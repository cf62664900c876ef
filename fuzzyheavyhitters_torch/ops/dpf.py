"""Payload-carrying all-prefix DPF, as plain PyTorch (the port of
``fuzzyheavyhitters_tpu/ops/dpf.py``, bit for bit).

The malicious-secure sketch rides on an all-prefix distributed point
function whose per-level payload is a field value pair ``(x, k·x)`` (ref:
src/sketch.rs:8-24, the BGI16 construction with the reference's
conventions).  A client's vector at tree level j is one-hot at
``prefix(alpha, j)``; the two servers' value shares satisfy

    share_0 + share_1 = value_j   at the on-path prefix,
    share_0 + share_1 = 0         everywhere else,

with ``share_b = (-1)^b * (convert(seed) + t * cw_val[j])``.

A key batch is a tuple of tensors with any batch dims; keygen walks the L
levels in a Python loop (the JAX package's ``lax.scan``), eval advances one
level a call.  ``convert`` (seed -> field lanes) is the ChaCha CTR stream of
the seed with a domain-separation tweak XORed into seed words 2 and 3, so
it never collides with the expansion PRG.  The DPF uses honest
seed-derived t-bits (``prg.expand(seed, True)``) whatever
``prg.DERIVED_BITS`` says: the reference's masked-bit quirk belongs to the
ibDCF only.

Seeds are ``int32[..., 4]`` bit patterns, bits ``bool``, FE62 values
``int64`` and F255 values ``int32[..., 8]`` (``ops/fields.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import prg

# domain-separation tweak for convert() vs the expansion PRG
_CONVERT_TWEAK = (0x6B8B4567, 0x327B23C6)  # XORed into seed words 2, 3


class DpfKeyBatch(NamedTuple):
    """One party's batch of payload DPF keys.

    cw_val:      inner-level value CWs, field T elements [..., L-1, lanes]
    cw_val_last: last-level value CW, field U elements [..., lanes(, limbs)]
    """

    key_idx: torch.Tensor  # bool[...]
    root_seed: torch.Tensor  # int32[..., 4]
    cw_seed: torch.Tensor  # int32[..., L, 4]
    cw_t: torch.Tensor  # bool[..., L, 2] (left/right t corrections)
    cw_val: torch.Tensor
    cw_val_last: torch.Tensor

    @property
    def data_len(self) -> int:
        return self.cw_seed.shape[-2]


class DpfEvalState(NamedTuple):
    seed: torch.Tensor  # int32[..., 4]
    t: torch.Tensor  # bool[...]


def convert(seed: torch.Tensor, field, lanes: int) -> torch.Tensor:
    """seed int32[..., 4] -> field elements [..., lanes(, limbs)], from the
    tweaked seed's CTR stream."""
    tweaked = seed.clone()
    tweaked[..., 2] ^= _CONVERT_TWEAK[0]
    tweaked[..., 3] ^= _CONVERT_TWEAK[1]
    w = 8 if field.limb_shape else 4
    words = prg.stream_words(tweaked, lanes * w)
    return field.sample(words.reshape(words.shape[:-1] + (lanes, w)))


def _neg_if(field, cond, v):
    return torch.where(cond[..., None] if field.limb_shape else cond, field.neg(v), v)


def gen_pair(init_seeds, alpha_bits, values, values_last, field_t, field_u, lanes=2):
    """Both parties' payload-DPF batches.

    init_seeds:  int32[..., 2, 4]; alpha_bits: bool[..., L];
    values:      field_t[..., L-1, lanes] per-level payloads;
    values_last: field_u[..., lanes(, limbs)] leaf payload.
    """
    batch = alpha_bits.shape[:-1]
    L = alpha_bits.shape[-1]
    if init_seeds.shape != batch + (2, 4):
        raise ValueError(f"init_seeds shaped {tuple(init_seeds.shape)}, want "
                         f"{tuple(batch) + (2, 4)}")
    if values.shape[:len(batch)] != batch or values.shape[-2] != L - 1:
        raise ValueError(f"values shaped {tuple(values.shape)} for batch {tuple(batch)}, "
                         f"L={L}")
    seeds = init_seeds
    ts = torch.tensor([False, True], device=alpha_bits.device).expand(batch + (2,))
    cw_seeds, cw_ts, lvl_seeds, lvl_ts = [], [], [], []
    for j in range(L):
        alpha = alpha_bits[..., j]
        s_l, s_r, d_bits, _ = prg.expand(seeds, True)  # honest t-bits
        k = alpha[..., None]
        cw_seed = torch.where(k, s_l[..., 0, :] ^ s_l[..., 1, :], s_r[..., 0, :] ^ s_r[..., 1, :])
        # t corrections: on-path child t-shares must differ, off-path agree
        cw_t = torch.stack([d_bits[..., 0, 0] ^ d_bits[..., 1, 0] ^ alpha ^ True,
                            d_bits[..., 0, 1] ^ d_bits[..., 1, 1] ^ alpha], dim=-1)
        kept_seed = torch.where(k[..., None, :], s_r, s_l)  # [..., 2, 4]
        kept_t = torch.where(k, d_bits[..., 1], d_bits[..., 0])  # [..., 2]
        seeds = torch.where(ts[..., None], kept_seed ^ cw_seed[..., None, :], kept_seed)
        cw_t_keep = torch.where(alpha, cw_t[..., 1], cw_t[..., 0])
        ts = kept_t ^ (ts & cw_t_keep[..., None])
        cw_seeds.append(cw_seed)
        cw_ts.append(cw_t)
        lvl_seeds.append(seeds)
        lvl_ts.append(ts)
    cw_seed = torch.stack(cw_seeds, dim=-2)  # [..., L, 4]
    cw_t = torch.stack(cw_ts, dim=-2)  # [..., L, 2]

    # value CWs from the corrected level seeds (inner levels in T)
    def val_cw(field, seeds2, t1, value):
        w0 = convert(seeds2[..., 0, :], field, lanes)
        w1 = convert(seeds2[..., 1, :], field, lanes)
        return _neg_if(field, t1, field.add(field.sub(value, w0), w1))

    if L > 1:
        cw_val = val_cw(field_t, torch.stack(lvl_seeds[:L - 1], dim=-3),  # [..., L-1, 2, 4]
                        torch.stack([t[..., 1] for t in lvl_ts[:L - 1]], dim=-1)[..., None],
                        values)
    else:  # a one-level tree has no inner level
        cw_val = values
    cw_val_last = val_cw(field_u, seeds, ts[..., 1, None], values_last)

    def mk(p: int) -> DpfKeyBatch:
        return DpfKeyBatch(
            key_idx=torch.full(batch, bool(p), dtype=torch.bool, device=alpha_bits.device),
            root_seed=init_seeds[..., p, :], cw_seed=cw_seed, cw_t=cw_t, cw_val=cw_val,
            cw_val_last=cw_val_last)

    return mk(0), mk(1)


def eval_init(key: DpfKeyBatch) -> DpfEvalState:
    return DpfEvalState(seed=key.root_seed, t=key.key_idx)


def level_cw(key: DpfKeyBatch, level: int):
    return key.cw_seed[..., level, :], key.cw_t[..., level, :]


def eval_bit(cw, state: DpfEvalState, direction, cw_val_level, key_idx, field, lanes):
    """Advance one level and emit this level's value share.

    cw:           output of :func:`level_cw`;
    direction:    bool[...] child taken (True = right);
    cw_val_level: this level's value CW (field[..., lanes(, limbs)]);
    Returns (new state, value share field[..., lanes(, limbs)]) with
    ``share = (-1)^key_idx * (convert(seed') + t' * cw_val)``.
    """
    cw_seed, cw_t = cw
    s_l, s_r, d_bits, _ = prg.expand(state.seed, True)
    seed = torch.where(direction[..., None], s_r, s_l)
    t = torch.where(direction, d_bits[..., 1], d_bits[..., 0])
    cw_t_d = torch.where(direction, cw_t[..., 1], cw_t[..., 0])
    seed = torch.where(state.t[..., None], seed ^ cw_seed, seed)
    t = t ^ (state.t & cw_t_d)
    w = convert(seed, field, lanes)
    tb = t[..., None]  # over the lanes axis
    mask = tb[..., None] if field.limb_shape else tb  # ... and the limbs
    share = field.add(w, torch.where(mask, cw_val_level, 0))
    return DpfEvalState(seed=seed, t=t), _neg_if(field, key_idx[..., None], share)
