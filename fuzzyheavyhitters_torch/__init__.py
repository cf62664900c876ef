"""fuzzyheavyhitters_torch — the two-server private fuzzy heavy hitters
system on PyTorch and hand-written CUDA for NVIDIA Hopper (H100).

A port of ``fuzzyheavyhitters_tpu`` (which stays beside it as the
reference).  It imports ``torch`` and never ``jax``, and nothing of the JAX
package.  Layout mirrors the reference package's module names:

- ``utils``     bit codecs, config, device selection
- ``workloads`` zipf / rides samplers + CSV output
- ``ops``       fixed-key ChaCha PRG, ibDCF keys, fields, base OT and IKNP,
                and the CUDA kernels (``*_cuda``; sources under ``csrc/``)
- ``protocol``  the frontier crawl (``collect``), the secure exchange
                (``secure``), the in-process two-server driver (``driver``)
                and the socket deployment (``rpc``, ``leader_rpc``,
                ``sessions``)
- ``resilience`` dial retries and verb budgets
- ``bin``       ``mesh`` (one process), ``server`` and ``leader`` (the
                socket deployment)

The crawl runs trusted or secure, in one process or as two server
processes and a leader on the JAX package's wire.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit CPU request they raise.

32-bit words (ChaCha state, seeds, correction words) live as ``torch.int32``
bit patterns: PyTorch's ``uint32`` has no add or shift on the CPU.
"""

__version__ = "0.1.0"
