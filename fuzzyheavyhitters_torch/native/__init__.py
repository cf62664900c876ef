"""Native runtime components: C++ through ctypes (the port's copy of the
JAX package's ``native/``).

The reference's data loaders are native Rust streaming multi-GB CSVs
(memmap row indexing and a seeded reservoir, src/sample_covid_data.rs:75-166,
src/sample_driving_data.rs:72-97).  ``reservoir.cc`` holds their C++
equivalents and the ingest front door's incremental reservoir.  It is
compiled with the host's ``g++`` at first use (never at import) into the
build directory of ``ops/cuda_build.py`` (``build/fhh_torch/``), named by a
hash of its source and flags, through a temporary file and a rename.
Where no ``g++`` is found, or the build fails, every caller keeps working:
:func:`csv_reservoir_sample` returns None (the caller samples with NumPy)
and :class:`Reservoir` runs on :class:`_PyXoshiro256`, bit-identical to
the native library, so the same seed makes the same slot decisions either
way.  :func:`available` says which one serves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops import cuda_build

_SRC = Path(__file__).resolve().parent / "reservoir.cc"
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_build_failed = False


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return cuda_build.build_dir() / f"libreservoir-{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.csv_reservoir_sample.restype = ctypes.c_long
    lib.csv_reservoir_sample.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_ulonglong,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.reservoir_new.restype = ctypes.c_void_p
    lib.reservoir_new.argtypes = [ctypes.c_long, ctypes.c_ulonglong]
    lib.reservoir_free.argtypes = [ctypes.c_void_p]
    lib.reservoir_offer.restype = ctypes.c_long
    lib.reservoir_offer.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                    np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    lib.reservoir_state.argtypes = [ctypes.c_void_p,
                                    np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")]
    lib.reservoir_from_state.restype = ctypes.c_void_p
    lib.reservoir_from_state.argtypes = [np.ctypeslib.ndpointer(np.uint64,
                                                                flags="C_CONTIGUOUS")]
    return lib


def _load():
    """The native library, built on first use; None when it cannot be."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = lib_path()
        if not path.exists():
            # build to a private temporary path and rename into place: the
            # rename is atomic, so a concurrent build never loads a
            # half-written library
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = f"{path}.build.{os.getpid()}"
            try:
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                               capture_output=True, timeout=120)
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError):
                # no g++, a compile error or a timeout: the twins serve
                _build_failed = True
                return None
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError):
            _build_failed = True
        return _lib


def available() -> bool:
    """True when the native library is built (or can be) and loads."""
    return _load() is not None


def csv_reservoir_sample(path: str, col_a: int, col_b: int, k: int,
                         seed: int) -> np.ndarray | None:
    """Reservoir-sample ``k`` rows' (col_a, col_b) floats from a CSV in one
    streaming pass with O(k) memory (the header row skipped).  Returns
    float64[kept, 2], or None when the native library is unavailable (the
    caller falls back to NumPy)."""
    lib = _load()
    if lib is None:
        return None
    out_a = np.empty(k, np.float64)
    out_b = np.empty(k, np.float64)
    kept = lib.csv_reservoir_sample(path.encode(), col_a, col_b, k, seed & (2**64 - 1),
                                    out_a, out_b)
    if kept < 0:
        raise FileNotFoundError(path)
    return np.stack([out_a[:kept], out_b[:kept]], axis=1)


# -- the incremental in-memory reservoir (the ingest front door's shed mode) --

_U64 = (1 << 64) - 1


class _PyXoshiro256:
    """The Python twin of reservoir.cc's Xoshiro256 (splitmix64 seeding,
    xoshiro256**, Lemire's unbiased bounding), bit-identical to it, so a
    reservoir sampled without the native library (or restored on a host
    without g++) makes the same slot decisions."""

    __slots__ = ("s",)

    def __init__(self, seed: int):
        x = seed & _U64
        s = []
        for _ in range(4):
            x = (x + 0x9E3779B97F4A7C15) & _U64
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
            s.append(z ^ (z >> 31))
        self.s = s

    @staticmethod
    def _rotl(v: int, k: int) -> int:
        return ((v << k) | (v >> (64 - k))) & _U64

    def next(self) -> int:
        s = self.s
        result = (self._rotl((s[1] * 5) & _U64, 7) * 9) & _U64
        t = (s[1] << 17) & _U64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = self._rotl(s[3], 45)
        return result

    def below(self, n: int) -> int:
        """Uniform in [0, n) without modulo bias."""
        m = self.next() * n
        lo = m & _U64
        if lo < n:
            floor = ((_U64 + 1) - n) % n
            while lo < floor:
                m = self.next() * n
                lo = m & _U64
        return m >> 64


class Reservoir:
    """A seeded algorithm-R reservoir over slots the caller owns:
    ``offer(n)`` returns each of the next ``n`` items' slot in ``[0, k)``
    (replace the occupant) or -1 (shed the item).  Runs on the native
    library when it is available, on the bit-identical Python twin
    otherwise; :meth:`state` and :meth:`from_state` round-trip the whole
    sampling stream, so a restored server goes on with the same
    seed-reproducible sequence."""

    def __init__(self, k: int, seed: int, *, _handle=None, _py=None, _seen: int = 0):
        if k <= 0:
            raise ValueError("reservoir capacity must be positive")
        self.k = int(k)
        self._lib = _load()
        if _handle is not None or _py is not None:
            self._handle, self._py, self._seen = _handle, _py, _seen
            return
        if self._lib is not None:
            self._handle = self._lib.reservoir_new(self.k, seed & _U64)
            self._py = None
        else:
            self._handle = None
            self._py = _PyXoshiro256(seed)
        self._seen = 0

    @property
    def seen(self) -> int:
        return self._seen

    def offer(self, n: int = 1) -> np.ndarray:
        """Slots of the next ``n`` sequential items (int64[n]; -1 = shed)."""
        if n <= 0:
            return np.zeros(0, np.int64)
        out = np.empty(n, np.int64)
        if self._handle is not None:
            self._lib.reservoir_offer(self._handle, n, out)
            self._seen += n
            return out
        for i in range(n):
            if self._seen < self.k:
                out[i] = self._seen
            else:
                j = self._py.below(self._seen + 1)
                out[i] = j if j < self.k else -1
            self._seen += 1
        return out

    def state(self) -> np.ndarray:
        """uint64[6]: [k, seen, s0..s3], checkpointable."""
        if self._handle is not None:
            out = np.empty(6, np.uint64)
            self._lib.reservoir_state(self._handle, out)
            return out
        return np.array([self.k, self._seen] + list(self._py.s), np.uint64)

    @classmethod
    def from_state(cls, st) -> "Reservoir":
        st = np.ascontiguousarray(np.asarray(st, np.uint64))
        if st.shape != (6,):
            raise ValueError("reservoir state must be uint64[6]")
        k, seen = int(st[0]), int(st[1])
        lib = _load()
        if lib is not None:
            return cls(k, 0, _handle=lib.reservoir_from_state(st), _seen=seen)
        twin = _PyXoshiro256(0)
        twin.s = [int(v) for v in st[2:]]
        return cls(k, 0, _py=twin, _seen=seen)

    def __del__(self):
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle is not None:
            lib.reservoir_free(handle)
