"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries land in
``build/fhh_torch/`` beside the package (``FHH_TORCH_BUILD_DIR`` overrides
it), named by a hash of their sources and flags, so an edited source is
rebuilt and an unchanged one is reused; processes that start together on
one build directory build each library once (:func:`build`).  Each
library ``nvcc`` builds counts as a fresh compile (``obs.devmem``).
Everything here runs at first use, never at import: the CPU tests import
every module on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..obs import devmem

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
SOURCES = {"keygen": "keygen.cu", "expand": "expand.cu", "ot2s": "ot2s.cu", "gc": "gc.cu"}
HEADERS = ("chacha.cuh",)
# -split-compile=0 runs the device optimizer's passes over a source's
# kernels on every core, so gc.cu's 32 template instantiations no longer
# build one after another; scripts/nvcc_split_check.py times both builds
# and checks that their SASS is byte-equal
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-split-compile=0",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}  # fhh-guard: _libs=_lock


def build_dir() -> Path:
    return Path(os.environ.get("FHH_TORCH_BUILD_DIR", PKG.parent / "build" / "fhh_torch"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return build_dir() / f"libfhh_{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return lib_path(name).with_suffix(".log")


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> library
    path; raises with the compiler's output if any build fails.

    Safe across processes on one build directory (two servers starting
    together): the build runs under an ``fcntl`` lock on ``build.lock``
    there, so a second process waits and then finds the libraries built;
    each ``nvcc`` writes to per-process temporary files, and its log is
    renamed into place before its library, so a library's log is never
    truncated by another build."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        build_dir().mkdir(parents=True, exist_ok=True)
        with open(build_dir() / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            _build_locked(names)
    return {name: lib_path(name) for name in names}


def _build_locked(names) -> None:
    todo = [name for name in names if not lib_path(name).exists()]
    if not todo:
        return
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        out = lib_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        tmp_log = out.with_name(f"{out.stem}.{os.getpid()}.tmp.log")
        log = open(tmp_log, "w")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, tmp_log, out)
    failed = []
    for name, (proc, log, tmp, tmp_log, out) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp_log, log_path(name))
            os.replace(tmp, out)
            # a fresh build, counted where the JAX package counts an XLA
            # compile (a cached library's load is not one)
            devmem.note_fresh_compile(name, time.perf_counter() - t0)
        else:
            failed.append(f"{name} (nvcc rc={rc}):\n{tmp_log.read_text()}")
            tmp_log.unlink()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    # fhh-lint: disable=guarded-state-unlocked (double-checked fast path: one dict.get, atomic under the GIL; a miss re-reads under the lock before it writes)
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                lib.fhh_error_string.argtypes = [ctypes.c_int]
                lib.fhh_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check_planes(what: str, arrs, n: int):
    """Validate plane-major kernel inputs ``[(name, tensor, rows), ...]``:
    each int32[rows, n], all on one cpu or cuda device, which is returned."""
    import torch

    dev = arrs[0][1].device
    for name, a, rows in arrs:
        if a.dtype != torch.int32 or tuple(a.shape) != (rows, n):
            raise ValueError(f"{what}: {name} must be int32[{rows}, {n}], got "
                             f"{a.dtype}{list(a.shape)}")
        if a.device != dev:
            raise ValueError(f"{what}: {name} is on {a.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return dev


def check_compiled(src: str, S: int, W: int, kernel_s, kernel_w) -> None:
    """Raise unless ``src`` was compiled for string width S and payload W."""
    if S not in kernel_s or W not in kernel_w:
        raise ValueError(f"csrc/{src} is compiled for S in {kernel_s}, W in {kernel_w}; "
                         f"got S={S}, W={W}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.fhh_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as the raw handle a
    ``c_void_p`` argument takes (no ``torch.cuda.Stream`` object is made)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
