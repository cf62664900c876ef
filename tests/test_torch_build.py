"""The port's first-use kernel build across processes
(``ops/cuda_build.build``), on the CPU with a stand-in ``nvcc``: two
processes that start together on an empty build directory compile each
library once, and the compiler log beside it is whole; a failed build
leaves no temporary file and raises with the compiler's output.  The same
race with the real compiler runs on the card (``tests/test_torch_cuda.py``)."""

import os
import subprocess
import sys

import pytest

from fuzzyheavyhitters_torch.ops import cuda_build

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a compiler that takes a second, counts its calls, writes its -o target
# and one ptxas-style line, or fails when FAIL is set
_NVCC = """#!/bin/sh
echo call >> "{calls}"
sleep 1
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
if [ -n "$FAIL" ]; then echo "error: stand-in failure"; exit 3; fi
echo "ptxas info    : Used 40 registers, 0 bytes spill stores"
printf 'library' > "$out"
"""


def _env(tmp_path, **extra):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True, exist_ok=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_NVCC.format(calls=tmp_path / "calls"))
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(home), FHH_TORCH_BUILD_DIR=str(tmp_path / "build"),
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


_BUILD = ("from fuzzyheavyhitters_torch.ops import cuda_build as b; "
          "p = b.build(['expand', 'ot2s']); "
          "print(p['expand'].read_text(), b.log_path('expand').read_text().count('registers'))")


def test_two_processes_build_each_library_once(tmp_path):
    env = _env(tmp_path)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD], env=env, cwd=_REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.split() for o in outs] == [["library", "1"]] * 2
    # one nvcc per source in all: the second process found both built
    assert (tmp_path / "calls").read_text().split() == ["call"] * 2
    left = sorted(f.name for f in (tmp_path / "build").iterdir())
    assert not [f for f in left if ".tmp." in f], left
    assert sum(f.endswith(".so") for f in left) == 2 and sum(f.endswith(".log") for f in left) == 2


def test_failed_build_raises_and_leaves_no_temporaries(tmp_path, monkeypatch):
    for k, v in _env(tmp_path, FAIL="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match=r"kernel build failed: expand \(nvcc rc=3\):\n"
                       "error: stand-in failure"):
        cuda_build.build(["expand"])
    assert [f.name for f in (tmp_path / "build").iterdir()] == ["build.lock"]
