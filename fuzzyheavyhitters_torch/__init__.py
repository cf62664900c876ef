"""fuzzyheavyhitters_torch — the two-server private fuzzy heavy hitters
system on PyTorch and hand-written CUDA for NVIDIA Hopper (H100).

A port of ``fuzzyheavyhitters_tpu`` (which stays beside it as the
reference).  It imports ``torch`` and never ``jax``, and nothing of the JAX
package.  Layout mirrors the reference package's module names:

- ``utils``     bit codecs, config, device selection
- ``workloads`` zipf / rides samplers + CSV output
- ``ops``       fixed-key ChaCha PRG, ibDCF keys, and the CUDA kernels
                (``keygen_cuda``, ``expand_cuda``; sources under ``csrc/``)
- ``protocol``  the frontier crawl (``collect``) and the in-process
                two-server driver (``driver``)
- ``bin``       ``mesh``: the single-card entry point

This slice runs the trusted-exchange crawl on one card.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit CPU request they raise.

32-bit words (ChaCha state, seeds, correction words) live as ``torch.int32``
bit patterns: PyTorch's ``uint32`` has no add or shift on the CPU.
"""

__version__ = "0.1.0"
