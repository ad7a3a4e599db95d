"""genomealignmenttools_tpu_torch - the PyTorch/CUDA port of genomealignmenttools_tpu.

The JAX package (`genomealignmenttools_tpu/`) stays the reference.  This
package owns every module that the JAX package writes against jax or a
Pallas kernel, and imports the jax-free layers of the reference as they are
(`formats/`, `native/`, `device/genome.py`, `engines/`, `utils/`).  It never
imports jax.

Layout (counterparts in genomealignmenttools_tpu/):
  device.py               device resolution + traffic and launch counters
                          (ops/rescore.py:84-97 PERF)
  _build.py               nvcc build of csrc/*.cu at first use, loaded with
                          ctypes (native/__init__.py:31-58 pattern)
  csrc/rescore.cu         K1, the chunk-sum kernel for sm_90a
                          (ops/pallas_rescore.py:43-136 _rescore_kernel)
  ops/window_rescore.py   chunking, plain PyTorch K1, the kernel wrapper,
                          WindowBlockScorer (ops/pallas_rescore.py)
  ops/rescore.py          TorchGenomeCache, TorchChainScorer
                          (ops/rescore.py:159-555)
  cli/main.py             scoreChain / chainNet / chainCleaner with the torch
                          scorer; every other command forwarded (cli/main.py)
"""

__version__ = "0.1.0"
