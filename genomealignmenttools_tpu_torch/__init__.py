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
  csrc/combine.cu         K2, the segmented combine for sm_90a
                          (ops/pallas_combine.py:112-147 _combine_kernel)
  csrc/band.cu            K3, the batched wandering-band extension DP for
                          sm_90a (ops/pallas_band.py:63-340, the inner
                          `kernel` of _build_kernel)
  ops/window_rescore.py   chunking, plain PyTorch K1, the kernel wrapper,
                          WindowBlockScorer (ops/pallas_rescore.py)
  ops/pair_combine.py     K2's wrapper, its tiled plain version, the finish
                          (ops/pallas_combine.py)
  ops/pair_rescore.py     int8 score tiles resident on the device,
                          TorchPairBlockScorer, TorchPairChainScorer
                          (ops/pair_rescore.py)
  ops/rescore.py          TorchGenomeCache, TorchChainScorer in window or
                          pair mode (ops/rescore.py:159-555)
  ops/band_batch.py       K3's wrapper, its plain version, BandExtBatch
                          (ops/pallas_band.py)
  ops/seed_extend.py      TorchGapAligner: GapAligner with the port's band
                          batch (ops/seed_extend.py)
  engines/repeat_filler.py, engines/drivers.py
                          RepeatFiller and patchChain with TorchGapAligner,
                          FilterChainsNetFilterNets with the torch scorer
                          (engines/repeat_filler.py, engines/drivers.py)
  engines/chain_cleaner.py
                          clean_chains_distributed on torch.distributed
                          (engines/chain_cleaner.py:1842-1875)
  parallel/mesh.py        make_mesh, ShardedBlockScorer, ShardedPairScorer,
                          ShardedChainScorer (parallel/mesh.py)
  parallel/distributed.py init_distributed, hosts_chips_mesh,
                          host0_merge_text (parallel/distributed.py)
  parallel/dryrun.py      dryrun_multidevice (__graft_entry__.py:40-349)
  utils/profiling.py      trace (torch.profiler), device_timer
                          (utils/profiling.py)
  cli/main.py             scoreChain / chainNet / chainCleaner /
                          FilterChainsNetFilterNets with the torch scorer,
                          RepeatFiller / patchChain with the torch gap
                          aligner, -profile=dir; every other command
                          forwarded (cli/main.py)
"""

__version__ = "0.1.0"
