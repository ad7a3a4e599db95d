"""genomealignmenttools_tpu_torch - the PyTorch/CUDA port of genomealignmenttools_tpu.

The JAX package (`genomealignmenttools_tpu/`) stays the reference, and this
package imports nothing of it: it is a second package beside it, with its
own copy of every host layer it uses (numpy, ctypes and C++, the
reference's text at the same relative path; tests/test_torch_copies.py
holds the copies equal and names each intended difference) and its own
modules wherever the reference is written against jax or a Pallas kernel.
It imports torch and numpy, never jax.

Layout (counterparts in genomealignmenttools_tpu/):
  device/__init__.py      device resolution + traffic and launch counters
                          (ops/rescore.py:84-97 PERF)
  device/genome.py        copy: 2bit genomes as code arrays
  _build.py               nvcc build of csrc/*.cu at first use, loaded with
                          ctypes (native/__init__.py:31-58 pattern)
  csrc/rescore.cu         K1, the chunk-sum kernel for sm_90a
                          (ops/pallas_rescore.py:43-136 _rescore_kernel)
  csrc/combine.cu         K2, the segmented combine fused with the int8
                          row sums, for sm_90a (ops/pallas_combine.py:
                          112-147 _combine_kernel; the row sum of
                          ops/pair_rescore.py:748-761 _fused_pass)
  csrc/band.cu            K3, the batched wandering-band extension DP for
                          sm_90a (ops/pallas_band.py:63-340, the inner
                          `kernel` of _build_kernel)
  native/                 copy: the ten C++ sources, gat_threads.h and
                          chain_io.py; __init__.py builds them with g++
                          into build/ and loads them under a lock
  formats/, utils/        copies (utils/profiling.py: torch.profiler trace,
                          the phase timers, each phase a record_function
                          range while the profiler records)
  ops/window_rescore.py   chunking, plain PyTorch K1, the kernel wrapper,
                          WindowBlockScorer (ops/pallas_rescore.py)
  ops/pair_combine.py     K2's wrappers (from int8, combined-code and 4-bit
                          tiles, from int32 sums), their tiled plain
                          versions, the finish (ops/pallas_combine.py)
  ops/pair_rescore.py     tiles resident on the device in the format
                          GAT_PAIR_TILES names, TorchPairBlockScorer (also
                          host-native), TorchPairChainScorer, pack_pairs
                          (ops/pair_rescore.py)
  ops/rescore.py          TorchGenomeCache, TorchChainScorer in window, pair
                          or host-native mode, the native combine
                          (ops/rescore.py)
  ops/band_batch.py       K3's wrapper, its plain version, BandExtBatch, the
                          host band batch (ops/pallas_band.py)
  ops/band_ext.py         copy: the numpy bandExt (oracle, chainBridge)
  ops/seed_extend.py      copy: GapAligner, with the port's band batch
  engines/                copies of all sixteen engines; their scorer seams
                          take torch_scorer_factory(device), the gap
                          aligners take the device, clean_chains_distributed
                          runs on torch.distributed
  parallel/mesh.py        make_mesh, ShardedBlockScorer, ShardedPairScorer,
                          ShardedChainScorer (parallel/mesh.py)
  parallel/distributed.py init_distributed, hosts_chips_mesh, shard_indices,
                          host0_merge_text (parallel/distributed.py)
  parallel/dryrun.py      dryrun_multidevice (__graft_entry__.py:40-349)
  cli/main.py             copy: the whole command table, with -device
                          (cli/main.py)
"""

__version__ = "0.1.0"
