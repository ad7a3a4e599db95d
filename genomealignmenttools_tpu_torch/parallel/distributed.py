"""Multi-process distribution on torch.distributed.

Counterpart of genomealignmenttools_tpu/parallel/distributed.py:

- `init_distributed(backend, ...)` - torch.distributed.init_process_group
  from torchrun's environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
  RANK) or from the arguments; idempotent, a no-op for one process.  The
  backend is named by the caller, never guessed: `nccl` for ranks that each
  own a CUDA card, `gloo` otherwise (two ranks on one card need gloo, since
  NCCL refuses two ranks on one GPU).  A group it made is destroyed when
  the interpreter exits, if the caller has not done so: a gloo group still
  alive at exit aborted a rank once in a few runs ("terminate called
  without an active exception") while its threads were torn down.
- `hosts_chips_mesh()` - (world size, this rank's devices): a torch process
  addresses only its own cards.
- `shard_indices` - the reference's contiguous work partition (its text),
  so per-rank outputs concatenate back in input order.
- `host0_merge_text(...)` - all-gather of fixed-size, length-prefixed uint8
  tensors on the backend's device (CUDA for NCCL, the CPU for gloo); every
  rank returns the concatenation in rank order, rank 0 writes.
"""

from __future__ import annotations

import atexit
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_distributed", "hosts_chips_mesh", "shard_indices",
           "host0_merge_text", "world"]

BACKENDS = ("gloo", "nccl")


def init_distributed(backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> None:
    """Join the process group.  world_size and rank default to WORLD_SIZE
    and RANK, init_method to env:// (MASTER_ADDR, MASTER_PORT).  A single
    process (world size 1, no init_method) returns at once; a second call
    returns too, and raises if it names another backend than the group's.
    With nccl, the rank's current card becomes LOCAL_RANK (default: rank)."""
    if dist.is_initialized():
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"process group already uses "
                             f"{dist.get_backend()}, not {backend}")
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size == 1 and init_method is None:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: name one of "
                         f"{', '.join(BACKENDS)}")
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    atexit.register(_leave_at_exit)


def _leave_at_exit() -> None:
    """Destroy the process group before the interpreter exits, unless the
    caller already has."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple[int, int]:
    """(world size, rank): (1, 0) outside a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def hosts_chips_mesh(devices=None) -> tuple[int, tuple[torch.device, ...]]:
    """(world size, this rank's devices): make_mesh(devices=devices), by
    default every card the process sees."""
    from .mesh import make_mesh     # mesh imports shard_indices from here
    return world()[0], make_mesh(devices=devices)


def shard_indices(n: int, num_shards: int, shard: int) -> range:
    """Deterministic contiguous partition of n work-units.

    Contiguous (not round-robin) so concatenating per-shard outputs in
    shard order reproduces input order exactly - the merge step is a
    plain cat, and bytes are identical at every topology."""
    base, extra = divmod(n, num_shards)
    start = shard * base + min(shard, extra)
    return range(start, start + base + (1 if shard < extra else 0))


def host0_merge_text(local_text: str, max_bytes: int = 1 << 26) -> str:
    """All-gather every rank's text; each rank returns the concatenation in
    rank order (rank 0 writes the canonical file).  One process gets
    `local_text` back unchanged.  Raises ValueError when the text is longer
    than max_bytes encoded, in any process count, so that a run fails the
    same way whatever its topology."""
    data = local_text.encode()
    if len(data) > max_bytes:
        raise ValueError(f"shard output {len(data)} exceeds {max_bytes}")
    n, _ = world()
    if n == 1:
        return local_text
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = np.zeros(max_bytes + 8, np.uint8)
    buf[:8] = np.frombuffer(np.int64(len(data)).tobytes(), np.uint8)
    buf[8:8 + len(data)] = np.frombuffer(data, np.uint8)
    mine = torch.from_numpy(buf).to(dev)
    gathered = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(gathered, mine)
    parts = []
    for row in gathered:
        row = row.cpu().numpy()
        size = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        parts.append(row[8:8 + size].tobytes().decode())
    return "".join(parts)
