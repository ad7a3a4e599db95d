"""Device resolution and the port's counters.

Counterpart of the PERF traffic counters of
genomealignmenttools_tpu/ops/rescore.py:84-97, plus one launch counter per
hand-written kernel.  The device is always explicit: the default is CUDA,
and asking for CUDA on a machine without it raises instead of moving the
work to the CPU.  The CPU is used only when a caller passes it.
"""

from __future__ import annotations

import torch

# Traffic counters: bytes shipped host->device and device->host; device
# passes (calls of a kernel wrapper, the plain CPU version included, and
# pair-mode row-sum passes); combine_overflow counts pair-mode batches whose
# int32 guard sent them to the host combine; band_problems counts the
# extension problems given to the band wrapper (K3 or its plain version),
# band_out_of_band those whose traceback left the band.
PERF = {"h2d_bytes": 0, "d2h_bytes": 0, "dispatches": 0,
        "combine_overflow": 0, "band_problems": 0, "band_out_of_band": 0}

# Kernel launch counters, one per hand-written kernel; a wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {"rescore_chunks": 0, "pair_combine": 0, "band_ext": 0}


def perf_reset() -> None:
    for counters in (PERF, LAUNCHES):
        for k in counters:
            counters[k] = 0


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device to run on: `cuda` unless the caller names another.

    Raises when CUDA is asked for and absent, and for device types the port
    has no path for (only `cuda` and `cpu`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev
