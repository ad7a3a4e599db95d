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
# band_out_of_band those whose traceback left the band;
# rf_chain_native_pairs and rf_chain_python_pairs count RepeatFiller's gaps
# chained by the native batch (ops/chain_pairs.py) and by the per-gap
# Python fallback; chainnet_fills counts the fill lines chainNet wrote on
# the target side, chainnet_rescored_fills the partial target fills that
# -rescore scored exactly, on whichever path scored them;
# chainnet_subsets_table counts the partial fills given to a scorer's
# score_subsets (cut from the chain table's arrays), chainnet_subsets_python
# those cut one by one by Chain.subset_on_t; cleaner_prescore_table counts
# the jobs of chainCleaner's prescore given to a scorer's score_subsets (cut
# from the row chains' arrays), cleaner_prescore_python those cut one by one
# by Chain.subset_on_t; pc_gaps, pc_band_problems, pc_band_runs and
# pc_psl_records count patchChain's gap jobs aligned, the extension problems
# they gave the band batch, the band batches run (one a chunk of gaps that
# has a problem: one K3 launch on the card) and the psl records written;
# hsp_windows_device counts the gap aligner's scan windows scored by the
# chunk-wide scan (K4 on the card, its plain version on the CPU),
# hsp_windows_host those scanned by the host scan, and hsp_windows_exact the
# windows of the chunk-wide scan that reached K and were split into
# segments on the host.
PERF = {"h2d_bytes": 0, "d2h_bytes": 0, "dispatches": 0,
        "combine_overflow": 0, "band_problems": 0, "band_out_of_band": 0,
        "rf_chain_native_pairs": 0, "rf_chain_python_pairs": 0,
        "chainnet_fills": 0, "chainnet_rescored_fills": 0,
        "chainnet_subsets_table": 0, "chainnet_subsets_python": 0,
        "cleaner_prescore_table": 0, "cleaner_prescore_python": 0,
        "pc_gaps": 0, "pc_band_problems": 0, "pc_band_runs": 0,
        "pc_psl_records": 0, "hsp_windows_device": 0,
        "hsp_windows_host": 0, "hsp_windows_exact": 0}

# Kernel launch counters, one per hand-written kernel, and for K2 one per
# row source: `pair_combine` counts its entries from int32 sums and from int8
# score tiles, `pair_combine_code` and `pair_combine_score4` those from
# combined-code and 4-bit tiles.  A wrapper adds one where it launches its
# kernel and nowhere else.
LAUNCHES = {"rescore_chunks": 0, "pair_combine": 0, "pair_combine_code": 0,
            "pair_combine_score4": 0, "band_ext": 0, "hsp_best": 0}


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
