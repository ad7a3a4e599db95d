"""The gap aligner of RepeatFiller and patchChain with the port's band batch.

Counterpart of genomealignmenttools_tpu/ops/seed_extend.py.  TorchGapAligner
is the reference GapAligner with one change: `_band_batch`
(seed_extend.py:202-210) returns the port's BandExtBatch (K3 on CUDA, its
plain version on the CPU) on the aligner's device instead of
pallas_band.BandExtBatch.  Seeding, the HSP scan (native hspscan.cpp), the
problem construction and the best-first coverage replay are inherited as
they are, so every result is the reference's whenever the band batch's is.
"""

from __future__ import annotations

import torch

from genomealignmenttools_tpu.ops.seed_extend import GapAligner

from ..device import resolve_device
from .band_batch import BandExtBatch, check_band_env


class TorchGapAligner(GapAligner):
    """GapAligner whose banded extension DP runs on `device`."""

    def __init__(self, *args, device: str | torch.device | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        check_band_env()
        self.device = resolve_device(device)

    def _band_batch(self) -> BandExtBatch:
        cached = getattr(self, "_band_batch_obj", None)
        if cached is None:
            cached = self._band_batch_obj = BandExtBatch(
                False, self._dp_char_matrix(), self.gap_open,
                self.gap_extend, self.max_insert,
                a_max=max(256, -(-self.max_ext // 128) * 128),
                device=self.device)
        return cached
