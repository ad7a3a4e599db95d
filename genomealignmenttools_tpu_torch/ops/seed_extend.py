"""Seed-and-extend local alignment for bounded regions (the lastz stage of
RepeatFiller / patchChain, re-designed).

Behavioral reference: the role lastz plays in src/RepeatFiller.py:445-468
(repeat-seeded alignment inside chain gaps, K/L score thresholds, W word
size) - not a lastz port.  Design:

- exact k-mer seeds over the two regions (soft-mask ignored, like lastz's
  [unmask]; N-containing words excluded); word sizes match the
  reference's lastz invocations (W=6 RepeatFiller.py:163-169, W=5
  patchChain.perl:23)
- per *diagonal*, seed positions are merged into scan windows extended
  by hsp_margin (the x-drop horizon); each window's substitution-score
  vector is scanned for maximal-scoring segments (clamped-prefix-sum
  decomposition) - equivalent to greedy x-drop extension of every seed
  on the diagonal at once, and fully vectorized: a grouped single-pass
  Kadane over all windows prefilters, the exact recursive extraction
  runs only on windows reaching K; on the card the prefilter runs for a
  whole chunk of gaps in one K4 launch (ops/hsp_scan.py,
  GapAligner.align_scan_batch)
- gap-free HSPs >= K are indel-joined by the gapped stage (banded
  affine DP, threshold L), then feed the kd-tree chainer
  (engines/kd_chainer) which plays lastz's chaining stage
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import PERF
from ..utils.profiling import phase


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Base-4 packed k-mers; -1 where the window contains an N."""
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, np.int64)
    c = codes.astype(np.int64)
    val = np.zeros(n - k + 1, np.int64)
    bad = np.zeros(n - k + 1, bool)
    for j in range(k):
        w = c[j:n - k + 1 + j]
        val = (val << 2) | np.minimum(w, 3)
        bad |= w >= 4
    val[bad] = -1
    return val


def _max_segments(scores: np.ndarray, min_score: int):
    """Disjoint maximal-scoring segments with score >= min_score.

    Returns list of (start, end, segment_score).  Uses the clamp-at-zero
    decomposition: within each zero-reset region the best segment runs
    from just after the prefix minimum to the prefix maximum.
    """
    out = []
    n = scores.shape[0]
    if n == 0:
        return out
    # take the globally best segment (max over ends e of
    # pref[e+1] - min(pref[:e+1]), the running-min formulation), then
    # recurse on the two flanks (segments above threshold are rare)
    stack = [(0, n)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= 0:
            continue
        seg = scores[lo:hi]
        c = np.cumsum(seg)
        pref = np.concatenate([[0], c])
        runmin = np.minimum.accumulate(pref[:-1])
        cand = c - runmin  # best segment score ending at each position
        best_end = int(np.argmax(cand))
        score = int(cand[best_end])
        if score < min_score:
            continue
        # minimal maximal segment: zero-score flanks are trimmed (argmax
        # already picks the first maximal end; the start is the LAST
        # prefix-minimum), matching lastz's seed-anchored extension which
        # records max positions and never includes score-neutral tails
        pref_slice = pref[:best_end + 1]
        best_start = int(np.flatnonzero(pref_slice == runmin[best_end])[-1])
        out.append((lo + best_start, lo + best_end + 1, score))
        stack.append((lo, lo + best_start))
        stack.append((lo + best_end + 1, hi))
    out.sort()
    return out


_CODE2CHAR = np.frombuffer(b"TCAGN", dtype=np.uint8)
_KEY = np.int64(1) << 32


def _holding_a_seed(blocks: list, seeds, t_lo: int, q_lo: int) -> list:
    """The HSP rows [tS, tE, qS, qE, score] that hold a whole seed word
    on their diagonal; seeds is _seed_windows' (diag, t, k) in region
    coordinates, sorted by diagonal then t.

    lastz x-drop-extends an HSP from a seed, so every HSP it finds holds
    one.  A scan window reaches hsp_margin bases past its seeds, so a
    K-scoring segment that lies wholly in soft-masked sequence, seeded
    from nowhere, can be found in it; masked seeding (patchChain without
    -unmask) keeps none of those.  Without seed codes every segment of
    the windows is kept, as in RepeatFiller."""
    d_s, t_s, k = seeds
    if not blocks or d_s.size == 0:
        return []
    rows = np.asarray(blocks, np.int64)
    t0, t1 = rows[:, 0] - t_lo, rows[:, 1] - t_lo
    diag = t0 - (rows[:, 2] - q_lo)
    i = np.searchsorted(d_s * _KEY + t_s, diag * _KEY + t0)
    j = np.minimum(i, d_s.size - 1)
    hold = (i < d_s.size) & (d_s[j] == diag) & (t_s[j] + k <= t1)
    return [b for b, h in zip(blocks, hold) if h]


def pack_windows(live: list):
    """The scan windows of align_seed's results `live` over their regions
    concatenated: (t_buf, q_buf, t_start, q_start, length, gid, t_off,
    q_off): uint8 codes of every target and every query region, each
    window's int64 starts in them and int32 length, in the regions' order
    and each region's window order; the region of each window, and each
    region's first position in t_buf and q_buf (int64)."""
    t_len = np.array([s[0].shape[0] for s in live], np.int64)
    q_len = np.array([s[1].shape[0] for s in live], np.int64)
    t_off = np.cumsum(t_len) - t_len
    q_off = np.cumsum(q_len) - q_len
    counts = np.array([s[4][0].size for s in live], np.int64)
    gid = np.repeat(np.arange(len(live)), counts)
    diag, w0, w1 = (np.concatenate([s[4][k] for s in live]).astype(np.int64)
                    for k in range(3))
    t_start = w0 + t_off[gid]
    q_start = w0 - diag + q_off[gid]
    length = (w1 - w0).astype(np.int32)
    t_buf = np.concatenate([s[0] for s in live]).astype(np.uint8)
    q_buf = np.concatenate([s[1] for s in live]).astype(np.uint8)
    return t_buf, q_buf, t_start, q_start, length, gid, t_off, q_off


def _native_scan():
    """The native library where its threaded HSP scan is built and
    GAT_HSP_NATIVE=0 does not turn it off, else None."""
    if os.environ.get("GAT_HSP_NATIVE", "1") == "0":
        return None
    from ..native import get_lib
    lib = get_lib()
    return lib if lib is not None and hasattr(lib, "gat_hsp_scan") else None


class GapAligner:
    """Aligns two bounded genome regions into scored gap-free blocks.

    Two stages, mirroring the role lastz's K/L thresholds play
    (RepeatFiller.py:163-169 `K=1500 L=2000`, patchChain.perl:23 `L=2500`):

    - ungapped: per-diagonal maximal segments with score >= K
      (hsp_threshold) - the HSP stage
    - gapped (when gapped_threshold/L is set): each HSP is extended left
    and right across indels with the banded affine-gap DP
      (ops/band_ext, the bit-exact kent bandExt port); an alignment is
      kept iff its total gapped score >= L.  Without L, HSPs are emitted
      directly (the round-1 behavior).

    The emitted gap-free blocks feed the kd-tree chainer (lastz's chaining
    stage is played by engines/kd_chainer downstream).
    """

    def __init__(self, lut: np.ndarray, seed_len: int = 10,
                 hsp_threshold: int = 1500, max_region: int = 1_000_000,
                 max_seeds: int = 32_000_000,
                 hsp_margin: int = 1_000,
                 gapped_threshold: int | None = None,
                 gap_open: int = 400, gap_extend: int = 30,
                 char_matrix: np.ndarray | None = None,
                 max_insert: int = 100, max_ext: int = 2_000,
                 device=None):
        # the device of the banded DP (cuda unless named; raises without
        # CUDA); GAT_BAND=host names the host band batch instead
        from .band_batch import band_device
        self.device = band_device(device)
        self.lut = np.asarray(lut, dtype=np.int64)
        # HSP/DP scoring penalizes N like lastz (characters outside the
        # matrix score as the worst mismatch) so ungapped extension stops
        # at N runs and the gapped DP strictly prefers gapping over them,
        # instead of coasting through at kent's N=0 chain-scoring
        # semantics and picking up off-diagonal noise beyond
        # (tests/test_planted_alignment.py n_run_gap).  Emitted block
        # scores still use self.lut (kent semantics, axt.c:431).
        self._bad_n = int(self.lut[:4, :4].min())
        self.hsp_lut = self.lut.copy()
        self.hsp_lut[4, :] = self._bad_n
        self.hsp_lut[:, 4] = self._bad_n
        self.seed_len = seed_len
        self.hsp_threshold = hsp_threshold
        self.max_region = max_region
        self.max_seeds = max_seeds
        self.hsp_margin = hsp_margin
        self.gapped_threshold = gapped_threshold
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.char_matrix = char_matrix
        self.max_insert = max_insert
        self.max_ext = max_ext

    # -- gapped stage --------------------------------------------------
    def _ext_blocks_and_score(self, t_sym: bytes, q_sym: bytes,
                              t_anchor: int, q_anchor: int, direction: int):
        """Turn band_ext symbol strings into gap-free blocks + affine
        score.  Coordinates grow from (t_anchor, q_anchor) in
        `direction`; for direction=-1 the anchor is the block START.

        band_ext returns syms in genomic-ASCENDING order for both
        directions (it reverses its output only for direction>0, having
        run the DP on reversed input for direction<0) - so for the left
        extension the anchor-adjacent symbol is LAST.  Flip to
        anchor-adjacent-first so the offset arithmetic below is uniform.
        """
        ta = np.frombuffer(t_sym, np.uint8)
        qa = np.frombuffer(q_sym, np.uint8)
        if direction < 0:
            ta = ta[::-1]
            qa = qa[::-1]
        dash = ord("-")
        both = (ta != dash) & (qa != dash)
        score = int(self._dp_char_matrix()[ta[both], qa[both]].sum())
        # affine gap charges: O for the first base, E per extra
        # (bandExt.c state init, bandExt.c:129-141)
        gap = ~both
        if gap.any():
            runs = np.flatnonzero(np.diff(np.concatenate(
                [[0], gap.view(np.int8), [0]])))
            starts, ends = runs[0::2], runs[1::2]
            lens = ends - starts
            score -= int(self.gap_open * len(lens)
                         + self.gap_extend * (lens - 1).sum())
        # blocks: runs of aligned columns; t/q advance where not a dash
        t_adv = np.cumsum(ta != dash)
        q_adv = np.cumsum(qa != dash)
        blocks = []
        if both.any():
            bruns = np.flatnonzero(np.diff(np.concatenate(
                [[0], both.view(np.int8), [0]])))
            for s, e in zip(bruns[0::2], bruns[1::2]):
                t_off0 = int(t_adv[s - 1]) if s else 0
                q_off0 = int(q_adv[s - 1]) if s else 0
                t_off1, q_off1 = int(t_adv[e - 1]), int(q_adv[e - 1])
                if direction > 0:
                    blocks.append([t_anchor + t_off0, t_anchor + t_off1,
                                   q_anchor + q_off0, q_anchor + q_off1])
                else:
                    blocks.append([t_anchor - t_off1, t_anchor - t_off0,
                                   q_anchor - q_off1, q_anchor - q_off0])
        return blocks, score

    def _dp_char_matrix(self) -> np.ndarray:
        """char_matrix with 'n'/'N' rows/cols at the worst mismatch (the
        lastz treatment of off-matrix characters) for the gapped DP, so
        gapping over an N run strictly beats pairing through it."""
        cached = getattr(self, "_dp_cm", None)
        if cached is None:
            m = self.char_matrix.copy()
            for ch in b"nN":
                m[ch, :] = self._bad_n
                m[:, ch] = self._bad_n
            cached = self._dp_cm = m
        return cached

    def _band_batch(self):
        cached = getattr(self, "_band_batch_obj", None)
        if cached is None:
            from .band_batch import BandExtBatch
            cached = self._band_batch_obj = BandExtBatch(
                False, self._dp_char_matrix(), self.gap_open,
                self.gap_extend, self.max_insert,
                a_max=max(256, -(-self.max_ext // 128) * 128),
                device=self.device)
        return cached

    def _gapped_probs(self, hsps: list, t_region: np.ndarray,
                      q_region: np.ndarray, t_lo: int, q_lo: int):
        """Build the (left, right) banded-DP extension problems for the
        best-first sorted HSPs; returns (hsps_sorted, probs)."""
        if self.char_matrix is None:
            from ..formats.scorematrix import score_scheme_default
            self.char_matrix = score_scheme_default().char_matrix()
        t_chars = _CODE2CHAR[np.minimum(t_region, 4)]
        q_chars = _CODE2CHAR[np.minimum(q_region, 4)]
        tn, qn = t_region.shape[0], q_region.shape[0]
        # best-first; skip anchors already covered by an emitted alignment
        hsps = sorted(hsps, key=lambda b: -b[4])
        probs = []
        for tS, tE, qS, qE, _score in hsps:
            rt0, rt1 = tS - t_lo, tE - t_lo
            rq0, rq1 = qS - q_lo, qE - q_lo
            probs.append((
                t_chars[rt1:min(tn, rt1 + self.max_ext)].tobytes(),
                q_chars[rq1:min(qn, rq1 + self.max_ext)].tobytes(), 1))
            probs.append((
                t_chars[max(0, rt0 - self.max_ext):rt0].tobytes(),
                q_chars[max(0, rq0 - self.max_ext):rq0].tobytes(), -1))
        return hsps, probs

    def _gapped(self, hsps: list, t_region: np.ndarray, q_region: np.ndarray,
                t_lo: int, q_lo: int) -> list:
        """Extend HSPs across indels; keep alignments scoring >= L.

        All (left, right) extension problems are built up front and run
        through the batched banded-DP kernel (ops/pallas_band: Pallas on
        TPU, the numpy band_ext loop elsewhere - identical results), then
        the best-first coverage replay uses the batch results."""
        hsps, probs = self._gapped_probs(hsps, t_region, q_region, t_lo, q_lo)
        exts = self._band_batch().run(probs)
        return self._gapped_finish(hsps, exts, t_region, q_region,
                                   t_lo, q_lo)

    def _gapped_finish(self, hsps: list, exts: list,
                       t_region: np.ndarray, q_region: np.ndarray,
                       t_lo: int, q_lo: int) -> list:
        """Replay the best-first coverage using precomputed extension
        results (exts[2i] = right, exts[2i+1] = left for hsps[i])."""
        covered: list[tuple[int, int, int]] = []  # (diag, t0, t1) in region
        out = []
        for hi, (tS, tE, qS, qE, hsp_score) in enumerate(hsps):
            rt0, rt1 = tS - t_lo, tE - t_lo
            rq0 = qS - q_lo
            diag = rt0 - rq0
            if any(d == diag and c0 <= rt0 and rt1 <= c1
                   for d, c0, c1 in covered):
                continue
            total = hsp_score
            blocks = [[tS, tE, qS, qE]]
            ok, t_sym, q_sym, _, _ = exts[2 * hi]       # right extension
            if ok:
                eb, es = self._ext_blocks_and_score(t_sym, q_sym, tE, qE, 1)
                blocks.extend(eb)
                total += es
            ok, t_sym, q_sym, _, _ = exts[2 * hi + 1]   # left extension
            if ok:
                eb, es = self._ext_blocks_and_score(t_sym, q_sym, tS, qS, -1)
                blocks.extend(eb)
                total += es
            if total < self.gapped_threshold:
                continue
            for bt0, bt1, bq0, bq1 in blocks:
                covered.append((bt0 - bq0 - (t_lo - q_lo),
                                bt0 - t_lo, bt1 - t_lo))
            out.extend([b[0], b[1], b[2], b[3],
                        int(self.lut[q_region[b[2] - q_lo:b[3] - q_lo],
                                     t_region[b[0] - t_lo:b[1] - t_lo]]
                            .sum())]
                       for b in blocks)
        out.sort(key=lambda b: (b[2], b[0]))
        return out

    def _seed_pairs(self, t_region: np.ndarray, q_region: np.ndarray,
                    k: int) -> tuple[np.ndarray, np.ndarray] | None:
        """All exact k-mer matches as (t_pos, q_pos) arrays (region
        coords), or None when either side has no valid word."""
        t_kmers = kmer_codes(t_region, k)
        q_kmers = kmer_codes(q_region, k)
        if t_kmers.size == 0 or q_kmers.size == 0:
            return None
        order = np.argsort(t_kmers, kind="stable")
        t_sorted = t_kmers[order]
        lo_idx = np.searchsorted(t_sorted, q_kmers, side="left")
        hi_idx = np.searchsorted(t_sorted, q_kmers, side="right")
        counts = np.where(q_kmers >= 0, hi_idx - lo_idx, 0)
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        if total > self.max_seeds:
            return None  # caller retries with a longer word
        q_pos = np.repeat(np.arange(q_kmers.shape[0]), counts)
        # ragged gather of order[lo:hi] per q position, fully vectorized
        cum = np.concatenate([[0], np.cumsum(counts)])
        intra = np.arange(total, dtype=np.int64) - cum[q_pos]
        t_pos = order[lo_idx[q_pos] + intra]
        return t_pos, q_pos

    def _seed_windows(self, t_region: np.ndarray, q_region: np.ndarray):
        """Per-diagonal scan windows anchored on exact-word seeds.

        Seeds on the same diagonal closer than 2*hsp_margin are merged
        into one window extended by hsp_margin on both sides (lastz's
        ungapped stage x-drop-extends each seed, so a K-scoring segment
        farther than the x-drop horizon from every seed word is
        invisible to lastz at the same W too; hsp_margin=1000 bases is
        wider than lastz's x-drop, 10*maxMatchScore in score units, a few
        tens of bases of chance sequence, so a window also holds segments
        that no seed's x-drop extension reaches: masked seeding drops
        those, _holding_a_seed).  Returns
        (diag, w0, w1) int64 arrays, windows clipped to the diagonal's
        overlap with both regions.

        When the word yields more than max_seeds matches the word length
        is raised by 2 (up to 3 times) - graceful specificity fallback
        instead of the round-1 give-up-on-the-region cliff.

        The windows come with the seeds, as (windows, (diag, t, k)): the
        seed words sorted by diagonal then target position, and the word
        length used (_holding_a_seed)."""
        k = self.seed_len
        for attempt in range(4):
            got = self._seed_pairs(t_region, q_region, k)
            if got is not None:
                break
            k += 2
        else:
            none = np.zeros(0, np.int64)
            return (none,) * 3, (none, none, k)
        t_pos, q_pos = got
        if t_pos.size == 0:
            none = np.zeros(0, np.int64)
            return (none,) * 3, (none, none, k)
        diags = t_pos - q_pos
        o = np.lexsort((t_pos, diags))
        d_s, t_s = diags[o], t_pos[o]
        margin = self.hsp_margin
        gap_limit = k + 2 * margin
        new_w = np.ones(t_s.shape[0], bool)
        new_w[1:] = (d_s[1:] != d_s[:-1]) | (t_s[1:] - t_s[:-1] > gap_limit)
        starts = np.flatnonzero(new_w)
        ends = np.concatenate([starts[1:], [t_s.shape[0]]])
        diag_w = d_s[starts]
        w0 = t_s[starts] - margin
        w1 = t_s[ends - 1] + k + margin
        # clip to the diagonal's overlap with both regions
        tn, qn = t_region.shape[0], q_region.shape[0]
        t0d = np.maximum(diag_w, 0)
        t1d = t0d + np.minimum(tn - t0d, qn - (t0d - diag_w))
        w0 = np.maximum(w0, t0d)
        w1 = np.minimum(w1, t1d)
        keep = w1 - w0 >= k
        return (diag_w[keep], w0[keep], w1[keep]), (d_s, t_s, k)

    # windows whose cells exceed this are Kadane-prefiltered in batches
    # before the exact (recursive) segment extraction runs
    _SCAN_BATCH = 8_000_000

    def _scan_windows(self, t_region: np.ndarray, q_region: np.ndarray,
                      diag_w, w0, w1, t_lo: int, q_lo: int) -> list:
        """Exact maximal-segment extraction over the given windows.

        A vectorized single-pass Kadane over all windows first computes
        each window's best segment score; the exact recursive
        _max_segments (byte-parity semantics) then runs only on windows
        whose best reaches the K threshold."""
        lut = self.hsp_lut
        blocks = []
        PERF["hsp_windows_host"] += diag_w.size
        lens = (w1 - w0).astype(np.int64)
        order = np.argsort(lens, kind="stable")  # batch similar lengths
        native = self._scan_windows_native(t_region, q_region, diag_w, w0,
                                           w1, order, t_lo, q_lo)
        if native is not None:
            return native
        csum = np.cumsum(lens[order])
        batch_edges = np.searchsorted(
            csum, np.arange(self._SCAN_BATCH, int(csum[-1]) if csum.size
                            else 0, self._SCAN_BATCH))
        batches = np.split(order, batch_edges)
        for batch in batches:
            if batch.size == 0:
                continue
            bl = lens[batch]
            n_cells = int(bl.sum())
            wid = np.repeat(np.arange(batch.shape[0]), bl)
            offs = np.concatenate([[0], np.cumsum(bl)])
            pos = np.arange(n_cells, dtype=np.int64) - offs[wid]
            t_idx = w0[batch][wid] + pos
            q_idx = t_idx - diag_w[batch][wid]
            scores = lut[q_region[q_idx], t_region[t_idx]]
            # grouped Kadane: best segment score per window in one pass
            c = np.cumsum(scores)
            base = np.concatenate([[0], c[offs[1:-1] - 1]])
            cw = c - base[wid]                      # window-local prefixes
            big = np.int64(1) << 50
            g = np.minimum.accumulate(cw - wid * big) + wid * big
            runmin = np.minimum(0, np.where(pos > 0,
                                            np.concatenate([[0], g[:-1]]),
                                            0))
            best = np.zeros(batch.shape[0], np.int64)
            np.maximum.at(best, wid, cw - runmin)
            for j in np.flatnonzero(best >= self.hsp_threshold):
                a, b = int(w0[batch[j]]), int(w1[batch[j]])
                d = int(diag_w[batch[j]])
                seg_scores = scores[offs[j]:offs[j + 1]]
                for s, e, sc in _max_segments(seg_scores,
                                              self.hsp_threshold):
                    blocks.append([t_lo + a + s, t_lo + a + e,
                                   q_lo + a - d + s, q_lo + a - d + e, sc])
        return blocks

    def _scan_windows_native(self, t_region, q_region, diag_w, w0, w1,
                             order, t_lo: int, q_lo: int) -> list | None:
        """Threaded C++ scan (native/hspscan.cpp), byte-identical to the
        numpy path incl. block emission order (windows processed in the
        caller's stable length-sorted order); None when unavailable."""
        rows = self._native_rows(t_region, q_region, diag_w[order],
                                 w0[order], w1[order], t_lo, q_lo)
        return None if rows is None else rows.tolist()

    def _native_rows(self, t_region, q_region, diag_w, w0, w1,
                     t_lo: int, q_lo: int) -> np.ndarray | None:
        """gat_hsp_scan's (n, 5) int64 rows over the windows in the given
        order; None when the native scan is unavailable."""
        lib = _native_scan()
        if lib is None:
            return None
        import ctypes
        lut25 = np.ascontiguousarray(self.hsp_lut.reshape(25), np.int32)
        tr = np.ascontiguousarray(t_region, np.uint8)
        qr = np.ascontiguousarray(q_region, np.uint8)
        dw = np.ascontiguousarray(diag_w, np.int64)
        a0 = np.ascontiguousarray(w0, np.int64)
        a1 = np.ascontiguousarray(w1, np.int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        res_p = lib.gat_hsp_scan(
            tr.ctypes.data_as(u8p), tr.shape[0],
            qr.ctypes.data_as(u8p), qr.shape[0],
            dw.ctypes.data_as(i64p), a0.ctypes.data_as(i64p),
            a1.ctypes.data_as(i64p), dw.shape[0],
            lut25.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(self.hsp_threshold), int(t_lo), int(q_lo), 0)
        try:
            n = int(res_p.contents.n)
            if n == 0:
                return np.zeros((0, 5), np.int64)
            rows = np.ctypeslib.as_array(res_p.contents.rows,
                                         shape=(n, 5)).copy()
        finally:
            lib.gat_hsp_free(res_p)
        return rows

    def align(self, t_codes: np.ndarray, q_codes: np.ndarray,
              t_lo: int, t_hi: int, q_lo: int, q_hi: int,
              t_seed_codes: np.ndarray | None = None,
              q_seed_codes: np.ndarray | None = None) -> list:
        """HSP block rows [tS, tE, qS, qE, score] (absolute coordinates in
        the supplied code arrays), sorted by (q, t).

        t_seed_codes/q_seed_codes: optional arrays used ONLY for seed
        discovery (soft-masked positions set to code 4 reproduce lastz's
        default masked seeding, where repeats cannot seed but extensions
        score through them; patchChain.perl:24 `[unmask]` lifts this)."""
        seeded = self.align_seed(t_codes, q_codes, t_lo, t_hi, q_lo, q_hi,
                                 t_seed_codes, q_seed_codes)
        if seeded is None:
            return []
        blocks = self.align_scan_batch([seeded])[0]
        if self.gapped_threshold is not None:
            t_region, q_region, t_lo, q_lo = seeded[:4]
            return self._gapped(blocks, t_region, q_region, t_lo, q_lo)
        blocks.sort(key=lambda b: (b[2], b[0]))
        return blocks

    def align_prepare(self, t_codes: np.ndarray, q_codes: np.ndarray,
                      t_lo: int, t_hi: int, q_lo: int, q_hi: int,
                      t_seed_codes: np.ndarray | None = None,
                      q_seed_codes: np.ndarray | None = None):
        """First half of align() for cross-region batching: seeds + HSP
        scan + banded-DP problem construction, WITHOUT running the DP.

        Returns (done, state, probs): when done is not None it is the
        final result (no gapped stage, or nothing to extend) and
        state/probs are empty; otherwise run all probs (from many
        prepare calls, concatenated) through one BandExtBatch.run and
        hand each region's slice to align_finish(state, exts).  Identical
        results to per-region align() - the DP problems are
        self-contained byte strings."""
        seeded = self.align_seed(t_codes, q_codes, t_lo, t_hi, q_lo, q_hi,
                                 t_seed_codes, q_seed_codes)
        if seeded is None:
            return [], None, []
        return self.align_probs(seeded, self.align_scan_batch([seeded])[0])

    # align_prepare's three stages, for callers that run each stage over
    # many regions before the next (engines/repeat_filler.py)
    def align_seed(self, t_codes: np.ndarray, q_codes: np.ndarray,
                   t_lo: int, t_hi: int, q_lo: int, q_hi: int,
                   t_seed_codes: np.ndarray | None = None,
                   q_seed_codes: np.ndarray | None = None):
        """The regions and their seed windows, or None when a region is
        larger than max_region.  With seed codes (masked seeding) the seed
        words are kept too, for align_scan's _holding_a_seed."""
        if t_hi - t_lo > self.max_region or q_hi - q_lo > self.max_region:
            return None
        t_region = t_codes[t_lo:t_hi]
        q_region = q_codes[q_lo:q_hi]
        t_seed = (t_region if t_seed_codes is None
                  else t_seed_codes[t_lo:t_hi])
        q_seed = (q_region if q_seed_codes is None
                  else q_seed_codes[q_lo:q_hi])
        windows, seeds = self._seed_windows(t_seed, q_seed)
        masked = t_seed_codes is not None or q_seed_codes is not None
        return (t_region, q_region, t_lo, q_lo, windows,
                seeds if masked else None)

    def align_scan(self, seeded) -> list:
        """The HSP rows of align_seed's windows; under masked seeding only
        those that hold a seed word (_holding_a_seed)."""
        t_region, q_region, t_lo, q_lo, (diag_w, w0, w1), seeds = seeded
        blocks = self._scan_windows(t_region, q_region, diag_w, w0, w1,
                                    t_lo, q_lo)
        if seeds is None:
            return blocks
        return _holding_a_seed(blocks, seeds, t_lo, q_lo)

    def align_scan_batch(self, seeded_list: list) -> list:
        """align_scan over many of align_seed's results: each one's HSP
        rows (None for None), the same rows in the same order.

        On the aligner's band device every window of every region is
        scored at once: the regions and windows are concatenated, one
        hsp_best call (one K4 launch on the card, the plain version on the
        CPU) gives each window's best segment score, and the exact split
        into maximal segments runs on the host only over the windows whose
        best reaches K, in each region's stable length-sorted window order,
        as the host scan emits them.  A window under K emits nothing on
        either path.  Without a band device (GAT_BAND=host) each region
        runs the threaded host scan."""
        if self.device is None:
            return [None if s is None else self.align_scan(s)
                    for s in seeded_list]
        live = [s for s in seeded_list if s is not None]
        rows = iter(self._scan_batch_rows(live) if live else [])
        out = []
        for s in seeded_list:
            if s is None:
                out.append(None)
                continue
            blocks = next(rows)
            out.append(blocks if s[5] is None
                       else _holding_a_seed(blocks, s[5], s[2], s[3]))
        return out

    def _scan_batch_rows(self, live: list) -> list:
        """The HSP rows of each of align_seed's results in `live`, every
        segment of its windows (align_scan_batch)."""
        with phase("hsp: to device"):
            packed = pack_windows(live)
            t_buf, q_buf, t_start, q_start, length, gid, t_off, q_off = packed
            best = self._window_bests(t_buf, q_buf, t_start, q_start, length)
        PERF["hsp_windows_device"] += best.size
        with phase("hsp: exact segments"):
            hit = np.flatnonzero(best >= self.hsp_threshold)
            PERF["hsp_windows_exact"] += hit.size
            # each region's windows in stable length order, as _scan_windows
            hit = hit[np.lexsort((length[hit], gid[hit]))]
            found = self._exact_rows(t_buf, q_buf, t_start[hit],
                                     q_start[hit], length[hit])
            # back to each region's coordinates, then one list a region
            g = np.searchsorted(t_off, found[:, 0], side="right") - 1
            found[:, :2] += (np.array([s[2] for s in live]) - t_off)[g, None]
            found[:, 2:4] += (np.array([s[3] for s in live]) - q_off)[g, None]
            cuts = np.searchsorted(g, np.arange(1, len(live)))
            return [part.tolist() for part in np.split(found, cuts)]

    def _window_bests(self, t_buf, q_buf, t_start, q_start, length):
        """hsp_best over the concatenated windows on the band device (K4 on
        the card, fed from pinned staging; the plain version on the CPU),
        as int32 on the host."""
        from .hsp_scan import hsp_best
        lut = torch.from_numpy(self.hsp_lut.astype(np.int32))
        dev = self.device
        if dev.type == "cuda":
            def up(a):
                return torch.from_numpy(a).pin_memory().to(dev,
                                                           non_blocking=True)
        else:
            up = torch.from_numpy
        best = hsp_best(up(t_buf), up(q_buf), lut, up(t_start), up(q_start),
                        up(length))
        return best.cpu().numpy()

    def _exact_rows(self, t_buf, q_buf, t_start, q_start, length):
        """(n, 5) int64 rows [tS, tE, qS, qE, score] of every maximal
        segment of at least K of the given windows, window by window in
        the given order, in the buffers' coordinates: the native scan where
        built, else _max_segments."""
        t_end = t_start + length
        rows = self._native_rows(t_buf, q_buf, t_start - q_start, t_start,
                                 t_end, 0, 0)
        if rows is not None:
            return rows
        found = []
        for ts, qs, n in zip(t_start.tolist(), q_start.tolist(),
                             length.tolist()):
            scores = self.hsp_lut[q_buf[qs:qs + n], t_buf[ts:ts + n]]
            found += [[ts + a, ts + e, qs + a, qs + e, sc]
                      for a, e, sc in _max_segments(scores,
                                                    self.hsp_threshold)]
        return np.array(found, np.int64).reshape(-1, 5)

    def align_probs(self, seeded, blocks: list):
        """align_prepare's (done, state, probs) from the HSP rows."""
        t_region, q_region, t_lo, q_lo = seeded[:4]
        if self.gapped_threshold is None:
            blocks.sort(key=lambda b: (b[2], b[0]))
            return blocks, None, []
        hsps, probs = self._gapped_probs(blocks, t_region, q_region,
                                         t_lo, q_lo)
        if not probs:
            return [], None, []
        return None, (hsps, t_region, q_region, t_lo, q_lo), probs

    def align_finish(self, state, exts: list) -> list:
        """Second half of align_prepare: exts must be the BandExtBatch
        results for exactly this region's probs slice."""
        hsps, t_region, q_region, t_lo, q_lo = state
        return self._gapped_finish(hsps, exts, t_region, q_region,
                                   t_lo, q_lo)
