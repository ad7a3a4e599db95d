"""Batched banded affine-gap extension: K3, its wrapper, its plain version
and BandExtBatch.

Counterpart of genomealignmenttools_tpu/ops/pallas_band.py.  Each problem is
kent bandExt (ops/band_ext.py::band_ext, the bit-exact oracle): a 3-state
affine DP over a wandering band of 2*max_insert+1 cells, a local x-drop stop
or global mode, and a traceback into moves (1 = diagonal, 2 = up, a gap in
a; 3 = left, a gap in b).  `band_ext_batch` launches K3 (csrc/band.cu) on
CUDA tensors and runs `band_ext_plain` on CPU tensors; both return the same
(meta, moves) bits:

    meta   int32 (P, 6): ok, best score, a_best, b_best, n_moves, err
    moves  uint8, problem i's n_moves moves at a_off[i] + b_off[i]

over ragged uint8 codes (T=0 C=1 A=2 G=3 N=4; every problem at least one
base on each side) with int64 offsets.  `err` is ERR_OUT_OF_BAND for a
traceback that left the band (band_ext.py:202-205) and ERR_WANDERED where
band_ext itself fails with IndexError.  BandExtBatch.run turns problems of
byte strings into band_ext's tuples: direction and empty sides on the host, as
pallas_band.py:532-545 does, sub-batches under a byte budget, and the moves
back into symbol strings (pallas_band.py:552-588).  An out-of-band traceback
raises AssertionError in local mode and returns (False, b"", b"", a_best,
b_best) in global mode, as band_ext does, straight from the error flag
(the reference re-runs such problems on the host, pallas_band.py:557-564).

Scores use the 5x5 matrix of char_matrix over b"TCAGN" (pallas_band.py:
419-423) and codes from device/genome._CHAR_CODE, so the results equal
band_ext's for sequences over TCAGN, which is what GapAligner builds.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import _build
from ..device import LAUNCHES, PERF, resolve_device
from ..device.genome import _CHAR_CODE
from ..utils.profiling import phase

MP_MATCH, MP_UP, MP_LEFT, MP_MASK = 1, 2, 3, 3
UP_EXT = 1 << 2
LP_EXT = 1 << 3
MOVE_DIAG, MOVE_UP, MOVE_LEFT = 1, 2, 3
# meta's err: the traceback left the band (band_ext.py:202-205), or, in
# global mode, the band centre fell so far below 0 that the seed cell lies
# past the state arrays, where band_ext's cur_u[cur_off - 1] raises
# IndexError (band_ext.py:90) and the C code writes out of bounds
ERR_OUT_OF_BAND, ERR_WANDERED = 1, 2

MAX_INSERT_LIMIT = 128          # max_insert < 128 (pallas_band.py:410-411)
NEG = -(1 << 30)                # the kernel's mask value
INT32_SAFE = 1 << 29            # bound on |state| checked by the constructor
PARENT_BUDGET = 1 << 31         # parent bytes of one sub-batch
LANES = 32                      # a warp; K3 runs one warp a problem
# (n_problems, 2) int32 on the card, of K3's last launch: the columns each
# problem ran and the band cells it computed (the local x-drop ends a
# problem early); what a roofline bound of that launch counts
LAST_WORK: dict = {"band_ext": None}
_DASH = ord("-")


def band_on_host() -> bool:
    """GAT_BAND: unset or `auto` runs the DP on the port's device; `host`
    names the host band batch (native/bandext.cpp, else numpy band_ext), the
    reference's path on a machine without a TPU (pallas_band.py:427-451).
    Nothing chooses the host on its own, and any other value raises."""
    mode = os.environ.get("GAT_BAND", "auto")
    if mode not in ("", "auto", "host"):
        raise ValueError(f"GAT_BAND={mode!r}: use auto (the port's device) "
                         "or host (the host band batch)")
    return mode == "host"


def band_device(device: str | torch.device | None) -> torch.device | None:
    """The device the band DP runs on; None when GAT_BAND=host names the
    host band batch, whatever `device` says."""
    return None if band_on_host() else resolve_device(device)


def parent_layout(max_insert: int) -> tuple[int, int]:
    """(cells per lane, bytes of parent scratch per column of `a`) of K3.

    A lane owns C = ceil(band_size / 32) band cells and packs their 4-bit
    parents into one word of 1 (C <= 2), 2 (C <= 4) or 4 bytes; a column is
    32 such words, cell j in nibble j % C of word j // C (csrc/band.cu)."""
    cells = -(-(2 * max_insert + 1) // LANES)
    return cells, LANES * (1 if cells <= 2 else 2 if cells <= 4 else 4)


def pack_parents(parents: np.ndarray, max_insert: int) -> np.ndarray:
    """K3's parent words of one column-major parent array: (columns, n <=
    band_size) uint8 parents (4 bits each) -> (columns, 32) words.  The
    kernel's layout in numpy, for the tests and for reading a scratch."""
    cells, row_bytes = parent_layout(max_insert)
    cols, n = parents.shape
    slots = np.zeros((cols, LANES * cells), np.uint32)
    slots[:, :n] = parents & 15
    words = np.zeros((cols, LANES), np.uint32)
    for c in range(cells):
        words |= slots[:, c::cells] << np.uint32(4 * c)
    return words.astype({32: np.uint8, 64: np.uint16,
                         128: np.uint32}[row_bytes])


def unpack_parents(words: np.ndarray, max_insert: int) -> np.ndarray:
    """The inverse of pack_parents: (columns, 32) words -> (columns,
    32 * cells) uint8 parents, cell j at column index j."""
    cells, _ = parent_layout(max_insert)
    w = words.astype(np.uint32)
    out = np.zeros((w.shape[0], LANES * cells), np.uint8)
    for c in range(cells):
        out[:, c::cells] = (w >> np.uint32(4 * c)) & 15
    return out


def _check_args(a_codes, a_off, b_codes, b_off, mat, max_insert) -> None:
    """Raise on anything the kernel does not take."""
    dev = a_codes.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no band path for device {dev}")
    for name, x, dtype in (("a_codes", a_codes, torch.uint8),
                           ("a_off", a_off, torch.int64),
                           ("b_codes", b_codes, torch.uint8),
                           ("b_off", b_off, torch.int64)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, a_codes on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if mat.device.type != "cpu" or mat.dtype != torch.int32 \
            or tuple(mat.shape) != (5, 5):
        raise ValueError("mat must be a (5, 5) int32 tensor on the CPU")
    if not 0 <= max_insert < MAX_INSERT_LIMIT:
        raise ValueError(f"max_insert must be in 0..{MAX_INSERT_LIMIT - 1}")
    if a_off.numel() != b_off.numel() or a_off.numel() < 2:
        raise ValueError("a_off and b_off must hold n_problems + 1 >= 2 "
                         "offsets each")
    for codes, off, side in ((a_codes, a_off, "a"), (b_codes, b_off, "b")):
        ok = (bool((off[1:] - off[:-1] >= 1).all()) and int(off[0]) == 0
              and int(off[-1]) == codes.numel())
        if not ok:
            raise ValueError(f"{side} offsets must start at 0, end at the "
                             "codes' length and give every problem a base")
        if int(codes.max()) > 4:
            raise ValueError(f"{side} codes must be 0..4")


def band_ext_plain(a_codes, a_off, b_codes, b_off, mat, global_mode: bool,
                   gap_open: int, gap_extend: int, max_insert: int):
    """(meta, moves) in plain PyTorch on the tensors' own device.

    band_ext batched over problems: a Python loop over columns with tensor
    ops over (problem, band cell), int64 state, per-problem band centre,
    shift and done flags, uint8 parents (P, a_max, band_size + 1), then a
    batched traceback loop.  Each state array has one spare column past
    band_plus that takes the writes of masked cells."""
    dev = a_codes.device
    O, E, mi = int(gap_open), int(gap_extend), int(max_insert)
    mi1 = mi + 1
    W = 2 * mi + 1                       # band_size
    bp = W + 2 * mi1                     # band_plus; column bp is the spare
    bad = -O * 100
    max_drop = O + E * mi
    mid = 1 + 2 * mi
    i64 = torch.int64
    n_prob = a_off.numel() - 1
    a_len = a_off[1:] - a_off[:-1]
    b_len = b_off[1:] - b_off[:-1]
    A, B = int(a_len.max()), int(b_len.max())
    rows = torch.arange(n_prob, device=dev)
    a_dense = a_codes[(a_off[:-1, None] + torch.arange(A, device=dev))
                      .clamp(max=a_codes.numel() - 1)].to(i64)
    b_dense = b_codes[(b_off[:-1, None] + torch.arange(B, device=dev))
                      .clamp(max=b_codes.numel() - 1)].to(i64)
    mat_flat = mat.to(device=dev, dtype=i64).reshape(-1)
    j = torch.arange(W, device=dev)
    jE = j * E

    cur_m, cur_u, cur_l, prev_m, prev_u, prev_l = torch.full(
        (6, n_prob, bp + 1), bad, dtype=i64, device=dev).unbind(0)
    prev_m[:, mid] = 0                                     # band_ext.py:62-66
    prev_u[:, mid:mid + mi] = -O - torch.arange(mi, device=dev) * E
    parents = torch.zeros((n_prob, A, W + 1), dtype=torch.uint8, device=dev)
    centers = torch.zeros((n_prob, A), dtype=i64, device=dev)
    band_center = torch.zeros(n_prob, dtype=i64, device=dev)
    col_shift = torch.ones(n_prob, dtype=i64, device=dev)
    best = torch.zeros(n_prob, dtype=i64, device=dev)
    a_best = torch.full((n_prob,), -1, dtype=i64, device=dev)
    b_best = torch.full((n_prob,), -1, dtype=i64, device=dev)
    done = torch.zeros(n_prob, dtype=torch.bool, device=dev)
    wandered = torch.zeros(n_prob, dtype=torch.bool, device=dev)
    init_gap = -O
    for a_pos in range(A):
        active = (a_len > a_pos) & ~done
        if a_pos % 32 == 0 and not bool(active.any()):
            break
        col_top = (band_center - mi).clamp(min=0)
        col_bottom = torch.minimum(band_center + mi1, b_len)
        cur_off = mi1 + col_top - (band_center - mi)
        prev_off = cur_off + col_shift
        n = col_bottom - col_top
        lost = active & (cur_off - 1 >= bp)
        wandered |= lost
        done |= lost
        active &= ~lost
        cur_u[rows, torch.where(active, cur_off - 1, bp)] = (
            init_gap if a_pos < mi else bad)
        if a_pos < mi:
            init_gap -= E
        cell = active[:, None] & (j < n[:, None])
        # match state: diagonal reads at prev_off - 1 + j (band_ext.py:112-121)
        diag = ((prev_off - 1)[:, None] + j).clamp(0, bp)
        pm, pl, pu = (x.gather(1, diag) for x in (prev_m, prev_l, prev_u))
        b_win = b_dense.gather(1, (col_top[:, None] + j).clamp(max=B - 1))
        match = mat_flat[a_dense[:, a_pos, None] * 5 + b_win]
        use_diag = (pm >= pl) & (pm >= pu)
        use_left = ~use_diag & (pl > pu)
        m_new = match + torch.where(use_diag, pm,
                                    torch.where(use_left, pl, pu))
        parent = torch.where(use_diag, MP_MATCH,
                             torch.where(use_left, MP_LEFT, MP_UP))
        # left state: same row of the previous column (band_ext.py:124-130)
        left = (diag + 1).clamp(max=bp)
        ext = prev_l.gather(1, left) - E
        opn = prev_m.gather(1, left) - O
        l_ext = ext >= opn
        l_new = torch.where(l_ext, ext, opn)
        # up state: prefix max of cand + k*E, minus k*E (band_ext.py:135-158)
        seed = (cur_off - 1).clamp(max=bp)[:, None]
        seed_u, seed_m = cur_u.gather(1, seed), cur_m.gather(1, seed)
        cand_m = torch.cat([seed_m, m_new[:, :-1]], 1)
        open_c = cand_m - O + jE
        open_c[:, :1] = torch.maximum(open_c[:, :1], seed_u - E)
        u_new = torch.cummax(open_c, 1).values - jE
        u_ext = (torch.cat([seed_u, u_new[:, :-1]], 1) - E) >= (cand_m - O)
        parent = parent | (l_ext * LP_EXT) | (u_ext * UP_EXT)
        target = torch.where(cell, cur_off[:, None] + j, bp)
        cur_m.scatter_(1, target, m_new)
        cur_l.scatter_(1, target, l_new)
        cur_u.scatter_(1, target, u_new)
        parents[:, a_pos].scatter_(
            1, torch.where(cell, (cur_off - mi1)[:, None] + j, W),
            parent.to(torch.uint8))
        # column best, first maximum (band_ext.py:166-168)
        masked = torch.where(cell, m_new, NEG)
        col_best = masked.max(1).values
        col_idx = torch.where(masked == col_best[:, None], j, W).min(1).values
        col_best = torch.where(n > 0, col_best, bad)
        col_pos = col_top + col_idx
        new_best = active & (best < col_best)
        drop = active & ~new_best & (col_best < best - max_drop)
        keep = active & ~new_best & ~drop
        best = torch.where(new_best, col_best, best)
        a_best = torch.where(new_best, a_pos, a_best)
        b_best = torch.where(new_best, col_pos, b_best)
        col_shift = torch.where(new_best, col_pos + 1 - band_center,
                                torch.where(keep, 1, col_shift))
        if not global_mode:
            done = done | drop
            active = active & ~drop
        centers[:, a_pos] = torch.where(active, band_center, 0)
        band_center = torch.where(active, band_center + col_shift,
                                  band_center)
        cur_m, prev_m = prev_m, cur_m
        cur_u, prev_u = prev_u, cur_u
        cur_l, prev_l = prev_l, cur_l

    # traceback (band_ext.py:188-236), all problems in step
    ok = (torch.ones(n_prob, dtype=torch.bool, device=dev) if global_mode
          else best > 0) & ~wandered
    ap = a_len - 1 if global_mode else a_best.clone()
    bq = b_len - 1 if global_mode else b_best.clone()
    L = A + B
    mv = torch.zeros((n_prob, L + 1), dtype=torch.uint8, device=dev)
    cnt = torch.zeros(n_prob, dtype=i64, device=dev)
    err = torch.zeros(n_prob, dtype=torch.bool, device=dev)
    up = torch.zeros(n_prob, dtype=torch.bool, device=dev)
    lf = torch.zeros(n_prob, dtype=torch.bool, device=dev)
    run = ok.clone()
    for step in range(L):
        if step % 32 == 0 and not bool(run.any()):
            break
        a_c = ap.clamp(0, A - 1)
        p_off = (bq - centers[rows, a_c] + mi).clamp(min=0)
        out = run & (p_off >= W)
        err |= out
        run = run & ~out
        parent = parents[rows, a_c, p_off.clamp(max=W - 1)].to(i64)
        move = torch.where(up, MOVE_UP, torch.where(lf, MOVE_LEFT, MOVE_DIAG))
        mv.scatter_(1, torch.where(run, cnt, L)[:, None],
                    move.to(torch.uint8)[:, None])
        cnt = cnt + run
        ap = ap - (run & (move != MOVE_UP)).to(i64)
        bq = bq - (run & (move != MOVE_LEFT)).to(i64)
        p = parent & MP_MASK
        new_up = torch.where(up, (parent & UP_EXT) != 0,
                             ~lf & (p == MP_UP))
        new_lf = torch.where(up, False,
                             torch.where(lf, (parent & LP_EXT) != 0,
                                         p == MP_LEFT))
        up = torch.where(run, new_up, up)
        lf = torch.where(run, new_lf, lf)
        run = run & (ap >= 0) & (bq >= 0)
    # the walk left a side: the rest of the other side (band_ext.py:227-235)
    fin = ok & ~err
    na = torch.where(fin, ap + 1, 0).clamp(min=0)
    nb = torch.where(fin, bq + 1, 0).clamp(min=0)
    k = torch.arange(L + 1, device=dev)[None]
    c0 = cnt[:, None]
    mv = torch.where((k >= c0) & (k < c0 + na[:, None]), MOVE_LEFT, mv)
    mv = torch.where((k >= c0 + na[:, None])
                     & (k < c0 + (na + nb)[:, None]), MOVE_UP, mv)
    cnt = cnt + na + nb

    moves = torch.zeros(a_codes.numel() + b_codes.numel(), dtype=torch.uint8,
                        device=dev)
    keep = k < cnt[:, None]
    moves[((a_off[:-1] + b_off[:-1])[:, None] + k)[keep]] = mv[keep]
    err = torch.where(wandered, ERR_WANDERED, err.to(i64) * ERR_OUT_OF_BAND)
    meta = torch.stack([ok.to(i64), best, a_best, b_best, cnt, err],
                       1).to(torch.int32)
    return meta, moves


def _launch_kernel(a_codes, a_off, b_codes, b_off, mat, global_mode: bool,
                   gap_open: int, gap_extend: int, max_insert: int):
    """Launch K3 on the current stream of the tensors' CUDA device."""
    lib = _build.load_library()
    dev = a_codes.device
    n_prob = a_off.numel() - 1
    # uninitialised: the kernel writes every parent word of every column it
    # runs once, before its traceback reads it
    row_bytes = parent_layout(max_insert)[1]
    if lib.gat_band_parent_row_bytes(max_insert) != row_bytes:
        raise RuntimeError("band.cu and parent_layout disagree on the parent "
                           "scratch")
    parents = torch.empty(a_codes.numel() * row_bytes, dtype=torch.uint8,
                          device=dev)
    centers = torch.empty(a_codes.numel(), dtype=torch.int32, device=dev)
    meta = torch.empty((n_prob, 8), dtype=torch.int32, device=dev)
    moves = torch.zeros(a_codes.numel() + b_codes.numel(), dtype=torch.uint8,
                        device=dev)
    mat25 = (ctypes.c_int32 * 25)(*mat.reshape(-1).tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gat_band_ext(
            a_codes.data_ptr(), a_off.data_ptr(), b_codes.data_ptr(),
            b_off.data_ptr(), n_prob, mat25, int(bool(global_mode)),
            int(gap_open), int(gap_extend), int(max_insert),
            parents.data_ptr(), centers.data_ptr(), meta.data_ptr(),
            moves.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("band_ext launch failed: "
                           + lib.gat_cuda_error_string(err).decode())
    LAUNCHES["band_ext"] += 1
    LAST_WORK["band_ext"] = meta[:, 6:]
    return meta[:, :6].contiguous(), moves


def band_ext_cuda(a_codes, a_off, b_codes, b_off, mat, global_mode: bool,
                  gap_open: int, gap_extend: int, max_insert: int):
    """K3 (csrc/band.cu) on CUDA tensors; raises on anything else."""
    _check_args(a_codes, a_off, b_codes, b_off, mat, max_insert)
    if a_codes.device.type != "cuda":
        raise ValueError(f"band_ext_cuda needs CUDA tensors, got "
                         f"{a_codes.device}")
    return _launch_kernel(a_codes, a_off, b_codes, b_off, mat, global_mode,
                          gap_open, gap_extend, max_insert)


def band_ext_batch(a_codes, a_off, b_codes, b_off, mat, global_mode: bool,
                   gap_open: int, gap_extend: int, max_insert: int):
    """(meta, moves) of every problem.  On CUDA tensors this launches K3 or
    raises; on CPU tensors it runs the plain version."""
    _check_args(a_codes, a_off, b_codes, b_off, mat, max_insert)
    PERF["dispatches"] += 1
    PERF["band_problems"] += a_off.numel() - 1
    fn = _launch_kernel if a_codes.device.type == "cuda" else band_ext_plain
    return fn(a_codes, a_off, b_codes, b_off, mat, global_mode, gap_open,
              gap_extend, max_insert)


def sub_batches(a_lens, max_insert: int, dense: bool, budget: int):
    """Contiguous [lo, hi) ranges of problems whose parent bytes fit the
    budget: sum(a_len) * parent_layout's row bytes for the kernel's ragged
    packed scratch, count * max(a_len) * (band_size + 1) for the plain
    version's dense array.  A problem alone over the budget still gets its
    own range."""
    band_size, row_bytes = 2 * max_insert + 1, parent_layout(max_insert)[1]
    ranges, lo, total, longest = [], 0, 0, 0
    for i, la in enumerate(a_lens):
        t, lg = total + la, max(longest, la)
        cost = (i - lo + 1) * lg * (band_size + 1) if dense else t * row_bytes
        if cost > budget and i > lo:
            ranges.append((lo, i))
            lo, t, lg = i, la, la
        total, longest = t, lg
    if lo < len(a_lens):
        ranges.append((lo, len(a_lens)))
    return ranges


def orient(problems, a_max: int):
    """(out, todo) for problems of (a_seq, b_seq, direction): `out` holds
    band_ext's answer for an empty side (band_ext.py:46-47) and None
    elsewhere; `todo` lists (index, a, b, direction) with both sides as
    uint8 arrays, reversed for direction < 0 (pallas_band.py:532-545)."""
    out: list = [None] * len(problems)
    todo = []
    for i, (a_seq, b_seq, direction) in enumerate(problems):
        a = np.frombuffer(a_seq, np.uint8)
        b = np.frombuffer(b_seq, np.uint8)
        if direction < 0:
            a, b = a[::-1], b[::-1]
        if a.shape[0] > a_max:
            raise ValueError(f"a_seq longer than a_max={a_max}")
        if a.shape[0] == 0 or b.shape[0] == 0:
            out[i] = (False, b"", b"", -1, -1)
        else:
            todo.append((i, a, b, direction))
    return out, todo


def pack(todo):
    """The kernel's ragged inputs (numpy): uint8 codes of every a and every
    b, concatenated, and their int64 offsets."""
    a_off = np.zeros(len(todo) + 1, np.int64)
    b_off = np.zeros(len(todo) + 1, np.int64)
    a_off[1:] = np.cumsum([len(t[1]) for t in todo])
    b_off[1:] = np.cumsum([len(t[2]) for t in todo])
    a_codes = _CHAR_CODE[np.concatenate([t[1] for t in todo])]
    b_codes = _CHAR_CODE[np.concatenate([t[2] for t in todo])]
    return a_codes, a_off, b_codes, b_off


def decode(meta_row, moves: np.ndarray, a: np.ndarray, b: np.ndarray,
           direction: int, global_mode: bool):
    """band_ext's tuple for one problem from its meta row and its moves
    (end to start): the symbol strings with '-' for gaps (pallas_band.py:
    565-588), or the error band_ext raises."""
    ok, _score, a_best, b_best, cnt, err = (int(v) for v in meta_row)
    if err == ERR_WANDERED:
        raise IndexError("bandExt band centre left the state arrays")
    if err:
        PERF["band_out_of_band"] += 1
        if not global_mode:
            raise AssertionError("bandExt traceback out of band (local)")
        return False, b"", b"", a_best, b_best
    if not ok:
        return False, b"", b"", a_best, b_best
    mv = moves[:cnt]
    a_used = mv != MOVE_UP
    b_used = mv != MOVE_LEFT
    a_idx = (len(a) if global_mode else a_best + 1) - np.cumsum(a_used)
    b_idx = (len(b) if global_mode else b_best + 1) - np.cumsum(b_used)
    sym_a = np.where(a_used, a[np.minimum(a_idx, len(a) - 1)],
                     _DASH).astype(np.uint8).tobytes()
    sym_b = np.where(b_used, b[np.minimum(b_idx, len(b) - 1)],
                     _DASH).astype(np.uint8).tobytes()
    if direction > 0:
        sym_a, sym_b = sym_a[::-1], sym_b[::-1]
    return True, sym_a, sym_b, a_best, b_best


class BandExtBatch:
    """Batched band_ext on one device: K3 on CUDA, the plain version on the
    CPU.

    run(problems): problems = [(a_seq: bytes, b_seq: bytes, direction)].
    Returns [(ok, sym_a, sym_b, a_best, b_best)] identical to
    ops.band_ext.band_ext per problem (pallas_band.BandExtBatch's contract).
    """

    def __init__(self, global_mode: bool, char_matrix: np.ndarray,
                 gap_open: int, gap_extend: int, max_insert: int,
                 a_max: int = 2048,
                 device: str | torch.device | None = None):
        if max_insert >= MAX_INSERT_LIMIT:
            raise ValueError(f"max_insert must be < {MAX_INSERT_LIMIT}")
        self.global_mode = global_mode
        self.char_matrix = char_matrix
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.max_insert = max_insert
        self.a_max = a_max
        self.device = band_device(device)
        mat = np.zeros((5, 5), np.int32)
        for i, ca in enumerate(b"TCAGN"):
            for k, cb in enumerate(b"TCAGN"):
                mat[i, k] = char_matrix[ca, cb]
        self.mat = torch.from_numpy(mat)
        # the kernel's int32 state: `bad` plus one step of the worst score
        # change per column and the in-band k*E terms must stay far from
        # the -2^30 mask
        step = abs(gap_open) + abs(gap_extend) + int(np.abs(mat).max())
        bound = (100 * abs(gap_open) + (a_max + 1) * step
                 + (4 * max_insert + 3) * abs(gap_extend))
        if bound >= INT32_SAFE:
            raise ValueError(f"scores too large for the int32 band state "
                             f"(bound {bound} >= 2^29)")

    def run(self, problems):
        if self.device is None:
            with phase("band: host batch"):
                return self._run_host(problems)
        with phase("band: orient"):
            out, todo = orient(problems, self.a_max)
        for lo, hi in sub_batches([len(t[1]) for t in todo],
                                  self.max_insert,
                                  self.device.type == "cpu",
                                  PARENT_BUDGET):
            self._run_sub(todo[lo:hi], out)
        return out

    def _run_sub(self, todo, out) -> None:
        with phase("band: pack + to device"):
            a_codes, a_off, b_codes, b_off = pack(todo)
            args = [torch.from_numpy(x).to(self.device)
                    for x in (a_codes, a_off, b_codes, b_off)]
        with phase("band: DP + fetch"):
            meta, moves = band_ext_batch(
                *args, self.mat, self.global_mode, self.gap_open,
                self.gap_extend, self.max_insert)
            meta = meta.cpu().numpy()
            moves = moves.cpu().numpy()
        with phase("band: moves to symbols"):
            for k, (i, a, b, direction) in enumerate(todo):
                base = int(a_off[k] + b_off[k])
                out[i] = decode(meta[k], moves[base:], a, b, direction,
                                self.global_mode)

    def _run_host(self, problems):
        """The host band batch, run only when GAT_BAND=host names it: the
        reference's path without a TPU (pallas_band.py:436-451), the
        threaded C++ batch or the numpy band_ext loop.  It shares nothing
        with K3 or its plain version."""
        if not problems:
            return []
        native = self._run_native(problems)
        if native is not None:
            return native
        from .band_ext import band_ext
        return [band_ext(self.global_mode, self.char_matrix,
                         self.gap_open, self.gap_extend,
                         self.max_insert, a, b, d)
                for a, b, d in problems]

    def _run_native(self, problems):
        """Threaded C++ batch (native/bandext.cpp), bit-identical to the
        numpy band_ext oracle; None when the native lib is unavailable or
        GAT_BAND_NATIVE=0."""
        import os as _os

        if _os.environ.get("GAT_BAND_NATIVE", "1") == "0":
            return None
        from ..native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "gat_band_ext_batch"):
            return None
        import ctypes
        n = len(problems)
        a_off = np.zeros(n + 1, np.int64)
        b_off = np.zeros(n + 1, np.int64)
        dirs = np.zeros(n, np.int32)
        for i, (a, b, d) in enumerate(problems):
            a_off[i + 1] = a_off[i] + len(a)
            b_off[i + 1] = b_off[i] + len(b)
            dirs[i] = d
        a_blob = np.frombuffer(b"".join(p[0] for p in problems)
                               or b"\0", np.uint8)
        b_blob = np.frombuffer(b"".join(p[1] for p in problems)
                               or b"\0", np.uint8)
        mat = np.ascontiguousarray(self.char_matrix, np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        res_p = lib.gat_band_ext_batch(
            1 if self.global_mode else 0,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(self.gap_open), int(self.gap_extend),
            int(self.max_insert),
            a_blob.ctypes.data_as(u8p), a_off.ctypes.data_as(i64p),
            b_blob.ctypes.data_as(u8p), b_off.ctypes.data_as(i64p),
            dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, 0)
        try:
            r = res_p.contents
            ok = np.ctypeslib.as_array(r.ok, shape=(n,)).copy()
            ab = np.ctypeslib.as_array(r.a_best, shape=(n,)).copy()
            bb = np.ctypeslib.as_array(r.b_best, shape=(n,)).copy()
            soff = np.ctypeslib.as_array(r.sym_off, shape=(n + 1,)).copy()
            total = int(soff[-1])
            sa = (np.ctypeslib.as_array(r.sym_a, shape=(total,)).tobytes()
                  if total else b"")
            sb = (np.ctypeslib.as_array(r.sym_b, shape=(total,)).tobytes()
                  if total else b"")
        finally:
            lib.gat_band_ext_free(res_p)
        out = []
        for i in range(n):
            if ok[i] == -2:
                raise AssertionError("bandExt traceback out of band (local)")
            out.append((bool(ok[i]),
                        sa[soff[i]:soff[i + 1]], sb[soff[i]:soff[i + 1]],
                        int(ab[i]), int(bb[i])))
        return out
