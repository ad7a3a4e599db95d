"""Per-chunk block scoring on the device: chunking, K1 and its plain version.

Counterpart of genomealignmenttools_tpu/ops/pallas_rescore.py: `chunk_blocks`
is the chunking of `pack_windows` (pallas_rescore.py:196-204), `chunk_sums`
wraps the CUDA kernel csrc/rescore.cu that replaces `_rescore_kernel`
(pallas_rescore.py:43-136), `chunk_sums_plain` is the same function in plain
PyTorch (in the spirit of `_build_block_scores_kernel`, ops/rescore.py:
110-140), and `WindowBlockScorer` has the contract of `PallasBlockScorer`
(pallas_rescore.py:267-384): `chunk_scores_multi` for the native combine
and `block_scores` per job.

Blocks are cut into chunks of at most CHUNK bases; chunk sums are exact in
int32 (CHUNK * 127 < 2^31).  The TPU's 16 kb windows, the per-window Python
loop of `pack_windows` (pallas_rescore.py:220-236) and the fixed batch shape
WB are not needed: the kernel reads each chunk straight from the genome
codes resident on the card.

K1 reads a chunk's bases as 16-byte words from 16-byte aligned addresses,
so the last word of a genome may hold bytes past its end.  Genome codes
therefore live in a storage padded with N (4) to a multiple of 16 bytes
(`upload_codes`, used by TorchGenomeCache and ShardedBlockScorer), and the
wrapper copies any code tensor whose storage does not hold the aligned span
around it into one that does (`padded_codes`): the loads then stay inside
the allocation whatever the allocator rounds.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..device import LAUNCHES, PERF
from ..utils.profiling import phase

CHUNK = 256  # max bases per chunk (pallas_rescore.py:37)
ALIGN = 16   # bytes of K1's aligned loads (csrc/rescore.cu)
N_CODE = 4


def _padded_len(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _padded_copy(codes: torch.Tensor, device) -> torch.Tensor:
    """uint8 `codes` copied to `device` into the first bytes of a new
    storage padded with N to a multiple of ALIGN bytes."""
    n = codes.numel()
    buf = torch.empty(_padded_len(n), dtype=torch.uint8, device=device)
    buf[n:].fill_(N_CODE)
    buf[:n].copy_(codes)
    return buf[:n]


def upload_codes(codes: np.ndarray, device) -> torch.Tensor:
    """uint8 genome codes on `device` in a storage padded with N to a
    multiple of 16 bytes: what K1 takes without a copy."""
    return _padded_copy(
        torch.from_numpy(np.ascontiguousarray(codes, np.uint8)), device)


def padded_codes(codes: torch.Tensor) -> torch.Tensor:
    """`codes` itself where its storage holds the 16-byte aligned span
    around it, else a copy in a storage that does (upload_codes' layout)."""
    st = codes.untyped_storage()
    lo = codes.data_ptr() // ALIGN * ALIGN
    hi = _padded_len(codes.data_ptr() + codes.numel())
    if st.data_ptr() <= lo and hi <= st.data_ptr() + st.nbytes():
        return codes
    return _padded_copy(codes, codes.device)


def chunk_blocks(blocks: np.ndarray, chunk: int = CHUNK):
    """Split (n, 4) [tS, tE, qS, qE] blocks into chunks of <= `chunk` bases.

    Returns (t_off int64, q_off int64, length int32, c_block int64), in
    block order.  A block of size 0 still gets one chunk of length 0, as in
    pack_windows and pair_rescore.chunk_blocks (pair_rescore.py:192-206), so
    c_block is the same as the reference's."""
    blocks = np.asarray(blocks)
    n = blocks.shape[0]
    sizes = (blocks[:, 1] - blocks[:, 0]).astype(np.int64)
    per_block = np.maximum((sizes + chunk - 1) // chunk, 1)
    c_block = np.repeat(np.arange(n, dtype=np.int64), per_block)
    first = np.cumsum(per_block) - per_block
    within = np.arange(c_block.shape[0], dtype=np.int64) - np.repeat(
        first, per_block)
    t_off = blocks[c_block, 0].astype(np.int64) + within * chunk
    q_off = blocks[c_block, 2].astype(np.int64) + within * chunk
    length = np.minimum(sizes[c_block] - within * chunk, chunk).astype(
        np.int32)
    return t_off, q_off, length, c_block


def _check_args(t_codes, q_codes, lut, t_off, q_off, length) -> None:
    """Raise on anything the kernel does not take: device, dtype, shape,
    contiguity, chunk lengths and chunk bounds."""
    dev = t_codes.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no rescore path for device {dev}")
    for name, x, dtype in (("t_codes", t_codes, torch.uint8),
                           ("q_codes", q_codes, torch.uint8),
                           ("t_off", t_off, torch.int64),
                           ("q_off", q_off, torch.int64),
                           ("length", length, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t_codes on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    if not (t_off.numel() == q_off.numel() == length.numel()):
        raise ValueError("t_off, q_off and length differ in length")
    if lut.device.type != "cpu" or lut.dtype != torch.int32 \
            or tuple(lut.shape) != (5, 5):
        raise ValueError("lut must be a (5, 5) int32 tensor on the CPU")
    if length.numel() == 0:
        return
    ln = length.to(torch.int64)
    bad = ((length < 0) | (length > CHUNK) | (t_off < 0) | (q_off < 0)
           | (t_off + ln > t_codes.numel()) | (q_off + ln > q_codes.numel()))
    if bool(bad.any()):
        raise IndexError("a chunk lies outside its genome code array or is "
                         f"not 0..{CHUNK} bases long")


def chunk_sums_plain(t_codes, q_codes, lut, t_off, q_off, length):
    """int32 per-chunk sums of lut[q][t], N (code >= 4) scoring 0, in plain
    PyTorch on the tensors' own device: expand chunks to bases, gather both
    genomes, look up, index_add_ per chunk."""
    dev = t_codes.device
    n = length.numel()
    ln = length.to(torch.int64)
    total = int(ln.sum())
    chunk = torch.repeat_interleave(torch.arange(n, device=dev), ln,
                                    output_size=total)
    start = torch.cumsum(ln, 0) - ln
    pos = torch.arange(total, device=dev) - start[chunk]
    tc = t_codes[t_off[chunk] + pos].to(torch.int64)
    qc = q_codes[q_off[chunk] + pos].to(torch.int64)
    table = torch.zeros(5, 5, dtype=torch.int32)
    table[:4, :4] = lut[:4, :4]
    table = table.to(dev).reshape(-1)
    vals = table[qc.clamp(max=4) * 5 + tc.clamp(max=4)]
    return torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, chunk, vals)


def _launch_kernel(t_codes, q_codes, lut, t_off, q_off, length):
    """Launch K1 on the current stream of the tensors' CUDA device."""
    lib = _build.load_library()
    dev = t_codes.device
    t_codes, q_codes = padded_codes(t_codes), padded_codes(q_codes)
    n = length.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lut25 = (ctypes.c_int32 * 25)(*lut.reshape(-1).tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gat_rescore_chunks(
            t_codes.data_ptr(), q_codes.data_ptr(), lut25,
            t_off.data_ptr(), q_off.data_ptr(), length.data_ptr(), n,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("rescore_chunks launch failed: "
                           + lib.gat_cuda_error_string(err).decode())
    LAUNCHES["rescore_chunks"] += 1
    return out


def chunk_sums(t_codes, q_codes, lut, t_off, q_off, length):
    """Per-chunk int32 sums of lut[q][t] over chunks (t_off, q_off, length).

    On CUDA tensors this launches K1 (csrc/rescore.cu) or raises; on CPU
    tensors it runs the plain version.  All tensors are 1-D and contiguous
    on one device: uint8 codes, int64 offsets, int32 lengths; `lut` is a
    (5, 5) int32 CPU tensor indexed [q, t]."""
    _check_args(t_codes, q_codes, lut, t_off, q_off, length)
    PERF["dispatches"] += 1
    if t_codes.device.type == "cuda":
        return _launch_kernel(t_codes, q_codes, lut, t_off, q_off, length)
    return chunk_sums_plain(t_codes, q_codes, lut, t_off, q_off, length)


def checked_lut(lut: np.ndarray) -> torch.Tensor:
    """(5, 5) int32 CPU tensor of a scheme LUT.  Like pack_lut
    (pallas_rescore.py:169-185), it requires a zero N row and column, so
    that skipping N bases is exact, and int8-range scores."""
    lut = np.asarray(lut, np.int64)
    if lut.shape != (5, 5):
        raise ValueError(f"score LUT must be 5x5, got {lut.shape}")
    if np.any(lut[4, :] != 0) or np.any(lut[:, 4] != 0):
        raise ValueError("score LUT must have a zero N row and column")
    if np.any((lut < -128) | (lut > 127)):
        raise ValueError("score LUT entries must fit int8")
    return torch.from_numpy(lut.astype(np.int32))


class WindowBlockScorer:
    """Block scorer over genome codes resident on one device; same
    contract as PallasBlockScorer (pallas_rescore.py:267-384).

    `host_native` is False: the engines then batch their sub-chain scoring
    through score_chains, and so through the kernel (chain_cleaner.py:
    709-713, 1076-1080; chain_net.py:1006-1016)."""

    host_native = False

    def __init__(self, lut: np.ndarray, t_cache, q_cache):
        self.lut = checked_lut(lut)
        self.t_cache = t_cache
        self.q_cache = q_cache
        self.device = t_cache.device

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        if self.device.type != "cpu":
            PERF["h2d_bytes"] += a.nbytes
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _dispatch(self, t_name, q_name, q_strand, blocks):
        """Launch one job's chunk sums (asynchronous on CUDA); returns the
        device output and the chunk -> block map."""
        with phase("rescore: chunk blocks"):
            t_off, q_off, length, c_block = chunk_blocks(blocks)
        with phase("rescore: genome codes to device"):
            t_codes = self.t_cache.codes(t_name, "+")
            q_codes = self.q_cache.codes(q_name, q_strand)
        with phase("rescore: chunks to device"):
            chunks = [self._upload(a) for a in (t_off, q_off, length)]
        with phase("rescore: check + launch"):
            out = chunk_sums(t_codes, q_codes, self.lut, *chunks)
        return out, c_block

    def _fetch(self, out: torch.Tensor) -> np.ndarray:
        with phase("rescore: wait + sums to host"):
            host = out.cpu().numpy()
        if self.device.type != "cpu":
            PERF["d2h_bytes"] += host.nbytes
        return host

    def chunk_scores_multi(self, jobs):
        """(chunk_scores int32, c_block int64, n_blocks) across jobs
        [(t_name, q_name, q_strand, blocks)], every job launched before the
        one fetch."""
        outs, cbs = [], []
        n_blocks = 0
        for (tn, qn, strand, blocks) in jobs:
            out, c_block = self._dispatch(tn, qn, strand, blocks)
            outs.append(out)
            cbs.append(c_block + n_blocks)
            n_blocks += blocks.shape[0]
        if not outs:
            return np.zeros(0, np.int32), np.zeros(0, np.int64), 0
        cs = self._fetch(torch.cat(outs))
        return cs, np.concatenate(cbs), n_blocks

    def block_scores(self, t_name: str, q_name: str, q_strand: str,
                     blocks: np.ndarray) -> np.ndarray:
        """int64[n] per-block scores for (n, 4) blocks [tS, tE, qS, qE]."""
        n = blocks.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        out, c_block = self._dispatch(t_name, q_name, q_strand, blocks)
        scores = np.zeros(n, np.int64)
        np.add.at(scores, c_block, self._fetch(out).astype(np.int64))
        return scores
