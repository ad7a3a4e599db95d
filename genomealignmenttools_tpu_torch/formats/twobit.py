"""2bit packed genome files: reader and writer.

Behavioral reference: kent/src/lib/twoBit.c and the public .2bit format spec.
Packing: 2 bits per base, T=0 C=1 A=2 G=3 (dnautil.h:23-27), first base of
each byte in the *high* two bits (twoBit.c:786 decode `(partial >> (6-2*i)) & 3`).
N blocks and soft-mask blocks are separate interval lists per sequence.

The decoded representation here is a code array (uint8):
  0=T 1=C 2=A 3=G 4=N
plus a mask array of (start, end) soft-mask intervals.  Character sequences
(for tests and fasta export) are derived from these: 'tcag' base, 'n' for N
blocks; when masking is applied, non-masked bases are uppercase and masked
ones lowercase (twoBitReadSeqFragExt semantics with doMask=True).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

SIGNATURE = 0x1A412743
CODE_TO_CHAR = np.frombuffer(b"tcag", dtype=np.uint8)
CODE_TO_CHAR_UPPER = np.frombuffer(b"TCAG", dtype=np.uint8)

# char -> code lookup for packing (case-insensitive; non-acgt treated as T
# for packing purposes, like faToTwoBit packs N as T with an N-block entry)
_CHAR_TO_CODE = np.zeros(256, dtype=np.uint8)
for i, ch in enumerate(b"tcag"):
    _CHAR_TO_CODE[ch] = i
    _CHAR_TO_CODE[ch - 32] = i  # uppercase


# 256-entry byte -> 4-code decode table (top bits first, twoBit.c:786)
_DECODE_LUT = np.empty((256, 4), np.uint8)
for _b in range(256):
    for _i in range(4):
        _DECODE_LUT[_b, _i] = (_b >> (6 - 2 * _i)) & 3


@dataclass
class TwoBitSeq:
    name: str
    size: int
    packed: np.ndarray  # uint8[(size+3)//4]
    n_blocks: np.ndarray  # int64[k,2] (start,end)
    mask_blocks: np.ndarray  # int64[m,2] (start,end)

    def codes(self, start: int = 0, end: int | None = None) -> np.ndarray:
        """Decode to uint8 codes 0..4 (4 = N) over [start, end)."""
        if end is None:
            end = self.size
        from ..native import get_lib
        from ..utils.bigmem import big_empty
        lib = get_lib()
        if lib is not None:
            import ctypes
            import os
            out = big_empty(end - start, np.uint8)
            nb = np.ascontiguousarray(self.n_blocks, np.int64)
            packed = np.ascontiguousarray(self.packed)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            ns = nb[:, 0] if nb.size else np.zeros(0, np.int64)
            ne = np.ascontiguousarray(nb[:, 1]) if nb.size \
                else np.zeros(0, np.int64)
            ns = np.ascontiguousarray(ns)
            lib.gat_twobit_decode(
                packed.ctypes.data_as(u8p), start, end,
                ns.ctypes.data_as(i64p), ne.ctypes.data_as(i64p),
                nb.shape[0], out.ctypes.data_as(u8p),
                min(os.cpu_count() or 1, 8))
            return out
        # decode whole bytes spanning the range, then trim
        byte_lo = start // 4
        byte_hi = (end + 3) // 4
        chunk = self.packed[byte_lo:byte_hi]
        # expand via a 256 -> 4-byte LUT (one gather, contiguous writes)
        out4 = _DECODE_LUT[chunk].reshape(-1)
        out = out4[start - byte_lo * 4: end - byte_lo * 4].copy()
        # overlay N blocks
        for s, e in self.n_blocks:
            s2, e2 = max(int(s), start), min(int(e), end)
            if s2 < e2:
                out[s2 - start:e2 - start] = 4
        return out

    def mask_bits(self, start: int = 0, end: int | None = None) -> np.ndarray:
        """Boolean array: True where soft-masked."""
        if end is None:
            end = self.size
        out = np.zeros(end - start, dtype=bool)
        for s, e in self.mask_blocks:
            s2, e2 = max(int(s), start), min(int(e), end)
            if s2 < e2:
                out[s2 - start:e2 - start] = True
        return out

    def chars(self, start: int = 0, end: int | None = None,
              do_mask: bool = True) -> bytes:
        """Decoded character sequence.

        do_mask=True: uppercase with soft-masked regions lowercase and N
        blocks as 'n' (this matches how the reference tools load sequence:
        twoBitReadSeqFrag + doMask overlay, twoBit.c:835-870).
        do_mask=False: all lowercase with 'n' for N blocks.
        """
        if end is None:
            end = self.size
        codes = self.codes(start, end)
        if do_mask:
            chars = CODE_TO_CHAR_UPPER[np.minimum(codes, 3)]
            chars[codes == 4] = ord("N")
            m = self.mask_bits(start, end)
            chars[m] = chars[m] + 32  # lowercase
        else:
            chars = CODE_TO_CHAR[np.minimum(codes, 3)]
            chars[codes == 4] = ord("n")
        return chars.tobytes()


# Raw 2bit bytes cached process-wide keyed by (realpath, mtime, size):
# warm pipelines re-open the same genome files every run, and re-reading a
# few hundred MB per run costs ~0.1 s even from page cache.  Mirrors the
# decoded-chrom cache in device/genome.py (_SEQ_CACHE); bounded to 8 files.
_RAW_CACHE: dict = {}


def _raw_bytes(path: str) -> bytes:
    import os
    try:
        st = os.stat(path)
        key = (os.path.realpath(path), st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None:
        hit = _RAW_CACHE.get(key)
        if hit is not None:
            return hit
    with open(path, "rb") as f:
        data = f.read()
    if key is not None:
        while len(_RAW_CACHE) >= 8:
            _RAW_CACHE.pop(next(iter(_RAW_CACHE)))
        _RAW_CACHE[key] = data
    return data


class TwoBitFile:
    """Random-access reader for a .2bit file (loads index; seq data lazily)."""

    def __init__(self, path: str):
        self.path = path
        self._data = _raw_bytes(path)
        sig, version, seq_count, _reserved = struct.unpack_from("<IIII", self._data, 0)
        if sig != SIGNATURE:
            # try big endian
            sig_be = struct.unpack_from(">I", self._data, 0)[0]
            if sig_be == SIGNATURE:
                raise NotImplementedError("big-endian 2bit files not supported")
            raise ValueError(f"{path} is not a 2bit file")
        if version not in (0, 1):
            raise ValueError(f"unsupported 2bit version {version}")
        self.long_offsets = version == 1
        off = 16
        self.index: dict[str, int] = {}
        self._order: list[str] = []
        for _ in range(seq_count):
            name_size = self._data[off]
            off += 1
            name = self._data[off:off + name_size].decode()
            off += name_size
            if self.long_offsets:
                (seq_off,) = struct.unpack_from("<Q", self._data, off)
                off += 8
            else:
                (seq_off,) = struct.unpack_from("<I", self._data, off)
                off += 4
            self.index[name] = seq_off
            self._order.append(name)
        self._cache: dict[str, TwoBitSeq] = {}

    def seq_names(self) -> list[str]:
        return list(self._order)

    def seq_size(self, name: str) -> int:
        return self.read_seq(name).size

    def read_seq(self, name: str) -> TwoBitSeq:
        if name in self._cache:
            return self._cache[name]
        if name not in self.index:
            raise KeyError(f"{name} not in {self.path}")
        off = self.index[name]
        d = self._data
        (dna_size,) = struct.unpack_from("<I", d, off)
        off += 4
        (n_count,) = struct.unpack_from("<I", d, off)
        off += 4
        n_starts = np.frombuffer(d, dtype="<u4", count=n_count, offset=off).astype(np.int64)
        off += 4 * n_count
        n_sizes = np.frombuffer(d, dtype="<u4", count=n_count, offset=off).astype(np.int64)
        off += 4 * n_count
        (m_count,) = struct.unpack_from("<I", d, off)
        off += 4
        m_starts = np.frombuffer(d, dtype="<u4", count=m_count, offset=off).astype(np.int64)
        off += 4 * m_count
        m_sizes = np.frombuffer(d, dtype="<u4", count=m_count, offset=off).astype(np.int64)
        off += 4 * m_count
        (_reserved,) = struct.unpack_from("<I", d, off)
        off += 4
        packed_size = (dna_size + 3) // 4
        # a read-only view into the file buffer: decode only reads it, and
        # skipping the copy halves large-chromosome load time
        packed = np.frombuffer(d, dtype=np.uint8, count=packed_size, offset=off)
        seq = TwoBitSeq(
            name=name, size=dna_size, packed=packed,
            n_blocks=np.stack([n_starts, n_starts + n_sizes], axis=1)
            if n_count else np.zeros((0, 2), np.int64),
            mask_blocks=np.stack([m_starts, m_starts + m_sizes], axis=1)
            if m_count else np.zeros((0, 2), np.int64),
        )
        self._cache[name] = seq
        return seq


def is_twobit_file(path: str) -> bool:
    """twoBitIsFile: check the signature."""
    try:
        with open(path, "rb") as f:
            head = f.read(4)
        return len(head) == 4 and struct.unpack("<I", head)[0] == SIGNATURE
    except (OSError, IsADirectoryError):
        return False


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _runs_of(mask: np.ndarray) -> np.ndarray:
    """(start,end) runs of True in a boolean array."""
    if mask.size == 0:
        return np.zeros((0, 2), np.int64)
    diff = np.diff(mask.astype(np.int8))
    starts = np.flatnonzero(diff == 1) + 1
    ends = np.flatnonzero(diff == -1) + 1
    if mask[0]:
        starts = np.concatenate([[0], starts])
    if mask[-1]:
        ends = np.concatenate([ends, [mask.size]])
    return np.stack([starts, ends], axis=1).astype(np.int64)


def pack_sequence(seq_chars: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a character sequence into (packed, n_blocks, mask_blocks)."""
    arr = np.frombuffer(seq_chars, dtype=np.uint8)
    lower = (arr >= ord("a")) & (arr <= ord("z"))
    upper_arr = np.where(lower, arr - 32, arr)
    is_n = ~np.isin(upper_arr, np.frombuffer(b"ACGT", dtype=np.uint8))
    codes = _CHAR_TO_CODE[arr]
    n = arr.size
    padded = np.zeros(((n + 3) // 4) * 4, dtype=np.uint8)
    padded[:n] = codes
    packed = (
        (padded[0::4] << 6) | (padded[1::4] << 4) | (padded[2::4] << 2) | padded[3::4]
    ).astype(np.uint8)
    return packed, _runs_of(is_n), _runs_of(lower)


def write_twobit(path: str, seqs: list[tuple[str, bytes]]) -> None:
    """Write a .2bit file from (name, sequence chars) pairs.

    Sequence characters: acgtACGT plus n/N; lowercase regions become
    soft-mask blocks, non-ACGT become N blocks.
    """
    records = []
    for name, chars in seqs:
        packed, n_blocks, mask_blocks = pack_sequence(chars)
        records.append((name, len(chars), packed, n_blocks, mask_blocks))

    # layout: header, index, then records
    index_size = sum(1 + len(name.encode()) + 4 for name, *_ in records)
    off = 16 + index_size
    offsets = []
    for name, size, packed, nb, mb in records:
        offsets.append(off)
        off += 4 + 4 + 8 * len(nb) + 4 + 8 * len(mb) + 4 + len(packed)

    with open(path, "wb") as f:
        f.write(struct.pack("<IIII", SIGNATURE, 0, len(records), 0))
        for (name, *_), seq_off in zip(records, offsets):
            nm = name.encode()
            f.write(struct.pack("<B", len(nm)))
            f.write(nm)
            f.write(struct.pack("<I", seq_off))
        for name, size, packed, nb, mb in records:
            f.write(struct.pack("<I", size))
            f.write(struct.pack("<I", len(nb)))
            if len(nb):
                f.write(nb[:, 0].astype("<u4").tobytes())
                f.write((nb[:, 1] - nb[:, 0]).astype("<u4").tobytes())
            f.write(struct.pack("<I", len(mb)))
            if len(mb):
                f.write(mb[:, 0].astype("<u4").tobytes())
                f.write((mb[:, 1] - mb[:, 0]).astype("<u4").tobytes())
            f.write(struct.pack("<I", 0))
            f.write(packed.tobytes())
