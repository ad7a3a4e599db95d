"""Genome sequences as code arrays (host numpy; mirrored to device HBM).

Code mapping follows the 2bit packing (T=0 C=1 A=2 G=3, N=4).  Reverse
complement in code space is `code ^ 2` for codes < 4 (T<->A, C<->G) and N
stays N - so '-'-strand query sequences are derived on the fly without a
character round-trip (reference loads revcomp'd char sequences on demand,
e.g. scoreChain.c getSeqFromHash).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..formats.twobit import TwoBitFile, TwoBitSeq
from ..utils.profiling import phase


_RC_CODE = np.array([2, 3, 0, 1, 4], dtype=np.uint8)  # T<->A, C<->G, N=N


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement a code array (0..4); native threaded pass when
    available, single LUT gather otherwise."""
    from ..native import get_lib
    from ..utils.bigmem import big_empty
    lib = get_lib()
    if lib is not None and hasattr(lib, "gat_revcomp_codes"):
        import ctypes
        import os
        src = np.ascontiguousarray(codes)
        out = big_empty(src.shape[0], src.dtype)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.gat_revcomp_codes(src.ctypes.data_as(u8p), src.shape[0],
                              out.ctypes.data_as(u8p),
                              min(os.cpu_count() or 1, 8))
        return out
    return _RC_CODE[codes[::-1]]


@dataclass
class GenomeSeq:
    name: str
    size: int
    codes: np.ndarray  # uint8 codes 0..4, full chromosome
    mask: np.ndarray | None = None  # bool soft-mask, only loaded when needed
    _rc: np.ndarray | None = field(default=None, repr=False)

    def rc_codes(self) -> np.ndarray:
        if self._rc is None:
            self._rc = revcomp_codes(self.codes)
        return self._rc


# Decoded chroms cached process-wide, keyed by (realpath, mtime_ns, size,
# with_mask): tools that re-open the same genome files (warm benchmark
# runs, multi-stage pipelines, server loops) skip the 2bit decode + '-'
# strand revcomp entirely.  Entries are per-file dicts shared by every
# Genome instance over that file; a stale file (new mtime) gets a fresh
# dict.  Bounded: oldest file entries are dropped past 8 files.
_SEQ_CACHE: dict[tuple, dict[str, "GenomeSeq"]] = {}


def _file_seq_cache(path: str, with_mask: bool) -> dict[str, "GenomeSeq"]:
    import os
    try:
        st = os.stat(path)
        key = (os.path.realpath(path), st.st_mtime_ns, st.st_size, with_mask)
    except OSError:
        return {}
    if key not in _SEQ_CACHE:
        while len(_SEQ_CACHE) >= 8:
            _SEQ_CACHE.pop(next(iter(_SEQ_CACHE)))
        _SEQ_CACHE[key] = {}
    return _SEQ_CACHE[key]


class Genome:
    """Lazily-loaded genome backed by a 2bit file; caches decoded chroms
    (shared process-wide per file, see _SEQ_CACHE)."""

    def __init__(self, twobit_path: str, with_mask: bool = False):
        self.tbf = TwoBitFile(twobit_path)
        self.with_mask = with_mask
        self._seqs: dict[str, GenomeSeq] = _file_seq_cache(
            twobit_path, with_mask)

    def names(self) -> list[str]:
        return self.tbf.seq_names()

    def seq(self, name: str) -> GenomeSeq:
        if name not in self._seqs:
            with phase("genome: decode"):
                raw: TwoBitSeq = self.tbf.read_seq(name)
                self._seqs[name] = GenomeSeq(
                    name=name,
                    size=raw.size,
                    codes=raw.codes(),
                    mask=raw.mask_bits() if self.with_mask else None,
                )
        return self._seqs[name]

    def codes(self, name: str, strand: str = "+") -> np.ndarray:
        s = self.seq(name)
        return s.codes if strand == "+" else s.rc_codes()


# ------------------------------------------------------------------
# Alternate genome sources: fasta files, nib directories, single nibs.
# The reference tools accept all of these interchangeably (axtChain
# seq loading, axtChain.c:119-171 + 379-470: twoBitIsFile else nib dir,
# -faQ/-faT fasta hashes; chainCleaner.c:440-457 nibLoadAllMasked
# NIB_MASK_MIXED).  All expose the Genome API (seq/codes/names).

_CHAR_CODE = np.full(256, 4, dtype=np.uint8)  # T=0 C=1 A=2 G=3, rest N
for _i, _c in enumerate(b"TCAG"):
    _CHAR_CODE[_c] = _i
    _CHAR_CODE[_c + 32] = _i


class CharGenome:
    """Genome backed by mixed-case character sequences (fasta / nib);
    lowercase = soft-masked (NIB_MASK_MIXED / faReadAllMixed semantics)."""

    def __init__(self, with_mask: bool = False):
        self.with_mask = with_mask
        self._seqs: dict[str, GenomeSeq] = {}

    def _load_chars(self, name: str) -> bytes:
        raise NotImplementedError

    def names(self) -> list[str]:
        raise NotImplementedError

    def seq(self, name: str) -> GenomeSeq:
        if name not in self._seqs:
            chars = np.frombuffer(self._load_chars(name), np.uint8)
            mask = None
            if self.with_mask:
                mask = (chars >= ord("a")) & (chars <= ord("z"))
            self._seqs[name] = GenomeSeq(
                name=name, size=chars.shape[0],
                codes=_CHAR_CODE[chars], mask=mask)
        return self._seqs[name]

    def codes(self, name: str, strand: str = "+") -> np.ndarray:
        s = self.seq(name)
        return s.codes if strand == "+" else s.rc_codes()


class FastaGenome(CharGenome):
    """All sequences of a fasta file, case preserved (faReadMixedNext)."""

    def __init__(self, path: str, with_mask: bool = False):
        super().__init__(with_mask)
        self.path = path
        self._chars: dict[str, bytes] = {}
        name, chunks = None, []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    if name is not None:
                        self._chars[name] = "".join(chunks).encode()
                    name = line[1:].split()[0] if len(line) > 1 else ""
                    chunks = []
                elif name is not None:
                    chunks.append(line)
        if name is not None:
            self._chars[name] = "".join(chunks).encode()

    def _load_chars(self, name: str) -> bytes:
        if name not in self._chars:
            raise KeyError(
                f"ERROR: can not find sequence name '{name}' "
                f"from fasta file '{self.path}'")
        return self._chars[name]

    def names(self) -> list[str]:
        return list(self._chars)


class NibDirGenome(CharGenome):
    """Directory of one-per-sequence .nib files; lazy per-chrom load
    ({dir}/{name}.nib, nibLoadAllMasked NIB_MASK_MIXED)."""

    def __init__(self, nib_dir: str, with_mask: bool = False):
        super().__init__(with_mask)
        self.nib_dir = nib_dir

    def _load_chars(self, name: str) -> bytes:
        import os
        from ..formats.nib import read_nib
        return read_nib(os.path.join(self.nib_dir, name + ".nib"))

    def names(self) -> list[str]:
        import os
        return sorted(f[:-4] for f in os.listdir(self.nib_dir)
                      if f.endswith(".nib"))


class NibFileGenome(CharGenome):
    """A single .nib file holding one sequence named by the file stem."""

    def __init__(self, path: str, with_mask: bool = False):
        super().__init__(with_mask)
        self.path = path
        import os
        self._name = os.path.splitext(os.path.basename(path))[0]

    def _load_chars(self, name: str) -> bytes:
        from ..formats.nib import read_nib
        if name != self._name:
            raise KeyError(f"{self.path} holds '{self._name}', not '{name}'")
        return read_nib(self.path)

    def names(self) -> list[str]:
        return [self._name]


def open_genome(path: str, fasta: bool = False, with_mask: bool = False):
    """Open a genome source by kind: fasta (explicit flag, like -faQ/-faT),
    a directory of .nib files, a single .nib file, or a 2bit file."""
    import os
    if fasta:
        return FastaGenome(path, with_mask=with_mask)
    if os.path.isdir(path):
        return NibDirGenome(path, with_mask=with_mask)
    if path.endswith(".nib"):
        return NibFileGenome(path, with_mask=with_mask)
    return Genome(path, with_mask=with_mask)
