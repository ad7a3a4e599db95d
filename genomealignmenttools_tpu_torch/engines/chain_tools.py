"""The stock kent chain tool-suite (one engine function per binary).

Behavioral references (kent/src/hg/mouseStuff/):
  chainPreNet.c     - drop chains that cannot contribute to a net
  chainStitchId.c   - re-join chain fragments sharing an id
  chainFilter.c     - rich predicate filter
  chainSplit.c      - split by target (or query) chrom
  chainMergeSort.c  - k-way merge of score-sorted files (renumbers ids)
  chainAntiRepeat.c - drop degenerate / repeat-driven chains
  chainSwap.c       - swap target and query
  chainToAxt.c (+ lib/chainToAxt.c) - chains -> axt records

Each function is byte-compatible with its C counterpart.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..device.genome import Genome
from ..formats.chain import (Chain, format_score, iter_chains, read_chains,
                             sort_chains_by_score, write_chains)
from ..formats.chromsizes import read_chrom_sizes
from ..formats.twobit import TwoBitFile

BIGNUM = 0x3FFFFFFF


def _meta_writer(f):
    """lineFileSetMetaDataOutput protocol: echo '#' input lines to an output
    file at the moment they are crossed (linefile.c:93-101, 66-84)."""
    return lambda line: f.write(line + "\n")


def _is_haplotype(name: str) -> bool:
    return "_hap" in name or "_alt" in name


# ---------------------------------------------------------------------------
# chainPreNet
# ---------------------------------------------------------------------------

class _BitChrom:
    __slots__ = ("bits",)

    def __init__(self, size: int):
        self.bits = np.zeros(size, dtype=bool)


def chain_pre_net(in_file: str, t_sizes_file: str, q_sizes_file: str, out,
                  pad: int = 1, incl_hap: bool = False, dots: int = 0) -> None:
    """chainPreNet: keep a chain iff any block covers an unused base on
    either side; then mark its blocks used (with pad).

    dots: progress dot to stdout every N chains read (chainPreNet.c:51-64,
    155: static dotMod starts at 0, so the first chain always dots)."""
    import sys as _sys
    t_chroms = {n: _BitChrom(s) for n, s in read_chrom_sizes(t_sizes_file).items()}
    q_chroms = {n: _BitChrom(s) for n, s in read_chrom_sizes(q_sizes_file).items()}
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    dot_mod = 0
    try:
        last_score = float("inf")
        meta = _meta_writer(f)
        for chain in iter_chains(in_file, meta_out=meta):
            if dots > 0:
                dot_mod -= 1
                if dot_mod <= 0:
                    dot_mod = dots
                    _sys.stdout.write(".")
                    _sys.stdout.flush()
            if chain.score > last_score:
                raise ValueError(f"{in_file} not sorted by score")
            last_score = chain.score
            qc = q_chroms[chain.q_name]
            tc = t_chroms[chain.t_name]
            if not incl_hap and _is_haplotype(chain.q_name):
                continue
            b = chain.blocks
            any_open = False
            for ts, te, qs, qe in b:
                if not qc.bits[qs:qe].all() or not tc.bits[ts:te].all():
                    any_open = True
                    break
            if any_open:
                for ts, te, qs, qe in b:
                    qc.bits[max(qs - pad, 0):qe + pad] = True
                    tc.bits[max(ts - pad, 0):te + pad] = True
                f.write(chain.to_text())
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# chainStitchId
# ---------------------------------------------------------------------------

def chain_stitch_id(in_file: str, out) -> None:
    """chainStitchId: merge fragments by id, sum scores, sort blocks."""
    by_id: dict[int, Chain] = {}
    for chain in iter_chains(in_file):
        have = by_id.get(chain.id)
        if have is None:
            by_id[chain.id] = chain
        else:
            if (have.t_name != chain.t_name or have.q_name != chain.q_name
                    or have.q_strand != chain.q_strand):
                raise ValueError(f"Inconsistent names/strand for chain id {chain.id}")
            have.t_start = min(have.t_start, chain.t_start)
            have.t_end = max(have.t_end, chain.t_end)
            have.q_start = min(have.q_start, chain.q_start)
            have.q_end = max(have.q_end, chain.q_end)
            have.blocks = np.concatenate([have.blocks, chain.blocks])
            have.score += chain.score
    chains = [by_id[i] for i in sorted(by_id)]
    for c in chains:
        order = np.argsort(c.blocks[:, 0], kind="stable")
        c.blocks = c.blocks[order]
    # chainStitchId walks ids DESCENDING with slAddHead (chainStitchId.c:
    # 93-100), so its list is ASCENDING by id before the stable score
    # sort - ties stay ascending (unlike chainSort's reverse-file order)
    chains = sorted(chains, key=lambda c: -c.score)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        write_chains(chains, f)
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# chainFilter
# ---------------------------------------------------------------------------

def chain_filter(in_files: list[str], out, *,
                 q=None, not_q=None, t=None, not_t=None,
                 id_=None, id_list=None, id_file=None, id_exclude_file=None,
                 min_score=-BIGNUM, max_score=1.0e20,
                 q_start_min=-BIGNUM, q_start_max=BIGNUM,
                 q_end_min=-BIGNUM, q_end_max=BIGNUM,
                 t_start_min=-BIGNUM, t_start_max=BIGNUM,
                 t_end_min=-BIGNUM, t_end_max=BIGNUM,
                 q_overlap_start=-BIGNUM, q_overlap_end=BIGNUM,
                 t_overlap_start=-BIGNUM, t_overlap_end=BIGNUM,
                 strand=None, do_long=False, zero_gap=False,
                 min_gapless=0, q_min_gap=0, t_min_gap=0,
                 q_max_gap=0, t_max_gap=0,
                 q_min_size=0, q_max_size=BIGNUM,
                 t_min_size=0, t_max_size=BIGNUM,
                 no_random=False, no_hap=False) -> None:
    """chainFilter (all predicates)."""
    q_set = set(q.split(",")) if q else None
    not_q_set = set(not_q.split(",")) if not_q else None
    t_set = set(t.split(",")) if t else None
    not_t_set = set(not_t.split(",")) if not_t else None
    id_list_set = set(id_list.split(",")) if id_list else None
    id_file_set = (set(ln.strip() for ln in open(id_file) if ln.strip())
                   if id_file else None)
    id_excl_set = (set(ln.strip() for ln in open(id_exclude_file)
                       if ln.strip()) if id_exclude_file else None)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for path in in_files:
            for chain in iter_chains(path):
                if zero_gap:
                    from .chain_connect import merge_abutting
                    rows = [list(r) for r in chain.blocks]
                    chain.blocks = np.array(merge_abutting(rows), np.int64)
                b = chain.blocks
                dt = b[1:, 0] - b[:-1, 1]
                dq = b[1:, 2] - b[:-1, 3]
                ok = True
                if q_set is not None and chain.q_name not in q_set:
                    ok = False
                if not_q_set is not None and chain.q_name in not_q_set:
                    ok = False
                if t_set is not None and chain.t_name not in t_set:
                    ok = False
                if not_t_set is not None and chain.t_name in not_t_set:
                    ok = False
                if chain.score < min_score or chain.score >= max_score:
                    ok = False
                if chain.q_start < q_start_min or chain.q_start >= q_start_max:
                    ok = False
                if chain.q_end < q_end_min or chain.q_end >= q_end_max:
                    ok = False
                if chain.t_start < t_start_min or chain.t_start >= t_start_max:
                    ok = False
                if chain.t_end < t_end_min or chain.t_end >= t_end_max:
                    ok = False
                if chain.q_end < q_overlap_start or chain.q_start >= q_overlap_end:
                    ok = False
                if chain.t_end < t_overlap_start or chain.t_start >= t_overlap_end:
                    ok = False
                if (chain.q_end - chain.q_start < q_min_size
                        or chain.t_end - chain.t_start < t_min_size):
                    ok = False
                if (chain.q_end - chain.q_start > q_max_size
                        or chain.t_end - chain.t_start > t_max_size):
                    ok = False
                if strand is not None and strand[0] != chain.q_strand:
                    ok = False
                if id_ is not None and id_ >= 0 and id_ != chain.id:
                    ok = False
                if id_list_set is not None and str(chain.id) not in id_list_set:
                    ok = False
                if id_file_set is not None and str(chain.id) not in id_file_set:
                    ok = False
                if id_excl_set is not None and str(chain.id) in id_excl_set:
                    ok = False
                if min_gapless and not int((b[:, 1] - b[:, 0]).max()) >= min_gapless:
                    ok = False
                if q_min_gap and not (int(dq.max()) if dq.size else 0) >= q_min_gap:
                    ok = False
                if t_min_gap and not (int(dt.max()) if dt.size else 0) >= t_min_gap:
                    ok = False
                if q_max_gap and (int(dq.max()) if dq.size else 0) > q_max_gap:
                    ok = False
                if t_max_gap and (int(dt.max()) if dt.size else 0) > t_max_gap:
                    ok = False
                if no_random and (chain.t_name.endswith("_random")
                                  or chain.q_name.endswith("_random")):
                    ok = False
                if no_hap and (_is_haplotype(chain.t_name)
                               or _is_haplotype(chain.q_name)):
                    ok = False
                if ok:
                    if do_long:
                        f.write(_chain_long_text(chain))
                    else:
                        f.write(chain.to_text())
    finally:
        if close:
            f.close()


def _chain_long_text(chain: Chain) -> str:
    """chainWriteLong."""
    out = [chain.header_line()]
    b = chain.blocks
    n = b.shape[0]
    for i in range(n):
        parts = [f"{b[i, 0]}\t{b[i, 2]}\t{b[i, 1] - b[i, 0]}"]
        if i + 1 < n:
            parts.append(f"\t{b[i + 1, 0] - b[i, 1]}\t{b[i + 1, 2] - b[i, 3]}")
        out.append("".join(parts))
    out.append("")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# chainSplit / chainMergeSort / chainSwap
# ---------------------------------------------------------------------------

def chain_split(out_dir: str, in_files: list[str], split_on_q: bool = False,
                lump: int = 0) -> None:
    """chainSplit: one output chain file per target (or query) chrom."""
    os.makedirs(out_dir, exist_ok=True)
    handles: dict[str, object] = {}
    meta_pool: list[str] = []
    first_file: list = []  # [FILE] once the first split file exists

    def on_meta(line):
        # Before any split file exists, meta collects in meta.tmp.  After
        # the first file is created the reference fcloses meta.tmp, and -
        # observed behavior of the C binary - the very next fopen (the
        # first split file) recycles the freed FILE slot, so later meta
        # lines are appended to the FIRST split file at encounter
        # (chainSplit.c:87-92).
        if first_file:
            first_file[0].write(line + "\n")
        else:
            meta_pool.append(line)

    try:
        for path in in_files:
            for chain in iter_chains(path, meta_out=on_meta):
                name = chain.q_name if split_on_q else chain.t_name
                if lump > 0:
                    # lumpName: first integer in the name (else kent
                    # hashString) mod lump
                    from ..utils.kenthash import kent_hash_string
                    digits = None
                    for j, ch in enumerate(name):
                        if ch.isdigit():
                            k = j
                            while k < len(name) and name[k].isdigit():
                                k += 1
                            digits = int(name[j:k])
                            break
                    ix = (digits if digits is not None
                          else kent_hash_string(name)) % lump
                    name = f"{ix:03d}"
                f = handles.get(name)
                if f is None:
                    f = open(os.path.join(out_dir, f"{name}.chain"), "w")
                    if not handles:
                        # meta.tmp is frozen when the first split file is
                        # created (chainSplit.c:87-89); the reference
                        # leaves it behind in the out dir - replicate
                        frozen_pool = sorted(set(meta_pool))
                        with open(os.path.join(out_dir, "meta.tmp"),
                                  "w") as mf:
                            for line in meta_pool:
                                mf.write(line + "\n")
                    # EVERY new split file starts with `cat meta.tmp |
                    # sort -u` of the frozen pool (chainSplit.c:90)
                    for line in frozen_pool:
                        f.write(line + "\n")
                    handles[name] = f
                    if not first_file:
                        first_file.append(f)
                f.write(chain.to_text())
    finally:
        for f in handles.values():
            f.close()


MERGE_MAX_FILES = 400  # chainMergeSort.c MAXFILES: open-handle budget


def chain_merge_sort(in_files: list[str], out, save_id: bool = False,
                     temp_dir: str = "./") -> None:
    """chainMergeSort: k-way merge by descending score; renumber ids
    unless save_id.

    More than MERGE_MAX_FILES inputs triggers the reference's hierarchical
    merge (chainMergeSort.c:130-197 hierSort): groups of 400 merge into
    temp files under temp_dir, repeated until one pass remains.
    Intermediate renumbering is unobservable (the final pass renumbers the
    already-merged stream), so intermediates keep their ids."""
    import heapq
    if len(in_files) > MERGE_MAX_FILES:
        import os
        import tempfile
        tmp_files = []
        orig_inputs = set(in_files)
        try:
            while len(in_files) > MERGE_MAX_FILES:
                nxt = []
                for g in range(0, len(in_files), MERGE_MAX_FILES):
                    group = in_files[g:g + MERGE_MAX_FILES]
                    fd, tmp = tempfile.mkstemp(suffix=".tmp", prefix="sort-",
                                               dir=temp_dir or "./")
                    os.close(fd)
                    tmp_files.append(tmp)
                    chain_merge_sort(group, tmp, save_id=True)
                    # the reference frees each temp at EOF of the pass
                    # that consumes it (chainMergeSort.c cfEof); deleting
                    # consumed level-N temps here keeps peak temp-dir
                    # usage at ~1x instead of ~2x the input size
                    for t in group:
                        if t not in orig_inputs and os.path.exists(t):
                            os.remove(t)
                    nxt.append(tmp)
                in_files = nxt
            chain_merge_sort(in_files, out, save_id=save_id)
        finally:
            for t in tmp_files:
                if os.path.exists(t):
                    os.remove(t)
        return
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    meta = _meta_writer(f)
    iters = [iter_chains(p, meta_out=meta) for p in in_files]
    heap = []
    for idx, it in enumerate(iters):
        chain = next(it, None)
        if chain is not None:
            heap.append((-chain.score, idx, chain))
    heapq.heapify(heap)
    next_id = 0
    try:
        while heap:
            _, idx, chain = heapq.heappop(heap)
            if not save_id:
                next_id += 1
                chain.id = next_id
            f.write(chain.to_text())
            nxt = next(iters[idx], None)
            if nxt is not None:
                heapq.heappush(heap, (-nxt.score, idx, nxt))
    finally:
        if close:
            f.close()


def chain_swap(in_file: str, out) -> None:
    """chainSwap tool: swap t/q of every chain."""
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for chain in iter_chains(in_file):
            f.write(chain.swapped().to_text())
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# chainAntiRepeat
# ---------------------------------------------------------------------------

def chain_anti_repeat(t_2bit: str, q_2bit: str, in_file: str, out,
                      min_score: int = 5000,
                      no_check_score: int = 200000) -> None:
    """chainAntiRepeat: degeneracy + repeat filters (chainAntiRepeat.c)."""
    t_genome = Genome(t_2bit, with_mask=True)
    q_genome = Genome(q_2bit, with_mask=True)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        meta = _meta_writer(f)
        for chain in iter_chains(in_file, meta_out=meta):
            ok = True
            if chain.score < no_check_score:
                ok = _anti_repeat_pass(chain, t_genome, q_genome, min_score)
            if ok:
                f.write(chain.to_text())
    finally:
        if close:
            f.close()


def _anti_repeat_pass(chain: Chain, t_genome: Genome, q_genome: Genome,
                      min_score: int) -> bool:
    t_seq = t_genome.seq(chain.t_name)
    q_seq = q_genome.seq(chain.q_name)
    t_codes = t_seq.codes
    t_mask = t_seq.mask
    if chain.q_strand == "-":
        q_codes = q_seq.rc_codes()
        q_mask = q_seq.mask[::-1]
    else:
        q_codes = q_seq.codes
        q_mask = q_seq.mask

    counts = np.zeros(5, np.int64)
    rep_count = 0
    total = 0
    for ts, te, qs, qe in chain.blocks:
        qc = q_codes[qs:qe].astype(np.int64)
        tc = t_codes[ts:te].astype(np.int64)
        eq = qc == tc
        # degeneracy counts use ntVal: -1 for N; matches of N==N counted
        # into counts[-1] which the C writes at countBuf[0]... the C's
        # counts[-1] slot aliases countBuf[0] (never read back as a
        # nucleotide, exactly like the reference's countBuf trick)
        valid = eq & (qc < 4)
        idx, cnt = np.unique(qc[valid], return_counts=True)
        counts[idx] += cnt
        # repeat filter counts bases whose loaded char is lowercase
        # (isLowerDna has a,c,g,t,n): with doMask loading, lowercase ==
        # soft-masked - an N outside a mask block renders as uppercase 'N'
        # and is NOT counted
        qm = q_mask[qs:qe]
        tm = t_mask[ts:te]
        rep_count += int((qm | tm).sum())
        total += te - ts

    # degeneracyFilter - note: C counts in ntVal order (t,c,a,g); the six
    # pair sums cover all pairs, so our code order (t=0,c=1,a=2,g=3) is
    # equivalent
    c = counts[:4]
    total_matches = int(c.sum())
    pairs = [c[0] + c[1], c[0] + c[2], c[0] + c[3],
             c[1] + c[2], c[1] + c[3], c[2] + c[3]]
    best2 = int(max(pairs))
    ok_best2 = 0.80
    if total_matches > 0:
        observed = best2 / total_matches
        over = observed - ok_best2
        if over > 0:
            adjust = 1.01 - over / (1.0 - ok_best2)
            if chain.score * adjust < min_score:
                return False
    # repeatFilter
    if total > 0:
        adjusted = chain.score * 2.0 * (total - rep_count) / total
        if adjusted < min_score:
            return False
    return True


# ---------------------------------------------------------------------------
# chainToAxt (lib + tool)
# ---------------------------------------------------------------------------

def chain_to_axt_records(chain: Chain, q_chars: bytes, q_offset: int,
                         t_chars: bytes, t_offset: int,
                         max_gap: int, max_chain: int = BIGNUM,
                         score_scheme=None):
    """lib/chainToAxt.c: split chain into axt records at double-sided gaps,
    gaps > max_gap, or length > max_chain."""
    from ..formats.axt import Axt
    from ..formats.scorematrix import score_scheme_default

    if score_scheme is None:
        score_scheme = score_scheme_default()
    char_matrix = score_scheme.char_matrix()

    def axt_from_rows(rows):
        t_sym = []
        q_sym = []
        prev = None
        for r in rows:
            if prev is not None:
                dq = r[2] - prev[3]
                dt = r[0] - prev[1]
                if dq == 0:
                    t_sym.append(t_chars[prev[1] - t_offset:r[0] - t_offset])
                    q_sym.append(b"-" * dt)
                else:
                    assert dt == 0
                    q_sym.append(q_chars[prev[3] - q_offset:r[2] - q_offset])
                    t_sym.append(b"-" * dq)
            t_sym.append(t_chars[r[0] - t_offset:r[1] - t_offset])
            q_sym.append(q_chars[r[2] - q_offset:r[3] - q_offset])
            prev = r
        t_txt = b"".join(t_sym).decode()
        q_txt = b"".join(q_sym).decode()
        score = _axt_score_sym(q_txt, t_txt, char_matrix,
                               score_scheme.gap_open, score_scheme.gap_extend)
        return Axt(q_name=chain.q_name, q_start=rows[0][2], q_end=prev[3],
                   q_strand=chain.q_strand, t_name=chain.t_name,
                   t_start=rows[0][0], t_end=prev[1], score=score,
                   q_sym=q_txt, t_sym=t_txt)

    out = []
    rows = [list(r) for r in chain.blocks]
    start = 0
    for i in range(1, len(rows)):
        a, b = rows[i - 1], rows[i]
        dq = b[2] - a[3]
        dt = b[0] - a[1]
        if ((dq > 0 and dt > 0) or dt > max_gap or dq > max_gap
                or (b[1] - rows[start][0]) > max_chain):
            out.append(axt_from_rows(rows[start:i]))
            start = i
    out.append(axt_from_rows(rows[start:]))
    return out


def _axt_score_sym(q_sym: str, t_sym: str, char_matrix, gap_open, gap_extend) -> int:
    """axtScoreSym (axt.c): matrix scores with blastz-style gap costs."""
    score = 0
    last_gap = False
    for qc, tc in zip(q_sym, t_sym):
        if qc == "-" or tc == "-":
            if last_gap:
                score -= gap_extend
            else:
                score -= gap_open + gap_extend
                last_gap = True
        else:
            score += int(char_matrix[ord(qc), ord(tc)])
            last_gap = False
    return score


class _CharGenome:
    """Mixed-case character sequences from a 2bit (twoBitReadSeqFrag)."""

    def __init__(self, path: str):
        self.tbf = TwoBitFile(path)
        self._cache: dict[tuple[str, str], bytes] = {}

    def chars(self, name: str, strand: str = "+") -> bytes:
        key = (name, strand)
        if key not in self._cache:
            plus = self._cache.get((name, "+"))
            if plus is None:
                plus = self.tbf.read_seq(name).chars(do_mask=True)
                self._cache[(name, "+")] = plus
            if strand == "-":
                comp = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")
                self._cache[key] = plus.translate(comp)[::-1]
        return self._cache[key]

    def size(self, name: str) -> int:
        return self.tbf.read_seq(name).size


def _axt_id_ratio(axt) -> float:
    """axtIdRatio (chainToAxt.c:70-89): match/aligned fraction over
    non-indel columns, case-blind; 0.0 when there are no matches."""
    match = ali = 0
    for q, t in zip(axt.q_sym.upper(), axt.t_sym.upper()):
        if q != "-" and t != "-":
            ali += 1
            if q == t:
                match += 1
    if match == 0:
        return 0.0
    return match / ali


def chain_to_axt(in_file: str, t_2bit: str, q_2bit: str, out,
                 max_gap: int = 100, min_score: float = 0.0,
                 min_id: float = 0.0, bed_out: bool = False) -> None:
    """chainToAxt tool (chainToAxt.c:146-159).

    min_score filters whole chains (chainToAxt.c:138); min_id is a percent
    filter per axt record via minIdRatio = minId/100 <= idRatio
    (chainToAxt.c:113-114, 152); bed_out emits
    ``tName tStart tEnd qName idPpt strand`` with idPpt = (int)(idRatio*1000)
    (chainToAxt.c:91-101).  The reference's -maxChain flag is parsed but
    dead — doAChain always passes BIGNUM (chainToAxt.c:108) — so we accept
    it at the CLI and ignore it the same way."""
    from ..formats.axt import write_axts
    t_genome = _CharGenome(t_2bit)
    q_genome = _CharGenome(q_2bit)
    min_id_ratio = min_id / 100.0
    axts = []
    bed_lines = []
    for chain in iter_chains(in_file):
        if chain.score < min_score:
            continue
        t_chars = t_genome.chars(chain.t_name, "+")
        q_chars = q_genome.chars(chain.q_name, chain.q_strand)
        for axt in chain_to_axt_records(chain, q_chars, 0, t_chars, 0,
                                        max_gap):
            id_ratio = _axt_id_ratio(axt)
            if min_id_ratio <= id_ratio:
                if bed_out:
                    bed_lines.append(
                        f"{axt.t_name}\t{axt.t_start}\t{axt.t_end}\t"
                        f"{axt.q_name}\t{int(id_ratio * 1000)}\t"
                        f"{axt.q_strand}\n")
                else:
                    axts.append(axt)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        if bed_out:
            f.writelines(bed_lines)
        else:
            write_axts(axts, f)
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------------------
# chainToPsl / chainToPslBasic / chainOverlap
# ---------------------------------------------------------------------------

def chain_to_psl_basic(in_file: str, out) -> None:
    """chainToPslBasic: psl geometry only (match = block sizes sum)."""
    from ..formats.psl import Psl, write_psls
    psls = []
    for c in iter_chains(in_file):
        q_start, q_end = c.q_start, c.q_end
        if c.q_strand == "-":
            q_start, q_end = c.q_size - q_end, c.q_size - q_start
        b = c.blocks
        sizes = b[:, 1] - b[:, 0]
        dt = b[1:, 0] - b[:-1, 1]
        dq = b[1:, 2] - b[:-1, 3]
        psls.append(Psl(
            matches=int(sizes.sum()), mis_matches=0, rep_matches=0, n_count=0,
            q_num_insert=int((dq > 0).sum()), q_base_insert=int(dq[dq > 0].sum()),
            t_num_insert=int((dt > 0).sum()), t_base_insert=int(dt[dt > 0].sum()),
            strand=c.q_strand, q_name=c.q_name, q_size=c.q_size,
            q_start=q_start, q_end=q_end, t_name=c.t_name, t_size=c.t_size,
            t_start=c.t_start, t_end=c.t_end, block_count=b.shape[0],
            block_sizes=sizes.copy(), q_starts=b[:, 2].copy(),
            t_starts=b[:, 0].copy()))
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        write_psls(psls, f)
    finally:
        if close:
            f.close()


def chain_to_psl(in_file: str, t_sizes_file: str, q_sizes_file: str,
                 t_seq_path: str, q_seq_path: str, out) -> None:
    """chainToPsl with match/misMatch/repMatch counting (aliStringToPsl).

    repMatch is decided by TARGET softmask case; N (either side) counts as
    nCount.  Sequence inputs are 2bit files (the C accepts fasta/nib lists
    too; 2bit covers the toolkit's pipelines)."""
    t_genome = Genome(t_seq_path, with_mask=True)
    q_genome = Genome(q_seq_path, with_mask=True)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for c in iter_chains(in_file):
            if c.q_start == c.q_end or c.t_start == c.t_end:
                continue
            t_seq = t_genome.seq(c.t_name)
            q_seq = q_genome.seq(c.q_name)
            t_codes = t_seq.codes
            t_mask = t_seq.mask
            if c.q_strand == "-":
                q_codes = q_seq.rc_codes()
            else:
                q_codes = q_seq.codes
            match = mis = rep = n_count = 0
            b = c.blocks
            for ts, te, qs, qe in b:
                qc = q_codes[qs:qe]
                tc = t_codes[ts:te]
                tm = t_mask[ts:te]
                is_n = (qc >= 4) | (tc >= 4)
                eq = (qc == tc) & ~is_n
                n_count += int(is_n.sum())
                rep += int((eq & tm).sum())
                match += int((eq & ~tm).sum())
                mis += int((~eq & ~is_n).sum())
            dt = b[1:, 0] - b[:-1, 1]
            dq = b[1:, 2] - b[:-1, 3]
            sizes = b[:, 1] - b[:, 0]
            q_start, q_end = c.q_start, c.q_end
            if c.q_strand == "-":
                q_start, q_end = c.q_size - q_end, c.q_size - q_start
            cols = [match, mis, rep, n_count,
                    int((dq != 0).sum()), int(dq[dq != 0].sum()),
                    int((dt != 0).sum()), int(dt[dt != 0].sum()),
                    c.q_strand, c.q_name, c.q_size, q_start, q_end,
                    c.t_name, c.t_size, c.t_start, c.t_end, b.shape[0]]
            f.write("\t".join(str(x) for x in cols) + "\t")
            f.write("".join(f"{s}," for s in sizes) + "\t")
            f.write("".join(f"{s}," for s in b[:, 2]) + "\t")
            f.write("".join(f"{s}," for s in b[:, 0]) + "\n")
    finally:
        if close:
            f.close()


def chain_overlap(in_file: str, out, on_query: bool = False) -> None:
    """chainOverlap: rescore chains by per-base coverage counts (x100)."""
    groups: dict[str, list[Chain]] = {}
    sizes: dict[str, int] = {}
    for c in read_chains(in_file):
        groups.setdefault(c.t_name, []).append(c)
        sizes.setdefault(c.t_name, c.q_size if on_query else c.t_size)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        # seqPair list is built with slAddHead -> reverse first-seen order;
        # per-group chains likewise reversed before the stable target sort
        for name in reversed(list(groups)):
            chains = groups[name]
            chains.reverse()
            chains.sort(key=lambda c: (c.t_name, c.t_start))
            cov = np.zeros(sizes[name], np.uint16)
            for c in chains:
                for ts, te, qs, qe in c.blocks:
                    s, e = (qs, qe) if on_query else (ts, te)
                    seg = cov[s:e]
                    seg[seg < 65535] += 1
            for c in chains:
                score = 0
                num_bases = 0
                for ts, te, qs, qe in c.blocks:
                    s, e = (qs, qe) if on_query else (ts, te)
                    score += int(cov[s:e].astype(np.int64).sum())
                    num_bases += e - s
                c.score = 100 * (score / float(num_bases))
                f.write(c.to_text())
    finally:
        if close:
            f.close()
