"""Alignment format converters (axt <-> psl and friends).

Behavioral references: kent/src/hg/mouseStuff/axtToPsl.c +
lib/psl.c pslFromAlign/accumCounts/trimAlignment, axtSort.c, axtSwap.c.
"""

from __future__ import annotations

from ..formats.axt import Axt, read_axts, write_axts
from ..formats.chromsizes import read_chrom_sizes
from ..formats.psl import Psl

_DEL_CHARS = set("-.=_")


def _is_del(c: str) -> bool:
    return c in _DEL_CHARS


def psl_from_align(q_name, q_size, q_start, q_end, q_string,
                   t_name, t_size, t_start, t_end, t_string,
                   strand, softmask: bool = True) -> Psl | None:
    """pslFromAlign (psl.c:1716-1806), PSL_IS_SOFTMASK semantics."""
    if len(q_string) != len(t_string):
        raise ValueError("query and target alignment strings differ in length")
    qs0, qe0, ts0, te0 = q_start, q_end, t_start, t_end
    i0, i1 = 0, len(q_string)
    # trim leading/trailing indels
    while i0 < i1 and (_is_del(q_string[i0]) or _is_del(t_string[i0])):
        if not _is_del(q_string[i0]):
            qs0 += 1
        elif not _is_del(t_string[i0]):
            ts0 += 1
        i0 += 1
    while i1 > i0 and (_is_del(q_string[i1 - 1]) or _is_del(t_string[i1 - 1])):
        if not _is_del(q_string[i1 - 1]):
            qe0 -= 1
        elif not _is_del(t_string[i1 - 1]):
            te0 -= 1
        i1 -= 1
    if qs0 == qe0 or ts0 == te0:
        return None

    qs, qe = qs0, qe0
    if strand[0] == "-":
        qs, qe = q_size - qe, q_size - qs
    ts, te = ts0, te0
    if len(strand) > 1 and strand[1] == "-":
        ts, te = t_size - te, t_size - ts

    match = mis_match = rep_match = n_count = 0
    q_num_insert = q_base_insert = t_num_insert = t_base_insert = 0
    block_sizes, q_starts, t_starts = [], [], []
    either_insert = False
    qe_cur, te_cur = qs, ts
    qs_cur, ts_cur = qs, ts
    prev_q = prev_t = "\0"
    for i in range(i0, i1):
        q = q_string[i]
        t = t_string[i]
        dq, dt = _is_del(q), _is_del(t)
        if dq and dt:
            continue
        if dq or dt:
            if not either_insert:
                block_sizes.append(qe_cur - qs_cur)
                q_starts.append(qs_cur)
                t_starts.append(ts_cur)
                either_insert = True
            if not dq:
                qe_cur += 1
            if not dt:
                te_cur += 1
        else:
            if either_insert:
                qs_cur, ts_cur = qe_cur, te_cur
                either_insert = False
            qe_cur += 1
            te_cur += 1
        # accumCounts
        if not dq and not dt:
            qu, tu = q.upper(), t.upper()
            if q == "N" or t == "N":
                n_count += 1
            elif qu == tu:
                if softmask and (qu != q or tu != t):
                    rep_match += 1
                else:
                    match += 1
            else:
                mis_match += 1
        elif dq and not dt:
            t_base_insert += 1
            if not _is_del(prev_q):
                t_num_insert += 1
        elif dt and not dq:
            q_base_insert += 1
            if not _is_del(prev_t):
                q_num_insert += 1
        prev_q, prev_t = q, t
    block_sizes.append(qe_cur - qs_cur)
    q_starts.append(qs_cur)
    t_starts.append(ts_cur)

    import numpy as np
    return Psl(
        matches=match, mis_matches=mis_match, rep_matches=rep_match,
        n_count=n_count, q_num_insert=q_num_insert,
        q_base_insert=q_base_insert, t_num_insert=t_num_insert,
        t_base_insert=t_base_insert, strand=strand,
        q_name=q_name, q_size=q_size, q_start=qs0, q_end=qe0,
        t_name=t_name, t_size=t_size, t_start=ts0, t_end=te0,
        block_count=len(block_sizes),
        block_sizes=np.array(block_sizes, np.int64),
        q_starts=np.array(q_starts, np.int64),
        t_starts=np.array(t_starts, np.int64))


def axt_to_psl_records(axts, t_sizes: dict, q_sizes: dict):
    """axtToPsl main loop."""
    out = []
    for axt in axts:
        q_size = q_sizes[axt.q_name]
        q_start, q_end = axt.q_start, axt.q_end
        if axt.q_strand == "-":
            q_start, q_end = q_size - q_end, q_size - q_start
        psl = psl_from_align(axt.q_name, q_size, q_start, q_end, axt.q_sym,
                             axt.t_name, t_sizes[axt.t_name],
                             axt.t_start, axt.t_end, axt.t_sym,
                             axt.q_strand)
        if psl is not None:
            out.append(psl)
    return out


def axt_to_psl(in_axt: str, t_sizes_file: str, q_sizes_file: str, out) -> None:
    from ..formats.psl import write_psls
    axts = read_axts(in_axt)
    psls = axt_to_psl_records(axts, read_chrom_sizes(t_sizes_file),
                              read_chrom_sizes(q_sizes_file))
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        write_psls(psls, f)
    finally:
        if close:
            f.close()


def axt_sort(in_axt: str, out, by_score: bool = False,
             by_query: bool = False) -> None:
    """axtSort: sort by target position, -query position, or -byScore
    desc (axtSort.c:38-43; -byScore wins when both are given)."""
    axts = read_axts(in_axt)
    # kent reads with slAddHead + stable slSort (axtSort.c:36-43): ties
    # emit in reverse file order
    axts.reverse()
    if by_score:
        axts.sort(key=lambda a: -a.score)
    elif by_query:
        axts.sort(key=lambda a: (a.q_name, a.q_start))
    else:
        axts.sort(key=lambda a: (a.t_name, a.t_start))
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        write_axts(axts, f)
    finally:
        if close:
            f.close()


def axt_swap(in_axt: str, t_sizes_file: str, q_sizes_file: str, out) -> None:
    """axtSwap: swap target and query (axtSwap.c / axt.c axtSwap)."""
    t_sizes = read_chrom_sizes(t_sizes_file)
    q_sizes = read_chrom_sizes(q_sizes_file)
    axts = read_axts(in_axt)
    swapped = []
    for a in axts:
        # axtSwap lib: swap sides; if strand '-', flip coordinates of the
        # (new) query (old target) into rc space
        new = Axt(q_name=a.t_name, q_start=a.t_start, q_end=a.t_end,
                  q_strand=a.q_strand, t_name=a.q_name, t_start=a.q_start,
                  t_end=a.q_end, score=a.score, q_sym=a.t_sym, t_sym=a.q_sym)
        if a.q_strand == "-":
            t_size = t_sizes[a.t_name]
            q_size = q_sizes[a.q_name]
            new.q_start, new.q_end = t_size - a.t_end, t_size - a.t_start
            new.t_start, new.t_end = q_size - a.q_end, q_size - a.q_start
            comp = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
            new.q_sym = new.q_sym.translate(comp)[::-1]
            new.t_sym = new.t_sym.translate(comp)[::-1]
        swapped.append(new)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        write_axts(swapped, f)
    finally:
        if close:
            f.close()


def _rounding_scale(a: int, p: int, q: int) -> int:
    """roundingScale (common.c:2943-2955): rounded a*p/q with the C's
    int/double split at 100000."""
    import math
    if a > 100000 or p > 100000:
        x = a * p / q
        return int(math.floor(x + 0.5)) if x >= 0 else -int(
            math.floor(-x + 0.5))
    return (a * p + q // 2) // q


def psl_mrna_cover(psl_file: str, fa_file: str, out,
                   min_size: int = 100,
                   list_zero: str | None = None) -> None:
    """pslMrnaCover (kent/src/hg/mouseStuff/pslMrnaCover/pslMrnaCover.c):
    histogram of per-mRNA best coverage percentage, with an optional
    zero-coverage accession list."""
    from ..formats.psl import read_psls

    order: list[str] = []
    sizes: dict[str, int] = {}
    name = None
    n = 0
    with open(fa_file) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None and n >= min_size and name not in sizes:
                    sizes[name] = n
                    order.append(name)
                name = line[1:].split()[0] if len(line) > 1 else ""
                n = 0
            else:
                n += len(line)
    if name is not None and n >= min_size and name not in sizes:
        sizes[name] = n
        order.append(name)

    max_ali = {nm: 0 for nm in order}
    for psl in read_psls(psl_file):
        if psl.q_size >= min_size:
            if psl.q_name not in sizes:
                raise ValueError(
                    f"{psl.q_name} is in {psl_file} but not {fa_file}")
            if sizes[psl.q_name] != psl.q_size:
                raise ValueError(
                    f"{psl.q_name} is {sizes[psl.q_name]} bytes in {fa_file} "
                    f"but {psl.q_size} in {psl_file}")
            q_ali = psl.matches + psl.rep_matches + psl.mis_matches
            if q_ali > max_ali[psl.q_name]:
                max_ali[psl.q_name] = q_ali

    if list_zero is not None:
        with open(list_zero, "w") as zf:
            for nm in order:
                if max_ali[nm] == 0:
                    zf.write(f"{nm}\t{sizes[nm]}\n")

    histogram = [0] * 101
    for nm in order:
        histogram[_rounding_scale(100, max_ali[nm], sizes[nm])] += 1

    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for i in range(101):
            f.write(f"{i:3d}% {histogram[i]:6d}\n")
    finally:
        if close:
            f.close()
