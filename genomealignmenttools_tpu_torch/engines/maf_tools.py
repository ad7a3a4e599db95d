"""MAF tool-suite: axtToMaf, mafToAxt, mafToPsl, mafToFa, mafRanges,
mafNoAlign.

Behavioral references: kent/src/hg/mouseStuff/{axtToMaf,mafToAxt,mafToPsl,
mafToFa,mafRanges,mafNoAlign}.c.  Byte-compatible with the C tools.
"""

from __future__ import annotations

from ..formats.axt import iter_axts, Axt, read_axts, write_axts
from ..formats.chromsizes import read_chrom_sizes
from ..formats.maf import MafAli, MafComp, format_maf, read_mafs
from .converters import psl_from_align


def _axt_score_default(axt: Axt) -> int:
    from ..formats.scorematrix import score_scheme_default
    from .chain_tools import _axt_score_sym
    ss = score_scheme_default()
    return _axt_score_sym(axt.q_sym, axt.t_sym, ss.char_matrix(),
                          ss.gap_open, ss.gap_extend)


def axt_to_maf(in_axt: str, t_sizes_file: str, q_sizes_file: str, out,
               q_prefix: str = "", t_prefix: str = "",
               rescore: bool = False, score_zero: bool = False,
               t_split: bool = False) -> None:
    """axtToMaf.

    t_split (axtToMaf.c:85-88, 124-139): `out` is a directory; one
    ``<tName>.maf`` per target sequence, input must arrive grouped by
    target (a revisited tName aborts), and no meta passthrough is
    registered in this mode (axtToMaf.c:92 is the non-split branch)."""
    import os
    t_sizes = read_chrom_sizes(t_sizes_file)
    q_sizes = read_chrom_sizes(q_sizes_file)

    def make_ali(axt):
        score = axt.score
        if (score == 0 and score_zero) or rescore:
            score = _axt_score_default(axt)
        ali = MafAli(score=float(score))
        # components: target first, then query (axtToMaf slAddHead order)
        ali.components.append(MafComp(
            src=t_prefix + axt.t_name, src_size=t_sizes[axt.t_name],
            strand="+", start=axt.t_start,
            size=axt.t_end - axt.t_start, text=axt.t_sym))
        ali.components.append(MafComp(
            src=q_prefix + axt.q_name, src_size=q_sizes[axt.q_name],
            strand=axt.q_strand, start=axt.q_start,
            size=axt.q_end - axt.q_start, text=axt.q_sym))
        return ali

    if t_split:
        os.makedirs(out, exist_ok=True)
        f = None
        cur_t = None
        seen: set[str] = set()
        try:
            for axt in iter_axts(in_axt):
                if axt.t_name != cur_t:
                    cur_t = axt.t_name
                    if cur_t in seen:
                        raise ValueError(
                            f"{in_axt} isn't sorted, which is necessary "
                            f"when -tSplit option is used")
                    seen.add(cur_t)
                    if f is not None:
                        f.close()
                    f = open(os.path.join(out, f"{cur_t}.maf"), "w")
                    f.write("##maf version=1 scoring=blastz\n")
                f.write(format_maf(make_ali(axt)))
        finally:
            if f is not None:
                f.close()
        return

    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        f.write("##maf version=1 scoring=blastz\n")
        # input '#' lines echo to the maf at encounter - i.e. after the
        # maf header line (axtToMaf.c:92-93 registers meta before
        # mafWriteStart, but meta is only crossed during axtRead)
        for axt in iter_axts(in_axt, meta_out=lambda l: f.write(l + "\n")):
            f.write(format_maf(make_ali(axt)))
    finally:
        if close:
            f.close()


def _strip_db(name: str, strip: bool) -> str:
    if strip:
        dot = name.find(".")
        if dot < 0:
            raise ValueError(f"No db. found in {name}")
        return name[dot + 1:]
    return name


def maf_to_axt(in_maf: str, t_name: str, q_name: str, out,
               strip_db: bool = False) -> None:
    """mafToAxt; t_name 'first' uses the first component as target."""
    t_is_first = t_name == "first"
    axts = []
    for ali in read_mafs(in_maf):
        for i, comp in enumerate(ali.components):
            if (t_is_first and i == 0) or (not t_is_first
                                           and comp.src.startswith(t_name)):
                if comp.text is None:
                    continue
                for qc in ali.components:
                    # (the C checks every component including the target)
                    if qc.text is None or not qc.src.startswith(q_name):
                        continue
                    if len(comp.text) != len(qc.text):
                        raise ValueError("component lengths differ")
                    axts.append(Axt(
                        q_name=_strip_db(qc.src, strip_db),
                        q_start=qc.start, q_end=qc.start + qc.size,
                        q_strand=qc.strand,
                        t_name=_strip_db(comp.src, strip_db),
                        t_start=comp.start, t_end=comp.start + comp.size,
                        score=int(ali.score), q_sym=qc.text,
                        t_sym=comp.text))
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        write_axts(axts, f)
    finally:
        if close:
            f.close()


def _find_component(ali: MafAli, src: str) -> MafComp | None:
    """mafMayFindComponentDb: by organism prefix or full src name."""
    for c in ali.components:
        if c.src == src:
            return c
        dot = c.src.find(".")
        if dot >= 0 and c.src[:dot] == src:
            return c
    return None


def _skip_dot(src: str) -> str:
    dot = src.find(".")
    return src if dot < 0 else src[dot + 1:]


def maf_to_psl(query_src: str, target_src: str, in_maf: str, out) -> None:
    """mafToPsl."""
    from ..formats.psl import write_psls
    psls = []
    for ali in read_mafs(in_maf):
        qc = _find_component(ali, query_src)
        tc = _find_component(ali, target_src)
        if qc is None or tc is None:
            continue
        q_start, q_end = qc.start, qc.start + qc.size
        t_start, t_end = tc.start, tc.start + tc.size
        if qc.strand == "-":
            q_start, q_end = qc.src_size - q_end, qc.src_size - q_start
        if tc.strand == "-":
            t_start, t_end = tc.src_size - t_end, tc.src_size - t_start
        psl = psl_from_align(_skip_dot(qc.src), qc.src_size, q_start, q_end,
                             qc.text, _skip_dot(tc.src), tc.src_size,
                             t_start, t_end, tc.text,
                             qc.strand + tc.strand, softmask=False)
        if psl is not None:
            if len(psl.strand) > 1 and psl.strand[1] == "-":
                psl = _psl_rc(psl)
            psl.strand = psl.strand[0]
            psls.append(psl)
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        write_psls(psls, f)
    finally:
        if close:
            f.close()


def _psl_rc(psl):
    """pslRc: reverse-complement a psl in place (flip both strands)."""
    import numpy as np
    sizes = psl.block_sizes
    psl.q_starts = (psl.q_size - (psl.q_starts + sizes))[::-1].copy()
    psl.t_starts = (psl.t_size - (psl.t_starts + sizes))[::-1].copy()
    psl.block_sizes = sizes[::-1].copy()
    flip = {"+": "-", "-": "+"}
    psl.strand = flip[psl.strand[0]] + (flip[psl.strand[1]]
                                        if len(psl.strand) > 1 else "")
    return psl


def maf_to_fa(in_maf: str, out, strip_dots_dashes: bool = False) -> None:
    """mafToFa."""
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for ali in read_mafs(in_maf):
            for c in ali.components:
                text = c.text
                if strip_dots_dashes:
                    text = text.replace(".", "").replace("-", "")
                start, end = c.start, c.start + c.size
                start, end = c.src_size - end, c.src_size - start
                f.write(f">{c.src}.{start}.{end}.{c.strand}.{c.src_size}\n"
                        f"{text}\n")
            f.write("\n")
    finally:
        if close:
            f.close()


def maf_ranges(in_maf: str, db: str, out, other_db: str | None = None,
               not_all_o_gap: bool = False) -> None:
    """mafRanges."""
    dbs = {db}
    if other_db:
        dbs.update(other_db.split(","))
    db_dot = db + "."
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        for ali in read_mafs(in_maf):
            present = {c.src.split(".")[0] for c in ali.components}
            if not dbs <= present:
                continue
            if not_all_o_gap:
                _maf_ranges_mind_gaps(ali, db_dot, f)
            else:
                for c in ali.components:
                    if c.src.startswith(db_dot):
                        start, end = c.start, c.start + c.size
                        if c.strand == "-":
                            start, end = (c.src_size - end, c.src_size - start)
                        f.write(f"{c.src[len(db_dot):]}\t{start}\t{end}\n")
                        break
    finally:
        if close:
            f.close()


def _maf_ranges_mind_gaps(ali: MafAli, db_dot: str, f) -> None:
    """mafRangesMindGaps: break ranges where all other dbs have gaps."""
    chrom = None
    t_start = t_pos = t_strand = None
    for c in ali.components:
        if c.src.startswith(db_dot):
            chrom = c.src[len(db_dot):]
            t_start = c.start
            t_end = c.start + c.size
            t_strand = c.strand
            if t_strand == "-":
                t_start, t_end = c.src_size - t_end, c.src_size - t_start
            t_pos = t_start
    n = ali.text_size
    for i in range(n):
        j = n - i - 1 if t_strand == "-" else i
        t_gap = False
        q_gap = True
        for c in ali.components:
            if c.src.startswith(db_dot):
                if c.text[j] == "-":
                    t_gap = True
            else:
                if c.text[j] != "-":
                    q_gap = False
        if not t_gap:
            if q_gap:
                if t_start < t_pos:
                    f.write(f"{chrom}\t{t_start}\t{t_pos}\n")
                t_start = t_pos + 1
            t_pos += 1
    if t_start < t_pos:
        f.write(f"{chrom}\t{t_start}\t{t_pos}\n")


def maf_no_align(in_maf: str, out) -> None:
    """mafNoAlign: BED of reference regions with no alignments."""
    close = isinstance(out, str)
    f = open(out, "w") if close else out
    try:
        prev_chrom = None
        prev_chrom_size = 0
        prev_end = 0
        for ali in read_mafs(in_maf):
            if not any(c.size for c in ali.components[1:]):
                continue
            ref = ali.components[0]
            dot = ref.src.find(".")
            if dot < 0:
                raise ValueError("maf reference not in species.chrom format")
            chrom = ref.src[dot + 1:]
            if prev_chrom is not None and chrom != prev_chrom:
                if prev_end != prev_chrom_size:
                    f.write(f"{prev_chrom}\t{prev_end}\t{prev_chrom_size}\n")
                prev_chrom = None
            if prev_chrom is None:
                prev_chrom = chrom
                prev_chrom_size = ref.src_size
                prev_end = 0
            if prev_end != ref.start:
                f.write(f"{prev_chrom}\t{prev_end}\t{ref.start}\n")
            prev_end = ref.start + ref.size
        if prev_chrom is not None and prev_end != prev_chrom_size:
            f.write(f"{prev_chrom}\t{prev_end}\t{prev_chrom_size}\n")
    finally:
        if close:
            f.close()
