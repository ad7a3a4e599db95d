"""lav format (blastz/lastz pairwise alignment output) parsing helpers.

Behavioral reference: kent/src/hg/lib/lav.c (parseS:48, parseH:61, parseD:104,
removeFrayedEnds:130) and kent/src/lib/axt.c (axtScoreSchemeReadLf:692,
axtScoreSchemeDnaWrite:836).

A lav file is a sequence of stanzas:
  #:lav header, then  d { ... }  s { ... }  h { ... }  a { ... }  blocks.
The 'd' stanza may embed the aligner command line and score matrix, which
the kent converters echo into the output as ##aligner/##matrix/##gapPenalties
comment lines.
"""

from __future__ import annotations

from dataclasses import dataclass

from .scorematrix import ScoreScheme, _scheme_from_acgt


@dataclass
class LavBlock:
    """One ungapped 'l' line of an 'a' stanza (0-based half-open)."""

    t_start: int
    t_end: int
    q_start: int
    q_end: int
    percent_id: int
    score: int = 0


class LineCursor:
    """Sequential cursor over the lines of a lav file (lineFile analogue)."""

    def __init__(self, lines: list[str], name: str = "<lav>"):
        self.lines = lines
        self.i = 0
        self.name = name

    def next(self) -> str | None:
        if self.i >= len(self.lines):
            return None
        line = self.lines[self.i]
        self.i += 1
        return line

    def need_next(self) -> str:
        line = self.next()
        if line is None:
            raise ValueError(f"Unexpected end of file in {self.name}")
        return line

    def chop_next(self, max_words: int = 6):
        """lineFileChopNext: next non-blank, non-'#' line chopped into at
        most max_words words; None at EOF."""
        while True:
            line = self.next()
            if line is None:
                return None
            stripped = line.strip()
            if not stripped or stripped.startswith("#"):
                continue
            self._raw = line
            return line.split()[:max_words]


def seek_end_of_stanza(cur: LineCursor) -> None:
    while True:
        line = cur.need_next()
        if line.startswith("}"):
            return


def _just_chrom(s: str) -> str:
    """justChrom (lav.c:35-46): strip mongo nib-file paths 'dir/chr1.nib:...'"""
    e = s.find(".nib:")
    if e < 0:
        return s
    s = s[:e]
    slash = s.rfind("/")
    return s if slash < 0 else s[slash + 1:]


def parse_s(cur: LineCursor) -> tuple[int, int]:
    """parseS: two rows; word index 2 is the sequence size."""
    sizes = []
    for _ in range(2):
        words = cur.chop_next(3)
        if words is None:
            raise ValueError(f"Unexpected end of file in {cur.name}")
        if len(words) < 3:
            raise ValueError(f"Short line in s stanza of {cur.name}")
        sizes.append(int(words[2]))
    seek_end_of_stanza(cur)
    return sizes[0], sizes[1]


def parse_h(cur: LineCursor) -> tuple[str, str, bool]:
    """parseH: two quoted names; '(reverse' in the line tail marks RC.

    Replicates the C tokenization quirks exactly: the name is the first
    whitespace word, with a leading '"' (and optional '>') skipped and the
    name cut at the next '"' inside that word; when that closing quote was
    found and a line remainder exists, the remainder's first character is
    skipped before the '(reverse' check (lav.c:92-95).
    """
    t_name = q_name = None
    is_rc = False
    i = 0
    while True:
        line = cur.need_next()
        if line.startswith("#"):
            continue
        if line.startswith("}"):
            if i < 2:
                raise ValueError(f"Short H stanza in {cur.name}")
            break
        stripped = line.lstrip()
        sp = 0
        while sp < len(stripped) and not stripped[sp].isspace():
            sp += 1
        word = stripped[:sp]
        rest = stripped[sp + 1:] if sp < len(stripped) else None
        if not word:
            raise ValueError(f"Short line in h stanza of {cur.name}")
        word = word[1:]  # skip `"`
        if word.startswith(">"):
            word = word[1:]
        quote = word.find('"')
        if quote >= 0:
            word = word[:quote]
            if rest is not None:
                rest = rest[1:]
        if i == 0:
            t_name = _just_chrom(word)
        elif i == 1:
            q_name = _just_chrom(word)
        if rest is not None and "(reverse" in rest:
            is_rc = True
        i += 1
    return t_name, q_name, is_rc


def read_score_scheme_stream(cur: LineCursor) -> ScoreScheme:
    """axtScoreSchemeReadLf on a cursor: tag=value settings lines, then the
    A/C/G/T matrix, then the literal next line as the O=,E= line.  Consumes
    exactly through that line (the caller seeks the stanza end)."""
    extra_parts: list[str] = []
    matrix: list[list[int]] = []
    gap_open = gap_extend = None

    words = cur.chop_next(6)
    if words is None:
        raise ValueError(f"Scoring matrix in {cur.name} too short")
    while True:
        if "=" in words[0] or (len(words) > 1 and "=" in words[1]):
            joined = "".join(words)
            joined = joined.split("#")[0]
            parts = joined.split("=")
            if parts[0] not in ("O", "E"):
                extra_parts.append(f"{parts[0]}={parts[1]}")
            words = cur.chop_next(6)
            if words is None:
                raise ValueError(f"Scoring matrix in {cur.name} too short")
            continue
        if not (words[0][0] == "A" and words[1][0] == "C"
                and words[2][0] == "G" and words[3][0] == "T"):
            raise ValueError(
                f"{cur.name} doesn't seem to be a score matrix file")
        for _ in range(4):
            words = cur.chop_next(6)
            if words is None:
                raise ValueError(f"Scoring matrix in {cur.name} too short")
            start = 1 if len(words) == 5 else 0
            matrix.append([int(w) for w in words[start:start + 4]])
        # the C reads the literal next line (lineFileNext, no blank-skip)
        line = cur.next()
        if line is not None:
            extra_parts.append(line)
            toks = [t for t in
                    line.replace("=", " ").replace(",", " ").replace("\t", " ")
                    .split() if t]
            for k in range(len(toks) - 1):
                if toks[k] == "O":
                    gap_open = int(toks[k + 1])
                if toks[k] == "E":
                    gap_extend = int(toks[k + 1])
            if gap_open is None or gap_extend is None:
                raise ValueError(f"Expecting O = and E = in {cur.name}")
            if gap_open <= 0 or gap_extend <= 0:
                raise ValueError("Must have positive gap scores")
        else:
            gap_open, gap_extend = 400, 30
        break
    extra = ",".join(extra_parts)
    if extra.endswith(","):
        extra = extra[:-1]
    return _scheme_from_acgt(matrix, gap_open, gap_extend, extra=extra)


def format_score_scheme_dna(scheme: ScoreScheme, name: str) -> str:
    """axtScoreSchemeDnaWrite (axt.c:836-875): ##matrix/##gapPenalties/
    ##blastzParms comment lines."""
    m = scheme.matrix_acgt
    vals = ",".join(str(int(m[i, j])) for i in range(4) for j in range(4))
    out = [f"##matrix={name} 16 {vals}",
           f"##gapPenalties={name} O={scheme.gap_open} E={scheme.gap_extend}"]
    if scheme.extra:
        extra = scheme.extra.replace(" ", "").replace('"', "")
        out.append(f"##blastzParms={extra}")
    return "\n".join(out) + "\n"


def parse_d(cur: LineCursor, out) -> None:
    """parseD: echo a lastz command line + its score matrix as ## comments
    into the output stream, then skip to the stanza end."""
    line = cur.need_next()
    if "lastz" in line:
        line = line.replace('"', "")
        words = line.split()
        out.write(f"##aligner={words[0]}")
        for w in words[3:]:
            out.write(f" {w} ")
        out.write("\n")
        scheme = read_score_scheme_stream(cur)
        out.write(format_score_scheme_dna(scheme, words[0]))
    seek_end_of_stanza(cur)


def remove_frayed_ends(blocks: list[LavBlock]) -> list[LavBlock]:
    """removeFrayedEnds: drop zero-length first and/or last block."""
    if blocks and blocks[0].q_start == blocks[0].q_end:
        blocks = blocks[1:]
    if blocks and blocks[-1].q_start == blocks[-1].q_end:
        blocks = blocks[:-1]
    return blocks
