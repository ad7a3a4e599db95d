"""Blastz-style nucleotide substitution score matrices.

Behavioral reference: kent/src/lib/axt.c (axtScoreSchemeDefault:423-458,
propagateCase:402-421, axtScoreSchemeReadLf:692-819).

The C scheme is a 256x256 int matrix indexed by raw sequence characters.
Only the 16 acgt x acgt cells (propagated across case) are non-zero; any
pairing involving any other character (notably 'n'/'N') scores 0 because
those matrix rows stay zero-initialized.

Our device representation is a 5x5 int32 LUT over base codes
(T=0, C=1, A=2, G=3, N=4 - the 2bit packing order of dnautil.h:23-27), with
the N row/column all zero.  Case never affects scoring (propagateCase makes
the matrix case-blind); masking is carried separately by the genome model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Base codes follow the .2bit packed encoding: T=0 C=1 A=2 G=3; 4 means
# "anything else" (N or unexpected characters) and always scores 0.
CODE_T, CODE_C, CODE_A, CODE_G, CODE_N = 0, 1, 2, 3, 4
NUM_CODES = 5

# order used by blastz matrix files (rows/cols are A C G T)
_ACGT_TO_CODE = {"a": CODE_A, "c": CODE_C, "g": CODE_G, "t": CODE_T}

# Default blastz matrix (axtScoreSchemeDefault), in A,C,G,T file order.
_DEFAULT_MATRIX_ACGT = [
    [91, -114, -31, -123],
    [-114, 100, -125, -31],
    [-31, -125, 100, -114],
    [-123, -31, -114, 91],
]
_DEFAULT_GAP_OPEN = 400
_DEFAULT_GAP_EXTEND = 30


@dataclass
class ScoreScheme:
    """Substitution scores + affine gap parameters.

    lut is a 5x5 int32 array indexed [q_code, t_code] (codes above).
    """

    lut: np.ndarray
    gap_open: int = _DEFAULT_GAP_OPEN
    gap_extend: int = _DEFAULT_GAP_EXTEND
    extra: str = ""

    @property
    def matrix_acgt(self) -> np.ndarray:
        """Return the 4x4 matrix in A,C,G,T order (blastz file order)."""
        order = [CODE_A, CODE_C, CODE_G, CODE_T]
        return self.lut[np.ix_(order, order)]

    def char_matrix(self) -> np.ndarray:
        """256x256 int matrix indexed by character code, as in the C struct.

        Used by tests to cross-check against reference semantics.
        """
        m = np.zeros((256, 256), dtype=np.int64)
        for qc_char, qcode in _ACGT_TO_CODE.items():
            for tc_char, tcode in _ACGT_TO_CODE.items():
                v = int(self.lut[qcode, tcode])
                for qcase in (qc_char, qc_char.upper()):
                    for tcase in (tc_char, tc_char.upper()):
                        m[ord(qcase), ord(tcase)] = v
        return m


def _scheme_from_acgt(matrix_acgt, gap_open, gap_extend, extra="") -> ScoreScheme:
    lut = np.zeros((NUM_CODES, NUM_CODES), dtype=np.int32)
    file_order = [CODE_A, CODE_C, CODE_G, CODE_T]
    for i, qi in enumerate(file_order):
        for j, tj in enumerate(file_order):
            lut[qi, tj] = matrix_acgt[i][j]
    return ScoreScheme(lut=lut, gap_open=int(gap_open), gap_extend=int(gap_extend),
                       extra=extra)


def score_scheme_default() -> ScoreScheme:
    """axtScoreSchemeDefault: the blastz default matrix, O=400 E=30."""
    return _scheme_from_acgt(_DEFAULT_MATRIX_ACGT, _DEFAULT_GAP_OPEN, _DEFAULT_GAP_EXTEND)


def score_scheme_simple_dna(match: int, mismatch: int,
                            gap_open: int, gap_extend: int) -> ScoreScheme:
    """axtScoreSchemeSimpleDna."""
    m = [[match if i == j else -mismatch for j in range(4)] for i in range(4)]
    return _scheme_from_acgt(m, gap_open, gap_extend)


def score_scheme_from_blastz_matrix_string(text: str, gap_open: int,
                                           gap_extend: int) -> ScoreScheme:
    """axtScoreSchemeFromBlastzMatrix: 16 comma separated ints in ACGT order."""
    vals = [v for v in text.split(",") if v != ""]
    if len(vals) != 16:
        return score_scheme_default()
    m = [[int(vals[i * 4 + j]) for j in range(4)] for i in range(4)]
    return _scheme_from_acgt(m, gap_open, gap_extend)


def read_score_scheme(path: str) -> ScoreScheme:
    """axtScoreSchemeRead: parse a blastz .q matrix file.

    Handles both the classic format (header row "A C G T", 4 rows of 4 or 5
    numbers, optional trailing "O = x, E = y" line) and the newer lastz
    tuning-settings format with tag=value lines before the matrix
    (axtScoreSchemeReadLf:692-819).
    """
    with open(path) as f:
        lines = f.read().splitlines()

    extra_parts: list[str] = []
    matrix: list[list[int]] = []
    gap_open = None
    gap_extend = None

    i = 0
    n = len(lines)

    raw_line = [None]

    def next_words(idx):
        # kent's lineFileChopNext skips blank and '#'-comment lines and
        # chops at most 6 words (ArraySize(row)); trailing words beyond six
        # only matter for settings lines, which strip at '#' anyway.  The
        # raw line is kept for the post-matrix O/E line, which the C code
        # reads unchopped (axtScoreSchemeReadLf).
        while idx < n:
            stripped = lines[idx].strip()
            if stripped and not stripped.startswith("#"):
                raw_line[0] = lines[idx]
                return idx, lines[idx].split()[:6]
            idx += 1
        raw_line[0] = None
        return idx, None

    i, words = next_words(i)
    if words is None:
        raise ValueError(f"Scoring matrix file {path} too short")

    while True:
        if "=" in words[0] or (len(words) > 1 and "=" in words[1]):
            # settings line: collapse whitespace, strip trailing comment
            joined = "".join(words)
            joined = joined.split("#")[0]
            parts = joined.split("=")
            if parts[0] not in ("O", "E"):
                extra_parts.append(f"{parts[0]}={parts[1]}")
            i, words = next_words(i + 1)
            if words is None:
                raise ValueError(f"Scoring matrix file {path} too short")
            continue
        if not (words[0][0] == "A" and words[1][0] == "C"
                and words[2][0] == "G" and words[3][0] == "T"):
            raise ValueError(f"{path} doesn't seem to be a score matrix file")
        # matrix rows follow the header
        for _ in range(4):
            i, words = next_words(i + 1)
            if words is None:
                raise ValueError(f"Scoring matrix file {path} too short")
            start = 1 if len(words) == 5 else 0
            matrix.append([int(w) for w in words[start:start + 4]])
        # optional last line: O = 400, E = 30
        i, words = next_words(i + 1)
        if words is not None:
            line = raw_line[0]
            extra_parts.append(line)
            toks = [t for t in line.replace("=", " ").replace(",", " ").split() if t]
            for k in range(len(toks) - 1):
                if toks[k] == "O":
                    gap_open = int(toks[k + 1])
                if toks[k] == "E":
                    gap_extend = int(toks[k + 1])
            if gap_open is None or gap_extend is None:
                raise ValueError(f"Expecting O = and E = in last line of {path}")
            if gap_open <= 0 or gap_extend <= 0:
                raise ValueError("Must have positive gap scores")
        else:
            gap_open = _DEFAULT_GAP_OPEN
            gap_extend = _DEFAULT_GAP_EXTEND
        break

    extra = ",".join(extra_parts)
    return _scheme_from_acgt(matrix, gap_open, gap_extend, extra=extra)
