"""Non-nested net filter.

Behavioral reference: src/NetFilterNonNested.perl.  Unlike netFilter's
recursive subtree pruning, every fill line is evaluated *individually*; when
a fill is dropped, its own gap lines disappear and all deeper descendants
are promoted two spaces left.  Four modes: UCSC-syn, score, batch sets, and
the legacy two-set mode.

The implementation is line-based like the Perl (the indentation tree never
needs to be materialized), including its quirks:
- a dropped fill's *direct* gap children (level+1) are skipped; deeper lines
  get MinusSpaces += 2 per dropped ancestor
- `Level2IsSkipped` keyed by absolute level controls syn/inv rescue
  (parent at level-2 must be kept)
- a `net` header is printed only if at least one of its fills survives
"""

from __future__ import annotations

import gzip
import io
import re
import sys

INT_MAX = 2 ** 31 - 1

# UCSC thresholds from netFilter.c (mirrored in NetFilterNonNested.perl:29-33)
UCSC_MIN_TOP_SCORE = 300000
UCSC_MIN_SYN_SCORE = 200000
UCSC_MIN_SYN_SIZE = 20000
UCSC_MIN_SYN_ALI = 10000
UCSC_MAX_FAR = 200000

_FILL_RE = re.compile(r"^([ ]+)((?:fill|gap).*)")


class NetFilterNonNested:
    def __init__(self,
                 min_score1: int = 0, min_size_t1: int = 0, min_size_q1: int = 0,
                 min_score2: int = 0, min_size_t2: int = 0, min_size_q2: int = 0,
                 min_scores: list[int] | None = None,
                 min_t_sizes: list[int] | None = None,
                 min_q_sizes: list[int] | None = None,
                 keep_syn_nets_with_score: int = INT_MAX,
                 keep_inv_nets_with_score: int = INT_MAX,
                 do_score_filter: bool = False,
                 do_ucsc_syn_filter: bool = False):
        self.min_score1 = min_score1
        self.min_size_t1 = min_size_t1
        self.min_size_q1 = min_size_q1
        self.min_score2 = min_score2
        self.min_size_t2 = min_size_t2
        self.min_size_q2 = min_size_q2
        self.min_scores = min_scores
        self.min_t_sizes = min_t_sizes
        self.min_q_sizes = min_q_sizes
        self.keep_syn = keep_syn_nets_with_score
        self.keep_inv = keep_inv_nets_with_score
        self.do_score_filter = do_score_filter
        self.do_ucsc = do_ucsc_syn_filter

        self.filter_mode = ""
        if any(v != 0 for v in (min_score1, min_size_t1, min_size_q1,
                                min_score2, min_size_t2, min_size_q2)):
            self.filter_mode = "12"
            if min_score2 == 0 and min_size_t2 == 0 and min_size_q2 == 0:
                self.min_score2 = INT_MAX
                self.min_size_t2 = INT_MAX
                self.min_size_q2 = INT_MAX
            if min_score1 == 0 and min_size_t1 == 0 and min_size_q1 == 0:
                self.min_score1 = INT_MAX
                self.min_size_t1 = INT_MAX
                self.min_size_q1 = INT_MAX
        if min_scores is not None:
            if self.filter_mode == "12":
                raise ValueError("cannot mix batch and individual filtering")
            self.filter_mode = "batch"

    # -- filters ------------------------------------------------------------
    def _test_inv_syn(self, score, typ, level, level2_skipped) -> bool:
        if level2_skipped.get(level - 2, 0) == 0:
            if typ == "inv":
                return score >= self.keep_inv
            if typ == "syn":
                return score >= self.keep_syn
            return False
        return False

    def _ucsc_filter(self, score, t_size, q_size, typ, ali, q_far, level,
                     level2_skipped) -> bool:
        if typ == "":
            raise ValueError("No type field, please run input net through netSyntenic")
        if (score >= UCSC_MIN_SYN_SCORE and t_size >= UCSC_MIN_SYN_SIZE
                and ali >= UCSC_MIN_SYN_ALI):
            return True
        if typ == "top":
            return score >= UCSC_MIN_TOP_SCORE
        if typ == "nonSyn":
            return False
        if q_far > UCSC_MAX_FAR:
            return False
        return self._test_inv_syn(score, typ, level, level2_skipped)

    def _score_filter(self, score, typ, level, level2_skipped) -> bool:
        if typ == "":
            raise ValueError("No type field, please run input net through netSyntenic")
        if score >= self.min_score1:
            return True
        if typ in ("top", "nonSyn"):
            return False
        return self._test_inv_syn(score, typ, level, level2_skipped)

    def passes(self, score, t_size, q_size, typ, ali, q_far, level,
               level2_skipped) -> bool:
        if self.do_ucsc:
            return self._ucsc_filter(score, t_size, q_size, typ, ali, q_far,
                                     level, level2_skipped)
        if self.do_score_filter:
            return self._score_filter(score, typ, level, level2_skipped)
        if typ == "syn" and score >= self.keep_syn:
            return True
        if typ == "inv" and score >= self.keep_inv:
            return True
        if self.filter_mode == "12":
            return ((score >= self.min_score1 and t_size >= self.min_size_t1
                     and q_size >= self.min_size_q1)
                    or (score >= self.min_score2 and t_size >= self.min_size_t2
                        and q_size >= self.min_size_q2))
        if self.filter_mode == "batch":
            return any(score >= s and t_size >= t and q_size >= q
                       for s, t, q in zip(self.min_scores, self.min_t_sizes,
                                          self.min_q_sizes))
        raise ValueError(f"unknown filterMode {self.filter_mode!r}")

    # -- main line-based pass ----------------------------------------------
    def filter_lines(self, lines: list[str], out) -> None:
        need_type = (self.keep_syn < INT_MAX or self.keep_inv < INT_MAX
                     or self.do_ucsc)
        net_kept: dict[int, int] = {}  # index of net line -> kept fill count
        skip: set[int] = set()
        minus_spaces: dict[int, int] = {}
        level2_skipped: dict[int, int] = {}
        max_level = 1
        cur_net = -1
        net_of_line: dict[int, int] = {}

        # find first net line
        start = 0
        for start in range(len(lines)):
            if lines[start].startswith("#"):
                continue
            if not lines[start].startswith("net "):
                raise ValueError(
                    f"expect file to start with net, got: {lines[start]}")
            break
        cur_net = start
        net_kept[cur_net] = 0

        for i in range(start + 1, len(lines)):
            line = lines[i]
            if " gap " in line:  # Perl: next if / gap /
                net_of_line[i] = cur_net
                continue
            if line.startswith("net "):
                cur_net = i
                net_kept[cur_net] = 0
                continue
            # manual leading-space scan (the _FILL_RE regex is the hot
            # cost at chr1 scale); same accept/reject set as _FILL_RE
            level = len(line) - len(line.lstrip(" "))
            rest = line[level:]
            if level < 1 or not (rest.startswith("fill ")
                                 or rest.startswith("gap ")):
                raise ValueError(f"expect fill or gap in {line!r}")
            net_of_line[i] = cur_net
            if level > max_level:
                max_level = level
            if not rest.startswith("fill"):
                continue
            w = rest.split(" ")

            typ = ""
            if need_type:
                mt = re.search(r"type (\w+) ", rest) or re.search(r"type (\w+)$", rest)
                if mt is None:
                    raise ValueError(f"cannot parse net type from: {rest}")
                typ = mt.group(1)
            ali = 0
            if self.do_ucsc:
                ma = re.search(r"ali (\d+) ", rest)
                if ma is None:
                    raise ValueError(f"cannot parse ali field from: {rest}")
                ali = int(ma.group(1))
            q_far = 0
            if self.do_ucsc and typ in ("inv", "syn"):
                mf = re.search(r"qFar (\d+) ", rest)
                if mf is None:
                    raise ValueError(f"cannot parse qFar field from: {rest}")
                q_far = int(mf.group(1))
            si = rest.find(" score ")
            if si < 0:
                raise ValueError(f"no score field in fill line: {rest}")
            se = rest.find(" ", si + 7)
            score = int(rest[si + 7:] if se < 0 else rest[si + 7:se])

            if self.passes(score, int(w[2]), int(w[6]), typ, ali, q_far,
                           level, level2_skipped):
                net_kept[cur_net] += 1
                for lv in range(level, max_level + 1):
                    level2_skipped[lv] = 0
            else:
                skip.add(i)
                self._erase_gaps_mark_skip(lines, i + 1, level, skip,
                                           minus_spaces)
                level2_skipped[level] = 1

        # output
        for i in range(len(lines)):
            line = lines[i]
            if line.startswith("net "):
                if net_kept.get(i, 0) > 0:
                    out.write(line + "\n")
            if i not in skip:
                level = len(line) - len(line.lstrip(" "))
                if level >= 1:
                    if i in minus_spaces:
                        out.write(line[minus_spaces[i]:] + "\n")
                    else:
                        out.write(line + "\n")

    @staticmethod
    def _erase_gaps_mark_skip(lines, start_idx, level, skip, minus_spaces):
        for i in range(start_idx, len(lines)):
            line = lines[i]
            if line.startswith("net "):
                return
            cur_level = len(line) - len(line.lstrip(" "))
            if cur_level < 1 or not (line[cur_level:].startswith("fill ")
                                     or line[cur_level:].startswith("gap ")):
                raise ValueError(f"expect fill or gap in {line!r}")
            if cur_level <= level:
                return
            if cur_level == level + 1:
                skip.add(i)
            else:
                minus_spaces[i] = minus_spaces.get(i, 0) + 2


_PLAIN12_KEYS = {"min_score1", "min_size_t1", "min_size_q1",
                 "min_score2", "min_size_t2", "min_size_q2"}


def filter_net_bytes(data: bytes, **kwargs) -> "memoryview | None":
    """Native two-set filter over raw net text (netwrite.cpp
    gat_netfilter12); None when the mode or input is not handled (caller
    falls back to the line-based python filter, byte-identical)."""
    if set(kwargs) - _PLAIN12_KEYS or not any(kwargs.values()):
        return None
    from ..native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "gat_netfilter12"):
        return None
    f = NetFilterNonNested(**kwargs)  # resolves the INT_MAX set defaults
    if f.filter_mode != "12":
        return None
    import ctypes

    import numpy as np
    out_len = ctypes.c_int64()
    ok = ctypes.c_int32(0)
    p = lib.gat_netfilter12(data, len(data),
                            f.min_score1, f.min_size_t1, f.min_size_q1,
                            f.min_score2, f.min_size_t2, f.min_size_q2,
                            ctypes.byref(out_len), ctypes.byref(ok))
    try:
        if not ok.value:
            return None
        from ..utils.bigmem import big_empty
        out_arr = big_empty(out_len.value, np.uint8)
        if out_len.value:
            ctypes.memmove(out_arr.ctypes.data, p, out_len.value)
        return memoryview(out_arr).cast("B")
    finally:
        if p:
            lib.gat_free_buffer(p)


def net_filter_non_nested(in_path_or_lines, out,
                          **kwargs) -> None:
    data = None
    if isinstance(in_path_or_lines, str) and \
            not in_path_or_lines.endswith(".gz"):
        with open(in_path_or_lines, "rb") as f:
            data = f.read()
        mv = filter_net_bytes(data, **kwargs)
        if mv is not None:
            buf = getattr(out, "buffer", None)
            if buf is not None:
                out.flush()
                buf.write(mv)
            else:
                out.write(bytes(mv).decode())
            return
    if data is not None:
        lines = data.decode().splitlines()
    elif isinstance(in_path_or_lines, list):
        lines = in_path_or_lines
    elif isinstance(in_path_or_lines, str):
        with io.TextIOWrapper(gzip.open(in_path_or_lines, "rb")) as f:
            lines = f.read().splitlines()
    else:
        lines = in_path_or_lines.read().splitlines()
    NetFilterNonNested(**kwargs).filter_lines(lines, out)


def net_filter_non_nested_main(argv: list[str]) -> int:
    """CLI compatible with NetFilterNonNested.perl's GNU-style options."""
    args = list(argv)
    pos = []
    kw = {}
    flag_map = {
        "minScore1": "min_score1", "minSizeT1": "min_size_t1",
        "minSizeQ1": "min_size_q1", "minScore2": "min_score2",
        "minSizeT2": "min_size_t2", "minSizeQ2": "min_size_q2",
        "keepSynNetsWithScore": "keep_syn_nets_with_score",
        "keepInvNetsWithScore": "keep_inv_nets_with_score",
    }
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("-v", "-verbose", "--verbose"):
            i += 1
            continue
        if a.lstrip("-") in flag_map and a.startswith("-"):
            kw[flag_map[a.lstrip("-")]] = int(args[i + 1])
            i += 2
            continue
        if a in ("-doScoreFilter", "--doScoreFilter"):
            kw["do_score_filter"] = True
            i += 1
            continue
        if a in ("-doUCSCSynFilter", "--doUCSCSynFilter"):
            kw["do_ucsc_syn_filter"] = True
            i += 1
            continue
        if a in ("-minScore", "-minSizeT", "-minSizeQ"):
            key = {"-minScore": "min_scores", "-minSizeT": "min_t_sizes",
                   "-minSizeQ": "min_q_sizes"}[a]
            kw[key] = [int(x) for x in args[i + 1].split(",")]
            i += 2
            continue
        pos.append(a)
        i += 1
    if not pos:
        print("usage: NetFilterNonNested input.net[.gz] [options] > out.net",
              file=sys.stderr)
        return 255
    net_filter_non_nested(pos[0], sys.stdout, **kw)
    return 0
