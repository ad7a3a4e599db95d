"""The port's copies of the reference's jax-free layers stay copies.

The port imports nothing of genomealignmenttools_tpu, so it keeps its own
copy of every host layer it uses, at the same relative path.  This file
holds each copy against the reference: a C++ source or header byte for
byte (but for one comment line that named a directory of the machine the
reference was written on), a Python module line for line.  The reference's modules import each
other relatively, so a copy needs no import rewritten; the files that do
differ are listed in DIFFERENCES, each intended difference by name with the
lines of the REFERENCE file it replaces (1-based, inclusive; an insertion
counts at the line it is inserted before), and the rest of the file is held
equal.  A passage that only moved under a new block is named in REINDENTED
and held equal with each line's leading whitespace stripped.  A later
change of either side then fails here, in one place.
"""

import difflib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "genomealignmenttools_tpu")
PORT = os.path.join(REPO, "genomealignmenttools_tpu_torch")

NATIVE_SOURCES = ["bandext.cpp", "breakloop.cpp", "chainblocks.cpp",
                  "chaincodec.cpp", "hspscan.cpp", "netscan.cpp",
                  "netsweep.cpp", "netwrite.cpp", "pairpack.cpp",
                  "twobitdec.cpp", "gat_threads.h"]

# the port's own native sources, which the reference does not have: each
# one is named here, so that any other source of the port's native/ that is
# not a copy fails test_every_native_source_is_copied
PORT_ONLY_NATIVE_SOURCES = ["chainpairs.cpp"]

PYTHON_COPIES = (
    [f"utils/{n}.py" for n in ("verbose", "bigmem", "kenthash", "pipeline",
                               "bench_workload")]
    + ["native/chain_io.py", "native/__init__.py", "device/genome.py"]
    + [f"formats/{n}.py" for n in (
        "__init__", "chain", "net", "axt", "psl", "maf", "lav", "nib",
        "twobit", "chromsizes", "scorematrix", "gapcalc")]
    + ["ops/band_ext.py", "ops/seed_extend.py"]
    + [f"engines/{n}.py" for n in (
        "scoring", "score_chain", "chain_net", "chain_cleaner", "chain_tools",
        "chain_connect", "chain_bridge", "kd_chainer", "axt_chain",
        "converters", "lav_tools", "maf_tools", "net_tools",
        "net_filter_nonnested", "repeat_filler", "drivers")]
    + ["cli/main.py"])

# C++ source -> the lines (1-based) that differ, with the port's text
NATIVE_DIFFERENCES = {
    "hspscan.cpp": {5: "// RepeatFiller/patchChain, src/RepeatFiller.py:"
                       "163-169 of the C reference):"},
}

# file -> {intended difference: [(first, last) line of the reference]}
DIFFERENCES = {
    "utils/bench_workload.py": {
        "the C reference's file, without a machine's directory": [(322, 322)],
    },
    "device/genome.py": {
        "import of the phase timer": [(17, 17)],
        "phase `genome: decode` opens at the cache miss": [(93, 93)],
    },
    "native/__init__.py": {
        "header note: the lock and the build directory": [(3, 5)],
        "threading, and BUILD_DIR of the CUDA build": [(13, 13)],
        "the library lives in the package's build/": [(15, 15)],
        "_build: a g++ a source, temporary names, os.replace": [(31, 39)],
        "get_lib under a lock": [(43, 44)],
        "_SRCS adds the port's chainpairs.cpp": [(25, 25)],
    },
    "ops/seed_extend.py": {
        "GapAligner takes the band DP's device": [(114, 115)],
        "_band_batch returns the port's BandExtBatch": [(205, 210)],
        "align composes align_seed and align_scan": [(473, 485)],
        "align_prepare composes align_seed, align_scan and align_probs":
            [(503, 527)],
        "_holding_a_seed: under masked seeding align_scan keeps only the "
        "HSPs that hold a seed word": [(87, 87)],
        "_seed_windows returns its seed words beside its windows": [
            (327, 327), (335, 335), (338, 338), (358, 358)],
        "_seed_windows' docstring: hsp_margin is wider than lastz's "
        "x-drop": [(320, 321)],
        "docstring: the prefilter of a chunk of gaps in one K4 launch": [
            (18, 18)],
        "imports of os, torch, the PERF counters and the phase timer": [
            (26, 27)],
        "pack_windows and _native_scan, the chunk-wide scan's packing and "
        "the native scan's lookup": [(87, 87)],
        "counter `hsp_windows_host`: the windows of the host scan": [
            (374, 374)],
        "_scan_windows_native calls _native_rows, which the chunk-wide "
        "scan shares": [(422, 460)],
        "align and align_prepare scan through align_scan_batch": [
            (473, 485), (503, 527)],
        "align_scan_batch, _scan_batch_rows, _window_bests and _exact_rows: "
        "the chunk-wide scan (K4 on the card)": [(514, 514)],
    },
    "engines/score_chain.py": {
        "device argument": [(32, 36)],
        "scorer seam: torch_scorer_factory(device)": [(49, 52)],
    },
    "engines/chain_net.py": {
        "import of the PERF counters": [(31, 31)],
        "each side's writer returns the fill lines it wrote": [
            (319, 321), (327, 327), (333, 333), (530, 530), (545, 545),
            (549, 549), (568, 568), (583, 583)],
        "device argument": [(862, 864)],
        "scorer seam: torch_scorer_factory(device)": [(879, 880)],
        "counter `chainnet_rescored_fills` on each path that scores a "
        "partial fill": [(886, 886), (1044, 1044), (1065, 1065)],
        "phases `chainnet: parse`, `chainnet: net sweep`, `chainnet: "
        "rescore fills` and `chainnet: write` open where phase_add closed "
        "the generic ones": [(890, 893), (963, 964), (998, 999),
                             (1081, 1082), (1119, 1119)],
        "the table path: every scorer with score_subsets (every mode of "
        "the port's) cuts and scores the partial fills from the chain "
        "table's arrays, with the jobs that were the host-native branch's "
        "alone": [(1007, 1021), (1033, 1039)],
        "counter `chainnet_subsets_python`: partial fills cut by "
        "Chain.subset_on_t": [(886, 886), (1059, 1059)],
        "counter `chainnet_fills`: the target side's fill lines": [
            (1105, 1105), (1111, 1111), (1116, 1116)],
        "chain_net_main passes the CLI's device": [(1122, 1122),
                                                    (1150, 1150)],
    },
    "engines/chain_cleaner.py": {
        "import of the phase timer": [(47, 47)],
        "import of the PERF counters": [(41, 41)],
        "_prescore_breaks: device scorers cut every job at once through "
        "score_subsets over ChainRows, scorers with only score_chains cut "
        "them by subset_on_t, each path counted in PERF; both take their "
        "jobs from _prescore_jobs, the one job collector": [(664, 703)],
        "_prescore_native takes its rows, blocks and jobs from "
        "_prescore_jobs": [(720, 786)],
        "phase `cleaner: prescore` opens in the python break loop": [
            (1010, 1010)],
        "phase `cleaner: net` opens around the in-memory netting": [
            (1542, 1542), (1554, 1554), (1567, 1567)],
        "root phase `chainCleaner`: the call's start, phase_add at each "
        "return": [(1412, 1412), (1685, 1685), (1731, 1731)],
        "device argument, handed down": [(1359, 1359), (1370, 1370),
                                         (1387, 1387), (1406, 1406)],
        "scorer seam: torch_scorer_factory(device)": [(1418, 1422)],
        "chain_cleaner_main passes the CLI's device": [(1736, 1736),
                                                        (1786, 1786)],
        "clean_chains_distributed on torch.distributed": [(1846, 1866)],
    },
    "engines/repeat_filler.py": {
        "import of the phase timer": [(35, 35)],
        "import of the PERF counters": [(30, 30)],
        "import of the native chaining batch, ops/chain_pairs.py": [
            (34, 34)],
        "run_gap_job goes (GAT_RF_BATCH=0 runs chunks of one gap) for "
        "_gap_jobs_hsps, which runs each stage over a batch, one phase "
        "`<prefix>: <stage>` a stage, with the seed codes a caller gives "
        "(patchChain's masked seeds), and _gap_jobs_chains, which chains "
        "the batch in one native call, the per-gap python path "
        "(_gap_job_chains) its fallback": [(145, 155)],
        "_gap_chunks: chunks of 4,096 gaps, of one under GAT_RF_BATCH=0, "
        "for RepeatFiller and patchChain": [(200, 200)],
        "_run_gap_jobs: each chunk of _gap_chunks through _gap_jobs_chains":
            [(211, 240)],
        "root phase `repeatfiller`": [(243, 243)],
        "device argument": [(253, 255)],
        "phase `rf: read + harvest` opens": [(261, 261)],
        "the gap aligner gets the device": [(307, 307)],
        "every chunk's mini-chains, gathered before the splice": [
            (310, 311)],
        "phase `rf: splice + write` opens": [(309, 309)],
        "repeat_filler_main passes the CLI's device": [(331, 331),
                                                        (403, 403)],
    },
    "engines/drivers.py": {
        "header note: patchChain aligns over chunks of gaps": [(8, 10)],
        "import of the PERF counters": [(32, 32)],
        "import of the phase timer": [(38, 38)],
        "import of RepeatFiller's gap stages": [(43, 43)],
        "root phase `patchchain`": [(181, 181)],
        "patch_chain's docstring names its chunks, phases and counter": [
            (199, 199)],
        "patch_chain: device argument, to the gap aligner; the unused "
        "code_to_char gone": [(193, 195), (229, 230)],
        "phase `pc: read + harvest` opens": [(209, 209)],
        "the shard filter on two lines, under its phase": [(214, 214)],
        "job_seed_codes (a job's masked seed codes from the seed_codes "
        "cache), and every chunk of gaps through RepeatFiller's stages "
        "(_gap_jobs_hsps, phases `pc: *`, one band batch a chunk), counted "
        "in PERF, where the reference aligns a gap at a time; then phase "
        "`pc: axt + psl` opens over the axt records in job order": [
            (249, 266)],
        "counter `pc_psl_records`": [(282, 282)],
        "job scripts run the port's CLI": [(323, 323)],
        "filter_chains_net_filter_nets: device, to chain_net": [
            (356, 358), (377, 377), (399, 399), (423, 423), (456, 456)],
    },
    "cli/main.py": {
        "header note: the port's CLI and its -device": [(3, 8)],
        "device commands take the device": [
            (32, 32), (52, 52), (113, 120), (133, 135), (512, 512),
            (566, 570), (587, 587)],
        "job scripts carry -device": [(535, 535)],
        "main: -device, DEVICE_COMMANDS, the torch trace": [(747, 750),
                                                            (774, 775)],
    },
}


# file -> {passage that moved under a new block: [(first, last) line of the
# reference]}; the block's opener is an intended difference above, and the
# passage is held to the reference with each line's leading whitespace
# stripped
REINDENTED = {
    "device/genome.py": {
        "the decode, under `genome: decode`": [(93, 99)],
    },
    "engines/chain_net.py": {
        "the parse, under `chainnet: parse`": [(894, 948)],
        "the net sweep, under `chainnet: net sweep`": [(965, 997)],
        "the fills' subsets and the scorer call, under `chainnet: rescore "
        "fills`": [(1000, 1080)],
        "both sides' writers, under `chainnet: write`": [(1083, 1118)],
    },
    "engines/chain_cleaner.py": {
        "the prescore, under `cleaner: prescore`": [(1010, 1010)],
        "the table path's return, under its branch": [(669, 669)],
        "the in-memory netting, under `cleaner: net`": [(1542, 1542),
                                                       (1554, 1573)],
    },
    "engines/drivers.py": {
        "the read, the harvest, the aligner and the seed codes, under "
        "`pc: read + harvest`": [(209, 247)],
        "the axt records, the filter and the psl write, under "
        "`pc: axt + psl`": [(249, 289)],
    },
    "engines/repeat_filler.py": {
        "the read, the filters, the harvest and the aligner, under "
        "`rf: read + harvest`": [(261, 307)],
        "the splice and the write, under `rf: splice + write`": [
            (309, 328)],
    },
}

def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("name", NATIVE_SOURCES)
def test_native_source_is_byte_identical(name):
    with open(os.path.join(REF, "native", name), "rb") as a, \
            open(os.path.join(PORT, "native", name), "rb") as b:
        ref, port = a.read(), b.read()
    differs = NATIVE_DIFFERENCES.get(name, {})
    if not differs:
        assert ref == port
        return
    ref_lines, port_lines = ref.split(b"\n"), port.split(b"\n")
    assert len(ref_lines) == len(port_lines)
    for k, (r, p) in enumerate(zip(ref_lines, port_lines), start=1):
        if k in differs:
            assert p.decode() == differs[k] and r != p
        else:
            assert r == p, f"{name}:{k}"


def test_every_native_source_is_copied():
    """The list above is the reference loader's own list of sources; the
    port's native/ holds those and its own, named in
    PORT_ONLY_NATIVE_SOURCES."""
    ref_sources = sorted(n for n in os.listdir(os.path.join(REF, "native"))
                         if n.endswith((".cpp", ".h")))
    assert ref_sources == sorted(NATIVE_SOURCES)
    port_sources = sorted(n for n in os.listdir(os.path.join(PORT, "native"))
                          if n.endswith((".cpp", ".h")))
    assert port_sources == sorted(ref_sources + PORT_ONLY_NATIVE_SOURCES)


def _inside(tag, i1, i2, ranges):
    """Is the opcode over reference lines [i1, i2) (0-based) inside one of
    the 1-based inclusive ranges?"""
    if tag == "insert":
        return any(lo <= i1 + 1 <= hi + 1 for lo, hi in ranges)
    return any(lo <= i1 + 1 and i2 <= hi for lo, hi in ranges)


def _changes(ref, port):
    """The opcodes of port against ref, diffed with each line's leading
    whitespace stripped, that are not "equal"; a line that differs in its
    indentation alone comes out as one "indent" opcode."""
    out = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, [ln.lstrip() for ln in ref], [ln.lstrip() for ln in port],
            autojunk=False).get_opcodes():
        if tag != "equal":
            out.append((tag, i1, i2, j1, j2))
            continue
        out += [("indent", i, i + 1, j, j + 1)
                for i, j in zip(range(i1, i2), range(j1, j2))
                if ref[i] != port[j]]
    return out


@pytest.mark.parametrize("rel", PYTHON_COPIES)
def test_python_copy_equals_the_reference(rel):
    ref, port = _lines(os.path.join(REF, rel)), _lines(os.path.join(PORT, rel))
    named = DIFFERENCES.get(rel, {})
    moved = REINDENTED.get(rel, {})
    every = [r for ranges in named.values() for r in ranges]
    shifted = every + [r for ranges in moved.values() for r in ranges]
    changed = _changes(ref, port)
    stray = [(tag, f"reference lines {i1 + 1}-{i2}", port[j1:j2])
             for tag, i1, i2, j1, j2 in changed
             if not _inside(tag, i1, i2,
                            shifted if tag == "indent" else every)]
    assert not stray, f"{rel} differs from the reference outside the " \
                      f"intended differences: {stray}"
    # and no entry of either dictionary has gone stale
    for what, ranges in named.items():
        for r in ranges:
            assert any(_inside(tag, i1, i2, [r])
                       for tag, i1, i2, _, _ in changed
                       if tag != "indent"), \
                f"{rel}: nothing differs at {r} ({what})"
    for what, ranges in moved.items():
        for r in ranges:
            assert any(_inside(tag, i1, i2, [r])
                       for tag, i1, i2, _, _ in changed
                       if tag == "indent"), \
                f"{rel}: nothing is re-indented at {r} ({what})"


def test_every_engine_and_format_is_copied():
    """The copies are whole layers: every module of the reference's
    engines/ and formats/ has its counterpart in the list."""
    for layer in ("engines", "formats"):
        ref_modules = sorted(n for n in os.listdir(os.path.join(REF, layer))
                             if n.endswith(".py") and n != "__init__.py")
        listed = sorted(os.path.basename(p) for p in PYTHON_COPIES
                        if p.startswith(layer + "/")
                        and not p.endswith("__init__.py"))
        assert listed == ref_modules


@pytest.mark.parametrize("rel,first,last", [
    ("utils/profiling.py", 24, 41),         # the profile directory
    ("utils/profiling.py", 43, 59),         # phase_acc_stop, phase_add
    ("parallel/distributed.py", 56, 65),    # shard_indices
    ("ops/rescore.py", 36, 42),             # _n_threads
    ("ops/rescore.py", 596, 710),           # the jax-free tail
])
def test_copied_passage_is_the_reference_s(rel, first, last):
    """Passages copied into modules the port wrote itself: the reference's
    lines first..last stand in the port's module unchanged."""
    passage = "\n".join(_lines(os.path.join(REF, rel))[first - 1:last])
    with open(os.path.join(PORT, rel)) as f:
        assert passage in f.read()
