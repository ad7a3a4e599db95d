"""genomealignmenttools_tpu_torch/sanitize.py on the CPU.

The tools themselves run on the card (`sanitize cuda`, chip_smoke.py's
[sanitize] phase) and in `sanitize tsan`; here: the case runner of the cuda
children with the plain versions, that the kernel filter names every
__global__ function of csrc/, the children's environment, the summary
parser and the verdict on a child's run, a missing compute-sanitizer, the
TSAN build's sources, and the repair of K1's loads past a genome's end
(its code storage padded to 16 bytes) with the case that reaches it.
"""

import glob
import os
import re

import numpy as np
import pytest
import torch

from genomealignmenttools_tpu_torch import sanitize as sz
from genomealignmenttools_tpu_torch.device import LAUNCHES, perf_reset
from genomealignmenttools_tpu_torch.device.genome import Genome
from genomealignmenttools_tpu_torch.formats.scorematrix import \
    score_scheme_default
from genomealignmenttools_tpu_torch.ops import band_batch as bb
from genomealignmenttools_tpu_torch.ops import window_rescore as wr
from genomealignmenttools_tpu_torch.ops.rescore import TorchGenomeCache
from genomealignmenttools_tpu_torch.parallel.mesh import ShardedBlockScorer
from rescore_cases import TAIL_LENGTHS, direct_sums, tail_case

CPU = torch.device("cpu")
PKG = os.path.dirname(os.path.abspath(sz.__file__))
LUT = wr.checked_lut(score_scheme_default().lut)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cases():
    return list(sz.kernel_cases(CPU))


SUBSETS = {
    "K1": r"^K1 (every alignment|chunks ending at the last byte of "
          r"(1|15|16|17|33)-base)",
    "K2": r"^K2 (int32 sums|\w+ rows of (1|2|64|128|130) bytes, tweak "
          r"(None|7)), edge$",
    "K3": r"^K3 (stale up cells|local out of band|global out of band|"
          r"wandered)",
}


@pytest.mark.parametrize("family", sorted(SUBSETS))
def test_child_case_runner_on_cpu(cases, family):
    """The cuda children's runner on -device=cpu: the kernels' wrappers run
    their plain versions there, launch nothing, and give the plain
    versions' digests."""
    chosen = [c for c in cases if re.search(SUBSETS[family], c.label)]
    assert len(chosen) >= 4
    perf_reset()
    seconds = {}
    got = sz.run_cases(CPU, True, chosen, seconds)
    assert not any(LAUNCHES.values())
    assert got == sz.run_cases(CPU, False, chosen)
    assert set(seconds) == {family}


def test_case_table_covers_every_entry(cases):
    labels = [c.label for c in cases]
    assert len(set(labels)) == len(labels)
    by = {}
    for c in cases:
        by.setdefault(c.label.split()[0], []).append(c)
    assert {k: len(v) for k, v in by.items()} == {
        "K1": 2 + len(TAIL_LENGTHS), "K2": 4 * (1 + 5 * 3 * 2), "K3": 30,
        "K4": 1}
    assert {c.key for c in cases} == set(sz.LAUNCH_KEYS)
    assert all(c.twice for c in by["K2"])
    k2 = " ".join(c.label for c in by["K2"])
    for name in sz.K2_INPUTS:
        assert f", {name}" in k2
    for width in (128, 130, 2, 6, 258):
        assert f"score8 rows of {width} bytes" in k2
        assert f"code rows of {width} bytes" in k2
    for width in (64, 65, 1, 3, 129):
        assert f"score4 rows of {width} bytes" in k2


def test_large_cases_name_k1_at_chr1_and_k2_on_200000_chains():
    large = list(sz.kernel_cases(CPU, large=True))   # built only when run
    assert [c.key for c in large] == ["rescore_chunks", "pair_combine",
                                      "pair_combine", "pair_combine_code",
                                      "pair_combine_score4"]
    assert all("200000 chains" in c.label for c in large[1:])
    assert all(c.twice for c in large[1:])


def test_case_table_reaches_every_k3_instantiation():
    import band_cases as bc
    sets = bc.kernel_cases() + bc.instantiation_cases()
    assert {bb.parent_layout(s[4])[0] for s in sets} == set(range(1, 9))
    assert {s[1] for s in sets} == {False, True}


def test_k3_cases_fetch_parent_rows_no_lane_fills():
    """The case that reached K3's unwritten parent words (fixed by writing
    every lane's word of every column): a traceback fetches whole rows of
    32 words, and the table's problems have columns with fewer cells than
    lanes (every band's first columns) and, in global mode, columns past
    the end of b (a longer than b by more than the band)."""
    import band_cases as bc
    for global_mode in (False, True):
        sets = [s for s in bc.kernel_cases() if s[1] == global_mode
                and len(s[5]) > 1]
        for _, _, _, _, mi, probs in sets:
            cells = bb.parent_layout(mi)[0]
            assert mi + 1 < 32 * cells      # the first column's cells
            if global_mode:
                assert any(len(a) > len(b) + 2 * mi + 2
                           for a, b, _ in probs)


def _globals_in_csrc() -> set:
    names = set()
    for path in glob.glob(os.path.join(PKG, "csrc", "*.cu")):
        with open(path) as f:
            names |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)\s*\(", f.read()))
    return names


def test_kernel_filter_names_every_global_function():
    """A new kernel in csrc/ cannot escape compute-sanitizer's filter."""
    assert _globals_in_csrc() == set(sz.KERNELS)
    opts = sz.kernel_filter()
    assert opts == [a for k in sz.KERNELS for a in ("--kernel-name",
                                                    f"kns={k}")]
    cmd = sz.sanitizer_command("/cs", "initcheck", ["python", "x.py"])
    assert cmd[:5] == ["/cs", "--tool", "initcheck", "--error-exitcode",
                       str(sz.ERROR_EXIT)]
    assert cmd[-2:] == ["python", "x.py"]
    for k in sz.KERNELS:
        assert f"kns={k}" in cmd


def test_children_run_without_the_caching_allocator():
    env = sz.child_env({"PYTHONPATH": "/elsewhere"})
    assert env["PYTORCH_NO_CUDA_MEMORY_CACHING"] == "1"
    assert env["PYTHONPATH"].split(os.pathsep) == [sz.REPO, "/elsewhere"]
    for checker in sz.CHECKERS:
        cmd = sz.child_command("synccheck", checker, "cuda:0", "/r.json",
                               exe="/cs")
        child = cmd[cmd.index("-m"):]
        assert child[:3] == ["-m", "genomealignmenttools_tpu_torch.sanitize",
                             "child"]
        assert "--wait-build" in child
        assert (cmd[0] == "/cs") == (checker == "compute-sanitizer")


def test_plain_shards_and_row_jobs_partition_the_run(cases, tmp_path):
    shards = [sz._shard(CPU, i, sz.PLAIN_SHARDS, False)
              for i in range(sz.PLAIN_SHARDS)]
    assert sorted(c.label for sh in shards for c in sh) == sorted(
        c.label for c in cases)
    k3 = {c.label for c in cases if c.key == "band_ext"}
    rest = [sz._shard(CPU, i, sz.PLAIN_SHARDS, False, skip=k3)
            for i in range(sz.PLAIN_SHARDS)]
    assert sorted(c.label for sh in rest for c in sh) == sorted(
        c.label for c in cases if c.label not in k3)
    jobs = [sz._row_jobs(i, sz.PLAIN_SHARDS) for i in range(sz.PLAIN_SHARDS)]
    every = [(n, c, k) for n in sz.K2_INPUTS for c in sz.K2_CHUNKS
             for k in sz.K2_KINDS]
    assert sorted(j for js in jobs for j in js) == sorted(every)
    assert max(map(len, jobs)) - min(map(len, jobs)) <= 1
    cmd = sz.plain_command(1, "cuda:0", "/p.json", inputs=str(tmp_path))
    assert cmd[cmd.index("--shard") + 1] == "1"
    assert cmd[cmd.index("--inputs") + 1] == str(tmp_path)


def test_shared_rows_equal_the_rows_made_in_process(tmp_path, monkeypatch):
    """A process that reads K2's rows from the run's files gets the rows
    it would have made itself (the two smallest jobs)."""
    jobs = sorted(sz._row_jobs(), key=lambda j: j[1])[:2]
    monkeypatch.setattr(sz, "_row_jobs", lambda shard=0, shards=1: jobs)
    sz.write_inputs(str(tmp_path))
    for job in jobs:
        assert np.array_equal(sz.k2_rows(*job, str(tmp_path)),
                              sz._make_rows(*job))
    sz.k2_rows.cache_clear()


@pytest.mark.parametrize("text, errors", [
    ("========= ERROR SUMMARY: 0 errors\n", 0),
    ("x\n========= ERROR SUMMARY: 1 error\n", 1),
    ("========= ERROR SUMMARY: 3 errors\n", 3),
    ("========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, "
     "0 warnings)\n", 0),
    ("========= RACECHECK SUMMARY: 2 hazards displayed (1 error, "
     "1 warning)\n", 2),
])
def test_summary_parser(text, errors):
    assert sz.parse_summary(text) == errors
    assert sz.parse_summary(sz.summary_line(errors)) == errors


def test_summary_parser_fails_without_a_summary():
    with pytest.raises(ValueError):
        sz.parse_summary("========= COMPUTE-SANITIZER\nall fine\n")


def _payload(plain, **kw):
    p = {"launches": dict.fromkeys(sz.LAUNCH_KEYS, 3), "digests": dict(plain),
         "cli": {"scoreChain (window)": "ok"},
         "checked_launches": 3 * len(sz.LAUNCH_KEYS),
         "unstable": [], "error": None, "foreign": []}
    p.update(kw)
    return p


def test_judge_fails_on_each_fault():
    plain = {"K1 a": "d1", "K3 b": "d2"}
    clean = sz.summary_line(0)
    assert sz.judge("memcheck", "builtin", 0, clean, _payload(plain),
                    plain) == []
    bad = {
        "an error": ("memcheck", 0, sz.summary_line(1), _payload(plain)),
        "no summary": ("racecheck", 0, "", _payload(plain)),
        "a timeout": ("synccheck", None, clean, _payload(plain)),
        "a child's exit": ("initcheck", 1, clean, _payload(plain)),
        "no results": ("initcheck", 0, clean, None),
        "a launch unlike its plain version": (
            "initcheck", 0, clean, _payload(plain, digests={
                "K1 a": "d1", "K3 b": "other"})),
        "a kernel never launched": (
            "racecheck", 0, clean, _payload(plain, launches={
                **dict.fromkeys(sz.LAUNCH_KEYS, 3), "band_ext": 0},
                checked_launches=3 * len(sz.LAUNCH_KEYS) - 3)),
        "unchecked launches": ("racecheck", 0, clean,
                               _payload(plain, checked_launches=14)),
        "a CLI difference": ("memcheck", 0, clean, _payload(
            plain, cli={"chainNet -rescore (pair)": "rc 0, differs"})),
        "jax loaded": ("memcheck", 0, clean, _payload(plain,
                                                      foreign=["jax"])),
        "a launch whose bits change": ("racecheck", 0, clean, _payload(
            plain, unstable=["K2 int32 sums, edge"])),
        "the child raised": ("racecheck", 1, clean, _payload(
            plain, error="Traceback ...\nRuntimeError: boom\n")),
        "a refused card": ("memcheck", 9, "========= Error: Device not "
                           "supported.\n" + sz.summary_line(3),
                           _payload(plain)),
    }
    for what, (tool, rc, text, payload) in bad.items():
        assert sz.judge(tool, "builtin", rc, text, payload, plain), what


def test_missing_compute_sanitizer_fails(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(sz, "CUDA_HOMES", ())
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        sz.find_compute_sanitizer()
    with pytest.raises(FileNotFoundError):
        sz.child_command("memcheck", "compute-sanitizer", "cuda", "/r.json")
    with pytest.raises(FileNotFoundError):
        sz.run_cuda("compute-sanitizer")
    assert sz.main(["cuda"]) == 1
    assert "compute-sanitizer not found" in capsys.readouterr().err


def test_tsan_build_names_the_ports_native_sources(tmp_path):
    so = str(tmp_path / "libgatnative.so")
    cmd = sz.tsan_build_command(so)
    srcs = [a for a in cmd if a.endswith(".cpp")]
    port = sorted(glob.glob(os.path.join(PKG, "native", "*.cpp")))
    assert srcs == port and len(port) >= 10
    assert all(os.sep + "genomealignmenttools_tpu_torch" + os.sep in s
               for s in srcs)
    assert cmd[:1] == ["g++"] and cmd[cmd.index("-o") + 1] == so
    for flag in ("-O1", "-g", "-fPIC", "-shared", "-std=c++17", "-pthread",
                 "-fsanitize=thread"):
        assert flag in cmd
    env = sz.tsan_env(so, {})
    assert env["GAT_NATIVE_SO"] == so and env["GAT_THREADS"] == "8"
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["GAT_RESCORE"] == "hostnative"
    assert os.path.basename(env["LD_PRELOAD"]).startswith("libtsan")


def _storage_holds_aligned_span(x: torch.Tensor) -> bool:
    st = x.untyped_storage()
    lo = x.data_ptr() // wr.ALIGN * wr.ALIGN
    hi = -(-(x.data_ptr() + x.numel()) // wr.ALIGN) * wr.ALIGN
    return st.data_ptr() <= lo and hi <= st.data_ptr() + st.nbytes()


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 70_001])
def test_upload_codes_pads_the_storage_with_n(n):
    codes = (np.arange(n) % 5).astype(np.uint8)
    x = wr.upload_codes(codes, CPU)
    assert x.numel() == n and np.array_equal(x.numpy(), codes)
    assert x.untyped_storage().nbytes() == -(-n // 16) * 16
    st = x.untyped_storage()
    whole = torch.empty(0, dtype=torch.uint8).set_(st, 0, (st.nbytes(),))
    assert bool((whole[n:] == wr.N_CODE).all())
    assert _storage_holds_aligned_span(x)
    assert wr.padded_codes(x) is x
    if n > 3:                       # a view off the storage's start
        view = x[3:]
        assert wr.padded_codes(view) is view


@pytest.mark.parametrize("n", [1, 17, 33])
def test_padded_codes_copies_only_an_unpadded_storage(n):
    x = torch.from_numpy((np.arange(n) % 5).astype(np.uint8))
    assert not _storage_holds_aligned_span(x)
    y = wr.padded_codes(x)
    assert y.data_ptr() != x.data_ptr() and torch.equal(x, y)
    assert _storage_holds_aligned_span(y)


def test_genome_producers_give_padded_storage():
    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    genome = Genome(os.path.join(fix, "target.2bit"))
    name = genome.names()[0]
    for strand in "+-":
        x = TorchGenomeCache(genome, CPU).codes(name, strand)
        assert _storage_holds_aligned_span(x)
        assert np.array_equal(x.numpy(), genome.codes(name, strand))
    codes = np.arange(1001, dtype=np.uint8) % 4
    x = ShardedBlockScorer(score_scheme_default().lut,
                           mesh=["cpu"]).put_genome(codes, CPU)
    assert _storage_holds_aligned_span(x)
    assert np.array_equal(x.numpy(), codes)


def test_tail_case_through_k1s_wrapper_on_cpu():
    """The case that reached K1's loads past a genome's end: every length
    1..48, chunks of every length ending at the last byte of both genomes,
    equal to the definition."""
    for n in TAIL_LENGTHS:
        t, q, t_off, q_off, length = tail_case(n)
        assert t_off[-2] + length[-2] == t.shape[0]
        assert q_off[-2] + length[-2] == q.shape[0]
        got = wr.chunk_sums(*[torch.from_numpy(a) for a in (t, q)], LUT,
                            *[torch.from_numpy(a)
                              for a in (t_off, q_off, length)])
        assert np.array_equal(got.numpy().astype(np.int64),
                              direct_sums(t, q, LUT.numpy(), t_off, q_off,
                                          length))
