"""Port twins of the reference's codec and unit tests: tests/test_formats.py,
test_gapcalc.py, test_native_codec.py, and the module-level tests of
test_chain_bridge.py (band_ext), test_axt_chain_parity.py (native chain
blocks), test_chain_net_parity.py (net round trip), test_converters_parity.py
(hierarchical chainMergeSort) and test_drivers.py (the axt identity filter).

Each test feeds the reference test's inputs to the port's module at the
same relative path (genomealignmenttools_tpu_torch.formats, .utils,
.native, .ops, .engines) and checks what the reference test checks, against
the same fixture or golden where it has one; each is named after the
reference test it mirrors.  These modules touch no device.
"""

import io
import os

import numpy as np
import pytest

from genomealignmenttools_tpu_torch.formats.chain import (Chain, read_chains,
                                                          write_chains)
from genomealignmenttools_tpu_torch.formats.gapcalc import (
    gap_calc_default, gap_calc_from_file, gap_calc_original)
from genomealignmenttools_tpu_torch.formats.scorematrix import (
    read_score_scheme, score_scheme_default)
from genomealignmenttools_tpu_torch.formats.twobit import (TwoBitFile,
                                                           pack_sequence,
                                                           write_twobit)
from genomealignmenttools_tpu_torch.native import chain_io, get_lib
from genomealignmenttools_tpu_torch.utils.kenthash import (KentHash,
                                                           kent_hash_string)


@pytest.fixture(scope="module")
def native_lib():
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable")
    return lib


# --- tests/test_formats.py ---------------------------------------------------

def test_formats_chain_roundtrip(fixtures_dir, tmp_path):
    src = os.path.join(fixtures_dir, "synthetic.chain")
    out = tmp_path / "rt.chain"
    write_chains(read_chains(src), str(out))
    assert out.read_bytes() == open(src, "rb").read()


def test_formats_chain_subset_on_t():
    blocks = np.array([[100, 200, 0, 100], [300, 400, 150, 250],
                       [500, 600, 300, 400]], dtype=np.int64)
    c = Chain(score=1000.0, t_name="t", t_size=1000, t_start=100, t_end=600,
              q_name="q", q_size=500, q_strand="+", q_start=0, q_end=400,
              id=7, blocks=blocks)
    sub = c.subset_on_t(250, 550)
    assert sub.n_blocks == 2
    assert list(sub.blocks[0]) == [300, 400, 150, 250]
    assert list(sub.blocks[1]) == [500, 550, 300, 350]
    assert sub.score == (550 - 300) / (600 - 100) * 1000.0
    assert c.subset_on_t(0, 1000) is c
    sub2 = c.subset_on_t(150, 350)
    assert list(sub2.blocks[0]) == [150, 200, 50, 100]
    assert list(sub2.blocks[1]) == [300, 350, 150, 200]


def test_formats_chain_swap_minus_strand():
    blocks = np.array([[100, 150, 10, 60], [200, 260, 80, 140]],
                      dtype=np.int64)
    c = Chain(score=5.0, t_name="t", t_size=1000, t_start=100, t_end=260,
              q_name="q", q_size=500, q_strand="-", q_start=10, q_end=140,
              id=1, blocks=blocks)
    s = c.swapped()
    assert s.t_name == "q" and s.q_name == "t"
    s2 = s.swapped()
    assert np.array_equal(s2.blocks, c.blocks)
    assert (s2.t_start, s2.t_end, s2.q_start, s2.q_end) == (
        c.t_start, c.t_end, c.q_start, c.q_end)


def test_formats_twobit_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    bases = np.frombuffer(b"ACGTacgt", dtype=np.uint8)
    seq = bases[rng.integers(0, 8, 10_001)].copy()
    seq[100:200] = ord("N")
    seq[5000:5100] = ord("n")
    raw = seq.tobytes()
    path = str(tmp_path / "t.2bit")
    write_twobit(path, [("chrX", raw)])
    s = TwoBitFile(path).read_seq("chrX")
    assert s.size == 10_001
    assert s.chars(do_mask=True) == raw
    assert s.chars(95, 205) == raw[95:205]


def test_formats_twobit_reads_reference_fixture():
    # the file the reference's test reads (test_formats.py:83-95), in the
    # reference's source tree that test_axt_chain_parity.py names
    from test_axt_chain_parity import REF_SRC
    p = os.path.join(REF_SRC, "input", "hg19.chrM.2bit")
    if not os.path.exists(p):
        pytest.skip("reference axtChain test input unavailable")
    tbf = TwoBitFile(p)
    assert tbf.seq_names() == ["hg19_chrM"]
    s = tbf.read_seq("hg19_chrM")
    assert s.size == 16571
    chars = s.chars()
    assert len(chars) == s.size
    assert set(chars) <= set(b"ACGTNacgtn")


def test_formats_score_scheme_default_matrix():
    ss = score_scheme_default()
    m = ss.char_matrix()
    assert m[ord("a"), ord("a")] == 91
    assert m[ord("A"), ord("a")] == 91
    assert m[ord("c"), ord("G")] == -125
    assert m[ord("n"), ord("a")] == 0
    assert m[ord("N"), ord("T")] == 0
    assert ss.gap_open == 400 and ss.gap_extend == 30


def test_formats_score_scheme_read_hoxd55(fixtures_dir):
    ss = read_score_scheme(os.path.join(fixtures_dir, "HoxD55.q"))
    m = ss.char_matrix()
    assert m[ord("a"), ord("a")] == 91
    assert m[ord("a"), ord("c")] == -90
    assert m[ord("t"), ord("g")] == -90
    assert ss.gap_open == 400 and ss.gap_extend == 30


def test_formats_kent_hash_string():
    assert kent_hash_string("") == 0
    assert kent_hash_string("a") == ord("a")
    assert kent_hash_string("ab") == (ord("a") * 9 + ord("b"))


def test_formats_kent_hash_orders():
    h = KentHash()
    for name in ["3", "17", "4097", "99", "17"]:
        h.add(name, name)
    trav = [n for n, _ in h.traverse_order()]
    ell = [n for n, _ in h.el_list_order()]
    assert ell == list(reversed(trav))
    assert trav.count("17") == 2


def test_formats_pack_sequence_runs():
    _, nb, mb = pack_sequence(b"ACGTnnNNacgt")
    assert nb.tolist() == [[4, 8]]
    assert mb.tolist() == [[4, 6], [8, 12]]


def test_formats_twobit_native_decode_matches_python(native_lib,
                                                     fixtures_dir):
    """The port's native/twobitdec.cpp against the python LUT decode."""
    import genomealignmenttools_tpu_torch.formats.twobit as tb
    tbf = TwoBitFile(os.path.join(fixtures_dir, "target.2bit"))
    rng = np.random.default_rng(3)
    for name in tbf.seq_names():
        seq = tbf.read_seq(name)
        for _ in range(8):
            a, b = sorted(rng.integers(0, seq.size, 2).tolist())
            if a == b:
                b = min(a + 1, seq.size)
            native = seq.codes(a, b)
            chunk = seq.packed[a // 4:(b + 3) // 4]
            py = tb._DECODE_LUT[chunk].reshape(-1)[a - (a // 4) * 4:][
                :b - a].copy()
            for s, e in seq.n_blocks:
                s2, e2 = max(int(s), a), min(int(e), b)
                if s2 < e2:
                    py[s2 - a:e2 - a] = 4
            assert np.array_equal(native, py), (name, a, b)


# --- tests/test_gapcalc.py ---------------------------------------------------

def test_gapcalc_loose_small_values():
    gc = gap_calc_default()
    assert [gc.cost(1, 0), gc.cost(2, 0), gc.cost(3, 0)] == [325, 360, 400]
    assert gc.cost(0, 1) == 325
    assert gc.cost(1, 1) == 660
    assert gc.cost(0, 0) == 0


def test_gapcalc_interpolation_truncation():
    gc = gap_calc_default()
    assert gc.cost(4, 0) == 400 + int(50 * 1 / 8)
    assert gc.cost(7, 0) == 400 + 25
    assert gc.cost(10, 0) == 400 + int(50 * 7 / 8)


def test_gapcalc_extrapolation_beyond_last():
    gc = gap_calc_default()
    assert gc.cost(252111, 0) == 56600
    assert gc.cost(252115, 0) == 56601
    assert gc.cost(1_000_000, 0) == int(56600 + 0.25 * (1_000_000 - 252111))


def test_gapcalc_medium_differs():
    gc = gap_calc_original()
    assert gc.cost(1, 0) == 350
    assert gc.cost(1, 1) == 825


def test_gapcalc_vectorized_matches_scalar():
    gc = gap_calc_default()
    rng = np.random.default_rng(0)
    dq = rng.integers(0, 500_000, 4000)
    dt = rng.integers(0, 500_000, 4000)
    dq[::3] = 0
    dt[1::3] = 0
    vec = gc.cost_vec(dq, dt)
    for i in range(0, 4000, 37):
        assert vec[i] == gc.cost(int(dq[i]), int(dt[i])), (dq[i], dt[i])


def test_gapcalc_file_roundtrip(tmp_path):
    p = tmp_path / "gap.txt"
    p.write_text(
        "tablesize 11\n"
        "smallSize 111\n"
        "position 1 2 3 11 111 2111 12111 32111 72111 152111 252111\n"
        "qGap 325 360 400 450 600 1100 3600 7600 15600 31600 56600\n"
        "tGap 325 360 400 450 600 1100 3600 7600 15600 31600 56600\n"
        "bothGap 625 660 700 750 900 1400 4000 8000 16000 32000 57000\n")
    gc = gap_calc_from_file(str(p))
    ref = gap_calc_default()
    for dq, dt in [(0, 5), (7, 0), (3, 9), (100000, 0), (12345, 54321)]:
        assert gc.cost(dq, dt) == ref.cost(dq, dt)


# --- tests/test_native_codec.py ---------------------------------------------

def test_native_codec_parse_matches_python(native_lib, fixtures_dir):
    from genomealignmenttools_tpu_torch.formats import chain as cf
    data = open(os.path.join(fixtures_dir, "synthetic.chain"), "rb").read()
    native = chain_io.parse_chain_text(data)
    py = cf._read_chains_stream(io.StringIO(data.decode()))
    assert len(native) == len(py)
    for a, b in zip(native, py):
        assert a.header_line() == b.header_line()
        assert np.array_equal(a.blocks, b.blocks)


def test_native_codec_serialize_matches_python(native_lib, fixtures_dir):
    from genomealignmenttools_tpu_torch.formats import chain as cf
    data = open(os.path.join(fixtures_dir, "synthetic.chain"), "rb").read()
    py = cf._read_chains_stream(io.StringIO(data.decode()))
    blob = chain_io.serialize_chains(py)
    assert blob == "".join(c.to_text() for c in py).encode()
    assert blob == data


def test_native_codec_parse_error_reporting(native_lib):
    with pytest.raises(ValueError):
        chain_io.parse_chain_text(
            b"chain notascore chrA x + 0 1 q 5 + 0 1 1\n1\n")


# --- module-level tests of the golden files ---------------------------------

def test_chain_bridge_band_ext_basic():
    from genomealignmenttools_tpu_torch.ops.band_ext import band_ext
    ss = score_scheme_default()
    cm = ss.char_matrix()
    ok, sa, sb, abest, bbest = band_ext(
        False, cm, ss.gap_open, ss.gap_extend, 3,
        b"acgtacgtacgt", b"acgtaacgtacgt", 1)
    assert ok
    assert sa == b"acgt-acgtacgt"
    assert sb == b"acgtaacgtacgt"
    assert (abest, bbest) == (11, 12)
    ok, sa, sb, _, _ = band_ext(
        False, cm, ss.gap_open, ss.gap_extend, 3, b"aaaa", b"tttt", 1)
    assert not ok and sa == b"" and sb == b""
    ok, sa, sb, _, _ = band_ext(
        False, cm, ss.gap_open, ss.gap_extend, 3, b"acgtacgt", b"acgtacgt",
        -1)
    assert ok and sa == b"acgtacgt" and sb == b"acgtacgt"


def test_axt_chain_chain_blocks_native_matches_python(native_lib):
    """The port's native/chainblocks.cpp against its python kd-tree DP on
    the reference test's randomised workloads."""
    from genomealignmenttools_tpu_torch.engines.chain_connect import (
        connect_cost, gap_cost)
    from genomealignmenttools_tpu_torch.engines.kd_chainer import (
        chain_blocks, chain_blocks_arrays)
    gcal = gap_calc_from_file("loose")
    lut = np.asarray(score_scheme_default().lut)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(3, 400))
        q_codes = rng.integers(0, 5, 100000).astype(np.uint8)
        t_codes = rng.integers(0, 5, 100000).astype(np.uint8)
        ts = np.sort(rng.integers(0, 90000, n))
        rows = []
        for i in range(n):
            length = int(rng.integers(0, 40))
            qs = max(0, int(ts[i] + rng.integers(-200, 200)))
            sc = int(rng.integers(-500, 4000))
            rows.append([int(ts[i]), int(ts[i]) + length, qs, qs + length,
                         sc])
        py = chain_blocks(
            "q", 100000, "+", "t", 100000, [list(r) for r in rows],
            lambda a, b: connect_cost(a, b, q_codes, t_codes, lut, gcal),
            lambda dq, dt: gap_cost(dq, dt, gcal))
        nat = chain_blocks_arrays("q", 100000, "+", "t", 100000,
                                  [list(r) for r in rows],
                                  q_codes, t_codes, lut, gcal)
        assert len(py) == len(nat), seed
        for a, b in zip(py, nat):
            assert a.score == b.score, seed
            assert [r[:4] for r in a._rows] == \
                [list(r)[:4] for r in b._rows], seed


def test_chain_net_net_read_write_roundtrip(golden_dir):
    from genomealignmenttools_tpu_torch.formats.net import (read_nets,
                                                            write_nets)
    src = os.path.join(golden_dir, "chainNet.target.net")
    out = io.StringIO()
    write_nets(read_nets(src), out)
    assert out.getvalue() == open(src).read()


def test_converters_chain_merge_sort_hierarchical(fixtures_dir, tmp_path,
                                                  monkeypatch):
    """More inputs than MERGE_MAX_FILES take the temp-file hierarchy
    (chainMergeSort.c:130-197) and give the flat merge's bytes."""
    from genomealignmenttools_tpu_torch.engines import chain_tools
    chains = read_chains(os.path.join(fixtures_dir,
                                      "synthetic.scored.sorted.chain"))
    files = []
    for i, c in enumerate(chains):
        p = str(tmp_path / f"c{i:04d}.chain")
        with open(p, "w") as fh:
            fh.write(c.to_text())
        files.append(p)
    flat = io.StringIO()
    chain_tools.chain_merge_sort(files, flat)
    monkeypatch.setattr(chain_tools, "MERGE_MAX_FILES", 5)
    hier = io.StringIO()
    chain_tools.chain_merge_sort(files, hier, temp_dir=str(tmp_path))
    assert hier.getvalue() == flat.getvalue()


def test_drivers_check_axt_entry_identity():
    from genomealignmenttools_tpu_torch.engines.drivers import \
        _check_axt_entry
    t = "ACGTACGTACGT"
    assert _check_axt_entry(t, t, 100, 0.0, 10)
    assert not _check_axt_entry(t, "TGCATGCATGCA", 50, 0.0, 10)
    t3 = "AAAAAAAAAAAA"
    assert not _check_axt_entry(t3, t3, 90, 1.0, 10)
    assert _check_axt_entry(t3, t3, 90, 0.0, 10)
    q4 = "ACGTACGTTGCA"
    assert _check_axt_entry(t, q4, 60, 0.0, 10)
    assert not _check_axt_entry(t, q4, 90, 0.0, 10)


def test_drivers_filter_axt_identity_entropy_roundtrip():
    from genomealignmenttools_tpu_torch.engines.drivers import \
        filter_axt_identity_entropy
    from genomealignmenttools_tpu_torch.formats.axt import Axt
    axts = [
        Axt(q_name="q", q_start=0, q_end=12, q_strand="+", t_name="t",
            t_start=0, t_end=12, score=100,
            q_sym="ACGTACGTACGT", t_sym="ACGTACGTACGT"),
        Axt(q_name="q", q_start=20, q_end=32, q_strand="+", t_name="t",
            t_start=20, t_end=32, score=50,
            q_sym="TGCATGCATGCA", t_sym="ACGTACGTACGT"),
    ]
    out = io.StringIO()
    filter_axt_identity_entropy(axts, 90, 1.0, 10, out)
    assert "ACGTACGTACGT" in out.getvalue()
    assert "TGCATGCATGCA" not in out.getvalue()
