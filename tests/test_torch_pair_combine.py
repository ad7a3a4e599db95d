"""K2's plain versions and the staged oracle (ops/pair_combine.py,
ops/pair_rescore.py) against the JAX Pallas combine.

The same numpy-seeded chunk arrays (tests/combine_cases.py: random chains as
tests/test_pallas_combine.py makes them, and the carry's edge cases) go
through the JAX `pair_combine_scan(..., interpret=True)` +
`pair_combine_finish`, through the port's `pair_combine_scan_plain` at tile
sizes 1, 7, 64, 2048 (the CUDA kernel's) and 32768 (the Pallas kernel's),
and through `pair_chain_scores_plain`; and, as int8 score tiles whose rows
sum to the same s (combine_cases.score_tiles), through
`pair_combine_scan_tiles_plain` at widths 128, 130 and 258.  The two other
row sources, combined-code and 4-bit tiles of the same bases
(combine_cases.code_tiles, nibble_tiles), go through the port's plain
version and the JAX package's one-dispatch pass (`_fused_pass` with
pack_lut's packed LUT, and with `scored4=True` and vals_packed;
`_fused_pass_chained` for the tweak), the Pallas combine in interpret mode,
at chunks 2, 6, 128, 130 and 258.  Integer math: every comparison is exact
(tolerance 0).  The int8 tile path against the JAX package's `_fused_pass`
is in tests/test_torch_pair_rescore.py; the CUDA kernel itself is held
against the plain versions on a card, in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

from combine_cases import (WIDE_LUT, code_tiles, combine_case, edge_chains,
                           nibble_tiles, random_chains, score_tiles,
                           scored_tiles)
from genomealignmenttools_tpu.ops import pallas_combine as jax_combine
from genomealignmenttools_tpu_torch import _build
from genomealignmenttools_tpu_torch.device import PERF
from genomealignmenttools_tpu_torch.ops import pair_combine as pc
from genomealignmenttools_tpu_torch.ops.pair_rescore import (
    pack_vals16, pair_chain_scores_plain, vals16_of)

CASES = {
    "random-7": (0, 7),
    "random-64": (1, 64),
    "random-200": (2, 200),
    "random-800": (3, 800),      # ~4 Pallas tiles: chains cross tiles
    "edge": None,                # edge_chains at the Pallas tile
    "multi-tile-chain": None,    # one chain over 3 Pallas tiles
}
TILES = [1, 7, 64, pc.TILE, jax_combine.TILE]


def _case(name):
    """Inputs padded to the Pallas tile, so that both sides see the same
    arrays, pad chunks included."""
    if name == "multi-tile-chain":
        # test_pallas_combine.py:127-147: blocks of 7 chunks end to end
        rng = np.random.default_rng(3)
        n = 3 * jax_combine.TILE
        s = rng.integers(-500, 16001, n).astype(np.int32)
        bias = np.zeros(n, np.int32)
        flags = np.zeros(n, np.int32)
        flags[0] |= pc.F_START
        for i in range(0, n, 7):
            flags[i] |= pc.F_FIRST
            if i > 0:
                bias[i] = int(rng.integers(0, 30000))
            flags[min(i + 6, n - 1)] |= pc.F_SAMPLE
        return s, bias, flags, np.array([0]), np.array([n - 1]), n
    if name == "edge":
        rng = np.random.default_rng(4)
        return combine_case(rng, *edge_chains(jax_combine.TILE),
                            pad_to=jax_combine.TILE)
    seed, n_chains = CASES[name]
    rng = np.random.default_rng(seed)
    return combine_case(rng, *random_chains(rng, n_chains),
                        pad_to=jax_combine.TILE)


@pytest.fixture(scope="module")
def reference():
    """Per case: the inputs and the JAX kernel's c, w and finish."""
    import jax.numpy as jnp
    out = {}
    for name in CASES:
        s, bias, flags, start_idx, end_idx, m = _case(name)
        c, w = jax_combine.pair_combine_scan(
            jnp.asarray(s), jnp.asarray(bias), jnp.asarray(flags),
            interpret=True)
        fin = jax_combine.pair_combine_finish(c, w, jnp.asarray(end_idx))
        out[name] = ((s, bias, flags, start_idx, end_idx, m),
                     np.asarray(c), np.asarray(w), np.asarray(fin))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_scan_matches_pallas_kernel(reference, name, tile):
    (s, bias, flags, _, end_idx, _), c_j, w_j, fin_j = reference[name]
    c, w = pc.pair_combine_scan_plain(_t(s), _t(bias), _t(flags), tile=tile)
    assert c.dtype == w.dtype == torch.int32
    assert np.array_equal(c.numpy(), c_j)
    assert np.array_equal(w.numpy(), w_j)
    fin = pc.pair_combine_finish(c, w, _t(end_idx))
    assert fin.dtype == torch.int32
    assert np.array_equal(fin.numpy(), fin_j)


@pytest.mark.parametrize("name", list(CASES))
def test_staged_oracle_matches_pallas_kernel(reference, name):
    (s, bias, flags, start_idx, end_idx, _), _, _, fin_j = reference[name]
    got = pair_chain_scores_plain(_t(s), _t(bias), _t(flags), _t(start_idx),
                                  _t(end_idx))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), fin_j.astype(np.int64))


def test_edge_case_shape():
    """edge_chains has what its docstring promises, at K2's tile."""
    nb, nc = edge_chains(pc.TILE)
    s, _, flags, start_idx, end_idx, m = combine_case(
        np.random.default_rng(0), nb, nc, pad_to=pc.TILE)
    lengths = end_idx - start_idx + 1
    assert (lengths[:3] == 1).all()
    assert lengths[3] > 3 * pc.TILE
    assert end_idx[4] % pc.TILE == pc.TILE - 1
    assert s.shape[0] % pc.TILE == 0 and s.shape[0] > m
    assert not flags[m:].any()


def test_wrapper_runs_plain_version_on_cpu(reference, monkeypatch):
    """On CPU tensors pair_combine_scan never reaches the CUDA build."""
    def no_build():
        raise AssertionError("the CUDA library was asked for on the CPU")
    monkeypatch.setattr(_build, "load_library", no_build)
    (s, bias, flags, _, end_idx, _), c_j, w_j, _ = reference["random-800"]
    before = PERF["dispatches"]
    c, w = pc.pair_combine_scan(_t(s), _t(bias), _t(flags))
    assert PERF["dispatches"] == before + 1
    assert np.array_equal(c.numpy(), c_j) and np.array_equal(w.numpy(), w_j)


def test_unpadded_and_empty_inputs():
    """Any length: the plain version pads its last tile itself."""
    rng = np.random.default_rng(9)
    s, bias, flags, start_idx, end_idx, m = combine_case(
        rng, *random_chains(rng, 30))
    assert s.shape[0] == m
    c, w = pc.pair_combine_scan(_t(s), _t(bias), _t(flags))
    got = pc.pair_combine_finish(c, w, _t(end_idx)).numpy()
    want = pair_chain_scores_plain(_t(s), _t(bias), _t(flags), _t(start_idx),
                                   _t(end_idx)).numpy()
    assert np.array_equal(got, want)
    empty = torch.zeros(0, dtype=torch.int32)
    c, w = pc.pair_combine_scan(empty, empty, empty)
    assert c.numel() == w.numel() == 0


def _args():
    z = torch.zeros(8, dtype=torch.int32)
    return {"s": z.clone(), "bias": z.clone(), "flags": z.clone()}


@pytest.mark.parametrize("change,exc", [
    (lambda a: a.update(s=a["s"].to(torch.int64)), TypeError),
    (lambda a: a.update(flags=a["flags"].to(torch.int16)), TypeError),
    (lambda a: a.update(bias=a["bias"][:5]), ValueError),
    (lambda a: a.update(s=a["s"].reshape(2, 4)), ValueError),
    (lambda a: a.update(s=torch.zeros(16, dtype=torch.int32)[::2]),
     ValueError),
    (lambda a: a.update(bias=a["bias"].to("meta")), ValueError),
    (lambda a: a.update(s=a["s"].to("meta"), bias=a["bias"].to("meta"),
                        flags=a["flags"].to("meta")), ValueError),
], ids=["s-dtype", "flags-dtype", "lengths-differ", "2d", "strided",
        "mixed-device", "unsupported-device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, exc):
    a = _args()
    change(a)
    with pytest.raises(exc):
        pc.pair_combine_scan(**a)


def test_plain_scan_refuses_bad_tile():
    a = _args()
    with pytest.raises(ValueError):
        pc.pair_combine_scan_plain(**a, tile=0)


WIDE = [128, 130, 258]   # tile widths that hold every case's s unclipped


@pytest.mark.parametrize("chunk", WIDE)
@pytest.mark.parametrize("name", ["random-64", "edge", "multi-tile-chain"])
def test_tiles_plain_matches_pallas_kernel(reference, name, chunk):
    """Tiles whose rows sum to the case's s give the JAX kernel's c, w and
    finish, at K2's tile and at a tiny one."""
    (s, bias, flags, _, end_idx, _), c_j, w_j, fin_j = reference[name]
    tiles = _t(score_tiles(np.random.default_rng(chunk), s, chunk))
    assert np.array_equal(tiles.sum(1, dtype=torch.int32).numpy(), s)
    for tile in (pc.TILE, 7):
        c, w = pc.pair_combine_scan_tiles_plain(tiles, _t(bias), _t(flags),
                                                tile=tile)
        assert c.dtype == w.dtype == torch.int32
        assert np.array_equal(c.numpy(), c_j)
        assert np.array_equal(w.numpy(), w_j)
    fin = pc.pair_combine_finish(c, w, _t(end_idx))
    assert np.array_equal(fin.numpy(), fin_j)


@pytest.mark.parametrize("tweak", [1, -3, 2 ** 31 - 1])
def test_tiles_plain_adds_the_tweak_to_every_row(tweak):
    """s = row sum + tweak on every row, pad rows included, wrapping in
    int32 as the reference's `s + tweak` does."""
    rng = np.random.default_rng(11)
    s, bias, flags, _, _, _ = combine_case(rng, *random_chains(rng, 40),
                                           pad_to=pc.TILE)
    tiles = _t(score_tiles(rng, s, 128))
    tw = torch.tensor(tweak, dtype=torch.int32)
    got = pc.pair_combine_scan_tiles(tiles, _t(bias), _t(flags), tw)
    s_tw = (_t(s) + tw).to(torch.int32)
    want = pc.pair_combine_scan_plain(s_tw, _t(bias), _t(flags))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    one = pc.pair_combine_scan_tiles(tiles, _t(bias), _t(flags),
                                     tw.reshape(1))
    assert all(torch.equal(a, b) for a, b in zip(one, want))


def test_tiles_wrapper_runs_plain_version_on_cpu(reference, monkeypatch):
    """On CPU tensors pair_combine_scan_tiles never reaches the CUDA build;
    it counts one dispatch and no launch."""
    from genomealignmenttools_tpu_torch.device import LAUNCHES

    def no_build():
        raise AssertionError("the CUDA library was asked for on the CPU")
    monkeypatch.setattr(_build, "load_library", no_build)
    (s, bias, flags, _, _, _), c_j, w_j, _ = reference["random-800"]
    tiles = _t(score_tiles(np.random.default_rng(5), s, 130))
    before, launches = PERF["dispatches"], LAUNCHES["pair_combine"]
    c, w = pc.pair_combine_scan_tiles(tiles, _t(bias), _t(flags))
    assert PERF["dispatches"] == before + 1
    assert LAUNCHES["pair_combine"] == launches
    assert np.array_equal(c.numpy(), c_j) and np.array_equal(w.numpy(), w_j)


@pytest.mark.parametrize("chunk", [2, 6])
def test_narrow_tiles_plain_matches_scan_of_row_sums(chunk):
    """Rows of 2 and 6 bytes hold sums in [-128 * chunk, 127 * chunk]: the
    case's s clipped to that, unpadded, through both plain versions."""
    rng = np.random.default_rng(chunk)
    s, bias, flags, start_idx, end_idx, m = combine_case(
        rng, *random_chains(rng, 300))
    s = np.clip(s, -128 * chunk, 127 * chunk).astype(np.int32)
    tiles = _t(score_tiles(rng, s, chunk))
    c, w = pc.pair_combine_scan_tiles(tiles, _t(bias), _t(flags))
    c_s, w_s = pc.pair_combine_scan_plain(_t(s), _t(bias), _t(flags))
    assert torch.equal(c, c_s) and torch.equal(w, w_s)
    got = pc.pair_combine_finish(c, w, _t(end_idx)).to(torch.int64)
    want = pair_chain_scores_plain(_t(s), _t(bias), _t(flags), _t(start_idx),
                                   _t(end_idx))
    assert torch.equal(got, want)


def test_tiles_empty_input():
    empty = torch.zeros(0, dtype=torch.int32)
    c, w = pc.pair_combine_scan_tiles(torch.zeros((0, 128), dtype=torch.int8),
                                      empty, empty)
    assert c.numel() == w.numel() == 0


def _tile_args():
    z = torch.zeros(8, dtype=torch.int32)
    return {"tiles": torch.zeros((8, 128), dtype=torch.int8),
            "bias": z.clone(), "flags": z.clone(), "tweak": None}


def _misaligned():
    flat = torch.zeros(8 * 128 + 16, dtype=torch.int8)
    off = (-flat.data_ptr()) % 16 + 2
    return flat[off:off + 8 * 128].view(8, 128)


@pytest.mark.parametrize("change,exc", [
    (lambda a: a.update(tiles=a["tiles"].to(torch.uint8)), TypeError),
    (lambda a: a.update(tiles=a["tiles"].reshape(-1)), ValueError),
    (lambda a: a.update(tiles=torch.zeros((8, 256), dtype=torch.int8)[:, ::2]),
     ValueError),
    (lambda a: a.update(tiles=a["tiles"][:7]), ValueError),
    (lambda a: a.update(tiles=torch.zeros((8, 127), dtype=torch.int8)),
     ValueError),
    (lambda a: a.update(tiles=torch.zeros((8, 260), dtype=torch.int8)),
     ValueError),
    (lambda a: a.update(tiles=torch.zeros((8, 0), dtype=torch.int8)),
     ValueError),
    (lambda a: a.update(tiles=_misaligned()), ValueError),
    (lambda a: a.update(flags=a["flags"].to(torch.int64)), TypeError),
    (lambda a: a.update(bias=a["bias"][:5]), ValueError),
    (lambda a: a.update(tiles=a["tiles"].to("meta")), ValueError),
    (lambda a: a.update(tweak=torch.tensor(1)), TypeError),
    (lambda a: a.update(tweak=torch.ones(2, dtype=torch.int32)), TypeError),
    (lambda a: a.update(tweak=torch.ones(1, dtype=torch.int32, device="meta")),
     ValueError),
], ids=["tiles-dtype", "1d", "strided", "rows-differ", "odd-chunk",
        "chunk-260", "chunk-0", "misaligned", "flags-dtype", "lengths-differ",
        "tiles-device", "tweak-int64", "tweak-two-values", "tweak-device"])
def test_tiles_wrapper_refuses_what_the_kernel_does_not_take(change, exc):
    a = _tile_args()
    change(a)
    with pytest.raises(exc):
        pc.pair_combine_scan_tiles(**a)


FORMAT_CHUNKS = [2, 6, 128, 130, 258]
IDX_LUT25, VALS_PACKED = pack_vals16(WIDE_LUT)
TABLES = {"code": torch.from_numpy(WIDE_LUT[:5, :5].reshape(25)
                                   .astype(np.int8)),
          "score4": torch.from_numpy(vals16_of(VALS_PACKED))}


def _format_case(name, chunk, kind):
    """A combine case's bias and flags with tiles of `kind` for as many rows
    (code_tiles' bases, seeded by the chunk; pad rows past m as the packer
    writes them), and the int8 score tiles of the same bases."""
    s, bias, flags, _, end_idx, m = _case(name)
    codes = code_tiles(np.random.default_rng(chunk), s.shape[0], chunk)
    codes[m:] = 24
    tiles = codes if kind == "code" else nibble_tiles(codes, IDX_LUT25)
    return tiles, scored_tiles(codes, WIDE_LUT), bias, flags, end_idx


def _jax_format_pass(kind, tiles, bias, flags, end_idx, feedback=None):
    import jax.numpy as jnp
    from genomealignmenttools_tpu.ops import pair_rescore as jax_pair
    from genomealignmenttools_tpu.ops.pallas_rescore import pack_lut
    table = pack_lut(WIDE_LUT) if kind == "code" else VALS_PACKED
    args = [jnp.asarray(a) for a in (tiles, table, bias, flags, end_idx)]
    if feedback is None:
        out = jax_pair._fused_pass(*args, interpret=True,
                                   scored4=kind == "score4")
    else:
        out = jax_pair._fused_pass_chained(*args, jnp.asarray(feedback),
                                           interpret=True,
                                           scored4=kind == "score4")
    return np.asarray(out)


def _port_format_pass(kind, tiles, bias, flags, end_idx, tweak=None):
    c, w = pc.pair_combine_scan_tiles(_t(tiles), _t(bias), _t(flags), tweak,
                                      kind, TABLES[kind])
    return pc.pair_combine_finish(c, w, _t(end_idx)).numpy()


def test_vals16_of_unpacks_pack_vals16():
    from genomealignmenttools_tpu.ops import pair_rescore as jax_pair
    idx, packed = jax_pair.pack_vals16(WIDE_LUT)
    assert np.array_equal(idx, IDX_LUT25)
    assert np.array_equal(packed, VALS_PACKED)
    vals = vals16_of(packed)
    assert vals.dtype == np.int8 and vals[0] == 0
    assert sorted(vals.tolist()) == sorted(
        set(WIDE_LUT[:5, :5].reshape(-1).tolist()))
    assert np.array_equal(vals[idx].reshape(5, 5), WIDE_LUT[:5, :5])


@pytest.mark.parametrize("kind", ["code", "score4"])
@pytest.mark.parametrize("chunk", FORMAT_CHUNKS)
@pytest.mark.parametrize("name", ["random-200", "edge", "multi-tile-chain"])
def test_format_plain_matches_jax_fused_pass(name, chunk, kind):
    """Combined-code and 4-bit tiles through the plain version give the JAX
    package's pass over the same tiles, and the int8 tiles' pass over the
    same bases."""
    tiles, s8, bias, flags, end_idx = _format_case(name, chunk, kind)
    got = _port_format_pass(kind, tiles, bias, flags, end_idx)
    assert got.dtype == np.int32
    assert np.array_equal(got, _jax_format_pass(kind, tiles, bias, flags,
                                                end_idx))
    c, w = pc.pair_combine_scan_tiles(_t(s8), _t(bias), _t(flags))
    assert np.array_equal(got, pc.pair_combine_finish(c, w, _t(end_idx))
                          .numpy())


@pytest.mark.parametrize("kind", ["code", "score4"])
@pytest.mark.parametrize("chunk", [6, 128, 130])
def test_format_plain_tweak_matches_jax_fused_pass_chained(chunk, kind):
    """The tweak: the reference adds 1 to every row sum when its feedback
    equals INT32_MIN; the port adds the tweak it is given."""
    tiles, _, bias, flags, end_idx = _format_case("random-200", chunk, kind)
    for fb, tweak in (([-2 ** 31, 0], 1), ([5, 0], 0)):
        want = _jax_format_pass(kind, tiles, bias, flags, end_idx,
                                np.array(fb, np.int32))
        got = _port_format_pass(kind, tiles, bias, flags, end_idx,
                                torch.tensor(tweak, dtype=torch.int32))
        assert np.array_equal(got, want)
    assert not np.array_equal(
        _port_format_pass(kind, tiles, bias, flags, end_idx,
                          torch.tensor(1, dtype=torch.int32)),
        _port_format_pass(kind, tiles, bias, flags, end_idx))


def test_code_rows_score_n_and_stray_bytes_zero():
    """A code byte scores lut[q, t] only where q and t are both below 4:
    every byte value, one a row."""
    lut = np.arange(25, dtype=np.int64).reshape(5, 5) - 12
    tiles = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    tiles = torch.stack([tiles, torch.full_like(tiles, 24)], 1).contiguous()
    got = pc.tile_row_sums(tiles, "code", torch.from_numpy(
        lut.reshape(25).astype(np.int8)))
    want = [int(lut[c // 5, c % 5]) if c < 25 and c // 5 < 4 and c % 5 < 4
            else 0 for c in range(256)]
    assert got.tolist() == want


def test_score4_rows_decode_both_nibbles():
    """A nibble byte scores vals[b & 15] + vals[b >> 4]: every byte value,
    alone in a row of one byte (odd width) and twice in a row of two."""
    vals = TABLES["score4"]
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    want = [int(vals[x & 15]) + int(vals[x >> 4]) for x in range(256)]
    assert pc.tile_row_sums(b[:, None].contiguous(), "score4",
                            vals).tolist() == want
    two = torch.stack([b, b], 1).contiguous()
    assert pc.tile_row_sums(two, "score4", vals).tolist() == [
        2 * x for x in want]


def _format_args(kind, width=None):
    z = torch.zeros(8, dtype=torch.int32)
    width = width or (64 if kind == "score4" else 128)
    pad = 24 if kind == "code" else 0    # N/N, and nibble 0: score 0
    return {"tiles": torch.full((8, width), pad, dtype=torch.uint8),
            "bias": z.clone(), "flags": z.clone(), "tweak": None,
            "kind": kind, "table": TABLES[kind].clone()}


def _misaligned_u8(width):
    flat = torch.zeros(8 * width + 16, dtype=torch.uint8)
    off = (-flat.data_ptr()) % 16 + 2
    return flat[off:off + 8 * width].view(8, width)


@pytest.mark.parametrize("kind", ["code", "score4"])
@pytest.mark.parametrize("change,exc", [
    (lambda a: a.update(tiles=a["tiles"].to(torch.int8)), TypeError),
    (lambda a: a.update(tiles=a["tiles"].reshape(-1)), ValueError),
    (lambda a: a.update(tiles=a["tiles"][:7]), ValueError),
    (lambda a: a.update(tiles=_misaligned_u8(a["tiles"].shape[1])),
     ValueError),
    (lambda a: a.update(tiles=a["tiles"][:, :0]), ValueError),
    (lambda a: a.update(table=None), TypeError),
    (lambda a: a.update(table=a["table"].to(torch.int32)), TypeError),
    (lambda a: a.update(table=a["table"][:-1]), TypeError),
    (lambda a: a.update(table=a["table"].to("meta")), TypeError),
    (lambda a: a.update(kind="int8"), ValueError),
    (lambda a: a.update(tweak=torch.ones(2, dtype=torch.int32)), TypeError),
    (lambda a: a.update(tiles=a["tiles"].to("meta")), ValueError),
], ids=["tiles-int8", "1d", "rows-differ", "misaligned", "width-0",
        "no-table", "table-dtype", "table-length", "table-device",
        "unknown-kind", "tweak-two-values", "tiles-device"])
def test_format_wrapper_refuses_what_the_kernel_does_not_take(kind, change,
                                                              exc):
    a = _format_args(kind)
    change(a)
    with pytest.raises(exc):
        pc.pair_combine_scan_tiles(**a)


@pytest.mark.parametrize("kind,width,ok", [
    ("code", 2, True), ("code", 258, True), ("code", 129, False),
    ("code", 260, False), ("score4", 1, True), ("score4", 65, True),
    ("score4", 129, True), ("score4", 130, False)])
def test_format_wrapper_widths(kind, width, ok):
    """Code rows take K2's even widths 2..258; 4-bit rows any width from 1
    to 129 bytes (chunk // 2 under GAT_PAIR_CHUNK), odd ones included."""
    a = _format_args(kind, width)
    if ok:
        c, w = pc.pair_combine_scan_tiles(**a)
        assert c.tolist() == [0] * 8
    else:
        with pytest.raises(ValueError, match="width"):
            pc.pair_combine_scan_tiles(**a)


def test_score8_takes_no_table():
    a = _tile_args()
    with pytest.raises(ValueError, match="no table"):
        pc.pair_combine_scan_tiles(**a, table=TABLES["code"])


@pytest.mark.parametrize("kind", ["code", "score4"])
def test_format_wrapper_runs_plain_version_on_cpu(kind, monkeypatch):
    """On CPU tensors the format's wrapper never reaches the CUDA build; it
    counts one dispatch and no launch under any key."""
    from genomealignmenttools_tpu_torch.device import LAUNCHES

    def no_build():
        raise AssertionError("the CUDA library was asked for on the CPU")
    monkeypatch.setattr(_build, "load_library", no_build)
    tiles, s8, bias, flags, end_idx = _format_case("random-64", 128, kind)
    before, launches = PERF["dispatches"], dict(LAUNCHES)
    got = _port_format_pass(kind, tiles, bias, flags, end_idx)
    assert PERF["dispatches"] == before + 1 and LAUNCHES == launches
    c, w = pc.pair_combine_scan_tiles_plain(_t(s8), _t(bias), _t(flags))
    assert np.array_equal(got, pc.pair_combine_finish(c, w, _t(end_idx))
                          .numpy())
