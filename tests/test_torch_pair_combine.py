"""K2's plain version and the staged oracle (ops/pair_combine.py,
ops/pair_rescore.py) against the JAX Pallas combine.

The same numpy-seeded chunk arrays (tests/combine_cases.py: random chains as
tests/test_pallas_combine.py makes them, and the carry's edge cases) go
through the JAX `pair_combine_scan(..., interpret=True)` +
`pair_combine_finish`, through the port's `pair_combine_scan_plain` at tile
sizes 1, 7, 64, 1024 (the CUDA kernel's) and 32768 (the Pallas kernel's),
and through `pair_chain_scores_plain`.  Integer math: every comparison is
exact (tolerance 0).  The CUDA kernel itself is held against the plain
version on a card, in tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

from combine_cases import combine_case, edge_chains, random_chains
from genomealignmenttools_tpu.ops import pallas_combine as jax_combine
from genomealignmenttools_tpu_torch import _build
from genomealignmenttools_tpu_torch.device import PERF
from genomealignmenttools_tpu_torch.ops import pair_combine as pc
from genomealignmenttools_tpu_torch.ops.pair_rescore import \
    pair_chain_scores_plain

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
