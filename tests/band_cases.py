"""Seeded banded-DP extension problems for the port's band tests and
chip_smoke.py: (a_seq, b_seq, direction) byte strings over ACGT(N).

- `pallas_problems`: the generator of tests/test_pallas_band.py:15-37
  (homologous with indels, or unrelated; both directions);
- `random_problems`: homologous with substitutions and indels up to twice
  max_insert, unrelated, or homologous with N runs; sides of length 1 up to
  `max_len`; both directions;
- `edge_problems`: empty sides, single bases, all-N sides;
- `wandering_problems`: `a` much longer than `b`, so that in global mode the
  band runs off the end of `b` (columns with n <= 0);
- literal cases found by search against ops/band_ext.band_ext:
  GLOBAL_OUT_OF_BAND (traceback leaves the band: (False, ...) in global
  mode), LOCAL_OUT_OF_BAND (band_ext raises AssertionError; only with
  gap_open 0, where `bad` is 0), STALE_UP (the result reads up-state cells
  left from two columns back) and WANDERED (band_ext raises IndexError in
  global mode: the band centre falls below the state arrays);
- `kernel_cases`: all of these as the sets K3 is held against its plain
  version on (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def pallas_problems(seed, n=10):
    rng = np.random.default_rng(seed)
    probs = []
    for i in range(n):
        la = int(rng.integers(3, 180))
        lb = int(rng.integers(3, 180))
        a = BASES[rng.integers(0, 4, la)].tobytes()
        if i % 2:  # homologous with indels
            bb = bytearray(a[:lb] if lb <= la
                           else a + BASES[rng.integers(0, 4,
                                                       lb - la)].tobytes())
            for _ in range(int(rng.integers(1, 5))):
                pos = int(rng.integers(0, max(1, len(bb) - 2)))
                if rng.random() < 0.5 and len(bb) > 3:
                    del bb[pos]
                else:
                    bb.insert(pos, int(BASES[rng.integers(0, 4)]))
            b = bytes(bb)
        else:  # unrelated
            b = BASES[rng.integers(0, 4, lb)].tobytes()
        probs.append((a, b, 1 if i % 3 else -1))
    return probs


def _mutate(rng, a: np.ndarray, max_indel: int, identity: float):
    b = a.copy()
    sub = rng.random(b.shape[0]) > identity
    b[sub] = BASES[rng.integers(0, 4, int(sub.sum()))]
    b = bytearray(b.tobytes())
    for _ in range(int(rng.integers(0, 6))):
        pos = int(rng.integers(0, len(b) + 1))
        size = int(rng.integers(1, max_indel + 1))
        if rng.random() < 0.5:
            b[pos:pos] = BASES[rng.integers(0, 4, size)].tobytes()
        else:
            del b[pos:pos + size]
    return bytes(b) or b"A"


def random_problems(rng, n, max_len, max_insert):
    probs = []
    for i in range(n):
        la = int(rng.integers(1, max_len + 1))
        a = BASES[rng.integers(0, 4, la)]
        kind = i % 4
        if kind == 0:
            b = BASES[rng.integers(0, 4, int(rng.integers(1, max_len + 1)))
                      ].tobytes()
        else:
            b = _mutate(rng, a, 2 * max_insert + 2,
                        0.95 if kind == 1 else 0.8)
        if kind == 3:  # N runs on both sides
            a = a.copy()
            bb = np.frombuffer(b, np.uint8).copy()
            for arr in (a, bb):
                for _ in range(int(rng.integers(1, 4))):
                    s = int(rng.integers(0, arr.shape[0]))
                    arr[s:s + int(rng.integers(1, 30))] = ord("N")
            b = bb.tobytes()
        probs.append((a.tobytes(), b, 1 if i % 3 else -1))
    return probs


def edge_problems():
    return [(b"", b"ACGT", 1), (b"ACGT", b"", -1), (b"", b"", 1),
            (b"A", b"A", 1), (b"A", b"C", -1), (b"G", b"GATTACA", 1),
            (b"GATTACA", b"A", -1), (b"NNNN", b"NNNNNN", 1),
            (b"ACGTNNNNACGT", b"ACGTACGT", 1)]


def wandering_problems(rng, n, max_insert):
    probs = []
    for _ in range(n):
        lb = int(rng.integers(1, 3 * max_insert + 3))
        b = BASES[rng.integers(0, 4, lb)]
        tail = BASES[rng.integers(0, 4, int(rng.integers(
            4 * max_insert + 8, 12 * max_insert + 40)))]
        probs.append((np.concatenate([b, tail]).tobytes(), b.tobytes(), 1))
    return probs


# (max_insert, problem); gap_open 400, gap_extend 30, global mode
GLOBAL_OUT_OF_BAND = [
    (7, (b"ACGT", b"ACGTACGTTGCAATGCCGTAGGCTTAACGGATCGATCGGCTAGCTAGG"
                  b"CCGATAGC", 1)),
]
# (gap_open, gap_extend, max_insert, problem); local mode
LOCAL_OUT_OF_BAND = [
    (0, 0, 1, (b"TCGTGGTTTATTTCGTCTGTCCTAAAC",
               b"CTTCGGCATCGTGGGCGGTTGTATTCGAGGTGGGTAACCT", 1)),
    (0, 30, 5, (b"TTTGTGTGTCAGTTCTATAGGGTCC",
                b"ACGACCATCCTAGGTGTACCCGGCCTGATTTGACCCCTTCTA", 1)),
]
# (global_mode, max_insert, problem); gap_open 400, gap_extend 30: results
# that change when the up-state cells left from two columns back are cleared
# (the m and l cells never changed a result in the same search)
STALE_UP = [
    (False, 3, (b"ACATCTAC", b"TCATCT", -1)),
    (True, 7, (b"ACAA", b"AC", 1)),
]
# (max_insert, problem); gap_open 400, gap_extend 30, global mode
WANDERED = [
    (5, (b"AACCCCCCCACAAACCAACCCCCAAACAAACACCACCAAAAACAAAAACAAC",
         b"AAACACAAAC", 1)),
]


def kernel_cases(seed=20261018, n=160):
    """The case sets on which K3 is held against its plain version: a list
    of (label, global_mode, gap_open, gap_extend, max_insert, problems).
    Both modes at max_insert 7, 20 and 100 (lengths up to 2,000 at 100),
    then the literal cases."""
    rng = np.random.default_rng(seed)
    sets = []
    for global_mode in (False, True):
        for mi in (7, 20, 100):
            probs = (random_problems(rng, n, 2000 if mi == 100 else 400, mi)
                     + edge_problems() + pallas_problems(seed + mi)
                     + wandering_problems(rng, 8, mi))
            sets.append((f"{'global' if global_mode else 'local'} "
                         f"max_insert {mi}", global_mode, 400, 30, mi, probs))
    mi, prob = GLOBAL_OUT_OF_BAND[0]
    sets.append(("global out of band", True, 400, 30, mi, [prob]))
    for gap_open, gap_extend, mi, prob in LOCAL_OUT_OF_BAND:
        sets.append((f"local out of band (gap_open {gap_open}, max_insert "
                     f"{mi})", False, gap_open, gap_extend, mi, [prob]))
    for g, mi, prob in STALE_UP:
        sets.append((f"stale up cells ({'global' if g else 'local'})", g,
                     400, 30, mi, [prob]))
    mi, prob = WANDERED[0]
    sets.append(("wandered", True, 400, 30, mi, [prob]))
    return sets


N_KERNEL_CASES = 12   # len(kernel_cases())


def raw_inputs(problems, device):
    """K3's inputs for these problems on `device`, as BandExtBatch.run
    builds them (problems with an empty side dropped)."""
    import torch

    from genomealignmenttools_tpu_torch.ops.band_batch import orient, pack
    _, todo = orient(problems, 2048)
    return [torch.from_numpy(x).to(device) for x in pack(todo)]


def outcome(fn):
    """fn()'s value, or the type of the error band_ext raises."""
    try:
        return fn()
    except (AssertionError, IndexError) as e:
        return type(e)
