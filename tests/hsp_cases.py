"""Scan windows for K4 (csrc/hspscan.cu) and its plain version
(ops/hsp_scan.py), shared by tests/test_torch_hsp_scan.py, the GPU tests,
chip_smoke.py's [kernel K4] phase and sanitize.py.

The edge cases: windows of 1, 5, 31, 32, 33, 511, 512, 513 (a lane's cells
and a warp's segment, K4's edges) and 5,000 cells at random places; windows
ending at the last code of either array; windows over N runs (code 4) and
over sequence that mismatches everywhere, whose best segment is negative;
windows whose best is exactly K=1500 (fifteen C/C matches of HoxD55 between
N runs) and just under it (fourteen and a T/T, 1,491).
"""

import numpy as np

# HoxD55 (tests/fixtures/HoxD55.q) over T C A G, N the worst mismatch: the
# gap aligner's hsp_lut for patchChain's configuration, indexed [q, t]
_ACGT = np.array([[91, -90, -25, -100], [-90, 100, -100, -25],
                  [-25, -100, 100, -90], [-100, -25, -90, 91]], np.int64)
_TCAG = [3, 1, 0, 2]          # code (T=0 C=1 A=2 G=3) -> ACGT row
K = 1500
LENGTHS = (1, 5, 31, 32, 33, 511, 512, 513, 5000)
C, N = 1, 4


def hsp_lut() -> np.ndarray:
    lut = np.empty((5, 5), np.int64)
    lut[:4, :4] = _ACGT[np.ix_(_TCAG, _TCAG)]
    lut[4, :] = lut[:, 4] = _ACGT.min()
    return lut


def edge_case(seed: int = 25, t_len: int = 60_000, q_len: int = 50_000,
              per_length: int = 40):
    """(t, q, t_start, q_start, length): uint8 codes with N runs, int64
    window starts and int32 lengths, the cases above among random ones."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, t_len).astype(np.uint8)
    q = rng.integers(0, 4, q_len).astype(np.uint8)
    for codes in (t, q):
        for s in rng.integers(0, codes.shape[0] - 700, 30):
            codes[s:s + int(rng.integers(1, 700))] = N
    rows = []
    for n in LENGTHS:
        for _ in range(per_length):
            rows.append((int(rng.integers(0, t_len - n)),
                         int(rng.integers(0, q_len - n)), n))
        rows.append((t_len - n, q_len - n, n))         # ends at both ends
        rows.append((t_len - n, 0, n))
    # all N, and a mismatch everywhere: every segment scores below 0
    t[1000:1600] = N
    q[2000:2600] = N
    rows += [(1000, 2000, 600), (1000, 7000, 33), (9000, 2000, 513)]
    t[11000:11600] %= 4
    q[11000:11600] = (t[11000:11600] + 2) % 4
    rows += [(11000, 11000, 600), (11000, 11000, 1)]
    # best exactly K, and just under it, each between N runs
    for at, run in ((20000, [C] * 15), (21000, [C] * 14 + [0])):
        t[at - 40:at + 60] = N
        q[at - 40:at + 60] = N
        t[at:at + len(run)] = run
        q[at:at + len(run)] = run
        rows += [(at - 40, at - 40, 100), (at - 5, at - 5, 33)]
    a = np.array(rows, np.int64)
    return (t, q, a[:, 0].copy(), a[:, 1].copy(),
            a[:, 2].astype(np.int32))


def kadane(t, q, t_start, q_start, length, lut) -> np.ndarray:
    """Each window's best non-empty segment score, one window at a time in
    numpy: max over cells of (prefix through the cell) - (least prefix
    before it)."""
    out = np.empty(length.shape[0], np.int64)
    for w, (ts, qs, n) in enumerate(zip(t_start, q_start, length)):
        v = lut[q[qs:qs + n], t[ts:ts + n]]
        pref = np.cumsum(v)
        least = np.minimum.accumulate(np.concatenate([[0], pref[:-1]]))
        out[w] = (pref - least).max()
    return out


# the two gap-filling cells of BENCHMARK.json: (configuration, generator
# module, whether seeds skip soft-masked bases)
CELLS = {"patchchain.gaps": ("patchchain-planted-hoxd55", "patchchain", True),
         "repeatfiller.gaps": ("gapfill-planted-loose", "repeatfiller",
                               False)}


def cell_chunk(cell: str, out_dir: str, seed: int, n_gaps: int, device,
               unmask: bool = False):
    """(aligner, seeded): one chunk of a gap-filling cell's gaps as its
    tool seeds them, through the benchmark's generator and configuration
    at n_gaps gaps: the GapAligner (on `device`) and align_seed's result of
    every gap, soft-masked bases seed-blind in patchchain.gaps unless
    `unmask`."""
    import json
    import os

    from benchmark.entries.patch_chain import write_score_file
    from benchmark.workloads import patchchain, repeatfiller
    from genomealignmenttools_tpu_torch.device.genome import Genome
    from genomealignmenttools_tpu_torch.engines.repeat_filler import (
        _gap_job_regions, harvest_gap_jobs)
    from genomealignmenttools_tpu_torch.formats.scorematrix import (
        read_score_scheme, score_scheme_default)
    from genomealignmenttools_tpu_torch.ops.seed_extend import GapAligner

    config_name, generator, masked = CELLS[cell]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "benchmark", "configs",
                           config_name + ".json")) as f:
        config = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    gen = {"patchchain": patchchain, "repeatfiller": repeatfiller}[generator]
    paths = gen.generate(seed, {"n_gaps": n_gaps}, out_dir)["paths"]
    if generator == "patchchain":
        write_score_file(os.path.join(out_dir, "scores.q"), config)
        scheme = read_score_scheme(os.path.join(out_dir, "scores.q"))
    else:
        scheme = score_scheme_default()
    lz = config["lastz"]
    aligner = GapAligner(scheme.lut, seed_len=lz["W"], hsp_threshold=lz["K"],
                         gapped_threshold=lz["L"], gap_open=scheme.gap_open,
                         gap_extend=scheme.gap_extend,
                         char_matrix=scheme.char_matrix(), device=device)
    with open(paths["chain"]) as f:
        lines = [ln + "\n" for ln in f.read().split("\n")]
    jobs = harvest_gap_jobs(lines, 0, 0, 0, config["gap_min"],
                            config["gap_min"], config["gap_max"],
                            config["gap_max"])
    t_gen, q_gen = Genome(paths["t2bit"]), Genome(paths["q2bit"])
    blind = masked and not unmask
    if blind:
        t_mask = Genome(paths["t2bit"], with_mask=True)
        q_mask = Genome(paths["q2bit"], with_mask=True)
    seeded = []
    for job in jobs:
        (t_codes, q_codes, _, _, t_lo, t_hi, q_lo,
         q_hi) = _gap_job_regions(job, t_gen, q_gen)
        seeds = (None, None)
        if blind:
            t_seed = t_codes.copy()
            t_seed[t_mask.seq(job.t_name).mask] = N
            m = q_mask.seq(job.q_name).mask
            q_seed = q_codes.copy()
            q_seed[m[::-1] if job.q_strand == "-" else m] = N
            seeds = (t_seed, q_seed)
        seeded.append(aligner.align_seed(t_codes, q_codes, t_lo, t_hi, q_lo,
                                         q_hi, *seeds))
    return aligner, seeded
