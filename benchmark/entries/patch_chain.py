"""patchChain: engines.drivers.patch_chain at the configuration's settings
(the lastz K, L and W, the scoring matrix and gap costs written as a .q
file, the gap bounds, the flag `unmask`: false seeds from unmasked bases
alone), its psl written to a file."""

import os


def write_score_file(path: str, config: dict) -> None:
    """The configuration's matrix in the .q format of HoxD55.q, with
    lastz's O and E on the line after it."""
    rows = config["score_matrix_acgt"]
    lz = config["lastz"]
    with open(path, "w") as f:
        f.write("".join(f"{c:>5}" for c in "ACGT") + "\n")
        for r in rows:
            f.write("".join(f"{v:>5}" for v in r) + "\n")
        f.write(f"O = {lz['O']}, E = {lz['E']}\n")


def prepare(workload, config, traffic, device, out_dir):
    from genomealignmenttools_tpu_torch.engines.drivers import patch_chain
    p = workload["paths"]
    scheme = os.path.join(out_dir, "scores.q")
    write_score_file(scheme, config)
    outs = [os.path.join(out_dir, "out.psl")]
    lz = config["lastz"]

    def call():
        patch_chain(p["chain"], p["t2bit"], p["q2bit"], p["t_sizes"],
                    p["q_sizes"], outs[0],
                    chain_min_score=config["chain_min_score"],
                    gap_min_t=config["gap_min"], gap_min_q=config["gap_min"],
                    gap_max_t=config["gap_max"], gap_max_q=config["gap_max"],
                    score_scheme=scheme, seed_len=lz["W"],
                    hsp_threshold=lz["K"], gapped_threshold=lz["L"],
                    min_identity=config["min_identity"],
                    min_entropy=config["min_entropy"],
                    unmask=config["flags"]["unmask"], device=device)
        return outs
    return call
