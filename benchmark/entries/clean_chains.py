"""chainCleaner: engines.chain_cleaner.clean_chains, as the CLI runs it
(the netting done in-process, -tSizes and -qSizes given)."""

import os


def prepare(workload, config, traffic, device, out_dir):
    from genomealignmenttools_tpu_torch.engines.chain_cleaner import \
        clean_chains
    p = workload["paths"]
    outs = [os.path.join(out_dir, "out.chain"),
            os.path.join(out_dir, "out.bed")]

    def call():
        clean_chains(p["chain"], p["t2bit"], p["q2bit"], *outs,
                     t_sizes=p["t_sizes"], q_sizes=p["q_sizes"],
                     linear_gap=config["flags"]["linear_gap"], device=device)
        return outs
    return call
