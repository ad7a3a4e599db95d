"""scoreChain: engines.score_chain.score_chain_file."""

import os


def prepare(workload, config, traffic, device, out_dir):
    from genomealignmenttools_tpu_torch.engines.score_chain import \
        score_chain_file
    p = workload["paths"]
    outs = [os.path.join(out_dir, "out.chain")]

    def call():
        score_chain_file(p["chain"], p["t2bit"], p["q2bit"], outs[0],
                         linear_gap=config["flags"]["linear_gap"],
                         device=device)
        return outs
    return call
