"""chainNet -rescore: engines.chain_net.chain_net with the traffic mix's
flags (min_space, rescore, linear_gap), both nets written to files as the
CLI writes them."""

import os


def prepare(workload, config, traffic, device, out_dir):
    from genomealignmenttools_tpu_torch.engines.chain_net import chain_net
    p = workload["paths"]
    flags = traffic["flags"]
    outs = [os.path.join(out_dir, "out.t.net"),
            os.path.join(out_dir, "out.q.net")]

    def call():
        with open(outs[0], "w") as t_out, open(outs[1], "w") as q_out:
            chain_net(p["chain"], p["t_sizes"], p["q_sizes"], t_out, q_out,
                      min_space=flags["min_space"], rescore=flags["rescore"],
                      t_2bit=p["t2bit"], q_2bit=p["q2bit"],
                      linear_gap=flags["linear_gap"], device=device)
        return outs
    return call
