"""RepeatFiller: engines.repeat_filler.repeat_filler at the configuration's
settings (gap sizes, lastz K, L and W, the score threshold)."""

import os


def prepare(workload, config, traffic, device, out_dir):
    from genomealignmenttools_tpu_torch.engines.repeat_filler import \
        repeat_filler
    p = workload["paths"]
    outs = [os.path.join(out_dir, "out.chain")]
    lz = config["lastz"]
    if config["flags"]["linear_gap"] != "loose":
        raise ValueError("the port's RepeatFiller scores with the loose "
                         "linear gap costs only")

    def call():
        repeat_filler(p["chain"], p["t2bit"], p["q2bit"], outs[0],
                      gap_min_t=config["gap_min"], gap_min_q=config["gap_min"],
                      gap_max_t=config["gap_max"], gap_max_q=config["gap_max"],
                      score_threshold=config["score_threshold"],
                      seed_len=lz["W"], hsp_threshold=lz["K"],
                      gapped_threshold=lz["L"], device=device)
        return outs
    return call
