"""Command surface of the port: the tools whose hot path runs on the device.

Counterpart of genomealignmenttools_tpu/cli/main.py.  Six commands are
parsed here with the same flags as the reference and run on the port's
device:

- scoreChain, chainNet and chainCleaner (cli/main.py:32-53,
  engines/chain_net.py:1122-1156, engines/chain_cleaner.py:1736-1787) run
  the reference engines with `scorer_factory` set to the port's
  TorchChainScorer;
- FilterChainsNetFilterNets (cli/main.py:570-588) runs the port's pipeline
  entry point, whose chainNet -rescore scores with the same scorer;
- RepeatFiller (engines/repeat_filler.py:331-404) and patchChain in its
  6-argument in-process mode (cli/main.py:512-567) run the port's engine
  entry points, whose gap aligner runs the band DP on the device (K3).

Every other command is handed unchanged to genomealignmenttools_tpu.cli.main,
and so are chainCleaner -mergeShards, which scores nothing, and patchChain's
5-argument mode, which writes cluster job scripts that run the reference
CLI.

One flag is the port's own: -device=cuda|cuda:N|cpu (default cuda).  There
is no silent fallback: without CUDA, the default raises.  The scoring mode
comes from the environment, as in the reference CLI: GAT_RESCORE=pair for
the resident pair path (unset, auto or pallas: K1's window path) and
GAT_COMBINE=auto|device|host for where pair mode combines
(ops/rescore.py).  GAT_BAND=host, the reference's host band batch, raises
here: that path is the reference CLI's.  -profile=dir (or GAT_PROFILE=dir)
wraps the command in a torch.profiler trace written into dir
(utils/profiling.py), as the reference CLI wraps it in a jax one.

    python -m genomealignmenttools_tpu_torch.cli.main scoreChain \\
        in.chain t.2bit q.2bit out.chain -linearGap=loose [-device=cpu]
"""

from __future__ import annotations

import sys

from genomealignmenttools_tpu.cli.main import (_parse_kent_args,
                                               _parse_lastz_parameters)
from genomealignmenttools_tpu.cli.main import main as reference_main

from ..ops.rescore import torch_scorer_factory
from ..utils.profiling import set_profile_dir, trace


def _out(path: str):
    return sys.stdout if path == "stdout" else open(path, "w")


def cmd_score_chain(argv: list[str], device) -> int:
    from genomealignmenttools_tpu.engines.score_chain import score_chain_file

    pos, opts = _parse_kent_args(argv)
    if len(pos) != 4:
        print("usage: scoreChain in.chain target.2bit query.2bit out.chain "
              "-linearGap=loose|medium|file [-scoreScheme=file] "
              "[-doLocalScore] [-forceLocalScore] [-returnOnlyScore] "
              "[-returnOnlyScoreAndCoords] [-device=cuda|cpu]",
              file=sys.stderr)
        return 255
    score_chain_file(
        pos[0], pos[1], pos[2], pos[3],
        linear_gap=opts.get("linearGap", ""),
        score_scheme=opts.get("scoreScheme"),
        do_local_score="doLocalScore" in opts,
        force_local_score="forceLocalScore" in opts,
        return_only_score="returnOnlyScore" in opts,
        return_only_score_and_coords="returnOnlyScoreAndCoords" in opts,
        scorer_factory=torch_scorer_factory(device),
        num_shards=int(opts.get("numShards", 1)),
        shard=int(opts.get("shard", 0)),
    )
    return 0


def cmd_chain_net(argv: list[str], device) -> int:
    from genomealignmenttools_tpu.engines.chain_net import chain_net

    pos, opts = _parse_kent_args(argv)
    if len(pos) != 5:
        print("usage: chainNet in.chain target.sizes query.sizes target.net "
              "query.net [-minSpace=N] [-minFill=N] [-minScore=N] [-inclHap] "
              "[-rescore -tNibDir=t.2bit -qNibDir=q.2bit -linearGap=...] "
              "[-numShards=N -shard=I] [-device=cuda|cpu]", file=sys.stderr)
        return 255
    t_out = _out(pos[3])
    q_out = _out(pos[4])
    try:
        chain_net(
            pos[0], pos[1], pos[2], t_out, q_out,
            min_space=int(opts.get("minSpace", 25)),
            min_fill=int(opts["minFill"]) if "minFill" in opts else None,
            min_score=int(opts.get("minScore", 2000)),
            incl_hap="inclHap" in opts,
            rescore="rescore" in opts,
            t_2bit=opts.get("tNibDir"),
            q_2bit=opts.get("qNibDir"),
            linear_gap=opts.get("linearGap"),
            score_scheme=opts.get("scoreScheme"),
            scorer_factory=torch_scorer_factory(device),
            num_shards=int(opts.get("numShards", 1)),
            shard=int(opts.get("shard", 0)),
        )
    finally:
        if t_out is not sys.stdout:
            t_out.close()
        if q_out is not sys.stdout:
            q_out.close()
    return 0


# chainCleaner threshold flags -> clean_chains keywords (chain_cleaner.py:
# 1752-1770)
_CLEANER_THRESHOLDS = {
    "LRfoldThreshold": ("lr_fold_threshold", float),
    "foldThreshold": ("fold_threshold", float),
    "maxSuspectBases": ("max_suspect_bases", float),
    "maxSuspectScore": ("max_suspect_score", float),
    "minBrokenChainScore": ("min_broken_chain_score", float),
    "minLRGapSize": ("min_lr_gap_size", int),
    "LRfoldThresholdPairs": ("lr_fold_threshold_pairs", float),
    "maxPairDistance": ("max_pair_distance", int),
}


def cmd_chain_cleaner(argv: list[str], device) -> int:
    from genomealignmenttools_tpu.engines.chain_cleaner import clean_chains

    pos, opts = _parse_kent_args(argv)
    if len(pos) != 5:
        print("usage: chainCleaner in.chain t.2bit q.2bit out.chain out.bed "
              "{-net=in.net | -tSizes=t.sizes -qSizes=q.sizes} "
              "-linearGap=loose|medium|file [options] [-device=cuda|cpu]",
              file=sys.stderr)
        return 255
    thresholds = {kw: conv(opts[flag])
                  for flag, (kw, conv) in _CLEANER_THRESHOLDS.items()
                  if flag in opts}
    if "doPairs" in opts:
        thresholds["do_pairs"] = True
    clean_chains(
        pos[0], pos[1], pos[2], pos[3], pos[4],
        net_file=opts.get("net"),
        t_sizes=opts.get("tSizes"), q_sizes=opts.get("qSizes"),
        linear_gap=opts.get("linearGap", "loose"),
        score_scheme=opts.get("scoreScheme"),
        new_chain_id_dict_path=opts.get("newChainIDDict"),
        scorer_factory=torch_scorer_factory(device),
        num_shards=int(opts.get("numShards", 1)),
        shard=int(opts.get("shard", 0)),
        shard_out=opts.get("shardOut"),
        debug="debug" in opts,
        suspect_data_file=opts.get("suspectDataFile"),
        only_this_chr=opts.get("onlyThisChr"),
        only_this_start=int(opts.get("onlyThisStart", -1)),
        only_this_end=int(opts.get("onlyThisEnd", -1)),
        **thresholds)
    return 0


def cmd_filter_chains_pipeline(argv: list[str], device) -> int:
    from genomealignmenttools_tpu.engines.drivers import INT_MAX

    from ..engines.drivers import filter_chains_net_filter_nets

    pos, o = _parse_kent_args(argv)
    if len(pos) != 8:
        print("usage: FilterChainsNetFilterNets in.chain in.net out.chain "
              "out.net t.2bit q.2bit t.sizes q.sizes -minScore=a,b "
              "-minSizeT=a,b -minSizeQ=a,b [-keepSynNetsWithScore=N] "
              "[-keepInvNetsWithScore=N] [-device=cuda|cpu]", file=sys.stderr)
        return 255
    filter_chains_net_filter_nets(
        pos[0], pos[1], pos[2],
        sys.stdout if pos[3] == "stdout" else pos[3],
        pos[4], pos[5], pos[6], pos[7],
        [int(x) for x in o.get("minScore", "0").split(",")],
        [int(x) for x in o.get("minSizeT", "0").split(",")],
        [int(x) for x in o.get("minSizeQ", "0").split(",")],
        keep_syn_nets_with_score=int(o.get("keepSynNetsWithScore", INT_MAX)),
        keep_inv_nets_with_score=int(o.get("keepInvNetsWithScore", INT_MAX)),
        device=device)
    return 0


def cmd_repeat_filler(argv: list[str], device) -> int:
    from ..engines.repeat_filler import repeat_filler_main
    return repeat_filler_main(argv, device)


def cmd_patch_chain(argv: list[str], device) -> int:
    """patchChain in 6-argument mode (cli/main.py:512-567); the 5-argument
    job-script mode never gets here (see main)."""
    from ..engines.drivers import patch_chain

    pos, o = _parse_kent_args(argv)
    if len(pos) != 6:
        print("usage: patchChain in.chain t.2bit q.2bit t.sizes q.sizes "
              "out.psl [-numShards=N -shard=N] [-device=cuda|cpu]\n"
              "  [options: -chainMinScore=N -gapMinSizeT=N ... "
              "-scoreScheme=HoxD55.q -lastzParameters=\"K=1500 L=2500 "
              "W=5 Q=...\" -unmask -minIdentity=N -minEntropy=F "
              "-windowSize=N]\n"
              "  with 5 arguments it writes cluster job scripts, which run "
              "the reference CLI (genomealignmenttools_tpu.cli.main)",
              file=sys.stderr)
        return 255
    lz = _parse_lastz_parameters(o.get("lastzParameters", ""))
    patch_chain(
        pos[0], pos[1], pos[2], pos[3], pos[4],
        sys.stdout if pos[5] == "stdout" else pos[5],
        chain_min_score=int(o.get("chainMinScore", 0)),
        chain_min_size_t=int(o.get("chainMinSizeT", 0)),
        chain_min_size_q=int(o.get("chainMinSizeQ", 0)),
        gap_min_t=int(o.get("gapMinSizeT", 10)),
        gap_min_q=int(o.get("gapMinSizeQ", 10)),
        gap_max_t=int(o.get("gapMaxSizeT", 100000)),
        gap_max_q=int(o.get("gapMaxSizeQ", 100000)),
        score_scheme=lz.get("score_scheme", o.get("scoreScheme")),
        seed_len=lz.get("seed_len", int(o.get("seedLen", 5))),
        hsp_threshold=lz.get("hsp_threshold",
                             int(o.get("hspThreshold", 1500))),
        gapped_threshold=lz.get("gapped_threshold",
                                int(o.get("gappedThreshold", 2500))),
        min_identity=float(o.get("minIdentity", 0)),
        min_entropy=float(o.get("minEntropy", 0)),
        window_size=int(o.get("windowSize", 0)),
        num_shards=int(o.get("numShards", 1)),
        shard_index=int(o.get("shard", 0)),
        unmask="unmask" in o,
        device=device)
    return 0


COMMANDS = {
    "scoreChain": cmd_score_chain,
    "chainNet": cmd_chain_net,
    "chainCleaner": cmd_chain_cleaner,
    "FilterChainsNetFilterNets": cmd_filter_chains_pipeline,
    "RepeatFiller": cmd_repeat_filler,
    "patchChain": cmd_patch_chain,
}


def _forwarded(rest: list[str]) -> bool:
    """Runs of the reference CLI: other commands, chainCleaner -mergeShards
    and patchChain's 5-argument job-script mode."""
    if not rest or rest[0] not in COMMANDS:
        return True
    if rest[0] == "chainCleaner":
        return any(a.startswith("-mergeShards") for a in rest)
    if rest[0] == "patchChain":
        return len(_parse_kent_args(rest[1:])[0]) == 5
    return False


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    rest = []
    for a in argv:
        if a.startswith("-device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if _forwarded(rest):
        return reference_main(rest)
    cmd, args = rest[0], []
    for a in rest[1:]:
        # kent-global flags (kent/src/lib/options.c), as the reference CLI
        # handles them (cli/main.py:758-772)
        if a.startswith("-verbose="):
            from genomealignmenttools_tpu.utils.verbose import set_verbosity
            set_verbosity(int(a.split("=", 1)[1]))
        elif a.startswith("-verboseLog="):
            from genomealignmenttools_tpu.utils.verbose import set_log_file
            set_log_file(a.split("=", 1)[1])
        elif a.startswith("-profile="):
            set_profile_dir(a.split("=", 1)[1])
        else:
            args.append(a)
    with trace(device=device):
        return COMMANDS[cmd](args, device)


if __name__ == "__main__":
    sys.exit(main())
