"""Command surface of the port: the rescoring tools with the torch scorer.

Counterpart of genomealignmenttools_tpu/cli/main.py.  The three commands
that touch the device - scoreChain, chainNet and chainCleaner - are parsed
here with the same kent flags as the reference (cli/main.py:32-53,
engines/chain_net.py:1122-1156, engines/chain_cleaner.py:1736-1787) and run
the reference engines with `scorer_factory` set to the port's
TorchChainScorer.  Every other command, and chainCleaner -mergeShards, which
scores nothing, is handed unchanged to genomealignmenttools_tpu.cli.main.

One flag is the port's own: -device=cuda|cuda:N|cpu (default cuda).  There
is no silent fallback: without CUDA, the default raises.

    python -m genomealignmenttools_tpu_torch.cli.main scoreChain \\
        in.chain t.2bit q.2bit out.chain -linearGap=loose [-device=cpu]
"""

from __future__ import annotations

import sys

from genomealignmenttools_tpu.cli.main import _parse_kent_args
from genomealignmenttools_tpu.cli.main import main as reference_main


def _out(path: str):
    return sys.stdout if path == "stdout" else open(path, "w")


def cmd_score_chain(argv: list[str], factory) -> int:
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
        scorer_factory=factory,
        num_shards=int(opts.get("numShards", 1)),
        shard=int(opts.get("shard", 0)),
    )
    return 0


def cmd_chain_net(argv: list[str], factory) -> int:
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
            scorer_factory=factory,
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


def cmd_chain_cleaner(argv: list[str], factory) -> int:
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
        scorer_factory=factory,
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


COMMANDS = {
    "scoreChain": cmd_score_chain,
    "chainNet": cmd_chain_net,
    "chainCleaner": cmd_chain_cleaner,
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    rest = []
    for a in argv:
        if a.startswith("-device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not rest or rest[0] not in COMMANDS or (
            rest[0] == "chainCleaner"
            and any(a.startswith("-mergeShards") for a in rest)):
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
            print("-profile is not supported by the port yet",
                  file=sys.stderr)
            return 255
        else:
            args.append(a)
    from ..ops.rescore import torch_scorer_factory
    return COMMANDS[cmd](args, torch_scorer_factory(device))


if __name__ == "__main__":
    sys.exit(main())
