#!/bin/bash
# Times the port's CLI from two checkouts in turns, in cold processes, on the
# cleaner, chr1 and 600-gap workloads of utils/bench_workload.py (built once,
# by the second checkout), then byte-compares the two sides' outputs.
#
#   bash genomealignmenttools_tpu_torch/experiments/cli_ab.sh A_DIR B_DIR WORK_DIR
#
# A_DIR and B_DIR are roots of checkouts (for example the parent and the
# change, unpacked by git archive); run on a machine with one CUDA card.
# Prints "AB <side> <tool> <seconds>" per run, in the order A B B A A B B A,
# and "SAME <file>" for each output that is identical on both sides.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
A=$(cd "$1" && pwd); B=$(cd "$2" && pwd); mkdir -p "$3"; W=$(cd "$3" && pwd)
(cd "$B" && python3 - "$W" <<'PY'
import json, sys
from genomealignmenttools_tpu_torch.utils.bench_workload import (
    build_cleaner_workload, build_repeatfiller_workload, build_workload)
W = sys.argv[1]
json.dump({"cl": build_cleaner_workload(W + "/cleaner", n_scenarios=2000,
                                        n_bulk=30000),
           "chr1": build_workload(W + "/chr1", t_size=256_000_000,
                                  n_chains=384),
           "rf": build_repeatfiller_workload(W + "/rf", n_gaps=600)},
          open(W + "/w.json", "w"))
PY
)
get() { python3 -c "import json; print(json.load(open('$W/w.json'))['$1']['$2'])"; }
CL=$(get cl chain); CLT=$(get cl t_sizes); CLQ=$(get cl q_sizes)
CT=$(get cl t2bit); CQ=$(get cl q2bit)
HC=$(get chr1 chain); HT=$(get chr1 t2bit); HQ=$(get chr1 q2bit)
RC=$(get rf chain); RT=$(get rf t2bit); RQ=$(get rf q2bit)
F=$B/tests/fixtures
CLI="python3 -m genomealignmenttools_tpu_torch.cli.main"
for root in "$A" "$B"; do   # each side builds its libraries first, untimed
  (cd "$root" && $CLI scoreChain $F/synthetic.chain $F/target.2bit \
     $F/query.2bit "$W/warm.chain" -linearGap=loose > /dev/null)
done
TIMEFORMAT=%R
one() {  # side root tool
  local o=$W/$1.$3 t
  cd "$2"
  case $3 in
    window) t=$( { time $CLI chainNet $CL $CLT $CLQ $o.t.net $o.q.net \
        -rescore -tNibDir=$CT -qNibDir=$CQ -linearGap=loose > /dev/null; } 2>&1 );;
    pair) t=$( { time env GAT_RESCORE=pair GAT_COMBINE=device $CLI chainNet \
        $CL $CLT $CLQ $o.t.net $o.q.net -rescore -tNibDir=$CT -qNibDir=$CQ \
        -linearGap=loose > /dev/null; } 2>&1 );;
    score) t=$( { time $CLI scoreChain $HC $HT $HQ $o.chain \
        -linearGap=loose > /dev/null; } 2>&1 );;
    rf) t=$( { time $CLI RepeatFiller -c $RC -T2 $RT -Q2 $RQ \
        -o $o.chain > /dev/null; } 2>&1 );;
  esac
  echo "AB $1 $3 $(echo "$t" | tail -1)"
}
for side in A B B A A B B A; do
  root=$A; [ $side = B ] && root=$B
  for tool in window pair score rf; do one $side "$root" $tool; done
done
for f in window.t.net window.q.net pair.t.net pair.q.net score.chain rf.chain; do
  cmp "$W/A.$f" "$W/B.$f" && echo "SAME $f"
done
