"""Port twin of tests/test_thread_determinism.py::
test_repeatfiller_thread_determinism: the port's RepeatFiller CLI on
build_repeatfiller_workload(n_gaps=24) in subprocesses at GAT_THREADS=1 and
=8 with -device=cpu gives the same bytes.  Each gap of that workload hands
the threaded native HSP scan of the port's own build (native/hspscan.cpp)
some 600 to 700 windows, ten or eleven chunks of 64, so all eight threads
take work on every gap; the reference's 120 gaps add no case the scan does
not see here.  The band DP runs as the plain PyTorch version of K3, most of
this file's time.  A file of its own so that the test runner can run it
beside the others.
"""

import golden_cases as gc


def test_repeatfiller_thread_determinism(tmp_path):
    from genomealignmenttools_tpu_torch.utils.bench_workload import \
        build_repeatfiller_workload
    m = build_repeatfiller_workload(str(tmp_path / "rf"), n_gaps=24)
    from conftest import hermetic_cpu_env
    outs = gc.port_cli_at_1_and_8_threads(lambda d: (
        ["RepeatFiller", "-c", m["chain"], "-T2", m["t2bit"], "-Q2",
         m["q2bit"], "-o", str(d / "rf.chain")], ["rf.chain"]), tmp_path,
        hermetic_cpu_env())
    assert outs[1] == outs[8]
    assert outs[1][0].count(b"chain ") >= 1
