"""The port's torch.distributed layer: host0_merge_text, init_distributed,
and genuine two-process gloo runs on the CPU.

Each two-process test spawns two ranks that meet through
torch.distributed (gloo, tcp://127.0.0.1:<free port>); each runs its shard
with -device=cpu and the outputs are merged over an all-gather.  The merged
files must be byte-identical to the goldens, and no rank may load jax.  A
refused or timed-out local rendezvous is retried on fresh ports, each
attempt in a directory of its own, then the test skips (as
tests/test_two_process_distributed.py does).  A failure reports which check
failed, the first line that differs from the golden, and both ranks' return
codes and the tails of their stdout and stderr.

Every rank leaves the process group before it exits: after a barrier (so
that no rank tears down while the other still merges) it calls
destroy_process_group(), and init_distributed destroys a group left alive at
exit.  Without that, a rank aborted at interpreter exit with "terminate
called without an active exception" from the gloo group's threads, in 3 of
50 runs of this file.
"""

import os
import socket
import subprocess
import sys
from typing import NamedTuple

import pytest
import torch.distributed as dist

from conftest import hermetic_cpu_env
from genomealignmenttools_tpu_torch.parallel import distributed as pd
from genomealignmenttools_tpu_torch.parallel.mesh import make_mesh

_WORKER = r"""
import os, sys
init, rank, fix, out, tool = sys.argv[1:6]
rank = int(rank)
import torch.distributed as dist
from genomealignmenttools_tpu_torch.native import get_lib
from genomealignmenttools_tpu_torch.parallel.distributed import (
    host0_merge_text, init_distributed, world)
init_distributed("gloo", init_method=init, world_size=2, rank=rank)
n, me = world()
assert (n, me) == (2, rank), (n, me)
f = lambda p: os.path.join(fix, p)
if tool == "scoreChain":
    from genomealignmenttools_tpu_torch.cli.main import main
    shard = out + f".shard{me}"
    if main(["scoreChain", f("synthetic.chain"), f("target.2bit"),
             f("query.2bit"), shard, "-linearGap=loose", f"-numShards={n}",
             f"-shard={me}", "-device=cpu"]) != 0:
        sys.exit("scoreChain failed")
    merged = host0_merge_text(open(shard).read(), max_bytes=1 << 22)
    if me == 0:
        with open(out, "w") as fh:
            fh.write(merged)
else:
    from genomealignmenttools_tpu_torch.utils.verbose import set_verbosity
    from genomealignmenttools_tpu_torch.engines.chain_cleaner import \
        clean_chains_distributed
    set_verbosity(0)
    clean_chains_distributed(
        f("synthetic.scored.sorted.chain"), f("target.2bit"),
        f("query.2bit"), out + ".chain", out + ".bed", out + ".work",
        max_gather_bytes=1 << 22, device="cpu",
        t_sizes=f("target.chrom.sizes"), q_sizes=f("query.chrom.sizes"),
        linear_gap="loose")
dist.barrier()
dist.destroy_process_group()
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "genomealignmenttools_tpu"
                or m.startswith("genomealignmenttools_tpu."))
print("NATIVE", get_lib() is not None)
print("LOADED", loaded)
print("WORKER_OK", me, flush=True)
"""

_TRANSIENT = ("connection refused", "timed out", "timeout",
              "address already in use", "failed to connect",
              "connection reset")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Attempt(NamedTuple):
    out: str                 # output path prefix of this attempt
    rcs: list                # each rank's return code (None: killed)
    streams: list            # each rank's (stdout, stderr)
    transient: str | None    # why the rendezvous itself failed, if it did


def _tail(text, n=2000):
    return text[-n:] if len(text) > n else text


def report(att: Attempt) -> str:
    """Both ranks' return codes and the tails of their stdout and stderr."""
    parts = [f"attempt {att.out}"]
    for i, (rc, (so, se)) in enumerate(zip(att.rcs, att.streams)):
        parts.append(f"--- rank {i}: rc {rc}\n[stdout]\n{_tail(so)}"
                     f"\n[stderr]\n{_tail(se)}")
    return "\n".join(parts)


def first_diff(got: bytes, want: bytes) -> str:
    """The first line where `got` differs from the golden `want`."""
    g, w = got.splitlines(), want.splitlines()
    for k, (a, b) in enumerate(zip(g, w)):
        if a != b:
            return f"line {k + 1}: got {a[:200]!r}, golden {b[:200]!r}"
    return f"{len(g)} lines, golden has {len(w)}"


def _rendezvous_once(fixtures_dir, out, tool) -> Attempt:
    """One two-rank attempt writing under `out`; `transient` is set when
    the rendezvous was refused or timed out."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = hermetic_cpu_env()
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, init, str(i), fixtures_dir, out,
         tool], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    streams = [("", "")] * 2
    for i, p in enumerate(procs):
        try:
            streams[i] = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for j, q in enumerate(procs):
                q.kill()
                so, se = q.communicate()
                streams[j] = (streams[j][0] + so, streams[j][1] + se)
            return Attempt(out, [q.returncode for q in procs], streams,
                           "rendezvous timed out")
    rcs = [p.returncode for p in procs]
    transient = None
    for rc, (_, err) in zip(rcs, streams):
        if rc != 0 and any(t in err.lower() for t in _TRANSIENT):
            transient = (err.strip().splitlines() or ["?"])[-1][:160]
    return Attempt(out, rcs, streams, transient)


def _two_ranks(fixtures_dir, tmp_path, tool) -> Attempt:
    """Up to three attempts, each in its own directory; the first that got
    past the rendezvous is returned, checked by the caller."""
    last = None
    for k in range(3):
        d = tmp_path / f"attempt{k}"
        d.mkdir()
        last = _rendezvous_once(fixtures_dir, str(d / "out"), tool)
        if last.transient is None:
            return last
    pytest.skip(f"runtime forbids a local rendezvous: {last.transient}\n"
                + report(last))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def check_workers(att: Attempt) -> list[str]:
    """Failed checks of the ranks themselves: return code, WORKER_OK and
    LOADED []."""
    bad = []
    for i, (rc, (so, _)) in enumerate(zip(att.rcs, att.streams)):
        if rc != 0:
            bad.append(f"rank {i} exited with rc {rc}")
        if f"WORKER_OK {i}" not in so:
            bad.append(f"rank {i}: no WORKER_OK")
        if "LOADED []" not in so:
            bad.append(f"rank {i}: not LOADED [] (a jax module was loaded)")
    return bad


def check_bytes(label: str, path: str, golden: str) -> list[str]:
    """[] when the file at `path` equals the golden byte for byte."""
    if not os.path.exists(path):
        return [f"{label}: {path} was not written"]
    got, want = _read(path), _read(golden)
    if got == want:
        return []
    return [f"{label}: differs from {os.path.basename(golden)} at "
            + first_diff(got, want)]


def _assert_ok(att: Attempt, bad: list[str]) -> None:
    assert not bad, ("failed checks:\n  " + "\n  ".join(bad) + "\n"
                     + report(att))


def test_two_process_gloo_score_chain(fixtures_dir, golden_dir, tmp_path):
    att = _two_ranks(fixtures_dir, tmp_path, "scoreChain")
    bad = check_workers(att)
    bad += check_bytes("merged .chain", att.out,
                       os.path.join(golden_dir, "scoreChain.loose.chain"))
    # each rank wrote a true part of the whole
    if not bad and not (0 < os.path.getsize(att.out + ".shard1")
                        < os.path.getsize(att.out)):
        bad.append("rank 1's shard is empty or the whole file")
    _assert_ok(att, bad)


def test_two_process_gloo_clean_chains_distributed(fixtures_dir, golden_dir,
                                                   tmp_path):
    att = _two_ranks(fixtures_dir, tmp_path, "chainCleaner")
    bad = check_workers(att)
    bad += check_bytes("merged .chain", att.out + ".chain",
                       os.path.join(golden_dir, "chainCleaner.out.chain"))
    bad += check_bytes(
        "merged .bed", att.out + ".bed",
        os.path.join(golden_dir, "chainCleaner.removedSuspects.bed"))
    work = att.out + ".work"
    listing = sorted(os.listdir(work)) if os.path.isdir(work) else None
    want = ["cleaner_shard_0.json", "cleaner_shard_1.json",
            "gathered_0.json", "gathered_1.json"]
    if listing != want:
        bad.append(f"listing of out.work: {listing}, expected {want}")
    _assert_ok(att, bad)


def test_failure_report_names_check_line_and_ranks(tmp_path):
    """The diagnostics a failing two-rank run prints: the check, the first
    differing line and both ranks' codes and stream tails."""
    golden = tmp_path / "golden"
    golden.write_bytes(b"a\nb\nc\n")
    got = tmp_path / "got"
    got.write_bytes(b"a\nB\nc\n")
    assert check_bytes("merged .chain", str(golden), str(golden)) == []
    (msg,) = check_bytes("merged .chain", str(got), str(golden))
    assert msg.startswith("merged .chain: differs") and "line 2" in msg
    assert "was not written" in check_bytes(
        "merged .bed", str(tmp_path / "none"), str(golden))[0]
    assert first_diff(b"a\n", b"a\nb\n") == "1 lines, golden has 2"
    att = Attempt(str(tmp_path / "out"), [0, -6],
                  [("LOADED []\nWORKER_OK 0\n", ""),
                   ("x" * 5000 + "LOADED []\n", "terminate called")], None)
    assert check_workers(att) == ["rank 1 exited with rc -6",
                                  "rank 1: no WORKER_OK"]
    text = report(att)
    assert "rank 0: rc 0" in text and "rank 1: rc -6" in text
    assert "terminate called" in text and "x" * 5001 not in text


_ONE_RANK = r"""
import atexit, sys
import torch.distributed as dist
atexit.register(lambda: print("AT_EXIT", dist.is_initialized(), flush=True))
from genomealignmenttools_tpu_torch.parallel.distributed import \
    init_distributed
init_distributed("gloo", init_method="file://" + sys.argv[1], world_size=1,
                 rank=0)
print("JOINED", dist.is_initialized(), flush=True)
"""


def test_group_is_left_before_the_interpreter_exits(tmp_path):
    """One rank that joins through init_distributed and exits without
    destroying its group: the group is destroyed at exit all the same (an
    exit handler registered earlier, so run later, sees none), which is what
    kept a gloo rank from aborting at exit."""
    env = hermetic_cpu_env()
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", _ONE_RANK, str(tmp_path / "rendezvous")],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["JOINED", "True", "AT_EXIT", "False"], \
        res.stdout + res.stderr[-2000:]


def test_host0_merge_text_single_process():
    assert not dist.is_initialized()
    assert pd.host0_merge_text("abc") == "abc"
    assert pd.host0_merge_text("abc", max_bytes=3) == "abc"
    with pytest.raises(ValueError, match="exceeds"):
        pd.host0_merge_text("abcd", max_bytes=3)
    with pytest.raises(ValueError, match="exceeds"):
        pd.host0_merge_text("éé", max_bytes=3)   # 4 bytes encoded


def test_init_distributed_single_process_and_backend(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    pd.init_distributed()
    pd.init_distributed("gloo")
    assert not dist.is_initialized()
    assert pd.world() == (1, 0)
    assert pd.hosts_chips_mesh(["cpu"] * 2) == (1, make_mesh(
        devices=["cpu"] * 2))
    # more than one process: the backend must be named, never guessed
    for backend in (None, "mpi"):
        with pytest.raises(ValueError, match="backend"):
            pd.init_distributed(backend, init_method="tcp://127.0.0.1:1",
                                world_size=2, rank=0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend"):
        pd.init_distributed()
    assert not dist.is_initialized()
