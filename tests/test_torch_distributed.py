"""The port's torch.distributed layer: host0_merge_text, init_distributed,
and genuine two-process gloo runs on the CPU.

Each two-process test spawns two ranks that meet through
torch.distributed (gloo, tcp://127.0.0.1:<free port>); each runs its shard
with -device=cpu and the outputs are merged over an all-gather.  The merged
files must be byte-identical to the goldens, and no rank may load jax.  A
refused or timed-out local rendezvous is retried on fresh ports, then the
test skips (as tests/test_two_process_distributed.py does).
"""

import os
import socket
import subprocess
import sys

import pytest
import torch.distributed as dist

from conftest import hermetic_cpu_env
from genomealignmenttools_tpu_torch.parallel import distributed as pd
from genomealignmenttools_tpu_torch.parallel.mesh import make_mesh

_WORKER = r"""
import os, sys
init, rank, fix, out, tool = sys.argv[1:6]
rank = int(rank)
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
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "genomealignmenttools_tpu"
                or m.startswith("genomealignmenttools_tpu."))
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


def _rendezvous_once(fixtures_dir, out, tool):
    """One two-rank attempt; None on success, else a transient error
    string (refused or timed-out rendezvous) - anything else raises."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = hermetic_cpu_env()
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, init, str(i), fixtures_dir, out,
         tool], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            return "rendezvous timed out"
    for i, (stdout, err) in enumerate(outs):
        if procs[i].returncode != 0:
            if any(t in err.lower() for t in _TRANSIENT):
                return err.strip().splitlines()[-1][:160]
            raise AssertionError(f"rank {i} failed:\n{err[-3000:]}")
        assert f"WORKER_OK {i}" in stdout
        assert "LOADED []" in stdout, stdout[-2000:]
    return None


def _two_ranks(fixtures_dir, out, tool):
    last = None
    for _attempt in range(3):
        last = _rendezvous_once(fixtures_dir, out, tool)
        if last is None:
            return
    pytest.skip(f"runtime forbids a local rendezvous: {last}")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_two_process_gloo_score_chain(fixtures_dir, golden_dir, tmp_path):
    out = str(tmp_path / "merged.chain")
    _two_ranks(fixtures_dir, out, "scoreChain")
    assert _read(out) == _read(os.path.join(golden_dir,
                                            "scoreChain.loose.chain"))
    # each rank wrote a true part of the whole
    assert 0 < os.path.getsize(out + ".shard1") < os.path.getsize(out)


def test_two_process_gloo_clean_chains_distributed(fixtures_dir, golden_dir,
                                                   tmp_path):
    out = str(tmp_path / "cleaned")
    _two_ranks(fixtures_dir, out, "chainCleaner")
    assert _read(out + ".chain") == _read(
        os.path.join(golden_dir, "chainCleaner.out.chain"))
    assert _read(out + ".bed") == _read(
        os.path.join(golden_dir, "chainCleaner.removedSuspects.bed"))
    assert sorted(os.listdir(out + ".work")) == [
        "cleaner_shard_0.json", "cleaner_shard_1.json", "gathered_0.json",
        "gathered_1.json"]


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
