"""The port's loader of the native host library is safe under threads and
under processes that build at once.

genomealignmenttools_tpu_torch/native/__init__.py differs from the
reference's loader in two ways (tests/test_torch_copies.py names them):
get_lib() holds a lock from its first look at `_tried` to the assignment of
`_lib`, and the library is built under a temporary name and moved into
place.  The reference sets `_tried` before it builds and loads, so a second
thread, the 2bit prefetch of score_chain_file against the main thread's
chain parse, could get None while the first was inside the build, and the
run silently took the python paths.  Each case runs in a fresh interpreter:
eight threads released together call get_lib(), with the library already
built and with an empty build directory (two such processes at once).
"""

import os
import subprocess
import sys

import pytest

from conftest import hermetic_cpu_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, sys, threading
from genomealignmenttools_tpu_torch import native
build_dir = sys.argv[1]
if build_dir != "-":
    # an empty build directory: nothing built yet
    native.BUILD_DIR = build_dir
    native._SO = os.path.join(build_dir, "libgatnative.so")
N = 8
sys.setswitchinterval(1e-5)
gate = threading.Barrier(N)
got = [None] * N
def work(i):
    gate.wait()
    got[i] = native.get_lib()
threads = [threading.Thread(target=work, args=(i,)) for i in range(N)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=280)
if any(t.is_alive() for t in threads):
    sys.exit("a thread is still inside get_lib()")
print("NONE", sum(g is None for g in got))
print("DISTINCT", len({id(g) for g in got}))
print("AGAIN", native.get_lib() is got[0])
print("PATH", getattr(got[0], "_name", None))
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "genomealignmenttools_tpu"
                or m.startswith("genomealignmenttools_tpu."))
print("LOADED", loaded)
"""


def _start(build_dir, **env):
    return subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, build_dir],
        env={**hermetic_cpu_env(), **env}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return dict(line.split(" ", 1) for line in out.splitlines())


def _check_all_threads_got_the_library(res, so_path):
    assert res["NONE"] == "0"
    assert res["DISTINCT"] == "1"
    assert res["AGAIN"] == "True"
    assert res["PATH"] == so_path
    assert res["LOADED"] == "[]"


def test_get_lib_from_eight_threads_library_built():
    from genomealignmenttools_tpu_torch import native
    assert native.get_lib() is not None      # built now, if it was not
    _check_all_threads_got_the_library(_finish(_start("-")), native._SO)


def test_get_lib_from_eight_threads_nothing_built(tmp_path):
    """An empty build directory, and two processes of eight threads each
    building into it at once: every thread of both gets the one loaded
    library of its process, none gets None, and no temporary is left."""
    build_dir = str(tmp_path / "build")
    procs = [_start(build_dir) for _ in range(2)]
    so_path = os.path.join(build_dir, "libgatnative.so")
    for res in [_finish(p) for p in procs]:
        _check_all_threads_got_the_library(res, so_path)
    assert os.listdir(build_dir) == ["libgatnative.so"]


def test_gat_native_0_disables_the_library():
    res = _finish(_start("-", GAT_NATIVE="0"))
    assert res["NONE"] == "8" and res["AGAIN"] == "True"


def test_gat_native_so_names_a_prebuilt_library(tmp_path):
    """GAT_NATIVE_SO keeps its meaning: that file is loaded, nothing is
    built (the build directory stays empty)."""
    import shutil

    from genomealignmenttools_tpu_torch import native
    assert native.get_lib() is not None
    prebuilt = str(tmp_path / "prebuilt.so")
    shutil.copy(native._SO, prebuilt)
    build_dir = str(tmp_path / "build")
    res = _finish(_start(build_dir, GAT_NATIVE_SO=prebuilt))
    _check_all_threads_got_the_library(res, prebuilt)
    assert not os.path.exists(build_dir)


def test_native_sources_are_found_beside_the_loader():
    """The loader finds its sources by __file__: all eleven (the
    reference's ten and the port's own chainpairs.cpp), in the port's own
    native/ directory, and the library goes to the port's build/."""
    from genomealignmenttools_tpu_torch import _build, native
    here = os.path.join(REPO, "genomealignmenttools_tpu_torch", "native")
    assert len(native._SRCS) == 11
    assert os.path.join(here, "chainpairs.cpp") in native._SRCS
    assert all(os.path.dirname(s) == here and os.path.exists(s)
               for s in native._SRCS)
    assert os.path.dirname(native._SO) == _build.BUILD_DIR


@pytest.mark.parametrize("name", ["gat_pack_pairs_scored",
                                  "gat_block_scores_direct",
                                  "gat_subset_scores", "gat_combine_scores",
                                  "gat_band_ext_batch"])
def test_library_exports_what_the_port_calls(name):
    from genomealignmenttools_tpu_torch.native import get_lib
    assert hasattr(get_lib(), name)
