"""Build the port's CUDA kernels at first use and load them with ctypes.

Same pattern as genomealignmenttools_tpu/native/__init__.py:31-58 (g++ at
first use, loaded with ctypes), with nvcc for Hopper: each `csrc/*.cu`
(K1 in rescore.cu, K2 in combine.cu, K3 in band.cu) compiles to an object,
one nvcc per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC -Xptxas -v -o build/<source>.o csrc/<source>.cu

and one more nvcc links the objects into one shared library with a plain C
interface, build/libgat_torch_kernels.so.  No PyTorch header is included, so
a build takes seconds.  The library is rebuilt when a source is newer than
it.  A failed build raises; there is no fallback.  The build directory is
`build/` inside this package (gitignored); the compilers' output (ptxas
register and shared-memory counts) is kept beside the library in
`build.log`.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libgat_torch_kernels.so")
LOG_PATH = os.path.join(BUILD_DIR, "build.log")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib = None
# seconds the last build in this process took (None: nothing was built)
last_build_seconds: float | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH);"
                           " the CUDA kernels cannot be built")
    return found


def build() -> str:
    """Compile every csrc/*.cu into LIB_PATH; returns the compilers' output."""
    global last_build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    t0 = time.monotonic()
    objs, cmds = [], []
    for src in srcs:
        name = os.path.splitext(os.path.basename(src))[0]
        objs.append(os.path.join(BUILD_DIR, f"{name}.{tag}.o"))
        cmds.append([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
                     "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", objs[-1],
                     src])
    tmp = f"{LIB_PATH}.{tag}.tmp"
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        results = [(cmd, p.communicate()[0], p.returncode)
                   for cmd, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in results):
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            results.append((cmd, res.stdout, res.returncode))
        log = "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in results)
        with open(LOG_PATH, "w") as f:
            f.write(log)
        failed = [rc for _, _, rc in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    last_build_seconds = time.monotonic() - t0
    return log


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if missing or older than a source."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        build()
    lib = ctypes.CDLL(LIB_PATH)
    p = ctypes.c_void_p
    lib.gat_rescore_chunks.restype = ctypes.c_int
    lib.gat_rescore_chunks.argtypes = [
        p, p,                                 # t codes, q codes (uint8, device)
        ctypes.POINTER(ctypes.c_int32),       # 5x5 LUT (host)
        p, p, p,                              # t_off, q_off (int64), len (int32)
        ctypes.c_int64,                       # number of chunks
        p,                                    # out (int32, device)
        p,                                    # cudaStream_t
    ]
    lib.gat_pair_combine.restype = ctypes.c_int
    lib.gat_pair_combine.argtypes = [
        p, p, p,                              # s, bias, flags (int32, device)
        ctypes.c_int64,                       # number of chunks
        p, p,                                 # c, w (int32, device)
        p,                                    # scratch (int32, device)
        p,                                    # cudaStream_t
    ]
    lib.gat_pair_combine_scratch.restype = ctypes.c_int64
    lib.gat_pair_combine_scratch.argtypes = [ctypes.c_int64]
    lib.gat_band_ext.restype = ctypes.c_int
    lib.gat_band_ext.argtypes = [
        p, p, p, p,                           # a codes, a_off, b codes, b_off
        ctypes.c_int64,                       # number of problems
        ctypes.POINTER(ctypes.c_int32),       # 5x5 matrix (host)
        ctypes.c_int, ctypes.c_int,           # global mode, gap open
        ctypes.c_int, ctypes.c_int,           # gap extend, max insert
        p, p,                                 # parents (uint8), centres
        p, p,                                 # meta (int32), moves (uint8)
        p,                                    # cudaStream_t
    ]
    lib.gat_cuda_error_string.restype = ctypes.c_char_p
    lib.gat_cuda_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return _lib
