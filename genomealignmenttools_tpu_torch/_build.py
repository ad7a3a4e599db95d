"""Build the port's CUDA kernels at first use and load them with ctypes.

Same pattern as genomealignmenttools_tpu/native/__init__.py:31-58 (g++ at
first use, loaded with ctypes), with nvcc for Hopper: each `csrc/*.cu`
(K1 in rescore.cu, K2 in combine.cu, K3 in band.cu, K4 in hspscan.cu) compiles to an object,
one nvcc per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC -Xptxas -v -o build/<source>.o csrc/<source>.cu

and one more nvcc links the objects into one shared library with a plain C
interface, build/libgat_torch_kernels.so.  No PyTorch header is included, so
a build takes seconds.  The library is rebuilt when a source or header is
newer than it.  A failed build raises; there is no fallback.  The build
directory is `build/` inside this package (gitignored); the compilers'
output (ptxas register and shared-memory counts) is kept beside the library
in `build.log`.

Two copies of the same sources serve sanitize.py, each in a directory of its
own under build/, with the flags above plus
    lineinfo   -lineinfo                (compute-sanitizer names source lines)
    checked    -lineinfo -DGAT_CHECKED  (the kernels' own checks, check.cuh)
`use_variant(name)` makes load_library() load one of them; it must come
before the first load.  The library the port loads keeps its flags.
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
# the extra nvcc flags of each copy of the kernels; "" is the port's own
VARIANTS = {"": (), "lineinfo": ("-lineinfo",),
            "checked": ("-lineinfo", "-DGAT_CHECKED")}

_lib = None
_variant = ""
# seconds the last build in this process took (None: nothing was built)
last_build_seconds: float | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def lib_path(variant: str = "") -> str:
    """The library of a copy of the kernels (VARIANTS)."""
    if variant not in VARIANTS:
        raise ValueError(f"no kernel build {variant!r}; one of {list(VARIANTS)}")
    if not variant:
        return LIB_PATH
    return os.path.join(BUILD_DIR, variant, os.path.basename(LIB_PATH))


def use_variant(variant: str) -> None:
    """Make load_library() load the copy `variant` of the kernels; raises
    once another copy is loaded in this process."""
    global _variant
    lib_path(variant)
    if _lib is not None and variant != _variant:
        raise RuntimeError(f"the kernel build {_variant or 'of the port'!r} "
                           f"is already loaded")
    _variant = variant


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH);"
                           " the CUDA kernels cannot be built")
    return found


def build(variant: str = "") -> str:
    """Compile every csrc/*.cu into lib_path(variant); returns the
    compilers' output."""
    global last_build_seconds
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    out = lib_path(variant)
    out_dir = os.path.dirname(out)
    os.makedirs(out_dir, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    t0 = time.monotonic()
    objs, cmds = [], []
    for src in srcs:
        name = os.path.splitext(os.path.basename(src))[0]
        objs.append(os.path.join(out_dir, f"{name}.{tag}.o"))
        cmds.append([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3",
                     *VARIANTS[variant], "-c", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-o", objs[-1], src])
    tmp = f"{out}.{tag}.tmp"
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
        with open(os.path.join(out_dir, os.path.basename(LOG_PATH)),
                  "w") as f:
            f.write(log)
        failed = [rc for _, _, rc in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    last_build_seconds = time.monotonic() - t0
    return log


def _stale(variant: str = "") -> bool:
    path = lib_path(variant)
    if not os.path.exists(path):
        return True
    built = os.path.getmtime(path)
    return any(os.path.getmtime(s) > built
               for s in glob.glob(os.path.join(SRC_DIR, "*.cu*")))


def load_library() -> ctypes.CDLL:
    """The kernel library of the copy use_variant() chose (the port's own
    unless named), built first if missing or older than a source."""
    global _lib
    if _lib is not None:
        return _lib
    if _stale(_variant):
        build(_variant)
    lib = ctypes.CDLL(lib_path(_variant))
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
        p,                                    # scratch (int64, device)
        p,                                    # cudaStream_t
    ]
    lib.gat_pair_combine_tiles.restype = ctypes.c_int
    lib.gat_pair_combine_tiles.argtypes = [
        p, ctypes.c_int,                      # tiles (int8, device), chunk
        p,                                    # tweak (int32, device) or None
        p, p,                                 # bias, flags (int32, device)
        ctypes.c_int64,                       # number of chunks
        p, p,                                 # c, w (int32, device)
        p,                                    # scratch (int64, device)
        p,                                    # cudaStream_t
    ]
    for entry in ("gat_pair_combine_code", "gat_pair_combine_score4"):
        getattr(lib, entry).restype = ctypes.c_int
        getattr(lib, entry).argtypes = [
            p, ctypes.c_int,                  # tiles (uint8, device), width
            ctypes.POINTER(ctypes.c_int8),    # 25 scores / 16 values (host)
            p,                                # tweak (int32, device) or None
            p, p,                             # bias, flags (int32, device)
            ctypes.c_int64,                   # number of chunks
            p, p,                             # c, w (int32, device)
            p,                                # scratch (int64, device)
            p,                                # cudaStream_t
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
        p, p,                                 # parents (packed), centres
        p, p,                                 # meta (int32), moves (uint8)
        p,                                    # cudaStream_t
    ]
    lib.gat_hsp_best.restype = ctypes.c_int
    lib.gat_hsp_best.argtypes = [
        p, p,                                 # t codes, q codes (uint8, device)
        ctypes.POINTER(ctypes.c_int32),       # 5x5 LUT (host)
        p, p, p,                              # t_start, q_start (int64), len (int32)
        ctypes.c_int64,                       # number of windows
        p,                                    # out (int32, device)
        p,                                    # cudaStream_t
    ]
    lib.gat_band_parent_row_bytes.restype = ctypes.c_int
    lib.gat_band_parent_row_bytes.argtypes = [ctypes.c_int]
    lib.gat_cuda_error_string.restype = ctypes.c_char_p
    lib.gat_cuda_error_string.argtypes = [ctypes.c_int]
    if _variant == "checked":
        lib.gat_check_arm.restype = ctypes.c_int
        lib.gat_check_arm.argtypes = [ctypes.c_int]
        for name in ("gat_check_errors", "gat_check_launches"):
            getattr(lib, name).restype = ctypes.c_ulonglong
            getattr(lib, name).argtypes = []
        lib.gat_check_reports.restype = ctypes.c_char_p
        lib.gat_check_reports.argtypes = []
        lib.gat_check_clear.restype = None
        lib.gat_check_clear.argtypes = []
    _lib = lib
    return _lib
