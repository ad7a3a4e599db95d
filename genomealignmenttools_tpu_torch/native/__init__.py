"""Native (C++) host runtime components, bound via ctypes.

Built lazily with g++ on first use (no pybind11 in this environment).  Set
GAT_NATIVE=0 to force the pure-python paths.

The sources and this binding are the reference's
(genomealignmenttools_tpu/native/), with two differences in the loader:

- `get_lib()` holds a lock from its first look at `_tried` to the
  assignment of `_lib`.  The reference sets `_tried` before it builds and
  loads, so a second thread (score_chain_file's 2bit prefetch against the
  main thread's chain parse) could see "tried" and get None while the
  first was still inside the build, and the run silently took the python
  paths.
- The library is built into the package's gitignored build/ directory,
  beside the CUDA library, one g++ per source started together, under
  temporary names and moved into place with os.replace, so that processes
  building at once (parallel test workers) never load a half-written
  file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from .._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(BUILD_DIR, "libgatnative.so")
_SRCS = [os.path.join(_DIR, "chaincodec.cpp"),
         os.path.join(_DIR, "pairpack.cpp"),
         os.path.join(_DIR, "twobitdec.cpp"),
         os.path.join(_DIR, "chainblocks.cpp"),
         os.path.join(_DIR, "netsweep.cpp"),
         os.path.join(_DIR, "netwrite.cpp"),
         os.path.join(_DIR, "netscan.cpp"),
         os.path.join(_DIR, "breakloop.cpp"),
         os.path.join(_DIR, "hspscan.cpp"),
         os.path.join(_DIR, "bandext.cpp"),
         os.path.join(_DIR, "chainpairs.cpp")]

_lib = None
_tried = False


_lock = threading.Lock()


def _build() -> bool:
    """One g++ per source, all started together, then the link; every output
    under a name of this process, the library moved into place at the end."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = os.getpid()
    tmp = f"{_SO}.{tag}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in _SRCS]
    flags = ["-O3", "-fPIC", "-std=c++17", "-pthread"]
    try:
        procs = [subprocess.Popen(["g++", *flags, "-c", "-o", o, s],
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL)
                 for s, o in zip(_SRCS, objs)]
        if any(p.wait() != 0 for p in procs):
            return False
        subprocess.run(["g++", *flags, "-shared", "-o", tmp] + objs,
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)


def get_lib():
    """Return the loaded native library, building if needed; None if
    unavailable or disabled.  Thread-safe: every caller waits for the first
    one's build and load."""
    with _lock:
        return _get_lib_locked()


def _get_lib_locked():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("GAT_NATIVE", "1") == "0":
        return None
    # GAT_NATIVE_SO: load a pre-built library instead (e.g. the
    # -fsanitize=thread build from tools/tsan_check.sh)
    so = os.environ.get("GAT_NATIVE_SO", _SO)
    if so == _SO:
        newest_src = max(os.path.getmtime(s) for s in _SRCS)
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest_src:
            if not _build():
                return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    class ChainArrays(ctypes.Structure):
        _fields_ = [
            ("n_chains", ctypes.c_int64),
            ("scores", ctypes.POINTER(ctypes.c_double)),
            ("header_nums", ctypes.POINTER(ctypes.c_int64)),
            ("q_strands", ctypes.POINTER(ctypes.c_uint8)),
            ("name_offsets", ctypes.POINTER(ctypes.c_int64)),
            ("name_blob", ctypes.c_char_p),
            ("n_blocks", ctypes.c_int64),
            ("block_offsets", ctypes.POINTER(ctypes.c_int64)),
            ("blocks", ctypes.POINTER(ctypes.c_int64)),
            ("t_name_ids", ctypes.POINTER(ctypes.c_int32)),
            ("q_name_ids", ctypes.POINTER(ctypes.c_int32)),
            ("n_uniq_names", ctypes.c_int64),
            ("uniq_name_off", ctypes.POINTER(ctypes.c_int64)),
            ("uniq_name_blob", ctypes.c_char_p),
            ("error", ctypes.c_char * 256),
        ]

    lib.ChainArrays = ChainArrays
    lib.gat_chain_parse.restype = ctypes.POINTER(ChainArrays)
    lib.gat_chain_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gat_chain_free.argtypes = [ctypes.POINTER(ChainArrays)]
    lib.gat_chain_serialize.restype = ctypes.POINTER(ctypes.c_char)
    lib.gat_chain_serialize.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gat_chain_serialize_ord.restype = ctypes.POINTER(ctypes.c_char)
    lib.gat_chain_serialize_ord.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gat_free_buffer.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.gat_pack_pairs.restype = None
    lib.gat_pack_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.gat_pack_pairs_combined.restype = None
    lib.gat_pack_pairs_combined.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.gat_pack_pairs_scored4.restype = None
    lib.gat_pack_pairs_scored4.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.gat_pack_pairs_scored.restype = None
    lib.gat_pack_pairs_scored.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int,
    ]
    lib.gat_chunk_scores_host.restype = None
    lib.gat_chunk_scores_host.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int,
    ]
    lib.gat_block_scores_direct.restype = None
    lib.gat_block_scores_direct.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
    ]
    lib.gat_segment_sum.restype = None
    lib.gat_segment_sum.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gat_combine_scores.restype = None
    lib.gat_combine_scores.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gat_subset_scores.restype = None
    lib.gat_subset_scores.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ]
    class GatBreakLoopResult(ctypes.Structure):
        _fields_ = [
            ("n_removals", ctypes.c_int64),
            ("rem_i", ctypes.POINTER(ctypes.c_int64)),
            ("rem_d", ctypes.POINTER(ctypes.c_double)),
            ("sus_off", ctypes.POINTER(ctypes.c_int64)),
            ("sus_blocks", ctypes.POINTER(ctypes.c_int64)),
            ("final_scores", ctypes.POINTER(ctypes.c_double)),
            ("score_set", ctypes.POINTER(ctypes.c_uint8)),
            ("rescored", ctypes.POINTER(ctypes.c_double)),
            ("rescored_set", ctypes.POINTER(ctypes.c_uint8)),
            ("error", ctypes.c_char * 256),
        ]

    lib.GatBreakLoopResult = GatBreakLoopResult
    lib.gat_break_loop.restype = ctypes.POINTER(GatBreakLoopResult)
    lib.gat_break_loop.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    ]
    lib.gat_break_loop_free.restype = None
    lib.gat_break_loop_free.argtypes = [ctypes.POINTER(GatBreakLoopResult)]

    class GatHspBlocks(ctypes.Structure):
        _fields_ = [
            ("n", ctypes.c_int64),
            ("rows", ctypes.POINTER(ctypes.c_int64)),
            ("error", ctypes.c_char * 256),
        ]

    lib.GatHspBlocks = GatHspBlocks
    lib.gat_hsp_scan.restype = ctypes.POINTER(GatHspBlocks)
    lib.gat_hsp_scan.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    lib.gat_hsp_free.restype = None
    lib.gat_hsp_free.argtypes = [ctypes.POINTER(GatHspBlocks)]

    class GatBandResults(ctypes.Structure):
        _fields_ = [
            ("n", ctypes.c_int64),
            ("ok", ctypes.POINTER(ctypes.c_int32)),
            ("a_best", ctypes.POINTER(ctypes.c_int64)),
            ("b_best", ctypes.POINTER(ctypes.c_int64)),
            ("sym_off", ctypes.POINTER(ctypes.c_int64)),
            ("sym_a", ctypes.POINTER(ctypes.c_uint8)),
            ("sym_b", ctypes.POINTER(ctypes.c_uint8)),
            ("error", ctypes.c_char * 256),
        ]

    lib.GatBandResults = GatBandResults
    lib.gat_band_ext_batch.restype = ctypes.POINTER(GatBandResults)
    lib.gat_band_ext_batch.argtypes = [
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int,
    ]
    lib.gat_band_ext_free.restype = None
    lib.gat_band_ext_free.argtypes = [ctypes.POINTER(GatBandResults)]

    lib.gat_twobit_decode.restype = None
    lib.gat_twobit_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.gat_revcomp_codes.restype = None
    lib.gat_revcomp_codes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.gat_chain_blocks.restype = ctypes.c_int64
    lib.gat_chain_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
    ]
    class GatNetResult(ctypes.Structure):
        _fields_ = [
            ("t_n_nodes", ctypes.c_int64),
            ("t_nodes", ctypes.POINTER(ctypes.c_int64)),
            ("t_n_chroms", ctypes.c_int64),
            ("t_chrom_seg", ctypes.POINTER(ctypes.c_int64)),
            ("q_n_nodes", ctypes.c_int64),
            ("q_nodes", ctypes.POINTER(ctypes.c_int64)),
            ("q_n_chroms", ctypes.c_int64),
            ("q_chrom_seg", ctypes.POINTER(ctypes.c_int64)),
            ("error", ctypes.c_char * 256),
            ("state", ctypes.c_void_p),
        ]

    lib.GatNetResult = GatNetResult
    lib.gat_net_sweep.restype = ctypes.POINTER(GatNetResult)
    lib.gat_net_sweep.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.gat_net_sweep_sides.restype = ctypes.POINTER(GatNetResult)
    lib.gat_net_sweep_sides.argtypes = \
        lib.gat_net_sweep.argtypes + [ctypes.c_int64]
    lib.gat_net_free.argtypes = [ctypes.POINTER(GatNetResult)]

    class GatNetScan(ctypes.Structure):
        _fields_ = [
            ("n_nodes", ctypes.c_int64),
            ("nodes", ctypes.POINTER(ctypes.c_int64)),
            ("n_nets", ctypes.c_int64),
            ("name_blob", ctypes.POINTER(ctypes.c_char)),
            ("name_off", ctypes.POINTER(ctypes.c_int64)),
            ("error", ctypes.c_char * 256),
            ("state", ctypes.c_void_p),
        ]

    lib.GatNetScan = GatNetScan
    lib.gat_net_scan.restype = ctypes.POINTER(GatNetScan)
    # POINTER(c_char) (not c_char_p) so any buffer — bytes or a zero-copy
    # ctypes view over a memoryview/ndarray — is accepted.
    lib.gat_net_scan.argtypes = [ctypes.POINTER(ctypes.c_char),
                                 ctypes.c_int64]
    lib.gat_net_scan_free.argtypes = [ctypes.POINTER(GatNetScan)]

    class GatBreaks(ctypes.Structure):
        _fields_ = [
            ("n_breaks", ctypes.c_int64),
            ("breaks", ctypes.POINTER(ctypes.c_int64)),
            ("n_nets", ctypes.c_int64),
            ("name_blob", ctypes.POINTER(ctypes.c_char)),
            ("name_off", ctypes.POINTER(ctypes.c_int64)),
            ("error", ctypes.c_char * 256),
            ("state", ctypes.c_void_p),
        ]

    lib.GatBreaks = GatBreaks
    lib.gat_find_breaks.restype = ctypes.POINTER(GatBreaks)
    lib.gat_find_breaks.argtypes = [ctypes.POINTER(ctypes.c_char),
                                    ctypes.c_int64]
    lib.gat_find_breaks_free.argtypes = [ctypes.POINTER(GatBreaks)]

    _i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gat_breaks_from_sweep.restype = ctypes.POINTER(GatBreaks)
    lib.gat_breaks_from_sweep.argtypes = [
        _i64p, ctypes.c_int64,            # nodes, n_nodes
        _i64p, ctypes.c_int64,            # segs, n_segs
        ctypes.c_char_p, _i64p,           # chrom_blob, chrom_off
        _i64p,                            # headers (n_chains, 5)
        _i64p, _i64p, ctypes.c_int64,     # blocks, chain_off, n_chains
        _i64p, ctypes.POINTER(ctypes.c_double),  # ids, scores
        ctypes.c_double, ctypes.c_int64,  # min_score, min_fill
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # set 1
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # set 2
    ]

    lib.gat_net_write.restype = ctypes.POINTER(ctypes.c_char)
    lib.gat_net_write.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gat_netfilter12.restype = ctypes.POINTER(ctypes.c_char)
    lib.gat_netfilter12.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gat_expand_blocks.restype = None
    lib.gat_expand_blocks.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = lib
    return _lib
