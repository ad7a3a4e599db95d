"""Verbose logging with reference-compatible semantics.

Mirrors kent verbose.c (reference kent/src/lib/verbose.c:19-140): a global
verbosity level (default 1), `verbose(level, msg)` printing to stderr (or a
log file) iff level <= verbosity, with immediate flush; `verbose_time` step
timers ("label: N millis"); and `print_mem` reading /proc/self/stat exactly
like chainCleaner.c printMem (src/chainCleaner/chainCleaner.c:348-361,
"memory usage %s, utime %s s/100, stime %s").

Every CLI tool accepts the kent-global `-verbose=N` flag
(kent/src/lib/options.c optionInit installs it for all tools).
"""

from __future__ import annotations

import sys
import time

_level = 1
_log_file = None
_last_time: float | None = None


def set_verbosity(level: int) -> None:
    global _level
    _level = int(level)


def verbosity() -> int:
    return _level


def set_log_file(path_or_file) -> None:
    """Redirect verbose output (verboseSetLogFile equivalent)."""
    global _log_file
    if isinstance(path_or_file, str):
        _log_file = open(path_or_file, "w")
    else:
        _log_file = path_or_file


def _out():
    return _log_file if _log_file is not None else sys.stderr


def verbose(level: int, msg: str) -> None:
    """Write msg (no newline appended - callers include it, as in C) to the
    log when the global verbosity is >= level."""
    if level <= _level:
        f = _out()
        f.write(msg)
        f.flush()


def verbose_time_init() -> None:
    global _last_time
    _last_time = time.monotonic()


def verbose_time(level: int, label: str) -> None:
    """Print label and millis since the previous verbose_time call
    (verboseTime, verbose.c:44-63)."""
    global _last_time
    now = time.monotonic()
    if _last_time is None:
        _last_time = now
    verbose(level, "%s: %d millis\n" % (label, int((now - _last_time) * 1000)))
    _last_time = now


def print_mem() -> None:
    """Memory/cpu summary from /proc/self/stat, field-compatible with the
    reference's printMem (chainCleaner.c:348-361: vsize bytes, utime and
    stime in clock ticks)."""
    try:
        with open("/proc/self/stat") as f:
            words = f.readline().split()
    except OSError:
        return
    if len(words) >= 23:
        verbose(1, "memory usage %s, utime %s s/100, stime %s\n"
                % (words[22], words[13], words[14]))


def pop_verbose_flag(opts: dict) -> None:
    """Consume a kent-global -verbose=N option out of a parsed opts dict."""
    v = opts.pop("verbose", None)
    if v not in (None, ""):
        set_verbosity(int(v))
