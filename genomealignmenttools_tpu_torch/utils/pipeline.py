"""Checkpoint/resume pipeline runner (SURVEY §5.4).

The reference has no in-process checkpointing; restartability comes from
every stage being a file (chain -> net -> filtered net ...) plus
re-runnable job scripts (patchChain.perl:202 - each csh job deletes its own
prior outputs first).  This module makes that contract first-class:

- a Pipeline is a sequence of named stages, each declaring input and
  output files plus a callable
- every completed stage records a manifest entry (input/output signatures:
  size + mtime_ns + a cheap head/tail hash) in <work_dir>/MANIFEST.json
- on re-run, a stage whose inputs match its manifest entry and whose
  outputs still match is SKIPPED - so an interrupted pipeline resumes at
  the first incomplete stage, and an input edit invalidates exactly the
  stages downstream of it
- stage callables write to temp paths first; outputs are renamed into
  place only on success, so a crash mid-stage never leaves a
  half-written output that a resume would trust
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

from .verbose import verbose


def _sig(path: str) -> dict | None:
    """Cheap file signature: size, mtime_ns, md5 of first+last 64 KiB."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    h = hashlib.md5()
    with open(path, "rb") as f:
        h.update(f.read(65536))
        if st.st_size > 131072:
            f.seek(-65536, 2)
            h.update(f.read(65536))
    return {"size": st.st_size, "mtime_ns": st.st_mtime_ns,
            "head_tail_md5": h.hexdigest()}


def _sig_match(a: dict | None, b: dict | None) -> bool:
    if a is None or b is None:
        return False
    # mtime changes don't invalidate if size+hash still match (e.g. the
    # file was rewritten identically)
    return (a["size"] == b["size"]
            and a["head_tail_md5"] == b["head_tail_md5"])


@dataclass
class Pipeline:
    work_dir: str
    _manifest: dict = field(default_factory=dict)
    ran: list[str] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.work_dir, exist_ok=True)
        self._mpath = os.path.join(self.work_dir, "MANIFEST.json")
        if os.path.exists(self._mpath):
            try:
                with open(self._mpath) as f:
                    self._manifest = json.load(f)
            except (OSError, ValueError):
                self._manifest = {}

    def path(self, name: str) -> str:
        """A checkpoint file path inside the work dir."""
        return os.path.join(self.work_dir, name)

    def _save(self) -> None:
        tmp = self._mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1)
        os.replace(tmp, self._mpath)

    def stage(self, name: str, inputs: list[str], outputs: list[str],
              fn) -> None:
        """Run fn(tmp_outputs) unless this stage is already complete.

        fn receives a list of temp paths (one per output) to write; they
        are atomically renamed to `outputs` on success."""
        entry = self._manifest.get(name)
        if entry is not None:
            in_ok = all(_sig_match(_sig(p), entry["inputs"].get(p))
                        for p in inputs)
            out_ok = all(_sig_match(_sig(p), entry["outputs"].get(p))
                         for p in outputs)
            if in_ok and out_ok:
                verbose(1, "[pipeline] %s: up to date, skipping\n" % name)
                self.skipped.append(name)
                return
        verbose(1, "[pipeline] %s: running\n" % name)
        tmps = [p + ".inprogress" for p in outputs]
        fn(tmps)
        for tmp, out in zip(tmps, outputs):
            os.replace(tmp, out)
        self._manifest[name] = {
            "inputs": {p: _sig(p) for p in inputs},
            "outputs": {p: _sig(p) for p in outputs},
        }
        self._save()
        self.ran.append(name)
