"""The readers of the spans inside RepeatFiller's stages and chainCleaner's
prescore and netting: a mean a call of their phases, nothing where the
program has no such phase."""

import pytest

from benchmark.lib.manifest import Manifest

from conftest import REPO

MAN = Manifest(REPO)


class Run:
    def __init__(self, phases):
        self.calls = [0.5, 0.7, 0.6, 0.9]
        self.phases = phases


PHASES = {"rf: read + harvest": 0.1, "rf: seed": 0.2, "rf: hsp scan": 0.3,
          "rf: band problems": 0.04, "band: DP + fetch": 0.5,
          "rf: gapped finish": 0.36, "rf: chain": 0.8,
          "rf: splice + write": 0.02, "repeatfiller": 2.6,
          "break_loop": 1.2, "cleaner: prescore": 0.4,
          "net+find_breaks": 0.8, "cleaner: net": 0.6, "chainCleaner": 2.7}


@pytest.mark.parametrize("name,seconds", [
    ("rf.seed_s", 0.2), ("rf.hsp_scan_s", 0.3), ("rf.gapped_host_s", 0.4),
    ("rf.chain_s", 0.8), ("rf.io_s", 0.12), ("cleaner.prescore_s", 0.4),
    ("cleaner.netting_s", 0.6)])
def test_span_reader_is_a_mean_a_call(name, seconds):
    reader = MAN.module("metrics", name)
    assert reader.read(Run(PHASES)) == pytest.approx(seconds / 4)
    # a version of the program without these phases: no number, and no
    # error
    assert reader.read(Run({"break_loop": 1.0, "band: orient": 0.1})) \
        is None
    assert reader.read(Run(None)) is None
