"""Seconds a call of the chainCleaner engine's prescore, inside its break
loop: the phase `cleaner: prescore` (engines/chain_cleaner.py
`_prescore_breaks`, the rescoring of every pending break's sub-chains, its
`rescore: *` phases included), mean over the window's calls."""

PHASES = ("cleaner: prescore",)


def read(run):
    if run.phases is None or not run.calls:
        return None
    found = [run.phases[p] for p in PHASES if p in run.phases]
    if not found:
        return None
    return sum(found) / len(run.calls)
