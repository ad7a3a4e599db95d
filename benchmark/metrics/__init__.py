"""One reader a metric, named as the metric: `read(run) -> float | None`.

`run` (run.py's Record) holds setup_s, first_call_s, the window's call
seconds (`calls`, `calls_at`), the work units of one call (`units`), the
port's phase totals and intervals over the window (`phases`, `intervals`;
traced runs), the device trace (`trace`; traced runs on the card) and the
window's bounds (`w0`, `w1`).  A reader that finds nothing to read returns
None and the metric is left out of the line."""
