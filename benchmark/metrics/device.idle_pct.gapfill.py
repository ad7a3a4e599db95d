"""The share of the traced window in which no operation ran on the card,
in %: one quantity, read by lib/devtrace.idle_pct, named apart for each
end-to-end metric it moves."""

from ..lib.devtrace import idle_pct as read   # noqa: F401
