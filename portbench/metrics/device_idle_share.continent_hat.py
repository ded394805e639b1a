"""The card's idle share of one traced HAT `predict_continent` pass, in %."""

from portbench.readers import idle_share_pct as read  # noqa: F401
