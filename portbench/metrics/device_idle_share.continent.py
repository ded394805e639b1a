"""The card's idle share of one traced `predict_continent` pass, in %."""

from portbench.readers import idle_share_pct as read  # noqa: F401
