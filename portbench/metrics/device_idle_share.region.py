"""The card's idle share of fifty traced `predict` requests, in %."""

from portbench.readers import idle_share_pct as read  # noqa: F401
