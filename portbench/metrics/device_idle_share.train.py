"""The card's idle share of five traced training steps, in %."""

from portbench.readers import idle_share_pct as read  # noqa: F401
