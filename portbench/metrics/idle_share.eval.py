"""The device's idle share of a closed evaluation cell's traced window, in %
(``portbench.trace.idle_share``)."""

from portbench.trace import idle_share as read  # noqa: F401
