"""Share of the traced window in which no kernel, copy or fill ran."""

from portbench.readers import idle_share as read  # noqa: F401
