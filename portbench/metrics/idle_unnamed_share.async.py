"""Share of the card's idle time in the traced window at whose start
neither a program span nor the harness's source span was open: idle time
that the program cannot put down to any of its layers."""

from portbench.program_spans import idle_unnamed_share as read  # noqa: F401
