"""Share of the conv layers' steps that fell back to the dense update
(``layer_counts[...]["dense_fallbacks"]`` over the layer calls)."""

from portbench.readers import dense_fallback_share as read  # noqa: F401
