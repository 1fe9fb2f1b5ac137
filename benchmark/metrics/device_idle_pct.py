"""Share of the traced window in which no kernel, copy or set ran on
the card (100 minus the union of their intervals); the reader of
``device_idle_pct.<kind>`` in every kind of cell."""

from benchmark.readers import idle_pct as read  # noqa: F401
