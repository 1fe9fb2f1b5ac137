"""Milliseconds the card sat idle while the host was inside the program's
``world.f0`` span (DIO and StoneMask, or Harvest), per ``vc.convert_batch``
call of the traced stretch: the gap that f0's host-launched loops leave on
the card.  The reader of ``f0_idle_ms_per_call.<kind>`` in every serving
cell."""

from benchmark import spans


def read(run):
    return spans.per_root(
        run.summary, spans.CALL,
        lambda s: spans.idle_ns_inside(s, "world.f0") / 1e6)
