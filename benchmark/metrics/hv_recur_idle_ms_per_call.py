"""Milliseconds the card sat idle while the host was inside Harvest's
``hv_recur`` spans (the contour's blocked recurrences: two jump removals,
two forward fills and two biquads a Harvest call, each an in-block loop
and a loop over the blocks), summed over them, per ``vc.convert_batch``
call of the traced stretch.  The reader of
``hv_recur_idle_ms_per_call.<kind>``; None where the stretch holds no
such span (a DIO cell, or a program that does not open it)."""

from benchmark import spans

SPAN = "hv_recur"


def read(run):
    s = run.summary
    if s is None or spans.count(s, SPAN) == 0:
        return None
    return spans.per_root(
        s, spans.CALL, lambda s: spans.idle_ns_inside(s, SPAN) / 1e6)
