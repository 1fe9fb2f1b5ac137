"""Milliseconds the card sat idle while the host was inside Harvest's
``hv_merge`` span (the channel candidates and the loop over the channels
of the band bank that merges them), per ``vc.convert_batch`` call of the
traced stretch.  The reader of ``hv_merge_idle_ms_per_call.<kind>``; None
where the stretch holds no such span (a DIO cell)."""

from benchmark import spans

SPAN = "hv_merge"


def read(run):
    s = run.summary
    if s is None or spans.count(s, SPAN) == 0:
        return None
    return spans.per_root(
        s, spans.CALL, lambda s: spans.idle_ns_inside(s, SPAN) / 1e6)
