"""Milliseconds the card sat idle while the host was inside the program's
``vc.vocode`` span (the vocoder's conditioning, upsampling and stack),
per ``vc.convert_batch`` call of the traced stretch: the gaps that the
vocoder's dispatch leaves on the card.  The reader of
``vocode_idle_ms_per_call.<kind>``; None where the stretch holds no such
span (a converter without a vocoder, or a program that does not open
it)."""

from benchmark import spans

SPAN = "vc.vocode"


def read(run):
    s = run.summary
    if s is None or spans.count(s, SPAN) == 0:
        return None
    return spans.per_root(
        s, spans.CALL, lambda s: spans.idle_ns_inside(s, SPAN) / 1e6)
