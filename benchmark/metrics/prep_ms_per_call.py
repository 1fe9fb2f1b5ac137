"""Host milliseconds in the program's ``vc.prep``, ``vc.upload`` and
``vc.noise`` spans (bucketing, padding and stacking the rows, their
copies to the card, the per-row noise generators) per
``vc.convert_batch`` call of the traced stretch."""

from benchmark import spans


def read(run):
    return spans.per_root(
        run.summary, spans.CALL,
        lambda s: spans.host_ns(s, "vc.prep", "vc.upload", "vc.noise") / 1e6)
