"""The host's waits for the card (CUDA API events whose names end in
``Synchronize``: a pageable copy's, a ``.cpu()``'s) inside the program's
``vc.convert_batch`` spans, per call of the traced stretch."""

from benchmark import spans


def read(run):
    return spans.per_root(
        run.summary, spans.CALL,
        lambda s: spans.count_inside(s, spans.SYNC, spans.CALL))
