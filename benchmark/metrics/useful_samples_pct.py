"""The share of the samples the program analysed that were real audio,
not padding: 100 x ``samples_real`` / ``samples_analysed``, the counters of
``tpuvc_torch.convert.pipeline``, over the whole process (set-up's
warm-up and the window, which draw the same traffic).  None where the
program has no such counters."""

import sys


def read(run):
    pipeline = sys.modules.get("tpuvc_torch.convert.pipeline")
    real = getattr(pipeline, "samples_real", None)
    analysed = getattr(pipeline, "samples_analysed", None)
    if real is None or not analysed:
        return None
    return 100.0 * real / analysed
