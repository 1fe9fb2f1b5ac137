"""Device milliseconds of the fused-route model kernels, K8 and K9 (the
device kernels that ``roofline/conv_d2s.py`` names), per
``vc.convert_batch`` call of the traced stretch.  None where they did not
run (the default route)."""

from benchmark import common, spans

NAMES = common.load_module("roofline", "conv_d2s").DEVICE_NAMES


def _ms(summary):
    return 1e3 * summary.device_seconds(NAMES)


def read(run):
    if run.summary is None or _ms(run.summary) == 0:
        return None
    return spans.per_root(run.summary, spans.CALL, _ms)
