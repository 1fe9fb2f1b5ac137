"""Device milliseconds of the model's LayerNorm forward kernels per
``vc.convert_batch`` call of the traced stretch: ATen's (its vectorized
kernel, and the moments + forward pair of its other path) and K11's
(``csrc/norm.cu``).  K8 and K9, which normalise inside their own kernels,
are not counted.  None where none of them ran."""

from benchmark import spans

NAMES = ("vectorized_layer_norm_kernel", "RowwiseMomentsCUDAKernel",
         "LayerNormForwardCUDAKernel", "norm_lrelu_rows_kernel",
         "norm_lrelu_slab_kernel", "norm_lrelu_any_kernel")


def _ms(summary):
    return 1e3 * summary.device_seconds(NAMES)


def read(run):
    if run.summary is None or _ms(run.summary) == 0:
        return None
    return spans.per_root(run.summary, spans.CALL, _ms)
