"""Device milliseconds of the layout traffic around the model's
convolutions per ``vc.convert_batch`` call of the traced stretch.

It matches two kinds of device kernel by name:
- cuDNN's layout conversions: names holding ``transposeBlock``,
  ``nchwToNhwc`` or ``nhwcToNchw`` (the NCHW <-> NHWC transposes cuDNN
  makes around its NHWC convolution engines, of inputs, weights and
  outputs) or ``tensorTransformGeneric`` (its generic transform, which it
  runs at a site whose channel count its engine does not take as it is);
- ATen's bfloat16 copies and fills: names holding ``BFloat16`` together
  with ``direct_copy_kernel_cuda`` or ``FillFunctor`` (the strided copies
  of transposed activations: ``F.pad``'s copy of its input, reshapes and
  ``.contiguous()`` of transposed views; ``F.pad``'s zero fills).
The model is the only bfloat16 work on the serving path (analysis and
synthesis run in float32), so the second kind counts the model's copies
and no other stage's.  Casts to bfloat16 (``bfloat16_copy_kernel_cuda``)
are not layout traffic and are not counted.  None where the trace holds
no device events (a run on the CPU) or no call; 0 where none of the
kernels ran.
"""

from benchmark import spans

CONVERSIONS = ("transposeBlock", "nchwToNhwc", "nhwcToNchw",
               "tensorTransformGeneric")
BF16 = "BFloat16"
BF16_OPS = ("direct_copy_kernel_cuda", "FillFunctor")


def matches(name: str) -> bool:
    return (any(c in name for c in CONVERSIONS)
            or (BF16 in name and any(o in name for o in BF16_OPS)))


def _ms(summary):
    return 1e3 * sum(v for k, v in summary.by_name.items() if matches(k))


def read(run):
    return spans.per_root(run.summary, spans.CALL, _ms)
