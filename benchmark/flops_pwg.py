"""Parallel WaveGAN's operations per waveform sample, worked out from the
configuration's ``vocoder`` block as ``flops.py`` counts the model's:
every convolution as 2 K Cin Cout per output position, the gates, the
adds and the stretches left out, so the count is a floor of what any
implementation must do.

Per sample: the first 1x1 (1 -> residual), per layer the dilated
convolution (residual -> gate, K taps), the conditioning's 1x1 (aux ->
gate), the skip and the residual 1x1s (gate/2 -> skip, gate/2 ->
residual), and the two output 1x1s (skip -> skip -> 1).  The upsampling
net's ``conv_in`` (aux -> aux, 2w + 1 taps) runs once a frame, its time
filters (2s + 1 taps over every aux channel) once a position of their
own rate: both are spread over the hop's samples.
"""

from __future__ import annotations

import math


def stack_per_sample(voc: dict) -> int:
    res, gate = voc["residual_channels"], voc["gate_channels"]
    skip, aux = voc["skip_channels"], voc["aux_channels"]
    layer = 2 * (voc["kernel_size"] * res * gate + aux * gate
                 + (gate // 2) * (skip + res))
    return 2 * res + voc["layers"] * layer + 2 * (skip * skip + skip)


def upsample_per_sample(voc: dict) -> float:
    aux, scales = voc["aux_channels"], voc["upsample_scales"]
    hop = math.prod(scales)
    ops = 2 * (2 * voc["aux_context_window"] + 1) * aux * aux   # a frame
    rate = 1
    for s in scales:
        rate *= s
        ops += rate * 2 * (2 * s + 1) * aux                       # a frame
    return ops / hop


def per_sample(voc: dict) -> float:
    """The generator's operations per output sample."""
    return stack_per_sample(voc) + upsample_per_sample(voc)
