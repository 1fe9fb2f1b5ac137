"""K8 and K9, the fused-route model kernels: the encoder's strided conv +
LayerNorm + LeakyReLU layers (K8) and the decoder's depth-to-space +
LayerNorm + LeakyReLU steps (K9), counted over every site of one model
call of the rows the reference converts.

Only where the architecture takes the fused routes (``conv_impl`` /
``d2s_impl`` "pallas"); on the default route the count is zero and the
kernels' share is left out.  The sites' shapes follow from the
architecture and the frames (B x (T // hop + 1) of the padded rows):

- K8 per encoder layer: its input (the compute type at layer 1, float32
  after, as the kernel writes float32), the weights, bias, gamma and beta,
  and the output written once; 8 float32 operations per output value for
  the epilogue; the products (2 K Cin per output value) as three TF32
  products each where Cin is a multiple of 16 (the tensor-core route,
  layers 2-5), as float32 ones otherwise (layer 1's row kernel, Cin 1).
- K9 per stride-s decoder step but the last: the [N, L, c s] input read
  once and the output written once in the compute type, gamma and beta;
  8 float32 operations per value.

The sites' bytes and operations are summed, so the least time is that of
the sums: a floor of the sum of each site's own (``chip_smoke.py``'s
record of the sites), below it where operations bound some sites and
bytes others (K8's layers 4-5 against the rest).
"""

from benchmark.reference.model import Decoder

DEVICE_NAMES = ("conv_ln_lrelu_kernel", "conv_ln_lrelu_row_kernel",
                "conv_ln_lrelu_tc_kernel", "split_tf32_kernel",
                "d2s_ln_lrelu_kernel")
REFERENCE = ("convert.convert_rows",)
OPS_LN_VALUE = 8
TC_CIN = 16              # csrc/conv.cu: kTcBK, the tensor-core route's chunk
_SIZES = {"float32": 4, "bfloat16": 2}


def conv_sites(arch, frames: int) -> list[tuple[float, float, float]]:
    """(bytes, float32 operations, TF32 operations) of each K8 site, one
    per encoder layer."""
    e = _SIZES[arch.compute_dtype]
    length, cin, out = arch.x_dim, 1, []
    for k, s, cout in zip(arch.encoder.kernel, arch.encoder.stride,
                          arch.encoder.output):
        l_out = -(-length // s)
        n_out = frames * l_out * cout
        nbytes = e * frames * length * cin + 4 * (k * cin * cout + 3 * cout
                                                  + n_out)
        products = 2 * k * cin * n_out
        if cin % TC_CIN == 0:
            out.append((nbytes, OPS_LN_VALUE * n_out, 3 * products))
        else:
            out.append((nbytes, OPS_LN_VALUE * n_out + products, 0))
        length, cin, e = l_out, cout, 4
    return out


def d2s_sites(arch, frames: int) -> list[tuple[float, float, float]]:
    """(bytes, float32 operations, TF32 operations) of each K9 site."""
    e = _SIZES[arch.compute_dtype]
    g = arch.generator
    length, out = Decoder.base_len, []
    for i, (s, c) in enumerate(zip(g.stride, g.output)):
        if s > 1 and i < len(g.stride) - 1:
            n = frames * length * c * s
            out.append((e * (2 * n + 2 * c), OPS_LN_VALUE * n, 0))
        length *= s
    return out


def sites(arch, frames: int) -> list[tuple[float, float, float]]:
    """The fused-route sites of one model call over ``frames``."""
    return ((conv_sites(arch, frames) if arch.conv_impl == "pallas" else [])
            + (d2s_sites(arch, frames) if arch.d2s_impl == "pallas" else []))


def work(model, xs, y_trg, xmin, xmax, mu_s, sd_s, mu_t, sd_t, noise, cfg,
         feature_dtype=None, out=None):
    """(bytes, float32 ops, TF32 ops) of one ``convert_rows`` call: one
    model call over every frame of the padded rows ``xs`` [B, T]."""
    frames = xs.shape[0] * (xs.shape[1] // cfg.hop + 1)
    parts = sites(model.arch, frames)
    return tuple(sum(p[i] for p in parts) for i in range(3))
