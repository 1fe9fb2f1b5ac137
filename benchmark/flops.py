"""Model operations worked out from the architecture's published shapes.

Counted: every convolution and dense layer as 2 multiply-adds' worth per
product (2 K Cin per output value); the depth-to-space steps are
reshapes, and LayerNorm, LeakyReLU and the losses are left out, so the
count is a floor of what any implementation must do.  One frame is one
513-bin envelope.
"""

from __future__ import annotations

from benchmark.reference.arch import Architecture, NetSpec


def _stack(spec: NetSpec, length: int, cin: int) -> tuple[int, int, int]:
    """(operations, output length, output channels) of a strided stack."""
    ops = 0
    for k, s, c in zip(spec.kernel, spec.stride, spec.output):
        length = -(-length // s)
        ops += 2 * k * cin * c * length
        cin = c
    return ops, length, cin


def encoder_per_frame(arch: Architecture) -> int:
    ops, length, c = _stack(arch.encoder, arch.x_dim, 1)
    return ops + 2 * (2 * length * c * arch.z_dim)     # mu and log-var


def decoder_per_frame(arch: Architecture) -> int:
    g = arch.generator
    base = 19                                           # models/vae.py
    ops = 2 * (arch.z_dim + arch.y_emb_dim) * base * g.output[0]
    length, cin = base, g.output[0]
    for k, s, c in zip(g.kernel, g.stride, g.output):
        ops += 2 * k * cin * (c * s) * length           # stride-1 conv
        length, cin = length * s, c                     # depth to space
    return ops


def critic_per_frame(arch: Architecture) -> int:
    ops, length, c = _stack(arch.discriminator, arch.x_dim, 1)
    flat = length * c
    ops += 2 * flat                                     # score
    if arch.d_conditional:
        ops += 2 * flat * arch.y_emb_dim                # projection
    return ops


def generator_per_frame(arch: Architecture) -> int:
    """One served frame: encode, decode."""
    return encoder_per_frame(arch) + decoder_per_frame(arch)


def vawgan_step(arch: Architecture) -> int:
    """One VAW-GAN step at the architecture's batch: ``n_unroll`` critic
    updates, each a generator forward without gradients (F_g), the
    critic on real and generated rows with the backward to its weights
    (3 F_c each) and the gradient penalty (forward, the input gradient,
    and the double backward through both: 6 F_c); then the generator
    update (forward 3 F_g with its backward, the critic's forward and
    its input gradient 2 F_c)."""
    t = arch.training
    fg = t.batch_size * generator_per_frame(arch)
    fc = t.batch_size * critic_per_frame(arch)
    return t.n_unroll * (fg + 12 * fc) + 3 * fg + 2 * fc
