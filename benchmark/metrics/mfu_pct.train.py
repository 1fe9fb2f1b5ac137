"""Operations of every forward and backward pass of the VAW-GAN steps
completed in the window (``flops.vawgan_step``) over the window times the
TF32 dense peak, the configuration's convolution precision."""

from benchmark.readers import train_mfu as read  # noqa: F401
