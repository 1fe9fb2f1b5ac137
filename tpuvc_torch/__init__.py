"""tpuvc_torch — the PyTorch/CUDA port of tpuvc.

A second package beside the JAX reference ``tpuvc``.  It keeps the old
sub-package names so each module's counterpart is easy to find:

  ops/      framing, Fourier transforms, OLA, transfer codecs, and the six
            hand-written CUDA kernels (events, harmonics with refine_score,
            window, smooth, topk) with their plain PyTorch versions; csrc/
            holds the sources
  dsp/      the WORLD analysis (DIO, StoneMask, Harvest, CheapTrick, D4C)
            and synthesis, with ``dsp/world.py`` as its entry point, and the
            port's copy of the DSP constants
  models/   the VAW-GAN encoder/decoder (inference) and its parameters
  convert/  the batched converter, the main path
  io/, utils/  resampling, the architecture record, the device default

It imports ``torch`` and never ``jax`` or the ``tpuvc`` package.  Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
