"""tpuvc_torch — the PyTorch/CUDA port of tpuvc.

A second package beside the JAX reference ``tpuvc``.  It keeps the old
sub-package names so each module's counterpart is easy to find:

  ops/      framing, Fourier transforms, OLA, transfer codecs, and the
            hand-written CUDA kernels (events with the fused block scans,
            harmonics with refine_score, window, smooth, topk, the fused
            conv + LayerNorm + LeakyReLU and depth-to-space + LayerNorm +
            LeakyReLU layers, the contour's extension passes, the model's
            other LayerNorm + LeakyReLU pairs) with their plain PyTorch
            versions; csrc/ holds the sources
  dsp/      the WORLD analysis (DIO, StoneMask, Harvest, CheapTrick, D4C)
            and synthesis, with ``dsp/world.py`` as its entry point, and the
            port's copy of the DSP constants
  models/   the VAW-GAN encoder/decoder (both kernel routes of the
            architecture), its critic, the losses and the parameters
  convert/  the batched converter (the main path), f0 statistics and the
            streaming converters
  train/    the VAE and VAW-GAN training steps, trainers (streaming and
            device-resident), checkpoints and metrics
  data/, cli/  corpus analysis (``python -m tpuvc_torch.cli.analyze``),
            training (``python -m tpuvc_torch.cli.train``), the frame
            dataset, the synthetic corpus and the Tanhize normalizer
  io/, utils/  WAV I/O and resampling, the .bin records and the corpus
            layout, the architecture record, the device default, run
            directories, spectrogram images, the train CLI's profiler
            trace and the stage spans (``utils/profiling.span``) that
            name the serving path's, the streaming tick's and the
            trainer's stages in a profile

It imports ``torch`` and never ``jax`` or the ``tpuvc`` package.  Its
entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
