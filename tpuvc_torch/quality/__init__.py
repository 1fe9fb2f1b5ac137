"""The port's quality studies, counterparts of the JAX repo's scripts.

  ``roundtrip_classes``      ``scripts/roundtrip_classes.py``: analysis ->
                             synthesis -> re-analysis MCD of five signal
                             classes against the analyzer's retest floor
  ``scale_validation``       ``scripts/scale_validation.py``: a 10-speaker
                             corpus through cli.analyze, cli.train,
                             cli.convert --all_pairs and cli.evaluate
  ``convergence_ab``         ``scripts/convergence_ab.py``: resident
                             training to milestones, SF1 -> TM3 quality at
                             each, for the model / decoder-head / critic /
                             alpha A/Bs
  ``critic_conditioning_ab`` ``scripts/critic_conditioning_ab.py``: the
                             critic with and without the speaker code, per
                             step curves

Each runs as ``python -m tpuvc_torch.quality.<name>`` with the JAX script's
arguments, ``--device`` in place of ``--platform``: on the CUDA card
unless ``--device cpu`` is given, raising without a card.  Results go into
``scale_validation_torch.json`` and ``critic_ab_torch.json`` at the root of
the repository (``common.RECORD_PATH``, ``common.CRITIC_AB_PATH``) with
the card they were measured on; corpora and run directories default to
``quality_runs/``.  ``signals`` is the port's copy of the JAX tests'
speech-shaped fixtures.
"""
