"""The port's two microbenchmarks, counterparts of the JAX repo's scripts.

  ``compute_only`` ``scripts/compute_only.py``: K calls on the device with
                   no transfer
  ``stages``       ``scripts/bench_stages.py``: the per-stage ablation

Each runs as ``python -m tpuvc_torch.bench.<name>`` with the JAX script's
arguments, on the CUDA card, and raises without one.  The functions behind
them take ``device="cpu"`` for the tests.  They time parts of the call in
isolation; the port's speed end to end is measured by ``benchmark/run.py``.
"""
