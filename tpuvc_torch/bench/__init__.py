"""The port's measurement entry points, counterparts of the JAX repo's.

  ``bench_torch.py`` (root) / ``throughput``  ``bench.py``: audio s per
                   wall s of the batched converter, three pipelined
                   dispatch strategies, the int16 / pcm12 drains and their
                   SNRs in ``both`` mode
  ``harvest``      ``scripts/bench_harvest.py``: the Harvest path's rate
  ``streaming``    ``scripts/bench_streaming.py``: per-chunk walls and a
                   real-time-paced multi-stream tick loop
  ``compute_only`` ``scripts/compute_only.py``: K calls on the device with
                   no transfer
  ``stages``       ``scripts/bench_stages.py``: the per-stage ablation

Each runs as ``python -m tpuvc_torch.bench.<name>`` with the JAX script's
arguments, on the CUDA card, and raises without one.  The functions behind
them take ``device="cpu"`` for the tests.
"""
