"""Benchmark: end-to-end conversion throughput of the PyTorch/CUDA port.

The counterpart of ``bench.py`` for ``tpuvc_torch`` on one CUDA card, with
its arguments, defaults and one-line JSON:

    python bench_torch.py [batch] [utterance_s] [encoding]
      encoding: ulaw8 (default) | pcm12 | int16 | both

What each field means: ``tpuvc_torch/bench/throughput.py``.  Without a
CUDA card it raises.
"""

from tpuvc_torch.bench.throughput import main

if __name__ == "__main__":
    main()
