"""Model operations of the real frames converted in the window (the
architecture's convolutions and dense layers, ``flops.py``) over the
window times the bf16 dense peak: the model serves in bf16."""

from benchmark.readers import serve_mfu as read  # noqa: F401
