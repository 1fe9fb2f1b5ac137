"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # float32, outside the tensor cores
TF32_OPS_PER_S = 495e12         # TF32 on the tensor cores
BF16_OPS_PER_S = 989e12         # bf16 on the tensor cores


def bound_s(nbytes: float, ops: float = 0.0, tf32_ops: float = 0.0) -> float:
    """The least time the card takes to move ``nbytes`` and do ``ops``
    float32 operations (plus ``tf32_ops`` on the tensor cores)."""
    return max(nbytes / HBM_BYTES_PER_S,
               ops / FP32_OPS_PER_S + tf32_ops / TF32_OPS_PER_S)
