"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time of a piece of
work on it."""

# 3.35 TB/s of HBM3; 67 TFLOP/s in f32 and 34 TFLOP/s in f64 outside the
# tensor cores (the port pins its f32 products at "highest", so no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12,
            "float16": 67e12}


def least_seconds(nbytes, ops, dtype="float32"):
    """The least time the card could take: bytes read once and written
    once over the HBM rate, or operations over the peak, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])
