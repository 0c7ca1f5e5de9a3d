"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, 700 W)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "float32": 67e12,  # outside the tensor cores
    "tf32": 495e12,
    "int8": 1979e12,
}
