"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick of every roofline
share the benchmark reports."""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12            # float32 outside the tensor cores
