"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W power limit), frozen from chip_smoke.py:366-369."""

HBM_BYTES_PER_S = 3.35e12        # device memory
BF16_FLOPS_PER_S = 989e12        # bf16 dense, tensor cores
TF32_FLOPS_PER_S = 495e12        # TF32 dense, tensor cores
FP32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
