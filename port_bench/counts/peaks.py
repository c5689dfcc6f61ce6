"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit). The benchmark runs float32 with TF32 off, so its
operations run on the CUDA cores, outside the tensor cores."""

FLOAT32_FLOPS = 67e12          # float32, non-tensor
HBM_BYTES_PER_S = 3.35e12
