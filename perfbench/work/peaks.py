"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity; NVIDIA's
data sheet), at its full 700 W power limit."""

F32_FLOPS = 67e12        # f32 outside the tensor cores
TF32_FLOPS = 495e12      # TF32 on the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes a second
