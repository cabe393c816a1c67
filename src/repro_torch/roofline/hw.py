"""NVIDIA H100 SXM figures: the denominators of the port's roofline and of
``chip_smoke.py``'s ``bound_ms``.

The peak rates are NVIDIA's H100 SXM data sheet (dense, no sparsity, at the
700 W limit); a card capped lower runs slower under load.  The link figures
are from the same data sheet, not measured: NVLink 4 moves 900 GB/s a GPU
in both directions together, 450 GB/s each way; a node's scale-out NIC is
one 400 Gb/s ConnectX-7 port a GPU.  The reference's TPU v5e figures stay
in ``repro.roofline.hw``.
"""

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB
INT8_OPS_PER_S = 1.979e15  # int8 tensor cores
BF16_FLOPS_PER_S = 989e12  # bf16 tensor cores
FP32_FLOPS_PER_S = 67e12  # fp32 outside the tensor cores (the CUDA cores' FMAs)
NVLINK_BYTES_PER_S = 450e9  # NVLink 4, one direction, one GPU (data sheet, not measured)
NIC_BYTES_PER_S = 400e9 / 8  # one 400 Gb/s NIC a GPU, one direction (data sheet, not measured)
GPUS_PER_NODE = 8  # an HGX H100 board: the NVLink domain
