"""Hardware constants of the port's card, under the reference's names
(`repro.roofline.hw`), for one NVIDIA H100 80GB HBM3 (SXM).

Rates are NVIDIA's H100 SXM data sheet figures (dense, no sparsity) at
the card's full 700 W power limit; a card set below it runs slower under
load, so a measurement is written with `nvidia-smi`'s power limit beside
it.  The interconnect and pod sizes of the reference (`ICI_BW`,
`CHIPS_*`) belong to its TPU mesh and have no counterpart here.
"""

# NVIDIA H100 80GB HBM3: bf16 / fp16 tensor cores, dense (data sheet)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
# NVIDIA H100 80GB HBM3: float32 outside the tensor cores (data sheet);
# the port's fp32 attention kernels are scalar
PEAK_FLOPS_FP32 = 67e12  # FLOP/s
# NVIDIA H100 80GB HBM3: device memory bandwidth (data sheet)
HBM_BW = 3.35e12  # bytes/s
# NVIDIA H100 80GB HBM3: device memory (data sheet)
HBM_PER_CHIP = 80 * 1024**3  # bytes
# NVIDIA H100 80GB HBM3 (SXM): streaming multiprocessors (Hopper
# architecture white paper)
NUM_SMS = 132
# NVIDIA H100 80GB HBM3: dynamic shared memory one block may opt in to,
# 227 KB of the SM's 256 KB (CUDA programming guide, compute capability
# 9.0; the limit the kernels' wrappers check, kernels/paged_attention)
SMEM_PER_BLOCK = 232448  # bytes
