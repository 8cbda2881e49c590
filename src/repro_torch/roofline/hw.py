"""Hardware constants of the port's card, under the reference's names
(`repro.roofline.hw`), for one NVIDIA H100 80GB HBM3 (SXM).

Rates are NVIDIA's H100 SXM data sheet figures (dense, no sparsity) at
the card's full 700 W power limit; a card set below it runs slower under
load, so a measurement is written with `nvidia-smi`'s power limit beside
it.

The dry run (`launch/dryrun.py`) lays the reference's TPU mesh geometry,
(data 16, model 16) = 256 ranks or (pod 2, data 16, model 16) = 512, over
H100 ranks, eight to a node (an HGX H100 board): rank = row-major mesh
index, so a node holds ranks [8 j, 8 j + 8).  Within a node the GPUs talk
over NVLink 4, between nodes over one InfiniBand NDR port a GPU.  Every
mesh axis crosses nodes at that layout: 'model' (16 consecutive ranks)
spans two nodes, 'data' (stride 16) and 'pod' (stride 256) a node a
rank; a collective over any of them is held back by its InfiniBand hops,
so the roofline's collective term divides by `COLLECTIVE_BW`, the
InfiniBand rate (`AXIS_LINK` names each axis's link).
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

# NVIDIA H100 SXM data sheet: NVLink 900 GB/s a GPU, both directions
# together; 450 GB/s each way
NVLINK_BW = 450e9  # bytes/s a GPU, one direction
# one InfiniBand NDR port a GPU (ConnectX-7, 400 Gb/s): 50 GB/s each way
IB_BW = 50e9  # bytes/s a GPU, one direction
# the link each mesh axis of the dry run's meshes crosses at 8 GPUs a node
AXIS_LINK = {"model": "infiniband", "data": "infiniband",
             "pod": "infiniband"}
# the roofline's collective rate: every axis above crosses InfiniBand
COLLECTIVE_BW = IB_BW
GPUS_PER_NODE = 8

# the reference's mesh sizes (its v5e pod geometry), laid over H100 ranks
CHIPS_SINGLE_POD = 256
CHIPS_MULTI_POD = 512

# what every dry-run record says beside the rates it used
RATES_SOURCE = "NVIDIA H100 80GB HBM3 SXM data sheet, 700 W"
