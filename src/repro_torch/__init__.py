"""repro_torch — the PyTorch / CUDA (NVIDIA Hopper) port of `repro`.

The JAX/Pallas package `repro` is the reference; this package imports none
of it.  Layers (bottom-up):

  csrc/       hand-written CUDA C++ paged-attention kernels (sm_90a).
  kernels/    ctypes wrappers + launch counters + plain PyTorch versions,
              and the host layer (`paged_attention/ops.py`).
  core/       page allocator, paged KV layout, attention backend,
              kernel-config heuristics.
  models/     dense decoder (`Model`, unified packed step) and sampling.
  serving/    request / scheduler / prefix cache / packed `Engine`.
  launch/     `python -m repro_torch.launch.serve`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; a CPU
tensor reaches each kernel's plain PyTorch version, a CUDA tensor the
kernel.
"""

__version__ = "0.1.0"
