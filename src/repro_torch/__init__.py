"""repro_torch — the PyTorch / CUDA (NVIDIA Hopper) port of `repro`.

The JAX/Pallas package `repro` is the reference; this package imports none
of it.  Layers (bottom-up):

  csrc/       hand-written CUDA C++ kernels (sm_90a): paged attention
              (serving), the flash-attention forward (training) and the
              Mamba2 chunked SSD (hybrid prefill).
  kernels/    ctypes wrappers + launch counters + plain PyTorch versions,
              and the host layers (`paged_attention/ops.py`, the
              differentiable `flash_attention/ops.py`, `mamba2/ops.py`).
  core/       page allocator, paged KV layout, attention backend,
              kernel-config heuristics.
  models/     dense decoder and zamba2 hybrid (`Model`; the unified
              packed step, the padded prefill / decode steps,
              `apply_train`), the Mamba2 block and sampling.
  serving/    request / scheduler / prefix cache / `Engine` (packed and
              padded per-kind steps).
  training/   Markov data, AdamW, the train step, checkpoints.
  launch/     `python -m repro_torch.launch.serve` / `.train`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; a CPU
tensor reaches each kernel's plain PyTorch version, a CUDA tensor the
kernel.
"""

__version__ = "0.1.0"
