"""repro_torch — the PyTorch / CUDA (NVIDIA Hopper) port of `repro`.

The JAX/Pallas package `repro` is the reference; this package imports none
of it.  Layers (bottom-up):

  csrc/       hand-written CUDA C++ kernels (sm_90a): paged attention
              (serving), the flash-attention forward (training), the
              Mamba2 chunked SSD (hybrid prefill), the chunked mLSTM
              (xlstm prefill) and the grouped expert GEMM (MoE).
  kernels/    ctypes wrappers + launch counters + plain PyTorch versions,
              and the host layers (`paged_attention/ops.py`, the
              differentiable `flash_attention/ops.py`, `mamba2/ops.py`,
              `mlstm/ops.py`, `moe/ops.py`).
  core/       page allocator, paged KV layout, attention backend,
              kernel-config heuristics.
  models/     dense and MoE decoders, the zamba2 hybrid and xlstm
              (`Model`; the unified packed step, the padded prefill /
              decode steps, `apply_train`), the MoE layer, the Mamba2 /
              mLSTM / sLSTM blocks and sampling.
  serving/    request / scheduler / prefix cache / `Engine` (packed and
              padded per-kind steps).
  training/   Markov data, AdamW, the train step, checkpoints.
  obs/        telemetry, metrics, tracing, the scrape server and the
              online refit daemon (copies of `repro.obs`).
  autotune/   the kernel-config sweep (timed on the card), the Hopper
              cost model and the decision-tree fit and export.
  roofline/   the card's constants (`hw.py`).
  launch/     `python -m repro_torch.launch.serve` / `.train` /
              `.autotune`.

Entry points run on `cuda` unless the caller passes `device="cpu"`; a CPU
tensor reaches each kernel's plain PyTorch version, a CUDA tensor the
kernel.
"""

__version__ = "0.1.0"
