#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100) and `nvcc`.  It imports nothing
of JAX and nothing of the JAX package.  Phases, each failing the run
(non-zero exit, no result line) on any error:

  1. device   the card's name and `nvidia-smi` name / power limit
  2. build    compile every csrc/*.cu with nvcc (sm_90a), one nvcc per
              source, all started together
  3. check    each of the four paged-attention kernels, and the segmented
              decode with the merge folded into its launch (the serving
              path's C3 decode), against its plain
              PyTorch version on the card, at the shapes both serve phases
              give them: smollm-135m's packed step (Hkv 3, group 3, D 64, page
              16, 8 sequences with contexts 0..2048, a 512-token prefill
              region with a resumed chunk; plus a non-power-of-two page,
              24) and zamba2-1.2b's padded step (Hkv 32, group 1, D 64,
              page 16, 8 decode rows with contexts up to 1056 on the
              segmented variant with 16 segments, a fresh prefill of 8 x
              1024 rows at context 0 in the uniform layout), at
              qwen2.5-3b's heads (Hkv 2, group 8, D 128: the D 128
              instantiation of the tensor-core prefill, and 128 rows a
              Q-Block, over 64), for the decode kernels only, at
              glm4-9b's heads (Hkv 2, group 16, D 128: the largest group
              the repo's models give them), for the prefill only, at
              the padded step's resumed chunks with smollm's heads (4
              chunks of 512 rows in the uniform layout after prior
              contexts of 0 / 512 / 1024 / 1536, one padded to half its
              rows: `prefill_attention_cached`), and at the speculative
              verify step's shapes (smollm's heads: 8 decode rows at
              contexts of 128-1100, then 8 chunk rows of q 2-5 ending at
              contexts of 130-1100), at qwen2-vl-2b's heads (Hkv 2, group
              6, D 128: six live rows in a decode block of 8, 96 rows a
              Q-Block) and musicgen-large's (Hkv 32, group 1, D 64) on
              the packed step's layout, in fp32 with TF32 off (atol
              1e-4) and bf16 (atol 2e-2: a bf16 output ulp near 1 is
              7.8e-3, and p is rounded to bf16 before p.V on both sides;
              bf16 prefill runs the tensor-core kernel, fp32 the scalar
              one); a context-0 decode row is exact zeros and every
              segment without a live key exactly (acc 0, m NEG, l 0); the
              folded launch gives the bits of the segmented kernel
              followed by the standalone merge
  4. time     median kernel time over CUDA events (L2 flushed before each
              launch; the events also time the wrapper's host enqueue
              where it outlasts the flush, so the wrapper's host time is
              logged beside it as host_us) beside the plain version, a
              library yardstick and the bound (bytes at 3.35 TB/s or
              FLOPs at peak); further `time` rows, logged only: the
              Q-Block prefill and both decode kernels at zamba2-1.2b's
              shapes (padded prefill; Hkv 32, group 1 decode), both
              decode kernels at qwen2.5-3b's heads (D 128, group 8), the
              Q-Block prefill at the verify shapes, the Q-Block prefill
              and the decode kernels at qwen2-vl-2b's and
              musicgen-large's heads (rows of the kernels' JSON, named
              "<kernel>[<arch>]", with phase 25's launches); the folded
              C3 launch beside the two launches it replaces (the
              `segment_reduce` row of the kernels' JSON is the folded
              launch)
  5. serve    full-width smollm-135m (bf16, random seeded weights) serves
              8 requests (prompts 128-1024, 32 new tokens, max_seqs 8,
              chunked prefill; one request sampled with temperature,
              top-k and top-p) through the packed fused step, captured
              into CUDA graphs and replayed (the engine's default); the
              kernel launch counters are zeroed just before and read just
              after: every paged kernel launched, each C3 decode one
              launch of the folded kernel (`KERNEL_LAUNCHES`: the
              partial-only kernel and the standalone merge never).  Then
              the same requests eagerly (`cuda_graphs=False`): identical
              tokens, launch counters and `compile_events`, logits bit for
              bit (else within one bf16 ulp of the largest logit), both
              walls, the captures and replays and the steps' walls by kind
              logged (`graphs_vs_eager`); and the same differential on a
              preempting trace (4 requests on 13 pages).  Then (a) the
              same 8 requests through `submit()` + `run()` (the async
              double-buffered loop), graphs on, against the synchronous
              graphed run: identical tokens, launch counters,
              `compile_events` and logits launch by launch bit for bit;
              both walls, the replayed steps' mean walls and the capture
              seconds logged, and the decode graph's replay time on the
              card against its kernels' summed time (`replay_cost`); (b) a
              shared-prefix trace (8 requests of one 768-token prefix and
              64-256 own tokens, 32 new each, chunked at 512) through
              `run()` with prefix caching off and on: every request
              finishes, a page must hit; the prefill accounting, both
              walls and each request's time to first token logged;
              (c) speculative decoding (`phase_spec_serve`): 8 requests
              of 128-1024 tokens, the even ones a repeated cycle of 3-8
              tokens, 32 new, request 2 sampled, draft_k 4, graphs on,
              against the same requests without speculation: in bf16
              drafts proposed, accepted and rejected, one `unified`
              device call a step, no page leaked, verify rows on the
              Q-Block prefill, graphs bit for bit against eager, the
              tokens' agreement with the run without speculation logged;
              in fp32 (TF32 off) identical tokens with and without; the
              sampler timed at [80, 49152] and its host noise draw; (d)
              phase 5's requests through the two-dispatch sampler
              (`fused_sampling=False`): identical tokens, counters,
              `compile_events` and logits, {"unified": n, "sample": n}
  6. diff     full width in fp32 (TF32 off): 3 greedy requests of 8 new
              tokens on the card (CUDA kernels, CUDA graphs) and on the
              CPU (plain versions), stepped in lockstep: identical tokens,
              logits within 5e-3; then one bf16 prefill of the same 3
              prompts on the card, replaying the packed step's graph (the
              prompts are served once before to capture it), and on the
              CPU: the logit gap within 2 x the CPU's own bf16-vs-fp32 gap;
              then three more fp32 legs, identical tokens and logits
              within 5e-3: phase 5's shared-prefix trace with prefix
              caching on (packed, in lockstep, the same cached tokens on
              both), the padded step with chunked prefill at 64 (resumed
              chunks run `apply_prefill_cached` on the card's fp32 prefill
              kernel), `stream()` on the card against `generate()` on
              the CPU, launch by launch, and speculative decoding (4
              prompts, two a repeated cycle, 16 greedy tokens, draft_k
              4): the same spec stats on both
  7. flash    the flash-attention forward kernel (o and lse) against its
              plain version on the card at the shape the train phase gives
              it (B 4, S 2048, Hq 9, Hkv 3, D 64, causal, packed q
              [12, 128, 48, 64]; fp32 and bf16), at qwen2.5-3b's heads
              (Hq 16, Hkv 2, D 128: the D 128 tensor-core instantiation;
              fp32 and bf16) and the five shapes of
              tests/test_kernels_flash_attention.py (atol 1e-4 fp32 with
              TF32 off, 2e-2 bf16; bf16 runs the tensor-core kernel, fp32
              the scalar one), and the gradient of flash attention
              (kernel forward + recompute backward) on the card against the
              same on the CPU (fp32, atol 1e-4)
  8. ftime    the flash kernel at B 4, S 2048, Hq 9, Hkv 3, D 64, bf16,
              causal, beside its plain version,
              scaled_dot_product_attention (a yardstick, never called by the
              port) and its bound
  9. train    full-width, full-depth smollm-135m in bf16 (random weights
              from seed 0) takes 1 + 5 AdamW steps at batch 4 x seq 2048 on
              Markov data (seed 1) through `trainer.train_step`; the launch
              counters are zeroed just before and read just after: the
              flash kernel runs 2 x 30 x 6 times (each block's forward and
              its remat recompute), the paged kernels never
 10. tdiff    full width in fp32 (TF32 off): 3 train steps at batch 2 x
              seq 256 on the card and on the CPU from the same weights and
              batches: losses within 1e-4 relative, grad norms within 1e-3
 11. ssd      the Mamba2 SSD kernel (y and the final state) against its
              plain version on the card, from a nonzero initial state: at
              the shape the hybrid serve phase gives it (B 8, L 1024, H 32,
              P 128, N 64, G 1, chunk 128), at a short prompt (L 16, chunk
              16), at the cases of tests/test_kernels_mamba2.py, at the
              card tests' cases across the bf16 kernel's MMA tiles (P 48 /
              N 24 / Q 24, P 40 / N 8 / Q 40, P 20 / N 12 / Q 12) and from
              a state of ~100 under x of ~0.01; fp32 (the scalar kernel)
              with TF32 off within 1e-5 x max |y| (sums of up to 128 x 64
              products of values as large as |y|, in another order), bf16
              (the tensor-core kernel, fp32 operands as bf16 hi + lo
              halves) within 2e-2
 12. ssdtime  the SSD kernel at the serve shape in bf16 beside its plain
              version and its bound; no single PyTorch call computes the
              SSD, so its library time is null
 13. hserve   full-width zamba2-1.2b (bf16, random seeded weights) serves 8
              requests (prompts 128-1024, 32 new tokens, max_seqs 8)
              through the padded per-kind step; the launch counters are
              zeroed just before and read just after: the SSD runs once
              per Mamba2 layer per prefill (32 x, every launch the
              tensor-core kernel), the Q-Block prefill once
              per shared-attention invocation per prefill (6 x), the decode
              kernels 6 x per decode step (one launch: a segmented step's
              partials and merge are one folded kernel; the decode step is
              a replayed CUDA graph, the prefill eager), the flash kernel
              never; the configs the engine picked are the ones phase 3
              checked; then phase 5's differential against the same
              requests served eagerly
 14. hdiff    zamba2 at full width cut to 12 layers (two groups of five
              Mamba2 blocks and the shared block), fp32 (TF32 off): 3
              greedy requests of 8 new tokens on the card and on the CPU,
              stepped in lockstep: identical tokens, logits within 5e-3;
              then one prefill of the same 3 requests in bf16 on the card
              (the tensor-core SSD) and on the CPU: the last-token logits'
              max abs gap within 2 x the CPU's own bf16-vs-fp32 gap in the
              same run, argmax agreement logged
 15. mlstm    the chunked mLSTM kernel (h and the final C, n, m) against
              its plain version on the card: at the shape the xlstm serve
              phase gives it (B 8, L 1024, H 4, P 512, chunk 64) from the
              empty state (m = -inf) and from a nonzero finite state, at a
              short prompt (L 16, chunk 16), at the cases of
              tests/test_kernels_mlstm.py with its extreme gates, and with
              padded rows (ig -30 / fg +30 past each row's length); fp32
              with TF32 off within 2e-5 x max |out| per output (h divides
              sums of up to 64 + 512 products, summed in another order, by
              a denominator that can sit at its exp(-m) floor), bf16
              inputs (the tensor-core kernel) within 2e-5 for the fp32
              state and 8e-3 x max |h| for h (rounded to bf16 on both
              sides: one ulp is at most 2^-7 of the value); also the card
              tests' cases across the MMA tiles (P 16 / Q 8, P 40 / Q 24,
              P 20 / Q 12, P 136) and a state of ~100 under q, k, v of
              ~0.01 ("large")
 16. mltime   the mLSTM kernel at the serve shape in bf16 beside its plain
              version and its bound; no single PyTorch call computes the
              chunked mLSTM, so its library time is null
 17. xserve   full-width, full-depth xlstm-350m (bf16, random seeded
              weights) serves 8 requests (prompts 128-1024, 32 new tokens,
              max_seqs 8) through the padded per-kind step; the launch
              counters are zeroed just before and read just after: the
              mLSTM kernel runs once per mLSTM layer per prefill (21 x,
              every launch the tensor-core kernel), the paged, flash and
              SSD kernels never (the decode step a replayed CUDA graph);
              then phase 5's differential against the same requests
              served eagerly
 18. xdiff    xlstm at full width cut to 8 layers (one group: seven mLSTM
              blocks and one sLSTM block), fp32 (TF32 off): 3 greedy
              requests of 8 new tokens on the card and on the CPU, stepped
              in lockstep: identical tokens, logits within 5e-3; then the
              bf16 leg of phase 14 (the tensor-core mLSTM)
 19. tune     the autotune loop on the card: (a) every configuration of
              the sweep's three spaces (`autotune.microbench`: DECODE_SPACE,
              PREFILL_SPACE, UNIFIED_SPACE), through the ops the sweep and
              the engine call, at the heads of smollm-135m (unified and
              prefill), zamba2-1.2b's attention and qwen2.5-3b (decode and
              prefill), on one mixed scenario (8 decode rows at contexts
              0-2048, a resumed chunk of 200 rows at context 1312, a fresh
              one of 100) against the same ops on the plain versions: fp32
              (TF32 off) 1e-4, bf16 2e-2, the context-0 row exact zeros; a
              configuration refused before launch (`LaunchLimitError`) is
              logged by name; then `tune_calibrate` reads the cost model's
              four card constants; (b) a cut grid (TUNE_GRID: batch 1 / 8 /
              64 x max length 128 / 1024 / 4096 x decode share 0 / 0.5 /
              1, the reference's jitter) swept at smollm's heads in bf16
              (each configuration TUNE_WARMUP eager launches, then
              TUNE_ITERS replayed in one CUDA graph and timed by CUDA
              events), the three trees fit and exported by
              `tune_and_export`: each phase's tuned-vs-best-fixed speedup,
              listing, the cost model's rank correlation with the
              measurement, the sweep's seconds, launches and inf count
              logged; (c) phase 5's 8 requests at full width with the
              default trees, then the tuned tree loaded: in fp32 (TF32
              off, greedy) identical tokens, no page leaked; in bf16 the
              dispatch, keys captured, capture seconds and walls logged
 20. observe  phase 5's 8 requests (greedy, fp32, TF32 off) through
              `run()` without telemetry, then with
              `Telemetry(launch_timing_interval=1)` and an inline
              `RefitDaemon(min_new=OBSERVE_MIN_NEW)` on the engine hook
              and a `MetricsServer` on 127.0.0.1 (port 0): identical
              tokens, >= 1 refit and hot-swap at step boundaries, the
              telemetry's steps, sampled and prefill tokens, dispatch and
              compile events equal to the engine's (captures as the
              compiled launches), every grid entry with `flops` and
              `bytes_accessed` > 0, the Prometheus text round-tripping
              through `parse_prometheus`, a `heuristics_hot_swap` instant
              in the trace, `GET /metrics` answered; TTFT / ITL / step
              p50-p95 and the refit report logged; then telemetry's cost
              in bf16 with graphs (`Telemetry()` at interval 8 against
              none, in turns, each engine's second run timed: replays
              only)

 21. moe      the MoE family: (a) the grouped expert GEMM
              (`csrc/moe_grouped_gemm.cu`: gate / up fused, then down)
              against its plain version at llama4-maverick's widths (E 128,
              d 5120, ff 8192, bf16, atol 2e-2) and at a cut size (E 8, d
              512, ff 1024, fp32 with TF32 off, 1e-4), at 8 and 520 rows,
              each with uniform routing, every row on one expert, empty
              experts and a 150-row group (three 64-row tiles); timed at 8
              and 520 rows in bf16 beside its plain version, its bound and
              a per-expert torch.matmul loop over host-known group sizes
              (the yardstick, never called by the port); (b) full-width
              llama4-maverick-400b-a17b cut to 2 of its 48 layers (bf16,
              random weights drawn on the card, ~69.3 GB) serves phase 5's
              8 prompts (greedy, 32 new tokens, max_seqs 8, chunked at 512)
              through the packed fused step on CUDA graphs, then eagerly,
              then through `submit()` + `run()`: tokens identical and
              logits bit-equal (else within one bf16 ulp) graphs against
              eager, `run()` bit for bit against `step()`; the grouped GEMM
              (2 launches a MoE layer a step, every one the tensor-core
              kernel) and every paged kernel launched; tokens/s, steps,
              keys captured, peak memory and the replayed step's ms under
              `run()` against `step()` logged; (c) maverick's attention
              width (d 5120, 40 / 8 heads of D 128) with 1 layer, 8
              experts of ff 1024 (shared ff 1024) and a vocab of 32768, fp32
              (TF32 off): 3 greedy requests of 8 new tokens on the card
              (eager, the fp32 kernels) and on the CPU in lockstep:
              identical tokens, logits within 5e-3, identical expert ids
              in every MoE call
 22. mla      MLA (deepseek-v2-236b), after phase 21 has freed maverick:
              (a) the latent paged decode (`csrc/mla_decode.cu`, through
              the serving entry and its split-KV choice) against its plain
              version at deepseek-v2's widths (H 128, r 512, rope 64,
              page 16): 8 rows at contexts 0-2048 (8 segments and the
              merge launch) and 64 rows of 4096 (one segment), bf16 (atol
              2e-2) and fp32 (TF32 off, 1e-4), dead rows exact zeros;
              timed at both in bf16 beside its bound, its plain version
              and a page gather + SDPA yardstick (its backend named),
              also with the enqueue hidden behind a spin; ptxas'
              registers and spills (from the build's report) and the
              dynamic shared memory of the bf16 kernel;
              (b) the flash forward at key width 192 / value width 128
              with a per-batch kv_len against its plain version at the
              padded prefill of phase 5's prompts (8 x 1024 rows, 128
              heads) in bf16 and at a cut in fp32, timed beside its
              bound, its plain version and SDPA; (c) full-width
              deepseek-v2 cut to 8 of its 60 layers (1 dense + 7 MoE,
              bf16, random weights drawn on the card, 58.4 GB) serves
              phase 5's 8 prompts (greedy, 32 new tokens, max_seqs 8,
              unchunked) on the padded step, decode on CUDA graphs, then
              eagerly: identical tokens, logits bit-equal (else within
              one bf16 ulp); the latent decode, the flash forward and the
              grouped GEMM launched as many times as the steps ask (every
              one the tensor-core kernel), no plain version called, no
              kernel-config key; tokens/s, steps, keys, peak memory, the
              decode graph's replay (the latent decode's device time and
              share in it) and a profiled prefill step logged;
              (d) deepseek-v2's
              attention width with 2 layers (1 dense + 1 MoE), 8 experts
              of ff 1024 top-6 with 2 shared and a vocab of 32768, fp32:
              3 greedy requests on the card (eager) and on the CPU in
              lockstep: identical tokens, logits within 5e-3, identical
              expert ids
 23. mtrain   MoE and MLA training (deepseek-v2), after phase 22 has freed
              its served model: (a) the flash forward at key width 192 /
              value width 128 without kv_len (the training path's
              `flash_mma_kernel<192, 128, false>`) against its plain
              version at the train shape (B 1, S 2048, 128 heads, causal)
              in bf16 (atol 2e-2) and at a cut in fp32 (TF32 off, 1e-4),
              its gradient (kernel forward + recompute backward) on the
              card against the CPU in fp32 with and without kv_len
              (1e-4), and its time at the train shape beside its bound,
              its plain version and SDPA; (b) full-width deepseek-v2 cut
              to 2 of its 60 layers (1 dense + 1 MoE, bf16, random
              weights drawn on the card, 5.36 G parameters: params, grads
              and fp32 moments 59.9 GiB) takes 1 + 3 AdamW steps at batch
              1 x seq 2048 of Markov data through `trainer.train_step`
              (the capacity dispatch: one group of 2048, capacity 96);
              the launch counters are zeroed just before and read just
              after: the flash forward 2 a layer a step (the forward and
              its remat recompute), every launch `flash_mma_kernel`; the
              grouped GEMM, the latent decode and the paged kernels never;
              no plain version; every loss finite; step ms, tokens/s,
              peak memory, the dropped share of the routed (token,
              choice) pairs and the routing's load, aux, one profiled
              step's top kernels and the step's parts (AdamW, the flash
              backward, the MoE and attention layers, by CUDA events)
              logged; (c) deepseek-v2's attention width, 2 layers (the
              dense block's d_ff cut to 1024), 8 experts of ff 1024 top-6
              with 2 shared, cf 1.25, a vocab of 32768, fp32 (TF32 off): 3
              train steps at 2 x 128 on the card and on the CPU from the
              same weights and batches: losses within 1e-4 relative, grad
              norms within 1e-3, aux within 1e-5, the first step's MoE
              forward with identical expert ids and identical kept /
              dropped (token, choice) pairs
 24. rtrain   training of the recurrent families, after phase 23 has
              freed its model: (a) zamba2's SSD at its training shape (B
              4, L 2048, H 32, P 128, N 64, G 1, chunk 128, from the zero
              state): the bf16 kernel against its plain version (2e-2),
              the trainable Function's bf16 forward bit for bit the op it
              wraps, its fp32 gradients (kernel forward, recompute
              backward) on the card against the CPU at a cut (1e-4 x each
              gradient's largest element), the kernel's ms beside its
              plain version and bound, the Function's forward and forward
              + backward ms; (b) the same for xlstm's mLSTM (B 4, L 1024,
              H 4, P 512, chunk 64); the D 64 flash forward at zamba2's
              training attention (B 4, S 2048, 32 heads, group 1) against
              its plain version and timed beside SDPA; (c) full-size
              zamba2-1.2b (38 layers, bf16, random weights from seed 0)
              takes 1 + 3 AdamW steps at batch 4 x seq 2048 of Markov data
              through `trainer.train_step`; the launch counters are zeroed
              just before and read just after: `ssd_mma_kernel` 64 a step
              (32 Mamba2 layers, each forward and its remat recompute),
              `flash_mma_kernel` 6 (the shared block, not rematerialised),
              no paged, MoE, latent-decode or fp32 scalar kernel, no plain
              version; every loss finite; step ms, tokens/s, peak memory,
              one profiled step's idle share and top kernels, and the
              step's parts (AdamW, the SSD's forwards and recompute
              backward, the flash backward) logged; (d) the same for
              xlstm-350m (24 layers) at 4 x 1024: `mlstm_mma_kernel` 42 a
              step, and the sLSTM loop's forward + backward as a part;
              (e) reduced zamba2 and xlstm in fp32 (TF32 off), 3 steps at
              2 x 128 on the card and on the CPU: losses within 1e-4
              relative, grad norms within 1e-3
 25. families the audio and vlm families, each freed before the next:
              musicgen-large (48 layers, Hkv 32, group 1, D 64, no
              position encoding) and qwen2-vl-2b (28 layers, Hkv 2, group
              6, D 128, M-RoPE over [3, 1, T] positions, a 151,936
              vocabulary) at full size, bf16, random weights from seed 0:
              (a) phase 5's trace (8 requests of 128-1024 tokens, 32 new,
              max_seqs 8, chunked at 512, request 3 sampled) on a pool of
              1024 pages through the packed fused step, graphs then eager
              (`graphs_vs_eager`: bit for bit); every paged kernel
              launched, each C3 decode on the folded kernel, nothing else
              and no plain version; the decode graph's replay against its
              byte bound (every matrix but the embedding table, plus the
              live rows' KV, at 3.35 TB/s); the flash forward at the
              training attention (B 4, S 2048) against its plain version
              and timed beside SDPA; (b) the served model trained, 1 + 2
              AdamW steps at 4 x 2048 of seeded [B, S, d] bf16
              embeddings (the stub frontend's), Markov labels and, for
              qwen2-vl, Qwen2-VL patch-grid positions: `flash_mma_kernel`
              twice a layer a step, nothing else; finite losses, step 0's
              ce within 1.0 of ln V, peak under 79 GiB, one profiled
              step's idle share; (c) a 2-layer full-width fp32 cut card
              vs CPU: 3 greedy requests in lockstep (identical tokens,
              logits within 5e-3), one train step (loss 1e-4 relative,
              grad norm 1e-3); (d) for qwen2-vl the cut with `fused_qkv`
              and `fused_mlp` holding the same weights concatenated,
              against the unfused model on the card: identical greedy
              tokens, logits within 1e-4, one train step's loss within
              1e-5 relative
 26. tp       tensor-parallel serving, the expert-parallel MoE and the
              gradient collectives, in 4 ranks of one gloo world sharing
              the card (`launch.mesh.spawn_ranks`; ranks 0-2 the tp 3
              group), eager: (a) the paged kernels at smollm-135m's heads
              over tp 3 (Hkv 1, group 3, D 64; checked in phase 3 as
              "smollm-135m/tp3", the folded C3 launch bit for bit) and the
              grouped GEMM's tail launch at deepseek-v2's 40 experts a
              rank (rank 0's routing of (d)'s rows; also phase 21's E 40
              case) against their plain versions (the grouped GEMM each
              element within two bf16 ulps of its own magnitude, plus
              one flip of the gate or up product's bf16 rounding, plus
              2^-16 of the largest output; the margin and what a kernel
              one row off per group reads logged), each timed with the
              enqueue hidden beside its plain version, a library
              yardstick and its bound; (b) fp32 (TF32 off) full-width
              smollm-135m on phase 5's trace (8 requests, prompts
              128-1024, 32 new, max_seqs 8, chunked at 512, greedy) at tp
              1 here and at tp 3 in the ranks: tokens identical on every
              rank and to tp 1, logits within 1e-5, one unified call a
              step on each rank; (c) the same in bf16: every rank's
              tokens and logits bit-equal to rank 0's, the tokens those
              of tp 1 (a difference only at a near-tie of tp 1: its top-2
              margin within one bf16 ulp of its largest logit), the walls
              of tp 1 and tp 3 and the all-gathers' share of the tp 3
              run (CUDA events around each on rank 0's stream); (d)
              `moe_ffn_dropless_ep` at 4 ranks on deepseek-v2's MoE layer
              at full width (160 experts of d 5120, ff 1536, top-6, 2
              shared; 40 a rank) at 8 and 520 rows against one device's
              `MoE.forward` within 2e-2 in bf16, and a fp32 cut (E 8, d
              512, ff 1024) within 2e-5; (e) `int8_ef_allgather` (one step
              within 0.02, 50 steps with error feedback within 0.002) and
              `bf16_psum` (0.01) on CUDA tensors at 4 ranks.  Any rank's
              failure fails the run

Each phase logs its duration (`phase <n> <name> <s>s`).  The line before
the last is `nvidia-smi`'s name and power limit, the one before that the
kernels' JSON; the last line is the result JSON.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
ARCH = "smollm-135m"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, H100 SXM
KERNEL_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode": "src/repro/kernels/paged_attention/kernel.py:169",
    "paged_decode_segmented": "src/repro/kernels/paged_attention/kernel.py:279",
    "segment_reduce": "src/repro/kernels/paged_attention/kernel.py:359",
    "paged_prefill_qblock": "src/repro/kernels/paged_attention/kernel.py:454",
}
# the serving path's C3 decode (segmented partials and merge in one
# launch), and the two launches it replaces, timed as one call
MERGED = "paged_decode_segmented_merged"
PAIR = "paged_decode_segmented+segment_reduce"
FLASH = "flash_attention_fwd"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:96"
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
DEVICE = "cuda"
# the paged kernels' check shapes, one set per serve phase: the model whose
# heads they are, the page sizes, the decode contexts (8 rows) and the
# decode variant's segment count, the prefill's per-sequence query rows and
# contexts (qlens None: the decode kernels only), and its layout (`stride`
# None: packed back to back as in the packed step's chunk region; else
# starts at that stride, the padded step's uniform layout)
PAGED_SHAPES = {
    "smollm-135m": dict(
        page_sizes=(16, 24), ctx=(0, 1, 17, 100, 511, 1000, 1500, 2048),
        num_segments=16, qlens=(200, 312, 0, 0, 0, 0, 0, 0),
        pf_ctx=(200, 1312, 0, 0, 0, 0, 0, 0), stride=None),
    # phase 13: 8 prompts of 128-1024 tokens in one fresh prefill padded
    # to 1024 rows each, then 31 decode steps (contexts up to 1055); its
    # decode profile (8 rows, max context 2048, page 16) picks segmented
    # with 16 segments, its prefill profile block_q 16
    "zamba2-1.2b": dict(
        page_sizes=(16,), ctx=(1056, 129, 300, 517, 640, 777, 901, 1033),
        num_segments=16, qlens=(1024, 128, 517, 1000, 256, 771, 390, 1023),
        pf_ctx=(1024, 128, 517, 1000, 256, 771, 390, 1023), stride=1024),
    # no serve phase: qwen2.5-3b's heads (Hkv 2, group 8, D 128) hold the
    # D 128 kernels, and a Q-Block of 16 x 8 = 128 rows, against their
    # plain versions; a resumed and a fresh chunk, dead Q-blocks
    "qwen2.5-3b": dict(
        page_sizes=(16,), ctx=(0, 1, 33, 300, 777, 1024, 1500, 2048),
        num_segments=16, qlens=(100, 37, 0, 0, 0, 0, 0, 0),
        pf_ctx=(900, 37, 0, 0, 0, 0, 0, 0), stride=None),
    # no serve phase: glm4-9b's heads (Hkv 2, group 16, D 128), the largest
    # group the repo's models give the decode kernels (two blocks of 8
    # rows); contexts on a segment (640) and a page boundary (1024), and at
    # the full 2048; the prefill is held at 128 rows by qwen2.5-3b's set
    "glm4-9b": dict(
        page_sizes=(16,), ctx=(0, 1, 33, 640, 1024, 1500, 2047, 2048),
        num_segments=16, qlens=None, pf_ctx=None, stride=None),
    # the Q-Block prefill alone (ctx None: no decode kernels) at smollm's
    # heads on the padded step's resumed chunks (`prefill_attention_cached`):
    # 4 chunks of 512 rows in the uniform layout after prior contexts of
    # 0, 512, 1024 and 1536 tokens, the last chunk padded to half its rows
    "smollm-135m/resumed": dict(
        page_sizes=(16,), ctx=None, num_segments=None,
        qlens=(512, 512, 512, 256), pf_ctx=(512, 1024, 1536, 1792),
        stride=512),
    # the speculative verify rows of phase 5 (c) at smollm's heads: 8
    # decode rows at contexts of 128-1100, then 8 chunk-region rows of
    # q = s + 1 in 2..5 (a decode row and its s drafts) ending at contexts
    # of 130-1100, packed back to back: most of each Q-Block is dead rows
    "smollm-135m/verify": dict(
        page_sizes=(16,), ctx=(128, 301, 517, 640, 777, 901, 1033, 1100),
        num_segments=16, qlens=(2, 3, 4, 5, 5, 4, 3, 2),
        pf_ctx=(130, 260, 515, 641, 799, 900, 1003, 1100), stride=None),
    # phase 25's packed step at qwen2-vl-2b's heads (Hkv 2, group 6, D 128:
    # six live rows in a decode block of 8, a Q-Block of 16 x 6 = 96 rows)
    # and at musicgen-large's (Hkv 32, group 1, D 64): the decode region's
    # contexts and a fresh and a resumed chunk, packed back to back
    "qwen2-vl-2b": dict(
        page_sizes=(16,), ctx=(0, 1, 33, 300, 777, 1024, 1500, 2048),
        num_segments=16, qlens=(200, 312, 0, 0, 0, 0, 0, 0),
        pf_ctx=(200, 1312, 0, 0, 0, 0, 0, 0), stride=None),
    "musicgen-large": dict(
        page_sizes=(16,), ctx=(0, 1, 17, 100, 511, 1000, 1500, 2048),
        num_segments=16, qlens=(200, 312, 0, 0, 0, 0, 0, 0),
        pf_ctx=(200, 1312, 0, 0, 0, 0, 0, 0), stride=None),
    # phase 26's packed step at smollm's heads over tp 3 (`tp`: the heads
    # of one rank, Hkv 1, group 3, D 64): the decode region's contexts and
    # a fresh and a resumed chunk, packed back to back
    "smollm-135m/tp3": dict(
        page_sizes=(16,), ctx=(0, 1, 17, 100, 511, 1000, 1500, 2048),
        num_segments=16, qlens=(200, 312, 0, 0, 0, 0, 0, 0),
        pf_ctx=(200, 1312, 0, 0, 0, 0, 0, 0), stride=None, tp=3),
}
# phase 25: the audio and vlm families at full size
FAMILY_ARCHS = ("musicgen-large", "qwen2-vl-2b")
FAMILY_PAGES = 1024  # KV pool of the serve trace: 16384 token slots
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 4, 2048
FAMILY_TRAIN_STEPS = 2  # + 1 untimed warm-up step
FAMILY_PEAK_GIB = 79.0
FAMILY_DIFF_LAYERS = 2  # the full-width fp32 cut of (c) and (d)
FAMILY_DIFF_TRAIN = (2, 256)  # batch x seq of (c)'s and (d)'s train step
FUSED_LOGIT_ATOL, FUSED_LOSS_RTOL = 1e-4, 1e-5
# the paged kernels' rows of phase 25's shapes in the kernels' JSON
FAMILY_PAGED = ("paged_decode", "paged_decode_segmented", "segment_reduce",
                "paged_prefill_qblock")
PAGED_BLOCK_Q = 16
DIFF_LOGIT_ATOL = 5e-3
# graphed against eager steps of one engine configuration: the same kernels
# on the same inputs, so bit-equal logits are expected; a cuBLAS algorithm
# chosen differently under capture would show as a difference, allowed up
# to this (fp32) or one bf16 ulp of the largest logit (bf16)
GRAPH_LOGIT_ATOL = 1e-5
# the sampled request pins its RNG stream (else its request id, which
# differs between the two runs)
SERVE_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9, seed=3)
# phase 5's preempting trace: 13 pages of 16 (12 usable) for four requests
# that need ~18, as in tests/test_torch_engine.py
PREEMPT_LENS, PREEMPT_NEW_TOKENS = (40, 33, 47, 20), 24
PREEMPT_ENGINE = dict(max_seqs=4, num_pages=13, max_model_len=128)
# the shared-prefix trace (phases 5 and 6): 8 requests of one 768-token
# prefix and 64-256 tokens of their own, 32 new tokens each, chunked at 512
SHARED_PREFIX, SHARED_OWN, SHARED_REQUESTS = 768, (64, 256), 8
# phase 5 (c): speculative decoding, up to SPEC_DRAFT_K drafts a request a
# step; half the prompts repeat a cycle of SPEC_CYCLE tokens (drawn)
SPEC_DRAFT_K, SPEC_CYCLE = 4, (3, 8)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 5  # + 1 untimed warm-up step
# flash check shapes: (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, dtype); the
# shape the train phase gives the kernel (smollm-135m: Hq 9, Hkv 3, D 64),
# then the cases of tests/test_kernels_flash_attention.py, then D 128
FLASH_TRAIN_CASE = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 9, 3, 64, True, 0,
                    "bfloat16")
FLASH_CASES = [
    FLASH_TRAIN_CASE[:-1] + ("float32",),
    FLASH_TRAIN_CASE,
    (2, 128, 128, 4, 2, 64, True, 0, "float32"),
    (1, 64, 64, 8, 8, 128, True, 0, "float32"),
    (2, 32, 128, 4, 1, 64, True, 96, "float32"),
    (1, 128, 128, 16, 2, 128, False, 0, "float32"),
    (2, 128, 128, 4, 2, 64, True, 0, "bfloat16"),
    (1, 512, 512, 16, 2, 128, True, 0, "float32"),  # qwen2.5-3b's heads
    (1, 512, 512, 16, 2, 128, True, 0, "bfloat16"),
]
FLASH_GRAD_CASE = (2, 256, 256, 9, 3, 64, True, 0, "float32")
SSD = "ssd_chunked_fwd"
SSD_SOURCE = "src/repro_torch/csrc/mamba2_ssd.cu"
SSD_REPLACES = "src/repro/kernels/mamba2/kernel.py:81"
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_REQUESTS, HYBRID_NEW_TOKENS = 8, 32
# SSD check shapes (B, L, H, P, N, G, chunk): the shape the hybrid serve
# phase gives the kernel (8 prompts of up to 1024 tokens in one prefill,
# zamba2's widths), a short prompt, then tests/test_kernels_mamba2.py's
SSD_SERVE_CASE = (HYBRID_REQUESTS, 1024, 32, 128, 64, 1, 128)
SSD_CASES = [SSD_SERVE_CASE, (1, 16, 32, 128, 64, 1, 16),
             (2, 64, 4, 32, 16, 2, 16), (1, 128, 2, 64, 64, 1, 32),
             (2, 32, 8, 16, 8, 8, 8),
             # the card tests' cases across the bf16 kernel's MMA tiles:
             # P 48 / N 24 / Q 24, P 40 / N 8 / Q 40, and P 20 / N 12 / Q 12
             # (rows that are no multiple of 16 bytes: element-wise copies)
             (1, 96, 3, 48, 24, 3, 24), (2, 80, 2, 40, 8, 1, 40),
             (1, 36, 2, 20, 12, 2, 12)]
# an initial state of ~100 under x of ~0.01: y ~ exp(a) C S_in up to ~10^3,
# where one bf16 rounding of S_in would miss the absolute 2e-2 (the bf16
# kernel's hi + lo halves keep ~2^-17)
SSD_LARGE_STATE_CASE = (2, 256, 4, 128, 64, 1, 128)
SSD_FP32_RTOL, SSD_BF16_ATOL = 1e-5, 2e-2
HDIFF_LAYERS = 12
MLSTM = "mlstm_chunked_fwd"
MLSTM_SOURCE = "src/repro_torch/csrc/mlstm_chunked.cu"
MLSTM_REPLACES = "src/repro/kernels/mlstm/kernel.py:94"
XLSTM_ARCH = "xlstm-350m"
XLSTM_REQUESTS, XLSTM_NEW_TOKENS = 8, 32
# mLSTM check cases (B, L, H, P, chunk, gates, state): the shape the xlstm
# serve phase gives the kernel (8 prompts of up to 1024 tokens in one
# prefill, xlstm-350m's 4 heads of 512, chunk 64) from the empty and from
# a nonzero state, a short prompt, tests/test_kernels_mlstm.py's cases and
# extreme gates, and padded rows; gates "normal" are drawn as that test
# file draws them (forget-gate bias 2)
MLSTM_SERVE_CASE = (XLSTM_REQUESTS, 1024, 4, 512, 64, "normal", "empty")
MLSTM_CASES = [MLSTM_SERVE_CASE,
               MLSTM_SERVE_CASE[:-1] + ("nonzero",),
               (XLSTM_REQUESTS, 16, 4, 512, 16, "normal", "empty"),
               (2, 64, 3, 16, 16, "normal", "empty"),
               (1, 128, 4, 64, 32, "normal", "nonzero"),
               (2, 32, 1, 32, 8, "normal", "empty"),
               (1, 32, 2, 16, 8, "extreme", "empty"),
               (4, 128, 4, 512, 64, "padded", "empty"),
               # the card tests' cases across the bf16 kernel's MMA tiles:
               # P 16 / Q 8, P 40 / Q 24, P 20 / Q 12 (element-wise
               # copies), P 136 (a ragged third column block); and a state
               # of ~100 under q, k, v of ~0.01 ("large")
               (2, 24, 2, 16, 8, "normal", "empty"),
               (1, 48, 2, 40, 24, "normal", "nonzero"),
               (1, 24, 1, 20, 12, "normal", "empty"),
               (1, 64, 2, 136, 32, "normal", "nonzero"),
               (2, 128, 2, 64, 32, "normal", "large")]
MLSTM_PAD_LENS = (128, 100, 37, 0)  # valid tokens per row of "padded"
MLSTM_FP32_RTOL, MLSTM_BF16_H_RTOL = 2e-5, 8e-3
XDIFF_LAYERS = 8
# the bf16 legs of phases 14 and 18: the card's bf16 prefill logits within
# this multiple of the CPU's own bf16-vs-fp32 gap, measured in the same run
BF16_GAP_FACTOR = 2.0
TRAIN_KW = dict(base_lr=1e-3, warmup=1, total_steps=100)
# 3 steps: the schedule gives step 0 a learning rate of 0, so step 2 is
# the first whose loss follows an update.  The loss is a mean over 512
# tokens and the grad norm a sum over 135M squares, each after 30 layers
# of fp32 GEMMs summed in another order on each side (~1e-6 relative
# expected): 1e-4 and 1e-3 leave room without hiding a wrong kernel.
TDIFF_BATCH, TDIFF_SEQ, TDIFF_STEPS = 2, 256, 3
TDIFF_LOSS_RTOL, TDIFF_GNORM_RTOL = 1e-4, 1e-3
# phase 19: the spaces the sweep times, at the heads of the models served
# by the packed step (smollm-135m), the padded step (zamba2-1.2b's
# attention) and qwen2.5-3b's (D 128, group 8)
TUNE_GEOMETRIES = {"smollm-135m": ("unified", "prefill"),
                   "zamba2-1.2b": ("decode", "prefill"),
                   "qwen2.5-3b": ("decode", "prefill")}
# the mixed scenario every configuration is checked on: 8 decode rows at
# these contexts (one dead), then a resumed chunk (200 rows ending at
# context 1312) and a fresh one (100 rows)
TUNE_CHECK_CTX = (0, 1, 17, 100, 511, 1000, 1500, 2048)
TUNE_CHECK_CHUNKS = ((200, 1312), (100, 100))
# the sweep's cut grid (the reference's jitter recipe,
# microbench.scenario_grid) and its launches a configuration
TUNE_GRID = dict(batch_sizes=(1, 8, 64), max_lens=(128, 1024, 4096),
                 decode_shares=(0.0, 0.5, 1.0))
TUNE_WARMUP, TUNE_ITERS = 3, 10
# phase 20: new warm launches per (phase, profile) bucket before a refit
OBSERVE_MIN_NEW = 2
# phase 21: the MoE family.  The grouped expert GEMM replaces no Pallas
# kernel: the reference computes it with jax.lax.ragged_dot in
# moe_ffn_dropless (the "replaces" key names that line)
MOE = "moe_grouped_gemm"
MOE_SOURCE = "src/repro_torch/csrc/moe_grouped_gemm.cu"
MOE_REPLACES = "src/repro/models/moe.py:209"
MOE_ARCH = "llama4-maverick-400b-a17b"
# full width, 2 of its 48 layers: a MoE layer is 32.2 GB in bf16, two
# layers with the embedding and the head ~69.3 GB of the card's 80
MOE_LAYERS = 2
# the kernel checks (E, d, ff, dtype, atol): maverick's widths in bf16, a
# cut size in fp32 (TF32 off); rows 8 (a decode step) and 520 (a chunk
# step), each with uniform routing, every row on one expert, only two
# experts with rows (the rest empty), and a group of 150 rows (three
# 64-row tiles) among uniform ones
MOE_CHECK_CASES = [(128, 5120, 8192, "bfloat16", 2e-2),
                   (8, 512, 1024, "float32", 1e-4)]
MOE_ROUTINGS = ("uniform", "one_expert", "empty", "long")
MOE_ROWS = (8, 520)
MOE_LONG_GROUP = 150
# (b): phase 5's serve trace (8 requests, prompts 128-1024, 32 new tokens,
# max_seqs 8, chunked at 512), greedy
MOE_NEW_TOKENS = 32
# (c): the card against the CPU at maverick's attention width (d 5120,
# 40 / 8 heads of D 128) in fp32, cut to 1 layer, 8 experts of ff 1024
# (shared ff 1024) and a vocab of 32768 so that the CPU leg fits
MOE_DIFF_CUT = dict(num_layers=1, vocab_size=32768, dtype="float32")
MOE_DIFF_EXPERTS = dict(num_experts=8, d_ff_expert=1024)
# phase 22: MLA (deepseek-v2).  The latent decode replaces no Pallas
# kernel: the reference runs it as its jnp decode path (backend.py:76,
# `v = k[..., :v_dim]` over the gathered latent pages)
MLA = "mla_decode"
MLA_SOURCE = "src/repro_torch/csrc/mla_decode.cu"
MLA_REPLACES = "src/repro/core/attention/backend.py:76"
MLA_FLASH = "flash_attention_fwd[192/128]"
MLA_ARCH = "deepseek-v2-236b"
# full width, 8 of its 60 layers (1 dense + 7 MoE): 58.4 GB of bf16
# weights of the card's 80
MLA_LAYERS = 8
# (a) the latent decode at deepseek-v2's widths (H 128, r 512, rope 64,
# page 16): phase 5's decode step (8 rows, contexts 0-2048) and 64 rows of
# 4096 (the bytes-bound shape)
MLA_DECODE_SHAPES = {"8x0-2048": [0, 1, 17, 300, 777, 1024, 1500, 2048],
                     "64x4096": [4096] * 64}
# (b) the flash forward at 192 / 128 at the padded prefill of phase 5's
# prompts (8 x 1024 rows, kv_len the prompt lengths), and an fp32 cut
MLA_FLASH_SERVE = (1024, 128)  # S (the prompts' bucket), H
MLA_FLASH_FP32 = (2, 256, 16, [256, 100])  # B, S, H, kv_len
MLA_NEW_TOKENS = 32
# (d) the card against the CPU at deepseek-v2's attention width (d 5120,
# 128 heads, q_lora 1536, kv_lora 512) in fp32: 2 layers (1 dense + 1
# MoE), 8 experts of ff 1024 top-6 with 2 shared, a vocab of 32768
MLA_DIFF_CUT = dict(num_layers=2, vocab_size=32768, dtype="float32")
MLA_DIFF_EXPERTS = dict(num_experts=8, d_ff_expert=1024)
# phase 23: MoE and MLA training (deepseek-v2).  Full width, 2 of its 60
# layers (1 dense + 1 MoE: 5.36 G parameters); bf16 params and grads and
# the fp32 AdamW moments stand at 64.3 GB (59.9 GiB) of the card's 80
MTRAIN = "flash_attention_fwd[192/128 train]"
MTRAIN_LAYERS = 2
MTRAIN_BATCH, MTRAIN_SEQ, MTRAIN_STEPS = 1, 2048, 3  # + 1 untimed warm-up
MTRAIN_HEADS = 128
# (a) the flash forward at 192 / 128 without kv_len: an fp32 cut (B, S, H),
# and the gradient card vs CPU (B, S, H; with and without kv_len)
MTRAIN_FLASH_FP32 = (2, 256, 16)
MTRAIN_GRAD = (1, 256, 8)
MTRAIN_GRAD_KV_LEN = [100]
# (c) the card against the CPU in fp32: deepseek-v2's attention width, 2
# layers (the lead dense block's d_ff cut to 1024), 8 experts of ff 1024
# top-6 with 2 shared, cf 1.25, a vocab of 32768; 3 steps at 2 x 128
MTRAIN_DIFF_CUT = dict(num_layers=2, d_ff=1024, vocab_size=32768,
                       dtype="float32")
MTRAIN_DIFF_EXPERTS = dict(num_experts=8, d_ff_expert=1024)
MTRAIN_DIFF_BATCH, MTRAIN_DIFF_SEQ, MTRAIN_DIFF_STEPS = 2, 128, 3
# the aux is a mean of fp32 products over 256 tokens: 1e-5 absolute
MTRAIN_AUX_ATOL = 1e-5
# phase 24: training of the recurrent families, zamba2-1.2b at 4 x 2048
# and xlstm-350m at 4 x 1024, full size (their kernels' rows in the
# kernels' JSON: the shapes these steps give them)
RTRAIN_SSD = "ssd_chunked_fwd[train]"
RTRAIN_MLSTM = "mlstm_chunked_fwd[train]"
RTRAIN_FLASH = "flash_attention_fwd[64 train, 32 heads]"
HTRAIN_BATCH, HTRAIN_SEQ = 4, 2048
XTRAIN_BATCH, XTRAIN_SEQ = 4, 1024
RTRAIN_STEPS = 3  # + 1 untimed warm-up step
# (a) zamba2's SSD (B, L, H, P, N, G, chunk) and (b) xlstm's mLSTM (B, L,
# H, P, chunk, gates, state) at those shapes, from the zero state; their
# fp32 gradients card vs CPU at two-chunk cuts, within 1e-4 x the largest
# element of each gradient (the recompute backward's sums in another
# order on each side; the CPU tests hold it to the reference at 1e-5)
RTRAIN_SSD_CASE = (HTRAIN_BATCH, HTRAIN_SEQ, 32, 128, 64, 1, 128)
RTRAIN_MLSTM_CASE = (XTRAIN_BATCH, XTRAIN_SEQ, 4, 512, 64, "normal", "empty")
RTRAIN_SSD_GRAD = (2, 256, 4, 128, 64, 1, 128)
RTRAIN_MLSTM_GRAD = (2, 128, 2, 512, 64, "normal", "empty")
RTRAIN_GRAD_RTOL = 1e-4
# zamba2's shared attention in training: 32 heads of D 64, group 1
RTRAIN_FLASH_CASE = (HTRAIN_BATCH, HTRAIN_SEQ, HTRAIN_SEQ, 32, 32, 64, True,
                     0, "bfloat16")
# (e) the reduced forms, fp32, 3 steps at 2 x 128, card vs CPU (phase
# 10's bounds)
RDIFF_BATCH, RDIFF_SEQ, RDIFF_STEPS = 2, 128, 3
# phase 26: tensor-parallel serving and the expert-parallel MoE, ranks of
# one gloo world sharing the card (walls of ranks that share one card and
# gather through the host: not a tensor-parallel deployment's speed)
TP = 3  # smollm-135m's 3 KV heads, one a rank
TP_SHAPES = "smollm-135m/tp3"
TP_ENGINE = dict(max_seqs=8, num_pages=2048, max_model_len=2048,
                 enable_chunked_prefill=True, max_prefill_tokens=512,
                 seed=SEED, debug_logits=True, device=DEVICE,
                 cuda_graphs=False)
TP_NEW_TOKENS = 32
TP_LOGIT_ATOL = 1e-5
TP_LEAD_CYCLES = 2_000_000  # the spin that hides a timed call's enqueue
EP_ARCH = "deepseek-v2-236b"
EP_RANKS = 4
EP_SEED = SEED + 26
EP_ROWS = (8, 520)
EP_ATOL, EP_FP32_ATOL = 2e-2, 2e-5
EP_FP32_CUT = dict(d_model=512, moe=dict(num_experts=8, d_ff_expert=1024))
EP_ROW = f"moe_grouped_gemm[{EP_ARCH} ep{EP_RANKS} tail]"
COLL_EF_STEPS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------


def decode_inputs(torch, dtype, ps, *, hkv=3, group=3, d=64,
                  ctx=(0, 1, 17, 100, 511, 1000, 1500, 2048),
                  max_model_len=2048, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    s = len(ctx)
    np_ = -(-max_model_len // ps)
    p = s * np_ + 1
    q = torch.randn((s, hkv * group, d), generator=g).to(dtype)
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: s * np_].reshape(s, np_)
          + 1).to(torch.int32)
    dev = DEVICE
    return (q.to(dev), kp.to(dev), vp.to(dev), pt.to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


def prefill_inputs(torch, tops, dtype, ps, *, hkv, group, d, qlens, ctx,
                   stride, block_q=PAGED_BLOCK_Q, max_model_len=2048,
                   seed=2):
    """Q-Block prefill inputs: sequence i has qlens[i] query rows ending at
    context ctx[i], packed back to back (stride None: the packed step's
    chunk region) or starting at i * stride (the padded step's uniform
    layout); q_packed / qb metadata as ops.paged_attention_prefill builds
    them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ms = len(qlens)
    qlens, ctx = list(qlens), list(ctx)
    t = sum(qlens) if stride is None else ms * stride
    np_ = -(-max_model_len // ps)
    p = ms * np_ + 1
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: ms * np_].reshape(ms, np_)
          + 1).to(torch.int32)
    qlens_t = torch.tensor(qlens, dtype=torch.int32)
    if stride is None:
        qsl = torch.cat([torch.zeros(1, dtype=torch.int32),
                         torch.cumsum(qlens_t, 0, dtype=torch.int32)])
    else:
        qsl = torch.arange(ms + 1, dtype=torch.int32) * stride
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    nqb = t // block_q + ms
    qb_seq, qb_pos0, _, _ = tops.build_qblock_metadata(
        qsl, qlens_t, ctx_t, block_q=block_q, num_q_blocks=nqb)
    q_packed = torch.randn((nqb, hkv, block_q * group, d), generator=g).to(
        dtype)
    dev = DEVICE
    return dict(q_packed=q_packed.to(dev), k=kp.to(dev), v=vp.to(dev),
                qb_seq=qb_seq.to(dev), qb_pos0=qb_pos0.to(dev),
                pt=pt.to(dev), ctx=ctx_t.to(dev), block_q=block_q,
                group=group, qlens=qlens)


def tile_view(pages, tile):
    hkv, p, ps, d = pages.shape
    return pages.reshape(hkv, p, ps // tile, tile, d)


# ---------------------------------------------------------------------------
# one call per kernel (kernel wrapper or plain version, same inputs)
# ---------------------------------------------------------------------------


def paged_heads(arch):
    """(hkv, group, head_dim, page_size) of the model a shape set is for
    (a set's name is the model's, or the model's and a "/" suffix); the
    KV heads of one rank where the set names a tensor-parallel `tp`."""
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch.split("/")[0]]
    tp = PAGED_SHAPES.get(arch, {}).get("tp", 1)
    return (cfg.num_kv_heads // tp, cfg.num_q_heads // cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.page_size)


def kernel_calls(torch, K, dtype, ps, tile, tops, arch=ARCH):
    """({name: (kernel_fn, plain_fn)}, inputs) at the shapes arch's serve
    phase gives the kernels (PAGED_SHAPES); both functions of a pair take
    the same tensors.  A set without decode contexts gives the prefill
    alone."""
    shp = PAGED_SHAPES[arch]
    hkv, group, d, _ = paged_heads(arch)
    scale = d ** -0.5
    calls, x = {}, {}
    if shp["ctx"] is not None:
        calls, x = decode_calls(torch, K, dtype, ps, tile, shp, hkv, group,
                                d, scale)
    pf = None
    if shp["qlens"] is not None:
        pf = prefill_inputs(torch, tops, dtype, ps, hkv=hkv, group=group,
                            d=d, qlens=shp["qlens"], ctx=shp["pf_ctx"],
                            stride=shp["stride"])
        pkt, pvt = tile_view(pf["k"], tile), tile_view(pf["v"], tile)
        pf_args = (pf["q_packed"], pkt, pvt, pf["qb_seq"], pf["qb_pos0"],
                   pf["pt"], pf["ctx"])
        pf_kw = dict(block_q=pf["block_q"], group=pf["group"], scale=scale)
        calls["paged_prefill_qblock"] = (
            lambda: K.paged_prefill_qblock(*pf_args, **pf_kw),
            lambda: K.paged_prefill_qblock_plain(*pf_args, **pf_kw))
    return calls, dict(x, pf=pf, tile=tile, ps=ps)


def decode_calls(torch, K, dtype, ps, tile, shp, hkv, group, d, scale):
    """The decode kernels' pairs of `kernel_calls` at a set's contexts."""
    q, kp, vp, pt, ctx = decode_inputs(torch, dtype, ps, hkv=hkv,
                                       group=group, d=d, ctx=shp["ctx"])
    s, hq, _ = q.shape
    kt, vt = tile_view(kp, tile), tile_view(vp, tile)
    num_tiles = pt.shape[1] * (ps // tile)
    nseg = min(shp["num_segments"], num_tiles)
    tps = -(-num_tiles // nseg)
    qg = q.reshape(s, hkv, group, d).contiguous()
    qb = q.reshape(s, hq, 1, d).contiguous()
    seg_kw = dict(num_segments=nseg, tiles_per_segment=tps, scale=scale)
    parts = K.paged_decode_segmented(qg, kt, vt, pt, ctx, **seg_kw)
    calls = {
        "paged_decode": (
            lambda: K.paged_decode(qg, kt, vt, pt, ctx, cells_per_kv=1,
                                   scale=scale),
            lambda: K.paged_decode_plain(qg, kt, vt, pt, ctx, cells_per_kv=1,
                                         scale=scale)),
        "paged_decode[baseline]": (
            lambda: K.paged_decode(qb, kt, vt, pt, ctx, cells_per_kv=group,
                                   scale=scale),
            lambda: K.paged_decode_plain(qb, kt, vt, pt, ctx,
                                         cells_per_kv=group, scale=scale)),
        "paged_decode_segmented": (
            lambda: K.paged_decode_segmented(qg, kt, vt, pt, ctx, **seg_kw),
            lambda: K.paged_decode_segmented_plain(qg, kt, vt, pt, ctx,
                                                   **seg_kw)),
        "segment_reduce": (
            lambda: K.segment_reduce(*parts, dtype),
            lambda: K.segment_reduce_plain(*parts, dtype)),
        MERGED: (
            lambda: K.paged_decode_segmented_merged(qg, kt, vt, pt, ctx,
                                                    **seg_kw),
            lambda: K.paged_decode_segmented_merged_plain(qg, kt, vt, pt, ctx,
                                                          **seg_kw)),
    }
    return calls, dict(q=q, kp=kp, vp=vp, pt=pt, ctx=ctx, nseg=nseg,
                       tps=tps, parts=parts)


def max_err(torch, name, got, want):
    """Max abs error; the segmented partials are compared as acc / l
    (the unnormalised accumulator grows with the context) plus m, l."""
    if name == "paged_decode_segmented":
        (o, m, l), (o2, m2, l2) = got, want
        norm = lambda a, b: a / torch.where(b == 0, 1.0, b)[..., None]  # noqa: E731
        errs = [(norm(o, l) - norm(o2, l2)).abs().max(),
                (m - m2).abs().max(),
                ((l - l2).abs() / l2.clamp_min(1.0)).max()]
        return max(float(e) for e in errs)
    return float((got.float() - want.float()).abs().max())


def dead_segments_exact(torch, x):
    """True when every segment without a live key holds exactly m = NEG,
    l = 0 and acc = 0 (segment_reduce's dead test m <= NEG / 2 and its
    exact zeros rely on it); fails too if the shape has no dead segment."""
    from repro_torch.kernels._common import NEG_INF

    o, m, l = x["parts"]
    start = torch.arange(x["nseg"], device=m.device) * x["tps"] * x["tile"]
    dead = start[None, :] >= x["ctx"][:, None]  # [S, nseg]
    return bool(dead.any()) \
        and bool((m.permute(0, 2, 1, 3)[dead] == NEG_INF).all()) \
        and bool((l.permute(0, 2, 1, 3)[dead] == 0).all()) \
        and bool((o.permute(0, 2, 1, 3, 4)[dead] == 0).all())


def same_bits(torch, a, b):
    """True when a and b hold the same bits (not merely equal values)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def phase_check(torch, K, tops):
    """Each paged kernel against its plain version at both serve phases'
    shapes, at qwen2.5-3b's and glm4-9b's heads and (the prefill) at the
    padded step's resumed chunks with smollm's heads, and the folded C3
    launch against the two launches it replaces, bit for bit; returns
    each kernel's worst error over all of them."""
    errs: dict[str, float] = {}
    for arch, shp in PAGED_SHAPES.items():
        hkv, group, d, page_size = paged_heads(arch)
        if page_size not in shp["page_sizes"]:
            raise AssertionError(f"PAGED_SHAPES[{arch!r}] misses the "
                                 f"model's page size {page_size}")
        for ps in shp["page_sizes"]:
            for dtype_name in ("float32", "bfloat16"):
                dtype = getattr(torch, dtype_name)
                tile = tops.default_tile(ps)
                calls, x = kernel_calls(torch, K, dtype, ps, tile, tops, arch)
                for name, (kfn, pfn) in calls.items():
                    got = kfn()
                    want = pfn()
                    torch.cuda.synchronize()
                    err = max_err(torch, name, got, want)
                    ok = err <= ATOL[dtype_name]
                    log(f"check {name:29s} {arch:12s} Hkv {hkv:2d} group "
                        f"{group} D {d} {dtype_name:8s} page {ps:2d} tile "
                        f"{tile:2d}  max_abs_err {err:.3e}  atol "
                        f"{ATOL[dtype_name]:g}  {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"{name} disagrees with its plain version "
                            f"({arch} shapes, {dtype_name}, page {ps})")
                    base = name.split("[")[0]
                    errs[base] = max(errs.get(base, 0.0), err)
                    key = f"{base}[{arch}]"
                    errs[key] = max(errs.get(key, 0.0), err)
                if shp["ctx"] is None:
                    continue  # the prefill alone
                merged = calls[MERGED][0]()
                pair = K.segment_reduce(*calls["paged_decode_segmented"][0](),
                                        dtype)
                torch.cuda.synchronize()
                if not same_bits(torch, merged, pair):
                    raise AssertionError(
                        f"{MERGED} differs from paged_decode_segmented + "
                        f"segment_reduce ({arch}, {dtype_name}, page {ps}): "
                        f"max abs diff "
                        f"{float((merged.float() - pair.float()).abs().max())}")
                log(f"check {MERGED} {arch} {dtype_name} page {ps}: the bits "
                    f"of paged_decode_segmented + segment_reduce")
                key = f"segment_reduce[{arch}]"
                errs[key] = max(errs.get(key, 0.0), errs[f"{MERGED}[{arch}]"])
                if shp["ctx"][0] == 0:  # exact zeros for a dead decode row
                    for out in (calls["paged_decode"][0](), merged):
                        if not bool((out[0] == 0).all()):
                            raise AssertionError("context-0 decode row is "
                                                 "not exact zeros")
                if not dead_segments_exact(torch, x):
                    raise AssertionError(f"a dead segment is not exactly "
                                         f"(acc 0, m NEG, l 0): {arch}, "
                                         f"{dtype_name}, page {ps}")
    return errs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters, flush, lead_cycles=0):
    """Median ms of `fn` between two CUDA events, L2 flushed before each
    call.  The events also take in the host's enqueue of `fn` where it
    outlasts the flush; `lead_cycles` > 0 spins the stream that long
    after the flush, so the enqueue hides behind it."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()  # evict the 50 MB L2: the step finds KV cold
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def host_us(torch, fn, iters=20):
    """Mean host time of one call of `fn` (enqueue only, no sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def bounds(name, x, dtype_name):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and FLOPs /
    peak, counting each input read once, each output written once, and
    only the K/V this run's contexts need."""
    e = 2 if dtype_name == "bfloat16" else 4
    q, pt, ctx, tile = x["q"], x["pt"], x["ctx"], x["tile"]
    s, hq, d = q.shape
    hkv = x["kp"].shape[0]
    ctx_l = [int(c) for c in ctx.tolist()]
    live_kv = sum(-(-c // tile) * tile for c in ctx_l)
    meta = pt.numel() * 4 + ctx.numel() * 4
    nseg = x["nseg"]
    m = hq // hkv
    seg_out = s * hkv * nseg * (m * d + 2 * m) * 4
    if name == "paged_decode":
        nbytes = 2 * q.numel() * e + 2 * live_kv * hkv * d * e + meta
        flops = 4 * hq * d * sum(ctx_l)
    elif name == "paged_decode_segmented":
        nbytes = q.numel() * e + 2 * live_kv * hkv * d * e + meta + seg_out
        flops = 4 * hq * d * sum(ctx_l)
    elif name == "segment_reduce":
        nbytes = seg_out + q.numel() * e
        flops = 3 * s * hkv * nseg * m * d
    elif name in (MERGED, PAIR):  # the partials are workspace
        nbytes = 2 * q.numel() * e + 2 * live_kv * hkv * d * e + meta
        flops = 4 * hq * d * sum(ctx_l) + 3 * s * hkv * nseg * m * d
    else:  # paged_prefill_qblock
        pf = x["pf"]
        pctx = [int(c) for c in pf["ctx"].tolist()]
        live = sum(-(-c // tile) * tile for c in pctx)
        nbytes = (2 * pf["q_packed"].numel() * e + 2 * live * hkv * d * e
                  + pf["pt"].numel() * 4 + 2 * pf["qb_seq"].numel() * 4)
        keys = 0  # causal keys per live query row
        for c, ql in zip(pctx, pf["qlens"]):
            start = c - ql
            keys += sum(start + i + 1 for i in range(ql))
        flops = 4 * hq * d * keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_calls(torch, x):
    """One PyTorch yardstick per kernel where one computes the same
    function: a page gather + scaled_dot_product_attention (timed only,
    never used by the port)."""
    F = torch.nn.functional
    q, kp, vp, pt, ctx = x["q"], x["kp"], x["vp"], x["pt"], x["ctx"]
    s, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    group = hq // hkv
    length = pt.shape[1] * ps
    pos = torch.arange(length, device=q.device)
    dmask = (pos[None, :] < ctx[:, None].long())[:, None, None, :]
    pt_l = pt.long()

    def decode():
        k = kp[:, pt_l].reshape(hkv, s, length, d).transpose(0, 1)
        v = vp[:, pt_l].reshape(hkv, s, length, d).transpose(0, 1)
        k = k.repeat_interleave(group, 1)
        v = v.repeat_interleave(group, 1)
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=dmask)

    pf = x["pf"]
    qp, qb_seq, qb_pos0 = pf["q_packed"], pf["qb_seq"], pf["qb_pos0"]
    nqb, _, bm, _ = qp.shape
    seq_c = qb_seq.clamp_min(0).long()
    ppt = pf["pt"].long()[seq_c]  # [NQB, Np]
    pctx = pf["ctx"].long()[seq_c]
    q_pos = qb_pos0.long()[:, None] + torch.arange(bm, device=q.device) \
        // pf["group"]
    pmask = ((pos[None, None, :] < pctx[:, None, None])
             & (pos[None, None, :] <= q_pos[:, :, None]))[:, None]

    def prefill():
        k = pf["k"][:, ppt].reshape(hkv, nqb, length, d).transpose(0, 1)
        v = pf["v"][:, ppt].reshape(hkv, nqb, length, d).transpose(0, 1)
        return F.scaled_dot_product_attention(qp, k, v, attn_mask=pmask)

    # the folded C3 launch, alone or as two, computes decode's function
    return {"paged_decode": decode, MERGED: decode, PAIR: decode,
            "paged_prefill_qblock": prefill}


def phase_time(torch, K, tops, dtype_name="bfloat16", iters=20):
    """Each paged kernel and the folded C3 launch at smollm's serve shapes
    (the rows of the kernels' JSON), the two launches it folds timed as
    one call, then, logged only, the Q-Block prefill and the decode
    kernels at zamba2's shapes, the decode kernels at qwen2.5-3b's
    heads and the Q-Block prefill at the verify rows' shapes; then the
    Q-Block prefill and the decode kernels at qwen2-vl-2b's and
    musicgen-large's heads, returned as rows "<name>[<arch>]" (the
    folded launch also as "segment_reduce[<arch>]")."""
    dtype = getattr(torch, dtype_name)
    ps = 16
    tile = tops.default_tile(ps)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def row(name, calls, lib, x, arch):
        kfn, pfn = calls[name]
        ms = time_ms(torch, kfn, iters, flush)
        plain_ms = time_ms(torch, pfn, 3, flush)
        lib_ms = time_ms(torch, lib[name], iters, flush) if name in lib \
            else None
        bound_ms, bound_by = bounds(name, x, dtype_name)
        log(f"time  {name:37s} {arch:12s} {dtype_name} kernel_ms {ms:.4f}  "
            f"plain_ms {plain_ms:.4f}  library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}  bound_ms "
            f"{bound_ms:.5f} ({bound_by})  host_us "
            f"{host_us(torch, kfn):.1f}")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=bound_ms, bound_by=bound_by)

    calls, x = kernel_calls(torch, K, dtype, ps, tile, tops)
    calls[PAIR] = (lambda: K.segment_reduce(
        *calls["paged_decode_segmented"][0](), dtype), calls[MERGED][1])
    lib = library_calls(torch, x)
    rows = {name: row(name, calls, lib, x, ARCH)
            for name in (*REPLACES, MERGED, PAIR)}
    del calls, x, lib
    for arch, names in ((HYBRID_ARCH, ("paged_prefill_qblock", "paged_decode",
                                       "paged_decode_segmented", MERGED)),
                        ("qwen2.5-3b", ("paged_decode",
                                        "paged_decode_segmented", MERGED)),
                        ("smollm-135m/verify", ("paged_prefill_qblock",))):
        calls, x = kernel_calls(torch, K, dtype, ps, tile, tops, arch)
        lib = library_calls(torch, x)
        for name in names:
            row(name, calls, lib, x, arch)
        del calls, x, lib
    for arch in FAMILY_ARCHS:
        calls, x = kernel_calls(torch, K, dtype, ps, tile, tops, arch)
        lib = library_calls(torch, x)
        for name in ("paged_prefill_qblock", "paged_decode",
                     "paged_decode_segmented", MERGED):
            rows[f"{name}[{arch}]"] = row(name, calls, lib, x, arch)
        rows[f"segment_reduce[{arch}]"] = rows[f"{MERGED}[{arch}]"]
        del calls, x, lib
    return rows


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def check_paged_routes(K, launches, tag, dtype):
    """The paged kernels a serving run launched, by device kernel: every
    C3 decode one folded launch (the partial-only kernel and the
    standalone merge never), every prefill the kernel of the model's dtype
    (bf16: the tensor-core kernel)."""
    mma = dtype == "bfloat16"
    want = {"decode_stream_kernel": launches["paged_decode"],
            "decode_stream_seg_kernel": 0,
            "decode_stream_seg_merge_kernel": launches["segment_reduce"],
            "segment_reduce_kernel": 0,
            "prefill_mma_kernel": launches["paged_prefill_qblock"] * mma,
            "prefill_kernel": launches["paged_prefill_qblock"] * (not mma)}
    log(f"{tag} paged kernels {K.KERNEL_LAUNCHES}")
    if K.KERNEL_LAUNCHES != want \
            or launches["paged_decode_segmented"] != launches["segment_reduce"]:
        raise AssertionError(f"paged kernels {K.KERNEL_LAUNCHES} != {want} "
                             f"(launches {launches})")


def serve_run(torch, eng, reqs, tag):
    """Serve `reqs` on `eng` to the end.  Every kernel launch counter is
    zeroed just before and read just after.  Each step ends in the host
    copy of its sampled ids (a synchronisation), so its host wall is its
    time; a step is "captured" when it captured a CUDA graph, "replayed"
    when it replayed one and captured none, else "eager".  Returns the
    steps' stats, their logits (the engine's debug copies, kept on the
    card), the wall, each step's wall, the walls by kind and the
    counters."""
    from repro_torch.serving.cuda_graphs import kernel_counters

    for r in reqs:
        eng.add_request(r)
    for counts in kernel_counters():
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    stats, logits, walls = [], [], []
    split = {kind: [0, 0.0] for kind in ("captured", "replayed", "eager")}
    t0 = time.perf_counter()
    while eng.sched.has_work and len(stats) < 1000:
        before = dict(eng.graph_stats)
        t_step = time.perf_counter()
        stats.append(eng.step())
        dt = time.perf_counter() - t_step
        walls.append(dt)
        kind = ("captured" if eng.graph_stats["captures"] > before["captures"]
                else "replayed" if eng.graph_stats["replays"]
                > before["replays"] else "eager")
        split[kind][0] += 1
        split[kind][1] += dt
        logits.append(eng.last_step_logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, x in enumerate(logits):  # checked after the timed loop
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: non-finite logits at step {i + 1}")
    return dict(eng=eng, reqs=reqs, stats=stats, logits=logits, wall=wall,
                step_walls=walls, split=split,
                counts=[dict(c) for c in kernel_counters()])


def stream_run(torch, eng, reqs, tag):
    """Serve `reqs` on `eng` through `submit()` + `run()` (the async loop).
    Every kernel launch counter is zeroed just before and read just after.
    Each launch's logits are taken as `_finish_step` hands them over and
    stay on the card until the loop has ended: a check inside the loop
    would wait for the launch dispatched after it, and so serialise the
    loop.  A step's wall is the time from one `_finish_step` return to
    the next (it holds the dispatch of the step after it), "replayed"
    when no capture fell in it.  Returns what `serve_run` returns, with each request's
    time to its first token (`ttft_s`) and the mean wall of the replayed
    steps."""
    from repro_torch.serving.cuda_graphs import kernel_counters
    from repro_torch.serving.request import State

    logits, marks = [], []
    finish = eng._finish_step

    def record(flight):
        stats = finish(flight)
        marks.append((time.perf_counter(), eng.graph_stats["captures"]))
        if flight.pack is not None:  # kept on the card: no wait here
            logits.append(flight.logits)
        return stats

    eng._finish_step = record
    for r in reqs:
        eng.submit(r)
    for counts in kernel_counters():
        counts.update(dict.fromkeys(counts, 0))
    torch.cuda.synchronize()
    first: dict[int, float] = {}
    t0 = time.perf_counter()
    out = eng.run(on_token=lambda rid, tok: first.setdefault(
        rid, time.perf_counter() - t0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if out["unfinished"] or not all(r.state is State.FINISHED for r in reqs):
        raise AssertionError(f"{tag}: run() left requests unfinished")
    for i, x in enumerate(logits):  # checked after the timed loop
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: non-finite logits at launch "
                                 f"{i + 1}")
    walls, prev = [], (t0, 0)
    for mark in marks:
        if mark[1] == prev[1]:
            walls.append(mark[0] - prev[0])
        prev = mark
    return dict(eng=eng, reqs=reqs, logits=logits, wall=wall,
                counts=[dict(c) for c in kernel_counters()],
                ttft_s=[first[r.req_id] for r in reqs],
                replayed_mean_s=statistics.fmean(walls) if walls else None,
                steps=len(marks))


def async_vs_sync(torch, tag, sync, streamed):
    """The synchronous graphed run `sync` (`serve_run`) against the same
    requests through `run()` (`stream_run`), graphs on: identical tokens,
    launch counters and compile_events, and the logits launch by launch
    bit for bit (a replay of the same graphs on the same inputs; the async
    launches read their decode inputs from the previous launch on the
    card).  Logs both walls, the replayed steps' mean wall and the
    capture seconds."""
    seng, aeng = sync["eng"], streamed["eng"]
    same_tokens = [(r.prompt, r.output) for r in sync["reqs"]] \
        == [(r.prompt, r.output) for r in streamed["reqs"]]
    same_counts = sync["counts"] == streamed["counts"]
    same_events = seng.compile_events == aeng.compile_events
    bit_equal = len(sync["logits"]) == len(streamed["logits"]) and all(
        torch.equal(a, b) for a, b in zip(sync["logits"], streamed["logits"]))
    n, t = sync["split"]["replayed"]
    log(f"{tag} run()-vs-step(): wall step() {sync['wall']:.3f}s run() "
        f"{streamed['wall']:.3f}s  replayed steps' mean wall step() "
        f"{1e3 * t / max(n, 1):.3f} ms ({n} steps) run() "
        f"{1e3 * (streamed['replayed_mean_s'] or float('nan')):.3f} ms  "
        f"capture_s step() {seng.graph_stats['capture_s']:.3f} run() "
        f"{aeng.graph_stats['capture_s']:.3f}  captures "
        f"{seng.graph_stats['captures']} / {aeng.graph_stats['captures']}  "
        f"replays {seng.graph_stats['replays']} / "
        f"{aeng.graph_stats['replays']}  steps {len(sync['stats'])} / "
        f"{streamed['steps']}")
    log(f"{tag} run()-vs-step(): tokens_identical {same_tokens}  "
        f"counters_identical {same_counts}  compile_events_identical "
        f"{same_events}  logits bit_equal {bit_equal} "
        f"({len(streamed['logits'])} / {len(sync['logits'])} launches)")
    if not (same_tokens and same_counts and same_events and bit_equal):
        raise AssertionError(f"{tag}: run() and step() differ: tokens "
                             f"{same_tokens}, counters {same_counts}, "
                             f"compile_events {same_events}, logits "
                             f"{bit_equal}")
    if not aeng.graph_stats["replays"]:
        raise AssertionError(f"{tag}: run() replayed no graph")
    return dict(wall_run=streamed["wall"],
                replayed_ms_run=1e3 * (streamed["replayed_mean_s"] or 0.0),
                replayed_ms_step=1e3 * t / max(n, 1))


def replay_cost(torch, eng, iters=20, bucket=None, top=0, focus=()):
    """Where a replayed decode step's time goes on the card: the packed
    step's decode-only graph (token bucket max_seqs, or `bucket`) of a
    finished run, replayed `iters` times back to back on its last inputs
    (the card rewrites the same KV slots with the same values): its wall
    on the card over CUDA events, against the sum of its kernels'
    durations and their count under `torch.profiler`.  The difference is
    the time between the graph's nodes, which no host work can fill.
    `top` > 0 also logs that many kernels by device time; `focus` names
    kernels (substrings) whose device time and share of the replay are
    logged and returned as `focus_ms`.  On the padded step
    (`eng._packed` False) the graph is the decode step's."""
    bucket = eng.max_seqs if bucket is None else bucket
    keys = [k for k in eng.compile_events
            if (k[0] == "unified" and k[2] == bucket)
            or (k[0] == "decode" and not eng._packed)]
    graph = eng._compiled[keys[-1]].graph
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / iters
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(iters):
            graph.replay()
        torch.cuda.synchronize()
    busy_us, kernels, by_name = 0.0, 0, []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None) \
                or ev.self_cuda_time_total
            busy_us += us
            kernels += ev.count
            by_name.append((us, ev.count, ev.key))
    busy_ms = busy_us / 1e3 / iters
    kind = "decode" if bucket == eng.max_seqs else "chunk"
    log(f"serve {kind} graph {keys[-1][:3]}: replay {wall_ms:.3f} ms on the "
        f"card (CUDA events, {iters} back to back), its kernels "
        f"{busy_ms:.3f} ms summed ({kernels / iters:.0f} a replay, "
        f"torch.profiler): {wall_ms - busy_ms:.3f} ms between nodes")
    for us, count, name in sorted(by_name, reverse=True)[:top]:
        log(f"  {us / 1e3 / iters:8.3f} ms  x{count / iters:4.0f} a replay"
            f"  {name[:90]}")
    out = dict(decode_replay_ms=wall_ms, decode_kernels_ms=busy_ms,
               decode_kernels=kernels / iters)
    if focus:
        hit = [(us, count) for us, count, name in by_name
               if any(f in name for f in focus)]
        focus_ms = sum(us for us, _ in hit) / 1e3 / iters
        log(f"  {' + '.join(focus)}: {focus_ms:.4f} ms a replay ("
            f"x{sum(c for _, c in hit) / iters:.0f}), {focus_ms / wall_ms:.4f} "
            f"of the replay, {focus_ms / busy_ms:.4f} of its kernels' sum")
        out["focus_ms"] = focus_ms
    return out


def shared_prefix_prompts(torch, g, vocab):
    """SHARED_REQUESTS prompts of one SHARED_PREFIX-token prefix and
    SHARED_OWN tokens of their own, drawn from `g`."""
    prefix = torch.randint(1, vocab, (SHARED_PREFIX,), generator=g).tolist()
    own = torch.randint(SHARED_OWN[0], SHARED_OWN[1] + 1,
                        (SHARED_REQUESTS,), generator=g).tolist()
    return [prefix + torch.randint(1, vocab, (n,), generator=g).tolist()
            for n in own]


def graphs_vs_eager(torch, tag, g, e, dtype):
    """The graphed run `g` (the engine's default) against the eager run `e`
    (`cuda_graphs=False`) of the same requests: identical tokens (prompts
    too: a preemption folds the output into the prompt), launch counters
    and compile_events, and graphs that replayed.  The logits are expected
    bit-equal (a replay runs the captured eager kernels on the same
    inputs); a difference must stay within GRAPH_LOGIT_ATOL (fp32 model)
    or one bf16 ulp of the largest logit (bf16 model).  Logs both walls,
    the captures and replays, and the steps' walls by kind."""
    geng, eeng = g["eng"], e["eng"]
    same_tokens = [(r.prompt, r.output) for r in g["reqs"]] \
        == [(r.prompt, r.output) for r in e["reqs"]]
    same_counts = g["counts"] == e["counts"]
    same_events = geng.compile_events == eeng.compile_events
    bit_equal, worst, top = len(g["logits"]) == len(e["logits"]), 0.0, 0.0
    for a, b in zip(g["logits"], e["logits"]):
        top = max(top, float(b.abs().max()))
        if a.shape != b.shape:
            bit_equal, worst = False, float("inf")
        elif not torch.equal(a, b):
            bit_equal = False
            worst = max(worst, float((a - b).abs().max()))
    bound = GRAPH_LOGIT_ATOL
    if dtype == "bfloat16" and top > 0:
        bound = max(bound, 2.0 ** (math.floor(math.log2(top)) - 7))
    split = " ".join(f"{k} {n} steps {s:.3f}s"
                     for k, (n, s) in g["split"].items())
    log(f"{tag} graphs-vs-eager: wall graphs {g['wall']:.3f}s eager "
        f"{e['wall']:.3f}s  steps {len(g['stats'])}  captures "
        f"{geng.graph_stats['captures']} ({geng.graph_stats['capture_s']:.3f}"
        f"s capturing) replays {geng.graph_stats['replays']}  graphed "
        f"run's steps: {split}  "
        f"eager run's steps {e['split']['eager'][1]:.3f}s")
    log(f"{tag} graphs-vs-eager: tokens_identical {same_tokens}  "
        f"counters_identical {same_counts}  compile_events_identical "
        f"{same_events} ({len(geng.compile_events)})  logits bit_equal "
        f"{bit_equal} max_abs_diff {worst:.3e} (bound {bound:.3e})")
    if not (same_tokens and same_counts and same_events):
        raise AssertionError(f"{tag}: graphs and eager differ: tokens "
                             f"{same_tokens}, counters {same_counts}, "
                             f"compile_events {same_events}")
    if not worst <= bound:
        raise AssertionError(f"{tag}: logits of graphs and eager differ by "
                             f"{worst} > {bound}")
    if not geng.graph_stats["replays"] or eeng.graph_stats["captures"]:
        raise AssertionError(f"{tag}: the graphed run replayed nothing or "
                             f"the eager run captured: {geng.graph_stats}, "
                             f"{eeng.graph_stats}")
    return dict(wall_graphs=g["wall"], wall_eager=e["wall"])


def sampler_cost(torch, s, v, iters=50):
    """What sharing one graph between greedy and sampling steps costs: the
    device time of the packed step's sampler at [S, V], each version
    captured into a CUDA graph and its replays timed over CUDA events (no
    L2 flush: the logits come hot from the head): the filter and draw that
    every graphed step runs, against greedy argmax alone."""
    from repro_torch.models.sampling import sample_tokens
    from repro_torch.serving.cuda_graphs import gc_paused

    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    logits = torch.randn((s, v), generator=g, device=DEVICE) * 4
    temps = torch.zeros((s,), device=DEVICE)
    temps[3] = SERVE_SAMPLED["temperature"]
    top_p = torch.full((s,), SERVE_SAMPLED["top_p"], device=DEVICE)
    top_k = torch.full((s,), SERVE_SAMPLED["top_k"], dtype=torch.int32,
                       device=DEVICE)
    noise = torch.rand((s, v), generator=g, device=DEVICE)
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    ms = {}
    for name, nz in (("filter_and_draw", noise), ("greedy", None)):
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            sample_tokens(logits, temps, top_p, top_k, nz)  # warm-up
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with gc_paused(), torch.cuda.graph(graph, stream=side):
            sample_tokens(logits, temps, top_p, top_k, nz)
        ms[name] = time_ms(torch, graph.replay, iters,
                           torch.empty(1, device=DEVICE))
        del graph
    log(f"serve sampler in a graph at [{s}, {v}]: filter_and_draw "
        f"{ms['filter_and_draw']:.4f} ms, greedy argmax "
        f"{ms['greedy']:.4f} ms a step")
    return ms


def phase_serve(torch, K, FK):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    cfg = ARCHS[ARCH]
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    log(f"serve {ARCH}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_q_heads}/{cfg.num_kv_heads} vocab {cfg.vocab_size}"
        f" {cfg.dtype}; weights in {time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=8, num_pages=2048, max_model_len=2048,
                  enable_chunked_prefill=True, max_prefill_tokens=512,
                  seed=SEED, debug_logits=True, device=DEVICE)
    g, warm_prompts, served = serve_prompts(torch, cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator) on a throwaway engine
    warm = Engine(cfg, model, **eng_kw)
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in warm_prompts])
    del warm
    torch.cuda.synchronize()

    def requests():  # request 3 samples: temperature, top-k and top-p
        return [Request(prompt=list(p), max_new_tokens=32,
                        **(SERVE_SAMPLED if i == 3 else {}))
                for i, p in enumerate(served)]

    eng = Engine(cfg, model, **eng_kw)
    run = serve_run(torch, eng, requests(), "serve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    launches = dict(K.LAUNCHES)
    if not all(r.state is State.FINISHED and len(r.output) == 32
               for r in reqs):
        raise AssertionError("not every request finished")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if FK.LAUNCHES[FLASH]:
        raise AssertionError("serving launched the training kernel")
    check_paged_routes(K, launches, "serve", cfg.dtype)
    if {v for _, v in eng.dispatch_counts} != {"gqa", "segmented"}:
        raise AssertionError("expected mixed steps on gqa and decode-heavy "
                             f"steps on segmented: {eng.dispatch_counts}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"serve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  new_tok_per_s {toks / wall:.1f}  "
        f"total_tok_per_s {(toks + prompt_toks) / wall:.1f}")
    log(f"serve dispatch_counts {dict(eng.dispatch_counts)}")
    log(f"serve launches {launches}  launched_token_slots "
        f"{eng.launched_token_slots}")
    del eng
    # the same requests on the eager step
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **eng_kw),
                      requests(), "serve eager")
    walls = graphs_vs_eager(torch, "serve", run, eager, cfg.dtype)
    del eager
    # (d) the same requests through the two-dispatch sampler
    walls |= two_dispatch_run(torch, cfg, model, eng_kw, requests, run)
    # (a) the same requests through submit() + run(), graphs on
    streamed = stream_run(torch, Engine(cfg, model, **eng_kw), requests(),
                          "serve run()")
    walls |= async_vs_sync(torch, "serve", run, streamed)
    walls |= replay_cost(torch, streamed["eng"])
    del run, streamed
    # (b) the shared-prefix trace through run(), prefix caching off and on
    shared = shared_prefix_prompts(torch, g, cfg.vocab_size)
    walls |= shared_prefix_run(torch, cfg, model, eng_kw, shared)
    # a preempting trace: preemption rewrites the page tables the graphs
    # read from their static buffers
    pre_kw = eng_kw | dict(PREEMPT_ENGINE)
    pre_prompts = [torch.randint(1, cfg.vocab_size, (n,),
                                 generator=g).tolist() for n in PREEMPT_LENS]
    runs = [serve_run(torch, Engine(cfg, model, cuda_graphs=graphs,
                                    **pre_kw),
                      [Request(prompt=list(p),
                               max_new_tokens=PREEMPT_NEW_TOKENS)
                       for p in pre_prompts], f"preempt graphs={graphs}")
            for graphs in (True, False)]
    preempted = sum(st["preempted"] for st in runs[0]["stats"])
    log(f"serve preempt: {len(PREEMPT_LENS)} requests on "
        f"{PREEMPT_ENGINE['num_pages']} pages, {preempted} preemptions")
    if not preempted:
        raise AssertionError("the preempting trace preempted nothing")
    graphs_vs_eager(torch, "serve preempt", *runs, cfg.dtype)
    del runs
    sampler_cost(torch, 2 * eng_kw["max_seqs"], cfg.vocab_size)
    # (c) speculative decoding
    walls |= phase_spec_serve(torch, K, cfg, model, eng_kw, g)
    return launches, dict(steps=steps, wall_s=wall, new_tokens=toks,
                          prompt_tokens=prompt_toks, **walls)


def draw_prompts(torch, g, vocab, n, lo, hi):
    """n prompts of lo..hi tokens drawn from `g`."""
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return [torch.randint(1, vocab, (n_,), generator=g).tolist()
            for n_ in lens]


def serve_prompts(torch, vocab):
    """(generator, warm-up prompts, served prompts) of phase 5: 2 warm-up
    prompts of 40-200 tokens, then the 8 served ones of 128-1024, drawn
    from seed SEED; the generator goes on to phase 5's later traces."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    warm = draw_prompts(torch, g, vocab, 2, 40, 200)
    return g, warm, draw_prompts(torch, g, vocab, 8, 128, 1024)


def shared_prefix_run(torch, cfg, model, eng_kw, prompts):
    """The shared-prefix trace through `run()`, prefix caching off then
    on: every request finishes with its 32 tokens, and with caching on a
    page hits.  Logs the prefill accounting, both walls and each
    request's time to its first token."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    runs = {}
    for caching in (False, True):
        eng = Engine(cfg, model, enable_prefix_caching=caching, **eng_kw)
        runs[caching] = stream_run(
            torch, eng, [Request(prompt=list(p), max_new_tokens=32)
                         for p in prompts], f"shared caching={caching}")
        if not all(len(r.output) == 32 for r in runs[caching]["reqs"]):
            raise AssertionError("shared-prefix trace: a request did not "
                                 "finish its 32 tokens")
    off, on = runs[False], runs[True]
    same = [r.output for r in off["reqs"]] == [r.output for r in on["reqs"]]
    cache = on["eng"].prefix_cache.stats()
    for caching, r in runs.items():
        e = r["eng"]
        log(f"serve shared-prefix caching={caching}: {len(prompts)} requests "
            f"x ({SHARED_PREFIX} shared + {SHARED_OWN[0]}-{SHARED_OWN[1]} own)"
            f" tokens, 32 new each: wall {r['wall']:.3f}s  steps "
            f"{r['steps']}  prefilled_tokens {e.prefilled_tokens}  "
            f"cached_prefill_tokens {e.cached_prefill_tokens}  "
            f"launched_token_slots {e.launched_token_slots}  ttft_ms "
            f"{[round(1e3 * t, 1) for t in r['ttft_s']]}")
    log(f"serve shared-prefix: prefix cache {cache}  tokens identical "
        f"off / on {same} (bf16: the cached prefix's KV comes from another "
        f"request's launch)")
    if not cache["cache_hits"] or not on["eng"].cached_prefill_tokens:
        raise AssertionError(f"shared-prefix trace: no page hit ({cache})")
    return dict(shared_wall_off=off["wall"], shared_wall_on=on["wall"],
                cached_prefill_tokens=on["eng"].cached_prefill_tokens)


def first_divergence(a, b):
    """(request, position) of the first token where two runs' requests
    (prompt + output) differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        sx, sy = x.prompt + x.output, y.prompt + y.output
        for j, (u, v) in enumerate(zip(sx, sy)):
            if u != v:
                return i, j
        if len(sx) != len(sy):
            return i, min(len(sx), len(sy))
    return None


def logits_diff(torch, a, b):
    """(bit_equal, max abs diff) of two runs' logits, step by step."""
    if len(a) != len(b):
        return False, float("inf")
    worst, equal = 0.0, True
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return False, float("inf")
        if not torch.equal(x, y):
            equal = False
            worst = max(worst, float((x - y).abs().max()))
    return equal, worst


def two_dispatch_run(torch, cfg, model, eng_kw, requests, fused):
    """Phase 5 (d): the serve trace with `fused_sampling=False` (the packed
    launch returns its logits, a second dispatch samples them), graphs
    on, against the fused graphed run `fused`: identical tokens, launch
    counters and compile_events, {"unified": n, "sample": n} device
    calls, logits bit for bit (the same launch up to the head; the
    sampler is outside it).  Logs both walls."""
    from repro_torch.serving.engine import Engine

    two = serve_run(torch, Engine(cfg, model, fused_sampling=False,
                                  **eng_kw), requests(), "two-dispatch")
    eng, n = two["eng"], len(two["stats"])
    same = first_divergence(two["reqs"], fused["reqs"]) is None
    same_counts = two["counts"] == fused["counts"]
    same_events = eng.compile_events == fused["eng"].compile_events
    bit_equal, worst = logits_diff(torch, two["logits"], fused["logits"])
    calls = dict(eng.device_calls)
    log(f"serve two-dispatch: wall {two['wall']:.3f}s against fused "
        f"{fused['wall']:.3f}s  steps {n} / {len(fused['stats'])}  device "
        f"calls {calls}  captures {eng.graph_stats['captures']} "
        f"({eng.graph_stats['capture_s']:.3f}s capturing) replays "
        f"{eng.graph_stats['replays']}")
    log(f"serve two-dispatch: tokens_identical {same}  counters_identical "
        f"{same_counts}  compile_events_identical {same_events}  logits "
        f"bit_equal {bit_equal} max_abs_diff {worst:.3e}")
    if not (same and same_counts and same_events and bit_equal):
        raise AssertionError("two-dispatch and fused runs differ")
    if calls != {"unified": n, "sample": n}:
        raise AssertionError(f"two-dispatch device calls {calls}")
    return dict(two_dispatch_wall=two["wall"], fused_wall=fused["wall"])


def spec_prompts(torch, g, vocab, lens):
    """Prompts of `lens` tokens drawn from `g`: the even ones repeat a
    cycle of SPEC_CYCLE tokens to their length (the n-gram drafter
    proposes from it), the odd ones are random."""
    out = []
    for i, n in enumerate(lens):
        if i % 2:
            out.append(torch.randint(1, vocab, (n,), generator=g).tolist())
            continue
        c = int(torch.randint(SPEC_CYCLE[0], SPEC_CYCLE[1] + 1, (1,),
                              generator=g))
        cycle = torch.randint(1, vocab, (c,), generator=g).tolist()
        out.append((cycle * (n // c + 1))[:n])
    return out


def noise_cost(torch, v, k, iters=20):
    """The host part of the sampler on the card: the wall of
    `sampling.gumbel_noise` (zero the static buffer, then one seeded
    generator and `torch.rand` a row, on the host) for one row, for the
    K + 1 rows of one sampled verify row, and for every row of a spec
    engine's buffer; synchronised, median of `iters`."""
    from repro_torch.models import sampling

    n = 16 * (k + 1)
    out = torch.zeros((n, v), device=DEVICE)
    ids = list(range(n))
    ms = {}
    for rows in (1, k + 1, n):
        walls = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampling.gumbel_noise(SEED, ids, ids, v, DEVICE,
                                  rows=list(range(rows)), out=out)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ms[rows] = 1e3 * statistics.median(walls)
    log(f"serve noise (host part of the sampler, [{n}, {v}] buffer): "
        + "  ".join(f"{r} rows {t:.3f} ms" for r, t in ms.items()))
    return ms


def phase_spec_serve(torch, K, cfg, model, eng_kw, g):
    """Phase 5 (c): speculative decoding on the serve trace's shape, graphs
    on: 8 requests of 128-1024 prompt tokens (the even ones a repeated
    cycle), 32 new tokens, request 2 sampled; with draft_k SPEC_DRAFT_K
    against the same requests without speculation.  In bf16 (the serving
    dtype): drafts proposed, accepted and rejected, one `unified` device
    call a step, no page leaked, the verify rows on the Q-Block prefill,
    and the spec run against itself eagerly (`graphs_vs_eager`); the
    tokens against the run without speculation are logged, with the first
    divergence: a verify row's logits come from the Q-Block prefill, a
    decode row's from the decode kernel, and in bf16 a near-tie (a
    sampled row's draw above all) can go either way.  Then the same
    trace in fp32 (TF32 off), where those paths agree to ~1e-6: identical
    tokens with and without speculation, the sampled request included.
    Logs steps, accept rate, captures by key and both walls; times the
    sampler at [S (K+1), V] and its host part."""
    from repro_torch import weights
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    lens = torch.randint(128, 1025, (8,), generator=g).tolist()
    prompts = spec_prompts(torch, g, cfg.vocab_size, lens)

    def requests():
        return [Request(prompt=list(p), max_new_tokens=32,
                        **(SERVE_SAMPLED if i == 2 else {}))
                for i, p in enumerate(prompts)]

    spec_kw = eng_kw | dict(speculative=True, draft_k=SPEC_DRAFT_K)
    base = serve_run(torch, Engine(cfg, model, **eng_kw), requests(),
                     "spec base")
    spec = serve_run(torch, Engine(cfg, model, **spec_kw), requests(),
                     "spec")
    launches = dict(K.LAUNCHES)
    eng, steps = spec["eng"], len(spec["stats"])
    st = dict(eng.spec_stats)
    diverged = first_divergence(spec["reqs"], base["reqs"])
    agree = sum(a.output == b.output
                for a, b in zip(spec["reqs"], base["reqs"]))
    rate = st["accepted"] / st["proposed"] if st["proposed"] else 0.0
    gs = eng.graph_stats
    log(f"serve spec: draft_k {SPEC_DRAFT_K}  prompts {lens}  steps {steps} "
        f"(without speculation {len(base['stats'])})  spec_stats {st}  "
        f"accepted / proposed {rate:.3f}  wall {spec['wall']:.3f}s "
        f"(without {base['wall']:.3f}s)  captures {gs['captures']} "
        f"({gs['capture_s']:.3f}s capturing; without "
        f"{base['eng'].graph_stats['captures']}, "
        f"{base['eng'].graph_stats['capture_s']:.3f}s) replays "
        f"{gs['replays']}")
    log(f"serve spec: keys captured {[k[:3] for k in eng.compile_events]} "
        f"(without {[k[:3] for k in base['eng'].compile_events]})  device "
        f"calls {dict(eng.device_calls)}  launches {launches}  "
        f"launched_token_slots {eng.launched_token_slots} (without "
        f"{base['eng'].launched_token_slots})  bf16 tokens_identical "
        f"{diverged is None}: {agree} of {len(prompts)} requests (first "
        f"divergence (request, position): {diverged}; request 2 "
        f"samples)")
    if not st["proposed"] or not st["accepted"] \
            or st["accepted"] == st["proposed"]:
        raise AssertionError(f"spec: want drafts accepted and rejected: {st}")
    if dict(eng.device_calls) != {"unified": steps}:
        raise AssertionError(f"spec: device calls {eng.device_calls}")
    if eng.alloc.free_pages != eng.num_pages - 1:
        raise AssertionError(f"spec: pages leaked ({eng.alloc.free_pages} "
                             f"free of {eng.num_pages - 1})")
    if not launches["paged_prefill_qblock"] or not launches["paged_decode"]:
        raise AssertionError(f"spec: a paged kernel never ran: {launches}")
    check_paged_routes(K, launches, "spec", cfg.dtype)
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **spec_kw),
                      requests(), "spec eager")
    graphs_vs_eager(torch, "spec", spec, eager, cfg.dtype)
    del base, eager
    cfg32 = cfg.replace(dtype="float32")
    model32 = weights.init_random(cfg32, SEED, device=DEVICE)
    runs = [serve_run(torch, Engine(cfg32, model32, **kw), requests(),
                      f"spec fp32 {tag}")
            for tag, kw in (("base", eng_kw), ("spec", spec_kw))]
    diverged = first_divergence(runs[1]["reqs"], runs[0]["reqs"])
    st32 = runs[1]["eng"].spec_stats
    log(f"serve spec fp32: steps {len(runs[1]['stats'])} (without "
        f"{len(runs[0]['stats'])})  spec_stats {st32}  tokens_identical "
        f"{diverged is None} (first divergence {diverged})")
    if diverged is not None or not st32["accepted"]:
        raise AssertionError(f"spec fp32: tokens differ from the run "
                             f"without speculation at {diverged}, or no "
                             f"draft accepted: {st32}")
    del runs, model32
    s = 2 * eng_kw["max_seqs"] * (SPEC_DRAFT_K + 1)
    sampler = sampler_cost(torch, s, cfg.vocab_size)
    noise = noise_cost(torch, cfg.vocab_size, SPEC_DRAFT_K)
    return dict(spec_wall=spec["wall"], spec_steps=steps,
                spec_sampler_ms=sampler["filter_and_draw"],
                spec_noise_ms=noise[SPEC_DRAFT_K + 1])


def lockstep_diff(torch, tag, cfg, models, prompts, new_tokens, eng_kw):
    """The same greedy requests on the card and on the CPU (`models`:
    {device: model}), stepped in lockstep: the same tokens each step and
    at the end, logits within DIFF_LOGIT_ATOL.  Returns (engines,
    requests, worst logit difference, steps, the CPU's first-step
    logits)."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    engines, reqs = [], []
    for dev in (DEVICE, "cpu"):
        eng = Engine(cfg, models[dev], device=dev, **eng_kw)
        rs = [Request(prompt=list(p), max_new_tokens=new_tokens)
              for p in prompts]
        for r in rs:
            eng.add_request(r)
        engines.append(eng)
        reqs.append(rs)
    worst, steps = 0.0, 0
    while engines[0].sched.has_work:
        stats = [e.step() for e in engines]
        steps += 1
        if stats[0]["sampled_tokens"] != stats[1]["sampled_tokens"]:
            raise AssertionError(f"{tag} step {steps}: engines diverged")
        if steps == 1:
            first = engines[1].last_step_logits
        a = engines[0].last_step_logits.cpu()
        worst = max(worst, float((a - engines[1].last_step_logits).abs()
                                 .max()))
    gpu_out = [r.output for r in reqs[0]]
    cpu_out = [r.output for r in reqs[1]]
    log(f"{tag} {cfg.name} {cfg.num_layers} layers fp32, {len(prompts)} "
        f"requests x {new_tokens} greedy tokens, {steps} steps: "
        f"max_abs_logit_diff {worst:.3e} (bound {DIFF_LOGIT_ATOL:g})  "
        f"tokens_identical {gpu_out == cpu_out}")
    if gpu_out != cpu_out:
        raise AssertionError(f"{tag}: greedy tokens differ:\n cuda "
                             f"{gpu_out}\n cpu  {cpu_out}")
    if engines[1].sched.has_work:
        raise AssertionError(f"{tag}: cpu engine did not finish in lockstep")
    if not worst <= DIFF_LOGIT_ATOL:
        raise AssertionError(f"{tag}: logit difference {worst} > "
                             f"{DIFF_LOGIT_ATOL}")
    return engines, reqs, worst, steps, first


def phase_diff_legs(torch, K):
    """Phase 6's legs for this slice's paths, smollm at full width in
    fp32, card against CPU: the shared-prefix trace with prefix caching
    on (packed); the padded step with chunked prefill at 64, whose resumed
    chunks run `apply_prefill_cached` on the card's fp32 prefill kernel;
    `stream()` on the card against `generate()` on the CPU; and
    speculative decoding (greedy: the same tokens and spec stats)."""
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    cfg = ARCHS[ARCH].replace(dtype="float32")
    models = {dev: weights.init_random(cfg, SEED, device=dev)
              for dev in (DEVICE, "cpu")}
    base = dict(max_seqs=4, num_pages=64, max_model_len=256, seed=SEED,
                debug_logits=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    # 1. the shared-prefix trace, prefix caching on, packed
    shared = shared_prefix_prompts(torch, g, cfg.vocab_size)
    engines, *_ = lockstep_diff(
        torch, "diff prefix-caching", cfg, models, shared, 32,
        base | dict(max_seqs=8, num_pages=1024, max_model_len=2048,
                    enable_chunked_prefill=True, max_prefill_tokens=512,
                    enable_prefix_caching=True))
    cached = [e.cached_prefill_tokens for e in engines]
    log(f"diff prefix-caching: cached_prefill_tokens card / cpu {cached}")
    if not cached[0] or cached[0] != cached[1]:
        raise AssertionError(f"diff prefix-caching: no hit, or the card "
                             f"and the CPU differ: {cached}")
    del engines
    # 2. the padded step, chunked at 64: resumed chunks on the card's
    # prefill kernel (fp32: `prefill_kernel`)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (37, 70, 101)]
    K.reset_launches()
    engines, *_ = lockstep_diff(
        torch, "diff padded-chunked", cfg, models, prompts, 8,
        base | dict(packed_attention=False, enable_chunked_prefill=True,
                    max_prefill_tokens=64))
    resumed = engines[0].device_calls["prefill_cached"]
    log(f"diff padded-chunked: device calls {dict(engines[0].device_calls)}"
        f"  compile_events {[k[:3] for k in engines[0].compile_events]}  "
        f"card prefill_kernel launches "
        f"{K.KERNEL_LAUNCHES['prefill_kernel']}")
    if not resumed or not K.KERNEL_LAUNCHES["prefill_kernel"]:
        raise AssertionError("diff padded-chunked: no resumed chunk ran on "
                             "the card's prefill kernel")
    del engines
    # 3. stream() on the card against generate() on the CPU
    outs, logits = [], []
    for dev in (DEVICE, "cpu"):
        eng = Engine(cfg, models[dev], device=dev, **base)
        seen = []
        finish = eng._finish_step

        def record(flight, finish=finish, seen=seen):
            stats = finish(flight)
            if flight.pack is not None:
                seen.append(flight.logits.cpu())
            return stats

        eng._finish_step = record
        reqs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
        if dev == DEVICE:
            for r in reqs:
                eng.submit(r)
            list(eng.stream())
        else:
            eng.generate(reqs)
        outs.append([r.output for r in reqs])
        logits.append(seen)
    worst = max((float((a - b).abs().max()) for a, b in zip(*logits)),
                default=float("inf"))
    log(f"diff stream-vs-generate: card stream() against cpu generate(), "
        f"{len(logits[0])} / {len(logits[1])} launches  max_abs_logit_diff "
        f"{worst:.3e} (bound {DIFF_LOGIT_ATOL:g})  tokens_identical "
        f"{outs[0] == outs[1]}")
    if outs[0] != outs[1] or len(logits[0]) != len(logits[1]) \
            or not worst <= DIFF_LOGIT_ATOL:
        raise AssertionError("diff stream-vs-generate: the card's stream() "
                             "and the CPU's generate() differ")
    # 4. speculative decoding, greedy, in lockstep: the same accept counts
    # on both sides (lockstep_diff compares each step's emitted tokens)
    prompts = spec_prompts(torch, g, cfg.vocab_size, (90, 70, 101, 37))
    engines, *_ = lockstep_diff(
        torch, "diff spec", cfg, models, prompts, 16,
        base | dict(speculative=True, draft_k=SPEC_DRAFT_K))
    stats = [e.spec_stats for e in engines]
    log(f"diff spec: spec_stats card {stats[0]}  cpu {stats[1]}")
    if stats[0] != stats[1] or not stats[0]["proposed"]:
        raise AssertionError(f"diff spec: no drafts, or the card and the "
                             f"CPU differ: {stats}")


def phase_engine_diff(torch, arch, seed, tag, layers=None, bf16_kernels=None):
    """`arch` at full width (cut to `layers`, else full depth), fp32: 3
    greedy requests of 8 new tokens on the card and on the CPU, stepped in
    lockstep: identical tokens, logits within DIFF_LOGIT_ATOL.  With
    `bf16_kernels` (kernel module, tensor-core kernel name), then the bf16
    leg (`engine_bf16_leg`) on the same prompts."""
    from repro_torch import weights
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch].replace(dtype="float32")
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256, seed=SEED,
                  debug_logits=True)
    g = torch.Generator(device="cpu").manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (37, 70, 101)]
    models = {dev: weights.init_random(cfg, SEED, device=dev)
              for dev in (DEVICE, "cpu")}
    engines, _, worst, _, first = lockstep_diff(torch, tag, cfg, models,
                                                prompts, 8, eng_kw)
    # the prefill of every prompt: the bf16 leg's ruler
    cpu_fp32_prefill = prefill_logits(engines[1], len(prompts), first)
    del engines, models
    if bf16_kernels is not None:
        engine_bf16_leg(torch, cfg, prompts, cpu_fp32_prefill, tag,
                        eng_kw, *bf16_kernels)
    return worst


def prefill_logits(eng, n, logits=None):
    """The last-token logits of a first step that prefilled n prompts
    (`logits`, default the engine's last step's): the packed step's rows
    follow its static decode region of max_seqs rows; the padded step's
    prefill rows come first."""
    logits = eng.last_step_logits if logits is None else logits
    first = eng.max_seqs if eng._packed else 0
    return logits[first:first + n]


def engine_bf16_leg(torch, cfg32, prompts, cpu_fp32, tag, eng_kw, kernels,
                    mma_name):
    """One prefill of `prompts` with the model in bf16 on the card (the
    tensor-core kernels) and on the CPU (plain versions), same seed: the
    max abs gap of the prefill's last-token logits within BF16_GAP_FACTOR
    x the gap between the CPU's own bf16 and fp32 (`cpu_fp32`) logits;
    the argmax agreement is logged.  `kernels.KERNEL_LAUNCHES[mma_name]`
    must count the card's launches.  The packed step (smollm) runs the
    leg through its CUDA graph: the same prompts are served once before
    (one new token each, which captures the key), so the leg's prefill
    replays the graph."""
    from repro_torch import weights
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    cfg = cfg32.replace(dtype="bfloat16")
    n = len(prompts)
    logits = []
    for dev in (DEVICE, "cpu"):
        eng = Engine(cfg, weights.init_random(cfg, SEED, device=dev),
                     device=dev, **eng_kw)
        graphed = eng._packed and eng._graphs
        if graphed:
            eng.generate([Request(prompt=list(p), max_new_tokens=1)
                          for p in prompts])
        replays = eng.graph_stats["replays"]
        for p in prompts:
            eng.add_request(Request(prompt=list(p), max_new_tokens=8))
        kernels.reset_launches()
        stats = eng.step()
        if stats["prefill"] != n or stats["decode"]:
            raise AssertionError(f"{tag} bf16: the first step was not one "
                                 f"prefill of {n} prompts: {stats}")
        if graphed and eng.graph_stats["replays"] != replays + 1:
            raise AssertionError(f"{tag} bf16: the prefill did not replay "
                                 f"a graph: {eng.graph_stats}")
        logits.append(prefill_logits(eng, n).float().cpu())
        if dev == DEVICE:
            torch.cuda.synchronize()
            mma_launches = kernels.KERNEL_LAUNCHES[mma_name]
            via = "graph replay" if graphed else "eager step"
    card, cpu = logits
    gap = float((card - cpu).abs().max())
    own = float((cpu - cpu_fp32.float()).abs().max())
    agree = int((card.argmax(-1) == cpu.argmax(-1)).sum())
    agree32 = int((cpu.argmax(-1) == cpu_fp32.argmax(-1)).sum())
    log(f"{tag} bf16 {cfg.name} {cfg.num_layers} layers, prefill of {n} "
        f"prompts: max_abs_logit_gap card-vs-cpu {gap:.3e}  cpu bf16-vs-fp32 "
        f"{own:.3e}  bound {BF16_GAP_FACTOR:g} x {own:.3e}  argmax agree "
        f"card-vs-cpu {agree}/{n}, cpu bf16-vs-fp32 {agree32}/{n}  "
        f"{mma_name} launches {mma_launches} (card: {via})")
    if not mma_launches:
        raise AssertionError(f"{tag} bf16: {mma_name} never launched")
    if not gap <= BF16_GAP_FACTOR * own:
        raise AssertionError(f"{tag} bf16: logit gap {gap} > "
                             f"{BF16_GAP_FACTOR} x {own}")


# ---------------------------------------------------------------------------
# the training path: flash attention and the trainer
# ---------------------------------------------------------------------------


def flash_inputs(torch, case, seed=3):
    """Packed kernel inputs (q [B*Hkv, nq, block_q*G, D], k / v
    [B*Hkv, Skv, D]) and their keyword arguments, on DEVICE."""
    from repro_torch.kernels.flash_attention import ops as fops

    b, sq, skv, hq, hkv, d, causal, off, dtype_name = case
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, sq, hq, d), generator=g).to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g).to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g).to(dtype)
    group = hq // hkv
    bq = fops.pick_block_q(sq, group)
    qp = fops.pack_q(q, hkv).reshape(b * hkv, sq // bq, bq * group, d)
    kp, vp = (x.permute(0, 2, 1, 3).reshape(b * hkv, skv, d) for x in (k, v))
    args = tuple(x.contiguous().to(DEVICE) for x in (qp, kp, vp))
    kw = dict(block_q=bq, group=group, scale=d ** -0.5, causal=causal,
              q_offset=off)
    return args, kw, (q, k, v)


def phase_flash_check(torch, FK):
    from repro_torch.kernels.flash_attention import ops as fops

    worst = 0.0
    for case in FLASH_CASES:
        dtype_name = case[-1]
        args, kw, _ = flash_inputs(torch, case)
        o, lse = FK.flash_attention_fwd(*args, **kw)
        want_o, want_lse = FK.flash_attention_fwd_plain(*args, **kw)
        torch.cuda.synchronize()
        err_o = float((o.float() - want_o.float()).abs().max())
        err_l = float((lse - want_lse).abs().max())
        err = max(err_o, err_l)
        ok = err <= ATOL[dtype_name]
        log(f"flash check B {case[0]} Sq {case[1]} Skv {case[2]} Hq {case[3]}"
            f" Hkv {case[4]} D {case[5]} causal {case[6]} q_offset {case[7]}"
            f" {dtype_name}: o {err_o:.3e} lse {err_l:.3e} atol "
            f"{ATOL[dtype_name]:g}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version at {case}")
        worst = max(worst, err)
    # gradient: autograd through the kernel on the card vs the plain
    # version on the CPU, same inputs, fp32
    *_, causal, off, _ = FLASH_GRAD_CASE
    _, _, inputs = flash_inputs(torch, FLASH_GRAD_CASE, seed=4)
    w = torch.randn(inputs[0].shape,
                    generator=torch.Generator(device="cpu").manual_seed(5))
    grads = []
    for dev in (DEVICE, "cpu"):
        xs = [x.to(dev).requires_grad_(True) for x in inputs]
        out = fops.flash_attention(*xs, causal=causal, q_offset=off)
        torch.sum(out * w.to(dev)).backward()
        grads.append([x.grad.cpu() for x in xs])
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log(f"flash grad  {FLASH_GRAD_CASE[:8]} fp32 card vs cpu: max_abs_err "
        f"{gerr:.3e} atol 1e-4  {'ok' if gerr <= 1e-4 else 'FAIL'}")
    if not gerr <= 1e-4:
        raise AssertionError("flash attention gradient: card vs CPU differ")
    return worst


def flash_bound(case):
    """(bound_ms, bound_by): causal FLOPs 4*B*Hq*D*S(S+1)/2 at the bf16
    peak vs q, k, v, o and the fp32 lse moved once at the HBM rate."""
    b, sq, skv, hq, hkv, d, causal, _, dtype_name = case
    e = 2 if dtype_name == "bfloat16" else 4
    pairs = sq * (sq + 1) // 2 if causal else sq * skv
    flops = 4 * b * hq * d * pairs
    nbytes = (2 * b * sq * hq * d + 2 * b * skv * hkv * d) * e + 4 * b * sq * hq
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_flash_time(torch, FK, iters=20):
    F = torch.nn.functional
    case = FLASH_TRAIN_CASE
    args, kw, (q, k, v) = flash_inputs(torch, case)
    qt, kt, vt = (x.transpose(1, 2).contiguous().to(DEVICE)
                  for x in (q, k, v))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: FK.flash_attention_fwd(*args, **kw), iters,
                 flush)
    # the same launches with the wrapper's host enqueue hidden behind a
    # ~1 ms spin: the kernel's own time
    ms_hidden = time_ms(torch, lambda: FK.flash_attention_fwd(*args, **kw),
                        iters, flush, lead_cycles=2_000_000)
    enqueue_us = host_us(torch, lambda: FK.flash_attention_fwd(*args, **kw))
    plain_ms = time_ms(torch, lambda: FK.flash_attention_fwd_plain(*args,
                                                                   **kw),
                       3, flush)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters, flush)
    bound_ms, bound_by = flash_bound(case)
    log(f"time  {FLASH:24s} {case[-1]} B {case[0]} S {case[1]} kernel_ms "
        f"{ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {lib_ms:.4f}  "
        f"bound_ms {bound_ms:.5f} ({bound_by})  kernel_ms with the enqueue "
        f"hidden {ms_hidden:.4f}  host_us {enqueue_us:.1f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def markov_batches(torch, cfg, n, batch_size, seq_len, device):
    from repro_torch.training.data import DataState, MarkovDataset

    ds = MarkovDataset(cfg.vocab_size, seed=1)
    dstate, out = DataState(seed=1), []
    for _ in range(n):
        b, dstate = ds.batch(dstate, batch_size=batch_size, seq_len=seq_len)
        out.append({k: torch.from_numpy(v).to(device) for k, v in b.items()})
    return out


def phase_train(torch, K, FK):
    import math

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.training.trainer import make_train_state, train_step

    cfg = ARCHS[ARCH]
    if (cfg.num_q_heads, cfg.num_kv_heads, cfg.resolved_head_dim) \
            != FLASH_TRAIN_CASE[3:6]:
        raise AssertionError("FLASH_TRAIN_CASE is not the train phase's "
                             "attention shape")
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    state = make_train_state(model)
    steps = 1 + TRAIN_STEPS
    batches = markov_batches(torch, cfg, steps, TRAIN_BATCH, TRAIN_SEQ,
                             DEVICE)
    before = [p.detach().clone() for p in model.parameters()]
    log(f"train {ARCH}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"{cfg.dtype}, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; set-up "
        f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    FK.reset_launches()
    losses, gnorms, times = [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = train_step(model, state, batch, **TRAIN_KW)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log(f"train step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{losses[-1]:.4f} grad_norm {gnorms[-1]:.4f} lr "
            f"{float(m['lr']):.2e} {times[-1] * 1e3:.1f} ms")
    launches = FK.LAUNCHES[FLASH]
    paged = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    timed = times[1:]
    tok_s = TRAIN_BATCH * TRAIN_SEQ * len(timed) / sum(timed)
    log(f"train {len(timed)} timed steps: mean_step_ms "
        f"{sum(timed) / len(timed) * 1e3:.1f}  tokens_per_s {tok_s:.1f}  "
        f"max_memory_allocated_gib {peak / 2**30:.2f}  flash launches "
        f"{launches}  paged launches {paged}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"non-finite loss or grad norm: {losses} "
                             f"{gnorms}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"step 0 loss {losses[0]} is not within 1.0 of "
                             f"ln V = {math.log(cfg.vocab_size):.2f}")
    # every matrix changes; bf16 norm scales near 1 may round back (the
    # reference keeps no fp32 master copy either)
    stuck = [n for (n, p), b in zip(model.named_parameters(), before)
             if p.ndim == 2 and torch.equal(p.detach(), b)]
    if stuck:
        raise AssertionError(f"parameters did not change: {stuck[:4]}")
    want = 2 * cfg.num_layers * steps  # each block's forward + its remat
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {want}")
    if any(paged.values()):
        raise AssertionError(f"training launched serving kernels: {paged}")
    return launches


def phase_train_diff(torch):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.training.trainer import make_train_state, train_step

    cfg = ARCHS[ARCH].replace(dtype="float32")
    runs = []
    for dev in (DEVICE, "cpu"):
        model = weights.init_random(cfg, SEED, device=dev)
        state = make_train_state(model)
        out = []
        for batch in markov_batches(torch, cfg, TDIFF_STEPS, TDIFF_BATCH,
                                    TDIFF_SEQ, dev):
            state, m = train_step(model, state, batch, **TRAIN_KW)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(out)
        del model, state
    worst_l = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(*runs))
    worst_g = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(*runs))
    log(f"tdiff fp32 {TDIFF_STEPS} steps batch {TDIFF_BATCH} x seq "
        f"{TDIFF_SEQ}: card {runs[0]} cpu {runs[1]}; loss rel "
        f"{worst_l:.3e} (bound {TDIFF_LOSS_RTOL:g}), grad_norm rel "
        f"{worst_g:.3e} (bound {TDIFF_GNORM_RTOL:g})")
    if not (worst_l <= TDIFF_LOSS_RTOL and worst_g <= TDIFF_GNORM_RTOL):
        raise AssertionError("training on the card and on the CPU differ")


# ---------------------------------------------------------------------------
# the hybrid path: the Mamba2 SSD kernel and zamba2 through the padded step
# ---------------------------------------------------------------------------


def ssd_inputs(torch, case, dtype_name, seed=6, large_state=False):
    """Kernel inputs (x, dt, b, c, a_cum, s0) on DEVICE, drawn like
    tests/test_kernels_mamba2.py's, with a nonzero initial state (~100
    under x of ~0.01 if large_state) and a_cum from the port's own chunk
    cumsum."""
    from repro_torch.kernels.mamba2 import ops as sops

    bsz, l, h, p, n, grp, chunk = case
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x_scale, s_scale = (0.01, 100.0) if large_state else (1.0, 1.0)
    x = (x_scale * torch.randn((bsz, l, h, p), generator=g)).to(dtype)
    dt = torch.randn((bsz, l, h), generator=g).abs() * 0.5 + 0.01
    a = -torch.randn((h,), generator=g).abs() - 0.1
    bm = torch.randn((bsz, l, grp, n), generator=g).to(dtype)
    cm = torch.randn((bsz, l, grp, n), generator=g).to(dtype)
    s0 = s_scale * torch.randn((bsz, h, n, p), generator=g)
    a_cum = sops.chunk_cumsum(
        (dt * a).reshape(bsz, l // chunk, chunk, h)).reshape(bsz, l, h)
    return tuple(t.contiguous().to(DEVICE) for t in (x, dt, bm, cm, a_cum, s0))


def ssd_err(torch, got, want, dtype_name):
    """(error, bound, max abs error) over y and the final state: the error
    is fp32's relative to max |y| (the state's to max |state|), bf16's
    absolute."""
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    if dtype_name == "float32":
        return max(e / max(1.0, float(b.abs().max()))
                   for e, b in zip(errs, want)), SSD_FP32_RTOL, max(errs)
    return max(errs), SSD_BF16_ATOL, max(errs)


def phase_ssd_check(torch, SK):
    worst = 0.0
    cases = [(c, False) for c in SSD_CASES] + [(SSD_LARGE_STATE_CASE, True)]
    for case, large in cases:
        for dtype_name in ("float32", "bfloat16"):
            args = ssd_inputs(torch, case, dtype_name, large_state=large)
            got = SK.ssd_chunked_fwd(*args, chunk=case[-1])
            want = SK.ssd_chunked_fwd_plain(*args, chunk=case[-1])
            torch.cuda.synchronize()
            err, bound, abs_err = ssd_err(torch, got, want, dtype_name)
            ok = err <= bound
            log(f"ssd check B {case[0]} L {case[1]} H {case[2]} P {case[3]} "
                f"N {case[4]} G {case[5]} chunk {case[6]}"
                f"{' large state' if large else ''} {dtype_name}: "
                f"err {err:.3e} bound {bound:g} "
                f"({'x max|y|' if dtype_name == 'float32' else 'abs'})  "
                f"max|y| {float(want[0].abs().max()):.1f}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"SSD kernel disagrees with its plain "
                                     f"version at {case} {dtype_name}")
            worst = max(worst, abs_err)
    return worst


def ssd_bound(case, dtype_name):
    """(bound_ms, bound_by): FLOPs B*H*nc*(2Q^2(N+P) + 4QNP) at the peak
    for the inputs' type vs the bytes of every input read once (x, B, C in
    the inputs' type; dt, a_cum, s0 fp32) and y (fp32) plus the final
    state written once."""
    bsz, l, h, p, n, grp, q = case
    e = 2 if dtype_name == "bfloat16" else 4
    flops = bsz * h * (l // q) * (2 * q * q * (n + p) + 4 * q * n * p)
    nbytes = (bsz * l * h * p * e + 2 * bsz * l * grp * n * e
              + 2 * bsz * l * h * 4 + 2 * bsz * h * n * p * 4
              + bsz * l * h * p * 4)
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_ssd_time(torch, SK, dtype_name="bfloat16", iters=20):
    case = SSD_SERVE_CASE
    args = ssd_inputs(torch, case, dtype_name)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: SK.ssd_chunked_fwd(*args, chunk=case[-1]),
                 iters, flush)
    plain_ms = time_ms(torch, lambda: SK.ssd_chunked_fwd_plain(
        *args, chunk=case[-1]), 3, flush)
    bound_ms, bound_by = ssd_bound(case, dtype_name)
    log(f"time  {SSD:24s} {dtype_name} B {case[0]} L {case[1]} H {case[2]} "
        f"P {case[3]} N {case[4]} chunk {case[6]} kernel_ms {ms:.4f}  "
        f"plain_ms {plain_ms:.4f}  library_ms null (no single PyTorch call "
        f"computes the SSD)  bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_hybrid_serve(torch, K, FK, SK):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import hybrid_layout
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    cfg = ARCHS[HYBRID_ARCH]
    n_mamba, n_attn, _ = hybrid_layout(cfg)
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"hserve {HYBRID_ARCH}: {n_mamba} Mamba2 + {n_attn} shared-attention "
        f"layers, d_model {cfg.d_model}, heads {cfg.num_q_heads}/"
        f"{cfg.num_kv_heads}, ssm H {cfg.ssm.num_heads} P {cfg.ssm.head_dim} "
        f"N {cfg.ssm.state_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters; weights in "
        f"{time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=HYBRID_REQUESTS, num_pages=1024,
                  max_model_len=2048, seed=SEED, debug_logits=True,
                  device=DEVICE)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)

    def prompts(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
        lens[0] = hi  # the longest sets the prefill's padded length
        return [torch.randint(1, cfg.vocab_size, (n_,), generator=g).tolist()
                for n_ in lens]

    warm = Engine(cfg, model, **eng_kw)
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in prompts(2, 40, 200)])
    del warm
    torch.cuda.synchronize()

    served = prompts(HYBRID_REQUESTS, 128, SSD_SERVE_CASE[1])

    def requests():
        return [Request(prompt=list(p), max_new_tokens=HYBRID_NEW_TOKENS)
                for p in served]

    eng = Engine(cfg, model, **eng_kw)
    torch.cuda.reset_peak_memory_stats()
    run = serve_run(torch, eng, requests(), "hserve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    picks = {(phase, d["variant"], d["tile"], d["num_segments"], d["block_q"])
             for st in run["stats"] for phase, d in st["dispatch"].items()}
    launches = dict(K.LAUNCHES) | dict(FK.LAUNCHES) | dict(SK.LAUNCHES)
    calls = dict(eng.device_calls)
    log(f"hserve launches {launches}  device_calls {calls}  dispatch "
        f"{dict(eng.dispatch_counts)}  configs {sorted(picks)}")
    if not all(r.state is State.FINISHED
               and len(r.output) == HYBRID_NEW_TOKENS for r in reqs):
        raise AssertionError("not every request finished")
    if eng._packed or "unified" in calls:
        raise AssertionError("the hybrid did not take the padded step")
    n_pref, n_dec = calls.get("prefill", 0), calls.get("decode", 0)
    prefill_rows = eng.launched_token_slots - HYBRID_REQUESTS * n_dec
    if n_pref != 1 or prefill_rows != HYBRID_REQUESTS * SSD_SERVE_CASE[1]:
        raise AssertionError(f"expected one prefill of {HYBRID_REQUESTS} x "
                             f"{SSD_SERVE_CASE[1]} tokens (SSD_SERVE_CASE), "
                             f"got {n_pref} prefill calls of {prefill_rows} "
                             f"token rows")
    gqa = eng.dispatch_counts[("decode", "gqa")]
    seg = eng.dispatch_counts[("decode", "segmented")]
    want = {SSD: n_mamba * n_pref,
            "paged_prefill_qblock": n_attn * n_pref,
            "paged_decode": n_attn * gqa,
            "paged_decode_segmented": n_attn * seg,
            "segment_reduce": n_attn * seg,
            FLASH: 0}
    if gqa + seg != n_dec or launches != want or not launches[SSD]:
        raise AssertionError(f"launch counts {launches} != {want} "
                             f"({n_pref} prefill, {n_dec} decode calls)")
    check_paged_routes(K, launches, "hserve", cfg.dtype)
    # bf16 serving: every SSD launch was the tensor-core kernel
    routes = {"ssd_mma_kernel": want[SSD], "ssd_fwd_kernel": 0}
    log(f"hserve ssd kernels {SK.KERNEL_LAUNCHES}")
    if SK.KERNEL_LAUNCHES != routes:
        raise AssertionError(f"SSD kernels {SK.KERNEL_LAUNCHES} != {routes}")
    # the engine picked the configs phase 3 checked at these shapes (tile
    # None: the page's default tile)
    shp = PAGED_SHAPES[HYBRID_ARCH]
    checked = {("prefill", "gqa", None, 8, PAGED_BLOCK_Q),
               ("decode", "segmented", None, shp["num_segments"],
                PAGED_BLOCK_Q)}
    if picks != checked or shp["stride"] != SSD_SERVE_CASE[1]:
        raise AssertionError(f"the engine's attention configs {picks} are "
                             f"not those phase 3 checked: {checked}, {shp}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"hserve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  new_tok_per_s {toks / wall:.1f}  "
        f"total_tok_per_s {(toks + prompt_toks) / wall:.1f}  "
        f"max_memory_allocated_gib "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del eng
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **eng_kw),
                      requests(), "hserve eager")
    graphs_vs_eager(torch, "hserve", run, eager, cfg.dtype)
    return launches


# ---------------------------------------------------------------------------
# the ssm path: the mLSTM kernel and xlstm through the padded step
# ---------------------------------------------------------------------------


def mlstm_inputs(torch, case, dtype_name, seed=7):
    """Kernel inputs (q, k, v, ig, bcum, g, c0, n0, m0) on DEVICE: q, k, v
    and the gate preactivations drawn like tests/test_kernels_mlstm.py's,
    bcum and g from the port's own host layer."""
    from repro_torch.kernels._common import chunk_cumsum
    from repro_torch.kernels.mlstm import ops as mops

    bsz, l, h, p, chunk, gates, state = case
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    qkv_scale = 0.01 if state == "large" else 1.0
    q, k, v = ((qkv_scale * torch.randn((bsz, l, h, p), generator=g)).to(dtype)
               for _ in range(3))
    ig = torch.randn((bsz, l, h), generator=g)
    fg = torch.randn((bsz, l, h), generator=g) + 2.0
    if gates == "extreme":  # test_extreme_gates_stable's
        ig, fg = ig * 30.0, fg - 20.0
    elif gates == "padded":  # the mLSTM block's state-neutral padding
        lens = torch.tensor(MLSTM_PAD_LENS)[:, None, None]
        valid = torch.arange(l)[None, :, None] < lens
        ig = torch.where(valid, ig, -30.0)
        fg = torch.where(valid, fg, 30.0)
    nc = l // chunk
    bcum = chunk_cumsum(torch.nn.functional.logsigmoid(fg).reshape(
        bsz, nc, chunk, h))
    gg = torch.cummax(ig.reshape(bsz, nc, chunk, h) - bcum, 2).values
    if state in ("nonzero", "large"):
        # "large": m0 ~30 keeps decay = 1 (m_in above every chunk's gate
        # max), so C and n stay ~100 through the chunks; q and n0 positive,
        # so no denominator q . n_in cancels towards 0
        s_scale, m_shift = (100.0, 30.0) if state == "large" else (0.1, 0.0)
        c0 = s_scale * torch.randn((bsz, h, p, p), generator=g)
        n0 = s_scale * torch.randn((bsz, h, p), generator=g)
        m0 = m_shift + torch.randn((bsz, h), generator=g)
        if state == "large":
            q, n0 = q.abs(), n0.abs()
    else:
        c0, n0, m0 = mops.zero_state(bsz, h, p, "cpu")
    return tuple(t.contiguous().to(DEVICE) for t in (
        q, k, v, ig, bcum.reshape(bsz, l, h), gg.reshape(bsz, l, h), c0, n0,
        m0))


def phase_mlstm_check(torch, MK):
    worst = 0.0
    for case in MLSTM_CASES:
        p, chunk = case[3], case[4]
        for dtype_name in ("float32", "bfloat16"):
            args = mlstm_inputs(torch, case, dtype_name)
            got = MK.mlstm_chunked_fwd(*args, chunk=chunk, scale=p ** -0.5)
            want = MK.mlstm_chunked_fwd_plain(*args, chunk=chunk,
                                              scale=p ** -0.5)
            torch.cuda.synchronize()
            report, ok = [], True
            for name, a, b in zip(("h", "C", "n", "m"), got, want):
                if not bool(torch.isfinite(a.float()).all()):
                    raise AssertionError(f"mLSTM kernel: non-finite {name} "
                                         f"at {case} {dtype_name}")
                err = float((a.float() - b.float()).abs().max())
                scale_ = max(1.0, float(b.float().abs().max()))
                rtol = (MLSTM_BF16_H_RTOL if name == "h"
                        and dtype_name == "bfloat16" else MLSTM_FP32_RTOL)
                ok = ok and err <= rtol * scale_
                report.append(f"{name} {err:.2e} (bound {rtol * scale_:.2e})")
                worst = max(worst, err)
            log(f"mlstm check B {case[0]} L {case[1]} H {case[2]} P {p} "
                f"chunk {chunk} gates {case[5]} state {case[6]} "
                f"{dtype_name}: {'  '.join(report)}  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"mLSTM kernel disagrees with its plain "
                                     f"version at {case} {dtype_name}")
    return worst


def mlstm_bound(case, dtype_name):
    """(bound_ms, bound_by): FLOPs B*H*nc*(6Q^2P + 4QP^2) (q k^T, S v and
    the decayed sum of k within the chunk; q C and the k^T v update) at
    the peak for the inputs' type vs the bytes of q, k, v (the inputs'
    type), the fp32 gates ig, bcum, g and the initial state read once, h
    (the inputs' type) and the final state written once."""
    bsz, l, h, p, q = case[:5]
    e = 2 if dtype_name == "bfloat16" else 4
    flops = bsz * h * (l // q) * (6 * q * q * p + 4 * q * p * p)
    state = bsz * h * (p * p + p + 1) * 4
    nbytes = 4 * bsz * l * h * p * e + 3 * bsz * l * h * 4 + 2 * state
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_mlstm_time(torch, MK, dtype_name="bfloat16", iters=20):
    case = MLSTM_SERVE_CASE
    args = mlstm_inputs(torch, case, dtype_name)
    kw = dict(chunk=case[4], scale=case[3] ** -0.5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = time_ms(torch, lambda: MK.mlstm_chunked_fwd(*args, **kw), iters,
                 flush)
    plain_ms = time_ms(torch, lambda: MK.mlstm_chunked_fwd_plain(*args, **kw),
                       3, flush)
    bound_ms, bound_by = mlstm_bound(case, dtype_name)
    log(f"time  {MLSTM:24s} {dtype_name} B {case[0]} L {case[1]} H {case[2]} "
        f"P {case[3]} chunk {case[4]} kernel_ms {ms:.4f}  plain_ms "
        f"{plain_ms:.4f}  library_ms null (no single PyTorch call computes "
        f"the chunked mLSTM)  bound_ms {bound_ms:.5f} ({bound_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_xlstm_serve(torch, kernel_modules):
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import xlstm_layout
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    cfg = ARCHS[XLSTM_ARCH]
    n_m, n_s, _ = xlstm_layout(cfg)
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"xserve {XLSTM_ARCH}: {n_m} mLSTM + {n_s} sLSTM layers, d_model "
        f"{cfg.d_model}, mLSTM H {cfg.ssm.num_heads} P {cfg.ssm.head_dim} "
        f"chunk {cfg.ssm.chunk}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters; weights in "
        f"{time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=XLSTM_REQUESTS, num_pages=1024,
                  max_model_len=2048, seed=SEED, debug_logits=True,
                  device=DEVICE)
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)

    def prompts(n, lo, hi):
        lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
        lens[0] = hi  # the longest sets the prefill's padded length
        return [torch.randint(1, cfg.vocab_size, (n_,), generator=g).tolist()
                for n_ in lens]

    warm = Engine(cfg, model, **eng_kw)
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in prompts(2, 40, 200)])
    del warm
    torch.cuda.synchronize()

    served = prompts(XLSTM_REQUESTS, 128, MLSTM_SERVE_CASE[1])

    def requests():
        return [Request(prompt=list(p), max_new_tokens=XLSTM_NEW_TOKENS)
                for p in served]

    eng = Engine(cfg, model, **eng_kw)
    torch.cuda.reset_peak_memory_stats()
    run = serve_run(torch, eng, requests(), "xserve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    prefill_s = sum(w for w, st in zip(run["step_walls"], run["stats"])
                    if st["prefill"])
    launches = {}
    for kernels in kernel_modules:
        launches.update(kernels.LAUNCHES)
    calls = dict(eng.device_calls)
    log(f"xserve launches {launches}  device_calls {calls}  dispatch "
        f"{dict(eng.dispatch_counts)}")
    if not all(r.state is State.FINISHED
               and len(r.output) == XLSTM_NEW_TOKENS for r in reqs):
        raise AssertionError("not every request finished")
    if eng._packed or "unified" in calls or "attn" in eng.cache:
        raise AssertionError("xlstm did not take the padded step")
    n_pref, n_dec = calls.get("prefill", 0), calls.get("decode", 0)
    prefill_rows = eng.launched_token_slots - XLSTM_REQUESTS * n_dec
    if n_pref != 1 or prefill_rows != XLSTM_REQUESTS * MLSTM_SERVE_CASE[1]:
        raise AssertionError(f"expected one prefill of {XLSTM_REQUESTS} x "
                             f"{MLSTM_SERVE_CASE[1]} tokens "
                             f"(MLSTM_SERVE_CASE), got {n_pref} prefill calls "
                             f"of {prefill_rows} token rows")
    want = {name: 0 for name in launches}
    want[MLSTM] = n_m * n_pref
    if launches != want or not launches[MLSTM] or eng.dispatch_counts:
        raise AssertionError(f"launch counts {launches} != {want} "
                             f"({n_pref} prefill, {n_dec} decode calls), "
                             f"dispatch {dict(eng.dispatch_counts)}")
    # bf16 serving: every mLSTM launch was the tensor-core kernel
    MK = next(m for m in kernel_modules if MLSTM in m.LAUNCHES)
    routes = {"mlstm_mma_kernel": want[MLSTM], "mlstm_fwd_kernel": 0}
    log(f"xserve mlstm kernels {MK.KERNEL_LAUNCHES}")
    if MK.KERNEL_LAUNCHES != routes:
        raise AssertionError(f"mLSTM kernels {MK.KERNEL_LAUNCHES} != "
                             f"{routes}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"xserve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  prefill_s {prefill_s:.3f}  "
        f"new_tok_per_s {toks / wall:.1f}  total_tok_per_s "
        f"{(toks + prompt_toks) / wall:.1f}  max_memory_allocated_gib "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del eng
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **eng_kw),
                      requests(), "xserve eager")
    graphs_vs_eager(torch, "xserve", run, eager, cfg.dtype)
    return launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 19: the autotune loop on the card
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels(K):
    """The paged wrappers that ops.py calls swapped for their plain
    versions (the same arguments), so an ops-level call runs the plain
    path on the card's tensors."""
    names = ("paged_decode", "paged_decode_segmented_merged",
             "paged_prefill_qblock")
    saved = {n: getattr(K, n) for n in names}
    for n in names:
        setattr(K, n, getattr(K, n + "_plain"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(K, n, f)


def tune_check_inputs(torch, dtype, hkv, group, d, ps, seed=11):
    """TUNE_CHECK's mixed scenario at one model's heads: 8 decode rows at
    TUNE_CHECK_CTX, then the chunks of TUNE_CHECK_CHUNKS (query rows,
    context) packed back to back, as the unified launch takes them; the
    decode and the prefill calls take their own rows of it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ctx = list(TUNE_CHECK_CTX) + [c for _, c in TUNE_CHECK_CHUNKS]
    qlens = [1] * len(TUNE_CHECK_CTX) + [q for q, _ in TUNE_CHECK_CHUNKS]
    s = len(ctx)
    np_ = -(-max(ctx) // ps)
    p = s * np_ + 1
    kp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    vp = torch.randn((hkv, p, ps, d), generator=g).to(dtype)
    pt = (torch.randperm(p - 1, generator=g)[: s * np_].reshape(s, np_)
          + 1).to(torch.int32)
    q = torch.randn((sum(qlens), hkv * group, d), generator=g).to(dtype)
    qsl = torch.tensor([0] + list(itertools.accumulate(qlens)),
                       dtype=torch.int32)
    x = dict(q=q, k=kp, v=vp, pt=pt, ctx=torch.tensor(ctx, dtype=torch.int32),
             qsl=qsl, qlens=torch.tensor(qlens, dtype=torch.int32))
    return {k: t.to(DEVICE) for k, t in x.items()}


def tune_check_call(tops, x, space, cfg):
    """One ops-level call of `space`'s launch at `cfg` on the inputs."""
    nd = len(TUNE_CHECK_CTX)
    kv = dict(tile=cfg.tile)
    if space == "decode":
        return tops.paged_attention_decode(
            x["q"][:nd], x["k"], x["v"], x["pt"][:nd], x["ctx"][:nd],
            variant=cfg.variant, num_segments=cfg.num_segments, **kv)
    if space == "prefill":
        return tops.paged_attention_prefill(
            x["q"][nd:], x["k"], x["v"], x["pt"][nd:], x["ctx"][nd:],
            x["qsl"][nd:] - nd, x["qlens"][nd:], block_q=cfg.block_q, **kv)
    return tops.paged_attention_unified(
        x["q"], x["k"], x["v"], x["pt"], x["ctx"], x["qsl"], x["qlens"],
        num_decode_seqs=nd, variant=cfg.variant,
        num_segments=cfg.num_segments, block_q=cfg.block_q, **kv)


def phase_tune_check(torch, K, tops):
    """Every configuration of the three spaces the sweep times, at the
    served models' heads (TUNE_GEOMETRIES), against the plain version on
    the card, before anything is timed: one mixed scenario each, fp32
    with TF32 off at 1e-4 and bf16 at 2e-2; the context-0 decode row
    exactly zero.  A configuration the wrapper refuses before launch
    (`LaunchLimitError`: the fp32 prefill's shared memory) is logged by
    name and returned; any other error fails the phase."""
    from repro_torch.autotune import microbench as MB
    from repro_torch.kernels._common import LaunchLimitError

    spaces = {"decode": MB.DECODE_SPACE, "prefill": MB.PREFILL_SPACE,
              "unified": MB.UNIFIED_SPACE}
    refused, worst, checked = [], {}, 0
    for arch, names in TUNE_GEOMETRIES.items():
        hkv, group, d, ps = paged_heads(arch)
        for dtype_name in ("float32", "bfloat16"):
            x = tune_check_inputs(torch, getattr(torch, dtype_name), hkv,
                                  group, d, ps)
            for space in names:
                for cfg in spaces[space]:
                    tag = (f"{arch} {dtype_name} {space} {cfg.variant} tile "
                           f"{cfg.tile} segments {cfg.num_segments} block_q "
                           f"{cfg.block_q}")
                    try:
                        got = tune_check_call(tops, x, space, cfg)
                    except LaunchLimitError as e:
                        refused.append(tag)
                        log(f"tune check {tag}: refused before launch ({e})")
                        continue
                    with plain_kernels(K):
                        want = tune_check_call(tops, x, space, cfg)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    zero = space == "prefill" or bool((got[0] == 0).all())
                    ok = err <= ATOL[dtype_name] and zero
                    log(f"tune check {tag}: max_abs_err {err:.3e} atol "
                        f"{ATOL[dtype_name]:g} context-0 row zero {zero}  "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"tune check {tag}: err {err}, "
                                             f"context-0 row zero {zero}")
                    key = (space, dtype_name)
                    worst[key] = max(worst.get(key, 0.0), err)
                    checked += 1
    log(f"tune check: {checked} configurations checked, worst "
        + ", ".join(f"{sp} {dt} {e:.3e}" for (sp, dt), e in worst.items())
        + f"; {len(refused)} refused before launch: {refused}")
    return refused


def tune_calibrate(torch):
    """The cost model's card constants, read at smollm's heads (bf16, each
    the mean of ITERS launches replayed in a CUDA graph): a decode launch
    of 1 sequence of 16 keys (LAUNCH_OVERHEAD_S), the prefill of 1
    sequence of 16 rows (PREFILL_OVERHEAD_S), a decode of 1 sequence of
    4096 keys (one streaming block a KV head: BLOCK_STREAM_BW, its K and V
    bytes over its time less the first), and the prefill of 8 x 1024
    fresh rows (MMA_EFFICIENCY: the FLOPs `prefill_time` counts for it
    over its time less the second, over the bf16 peak)."""
    from repro_torch.autotune import costmodel as C
    from repro_torch.autotune import microbench as MB
    from repro_torch.core.attention.heuristics import KernelConfig
    from repro_torch.roofline import hw

    hkv, group, d, ps = paged_heads(ARCH)

    def sc(ctx, q):
        return C.Scenario(num_seqs=len(ctx), context_lens=ctx, query_lens=q,
                          num_q_heads=hkv * group, num_kv_heads=hkv,
                          head_dim=d, page_size=ps)

    gqa = KernelConfig("gqa")
    t_dec = MB._measure_on_device(sc((16,), (1,)), gqa)
    t_pre = MB._measure_on_device(sc((16,), (16,)), gqa)
    t_long = MB._measure_on_device(sc((4096,), (1,)), gqa)
    pf = sc((1024,) * 8, (1024,) * 8)
    t_pf = MB._measure_on_device(pf, gqa)
    # prefill_time's FLOPs: its time at efficiency 1 and no fixed cost
    model = (C.prefill_time(pf, block_q=16, tile=ps) - C.PREFILL_OVERHEAD_S) \
        * C.MMA_EFFICIENCY
    flops = model * hw.PEAK_FLOPS_BF16
    bw = 4096 * 2 * d * 2 / max(t_long - t_dec, 1e-9)
    eff = flops / max(t_pf - t_pre, 1e-9) / hw.PEAK_FLOPS_BF16
    log(f"tune calibrate (bf16, {ARCH} heads): decode 1 x 16 keys "
        f"{t_dec * 1e6:.2f} us, prefill 1 x 16 rows {t_pre * 1e6:.2f} us, "
        f"decode 1 x 4096 keys {t_long * 1e6:.2f} us -> one block "
        f"{bw / 1e9:.1f} GB/s, prefill 8 x 1024 rows {t_pf * 1e6:.2f} us "
        f"-> {flops:.4g} FLOPs at {eff:.4f} of the bf16 peak (model "
        f"constants now {C.LAUNCH_OVERHEAD_S * 1e6:g} us, "
        f"{C.PREFILL_OVERHEAD_S * 1e6:g} us, {C.BLOCK_STREAM_BW / 1e9:g} "
        f"GB/s, {C.MMA_EFFICIENCY:g})")
    return dict(launch_us=t_dec * 1e6, prefill_us=t_pre * 1e6,
                block_gbps=bw / 1e9, mma_efficiency=eff)


def rank_corr(a, b):
    """Spearman's rank correlation of two equal-length sequences (ties
    take their mean rank)."""
    def ranks(v):
        order = sorted(range(len(v)), key=v.__getitem__)
        r = [0.0] * len(v)
        i = 0
        while i < len(order):
            j = i
            while j + 1 < len(order) and v[order[j + 1]] == v[order[i]]:
                j += 1
            for k in range(i, j + 1):
                r[order[k]] = (i + j) / 2
            i = j + 1
        return r
    ra, rb = ranks(a), ranks(b)
    ma, mb = statistics.fmean(ra), statistics.fmean(rb)
    cov = sum((x - ma) * (y - mb) for x, y in zip(ra, rb))
    var = math.sqrt(sum((x - ma) ** 2 for x in ra)
                    * sum((y - mb) ** 2 for y in rb))
    return cov / var if var else float("nan")


def phase_tune_sweep(torch, K, out_dir):
    """The sweep of TUNE_GRID (the reference's jitter recipe, a cut grid)
    at smollm's heads on the card, TUNE_WARMUP + TUNE_ITERS launches a
    configuration, the three trees fit and exported in `tune_and_export`'s
    format into out_dir/tuned.json.  Logs each phase's tuned-vs-best-fixed
    speedup and listing, the sweep's seconds and launches, the `inf`
    configurations, and the rank correlation of the Hopper cost model's
    predictions against the measurement per phase (a finding, not a
    gate).  Returns the exported tree's path."""
    from repro_torch.autotune import microbench as MB
    from repro_torch.autotune.tune import tune_and_export

    hkv, group, d, ps = paged_heads(ARCH)
    arch = dict(num_q_heads=hkv * group, num_kv_heads=hkv, head_dim=d,
                page_size=ps)
    grid = MB.scenario_grid(seed=SEED, **arch, **TUNE_GRID)
    path = str(Path(out_dir) / "tuned.json")
    before = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    rep = tune_and_export(path, str(Path(out_dir) / "tuned.py"),
                          use_hardware=True, grid=grid, warmup=TUNE_WARMUP,
                          iters=TUNE_ITERS, **arch)
    sweep_s = time.perf_counter() - t0
    # the counters see the eager warm-up launches only; each measurement
    # then replays its graph of TUNE_ITERS launches twice
    eager = sum(K.LAUNCHES[k] - before[k] for k in before)
    graphed = eager * 2 * TUNE_ITERS // TUNE_WARMUP
    spaces = {"decode": MB.DECODE_SPACE, "prefill": MB.PREFILL_SPACE,
              "unified": MB.UNIFIED_SPACE}
    n_meas = sum(len(r.timings) for res in rep["results"].values()
                 for r in res)
    n_inf = sum(1 for res in rep["results"].values() for r in res
                for t in r.timings.values() if math.isinf(t))
    log(f"tune sweep {ARCH} heads: {len(grid)} scenarios, {n_meas} "
        f"(scenario, config) timings in {sweep_s:.1f}s, each "
        f"{TUNE_WARMUP} eager + {TUNE_ITERS} graphed launches, replayed "
        f"twice: {eager} eager and {graphed} replayed Pallas-function "
        f"launches; {n_inf} inf")
    for phase, res in rep["results"].items():
        st = rep if phase == "decode" else rep[phase]
        meas, pred = [], []
        for r in res:
            for i, t in r.timings.items():
                if math.isfinite(t):
                    meas.append(t)
                    pred.append(MB.measure(r.scenario, spaces[phase][i],
                                           unified=phase == "unified"))
        log(f"tune {phase}: {len(res)} scenarios, tuned-vs-best-fixed "
            f"{st['tuned_vs_untuned_speedup']:.4f}x, max pointwise "
            f"{st['max_pointwise_speedup']:.3f}x, oracle overhead "
            f"{st['tuned_vs_oracle_overhead']:.2%}, cost-model rank "
            f"correlation {rank_corr(meas, pred):.3f} over {len(meas)} "
            f"timings; measured {min(meas) * 1e6:.2f}-"
            f"{max(meas) * 1e6:.2f} us")
        for line in st["listing"].rstrip().splitlines():
            log(f"tune {phase} tree | {line}")
    log(f"tune suggested_max_prefill_tokens "
        f"{rep['suggested_max_prefill_tokens']}")
    log(f"tune payload {json.dumps(json.load(open(path)))}")
    return path, dict(sweep_s=sweep_s, timings=n_meas, inf=n_inf,
                      launches=eager + graphed)


def tuned_vs_default(torch, cfg, model, eng_kw, requests, path, tag):
    """Phase 5's requests served with the default trees, then with the
    tree at `path` (`heuristics.load`; reset after): both runs' tokens,
    walls, keys captured and capture seconds, and dispatch by (phase,
    variant).  Returns both `serve_run`s."""
    from repro_torch.core.attention import heuristics
    from repro_torch.serving.engine import Engine

    runs = {}
    try:
        for name in ("default", "tuned"):
            if name == "tuned":
                heuristics.load(path)
            eng = Engine(cfg, model, debug_logits=True, **eng_kw)
            runs[name] = serve_run(torch, eng, requests(), f"{tag} {name}")
    finally:
        heuristics.reset()
    for name, run in runs.items():
        eng = run["eng"]
        leaked = eng.alloc.free_pages != eng.num_pages - 1
        gs = eng.graph_stats
        log(f"{tag} {name} tree: wall {run['wall']:.3f}s  steps "
            f"{len(run['stats'])}  keys captured {gs['captures']} "
            f"({gs['capture_s']:.3f}s capturing)  compile_events "
            f"{len(eng.compile_events)}  "
            f"dispatch {dict(eng.dispatch_counts)}  pages leaked {leaked}")
        if leaked:
            raise AssertionError(f"{tag} {name}: pages leaked")
    return runs


def phase_tune(torch, K, tops):
    """Phase 19: (a) every configuration checked, (b) the sweep, fit and
    export, (c) the tuned tree served against the default trees."""
    import tempfile

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.request import Request

    refused = phase_tune_check(torch, K, tops)
    calib = tune_calibrate(torch)
    with tempfile.TemporaryDirectory() as out_dir:
        path, sweep = phase_tune_sweep(torch, K, out_dir)
        cfg = ARCHS[ARCH]
        g, _, served = serve_prompts(torch, cfg.vocab_size)
        del g
        eng_kw = dict(max_seqs=8, num_pages=2048, max_model_len=2048,
                      enable_chunked_prefill=True, max_prefill_tokens=512,
                      seed=SEED, device=DEVICE)
        cfg32 = cfg.replace(dtype="float32")
        model32 = weights.init_random(cfg32, SEED, device=DEVICE)

        def greedy():
            return [Request(prompt=list(p), max_new_tokens=32)
                    for p in served]

        runs = tuned_vs_default(torch, cfg32, model32, eng_kw, greedy, path,
                                "tune serve fp32")
        same = [r.output for r in runs["default"]["reqs"]] \
            == [r.output for r in runs["tuned"]["reqs"]]
        log(f"tune serve fp32: tuned tokens identical to default {same}")
        if not same:
            raise AssertionError("the tuned tree changed fp32 tokens")
        del runs
        model16 = weights.init_random(cfg, SEED, device=DEVICE)

        def phase5():
            return [Request(prompt=list(p), max_new_tokens=32,
                            **(SERVE_SAMPLED if i == 3 else {}))
                    for i, p in enumerate(served)]

        runs16 = tuned_vs_default(torch, cfg, model16, eng_kw, phase5, path,
                                  "tune serve bf16")
        same16 = sum(a.output == b.output for a, b in
                     zip(runs16["default"]["reqs"], runs16["tuned"]["reqs"]))
        log(f"tune serve bf16: {same16} of {len(served)} requests' tokens "
            f"identical to the default trees' (logged only)")
        walls = {f"{k}_wall_s": v["wall"] for k, v in runs16.items()}
        del runs16
    return dict(refused=refused, **calib, **sweep, **walls), \
        (cfg32, model32, cfg, model16, served, eng_kw)


# ---------------------------------------------------------------------------
# phase 20: telemetry and the online refit on the card
# ---------------------------------------------------------------------------


def observed_run(torch, cfg, model, eng_kw, requests, tel=None,
                 daemon=None):
    """`requests()` through `submit()` + `run()` on a fresh engine, with
    `tel` / `daemon` on it; (engine, requests, wall)."""
    from repro_torch.serving.engine import Engine

    eng = Engine(cfg, model, telemetry=tel, refit=daemon, **eng_kw)
    reqs = requests()
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if out["unfinished"]:
        raise AssertionError("run() left requests unfinished")
    return eng, reqs, wall


def check_telemetry(torch, eng, reqs, tel):
    """The telemetry's counts against the engine's ground truth, the
    grid's costs, the Prometheus round trip, the trace."""
    from repro_torch.obs import parse_prometheus

    m = tel.metrics
    checks = {
        "steps": (m.value("repro_steps_total"), eng.step_idx),
        "sampled": (m.value("repro_tokens_total", kind="sampled"),
                    sum(len(r.output) for r in reqs)),
        "prefill": (m.value("repro_tokens_total", kind="prefill"),
                    eng.prefilled_tokens),
        "compiled launches": (
            sum(s["value"] for s in
                m.snapshot()["repro_compile_events_total"]["series"]),
            len(eng.compile_events)),
        "graph captures": (m.value("repro_compile_events_total",
                                   kind="unified"),
                           eng.graph_stats["captures"]),
    }
    for (phase, variant), n in eng.dispatch_counts.items():
        checks[f"dispatch {phase}/{variant}"] = (
            m.value("repro_dispatch_total", phase=phase, variant=variant), n)
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    grid = tel.latency_grid()
    costless = [e for e in grid["entries"]
                if not (e["flops"] and e["flops"] > 0
                        and e["bytes_accessed"] and e["bytes_accessed"] > 0)]
    parsed = parse_prometheus(tel.prometheus_text())
    snap = m.snapshot()
    lost = [n for n in snap if n not in parsed]
    steps = [v for name, _, v in parsed["repro_steps_total"]["samples"]]
    doc = json.loads(json.dumps(tel.tracer.to_json()))
    swaps = [e for e in doc["traceEvents"]
             if e["name"] == "heuristics_hot_swap"]
    log(f"observe telemetry vs engine: "
        + ", ".join(f"{k} {a:g}/{b:g}" for k, (a, b) in checks.items())
        + f"; grid entries {len(grid['entries'])} ({len(costless)} without"
        f" cost); prometheus families {len(parsed)} (lost {lost}); trace "
        f"events {len(doc['traceEvents'])}, hot-swap instants {len(swaps)}")
    if bad or costless or lost or steps != [eng.step_idx] or not swaps:
        raise AssertionError(f"telemetry disagrees: {bad}, costless "
                             f"{len(costless)}, lost {lost}, steps {steps}, "
                             f"swaps {len(swaps)}")


def phase_observe(torch, models):
    """Phase 20: phase 5's 8 requests (greedy, fp32, TF32 off) through
    `run()`, unobserved and then with `Telemetry(launch_timing_interval=1)`
    and a `RefitDaemon(min_new=OBSERVE_MIN_NEW)` on the engine hook:
    identical tokens, >= 1 refit and hot-swap at step boundaries, the
    telemetry's counts equal to the engine's, every grid entry with a
    cost, the Prometheus text round-tripping, a hot-swap instant in the
    trace, and `GET /metrics` answered on 127.0.0.1.  Then telemetry's
    cost: bf16 with graphs, no telemetry against `Telemetry()` (interval
    8, no refit), in turns."""
    import tempfile
    import urllib.request

    from repro_torch.core.attention import heuristics
    from repro_torch.obs import MetricsServer, RefitDaemon, Telemetry
    from repro_torch.serving.request import Request

    cfg32, model32, cfg16, model16, served, eng_kw = models

    def greedy():
        return [Request(prompt=list(p), max_new_tokens=32) for p in served]

    _, plain, _ = observed_run(torch, cfg32, model32, eng_kw, greedy)
    tel = Telemetry(launch_timing_interval=1)
    with tempfile.TemporaryDirectory() as out_dir:
        daemon = RefitDaemon(tel, out_dir=out_dir, min_new=OBSERVE_MIN_NEW)
        server = MetricsServer(tel, port=0).start()
        try:
            eng, reqs, wall = observed_run(torch, cfg32, model32, eng_kw,
                                           greedy, tel, daemon)
            with urllib.request.urlopen(server.url("/metrics"),
                                        timeout=10) as resp:
                scraped = resp.read().decode()
        finally:
            server.stop()
            heuristics.reset()
        rep = daemon.report()
        same = [r.output for r in plain] == [r.output for r in reqs]
        keys = [(k[2], k[3].variant, k[3].tile, k[3].num_segments,
                 k[3].block_q) for k in eng.compile_events]
        log(f"observe fp32: tokens identical to the unobserved run {same}; "
            f"refits {rep['refits']} swaps {rep['swaps']} at steps "
            f"{rep['swap_steps']} of {eng.step_idx}; wall {wall:.3f}s; "
            f"keys captured {eng.graph_stats['captures']} "
            f"({eng.graph_stats['capture_s']:.3f}s capturing; (tokens, "
            f"variant, tile, segments, block_q) {keys}); dispatch "
            f"{dict(eng.dispatch_counts)}; GET /metrics {len(scraped)} "
            f"bytes")
        if not (same and rep["refits"] >= 1 and rep["swaps"] >= 1
                and all(s is not None and s <= eng.step_idx
                        for s in rep["swap_steps"])
                and "repro_steps_total" in scraped):
            raise AssertionError(f"observe: tokens {same}, refit {rep}, "
                                 f"scrape {len(scraped)} bytes")
        check_telemetry(torch, eng, reqs, tel)
        last = daemon.last_report or {"phases": {}}
        for phase, st in last["phases"].items():
            log(f"observe refit {phase}: calibration "
                f"{st['calibration_ratio']:.4g}, host overhead "
                f"{(st['host_overhead_s_est'] or 0) * 1e3:.4f} ms, device "
                f"fraction {st['device_time_fraction']}, profiles "
                f"{st['profiles']}, observed points {st['observed_points']}")
    s = tel.summary()
    log(f"observe fp32 telemetry: ttft p50 {s['ttft_p50'] * 1e3:.3f} ms p95 "
        f"{s['ttft_p95'] * 1e3:.3f} ms, itl p50 {s['itl_p50'] * 1e3:.3f} ms "
        f"p95 {s['itl_p95'] * 1e3:.3f} ms, step p50 "
        f"{s['step_p50'] * 1e3:.3f} ms, padding waste "
        f"{s['padding_waste']:.4f} (every launch timed: the loop is "
        f"synchronous)")
    walls = telemetry_cost(torch, cfg16, model16, eng_kw, greedy)
    return dict(refits=rep["refits"], swaps=rep["swaps"],
                tel_walls=walls["telemetry"], none_walls=walls["none"])


def telemetry_cost(torch, cfg, model, eng_kw, requests):
    """Telemetry's cost on the serving path: bf16, graphs, `run()`, no
    telemetry against `Telemetry()` (interval 8, no refit), in turns
    (none, on, on, none).  Each engine serves the requests once to
    capture its graphs, then again, timed: replays only, so the captures
    (0.2-0.3 s a key) do not hide the hooks' cost.  Returns the timed
    walls by name."""
    from repro_torch.obs import Telemetry
    from repro_torch.serving.engine import Engine

    walls = {"none": [], "telemetry": []}
    summaries = []
    for name in ("none", "telemetry", "telemetry", "none"):
        tel = Telemetry() if name == "telemetry" else None
        eng = Engine(cfg, model, telemetry=tel, **eng_kw)
        for timed in (False, True):
            captures = eng.graph_stats["captures"]
            for r in requests():
                eng.submit(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if out["unfinished"]:
                raise AssertionError("run() left requests unfinished")
        if eng.graph_stats["captures"] != captures:
            raise AssertionError("the timed run captured a graph")
        walls[name].append(wall)
        if tel is not None:
            summaries.append(tel.summary())
    log(f"observe bf16 telemetry cost (graphs, run(), interval 8, replays "
        f"only, {eng.step_idx // 2} steps): walls none {walls['none']} "
        f"telemetry {walls['telemetry']}; with telemetry: step p50 "
        + ", ".join(f"{x['step_p50'] * 1e3:.3f}" for x in summaries)
        + " ms, itl p50 " + ", ".join(f"{x['itl_p50'] * 1e3:.3f}"
                                      for x in summaries) + " ms")
    return walls


# ---------------------------------------------------------------------------
# phase 21: the MoE family (llama4-maverick) on the packed serving step
# ---------------------------------------------------------------------------


def moe_routing(torch, case, rows, e, g):
    """Sorted expert ids [rows] of a routing case, drawn from `g`."""
    dev = DEVICE
    if case == "uniform":
        ids = torch.randint(0, e, (rows,), generator=g)
    elif case == "one_expert":
        ids = torch.full((rows,), 3 % e, dtype=torch.long)
    elif case == "empty":  # only the first and the last expert get rows
        ids = torch.randint(0, 2, (rows,), generator=g) * (e - 1)
    else:  # "long": one group of MOE_LONG_GROUP rows among uniform ones
        ids = torch.cat([torch.full((MOE_LONG_GROUP,), 1, dtype=torch.long),
                         torch.randint(0, e, (rows - MOE_LONG_GROUP,),
                                       generator=g)])
    return torch.sort(ids).values.to(dev)


def moe_offsets(torch, ids, e):
    """offsets [E + 1] int32 of sorted expert ids (host-side: the checks'
    inputs, not the serving path's)."""
    counts = torch.bincount(ids, minlength=e)
    return torch.cat([torch.zeros(1, dtype=torch.long, device=ids.device),
                      counts.cumsum(0)]).to(torch.int32)


def moe_weights(torch, e, d, ff, dtype, g):
    """w_gate, w_up [E, d, ff] and w_down [E, ff, d], drawn on the card at
    the reference's init scale (std d ** -0.5, ff ** -0.5)."""
    return [(torch.randn(shape, generator=g, device=DEVICE) * fan ** -0.5
             ).to(dtype) for shape, fan in (((e, d, ff), d), ((e, d, ff), d),
                                            ((e, ff, d), ff))]


def bf16_ulp(x):
    """One bf16 ulp at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def bf16_ulps(torch, x):
    """One bf16 ulp at each element's own magnitude (fp32)."""
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def moe_pair_tolerances(torch, GK, ws, xs, off, h_plain, ys_plain, tail):
    """Per-element tolerances of the pair check where cuBLAS's plain
    products sum in another order than the kernel (E 40 at ff 1536): each
    output is held to two bf16 ulps of its own magnitude (the kernel's one
    rounding and the plain's last), h also to one flip of the gate or up
    product's rounding to bf16 (|b| |silu'(a)| ulp(a) + |silu(a)| ulp(b):
    both round a and b before silu and the product, as the reference does;
    an h near 0 moves by many of its own ulps), and both to a floor of
    2^-16 of the largest |output| for sums that cancel towards 0."""
    wg, wu, _ = ws
    a = GK.grouped_gemm_plain(xs, wg, off, tail=tail).float()
    b = GK.grouped_gemm_plain(xs, wu, off, tail=tail).float()
    sig = torch.sigmoid(a)
    dsilu = (sig * (1 + a * (1 - sig))).abs()
    flip = (b.abs() * dsilu * bf16_ulps(torch, a)
            + (a * sig).abs() * bf16_ulps(torch, b))
    tols = []
    for want, extra in ((h_plain, flip), (ys_plain, 0.0)):
        floor = 2.0 ** -16 * float(want.float().abs().max())
        tols.append(2 * bf16_ulps(torch, want) + extra + floor)
    return tols


def moe_pair_check(torch, GK, ws, xs, off, atol, tag, tail=False,
                   wrong=False):
    """Both grouped GEMM launches (gate / up fused, then down) against
    their plain versions on the same inputs: h and ys each within `atol`
    (None: each element within `moe_pair_tolerances`; the log gives the margin, the largest
    error over its tolerance, and with `wrong` what a kernel that gives
    one row per group to the next expert reads: the plain pair over
    offsets moved one row on).  Returns (the worst error, (h, ys))."""
    wg, wu, wd = ws
    h = GK.grouped_gemm(xs, wg, off, wu, tail=tail)
    ys = GK.grouped_gemm(h, wd, off, tail=tail)
    h_plain = GK.grouped_gemm_plain(xs, wg, off, wu, tail=tail)
    ys_plain = GK.grouped_gemm_plain(h, wd, off, tail=tail)
    torch.cuda.synchronize()
    pairs = ((h, h_plain), (ys, ys_plain))
    errs = [max_err(torch, MOE, got, want) for got, want in pairs]
    if atol is not None:
        log(f"check {MOE:18s} {tag}: max_abs_err h {errs[0]:.3e} ys "
            f"{errs[1]:.3e} (tolerance {atol:g}, max |ys| "
            f"{float(ys_plain.float().abs().max()):.3f})")
        if not all(e <= atol for e in errs):
            raise AssertionError(f"{MOE} {tag}: error {errs} > {atol}")
        return max(errs), (h, ys)
    tols = moe_pair_tolerances(torch, GK, ws, xs, off, h_plain, ys_plain,
                               tail)
    ratios = [float(((got.float() - want.float()).abs() / tol).max())
              for (got, want), tol in zip(pairs, tols)]
    ulps = [float(((got.float() - want.float()).abs()
                   / bf16_ulps(torch, want)).max()) for got, want in pairs]
    msg = ""
    if wrong:
        moved = torch.minimum(off + 1, off[-1:]).to(off.dtype)
        moved[0] = off[0]
        h_bad = GK.grouped_gemm_plain(xs, wg, moved, wu, tail=tail)
        ys_bad = GK.grouped_gemm_plain(h, wd, moved, tail=tail)
        bad = [float(((got.float() - want.float()).abs() / tol).max())
               for got, want, tol in ((h_bad, h_plain, tols[0]),
                                      (ys_bad, ys_plain, tols[1]))]
        msg = (f"; a kernel one row off per group reads "
               f"{bad[0]:.3g} / {bad[1]:.3g} of it")
    log(f"check {MOE:18s} {tag}: max_abs_err h {errs[0]:.3e} ys "
        f"{errs[1]:.3e}, in own-magnitude bf16 ulps {ulps[0]:.3f} / "
        f"{ulps[1]:.3f}, margin (error over tolerance) {ratios[0]:.3f} / "
        f"{ratios[1]:.3f}{msg}")
    if not all(r <= 1 for r in ratios):
        raise AssertionError(f"{MOE} {tag}: error over tolerance {ratios}")
    return max(errs), (h, ys)


def phase_moe_check(torch, GK):
    """21 (a): the grouped GEMM (both launches: gate / up fused, then
    down) against its plain version on the same inputs, at every case of
    MOE_CHECK_CASES x MOE_ROWS x MOE_ROUTINGS; h and ys each within the
    case's atol.  Returns (the worst error, the bf16 case's weights for
    the timing)."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    gh = torch.Generator(device="cpu").manual_seed(SEED + 21)
    worst, kept = 0.0, None
    for e, d, ff, dtype_name, atol in MOE_CHECK_CASES:
        dtype = getattr(torch, dtype_name)
        wg, wu, wd = moe_weights(torch, e, d, ff, dtype, g)
        for rows in MOE_ROWS:
            for case in MOE_ROUTINGS:
                if case == "long" and rows <= MOE_LONG_GROUP:
                    continue
                off = moe_offsets(torch, moe_routing(torch, case, rows, e,
                                                     gh), e)
                xs = torch.randn((rows, d), generator=g,
                                 device=DEVICE).to(dtype)
                err, _ = moe_pair_check(
                    torch, GK, (wg, wu, wd), xs, off, atol,
                    f"E {e} d {d} ff {ff} {dtype_name} rows {rows} "
                    f"{case:10s}")
                worst = max(worst, err)
        if dtype_name == "bfloat16":
            kept = (wg, wu, wd)
        del wg, wu, wd
    return worst, kept


def moe_bound(rows, touched, d, ff, dtype_name):
    """(bound_ms, bound_by) of the grouped GEMM pair: the touched experts'
    three weight matrices, xs read and ys written once, against 2 x rows x
    3 x d x ff operations."""
    e = 2 if dtype_name == "bfloat16" else 4
    nbytes = touched * 3 * d * ff * e + 2 * rows * d * e
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * 3 * d * ff / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_moe_time(torch, GK, GO, kept, iters=20):
    """21 (a): the grouped GEMM pair at maverick's widths in bf16, at 8
    decode rows (the JSON row) and at 520 rows of a chunk step, routing
    drawn uniformly: the kernel (`expert_ffn`, two launches), its plain
    version, the bound, and a library yardstick the port never calls: one
    torch.matmul per product over each expert's rows, the group sizes
    known on the host beforehand."""
    F = torch.nn.functional
    wg, wu, wd = kept
    e, d, ff = wg.shape
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    g = torch.Generator(device="cpu").manual_seed(SEED + 22)
    rows_out = {}
    for rows in MOE_ROWS:
        ids = moe_routing(torch, "uniform", rows, e, g)
        off = moe_offsets(torch, ids, e)
        bounds_h = [int(v) for v in off.tolist()]
        groups = [(x, lo, hi) for x, (lo, hi) in
                  enumerate(zip(bounds_h, bounds_h[1:])) if hi > lo]
        xs = torch.randn((rows, d), generator=g).to(DEVICE, torch.bfloat16)

        def kernel():
            return GO.expert_ffn(xs, off, wg, wu, wd)

        def plain():
            return GK.grouped_gemm_plain(GK.grouped_gemm_plain(
                xs, wg, off, wu), wd, off)

        def library():
            outs = []
            for x, lo, hi in groups:
                a = xs[lo:hi]
                h = F.silu(torch.matmul(a, wg[x])) * torch.matmul(a, wu[x])
                outs.append(torch.matmul(h, wd[x]))
            return torch.cat(outs)

        ms = time_ms(torch, kernel, iters, flush)
        plain_ms = time_ms(torch, plain, 3, flush)
        lib_ms = time_ms(torch, library, iters, flush)
        bound_ms, bound_by = moe_bound(rows, len(groups), d, ff, "bfloat16")
        log(f"time  {MOE:37s} {MOE_ARCH} bf16 rows {rows} experts touched "
            f"{len(groups)} kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"library_ms {lib_ms:.4f}  bound_ms {bound_ms:.5f} "
            f"({bound_by})  of the bound {bound_ms / ms:.3f}  host_us "
            f"{host_us(torch, kernel):.1f}")
        rows_out[rows] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    return rows_out[MOE_ROWS[0]]


def phase_moe_serve(torch, kernel_modules):
    """21 (b): full-width llama4-maverick cut to MOE_LAYERS layers, bf16,
    random weights drawn on the card, serves phase 5's 8 prompts (greedy,
    32 new tokens, max_seqs 8, chunked at 512) through the packed fused
    step captured into CUDA graphs, then eagerly, then through `submit()`
    + `run()` (graphs): identical tokens between graphs and eager and
    logits bit-equal (else within one bf16 ulp), `run()` equal to
    `step()` bit for bit; the grouped GEMM and every paged kernel
    launched (counters zeroed just before the graphed run and read just
    after); tokens/s, steps, keys captured, launches, peak memory and the
    replayed step's ms under `run()` against `step()` logged.  Returns
    the graphed run's launches by function."""
    import gc

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    K, GK = kernel_modules
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[MOE_ARCH].replace(num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"moe serve {MOE_ARCH}: {cfg.num_layers} of 48 layers, d_model "
        f"{cfg.d_model}, heads {cfg.num_q_heads}/{cfg.num_kv_heads} D "
        f"{cfg.resolved_head_dim}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} ff {cfg.moe.d_ff_expert} + "
        f"{cfg.moe.num_shared_experts} shared, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}: {n_params / 1e9:.2f} G parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB) drawn on the "
        f"card in {time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=8, num_pages=1024, max_model_len=2048,
                  enable_chunked_prefill=True, max_prefill_tokens=512,
                  seed=SEED, debug_logits=True, device=DEVICE)
    _, _, served = serve_prompts(torch, cfg.vocab_size)

    def requests():
        return [Request(prompt=list(p), max_new_tokens=MOE_NEW_TOKENS)
                for p in served]

    run = serve_run(torch, Engine(cfg, model, **eng_kw), requests(),
                    "moe serve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    eng = run["eng"]
    launches = dict(K.LAUNCHES) | dict(GK.LAUNCHES)
    if not all(r.state is State.FINISHED and len(r.output) == MOE_NEW_TOKENS
               for r in reqs):
        raise AssertionError("moe serve: not every request finished")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"moe serve: a kernel was never launched: "
                             f"{launches}")
    check_paged_routes(K, launches, "moe serve", cfg.dtype)
    # two launches (gate / up, down) per MoE layer per device step
    want = 2 * MOE_LAYERS * eng.device_calls["unified"]
    if GK.LAUNCHES[MOE] != want or GK.KERNEL_LAUNCHES["moe_mma_kernel"] \
            != want:
        raise AssertionError(f"moe serve: grouped GEMM launches "
                             f"{GK.KERNEL_LAUNCHES} != {want}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"moe serve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  new_tok_per_s {toks / wall:.1f}  "
        f"total_tok_per_s {(toks + prompt_toks) / wall:.1f}  keys captured "
        f"{eng.graph_stats['captures']} ({eng.graph_stats['capture_s']:.3f}"
        f"s capturing)  replays {eng.graph_stats['replays']}")
    log(f"moe serve dispatch_counts {dict(eng.dispatch_counts)}  device "
        f"calls {dict(eng.device_calls)}")
    log(f"moe serve launches {launches}  by kernel {GK.KERNEL_LAUNCHES}")
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False,
                                    **eng_kw), requests(), "moe serve eager")
    walls = graphs_vs_eager(torch, "moe serve", run, eager, cfg.dtype)
    del eager
    streamed = stream_run(torch, Engine(cfg, model, **eng_kw), requests(),
                          "moe serve run()")
    walls |= async_vs_sync(torch, "moe serve", run, streamed)
    by_kind = {"decode": [], "chunk": []}
    for st, dt in zip(run["stats"], run["step_walls"]):
        by_kind["chunk" if st["prefill"] else "decode"].append(dt)
    log("moe serve step() walls by kind (captures included): " + "  ".join(
        f"{k} {len(v)} steps mean {1e3 * statistics.fmean(v):.3f} ms"
        for k, v in by_kind.items() if v))
    for bucket in sorted({k[2] for k in streamed["eng"].compile_events}):
        walls |= {f"{name}_b{bucket}": v for name, v in replay_cost(
            torch, streamed["eng"], bucket=bucket, top=8).items()}
    del run, streamed, eng
    sampler_cost(torch, 2 * eng_kw["max_seqs"], cfg.vocab_size)
    peak = torch.cuda.max_memory_allocated()
    log(f"moe serve peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated, of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
        f"GiB)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(steps=steps, wall_s=wall, new_tokens=toks,
                          prompt_tokens=prompt_toks, peak_gib=peak / 2**30,
                          **walls)


def phase_moe_diff(torch):
    """21 (c): maverick's attention width with its MoE cut
    (MOE_DIFF_CUT, MOE_DIFF_EXPERTS; shared ff = d_ff_expert), fp32 with
    TF32 off: 3 greedy requests of 8 new tokens on the card and on the
    CPU (the card model a copy of the CPU one: a MoE model's random
    experts are drawn on its device), stepped in lockstep: identical
    tokens, logits within DIFF_LOGIT_ATOL, and every MoE call's expert ids
    equal.  The card runs eagerly (`cuda_graphs=False`) so that each
    call's routing reaches the host; (b) holds the graphs to eager."""
    import copy
    import dataclasses

    from repro_torch import weights
    from repro_torch.configs import ARCHS

    base = ARCHS[MOE_ARCH]
    cfg = base.replace(moe=dataclasses.replace(base.moe, **MOE_DIFF_EXPERTS),
                       **MOE_DIFF_CUT)
    cpu_model = weights.init_random(cfg, SEED, device="cpu")
    models = {"cpu": cpu_model,
              DEVICE: copy.deepcopy(cpu_model).to(DEVICE)}
    routed = {}
    for dev, model in models.items():
        seen = routed[dev] = []
        for blk in model.decoder_blocks():
            route = blk.moe.route

            def record(xt, route=route, seen=seen):
                w, ids = route(xt)
                seen.append(ids.cpu())
                return w, ids
            blk.moe.route = record
    g = torch.Generator(device="cpu").manual_seed(SEED + 21)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (37, 70, 101)]
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256, seed=SEED,
                  debug_logits=True, cuda_graphs=False)
    _, _, worst, steps, _ = lockstep_diff(torch, "moe diff", cfg, models,
                                          prompts, 8, eng_kw)
    same = len(routed[DEVICE]) == len(routed["cpu"]) and all(
        torch.equal(a, b) for a, b in zip(routed[DEVICE], routed["cpu"]))
    rows = sum(t.shape[0] for t in routed["cpu"])
    log(f"moe diff: cuts {MOE_DIFF_CUT} {MOE_DIFF_EXPERTS} (shared ff "
        f"{cfg.moe.d_ff_expert}); {len(routed['cpu'])} MoE calls, {rows} "
        f"rows routed: expert ids identical {same}")
    if not same:
        raise AssertionError("moe diff: the card and the CPU chose "
                             "different experts")
    return worst


# ---------------------------------------------------------------------------
# phase 22: MLA (deepseek-v2) on the padded serving step
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def counted_plain(*targets):
    """Every (module, name) plain version wrapped to count its calls:
    yields {name: calls} (a kernel wrapper that gave way to its plain
    version on the card would show there)."""
    calls, saved = {}, []
    for mod, name in targets:
        f = getattr(mod, name)
        calls[name] = 0

        def wrapped(*a, _f=f, _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        saved.append((mod, name, f))
        setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def sdpa_backend(torch, call):
    """(the first SDPA backend that runs `call`, in the order flash,
    efficient, cuDNN, math; None if none does), timed later under it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                call()
            torch.cuda.synchronize()
            return b
        except RuntimeError:
            continue
    return None


def mla_decode_inputs(torch, dtype, ctx, g, ps=16, h=128, r=512, rope=64):
    """q [S, H, r + rope], one pool of pages, a shuffled page table and
    contexts `ctx`, drawn from `g` on the card."""
    s = len(ctx)
    np_ = -(-max(ctx) // ps)
    p = s * np_ + 1
    q = torch.randn((s, h, r + rope), generator=g, device=DEVICE).to(dtype)
    kp = torch.randn((p, ps, r + rope), generator=g,
                     device=DEVICE).to(dtype)
    pt = (torch.randperm(p - 1, generator=g, device=DEVICE)[:s * np_]
          .reshape(s, np_) + 1).to(torch.int32)
    return q, kp, pt, torch.tensor(ctx, dtype=torch.int32, device=DEVICE)


def mla_decode_bound(ctx, h, r, rope, dtype_name):
    """(bound_ms, bound_by) of the latent decode: each live cached row read
    once (for both products), q read and o_lat written once; 2 x H x (D +
    r) operations a live row."""
    e = 2 if dtype_name == "bfloat16" else 4
    d = r + rope
    live = sum(ctx)
    nbytes = live * d * e + len(ctx) * h * (d + r) * e + 8 * len(ctx)
    flops = live * h * 2 * (d + r)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_mla_check(torch, AK, AO, ptxas=(), iters=20):
    """22 (a): the latent decode at deepseek-v2's widths through the
    serving entry (its split-KV choice: 8 segments and the merge launch
    at 8 rows, one segment at 64 rows) against its plain version, bf16
    (atol 2e-2) and fp32 (TF32 off, 1e-4), dead rows exact zeros; timed in
    bf16 beside its bound, its plain version and a page gather + SDPA
    yardstick, and also with the enqueue hidden (`lead_cycles`).
    `ptxas` holds `_build.resource_usage("mla_decode")`: the bf16
    kernel's lines are logged with its dynamic shared memory.  Returns
    (worst error, the 8-row shape's timing row)."""
    F = torch.nn.functional
    entry = False
    for line in ptxas:
        if "Compiling entry" in line:
            entry = "mla_wgmma_kernel" in line
            if entry:
                log("ptxas mla_wgmma_kernel")
        elif entry:
            log(f"ptxas   {line.replace('ptxas info    : ', '')}")
    log(f"mla_wgmma_kernel dynamic shared memory "
        f"{AK.library().mla_decode_smem_bytes()} B of 232448")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    worst, rows = 0.0, {}
    scale = (128 + 64) ** -0.5
    for tag, ctx in MLA_DECODE_SHAPES.items():
        for dtype_name, atol in (("bfloat16", 2e-2), ("float32", 1e-4)):
            dtype = getattr(torch, dtype_name)
            q, kp, pt, cl = mla_decode_inputs(torch, dtype, ctx, g)
            got = AO.mla_decode_attention(q, kp, pt, cl, v_dim=512,
                                          scale=scale)
            want = AK.mla_decode_plain(q, kp, pt, cl, v_dim=512,
                                       scale=scale)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            dead_exact = not bool(got[cl == 0].any())
            nseg, seg = AO.split(q.shape[0], 128, pt.shape[1] * 16,
                                 torch.cuda.get_device_properties(
                                     0).multi_processor_count)
            log(f"check {MLA:18s} {tag} {dtype_name} H 128 r 512 rope 64 "
                f"page 16, {nseg} segments of {seg} keys: max_abs_err "
                f"{err:.3e} (atol {atol:g}, max |o| "
                f"{float(want.float().abs().max()):.3f})  dead rows exact "
                f"zeros {dead_exact}")
            if not (err <= atol and dead_exact):
                raise AssertionError(f"{MLA} {tag} {dtype_name}: error "
                                     f"{err} > {atol} or a dead row is "
                                     f"not zero")
            worst = max(worst, err)
            if dtype_name != "bfloat16":
                continue
            s, h = q.shape[0], q.shape[1]
            length = pt.shape[1] * 16
            pos = torch.arange(length, device=DEVICE)
            mask = (pos[None, :] < cl[:, None].long())[:, None, None, :]
            pt_l = pt.long()

            def library():  # the H heads as query rows of one KV head
                k = kp[pt_l].reshape(s, 1, length, 576)
                return F.scaled_dot_product_attention(
                    q[:, None], k, k[..., :512], attn_mask=mask,
                    scale=scale)[:, 0]

            backend = sdpa_backend(torch, library)
            ms = time_ms(torch, lambda: AO.mla_decode_attention(
                q, kp, pt, cl, v_dim=512, scale=scale), iters, flush)
            # the launches' own time, the enqueue hidden behind a ~1 ms
            # spin
            hidden = time_ms(torch, lambda: AO.mla_decode_attention(
                q, kp, pt, cl, v_dim=512, scale=scale), iters, flush,
                lead_cycles=2_000_000)
            plain_ms = time_ms(torch, lambda: AK.mla_decode_plain(
                q, kp, pt, cl, v_dim=512, scale=scale), 3, flush)
            lib_ms = None
            if backend is not None:
                from torch.nn.attention import sdpa_kernel

                with sdpa_kernel([backend]):
                    lib_ms = time_ms(torch, library, iters, flush)
            bound_ms, bound_by = mla_decode_bound(ctx, 128, 512, 64,
                                                  dtype_name)
            log(f"time  {MLA:37s} {tag} bf16 (sum ctx {sum(ctx)}) "
                f"kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
                f"{lib_ms if lib_ms is None else round(lib_ms, 4)} "
                f"(gather + SDPA, backend {backend})  bound_ms "
                f"{bound_ms:.5f} ({bound_by})  of the bound "
                f"{bound_ms / ms:.3f}  host_us "
                f"{host_us(torch, lambda: AO.mla_decode_attention(q, kp, pt, cl, v_dim=512, scale=scale)):.1f}")
            log(f"time  {MLA:37s} {tag} bf16 kernel_ms with the enqueue "
                f"hidden {hidden:.4f}  of the bound {bound_ms / hidden:.3f}")
            rows[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
            del q, kp, pt, cl, got, want
    return worst, rows["8x0-2048"]


def mla_flash_inputs(torch, dtype, b, s, h, kvl, g):
    """Packed q [B*H, nq, bq, 192], k [B*H, S, 192], v [B*H, S, 128],
    kv_len [B*H] and the kernel's keywords (group 1: every MLA head has its
    own expanded key), drawn from `g` on the card."""
    from repro_torch.kernels.flash_attention import ops as fops

    bq = fops.pick_block_q(s, 1)
    q = torch.randn((b * h, s // bq, bq, 192), generator=g,
                    device=DEVICE).to(dtype)
    k = torch.randn((b * h, s, 192), generator=g, device=DEVICE).to(dtype)
    v = torch.randn((b * h, s, 128), generator=g, device=DEVICE).to(dtype)
    kv_len = torch.tensor(kvl, dtype=torch.int32,
                          device=DEVICE).repeat_interleave(h)
    return (q, k, v, kv_len, dict(block_q=bq, group=1, scale=192 ** -0.5,
                                  causal=True, q_offset=0))


def mla_flash_bound(b, s, h, kvl, dtype_name):
    """(bound_ms, bound_by): q read and o and lse written once for every
    row, k and v read once for the live keys only (the kernel loads no key
    at or past kv_len); 2 x (192 + 128) operations a (query, key) pair a
    head, each query row over min(row + 1, kv_len) keys."""
    e = 2 if dtype_name == "bfloat16" else 4
    rows = b * h * s
    live = h * sum(kvl)
    nbytes = rows * (192 + 128) * e + rows * 4 + live * (192 + 128) * e
    pairs = sum(sum(min(i + 1, n) for i in range(s)) for n in kvl)
    flops = h * pairs * 2 * (192 + 128)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def phase_mla_flash(torch, FK, kvl_serve, iters=10):
    """22 (b): the flash forward at key width 192 / value width 128 with a
    per-batch kv_len against its plain version, bf16 at the padded
    prefill of phase 5's prompts (8 x 1024 rows, 128 heads, kv_len the
    prompt lengths) and fp32 at MLA_FLASH_FP32; timed in bf16 beside its
    bound, its plain version and SDPA on the same masked problem.
    Returns (worst error, timing row)."""
    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    b, (s, h) = len(kvl_serve), MLA_FLASH_SERVE
    worst, row = 0.0, None
    for dtype_name, (b_, s_, h_, kvl), atol in (
            ("bfloat16", (b, s, h, kvl_serve), 2e-2),
            ("float32", MLA_FLASH_FP32, 1e-4)):
        dtype = getattr(torch, dtype_name)
        q, k, v, kv_len, kw = mla_flash_inputs(torch, dtype, b_, s_, h_,
                                               kvl, g)
        o, lse = FK.flash_attention_fwd(q, k, v, kv_len=kv_len, **kw)
        want_o, want_lse = FK.flash_attention_fwd_plain(q, k, v,
                                                        kv_len=kv_len, **kw)
        torch.cuda.synchronize()
        err = float((o.float() - want_o.float()).abs().max())
        err_lse = float((lse - want_lse).abs().max())
        log(f"check {MLA_FLASH:18s} {dtype_name} B {b_} S {s_} H {h_} "
            f"kv_len {kvl}: max_abs_err o {err:.3e} lse {err_lse:.3e} "
            f"(atol {atol:g})")
        if not (err <= atol and err_lse <= 1e-4):
            raise AssertionError(f"{MLA_FLASH} {dtype_name}: error {err} / "
                                 f"{err_lse} > {atol} / 1e-4")
        worst = max(worst, err)
        if dtype_name != "bfloat16":
            continue
        # SDPA on the same problem: [B, H, S, D], causal and kv_len masked
        qd, kd, vd = (x.reshape(b_, h_, s_, -1) for x in (q, k, v))
        pos = torch.arange(s_, device=DEVICE)
        lens = torch.tensor(kvl, device=DEVICE)
        mask = ((pos[None, :] <= pos[:, None])[None]
                & (pos[None, None, :] < lens[:, None, None]))[:, None]

        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                                  scale=kw["scale"])

        backend = sdpa_backend(torch, library)
        ms = time_ms(torch, lambda: FK.flash_attention_fwd(
            q, k, v, kv_len=kv_len, **kw), iters, flush)
        plain_ms = time_ms(torch, lambda: FK.flash_attention_fwd_plain(
            q, k, v, kv_len=kv_len, **kw), 2, flush)
        lib_ms = None
        if backend is not None:
            from torch.nn.attention import sdpa_kernel

            with sdpa_kernel([backend]):
                lib_ms = time_ms(torch, library, iters, flush)
        bound_ms, bound_by = mla_flash_bound(b_, s_, h_, kvl, dtype_name)
        log(f"time  {MLA_FLASH:37s} bf16 B {b_} S {s_} H {h_} kernel_ms "
            f"{ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} (SDPA, "
            f"backend {backend})  bound_ms {bound_ms:.5f} ({bound_by})  of "
            f"the bound {bound_ms / ms:.3f}")
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, o, want_o, qd, kd, vd, mask
    return worst, row


def profile_step(torch, step, tag, top=10):
    """`step()` under `torch.profiler`, the device activity alone: (its
    result, its wall ms, its kernels' summed device ms); the wall, the
    sum, the idle share and the `top` kernels by device time (with their
    share of the sum) logged.  The device events are summed from the
    profiler's raw results (its per-event tables take minutes to build
    for a step of ~10^5 kernels)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(ev.name(), (0.0, 0))
            by_name[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    rows = [(us, n, name) for name, (us, n) in by_name.items()]
    busy = sum(r[0] for r in rows) / 1e3
    log(f"{tag} (profiled): wall {wall:.3f} ms, its kernels {busy:.3f} ms "
        f"summed ({sum(r[1] for r in rows)} launches), idle share "
        f"{max(0.0, 1 - busy / wall):.3f}")
    for us, count, name in sorted(rows, reverse=True)[:top]:
        log(f"  {us / 1e3:8.3f} ms  {us / 1e3 / max(busy, 1e-9):6.3f}  "
            f"x{count:5d}  {name[:90]}")
    return out, wall, busy


def prefill_profile(torch, eng, top=10):
    """The first step of `eng` (a prefill, its requests added) profiled
    (`profile_step`)."""
    st, wall, busy = profile_step(torch, eng.step, "prefill step", top)
    if not st["prefill"]:
        raise AssertionError("prefill_profile: the first step did not "
                             "prefill")
    return dict(prefill_ms=wall, prefill_kernels_ms=busy)


def phase_mla_serve(torch, kernel_modules):
    """22 (c): full-width deepseek-v2 cut to MLA_LAYERS layers (1 dense +
    7 MoE), bf16, random weights drawn on the card, serves phase 5's 8
    prompts (greedy, 32 new tokens, max_seqs 8, unchunked) on the padded
    step (the packed request falls back to it, as in the reference), the
    decode step on CUDA graphs, then eagerly: identical tokens, logits
    bit-equal (else within one bf16 ulp); the latent decode (one launch
    and one merge a layer a decode step, the tensor-core kernel), the
    flash forward (one launch a layer a prefill) and the grouped GEMM (2
    a MoE layer a step) launched, no plain version called (counters
    zeroed just before the graphed run and read just after); tokens/s,
    steps, keys, peak memory and the decode graph's replay logged.
    Returns (the graphed run's launches by function, its numbers)."""
    import gc

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    K, FK, GK, AK = kernel_modules
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = ARCHS[MLA_ARCH].replace(num_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    m = cfg.mla
    log(f"mla serve {MLA_ARCH}: {cfg.num_layers} of 60 layers ("
        f"{cfg.moe.first_k_dense} dense), d_model {cfg.d_model}, "
        f"{cfg.num_q_heads} heads, q_lora {m.q_lora_rank} kv_lora "
        f"{m.kv_lora_rank} nope {m.qk_nope_dim} rope {m.qk_rope_dim} v "
        f"{m.v_head_dim}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} ff {cfg.moe.d_ff_expert} + "
        f"{cfg.moe.num_shared_experts} shared, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}: {n_params / 1e9:.2f} G parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB) drawn on the "
        f"card in {time.perf_counter() - t0:.1f}s")
    eng_kw = dict(max_seqs=8, num_pages=1024, max_model_len=2048,
                  seed=SEED, debug_logits=True, device=DEVICE)
    _, _, served = serve_prompts(torch, cfg.vocab_size)

    def requests():
        return [Request(prompt=list(p), max_new_tokens=MLA_NEW_TOKENS)
                for p in served]

    with counted_plain((AK, "mla_decode_plain"),
                       (FK, "flash_attention_fwd_plain"),
                       (GK, "grouped_gemm_plain")) as plain_calls:
        run = serve_run(torch, Engine(cfg, model, **eng_kw), requests(),
                        "mla serve")
    reqs, steps, wall = run["reqs"], len(run["stats"]), run["wall"]
    eng = run["eng"]
    launches = {MLA: AK.LAUNCHES[MLA],
                "flash_attention_fwd": FK.LAUNCHES["flash_attention_fwd"],
                MOE: GK.LAUNCHES[MOE]}
    if eng._packed:
        raise AssertionError("mla serve: MLA must take the padded step")
    if not all(r.state is State.FINISHED and len(r.output) == MLA_NEW_TOKENS
               for r in reqs):
        raise AssertionError("mla serve: not every request finished")
    if any(plain_calls.values()):
        raise AssertionError(f"mla serve: plain versions ran on the card "
                             f"path: {plain_calls}")
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"mla serve: a paged GQA kernel ran: "
                             f"{K.LAUNCHES}")
    from repro_torch.kernels.mla_decode import ops as AO

    calls = eng.device_calls
    n_moe = MLA_LAYERS - cfg.moe.first_k_dense
    nseg, _ = AO.split(eng.max_seqs, cfg.num_q_heads,
                       eng.pages_per_seq * cfg.page_size,
                       AO._sm_count(torch.device(DEVICE)))
    want = {MLA: MLA_LAYERS * calls["decode"],
            "flash_attention_fwd": MLA_LAYERS * calls["prefill"],
            MOE: 2 * n_moe * (calls["decode"] + calls["prefill"])}
    if launches != want \
            or AK.KERNEL_LAUNCHES["mla_wgmma_kernel"] != want[MLA] \
            or AK.KERNEL_LAUNCHES["mla_merge_kernel"] \
            != want[MLA] * (nseg > 1) \
            or GK.KERNEL_LAUNCHES["moe_mma_kernel"] != want[MOE]:
        raise AssertionError(f"mla serve: launches {launches} "
                             f"{AK.KERNEL_LAUNCHES} {GK.KERNEL_LAUNCHES} != "
                             f"{want}")
    if any(k[3] is not None for k in eng.compile_events):
        raise AssertionError(f"mla serve: kernel-config dispatch ran: "
                             f"{eng.compile_events}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    log(f"mla serve steps {steps}  prompt_tokens {prompt_toks}  new_tokens "
        f"{toks}  wall_s {wall:.3f}  new_tok_per_s {toks / wall:.1f}  "
        f"total_tok_per_s {(toks + prompt_toks) / wall:.1f}  keys "
        f"{eng.compile_events}  captured {eng.graph_stats['captures']} ("
        f"{eng.graph_stats['capture_s']:.3f}s capturing)  replays "
        f"{eng.graph_stats['replays']}")
    log(f"mla serve device calls {dict(calls)}  launches {launches}  by "
        f"kernel {AK.KERNEL_LAUNCHES} {GK.KERNEL_LAUNCHES}  plain calls "
        f"{plain_calls}  latent decode segments {nseg}")
    by_kind = {"decode": [], "prefill": []}
    for st, dt in zip(run["stats"], run["step_walls"]):
        by_kind["prefill" if st["prefill"] else "decode"].append(dt)
    log("mla serve step() walls by kind (captures included): " + "  ".join(
        f"{k} {len(v)} steps mean {1e3 * statistics.fmean(v):.3f} ms"
        for k, v in by_kind.items() if v))
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False,
                                    **eng_kw), requests(), "mla serve eager")
    walls = graphs_vs_eager(torch, "mla serve", run, eager, cfg.dtype)
    del eager
    walls |= replay_cost(torch, eng, top=8,
                         focus=("mla_wgmma_kernel", "mla_merge_kernel"))
    del run, eng
    peak = torch.cuda.max_memory_allocated()
    # where the prefill step's time goes (warm: the third prefill of the
    # process)
    prof_eng = Engine(cfg, model, cuda_graphs=False, **eng_kw)
    for r in requests():
        prof_eng.add_request(r)
    walls |= prefill_profile(torch, prof_eng)
    del prof_eng
    log(f"mla serve peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated, of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
        f"GiB)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(steps=steps, wall_s=wall, new_tokens=toks,
                          prompt_tokens=prompt_toks, peak_gib=peak / 2**30,
                          **walls)


def phase_mla_diff(torch):
    """22 (d): deepseek-v2's attention width with its MoE cut
    (MLA_DIFF_CUT, MLA_DIFF_EXPERTS: 1 dense + 1 MoE layer), fp32 with
    TF32 off: 3 greedy requests of 8 new tokens on the card (eager, the
    fp32 kernels, so each MoE call's routing reaches the host) and on the
    CPU (the card model a copy of the CPU one), stepped in lockstep:
    identical tokens, logits within DIFF_LOGIT_ATOL, every MoE call's
    expert ids equal."""
    import copy
    import dataclasses

    from repro_torch import weights
    from repro_torch.configs import ARCHS

    base = ARCHS[MLA_ARCH]
    cfg = base.replace(moe=dataclasses.replace(base.moe, **MLA_DIFF_EXPERTS),
                       **MLA_DIFF_CUT)
    cpu_model = weights.init_random(cfg, SEED, device="cpu")
    models = {"cpu": cpu_model,
              DEVICE: copy.deepcopy(cpu_model).to(DEVICE)}
    routed = {}
    for dev, model in models.items():
        seen = routed[dev] = []
        for blk in model.decoder_blocks():
            if not hasattr(blk, "moe"):
                continue
            route = blk.moe.route

            def record(xt, route=route, seen=seen):
                w, ids = route(xt)
                seen.append(ids.cpu())
                return w, ids
            blk.moe.route = record
    g = torch.Generator(device="cpu").manual_seed(SEED + 22)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (37, 70, 101)]
    eng_kw = dict(max_seqs=4, num_pages=64, max_model_len=256, seed=SEED,
                  debug_logits=True, cuda_graphs=False)
    _, _, worst, steps, _ = lockstep_diff(torch, "mla diff", cfg, models,
                                          prompts, 8, eng_kw)
    same = len(routed[DEVICE]) == len(routed["cpu"]) > 0 and all(
        torch.equal(a, b) for a, b in zip(routed[DEVICE], routed["cpu"]))
    rows = sum(t.shape[0] for t in routed["cpu"])
    log(f"mla diff: cuts {MLA_DIFF_CUT} {MLA_DIFF_EXPERTS} (top-"
        f"{cfg.moe.top_k}, {cfg.moe.num_shared_experts} shared, "
        f"{cfg.moe.first_k_dense} dense); {len(routed['cpu'])} MoE calls, "
        f"{rows} rows routed: expert ids identical {same}")
    if not same:
        raise AssertionError("mla diff: the card and the CPU chose "
                             "different experts")
    return worst


# ---------------------------------------------------------------------------
# phase 23: MoE and MLA training (deepseek-v2)
# ---------------------------------------------------------------------------


def phase_mtrain_flash(torch, FK, iters=10):
    """23 (a): the flash forward at key width 192 / value width 128
    without kv_len (`flash_mma_kernel<192, 128, false>`, the training
    path's instance) against its plain version at the train shape (B 1, S
    2048, 128 heads, causal) in bf16 (atol 2e-2) and at MTRAIN_FLASH_FP32
    in fp32 (TF32 off, 1e-4); the gradient (kernel forward + recompute
    backward) on the card against the same on the CPU in fp32 at
    MTRAIN_GRAD, with and without kv_len (1e-4); the forward timed at the
    train shape beside its bound, its plain version and SDPA (a yardstick,
    never called by the port).  Returns (worst forward error, timing
    row)."""
    from repro_torch.kernels.flash_attention import ops as fops

    F = torch.nn.functional
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 24)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    worst, row = 0.0, None
    train = (MTRAIN_BATCH, MTRAIN_SEQ, MTRAIN_HEADS)
    for dtype_name, (b, s, h), atol in (("bfloat16", train, 2e-2),
                                        ("float32", MTRAIN_FLASH_FP32, 1e-4)):
        dtype = getattr(torch, dtype_name)
        q, k, v, _, kw = mla_flash_inputs(torch, dtype, b, s, h, [s] * b, g)
        o, lse = FK.flash_attention_fwd(q, k, v, **kw)
        want_o, want_lse = FK.flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((o.float() - want_o.float()).abs().max())
        err_lse = float((lse - want_lse).abs().max())
        log(f"check {MTRAIN:18s} {dtype_name} B {b} S {s} H {h} (no "
            f"kv_len): max_abs_err o {err:.3e} lse {err_lse:.3e} (atol "
            f"{atol:g})")
        if not (err <= atol and err_lse <= 1e-4):
            raise AssertionError(f"{MTRAIN} {dtype_name}: error {err} / "
                                 f"{err_lse} > {atol} / 1e-4")
        worst = max(worst, err)
        if dtype_name != "bfloat16":
            continue
        qd, kd, vd = (x.reshape(b, h, s, -1) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qd, kd, vd, is_causal=True,
                                                  scale=kw["scale"])

        def kernel():
            return FK.flash_attention_fwd(q, k, v, **kw)

        backend = sdpa_backend(torch, library)
        ms = time_ms(torch, kernel, iters, flush)
        ms_hidden = time_ms(torch, kernel, iters, flush,
                            lead_cycles=2_000_000)
        plain_ms = time_ms(torch, lambda: FK.flash_attention_fwd_plain(
            q, k, v, **kw), 2, flush)
        lib_ms = None
        if backend is not None:
            from torch.nn.attention import sdpa_kernel

            with sdpa_kernel([backend]):
                lib_ms = time_ms(torch, library, iters, flush)
        bound_ms, bound_by = mla_flash_bound(b, s, h, [s] * b, dtype_name)
        log(f"time  {MTRAIN:37s} bf16 B {b} S {s} H {h} kernel_ms "
            f"{ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} (SDPA, "
            f"backend {backend})  bound_ms {bound_ms:.5f} ({bound_by})  of "
            f"the bound {bound_ms / ms:.3f}  kernel_ms with the enqueue "
            f"hidden {ms_hidden:.4f}")
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, o, want_o, qd, kd, vd
    # the gradient: autograd through the kernel on the card against the
    # plain version on the CPU, the same inputs, fp32
    b, s, h = MTRAIN_GRAD
    cg = torch.Generator(device="cpu").manual_seed(SEED + 25)
    inputs = [torch.randn((b, s, h, d), generator=cg) for d in (192, 192,
                                                                128)]
    w = torch.randn((b, s, h, 128), generator=cg)
    for kvl in (None, MTRAIN_GRAD_KV_LEN):
        grads = []
        for dev in (DEVICE, "cpu"):
            xs = [x.detach().to(dev).requires_grad_(True) for x in inputs]
            kv_len = None if kvl is None else torch.tensor(
                kvl, dtype=torch.int32, device=dev)
            out = fops.flash_attention(*xs, causal=True, scale=192 ** -0.5,
                                       kv_len=kv_len)
            torch.sum(out * w.to(dev)).backward()
            grads.append([x.grad.cpu() for x in xs])
        gerr = max(float((a - c).abs().max()) for a, c in zip(*grads))
        log(f"flash grad 192/128 B {b} S {s} H {h} kv_len {kvl} fp32 card "
            f"vs cpu: max_abs_err {gerr:.3e} atol 1e-4  "
            f"{'ok' if gerr <= 1e-4 else 'FAIL'}")
        if not gerr <= 1e-4:
            raise AssertionError("flash 192/128 gradient: card vs CPU "
                                 "differ")
    return worst, row


def mtrain_split(torch, model, state, batch, step_ms):
    """Where phase 23 (b)'s step goes: one step profiled, then, each with
    CUDA events at the train shape (L2 flushed): the AdamW update over
    this model's gradients (at lr 0, so the parameters keep their values;
    the phase's last use of the moments), the flash recompute backward
    alone, the MoE layer's capacity dispatch forward and forward +
    backward, its three expert `torch.bmm` alone, and the MLA attention's
    forward and forward + backward.  The step runs each layer's forward
    twice (remat) and its backward once."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import moe as TMOE
    from repro_torch.models.model import apply_train
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.trainer import train_step

    _, wall, busy = profile_step(torch, lambda: train_step(
        model, state, batch, **TRAIN_KW), "mtrain step", top=15)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    cfg, blk = model.cfg, model.blocks[0]
    dt = cfg.param_dtype
    t, s, h = MTRAIN_BATCH * MTRAIN_SEQ, MTRAIN_SEQ, cfg.num_q_heads
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 26)

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=g, device=DEVICE).to(dtype)

    params = list(model.parameters())
    apply_train(model, batch)[0].backward()
    grads = [p.grad for p in params]
    split = {"adamw": time_ms(torch, lambda: adamw_update(
        grads, state["opt"], params, lr=torch.zeros((), device=DEVICE)),
        2, flush)}
    del grads
    for p in params:
        p.grad = None
    qp, kp = randn(1, h, s, 192), randn(1, h, s, 192)
    vp, dop = randn(1, h, s, 128), randn(1, h, s, 128)
    op, lse = fops.flash_forward(qp, kp, vp, group=1, causal=True,
                                 scale=192 ** -0.5, q_offset=0)
    split["flash_backward"] = time_ms(torch, lambda: fops.flash_backward(
        qp, kp, vp, op, lse, dop, group=1, causal=True, scale=192 ** -0.5,
        q_offset=0), 3, flush)
    del qp, kp, vp, dop, op, lse
    x = randn(MTRAIN_BATCH, s, cfg.d_model).requires_grad_(True)
    pos = torch.arange(s, device=DEVICE)[None].expand(MTRAIN_BATCH, -1)

    def fwd_bwd(f):
        def call():
            y = f()
            y = y[0] + y[1] if isinstance(y, tuple) else y
            y.float().sum().backward()
        return call

    def no_grad(f):
        def call():
            with torch.no_grad():
                f()
        return call

    moe = lambda: blk.moe(x, mode="train")  # noqa: E731
    attn = lambda: blk.attn.forward_train(x, pos)  # noqa: E731
    _, _, cap = TMOE.capacity_layout(t, cfg.moe.num_experts,
                                     cfg.moe.top_k, cfg.moe.capacity_factor)
    xe = randn(cfg.moe.num_experts, cap, cfg.d_model)

    def bmm3():
        with torch.no_grad():
            hid = torch.nn.functional.silu(torch.bmm(xe, blk.moe.w_gate)) \
                * torch.bmm(xe, blk.moe.w_up)
            torch.bmm(hid, blk.moe.w_down)
    split |= {"moe_fwd": time_ms(torch, no_grad(moe), 5, flush),
              "moe_fwd_bwd": time_ms(torch, fwd_bwd(moe), 3, flush),
              "moe_bmm3_fwd": time_ms(torch, bmm3, 5, flush),
              "attn_fwd": time_ms(torch, no_grad(attn), 5, flush),
              "attn_fwd_bwd": time_ms(torch, fwd_bwd(attn), 3, flush)}
    for p in params:
        p.grad = None
    e_bytes = 3 * blk.moe.w_gate.numel() * blk.moe.w_gate.element_size()
    log("mtrain parts (CUDA events, L2 flushed, bf16, T "
        f"{t}): " + "  ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; the three expert matrices hold {e_bytes / 1e9:.2f} GB "
        f"({e_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s)")
    shares = {
        "adamw": split["adamw"],
        "attention (2 layers: 2 forwards + a backward each)": 2 * (
            split["attn_fwd"] + split["attn_fwd_bwd"]),
        "  of it the flash recompute backward": 2 * split["flash_backward"],
        "MoE layer (2 forwards + a backward)": split["moe_fwd"]
        + split["moe_fwd_bwd"],
        "  of it the expert bmm (3 passes of the weights)": 3 * split[
            "moe_bmm3_fwd"]}
    log(f"mtrain step {step_ms:.1f} ms, by part: " + "; ".join(
        f"{k} {v:.1f} ms ({v / step_ms:.3f})" for k, v in shares.items()))
    return dict(profiled_ms=wall, profiled_kernels_ms=busy, **split)


def phase_mtrain(torch, kernel_modules):
    """23 (b): full-width deepseek-v2 cut to MTRAIN_LAYERS of its 60
    layers (1 dense + 1 MoE), bf16, random weights drawn on the card,
    takes 1 + MTRAIN_STEPS AdamW steps at batch 1 x seq 2048 of Markov
    data (seed 1) through `trainer.train_step`.  The launch counters are
    zeroed just before the steps and read just after: the flash forward
    runs 2 a layer a step (the forward and its remat recompute), every
    launch the tensor-core kernel; the grouped GEMM, the latent decode and
    the paged kernels never; no plain version runs.  Every loss finite;
    step ms, tokens/s, peak memory against the standing state, the share
    of routed (token, choice) pairs dropped, each MoE call's busiest
    expert and idle experts, aux, and a profiled step with its parts
    (`mtrain_split`) logged.  Returns (flash launches, numbers)."""
    import gc

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe as TMOE
    from repro_torch.training.trainer import make_train_state, train_step

    K, FK, GK, AK = kernel_modules
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ARCHS[MLA_ARCH].replace(num_layers=MTRAIN_LAYERS)
    m = cfg.mla
    if (cfg.num_q_heads, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim) \
            != (MTRAIN_HEADS, 192, 128):
        raise AssertionError("phase 23 (a)'s flash shape is not the train "
                             "path's")
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    state = make_train_state(model)
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    standing = sum(2 * p.numel() * p.element_size() + 8 * p.numel()
                   for p in params)  # params, grads, fp32 mu and nu
    t, k = MTRAIN_BATCH * MTRAIN_SEQ, cfg.moe.top_k
    sg, groups, cap = TMOE.capacity_layout(t, cfg.moe.num_experts, k,
                                           cfg.moe.capacity_factor)
    steps = 1 + MTRAIN_STEPS
    batches = markov_batches(torch, cfg, steps + 1, MTRAIN_BATCH,
                             MTRAIN_SEQ, DEVICE)
    torch.cuda.synchronize()
    log(f"mtrain {MLA_ARCH}: {cfg.num_layers} of 60 layers ("
        f"{cfg.moe.first_k_dense} dense), d_model {cfg.d_model}, "
        f"{cfg.num_q_heads} heads, {cfg.moe.num_experts} experts top-{k} "
        f"ff {cfg.moe.d_ff_expert} + {cfg.moe.num_shared_experts} shared, "
        f"cf {cfg.moe.capacity_factor}, vocab {cfg.vocab_size}, {cfg.dtype}"
        f": {n_params / 1e9:.3f} G parameters; params + grads + fp32 "
        f"moments {standing / 2**30:.2f} GiB; batch {MTRAIN_BATCH} x seq "
        f"{MTRAIN_SEQ}: T {t}, {groups} group(s) of {sg}, capacity {cap}; "
        f"set-up {time.perf_counter() - t0:.1f}s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    # each MoE call's kept (token, choice) pairs, its busiest expert's
    # routed pairs and its experts without one, on the device
    kept, loads = [], []
    for blk in model.decoder_blocks():
        if hasattr(blk, "moe"):
            slots = blk.moe.capacity_slots

            def record(topi, cap_, slots=slots):
                slot, keep = slots(topi, cap_)
                kept.append(keep.sum())
                load = torch.bincount(topi.reshape(-1),
                                      minlength=cfg.moe.num_experts)
                loads.append(torch.stack([load.max(), (load == 0).sum()]))
                return slot, keep
            blk.moe.capacity_slots = record
    n_moe = len(model.blocks)
    before = [p.detach().clone() for p in model.blocks[0].attn.parameters()]
    torch.cuda.reset_peak_memory_stats()
    for mod in (K, FK, GK, AK):
        mod.reset_launches()
    losses, ces, auxes, gnorms, times = [], [], [], [], []
    with counted_plain((FK, "flash_attention_fwd_plain"),
                       (GK, "grouped_gemm_plain"),
                       (AK, "mla_decode_plain")) as plain_calls:
        for i, batch in enumerate(batches[:steps]):
            t0 = time.perf_counter()
            state, met = train_step(model, state, batch, **TRAIN_KW)
            losses.append(float(met["loss"]))
            ces.append(float(met["ce"]))
            auxes.append(float(met["aux"]))
            gnorms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            log(f"mtrain step {i}{' (warm-up)' if i == 0 else ''}: loss "
                f"{losses[-1]:.4f} ce {ces[-1]:.4f} aux {auxes[-1]:.5f} "
                f"grad_norm {gnorms[-1]:.4f} lr {float(met['lr']):.2e} "
                f"{times[-1] * 1e3:.1f} ms")
    launches = {"flash_attention_fwd": FK.LAUNCHES["flash_attention_fwd"],
                **FK.KERNEL_LAUNCHES}
    others = {**K.LAUNCHES, **GK.LAUNCHES, **AK.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    # every MoE call: each step's forward, then its remat recompute
    dropped = [1 - float(x) / (t * k) for x in kept]
    timed = times[1:]
    tok_s = t * len(timed) / sum(timed)
    log(f"mtrain {len(timed)} timed steps: mean_step_ms "
        f"{sum(timed) / len(timed) * 1e3:.1f}  tokens_per_s {tok_s:.1f}  "
        f"max_memory_allocated_gib {peak / 2**30:.2f} (standing state "
        f"{standing / 2**30:.2f} GiB, of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f})  "
        f"flash launches {launches}  other kernels {others}  plain calls "
        f"{plain_calls}")
    log(f"mtrain routed (token, choice) pairs dropped per MoE call: "
        f"{[round(x, 5) for x in dropped]} (capacity {cap} of {t * k} "
        f"pairs over {cfg.moe.num_experts} experts, a mean load of "
        f"{t * k / cfg.moe.num_experts:g}); busiest expert's pairs and "
        f"experts with none, per call: {[x.tolist() for x in loads]}; "
        f"aux {auxes}")
    if not all(math.isfinite(x) for x in losses + gnorms + auxes):
        raise AssertionError(f"mtrain: non-finite loss, aux or grad norm: "
                             f"{losses} {auxes} {gnorms}")
    if abs(ces[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"mtrain: step 0 ce {ces[0]} is not within 1.0 "
                             f"of ln V = {math.log(cfg.vocab_size):.2f}")
    if len(kept) != 2 * n_moe * steps:
        raise AssertionError(f"mtrain: {len(kept)} MoE calls, expected "
                             f"{2 * n_moe * steps}")
    want = 2 * MTRAIN_LAYERS * steps
    if launches != {"flash_attention_fwd": want, "flash_mma_kernel": want,
                    "flash_fwd_kernel": 0}:
        raise AssertionError(f"mtrain: flash launches {launches}, expected "
                             f"{want}, every one flash_mma_kernel")
    if any(others.values()) or any(plain_calls.values()):
        raise AssertionError(f"mtrain: serving kernels or plain versions "
                             f"ran: {others} {plain_calls}")
    # every matrix changes; bf16 norm scales near 1 may round back
    stuck = [n for (n, p), b in zip(model.blocks[0].attn.named_parameters(),
                                    before)
             if p.ndim == 2 and torch.equal(p.detach(), b)]
    if stuck:
        raise AssertionError(f"mtrain: parameters did not change: {stuck}")
    del before
    numbers = mtrain_split(torch, model, state, batches[steps],
                           1e3 * sum(timed) / len(timed))
    del model, state, batches, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention_fwd"], dict(
        step_ms=1e3 * sum(timed) / len(timed), tokens_per_s=tok_s,
        peak_gib=peak / 2**30, standing_gib=standing / 2**30,
        dropped=dropped, **numbers)


def phase_mtrain_diff(torch):
    """23 (c): deepseek-v2's attention width with its MoE cut
    (MTRAIN_DIFF_CUT, MTRAIN_DIFF_EXPERTS: 1 dense + 1 MoE layer), fp32
    with TF32 off: MTRAIN_DIFF_STEPS train steps at 2 x 128 on the card
    and on the CPU from the same weights (the card model a copy of the CPU
    one) and batches: losses within TDIFF_LOSS_RTOL relative, grad norms
    within TDIFF_GNORM_RTOL, aux within MTRAIN_AUX_ATOL; the first step's
    MoE forward chooses the same experts and keeps and drops the same
    (token, choice) pairs on both."""
    import copy
    import dataclasses

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.training.trainer import make_train_state, train_step

    base = ARCHS[MLA_ARCH]
    cfg = base.replace(moe=dataclasses.replace(base.moe,
                                               **MTRAIN_DIFF_EXPERTS),
                       **MTRAIN_DIFF_CUT)
    cpu_model = weights.init_random(cfg, SEED, device="cpu")
    models = {DEVICE: copy.deepcopy(cpu_model).to(DEVICE), "cpu": cpu_model}
    del cpu_model
    runs, routed = {}, {}
    for dev in list(models):
        model = models.pop(dev)
        seen = routed[dev] = []
        for blk in model.decoder_blocks():
            if hasattr(blk, "moe"):
                slots = blk.moe.capacity_slots

                def record(topi, cap, slots=slots, seen=seen):
                    slot, keep = slots(topi, cap)
                    seen.append((topi.cpu(), keep.cpu()))
                    return slot, keep
                blk.moe.capacity_slots = record
        state = make_train_state(model)
        out = []
        for batch in markov_batches(torch, cfg, MTRAIN_DIFF_STEPS,
                                    MTRAIN_DIFF_BATCH, MTRAIN_DIFF_SEQ, dev):
            state, met = train_step(model, state, batch, **TRAIN_KW)
            out.append((float(met["loss"]), float(met["grad_norm"]),
                        float(met["aux"])))
        runs[dev] = out
        del model, state
    card, cpu = runs[DEVICE], runs["cpu"]
    worst_l = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(card, cpu))
    worst_g = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(card, cpu))
    worst_a = max(abs(a[2] - b[2]) for a, b in zip(card, cpu))
    (ids_d, keep_d), (ids_c, keep_c) = routed[DEVICE][0], routed["cpu"][0]
    same_ids, same_keep = torch.equal(ids_d, ids_c), torch.equal(keep_d,
                                                                 keep_c)
    later = sum(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(routed[DEVICE][1:], routed["cpu"][1:]))
    log(f"mtrain diff fp32 {MTRAIN_DIFF_STEPS} steps batch "
        f"{MTRAIN_DIFF_BATCH} x seq {MTRAIN_DIFF_SEQ}, cuts "
        f"{MTRAIN_DIFF_CUT} {MTRAIN_DIFF_EXPERTS} (top-{cfg.moe.top_k}, "
        f"cf {cfg.moe.capacity_factor}): (loss, grad_norm, aux) card "
        f"{card} cpu {cpu}; loss rel {worst_l:.3e} (bound "
        f"{TDIFF_LOSS_RTOL:g}), grad_norm rel {worst_g:.3e} (bound "
        f"{TDIFF_GNORM_RTOL:g}), aux abs {worst_a:.3e} (bound "
        f"{MTRAIN_AUX_ATOL:g})")
    log(f"mtrain diff first MoE forward: expert ids identical {same_ids}, "
        f"kept / dropped pairs identical {same_keep} ({int(keep_c.sum())} "
        f"of {keep_c.numel()} kept); later MoE calls identical {later} of "
        f"{len(routed['cpu']) - 1}")
    if not (worst_l <= TDIFF_LOSS_RTOL and worst_g <= TDIFF_GNORM_RTOL
            and worst_a <= MTRAIN_AUX_ATOL):
        raise AssertionError("mtrain diff: training on the card and on the "
                             "CPU differ")
    if not (same_ids and same_keep):
        raise AssertionError("mtrain diff: the card and the CPU routed or "
                             "dropped differently")


def ssd_op_inputs(torch, case, dtype_name, device, seed=40):
    """The SSD op's inputs (x, dt, a, b, c, d) on `device`, drawn like
    `ssd_inputs`'s (training has no initial state)."""
    bsz, l, h, p, n, grp, _ = case
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((bsz, l, h, p), generator=g).to(dtype)
    dt = torch.randn((bsz, l, h), generator=g).abs() * 0.5 + 0.01
    a = -torch.randn((h,), generator=g).abs() - 0.1
    bm = torch.randn((bsz, l, grp, n), generator=g).to(dtype)
    cm = torch.randn((bsz, l, grp, n), generator=g).to(dtype)
    d = torch.randn((h,), generator=g)
    return tuple(t.to(device) for t in (x, dt, a, bm, cm, d))


def mlstm_op_inputs(torch, case, dtype_name, device, seed=41):
    """The mLSTM op's inputs (q, k, v, igate, fgate) on `device`, drawn
    like `mlstm_inputs`'s (forget bias 2)."""
    bsz, l, h, p = case[:4]
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((bsz, l, h, p), generator=g).to(dtype)
               for _ in range(3))
    ig = torch.randn((bsz, l, h), generator=g)
    fg = torch.randn((bsz, l, h), generator=g) + 2.0
    return tuple(t.to(device) for t in (q, k, v, ig, fg))


def trainable_grad_diff(torch, fn, inputs):
    """fn (a trainable Function) on the card and on the CPU from the same
    fp32 inputs against one cotangent: the largest gradient error of any
    input relative to that gradient's largest element."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 27)
    grads = []
    w = None
    for dev in (DEVICE, "cpu"):
        xs = [t.detach().to(dev).requires_grad_(True) for t in inputs]
        y = fn(*xs)
        if w is None:
            w = torch.randn(y.shape, generator=g)
        (y * w.to(dev)).sum().backward()
        grads.append([x.grad.cpu() for x in xs])
    worst = 0.0
    for a, b in zip(*grads):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("trainable gradient: non-finite on the card")
        worst = max(worst, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30))
    return worst


def fwd_bwd_ms(torch, fn, inputs, flush, iters=3):
    """(forward ms, forward + backward ms) of a trainable Function on
    `inputs` (bf16 on the card), CUDA events, L2 flushed."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    with torch.no_grad():
        dy = fn(*xs).float().normal_().to(xs[0].dtype)

    def step():
        for x in xs:
            x.grad = None
        fn(*xs).backward(dy)
    with torch.no_grad():
        fwd = time_ms(torch, lambda: fn(*xs), iters, flush)
    return fwd, time_ms(torch, step, iters, flush)


def phase_rtrain_kernels(torch, SK, MK, FK, iters=10):
    """24 (a), (b): zamba2's SSD (RTRAIN_SSD_CASE) and xlstm's mLSTM
    (RTRAIN_MLSTM_CASE) at their training shapes, from the zero state:
    the bf16 kernel against its plain version (SSD 2e-2; mLSTM h 8e-3 x
    max |h|, the state 2e-5 x max), the trainable Function's bf16 forward
    bit for bit the op it wraps (one kernel launch), its fp32 gradients
    card vs CPU at a cut (RTRAIN_GRAD_RTOL x max), and the kernel's ms
    beside its plain version and its bound, the Function's forward and
    forward + backward ms (the backward the recompute form); then the D
    64 flash forward at zamba2's training attention (RTRAIN_FLASH_CASE)
    against its plain version (2e-2) and timed beside its plain version,
    SDPA and its bound.  Returns ({row: max abs error}, {row: timing
    numbers})."""
    from repro_torch.kernels.mamba2 import ops as sops
    from repro_torch.kernels.mlstm import ops as mops

    F = torch.nn.functional
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    errs, rows, fb = {}, {}, {}
    # (a) the SSD
    case = RTRAIN_SSD_CASE
    chunk = case[-1]
    args = ssd_inputs(torch, case, "bfloat16")
    args = args[:5] + (torch.zeros_like(args[5]),)
    got = SK.ssd_chunked_fwd(*args, chunk=chunk)
    want = SK.ssd_chunked_fwd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    err, bound, abs_err = ssd_err(torch, got, want, "bfloat16")
    log(f"rtrain check {RTRAIN_SSD} bf16 {case}: err {err:.3e} bound "
        f"{bound:g}  {'ok' if err <= bound else 'FAIL'}")
    if not err <= bound:
        raise AssertionError("rtrain: the SSD kernel disagrees with its plain "
                             "version at the training shape")
    errs[RTRAIN_SSD] = abs_err
    ms = time_ms(torch, lambda: SK.ssd_chunked_fwd(*args, chunk=chunk), iters,
                 flush)
    plain_ms = time_ms(torch, lambda: SK.ssd_chunked_fwd_plain(
        *args, chunk=chunk), 2, flush)
    bound_ms, bound_by = ssd_bound(case, "bfloat16")
    rows[RTRAIN_SSD] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                            bound_ms=bound_ms, bound_by=bound_by)
    del args, got, want
    ops_in = ssd_op_inputs(torch, case, "bfloat16", DEVICE)
    fn = lambda *t: sops.mamba2_ssd_trainable(*t, chunk=chunk)  # noqa: E731
    SK.reset_launches()
    with torch.no_grad():
        same = torch.equal(fn(*ops_in), sops.mamba2_ssd(*ops_in,
                                                        chunk=chunk)[0])
    if not (same and SK.KERNEL_LAUNCHES["ssd_mma_kernel"] == 2):
        raise AssertionError(f"rtrain: the SSD Function's forward is not the "
                             f"op's ({same}, {SK.KERNEL_LAUNCHES})")
    fb["ssd"] = fwd_bwd_ms(torch, fn, ops_in, flush)
    del ops_in
    gerr = trainable_grad_diff(torch, lambda *t: sops.mamba2_ssd_trainable(
        *t, chunk=RTRAIN_SSD_GRAD[-1]), ssd_op_inputs(
            torch, RTRAIN_SSD_GRAD, "float32", "cpu"))
    log(f"rtrain {RTRAIN_SSD}: kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"bound_ms {bound_ms:.5f} ({bound_by}); the Function bf16 forward "
        f"{fb['ssd'][0]:.4f} ms, forward + recompute backward "
        f"{fb['ssd'][1]:.4f} ms; fp32 gradient card vs cpu at "
        f"{RTRAIN_SSD_GRAD}: {gerr:.3e} x max (bound {RTRAIN_GRAD_RTOL:g})")
    if not gerr <= RTRAIN_GRAD_RTOL:
        raise AssertionError("rtrain: SSD gradients differ card vs CPU")
    # (b) the mLSTM
    case = RTRAIN_MLSTM_CASE
    chunk, p = case[4], case[3]
    args = mlstm_inputs(torch, case, "bfloat16")
    kw = dict(chunk=chunk, scale=p ** -0.5)
    got = MK.mlstm_chunked_fwd(*args, **kw)
    want = MK.mlstm_chunked_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    worst, ok = 0.0, True
    for name, a, b in zip(("h", "C", "n", "m"), got, want):
        e = float((a.float() - b.float()).abs().max())
        rtol = MLSTM_BF16_H_RTOL if name == "h" else MLSTM_FP32_RTOL
        ok = ok and e <= rtol * max(1.0, float(b.float().abs().max()))
        worst = max(worst, e)
    log(f"rtrain check {RTRAIN_MLSTM} bf16 {case}: max abs err {worst:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("rtrain: the mLSTM kernel disagrees with its "
                             "plain version at the training shape")
    errs[RTRAIN_MLSTM] = worst
    ms = time_ms(torch, lambda: MK.mlstm_chunked_fwd(*args, **kw), iters,
                 flush)
    plain_ms = time_ms(torch, lambda: MK.mlstm_chunked_fwd_plain(*args, **kw),
                       2, flush)
    bound_ms, bound_by = mlstm_bound(case, "bfloat16")
    rows[RTRAIN_MLSTM] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                              bound_ms=bound_ms, bound_by=bound_by)
    del args, got, want
    ops_in = mlstm_op_inputs(torch, case, "bfloat16", DEVICE)
    fn = lambda *t: mops.mlstm_trainable(*t, chunk=chunk)  # noqa: E731
    MK.reset_launches()
    with torch.no_grad():
        same = torch.equal(fn(*ops_in), mops.mlstm_chunked(*ops_in,
                                                           chunk=chunk)[0])
    if not (same and MK.KERNEL_LAUNCHES["mlstm_mma_kernel"] == 2):
        raise AssertionError(f"rtrain: the mLSTM Function's forward is not "
                             f"the op's ({same}, {MK.KERNEL_LAUNCHES})")
    fb["mlstm"] = fwd_bwd_ms(torch, fn, ops_in, flush)
    del ops_in
    gerr = trainable_grad_diff(torch, lambda *t: mops.mlstm_trainable(
        *t, chunk=RTRAIN_MLSTM_GRAD[4]), mlstm_op_inputs(
            torch, RTRAIN_MLSTM_GRAD, "float32", "cpu"))
    log(f"rtrain {RTRAIN_MLSTM}: kernel_ms {ms:.4f}  plain_ms "
        f"{plain_ms:.4f}  bound_ms {bound_ms:.5f} ({bound_by}); the "
        f"Function bf16 forward {fb['mlstm'][0]:.4f} ms, forward + "
        f"recompute backward {fb['mlstm'][1]:.4f} ms; fp32 gradient card "
        f"vs cpu at {RTRAIN_MLSTM_GRAD[:5]}: {gerr:.3e} x max (bound "
        f"{RTRAIN_GRAD_RTOL:g})")
    if not gerr <= RTRAIN_GRAD_RTOL:
        raise AssertionError("rtrain: mLSTM gradients differ card vs CPU")
    # the D 64 flash forward at zamba2's training attention
    case = RTRAIN_FLASH_CASE
    fargs, fkw, (q, k, v) = flash_inputs(torch, case)
    o, lse = FK.flash_attention_fwd(*fargs, **fkw)
    want_o, want_lse = FK.flash_attention_fwd_plain(*fargs, **fkw)
    torch.cuda.synchronize()
    err = float((o.float() - want_o.float()).abs().max())
    err_lse = float((lse - want_lse).abs().max())
    log(f"rtrain check {RTRAIN_FLASH} bf16 {case[:6]}: max_abs_err o "
        f"{err:.3e} lse {err_lse:.3e} (atol 2e-2 / 1e-4)")
    if not (err <= ATOL["bfloat16"] and err_lse <= 1e-4):
        raise AssertionError("rtrain: the flash kernel disagrees with its "
                             "plain version at zamba2's training shape")
    errs[RTRAIN_FLASH] = err
    del o, lse, want_o, want_lse
    qt, kt, vt = (x.transpose(1, 2).contiguous().to(DEVICE)
                  for x in (q, k, v))
    ms = time_ms(torch, lambda: FK.flash_attention_fwd(*fargs, **fkw), iters,
                 flush)
    plain_ms = time_ms(torch, lambda: FK.flash_attention_fwd_plain(
        *fargs, **fkw), 2, flush)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters, flush)
    bound_ms, bound_by = flash_bound(case)
    rows[RTRAIN_FLASH] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    log(f"time  {RTRAIN_FLASH} bf16 B {case[0]} S {case[1]} H {case[3]} "
        f"kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
        f"{lib_ms:.4f} (SDPA)  bound_ms {bound_ms:.5f} ({bound_by})")
    return errs, rows


def span_wrappers(torch, spans):
    """(call, backward): `call(name, fn)` is fn with each call timed by
    two CUDA events on the current stream, appended to spans[name];
    `backward(name, fn)` is fn (a layer of one tensor) with its backward
    timed so: an identity Function on its output records the first event
    when the output's gradient arrives, one on its input the second when
    the input's gradient is done."""
    class Mark(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, event):
            ctx.event = event
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            ctx.event.record()
            return g, None

    def pair(name):
        ev = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
        spans.setdefault(name, []).append(ev)
        return ev

    def call(name, fn):
        def timed(*a, **kw):
            start, end = pair(name)
            start.record()
            out = fn(*a, **kw)
            end.record()
            return out
        return timed

    def backward(name, fn):
        def marked(u):
            start, end = pair(name)
            return Mark.apply(fn(Mark.apply(u, end)), start)
        return marked
    return call, backward


def rtrain_parts(torch, model, state, batch, step_ms):
    """Where a phase 24 step goes: one step profiled (the device activity
    alone: wall, its kernels' sum, the idle share against the profiled
    wall and against `step_ms`, the timed steps' mean), then one more
    step with its parts timed by CUDA events on the stream
    (`span_wrappers`): the step itself; AdamW; each scan's forward op
    (the kernel and its host layer: the gates' cumsum, the copies; in its
    layer's forward and in the remat recompute) and its recompute
    backward; for zamba2 the flash backward of each shared-block use, for
    xlstm each sLSTM block's forward and backward.  A span is the time on
    the stream between its two events, the device's idle gaps inside it
    included (the sLSTM's per-token loop is host-bound); the rest of the
    step is by difference."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2 import ops as m2ops
    from repro_torch.kernels.mlstm import ops as mlops
    from repro_torch.training import trainer

    cfg = model.cfg
    hybrid = cfg.family == "hybrid"
    tag = "htrain" if hybrid else "xtrain"
    t0 = time.perf_counter()
    _, wall, busy = profile_step(torch, lambda: trainer.train_step(
        model, state, batch, **TRAIN_KW), f"{tag} step", top=12)
    log(f"{tag} profiled step with its processing "
        f"{time.perf_counter() - t0:.1f}s; idle share against the "
        f"unprofiled step ({step_ms:.1f} ms): "
        f"{max(0.0, 1 - busy / step_ms):.3f}")
    spans = {}
    call, backward = span_wrappers(torch, spans)
    if hybrid:
        scan, ops, fwd = "SSD", m2ops, "mamba2_ssd"
        patches = [(fops, "flash_backward", "flash backward")]
    else:
        scan, ops, fwd = "mLSTM", mlops, "mlstm_chunked"
        patches = []
        for blk in model.slstm:
            blk.forward_train = backward("sLSTM backward", call(
                "sLSTM forward", blk.forward_train))
    patches += [(trainer, "adamw_update", "AdamW"),
                (ops, fwd, f"{scan} forward op ({fwd})"),
                (ops, "recompute_grads", f"{scan} recompute backward")]
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _ in patches]
    for owner, attr, name in patches:
        setattr(owner, attr, call(name, getattr(owner, attr)))
    try:
        torch.cuda.synchronize()
        call("step", trainer.train_step)(model, state, batch, **TRAIN_KW)
        torch.cuda.synchronize()
    finally:
        for owner, attr, f in saved:
            setattr(owner, attr, f)
        for blk in ([] if hybrid else model.slstm):
            del blk.forward_train
    parts = {name: (len(evs), sum(a.elapsed_time(b) for a, b in evs))
             for name, evs in spans.items()}
    span_ms = parts.pop("step")[1]
    rest = span_ms - sum(ms for _, ms in parts.values())
    log(f"{tag} step timed by its parts (CUDA events, bf16): "
        f"{span_ms:.1f} ms; " + "; ".join(
            f"{name} x{n} {ms:.1f} ms ({ms / span_ms:.3f})"
            for name, (n, ms) in parts.items())
        + f"; the rest, by difference, {rest:.1f} ms "
        f"({rest / span_ms:.3f})")
    return dict(profiled_ms=wall, profiled_kernels_ms=busy,
                idle_share=max(0.0, 1 - busy / step_ms), parts_step_ms=span_ms,
                **{f"{name} ms": ms for name, (_, ms) in parts.items()})


def phase_rtrain_model(torch, arch, batch_size, seq, kernel_modules):
    """24 (c) / (d): full-size `arch` (zamba2-1.2b or xlstm-350m, bf16,
    random weights from SEED) takes 1 + RTRAIN_STEPS AdamW steps at
    batch_size x seq of Markov data (seed 1) through `train_step`.  The
    launch counters are zeroed just before the steps and read just after:
    zamba2 launches `ssd_mma_kernel` twice a Mamba2 layer a step (the
    forward and its remat recompute) and `flash_mma_kernel` once a use of
    the shared block (not rematerialised); xlstm `mlstm_mma_kernel`
    twice an mLSTM layer a step; no other kernel (paged, MoE, latent
    decode, the fp32 scalar ones) and no plain version.  Every loss
    finite, step 0's ce within 1.0 of ln V, every matrix of the first
    recurrent block changed.  Step ms, tokens/s, peak memory against the
    standing state, and the step's parts (`rtrain_parts`) logged.
    Returns (the launches by kernel, numbers)."""
    import gc

    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.models.model import hybrid_layout, xlstm_layout
    from repro_torch.models.ssm_blocks import prefill_chunk
    from repro_torch.training.trainer import make_train_state, train_step

    K, FK, SK, MK, GK, AK = kernel_modules
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ARCHS[arch]
    tag = "htrain" if cfg.family == "hybrid" else "xtrain"
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    state = make_train_state(model)
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    standing = sum(2 * p.numel() * p.element_size() + 8 * p.numel()
                   for p in params)  # params, grads, fp32 mu and nu
    steps = 1 + RTRAIN_STEPS
    batches = markov_batches(torch, cfg, steps + 1, batch_size, seq, DEVICE)
    torch.cuda.synchronize()
    log(f"{tag} {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.dtype}: {n_params / 1e9:.3f} G parameters; params + grads + "
        f"fp32 moments {standing / 2**30:.2f} GiB; batch {batch_size} x seq "
        f"{seq}; set-up {time.perf_counter() - t0:.1f}s")
    ssm = cfg.ssm
    if cfg.family == "hybrid":
        n_mamba, n_attn, _ = hybrid_layout(cfg)
        want = {"ssd_mma_kernel": 2 * n_mamba * steps,
                "flash_mma_kernel": n_attn * steps}
        first = model.mamba[0]
        shape = (batch_size, seq, ssm.num_heads, ssm.head_dim,
                 ssm.state_dim, ssm.num_groups, prefill_chunk(cfg, seq))
        attn = (batch_size, seq, seq, cfg.num_q_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim)
        if shape != RTRAIN_SSD_CASE or attn != RTRAIN_FLASH_CASE[:6]:
            raise AssertionError(f"{tag}: 24 (a)'s shapes are not the "
                                 f"step's: {shape} {attn}")
    else:
        n_m, _, _ = xlstm_layout(cfg)
        want = {"mlstm_mma_kernel": 2 * n_m * steps}
        first = model.mlstm[0]
        shape = (batch_size, seq, ssm.num_heads, ssm.head_dim,
                 prefill_chunk(cfg, seq))
        if shape != RTRAIN_MLSTM_CASE[:5]:
            raise AssertionError(f"{tag}: 24 (b)'s shape is not the "
                                 f"step's: {shape}")
    before = [p.detach().clone() for p in first.parameters()]
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_modules:
        mod.reset_launches()
    losses, ces, gnorms, times = [], [], [], []
    with counted_plain((FK, "flash_attention_fwd_plain"),
                       (SK, "ssd_chunked_fwd_plain"),
                       (MK, "mlstm_chunked_fwd_plain"),
                       (GK, "grouped_gemm_plain"),
                       (AK, "mla_decode_plain")) as plain_calls:
        for i, batch in enumerate(batches[:steps]):
            t0 = time.perf_counter()
            state, met = train_step(model, state, batch, **TRAIN_KW)
            losses.append(float(met["loss"]))
            ces.append(float(met["ce"]))
            gnorms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            log(f"{tag} step {i}{' (warm-up)' if i == 0 else ''}: loss "
                f"{losses[-1]:.4f} grad_norm {gnorms[-1]:.4f} lr "
                f"{float(met['lr']):.2e} {times[-1] * 1e3:.1f} ms")
    launches = {**FK.KERNEL_LAUNCHES, **SK.KERNEL_LAUNCHES,
                **MK.KERNEL_LAUNCHES}
    others = {**K.LAUNCHES, **GK.LAUNCHES, **AK.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    timed = times[1:]
    step_ms = 1e3 * sum(timed) / len(timed)
    tok_s = batch_size * seq * len(timed) / sum(timed)
    log(f"{tag} {len(timed)} timed steps: mean_step_ms {step_ms:.1f}  "
        f"tokens_per_s {tok_s:.1f}  max_memory_allocated_gib "
        f"{peak / 2**30:.2f} (standing state {standing / 2**30:.2f} GiB)  "
        f"kernel launches {launches}  other kernels {others}  plain calls "
        f"{plain_calls}")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{tag}: non-finite loss or grad norm: "
                             f"{losses} {gnorms}")
    if abs(ces[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"{tag}: step 0 ce {ces[0]} is not within 1.0 "
                             f"of ln V = {math.log(cfg.vocab_size):.2f}")
    expected = {k: want.get(k, 0) for k in launches}
    if launches != expected:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{expected}")
    if any(others.values()) or any(plain_calls.values()):
        raise AssertionError(f"{tag}: serving kernels or plain versions "
                             f"ran: {others} {plain_calls}")
    stuck = [n for (n, p), b in zip(first.named_parameters(), before)
             if p.ndim == 2 and torch.equal(p.detach(), b)]
    if stuck:
        raise AssertionError(f"{tag}: parameters did not change: {stuck}")
    del before
    numbers = rtrain_parts(torch, model, state, batches[steps], step_ms)
    del model, state, batches, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(step_ms=step_ms, tokens_per_s=tok_s,
                          peak_gib=peak / 2**30,
                          standing_gib=standing / 2**30, **numbers)


def phase_rtrain_diff(torch):
    """24 (e): reduced zamba2-1.2b and xlstm-350m in fp32 (TF32 off; the
    scalar SSD, mLSTM and flash kernels), RDIFF_STEPS train steps at
    RDIFF_BATCH x RDIFF_SEQ on the card and on the CPU from the same
    weights (one seed, the CPU generator) and batches: losses within
    TDIFF_LOSS_RTOL relative, grad norms within TDIFF_GNORM_RTOL."""
    from repro_torch import weights
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.training.trainer import make_train_state, train_step

    for arch in (HYBRID_ARCH, XLSTM_ARCH):
        cfg = reduced(ARCHS[arch])
        runs = []
        for dev in (DEVICE, "cpu"):
            model = weights.init_random(cfg, SEED, device=dev)
            state = make_train_state(model)
            out = []
            for batch in markov_batches(torch, cfg, RDIFF_STEPS, RDIFF_BATCH,
                                        RDIFF_SEQ, dev):
                state, m = train_step(model, state, batch, **TRAIN_KW)
                out.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append(out)
            del model, state
        worst_l = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(*runs))
        worst_g = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(*runs))
        log(f"rtrain diff {arch} reduced {cfg.dtype} {RDIFF_STEPS} steps "
            f"batch {RDIFF_BATCH} x seq {RDIFF_SEQ}: card {runs[0]} cpu "
            f"{runs[1]}; loss rel {worst_l:.3e} (bound {TDIFF_LOSS_RTOL:g}), "
            f"grad_norm rel {worst_g:.3e} (bound {TDIFF_GNORM_RTOL:g})")
        if not (worst_l <= TDIFF_LOSS_RTOL and worst_g <= TDIFF_GNORM_RTOL):
            raise AssertionError(f"rtrain diff: {arch} trains differently on "
                                 f"the card and on the CPU")



# ---------------------------------------------------------------------------
# the audio and vlm families (musicgen-large, qwen2-vl-2b)
# ---------------------------------------------------------------------------


def patch_grid_positions(torch, b, s, g):
    """[3, B, S] int32 Qwen2-VL positions drawn from `g`: each row a few
    text tokens (t = h = w = index), one image of hh x ww patches (t the
    image's start for all of them, h / w the start plus the patch's row /
    column), then text again from the start plus max(hh, ww)."""
    pos = torch.zeros((3, b, s), dtype=torch.int32)
    for i in range(b):
        side = max(3, int((s // 2) ** 0.5))  # an image <= half the row
        pre = int(torch.randint(1, max(2, s // 32), (1,), generator=g))
        hh, ww = (int(x) for x in torch.randint(2, side + 1, (2,),
                                                generator=g))
        pos[:, i, :pre] = torch.arange(pre, dtype=torch.int32)
        j = torch.arange(hh * ww, dtype=torch.int32)
        end = pre + hh * ww
        pos[0, i, pre:end] = pre
        pos[1, i, pre:end] = pre + j // ww
        pos[2, i, pre:end] = pre + j % ww
        pos[:, i, end:] = pre + max(hh, ww) + torch.arange(
            s - end, dtype=torch.int32)
    return pos


def family_batch(torch, cfg, b, s, device, seed):
    """A training batch of `cfg`'s stub frontend: [B, S, d] embeddings
    (standard normal, drawn from `seed`, in the parameter dtype), labels
    from the Markov stream, and for "mrope" patch-grid positions."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    batch = markov_batches(torch, cfg, 1, b, s, device)[0]
    batch["inputs"] = torch.randn((b, s, cfg.d_model), generator=g).to(
        device=device, dtype=cfg.param_dtype)
    if cfg.rope_style == "mrope":
        batch["positions"] = patch_grid_positions(torch, b, s, g).to(device)
    return batch


def decode_graph_bound(eng):
    """(bound ms, weight bytes, KV bytes) of the packed step's decode-only
    graph on its last inputs: every matrix but the embedding table read
    once (the head included) and the live rows' K / V at their contexts
    (the graph's static host buffer keeps the last upload), at 3.35 TB/s."""
    keys = [k for k in eng.compile_events
            if k[0] == "unified" and k[2] == eng.max_seqs]
    ctx = eng._compiled[keys[-1]].inputs.host["context_lens"]
    live = int(ctx[:eng.max_seqs].sum())
    cfg = eng.cfg
    weights = sum(p.numel() * p.element_size()
                  for n, p in eng.model.named_parameters()
                  if n != "embed")
    kv = (live * cfg.num_layers * 2 * cfg.num_kv_heads
          * cfg.resolved_head_dim * cfg.param_dtype.itemsize)
    return (weights + kv) / HBM_BYTES_PER_S * 1e3, weights, kv


def phase_family_serve(torch, arch, kernel_modules):
    """25 (a): full-size `arch` (bf16, random weights from SEED) serves
    phase 5's 8 requests (128-1024 tokens, 32 new, max_seqs 8, chunked at
    512, request 3 sampled) through the packed fused step, graphs then
    eager: identical tokens, counters, compile_events and logits
    (`graphs_vs_eager`); every paged kernel launched, each C3 decode on
    the folded kernel, no training, MoE or latent kernel; the attention
    configs' variants and Q-Block are those phase 3 checked (gqa and
    segmented, block_q 16; the segment count is a launch argument).
    The decode graph's replay against its byte bound.  Returns (the
    model, the graphed run's launches by Pallas function, numbers)."""
    from repro_torch import weights
    from repro_torch.configs import ARCHS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request, State

    K, FK, SK, MK, GK, AK = kernel_modules
    cfg = ARCHS[arch]
    t0 = time.perf_counter()
    model = weights.init_random(cfg, SEED, device=DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    kv_tok = cfg.num_layers * 2 * hkv * dh * cfg.param_dtype.itemsize
    log(f"fserve {arch}: {cfg.num_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.num_q_heads}/{hkv} D {dh} vocab {cfg.vocab_size} rope "
        f"{cfg.rope_style} {cfg.dtype}: {n_params / 1e9:.3f} G parameters, "
        f"weights in {time.perf_counter() - t0:.1f}s; KV {kv_tok} B a token, "
        f"the pool {FAMILY_PAGES} pages x {cfg.page_size} = "
        f"{FAMILY_PAGES * cfg.page_size} tokens, "
        f"{FAMILY_PAGES * cfg.page_size * kv_tok / 1e9:.2f} GB")
    eng_kw = dict(max_seqs=8, num_pages=FAMILY_PAGES, max_model_len=2048,
                  enable_chunked_prefill=True, max_prefill_tokens=512,
                  seed=SEED, debug_logits=True, device=DEVICE)
    served = serve_prompts(torch, cfg.vocab_size)[2]

    def requests():
        return [Request(prompt=list(p), max_new_tokens=32,
                        **(SERVE_SAMPLED if i == 3 else {}))
                for i, p in enumerate(served)]

    with counted_plain((K, "paged_decode_plain"),
                       (K, "paged_decode_segmented_merged_plain"),
                       (K, "paged_prefill_qblock_plain")) as plain_calls:
        run = serve_run(torch, Engine(cfg, model, **eng_kw), requests(),
                        f"fserve {arch}")
    eng, reqs = run["eng"], run["reqs"]
    launches = dict(K.LAUNCHES)
    others = {**FK.LAUNCHES, **SK.LAUNCHES, **MK.LAUNCHES, **GK.LAUNCHES,
              **AK.LAUNCHES}
    if not all(r.state is State.FINISHED and len(r.output) == 32
               for r in reqs):
        raise AssertionError(f"fserve {arch}: not every request finished")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"fserve {arch}: a paged kernel was never "
                             f"launched: {launches}")
    if any(others.values()) or any(plain_calls.values()):
        raise AssertionError(f"fserve {arch}: other kernels or plain "
                             f"versions ran: {others} {plain_calls}")
    check_paged_routes(K, launches, f"fserve {arch}", cfg.dtype)
    cfgs = {(k.variant, k.block_q,
             k.num_segments if k.variant == "segmented" else None)
            for _, _, _, k in eng.compile_events}
    log(f"fserve {arch} kernel configs {sorted(cfgs, key=str)}")
    if {v for v, _, _ in cfgs} - {"gqa", "segmented"} \
            or {bq for _, bq, _ in cfgs} != {PAGED_BLOCK_Q}:
        raise AssertionError(f"fserve {arch}: configs phase 3 did not "
                             f"check: {cfgs}")
    toks = sum(len(r.output) for r in reqs)
    prompt_toks = sum(r.num_prompt_tokens for r in reqs)
    wall = run["wall"]
    log(f"fserve {arch} steps {len(run['stats'])}  prompt_tokens "
        f"{prompt_toks}  new_tokens {toks}  wall_s {wall:.3f}  "
        f"new_tok_per_s {toks / wall:.1f}  dispatch "
        f"{dict(eng.dispatch_counts)}  launches {launches}  "
        f"launched_token_slots {eng.launched_token_slots}")
    cost = replay_cost(torch, eng, top=6)
    bound_ms, wbytes, kvbytes = decode_graph_bound(eng)
    log(f"fserve {arch} decode graph: replay {cost['decode_replay_ms']:.4f} "
        f"ms against its byte bound {bound_ms:.4f} ms (weights "
        f"{wbytes / 1e9:.3f} GB + the live rows' KV {kvbytes / 1e9:.3f} GB at"
        f" 3.35 TB/s): {cost['decode_replay_ms'] / bound_ms:.2f}x")
    del eng
    eager = serve_run(torch, Engine(cfg, model, cuda_graphs=False, **eng_kw),
                      requests(), f"fserve {arch} eager")
    walls = graphs_vs_eager(torch, f"fserve {arch}", run, eager, cfg.dtype)
    del run, eager
    return model, launches, dict(
        wall_s=wall, new_tokens=toks, prompt_tokens=prompt_toks,
        decode_bound_ms=bound_ms, **cost, **walls)


def phase_family_flash(torch, FK, cfg, iters=10):
    """25 (b)'s flash forward at `cfg`'s training attention (B 4, S 2048,
    causal, bf16) against its plain version (2e-2 on o, 1e-4 on the lse)
    and timed beside its plain version, SDPA and its bound.  Returns
    (the max abs error, the row's numbers)."""
    F = torch.nn.functional
    case = (FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_SEQ,
            cfg.num_q_heads, cfg.num_kv_heads, cfg.resolved_head_dim, True,
            0, "bfloat16")
    args, kw, (q, k, v) = flash_inputs(torch, case)
    o, lse = FK.flash_attention_fwd(*args, **kw)
    want_o, want_lse = FK.flash_attention_fwd_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((o.float() - want_o.float()).abs().max())
    err_lse = float((lse - want_lse).abs().max())
    log(f"ftrain check flash {cfg.name} bf16 {case[:6]} block_q "
        f"{kw['block_q']} x group {kw['group']}: max_abs_err o {err:.3e} "
        f"lse {err_lse:.3e} (atol 2e-2 / 1e-4)")
    if not (err <= ATOL["bfloat16"] and err_lse <= 1e-4):
        raise AssertionError(f"ftrain: the flash kernel disagrees with its "
                             f"plain version at {cfg.name}'s training shape")
    del o, lse, want_o, want_lse
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    qt, kt, vt = (x.transpose(1, 2).contiguous().to(DEVICE)
                  for x in (q, k, v))
    ms = time_ms(torch, lambda: FK.flash_attention_fwd(*args, **kw), iters,
                 flush)
    plain_ms = time_ms(torch, lambda: FK.flash_attention_fwd_plain(
        *args, **kw), 2, flush)
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters, flush)
    bound_ms, bound_by = flash_bound(case)
    log(f"time  flash {cfg.name} bf16 B {case[0]} S {case[1]} Hq {case[3]} "
        f"Hkv {case[4]} D {case[5]} kernel_ms {ms:.4f}  plain_ms "
        f"{plain_ms:.4f}  library_ms {lib_ms:.4f} (SDPA)  bound_ms "
        f"{bound_ms:.5f} ({bound_by})")
    return err, dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=bound_ms, bound_by=bound_by)


def phase_family_train(torch, arch, model, kernel_modules):
    """25 (b): the served full-size `arch` trained through `train_step`,
    1 + FAMILY_TRAIN_STEPS AdamW steps at 4 x 2048 of [B, S, d] bf16
    embeddings (the stub frontend's, seeded), Markov labels and, for
    qwen2-vl, patch-grid [3, B, S] positions.  The launch counters are
    zeroed just before and read just after: `flash_mma_kernel` twice a
    layer a step (the forward and its remat recompute), no other kernel,
    no plain version.  Every loss finite, step 0's ce within 1.0 of ln V,
    every matrix of block 0 changed.  Step ms, tokens/s, peak memory
    (halving B above FAMILY_PEAK_GIB), one profiled step's idle share.
    Returns (the flash launches, numbers)."""
    import gc

    from repro_torch.training.trainer import make_train_state, train_step

    K, FK, SK, MK, GK, AK = kernel_modules
    cfg = model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    state = make_train_state(model)
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    standing = sum(2 * p.numel() * p.element_size() + 8 * p.numel()
                   for p in params)
    b, s = FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ
    steps = 1 + FAMILY_TRAIN_STEPS
    first = model.blocks[0]
    before = [p.detach().clone() for p in first.parameters()]
    torch.cuda.reset_peak_memory_stats()
    for mod in kernel_modules:
        mod.reset_launches()
    losses, ces, gnorms, times = [], [], [], []
    with counted_plain((FK, "flash_attention_fwd_plain"),
                       (K, "paged_prefill_qblock_plain"),
                       (GK, "grouped_gemm_plain")) as plain_calls:
        for i in range(steps):
            batch = family_batch(torch, cfg, b, s, DEVICE, SEED + 10 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = train_step(model, state, batch, **TRAIN_KW)
            losses.append(float(met["loss"]))
            ces.append(float(met["ce"]))
            gnorms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            log(f"ftrain {arch} step {i}{' (warm-up)' if i == 0 else ''}: "
                f"loss {losses[-1]:.4f} grad_norm {gnorms[-1]:.4f} "
                f"{times[-1] * 1e3:.1f} ms")
    launches = dict(FK.KERNEL_LAUNCHES)
    others = {**K.LAUNCHES, **SK.LAUNCHES, **MK.LAUNCHES, **GK.LAUNCHES,
              **AK.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    timed = times[1:]
    step_ms = 1e3 * sum(timed) / len(timed)
    tok_s = b * s * len(timed) / sum(timed)
    flops = 8 * n_params * b * s  # 2 forward + 4 backward + 2 remat
    log(f"ftrain {arch}: {n_params / 1e9:.3f} G parameters, batch {b} x "
        f"seq {s}: mean_step_ms {step_ms:.1f}  tokens_per_s {tok_s:.1f}  "
        f"max_memory_allocated_gib {peak / 2**30:.2f} (standing state "
        f"{standing / 2**30:.2f} GiB)  8 N T = {flops:.3e} FLOP a step, "
        f"{flops / PEAK_FLOPS['bfloat16'] * 1e3:.1f} ms at 989 TFLOP/s "
        f"({flops / PEAK_FLOPS['bfloat16'] * 1e3 / step_ms:.3f} of the "
        f"step)  kernel launches {launches}  plain calls {plain_calls}")
    if peak / 2**30 > FAMILY_PEAK_GIB:
        raise AssertionError(f"ftrain {arch}: peak {peak / 2**30:.1f} GiB "
                             f"over {FAMILY_PEAK_GIB}: halve the batch")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"ftrain {arch}: non-finite loss or grad norm:"
                             f" {losses} {gnorms}")
    if abs(ces[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"ftrain {arch}: step 0 ce {ces[0]} is not "
                             f"within 1.0 of ln V")
    want = {k: 0 for k in launches}
    want["flash_mma_kernel"] = 2 * cfg.num_layers * steps
    if launches != want or any(others.values()) \
            or any(plain_calls.values()):
        raise AssertionError(f"ftrain {arch}: launches {launches} (want "
                             f"{want}), others {others}, plain "
                             f"{plain_calls}")
    stuck = [n for (n, p), b0 in zip(first.named_parameters(), before)
             if p.ndim == 2 and torch.equal(p.detach(), b0)]
    if stuck:
        raise AssertionError(f"ftrain {arch}: parameters did not change: "
                             f"{stuck}")
    del before
    batch = family_batch(torch, cfg, b, s, DEVICE, SEED + 20)
    _, wall, busy = profile_step(
        torch, lambda: train_step(model, state, batch, **TRAIN_KW),
        f"ftrain {arch} step", top=8)
    del state, batch, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_mma_kernel"], dict(
        step_ms=step_ms, tokens_per_s=tok_s, peak_gib=peak / 2**30,
        standing_gib=standing / 2**30, profiled_ms=wall,
        profiled_kernels_ms=busy, idle_share=max(0.0, 1 - busy / wall))


def family_train_losses(torch, models, cfg, seed):
    """One `train_step` of each of `models` ({tag: model}, each on its
    own device) on the same [2, 256] batch of `cfg`'s frontend: {tag:
    (loss, grad norm)}."""
    from repro_torch.training.trainer import make_train_state, train_step

    out = {}
    for tag, model in models.items():
        dev = next(model.parameters()).device
        batch = family_batch(torch, cfg, *FAMILY_DIFF_TRAIN, dev, seed)
        _, m = train_step(model, make_train_state(model), batch, **TRAIN_KW)
        out[tag] = (float(m["loss"]), float(m["grad_norm"]))
        model.requires_grad_(False)
    return out


def fused_copy(torch, model, cfg):
    """A `fused_qkv` + `fused_mlp` model of `cfg`'s shapes on `model`'s
    device holding `model`'s weights: wqkv = [wq | wk | wv] (their biases
    likewise), gate_up = [gate | up]."""
    from repro_torch.models.model import Model

    fcfg = cfg.replace(fused_qkv=True, fused_mlp=True)
    dev = next(model.parameters()).device
    fused = Model(fcfg, device=dev)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for name, p in fused.named_parameters():
            if ".wqkv." in name:
                parts = [src[name.replace("wqkv", w)] for w in ("wq", "wk",
                                                                 "wv")]
            elif ".gate_up." in name:
                parts = [src[name.replace("gate_up", w)]
                         for w in ("gate", "up")]
            else:
                parts = [src[name]]
            p.copy_(torch.cat(parts, dim=-1))
    return fused


def phase_family_diff(torch, arch, seed):
    """25 (c): `arch` at full width cut to FAMILY_DIFF_LAYERS layers, fp32
    (TF32 off), card against CPU: 3 greedy requests of 8 tokens in
    lockstep (identical tokens, logits within 5e-3, `lockstep_diff`),
    then one train step of the same models: the loss within 1e-4 relative, the grad
    norm within 1e-3.  (d) for qwen2-vl: the cut again on the card with
    `fused_qkv` and `fused_mlp` holding the same weights concatenated,
    against the unfused model: the same greedy tokens, logits within
    FUSED_LOGIT_ATOL, one train step's loss within FUSED_LOSS_RTOL."""
    from repro_torch import weights
    from repro_torch.configs import ARCHS

    cfg = ARCHS[arch].replace(dtype="float32", num_layers=FAMILY_DIFF_LAYERS)
    models = {dev: weights.init_random(cfg, SEED, device=dev)
              for dev in (DEVICE, "cpu")}
    g = torch.Generator(device="cpu").manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (37, 70, 101)]
    worst = lockstep_diff(torch, f"fdiff {arch}", cfg, models, prompts, 8,
                          dict(max_seqs=4, num_pages=64, max_model_len=256,
                               seed=SEED, debug_logits=True))[2]
    got = family_train_losses(torch, models, cfg, seed)
    (lc, gc_), (l0, g0) = got[DEVICE], got["cpu"]
    rel_l, rel_g = abs(lc - l0) / abs(l0), abs(gc_ - g0) / abs(g0)
    log(f"fdiff {arch} train step fp32 {FAMILY_DIFF_TRAIN}: card {got[DEVICE]}"
        f" cpu {got['cpu']}: loss rel {rel_l:.3e} (bound "
        f"{TDIFF_LOSS_RTOL:g}), grad_norm rel {rel_g:.3e} (bound "
        f"{TDIFF_GNORM_RTOL:g})")
    if not (rel_l <= TDIFF_LOSS_RTOL and rel_g <= TDIFF_GNORM_RTOL):
        raise AssertionError(f"fdiff {arch}: training differs card vs CPU")
    if cfg.rope_style != "mrope":
        return dict(serve_logit_diff=worst, train_loss_rel=rel_l)
    # (d) fused against unfused, both on the card, holding the weights of
    # the card's model after its step
    base = models.pop(DEVICE)
    del models
    pair = {"unfused": base, "fused": fused_copy(torch, base, cfg)}
    fworst = fused_lockstep(torch, cfg, pair, prompts)
    got = family_train_losses(torch, pair, cfg, seed + 1)
    rel_f = abs(got["fused"][0] - got["unfused"][0]) / abs(got["unfused"][0])
    log(f"fused {arch} train step fp32: fused {got['fused']} unfused "
        f"{got['unfused']}: loss rel {rel_f:.3e} (bound "
        f"{FUSED_LOSS_RTOL:g})")
    if not rel_f <= FUSED_LOSS_RTOL:
        raise AssertionError(f"fused {arch}: the fused layouts train "
                             f"differently")
    return dict(serve_logit_diff=worst, train_loss_rel=rel_l,
                fused_logit_diff=fworst, fused_loss_rel=rel_f)


def fused_lockstep(torch, cfg, pair, prompts):
    """The same greedy requests through the packed step of both models of
    `pair` on the card, stepped in lockstep: identical tokens, logits
    within FUSED_LOGIT_ATOL.  Returns the worst logit difference."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    engines, reqs = [], []
    for model in pair.values():
        eng = Engine(cfg, model, max_seqs=4, num_pages=64, max_model_len=256,
                     seed=SEED, debug_logits=True, device=DEVICE)
        rs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
        for r in rs:
            eng.add_request(r)
        engines.append(eng)
        reqs.append(rs)
    worst = 0.0
    while engines[0].sched.has_work:
        for e in engines:
            e.step()
        a, b = (e.last_step_logits for e in engines)
        worst = max(worst, float((a - b).abs().max()))
    same = [r.output for r in reqs[0]] == [r.output for r in reqs[1]]
    log(f"fused {cfg.name} {cfg.num_layers} layers fp32 on the card: "
        f"tokens_identical {same}  max_abs_logit_diff {worst:.3e} (bound "
        f"{FUSED_LOGIT_ATOL:g})")
    if not same or engines[1].sched.has_work or not worst <= FUSED_LOGIT_ATOL:
        raise AssertionError("fused: the fused layouts serve differently")
    return worst


def phase_families(torch, kernel_modules):
    """25: each of musicgen-large and qwen2-vl-2b at full size served
    (a) and trained (b), the flash forward at its training shape checked
    and timed, then (c) / (d) its fp32 cut card vs CPU (and fused vs
    unfused).  Returns {arch: (serve launches, flash launches, flash
    error, flash row, numbers)}."""
    import gc

    FK = kernel_modules[1]
    out = {}
    for i, arch in enumerate(FAMILY_ARCHS):
        t0 = time.perf_counter()
        model, launches, serve = phase_family_serve(torch, arch,
                                                    kernel_modules)
        ferr, frow = phase_family_flash(torch, FK, model.cfg)
        flash, train = phase_family_train(torch, arch, model, kernel_modules)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        diff = phase_family_diff(torch, arch, SEED + 7 + i)
        log(f"families {arch}: {time.perf_counter() - t0:.1f}s")
        out[arch] = (launches, flash, ferr, frow,
                     dict(serve=serve, train=train, diff=diff))
    return out

# ---------------------------------------------------------------------------
# 26. tensor-parallel serving, the expert-parallel MoE and the gradient
# collectives: ranks of one gloo world sharing the card
# ---------------------------------------------------------------------------


def tp_cfg(dtype_name):
    from repro_torch.configs import ARCHS

    return ARCHS[ARCH].replace(dtype=dtype_name)


def tp_leg(torch, dtype_name, tp=1, group=None, timed=None):
    """Full-width smollm-135m in `dtype_name` (random weights from SEED)
    serves phase 5's 8 prompts greedily, eager, at `tp` (over `group`),
    after a throwaway warm-up engine; `serve_run`'s result.  `timed`:
    called after the warm-up, it returns an undo called after the run."""
    from repro_torch import weights
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import Request

    cfg = tp_cfg(dtype_name)
    _, warm_prompts, served = serve_prompts(torch, cfg.vocab_size)
    kw = dict(TP_ENGINE, tp=tp, tp_group=group)
    model = weights.init_random(cfg, SEED, device=DEVICE)
    warm = Engine(cfg, model, **kw)  # cuts the model to the rank's heads
    warm.generate([Request(prompt=p, max_new_tokens=4)
                   for p in warm_prompts])
    del warm
    eng = Engine(cfg, model, **kw)
    torch.cuda.synchronize()
    undo = timed() if timed else None
    try:
        return serve_run(torch, eng, [Request(prompt=list(p),
                                              max_new_tokens=TP_NEW_TOKENS)
                                      for p in served],
                         f"tp {tp} {dtype_name}")
    finally:
        if undo:
            undo()


def logits_digest(torch, logits):
    """One sha256 over every step's logits bytes: equal digests, equal
    bits."""
    import hashlib

    uint8 = torch.uint8
    h = hashlib.sha256()
    for x in logits:
        h.update(x.detach().contiguous().cpu().view(-1).view(uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def ep_experts(torch, e_range, d, ff, dtype):
    """w_gate, w_up [n, d, ff] and w_down [n, ff, d] of experts `e_range`,
    each expert drawn on the card from a generator seeded by its id (so a
    rank draws its own experts, and one device all of them, alike), at the
    reference's init scale."""
    outs = ([], [], [])
    for e in e_range:
        g = torch.Generator(device=DEVICE).manual_seed(EP_SEED * 1000 + e)
        for out, shape, fan in zip(outs, ((d, ff), (d, ff), (ff, d)),
                                   (d, d, ff)):
            out.append((torch.randn(shape, generator=g, device=DEVICE)
                        * fan ** -0.5).to(dtype))
    return [torch.stack(o) for o in outs]


def ep_cfg(cut):
    """deepseek-v2's MoE layer at full width (bf16), or the fp32 cut."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = ARCHS[EP_ARCH]
    if not cut:
        return cfg.replace(dtype="bfloat16")
    return cfg.replace(dtype="float32", d_model=EP_FP32_CUT["d_model"],
                       moe=dataclasses.replace(cfg.moe,
                                               **EP_FP32_CUT["moe"]))


def ep_layer(torch, cfg, experts):
    """deepseek-v2's MoE layer holding `experts` (an id range; None: the
    router alone, for its routing), its router and shared experts drawn
    on the card from EP_SEED."""
    from torch import nn

    from repro_torch.models.moe import MoE

    m, d = cfg.moe, cfg.d_model
    moe = MoE(cfg, device="meta")
    g = torch.Generator(device=DEVICE).manual_seed(EP_SEED)

    def param(shape, fan, dtype):
        return nn.Parameter((torch.randn(shape, generator=g, device=DEVICE)
                             * fan ** -0.5).to(dtype), requires_grad=False)

    moe.router.w = param((d, m.num_experts), d, torch.float32)
    if experts is None:
        return moe
    ffs = m.d_ff_expert * m.num_shared_experts
    moe.shared.gate.w = param((d, ffs), d, cfg.param_dtype)
    moe.shared.up.w = param((d, ffs), d, cfg.param_dtype)
    moe.shared.down.w = param((ffs, d), ffs, cfg.param_dtype)
    for name, w in zip(("w_gate", "w_up", "w_down"),
                       ep_experts(torch, experts, d, m.d_ff_expert,
                                  cfg.param_dtype)):
        setattr(moe, name, nn.Parameter(w, requires_grad=False))
    return moe


def ep_inputs(torch, cfg, rows):
    g = torch.Generator(device="cpu").manual_seed(EP_SEED + rows)
    return torch.randn((rows, cfg.d_model), generator=g).to(
        DEVICE, cfg.param_dtype)


def ep_reference(torch):
    """The one-device dropless MoE (`MoE.forward`, every expert) on each
    case of (d): {(cut, rows): y as fp32 numpy}."""
    import gc

    out = {}
    for cut in (False, True):
        cfg = ep_cfg(cut)
        moe = ep_layer(torch, cfg, range(cfg.moe.num_experts))
        with torch.no_grad():
            for rows in EP_ROWS:
                out[cut, rows] = moe(ep_inputs(torch, cfg, rows))[0] \
                    .float().cpu().numpy()
        del moe
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ep_rank_launch(torch, cfg, rank, n, rows):
    """(xs, offsets, experts, local rows, touched experts) of the grouped
    GEMM launch rank `rank` of `n` makes in `moe_ffn_dropless_ep` on
    `rows` rows of (d): the tail launch, rows routed elsewhere last."""
    moe = ep_layer(torch, cfg, None)
    e_loc = cfg.moe.num_experts // n
    xt = ep_inputs(torch, cfg, rows)
    _, topi = moe.route(xt)
    e_flat = topi.reshape(-1) - rank * e_loc
    local = (e_flat >= 0) & (e_flat < e_loc)
    ids, order = torch.sort(torch.where(local, e_flat, e_loc), stable=True)
    offsets = torch.searchsorted(ids, torch.arange(e_loc + 1,
                                                   device=DEVICE),
                                 out_int32=True)
    xs = xt[order // cfg.moe.top_k]
    bounds = [int(v) for v in offsets.tolist()]
    touched = sum(hi > lo for lo, hi in zip(bounds, bounds[1:]))
    return xs, offsets, e_loc, bounds[-1], touched


def phase_tp_kernels(torch, K, GK, GO, tops, errs, iters=20):
    """26 (a): the paged kernels at smollm's heads over tp 3 (checked
    against their plain versions in phase 3, TP_SHAPES) and the grouped
    GEMM at deepseek-v2's E / 4 = 40 experts a rank (phase 21's routings,
    then the tail launch of rank 0's routing of (d)'s 8 and 520 rows),
    checked here, each timed with
    the enqueue hidden behind a spin, beside its plain version, a library
    yardstick and its bound.  Returns the JSON rows' numbers by name."""
    F = torch.nn.functional
    dtype_name = "bfloat16"
    ps = 16
    tile = tops.default_tile(ps)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    calls, x = kernel_calls(torch, K, torch.bfloat16, ps, tile, tops,
                            TP_SHAPES)
    lib = library_calls(torch, x)
    rows = {}
    for name in ("paged_decode", "paged_decode_segmented", MERGED,
                 "paged_prefill_qblock"):
        kfn, pfn = calls[name]
        ms = time_ms(torch, kfn, iters, flush, lead_cycles=TP_LEAD_CYCLES)
        plain_ms = time_ms(torch, pfn, 3, flush)
        lib_ms = (time_ms(torch, lib[name], iters, flush,
                          lead_cycles=TP_LEAD_CYCLES)
                  if name in lib else None)
        bound_ms, bound_by = bounds(name, x, dtype_name)
        log(f"tp time {name:37s} {TP_SHAPES} bf16 kernel_ms {ms:.4f}  "
            f"plain_ms {plain_ms:.4f}  library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'}  bound_ms "
            f"{bound_ms:.5f} ({bound_by})  of the bound {bound_ms / ms:.3f}")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=errs[f"{name}[{TP_SHAPES}]"])
    # the segment_reduce row is the folded launch that computes it on the
    # serving path
    rows["segment_reduce"] = dict(rows.pop(MERGED),
                                  max_abs_err=errs[f"segment_reduce"
                                                   f"[{TP_SHAPES}]"])
    del calls, x, lib
    cfg = ep_cfg(False)
    e_loc = cfg.moe.num_experts // EP_RANKS
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    ws = ep_experts(torch, range(e_loc), d, ff, torch.bfloat16)
    wg, wu, wd = ws
    # phase 21's routings at a rank's 40 experts, then the tail launches
    # (each element to its own magnitude, `moe_pair_tolerances`: the plain
    # product sums in cuBLAS's order)
    gh = torch.Generator(device="cpu").manual_seed(EP_SEED)
    worst, ep_rows = 0.0, {}
    for n_rows in MOE_ROWS:
        for case in MOE_ROUTINGS:
            if case == "long" and n_rows <= MOE_LONG_GROUP:
                continue
            off = moe_offsets(torch, moe_routing(torch, case, n_rows, e_loc,
                                                 gh), e_loc)
            xs = torch.randn((n_rows, d), generator=gh).to(DEVICE,
                                                           torch.bfloat16)
            err, _ = moe_pair_check(torch, GK, ws, xs, off, None,
                                    f"E {e_loc} d {d} ff {ff} bf16 rows "
                                    f"{n_rows} {case:10s}")
            worst = max(worst, err)
    for n_rows in EP_ROWS:
        xs, off, _, live, touched = ep_rank_launch(torch, cfg, 0, EP_RANKS,
                                                   n_rows)
        err, (h, ys) = moe_pair_check(
            torch, GK, ws, xs, off, None,
            f"E_loc {e_loc} tail, rank 0 of {EP_RANKS}: rows {xs.shape[0]} "
            f"({live} local, {touched} experts touched)", tail=True,
            wrong=True)
        tail_zero = bool((ys[live:] == 0).all()) \
            and bool((h[live:] == 0).all())
        log(f"tp check {MOE} tail rows zero {tail_zero}")
        if not tail_zero:
            raise AssertionError(f"{MOE} tail launch wrote the tail rows")
        worst = max(worst, err)
        bounds_h = [int(v) for v in off.tolist()]
        groups = [(e, lo, hi) for e, (lo, hi) in
                  enumerate(zip(bounds_h, bounds_h[1:])) if hi > lo]

        def kernel():
            return GO.expert_ffn(xs, off, wg, wu, wd, tail=True)

        def plain():
            return GK.grouped_gemm_plain(GK.grouped_gemm_plain(
                xs, wg, off, wu, tail=True), wd, off, tail=True)

        def library():
            outs = []
            for e, lo, hi in groups:
                a = xs[lo:hi]
                hh = F.silu(torch.matmul(a, wg[e])) * torch.matmul(a, wu[e])
                outs.append(torch.matmul(hh, wd[e]))
            return torch.cat(outs)

        ms = time_ms(torch, kernel, iters, flush,
                     lead_cycles=TP_LEAD_CYCLES)
        plain_ms = time_ms(torch, plain, 3, flush)
        lib_ms = time_ms(torch, library, iters, flush,
                         lead_cycles=TP_LEAD_CYCLES)
        bound_ms, bound_by = moe_bound(live, touched, d, ff, dtype_name)
        log(f"tp time {MOE} E_loc {e_loc} rows {xs.shape[0]} ({live} "
            f"local) kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"library_ms {lib_ms:.4f}  bound_ms {bound_ms:.5f} ({bound_by})"
            f"  of the bound {bound_ms / ms:.3f}")
        ep_rows[n_rows] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by)
    rows[EP_ROW] = dict(ep_rows[EP_ROWS[0]], max_abs_err=worst)
    del ws, wg, wu, wd, h, ys
    torch.cuda.empty_cache()
    return rows


def timed_gathers(torch, A, events):
    """Wrap the attention layers' all-gather between two CUDA events on the
    current stream, appended to `events`: gloo's gather makes the stream
    wait for the gathered rows, so each pair spans the stream's wait on
    one gather (read after the run: no synchronisation inside it);
    returns the undo."""
    inner = A.all_gather_heads

    def wrapped(o, shard):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(o, shard)
        b.record()
        events.append((a, b))
        return out

    A.all_gather_heads = wrapped
    return lambda: setattr(A, "all_gather_heads", inner)


def tp_rank(rank, world):
    """One rank of phase 26 (a process of its own, one gloo world of
    EP_RANKS ranks on the one card).  Ranks 0..TP-1: (b) fp32 and (c) bf16
    serving at tp TP, the bf16 run's all-gathers timed; every rank: (d) `moe_ffn_dropless_ep` on its E / n experts and (e) the
    collectives on CUDA tensors.  Returns plain data (numpy, never a
    tensor: a tensor would cross through shared memory)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.kernels.moe import kernel as GK
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.models import attention as A
    from repro_torch.models.moe import moe_ffn_dropless_ep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    group = dist.new_group(list(range(TP)), backend="gloo")
    out = {}
    if rank < TP:
        events = []
        for dtype_name in ("float32", "bfloat16"):
            run = tp_leg(torch, dtype_name, TP, group, timed=(
                lambda: timed_gathers(torch, A, events))
                if dtype_name == "bfloat16" else None)
            leg = dict(tokens=[r.output for r in run["reqs"]],
                       device_calls=dict(run["eng"].device_calls),
                       steps=len(run["stats"]), wall=run["wall"],
                       digest=logits_digest(torch, run["logits"]),
                       launches=dict(K.LAUNCHES),
                       kernels=dict(K.KERNEL_LAUNCHES),
                       pool=run["stats"][-1]["pool"]["num_devices"])
            if rank == 0:  # the others' are checked bit-equal to these
                leg["logits"] = [x.cpu().numpy() for x in run["logits"]]
            out[dtype_name] = leg
        torch.cuda.synchronize()
        out["gathers"] = dict(calls=len(events), s=sum(
            a.elapsed_time(b) for a, b in events) / 1e3, wall=run["wall"],
            steps=len(run["stats"]))
        del run, events
        torch.cuda.empty_cache()
    ep = {}
    for cut in (False, True):
        cfg = ep_cfg(cut)
        e_loc = cfg.moe.num_experts // world
        moe = ep_layer(torch, cfg, range(rank * e_loc, (rank + 1) * e_loc))
        for rows in EP_ROWS:
            xt = ep_inputs(torch, cfg, rows)
            with torch.no_grad():
                moe_ffn_dropless_ep(moe, xt)  # warm
                torch.cuda.synchronize()
                GK.reset_launches()
                t0 = time.perf_counter()
                y, _ = moe_ffn_dropless_ep(moe, xt)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            ep[cut, rows] = dict(y=y.float().cpu().numpy(), s=dt,
                                 launches=dict(GK.KERNEL_LAUNCHES),
                                 experts=moe.w_gate.shape[0])
        del moe
        torch.cuda.empty_cache()
    out["ep"] = ep
    g = torch.arange(32, dtype=torch.float32, device=DEVICE).reshape(4, 8) \
        / 7.3
    mine = g[rank].clone()
    one, _ = collectives.int8_ef_allgather(mine, None,
                                           torch.zeros_like(mine))
    ef, acc = torch.zeros_like(mine), torch.zeros_like(mine,
                                                       dtype=torch.float64)
    for _ in range(COLL_EF_STEPS):
        s, ef = collectives.int8_ef_allgather(mine, None, ef)
        acc += s
    bf16 = collectives.bf16_psum({"g": mine}, None)["g"]
    out["coll"] = dict(exact=g.sum(0).cpu().numpy(), int8=one.cpu().numpy(),
                       int8_mean=(acc / COLL_EF_STEPS).cpu().numpy(),
                       bf16=bf16.cpu().numpy(),
                       device=f"{one.device} {bf16.device}")
    return out


def top2_margin(torch, row):
    """(top-1 minus top-2 logit, one bf16 ulp of the largest |logit|) of
    a logits row."""
    top = torch.topk(row.float(), 2).values
    big = float(row.float().abs().max())
    return float(top[0] - top[1]), 2.0 ** (math.floor(math.log2(big)) - 7)


def tp_bf16_verdict(torch, tp1, leg):
    """(c): the tp TP tokens against tp 1's.  Identical passes; else the
    first step where a row's argmax differs must be a near-tie of tp 1:
    its top-2 margin within one bf16 ulp of the row's largest logit."""
    tokens1 = [r.output for r in tp1["reqs"]]
    if leg["tokens"] == tokens1:
        return "tokens identical"
    for step, (x, y) in enumerate(zip(tp1["logits"], leg["logits"])):
        am = torch.from_numpy(y).argmax(-1)
        rows = (x.argmax(-1).cpu() != am).nonzero().flatten().tolist()
        for row in rows:
            margin, ulp = top2_margin(torch, x[row])
            log(f"tp bf16: step {step + 1} row {row} tp 1 top-2 margin "
                f"{margin:.4e} (one bf16 ulp of its largest logit "
                f"{ulp:.4e})")
            if margin > ulp:
                raise AssertionError(f"tp {TP} bf16 tokens part from tp 1's "
                                     f"at step {step + 1} off a near-tie "
                                     f"(margin {margin} > {ulp})")
        if rows:
            return f"tokens part at step {step + 1}, a near-tie"
    raise AssertionError(f"tp {TP} bf16 tokens differ from tp 1's with no "
                         f"step's argmax differing")


def phase_tp(torch, kernel_modules, tops, errs):
    """26: (a) the kernels at the new launch shapes (`phase_tp_kernels`);
    (b) fp32 (TF32 off) and (c) bf16 full-width smollm-135m at tp 1 here
    and at tp TP in ranks 0..TP-1 of one gloo world of EP_RANKS processes
    sharing the card, eager, on phase 5's trace; (d) deepseek-v2's MoE
    layer expert-parallel over the EP_RANKS ranks against one device's
    `MoE.forward`; (e) the collectives on CUDA tensors.  Any rank's
    failure fails the phase.  Returns (JSON rows by name, launches by
    name, numbers)."""
    import gc
    import shutil
    import types

    import numpy as np

    from repro_torch.launch.mesh import spawn_ranks

    K, GK, GO = kernel_modules[0], kernel_modules[4], kernel_modules[5]
    rows = phase_tp_kernels(torch, K, GK, GO, tops, errs)
    tp1 = {}
    for dtype_name in ("float32", "bfloat16"):
        tp1[dtype_name] = tp_leg(torch, dtype_name)
        run = tp1[dtype_name]
        log(f"tp 1 {dtype_name} eager: steps {len(run['stats'])} wall "
            f"{run['wall']:.3f}s  device_calls "
            f"{dict(run['eng'].device_calls)}")
        run["eng"] = None
        gc.collect()
    ref = ep_reference(torch)
    torch.cuda.empty_cache()
    store = ROOT / "build" / "tp"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    t0 = time.perf_counter()
    res = spawn_ranks(tp_rank, EP_RANKS, backend="gloo",
                      init_file=str(store / "store"))
    log(f"tp ranks: {EP_RANKS} processes over gloo on the one card, "
        f"{time.perf_counter() - t0:.1f}s")
    shutil.rmtree(store, ignore_errors=True)
    # (b) / (c)
    for dtype_name in ("float32", "bfloat16"):
        tokens1 = [r.output for r in tp1[dtype_name]["reqs"]]
        legs = [r[dtype_name] for r in res[:TP]]
        same_tokens = all(leg["tokens"] == legs[0]["tokens"] for leg in legs)
        same_bits = all(leg["digest"] == legs[0]["digest"] for leg in legs)
        one_call = all(leg["device_calls"] == {"unified": leg["steps"]}
                       and leg["pool"] == TP for leg in legs)
        log(f"tp {TP} {dtype_name}: steps {legs[0]['steps']} wall rank 0 "
            f"{legs[0]['wall']:.3f}s (tp 1 eager "
            f"{tp1[dtype_name]['wall']:.3f}s)  ranks' tokens identical "
            f"{same_tokens}  logits bit-equal across ranks {same_bits}  "
            f"one unified call a step on every rank {one_call}")
        if not (same_tokens and one_call):
            raise AssertionError(f"tp {TP} {dtype_name}: ranks disagree or "
                                 f"a step made other calls")
        if dtype_name == "float32":
            diff = max(float((a.cpu() - torch.from_numpy(b)).abs().max())
                       for a, b in zip(tp1[dtype_name]["logits"],
                                       legs[0]["logits"]))
            log(f"tp {TP} fp32 vs tp 1: tokens identical "
                f"{legs[0]['tokens'] == tokens1}  max_abs_logit_diff "
                f"{diff:.3e} (bound {TP_LOGIT_ATOL:g})")
            if legs[0]["tokens"] != tokens1 or not diff <= TP_LOGIT_ATOL:
                raise AssertionError(f"tp {TP} fp32 differs from tp 1")
        else:
            if not same_bits:
                raise AssertionError(f"tp {TP} bf16 logits differ across "
                                     f"ranks")
            log(f"tp {TP} bf16 vs tp 1: "
                f"{tp_bf16_verdict(torch, tp1[dtype_name], legs[0])}")
    launches = res[0]["bfloat16"]["launches"]
    check_paged_routes(types.SimpleNamespace(
        KERNEL_LAUNCHES=res[0]["bfloat16"]["kernels"]), launches,
        f"tp {TP} bf16 rank 0", "bfloat16")
    if any(launches[name] == 0 for name in REPLACES):
        raise AssertionError(f"tp {TP}: a paged kernel never launched: "
                             f"{launches}")
    gat = res[0]["gathers"]
    share = gat["s"] / gat["wall"]
    log(f"tp {TP} bf16 all-gathers (the stream's wait on each, CUDA "
        f"events on rank 0): {gat['calls']} calls over {gat['steps']} steps, "
        f"{gat['s'] * 1e3:.1f} ms of the run's {gat['wall'] * 1e3:.1f} ms "
        f"wall: share {share:.3f}, {gat['s'] / gat['calls'] * 1e3:.3f} ms a "
        f"gather")
    # (d)
    for (cut, n_rows), want in ref.items():
        atol = EP_FP32_ATOL if cut else EP_ATOL
        errs_r = [float(np.abs(r["ep"][cut, n_rows]["y"] - want).max())
                  for r in res]
        walls = [r["ep"][cut, n_rows]["s"] * 1e3 for r in res]
        log(f"tp ep {'fp32 cut' if cut else 'bf16 full width'} rows "
            f"{n_rows}: {res[0]['ep'][cut, n_rows]['experts']} experts a "
            f"rank, max_abs_err by rank "
            f"{' '.join(f'{e:.3e}' for e in errs_r)} (atol {atol:g}, max |y| "
            f"{float(np.abs(want).max()):.3f}); host ms by rank "
            f"{' '.join(f'{w:.2f}' for w in walls)}")
        if not max(errs_r) <= atol:
            raise AssertionError(f"moe_ffn_dropless_ep differs from "
                                 f"MoE.forward: {errs_r} > {atol}")
    ep_launches = sum(res[0]["ep"][False, n]["launches"]["moe_mma_kernel"]
                      for n in EP_ROWS)
    # (e)
    for rank, r in enumerate(res):
        c = r["coll"]
        scale = float(np.abs(c["exact"]).max())
        rel = float(np.abs(c["int8"] - c["exact"]).max()) / scale
        rel50 = float(np.abs(c["int8_mean"] - c["exact"]).max()) / scale
        relb = float(np.abs(c["bf16"] - c["exact"]).max()) / scale
        log(f"tp collectives rank {rank} ({c['device']}): int8 one step "
            f"{rel:.3e} (< 0.02), {COLL_EF_STEPS} steps with feedback "
            f"{rel50:.3e} (< 0.002), bf16 {relb:.3e} (< 0.01)")
        if not (rel < 0.02 and rel50 < 0.002 and relb < 0.01):
            raise AssertionError(f"collectives rank {rank} off bounds")
    counts = {name: launches[name] for name in
              ("paged_decode", "paged_decode_segmented", "segment_reduce",
               "paged_prefill_qblock")}
    counts[EP_ROW] = ep_launches
    return rows, counts, dict(gather_share=share)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc" / "mamba2_ssd.cu").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phase: str) -> None:
        """Log the seconds since the previous lap: one phase's duration."""
        now = time.perf_counter()
        log(f"phase {phase} {now - t_lap[0]:.1f}s")
        t_lap[0] = now

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device {kind}  count {torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi {smi}")
    lap("1 device")

    # 2. build: one nvcc per source, all started together
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba2 import kernel as SK
    from repro_torch.kernels.mla_decode import kernel as AK
    from repro_torch.kernels.mla_decode import ops as AO
    from repro_torch.kernels.mlstm import kernel as MK
    from repro_torch.kernels.moe import kernel as GK
    from repro_torch.kernels.moe import ops as GO
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops as tops

    t0 = time.perf_counter()
    libraries = (K.library, FK.library, SK.library, MK.library, GK.library,
                 AK.library)
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        for f in [pool.submit(lib) for lib in libraries]:
            f.result()
    for name in sorted(_build.BUILD_SECONDS):
        log(f"build {name}.cu -> {_build.library_path(name)} (nvcc "
            f"{_build.BUILD_SECONDS[name]:.1f}s)")
    log(f"build all in {time.perf_counter() - t0:.1f}s")
    lap("2 build")

    # 3. kernels against their plain versions
    errs = phase_check(torch, K, tops)
    lap("3 check")

    # 4. kernel times at the main path's shapes (bf16, the serving dtype)
    times = phase_time(torch, K, tops)
    lap("4 time")

    # 5. end to end through the port's serving path
    launches, serve = phase_serve(torch, K, FK)
    lap("5 serve")

    # 6. card (kernels, graphs) vs CPU (plain versions), fp32; then one
    # bf16 prefill through the graphed packed step
    phase_engine_diff(torch, ARCH, SEED + 1, "diff", None,
                      (K, "prefill_mma_kernel"))
    # prefix caching, the padded step's resumed chunks, stream()
    phase_diff_legs(torch, K)
    lap("6 diff")

    # 7. the flash kernel against its plain version; the gradient card vs CPU
    flash_err = phase_flash_check(torch, FK)
    lap("7 flash")

    # 8. the flash kernel's time at the training shape (bf16)
    flash_time = phase_flash_time(torch, FK)
    lap("8 ftime")

    # 9. end to end through the port's training path
    flash_launches = phase_train(torch, K, FK)
    lap("9 train")

    # 10. training on the card (kernel) vs the CPU (plain version), fp32
    phase_train_diff(torch)
    lap("10 tdiff")

    # 11. the SSD kernel against its plain version
    ssd_err_ = phase_ssd_check(torch, SK)
    lap("11 ssd")

    # 12. the SSD kernel's time at the hybrid serve shape (bf16)
    ssd_time = phase_ssd_time(torch, SK)
    lap("12 ssdtime")

    # 13. end to end through the padded step: zamba2 on the SSD and paged
    # kernels
    hybrid_launches = phase_hybrid_serve(torch, K, FK, SK)
    lap("13 hserve")

    # 14. the hybrid on the card vs the CPU, fp32; then one bf16 prefill
    phase_engine_diff(torch, HYBRID_ARCH, SEED + 3, "hdiff", HDIFF_LAYERS,
                      (SK, "ssd_mma_kernel"))
    lap("14 hdiff")

    # 15. the mLSTM kernel against its plain version
    mlstm_err = phase_mlstm_check(torch, MK)
    lap("15 mlstm")

    # 16. the mLSTM kernel's time at the xlstm serve shape (bf16)
    mlstm_time = phase_mlstm_time(torch, MK)
    lap("16 mltime")

    # 17. end to end through the padded step: xlstm on the mLSTM kernel
    xlstm_launches = phase_xlstm_serve(torch, (K, FK, SK, MK))
    lap("17 xserve")

    # 18. xlstm on the card vs the CPU, fp32; then one bf16 prefill
    phase_engine_diff(torch, XLSTM_ARCH, SEED + 5, "xdiff", XDIFF_LAYERS,
                      (MK, "mlstm_mma_kernel"))
    lap("18 xdiff")

    # 19. the autotune loop: every configuration checked, the sweep timed
    # on the card, the trees fit and served
    _, tune_models = phase_tune(torch, K, tops)
    lap("19 tune")

    # 20. telemetry and the online refit's hot-swap on the serving path
    phase_observe(torch, tune_models)
    del tune_models
    lap("20 observe")

    # 21. the MoE family: (a) the grouped expert GEMM against its plain
    # version and timed; (b) full-width llama4-maverick (2 layers) served
    # through the graphed packed step; (c) the card against the CPU
    moe_err, kept = phase_moe_check(torch, GK)
    moe_time = phase_moe_time(torch, GK, GO, kept)
    del kept
    moe_launches, _ = phase_moe_serve(torch, (K, GK))
    phase_moe_diff(torch)
    lap("21 moe")

    # 22. MLA (deepseek-v2): (a) the latent decode and (b) the flash
    # forward at 192 / 128 against their plain versions and timed; (c)
    # full-width deepseek-v2 (8 layers) served on the padded step; (d) the
    # card against the CPU
    mla_err, mla_time = phase_mla_check(torch, AK, AO,
                                        _build.resource_usage("mla_decode"))
    kvl_serve = [len(p) for p in serve_prompts(torch, 102400)[2]]
    mla_flash_err, mla_flash_time = phase_mla_flash(torch, FK, kvl_serve)
    mla_launches, _ = phase_mla_serve(torch, (K, FK, GK, AK))
    phase_mla_diff(torch)
    lap("22 mla")

    # 23. MoE and MLA training (deepseek-v2): (a) the flash forward at 192 /
    # 128 without kv_len against its plain version, its gradient card vs
    # CPU, timed; (b) full-width deepseek-v2 (2 layers) trained through
    # `train_step`; (c) the card against the CPU in fp32
    mtrain_err, mtrain_time = phase_mtrain_flash(torch, FK)
    mtrain_launches, _ = phase_mtrain(torch, (K, FK, GK, AK))
    phase_mtrain_diff(torch)
    lap("23 mtrain")

    # 24. training of the recurrent families: (a) / (b) zamba2's SSD and
    # xlstm's mLSTM at their training shapes (kernel vs plain, the
    # trainable Functions' forward and gradients, timed) and the D 64
    # flash at zamba2's training attention; (c) / (d) full-size zamba2 and
    # xlstm trained through `train_step`; (e) the card against the CPU
    rtrain_err, rtrain_time = phase_rtrain_kernels(torch, SK, MK, FK)
    kmods = (K, FK, SK, MK, GK, AK)
    htrain_launches, _ = phase_rtrain_model(
        torch, HYBRID_ARCH, HTRAIN_BATCH, HTRAIN_SEQ, kmods)
    xtrain_launches, _ = phase_rtrain_model(
        torch, XLSTM_ARCH, XTRAIN_BATCH, XTRAIN_SEQ, kmods)
    phase_rtrain_diff(torch)
    lap("24 rtrain")

    # 25. the audio and vlm families: musicgen-large and qwen2-vl-2b at
    # full size (a) served graphed and eager, (b) trained, with the flash
    # forward at each training shape checked and timed; (c) the card
    # against the CPU, (d) fused against unfused layouts
    families = phase_families(torch, kmods)
    lap("25 families")

    # 26. tensor-parallel serving, the expert-parallel MoE and the gradient
    # collectives in 4 gloo ranks sharing the card: (a) the kernels at the
    # new launch shapes; (b) / (c) smollm-135m at tp 1 and tp 3, fp32 and
    # bf16; (d) deepseek-v2's MoE layer over 4 ranks; (e) the collectives
    tp_rows, tp_launches, _ = phase_tp(torch, (K, FK, SK, MK, GK, GO), tops,
                                       errs)
    lap("26 tp")

    # the segment_reduce row is the folded launch that computes it on the
    # main path (its standalone kernel is checked and timed, never served)
    times["segment_reduce"] = times[MERGED]
    errs["segment_reduce"] = max(errs["segment_reduce"], errs[MERGED])
    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    max_abs_err=errs[name], **times[name])
               for name in REPLACES]
    kernels.append(dict(name=FLASH, route="cuda", source=FLASH_SOURCE,
                        replaces=FLASH_REPLACES, launches=flash_launches,
                        max_abs_err=flash_err, **flash_time))
    kernels.append(dict(name=SSD, route="cuda", source=SSD_SOURCE,
                        replaces=SSD_REPLACES,
                        launches=hybrid_launches[SSD],
                        max_abs_err=ssd_err_, **ssd_time))
    kernels.append(dict(name=MLSTM, route="cuda", source=MLSTM_SOURCE,
                        replaces=MLSTM_REPLACES,
                        launches=xlstm_launches[MLSTM],
                        max_abs_err=mlstm_err, **mlstm_time))
    kernels.append(dict(name=MOE, route="cuda", source=MOE_SOURCE,
                        replaces=MOE_REPLACES, launches=moe_launches[MOE],
                        max_abs_err=moe_err, **moe_time))
    kernels.append(dict(name=MLA, route="cuda", source=MLA_SOURCE,
                        replaces=MLA_REPLACES, launches=mla_launches[MLA],
                        max_abs_err=mla_err, **mla_time))
    kernels.append(dict(name=MLA_FLASH, route="cuda", source=FLASH_SOURCE,
                        replaces=FLASH_REPLACES,
                        launches=mla_launches["flash_attention_fwd"],
                        max_abs_err=mla_flash_err, **mla_flash_time))
    kernels.append(dict(name=MTRAIN, route="cuda", source=FLASH_SOURCE,
                        replaces=FLASH_REPLACES, launches=mtrain_launches,
                        max_abs_err=mtrain_err, **mtrain_time))
    for name, source, replaces, launched in (
            (RTRAIN_SSD, SSD_SOURCE, SSD_REPLACES,
             htrain_launches["ssd_mma_kernel"]),
            (RTRAIN_MLSTM, MLSTM_SOURCE, MLSTM_REPLACES,
             xtrain_launches["mlstm_mma_kernel"]),
            (RTRAIN_FLASH, FLASH_SOURCE, FLASH_REPLACES,
             htrain_launches["flash_mma_kernel"])):
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launched,
                            max_abs_err=rtrain_err[name],
                            **rtrain_time[name]))
    for arch, (served, flash_n, ferr, frow, _) in families.items():
        for name in FAMILY_PAGED:
            key = f"{name}[{arch}]"
            kernels.append(dict(name=key, route="cuda", source=KERNEL_SOURCE,
                                replaces=REPLACES[name],
                                launches=served[name], max_abs_err=errs[key],
                                **times[key]))
        kernels.append(dict(
            name=f"{FLASH}[{paged_heads(arch)[2]} train, {arch}]",
            route="cuda", source=FLASH_SOURCE, replaces=FLASH_REPLACES,
            launches=flash_n, max_abs_err=ferr, **frow))
    for name in FAMILY_PAGED:
        kernels.append(dict(name=f"{name}[{TP_SHAPES}]", route="cuda",
                            source=KERNEL_SOURCE, replaces=REPLACES[name],
                            launches=tp_launches[name], **tp_rows[name]))
    kernels.append(dict(name=EP_ROW, route="cuda", source=MOE_SOURCE,
                        replaces=MOE_REPLACES, launches=tp_launches[EP_ROW],
                        **tp_rows[EP_ROW]))
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
