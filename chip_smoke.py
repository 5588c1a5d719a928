#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:

1. Build the six kernels from the sources in the checkout (one ``nvcc``
   per source, started together).
2. Hold ``bna_step`` against its plain PyTorch version on the card, for
   exact equality, on random states (B in {1, 37, 256}, w in {1, 8, 64,
   256}, drained matrices included, and B=2 at w=2048, more senders than a
   block has threads), its int64 instance on random states
   with effective sizes past 2^31, and the demand ``[[2^31 - 1]]`` through
   the pipeline's int32-overflow branch (the int64 instance, equal to the
   CPU and to the reference's ``[(2147483647, [0])]``); and
   ``bna_decompose`` on random buckets (w in {1, 2, 8, 64, 256}: all-zero
   lanes, sparse support, lanes of one step, stacks stored short so the
   wrapper relaunches) and sparse buckets at w = 1024 (one lane a block)
   and w = 2048 (a lane's state in a device scratch).
3. Python plan path, checked: gdm at the main path's size with every
   ``bna_step`` launch held against the plain version on a clone of the
   same state and every ``coflow_merge`` call against the plain version on
   the same deltas; then ``coflow_merge`` on a synthetic K ~ 1e5, at
   2m = 300 and at 2m = 2000 (four tiles of the scan's port axis).
4. Pipeline plan path, checked: gdm at scale 0.25 with every
   ``bna_decompose`` bucket (the workload's real buckets, w up to 256) and
   every ``merge_fix`` merge held against the plain versions on the same
   inputs; then
   ``merge_fix`` on random edge sets (m up to 1000) and a synthetic
   K ~ 1.2e5.  Each checked bucket's plain run also counts its searches.
5. The main path: ``paper_workload(m=150, mu_bar=5, seed=0, scale=0.1)``
   planned with gdm and om_alg, and with gdm_rt on the ``rooted=True``
   workload at scale 0.1 (27 coflows), each with the
   launch counters set to 0 just before and read just after:
   a. through the python path on the card (``bna_step``, host repair,
      ``coflow_merge``), equal bit for bit to the same plan on the CPU;
   b. through the pipeline on the card (``bna_decompose``, ``merge_fix``),
      equal bit for bit to the python-path plan of (a), with 0 host
      repairs and 0 int32-overflow buckets.
   Each plan must be feasible under the port's simulator and must have
   launched its path's kernels.  gdm is also planned through the python
   path with the caches off (no prefetch), where every coflow must still
   go through ``bna_step``; a few coflows are checked against the scalar
   BNA.  Then gdm is planned once more through each path under
   ``torch.profiler``, the counters set to 0 just before, and each of
   ``coflow_merge``'s two CUDA kernels (python path) and ``merge_fix``'s
   three (pipeline) must have run once a call.
6. gdm and om_alg at ``scale=1.0`` (the paper's 267 coflows) through the
   pipeline on the card: feasible, 0 host repairs, 0 overflow buckets.
   The lane of gdm's widest bucket with the longest chain (8575 steps)
   runs alone through ``bna_decompose`` and is held, alone and as its row
   of the bucket's result, against the plain version on the CPU.  gdm's
   merge stage is split into each merge's ``merge_fix`` device time (CUDA
   events) and the rest of the stage's host seconds (the wrapper's
   staging), and its largest merge is held against the plain version; the
   K and E of every scale-1.0 merge are recorded, and om_alg's one merge
   (the main path's largest) is held against the plain version and
   timed.  Then a
   switch of m = 1000 ports (``paper_workload(m=1000, mu_bar=2, seed=0,
   scale=0.01)``) is planned with gdm through both paths on the card, each
   equal to the same path's plan on the CPU.
6c. Backfilling: ``gdm_bf``, ``gdm_rt_bf`` and ``om_alg_bf`` (exec
   ``packet``) and ``gdm_bf`` with ``ledger`` at scale 0.1 (``rooted=True``
   for gdm_rt), through ``plan(...)`` on both plan backends on the card,
   each equal bit for bit (a sha256 of the transcript, completions, twct,
   makespan) to the same plan on the CPU.  Every run: the transcript
   capacity-feasible (``verify_transcript(check_capacity=True)``), no
   scalar BNA in the fix-up, a packet plan no worse than its base plan,
   and on the card the path's kernels launched, counted from 0 around the
   run (the pipeline's fix-up through ``bna_decompose`` with 0 host
   repairs; the python path's through ``bna_step``).  Every fix-up bucket
   of the gdm_rt_bf pipeline plan is held against ``bna_decompose``'s
   plain version on the same inputs.  Then ``BF_LARGE``: ``gdm_bf`` and
   ``om_alg_bf`` at 0.25 and ``gdm_rt_bf`` at 0.2 through the pipeline,
   each feasible and no worse than its plan (cut from 0.35 and 0.25 to
   leave room under the time limit: the host's packet sweep grows faster
   than the trace, and scale 1.0 does not fit at all).  The
   CPU runs, the python path's card runs and the larger scales run in
   spawned worker processes while this one runs the pipeline's 0.1 plans,
   so they share the host and the card.  Each run's wall is split into
   the plan, the prefetch, the fix-up (its walk, batch and emission; in
   the batch the ``bna_decompose`` device time by CUDA events,
   ``_steps_to_lists`` and the staging), the sweep and the rest.  The
   record keeps the second at which each worker job ended
   (``pool_done_s``): the last ones set the phase's length.
6d. The online scheduler at the paper's cluster size (run in this process
   while 6c's workers run): ``plan_online`` of ``paper_workload(m=150,
   mu_bar=5, seed=0, scale=0.35)`` with ``poisson_releases(theta=a *
   theta0)``, a in {1, 10}, for the figure's pair (gdm with
   ``nested=False, seed=0``; om_alg) on the pipeline, under the session and
   the batch driver, each with its caches cleared and the counts set to 0
   just before; the session must equal the batch driver (completions,
   twct, reschedules), the path's kernels must launch with 0 host repairs,
   and the first replan of every run goes through ``bna_decompose`` and
   ``merge_fix`` checked against their plain versions (on CPU copies of the
   same inputs).  After the pool, gdm at scale 1.0 (54 arrivals, a = 1)
   under the session alone.  Per run: reschedules, the per-replan wall
   (p50, p95, max; host clock, synced), repair and full-replan counts, the
   bna, order, group and gkey hit rates, launches per replan, twct; and
   the pair's gain 1 - twct(gdm)/twct(om_alg).
6e. Card against CPU (in 6c's pool): the online runs of gdm, om_alg and
   gdm_rt (``rooted=True``, ``nested=False``) at scale 0.1, a = 1, on both
   plan backends, on the card and on the CPU: completions, twct and the
   session's counters equal across all four.
6f. The streaming harness on BENCH_serve's cells (in 6c's pool, sharing
   the host): ``benchmarks/serve_stream.py``'s generator (m = 8, mu = 2,
   trace_seed = 7), the 250-job cells of gdm and gdm_rt spread under
   residual and pinned gamma, Poisson and MMPP at load 0.9, and the 60-job
   overload cell (MMPP, load 2.0, ``AdmissionPolicy(16, 0.4, 16)``),
   through ``StreamDriver`` on the pipeline; each row's twct, full
   replans, repairs, deferred and rejected counts must equal
   ``benchmarks/results/BENCH_serve.json``'s (read as data).  Prints
   p50/p95/p99 ms per arrival and jobs/s.  The two 1000-job om_alg cells
   are left out: 1000 full replans each, a path the other cells cover.
6g. The zoo: instances from the port's own ``repro_torch.scenarios`` and
   the paper's constructions, through the pipeline on the card, caches
   cleared and the counts set to 0 before each run (``_zoo_run``).  The
   CPU side runs in 6c's pool (its plain versions take minutes on the
   FB-calibrated scenarios' gdm_rt); the card side in this process while
   the pool works.  Card == CPU means equal twct, job completions,
   makespan and transcript sha256.  The card side's three FB-calibrated
   gdm_rt runs (host-bound) go to the pool too, ahead of the CPU side.
   a. Every scenario at its builder's defaults (seed 0; online_poisson
      through ``strip_releases``) x gdm, gdm_rt, om_alg with
      ``scheduler_opts``: card == CPU; ``verify_transcript`` and the
      replay of the transcript's completions on both.
   b. After the pool, on the card alone: every scenario at m = 150, scale
      1.0 (dist_collectives on its 2 x 75 fabric) x gdm, om_alg, with
      phase 5's stage split, ``verify_schedule`` and ``verify_transcript``;
      then, for each plan whose merges take at most ``ZOO_PACKET_EDGES``
      edges, cheapest first while ``ZOO_FABRIC_BUDGET_S`` lasts, the same
      plan with ``decompose=True`` under the packet-level
      ``verify_schedule``.
   c. At tests/test_scenarios.py's MID sizes: gdm_bf, gdm_rt_bf, om_alg_bf
      (exec ``packet``) on all 9 scenarios (capacity-feasible, no worse
      than the plan), and ``plan_online`` of online_poisson (session) for
      gdm and om_alg with each replan timed; card == CPU, the session's
      counters too.
   d. Lemma 2: ``gap_instance(K, d=1)`` for K in {2, 4, 8} x gdm, gdm_rt
      (``require_tree=False``), om_alg, card == CPU, each makespan at or
      above (2K+1)Kd; Theorem 1: ``fsp_to_coflow_job`` of an 8 x 32 flow
      shop (integers 1-100 from seed 0) through gdm_rt, card == CPU,
      ``verify_schedule``.
   e. The collective planner: ``coflows_from_step(synthetic_collective_ops(
      n_ops=128, seed, max_mb=8), 8, 8, 32)`` for seeds 0, 1, 2, planned
      as three phases on one session on the card; each phase's order and
      makespans equal to the CPU's.
   Each run on the card must launch ``bna_decompose`` and ``merge_fix``
   with 0 host repairs, 0 overflow buckets and 0 scalar BNA.  Prints each
   cell's wall, launches and widest bucket, beside the card's name and
   power limit.
7. ``flash_attention`` (K4) against its plain version on the card, float32
   (FMA path) and bfloat16 (``wgmma`` on TMA tiles at d = 64 and 128,
   ``mma.sync`` at the other head dims), causal and not, at the reference
   sweep's shapes (d = 24, 32, 48, 64, 128),
   qwen3-1.7b's prefill shapes (B=1, Hq=16, Hkv=8, d=128, S in {1, 127,
   2048}) and the families' of phase 14b (``FAMILY_ATTN``: whisper's
   encoder, 20 heads of d = 64 over 1500 frames, and its cross-attention,
   Sq = 64 over Sk = 1500; granite's 24:8 at d = 64, S = 3072; qwen3-moe's
   64:4 at S = 2048; llava's 32:8 at S = 3008).  Tolerances: 2e-5 in
   float32 (the reference's test; the sums run in another order), 4e-2 in
   bfloat16 (both round a float32 result to bfloat16, so they may differ
   by an ulp of values up to a few units).
8. Serve qwen3-1.7b at its published full width (28 layers, d_model 2048,
   vocab 151936, bf16; 2.03 B parameters from seed 0) with
   ``ServingEngine(ServeConfig(slots=4, capacity=4096, admission="fifo"))``:
   a checked prefill first holds every K4 launch (28) against the plain
   version on the same q/k/v; then, with the counts set to 0, 8 requests
   (prompts of 512-3072 tokens, 32 new tokens each) must all complete with
   28 K4 launches per prefill.  Prints prefill seconds per request, decode
   ms per token, tokens/s and the peak device memory.  A profiled prefill
   of the longest prompt (after 8b) must launch K4's ``wgmma`` kernel
   (``flash_fwd_wgmma``) 28 times.
8b. The same 8 requests served again with ``admission="coflow"``: the
   engine's ``SchedulerSession`` plans on the card (pipeline) at every
   arrival tick.  Its calls are logged and replayed on a CPU session; each
   request must be admitted first, by (planned completion under the
   frontier in force, arrival, rid), among the arrived requests still
   waiting, and all must complete.  Prints the admission's planning ms per
   arrival tick, and decode ms per token and tokens/s beside fifo's, read
   in turns (fifo, coflow, fifo), before any profiler of phase 8 runs.
9. The same full-width weights on the CPU (the plain path): one 64-token
   prefill on the card and on the CPU, last-position logits within 5% of
   the largest logit (bf16 keeps 8 bits: its unit roundoff is 2^-9, and the
   two devices round at other places in each of 28 layers), and whether
   the argmax agrees.
10. ``ssd_scan`` (K5) against its plain version (``ssd_ref``, the
   sequential recurrence) on the card, float32 (three FMA kernels,
   chunk-parallel) and bfloat16 (one launch that walks the chunks, its
   products on ``wgmma``; an operand it computes as high and low bf16
   parts), at the
   reference sweep's shapes, mamba2-2.7b's (B=2, H=80, G=1, N=128, P=64,
   L=128, S in {1, 127, 128, 4096}) and a G=8 shape (jamba's).  Tolerances,
   relative to the largest |y|: 1e-4 in float32 (the reference's test),
   8e-3 in bfloat16 (both round a float32 result to bfloat16: two ulps at
   the top of the range).
11. mamba2-2.7b ``lm_forward`` at its published full width (64 layers,
   d_model 2560, 80 SSD heads, d_state 128, vocab 50280, bf16; 2.83 B
   parameters from seed 0) at B=2, S=4096: a checked pass holds each of
   its 64 K5 calls against ``ssd_ref`` on the same inputs; then, with
   the counts set to 0, an unchecked pass must call K5 exactly 64 times
   (``ssd_scan.launches`` counts calls).  A profiled pass counts K5's CUDA
   launches and must find one a call, the chunk walk (``ssd_walk_wgmma``).
   Prints its wall seconds, peak memory and a ``torch.profiler`` split of
   its device time (K5, GEMMs, the rest) with the busy share.
12. Teacher forcing at full width: prefill 64 tokens (the chunked form) and
   decode 16 (the recurrence); their logits against ``lm_forward``'s
   (through K5) at the same positions, within 0.1% of the largest logit
   with float32 copies of the weights and within 8% in bf16 (the three
   forms of the scan differ by 6.2-6.4% after 64 layers of bf16 rounding,
   as much with K5 swapped for its plain version; a decode that drops its
   state reads 43%: ``scripts/mamba2_bf16_drift.py``, PERF.md).
13. The same weights on the CPU: one 64-token ``lm_forward`` on the card
   and on the CPU, last-position logits within 0.1% of the largest logit
   in float32 and within 5% in bf16.
14. Serve mamba2-2.7b at full width with ``ServingEngine(ServeConfig(
   slots=4, capacity=4096, admission="fifo"))``: the 8 requests of phase 8
   plus one whose prompt is exactly 80 tokens (= H, which the reference's
   ``_pad_cache`` cannot serve); all must complete.  Prints prefill seconds
   per request, decode ms per token, tokens/s, peak memory and a profile
   of one prefill and 8 decode ticks.
14b. The MoE, encoder-decoder and VLM families, each at its published width
   with weights from seed 0 (a ``torch.Generator`` on the card), each
   freed before the next (``_families``):
   a. granite-moe-3b (32 layers, 40 experts top-8, bf16; 3.4 B
      parameters), the slice's path: a checked prefill (every K4 launch
      against the plain version), then phase 8's 8 requests served
      (``_serve_run``, fifo, the counts set to 0 just before), 32 K4
      launches per prefill; a 2048-token prompt's routing (pairs dropped
      per layer) with layer 16's MoE input through ``moe_route`` and
      ``moe_ffn`` on the card and on the CPU (equal experts and kept pairs
      on at least 99% of them, outputs within 5% where a token routes
      alike); ``lm_loss`` at S = 2048; a 64-token prefill card vs CPU.
   b. qwen3-moe-235b at full width (128 experts top-8) with its depth cut
      to 2 of 94 layers: ``lm_forward`` (checked K4) and ``lm_loss`` at
      B = 1, S = 2048.
   c. jamba-1.5-large's smoke config (float32; attention, mamba through K5
      and MoE in one period): ``lm_forward`` card vs CPU (0.1% of the
      largest logit), its aux and ``lm_loss`` within 1e-4, and prefill +
      decode against the card's ``lm_forward`` (2e-3, the reference's
      test).
   d. whisper-large-v3 (32 + 32 layers, bf16): 1500 frames of seeded
      normal embeddings and a 64-token prompt through ``encdec_prefill``
      (checked: 96 K4 launches, 32 encoder, 32 decoder self, 32 cross),
      32 ``encdec_decode_step``s, ``encdec_loss`` on 448 tokens; card vs
      CPU on the weights cut to 2 + 2 layers.
   e. llava-next-mistral-7b (32 layers, bf16, 7.2 B parameters): 2880
      seeded patch embeddings and 128 tokens through ``vlm_prefill``
      (checked, 32 K4 launches), 16 ``decode_step``s on its cache,
      ``vlm_loss``; card vs CPU on the weights cut to 2 layers (576
      patches and 64 tokens).
   Bf16 card vs CPU logits within 5% of the largest.  Prints each model's
   walls, decode ms per token, peak memory and K4 launches per prefill.
15. Time each kernel at the largest shapes the main path gave it (CUDA
   events for the asynchronous ones; host clock around the call for
   ``bna_decompose``, whose wrapper reads the step counts back), beside
   its plain version and its bound (the larger of bytes over the card's
   3.35 TB/s and operations over its peak rate): ``merge_fix`` at the
   largest merge of the scale-1.0 gdm plan (scale 0.25's and the synthetic
   K ~ 1.2e5 beside it), ``bna_step`` beside an empty kernel launched
   through its library (``launch_floor_ms``, what a launch costs).
   ``bna_decompose``'s row
   adds the longest lane's steps, searches and search iterations (from
   the plain version's counters on the same bucket), the kernel's whole
   time over each (``whole_ns_per_iteration``, ``whole_ns_per_step``;
   not a split of it), its design floor (the longest lane's dependent
   shared-memory round trips at 30 cycles each, over the SM clock that
   ``nvidia-smi`` reads while it runs), and its lanes and shared memory
   per block; K4 also at S=32768 (the ``prefill_32k`` sequence length)
   and at the families' shapes as their paths run them, each beside
   ``scaled_dot_product_attention``, its launches on granite's serve (this
   slice's path) and per prefill of each family; K5 at mamba2's B=2, S=4096 (no
   PyTorch call computes the SSD scan, so its library time is null), which
   must hold less device memory than the chunk states it does not keep.
   K4's and K5's bounds come from ``attn_fwd_bounds`` and
   ``ssd_fwd_bounds``.  K4's
   and K5's rows add their design, TFLOP/s, and the registers, local
   memory (spills) and dynamic shared memory of each kernel as the loaded
   library reports them; K4 its ratio to ``library_ms``; K2, K3 and K5 the
   CUDA launches per call counted under the profiler (phases 5 and 11) and
   the device bytes one call holds at its peak (``alloc_bytes``: outputs
   and scratch, read from the caching allocator).  What a model computes
   rather than the run measures (``bna_decompose``'s design floor, the
   parts of K5's bound) goes to the record's ``kernel_models``, not the
   line.  Print the
   ``kernels`` line, the plan, serve and training timings
   and counts, and the card's name and power limit.  The last line is the
   result line.
16. Training (``_training``, run after the timings of 15, whose kernels
   line it extends):
   a. qwen3-1.7b at its published full width (28 layers, bf16, remat
      "full") trained through ``repro_torch.launch.train``'s ``main`` for
      4 steps of 4 x 4096 tokens with ``--plan-buckets 8`` (the gradient
      buckets planned on the card's scheduling session), the counts set to
      0 just before and read just after: 56 K4 forward launches a step (28
      and 28 recomputed) and 28 of each backward kernel (``attn_bwd_prep``,
      ``attn_bwd_dkdv``, ``attn_bwd_dq``).  The reference's train_4k shape
      is seq 4096 at global batch 256: the batch is cut to 4 (at 8 the
      step's backward does not fit the card's 80 GB).  Prints the
      step's wall (median of steps 2-4), tokens/s, peak memory, loss and
      grad norm per step, and the bucket plan's seconds and gain, and
      fails unless the step ran in bf16 and the backward kernels read
      their operands by TMA as they lie (``.staged`` stays 0).
   b. K4's backward kernels against ``attention_bwd_ref``: layer 0 of a
      real step of that model at B = 1, S = 4096, and a grid
      (``ATTN_BWD_SHAPES``: d 64 and 128, GQA 16:8, 24:8, 32:8, 64:4, MHA
      20:20, S in {1, 127, 128, 129, 4096}, Sq != Sk both ways, rows that
      see no key) in float32 and bfloat16, causal and not; tolerances
      ``ATTN_BWD_TOL`` of the largest |gradient| (float32 2e-5, bf16 4e-2),
      dq 0 on rows that see no key.  Then the backward at the training
      shape (B=4, Hq=16, Hkv=8, S=4096, d=128, bf16, causal) and at
      granite-moe-3b's (``ATTN_BWD_TIME_D64``, d=64): each kernel (ms,
      bound, share of the bound, registers, local memory, shared memory)
      and the whole beside its bound (five products of 2 B Hq Sq Sk d
      operations over the kept pairs at the bf16 peak; dkdv four, dq
      three), SDPA's backward (``torch.autograd.grad`` of SDPA with
      ``enable_gqa=True``, minus its forward) and, at the training shape,
      the plain version; two runs of the training shape's backward must
      give the same bits; the forward with lse at the training shape beside
      its bound.  The capture pass (one step's forward and backward at B =
      1) runs under the profiler and must launch K4's ``wgmma`` kernel 56
      times.
   c. Card against CPU: one ``build_train_step`` of qwen3-1.7b at full
      width cut to 2 periods, float32, B = 1, S = 256, from one state
      (loss, grad norm, every parameter after the step); every gradient
      leaf of the float32 smoke configs of tinyllama, qwen3, granite-moe,
      whisper, llava, mamba2 and jamba (K4, K5 and their backwards on the
      card) within 1e-4 of its largest; the reference's crash/resume
      protocol on the card (tinyllama's and jamba's smoke configs: crash
      at step 7, resume from step 6, run to 12), every parameter
      bit-equal to an uninterrupted run.
   d. mamba2-2.7b at its published full width (64 layers, bf16, remat
      "full") trained through ``launch.train``'s ``main`` for 4 steps of
      4 x 4096 tokens with ``--plan-buckets 8``, the counts set to 0 just
      before and read just after: 128 K5 forward calls a step (64 and 64
      recomputed) and 64 of each backward wrapper (``ssd_bwd_state``,
      ``ssd_bwd_chunk``; in bf16 one and four CUDA launches, on the
      tensor cores).  Prints the step's wall
      (median of steps 2-4), tokens/s, peak memory, loss and grad norm.
   e. K5's backward wrappers against their plain versions
      (``ssd_bwd_state_ref``, ``ssd_bwd_chunk_ref``, on the same inputs,
      the forward's kept states from the card) and the whole backward
      (``ssd_scan(...).backward``, the autograd path training runs)
      against ``ssd_bwd_ref``, on ``SSD_BWD_SHAPES`` in float32 and
      bfloat16, b and c strided views of one tensor as the model hands
      them; tolerances ``SSD_BWD_TOL`` of each output's own largest
      |value| and of the largest over the outputs (float32 1e-4 and
      2e-5, bf16 1e-2).  Then each wrapper at the
      training shape (B=4, S=4096, H=80, bf16): ms, bound, the plain
      version's ms and its outputs held against the wrapper's, registers,
      local and shared memory of each CUDA kernel
      (``ssd_scan.BWD_KERNELS``, named by ``ssd_bwd_kernel_name``; a bf16
      kernel with local memory fails), and the CUDA launches one call of
      each wrapper makes under the profiler (each named kernel once, none
      other, or it fails); two runs must give the same bits.  The forward
      that keeps its states at the training shape beside its bound
      (``ssd_fwd_bounds(keep=True)``), profiled in the same window: one
      CUDA launch, the chunk walk.
17. The mesh (``_mesh``): the dry run and its collectives on the card.
   a. ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
      train_4k``, on the 16 x 16 mesh and, with ``--multi-pod``, on the
      2 x 16 x 16 mesh, two subprocesses started together with the card
      hidden from them: a fake process group of 256 or 512 ranks, ``meta``
      tensors, full width, global batch 256 x 4096.  Prints each mesh's
      FLOPs per device, argument bytes per device, collectives per kind
      (count and bytes), the H100 roofline terms, the bottleneck and the
      trace's seconds: figures of a trace, rank 0's share, not of a run.
   b. The 16 x 16 trace's collective program through
      ``coflows_from_step(ops, rows=16, cols=16, n_buckets=8)``, planned
      with ``plan(inst, device="cuda")`` on the pipeline (the counts set
      to 0 just before and read just after: ``bna_decompose`` and
      ``merge_fix`` must launch), equal with no tolerance to the same plan
      on the CPU's pipeline (order, planner and naive makespans); then
      ``bucket_order_from_plan`` over qwen3-1.7b's leaf paths.
   c. A real process group: NCCL, world size 1, over a ``HashStore``; a
      (1, 1) ("data", "model") mesh; one qwen3-1.7b training step at full
      width, 1 x 4096 tokens, the parameters and moments distributed by
      the rule table, the gradients redistributed in (b)'s bucket order,
      K4 through ``local_map`` on the card (the counts set to 0 just
      before and read just after), against the same step without a mesh
      from the same seed and batch: the loss must be the same bits, and
      K4 must launch as often; the grad norm's difference is printed.
18. The port's contract checker (``_checker``, host only; this machine's
   Python and PyTorch, not the CPU tests'): (a) ``repro_torch.analysis``'s
   ``scan_paths`` over src/repro_torch in process, with ``--strict``'s
   semantics: 0 unsuppressed findings, an empty
   ``analysis_baseline_torch.json`` and no stale entry; prints the rule,
   file and suppressed counts and the scan's wall; (b) every launch site
   ``overflow-range`` resolves (13: each ``kernels/*/ops.py`` call of a
   ctypes entry): each entry it may call must be a symbol that its
   kernel's built library exports (``getattr`` on the loaded ``CDLL``),
   with the argtypes of the entry's ``extern "C"`` declaration in its
   ``.cu`` source; and every kernel of the ``kernels`` line
   (``<name>_launch``) must be among them.  It launches nothing.

float32 matrix products run in full float32 (``allow_tf32`` is set False,
PyTorch's default, for matmul and cuDNN).

The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
BF16_FLOPS = 989e12                 # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12                   # H100 SXM float32 outside the tensor cores
# the python path's host repair takes 30-60 s a plan at 0.25 (card and
# CPU), so the time limit cuts all three to 0.1 (the pipeline plans the
# full trace, scale 1.0, in phase 6, and backfills gdm_rt at 0.25 in 6c)
SCALES = {"gdm": 0.1, "gdm_rt": 0.1, "om_alg": 0.1}
FULL_SCALE = ("gdm", "om_alg")      # planned at scale 1.0 on the pipeline
KERNELS = ("bna_step", "coflow_merge", "bna_decompose", "merge_fix",
           "flash_attention", "ssd_scan")
SERVE_ARCH = "qwen3-1.7b"
SSM_ARCH = "mamba2-2.7b"
# phase 14b, the MoE, encoder-decoder and VLM families at full width:
# granite-moe-3b served (the slice's path), qwen3-moe-235b at full width
# with its depth cut (one 128-expert layer is 2.42 B parameters: 94 do not
# fit one card), jamba-1.5-large's smoke config (one full-width period of
# 4 MoE layers is about 77 GB in bf16), whisper-large-v3 and
# llava-next-mistral-7b
MOE_ARCH = "granite-moe-3b"
WIDE_MOE = ("qwen3-moe-235b", 2)    # (arch, periods kept)
HYBRID_ARCH = "jamba-1.5-large"
ENCDEC_ARCH = "whisper-large-v3"
VLM_ARCH = "llava-next-mistral-7b"
LOSS_S = 2048                       # lm_loss's and the routing check's S
ENCDEC_PROMPT, ENCDEC_DECODE, ENCDEC_LOSS = 64, 32, 448
VLM_TEXT, VLM_DECODE = 128, 16
VLM_CPU = (576, 64)                 # patches, text tokens of the CPU compare
TF_ABS_TOL = 2e-3                   # the reference's teacher-forcing test
# K4 at the families' shapes (B, Hq, Hkv, Sq, Sk, d) -> causal on their
# path: whisper's encoder and its cross-attention (a 64-token decoder
# prompt over 1500 frames), granite's longest prompt, qwen3-moe's 64:4 GQA
# at S = 2048, llava's 2880 patches + 128 tokens; phase 7 checks each,
# causal and not, and phase 15 times each as its path runs it
FAMILY_ATTN = {(1, 20, 20, 1500, 1500, 64): False,
               (1, 20, 20, 64, 1500, 64): False,
               (1, 24, 8, 3072, 3072, 64): True,
               (1, 64, 4, 2048, 2048, 128): True,
               (1, 32, 8, 3008, 3008, 128): True}
# K5's forward kernels by type, as the profiler names them: bf16 one
# launch that walks the chunks; float32 chunk states, the state pass over
# the chunks and chunk outputs
K5_NAMES = {"bfloat16": ("ssd_walk_",),
            "float32": ("ssd_state_", "ssd_pass", "ssd_out_")}
K4_FWD_WGMMA = "flash_fwd_wgmma"    # K4's forward kernel at bf16, d 64 / 128
K2_NAMES = ("carry_clear", "merge_pass")              # K2's two kernels
K3_NAMES = ("bucket_index", "bin_sort", "tile_scan")  # K3's three kernels
# fields of the kernels line that a model computes rather than the run
# measures, besides bound_ms: kept in the record, not the line
MODEL_KEYS = ("bound_bytes_ms", "bound_ops_ms", "bound_f32_cuda_core_ms",
              "design_floor_ms", "design_floor_round_trips",
              "cycles_per_round_trip")
ATTN_TOL = {"float32": 2e-5, "bfloat16": 4e-2}
# within ATTN_TOL, a K4 launch on the wgmma route (bf16, d 64 or 128) is
# held to the size of its own output (attn_rel_err): each query row within
# 2e-2 of the row's largest |value|, each (batch, head) within 1e-2 in L2.
# A correct kernel and the plain version each round a float32 result (the
# kernel's P too) to bf16, so they differ by an ulp, at most 2^-7 of the
# row's largest value, or two where the results lie a few 1e-3 apart; a
# CPU model of the kernel read 0.0078 and 0.0025 over 400k rows.  A kernel
# that drops one key stage of a long row misses about sqrt(keys of a stage
# / keys of the row) of it, 0.2 in L2 and 0.7 in a row at 64 of 1500 keys
WGMMA_REL_TOL = {"row": 2e-2, "head": 1e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 8e-3}   # relative to max |y|
CHECK_SCALE = 0.25                  # phase 4's checked pipeline plan
# phase 6c: the *_bf schedulers at scale 0.1 (card == CPU on both plan
# backends), then through the pipeline at larger scales: the reference's
# figure scale (0.35, paper_figs.DEFAULT_SCALE) took 204.9 s for gdm_bf,
# 161.9 of it the host's packet sweep, which grows about as scale^2.6, so
# the scales are cut to leave the whole run room under its time limit
BF_SCHEDS = ("gdm_bf", "gdm_rt_bf", "om_alg_bf")
BF_SCALE = 0.1
BF_LARGE = {"gdm_bf": 0.25, "om_alg_bf": 0.25, "gdm_rt_bf": 0.2}
# spawned processes for phase 6c's runs: one a core of an 8-core H100
# host (the main process's own 6c work ends well before the pool's, which
# sets the phase)
BF_WORKERS = 8
# phases 6d-6f: the online scheduler.  6d: the figure's pair (paper_figs.
# fig_c: gdm with nested=False, seed=0, against om_alg) at the figure's
# scale and arrival rates theta = a * theta0, session and batch drivers on
# the pipeline, then gdm at scale 1.0 under the session alone; 6e: card ==
# CPU at 0.1 on both plan backends; 6f: BENCH_serve's cells
ONLINE_OPTS = {"gdm": {"nested": False, "seed": 0},
               "gdm_rt": {"nested": False, "seed": 0}, "om_alg": {}}
ONLINE_SCALE = 0.35
ONLINE_RATES = (1, 10)              # a in theta = a * theta0
ONLINE_FULL = ("gdm", 1.0, 1)       # (scheduler, scale, a), session alone
ONLINE_CPU_SCALE = 0.1
ONLINE_CPU_SCHEDS = ("gdm", "gdm_rt", "om_alg")
# benchmarks/serve_stream.py's generator and cells, read from
# benchmarks/results/BENCH_serve.json as data; its two 1000-job om_alg
# cells are left out (1000 full replans each, a path the others cover)
STREAM = {"m": 8, "mu": 2, "trace_seed": 7, "load": 0.9, "overload": 2.0}
STREAM_JOBS = 250
STREAM_POLICY = (16, 0.4, 16)       # AdmissionPolicy of the overload cell
STREAM_OVERLOAD_JOBS = 60
STREAM_KEYS = ("twct", "session_full_replans", "session_repairs",
               "deferred", "rejected")
# phase 6g, the zoo: the port's own scenario registry (repro_torch.scenarios)
# and the paper's constructions.  (a) every scenario at its builder's
# defaults x ZOO_SCHEDS, card == CPU; (b) every scenario at m = ZOO_M,
# scale 1.0 (dist_collectives on its 2 x 75 fabric) x ZOO_FABRIC on the card
# alone, with a packet-level check; (c) the
# *_bf schedulers and the online session at tests/test_scenarios.py's MID
# sizes, card == CPU; (d) Lemma 2's gap instance for ZOO_GAP_K and Theorem
# 1's reduction of a ZOO_FSP flow shop (integers 1-100 from seed 0), card ==
# CPU; (e) the collective planner on an 8 x 8 pod (benchmarks/planner_ab.py's
# fabric), three phases on one session, card == CPU
ZOO_SCHEDS = ("gdm", "gdm_rt", "om_alg")
ZOO_FABRIC = ("gdm", "om_alg")
ZOO_M = 150
# (b)'s packet-level check runs on a plan whose merges take at most
# ZOO_PACKET_EDGES edges, while ZOO_FABRIC_BUDGET_S lasts: decompose=True
# took 108-112 s a plan on shuffle_heavy's 6.4 M merged edges at m = 150
ZOO_PACKET_EDGES = 1_000_000
ZOO_FABRIC_BUDGET_S = 60.0
ZOO_MID = {
    "fb_like": dict(m=14, scale=0.06),
    "fb_like_rt": dict(m=14, scale=0.06),
    "alibaba_sparse": dict(m=14, scale=0.3),
    "incast": dict(m=14, scale=0.25),
    "shuffle_heavy": dict(m=12, scale=0.35),
    "wide_shallow": dict(m=14, scale=0.3),
    "deep_chain": dict(m=12, scale=0.4),
    "online_poisson": dict(m=14, scale=0.06),
    "dist_collectives": dict(m=12, scale=1.0),
}
ZOO_BF = ("gdm_bf", "gdm_rt_bf", "om_alg_bf")
ZOO_ONLINE = ("gdm", "om_alg")
ZOO_GAP_K = (2, 4, 8)
ZOO_FSP = (8, 32)                   # machines x jobs
ZOO_PLANNER = dict(n_ops=128, max_mb=8, rows=8, cols=8, n_buckets=32,
                   seeds=(0, 1, 2))  # one phase per seed, one session
ZOO_KEYS = ("twct", "job_completions", "makespan", "digest", "entries")
LOGIT_TOL = 0.05                    # of the largest logit, bf16 card vs CPU
LOGIT_TOL_F32 = 1e-3                # of the largest logit, float32 weights
TF_TOL_BF16 = 0.08                  # of the largest logit, bf16 teacher forcing
# phase 16, training: qwen3-1.7b at full width through repro_torch.launch.
# train (the reference's train_4k shape is seq 4096 at global batch 256; the
# batch is cut to 4: at 8 the backward asked for 9.27 GiB more with 69.33
# GiB allocated, past the card's 79.18 GiB), K4's backward kernels
# (BWD_KERNELS) against attention_bwd_ref on ATTN_BWD_SHAPES (the families' head shapes, S in
# {1, 127, 128, 129, 4096}, Sq != Sk both ways: causal rows that see no
# key), card vs CPU on qwen3 cut to TRAIN_CPU_CUT = (periods, B, S) in
# float32 and on TRAIN_SMOKE's smoke configs, crash/resume on RESUME_ARCHS'
# smoke configs
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_BUCKETS = 4, 4096, 4, 8
TRAIN_CPU_CUT = (2, 1, 256)
TRAIN_SMOKE = ("tinyllama-1.1b", "qwen3-1.7b", "granite-moe-3b",
               "whisper-large-v3", "llava-next-mistral-7b", "mamba2-2.7b",
               "jamba-1.5-large")
# crash/resume on the card: a decoder-only LM, and jamba's hybrid (K4, K5
# and the MoE layer in one run)
RESUME_ARCHS = ("tinyllama-1.1b", "jamba-1.5-large")
BWD_KERNELS = ("attn_bwd_prep", "attn_bwd_dkdv", "attn_bwd_dq")
# K4's backward is timed at the training shape and at granite-moe-3b's head
# shape (d = 64), both bf16 and causal
ATTN_BWD_TIME_D64 = (1, 24, 8, 3072, 3072, 64)
ATTN_BWD_TOL = {"float32": 2e-5, "bfloat16": 4e-2}   # of the largest |grad|
ATTN_BWD_SHAPES = [(1, 16, 8, S, S, 128) for S in (1, 127, 128, 129, 4096)] \
    + [(1, 24, 8, 300, 300, 64), (1, 64, 4, 200, 200, 128),
       (1, 32, 8, 257, 257, 128), (1, 20, 20, 64, 1500, 64),
       (1, 20, 20, 300, 300, 64), (1, 4, 2, 100, 40, 32),
       (2, 4, 2, 33, 33, 24)]
# phase 16(d)-(e), the SSM slice: mamba2-2.7b at full width trained through
# repro_torch.launch.train (B x S tokens a step, as qwen3's run: B = 8
# fits the card, at a peak of 55.9 GiB on an H100, but its 12 s more do not
# fit this script's time on a slower host; scripts/ssm_train_batch.py
# trains it), and K5's
# backward wrappers (SSD_BWD: the chunk state gradients and their reverse
# pass; the chunk gradients and the group sum) against their plain versions
# on SSD_BWD_SHAPES (B, S, H, G, N, P, L): mamba2's heads at S in {1, 127,
# 128, 129, 4096}, jamba-1.5-large's full-width heads (H 256 in 8 groups)
# at a small B S, the smoke configs' (N 16, P 8, L 16).  SSD_BWD_TOL: (of
# each output's own largest |value|, of the largest |value| over the
# outputs); each output is held to both.  float32 (1e-4, 2e-5): the second
# is K4's backward's; the first is the forward's and the CPU tests' 1e-4,
# as an output can be small by cancellation where its rounding is not: at
# S = 1 (one batch, one group) dx is the single dot product c.b times dy,
# and this draw's c.b is about 3e-4 (dx read 5.6e-5 of its own largest on
# an H100).  bf16 (1e-2, 1e-2), set from readings: 3.4e-3 at most, dx at S
# = 4096
SSM_TRAIN_STEPS, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH = 4, 4096, 4
# phase 17, the mesh: qwen3-1.7b's train_4k cell traced by the dry run (host
# subprocesses, killed past MESH_TRACE_TIMEOUT s), its 16 x 16 collective
# program planned in MESH_BUCKETS buckets, and one full-width step of
# MESH_STEP = (B, S) tokens on a (1, 1) NCCL mesh
MESH_ARCH, MESH_SHAPE, MESH_BUCKETS, MESH_STEP = "qwen3-1.7b", "train_4k", \
    8, (1, 4096)
MESH_TRACE_TIMEOUT = 300
SSD_BWD = ("ssd_bwd_state", "ssd_bwd_chunk")
SSD_GRADS = ("dx", "da", "db", "dc")
SSD_BWD_TOL = {"float32": (1e-4, 2e-5), "bfloat16": (1e-2, 1e-2)}
SSD_BWD_SHAPES = [(1, S, 80, 1, 128, 64, 128) for S in (1, 127, 128, 129,
                                                        4096)] \
    + [(1, 384, 256, 8, 128, 64, 128), (2, 24, 16, 1, 16, 8, 16),
       (2, 50, 6, 3, 16, 8, 16)]


def attn_rel_err(got, want) -> dict:
    """K4's output against its plain version, relative to the output's own
    size: "row", the largest over query rows of max |got - want| over the
    row's max |want|; "head", the largest over (batch, head) of
    ||got - want|| over ||want||.  Rows where `want` is not finite
    (``attention_ref`` gives NaN on a row that sees no key) are left out."""
    import torch

    g, w = got.float(), want.float()
    ok = torch.isfinite(w).all(-1, keepdim=True)
    diff = torch.where(ok, g - w, 0.0)
    w = torch.where(ok, w, 0.0)
    tiny = torch.finfo(torch.float32).tiny
    row = diff.abs().amax(-1) / w.abs().amax(-1).clamp_min(tiny)
    head = diff.flatten(2).norm(dim=-1) / \
        w.flatten(2).norm(dim=-1).clamp_min(tiny)
    return {"row": float(row.max()), "head": float(head.max())}


def zero_staged() -> None:
    """Sets the staged-copy counts of K4's and K5's forwards to 0."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    flash_attention.staged = ssd_scan.staged = 0


def check_staged(what: str) -> dict:
    """Fails unless K4's and K5's forwards have read every operand since
    ``zero_staged()`` by TMA as it lay, with no staged copy (a layout change
    in the models would add a copy to every call); returns the counts."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    staged = {"flash_attention": flash_attention.staged,
              "ssd_scan": ssd_scan.staged}
    if any(staged.values()):
        _fail(f"{what}: the forwards staged copies of operands that TMA "
              f"should read as they lie: {staged}")
    return staged


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _cuda_ms(fn, reps: int = 50, rounds: int = 7) -> float:
    """Median device time of one fn() in ms: a sleep kernel holds the
    stream while the host enqueues `reps` calls, so the events bracket
    back-to-back device work, not the host's launch overhead (a call that
    synchronises inside measures its wall time instead)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _wall_ms(fn, rounds: int = 3) -> float:
    """Median host-clock time of fn() in ms, each ending in a sync (for a
    call that synchronises inside)."""
    import torch

    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _attributes(fn, *args) -> dict:
    """A kernel's compiled attributes, through its library's
    ``*_attributes`` entry: registers and local memory (spills) a thread,
    and the dynamic shared memory its launch requests."""
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = fn(*args, ctypes.byref(regs), ctypes.byref(local),
             ctypes.byref(smem))
    if err != 0:
        _fail(f"{fn.__name__}{args}: CUDA error {err}")
    return {"registers": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}


def alloc_bytes(fn) -> int:
    """Device bytes that one fn() call holds at its peak, its outputs and
    scratch included, as the caching allocator counts them."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def _nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    return smi.stdout.strip()


def _host_cpu() -> str:
    """The host's CPU model and core count (host-bound times move with
    it)."""
    import os
    import platform

    try:
        model = next(line.split(":", 1)[1].strip() for line in
                     Path("/proc/cpuinfo").read_text().splitlines()
                     if line.startswith("model name"))
    except (OSError, StopIteration):
        model = "model not named"
    return f"{platform.machine()}, {model}, {os.cpu_count()} cores"


def _bf_digest(transcript) -> str:
    """sha256 of a transcript, entry by entry in order: (jid, cid, t0, t1)
    and each array's dtype and bytes.  Equal digests mean equal
    transcripts, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for e in transcript.entries:
        h.update(repr((int(e.jid), int(e.cid), float(e.t0),
                       float(e.t1))).encode())
        for a in (e.srcs, e.dsts, e.units):
            h.update(a.dtype.str.encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _bf_plan(job, check=None) -> dict:
    """Phase 6c: one ``*_bf`` plan of ``paper_workload(m=150, mu_bar=5,
    seed=0, scale)`` (``rooted=True`` for gdm_rt_bf), ``job = (sched, exec,
    scale, device, plan_backend)``, through ``plan(...)``.  Returns the
    result as card and CPU runs are compared (transcript digest,
    completions, twct, makespan), the wall split into the plan (the base
    scheduler's factory), the fix-up (the BNA of every merged interval
    with alpha > 1: its walk, batch and emission; inside the batch the
    ``bna_decompose`` device time by CUDA events, ``_steps_to_lists`` and
    the rest, its staging), the sweep, the prefetch and the rest, and the
    counters.  ``check(d, ks, T_cap, out)`` sees every fix-up bucket's
    ``bna_decompose`` call (its seconds are taken out of the split).
    Raises RuntimeError when a check fails: the transcript is capacity-
    feasible, no scalar BNA ran, a packet plan is no worse than its base
    plan, and on the card the path's kernels ran (the pipeline with 0 host
    repairs)."""
    import importlib

    import torch

    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import (cache_stats, clear_caches, paper_workload,
                                  plan, verify_transcript)
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.bna_step import bna_step
    from repro_torch.kernels.coflow_merge import coflow_merge
    from repro_torch.kernels.merge_fix import merge_fix

    wrappers = {"bna_step": bna_step, "coflow_merge": coflow_merge,
                "bna_decompose": bna_decompose, "merge_fix": merge_fix}
    engine = importlib.import_module("repro_torch.core.engine")
    pipeline = importlib.import_module("repro_torch.core.pipeline")
    timeline = importlib.import_module("repro_torch.core.timeline")
    sched, exec_, scale, device, plan_backend = job
    cuda = device == "cuda"
    inst = paper_workload(m=150, mu_bar=5, seed=0, scale=scale,
                          rooted=(sched == "gdm_rt_bf"))
    acc = dict.fromkeys(("plan", "prefetch", "backfill", "walk", "pieces",
                         "emit", "fix_plan", "check", "check_plan",
                         "device_ms", "steps_to_lists"), 0.0)
    state = {"plan": False, "fixup": False}
    kept: dict = {"buckets": []}

    def timed(name, fn, flag=None):
        def wrapped(*args, **kwargs):
            prev = state.get(flag)
            if flag:
                state[flag] = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                acc[name] += dt
                if name in ("walk", "pieces", "emit") and state["plan"]:
                    acc["fix_plan"] += dt
                if flag:
                    state[flag] = prev
        return wrapped

    base_name = "_" + sched[:-3]        # _gdm, _gdm_rt, _om_alg
    base = getattr(engine, base_name)
    orig_dec, orig_lists = pipeline.bna_decompose, pipeline._steps_to_lists

    def factory(*args, **kwargs):
        kept["plan"] = timed("plan", base, "plan")(*args, **kwargs)
        return kept["plan"]

    def decompose(d, ks, T_cap, t_store=None):
        if not state["fixup"]:
            return orig_dec(d, ks, T_cap, t_store=t_store)
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        out = orig_dec(d, ks, T_cap, t_store=t_store)
        if cuda:
            b.record()
            b.synchronize()
            acc["device_ms"] += a.elapsed_time(b)
        kept["buckets"].append(list(d.shape))
        if check is not None:
            t0 = time.perf_counter()
            check(d, ks, T_cap, out)
            dt = time.perf_counter() - t0
            acc["check"] += dt
            if state["plan"]:
                acc["check_plan"] += dt
        return out

    def steps_to_lists(*args):
        if not state["fixup"]:
            return orig_lists(*args)
        return timed("steps_to_lists", orig_lists)(*args)

    patches = [(engine, base_name, factory),
               (engine, "backfill", timed("backfill", engine.backfill)),
               (engine.backend, "prefetch_plan",
                timed("prefetch", engine.backend.prefetch_plan)),
               (timeline, "_fixup_walk", timed("walk", timeline._fixup_walk)),
               (timeline, "_interval_pieces",
                timed("pieces", timeline._interval_pieces, "fixup")),
               (timeline, "_fixup_emit", timed("emit", timeline._fixup_emit)),
               (pipeline, "bna_decompose", decompose),
               (pipeline, "_steps_to_lists", steps_to_lists)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    clear_caches()
    for fn in wrappers.values():
        fn.launches = 0
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = plan(inst, sched, device=device, plan_backend=plan_backend,
                   seed=0, exec=exec_)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    st = cache_stats()
    fixup = st["plan"]["fixup"]
    launches = {name: fn.launches for name, fn in wrappers.items()}
    t0 = time.perf_counter()
    try:
        verify_transcript(inst, got.transcript(), check_capacity=True,
                          makespan=got.makespan)
    except AssertionError as err:
        raise RuntimeError(f"{job}: transcript check failed: {err}") from err
    verify_s = time.perf_counter() - t0
    plan_twct = kept["plan"].twct()
    fix_gross = acc["walk"] + acc["pieces"] + acc["emit"]
    fix = fix_gross - acc["check"]
    split = {"wall_s": wall - acc["check"],
             "plan_s": acc["plan"] - acc["fix_plan"],
             "prefetch_s": acc["prefetch"], "fixup_s": fix,
             "sweep_s": acc["backfill"] - (fix_gross - acc["fix_plan"])}
    split["rest_s"] = split["wall_s"] - sum(
        split[k] for k in ("plan_s", "prefetch_s", "fixup_s", "sweep_s"))
    batch = acc["pieces"] - acc["check"]
    detail = {"walk_s": acc["walk"], "emit_s": acc["emit"], "batch_s": batch,
              "device_ms": acc["device_ms"] if cuda else None,
              "steps_to_lists_s": acc["steps_to_lists"],
              "staging_s": batch - acc["device_ms"] / 1e3
              - acc["steps_to_lists"],
              "in_plan_s": acc["fix_plan"] - acc["check_plan"],
              "lanes": fixup["lanes"], "buckets": fixup["buckets"],
              "launches": fixup["launches"],
              "bucket_fallbacks": fixup["bucket_fallbacks"],
              "largest_bucket": max(kept["buckets"], default=None,
                                    key=lambda x: x[0] * x[1] * x[2])}
    out = {"job": list(job), "coflows": sum(j.mu for j in inst.jobs),
           "twct": got.twct(), "plan_twct": plan_twct,
           "job_completions": got.job_completions(),
           "coflow_completions": dict(got.schedule.coflow_completions),
           "makespan": got.makespan, "digest": _bf_digest(got.transcript()),
           "entries": len(got.transcript().entries), "split": split,
           "fixup": detail, "launches": launches,
           "host_repairs": st["bna"]["repairs"],
           "scalar_bna": fixup["scalar_bna"], "verify_s": verify_s,
           "check_s": acc["check"]}
    bad = []
    if fixup["scalar_bna"]:
        bad.append(f"{fixup['scalar_bna']} scalar bna calls")
    if exec_ == "packet" and not got.twct() <= plan_twct * (1 + 1e-9) + 1e-9:
        bad.append(f"twct {got.twct()} > the plan's {plan_twct}")
    if cuda and plan_backend == "pipeline" and (
            st["bna"]["repairs"] or fixup["bucket_fallbacks"]
            or (fixup["lanes"] and not fixup["launches"])):
        bad.append(f"{st['bna']['repairs']} host repairs, "
                   f"{fixup['bucket_fallbacks']} overflow buckets, "
                   f"{fixup['launches']} fix-up launches")
    path = ("bna_decompose", "merge_fix") if plan_backend == "pipeline" \
        else ("bna_step", "coflow_merge")
    if cuda and not all(launches[k] for k in path):
        bad.append(f"a kernel of the path was not launched: {launches}")
    if bad:
        raise RuntimeError(f"{job}: " + "; ".join(bad))
    return out


def _bf_worker(job) -> dict:
    """_bf_plan in a spawned process, one intra-op thread."""
    import torch

    torch.set_num_threads(1)
    return _bf_plan(job)


def _quantiles(xs) -> dict:
    """p50, p95 and max of a list of seconds, in ms (None when empty)."""
    import numpy as np

    if not xs:
        return {"p50_ms": None, "p95_ms": None, "max_ms": None}
    a = np.asarray(xs, dtype=np.float64) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)), "max_ms": float(a.max())}


def _online_plan(job, check=None) -> dict:
    """Phases 6d and 6e: ``plan_online`` of ``paper_workload(m=150,
    mu_bar=5, seed=0, scale)`` (``rooted=True`` for gdm_rt) with
    ``poisson_releases(theta=a * theta0)``, ``job = (sched, scale, a,
    device, plan_backend, driver)``, caches cleared and the launch counts
    set to 0 just before.  Every replan is timed on the host clock, synced
    on the card (the session's ``_ensure_plan``; the batch driver's plans
    through ``plan_full``), with its kernel launches.  ``check(on)`` is
    called with True just before the run's first replan and with False
    after it (phase 6d installs the checked wrappers there).  Returns
    completions, twct, reschedules, the session's counters, the per-replan
    walls and launches, and the cache hit rates (``gkey`` from
    ``cache_stats`` around the run, with its prefix counts).  ``check(False)``
    returns the seconds its checks took, which are taken out of that
    replan's wall.  Raises RuntimeError when a kernel of the path did not
    launch on the card."""
    import importlib

    import torch

    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import (cache_stats, clear_caches, paper_workload,
                                  plan_online, poisson_releases, theta0)
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.bna_step import bna_step
    from repro_torch.kernels.coflow_merge import coflow_merge
    from repro_torch.kernels.merge_fix import merge_fix

    wrappers = {"bna_step": bna_step, "coflow_merge": coflow_merge,
                "bna_decompose": bna_decompose, "merge_fix": merge_fix}
    engine = importlib.import_module("repro_torch.core.engine")
    session = importlib.import_module("repro_torch.core.session")
    sched, scale, a, device, plan_backend, driver = job
    cuda = device == "cuda"
    base = paper_workload(m=150, mu_bar=5, seed=0, scale=scale,
                          rooted=(sched == "gdm_rt"))
    inst = poisson_releases(base, theta=a * theta0(base), seed=0)
    replans: list = []
    state = {"check_s": 0.0}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn, in_session):
        # the session's _ensure_plan replans only when arrivals suspended
        # its plan (reschedules counts those); every batch plan_full plans
        def wrapped(self, *args, **kwargs):
            before = self.stats.reschedules if in_session else None
            n0 = {k: f.launches for k, f in wrappers.items()}
            first = not replans
            if first and check is not None:
                check(True)
            sync()
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                sync()
                dt = time.perf_counter() - t0
                if first and check is not None:
                    spent = check(False)
                    state["check_s"] += spent
                    dt -= spent
                if not in_session or self.stats.reschedules > before:
                    replans.append({"wall_s": dt, "launches": {
                        k: f.launches - n0[k] for k, f in wrappers.items()}})
        return wrapped

    patches = [(session.SchedulerSession, "_ensure_plan",
                timed(session.SchedulerSession._ensure_plan, True))]
    if driver == "batch":
        patches = [(engine._Registered, "plan_full",
                    timed(engine._Registered.plan_full, False))]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    opts = ONLINE_OPTS[sched]
    clear_caches()
    for fn in wrappers.values():
        fn.launches = 0
    before = cache_stats()
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        sync()
        t0 = time.perf_counter()
        res = plan_online(inst, sched, driver=driver, device=device,
                          plan_backend=plan_backend, **opts)
        sync()
        wall = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    after = cache_stats()
    launches = {k: f.launches for k, f in wrappers.items()}
    g_hits = after["gkey"]["hits"] - before["gkey"]["hits"]
    g_miss = after["gkey"]["misses"] - before["gkey"]["misses"]
    hit = {c: res.stats[c]["hit_rate"] for c in ("bna", "order", "group")}
    hit["gkey"] = g_hits / (g_hits + g_miss) if g_hits + g_miss else 0.0
    gkey_prefix = {k: after["gkey"]["prefix"][k] - before["gkey"]["prefix"][k]
                   for k in after["gkey"]["prefix"]}
    n = max(len(replans), 1)
    out = {"job": list(job), "jobs": len(inst.jobs),
           "coflows": sum(j.mu for j in inst.jobs), "twct": res.twct(),
           "job_completions": res.job_completions,
           "reschedules": res.reschedules, "wall_s": wall,
           "session": res.stats.get("session"), "hit_rates": hit,
           "cache": {c: res.stats[c] for c in ("bna", "order", "group")},
           "gkey_prefix": gkey_prefix, "check_s": state["check_s"],
           "replans": len(replans),
           "replan_wall": _quantiles([r["wall_s"] for r in replans]),
           "replan_wall_s": [r["wall_s"] for r in replans],
           "launches": launches,
           "launches_per_replan": {k: v / n for k, v in launches.items()},
           "host_repairs": after["bna"]["repairs"] - before["bna"]["repairs"]}
    path = ("bna_decompose", "merge_fix") if plan_backend == "pipeline" \
        else ("bna_step", "coflow_merge")
    if cuda and not all(launches[k] for k in path):
        raise RuntimeError(f"{job}: a kernel of the path was not launched: "
                           f"{launches}")
    if cuda and plan_backend == "pipeline" and out["host_repairs"]:
        raise RuntimeError(f"{job}: {out['host_repairs']} host repairs on "
                           "the pipeline")
    return out


def _online_worker(job) -> dict:
    """_online_plan in a spawned process, one intra-op thread."""
    import torch

    torch.set_num_threads(1)
    return _online_plan(job)


def _stream_cell(job) -> dict:
    """Phase 6f: one cell of BENCH_serve's streaming harness, ``job =
    (cell, sched, process, gamma, n_jobs, load, policy)`` on BENCH_serve's
    generator (``stream_jobs(8, n_jobs, 7, process, load, mu=2)``), fed
    through a ``StreamDriver`` on the card's pipeline (``delays="spread",
    seed=0``; ``policy`` the overload cell's ``AdmissionPolicy`` arguments
    or None), the launch counts set to 0 just before.  Returns the
    ``StreamResult.as_dict()`` row and the launches; raises RuntimeError
    when a kernel of the path did not launch."""
    import torch

    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import AdmissionPolicy, clear_caches, stream_jobs
    from repro_torch.core.stream import StreamDriver
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.merge_fix import merge_fix

    torch.set_num_threads(1)
    cell, sched, process, gamma, n_jobs, load, policy = job
    jobs = stream_jobs(STREAM["m"], n_jobs, STREAM["trace_seed"],
                       process=process, load=load, mu=STREAM["mu"])
    clear_caches()
    bna_decompose.launches = merge_fix.launches = 0
    drv = StreamDriver(STREAM["m"], sched, gamma=gamma, device="cuda",
                       plan_backend="pipeline",
                       admission=AdmissionPolicy(*policy) if policy else None,
                       delays="spread", seed=0)
    for j in jobs:
        drv.feed(j)
    res = drv.result()
    torch.cuda.synchronize()
    launches = {"bna_decompose": bna_decompose.launches,
                "merge_fix": merge_fix.launches}
    if not all(launches.values()):
        raise RuntimeError(f"{cell}: a kernel of the path was not launched: "
                           f"{launches}")
    return {"cell": cell, "n_jobs": n_jobs, "launches": launches,
            **res.as_dict()}


def _zoo_run(job) -> dict:
    """Phase 6g: one run of the zoo, ``job = (kind, what, sched, device)``,
    through the pipeline on ``device``, caches cleared and the launch counts
    set to 0 just before; the run's wall is on the host clock, synced, and
    leaves the checks out.  Kinds:

    * ``defaults``: scenario ``what`` at its builder's defaults (seed 0;
      ``strip_releases`` for an online scenario) planned with ``sched`` and
      ``scheduler_opts``;
    * ``bf``: scenario ``what`` at ``ZOO_MID``'s size, ``sched`` a ``*_bf``
      scheduler with exec ``packet``;
    * ``online``: ``plan_online`` of online_poisson at ``ZOO_MID``'s size
      (session driver), each replan timed;
    * ``gap``: ``gap_instance(what, d=1)`` (``require_tree=False`` for
      gdm_rt);
    * ``fsp``: ``fsp_to_coflow_job`` of a ``ZOO_FSP`` flow shop, integers
      1-100 from ``default_rng(0)``;
    * ``planner``: ``dist.planner.plan`` of ``ZOO_PLANNER``'s step, then
      its next phases on the same session.

    Returns what card and CPU runs compare (``ZOO_KEYS``: twct,
    completions, makespan, the transcript's sha256 and entry count; the
    session counters; each planner phase's order and makespans) and the
    run's launches, wall and widest ``bna_decompose`` bucket.  Raises
    RuntimeError when a check fails: ``verify_transcript`` (capacity too
    for ``*_bf``), the replay of the transcript's completions, a backfill
    no worse than its plan, ``verify_schedule`` (fsp), a makespan below
    Lemma 2's optimum, and on the card the path's kernels launched with 0
    host repairs, 0 int32-overflow buckets and 0 scalar BNA."""
    import importlib

    import numpy as np
    import torch

    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch import scenarios
    from repro_torch.core import (cache_stats, clear_caches,
                                  fsp_to_coflow_job, gap_bounds, gap_instance,
                                  gap_optimal_schedule_length, plan,
                                  plan_online, verify_schedule,
                                  verify_transcript)
    from repro_torch.dist import planner
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.merge_fix import merge_fix

    pipeline = importlib.import_module("repro_torch.core.pipeline")
    session = importlib.import_module("repro_torch.core.session")
    kind, what, sched, device = job
    cuda = device == "cuda"
    widest = {"calls": 0, "shape": None}
    replans: list = []
    out: dict = {"job": list(job)}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    orig_dec = pipeline.bna_decompose
    orig_ensure = session.SchedulerSession._ensure_plan

    def decompose(d, ks, T_cap, t_store=None):
        widest["calls"] += 1
        B, w = int(d.shape[0]), int(d.shape[1])
        if widest["shape"] is None or (w, B) > widest["shape"][::-1]:
            widest["shape"] = (B, w)
        return orig_dec(d, ks, T_cap, t_store=t_store)

    def ensure(self, *args, **kwargs):
        before = self.stats.reschedules
        sync()
        t0 = time.perf_counter()
        try:
            return orig_ensure(self, *args, **kwargs)
        finally:
            sync()
            if self.stats.reschedules > before:
                replans.append(time.perf_counter() - t0)

    def ran(fn):
        clear_caches()
        bna_decompose.launches = merge_fix.launches = 0
        pipeline.bna_decompose = decompose
        session.SchedulerSession._ensure_plan = ensure
        try:
            sync()
            t0 = time.perf_counter()
            res = fn()
            sync()
            out["wall_s"] = time.perf_counter() - t0
        finally:
            pipeline.bna_decompose = orig_dec
            session.SchedulerSession._ensure_plan = orig_ensure
        st = cache_stats()
        out["launches"] = {"bna_decompose": bna_decompose.launches,
                           "merge_fix": merge_fix.launches}
        out["widest_bucket"] = widest["shape"]
        out["host_repairs"] = st["bna"]["repairs"]
        out["bucket_fallbacks"] = (st["plan"]["decompose"]["bucket_fallbacks"]
                                   + st["plan"]["fixup"]["bucket_fallbacks"])
        out["scalar_bna"] = st["plan"]["fixup"]["scalar_bna"]
        return res

    def keep_plan(inst, got, capacity=False):
        tr = got.transcript()
        out.update(twct=got.twct(), job_completions=got.job_completions(),
                   makespan=got.makespan, digest=_bf_digest(tr),
                   entries=len(tr.entries), m=inst.m,
                   coflows=sum(j.mu for j in inst.jobs))
        try:
            verify_transcript(inst, tr, check_capacity=capacity,
                              makespan=got.makespan if capacity else None)
        except AssertionError as err:
            raise RuntimeError(f"{job}: transcript check failed: {err}") \
                from err
        replay = tr.job_completions()
        bad = {j: (t, replay.get(j)) for j, t in got.job_completions().items()
               if replay.get(j) is None or abs(replay[j] - t) > 1e-6}
        if bad:
            raise RuntimeError(f"{job}: the transcript replays other "
                               f"completions: {bad}")

    opts: dict = {}
    if kind in ("defaults", "bf", "online"):
        built = scenarios.build(what, seed=0, **({} if kind == "defaults"
                                                 else ZOO_MID[what]))
        inst = built.instance
        if kind != "online" and built.meta.arrival != "offline":
            inst = scenarios.strip_releases(inst)
        opts = scenarios.scheduler_opts(sched, built.meta)
    if kind == "defaults":
        keep_plan(inst, ran(lambda: plan(inst, sched, device=device,
                                         plan_backend="pipeline", seed=0,
                                         **opts)))
    elif kind == "bf":
        got = ran(lambda: plan(inst, sched, device=device,
                               plan_backend="pipeline", seed=0,
                               exec="packet", **opts))
        keep_plan(inst, got, capacity=True)
        base = plan(inst, sched[:-3], device=device, plan_backend="pipeline",
                    seed=0, **opts).twct()
        out["plan_twct"] = base
        if not got.twct() <= base * (1 + 1e-9) + 1e-9:
            raise RuntimeError(f"{job}: twct {got.twct()} > the plan's "
                               f"{base}")
    elif kind == "online":
        res = ran(lambda: plan_online(inst, sched, driver="session",
                                      device=device, plan_backend="pipeline",
                                      seed=0, **opts))
        ss = res.stats["session"]
        out.update(twct=res.twct(), job_completions=res.job_completions,
                   reschedules=res.reschedules, jobs=len(inst.jobs),
                   session={k: ss[k] for k in (
                       "reschedules", "repairs", "full_replans",
                       "repair_rejects", "groups_reused",
                       "groups_replanned")},
                   replan_ms=[t * 1e3 for t in replans],
                   replan_wall=_quantiles(replans))
    elif kind == "gap":
        inst = gap_instance(what, d=1)
        opts = {"require_tree": False} if sched == "gdm_rt" else {}
        got = ran(lambda: plan(inst, sched, device=device,
                               plan_backend="pipeline", seed=0, **opts))
        keep_plan(inst, got)
        delta, T = gap_bounds(inst)
        opt = gap_optimal_schedule_length(what, 1)
        out.update(delta=delta, T=T, optimum=opt)
        if not (delta == T == 2 * what and got.makespan >= opt):
            raise RuntimeError(f"{job}: Delta {delta}, T {T}, makespan "
                               f"{got.makespan} against the optimum {opt}")
    elif kind == "fsp":
        p = np.random.default_rng(0).integers(1, 101, size=ZOO_FSP)
        inst = fsp_to_coflow_job(p)
        got = ran(lambda: plan(inst, sched, device=device,
                               plan_backend="pipeline", seed=0))
        keep_plan(inst, got)
        try:
            verify_schedule(inst, got.schedule)
        except AssertionError as err:
            raise RuntimeError(f"{job}: verify_schedule failed: {err}") \
                from err
    elif kind == "planner":
        cfg = ZOO_PLANNER

        def phases():
            rows, shared = [], None
            for seed in cfg["seeds"]:
                ops = planner.synthetic_collective_ops(
                    n_ops=cfg["n_ops"], seed=seed, max_mb=cfg["max_mb"])
                step = planner.coflows_from_step(ops, cfg["rows"],
                                                 cfg["cols"],
                                                 cfg["n_buckets"])
                res = planner.plan(step, device=device,
                                   plan_backend="pipeline") \
                    if shared is None else planner.plan(step, session=shared)
                shared = res.session
                rows.append({"order": res.order,
                             "planner_makespan": res.planner_makespan,
                             "naive_makespan": res.naive_makespan,
                             "makespan_gain": res.makespan_gain,
                             "jobs": step.n,
                             "coflows": sum(j.mu for j in step.jobs)})
            return rows, shared

        rows, shared = ran(phases)
        out["phases"] = rows
        out["session"] = {k: getattr(shared.stats, k) for k in (
            "reschedules", "repairs", "full_replans")}
        out["m"] = ZOO_PLANNER["rows"] * ZOO_PLANNER["cols"]
    else:
        raise ValueError(f"unknown zoo run {kind!r}")
    if cuda:
        bad = [k for k, v in out["launches"].items() if not v]
        if bad or out["host_repairs"] or out["bucket_fallbacks"] \
                or out["scalar_bna"]:
            raise RuntimeError(
                f"{job}: launches {out['launches']}, {out['host_repairs']} "
                f"host repairs, {out['bucket_fallbacks']} overflow buckets, "
                f"{out['scalar_bna']} scalar bna")
    return out


def _zoo_worker(job) -> dict:
    """_zoo_run in a spawned process, one intra-op thread."""
    import torch

    torch.set_num_threads(1)
    return _zoo_run(job)


def _zoo_jobs(device: str) -> list:
    """Phase 6g's card = CPU runs, longest first (the CPU's plain versions
    take minutes on the FB-calibrated scenarios' gdm_rt)."""
    import importlib

    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    names = importlib.import_module("repro_torch.scenarios").names()
    fb = [n for n in names if n in ("fb_like", "fb_like_rt",
                                    "online_poisson")]
    rest = [n for n in names if n not in fb]
    return [("defaults", n, "gdm_rt", device) for n in fb] \
        + [("defaults", n, s, device) for s in ("gdm", "om_alg")
           for n in fb] \
        + [("gap", k, s, device) for k in ZOO_GAP_K[::-1]
           for s in ZOO_SCHEDS] \
        + [("defaults", n, s, device) for n in rest for s in ZOO_SCHEDS] \
        + [("bf", n, s, device) for n in names for s in ZOO_BF] \
        + [("online", "online_poisson", s, device) for s in ZOO_ONLINE] \
        + [("fsp", None, "gdm_rt", device), ("planner", None, "gdm", device)]


def _serve_run(cfg_, params_, reqs, counts, admission="fifo"):
    """Serve `reqs` with 4 slots of 4096 tokens (``admission``), every
    prefill and decode_step timed (synced), the counts set to 0 just
    before (``counts`` = (zero_counts, read_counts)).  Fails unless every
    request completes with its tokens in the vocabulary.  Returns (engine,
    record)."""
    import torch

    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve import engine as serve_engine

    zero_counts, read_counts = counts
    serve_t = {"prefill_s": [], "decode_s": []}

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            serve_t[key].append(time.perf_counter() - t0)
            return out
        return wrapped

    eng_ = ServingEngine(cfg_, params_, ServeConfig(
        slots=4, capacity=4096, admission=admission))
    orig = (serve_engine.prefill, serve_engine.decode_step)
    serve_engine.prefill = timed(orig[0], "prefill_s")
    serve_engine.decode_step = timed(orig[1], "decode_s")
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = eng_.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        serve_engine.prefill, serve_engine.decode_step = orig
    n_tokens = sum(len(r.out) for r in reqs)
    if stats["completed"] != len(reqs) or any(
            len(r.out) != r.max_new or not all(0 <= t < cfg_.vocab
                                               for t in r.out)
            for r in reqs):
        _fail(f"serve {cfg_.name}: {stats} (every request must "
              "complete with its max_new tokens in the vocabulary)")
    decode_s = serve_t["decode_s"]
    return eng_, {
        "arch": cfg_.name, "requests": len(reqs),
        "prompt_lens": [len(r.tokens) for r in reqs],
        "max_new": reqs[0].max_new, "stats": stats, "wall_s": wall,
        "prefill_s": serve_t["prefill_s"],
        "decode_ms_per_token": statistics.median(decode_s) * 1e3,
        "decode_ms_per_token_mean": sum(decode_s) / len(decode_s) * 1e3,
        "decode_steps": len(decode_s), "tokens": n_tokens,
        "tokens_per_s": n_tokens / wall,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches}


def _families(dev, note_attn, counts) -> dict:
    """Phase 14b: the MoE, encoder-decoder and VLM families at full width,
    each model freed before the next.  `note_attn(got, want, q, what)`
    holds a K4 launch's output to its plain version (``ATTN_TOL``, and
    ``WGMMA_REL_TOL`` on the wgmma route);
    ``counts`` = (zero_counts, read_counts).  Returns the record."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import (decode_step, encdec_decode_step,
                                    encdec_loss, encdec_prefill,
                                    init_decode_cache, init_encdec, init_lm,
                                    init_vlm, layers, lm_forward, lm_loss,
                                    moe, prefill, vlm_loss, vlm_prefill)
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.serve import Request

    zero_counts, read_counts = counts
    bf16 = torch.bfloat16
    out: dict = {"k4_launches_per_prefill": {}}
    t_phase = time.perf_counter()

    check_peaks: dict = {}

    def checked(fn, expect: int, what: str):
        """fn() under inference mode with every K4 launch held against the
        plain version on the same q, k, v; fails unless it made `expect`.
        Its peak memory (the plain version's float32 scores included) goes
        to ``check_peaks``, and the peak is reset after it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        orig = layers.flash_attention
        n = [0]

        def check(q, k, v, *, causal=True, scale=None):
            o = orig(q, k, v, causal=causal, scale=scale)
            want = attention_ref(q, k, v, causal=causal, scale=scale)
            note_attn(o, want, q, f"{what} (Sq={q.shape[2]}, "
                      f"Sk={k.shape[2]}, causal={causal})")
            n[0] += 1
            return o

        layers.flash_attention = check
        try:
            with torch.inference_mode():
                res = fn()
            torch.cuda.synchronize()
        finally:
            layers.flash_attention = orig
        if n[0] != expect:
            _fail(f"{what}: {n[0]} flash_attention launches, expected "
                  f"{expect}")
        check_peaks[what] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return res

    def counted(fn):
        """fn() under inference mode, the counts set to 0 just before and
        read just after -> (result, wall s, counts)."""
        with torch.inference_mode():
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return res, wall, read_counts()

    def routed(fn, keep_input_of: int = -1):
        """fn() with every MoE routing noted: per layer, the pairs dropped,
        the tokens with a dropped pair and the capacity; and the input of
        MoE layer `keep_input_of` (counted from 0)."""
        orig_route, orig_ffn = moe.moe_route, moe.moe_ffn
        drops: list = []
        kept: dict = {}

        def route(cfg_, router, xt):
            r = orig_route(cfg_, router, xt)
            lost = (r["pair_slot"] == cfg_.moe.n_experts * r["C"]) \
                .view(-1, cfg_.moe.top_k)
            drops.append({"pairs": int(lost.sum()),
                          "tokens": int(lost.any(1).sum()), "C": r["C"]})
            return r

        def ffn(cfg_, p, x):
            if len(drops) == keep_input_of:
                kept["x"] = x.clone()
            return orig_ffn(cfg_, p, x)

        moe.moe_route, moe.moe_ffn = route, ffn
        try:
            res = fn()
        finally:
            moe.moe_route, moe.moe_ffn = orig_route, orig_ffn
        return res, drops, kept.get("x")

    def versus_cpu(what: str, fn, params, args, tol=LOGIT_TOL) -> dict:
        """fn(params, *args) -> logits (B, V) on the card and on CPU copies
        of the same weights and inputs: within `tol` of the largest."""
        with torch.inference_mode():
            card = fn(params, *args).float().cpu()
            p_cpu = tree_map(lambda x: x.cpu(), params)
            a_cpu = [a.cpu() for a in args]
            t0 = time.perf_counter()
            host = fn(p_cpu, *a_cpu).float()
            cpu_s = time.perf_counter() - t0
        del p_cpu, a_cpu
        diff = float((card - host).abs().max())
        top = float(host.abs().max())
        row = {"max_abs_diff": diff, "max_abs_logit": top, "tol": tol,
               "argmax_agrees": bool((card.argmax(-1)
                                      == host.argmax(-1)).all()),
               "cpu_s": cpu_s}
        if not (np.isfinite(diff) and diff <= tol * top):
            _fail(f"{what}, card vs CPU: max |diff| {diff} > {tol} x {top}")
        return row

    def finite(what: str, t) -> None:
        if not bool(torch.isfinite(t).all()):
            _fail(f"{what}: not all finite")

    def init(fn, cfg):
        """fn(cfg, generator) with a fresh seed-0 generator on the card,
        the previous model freed -> (params, record: parameters, init s,
        its peak memory).  The peak is reset after it: each model's peak
        counts its run, not its float32 draws."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = fn(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        rec = {"params": sum(x.numel() for x in tree_leaves(params)),
               "init_s": time.perf_counter() - t0,
               "init_peak": torch.cuda.max_memory_allocated()}
        torch.cuda.reset_peak_memory_stats()
        return params, rec

    def tokens(rng, cfg, shape):
        return torch.as_tensor(rng.integers(1, cfg.vocab, size=shape),
                               device=dev)

    def shifted(t):
        labels = t.roll(-1, dims=1)
        labels[:, -1] = -1
        return labels

    def pad_kv(cache, cap: int) -> dict:
        return {"layers": {n: {k: F.pad(t, (0, 0, 0, 0, 0,
                                            cap - t.shape[2]))
                               if k in ("k", "v") else t
                               for k, t in leaves.items()}
                           for n, leaves in cache["layers"].items()},
                "length": cache["length"]}

    def decode(step, cache, first, n: int):
        """n greedy decode steps from token `first`, each timed (synced):
        -> (ms per step, median; the logits of the last)."""
        times = []
        tok = first
        with torch.inference_mode():
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = step(cache, tok)
                tok = torch.argmax(lg, dim=-1, keepdim=True)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finite("decode", lg)
        return statistics.median(times) * 1e3, times

    # (a) granite-moe-3b served at full width: the slice's path ------------
    t_a = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    params, rec = init(init_lm, cfg)
    srng = np.random.default_rng(0)
    reqs = [Request(rid=i, tokens=srng.integers(
        1, cfg.vocab, size=int(srng.integers(512, 3073))), max_new=32,
        weight=float(srng.uniform(0.5, 2.0)), arrival=float(i // 2))
        for i in range(8)]
    first = torch.as_tensor(reqs[0].tokens, device=dev)[None]
    checked(lambda: prefill(cfg, params, first), cfg.n_layers,
            f"{cfg.name} prefill")
    _, pre_s, c = counted(lambda: prefill(cfg, params, first))
    out["k4_launches_per_prefill"][cfg.name] = c["flash_attention"]
    _, run = _serve_run(cfg, params, reqs, counts)
    if run["launches"]["flash_attention"] != cfg.n_layers * len(reqs):
        _fail(f"serve {cfg.name}: {run['launches']} launches, expected "
              f"{cfg.n_layers} flash_attention launches per prefill")
    # the routing of a 2048-token prompt: pairs dropped per layer, and one
    # layer's input through moe_ffn on the card and on the CPU
    rng = np.random.default_rng(21)
    long = tokens(rng, cfg, (1, LOSS_S))
    L = cfg.n_layers // 2
    with torch.inference_mode():
        _, drops, x_l = routed(lambda: prefill(cfg, params, long), L)
        p_l = tree_map(lambda t: t[L], params["stack"]["l0"]["moe"])
        xt = x_l.reshape(-1, cfg.d_model)
        r_card = moe.moe_route(cfg, p_l["router"], xt)
        y_card = moe.moe_ffn(cfg, p_l, x_l)[0].float().cpu()
        p_cpu = tree_map(lambda t: t.cpu(), p_l)
        r_cpu = moe.moe_route(cfg, p_cpu["router"], xt.cpu())
        y_cpu = moe.moe_ffn(cfg, p_cpu, x_l.cpu())[0].float()
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    idx_c, idx_h = r_card["idx"].cpu(), r_cpu["idx"]
    kept_c = (r_card["pair_slot"].cpu() != E * r_card["C"]).view(-1, k)
    kept_h = (r_cpu["pair_slot"] != E * r_cpu["C"]).view(-1, k)
    same = (idx_c == idx_h).all(1) & (kept_c == kept_h).all(1)
    y_rel = float((y_card[0][same] - y_cpu[0][same]).abs().max()) \
        / float(y_cpu.abs().max())
    layer_check = {
        "layer": L, "tokens": int(xt.shape[0]), "C": r_card["C"],
        "equal_expert_share": float((idx_c == idx_h).float().mean()),
        "equal_kept_share": float((kept_c == kept_h).float().mean()),
        "tokens_routed_alike": int(same.sum()),
        "y_max_rel_diff_where_routed_alike": y_rel,
        "pairs_dropped": int((~kept_c).sum())}
    if layer_check["equal_expert_share"] < 0.99 or \
            layer_check["equal_kept_share"] < 0.99 or \
            not y_rel <= LOGIT_TOL:
        _fail(f"{cfg.name} layer {L}'s MoE, card vs CPU: {layer_check}")
    del p_cpu, x_l, xt
    loss, loss_s, c = counted(lambda: lm_loss(cfg, params, long,
                                              shifted(long)))
    finite(f"{cfg.name} lm_loss", loss)
    if c["flash_attention"] != cfg.n_layers:
        _fail(f"{cfg.name} lm_loss: {c} launches")
    cmp = versus_cpu(f"{cfg.name} 64-token prefill",
                     lambda p, t: prefill(cfg, p, t)[0], params,
                     [tokens(np.random.default_rng(9), cfg, (1, 64))])
    out["granite"] = {
        "arch": cfg.name, **rec, "serve": run, "prefill_s": pre_s,
        "layer_check": layer_check, "drops_2048": drops,
        "loss": float(loss), "loss_s": loss_s,
        "peak": torch.cuda.max_memory_allocated(), "cpu_compare": cmp,
        "wall_s": time.perf_counter() - t_a}
    print(f"14b(a) serve {cfg.name} (full width, "
          f"{out['granite']['params']} parameters, bf16; init "
          f"{rec['init_s']:.2f} s): {run['stats']}, "
          f"{run['tokens']} tokens in {run['wall_s']:.2f} s "
          f"({run['tokens_per_s']:.1f} tokens/s); prefill s per request "
          f"{[round(x, 4) for x in run['prefill_s']]} for prompts "
          f"{run['prompt_lens']}; decode ms per token (median) "
          f"{run['decode_ms_per_token']:.2f}; peak memory "
          f"{run['max_memory_allocated'] / 2**30:.2f} GiB; launches "
          f"{run['launches']}; MoE layer {L} card vs CPU {layer_check}; "
          f"pairs dropped per layer at S={LOSS_S} "
          f"{[d['pairs'] for d in drops]} (C={drops[0]['C']}); lm_loss "
          f"{float(loss):.4f} in {loss_s:.3f} s; 64-token logits card vs "
          f"CPU {cmp}")
    del params, loss, long
    # (b) qwen3-moe-235b, full width, depth cut ----------------------------
    t_b = time.perf_counter()
    arch, depth = WIDE_MOE
    full = get_config(arch)
    cfg = full.replace(n_periods=depth)
    params, rec = init(init_lm, cfg)
    t = tokens(np.random.default_rng(22), cfg, (1, LOSS_S))
    (lg, aux), drops, _ = checked(lambda: routed(
        lambda: lm_forward(cfg, params, t)), cfg.n_layers,
        f"{cfg.name} lm_forward")
    if tuple(lg.shape) != (1, LOSS_S, cfg.padded_vocab):
        _fail(f"{cfg.name} lm_forward: logits {tuple(lg.shape)}")
    finite(f"{cfg.name} lm_forward", lg)
    del lg
    _, fwd_s, fwd_c = counted(lambda: float(lm_forward(cfg, params, t)[1]))
    loss, loss_s, loss_c = counted(lambda: lm_loss(cfg, params, t,
                                                   shifted(t)))
    finite(f"{cfg.name} lm_loss", loss)
    out["qwen3_moe"] = {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "full_n_layers": full.n_layers, **rec,
        "full_params": full.param_count(), "forward_s": fwd_s,
        "forward_launches": fwd_c, "aux": float(aux), "loss": float(loss),
        "loss_s": loss_s, "loss_launches": loss_c, "drops_2048": drops,
        "peak": torch.cuda.max_memory_allocated(),
        "wall_s": time.perf_counter() - t_b}
    print(f"14b(b) {cfg.name} at full width, depth cut to {cfg.n_layers} "
          f"of {full.n_layers} layers ({out['qwen3_moe']['params']} of "
          f"{out['qwen3_moe']['full_params']} parameters, bf16), B=1, "
          f"S={LOSS_S}: lm_forward {fwd_s:.3f} s, lm_loss "
          f"{float(loss):.4f} in {loss_s:.3f} s, aux {float(aux):.4f}, "
          f"pairs dropped per layer {[d['pairs'] for d in drops]} "
          f"(C={drops[0]['C']}), peak memory "
          f"{out['qwen3_moe']['peak'] / 2**30:.2f} GiB (init "
          f"{rec['init_peak'] / 2**30:.2f} GiB, checked lm_forward "
          f"{check_peaks[f'{cfg.name} lm_forward'] / 2**30:.2f} GiB)")
    del params, loss, aux, t
    # (c) jamba-1.5-large's smoke config: card vs CPU, teacher forcing -----
    t_c = time.perf_counter()
    cfg = get_config(HYBRID_ARCH).smoke()
    params, _ = init(init_lm, cfg)
    t = tokens(np.random.default_rng(23), cfg, (2, 64))
    n_attn = cfg.n_periods * sum(s.kind == "attn" for s in cfg.period)
    (lg, aux), _, c = counted(lambda: lm_forward(cfg, params, t))
    if (c["flash_attention"], c["ssd_scan"]) != \
            (n_attn, cfg.n_layers - n_attn):
        _fail(f"{cfg.name} lm_forward: {c} launches, expected {n_attn} "
              f"flash_attention and {cfg.n_layers - n_attn} ssd_scan")
    V = cfg.vocab
    jcmp = versus_cpu(f"{cfg.name} lm_forward",
                      lambda p, x: lm_forward(cfg, p, x)[0][:, -1, :V],
                      params, [t], tol=LOGIT_TOL_F32)
    with torch.inference_mode():
        p_cpu = tree_map(lambda x: x.cpu(), params)
        aux_cpu = lm_forward(cfg, p_cpu, t.cpu())[1]
        loss_pair = [float(lm_loss(cfg, p, x, shifted(x)))
                     for p, x in ((params, t), (p_cpu, t.cpu()))]
        del p_cpu
        P = 48
        plg, pc = prefill(cfg, params, t[:, :P])
        cache = init_decode_cache(cfg, 2, t.shape[1], device=dev)
        for name, leaves in pc["layers"].items():
            for key, x in leaves.items():
                if key in ("k", "v"):
                    cache["layers"][name][key][:, :, :P] = x
                else:
                    cache["layers"][name][key].copy_(x)
        cache = {"layers": cache["layers"], "length": pc["length"]}
        errs = [float((plg - lg[:, P - 1, :V]).abs().max())]
        for i in range(P, t.shape[1]):
            plg, cache = decode_step(cfg, params, cache, t[:, i:i + 1])
            errs.append(float((plg - lg[:, i, :V]).abs().max()))
    aux_diff = abs(float(aux) - float(aux_cpu))
    loss_diff = abs(loss_pair[0] - loss_pair[1])
    if not (max(errs) < TF_ABS_TOL and aux_diff < 1e-4 and loss_diff < 1e-4):
        _fail(f"{cfg.name}: teacher forcing max |diff| {max(errs)} (< "
              f"{TF_ABS_TOL}), aux card vs CPU {aux_diff}, lm_loss "
              f"{loss_pair} (< 1e-4)")
    out["jamba"] = {"arch": cfg.name, "launches": c, "cpu_compare": jcmp,
                    "aux_diff": aux_diff, "loss": loss_pair,
                    "teacher_forcing_max_abs_diff": max(errs),
                    "positions": len(errs),
                    "wall_s": time.perf_counter() - t_c}
    print(f"14b(c) {cfg.name} (float32): lm_forward launches {c}; "
          f"last-position logits card vs CPU {jcmp}; aux |diff| "
          f"{aux_diff:.3g}; lm_loss card, CPU {loss_pair}; teacher forcing "
          f"(prefill {P}, decode {len(errs) - 1}) max |diff| "
          f"{max(errs):.3g} (< {TF_ABS_TOL})")
    del params, lg, cache, pc
    # (d) whisper-large-v3 at full width -----------------------------------
    t_d = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    params, rec = init(init_encdec, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev).to(bf16)
    rng = np.random.default_rng(24)
    prompt = tokens(rng, cfg, (1, ENCDEC_PROMPT))
    cap = ENCDEC_PROMPT + ENCDEC_DECODE
    n_k4 = cfg.n_encoder_layers + 2 * cfg.n_periods
    checked(lambda: encdec_prefill(cfg, params, frames, prompt,
                                   capacity=cap), n_k4,
            f"{cfg.name} encdec_prefill")
    (lg, cache), pre_s, c = counted(lambda: encdec_prefill(
        cfg, params, frames, prompt, capacity=cap))
    out["k4_launches_per_prefill"][cfg.name] = c["flash_attention"]
    if c["flash_attention"] != n_k4:
        _fail(f"{cfg.name} encdec_prefill: {c} launches, expected {n_k4}")
    dec_ms, _ = decode(lambda ca, x: encdec_decode_step(cfg, params, ca, x),
                       cache, torch.argmax(lg, -1, keepdim=True),
                       ENCDEC_DECODE)
    del cache
    t_loss = tokens(rng, cfg, (1, ENCDEC_LOSS))
    loss, loss_s, loss_c = counted(lambda: encdec_loss(
        cfg, params, frames, t_loss, shifted(t_loss)))
    finite(f"{cfg.name} encdec_loss", loss)
    cut = cfg.replace(n_encoder_layers=2, n_periods=2)
    pcut = dict(params, **{s: tree_map(lambda x: x[:2], params[s])
                           for s in ("enc_stack", "dec_stack")})
    wcmp = versus_cpu(f"{cut.name} cut to 2 + 2 layers, prefill",
                      lambda p, f, x: encdec_prefill(cut, p, f, x,
                                                     capacity=cap)[0],
                      pcut, [frames, prompt])
    out["whisper"] = {
        "arch": cfg.name, **rec, "prefill_s": pre_s,
        "prefill_launches": c, "decode_ms_per_token": dec_ms,
        "decode_steps": ENCDEC_DECODE, "loss": float(loss),
        "loss_s": loss_s, "loss_tokens": ENCDEC_LOSS,
        "loss_launches": loss_c, "cpu_compare_cut": wcmp,
        "peak": torch.cuda.max_memory_allocated(),
        "wall_s": time.perf_counter() - t_d}
    print(f"14b(d) {cfg.name} (full width, {out['whisper']['params']} "
          f"parameters, bf16): encdec_prefill of {cfg.encoder_seq} frames "
          f"and {ENCDEC_PROMPT} tokens {pre_s:.3f} s ({c['flash_attention']}"
          f" flash_attention launches), decode ms per token (median of "
          f"{ENCDEC_DECODE}) {dec_ms:.2f}, encdec_loss on {ENCDEC_LOSS} "
          f"tokens {float(loss):.4f} in {loss_s:.3f} s; cut to 2 + 2 "
          f"layers, card vs CPU {wcmp}; peak memory "
          f"{out['whisper']['peak'] / 2**30:.2f} GiB (init "
          f"{rec['init_peak'] / 2**30:.2f} GiB, checked prefill "
          f"{check_peaks[f'{cfg.name} encdec_prefill'] / 2**30:.2f} GiB)")
    del params, pcut, frames, loss, lg
    # (e) llava-next-mistral-7b at full width ------------------------------
    t_e = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    params, rec = init(init_vlm, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    patches = torch.randn((1, cfg.n_image_tokens, cfg.d_model),
                          generator=gen, device=dev).to(bf16)
    text = tokens(np.random.default_rng(25), cfg, (1, VLM_TEXT))
    checked(lambda: vlm_prefill(cfg, params, patches, text), cfg.n_layers,
            f"{cfg.name} vlm_prefill")
    (lg, cache), pre_s, c = counted(lambda: vlm_prefill(cfg, params,
                                                        patches, text))
    out["k4_launches_per_prefill"][cfg.name] = c["flash_attention"]
    n_seq = cfg.n_image_tokens + VLM_TEXT
    if c["flash_attention"] != cfg.n_layers or cache["length"] != n_seq:
        _fail(f"{cfg.name} vlm_prefill: {c} launches, cache length "
              f"{cache['length']}")
    dec_ms, _ = decode(lambda ca, x: decode_step(cfg, params, ca, x),
                       pad_kv(cache, n_seq + VLM_DECODE),
                       torch.argmax(lg, -1, keepdim=True), VLM_DECODE)
    del cache
    loss, loss_s, loss_c = counted(lambda: vlm_loss(
        cfg, params, patches, text, shifted(text)))
    finite(f"{cfg.name} vlm_loss", loss)
    cut = cfg.replace(n_periods=2)
    pcut = dict(params, stack=tree_map(lambda x: x[:2], params["stack"]))
    vcmp = versus_cpu(
        f"{cut.name} cut to 2 layers, prefill",
        lambda p, pa, x: vlm_prefill(cut, p, pa, x)[0], pcut,
        [patches[:, :VLM_CPU[0]], text[:, :VLM_CPU[1]]])
    out["llava"] = {
        "arch": cfg.name, **rec, "prefill_s": pre_s,
        "prefill_launches": c, "sequence": n_seq,
        "decode_ms_per_token": dec_ms, "decode_steps": VLM_DECODE,
        "loss": float(loss), "loss_s": loss_s, "loss_launches": loss_c,
        "cpu_compare_cut": {**vcmp, "inputs": list(VLM_CPU)},
        "peak": torch.cuda.max_memory_allocated(),
        "wall_s": time.perf_counter() - t_e}
    print(f"14b(e) {cfg.name} (full width, {out['llava']['params']} "
          f"parameters, bf16): vlm_prefill of {cfg.n_image_tokens} patches "
          f"and {VLM_TEXT} tokens {pre_s:.3f} s ({c['flash_attention']} "
          f"flash_attention launches), decode ms per token (median of "
          f"{VLM_DECODE}) {dec_ms:.2f}, vlm_loss {float(loss):.4f} in "
          f"{loss_s:.3f} s; cut to 2 layers ({VLM_CPU[0]} patches, "
          f"{VLM_CPU[1]} tokens), card vs CPU {vcmp}; peak memory "
          f"{out['llava']['peak'] / 2**30:.2f} GiB (init "
          f"{rec['init_peak'] / 2**30:.2f} GiB, checked prefill "
          f"{check_peaks[f'{cfg.name} vlm_prefill'] / 2**30:.2f} GiB)")
    del params, pcut, patches, loss, lg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["check_peaks"] = check_peaks
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"14b: (a)-(e) took {out['wall_s']:.1f} s; K4 launches per "
          f"prefill {out['k4_launches_per_prefill']}")
    return out


def attn_bwd_bound(B, Hq, Hkv, Sq, Sk, d, causal, products=5,
                   nbytes=2) -> dict:
    """The least time of (part of) K4's backward: `products` products of
    2 d flops a kept (query, key) pair and head (5 for the whole backward:
    S, dP, dV, dQ and dK), at the bf16 peak; or q, k, v, o and dO read and
    dq, dk and dv written once, lse and D read, over the memory rate."""
    pairs = Sq * Sk - (Sq * (Sq - 1) // 2 if causal else 0)
    ops = products * 2 * B * Hq * pairs * d
    moved = nbytes * d * B * (4 * Hq * Sq + 4 * Hkv * Sk) + 8 * B * Hq * Sq
    bound = {"operations": ops / BF16_FLOPS * 1e3,
             "bytes": moved / HBM_BYTES_PER_S * 1e3}
    by = max(bound, key=bound.get)
    return {"bound_ms": bound[by], "bound_by": by, "flops": ops}


def _train_full_width(dev, counts, arch, steps, seq, batch,
                      per_step) -> tuple:
    """Train `arch` at its published full width through
    ``repro_torch.launch.train``'s ``main`` for `steps` steps of `batch` x
    `seq` tokens with ``--plan-buckets``, the counts set to 0 just before
    and read just after.  Fails unless every loss and grad norm is finite,
    each wrapper of `per_step` (name -> launches a step) ran that many
    times a step, the bucket plan ran on the card's pipeline, the model
    computed in bf16 and K4's and K5's forwards read every operand by TMA
    as it lay (``check_staged``).  Returns (the launcher's result, the
    run's record)."""
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.lm import tree_leaves

    zero_counts, read_counts = counts
    cfg = get_config(arch)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)     # no resume
    argv = ["--arch", arch, "--steps", str(steps), "--seq-len", str(seq),
            "--global-batch", str(batch), "--plan-buckets",
            str(TRAIN_BUCKETS), "--ckpt-every", str(steps + 1),
            "--ckpt-dir", str(ckpt_dir), "--seed", "0", "--device",
            dev.type]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    zero_staged()
    t0 = time.perf_counter()
    res = launch_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    staged = check_staged(f"{arch} training")
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log = res["runner"].metrics_log
    if len(log) != steps:
        _fail(f"{arch} training ran {len(log)} steps, not {steps}")
    for r in log:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            _fail(f"{arch} training step {r['step']}: loss {r['loss']}, "
                  f"grad norm {r['grad_norm']}")
    for name, n in per_step.items():
        if launches[name] != n * steps:
            _fail(f"{arch} training launched {name} {launches[name]} times, "
                  f"not {n} a step x {steps}")
    if launches["bna_decompose"] < 1 or launches["merge_fix"] < 1:
        _fail(f"{arch}'s bucket plan did not run on the card's pipeline: "
              f"{launches}")
    if cfg.compute_dtype != "bfloat16":
        _fail(f"{arch} trained in {cfg.compute_dtype}, not bf16")
    walls = [r["time_s"] for r in log]
    step_s = statistics.median(walls[1:])
    return res, {
        "arch": cfg.name, "params": sum(x.numel() for x in
                                        tree_leaves(res["state"].params)),
        "seq_len": seq, "global_batch": batch, "steps": steps,
        "remat": cfg.remat, "loss_chunk": cfg.loss_chunk, "step_s": walls,
        "step_s_median_2_4": step_s, "first_step_s": walls[0],
        "tokens_per_s": seq * batch / step_s,
        "loss": [r["loss"] for r in log],
        "grad_norm": [r["grad_norm"] for r in log],
        "max_memory_allocated": peak, "wall_s": wall, "launches": launches,
        "forward_staged_copies": staged,
        "launches_per_step": {k: launches[k] / steps for k in per_step},
        "planned_buckets": len(res["outcome"].order),
        "bucket_order": res["outcome"].order,
        "bucket_makespan_gain_pct": res["summary"][
            "bucket_makespan_gain_pct"],
        "plan_s": res["plan_s"]}


def _training(dev, counts) -> dict:
    """Phase 16: training.  (a) qwen3-1.7b at full width through
    ``repro_torch.launch.train``'s ``main`` (the counts set to 0 just
    before and read just after); (b) K4's backward kernels against
    ``attention_bwd_ref`` (one layer of a real step, the grid of shapes)
    and timed; (c) card against CPU and crash/resume.
    ``counts`` = (zero_counts, read_counts).  Returns the record."""
    import gc
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.ft import FTConfig, TrainRunner
    from repro_torch.kernels.flash_attention import (attn_bwd_dkdv,
                                                     attn_bwd_dq,
                                                     attn_bwd_prep,
                                                     flash_attention,
                                                     flash_attention_lse)
    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_prep_ref, attention_bwd_ref)
    from repro_torch.models import layers
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import (TrainState, _value_and_grad,
                                        build_train_step, init_params,
                                        init_train_state, leaf_paths,
                                        loss_for)

    out: dict = {"max_abs_err": {k: 0.0 for k in BWD_KERNELS},
                 "checked": {k: 0 for k in BWD_KERNELS}}
    t_phase = time.perf_counter()

    def free() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # (a) qwen3-1.7b trained at full width through the launcher -----------
    cfg = get_config(TRAIN_ARCH)
    staged0 = (attn_bwd_dkdv.staged, attn_bwd_dq.staged)
    res, out["train"] = _train_full_width(
        dev, counts, TRAIN_ARCH, TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH,
        {"flash_attention": 2 * cfg.n_layers,         # remat="full"
         **{k: cfg.n_layers for k in BWD_KERNELS}})
    staged = {"attn_bwd_dkdv": attn_bwd_dkdv.staged - staged0[0],
              "attn_bwd_dq": attn_bwd_dq.staged - staged0[1]}
    # bf16 operands, as the step hands them (transpose(1, 2) views), go to
    # the wgmma kernels by TMA as they lie: no staged copy
    if any(staged.values()):
        _fail(f"the training step's backward did not read its operands "
              f"by TMA as they lie: staged copies {staged}")
    out["train"]["staged_copies"] = staged
    out["train"]["summary"] = res["summary"]
    walls, step_s = out["train"]["step_s"], out["train"]["step_s_median_2_4"]
    peak, outcome = out["train"]["max_memory_allocated"], res["outcome"]
    print(f"16(a) {cfg.name} trained at full width "
          f"({out['train']['params']} parameters, bf16, remat "
          f"{cfg.remat}) through repro_torch.launch.train, {TRAIN_STEPS} "
          f"steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: step s "
          f"{[round(w, 4) for w in walls]} (median of 2-{TRAIN_STEPS} "
          f"{step_s:.4f}, {out['train']['tokens_per_s']:.0f} tokens/s), "
          f"loss {[round(x, 4) for x in out['train']['loss']]}, grad norm "
          f"{[round(x, 4) for x in out['train']['grad_norm']]}, peak "
          f"{peak / 2**30:.2f} GiB; buckets planned in "
          f"{res['plan_s']:.3f} s, order {outcome.order}, makespan gain "
          f"{out['train']['bucket_makespan_gain_pct']}%; launches a step "
          f"{out['train']['launches_per_step']}, staged copies {staged}")

    # (b) one layer of a real step at B = 1, S = TRAIN_SEQ: layer 0's q, k,
    # v and the gradient that reaches its output
    params = res["state"].params
    del res
    free()
    batch = SyntheticTokens(cfg, DataConfig(TRAIN_SEQ, 1, seed=1),
                            device=dev).batch_at(0)
    seen: dict = {}
    orig = layers.flash_attention

    def capture(q, k, v, **kw):
        o = orig(q, k, v, **kw)
        if "q" not in seen and o.requires_grad:
            seen.update(q=q.detach().clone(), k=k.detach().clone(),
                        v=v.detach().clone())
            o.register_hook(lambda g: seen.setdefault("do", g.clone()))
        return o

    # the same step's forward and backward under the profiler: every K4
    # forward (2 a layer under remat "full") runs the wgmma kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    layers.flash_attention = capture
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _value_and_grad(loss_for(cfg), params, batch)
            torch.cuda.synchronize()
    finally:
        layers.flash_attention = orig
    n_wgmma = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and K4_FWD_WGMMA in e.key)
    out["profiled_step_k4_fwd_wgmma"] = n_wgmma
    if n_wgmma != 2 * cfg.n_layers:
        _fail(f"a profiled {cfg.name} training step launched "
              f"{K4_FWD_WGMMA} {n_wgmma} times, expected {2 * cfg.n_layers}")
    del params, prof
    free()

    def check_bwd(q, k, v, do, causal, what):
        """K4's backward kernels on (q, k, v, do) against the plain
        version: dq, dk, dv each within ATTN_BWD_TOL of the largest
        |gradient|, dq 0 on rows that see no key; D against its plain
        version (on the kernel's output) within 1e-5 of its largest |D|,
        on the rows that see a key."""
        name = str(q.dtype).split(".")[-1]
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        D = attn_bwd_prep(o, do)
        dk, dv = attn_bwd_dkdv(q, k, v, do, lse, D, causal=causal,
                               scale=q.shape[3] ** -0.5)
        dq = attn_bwd_dq(q, k, v, do, lse, D, causal=causal,
                         scale=q.shape[3] ** -0.5)
        wq, wk, wv = attention_bwd_ref(q, k, v, do, causal=causal)
        wD = attention_bwd_prep_ref(o, do)
        Sq, Sk = q.shape[2], k.shape[2]
        sees = (torch.arange(Sq, device=q.device) + Sk - Sq >= 0) \
            if causal else torch.ones(Sq, dtype=torch.bool, device=q.device)
        scale = max(float(w.float().abs().max()) for w in (wq, wk, wv)) \
            or 1.0
        errs = {"attn_bwd_dq": float((dq[:, :, sees].float()
                                      - wq[:, :, sees].float()).abs().max())
                if bool(sees.any()) else 0.0,
                "attn_bwd_dkdv": max(float((dk.float() - wk.float()).abs()
                                           .max()),
                                     float((dv.float() - wv.float()).abs()
                                           .max())),
                "attn_bwd_prep": float((D[:, :, sees] - wD[:, :, sees])
                                       .abs().max())
                if bool(sees.any()) else 0.0}
        d_scale = max(float(wD[:, :, sees].abs().max()), 1.0) \
            if bool(sees.any()) else 1.0
        if bool(dq[:, :, ~sees].any()):
            _fail(f"attn_bwd_dq wrote a nonzero gradient on a row that sees "
                  f"no key ({what})")
        tol = {"attn_bwd_dq": ATTN_BWD_TOL[name] * scale,
               "attn_bwd_dkdv": ATTN_BWD_TOL[name] * scale,
               "attn_bwd_prep": 1e-5 * d_scale}
        for key, err in errs.items():
            rel = err / (scale if key != "attn_bwd_prep" else d_scale)
            out["max_abs_err"][key] = max(out["max_abs_err"][key], err)
            out["checked"][key] += 1
            out.setdefault("max_rel_err", {}).setdefault(key, 0.0)
            out["max_rel_err"][key] = max(out["max_rel_err"][key], rel)
            if not err <= tol[key]:
                _fail(f"{key} != plain version on {what} ({name}, max "
                      f"|diff| {err} > {tol[key]})")

    if seen["q"].dtype != torch.bfloat16:
        _fail(f"layer 0's attention ran in {seen['q'].dtype}, not bf16")
    q1, k1, v1, do1 = (seen[x][:1] for x in ("q", "k", "v", "do"))
    check_bwd(q1, k1, v1, do1, True,
              f"layer 0 of a {cfg.name} training step, B=1, S={TRAIN_SEQ}")
    out["real_layer"] = {"shape": list(q1.shape), "kv_shape":
                         list(k1.shape), "dtype": str(q1.dtype)}
    del seen, q1, k1, v1, do1
    free()
    rng = np.random.default_rng(16)
    n_grid = 0
    for shape in ATTN_BWD_SHAPES:
        B, Hq, Hkv, Sq, Sk, d = shape
        arrays = [rng.normal(size=sz).astype(np.float32)
                  for sz in ((B, Hq, Sq, d), (B, Hkv, Sk, d),
                             (B, Hkv, Sk, d), (B, Hq, Sq, d))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.as_tensor(a).to(dev, dtype)
                           for a in arrays)
            for causal in (True, False):
                check_bwd(q, k, v, do, causal,
                          f"shape {shape}, causal={causal}")
                n_grid += 1
    free()
    print(f"16(b) K4's backward kernels within tolerance of "
          f"attention_bwd_ref on layer 0 of a {cfg.name} training step "
          f"(B=1, S={TRAIN_SEQ}, bf16) and {n_grid} grid cases "
          f"({len(ATTN_BWD_SHAPES)} shapes x f32/bf16 x causal or not); "
          f"max |diff| {out['max_abs_err']}, relative to the largest "
          f"|gradient| {out['max_rel_err']}")

    # the backward at the training shape and at a d = 64 shape: each
    # kernel, the whole, SDPA's backward and (training shape) the plain
    # version; two runs of the training shape's backward give the same bits
    lib = kernels.load_kernel("flash_attention")

    def time_bwd(shape, plain: bool) -> dict:
        B, Hq, Hkv, S, _, d = shape
        g = torch.Generator(device=dev).manual_seed(S)
        q, k, v, do = (torch.randn(sz, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for sz in ((B, Hq, S, d), (B, Hkv, S, d),
                                  (B, Hkv, S, d), (B, Hq, S, d)))
        sc = d ** -0.5
        o, lse = flash_attention_lse(q, k, v, scale=sc)
        D = attn_bwd_prep(o, do)
        staged0 = (attn_bwd_dkdv.staged, attn_bwd_dq.staged)
        tm = {
            "shape": list(shape), "dtype": "bfloat16", "causal": True,
            "attn_bwd_prep": _cuda_ms(lambda: attn_bwd_prep(o, do), reps=5,
                                      rounds=3),
            "attn_bwd_dkdv": _cuda_ms(lambda: attn_bwd_dkdv(
                q, k, v, do, lse, D, causal=True, scale=sc), reps=5,
                rounds=3),
            "attn_bwd_dq": _cuda_ms(lambda: attn_bwd_dq(
                q, k, v, do, lse, D, causal=True, scale=sc), reps=5,
                rounds=3),
            "fwd_lse_ms": _cuda_ms(lambda: flash_attention_lse(
                q, k, v, scale=sc), reps=5, rounds=3),
            "prep_plain_ms": _cuda_ms(lambda: attention_bwd_prep_ref(o, do),
                                      reps=5, rounds=3)}
        if (attn_bwd_dkdv.staged, attn_bwd_dq.staged) != staged0:
            _fail(f"K4's backward staged a copy of contiguous operands at "
                  f"{shape}")
        tm["bwd_ms"] = sum(tm[x] for x in BWD_KERNELS)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa(grad: bool):
            if not grad:
                with torch.no_grad():
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=sc, enable_gqa=True)
            o2 = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                scale=sc, enable_gqa=True)
            return torch.autograd.grad(o2, (qs, ks, vs), do)

        tm["library_fwd_ms"] = _cuda_ms(lambda: sdpa(False), reps=5,
                                        rounds=3)
        tm["library_fwd_bwd_ms"] = _cuda_ms(lambda: sdpa(True), reps=5,
                                            rounds=3)
        tm["library_ms"] = tm["library_fwd_bwd_ms"] - tm["library_fwd_ms"]
        if plain:
            tm["plain_ms"] = _cuda_ms(lambda: attention_bwd_ref(
                q, k, v, do, scale=sc), reps=1, rounds=2)
            runs = [(*attn_bwd_dkdv(q, k, v, do, lse, D, causal=True,
                                    scale=sc),
                     attn_bwd_dq(q, k, v, do, lse, D, causal=True, scale=sc))
                    for _ in range(2)]
            tm["same_bits"] = all(torch.equal(x, y)
                                  for x, y in zip(*runs))
            if not tm["same_bits"]:
                _fail(f"two runs of K4's backward at {shape} gave different "
                      f"bits")
            del runs
        tm.update(attn_bwd_bound(B, Hq, Hkv, S, S, d, True))
        fwd = attn_fwd_bounds(B, Hq, Hkv, S, S, d, True, lse=True)
        tm["fwd_lse_bound_by"] = fwd["bound_by"]
        tm["fwd_lse_bound_ms"] = fwd["bound_ms"]
        tm["bounds"] = {
            "attn_bwd_prep": {"bound_ms": 2 * 2 * B * Hq * S * d
                              / HBM_BYTES_PER_S * 1e3 + 4 * B * Hq * S
                              / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"},
            "attn_bwd_dkdv": attn_bwd_bound(B, Hq, Hkv, S, S, d, True, 4),
            "attn_bwd_dq": attn_bwd_bound(B, Hq, Hkv, S, S, d, True, 3)}
        tm["share_of_bound"] = {x: tm["bounds"][x]["bound_ms"] / tm[x]
                                for x in BWD_KERNELS}
        tm["tflops"] = tm["flops"] / tm["bwd_ms"] / 1e9
        tm["vs_library"] = tm["bwd_ms"] / tm["library_ms"]
        tm["attributes"] = {
            name: _attributes(lib.attn_bwd_attributes, 1, which, d)
            for name, which in (("attn_bwd_prep", 0), ("attn_bwd_dkdv", 1),
                                ("attn_bwd_dq", 2))}
        del q, k, v, do, o, lse, D, qs, ks, vs
        free()
        kern = "; ".join(
            f"{x} {tm[x]:.4f} ms (bound {tm['bounds'][x]['bound_ms']:.4f} ms "
            f"by {tm['bounds'][x]['bound_by']}, "
            f"{100 * tm['share_of_bound'][x]:.1f}% of it; "
            f"{tm['attributes'][x]['registers']} registers, "
            f"{tm['attributes'][x]['local_bytes']} B local, "
            f"{tm['attributes'][x]['smem_bytes']} B shared)"
            for x in BWD_KERNELS)
        print(f"16(b) K4's backward at {tm['shape']} (bf16, causal): {kern}; "
              f"whole {tm['bwd_ms']:.4f} ms ({tm['tflops']:.1f} TFLOP/s) "
              f"against its bound {tm['bound_ms']:.4f} ms, SDPA's backward "
              f"{tm['library_ms']:.4f} ms (x{tm['vs_library']:.2f}); the "
              f"forward with lse {tm['fwd_lse_ms']:.4f} ms against its bound "
              f"{tm['fwd_lse_bound_ms']:.4f} ms by {tm['fwd_lse_bound_by']}"
              + (f", the plain version {tm['plain_ms']:.2f} ms, two runs "
                 f"the same bits: {tm['same_bits']}" if plain else ""))
        return tm

    Hq, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    timing = time_bwd((TRAIN_BATCH, Hq, Hkv, TRAIN_SEQ, TRAIN_SEQ, d), True)
    timing["d64"] = time_bwd(ATTN_BWD_TIME_D64, False)
    out["timing"] = timing

    # (c) card against CPU: one step of qwen3-1.7b at full width cut to
    # TRAIN_CPU_CUT periods, float32, from one state
    n_per, Bc, Sc = TRAIN_CPU_CUT
    ccfg = cfg.replace(n_periods=n_per, param_dtype="float32",
                       compute_dtype="float32")
    opt = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    card = init_train_state(ccfg, torch.Generator(device=dev).manual_seed(0))
    cpu = TrainState(*(tree_map(lambda x: x.to("cpu", copy=True), t)
                       for t in (card.params, card.opt, card.step)))
    cbatch = SyntheticTokens(ccfg, DataConfig(Sc, Bc, seed=2)).batch_at(0)
    step = build_train_step(ccfg, opt)
    t0 = time.perf_counter()
    card, m_card = step(card, {k: x.to(dev) for k, x in cbatch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu, m_cpu = step(cpu, cbatch)
    cpu_s = time.perf_counter() - t0
    cmp = {key: abs(float(m_card[key]) - float(m_cpu[key]))
           / abs(float(m_cpu[key])) for key in ("loss", "grad_norm")}
    for key, rel in cmp.items():
        if not rel <= 1e-5:
            _fail(f"qwen3 cut to {n_per} periods: {key} on the card "
                  f"{float(m_card[key])} vs the CPU {float(m_cpu[key])}")
    diff = torch.cat([(a.cpu() - b).abs().ravel() for a, b in zip(
        tree_leaves(card.params), tree_leaves(cpu.params))])
    lr1 = float(m_cpu["lr"])
    cmp["param_max_abs_diff"] = float(diff.max())
    cmp["param_share_within_1e-5"] = float((diff <= 1e-5).float().mean())
    cmp["lr"] = lr1
    # AdamW's first step moves an element by about lr sign(g): a gradient
    # near 0 of the other sign moves it 2 lr
    if not (cmp["param_max_abs_diff"] <= 2 * lr1 + 1e-5
            and cmp["param_share_within_1e-5"] >= 0.999):
        _fail(f"qwen3 cut to {n_per} periods: parameters after one step, "
              f"card vs CPU: {cmp}")
    out["card_vs_cpu_step"] = {"periods": n_per, "B": Bc, "S": Sc,
                               "card_s": card_s, "cpu_s": cpu_s, **cmp}
    del card, cpu, diff
    free()
    grads_cmp = {}
    for arch in TRAIN_SMOKE:
        scfg = get_config(arch).smoke()
        pcpu = init_params(scfg, torch.Generator().manual_seed(0))
        pdev = tree_map(lambda x: x.to(dev), pcpu)
        S0 = 24 - (scfg.n_image_tokens if scfg.family == "vlm" else 0)
        b = SyntheticTokens(scfg, DataConfig(S0, 2, seed=3)).batch_at(0)
        lc, gc_ = _value_and_grad(loss_for(scfg), pdev,
                                  {k: x.to(dev) for k, x in b.items()})
        lw, gw = _value_and_grad(loss_for(scfg), pcpu, b)
        worst = 0.0
        for path, a, w in zip(leaf_paths(gw), tree_leaves(gc_),
                              tree_leaves(gw)):
            rel = float((a.cpu() - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            worst = max(worst, rel)
            if not rel <= 1e-4:
                _fail(f"{arch} smoke: gradient of {path} card vs CPU "
                      f"{rel} of its largest |gradient|")
        grads_cmp[arch] = {"loss_rel": abs(float(lc) - float(lw))
                           / abs(float(lw)), "worst_leaf_rel": worst}
    out["smoke_grads"] = grads_cmp

    class Boom(Exception):
        pass

    def crash_at_7(s):
        if s == 7:
            raise Boom()

    out["crash_resume"] = {}
    for arch in RESUME_ARCHS:
        rcfg = get_config(arch).smoke()
        root = ROOT / "build" / "chip_smoke_resume"
        shutil.rmtree(root, ignore_errors=True)

        def runner(d, hook=None):
            return TrainRunner(rcfg, OptConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=50),
                               DataConfig(seq_len=32, global_batch=4,
                                          seed=0),
                               FTConfig(ckpt_dir=str(root / d),
                                        ckpt_every=3),
                               fault_hook=hook, device=dev)

        try:
            runner("a", crash_at_7).run(12)
            _fail("the fault hook did not crash the run")
        except Boom:
            pass
        r2 = runner("a")
        resumed = r2.run(12)
        clean = runner("b").run(12)
        equal = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(resumed.params), tree_leaves(clean.params)))
        if r2.metrics_log[0]["step"] != 6 or not equal:
            _fail(f"crash/resume of {arch} on the card: resumed from step "
                  f"{r2.metrics_log[0]['step']}, bit-equal {equal}")
        shutil.rmtree(root, ignore_errors=True)
        out["crash_resume"][rcfg.name] = {"resumed_from": 6, "steps": 12,
                                          "bit_equal": equal}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"16(c) card vs CPU: {ccfg.name} cut to {n_per} periods (float32, "
          f"B={Bc}, S={Sc}), one step: {json.dumps(out['card_vs_cpu_step'])}"
          f"; smoke gradients per leaf {json.dumps(grads_cmp)}; crash at "
          f"7 / resume at 6 / run to 12 bit-equal on the card "
          f"({', '.join(out['crash_resume'])}).  16(a)-(c) took "
          f"{out['wall_s']:.1f} s")
    return out


def attn_fwd_bounds(B, Hq, Hkv, Sq, Sk, d, causal, lse=False,
                    nbytes=2) -> dict:
    """The least time of K4's forward: two products (S = Q K^T and P V) of
    2 d flops a kept (query, key) pair and head at the bf16 peak (float32's
    outside the tensor cores for 4-byte inputs); or q, k and v read and the
    output (and, with `lse`, the float32 row log-sum-exp) written once over
    the memory rate."""
    pairs = Sq * Sk - (Sq * (Sq - 1) // 2 if causal else 0)
    ops = 2 * 2 * B * Hq * pairs * d
    moved = nbytes * d * B * (2 * Hq * Sq + 2 * Hkv * Sk) \
        + (4 * B * Hq * Sq if lse else 0)
    bound = {"operations": ops / (BF16_FLOPS if nbytes == 2 else F32_FLOPS)
             * 1e3, "bytes": moved / HBM_BYTES_PER_S * 1e3}
    by = max(bound, key=bound.get)
    return {"bound_ms": bound[by], "bound_by": by, "flops": ops,
            "bytes": moved}


def ssd_fwd_bounds(B, S, H, G, N, P, L, keep=False, nbytes=2) -> dict:
    """The least time of K5's forward at (B, S, H, G, N, P, L): x read and
    y written, b, c and the float32 loga read once, and, with `keep` (the
    training forward), the float32 state entering each chunk (B, nC, H, N,
    P) and each chunk's log decay written, over the memory rate; or its
    operations at the inputs' peak: per chunk and head C B^T and its
    product with X over the L (L + 1) / 2 pairs i >= j, C h and the state
    update, 2 L N P each."""
    nC = -(-S // L)
    peak = BF16_FLOPS if nbytes == 2 else F32_FLOPS
    moved = 2 * nbytes * B * S * (H * P + G * N) + 4 * B * S * H \
        + (4 * B * nC * H * (N * P + 1) if keep else 0)
    ops = B * H * nC * 2 * (L * (L + 1) // 2 * (N + P) + 2 * L * N * P)
    bound = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
             "operations": ops / peak * 1e3}
    by = max(bound, key=bound.get)
    return {"bound_ms": bound[by], "bound_by": by, "flops": ops,
            "bytes": moved}


def ssd_bwd_bounds(B, S, H, G, N, P, L, nbytes=2) -> dict:
    """The least time of each of K5's backward wrappers at (B, S, H, G, N,
    P, L): its inputs read and outputs written once over the memory rate,
    or its operations over the inputs' peak (bf16's for 2-byte inputs,
    float32's outside the tensor cores for 4).  ssd_bwd_state: c, dy, loga
    and the chunks' decay in, G (B, nC, H, N, P) float32 out; 2 L N P
    operations a chunk and head, and the pass.  ssd_bwd_chunk: x, dy, b, c,
    a, loga and the float32 states and G in, dx, da, db and dc out; per
    chunk and head C B^T and dY X^T over the L (L + 1) / 2 pairs i >= j,
    their products with dY, C and B, and three inter-chunk products of
    L N P."""
    nC = -(-S // L)
    peak = BF16_FLOPS if nbytes == 2 else F32_FLOPS
    pairs = L * (L + 1) // 2
    blocks = B * nC * H
    work = {
        "ssd_bwd_state": (
            nbytes * B * S * (G * N + H * P) + 4 * B * S * H
            + 4 * B * nC * H + 4 * blocks * N * P,
            2 * blocks * N * P * (L + 1)),
        "ssd_bwd_chunk": (
            2 * nbytes * B * S * (H * P + G * N) + 2 * 4 * B * S * H
            + 2 * 4 * blocks * N * P + nbytes * B * S * H * P
            + 4 * B * S * H + 2 * nbytes * B * S * G * N,
            blocks * (2 * pairs * (3 * N + 2 * P) + 6 * L * N * P)
            + 2 * B * S * H * N)}
    out = {}
    for name, (moved, ops) in work.items():
        bound = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
                 "operations": ops / peak * 1e3}
        by = max(bound, key=bound.get)
        out[name] = {"bound_ms": bound[by], "bound_by": by, "flops": ops,
                     "bytes": moved}
    return out


def _ssm_training(dev, counts) -> dict:
    """Phase 16(d)-(e): mamba2-2.7b at full width through
    ``repro_torch.launch.train``'s ``main`` (the counts set to 0 just
    before and read just after), then K5's backward wrappers against their
    plain versions on SSD_BWD_SHAPES and timed at the training shape.
    ``counts`` = (zero_counts, read_counts).  Returns the record."""
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import BWD_KERNELS as SSD_BWD_KERNELS
    from repro_torch.kernels.ssd_scan import (ssd_bwd_chunk, ssd_bwd_state,
                                              ssd_scan)
    from repro_torch.kernels.ssd_scan.ops import _forward as ssd_forward
    from repro_torch.kernels.ssd_scan.ref import (pad_chunks,
                                                  ssd_bwd_chunk_ref,
                                                  ssd_bwd_ref,
                                                  ssd_bwd_state_ref)

    outputs = {"ssd_bwd_state": ("G",), "ssd_bwd_chunk": SSD_GRADS,
               "whole": SSD_GRADS}
    out: dict = {"max_abs_err": {k: 0.0 for k in outputs},
                 "max_rel_err": {k: dict.fromkeys(v, 0.0)
                                 for k, v in outputs.items()},
                 "checked": {k: 0 for k in outputs}}
    t_phase = time.perf_counter()

    def free() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # (d) mamba2-2.7b trained at full width through the launcher ----------
    cfg = get_config(SSM_ARCH)
    res, out["train"] = _train_full_width(
        dev, counts, SSM_ARCH, SSM_TRAIN_STEPS, SSM_TRAIN_SEQ,
        SSM_TRAIN_BATCH, {"ssd_scan": 2 * cfg.n_layers,   # remat="full"
                          **{k: cfg.n_layers for k in SSD_BWD}})
    del res
    free()
    walls, step_s = out["train"]["step_s"], out["train"]["step_s_median_2_4"]
    peak = out["train"]["max_memory_allocated"]
    tr = out["train"]
    print(f"16(d) {cfg.name} trained at full width ({tr['params']} "
          f"parameters, bf16, remat {cfg.remat}) through "
          f"repro_torch.launch.train, {SSM_TRAIN_STEPS} steps of "
          f"{SSM_TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens: step s "
          f"{[round(w, 4) for w in walls]} (median of 2-{SSM_TRAIN_STEPS} "
          f"{step_s:.4f}, {tr['tokens_per_s']:.0f} tokens/s), loss "
          f"{[round(x, 4) for x in tr['loss']]}, grad norm "
          f"{[round(x, 4) for x in tr['grad_norm']]}, peak "
          f"{peak / 2**30:.2f} GiB; buckets planned in {tr['plan_s']:.3f} s, "
          f"makespan gain {tr['bucket_makespan_gain_pct']}%; launches a step "
          f"{tr['launches_per_step']}")

    # (e) K5's backward against its plain versions ------------------------
    def inputs(shape, dtype, seed):
        """x, a, b, c, dy as the model hands them: b and c strided views of
        one (B, S, 2, G, N) tensor; a in (0.55, 1) float32."""
        B, S, H, G, N, P, _ = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
        a = torch.rand((B, S, H), generator=g, device=dev) * 0.45 + 0.55
        bc = (torch.randn((B, S, 2, G, N), generator=g, device=dev)
              * 0.3).to(dtype)
        dy = torch.randn((B, S, H, P), generator=g, device=dev).to(dtype)
        return x, a, bc[:, :, 0], bc[:, :, 1], dy

    def note(name, got, want, what, dtype):
        """Each output against its own largest |value| and against the
        largest over the outputs (SSD_BWD_TOL): db and dc sum the group's
        heads (80 at mamba2) and dwarf dx, so the second alone would not
        hold dx."""
        own_tol, all_tol = SSD_BWD_TOL[str(dtype).split(".")[-1]]
        top = max(float(w.float().abs().max()) for w in want) or 1.0
        out["checked"][name] += 1
        for key, g, w in zip(outputs[name], got, want):
            scale = float(w.float().abs().max()) or 1.0
            err = float((g.float() - w.float()).abs().max())
            out["max_abs_err"][name] = max(out["max_abs_err"][name], err)
            rel = out["max_rel_err"][name]
            rel[key] = max(rel[key], err / scale)
            if not (err <= own_tol * scale and err <= all_tol * top):
                _fail(f"{name}'s {key} != plain version on {what} (max "
                      f"|diff| {err} > {own_tol} x {scale} or {all_tol} x "
                      f"{top})")

    def check(shape, dtype):
        B, S, H, G, N, P, L = shape
        x, a, b, c, dy = inputs(shape, dtype, sum(shape))
        what = f"shape {shape} {str(dtype).split('.')[-1]}"
        with torch.no_grad():
            loga, states, decay = ssd_forward(x, a, b, c, L, True)[1]
        xp, ap, bp, cp, dyp = pad_chunks(min(L, S), x, a, b, c, dy)
        Lc = min(L, S)
        grads = ssd_bwd_state(cp, dyp, loga, decay, chunk=Lc)
        note("ssd_bwd_state", [grads],
             [ssd_bwd_state_ref(cp, dyp, loga, decay, Lc)], what, dtype)
        af = ap.float().contiguous()
        got = ssd_bwd_chunk(xp, af, loga, bp, cp, dyp, states, grads,
                            chunk=Lc)
        note("ssd_bwd_chunk", got, ssd_bwd_chunk_ref(
            xp, af, loga, bp, cp, dyp, states, grads, Lc), what, dtype)
        leaves = [t.detach().clone().requires_grad_() for t in (x, a, b, c)]
        ssd_scan(*leaves, chunk=L).backward(dy)
        note("whole", [t.grad for t in leaves],
             ssd_bwd_ref(x, a, b, c, dy, chunk=L), what, dtype)

    n_grid = 0
    for shape in SSD_BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            check(shape, dtype)
            n_grid += 1
    free()
    print(f"16(e) K5's backward within tolerance of its plain versions on "
          f"{n_grid} cases ({len(SSD_BWD_SHAPES)} shapes x f32/bf16; each "
          f"wrapper and the whole): max |diff| {out['max_abs_err']}, "
          f"relative to each output's largest |value| "
          f"{out['max_rel_err']}")

    # each wrapper at the training shape; two runs give the same bits
    s_ssm = cfg.ssm
    H5 = s_ssm.expand * cfg.d_model // s_ssm.d_head
    L5 = s_ssm.chunk
    shape = (SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, H5, s_ssm.n_groups,
             s_ssm.d_state, s_ssm.d_head, L5)
    B, S, H, G, N, P, L = shape
    x, a, b, c, dy = inputs(shape, torch.bfloat16, 5)
    with torch.no_grad():
        loga, states, decay = ssd_forward(x, a, b, c, L, True)[1]
    af = a.contiguous()
    grads = ssd_bwd_state(c, dy, loga, decay, chunk=L)
    tm = {"shape": list(shape), "dtype": "bfloat16",
          "ssd_bwd_state": _cuda_ms(lambda: ssd_bwd_state(
              c, dy, loga, decay, chunk=L), reps=5, rounds=3),
          "ssd_bwd_chunk": _cuda_ms(lambda: ssd_bwd_chunk(
              x, af, loga, b, c, dy, states, grads, chunk=L), reps=3,
              rounds=3),
          "forward_kept_ms": _cuda_ms(lambda: ssd_forward(
              x, a, b, c, L, True), reps=5, rounds=3),
          "plain": {
              "ssd_bwd_state": _cuda_ms(lambda: ssd_bwd_state_ref(
                  c, dy, loga, decay, L), reps=1, rounds=2),
              "ssd_bwd_chunk": _cuda_ms(lambda: ssd_bwd_chunk_ref(
                  x, af, loga, b, c, dy, states, grads, L), reps=1,
                  rounds=2)}}
    runs = [(ssd_bwd_state(c, dy, loga, decay, chunk=L),
             *ssd_bwd_chunk(x, af, loga, b, c, dy, states, grads, chunk=L))
            for _ in range(2)]
    tm["same_bits"] = all(torch.equal(u, v) for u, v in zip(*runs))
    if not tm["same_bits"]:
        _fail(f"two runs of K5's backward at {shape} gave different bits")
    # the training shape's outputs against the plain versions' too: the bf16
    # chunk kernels' grid and their per-slice partials grow with B
    what = f"the training shape {shape} bfloat16"
    note("ssd_bwd_state", runs[0][:1],
         [ssd_bwd_state_ref(c, dy, loga, decay, L)], what, torch.bfloat16)
    note("ssd_bwd_chunk", runs[0][1:], ssd_bwd_chunk_ref(
        x, af, loga, b, c, dy, states, grads, L), what, torch.bfloat16)
    del runs
    free()
    tm["bounds"] = ssd_bwd_bounds(B, S, H, G, N, P, L)
    tm["forward_kept_bound"] = ssd_fwd_bounds(B, S, H, G, N, P, L, keep=True)
    tm["share_of_bound"] = {k: tm["bounds"][k]["bound_ms"] / tm[k]
                            for k in SSD_BWD}
    tm["tflops"] = {k: tm["bounds"][k]["flops"] / tm[k] / 1e9
                    for k in SSD_BWD}
    tm["bwd_ms"] = sum(tm[k] for k in SSD_BWD)
    lib = kernels.load_kernel("ssd_scan")
    lib.ssd_bwd_kernel_name.argtypes = [ctypes.c_int]
    lib.ssd_bwd_kernel_name.restype = ctypes.c_char_p
    names = {w: [lib.ssd_bwd_kernel_name(k).decode() for k in ids]
             for w, ids in SSD_BWD_KERNELS[torch.bfloat16].items()}
    tm["attributes"] = {
        w: {n: _attributes(lib.ssd_bwd_attributes, k, L, N, P)
            for n, k in zip(names[w], SSD_BWD_KERNELS[torch.bfloat16][w])}
        for w in SSD_BWD}
    # the CUDA launches one call of each wrapper makes, counted by the
    # profiler: each kernel BWD_KERNELS names once, and no other of K5's
    # backward.  The spins pad the window's start, as 11's profiled pass
    # does (this late in the process the profiler has dropped a window's
    # first device events)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(1024):
            torch.cuda._sleep(1000)
        torch.cuda._sleep(2_000_000_000)
        torch.cuda.synchronize()
        ssd_forward(x, a, b, c, L, True)
        ssd_bwd_state(c, dy, loga, decay, chunk=L)
        ssd_bwd_chunk(x, af, loga, b, c, dy, states, grads, chunk=L)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    ran = [e for e in ka
           if e.device_type == DeviceType.CUDA and "ssd_bwd" in e.key]
    # the forward that keeps its states: one CUDA launch, the chunk walk
    tm["forward_cuda_launches"] = {
        n: sum(e.count for e in ka if e.device_type == DeviceType.CUDA
               and n in e.key)
        for names in K5_NAMES.values() for n in names}
    if tm["forward_cuda_launches"] != {
            n: int(n in K5_NAMES["bfloat16"])
            for names in K5_NAMES.values() for n in names}:
        _fail(f"one bf16 forward keeping its states at {shape} launched "
              f"{tm['forward_cuda_launches']}, expected "
              f"{K5_NAMES['bfloat16']} once and nothing else")

    def launched(n: str) -> int:
        return sum(e.count for e in ran
                   if f"::{n}<" in e.key or f"::{n}(" in e.key)

    tm["cuda_launches"] = {w: {n: launched(n) for n in ns}
                           for w, ns in names.items()}
    tm["cuda_launches_per_call"] = {w: sum(v.values())
                                    for w, v in tm["cuda_launches"].items()}
    other = sum(e.count for e in ran) - sum(
        tm["cuda_launches_per_call"].values())
    if other or any(n != 1 for v in tm["cuda_launches"].values()
                    for n in v.values()):
        _fail(f"one call of each of K5's backward wrappers at {shape} "
              f"(bf16) launched {tm['cuda_launches']} and {other} other "
              f"ssd_bwd kernels, expected each of {names} once")
    del prof, ran
    spilled = {k: v["local_bytes"] for kinds in tm["attributes"].values()
               for k, v in kinds.items() if v["local_bytes"]}
    if spilled:
        _fail(f"K5's bf16 backward kernels use local memory: {spilled}")
    del x, a, b, c, dy, loga, states, decay, af, grads
    free()
    out["timing"] = tm
    out["wall_s"] = time.perf_counter() - t_phase
    for k in SSD_BWD:
        print(f"16(e) {k} at {shape} (bf16): {tm[k]:.4f} ms (bound "
              f"{tm['bounds'][k]['bound_ms']:.4f} ms by "
              f"{tm['bounds'][k]['bound_by']}, "
              f"{100 * tm['share_of_bound'][k]:.1f}% of it; "
              f"{tm['tflops'][k]:.2f} TFLOP/s), the plain version "
              f"{tm['plain'][k]:.2f} ms, held against it there (max "
              f"|diff| relative to each output's largest "
              f"{out['max_rel_err'][k]}); CUDA launches a call (profiled) "
              f"{tm['cuda_launches'][k]}; kernels "
              f"{json.dumps(tm['attributes'][k])}")
    kb = tm["forward_kept_bound"]
    print(f"16(e) K5's forward keeping its states at {shape} (bf16): "
          f"{tm['forward_kept_ms']:.4f} ms (bound {kb['bound_ms']:.4f} ms by "
          f"{kb['bound_by']}); CUDA launches a call (profiled) "
          f"{tm['forward_cuda_launches']}")
    print(f"16(e) K5's backward at the training shape: {tm['bwd_ms']:.4f} "
          f"ms a layer, {cfg.n_layers} a step: "
          f"{tm['bwd_ms'] * cfg.n_layers / 1e3:.4f} s; two runs the same "
          f"bits: {tm['same_bits']}.  16(d)-(e) took {out['wall_s']:.1f} s")
    return out


def _dryrun_cells() -> dict:
    """Phase 17(a): ``python -m repro_torch.launch.dryrun`` of MESH_ARCH x
    MESH_SHAPE on each mesh, in subprocesses started together (the card
    hidden from them: the trace runs on the host), each killed if it
    outlives MESH_TRACE_TIMEOUT.  Returns mesh name -> the cell's
    record."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = {}
    for mp in (False, True):
        name = "2x16x16" if mp else "16x16"
        out = ROOT / "build" / f"chip_smoke_dryrun_{name}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               MESH_ARCH, "--shape", MESH_SHAPE, "--out", str(out)]
        procs[name] = (subprocess.Popen(
            cmd + (["--multi-pod"] if mp else []), env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out)
    cells = {}
    for name, (proc, out) in procs.items():
        try:
            _, err = proc.communicate(timeout=MESH_TRACE_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p, _ in procs.values():
                p.kill()
                p.communicate()
            _fail(f"17(a) the {name} dry run outlived "
                  f"{MESH_TRACE_TIMEOUT} s")
        if proc.returncode != 0:
            _fail(f"17(a) the {name} dry run exited {proc.returncode}: "
                  f"{err[-2000:]}")
        cell = json.loads(out.read_text())[-1]
        if cell["status"] != "ok":
            _fail(f"17(a) the {name} cell is {cell['status']}: "
                  f"{cell.get('trace', cell.get('reason'))}")
        cells[name] = cell
    return cells


def _mesh(dev, counts) -> dict:
    """Phase 17: (a) the dry run of qwen3-1.7b's full-width train step on
    both production meshes (host subprocesses), (b) its 16 x 16 collective
    program planned on the card's pipeline, equal to the CPU's plan, (c)
    one full-width step on a (1, 1) NCCL mesh against the same step with
    no mesh.  ``counts`` = (zero_counts, read_counts).  Returns the
    record."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.dist.partition import (batch_pspecs, distribute,
                                            distribute_state)
    from repro_torch.dist.planner import (CollectiveOp,
                                          bucket_order_from_plan,
                                          coflows_from_step, plan)
    from repro_torch.launch.mesh import (make_production_mesh, mesh_rules,
                                         one_rank_group)
    from repro_torch.launch.specs import abstract_params
    from repro_torch.models.lm import tree_leaves
    from repro_torch.models.sharding import mesh_context
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        leaf_paths)

    zero_counts, read_counts = counts
    out: dict = {}
    t_phase = time.perf_counter()

    # (a) both traces run on the host while (c)'s step without a mesh runs
    # on the card; the cells are read before (b)
    import threading
    traced: dict = {}
    tracer = threading.Thread(target=lambda: traced.update(
        cells=_dryrun_cells()))
    tracer.start()

    cfg = get_config(MESH_ARCH)
    B, S = MESH_STEP
    batch = SyntheticTokens(cfg, DataConfig(seq_len=S, global_batch=B,
                                            seed=0), device=dev).batch_at(0)

    def fresh_state():
        gc.collect()
        torch.cuda.empty_cache()
        return init_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    @torch.no_grad()
    def fingerprint(state):
        """Per leaf of the parameters and both moments, in leaf order: the
        float64 sum and the float64 sum weighted by (flat index mod 1021)
        + 1, so a moved element shows too.  Held at 0, since equal bits
        give equal sums."""
        sums = []
        for tree in (state.params, state.opt["m"], state.opt["v"]):
            for t in tree_leaves(tree):
                x = whole(t).reshape(-1).double()
                w = torch.arange(x.numel(), device=x.device,
                                 dtype=torch.float64).remainder_(1021)
                sums += [x.sum(), (x * w.add_(1)).sum()]
                del x, w
        return torch.stack(sums).cpu()

    def timed_step(step, state, b, mesh=None):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mesh is None:
            state, metrics = step(state, b)
        else:
            with mesh_context(mesh, mesh_rules(mesh)):
                state, metrics = step(state, b)
        loss = whole(metrics["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, read_counts(), loss.clone(),
                metrics["grad_norm"].clone(), state)

    opt = OptConfig(warmup_steps=1)
    plain = timed_step(build_train_step(cfg, opt), fresh_state(), batch)
    plain_fp = fingerprint(plain[-1])
    plain = plain[:-1]
    tracer.join()
    if "cells" not in traced:
        _fail("17(a) the dry run did not finish")
    cells = out["dryrun"] = traced["cells"]
    for name, cell in cells.items():
        kinds: dict = {}
        for kind, nbytes, _ in cell["collective_ops"]:
            k = kinds.setdefault(kind, [0, 0.0])
            k[0] += 1
            k[1] += nbytes
        r = cell["roofline"]
        print(f"17(a) dry run {MESH_ARCH} {MESH_SHAPE} on {name} (a trace "
              f"on a fake group of {'512' if name == '2x16x16' else '256'} "
              f"ranks, rank 0's share): FLOPs/device "
              f"{cell['cost']['flops']:.6e}, argument bytes/device "
              f"{cell['memory']['argument_size_in_bytes']}, peak live "
              f"bytes {cell['memory']['peak_live_bytes']}, collectives "
              f"(count, bytes) {json.dumps(kinds)}, H100 roofline compute "
              f"{r['compute_s']:.6f} s, memory {r['memory_s']:.6f} s, "
              f"collective {r['collective_s']:.6f} s, bottleneck "
              f"{r['bottleneck']}; traced in {cell['trace_s']} s")
        cell["kinds"] = kinds

    # (b) the traced program planned on the card, equal to the CPU's plan
    ops = [CollectiveOp(kind, nbytes, i, axis) for i, (kind, nbytes, axis)
           in enumerate(cells["16x16"]["collective_ops"])]
    inst = coflows_from_step(ops, rows=16, cols=16, n_buckets=MESH_BUCKETS)
    zero_counts()
    t0 = time.perf_counter()
    card = plan(inst, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    cpu = plan(inst, device="cpu", plan_backend="pipeline")
    cpu_s = time.perf_counter() - t0
    same = (card.order == cpu.order
            and card.planner_makespan == cpu.planner_makespan
            and card.naive_makespan == cpu.naive_makespan)
    if not same:
        _fail(f"17(b) card plan != CPU plan: {card.order} "
              f"{card.planner_makespan} {card.naive_makespan} vs "
              f"{cpu.order} {cpu.planner_makespan} {cpu.naive_makespan}")
    if launches["bna_decompose"] < 1 or launches["merge_fix"] < 1:
        _fail(f"17(b) the plan did not run the card's pipeline: {launches}")
    order = bucket_order_from_plan(card, leaf_paths(abstract_params(cfg)))
    out["plan"] = {"ops": len(ops), "coflows": sum(len(j.coflows)
                                                   for j in inst.jobs),
                   "order": card.order,
                   "planner_makespan": card.planner_makespan,
                   "naive_makespan": card.naive_makespan,
                   "plan_s_cuda": plan_s, "plan_s_cpu": cpu_s,
                   "launches": {k: launches[k] for k in ("bna_decompose",
                                                         "merge_fix")},
                   "buckets": [len(b) for b in order]}
    print(f"17(b) {len(ops)} traced collectives as {out['plan']['coflows']} "
          f"coflows in {MESH_BUCKETS} buckets on the 16 x 16 fabric: card "
          f"plan == CPU plan (order {card.order}, makespan "
          f"{card.planner_makespan} vs naive {card.naive_makespan}); "
          f"bna_decompose {launches['bna_decompose']}, merge_fix "
          f"{launches['merge_fix']} launches; {plan_s:.3f} s on the card, "
          f"{cpu_s:.3f} s on the CPU")

    # (c) one full-width step on a (1, 1) NCCL mesh
    with one_rank_group("nccl"):
        mesh = make_production_mesh(shape=(1, 1), device_type="cuda")
        state = distribute_state(fresh_state(), mesh)
        b = distribute(batch, batch_pspecs(batch, mesh), mesh)
        mesh_step = build_train_step(cfg, opt, bucket_order=order)
        meshed = timed_step(mesh_step, state, b, mesh)
        mesh_fp = fingerprint(meshed[-1])
        # a second step on the same mesh, timed only: the first one is
        # also the first on its communicator and DTensor's caches
        second_s = timed_step(mesh_step, meshed[-1], b, mesh)[0]
        meshed = meshed[:-1]
        del state, b
    p_s, p_launch, p_loss, p_norm = plain
    m_s, m_launch, m_loss, m_norm = meshed
    fp_diff = (plain_fp - mesh_fp).abs()
    out["step"] = {
        "arch": cfg.name, "tokens": B * S, "plain_s": p_s, "mesh_s": m_s,
        "mesh_second_s": second_s,
        "loss": [float(p_loss), float(m_loss)],
        "grad_norm": [float(p_norm), float(m_norm)],
        "loss_same_bits": bool(torch.equal(p_loss, m_loss)),
        "grad_norm_same_bits": bool(torch.equal(p_norm, m_norm)),
        "grad_norm_diff": float((p_norm - m_norm).abs()),
        "state_sums": len(plain_fp),
        "state_same_sums": bool(torch.equal(plain_fp, mesh_fp)),
        "state_sums_max_diff": float(fp_diff.max()),
        "launches": {"plain": p_launch, "mesh": m_launch}}
    if not out["step"]["loss_same_bits"]:
        _fail(f"17(c) the (1, 1) mesh step's loss {float(m_loss)!r} != "
              f"{float(p_loss)!r} without a mesh")
    if not out["step"]["grad_norm_same_bits"]:
        _fail(f"17(c) the (1, 1) mesh step's grad norm {float(m_norm)!r} "
              f"!= {float(p_norm)!r} without a mesh")
    if not out["step"]["state_same_sums"]:
        bad = int(fp_diff.argmax())
        _fail(f"17(c) the updated parameters and moments differ from the "
              f"step without a mesh: {int((fp_diff > 0).sum())} of "
              f"{len(plain_fp)} per-leaf sums, the largest by "
              f"{float(fp_diff[bad])!r} (sum {bad})")
    for name in ("flash_attention", *BWD_KERNELS):
        if m_launch[name] < 1 or m_launch[name] != p_launch[name]:
            _fail(f"17(c) {name} launched {m_launch[name]} times on the "
                  f"mesh, {p_launch[name]} without")
    print(f"17(c) {cfg.name} at full width, {B} x {S} tokens, on a (1, 1) "
          f"NCCL mesh (world size 1): loss {float(m_loss)!r} (no mesh "
          f"{float(p_loss)!r}, same bits), grad norm {float(m_norm)!r} "
          f"(no mesh {float(p_norm)!r}, same bits: "
          f"{out['step']['grad_norm_same_bits']}); updated parameters "
          f"and moments: {len(plain_fp)} per-leaf float64 sums, the same; "
          f"K4 launches {m_launch['flash_attention']} through local_map "
          f"({p_launch['flash_attention']} without); step {m_s:.3f} s on "
          f"the mesh, {p_s:.3f} s without (first steps), a second mesh "
          f"step {second_s:.3f} s")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"17 took {out['wall_s']:.1f} s")
    return out


def _checker(kernel_names) -> dict:
    """Phase 18: the port's contract checker (``repro_torch.analysis``) on
    this machine's host, in process.  (a) ``--strict`` over src/repro_torch:
    0 unsuppressed findings and an empty ``analysis_baseline_torch.json``.
    (b) Every launch site ``overflow-range`` resolves: each entry it may
    call is a symbol its kernel's built library exports, with the argtypes
    of the entry's ``extern "C"`` declaration; and each kernel the kernels
    line holds against its plain version (``<name>_launch``) is among
    them."""
    from repro_torch.analysis import baseline, names, scan_paths
    from repro_torch.analysis.rules import overflow_range
    from repro_torch.kernels import load_kernel

    t0 = time.perf_counter()
    src = ROOT / "src" / "repro_torch"
    report = scan_paths([src], root=ROOT)
    entries = baseline.load(ROOT / baseline.DEFAULT_BASELINE)
    ratchet = baseline.diff(report, entries)
    scan_s = time.perf_counter() - t0
    if report.unsuppressed or entries or not ratchet.ok():
        _fail("18(a): the checker is not clean under --strict:\n"
              + "\n".join(f.render() for f in report.unsuppressed)
              + f"\nbaseline entries: {entries}")
    sites = overflow_range.resolve_launches([src / "kernels"], ROOT)
    exported = set()
    for site in sites:
        lib = load_kernel(site.kernel)
        for entry in site.entries:
            if not hasattr(lib, entry):
                _fail(f"18(b): {site.path}:{site.line} launches {entry}, "
                      f"which the {site.kernel} library does not export")
            cite = overflow_range.INT32_INDEXED[(site.kernel, entry)][1]
            cu = (src / "kernels" / cite.split(":")[0]).read_text()
            if list(site.argtypes or ()) != \
                    overflow_range.c_signature(cu, entry):
                _fail(f"18(b): {site.path}:{site.line}: {entry}'s argtypes "
                      f"{site.argtypes} differ from its CUDA declaration")
            exported.add(entry)
    missing = sorted(n for n in kernel_names if f"{n}_launch" not in exported)
    if missing:
        _fail(f"18(b): kernels of the kernels line with no resolved launch "
              f"site: {missing}")
    return {"rules": len(names()), "files": report.n_files,
            "findings": len(report.unsuppressed),
            "suppressed": len(report.suppressed),
            "baseline_entries": len(entries), "scan_s": scan_s,
            "launch_sites": len(sites), "entries": sorted(exported),
            "wall_s": time.perf_counter() - t0}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.models.lm import tree_leaves
    from repro_torch.core import (backend, bna, bna_many, cache_stats,
                                  clear_caches, matching, no_caches,
                                  paper_workload, pipeline, plan, timeline,
                                  transcript_to_arrays, verify_schedule,
                                  verify_transcript)
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.bna_decompose.ops import \
        layout as bna_decompose_layout
    from repro_torch.kernels.bna_decompose.ref import (bna_decompose_ref,
                                                       tight_bucket)
    from repro_torch.kernels.bna_step import bna_step, stage_state
    from repro_torch.kernels.bna_step.ref import bna_step_ref
    from repro_torch.kernels.coflow_merge import coflow_merge
    from repro_torch.kernels.coflow_merge.ref import alphas_ref, build_delta
    from repro_torch.kernels.merge_fix import merge_fix
    from repro_torch.kernels.merge_fix.ref import merge_fix_ref
    from repro_torch.kernels.flash_attention import (attn_bwd_dkdv,
                                                     attn_bwd_dq,
                                                     attn_bwd_prep,
                                                     flash_attention,
                                                     forward_kernel)
    from repro_torch.kernels.flash_attention.ops import FORWARD_KERNELS
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import CUDA_LAUNCHES as \
        SSD_CUDA_LAUNCHES
    from repro_torch.kernels.ssd_scan import (ssd_bwd_chunk, ssd_bwd_state,
                                              ssd_scan)
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrappers = {"bna_step": bna_step, "coflow_merge": coflow_merge,
                "bna_decompose": bna_decompose, "merge_fix": merge_fix,
                "flash_attention": flash_attention, "ssd_scan": ssd_scan,
                "attn_bwd_prep": attn_bwd_prep,
                "attn_bwd_dkdv": attn_bwd_dkdv, "attn_bwd_dq": attn_bwd_dq,
                "ssd_bwd_state": ssd_bwd_state,
                "ssd_bwd_chunk": ssd_bwd_chunk}
    record: dict = {"device": torch.cuda.get_device_name(0),
                    "host": _host_cpu()}
    t_start = time.perf_counter()
    phase_at: dict = {}

    def mark(phase: str) -> None:
        """The second at which a phase starts, printed and kept in the
        record: the run has to end within its time limit."""
        phase_at[phase] = time.perf_counter() - t_start
        print(f"[{phase_at[phase]:.1f} s] phase {phase}", flush=True)

    def zero_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    # 1. build --------------------------------------------------------------
    mark("1")
    t0 = time.perf_counter()
    kernels.build_kernels(list(KERNELS))
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.2f} s, sm_90a, into {kernels.BUILD_DIR}; "
          f"host {record['host']}")

    # largest |kernel - plain| over every comparison made in this run, the
    # kernels' outputs and the states they update in place included
    max_err = {name: 0 for name in KERNELS}
    checked = {name: 0 for name in KERNELS}

    def abs_err(pairs) -> int:
        return max((int((x.long() - y.long()).abs().max()) if x.numel()
                    else 0 for x, y in pairs), default=0)

    def note(name: str, err: int, what: str) -> None:
        max_err[name] = max(max_err[name], err)
        checked[name] += 1
        if err:
            _fail(f"{name} != plain version on {what} (max |diff| {err})")

    # 2. bna_step on random states, bna_decompose on random buckets ----------
    mark("2")
    def random_state(rng, B, w):
        d = rng.integers(0, 40, size=(B, w, w))
        d[rng.random((B, w, w)) > 0.6] = 0
        d[0] = 0                                   # a drained matrix
        row, col = d.sum(axis=2), d.sum(axis=1)
        D = np.maximum(row.max(axis=1), col.max(axis=1))
        match = np.full((B, w), -1, dtype=np.int64)
        for i in range(B):
            perm = rng.permutation(w)
            keep = rng.random(w) < 0.8
            match[i, keep] = perm[keep]
        match[0] = -1
        return d, row, col, D, match

    def step_err(state_dev) -> int:
        ref_in = [x.clone() for x in state_dev]
        got = bna_step(*state_dev)
        want = bna_step_ref(*ref_in)
        return abs_err([(got, want), *zip(state_dev, ref_in)])

    rng = np.random.default_rng(0)
    shapes = [(B, w) for B in (1, 37, 256) for w in (1, 8, 64, 256)]
    for B, w in shapes + [(2, 2048)]:
        state = stage_state(*random_state(rng, B, w), dev)
        note("bna_step", step_err(list(state)),
             f"a random state (B={B}, w={w})")
    n_step_i32 = checked["bna_step"]
    for B, w in [(B, w) for B in (1, 37) for w in (1, 8, 64, 256)] \
            + [(2, 2048)]:
        d, row, col, D, match = random_state(rng, B, w)
        d = d * (2**33 + 1)
        d[-1, 0, 0] = 2**33
        row, col = d.sum(axis=2), d.sum(axis=1)
        D = np.maximum(row.max(axis=1), col.max(axis=1))
        state = stage_state(d, row, col, D, match, dev)
        if state[0].dtype != torch.int64:
            _fail("a state past 2^31 was not staged int64")
        note("bna_step", step_err(list(state)),
             f"a random int64 state (B={B}, w={w})")
    del state
    n_step_random = checked["bna_step"]
    torch.cuda.synchronize()
    print(f"bna_step: equal to the plain version on {n_step_i32} random "
          f"int32 states (B in 1/37/256, w in 1/8/64/256, and B=2 at "
          f"w=2048) and {n_step_random - n_step_i32} int64 states "
          "(effective sizes past 2^31; w up to 2048)")

    overflow = [np.array([[2**31 - 1]], np.int64)]
    clear_caches()
    bna_step.launches = 0
    got_o = pipeline._plan_decompositions(overflow, device="cuda")
    torch.cuda.synchronize()
    n_i64 = bna_step.launches
    fallbacks = cache_stats()["plan"]["decompose"]["bucket_fallbacks"]
    clear_caches()
    want_o = pipeline._plan_decompositions(overflow, device="cpu")
    as_lists = [[(int(t), p.tolist()) for t, p in r[0][0]] for r in
                (got_o, want_o)]
    if not (n_i64 and fallbacks == 1
            and as_lists[0] == as_lists[1] == [(2**31 - 1, [0])]
            and all(np.array_equal(x, y)
                    for x, y in zip(got_o[1][0], want_o[1][0]))):
        _fail(f"[[2^31 - 1]] on the card: {as_lists[0]}, {n_i64} bna_step "
              f"launches, {fallbacks} overflow buckets")
    record["overflow_bucket"] = {"pieces": as_lists[0],
                                 "bna_step_int64_launches": n_i64,
                                 "bucket_fallbacks": fallbacks}
    print(f"[[2^31 - 1]] through the pipeline's overflow branch on the card: "
          f"{as_lists[0]} ({n_i64} int64 bna_step launch), equal to the CPU "
          "and to the reference's result")

    def random_bucket(rng, w, density):
        """Lanes: full width, random narrower widths, one lane of one step
        (a scaled permutation), and an all-zero lane."""
        B = 6 if w < 256 else 4
        d = np.zeros((B, w, w), np.int32)
        ks = np.zeros(B, np.int32)
        for b in range(B - 2):
            k = w if b == 0 else int(rng.integers(1, w + 1))
            x = rng.integers(0, 40, size=(k, k))
            x[rng.random((k, k)) > density] = 0
            d[b, :k, :k] = x
            ks[b] = k
        k = max(1, w // 2)
        d[B - 2, np.arange(k), rng.permutation(k)] = 7
        ks[B - 2] = k
        nnz = int((d > 0).sum(axis=(1, 2)).max())
        return (torch.from_numpy(d), torch.from_numpy(ks),
                1 << (nnz + 6 * w + 8 - 1).bit_length())

    def decompose_err(d, ks, T_cap, t_store=None) -> int:
        got = bna_decompose(d.to(dev), ks.to(dev), T_cap, t_store=t_store)
        want = bna_decompose_ref(d.to(dev), ks.to(dev), T_cap)
        if got[1].shape != want[1].shape:
            return 1 << 30
        return abs_err(zip(got, want))

    for w, density, t_store in ((1, 1.0, None), (2, 0.7, None),
                                (8, 0.5, 2), (64, 0.15, None),
                                (256, 0.01, 8)):
        d, ks, T_cap = random_bucket(rng, w, density)
        note("bna_decompose", decompose_err(d, ks, T_cap, t_store),
             f"a random bucket (w={w})")
    # one lane a block in shared memory (w = 1024), and the layout past
    # 1024 senders (w = 2048), both relaunched from a 2-step store
    for w, lanes in ((1024, [(1024, 3), (700, 2), (0, 0)]),
                     (2048, [(1100, 3), (2048, 1), (1500, 2), (0, 0)])):
        d, ks, T_cap = tight_bucket(rng, w, lanes)
        note("bna_decompose", decompose_err(d, ks, T_cap, 2),
             f"a sparse bucket (w={w})")
    n_dec_random = checked["bna_decompose"]
    torch.cuda.synchronize()
    print(f"bna_decompose: equal to the plain version on {n_dec_random} "
          "random buckets (w in 1/2/8/64/256; zero, one-step and sparse "
          "lanes; short stores relaunched) and sparse buckets at w = 1024 "
          "and 2048")

    # 3. python path, both kernels checked at every call ---------------------
    mark("3")
    largest = {name: None for name in KERNELS}
    orig_alphas = backend.edge_interval_alphas

    def checked_step(d, row, col, D, match):
        ref_in = [x.clone() for x in (d, row, col, D, match)]
        before = [x.clone() for x in (d, row, col, D, match)]
        out = bna_step(d, row, col, D, match)
        want = bna_step_ref(*ref_in)
        note("bna_step", abs_err([(out, want),
                                  *zip((d, row, col, D, match), ref_in)]),
             f"a main-path state (B={d.shape[0]}, w={d.shape[1]})")
        size = d.shape[0] * d.shape[1]
        if largest["bna_step"] is None or size > largest["bna_step"][0]:
            largest["bna_step"] = (size, before)
        return out

    def checked_alphas(events, t0, t1, s, r, m, *, device):
        got = orig_alphas(events, t0, t1, s, r, m, device=device)
        si = torch.as_tensor(np.searchsorted(events, t0), device=dev)
        ei = torch.as_tensor(np.searchsorted(events, t1), device=dev)
        delta = build_delta(si, ei, torch.as_tensor(s, device=dev),
                            torch.as_tensor(r, device=dev),
                            int(events.size) - 1, m)
        want = alphas_ref(delta).cpu().numpy()
        note("coflow_merge", int(np.abs(got - want).max(initial=0)),
             f"a main-path edge set (K={delta.shape[0]})")
        if largest["coflow_merge"] is None or \
                delta.numel() > largest["coflow_merge"].numel():
            largest["coflow_merge"] = delta
        return got

    inst = paper_workload(m=150, mu_bar=5, seed=0, scale=SCALES["gdm"])
    matching.bna_step, backend.edge_interval_alphas = \
        checked_step, checked_alphas
    try:
        clear_caches()
        t0 = time.perf_counter()
        plan(inst, "gdm", device="cuda", plan_backend="python", seed=0)
        torch.cuda.synchronize()
    finally:
        matching.bna_step, backend.edge_interval_alphas = \
            bna_step, orig_alphas
    if not (checked["bna_step"] > n_step_random and checked["coflow_merge"]):
        _fail(f"checked python-path run reached no kernel call: {checked}")
    print(f"checked python-path run (gdm): "
          f"{checked['bna_step'] - n_step_random} bna_step and "
          f"{checked['coflow_merge']} coflow_merge calls equal to the plain "
          f"versions ({time.perf_counter() - t0:.1f} s)")

    grng = np.random.default_rng(1)
    E, m_syn = 60_000, 150
    t0s = grng.integers(0, 10_000_000, E)
    t1s = t0s + grng.integers(1, 5_000, E)
    events = np.unique(np.concatenate([t0s, t1s]))
    s_syn, r_syn = grng.integers(0, m_syn, E), grng.integers(0, m_syn, E)
    si = torch.as_tensor(np.searchsorted(events, t0s), device=dev)
    ei = torch.as_tensor(np.searchsorted(events, t1s), device=dev)
    big = build_delta(si, ei, torch.as_tensor(s_syn, device=dev),
                      torch.as_tensor(r_syn, device=dev),
                      int(events.size) - 1, m_syn)
    note("coflow_merge", abs_err([(coflow_merge(big), alphas_ref(big))]),
         f"a synthetic edge set (K={big.shape[0]})")
    # a switch of m = 1000 ports: four tiles of the scan's port axis
    s_w, r_w = grng.integers(0, 1000, E), grng.integers(0, 1000, E)
    wide = build_delta(si, ei, torch.as_tensor(s_w, device=dev),
                       torch.as_tensor(r_w, device=dev),
                       int(events.size) - 1, 1000)
    note("coflow_merge", abs_err([(coflow_merge(wide), alphas_ref(wide))]),
         f"a synthetic edge set (K={wide.shape[0]}, 2m=2000)")
    del wide   # about 1 GB on the card: free it before later peak readings
    torch.cuda.synchronize()
    print(f"coflow_merge: equal to the plain version on synthetic edge "
          f"sets, K={big.shape[0]}, 2m={big.shape[1]} and 2m=2000")

    # 4. pipeline path, both kernels checked at every call -------------------
    mark("4")
    orig_decompose = pipeline.bna_decompose
    orig_merge_fix_step = backend.merge_fix_step

    def checked_decompose(d, ks, T_cap, t_store=None):
        got = orig_decompose(d, ks, T_cap, t_store=t_store)
        t1 = time.perf_counter()
        counts: dict = {}
        want = bna_decompose_ref(d, ks, T_cap, counts=counts)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        err = abs_err(zip(got, want)) if got[1].shape == want[1].shape \
            else 1 << 30
        note("bna_decompose", err,
             f"a main-path bucket (B={d.shape[0]}, w={d.shape[1]})")
        size = d.shape[0] * d.shape[1]
        if largest["bna_decompose"] is None or \
                size > largest["bna_decompose"][0]:
            largest["bna_decompose"] = (size, (d, ks, T_cap, t_store),
                                        plain_s * 1e3, got[3], counts)
        return got

    def checked_merge_fix(events, t0, t1, s, r, m, *, device):
        got = orig_merge_fix_step(events, t0, t1, s, r, m, device=device)
        args = [torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
                for a in (events, t0, t1, s, r)]
        want = merge_fix_ref(*args, m)
        note("merge_fix", abs_err([(torch.as_tensor(g), w.cpu())
                                   for g, w in zip(got, want)]),
             f"a main-path merge (K={args[0].numel() - 1})")
        if largest["merge_fix"] is None or \
                args[0].numel() > largest["merge_fix"][0][0].numel():
            largest["merge_fix"] = (args, m)
        return got

    pipeline.bna_decompose, backend.merge_fix_step = \
        checked_decompose, checked_merge_fix
    try:
        clear_caches()
        t0 = time.perf_counter()
        plan(paper_workload(m=150, mu_bar=5, seed=0, scale=CHECK_SCALE),
             "gdm", device="cuda", plan_backend="pipeline", seed=0)
        torch.cuda.synchronize()
    finally:
        pipeline.bna_decompose, backend.merge_fix_step = \
            orig_decompose, orig_merge_fix_step
    if not (checked["bna_decompose"] > n_dec_random
            and checked["merge_fix"]):
        _fail(f"checked pipeline run reached no kernel call: {checked}")
    print(f"checked pipeline run (gdm, scale {CHECK_SCALE}): "
          f"{checked['bna_decompose'] - n_dec_random} bna_decompose buckets "
          f"(w up to {largest['bna_decompose'][1][0].shape[1]}) and "
          f"{checked['merge_fix']} merge_fix merges equal to the plain "
          f"versions ({time.perf_counter() - t0:.1f} s)")

    n_mf_path = checked["merge_fix"]
    for seed, (E_r, m_r) in enumerate(((1, 2), (400, 7), (20_000, 150),
                                       (3, 1000), (20_000, 1000))):
        rr = np.random.default_rng(10 + seed)
        t0r = rr.integers(0, 10**6, E_r)
        t1r = t0r + rr.integers(1, 5000, E_r)
        args = [torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (
            np.unique(np.concatenate([t0r, t1r])), t0r, t1r,
            rr.integers(0, m_r, E_r), rr.integers(0, m_r, E_r))]
        note("merge_fix", abs_err(zip(merge_fix(*args, m_r),
                                      merge_fix_ref(*args, m_r))),
             f"a random edge set (E={E_r}, m={m_r})")
    syn_args = [torch.as_tensor(a, dtype=torch.int64, device=dev)
                for a in (events, t0s, t1s, s_syn, r_syn)]
    note("merge_fix", abs_err(zip(merge_fix(*syn_args, m_syn),
                                  merge_fix_ref(*syn_args, m_syn))),
         f"a synthetic edge set (K={events.size - 1})")
    torch.cuda.synchronize()
    print(f"merge_fix: equal to the plain version on "
          f"{checked['merge_fix'] - n_mf_path} random and synthetic edge "
          f"sets (K up to {events.size - 1}, 2m up to 2000)")

    # 5. the main path: python path (card vs CPU), then the pipeline ---------
    mark("5")
    def plans_equal(got, want) -> bool:
        a = transcript_to_arrays(got.transcript())
        b = transcript_to_arrays(want.transcript())
        return len(a) == len(b) and all(
            x[:4] == y[:4] and all(np.array_equal(u, v)
                                   for u, v in zip(x[4:], y[4:]))
            for x, y in zip(a, b)) and got.twct() == want.twct() \
            and got.job_completions() == want.job_completions()

    def timed_plan(inst, sched, plan_backend):
        clear_caches()
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = plan(inst, sched, device="cuda", plan_backend=plan_backend,
                   seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        st = cache_stats()
        verify_schedule(inst, got.schedule)
        verify_transcript(inst, got.transcript())
        return got, wall, launches, st

    # host seconds inside the pipeline's stages, for the time breakdown
    stage_s: dict = {}

    def timed_stage(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    # (timeline._interval_pieces: merge_and_fix's fix-up batch, gdm_rt's
    # decompose=True merges; its bna_decompose and _steps_to_lists calls
    # are in those stages too)
    stages = {(pipeline, "bna_decompose"), (pipeline, "_steps_to_lists"),
              (pipeline, "_rle_batch"), (pipeline, "instance_load_vectors"),
              (backend, "merge_fix_step"), (timeline, "_interval_pieces")}
    saved_stages = {(mod, name): getattr(mod, name) for mod, name in stages}

    def pipeline_plan(inst, sched):
        stage_s.clear()
        for (mod, name), fn in saved_stages.items():
            setattr(mod, name, timed_stage(name, fn))
        try:
            out = timed_plan(inst, sched, "pipeline")
        finally:
            for (mod, name), fn in saved_stages.items():
                setattr(mod, name, fn)
        got, wall, launches, st = out
        dec = st["plan"]["decompose"]
        if min(launches["bna_decompose"], launches["merge_fix"]) == 0:
            _fail(f"{sched} pipeline: a kernel of the path was not launched "
                  f"({launches})")
        fix = st["plan"]["fixup"]
        if st["bna"]["repairs"] or dec["bucket_fallbacks"] \
                or fix["bucket_fallbacks"] or fix["scalar_bna"]:
            _fail(f"{sched} pipeline: {st['bna']['repairs']} host repairs, "
                  f"{dec['bucket_fallbacks']} + {fix['bucket_fallbacks']} "
                  f"int32-overflow buckets, {fix['scalar_bna']} scalar bna")
        return got, {"plan_s_cuda": wall, "launches": launches,
                     "host_repairs": st["bna"]["repairs"],
                     "bucket_fallbacks": dec["bucket_fallbacks"],
                     "buckets": dec["buckets"], "fixup": fix,
                     "stage_s": dict(stage_s)}

    runs, pipe_runs = {}, {}
    for sched, scale in SCALES.items():
        inst = paper_workload(m=150, mu_bar=5, seed=0, scale=scale,
                              rooted=(sched == "gdm_rt"))
        n_cf = sum(j.mu for j in inst.jobs)
        got, wall, launches, st = timed_plan(inst, sched, "python")
        if min(launches["bna_step"], launches["coflow_merge"]) == 0:
            _fail(f"{sched}: a kernel of the python path was not launched "
                  f"({launches})")
        st = st["bna"]
        clear_caches()
        t0 = time.perf_counter()
        want = plan(inst, sched, device="cpu", seed=0)
        wall_cpu = time.perf_counter() - t0
        st_cpu = cache_stats()["bna"]
        if not plans_equal(got, want):
            _fail(f"{sched}: the card's plan differs from the CPU plan "
                  f"(twct {got.twct()} vs {want.twct()})")
        runs[sched] = {"scale": scale, "coflows": n_cf, "twct": got.twct(),
                       "plan_s_cuda": wall, "plan_s_cpu": wall_cpu,
                       "launches": launches, "bna_steps": st["steps"],
                       "host_repairs": st["repairs"],
                       "step_s": st["step_s"], "repair_s": st["repair_s"],
                       "step_s_cpu": st_cpu["step_s"],
                       "repair_s_cpu": st_cpu["repair_s"],
                       "transcript_entries":
                           len(transcript_to_arrays(got.transcript()))}
        print(f"plan {sched} (python path): m=150, scale={scale}, {n_cf} "
              f"coflows, twct {got.twct()}, cuda {wall:.2f} s, cpu "
              f"{wall_cpu:.2f} s, launches {launches}, BNA steps "
              f"{st['steps']} ({st['step_s']:.2f} s), host repairs "
              f"{st['repairs']} ({st['repair_s']:.2f} s); feasible, "
              "bit-equal to the CPU plan")
        pgot, prun = pipeline_plan(inst, sched)
        if not plans_equal(pgot, got):
            _fail(f"{sched}: the pipeline plan differs from the python-path "
                  f"plan (twct {pgot.twct()} vs {got.twct()})")
        pipe_runs[sched] = {"scale": scale, "coflows": n_cf,
                            "twct": pgot.twct(), **prun}
        print(f"plan {sched} (pipeline): scale={scale}, cuda "
              f"{prun['plan_s_cuda']:.2f} s, launches {prun['launches']}, "
              f"host repairs {prun['host_repairs']}, bucket_fallbacks "
              f"{prun['bucket_fallbacks']}, stage s "
              f"{json.dumps(prun['stage_s'])}; feasible, bit-equal to the "
              "python-path plan")
    record["plans"] = runs
    record["pipeline_plans"] = pipe_runs

    # 5b. K2's and K3's CUDA launches a call, read under torch.profiler in
    # a rerun of the main path's gdm plan (python path: K2; pipeline: K3),
    # the counts set to 0 just before: each of a kernel's CUDA kernels must
    # run once a call
    mark("5b")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profiled_launches(plan_backend, wrapper, names) -> dict:
        inst = paper_workload(m=150, mu_bar=5, seed=0, scale=SCALES["gdm"])
        clear_caches()
        zero_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            plan(inst, "gdm", device="cuda", plan_backend=plan_backend,
                 seed=0)
            torch.cuda.synchronize()
        calls = wrapper.launches
        ka = prof.key_averages()
        per = {n: sum(e.count for e in ka if n in e.key
                      and e.device_type == DeviceType.CUDA) for n in names}
        if not calls or any(c != calls for c in per.values()):
            _fail(f"gdm {plan_backend} (profiled): {calls} calls launched "
                  f"{per}, expected each kernel once a call")
        return {"calls": calls, "cuda_kernels": per,
                "per_call": sum(per.values()) / calls}

    record["merge_cuda_launches"] = {
        "coflow_merge": profiled_launches("python", coflow_merge, K2_NAMES),
        "merge_fix": profiled_launches("pipeline", merge_fix, K3_NAMES)}
    print("merge kernels' CUDA launches in a profiled gdm plan (scale "
          f"{SCALES['gdm']}): {json.dumps(record['merge_cuda_launches'])}")

    # 6. the paper's full trace size through the pipeline --------------------
    mark("6")
    full_runs = {}
    widest: dict = {}

    def keep_widest(fn):
        def wrapped(d, ks, T_cap, t_store=None):
            out = fn(d, ks, T_cap, t_store=t_store)
            if d.shape[1] >= widest.get("w", 0):
                widest.update(w=d.shape[1], args=(d, ks, T_cap), out=out)
            return out
        return wrapped

    # the scale-1.0 plans' merges (host arrays)
    full_merges: dict = {sched: [] for sched in FULL_SCALE}

    def keep_merges(fn, kept):
        def wrapped(events, t0, t1, s, r, m, *, device):
            kept.append(((events, t0, t1, s, r), m))
            return fn(events, t0, t1, s, r, m, device=device)
        return wrapped

    for sched in FULL_SCALE:
        inst = paper_workload(m=150, mu_bar=5, seed=0, scale=1.0)
        key, mkey = (pipeline, "bna_decompose"), (backend, "merge_fix_step")
        if sched == "gdm":
            saved_stages[key] = keep_widest(saved_stages[key])
        saved_stages[mkey] = keep_merges(saved_stages[mkey],
                                         full_merges[sched])
        try:
            _, prun = pipeline_plan(inst, sched)
        finally:
            saved_stages[key] = orig_decompose
            saved_stages[mkey] = orig_merge_fix_step
        full_runs[sched] = {"scale": 1.0,
                            "coflows": sum(j.mu for j in inst.jobs), **prun}
        print(f"plan {sched} (pipeline): scale=1.0, "
              f"{full_runs[sched]['coflows']} coflows, cuda "
              f"{prun['plan_s_cuda']:.2f} s, launches {prun['launches']}, "
              f"host repairs {prun['host_repairs']}, bucket_fallbacks "
              f"{prun['bucket_fallbacks']}, stage s "
              f"{json.dumps(prun['stage_s'])}; feasible")
    record["full_scale_plans"] = full_runs
    record["full_scale_merge_shapes"] = {
        sched: [{"K": a[0].size - 1, "E": a[1].size} for a, _ in kept]
        for sched, kept in full_merges.items()}

    # the scale-1.0 gdm merge stage, split: each merge's kernel device time
    # (CUDA events) against the stage's host seconds (the wrapper's staging:
    # host-to-device copies, scratch, the launch, the copies back)
    mf_dev = [([torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                                device=dev) for a in args], m_)
              for args, m_ in full_merges["gdm"]]
    kernel_ms = [_cuda_ms(lambda a=a, m_=m_: merge_fix(*a, m_), reps=20,
                          rounds=3) for a, m_ in mf_dev]
    stage_ms = full_runs["gdm"]["stage_s"]["merge_fix_step"] * 1e3
    mf_full = max(mf_dev, key=lambda x: x[0][0].numel())
    note("merge_fix", abs_err(zip(merge_fix(*mf_full[0], mf_full[1]),
                                  merge_fix_ref(*mf_full[0], mf_full[1]))),
         f"the largest scale-1.0 merge (K={mf_full[0][0].numel() - 1})")
    record["full_scale_merge_stage"] = {
        "calls": len(mf_dev), "stage_ms": stage_ms,
        "kernel_ms": sum(kernel_ms), "staging_ms": stage_ms - sum(kernel_ms),
        "per_call": [{"K": a[0].numel() - 1, "E": a[1].numel(), "ms": t}
                     for (a, _), t in zip(mf_dev, kernel_ms)]}
    print("gdm scale-1.0 merge stage, split (ms): "
          + json.dumps(record["full_scale_merge_stage"]))
    del mf_dev   # up to a gigabyte of edges: free it before peak readings
    # om_alg's scale-1.0 merge, the main path's largest: checked and timed
    oa, oa_m = max(full_merges["om_alg"], key=lambda x: x[0][0].size)
    oa_args = [torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=dev) for a in oa]
    Ko, Eo = oa_args[0].numel() - 1, oa_args[1].numel()
    note("merge_fix", abs_err(zip(merge_fix(*oa_args, oa_m),
                                  merge_fix_ref(*oa_args, oa_m))),
         f"om_alg's scale-1.0 merge (K={Ko})")
    record["merge_fix_om_alg_1.0"] = {
        "shape": [Ko, 2 * oa_m, Eo],
        "ms": _cuda_ms(lambda: merge_fix(*oa_args, oa_m)),
        "plain_ms": _cuda_ms(lambda: merge_fix_ref(*oa_args, oa_m), reps=3,
                             rounds=3),
        "bound_ms": 8 * (Ko + 1 + 4 * Eo + 2 * Ko) / HBM_BYTES_PER_S * 1e3}
    print(f"merge_fix at om_alg's scale-1.0 merge: "
          f"{json.dumps(record['merge_fix_om_alg_1.0'])}")
    del oa, oa_args

    # the scale-1.0 lane with the longest chain, alone and inside its
    # bucket, against the plain version on the CPU
    (d, ks, T_cap), (ts_b, pc_b, _, ns_b) = widest["args"], widest["out"]
    lane = int(ns_b.argmax())
    one = (d[lane:lane + 1], ks[lane:lane + 1])
    got1 = bna_decompose(*one, T_cap)
    lane_counts: dict = {}
    t0 = time.perf_counter()
    want1 = bna_decompose_ref(one[0].cpu(), one[1].cpu(), T_cap,
                              counts=lane_counts)
    plain_lane_s = time.perf_counter() - t0
    n1 = int(want1[3][0])
    in_bucket = [ts_b[lane:lane + 1, :n1], pc_b[lane:lane + 1, :n1]]
    note("bna_decompose", abs_err(
        [(x.cpu(), y) for x, y in zip(got1, want1)]
        + [(x.cpu(), y) for x, y in zip(in_bucket, want1[:2])])
        if got1[1].shape == want1[1].shape else 1 << 30,
        f"the longest scale-1.0 lane (k={int(ks[lane])})")
    record["full_scale_longest_lane"] = {
        "bucket": list(d.shape), "lane": lane, "k": int(ks[lane]),
        "nnz": int((d[lane] > 0).sum()), "steps": n1,
        **{name: v[0] for name, v in lane_counts.items()},
        "plain_s_cpu": plain_lane_s}
    print("longest scale-1.0 lane equal to the plain version, alone and in "
          "its bucket: " + json.dumps(record["full_scale_longest_lane"]))
    # the bucket's stacks hold gigabytes: free them before later phases
    # read peak memory
    widest.clear()
    del d, ks, ts_b, pc_b, ns_b, one, got1, want1, in_bucket

    # 6b. a switch of m = 1000 ports, past the 908 whose scan tile once
    # overflowed a block's shared memory: both paths on the card == CPU
    mark("6b")
    inst_w = paper_workload(m=1000, mu_bar=2, seed=0, scale=0.01)
    wide_runs = {}
    for plan_backend in ("pipeline", "python"):
        got, wall, launches, _ = timed_plan(inst_w, "gdm", plan_backend)
        path = ("bna_decompose", "merge_fix") if plan_backend == "pipeline" \
            else ("bna_step", "coflow_merge")
        if min(launches[k] for k in path) == 0:
            _fail(f"m=1000 {plan_backend}: a kernel of the path was not "
                  f"launched ({launches})")
        clear_caches()
        want = plan(inst_w, "gdm", device="cpu", plan_backend=plan_backend,
                    seed=0)
        if not plans_equal(got, want):
            _fail(f"m=1000 {plan_backend}: the card's plan differs from the "
                  f"CPU plan (twct {got.twct()} vs {want.twct()})")
        wide_runs[plan_backend] = {"plan_s_cuda": wall, "twct": got.twct(),
                                   "launches": launches}
    record["wide_switch_plans"] = wide_runs
    print("plan gdm at m=1000 (scale 0.01) on the card, equal to the CPU "
          "through both paths: " + json.dumps(wide_runs))

    # with the caches off the engine cannot prefetch, and the walk's
    # per-coflow misses must still decompose through the kernel
    inst_nc = paper_workload(m=150, mu_bar=5, seed=0, scale=0.05)
    clear_caches()
    cached = plan(inst_nc, "gdm", device="cuda", plan_backend="python",
                  seed=0)
    batches = cache_stats()["bna"]["batch"]["batches"]
    bna_step.launches = 0
    with no_caches():
        uncached = plan(inst_nc, "gdm", device="cuda", plan_backend="python",
                        seed=0)
    torch.cuda.synchronize()
    if bna_step.launches == 0 or \
            cache_stats()["bna"]["batch"]["batches"] != batches:
        _fail(f"gdm without caches: {bna_step.launches} bna_step launches")
    if uncached.twct() != cached.twct() or \
            uncached.job_completions() != cached.job_completions():
        _fail("gdm without caches differs from the cached plan")
    record["no_caches_bna_step_launches"] = bna_step.launches
    print(f"plan gdm without caches (python path, scale 0.05): "
          f"{bna_step.launches} bna_step launches, equal to the cached plan")

    inst = paper_workload(m=150, mu_bar=5, seed=0, scale=SCALES["gdm"])
    small = sorted((c.demand for j in inst.jobs for c in j.coflows),
                   key=lambda d: int((d > 0).sum()))[:4]
    for d, pieces in zip(small, bna_many(small, device="cuda")):
        want = bna(d)
        if len(pieces) != len(want) or any(
                t1 != t2 or not np.array_equal(p1, p2)
                for (t1, p1), (t2, p2) in zip(pieces, want)):
            _fail("bna_many on the card != the scalar BNA")
    print(f"bna_many on the card equals the scalar BNA on {len(small)} "
          "coflows")

    # 6d. the online scheduler at the paper's cluster size: the figure's
    # pair at scale 0.35, session and batch drivers on the pipeline, the
    # first replan of every run through checked bna_decompose and merge_fix
    # (plain versions on CPU copies of the same inputs).  Run in this
    # process while phase 6c's workers run (defined here, called there)
    mark("6d")
    online_checked = {"bna_decompose": 0, "merge_fix": 0}
    online_check_s = [0.0]

    def online_decompose(d, ks, T_cap, t_store=None):
        out = orig_decompose(d, ks, T_cap, t_store=t_store)
        t0 = time.perf_counter()
        want = bna_decompose_ref(d.cpu(), ks.cpu(), T_cap)
        got = [x.cpu() for x in out]
        note("bna_decompose", abs_err(zip(got, want))
             if got[1].shape == want[1].shape else 1 << 30,
             f"an online replan's bucket (B={d.shape[0]}, w={d.shape[1]})")
        online_checked["bna_decompose"] += 1
        online_check_s[0] += time.perf_counter() - t0
        return out

    def online_merge_fix(events, t0, t1, s, r, m, *, device):
        got = orig_merge_fix_step(events, t0, t1, s, r, m, device=device)
        t_check = time.perf_counter()
        args = [torch.as_tensor(np.asarray(a, dtype=np.int64))
                for a in (events, t0, t1, s, r)]
        want = merge_fix_ref(*args, m)
        note("merge_fix", abs_err([(torch.as_tensor(g), w)
                                   for g, w in zip(got, want)]),
             f"an online replan's merge (K={args[0].numel() - 1})")
        online_checked["merge_fix"] += 1
        online_check_s[0] += time.perf_counter() - t_check
        return got

    def online_check(on: bool) -> float:
        """Install (on) or remove the checked wrappers; removing returns
        the seconds the checks took since they were installed."""
        pipeline.bna_decompose = online_decompose if on else orig_decompose
        backend.merge_fix_step = online_merge_fix if on \
            else orig_merge_fix_step
        spent, online_check_s[0] = online_check_s[0], 0.0
        return 0.0 if on else spent

    def online_line(r) -> str:
        ss = r["session"]
        counts = "" if ss is None else (
            f"repairs {ss['repairs']}, full replans {ss['full_replans']}, ")
        lp = r["launches_per_replan"]
        return (f"{r['jobs']} jobs, {r['coflows']} coflows: reschedules "
                f"{r['reschedules']}, {counts}per-replan wall ms "
                f"{json.dumps({k: round(v, 3) if v is not None else v for k, v in r['replan_wall'].items()})}, "
                f"run {r['wall_s']:.2f} s (checks {r['check_s']:.2f} s); "
                f"gkey prefix {json.dumps(r['gkey_prefix'])}; hit rates "
                f"{json.dumps({k: round(v, 4) for k, v in r['hit_rates'].items()})}; "
                f"launches per replan bna_decompose "
                f"{lp['bna_decompose']:.2f}, merge_fix {lp['merge_fix']:.2f}; "
                f"twct {r['twct']}")

    def online_pair() -> dict:
        out = {}
        for sched in ("gdm", "om_alg"):
            for a in ONLINE_RATES:
                for driver in ("session", "batch"):
                    job = (sched, ONLINE_SCALE, a, "cuda", "pipeline", driver)
                    n0 = dict(online_checked)
                    try:
                        out[job] = _online_plan(job, check=online_check)
                    except RuntimeError as err:
                        _fail(str(err))
                    torch.cuda.synchronize()
                    if not all(online_checked[k] > n0[k] for k in n0):
                        _fail(f"{job}: the first replan reached no checked "
                              f"bna_decompose or merge_fix call")
                a_, b_ = (out[(sched, ONLINE_SCALE, a, "cuda", "pipeline", d)]
                          for d in ("session", "batch"))
                if not (a_["job_completions"] == b_["job_completions"]
                        and a_["twct"] == b_["twct"]
                        and a_["reschedules"] == b_["reschedules"]):
                    _fail(f"online {sched} a={a}: the session driver differs "
                          f"from the batch driver on the card (twct "
                          f"{a_['twct']} vs {b_['twct']})")
        return out

    # 6c. backfilling: the *_bf schedulers --------------------------------
    # (a) at scale 0.1 on both plan backends on the card, each equal to the
    # same plan on the CPU, and (c) the larger scales through the pipeline.
    # The host's packet sweep and the python path's host repair dominate
    # these runs, so all but the pipeline's 0.1 runs (this process) go to
    # spawned workers that share the host and the card with it
    mark("6c")
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    def bf_checked(d, ks, T_cap, out):
        want = bna_decompose_ref(d.cpu(), ks.cpu(), T_cap)
        got = [x.cpu() for x in out]
        note("bna_decompose", abs_err(zip(got, want))
             if got[1].shape == want[1].shape else 1 << 30,
             f"a fix-up bucket (B={d.shape[0]}, w={d.shape[1]})")
        bf_check["buckets"] += 1
        bf_check["lanes"] += d.shape[0]

    def bf_same(a, b) -> bool:
        return all(a[k] == b[k] for k in (
            "digest", "entries", "job_completions", "coflow_completions",
            "twct", "makespan"))

    def bf_line(run) -> str:   # the whole run goes to the record
        sp, fx = run["split"], run["fixup"]
        dev_ms = "-" if fx["device_ms"] is None else f"{fx['device_ms']:.1f}"
        return (f"twct {run['twct']} (plan {run['plan_twct']}); wall "
                f"{sp['wall_s']:.2f} s: plan {sp['plan_s']:.2f}, prefetch "
                f"{sp['prefetch_s']:.2f}, fix-up {sp['fixup_s']:.2f} (walk "
                f"{fx['walk_s']:.2f}, batch {fx['batch_s']:.2f} [device "
                f"{dev_ms} ms, _steps_to_lists {fx['steps_to_lists_s']:.2f}, "
                f"staging {fx['staging_s']:.2f}], emit {fx['emit_s']:.2f}; "
                f"{fx['lanes']} lanes, {fx['buckets']} buckets, "
                f"{fx['launches']} launches), sweep {sp['sweep_s']:.2f}; "
                f"launches {run['launches']}, host repairs "
                f"{run['host_repairs']}")

    bf_check = {"buckets": 0, "lanes": 0}
    backends = ("python", "pipeline")
    bf_jobs = [(s_, "packet", BF_SCALE) for s_ in BF_SCHEDS] \
        + [("gdm_bf", "ledger", BF_SCALE)]
    large_jobs = [(s_, "packet", sc, "cuda", "pipeline")
                  for s_, sc in BF_LARGE.items()]
    # longest first: the larger scales, the CPU's python backend, the
    # card's python backend, the CPU's pipeline
    worker_jobs = large_jobs + [(*j, "cpu", "python") for j in bf_jobs] \
        + [(*j, "cuda", "python") for j in bf_jobs] \
        + [(*j, "cpu", "pipeline") for j in bf_jobs]
    # phase 6e's online runs at 0.1 (card and CPU, both plan backends) and
    # phase 6f's streaming cells go to the same pool
    online_jobs = [(s_, ONLINE_CPU_SCALE, 1, dv, pb, "session")
                   for pb in ("python", "pipeline") for s_ in ONLINE_CPU_SCHEDS
                   for dv in ("cuda", "cpu")]
    stream_jobs_ = [
        (f"{proc}_{s_}_spread" + ("_pinned" if g == "pinned" else ""), s_,
         proc, g, STREAM_JOBS, STREAM["load"], None)
        for proc in ("poisson", "mmpp") for s_ in ("gdm", "gdm_rt")
        for g in ("residual", "pinned")] + [
        ("overload_mmpp_gdm_spread", "gdm", "mmpp", "residual",
         STREAM_OVERLOAD_JOBS, STREAM["overload"], STREAM_POLICY)]
    # phase 6g's CPU side (the zoo) goes to the same pool: its three
    # longest runs right after the larger scales, the rest at the end
    zoo_cpu = _zoo_jobs("cpu")
    # the card side's three FB-calibrated gdm_rt runs (47-60 s each, host
    # bound: the fix-up's walk) go to the pool too, right after the larger
    # scales: in this process they set the phase's length (on one run the
    # pool ended at 331 s, this process at 407 s; ``pool_done_s``)
    zoo_card_jobs = _zoo_jobs("cuda")
    submissions = [(_bf_worker, j) for j in worker_jobs[:len(large_jobs)]] \
        + [(_zoo_worker, j) for j in zoo_card_jobs[:3]] \
        + [(_zoo_worker, j) for j in zoo_cpu[:3]] \
        + [(_bf_worker, j) for j in worker_jobs[len(large_jobs):len(
            large_jobs) + 2 * len(bf_jobs)]] \
        + [(_online_worker, j) for j in online_jobs[:6]] \
        + [(_stream_cell, j) for j in stream_jobs_] \
        + [(_bf_worker, j) for j in worker_jobs[len(large_jobs)
                                                + 2 * len(bf_jobs):]] \
        + [(_online_worker, j) for j in online_jobs[6:]] \
        + [(_zoo_worker, j) for j in zoo_cpu[3:]]
    t_bf = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=BF_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    pool_done: dict = {}     # worker job -> the second it ended

    def done_at(label: str) -> None:
        pool_done[label] = round(time.perf_counter() - t_bf, 1)

    try:
        futures = {}
        for fn, job in submissions:
            futures[job] = pool.submit(fn, job)
            futures[job].add_done_callback(
                lambda _f, label=f"{fn.__name__} {job}": done_at(label))
        bf_runs: dict = {}
        for j in bf_jobs:
            job = (*j, "cuda", "pipeline")
            try:
                bf_runs[job] = _bf_plan(job, check=bf_checked if j[0] ==
                                        "gdm_rt_bf" else None)
            except RuntimeError as err:
                _fail(str(err))
            torch.cuda.synchronize()
        if not bf_check["buckets"]:
            _fail("gdm_rt_bf: no fix-up bucket reached bna_decompose")
        t_online = time.perf_counter()
        online_runs = online_pair()     # phase 6d, while the workers run
        online_pair_s = time.perf_counter() - t_online
        t_zoo = time.perf_counter()
        zoo_card: dict = {}
        for job in zoo_card_jobs[3:]:     # phase 6g's card side, meanwhile
            try:
                zoo_card[job[:3]] = _zoo_run(job)
            except RuntimeError as err:
                _fail(str(err))
        zoo_card_s = time.perf_counter() - t_zoo
        pool_runs: dict = {}
        for job, fut in futures.items():
            try:
                pool_runs[job] = fut.result()
            except RuntimeError as err:
                _fail(str(err))
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    bf_s = time.perf_counter() - t_bf
    bf_runs.update({j: pool_runs.pop(j) for j in worker_jobs})
    zoo_card.update({j[:3]: pool_runs.pop(j) for j in zoo_card_jobs[:3]})
    for j in bf_jobs:
        for pb in backends:
            card, cpu = bf_runs[(*j, "cuda", pb)], bf_runs[(*j, "cpu", pb)]
            if not bf_same(card, cpu):
                _fail(f"{j} {pb}: the card's plan differs from the CPU's "
                      f"(twct {card['twct']} vs {cpu['twct']})")
        a, b = (bf_runs[(*j, "cuda", pb)] for pb in backends)
        if not all(a[k] == b[k] for k in ("job_completions", "twct",
                                           "makespan")):
            _fail(f"{j}: the two plan backends differ (twct {a['twct']} "
                  f"vs {b['twct']})")
        for pb in backends:
            print(f"plan {j[0]} exec={j[1]} ({pb}, scale {j[2]}): "
                  f"{bf_line(bf_runs[(*j, 'cuda', pb)])}; equal to the CPU")
    bf_large = {job[0]: bf_runs.pop(job) for job in large_jobs}
    for job in large_jobs:
        print(f"plan {job[0]} (pipeline, scale {job[2]}): "
              f"{bf_line(bf_large[job[0]])}; feasible, no worse than its "
              "plan")
    print(f"gdm_rt_bf (pipeline, scale {BF_SCALE}): {bf_check['buckets']} "
          f"fix-up buckets ({bf_check['lanes']} lanes) equal to "
          f"bna_decompose's plain version; phase 6c took {bf_s:.1f} s with "
          f"{BF_WORKERS} workers")
    keep = ("job", "coflows", "twct", "plan_twct", "makespan", "entries",
            "split", "fixup", "launches", "host_repairs", "scalar_bna",
            "verify_s")
    record["bf_check"] = dict(bf_check)
    record["bf_s"] = bf_s
    record["pool_done_s"] = pool_done
    print("phase 6c's pool, the last jobs to end (s from its start): "
          + json.dumps(dict(sorted(pool_done.items(),
                                   key=lambda kv: kv[1])[-5:])))
    record["bf_plans"] = [{k: r[k] for k in keep} for r in bf_runs.values()]
    record["bf_large"] = {s_: {k: r[k] for k in keep}
                          for s_, r in bf_large.items()}

    # 6d (cont.): the pair's record, then gdm at scale 1.0 alone ----------
    mark("6d-cont")
    def online_keep(r) -> dict:
        return {k: v for k, v in r.items() if k != "job_completions"}

    gains = {}
    for a in ONLINE_RATES:
        for sched in ("gdm", "om_alg"):
            r = online_runs[(sched, ONLINE_SCALE, a, "cuda", "pipeline",
                             "session")]
            print(f"online {sched} (pipeline, scale {ONLINE_SCALE}, theta = "
                  f"{a} theta0, session): {online_line(r)}; equal to the "
                  "batch driver")
        g_, o_ = (online_runs[(s_, ONLINE_SCALE, a, "cuda", "pipeline",
                               "session")]["twct"] for s_ in ("gdm", "om_alg"))
        gains[a] = 1 - g_ / o_
    print(f"online pair gain 1 - twct(gdm)/twct(om_alg) at scale "
          f"{ONLINE_SCALE}: {json.dumps(gains)}; checked online calls "
          f"{json.dumps(online_checked)}; the pair took {online_pair_s:.1f} s "
          f"beside phase 6c's workers")
    sched, scale, a = ONLINE_FULL
    try:
        full_online = _online_plan((sched, scale, a, "cuda", "pipeline",
                                    "session"))
    except RuntimeError as err:
        _fail(str(err))
    print(f"online {sched} (pipeline, scale {scale}, theta = {a} theta0, "
          f"session, alone): {online_line(full_online)}")
    record["online"] = {
        "pair": [online_keep(r) for r in online_runs.values()],
        "gain": gains, "checked": dict(online_checked),
        "pair_s": online_pair_s, "full": online_keep(full_online)}

    # 6e. card against CPU at 0.1, both plan backends (phase 6c's pool) ----
    mark("6e")
    counts_keys = ("reschedules", "repairs", "full_replans", "repair_rejects",
                   "groups_reused", "groups_replanned")
    for sched in ONLINE_CPU_SCHEDS:
        rs = [pool_runs[(sched, ONLINE_CPU_SCALE, 1, dv, pb, "session")]
              for pb in ("python", "pipeline") for dv in ("cuda", "cpu")]
        ref_ = rs[0]
        for r in rs[1:]:
            if not (r["job_completions"] == ref_["job_completions"]
                    and r["twct"] == ref_["twct"]
                    and {k: r["session"][k] for k in counts_keys}
                    == {k: ref_["session"][k] for k in counts_keys}):
                _fail(f"online {sched} at {ONLINE_CPU_SCALE}: {r['job'][3:5]}"
                      f" differs from {ref_['job'][3:5]} (twct {r['twct']} vs "
                      f"{ref_['twct']})")
        print(f"online {sched} at scale {ONLINE_CPU_SCALE}: card == CPU on "
              f"both plan backends (twct {ref_['twct']}, reschedules "
              f"{ref_['reschedules']}); card python path "
              f"{rs[0]['wall_s']:.2f} s, launches {rs[0]['launches']}; card "
              f"pipeline {rs[2]['wall_s']:.2f} s, launches "
              f"{rs[2]['launches']}")
    record["online_card_cpu"] = [online_keep(pool_runs.pop(j))
                                 for j in online_jobs]

    # 6f. BENCH_serve's cells through the streaming harness (the pool) ----
    mark("6f")
    bench_rows = {r["cell"]: r for r in json.loads(
        (ROOT / "benchmarks" / "results" / "BENCH_serve.json").read_text()
    )["rows"]}
    stream_rows = []
    for job in stream_jobs_:
        row = pool_runs.pop(job)
        want = bench_rows[job[0]]
        if any(row[k] != want[k] for k in STREAM_KEYS):
            _fail(f"stream {job[0]}: "
                  f"{ {k: row[k] for k in STREAM_KEYS} } != BENCH_serve.json "
                  f"{ {k: want[k] for k in STREAM_KEYS} }")
        stream_rows.append(row)
        print(f"stream {job[0]} ({row['n_jobs']} jobs, pipeline): p50 "
              f"{row['p50_ms']:.2f} ms, p95 {row['p95_ms']:.2f} ms, p99 "
              f"{row['p99_ms']:.2f} ms, {row['jobs_per_sec']:.2f} jobs/s; "
              f"repairs {row['session_repairs']}, full replans "
              f"{row['session_full_replans']} (hit rate "
              f"{row['session_repair_hit_rate']}), deferred "
              f"{row['deferred']}, rejected {row['rejected']}, twct "
              f"{row['twct']}, launches {row['launches']}; equal to "
              "BENCH_serve.json")
    record["stream"] = {"rows": stream_rows, "left_out": [
        "poisson_om_alg", "mmpp_om_alg"], "workers": BF_WORKERS}

    # 6g. the zoo: (a), (c)-(e) card == CPU (the CPU side in the pool) ----
    mark("6g")
    from repro_torch import scenarios

    smi_zoo = _nvidia_smi()
    zoo_rows = []
    for job in zoo_cpu:
        cpu, card = pool_runs.pop(job), zoo_card[job[:3]]
        kind = job[0]
        keys = {"online": ("twct", "job_completions", "reschedules",
                           "session"),
                "planner": ("phases",)}.get(kind, ZOO_KEYS)
        if any(card[k] != cpu[k] for k in keys):
            diff = [k for k in keys if card[k] != cpu[k]]
            _fail(f"zoo {job[:3]}: the card differs from the CPU in {diff}")
        zoo_rows.append({**{k: v for k, v in card.items()
                            if k != "job_completions"},
                         "cpu_wall_s": cpu["wall_s"]})
    rows_by = {tuple(r["job"][:3]): r for r in zoo_rows}

    def zoo_cell(r) -> str:
        return (f"wall {r['wall_s']:.3f} s (CPU {r['cpu_wall_s']:.2f} s), "
                f"launches bna_decompose {r['launches']['bna_decompose']}, "
                f"merge_fix {r['launches']['merge_fix']}, widest bucket "
                f"(B, w) {r['widest_bucket']}")

    print(f"zoo (phase 6g) on {smi_zoo}; card runs {zoo_card_s:.1f} s in "
          "this process beside the pool (the three FB-calibrated gdm_rt "
          "runs in the pool); every card run equal to the CPU's")
    for (kind, what, sched), r in rows_by.items():
        if kind == "defaults":
            print(f"zoo {what} (defaults, m={r['m']}, {r['coflows']} "
                  f"coflows) {sched}: twct {r['twct']}, {zoo_cell(r)}")
        elif kind == "bf":
            print(f"zoo {what} (MID) {sched}: twct {r['twct']} (plan "
                  f"{r['plan_twct']}), {zoo_cell(r)}")
        elif kind == "online":
            w = r["replan_wall"]
            print(f"zoo online_poisson (MID, session) {sched}: "
                  f"{r['jobs']} jobs, reschedules {r['reschedules']}, "
                  f"counters {json.dumps(r['session'])}, per-replan ms "
                  f"p50 {w['p50_ms']:.2f} p95 {w['p95_ms']:.2f} max "
                  f"{w['max_ms']:.2f} ({[round(x, 2) for x in r['replan_ms']]}), "
                  f"twct {r['twct']}, {zoo_cell(r)}")
        elif kind == "gap":
            print(f"zoo Lemma 2 gap_instance(K={what}, d=1) ({r['coflows']} "
                  f"coflows, m={r['m']}) {sched}: makespan {r['makespan']}, "
                  f"Delta = T = {r['delta']}, (2K+1)Kd = {r['optimum']}, "
                  f"{zoo_cell(r)}")
        elif kind == "fsp":
            print(f"zoo Theorem 1 fsp_to_coflow_job({ZOO_FSP[0]} x "
                  f"{ZOO_FSP[1]}) {sched}: makespan {r['makespan']}, "
                  f"verify_schedule holds, {zoo_cell(r)}")
        else:
            print(f"zoo planner ({ZOO_PLANNER['rows']} x "
                  f"{ZOO_PLANNER['cols']} pod, {ZOO_PLANNER['n_ops']} ops in "
                  f"{ZOO_PLANNER['n_buckets']} buckets, "
                  f"{len(r['phases'])} phases on one session): "
                  + "; ".join(
                      f"phase {i}: makespan {ph['planner_makespan']} vs "
                      f"naive {ph['naive_makespan']}, gain "
                      f"{ph['makespan_gain']:.4f}"
                      for i, ph in enumerate(r["phases"]))
                  + f"; session {json.dumps(r['session'])}, {zoo_cell(r)}")

    # (b) the paper's fabric, m = ZOO_M, scale 1.0, on the card alone: the
    # pipeline with phase 5's stage split; then packet-level plans
    # (decompose=True) under verify_schedule while the budget lasts
    t_fab = time.perf_counter()
    zoo_widest: dict = {}
    zoo_edges = [0]
    key, mkey = (pipeline, "bna_decompose"), (backend, "merge_fix_step")

    def zoo_count_edges(fn):
        def wrapped(events, t0, t1, s, r, m, *, device):
            zoo_edges[0] += len(s)
            return fn(events, t0, t1, s, r, m, device=device)
        return wrapped

    def zoo_keep_widest(fn):
        def wrapped(d, ks, T_cap, t_store=None):
            B, w = int(d.shape[0]), int(d.shape[1])
            if (w, B) > zoo_widest.get("wB", (0, 0)):
                zoo_widest["wB"] = (w, B)
            return fn(d, ks, T_cap, t_store=t_store)
        return wrapped

    cheap_first = ("dist_collectives", "deep_chain", "wide_shallow",
                   "incast", "alibaba_sparse", "shuffle_heavy", "fb_like",
                   "fb_like_rt", "online_poisson")
    if sorted(cheap_first) != scenarios.names():
        _fail(f"the zoo's scenarios changed: {scenarios.names()}")
    fabric = {}
    for name in cheap_first:
        built = scenarios.build(name, m=ZOO_M, seed=0, scale=1.0)
        inst = scenarios.strip_releases(built.instance)
        for sched in ZOO_FABRIC:
            zoo_widest.clear()
            zoo_edges[0] = 0
            saved_stages[key] = zoo_keep_widest(orig_decompose)
            saved_stages[mkey] = zoo_count_edges(orig_merge_fix_step)
            try:
                _, prun = pipeline_plan(inst, sched)
            finally:
                saved_stages[key] = orig_decompose
                saved_stages[mkey] = orig_merge_fix_step
            fabric[(name, sched)] = {
                "scenario": name, "sched": sched, "m": inst.m,
                "coflows": sum(j.mu for j in inst.jobs),
                "merged_edges": zoo_edges[0],
                "widest_bucket": zoo_widest["wB"][::-1], **prun}
            print(f"zoo fabric {name} (m={inst.m}, scale 1.0, "
                  f"{fabric[(name, sched)]['coflows']} coflows) {sched}: "
                  f"wall {prun['plan_s_cuda']:.3f} s, launches "
                  f"bna_decompose {prun['launches']['bna_decompose']}, "
                  f"merge_fix {prun['launches']['merge_fix']}, widest "
                  f"bucket (B, w) {fabric[(name, sched)]['widest_bucket']}, "
                  f"{zoo_edges[0]} merged edges, stage s "
                  f"{json.dumps(prun['stage_s'])}; feasible")
    for (name, sched), row in fabric.items():
        if row["merged_edges"] > ZOO_PACKET_EDGES or \
                time.perf_counter() - t_fab > ZOO_FABRIC_BUDGET_S:
            row["packet_check"] = None
            continue
        built = scenarios.build(name, m=ZOO_M, seed=0, scale=1.0)
        inst = scenarios.strip_releases(built.instance)
        clear_caches()
        t0 = time.perf_counter()
        pd = plan(inst, sched, device="cuda", seed=0, decompose=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        verify_schedule(inst, pd.schedule, check_packets=True)
        row["packet_check"] = {"plan_s_cuda": wall,
                               "total_s": time.perf_counter() - t0}
    fabric_s = time.perf_counter() - t_fab
    checked_pk = [f"{n}/{s_}" for (n, s_), r in fabric.items()
                  if r["packet_check"]]
    print(f"zoo fabric: {len(checked_pk)} of {len(fabric)} plans also "
          f"planned with decompose=True and held by verify_schedule at the "
          f"packet level ({', '.join(checked_pk)}); the rest left out (more "
          f"than {ZOO_PACKET_EDGES} merged edges, or past the "
          f"{ZOO_FABRIC_BUDGET_S:.0f} s budget); (b) took {fabric_s:.1f} s "
          f"on {smi_zoo}")
    record["zoo"] = {"rows": zoo_rows, "card_s": zoo_card_s,
                     "fabric": list(fabric.values()), "fabric_s": fabric_s,
                     "nvidia_smi": smi_zoo}

    def zoo_launches(name: str) -> dict:
        """A kernel's launches per plan in the zoo's card runs."""
        label = {"defaults": "{}", "gap": "gap K={}", "fsp": "fsp {}"}
        out_ = {label[r["job"][0]].format(
            r["job"][1] if r["job"][0] != "fsp" else "x".join(
                map(str, ZOO_FSP))) + f"/{r['job'][2]}": r["launches"][name]
                for r in zoo_rows if r["job"][0] in label}
        out_.update({f"{r['scenario']}@{ZOO_M}/{r['sched']}":
                     r["launches"][name] for r in fabric.values()})
        return out_

    def online_per_replan(name: str) -> dict:
        """A kernel's launches per replan in this slice's session runs on
        the card (6d's pair and scale-1.0 run; 6e's card runs)."""
        rs = [r for r in [*record["online"]["pair"], record["online"]["full"],
                          *record["online_card_cpu"]]
              if r["job"][3] == "cuda" and r["job"][5] == "session"]
        return {f"{r['job'][0]}@{r['job'][1]} a={r['job'][2]} "
                f"{r['job'][4]}": r["launches_per_replan"][name]
                for r in rs if r["launches"][name]}

    # 7. flash_attention (K4) against its plain version --------------------
    mark("7")
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_lm, layers, prefill
    from repro_torch.models.lm import tree_map
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    from repro_torch.serve import engine as serve_engine

    # the largest attn_rel_err over every wgmma-route launch checked
    wgmma_rel = {"row": 0.0, "head": 0.0, "checked": 0}

    def note_attn(got, want, q, what: str) -> None:
        """Holds a K4 launch's output `got` on q to its plain version `want`:
        within ATTN_TOL, and on the wgmma route within WGMMA_REL_TOL."""
        name = str(q.dtype).split(".")[-1]
        if got.dtype != q.dtype or got.shape != q.shape:
            _fail(f"flash_attention on {what}: {got.dtype} "
                  f"{tuple(got.shape)}, expected {q.dtype} {tuple(q.shape)}")
        err = float((got.float() - want.float()).abs().max())
        max_err["flash_attention"] = max(max_err["flash_attention"], err)
        checked["flash_attention"] += 1
        if not err < ATTN_TOL[name]:
            _fail(f"flash_attention != plain version on {what} "
                  f"({name}, max |diff| {err} >= {ATTN_TOL[name]})")
        if forward_kernel(q.dtype, q.shape[3]) != "wgmma":
            return
        rel = attn_rel_err(got, want)
        wgmma_rel["checked"] += 1
        for key, tol in WGMMA_REL_TOL.items():
            wgmma_rel[key] = max(wgmma_rel[key], rel[key])
            if not rel[key] <= tol:
                _fail(f"flash_attention (wgmma) != plain version on {what}: "
                      f"{key} relative error {rel[key]} > {tol}")

    attn_shapes = [(1, 2, 2, 16, 16, 32), (2, 4, 2, 33, 33, 24),
                   (1, 8, 2, 64, 128, 48), (1, 4, 1, 1, 96, 64),
                   (1, 4, 4, 48, 48, 128)] + \
        [(1, 16, 8, S, S, 128) for S in (1, 127, 2048)] + list(FAMILY_ATTN)
    arng = np.random.default_rng(7)
    for shape in attn_shapes:
        B, Hq, Hkv, Sq, Sk, d = shape
        arrays = [arng.normal(size=sz).astype(np.float32) for sz in
                  ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d))]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.as_tensor(a).to(dev, dtype) for a in arrays)
            for causal in (True, False):
                note_attn(flash_attention(q, k, v, causal=causal),
                          attention_ref(q, k, v, causal=causal), q,
                          f"shape {shape}, causal={causal}")
    torch.cuda.synchronize()
    print(f"flash_attention: within tolerance of the plain version on "
          f"{checked['flash_attention']} cases ({len(attn_shapes)} shapes x "
          f"f32/bf16 x "
          f"causal or not; max |diff| {max_err['flash_attention']:.3g}); "
          f"the wgmma route's {wgmma_rel['checked']} within "
          f"{WGMMA_REL_TOL} of their own size: worst row "
          f"{wgmma_rel['row']:.3g}, worst (batch, head) "
          f"{wgmma_rel['head']:.3g}")

    # 8. serve qwen3-1.7b at full width -------------------------------------
    mark("8")
    zero_staged()
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    srng = np.random.default_rng(0)
    serve_reqs = [Request(rid=i, tokens=srng.integers(
        1, cfg.vocab, size=int(srng.integers(512, 3073))), max_new=32,
        weight=float(srng.uniform(0.5, 2.0)), arrival=float(i // 2))
        for i in range(8)]
    prompt_lens = [len(r.tokens) for r in serve_reqs]

    # a checked prefill of the first prompt: every K4 launch against the
    # plain version on the same q, k, v
    orig_fa = layers.flash_attention
    n_before = checked["flash_attention"]

    def checked_fa(q, k, v, *, causal=True, scale=None):
        out = orig_fa(q, k, v, causal=causal, scale=scale)
        want = attention_ref(q, k, v, causal=causal, scale=scale)
        note_attn(out, want, q,
                  f"a full-width prefill layer (S={q.shape[2]})")
        return out

    layers.flash_attention = checked_fa
    try:
        with torch.inference_mode():
            prefill(cfg, params, torch.as_tensor(
                serve_reqs[0].tokens, device=dev)[None])
        torch.cuda.synchronize()
    finally:
        layers.flash_attention = orig_fa
    n_layer_checks = checked["flash_attention"] - n_before
    if n_layer_checks != cfg.n_layers:
        _fail(f"checked prefill made {n_layer_checks} K4 calls, expected "
              f"{cfg.n_layers}")
    print(f"checked full-width prefill (S={prompt_lens[0]}): all "
          f"{n_layer_checks} flash_attention launches within tolerance of "
          "the plain version")

    # where a request's device time goes (serve_profile): one prefill of
    # the longest prompt and 8 decode ticks of its slot under
    # torch.profiler.  Device time is summed over the kernel events only (an
    # aten op's own device time repeats its kernels'); the profiler slows
    # the host, so the busy share of decode is also taken against the
    # unprofiled run's median tick
    def device_us(events) -> float:
        return sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA)

    def serve_run(cfg_, params_, reqs, admission="fifo"):
        return _serve_run(cfg_, params_, reqs, (zero_counts, read_counts),
                          admission)

    def serve_profile(cfg_, params_, eng_, reqs, run, kernel_keys) -> dict:
        """Device time of one prefill of the longest prompt of `reqs` and of
        8 decode ticks of its slot; `kernel_keys` names the kernels to sum
        (name -> substrings of their event keys)."""
        longest = max(reqs, key=lambda r: len(r.tokens))
        ptoks = torch.as_tensor(longest.tokens, device=dev)[None]
        breakdown = {}
        with torch.inference_mode():
            for label, steps in (("prefill", 0), ("decode", 8)):
                _, pc = prefill(cfg_, params_, ptoks)
                pc = eng_._pad_cache(pc, ptoks.shape[1])
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    if steps == 0:
                        int(torch.argmax(prefill(cfg_, params_, ptoks)[0][0]))
                    tok = torch.tensor([[1]], device=dev)
                    for _ in range(steps):
                        lg, pc = decode_step(cfg_, params_, pc, tok)
                        tok = torch.argmax(lg, dim=-1, keepdim=True)
                        int(tok)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                ka = prof.key_averages()
                total = device_us(ka)
                top = sorted(ka, key=lambda e: -device_us([e]))[:6]
                breakdown[label] = {
                    "wall_ms": wall_us / 1e3, "device_ms": total / 1e3,
                    "busy_share": total / wall_us if total else None,
                    "device_ms_per_tick": total / 1e3 / max(steps, 1),
                    **{f"{name}_ms": device_us([
                        e for e in ka if any(k in e.key.lower()
                                             for k in keys)]) / 1e3
                       for name, keys in kernel_keys.items()},
                    # the CUDA launches of each named kernel, as the
                    # profiler counts them
                    "launches": {name: sum(
                        e.count for e in ka
                        if e.device_type == DeviceType.CUDA
                        and any(k in e.key.lower() for k in keys))
                        for name, keys in kernel_keys.items()},
                    "top_device_ms": {e.key[:60]: device_us([e]) / 1e3
                                      for e in top}}
        breakdown["decode"]["busy_share_unprofiled"] = \
            breakdown["decode"]["device_ms_per_tick"] \
            / run["decode_ms_per_token"]
        return {"prompt_len": int(ptoks.shape[1]), "decode_steps": 8,
                **breakdown}

    eng, run = serve_run(cfg, params, serve_reqs)
    record["serve"] = {**run, "params": n_params, "init_s": init_s}
    serve_launches = run["launches"]
    if serve_launches["flash_attention"] != cfg.n_layers * len(serve_reqs):
        _fail(f"serve: {serve_launches['flash_attention']} flash_attention "
              f"launches, expected {cfg.n_layers} per prefill")
    print(f"serve {cfg.name} (full width, {n_params} parameters, bf16): "
          f"{run['stats']}, {run['tokens']} tokens in {run['wall_s']:.2f} s "
          f"({run['tokens_per_s']:.1f} tokens/s); prefill s per request "
          f"{[round(x, 4) for x in run['prefill_s']]} for prompts "
          f"{prompt_lens}; decode ms per token (median) "
          f"{run['decode_ms_per_token']:.2f}; peak memory "
          f"{run['max_memory_allocated'] / 2**30:.2f} GiB; launches "
          f"{serve_launches}")
    # 8b. the same serve with coflow admission, before any profiler runs
    # (decode is host-bound: both serves run under the same conditions):
    # the engine's session plans on the card at every arrival tick.  Its submits, advances and
    # frontier reads are logged and replayed on a CPU session; each request
    # admitted at step s must be the first, by (planned completion under
    # the replayed frontier in force at s, arrival, rid), of the arrived
    # requests not yet admitted
    mark("8b")
    import math

    from repro_torch.core import SchedulerSession

    co_reqs = [Request(rid=r.rid, tokens=r.tokens, max_new=r.max_new,
                       weight=r.weight, arrival=r.arrival)
               for r in serve_reqs]
    by_prompt = {tuple(int(t) for t in r.tokens[:16]): r for r in co_reqs}
    admitted: list = []          # (rid, step)
    ops: list = []               # the run's session calls, in order
    step_now = [0]
    orig_prefill = serve_engine.prefill
    orig_order = ServingEngine._admission_order
    orig_new = ServingEngine._new_session

    def noting_prefill(cfg_, params_, toks):
        r = by_prompt[tuple(int(t) for t in toks[0, :16].tolist())]
        admitted.append((r.rid, step_now[0]))
        return orig_prefill(cfg_, params_, toks)

    def noting_order(self, pending, step=0):
        step_now[0] = step
        return orig_order(self, pending, step)

    def logged_session(self):
        sess = orig_new(self)
        sub, adv, fr = sess.submit, sess.advance, sess.frontier

        def submit(job):
            ops.append(("submit", job))
            return sub(job)

        def advance(until=None):
            ops.append(("advance", until))
            return adv(until)

        def frontier():
            ops.append(("frontier", step_now[0]))
            return fr()

        sess.submit, sess.advance, sess.frontier = submit, advance, frontier
        return sess

    serve_engine.prefill = noting_prefill
    ServingEngine._admission_order = noting_order
    ServingEngine._new_session = logged_session
    try:
        co_eng, co_run = serve_run(cfg, params, co_reqs, admission="coflow")
    finally:
        serve_engine.prefill = orig_prefill
        ServingEngine._admission_order = orig_order
        ServingEngine._new_session = orig_new
    if co_eng._session.device.type != "cuda" or \
            co_eng._session.plan_backend != "pipeline":
        _fail(f"coflow serve: the session plans on "
              f"{co_eng._session.device} / {co_eng._session.plan_backend}")
    if co_run["launches"]["bna_decompose"] == 0 or \
            co_run["launches"]["merge_fix"] == 0:
        _fail(f"coflow serve: the session launched no pipeline kernel "
              f"({co_run['launches']})")
    replay = SchedulerSession(co_eng.sc.ports, "om_alg", device="cpu")
    frontier_at: dict = {}
    for op, arg in ops:
        if op == "submit":
            replay.submit(arg)
        elif op == "advance":
            replay.advance(until=arg)
        else:
            frontier_at[arg] = replay.frontier()
    if not frontier_at or len(admitted) != len(co_reqs):
        _fail(f"coflow serve: {len(frontier_at)} frontier reads, "
              f"{len(admitted)} admissions of {len(co_reqs)} requests")
    left = {r.rid: r for r in co_reqs}
    for rid, step in admitted:
        read = [t for t in frontier_at if t <= step]
        f = frontier_at[max(read)] if read else None
        best = min((x for x in left.values() if x.arrival <= step),
                   key=lambda x: (f.completion(x.rid) if f else math.inf,
                                  x.arrival, x.rid))
        if best.rid != rid:
            _fail(f"coflow serve: request {rid} admitted at step {step}, "
                  f"the session's frontier puts {best.rid} first "
                  f"(admitted {admitted})")
        del left[rid]
    # fifo once more, so the two admissions are read in turns (fifo,
    # coflow, fifo) on this host: decode is host-bound
    _, fifo_again = serve_run(cfg, params, [
        Request(rid=r.rid, tokens=r.tokens, max_new=r.max_new,
                weight=r.weight, arrival=r.arrival) for r in serve_reqs])
    plan_ms = [x * 1e3 for x in co_eng.admission_plan_s]
    record["serve_coflow"] = {**co_run, "admitted": admitted,
                              "admission_plan_ms": plan_ms,
                              "fifo_weighted_finish":
                                  run["stats"]["weighted_finish"],
                              "fifo_again": fifo_again}
    print(f"serve {cfg.name} coflow admission: {co_run['stats']} "
          f"(fifo {run['stats']}), admitted (rid, step) {admitted}, "
          f"following the session's frontier (replayed on the CPU); "
          f"admission planning ms per arrival tick "
          f"{[round(x, 3) for x in plan_ms]}; decode ms per token (median) "
          f"{co_run['decode_ms_per_token']:.2f}, tokens/s "
          f"{co_run['tokens_per_s']:.2f} (fifo before: "
          f"{run['decode_ms_per_token']:.2f}, {run['tokens_per_s']:.2f}; fifo "
          f"after: {fifo_again['decode_ms_per_token']:.2f}, "
          f"{fifo_again['tokens_per_s']:.2f}); launches {co_run['launches']}")

    record["serve_profile"] = serve_profile(
        cfg, params, eng, serve_reqs, run,
        {"flash_attention": ("flash_attention", "flash_fwd"),
         K4_FWD_WGMMA: (K4_FWD_WGMMA,)})
    print("serve profile (one prefill at S="
          f"{record['serve_profile']['prompt_len']}; 8 decode ticks of one "
          "slot): " + json.dumps(record["serve_profile"]))
    # bf16 at d = 128: every prefill attention runs K4's wgmma kernel
    n_wgmma = record["serve_profile"]["prefill"]["launches"][K4_FWD_WGMMA]
    if n_wgmma != cfg.n_layers:
        _fail(f"the profiled {cfg.name} prefill launched {K4_FWD_WGMMA} "
              f"{n_wgmma} times, expected {cfg.n_layers}")
    record["serve"]["staged_copies"] = check_staged(f"serving {cfg.name}")

    # 9. the same weights on the CPU ----------------------------------------
    mark("9")
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        1, cfg.vocab, size=(1, 64)))
    with torch.inference_mode():
        lg_card = prefill(cfg, params, toks.to(dev))[0].float().cpu()
        cpu_params = tree_map(lambda x: x.cpu(), params)
        t0 = time.perf_counter()
        lg_cpu = prefill(cfg, cpu_params, toks)[0].float()
        cpu_prefill_s = time.perf_counter() - t0
    del cpu_params
    diff = float((lg_card - lg_cpu).abs().max())
    scale_l = float(lg_cpu.abs().max())
    agree = int(lg_card.argmax()) == int(lg_cpu.argmax())
    record["cpu_compare"] = {"tokens": 64, "max_abs_diff": diff,
                             "max_abs_logit": scale_l,
                             "argmax_agrees": agree,
                             "cpu_prefill_s": cpu_prefill_s}
    if not (np.isfinite(diff) and diff <= LOGIT_TOL * scale_l):
        _fail(f"full-width logits, card vs CPU: max |diff| {diff} > "
              f"{LOGIT_TOL} x {scale_l}")
    print(f"full-width 64-token prefill, card vs CPU: last-position logits "
          f"max |diff| {diff:.4g} (largest logit {scale_l:.4g}, tolerance "
          f"{LOGIT_TOL:.0%} of it); argmax agrees: {agree}; CPU prefill "
          f"{cpu_prefill_s:.1f} s")

    # 10. ssd_scan (K5) against its plain version ---------------------------
    mark("10")
    from repro_torch.models import lm_forward, ssm

    ssd_rel_max = 0.0

    def note_ssd(got, want, what: str) -> None:
        nonlocal ssd_rel_max
        name = str(got.dtype).split(".")[-1]
        if got.dtype != want.dtype or got.shape != want.shape:
            _fail(f"ssd_scan on {what}: {got.dtype} {tuple(got.shape)}, "
                  f"expected {want.dtype} {tuple(want.shape)}")
        diff = float((got.float() - want.float()).abs().max())
        rel = diff / (float(want.float().abs().max()) + 1e-9)
        max_err["ssd_scan"] = max(max_err["ssd_scan"], diff)
        ssd_rel_max = max(ssd_rel_max, rel)
        checked["ssd_scan"] += 1
        if not rel < SSD_TOL[name]:
            _fail(f"ssd_scan != plain version on {what} ({name}, max "
                  f"|diff| / max |y| = {rel} >= {SSD_TOL[name]})")

    def ssd_inputs(shape, dtype, seed):
        """As the reference's sweep draws them: a in (0.55, 1), b and c
        scaled by 0.3."""
        B, S, H, G, N, P = shape
        r = np.random.default_rng(seed)
        return (torch.as_tensor(r.normal(size=(B, S, H, P)), dtype=dtype,
                                device=dev),
                torch.as_tensor(r.uniform(0.55, 1.0, size=(B, S, H)),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(r.normal(size=(B, S, G, N)) * 0.3,
                                dtype=dtype, device=dev),
                torch.as_tensor(r.normal(size=(B, S, G, N)) * 0.3,
                                dtype=dtype, device=dev))

    ssd_shapes = [((1, 16, 2, 1, 8, 16), 8), ((2, 33, 4, 2, 16, 32), 16),
                  ((1, 64, 2, 2, 32, 64), 32), ((1, 40, 8, 1, 16, 8), 64),
                  ((1, 300, 16, 8, 128, 64), 128)] + \
        [((2, S, 80, 1, 128, 64), 128) for S in (1, 127, 128, 4096)]
    for shape, chunk in ssd_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, a, b, c = ssd_inputs(shape, dtype, sum(shape))
            note_ssd(ssd_scan(x, a, b, c, chunk=chunk), ssd_ref(x, a, b, c),
                     f"shape {shape}, chunk {chunk}")
    torch.cuda.synchronize()
    print(f"ssd_scan: within tolerance of the plain version on "
          f"{checked['ssd_scan']} cases ({len(ssd_shapes)} shapes x "
          f"f32/bf16; max |diff| {max_err['ssd_scan']:.3g}, max |diff| / "
          f"max |y| {ssd_rel_max:.3g})")

    # 11. mamba2-2.7b lm_forward at full width ------------------------------
    mark("11")
    zero_staged()
    scfg = get_config(SSM_ARCH)
    del params, eng                             # qwen3's weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sparams = init_lm(scfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    s_init_s = time.perf_counter() - t0
    n_sparams = sum(x.numel() for x in tree_leaves(sparams))
    fwd_B, fwd_S = 2, 4096
    ftoks = torch.as_tensor(np.random.default_rng(3).integers(
        1, scfg.vocab, size=(fwd_B, fwd_S)), device=dev)
    orig_ssd = ssm.ssd_scan
    n_before = checked["ssd_scan"]

    def checked_ssd(x, a, b, c, *, chunk=128):
        out = orig_ssd(x, a, b, c, chunk=chunk)
        note_ssd(out, ssd_ref(x, a, b, c),
                 f"a full-width lm_forward layer (B={x.shape[0]}, "
                 f"S={x.shape[1]})")
        return out

    ssm.ssd_scan = checked_ssd
    try:
        with torch.inference_mode():
            lg, _ = lm_forward(scfg, sparams, ftoks)
            torch.cuda.synchronize()
            if lg.shape != (fwd_B, fwd_S, scfg.padded_vocab) or \
                    not bool(torch.isfinite(lg).all()):
                _fail(f"mamba2 lm_forward: logits {tuple(lg.shape)}, "
                      "not all finite")
            del lg
    finally:
        ssm.ssd_scan = orig_ssd
    n_layer_checks = checked["ssd_scan"] - n_before
    if n_layer_checks != scfg.n_layers:
        _fail(f"checked mamba2 forward made {n_layer_checks} K5 calls, "
              f"expected {scfg.n_layers}")
    print(f"checked full-width mamba2 lm_forward (B={fwd_B}, S={fwd_S}): "
          f"all {n_layer_checks} ssd_scan launches within tolerance of the "
          "plain version")

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = lm_forward(scfg, sparams, ftoks)
        torch.cuda.synchronize()
        fwd_wall = time.perf_counter() - t0
        fwd_launches = read_counts()
        if not bool(torch.isfinite(lg).all()):
            _fail("mamba2 lm_forward: logits not all finite")
        del lg
    fwd_peak = torch.cuda.max_memory_allocated()
    if fwd_launches["ssd_scan"] != scfg.n_layers:
        _fail(f"mamba2 lm_forward: {fwd_launches['ssd_scan']} ssd_scan "
              f"launches, expected {scfg.n_layers}")
    gemm_keys = ("gemm", "nvjet", "cutlass", "xmma")

    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # spin kernels and a sync before the counted pass: this late in
            # the process the profiler dropped the first device events of
            # its window (the first K5 call's three kernels, 3 ms in; with
            # a 10 ms spin kernel first, the spin and the 44 kernels after
            # it; with 256 short spins and a 0.2 s one, all 257 of them),
            # while scripts/profiler_window_probe.py's passes record every
            # one; 1024 short spins and a 1 s one cover a loss by count or
            # by time
            for _ in range(1024):
                torch.cuda._sleep(1000)
            torch.cuda._sleep(2_000_000_000)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            lm_forward(scfg, sparams, ftoks)
            torch.cuda.synchronize()
            prof_wall_us = (time.perf_counter() - t0) * 1e6
        prof_calls = ssd_scan.launches
    ka = prof.key_averages()
    # K5's CUDA launches in the profiled pass, by kernel: bf16 runs one,
    # the chunk walk, once a call
    k5_names = K5_NAMES["bfloat16"]
    k5_cuda = {n: sum(e.count for e in ka if n in e.key
                      and e.device_type == DeviceType.CUDA)
               for n in k5_names}
    spin = sum(e.count for e in ka if "spin" in e.key.lower()
               and e.device_type == DeviceType.CUDA)
    k5_per_call = sum(k5_cuda.values()) / prof_calls if prof_calls else 0
    if any(c != prof_calls for c in k5_cuda.values()) \
            or k5_per_call != SSD_CUDA_LAUNCHES[torch.bfloat16]:
        _fail(f"mamba2 lm_forward (profiled): {prof_calls} ssd_scan calls "
              f"launched {k5_cuda}, expected each kernel once a call "
              f"({SSD_CUDA_LAUNCHES[torch.bfloat16]} a call; the spin kernel "
              f"before them recorded {spin} times)")
    total = device_us(ka)
    k5 = device_us([e for e in ka if any(n in e.key for n in k5_names)])
    gemm = device_us([e for e in ka if any(g in e.key.lower()
                                           for g in gemm_keys)])
    top = sorted(ka, key=lambda e: -device_us([e]))[:6]
    record["mamba2_forward"] = {
        "arch": scfg.name, "params": n_sparams, "init_s": s_init_s,
        "batch": fwd_B, "seq": fwd_S, "wall_s": fwd_wall,
        "max_memory_allocated": fwd_peak, "launches": fwd_launches,
        "checked_k5_calls": n_layer_checks,
        "k5_cuda_launches": {"calls": prof_calls, "by_kernel": k5_cuda,
                             "per_call": k5_per_call,
                             "spin_kernel_recorded": spin},
        "profile": {"wall_ms": prof_wall_us / 1e3, "device_ms": total / 1e3,
                    "busy_share": total / prof_wall_us if total else None,
                    "ssd_scan_ms": k5 / 1e3, "gemm_ms": gemm / 1e3,
                    "rest_ms": (total - k5 - gemm) / 1e3,
                    "top_device_ms": {e.key[:60]: device_us([e]) / 1e3
                                      for e in top}}}
    print(f"mamba2 lm_forward ({scfg.name}, full width, {n_sparams} "
          f"parameters, bf16, B={fwd_B}, S={fwd_S}): {fwd_wall:.3f} s, "
          f"peak memory {fwd_peak / 2**30:.2f} GiB, launches {fwd_launches}; "
          f"profile {json.dumps(record['mamba2_forward']['profile'])}")
    record["mamba2_forward"]["staged_copies"] = check_staged(
        f"{scfg.name} lm_forward")

    # 12. teacher forcing at full width -------------------------------------
    # the three forms of the scan (K5 in lm_forward, the chunked prefill,
    # the decode recurrence) compute one function: float32 copies of the
    # weights hold them to 0.1%; in bf16, 64 layers of rounding move the
    # logits by 6.2-6.4% whichever form runs, K5 or its plain version
    mark("12")
    sparams32 = tree_map(lambda x: x.float(), sparams)
    P_tf, D_tf = 64, 16
    ttoks = torch.as_tensor(np.random.default_rng(12).integers(
        1, scfg.vocab, size=(1, P_tf + D_tf)), device=dev)   # 80 tokens
    V = scfg.vocab

    def teacher_forcing(p) -> dict:
        with torch.inference_mode():
            full = lm_forward(scfg, p, ttoks)[0][0, :, :V].float()
            lg, tcache = prefill(scfg, p, ttoks[:, :P_tf])
            steps = [lg[0].float()]
            for t in range(P_tf, P_tf + D_tf):
                lg, tcache = decode_step(scfg, p, tcache, ttoks[:, t:t + 1])
                steps.append(lg[0].float())
        steps = torch.stack(steps)               # positions 63 .. 79
        want = full[P_tf - 1:P_tf + D_tf]
        return {"max_abs_diff": float((steps - want).abs().max()),
                "max_abs_logit": float(want.abs().max()),
                "argmax_agree": int((steps.argmax(-1)
                                     == want.argmax(-1)).sum()),
                "positions": len(steps)}

    tf32, tf16 = teacher_forcing(sparams32), teacher_forcing(sparams)
    record["mamba2_teacher_forcing"] = {
        "prefill": P_tf, "decode": D_tf, "float32": tf32, "bfloat16": tf16}
    for label, row, tol in (("float32", tf32, LOGIT_TOL_F32),
                            ("bf16", tf16, TF_TOL_BF16)):
        if not (np.isfinite(row["max_abs_diff"]) and row["max_abs_diff"]
                <= tol * row["max_abs_logit"]):
            _fail(f"mamba2 teacher forcing ({label}): max |diff| "
                  f"{row['max_abs_diff']} > {tol} x {row['max_abs_logit']}")
    print(f"mamba2 teacher forcing at full width (prefill {P_tf}, decode "
          f"{D_tf}) against lm_forward's logits: float32 max |diff| "
          f"{tf32['max_abs_diff']:.4g} (largest logit "
          f"{tf32['max_abs_logit']:.4g}, tolerance {LOGIT_TOL_F32:.1%} of "
          f"it), argmax agrees at {tf32['argmax_agree']} of "
          f"{tf32['positions']}; bf16 max |diff| {tf16['max_abs_diff']:.4g} "
          f"(largest logit {tf16['max_abs_logit']:.4g}, tolerance "
          f"{TF_TOL_BF16:.0%} of it), argmax agrees at "
          f"{tf16['argmax_agree']} of {tf16['positions']}")

    # 13. the same weights on the CPU ---------------------------------------
    mark("13")
    ctoks = torch.as_tensor(np.random.default_rng(13).integers(
        1, scfg.vocab, size=(1, 64)))
    cpu_cmp = {}
    for label, p_card in (("float32", sparams32), ("bfloat16", sparams)):
        with torch.inference_mode():
            lg_card = lm_forward(scfg, p_card, ctoks.to(dev))[0][0, -1, :V] \
                .float().cpu()
            cpu_params = tree_map(lambda x: x.cpu(), p_card)
            t0 = time.perf_counter()
            lg_cpu = lm_forward(scfg, cpu_params, ctoks)[0][0, -1, :V] \
                .float()
            s_cpu_s = time.perf_counter() - t0
        del cpu_params
        cpu_cmp[label] = {
            "max_abs_diff": float((lg_card - lg_cpu).abs().max()),
            "max_abs_logit": float(lg_cpu.abs().max()),
            "argmax_agrees": int(lg_card.argmax()) == int(lg_cpu.argmax()),
            "cpu_forward_s": s_cpu_s}
    del sparams32
    torch.cuda.empty_cache()
    c32, c16 = cpu_cmp["float32"], cpu_cmp["bfloat16"]
    record["mamba2_cpu_compare"] = {"tokens": 64, **cpu_cmp}
    for label, row, tol in (("float32", c32, LOGIT_TOL_F32),
                            ("bf16", c16, LOGIT_TOL)):
        if not (np.isfinite(row["max_abs_diff"]) and row["max_abs_diff"]
                <= tol * row["max_abs_logit"]):
            _fail(f"mamba2 full-width logits ({label}), card vs CPU: max "
                  f"|diff| {row['max_abs_diff']} > {tol} x "
                  f"{row['max_abs_logit']}")
    print(f"mamba2 full-width 64-token lm_forward, card vs CPU: float32 "
          f"last-position logits max |diff| {c32['max_abs_diff']:.4g} "
          f"(largest logit {c32['max_abs_logit']:.4g}, tolerance "
          f"{LOGIT_TOL_F32:.1%} of it), argmax agrees: "
          f"{c32['argmax_agrees']}; bf16 max |diff| "
          f"{c16['max_abs_diff']:.4g} (largest logit "
          f"{c16['max_abs_logit']:.4g}, tolerance {LOGIT_TOL:.0%} of it), "
          f"argmax agrees: {c16['argmax_agrees']}; CPU forward "
          f"{c32['cpu_forward_s']:.1f} s (f32), {c16['cpu_forward_s']:.1f} s "
          "(bf16)")

    # 14. serve mamba2-2.7b at full width -----------------------------------
    mark("14")
    H_ssd = scfg.ssm.expand * scfg.d_model // scfg.ssm.d_head
    mrng = np.random.default_rng(0)
    m_reqs = [Request(rid=i, tokens=mrng.integers(
        1, scfg.vocab, size=int(mrng.integers(512, 3073))), max_new=32,
        weight=float(mrng.uniform(0.5, 2.0)), arrival=float(i // 2))
        for i in range(8)]
    m_reqs.append(Request(rid=8, tokens=mrng.integers(1, scfg.vocab,
                                                      size=H_ssd),
                          max_new=32, arrival=4.0))
    meng, mrun = serve_run(scfg, sparams, m_reqs)
    record["mamba2_serve"] = mrun
    print(f"serve {scfg.name} (full width, bf16): {mrun['stats']}, "
          f"{mrun['tokens']} tokens in {mrun['wall_s']:.2f} s "
          f"({mrun['tokens_per_s']:.1f} tokens/s); prefill s per request "
          f"{[round(x, 4) for x in mrun['prefill_s']]} for prompts "
          f"{mrun['prompt_lens']} (the {H_ssd}-token one served); decode ms "
          f"per token (median) {mrun['decode_ms_per_token']:.2f}; peak "
          f"memory {mrun['max_memory_allocated'] / 2**30:.2f} GiB; launches "
          f"{mrun['launches']}")
    record["mamba2_serve_profile"] = serve_profile(
        scfg, sparams, meng, m_reqs, mrun, {"gemm": gemm_keys})
    print("mamba2 serve profile (one prefill at S="
          f"{record['mamba2_serve_profile']['prompt_len']}; 8 decode ticks "
          "of one slot): " + json.dumps(record["mamba2_serve_profile"]))

    # 14b. the MoE, encoder-decoder and VLM families at full width ---------
    # free the earlier models: mamba2's weights (sparams, and p_card and
    # meng that hold them) and qwen3's (held by the coflow serve's engine)
    mark("14b")
    del sparams, meng, p_card, co_eng
    record["families"] = _families(dev, note_attn, (zero_counts, read_counts))

    # 15. timings -----------------------------------------------------------
    mark("15")
    kernels_line = []
    _, state = largest["bna_step"]
    B, w = state[0].shape[0], state[0].shape[1]
    match = state[4]
    midx = match.clamp(min=0).long()
    dm = state[0].gather(2, midx[:, :, None])[:, :, 0]
    n_matched = int((match >= 0).sum())
    n_real = int(((match >= 0) & (dm > 0)).sum())
    # each input read once (row, col, match, D and the matched d entries),
    # each output written once (d, row, col at real edges, D, packed rows)
    k1_bytes = 4 * (3 * B * w + n_matched + B) \
        + 4 * (3 * n_real + B + B * (2 + 2 * w))
    work = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    # what a launch costs: an empty kernel through K1's library, timed alike
    empty = kernels.load_kernel("bna_step").bna_step_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_void_p], ctypes.c_int
    launch_floor_ms = _cuda_ms(
        lambda: empty(torch.cuda.current_stream().cuda_stream))
    kernels_line.append({
        "name": "bna_step", "route": "cuda",
        "source": "src/repro_torch/kernels/bna_step/csrc/bna_step.cu",
        "replaces": "src/repro/kernels/bna_step/bna_step.py:79",
        "launches": runs["gdm"]["launches"]["bna_step"],
        "online_launches_per_replan": online_per_replan("bna_step"),
        "max_abs_err": max_err["bna_step"],
        "ms": _cuda_ms(lambda: bna_step(*work)),
        "plain_ms": _cuda_ms(lambda: bna_step_ref(*plain)),
        "bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "equal": max_err["bna_step"] == 0,
        "checked_calls": checked["bna_step"], "shape": [B, w, w],
        "launch_floor_ms": launch_floor_ms})
    delta = largest["coflow_merge"]
    K, P = delta.shape
    kernels_line.append({
        "name": "coflow_merge", "route": "cuda",
        "source": "src/repro_torch/kernels/coflow_merge/csrc/coflow_merge.cu",
        "replaces": "src/repro/kernels/coflow_merge/coflow_merge.py:43",
        "launches": runs["gdm"]["launches"]["coflow_merge"],
        "online_launches_per_replan": online_per_replan("coflow_merge"),
        "max_abs_err": max_err["coflow_merge"],
        "ms": _cuda_ms(lambda: coflow_merge(delta)),
        "plain_ms": _cuda_ms(lambda: alphas_ref(delta)),
        "bound_ms": 4 * (K * P + K) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "equal": max_err["coflow_merge"] == 0,
        "checked_calls": checked["coflow_merge"], "shape": [K, P],
        "cuda_launches_per_call":
            record["merge_cuda_launches"]["coflow_merge"]["per_call"],
        "design": "one pass: a block a 32-row tile from a ticket copies "
                  "its rows (cp.async), publishes their totals and scans "
                  "them on from the carry, a radix-8 hierarchy of tile "
                  "totals (publish, then wait on at most 7 blocks a "
                  "level); a kernel clears the carry's counts first",
        "alloc_bytes": alloc_bytes(lambda: coflow_merge(delta))})
    Kb, Pb = big.shape
    record["coflow_merge_1e5"] = {
        "shape": [Kb, Pb], "ms": _cuda_ms(lambda: coflow_merge(big)),
        "plain_ms": _cuda_ms(lambda: alphas_ref(big)),
        "bound_ms": 4 * (Kb * Pb + Kb) / HBM_BYTES_PER_S * 1e3}
    print(f"coflow_merge at K={Kb}, 2m={Pb}: "
          f"{json.dumps(record['coflow_merge_1e5'])}")

    _, (d, ks, T_cap, t_store), dec_plain_ms, nsteps, dec_counts = \
        largest["bna_decompose"]
    Bd, wd = d.shape[0], d.shape[1]
    steps = int(nsteps.sum())
    # the stack read once; each lane's steps written once (t and its row
    # of w matched receivers), D_final and the step counts
    k_dec_bytes = 4 * (Bd * wd * wd + Bd) + 4 * (steps * (wd + 1) + 2 * Bd)
    # the SM clock while the kernel runs, sampled by nvidia-smi
    smi_clock = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        dec_ms = _wall_ms(lambda: bna_decompose(d, ks, T_cap,
                                                t_store=t_store), rounds=5)
    finally:
        smi_clock.terminate()
        clock_out, _ = smi_clock.communicate(timeout=60)
    sm_mhz = max((float(x) for x in clock_out.split() if x.strip()),
                 default=float("nan"))
    # the longest lane's chain: a search iteration visits a receiver or
    # pops a sender, two dependent shared-memory round trips either way
    # (the support word and row-slack mask, then mrs[r] or the stack); a
    # step about four (the owners' values, dmv through the inverse
    # matching, the invalid test's col[msr[s]], the repair tail's reads);
    # a search about three more (the slice's ballot, the flip's walk)
    ll = int(nsteps.argmax())
    ll_iter = dec_counts["visits"][ll] + dec_counts["pops"][ll]
    ll_steps, ll_searches = int(nsteps[ll]), dec_counts["searches"][ll]
    round_trips = 2 * ll_iter + 4 * ll_steps + 3 * ll_searches
    cycles_per_rt = 30
    lay = bna_decompose_layout(Bd, wd)
    kernels_line.append({
        "name": "bna_decompose", "route": "cuda",
        "source": "src/repro_torch/kernels/bna_decompose/csrc/"
                  "bna_decompose.cu",
        "replaces": "src/repro/core/pipeline.py:114",
        "launches": pipe_runs["gdm"]["launches"]["bna_decompose"],
        "online_launches_per_replan": online_per_replan("bna_decompose"),
        "zoo_launches_per_plan": zoo_launches("bna_decompose"),
        "max_abs_err": max_err["bna_decompose"],
        "ms": dec_ms, "plain_ms": dec_plain_ms,
        "bound_ms": k_dec_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "equal": max_err["bna_decompose"] == 0,
        "checked_calls": checked["bna_decompose"], "shape": [Bd, wd, wd],
        "lane_steps": {"sum": steps, "max": int(nsteps.max())},
        "longest_lane": {"lane": ll, "k": int(ks[ll]), "steps": ll_steps,
                         "searches": ll_searches,
                         "visits": dec_counts["visits"][ll],
                         "pops": dec_counts["pops"][ll],
                         "iterations": ll_iter},
        # the whole kernel time over each count, not a split of it
        "whole_ns_per_iteration": dec_ms * 1e6 / ll_iter,
        "whole_ns_per_step": dec_ms * 1e6 / ll_steps,
        "design_floor_ms": round_trips * cycles_per_rt / (sm_mhz * 1e3),
        "design_floor_round_trips": round_trips,
        "cycles_per_round_trip": cycles_per_rt, "sm_clock_mhz": sm_mhz,
        "design": "one warp per lane, 4 lanes a block, no block barrier; "
                  "per-lane bit sets in registers, first receiver by "
                  "__clz and redux.sync min, a lane's state in shared "
                  "memory",
        # merge_and_fix's fix-up (phase 6c): launches per *_bf plan on the
        # pipeline and the largest fix-up bucket, (B, w, w)
        "fixup_launches": {
            f"{r['job'][0]}@{r['job'][2]}": r["fixup"]["launches"]
            for r in [*bf_runs.values(), *bf_large.values()]
            if r["job"][3:] == ["cuda", "pipeline"]
            and r["job"][1] == "packet"},
        "fixup_largest_bucket": max(
            (r["fixup"]["largest_bucket"] for r in bf_large.values()
             if r["fixup"]["largest_bucket"]), default=None,
            key=lambda x: x[0] * x[1] * x[2]),
        **lay})
    print(f"bna_decompose at B={Bd}, w={wd}: "
          f"{json.dumps(kernels_line[-1])}")
    # the main path's largest merge: the scale-1.0 gdm plan's
    (mf_args, mf_m) = mf_full
    Km, Em = mf_args[0].numel() - 1, mf_args[1].numel()
    # events and the four edge arrays read once, alphas and deltas written
    k3_bytes = 8 * (Km + 1 + 4 * Em) + 8 * 2 * Km
    (q_args, q_m) = largest["merge_fix"]
    Kq, Eq = q_args[0].numel() - 1, q_args[1].numel()
    record["merge_fix_scale_0.25"] = {
        "shape": [Kq, 2 * q_m, Eq],
        "ms": _cuda_ms(lambda: merge_fix(*q_args, q_m)),
        "plain_ms": _cuda_ms(lambda: merge_fix_ref(*q_args, q_m)),
        "bound_ms": 8 * (Kq + 1 + 4 * Eq + 2 * Kq) / HBM_BYTES_PER_S * 1e3}
    print(f"merge_fix at scale 0.25's largest merge, K={Kq}, E={Eq}: "
          f"{json.dumps(record['merge_fix_scale_0.25'])}")
    kernels_line.append({
        "name": "merge_fix", "route": "cuda",
        "source": "src/repro_torch/kernels/merge_fix/csrc/merge_fix.cu",
        "replaces": "src/repro/kernels/merge_fix/ops.py:28",
        "launches": pipe_runs["gdm"]["launches"]["merge_fix"],
        "online_launches_per_replan": online_per_replan("merge_fix"),
        "zoo_launches_per_plan": zoo_launches("merge_fix"),
        "max_abs_err": max_err["merge_fix"],
        "ms": _cuda_ms(lambda: merge_fix(*mf_args, mf_m)),
        "plain_ms": _cuda_ms(lambda: merge_fix_ref(*mf_args, mf_m)),
        "bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None, "equal": max_err["merge_fix"] == 0,
        "checked_calls": checked["merge_fix"], "shape": [Km, 2 * mf_m, Em],
        "cuda_launches_per_call":
            record["merge_cuda_launches"]["merge_fix"]["per_call"],
        "design": "no (K + 1) x 2m array: a bucket table of the events' "
                  "times, a counting sort of the endpoints per chunk of "
                  "edges, a scan of 32-row tiles from a ticket on the "
                  "radix-8 carry",
        "alloc_bytes": alloc_bytes(lambda: merge_fix(*mf_args, mf_m))})
    Ks = events.size - 1
    record["merge_fix_1e5"] = {
        "shape": [Ks, 2 * m_syn, E],
        "ms": _cuda_ms(lambda: merge_fix(*syn_args, m_syn)),
        "plain_ms": _cuda_ms(lambda: merge_fix_ref(*syn_args, m_syn)),
        "bound_ms": 8 * (Ks + 1 + 4 * E + 2 * Ks) / HBM_BYTES_PER_S * 1e3}
    print(f"merge_fix at K={Ks}, 2m={2 * m_syn}, E={E}: "
          f"{json.dumps(record['merge_fix_1e5'])}")
    import torch.nn.functional as F

    def attn_timing(S, reps, plain):
        Hq, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        g = torch.Generator(device=dev).manual_seed(S)
        q, k, v = (torch.randn((1, h, S, d), generator=g, device=dev)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        scale = d ** -0.5
        row = {"shape": [1, Hq, Hkv, S, S, d], "dtype": "bfloat16",
               "causal": True,
               "ms": _cuda_ms(lambda: flash_attention(q, k, v, scale=scale),
                              reps=reps, rounds=3),
               "plain_ms": _cuda_ms(lambda: plain(q, k, v, scale),
                                    reps=reps, rounds=3),
               "library_ms": _cuda_ms(
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, scale=scale,
                       enable_gqa=True), reps=reps, rounds=3),
               **attn_fwd_bounds(1, Hq, Hkv, S, S, d, True)}
        row["tflops"] = row.pop("flops") / row["ms"] / 1e9
        del row["bytes"]
        return row

    S_main = max(prompt_lens)
    attn_main = attn_timing(
        S_main, 10, lambda q, k, v, sc: attention_ref(q, k, v, scale=sc))
    # attention_ref would hold (16 x 32768^2) float32 scores; the plain
    # version at 32k is the chunked one the CPU path takes for long
    # sequences (layers._attn_chunked, the same function)
    attn_32k = attn_timing(
        32768, 2, lambda q, k, v, sc: layers._attn_chunked(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), True,
            sc, cfg.attn_chunk))
    record["flash_attention_32k"] = attn_32k

    def family_attn_timing(shape, causal) -> dict:
        """K4 at a family's shape, bf16, beside its plain version and SDPA
        (causal only where Sq = Sk: SDPA aligns the mask to the top)."""
        B, Hq, Hkv, Sq, Sk, d = shape
        g = torch.Generator(device=dev).manual_seed(Sq + Sk)
        q, k, v = (torch.randn(sz, generator=g, device=dev)
                   .to(torch.bfloat16) for sz in
                   ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d)))
        scale = d ** -0.5
        bound = attn_fwd_bounds(B, Hq, Hkv, Sq, Sk, d, causal)
        row = {"shape": list(shape), "dtype": "bfloat16", "causal": causal,
               "ms": _cuda_ms(lambda: flash_attention(
                   q, k, v, causal=causal, scale=scale), reps=10, rounds=3),
               "plain_ms": _cuda_ms(lambda: attention_ref(
                   q, k, v, causal=causal, scale=scale), reps=2, rounds=3),
               "library_ms": _cuda_ms(
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal, scale=scale,
                       enable_gqa=True), reps=10, rounds=3),
               "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        row["tflops"] = bound["flops"] / row["ms"] / 1e9
        return row

    attn_families = [family_attn_timing(sh, causal)
                     for sh, causal in FAMILY_ATTN.items()]
    record["flash_attention_families"] = attn_families
    families = record["families"]
    kernels_line.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:79",
        "launches": families["granite"]["serve"]["launches"][
            "flash_attention"],
        "launches_by_path": {
            f"serve {cfg.name}": serve_launches["flash_attention"],
            f"serve {MOE_ARCH}": families["granite"]["serve"]["launches"][
                "flash_attention"]},
        "launches_per_prefill": {cfg.name: cfg.n_layers,
                                 **families["k4_launches_per_prefill"]},
        "family_shapes": attn_families,
        "max_abs_err": max_err["flash_attention"],
        "wgmma_rel_err": wgmma_rel, "wgmma_rel_tol": WGMMA_REL_TOL,
        "ms": attn_main["ms"], "plain_ms": attn_main["plain_ms"],
        "bound_ms": attn_main["bound_ms"], "bound_by": "operations",
        "library_ms": attn_main["library_ms"],
        "checked_calls": checked["flash_attention"],
        "shape": attn_main["shape"], "dtype": "bfloat16",
        "tflops": attn_main["tflops"],
        "vs_library": attn_main["ms"] / attn_main["library_ms"],
        "design": "bf16 at d = 64 and 128: wgmma on TMA tiles, a block "
                  "(two consumer warpgroups) a 128-row query tile, Q "
                  "resident, K/V in a ring under mbarriers (128 keys x 3 "
                  "stages at d = 128; 64 x 4 and two blocks an SM at d = "
                  "64); S = Q K^T from shared memory, the online softmax on "
                  "the accumulators, O += P V with P from registers; the "
                  "next stage's Q K^T issued under this stage's softmax; "
                  "heaviest query tiles first; other bf16 head dims "
                  "mma.sync, float32 FMAs",
        "kernel_by_dtype_d": {f"{dt} d={dd}": forward_kernel(
            getattr(torch, dt), dd) for dt in ("bfloat16", "float32")
            for dd in (24, 32, 48, 64, 128, 256)},
        "staged_copies": flash_attention.staged,
        **_attributes(kernels.load_kernel("flash_attention")
                      .flash_attention_attributes, FORWARD_KERNELS.index(
                          forward_kernel(torch.bfloat16, cfg.d_head)),
                      cfg.d_head)})
    print(f"flash_attention at S={S_main}: {json.dumps(attn_main)}")
    print(f"flash_attention at S=32768: {json.dumps(attn_32k)}")
    for row in attn_families:
        print(f"flash_attention at {row['shape']} (causal={row['causal']}): "
              f"{json.dumps(row)}")

    # K5 at lm_forward's shapes: B=2, S=4096, H=80, G=1, N=128, P=64, bf16
    s_ssm = scfg.ssm
    H5, G5, N5, P5 = H_ssd, s_ssm.n_groups, s_ssm.d_state, s_ssm.d_head
    L5 = min(s_ssm.chunk, fwd_S)
    x5, a5, b5, c5 = ssd_inputs((fwd_B, fwd_S, H5, G5, N5, P5),
                                torch.bfloat16, 5)
    k5_ms = _cuda_ms(lambda: ssd_scan(x5, a5, b5, c5, chunk=L5), reps=10,
                     rounds=3)
    k5_plain_ms = _cuda_ms(lambda: ssd_ref(x5, a5, b5, c5), reps=1,
                           rounds=2)
    k5_b = ssd_fwd_bounds(fwd_B, fwd_S, H5, G5, N5, P5, L5)
    k5_flops = k5_b["flops"]
    k5_bound = {"bytes": k5_b["bytes"] / HBM_BYTES_PER_S * 1e3,
                "operations": k5_flops / BF16_FLOPS * 1e3}
    k5_by = k5_b["bound_by"]
    ssd_attrs = kernels.load_kernel("ssd_scan").ssd_scan_attributes
    k5_kernels = {"chunk_walk": _attributes(ssd_attrs, 1, 1, L5, N5, P5)}
    # serving keeps nothing: one call holds its output, the padded loga
    # and no state scratch ((B, nC, H, N, P) float32, 84 MB here)
    k5_alloc = alloc_bytes(lambda: ssd_scan(x5, a5, b5, c5, chunk=L5))
    k5_states_bytes = 4 * fwd_B * (fwd_S // L5) * H5 * N5 * P5
    if k5_alloc >= k5_states_bytes:
        _fail(f"a serving ssd_scan call held {k5_alloc} B, at least the "
              f"{k5_states_bytes} B of the chunk states it does not keep")
    kernels_line.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:84",
        "launches": fwd_launches["ssd_scan"],
        "max_abs_err": max_err["ssd_scan"], "ms": k5_ms,
        "plain_ms": k5_plain_ms, "bound_ms": k5_bound[k5_by],
        "bound_by": k5_by, "library_ms": None,
        "checked_calls": checked["ssd_scan"],
        "max_rel_err": ssd_rel_max,
        "shape": [fwd_B, fwd_S, H5, G5, N5, P5, L5], "dtype": "bfloat16",
        "bound_bytes_ms": k5_bound["bytes"],
        "bound_ops_ms": k5_bound["operations"],
        "bound_f32_cuda_core_ms": k5_flops / F32_FLOPS * 1e3,
        "tflops": k5_flops / k5_ms / 1e9,
        "design": "bf16: one launch, a block (two warpgroups) a (batch, "
                  "head, 64 columns of P) walking the chunks with the "
                  "state in float32 accumulators; C, B and x tiles by TMA "
                  "in a 2-stage mbarrier ring; C h, C B^T, the decayed "
                  "scores times X and the state update on wgmma, the "
                  "operands the block computes (h, the scores, w o X) as "
                  "high and low bf16 parts; the states written only when "
                  "kept; float32: three FMA kernels through a scratch",
        "cuda_launches_per_call": k5_per_call,
        "alloc_bytes": k5_alloc, "states_bytes_not_kept": k5_states_bytes,
        "staged_copies": ssd_scan.staged,
        "kernels": k5_kernels})
    print(f"ssd_scan at B={fwd_B}, S={fwd_S}: {json.dumps(kernels_line[-1])}")
    del x5, a5, b5, c5

    # 16. training: qwen3-1.7b at full width, K4's backward ------------------
    mark("16")
    record["training"] = tr = _training(dev, (zero_counts, read_counts))
    tm = tr["timing"]
    k4_row = next(k for k in kernels_line if k["name"] == "flash_attention")
    # this slice's path is training: K4's launches are the training run's
    k4_row["launches"] = tr["train"]["launches"]["flash_attention"]
    k4_row["launches_by_path"][f"train {TRAIN_ARCH}"] = k4_row["launches"]
    k4_row["launches_per_train_step"] = \
        tr["train"]["launches_per_step"]["flash_attention"]
    for name in BWD_KERNELS:
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            # the reference's gradient: jax.grad of its plain attention
            "replaces": "src/repro/models/layers.py:92",
            "launches": tr["train"]["launches"][name],
            "launches_per_step": tr["train"]["launches_per_step"][name],
            "max_abs_err": tr["max_abs_err"][name],
            "max_rel_err": tr["max_rel_err"][name],
            "ms": tm[name],
            # prep's plain version is its row sum; dkdv's and dq's is the
            # whole plain backward (attention_bwd_ref), which gives both
            "plain_ms": tm["prep_plain_ms"] if name == "attn_bwd_prep"
            else tm["plain_ms"],
            "bound_ms": tm["bounds"][name]["bound_ms"],
            "bound_by": tm["bounds"][name]["bound_by"],
            # SDPA's whole backward (its forward and backward, minus its
            # forward) on the same inputs
            "library_ms": tm["library_ms"],
            "checked_calls": tr["checked"][name], "shape": tm["shape"],
            "dtype": "bfloat16",
            "share_of_bound": tm["share_of_bound"][name],
            "d64": {"shape": tm["d64"]["shape"], "ms": tm["d64"][name],
                    "bound_ms": tm["d64"]["bounds"][name]["bound_ms"],
                    **tm["d64"]["attributes"][name]},
            "design": {"attn_bwd_prep": "one warp a query row, D = "
                                        "rowsum(dO o O) in float32",
                       "attn_bwd_dkdv": "one block (two warpgroups) a "
                                        "128-key block of a kv head, K and V "
                                        "resident; its group's query heads' "
                                        "64-row Q/dO/lse/D tiles by TMA in a "
                                        "3-stage mbarrier ring; S^T, dP^T "
                                        "(wgmma from shared memory), dV, dK "
                                        "(wgmma, A from registers); no "
                                        "atomics",
                       "attn_bwd_dq": "one block (two warpgroups) a 128-row "
                                      "query tile, Q and dO resident; 64-key "
                                      "K/V tiles by TMA in a 3-stage mbarrier "
                                      "ring; S, dP (wgmma from shared "
                                      "memory), dQ (wgmma, A from "
                                      "registers)"
                       }[name],
            **tm["attributes"][name]})

    # 16(d)-(e). mamba2-2.7b trained at full width, K5's backward ----------
    mark("16(d)-(e)")
    record["ssm_training"] = st = _ssm_training(dev, (zero_counts,
                                                      read_counts))
    k5_row = next(k for k in kernels_line if k["name"] == "ssd_scan")
    # this slice's path is mamba2's training: K5's launches are that run's
    k5_row["launches_by_path"] = {"lm_forward": k5_row["launches"],
                                  f"train {SSM_ARCH}": st["train"][
                                      "launches"]["ssd_scan"]}
    k5_row["launches"] = st["train"]["launches"]["ssd_scan"]
    k5_row["launches_per_train_step"] = \
        st["train"]["launches_per_step"]["ssd_scan"]
    stm = st["timing"]
    # the training forward, keeping its states, at the training shape
    k5_row["kept"] = {"shape": stm["shape"], "ms": stm["forward_kept_ms"],
                      **{k: stm["forward_kept_bound"][k]
                         for k in ("bound_ms", "bound_by")},
                      "cuda_launches": stm["forward_cuda_launches"]}
    for name in SSD_BWD:
        kernels_line.append({
            "name": name, "route": "cuda",
            # the bf16 kernels timed here; ssd_scan_bwd.cu holds the entry
            # points and the float32 route
            "source": "src/repro_torch/kernels/ssd_scan/csrc/"
                      "ssd_scan_bwd_mma.cu",
            "library": "ssd_scan",
            # the reference's gradient: jax.grad of its plain chunked scan
            "replaces": "jax.grad of _ssd_chunked_jnp, "
                        "src/repro/models/ssm.py:110",
            "launches": st["train"]["launches"][name],
            "launches_per_step": st["train"]["launches_per_step"][name],
            "max_abs_err": st["max_abs_err"][name],
            "max_rel_err": st["max_rel_err"][name],
            "ms": stm[name], "plain_ms": stm["plain"][name],
            "bound_ms": stm["bounds"][name]["bound_ms"],
            "bound_by": stm["bounds"][name]["bound_by"],
            # no PyTorch call computes the SSD scan's gradient
            "library_ms": None,
            "checked_calls": st["checked"][name], "shape": stm["shape"],
            "dtype": "bfloat16", "share_of_bound": stm["share_of_bound"][name],
            "tflops": stm["tflops"][name],
            "cuda_launches_per_call": stm["cuda_launches_per_call"][name],
            "cuda_launches": stm["cuda_launches"][name],
            "same_bits": stm["same_bits"],
            "design": {"ssd_bwd_state": "one launch, one block a (head, "
                                        "batch) walking the chunks from the "
                                        "last with G in the accumulators: "
                                        "G += (e^cum c)^T dy on the tensor "
                                        "cores (TF32 mma.sync, ldmatrix.trans "
                                        "fragments), c and dy by cp.async "
                                        "two chunks ahead; U_c never leaves "
                                        "the registers",
                       "ssd_bwd_chunk": "three role kernels (dx, db, dc), a "
                                        "block a (slice of 8 heads of a "
                                        "group, chunk, batch) walking its "
                                        "heads with two heads' x, dy, G or h "
                                        "in flight by cp.async; C B^T and "
                                        "dY X^T as bf16 mma.sync on the "
                                        "tiles at or under the diagonal, "
                                        "the decayed triangles and the "
                                        "inter-chunk products as TF32 "
                                        "mma.sync from the accumulators; "
                                        "db, dc summed over the slice in "
                                        "registers, dla's sums from the "
                                        "fragments by shuffles and warp "
                                        "scans; then the slices summed in "
                                        "order and da finished; no "
                                        "atomics"}[name],
            "kernels": stm["attributes"][name]})
    whole_keys = ("bwd_ms", "bound_ms", "bound_by", "library_ms",
                  "library_fwd_ms", "library_fwd_bwd_ms", "tflops",
                  "vs_library", "fwd_lse_ms", "fwd_lse_bound_ms",
                  "fwd_lse_bound_by", "shape")
    record["attn_bwd_whole"] = {
        **{k: tm[k] for k in whole_keys}, "plain_ms": tm["plain_ms"],
        "same_bits": tm["same_bits"],
        "d64": {k: tm["d64"][k] for k in whole_keys}}
    # 17. the mesh: the dry run, its collectives planned, a (1, 1) step ----
    mark("17")
    record["mesh"] = ms = _mesh(dev, (zero_counts, read_counts))
    for name, row in ((n, k) for k in kernels_line for n in (k["name"],)):
        if name in ("bna_decompose", "merge_fix"):
            row.setdefault("launches_by_path", {})["mesh plan"] = \
                ms["plan"]["launches"][name]
        if name in ("flash_attention", *BWD_KERNELS):
            row.setdefault("launches_by_path", {})["mesh step (1, 1)"] = \
                ms["step"]["launches"]["mesh"][name]

    # 18. the port's contract checker, and the launch sites it resolves
    # held against the built libraries (host only) ------------------------
    mark("18")
    record["checker"] = ck = _checker([k["name"] for k in kernels_line])
    print(f"18. checker: {ck['rules']} rules over {ck['files']} files, "
          f"{ck['findings']} findings, {ck['suppressed']} suppressed, "
          f"baseline {ck['baseline_entries']} entries, scan "
          f"{ck['scan_s']:.2f} s; {ck['launch_sites']} launch sites, "
          f"{len(ck['entries'])} entries, each exported by its library "
          f"with its CUDA declaration's argtypes; phase 18 "
          f"{ck['wall_s']:.2f} s")

    # the modelled fields go to the record: the line keeps bound_ms and
    # what this run measured
    record["kernel_models"] = {
        k["name"]: {x: k.pop(x) for x in MODEL_KEYS if x in k}
        for k in kernels_line}
    record["kernels"] = kernels_line

    smi = _nvidia_smi()
    record["nvidia_smi"] = smi
    record["total_s"] = time.perf_counter() - t_start
    record["phase_start_s"] = phase_at
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    print("plan wall times (s): " + json.dumps(
        {s: {"python_cuda": r["plan_s_cuda"], "python_cpu": r["plan_s_cpu"],
             "pipeline_cuda": pipe_runs[s]["plan_s_cuda"]}
         for s, r in runs.items()}))
    print("pipeline at scale 1.0 (s): " + json.dumps(
        {s: r["plan_s_cuda"] for s, r in full_runs.items()}))
    print("python path: BNA steps, host repairs, and their seconds (card "
          "run; CPU run): " + json.dumps(
              {s: [r["bna_steps"], r["host_repairs"],
                   [r["step_s"], r["repair_s"]],
                   [r["step_s_cpu"], r["repair_s_cpu"]]]
               for s, r in runs.items()}))
    print("serve (full width): " + json.dumps(
        {k: record["serve"][k] for k in ("prefill_s", "decode_ms_per_token",
                                         "tokens_per_s",
                                         "max_memory_allocated")}))
    print("mamba2 (full width): " + json.dumps(
        {"forward_s": record["mamba2_forward"]["wall_s"],
         "forward_peak": record["mamba2_forward"]["max_memory_allocated"],
         "forward_ssd_scan_launches":
             record["mamba2_forward"]["launches"]["ssd_scan"],
         **{k: record["mamba2_serve"][k] for k in (
             "prefill_s", "decode_ms_per_token", "tokens_per_s",
             "max_memory_allocated")}}))
    print("online (pipeline, card): " + json.dumps(
        {f"{r['job'][0]}@{r['job'][1]} a={r['job'][2]}": {
            "reschedules": r["reschedules"], "twct": r["twct"],
            **r["replan_wall"], "run_s": r["wall_s"]}
         for r in [*record["online"]["pair"], record["online"]["full"]]
         if r["job"][5] == "session"}))
    print("training (full width): " + json.dumps(
        {k: tr["train"][k] for k in ("arch", "global_batch", "seq_len",
                                     "step_s_median_2_4", "tokens_per_s",
                                     "max_memory_allocated", "loss",
                                     "grad_norm", "launches_per_step",
                                     "bucket_makespan_gain_pct", "plan_s")}))
    print("K4 backward (whole) at the training shape: "
          + json.dumps(record["attn_bwd_whole"]))
    print("mamba2 training (full width): " + json.dumps(
        {k: st["train"][k] for k in ("arch", "global_batch", "seq_len",
                                     "step_s_median_2_4", "tokens_per_s",
                                     "max_memory_allocated", "loss",
                                     "grad_norm", "launches_per_step",
                                     "bucket_makespan_gain_pct", "plan_s")}))
    print(f"total {record['total_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
