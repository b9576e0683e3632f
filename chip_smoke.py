#!/usr/bin/env python3
"""Card smoke test of the PyTorch/CUDA port of MemorySim (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py

Phases (any failed check exits non-zero):

1. device: the card's name and power limit, then the build of the CUDA
   kernels from ``src/repro_torch/csrc`` (seconds printed), the registers,
   static shared memory and spills of K3's kernels (the one-bank-a-thread
   forms and the k-banks-a-thread form), K6's kernels and its backward's,
   K5's D = 128 kernels and K7's production kernels from the ``-Xptxas
   -v`` logs (K6's tensor-core kernels at (64, 64), (128, 128) and (192,
   128) with no spill; the six tensor-core kernels of K6's backward, dK/dV
   and dQ at the same pairs, K7's backward's eight kernels and the six FMA
   instances of K6's backward that only its general form takes, none
   spilling), the count of ``HGMMA`` instructions in
   ``cuobjdump -sass`` of each of those three kernels (at least one a k
   step of a tile's two products; none in K6's FMA kernels) and of each
   of the six tensor-core kernels of K6's backward (at least one a k step
   of a tile's products, and no global atomic), and K7's bf16
   S = 16 kernel's ``MUFU.EX2`` count (at least one
   per element of a thread's chunk: exp on the SFUs) and instructions per
   ``EX2``; no global atomic in ``cuobjdump -sass`` of K7's backward;
2. every kernel against its plain PyTorch version on the card, bit for bit:
   K1/K2 at B in {32, 128}, S in {1, 3}, T in {1, 2}; K3 at lanes in
   {1, 4}, channels in {1, 2}, S in {1, 3}, T in {1, 2}, and channels of
   4, 16, 32 and 64 banks (both arbiter reduction paths); two 500-cycle K3
   rollouts that feed the kernel's outputs back in; then K3's persistent
   form ``fused_run`` against ``fused_run_plain`` (its steps replayed
   from CUDA graphs where a step's successor lies in its segment), the
   whole ``SimState`` bit for bit (sink slots stripped), on the four
   traces at 3000 cycles (conv2d also cut into launches of 7 steps), on a
   DVFS schedule with an open-page FR-FCFS segment, on a two-tier
   topology (64 banks, block barriers), on 512 banks at 1500 cycles
   (bank-queue rings in device memory), at queue 8192 / respQueue 8192
   (and the response ring), at queue 16384 / respQueue 16384 (and the
   request ring) and on a schedule of 4096 one-cycle segments at 2000
   (longer than a launch holds: launches over slices of it, more than
   one); then lanes above 1024 banks (k = B / 1024 banks a thread): 2
   channels x 2 ranks x 16 x 32 (two channels of 1024), 1 x 2 x 32 x 32
   (one channel of 2048), 2 x 4 x 16 x 32 (4096 banks, k = 4), 2 x 4 x
   32 x 32 (8192 banks, k = 8),
   8 x 8 x 32 x 32 (65 536 banks, k = 64, the bank-queue heads and counts
   in device memory too) and 16 x 8 x 32 x 32 (131 072 banks, k = 128),
   K3's per-step form against plain at lanes 1 and 2, and ``fused_run``
   against ``fused_run_plain`` on a random trace over every bank at 400
   cycles (budgets none and 7); each case prints its K3 launches (> 0)
   and must keep in device memory what it is built to move there; a
   mismatch names the leaf and the first clock at which the two differ;
   then K3's per-cycle form (``fused_run(..., cycle_skip=False)``, what
   ``simulate`` runs) against its plain version (the step of
   ``fused_run_plain(cycle_skip=False)`` replayed from CUDA graphs), the
   whole ``SimState`` bit for bit, steps = cycles: the four traces at 3000
   cycles (conv2d also in launches of 7 and of 1 step), the DVFS and
   two-tier cases, 512 banks, 2048 banks (k = 2; also launches of 7),
   queue 16384 and the 4096-segment schedule (two launches);
3. the main path at the paper's Table-1 size: ``simulate_fast`` (fused
   backend: persistent K3 launches, ``(t, steps)`` read once per launch)
   on the four benchmark traces at queue 128 over 100k cycles, each held
   against the JAX reference's golden digest (executed steps included),
   with the Table-2 rows, executed steps, steps/s, wall seconds and the
   launches: persistent K3 launches = the host loop's launches, and no
   per-step K3, K1 or K2 launch;
4. the per-cycle engine on the card: ``simulate`` with the fused backend
   (K3's per-cycle persistent form: one launch, no per-step K3, no CUDA
   graph captured) on conv2d at 20k cycles and on the four traces at 100k
   against the golden digests (all fields but ``steps``), wall seconds
   each, and on a trace with no request (``IndexError``, as the
   reference); ``simulate`` with the split backend (K1) and
   ``simulate_fast`` split (K1 + K2) on conv2d at 20k cycles against the
   golden digest, and ``simulate`` with the plain backend, which must
   agree bit for bit;
5. kernel times at the main path's shapes: device time per launch (200
   launches replayed from CUDA graphs, timed with CUDA events) beside the
   plain version's and the bandwidth bound, and the eager call time with
   its host launch (median of 200 calls), and the launch floor (a
   one-element int32 ``add_`` timed the same way); the persistent K3's
   device time per executed step on each trace at 100k cycles (one launch,
   CUDA events) beside the plain loop's time per step and the byte bound,
   and the same per cycle for its per-cycle form;
6. where a main-path step's time goes: a torch.profiler device trace of
   conv2d over 5000 cycles (device kernels and device time per executed
   step, device busy share) and the count of host synchronisations, at
   most the persistent launches plus set-up;
7. the attention kernels against their plain versions on the card, in
   float32 (max abs error 1e-5) and bfloat16 (2e-2), with random kv_len
   including 1 and S: K5 (decode) on the reference test shapes, a GQA
   group of 5, and qwen3-14b's 40/8 heads at the shapes phase 8 gives it
   (B = 4, S = 256 served; B = 2, S = 128 in the invariant), at S = 4096
   and at a ragged S = 600; K6 (prefill) on the reference test shapes,
   qwen3-14b's B = 2 at S = 1024 (prefill) and S = 128 (the invariant's
   prefill), and a ragged S = 200, causal and not; then peaked logits in
   bfloat16 (q scaled by 8, logits up to about +-30) for K6 at (1, 10,
   256, 128, 2) and the prefill shape and for K5 at the served shape and
   S = 4096; and K5 gives 0 at kv_len = 0;
8. the LLM serve path at full width: qwen3-14b (40 layers, d_model 5120,
   unreduced), random weights drawn on the card from
   ``torch.Generator(device="cuda").manual_seed(0)``, each matrix in
   float32 and cast to bfloat16 before the next is drawn; a prefill
   of 2 x 1024 tokens (K6 launches = 40), then ``serve_loop`` with 8
   requests through 4 slots (K5 launches = 40 x steps), then the serving
   invariant: 128 teacher-forced decode steps with the kernels and with
   the plain versions, each against the prefill's last-token logits;
9. attention times: device time per launch of K5 at the served shape and
   at S = 4096, of K6 in bfloat16 at B = 2, S = 1024 (the prefill's shape)
   and B = 1, S = 4096, and of K6 in float32 at B = 2, S = 1024
   (CUDA-graph replays timed with CUDA events, median), each beside the
   plain version, PyTorch's ``scaled_dot_product_attention`` (timed only,
   never on the path) and the bound;
10. K7 (selective scan) against its plain version on the card, y and
   h_final, in float32 (1e-5 x max |y|, resp. |h|) and bfloat16 (2e-2 +
   2e-2 |value|), at the reference test shapes, the jamba prefill shape
   (2, 1024, 8192, 16), the invariant's (2, 128, 8192, 16), a ragged
   (2, 200, 600, 16), T = 1 and T = 33 at B = 1, S = 8, rows that are not
   whole 16-byte pieces ((2, 33, 601, 8), and (1, 100, 36, 16) in
   bfloat16), and a long scan (1, 4096, 256, 16) with dt and A scaled by
   0.01 (dt A near 0: h accumulates over every step); each case prints
   whether K7 staged it with bulk copies or plain loads, and each dtype
   must take both;
11. the hybrid serve path: qwen3-14b's weights freed, jamba-v0.1 at full
   width (its weights drawn on the card as in 8) with its depth cut to one period of 8 layers (7 Mamba, 1
   attention; 4 dense and 4 MoE FFNs); a prefill of 2 x 1024 tokens (K7
   launches = 7, K6 = 1), ``serve_loop`` with 8 requests through 4 slots
   (K5 launches = steps), the decode-vs-prefill invariant over 2 x 128
   teacher-forced steps with the kernels and with the plain versions
   (with the prefill's MoE drop fractions), each Mamba layer's decode
   state against K7's h_final from the 128-token prefill (bfloat16: the
   layers before the first MoE FFN, 5e-2 x max |h|), and the same in
   float32 with room for every MoE assignment (logits 1e-3 x max |logit|,
   every Mamba layer 1e-3 x max |h|); peak device memory;
12. K4 (address decode): its entry point on the four traces' address
   columns at the Table-1 topology (the launches counted), then against
   its plain version bit for bit on those and random address sets of
   N in {1, 1000, 4096, 2^20 + 3} at the Table-1 topology, two channels
   and two tiered placements; device times of K4 at N = 2^24 and of K7 at
   the jamba prefill shape beside their plain versions and bounds (no
   single PyTorch call computes either, so neither has a library time),
   K7 beside its time before the Hopper redesign, and the sweep of K7's
   shapes (lanes a channel, channels a CTA, chunk) at the prefill shape
   and the invariant's, each held against the production kernel;
13. the lane-batched persistent K3 (``fused_run_batch_cuda``, one CTA a
   lane; run after the LLM phases): against its plain version, every
   lane's whole ``SimState`` bit for bit (sink slots stripped), in both
   forms, on the four traces at 3000 cycles as one ragged batch (also in
   launches of 7 steps, lanes finishing at different launches), a queue
   sweep at capacity 2048 (bank-queue rings in device memory, asserted),
   constant and DVFS lanes padded to three segments, two two-tier lanes,
   two lanes of 2048 banks (k = 2; also in launches of 7) and a batch of
   more lanes than the card holds at once (eight distinct lanes repeated,
   so CTAs run in waves); the plain version's steps are replayed from CUDA
   graphs (reused from phase 2 where the inputs are phase 2's), and a
   mismatch names the first diverging lane and the clock at which that
   lane alone first differs; then the main path through the batched entry
   points: the Table-2 batch (``simulate_batch``, the four traces at queue
   128 on capacity 2048, 100k cycles) against the golden batch digests and
   the single-lane ones, the Fig 6-9 sweep (``sweep_queue_sizes``, 11
   depths, conv2d at burst gap 18, capacity 2048) at 20k cycles against
   its golden digests and at 100k against single-lane ``simulate_fast``
   runs (Fig 7's rows printed), and ``sweep_grid`` grids of 132 (tRP x tCL
   x queue_size) and 528 lanes (x page_policy x sched_policy) on conv2d at
   100k, three lanes of each against single-lane runs; each is one launch,
   and the lane-batched K3 is the only kernel they launch; then the time of
   one launch of each batch (CUDA events) with its lanes, SMs busy, the
   CTAs an SM holds (``fused_run_batch_occupancy``), executed steps/s and
   device us per step of the longest lane, beside conv2d as a batch of one
   lane and the single-lane kernel on the same inputs, the plain version's
   time a step and the byte bound.

14. windowed sessions and the closed-loop serving study: (a)
   the four traces at 100k cycles through a fused ``SimSession`` in windows
   of 2000 (conv2d also with each window's arrivals appended before it),
   each equal to its golden digest (all fields but steps, which may exceed
   the monolithic run's by at most one a window), each window one
   persistent K3 launch and nothing else, wall per window split into the
   launch with its read and the report copy, and the device time per
   executed step inside windows beside the monolithic run's (CUDA events
   around each launch); (b) ``split`` sessions:
   conv2d at 20k in windows of 1000 against its golden digest, one CUDA
   graph captured, and conv2d at 3000 on a three-segment DVFS schedule in
   windows of 250 and 1000 against the fused ``simulate_fast``, one capture
   a segment whatever the windows; (c) a ``SessionBatch`` of 132 lanes (the
   four traces x 33, queue limits 128 to 4) in windows of 2000 at 100k,
   each window one lane-batched K3 launch, every lane equal to its
   single-lane ``simulate_fast``, the host time of a window's launch
   arguments (``_batch_args``) and report copy, and the device time a step
   of the longest lane (CUDA events around each launch); (d) the serving study's closed loop (2-channel
   DRAM and tiered CXL, loads 0.5 / 1 / 2 / 4, chat, horizon 10 000,
   windows of 400): ``run_serving_batched`` per topology against the golden
   serving digests (every ``ServingResult`` field and each lane's session),
   ``run_serving`` of one lane against its batched twin, each window one
   lane-batched launch, and each topology's wall split into launches,
   report copies and the scheduler;
15. the multi-topology sweep and the effective-bandwidth studies: (a) ``sweep_topologies`` on conv2d at 100k cycles over channels
   [1, 2] x ranks [1, 2] x banks a group [2, 4] x tCL [14, 18] x queue
   [16, 64, 128] (8 topologies, 48 lanes; each topology's launch
   enqueued on a CUDA stream of its own), every lane equal to its
   single-lane ``simulate_fast``, one lane-batched K3 launch a topology and
   nothing else, each launch's device time (CUDA events on its stream) and
   the first start to the last end, which must stay under the spread of
   the starts plus 1.25 times the longest topology's launch alone (the
   launches overlapped); the sweep's wall with the default workers and
   with ``max_workers=1`` (one topology after another), each topology's
   lanes alone in one launch (device time, steps), and the slowest
   topology's byte bound and plain version on its own lanes;
   (b) the small grid of ``golden.TOPO_GRID`` against its JAX digests, and
   a ``split`` x ``fused`` backend axis at 2000 cycles, each split lane
   equal to its fused twin; (c) every study of
   ``golden/jax_perfmodel_reference.json`` (``decode_efficiency`` and
   ``train_efficiency`` on the per-cycle ``simulate``, ``llm_grid_study``,
   ``topo_llm_grid_study``, ``dvfs_llm_study``, ``cxl_tier_study`` with
   its per-cycle bit check, ``serving_study``) at the file's arguments,
   every row equal to the reference's, ``bit_identical`` true on every
   ``cxl_tier_study`` lane, each study's wall and launches.
16. streaming and persistence: (a) ``sweep_grid`` of 4096
   points on conv2d at 100k cycles (tCL x tRCDRD x tRCDWR x tRP x queue
   [16, 32, 64, 128] x page policy x scheduler policy, capacity 128) with
   no streaming option, so it streams by the default threshold: 16 chunks
   of 256, one lane-batched K3 launch a chunk and nothing else, every
   lane equal to the same grid's ``stream=False`` run; the wall split
   into the chunks' set-up, the waits for their launches and the result
   copies, each chunk's device time (CUDA events on its stream), the peak
   of allocated device memory against ``peak_chunk_bytes``, and the
   slowest chunk's time a step of its longest lane beside its lanes' byte
   bound and its plain protocol (2 steps of every lane); (a') phase
   15(a)'s grid streamed under a ``memory_budget_bytes`` of 4-lane
   chunks, every lane equal to ``sweep_topologies``'; (b) a child process
   streaming the 256 points of (a)'s tCL x tRCDRD x tRP x queue axes in
   chunks of 32 into a checkpoint, SIGKILLed before chunk 4 commits
   (chunks 0-3 left), a second child resuming it (4 chunks restored, 4
   launches) and then sweeping again (all 8 restored, no launch), each
   equal to (a)'s lanes; (c) two fresh children over one empty
   ``MEMSIM_EXEC_CACHE_DIR``, each loading only the library its sweep
   runs (K3's, ``CACHE_LIBS``): the first builds it (its nvcc seconds
   printed), the second builds none (0 compiles, a hit, no error) and
   gives the same ``t_complete``.
17. training: (a) K6's backward (``flash_attention_bwd_cuda``,
   ``csrc/flash_attention_bwd.cu``) against autograd through its plain
   version in float32: causal at minicpm-2b's B 4, H 36/36, S 1024, D 64
   in bf16 and float32, qwen3-14b's B 1, H 40/8, D 128 in bf16, and ragged
   small cases (S 77-256, D 16-128, GQA, causal and not): dq, dk
   and dv within 1e-4 (float32) / 2e-2 (bf16) x max |plain|, K6's lse
   within 1e-5 of ``logsumexp``, K6's output bit-identical with and
   without the lse pointer; at minicpm's and qwen3's bf16 shapes a second
   launch bit-identical to the first, the backward's device time (a CUDA
   graph of launches) and each of its three kernels' (the profiler)
   beside the bound (10 S^2 D B Hq / 2 flops at 989 TFLOP/s against its
   bytes) and SDPA's backward (CUDA graphs of its forward + backward and
   of its forward), at minicpm's also beside its plain version; K5, K7
   and K6's plain launch raise for inputs that require grad; (b)
   minicpm-2b at its published width and depth (40 layers, 2.72 B
   parameters, float32 masters drawn on the card): step 0's loss and
   gradient norm with K6's plain backward against K6's kernels (1e-3 and
   1e-2 relative), every parameter's gradient finite and not zero, then 5
   steps of ``make_train_step`` in bf16 (B 4 x S 1024, WSD) with 80 K6
   and 40 K6-backward launches a step, the median wall of steps 2-5,
   tokens/s, peak allocated memory, and a sixth step under the profiler
   (device busy share, largest kernels); (c) the training CLI's
   fault-tolerance drill on the card in child processes (tiny minicpm, 8
   steps: a crash at step 5 and an uninterrupted run, both started beside
   16(b)'s children and waited for before 17(a), so that no child shares
   the card with 17's timings; then a resumed run), the resumed losses
   equal the uninterrupted ones (rtol 1e-6).
18. the MLA, xLSTM and encoder-decoder families (run last): (a) K6's
   general form (Dqk != Dv, Sq != Sk, the caller's scale: in bf16 at
   (64, 64), (128, 128) and (192, 128) the tensor-core kernel
   ``flash_attention_gen_tc_launch``, counted under ``k6gen_tc``; in
   float32 and at smaller widths the FMA kernel
   ``flash_attention_gen_launch``, under ``k6gen``) against its plain
   version in float32 and bfloat16 (1e-5 / 2e-2 x max |plain|) at
   deepseek-v3's MLA prefill shape (2, 128/128, 1024, 192/128) causal, a
   cross shape (Sq 256 against a ragged Sk 1000, not causal) and small
   ragged, GQA and tiny-MLA shapes, each launch under the key of the form
   its dtype and widths choose (MLA's and the cross shape: tensor cores in
   bf16, FMA in float32), and at those two shapes its log-sum-exp within
   1e-5 of ``logsumexp``; a shape no form takes, causal Sq != Sk and a
   shape no form takes under grad raise; its device time in bf16 at MLA's shape
   beside its plain version, SDPA (timed only) and the bound, and at the
   cross shape beside SDPA and the bound; (b) deepseek-v3 at its
   published widths, depth cut 61 -> 4 (the 3 dense prefix layers and 1
   MoE layer of 256 experts top-8, 15.1 B parameters, 30.2 GB in bf16): a
   prefill of 2 x 1024 (4 launches of the general form, all on the
   tensor cores; the latent caches'
   shapes), ``serve_loop`` of 8 requests through 4 slots (no kernel: MLA's
   decode is absorbed einsums), the decode step's device profile beside
   the weight-streaming floor, and decode against prefill over 2 x 128
   tokens in float32 with room for every MoE assignment, within 1e-3 x max
   |logit| (no kernel runs in the decode, so phase 8's bf16 rule, kernel
   path against plain path, has nothing to compare; float32 is the gate);
   (c) xlstm-1.3b at its published
   width and depth (42 mLSTM + 6 sLSTM layers, 3.5 B parameters): a prefill
   of 2 x 128 (a loop over the steps; no kernel), ``serve_loop``, the
   step's floor (weights + the mLSTM states read and written) and
   profile, and decode against prefill in float32 (the gate, as in (b)):
   on the first period within 1e-3 of logits and states, on all 48
   layers within ``DEEP_F32_TOL``; (d) seamless-m4t-medium at its
   published dims, unreduced: encode 4 x 1024 frame embeddings (12 K6
   launches) and the cross K/V, 32 greedy decode steps (24 K5 launches a
   step), the step's profile, and 8 steps of the kernel path within 2e-2
   x max |logit| of the plain path's, in bf16.
19. every family trains (run last): (a) K7's saving forward
   (``selective_scan_save_cuda``: y and h_final bit for bit those of
   ``selective_scan_cuda``, its last checkpoint the plain h_final over
   the steps before it) and K7's backward (``selective_scan_bwd_cuda``,
   ``csrc/selective_scan_bwd.cu``, from those checkpoints) against
   autograd through ``selective_scan_ref`` in float32, dx, ddt, dB, dC and
   dA within 1e-4 (float32) / 2e-2 (bf16, against the float32 plain
   version on the same bf16 inputs) x max |plain|, with the gradient of
   h_final and without, at the JAX tests' shapes, jamba's (2, 1024, 8192,
   16), (2, 128, 8192, 16), a ragged (2, 200, 600, 16), T 1 and 33 at S
   8, T 15, 17 and 49 against chunks of 16 with D ragged against the
   channel block and S 8 (each float32 and bf16) and (1, 4096, 256, 16)
   with dt A near 0; a second launch, from the inputs alone,
   bit-identical; its device time at jamba's shape (CUDA events) beside
   K7's forward, plain and saving, its plain version and the bound (no
   library call computes it), and the sweep of its (lanes, channels,
   chunk) there; (b) K6's backward at its general form (bf16 at (64,
   64), (128, 128) and (192, 128): the tensor-core kernels of
   ``flash_attention_bwd_gen_tc_launch``, under ``k6bwd_gen_tc``; float32
   and the tiny widths: the FMA kernels of
   ``flash_attention_bwd_gen_launch``, under ``k6bwd_gen``) against
   autograd through ``gqa_attention_ref`` (phase 17's gates) at MLA's
   (2, 128/128, 1024, 192/128) causal bf16 (float32 on 16 heads), the
   cross shape (4, 16/16, Sq 256, Sk 1000, 64), the tiny (24, 16), an
   explicit scale 0.5, GQA across Sq != Sk at (192, 128) and at (128,
   128) with a scale of 0.2, (192, 128) at lengths that leave the dQ
   kernel's second warpgroup past Sq (causal S 130; GQA Sq 40 against Sk
   133, scale 0.3), and seamless's encoder shape through the base form's
   backward; each launch under its form's key, a second
   launch bit-identical; device times at MLA's and the cross shape, and
   each of the three kernels' by the profiler, beside the bound, the
   plain version and SDPA's backward;
   (c) four families at their published widths, float32 masters drawn on
   the card, bf16 compute, each freed before the next: jamba-v0.1 (8 of
   32 layers, 2 of 16 experts top-2; B 2 x S 1024), deepseek-v3 (its 3
   dense prefix layers of 61, no MoE layer; B 2 x S 1024), xlstm-1.3b (8
   of 48 layers: 7 mLSTM + 1 sLSTM; B 2 x S 256) and seamless-m4t-medium
   (unreduced; B 4, 1024 source frames, 256 target tokens): the first
   batch's loss and gradient norm with the kernels against every kernel's
   plain version (1e-3 and 1e-2 relative; xlstm runs no kernel), every
   gradient finite and not zero, then 3 steps of ``make_train_step``
   (cosine), each kernel's launches a step held to the model's layers
   (jamba: K7 14, K7's backward 7, K6 2, K6's backward 1; deepseek: the
   general form 3, its backward 3; seamless: K6 24, K6's backward 24, the
   general form 12, its backward 12; both general forms on the tensor
   cores), the median wall of steps 2-3,
   tokens/s and peak allocated memory.
20. the cost model and the sharding layer on the card (run last): (a)
   ``perfmodel.analytic.param_counts`` of all ten configs (from their
   trees on ``meta``, nothing drawn) and xlstm-1.3b at its published width
   and depth drawn on the card in bf16, the sum of its tensors' sizes
   equal to the count; (b) ``launch.specs.batch_specs(cfg,
   "long_500k")["caches"]`` against ``registry.init_caches(cfg, 1,
   524288, bf16)`` on the card, leaf by leaf in shape and dtype; (c)
   xlstm-1.3b's ``long_500k`` cell, one decode step at batch 1 at
   position 524 287 (CUDA events, median of 10 after 3 warm-ups), no
   faster than ``roofline_terms(cell_cost(cfg, "long_500k", devices=1),
   0, 1)["bound_s"]`` under the H100's constants, printed beside the
   analytic ``flops_fwd`` and ``kv_bytes``, ``FlopCounterMode``'s count of
   the real step and the real caches' bytes, and ``hbm_bytes`` less its
   activation term within rel 1e-3 of the card's weight and cache bytes;
   (d) ``optim.compression.compressed_psum`` on a one-rank NCCL group (an
   in-process ``HashStore``, no socket) on the card against the same call
   on a one-rank gloo group on the CPU, bit for bit (else within one
   quantum, and the phase says which); (e)
   ``distributed.shard.round_robin_devices(8)`` over the visible cards,
   and phase 15(a)'s ``sweep_topologies`` with no device given, at once
   and streamed: each topology on its round-robin card, every lane equal
   to the sweep's on ``cuda:0``.

``python3 chip_smoke.py --placement CHECKOUT`` runs only 20(e)'s sweeps,
of the port in another checkout: on a machine of several cards it holds
the topologies spread over them to the one-card sweep.

``python3 chip_smoke.py --split-times CHECKOUT`` runs only the split
backend's ``simulate_fast`` on conv2d at 20k cycles (phase 4's run) of the
port in another checkout, printing its wall time, so that two checkouts
compare on one card, each in its own process (A B B A).

``python3 chip_smoke.py --topology-sweep CHECKOUT`` runs only phase
15(a)'s sweep, twice, in a fresh process of the port in another checkout
(no form of the lane-batched K3 loaded before the first), printing each
sweep's wall, launch starts and device times.

``python3 chip_smoke.py --k6-bwd-times CHECKOUT`` runs only K6's
backward's device time a launch at minicpm-2b's and qwen3-14b's bf16
shapes, of the port in another checkout (A B B A, as below).

``python3 chip_smoke.py --k6-gen-times CHECKOUT`` runs only K6's general
form at MLA's shape, its base forms at qwen3-14b's and minicpm-2b's bf16
shapes, K6's general backward at MLA's and the cross shape and its base
forms' backward at minicpm-2b's and qwen3-14b's bf16 shapes (device µs a
launch) and deepseek-v3's 4-layer prefill of 2 x 1024 (wall ms, three
runs), of the port in another checkout (A B B A, as below).

``python3 chip_smoke.py --k7-bwd-times CHECKOUT`` runs only K7's
backward and K7's forward (plain, and saving where the checkout has it)
at jamba's training shape (device µs a launch) and phase 19(c)'s jamba
cell trained 5 steps (wall ms a step, peak GB), of the port in another
checkout (A B B A, as below).

``python3 chip_smoke.py --k7-bwd-parts CHECKOUT`` times K7's backward of
the port in another checkout with one part taken out at a time (the
consumers' arithmetic, the write-back, a pass, the exps, the shuffle
sums; a third stage), each form built from a copy of its source: what a
part costs where the others do not hide it.

``python3 chip_smoke.py --train-kernel-times CHECKOUT`` runs only K7's
forward at jamba's training shape and K6's base-form backward at
minicpm-2b's bf16 and float32 and qwen3-14b's bf16 shapes (device µs a
launch), of the port in another checkout (A B B A, as below).

``python3 chip_smoke.py --k3-step-times CHECKOUT`` runs only the
single-lane persistent K3's time per step (four traces at 100k cycles,
three launches each) of the port in another checkout, so that two
checkouts compare on one card, each in its own process (A B B A).

Before them the script prints each phase's wall in seconds and the total.
The second-to-last lines are the kernel JSON object and the card line of
``nvidia-smi``; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 bandwidth
BF16_FLOPS_PER_S = 989e12  # H100 SXM published dense bf16 tensor-core rate


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- operands --

def rand_int(gen, lo, hi, shape):
    import torch

    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)


def rand_point(gen, page=None, sched=None):
    from repro_torch.core.params import RuntimeParams

    def r(lo, hi):
        return int(rand_int(gen, lo, hi, (1,))[0])

    trfc = r(20, 300)
    return RuntimeParams(
        tRP=r(1, 30), tFAW=r(20, 40), tRRDL=r(1, 20), tRCDRD=r(1, 30),
        tRCDWR=r(1, 30), tCCDL=r(1, 8), tWTR=r(1, 12), tRFC=trfc,
        tREFI=trfc + r(100, 4000), tCL=r(1, 30), tXS=r(1, 20),
        tRTW=r(1, 8), sref_idle_cycles=r(5, 1500),
        page_policy=r(0, 2) if page is None else page,
        sched_policy=r(0, 2) if sched is None else sched)


def rand_schedule(gen, segments, tiers):
    """A valid random ParamSchedule (CPU) of S segments and T tiers."""
    import torch
    from repro_torch.core.params import (
        ParamSchedule, RuntimeParams, tiered_params)

    points = []
    for _ in range(segments):
        page = int(rand_int(gen, 0, 2, (1,))[0])
        sched = int(rand_int(gen, 0, 2, (1,))[0])
        pts = [rand_point(gen, page, sched) for _ in range(tiers)]
        points.append(pts[0] if tiers == 1 else tiered_params(*pts))
    bounds = torch.tensor([0, 100, 400][:segments], dtype=torch.int32)
    return ParamSchedule(boundaries=bounds,
                         values=RuntimeParams.stack(points)).validate()


def rand_state(gen, b, row_shift):
    import torch

    s = torch.stack([
        rand_int(gen, 0, 14, (b,)),                 # st
        rand_int(gen, 0, 40, (b,)),                 # timer
        rand_int(gen, 0, 1200, (b,)),               # idle_ctr
        rand_int(gen, 0, 8000, (b,)),               # refresh_due
        rand_int(gen, 0, 64 << row_shift, (b,)),    # cur_addr
        rand_int(gen, 0, 2, (b,)),                  # cur_write
        rand_int(gen, 0, 1 << 30, (b,)),            # cur_data
        rand_int(gen, -1, 1000, (b,)),              # cur_id
        rand_int(gen, -1, 64, (b,)),                # open_row
        rand_int(gen, 0, 4, (b,)),                  # pending
    ])
    return s


def rand_pop(gen, b, row_shift):
    import torch

    return torch.stack([rand_int(gen, 0, 64 << row_shift, (b,)),
                        rand_int(gen, 0, 2, (b,)),
                        rand_int(gen, 0, 1 << 30, (b,)),
                        rand_int(gen, 0, 1000, (b,))])


def k3_operands(gen, topo, lanes, segments, cycle):
    """Random K3 operands (CPU) of the ABI in repro_torch.kernels.bank_fsm
    .fused, at ``lanes`` lanes of ``topo``."""
    import torch

    b = topo.num_banks
    total = lanes * b
    qr = topo.resp_queue_size
    rs = topo.row_shift
    state = rand_state(gen, total, rs)
    qhead = rand_int(gen, 0, topo.queue_size, (total,))
    qcount = rand_int(gen, 0, 4, (total,)) * rand_int(gen, 0, 2, (total,))
    timing = cycle - rand_int(gen, 0, 80, (7, total))
    bank_rows = torch.cat([state, qhead[None], qcount[None], timing,
                           rand_pop(gen, total, rs)])
    resp = rand_int(gen, 0, 1 << 20, (lanes * qr, 4))
    packs = [rand_schedule(gen, segments, topo.tiers).pack()
             for _ in range(lanes)]
    bounds = torch.cat([p[0] for p in packs])
    rp = torch.cat([p[1] for p in packs])
    inf = 0x3FFFFFFF
    arrival = rand_int(gen, -3, 200, (lanes,))
    arrival = torch.where(rand_int(gen, 0, 4, (lanes,)) == 0, inf, arrival)
    scal = torch.stack([
        torch.full((lanes,), cycle, dtype=torch.int32),
        arrival,
        cycle + rand_int(gen, 1, 5000, (lanes,)),
        rand_int(gen, 0, 3, (lanes,)) * (rand_int(gen, 0, 3, (lanes,)) == 0),
        rand_int(gen, 0, qr, (lanes,)),
        rand_int(gen, 0, qr + 1, (lanes,)) * rand_int(gen, 0, 2, (lanes,)),
        rand_int(gen, 1, qr + 1, (lanes,)),
        rand_int(gen, 0, b, (lanes,)),
    ] + [rand_int(gen, 0, topo.banks_per_channel, (lanes,))
         for _ in range(topo.channels)], dim=1).to(torch.int32)
    return [bank_rows.contiguous(), resp, rp.contiguous(),
            bounds.contiguous(), scal.contiguous()]


def max_err(a, b):
    import torch

    if a.shape != b.shape:
        return float("inf")
    return (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() \
        if a.numel() else 0


# ------------------------------------------------------------------ phases --

def phase_device():
    import torch
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[1] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.load()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds():.1f} s) from {build.CSRC}")
    out_dir = build.build_dir()
    prod = k7_production()
    bwd = k7_bwd_production()
    for name, keep in (("fused", None), ("flash_attention", None),
                       ("flash_attention_bwd", None),
                       ("decode_attention", "Li128E"),
                       ("selective_scan", "scan_kernel"),
                       ("selective_scan_bwd", None)):
        rows = ptxas_report((out_dir / f"{name}.log").read_text(), keep)
        if name == "fused":
            check(any("fused_run_batch_kernel" in r[0] for r in rows),
                  "no lane-batched K3 (fused_run_batch_kernel) in the "
                  "ptxas log of csrc/fused.cu")
        if name == "flash_attention":
            tc_rows = {r[0]: r[3] for r in rows if "tc_fwd_kernel" in r[0]}
            check(sorted(tc_rows) == sorted(K6_TC_KERNELS) and all(
                v == "0/0" for v in tc_rows.values()), f"K6's tensor-core "
                f"kernels in the ptxas log, spill stores/loads: {tc_rows} "
                f"(want {K6_TC_KERNELS}, none spilling)")
        if name == "flash_attention_bwd":
            gen = {r[0]: r[3] for r in rows if "simt::" in r[0] and any(
                f"{p}>" in r[0] for p in K6_BWD_GEN_NEW)}
            check(len(gen) == 6 and all(v == "0/0" for v in gen.values()),
                  f"the general backward's FMA instances new in its "
                  f"template, spill stores/loads: {gen} (want 6, none "
                  f"spilling)")
            tc = {r[0]: r[3] for r in rows if "tc::" in r[0]}
            check(sorted(tc) == sorted(K6_BWD_TC_KERNELS) and all(
                v == "0/0" for v in tc.values()), f"K6's backward's "
                f"tensor-core kernels, spill stores/loads: {tc} (want "
                f"{sorted(K6_BWD_TC_KERNELS)}, none spilling)")
        if name == "selective_scan":
            save = {r[0]: r[3] for r in rows if r[0] == prod["save_name"]}
            check(list(save.values()) == ["0/0"], f"K7's saving form "
                  f"{prod['save_name']}, spill stores/loads: {save}")
        if name == "selective_scan_bwd":
            want = 8 + len(set(bwd["sweep"]) - {bwd["shape"]})
            check(len(rows) == want and all(r[3] == "0/0" for r in rows)
                  and any(r[0] == bwd["name"] for r in rows),
                  f"K7's backward kernels, spill stores/loads: "
                  f"{[(r[0], r[3]) for r in rows]} (want {want} with "
                  f"{bwd['name']}, none spilling)")
        for fn, regs, smem, spills in rows:
            if name == "selective_scan" and fn not in (prod["name"],
                                                       prod["save_name"]):
                continue  # the sweep's shapes: not on the path
            log(f"[1] {name}: {fn}: {regs} registers, {smem} B static "
                f"shared memory, spill stores/loads {spills}")
    k6_fwd_sass(out_dir)
    k6_bwd_sass(out_dir)
    k7_sass(out_dir / "libselective_scan.so", prod)
    k7_bwd_sass(out_dir / "libselective_scan_bwd.so", bwd)
    return card


#: the (DQK, DV) pairs of K6's backward's FMA template that only the
#: general form instantiates: the tests' (24, 16) in float32 and bf16 and
#: MLA's (192, 128) in float32 (their dK/dV and dQ kernels: 6 kernels;
#: bf16 at the tensor-core pairs takes the tc kernels)
K6_BWD_GEN_NEW = ("float, 24, 16", "__nv_bfloat16, 24, 16",
                  "float, 192, 128")
#: K6's backward's tensor-core kernels, (DQK, DV): the base forms' D 64 and
#: 128 and MLA's (192, 128), base and general forms alike
K6_BWD_TC_KERNELS = {f"tc::{fn}<{qk}, {vv}>": (fn, qk, vv)
                     for fn in ("dkdv_kernel", "dq_kernel")
                     for qk, vv in ((64, 64), (128, 128), (192, 128))}


def k7_bwd_sass(lib, bwd):
    """K7's backward: no global atomic in any of its kernels (its sums
    over channels and over B are per-block partials added in a fixed
    order); its bf16 S = 16 production kernel holds at least two MUFU.EX2
    an element of a thread's chunk (the recompute's exp and the reverse
    step's: chunk x S / lanes each), exp on the SFUs."""
    funcs = sass_functions(lib)
    check(len(funcs) >= 8, f"{lib.name}: kernels {sorted(funcs)}")
    n = {f: sum(op.startswith(("RED.", "ATOMG")) for op in ops)
         for f, ops in funcs.items()}
    check(not any(n.values()), f"{lib.name}: global atomics {n}")
    ops = funcs.get(bwd["name"])
    check(ops is not None, f"{bwd['name']} not found in {lib.name}: "
          f"{sorted(funcs)[:4]} ...")
    ex2 = sum(op.startswith("MUFU.EX2") for op in ops)
    per_chunk = bwd["chunk"] * 16 // bwd["lanes"]
    check(ex2 >= 2 * per_chunk, f"{bwd['name']} has {ex2} MUFU.EX2, fewer "
          f"than two per element of a thread's chunk ({2 * per_chunk}): "
          f"exp is not on the SFUs")
    log(f"[1] {lib.name}: {len(funcs)} kernels, global atomics (RED, "
        f"ATOMG) 0 in each; {bwd['name']}: {ex2} MUFU.EX2 (a thread's "
        f"chunk holds {per_chunk} elements: {bwd['chunk']} steps x "
        f"{16 // bwd['lanes']} states, two exps each), {len(ops)} SASS "
        f"instructions")


#: K6's tensor-core forward instantiations, (DQK, DV): the base forms' D
#: 64 and 128 and MLA's (192, 128), base and general forms alike
K6_TC_KERNELS = {f"tc::tc_fwd_kernel<{qk}, {vv}>": (qk, vv)
                 for qk, vv in ((64, 64), (128, 128), (192, 128))}


def k6_fwd_sass(out_dir):
    """K6's forward, tensor-core form: each instantiation holds HGMMA, at
    least one a k step of a tile's two products (DQK / 16 for S = Q K^T, 8
    for O += P V over 128 keys), and so does no other kernel of the
    library (the FMA forms)."""
    funcs = sass_functions(out_dir / "libflash_attention.so")
    rows = []
    for name, (qk, vv) in K6_TC_KERNELS.items():
        ops = funcs.get(name)
        check(ops is not None, f"{name} not in libflash_attention.so: "
              f"{sorted(funcs)[:6]} ...")
        n = sum(op.startswith("HGMMA") for op in ops)
        want = qk // 16 + 8
        check(n >= want, f"{name}: {n} HGMMA, fewer than one a k step of "
              f"a tile's products ({want}): not on the tensor cores")
        rows.append(f"{name} HGMMA {n} (a tile's k steps {want})")
    other = {f: sum(op.startswith("HGMMA") for op in ops)
             for f, ops in funcs.items() if f not in K6_TC_KERNELS}
    check(not any(other.values()), f"HGMMA outside the tensor-core "
          f"kernels: {other}")
    log("[1] libflash_attention.so: " + "; ".join(rows) + f"; the "
        f"{len(other)} FMA kernels 0")


def k6_bwd_sass(out_dir):
    """K6's backward, tensor-core form: its dK/dV and dQ kernels at (64,
    64), (128, 128) and (192, 128) each hold HGMMA (every product on wgmma:
    two SS score products over DQK / 16 and DV / 16 k steps and one or two
    RS gradient products of 4 k steps a tile) and no global atomic; the
    FFMAs left are the softmax's scale and subtract, not a product's loop
    over D."""
    funcs = sass_functions(out_dir / "libflash_attention_bwd.so")
    rows = []
    for name, (fn, qk, vv) in K6_BWD_TC_KERNELS.items():
        ops = funcs.get(name)
        check(ops is not None, f"{name} not in libflash_attention_bwd.so"
              f": {sorted(funcs)[:6]} ...")
        want = qk // 16 + vv // 16 + (8 if fn == "dkdv_kernel" else 4)
        n = {k: sum(op.startswith(k) for op in ops)
             for k in ("HGMMA", "FFMA", "RED.", "ATOMG")}
        check(n["HGMMA"] >= want, f"{name}: {n['HGMMA']} HGMMA, fewer "
              f"than one a k step of a tile's products ({want})")
        check(n["RED."] == n["ATOMG"] == 0, f"{name}: {n['RED.']} RED and "
              f"{n['ATOMG']} ATOMG instructions: the backward must use "
              f"no global atomics")
        rows.append(f"{name} HGMMA {n['HGMMA']} (a tile's k steps "
                    f"{want}), FFMA {n['FFMA']}, global atomics 0")
    log("[1] libflash_attention_bwd.so: " + "; ".join(rows))


def k7_production():
    """K7's production shape (csrc/selective_scan.cu K7_PROD) and the name of
    its bfloat16, S = 16 kernel as c++filt prints it."""
    import ctypes

    from repro_torch.kernels import build

    from repro_torch.kernels.selective_scan.selective_scan import BWD_CHUNK

    cfg = (ctypes.c_int * 3)()
    build.load()["selective_scan"].selective_scan_config(cfg)
    lanes, channels, chunk = list(cfg)
    name = f"scan_kernel<__nv_bfloat16, 16, {lanes}, {channels}, {chunk}"
    return {"lanes": lanes, "channels": channels, "chunk": chunk,
            "name": f"{name}, 0>", "save_name": f"{name}, {BWD_CHUNK}>"}


def k7_bwd_production():
    """K7's backward's production shape (csrc/selective_scan_bwd.cu
    K7_BWD_PROD), held to the wrapper's scratch layout (``BWD_CHANNELS``,
    ``BWD_CHUNK``), its sweep's shapes and the name of its bfloat16, S = 16
    kernel as c++filt prints it."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan.selective_scan import (
        BWD_CHANNELS, BWD_CHUNK)

    lib = build.load()["selective_scan_bwd"]
    cfg = (ctypes.c_int * 3)()
    lib.selective_scan_bwd_config(cfg)
    lanes, channels, chunk = list(cfg)
    check((channels, chunk) == (BWD_CHANNELS, BWD_CHUNK), f"K7's backward "
          f"compiled at (channels, chunk) {(channels, chunk)}, the wrapper "
          f"lays its scratch out for {(BWD_CHANNELS, BWD_CHUNK)}")
    rows = (ctypes.c_int * 48)()
    n = lib.selective_scan_bwd_sweep_configs(rows, 16)
    return {"lanes": lanes, "channels": channels, "chunk": chunk,
            "shape": (lanes, channels, chunk),
            "sweep": [tuple(rows[3 * i:3 * i + 3]) for i in range(n)],
            "name": f"scan_bwd_kernel<__nv_bfloat16, 16, {lanes}, "
                    f"{channels}, {chunk}>"}


def sass_functions(lib):
    """{demangled kernel name: [SASS opcodes]} of ``cuobjdump -sass``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed on {lib}: {sass.stderr}")
    funcs, cur = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if m and cur is not None:
            cur.append(m.group(1))
    names = list(funcs)
    plain = subprocess.run(["c++filt"], input="\n".join(names),
                           capture_output=True, text=True, timeout=60)
    if plain.returncode == 0 and len(plain.stdout.splitlines()) == len(names):
        names = [n.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0] for n in plain.stdout.splitlines()]
    return dict(zip(names, funcs.values()))


def k7_sass(lib, prod):
    """MUFU.EX2 and all instructions of K7's bf16 S = 16 production kernel:
    at least one EX2 per element of a thread's unrolled chunk (chunk x S /
    lanes; the compiler may copy part of the loop) shows exp on the SFUs;
    the instructions spanned by the densest run of one chunk's EX2s, per
    element, are the compute loop's cost per element."""
    funcs = sass_functions(lib)
    ops = funcs.get(prod["name"])
    check(ops is not None, f"{prod['name']} not found in {lib.name}: "
          f"{sorted(funcs)[:4]} ...")
    ex2 = [i for i, op in enumerate(ops) if op.startswith("MUFU.EX2")]
    per_chunk = prod["chunk"] * 16 // prod["lanes"]
    check(len(ex2) >= per_chunk, f"K7 has {len(ex2)} MUFU.EX2, fewer than "
          f"one per element of a thread's chunk ({per_chunk}): exp is not "
          f"on the SFUs")
    # the densest run of one chunk's EX2s is the unrolled compute loop
    span = min(ex2[i + per_chunk - 1] - ex2[i] + 1
               for i in range(len(ex2) - per_chunk + 1))
    log(f"[1] libselective_scan.so {prod['name']}: {len(ex2)} MUFU.EX2 "
        f"(a thread's chunk holds {per_chunk} elements: {prod['chunk']} "
        f"steps x {16 // prod['lanes']} states); {len(ops)} SASS "
        f"instructions in all; the densest {per_chunk} EX2 span {span} "
        f"instructions = {span / per_chunk:.2f} per element")


def ptxas_report(text, keep=None):
    """(kernel, registers, static shared bytes, spill stores/loads) of each
    entry function in an ``nvcc -Xptxas -v`` log whose mangled name holds
    ``keep`` (all when None), names demangled by c++filt where present."""
    import re

    rows, name, spills = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            if keep is None or keep in name:
                rows.append([name, int(m.group(1)),
                             int(smem.group(1)) if smem else 0, spills])
            name = None
    try:
        names = subprocess.run(["c++filt"],
                               input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60)
        plain = names.stdout.splitlines()
        if names.returncode == 0 and len(plain) == len(rows):
            for r, n in zip(rows, plain):
                r[0] = n.replace("(anonymous namespace)::", "").split(
                    "(")[0].replace("void ", "")
    except OSError:
        pass
    return rows


def topo_for(channels, tiers, ranks=2, **kw):
    from repro_torch.core.params import MemSimConfig

    cfg = MemSimConfig(channels=channels, ranks=ranks, tiers=tiers,
                       cxl_channels=1 if tiers == 2 else 0, **kw)
    return cfg.validate().topology()


def phase_kernels():
    import torch
    from repro_torch.kernels.bank_fsm.bank_fsm import (
        bank_event_bound_cuda, bank_fsm_step_cuda)
    from repro_torch.kernels.bank_fsm.fused import (
        fused_step_cuda, fused_step_plain)
    from repro_torch.kernels.bank_fsm.ref import (
        bank_event_bound_plain, bank_fsm_step_plain)

    gen = torch.Generator().manual_seed(2024)
    errs = {"k1": 0, "k2": 0, "k3": 0}
    # K1/K2: (B, T) -> topology
    k12 = {(32, 1): topo_for(1, 1), (32, 2): topo_for(2, 2, ranks=1),
           (128, 1): topo_for(2, 1, ranks=4), (128, 2): topo_for(2, 2,
                                                                  ranks=4)}
    n12 = 0
    for (b, t), topo in k12.items():
        check(topo.num_banks == b, f"topology for B={b} has "
              f"{topo.num_banks} banks")
        for s in (1, 3):
            for cycle in (0, 99, 100, 101, 399, 400, 4321):
                sched = rand_schedule(gen, s, t)
                bounds, rp = (x.to(DEVICE) for x in sched.pack())
                state = rand_state(gen, b, topo.row_shift).to(DEVICE)
                inputs = rand_int(gen, 0, 2, (3, b)).to(DEVICE)
                pop = rand_pop(gen, b, topo.row_shift).to(DEVICE)
                cyc = torch.full((1, 1), cycle, dtype=torch.int32,
                                 device=DEVICE)
                ks, kf = bank_fsm_step_cuda(topo, state, inputs, pop, rp,
                                            bounds, cyc)
                ps, pf = bank_fsm_step_plain(topo, state, inputs, pop, rp,
                                             bounds, cyc)
                e1 = max(max_err(ks, ps), max_err(kf, pf))
                split = topo.tier_split_bank if t > 1 else 0
                kb = bank_event_bound_cuda(state, rp, bounds, cyc, tiers=t,
                                           tier_split=split)
                pb = bank_event_bound_plain(state, rp, bounds, cyc,
                                            topo=topo if t > 1 else None)
                e2 = max_err(kb, pb)
                check(e1 == 0, f"K1 != plain at B={b} S={s} T={t} "
                      f"cycle={cycle} (max abs err {e1})")
                check(e2 == 0, f"K2 != plain at B={b} S={s} T={t} "
                      f"cycle={cycle} (max abs err {e2})")
                errs["k1"] = max(errs["k1"], e1)
                errs["k2"] = max(errs["k2"], e2)
                n12 += 1
    log(f"[2] K1, K2 == plain on {n12} random cases each "
        f"(B in {{32,128}}, S in {{1,3}}, T in {{1,2}})")

    # K3: (channels, T, ranks)
    # banks per channel 32, 32, 32, 64 (shared-memory arbiter), 16 and 4
    # (narrow and partial-warp shuffles)
    k3_topos = [topo_for(1, 1), topo_for(2, 1), topo_for(2, 2),
                topo_for(2, 1, ranks=4), topo_for(2, 1, ranks=1),
                topo_for(1, 1, ranks=1, bankgroups=2, banks_per_group=2)]
    n3 = 0
    for topo in k3_topos:
        for lanes in (1, 4):
            for s in (1, 3):
                for cycle in (0, 99, 100, 399, 2500):
                    ops = k3_operands(gen, topo, lanes, s, cycle)
                    cu = [x.to(DEVICE) for x in ops]
                    k = fused_step_cuda(topo, *cu, lanes=lanes)
                    p = fused_step_plain(topo, *cu, lanes=lanes)
                    e = max(max_err(a, b) for a, b in zip(k, p))
                    check(e == 0, f"K3 != plain at C={topo.channels} "
                          f"T={topo.tiers} per={topo.banks_per_channel} "
                          f"L={lanes} S={s} cycle={cycle} (err {e})")
                    errs["k3"] = max(errs["k3"], e)
                    n3 += 1
    log(f"[2] K3 == plain on {n3} random cases (L in {{1,4}}, C in {{1,2}}, "
        f"S in {{1,3}}, T in {{1,2}}, banks/channel in {{4,16,32,64}})")

    for topo, lanes, s in ((topo_for(1, 1), 1, 1), (topo_for(2, 2), 4, 3)):
        e, delta_pos = k3_rollout(gen, topo, lanes, s, 500)
        errs["k3"] = max(errs["k3"], e)
        log(f"[2] K3 rollout 500 cycles C={topo.channels} T={topo.tiers} "
            f"L={lanes} S={s}: == plain every cycle ({delta_pos} "
            f"lane-cycles with a skip > 0)")

    # lanes above 1024 banks: k = B / 1024 banks a thread
    from repro_torch.kernels import build
    for label, topo in big_topologies():
        build.reset_launches()
        n = 0
        for lanes in (1, 2):
            for s in (1, 3):
                for cycle in (0, 100, 399, 2500):
                    ops = k3_operands(gen, topo, lanes, s, cycle)
                    cu = [x.to(DEVICE) for x in ops]
                    k = fused_step_cuda(topo, *cu, lanes=lanes)
                    p = fused_step_plain(topo, *cu, lanes=lanes)
                    e = max(max_err(a, b) for a, b in zip(k, p))
                    check(e == 0, f"K3 != plain at {label} L={lanes} S={s} "
                          f"cycle={cycle} (err {e})")
                    n += 1
        launches = build.LAUNCHES["k3"]
        check(launches == n, f"K3 launched {launches} times for {n} cases")
        log(f"[2] K3 == plain at {label} ({topo.num_banks} banks, "
            f"{topo.num_banks // 1024} a thread) on {n} random cases (L in "
            f"{{1,2}}, S in {{1,3}}); K3 launches {launches}")
    return errs


def big_topologies():
    """(label, topology) of the lanes above 1024 banks that phase 2 runs."""
    def topo(channels, ranks, bankgroups, banks_per_group, q=16):
        from repro_torch.core.params import MemSimConfig

        return MemSimConfig(channels=channels, ranks=ranks,
                            bankgroups=bankgroups,
                            banks_per_group=banks_per_group,
                            queue_size=q).validate().topology()

    return [("2 ch x 2 ranks x 16 x 32 (two channels of 1024)",
             topo(2, 2, 16, 32)),
            ("1 ch x 2 ranks x 32 x 32 (one channel of 2048)",
             topo(1, 2, 32, 32)),
            ("2 ch x 4 ranks x 16 x 32", topo(2, 4, 16, 32)),
            ("2 ch x 4 ranks x 32 x 32", topo(2, 4, 32, 32)),
            ("8 ch x 8 ranks x 32 x 32", topo(8, 8, 32, 32)),
            ("16 ch x 8 ranks x 32 x 32", topo(16, 8, 32, 32))]


def spread_trace(topo, n, last_arrival, seed):
    """n requests at random times in [0, last_arrival) over every bank of
    ``topo`` (4 rows, 3 columns each; a third of them writes)."""
    import numpy as np
    from repro_torch.core.simulator import Trace

    rng = np.random.default_rng(seed)
    addr = ((rng.integers(0, 4, n) << topo.row_shift)
            | (rng.integers(0, 3, n) << topo.addr_low_bits)
            | rng.integers(0, topo.num_banks, n))
    return Trace.from_numpy(rng.integers(0, last_arrival, n), addr,
                            rng.integers(0, 3, n) == 0,
                            rng.integers(0, 1 << 20, n))


def k3_rollout(gen, topo, lanes, segments, cycles):
    """Run K3 for ``cycles`` cycles feeding its outputs back in (new pops
    and queue arrivals drawn at random), holding every cycle against the
    plain version on the same inputs."""
    import torch
    from repro_torch.kernels.bank_fsm.fused import (
        NUM_SCAL_OUT, fused_step_cuda, fused_step_plain)

    b = topo.num_banks
    total = lanes * b
    c = topo.channels
    ops = [x.to(DEVICE) for x in k3_operands(gen, topo, lanes, segments, 0)]
    bank_rows, resp, rp, bounds, scal = ops
    # start from reset-like registers: idle banks, empty queues
    bank_rows[0:3] = 0
    bank_rows[3] = torch.randint(200, 4000, (total,), generator=gen,
                                 dtype=torch.int32).to(DEVICE)
    bank_rows[8] = -1
    bank_rows[9] = 0
    bank_rows[11] = 0
    bank_rows[12:19] = -(1 << 20)
    scal[:, 3:6] = 0
    delta_pos = 0
    for cycle in range(cycles):
        scal[:, 0] = cycle
        scal[:, 2] = cycles * 10
        k = fused_step_cuda(topo, bank_rows, resp, rp, bounds, scal,
                            lanes=lanes)
        p = fused_step_plain(topo, bank_rows, resp, rp, bounds, scal,
                             lanes=lanes)
        e = max(max_err(x, y) for x, y in zip(k, p))
        check(e == 0, f"K3 rollout diverged from plain at cycle {cycle}")
        bank2, resp, scal2 = k
        delta_pos += int((scal2[:, 0] > 0).sum())
        arrive = (torch.randint(0, 4, (total,), generator=gen) == 0).to(DEVICE)
        qcount = bank2[14] + (arrive & (bank2[14] < 8)).to(torch.int32)
        pop = rand_pop(gen, total, topo.row_shift).to(DEVICE)
        bank_rows = torch.cat([bank2[0:10], bank2[13:14], qcount[None],
                               bank2[15:22], pop]).contiguous()
        nxt = torch.empty_like(scal)
        nxt[:, 0] = cycle + 1
        nxt[:, 1] = torch.randint(-2, 30, (lanes,), generator=gen,
                                  dtype=torch.int32).to(DEVICE)
        nxt[:, 2] = cycles * 10
        nxt[:, 3] = (torch.randint(0, 5, (lanes,), generator=gen) == 0).to(
            torch.int32).to(DEVICE)
        nxt[:, 4] = scal2[:, 2]
        nxt[:, 5] = scal2[:, 3]
        nxt[:, 6] = scal[:, 6]
        nxt[:, 7] = scal2[:, 1]
        nxt[:, 8:8 + c] = scal2[:, NUM_SCAL_OUT:NUM_SCAL_OUT + c]
        scal = nxt.contiguous()
        resp = resp.contiguous()
    return 0, delta_pos


def dvfs_schedule(cfg):
    """Three segments: Table-1 timings, slower timings with open pages
    from cycle 500, and open-page FR-FCFS with a short tREFI from 1300."""
    import torch
    from repro_torch.core.params import ParamSchedule, RuntimeParams

    base = cfg.runtime()
    pts = [base,
           base._replace(tCL=base.tCL + 4, tRCDRD=base.tRCDRD + 2,
                         page_policy=1),
           base._replace(tRP=base.tRP + 3, tCL=base.tCL + 2, tREFI=900,
                         page_policy=1, sched_policy=1)]
    return ParamSchedule(boundaries=torch.tensor([0, 500, 1300],
                                                 dtype=torch.int32),
                         values=RuntimeParams.stack(pts)).validate()


def long_schedule(cfg, segments):
    """``segments`` segments of one cycle each, cycling through the three
    points of ``dvfs_schedule``: a schedule longer than one persistent
    launch holds (862 segments at one tier), so ``fused_run_cuda`` runs it
    in slices."""
    import torch
    from repro_torch.core.params import ParamSchedule, RuntimeParams

    pts = dvfs_schedule(cfg).values
    idx = torch.arange(segments) % 3
    return ParamSchedule(
        boundaries=torch.arange(segments, dtype=torch.int32),
        values=RuntimeParams(*[v[idx] for v in pts])).validate()


def run_fused(cfg, trace, cycles, params=None, budget=None,
              cycle_skip=True):
    """The fused event-horizon loop (``cycle_skip=False``: its per-cycle
    form) on a fresh state on the card: ``fused_run_cuda`` launches until
    ``cycles``. Returns (topo, view, trace, state, steps, launches)."""
    from repro_torch.core.engine import _sched_i32
    from repro_torch.core.simulator import ScheduleView, init_state
    from repro_torch.kernels.bank_fsm.fused import fused_run_cuda

    topo = cfg.topology()
    view = ScheduleView(topo, _sched_i32(cfg.runtime() if params is None
                                         else params), DEVICE)
    tr = trace.to(DEVICE)
    state = init_state(topo, view, tr.num_requests, device=DEVICE)
    t = steps = launches = 0
    while t < cycles:
        t, n = fused_run_cuda(topo, view, tr, state, t, cycles, budget,
                              cycle_skip)
        steps += n
        launches += 1
    return topo, view, tr, state, steps, launches


def state_diff(a, b):
    """The leaves (sink slots stripped) where two states differ."""
    from repro_torch.core import interop

    x, y = interop.state_to_numpy(a), interop.state_to_numpy(b)
    return [k for k in x if x[k].shape != y[k].shape
            or (x[k] != y[k]).any()]


def first_divergence(cfg, trace, cycles, params, cycle_skip=True):
    """The first clock after which one kernel step and one plain step,
    taken in lockstep from reset, leave different states."""
    from repro_torch.core.engine import fused_run_plain
    from repro_torch.kernels.bank_fsm.fused import fused_run_cuda

    topo, view, tr, a, _, _ = run_fused(cfg, trace, 0, params)
    b = run_fused(cfg, trace, 0, params)[3]
    t = 0
    while t < cycles:
        ta, _ = fused_run_cuda(topo, view, tr, a, t, cycles, 1, cycle_skip)
        tb, _ = fused_run_plain(topo, view, tr, b, t, cycles, 1, cycle_skip)
        bad = state_diff(a, b)
        if bad or ta != tb:
            return t, bad, (ta, tb)
        t = ta
    return None


def phase_fused_run():
    """K3's persistent form against its plain loop, the whole SimState."""
    from repro_torch.core import MemSimConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.fused import fused_run_placement
    from repro_torch.core.params import RuntimeParams, tiered_params
    from repro_torch.traces import BENCHMARKS, conv2d

    q = 128
    cfg = MemSimConfig(queue_size=q)
    rings = ("bank-queue rings",)
    queues = rings + ("response ring", "request ring")
    # (label, config, trace, params, cycles, kernel budgets, what the
    # launch must keep in device memory); the plain loop runs once a case
    # (its result does not depend on the budget), its steps replayed from
    # CUDA graphs (``run_plain_lane``: the eager steps take ~11 ms each)
    cases = [(name, cfg, BENCHMARKS[name](), None, 3_000,
              (None, 7) if name == "conv2d" else (None,), ())
             for name in sorted(BENCHMARKS)]
    cases += [
        ("conv2d dvfs+frfcfs", cfg, conv2d(), dvfs_schedule(cfg), 3_000,
         (None,), ()),
        ("conv2d two-tier (64 banks)",
         MemSimConfig(queue_size=q, channels=2, tiers=2, cxl_channels=1),
         conv2d(), tiered_params(RuntimeParams(), RuntimeParams(
             tRCDRD=30, tCL=24, tRFC=300, tREFI=5000)), 3_000, (None,), ()),
        ("conv2d 512 banks (rings of 1 MiB in device memory)",
         MemSimConfig(queue_size=q, channels=16), conv2d(), None, 1_500,
         (None,), rings),
        ("conv2d at queue 8192 / respQueue 8192",
         MemSimConfig(queue_size=8192, resp_queue_size=8192), conv2d(),
         None, 1_000, (None,), queues[:2]),
        ("conv2d at queue 16384 / respQueue 16384",
         MemSimConfig(queue_size=16384, resp_queue_size=16384), conv2d(),
         None, 1_000, (None,), queues),
        # one segment a cycle: a launch holds 862 of them, so the run is
        # three launches over slices of the schedule
        ("conv2d on a schedule of 4096 segments", cfg, conv2d(),
         long_schedule(cfg, 4096), 2_000, (None,), ()),
    ]
    for label, topo in big_topologies():
        big = MemSimConfig(channels=topo.channels, ranks=topo.ranks,
                           bankgroups=topo.bankgroups,
                           banks_per_group=topo.banks_per_group,
                           queue_size=topo.queue_size)
        # a lane's heads and counts (2 B ints) leave shared memory above
        # ~28 000 banks, the request and response rings before them
        placed = (queues + ("bank-queue heads and counts",)
                  if topo.num_banks > 28_000 else rings)
        cases.append((f"{label}, {topo.num_banks} banks", big,
                      spread_trace(topo, 300, 280, topo.num_banks), None,
                      400, (None, 7), placed))
    for label, cfg, trace, params, cycles, budgets, placed in cases:
        t0 = time.perf_counter()
        p_state, p_steps = run_plain_lane(
            run_fused(cfg, trace, 0, params)[:4], cycles, True)
        t_p = time.perf_counter() - t0
        keep_plain(label, True, cycles, p_state, p_steps)
        topo, view, tr, state, _, _ = run_fused(cfg, trace, 0, params)
        where = fused_run_placement(topo, view, tr, state)
        check(where == placed, f"{label}: the launch keeps {where} in "
              f"device memory, built to keep {placed}")
        for budget in budgets:
            t0 = time.perf_counter()
            build.reset_launches()
            *_, k_state, k_steps, k_launches = run_fused(cfg, trace, cycles,
                                                         params, budget)
            t_k = time.perf_counter() - t0
            check(build.LAUNCHES["k3run"] == k_launches > 0,
                  f"{label}: {build.LAUNCHES['k3run']} K3 launches counted "
                  f"for {k_launches}")
            bad = state_diff(k_state, p_state)
            if bad or k_steps != p_steps:
                first = first_divergence(cfg, trace, cycles, params)
                check(False, f"fused_run (budget {budget}) != "
                      f"fused_run_plain on {label}@{cycles}: leaves {bad}, "
                      f"steps {k_steps} vs {p_steps}; first divergence "
                      f"(clock, leaves, next clocks) {first}")
            if budget is not None:
                check(k_launches == -(-k_steps // budget),
                      f"{label}: {k_launches} launches for {k_steps} steps")
            elif "segments" in label:
                check(k_launches > 1, f"{label}: one launch, the schedule "
                      f"was not cut into slices")
            log(f"[2] fused_run (budget {budget or 'default'}) == "
                f"fused_run_plain on {label}@{cycles}: whole SimState bit "
                f"for bit, {k_steps} steps in {k_launches} K3 launch(es) "
                f"({t_k:.2f} s; plain {t_p:.1f} s); in device memory: "
                f"{', '.join(where) or 'nothing'}")
    return 0


def _plain_cycle(topo, view, tr, seg, state, cycle):
    """One step of the per-cycle form's plain version (the step of
    ``fused_run_plain(cycle_skip=False)``) at a 0-d device ``cycle``."""
    from repro_torch.core.fused_step import fused_cycle_step
    from repro_torch.kernels.bank_fsm.fused import fused_step_plain

    new, _ = fused_cycle_step(topo, view, tr, state, cycle, cycle + 1, seg,
                              kernel=fused_step_plain)
    return new, None


def run_cycle_plain(cfg, trace, cycles, params=None):
    """The per-cycle form's plain version on a fresh state on the card,
    until ``cycles``: its step replayed from one CUDA graph per schedule
    segment (``core.graphs``, the same ops as the eager
    ``fused_run_plain(cycle_skip=False)``, whose eager steps take ~8 ms
    each), or eagerly on a schedule of more than 8 segments. Returns the
    state."""
    import functools

    from repro_torch.core.engine import fused_run_plain
    from repro_torch.core.graphs import StepGraphs

    topo, view, tr, state, _, _ = run_fused(cfg, trace, 0, params)
    if view.num_segments > 8:
        fused_run_plain(topo, view, tr, state, 0, cycles, cycle_skip=False)
        return state
    graphs = StepGraphs(state)
    for t in range(cycles):
        seg = view.segment_at(t)
        graphs.step(seg, t, functools.partial(_plain_cycle, topo, view, tr,
                                              seg))
    return graphs.state


def phase_cycle_run():
    """K3's per-cycle form (``fused_run(..., cycle_skip=False)``, what
    ``simulate`` runs) against its plain version, the whole SimState."""
    import torch
    from repro_torch.core import MemSimConfig
    from repro_torch.kernels import build
    from repro_torch.core.params import RuntimeParams, tiered_params
    from repro_torch.traces import BENCHMARKS, conv2d

    q = 128
    cfg = MemSimConfig(queue_size=q)
    # (label, config, trace, params, cycles, kernel budgets)
    cases = [(name, cfg, BENCHMARKS[name](), None, 3_000,
              (None, 7, 1) if name == "conv2d" else (None,))
             for name in sorted(BENCHMARKS)]
    label, topo = big_topologies()[0]
    big = MemSimConfig(channels=topo.channels, ranks=topo.ranks,
                       bankgroups=topo.bankgroups,
                       banks_per_group=topo.banks_per_group,
                       queue_size=topo.queue_size)
    cases += [
        ("conv2d dvfs+frfcfs", cfg, conv2d(), dvfs_schedule(cfg), 3_000,
         (None,)),
        ("conv2d two-tier (64 banks)",
         MemSimConfig(queue_size=q, channels=2, tiers=2, cxl_channels=1),
         conv2d(), tiered_params(RuntimeParams(), RuntimeParams(
             tRCDRD=30, tCL=24, tRFC=300, tREFI=5000)), 3_000, (None,)),
        ("conv2d 512 banks", MemSimConfig(queue_size=q, channels=16),
         conv2d(), None, 1_500, (None,)),
        (f"{label}, {topo.num_banks} banks (k = 2)", big,
         spread_trace(topo, 300, 280, topo.num_banks), None, 400, (None, 7)),
        ("conv2d at queue 16384 / respQueue 16384",
         MemSimConfig(queue_size=16384, resp_queue_size=16384), conv2d(),
         None, 1_000, (None,)),
        # a launch holds 862 one-cycle segments: two launches
        ("conv2d on a schedule of 4096 segments", cfg, conv2d(),
         long_schedule(cfg, 4096), 1_000, (None,)),
    ]
    for label, cfg, trace, params, cycles, budgets in cases:
        t0 = time.perf_counter()
        p_state = run_cycle_plain(cfg, trace, cycles, params)
        torch.cuda.synchronize()  # graph replays return before they run
        t_p = time.perf_counter() - t0
        keep_plain(label, False, cycles, p_state, cycles)
        for budget in budgets:
            t0 = time.perf_counter()
            build.reset_launches()
            *_, k_state, k_steps, k_launches = run_fused(
                cfg, trace, cycles, params, budget, cycle_skip=False)
            t_k = time.perf_counter() - t0
            check(build.LAUNCHES["k3cyc"] == k_launches > 0
                  and build.LAUNCHES["k3run"] == 0,
                  f"{label}: per-cycle launches counted {build.LAUNCHES} "
                  f"for {k_launches}")
            bad = state_diff(k_state, p_state)
            if bad or k_steps != cycles:
                first = first_divergence(cfg, trace, cycles, params, False)
                check(False, f"per-cycle fused_run (budget {budget}) != its "
                      f"plain version on {label}@{cycles}: leaves {bad}, "
                      f"steps {k_steps}; first divergence (clock, leaves, "
                      f"next clocks) {first}")
            if budget is not None:
                check(k_launches == -(-cycles // budget),
                      f"{label}: {k_launches} launches for {cycles} cycles")
            elif "segments" in label:
                check(k_launches > 1, f"{label}: one launch, the schedule "
                      f"was not cut into slices")
            else:
                check(k_launches == 1, f"{label}: {k_launches} launches")
            log(f"[2] per-cycle fused_run (budget {budget or 'default'}) == "
                f"its plain version on {label}@{cycles}: whole SimState bit "
                f"for bit, {k_steps} steps in {k_launches} launch(es) "
                f"({t_k:.2f} s; plain {t_p:.1f} s)")
    return 0


def phase_main_path():
    import numpy as np
    from repro_torch import golden
    from repro_torch.core import MemSimConfig, simulate_fast, simulate_ideal
    from repro_torch.core.stats import cycle_diffs, format_table2
    from repro_torch.kernels import build
    from repro_torch.traces import BENCHMARKS

    expected = golden.load()
    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    rows, total_steps, total_wall, total_run = [], 0, 0.0, 0.0
    loop_launches = 0
    build.reset_launches()
    for name in sorted(BENCHMARKS):
        trace = BENCHMARKS[name]()
        tm = {}
        t0 = time.perf_counter()
        res = simulate_fast(cfg, trace, 100_000, timings=tm, device=DEVICE)
        wall = time.perf_counter() - t0
        ideal = simulate_ideal(cfg, trace,
                               device=DEVICE).t_complete.cpu().numpy()
        got = golden.result_digest(res, ideal, tm["steps"])
        bad = golden.mismatches(expected[golden.case_key(name, 100_000)],
                                got)
        check(not bad, f"{name}@100000 differs from the JAX golden digest "
              f"in {bad}")
        rows.append((name, cycle_diffs(res, np.asarray(ideal))))
        total_steps += tm["steps"]
        total_wall += wall
        total_run += tm["run_s"]
        loop_launches += tm["launches"]
        log(f"[3] {name}: {trace.num_requests} requests, 100000 cycles, "
            f"{tm['steps']} executed steps in {tm['launches']} persistent "
            f"K3 launch(es), {wall:.3f} s wall (run {tm['run_s']:.3f} s), "
            f"{tm['steps'] / tm['run_s']:.0f} steps/s, matches golden "
            f"digest")
    launches = dict(build.LAUNCHES)
    check(launches["k3run"] > 0,
          "the persistent K3 was never launched on the main path")
    check(launches["k3run"] == loop_launches,
          f"persistent K3 launches {launches['k3run']} != the host loop's "
          f"launches {loop_launches}")
    check(launches["k3"] == 0 and launches["k3cyc"] == 0
          and launches["k1"] == 0 and launches["k2"] == 0,
          f"the fused path launched per-step kernels: {launches}")
    log(f"[3] persistent K3 launches {launches['k3run']} = host loop "
        f"launches (one host read each); per-step K3, K1, K2 launches 0; "
        f"{total_steps} executed steps, four traces in {total_wall:.3f} s "
        f"wall, {total_run:.3f} s run, {total_steps / total_run:.0f} "
        f"steps/s")
    log("[3] Table 2 (MemorySim - ideal, cycles):\n" + format_table2(rows))
    return launches["k3run"]


def simulate_fused(cfg, trace, cycles):
    """``simulate`` on the fused backend on the card, with the graphs it
    captures counted (it must capture none). Returns (result, wall s,
    graphs captured)."""
    from repro_torch.core import graphs, simulate

    captured = []
    capture = graphs.StepGraphs._capture

    def counted(self, fn):
        captured.append(fn)
        return capture(self, fn)

    graphs.StepGraphs._capture = counted
    try:
        t0 = time.perf_counter()
        res = simulate(cfg, trace, cycles, device=DEVICE)
        wall = time.perf_counter() - t0
    finally:
        graphs.StepGraphs._capture = capture
    return res, wall, len(captured)


def phase_per_cycle():
    import torch
    from repro_torch import golden
    from repro_torch.core import (
        MemSimConfig, simulate, simulate_fast, simulate_ideal)
    from repro_torch.core.simulator import Trace
    from repro_torch.kernels import build
    from repro_torch.traces import BENCHMARKS, conv2d

    digests = golden.load()
    expected = digests[golden.case_key("conv2d", 20_000)]
    trace = conv2d()
    q = golden.QUEUE_SIZE
    cfg = MemSimConfig(queue_size=q)
    ideal = simulate_ideal(cfg, trace, device=DEVICE).t_complete.cpu().numpy()
    no_steps = {k: v for k, v in expected.items() if k != "steps"}
    # the main path: simulate (fused) in K3's per-cycle persistent form
    build.reset_launches()
    fused, t_fused, graphs = simulate_fused(cfg, trace, 20_000)
    bad = golden.mismatches(no_steps, golden.result_digest(fused, ideal))
    check(not bad, f"simulate(fused) conv2d@20000 differs from golden in "
          f"{bad}")
    launches = dict(build.LAUNCHES)
    check(launches["k3"] == 0 and launches["k3cyc"] == 1
          and launches["k3run"] == 0 and graphs == 0,
          f"simulate(fused) conv2d@20000: launches {launches}, {graphs} "
          f"graphs captured; built for one per-cycle launch, no per-step "
          f"K3 and no graph")
    log(f"[4] simulate fused conv2d@20000: {t_fused:.3f} s wall, one "
        f"per-cycle K3 launch, per-step K3 0, no graph; matches the golden "
        f"digest")
    for name in sorted(BENCHMARKS):
        tr = BENCHMARKS[name]()
        res, wall, graphs = simulate_fused(cfg, tr, 100_000)
        ideal_n = simulate_ideal(cfg, tr, device=DEVICE).t_complete.cpu(
            ).numpy()
        want = {k: v for k, v in
                digests[golden.case_key(name, 100_000)].items()
                if k != "steps"}
        bad = golden.mismatches(want, golden.result_digest(res, ideal_n))
        check(not bad and graphs == 0,
              f"simulate(fused) {name}@100000 differs from golden in {bad} "
              f"({graphs} graphs captured)")
        log(f"[4] simulate fused {name}@100000: {wall:.3f} s wall, matches "
            f"the golden digest (all fields but steps)")
    main = dict(build.LAUNCHES)
    check(main["k3cyc"] == 1 + len(BENCHMARKS) and main["k3"] == 0
          and main["k3run"] == 0,
          f"simulate(fused) launches on the five runs: {main}")
    empty = Trace(*[torch.zeros((0,), dtype=torch.int32) for _ in range(4)])
    try:
        simulate(cfg, empty, 100, device=DEVICE)
        raised = False
    except IndexError:
        raised = True
    check(raised, "simulate(fused) on a trace with no request did not "
          "raise IndexError, as the reference does")
    build.reset_launches()
    t0 = time.perf_counter()
    split = simulate(MemSimConfig(queue_size=q, fsm_backend="split"),
                     trace, 20_000, device=DEVICE)
    t_split = time.perf_counter() - t0
    got = golden.result_digest(split, ideal)
    bad = golden.mismatches(no_steps, got)
    check(not bad, f"simulate(split) conv2d@20000 differs from golden in "
          f"{bad}")
    tm = {}
    t0 = time.perf_counter()
    fast = simulate_fast(MemSimConfig(queue_size=q, fsm_backend="split"),
                         trace, 20_000, timings=tm, device=DEVICE)
    t_fast = time.perf_counter() - t0
    bad = golden.mismatches(expected,
                            golden.result_digest(fast, ideal, tm["steps"]))
    check(not bad, f"simulate_fast(split) conv2d@20000 differs from golden "
          f"in {bad}")
    launches = dict(build.LAUNCHES)
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"split path did not launch K1 and K2: {launches}")
    check(launches["k3"] == 0 and launches["k3cyc"] == 0,
          f"split path launched K3: {launches}")
    t0 = time.perf_counter()
    plain = simulate(MemSimConfig(queue_size=q, fsm_backend="plain"),
                     trace, 20_000, device=DEVICE)
    t_plain = time.perf_counter() - t0
    check(golden.result_digest(plain, ideal) == got,
          "simulate(plain) on the card != simulate(split)")
    log(f"[4] conv2d@20000: simulate fused {t_fused:.3f} s (per-cycle K3 "
        f"launches {main['k3cyc']} over five runs, per-step K3 "
        f"{main['k3']}), simulate split {t_split:.1f} s, simulate plain "
        f"{t_plain:.1f} s (bit-identical), simulate_fast split {t_fast:.1f} "
        f"s ({tm['steps']} steps); all match the golden digest; "
        f"K1 launches {launches['k1']}, K2 launches {launches['k2']}")
    launches["k3"] = main["k3"]
    launches["k3cyc"] = main["k3cyc"]
    return launches


def median_ms(fn, n=200, warm=20):
    """Median wall time of one call on the card, host launch included:
    CUDA events around each of ``n`` calls after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def device_ms(fn, per_graph=20, replays=10):
    """Device time of one call: ``per_graph`` calls captured in a CUDA
    graph, each replay timed with CUDA events, the median replay divided
    by ``per_graph`` (``per_graph * replays`` >= 200 calls). Host launch
    cost is excluded; a graph is how the simulator's loop replays them.
    Launch counters are restored: timing launches are not main-path
    launches."""
    import torch
    from repro_torch.kernels import build

    counted = dict(build.LAUNCHES)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    times = []
    for _ in range(replays + 2):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / per_graph)
    build.LAUNCHES.update(counted)
    return statistics.median(times[2:])


def phase_times():
    import torch
    from repro_torch.core import MemSimConfig
    from repro_torch.core.params import ParamSchedule
    from repro_torch.kernels.bank_fsm.bank_fsm import (
        bank_event_bound_cuda, bank_fsm_step_cuda)
    from repro_torch.kernels.bank_fsm.fused import (
        NUM_BANK_ROWS_IN, NUM_BANK_ROWS_OUT, NUM_SCAL_IN, NUM_SCAL_OUT,
        fused_step_cuda, fused_step_plain)
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.ref import (
        bank_event_bound_plain, bank_fsm_step_plain)

    gen = torch.Generator().manual_seed(7)
    cfg = MemSimConfig(queue_size=128)
    topo = cfg.topology()
    b, qr, c = topo.num_banks, topo.resp_queue_size, topo.channels
    bounds, rp = (x.to(DEVICE) for x in ParamSchedule.constant(
        cfg.runtime()).pack())
    state = rand_state(gen, b, topo.row_shift).to(DEVICE)
    inputs = rand_int(gen, 0, 2, (3, b)).to(DEVICE)
    pop = rand_pop(gen, b, topo.row_shift).to(DEVICE)
    cyc = torch.full((1, 1), 1234, dtype=torch.int32, device=DEVICE)
    ops = [x.to(DEVICE) for x in k3_operands(gen, topo, 1, 1, 1234)]
    ops[2], ops[3] = rp, bounds

    rp_bytes = rp.numel() * 4 + bounds.numel() * 4
    work = {
        "k1": (lambda: bank_fsm_step_cuda(topo, state, inputs, pop, rp,
                                          bounds, cyc),
               lambda: bank_fsm_step_plain(topo, state, inputs, pop, rp,
                                           bounds, cyc),
               (10 + 3 + 4) * b * 4 + rp_bytes + 4 + (10 + 3) * b * 4),
        "k2": (lambda: bank_event_bound_cuda(state, rp, bounds, cyc),
               lambda: bank_event_bound_plain(state, rp, bounds, cyc),
               4 * b * 4 + rp_bytes + 4 + b * 4),
        "k3": (lambda: fused_step_cuda(topo, *ops),
               lambda: fused_step_plain(topo, *ops),
               (NUM_BANK_ROWS_IN + NUM_BANK_ROWS_OUT) * b * 4
               + 2 * qr * 4 * 4 + rp_bytes
               + (NUM_SCAL_IN + c + NUM_SCAL_OUT + 2 * c) * 4),
    }
    out = {}
    counted = dict(build.LAUNCHES)
    for k, (kern, plain, nbytes) in work.items():
        ms = device_ms(kern)
        plain_ms = device_ms(plain)
        call_ms = median_ms(kern)
        plain_call_ms = median_ms(plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[k] = (ms, plain_ms, bound_ms, nbytes)
        log(f"[5] {k}: device {ms * 1e3:.2f} us/launch (plain version "
            f"{plain_ms * 1e3:.2f} us); eager call incl. host launch "
            f"{call_ms * 1e3:.2f} us (plain {plain_call_ms * 1e3:.2f} us); "
            f"bound {bound_ms * 1e6:.2f} ns ({nbytes} B at 3.35 TB/s); "
            f"main-path shape B={b} S=1 T=1")
    # the floor of a graph node: the same timing of the least kernel
    one = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
    floor_ms = device_ms(lambda: one.add_(1))
    out["floor"] = floor_ms
    log(f"[5] launch floor: a one-element int32 add_ {floor_ms * 1e3:.2f} "
        f"us/launch (20 in a graph, median replay / 20), beside k1 "
        f"{out['k1'][0] * 1e3:.2f}, k2 {out['k2'][0] * 1e3:.2f}, per-step "
        f"k3 {out['k3'][0] * 1e3:.2f} us")
    build.LAUNCHES.update(counted)
    return out


def run_bytes(view, trace, state):
    """Bytes one persistent K3 launch from reset must move, counted from
    its final state: the resident state (registers, timing, queues and
    their rings, arbiter pointers, counters) loaded and stored once, the
    parameters and each admitted trace entry read once, each record word
    written once where it was set, and one ``mem`` word per completed
    write, a ``mem`` read and an ``rdata`` write per completed read."""
    from repro_torch.core.graphs import _leaves

    records = (state.t_admit, state.t_dispatch, state.t_start,
               state.t_complete)
    n = trace.num_requests
    in_place = {id(x) for x in (state.mem, state.rdata, *records)}
    resident = sum(x.numel() for x in _leaves(state)
                   if id(x) not in in_place)
    admitted = int(state.next_arrival)
    stamped = sum(int((r[:n] >= 0).sum()) for r in records)
    done = state.t_complete[:n] >= 0
    writes = int((done & (trace.is_write[:n] != 0)).sum())
    reads = int(done.sum()) - writes
    words = (2 * resident + sum(x.numel() for x in view.packed)
             + 4 * admitted + stamped + writes + 2 * reads)
    return words * 4


def phase_run_times():
    """The persistent K3 on each trace at 100k cycles: device time of its
    one launch (CUDA events) per executed step, beside the plain loop's
    wall time per step (300 steps of conv2d) and the byte bound of what
    the launch must move (``run_bytes``); then the same for its per-cycle
    form, per cycle. Returns ({trace: skipping times}, skipping plain ms,
    {trace: per-cycle times}, per-cycle plain ms)."""
    import torch
    from repro_torch.core import MemSimConfig
    from repro_torch.kernels import build
    from repro_torch.core.engine import fused_run_plain
    from repro_torch.kernels.bank_fsm.fused import fused_run_cuda
    from repro_torch.traces import BENCHMARKS

    cfg = MemSimConfig(queue_size=128)
    counted = dict(build.LAUNCHES)
    out = {}
    for name in sorted(BENCHMARKS):
        topo, view, tr, state, _, _ = run_fused(cfg, BENCHMARKS[name](), 0)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        t, steps = fused_run_cuda(topo, view, tr, state, 0, 100_000)
        e.record()
        torch.cuda.synchronize()
        check(t == 100_000, f"{name}: one launch stopped at {t}")
        ms = s.elapsed_time(e)
        nbytes = run_bytes(view, tr, state)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (ms / steps, steps, ms, bound_ms / steps, nbytes)
        log(f"[5] k3run {name}@100000: one launch {ms:.3f} ms for {steps} "
            f"executed steps = {ms / steps * 1e3:.3f} us/step "
            f"({steps / ms * 1e3:.0f} steps/s of device time); bound "
            f"{bound_ms * 1e3:.3f} us per launch ({nbytes} B at 3.35 TB/s) "
            f"= {bound_ms / steps * 1e6:.3f} ns/step")
    topo, view, tr, state, _, _ = run_fused(cfg, BENCHMARKS["conv2d"](), 0)
    fused_run_plain(topo, view, tr, state, 0, 100_000, 20)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, n = fused_run_plain(topo, view, tr, state, 20, 100_000, 300)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / n * 1e3
    log(f"[5] k3run plain loop (fused_run_plain, eager on the card): "
        f"{plain_ms * 1e3:.1f} us wall per executed step (conv2d, {n} "
        f"steps)")
    cyc = {}
    for name in sorted(BENCHMARKS):
        topo, view, tr, state, _, _ = run_fused(cfg, BENCHMARKS[name](), 0)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        t, steps = fused_run_cuda(topo, view, tr, state, 0, 100_000,
                                  cycle_skip=False)
        e.record()
        torch.cuda.synchronize()
        check(t == steps == 100_000,
              f"{name}: one per-cycle launch stopped at {t} ({steps} steps)")
        ms = s.elapsed_time(e)
        nbytes = run_bytes(view, tr, state)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        cyc[name] = (ms / steps, steps, ms, bound_ms / steps, nbytes)
        log(f"[5] k3cyc {name}@100000: one per-cycle launch {ms:.3f} ms = "
            f"{ms / steps * 1e3:.3f} us/cycle; bound {bound_ms * 1e3:.3f} us "
            f"per launch ({nbytes} B at 3.35 TB/s) = "
            f"{bound_ms / steps * 1e6:.3f} ns/cycle")
    topo, view, tr, state, _, _ = run_fused(cfg, BENCHMARKS["conv2d"](), 0)
    fused_run_plain(topo, view, tr, state, 0, 100_000, 20, False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, n = fused_run_plain(topo, view, tr, state, 20, 100_000, 300, False)
    torch.cuda.synchronize()
    cyc_plain_ms = (time.perf_counter() - t0) / n * 1e3
    log(f"[5] k3cyc plain loop (fused_run_plain(cycle_skip=False), eager on "
        f"the card): {cyc_plain_ms * 1e3:.1f} us wall per cycle (conv2d, "
        f"{n} cycles)")
    build.LAUNCHES.update(counted)
    return out, plain_ms, cyc, cyc_plain_ms


def device_rows(prof):
    """The rows of a profile's ``key_averages()`` that ran on the device
    (kernels, copies, fills). The rows of CPU operators carry the device
    time of the kernels they launched as well, so summing every row with
    device time would count those kernels twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and getattr(e, "self_device_time_total", 0) > 0]


def phase_trace():
    """Where a main-path step's time goes: a device trace of conv2d over
    5000 cycles (kernels and device time per executed step, device busy
    share), and the host synchronisations against the launches."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import MemSimConfig, simulate_fast
    from repro_torch.traces import conv2d

    cfg = MemSimConfig(queue_size=128)
    trace = conv2d()
    tm = {}
    simulate_fast(cfg, trace, 5_000, timings=tm, device=DEVICE)
    t0 = time.perf_counter()
    simulate_fast(cfg, trace, 5_000, timings=tm, device=DEVICE)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        simulate_fast(cfg, trace, 5_000, device=DEVICE)
    dev = device_rows(prof)
    steps = tm["steps"]
    if dev:
        kernels = sum(e.count for e in dev)
        dev_us = sum(e.self_device_time_total for e in dev)
        log(f"[6] conv2d@5000 ({steps} executed steps): {wall:.4f} s wall "
            f"untraced = {wall / steps * 1e6:.2f} us/step; traced: "
            f"{kernels} device kernels = {kernels / steps:.4f}/step, "
            f"{dev_us / steps:.3f} us device time/step, device busy "
            f"{dev_us * 1e-6 / wall:.1%} of the untraced wall time")
    else:
        log("[6] device trace: no device events recorded (not measured)")
    torch.cuda.set_sync_debug_mode(1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            simulate_fast(cfg, trace, 5_000, timings=tm, device=DEVICE)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    check(syncs <= tm["launches"] + 64, f"{syncs} host synchronisations "
          f"for {tm['launches']} persistent launches")
    log(f"[6] host synchronisations: {syncs} for {steps} executed steps in "
        f"{tm['launches']} persistent K3 launch(es) (one read of (t, "
        f"steps) a launch; the rest are set-up and the result copy)")


# ------------------------------------------------ lane-batched simulator --

#: phase 2's plain final states and steps, kept where phase 13 runs a lane
#: of the same inputs: (phase 2 label, cycle_skip, cycles) -> (SimState,
#: steps)
PLAIN_STATES = {}
#: the phase 2 labels phase 13 reuses
PLAIN_KEPT = ("conv2d", "multihead_attention", "trace_example",
              "vector_similarity", "conv2d dvfs+frfcfs",
              "conv2d two-tier (64 banks)")


#: the horizon of phase 13's timed batches: the paper's
BATCH_CYCLES = 100_000


def keep_plain(label, cycle_skip, cycles, state, steps):
    if label in PLAIN_KEPT or "2048 banks" in label:
        PLAIN_STATES[(label, cycle_skip, cycles)] = (state, steps)


def lane_inputs(spec, shared):
    """(topology, view, trace on the card, fresh state) of a lane spec; the
    view and trace of equal specs (``spec["key"]``) are shared."""
    from repro_torch.core.engine import _sched_i32
    from repro_torch.core.simulator import ScheduleView, init_state

    cfg = spec["cfg"]
    topo = cfg.topology()
    if spec["key"] not in shared:
        sched = _sched_i32(cfg.runtime() if spec.get("params") is None
                           else spec["params"])
        if spec.get("pad_to"):
            sched = sched.pad_to(spec["pad_to"])
        shared[spec["key"]] = (ScheduleView(topo, sched, DEVICE),
                               spec["trace"].to(DEVICE))
    view, tr = shared[spec["key"]]
    state = init_state(topo, view, tr.num_requests, spec.get("q"),
                       spec.get("r"), device=DEVICE)
    return topo, view, tr, state


def _plain_skip_step(topo, view, tr, horizon, seg, seg_next, state, cycle):
    """One step of ``fused_run_plain`` (the fused step's plain version and
    the skip) at a 0-d device ``cycle`` whose successor lies in the same
    segment."""
    from repro_torch.core.engine import _apply_skip
    from repro_torch.core.fused_step import fused_cycle_step
    from repro_torch.kernels.bank_fsm.fused import fused_step_plain

    new, delta = fused_cycle_step(topo, view, tr, state, cycle, horizon, seg,
                                  kernel=fused_step_plain)
    return _apply_skip(topo, view, new, delta, seg_next), delta


def run_plain_lane(lane, cycles, cycle_skip):
    """A lane's run to ``cycles`` in the plain version of either form (the
    steps of ``fused_run_plain``), each step replayed from a CUDA graph of
    it (one a schedule segment; a step whose successor lies in the next
    segment runs eagerly), as the split engine replays its steps. Returns
    (final state, steps)."""
    import functools

    import torch
    from repro_torch.core.graphs import StepGraphs

    topo, view, tr, state = lane
    graphs = StepGraphs(state)
    t = steps = 0
    while t < cycles:
        seg = view.segment_at(t)
        if not cycle_skip:
            graphs.step(seg, t, functools.partial(_plain_cycle, topo, view,
                                                  tr, seg))
            t += 1
        else:
            seg_next = view.segment_at(t + 1)
            fn = functools.partial(_plain_skip_step, topo, view, tr, cycles,
                                   seg, seg_next)
            if seg == seg_next:
                t += 1 + int(graphs.step(seg, t, fn))
                graphs.advanced_to(t)
            else:
                new, delta = fn(graphs.state, t)
                graphs.adopt(new)
                t += 1 + int(delta)
        steps += 1
    torch.cuda.synchronize()
    return graphs.state, steps


_PLAIN_LANES = {}


def plain_lane(spec, cycles, cycle_skip):
    """(numpy state, steps) of a lane spec's plain run, reused from phase
    2 or computed once per spec key."""
    from repro_torch.core import interop

    reuse = spec.get("reuse", {}).get(cycle_skip)
    if (reuse, cycle_skip, cycles) in PLAIN_STATES:
        state, steps = PLAIN_STATES[(reuse, cycle_skip, cycles)]
        return interop.state_to_numpy(state), steps
    key = (spec["key"], cycle_skip, cycles)
    if key not in _PLAIN_LANES:
        state, steps = run_plain_lane(lane_inputs(spec, {}), cycles,
                                      cycle_skip)
        _PLAIN_LANES[key] = (interop.state_to_numpy(state), steps)
    return _PLAIN_LANES[key]


def batch_run(specs, cycles, cycle_skip=True, budget=None):
    """The lane-batched K3 on fresh lanes of ``specs``. Returns (lanes,
    steps of each, launches)."""
    from repro_torch.kernels.bank_fsm.fused import fused_run_batch_cuda

    shared = {}
    lanes = [lane_inputs(s, shared) for s in specs]
    _, steps, launches = fused_run_batch_cuda(
        lanes[0][0], [x[1] for x in lanes], [x[2] for x in lanes],
        [x[3] for x in lanes], cycles, budget, cycle_skip)
    return lanes, steps, launches


def batch_first_divergence(spec, cycles, cycle_skip):
    """The first clock after which one step of the lane alone in the
    lane-batched K3 and one plain step, in lockstep from reset, leave
    different states."""
    from repro_torch.core import interop
    from repro_torch.core.engine import fused_run_plain
    from repro_torch.kernels.bank_fsm.fused import fused_run_batch_cuda

    topo, view, tr, a = lane_inputs(spec, {})
    b = lane_inputs(spec, {})[3]
    t = 0
    while t < cycles:
        (ta,), _, _ = fused_run_batch_cuda(topo, [view], [tr], [a], cycles,
                                           1, cycle_skip, t=[t],
                                           max_launches=1)
        tb, _ = fused_run_plain(topo, view, tr, b, t, cycles, 1, cycle_skip)
        x, y = interop.state_to_numpy(a), interop.state_to_numpy(b)
        bad = [k for k in x if (x[k] != y[k]).any()]
        if bad or ta != tb:
            return t, bad, (ta, tb)
        t = tb
    return None


def batch_cases(per_sm, sms):
    """(label, lane specs, cycles, budgets, what a launch keeps in device
    memory) of phase 13's checks against the plain version."""
    from repro_torch.core import MemSimConfig
    from repro_torch.core.params import RuntimeParams, tiered_params
    from repro_torch.traces import BENCHMARKS, conv2d, trace_example

    cfg = MemSimConfig(queue_size=128)
    four = [{"cfg": cfg, "trace": BENCHMARKS[n](), "key": n,
             "reuse": {True: n, False: n}} for n in sorted(BENCHMARKS)]
    big = MemSimConfig(queue_size=2048)
    over = conv2d(burst_gap=18)
    sweep = [{"cfg": big, "trace": over, "q": q, "key": f"sweep q{q}"}
             for q in (2, 16, 128, 512, 2048)]
    dvfs = "conv2d dvfs+frfcfs"
    mixed = [{"cfg": cfg, "trace": conv2d(), "pad_to": 3, "key": "const/3"},
             {"cfg": cfg, "trace": conv2d(), "params": dvfs_schedule(cfg),
              "key": "dvfs", "reuse": {True: dvfs, False: dvfs}},
             {"cfg": cfg, "trace": conv2d(), "pad_to": 3, "key": "open/3",
              "params": RuntimeParams(page_policy=1, sched_policy=1)}]
    tiered = MemSimConfig(queue_size=128, channels=2, tiers=2,
                          cxl_channels=1)
    slow = RuntimeParams(tRCDRD=30, tCL=24, tRFC=300, tREFI=5000)
    two = "conv2d two-tier (64 banks)"
    tiers = [{"cfg": tiered, "trace": conv2d(), "key": "tiers",
              "params": tiered_params(RuntimeParams(), slow),
              "reuse": {True: two, False: two}},
             {"cfg": tiered, "trace": conv2d(), "key": "tiers tCL 18",
              "params": tiered_params(RuntimeParams(tCL=18), slow)}]
    label, topo = big_topologies()[0]
    wide = MemSimConfig(channels=topo.channels, ranks=topo.ranks,
                        bankgroups=topo.bankgroups,
                        banks_per_group=topo.banks_per_group,
                        queue_size=topo.queue_size)
    spread = spread_trace(topo, 300, 280, topo.num_banks)
    k2 = [{"cfg": wide, "trace": spread, "key": "2048",
           "reuse": {True: f"{label}, {topo.num_banks} banks",
                     False: f"{label}, {topo.num_banks} banks (k = 2)"}},
          {"cfg": wide, "trace": spread, "q": 4, "key": "2048 q4"}]
    # more lanes than the card holds at once: eight distinct lanes, each
    # repeated, so the CTAs run in waves
    n_lanes = max(4 * sms, (per_sm + 1) * sms)
    short = trace_example(n=150, gap=4)
    distinct = [{"cfg": cfg, "trace": short, "q": q, "key": f"w{q}/{p}",
                 "params": RuntimeParams(page_policy=p)}
                for q in (8, 32, 64, 128) for p in (0, 1)]
    waves = [distinct[i % len(distinct)] for i in range(n_lanes)]
    return [
        ("the four traces (ragged: 4000 to 10528 requests)", four, 3_000,
         (None, 7), ()),
        ("a queue sweep at capacity 2048 (conv2d, burst gap 18)", sweep, 600,
         (None,), ("bank-queue rings",)),
        ("mixed constant and DVFS lanes (padded to 3 segments)", mixed,
         3_000, (None,), ()),
        ("two-tier lanes (64 banks)", tiers, 3_000, (None,), ()),
        ("two lanes of 2048 banks (k = 2)", k2, 400, (None, 7),
         ("bank-queue rings",)),
        (f"{n_lanes} lanes, {len(distinct)} distinct (waves)", waves, 1_000,
         (None,), ()),
    ]


def batch_lanes(cfg, traces, qs, scheds):
    """The lanes ``simulate_batch`` builds (padded traces, shared views,
    fresh states on the card), for timing its launch alone."""
    from repro_torch.core.engine import _lane_views, _pad_trace
    from repro_torch.core.simulator import init_state

    topo = cfg.topology()
    n_max = max(t.num_requests for t in traces)
    on_dev = {}
    for tr in traces:
        if id(tr) not in on_dev:
            on_dev[id(tr)] = _pad_trace(tr, n_max).to(DEVICE)
    trs = [on_dev[id(t)] for t in traces]
    views = _lane_views(topo, scheds, DEVICE)
    states = [init_state(topo, v, n_max, q, None, device=DEVICE)
              for v, q in zip(views, qs)]
    return topo, views, trs, states


def grid_lanes(cfg, trace, grid, capacity):
    """``batch_lanes`` of a ``sweep_grid``'s points."""
    import dataclasses

    from repro_torch.core.engine import _sched_i32, grid_points

    pts = grid_points(grid)
    cfgs = [dataclasses.replace(cfg, **p) for p in pts]
    cap = dataclasses.replace(cfg, queue_size=capacity)
    return batch_lanes(cap, [trace] * len(pts), [c.queue_size for c in cfgs],
                       [_sched_i32(c.runtime()) for c in cfgs])


def time_batch(label, lanes, cycles, sms, wall_s=None):
    """Device time of one lane-batched launch of fresh ``lanes`` to
    ``cycles`` (CUDA events), beside lanes, SMs busy, the CTAs an SM holds
    and aggregate executed steps/s. Returns the record."""
    import torch
    from repro_torch.kernels.bank_fsm.fused import (
        fused_run_batch_cuda, fused_run_batch_occupancy)

    topo, views, trs, states = lanes
    per_sm = fused_run_batch_occupancy(topo, views, trs, states)
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    _, steps, launches = fused_run_batch_cuda(topo, views, trs, states,
                                              cycles)
    e.record()
    torch.cuda.synchronize()
    check(launches == 1, f"{label}: {launches} launches")
    ms = s.elapsed_time(e)
    n = len(states)
    rec = {"label": label, "lanes": n, "sms_busy": min(n, sms),
           "ctas_per_sm": per_sm, "waves": -(-n // (per_sm * sms)),
           "device_ms": ms, "max_steps": max(steps),
           "steps_total": sum(steps),
           "us_per_step": ms * 1e3 / max(steps),
           "steps_per_s": sum(steps) / ms * 1e3, "wall_s": wall_s}
    log(f"[13] {label}: {n} lanes, SMs busy {min(n, sms)} of {sms}, "
        f"{per_sm} CTAs an SM at once ({rec['waves']} wave(s)); one launch "
        f"{ms:.3f} ms of device time, longest lane {max(steps)} steps = "
        f"{rec['us_per_step']:.3f} us/step, {sum(steps)} steps in all = "
        f"{rec['steps_per_s']:.0f} steps/s"
        + (f"; entry point {wall_s:.3f} s wall" if wall_s else ""))
    return rec, lanes, steps


def phase_batch():
    """13: the lane-batched persistent K3 against its plain version, the
    batched entry points against the golden digests and single-lane runs,
    and their times."""
    import dataclasses

    import torch
    from repro_torch import golden
    from repro_torch.core import (
        MemSimConfig, interop, simulate_batch, simulate_fast,
        simulate_ideal, stats, sweep_grid, sweep_queue_sizes)
    from repro_torch.core.engine import _sched_i32, fused_run_batch_plain
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.fused import (
        fused_run_batch_occupancy, fused_run_batch_placement, fused_run_cuda)
    from repro_torch.traces import BENCHMARKS, conv2d

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = MemSimConfig(queue_size=128)
    probe = lane_inputs({"cfg": cfg, "trace": BENCHMARKS["conv2d"](),
                         "key": "probe"}, {})
    per_sm = fused_run_batch_occupancy(probe[0], [probe[1]], [probe[2]],
                                       [probe[3]])
    # ---- the kernel against its plain version, every lane's SimState ----
    counted = dict(build.LAUNCHES)
    for label, specs, cycles, budgets, placed in batch_cases(per_sm, sms):
        topo, view, tr, state = lane_inputs(specs[0], {})
        where = fused_run_batch_placement(topo, [view], [tr], [state])
        check(where == placed, f"{label}: the launch keeps {where} in device "
              f"memory, built to keep {placed}")
        if "waves" in label:
            check(len(specs) > per_sm * sms, f"{label}: the card holds "
                  f"{per_sm * sms} lanes at once")
        for cycle_skip in (True, False):
            form = "skipping" if cycle_skip else "per-cycle"
            t0 = time.perf_counter()
            want = [plain_lane(s, cycles, cycle_skip) for s in specs]
            t_p = time.perf_counter() - t0
            for budget in budgets:
                build.reset_launches()
                t0 = time.perf_counter()
                lanes, steps, launches = batch_run(specs, cycles, cycle_skip,
                                                   budget)
                t_k = time.perf_counter() - t0
                check(build.LAUNCHES["k3batch"] == launches > 0
                      and build.LAUNCHES["k3run"] == 0
                      and build.LAUNCHES["k3cyc"] == 0,
                      f"{label}: launches counted {build.LAUNCHES} for "
                      f"{launches}")
                for i, (lane, (w, w_steps)) in enumerate(zip(lanes, want)):
                    got = interop.state_to_numpy(lane[3])
                    bad = [k for k in w if got[k].shape != w[k].shape
                           or (got[k] != w[k]).any()]
                    if bad or steps[i] != w_steps:
                        first = batch_first_divergence(specs[i], cycles,
                                                       cycle_skip)
                        check(False, f"lane-batched K3 ({form} form, budget "
                              f"{budget}) != its plain version on "
                              f"{label}@{cycles}: first diverging lane {i} "
                              f"({specs[i]['key']}), leaves {bad}, steps "
                              f"{steps[i]} vs {w_steps}; the lane alone in "
                              f"lockstep diverges at (clock, leaves, next "
                              f"clocks) {first}")
                if budget is not None:
                    check(launches == -(-max(steps) // budget),
                          f"{label}: {launches} launches for "
                          f"{max(steps)} steps")
                else:
                    check(launches == 1, f"{label}: {launches} launches")
                log(f"[13] lane-batched K3 ({form}, budget "
                    f"{budget or 'default'}) == its plain version on "
                    f"{label}@{cycles}: every lane's SimState bit for bit, "
                    f"steps {min(steps)}-{max(steps)}, {launches} "
                    f"launch(es) ({t_k:.2f} s; plain {t_p:.1f} s); in "
                    f"device memory: {', '.join(where) or 'nothing'}")
    build.LAUNCHES.update(counted)

    # ---- the main path: the batched entry points -------------------------
    single, batch = golden.load(), golden.load_batch()
    names = sorted(BENCHMARKS)
    traces = [BENCHMARKS[n]() for n in names]
    cap = golden.BATCH_CAPACITY
    q = golden.QUEUE_SIZE
    over = conv2d(burst_gap=golden.FIG_BURST_GAP)
    depths = list(golden.SWEEP_F8)
    grid132 = {"tRP": [14, 15, 16], "tCL": [14, 16, 18, 20],
               "queue_size": depths}
    grid528 = dict(grid132, page_policy=["closed", "open"],
                   sched_policy=["fcfs", "frfcfs"])
    runs = {}
    build.reset_launches()

    def entry(key, fn):
        tm = {}
        t0 = time.perf_counter()
        res = fn(tm)
        runs[key] = (res, time.perf_counter() - t0, tm)
        check(tm["launches"] == 1, f"{key}: {tm['launches']} launches, "
              f"built for one")
        log(f"[13] {key}: {len(res)} lanes in {runs[key][1]:.3f} s wall: "
            f"set-up {tm['setup_s']:.3f} s (traces, views, states), lanes "
            f"{tm['lanes_s']:.3f} s (the launch and its read), results "
            f"{tm['results_s']:.3f} s (copies to the host)")
        return res

    t2 = entry("table2", lambda tm: simulate_batch(
        MemSimConfig(queue_size=cap), traces, golden.TABLE2_BATCH[1],
        queue_sizes=[q] * len(traces), timings=tm, device=DEVICE))
    f20 = entry("fig20k", lambda tm: sweep_queue_sizes(
        MemSimConfig(), over, depths, golden.FIG_SWEEP[1], capacity=cap,
        timings=tm, device=DEVICE))
    f100 = entry("fig100k", lambda tm: sweep_queue_sizes(
        MemSimConfig(), over, depths, BATCH_CYCLES, capacity=cap, timings=tm,
        device=DEVICE))
    g132 = entry("grid132", lambda tm: sweep_grid(
        MemSimConfig(), conv2d(), grid132, BATCH_CYCLES, capacity=cap,
        timings=tm, device=DEVICE))
    g528 = entry("grid528", lambda tm: sweep_grid(
        MemSimConfig(), conv2d(), grid528, BATCH_CYCLES, capacity=cap,
        timings=tm, device=DEVICE))
    main = dict(build.LAUNCHES)
    check(main["k3batch"] == len(runs) and all(
        v == 0 for k, v in main.items() if k != "k3batch"),
          f"the batched entry points launched {main}; built for "
          f"{len(runs)} lane-batched K3 launches and nothing else")

    rows = []
    batch_name, cycles = golden.TABLE2_BATCH
    for name, tr, res, lane in zip(names, traces, t2,
                                   runs["table2"][2]["per_lane"]):
        ideal = simulate_ideal(MemSimConfig(queue_size=q), tr,
                               device=DEVICE).t_complete.cpu().numpy()
        got = golden.result_digest(res, ideal, lane["steps"])
        bad = golden.mismatches(
            batch[golden.batch_key(batch_name, name, cycles)], got)
        bad1 = golden.mismatches(single[golden.case_key(name, cycles)], got)
        check(not bad and not bad1, f"Table-2 batch lane {name} differs "
              f"from the batch golden digest in {bad}, from the single-lane "
              f"one in {bad1}")
        rows.append((name, stats.cycle_diffs(res, ideal)))
    log(f"[13] the Table-2 batch ({len(traces)} traces, queue {q} on "
        f"capacity {cap}, {cycles} cycles): one launch, every lane equal to "
        f"its golden batch digest and its single-lane digest\n"
        + stats.format_table2(rows))
    batch_name, cycles = golden.FIG_SWEEP
    for d, res, lane in zip(depths, f20, runs["fig20k"][2]["per_lane"]):
        got = golden.result_digest(res, None, lane["steps"])
        bad = golden.mismatches(
            batch[golden.batch_key(batch_name, f"q{d}", cycles)], got)
        check(not bad, f"Fig sweep q{d}@{cycles} differs from the golden "
              f"digest in {bad}")
    log(f"[13] the Fig 6-9 sweep ({len(depths)} depths, conv2d at burst gap "
        f"{golden.FIG_BURST_GAP}, capacity {cap}) at {cycles} cycles: one "
        f"launch, every lane equal to its golden digest")
    # each Fig-sweep lane at 100k against its single-lane run
    for d, res, lane in zip(depths, f100, runs["fig100k"][2]["per_lane"]):
        tm = {}
        one = simulate_fast(MemSimConfig(queue_size=cap), over, BATCH_CYCLES,
                            queue_size=d, timings=tm, device=DEVICE)
        bad = golden.mismatches(golden.result_digest(one, None, tm["steps"]),
                                golden.result_digest(res, None,
                                                     lane["steps"]))
        same_cfg = dataclasses.asdict(one.cfg) == dataclasses.asdict(res.cfg)
        check(not bad and same_cfg, f"Fig sweep lane q{d}@{BATCH_CYCLES} != "
              f"simulate_fast at queue {d}: {bad}, labels equal: {same_cfg}")
    log(f"[13] Fig 7 (conv2d, burst gap 18, {BATCH_CYCLES} cycles; every "
        f"lane equal to its single-lane simulate_fast):\n" + "\n".join(
            f"  queue {d:5d}: read {s['read_mean']:9.2f}  write "
            f"{s['write_mean']:9.2f}  mean {s['mean']:9.2f} cycles"
            for d, s in ((d, stats.latency_summary(r))
                         for d, r in zip(depths, f100))))
    for key, res in (("grid132", g132), ("grid528", g528)):
        per = runs[key][2]["per_lane"]
        for i in (0, len(res) // 3, len(res) - 1):
            tm = {}
            c = res[i].cfg
            one = simulate_fast(dataclasses.replace(c, queue_size=cap),
                                conv2d(), BATCH_CYCLES,
                                queue_size=c.queue_size, timings=tm,
                                device=DEVICE)
            bad = golden.mismatches(
                golden.result_digest(one, None, tm["steps"]),
                golden.result_digest(res[i], None, per[i]["steps"]))
            check(not bad, f"{key} lane {i} != simulate_fast of its point: "
                  f"{bad}")
    log("[13] grids: lanes 0, L/3 and L-1 of each equal their single-lane "
        "simulate_fast")

    # ---- times --------------------------------------------------------------
    counted = dict(build.LAUNCHES)
    recs = {}
    const = _sched_i32(MemSimConfig().runtime())
    big = MemSimConfig(queue_size=cap)
    recs["table2"], t2_lanes, t2_steps = time_batch(
        f"Table-2 batch@{BATCH_CYCLES}",
        batch_lanes(big, traces, [q] * 4, [const] * 4), BATCH_CYCLES, sms,
        runs["table2"][1])
    recs["fig100k"], _, _ = time_batch(
        f"Fig sweep@{BATCH_CYCLES}",
        batch_lanes(big, [over] * len(depths), depths,
                    [const] * len(depths)), BATCH_CYCLES, sms,
        runs["fig100k"][1])
    for key, grid in (("grid132", grid132), ("grid528", grid528)):
        axes = " x ".join(f"{k} {len(v)}" for k, v in grid.items())
        recs[key], _, _ = time_batch(
            f"sweep_grid {axes} on conv2d@{BATCH_CYCLES}",
            grid_lanes(MemSimConfig(), conv2d(), grid, cap), BATCH_CYCLES,
            sms, runs[key][1])
    # the single lane, alone and as a batch of one, at the batch's inputs
    for label, c in (("capacity 2048", cap), ("capacity 128", q)):
        lanes = batch_lanes(MemSimConfig(queue_size=c), traces[:1], [q],
                            [const])
        time_batch(f"conv2d@{BATCH_CYCLES} as a batch of one lane, {label}",
                   lanes, BATCH_CYCLES, sms)
        topo, view, tr, state = lane_inputs(
            {"cfg": MemSimConfig(queue_size=c), "trace": traces[0],
             "q": q, "key": "one"}, {})
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        _, n = fused_run_cuda(topo, view, tr, state, 0, BATCH_CYCLES)
        e.record()
        torch.cuda.synchronize()
        log(f"[13] conv2d@{BATCH_CYCLES} single-lane K3, {label}: "
            f"{s.elapsed_time(e) * 1e3 / n:.3f} us/step ({n} steps)")
    # the plain version of the Table-2 batch: one launch of its protocol
    # (30 steps of every lane) on fresh lanes, after one of 5 to warm up
    for budget in (5, 30):
        topo, views, trs, states = batch_lanes(big, traces, [q] * 4,
                                               [const] * 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_run_batch_plain(topo, views, trs, states, BATCH_CYCLES, budget,
                              max_launches=1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / budget
    nbytes = sum(run_bytes(v, t, s) for v, t, s in zip(*t2_lanes[1:]))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3 / max(t2_steps)
    log(f"[13] the Table-2 batch's plain version (fused_run_batch_plain, "
        f"eager on the card): {plain_ms * 1e3:.1f} us wall a step of the "
        f"batch (every lane one step); bound {nbytes} B at 3.35 TB/s = "
        f"{bound_ms * 1e6:.3f} ns per step of the longest lane")
    build.LAUNCHES.update(counted)
    return {"launches": main["k3batch"], "ms": recs["table2"]["us_per_step"]
            / 1e3, "plain_ms": plain_ms, "bound_ms": bound_ms, "recs": recs}


# ------------------------------------------------- windowed sessions --

#: phase 14's fused sessions: the paper's horizon in windows of 2000
SESSION_CYCLES = 100_000
SESSION_WINDOW = 2_000
#: phase 14's split session: conv2d at 20k cycles in windows of 1000
SPLIT_SESSION = (20_000, 1_000)
#: the runtime queue limits the 132 lanes of phase 14's batch cycle through
BATCH_SESSION_QS = (128, 64, 32, 16, 8, 4)


class LaunchTimer:
    """CUDA events around every K3 launch made inside the ``with`` block:
    the start event is recorded when the kernel's wrapper asks for the
    launch's stream (its host preparation done, the launch's argument
    copies enqueued), the end event when it checks the launch's error
    code, right after the launch is enqueued. ``ms()`` is the device time
    of the launches alone, without the host's work between windows (a
    profiler trace of a session's many launches can drop some)."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import build

        self.pairs = []
        self._saved = (build.stream_of, build.check)
        stream_of, check = self._saved

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_stream_of(t):
            self.pairs.append([event(), None])
            return stream_of(t)

        def timed_check(err, what):
            if self.pairs and self.pairs[-1][1] is None:
                self.pairs[-1][1] = event()
            return check(err, what)

        build.stream_of, build.check = timed_stream_of, timed_check
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import build

        build.stream_of, build.check = self._saved

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def drive_session(ses, cycles, window, arrivals=None):
    """Advance ``ses`` to ``cycles`` in windows of ``window``, appending
    before each window the arrivals of ``arrivals`` (host arrays, or None)
    due before its end. Checks that each window launches one K3 of the
    session's kind (``k3run`` for a SimSession, ``k3batch`` for a
    SessionBatch) and nothing else. Returns (reports, wall s of each
    window, launch s of each window)."""
    import numpy as np
    from repro_torch.core import SimSession
    from repro_torch.kernels import build

    kind = "k3run" if isinstance(ses, SimSession) else "k3batch"
    reports, walls, runs = [], [], []
    pos = 0
    while ses.cycle < cycles:
        t1 = min(ses.cycle + window, cycles)
        payload = None
        if arrivals is not None:
            end = int(np.searchsorted(arrivals[0], t1, side="left"))
            payload = tuple(x[pos:end] for x in arrivals)
            pos = end
        before, run0 = dict(build.LAUNCHES), ses.timings.get("run_s", 0.0)
        t0 = time.perf_counter()
        reports.append(ses.advance(t1 - ses.cycle, payload))
        walls.append(time.perf_counter() - t0)
        runs.append(ses.timings["run_s"] - run0)
        delta = {k: build.LAUNCHES[k] - before[k] for k in before}
        check(delta[kind] == 1 and sum(delta.values()) == 1,
              f"a window of {type(ses).__name__} launched {delta}; built "
              f"for one {kind} launch and nothing else")
    return reports, walls, runs


def report_copy_ms(states, filled, n=50):
    """Median wall ms of one window's report copy: every lane's
    ``report_fetch`` tensors, concatenated and copied to the host."""
    import torch
    from repro_torch.core.session import report_fetch

    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cat([x for st, k in zip(states, filled)
                   for x in report_fetch(st, k)]).cpu()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def phase_sessions(run_plain_ms, batch_plain_ms):
    """14: windowed sessions and the closed-loop serving study on the card
    (see the module docstring)."""
    import numpy as np
    import torch
    from repro_torch import golden
    from repro_torch.core import (
        MemSimConfig, SessionBatch, SimSession, simulate_fast,
        simulate_ideal)
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.fused import (
        _batch_args, _batch_scratch)
    from repro_torch.serving import (
        ServingConfig, generate_request_batch, run_serving,
        run_serving_batched)
    from repro_torch.traces import BENCHMARKS, conv2d

    expected = golden.load()
    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    cycles, window = SESSION_CYCLES, SESSION_WINDOW
    n_windows = -(-cycles // window)
    out = {}

    def no_steps(d):
        return {k: v for k, v in d.items() if k != "steps"}

    # ---- (a) fused sessions on the four traces --------------------------
    build.reset_launches()
    walls_a, runs_a, steps_a = [], [], 0
    cases = [(n, False) for n in sorted(BENCHMARKS)] + [("conv2d", True)]
    for name, incremental in cases:
        tr = BENCHMARKS[name]()
        arrs = tuple(x.numpy() for x in tr)
        tm = {}
        ses = SimSession.open(cfg, capacity=tr.num_requests, timings=tm,
                              device=DEVICE)
        if not incremental:
            ses.append(arrs)
        reps, walls, runs = drive_session(ses, cycles, window,
                                          arrs if incremental else None)
        res = ses.result()
        ideal = simulate_ideal(cfg, tr, device=DEVICE).t_complete.cpu(
            ).numpy()
        want = expected[golden.case_key(name, cycles)]
        bad = golden.mismatches(no_steps(want),
                                golden.result_digest(res, ideal))
        steps = sum(r.steps for r in reps)
        how = "appended window by window" if incremental else "appended once"
        check(not bad, f"session {name}@{cycles} ({how}) differs from the "
              f"golden digest in {bad}")
        check(len(reps) == n_windows == tm["windows"] == tm["launches"]
              and tm["captures"] == 0, f"session {name}: {len(reps)} "
              f"windows, timings {tm}")
        check(0 <= steps - want["steps"] <= n_windows, f"session {name}: "
              f"{steps} steps in windows against {want['steps']} in one run")
        walls_a += walls
        runs_a += runs
        steps_a += steps
        log(f"[14] SimSession fused {name}@{cycles} ({how}), {len(reps)} "
            f"windows of {window}: equals the golden digest (all fields but "
            f"steps); {steps} steps ({steps - want['steps']} more than the "
            f"monolithic run's {want['steps']}); one k3run launch a window "
            f"and nothing else; {sum(walls):.3f} s wall, "
            f"{np.mean(walls) * 1e3:.3f} ms a window (launch and its read "
            f"{np.mean(runs) * 1e3:.3f}, report copy and host "
            f"{(np.mean(walls) - np.mean(runs)) * 1e3:.3f})")
    run_launches = build.LAUNCHES["k3run"]
    check(run_launches == len(cases) * n_windows and all(
        v == 0 for k, v in build.LAUNCHES.items() if k != "k3run"),
        f"the fused sessions launched {dict(build.LAUNCHES)}")
    # device time of the windows' launches (conv2d, appended once)
    counted = dict(build.LAUNCHES)
    tr = BENCHMARKS["conv2d"]()
    ses = SimSession.open(cfg, capacity=tr.num_requests, device=DEVICE)
    ses.append(tuple(x.numpy() for x in tr))
    with LaunchTimer() as timer:
        reps = ses.run_until(cycles, window)
    dev_ms, n_k = timer.ms(), len(timer.pairs)
    steps = sum(r.steps for r in reps)
    nbytes = run_bytes(ses._view, ses._buf.traces[0], ses._state)
    out["run"] = {"launches": run_launches, "ms": dev_ms / steps,
                  "plain_ms": run_plain_ms,
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3 / steps}
    with LaunchTimer() as timer:
        st = {}
        t0 = time.perf_counter()
        simulate_fast(cfg, tr, cycles, timings=st, device=DEVICE)
        mono_wall = time.perf_counter() - t0
    mono_ms = timer.ms()
    check(n_k == len(reps) and len(timer.pairs) == 1,
          f"timed {n_k} launches for {len(reps)} windows")
    log(f"[14] conv2d@{cycles}: {n_k} window launches {dev_ms:.3f} ms of "
        f"device time for {steps} steps = {dev_ms / steps * 1e3:.3f} us/step "
        f"inside windows; the monolithic simulate_fast in the same way "
        f"{mono_ms:.3f} ms for {st['steps']} steps = "
        f"{mono_ms / st['steps'] * 1e3:.3f} us/step in one launch, "
        f"{mono_wall:.3f} s wall; mean per-window wall over the five "
        f"sessions {np.mean(walls_a) * 1e3:.3f} ms (launch and read "
        f"{np.mean(runs_a) * 1e3:.3f} ms, report copy "
        f"{report_copy_ms([ses._state], [tr.num_requests]):.3f} ms)")
    build.LAUNCHES.update(counted)

    # ---- (b) the split backend's windows ---------------------------------
    build.reset_launches()
    horizon, w = SPLIT_SESSION
    split = MemSimConfig(queue_size=golden.QUEUE_SIZE, fsm_backend="split")
    tr = conv2d()
    tm = {}
    ses = SimSession.open(split, capacity=tr.num_requests, timings=tm,
                          device=DEVICE)
    ses.append(tuple(x.numpy() for x in tr))
    t0 = time.perf_counter()
    reps = ses.run_until(horizon, w)
    wall = time.perf_counter() - t0
    ideal = simulate_ideal(cfg, tr, device=DEVICE).t_complete.cpu().numpy()
    want = expected[golden.case_key("conv2d", horizon)]
    bad = golden.mismatches(no_steps(want),
                            golden.result_digest(ses.result(), ideal))
    check(not bad, f"split session conv2d@{horizon} differs from the golden "
          f"digest in {bad}")
    check(tm["captures"] == 1 and tm["launches"] == 0
          and build.LAUNCHES["k1"] > 0 and build.LAUNCHES["k2"] > 0
          and build.LAUNCHES["k3run"] == 0, f"split session: timings {tm}, "
          f"launches {dict(build.LAUNCHES)}")
    # each window skips as the fused session's window does: a replayed step
    # reads this window's horizon, not the one it was captured with
    fused = SimSession.open(cfg, capacity=tr.num_requests, device=DEVICE)
    fused.append(tuple(x.numpy() for x in tr))
    want = [r.steps for r in fused.run_until(horizon, w)]
    check([r.steps for r in reps] == want, f"split session's steps a window "
          f"{[r.steps for r in reps]} != the fused session's {want}")
    log(f"[14] SimSession split conv2d@{horizon}, {len(reps)} windows of {w}: "
        f"equals the golden digest (all fields but steps), "
        f"{sum(r.steps for r in reps)} steps, each window's equal to the "
        f"fused session's, {tm['captures']} CUDA graph captured (one "
        f"schedule segment), {wall:.2f} s wall")
    dvfs = dvfs_schedule(cfg)
    ref = simulate_fast(cfg, tr, 3_000, params=dvfs, device=DEVICE)
    for w in (250, 1_000):
        tm = {}
        ses = SimSession.open(split, capacity=tr.num_requests, params=dvfs,
                              timings=tm, device=DEVICE)
        ses.append(tuple(x.numpy() for x in tr))
        ses.run_until(3_000, w)
        bad = golden.mismatches(golden.result_digest(ref, None),
                                golden.result_digest(ses.result(), None))
        check(not bad and tm["captures"] == dvfs.num_segments,
              f"split DVFS session (windows of {w}) != fused simulate_fast "
              f"in {bad}, {tm['captures']} captures for "
              f"{dvfs.num_segments} segments")
        log(f"[14] SimSession split conv2d@3000 on a {dvfs.num_segments}-"
            f"segment DVFS schedule, {tm['windows']} windows of {w}: equals "
            f"the fused simulate_fast; {tm['captures']} captures, one a "
            f"segment")

    # ---- (c) a SessionBatch at full occupancy ----------------------------
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = sorted(BENCHMARKS)
    traces = {n: BENCHMARKS[n]() for n in names}
    lanes = [(names[i % 4], BATCH_SESSION_QS[(i // 4)
                                             % len(BATCH_SESSION_QS)])
             for i in range(4 * 33)]
    capacity = max(t.num_requests for t in traces.values())

    def open_batch(tm):
        b = SessionBatch.open(cfg, len(lanes), capacity=capacity,
                              queue_size=[q for _, q in lanes], timings=tm,
                              device=DEVICE)
        for i, (n, _) in enumerate(lanes):
            b.append(i, tuple(x.numpy() for x in traces[n]))
        return b

    build.reset_launches()
    tm = {}
    batch = open_batch(tm)
    reps, walls, runs = drive_session(batch, cycles, window)
    k3batch = build.LAUNCHES["k3batch"]
    single = {}
    for i, (n, q) in enumerate(lanes):
        if (n, q) not in single:
            st = {}
            one = simulate_fast(cfg, traces[n], cycles, queue_size=q,
                                timings=st, device=DEVICE)
            single[(n, q)] = (golden.result_digest(one, None), st["steps"])
        want, want_steps = single[(n, q)]
        got = golden.result_digest(batch.lane_result(i), None)
        bad = golden.mismatches(no_steps(want), got)
        steps = sum(r[i].steps for r in reps)
        check(not bad and 0 <= steps - want_steps <= n_windows,
              f"batch lane {i} ({n}, queue {q}) != its simulate_fast in "
              f"{bad}; steps {steps} against {want_steps}")
        if q == golden.QUEUE_SIZE:
            gold = expected[golden.case_key(n, cycles)]
            bad = golden.mismatches({k: gold[k] for k in got}, got)
            check(not bad, f"batch lane {i} ({n}) != golden in {bad}")
    log(f"[14] SessionBatch fused, {len(lanes)} lanes (four traces x 33, "
        f"queue limits {BATCH_SESSION_QS}), {len(reps)} windows of {window} "
        f"at {cycles}: one k3batch launch a window and nothing else; every "
        f"lane equals its single-lane simulate_fast ({len(single)} distinct "
        f"runs; the queue-128 lanes the golden digests); {sum(walls):.3f} s "
        f"wall, {np.mean(walls) * 1e3:.3f} ms a window (launch and its read "
        f"{np.mean(runs) * 1e3:.3f}, report copy and host "
        f"{(np.mean(walls) - np.mean(runs)) * 1e3:.3f})")
    # the host set-up of a window's launch at 132 lanes (hazard: rebuilt
    # every window) and the report copy of every lane
    ts = [batch.cycle] * len(lanes)
    dev = torch.device(DEVICE)
    per = []
    for _ in range(20):
        outs = torch.empty((len(lanes), 2), dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        _batch_args(batch.topo, batch._views, batch._buf.traces,
                    batch._states, range(len(lanes)), ts, cycles + window,
                    1 << 20, _batch_scratch(batch.topo, len(lanes), dev),
                    outs, True)
        per.append(time.perf_counter() - t0)
    args_ms = statistics.median(per) * 1e3
    copy_ms = report_copy_ms(batch._states, batch._buf.filled)
    log(f"[14] {len(lanes)} lanes: the launch's host arguments "
        f"(_batch_args) {args_ms:.3f} ms a window (median of 20), the report "
        f"copy of every lane {copy_ms:.3f} ms")
    counted = dict(build.LAUNCHES)
    batch = open_batch({})
    with LaunchTimer() as timer:
        reps = batch.run_until(cycles, window)
    dev_ms = timer.ms()
    check(len(timer.pairs) == len(reps), f"timed {len(timer.pairs)} "
          f"launches for {len(reps)} windows")
    lane_steps = [sum(r[i].steps for r in reps) for i in range(len(lanes))]
    nbytes = sum(run_bytes(v, t, s) for v, t, s in zip(
        batch._views, batch._buf.traces, batch._states))
    out["batch"] = {
        "ms": dev_ms / max(lane_steps), "plain_ms": batch_plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3 / max(lane_steps)}
    log(f"[14] {len(lanes)}-lane batch, {len(reps)} window launches on "
        f"{min(len(lanes), sms)} SMs: {dev_ms:.3f} ms of device time, "
        f"longest lane {max(lane_steps)} steps = "
        f"{dev_ms / max(lane_steps) * 1e3:.3f} us/step inside windows, "
        f"{sum(lane_steps) / dev_ms * 1e3:.0f} steps/s")
    build.LAUNCHES.update(counted)

    # ---- (d) the serving study's closed loop -----------------------------
    serving = golden.load_serving()
    scfg = ServingConfig()
    lists = generate_request_batch(golden.serving_scenarios(),
                                   seed=golden.SERVING_SEED,
                                   independent_streams=False)
    cap = golden.serving_capacity(lists, scfg)
    serve_launches = 0
    for name, tcfg, params in golden.serving_topologies():
        build.reset_launches()
        tm = {}
        t0 = time.perf_counter()
        results = run_serving_batched(
            tcfg, lists, scfg, params=params,
            window_cycles=golden.SERVING_WINDOW, capacity=cap,
            seed=golden.SERVING_SEED, timings=tm, device=DEVICE)
        wall = time.perf_counter() - t0
        check(build.LAUNCHES["k3batch"] == tm["windows"] == tm["launches"]
              and sum(build.LAUNCHES.values()) == tm["windows"],
              f"serving {name}: launches {dict(build.LAUNCHES)}, timings "
              f"{tm}")
        serve_launches += tm["windows"]
        for load, res in zip(golden.SERVING_LOADS, results):
            key = golden.serving_key(name, load)
            bad = golden.mismatches(serving[key],
                                    golden.serving_digest(res, cap))
            check(not bad, f"serving {key} differs from the golden digest "
                  f"in {bad}")
        lane = len(golden.SERVING_LOADS) - 1
        seq = run_serving(tcfg, lists[lane], scfg, params=params,
                          window_cycles=golden.SERVING_WINDOW, capacity=cap,
                          seed=golden.SERVING_SEED, device=DEVICE)
        got = golden.serving_digest(seq, cap)
        want = serving[golden.serving_key(name, golden.SERVING_LOADS[lane])]
        bad = [k for k in golden.mismatches(want, got) if k != "session"]
        bad += [f for f in golden.RECORDS
                if want["session"][f] != got["session"][f]]
        check(not bad, f"serving {name}: run_serving of load "
              f"{golden.SERVING_LOADS[lane]} != its batched lane in {bad}")
        copy_ms = report_copy_ms(results[0].session._batch._states,
                                 results[0].session._batch._buf.filled)
        host = wall - tm["run_s"] - copy_ms * tm["windows"] / 1e3
        log(f"[14] serving {name} ({len(lists)} loads "
            f"{golden.SERVING_LOADS} as one run_serving_batched, windows of "
            f"{golden.SERVING_WINDOW}): every ServingResult field and lane "
            f"session equal the golden digests; the sequential run_serving "
            f"of load {golden.SERVING_LOADS[lane]} equals its lane; "
            f"{tm['windows']} windows (one k3batch launch each), "
            f"{wall:.3f} s wall = launches and their reads "
            f"{tm['run_s']:.3f} s + report copies ~"
            f"{copy_ms * tm['windows'] / 1e3:.3f} s + scheduler and host "
            f"~{host:.3f} s; tokens/kcycle "
            + ", ".join(f"{r.tokens_per_kcycle:.3f}" for r in results))
        out[f"serving_{name}"] = {"wall_s": wall, "windows": tm["windows"],
                                  "run_s": tm["run_s"]}
    out["batch"]["launches"] = k3batch + serve_launches
    return out


# ------------------------------------------- topology sweeps and studies --

#: phase 15(a): 8 topologies (channels x ranks x banks a group) x 6 runtime
#: lanes (tCL x queue depth) on conv2d at the paper's horizon
TOPO_SWEEP_GRID = {"channels": [1, 2], "ranks": [1, 2],
                   "banks_per_group": [2, 4], "tCL": [14, 18],
                   "queue_size": [16, 64, 128]}
TOPO_SWEEP_CYCLES = 100_000
#: phase 15(b): a backend axis, each split lane against its fused twin
BACKEND_GRID = {"fsm_backend": ["split", "fused"], "ranks": [1, 2],
                "tCL": [14, 18]}
BACKEND_CYCLES = 2_000
#: phase 15(a): the sweep's first start to last end is held under the
#: spread of its launches' starts plus this many times its longest
#: topology's launch alone
OVERLAP_SLACK = 1.25


def timed_sweep(cfg, trace):
    """One ``sweep_topologies`` of phase 15(a)'s grid with the default
    workers: (the sweep, its timings, its wall seconds, each launch's
    (start, end) in ms after the sweep's entry, by CUDA events on its
    topology's stream, in launch order)."""
    import torch
    from repro_torch.core import sweep_topologies

    tm = {}
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    with LaunchTimer() as timer:
        t0 = time.perf_counter()
        sweep = sweep_topologies(cfg, trace, TOPO_SWEEP_GRID,
                                 TOPO_SWEEP_CYCLES, timings=tm,
                                 device=DEVICE)
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    spans = sorted((ref.elapsed_time(s), ref.elapsed_time(e))
                   for s, e in timer.pairs)
    return sweep, tm, wall, spans


def spans_text(spans):
    """A sweep's launches: device ms, starts, first start to last end."""
    dev_ms = [e - s for s, e in spans]
    return ("launches' device ms " + ", ".join(f"{d:.3f}" for d in dev_ms)
            + f" (sum {sum(dev_ms):.3f}), started at "
            + ", ".join(f"{s:.1f}" for s, _ in spans)
            + " ms; first start to last end "
            f"{max(e for _, e in spans) - min(s for s, _ in spans):.3f} ms")


def same_lane(a, b):
    """The fields of two SimResults that differ (empty when equal)."""
    import numpy as np

    bad = [f for f in ("t_intended", "is_write", "t_admit", "t_dispatch",
                       "t_start", "t_complete", "rdata")
           if not np.array_equal(getattr(a, f), getattr(b, f))]
    bad += [f"counter {k}" for k in sorted(set(a.counters) | set(b.counters))
            if not np.array_equal(a.counters.get(k), b.counters.get(k))]
    bad += [f for f in ("blocked_arrival", "blocked_dispatch", "num_cycles",
                        "cfg") if getattr(a, f) != getattr(b, f)]
    return bad


def phase_topologies():
    """15: the multi-topology sweep and the effective-bandwidth studies on
    the card (see the module docstring)."""
    import dataclasses

    import torch
    from repro_torch import golden
    from repro_torch.core import (
        MemSimConfig, simulate_fast, sweep_topologies, topo_grid_points)
    from repro_torch.core.engine import fused_run_batch_plain
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.fused import fused_run_batch_cuda
    from repro_torch.perfmodel import effective_bw
    from repro_torch.traces import BENCHMARKS

    out = {}
    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    trace = BENCHMARKS["conv2d"]()
    cycles = TOPO_SWEEP_CYCLES

    # ---- (a) 8 topologies x 6 lanes, one launch a topology ---------------
    build.reset_launches()
    sweep, tm, wall, spans = timed_sweep(cfg, trace)
    counted = dict(build.LAUNCHES)
    n_topo = len(sweep.topologies)
    check(len(sweep) == 48 and n_topo == 8,
          f"topology sweep: {len(sweep)} lanes, {n_topo} topologies")
    check(tm["launches"] == n_topo == counted["k3batch"] == len(spans)
          and sum(counted.values()) == n_topo,
          f"topology sweep: launches {counted}, timings {tm['launches']}, "
          f"timed {len(spans)}; built for one k3batch launch a topology and "
          f"nothing else")
    out["launches"] = counted["k3batch"]
    for point, res in zip(sweep.points, sweep.results):
        want = simulate_fast(res.cfg, trace, cycles, device=DEVICE)
        bad = same_lane(want, res)
        check(not bad, f"topology sweep lane {point} != its single-lane "
              f"simulate_fast in {bad}")
    log(f"[15] sweep_topologies on conv2d at {cycles}: {len(sweep)} lanes, "
        f"{n_topo} topologies ({tm['topologies']}), one k3batch launch a "
        f"topology and nothing else; every lane equals its single-lane "
        f"simulate_fast; default workers {wall:.3f} s wall (run_s "
        f"{tm['run_s']:.3f}); " + spans_text(spans))
    walls = {"default": [wall], "max_workers=1": []}
    for mw in (1, None, 1):
        t1 = time.perf_counter()
        again = sweep_topologies(cfg, trace, TOPO_SWEEP_GRID, cycles,
                                 max_workers=mw, device=DEVICE)
        walls["default" if mw is None else "max_workers=1"].append(
            time.perf_counter() - t1)
        bad = [i for i, (a, b) in enumerate(zip(sweep, again))
               if same_lane(a, b)]
        check(not bad, f"topology sweep, max_workers={mw}: lanes {bad} "
              f"differ from the default run")
    # each topology alone: one launch of its lanes (as simulate_batch
    # builds them), device time by CUDA events, the bytes of its lanes
    pts = topo_grid_points(TOPO_SWEEP_GRID)
    alone = []
    for gi, topo in enumerate(sweep.topologies):
        idxs = [i for i, t in enumerate(sweep.topo_of_point) if t == gi]
        tcfg = dataclasses.replace(
            sweep.results[idxs[0]].cfg, queue_size=topo.queue_size)
        axes = {"tCL": sorted({pts[i]["tCL"] for i in idxs}),
                "queue_size": sorted({pts[i]["queue_size"] for i in idxs})}
        t_, views, trs, states = grid_lanes(tcfg, trace, axes,
                                            topo.queue_size)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        _, steps, launches = fused_run_batch_cuda(t_, views, trs, states,
                                                  cycles)
        e.record()
        torch.cuda.synchronize()
        check(launches == 1, f"topology {gi} alone: {launches} launches")
        alone.append({"banks": topo.num_banks, "ms": s.elapsed_time(e),
                      "steps": max(steps), "cfg": tcfg, "axes": axes,
                      "bytes": sum(run_bytes(v, tr, st) for v, tr, st
                                   in zip(views, trs, states))})
    # the launches overlapped: the sweep's first start to last end within
    # the spread of its starts (the host's set-up) plus a quarter more than
    # the longest launch alone; launches that waited for each other (one
    # after another, or a kernel loaded while others ran) take longer
    dev_ms = [e - s for s, e in spans]
    span_ms = max(e for _, e in spans) - min(s for s, _ in spans)
    stagger = spans[-1][0] - spans[0][0]
    longest = max(a["ms"] for a in alone)
    dearer = max(d / a["ms"] for d, a in zip(dev_ms, alone))
    check(span_ms < stagger + OVERLAP_SLACK * longest,
          f"topology sweep: first start to last end {span_ms:.3f} ms, over "
          f"the starts' spread {stagger:.3f} ms + {OVERLAP_SLACK} x the "
          f"longest launch alone {longest:.3f} ms: the launches did not "
          f"overlap")
    # the slowest topology alone: its time, byte bound and plain version
    # (its fused_run_batch_plain protocol on fresh lanes, 30 steps of every
    # lane, after 5 to warm up), each per step of its longest lane
    slowest = max(alone, key=lambda a: a["ms"])
    for budget in (5, 30):
        t_, views, trs, states = grid_lanes(
            slowest["cfg"], trace, slowest["axes"],
            slowest["cfg"].queue_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_run_batch_plain(t_, views, trs, states, cycles, budget,
                              max_launches=1)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / budget
    out.update({
        "ms": slowest["ms"] / slowest["steps"], "plain_ms": plain_ms,
        "bound_ms": (slowest["bytes"] / HBM_BYTES_PER_S * 1e3
                     / slowest["steps"]),
        "walls": walls, "dev_ms": dev_ms, "span_ms": span_ms,
        "alone": [(a["banks"], a["ms"], a["steps"]) for a in alone]})
    log("[15] each topology alone, one launch of its 6 lanes (banks: device "
        "ms, longest lane steps, us/step): "
        + "; ".join(f"{a['banks']}: {a['ms']:.3f} ms, {a['steps']}, "
                    f"{a['ms'] * 1e3 / a['steps']:.3f}" for a in alone)
        + f"; sum {sum(a['ms'] for a in alone):.3f} ms, longest "
        f"{longest:.3f} ms; in the sweep a launch at most "
        f"{(dearer - 1) * 100:.1f}% dearer than alone; first start to last "
        f"end {span_ms:.3f} ms < starts' spread {stagger:.3f} + "
        f"{OVERLAP_SLACK} x {longest:.3f} ms: overlapped")
    log(f"[15] the slowest topology ({slowest['banks']} banks) alone: "
        f"{out['ms'] * 1e3:.3f} us/step of its longest lane; its plain "
        f"version (fused_run_batch_plain, eager on the card) "
        f"{plain_ms * 1e3:.1f} us wall a step of its 6 lanes; bound "
        f"{slowest['bytes']} B at 3.35 TB/s = {out['bound_ms'] * 1e6:.3f} "
        f"ns per step of its longest lane")
    log(f"[15] sweep wall: default workers "
        + ", ".join(f"{w:.3f}" for w in walls["default"])
        + " s; max_workers=1 (one topology after another) "
        + ", ".join(f"{w:.3f}" for w in walls["max_workers=1"]) + " s")

    # ---- (b) the small golden grid; a split x fused backend axis ---------
    build.reset_launches()
    got = golden.topo_grid_digests(sweep_topologies, MemSimConfig,
                                   BENCHMARKS[golden.TOPO_GRID_TRACE](),
                                   device=DEVICE)
    bad = golden.mismatches(golden.load_perfmodel()["topo_grid"], got)
    check(not bad, f"small topology grid lanes {bad} differ from the JAX "
          f"digests")
    n_small = len(golden.TOPO_GRID["ranks"])  # its only structural axis
    check(build.LAUNCHES["k3batch"] == n_small
          and sum(build.LAUNCHES.values()) == n_small,
          f"small grid launches {dict(build.LAUNCHES)}")
    log(f"[15] small grid {golden.TOPO_GRID} on {golden.TOPO_GRID_TRACE} at "
        f"{golden.TOPO_GRID_CYCLES}: {len(got)} lanes equal the JAX digests, "
        f"{n_small} k3batch launches")
    build.reset_launches()
    tmb = {}
    t0 = time.perf_counter()
    both = sweep_topologies(cfg, trace, BACKEND_GRID, BACKEND_CYCLES,
                            timings=tmb, device=DEVICE)
    wall_b = time.perf_counter() - t0
    half = len(both) // 2
    check([t.fsm_backend for t in both.topologies]
          == ["split"] * 2 + ["fused"] * 2,
          f"backend grid topologies {both.topologies}")
    for i in range(half):
        bad = [f for f in same_lane(both[i], both[i + half]) if f != "cfg"]
        check(not bad and both[i].cfg == dataclasses.replace(
            both[i + half].cfg, fsm_backend="split"),
              f"split lane {both.points[i]} != its fused twin in {bad}")
    check(build.LAUNCHES["k3batch"] == 2 and build.LAUNCHES["k1"] > 0
          and build.LAUNCHES["k2"] > 0,
          f"backend grid launches {dict(build.LAUNCHES)}")
    log(f"[15] split x fused grid {BACKEND_GRID} on conv2d at "
        f"{BACKEND_CYCLES}: every split lane equals its fused twin; "
        f"{wall_b:.3f} s wall; launches {dict(build.LAUNCHES)}")

    # ---- (c) every study of the golden file ------------------------------
    want = golden.load_perfmodel()["rows"]
    studies = {}
    for study in golden.perfmodel_calls():
        build.reset_launches()
        tms = {}
        kw = {"device": DEVICE}
        if study not in ("decode_efficiency", "train_efficiency"):
            kw["timings"] = tms
        t0 = time.perf_counter()
        rows = golden.perfmodel_rows(effective_bw, study, **kw)
        wall_s = time.perf_counter() - t0
        launched = {k: v for k, v in build.LAUNCHES.items() if v}
        check(rows == want[study], f"{study}: rows differ from the JAX "
              f"golden rows: got {rows}, want {want[study]}")
        if study == "cxl_tier_study":
            check(all(r["bit_identical"] for r in rows),
                  "cxl_tier_study: a lane is not bit-identical to its "
                  "per-cycle simulate")
            check(launched == {"k3batch": 1, "k3cyc": len(rows)},
                  f"cxl_tier_study launches {launched}")
        if study in ("llm_grid_study", "dvfs_llm_study"):
            check(launched == {"k3batch": 1}, f"{study}: {launched}")
        studies[study] = {"wall_s": wall_s, "launches": launched}
        log(f"[15] {study}: {len(rows) if isinstance(rows, list) else 1} "
            f"row(s) equal the JAX golden rows; {wall_s:.3f} s wall; "
            f"launches {launched}")
    out["studies"] = studies
    return out


# ---------------------------------------------- streaming and persistence --

#: phase 16(a): 4096 points of conv2d at 100k on the Table-1 device, so
#: ``sweep_grid`` streams by the default threshold (16 chunks of 256)
STREAM_GRID = {"tCL": [14, 16, 18, 20], "tRCDRD": [12, 14, 16, 18],
               "tRCDWR": [12, 14, 16, 18], "tRP": [12, 14, 16, 18],
               "queue_size": [16, 32, 64, 128],
               "page_policy": ["closed", "open"],
               "sched_policy": ["fcfs", "frfcfs"]}
STREAM_CYCLES = 100_000
#: 16(b): its tCL x tRCDRD x tRP x queue axes (256 points, the other axes
#: at the config's values), in chunks of 32, killed before chunk 4 commits
KILL_GRID = {k: STREAM_GRID[k] for k in ("tCL", "tRCDRD", "tRP",
                                         "queue_size")}
KILL_CHUNK = 32
KILL_AT = 4
#: 16(c): the warm re-invoke's sweep (4 points of conv2d at 20k), and the
#: one library its two processes build and load (K3's)
CACHE_GRID = {"tCL": [14, 18], "queue_size": [16, 128]}
CACHE_LIBS = ("fused",)
CACHE_CYCLES = 20_000
#: plain protocol steps of every lane of 16(a)'s slowest chunk, timed
#: after one warm-up step of its first 8 lanes
STREAM_PLAIN_STEPS = 2
#: the parts of a streamed sweep's wall that its timings name
STREAM_SPLIT = ("plan_s", "compile_s", "prep_s", "run_s", "results_s",
                "merge_s")
CHILD = ("import sys, chip_smoke; "
         "sys.exit(chip_smoke.stream_child(sys.argv[1:]))")


def table_digest(results):
    """SHA-256 of every lane's records, counters (sorted) and blocked
    totals, in grid order."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for r in results:
        for f in ("t_admit", "t_dispatch", "t_start", "t_complete",
                  "rdata"):
            h.update(np.ascontiguousarray(
                np.asarray(getattr(r, f), np.int32)).tobytes())
        for k in sorted(r.counters):
            h.update(np.ascontiguousarray(
                np.asarray(r.counters[k], np.int64)).tobytes())
        h.update(np.int64(r.blocked_arrival).tobytes())
        h.update(np.int64(r.blocked_dispatch).tobytes())
    return h.hexdigest()


def stream_child(args):
    """A streamed ``sweep_grid`` of conv2d on the card in this fresh
    process (phase 16(b) and (c)): ``mode`` (``kill``: SIGKILL from the
    pre-commit hook at chunk ``kill_at``; ``resume``: the sweep twice, the
    second restoring every chunk the first committed), a checkpoint
    directory (``-`` for none), the grid as JSON, cycles, chunk lanes,
    ``kill_at``. Prints ``RESULT`` and a JSON object a sweep."""
    import hashlib
    import os
    import signal

    import numpy as np
    from repro_torch import golden
    from repro_torch.core import MemSimConfig, aot_cache_stats, sweep_grid
    from repro_torch.core import sweep_stream
    from repro_torch.kernels import build
    from repro_torch.traces import BENCHMARKS

    mode, ckdir, grid = args[0], args[1], json.loads(args[2])
    cycles, chunk, kill_at = int(args[3]), int(args[4]), int(args[5])
    if mode in ("cold", "warm"):
        # 16(c): this process loads, and so builds, only the library its
        # sweep runs (K3's), not the whole set
        build._ENTRY_POINTS = {k: v for k, v in build._ENTRY_POINTS.items()
                               if k in CACHE_LIBS}
    if mode == "kill":
        def hook(ci):
            if ci >= kill_at:
                os.kill(os.getpid(), signal.SIGKILL)
        sweep_stream._pre_commit_hook = hook
    for _ in range(2 if mode == "resume" else 1):
        build.reset_launches()
        tm = {}
        t0 = time.perf_counter()
        res = sweep_grid(MemSimConfig(queue_size=golden.QUEUE_SIZE),
                         BENCHMARKS["conv2d"](), grid, cycles, stream=True,
                         chunk_lanes=chunk,
                         checkpoint_dir=None if ckdir == "-" else ckdir,
                         timings=tm, device=DEVICE)
        wall = time.perf_counter() - t0
        tc = hashlib.sha256(b"".join(
            np.ascontiguousarray(r.t_complete, np.int32).tobytes()
            for r in res)).hexdigest()
        print("RESULT " + json.dumps({
            "digest": table_digest(res), "tc": tc, "wall_s": wall,
            "chunks": tm["chunks"], "chunks_resumed": tm["chunks_resumed"],
            "launches": tm["launches"],
            "k3batch": build.LAUNCHES["k3batch"],
            "compiles": tm["compiles"], "compile_s": tm["compile_s"],
            "build_s": build.build_seconds(),
            "libraries": len(build._libs), "run_s": tm["run_s"],
            "prep_s": tm["prep_s"], "checkpoint_s": tm["checkpoint_s"],
            "cache": aot_cache_stats()}), flush=True)
    return 0


def run_child(label, mode, ckdir, grid, cycles, chunk, kill_at=-1,
              cache_dir=None):
    """``stream_child`` in a fresh process of this checkout's port (at most
    300 s). Returns (its exit code, its RESULT objects, wall s)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
    env.pop("MEMSIM_EXEC_CACHE_DIR", None)
    if cache_dir is not None:
        env["MEMSIM_EXEC_CACHE_DIR"] = str(cache_dir)
    t0 = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, "-c", CHILD, mode, str(ckdir), json.dumps(grid),
             str(cycles), str(chunk), str(kill_at)],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        raise CheckFailed(f"{label}: the child did not end within 300 s")
    wall = time.perf_counter() - t0
    outs = [json.loads(ln[len("RESULT "):]) for ln in p.stdout.splitlines()
            if ln.startswith("RESULT ")]
    if mode != "kill":
        check(p.returncode == 0 and len(outs) == (2 if mode == "resume"
                                                  else 1),
              f"{label}: child exit {p.returncode}\n{p.stderr[-3000:]}")
    return p.returncode, outs, wall


def phase_stream(drills):
    """16: streaming and persistence on the card (see the module
    docstring); before (b)'s children, phase 17(c)'s first two start
    beside them (a ``Drill`` appended to ``drills``). Returns the streamed
    K3's record for the kernels line."""
    import dataclasses
    import gc
    import shutil
    import signal
    import tempfile

    import torch
    from repro_torch import golden
    from repro_torch.checkpoint.store import SweepCheckpoint
    from repro_torch.core import MemSimConfig, sweep_grid, sweep_topologies
    from repro_torch.core.engine import (
        _sched_i32, fused_run_batch_plain, grid_points)
    from repro_torch.core.sweep_stream import lane_footprint_bytes
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.fused import fused_run_batch_cuda
    from repro_torch.traces import BENCHMARKS

    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    trace = BENCHMARKS["conv2d"]()
    out = {}

    # ---- (a) 4096 points, no streaming option: 16 chunks of 256 --------
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    tm = {}
    with LaunchTimer() as timer:
        t0 = time.perf_counter()
        streamed = sweep_grid(cfg, trace, STREAM_GRID, STREAM_CYCLES,
                              timings=tm, device=DEVICE)
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counted = dict(build.LAUNCHES)
    dev_ms = [s.elapsed_time(e) for s, e in timer.pairs]
    per = tm["per_chunk"]
    check(len(streamed) == 4096 and tm.get("streamed") is True
          and tm["chunks"] == 16 and tm["chunk_lanes"] == 256
          and tm["chunks_resumed"] == 0,
          f"16(a): {len(streamed)} lanes, timings "
          f"{ {k: v for k, v in tm.items() if k != 'per_chunk'} }")
    check(counted["k3batch"] == 16 == tm["launches"] == len(dev_ms)
          and sum(counted.values()) == 16,
          f"16(a): launches {counted}, timings {tm['launches']}, timed "
          f"{len(dev_ms)}; built for one k3batch launch a chunk")
    # a leak of chunks' device state would hold many chunks at once
    check(peak < 3 * tm["peak_chunk_bytes"],
          f"16(a): peak {peak} B allocated over 3 x peak_chunk_bytes "
          f"{tm['peak_chunk_bytes']}: chunks' device state is not freed")
    log(f"[16] (a) sweep_grid of {len(streamed)} points on conv2d at "
        f"{STREAM_CYCLES}, no streaming option: streamed in {tm['chunks']} "
        f"chunks of {tm['chunk_lanes']}, {counted['k3batch']} k3batch "
        f"launches and nothing else; {wall:.3f} s wall = plan "
        f"{tm['plan_s']:.3f} + compile {tm['compile_s']:.3f} + prep "
        f"{tm['prep_s']:.3f} + run {tm['run_s']:.3f} + results "
        f"{tm['results_s']:.3f} + merge {tm['merge_s']:.3f} + other "
        f"{wall - sum(tm[k] for k in STREAM_SPLIT):.3f} s; a chunk's prep {min(c['prep_s'] for c in per):.3f}-"
        f"{max(c['prep_s'] for c in per):.3f} s, wait "
        f"{min(c['run_s'] for c in per):.3f}-{max(c['run_s'] for c in per):.3f}"
        f" s, results {min(c['results_s'] for c in per):.3f}-"
        f"{max(c['results_s'] for c in per):.3f} s, longest lane "
        f"{min(c['steps'] for c in per)}-{max(c['steps'] for c in per)} "
        f"steps; device ms a chunk (CUDA events on its stream) "
        + ", ".join(f"{d:.1f}" for d in dev_ms)
        + f" (sum {sum(dev_ms):.1f}); peak allocated {peak} B against "
        f"peak_chunk_bytes {tm['peak_chunk_bytes']} ({tm['lane_bytes']} B "
        f"a lane reckoned, {peak / (2 * tm['chunk_lanes']):.0f} B a lane "
        f"of two chunks allocated: x"
        f"{peak / tm['peak_chunk_bytes']:.3f})")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tmm = {}
    t0 = time.perf_counter()
    mat = sweep_grid(cfg, trace, STREAM_GRID, STREAM_CYCLES, stream=False,
                     timings=tmm, device=DEVICE)
    wall_mat = time.perf_counter() - t0
    peak_mat = torch.cuda.max_memory_allocated() - base
    check("streamed" not in tmm, "16(a): stream=False streamed")
    bad = [i for i, (a, b) in enumerate(zip(mat, streamed))
           if same_lane(a, b)]
    check(len(mat) == 4096 and not bad,
          f"16(a): streamed lanes {bad[:8]} differ from stream=False")
    log(f"[16] (a) every streamed lane equals the stream=False run's; "
        f"stream=False: {wall_mat:.3f} s wall (set-up {tmm['setup_s']:.3f} "
        f"/ lanes {tmm['lanes_s']:.3f} / results {tmm['results_s']:.3f}), "
        f"{tmm['launches']} launch(es), peak allocated {peak_mat} B")
    del mat
    gc.collect()
    # the slowest chunk: its time a step of its longest lane, its lanes'
    # byte bound (fresh lanes rerun to the horizon) and its plain protocol
    # (STREAM_PLAIN_STEPS steps of every lane after a warm-up)
    slow = max(range(len(dev_ms)), key=lambda i: dev_ms[i])
    ci = per[slow]["chunk"]
    pts = grid_points(STREAM_GRID)[ci * 256:(ci + 1) * 256]
    cfgs = [dataclasses.replace(cfg, **p) for p in pts]
    lanes_args = (cfg, [trace] * len(pts), [c.queue_size for c in cfgs],
                  [_sched_i32(c.runtime()) for c in cfgs])
    topo, views, trs, states = batch_lanes(*lanes_args)
    _, steps, _ = fused_run_batch_cuda(topo, views, trs, states,
                                       STREAM_CYCLES)
    torch.cuda.synchronize()
    check(max(steps) == per[slow]["steps"],
          f"16(a): chunk {ci} rerun alone: {max(steps)} steps, in the "
          f"sweep {per[slow]['steps']}")
    nbytes = sum(run_bytes(v, tr, st) for v, tr, st
                 in zip(views, trs, states))
    del topo, views, trs, states
    topo, views, trs, states = batch_lanes(*lanes_args)
    fused_run_batch_plain(topo, views[:8], trs[:8], states[:8],
                          STREAM_CYCLES, 1, max_launches=1)
    topo, views, trs, states = batch_lanes(*lanes_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_run_batch_plain(topo, views, trs, states, STREAM_CYCLES,
                          STREAM_PLAIN_STEPS, max_launches=1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / STREAM_PLAIN_STEPS
    del topo, views, trs, states
    out.update({"launches": counted["k3batch"],
                "ms": dev_ms[slow] / per[slow]["steps"],
                "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3
                / per[slow]["steps"]})
    log(f"[16] (a) the slowest chunk ({ci}): {dev_ms[slow]:.3f} ms, "
        f"{per[slow]['steps']} steps of its longest lane = "
        f"{out['ms'] * 1e3:.3f} us/step; its 256 lanes' bytes {nbytes} B "
        f"at 3.35 TB/s = {out['bound_ms'] * 1e6:.3f} ns a step of its "
        f"longest lane; its plain protocol {plain_ms * 1e3:.1f} us wall a "
        f"step of its 256 lanes ({STREAM_PLAIN_STEPS} steps of every lane, "
        f"after one step of 8 to warm up)")

    # ---- (a') phase 15(a)'s grid under a budget of 4-lane chunks --------
    t_b = time.perf_counter()
    want = sweep_topologies(cfg, trace, TOPO_SWEEP_GRID, TOPO_SWEEP_CYCLES,
                            stream=False, device=DEVICE)
    lane_b = max(lane_footprint_bytes(t, trace.num_requests, 1)
                 for t in want.topologies)
    budget = 9 * lane_b
    build.reset_launches()
    tmt = {}
    got = sweep_topologies(cfg, trace, TOPO_SWEEP_GRID, TOPO_SWEEP_CYCLES,
                           stream=True, memory_budget_bytes=budget,
                           timings=tmt, device=DEVICE)
    check(tmt["chunk_lanes"] == 4 and tmt["chunks"] == 16
          and tmt["launches"] == build.LAUNCHES["k3batch"] == 16,
          f"16(a'): chunk_lanes {tmt['chunk_lanes']}, chunks "
          f"{tmt['chunks']}, launches {tmt['launches']} / "
          f"{dict(build.LAUNCHES)}")
    check((got.points, got.topologies, got.topo_of_point)
          == (want.points, want.topologies, want.topo_of_point),
          "16(a'): points or topologies differ from sweep_topologies'")
    bad = [i for i, (a, b) in enumerate(zip(want, got)) if same_lane(a, b)]
    check(not bad, f"16(a'): lanes {bad} differ from sweep_topologies'")
    log(f"[16] (a') phase 15(a)'s grid streamed under "
        f"memory_budget_bytes={budget} (9 x {lane_b} B): chunk_lanes 4, "
        f"{tmt['chunks']} chunks over {tmt['topologies']} topologies, "
        f"{tmt['launches']} launches; every lane equals sweep_topologies'; "
        f"{time.perf_counter() - t_b:.3f} s for both sweeps (streamed: "
        f"prep {tmt['prep_s']:.3f}, run {tmt['run_s']:.3f}, results "
        f"{tmt['results_s']:.3f} s)")

    # ---- (b) SIGKILL at chunk 4 in a child, resume, restore ------------
    drills.append(Drill())
    tmp_root = ROOT / "build" / "repro_torch"
    tmp_root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="phase16_", dir=tmp_root))
    try:
        ckdir = tmp / "ck"
        keep = [i for i, p in enumerate(grid_points(STREAM_GRID))
                if p["tRCDWR"] == cfg.tRCDWR and p["page_policy"] ==
                cfg.page_policy and p["sched_policy"] == cfg.sched_policy]
        want_digest = table_digest([streamed[i] for i in keep])
        check(len(keep) == 256, f"16(b): {len(keep)} lanes of (a)")
        rc, _, w_kill = run_child("16(b) kill", "kill", ckdir, KILL_GRID,
                                  STREAM_CYCLES, KILL_CHUNK, KILL_AT)
        done = SweepCheckpoint(str(ckdir)).done_chunks()
        check(rc == -signal.SIGKILL and done == list(range(KILL_AT)),
              f"16(b): the child exited {rc} (want -SIGKILL) with chunks "
              f"{done} committed (want 0-{KILL_AT - 1})")
        _, (res, again), w_res = run_child(
            "16(b) resume", "resume", ckdir, KILL_GRID, STREAM_CYCLES,
            KILL_CHUNK)
        check(res["chunks"] == 8 and res["chunks_resumed"] == KILL_AT
              and res["launches"] == res["k3batch"] == 8 - KILL_AT
              and res["digest"] == want_digest,
              f"16(b) resume: {res}; want 8 chunks, {KILL_AT} resumed, "
              f"{8 - KILL_AT} launches, the digest of (a)'s lanes")
        check(again["chunks_resumed"] == 8 and again["launches"] == 0
              and again["k3batch"] == 0 and again["digest"] == want_digest,
              f"16(b) restore: {again}")
        log(f"[16] (b) {len(keep)} points in chunks of {KILL_CHUNK}: a child "
            f"SIGKILLed before chunk {KILL_AT} commits ({w_kill:.1f} s) "
            f"leaves chunks {done}; a second child resumes ("
            f"{res['chunks_resumed']} restored, {res['launches']} launches, "
            f"run {res['run_s']:.3f} s, checkpoint {res['checkpoint_s']:.3f}"
            f" s) and sweeps again (8 restored, 0 launches), both equal to "
            f"(a)'s lanes, digest {want_digest[:16]} ({w_res:.1f} s for the "
            f"child)")

        # ---- (c) a warm re-invoke over one exec cache directory --------
        cache = tmp / "exec_cache"
        n_libs = len(CACHE_LIBS)
        _, (cold,), w_cold = run_child("16(c) cold", "cold", "-",
                                       CACHE_GRID, CACHE_CYCLES, 2,
                                       cache_dir=cache)
        _, (warm,), w_warm = run_child("16(c) warm", "warm", "-",
                                       CACHE_GRID, CACHE_CYCLES, 2,
                                       cache_dir=cache)
        cd, wd = cold["cache"]["disk"], warm["cache"]["disk"]
        check(cold["compiles"] >= 1 and cd["writes"] >= 1,
              f"16(c) cold: {cold}")
        check(warm["compiles"] == 0 and wd["hits"] >= n_libs
              and wd["errors"] == 0 and warm["tc"] == cold["tc"],
              f"16(c) warm: {warm}; cold {cold}")
        out["cold_nvcc_s"] = cold["build_s"]
        log(f"[16] (c) MEMSIM_EXEC_CACHE_DIR, two fresh processes: cold "
            f"{w_cold:.1f} s wall, {cold['compiles']} libraries built by "
            f"nvcc in {cold['build_s']:.1f} s (writes {cd['writes']}, "
            f"misses {cd['misses']}); warm {w_warm:.1f} s wall, compiles 0, "
            f"hits {wd['hits']} of {n_libs} libraries, errors "
            f"{wd['errors']}, load {wd['load_s']} s, compile_s "
            f"{warm['compile_s']:.3f}; t_complete digests equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------- LLM serve slice --

FLASH_SHAPES = [  # b, hq, s, d, hkv
    (1, 4, 128, 64, 4), (2, 8, 256, 64, 2), (1, 8, 256, 128, 8),
    (1, 10, 256, 128, 2),
    (2, 40, 1024, 128, 8), (2, 40, 128, 128, 8),  # phase 8's prefills
    (1, 10, 200, 128, 2)]  # ragged: no multiple of a block
DECODE_SHAPES = [  # b, hq, hkv, s, d
    (2, 8, 2, 512, 64), (1, 4, 4, 1024, 128), (4, 16, 2, 2048, 64),
    (3, 10, 2, 512, 128),
    (4, 40, 8, 256, 128), (2, 40, 8, 128, 128),  # phase 8's decode steps
    (4, 40, 8, 4096, 128),
    (2, 40, 8, 600, 128)]  # ragged: no multiple of a tile
PEAKED_FLASH_SHAPES = [(1, 10, 256, 128, 2), (2, 40, 1024, 128, 8)]
PEAKED_DECODE_SHAPES = [(4, 40, 8, 256, 128), (4, 40, 8, 4096, 128)]
ATTN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def float_err(a, b):
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    d = (a.to(torch.float32) - b.to(torch.float32)).abs()
    return float(d.max()) if torch.isfinite(d).all() else float("inf")


def randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen).to(DEVICE, dtype)


def phase_attention_kernels():
    import torch
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    gen = torch.Generator().manual_seed(12)
    errs = {"k5": 0.0, "k6": 0.0}
    n5 = n6 = 0
    for name, tol in ATTN_TOL.items():
        dt = getattr(torch, name)
        for b, hq, s, d, hkv in FLASH_SHAPES:
            q = randn(gen, (b, hq, s, d), dt)
            k = randn(gen, (b, hkv, s, d), dt)
            v = randn(gen, (b, hkv, s, d), dt)
            for causal in (True, False):
                e = float_err(flash_attention_cuda(q, k, v, causal),
                              gqa_attention_ref(q, k, v, causal))
                check(e <= tol, f"K6 != plain at {(b, hq, s, d, hkv)} "
                      f"causal={causal} {name}: max abs err {e}")
                errs["k6"] = max(errs["k6"], e)
                n6 += 1
        for b, hq, hkv, s, d in DECODE_SHAPES:
            q = randn(gen, (b, hq, d), dt)
            k = randn(gen, (b, hkv, s, d), dt)
            v = randn(gen, (b, hkv, s, d), dt)
            for draw in range(2):
                lens = torch.randint(1, s + 1, (b,), generator=gen,
                                     dtype=torch.int32)
                lens[0 if draw == 0 else -1] = 1 if draw == 0 else s
                lens = lens.to(DEVICE)
                e = float_err(decode_attention_cuda(q, k, v, lens),
                              decode_attention_ref(q, k, v, lens))
                check(e <= tol, f"K5 != plain at {(b, hq, hkv, s, d)} "
                      f"{name} kv_len={lens.tolist()}: max abs err {e}")
                errs["k5"] = max(errs["k5"], e)
                n5 += 1
    # peaked logits in bfloat16: q scaled by 8, so the logits span about
    # +-30 and P is near one-hot, where K6 rounds P to bf16 before P V
    bf16, tol = torch.bfloat16, ATTN_TOL["bfloat16"]
    span = 0.0
    for b, hq, s, d, hkv in PEAKED_FLASH_SHAPES:
        q = 8 * randn(gen, (b, hq, s, d), bf16)
        k = randn(gen, (b, hkv, s, d), bf16)
        v = randn(gen, (b, hkv, s, d), bf16)
        span = max(span, float((q[:, ::hq // hkv].float() @ k.float(
        ).transpose(-1, -2)).abs().max()) / d ** 0.5)
        for causal in (True, False):
            e = float_err(flash_attention_cuda(q, k, v, causal),
                          gqa_attention_ref(q, k, v, causal))
            check(e <= tol, f"K6 != plain at {(b, hq, s, d, hkv)} "
                  f"causal={causal} peaked bf16: max abs err {e}")
            errs["k6"] = max(errs["k6"], e)
            n6 += 1
    for b, hq, hkv, s, d in PEAKED_DECODE_SHAPES:
        q = 8 * randn(gen, (b, hq, d), bf16)
        k = randn(gen, (b, hkv, s, d), bf16)
        v = randn(gen, (b, hkv, s, d), bf16)
        lens = torch.randint(1, s + 1, (b,), generator=gen, dtype=torch.int32)
        lens[0], lens[-1] = 1, s
        lens = lens.to(DEVICE)
        e = float_err(decode_attention_cuda(q, k, v, lens),
                      decode_attention_ref(q, k, v, lens))
        check(e <= tol, f"K5 != plain at {(b, hq, hkv, s, d)} peaked bf16 "
              f"kv_len={lens.tolist()}: max abs err {e}")
        errs["k5"] = max(errs["k5"], e)
        n5 += 1
    # kv_len = 0 gives 0 (as the Pallas kernel), never NaN
    q = randn(gen, (2, 40, 128), bf16)
    k = randn(gen, (2, 8, 256, 128), bf16)
    got = decode_attention_cuda(q, k, k, torch.tensor(
        [0, 77], dtype=torch.int32, device=DEVICE))
    check(bool((got[0] == 0).all()) and bool(torch.isfinite(got).all()),
          "K5 with kv_len = 0 is not 0")
    torch.cuda.synchronize()
    log(f"[7] K5 == plain within tolerance on {n5} cases over "
        f"{len(DECODE_SHAPES)} shapes and {len(PEAKED_DECODE_SHAPES)} peaked "
        f"(max abs err {errs['k5']:.3g}), 0 at kv_len = 0; K6 on {n6} cases "
        f"over {len(FLASH_SHAPES)} shapes and {len(PEAKED_FLASH_SHAPES)} "
        f"peaked (max abs err {errs['k6']:.3g}; peaked logits up to "
        f"+-{span:.1f}); float32 1e-5, bfloat16 2e-2")
    return errs


def phase_serve():
    """The serve path of the LLM stack at qwen3-14b's full width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.launch.steps import make_decode_step, make_prefill
    from repro_torch.models import lm, registry

    bf16 = torch.bfloat16
    cfg = get_config("qwen3-14b")
    check(cfg.n_layers == 40 and cfg.d_model == 5120,
          "qwen3-14b config is not the full-width one")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = lm.init_params(cfg, gen, device=DEVICE, dtype=bf16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[8] qwen3-14b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params / 1e9:.3f} B parameters, "
        f"{n_bytes / 1e9:.2f} GB on the card, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(1)

    # prefill: 2 prompts of 1024 tokens
    prefill = make_prefill(cfg, dtype=bf16)
    toks = torch.randint(1, cfg.vocab, (2, 1024), generator=gen)
    prefill(params, {"tokens": toks})  # warm-up: cuBLAS handles, kernels
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre_launches = dict(build.LAUNCHES)
    check(pre_launches["k6"] == cfg.n_layers and pre_launches["k5"] == 0,
          f"prefill launched {pre_launches}, want K6 = {cfg.n_layers}")
    check(logits.shape == (2, cfg.vocab) and bool(torch.isfinite(
        logits).all()), "prefill logits are not finite [2, vocab]")
    check(len(caches) == cfg.n_layers and caches[0]["k"].shape
          == (2, cfg.n_kv_heads, 1024, cfg.head_dim), "prefill caches")
    del caches
    log(f"[8] prefill B=2 S=1024: {prefill_ms:.1f} ms wall, K6 launches "
        f"{pre_launches['k6']} (= {cfg.n_layers} layers)")

    # serve: 8 requests through 4 slots
    decode = make_decode_step(cfg, dtype=bf16)
    batch, max_seq = 4, 256
    prompts, news = make_requests(0, cfg.vocab, 8, 64, 64)
    caches = registry.init_caches(cfg, batch, max_seq, dtype=bf16)
    decode(params, caches, torch.zeros(batch, dtype=torch.int32),
           torch.zeros(batch, dtype=torch.int32))  # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    outputs, joined, steps = serve_loop(decode, params, caches, prompts,
                                        news, batch, max_seq=max_seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = dict(build.LAUNCHES)
    check(serve_launches["k5"] == cfg.n_layers * steps
          and serve_launches["k6"] == 0,
          f"serve launched {serve_launches}, want K5 = {cfg.n_layers} x "
          f"{steps} steps")
    check(all(o is not None and len(o) == n
              and all(0 <= t < cfg.vocab for t in o)
              for o, n in zip(outputs, news)), "serve outputs")
    tokens = sum(len(p) for p in prompts) + sum(news)
    log(f"[8] serve 8 requests / 4 slots (prompts {min(map(len, prompts))}"
        f"-{max(map(len, prompts))}, max_new {min(news)}-{max(news)}, "
        f"max_seq {max_seq}): {steps} steps in {wall:.2f} s, "
        f"{wall / steps * 1e3:.2f} ms per decode step, {tokens / wall:.0f} "
        f"tok/s ({sum(news) / wall:.0f} generated tok/s); joins {joined}; "
        f"K5 launches {serve_launches['k5']} = {cfg.n_layers} x {steps}")
    del caches
    decode_profile(decode, params, cfg, batch, max_seq)

    # the serving invariant: decode reproduces teacher forcing
    toks = torch.randint(1, cfg.vocab, (2, 128), generator=gen)
    ref_last, _ = prefill(params, {"tokens": toks})
    errs = {}
    for backend in ("kernel", "plain"):
        step = make_decode_step(cfg, dtype=bf16, backend=backend)
        caches = registry.init_caches(cfg, 2, 128, dtype=bf16)
        for t in range(128):
            _, last, caches = step(params, caches, toks[:, t],
                                   torch.full((2,), t, dtype=torch.int32))
        errs[backend] = float((last - ref_last).abs().max())
        del caches
    scale = float(ref_last.abs().max())
    bound = 1.5 * errs["plain"] + 1e-3 * scale
    check(errs["kernel"] <= bound, f"decode with kernels is off teacher "
          f"forcing by {errs['kernel']}, bound {bound}")
    log(f"[8] invariant, 2 x 128 tokens: max |decode - prefill| logit "
        f"kernels {errs['kernel']:.4f}, plain {errs['plain']:.4f} (max "
        f"|logit| {scale:.3f}; bound 1.5 x plain + 1e-3 x max = "
        f"{bound:.4f})")
    log(f"[8] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    del params
    torch.cuda.empty_cache()
    return {"k5": serve_launches["k5"], "k6": pre_launches["k6"]}


def decode_profile(decode, params, cfg, batch, max_seq, phase="8",
                   steps=8):
    """Where a served decode step's time goes: ``steps`` steps at the
    serve shape (positions 64..), each ending in the host read of the next
    tokens as in ``serve_loop``; untraced wall, then a torch.profiler trace
    (device time, kernels and the largest kernels per step), beside the
    weight-streaming floor (every parameter byte read once a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import registry

    caches = registry.init_caches(cfg, batch, max_seq, dtype=torch.bfloat16)
    tok = torch.ones(batch, dtype=torch.int32)

    def run():
        for i in range(steps):
            pos = torch.full((batch,), 64 + i, dtype=torch.int32)
            nxt, _, _ = decode(params, caches, tok, pos)
            nxt.cpu()

    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    dev = device_rows(prof)
    if not dev:
        log(f"[{phase}] decode-step device trace: no device events recorded "
            f"(not measured)")
        return
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    dev_us = sum(e.self_device_time_total for e in dev) / steps
    kernels = sum(e.count for e in dev) / steps
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    log(f"[{phase}] decode step at the serve shape (B={batch}, positions "
        f"64-{64 + steps - 1}): {wall * 1e3:.2f} ms wall untraced, "
        f"{kernels:.0f} device kernels and {dev_us / 1e3:.2f} ms device "
        f"time per step, device busy {dev_us * 1e-6 / wall:.1%} of the wall; "
        f"weight-streaming floor {n_bytes / 1e9:.2f} GB / 3.35 TB/s = "
        f"{n_bytes / HBM_BYTES_PER_S * 1e3:.2f} ms")
    log(f"[{phase}] largest per step: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / steps:.0f} us "
        f"x{e.count // steps}" for e in top))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_attention_times():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(99)
    out = {}
    b, hq, hkv, d = 4, 40, 8, 128
    for label, s, lens in (("served", 256, [120, 128, 128, 136]),
                           ("S4096", 4096, [4096] * 4)):
        q = randn(gen, (b, hq, d), bf16)
        k = randn(gen, (b, hkv, s, d), bf16)
        v = randn(gen, (b, hkv, s, d), bf16)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
        mask = (torch.arange(s, device=DEVICE)[None, None, None, :]
                < kv_len[:, None, None, None])
        q4 = q[:, :, None]
        ms = device_ms(lambda: decode_attention_cuda(q, k, v, kv_len))
        plain_ms = device_ms(lambda: decode_attention_ref(q, k, v, kv_len))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True))
        call_ms = median_ms(lambda: decode_attention_cuda(q, k, v, kv_len))
        nbytes = (2 * sum(lens) * hkv * d + 2 * b * hq * d) * 2 + 4 * b
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out["k5_" + label] = (ms, plain_ms, bound, "bytes", lib_ms)
        log(f"[9] K5 B={b} Hq={hq} Hkv={hkv} D={d} S={s} kv_len={lens} "
            f"bf16: device {ms * 1e3:.2f} us/launch (plain "
            f"{plain_ms * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us, "
            f"{ms / lib_ms:.2f}x sdpa); eager "
            f"call {call_ms * 1e3:.2f} us; bound {bound * 1e3:.2f} us "
            f"({nbytes} B at 3.35 TB/s, {bound / ms:.0%} of it)")
    # K6: the qwen3 prefill's shape (main path), a long prompt, float32
    for label, b, s, dt in (("k6", 2, 1024, bf16), ("k6_S4096", 1, 4096, bf16),
                            ("k6_f32", 2, 1024, torch.float32)):
        q = randn(gen, (b, hq, s, d), dt)
        k = randn(gen, (b, hkv, s, d), dt)
        v = randn(gen, (b, hkv, s, d), dt)
        ms = device_ms(lambda: flash_attention_cuda(q, k, v, True),
                       per_graph=20 if dt == bf16 else 2)
        plain_ms = device_ms(lambda: gqa_attention_ref(q, k, v, True),
                             per_graph=2, replays=10)
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
            per_graph=20 if dt == bf16 else 2)
        flops = 4 * b * hq * d * s * (s + 1) // 2
        nbytes = (2 * b * hq * s * d + 2 * b * hkv * s * d) * q.element_size()
        rate, rate_name = ((BF16_FLOPS_PER_S, "989 TFLOP/s bf16") if dt == bf16
                           else (F32_FLOPS_PER_S, "67 TFLOP/s float32"))
        t_ops = flops / rate * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        out[label] = (ms, plain_ms, bound, by, lib_ms)
        log(f"[9] K6 B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal "
            f"{str(dt)[6:]}: device {ms * 1e3:.1f} us/launch (plain "
            f"{plain_ms * 1e3:.1f} us, sdpa {lib_ms * 1e3:.1f} us, "
            f"{ms / lib_ms:.2f}x sdpa); bound {bound * 1e3:.2f} us "
            f"({flops / 1e9:.2f} GFLOP at {rate_name} = {t_ops * 1e3:.2f} "
            f"us, {nbytes} B at 3.35 TB/s = {t_bytes * 1e3:.2f} us; {by}; "
            f"{bound / ms:.1%} of it)")
    return out


# ------------------------------------------- hybrid serve slice (jamba) --

SCAN_SHAPES = [  # b, t, d, s
    (2, 64, 32, 8), (1, 512, 512, 16), (3, 128, 64, 16),  # the JAX tests
    (2, 1024, 8192, 16),  # phase 11's prefill (jamba's d_inner, d_state)
    (2, 128, 8192, 16),   # phase 11's invariant prefill
    (2, 200, 600, 16),    # ragged: no multiple of a chunk or channel block
    (1, 1, 600, 8), (1, 33, 600, 8),  # one step; a chunk and one step
    # rows that are not whole 16-byte pieces: staged by plain loads
    (2, 33, 601, 8), (1, 100, 36, 16)]
#: a long scan with dt * A near 0, so that h accumulates over every step:
#: (b, t, d, s) and the factor on the draw's dt and A
SCAN_LONG = ((1, 4096, 256, 16), 0.01)
#: K7 against its plain version: float32 max abs error relative to max |y|
#: (resp. max |h|), which leaves room for 1024 steps of accumulated
#: rounding in another order (fused multiply-adds, the shuffle sum);
#: bfloat16 inputs |kernel - plain| <= 2e-2 + 2e-2 |plain| per element of
#: y and of h: one rounding of y at its size, and the kernel's float32
#: dt * x (the plain version, as the jnp oracle, multiplies in bfloat16)
SCAN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: H100 SXM: 16 exp per clock per SM on the special-function units, 132
#: SMs, 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9
F32_FLOPS_PER_S = 67e12  # H100 SXM published float32 rate (no tensor cores)
#: the decode chain's Mamba state h after 128 steps against K7's h_final
#: from the 128-token prefill: max abs error relative to max |h| per
#: layer. The two differ by rounding upstream of the scan (a 1-token
#: against a 128-token product at every layer): in bfloat16 ~1% of max |h|
#: (held on the layers before the first MoE FFN), in float32 far less; a
#: wrong h_final (transposed, zero, another row's) misses by ~100%
MAMBA_STATE_TOL = {"bfloat16": 5e-2, "float32": 1e-3}
#: the recurrent state of each mixer that ``decode_vs_prefill`` compares
STATE_KEY = {"mamba": "h", "mlstm": "c", "slstm": "c"}


def scan_inputs(gen, b, t, d, s, dtype):
    """The JAX test's draw: x ~ N(0, 0.25), dt = 0.1 |N|, B, C ~ N(0, 1),
    a = -|N| - 0.1 (float32)."""
    import torch

    x = (torch.randn((b, t, d), generator=gen) * 0.5).to(DEVICE, dtype)
    dt = (torch.randn((b, t, d), generator=gen).abs() * 0.1).to(DEVICE,
                                                                dtype)
    bc = torch.randn((b, t, s), generator=gen).to(DEVICE, dtype)
    cc = torch.randn((b, t, s), generator=gen).to(DEVICE, dtype)
    a = (-torch.randn((d, s), generator=gen).abs() - 0.1).to(DEVICE)
    return x, dt, bc, cc, a


def scan_check(got, want, dtype_name):
    """(max abs error, whether it is within SCAN_TOL) of one K7 output."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf"), False
    w = want.to(torch.float32)
    d = (got.to(torch.float32) - w).abs()
    if not bool(torch.isfinite(d).all()):
        return float("inf"), False
    tol = SCAN_TOL[dtype_name]
    if dtype_name == "float32":
        return float(d.max()), float(d.max()) <= tol * float(w.abs().max())
    return float(d.max()), bool((d <= tol + tol * w.abs()).all())


def scan_staging(x, dt, bc, cc, a):
    """How K7 stages these inputs (csrc/selective_scan.cu vec_ok): "bulk
    copies" where every operand is 16-byte aligned and the rows of x, dt
    (D values) and of B, C (S values) are whole 16-byte pieces, else
    "plain loads"."""
    esize = x.element_size()
    vec = (all(v.data_ptr() % 16 == 0 for v in (x, dt, bc, cc))
           and x.shape[-1] * esize % 16 == 0
           and bc.shape[-1] * esize % 16 == 0)
    return "bulk copies" if vec else "plain loads"


def phase_scan_kernel():
    """K7 against its plain version on the card, y and h_final."""
    import torch
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_cuda)

    gen = torch.Generator().manual_seed(13)
    worst = 0.0
    n = 0
    long_shape, factor = SCAN_LONG
    for name in SCAN_TOL:
        dt_ = getattr(torch, name)
        paths = set()
        for b, t, d, s in SCAN_SHAPES + [long_shape]:
            ins = scan_inputs(gen, b, t, d, s, dt_)
            if (b, t, d, s) == long_shape:
                x, dt, bc, cc, a = ins
                ins = x, (dt.float() * factor).to(dt_), bc, cc, a * factor
            path = scan_staging(*ins)
            paths.add(path)
            got = selective_scan_cuda(*ins)
            want = selective_scan_ref(*ins)
            torch.cuda.synchronize()
            errs = {}
            for what, g, w in (("y", got[0], want[0]),
                               ("h", got[1], want[1])):
                # h_final is float32 in both dtypes, but from bfloat16
                # inputs it carries the kernel's other rounding of dt * x
                e, ok = scan_check(g, w, name)
                check(ok, f"K7 {what} != plain at {(b, t, d, s)} {name}: "
                      f"max abs err {e} (max |{what}| "
                      f"{float(w.float().abs().max())})")
                errs[what] = e
                worst = max(worst, e)
            log(f"[10] K7 {(b, t, d, s)} {name} ({path}): max abs err y "
                f"{errs['y']:.3g} (max |y| "
                f"{float(want[0].float().abs().max()):.3g}), h "
                f"{errs['h']:.3g} (max |h| "
                f"{float(want[1].abs().max()):.3g})")
            n += 1
        check(len(paths) == 2, f"K7 {name} cases took only {paths}")
    log(f"[10] K7 == plain within tolerance on {n} cases over "
        f"{len(SCAN_SHAPES) + 1} shapes, the last {long_shape} with dt and A "
        f"x {factor} (max abs err {worst:.3g}); float32 "
        f"{SCAN_TOL['float32']} x max |y| (resp. |h|), bfloat16 2e-2 + "
        f"2e-2 |y| (resp. |h|)")
    return worst


JAMBA_LAYERS = 8  # one period of jamba's 32: every layer kind, one card


def phase_jamba():
    """The hybrid serve path at jamba-v0.1's full width, depth cut to one
    period (8 layers: 7 Mamba, 1 attention; 4 dense, 4 MoE FFNs)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.launch.steps import make_decode_step, make_prefill
    from repro_torch.models import lm, registry

    bf16 = torch.bfloat16
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    check(cfg.d_model == 4096 and cfg.ssm_expand * cfg.d_model == 8192
          and cfg.ssm_d_state == 16 and cfg.n_experts == 16
          and cfg.top_k == 2 and cfg.d_ff == 14336 and cfg.vocab == 65536,
          "jamba-v0.1-52b config is not the full-width one")
    kinds = lm.layer_kinds(cfg)
    n_mamba = sum(m == "mamba" for m, _ in kinds)
    n_attn = len(kinds) - n_mamba
    torch.cuda.synchronize()
    log(f"[11] device memory before jamba: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated (qwen3-14b "
        f"freed)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = lm.init_params(cfg, gen, device=DEVICE, dtype=bf16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[11] jamba-v0.1-52b depth {cfg.n_layers} of {full.n_layers} "
        f"({n_mamba} Mamba + {n_attn} attention; FFNs "
        f"{''.join(f[0] for _, f in kinds)}), d_model {cfg.d_model}, "
        f"d_inner {cfg.ssm_expand * cfg.d_model}, d_state "
        f"{cfg.ssm_d_state}, {cfg.n_experts} experts top-{cfg.top_k}, vocab "
        f"{cfg.vocab}: {n_params / 1e9:.3f} B parameters, "
        f"{n_bytes / 1e9:.2f} GB on the card, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(3)

    # prefill: 2 prompts of 1024 tokens
    prefill = make_prefill(cfg, dtype=bf16)
    toks = torch.randint(1, cfg.vocab, (2, 1024), generator=gen)
    prefill(params, {"tokens": toks})  # warm-up
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = dict(build.LAUNCHES)
    check(pre["k7"] == n_mamba and pre["k6"] == n_attn and pre["k5"] == 0,
          f"prefill launched {pre}, want K7 = {n_mamba}, K6 = {n_attn}")
    check(logits.shape == (2, cfg.vocab) and bool(torch.isfinite(
        logits).all()), "prefill logits are not finite [2, vocab]")
    di = cfg.ssm_expand * cfg.d_model
    for (m, _), c in zip(kinds, caches):
        want = ({"h": (2, di, cfg.ssm_d_state), "conv": (2, 3, di)}
                if m == "mamba" else
                {"k": (2, cfg.n_kv_heads, 1024, cfg.head_dim),
                 "v": (2, cfg.n_kv_heads, 1024, cfg.head_dim)})
        check({k: tuple(v.shape) for k, v in c.items()} == want
              and all(bool(torch.isfinite(v.float()).all())
                      for v in c.values()), f"prefill {m} cache")
    del caches
    log(f"[11] prefill B=2 S=1024: {prefill_ms:.1f} ms wall, K7 launches "
        f"{pre['k7']} (= {n_mamba} Mamba layers), K6 launches {pre['k6']}")

    # serve: 8 requests through 4 slots
    decode = make_decode_step(cfg, dtype=bf16)
    batch, max_seq = 4, 256
    prompts, news = make_requests(0, cfg.vocab, 8, 64, 64)
    caches = registry.init_caches(cfg, batch, max_seq, dtype=bf16)
    decode(params, caches, torch.zeros(batch, dtype=torch.int32),
           torch.zeros(batch, dtype=torch.int32))  # warm-up
    caches = registry.init_caches(cfg, batch, max_seq, dtype=bf16)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    outputs, joined, steps = serve_loop(decode, params, caches, prompts,
                                        news, batch, max_seq=max_seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = dict(build.LAUNCHES)
    check(served["k5"] == n_attn * steps and served["k6"] == 0
          and served["k7"] == 0,
          f"serve launched {served}, want K5 = {n_attn} x {steps} steps")
    check(all(o is not None and len(o) == n
              and all(0 <= t < cfg.vocab for t in o)
              for o, n in zip(outputs, news)), "serve outputs")
    tokens = sum(len(p) for p in prompts) + sum(news)
    log(f"[11] serve 8 requests / 4 slots (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, max_new "
        f"{min(news)}-{max(news)}, max_seq {max_seq}): {steps} steps in "
        f"{wall:.2f} s, {wall / steps * 1e3:.2f} ms per decode step, "
        f"{tokens / wall:.0f} tok/s ({sum(news) / wall:.0f} generated "
        f"tok/s); joins {joined}; K5 launches {served['k5']} = {n_attn} x "
        f"{steps}")
    del caches
    decode_profile(decode, params, cfg, batch, max_seq, phase="11")

    # the serving invariant, and the Mamba state against K7's h_final
    toks = torch.randint(1, cfg.vocab, (2, 128), generator=gen)
    errs, scale, state, drops = decode_vs_prefill(cfg, params, toks,
                                                  ("kernel", "plain"), bf16)
    bound = 1.5 * errs["plain"] + 1e-3 * scale
    log(f"[11] invariant, 2 x 128 tokens: max |decode - prefill| logit "
        f"kernels {errs['kernel']:.4f}, plain {errs['plain']:.4f} (max "
        f"|logit| {scale:.3f}; bound 1.5 x plain + 1e-3 x max = "
        f"{bound:.4f}); the prefill's MoE layers drop "
        + ", ".join(f"{d:.1%}" for d in drops) + " of their assignments "
        f"(capacity factor {cfg.capacity_factor}), decode's none")
    log(f"[11] Mamba state after 128 decode steps vs K7's h_final of the "
        f"128-token prefill, per Mamba layer max abs err / max |h|: "
        + ", ".join(f"{e:.3g}/{m:.3g}" for e, m in state.values()))
    check(errs["kernel"] <= bound, f"jamba decode with kernels is off "
          f"teacher forcing by {errs['kernel']}, bound {bound}")
    # past an MoE FFN a layer's input differs between prefill and decode
    # by more than rounding: the prefill drops assignments past capacity,
    # and bfloat16 rounding flips near-tied top-2 choices
    clean = [i for i in state if all(f != "moe" for _, f in kinds[:i])]
    worst = max(state[i][0] / state[i][1] for i in clean)
    check(worst <= MAMBA_STATE_TOL["bfloat16"], f"Mamba state of layers "
          f"{clean} after 128 decode steps is off K7's h_final by "
          f"{worst:.3g} x max |h| (bound {MAMBA_STATE_TOL['bfloat16']})")
    # float32, with room for every assignment: prefill and decode compute
    # one function, so every layer's state and the logits are held tight
    roomy = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                / cfg.top_k)
    errs32, scale32, state32, drops32 = decode_vs_prefill(
        roomy, params, toks, ("kernel",), torch.float32)
    worst32 = max(e / m for e, m in state32.values())
    log(f"[11] float32, capacity factor {roomy.capacity_factor} (prefill "
        f"drops " + ", ".join(f"{d:.1%}" for d in drops32) + "): max "
        f"|decode - prefill| logit {errs32['kernel']:.3g} (max |logit| "
        f"{scale32:.3f}); Mamba state per layer max abs err / max |h|: "
        + ", ".join(f"{e:.3g}/{m:.3g}" for e, m in state32.values()))
    check(max(drops32) == 0, f"capacity factor {roomy.capacity_factor} "
          f"still drops {drops32}")
    check(errs32["kernel"] <= 1e-3 * scale32, f"float32 decode is off "
          f"teacher forcing by {errs32['kernel']} (bound 1e-3 x max |logit|"
          f" = {1e-3 * scale32})")
    check(worst32 <= MAMBA_STATE_TOL["float32"], f"float32 Mamba state "
          f"after 128 decode steps is off K7's h_final by {worst32:.3g} x "
          f"max |h| (bound {MAMBA_STATE_TOL['float32']})")
    log(f"[11] Mamba state vs K7's h_final: bfloat16 worst {worst:.3g} x "
        f"max |h| over layers {clean} (before the first MoE FFN; bound "
        f"{MAMBA_STATE_TOL['bfloat16']}), float32 without drops "
        f"{worst32:.3g} over all {len(state32)} (bound "
        f"{MAMBA_STATE_TOL['float32']})")
    log(f"[11] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    del params
    torch.cuda.empty_cache()
    return {"k5": served["k5"], "k6": pre["k6"], "k7": pre["k7"]}


def decode_vs_prefill(cfg, params, toks, backends, dtype):
    """Teacher-force ``toks`` [B, T] through T decode steps with each
    backend and through one prefill, in ``dtype``. Returns (max |decode - prefill| of
    the last logits per backend, max |prefill logit|, {Mamba layer: (max
    |h_decode - h_prefill| after the last step of the first backend, max
    |h_prefill|)} (and the same of an mLSTM or sLSTM layer's c), the
    prefill's MoE drop fraction per MoE layer)."""
    import torch
    from repro_torch.launch.steps import make_decode_step, make_prefill
    from repro_torch.models import lm, moe, registry

    drops = []
    routed = moe.moe_forward

    def recorded(p, x, c):
        out, metrics = routed(p, x, c)
        drops.append(float(metrics["drop_frac"]))
        return out, metrics

    moe.moe_forward = recorded
    try:
        ref_last, ref_caches = make_prefill(cfg, dtype=dtype)(
            params, {"tokens": toks})
    finally:
        moe.moe_forward = routed
    b, t = toks.shape
    errs, state = {}, {}
    for backend in backends:
        step = make_decode_step(cfg, dtype=dtype, backend=backend)
        caches = registry.init_caches(cfg, b, t, dtype=dtype)
        for i in range(t):
            _, last, caches = step(params, caches, toks[:, i],
                                   torch.full((b,), i, dtype=torch.int32))
        errs[backend] = float((last - ref_last).abs().max())
        if not state:
            state = {i: (float((c[key] - r[key]).abs().max()),
                         float(r[key].abs().max()))
                     for i, ((m, _), c, r) in enumerate(zip(
                         lm.layer_kinds(cfg), caches, ref_caches))
                     for key in [STATE_KEY.get(m)] if key}
    return errs, float(ref_last.abs().max()), state, drops


def addr_configs():
    """K4's topologies: the paper's Table-1 device, two channels, and two
    tiered placements (interleave_log2, cxl_frac_log2) of a DRAM + CXL
    box."""
    from repro_torch.core.params import MemSimConfig

    tiered = dict(channels=2, tiers=2, cxl_channels=1)
    return {"table1": MemSimConfig(), "channels=2": MemSimConfig(channels=2),
            "tiered(6,1)": MemSimConfig(tier_interleave_log2=6,
                                        tier_cxl_frac_log2=1, **tiered),
            "tiered(8,2)": MemSimConfig(tier_interleave_log2=8,
                                        tier_cxl_frac_log2=2, **tiered)}


def phase_addr_map():
    """K4's path (its entry point on the four benchmark traces' address
    columns at the Table-1 topology), then K4 against its plain version,
    bit for bit, on every topology of ``addr_configs`` and address set."""
    import torch
    from repro_torch.core.params import MemSimConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.addr_map.ops import addr_map
    from repro_torch.kernels.addr_map.ref import addr_map_ref
    from repro_torch.traces import BENCHMARKS

    sets = {name: BENCHMARKS[name]().addr.to(DEVICE)
            for name in sorted(BENCHMARKS)}
    cfg = MemSimConfig()
    build.reset_launches()
    hists = {name: addr_map(cfg, a)[3] for name, a in sets.items()}
    torch.cuda.synchronize()
    launches = build.LAUNCHES["k4"]
    check(launches == len(sets), f"K4 launches {launches} on "
          f"{len(sets)} traces")
    for name, h in hists.items():
        check(int(h.sum()) == sets[name].numel(), f"{name}: histogram "
              f"total {int(h.sum())} != {sets[name].numel()} addresses")
    log(f"[12] K4 path: the four traces' addresses at the Table-1 topology "
        f"({', '.join(f'{k} {v.numel()}' for k, v in sets.items())}), K4 "
        f"launches {launches}")

    gen = torch.Generator().manual_seed(4)
    for n in (1, 1000, 4096, (1 << 20) + 3):
        # the whole int32 range: negative addresses test the arithmetic >>
        sets[f"random{n}"] = torch.randint(
            -(1 << 31), (1 << 31) - 1, (n,), generator=gen,
            dtype=torch.int32).to(DEVICE)
    counted = dict(build.LAUNCHES)
    cases, worst = 0, 0
    for cname, c in addr_configs().items():
        flags = None if c.tiers == 1 else torch.tensor(
            [c.tier_interleave_log2, c.tier_cxl_frac_log2],
            dtype=torch.int32, device=DEVICE)
        for aname, a in sets.items():
            got = addr_map(c, a)
            want = addr_map_ref(c, a, flags)
            for what, g, w in zip(("bank", "rank", "row", "hist"), got,
                                  want):
                e = max_err(g, w) if g.dtype == w.dtype else float("inf")
                check(e == 0, f"K4 {what} != plain on {aname} at {cname} "
                      f"(max abs err {e})")
                worst = max(worst, e)
            cases += 1
    build.LAUNCHES.update(counted)
    log(f"[12] K4 == plain bit for bit on {cases} cases ({len(sets)} "
        f"address sets x {len(addr_configs())} topologies: "
        f"{', '.join(addr_configs())})")
    return launches, worst


def phase_hybrid_times():
    """Device time per launch of K4 at N = 2^24 and K7 at the jamba
    prefill shape, beside their plain versions and bounds."""
    import torch
    from repro_torch.core.params import MemSimConfig
    from repro_torch.kernels.addr_map.addr_map import addr_map_cuda
    from repro_torch.kernels.addr_map.ref import addr_map_ref
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_cuda)

    gen = torch.Generator().manual_seed(5)
    out = {}
    cfg = MemSimConfig()
    n = 1 << 24
    addr = torch.randint(0, 1 << 30, (n,), generator=gen,
                         dtype=torch.int32).to(DEVICE)
    ms = device_ms(lambda: addr_map_cuda(cfg, addr))
    plain_ms = device_ms(lambda: addr_map_ref(cfg, addr), per_graph=5,
                         replays=20)
    nbytes = 16 * n + 4 * cfg.num_banks
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    out["k4"] = (ms, plain_ms, bound, "bytes")
    log(f"[12] K4 N=2^24 Table-1 topology: device {ms * 1e3:.1f} us/launch "
        f"(plain {plain_ms * 1e3:.1f} us); bound {bound * 1e3:.2f} us "
        f"({nbytes} B at 3.35 TB/s; {bound / ms:.1%} of it)")

    b, t, d, s = 2, 1024, 8192, 16
    ins = scan_inputs(gen, b, t, d, s, torch.bfloat16)
    ms = device_ms(lambda: selective_scan_cuda(*ins))
    plain_ms = device_ms(lambda: selective_scan_ref(*ins), per_graph=1,
                         replays=5)
    nbytes = 3 * b * t * d * 2 + 2 * b * t * s * 2 + d * s * 4 + b * d * s * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = b * t * d * s / SFU_EXP_PER_S * 1e3
    flops = 6 * b * t * d * s + b * t * d
    t_fma = flops / F32_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_exp, t_fma)
    by = "bytes" if bound == t_bytes else "operations"
    out["k7"] = (ms, plain_ms, bound, by)
    log(f"[12] K7 B={b} T={t} D={d} S={s} bf16: device {ms * 1e3:.1f} "
        f"us/launch (before the Hopper redesign {K7_BEFORE_US} us; plain "
        f"{plain_ms * 1e3:.1f} us); bound "
        f"{bound * 1e3:.2f} us ({b * t * d * s} exp at 16/clock/SM x 132 "
        f"SMs x 1.98 GHz = {t_exp * 1e3:.2f} us; {nbytes} B at 3.35 TB/s = "
        f"{t_bytes * 1e3:.2f} us; {flops} float32 flops at 67 TFLOP/s = "
        f"{t_fma * 1e3:.2f} us; {by}; {bound / ms:.1%} of it)")
    k7_sweep(gen)
    return out


#: K7 at the jamba prefill shape (2, 1024, 8192, 16) bf16 before its Hopper
#: redesign: device us per launch, this script's phase 12 on an NVIDIA H100
#: 80GB HBM3 at 700 W
K7_BEFORE_US = 366.4


def k7_sweep(gen):
    """Device time of each shape of K7's sweep (csrc/selective_scan.cu
    K7_SWEEP: lanes a channel, channels a CTA, chunk) at the jamba prefill
    shape and the invariant's, bf16, each output held against the
    production kernel's within SCAN_TOL; the production shape is marked."""
    import ctypes

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_cuda)

    lib = build.load()["selective_scan"]
    n = lib.selective_scan_sweep_configs(None, 0)
    rows = (ctypes.c_int * (3 * n))()
    lib.selective_scan_sweep_configs(rows, n)
    shapes = [tuple(rows[3 * i:3 * i + 3]) for i in range(n)]
    prod = k7_production()
    prod = (prod["lanes"], prod["channels"], prod["chunk"])
    for b, t, d, s in ((2, 1024, 8192, 16), (2, 128, 8192, 16)):
        ins = scan_inputs(gen, b, t, d, s, torch.bfloat16)
        want = selective_scan_cuda(*ins)
        y = torch.empty_like(ins[0])
        h = torch.empty((b, d, s), dtype=torch.float32, device=DEVICE)
        cells = []
        for shape in shapes:
            def run():
                build.check(lib.selective_scan_sweep_launch(
                    *(v.data_ptr() for v in ins), y.data_ptr(), h.data_ptr(),
                    b, t, d, *shape, build.stream_of(y)), "K7 sweep")

            run()
            torch.cuda.synchronize()
            for what, g, w in (("y", y, want[0]), ("h", h, want[1])):
                e, ok = scan_check(g, w, "bfloat16")
                check(ok, f"K7 sweep shape {shape} {what} != production at "
                      f"{(b, t, d, s)}: max abs err {e}")
            ms = device_ms(run)
            mark = " (production)" if shape == prod else ""
            cells.append(f"L{shape[0]} CH{shape[1]} TC{shape[2]} "
                         f"{ms * 1e3:.1f}{mark}")
        log(f"[12] K7 sweep at {(b, t, d, s)} bf16, device us/launch: "
            + "; ".join(cells))


# ----------------------------------------------- training slice (minicpm) --

K6_BWD_SHAPES = [  # label, b, hq, hkv, s, d, dtype, causal
    ("minicpm", 4, 36, 36, 1024, 64, "bfloat16", True),
    ("minicpm_f32", 4, 36, 36, 1024, 64, "float32", True),
    ("qwen3", 1, 40, 8, 1024, 128, "bfloat16", True)] + [
    # ragged S, every D, GQA groups, not causal
    (f"small{i}", *shape, name, causal)
    for i, shape in enumerate([(2, 8, 2, 200, 16), (1, 4, 2, 130, 32),
                               (1, 10, 2, 256, 128), (1, 4, 4, 77, 64)])
    for name in ("float32", "bfloat16") for causal in (True, False)]
K6_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # x max |plain|
K6_BWD_TIMED = ("minicpm", "qwen3")  # timed, and launched twice
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 5


def events_ms(fn, n=5, warm=1):
    """Mean device time of one call of ``fn`` (CUDA events around ``n``
    calls after ``warm``), for work a CUDA graph cannot hold (autograd).
    Launch counters are restored."""
    import torch
    from repro_torch.kernels import build

    counted = dict(build.LAUNCHES)
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    build.LAUNCHES.update(counted)
    return s.elapsed_time(e) / n


def k6_bwd_split(bwd, n=10):
    """Device µs a launch of each of K6's backward's three kernels (row
    sums, dK/dV, dQ), from the profiler: ``n`` eager calls of ``bwd`` in a
    warm-up step, then ``n`` recorded. Late in this script the first
    milliseconds of a profile may hold no device event (a profile of a
    few launches there can record none), so the recorded step follows a
    warm-up step that lasts 50 ms or more, and each kernel's time is
    averaged over the launches recorded of it. A profile there has also
    recorded no device event at all, so a profile that misses one of the
    three is taken again, up to three profiles; fails when none records
    all three. Launch counters are restored."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import build

    for attempt in range(3):
        counted = dict(build.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for warm in (True, False):
                for _ in range(n):
                    bwd()
                torch.cuda.synchronize()
                if warm:
                    time.sleep(0.05)
                prof.step()
        build.LAUNCHES.update(counted)
        rows = device_rows(prof)
        parts = {}
        for e in rows:
            for part in ("delta_kernel", "dkdv_kernel", "dq_kernel"):
                if part in e.key:
                    t, c = parts.get(part, (0.0, 0))
                    parts[part] = (t + e.self_device_time_total, c + e.count)
        if len(parts) == 3:
            break
        log(f"the profiler recorded {sorted(parts)} of K6 backward's three "
            f"kernels in profile {attempt + 1} of 3")
    check(len(parts) == 3, f"the profiler recorded {sorted(parts)} of K6 "
          f"backward's three kernels over {n} launches in each of three "
          f"profiles; its device rows: {[e.key[:48] for e in rows][:8]}")
    return {k: t / c for k, (t, c) in parts.items()}, \
        min(c for _, c in parts.values())


def k6_bwd_timing(q, k, v, o, lse, do, plain):
    """K6's backward at one causal bf16 shape: each of its three kernels'
    device µs from the profiler (``k6_bwd_split``), its device µs a launch
    by ``device_ms`` (a CUDA graph of launches), K6's forward with lse,
    SDPA's forward + backward and its forward by ``device_ms`` too (timed
    only, never called by the port; its backward is their difference), the
    bound, and with ``plain`` autograd through the plain version in
    float32. Returns the JSON line's times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    b, hq, s, d = q.shape
    hkv = k.shape[1]

    def bwd():
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, True)

    parts, seen = k6_bwd_split(bwd)
    split = (f"row sums {parts['delta_kernel']:.1f} + dK/dV "
             f"{parts['dkdv_kernel']:.1f} + dQ {parts['dq_kernel']:.1f} us "
             f"by the profiler, {seen} or more of 10 launches recorded")
    ms = device_ms(bwd, per_graph=2, replays=10)
    fwd_ms = device_ms(lambda: flash_attention_cuda(q, k, v, True, lse=lse),
                       per_graph=10, replays=5)
    plain_ms = None
    if plain:
        ref = [t.float().requires_grad_() for t in (q, k, v)]
        ref_out = gqa_attention_ref(*ref, True)
        plain_ms = events_ms(lambda: torch.autograd.grad(
            ref_out, ref, do.float(), retain_graph=True), n=3)
        del ref, ref_out
    lib_in = [t.detach().requires_grad_() for t in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*lib_in, is_causal=True,
                                              enable_gqa=hq != hkv)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), lib_in, do)

    # a graph holds SDPA's backward only with its forward captured beside
    # it (autograd runs a backward op on its forward op's stream): its
    # backward is the graph of both less the graph of the forward
    lib_both_ms = device_ms(sdpa_fwd_bwd, per_graph=2, replays=10)
    lib_fwd_ms = device_ms(sdpa, per_graph=10, replays=5)
    lib_ms = lib_both_ms - lib_fwd_ms
    del lib_in
    flops = 10 * s * s * d * b * hq / 2
    nbytes = (4 * b * hq * s * d + 4 * b * hkv * s * d) * 2 + 4 * b * hq * s
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    plain_txt = ("" if plain_ms is None else
                 f"; plain autograd {plain_ms * 1e3:.1f} us in float32")
    log(f"[17] K6 backward at B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16: "
        f"device {ms * 1e3:.1f} us/launch ({split}){plain_txt}; "
        f"sdpa's backward {lib_ms * 1e3:.1f} us (its forward + backward "
        f"{lib_both_ms * 1e3:.1f} less its forward {lib_fwd_ms * 1e3:.1f}, "
        f"both CUDA graphs); K6 forward with lse {fwd_ms * 1e3:.1f} us, "
        f"forward + backward {(fwd_ms + ms) * 1e3:.1f} us; bound "
        f"{bound * 1e3:.2f} "
        f"us ({flops / 1e9:.2f} GFLOP at 989 TFLOP/s = {t_ops * 1e3:.2f} "
        f"us, {nbytes} B at 3.35 TB/s = {t_bytes * 1e3:.2f} us; {by}; "
        f"{bound / ms:.1%} of it)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms}


def train_kernel_times():
    """K7's forward at jamba's training shape (2, 1024, 8192, 16) bf16 and
    K6's base-form backward at minicpm-2b's bf16 and float32 and qwen3-14b's
    bf16 shapes (``K6_BWD_SHAPES``), device µs a launch by ``device_ms``, of
    the port imported from ``sys.path``: run once per checkout, each in its
    own process, to compare two checkouts on one card (A B B A)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_cuda)

    build.load()
    gen = torch.Generator().manual_seed(27)
    x, dt, bc, cc, a = scan_inputs(gen, 2, 1024, 8192, 16, torch.bfloat16)
    ms = device_ms(lambda: selective_scan_cuda(x, dt, bc, cc, a),
                   per_graph=10, replays=5)
    cells = [f"K7 forward (2, 1024, 8192, 16) bf16 {ms * 1e3:.1f}"]
    for label, b, hq, hkv, s, d, name, causal in K6_BWD_SHAPES[:3]:
        dt_ = getattr(torch, name)
        q, k, v, do = (randn(gen, (b, h, s, d), dt_)
                       for h in (hq, hkv, hkv, hq))
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=DEVICE)
        with torch.no_grad():
            o = flash_attention_cuda(q, k, v, causal, lse=lse)
        ms = device_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                        causal),
                       per_graph=2, replays=10)
        cells.append(f"K6 backward {label} (B={b} Hq={hq} Hkv={hkv} S={s} "
                     f"D={d} {name}) {ms * 1e3:.1f}")
    log(f"train kernel times {build.CSRC.parents[2]}: " + "; ".join(cells)
        + " us/launch")


def k6_bwd_times():
    """K6's backward at the shapes of ``K6_BWD_TIMED`` (bf16, causal),
    device µs a launch by ``device_ms``, of the port imported from
    ``sys.path``: run once per checkout, each in its own process, to
    compare two checkouts on one card (A B B A)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    build.load()
    gen = torch.Generator().manual_seed(17)
    cells = []
    for label, b, hq, hkv, s, d, name, causal in K6_BWD_SHAPES:
        if label not in K6_BWD_TIMED:
            continue
        q, k, v, do = (randn(gen, (b, h, s, d), torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=DEVICE)
        with torch.no_grad():
            o = flash_attention_cuda(q, k, v, True, lse=lse)
        ms = device_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                        True),
                       per_graph=2, replays=10)
        cells.append(f"{label} (B={b} Hq={hq} Hkv={hkv} S={s} D={d}) "
                     f"{ms * 1e3:.1f}")
    log(f"k6 bwd times {build.CSRC.parents[2]}: " + "; ".join(cells)
        + " us/launch")


def phase_attention_backward():
    """17(a): K6's forward with its log-sum-exp and K6's backward against
    their plain versions on the card; the wrappers without a backward
    refuse inputs that require grad; the backward's times."""
    import torch
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_cuda)

    gen = torch.Generator().manual_seed(17)
    err_abs, out, worst = 0.0, {}, {}
    for label, b, hq, hkv, s, d, name, causal in K6_BWD_SHAPES:
        dt = getattr(torch, name)
        q, k, v, do = (randn(gen, (b, h, s, d), dt)
                       for h in (hq, hkv, hkv, hq))
        with torch.no_grad():
            o_plain = flash_attention_cuda(q, k, v, causal)
            lse = torch.empty((b, hq, s), dtype=torch.float32, device=DEVICE)
            o = flash_attention_cuda(q, k, v, causal, lse=lse)
        check(torch.equal(o, o_plain), f"K6 with lse != K6 without at "
              f"{label}: the forward is not bit-identical")
        g = hq // hkv
        logits = torch.einsum("bhgsd,bhtd->bhgst",
                              q.float().reshape(b, hkv, g, s, d),
                              k.float()) / d ** 0.5
        if causal:
            logits = logits.masked_fill(~torch.ones(
                (s, s), dtype=torch.bool, device=DEVICE).tril(),
                float("-inf"))
        lse_err = float((lse - torch.logsumexp(logits, -1).reshape(
            b, hq, s)).abs().max())
        del logits
        check(lse_err <= 1e-5, f"K6's lse at {label} is off logsumexp by "
              f"{lse_err} (> 1e-5)")
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        ref = [t.float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(gqa_attention_ref(*ref, causal), ref,
                                   do.float())
        errs = []
        for nm, got, w in zip("qkv", (dq, dk, dv), want):
            e = float_err(got.float(), w)
            scale = float(w.abs().max())
            check(e <= K6_BWD_TOL[name] * scale, f"K6 backward d{nm} != "
                  f"plain at {label} {name} causal={causal}: max abs err "
                  f"{e} > {K6_BWD_TOL[name]} x {scale}")
            errs.append(e / scale)
            err_abs = max(err_abs, e)
        del ref, want
        worst[name] = max(worst.get(name, 0.0), *errs)
        if label.startswith("small"):
            continue
        same = ""
        if label in K6_BWD_TIMED:
            # no atomics: a second launch on the same inputs, the same bits
            again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
            check(all(torch.equal(x, y) for x, y in zip(again,
                                                        (dq, dk, dv))),
                  f"K6 backward at {label}: two launches on the same "
                  f"inputs gave different gradients")
            same = "; a second launch bit-identical"
            del again
        del dq, dk, dv
        log(f"[17] K6 backward {label} (B={b} Hq={hq} Hkv={hkv} S={s} "
            f"D={d} {name}, causal): max |err| / max |plain| dq "
            f"{errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g} (gate "
            f"{K6_BWD_TOL[name]}); lse off logsumexp by {lse_err:.3g}; the "
            f"forward bit-identical with and without lse{same}")
        if label not in K6_BWD_TIMED:
            continue
        timed = k6_bwd_timing(q, k, v, o, lse, do, label == "minicpm")
        if label == "minicpm":
            out = timed
    log(f"[17] K6 backward and lse on {len(K6_BWD_SHAPES)} cases (the "
        f"three above; ragged S 200, 130, 77, D 16-128, GQA, causal and "
        f"not, float32 and bf16): worst max |err| / max |plain| "
        f"{worst['float32']:.3g} float32, {worst['bfloat16']:.3g} bf16")
    # no silent detach: the wrappers without a backward refuse grad
    x = randn(gen, (1, 32, 8192), torch.bfloat16).requires_grad_()
    bc = randn(gen, (1, 32, 16), torch.bfloat16)
    qd = randn(gen, (2, 8, 64), torch.bfloat16).requires_grad_()
    kd = randn(gen, (2, 2, 128, 64), torch.bfloat16)
    lens = torch.full((2,), 128, dtype=torch.int32, device=DEVICE)
    qf = randn(gen, (1, 4, 64, 64), torch.bfloat16).requires_grad_()
    for label, call in (
            ("K5", lambda: decode_attention_cuda(qd, kd, kd, lens)),
            ("K7", lambda: selective_scan_cuda(
                x, x, bc, bc, torch.zeros((8192, 16), device=DEVICE))),
            ("K6's plain launch", lambda: flash_attention_cuda(qf, qf, qf))):
        try:
            call()
        except RuntimeError as e:
            check("requires grad" in str(e), f"{label}: {e}")
        else:
            raise CheckFailed(f"{label} returned a detached output for an "
                              f"input that requires grad")
    log("[17] K5, K7 and K6's plain launch refuse inputs that require grad")
    out["max_abs_err"] = err_abs
    return out


class Drill:
    """17(c): the training CLI's fault-tolerance drill on the card in child
    processes (tiny minicpm, 8 steps): a child that crashes at step 5 and
    an uninterrupted one start at construction, alongside phase 16's
    children; ``join_first`` waits for both before phase 17 times
    anything; ``finish`` runs the resumed child after the crash and holds
    the three runs' losses to each other. ``stop`` ends any child still
    running and removes their directory."""

    def __init__(self):
        import os
        import tempfile

        root = ROOT / "build" / "repro_torch"
        root.mkdir(parents=True, exist_ok=True)
        self.tmp = Path(tempfile.mkdtemp(prefix="drill", dir=root))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                             env.get("PYTHONPATH", "")])
        self.env = env
        self.procs = []
        self.t0 = time.perf_counter()
        self.crash = self.start(self.tmp / "ckpt", "--resume",
                                "--fail-at-step", "5")
        self.whole = self.start(self.tmp / "whole")
        self.first = None

    def start(self, ckdir, *extra):
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "minicpm-2b", "--tiny", "--steps", "8", "--batch", "2",
                "--seq", "32", "--checkpoint-every", "2", "--log-every", "1",
                "--ckpt-dir", str(ckdir), *extra]
        p = subprocess.Popen(args, env=self.env, cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        self.procs.append(p)
        return p

    @staticmethod
    def wait(p):
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise CheckFailed("a training child did not end within 300 s")
        return p.returncode, so, se

    def join_first(self):
        """Wait for the crashing and the uninterrupted child; returns the
        seconds waited."""
        t = time.perf_counter()
        self.first = (self.wait(self.crash), self.wait(self.whole))
        return time.perf_counter() - t

    def stop(self):
        import shutil

        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def finish(self):
        def losses_of(text):
            return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
                    if ln.startswith("[train] step")}

        def last_loss(d):
            with open(d / "step_000000008" / "manifest.json") as f:
                return json.load(f)["extra"]["loss"]

        try:
            (rc1, so1, se1), (rc3, so3, se3) = self.first
            rc2, so2, se2 = self.wait(self.start(self.tmp / "ckpt",
                                                 "--resume"))
            wall = time.perf_counter() - self.t0
            check(rc1 != 0 and "injected failure at step 5" in se1,
                  f"the crashing child: exit {rc1}\n{se1[-2000:]}")
            check(rc2 == 0 and "[train] resumed from step 6" in so2
                  and "done: 8 steps" in so2,
                  f"the resumed child: exit {rc2}\n{so2[-2000:]}"
                  f"{se2[-2000:]}")
            check(rc3 == 0 and "done: 8 steps" in so3,
                  f"the uninterrupted child: exit {rc3}\n{se3[-2000:]}")
            a, b, c = losses_of(so1), losses_of(so2), losses_of(so3)
            check(sorted(b) == ["6", "7"] and {**a, **b} == c,
                  f"crashed {a} + resumed {b} != uninterrupted {c}")
            la = last_loss(self.tmp / "ckpt")
            lc = last_loss(self.tmp / "whole")
            check(abs(la - lc) <= 1e-6 * abs(lc), f"the resumed run's last "
                  f"loss {la} != the uninterrupted run's {lc}")
        finally:
            self.stop()
        log(f"[17] drill (minicpm-2b tiny on the card, 8 steps): a child "
            f"crashed at step 5, a resumed child restored step 6 and "
            f"finished, its losses {b} equal the uninterrupted child's, the "
            f"last one {la!r} to rtol 1e-6 ({wall:.1f} s from the first "
            f"two children's start, beside phase 16, to the resumed "
            f"child's end)")


def phase_train(drill):
    """17(b): minicpm-2b at its published width and depth trains on the
    card in bf16 through ``make_train_step``; (c) the training CLI's
    fault-tolerance drill (``drill``, started beside phase 16). Returns K6
    backward's launches on the training path."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import lm, registry
    from repro_torch.optim import adamw_init, global_norm, schedules

    bf16 = torch.bfloat16
    cfg = get_config("minicpm-2b")
    check(cfg.n_layers == 40 and cfg.d_model == 2304 and cfg.n_heads == 36
          and cfg.n_kv_heads == 36 and cfg.head_dim == 64
          and cfg.d_ff == 5760 and cfg.vocab == 122753
          and cfg.tie_embeddings and cfg.remat == "full",
          "minicpm-2b config is not the published one")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[17] device memory before minicpm-2b: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            device=DEVICE, dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[17] minicpm-2b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, tied: {n_params / 1e9:.4f} B parameters, float32 "
        f"masters drawn on the card in {time.perf_counter() - t0:.1f} s; "
        f"remat {cfg.remat}, loss chunk {cfg.loss_chunk}")
    source = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    lfn = registry.loss_fn(cfg)

    def batch_at(step):
        return {k: torch.from_numpy(v).to(DEVICE)
                for k, v in source.batch_at(step).items()}

    # the first step's gradients with K6's plain backward, then with K6's
    build.reset_launches()
    with plain_kernels():
        loss_p, _, grads = loss_and_grads(lfn, params, batch_at(0), bf16)
        gn_p = float(global_norm(grads))
    check(build.LAUNCHES["k6"] == 0 and build.LAUNCHES["k6bwd"] == 0,
          f"the plain step launched K6: {build.LAUNCHES}")
    del grads
    build.reset_launches()
    loss_k, _, grads = loss_and_grads(lfn, params, batch_at(0), bf16)
    gn_k = float(global_norm(grads))
    one = dict(build.LAUNCHES)
    bad = [i for i, g in enumerate(_leaves(grads))
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    check(not bad, f"{len(bad)} parameters got a gradient that is not "
          f"finite or is zero (leaves {bad[:10]})")
    del grads
    loss_p, loss_k = float(loss_p), float(loss_k)
    check(abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
          and abs(gn_k - gn_p) <= 1e-2 * gn_p,
          f"the kernel step (loss {loss_k}, grad norm {gn_k}) is off the "
          f"plain-backward step (loss {loss_p}, grad norm {gn_p})")
    check(one["k6"] == 2 * cfg.n_layers and one["k6bwd"] == cfg.n_layers,
          f"a step launched K6 {one['k6']} and K6 backward {one['k6bwd']} "
          f"times, want {2 * cfg.n_layers} (the forward and its recompute) "
          f"and {cfg.n_layers}")
    log(f"[17] step 0 with K6's plain backward: loss {loss_p:.6f}, grad norm "
        f"{gn_p:.6f}; with K6's kernels: loss {loss_k:.6f} (rel "
        f"{abs(loss_k - loss_p) / loss_p:.2e}, gate 1e-3), grad norm "
        f"{gn_k:.6f} (rel {abs(gn_k - gn_p) / gn_p:.2e}, gate 1e-2); every "
        f"one of {len(list(_leaves(params)))} parameters got a finite, "
        f"non-zero gradient")

    # five steps through make_train_step: bf16 compute, the WSD schedule
    opt = adamw_init(params)
    step = make_train_step(cfg, schedule=schedules.make(
        "wsd", 1e-4, TRAIN_STEPS, warmup=1), dtype=bf16, device=DEVICE)
    build.reset_launches()
    walls, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = source.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    check(all(map(lambda x: x == x and abs(x) < 1e4, losses)),
          f"losses {losses}")
    per_step = {k: launches[k] / TRAIN_STEPS for k in ("k6", "k6bwd")}
    check(per_step["k6"] == 2 * cfg.n_layers
          and per_step["k6bwd"] == cfg.n_layers
          and launches["k5"] == launches["k7"] == 0,
          f"the train steps launched {launches}")
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(walls[1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # one more step under the profiler: the device's busy share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, source.batch_at(TRAIN_STEPS))
        float(m["loss"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    dev = device_rows(prof)
    busy = (f"{sum(e.self_device_time_total for e in dev) * 1e-6 / prof_wall:.1%}"
            f" of a traced step's {prof_wall * 1e3:.1f} ms wall"
            if dev else "not measured (no device events recorded)")
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[17] {TRAIN_STEPS} train steps, B={TRAIN_BATCH} x S={TRAIN_SEQ} "
        f"bf16: losses {[round(x, 5) for x in losses]}; wall per step "
        f"{[round(w * 1e3, 1) for w in walls]} ms, median of steps 2-"
        f"{TRAIN_STEPS} {ms:.1f} ms = {tokens / ms * 1e3:.0f} tokens/s; "
        f"device busy {busy}; peak allocated {peak / 1e9:.2f} GB; per step "
        f"K6 {per_step['k6']:.0f} launches (forward and recompute), K6 "
        f"backward {per_step['k6bwd']:.0f}")
    if dev:
        log("[17] largest device kernels in the traced step: " + "; ".join(
            f"{e.key[:50]} {e.self_device_time_total / 1e3:.1f} ms "
            f"x{e.count}" for e in top))
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the fault-tolerance drill of the training CLI, in child processes
    drill.finish()
    return launches["k6bwd"]


# ------------------------- phase 18: MLA, xLSTM and the encoder-decoder --

#: K6's general form against its plain version: (b, hq, hkv, sq, sk, dqk,
#: dv, causal). deepseek-v3's MLA prefill (phase 18(b)'s shape), a cross
#: shape with a ragged source, and small ones: the tests' tiny MLA widths,
#: a GQA cross-attention, equal widths with Sq != Sk, MLA's widths ragged
#: (causal, and GQA across Sq != Sk) and D 64 causal at another scale
K6_GEN_SHAPES = [(2, 128, 128, 1024, 1024, 192, 128, True),
                 (4, 16, 16, 256, 1000, 64, 64, False),
                 (2, 4, 4, 77, 77, 24, 16, True),
                 (2, 8, 2, 33, 50, 16, 16, False),
                 (1, 4, 1, 130, 64, 128, 128, False),
                 (1, 4, 4, 40, 97, 32, 32, False),
                 (1, 4, 4, 300, 300, 192, 128, True),
                 (1, 8, 2, 200, 333, 192, 128, False),
                 (2, 6, 3, 77, 77, 64, 64, True)]
#: the two shapes whose form, log-sum-exp and time phase 18(a) also checks:
#: MLA's prefill and the cross shape
K6_GEN_MLA, K6_GEN_CROSS = K6_GEN_SHAPES[:2]
#: the general form's LSE against logsumexp, as phase 17's base forms'
K6_LSE_TOL = 1e-5
#: deepseek-v3 cut to its 3 dense prefix layers and 1 MoE layer
DEEPSEEK_LAYERS = 4
#: xlstm-1.3b's float32 decode against its prefill over all 48 layers,
#: logits and states relative to their max. The prefill's and the decode's
#: products differ in rounding (a 256-row against a 2-row product), and
#: the difference grows ~1.2x a layer: 2.2e-5 of max |logit| after the
#: first period's 8 layers, 1.1e-3-1.7e-3 after 48, states 3.4e-3 (18(c)'s
#: two float32 lines on an H100 at 700 W, PERF.md), while the recurrence
#: itself holds the reference's to 3e-5 after 150 steps on the CPU
#: (tests/test_torch_xlstm.py). A wrong state misses by ~100%. At all 48
#: layers and tiny width on the CPU, the port's float32 decode-against-
#: prefill gap is held to at most 2x the reference's own
#: (test_xlstm_48_layers_decode_gap_is_the_references): both are 0 there.
#: The first period's 8 layers are held to 1e-3.
DEEP_F32_TOL = 1e-2
#: xlstm-1.3b's timed prefill length (2 x 128: a loop over time, ~20 ms a
#: step over 48 layers)
XLSTM_PREFILL = 128
#: seamless: frame embeddings encoded, greedy decode steps, the gate's steps
SEAMLESS_SRC = (4, 1024)
SEAMLESS_STEPS = 32
SEAMLESS_GATE_STEPS = 8


def gen_scale(dqk, dv):
    """Phase 18(a)'s scale: MLA's 1/sqrt(Dqk), and for equal widths 0.7 of
    it (not a base form's)."""
    return dqk ** -0.5 if dqk != dv else 0.7 / dqk ** 0.5


def plain_lse(q, k, causal, scale):
    """Each row's log-sum-exp of its scaled logits in float32, [B, Hq,
    Sq]."""
    import torch

    g = q.shape[1] // k.shape[1]
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(),
                          k.float().repeat_interleave(g, dim=1)) * scale
    if causal:
        s = q.shape[2]
        logits = logits.masked_fill(~torch.ones(
            (s, s), dtype=torch.bool, device=q.device).tril(), float("-inf"))
    return torch.logsumexp(logits, -1)


def gen_time(gen, shape):
    """K6's general form in bf16 at one shape: device ms a launch beside
    SDPA's (timed only), with the bound; the plain version's too at MLA's
    shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    b, hq, hkv, sq, sk, dqk, dv, causal = shape
    bf16 = torch.bfloat16
    q = randn(gen, (b, hq, sq, dqk), bf16)
    k = randn(gen, (b, hkv, sk, dqk), bf16)
    v = randn(gen, (b, hkv, sk, dv), bf16)
    scale = gen_scale(dqk, dv)
    ms = device_ms(lambda: flash_attention_cuda(q, k, v, causal,
                                                scale=scale),
                   per_graph=2 if causal else 20, replays=10)
    plain_ms = None
    if shape == K6_GEN_MLA:
        plain_ms = device_ms(lambda: gqa_attention_ref(q, k, v, causal,
                                                       scale),
                             per_graph=1, replays=5)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale, enable_gqa=hq != hkv),
        per_graph=2 if causal else 20, replays=10)
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    flops = 2 * b * hq * pairs * (dqk + dv)
    nbytes = (b * hq * sq * (dqk + dv) + b * hkv * sk * (dqk + dv)) * 2
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    by = "operations" if t_ops >= t_bytes else "bytes"
    plain_txt = ("" if plain_ms is None else
                 f"plain {plain_ms * 1e3:.1f} us, ")
    log(f"[18] K6 general B={b} H={hq}/{hkv} Sq={sq} Sk={sk} Dqk={dqk} "
        f"Dv={dv} causal={causal} bf16: device {ms * 1e3:.1f} us/launch "
        f"({plain_txt}sdpa {lib_ms * 1e3:.1f} us, {ms / lib_ms:.2f}x sdpa); "
        f"bound {bound * 1e3:.2f} us ({flops / 1e9:.2f} GFLOP at 989 TFLOP/s "
        f"bf16 = {t_ops * 1e3:.2f} us, {nbytes} B at 3.35 TB/s = "
        f"{t_bytes * 1e3:.2f} us; {by}; {bound / ms:.1%} of it)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms}


def phase_general_attention():
    """18(a): K6's general form (Dqk != Dv, Sk != Sq, the caller's scale)
    against its plain version on the card in float32 and bfloat16, with
    K6's tolerances times max |plain|, each launch counted under its
    kernel's key (``k6gen_tc`` for the tensor-core form, bf16 at a pair of
    ``TC_DIMS``; ``k6gen`` for the FMA form); at MLA's and the cross shape
    its log-sum-exp against the plain one; shapes no form takes raise;
    then its device time at MLA's and the cross shape beside SDPA and the
    bound."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        TC_DIMS, FlashAttention, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    gen = torch.Generator().manual_seed(18)
    worst, worst_abs, n, forms, lse_errs = 0.0, 0.0, 0, {}, []
    for name, tol in ATTN_TOL.items():
        dt = getattr(torch, name)
        for shape in K6_GEN_SHAPES:
            b, hq, hkv, sq, sk, dqk, dv, causal = shape
            q = randn(gen, (b, hq, sq, dqk), dt)
            k = randn(gen, (b, hkv, sk, dqk), dt)
            v = randn(gen, (b, hkv, sk, dv), dt)
            scale = gen_scale(dqk, dv)
            key = ("k6gen_tc" if dt == torch.bfloat16 and (dqk, dv)
                   in TC_DIMS else "k6gen")
            before = dict(build.LAUNCHES)
            lse = None
            if shape in (K6_GEN_MLA, K6_GEN_CROSS):
                lse = torch.empty((b, hq, sq), dtype=torch.float32,
                                  device=DEVICE)
            got = flash_attention_cuda(q, k, v, causal, lse=lse, scale=scale)
            check(build.LAUNCHES == {**before, key: before[key] + 1},
                  f"K6 general at {shape} {name}: launches went from "
                  f"{before} to {build.LAUNCHES}, want one {key}")
            forms[shape, name] = key
            want = gqa_attention_ref(q, k, v, causal, scale)
            e = float_err(got, want)
            top = float(want.float().abs().max())
            check(e <= tol * top, f"K6 general != plain at {shape} {name}: "
                  f"max abs err {e} (max |plain| {top:.3f}, bound {tol} x "
                  f"max)")
            worst = max(worst, e / top)
            worst_abs = max(worst_abs, e)
            n += 1
            del got, want
            if lse is not None:
                le = float((lse - plain_lse(q, k, causal, scale)).abs().max())
                check(le <= K6_LSE_TOL, f"K6 general's lse at {shape} {name} "
                      f"is off logsumexp by {le} (> {K6_LSE_TOL})")
                lse_errs.append(le)
            del q, k, v, lse
    for shape in (K6_GEN_MLA, K6_GEN_CROSS):
        check(forms[shape, "bfloat16"] == "k6gen_tc"
              and forms[shape, "float32"] == "k6gen", f"K6 general at "
              f"{shape}: forms {forms[shape, 'bfloat16']} (bf16), "
              f"{forms[shape, 'float32']} (float32); want the tensor-core "
              f"form in bf16, the FMA form in float32")
    refused = 0
    q = randn(gen, (1, 4, 64, 48), torch.bfloat16)
    v = randn(gen, (1, 4, 64, 32), torch.bfloat16)
    for args in ((q, q, v, False), (q, q[:, :, :32], v[:, :, :32], True)):
        try:
            flash_attention_cuda(*args)
        except ValueError:
            refused += 1
    q = randn(gen, (1, 4, 64, 48), torch.float32).requires_grad_()
    try:  # under grad too: the Function takes what the forms take
        FlashAttention.apply(q, q, q[..., :32], False)
    except ValueError:
        refused += 1
    check(refused == 3, f"K6 took {3 - refused} shapes no form takes")
    torch.cuda.synchronize()
    n_tc = sum(v == "k6gen_tc" for v in forms.values())
    log(f"[18] K6 general == plain on {n} cases (MLA's (2, 128, 1024, "
        f"192/128) causal, a cross Sq 256 against Sk 1000, small GQA and "
        f"ragged shapes; float32 and bfloat16), worst max abs err "
        f"{worst:.3g} x max |plain| (bounds 1e-5, 2e-2); {n_tc} cases on "
        f"the tensor-core form (k6gen_tc), {n - n_tc} on the FMA form "
        f"(k6gen): MLA's and the cross shape tensor cores in bf16, FMA in "
        f"float32; lse at those two off logsumexp by at most "
        f"{max(lse_errs):.3g} (bound {K6_LSE_TOL}); (Dqk, Dv) = (48, 32), "
        f"causal Sq != Sk and (48, 32) under grad raise")
    rec = gen_time(gen, K6_GEN_MLA)
    rec["cross"] = gen_time(gen, K6_GEN_CROSS)
    rec["max_abs_err"] = worst_abs
    return rec


def serve_cell(tag, cfg, params, batch=4, max_seq=256):
    """``serve_loop`` of 8 requests through ``batch`` slots (phase 8's
    requests), after a warm-up step; returns (launches, steps, wall)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_requests, serve_loop
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import registry

    bf16 = torch.bfloat16
    decode = make_decode_step(cfg, dtype=bf16)
    prompts, news = make_requests(0, cfg.vocab, 8, 64, 64)
    zeros = torch.zeros(batch, dtype=torch.int32)
    decode(params, registry.init_caches(cfg, batch, max_seq, dtype=bf16),
           zeros, zeros)  # warm-up
    caches = registry.init_caches(cfg, batch, max_seq, dtype=bf16)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    outputs, joined, steps = serve_loop(decode, params, caches, prompts,
                                        news, batch, max_seq=max_seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = dict(build.LAUNCHES)
    check(all(o is not None and len(o) == n
              and all(0 <= t < cfg.vocab for t in o)
              for o, n in zip(outputs, news)), f"{tag} serve outputs")
    tokens = sum(len(p) for p in prompts) + sum(news)
    log(f"[18] {tag} serve 8 requests / {batch} slots (prompts "
        f"{min(map(len, prompts))}-{max(map(len, prompts))}, max_new "
        f"{min(news)}-{max(news)}): {steps} steps in {wall:.2f} s, "
        f"{wall / steps * 1e3:.2f} ms per decode step, {tokens / wall:.0f} "
        f"tok/s ({sum(news) / wall:.0f} generated tok/s); joins {joined}; "
        f"launches {({k: v for k, v in served.items() if v})}")
    del caches
    return served, steps, wall


def invariant_cell(tag, cfg, params, toks, period_first=False):
    """The decode-vs-prefill invariant in float32 with room for every MoE
    assignment: logits within 1e-3 x max |logit| and every recurrent
    layer's state within ``MAMBA_STATE_TOL["float32"]``. MLA's and xLSTM's
    decode launch no kernel (``serve_cell`` checks it), so phase 8's
    bfloat16 rule, which holds the decode's kernel path to its plain one,
    has no two paths to compare here: float32 is the gate. With
    ``period_first`` those bounds hold the model's first period, and the
    whole depth is held to ``DEEP_F32_TOL`` (a difference that grows with
    depth, not with the step: see there)."""
    import dataclasses

    if period_first:
        depth = dataclasses.replace(cfg, n_layers=len(cfg.period))
        invariant_f32(f"{tag} first period ({depth.n_layers} layers)",
                      depth, {**params, "layers": params["layers"][
                          :depth.n_layers]}, toks, 1e-3,
                      MAMBA_STATE_TOL["float32"])

    tol = DEEP_F32_TOL if period_first else 1e-3
    invariant_f32(tag, cfg, params, toks, tol,
                  DEEP_F32_TOL if period_first else MAMBA_STATE_TOL[
                      "float32"])


def invariant_f32(tag, cfg, params, toks, tol, state_tol):
    """Decode against prefill in float32 with room for every MoE
    assignment: logits within ``tol`` x max |logit|, every recurrent
    layer's state within ``state_tol`` x its max."""
    import dataclasses

    import torch

    roomy = (dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k) if cfg.is_moe else cfg)
    errs32, scale32, state32, drops32 = decode_vs_prefill(
        roomy, params, toks, ("kernel",), torch.float32)
    worst = max((e / m for e, m in state32.values()), default=0.0)
    log(f"[18] {tag} float32" + (f", capacity factor "
        f"{roomy.capacity_factor} (drops {drops32})" if cfg.is_moe else "")
        + f": max |decode - prefill| logit {errs32['kernel']:.3g} (max "
        f"|logit| {scale32:.3f}, bound {tol} x max)"
        + (f"; recurrent state, worst layer max abs err / max "
           f"{worst:.3g} over {len(state32)} layers (bound {state_tol})"
           if state32 else ""))
    check(not drops32 or max(drops32) == 0, f"{tag}: capacity factor "
          f"{roomy.capacity_factor} still drops {drops32}")
    check(errs32["kernel"] <= tol * scale32, f"{tag} float32 decode is "
          f"off teacher forcing by {errs32['kernel']} (bound "
          f"{tol * scale32})")
    check(worst <= state_tol, f"{tag} float32 recurrent state after decode "
          f"is off the prefill's by {worst:.3g} x max (bound {state_tol})")


def fresh_memory(tag, phase="18"):
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[{phase}] device memory before {tag}: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")


def draw(tag, cfg, init):
    """Weights drawn on the card (each matrix in float32, cast to bf16
    before the next is drawn); returns (params, parameter bytes)."""
    import torch

    t0 = time.perf_counter()
    params = init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                  device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"[18] {tag}: {n_params / 1e9:.3f} B parameters, "
        f"{n_bytes / 1e9:.2f} GB on the card, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return params, n_bytes


def timed_prefill(cfg, params, batch, warm=None):
    """A warm-up prefill (of ``warm``, else of ``batch``), then a timed one
    of ``batch`` with the launches counted: (logits, caches, ms,
    launches)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_prefill

    prefill = make_prefill(cfg, dtype=torch.bfloat16)
    prefill(params, batch if warm is None else warm)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    torch.cuda.synchronize()
    return logits, caches, (time.perf_counter() - t0) * 1e3, dict(
        build.LAUNCHES)


def phase_deepseek():
    """18(b): deepseek-v3 at its published widths, depth cut to the 3 dense
    prefix layers and 1 MoE layer: a prefill of 2 x 1024 (K6's general
    form, one launch an MLA layer), ``serve_loop``, the invariant."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import lm

    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_LAYERS)
    check(cfg.d_model == 7168 and cfg.n_heads == 128 and cfg.mla_q_lora
          == 1536 and cfg.mla_kv_lora == 512 and cfg.mla_nope_dim == 128
          and cfg.mla_rope_dim == 64 and cfg.mla_v_dim == 128
          and cfg.n_experts == 256 and cfg.top_k == 8
          and cfg.n_shared_experts == 1 and cfg.d_ff_expert == 2048
          and cfg.d_ff == 18432 and cfg.vocab == 129280
          and len(cfg.prefix) == 3, "deepseek-v3 config is not the "
          "published one")
    fresh_memory("deepseek-v3")
    params, n_bytes = draw(
        f"deepseek-v3-671b depth {cfg.n_layers} of {full.n_layers} (3 dense "
        f"+ 1 MoE of {cfg.n_experts} experts top-{cfg.top_k}, "
        f"{cfg.n_shared_experts} shared), MLA q_lora {cfg.mla_q_lora} "
        f"kv_lora {cfg.mla_kv_lora}, vocab {cfg.vocab}", cfg, lm.init_params)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(1, cfg.vocab, (2, 1024), generator=gen)
    logits, caches, pre_ms, pre = timed_prefill(cfg, params,
                                                {"tokens": toks})
    check(pre["k6gen_tc"] == cfg.n_layers and pre["k6gen"] == 0
          and pre["k6"] == 0 and pre["k5"] == 0, f"prefill launched {pre}, "
          f"want K6's general form on the tensor cores (k6gen_tc) = "
          f"{cfg.n_layers} and no other K6")
    check(logits.shape == (2, cfg.vocab) and bool(torch.isfinite(
        logits).all()), "prefill logits are not finite [2, vocab]")
    for c in caches:
        check({k: tuple(v.shape) for k, v in c.items()}
              == {"ckv": (2, 1024, 512), "k_rope": (2, 1024, 64)}
              and all(bool(torch.isfinite(v.float()).all())
                      for v in c.values()), "prefill latent cache")
    del caches
    latent = (cfg.mla_kv_lora + cfg.mla_rope_dim) * cfg.n_layers * 2
    log(f"[18] deepseek prefill B=2 S=1024: {pre_ms:.1f} ms wall, "
        f"{2 * 1024 / pre_ms * 1e3:.0f} tok/s, K6 general launches "
        f"{pre['k6gen_tc']} on the tensor cores (= {cfg.n_layers} MLA "
        f"layers); latent cache "
        f"{cfg.mla_kv_lora + cfg.mla_rope_dim} values x {cfg.n_layers} "
        f"layers = {latent} B a token in bf16 (GQA at 128 heads of 128 "
        f"would hold {2 * 128 * 128 * cfg.n_layers * 2} B)")
    served, steps, wall = serve_cell("deepseek", cfg, params)
    check(served["k6gen"] == served["k6gen_tc"] == served["k6"]
          == served["k5"] == 0,
          f"deepseek serve launched {served}: MLA's absorbed decode runs "
          f"no kernel")
    decode_profile(make_decode_step(cfg, dtype=torch.bfloat16), params, cfg,
                   4, 256, phase="18")
    invariant_cell("deepseek", cfg, params,
                   torch.randint(1, cfg.vocab, (2, 128), generator=gen))
    log(f"[18] deepseek peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    return {"k6gen_tc": pre["k6gen_tc"], "prefill_ms": pre_ms,
            "step_ms": wall / steps * 1e3, "floor_ms": n_bytes
            / HBM_BYTES_PER_S * 1e3}


def phase_xlstm():
    """18(c): xlstm-1.3b at its published width and depth (42 mLSTM + 6
    sLSTM layers): a prefill of 2 x 256 (the step loop, no kernel),
    ``serve_loop``, the invariant with the recurrent states."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import lm

    cfg = get_config("xlstm-1.3b")
    kinds = [m for m, _ in lm.layer_kinds(cfg)]
    check(cfg.n_layers == 48 and cfg.d_model == 2048 and cfg.n_heads == 4
          and cfg.vocab == 50304 and kinds.count("mlstm") == 42
          and kinds.count("slstm") == 6, "xlstm-1.3b config is not the "
          "published one")
    fresh_memory("xlstm-1.3b")
    params, n_bytes = draw(
        f"xlstm-1.3b, {cfg.n_layers} layers (42 mLSTM, 6 sLSTM), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab} (the "
        f"mLSTM's up-projection by 2 and its three d_inner^2 matrices make "
        f"it more than the name says)", cfg, lm.init_params)
    gen = torch.Generator().manual_seed(6)
    toks = torch.randint(1, cfg.vocab, (2, XLSTM_PREFILL), generator=gen)
    logits, caches, pre_ms, pre = timed_prefill(
        cfg, params, {"tokens": toks}, warm={"tokens": toks[:, :16]})
    check(not any(pre.values()), f"xlstm prefill launched {pre}: no "
          f"kernel is on this path")
    check(logits.shape == (2, cfg.vocab) and bool(torch.isfinite(
        logits).all()) and all(bool(torch.isfinite(v).all())
                               for c in caches for v in c.values()),
          "xlstm prefill logits or states are not finite")
    del caches
    log(f"[18] xlstm prefill B=2 S={XLSTM_PREFILL} (a Python loop over the "
        f"{XLSTM_PREFILL} steps a layer; no TPU kernel is on this path): "
        f"{pre_ms:.1f} ms wall, {2 * XLSTM_PREFILL / pre_ms * 1e3:.0f} "
        f"tok/s")
    served, steps, wall = serve_cell("xlstm", cfg, params)
    check(not any(served.values()), f"xlstm serve launched {served}")
    dh = 2 * cfg.d_model // cfg.n_heads
    state = 42 * 4 * cfg.n_heads * dh * dh * 4
    floor = (n_bytes + 2 * state) / HBM_BYTES_PER_S * 1e3
    log(f"[18] xlstm decode floor at B=4: weights {n_bytes / 1e9:.2f} GB "
        f"once + the mLSTM states ({state / 1e9:.2f} GB float32) read and "
        f"written = {floor:.2f} ms at 3.35 TB/s, against "
        f"{wall / steps * 1e3:.2f} ms a step")
    decode_profile(make_decode_step(cfg, dtype=torch.bfloat16), params, cfg,
                   4, 256, phase="18")
    invariant_cell("xlstm", cfg, params,
                   torch.randint(1, cfg.vocab, (2, 128), generator=gen),
                   period_first=True)
    log(f"[18] xlstm peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    return {"prefill_ms": pre_ms, "step_ms": wall / steps * 1e3,
            "floor_ms": floor}


def phase_seamless():
    """18(d): seamless-m4t-medium at its published dims, unreduced: encode
    4 x 1024 frame embeddings (K6, one launch a layer), precompute the
    cross K/V, 32 greedy decode steps (K5 twice a layer a step), and the
    gate: 8 steps of the kernel path against the plain path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import encdec, registry

    bf16 = torch.bfloat16
    cfg = get_config("seamless-m4t-medium")
    check(cfg.n_layers == 12 and cfg.n_enc_layers == 12 and cfg.d_model
          == 1024 and cfg.n_heads == 16 and cfg.head_dim == 64
          and cfg.d_ff == 4096 and cfg.vocab == 256206,
          "seamless-m4t-medium config is not the published one")
    fresh_memory("seamless-m4t-medium")
    params, n_bytes = draw(
        f"seamless-m4t-medium, {cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}", cfg, encdec.init_params)
    b, s_src = SEAMLESS_SRC
    gen = torch.Generator().manual_seed(7)
    src = randn(gen, (b, s_src, cfg.d_model), bf16)
    enc, cross, enc_ms, pre = timed_prefill(cfg, params, src)
    check(pre["k6"] == cfg.n_enc_layers and pre["k6gen"] == 0
          and pre["k6gen_tc"] == 0 and pre["k5"] == 0, f"encode launched "
          f"{pre}, want K6 = "
          f"{cfg.n_enc_layers}")
    check(enc.shape == (b, s_src, cfg.d_model) and bool(torch.isfinite(
        enc.float()).all()) and len(cross) == cfg.n_layers
          and cross[0][0].shape == (b, cfg.n_kv_heads, s_src, cfg.head_dim),
          "encoder output or cross K/V")
    log(f"[18] seamless encode B={b} S_src={s_src} + cross K/V: "
        f"{enc_ms:.1f} ms wall, K6 launches {pre['k6']} (= "
        f"{cfg.n_enc_layers} encoder layers)")
    step = make_decode_step(cfg, dtype=bf16)
    plain = make_decode_step(cfg, dtype=bf16, backend="plain")
    max_seq = SEAMLESS_STEPS
    tok = torch.ones(b, dtype=torch.int32)
    step(params, registry.init_caches(cfg, b, max_seq, dtype=bf16), cross,
         tok, torch.zeros(b, dtype=torch.int32))  # warm-up
    caches = registry.init_caches(cfg, b, max_seq, dtype=bf16)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    for t in range(SEAMLESS_STEPS):
        tok, logits, caches = step(params, caches, cross, tok,
                                   torch.full((b,), t, dtype=torch.int32))
        tok = tok.cpu()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec = dict(build.LAUNCHES)
    check(dec["k5"] == 2 * cfg.n_layers * SEAMLESS_STEPS and dec["k6"] == 0
          and dec["k6gen"] == dec["k6gen_tc"] == 0, f"decode launched "
          f"{dec}, want K5 = 2 x "
          f"{cfg.n_layers} x {SEAMLESS_STEPS}")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    step_ms = wall / SEAMLESS_STEPS * 1e3
    log(f"[18] seamless {SEAMLESS_STEPS} greedy decode steps at B={b}: "
        f"{step_ms:.2f} ms per step, {b * SEAMLESS_STEPS / wall:.0f} tok/s; "
        f"K5 launches {dec['k5']} = 2 x {cfg.n_layers} x {SEAMLESS_STEPS}")
    decode_profile(lambda p, c, t, q: step(p, c, cross, t, q), params, cfg,
                   b, 128, phase="18")
    # the gate: the kernel path against the plain path, same tokens
    counted = dict(build.LAUNCHES)
    ck = registry.init_caches(cfg, b, max_seq, dtype=bf16)
    cp = registry.init_caches(cfg, b, max_seq, dtype=bf16)
    tok = torch.ones(b, dtype=torch.int32)
    err = top = 0.0
    for t in range(SEAMLESS_GATE_STEPS):
        pos = torch.full((b,), t, dtype=torch.int32)
        nxt, lk, ck = step(params, ck, cross, tok, pos)
        _, lp, cp = plain(params, cp, cross, tok, pos)
        err = max(err, float((lk - lp).abs().max()))
        top = max(top, float(lp.abs().max()))
        tok = nxt.cpu()
    build.LAUNCHES.update(counted)
    log(f"[18] seamless gate, {SEAMLESS_GATE_STEPS} steps bf16: max |kernel "
        f"- plain| logit {err:.4f} (max |logit| {top:.3f}; bound 2e-2 x max "
        f"= {2e-2 * top:.4f})")
    check(err <= 2e-2 * top, f"seamless decode with kernels is off the "
          f"plain path by {err} (bound {2e-2 * top})")
    log(f"[18] seamless peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params, cross, caches, ck, cp
    return {"k6": pre["k6"], "k5": dec["k5"], "encode_ms": enc_ms,
            "step_ms": step_ms}


def phase_families():
    """Phase 18: K6's general form, then the three families the port
    serves since it has MLA, xLSTM and the encoder-decoder."""
    t0 = time.perf_counter()
    out = {"k6gen": phase_general_attention(),
           "deepseek": phase_deepseek(),
           "xlstm": phase_xlstm(),
           "seamless": phase_seamless()}
    log(f"[18] phase 18 {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------- phase 19: every family trains --

#: K7's backward against autograd through its plain version: (b, t, d, s).
#: The JAX tests' shapes, jamba's training shape (phase 19(c)'s, timed),
#: the invariant's, a ragged one, one step and a chunk and one step at
#: S = 8; then the edges of the production shape (lanes 4, channels 64,
#: chunk 16): T = chunk - 1, chunk + 1 and 3 chunk + 1, D ragged against
#: the channels (72 and 136 whole 16-byte rows, 100 not in bf16: plain
#: loads), S = 8 at 4 lanes (2 states a thread); each in float32 and bf16,
#: with the gradient of h_final and without
K7_BWD_SHAPES = [(2, 64, 32, 8), (1, 512, 512, 16), (3, 128, 64, 16),
                 (2, 1024, 8192, 16), (2, 128, 8192, 16), (2, 200, 600, 16),
                 (1, 1, 600, 8), (1, 33, 600, 8),
                 (2, 15, 72, 16), (1, 17, 100, 16), (2, 49, 136, 8),
                 (1, 17, 72, 8)]
K7_BWD_TIMED = (2, 1024, 8192, 16)
#: K6's backward at its general form against autograd through its plain
#: version: label, b, hq, hkv, sq, sk, dqk, dv, causal, dtype, scale (None:
#: 1/sqrt(dqk)). deepseek-v3's MLA training shape (bf16; float32 on fewer
#: heads), seamless's cross-attention (S_tgt 256 against a ragged source),
#: the tests' tiny MLA widths, an explicit scale, GQA across Sq != Sk at
#: MLA's widths and at (128, 128) with a scale; MLA's widths at a length
#: whose last 128-row dQ tile leaves its second warpgroup past Sq (Sq mod
#: 128 in (0, 64]: the dQ kernel's row guard, a Q/dO box wholly past Sq and
#: the causal early stop at a ragged length); and seamless's encoder shape,
#: which is a base form (K6's tensor-core backward). bf16 at a pair of
#: TC_DIMS runs the general form's tensor-core kernels, float32 and the
#: tiny widths its FMA kernels
K6_GEN_BWD_SHAPES = [
    ("mla", 2, 128, 128, 1024, 1024, 192, 128, True, "bfloat16", None),
    ("mla_f32", 1, 16, 16, 1024, 1024, 192, 128, True, "float32", None),
    ("cross", 4, 16, 16, 256, 1000, 64, 64, False, "bfloat16", None),
    ("cross_f32", 1, 16, 16, 256, 1000, 64, 64, False, "float32", None),
    ("tiny_mla", 2, 4, 4, 77, 77, 24, 16, True, "float32", None),
    ("tiny_mla_bf16", 2, 4, 4, 77, 77, 24, 16, True, "bfloat16", None),
    ("scale", 2, 4, 4, 64, 64, 64, 64, True, "bfloat16", 0.5),
    ("scale_f32", 2, 8, 2, 33, 50, 16, 16, False, "float32", 0.5),
    ("gqa_cross_mla", 1, 8, 2, 200, 333, 192, 128, False, "bfloat16", None),
    ("gqa_cross_128", 2, 8, 4, 150, 410, 128, 128, False, "bfloat16", 0.2),
    ("mla_130", 1, 4, 4, 130, 130, 192, 128, True, "bfloat16", None),
    ("gqa_cross_mla_40", 1, 8, 2, 40, 133, 192, 128, False, "bfloat16",
     0.3),
    ("seamless_enc", 4, 16, 16, 1024, 1024, 64, 64, False, "bfloat16",
     None)]
K6_GEN_BWD_TIMED = ("mla", "cross")
#: the general backward's launch key by form (``general_form``)
GEN_BWD_KEY = {"tc": "k6bwd_gen_tc", "fma": "k6bwd_gen"}
#: phase 19(c): steps timed after the comparison step, the cosine schedule
FAMILY_STEPS = 3
#: deepseek-v3's training batch (2 x 1024; 1 if its peak passes 75 GB)
DEEPSEEK_TRAIN_BATCH = 2


class plain_kernels:
    """Within: every kernel call of the LM stack's training path is its
    plain version, autograd and all, on any device: K6 (the GQA
    attention's and ``blocked_attention``'s, base and general forms) and K7
    (the Mamba mixer's scan)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention.ref import gqa_attention_ref
        from repro_torch.kernels.selective_scan.ref import selective_scan_ref
        from repro_torch.models import attention, blocked_attention, ssm

        self.saved = (attention.flash_attention,
                      blocked_attention.k6_attention, ssm.selective_scan)
        attention.flash_attention = gqa_attention_ref
        blocked_attention.k6_attention = gqa_attention_ref
        ssm.selective_scan = selective_scan_ref

    def __exit__(self, *exc):
        from repro_torch.models import attention, blocked_attention, ssm

        (attention.flash_attention, blocked_attention.k6_attention,
         ssm.selective_scan) = self.saved


def k7_bwd_bound_ms(b, t, d, s, nbytes):
    """K7's backward's bound: the larger of one exp a (b, t, d, s) on the
    SFUs (K7's own bound) and the bytes it must move at 3.35 TB/s:
    x, dt, dy read and dx, ddt written ([B, T, D]), B, C read and dB, dC
    written ([B, T, S]), A read and dA written ([D, S], float32)."""
    t_exp = b * t * d * s / SFU_EXP_PER_S * 1e3
    moved = 5 * b * t * d * nbytes + 4 * b * t * s * nbytes + 2 * d * s * 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return max(t_exp, t_bytes), ("operations" if t_exp >= t_bytes
                                 else "bytes"), t_exp, t_bytes


def phase_scan_backward():
    """19(a): K7's saving forward against its plain launch (y and h_final
    bit for bit, the last checkpoint against the plain launch's h_final
    over the steps before it), then K7's backward against autograd
    through ``selective_scan_ref`` on the card, every gradient, with and
    without the gradient of h_final, from the saving forward's checkpoints
    and from the inputs alone (bit-identical); its time at jamba's
    training shape beside K7's forward, plain and saving; and the sweep of
    its (lanes, channels, chunk) there."""
    import torch
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan.selective_scan import (
        BWD_CHUNK, selective_scan_bwd_cuda, selective_scan_cuda,
        selective_scan_save_cuda)

    gen = torch.Generator().manual_seed(19)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}
    long_shape, factor = SCAN_LONG  # dt A near 0, float32 only
    worst, err_abs, n = {}, 0.0, 0
    timed = None
    for shape in K7_BWD_SHAPES + [long_shape]:
        for name in (("float32",) if shape == long_shape
                     else ("float32", "bfloat16")):
            dt_ = getattr(torch, name)
            x, dt, bc, cc, a = scan_inputs(gen, *shape, dt_)
            if shape == long_shape:
                dt, a = (dt.float() * factor).to(dt_), a * factor
            b, t, d, s = shape
            y0, h0 = selective_scan_cuda(x, dt, bc, cc, a)
            y1, h1, hs = selective_scan_save_cuda(x, dt, bc, cc, a)
            check(torch.equal(y0, y1) and torch.equal(h0, h1), f"K7's "
                  f"saving forward at {shape} {name}: y or h_final differs "
                  f"from the plain launch's")
            t_last = (hs.shape[1] - 1) * BWD_CHUNK
            if t_last:
                h_last = selective_scan_cuda(
                    *(v[:, :t_last].contiguous() for v in (x, dt, bc, cc)),
                    a)[1]
                check(torch.equal(hs[:, -1], h_last), f"K7's saving forward "
                      f"at {shape} {name}: the checkpoint at step {t_last} "
                      f"is not the plain launch's h_final over {t_last} "
                      f"steps")
            del y0, h0, y1, h1
            dy = randn(gen, (b, t, d), dt_)
            dh = randn(gen, (b, d, s), torch.float32)
            ref = [u.detach().float().requires_grad_()
                   for u in (x, dt, bc, cc, a)]
            y, h = selective_scan_ref(*ref)
            want = {
                "dh": torch.autograd.grad((y, h), ref, (dy.float(), dh),
                                          retain_graph=True),
                "none": torch.autograd.grad(y, ref, dy.float())}
            del y, h, ref
            errs = []
            for case, dh_in in (("dh", dh), ("none", None)):
                got = selective_scan_bwd_cuda(x, dt, bc, cc, a, dy, dh_in, hs)
                again = selective_scan_bwd_cuda(x, dt, bc, cc, a, dy, dh_in)
                check(all(torch.equal(p, q) for p, q in zip(got, again)),
                      f"K7 backward at {shape} {name} dh={case}: two launches "
                      f"on the same inputs (with the checkpoints, and from "
                      f"the inputs alone) gave different gradients")
                for nm, g, w in zip(("dx", "ddt", "dB", "dC", "dA"), got,
                                    want[case]):
                    e = float_err(g.float(), w)
                    scale = float(w.abs().max())
                    check(e <= tol[name] * scale, f"K7 backward {nm} != "
                          f"plain at {shape} {name} dh={case}: max abs err "
                          f"{e} > {tol[name]} x {scale}")
                    errs.append(e / max(scale, 1e-30))
                    err_abs = max(err_abs, e)
                n += 1
            worst[name] = max(worst.get(name, 0.0), *errs)
            del want, got, again
            if shape == K7_BWD_TIMED and name == "bfloat16":
                timed = (x, dt, bc, cc, a, dy)
    log(f"[19] (a) K7's saving forward == its plain launch bit for bit (y, "
        f"h_final) on every shape below, its last checkpoint == the plain "
        f"h_final over the steps before it; K7 backward against autograd "
        f"through its plain version on {n} cases (the JAX tests' shapes, "
        f"jamba's (2, 1024, 8192, 16), (2, 128, 8192, 16), ragged (2, 200, "
        f"600, 16), T 1 and 33 at S 8, T 15, 17, 49 against chunks of "
        f"{BWD_CHUNK} with D 72, 100, 136 ragged against the channel block "
        f"and S 8; each float32 and bf16; {long_shape} float32 with dt A "
        f"near 0; each with the gradient of h_final and without): worst max "
        f"|err| / max |plain| over dx, ddt, dB, dC, dA "
        f"{worst['float32']:.3g} float32 (gate 1e-4), "
        f"{worst['bfloat16']:.3g} bf16 against float32 plain on the same "
        f"bf16 inputs (gate 2e-2: the forward already rounds dt x elsewhere "
        f"than the oracle); every second launch (from the inputs alone) "
        f"bit-identical")
    x, dt, bc, cc, a, dy = timed
    b, t, d, s = K7_BWD_TIMED
    hs = selective_scan_save_cuda(x, dt, bc, cc, a)[2]
    ms = events_ms(lambda: selective_scan_bwd_cuda(x, dt, bc, cc, a, dy,
                                                   None, hs), n=10, warm=2)
    fwd_ms = events_ms(lambda: selective_scan_cuda(x, dt, bc, cc, a),
                       n=10, warm=2)
    save_ms = events_ms(lambda: selective_scan_save_cuda(x, dt, bc, cc, a),
                        n=10, warm=2)
    ref = [u.detach().float().requires_grad_() for u in (x, dt, bc, cc, a)]
    y, _ = selective_scan_ref(*ref)
    plain_ms = events_ms(lambda: torch.autograd.grad(
        y, ref, dy.float(), retain_graph=True), n=2, warm=1)
    del ref, y
    bound, by, t_exp, t_bytes = k7_bwd_bound_ms(b, t, d, s, 2)
    log(f"[19] (a) K7 backward at jamba's {K7_BWD_TIMED} bf16: device "
        f"{ms * 1e3:.1f} us/launch from the checkpoints (CUDA events over 10 "
        f"launches); K7's forward {fwd_ms * 1e3:.1f} plain, "
        f"{save_ms * 1e3:.1f} saving (+{(save_ms - fwd_ms) * 1e3:.1f} for "
        f"{hs.numel() * 4 / 1e6:.1f} MB of checkpoints); plain autograd's "
        f"backward {plain_ms * 1e3:.1f} us in float32; bound "
        f"{bound * 1e3:.2f} us ({b * t * d * s} exps on the SFUs = "
        f"{t_exp * 1e3:.2f} us, bytes {t_bytes * 1e3:.2f} us; {by}; "
        f"{bound / ms:.1%} of it); no single PyTorch call computes it")
    k7_bwd_sweep(x, dt, bc, cc, a, dy)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": None, "max_abs_err": err_abs}


def k7_bwd_sweep(x, dt, bc, cc, a, dy):
    """Device time of each shape of K7's backward's sweep
    (csrc/selective_scan_bwd.cu K7_BWD_SWEEP: lanes a channel, channels a
    CTA, chunk) on these bf16 S = 16 inputs, each from the saving
    forward's checkpoints at its chunk, its gradients held against the
    production kernel's within 2e-2 x max |production|; the production
    shape is marked."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_bwd_cuda, selective_scan_save_cuda)

    lib = build.load()["selective_scan_bwd"]
    prod = k7_bwd_production()
    b, t, d, s = x.shape + (bc.shape[2],)
    want = selective_scan_bwd_cuda(x, dt, bc, cc, a, dy)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    outs = [torch.empty_like(v) for v in (x, dt, bc, cc)] + [
        torch.empty((d, s), **f32)]
    pa = torch.empty((b, d, s), **f32)
    cells = []
    for lanes, channels, chunk in prod["sweep"]:
        hs = selective_scan_save_cuda(x, dt, bc, cc, a, chunk)[2]
        part = torch.empty((b, -(-d // channels), t, 2 * s), **f32)

        def run():
            build.check(lib.selective_scan_bwd_sweep_launch(
                *(v.data_ptr() for v in (x, dt, bc, cc, a, dy)), None,
                hs.data_ptr(), part.data_ptr(), pa.data_ptr(),
                *(g.data_ptr() for g in outs), b, t, d, lanes, channels,
                chunk, build.stream_of(x)), "K7 backward sweep")

        run()
        torch.cuda.synchronize()
        for nm, g, w in zip(("dx", "ddt", "dB", "dC", "dA"), outs, want):
            e = float_err(g.float(), w.float())
            scale = float(w.float().abs().max())
            check(e <= 2e-2 * scale, f"K7 backward sweep shape "
                  f"{(lanes, channels, chunk)} {nm} != production: max abs "
                  f"err {e} > 2e-2 x {scale}")
        ms = events_ms(run, n=10, warm=2)
        mark = " (production)" if (lanes, channels, chunk) == prod[
            "shape"] else ""
        cells.append(f"L{lanes} CH{channels} TC{chunk} {ms * 1e3:.1f}{mark}")
        del hs, part
    log(f"[19] (a) K7 backward sweep at {(b, t, d, s)} bf16, device "
        f"us/launch (CUDA events over 10): " + "; ".join(cells))


def k6_gen_bwd_bound_ms(b, hq, hkv, sq, sk, dqk, dv, causal, nbytes, peak):
    """The general backward's bound: five products (S = Q K^T and dP = dO
    V^T recomputed, dV, dK, dQ), 2 Sq Sk (3 Dqk + 2 Dv) flops a head (half
    of it causal) at ``peak``, against the bytes of q, k, v, o, do read and
    dq, dk, dv written, and the LSE."""
    flops = 2 * sq * sk * (3 * dqk + 2 * dv) * b * hq * (0.5 if causal
                                                         else 1.0)
    moved = (2 * b * hq * sq * dqk + 2 * b * hkv * sk * (dqk + dv)
             + 2 * b * hq * sq * dv) * nbytes + 4 * b * hq * sq
    t_ops = flops / peak * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def phase_general_backward():
    """19(b): K6's backward at its general form (and at seamless's encoder
    shape, a base form) against autograd through ``gqa_attention_ref`` on
    the card; two launches bit-identical; the launches by form; times at
    MLA's and the cross shape beside SDPA's backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda, general_form,
        is_base_form)
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    gen = torch.Generator().manual_seed(20)
    worst, err_abs, out = {}, 0.0, {}
    for label, b, hq, hkv, sq, sk, dqk, dv, causal, name, scale in \
            K6_GEN_BWD_SHAPES:
        dt_ = getattr(torch, name)
        q, k = randn(gen, (b, hq, sq, dqk), dt_), randn(gen, (b, hkv, sk,
                                                              dqk), dt_)
        v, do = randn(gen, (b, hkv, sk, dv), dt_), randn(gen, (b, hq, sq,
                                                               dv), dt_)
        base = is_base_form(q, k, v, scale)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=DEVICE)
        with torch.no_grad():
            o = flash_attention_cuda(q, k, v, causal, lse=lse, scale=scale)
        build.reset_launches()
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, scale)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, scale)
        key = "k6bwd" if base else GEN_BWD_KEY[general_form(dt_, dqk, dv)]
        check(build.LAUNCHES[key] == 2 and sum(build.LAUNCHES.values()) == 2,
              f"K6 backward at {label} launched {build.LAUNCHES}, want "
              f"{key} = 2")
        check(all(torch.equal(p, r) for p, r in zip(got, again)),
              f"K6 backward at {label}: two launches on the same inputs "
              f"gave different gradients")
        del again
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(gqa_attention_ref(*ref, causal, scale),
                                   ref, do.float())
        errs = []
        for nm, g, w in zip("qkv", got, want):
            e = float_err(g.float(), w)
            sc = float(w.abs().max())
            check(e <= K6_BWD_TOL[name] * sc, f"K6 general backward d{nm} "
                  f"!= plain at {label} {name}: max abs err {e} > "
                  f"{K6_BWD_TOL[name]} x {sc}")
            errs.append(e / sc)
            err_abs = max(err_abs, e)
        del ref, want, got
        worst[name] = max(worst.get(name, 0.0), *errs)
        log(f"[19] (b) K6 backward {label} (B={b} Hq={hq} Hkv={hkv} Sq={sq} "
            f"Sk={sk} Dqk={dqk} Dv={dv} {name}, causal={causal}, scale "
            f"{scale if scale else 'default'}; {key}): max |err| / max "
            f"|plain| dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g} "
            f"(gate {K6_BWD_TOL[name]}); a second launch bit-identical")
        if label not in K6_GEN_BWD_TIMED:
            continue

        def bwd():
            return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal,
                                            scale)

        parts, seen = k6_bwd_split(bwd)
        ms = device_ms(bwd, per_graph=2, replays=5)
        ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
        ref_out = gqa_attention_ref(*ref, causal, scale)
        plain_ms = events_ms(lambda: torch.autograd.grad(
            ref_out, ref, do.float(), retain_graph=True), n=3)
        del ref, ref_out
        lib_in = [t.detach().requires_grad_() for t in (q, k, v)]

        def sdpa():
            return F.scaled_dot_product_attention(
                *lib_in, is_causal=causal, scale=scale,
                enable_gqa=hq != hkv)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), lib_in, do)

        try:
            lib_ms = (device_ms(sdpa_fwd_bwd, per_graph=2, replays=10)
                      - device_ms(sdpa, per_graph=10, replays=5))
        except RuntimeError as e:  # no SDPA backend takes the shape
            log(f"[19] (b) SDPA's backward at {label} did not run: "
                f"{str(e)[:200]}")
            lib_ms = None
        del lib_in
        bound, by, flops = k6_gen_bwd_bound_ms(
            b, hq, hkv, sq, sk, dqk, dv, causal, 2, BF16_FLOPS_PER_S)
        log(f"[19] (b) K6 general backward at {label}: device "
            f"{ms * 1e3:.1f} us/launch (CUDA graphs; row sums "
            f"{parts['delta_kernel']:.1f} + dK/dV {parts['dkdv_kernel']:.1f}"
            f" + dQ {parts['dq_kernel']:.1f} us by the profiler, {seen} or "
            f"more of 10 launches recorded); plain autograd "
            f"{plain_ms * 1e3:.1f} us in float32; SDPA's backward "
            f"{'not measured' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}"
            f" (its forward + backward less its forward, CUDA graphs; timed "
            f"only); bound {bound * 1e3:.2f} us "
            f"({flops / 1e9:.2f} GFLOP at 989 TFLOP/s; {by}; "
            f"{bound / ms:.1%} of it)")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": lib_ms}
    log(f"[19] (b) K6 backward on {len(K6_GEN_BWD_SHAPES)} cases: worst "
        f"max |err| / max |plain| {worst['float32']:.3g} float32, "
        f"{worst['bfloat16']:.3g} bf16")
    out["max_abs_err"] = err_abs
    return out


def train_cell(tag, cfg, init, batch_at, tokens, want, plain=True):
    """19(c): one model at its published widths trains on the card in bf16
    (float32 masters drawn on the card): the first batch's loss and
    gradients with the kernels against those with every kernel's plain
    version (``plain``), every gradient finite and not all zero, then
    ``FAMILY_STEPS`` steps of ``make_train_step``, with the kernels' launches
    a step held to ``want``. Returns the cell's record."""
    import gc

    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init, global_norm, schedules

    bf16 = torch.bfloat16
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                  device=DEVICE, dtype=torch.float32)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_leaves = len(list(_leaves(params)))
    log(f"[19] (c) {tag}: {n_params / 1e9:.4f} B parameters, float32 masters "
        f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    lfn = registry.loss_fn(cfg)
    kernels = [k for k in build.LAUNCHES if k.startswith(("k6", "k7"))]
    rel = ""
    if plain:
        build.reset_launches()
        with plain_kernels():
            loss_p, _, grads = loss_and_grads(lfn, params, batch_at(0), bf16)
            gn_p = float(global_norm(grads))
        check(not any(build.LAUNCHES[k] for k in kernels),
              f"{tag}: the plain step launched {build.LAUNCHES}")
        del grads
    build.reset_launches()
    loss_k, _, grads = loss_and_grads(lfn, params, batch_at(0), bf16)
    gn_k = float(global_norm(grads))
    leaves = list(_leaves(grads))
    bad = [i for i, g in enumerate(leaves)
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    check(not bad, f"{tag}: {len(bad)} of {len(leaves)} parameters got a "
          f"gradient that is not finite or is zero (leaves {bad[:10]})")
    del grads, leaves
    loss_k = float(loss_k)
    if plain:
        loss_p = float(loss_p)
        check(abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
              and abs(gn_k - gn_p) <= 1e-2 * gn_p,
              f"{tag}: the kernel step (loss {loss_k}, grad norm {gn_k}) is "
              f"off the plain step (loss {loss_p}, grad norm {gn_p})")
        rel = (f"; with every kernel's plain version loss {loss_p:.6f} (rel "
               f"{abs(loss_k - loss_p) / loss_p:.2e}, gate 1e-3), grad norm "
               f"{gn_p:.5f} (rel {abs(gn_k - gn_p) / gn_p:.2e}, gate 1e-2)")
    log(f"[19] (c) {tag} step 0 with the kernels: loss {loss_k:.6f}, grad "
        f"norm {gn_k:.5f}; every one of {n_leaves} parameters got a "
        f"finite, non-zero gradient{rel}")
    opt = adamw_init(params)
    step = make_train_step(cfg, schedule=schedules.make(
        "cosine", 1e-4, FAMILY_STEPS, warmup=1), dtype=bf16, device=DEVICE)
    walls, losses = [], []
    build.reset_launches()
    for i in range(FAMILY_STEPS):
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    per_step = {k: build.LAUNCHES[k] / FAMILY_STEPS for k in kernels}
    check(all(x == x and abs(x) < 1e4 for x in losses), f"{tag}: losses "
          f"{losses}")
    check(per_step == {k: want.get(k, 0) for k in kernels}, f"{tag}: "
          f"launches a step {per_step}, want {want} and no other kernel")
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(walls[1:]) * 1e3
    log(f"[19] (c) {tag}: {FAMILY_STEPS} steps bf16, losses "
        f"{[round(x, 5) for x in losses]}; wall per step "
        f"{[round(w * 1e3, 1) for w in walls]} ms, median of steps 2-"
        f"{FAMILY_STEPS} {ms:.1f} ms = {tokens / ms * 1e3:.0f} tokens/s; "
        f"peak allocated {peak / 1e9:.2f} GB; kernel launches a step "
        f"{ {k: v for k, v in per_step.items() if v} }")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "tokens_s": tokens / ms * 1e3, "peak_gb": peak / 1e9,
            "launches": {k: build.LAUNCHES[k] for k in kernels}}


def phase_family_training():
    """19(c): jamba, deepseek-v3, xlstm-1.3b and seamless-m4t-medium, the
    four families the port served but did not train, train on the card
    at their published widths (depth cut as ``reduced`` says)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import encdec, lm

    def lm_batches(cfg, b, s):
        source = SyntheticLM(cfg, b, s, seed=0)
        return lambda i: {k: torch.from_numpy(v).to(DEVICE)
                          for k, v in source.batch_at(i).items()}

    out = {}
    # jamba: one period (7 Mamba + 1 attention), 2 experts top-2
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS, n_experts=2)
    kinds = [m for m, _ in lm.layer_kinds(cfg)]
    nm, na = kinds.count("mamba"), kinds.count("attn")
    out["jamba"] = train_cell(
        f"jamba-v0.1-52b ({cfg.n_layers} of {full.n_layers} layers: {nm} "
        f"Mamba, {na} attention; {cfg.n_experts} of {full.n_experts} "
        f"experts, top-{cfg.top_k}; d_model {cfg.d_model}, d_inner "
        f"{cfg.ssm_expand * cfg.d_model}), B 2 x S 1024", cfg,
        lm.init_params, lm_batches(cfg, 2, 1024), 2 * 1024,
        {"k7": 2 * nm, "k7bwd": nm, "k6": 2 * na, "k6bwd": na})
    # deepseek-v3: its 3 dense prefix layers, no MoE layer (the prefix is
    # not under remat, as in the reference: one K6 forward a layer)
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=len(full.prefix))
    bd = DEEPSEEK_TRAIN_BATCH
    out["deepseek"] = train_cell(
        f"deepseek-v3-671b ({cfg.n_layers} of {full.n_layers} layers: the "
        f"dense prefix, MLA Dqk 192 / Dv 128, no MoE layer), B {bd} x S "
        f"1024", cfg, lm.init_params, lm_batches(cfg, bd, 1024), bd * 1024,
        {"k6gen_tc": cfg.n_layers, "k6bwd_gen_tc": cfg.n_layers})
    # xlstm-1.3b: one period (7 mLSTM + 1 sLSTM); no kernel on its path
    full = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(full, n_layers=len(full.period))
    out["xlstm"] = train_cell(
        f"xlstm-1.3b ({cfg.n_layers} of {full.n_layers} layers: 7 mLSTM + 1 "
        f"sLSTM, d_model {cfg.d_model}; chunks of 64 / 128 under "
        f"checkpoint), B 2 x S 256", cfg, lm.init_params,
        lm_batches(cfg, 2, 256), 2 * 256, {}, plain=False)
    # seamless-m4t-medium, unreduced: 1024 source frames, 256 target tokens
    cfg = get_config("seamless-m4t-medium")
    b, s_src, s_tgt = 4, 1024, 256
    source = SyntheticLM(cfg, b, s_tgt, seed=0)

    def seamless_batch(i):
        batch = source.batch_at(i)
        rng = np.random.default_rng(100 + i)
        batch["src_embeds"] = (rng.standard_normal(
            (b, s_src, cfg.d_model)) * 0.02).astype(np.float32)
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}

    n = cfg.n_layers
    out["seamless"] = train_cell(
        f"seamless-m4t-medium (unreduced: {cfg.n_enc_layers} + {n} layers), "
        f"B {b} x S_src {s_src} / S_tgt {s_tgt} (tokens/s counts target "
        f"tokens)", cfg, encdec.init_params, seamless_batch, b * s_tgt,
        {"k6": cfg.n_enc_layers + n, "k6bwd": cfg.n_enc_layers + n,
         "k6gen_tc": n, "k6bwd_gen_tc": n})
    return out


def phase_every_family_trains():
    """Phase 19: K7's backward, K6's general backward, then every family
    the port serves trains on the card."""
    return {"k7bwd": phase_scan_backward(),
            "k6bwd_gen": phase_general_backward(),
            "families": phase_family_training()}


def placement_check():
    """``sweep_topologies`` on phase 15(a)'s grid with no device given, at
    once and streamed: each topology runs on the card
    ``round_robin_devices`` gives it, and every lane equals the same
    sweep's on ``cuda:0``."""
    import torch
    from repro_torch import golden
    from repro_torch.core import MemSimConfig, sweep_topologies
    from repro_torch.distributed.shard import round_robin_devices
    from repro_torch.traces import BENCHMARKS

    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    trace = BENCHMARKS["conv2d"]()
    want = sweep_topologies(cfg, trace, TOPO_SWEEP_GRID, TOPO_SWEEP_CYCLES,
                            device=DEVICE)
    n_topo = len(want.topologies)
    cards = [str(d) for d in round_robin_devices(n_topo)]
    for stream in (False, True):
        tm = {}
        t0 = time.perf_counter()
        got = sweep_topologies(cfg, trace, TOPO_SWEEP_GRID,
                               TOPO_SWEEP_CYCLES, stream=stream, timings=tm)
        wall = time.perf_counter() - t0
        if stream:
            placed = {r["topology"]: r["device"] for r in tm["per_chunk"]}
            placed = [placed[gi] for gi in range(n_topo)]
        else:
            placed = [r["device"] for r in tm["per_topology"]]
        form = "streamed" if stream else "at once"
        check(placed == cards, f"sweep_topologies {form} with no device "
              f"placed its topologies on {placed}, not {cards}")
        bad = [i for i, (a, b) in enumerate(zip(want, got)) if same_lane(a, b)]
        check(len(got) == len(want) and not bad, f"sweep_topologies {form} "
              f"over {sorted(set(cards))}: lanes {bad} differ from cuda:0's")
        log(f"[20] sweep_topologies {form}, no device given, on "
            f"{torch.cuda.device_count()} card(s): {n_topo} topologies on "
            f"{', '.join(placed)}; all {len(got)} lanes equal the sweep on "
            f"{DEVICE}; {wall:.3f} s wall")


def phase_cost_model():
    """Phase 20: the analytic cost model, the shape specs,
    ``compressed_psum`` and ``round_robin_devices`` on the card."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.distributed.shard import round_robin_devices
    from repro_torch.launch.specs import batch_specs
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import lm, registry
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.perfmodel.analytic import (
        HBM_BW, PEAK_FLOPS, cell_cost, param_counts, roofline_terms)

    # (a) the counts of every config, then xlstm-1.3b's real tree
    counts = {name: param_counts(cfg) for name, cfg in sorted(ARCHS.items())}
    log("[20] param_counts (B total / routed / active): " + "; ".join(
        f"{n} {c['total'] / 1e9:.3f} / {c['routed_experts'] / 1e9:.3f} / "
        f"{c['active'] / 1e9:.3f}" for n, c in counts.items()))
    cfg = get_config("xlstm-1.3b")
    check(cfg.n_layers == 48 and cfg.d_model == 2048, "xlstm-1.3b config "
          "is not the published one")
    fresh_memory("xlstm-1.3b", phase="20")
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), device=DEVICE, dtype=torch.bfloat16)
    n_real = sum(t.numel() for t in _leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    check(n_real == counts["xlstm-1.3b"]["total"], f"xlstm-1.3b on the "
          f"card holds {n_real} parameters, param_counts says "
          f"{counts['xlstm-1.3b']['total']:.0f}")
    log(f"[20] xlstm-1.3b on the card: {n_real} parameters = "
        f"param_counts' total, {w_bytes / 1e9:.3f} GB in bf16 (norm "
        f"scales and biases float32)")

    # (b) the long_500k cell's cache shapes against the real caches
    b, s = 1, 524288
    spec = batch_specs(cfg, "long_500k")["caches"]
    caches = registry.init_caches(cfg, b, s, torch.bfloat16, device=DEVICE)
    want = [(tuple(t.shape), t.dtype) for t in _leaves(caches)]
    got = [(tuple(t.shape), t.dtype) for t in _leaves(spec)]
    check(got == want and all(t.device.type == "meta"
                              for t in _leaves(spec)),
          f"batch_specs' long_500k caches {got[:3]}... differ from "
          f"init_caches' {want[:3]}...")
    kv_real = sum(t.numel() * t.element_size() for t in _leaves(caches))
    log(f"[20] long_500k caches: {len(got)} leaves in {len(caches)} layers "
        f"agree in shape and dtype; {kv_real} B on the card")

    # (c) one decode step at position 524 287 against the roofline
    step = make_decode_step(cfg, dtype=torch.bfloat16)
    token = torch.full((b,), 7, dtype=torch.int32, device=DEVICE)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=DEVICE)
    nxt, logits, caches = step(params, caches, token, pos)
    check(logits.shape == (b, cfg.vocab) and bool(torch.isfinite(
        logits).all()), "xlstm long_500k decode logits are not finite")
    for _ in range(2):
        nxt, logits, caches = step(params, caches, token, pos)
    times = []
    for _ in range(10):
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        e0.record()
        nxt, logits, caches = step(params, caches, token, pos)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    ms = statistics.median(times)
    check(bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in _leaves(caches)),
        "xlstm long_500k decode: logits or states not finite after 13 "
        "steps")
    with FlopCounterMode(display=False) as fc:
        step(params, caches, token, pos)
    torch.cuda.synchronize()
    flops_real = fc.get_total_flops()
    cost = cell_cost(cfg, "long_500k", devices=1)
    terms = roofline_terms(cost, 0.0, 1)
    bound_ms = terms["bound_s"] * 1e3
    log(f"[20] xlstm-1.3b long_500k decode step (B 1, bf16, position "
        f"{s - 1}): {ms:.3f} ms median of 10 (CUDA events; min "
        f"{min(times):.3f}, max {max(times):.3f}); analytic bound "
        f"{bound_ms:.4f} ms ({terms['dominant']}: hbm_bytes "
        f"{cost.hbm_bytes:.0f} B at {HBM_BW:.3g} B/s; compute "
        f"{terms['compute_s'] * 1e3:.4f} ms at {PEAK_FLOPS:.3g} FLOP/s), "
        f"the step at {bound_ms / ms:.3f} of it; roofline_fraction "
        f"{terms['roofline_fraction']:.6f}; flops_fwd analytic "
        f"{cost.flops_fwd:.0f}, FlopCounterMode {flops_real}; kv_bytes "
        f"analytic {cost.kv_bytes:.0f}, real caches {kv_real}; weights "
        f"{w_bytes} B")
    check(ms * 1e-3 >= terms["bound_s"], f"the decode step took {ms:.4f} "
          f"ms, under the analytic bound {bound_ms:.4f} ms: a wrong "
          f"constant or count")
    # the bound's bytes, held to the card's: hbm_bytes is the weights at
    # 2 B a parameter, the caches and an activation term; the model keeps
    # no float32 norm scale and the mLSTM's C alone (not its n and m), so
    # it reads ~1e-4 under the real bytes, and 1e-3 is the gate
    act = cost.tokens * cfg.d_model * 2 * (cfg.n_layers + cfg.n_enc_layers) \
        * 4
    rel = (cost.hbm_bytes - act) / (w_bytes + kv_real) - 1.0
    log(f"[20] hbm_bytes less its activation term {act:.0f} B: "
        f"{cost.hbm_bytes - act:.0f} B against the card's weights and "
        f"caches {w_bytes + kv_real} B, rel {rel:.3e} (gate 1e-3)")
    check(abs(rel) <= 1e-3, f"the analytic bytes {cost.hbm_bytes - act:.0f}"
          f" B are off the card's weights and caches {w_bytes + kv_real} B "
          f"by rel {rel:.3e}, more than 1e-3: a wrong count")
    del params, caches, logits

    # (d) compressed_psum: one NCCL rank on the card, one gloo rank on the
    # CPU, the same seeded input
    x = np.random.default_rng(20).normal(0.0, 1.0, (4096, 1024)).astype(
        np.float32)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        gloo = dist.new_group([0], backend="gloo")
        on_card = compressed_psum(torch.from_numpy(x).to(DEVICE)).cpu()
        on_cpu = compressed_psum(torch.from_numpy(x), group=gloo)
    finally:
        dist.destroy_process_group()
    scale = float((np.abs(x).max() + np.float32(1e-12)) / np.float32(127))
    diff = float((on_card - on_cpu).abs().max())
    check(diff <= scale, f"compressed_psum: NCCL on the card and gloo on "
          f"the CPU differ by {diff}, more than one quantum {scale}")
    log(f"[20] compressed_psum {tuple(x.shape)} float32, one rank: NCCL on "
        f"the card against gloo on the CPU "
        + ("bit for bit" if diff == 0 else
           f"within one quantum ({diff} <= {scale})"))

    # (e) launches placed round-robin over the visible cards
    n = torch.cuda.device_count()
    got = round_robin_devices(8)
    check(got == [torch.device("cuda", i % n) for i in range(8)],
          f"round_robin_devices(8) on {n} card(s): {got}")
    log(f"[20] round_robin_devices(8) on {n} card(s): "
        + ", ".join(str(d) for d in got))
    placement_check()
    return {"decode_ms": ms, "bound_ms": bound_ms, "flops_real": flops_real,
            "psum_bitwise": diff == 0}


def k3_step_times():
    """The single-lane persistent K3's device time per executed step on
    the four traces at 100k cycles, three launches each (CUDA events), of
    the port imported from ``sys.path``: run once per checkout, each in its
    own process, to compare two checkouts on one card (A B B A)."""
    import torch
    from repro_torch.core import MemSimConfig
    from repro_torch.core.engine import _sched_i32
    from repro_torch.core.simulator import ScheduleView, init_state
    from repro_torch.kernels import build
    from repro_torch.kernels.bank_fsm.fused import fused_run_cuda
    from repro_torch.traces import BENCHMARKS

    build.load()
    cfg = MemSimConfig(queue_size=128)
    topo = cfg.topology()
    view = ScheduleView(topo, _sched_i32(cfg.runtime()), DEVICE)
    for name in sorted(BENCHMARKS):
        tr = BENCHMARKS[name]().to(DEVICE)
        per = []
        for _ in range(3):
            state = init_state(topo, view, tr.num_requests, device=DEVICE)
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            _, n = fused_run_cuda(topo, view, tr, state, 0, 100_000)
            e.record()
            torch.cuda.synchronize()
            per.append(s.elapsed_time(e) * 1e3 / n)
        log(f"k3 step times {build.CSRC.parents[2]} {name}: {n} steps, "
            + ", ".join(f"{x:.4f}" for x in per) + " us/step")


def split_times():
    """The split backend's ``simulate_fast`` on conv2d at 20k cycles (phase
    4's run) of the port imported from ``sys.path``, its wall seconds and
    steps: run once per checkout, each in its own process, to compare two
    checkouts on one card (A B B A)."""
    from repro_torch.core import MemSimConfig, simulate_fast
    from repro_torch.kernels import build
    from repro_torch.traces import conv2d

    build.load()
    cfg = MemSimConfig(queue_size=128, fsm_backend="split")
    tm = {}
    t0 = time.perf_counter()
    simulate_fast(cfg, conv2d(), 20_000, timings=tm, device=DEVICE)
    log(f"split times {build.CSRC.parents[2]}: simulate_fast split "
        f"conv2d@20000 {time.perf_counter() - t0:.3f} s wall, "
        f"{tm['steps']} steps")


def topology_sweep_times():
    """Phase 15(a)'s sweep twice in this fresh process, of the port
    imported from ``sys.path``: its kernels built and loaded first, but no
    form of the lane-batched K3 loaded into the card's context before the
    first sweep. Each sweep's wall, each launch's start and device time and
    the first start to the last end: run once per checkout, each in its
    own process, to compare two checkouts on one card (A B B A)."""
    import torch
    from repro_torch import golden
    from repro_torch.core import MemSimConfig
    from repro_torch.kernels import build
    from repro_torch.traces import BENCHMARKS

    build.load()
    torch.zeros(1, device=DEVICE)  # the context, before the first sweep
    cfg = MemSimConfig(queue_size=golden.QUEUE_SIZE)
    trace = BENCHMARKS["conv2d"]()
    for run in ("first", "second"):
        _, _, wall, spans = timed_sweep(cfg, trace)
        log(f"topology sweep {build.CSRC.parents[2]}, {run} in the "
            f"process: {wall:.3f} s wall; " + spans_text(spans))


#: K6's base forms timed against another checkout: (label, b, hq, hkv, s,
#: d), causal bf16 at qwen3-14b's prefill and minicpm-2b's training shape
K6_BASE_TIMED = [("qwen3", 2, 40, 8, 1024, 128), ("minicpm", 4, 36, 36, 1024,
                                                    64)]


def k6_gen_times():
    """K6's general form at MLA's prefill shape (phase 18(a)), its base
    forms at ``K6_BASE_TIMED`` (device µs a launch, CUDA graphs, bf16
    causal), K6's general backward at ``K6_GEN_BWD_TIMED`` (phase 19(b)'s
    MLA and cross shapes) and its base forms' backward at ``K6_BWD_TIMED``
    (phase 17's minicpm-2b and qwen3-14b bf16 shapes; device µs a launch,
    CUDA graphs) and deepseek-v3 cut to 4 layers prefilling 2 x 1024 (phase
    18(b)'s cell: wall ms of 3 prefills after a warm-up, and the K6
    launches of one), of the port imported from ``sys.path``: run once per
    checkout, each in its own process, to compare two checkouts on one
    card (A B B A)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.launch.steps import make_prefill
    from repro_torch.models import lm

    build.load()
    where = build.CSRC.parents[2]
    gen = torch.Generator().manual_seed(26)
    bf16 = torch.bfloat16
    b, hq, hkv, s, _, dqk, dv, causal = K6_GEN_MLA
    q, k, v = (randn(gen, (b, h, s, d), bf16)
               for h, d in ((hq, dqk), (hkv, dqk), (hkv, dv)))
    ms = device_ms(lambda: flash_attention_cuda(q, k, v, causal,
                                                scale=gen_scale(dqk, dv)),
                   per_graph=2)
    cells = [f"general MLA {ms * 1e3:.1f}"]
    for label, b, hq, hkv, s, d in K6_BASE_TIMED:
        q, k, v = (randn(gen, (b, h, s, d), bf16) for h in (hq, hkv, hkv))
        ms = device_ms(lambda: flash_attention_cuda(q, k, v, True),
                       per_graph=20)
        cells.append(f"base {label} {ms * 1e3:.1f}")
    bwd = [(f"general bwd {label}", b, hq, hkv, sq, sk, dqk, dv, causal,
            scale)
           for label, b, hq, hkv, sq, sk, dqk, dv, causal, _, scale
           in K6_GEN_BWD_SHAPES if label in K6_GEN_BWD_TIMED]
    bwd += [(f"base bwd {label}", b, hq, hkv, s, s, d, d, causal, None)
            for label, b, hq, hkv, s, d, name, causal in K6_BWD_SHAPES
            if label in K6_BWD_TIMED]
    for label, b, hq, hkv, sq, sk, dqk, dv, causal, scale in bwd:
        q, k = randn(gen, (b, hq, sq, dqk), bf16), randn(gen, (b, hkv, sk,
                                                               dqk), bf16)
        v, do = randn(gen, (b, hkv, sk, dv), bf16), randn(gen, (b, hq, sq,
                                                                dv), bf16)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=DEVICE)
        with torch.no_grad():
            o = flash_attention_cuda(q, k, v, causal, lse=lse, scale=scale)
        ms = device_ms(lambda: flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal, scale), per_graph=2, replays=10)
        cells.append(f"{label} {ms * 1e3:.1f}")
        del o, lse, do
    del q, k, v
    log(f"k6 gen times {where}: " + "; ".join(cells) + " us/launch")
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"),
                              n_layers=DEEPSEEK_LAYERS)
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), device=DEVICE, dtype=bf16)
    toks = torch.randint(1, cfg.vocab, (2, 1024),
                         generator=torch.Generator().manual_seed(5))
    prefill = make_prefill(cfg, dtype=bf16)
    prefill(params, {"tokens": toks})
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        prefill(params, {"tokens": toks})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    k6 = {key: n for key, n in build.LAUNCHES.items() if key.startswith("k6")
          and n}
    log(f"k6 gen times {where}: deepseek-v3 ({cfg.n_layers} layers) prefill "
        f"2 x 1024 " + ", ".join(f"{w:.1f}" for w in walls) + f" ms; K6 "
        f"launches a prefill {k6}")


def k7_bwd_times():
    """K7's backward (from the saving forward's checkpoints where the
    checkout has them, and from the inputs alone) and K7's forward (plain,
    and saving where the checkout has it) at jamba's training shape
    ``K7_BWD_TIMED`` bf16 (device µs a launch, CUDA events over 20 launches
    after 3), then phase 19(c)'s jamba cell (8 layers, 2 experts, B 2 x S
    1024, bf16) trained 5 steps with the kernels (wall ms a step, the
    median of steps 2-5, and peak allocated GB), of the port imported from
    ``sys.path``: run once per checkout, each in its own process, to
    compare two checkouts on one card (A B B A)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan import selective_scan as k7
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init, schedules

    build.load()
    where = build.CSRC.parents[2]
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(29)
    x, dt, bc, cc, a = scan_inputs(gen, *K7_BWD_TIMED, bf16)
    dy = randn(gen, x.shape, bf16)
    save = getattr(k7, "selective_scan_save_cuda", None)
    runs = []
    if save is not None:
        hs = save(x, dt, bc, cc, a)[2]
        runs.append(("bwd from checkpoints",
                     lambda: k7.selective_scan_bwd_cuda(x, dt, bc, cc, a, dy,
                                                        None, hs)))
    runs.append(("bwd from inputs", lambda: k7.selective_scan_bwd_cuda(
        x, dt, bc, cc, a, dy)))
    runs.append(("fwd plain", lambda: k7.selective_scan_cuda(x, dt, bc, cc,
                                                              a)))
    if save is not None:
        runs.append(("fwd saving", lambda: save(x, dt, bc, cc, a)))
    cells = [f"{label} {events_ms(fn, n=20, warm=3) * 1e3:.1f}"
             for label, fn in runs]
    log(f"k7 bwd times {where}: {K7_BWD_TIMED} bf16 " + "; ".join(cells)
        + " us/launch")
    del x, dt, bc, cc, a, dy, runs
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS, n_experts=2)
    source = SyntheticLM(cfg, 2, 1024, seed=0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        0), device=DEVICE, dtype=torch.float32)
    opt = adamw_init(params)
    n_steps = 5
    step = make_train_step(cfg, schedule=schedules.make(
        "cosine", 1e-4, n_steps, warmup=1), dtype=bf16, device=DEVICE)
    walls, losses = [], []
    build.reset_launches()
    for i in range(n_steps):
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in source.batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    k7n = {k: n // n_steps for k, n in build.LAUNCHES.items()
           if k.startswith("k7") and n}
    log(f"k7 bwd times {where}: jamba ({cfg.n_layers} layers, "
        f"{cfg.n_experts} experts) B 2 x S 1024 bf16 step walls "
        + ", ".join(f"{w:.1f}" for w in walls) + f" ms, median of steps "
        f"2-{n_steps} {statistics.median(walls[1:]):.1f} ms; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; losses "
        f"{[round(v, 4) for v in losses]}; K7 launches a step {k7n}")


#: ``--k7-bwd-parts``: K7's backward with one part taken out, as text
#: substitutions in csrc/selective_scan_bwd.cu (label -> [(text,
#: replacement)]); their outputs are wrong by design, only times are read
K7_BWD_PARTS = {
    "whole": [],
    "no consumer arithmetic": [(
        "    // h_{t0 - 1 + k} for k = 0 .. TC: the checkpoint, then the chunk",
        "    if (D > 0) { mbar_arrive(empty(s)); continue; }")],
    "no consumer arithmetic, no write-back": [
        ("    // h_{t0 - 1 + k} for k = 0 .. TC: the checkpoint, then the "
         "chunk", "    if (D > 0) { mbar_arrive(empty(s)); continue; }"),
        ("      const int nt = min(TC, Tn - t0);\n      if (vec) {\n"
         "        if (pl == 0) {\n          tma_store_3d",
         "      const int nt = min(TC, Tn - t0);\n      if (D > 0) return;\n"
         "      if (vec) {\n        if (pl == 0) {\n          tma_store_3d")],
    "no reverse pass": [(
        "    StepIn<P> nxt;",
        "    if (D > 0) { for (int p = 0; p < P; ++p) dA[p] += hh[TC][p]; "
        "mbar_arrive(empty(s)); continue; }\n    StepIn<P> nxt;")],
    "no exp in the reverse step": [(
        "        const float e = kEx2 ? ex2(x2) : expf(x2);\n"
        "        const float g",
        "        const float e = x2;\n        const float g")],
    "no shuffle sums": [
        ("reduce_scatter<2 * P, L, 16>(v, lane);", ""),
        ("reduce_scatter<2, 1, L / 2>(w, lane);", "")],
    "three stages": [("constexpr int kStages = 2;",
                      "constexpr int kStages = 3;")],
}


def k7_bwd_parts():
    """K7's backward of the port imported from ``sys.path`` with one part
    taken out at a time (``K7_BWD_PARTS``): each form built by nvcc from a
    copy of its ``csrc/`` (all together, under the git-ignored build
    directory), loaded with ctypes and timed at jamba's training shape
    ``K7_BWD_TIMED`` bf16 through its sweep entry at the production shape
    (device µs a launch, CUDA events over 10 after 2). A part whose text is
    not in that checkout's source prints n/a. What a form saves is what
    that part costs where the others overlap it."""
    import ctypes
    import shutil

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.selective_scan.selective_scan import (
        selective_scan_save_cuda)

    build.load()
    where = build.CSRC.parents[2]
    lanes, channels, chunk = k7_bwd_production()["shape"]
    src = (build.CSRC / "selective_scan_bwd.cu").read_text()
    work = build.BUILD_ROOT / "k7_bwd_parts"
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    for i, (label, subs) in enumerate(K7_BWD_PARTS.items()):
        text = src
        if not all(old in text for old, _ in subs):
            procs[label] = None
            continue
        for old, new in subs:
            text = text.replace(old, new)
        d = work / str(i)
        shutil.copytree(build.CSRC, d)
        (d / "selective_scan_bwd.cu").write_text(text)
        procs[label] = (d, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "selective_scan_bwd.cu")],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT))
    gen = torch.Generator().manual_seed(29)
    b, t, d_, s = K7_BWD_TIMED
    x, dt, bc, cc, a = scan_inputs(gen, b, t, d_, s, torch.bfloat16)
    dy = randn(gen, x.shape, torch.bfloat16)
    hs = selective_scan_save_cuda(x, dt, bc, cc, a, chunk)[2]
    f32 = dict(dtype=torch.float32, device=DEVICE)
    outs = [torch.empty_like(v) for v in (x, dt, bc, cc)] + [
        torch.empty((d_, s), **f32)]
    pa = torch.empty((b, d_, s), **f32)
    part = torch.empty((b, -(-d_ // channels), t, 2 * s), **f32)
    cells = []
    for label, proc in procs.items():
        if proc is None:
            cells.append(f"{label} n/a")
            continue
        d, p = proc
        check(p.wait() == 0, f"nvcc failed on the form '{label}'")
        fn = ctypes.CDLL(str(d / "lib.so")).selective_scan_bwd_sweep_launch
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]

        def run():
            build.check(fn(*(v.data_ptr() for v in (x, dt, bc, cc, a, dy)),
                           None, hs.data_ptr(), part.data_ptr(),
                           pa.data_ptr(), *(g.data_ptr() for g in outs), b,
                           t, d_, lanes, channels, chunk,
                           build.stream_of(x)), f"K7 backward, {label}")

        cells.append(f"{label} {events_ms(run, n=10, warm=2) * 1e3:.1f}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"k7 bwd parts {where}: {K7_BWD_TIMED} bf16 at (lanes, channels, "
        f"chunk) {(lanes, channels, chunk)}, us/launch: " + "; ".join(cells))


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    # --k3-step-times / --k6-bwd-times / --k6-gen-times / --k7-bwd-times
    # / --k7-bwd-parts / --train-kernel-times / --split-times /
    # --topology-sweep / --placement CHECKOUT: only that timing or check,
    # of that checkout's port
    only = {"--k3-step-times": k3_step_times,
            "--k6-bwd-times": k6_bwd_times,
            "--k6-gen-times": k6_gen_times,
            "--k7-bwd-times": k7_bwd_times,
            "--k7-bwd-parts": k7_bwd_parts,
            "--train-kernel-times": train_kernel_times,
            "--split-times": split_times,
            "--topology-sweep": topology_sweep_times,
            "--placement": placement_check}.get(
                sys.argv[1] if len(sys.argv) == 3 else None)
    step_times = only is not None
    root = Path(sys.argv[2]).resolve() if step_times else ROOT
    sys.path.insert(0, str(root / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: src/repro_torch not found under {root}",
              file=sys.stderr)
        return 2
    if step_times:
        only()
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    drills = []  # 17(c)'s drill, started in phase 16
    walls = []

    def timed(fn, *args):  # a phase's wall, printed after the run
        t0 = time.perf_counter()
        out = fn(*args)
        walls.append(f"{fn.__name__} {time.perf_counter() - t0:.1f}")
        return out

    try:
        card = timed(phase_device)
        errs = timed(phase_kernels)
        errs["k3run"] = timed(phase_fused_run)
        errs["k3cyc"] = timed(phase_cycle_run)
        k3run_launches = timed(phase_main_path)
        split_launches = timed(phase_per_cycle)
        times = timed(phase_times)
        run_times, run_plain_ms, cyc_times, cyc_plain_ms = timed(
            phase_run_times)
        timed(phase_trace)
        attn_errs = timed(phase_attention_kernels)
        llm_launches = timed(phase_serve)
        attn_times = timed(phase_attention_times)
        scan_err = timed(phase_scan_kernel)
        hybrid_launches = timed(phase_jamba)
        k4_launches, k4_err = timed(phase_addr_map)
        hybrid_times = timed(phase_hybrid_times)
        batch = timed(phase_batch)
        sessions = timed(phase_sessions, run_plain_ms, batch["plain_ms"])
        topologies = timed(phase_topologies)
        stream = timed(phase_stream, drills)
        waited = drills[0].join_first()
        log(f"[17] waited {waited:.1f} s for 17(c)'s first two children "
            f"to end before 17(a)")
        k6_bwd = timed(phase_attention_backward)
        k6_bwd["launches"] = timed(phase_train, drills[0])
        families = timed(phase_families)
        trains = timed(phase_every_family_trains)
        timed(phase_cost_model)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for drill in drills:
            drill.stop()
    src = "src/repro_torch/csrc/"
    ref = "src/repro/kernels/bank_fsm/"
    meta = {
        "k1": ("bank_fsm_step", src + "bank_fsm.cu", ref + "bank_fsm.py:332",
               split_launches["k1"]),
        "k2": ("bank_event_bound", src + "bank_fsm.cu",
               ref + "bank_fsm.py:300", split_launches["k2"]),
        "k3": ("fused_step", src + "fused.cu", ref + "fused.py:397",
               split_launches["k3"]),
    }
    kernels = []
    for k, (name, source, replaces, launches) in meta.items():
        ms, plain_ms, bound_ms, _ = times[k]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})
    # the persistent K3, per executed step on conv2d at 100k cycles
    ms_step, _, _, bound_step, _ = run_times["conv2d"]
    kernels.append({
        "name": "fused_run", "route": "cuda", "source": src + "fused.cu",
        "replaces": ref + "fused.py:397", "launches": k3run_launches,
        "max_abs_err": errs["k3run"], "ms": ms_step, "plain_ms": run_plain_ms,
        "bound_ms": bound_step, "bound_by": "bytes", "library_ms": None})
    # its per-cycle form (simulate), per cycle on conv2d at 100k cycles
    ms_cyc, _, _, bound_cyc, _ = cyc_times["conv2d"]
    kernels.append({
        "name": "fused_run_cycle", "route": "cuda",
        "source": src + "fused.cu", "replaces": ref + "fused.py:397",
        "launches": split_launches["k3cyc"], "max_abs_err": errs["k3cyc"],
        "ms": ms_cyc, "plain_ms": cyc_plain_ms, "bound_ms": bound_cyc,
        "bound_by": "bytes", "library_ms": None})
    # the lane-batched persistent K3, per executed step of the longest lane
    # of the Table-2 batch at 100k cycles
    kernels.append({
        "name": "fused_run_batch", "route": "cuda",
        "source": src + "fused.cu", "replaces": ref + "fused.py:397",
        "launches": batch["launches"], "max_abs_err": 0,
        "ms": batch["ms"], "plain_ms": batch["plain_ms"],
        "bound_ms": batch["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    # the session path: fused SimSession windows (one persistent K3 launch
    # each) and SessionBatch windows (one lane-batched launch each), per
    # executed step inside windows
    for key, name in (("run", "fused_run_session"),
                      ("batch", "fused_run_batch_session")):
        rec = sessions[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src + "fused.cu",
            "replaces": ref + "fused.py:397", "launches": rec["launches"],
            "max_abs_err": 0, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    # the topology sweep: one lane-batched launch a topology, per executed
    # step of the longest lane of the slowest topology alone
    kernels.append({
        "name": "fused_run_batch_topologies", "route": "cuda",
        "source": src + "fused.cu", "replaces": ref + "fused.py:397",
        "launches": topologies["launches"], "max_abs_err": 0,
        "ms": topologies["ms"], "plain_ms": topologies["plain_ms"],
        "bound_ms": topologies["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    # the streaming sweep: one lane-batched launch a chunk, per executed
    # step of the longest lane of 16(a)'s slowest chunk
    kernels.append({
        "name": "fused_run_batch_stream", "route": "cuda",
        "source": src + "fused.cu", "replaces": ref + "fused.py:397",
        "launches": stream["launches"], "max_abs_err": 0,
        "ms": stream["ms"], "plain_ms": stream["plain_ms"],
        "bound_ms": stream["bound_ms"], "bound_by": "bytes",
        "library_ms": None})
    ref = "src/repro/kernels/"
    ms, plain_ms, bound_ms, bound_by = hybrid_times["k4"]
    kernels.append({
        "name": "addr_map", "route": "cuda", "source": src + "addr_map.cu",
        "replaces": ref + "addr_map/addr_map.py:67",
        "launches": k4_launches, "max_abs_err": k4_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None})
    # K5 and K6 on the serve paths: qwen3-14b (phase 8) and seamless's
    # decode steps and encoder (phase 18(d))
    for k, name, timed, replaces in (
            ("k5", "decode_attention", "k5_served",
             ref + "decode_attention/decode_attention.py:70"),
            ("k6", "flash_attention", "k6",
             ref + "flash_attention/flash_attention.py:76")):
        ms, plain_ms, bound_ms, bound_by, lib_ms = attn_times[timed]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}{name}.cu",
            "replaces": replaces,
            "launches": llm_launches[k] + families["seamless"][k],
            "max_abs_err": attn_errs[k], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    # K6's general form (Dqk != Dv, Sk != Sq): what the reference runs as
    # jnp blocked_attention; its tensor-core kernel (bf16) timed at
    # deepseek-v3's MLA prefill shape, its launches those of phase 18(b)'s
    # prefill, all on the tensor-core form
    gen_rec = families["k6gen"]
    kernels.append({
        "name": "flash_attention_general", "route": "cuda",
        "source": src + "flash_attention.cu",
        "replaces": "src/repro/models/blocked_attention.py:30",
        "launches": families["deepseek"]["k6gen_tc"],
        "max_abs_err": gen_rec["max_abs_err"], "ms": gen_rec["ms"],
        "plain_ms": gen_rec["plain_ms"], "bound_ms": gen_rec["bound_ms"],
        "bound_by": gen_rec["bound_by"],
        "library_ms": gen_rec["library_ms"]})
    # K6's backward: the gradient of K6, per backward launch (its three
    # kernels) at minicpm-2b's training shape, bf16
    kernels.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": src + "flash_attention_bwd.cu",
        "replaces": ref + "flash_attention/flash_attention.py:76",
        "launches": k6_bwd["launches"], "max_abs_err": k6_bwd["max_abs_err"],
        "ms": k6_bwd["ms"], "plain_ms": k6_bwd["plain_ms"],
        "bound_ms": k6_bwd["bound_ms"], "bound_by": k6_bwd["bound_by"],
        "library_ms": k6_bwd["library_ms"]})
    ms, plain_ms, bound_ms, bound_by = hybrid_times["k7"]
    kernels.append({
        "name": "selective_scan", "route": "cuda",
        "source": src + "selective_scan.cu",
        "replaces": ref + "selective_scan/selective_scan.py:54",
        "launches": hybrid_launches["k7"], "max_abs_err": scan_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None})
    # K6's backward at its general form, per launch at deepseek-v3's MLA
    # training shape, bf16; its launches those of phase 19(c)'s steps
    # (deepseek-v3's MLA and seamless's cross-attention), all on the
    # tensor-core form (the FMA form, float32 and the tiny widths, is held
    # to its plain version in 19(b) and runs on no training path here)
    fam = trains["families"]
    rec = trains["k6bwd_gen"]
    kernels.append({
        "name": "flash_attention_bwd_general", "route": "cuda",
        "source": src + "flash_attention_bwd.cu",
        "replaces": "src/repro/models/blocked_attention.py:30",
        "launches": sum(f["launches"]["k6bwd_gen_tc"]
                        for f in fam.values()),
        "max_abs_err": rec["max_abs_err"], "ms": rec["mla"]["ms"],
        "plain_ms": rec["mla"]["plain_ms"],
        "bound_ms": rec["mla"]["bound_ms"],
        "bound_by": rec["mla"]["bound_by"],
        "library_ms": rec["mla"]["library_ms"]})
    # K7's backward, per launch at jamba's training shape, bf16; its
    # launches those of phase 19(c)'s jamba steps
    rec = trains["k7bwd"]
    kernels.append({
        "name": "selective_scan_bwd", "route": "cuda",
        "source": src + "selective_scan_bwd.cu",
        "replaces": ref + "selective_scan/selective_scan.py:54",
        "launches": fam["jamba"]["launches"]["k7bwd"],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None})
    log("walls (s): " + "; ".join(walls))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
