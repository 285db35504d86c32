#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every CUDA library from `src/repro_torch/kernels/csrc`, in
   parallel, with ptxas's registers, static shared memory and spills
   for each kernel;
3. kernels: `iss_segment_banked` and `iss_refill` against their plain
   PyTorch versions on the card, bit for bit over the full state: first
   on a 256-lane pool of all 11 FlexiBench workloads (timing off and on)
   and random refills, then at the main path's shapes (16,384 lanes,
   2,824 memory words, a bank of 11 programs of up to 2,006 words, one
   4,096-step segment), where each is also timed with CUDA events, the
   segment kernel beside its earlier time;
4. small plan: the three-group plan of `examples/fleet_simulation.py` at
   256 items per group through `run_plan` on the card and on the CPU,
   every per-item field and the final state bit for bit;
5. main path: a `FleetPlan` of all 11 workloads, 8,192 items each on
   SERV/QERV/HERV in turn, FlexiLint-static budgets, dynamic timing,
   chunk 16,384, seg_steps 4,096, through `run_plan` on the card, with
   every item halted, every item's output equal to the workload's
   reference function (TT on its first 1,024 items per group: its
   reference is a slow Python loop), and launch counts showing that both
   kernels, and never their plain versions, ran the path;
6. profile: the main path once more under torch.profiler, for the
   device's busy share, its time by kernel, and the segment kernel's
   device time per launch on the path's own pool;
7. sweep kernel, both builds against their plain PyTorch versions on the
   card: (a) `sweep_tile`, lifetimes read from memory, on three streamed
   tiles of 12 cells x 8 draws x 3 candidates (+inf lifetimes, invalid
   cells, exact ties); (b) `sweep_tile_drawn`, lifetimes drawn in the
   kernel, on three streamed tiles of 12 cells x 40 draws, its lifetimes
   within the CPU tests' ulp bound of the plain draws and every output
   equal to the plain tile given them; each in float32 and float64, then
   at the sweep's main tile (1,024 cells x 4,096 draws x 9 candidates,
   float32), timed with CUDA events against its bound;
8. small sweep: the reference test's mixture spec on the card and on the
   CPU (the CPU fed the card kernel's own lifetimes), at four tile sizes
   on the card, and the float64 point-mass spec against
   `total_grid`/`selection_map`;
9. main sweep: all 11 workloads x 4 lifetime distributions x 5
   frequencies x 4 intensities x 3 volumes x 3 timing models x 2 fault
   rates (15,840 cells) x 4,096 draws, argmin over 3 cores x 3
   redundancy modes, through `run_sweep` on the card in float32, with
   launch counts showing that the drawn kernel ran every tile and that
   neither plain version, build (a) nor the eager draws ran, every field
   bit-identical on a rerun and at a second tile size, and once more
   under torch.profiler;
10. fault kernel: the `faults` variant of `iss_segment_banked` against
   its plain version, full state bit for bit, on a 256-lane pool of 3
   programs (two 256-step segments, timing off and on) under transients
   on regs, mem and pc at rate 1e-2 and at rate 1.0, stuck-at at 0.5 and
   dead lanes at 0.5, plus the one-program `iss_segment` wrapper; then at
   the main path's shapes (16,384 lanes, 4,096 steps, timing on) timed
   with CUDA events with faults off and with transients at 1e-5, beside
   the earlier kernel's times;
11. small resilient plans: the three groups of phase 4 (64 items each,
   FlexiLint-static budgets) with transients at 1e-4, unprotected and
   under DMR, on the card and on the CPU: every per-item field, the DMR
   counters and the schedule bit for bit;
12. resilient main path: phase 5's plan three ways, (a) transients on
   regs, mem and pc at 1e-5 unprotected (the items whose output,
   retirement count or halt differ from phase 5's are counted), (b) the
   same under DMR with max_retries 6 and (c) dead lanes at 1e-3 under DMR
   with max_retries 1, where every item's output, retirement count and
   halt must equal phase 5's (the tallies DMR's digest does not cover,
   the two-stage count, ticks and mix, are counted); each run once more
   under torch.profiler for the busy share and the segment kernel's
   device time per launch, and the DMR boundary's digest, snapshot and
   rollback timed at full shape;
13. LM kernels: the count of tensor-core instructions (HMMA, HGMMA) in
   each LM kernel's SASS where the toolkit has `cuobjdump` (the bit
   planes' GEMM must have some; the bfloat16 flash forward's four
   `flash_fwd_wgmma` builds, the flash backward's two kernels' four
   builds, the bfloat16 scan forward's two `ssd_fwd_wgmma` builds and its
   backward's six `ssd_bwd_wgmma` builds HGMMA and no HMMA; ptxas's
   registers and spills of `ssd_fwd_wgmma` and `ssd_bwd_wgmma`, none
   spilled);
   `flash_attention`, `ssd_scan` and `bitplane_matmul` against their
   plain versions in float32 and bfloat16 on small and ragged shapes (L
   11 and 200 causal and full with equal and unequal tiles, D 40
   zero-padded; SSD scans of two and three chunks with odd head counts
   and groups, P = N = 128 and a 512-step chunk; bit planes at 1, 4
   and 8 bits, ragged M through
   `quantized_linear`, M 384 x K 640 x N 384 against the GEMM's block
   tile, and the bfloat16 repack bit for bit at 1-8 bits), then at the
   main serve's shapes in bfloat16, timed with CUDA events beside the
   plain version and a library call (SDPA for attention, `torch.matmul`
   on the dequantised weight for bit planes, none for the scan), the bit
   planes' repack and GEMM also timed alone;
14. small serve: the Zamba2 smoke config in float32 and bfloat16 with
   the same parameters on the card (kernels) and on the CPU (plain
   versions): prefill and first decode logits within the stated
   tolerance (the card's first decode fed the CPU's first token),
   greedy tokens equal wherever the CPU's top-2 margin clears twice it,
   one launch a layer and no plain call on the card, and `generate`
   equal to the greedy loop on both;
15. main serve: Zamba2-7B at full width and depth (6.957e9 parameters,
   bfloat16, random from a seed) through `generate` on the card, 8
   requests x prompt 512, 32 tokens: 81 `ssd_scan` (all
   `ssd_fwd_wgmma`) and 13 `flash_attention` launches per prefill and no
   plain call; prefill
   and decode rates and peak memory; the kernels against their plain
   versions on the tensors this prefill feeds the first Mamba layer and
   the first shared block, the scan timed on the first Mamba layer's
   own tensors and the attention (`flash_fwd_wgmma`) on the first
   shared block's beside SDPA and the bound; that block's FFN input
   through `quantized_linear` at 4 and 8 bits (the bit-plane kernel's
   path); and the serve once more under torch.profiler;
16. host loop: phase 4's plan through `refill="host"` and through
   `packed=False` on the card, every per-item field and the final state
   equal to phase 4's resident run, and its MC and WQ groups the same on
   the card and the CPU, bit for bit (SI's 7,715 steps would cost the
   CPU's plain stepper ~40 s a run); phase 5's plan through
   `refill="host"`: every per-item field equal to phase 5's, more host
   syncs than phase 5's, its wall and items/s; then TT, PT, CT and AD at
   28,000 items each on SERV with FlexiLint-static budgets, past the
   int32 mix bound, which must fall back to the host loop
   (`refill == "host"`) with every item halted and every output equal to
   the workload's reference (TT on its first 1,024 items); each run with
   the launch counts zeroed just before it: segment kernel launched, no
   plain version, and no refill kernel on the host loop;
17. checkpoints: phase 5's plan checkpointed every 8 segments into
   `build/chip_smoke_ckpt/` (removed after), crashed by
   `_crash_after_segments=20` and resumed through `run_plan`: every
   per-item field, `n_segments` and the schedule equal to phase 5's (a
   resume stages the unconsumed items again, so `lane_steps` may
   differ); each save's write time and bytes on disk, the restore's
   time and the resumed wall; then a 64-item stream checkpointed and
   crashed on the card resumes on the CPU, and the other way round, bit
   for bit with the card's uninterrupted run;
18. shards and steppers: (a) phase 4's plan at `mesh=["cuda"] * 2` and
   `* 4` (logical shards on the one card), every per-item field and the
   final state equal to phase 4's, the 4-shard schedule and shard
   statistics equal to the same plan's at `["cpu"] * 4`, host syncs not
   multiplied by the shard count; (b) phase 5's plan at 4 shards, every
   per-item field equal to phase 5's, its wall, items/s, host syncs,
   retired items per shard and the segment kernel's launches and ms a
   launch (CUDA events around each launch) beside a one-shard rerun in
   the same call; (c) phase 5's plan checkpointed every 8 segments at 4
   shards, crashed after 20 and resumed at one shard, equal to phase 5's
   (checkpoints in the git-ignored `build/chip_smoke_ckpt_shards/`,
   removed after); (d) phase 4's MC and WQ groups through
   `stepper="branchless"` and `"switch"` (plain torch on the card: no
   segment kernel launch), equal to the kernel route's and the CPU's,
   and `run_fleet_sharded` on 256 MC items at 2 shards equal to
   `iss.run_fleet` on the card; (e) phase 11's DMR plan at 2 shards,
   every item's architectural result equal to the fault-free run; each
   run of (a)-(e) with the launch counts zeroed just before it: both
   kernels launched on the kernel route, no plain version;
19. the paper's studies: (a) Fig. 6's six spoilage variants on the
   4,000 held-out inputs of `gen_dataset(default_rng(99), 4000)` plus
   the profile input, one pool per variant (KNN-Large: 4,001 lanes x
   17,035 words), through `iss_segment` on the card until every lane
   halts: every output equal to the variant's reference function, so
   its accuracy equals the reference's; the profile input's counts equal
   to PyISS and priced at the carbon-optimal core over a 1-year hourly
   deployment, as `benchmarks/spoilage.py` prices them, and the
   KNN-Large / LR carbon ratio beside the paper's 14.5; (b) the three
   examples through `main(argv)` in this process on the card:
   `torch_quickstart` and `torch_fleet_simulation` at their defaults,
   the fleet example also at 8,192 items a group (every output equal to
   the workload's reference), `torch_carbon_planner` at its defaults
   with `--serving`; each with the counts zeroed just before it: the
   segment kernel and `iss_refill` launched on the fleet example,
   `sweep_tile_drawn` on the planner, no plain version anywhere, and
   their launches added to the kernels line; (c) the float64 serving
   planner `sweep.serving_plan` on the card bit for bit against the
   numpy `plan_grid` on the example's grid and on 365 lifetimes x 1,000
   QPS x 18 options (infeasible and tied cells), timed with CUDA events;
   (d) Table 5 equal to its recomputation from the paper's inputs, and
   `python -m repro_torch.tools.flexilint` over all 11 workloads exiting
   0;
20. dense and SSM serving: (a) the Qwen2-1.5B, Qwen2.5-14B, Minitron-8B
   and Mamba2-1.3B smoke configs as phase 14 runs Zamba2's (card against
   CPU, float32 and bfloat16, one `flash_attention` launch a dense layer
   and one `ssd_scan` a Mamba2 layer, no plain call on the card); (b)
   Qwen2.5-14B (14,770,033,664 bfloat16 parameters), (c) Mamba2-1.3B and
   (d) Qwen2-1.5B and Minitron-8B at full width and depth through
   `generate` on the card, cut as phase 15: 8 requests x prompt 512, 32
   tokens; for each, launches, prefill and decode rates and peak memory,
   the first layer's kernel against its plain version on its own
   tensors (timed beside the plain version, SDPA for attention, and the
   bound); (b) and (c) once more under torch.profiler (the prefill and 8
   decode steps); and the cache path (prefill and 32 decode steps)
   against the full forward over the same 544 tokens, in float32 (the
   same bfloat16-valued parameters cast in place) within 1e-3 at every
   step, and in bfloat16 by its relative error against the float32
   forward, at most 1.25x the bfloat16 forward's own (at 28-48 layers
   both bfloat16 paths drift from float32 past the smoke configs'
   elementwise tolerance, as the reference's own bfloat16 run does).
   Each model is freed before the next.
21. training: (a) the `flash_attention_bwd` kernel (and the forward's
   log-sum-exp) against its plain version at Qwen2-1.5B's training
   shape (BH 8 x 12 = 96, L 512, D 128, tile 512), causal, in float32
   and bfloat16, and at tq != tk both ways and causal=False, every
   gradient within `LM_TOL`; the bfloat16 causal case launched twice
   for the same bits, and timed beside the plain version, SDPA's
   backward ((forward + backward) - forward) and the bound, each
   backward's kernels also by their device time (torch.profiler), with
   the bfloat16 backward kernels' registers and spills (none allowed);
   (b) Qwen2-1.5B at full width and depth (1,543,910,912
   bfloat16 parameters from a seed, remat on), five `train_loop` steps
   with AdamW at 8 x 512 tokens from `data/pipeline.py` (cut: the step
   count): finite losses, the median step of steps 2-5, train tokens/s,
   6 N tokens over the step time against the bfloat16 peak, peak memory,
   56 flash forwards (with the remat recompute) and 28 backwards a step
   and no plain call; then one more step under torch.profiler; (c) the
   smoke config in float32 from the same parameters, card against CPU, 3
   steps at grad_accum 1 and 2 (losses and gnorms within 1e-4 relative,
   parameters within 2 x the summed learning rates), and 11 card steps
   whose loss at step 10 is below step 0's; (d) the smoke config 6 steps
   uninterrupted against 3 steps, a checkpoint (into the git-ignored
   `build/chip_smoke_train_ckpt/`, removed after) and a resumed
   `train_loop` to 6: losses, parameters, m and v bit for bit.
22. SSM and hybrid training: (a) the `ssd_scan_bwd` kernel against its
   plain version at Mamba2-1.3B's training shape (BH 8 x 64 = 512, L
   512, P 64, N 128, chunk 256, 64 heads a group) and Zamba2-7B's (BH 8
   x 112 = 896, N 64, 112 heads a group), in float32 and bfloat16, on
   the forward kernel's own saved chunk-entry states (held to the plain
   forward's): every gradient within `LM_TOL`, two launches the same
   bits, timed beside the plain version and the bound (the Mamba2
   bfloat16 cases also by their device time, the kernel and the sum of
   the blocks' partials apart), with ptxas's registers and spills; the
   bfloat16 build is `ssd_bwd_wgmma` on wgmma and TMA (the float32 build
   stays `ssd_bwd` on the CUDA cores), one `bwd_wgmma_launches` count a
   call, logged with its heads a block, blocks and resident blocks
   (`ssd_scan_bwd_wgmma_info`, held to the host's `bwd_wgmma_smem` and
   `bwd_wgmma_heads`) and its time beside the earlier mma.sync build's
   0.8167 and 1.1360 ms; (b) Mamba2-1.3B at full width and depth
   (1,344,052,224 bfloat16 parameters from a seed), five `train_loop`
   AdamW steps of
   8 x 512 as 21(b): 96 `ssd_scan` launches (with the remat recompute)
   and 48 `ssd_scan_bwd` a step, every one `ssd_fwd_wgmma` and
   `ssd_bwd_wgmma`, no plain call, then one profiled step;
   (c) Zamba2-7B at full width with its depth cut to 27 layers (4 groups
   of 6 Mamba layers and their shared-block calls, then the 3-layer
   tail; 81 layers need about 83.5 GB for AdamW), 3 steps: 54 scans
   and 27 scan backwards, 8 flash forwards and 4 backwards a step, then
   one profiled step; (d) the Mamba2 and Zamba2 smoke configs in float32
   card against CPU as 21(c) at grad_accum 1, and 11 card steps each.
23. Gemma3-12B (5:1 local:global attention, window 1,024, head dim
   256): (a) `flash_attention` and its backward against their plain
   versions at its serve shape (BH 8 x 16 = 128, L 4,096, tile 1,024) and
   training shape (BH 2 x 16 = 32, L 2,048), each with window 1,024 and
   without, and at window 1,000 with tile 512, in float32 and bfloat16:
   every output, log-sum-exp and gradient within `LM_TOL`, the bfloat16
   kernels twice for the same bits, timed beside the plain version, the
   bound (window counted) and SDPA (causal, or a band mask on the backend
   named), the training shape's backwards also by device time; ptxas's
   registers for the forward's four builds and the wide backward's, no
   spill in any flash build; before them, the bfloat16 forward
   (`flash_fwd_wgmma`, every head dim; its own row of the `kernels`
   line, timed at the serve shape's causal case) at 20 small cases (D
   256, 192, 250 and 136 zero-padded; D 12 padded to 16, 64, 112 and
   128; causal with tq != tk, windows, non-causal; ragged 128-row blocks
   and key tiles, one non-causal tile of 300): output within `LM_TOL` of
   the plain version and of its rounding model
   (`tests/_torch_flash_wgmma.py`), log-sum-exp within 1e-4, two
   launches the same bits, each counted; the backward at the same cases,
   given the forward's log-sum-exp, at every head dim `flash_bwd_dq_wgmma`
   then `flash_bwd_dkdv_wgmma` (counted as `flash_bwd_wgmma`, its own row
   of the `kernels` line, timed at the training shape's causal case
   beside SDPA's backward), within `LM_TOL` of the plain backward and of
   its rounding model; two launches the same bits, each counted; (b)
   Gemma3-12B at full width and depth
   (11,765,395,200 bfloat16 parameters from a seed) through `generate`,
   8 requests x prompt 4,096 (longer than the window), 32 tokens: 48
   `flash_attention` launches a prefill, all of them `flash_fwd_wgmma`,
   no plain call, rates and peak memory, the first (local)
   layer's kernel on its own tensors, then under torch.profiler; (c) the
   cache path against the full forward over the same 4,128 tokens on the
   first 2 requests (float32 parameters and caches for 8 would not fit),
   the full forward at a tile of 32 (1,024 does not divide 4,128);
   (d) training at full width, its depth cut to 6 layers (5 local, 1
   global; 12 ran out of memory in AdamW), 5 `train_loop` AdamW steps of
   2 x 2,048 tokens: 12 flash forwards (`flash_fwd_wgmma`) and 6
   backwards (`flash_bwd_wgmma`) a step, no plain
   call, then a profiled step; (e) the smoke config card against CPU:
   `small_serve` in both dtypes, the prefill logits, 3 decode steps and
   the K/V cache in float32, and `smoke_train` at grad_accum 1 with 11
   card steps.
24. the MoE family: (a) the Qwen2-MoE and DeepSeek-V3 smoke configs and
   Qwen2-MoE's padded (6 experts of 8), hierarchical variant in float32,
   card against CPU from the same parameters: a prefill of 4 x 64 and 8
   decode steps, every step's logits and the cache (K/V, or MLA's
   latents) within `LM_TOL`, every router call's routes equal (so its
   drops; the padded variant's prefill must drop slots), one flash
   launch a layer and no plain call on the card; DeepSeek-V3's loss,
   its xent, aux and mtp terms within 1e-4 relative and every
   parameter's gradient within `LM_TOL`, the card's flash launches
   matched by the CPU's plain calls; (b) Qwen2-MoE-A2.7B at full width
   and depth (15,146,928,128 bfloat16 parameters from a seed) and (c)
   DeepSeek-V3 at full width, its depth cut to 4 layers (3 dense, 1 MoE,
   and the MTP head: 15,797,352,448), each through `generate`, 8
   requests x prompt 4,096, 32 tokens: one flash launch a layer a
   prefill (D 128; MLA's at D 192 with V zero-padded, `flash_fwd_wgmma`)
   and no plain call,
   rates, peak memory, the slots each MoE layer dropped, the first
   layer's flash kernel on its own tensors beside its plain version,
   SDPA and the bound, the first MoE layer's expert products timed on
   its own buffer and scaled to the prefill, then the prefill and 8
   decode steps under torch.profiler; (d) Qwen2-MoE-A2.7B at full width,
   its depth cut to 6 layers, 5 `train_loop` AdamW steps of 2 x 2,048:
   12 flash forwards and 6 backwards a step, no plain call, each step's
   xent, aux and loss finite, then a profiled step; DeepSeek-V3 with its
   Adafactor over the reference's stacked leaves: the smoke config card
   against CPU (`smoke_train`: 3 steps, losses and gnorms within 1e-4
   relative, then 11 card steps whose loss falls), then at full width,
   its depth cut to its 3 dense layers and the MTP head (4,290,066,432
   parameters; a full-width MoE layer's weights and gradients alone are
   45 GB), 5 `train_loop` steps of 2 x 2,048: 7 flash forwards (all
   `flash_fwd_wgmma`) and 4 backwards (`flash_bwd_wgmma`) a step, then a
   profiled step; the
   D 192 backward alone, given the new forward's log-sum-exp, at
   that step's shape (BH 256 x 2,048, causal, tile 1,024) against plain,
   SDPA's backward and the bound.
25. the VLM family: (a) the LLaVA-NeXT smoke config card against CPU
   from the same parameters and patches, a prefill of 4 x (8 patches +
   16 tokens) and 3 decode steps in float32 (`LM_TOL`) and bfloat16
   (phase 14's tolerance), logits and the K/V cache, and the float32
   loss and every gradient; (b) LLaVA-NeXT-34B at full width and depth
   (34,388,917,248 bfloat16 parameters from a seed) through `generate`,
   8 requests x (576 patches + 1,472 tokens), 32 tokens: 60 flash
   launches a prefill and no plain call, prefill positions/s (patches
   counted), decode tokens/s, peak memory; the first layer's flash call
   of one more prefill (BH 448 x 2,048 x 128, causal, tile 1,024) on its
   own tensors, with the parameters freed, against plain, SDPA and the
   bound.
26. the audio family: (a) the Whisper smoke config (D 12) likewise,
   frames in place of patches; (b) Whisper-tiny at full size
   (61,153,536) through `generate`, 64 requests x 1,500 frames, a
   4-token prompt, 60 tokens: 8 flash launches a prefill (4 encoder
   layers without a causal mask, 4 decoder layers), encoder frames/s,
   decode tokens/s, peak memory; the first encoder layer's flash call
   (BH 384 x 1,500 x 64, non-causal, one tile of 1,500: a ragged last
   64-row block and 64-key tile) against plain, SDPA and the bound, then
   its backward alone; (c) 5 AdamW `make_train_step` steps of 16 x
   (1,500 frames, 448 tokens): 16 flash forwards and 8 backwards a step,
   finite losses, step ms, tokens/s, peak memory.
27. the distributed modules: (a) `make_host_mesh()`, a (1, 1) NCCL mesh
   over a one-rank group; (b) Qwen2-1.5B at full size, 3 AdamW steps of
   8 x 512 without a mesh and 3 data-parallel on the mesh from the same
   seed (`train_loop(mesh=)` for 2, checkpointed at step 2, the third
   from (c)'s resume), losses and final parameters equal bit for bit
   (a one-rank mean all-reduce is exact), both step times and the
   gradient all-reduce's ms a step (CUDA events); (c) `resume_elastic`
   of that checkpoint onto the mesh: parameters bit-equal to the mesh
   run's at step 2; (d) `compressed_allreduce` over the one-rank NCCL
   group on the gradients of `embed` and layer 0, two error-feedback
   steps, bit-equal to the same call on the CPU, its ms and GB/s
   against the bytes it must move; (e) `launch/dryrun.py::analyze_cell`
   of (b)'s cell (8 x 512, train, one chip; traced on fake tensors in a
   CPU worker beside the card's phases): the roofline's terms beside
   (b)'s measured step, and the measured share of the ideal step. The
   main serve's parameter count (phase 15) is `count_params_abstract` of
   the port's config, checked against the reference's 6.957e9.
28. tensor parallelism: two spawned ranks share the card in a gloo group
   (NCCL refuses two ranks on one device), a (1, 2) mesh: (a)
   Qwen2-1.5B at full width and 2 layers, float32, 3 AdamW steps from
   step 10 and a nonzero state (norms and QKV bias drawn too) on the
   mesh, against the same steps in one process: losses, gnorms and every
   gathered parameter within 1e-4 of the tensor's largest magnitude, the
   step's collectives counted; (b) Qwen2-1.5B at full size, bfloat16, 3
   `train_loop` steps of 8 x 512 on the mesh: each rank holds
   771,999,232 parameters, its losses within 2e-2 of 27(b)'s run
   without a mesh, every flash call at BH 8 x 6 heads and every one
   `flash_fwd_wgmma` / `flash_bwd_wgmma`, no plain call; step ms and
   peak GiB beside 27(b)'s, one profiled step's device busy share a
   rank, one all-reduce of the residual stream timed (gloo stages it
   through the host).

The CPU halves of phases 4, 11 and 18(a) (small plans on the plain
path, single-threaded, the largest host work of the run) run in four
spawned worker processes, started after the build, beside the card's
phases; each phase collects its result where it compares it with the
card's run, and the pool is shut down before the script exits.

It ends with a `kernels:` line of launch counts, one JSON line
`{"kernels": [...]}` with an entry per kernel (times, bound, launches,
error; the segment kernel's faults variant has its own entry, launched
on phase 12's path; the sweep kernel's two builds each have one, the
drawn build launched on phase 9's path and build (a) on none; the
bit-plane kernel's launches are phase 15's quantized path; phase 19's
launches are added to the segment kernel's, the refill kernel's, the
drawn sweep's, flash's and the scan's, and phase 20's full serves' to
flash's and the scan's; `flash_attention_bwd`'s are phase 21(b)'s five
steps plus the quickstart's; phase 22(b) and (c)'s are added to the
scan's and to flash's, forward and backward, and `ssd_scan_bwd`'s are
theirs alone; phase 23(b)'s prefill and (d)'s steps, phase
24(b)-(c)'s prefills and (d)'s steps, phases 25(b)'s and 26(b)'s
prefills and 26(c)'s steps, phase 27(b)'s six steps and both of phase
28(b)'s ranks' three, are added to flash's, forward and backward; `flash_fwd_wgmma`'s are every bfloat16
forward among them (all of phases 15's, 20(b)-(d)'s, 21(b)'s, 22(c)'s
and 23-28's; each phase checks that its bfloat16 forwards all ran it);
`flash_bwd_wgmma`'s are every bfloat16 backward among them (all of
21(b)'s, 22(c)'s and 23-28's; each phase checks that its bfloat16
backwards all ran it)), the card's nvidia-smi line, and
as the last line
`{"ok": true, "device": {...}}`. The fleet kernels' integer state is
held bit for bit (max_abs_err 0). The sweep is held bit for bit but for
its per-cell sums, which follow no fixed order (relative 2 (N - 1) u),
and for values at a log10 bin edge (counted; see
`tests/_torch_parity.py`); its max_abs_err is over the exact fields.
The LM kernels sum in another order than their plain versions (the
bfloat16 flash kernel also rounds P to bfloat16 for P v, its backward P
and dS for their products, the bfloat16 scan W, S and B w; the scan's
backward is float32 for both types and rounds only its bfloat16 dx, dB
and dC) and are held to `LM_TOL` times the output's largest magnitude.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))  # _torch_parity (no JAX)

# H100 SXM peaks used for the bounds: HBM bandwidth and the bfloat16
# dense rate of the tensor cores (the least time for a product of
# bfloat16 inputs), NVIDIA's data sheet, kept in the port's roofline;
# the int32 rate outside the tensor cores (132 SMs x 64 int32 lanes per
# SM per clock x 1.98 GHz boost, from the Hopper architecture paper)
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_OPS_PER_S, HBM_BYTES_PER_S)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# float32 rate outside the tensor cores (NVIDIA's data sheet, H100 SXM)
FP32_OPS_PER_S = 67e12
# int32 operations per retired lane-step of rv32e_step.cuh: fetch clamp
# and load address (5), field and immediate decode (40), register reads
# (2), execute and next pc (8), classify (10), commit (5), and the live
# test (2), rounded down
OPS_PER_STEP = 64
# added per live step by flexifault.cuh's transient mode: the halt test
# (1), k ^ n_instr (1), mix32 (2 shifts, 3 xors, 2 multiplies) and the
# threshold compare (1); a step that fires adds two more mix32 and the
# flip (about 25), counted per fire
FAULT_OPS_PER_STEP = 10
FAULT_OPS_PER_FIRE = 25
# int32 operations of one threefry2x32 hash in sweep_draws.cuh: 20 rounds
# of an add, a funnel shift and a xor (60), 5 key injections of three adds
# (15), the first key add (2) and the conversion to a float (xor, shift,
# or, subtract: 4)
OPS_PER_HASH = 81

SEG = ("iss_segment_banked", "src/repro_torch/kernels/csrc/iss_segment.cu",
       "src/repro/kernels/iss_stepper.py:246")
REF = ("iss_refill", "src/repro_torch/kernels/csrc/iss_refill.cu",
       "src/repro/kernels/iss_stepper.py:418")
SWEEP = ("carbon_sweep", "src/repro_torch/kernels/csrc/carbon_sweep.cu",
         "src/repro/kernels/carbon_sweep.py:408")
SWEEP_DRAWN = ("carbon_sweep[drawn]",
               "src/repro_torch/kernels/csrc/carbon_sweep.cu",
               "src/repro/kernels/carbon_sweep.py:408")
SEG_FAULTS = ("iss_segment_banked[faults]",
              "src/repro_torch/kernels/csrc/iss_segment.cu",
              "src/repro/kernels/iss_stepper.py:152")
# the segment kernel's times at phase 3's and phase 10's full shape before
# its redesign (measured on one NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_SEG_MS = {"fault-free": 3.366, "faults": 3.635}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every field of two PackedStates (raises if
    any is not zero: the tolerance is bit-exact)."""
    import numpy as np
    err = 0
    for f, x, y in zip(("regs", "pc", "mem", "halted", "n_instr",
                        "n_two_stage", "mix", "n_cycles"), a.lanes, b.lanes):
        d = np.abs(x.cpu().numpy().astype(np.int64)
                   - y.cpu().numpy().astype(np.int64))
        e = int(d.max()) if d.size else 0
        if e:
            raise AssertionError(f"kernel and plain version differ in {f} "
                                 f"(max |diff| {e})")
        err = max(err, e)
    for x, y in ((a.prog_id, b.prog_id), (a.max_steps, b.max_steps)):
        if not bool((x == y).all()):
            raise AssertionError("prog_id/max_steps differ")
    return err


def pool(n_lanes, seed, dev, keys=None):
    """An n_lanes pool of all 11 workloads, or of those named by `keys`
    (lane i on workload i % n), plus its bank, per-program bounds and
    dynamic cost rows."""
    import numpy as np
    import torch
    from repro_torch.flexibench.base import all_workloads
    from repro_torch.flexibits.cycles import CORES, cost_row
    from repro_torch.flexibits.iss import PackedState, fresh_lanes, \
        pack_programs
    ws = all_workloads()
    if keys is not None:
        ws = [w for w in ws if w.key in keys]
    bank, clen = pack_programs([w.program.code for w in ws])
    mlen = np.array([w.total_mem_words for w in ws], np.int32)
    cores = [CORES[c] for c in ("SERV", "QERV", "HERV")]
    cost = np.stack([cost_row(cores[i % 3], dynamic=True)
                     for i in range(len(ws))]).astype(np.int32)
    pids = (np.arange(n_lanes) % len(ws)).astype(np.int32)
    mems = np.zeros((n_lanes, int(mlen.max())), np.int32)
    for i, p in enumerate(pids):
        w = ws[p]
        m = w.initial_memory(w.gen_inputs(np.random.default_rng([seed, i]),
                                          1)[0])
        mems[i, :len(m)] = m
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    ms = np.array([ws[p].max_steps for p in pids], np.int32)

    def state():
        return PackedState(lanes=fresh_lanes(t(mems)), prog_id=t(pids),
                           max_steps=t(ms))
    return t(bank), t(clen), t(mlen), t(cost), state


def clone(ps):
    from repro_torch.flexibits.iss import ISSState, PackedState
    return PackedState(ISSState(*(x.clone() for x in ps.lanes)),
                       ps.prog_id.clone(), ps.max_steps.clone())


def events_ms(fn, reps=1):
    """Mean device time of `reps` calls of fn(), from CUDA events."""
    import torch
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_segment(st, dev, bank, clen, mlen, cost, state, seg_steps,
                  n_segs, faults=None, epoch=None):
    """Kernel vs plain version, segment after segment (bit for bit),
    with `faults` the faults variant under per-lane `epoch`s. Returns the
    retired instructions and the kernel's final state."""
    import torch
    from repro_torch.flexibits import faults as pf
    from repro_torch.flexibits import iss
    a, b = state(), state()
    fk = {} if faults is None else dict(
        faults=faults, epoch=epoch,
        lane_key=pf.lane_keys_tensor(faults.seed, a.lanes.pc.shape[0], dev))
    for _ in range(n_segs):
        a = st.iss_segment_banked(bank, clen, a, seg_steps=seg_steps,
                                  mem_len=mlen, cost=cost, device=dev, **fk)
        b = iss.run_segment_lanes_banked(bank, clen, b, seg_steps, None,
                                         mlen, cost, **fk)
        torch.cuda.synchronize()
        max_abs_err(a, b)
    return int(a.lanes.n_instr.sum()), a


def phase_kernels(dev, rec):
    import numpy as np
    import torch
    from repro_torch.flexibits import iss
    from repro_torch.kernels import iss_stepper as st

    # ---- small pool: all 11 workloads, timing off and on
    bank, clen, mlen, cost, state = pool(256, 1, dev)
    for timing in (False, True):
        n, _ = check_segment(st, dev, bank, clen, mlen,
                             cost if timing else None, state, 256, 3)
        log(f"[kernels] iss_segment_banked 256 lanes x 3 x 256 steps, "
            f"timing {'on' if timing else 'off'}: bit-exact "
            f"({n} instructions retired)")
    rng = np.random.default_rng(0)

    def refill_case(n_lanes, mem_words, n_staged, seed):
        r = np.random.default_rng(seed)
        t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        from repro_torch.flexibits.iss import ISSState, PackedState
        ps = PackedState(
            ISSState(regs=t(r.integers(-9, 9, (n_lanes, 16), np.int32)),
                     pc=t(r.integers(0, 64, n_lanes, np.int32)),
                     mem=t(r.integers(-99, 99, (n_lanes, mem_words),
                                      np.int32)),
                     halted=t(r.random(n_lanes) < 0.5),
                     n_instr=t(r.integers(0, 50, n_lanes, np.int32)),
                     n_two_stage=t(r.integers(0, 20, n_lanes, np.int32)),
                     mix=t(r.integers(0, 9, (n_lanes, 8), np.int32)),
                     n_cycles=t(r.integers(0, 999, n_lanes, np.int32))),
            t(r.integers(0, 11, n_lanes, np.int32)),
            t(r.integers(1, 99, n_lanes, np.int32)))
        free = t(r.random(n_lanes) < 0.6)
        take, src = iss.refill_take(
            free, torch.tensor([n_staged], dtype=torch.int32, device=dev))
        staged = (t(r.integers(-99, 99, (n_lanes, mem_words), np.int32)),
                  t(r.integers(0, 11, n_lanes, np.int32)),
                  t(r.integers(1, 99, n_lanes, np.int32)))
        return ps, take, src, staged

    ps, take, src, staged = refill_case(256, 2824, 100, 1)
    want = iss.refill_lanes(ps, take, src, *staged)
    got = st.iss_refill(clone(ps), take, src, *staged, device=dev)
    torch.cuda.synchronize()
    max_abs_err(got, want)
    log("[kernels] iss_refill 256 lanes, random take/src: bit-exact")

    # ---- the main path's shapes: 16,384 lanes x 2,824 words, 11 programs
    L, SEGSTEPS = 16384, 4096
    t0 = time.perf_counter()
    bank, clen, mlen, cost, state = pool(L, 2, dev)
    log(f"[kernels] full-shape pool built in "
        f"{time.perf_counter() - t0:.1f}s: lanes {L}, mem words "
        f"{state().lanes.mem.shape[1]}, bank {tuple(bank.shape)}")
    s0 = state()
    plain = [None]

    def run_plain():
        plain[0] = iss.run_segment_lanes_banked(bank, clen, clone(s0),
                                                SEGSTEPS, None, mlen, cost)
    plain_ms = events_ms(run_plain)
    times = []
    for _ in range(3):
        s = clone(s0)
        torch.cuda.synchronize()
        times.append(events_ms(lambda: st.iss_segment_banked(
            bank, clen, s, seg_steps=SEGSTEPS, mem_len=mlen, cost=cost,
            device=dev)))
        err = max_abs_err(s, plain[0])
    steps = int((plain[0].lanes.n_instr - s0.lanes.n_instr).sum())
    nbytes = 2 * sum(x.numel() * x.element_size() for x in s0.lanes) + sum(
        x.numel() * x.element_size()
        for x in (s0.prog_id, s0.max_steps, bank, clen, mlen, cost))
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = steps * OPS_PER_STEP / INT32_OPS_PER_S * 1e3
    rec["iss_segment_banked"] = dict(
        ms=sorted(times)[1], plain_ms=plain_ms, max_abs_err=err,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations",
        detail=f"{steps} lane-steps, {nbytes} bytes")
    log(f"[kernels] iss_segment_banked {L} lanes x {SEGSTEPS} steps "
        f"(timing on): bit-exact; kernel {sorted(times)[1]:.3f} ms "
        f"(earlier kernel: {EARLIER_SEG_MS['fault-free']} ms) "
        f"(runs {', '.join(f'{x:.3f}' for x in times)}), plain "
        f"{plain_ms:.1f} ms; {steps} retired lane-steps; bound "
        f"{max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f}, "
        f"operations {b_ops:.4f})")

    ps, take, src, staged = refill_case(L, 2824, L // 2, 3)
    want = iss.refill_lanes(ps, take, src, *staged)
    got = clone(ps)
    st.iss_refill(got, take, src, *staged, device=dev)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    # the swap is idempotent for a fixed take/src: time repeated launches
    ms = events_ms(lambda: st.iss_refill(got, take, src, *staged,
                                         device=dev), reps=20)
    plain_ms = events_ms(lambda: iss.refill_lanes(ps, take, src, *staged),
                         reps=5)
    n_take = int(take.sum())
    lane_row = 4 * (2824 + 16 + 8 + 6)          # mem, regs, mix, scalars
    nbytes = L * (1 + 4) + n_take * (4 * 2824 + 8) + n_take * lane_row
    rec["iss_refill"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                             bound_by="bytes",
                             detail=f"{n_take} lanes take, {nbytes} bytes")
    log(f"[kernels] iss_refill {L} lanes, {n_take} take: bit-exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{rec['iss_refill']['bound_ms']:.4f} ms")


def three_group_plan(n_items):
    from repro_torch.fleet import FleetGroup, FleetPlan
    return FleetPlan(groups=(
        FleetGroup(workload="MC", core="SERV", n_items=n_items, seed=0),
        FleetGroup(workload="WQ", core="QERV", n_items=n_items, seed=1),
        FleetGroup(workload="SI", core="HERV", n_items=n_items, seed=2),
    ), chunk=128, seg_steps=1024)


def phase_small_plan(dev, cpu_runs):
    import numpy as np
    from repro_torch.fleet import run_plan
    plan = three_group_plan(256)
    t0 = time.perf_counter()
    gpu = run_plan(plan, keep_state=True, device=dev)
    t1 = time.perf_counter()
    cpu, t_cpu = cpu_runs["small"].result()
    fields = ("n_instr", "n_two_stage", "halted", "out", "mix", "mems",
              "regs", "pc", "mix_items")
    for a, b in zip(gpu.groups, cpu.groups):
        for f in fields:
            if not np.array_equal(getattr(a.result, f),
                                  getattr(b.result, f)):
                raise AssertionError(f"small plan: card and CPU differ in "
                                     f"{a.workload.key}.{f}")
        if a.total_kg != b.total_kg:
            raise AssertionError("small plan: carbon differs")
    for f in ("lane_steps", "n_segments", "seg_schedule"):
        if getattr(gpu.packed, f) != getattr(cpu.packed, f):
            raise AssertionError(f"small plan: schedule differs in {f}")
    log(f"[small plan] 3 groups x 256 items: card {t1 - t0:.2f}s, CPU "
        f"{t_cpu:.2f}s (a worker process); every per-item field, final "
        f"state and the schedule bit-exact")
    return gpu


def main_plan():
    from repro_torch.flexibench.base import all_workloads
    from repro_torch.fleet import FleetGroup, FleetPlan
    cores = ("SERV", "QERV", "HERV")
    return FleetPlan(groups=tuple(
        FleetGroup(workload=w.key, core=cores[i % 3], n_items=8192, seed=i,
                   max_steps="static")
        for i, w in enumerate(all_workloads())),
        chunk=16384, seg_steps=4096, timing="dynamic")


def phase_main(dev):
    import numpy as np
    from repro_torch.fleet import run_plan
    from repro_torch.fleet.engine import workload_source
    from repro_torch.kernels import iss_stepper as st
    plan = main_plan()
    st.reset_counts()
    rep = run_plan(plan, device=dev)
    counts = {"iss_segment_banked": st.iss_segment_banked.launches,
              "iss_refill": st.iss_refill.launches}
    plain = st.iss_segment_banked.plain_calls + st.iss_refill.plain_calls
    p = rep.packed
    if min(counts.values()) <= 0 or plain:
        raise AssertionError(f"main path launches {counts}, plain calls "
                             f"{plain}")
    n_instr = sum(int(g.result.n_instr.sum()) for g in rep.groups)
    log(f"[main] {rep.n_items} items in {p.wall_s:.2f}s wall: "
        f"{rep.n_items / p.wall_s:.1f} items/s, "
        f"{n_instr / p.wall_s:.4g} retired instructions/s, "
        f"{p.lane_steps} lane-step slots, {p.n_segments} segments, "
        f"{p.host_syncs} blocking host syncs, device busy share "
        f"{p.device_busy_frac:.4f} (engine estimate)")
    for g, grp in zip(rep.groups, plan.groups):
        r = g.result
        if not r.halted.all():
            raise AssertionError(f"{grp.workload}: "
                                 f"{int((~r.halted).sum())} items never "
                                 f"halted")
        w = g.workload
        n_chk = 1024 if w.key == "TT" else r.n_items
        mems = workload_source(w, grp.seed)(0, n_chk)
        want = np.asarray(w.ref(mems[:, :w.n_inputs]), np.int32)
        bad = int((r.out[:n_chk] != want).sum())
        if bad:
            raise AssertionError(f"{w.key}: {bad} of {n_chk} outputs differ "
                                 f"from the workload's reference")
        log(f"[main] {w.key} on {grp.core}: {r.n_items} items halted, "
            f"{n_chk} outputs equal to the reference, mean "
            f"{r.n_instr.mean():.1f} instructions")
    log(rep.format())
    return counts, rep


def profiled(fn, cpu=True):
    """Run fn() under torch.profiler: (its result, wall seconds, device
    busy seconds (the union of the device's activity intervals), rows of
    key_averages by device time), or busy None when the profiler saw no
    device activity. `cpu=False` records the device's activity only (a
    run of many small launches makes the host's events slow to read)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:              # union of device intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    rows = sorted(prof.key_averages(),
                  key=lambda r: r.self_device_time_total, reverse=True)
    return out, wall, (busy / 1e6 if spans else None), rows


def log_rows(tag, rows, n=10):
    for r in rows[:n]:
        if r.self_device_time_total <= 0:
            break
        log(f"[{tag}] {r.self_device_time_total / 1e3:10.2f} ms device "
            f"{r.count:6d} calls  {r.key[:90]}")


def log_per_launch(tag, rows):
    """The segment kernel's device time per launch from torch.profiler's
    rows (the run's own pool and segments)."""
    hit = [r for r in rows if "iss_segment_kernel" in r.key
           and not r.key.startswith("aten::")]
    n = sum(r.count for r in hit)
    ms = sum(r.self_device_time_total for r in hit) / 1e3
    if n:
        log(f"[{tag}] iss_segment_banked: {ms:.2f} ms device in {n} "
            f"launches = {ms / n:.4f} ms a launch (torch.profiler)")


def phase_profile(dev):
    """The main path once more under torch.profiler: the device's busy
    share (union of its activity intervals over the run's wall clock)
    and device time by kernel. Runs after the launch counts were read."""
    from repro_torch.fleet import run_plan
    plan = main_plan()
    rep, wall, busy, rows = profiled(lambda: run_plan(plan, device=dev))
    if busy is None:
        log("[profile] the profiler saw no device activity: device busy "
            "share not measured")
        return
    log(f"[profile] main path under torch.profiler: {wall:.2f}s wall "
        f"({rep.packed.wall_s:.2f}s inside run_packed), device busy "
        f"{busy:.3f}s = share {busy / wall:.4f} of the wall")
    log_rows("profile", rows)
    log_per_launch("profile", rows)


def queued_ms(fn, reps):
    """Device time of `reps` back-to-back calls, from CUDA events; a sleep
    queued first lets the host enqueue them all before the device reaches
    the first, so host overhead stays out."""
    import torch
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def exact_err(want, got):
    """Largest |a - b| over the sweep fields held exactly (numpy TileOut
    and accumulators of one tile; equal infinities count as 0, and a
    value at a bin edge would show here)."""
    import numpy as np
    (w_out, w_acc), (g_out, g_acc) = want, got
    err = 0.0
    pairs = [(getattr(w_out, f), getattr(g_out, f))
             for f in ("best_total", "best_core", "counts", "min_best",
                       "max_best")] + list(zip(w_acc, g_acc))
    for a, b in pairs:
        a, b = a.astype(np.float64), b.astype(np.float64)
        with np.errstate(invalid="ignore"):         # inf - inf, masked
            d = np.where(a == b, 0.0, np.abs(a - b))
        err = max(err, float(d.max()) if d.size else 0.0)
    return err


def sweep_bound(nbytes, n_ops, ops_per_s):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms)."""
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = n_ops / ops_per_s * 1e3
    return (max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops
            else "operations", b_bytes, b_ops)


def phase_sweep_kernel(dev, rec):
    """Both builds of the sweep kernel against their plain versions: small
    streamed tiles in float32 and float64, then the main path's tile,
    timed against its bound."""
    import numpy as np
    import torch
    import _torch_parity as tp
    from repro_torch import convert
    from repro_torch.kernels import carbon_sweep as cs

    worst = 0.0
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        cases = tp.stream_cases(np.random.default_rng(7), dtype)
        got = tp.port_stream(cases, dtype, dev)
        torch.cuda.synchronize()
        want = tp.port_stream(cases, dtype, dev, fn=cs.sweep_tile_plain)
        w = tp.assert_streams_equal(cases, want, got, dtype, name)
        worst = max(worst, w)
        log(f"[sweep kernel] (a) 3 streamed tiles of 12 cells x 8 draws x "
            f"3-4 candidates, {name}: equal to the plain version (largest "
            f"relative sum difference {w:.3g})")
        cases = tp.drawn_stream_cases(np.random.default_rng(9), dtype,
                                      n_draws=40)
        outs, accs, lifes = tp.port_stream_drawn(cases, dtype, dev)
        torch.cuda.synchronize()
        _, _, plain = tp.port_stream_drawn(cases, dtype, dev,
                                           fn=cs.sweep_tile_drawn_plain)
        ulps = max(int(tp.ulps(a, b).max()) for a, b in zip(plain, lifes))
        if ulps > tp.LIFE_ULPS[dtype]:
            raise AssertionError(f"drawn {name}: lifetimes {ulps} ulps from "
                                 f"the plain draws")
        fed = tp.with_lifetimes(cases, lifes)
        want = tp.port_stream(fed, dtype, dev, fn=cs.sweep_tile_plain)
        w = tp.assert_streams_equal(fed, want, (outs, accs), dtype, name)
        worst = max(worst, w)
        log(f"[sweep kernel] (b) 3 streamed drawn tiles of 12 cells x 40 "
            f"draws x 3-4 candidates, {name}: lifetimes within {ulps} ulps "
            f"of the plain draws; given them, equal to the plain tile "
            f"(largest relative sum difference {w:.3g})")

    # the main path's tile: 1,024 cells x 4,096 draws x 9 candidates
    TC, N, C = 1024, 4096, 9
    np_out = lambda o: cs.TileOut(*(x.cpu().numpy() for x in o))  # noqa
    fresh = lambda: cs.init_acc(64, 32, torch.float32, dev)  # noqa: E731
    sum_tol = 2 * (N - 1) * 2.0 ** -24

    # build (a): lifetimes read from device memory
    case = tp.tile_inputs(np.random.default_rng(8), TC, N, C, np.float32,
                          inf_cells=2, invalid_frac=0.05)
    args = [torch.from_numpy(case[k]).to(dev) for k in tp.TILE_ORDER]
    out, acc = cs.sweep_tile(*args, fresh(), device=dev, **tp.TILE_KW)
    torch.cuda.synchronize()
    pout, pacc = cs.sweep_tile_plain(*args, fresh(), **tp.TILE_KW)
    want = ([np_out(pout)], [convert.sweep_acc_to_numpy(pacc)])
    got = ([np_out(out)], [convert.sweep_acc_to_numpy(acc)])
    w = tp.assert_streams_equal([case], want, got, np.float32, "main tile")
    worst = max(worst, w)
    err = exact_err((want[0][0], want[1][0]), (got[0][0], got[1][0]))
    acc_t = fresh()
    times = [queued_ms(lambda: cs.sweep_tile(*args, acc_t, device=dev,
                                             **tp.TILE_KW), 10)
             for _ in range(3)]
    plain = [queued_ms(lambda: cs.sweep_tile_plain(*args, fresh(),
                                                   **tp.TILE_KW), 1)
             for _ in range(3)]
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + 2 * sum(t.numel() * t.element_size() for t in acc) \
        + sum(t.numel() * t.element_size() for t in out)
    n_ops = 4 * TC * N * C          # 2 mul, 1 add, 1 compare per candidate
    bound, by, b_bytes, b_ops = sweep_bound(nbytes, n_ops, FP32_OPS_PER_S)
    ms, plain_ms = sorted(times)[1], sorted(plain)[1]
    rec[SWEEP[0]] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         bound_ms=bound, bound_by=by)
    log(f"[sweep kernel] (a) main tile {TC} cells x {N} draws x {C} "
        f"candidates float32: equal to the plain version (largest relative "
        f"sum difference {w:.3g}, bound {sum_tol:.3g}); kernel {ms:.4f} ms "
        f"(runs {', '.join(f'{x:.4f}' for x in times)}), plain "
        f"{plain_ms:.2f} ms; bound {bound:.4f} ms (bytes {nbytes} -> "
        f"{b_bytes:.4f}, operations {n_ops} -> {b_ops:.4f})")

    # build (b): lifetimes drawn in the kernel, as the sweep runs it
    case = tp.drawn_tile_inputs(np.random.default_rng(10), TC, N, C,
                                np.float32, invalid_frac=0.05)
    args = [torch.from_numpy(case[k]).to(dev) for k in tp.DRAWN_ORDER]
    kw = dict(tp.TILE_KW, n_draws=N, day_s=tp.DAY_S)
    key = case["key"]
    life = torch.empty((TC, N), dtype=torch.float32, device=dev)
    out, acc = cs.sweep_tile_drawn(key, *args, fresh(), life_out=life,
                                   device=dev, **kw)
    torch.cuda.synchronize()
    plife = torch.empty_like(life)
    cs.sweep_tile_drawn_plain(key, *args, fresh(), life_out=plife, **kw)
    ulps = tp.ulps(plife.cpu().numpy(), life.cpu().numpy())
    if ulps.max() > tp.LIFE_ULPS[np.float32]:
        raise AssertionError(f"drawn main tile: lifetimes {ulps.max()} ulps "
                             f"from the plain draws")
    fed = tp.with_lifetimes([case], [life.cpu().numpy()])
    fargs = [torch.from_numpy(fed[0][k]).to(dev) for k in tp.TILE_ORDER]
    pout, pacc = cs.sweep_tile_plain(*fargs, fresh(), **tp.TILE_KW)
    want = ([np_out(pout)], [convert.sweep_acc_to_numpy(pacc)])
    got = ([np_out(out)], [convert.sweep_acc_to_numpy(acc)])
    w = tp.assert_streams_equal(fed, want, got, np.float32, "drawn tile")
    worst = max(worst, w)
    err = exact_err((want[0][0], want[1][0]), (got[0][0], got[1][0]))
    acc_t = fresh()
    times = [queued_ms(lambda: cs.sweep_tile_drawn(
        key, *args, acc_t, best_core=False, device=dev, **kw), 10)
        for _ in range(3)]
    plain = [queued_ms(lambda: cs.sweep_tile_drawn_plain(
        key, *args, fresh(), **kw), 1) for _ in range(3)]
    out_t, _ = cs.sweep_tile_drawn(key, *args, acc_t, best_core=False,
                                   device=dev, **kw)
    nbytes = sum(t.numel() * t.element_size() for t in args) \
        + 2 * sum(t.numel() * t.element_size() for t in acc) \
        + sum(t.numel() * t.element_size() for t in out_t if t is not None)
    n_ops = OPS_PER_HASH * (2 * TC * N + TC)   # two uniforms a draw, fold_in
    bound, by, b_bytes, b_ops = sweep_bound(nbytes, n_ops, INT32_OPS_PER_S)
    ms, plain_ms = sorted(times)[1], sorted(plain)[1]
    rec[SWEEP_DRAWN[0]] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                               bound_ms=bound, bound_by=by)
    log(f"[sweep kernel] (b) main drawn tile {TC} cells x {N} draws x {C} "
        f"candidates float32: lifetimes within {ulps.max()} ulps of the "
        f"plain draws ({int((ulps > 0).sum())} of {ulps.size} differ); "
        f"given them, equal to the plain tile (largest relative sum "
        f"difference {w:.3g}); kernel without best_core {ms:.4f} ms (runs "
        f"{', '.join(f'{x:.4f}' for x in times)}), plain {plain_ms:.2f} ms; "
        f"bound {bound:.4f} ms (bytes {nbytes} -> {b_bytes:.4f}, int32 "
        f"operations {n_ops} -> {b_ops:.4f})")
    log(f"[sweep kernel] largest relative sum difference seen: {worst:.3g}")


def phase_small_sweep(dev):
    """The reference test's mixture spec on card and CPU; tile sizes on the
    card; the float64 point-mass spec against the numpy oracles."""
    import numpy as np
    import _torch_parity as tp
    from repro_torch.core import selection as sel
    from repro_torch.core import sweep as sw

    spec = tp.sweep_mixture_spec()
    card, best, emb = tp.run_sweep_recorded(spec, tile_cells=48,
                                            device=dev)
    life_card = tp.sweep_life_days(spec, np.float32, dev, spec.n_cells)
    life_cpu = tp.sweep_life_days(spec, np.float32, "cpu", spec.n_cells)
    ulps = tp.ulps(life_card, life_cpu)
    if ulps.max() > tp.LIFE_ULPS[np.float32]:
        raise AssertionError(f"card and CPU lifetimes differ by "
                             f"{ulps.max()} ulps")
    cpu, _, _ = tp.run_sweep_recorded(spec, life_days=life_card,
                                      tile_cells=48, device="cpu")
    w = tp.assert_sweeps_equal(cpu, card, sw.build_tables(spec), best, emb,
                               "mixture card vs CPU")
    if card.frontier() != cpu.frontier():
        raise AssertionError("mixture: frontier rows differ")
    log(f"[small sweep] mixture spec ({spec.n_cells} cells x {spec.draws} "
        f"draws): the card kernel's lifetimes vs the CPU's within "
        f"{ulps.max()} ulps "
        f"({int((ulps > 0).sum())} of {ulps.size} differ); CPU fed the "
        f"card's lifetimes equals the card's sweep (means within relative "
        f"{w:.3g}), frontier rows equal")
    runs = [sw.run_sweep(spec, tile_cells=t, device=dev)
            for t in (3, 7, 48, spec.n_cells)]
    for r in runs[1:]:
        tp.assert_sweeps_identical(runs[0], r, "tile sizes")
    log("[small sweep] tile sizes 3, 7, 48, all on the card: bit-identical")
    spec, lifes = tp.sweep_point_spec()
    res = sw.run_sweep(spec, tile_cells=5, dtype=np.float64, device=dev)
    tg = sel.total_grid(list(spec.cores), spec.profiles[0],
                        np.asarray(lifes), np.asarray(spec.execs_per_day))
    smap = sel.selection_map(spec.profiles[0], np.asarray(lifes),
                             np.asarray(spec.execs_per_day))
    sq = np.s_[:, :, 0, 0, 0, 0, 0]
    for f in ("p50", "min", "max"):
        if not np.array_equal(getattr(res, f)[sq], tg.min(axis=0)):
            raise AssertionError(f"point mass f64: {f} != total_grid min")
    if not np.array_equal(res.best_core[sq], smap):
        raise AssertionError("point mass f64: best_core != selection_map")
    log("[small sweep] float64 point-mass spec on the card: min, p50, max "
        "equal total_grid(...).min(0) and best_core equals selection_map, "
        "bit for bit")


def main_sweep_spec():
    """The sweep's main path: the axes of benchmarks/fleet.py's planner
    study plus the redundancy and fault-rate axes that
    examples/carbon_planner.py exposes, at 4,096 draws."""
    from repro_torch.core.sweep import LifetimeDist, workload_spec
    day = 86_400.0
    dists = (
        LifetimeDist.point(30 * day),
        LifetimeDist.lognormal(100 * day, 1.8),
        LifetimeDist.weibull(300 * day, 1.5),
        LifetimeDist.mixture(
            [(LifetimeDist.point(10 * day), 0.5),
             (LifetimeDist.lognormal(1000 * day, 0.8), 0.5)]),
    )
    return workload_spec(
        dists=dists, execs_per_day=(1.0, 24.0, 96.0, 960.0, 8640.0),
        intensities=(0.05, 0.233, 0.367, 0.7), volumes=(1e3, 1e6, 1e9),
        timing=("base", "dynamic", "wcet"),
        redundancies=("none", "dmr", "tmr"), fault_rates=(0.0, 1e-6),
        draws=4096, seed=0)


def phase_main_sweep(dev):
    """The main sweep through `run_sweep` on the card: 16 drawn-kernel
    launches and no eager draw, bit-identical on a rerun and at tile
    1,536, then under torch.profiler. Returns the launches of both
    builds on the main sweep's run."""
    import numpy as np
    import _torch_parity as tp
    from repro_torch import prng
    from repro_torch.core import sweep as sw
    from repro_torch.kernels import carbon_sweep as cs

    t0 = time.perf_counter()
    spec = main_sweep_spec()
    log(f"[main sweep] spec built on the host in "
        f"{time.perf_counter() - t0:.1f}s: {spec.n_cells} cells x "
        f"{spec.draws} draws = {spec.n_scenarios} scenarios, "
        f"{spec.n_candidates} candidates")
    n_tiles = -(-spec.n_cells // 1024)
    # count the eager draws too: the card's sweep must not call them
    eager = {"_Step.life_days": 0, "prng.uniform": 0}

    def counted(fn, name):
        def call(*a, **k):
            eager[name] += 1
            return fn(*a, **k)
        return call
    life_days, uniform = sw._Step.life_days, prng.uniform
    sw._Step.life_days = counted(life_days, "_Step.life_days")
    prng.uniform = counted(uniform, "prng.uniform")
    cs.reset_counts()
    try:
        res = sw.run_sweep(spec, tile_cells=1024, device=dev)
    finally:
        sw._Step.life_days, prng.uniform = life_days, uniform
    launches = cs.sweep_tile_drawn.launches
    counts = {SWEEP[0]: cs.sweep_tile.launches, SWEEP_DRAWN[0]: launches}
    other = (cs.sweep_tile_drawn.plain_calls, cs.sweep_tile.launches,
             cs.sweep_tile.plain_calls)
    if launches != n_tiles or any(other) or any(eager.values()):
        raise AssertionError(
            f"main sweep: {launches} drawn launches for {n_tiles} tiles; "
            f"drawn plain calls, sweep_tile launches and plain calls "
            f"{other}; eager draws {eager}")
    if int(res.hist.sum()) != spec.n_scenarios:
        raise AssertionError(f"main sweep: histogram holds "
                             f"{int(res.hist.sum())} scenarios")
    log(f"[main sweep] run_sweep tile 1024: {res.n_scenarios} scenarios in "
        f"{res.wall_s:.3f}s wall = {res.scenarios_per_s:.4g} scenarios/s, "
        f"{res.host_syncs} blocking host syncs, {launches} sweep_tile_drawn "
        f"launches ({n_tiles} tiles), 0 plain calls, 0 sweep_tile launches, "
        f"eager draws {eager}, histogram total {int(res.hist.sum())}")
    again = sw.run_sweep(spec, tile_cells=1024, device=dev)
    wide = sw.run_sweep(spec, tile_cells=1536, device=dev)
    tp.assert_sweeps_identical(res, again, "main sweep rerun")
    tp.assert_sweeps_identical(res, wide, "main sweep tile 1536")
    log(f"[main sweep] rerun at tile 1024: {again.wall_s:.3f}s = "
        f"{again.scenarios_per_s:.4g} scenarios/s; tile 1536: "
        f"{wide.wall_s:.3f}s = {wide.scenarios_per_s:.4g} scenarios/s; "
        f"every field bit-identical across the three runs")
    rows = res.frontier()
    cores, n = np.unique(res.best_core, return_counts=True)
    log(f"[main sweep] frontier: {len(rows)} points, embodied "
        f"{rows[0]['embodied_kg']:.4g}..{rows[-1]['embodied_kg']:.4g} kg; "
        f"least p50 total {res.p50.min():.4g} kg; cells by modal core "
        + ", ".join(f"{spec.cores[c].name} {k}" for c, k in zip(cores, n)))
    prof, wall, busy, krows = profiled(
        lambda: sw.run_sweep(spec, tile_cells=1024, device=dev))
    if busy is None:
        log("[main sweep] the profiler saw no device activity: device busy "
            "share not measured")
        return counts
    log(f"[main sweep] under torch.profiler: {wall:.3f}s wall "
        f"({prof.wall_s:.3f}s inside run_sweep), device busy "
        f"{busy:.4f}s = share {busy / wall:.4f} of the wall")
    # device time by layer, over the device rows themselves (the aten::
    # rows repeat their kernels' time); rows that are no kernel (launch
    # queue full, event queries) get their own bucket
    layers = {"carbon_sweep kernel (draws fused)": 0.0, "sort": 0.0,
              "copies": 0.0,
              "decode, gathers, statistics (eager elementwise)": 0.0,
              "no kernel (launch queue full, event queries)": 0.0}
    kernels = [r for r in krows if r.self_device_time_total > 0
               and not r.key.startswith("aten::")]
    for r in kernels:
        k = r.key
        if "sweep_cells_kernel" in k or "sweep_pareto_kernel" in k:
            g = "carbon_sweep kernel (draws fused)"
        elif "ort" in k or "adix" in k:
            g = "sort"
        elif "emcpy" in k or "emset" in k:
            g = "copies"
        elif k.startswith("cuda") or k == "Command Buffer Full":
            g = "no kernel (launch queue full, event queries)"
        else:
            g = "decode, gathers, statistics (eager elementwise)"
        layers[g] += r.self_device_time_total / 1e3
    total = sum(layers.values())
    log("[main sweep] device time by layer: " + "; ".join(
        f"{g} {ms:.2f} ms ({ms / total:.3f})" for g, ms in layers.items()))
    log_rows("main sweep", kernels, 12)
    return counts

FAULT_CASES = (
    ("transient regs+mem+pc 1e-2",
     dict(rate=1e-2, seed=3, targets=("regs", "mem", "pc"))),
    ("transient regs+mem+pc 1.0",
     dict(rate=1.0, seed=4, targets=("regs", "mem", "pc"))),
    ("stuck 0.5", dict(rate=0.5, seed=5, mode="stuck")),
    ("dead 0.5", dict(rate=0.5, seed=6, mode="dead")),
)


def phase_fault_kernel(dev, rec):
    """The faults variant against its plain version on a small pool in
    every mode; the one-program wrapper; then at full shape, timed with
    faults off and with transients at 1e-5, and its bound."""
    import numpy as np
    import torch
    from repro_torch.flexibits import faults as pf
    from repro_torch.flexibits import iss
    from repro_torch.kernels import iss_stepper as st

    bank, clen, mlen, cost, state = pool(256, 7, dev,
                                         keys=("MC", "WQ", "SI"))
    epoch = torch.arange(256, dtype=torch.int32, device=dev) % 5
    clean = state()
    for _ in range(2):
        st.iss_segment_banked(bank, clen, clean, seg_steps=256,
                              mem_len=mlen, device=dev)
    for label, kw in FAULT_CASES:
        spec = pf.FaultSpec(**kw)
        for timing in (False, True):
            n, out = check_segment(st, dev, bank, clen, mlen,
                                   cost if timing else None, state, 256, 2,
                                   faults=spec, epoch=epoch)
            if torch.equal(out.lanes.regs, clean.lanes.regs):
                raise AssertionError(f"{label}: no fault fired")
            log(f"[fault kernel] {label}, 256 lanes x 3 programs x 2 x 256 "
                f"steps, timing {'on' if timing else 'off'}: bit-exact "
                f"({n} instructions retired)")

    # the one-program wrapper: a skewed counting loop, transients
    import _torch_parity as tp
    prog = tp.skew_program()
    mems = torch.from_numpy(tp.skew_mems(prog, 512, 8, 300, 0.3, 5)).to(dev)
    code = torch.from_numpy(
        np.asarray(prog.code, np.uint32).view(np.int32)).to(dev)
    spec = pf.FaultSpec(**FAULT_CASES[0][1])
    key = pf.lane_keys_tensor(spec.seed, 512, dev)
    ep = torch.zeros(512, dtype=torch.int32, device=dev)
    # fresh_lanes keeps an int32 image as the lanes' memory, and the
    # kernel updates it in place: each run gets its own copy
    a = st.iss_segment(code, iss.fresh_lanes(mems.clone()), seg_steps=700,
                       max_steps=650, faults=spec, lane_key=key, epoch=ep,
                       device=dev)
    z = torch.zeros(512, dtype=torch.int32, device=dev)
    b = iss.run_segment_lanes_banked(
        code[None, :].contiguous(),
        torch.full((1,), code.shape[0], dtype=torch.int32, device=dev),
        iss.PackedState(iss.fresh_lanes(mems.clone()), z, z + 650), 700,
        None, None, None, faults=spec, lane_key=key, epoch=ep).lanes
    torch.cuda.synchronize()
    max_abs_err(iss.PackedState(a, z, z), iss.PackedState(b, z, z))
    log("[fault kernel] iss_segment (one program, 512 lanes, transients "
        "1e-2): bit-exact with the plain version")

    # ---- full shape: 16,384 lanes x 4,096 steps, timing on
    L, SEGSTEPS = 16384, 4096
    bank, clen, mlen, cost, state = pool(L, 2, dev)
    s0 = state()
    spec = pf.FaultSpec(rate=1e-5, seed=5, targets=("regs", "mem", "pc"))
    key = pf.lane_keys_tensor(spec.seed, L, dev)
    ep = torch.zeros(L, dtype=torch.int32, device=dev)
    kw = dict(mem_len=mlen, cost=cost, device=dev)
    plain = [None]

    def run_plain():
        plain[0] = iss.run_segment_lanes_banked(
            bank, clen, clone(s0), SEGSTEPS, None, mlen, cost, faults=spec,
            lane_key=key, epoch=ep)
    plain_ms = events_ms(run_plain)
    t_off, t_on = [], []
    out = [None]
    for _ in range(3):
        for faults, times in ((None, t_off), (spec, t_on)):
            s = clone(s0)
            torch.cuda.synchronize()
            times.append(events_ms(lambda: out.__setitem__(
                0, st.iss_segment_banked(bank, clen, s, seg_steps=SEGSTEPS,
                                         faults=faults, lane_key=key,
                                         epoch=ep, **kw))))
            if faults is not None:
                err = max_abs_err(out[0], plain[0])
    steps = int((plain[0].lanes.n_instr - s0.lanes.n_instr).sum())
    fires = count_fires(spec, key, ep, s0, plain[0])
    nbytes = 2 * sum(x.numel() * x.element_size() for x in s0.lanes) + sum(
        x.numel() * x.element_size()
        for x in (s0.prog_id, s0.max_steps, bank, clen, mlen, cost, key, ep))
    n_ops = steps * (OPS_PER_STEP + FAULT_OPS_PER_STEP) \
        + fires * FAULT_OPS_PER_FIRE
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = n_ops / INT32_OPS_PER_S * 1e3
    ms_off, ms_on = sorted(t_off)[1], sorted(t_on)[1]
    rec[SEG_FAULTS[0]] = dict(
        ms=ms_on, plain_ms=plain_ms, max_abs_err=err,
        bound_ms=max(b_bytes, b_ops),
        bound_by="bytes" if b_bytes >= b_ops else "operations")
    log(f"[fault kernel] full shape {L} lanes x {SEGSTEPS} steps (timing "
        f"on; earlier kernel: faults off {EARLIER_SEG_MS['fault-free']} ms, "
        f"transients {EARLIER_SEG_MS['faults']} ms): faults off "
        f"{ms_off:.3f} ms (runs "
        f"{', '.join(f'{x:.3f}' for x in t_off)}); transients 1e-5 "
        f"{ms_on:.3f} ms (runs {', '.join(f'{x:.3f}' for x in t_on)}), "
        f"{ms_on / ms_off:.3f}x; bit-exact with the plain version "
        f"({plain_ms:.1f} ms); {steps} retired lane-steps, {fires} fires; "
        f"bound {max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f}, "
        f"operations {n_ops} -> {b_ops:.4f})")


def count_fires(spec, key, epoch, before, after) -> int:
    """Transient fires of a segment: for each lane, the post-commit
    counts n in (before, after] whose draw mix32(k ^ n) is under the
    threshold (the halting step's draw is counted too: an upper bound)."""
    import torch
    from repro_torch import _u32
    from repro_torch.flexibits import faults as pf
    k = pf.mix32(key ^ pf.mix32(epoch))
    lo, hi = before.lanes.n_instr, after.lanes.n_instr
    fires = torch.zeros((), dtype=torch.int64, device=k.device)
    for n in range(int(lo.min()) + 1, int(hi.max()) + 1):
        hit = (_u32.as_u32(pf.mix32(k ^ n)) < spec.threshold) \
            & (n > lo) & (n <= hi)
        fires += hit.sum()
    return int(fires)


def small_resilient_plan(**kw):
    from repro_torch.fleet import FleetGroup, FleetPlan
    return FleetPlan(groups=(
        FleetGroup(workload="MC", core="SERV", n_items=64, seed=0,
                   max_steps="static"),
        FleetGroup(workload="WQ", core="QERV", n_items=64, seed=1,
                   max_steps="static"),
        FleetGroup(workload="SI", core="HERV", n_items=64, seed=2,
                   max_steps="static"),
    ), chunk=128, seg_steps=1024, **kw)


def resilient_plans():
    """Phase 11's plans by label: unprotected and under DMR."""
    from repro_torch.flexibits.faults import FaultSpec
    spec = FaultSpec(rate=1e-4, seed=5, targets=("regs", "mem", "pc"))
    return {"unprotected": small_resilient_plan(faults=spec),
            "dmr": small_resilient_plan(faults=spec, redundancy="dmr",
                                        max_retries=6)}


def phase_small_resilient(dev, cpu_runs):
    """Phase 4's groups with transients, unprotected and under DMR, on
    card and CPU: every per-item field, counters and schedule equal."""
    import numpy as np
    from repro_torch.fleet import run_plan
    for label, plan in resilient_plans().items():
        t0 = time.perf_counter()
        gpu = run_plan(plan, keep_state=True, device=dev)
        t1 = time.perf_counter()
        cpu, t_cpu = cpu_runs[f"resilient {label}"].result()
        for a, b in zip(gpu.groups, cpu.groups):
            for f in ("n_instr", "n_two_stage", "halted", "out", "mix",
                      "mems", "regs", "pc", "mix_items"):
                if not np.array_equal(getattr(a.result, f),
                                      getattr(b.result, f)):
                    raise AssertionError(f"small {label} plan: card and CPU "
                                         f"differ in {a.workload.key}.{f}")
        p, q = gpu.packed, cpu.packed
        for f in ("lane_steps", "n_segments", "seg_schedule", "detected",
                  "corrected", "quarantined"):
            if getattr(p, f) != getattr(q, f):
                raise AssertionError(f"small {label} plan: {f} differs "
                                     f"({getattr(p, f)} vs {getattr(q, f)})")
        if label == "dmr" and p.detected == 0:
            raise AssertionError("small dmr plan: nothing detected")
        log(f"[small resilient] {label}: 3 groups x 64 items, chunk "
            f"{p.chunk}: card {t1 - t0:.2f}s, CPU {t_cpu:.2f}s (a worker "
            f"process); every "
            f"per-item field, the final state, {p.n_segments} segments, "
            f"{p.lane_steps} lane-steps and detected/corrected/quarantined "
            f"{p.detected}/{p.corrected}/{p.quarantined} bit-exact")


def dmr_boundary_ms(dev):
    """Device time of one DMR boundary's digest, snapshot copy and
    rollback at the main path's pool shape (16,384 lanes x 2,824 words;
    random contents, which these costs do not depend on), from CUDA
    events (mean of 5; the rollback selects every field)."""
    import torch
    from repro_torch.flexibits import faults as pf
    from repro_torch.flexibits import iss
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                             dtype=torch.int32, device=dev)
    L = 16384
    lanes = iss.ISSState(r(L, 16), r(L), r(L, 2824), r(L) > 0, r(L), r(L),
                         r(L, 8), r(L))
    snap = iss.ISSState(*(x.clone() for x in lanes))
    rb = r(L) > 2**30                      # a quarter of the lanes
    digest = events_ms(lambda: pf.arch_digest(
        lanes.regs, lanes.pc, lanes.mem, lanes.halted, lanes.n_instr), 5)

    def copy():
        for x, y in zip(snap, lanes):
            x.copy_(y)

    def rollback():
        for x, y in zip(lanes, snap):
            torch.where(rb.view((-1,) + (1,) * (x.dim() - 1)), y, x, out=x)
    return digest, events_ms(copy, 5), events_ms(rollback, 5)


def phase_main_resilient(dev, main_rep):
    """Phase 5's plan (a) with unprotected transients, (b) the same under
    DMR, (c) dead lanes under DMR; launch counts per run, items against
    phase 5's, and each run once more under torch.profiler."""
    import numpy as np
    from repro_torch.fleet import run_plan
    from repro_torch.flexibits.faults import FaultSpec
    from repro_torch.kernels import iss_stepper as st
    base = main_plan()
    transient = FaultSpec(rate=1e-5, seed=5, targets=("regs", "mem", "pc"))
    runs = (
        ("a", "transients 1e-5, unprotected", dict(faults=transient)),
        ("b", "transients 1e-5, DMR, max_retries 6",
         dict(faults=transient, redundancy="dmr", max_retries=6)),
        ("c", "dead lanes 1e-3, DMR, max_retries 1",
         dict(faults=FaultSpec(rate=1e-3, seed=5, mode="dead"),
              redundancy="dmr", max_retries=1)),
    )
    total_launches = 0
    for tag, label, kw in runs:
        plan = dataclasses.replace(base, **kw)
        st.reset_counts()
        rep = run_plan(plan, device=dev)
        launches = st.iss_segment_banked.fault_launches
        if launches <= 0 or st.iss_segment_banked.launches \
                or st.iss_refill.launches <= 0 \
                or st.iss_segment_banked.plain_calls \
                or st.iss_refill.plain_calls:
            raise AssertionError(
                f"({tag}) launches: faults {launches}, fault-free "
                f"{st.iss_segment_banked.launches}, refill "
                f"{st.iss_refill.launches}, plain calls "
                f"{st.iss_segment_banked.plain_calls}")
        total_launches += launches
        p = rep.packed
        # architectural results (output, retirements, halt) of every item
        # against phase 5's; DMR's digest covers the architectural state
        # only, so its recovery is held to those, and the tallies it does
        # not cover (two-stage count, ticks, mix) are counted
        differ = tallies = 0
        mix_diff = {}
        for g, g0 in zip(rep.groups, main_rep.groups):
            a, b = g.result, g0.result
            bad = (a.out != b.out) | (a.n_instr != b.n_instr) \
                | (a.halted != b.halted)
            differ += int(bad.sum())
            tallies += int(((a.n_two_stage != b.n_two_stage)
                            | (a.n_cycles != b.n_cycles)).sum())
            if not np.array_equal(a.mix, b.mix):
                mix_diff[g.workload.key] = (a.mix - b.mix).tolist()
        if tag != "a" and differ:
            raise AssertionError(f"({tag}) {differ} items' output, "
                                 f"retirement count or halt differ from "
                                 f"the fault-free run")
        if tag == "b" and not (p.detected > 0
                               and p.corrected <= p.detected):
            raise AssertionError(f"(b) detected {p.detected}, corrected "
                                 f"{p.corrected}")
        if tag == "c" and p.quarantined <= 0:
            raise AssertionError("(c) nothing quarantined")
        log(f"[resilient main] ({tag}) {label}: {rep.n_items} items in "
            f"{p.wall_s:.2f}s wall = {rep.n_items / p.wall_s:.1f} items/s "
            f"(fault-free {main_rep.packed.wall_s:.2f}s, "
            f"{p.wall_s / main_rep.packed.wall_s:.2f}x), chunk {p.chunk}, "
            f"{p.n_segments} segments, {p.host_syncs} blocking host syncs, "
            f"{launches} faults-variant launches, "
            f"{st.iss_refill.launches} refill launches; detected "
            f"{p.detected}, corrected {p.corrected}, quarantined "
            f"{p.quarantined}; items whose output, retirement count or "
            f"halt differ from the fault-free run: {differ}; items whose "
            f"two-stage count or ticks differ: {tallies}; groups whose "
            f"instruction mix differs (this run minus the fault-free one, "
            f"by class): {mix_diff or 'none'}")
        if tag == "a":
            log(f"[resilient main] (a) unprotected SDC count (output, "
                f"retirement count or halt differ): {differ} of "
                f"{rep.n_items} items")
        prep, wall, busy, rows = profiled(lambda: run_plan(plan, device=dev))
        if busy is None:
            log(f"[resilient main] ({tag}) the profiler saw no device "
                f"activity: busy share not measured")
        else:
            log(f"[resilient main] ({tag}) under torch.profiler: "
                f"{wall:.2f}s wall ({prep.packed.wall_s:.2f}s inside "
                f"run_packed), device busy {busy:.3f}s = share "
                f"{busy / wall:.4f}")
            log_rows(f"resilient main ({tag})", rows, 8)
            log_per_launch(f"resilient main ({tag})", rows)
        if tag == "b":
            d, c, r = dmr_boundary_ms(dev)
            n = p.n_segments
            log(f"[resilient main] (b) one DMR boundary at full shape: "
                f"digest {d:.3f} ms, snapshot copy {c:.3f} ms, rollback "
                f"{r:.3f} ms (CUDA events); x {n} boundaries = digest "
                f"{d * n:.1f} ms, snapshot {c * n:.1f} ms, rollback "
                f"{r * n:.1f} ms of device time")
    return total_launches


# ------------------------------------------------------------------ LM
# kernel against plain version on the same inputs: largest |difference|
# over the output's largest magnitude (at least 1). The float32
# instantiations multiply in float32 like their plain versions, in
# another order: 1e-4 for float32 outputs. The bfloat16 ones multiply
# bfloat16 operands on the tensor cores into float32 sums (the bit
# planes' W_q and the flash kernel's q, k, v are exact in bfloat16), and
# the flash kernel rounds P to bfloat16 for P v, the scan kernel W, S
# and B w for their products: one bfloat16 step (2^-7) for bfloat16
# outputs
LM_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
FLASH = ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:61")
# the same wrapper's bfloat16 forward, every head dim (1-256), a kernel
# of its own (wgmma, TMA, warpgroups taking turns; builds of 64, 128, 192
# and 256 columns): its launches are counted apart too
# (`flash_attention.wgmma_launches`), and are also flash's
FLASH_WGMMA = ("flash_fwd_wgmma",
               "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:61")
SSD = ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
       "src/repro/kernels/ssd_scan.py:67")
BITPLANE = ("bitplane_matmul",
            "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
            "src/repro/kernels/bitplane_matmul.py:56")
# the scan kernel's time at the main shape before its bfloat16 forward
# moved to wgmma and TMA (the mma.sync build, measured on one NVIDIA H100
# 80GB HBM3, 700.00 W)
EARLIER_SSD_MS = 0.4014
# the scan's bfloat16 forward kernel (wgmma and TMA; builds of N <= 64
# and N <= 128): its launches are counted apart
# (`ssd_scan.wgmma_launches`), and are also ssd_scan's
SSD_WGMMA = "ssd_fwd_wgmma"
# its bfloat16 backward kernel (wgmma and TMA; six builds by N's and P's
# 64-column boxes and heads a block): counted apart too
# (`ssd_scan.bwd_wgmma_launches`), and also ssd_scan_bwd's
SSD_BWD_WGMMA = "ssd_bwd_wgmma"
# the main serve: Zamba2-7B, 8 requests, prompt 512, 32 generated tokens
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
# the reference's count_params_abstract of Zamba2-7B, rounded
REF_SERVE_PARAMS = 6.957e9
PROFILE_GEN = 8


def lm_err(got, want, what, tol=None):
    """Largest |got - want|; raises past the stated tolerance."""
    dt = str(got.dtype).replace("torch.", "")
    tol = LM_TOL[dt] if tol is None else tol
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not err <= tol * scale:
        raise AssertionError(f"{what}: kernel and plain version differ by "
                             f"{err:.3g} (tolerance {tol} x {scale:.3g})")
    return err


def timed(fn, reps):
    fn()                                            # warm-up
    return events_ms(fn, reps)


def kernel_name(mangled: str) -> str:
    """A kernel's own name and template arguments from its mangled name
    (_Z[N] <len><namespace>... <len><name> I<args>E ...): integers
    (Li<n>E), builtin types (f: float) and named types (<len><name>)."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while i < len(mangled) and mangled[i] != "E":
            m = re.match(r"Li(\d+)E|(\d+)|([a-z])", mangled[i:])
            if m is None:
                break
            if m.group(1):
                args.append(m.group(1))
            elif m.group(2):
                k = i + len(m.group(2))
                args.append(mangled[k:k + int(m.group(2))])
                i = k + int(m.group(2)) - m.end()
            else:
                args.append({"f": "float"}.get(m.group(3), m.group(3)))
            i += m.end()
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str):
    """[(kernel, registers, static shared bytes, spill stores, spill
    loads)] from nvcc's -Xptxas=-v output."""
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            rows.append((kernel_name(fn), int(m.group(1)),
                         int(m.group(2) or 0), *spill))
            fn = None
    return rows


def sass_mma_counts(lib: str):
    """{kernel: (HMMA, HGMMA)}: the tensor-core instructions in the SASS
    of a built library, or None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += bool(re.search(r"\bHMMA\.", line))
            counts[fn][1] += bool(re.search(r"\bHGMMA\.", line))
    return {k: tuple(v) for k, v in counts.items()}


def check_tensor_cores():
    """Counts each LM kernel's tensor-core instructions; fails if the bit
    planes' GEMM has none, if one of the four builds (64, 128, 192 and 256
    columns) of the bfloat16 flash forward (flash_fwd_wgmma) or of each of
    the backward's kernels (flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma) has
    no HGMMA or any HMMA (Ampere's mma.sync), or if one of the two builds
    (N <= 64, N <= 128) of the bfloat16 scan forward (ssd_fwd_wgmma) or
    of the six of its backward (ssd_bwd_wgmma) does."""
    libs = ("flash_attention", "ssd_scan", "bitplane_matmul")
    counts = {lib: sass_mma_counts(lib) for lib in libs}
    if counts[libs[0]] is None:
        log("[lm kernels] no cuobjdump in the toolkit: tensor-core "
            "instructions not counted")
        return
    for lib, c in counts.items():
        log(f"[lm kernels] {lib} SASS: " + "; ".join(
            f"{k} {h} HMMA, {g} HGMMA" for k, (h, g) in c.items()))
    for lib, kernel in (("bitplane_matmul", "bitplane_gemm"),):
        hits = [sum(v) for k, v in counts[lib].items()
                if k.startswith(kernel)]
        if not hits or min(hits) == 0:
            raise AssertionError(f"{kernel} ({lib}) has no HMMA or HGMMA "
                                 f"instruction in its SASS: {counts[lib]}")
    for kernel in (FLASH_WGMMA[0],) + BWD_WGMMA_KERNELS:
        wg = [v for k, v in counts["flash_attention"].items()
              if k.startswith(kernel)]
        if len(wg) != 4 or any(h or not g for h, g in wg):
            raise AssertionError(f"{kernel}: its 4 builds need HGMMA and no "
                                 f"HMMA: {wg}")
    for kernel, builds in ((SSD_WGMMA, 2), (SSD_BWD_WGMMA, 6)):
        wg = [v for k, v in counts["ssd_scan"].items()
              if k.startswith(kernel)]
        if len(wg) != builds or any(h or not g for h, g in wg):
            raise AssertionError(f"{kernel}: its {builds} builds need HGMMA "
                                 f"and no HMMA: {wg}")


def ssd_wgmma_registers():
    """ptxas's report for the bfloat16 scan forward's two builds
    (ssd_fwd_wgmma<1 | 2>) and its backward's six (ssd_bwd_wgmma<N's
    boxes, P's boxes, heads a block>): '<kernel>: <registers> registers,
    spills <st>/<ld> bytes'; raises on a spill. Empty where this process
    found the library built."""
    from repro_torch.kernels import _build
    rows = [r for r in ptxas_report(_build.build_log("ssd_scan"))
            if r[0].startswith((SSD_WGMMA, SSD_BWD_WGMMA))]
    spilled = [r for r in rows if r[3] or r[4]]
    if spilled:
        raise AssertionError(f"bfloat16 scan kernels spill: {spilled}")
    return [f"{k}: {regs} registers, spills {st}/{ld} bytes"
            for k, regs, _, st, ld in rows]


def check_ssd_wgmma_share(tag, cfg, launches):
    """Every bfloat16 scan forward of `cfg` since the counts were zeroed
    ran ssd_fwd_wgmma, and no float32 one: `ssd_scan.wgmma_launches` is
    wgmma_share(cfg, launches), `launches` the scan forwards counted."""
    from repro_torch.kernels import ssd_scan as pss
    want = wgmma_share(cfg, launches)
    if pss.ssd_scan.wgmma_launches != want:
        raise AssertionError(f"{tag}: {pss.ssd_scan.wgmma_launches} of "
                             f"{launches} scan forwards ran {SSD_WGMMA}, "
                             f"expected {want}")


def check_ssd_bwd_wgmma_share(tag, cfg, launches):
    """Every bfloat16 scan backward of `cfg` since the counts were zeroed
    ran ssd_bwd_wgmma, and no float32 one: `ssd_scan.bwd_wgmma_launches`
    is wgmma_share(cfg, launches), `launches` the scan backwards
    counted."""
    from repro_torch.kernels import ssd_scan as pss
    want = wgmma_share(cfg, launches)
    if pss.ssd_scan.bwd_wgmma_launches != want:
        raise AssertionError(f"{tag}: {pss.ssd_scan.bwd_wgmma_launches} of "
                             f"{launches} scan backwards ran "
                             f"{SSD_BWD_WGMMA}, expected {want}")


def flash_bound(q, tq, tk, causal, window=0):
    """Bytes (q, k, v read once, o written once) and operations (two
    products over the (query, key) pairs the function uses: below each
    row's key limit and, with a window, from its lower limit) over the
    card's peaks, ms."""
    bh, l, d = q.shape
    pairs = 0
    for qp in range(l):
        if causal:
            up = min(max((qp // tq + 1) * tq // tk, 1), l // tk)
            lo = max(qp - window + 1, max(qp // tq - window // tk, 0) * tk) \
                if window else 0
            pairs += min(qp + 1, up * tk) - lo
        else:
            pairs += l
    nbytes = 4 * q.numel() * q.element_size()
    ops = 4 * bh * d * pairs
    rate = BF16_OPS_PER_S if q.dtype.itemsize == 2 else FP32_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3


def ssd_bound(a, x, dt, b, c, q):
    """Bytes (inputs read once, y and the final state written once) and
    operations (per chunk: C.B over the causal pairs, their weighted sum
    of x, C.S and the state update) over the card's peaks, ms."""
    bh, l, p = x.shape
    n = b.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (a, x, dt, b, c)) \
        + x.numel() * x.element_size() + bh * n * p * 4
    pairs = q * (q + 1) // 2
    ops = bh * (l // q) * (pairs * 2 * (n + p) + 4 * q * n * p)
    rate = BF16_OPS_PER_S if x.dtype.itemsize == 2 else FP32_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3


def bitplane_bound(x, planes, scales, n):
    m, k = x.shape
    nbytes = sum(t.numel() * t.element_size() for t in (x, planes, scales)) \
        + m * n * x.element_size()
    rate = BF16_OPS_PER_S if x.dtype.itemsize == 2 else FP32_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * k * n / rate * 1e3


def record(rec, name, ms, plain_ms, err, bounds, library_ms, detail):
    b_bytes, b_ops = bounds
    rec[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                     bound_ms=max(b_bytes, b_ops),
                     bound_by="bytes" if b_bytes >= b_ops else "operations",
                     library_ms=library_ms, detail=detail)
    log(f"[lm kernels] {name} {detail}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, library "
        f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
        f"bound {max(b_bytes, b_ops):.4f} ms (bytes {b_bytes:.4f}, "
        f"operations {b_ops:.4f}); max |kernel - plain| {err:.3g}")


def phase_lm_kernels(dev, rec):
    """The three LM kernels against their plain versions: small and
    ragged shapes in float32 and bfloat16, then the main path's shapes in
    bfloat16, timed with CUDA events beside the plain version and, where
    one PyTorch call computes the same function, that call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as pss

    # float32 products in full float32 on the card, stated and set (the
    # plain versions and the library calls use cuBLAS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(14)

    def rnd(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    check_tensor_cores()
    log("[lm kernels] ptxas: " + ("; ".join(ssd_wgmma_registers())
                                  or "ssd_scan found built"))
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for bh, l, d, tq, tk in ((3, 11, 16, 11, 11), (2, 200, 112, 200, 200),
                                 (2, 200, 64, 50, 100),
                                 (2, 200, 64, 100, 50),
                                 (2, 200, 40, 200, 200),
                                 (2, 200, 40, 50, 100)):
            for causal in (True, False):
                q, k, v = (rnd((bh, l, d), dtype) for _ in range(3))
                got = pfa.flash_attention(q, k, v, causal=causal, tq=tq,
                                          tk=tk, device=dev)
                torch.cuda.synchronize()
                lm_err(got, pfa.flash_attention_plain(
                    q, k, v, causal=causal, tq=tq, tk=tk),
                    f"flash {dtype} {(bh, l, d, tq, tk, causal)}")
                n_cases += 1
        # two chunks and an odd head count; three chunks, three groups;
        # P = N = 128 (the bfloat16 kernel's wide build); a chunk past one
        # C B^T strip of the bfloat16 kernel (one head a block)
        for bt, h, l, p, n, q_, groups in ((1, 3, 22, 16, 8, 11, 1),
                                           (2, 5, 96, 64, 64, 48, 5),
                                           (2, 6, 300, 20, 40, 100, 3),
                                           (1, 4, 512, 128, 128, 256, 1),
                                           (1, 2, 1024, 64, 64, 512, 1)):
            x = rnd((bt * h, l, p), dtype)
            dt = F.softplus(rnd((bt * h, l)))
            a = -torch.exp(rnd((bt * h,), scale=0.3))
            b = rnd((bt * groups, l, n), dtype, 0.5)
            c = rnd((bt * groups, l, n), dtype, 0.5)
            y, s = pss.ssd_scan(a, x, dt, b, c, q=q_, rep=h // groups,
                                device=dev)
            torch.cuda.synchronize()
            yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=q_,
                                        rep=h // groups)
            lm_err(y, yp, f"ssd y {dtype} {(bt, h, l, p, n, q_, groups)}")
            lm_err(s, sp, "ssd state", LM_TOL[str(dtype)[6:]])
            n_cases += 1
        for bits in (1, 4, 8):
            x = rnd((256, 128), dtype)
            w = rnd((128, 384), scale=0.1)
            planes, scales, _ = ref.quantize_weights(w, bits)
            got = pbp.bitplane_matmul(x, planes, scales, bits=bits,
                                      device=dev)
            torch.cuda.synchronize()
            lm_err(got, pbp.bitplane_matmul_plain(x, planes, scales,
                                                  bits=bits),
                   f"bitplane {dtype} bits {bits}")
            xm = rnd((3, 50, 128), dtype)           # ragged M, padded
            lm_err(ops.quantized_linear(xm, w, bits=bits, device=dev),
                   ref.bitplane_matmul_ref(xm.reshape(-1, 128), planes,
                                           scales, bits=bits
                                           ).reshape(3, 50, 384),
                   f"quantized_linear {dtype} bits {bits}")
            # ragged against the bfloat16 GEMM's 128 x 256 x 64 block tile
            x = rnd((384, 640), dtype)
            w = rnd((640, 384), scale=0.1)
            planes, scales, _ = ref.quantize_weights(w, bits)
            got = pbp.bitplane_matmul(x, planes, scales, bits=bits,
                                      device=dev)
            torch.cuda.synchronize()
            lm_err(got, pbp.bitplane_matmul_plain(x, planes, scales,
                                                  bits=bits),
                   f"bitplane {dtype} bits {bits} M 384 K 640 N 384")
            n_cases += 3
    for bits in range(1, 9):
        planes, _, w_q = ref.quantize_weights(rnd((640, 384), scale=0.1),
                                              bits)
        got = pbp.bitplane_repack(planes, bits=bits, device=dev)
        if not (torch.equal(got, pbp.bitplane_repack_plain(planes, bits=bits))
                and torch.equal(got.to(torch.int32), w_q)):
            raise AssertionError(f"bitplane repack bits {bits}: not W_q")
        n_cases += 1
    log(f"[lm kernels] {n_cases} small and ragged cases in float32 and "
        f"bfloat16 equal their plain versions within {LM_TOL} x max(1, "
        f"largest |output|)")

    # ---- the main path's shapes (the main serve's prefill), bfloat16
    from repro_torch.configs.registry import get_config
    from repro_torch.models.mamba import mamba_dims
    cfg = get_config("zamba2-7b")
    bf = torch.bfloat16
    heads, d = cfg.n_heads, cfg.resolved_head_dim
    bh, l, t = SERVE_BATCH * heads, SERVE_PROMPT, min(cfg.attn_chunk,
                                                     SERVE_PROMPT)
    q, k, v = (rnd((bh, l, d), bf) for _ in range(3))
    got = pfa.flash_attention(q, k, v, causal=True, tq=t, tk=t, device=dev)
    err = lm_err(got, pfa.flash_attention_plain(q, k, v, causal=True, tq=t,
                                                tk=t), "flash main shape")
    qs, ks, vs = q[None], k[None], v[None]
    record(rec, FLASH[0],
           timed(lambda: pfa.flash_attention(q, k, v, causal=True, tq=t,
                                             tk=t, device=dev), 50),
           timed(lambda: pfa.flash_attention_plain(q, k, v, causal=True,
                                                   tq=t, tk=t), 5),
           err, flash_bound(q, t, t, True),
           timed(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                        is_causal=True), 20),
           f"BH {bh} x L {l} x D {d} bfloat16, causal, tile {t}")
    del q, k, v, qs, ks, vs, got

    s_ = cfg.ssm
    _, n_heads = mamba_dims(cfg.d_model, s_)
    bh, p, n = SERVE_BATCH * n_heads, s_.head_dim, s_.d_state
    q_, rep = min(s_.chunk, l), n_heads // s_.n_groups
    x = rnd((bh, l, p), bf)
    dt = F.softplus(rnd((bh, l)))
    a = -torch.linspace(1.0, 16.0, n_heads, device=dev).repeat(SERVE_BATCH)
    b = rnd((SERVE_BATCH * s_.n_groups, l, n), bf)
    c = rnd((SERVE_BATCH * s_.n_groups, l, n), bf)
    pss.reset_counts()
    y, st = pss.ssd_scan(a, x, dt, b, c, q=q_, rep=rep, device=dev)
    if pss.ssd_scan.wgmma_launches != 1:
        raise AssertionError(f"ssd main shape: not an {SSD_WGMMA} launch")
    yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=q_, rep=rep)
    err = lm_err(y, yp, "ssd main shape")
    lm_err(st, sp, "ssd main shape state", LM_TOL["bfloat16"])
    runs = [timed(lambda: pss.ssd_scan(a, x, dt, b, c, q=q_, rep=rep,
                                       device=dev), 20) for _ in range(5)]
    record(rec, SSD[0], sorted(runs)[2],
           timed(lambda: pss.ssd_scan_plain(a, x, dt, b, c, q=q_, rep=rep),
                 5),
           err, ssd_bound(a, x, dt, b, c, q_), None,
           f"BH {bh} x L {l}, P {p}, N {n}, chunk {q_}, B/C per group "
           f"({rep} heads), bfloat16, {SSD_WGMMA}; median of runs "
           f"{', '.join(f'{r:.4f}' for r in runs)} (earlier kernel, "
           f"mma.sync: {EARLIER_SSD_MS} ms)")
    del x, y, yp, st, sp

    m, kk, nn = SERVE_BATCH * SERVE_PROMPT, cfg.d_model, cfg.d_ff
    x = rnd((m, kk), bf)
    w = rnd((kk, nn), scale=kk ** -0.5)
    for bits in (4, 8):
        planes, scales, w_q = ref.quantize_weights(w, bits)
        wd = (w_q.float() * scales).to(bf)          # dequantised
        got = pbp.bitplane_matmul(x, planes, scales, bits=bits, device=dev)
        err = lm_err(got, pbp.bitplane_matmul_plain(x, planes, scales,
                                                    bits=bits),
                     f"bitplane main shape bits {bits}")
        # the two phases alone: the repack, and the GEMM on its W_q
        wq_b = pbp.bitplane_repack(planes, bits=bits, device=dev)
        if not torch.equal(wq_b.to(torch.int32), w_q):
            raise AssertionError(f"bitplane repack main shape bits {bits}")
        repack_ms = timed(lambda: pbp.bitplane_repack(planes, bits=bits,
                                                      device=dev), 20)
        gemm_ms = timed(lambda: pbp.bitplane_gemm(x, wq_b, scales,
                                                  device=dev), 20)
        name = BITPLANE[0] if bits == 8 else f"{BITPLANE[0]}[bits 4]"
        record(rec, name,
               timed(lambda: pbp.bitplane_matmul(x, planes, scales,
                                                 bits=bits, device=dev), 20),
               timed(lambda: pbp.bitplane_matmul_plain(x, planes, scales,
                                                       bits=bits), 3),
               err, bitplane_bound(x, planes, scales, nn),
               timed(lambda: torch.matmul(x, wd), 20),
               f"x {m} x {kk} bfloat16 @ {kk} x {nn}, {bits} bits; repack "
               f"{repack_ms:.4f} ms, GEMM {gemm_ms:.4f} ms")
        del planes, w_q, wd, got, wq_b
    torch.cuda.empty_cache()


def greedy(model, params, tokens, cap, steps, forced=None):
    """Prefill and `steps` greedy decode steps: the tokens and every
    step's logits (float32, on the host). With `forced` (B, steps), step
    i is fed forced[:, i] in place of the previous step's argmax."""
    import torch
    v = model.cfg.vocab
    with torch.inference_mode():
        logits, cache = model.prefill_fn(params, {"tokens": tokens}, cap)
        out, steps_logits = [], [logits[:, 0, :v].float().cpu()]
        tok = torch.argmax(logits[..., :v], -1)
        for i in range(steps):
            if forced is not None:
                tok = forced[:, i:i + 1].to(tokens.device)
            out.append(tok.cpu())
            logits, cache = model.decode_fn(params, cache, tok,
                                            tokens.shape[1] + i)
            steps_logits.append(logits[:, 0, :v].float().cpu())
            tok = torch.argmax(logits[..., :v], -1)
        out.append(tok.cpu())
    return torch.cat(out, 1), steps_logits


def expected_launches(cfg):
    """(ssd_scan, flash_attention) launches of one prefill: one scan a
    Mamba2 layer, one attention a dense layer or shared-block
    invocation."""
    if cfg.family == "dense":
        return 0, cfg.n_layers
    if cfg.family == "ssm":
        return cfg.n_layers, 0
    return cfg.n_layers, cfg.n_layers // cfg.shared_attn_period


def small_serve(dev, arch, dtype, tag):
    """`arch`'s smoke config with the same parameters on the card (the
    kernels) and on the CPU (the plain versions): prefill and first
    decode logits within the stated tolerance (the card's first decode
    fed the CPU's first token: where the prefill's top two tie, the two
    argmaxes may differ), greedy tokens equal wherever the CPU's top-2
    margin exceeds twice it, one launch a layer and no plain call on the
    card, and `generate` equal to the greedy loop on both."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    rtol, atol = SMALL_SERVE_TOL[dtype]
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    model = build_model(cfg)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card = model.init_params(torch.Generator(device=dev).manual_seed(0),
                             dev)
    card.load_state_dict(cpu.state_dict())
    b, l, gen = 4, 64, 8
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, l)))
    pfa.reset_counts()
    pss.reset_counts()
    tc, lc = greedy(model, card, toks.to(dev), l + gen, gen - 1)
    counts = (pss.ssd_scan.launches, pfa.flash_attention.launches)
    plain = pss.ssd_scan.plain_calls + pfa.flash_attention.plain_calls
    tp_, lp = greedy(model, cpu, toks, l + gen, gen - 1)
    if counts != expected_launches(cfg) or plain:
        raise AssertionError(f"{tag} {arch} {dtype}: launches {counts}, "
                             f"{plain} plain calls on the card")
    check_wgmma_share(f"{tag} {arch} {dtype}", cfg, {
        FLASH[0]: counts[1],
        FLASH_WGMMA[0]: pfa.flash_attention.wgmma_launches})
    check_ssd_wgmma_share(f"{tag} {arch} {dtype}", cfg, counts[0])
    _, lf = greedy(model, card, toks.to(dev), l + gen, 1, forced=tp_)
    for i, what in ((0, "prefill"), (1, "first decode")):
        torch.testing.assert_close(
            lf[i], lp[i], rtol=rtol, atol=atol,
            msg=lambda m: f"{tag} {arch} {dtype} {what}: {m}")
    errs = [float((x - y).abs().max()) for x, y in zip(lc, lp)]
    forced_errs = [float((x - y).abs().max()) for x, y in zip(lf, lp)]
    compared = 0
    for i in range(gen):
        top2 = torch.topk(lp[i], 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        thresh = 2 * (atol + rtol * top2[:, 0].abs())
        sure = margin > thresh
        if not bool((tc[:, i] == tp_[:, i])[sure].all()):
            raise AssertionError(f"{tag} {arch} {dtype}: step {i} greedy "
                                 f"tokens differ where the CPU's margin "
                                 f"exceeds {thresh.tolist()}")
        compared += int(sure.sum())
        if not bool((tc[:, i] == tp_[:, i]).all()):
            break                   # contexts differ from here on
    for d_, params in ((dev, card), ("cpu", cpu)):
        got, _ = serve.generate(cfg, batch=b, prompt_len=l, gen=gen,
                                seed=1, params=params, device=d_,
                                log=lambda *a: None)
        want = (tc if d_ == dev else tp_).numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"{tag} {arch} {dtype}: generate on {d_} "
                                 f"differs from the greedy loop")
    log(f"[{tag}] {arch} {dtype} smoke config, {b} x {l} prompt, {gen} "
        f"tokens: card (kernels: {counts[0]} ssd_scan, {counts[1]} "
        f"flash_attention launches, 0 plain calls) vs CPU (plain): prefill "
        f"and first decode on the CPU's first token within rtol {rtol}, "
        f"atol {atol} (max |diff| {forced_errs[0]:.3g}, "
        f"{forced_errs[1]:.3g}); each free-running step's logits max |diff| "
        f"{', '.join(f'{e:.3g}' for e in errs)}; greedy tokens "
        f"equal at {compared} of {b * gen} positions whose CPU margin "
        f"clears twice the tolerance, {int((tc == tp_).sum())} of "
        f"{b * gen} equal in all; generate() gives the loop's tokens on "
        f"both")


# phase 14's card-against-CPU tolerances: float32 (the kernels sum in
# another order) and the reference's bfloat16 cross-path tolerance
SMALL_SERVE_TOL = {"float32": (1e-3, 1e-3), "bfloat16": (6e-2, 8e-2)}


def phase_small_serve(dev):
    """The Zamba2 smoke config in float32 and bfloat16 (`small_serve`)."""
    for dtype in SMALL_SERVE_TOL:
        small_serve(dev, "zamba2-7b", dtype, "small serve")


def device_time_by_layer(tag, rows):
    """Log the profiled device time of an LM serve or train step by
    layer; returns the rows that are kernels (not aten:: ops, which
    repeat their kernels' time)."""
    kernels = [r for r in rows if r.self_device_time_total > 0
               and not r.key.startswith("aten::")]
    groups = {"ssd_scan kernel": 0.0, "ssd_scan_bwd kernel": 0.0,
              "flash_attention kernel": 0.0,
              "flash_attention_bwd kernels": 0.0,
              "matrix products (cuBLAS)": 0.0, "copies and casts": 0.0,
              "other elementwise and reductions": 0.0}
    for r in kernels:
        k = r.key
        if "ssd_fwd" in k:
            g = "ssd_scan kernel"
        elif "ssd_bwd" in k:
            g = "ssd_scan_bwd kernel"
        elif "flash_fwd" in k:
            g = "flash_attention kernel"
        elif "flash_bwd" in k:
            g = "flash_attention_bwd kernels"
        elif "nvjet" in k or "gemm" in k.lower() or "cutlass" in k:
            g = "matrix products (cuBLAS)"
        elif "copy" in k or "emcpy" in k or "emset" in k:
            g = "copies and casts"
        else:
            g = "other elementwise and reductions"
        groups[g] += r.self_device_time_total / 1e3
    total = sum(groups.values())
    log(f"[{tag}] device time by layer: " + "; ".join(
        f"{g} {ms:.2f} ms ({ms / total:.3f})" for g, ms in groups.items()))
    return kernels


def phase_main_serve(dev, rec):
    """Zamba2-7B at full width and depth in bfloat16 through `generate`
    on the card: launch counts, rates and memory; the kernels against
    their plain versions on the tensors this prefill feeds them; the
    quantized path on its FFN input; and a profiled run."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import bitplane_matmul as pbp
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import serve
    from repro_torch.models import hybrid as HY
    from repro_torch.models import layers as L
    from repro_torch.models.model import (build_model, count_params,
                                           count_params_abstract)

    cfg = get_config("zamba2-7b")
    period, n_groups, n_tail = HY.split_counts(cfg)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"[main serve] Zamba2-7B ({cfg.n_layers} Mamba2 layers, "
        f"{n_groups} invocations of {cfg.n_shared_blocks} shared blocks, "
        f"d_model {cfg.d_model}, {cfg.dtype}): {n_params} parameters "
        f"({n_params / 1e9:.3f}e9) initialised on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    want = count_params_abstract(model)
    if n_params != want or abs(want - REF_SERVE_PARAMS) > 0.0005e9:
        raise AssertionError(f"{n_params} parameters, count_params_abstract "
                             f"{want}, the reference's {REF_SERVE_PARAMS:.4g}")

    # warm-up (the allocator's pool, cuBLAS's choices), not counted
    serve.generate(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=2,
                   params=params, device=dev, log=lambda *a: None)
    for mod in (pfa, pss, pbp):
        mod.reset_counts()
    toks, stats = serve.generate(cfg, batch=SERVE_BATCH,
                                 prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                                 params=params, device=dev, log=log)
    counts = {FLASH[0]: pfa.flash_attention.launches,
              SSD[0]: pss.ssd_scan.launches}
    plain = (pfa.flash_attention.plain_calls + pss.ssd_scan.plain_calls
             + pbp.bitplane_matmul.plain_calls)
    peak = torch.cuda.max_memory_allocated(dev)
    if counts != {FLASH[0]: n_groups, SSD[0]: cfg.n_layers} or plain:
        raise AssertionError(f"main serve launches {counts}, plain calls "
                             f"{plain}: expected {n_groups} flash_attention "
                             f"and {cfg.n_layers} ssd_scan per prefill")
    counts[FLASH_WGMMA[0]] = pfa.flash_attention.wgmma_launches
    check_wgmma_share("main serve", cfg, counts)
    check_ssd_wgmma_share("main serve", cfg, counts[SSD[0]])
    if toks.shape != (SERVE_BATCH, SERVE_GEN) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"main serve tokens {toks.shape}")
    n_dec = (SERVE_GEN - 1) * SERVE_BATCH
    log(f"[main serve] {SERVE_BATCH} requests x prompt {SERVE_PROMPT}, "
        f"{SERVE_GEN} tokens each: prefill {stats['prefill_s'] * 1e3:.1f} ms "
        f"= {SERVE_BATCH * SERVE_PROMPT / stats['prefill_s']:.1f} prefill "
        f"tokens/s; {SERVE_GEN - 1} decode steps {stats['decode_s']:.3f}s = "
        f"{n_dec / stats['decode_s']:.1f} decode tokens/s "
        f"({stats['decode_s'] / (SERVE_GEN - 1) * 1e3:.2f} ms a step); "
        f"launches per prefill: {counts[SSD[0]]} ssd_scan (all "
        f"{SSD_WGMMA}), {counts[FLASH[0]]} flash_attention, 0 plain calls; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes)")

    # the tensors this prefill feeds the kernels: the first Mamba layer's
    # scan and the first shared block's attention and FFN input, recorded
    # by wrapping the ops module's kernel entries and the FFN block for
    # one more prefill
    ffn, ffn_in = HY.ffn_block, []

    def ffn_keep(p, cfg_, h):
        if not ffn_in:
            ffn_in.append((L.rms_norm(h, p.ln2, cfg_.rms_eps), p.mlp["wi"]))
        return ffn(p, cfg_, h)

    HY.ffn_block = ffn_keep
    try:
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
        seen = capture_first_kernels(model, params, prompt,
                                     SERVE_PROMPT + SERVE_GEN)
    finally:
        HY.ffn_block = ffn
    (a, x, dt, b, c), kw, (y, s) = seen["ssd"]
    yp, sp = pss.ssd_scan_plain(a, x, dt, b, c, q=kw["q"], rep=kw["rep"])
    e_ssd = lm_err(y, yp, "main serve first Mamba layer")
    lm_err(s, sp, "main serve first Mamba layer state", LM_TOL["bfloat16"])
    ssd_ms = timed(lambda: pss.ssd_scan(a, x, dt, b, c, q=kw["q"],
                                        rep=kw["rep"], device=dev), 20)
    ssd_plain_ms = timed(lambda: pss.ssd_scan_plain(
        a, x, dt, b, c, q=kw["q"], rep=kw["rep"]), 3)
    log(f"[main serve] ssd_scan on the first Mamba layer's own tensors "
        f"({tuple(x.shape)}, chunk {kw['q']}, {kw['rep']} heads a group): "
        f"{SSD_WGMMA} {ssd_ms:.4f} ms (earlier kernel, mma.sync, at the "
        f"main shape: {EARLIER_SSD_MS} ms), plain {ssd_plain_ms:.3f} ms, "
        f"bound "
        f"{max(ssd_bound(a, x, dt, b, c, kw['q'])):.4f} ms")
    (q, k, v), kw, o = seen["flash"]
    op = pfa.flash_attention_plain(q, k, v, causal=kw["causal"],
                                   tq=kw["tq"], tk=kw["tk"])
    e_fa = lm_err(o, op, "main serve first shared block")
    log(f"[main serve] the first Mamba layer's scan ({tuple(x.shape)}) "
        f"and the first shared block's attention ({tuple(q.shape)}, tile "
        f"{kw['tk']}) equal their "
        f"plain versions on this prefill's tensors: max |diff| "
        f"{e_ssd:.3g} and {e_fa:.3g}")
    fa_ms = timed(lambda: pfa.flash_attention(
        q, k, v, causal=kw["causal"], tq=kw["tq"], tk=kw["tk"], device=dev),
        20)
    sdpa = sdpa_call(q, k, v, kw["causal"])[0]
    log(f"[main serve] flash_attention ({FLASH_WGMMA[0]}) on the first "
        f"shared block's own tensors: kernel {fa_ms:.4f} ms, SDPA "
        f"{timed(sdpa, 20):.4f} ms, bound "
        f"{max(flash_bound(q, kw['tq'], kw['tk'], kw['causal'])):.4f} ms")
    del seen, yp, sp, op

    # the quantized path (ops.quantized_linear, the bit-plane kernel's
    # entry point) on the first shared block's FFN input and its wi
    xf, wi = ffn_in.pop()
    xm = xf.reshape(-1, cfg.d_model)
    dense = (xm.float() @ wi.float())
    pbp.reset_counts()
    outs = {bits: ops.quantized_linear(xf, wi.float(), bits=bits,
                                       device=dev) for bits in (4, 8)}
    counts[BITPLANE[0]] = pbp.bitplane_matmul.launches
    if counts[BITPLANE[0]] != 2 or pbp.bitplane_matmul.plain_calls:
        raise AssertionError(f"quantized path: {counts[BITPLANE[0]]} "
                             f"launches")
    rel = {}
    for bits, out in outs.items():
        planes, scales, _ = ref.quantize_weights(wi.float(), bits)
        lm_err(out.reshape(-1, wi.shape[1]), pbp.bitplane_matmul_plain(
            xm, planes, scales, bits=bits), f"quantized FFN bits {bits}")
        rel[bits] = float((out.reshape(dense.shape).float() - dense).norm()
                          / dense.norm())
        del planes
    if not rel[8] < rel[4] < 0.5:
        raise AssertionError(f"quantization error by bits {rel}")
    log(f"[main serve] quantized path: the first shared block's FFN input "
        f"{tuple(xf.shape)} through ops.quantized_linear with its wi "
        f"{tuple(wi.shape)}: {counts[BITPLANE[0]]} bitplane_matmul launches "
        f"(bits 4 and 8), each equal to its plain version; relative error "
        f"against the bfloat16 weights' product {rel[4]:.4f} (4 bits), "
        f"{rel[8]:.5f} (8 bits)")
    del outs, dense, xf, xm
    torch.cuda.empty_cache()

    # profiled: the same requests with 8 generated tokens (prefill and 7
    # decode steps; reading the events of all 31 steps takes minutes),
    # device activity only
    t0 = time.perf_counter()
    run, wall, busy, rows = profiled(lambda: serve.generate(
        cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=PROFILE_GEN,
        params=params, device=dev, log=lambda *a: None), cpu=False)
    if busy is None:
        log("[main serve] the profiler saw no device activity: device busy "
            "share not measured")
    else:
        log(f"[main serve] under torch.profiler ({PROFILE_GEN} tokens): "
            f"{wall:.2f}s wall (prefill {run[1]['prefill_s']:.3f}s, "
            f"{PROFILE_GEN - 1} decode steps {run[1]['decode_s']:.3f}s "
            f"inside generate), device busy {busy:.3f}s = share "
            f"{busy / wall:.4f} of the wall; reading the trace took "
            f"{time.perf_counter() - t0 - wall:.1f}s")
        kernels = device_time_by_layer("main serve", rows)
        log_rows("main serve", kernels, 12)
    return counts


RESULT_FIELDS = ("n_instr", "n_two_stage", "halted", "out", "mix", "mems",
                 "regs", "pc", "mix_items", "n_cycles")


def same_results(what, want, got, fields=RESULT_FIELDS):
    """Every per-item field of two lists of FleetResults equal (a field
    absent from one must be absent from the other)."""
    import numpy as np
    for g, (a, b) in enumerate(zip(want, got)):
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                raise AssertionError(f"{what}: group {g} differs in {f}")


def counted_run(what, fn, refill_launches: bool,
                segment_launches: bool = True):
    """fn() with the fleet kernels' counts zeroed just before it and read
    just after: the segment kernel must have launched (none when the
    run's stepper is one of the plain baselines), no plain version run,
    and the refill kernel launched exactly when the resident loop ran."""
    from repro_torch.kernels import iss_stepper as st
    st.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    seg, ref = st.iss_segment_banked.launches, st.iss_refill.launches
    plain = st.iss_segment_banked.plain_calls + st.iss_refill.plain_calls
    if (seg > 0) != segment_launches or plain \
            or (ref > 0) != refill_launches:
        raise AssertionError(f"{what}: iss_segment_banked {seg}, "
                             f"iss_refill {ref} launches, {plain} plain "
                             f"calls")
    return out, wall, seg, ref


def on_cpu(fn):
    """fn() with torch on one thread (the plain path's small tensors)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def past_bound_plan():
    """TT, PT, CT and AD at 28,000 items each on SERV with FlexiLint-static
    budgets: n_items x max_steps passes 2^31 - 1 in every group, so the
    engine falls back to its host loop."""
    from repro_torch.fleet import FleetGroup, FleetPlan
    return FleetPlan(groups=tuple(
        FleetGroup(workload=k, core="SERV", n_items=28_000, seed=20 + i,
                   max_steps="static")
        for i, k in enumerate(("TT", "PT", "CT", "AD"))),
        chunk=16384, seg_steps=4096)


def phase_host_loop(dev, small_rep, main_rep):
    """Phase 16: the host-refill loop and the sequential plan on the card.
    (a) phase 4's plan through refill="host" and packed=False on the card,
    per item equal to phase 4's resident run; its MC and WQ groups the
    same on the card and the CPU. (b) phase 5's plan through
    refill="host": per item equal to phase 5, more host syncs. (c) a plan
    past the int32 mix bound, which falls back to the host loop: every
    item halted with the workload's reference output."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.fleet import run_plan
    from repro_torch.fleet.engine import workload_source
    small = three_group_plan(256)
    want = [g.result for g in small_rep.groups]
    for label, kw in (("refill=host", dict(refill="host")),
                      ("packed=False", dict(packed=False))):
        plan = dc.replace(small, **kw)
        # packed=False drains each group through the resident loop
        rep, wall, seg, _ = counted_run(
            f"small plan {label}",
            lambda: run_plan(plan, keep_state=True, device=dev),
            label == "packed=False")
        same_results(f"small plan {label} vs phase 4", want,
                     [g.result for g in rep.groups])
        two = dc.replace(plan, groups=plan.groups[:2])
        gpu = run_plan(two, keep_state=True, device=dev)
        t0 = time.perf_counter()
        cpu = on_cpu(lambda: run_plan(two, keep_state=True, device="cpu",
                                      power_w=0.0))
        t_cpu = time.perf_counter() - t0
        same_results(f"small plan {label} card vs CPU",
                     [g.result for g in gpu.groups],
                     [g.result for g in cpu.groups])
        if (gpu.packed is None) != (label == "packed=False"):
            raise AssertionError(f"small plan {label}: packed stats")
        log(f"[host loop] small plan {label}: 3 groups x 256 items on the "
            f"card in {wall:.2f}s ({seg} segment launches, no plain call), "
            f"every per-item field and the final state equal to phase 4's "
            f"resident run; MC and WQ on card and CPU ({t_cpu:.2f}s) bit "
            f"for bit")

    plan = dc.replace(main_plan(), refill="host")
    rep, wall, seg, _ = counted_run(
        "main plan refill=host", lambda: run_plan(plan, device=dev), False)
    p, q = rep.packed, main_rep.packed
    same_results("main plan refill=host vs phase 5",
                 [g.result for g in main_rep.groups],
                 [g.result for g in rep.groups])
    if p.refill != "host" or p.host_syncs <= q.host_syncs:
        raise AssertionError(f"main plan host loop: refill {p.refill}, "
                             f"{p.host_syncs} host syncs vs phase 5's "
                             f"{q.host_syncs}")
    log(f"[host loop] main plan refill=host: {rep.n_items} items in "
        f"{p.wall_s:.2f}s wall = {rep.n_items / p.wall_s:.1f} items/s "
        f"(phase 5's resident loop {q.wall_s:.2f}s, "
        f"{rep.n_items / q.wall_s:.1f}), {p.n_segments} segments, "
        f"{p.host_syncs} blocking host syncs (phase 5: {q.host_syncs}), "
        f"{p.sync_wait_s:.3f}s waited, harvest and rebuild "
        f"{p.refill_wall_s:.3f}s, engine busy estimate "
        f"{p.device_busy_frac:.4f}; {seg} segment launches, no plain "
        f"call; every per-item field equal to phase 5")

    plan = past_bound_plan()
    rep, wall, seg, _ = counted_run(
        "past the mix bound", lambda: run_plan(plan, device=dev), False)
    p = rep.packed
    if p.refill != "host":
        raise AssertionError(f"past the mix bound: refill {p.refill}")
    for g, grp in zip(rep.groups, plan.groups):
        r, w = g.result, g.workload
        if not r.halted.all():
            raise AssertionError(f"past the bound: {w.key}: "
                                 f"{int((~r.halted).sum())} items never "
                                 f"halted")
        n_chk = 1024 if w.key == "TT" else r.n_items
        mems = workload_source(w, grp.seed)(0, n_chk)
        ref = np.asarray(w.ref(mems[:, :w.n_inputs]), np.int32)
        bad = int((r.out[:n_chk] != ref).sum())
        if bad:
            raise AssertionError(f"past the bound: {w.key}: {bad} of "
                                 f"{n_chk} outputs differ")
    log(f"[host loop] past the mix bound (TT, PT, CT, AD x 28,000 on SERV, "
        f"static budgets): refill={p.refill}, {rep.n_items} items halted "
        f"in {p.wall_s:.2f}s wall = {rep.n_items / p.wall_s:.1f} items/s, "
        f"{p.n_segments} segments, {p.host_syncs} host syncs, {seg} "
        f"segment launches, no plain call; every output equal to the "
        f"workload's reference (TT on its first 1,024)")


def phase_checkpoint(dev, main_rep):
    """Phase 17: durable resident streams. Phase 5's plan checkpointed
    every 8 segments, crashed after 20 and resumed: per-item results and
    the schedule equal to phase 5's, each save's write time and bytes,
    the resumed wall. Then a small stream crashed on the card resumes on
    the CPU, and the other way round."""
    import _torch_parity as tp
    from repro_torch.distributed import checkpoint as dckpt
    from repro_torch.fleet import InjectedFault, engine, run_plan
    from repro_torch.fleet.plan import _packed_groups
    cdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(cdir, ignore_errors=True)
    writes, reads = [], []
    save, restore = dckpt.save, dckpt.restore

    def timed_save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        path = save(ckpt_dir, step, tree, **kw)
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        writes.append((step, time.perf_counter() - t0, nbytes))
        return path

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        out = restore(*a, **kw)
        reads.append((out[1], time.perf_counter() - t0))
        return out

    dckpt.save, dckpt.restore = timed_save, timed_restore
    try:
        plan = main_plan()
        lowered, _ = _packed_groups(plan)

        def crash():
            try:
                engine.run_packed(
                    lowered, chunk=plan.chunk, seg_steps=plan.seg_steps,
                    prefetch=plan.prefetch, adaptive=plan.adaptive,
                    checkpoint_dir=cdir, checkpoint_every=8,
                    _crash_after_segments=20, device=dev)
            except InjectedFault:
                return
            raise AssertionError("the checkpointed main plan did not crash")
        _, crash_wall, _, _ = counted_run("checkpointed crash", crash, True)
        if sorted(dckpt.all_steps(cdir)) != [8, 16]:
            raise AssertionError(f"checkpoints {dckpt.all_steps(cdir)}")
        rep, wall, seg, ref = counted_run(
            "resume", lambda: run_plan(plan, checkpoint_dir=cdir,
                                       checkpoint_every=8, device=dev),
            True)
    finally:
        dckpt.save, dckpt.restore = save, restore
    p, q = rep.packed, main_rep.packed
    same_results("resumed main plan vs phase 5",
                 [g.result for g in main_rep.groups],
                 [g.result for g in rep.groups])
    # lane_steps may differ: a resume stages the unconsumed items again,
    # so lanes can take other items than in the uninterrupted run
    for f in ("n_segments", "seg_schedule"):
        if getattr(p, f) != getattr(q, f):
            raise AssertionError(f"resumed main plan: {f} differs")
    for step, secs, nbytes in writes:
        log(f"[checkpoint] main plan save at segment {step}: write "
            f"{secs * 1e3:.1f} ms (serialise, CRC32, rename), {nbytes} "
            f"bytes on disk")
    for step, secs in reads:
        log(f"[checkpoint] restore of segment {step}: {secs * 1e3:.1f} ms "
            f"(read and CRC32-verify)")
    log(f"[checkpoint] main plan crashed after 20 segments in "
        f"{crash_wall:.2f}s (checkpoints at 8 and 16), resumed in "
        f"{wall:.2f}s ({p.wall_s:.2f}s in run_packed; phase 5's whole run "
        f"{q.wall_s:.2f}s): {p.n_segments} segments, {seg} segment and "
        f"{ref} refill launches in the resumed run, no plain call; every "
        f"per-item field, n_segments and the schedule equal to phase 5's "
        f"({p.lane_steps} lane-step slots, phase 5 {q.lane_steps})")

    kw = dict(chunk=16, seg_steps=64, keep_state=True)

    def groups():
        return tp.skew_groups(engine, max_steps_b=100_000)
    gold, gs = engine.run_packed(groups(), device=dev, **kw)
    for crash_dev, resume_dev in ((dev, "cpu"), ("cpu", dev)):
        d = os.path.join(cdir, f"small_{crash_dev}")
        try:
            on_cpu(lambda: engine.run_packed(
                groups(), checkpoint_dir=d, checkpoint_every=4,
                _crash_after_segments=10, device=crash_dev, **kw))
            raise AssertionError("the small stream did not crash")
        except InjectedFault:
            pass
        res, rs = on_cpu(lambda: engine.run_packed(
            groups(), checkpoint_dir=d, checkpoint_every=4,
            device=resume_dev, **kw))
        same_results(f"small stream crashed on {crash_dev}, resumed on "
                     f"{resume_dev}", gold, res)
        if (rs.n_segments, rs.seg_schedule) != (gs.n_segments,
                                                gs.seg_schedule):
            raise AssertionError("small stream: schedule differs")
        log(f"[checkpoint] small stream (64 items) crashed on {crash_dev} "
            f"at segment 10, resumed on {resume_dev} from its segment-8 "
            f"checkpoint: every per-item field, the final state and "
            f"{rs.n_segments} segments equal to the card's uninterrupted "
            f"run")
    shutil.rmtree(cdir, ignore_errors=True)


def launch_times(fn):
    """fn() with every `iss_segment_banked` launch bracketed by CUDA
    events on its stream: (fn's result, the device ms of each launch).
    The wrapper itself still counts the launches: it adds to the counts
    of whatever its module's name holds, so the shim carries them and
    hands them back."""
    import torch
    from repro_torch.kernels import iss_stepper as st
    real, evs = st.iss_segment_banked, []
    counts = ("launches", "fault_launches", "plain_calls")

    def shim(*a, **kw):
        s = torch.cuda.current_stream(kw.get("device"))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(s)
        out = real(*a, **kw)
        e1.record(s)
        evs.append((e0, e1))
        return out
    for k in counts:
        setattr(shim, k, getattr(real, k))
    st.iss_segment_banked = shim
    try:
        out = fn()
    finally:
        st.iss_segment_banked = real
        for k in counts:
            setattr(real, k, getattr(shim, k))
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in evs]


SHARD_STATS = ("lane_steps", "n_segments", "seg_schedule", "shard_retired",
               "shard_lane_steps", "host_syncs")
ARCH_FIELDS = ("n_instr", "halted", "out", "mems", "regs", "pc")


def phase_shards(dev, small_rep, main_rep, cpu_runs):
    """Phase 18: shard-local streaming (`mesh=`) and the reference's
    baseline steppers on the card. (a) phase 4's plan at 2 and 4 logical
    shards: per item equal to phase 4, the 4-shard schedule equal to the
    CPU's at 4 shards, one host sync a segment; (b) phase 5's plan at 4
    shards: per item equal to phase 5, its wall, syncs and segment
    launches beside a one-shard rerun; (c) phase 5's plan checkpointed at
    4 shards, crashed and resumed at one; (d) MC and WQ through the
    "branchless" and "switch" steppers, and `run_fleet_sharded`; (e)
    phase 11's DMR plan at 2 shards equal to the fault-free run."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.flexibench.base import get
    from repro_torch.flexibits import fleet as pfleet
    from repro_torch.flexibits import iss
    from repro_torch.flexibits.faults import FaultSpec
    from repro_torch.fleet import InjectedFault, engine, run_plan
    from repro_torch.fleet.plan import _packed_groups
    from repro_torch.kernels import iss_stepper as st

    def cuda(n):
        return [dev] * n

    # ---- (a) shards, small plan
    small = three_group_plan(256)
    q = small_rep.packed
    reps = {}
    for n in (2, 4):
        rep, wall, seg, ref = counted_run(
            f"small plan at {n} shards",
            lambda: run_plan(small, keep_state=True, mesh=cuda(n)), True)
        same_results(f"small plan at {n} shards vs phase 4",
                     [g.result for g in small_rep.groups],
                     [g.result for g in rep.groups])
        p = rep.packed
        if (p.n_shards, p.n_devices) != (n, 1) \
                or p.host_syncs - p.n_segments != q.host_syncs - q.n_segments:
            raise AssertionError(f"small plan at {n} shards: {p.n_shards} "
                                 f"shards on {p.n_devices} devices, "
                                 f"{p.host_syncs} syncs in {p.n_segments} "
                                 f"segments (phase 4: {q.host_syncs} in "
                                 f"{q.n_segments})")
        reps[n] = rep
        log(f"[shards] small plan at {n} logical shards: {wall:.2f}s, "
            f"{p.n_segments} segments (phase 4: {q.n_segments}), "
            f"{p.host_syncs} host syncs (phase 4: {q.host_syncs}), "
            f"retired/shard {list(p.shard_retired)}, {seg} segment and "
            f"{ref} refill launches, no plain call; every per-item field "
            f"and the final state equal to phase 4's")
    cpu, t_cpu = cpu_runs["small at 4 shards"].result()
    same_results("small plan at 4 shards, card vs CPU",
                 [g.result for g in cpu.groups],
                 [g.result for g in reps[4].groups])
    for f in SHARD_STATS:
        if getattr(reps[4].packed, f) != getattr(cpu.packed, f):
            raise AssertionError(f"small plan at 4 shards: {f} differs "
                                 f"between card and CPU")
    log(f"[shards] small plan at 4 shards on the CPU ({t_cpu:.2f}s, a "
        f"worker process): "
        f"lane_steps, n_segments, seg_schedule, shard_retired, "
        f"shard_lane_steps and host syncs equal to the card's")

    # ---- (b) shards, main plan
    plan = main_plan()
    (rep4, ms4), _, seg4, ref4 = counted_run(
        "main plan at 4 shards",
        lambda: launch_times(lambda: run_plan(plan, mesh=cuda(4))), True)
    same_results("main plan at 4 shards vs phase 5",
                 [g.result for g in main_rep.groups],
                 [g.result for g in rep4.groups])
    (rep1, ms1), _, seg1, _ = counted_run(
        "main plan at one shard",
        lambda: launch_times(lambda: run_plan(plan, device=dev)), True)
    p4, p1, q5 = rep4.packed, rep1.packed, main_rep.packed
    if p4.host_syncs - p4.n_segments != q5.host_syncs - q5.n_segments:
        raise AssertionError(f"main plan at 4 shards: {p4.host_syncs} "
                             f"syncs in {p4.n_segments} segments")
    log(f"[shards] main plan at 4 logical shards: {rep4.n_items} items in "
        f"{p4.wall_s:.2f}s = {rep4.n_items / p4.wall_s:.1f} items/s "
        f"(phase 5: {q5.wall_s:.2f}s; one-shard rerun {p1.wall_s:.2f}s = "
        f"{rep1.n_items / p1.wall_s:.1f} items/s), {p4.n_segments} segments "
        f"(phase 5: {q5.n_segments}), {p4.host_syncs} host syncs (phase 5: "
        f"{q5.host_syncs}), retired/shard {list(p4.shard_retired)}, "
        f"restock {p4.refill_wall_s:.3f}s (rerun {p1.refill_wall_s:.3f}s); "
        f"iss_segment_banked {seg4} launches, {np.mean(ms4):.4f} ms a "
        f"launch (one-shard rerun {seg1}, {np.mean(ms1):.4f}; CUDA events), "
        f"iss_refill {ref4} launches; every per-item field equal to "
        f"phase 5's")

    # ---- (c) elastic resume: checkpointed at 4 shards, resumed at one
    cdir = os.path.join(ROOT, "build", "chip_smoke_ckpt_shards")
    shutil.rmtree(cdir, ignore_errors=True)
    lowered, _ = _packed_groups(plan)

    def crash():
        try:
            engine.run_packed(
                lowered, chunk=plan.chunk, seg_steps=plan.seg_steps,
                prefetch=plan.prefetch, adaptive=plan.adaptive,
                checkpoint_dir=cdir, checkpoint_every=8,
                _crash_after_segments=20, mesh=cuda(4))
        except InjectedFault:
            return
        raise AssertionError("the checkpointed 4-shard plan did not crash")
    try:
        _, crash_wall, _, _ = counted_run("crash at 4 shards", crash, True)
        rep, wall, seg, ref = counted_run(
            "resume at one shard",
            lambda: run_plan(plan, checkpoint_dir=cdir, checkpoint_every=8,
                             device=dev), True)
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
    same_results("main plan resumed at one shard vs phase 5",
                 [g.result for g in main_rep.groups],
                 [g.result for g in rep.groups])
    log(f"[shards] main plan checkpointed every 8 segments at 4 shards, "
        f"crashed after 20 ({crash_wall:.2f}s), resumed at one shard in "
        f"{wall:.2f}s ({rep.packed.wall_s:.2f}s in run_packed, "
        f"{rep.packed.n_segments} segments, {seg} segment and {ref} refill "
        f"launches): every per-item field equal to phase 5's")

    # ---- (d) the reference's baseline steppers on the card
    two = dc.replace(small, groups=small.groups[:2])
    kern, kwall, _, _ = counted_run(
        "MC and WQ, kernel route",
        lambda: run_plan(two, keep_state=True, device=dev), True)
    for stepper in ("branchless", "switch"):
        plan_s = dc.replace(two, stepper=stepper)
        rep, wall, _, ref = counted_run(
            f"MC and WQ, {stepper}",
            lambda: run_plan(plan_s, keep_state=True, device=dev), True,
            segment_launches=False)
        t0 = time.perf_counter()
        cpu = on_cpu(lambda: run_plan(plan_s, keep_state=True, device="cpu",
                                      power_w=0.0))
        t_cpu = time.perf_counter() - t0
        same_results(f"{stepper} vs the kernel route",
                     [g.result for g in kern.groups],
                     [g.result for g in rep.groups])
        same_results(f"{stepper} card vs CPU",
                     [g.result for g in cpu.groups],
                     [g.result for g in rep.groups])
        if rep.packed.stepper != stepper:
            raise AssertionError(f"{stepper}: stats say "
                                 f"{rep.packed.stepper}")
        log(f"[shards] MC and WQ (2 x 256 items) through stepper="
            f"{stepper!r} on the card: {wall:.2f}s (kernel route "
            f"{kwall:.2f}s; CPU {t_cpu:.2f}s), no segment kernel launch, "
            f"{ref} refill launches; every per-item field and the final "
            f"state equal to the kernel route's and the CPU's")
    w = get("MC")
    mems = pfleet.fleet_inputs(w, 256, seed=7)
    t0 = time.perf_counter()
    got = pfleet.run_fleet_sharded(w, mems, cuda(2))
    t_sh = time.perf_counter() - t0
    code = torch.from_numpy(w.program.code.view(np.int32)).to(dev)
    t0 = time.perf_counter()
    want = iss.run_fleet(code, torch.from_numpy(mems).to(dev), w.max_steps)
    t_rf = time.perf_counter() - t0
    for f in iss.ISSState._fields:
        if not torch.equal(getattr(want, f), getattr(got, f)):
            raise AssertionError(f"run_fleet_sharded differs in {f}")
    log(f"[shards] run_fleet_sharded, 256 MC items at 2 shards "
        f"({t_sh:.2f}s) equal to iss.run_fleet on the card ({t_rf:.2f}s), "
        f"every field")

    # ---- (e) DMR under shards
    gold = run_plan(small_resilient_plan(), keep_state=True, device=dev)
    spec = FaultSpec(rate=1e-4, seed=5, targets=("regs", "mem", "pc"))
    st.reset_counts()
    t0 = time.perf_counter()
    rep = run_plan(small_resilient_plan(faults=spec, redundancy="dmr",
                                        max_retries=6),
                   keep_state=True, mesh=cuda(2))
    wall = time.perf_counter() - t0
    fl, rl = st.iss_segment_banked.fault_launches, st.iss_refill.launches
    plain = st.iss_segment_banked.plain_calls + st.iss_refill.plain_calls
    if fl <= 0 or rl <= 0 or plain:
        raise AssertionError(f"DMR at 2 shards: {fl} faults-variant and "
                             f"{rl} refill launches, {plain} plain calls")
    same_results("phase 11's DMR plan at 2 shards vs fault-free",
                 [g.result for g in gold.groups],
                 [g.result for g in rep.groups], ARCH_FIELDS)
    p = rep.packed
    if p.detected == 0 or p.n_shards != 2:
        raise AssertionError(f"DMR at 2 shards: detected {p.detected}")
    log(f"[shards] phase 11's DMR plan at 2 shards: {wall:.2f}s, detected/"
        f"corrected/quarantined {p.detected}/{p.corrected}/"
        f"{p.quarantined}, {fl} faults-variant and {rl} refill launches; "
        f"every item's architectural result equal to the fault-free run")


# ------------------------------------------------------------- phase 19
# Fig. 6 (benchmarks/spoilage.py): 4,000 held-out inputs from
# default_rng(99), the profile input from default_rng(3), each variant
# priced over a 1-year deployment at one execution an hour
FIG6_N, FIG6_SEED, FIG6_PROFILE_SEED = 4000, 99, 3
FIG6_LIFETIME_S, FIG6_EXECS_PER_DAY = 365 * 86_400.0, 24.0
FIG6_SEG_STEPS = 1 << 16
PAPER_KNN_LR_RATIO = 14.5       # the paper's KNN-Large / LR carbon
# the serving planner's chip in phase 19: an H100 SXM at the card's power
# limit; its embodied carbon is a what-if input (the repo has no
# life-cycle figure for an H100)
WHAT_IF_EMBODIED_KG = 1500.0


def phase_spoilage(dev, smi):
    """19(a): the six Fig. 6 variants on the 4,000 held-out inputs (and
    the profile input as lane 4,000) through `iss_segment` on the card,
    segment after segment until every lane halts: every output equal to
    the variant's reference function, the profile lane's counts equal to
    PyISS, and each variant priced at its carbon-optimal core. Returns
    the segment kernel's launches."""
    import numpy as np
    import torch
    import _torch_parity as tp
    from repro_torch.core.carbon import DeviceProfile
    from repro_torch.core.selection import optimal_core
    from repro_torch.flexibench import spoilage_algos as sa
    from repro_torch.flexibits import iss
    from repro_torch.flexibits.pyiss import PyISS
    from repro_torch.kernels import iss_stepper as st

    xte, yte = sa.gen_dataset(np.random.default_rng(FIG6_SEED), FIG6_N)
    xp, _ = sa.gen_dataset(np.random.default_rng(FIG6_PROFILE_SEED), 1)
    x = np.concatenate([xte, xp])
    launches, rows = 0, {}
    for algo in sa.all_algos():
        mems = tp.spoilage_memory(algo, x)
        code = torch.as_tensor(np.asarray(algo.program.code).view(np.int32),
                               device=dev)
        state = iss.fresh_lanes(torch.as_tensor(mems, device=dev))
        st.reset_counts()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        while True:
            state = st.iss_segment(code, state, seg_steps=FIG6_SEG_STEPS,
                                   max_steps=algo.max_steps, device=dev)
            if bool((state.halted | (state.n_instr >= algo.max_steps))
                    .all()):
                break
        e1.record()
        e1.synchronize()
        wall = time.perf_counter() - t0
        dev_ms = e0.elapsed_time(e1)
        n = st.iss_segment_banked.launches
        if n < 1 or st.iss_segment_banked.plain_calls:
            raise AssertionError(f"{algo.name}: {n} segment launches, "
                                 f"{st.iss_segment_banked.plain_calls} "
                                 f"plain calls")
        launches += n
        if not bool(state.halted.all()):
            raise AssertionError(f"{algo.name}: "
                                 f"{int((~state.halted).sum())} lanes never "
                                 f"halted within {algo.max_steps} steps")
        out = state.mem[:, algo.out_addr].cpu().numpy()
        n_instr = state.n_instr.cpu().numpy().astype(np.int64)
        n_two = state.n_two_stage.cpu().numpy()
        want = algo.ref(xte)
        bad = int((out[:FIG6_N] != want).sum())
        if bad or out[FIG6_N] != algo.ref(xp)[0]:
            raise AssertionError(f"{algo.name}: {bad} of {FIG6_N} outputs "
                                 f"differ from the reference function")
        acc = float((out[:FIG6_N] == yte).mean())
        ref_acc = float((want == yte).mean())
        if acc != ref_acc:
            raise AssertionError(f"{algo.name}: accuracy {acc} != {ref_acc}")
        sim = PyISS(algo.program.code, mems.shape[1],
                    mems[FIG6_N].copy()).run(algo.max_steps)
        got = (int(n_instr[FIG6_N]), int(n_two[FIG6_N]))
        if not sim.halted or got != (sim.n_instr, sim.n_two_stage):
            raise AssertionError(f"{algo.name}: profile counts {got} on "
                                 f"the card, PyISS {sim.n_instr}, "
                                 f"{sim.n_two_stage}")

        def price(n1, n2):
            prof = DeviceProfile(n1 - n2, n2, algo.vm_reserved_bytes / 1024.0,
                                 algo.program.nvm_bytes / 1024.0)
            core, totals = optimal_core(prof, lifetime_s=FIG6_LIFETIME_S,
                                        execs_per_day=FIG6_EXECS_PER_DAY)
            return float(min(totals.values())), core.name
        kg, core = price(*got)
        if (kg, core) != price(sim.n_instr, sim.n_two_stage):
            raise AssertionError(f"{algo.name}: carbon differs")
        lane_steps = int(n_instr.sum())
        rows[algo.name] = (acc, kg, core)
        log(f"[fig6] {algo.name}: {mems.shape[0]} lanes x {mems.shape[1]} "
            f"words ({mems.nbytes / 1e6:.1f} MB), {n} launches of "
            f"{FIG6_SEG_STEPS} steps, {wall:.3f}s wall ({dev_ms:.1f} ms "
            f"between CUDA events), {lane_steps} retired lane-steps = "
            f"{lane_steps / wall:.4g} lane-steps/s; every output equal to "
            f"the reference function; accuracy {acc:.4f}; profile input "
            f"{got[0]} instructions, {got[1]} two-stage (PyISS equal); "
            f"{kg:.6g} kg CO2e on {core} over 1 year hourly ({smi})")
    ratio = rows["KNN-Large"][1] / rows["LR"][1]
    log(f"[fig6] KNN-Large / LR carbon {ratio:.4f}x (paper "
        f"{PAPER_KNN_LR_RATIO}x) at accuracy {rows['KNN-Large'][0]:.4f} vs "
        f"{rows['LR'][0]:.4f}; all {6 * FIG6_N} held-out outputs equal to "
        f"the reference functions")
    return launches


def run_example(name, argv):
    """examples/<name>.py's main(argv) in this process with every
    kernel's counts zeroed just before it: (its result, wall seconds,
    launches by kernel). No plain version may run."""
    import _torch_parity as tp
    from repro_torch.kernels import carbon_sweep as cs
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import iss_stepper as st
    from repro_torch.kernels import ssd_scan as pss
    mod = tp.load_example(name)
    for m in (st, cs, pfa, pss):
        m.reset_counts()
    t0 = time.perf_counter()
    out = mod.main(argv)
    wall = time.perf_counter() - t0
    fns = {SEG[0]: st.iss_segment_banked, REF[0]: st.iss_refill,
           SWEEP[0]: cs.sweep_tile, SWEEP_DRAWN[0]: cs.sweep_tile_drawn,
           FLASH[0]: pfa.flash_attention, SSD[0]: pss.ssd_scan}
    plain = {k: f.plain_calls for k, f in fns.items() if f.plain_calls}
    if pfa.flash_attention.bwd_plain_calls:
        plain[FLASH_BWD[0]] = pfa.flash_attention.bwd_plain_calls
    if plain:
        raise AssertionError(f"{name} {argv}: plain calls {plain}")
    launches = {k: f.launches for k, f in fns.items()}
    launches[FLASH_BWD[0]] = pfa.flash_attention.bwd_launches
    launches[FLASH_WGMMA[0]] = pfa.flash_attention.wgmma_launches
    return out, wall, launches


def phase_examples(dev):
    """19(b): the three examples through main(argv) on the card, at their
    defaults (the fleet example also at 8,192 items a group, the planner
    with --serving). Returns their launches by kernel."""
    import numpy as np
    from repro_torch.fleet.engine import workload_source
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    rc, wall, n = run_example("torch_quickstart", [])
    if rc != 0:
        raise AssertionError(f"torch_quickstart returned {rc}")
    add(n)
    log(f"[examples] torch_quickstart: {wall:.2f}s, launches {n}")
    for argv in ([], ["--items", "8192"]):
        rep, wall, n = run_example("torch_fleet_simulation", argv)
        if min(n[SEG[0]], n[REF[0]]) < 1:
            raise AssertionError(f"fleet example {argv}: launches {n}")
        for g in rep.groups:
            r, w = g.result, g.workload
            mems = workload_source(w, g.group.seed)(0, r.n_items)
            want = np.asarray(w.ref(mems[:, :w.n_inputs]), np.int32)
            if not r.halted.all() or (r.out != want).any():
                raise AssertionError(f"fleet example {argv}: {w.key} "
                                     f"outputs differ from the reference")
        add(n)
        log(f"[examples] torch_fleet_simulation {argv}: {rep.n_items} "
            f"items in {wall:.2f}s ({rep.packed.wall_s:.2f}s in "
            f"run_packed = {rep.n_items / rep.packed.wall_s:.1f} items/s), "
            f"{rep.packed.n_segments} segments, every output equal to the "
            f"workload's reference; launches {n}")
    (res, ok), wall, n = run_example(
        "torch_carbon_planner",
        ["--serving", "--embodied-kg", str(WHAT_IF_EMBODIED_KG)])
    if n[SWEEP_DRAWN[0]] < 1 or ok is not True or res.path != "cuda":
        raise AssertionError(f"planner example: launches {n}, serving "
                             f"{ok}, path {res.path}")
    add(n)
    log(f"[examples] torch_carbon_planner --serving: {wall:.2f}s, "
        f"{res.n_scenarios} scenarios in {res.wall_s * 1e3:.1f} ms, "
        f"serving planner equal to plan_grid; launches {n}")
    return total


def serving_grids():
    """The example's grid (8e9 parameters, 3 lifetimes x 9 QPS) and a
    dense one: 365 lifetimes x 1,000 QPS (inf, NaN and 0 among them,
    and demands past every option) x 18 options, two of them tied."""
    import numpy as np
    kv = 32 * 8 * 128 * 2 * 2
    example = dict(n_params=8e9, kv_bytes_per_token=kv,
                   lifetimes_days=np.array([7.0, 90.0, 3 * 365.0]),
                   qps_grid=np.logspace(2, 6, 9))
    dense = dict(n_params=8e9, kv_bytes_per_token=kv,
                 lifetimes_days=np.arange(1.0, 366.0),
                 qps_grid=np.concatenate([np.logspace(0, 8, 997),
                                          [0.0, np.inf, np.nan]]),
                 chips_options=(8, 16, 32, 32, 64, 256))
    return {"example": example, "dense": dense}


def phase_serving_plan(dev, smi):
    """19(c): the float64 serving planner on the card bit for bit against
    the numpy `plan_grid`, on the example's grid and a dense one."""
    import numpy as np
    import torch
    from repro_torch.core import planner
    from repro_torch.core import sweep as sw
    chip = planner.h100_sxm(WHAT_IF_EMBODIED_KG)
    for name, kw in serving_grids().items():
        t0 = time.perf_counter()
        want = planner.plan_grid(chip=chip, **kw)
        np_s = time.perf_counter() - t0
        sw.serving_plan(chip=chip, device=dev, **kw)      # warm-up
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        got = sw.serving_plan(chip=chip, device=dev, **kw)
        e1.record()
        e1.synchronize()
        wall = time.perf_counter() - t0
        for k in ("variant_idx", "chips", "total_kg"):
            g = got[k].cpu().numpy()
            if g.dtype != want[k].dtype or g.shape != want[k].shape or \
                    g.tobytes() != want[k].tobytes():
                raise AssertionError(f"serving plan {name}: {k} differs "
                                     f"from plan_grid")
        vi = want["variant_idx"]
        cells = vi.size * len(want["variants"]) * len(
            kw.get("chips_options", (8, 16, 32, 64, 128, 256)))
        log(f"[serving plan] {name} grid {vi.shape} x "
            f"{cells // vi.size} options ({cells} cells): variant_idx, "
            f"chips and total_kg bit for bit equal to plan_grid "
            f"({int((vi < 0).sum())} infeasible cells, "
            f"{int(np.isinf(want['total_kg']).sum())} +inf); on the card "
            f"{e0.elapsed_time(e1):.3f} ms between CUDA events, "
            f"{wall * 1e3:.3f} ms wall; numpy {np_s * 1e3:.1f} ms "
            f"({chip.hbm_bw:.3g} B/s, {chip.power_w:g} W, "
            f"{chip.embodied_kg:g} kg what-if; {smi})")


def phase_tables():
    """19(d): Table 5 against the paper's inputs, recomputed here, and
    the FlexiLint CLI over all 11 workloads."""
    from repro_torch.core import scale
    beef_kg = 26.19e9 * (1 / 2.20462)
    want = {}
    for name, fp in (("flexible", 0.01086), ("hybrid", 0.12829),
                     ("silicon", 2.66)):
        def kg(e, fp=fp):
            return e * 0.31 * beef_kg * 14.5 - beef_kg * fp
        es = (1.0, 0.1, 0.01, 0.001)
        want[name] = {"device_kg": fp,
                      "savings_kg": {e: kg(e) for e in es},
                      "savings_cars": {e: kg(e) / 4_600.0 for e in es},
                      "breakeven": fp / (0.31 * 14.5)}
    got = scale.table5()
    if got != want:
        raise AssertionError(f"Table 5 differs: {got} != {want}")
    log("[table5] " + "; ".join(
        f"{k}: break-even 1 in {1 / v['breakeven']:.0f}, "
        f"{v['savings_cars'][1.0]:.4g} cars at full effectiveness"
        for k, v in got.items()) + "; equal to the paper's inputs")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.tools.flexilint"],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ""
    if proc.returncode != 0 or last != "flexilint: 11 program(s) " \
                                       "analyzed, ok":
        raise AssertionError(f"flexilint exit {proc.returncode}: {last!r} "
                             f"{proc.stderr[-2000:]}")
    log(f"[flexilint] python -m repro_torch.tools.flexilint: exit 0, "
        f"{last!r}")


# ------------------------------------------------------------- phase 20
# the dense and SSM serves at full width and depth, cut as the main serve
# (phase 15): 8 requests, prompt 512, 32 generated tokens, greedy,
# bfloat16 parameters from a seed. Parameter counts: the reference's
# count_params_abstract of each config
FULL_PARAMS = {"qwen2.5-14b": 14_770_033_664, "mamba2-1.3b": 1_344_052_224,
               "qwen2-1.5b": 1_543_910_912, "minitron-8b": 9_882_046_464}
# (arch, profiled): Qwen2.5-14B and Mamba2-1.3B are also profiled
FULL_SERVES = (("qwen2.5-14b", True), ("mamba2-1.3b", True),
               ("qwen2-1.5b", False), ("minitron-8b", False))
# a profiled serve: the prefill and 8 decode steps
FULL_PROFILE_GEN = 9
# the bfloat16 cache path's relative error against the float32 forward,
# at most this times the bfloat16 forward's own
CACHE_DRIFT = 1.25


def capture_first_kernels(model, params, prompt, cap):
    """{"flash" | "ssd" | "experts": (args, kwargs, result)} of the first
    flash_attention and ssd_scan call, and the first MoE layer's expert
    products, of one more prefill of `prompt` (tokens, or a batch dict
    with patches or frames), recorded by wrapping the ops module's
    kernel entries and `models/moe.py::experts`."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    seen = {}

    def keep(name, fn, result=True):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if name not in seen:
                seen[name] = ([a.clone() if torch.is_tensor(a) else a
                               for a in args], dict(kw),
                              out if result else None)
            return out
        return wrapped

    saved = (ops.ssd_scan, ops.flash_attention, moe.experts)
    ops.ssd_scan = keep("ssd", ops.ssd_scan)
    ops.flash_attention = keep("flash", ops.flash_attention)
    moe.experts = keep("experts", moe.experts, result=False)
    try:
        with torch.inference_mode():
            model.prefill_fn(params, prompt if isinstance(prompt, dict)
                             else {"tokens": prompt}, cap)
    finally:
        ops.ssd_scan, ops.flash_attention, moe.experts = saved
    return seen


def sdpa_call(q, k, v, causal, window=0):
    """(a no-argument SDPA call computing flash's function on q, k, v
    (BH, L, D), the backend it runs on). Without a window: `is_causal`,
    PyTorch's own choice of backend; with one: a boolean band `attn_mask`
    (0 <= qpos - kpos < window), flash's function where the reference's
    tile bound drops no key (window % tile <= 1), on the first of
    memory-efficient, flash, cuDNN and math attention that takes it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = q[None], k[None], v[None]
    if not window:
        return (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal)), "PyTorch's choice"
    pos = torch.arange(q.shape[1], device=q.device)
    diff = pos[:, None] - pos[None, :]
    kw = {"attn_mask": (diff >= 0) & (diff < window)}
    names = ("EFFICIENT_ATTENTION", "FLASH_ATTENTION", "CUDNN_ATTENTION",
             "MATH")
    for backend in (getattr(SDPBackend, n) for n in names
                    if hasattr(SDPBackend, n)):
        def call(b=backend):
            with sdpa_kernel([b]):
                return F.scaled_dot_product_attention(q4, k4, v4, **kw)
        try:
            call()
        except RuntimeError:
            continue
        return call, backend.name
    raise AssertionError("no SDPA backend takes the call")


def check_first_kernels(tag, seen):
    """The first layer's kernel against its plain version on this
    prefill's own tensors, timed with CUDA events beside the plain
    version, SDPA (attention) and the bound. Returns {kernel: row}."""
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    rows = {}
    if "flash" in seen:
        (q, k, v), kw, o = seen["flash"]
        c, tq, tk = kw["causal"], kw["tq"], kw["tk"]
        w = kw.get("window", 0)
        err = lm_err(o, pfa.flash_attention_plain(q, k, v, causal=c, tq=tq,
                                                  tk=tk, window=w),
                     f"{tag} first layer's attention")
        sdpa, backend = sdpa_call(q, k, v, c, w)
        rows[FLASH[0]] = dict(
            ms=timed(lambda: pfa.flash_attention(q, k, v, causal=c, tq=tq,
                                                 tk=tk, window=w,
                                                 device=q.device), 20),
            plain_ms=timed(lambda: pfa.flash_attention_plain(
                q, k, v, causal=c, tq=tq, tk=tk, window=w), 3),
            library_ms=timed(sdpa, 20),
            bounds=flash_bound(q, tq, tk, c, w), err=err,
            shape=f"BH {q.shape[0]} x L {q.shape[1]} x D {q.shape[2]}, "
                  f"tile {tq}, {q.dtype}"
                  + (f", window {w}; library: SDPA ({backend})" if w else ""))
    if "ssd" in seen:
        (a, x, dt, b, c_), kw, (y, st) = seen["ssd"]
        q_, rep = kw["q"], kw["rep"]
        yp, sp = pss.ssd_scan_plain(a, x, dt, b, c_, q=q_, rep=rep)
        err = lm_err(y, yp, f"{tag} first layer's scan")
        lm_err(st, sp, f"{tag} first layer's scan state", LM_TOL["bfloat16"])
        rows[SSD[0]] = dict(
            ms=timed(lambda: pss.ssd_scan(a, x, dt, b, c_, q=q_, rep=rep,
                                          device=x.device), 20),
            plain_ms=timed(lambda: pss.ssd_scan_plain(a, x, dt, b, c_, q=q_,
                                                      rep=rep), 3),
            library_ms=None, bounds=ssd_bound(a, x, dt, b, c_, q_), err=err,
            shape=f"BH {x.shape[0]} x L {x.shape[1]}, P {x.shape[2]}, N "
                  f"{b.shape[-1]}, chunk {q_}, {rep} heads a group, "
                  f"{x.dtype}")
    for name, r in rows.items():
        lib = r["library_ms"]
        log(f"[{tag}] {name} on the first layer's own tensors "
            f"({r['shape']}): "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{max(r['bounds']):.4f} ms (bytes {r['bounds'][0]:.4f}, "
            f"operations {r['bounds'][1]:.4f}); max |kernel - plain| "
            f"{r['err']:.3g}")
    return rows


def full_logits(params, cfg, seq, pl, gen):
    """The full forward's logits at positions pl - 1 .. pl + gen - 1 of
    `seq`, (B, gen + 1, vocab) float32 on the host. The SSM's forward
    runs over a whole number of chunks: the causal pad after the last
    token reaches none of those positions."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ssm as SM
    from repro_torch.models import transformer as TF
    with torch.inference_mode():
        if cfg.family == "ssm":
            pad = (-seq.shape[1]) % cfg.ssm.chunk
            h = SM.ssm_forward(params, cfg, F.pad(seq, (0, pad)))
        else:
            h, _ = TF.decoder_forward(params, cfg, seq)
        return TF.logits_fn(params, cfg, h[:, pl - 1:pl + gen])[
            ..., :cfg.vocab].float().cpu()


def check_cache_path(tag, cache_bf, full_bf, cache32, full32):
    """The cache path's logits (B, steps, V) against the full forward's.
    float32: within SMALL_SERVE_TOL["float32"] at every step: the cache
    path computes the forward. bfloat16: both paths round, and at 28-48
    layers of random weights both drift from the float32 answer by far
    more than the smoke configs' elementwise tolerance (so does the
    reference's own bfloat16 run: tests/test_torch_*_serve.py's drift
    test); the cache path may add at most a quarter to the forward's own
    relative error against the float32 answer (CACHE_DRIFT)."""
    import torch
    rtol, atol = SMALL_SERVE_TOL["float32"]
    for i in range(cache32.shape[1]):
        torch.testing.assert_close(
            cache32[:, i], full32[:, i], rtol=rtol, atol=atol,
            msg=lambda m: f"{tag}: float32 cache path step {i} against the "
                          f"full forward: {m}")
    d32 = float((cache32 - full32).abs().max())

    def rel(a):
        return float((a - full32).norm() / full32.norm())
    r_cache, r_fwd = rel(cache_bf), rel(full_bf)
    brtol, batol = SMALL_SERVE_TOL["bfloat16"]
    over = int(((cache_bf - full_bf).abs()
                > batol + brtol * full_bf.abs()).sum())
    log(f"[{tag}] cache path (prefill + {cache32.shape[1] - 1} decode "
        f"steps) against the full forward over the same tokens: float32 "
        f"max |diff| {d32:.3g} (within rtol {rtol}, atol {atol} at every "
        f"step); bfloat16, relative L2 error against the float32 forward: "
        f"cache path {r_cache:.5f}, forward {r_fwd:.5f} (ratio "
        f"{r_cache / r_fwd:.3f}, at most {CACHE_DRIFT}); bfloat16 cache "
        f"path against bfloat16 forward: max |diff| "
        f"{float((cache_bf - full_bf).abs().max()):.4f}, {over} of "
        f"{cache_bf.numel()} logits past rtol {brtol}, atol {batol}")
    if not r_cache <= CACHE_DRIFT * r_fwd:
        raise AssertionError(f"{tag}: the bfloat16 cache path's relative "
                             f"error {r_cache:.5f} exceeds {CACHE_DRIFT} x "
                             f"the forward's {r_fwd:.5f}")


def serve_full(dev, arch, profile):
    """`arch` at full width and depth in bfloat16 through `generate` on
    the card: launches (one kernel a layer a prefill, no plain call),
    rates and peak memory; the first layer's kernel against its plain
    version; with `profile`, the prefill and 8 decode steps under
    torch.profiler; then the cache path (prefill and 32 decode steps)
    against the full forward over the same 544 tokens
    (`check_cache_path`), the parameters cast to float32 in place for
    its float32 half. Frees the model after. Returns the generate run's
    launches by kernel."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, count_params

    tag = f"serve {arch}"
    b, pl, gen = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"[{tag}] {cfg.family}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}: {n_params} parameters initialised on "
        f"the card in {time.perf_counter() - t0:.1f}s; "
        f"memory_allocated {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
        f"GiB")
    if n_params != FULL_PARAMS[arch]:
        raise AssertionError(f"{tag}: {n_params} parameters, the reference "
                             f"counts {FULL_PARAMS[arch]}")

    # warm-up (the allocator's pool, cuBLAS's choices), not counted
    serve.generate(cfg, batch=b, prompt_len=pl, gen=2, params=params,
                   device=dev, log=lambda *a: None)
    pfa.reset_counts()
    pss.reset_counts()
    toks, stats = serve.generate(cfg, batch=b, prompt_len=pl, gen=gen,
                                 params=params, device=dev, log=log)
    counts = {SSD[0]: pss.ssd_scan.launches,
              FLASH[0]: pfa.flash_attention.launches}
    plain = pfa.flash_attention.plain_calls + pss.ssd_scan.plain_calls
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(counts.values()) != expected_launches(cfg) or plain:
        raise AssertionError(f"{tag}: launches {counts}, {plain} plain "
                             f"calls; expected {expected_launches(cfg)} "
                             f"(ssd_scan, flash_attention) per prefill")
    counts[FLASH_WGMMA[0]] = pfa.flash_attention.wgmma_launches
    check_wgmma_share(tag, cfg, counts)
    check_ssd_wgmma_share(tag, cfg, counts[SSD[0]])
    if toks.shape != (b, gen) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{tag}: tokens {toks.shape}")
    n_dec = (gen - 1) * b
    log(f"[{tag}] {b} requests x prompt {pl}, {gen} tokens each: prefill "
        f"{stats['prefill_s'] * 1e3:.1f} ms = "
        f"{b * pl / stats['prefill_s']:.1f} prefill tokens/s; {gen - 1} "
        f"decode steps {stats['decode_s']:.3f}s = "
        f"{n_dec / stats['decode_s']:.1f} decode tokens/s "
        f"({stats['decode_s'] / (gen - 1) * 1e3:.2f} ms a step); launches "
        f"per prefill: {counts[SSD[0]]} ssd_scan "
        f"({pss.ssd_scan.wgmma_launches} {SSD_WGMMA}), {counts[FLASH[0]]} "
        f"flash_attention, 0 plain calls; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({peak} bytes)")

    # the same prompt as generate's (default_rng(0))
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, pl)), device=dev)
    seen = capture_first_kernels(model, params, prompt, pl + gen)
    check_first_kernels(tag, seen)
    del seen

    if profile:
        t0 = time.perf_counter()
        run, wall, busy, rows = profiled(lambda: serve.generate(
            cfg, batch=b, prompt_len=pl, gen=FULL_PROFILE_GEN, params=params,
            device=dev, log=lambda *a: None), cpu=False)
        if busy is None:
            log(f"[{tag}] the profiler saw no device activity: device busy "
                f"share not measured")
        else:
            log(f"[{tag}] under torch.profiler (prefill and "
                f"{FULL_PROFILE_GEN - 1} decode steps): {wall:.2f}s wall "
                f"(prefill {run[1]['prefill_s']:.3f}s, decode "
                f"{run[1]['decode_s']:.3f}s inside generate), device busy "
                f"{busy:.3f}s = share {busy / wall:.4f} of the wall; reading "
                f"the trace took {time.perf_counter() - t0 - wall:.1f}s")
            log_rows(tag, device_time_by_layer(tag, rows), 8)

    # the cache path (prefill, then 32 decode steps) against the full
    # forward over the same 544 tokens, in bfloat16 and, with the same
    # (bfloat16-valued) parameters cast in place, in float32
    gt, cache_bf = greedy(model, params, prompt, pl + gen, gen)
    if not np.array_equal(gt[:, :gen].numpy(), toks):
        raise AssertionError(f"{tag}: the greedy loop's tokens differ from "
                             f"generate's")
    seq = torch.cat([prompt, gt[:, :gen].to(dev)], 1)
    full_bf = full_logits(params, cfg, seq, pl, gen)
    for p in params.parameters():
        p.data = p.data.float()
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    full32 = full_logits(params, cfg32, seq, pl, gen)
    _, cache32 = greedy(build_model(cfg32), params, prompt, pl + gen, gen,
                        forced=gt[:, :gen])
    check_cache_path(tag, torch.stack(cache_bf, 1), full_bf,
                     torch.stack(cache32, 1), full32)
    del cache_bf, cache32, full_bf, full32, gt
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_dense_ssm(dev):
    """20: (a) the four smoke configs in float32 and bfloat16, card
    against CPU (`small_serve`); (b)-(d) each at full width and depth
    (`serve_full`). Returns the full serves' launches by kernel."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    for arch, _ in FULL_SERVES:
        for dtype in SMALL_SERVE_TOL:
            small_serve(dev, arch, dtype, "dense/ssm small")
    total = {FLASH[0]: 0, FLASH_WGMMA[0]: 0, SSD[0]: 0}
    for arch, prof in FULL_SERVES:
        for k, v in serve_full(dev, arch, prof).items():
            total[k] += v
    return total


# ------------------------------------------------------------- phase 21
FLASH_BWD = ("flash_attention_bwd",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:61")
# the same wrapper's bfloat16 backward, at every head dim a pair of
# kernels of its own (flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma: wgmma and
# TMA): its launches are counted apart too
# (`flash_attention.bwd_wgmma_launches`), and are also flash_attention_bwd's
FLASH_BWD_WGMMA = ("flash_bwd_wgmma",
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:61")
# its two kernels' names in the SASS and ptxas's report
BWD_WGMMA_KERNELS = ("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma")
# the training cell: Qwen2-1.5B at full width and depth, 5 AdamW steps
# of 8 x 512 tokens from data/pipeline.py, remat on (the config's)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen2-1.5b", 8, 512, 5
# 21(c): the smoke config card against CPU: steps, and the steps of the
# card's run whose loss must fall
SMOKE_TRAIN_STEPS, SMOKE_FALL_STEPS = 3, 10
SMOKE_TRAIN_LR = {"warmup": 1}


def flash_bwd_bound(q, tq, tk, causal, window=0):
    """Bytes (q, k, v, o, dO and lse read once, dq, dk, dv written once)
    and operations (five products, S, dP, dV, dQ, dK, over the (query,
    key) pairs the forward uses) over the card's peaks, ms."""
    bh, l, d = q.shape
    _, fwd_ms = flash_bound(q, tq, tk, causal, window)   # two products
    nbytes = 8 * q.numel() * q.element_size() + bh * l * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, fwd_ms * 5 / 2


def bwd_mma_registers():
    """ptxas's report for the bfloat16 backward kernels (the `wgmma` pair,
    flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma), one entry per build of
    64, 128, 192 and 256 columns: '<kernel>: <registers> registers,
    spills <st>/<ld> bytes'; raises on a spill. Empty where this process
    found the library built."""
    from repro_torch.kernels import _build
    rows = [r for r in ptxas_report(_build.build_log("flash_attention"))
            if r[0].startswith(BWD_WGMMA_KERNELS)]
    spilled = [r for r in rows if r[3] or r[4]]
    if spilled:
        raise AssertionError(f"bfloat16 backward kernels spill: {spilled}")
    return [f"{k}: {regs} registers, spills {st}/{ld} bytes"
            for k, regs, _, st, ld in rows]


def kernel_device_ms(fn, reps):
    """{kernel: (device ms, launches) a call of fn()} over `reps` calls
    under torch.profiler (device activity only), after one call to warm
    up. A session can lose most of its kernel records (phase 21(a)'s
    first one did, in two runs), so a kernel's count of records must be
    a multiple of `reps`: else a second session, then None."""
    fn()
    for _ in range(2):
        _, _, _, rows = profiled(lambda: [fn() for _ in range(reps)],
                                 cpu=False)
        rows = [r for r in rows if r.self_device_time_total > 0
                and not r.key.startswith("aten::")]
        if rows and not any(r.count % reps for r in rows):
            break
    else:
        return None
    out = {}
    for r in rows:
        name = r.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.strip().removeprefix("void ").split("::")[-1][:60]
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + r.self_device_time_total / 1e3 / reps,
                     n + r.count // reps)
    return out


def phase_flash_bwd(dev, rec):
    """21(a): the backward kernel against its plain version at the
    training shape (Qwen2-1.5B: B 8 x 12 heads, L 512, D 128, tile 512),
    causal, in float32 and bfloat16, and at tq != tk and causal=False;
    every gradient within LM_TOL; the bfloat16 causal case launched
    twice for the same bits, then timed beside the plain version, SDPA's
    backward and the bound, with the bfloat16 kernels' registers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as pfa
    regs = bwd_mma_registers()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    bh, l, d = TRAIN_BATCH * cfg.n_heads, TRAIN_SEQ, cfg.resolved_head_dim
    t = min(cfg.attn_chunk, l)
    g = torch.Generator(device=dev).manual_seed(21)
    cases = [(torch.float32, True, t, t), (torch.bfloat16, True, t, t),
             (torch.bfloat16, True, 128, 256), (torch.bfloat16, True, 256, 64),
             (torch.bfloat16, False, t, t), (torch.float32, False, 128, 256)]
    for dtype, causal, tq, tk in cases:
        q, k, v, do = ((torch.randn((bh, l, d), generator=g, device=dev))
                       .to(dtype) for _ in range(4))
        o, lse = pfa._forward(q, k, v, causal, tq, tk, 0, dev, True)
        po, plse = pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq,
                                             tk=tk, return_lse=True)
        what = f"BH {bh} x L {l} x D {d} {dtype}, causal {causal}, tq {tq}, " \
               f"tk {tk}"
        lm_err(o, po, f"flash forward {what}")
        lm_err(lse, plse, f"flash log-sum-exp {what}", LM_TOL["float32"])
        got = pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                      tq=tq, tk=tk, device=dev)
        torch.cuda.synchronize()
        want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                             causal=causal, tq=tq, tk=tk)
        errs = [lm_err(a, b, f"flash backward d{n} {what}")
                for n, a, b in zip("qkv", got, want)]
        log(f"[train] flash_attention_bwd {what}: max |kernel - plain| dq "
            f"{errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g} (within "
            f"{LM_TOL[str(dtype)[6:]]} x max(1, largest |gradient|))")
        if (dtype, causal, tq, tk) != (torch.bfloat16, True, t, t):
            continue
        again = pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                        tq=t, tk=t, device=dev)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash backward {what}: two launches on "
                                 f"the same inputs differ")
        qs, ks, vs = (x[None].detach().requires_grad_() for x in (q, k, v))
        do4 = do[None]

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            torch.autograd.grad(out, (qs, ks, vs), do4)
        lib = timed(sdpa_fwd_bwd, 20) - timed(sdpa_fwd, 20)
        # the same two backwards by their kernels' device time alone
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        ours = kernel_device_ms(lambda: pfa.flash_attention_bwd(
            q, k, v, o, do, lse, causal=True, tq=t, tk=t, device=dev), 20)
        sdpa = kernel_device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do4, retain_graph=True), 20)
        log("[train] device time a call (torch.profiler): " + "; ".join(
            f"{what} " + ("not measured (records lost)" if ms is None else
                          f"{sum(v for v, _ in ms.values()):.4f} ms ("
                          + ", ".join(f"{k} {v:.4f} in {n}"
                                      for k, (v, n) in ms.items()) + ")")
            for what, ms in (("flash_attention_bwd", ours),
                             ("SDPA's backward", sdpa))))
        del out
        record(rec, FLASH_BWD[0],
               timed(lambda: pfa.flash_attention_bwd(
                   q, k, v, o, do, lse, causal=True, tq=t, tk=t,
                   device=dev), 20),
               timed(lambda: pfa.flash_attention_bwd_plain(
                   q, k, v, o, do, lse, causal=True, tq=t, tk=t), 3),
               max(errs), flash_bwd_bound(q, t, t, True), lib,
               f"BH {bh} x L {l} x D {d} bfloat16, causal, tile {t} "
               f"(library: SDPA's forward + backward minus its forward)")
        log(f"[train] flash_attention_bwd bfloat16: two launches give the "
            f"same bits; ptxas: " + ("; ".join(regs) if regs else
                                     "not reported (library found built)"))
    torch.cuda.empty_cache()


def lm_counts():
    """({kernel: launches} of the four LM kernels on the train path, and
    of flash_fwd_wgmma and flash_bwd_wgmma among flash's; the plain
    versions' calls in all)."""
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    fa, ss = pfa.flash_attention, pss.ssd_scan
    return ({FLASH[0]: fa.launches, FLASH_WGMMA[0]: fa.wgmma_launches,
             FLASH_BWD[0]: fa.bwd_launches,
             FLASH_BWD_WGMMA[0]: fa.bwd_wgmma_launches, SSD[0]: ss.launches,
             SSD_BWD[0]: ss.bwd_launches},
            fa.plain_calls + fa.bwd_plain_calls + ss.plain_calls
            + ss.bwd_plain_calls)


# the wrapper's forward counts: flash's holds flash_fwd_wgmma's
FLASH_FWD = (FLASH[0], FLASH_WGMMA[0])


def wgmma_share(cfg, n):
    """Of n flash forwards of `cfg`, those flash_fwd_wgmma runs: all in
    bfloat16 (every head dim), none in float32."""
    return n if cfg.dtype == "bfloat16" else 0


def check_wgmma_share(tag, cfg, counts):
    """Every bfloat16 flash forward of `cfg` ran flash_fwd_wgmma, and no
    float32 one: counts[FLASH_WGMMA] is wgmma_share(cfg, counts[FLASH])."""
    want = wgmma_share(cfg, counts[FLASH[0]])
    if counts[FLASH_WGMMA[0]] != want:
        raise AssertionError(f"{tag}: {counts[FLASH_WGMMA[0]]} of "
                             f"{counts[FLASH[0]]} flash forwards ran "
                             f"{FLASH_WGMMA[0]}, expected {want}")


def check_bwd_wgmma_share(tag, cfg, counts):
    """Every bfloat16 flash backward of `cfg` ran the wgmma pair
    (flash_bwd_wgmma), and no float32 one: counts[FLASH_BWD_WGMMA] is
    wgmma_share(cfg, counts[FLASH_BWD])."""
    want = wgmma_share(cfg, counts[FLASH_BWD[0]])
    if counts[FLASH_BWD_WGMMA[0]] != want:
        raise AssertionError(f"{tag}: {counts[FLASH_BWD_WGMMA[0]]} of "
                             f"{counts[FLASH_BWD[0]]} flash backwards ran "
                             f"{FLASH_BWD_WGMMA[0]}, expected {want}")


def reset_lm_counts():
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    pfa.reset_counts()
    pss.reset_counts()


def train_full(dev, cfg, steps, per_step, n_params=None, what="",
               batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """`steps` `train_loop` steps with the config's optimizer (AdamW;
    DeepSeek-V3's Adafactor) at batch x seq tokens
    (parameters and data from a seed): finite losses, the parameter count
    (against `n_params` where given), the median step of steps 2 on,
    tokens/s, the share of the bfloat16 dense peak, peak memory, and the
    LM kernels' launches, exactly `per_step` ({kernel: launches}) a step
    and no plain call; then one more step under torch.profiler. Returns
    the run's launches."""
    import gc

    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models.model import build_model, count_params

    tag = f"train {cfg.name}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_lm_counts()
    t0 = time.perf_counter()
    out = train_loop(cfg=cfg, steps=steps, batch=batch, seq=seq,
                     ckpt_dir="", device=dev, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = lm_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n = count_params(out["params"])
    if n_params is not None and n != n_params:
        raise AssertionError(f"{tag}: {n} parameters, the reference counts "
                             f"{n_params}")
    losses = out["losses"]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    want = {k: v * steps for k, v in per_step.items()}
    if {k: counts[k] for k in want} != want or plain:
        raise AssertionError(f"{tag}: launches {counts}, {plain} plain "
                             f"calls; expected {want} (forwards with their "
                             f"remat recompute, backwards)")
    check_wgmma_share(tag, cfg, counts)
    check_bwd_wgmma_share(tag, cfg, counts)
    check_ssd_wgmma_share(tag, cfg, counts[SSD[0]])
    check_ssd_bwd_wgmma_share(tag, cfg, counts[SSD_BWD[0]])
    step_s = float(np.median(out["dts"][1:]))
    tokens = batch * seq
    flops = 6.0 * n * tokens
    log(f"[{tag}] {cfg.n_layers} layers{what}, d_model {cfg.d_model}, "
        f"{cfg.dtype}, remat {cfg.remat}, {cfg.optimizer}: {n} parameters; "
        f"{steps} steps of {batch} x {seq} in {wall:.1f}s "
        f"(init included); losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"step times {', '.join(f'{x * 1e3:.1f}' for x in out['dts'])} ms; "
        f"median of steps 2-{steps} {step_s * 1e3:.2f} ms = "
        f"{tokens / step_s:.1f} train tokens/s; 6 N tokens = {flops:.4g} "
        f"operations = {flops / step_s / BF16_OPS_PER_S:.4f} of the "
        f"bfloat16 dense peak; launches a step: "
        + ", ".join(f"{v} {k}" for k, v in per_step.items())
        + f" (forwards with their remat recompute), 0 plain calls; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes)")
    terms = out["metrics"]
    if not all(np.isfinite(v) for t in terms for v in t.values()):
        raise AssertionError(f"{tag}: loss terms {terms}")
    if any(len(t) > 1 for t in terms):
        log(f"[{tag}] each step's loss terms: " + "; ".join(
            f"step {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
            + f", loss {x:.4f}" for i, (t, x) in enumerate(zip(terms,
                                                              losses))))

    # one more step under torch.profiler, device activity only
    model = build_model(cfg)
    _, step_fn = psteps.make_train_step(model)
    bt = to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                         global_batch=batch), steps), dev)
    params, opt_state = out["params"], out["opt_state"]
    t0 = time.perf_counter()
    run, pwall, busy, rows = profiled(lambda: step_fn(
        params, opt_state, bt, steps), cpu=False)
    if busy is None:
        log(f"[{tag}] the profiler saw no device activity: device busy "
            f"share not measured")
    else:
        log(f"[{tag}] one step under torch.profiler: {pwall * 1e3:.1f} ms "
            f"wall, device busy {busy * 1e3:.1f} ms = share "
            f"{busy / pwall:.4f}; reading the trace took "
            f"{time.perf_counter() - t0 - pwall:.1f}s")
        log_rows(tag, device_time_by_layer(tag, rows), 10)
    del out, params, opt_state, run, bt
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_train_full(dev):
    """21(b): Qwen2-1.5B at full width and depth, five `train_loop` steps
    with AdamW at 8 x 512 (cut: the step count); 56 flash forwards (with
    the remat recompute) and 28 backwards a step. Returns the five
    steps' launches."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(TRAIN_ARCH)
    layers = cfg.n_layers
    return train_full(dev, cfg, TRAIN_STEPS,
                      {FLASH[0]: 2 * layers, FLASH_BWD[0]: layers,
                       SSD[0]: 0, SSD_BWD[0]: 0}, FULL_PARAMS[TRAIN_ARCH])


def smoke_train(dev, arch, grad_accums):
    """A smoke config in float32 from the same parameters on the card and
    the CPU, SMOKE_TRAIN_STEPS steps at each grad_accum: losses and
    gnorms within 1e-4 relative, parameters within 2 x the summed
    learning rates, and every LM kernel the card launched (forward and
    backward) matched one for one by the CPU's plain calls; then
    SMOKE_FALL_STEPS card steps of `train_loop` whose loss must fall."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.kernels import ssd_scan as pss
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models.model import build_model
    from repro_torch.optim import cosine_schedule

    cpu = torch.device("cpu")
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    # Adam's first moves are sign(g) lr: a gradient at rounding level may
    # differ in sign between the card and the CPU, so a parameter may
    # differ by up to 2 lr a step
    atol = 2 * sum(float(cosine_schedule(s, **SMOKE_TRAIN_LR))
                   for s in range(SMOKE_TRAIN_STEPS))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    for ga in grad_accums:
        opt_init, step_fn = psteps.make_train_step(model, grad_accum=ga,
                                                   lr_kwargs=SMOKE_TRAIN_LR)
        p_cpu = model.init_params(torch.Generator().manual_seed(0), cpu,
                                  trainable=True)
        p_card = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                   dev, trainable=True)
        with torch.no_grad():
            for a, b in zip(p_card.parameters(), p_cpu.parameters()):
                a.copy_(b)
        s_cpu, s_card = opt_init(p_cpu), opt_init(p_card)
        reset_lm_counts()
        rel = 0.0
        for step in range(SMOKE_TRAIN_STEPS):
            bt = host_batch(dcfg, step)
            p_card, s_card, mc = step_fn(p_card, s_card, to_device(bt, dev),
                                         step)
            p_cpu, s_cpu, mp = step_fn(p_cpu, s_cpu, to_device(bt, cpu), step)
            for k in ("loss", "gnorm"):
                a, b = float(mc[k]), float(mp[k])
                rel = max(rel, abs(a - b) / abs(b))
                if not abs(a - b) <= 1e-4 * abs(b):
                    raise AssertionError(f"[train small] {arch} grad_accum "
                                         f"{ga} step {step} {k}: card {a}, "
                                         f"CPU {b}")
        dmax = max(float((a.detach().cpu() - b.detach()).abs().max())
                   for a, b in zip(p_card.parameters(), p_cpu.parameters()))
        if not dmax <= atol:
            raise AssertionError(f"[train small] {arch} grad_accum {ga}: "
                                 f"parameters differ by {dmax:.3g}, past "
                                 f"{atol:.3g}")
        # each kernel the family runs, forward and backward, on the card
        # (and no other); the plain versions' calls are the CPU's, one for
        # one
        family = {"qwen2-1.5b": (pfa.flash_attention,),
                  "gemma3-12b": (pfa.flash_attention,),
                  "mamba2-1.3b": (pss.ssd_scan,),
                  "zamba2-7b": (pfa.flash_attention, pss.ssd_scan),
                  "deepseek-v3-671b": (pfa.flash_attention,)}[arch]
        launched = []
        for k in (pfa.flash_attention, pss.ssd_scan):
            pairs = ((k.launches, k.plain_calls),
                     (k.bwd_launches, k.bwd_plain_calls))
            if any(n != m for n, m in pairs):
                raise AssertionError(f"[train small] {arch}: card launches "
                                     f"and CPU plain calls differ: {pairs}")
            ran = (k.launches, k.bwd_launches)
            if not all(ran) if k in family else any(ran):
                raise AssertionError(f"[train small] {arch}: {k.__name__} "
                                     f"launched {k.launches} + backward "
                                     f"{k.bwd_launches}")
            if k in family:
                launched.append(f"{k.__name__} {k.launches} + backward "
                                f"{k.bwd_launches}")
        log(f"[train small] {arch} smoke config, float32, {cfg.optimizer}, "
            f"grad_accum {ga}, {SMOKE_TRAIN_STEPS} steps, card against CPU: "
            f"losses and "
            f"gnorms within {rel:.3g} relative (limit 1e-4); parameters "
            f"within {dmax:.3g} (limit {atol:.3g} = 2 x the summed "
            f"learning rates); on the card {'; '.join(launched)}")
    out = train_loop(cfg=cfg, steps=SMOKE_FALL_STEPS + 1, batch=4, seq=64,
                     ckpt_dir="", lr_kwargs=SMOKE_TRAIN_LR, device=dev,
                     log=lambda *a: None)
    losses = out["losses"]
    if not losses[SMOKE_FALL_STEPS] < losses[0]:
        raise AssertionError(f"[train small] {arch}: the loss did not "
                             f"fall: {losses}")
    log(f"[train small] {arch}: {SMOKE_FALL_STEPS + 1} card steps: loss "
        f"{losses[0]:.4f} at step 0 -> {losses[SMOKE_FALL_STEPS]:.4f} at "
        f"step {SMOKE_FALL_STEPS}")


def phase_train_small(dev):
    """21(c): the qwen2-1.5b smoke config in float32 from the same
    parameters on the card and the CPU, SMOKE_TRAIN_STEPS steps at
    grad_accum 1 and 2; then SMOKE_FALL_STEPS card steps of `train_loop`
    whose loss must fall. 21(d): the smoke config (its own bfloat16) 6
    steps uninterrupted, against 3 steps, a checkpoint, and a resumed
    `train_loop` to 6: losses, parameters and optimizer state equal bit
    for bit."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.train import train_loop

    smoke_train(dev, TRAIN_ARCH, (1, 2))

    # 21(d) resume
    cfg = get_smoke_config(TRAIN_ARCH)
    d = os.path.join(ROOT, "build", "chip_smoke_train_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(cfg=cfg, steps=6, batch=4, seq=64, lr_kwargs=SMOKE_TRAIN_LR,
              device=dev, log=lambda *a: None)
    try:
        full = train_loop(ckpt_dir="", **kw)
        train_loop(ckpt_dir=d, **dict(kw, steps=3))
        resumed = train_loop(ckpt_dir=d, **kw)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    same = resumed["losses"] == full["losses"][3:] and all(
        torch.equal(a, b) for a, b in zip(full["params"].parameters(),
                                          resumed["params"].parameters()))
    for part in ("m", "v"):
        same &= all(torch.equal(a, resumed["opt_state"][part][k])
                    for k, a in full["opt_state"][part].items())
    if not same:
        raise AssertionError(f"[train resume] resumed run differs: losses "
                             f"{resumed['losses']} vs {full['losses'][3:]}")
    log(f"[train resume] smoke config ({cfg.dtype}) on the card: 6 steps "
        f"uninterrupted against 3, a checkpoint and a resumed train_loop "
        f"to 6: losses {', '.join(f'{x:.6f}' for x in full['losses'][3:])} "
        f"and every parameter, m and v equal bit for bit")


# ------------------------------------------------------------- phase 22
SSD_BWD = ("ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "src/repro/kernels/ssd_scan.py:67")
# the SSM and hybrid training cells: Mamba2-1.3B at full width and depth
# for TRAIN_STEPS steps; Zamba2-7B at full width, its depth cut to 27
# layers (4 groups of 6 Mamba layers with their shared-block calls, then
# the 3-layer tail: at 81 layers its bfloat16 parameters with float32
# AdamW m and v need about 6.96e9 x 12 B = 83.5 GB, past the card's 80 GB)
SSM_TRAIN_ARCH, HYBRID_TRAIN_ARCH = "mamba2-1.3b", "zamba2-7b"
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_STEPS = 27, 3
# the bfloat16 backward's times before its wgmma build (the mma.sync
# kernel's, ms a launch with torch's sum of its partials, PERF.md section
# 6 row 7; NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_BWD_MS = {SSM_TRAIN_ARCH: 0.8167, HYBRID_TRAIN_ARCH: 1.1360}


def ssd_train_shape(arch):
    """(BH, L, P, N, chunk, rep) of a family's training scans at
    TRAIN_BATCH x TRAIN_SEQ."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.mamba import mamba_dims
    cfg = get_config(arch)
    _, heads = mamba_dims(cfg.d_model, cfg.ssm)
    s = cfg.ssm
    return (TRAIN_BATCH * heads, TRAIN_SEQ, s.head_dim, s.d_state,
            min(s.chunk, TRAIN_SEQ), heads // s.n_groups)


def ssd_bwd_bound(a, x, dt, b, c, dy, states, ds, q):
    """Bytes (a, x, dt, B, C, dy, the saved states and d(s_final) read
    once; da, dx, ddt, dB, dC, the inputs' shapes and types, written
    once) and operations over the card's peaks, ms. Operations per chunk:
    over the causal (i, j) pairs, dy.x and W^T dy for each head, and C.B,
    dG B and dG^T C for each group (B and C are a group's, and dB, dC are
    summed over its heads, so the heads' dG can be summed first); two of
    Q N P per head, B dS and x dS^T; and two more, dy S_c^T and C^T dy,
    in every chunk but the first (its state is zero and the initial
    state's gradient is no output)."""
    bh, l, p = x.shape
    groups, _, n = b.shape
    nc = l // q
    nbytes = sum(t.numel() * t.element_size() for t in (a, x, dt, b, c)) \
        * 2 + sum(t.numel() * t.element_size() for t in (dy, states, ds))
    pairs = q * (q + 1) // 2
    qnp = 2 * q * n * p
    ops = (nc * pairs * 2 * (bh * 2 * p + groups * 3 * n)
           + bh * (nc * 2 + (nc - 1) * 2) * qnp)
    rate = BF16_OPS_PER_S if x.dtype.itemsize == 2 else FP32_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3


def bwd_wgmma_launch(p, n, q, rep):
    """The bfloat16 backward's launch as its library reports it
    (`ssd_scan_bwd_wgmma_info`): shared memory bytes, resident blocks an
    SM, registers and local (spilled) bytes a thread, heads a block,
    blocks a group; raises if the host's model (`bwd_wgmma_smem`,
    `bwd_wgmma_heads`) disagrees."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as pss
    out = (ctypes.c_int * 6)()
    rc = _build.load("ssd_scan").ssd_scan_bwd_wgmma_info(
        p, n, q, rep, ctypes.addressof(out))
    if rc:
        raise AssertionError(f"ssd_scan_bwd_wgmma_info: CUDA error {rc}")
    info = dict(zip(("smem", "blocks_per_sm", "registers", "local_bytes",
                     "heads", "sets"), out))
    hb = pss.bwd_wgmma_heads(p, n, q, rep)
    if (info["smem"], info["heads"]) != (pss.bwd_wgmma_smem(n, p, q, hb),
                                         hb):
        raise AssertionError(f"bwd_wgmma_smem or heads disagree with the "
                             f"library: {info}")
    return info


def phase_ssd_bwd(dev, rec):
    """22(a): the `ssd_scan_bwd` kernel against its plain version at
    Mamba2-1.3B's and Zamba2-7B's training shapes (8 x 512 tokens), in
    float32 and bfloat16, on the forward kernel's own saved states (held
    to the plain forward's first): every gradient within LM_TOL, two
    launches the same bits; timed beside the plain version and the
    bound, with ptxas's registers and spills; the bfloat16 build
    (`ssd_bwd_wgmma`, one `bwd_wgmma_launches` count a call) also with its
    heads a block, blocks and resident blocks, its device time by kernel
    (the second kernel that sums the blocks' partials apart) and its time
    beside the earlier mma.sync build's."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as pss
    rows = [r for r in ptxas_report(_build.build_log("ssd_scan"))
            if r[0].startswith("ssd_bwd")]
    log("[ssd bwd] ptxas: " + ("; ".join(
        f"{k}: {regs} registers, spills {st}/{ld} bytes"
        for k, regs, _, st, ld in rows) if rows else
        "not reported (library found built)"))
    g = torch.Generator(device=dev).manual_seed(22)
    for arch in (SSM_TRAIN_ARCH, HYBRID_TRAIN_ARCH):
        bh, l, p, n, q, rep = ssd_train_shape(arch)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((bh, l, p), generator=g, device=dev).to(dtype)
            dt = torch.nn.functional.softplus(
                torch.randn((bh, l), generator=g, device=dev))
            a = -torch.exp(torch.randn((bh,), generator=g, device=dev) * 0.3)
            b, c = ((torch.randn((bh // rep, l, n), generator=g, device=dev)
                     * 0.5).to(dtype) for _ in range(2))
            dy = torch.randn((bh, l, p), generator=g, device=dev).to(dtype)
            ds = torch.randn((bh, n, p), generator=g, device=dev)
            what = (f"{arch} BH {bh} x L {l}, P {p}, N {n}, chunk {q}, rep "
                    f"{rep}, {str(dtype)[6:]}")
            _, _, st = pss._forward(a, x, dt, b, c, q, rep, dev, True)
            _, _, pst = pss.ssd_scan_plain(a, x, dt, b, c, q=q, rep=rep,
                                           return_states=True)
            es = lm_err(st, pst, f"ssd saved states {what}",
                        LM_TOL[str(dtype)[6:]])

            def kern():
                return pss.ssd_scan_bwd(a, x, dt, b, c, dy, st, ds, q=q,
                                        rep=rep, device=dev)

            def plain():
                return pss.ssd_scan_bwd_plain(a, x, dt, b, c, dy, st, ds,
                                              q=q, rep=rep)
            pss.reset_counts()
            got = kern()
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            if (pss.ssd_scan.bwd_launches,
                    pss.ssd_scan.bwd_wgmma_launches) != (1, int(bf16)):
                raise AssertionError(
                    f"ssd backward {what}: {pss.ssd_scan.bwd_launches} "
                    f"launches, {pss.ssd_scan.bwd_wgmma_launches} of "
                    f"{SSD_BWD_WGMMA}")
            want = plain()
            errs = [lm_err(u, v, f"ssd backward {name} {what}")
                    for name, u, v in zip(("da", "dx", "ddt", "dB", "dC"),
                                          got, want)]
            again = kern()
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"ssd backward {what}: two launches "
                                     f"on the same inputs differ")
            ms, plain_ms = timed(kern, 10), timed(plain, 3)
            b_bytes, b_ops = ssd_bwd_bound(a, x, dt, b, c, dy, st, ds,
                                           q)
            if bf16:
                info = bwd_wgmma_launch(p, n, q, rep)
                dev_ms = kernel_device_ms(kern, 10)
                if dev_ms is None:
                    dev_txt = "device time not measured (records lost)"
                else:
                    k_ms = sum(v for k, (v, _) in dev_ms.items()
                               if k.startswith(SSD_BWD_WGMMA))
                    s_ms = sum(v for k, (v, _) in dev_ms.items()
                               if k.startswith("ssd_bwd_sum_parts"))
                    dev_txt = (f"device {k_ms:.4f} ms in {SSD_BWD_WGMMA}, "
                               f"{s_ms:.4f} ms in ssd_bwd_sum_parts "
                               f"(torch.profiler; all kernels: " + "; ".join(
                                   f"{k} {v:.4f} ms in {m}"
                                   for k, (v, m) in dev_ms.items()) + ")")
                was = EARLIER_BWD_MS[arch]
                log(f"[ssd bwd] {what}: {SSD_BWD_WGMMA}, {info['heads']} "
                    f"heads a block, {bh // rep * info['sets']} blocks "
                    f"({info['sets']} partials a group), "
                    f"{info['blocks_per_sm']} resident an SM, "
                    f"{info['registers']} registers and "
                    f"{info['local_bytes']} local bytes a thread, "
                    f"{info['smem']} bytes of shared memory; events "
                    f"{ms:.4f} ms a call, {dev_txt}; the earlier mma.sync "
                    f"build's {was} ms: {was / ms:.2f}x")
            log(f"[ssd bwd] {what}: saved states within {es:.3g}; max "
                f"|kernel - plain| da {errs[0]:.3g}, dx {errs[1]:.3g}, ddt "
                f"{errs[2]:.3g}, dB {errs[3]:.3g}, dC {errs[4]:.3g} (within "
                f"{LM_TOL[str(dtype)[6:]]} x max(1, largest |gradient|)); "
                f"two launches the same bits; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {max(b_bytes, b_ops):.4f} ms "
                f"(bytes {b_bytes:.4f}, operations {b_ops:.4f})")
            if bf16 and arch == SSM_TRAIN_ARCH:
                record(rec, SSD_BWD[0], ms, plain_ms, max(errs),
                       (b_bytes, b_ops), None,
                       f"{what} (the Mamba2-1.3B training path's)")
            del x, dt, a, b, c, dy, ds, st, pst, got, want, again
    torch.cuda.empty_cache()


def phase_train_ssm(dev):
    """22(b): Mamba2-1.3B at full width and depth, TRAIN_STEPS
    `train_loop` steps with AdamW at 8 x 512 (cut: the step count): 96
    `ssd_scan` launches a step (the forward and its remat recompute), 48
    `ssd_scan_bwd`, no plain call. 22(c): Zamba2-7B at full width, 27
    layers (cut: the depth, for AdamW's memory; and the step count),
    HYBRID_TRAIN_STEPS steps: the scan's and flash's forwards and
    backwards a step. 22(d): both smoke configs card against CPU.
    Returns the full runs' launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.hybrid import split_counts
    cfg = get_config(SSM_TRAIN_ARCH)
    layers = cfg.n_layers
    counts = train_full(dev, cfg, TRAIN_STEPS,
                        {SSD[0]: 2 * layers, SSD_BWD[0]: layers,
                         FLASH[0]: 0, FLASH_BWD[0]: 0},
                        FULL_PARAMS[SSM_TRAIN_ARCH])
    cfg = get_config(HYBRID_TRAIN_ARCH).replace(
        n_layers=HYBRID_TRAIN_LAYERS)
    calls = split_counts(cfg)[1]
    for k, v in train_full(dev, cfg, HYBRID_TRAIN_STEPS,
                           {SSD[0]: 2 * cfg.n_layers,
                            SSD_BWD[0]: cfg.n_layers, FLASH[0]: 2 * calls,
                            FLASH_BWD[0]: calls},
                           what=f" (of 81: cut for AdamW's memory), "
                                f"{calls} shared-block calls").items():
        counts[k] += v
    for arch in (SSM_TRAIN_ARCH, HYBRID_TRAIN_ARCH):
        smoke_train(dev, arch, (1,))
    return counts


# ------------------------------------------------------------- phase 23
# Gemma3-12B: the dense decoder with 5:1 local:global attention (window
# 1,024 on 40 of its 48 layers) and head dim 256. Its serve: 8 requests x
# prompt 4,096 (longer than the window, so every local layer's window
# bites), 32 tokens, greedy, at full width and depth (the reference's
# count_params_abstract: 11,765,395,200). Its training: full width, the
# depth cut to 6 layers (one group: 5 local, 1 global; AdamW's m and v for
# 48 layers need about 11.77e9 x 12 B = 141 GB, and at 12 layers the
# step ran out of the card's 80 GB in AdamW's update of the 1.0e9-value
# embedding), 2 x 2,048 tokens a step, as many as phase 21(b)'s 8 x 512.
GEMMA_ARCH = "gemma3-12b"
GEMMA_PARAMS, GEMMA_TRAIN_PARAMS = 11_765_395_200, 2_351_481_600
GEMMA_BATCH, GEMMA_PROMPT, GEMMA_GEN = 8, 4096, 32
GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ = 6, 2, 2048
# the cache path's check runs on the first 2 requests: at 8, the float32
# parameters (47 GB) and K/V caches (26 GB) with the forward's activations
# would not fit 80 GB
GEMMA_CACHE_BATCH = 2
# the full forward over the 4,128 prompt and generated tokens runs at a
# tile of 32, which divides 4,128 (1,024, the config's, does not) and the
# window, so its tile bound drops no key: the exact causal mask and
# windows that the prefill's tile of 1,024 (= the window) and decode's
# masks give
GEMMA_FULL_TILE = 32


def wide_flash_registers():
    """ptxas's report for the bfloat16 forward's four builds
    (flash_fwd_wgmma at 64, 128, 192 and 256 columns), the backward's
    (flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma, likewise) and the
    float32 backward's (one build for every D), one entry each; raises
    if any flash kernel, of any head dim, spills. Empty where this
    process found the library built."""
    from repro_torch.kernels import _build
    every = ptxas_report(_build.build_log("flash_attention"))
    spilled = [r for r in every if r[3] or r[4]]
    if spilled:
        raise AssertionError(f"flash kernels spill: {spilled}")
    rows = [r for r in every if re.search(r"<float, 16[,>]", r[0])
            or r[0].startswith(("flash_bwd_dq<", "flash_bwd_dkdv<",
                                FLASH_WGMMA[0]) + BWD_WGMMA_KERNELS)]
    return [f"{k}: {regs} registers, {smem} bytes static shared memory, "
            f"spills {st}/{ld} bytes" for k, regs, smem, st, ld in rows]


# 23(a): flash_fwd_wgmma's small cases (BH, L, D, tq, tk, causal,
# window): D 256, 192 and the padded 250 and 136; causal with tq != tk
# both ways; a window of 100 at tile 64 (a multiple of neither);
# non-causal; L 320 and 200 leave a ragged last 128-row block. The narrow
# builds: D 12 (padded to 16, read at the 64 build's width), 64, 112 and
# 128, causal and non-causal; one ragged non-causal tile of 300 like
# Whisper's encoder's; tq != tk both ways at L 200; a window
WGMMA_CASES = [(2, 256, 256, 64, 64, True, 0), (2, 256, 192, 64, 128, True, 0),
               (2, 384, 192, 128, 64, True, 0), (2, 320, 250, 64, 64, True, 100),
               (2, 256, 192, 64, 64, True, 100), (3, 320, 136, 64, 64, True, 0),
               (2, 200, 256, 200, 200, False, 0), (4, 128, 192, 64, 64, False, 0),
               (2, 256, 12, 64, 64, True, 0), (2, 200, 12, 100, 100, False, 0),
               (2, 320, 64, 64, 64, True, 0), (2, 256, 64, 128, 128, False, 0),
               (2, 256, 112, 128, 128, True, 0), (2, 200, 112, 200, 200, False, 0),
               (2, 384, 128, 128, 128, True, 0), (3, 256, 128, 64, 64, False, 0),
               (2, 300, 64, 300, 300, False, 0), (2, 200, 64, 50, 100, True, 0),
               (2, 200, 64, 100, 50, True, 0), (2, 320, 128, 64, 64, True, 100)]


def wgmma_cases(dev):
    """flash_fwd_wgmma at WGMMA_CASES: the output within LM_TOL of the
    plain version and of its rounding model (tests/_torch_flash_wgmma.py),
    the log-sum-exp within the float32 tolerance, one count of
    `wgmma_launches` a call, two launches the same bits; and the backward
    given that log-sum-exp (flash_bwd_wgmma, at every head dim): every
    gradient within LM_TOL of the plain backward and of its rounding
    model, one count of `bwd_launches` and of `bwd_wgmma_launches` a
    call, two launches the same bits."""
    import torch
    from _torch_flash_wgmma import (flash_bwd_wgmma_emulation,
                                    flash_wgmma_emulation)
    from repro_torch.kernels import flash_attention as pfa
    g = torch.Generator(device=dev).manual_seed(30)
    worst = [0.0] * 5
    for bh, l, d, tq, tk, causal, w in WGMMA_CASES:
        what = (f"{FLASH_WGMMA[0]} BH {bh} x L {l} x D {d}, tq {tq}, tk "
                f"{tk}, {'causal' if causal else 'non-causal'}, window {w}")
        q, k, v, do = (torch.randn((bh, l, d), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        pfa.reset_counts()
        o, lse = pfa._forward(q, k, v, causal, tq, tk, w, dev, True)
        o2, lse2 = pfa._forward(q, k, v, causal, tq, tk, w, dev, True)
        torch.cuda.synchronize()
        if pfa.flash_attention.wgmma_launches != 2:
            raise AssertionError(f"{what}: {pfa.flash_attention.wgmma_launches}"
                                 f" launches counted, expected 2")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{what}: two launches differ")
        po, plse = pfa.flash_attention_plain(q, k, v, causal=causal, tq=tq,
                                             tk=tk, window=w,
                                             return_lse=True)
        errs = [lm_err(o, po, f"{what} against plain"),
                lm_err(o, flash_wgmma_emulation(
                    q, k, v, causal=causal, tq=tq, tk=tk, window=w),
                    f"{what} against its rounding model"),
                lm_err(lse, plse, f"{what} log-sum-exp", LM_TOL["float32"])]
        bwd = (f"{FLASH_BWD_WGMMA[0]} BH {bh} x L {l} x D {d}, tq {tq}, "
               f"tk {tk}, {'causal' if causal else 'non-causal'}, window {w}")
        got, again = (pfa.flash_attention_bwd(
            q, k, v, o, do, lse, causal=causal, tq=tq, tk=tk, window=w,
            device=dev) for _ in range(2))
        torch.cuda.synchronize()
        if (pfa.flash_attention.bwd_launches,
                pfa.flash_attention.bwd_wgmma_launches,
                pfa.flash_attention.bwd_plain_calls) != (2, 2, 0):
            raise AssertionError(f"{bwd}: launches counted "
                                 f"{pfa.flash_attention.bwd_launches}, of "
                                 f"them wgmma "
                                 f"{pfa.flash_attention.bwd_wgmma_launches}"
                                 f"; expected 2 and 2, no plain call")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{bwd}: two launches differ")
        want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                             causal=causal, tq=tq, tk=tk,
                                             window=w)
        model = flash_bwd_wgmma_emulation(q, k, v, o, do, lse, causal=causal,
                                          tq=tq, tk=tk, window=w)
        errs += [max(lm_err(a, b, f"{bwd}: d{n} against plain, given the "
                                  f"forward's lse")
                     for n, a, b in zip("qkv", got, want)),
                 max(lm_err(a, b, f"{bwd}: d{n} against its rounding model")
                     for n, a, b in zip("qkv", got, model))]
        worst = [max(a, b) for a, b in zip(worst, errs)]
    n_wide = sum(c[2] > 128 for c in WGMMA_CASES)
    log(f"[gemma3 kernels] {FLASH_WGMMA[0]} at {len(WGMMA_CASES)} small "
        f"cases ({n_wide} wide: D 256, 192, 250 and 136 zero-padded to 256 "
        f"and 136; {len(WGMMA_CASES) - n_wide} narrow: D 12 padded to 16, "
        f"64, 112, 128; causal with tq != tk, windows, non-causal; ragged "
        f"128-row blocks and key tiles; with the log-sum-exp): max |kernel "
        f"- plain| {worst[0]:.3g}, max |kernel - rounding model| "
        f"{worst[1]:.3g}, log-sum-exp {worst[2]:.3g}; given that lse, "
        f"{FLASH_BWD_WGMMA[0]} at every case: max |kernel - plain| "
        f"{worst[3]:.3g}, max |kernel - rounding model| {worst[4]:.3g} "
        f"(within {LM_TOL['bfloat16']} x max(1, largest |value|)); each "
        f"kernel's two "
        f"launches the same bits, each counted")


def phase_gemma_kernels(dev, rec):
    """23(a): `flash_attention` and its backward at Gemma3-12B's head dim
    (256): the serve shape (BH 8 x 16 = 128, L 4,096, tile 1,024) and the
    training shape (BH 2 x 16 = 32, L 2,048, tile 1,024), each with the
    local layers' window (1,024) and without (the global layers'), and
    at window 1,000 with tile 512 (a multiple of neither 64 nor the
    tile); float32 and bfloat16. Every output, log-sum-exp and gradient
    within LM_TOL of the plain version; the bfloat16 kernels twice, the
    same bits. The bfloat16 cases timed (CUDA events) beside the plain
    version, the bound and SDPA (causal, or a band mask on the backend
    named); at the training shape the backwards also by device time.
    The serve shape's causal bfloat16 forward is flash_fwd_wgmma's row of
    the `kernels` line, the training shape's causal bfloat16 backward
    flash_bwd_wgmma's (beside SDPA's backward, CUDA events); `wgmma_cases`
    first."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as pfa
    regs = wide_flash_registers()
    log("[gemma3 kernels] ptxas: " + ("; ".join(regs) if regs else
                                      "not reported (library found built)"))
    wgmma_cases(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(GEMMA_ARCH)
    h, d, w, t = (cfg.n_heads, cfg.resolved_head_dim, cfg.window,
                  cfg.attn_chunk)
    serve = (GEMMA_BATCH * h, GEMMA_PROMPT)
    train = (GEMMA_TRAIN_BATCH * h, GEMMA_TRAIN_SEQ)
    cases = [("serve", *serve, t, w), ("serve", *serve, t, 0),
             ("train", *train, t, w), ("train", *train, t, 0),
             ("train", *train, 512, 1000)]
    g = torch.Generator(device=dev).manual_seed(23)
    for dtype in (torch.float32, torch.bfloat16):
        for shape, bh, l, tile, win in cases:
            q, k, v, do = (torch.randn((bh, l, d), generator=g, device=dev)
                           .to(dtype) for _ in range(4))
            what = (f"{shape} BH {bh} x L {l} x D {d} {str(dtype)[6:]}, "
                    f"tile {tile}, window {win}")

            def fwd():
                return pfa._forward(q, k, v, True, tile, tile, win, dev,
                                    True)

            def bwd(o, lse):
                return pfa.flash_attention_bwd(q, k, v, o, do, lse, tq=tile,
                                               tk=tile, window=win,
                                               device=dev)
            o, lse = fwd()
            got = bwd(o, lse)
            torch.cuda.synchronize()
            po, plse = pfa.flash_attention_plain(q, k, v, tq=tile, tk=tile,
                                                 window=win, return_lse=True)
            e_o = lm_err(o, po, f"flash forward {what}")
            lm_err(lse, plse, f"flash log-sum-exp {what}", LM_TOL["float32"])
            del po, plse
            want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                 tq=tile, tk=tile,
                                                 window=win)
            errs = [lm_err(a, b, f"flash backward d{n} {what}")
                    for n, a, b in zip("qkv", got, want)]
            del want
            line = (f"[gemma3 kernels] {what}: max |kernel - plain| o "
                    f"{e_o:.3g}, dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv "
                    f"{errs[2]:.3g} (within {LM_TOL[str(dtype)[6:]]} x "
                    f"max(1, largest |value|))")
            if dtype == torch.bfloat16:
                o2, lse2 = fwd()
                again = bwd(o, lse)
                torch.cuda.synchronize()
                if not (torch.equal(o, o2) and torch.equal(lse, lse2) and all(
                        torch.equal(a, b) for a, b in zip(got, again))):
                    raise AssertionError(f"flash {what}: two launches on the "
                                         f"same inputs differ")
                del o2, lse2, again
                sdpa, backend = sdpa_call(q, k, v, True, win)
                f_ms = timed(lambda: pfa.flash_attention(
                    q, k, v, tq=tile, tk=tile, window=win, device=dev), 10)
                f_plain = timed(lambda: pfa.flash_attention_plain(
                    q, k, v, tq=tile, tk=tile, window=win), 2)
                f_lib = timed(sdpa, 10)
                fb, fo = flash_bound(q, tile, tile, True, win)
                b_ms = timed(lambda: bwd(o, lse), 10)
                b_plain = timed(lambda: pfa.flash_attention_bwd_plain(
                    q, k, v, o, do, lse, tq=tile, tk=tile, window=win), 2)
                bb, bo = flash_bwd_bound(q, tile, tile, True, win)
                if shape == "serve" and not win:
                    record(rec, FLASH_WGMMA[0], f_ms, f_plain, e_o, (fb, fo),
                           f_lib, f"{what}, causal")
                line += (f"; two launches the same bits. Forward: kernel "
                         f"{f_ms:.4f} ms, plain {f_plain:.3f} ms, SDPA "
                         f"({backend}) {f_lib:.4f} ms, bound "
                         f"{max(fb, fo):.4f} ms (bytes {fb:.4f}, operations "
                         f"{fo:.4f}); backward: kernel {b_ms:.4f} ms, plain "
                         f"{b_plain:.3f} ms, bound {max(bb, bo):.4f} ms "
                         f"(bytes {bb:.4f}, operations {bo:.4f})")
                if shape == "train" and tile == t:
                    qs, ks, vs = (x.detach().requires_grad_()
                                  for x in (q, k, v))
                    with torch.enable_grad():
                        out = sdpa_call(qs, ks, vs, True, win)[0]()

                    def sdpa_bwd():
                        torch.autograd.grad(out, (qs, ks, vs), do[None],
                                            retain_graph=True)
                    b_lib = timed(sdpa_bwd, 10)
                    ours = kernel_device_ms(lambda: bwd(o, lse), 10)
                    theirs = kernel_device_ms(sdpa_bwd, 10)
                    line += (f"; SDPA's backward ({backend}) {b_lib:.4f} ms "
                             f"(CUDA events); backward device time a call "
                             f"(torch.profiler): ") + "; ".join(
                            f"{who} " + device_total(ms)
                            for who, ms in (("flash_attention_bwd", ours),
                                            (f"SDPA's ({backend})", theirs)))
                    if not win:
                        record(rec, FLASH_BWD_WGMMA[0], b_ms, b_plain,
                               max(errs), (bb, bo), b_lib,
                               f"{what}, causal (library: SDPA's backward)")
                    del out, qs, ks, vs
            log(line)
            del q, k, v, do, o, lse, got
            torch.cuda.empty_cache()


def device_total(ms):
    """A `kernel_device_ms` result as its total ms a call."""
    if ms is None:
        return "not measured (records lost)"
    return f"{sum(x for x, _ in ms.values()):.4f} ms"


def phase_gemma_serve(dev):
    """23(b): Gemma3-12B at full width and depth in bfloat16 through
    `generate` on the card, 8 requests x prompt 4,096, 32 tokens: 48
    `flash_attention` launches a prefill and no plain call, the prefill
    and decode rates and peak memory, the first (local) layer's kernel on
    its own tensors, the serve once more under torch.profiler. (c): the
    cache path (prefill and 32 decode steps) against the full forward
    over the same 4,128 tokens on the first GEMMA_CACHE_BATCH requests:
    float32 within 1e-3 at every step, the bfloat16 drift at most
    CACHE_DRIFT x the forward's. Returns the generate run's launches."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, count_params

    tag = f"serve {GEMMA_ARCH}"
    b, pl, gen = GEMMA_BATCH, GEMMA_PROMPT, GEMMA_GEN
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(GEMMA_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"[{tag}] {cfg.n_layers} layers (window {cfg.window} on all but "
        f"every {cfg.global_every}th), d_model {cfg.d_model}, head dim "
        f"{cfg.resolved_head_dim}, {cfg.dtype}: {n_params} parameters "
        f"initialised on the card in {time.perf_counter() - t0:.1f}s")
    if n_params != GEMMA_PARAMS:
        raise AssertionError(f"{tag}: {n_params} parameters, the reference "
                             f"counts {GEMMA_PARAMS}")
    serve.generate(cfg, batch=b, prompt_len=pl, gen=2, params=params,
                   device=dev, log=lambda *a: None)       # warm-up
    pfa.reset_counts()
    toks, stats = serve.generate(cfg, batch=b, prompt_len=pl, gen=gen,
                                 params=params, device=dev, log=log)
    counts = {FLASH[0]: pfa.flash_attention.launches,
              FLASH_WGMMA[0]: pfa.flash_attention.wgmma_launches}
    plain = pfa.flash_attention.plain_calls
    peak = torch.cuda.max_memory_allocated(dev)
    if counts != dict.fromkeys(FLASH_FWD, cfg.n_layers) or plain:
        raise AssertionError(f"{tag}: {counts} launches, {plain} plain "
                             f"calls; expected {cfg.n_layers} a prefill, "
                             f"all of them {FLASH_WGMMA[0]}")
    if toks.shape != (b, gen) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{tag}: tokens {toks.shape}")
    log(f"[{tag}] {b} requests x prompt {pl}, {gen} tokens each: prefill "
        f"{stats['prefill_s'] * 1e3:.1f} ms = "
        f"{b * pl / stats['prefill_s']:.1f} prefill tokens/s; {gen - 1} "
        f"decode steps {stats['decode_s']:.3f}s = "
        f"{(gen - 1) * b / stats['decode_s']:.1f} decode tokens/s "
        f"({stats['decode_s'] / (gen - 1) * 1e3:.2f} ms a step); "
        f"{counts[FLASH[0]]} flash_attention launches a prefill (all "
        f"{FLASH_WGMMA[0]}), 0 plain calls; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({peak} bytes)")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, pl)), device=dev)
    check_first_kernels(tag, capture_first_kernels(model, params, prompt,
                                                   pl + gen))
    t0 = time.perf_counter()
    run, wall, busy, rows = profiled(lambda: serve.generate(
        cfg, batch=b, prompt_len=pl, gen=FULL_PROFILE_GEN, params=params,
        device=dev, log=lambda *a: None), cpu=False)
    if busy is None:
        log(f"[{tag}] the profiler saw no device activity: device busy "
            f"share not measured")
    else:
        log(f"[{tag}] under torch.profiler (prefill and "
            f"{FULL_PROFILE_GEN - 1} decode steps): {wall:.2f}s wall "
            f"(prefill {run[1]['prefill_s']:.3f}s, decode "
            f"{run[1]['decode_s']:.3f}s inside generate), device busy "
            f"{busy:.3f}s = share {busy / wall:.4f} of the wall; reading "
            f"the trace took {time.perf_counter() - t0 - wall:.1f}s")
        log_rows(tag, device_time_by_layer(tag, rows), 8)
    del run, rows

    # (c) the cache path against the full forward, first 2 requests
    cb = GEMMA_CACHE_BATCH
    p2 = prompt[:cb]
    gt, cache_bf = greedy(model, params, p2, pl + gen, gen)
    seq = torch.cat([p2, gt[:, :gen].to(dev)], 1)
    full_cfg = cfg.replace(attn_chunk=GEMMA_FULL_TILE)
    full_bf = full_logits(params, full_cfg, seq, pl, gen)
    for p in params.parameters():
        p.data = p.data.float()
    torch.cuda.empty_cache()
    full32 = full_logits(params, full_cfg.replace(dtype="float32"), seq, pl,
                         gen)
    _, cache32 = greedy(build_model(cfg.replace(dtype="float32")), params,
                        p2, pl + gen, gen, forced=gt[:, :gen])
    check_cache_path(f"{tag}, first {cb} requests, full forward at tile "
                     f"{GEMMA_FULL_TILE}", torch.stack(cache_bf, 1), full_bf,
                     torch.stack(cache32, 1), full32)
    del cache_bf, cache32, full_bf, full32, gt, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def gemma_small_cache(dev):
    """23(e): the Gemma3 smoke config in float32, card against CPU from
    the same parameters: the prefill logits of a 64-token prompt (longer
    than the window, 16), 3 decode steps fed the same tokens and the K/V
    cache after them, within phase 14's float32 tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import build_model
    cfg = get_smoke_config(GEMMA_ARCH).replace(dtype="float32")
    model = build_model(cfg)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card = model.init_params(torch.Generator(device=dev).manual_seed(0),
                             dev)
    card.load_state_dict(cpu.state_dict())
    l, steps = 64, 3
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, l + steps)))
    out = []
    with torch.inference_mode():
        for d_, params in ((dev, card), ("cpu", cpu)):
            lg, cache = model.prefill_fn(params, {"tokens": toks[:, :l].to(
                d_)}, l + steps)
            logits = [lg.float().cpu()]
            for i in range(steps):
                lg, cache = model.decode_fn(params, cache, toks[
                    :, l + i:l + i + 1].to(d_), l + i)
                logits.append(lg.float().cpu())
            out.append((logits, {k: c.float().cpu() for k, c in
                                 cache.items()}))
    rtol, atol = SMALL_SERVE_TOL["float32"]
    (lc, cc), (lp, cp) = out
    for i, (a, b_) in enumerate(zip(lc, lp)):
        torch.testing.assert_close(a, b_, rtol=rtol, atol=atol, msg=lambda m:
                                   f"[gemma3 small] step {i} logits: {m}")
    for k in cc:
        torch.testing.assert_close(cc[k], cp[k], rtol=rtol, atol=atol,
                                   msg=lambda m: f"[gemma3 small] cache {k}: "
                                                 f"{m}")
    log(f"[gemma3 small] smoke config float32, card against CPU: prefill "
        f"of {l} tokens (window {cfg.window}) and {steps} decode steps, "
        f"logits max |diff| "
        + ", ".join(f"{float((a - b_).abs().max()):.3g}"
                    for a, b_ in zip(lc, lp))
        + "; the K/V cache max |diff| "
        + ", ".join(f"{k} {float((cc[k] - cp[k]).abs().max()):.3g}"
                    for k in cc)
        + f" (within rtol {rtol}, atol {atol})")


def phase_gemma_train(dev):
    """23(d): Gemma3-12B at full width, GEMMA_TRAIN_LAYERS layers,
    TRAIN_STEPS `train_loop` AdamW steps of 2 x 2,048 (`train_full`): 12
    flash forwards (with the remat recompute) and 6 backwards a step, no
    plain call, then a profiled step. (e) the smoke config card against
    CPU, serving (`small_serve` in both dtypes, `gemma_small_cache`) and
    training (`smoke_train`). Returns (d)'s launches."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(GEMMA_ARCH).replace(n_layers=GEMMA_TRAIN_LAYERS)
    n = cfg.n_layers
    counts = train_full(dev, cfg, TRAIN_STEPS,
                        {FLASH[0]: 2 * n, FLASH_WGMMA[0]: 2 * n,
                         FLASH_BWD[0]: n, FLASH_BWD_WGMMA[0]: n, SSD[0]: 0,
                         SSD_BWD[0]: 0},
                        GEMMA_TRAIN_PARAMS,
                        what=" (of 48: cut for AdamW's memory; 5 local, 1 "
                             "global)", batch=GEMMA_TRAIN_BATCH,
                        seq=GEMMA_TRAIN_SEQ)
    for dtype in SMALL_SERVE_TOL:
        small_serve(dev, GEMMA_ARCH, dtype, "gemma3 small")
    gemma_small_cache(dev)
    smoke_train(dev, GEMMA_ARCH, (1,))
    return counts


# ------------------------------------------------------------- phase 24
# The MoE family. Qwen2-MoE-A2.7B serves at full width and depth (the
# reference's count_params_abstract: 15,146,928,128; 60 experts padded to
# 64, top 4, 4 shared) and DeepSeek-V3 at full width with its depth cut
# to 4 layers (its 3 dense layers and 1 MoE layer, and the MTP head:
# 15,797,352,448 parameters; all 61 layers are 671.7e9, and a second MoE
# layer's 11.5e9 beside the prefill's ~20 GB of dispatch buffers would
# not fit 80 GB), each through `generate`, 8 requests x prompt 4,096, 32
# tokens, as Gemma3's. Qwen2-MoE trains with AdamW at full width, its
# depth cut to MOE_TRAIN_LAYERS (4,253,874,176 parameters; 6 layers
# peaked at 58.05 GiB, 8 would need about 71 GiB, 24 about 182 GB), 5
# steps of 2 x 2,048 tokens, as many as phase 21(b)'s; DeepSeek-V3 trains
# with its Adafactor at its 3 dense layers and the MTP head
# (MLA_TRAIN_LAYERS).
MOE_ARCH, MLA_ARCH = "qwen2-moe-a2.7b", "deepseek-v3-671b"
MOE_PARAMS = 15_146_928_128
MLA_LAYERS, MLA_PARAMS = 4, 15_797_352_448
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS = 6, 4_253_874_176
MOE_BATCH, MOE_PROMPT, MOE_GEN = 8, 4096, 32
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 2048
# 24(a): the smoke configs card against CPU, float32: requests, prompt
# and decode steps
MOE_SMALL_BATCH, MOE_SMALL_PROMPT, MOE_SMALL_STEPS = 4, 64, 8
# the full Qwen2-MoE's dispatch at smoke size: 6 experts padded to 8,
# `hierarchical` (the flat form on one device); 256 prompt tokens x 2
# choices overflow the 80 places of some of the 6 experts
MOE_PADDED = dict(n_experts=6, top_k=2, n_shared=1, d_ff_expert=64,
                  n_experts_padded=8, dispatch="hierarchical")


def drops_of(idx, mcfg):
    """The slots dropped by each recorded call, at its own capacity."""
    from repro_torch.models import moe
    return [int(moe.dropped(i, mcfg.e_padded,
                            moe.capacity(i.shape[0], mcfg)).sum())
            for i in idx]


def close_f32(got, want, what):
    """Largest |got - want| of float32 results; raises past LM_TOL times
    max(1, largest |want|)."""
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not err <= LM_TOL["float32"] * scale:
        raise AssertionError(f"{what}: card and CPU differ by {err:.3g} "
                             f"(tolerance {LM_TOL['float32']} x "
                             f"{scale:.3g})")
    return err


def moe_small_serve(dev, arch, variant=""):
    """24(a): `arch`'s smoke config (with `variant` "padded": MOE_PADDED)
    in float32, card against CPU from the same parameters: a prefill and
    MOE_SMALL_STEPS decode steps fed the same tokens, every step's
    logits and the cache after them within LM_TOL, every router call's
    routes equal (so its drops), one flash launch a layer in the prefill
    and no plain call on the card."""
    import numpy as np
    import torch
    import _torch_parity as tp
    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model

    tag = f"moe small {arch}{' ' + variant if variant else ''}"
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if variant:
        cfg = cfg.replace(moe=MoEConfig(**MOE_PADDED))
    model = build_model(cfg)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card = model.init_params(torch.Generator(device=dev).manual_seed(0),
                             dev)
    card.load_state_dict(cpu.state_dict())
    b, l, steps = MOE_SMALL_BATCH, MOE_SMALL_PROMPT, MOE_SMALL_STEPS
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (b, l + steps)))
    out = []
    for d_, params in ((dev, card), ("cpu", cpu)):
        reset_lm_counts()
        with torch.inference_mode(), tp.RoutesRecorded() as r:
            lg, cache = model.prefill_fn(params, {"tokens": toks[:, :l].to(
                d_)}, l + steps)
            logits = [lg.float().cpu()]
            for i in range(steps):
                lg, cache = model.decode_fn(params, cache, toks[
                    :, l + i:l + i + 1].to(d_), l + i)
                logits.append(lg.float().cpu())
        out.append((logits, {k: c.float().cpu() for k, c in cache.items()},
                    [i.cpu() for i in r.idx], lm_counts()))
    (lc, cc, rc, (kc, pc)), (lp, cp, rp, _) = out
    if kc[FLASH[0]] != cfg.n_layers or pc or kc[FLASH_BWD[0]]:
        raise AssertionError(f"[{tag}] launches {kc}, {pc} plain calls on "
                             f"the card; expected {cfg.n_layers} flash "
                             f"forwards")
    check_wgmma_share(f"[{tag}]", cfg, kc)
    errs = [close_f32(a, b_, f"[{tag}] step {i} logits")
            for i, (a, b_) in enumerate(zip(lc, lp))]
    cerrs = {k: close_f32(cc[k], cp[k], f"[{tag}] cache {k}") for k in cc}
    if len(rc) != len(rp) or not all(torch.equal(a, b_)
                                     for a, b_ in zip(rc, rp)):
        raise AssertionError(f"[{tag}] the card's routes differ from the "
                             f"CPU's")
    n_moe = cfg.n_layers - cfg.moe.n_dense_layers
    drops = drops_of(rc, cfg.moe)
    log(f"[{tag}] smoke config float32, {cfg.moe.e_padded} experts "
        f"({cfg.moe.n_experts} real), top {cfg.moe.top_k}, "
        f"{'MLA, ' if cfg.mla else ''}{n_moe} MoE of {cfg.n_layers} "
        f"layers, card against CPU: prefill of {b} x {l} and {steps} "
        f"decode steps, logits max |diff| "
        + ", ".join(f"{e:.3g}" for e in errs) + "; cache "
        + ", ".join(f"{k} {e:.3g}" for k, e in cerrs.items())
        + f" (within {LM_TOL['float32']} x max(1, largest |value|)); "
        f"routes equal at all {len(rc)} router calls; slots dropped a "
        f"layer in the prefill {drops[:n_moe]} of {b * l * cfg.moe.top_k} "
        f"(capacity {moe.capacity(b * l, cfg.moe)}), in decode "
        f"{sum(drops[n_moe:])}; {kc[FLASH[0]]} flash_attention launches, "
        f"0 plain calls on the card")
    return sum(drops[:n_moe])


def extra_inputs(cfg, b, seed=0):
    """The VLM family's patches or the audio family's frames for `b`
    requests ({} for the others): N(0, 1) bfloat16 on the host, as
    `generate` draws them."""
    import numpy as np
    import torch
    n = {"vlm": ("patches", cfg.n_patches),
         "audio": ("frames", cfg.n_audio_frames)}.get(cfg.family)
    if n is None:
        return {}
    x = np.random.default_rng(seed).normal(size=(b, n[1], cfg.d_model))
    return {n[0]: torch.as_tensor(x, dtype=torch.float32).to(
        torch.bfloat16)}


def small_grads(dev, arch):
    """24(a), 25(a), 26(a): `arch`'s smoke config in float32, card
    against CPU from the same parameters: the loss, its terms ({"xent"},
    and "aux", "mtp" for DeepSeek-V3) within 1e-4 relative, every
    parameter's gradient within LM_TOL, the routes equal, and the card's
    flash launches (forward with the remat recompute, backward) matched
    one for one by the CPU's plain calls. The VLM's batch has patches,
    the audio family's frames."""
    import torch
    import _torch_parity as tp
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.kernels import flash_attention as pfa
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import build_model

    tag = f"small {arch} loss"
    cfg = get_smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    bt = host_batch(DataConfig(vocab=cfg.vocab, seq_len=64,
                               global_batch=4), 0)
    extra = extra_inputs(cfg, 4)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu",
                            trainable=True)
    card = model.init_params(torch.Generator(device=dev).manual_seed(0),
                             dev, trainable=True)
    with torch.no_grad():
        for a, b_ in zip(card.parameters(), cpu.parameters()):
            a.copy_(b_)
    res = []
    for d_, params in ((dev, card), ("cpu", cpu)):
        reset_lm_counts()
        with tp.RoutesRecorded() as r:
            loss, met = model.loss_fn(params, dict(
                to_device(bt, d_), **{k: x.to(d_)
                                      for k, x in extra.items()}))
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        res.append(({"loss": float(loss.detach()),
                     **{k: float(v.detach()) for k, v in met.items()}},
                    [g.float().cpu() for g in grads],
                    [i.cpu() for i in r.idx], lm_counts(), list(named)))
    (mc, gc_, rc, (kc, _), names), (mp, gp, rp, _, _) = res
    for k in mp:
        if not abs(mc[k] - mp[k]) <= 1e-4 * abs(mp[k]):
            raise AssertionError(f"[{tag}] {k}: card {mc[k]}, CPU {mp[k]}")
    gerr = max(close_f32(a, b_, f"[{tag}] gradient of {n}")
               for a, b_, n in zip(gc_, gp, names))
    if not all(torch.equal(a, b_) for a, b_ in zip(rc, rp)):
        raise AssertionError(f"[{tag}] the card's routes differ from the "
                             f"CPU's")
    fa = pfa.flash_attention
    want = (fa.plain_calls, fa.bwd_plain_calls)
    got = (kc[FLASH[0]], kc[FLASH_BWD[0]])
    if got != want or not all(got):
        raise AssertionError(f"[{tag}] card flash launches {got} (forward, "
                             f"backward), CPU plain calls {want}")
    log(f"[{tag}] smoke config float32, 4 x 64 tokens"
        + "".join(f" after {x.shape[1]} {k}" for k, x in extra.items())
        + ", card against CPU: "
        + ", ".join(f"{k} {mc[k]:.6f} (CPU {mp[k]:.6f})" for k in mp)
        + f"; every one of {len(gc_)} parameters' gradients within "
        f"{gerr:.3g} (limit {LM_TOL['float32']} x max(1, largest "
        f"|value|)); routes equal at {len(rc)} router calls; flash "
        f"launches {got[0]} forward (remat recompute included) and "
        f"{got[1]} backward, as many as the CPU's plain calls")


def phase_moe_small(dev):
    """24(a): the two smoke configs and Qwen2-MoE's padded, hierarchical
    variant served card against CPU (`moe_small_serve`), DeepSeek-V3's
    loss and gradients (`small_grads`); the padded variant's prefill
    must drop slots."""
    moe_small_serve(dev, MOE_ARCH)
    if not moe_small_serve(dev, MOE_ARCH, "padded"):
        raise AssertionError("[moe small] the padded variant's prefill "
                             "dropped no slot")
    moe_small_serve(dev, MLA_ARCH)
    small_grads(dev, MLA_ARCH)


def experts_bound(p, buf, filled):
    """Bytes (the three expert weight stacks and the buffer read once,
    the output written once) and operations (three products over the
    `filled` slots the tokens fill) over the card's peaks, ms."""
    e, c, d = buf.shape
    f = p["wi"].shape[-1]
    nbytes = (3 * e * d * f + 2 * e * c * d) * buf.element_size()
    ops = 3 * 2 * d * f * filled
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3


def moe_serve_full(dev, cfg, n_params, what=""):
    """24(b), (c): `cfg` in bfloat16 through `generate` on the card,
    MOE_BATCH requests x prompt MOE_PROMPT, MOE_GEN tokens: one
    `flash_attention` launch a layer a prefill and no plain call; the
    prefill and decode rates, peak memory and the slots each MoE layer
    dropped in the prefill; the first layer's flash kernel on its own
    tensors (against plain, SDPA and the bound); the first MoE layer's
    expert products on its own buffer, timed and scaled to the prefill's
    MoE layers; then the prefill and 8 decode steps under torch.profiler
    (flash's share of the device time). Returns the generate run's
    launches."""
    import gc

    import numpy as np
    import torch
    import _torch_parity as tp
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.model import build_model, count_params
    from repro_torch.models.transformer import layer_counts

    tag = f"serve {cfg.name}"
    b, pl, gen = MOE_BATCH, MOE_PROMPT, MOE_GEN
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    n = count_params(params)
    n_dense, n_moe = layer_counts(cfg)
    m = cfg.moe
    log(f"[{tag}] {cfg.n_layers} layers{what} ({n_dense} dense, {n_moe} "
        f"MoE: {m.e_padded} experts ({m.n_experts} real), top {m.top_k}, "
        f"{m.n_shared} shared of {m.d_ff_expert}), "
        + (f"MLA (q·k {cfg.mla.qk_nope_head_dim} + "
           f"{cfg.mla.qk_rope_head_dim}, v {cfg.mla.v_head_dim}), "
           if cfg.mla else "GQA, ")
        + f"{'MTP, ' if cfg.use_mtp else ''}d_model {cfg.d_model}, "
        f"{cfg.dtype}: {n} parameters initialised on the card in "
        f"{time.perf_counter() - t0:.1f}s; memory_allocated "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    if n != n_params:
        raise AssertionError(f"{tag}: {n} parameters, the reference counts "
                             f"{n_params}")
    serve.generate(cfg, batch=b, prompt_len=pl, gen=2, params=params,
                   device=dev, log=lambda *a: None)       # warm-up
    reset_lm_counts()
    with tp.RoutesRecorded() as r:
        toks, stats = serve.generate(cfg, batch=b, prompt_len=pl, gen=gen,
                                     params=params, device=dev, log=log)
    counts, plain = lm_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if counts[FLASH[0]] != cfg.n_layers or plain or any(
            v for k, v in counts.items() if k not in FLASH_FWD) or \
            counts[FLASH_WGMMA[0]] != wgmma_share(cfg, cfg.n_layers):
        raise AssertionError(f"{tag}: launches {counts}, {plain} plain "
                             f"calls; expected {cfg.n_layers} flash "
                             f"forwards a prefill, "
                             f"{wgmma_share(cfg, cfg.n_layers)} of them "
                             f"{FLASH_WGMMA[0]}")
    if toks.shape != (b, gen) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{tag}: tokens {toks.shape}")
    if len(r.idx) != n_moe * gen:
        raise AssertionError(f"{tag}: {len(r.idx)} router calls, expected "
                             f"{n_moe * gen}")
    drops = drops_of(r.idx, m)
    slots = b * pl * m.top_k
    cap = moe.capacity(b * pl, m)
    del r
    log(f"[{tag}] {b} requests x prompt {pl}, {gen} tokens each: prefill "
        f"{stats['prefill_s'] * 1e3:.1f} ms = "
        f"{b * pl / stats['prefill_s']:.1f} prefill tokens/s; {gen - 1} "
        f"decode steps {stats['decode_s']:.3f}s = "
        f"{(gen - 1) * b / stats['decode_s']:.1f} decode tokens/s "
        f"({stats['decode_s'] / (gen - 1) * 1e3:.2f} ms a step); "
        f"{counts[FLASH[0]]} flash_attention launches a prefill, 0 plain "
        f"calls; max_memory_allocated {peak / 2**30:.2f} GiB ({peak} "
        f"bytes); slots dropped a MoE layer in the prefill, of {slots} "
        f"({m.e_padded} experts x capacity {cap} places): "
        f"{drops[:n_moe]} (share {sum(drops[:n_moe]) / (slots * n_moe):.5f}"
        f"); in {gen - 1} decode steps {sum(drops[n_moe:])}")

    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, pl)), device=dev)
    seen = capture_first_kernels(model, params, prompt, pl + gen)
    (p, buf), _, _ = seen.pop("experts")
    check_first_kernels(tag, seen)
    del seen
    gc.collect()
    torch.cuda.empty_cache()
    filled = slots - drops[0]
    ms = timed(lambda: moe.experts(p, buf), 5)
    bb, bo = experts_bound(p, buf, filled)
    log(f"[{tag}] the first MoE layer's expert products (3 torch.bmm on "
        f"its ({buf.shape[0]}, {buf.shape[1]}, {buf.shape[2]}) buffer, "
        f"{filled} of its {buf.shape[0] * buf.shape[1]} places filled): "
        f"{ms:.4f} ms, bound {max(bb, bo):.4f} ms (bytes {bb:.4f}, "
        f"operations {bo:.4f} over the filled places); x {n_moe} MoE "
        f"layers = {ms * n_moe:.1f} ms = share "
        f"{ms * n_moe / (stats['prefill_s'] * 1e3):.3f} of the prefill's "
        f"{stats['prefill_s'] * 1e3:.1f} ms")
    del p, buf
    t0 = time.perf_counter()
    run, wall, busy, rows = profiled(lambda: serve.generate(
        cfg, batch=b, prompt_len=pl, gen=FULL_PROFILE_GEN, params=params,
        device=dev, log=lambda *a: None), cpu=False)
    if busy is None:
        log(f"[{tag}] the profiler saw no device activity: device busy "
            f"share not measured")
    else:
        log(f"[{tag}] under torch.profiler (prefill and "
            f"{FULL_PROFILE_GEN - 1} decode steps): {wall:.2f}s wall "
            f"(prefill {run[1]['prefill_s']:.3f}s, decode "
            f"{run[1]['decode_s']:.3f}s inside generate), device busy "
            f"{busy:.3f}s = share {busy / wall:.4f} of the wall; reading "
            f"the trace took {time.perf_counter() - t0 - wall:.1f}s")
        log_rows(tag, device_time_by_layer(tag, rows), 8)
    del run, rows, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_moe_serve(dev):
    """24(b): Qwen2-MoE-A2.7B at full width and depth; (c): DeepSeek-V3
    at full width, MLA_LAYERS layers (`moe_serve_full`). Returns both
    generate runs' launches."""
    from repro_torch.configs.registry import get_config
    counts = moe_serve_full(dev, get_config(MOE_ARCH), MOE_PARAMS)
    cfg = get_config(MLA_ARCH).replace(n_layers=MLA_LAYERS)
    for k, v in moe_serve_full(dev, cfg, MLA_PARAMS,
                               " (of 61: cut to fit one card)").items():
        counts[k] += v
    return counts


def flash_bwd_alone(tag, q, k, v, causal, t):
    """flash_attention_bwd on q, k, v (BH, L, D) and a random dO: each
    gradient and the forward within LM_TOL of the plain versions, two
    launches the same bits, then timed with CUDA events beside the plain
    version, SDPA's backward ((forward + backward) - forward, PyTorch's
    choice of backend) and the bound, and both backwards by their
    kernels' device time (torch.profiler), logged by kernel. Returns the
    row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as pfa
    dev = q.device
    g = torch.Generator(device=dev).manual_seed(q.shape[1])
    do = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    o, lse = pfa._forward(q, k, v, causal, t, t, 0, dev, True)
    what = (f"BH {q.shape[0]} x L {q.shape[1]} x D {q.shape[2]}, "
            f"{'causal' if causal else 'non-causal'}, tile {t}, {q.dtype}")
    lm_err(o, pfa.flash_attention_plain(q, k, v, causal=causal, tq=t, tk=t),
           f"{tag} flash forward {what}")
    got = pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, tq=t,
                                  tk=t, device=dev)
    again = pfa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                    tq=t, tk=t, device=dev)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag} flash backward {what}: two launches on "
                             f"the same inputs differ")
    want = pfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         tq=t, tk=t)
    errs = [lm_err(a, b, f"{tag} flash backward d{n} {what}")
            for n, a, b in zip("qkv", got, want)]
    del again, want
    qs, ks, vs = (x[None].detach().requires_grad_() for x in (q, k, v))

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        torch.autograd.grad(out, (qs, ks, vs), do[None])
    lib = timed(sdpa_fwd_bwd, 10) - timed(sdpa_fwd, 10)
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    ours = kernel_device_ms(lambda: pfa.flash_attention_bwd(
        q, k, v, o, do, lse, causal=causal, tq=t, tk=t, device=dev), 10)
    sdpa = kernel_device_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), do[None], retain_graph=True), 10)
    del out
    row = dict(ms=timed(lambda: pfa.flash_attention_bwd(
                   q, k, v, o, do, lse, causal=causal, tq=t, tk=t,
                   device=dev), 10),
               plain_ms=timed(lambda: pfa.flash_attention_bwd_plain(
                   q, k, v, o, do, lse, causal=causal, tq=t, tk=t), 2),
               library_ms=lib, bounds=flash_bwd_bound(q, t, t, causal),
               err=max(errs))
    dev_ms = "; ".join(
        f"{n} " + ("not measured (records lost)" if ms is None else
                   f"{sum(x for x, _ in ms.values()):.4f} ms ("
                   + ", ".join(f"{k} {x:.4f}" for k, (x, _) in ms.items())
                   + ")")
        for n, ms in (("flash_attention_bwd", ours), ("SDPA's", sdpa)))
    log(f"[{tag}] flash_attention_bwd alone ({what}): kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, SDPA's "
        f"backward {lib:.4f} ms ((forward + backward) - forward), bound "
        f"{max(row['bounds']):.4f} ms (bytes {row['bounds'][0]:.4f}, "
        f"operations {row['bounds'][1]:.4f}); device time a call: {dev_ms}; "
        f"max |kernel - plain| dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv "
        f"{errs[2]:.3g} (within {LM_TOL[str(q.dtype)[6:]]} x max(1, "
        f"largest |gradient|)); two launches the same bits")
    torch.cuda.empty_cache()
    return row


def phase_moe_train(dev):
    """24(d): Qwen2-MoE-A2.7B at full width, MOE_TRAIN_LAYERS layers,
    TRAIN_STEPS `train_loop` AdamW steps of 2 x 2,048 (`train_full`):
    2 flash forwards (with the remat recompute) and 1 backward a layer a
    step, no plain call, each step's xent, aux and loss finite, then a
    profiled step. DeepSeek-V3 with its Adafactor over the reference's
    stacked leaves: the smoke config card against CPU (`smoke_train`),
    then at full width, its 3 dense layers and the MTP head (MLA at D
    192), TRAIN_STEPS `train_loop` steps of 2 x 2,048: 7 flash forwards
    (3 layers with their remat recompute, the MTP layer's) and 4
    backwards a step; then the D 192 backward alone at that step's
    shape (`flash_bwd_alone`). Returns the steps' launches."""
    import dataclasses as dc

    import torch
    from repro_torch.configs.registry import get_config
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    n = cfg.n_layers
    counts = train_full(dev, cfg, TRAIN_STEPS,
                        {FLASH[0]: 2 * n, FLASH_WGMMA[0]: 2 * n,
                         FLASH_BWD[0]: n, FLASH_BWD_WGMMA[0]: n, SSD[0]: 0,
                         SSD_BWD[0]: 0},
                        MOE_TRAIN_PARAMS,
                        what=" (of 24: cut for AdamW's memory)",
                        batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ)
    smoke_train(dev, MLA_ARCH, (1,))
    full = get_config(MLA_ARCH)
    n = MLA_TRAIN_LAYERS
    cfg = full.replace(n_layers=n, moe=dc.replace(full.moe,
                                                  n_dense_layers=n))
    for k, v in train_full(
            dev, cfg, TRAIN_STEPS,
            {FLASH[0]: 2 * n + 1, FLASH_WGMMA[0]: 2 * n + 1,
             FLASH_BWD[0]: n + 1, FLASH_BWD_WGMMA[0]: n + 1, SSD[0]: 0,
             SSD_BWD[0]: 0},
            MLA_TRAIN_PARAMS,
            what=" (of 61: its 3 dense layers; a full-width MoE layer's "
                 "weights and gradients alone are 45 GB)",
            batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ).items():
        counts[k] += v
    g = torch.Generator(device=dev).manual_seed(24)
    d = full.mla.qk_nope_head_dim + full.mla.qk_rope_head_dim
    shape = (MOE_TRAIN_BATCH * full.n_heads, MOE_TRAIN_SEQ, d)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    flash_bwd_alone(f"train {MLA_ARCH}", q, k, v, True,
                    min(full.attn_chunk, MOE_TRAIN_SEQ))
    return counts


# ------------------------------------------------------- phases 25, 26
# 25: LLaVA-NeXT-34B at full width and depth (34,388,917,248 bfloat16
# parameters, 64.06 GiB), 8 requests x (576 patches + 1,472 tokens =
# 2,048 positions, tile 1,024), 32 tokens. 26: Whisper-tiny at full size
# (61,153,536), 64 requests x 1,500 frames, a 4-token prompt, 60 tokens;
# 5 AdamW steps of 16 x (1,500 frames, 448 tokens). Counts from the
# reference's `count_params_abstract`.
VLM_ARCH, VLM_PARAMS = "llava-next-34b", 34_388_917_248
VLM_BATCH, VLM_PROMPT, VLM_GEN = 8, 1472, 32
AUDIO_ARCH, AUDIO_PARAMS = "whisper-tiny", 61_153_536
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_GEN = 64, 4, 60
AUDIO_TRAIN_BATCH, AUDIO_TRAIN_SEQ = 16, 448
MLA_TRAIN_LAYERS, MLA_TRAIN_PARAMS = 3, 4_290_066_432
SMALL_STEPS = 3


def family_small_serve(dev, arch, dtype):
    """25(a), 26(a): `arch`'s smoke config (`dtype`) on the card and the
    CPU from the same parameters and the same patches or frames: a
    prefill of 4 x 16 tokens and SMALL_STEPS decode steps fed the same
    tokens, every step's logits and the cache within LM_TOL (float32) or
    SMALL_SERVE_TOL (bfloat16), one flash launch a layer (the
    encoder-decoder's: each encoder and decoder layer) and no plain call
    on the card."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import build_model

    tag = f"{arch} small"
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    model = build_model(cfg)
    cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    card = model.init_params(torch.Generator(device=dev).manual_seed(0),
                             dev)
    card.load_state_dict(cpu.state_dict())
    b, l, steps = 4, 16, SMALL_STEPS
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (b, l + steps)))
    extra = extra_inputs(cfg, b, seed=6)
    pre = cfg.n_patches if cfg.family == "vlm" else 0
    out = []
    for d_, params in ((dev, card), ("cpu", cpu)):
        reset_lm_counts()
        with torch.inference_mode():
            batch = dict({k: x.to(d_) for k, x in extra.items()},
                         tokens=toks[:, :l].to(d_))
            lg, cache = model.prefill_fn(params, batch, pre + l + steps)
            logits = [lg.float().cpu()]
            for i in range(steps):
                lg, cache = model.decode_fn(params, cache, toks[
                    :, l + i:l + i + 1].to(d_), pre + l + i)
                logits.append(lg.float().cpu())
        out.append((logits, {k: c.float().cpu() for k, c in cache.items()},
                    lm_counts()))
    (lc, cc, (kc, pc)), (lp, cp, _) = out
    n_fl = cfg.n_layers + cfg.n_enc_layers
    if kc[FLASH[0]] != n_fl or pc or kc[FLASH_BWD[0]]:
        raise AssertionError(f"[{tag}] launches {kc}, {pc} plain calls on "
                             f"the card; expected {n_fl} flash forwards")
    check_wgmma_share(f"[{tag}]", cfg, kc)
    pairs = [(f"step {i} logits", a, b_) for i, (a, b_) in
             enumerate(zip(lc, lp))] + [(f"cache {k}", cc[k], cp[k])
                                        for k in cc]
    if dtype == "float32":
        errs = [close_f32(a, b_, f"[{tag}] {w}") for w, a, b_ in pairs]
        tol = f"{LM_TOL['float32']} x max(1, largest |value|)"
    else:
        rtol, atol = SMALL_SERVE_TOL[dtype]
        for w, a, b_ in pairs:
            torch.testing.assert_close(a, b_, rtol=rtol, atol=atol,
                                       msg=lambda m: f"[{tag}] {w}: {m}")
        errs = [float((a - b_).abs().max()) for _, a, b_ in pairs]
        tol = f"rtol {rtol}, atol {atol}"
    log(f"[{tag}] smoke config {dtype}, card against CPU: prefill of {b} "
        f"x {l} tokens" + "".join(f" after {x.shape[1]} {k}"
                                  for k, x in extra.items())
        + f" and {steps} decode steps: max |diff| "
        + ", ".join(f"{w} {e:.3g}" for (w, _, _), e in zip(pairs, errs))
        + f" (within {tol}); {kc[FLASH[0]]} flash_attention launches, 0 "
        f"plain calls on the card")


def serve_family_full(dev, cfg, n_params, b, pl, gen):
    """25(b), 26(b): `cfg` in bfloat16 through `generate` on the card
    (random parameters from a seed; patches or frames drawn by
    `generate`), b requests x prompt pl, gen tokens, after a one-request
    warm-up: the flash launches of one prefill (a layer; the
    encoder-decoder's every layer) and no plain call or other kernel,
    the prefill and decode rates (the prefill's counting the patches;
    the encoder's frames a second), peak memory; FULL_PROFILE_GEN - 1
    decode steps after one more prefill under torch.profiler (the
    device's busy share, its time by layer); then the first flash call
    of one more prefill, captured, its tensors checked and timed with
    the parameters freed (`check_first_kernels`). Returns (the generate
    run's launches, the captured flash call, as tensors outside
    inference mode)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, count_params

    tag = f"serve {cfg.name}"
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev)
    torch.cuda.synchronize()
    n = count_params(params)
    log(f"[{tag}] {cfg.family}, {cfg.n_layers} layers"
        + (f" ({cfg.n_enc_layers} encoder layers)" if cfg.n_enc_layers
           else "") + f", d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv_heads} KV) of {cfg.resolved_head_dim}, {cfg.dtype}: "
        f"{n} parameters initialised on the card in "
        f"{time.perf_counter() - t0:.1f}s; memory_allocated "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    if n != n_params:
        raise AssertionError(f"{tag}: {n} parameters, the reference counts "
                             f"{n_params}")
    serve.generate(cfg, batch=1, prompt_len=pl, gen=2, params=params,
                   device=dev, log=lambda *a: None)       # warm-up
    reset_lm_counts()
    toks, stats = serve.generate(cfg, batch=b, prompt_len=pl, gen=gen,
                                 params=params, device=dev, log=log)
    counts, plain = lm_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_fl = cfg.n_layers + cfg.n_enc_layers
    if counts[FLASH[0]] != n_fl or plain or any(
            v for k, v in counts.items() if k not in FLASH_FWD) or \
            counts[FLASH_WGMMA[0]] != wgmma_share(cfg, n_fl):
        raise AssertionError(f"{tag}: launches {counts}, {plain} plain "
                             f"calls; expected {n_fl} flash forwards a "
                             f"prefill")
    if toks.shape != (b, gen) or not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{tag}: tokens {toks.shape}")
    pre = cfg.n_patches if cfg.family == "vlm" else 0
    rates = (f"prefill {stats['prefill_s'] * 1e3:.1f} ms = "
             f"{b * (pre + pl) / stats['prefill_s']:.1f} prefill "
             f"positions/s ({pre} patches + {pl} tokens a request)"
             if cfg.family == "vlm" else
             f"prefill (encoder and prompt) {stats['prefill_s'] * 1e3:.1f} "
             f"ms = {b * cfg.n_audio_frames / stats['prefill_s']:.1f} "
             f"encoder frames/s")
    log(f"[{tag}] {b} requests x prompt {pl}, {gen} tokens each: {rates}; "
        f"{gen - 1} decode steps {stats['decode_s']:.3f}s = "
        f"{(gen - 1) * b / stats['decode_s']:.1f} decode tokens/s "
        f"({stats['decode_s'] / (gen - 1) * 1e3:.2f} ms a step); "
        f"{counts[FLASH[0]]} flash_attention launches a prefill, 0 plain "
        f"calls; max_memory_allocated {peak / 2**30:.2f} GiB ({peak} "
        f"bytes)")
    prompt = dict({k: x.to(dev) for k, x in extra_inputs(cfg, b).items()},
                  tokens=torch.as_tensor(np.random.default_rng(0).integers(
                      0, cfg.vocab, (b, pl)), device=dev))
    with torch.inference_mode():
        logits, cache = model.prefill_fn(params, prompt, pre + pl + gen)
        tok = torch.argmax(logits[..., :cfg.vocab], -1)
        del logits
        n_dec = FULL_PROFILE_GEN - 1

        def decode():
            for i in range(n_dec):
                model.decode_fn(params, cache, tok, pre + pl + i)
        _, wall, busy, rows = profiled(decode, cpu=False)
    del cache, tok
    gc.collect()
    torch.cuda.empty_cache()
    if busy is None:
        log(f"[{tag}] the profiler saw no device activity: device busy "
            f"share not measured")
    else:
        log(f"[{tag}] {n_dec} decode steps under torch.profiler: "
            f"{wall * 1e3:.1f} ms wall ({wall / n_dec * 1e3:.2f} ms a "
            f"step), device busy {busy * 1e3:.1f} ms = share "
            f"{busy / wall:.4f}")
        log_rows(tag, device_time_by_layer(tag, rows), 6)
    seen = capture_first_kernels(model, params, prompt, pre + pl + gen)
    del params, prompt
    gc.collect()
    torch.cuda.empty_cache()
    check_first_kernels(tag, seen)
    (q, k, v), kw, _ = seen["flash"]
    return counts, ((q.clone(), k.clone(), v.clone()), kw)


def phase_vlm(dev):
    """25: (a) the LLaVA-NeXT smoke config card against CPU, served in
    float32 and bfloat16 (`family_small_serve`), its loss and every
    gradient in float32 (`small_grads`); (b) LLaVA-NeXT-34B at full width
    and depth through `generate` (`serve_family_full`): 60 flash launches
    a prefill, the first layer's (BH 448 x 2,048 x 128, causal, tile
    1,024) against plain, SDPA and the bound. Returns the launches."""
    from repro_torch.configs.registry import get_config
    for dtype in ("float32", "bfloat16"):
        family_small_serve(dev, VLM_ARCH, dtype)
    small_grads(dev, VLM_ARCH)
    counts, _ = serve_family_full(dev, get_config(VLM_ARCH), VLM_PARAMS,
                                  VLM_BATCH, VLM_PROMPT, VLM_GEN)
    return counts


def audio_train(dev, cfg, steps):
    """26(c): `steps` `make_train_step` steps (the config's AdamW) of
    AUDIO_TRAIN_BATCH x (1,500 frames, 448 tokens) from a seed: finite
    losses, 2 flash forwards (with the remat recompute) and 1 backward
    an encoder or decoder layer a step, no plain call; the median step
    of steps 2 on, target tokens/s, peak memory. Returns the launches."""
    import gc

    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.train import to_device
    from repro_torch.models.model import build_model

    tag = f"train {cfg.name}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg)
    opt_init, step_fn = psteps.make_train_step(model)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dev, trainable=True)
    state = opt_init(params)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=AUDIO_TRAIN_SEQ,
                      global_batch=AUDIO_TRAIN_BATCH)
    reset_lm_counts()
    losses, dts = [], []
    for step in range(steps):
        bt = dict(to_device(host_batch(dcfg, step), dev),
                  **{k: x.to(dev) for k, x in extra_inputs(
                      cfg, AUDIO_TRAIN_BATCH, seed=step).items()})
        t0 = time.perf_counter()
        params, state, met = step_fn(params, state, bt, step)
        losses.append(float(met["loss"].item()))
        dts.append(time.perf_counter() - t0)
    counts, plain = lm_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_fl = cfg.n_layers + cfg.n_enc_layers
    want = {FLASH[0]: 2 * n_fl * steps, FLASH_BWD[0]: n_fl * steps}
    if {k: counts[k] for k in want} != want or plain:
        raise AssertionError(f"{tag}: launches {counts}, {plain} plain "
                             f"calls; expected {want}")
    check_wgmma_share(tag, cfg, counts)
    check_bwd_wgmma_share(tag, cfg, counts)
    check_ssd_wgmma_share(tag, cfg, counts[SSD[0]])
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    step_s = float(np.median(dts[1:]))
    tokens = AUDIO_TRAIN_BATCH * AUDIO_TRAIN_SEQ
    log(f"[{tag}] {cfg.optimizer}, remat {cfg.remat}, {cfg.dtype}: "
        f"{steps} steps of {AUDIO_TRAIN_BATCH} x ({cfg.n_audio_frames} "
        f"frames, {AUDIO_TRAIN_SEQ} tokens); losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step times "
        f"{', '.join(f'{x * 1e3:.1f}' for x in dts)} ms; median of steps "
        f"2-{steps} {step_s * 1e3:.2f} ms = {tokens / step_s:.1f} target "
        f"tokens/s ({AUDIO_TRAIN_BATCH * cfg.n_audio_frames / step_s:.1f} "
        f"frames/s); launches a step: {2 * n_fl} flash_attention (with "
        f"the remat recompute), {n_fl} flash_attention_bwd, 0 plain calls; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes)")
    del params, state, bt
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_audio(dev):
    """26: (a) the Whisper smoke config (D 12) card against CPU, served in
    float32 and bfloat16, its loss and every gradient in float32; (b)
    Whisper-tiny at full size through `generate` (`serve_family_full`):
    8 flash launches a prefill, the first encoder layer's (BH 384 x 1,500
    x 64, non-causal, one tile of 1,500: past the kernel's 64-row blocks
    a ragged last block) against plain, SDPA and the bound, then its
    backward alone on those tensors (`flash_bwd_alone`); (c) 5 AdamW
    steps (`audio_train`). Returns the launches."""
    from repro_torch.configs.registry import get_config
    for dtype in ("float32", "bfloat16"):
        family_small_serve(dev, AUDIO_ARCH, dtype)
    small_grads(dev, AUDIO_ARCH)
    cfg = get_config(AUDIO_ARCH)
    counts, ((q, k, v), kw) = serve_family_full(
        dev, cfg, AUDIO_PARAMS, AUDIO_BATCH, AUDIO_PROMPT, AUDIO_GEN)
    if kw["causal"] or kw["tq"] != cfg.n_audio_frames:
        raise AssertionError(f"[serve {cfg.name}] the first flash call is "
                             f"not the encoder's: {kw}")
    flash_bwd_alone(f"serve {cfg.name}", q, k, v, False, kw["tq"])
    del q, k, v
    for k_, v_ in audio_train(dev, cfg, TRAIN_STEPS).items():
        counts[k_] += v_
    return counts


# ------------------------------------------------------------- phase 27
# the data-parallel cell: phase 21(b)'s Qwen2-1.5B at 8 x 512, 3 steps
MESH_STEPS = 3


def roofline_cell():
    """`launch/dryrun.py::analyze_cell` of phase 27's train cell on one
    chip, traced on fake tensors (in a CPU worker process): the result
    dict and the trace's wall seconds."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch.dryrun import analyze_cell
    t0 = time.perf_counter()
    res = analyze_cell(get_config(TRAIN_ARCH),
                       ShapeConfig("train_8x512", TRAIN_SEQ, TRAIN_BATCH,
                                   "train"),
                       AbstractMesh(("data", "model"), (1, 1)))
    return res, time.perf_counter() - t0


def torch_equal(x, y) -> bool:
    """Same dtype, shape and bits."""
    import torch
    return x.dtype == y.dtype and torch.equal(x, y)


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(map(torch_equal, a, b))


def phase_mesh(dev, cpu_runs):
    """27 (the module docstring's list): the host mesh, data-parallel
    Qwen2-1.5B against the same steps without a mesh, elastic resume,
    the compressed all-reduce against the CPU and the roofline beside
    the measured step. Returns the launches of (b)'s six steps, and (b)'s
    run without a mesh for phase 28: {"losses", "peak", "step_ms"}."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.distributed import compression, meshctx
    from repro_torch.distributed.elastic import resume_elastic
    from repro_torch.distributed.sharding import mesh_shape
    from repro_torch.launch import steps as psteps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models.model import build_model

    # (a)
    mesh = make_host_mesh()
    shape = mesh_shape(mesh)
    group = meshctx.batch_group(mesh)
    if shape != {"data": 1, "model": 1} or dist.get_backend(group) != "nccl":
        raise AssertionError(f"[mesh] host mesh {shape}, backend "
                             f"{dist.get_backend(group)}")
    log(f"[mesh] make_host_mesh(): {mesh}, axes {shape}, backend "
        f"{dist.get_backend(group)}, world {dist.get_world_size()}")

    # (b) 3 steps without a mesh, then on it
    cfg = get_config(TRAIN_ARCH)
    kw = dict(cfg=cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              log=lambda *a: None)
    gc.collect()
    torch.cuda.empty_cache()
    reset_lm_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    plain = train_loop(steps=MESH_STEPS, ckpt_dir="", device=dev, **kw)
    plain_peak = torch.cuda.max_memory_allocated(dev)
    want = [p.detach().clone() for p in plain["params"].parameters()]
    want_losses, want_dts = plain["losses"], plain["dts"]
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    d = os.path.join(ROOT, "build", "chip_smoke_mesh_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        run = train_loop(steps=MESH_STEPS - 1, ckpt_dir=d, mesh=mesh, **kw)
        mesh_wall = time.perf_counter() - t0
        at2 = [p.detach().clone() for p in run["params"].parameters()]
        losses, dts = run["losses"], run["dts"]
        del run
        gc.collect()
        torch.cuda.empty_cache()
        # (c) resume the step-2 checkpoint onto the mesh, then step 3
        model = build_model(cfg)
        opt_init, step_fn = psteps.make_train_step(model, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, step = resume_elastic(d, model, opt_init, mesh)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(r, f))
                       for r, _, fs in os.walk(d) for f in fs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if step != MESH_STEPS - 1 or not same_bits(list(params.parameters()),
                                               at2):
        raise AssertionError(f"[mesh] resume_elastic: step {step}, or the "
                             f"parameters differ from the mesh run's")
    del at2
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    bt = to_device(host_batch(dcfg, step), dev)
    with meshctx.mesh_context(mesh):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, bt, step)
        losses.append(float(m["loss"].item()))
        dts.append(time.perf_counter() - t0)
    counts, plain_calls = lm_counts()
    per = {FLASH[0]: 2 * cfg.n_layers, FLASH_BWD[0]: cfg.n_layers}
    if {k: counts[k] for k in per} != {
            k: v * 2 * MESH_STEPS for k, v in per.items()} or plain_calls:
        raise AssertionError(f"[mesh] launches {counts}, {plain_calls} plain "
                             f"calls")
    check_wgmma_share("[mesh]", cfg, counts)
    check_bwd_wgmma_share("[mesh]", cfg, counts)
    if losses != want_losses or not same_bits(list(params.parameters()),
                                              want):
        raise AssertionError(f"[mesh] data-parallel losses {losses} vs "
                             f"{want_losses}, or the parameters differ")
    del want
    step_ms = float(np.median(dts[1:])) * 1e3
    plain_ms = float(np.median(want_dts[1:])) * 1e3
    named = {k: p.detach() for k, p in params.named_parameters()}
    loss0 = torch.zeros((), device=dev)
    psteps.mean_over(group, named, {"xent": loss0})       # warm
    reduce_ms = events_ms(lambda: psteps.mean_over(
        group, named, {"xent": loss0}), reps=3)
    n_el = sum(p.numel() for p in named.values())
    log(f"[mesh] (b) {cfg.name} at full size ({n_el} parameters), "
        f"{MESH_STEPS} AdamW steps of {TRAIN_BATCH} x {TRAIN_SEQ} on the "
        f"(1, 1) mesh against the same steps without one: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)} and every parameter "
        f"equal bit for bit; median step of steps 2-{MESH_STEPS} "
        f"{step_ms:.2f} ms on the mesh, {plain_ms:.2f} ms without "
        f"(steps {', '.join(f'{x * 1e3:.1f}' for x in dts)} and "
        f"{', '.join(f'{x * 1e3:.1f}' for x in want_dts)} ms); the "
        f"gradient mean over the one-rank NCCL group (one float32 "
        f"all-reduce of {n_el} values, packed and unpacked) "
        f"{reduce_ms:.3f} ms a step (CUDA events); launches {counts}, no "
        f"plain call")
    log(f"[mesh] (c) resume_elastic of the step-{step} checkpoint "
        f"({ck_bytes / 1e9:.2f} GB; the mesh run's init, {step} steps and "
        f"save took {mesh_wall:.1f}s) onto the mesh in {resume_s:.1f}s: "
        f"parameters bit-equal to the mesh run's at step {step}; step "
        f"{step + 1}'s loss {losses[-1]:.6f} equal to the uninterrupted "
        f"run's")

    # (d) the compressed all-reduce on embed's and layer 0's gradients
    names = ["embed"] + [k for k in named if k.startswith("layers.0.")]
    loss, _ = model.loss_fn(params, bt)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [dict(params.named_parameters())[k] for k in names])))
    del loss, opt
    cpu_g = {k: g.cpu() for k, g in grads.items()}
    res, cpu_res = (compression.init_residuals(grads),
                    compression.init_residuals(cpu_g))
    for i in range(2):
        mean, res = compression.compressed_allreduce(grads, res, group)
        cmean, cpu_res = compression.compressed_allreduce(cpu_g, cpu_res)
        for k in names:
            if not (torch_equal(mean[k].cpu(), cmean[k])
                    and torch_equal(res[k].cpu(), cpu_res[k])):
                raise AssertionError(f"[mesh] compressed_allreduce step {i} "
                                     f"{k}: card and CPU differ")
    comp_ms = events_ms(lambda: compression.compressed_allreduce(
        grads, res, group), reps=3)
    n = sum(g.numel() for g in grads.values())
    # each gradient (bfloat16) and residual (float32) read once, each mean
    # (bfloat16) and residual written once
    nbytes = sum(g.numel() * (2 * g.element_size() + 8)
                 for g in grads.values())
    log(f"[mesh] (d) compressed_allreduce over the one-rank NCCL group on "
        f"{len(names)} gradients ({n} values: embed and layer 0), two "
        f"error-feedback steps bit-equal to the same call on the CPU; "
        f"{comp_ms:.3f} ms a call (CUDA events), {nbytes / 1e9:.3f} GB "
        f"moved at least = {nbytes / comp_ms / 1e6:.1f} GB/s, bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    del grads, mean, res, cpu_g, cmean, cpu_res, params, named
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # (e) the roofline of (b)'s cell beside its measured step
    cell, trace_s = cpu_runs["roofline"].result()
    rf = cell["roofline"]
    log(f"[mesh] (e) analyze_cell of {cfg.name} train {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} on one chip (fake tensors, {trace_s:.1f}s in a CPU "
        f"worker): {cell['hlo']['flops_per_device']:.4g} operations, "
        f"{cell['hlo']['bytes_per_device']:.4g} bytes a step (eager "
        f"ops' inputs and outputs); terms compute "
        f"{rf['compute_s'] * 1e3:.2f} ms, memory {rf['memory_s'] * 1e3:.2f} "
        f"ms, collective {rf['collective_s'] * 1e3:.2f} ms (bottleneck "
        f"{rf['bottleneck']}); model FLOPs {rf['model_flops']:.4g}, ideal "
        f"step {rf['ideal_step_s'] * 1e3:.2f} ms at "
        f"{rf['card']['name']}'s {rf['card']['bf16_ops_per_s']:.4g}/s, "
        f"{rf['card']['power_limit_w']:.0f} W; measured step "
        f"{step_ms:.2f} ms: share of the ideal step "
        f"{rf['ideal_step_s'] * 1e3 / step_ms:.4f}, of the bound step "
        f"{rf['bound_step_s'] * 1e3 / step_ms:.4f}; per-device memory "
        f"{cell['memory']['total_bytes'] / 2**30:.2f} GiB (parameters and "
        f"AdamW state)")
    return counts, {"losses": want_losses, "peak": plain_peak,
                    "step_ms": plain_ms}


# ------------------------------------------------------------- phase 28
# tensor parallelism over the model axis: two ranks on the one card, a
# (1, 2) mesh over gloo (NCCL refuses two ranks on one device)
TP_RANKS, TP_STEPS = 2, 3
# (a): Qwen2-1.5B at full width, this many layers, float32, from this
# step of the schedule (its learning rate at step 0 is 0), held to this
# share of each tensor's largest magnitude
TP_CHECK_LAYERS, TP_FIRST_STEP, TP_CHECK_TOL = 2, 10, 1e-4
# (b): a rank's share of Qwen2-1.5B's 1,543,910,912 parameters at a model
# axis of 2 (every tensor but the 57 norms' 87,552 values splits in
# two), and the bfloat16 losses' bound against 27(b)'s run
TP_RANK_PARAMS, TP_LOSS_TOL = 771_999_232, 2e-2


def tp_inputs(cfg, dev):
    """(a)'s starting point, the same in every process: the seed's
    parameters with the leaves the init leaves at zero (norms, the QKV
    bias) drawn from N(0, 0.1^2), and an AdamW state at TP_FIRST_STEP with
    m ~ N(0, 1e-2^2) and v ~ U(0, 1e-4) (from a zero state AdamW's first
    step turns the key bias's rounding-noise gradient into a step of
    about lr). Returns (model, params, opt_state)."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    g = torch.Generator(device=dev).manual_seed(0)
    params = model.init_params(generator=g, device=dev, trainable=True)
    opt = make_train_step(model)[0](params)
    with torch.no_grad():
        for p in params.parameters():
            if not p.any():
                p.normal_(0.0, 0.1, generator=g)
        for k in opt["m"]:
            opt["m"][k].normal_(0.0, 1e-2, generator=g)
            opt["v"][k].uniform_(0.0, 1e-4, generator=g)
        opt["step"].fill_(TP_FIRST_STEP)
    return model, params, opt


def tp_steps(model, params, opt, dev, group=None):
    """TP_STEPS steps of (a) from TP_FIRST_STEP + 1 (the global batch on
    every rank): (losses, gnorms, params)."""
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import to_device
    _, step_fn = make_train_step(model, group=group)
    dcfg = DataConfig(vocab=model.cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    losses, gnorms = [], []
    for s in range(TP_FIRST_STEP + 1, TP_FIRST_STEP + 1 + TP_STEPS):
        params, opt, m = step_fn(params, opt, to_device(host_batch(dcfg, s),
                                                        dev), s)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    return losses, gnorms, params


def tp_check(rank, dev, res):
    """28(a) on one rank: the steps on the (1, 2) mesh, their collectives
    counted; then rank 0 takes the same steps without a mesh and holds
    the two to TP_CHECK_TOL."""
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import meshctx
    from repro_torch.distributed.sharding import place_params, place_state
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TP_CHECK_LAYERS,
                                         dtype="float32")
    mesh = make_host_mesh(dev, model=TP_RANKS)
    model, params, opt = tp_inputs(cfg, dev)
    place_params(params, cfg, mesh)
    opt = place_state(opt, cfg, mesh)
    with meshctx.mesh_context(mesh), CommDebugMode() as comm:
        losses, gnorms, params = tp_steps(model, params, opt, dev,
                                          meshctx.batch_group(mesh))
    got = {k: meshctx.full(p).detach() for k, p in params.named_parameters()}
    res["check"] = {"losses": losses, "gnorms": gnorms, "comm": {
        str(k): v for k, v in comm.get_comm_counts().items()}}
    del params, opt
    gc.collect()
    if rank == 0:
        want_l, want_g, want = tp_steps(*tp_inputs(cfg, dev), dev)
        res["check"].update(
            want_losses=want_l, want_gnorms=want_g,
            param_err=max(float((got[k] - p.detach()).abs().max()
                                / p.detach().abs().max())
                          for k, p in want.named_parameters()))
        del want
    del got
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()


def tp_full(dev, res):
    """28(b) on one rank: Qwen2-1.5B at full size, TP_STEPS `train_loop`
    steps on the (1, 2) mesh: losses, step times, the rank's parameters,
    peak memory, the LM kernels' launches and the heads each flash call
    saw; then one profiled step and one timed all-reduce."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.distributed.meshctx import batch_group, mesh_context
    from repro_torch.distributed.sharding import local
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models.model import build_model
    cfg = get_config(TRAIN_ARCH)
    mesh = make_host_mesh(dev, model=TP_RANKS)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_lm_counts()
    seen, flash = set(), ops.flash_attention

    def spy(q, *a, **kw):
        seen.add(q.shape[0])
        return flash(q, *a, **kw)
    ops.flash_attention = spy
    try:
        out = train_loop(cfg=cfg, steps=TP_STEPS, batch=TRAIN_BATCH,
                         seq=TRAIN_SEQ, ckpt_dir="", mesh=mesh,
                         log=lambda *a: None)
    finally:
        ops.flash_attention = flash
    torch.cuda.synchronize()
    counts, plain = lm_counts()
    res["full"] = {
        "losses": out["losses"], "dts": out["dts"], "counts": counts,
        "plain_calls": plain, "bh": sorted(seen),
        "peak": torch.cuda.max_memory_allocated(dev),
        "params": sum(local(p).numel() for p in out["params"].parameters())}
    # one more step under torch.profiler, this rank's device activity
    _, step_fn = make_train_step(build_model(cfg), group=batch_group(mesh))
    bt = to_device(host_batch(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH),
        TP_STEPS), dev)
    params, opt = out["params"], out["opt_state"]
    with mesh_context(mesh):
        _, pwall, busy, rows = profiled(
            lambda: step_fn(params, opt, bt, TP_STEPS), cpu=False)
    res["full"]["profiled"] = {
        "wall": pwall, "busy": busy,
        "top": [(r.key, r.self_device_time_total / 1e3) for r in rows[:6]]}
    del out, params, opt, bt
    # one all-reduce of the residual stream's size over the model axis
    # (a layer's forward sums two such, its backward two more)
    h = torch.ones(TRAIN_BATCH, TRAIN_SEQ, cfg.d_model, dtype=torch.bfloat16,
                   device=dev)
    group = mesh["model"].get_group()
    dist.all_reduce(h, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(h, group=group)
    torch.cuda.synchronize()
    res["full"]["allreduce_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    res["full"]["allreduce_bytes"] = h.numel() * h.element_size()
    del h
    gc.collect()
    torch.cuda.empty_cache()


def tp_rank(rank, init_file, out_dir):
    """One of phase 28's ranks (spawned): a gloo group over the ranks,
    each on card 0; writes its results to out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=TP_RANKS)
    try:
        res = {}
        t0 = time.perf_counter()
        tp_check(rank, dev, res)
        res["check_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp_full(dev, res)
        res["full_s"] = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_tp(dev, plain):
    """28 (the module docstring's list): Qwen2-1.5B tensor-parallel on a
    (1, 2) mesh, two ranks on the card; `plain`: 27(b)'s run without a
    mesh ({"losses", "peak", "step_ms"}). Returns the ranks' launches."""
    import gc

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import get_config
    d = os.path.join(ROOT, "build", "chip_smoke_tp")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        mp.spawn(tp_rank, args=(os.path.join(d, "init"), d),
                 nprocs=TP_RANKS, join=True)
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    wall = time.perf_counter() - t0

    # (a)
    c = ranks[0]["check"]
    bad = [(x, w) for x, w in zip(c["losses"] + c["gnorms"],
                                  c["want_losses"] + c["want_gnorms"])
           if abs(x - w) > TP_CHECK_TOL * abs(w)]
    if bad or c["param_err"] > TP_CHECK_TOL or \
            ranks[1]["check"]["losses"] != c["losses"]:
        raise AssertionError(f"[tp] (a) losses {c['losses']} vs "
                             f"{c['want_losses']}, gnorms {c['gnorms']} vs "
                             f"{c['want_gnorms']}, parameters' largest "
                             f"error {c['param_err']:.3g} of the tensor's "
                             f"largest magnitude")
    log(f"[tp] (a) {TRAIN_ARCH} at full width, {TP_CHECK_LAYERS} layers, "
        f"float32, {TP_STEPS} AdamW steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"from step {TP_FIRST_STEP} (a nonzero state) on the (1, 2) mesh "
        f"against the same steps in one process: losses "
        f"{', '.join(f'{x:.6f}' for x in c['losses'])} vs "
        f"{', '.join(f'{x:.6f}' for x in c['want_losses'])}, gnorms "
        f"{', '.join(f'{x:.6f}' for x in c['gnorms'])} vs "
        f"{', '.join(f'{x:.6f}' for x in c['want_gnorms'])}; every "
        f"gathered parameter within {c['param_err']:.3g} of its largest "
        f"magnitude (bound {TP_CHECK_TOL}); a rank's collectives "
        f"{c['comm']}")

    # (b)
    cfg = get_config(TRAIN_ARCH)
    want_bh = TRAIN_BATCH * cfg.n_heads // TP_RANKS
    layers = cfg.n_layers
    counts = {}
    for r, res in enumerate(ranks):
        f = res["full"]
        per = {FLASH[0]: 2 * layers * TP_STEPS,
               FLASH_WGMMA[0]: 2 * layers * TP_STEPS,
               FLASH_BWD[0]: layers * TP_STEPS,
               FLASH_BWD_WGMMA[0]: layers * TP_STEPS}
        diff = [abs(x - w) for x, w in zip(f["losses"], plain["losses"])]
        if f["params"] != TP_RANK_PARAMS or f["plain_calls"] or \
                {k: f["counts"][k] for k in per} != per or \
                f["bh"] != [want_bh] or len(diff) != TP_STEPS or \
                max(diff) > TP_LOSS_TOL:
            raise AssertionError(f"[tp] (b) rank {r}: {f['params']} "
                                 f"parameters, launches {f['counts']}, "
                                 f"{f['plain_calls']} plain calls, flash "
                                 f"BH {f['bh']}, losses {f['losses']} vs "
                                 f"{plain['losses']}")
        for k in per:
            counts[k] = counts.get(k, 0) + f["counts"][k]
        step_ms = float(np.median(f["dts"][1:])) * 1e3
        log(f"[tp] (b) rank {r}: {TRAIN_ARCH} at full size, {TP_STEPS} "
            f"`train_loop` AdamW steps of {TRAIN_BATCH} x {TRAIN_SEQ} on the "
            f"(1, 2) mesh: {f['params']} parameters held; losses "
            f"{', '.join(f'{x:.4f}' for x in f['losses'])} (27(b) without a "
            f"mesh: {', '.join(f'{x:.4f}' for x in plain['losses'])}, "
            f"largest difference {max(diff):.4f}, bound {TP_LOSS_TOL}); "
            f"step times {', '.join(f'{x * 1e3:.1f}' for x in f['dts'])} "
            f"ms, median of steps 2-{TP_STEPS} {step_ms:.1f} ms (27(b): "
            f"{plain['step_ms']:.1f} ms on the whole card); "
            f"max_memory_allocated {f['peak'] / 2**30:.2f} GiB (27(b): "
            f"{plain['peak'] / 2**30:.2f} GiB); launches "
            + ", ".join(f"{v} {k}" for k, v in per.items())
            + f" (every forward flash_fwd_wgmma, every backward the wgmma "
            f"pair), flash BH {f['bh'][0]} = {TRAIN_BATCH} x "
            f"{want_bh // TRAIN_BATCH} heads, 0 plain calls")
    for r, res in enumerate(ranks):
        pr = res["full"]["profiled"]
        busy = ("not measured (the profiler saw no device activity)"
                if pr["busy"] is None else
                f"{pr['busy'] * 1e3:.1f} ms = share "
                f"{pr['busy'] / pr['wall']:.4f}")
        log(f"[tp] (b) rank {r}: one more step under torch.profiler: "
            f"{pr['wall'] * 1e3:.1f} ms wall, this rank's device busy "
            f"{busy}; its kernels by device time: " + "; ".join(
                f"{k[:60]} {ms:.1f} ms" for k, ms in pr["top"]))
    f = ranks[0]["full"]
    log(f"[tp] two ranks over gloo (collectives staged through the host, "
        f"not NVLink): one all-reduce of {f['allreduce_bytes']} bytes (the "
        f"residual stream, bfloat16) over the model axis "
        f"{f['allreduce_ms']:.2f} ms (host clock, mean of 5) = "
        f"{f['allreduce_bytes'] / f['allreduce_ms'] / 1e6:.3f} GB/s; "
        f"{wall:.1f}s wall with the ranks' start; (a) "
        f"{ranks[0]['check_s']:.1f}s, (b) {ranks[0]['full_s']:.1f}s on "
        f"rank 0")
    return counts


# ------------------------------------------------------- CPU halves aside
# The CPU halves of phases 4, 11 and 18(a) are small plans on the plain
# path: single-threaded eager torch, 45-70 s each (240 s in all on a slow
# host), and independent of the card. They run in spawned worker
# processes, started after the build, beside the card's phases; each
# phase collects its result where it compares it with the card's run.
CPU_HALVES = ("small", "resilient unprotected", "resilient dmr",
              "small at 4 shards")


def run_cpu_half(name):
    """One of CPU_HALVES on the CPU, one thread (in a worker process):
    (its groups' results and carbon and its PackedStats, wall seconds)."""
    import types

    import torch
    from repro_torch.fleet import run_plan
    torch.set_num_threads(1)        # small tensors: one thread is fastest
    if name.startswith("resilient "):
        plan, kw = resilient_plans()[name.split()[1]], {"device": "cpu"}
    else:
        plan = three_group_plan(256)
        kw = ({"mesh": ["cpu"] * 4} if name == "small at 4 shards" else
              {"device": "cpu"})
    t0 = time.perf_counter()
    rep = run_plan(plan, keep_state=True, power_w=0.0, **kw)
    wall = time.perf_counter() - t0
    return types.SimpleNamespace(
        groups=[types.SimpleNamespace(result=g.result, total_kg=g.total_kg)
                for g in rep.groups], packed=rep.packed), wall


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s wall "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    for n in secs:
        for kern, regs, smem, st, ld in ptxas_report(_build.build_log(n)):
            log(f"[build] {n}: {kern}: {regs} registers, {smem} bytes "
                f"static shared memory, spill stores {st} / loads {ld} "
                f"bytes")

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(len(CPU_HALVES), multiprocessing.get_context(
            "spawn")) as pool:
        try:
            cpu_runs = {n: pool.submit(run_cpu_half, n) for n in CPU_HALVES}
            cpu_runs["roofline"] = pool.submit(roofline_cell)
            return run_phases(dev, smi, cpu_runs)
        finally:
            pool.shutdown(cancel_futures=True)


def run_phases(dev, smi, cpu_runs) -> int:
    """Phases 3-28 and the closing lines; `cpu_runs`: CPU_HALVES' futures
    by name, and phase 27's roofline cell's."""
    import torch
    rec = {}
    t0 = time.perf_counter()
    phase_kernels(dev, rec)
    log(f"[kernels] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    small_rep = phase_small_plan(dev, cpu_runs)
    log(f"[small plan] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts, main_rep = phase_main(dev)
    log(f"[main] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_profile(dev)
    log(f"[profile] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_sweep_kernel(dev, rec)
    log(f"[sweep kernel] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_small_sweep(dev)
    log(f"[small sweep] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts.update(phase_main_sweep(dev))
    log(f"[main sweep] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_fault_kernel(dev, rec)
    log(f"[fault kernel] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_small_resilient(dev, cpu_runs)
    log(f"[small resilient] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts[SEG_FAULTS[0]] = phase_main_resilient(dev, main_rep)
    log(f"[resilient main] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_lm_kernels(dev, rec)
    log(f"[lm kernels] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_small_serve(dev)
    log(f"[small serve] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts.update(phase_main_serve(dev, rec))
    log(f"[main serve] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_host_loop(dev, small_rep, main_rep)
    log(f"[host loop] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_checkpoint(dev, main_rep)
    log(f"[checkpoint] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_shards(dev, small_rep, main_rep, cpu_runs)
    log(f"[shards] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counts[SEG[0]] += phase_spoilage(dev, smi)
    log(f"[fig6] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, v in phase_examples(dev).items():
        counts[k] = counts.get(k, 0) + v
    log(f"[examples] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_serving_plan(dev, smi)
    phase_tables()
    log(f"[serving plan, tables] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, v in phase_dense_ssm(dev).items():
        counts[k] += v
    log(f"[dense/ssm serve] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_flash_bwd(dev, rec)
    for k, v in phase_train_full(dev).items():
        counts[k] = counts.get(k, 0) + v
    phase_train_small(dev)
    log(f"[train] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_ssd_bwd(dev, rec)
    for k, v in phase_train_ssm(dev).items():
        counts[k] = counts.get(k, 0) + v
    log(f"[ssm/hybrid train] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_gemma_kernels(dev, rec)
    for part in (phase_gemma_serve, phase_gemma_train):
        for k, v in part(dev).items():
            counts[k] = counts.get(k, 0) + v
    log(f"[gemma3] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_moe_small(dev)
    for part in (phase_moe_serve, phase_moe_train):
        for k, v in part(dev).items():
            counts[k] = counts.get(k, 0) + v
    log(f"[moe] phase {time.perf_counter() - t0:.1f}s")
    for name_, part in (("vlm", phase_vlm), ("audio", phase_audio)):
        t0 = time.perf_counter()
        for k, v in part(dev).items():
            counts[k] = counts.get(k, 0) + v
        log(f"[{name_}] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    mesh_counts, plain = phase_mesh(dev, cpu_runs)
    for k, v in mesh_counts.items():
        counts[k] = counts.get(k, 0) + v
    log(f"[mesh] phase {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for k, v in phase_tp(dev, plain).items():
        counts[k] = counts.get(k, 0) + v
    log(f"[tp] phase {time.perf_counter() - t0:.1f}s")

    log("kernels: " + " ".join(f"{k}={v}" for k, v in counts.items()))
    out = []
    for name_, src, replaces in (SEG, REF, SWEEP, SWEEP_DRAWN, SEG_FAULTS,
                                 FLASH, FLASH_WGMMA, SSD, BITPLANE,
                                 FLASH_BWD, FLASH_BWD_WGMMA, SSD_BWD):
        r = rec[name_]
        out.append({"name": name_, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": counts[name_],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r.get("library_ms")})
    log(json.dumps({"kernels": out}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
