#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FedSem on one CUDA card and check it.

    python3 chip_smoke.py [--out report.json] [--profile]

Phases (any failure exits non-zero; nothing is skipped and nothing runs on
the CPU in place of the card):

1. build the CUDA kernels of `repro_torch.kernels` (`fedsem_objective`,
   `flash_attention`, `rwkv6_scan`, `mamba_scan`, `p4_adam`) from the
   sources in this checkout, one nvcc (sm_90a) each, all at once, and print
   ptxas' report;
   the flash library's bf16 kernel (one instantiation per head dim; hd 80's
   at width 128) must hold BF16 `HGMMA` (wgmma) instructions in its SASS
   (`cuobjdump -sass`), and its float32 kernel (one per head dim, hd 80 at
   its own width) TF32 ones; the WKV6, selective-scan, flash and Adam-loop
   kernels' registers are printed, and no instantiation of any may spill;
2. hold the objective kernel against its plain PyTorch version on the card at the
   shapes the solver gives it ((B, G, N) = (16, 3, 10) for the multi-start
   selection, (48, 1, 10) for the per-iteration trace), at a large-G case
   (64, 8192, 8), at the exhaustive sweep's shapes with the feasibility mask
   ((1, 800000, 4), each of Table II's 1024 chunks; (64, 6912, 3), each of the
   oracle gate's 2), and `objective_grid` at (G, N) = (1024, 10); with
   masked rows, per-row weights and the feasibility mask on and off. The
   +inf mask must agree exactly and finite scores to rtol 5e-7, atol 1e-5.
   Each is timed with CUDA events: on the device (launches captured in a
   CUDA graph and replayed) beside its memory bound, and per eager call;
3. the slice: draw 16 Table-I scenarios (N = 10, K = 50, `iid_rayleigh`) on
   the card and run `solve_batch` under ``AllocatorConfig(inner="pgd")``
   (the serving config) and the default ``AllocatorConfig()`` (SCA) cut to
   `cut_configs()` depth (`SCA_REDUCED`). Every
   leaf must be finite, each hardened X binary with every subcarrier owned
   once and every device owning one, every scenario feasible, the kernel
   launched at least ``outer_iters + 1`` times per solve, and
   ``use_kernel_objective=False`` must give the identical X, P and rho
   (each config's twin at cut depth against a kernel solve at that depth,
   SCA's the main path's, `TWIN_REDUCED`). A small input solved on the card and on the CPU must
   give the same X.

4. build check of the flash-attention kernel of
   `repro_torch.kernels.flash_attention` against its plain version (the
   chunked attention of `repro_torch.models.attention`) on the card: float32
   (3xTF32 on the tensor cores) and bfloat16 (bf16 on them); MHA, GQA,
   MQA; S not a block multiple; window; softcap; non-causal; hd 256; the
   Gemma-2 2B layer shapes (B = 1, S = 8192, H 8, KV 4, hd 256, bf16; global
   and window 4096, softcap 50), the Qwen2.5-3B shape (H 16, KV 2, hd 128)
   and the Jamba-1.5-Large attention layer (S = 4096, H 64, KV 8, hd 128,
   bf16), phase 20's Arctic-480B layer (S = 4096, H 56, KV 8, hd 128,
   bf16), and phase 19's layers: HuBERT X-Large's (B 4, S 1500, H 16, KV
   16, hd 80, bidirectional; bf16 and float32: hd 80 runs at width 128 in
   bf16, and that design's own floor, 128/80 of the operations, is printed
   beside the bound; float32 runs it at width 80), StarCoder2-3B's (S 8192,
   H 24, KV 2, hd 128; bf16 and float32), Pixtral-12B's (S 8192, H 32, KV
   8, hd 128), Gemma-2 9B's (S 8192, H 16, KV 8, hd 256, softcap 50; global
   and window 4096) and Gemma-2 2B's global layer in float32, the float32
   yardsticks' widest.
   Tolerance, absolute plus relative: float32 the JAX tests' own
   2e-5; bfloat16 one bf16 ulp (rtol 2**-7, atol 1e-4): the plain version
   keeps the probabilities P in float32 for P V, and the bf16 kernel keeps
   them to about 2^-17 (P V = P_hi V + P_lo V, two bf16 products), so the
   two differ by the rounding of the output (the JAX tests' 2e-2 would be as
   large as the outputs of the late rows at S = 8192). Each case is timed
   on the device (CUDA-graph replay) beside its bound, with the plain
   version and one PyTorch call that computes the same function:
   `scaled_dot_product_attention` without a softcap, compiled
   `flex_attention` with the softcap as its score_mod; each case prints
   the share of the bound the kernel reaches and its factor against that
   call (a float32 case's bound is 3xTF32's, 12 hd operations a pair at
   495 TFLOP/s, and the CUDA cores' 4 hd at 67 is printed beside it). The
   call is held to the JAX tests' tolerance; whether it also stays within
   the kernel's one-ulp gate is recorded, not required (it rounds P to
   bf16);
5. the LM slice: `gemma2_2b` at full width in bfloat16 on the card from a
   seeded `torch.Generator`; `prefill(use_kernel=True)` on B = 1, S = 8192
   tokens must launch the kernel once per layer (26) and give finite logits.
   The same prefill with the plain attention and the same model in float32
   (plain attention) are the yardsticks: the kernel's logits must lie no
   farther from the plain bf16 logits than the plain bf16 logits lie from
   the float32 ones (the bf16 rounding of the whole model). In float32,
   each layer's kernel route must match its plain route on the same input
   (the plain run's, layer by layer) at the kernels' float32 tolerance
   (atol and rtol 1e-4), and the kernel prefill's logits must lie no
   farther from the plain ones than twice the gap a one-ulp perturbation of
   the embedding table makes (the random-weight model amplifies rounding at
   its first positions, so a fixed logit tolerance would fail the plain
   version against itself). One more warm kernel prefill runs under
   `torch.profiler`: the kernel's device time and launches in the trace,
   the matrix products' device time and the device's busy time; so does one
   more warm float32 kernel prefill (the float32 kernel's launches and its
   share of busy time; phase 5 only). Then the
   mesh path (`mesh_path`): the same warm parameters placed on a (1, 1)
   ("data", "model") mesh of this card (`launch.mesh.open_mesh`, a
   one-process nccl group), as DTensors whose local tensors are the
   parameters themselves; its prefill must equal the unsharded one bit
   for bit at the same 26 launches, and two `ServeLoop` decode steps on a
   cache placed by `cache_specs` the unsharded loop's, launching nothing
   (likewise in phases 8 and 11: 24 WKV6, 7 scans + 1 flash);
6. `ServeLoop` on the same model: 8 requests of 8 tokens, 4 slots, 16 new
   tokens each, max_len 256; every request must come back with 16 tokens
   in the vocabulary;
7. the WKV6 kernel of `repro_torch.kernels.rwkv6_scan` against its plain
   version (the step-by-step recurrence of its ``ref.py``) on the card: the
   reference's test shapes ((1, 2, 128, 64) and (2, 4, 96, 32), float32 and
   bfloat16), a ragged S, a strong decay (w = exp(-exp(1 + 0.5 z)), near
   0.07, at (2, 4, 1024, 64)), and the full-width RWKV-6 1.6B layer (B 1,
   S 4096, H 32, hd 64, w near the model's exp(-exp(-6))) all in float32
   and in the types the bf16 model hands over (bf16 r/k/v, float32 w and
   y); the strong-decay and model-law cases in the model's (B, S, H, hd)
   layout. Tolerance by y's type, absolute plus relative: float32 the JAX
   tests' 1e-4; bfloat16 one bf16 ulp of the output (rtol 2**-7, atol
   1e-5), since kernel and plain version evolve the same float32 state,
   rounded alike, and differ only in y's sum (the bonus term factored out
   and the sum over the key index in another order). The kernel is timed on
   the device (CUDA-graph replay) beside its bound (the function's float32
   operations: 5 per step, key and value column, an FMA counted as 2); the
   plain version by graph replay up to S = 1024 and by events around one
   eager call at S = 4096 (a graph of its 28,000 launches is not worth its
   capture). No single PyTorch call computes WKV6;
8. the RWKV slice: `rwkv6_1_6b` at full width in bfloat16 from a seeded
   `torch.Generator`; `prefill(use_kernel=True)` on B = 1, S = 4096 tokens
   must launch the WKV kernel once per layer (24) and give finite logits,
   with the logit gates and profile of phase 5; the yardsticks run on the
   model cut to 4 layers (`LM_REDUCED`), as phase 19's Gemma-2 9B's do;
9. `ServeLoop` on the RWKV model, as phase 6 (decode carries the state
   through the plain one-step recurrence and launches no kernel);
10. the selective-scan kernel of `repro_torch.kernels.mamba_scan` against its
   plain version (the step-by-step recurrence of its ``ref.py``) on the card:
   the reference's test cases ((B, S, di, N) = (1, 64, 128, 8) and
   (2, 96, 64, 16); x and dt float32 or bfloat16, B/C float32), a ragged S
   and di, B/C as strided column views of one projection, dt A down to
   about -100 (dt = softplus(z + 2): exp(dt A) underflows, and the kernel's
   exponential flushes what would be subnormal to 0), and the full-width
   Jamba-1.5-Large layer (1, 4096, 16384, 16) all in float32 and in the
   types the bf16 model hands over (bf16 x, float32 dt, bf16 B/C views; y
   in x's type), with dt and A of the initialised model's law. Tolerance
   by y's type: float32 the JAX tests' 1e-4; bfloat16 one bf16 ulp (rtol
   2**-7, atol 1e-5): kernel and plain version evolve a float32 state with
   every operation rounded alike but the exponential (2^(dt A log2 e) on
   the exponential unit, a few ulp from `expf`), and sum over the state in
   another order. Timed as
   phase 7, beside its bound (the bytes, or the operations: the
   exponentials shared between the card's exponential unit, 16 a clock per
   SM, and polynomials on the float32 pipe beside the other float32
   operations, in the share that levels the two; whichever takes longer). No
   single PyTorch call computes the selective scan;
11. the Jamba slice: `jamba_1_5_large_398b` at full width cut to one period
   with every FFN dense (``scaled(n_layers=8, n_experts=0, top_k=0)``: 7
   Mamba layers and 1 attention layer (H 64, KV 8, hd 128), 9.0 B
   parameters) in bfloat16 from a seeded `torch.Generator`;
   `prefill(use_kernel=True)` on B = 1, S = 4096 tokens must launch the
   selective-scan kernel once per Mamba layer (7) and the flash kernel once
   per attention layer (1) and give finite logits, with the yardsticks,
   logit gates and profile of phase 5;
12. `ServeLoop` on the Jamba cut, as phase 6 (decode carries (conv window,
   h) through the plain one-step recurrence and launches no kernel);
13. the scenario families and the paper's baselines: 16 Table-I scenarios
   (N = 10, K = 50) from seed 0 of each of the four families on the card
   (`iid_rayleigh` reuses phase 3's solve), `solve_batch` under
   ``AllocatorConfig(inner="pgd")`` cut to the reference's smoke allocator
   (2 outer iterations, 60 PGD steps; `FAMILY_REDUCED`), and the four
   baselines of
   `repro_torch.core.baselines` on the same batch, one call each. Every leaf
   finite; Alg. A2's X and the equal, computation-only and random
   baselines' X binary with every subcarrier owned once (the
   communication-only baseline returns PGD's relaxed X: in [0, 1], each
   subcarrier owned at most once); Alg. A2 feasible on every scenario and
   no worse than every feasible baseline (+1e-3, like with like); the count
   of infeasible baselines is printed, with each family's solve time and
   `hetero_classes`' three device classes;
14. the exhaustive oracle (`repro_torch.core.exhaustive`) through the
   objective kernel: Table II on the card (`iid_rayleigh`, N 4, K 5, seed 0,
   f 5 levels in [0.25, 2] GHz, p 4 levels in [4, 20] dBm, rho 5 levels in
   [0.2, 1]: G = 800,000 candidates for each of the 1024 assignments), once
   with the kernel and once with ``use_kernel=False`` on the same card
   tensors. Both must return the same allocation (or, on a tie, values
   within phase 2's tolerance); the kernel launches once per chunk (1024)
   on the kernel run and never on the plain run; the value equals the
   port's `report` objective of its allocation to rtol 1e-5, and the
   allocation is feasible. Each run's wall time (ending in a synchronize)
   and candidates per second are printed, and one more warm kernel sweep
   runs under `torch.profiler` (the device's busy share, the kernel's
   device time); then Alg. A2's objective (PGD) on the same instance and
   Table II's claims (printed, not gated: the instance is the port's
   draw). Then the oracle gate's sweep (N 3, K 4,
   the gate's grids) for each family, kernel against plain, as above;
15. serving (`repro_torch.serve`) on the card at full width: an
   `iid_rayleigh` stream of 12 requests of sizes (10, 50) (Table I; bucket
   (16, 64)) and (6, 16) (bucket (8, 16)) at the Table-I bbar, Poisson
   arrivals at 20 req/s, `AllocService` with the serving config
   ``AllocatorConfig(inner="pgd")`` cut to the reference's smoke allocator
   (2 outer iterations, 60 PGD steps; `SERVE_REDUCED`), `DEFAULT_BUCKETS`, max_batch 8, max_wait 50 ms. Passes: (a) the
   `RealClockDriver` through `pace_stream`, then a drain; (b) the same
   stream and arrivals through `run_load` on the virtual clock; (c) the
   same stream again, all at once, through a ``warmstart=WarmStartConfig()``
   service whose cache holds (a)'s solutions, so every request hits; then
   the (6, 16) requests at cut depth (1 outer iteration, 100 PGD steps: a
   full-depth flush holds too many events for the profiler) in one kernel
   flush, the same under `torch.profiler`, and one flush of the plain
   scoring path (``use_kernel_objective=False``). Gates: every request
   answered once, binary and feasible at its exact shape,
   `Completion.objective` equal to `system.objective` there to rtol 1e-5;
   (a) and (b) give the same req_id -> X; in (c) every request hits and
   no objective exceeds (b)'s + 1e-5 max(1, |cold|); the kernel launches 4
   times per cold flush (2 trace entries, the multi-start selection, the
   flush's scoring) and 7 per flush with a hit (+ the refine pass's 3),
   never on the plain path, whose allocations equal its kernel twin's and
   whose objectives lie within phase 2's tolerance of them. Printed:
   latency p50/p99, throughput, `solve_s` per flush, each solver's first
   call, the warm hit rate and outer iterations to converge, the profiled
   flush's device busy share, and the kernel at each serving launch shape
   phase 2 does not time (graph replay, bound, plain version);
16. the FedSem closed loop (`repro_torch.launch.fedsem_e2e`) on the card
   at the reference's full harness (`harness_config(smoke=False)`: jobs
   `hetero_classes` (4, 12), `gauss_markov` (4, 12) and `iid_rayleigh`
   (6, 16), `AEConfig(image_size=32, hidden=8, base_latent=8)`, batch 8,
   eval batch 16, max_batch 4, max_wait 20 ms), cut to the smoke harness's
   3 rounds a job (`FEDSEM_ROUNDS`) and the allocator to the reference's
   smoke allocator (2 outer iterations, 60 PGD steps; `FEDSEM_REDUCED`). Gates: the four e2e gates (ServiceBackend's X equals
   PlannedBackend's exactly, rho within 1e-6; an applied, monotone refit;
   every job complete; each job's solo re-run equal to its co-tenanted run
   exactly); the objective kernel launched exactly 3 times per
   `solve_batch` call and once per flush's scoring, by the phase's own
   counts of both; the planned batch of e2e phase 1 solved on the card's
   scenario mesh (`scenario_mesh()`) with the unsharded X and launches;
   a ``shard_batch`` service with device count x max_batch slots answering
   its rounds as the unsharded service. Printed: wall time per e2e phase,
   each job's loss, rho, energy, objective and proxy accuracy per round,
   the service's latency p95 and occupancy, one round's device busy share
   (`torch.profiler`, device activity: the round with its allocation
   answered at once, then the allocation's flush alone; the round is their
   sum), and the kernel at the phase's launch shapes
   (graph replay, bound, plain version);
17. LM training (`repro_torch.launch.train`): (a) `qwen2_5_3b` at full width
   (36 layers, d 2048, vocab 151936, bf16, 3.09 B parameters) from seed 0,
   `build_train_step` at `train.py`'s defaults (B 8, S 128, lr 1e-3, clip
   1.0), 5 steps on one fixed batch of tokens drawn from a seeded generator
   (`TRAIN_REDUCED`). Gates: loss and grad norm finite every step; the loss
   after the 5 steps below step 0's; no flash, WKV or selective-scan launch
   during the steps (training takes the plain path, as the reference's);
   step 0's loss within 1e-3 relative of the same loss through
   `forward(use_kernel=True)` (the flash kernel, under no_grad; its 36
   launches are a comparison, not the path); `loss_fn(use_kernel=True)`
   with trainable leaves raises, naming the plain route. Printed: each
   step's wall, the median warm step, tokens/s, ``mfu_bf16_dense`` (6 x
   parameters x tokens / step time / 989 TFLOP/s), the peak memory, and the
   last step's device busy share (`torch.profiler`). Then one more step
   on the (1, 1) mesh (`train_on_mesh`, the state placed as views):
   `loss_fn` there takes the vocab-sharded cross-entropy (a model axis of
   1 divides the vocab) and must lie within 1e-5 relative of mesh=None's;
   the step's grad_norm within 1e-4 of mesh=None's on the same state
   (deterministic algorithms for both); `launch.dryrun.lower_pair` of the
   same step on a (1, 1) fake mesh, traced in a process of its own beside
   the phase, must count the step's per-device dot FLOPs within 1% of
   `launch.op_cost.OpCost` around the real step, and its predicted peak
   is printed beside the measured one. (b) the smoke variants
   of `gemma2_2b`, `rwkv6_1_6b`, the Jamba dense cut, `arctic_480b` and
   `deepseek_v3_671b` on bigram-chain batches: gradients with remat on and
   off equal bit for bit (deterministic algorithms on for the comparison),
   then 3 steps with finite, falling losses; for the two MoE models the
   loss is the cross-entropy plus 0.01 x the positive aux term / n_layers;
18. federated LM fine-tuning (`repro_torch.launch.federated_lm`): (a) its
   own computation, the smoke `qwen2_5_3b`, 4 clients, 8 rounds,
   `PlannedBackend` at the reference's smoke allocator depth
   (`FED_REDUCED`): the last round's loss below the first, every round's X
   binary with each subcarrier owned once, the objective kernel launched
   ``outer_iters + 1`` times per counted `solve_batch`; (b) one round of
   `qwen2_5_3b` at full width (2 clients, one local SGD step on generator
   tokens, compression on, the solved allocation's rho held at 0.4;
   `FED_REDUCED`): every leaf of every upload (the 311 M-entry embedding
   and the 811 M-entry stacked FFN leaves among them) is sparsified at rho
   0.4 and keeps at most rho n + 1 entries above its threshold and at
   least rho n - 1 at or above it, the aggregated parameters finite; then
   float32 draws (no ties) of the embedding's and the largest stacked
   leaf's sizes, sparsified at rho 0.3, keep exactly the entries at or
   above their thresholds, within one of 0.3 n. The round's wall split
   into the allocation, the sparsification and the rest, the leaves whose
   threshold sits on a tie, and the peak memory are printed;
19. the remaining dense configs and the stub frontends, each at its
   published widths and depth in bfloat16 from a seeded `torch.Generator`
   (`MODEL_PATHS`), as phases 5-6: `gemma2_9b` (B 1, S 8192; 42 flash
   launches), `starcoder2_3b` (B 1, S 8192; 30), `hubert_xlarge` (audio:
   B 4, S 1500 frame embeddings, bidirectional, hd 80; 48; logits (4,
   1500, 504); no `ServeLoop`: an encoder has no decode step) and
   `pixtral_12b` (vision: B 1, S 8192 tokens with 1024 patch embeddings
   over the leading positions; 40). The batch follows
   `specs.input_specs` (`lm_batch`); the parameter count is read from the
   tensors; a warm prefill is profiled. The yardstick gates of phase 5
   run at full depth for StarCoder2 and HuBERT (HuBERT's one-ulp
   perturbation moves its frame projection: it reads no embedding) and on
   a 4-layer cut of the same widths for Gemma-2 9B and Pixtral
   (`MODEL_REDUCED` lists each cut);
20. the MoE and MLA models at their published widths, cut in depth only
   (`MOE_PATHS`, `MOE_REDUCED`), in bfloat16 from a seeded
   `torch.Generator`, B 1, S 4096, as phases 5-6: `arctic_480b` cut to 2
   layers (d 7168, GQA 56/8 at hd 128, 128 experts top-2 of 4864 beside a
   dense residual of 4864; 27.7 B parameters; 2 flash launches), its
   yardsticks on 1 layer (the float32 model is 56 GB); `deepseek_v3_671b`
   cut to 4 layers (MLA: q_lora 1536, kv_lora 512, hd 128 + rope 64; three
   dense-prefix layers of d_ff 18432, then one MoE layer of 256 experts
   top-8 of 2048 and a shared expert; 15.1 B parameters; no kernel launch:
   MLA takes the plain chunked attention, as the reference's does), its
   yardsticks on the same 4 layers. The float32 layer-by-layer gate holds a
   MoE layer's kernel route to its plain route on the attention half (the
   router's top-k is discontinuous: a float32 ulp may move a token to
   another expert). More gates: the first MoE layer of each model on the
   FFN norm of the prompt's embeddings run twice in bf16 must be bit for bit
   equal (the combine sums in a fixed order, no atomics); in float32 on 64
   of those tokens sampled, it must match a per-token oracle (each token's
   kept assignments, counted in the reference's dispatch order, times their
   gates through that expert's SwiGLU, plus the shared expert or dense
   residual) to 1e-5 of the oracle's scale, with the dropped assignments
   equal to the oracle's own count; DeepSeek's float32 decode of the first
   32 positions (the absorbed MLA, the latent cache) must match `forward`'s
   logits there within 2e-2 (tests/test_distributed_equivalence.py's
   tolerance);
21. the paper's evaluation (`repro_torch.paper`): each of the seven drivers
   (Figs. 3, 4, 5, 6 and 8, Table II, the §IV-D analyses) with its quick
   grid at Table-I width (N 10, K 50; Table II at N 4, K 5; Fig. 5's grid
   and the runtime sizes at their own) on the card, then the three examples
   (`launch.quickstart`, `launch.serve_scenarios`,
   `launch.fedsem_autoencoder`), the allocator cut (`PAPER_REDUCED`).
   Gates: every allocation a driver makes (`paper.common.watch`) finite,
   with X binary and each subcarrier owned once (comm_only's relaxed X at
   most once); Alg. A2's with every device served and feasible, and the
   oracle's feasible; each row's objective `report` of its own allocation
   (rtol 1e-6; the oracle's value rtol 1e-5); the quickstart's solve
   likewise, the served requests as phase 15's, the autoencoder's rows
   finite with a fit in [0.05, 0.95]; at least one objective-kernel launch
   per driver and example, and no other kernel; fig4's sweep solved again
   with ``use_kernel_objective=False`` gives the identical X, P and rho.
   Printed: each driver's wall time, solves, launches and its claim checks
   (recorded, not gated at cut depth);
22. the Adam loops' kernel (`repro_torch.kernels.p4_adam`) at the
   allocation benchmark's three loops (PGD on 64,512 and 21,504 Table-I
   rows x 800 steps, the power re-solve on 64,512 x 600) and at `P4_EXTRA`
   (N 8, 16 devices a lane; the (64, 256) bucket, the wide kernel): one
   launch a call, its device time beside its bound (`p4_bound`: float32
   issue, the special-function unit or bytes) and the eager loop's time on
   the same tensors; then one step on every entry of the main path's
   64,512 rows in both modes against the eager loop and its float64 twin
   (`tests/p4_adam_checks.py`'s `one_step_check`), and 800 PGD steps on
   `P4_CHECK_ROWS` rows against the eager loop: the final decode's P4 loss
   within `P4_ROW_GAP` on every row and `P4_LOSS_GAP` in the median, and
   at least a share `P4_SAME_X` of the rows with the same hardened X.

Each LM path launches, per prefill, each kernel as often as it has layers of
that kernel's kind (attention: flash, but MLA none; rwkv: WKV6; mamba: the
selective scan) and every other kernel never; the allocator paths (3, 13, 14, 15, 16, 18 and 21)
launch the objective kernel and the Adam loops' kernel, exactly once for
each call of `solve_p4_pgd` or `power_given_x` on the card
(`count_adam_calls`), and no LM kernel; the training path (17) launches
none. Each path (3, 5 + 6, 8 + 9, 11 + 12, 13, 14, 15, 16, 17, 18 and each
model of 19) is
driven with the kernels' launch counts set to 0 just before it and read
just after (likewise phase 21, each model of 20, each (1, 1) mesh path of 5, 8 and
11, and phase 17's mesh step). With ``--profile``, one short solve
per config (cut depth) also runs under `torch.profiler`, for the device's
busy share. The last lines are the kernels' JSON record, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.

Exit codes: 0 all phases passed; 1 a phase failed; 4 no CUDA card; 5 the
port (``src/repro_torch``) is not beside this script (2 is argparse's
usage error).
"""
from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM TF32 dense tensor cores
#: phase 4's (atol, rtol) of the kernel against its plain version: float32 the
#: JAX tests' 2e-5 (tests/test_kernels.py), bfloat16 one ulp of the output
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-4, 2**-7)}
#: the library call against the plain version: the JAX tests' tolerance
LIBRARY_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: phase 7's and phase 10's (atol, rtol): float32 the JAX tests' 1e-4,
#: bfloat16 one ulp
WKV_TOL = SCAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2**-7)}
#: float32 operations WKV6 needs per (step, key, value column): the FMA of
#: r_i S_ij into y_j (2), k_i v_j, the FMA w_i S_ij + k_i v_j (2); and per
#: (step, key) the bonus term's r_i u_i k_i and its sum (3), per (step, value
#: column) v_j times that sum and its add into y_j (2)
WKV_OPS, WKV_OPS_KEY, WKV_OPS_COL = 5, 3, 2
#: float32 operations the selective scan needs per (step, channel, state):
#: dt A, da h, (dt x) B, their add, the FMA of h C into y (2); and per (step,
#: channel): dt x, D x and its add. Besides, one exponential per (step,
#: channel, state)
SCAN_OPS, SCAN_OPS_CHANNEL = 6, 3
#: exponentials a second: 16 a clock on each of the 132 SMs (the exponential
#: unit's rate in the CUDA programming guide's throughput table for compute
#: capability 9.0) at the 1.98 GHz that the float32 rate implies
#: (67e12 = 132 SMs x 128 lanes x 2 x 1.98e9)
EXP_PER_S = 16 * 132 * FP32_FLOPS_PER_S / (132 * 128 * 2)
#: float32 operations of an exponential computed as a polynomial on the FMA
#: pipe instead (as FlashAttention-3 does for part of its exponentials):
#: round the base-2 argument with a magic-number add, subtract it back, take
#: the fraction (3 adds), and a degree-5 Horner polynomial for 2^f on
#: [-1/2, 1/2] (5 FMAs: about 1 ulp, as `expf`'s 2); the exponent's insert is
#: integer work, off that pipe
EXP_POLY_OPS = 3 + 5 * 2
#: phase 22's loops: the allocation benchmark's three (mode, rows, steps) at
#: Table I's N 10, K 50: each outer iteration's PGD on 3 x 21504 rows, the
#: full-payload start's on 21504, the power re-solve on 3 x 21504
P4_CASES = (("pgd", 64512, 800), ("pgd", 21504, 800), ("power", 64512, 600))
#: float32 operations and special-function operations (exponentials,
#: log1p's logarithm, reciprocals, square roots) a (device, subcarrier)
#: entry and step: the gradient as written out
#: (tests/test_torch_p4_adam.py::_written_out) and Adam on z and w (PGD),
#: or on w (power mode)
P4_OPS = {"pgd": (80, 9), "power": (45, 6)}
#: phase 22's other timed loops (mode, N, K, pad, rows, steps): N 8 (the
#: (8, 32) bucket's devices, 16 a lane) on the benchmark's 64,512 rows, and
#: the (64, 256) bucket (the wide kernel) on a serving batch's 3 x 48 rows
P4_EXTRA = (("pgd", 8, 32, None, 64512, 800), ("pgd", 40, 200, (64, 256), 144, 800))
#: rows of phase 22's 800-step comparison with the eager loop, and its gate
#: on the median relative gap of the final decode's P4 loss (the gates on
#: every row are `tests/p4_adam_checks.py`'s `P4_ROW_GAP` and `P4_SAME_X`)
P4_CHECK_ROWS, P4_LOSS_GAP = 1024, 1e-3
#: phases 5 and 8's float32 gates: each layer's kernel route against its
#: plain route on the same input at the kernels' float32 (atol, rtol) (the
#: JAX tests' 1e-4); and the kernel prefill's logits no farther from the
#: plain prefill's than this many times the gap a one-ulp perturbation of the
#: embedding table makes (the model's own float32 sensitivity)
LM_LAYER_TOL = (1e-4, 1e-4)
LM_F32_ULP_FACTOR = 2.0
#: the symbol of each LM kernel, as it appears in a profiler trace
KERNEL_SYMBOLS = {"flash_attention": "flash_fwd_kernel", "rwkv6_scan": "wkv6_fwd_kernel",
                  "mamba_scan": "mamba_scan_fwd_kernel"}
#: the main path's instantiation of the WKV6 kernel (bf16 r/k/v, float32 w
#: and y, hd 64), of the selective scan (bf16 x and y, float32 dt, bf16
#: B/C, N 16) and of flash, as they appear in the mangled names ptxas reports
MAIN_INSTANTIATION = {"rwkv6_scan": "wkv6_fwd_kernelI13__nv_bfloat16ffLi64E",
                      # the PGD loop at 16 devices a lane (Table I's N 10)
                      "p4_adam": "p4_adam_kernelILi16ELb1E",
                      "mamba_scan": "mamba_scan_fwd_kernelI13__nv_bfloat16fS1_Li16E",
                      # the bf16 tensor-core kernel at Gemma-2's hd 256
                      "flash_attention": "flash_fwd_kernel_sm90ILi256ELi256E"}
#: every kernel of the port, by module name under `repro_torch.kernels`
KERNELS = ("fedsem_objective", "flash_attention", "rwkv6_scan", "mamba_scan")
#: one-cycle device sleeps (`torch.cuda._sleep`; the symbol of their kernel)
#: that every profile (`device_profile`) launches before what it measures: the
#: profiler drops a profile's leading device records, more of them the longer
#: the process has run profiles (tools/torch_profile_repeat.py: 54 of a
#: Gemma-2 2B prefill's first kernels after 13 minutes, layer 0's flash
#: launch among them twice in 81 profiles; none behind 3000 of these sleeps)
PROFILE_LEAD_IN = 3000
LEAD_IN_SYMBOL = "spin_kernel"
#: the kernel a prefill launches once for each layer of a block kind (an
#: MLA model's attention layers launch none: `path_launches`)
KERNEL_OF_KIND = {"attn": "flash_attention", "attn_local": "flash_attention",
                  "rwkv": "rwkv6_scan", "mamba": "mamba_scan"}
#: what marks a matrix product's kernel in a trace (cuBLAS and CUTLASS names)
PRODUCT_MARKS = ("gemm", "xmma", "nvjet", "cutlass")
#: the LM path whose float32 kernel prefill is profiled too (phase 5): the
#: float32 kernel's launches and share of the device's busy time
F32_PROFILE_ARCH = "gemma2_2b"
#: the LM paths: (arch, prefill length, the cut of its config, the
#: yardsticks' cut or None for the same model; cuts as `ModelConfig.scaled`
#: arguments)
LM_PATHS = (("gemma2_2b", 8192, {}, None),            # phases 5-6 (> the 4096 window)
            # phases 8-9 (RWKV-6's training context); the yardsticks on 4 layers
            ("rwkv6_1_6b", 4096, {}, dict(n_layers=4)),
            # phases 11-12: one period, the MoE FFNs dense; the port runs the
            # experts (phase 20's models), but one period with them is 45.1 B
            # parameters, 90 GB in bf16: the cut is for memory
            ("jamba_1_5_large_398b", 4096, dict(n_layers=8, n_experts=0, top_k=0), None))
#: the LM paths' cuts of time, by arch
LM_REDUCED = {
    "rwkv6_1_6b": ["the yardsticks (kernel vs plain bf16; float32 layer by layer; float32 kernel "
                   "vs a one-ulp embedding): n_layers 24 -> 4 (at 24 layers the three plain "
                   "prefills' step-by-step recurrence took 51 s of the script's 1200)"],
}
#: phase 19: the models at their published widths and depths in bf16, (arch,
#: B, S, the yardsticks' cut: `ModelConfig.scaled` arguments, or None for
#: the full depth); the inputs follow `specs.input_specs`
MODEL_PATHS = (("gemma2_9b", 1, 8192, dict(n_layers=4)),
               ("starcoder2_3b", 1, 8192, None),
               ("hubert_xlarge", 4, 1500, None),     # 30 s of 50 Hz frames
               ("pixtral_12b", 1, 8192, dict(n_layers=4)))
#: phase 19's cuts of scale, by arch
MODEL_REDUCED = {
    "gemma2_9b": ["batch and sequence: prefill_32k's (32, 32768) -> (1, 8192)",
                  "the yardsticks (kernel vs plain bf16; float32 layer by layer; float32 kernel vs "
                  "a one-ulp embedding): n_layers 42 -> 4 (the float32 model is 37 GB beside 8.4 GB "
                  "of float32 logits)"],
    "starcoder2_3b": ["batch and sequence: prefill_32k's (32, 32768) -> (1, 8192)"],
    "hubert_xlarge": ["batch and sequence: prefill_32k's (32, 32768) -> (4, 1500): 30 s of "
                      "50 Hz frames each"],
    "pixtral_12b": ["batch and sequence: prefill_32k's (32, 32768) -> (1, 8192), 1024 patches",
                    "the yardsticks: n_layers 40 -> 4 (the float32 model is 49 GB)"],
}
#: phase 20: the MoE and MLA models at their published widths in bf16, (arch,
#: B, S, the cut, the yardsticks' cut or None for the same model), and their
#: cuts of scale
MOE_PATHS = (("arctic_480b", 1, 4096, dict(n_layers=2), dict(n_layers=1)),
             ("deepseek_v3_671b", 1, 4096, dict(n_layers=4), None))
MOE_REDUCED = {
    "arctic_480b": ["batch and sequence: prefill_32k's (32, 32768) -> (1, 4096), Arctic's "
                    "published context", "n_layers 35 -> 2: 27.68 B parameters, 55.4 GB in bf16 "
                    "(476.8 B at full depth)", "the yardsticks (kernel vs plain bf16; float32 "
                    "layer by layer; float32 kernel vs a one-ulp embedding; the MoE oracle): "
                    "n_layers 2 -> 1, 14.07 B parameters (56.3 GB in float32)"],
    "deepseek_v3_671b": ["batch and sequence: prefill_32k's (32, 32768) -> (1, 4096)",
                         "n_layers 61 -> 4: the 3 dense-prefix layers and 1 MoE layer, 15.11 B "
                         "parameters, 30.2 GB in bf16 (671.0 B at full depth; 60.4 GB in float32, "
                         "where the yardsticks, the MoE oracle and the MLA decode gate run)"],
}
#: phase 20's gates: the tokens the MoE layer's oracle takes, and its
#: tolerance (absolute, a share of the oracle's largest |entry|, and
#: relative: float32 sums over d 7168 and 4864 or 2048 in another order);
#: the positions the MLA decode is held to `forward` on, and the tolerance
#: (tests/test_distributed_equivalence.py:104-106)
MOE_TOKENS, MOE_ORACLE_TOL = 64, 1e-5
MLA_POSITIONS, MLA_DECODE_TOL = 32, 2e-2
#: the exit codes for no card and for no port beside the script
EXIT_NO_CARD, EXIT_NO_PORT = 4, 5
RTOL, ATOL = 5e-7, 1e-5
XI, ETA, AB = 1e-28, 10, (0.6356, 0.4025)
#: the exhaustive sweep's launches of the objective kernel, (B, G, N) with
#: the feasibility mask: Table II's full levels (1024 chunks of one
#: assignment) and the per-family oracle gate (2 chunks of 64)
SWEEP_SHAPES = ((1, 800000, 4), (64, 6912, 3))
#: phase 13's scenarios per family (Table I: N 10, K 50)
FAMILY_B = 16
#: phase 14's Table II grid (benchmarks/table2_exhaustive.py, full levels)
TABLE2_LEVELS = dict(f_levels=(0.25e9, 2e9, 5), p_levels_dbm=(4.0, 20.0, 4), rho_levels=(0.2, 1.0, 5))
#: floating-point operations per (candidate, device) of eq. 13 as the kernel
#: evaluates it (divisions, products, sums, compares; exp/log counted once)
OPS_PER_ELEMENT = 24
#: phase 15's stream: Table I's (10, 50) (bucket (16, 64)) and (6, 16)
#: (bucket (8, 16)) at the Table-I bbar, Poisson arrivals at the serving
#: CLI's default rate, its default batching policy
SERVE_SIZES = ((10, 50), (6, 16))
SERVE_REQUESTS = 12
SERVE_RATE_HZ = 20.0
SERVE_MAX_BATCH, SERVE_MAX_WAIT_S = 8, 0.05
#: the real-clock driver's drain bound (a flush takes about 3 s)
SERVE_TIMEOUT_S = 900.0
#: phase 3's cuts: the SCA solve runs at `cut_configs()` depth (53-81 s at
#: default depth), and the PGD solve's plain-scoring twin (about 23 s at
#: default depth) too, against a kernel solve at that depth; the PGD
#: main-path solve keeps its depth
SCA_REDUCED = ("allocator depth: AllocatorConfig() -> cut_configs()['sca'] (1 outer iteration, "
               "P5 1 x 100, 100 PGD steps): at default depth it took 53-81 s on an NVIDIA H100 "
               "80GB HBM3, host to host, and chip_smoke.py ran past its 1200 s limit")
TWIN_REDUCED = ("the plain-scoring twins at cut depth: AllocatorConfig(inner='pgd') -> "
                "cut_configs()['pgd'] (1 outer iteration, 100 PGD steps), held for identical X, P "
                "and rho against a kernel solve at that depth; SCA's against its main-path solve, "
                "which runs at cut depth (SCA_REDUCED): with the SCA twin at default depth "
                "chip_smoke.py took 1214 s, past its 1200 s limit, on an NVIDIA H100 80GB HBM3 at "
                "700 W")
#: phases 13 and 15: the allocator's depth, cut to the reference's smoke
#: allocator as phase 16's (its solves are host-bound, about 20 s each at
#: default depth); with them at default depth chip_smoke.py ran past its
#: 1200 s limit on an NVIDIA H100 80GB HBM3
FAMILY_REDUCED = ("allocator depth: AllocatorConfig(inner='pgd') -> the reference's smoke "
                  "allocator, AllocatorConfig(inner='pgd', outer_iters=2, "
                  "pgd=PGDConfig(steps=60)), for the three families phase 3 does not solve "
                  "(about 27 s each at default depth)")
SERVE_REDUCED = ("allocator depth: AllocatorConfig(inner='pgd') -> the reference's smoke "
                 "allocator, AllocatorConfig(inner='pgd', outer_iters=2, "
                 "pgd=PGDConfig(steps=60)): at default depth a cold flush took about 26 s and "
                 "the phase about 280 s")
#: phase 16: `fedsem_e2e`'s seed, and its cuts: the allocator's depth, and
#: the FL rounds a job (about 33 s of the phase a round on an NVIDIA H100
#: 80GB HBM3, 50 s on a slower host)
FEDSEM_SEED = 0
FEDSEM_ROUNDS = 3
FEDSEM_REDUCED = ("allocator depth: AllocatorConfig(inner='pgd') -> the reference's smoke "
                  "allocator, AllocatorConfig(inner='pgd', outer_iters=2, "
                  "pgd=PGDConfig(steps=60)); about 50 allocations at default depth would take "
                  "about 18 s each; FL rounds a job: the full harness's 6 -> 3, the reference's "
                  "smoke harness's: with 6 the phase took 200-300 s and chip_smoke.py ran past its "
                  "1200 s limit on an NVIDIA H100 80GB HBM3 at 700 W")

#: phase 17: the full-width training run (`launch.train`'s defaults: B 8,
#: S 128, lr 1e-3, clip 1.0), and the smoke variants trained beside it
TRAIN_ARCH = "qwen2_5_3b"
TRAIN_B, TRAIN_S, TRAIN_LR, TRAIN_CLIP, TRAIN_STEPS = 8, 128, 1e-3, 1.0, 5
TRAIN_SMOKE = (("gemma2_2b", {}), ("rwkv6_1_6b", {}),
               ("jamba_1_5_large_398b", dict(n_experts=0, top_k=0)),
               ("arctic_480b", {}), ("deepseek_v3_671b", {}))
#: step 0's loss against the same loss through the flash kernel (bf16)
TRAIN_KERNEL_RTOL = 1e-3
TRAIN_REDUCED = ("tokens: uniform draws from a seeded torch.Generator, not the bigram chain: "
                 "its (vocab, vocab) float32 table is 92 GB at vocab 151936; one fixed batch, "
                 "so 5 steps overfit it")
#: phase 18: `launch.federated_lm`'s defaults, and the full-width round
FED_ARCH, FED_ROUNDS, FED_CLIENTS = "qwen2_5_3b", 8, 4
FED_FULL_CLIENTS, FED_FULL_SEQ = 2, 64
#: the full-width round's rho (its solve answers 1), and the fraction the
#: float32 probe leaves are sparsified at
FED_FULL_RHO, FED_PROBE_RHO = 0.4, 0.3
FED_REDUCED = ("allocator depth, both parts: the example's AllocatorConfig(inner='pgd') -> the "
               "reference's smoke allocator (2 outer iterations, 60 PGD steps): at default depth "
               "part (a)'s one solve took 28.6 s, and would take about twice that on a slower "
               "host; the full-width round: tokens uniform from a seeded torch.Generator (the "
               "bigram table would be 92 GB), 2 clients, 1 round, 1 local SGD step, the solved "
               "allocation's rho (1) held at 0.4 so that every leaf is sparsified below 1")

#: phase 21: the paper's drivers and examples at Table-I width, the allocator
#: at cut depth; the autoencoder example's rounds and rates
PAPER_REDUCED = ("allocator depth: every driver's and example's AllocatorConfig -> "
                 "cut_configs()['sca'] (1 outer iteration, P5 1 x 100, 100 PGD steps), its inner "
                 "set per call, with 2 outer iterations for alg_analysis, whose convergence check "
                 "reads the trace's last two; at default depth the seven drivers' quick grids "
                 "took 836 s on an NVIDIA H100 80GB HBM3 (python -m repro_torch.paper.run); "
                 "fedsem_autoencoder: 40 rounds and 5 rates -> 2 rounds at rho 0.3 and 1.0")
PAPER_AE_ROUNDS, PAPER_AE_RHOS = 2, (0.3, 1.0)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def device_profile(cpu: bool = True):
    """A `torch.profiler` window (the device's activity, and the host's with
    ``cpu``) opened by `PROFILE_LEAD_IN` one-cycle device sleeps, which
    `device_rows` leaves out: the body's leading device records are then
    kept however long the process has profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(PROFILE_LEAD_IN):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        yield prof


def device_rows(prof) -> list:
    """The device's own rows (kernels, copies) of a `device_profile`'s
    `key_averages()`, the lead-in's sleeps left out: a CPU op's row repeats
    the device time of the kernels it launched."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and LEAD_IN_SYMBOL not in e.key]


def graph_ms(fn, reps: int = 20, iters: int = 20) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph and replayed, so no host time sits between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters) / reps


def grid_inputs(gen, B, G, N, device):
    """Candidate grids and parameter rows in the ranges of the CPU tests,
    with masked rows (device 0 always real) and per-row weights."""
    import torch

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    f = u((B, G, N), 1e8, 2e9)
    p = u((B, G, N), 1e-3, 0.1)
    r = u((B, G, N), 1e5, 3e7)
    rho = u((B, G), 0.05, 1.0)
    rows = [u((B, N), 1e3, 1e4), u((B, N), 1e5, 1e6), u((B, N), 1e5, 1e6), u((B, N), 1e5, 1e6)]
    tsc = torch.full((B, N), 0.5, device=device)
    fmax = torch.full((B, N), 2e9, device=device)
    mask = (torch.rand((B, N), generator=gen, device=device) > 0.4).float()
    mask[:, 0] = 1.0
    kap = (torch.linspace(0.5, 2.0, B, device=device), torch.ones(B, device=device),
           torch.full((B,), 1.3, device=device))
    return (f, p, r, rho, *rows, tsc, fmax), mask, kap


def compare(got, want, what: str) -> float:
    """inf mask exactly, finite scores to RTOL/ATOL; returns max abs error."""
    import torch

    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(torch.equal(torch.isinf(got), torch.isinf(want)), f"{what}: +inf masks differ")
    check(not bool(torch.isnan(got).any()), f"{what}: kernel produced nan")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    lim = ATOL + RTOL * want[fin].abs()
    check(bool((err <= lim).all()), f"{what}: max abs err {float(err.max())} beyond rtol {RTOL}, atol {ATOL}")
    return float(err.max()) if err.numel() else 0.0


def bound(B, G, N, check_feasible):
    """(ms, 'bytes'|'operations'): the least time for eq. 13 on B x G x N.

    Bytes: f, p, r and rho read once, the (B, G) score written once, the
    five (B,) scalars, and the (B, N) rows the function reads: c, d, D, C
    and the device mask, plus t_sc_max and f_max with the feasibility mask.
    """
    rows = 7 if check_feasible else 5
    nbytes = 4 * (3 * B * G * N + B * G + rows * B * N + 5 * B + B * G)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT * B * G * N / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: each flash kernel's symbol in the SASS (its head dim the template
#: argument caught) and the tensor-core instruction its products must be
FLASH_SASS = {"bfloat16": (r"flash_fwd_kernel_sm90ILi\d+ELi(\d+)E", ".BF16"),
              "float32": (r"flash_fwd_kernel_f32_sm90ILi(\d+)E", ".TF32")}


def flash_tensor_core_sass(lib_path) -> dict:
    """Phase 1's proof that both flash kernels run on the tensor cores: the
    `HGMMA` (wgmma) instructions in the SASS (``cuobjdump -sass``) of each
    instantiation (one per head dim) of the bf16 `flash_fwd_kernel_sm90`,
    BF16 ones, and of the float32 `flash_fwd_kernel_f32_sm90`, TF32 ones.
    Returns {dtype: {hd: count}}."""
    from repro_torch.kernels.build import nvcc
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS

    tool = pathlib.Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, at = {dt: {} for dt in FLASH_SASS}, None
    for line in sass.splitlines():
        if "Function :" in line:
            at = None
            for dt, (symbol, _) in FLASH_SASS.items():
                found = re.search(symbol, line)
                if found:
                    at = (dt, int(found.group(1)))
                    counts[dt][at[1]] = 0
        elif at is not None and "HGMMA" in line and FLASH_SASS[at[0]][1] in line:
            counts[at[0]][at[1]] += 1
    for dt, by_hd in counts.items():
        check(sorted(by_hd) == sorted(HEAD_DIMS) and all(by_hd.values()),
              f"flash: the {dt} kernel's SASS lacks {FLASH_SASS[dt][1][1:]} HGMMA at some head "
              f"dim: {by_hd}")
    return counts


def ptxas_report(log: str) -> dict:
    """Per kernel function of a ptxas ``-v`` log: {mangled name: dict(
    registers, spill_bytes (stores + loads), stack_bytes)}."""
    out, fn = {}, None
    for line in log.splitlines():
        found = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?$", line.strip())
        if found:
            fn = found.group(1)
            out.setdefault(fn, dict(registers=None, spill_bytes=0, stack_bytes=0))
            continue
        if fn is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[fn]["stack_bytes"] = int(spill.group(1))
            out[fn]["spill_bytes"] = int(spill.group(2)) + int(spill.group(3))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[fn]["registers"] = int(regs.group(1))
    return out


def phase_kernel(device):
    """Phase 2: kernel vs plain version, timed. Returns per-case records."""
    import torch

    from repro_torch.kernels.fedsem_objective import kernel, ref

    gen = torch.Generator(device=device).manual_seed(1234)
    cases = []
    ab = tuple(torch.tensor(v, device=device) for v in AB)
    for B, G, N in ((16, 3, 10), (48, 1, 10), (64, 8192, 8)) + SWEEP_SHAPES:
        args, mask, kap = grid_inputs(gen, B, G, N, device)
        for feas in (True,) if (B, G, N) in SWEEP_SHAPES else (True, False):
            kw = dict(xi=XI, eta=ETA, check_feasible=feas)
            run_k = lambda: kernel.objective_batch(*args, mask, *kap, *AB, **kw)
            run_p = lambda: ref.objective_grid_batch(*args, *kap, accuracy_ab=ab, dev_mask=mask, **kw)
            err = compare(run_k(), run_p(), f"objective_batch{(B, G, N)} feasible={feas}")
            prep = kernel.prepare(*args, mask, *kap, *AB, **kw)
            iters = 200 if G * B < 10000 else 50
            cases.append(dict(
                entry="objective_batch", shape=[B, G, N], check_feasible=feas, max_abs_err=err,
                ms=graph_ms(lambda: kernel.launch(prep)), plain_ms=graph_ms(run_p),
                wrapper_ms=cuda_ms(run_k, iters), plain_eager_ms=cuda_ms(run_p, iters),
                **dict(zip(("bound_ms", "bound_by"), bound(B, G, N, feas))),
            ))
    # objective_grid: one scenario, feasibility on, half the devices masked
    G, N = 1024, 10
    args, _, _ = grid_inputs(gen, 1, G, N, device)
    one = [a[0] for a in args]
    mask = torch.tensor([1.0] * 5 + [0.0] * 5, device=device)
    scal = dict(xi=XI, eta=ETA, k1=0.8, k2=1.0, k3=1.2, a_acc=AB[0], b_acc=AB[1])
    run_k = lambda: kernel.objective_grid(*one, mask, **scal)
    kap = [torch.tensor(v, device=device) for v in (0.8, 1.0, 1.2)]
    run_p = lambda: ref.objective_grid(*one, XI, ETA, *kap, ab, mask)
    err = compare(run_k(), run_p(), "objective_grid(1024, 10)")
    prep = kernel.prepare(*(a[None] for a in one), mask[None], 0.8, 1.0, 1.2, *AB, xi=XI, eta=ETA)
    cases.append(dict(
        entry="objective_grid", shape=[1, G, N], check_feasible=True, max_abs_err=err,
        ms=graph_ms(lambda: kernel.launch(prep)), plain_ms=graph_ms(run_p),
        wrapper_ms=cuda_ms(run_k, 200), plain_eager_ms=cuda_ms(run_p, 200),
        **dict(zip(("bound_ms", "bound_by"), bound(1, G, N, True))),
    ))
    torch.cuda.synchronize()
    return cases


def check_binary_x(params, X, what: str) -> None:
    check(bool(((X == 0) | (X == 1)).all()), f"{what}: X is not binary")
    check(bool((X.sum(dim=-2) == params.sc_mask).all()), f"{what}: a subcarrier not owned exactly once")


def check_allocation(params, res, what: str) -> None:
    import torch

    from repro_torch.core.system import feasible

    a = res.alloc
    for name in ("f", "P", "X", "rho"):
        check(bool(torch.isfinite(getattr(a, name)).all()), f"{what}: non-finite {name}")
    check(bool(torch.isfinite(res.trace).all()), f"{what}: non-finite trace")
    check_binary_x(params, a.X, what)
    check(bool((a.X.sum(dim=-1) >= 1).all()), f"{what}: a device owns no subcarrier")
    check(bool(feasible(params, a).all()), f"{what}: infeasible allocation")


def phase_slice(device):
    """Phase 3: `solve_batch` at Table-I width on the card."""
    import torch

    from repro_torch.core import AllocatorConfig, Weights, solve_batch
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.core.types import tree_map
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.scenarios import get_family

    fam = get_family("iid_rayleigh")
    params = fam.sample_batch(0, 16, N=10, K=50, device=device)
    check(params.g.is_cuda and params.g.shape == (16, 10, 50), "scenarios not drawn on the card")
    w = Weights.ones(device)
    configs = {"pgd": AllocatorConfig(inner="pgd"), "sca": cut_configs()["sca"]}   # `SCA_REDUCED`

    solves = {}
    zero_launches()                          # the allocator path starts here
    for name, cfg in configs.items():
        before = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batch(params, w, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernel.launches - before
        check_allocation(params, res, f"solve_batch[{name}]")
        check(n >= cfg.outer_iters + 1,
              f"solve_batch[{name}]: {n} kernel launches < outer_iters + 1 = {cfg.outer_iters + 1}")
        solves[name] = dict(res=res, wall_s=wall, launches=n)
        print(f"solve_batch[{name}] B=16 N=10 K=50: {wall:.3f} s wall, {n} kernel launches", flush=True)
    solves["sca"]["reduced"] = SCA_REDUCED
    print(f"solve_batch[sca] reduced: {SCA_REDUCED}", flush=True)
    main_path_launches = only_objective_launched("the allocator path")    # ... and ends here

    # the plain-scoring twins at cut depth (`TWIN_REDUCED`), each against a
    # kernel solve at that depth (the main path's where it ran there),
    # whose launches are a comparison's, not the path's
    compare_launches = 0
    for name, cfg in cut_configs().items():
        if cfg == configs[name]:
            on = solves[name]["res"].alloc
        else:
            before = kernel.launches
            on = solve_batch(params, w, cfg).alloc
            compare_launches += kernel.launches - before
        solves[name]["plain_scoring_reduced"] = TWIN_REDUCED
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = solve_batch(params, w, cfg._replace(use_kernel_objective=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for leaf in ("X", "P", "rho"):
            check(torch.equal(getattr(off.alloc, leaf), getattr(on, leaf)),
                  f"solve_batch[{name}]: use_kernel_objective=False changes {leaf}")
        solves[name]["plain_scoring_wall_s"] = wall
        print(f"solve_batch[{name}] use_kernel_objective=False at cut depth: {wall:.3f} s wall, "
              "identical X, P, rho", flush=True)
    print(f"solve_batch reduced: {TWIN_REDUCED}", flush=True)
    check(kernel.launches == main_path_launches + compare_launches,
          "the plain scoring path launched the kernel")

    # the port on the card against the port on the CPU, on a small input
    small_cfg = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=80))
    small = fam.sample_batch(7, 2, N=4, K=12, device="cpu")
    cpu = solve_batch(small, Weights.ones(), small_cfg)
    gpu = solve_batch(tree_map(lambda x: x.to(device), small), w, small_cfg)
    check(torch.equal(gpu.alloc.X.cpu(), cpu.alloc.X), "card and CPU disagree on a small input's X")
    print("small input (B=2, N=4, K=12): card and CPU give the same hardened X", flush=True)
    return {k: {kk: vv for kk, vv in v.items() if kk != "res"} for k, v in solves.items()}, \
        main_path_launches, (params, solves["pgd"]["res"])


def cut_configs() -> dict:
    """The serving and the default config at cut depth (1 outer iteration,
    100 PGD steps; SCA's P5 1 x 100): their step structure, a fraction of
    their steps, for phase 3's plain-scoring twins, the profiled solves and
    phase 15's profiled flush."""
    from repro_torch.core import AllocatorConfig
    from repro_torch.core.p5 import P5Config
    from repro_torch.core.pgd import PGDConfig

    return {
        "pgd": AllocatorConfig(inner="pgd", outer_iters=1, pgd=PGDConfig(steps=100)),
        "sca": AllocatorConfig(outer_iters=1, p5=P5Config(outer_iters=1, inner_iters=100),
                               pgd=PGDConfig(steps=100)),
    }


def phase_profile(device):
    """Where a solve's time goes: one short solve per config (the default
    configs' step structure at cut depth) under `torch.profiler`, with the
    device's busy time against the unprofiled wall time."""
    import torch

    from repro_torch.core import Weights, solve_batch
    from repro_torch.scenarios import get_family

    params = get_family("iid_rayleigh").sample_batch(0, 16, N=10, K=50, device=device)
    w = Weights.ones(device)
    out = {}
    for name, cfg in cut_configs().items():
        solve_batch(params, w, cfg)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve_batch(params, w, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with device_profile() as prof:
            t0 = time.perf_counter()
            solve_batch(params, w, cfg)
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        on_dev = device_rows(prof)
        dev_us = lambda e: e.self_device_time_total
        busy_s = sum(dev_us(e) for e in on_dev) / 1e6
        kernels = sum(e.count for e in prof.key_averages()
                      if "LaunchKernel" in e.key) - PROFILE_LEAD_IN
        check(busy_s > 0, f"profile[{name}]: the profiler saw no device time")
        check(busy_s <= wall_prof, f"profile[{name}]: device time {busy_s} s > wall {wall_prof} s")
        top = sorted(on_dev, key=dev_us, reverse=True)[:6]
        out[name] = dict(wall_s=wall, wall_profiled_s=wall_prof, device_busy_s=busy_s,
                         busy_share=busy_s / wall, kernel_launches=kernels,
                         top=[(e.key, dev_us(e) / 1e3, e.count) for e in top])
        print(f"profile[{name}] (cut depth): wall {wall:.3f} s ({wall_prof:.3f} s profiled), "
              f"device busy {busy_s:.4f} s = {100 * busy_s / wall:.2f}% of wall, "
              f"{kernels} kernel launches", flush=True)
        for key, ms, count in out[name]["top"]:
            print(f"  {ms:9.2f} ms  x{count:<7d} {key[:90]}")
    return out


def attention_pairs(S: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of one (batch, head): the work the
    attention needs on these inputs."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window is not None else 0
        hi = q + 1 if causal else S
        total += hi - lo
    return total


def flash_bound(B, S, H, KV, hd, dtype, causal, window, op_hd=None, cuda_cores=False):
    """(ms, 'bytes'|'operations'): the least time that meets the type's
    gate: q, k, v read once and the output written once, against the
    operations per unmasked pair and head on the tensor cores: bf16 4 * hd
    at 989 TFLOP/s; float32 12 * hd at TF32's 495 (three TF32 products:
    one misses the float32 gate, tests/test_torch_flash_attention.py's
    test_f32_kernel_needs_three_tf32_products), or with ``cuda_cores`` 4 *
    hd at the CUDA cores' 67 (a float32 FMA design's bound). With
    ``op_hd`` the operations are counted at that head dim (a padded design's
    own floor)."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    pairs = B * H * attention_pairs(S, causal, window)
    if dtype == torch.bfloat16:
        flops, peak = 4 * (op_hd or hd) * pairs, BF16_FLOPS_PER_S
    elif cuda_cores:
        flops, peak = 4 * (op_hd or hd) * pairs, FP32_FLOPS_PER_S
    else:
        flops, peak = 12 * (op_hd or hd) * pairs, TF32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: phase 4's cases: (name, (B, S, H, KV, hd), dtype, causal, window, cap)
FLASH_CASES = [
    *((f"mha {dt}", (1, 128, 4, 4, 64), dt, True, None, None) for dt in ("float32", "bfloat16")),
    *((f"gqa {dt}", (2, 256, 4, 2, 64), dt, True, None, None) for dt in ("float32", "bfloat16")),
    *((f"mqa {dt}", (1, 256, 8, 1, 32), dt, True, None, None) for dt in ("float32", "bfloat16")),
    *((f"ragged S {dt}", (1, 192, 2, 2, 128), dt, True, None, None) for dt in ("float32", "bfloat16")),
    ("window", (2, 256, 4, 2, 64), "float32", True, 64, None),
    ("softcap", (2, 256, 4, 2, 64), "float32", True, None, 50.0),
    ("non-causal", (2, 256, 4, 2, 64), "float32", False, None, None),
    ("hd 256 window softcap", (1, 160, 2, 1, 256), "float32", True, 64, 50.0),
    ("gemma2_2b global", (1, 8192, 8, 4, 256), "bfloat16", True, None, 50.0),
    ("gemma2_2b local", (1, 8192, 8, 4, 256), "bfloat16", True, 4096, 50.0),
    ("qwen2_5_3b", (1, 8192, 16, 2, 128), "bfloat16", True, None, None),
    ("jamba_1_5_large_398b attn", (1, 4096, 64, 8, 128), "bfloat16", True, None, None),
    ("arctic_480b attn", (1, 4096, 56, 8, 128), "bfloat16", True, None, None),   # phase 20
    # phase 19's layers: HuBERT's (bidirectional, hd 80 at a padded width in
    # bf16, 30 s of 50 Hz frames: the last 128-row block ragged)
    ("hubert_xlarge", (4, 1500, 16, 16, 80), "bfloat16", False, None, None),
    ("hubert_xlarge float32", (4, 1500, 16, 16, 80), "float32", False, None, None),
    ("starcoder2_3b", (1, 8192, 24, 2, 128), "bfloat16", True, None, None),
    # the float32 yardsticks' full-width layers (phases 5 and 19)
    ("starcoder2_3b float32", (1, 8192, 24, 2, 128), "float32", True, None, None),
    ("gemma2_2b global float32", (1, 8192, 8, 4, 256), "float32", True, None, 50.0),
    ("pixtral_12b", (1, 8192, 32, 8, 128), "bfloat16", True, None, None),
    ("gemma2_9b global", (1, 8192, 16, 8, 256), "bfloat16", True, None, 50.0),
    ("gemma2_9b local", (1, 8192, 16, 8, 256), "bfloat16", True, 4096, 50.0),
]


def library_call(q, k, v, causal, window, cap, compiled_flex):
    """One PyTorch call that computes the same attention, over the (B, heads,
    S, hd) views with GQA on: `scaled_dot_product_attention` with the
    causal/window mask, or, with a softcap, `flex_attention` (compiled) with
    cap * tanh(s / cap) as its score_mod and the mask as its block mask."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.flex_attention import create_block_mask

    S = q.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if cap is not None:
        def keep(b, h, qi, ki):
            m = (ki <= qi) if causal else (ki >= 0)
            return m & (qi - ki < window) if window is not None else m

        blocks = create_block_mask(keep, None, None, S, S, device=q.device)
        score = lambda s, b, h, qi, ki: cap * torch.tanh(s / cap)
        return lambda: compiled_flex(qt, kt, vt, score_mod=score, block_mask=blocks,
                                     enable_gqa=True).transpose(1, 2)
    mask = None
    if window is not None:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] - pos[None, :] < window
        if causal:
            mask &= pos[None, :] <= pos[:, None]
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True,
    ).transpose(1, 2)


def phase_flash(device):
    """Phase 4: the flash kernel against its plain version, timed."""
    import torch
    from torch.nn.attention.flex_attention import flex_attention

    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.models.attention import flash_attention as plain_flash

    compiled_flex = torch.compile(flex_attention, dynamic=False)
    gen = torch.Generator(device=device).manual_seed(4321)
    cases = []
    for name, (B, S, H, KV, hd), dt, causal, window, cap in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device=device).to(dtype)
                   for n in (H, KV, KV))
        pos = torch.arange(S, dtype=torch.int32, device=device)
        run_k = lambda: kernel.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
        run_p = lambda: plain_flash(q, k, v, q_positions=pos, kv_positions=pos,
                                    causal=causal, window=window, cap=cap)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        atol, rtol = FLASH_TOL[dt]
        check(bool(torch.isfinite(got.float()).all()), f"flash[{name}]: non-finite output")
        check(got.dtype == dtype and got.shape == want.shape, f"flash[{name}]: dtype or shape")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"flash[{name}]: max abs err {float(err.max())} beyond atol {atol} + rtol {rtol}")
        run_l = library_call(q, k, v, causal, window, cap, compiled_flex)
        library = "flex_attention" if cap is not None else "scaled_dot_product_attention"
        lib_err = (run_l().float() - want.float()).abs()
        tol = LIBRARY_TOL[dt]
        check(bool((lib_err <= tol + tol * want.float().abs()).all()),
              f"flash[{name}]: {library} differs from the plain version by {float(lib_err.max())}")
        # the library call against the kernel's own gate: recorded, not required
        lib_gate = float((lib_err / (atol + rtol * want.float().abs())).max())
        big = S >= 4096
        reps, iters = (2, 3) if big else (20, 20)
        rec = dict(case=name, shape=[B, S, H, KV, hd], dtype=dt, causal=causal, window=window,
                   cap=cap, atol=atol, rtol=rtol, max_abs_err=float(err.max()),
                   out_mean_abs=float(want.float().abs().mean()),
                   out_mean_abs_last_row=float(want[:, -1].float().abs().mean()),
                   ms=graph_ms(run_k, reps, iters), plain_ms=graph_ms(run_p, reps, iters),
                   library=library, library_ms=graph_ms(run_l, reps, iters),
                   library_max_abs_err=float(lib_err.max()), library_gate_ratio=lib_gate)
        rec["bound_ms"], rec["bound_by"] = flash_bound(B, S, H, KV, hd, dtype, causal, window)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        rec["library_factor"] = rec["ms"] / rec["library_ms"]
        if dtype == torch.float32:                        # the CUDA-core design's bound, beside
            rec["fp32_core_bound_ms"], _ = flash_bound(B, S, H, KV, hd, dtype, causal, window,
                                                       cuda_cores=True)
        width = kernel.instantiated_hd(hd, dtype)
        if width != hd:                                   # the padded design's own floor
            rec["padded_width"] = width
            rec["padded_bound_ms"], _ = flash_bound(B, S, H, KV, hd, dtype, causal, window, width)
            print(f"flash[{name}]: hd {hd} at width {width}: its own floor "
                  f"{rec['padded_bound_ms']:.5f} ms ({width}/{hd} of the operations), "
                  f"{100 * rec['padded_bound_ms'] / rec['ms']:.2f}% of it reached", flush=True)
        cases.append(rec)
        print(f"flash[{name}] {tuple(rec['shape'])} {dt}: kernel {rec['ms']:.5f} ms, plain "
              f"{rec['plain_ms']:.5f} ms, {library} {rec['library_ms']:.5f} ms, bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}); max abs err "
              f"{rec['max_abs_err']:.3g} (mean |out| {rec['out_mean_abs']:.3g}, last row "
              f"{rec['out_mean_abs_last_row']:.3g}; {library} {rec['library_max_abs_err']:.3g})",
              flush=True)
        if dtype == torch.bfloat16:
            print(f"flash[{name}] bf16: {100 * rec['bound_share']:.2f}% of the bound, "
                  f"{rec['library_factor']:.3f}x {library}; {library} "
                  f"{'within' if lib_gate <= 1.0 else 'outside'} the one-ulp gate "
                  f"({lib_gate:.3g} of it)", flush=True)
        else:
            print(f"flash[{name}] float32: {100 * rec['bound_share']:.2f}% of the 3xTF32 bound, "
                  f"{100 * rec['fp32_core_bound_ms'] / rec['ms']:.2f}% of the CUDA cores' "
                  f"{rec['fp32_core_bound_ms']:.5f} ms (fp32_core_bound_ms), "
                  f"{rec['library_factor']:.3f}x {library}; {library} at "
                  f"{lib_gate:.3g} of the float32 gate", flush=True)
    torch.cuda.synchronize()
    return cases


def wkv_bound(B, H, S, hd, dtype, w_dtype, out_dtype):
    """(ms, 'bytes'|'operations'): the float32 operations the function needs
    over the float32 peak, against r, k, v (``dtype``) and w read once, y
    written once and u (float32) read once. The function needs y_j =
    sum_i r_i S_ij + v_j sum_i r_i u_i k_i, the bonus term factored out of
    the (key, column) loop, as the kernel evaluates it."""
    import torch

    size = lambda dt: torch.tensor([], dtype=dt).element_size()
    nbytes = B * H * S * hd * (3 * size(dtype) + size(w_dtype) + size(out_dtype)) + 4 * H * hd
    flops = B * H * S * (WKV_OPS * hd * hd + (WKV_OPS_KEY + WKV_OPS_COL) * hd)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: phase 7's cases: (name, (B, H, S, hd), type of r/k/v, of w, of y, the law
#: of w: the reference test's sigmoid law, the model's exp(-exp(-6 + 0.5 z))
#: (near 0.9975) or a strong decay exp(-exp(1 + 0.5 z)) (near 0.07)); the
#: model's and the strong law in the model's (B, S, H, hd) layout. The
#: full-width cases: all float32, and the types the bf16 model hands over
#: (the main path's)
WKV_CASES = [
    *((f"reference (1, 2, 128, 64) {dt}", (1, 2, 128, 64), dt, dt, dt, "reference")
      for dt in ("float32", "bfloat16")),
    *((f"reference (2, 4, 96, 32) {dt}", (2, 4, 96, 32), dt, dt, dt, "reference")
      for dt in ("float32", "bfloat16")),
    *((f"ragged S {dt}", (2, 3, 77, 64), dt, dt, dt, "reference") for dt in ("float32", "bfloat16")),
    ("strong decay", (2, 4, 1024, 64), "bfloat16", "float32", "float32", "strong"),
    ("rwkv6_1_6b layer float32", (1, 32, 4096, 64), "float32", "float32", "float32", "model"),
    ("rwkv6_1_6b layer", (1, 32, 4096, 64), "bfloat16", "float32", "float32", "model"),
]
#: the (mean, scale) of the normal z in w = exp(-exp(mean + scale z)) by law
WKV_DECAY_LAWS = {"model": (-6.0, 0.5), "strong": (1.0, 0.5)}
#: the phase-7 case at the shape and types the RWKV prefill launches the kernel with
WKV_MAIN = "rwkv6_1_6b layer"


def phase_wkv(device):
    """Phase 7: the WKV6 kernel against its plain version, timed."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel, ref

    gen = torch.Generator(device=device).manual_seed(2468)
    cases = []
    for name, (B, H, S, hd), dt, dt_w, dt_y, law in WKV_CASES:
        dtype, w_dtype, out_dtype = (getattr(torch, t) for t in (dt, dt_w, dt_y))
        # (B, S, H, hd) tensors seen as (B, H, S, hd) views, as the model hands them over
        draw = lambda: torch.randn((B, S, H, hd), generator=gen, device=device).transpose(1, 2)
        r, k, v = draw(), draw(), draw()
        if law in WKV_DECAY_LAWS:
            mean, scale = WKV_DECAY_LAWS[law]
            w = torch.exp(-torch.exp(mean + scale * draw()))
        else:   # the reference test's law
            w = torch.sigmoid(draw()) * 0.5 + 0.45
        u = torch.randn((H, hd), generator=gen, device=device)
        r, k, v, u = (x.to(dtype) for x in (r, k, v, u))
        w = w.to(w_dtype)
        run_k = lambda: kernel.rwkv6_scan(r, k, v, w, u, out_dtype)
        run_p = lambda: ref.rwkv6_scan(r, k, v, w, u, out_dtype=out_dtype)[0]
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        atol, rtol = WKV_TOL[dt_y]
        check(bool(torch.isfinite(got.float()).all()), f"wkv[{name}]: non-finite output")
        check(got.dtype == out_dtype and got.shape == want.shape, f"wkv[{name}]: dtype or shape")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"wkv[{name}]: max abs err {float(err.max())} beyond atol {atol} + rtol {rtol}")
        rec = dict(case=name, shape=[B, H, S, hd], dtype=dt, w_dtype=dt_w, out_dtype=dt_y,
                   atol=atol, rtol=rtol,
                   max_abs_err=float(err.max()), out_mean_abs=float(want.float().abs().mean()),
                   w_mean=float(w.float().mean()), ms=graph_ms(run_k))
        if S <= 1024:
            rec["plain_ms"], rec["plain_timing"] = graph_ms(run_p, 1, 5), "graph replay"
        else:
            rec["plain_ms"], rec["plain_timing"] = cuda_ms(run_p, 1), "events around one eager call"
        rec["bound_ms"], rec["bound_by"] = wkv_bound(B, H, S, hd, dtype, w_dtype, out_dtype)
        cases.append(rec)
        print(f"wkv[{name}] {tuple(rec['shape'])} r/k/v {dt}, w {dt_w}, y {dt_y}: kernel {rec['ms']:.5f} ms, plain "
              f"{rec['plain_ms']:.5f} ms ({rec['plain_timing']}), bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}); max abs err {rec['max_abs_err']:.3g} (mean |y| "
              f"{rec['out_mean_abs']:.3g}, mean w {rec['w_mean']:.5f})", flush=True)
    torch.cuda.synchronize()
    return cases


def scan_bound(B, S, di, N, x_dtype, dt_dtype, b_dtype):
    """(ms, 'bytes'|'operations', parts): the least time of the selective
    scan. Operations: one exponential per (step, channel, state) and the
    float32 operations of `SCAN_OPS`/`SCAN_OPS_CHANNEL` at the float32 peak.
    Each exponential runs either on the exponential unit (`EXP_PER_S`) or as
    a polynomial of `EXP_POLY_OPS` on the float32 pipe beside the other
    float32 work; the bound takes the share of polynomials that levels the
    two. Bytes: x, dt, B, C read once, y (x's type) written once, A and D
    (float32) read once. ``parts``: the exponentials all on their unit, the
    float32 work alone, the bytes (ms each) and the polynomial share."""
    import torch

    size = lambda dt: torch.tensor([], dtype=dt).element_size()
    nbytes = (B * S * di * (2 * size(x_dtype) + size(dt_dtype))
              + 2 * B * S * N * size(b_dtype) + 4 * di * (N + 1))
    t_exp = B * S * di * N / EXP_PER_S * 1e3
    t_flops = B * S * di * (SCAN_OPS * N + SCAN_OPS_CHANNEL) / FP32_FLOPS_PER_S * 1e3
    t_poly = B * S * di * N * EXP_POLY_OPS / FP32_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # a share f of polynomials: the unit takes (1 - f) t_exp, the pipe t_flops + f t_poly
    share = max(0.0, (t_exp - t_flops) / (t_exp + t_poly))
    t_ops = max((1 - share) * t_exp, t_flops + share * t_poly)
    kind = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), kind, dict(bound_exp_ms=t_exp, bound_fp32_ms=t_flops,
                                           bound_bytes_ms=t_bytes, bound_poly_share=share)


#: phase 10's cases: (name, (B, S, di, N), type of x (and y), of dt, of B/C,
#: the law: the reference test's, the model's (dt = softplus(-4.6 + 0.5 z),
#: near softplus(log(expm1(0.01))); A = -(1..N); B/C as column views of one
#: projection) or a deep one (the model's with dt = softplus(z + 2), so that
#: dt A reaches about -100, where exp(dt A) underflows))
SCAN_CASES = [
    *((f"reference (1, 64, 128, 8) {dt}", (1, 64, 128, 8), dt, dt, "float32", "reference")
      for dt in ("float32", "bfloat16")),
    *((f"reference (2, 96, 64, 16) {dt}", (2, 96, 64, 16), dt, dt, "float32", "reference")
      for dt in ("float32", "bfloat16")),
    *((f"ragged S and di {dt}", (2, 77, 96, 16), dt, dt, "float32", "reference")
      for dt in ("float32", "bfloat16")),
    ("strided B/C", (2, 512, 1024, 16), "bfloat16", "float32", "bfloat16", "model"),
    ("dt A to -100", (1, 1024, 1024, 16), "bfloat16", "float32", "bfloat16", "deep"),
    ("jamba_1_5_large_398b layer float32", (1, 4096, 16384, 16), "float32", "float32", "float32",
     "model"),
    ("jamba_1_5_large_398b layer", (1, 4096, 16384, 16), "bfloat16", "float32", "bfloat16",
     "model"),
]
#: the phase-10 case at the shape and types the Jamba prefill launches the kernel with
SCAN_MAIN = "jamba_1_5_large_398b layer"
#: the width of Jamba's x_proj output: dt rank 512 + 2 N
SCAN_PROJ_EXTRA = 512


def phase_scan(device):
    """Phase 10: the selective-scan kernel against its plain version, timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.mamba_scan import kernel, ref

    gen = torch.Generator(device=device).manual_seed(1357)
    draw = lambda *shape: torch.randn(shape, generator=gen, device=device)
    cases = []
    for name, (B, S, di, N), tx, td, tb, law in SCAN_CASES:
        x_dtype, dt_dtype, b_dtype = (getattr(torch, t) for t in (tx, td, tb))
        x = draw(B, S, di).to(x_dtype)
        if law != "reference":   # as the initialised Jamba has them; B and C views of x_proj's output
            z = draw(B, S, di)
            dt = F.softplus(z + 2.0 if law == "deep" else -4.6 + 0.5 * z)
            A = -torch.arange(1, N + 1, dtype=torch.float32, device=device).repeat(di, 1)
            proj = draw(B, S, SCAN_PROJ_EXTRA + 2 * N).to(b_dtype)
            Bm, Cm = proj[..., SCAN_PROJ_EXTRA:SCAN_PROJ_EXTRA + N], proj[..., SCAN_PROJ_EXTRA + N:]
        else:           # the reference test's law
            dt = F.softplus(draw(B, S, di)) * 0.1
            A = -draw(di, N).abs()
            Bm, Cm = draw(B, S, N).to(b_dtype), draw(B, S, N).to(b_dtype)
        dt = dt.to(dt_dtype)
        D = 1.0 + 0.5 * draw(di)
        run_k = lambda: kernel.mamba_scan(x, dt, Bm, Cm, A, D)
        run_p = lambda: ref.mamba_scan(x, dt, Bm, Cm, A, D)[0]
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        atol, rtol = SCAN_TOL[tx]
        check(bool(torch.isfinite(got.float()).all()), f"scan[{name}]: non-finite output")
        check(got.dtype == x_dtype and got.shape == want.shape, f"scan[{name}]: dtype or shape")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"scan[{name}]: max abs err {float(err.max())} beyond atol {atol} + rtol {rtol}")
        rec = dict(case=name, shape=[B, S, di, N], x_dtype=tx, dt_dtype=td, b_dtype=tb,
                   strided_bc=not Bm.is_contiguous(), atol=atol, rtol=rtol,
                   max_abs_err=float(err.max()), out_mean_abs=float(want.float().abs().mean()),
                   dt_mean=float(dt.float().mean()),
                   min_dt_a=float((dt.float().amax() * A.amin()).cpu()), ms=graph_ms(run_k))
        del got, want, err
        if S <= 1024:
            rec["plain_ms"], rec["plain_timing"] = graph_ms(run_p, 1, 5), "graph replay"
        else:
            rec["plain_ms"], rec["plain_timing"] = cuda_ms(run_p, 1), "events around one eager call"
        rec["bound_ms"], rec["bound_by"], parts = scan_bound(B, S, di, N, x_dtype, dt_dtype, b_dtype)
        rec.update(parts)
        cases.append(rec)
        print(f"scan[{name}] {tuple(rec['shape'])} x {tx}, dt {td}, B/C {tb}"
              f"{' (strided)' if rec['strided_bc'] else ''}: kernel {rec['ms']:.5f} ms, "
              f"plain {rec['plain_ms']:.5f} ms ({rec['plain_timing']}), bound {rec['bound_ms']:.5f} ms "
              f"({rec['bound_by']}, {rec['bound_poly_share']:.3f} of the exponentials as "
              f"polynomials; all on the exponential unit {rec['bound_exp_ms']:.5f}, float32 "
              f"{rec['bound_fp32_ms']:.5f}, bytes {rec['bound_bytes_ms']:.5f}); max abs err "
              f"{rec['max_abs_err']:.3g} (mean |y| {rec['out_mean_abs']:.3g}, mean dt "
              f"{rec['dt_mean']:.5f}, dt A down to {rec['min_dt_a']:.1f})", flush=True)
    torch.cuda.synchronize()
    return cases


def lm_batch(cfg, B: int, S: int, gen) -> dict:
    """A prefill batch of `repro_torch.launch.specs.input_specs`' layout at
    (B, S), drawn from ``gen`` on its device: tokens uniform over the
    vocabulary, frame and patch embeddings standard normal in their spec's
    type (bf16); no labels or mask, which a prefill does not read."""
    import torch

    from repro_torch.launch import specs

    out = {}
    for name, spec in specs.input_specs(cfg, "prefill_32k", B, S).items():
        if name == "tokens":
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen, device=gen.device)
        elif name in ("frame_embeds", "patch_embeds"):
            out[name] = torch.randn(spec.shape, generator=gen, device=gen.device).to(spec.dtype)
    return out


def profile_prefill(M, params, cfg, batch, want):
    """One warm kernel prefill of ``batch`` in a `device_profile`: each of
    its kernels' device time and launches (``want``: the launches each
    kernel must show), the matrix products' device time, the device's busy
    time and the top entries."""
    import torch

    with device_profile() as prof:
        t0 = time.perf_counter()
        out = M.prefill(params, cfg, batch, use_kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del out
    on_dev = device_rows(prof)
    dev_ms = lambda es: sum(e.self_device_time_total for e in es) / 1e3
    products = [e for e in on_dev if any(m in e.key.lower() for m in PRODUCT_MARKS)]
    busy = dev_ms(on_dev)
    check(busy > 0, f"profile[{cfg.name}]: the profiler saw no device time")
    kernel_ms, kernel_launches = {}, {}
    for name, n in want.items():
        mine = [e for e in on_dev if KERNEL_SYMBOLS[name] in e.key]
        count = sum(e.count for e in mine)
        check(count == n, f"profile[{cfg.name}]: the trace holds {count} {name} launches, want {n}")
        kernel_ms[name], kernel_launches[name] = dev_ms(mine), count
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return dict(wall_profiled_s=wall, device_busy_ms=busy, kernel_device_ms=kernel_ms,
                kernel_launches=kernel_launches, products_device_ms=dev_ms(products),
                top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])


def layer_by_layer(M, params, cfg, batch, rows):
    """The plain prefill run one layer at a time, each layer also through its
    kernel route on the same input (the model's own layer functions; a MoE
    layer's on its attention half, where the kernel acts: its router's top-k
    is discontinuous, so a float32 ulp there may send a token to another
    expert). Returns (plain logits at ``rows`` of every sequence, (B x rows,
    V), per layer (max |kernel - plain|, the largest ratio of that gap to
    atol + rtol |plain|))."""
    atol, rtol = LM_LAYER_TOL
    x, positions = M._embed(params, cfg, batch)
    gaps = []
    for blk in params.layers:
        if blk.is_moe:
            want = M._mixer(blk, cfg, x, positions, False)
            got = M._mixer(blk, cfg, x, positions, True)
        else:
            want = M._apply_block(blk, cfg, x, positions, False)[0]
            got = M._apply_block(blk, cfg, x, positions, True)[0]
        err = (got - want).abs()
        gaps.append((float(err.max()), float((err / (atol + rtol * want.abs())).max())))
        del got, err
        x = M._ffn(blk, cfg, want)[0] if blk.is_moe else want
    logits = M._head(params, cfg, x[:, rows]).float()
    return logits.reshape(-1, logits.shape[-1]), gaps


def perturb_one_ulp(t, seed):
    """Move every entry of ``t`` (the embedding table; HuBERT's frame
    projection) one ulp up or down at random."""
    import torch

    gen = torch.Generator(device=t.device).manual_seed(seed)
    up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    inf = torch.tensor(float("inf"), dtype=t.dtype, device=t.device)
    with torch.no_grad():
        t.copy_(torch.nextafter(t, torch.where(up, inf, -inf)))


def path_launches(M, cfg) -> dict:
    """Each kernel's launches in one prefill of ``cfg``: one per layer of its
    block kind (`KERNEL_OF_KIND`); MLA attention launches none."""
    kinds = [k for k in M.layer_kinds(cfg) if not (cfg.use_mla and k.startswith("attn"))]
    return {name: sum(KERNEL_OF_KIND[k] == name for k in kinds) for name in KERNELS}


def phase_lm(device, arch, S, cut, B=1, yard_cut=None, checks=None, mesh=None):
    """Full-width ``arch`` (cut by ``cut``, `ModelConfig.scaled` arguments)
    prefill of a (B, S) batch (`lm_batch`) through its kernels (one launch
    per layer of each kernel's block kind) and, for a decoder, `ServeLoop`
    on the same model (phases 5-6, 8-9, 11-12, 19 and 20). The yardsticks
    run on the same model, or, with ``yard_cut``, on its cut
    ``cfg.scaled(**yard_cut)`` (phases 19 and 20). ``checks(params, cfg,
    batch) -> dict``, if given, runs on the bf16 model after the path and
    on the float32 model after its layer-by-layer run (phase 20's gates).
    With ``mesh`` (the (1, 1) mesh on the card) the same warm model runs
    its mesh path too (`mesh_path`), its own path for the launch counts.
    Returns (report, each kernel's launches on the path, the mesh path's
    report and launches or (None, None))."""
    import importlib

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M

    kernels = {name: importlib.import_module(f"repro_torch.kernels.{name}.kernel")
               for name in KERNELS}
    cfg = get_config(arch).scaled(**cut)
    check(cfg.dtype == "bfloat16", f"{arch} is not a bf16 config")
    decoder = cfg.arch_type != "audio"
    out_dim = cfg.vocab if decoder else cfg.n_classes
    want = path_launches(M, cfg)
    mine = [name for name, n in want.items() if n]        # the path's kernels
    seed = 0
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = params_of(params.tree)
    init_s = time.perf_counter() - t0
    print(f"{arch}: {n_params / 1e9:.4f} B parameters in bf16 on the card "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated), init {init_s:.2f} s", flush=True)
    data = torch.Generator(device=device).manual_seed(seed + 1)
    batch = lm_batch(cfg, B, S, data)
    prompts = torch.randint(0, cfg.vocab, (8, 8), generator=data, device=device).tolist()

    for k in kernels.values():                            # the path starts here
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_k = M.prefill(params, cfg, batch, use_kernel=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {name: k.launches for name, k in kernels.items()}
    stats, serve_s = None, None
    if decoder:                                           # an encoder has no decode step
        loop = ServeLoop(cfg, params, batch_slots=4, max_len=256)
        t0 = time.perf_counter()
        results, stats = loop.run(prompts, max_new=16)
        serve_s = time.perf_counter() - t0
        del loop
    launches = {name: k.launches for name, k in kernels.items()}   # ... and ends here
    check(prefill_launches == want,
          f"{arch} prefill launched the kernels {prefill_launches} times, want {want}")
    check(launches == prefill_launches, f"{arch} ServeLoop launched a kernel: {launches}")
    check(tuple(logits_k.shape) == (B, S, out_dim), f"prefill logits shape {tuple(logits_k.shape)}")
    check(bool(torch.isfinite(logits_k).all()), "prefill logits are not finite")
    counts = ", ".join(f"{want[name]} {name}" for name in mine) or "none"
    print(f"{arch} prefill(use_kernel=True) B={B} S={S}: {prefill_s:.3f} s wall (first call), "
          f"launches: {counts}; finite logits {tuple(logits_k.shape)}", flush=True)
    if decoder:
        check(sorted(results) == list(range(8)), f"ServeLoop finished requests {sorted(results)}")
        for i, toks in results.items():
            check(len(toks) == 16 and all(0 <= t < cfg.vocab for t in toks),
                  f"ServeLoop request {i}: {len(toks)} tokens, want 16 in [0, {cfg.vocab})")
        ms_step = 1e3 * sum(stats["step_times"]) / stats["steps"]
        print(f"{arch} ServeLoop 8 requests x 16 tokens, 4 slots: {stats['steps']} steps in "
              f"{serve_s:.3f} s, {ms_step:.2f} ms/step", flush=True)
    checked = {}
    if checks is not None:
        checked["bfloat16"] = checks(params, cfg, batch)

    # the yardsticks: the plain kernels' versions in bf16, and the same model in float32
    rows = torch.cat([torch.arange(0, S, 64, device=device), torch.tensor([S - 1], device=device)])
    timed = {}

    def run(p, c, use_kernel, name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = M.prefill(p, c, batch, use_kernel=use_kernel)
        torch.cuda.synchronize()
        timed[name] = time.perf_counter() - t
        sub = out[:, rows].float()
        del out
        return sub.reshape(-1, sub.shape[-1])

    sub_k = logits_k[:, rows].float().reshape(-1, out_dim)
    meshed, mesh_launches = None, None
    if mesh is not None:                                  # the same weights; a second logits tensor
        meshed, mesh_launches = mesh_path(params, cfg, batch, logits_k, mesh, want, decoder)
    del logits_k
    run(params, cfg, True, "kernel_s")                    # a second, warm call
    prof = profile_prefill(M, params, cfg, batch, {name: want[name] for name in KERNEL_SYMBOLS})
    warm_ms = 1e3 * timed["kernel_s"]
    busy = prof["device_busy_ms"]
    shares = "; ".join(
        f"{prof['kernel_launches'][name]} {name} launches {prof['kernel_device_ms'][name]:.3f} ms = "
        f"{100 * prof['kernel_device_ms'][name] / warm_ms:.2f}% of the wall, "
        f"{100 * prof['kernel_device_ms'][name] / busy:.2f}% of busy" for name in mine) or "no kernel"
    print(f"{arch} warm prefill, profiled ({prof['wall_profiled_s']:.3f} s wall): device busy "
          f"{busy:.2f} ms = {100 * busy / warm_ms:.2f}% of the unprofiled {warm_ms:.2f} ms; "
          f"{shares}; matrix products {prof['products_device_ms']:.3f} ms = "
          f"{100 * prof['products_device_ms'] / busy:.2f}% of busy", flush=True)
    for key, ms, count in prof["top"]:
        print(f"  {ms:9.3f} ms  x{count:<6d} {key[:100]}")
    if yard_cut is not None:                              # the yardsticks' own model
        del params
        torch.cuda.empty_cache()
        cfg = cfg.scaled(**yard_cut)
        params = M.init_params(cfg, torch.Generator(device=device).manual_seed(seed))
        sub_k = run(params, cfg, True, "cut_kernel_s")
    sub_p = run(params, cfg, False, "plain_s")
    del params
    torch.cuda.empty_cache()
    cfg32 = cfg.scaled(dtype="float32")
    params32 = M.init_params(cfg32, torch.Generator(device=device).manual_seed(seed))
    sub_fk = run(params32, cfg32, True, "float32_kernel_s")
    prof32 = None
    if arch == F32_PROFILE_ARCH:                          # a second, warm float32 kernel prefill
        prof32 = profile_prefill(M, params32, cfg32, batch,
                                 {name: want[name] for name in KERNEL_SYMBOLS})
        busy32 = prof32["device_busy_ms"]
        print(f"{arch} float32 warm kernel prefill, profiled ({prof32['wall_profiled_s']:.3f} s "
              f"wall): device busy {busy32:.2f} ms; " + "; ".join(
                  f"{prof32['kernel_launches'][name]} {name} launches "
                  f"{prof32['kernel_device_ms'][name]:.3f} ms = "
                  f"{100 * prof32['kernel_device_ms'][name] / busy32:.2f}% of busy"
                  for name in mine) + f"; matrix products {prof32['products_device_ms']:.3f} ms "
              f"= {100 * prof32['products_device_ms'] / busy32:.2f}% of busy", flush=True)
        for key, ms, count in prof32["top"]:
            print(f"  {ms:9.3f} ms  x{count:<6d} {key[:100]}")
    t0 = time.perf_counter()
    sub_f, layer_gaps = layer_by_layer(M, params32, cfg32, batch, rows)
    torch.cuda.synchronize()
    timed["float32_layer_by_layer_s"] = time.perf_counter() - t0
    if checks is not None:
        checked["float32"] = checks(params32, cfg32, batch)
    perturb_one_ulp(params32.embed if decoder else params32.frontend_proj, seed + 2)
    sub_fq = run(params32, cfg32, False, "float32_ulp_plain_s")
    del params32
    torch.cuda.empty_cache()
    gap = lambda a, b: float((a - b).abs().max())
    worst_row = lambda a, b: int(rows[int((a - b).abs().amax(-1).argmax()) % rows.numel()])
    gap_kp, gap_pf, gap_kf = gap(sub_k, sub_p), gap(sub_p, sub_f), gap(sub_k, sub_f)
    gap_f32, gap_ulp = gap(sub_fk, sub_f), gap(sub_fq, sub_f)
    layer_err = max(g[0] for g in layer_gaps)
    layer_ratio = max(g[1] for g in layer_gaps)
    moved = "embedding" if decoder else "frame projection"
    where = "" if yard_cut is None else f" (the yardsticks on {cfg.n_layers} layers)"
    print(f"{arch} prefill logits at {rows.numel()} positions{where} (|logit| <= "
          f"{float(sub_f.abs().max()):.3f}): kernel vs plain bf16 {gap_kp:.5g} (position "
          f"{worst_row(sub_k, sub_p)}), plain bf16 vs float32 {gap_pf:.5g} (position "
          f"{worst_row(sub_p, sub_f)}), kernel vs float32 {gap_kf:.5g}; in float32: kernel vs "
          f"plain {gap_f32:.5g} (position {worst_row(sub_fk, sub_f)}), one-ulp {moved} vs "
          f"plain {gap_ulp:.5g} (position {worst_row(sub_fq, sub_f)}); each layer's kernel route "
          f"on the plain input: max abs err {layer_err:.3g}, at most {layer_ratio:.3g} of atol "
          f"{LM_LAYER_TOL[0]} + rtol {LM_LAYER_TOL[1]}; wall: kernel {timed['kernel_s']:.3f} s, "
          f"plain {timed['plain_s']:.3f} s, float32 kernel {timed['float32_kernel_s']:.3f} s, "
          f"float32 layer by layer {timed['float32_layer_by_layer_s']:.3f} s, float32 plain "
          f"{timed['float32_ulp_plain_s']:.3f} s", flush=True)
    check(gap_kp <= gap_pf,
          f"{arch}: kernel prefill differs from the plain one by {gap_kp}, more than bf16 rounding ({gap_pf})")
    check(layer_ratio <= 1.0,
          f"{arch}: a float32 layer's kernel route differs from its plain route by {layer_err} "
          f"({layer_ratio} of the tolerance)")
    check(gap_f32 <= LM_F32_ULP_FACTOR * gap_ulp,
          f"{arch}: float32 kernel prefill differs from the plain one by {gap_f32}, more than "
          f"{LM_F32_ULP_FACTOR} x a one-ulp {moved} perturbation's {gap_ulp}")
    report = dict(arch=arch, cut=cut, yard_cut=yard_cut, batch=B, tokens=S, params=n_params,
                  init_s=init_s, prefill_first_s=prefill_s, **timed,
                  prefill_launches=prefill_launches, profile=prof, profile_float32=prof32,
                  kernel_share_of_warm_prefill={name: prof["kernel_device_ms"][name] / warm_ms
                                                for name in mine},
                  gap_kernel_plain=gap_kp, gap_plain_float32=gap_pf, gap_kernel_float32=gap_kf,
                  gap_float32_kernel_plain=gap_f32, gap_float32_one_ulp=gap_ulp,
                  layer_gaps=layer_gaps, checks=checked)
    if decoder:
        report.update(serve_steps=stats["steps"], serve_s=serve_s, serve_ms_per_step=ms_step)
    report["mesh"] = meshed
    return report, launches, mesh_launches


def mesh_path(params, cfg, batch, logits, mesh, want, decoder):
    """The model's mesh path on the (1, 1) mesh, over `phase_lm`'s warm
    bf16 parameters placed by `parallel.sharding.param_specs` (DTensors
    whose local tensors are the parameters themselves, no copy): the
    prefill (``use_kernel=True``) must give the logits of the unsharded
    prefill (``logits``) bit for bit at the same kernel launches, and two `ServeLoop` decode steps on a cache placed by
    `cache_specs` the unsharded loop's logits bit for bit, launching no
    kernel. Returns (report, launches), the path's own counts."""
    import importlib

    import torch

    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as SH

    kernels = {name: importlib.import_module(f"repro_torch.kernels.{name}.kernel") for name in KERNELS}
    t_path = time.perf_counter()
    placed = SH.shard_tree(mesh, SH.param_specs(params.tree), params.tree)
    check(placed["embed"].to_local().data_ptr() == params.tree["embed"].data_ptr(),
          f"{cfg.name}: the mesh's parameters are a copy, not the model's own tensors")
    zero_launches()                                       # the mesh path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = M.prefill(placed, cfg, batch, mesh=mesh, use_kernel=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {name: k.launches for name, k in kernels.items()}
    check(tuple(got.shape) == tuple(logits.shape), f"mesh prefill logits {tuple(got.shape)}")
    same_prefill = torch.equal(got.to_local(), logits)
    del got
    same_decode, steps = None, 2
    t_decode = time.perf_counter()
    if decoder:
        loops = (ServeLoop(cfg, params, 4, 256), ServeLoop(cfg, placed, 4, 256, mesh=mesh))
        gen = torch.Generator(device=params.device).manual_seed(3)
        same_decode = True
        for pos in range(steps):
            tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen, device=params.device)
            a, b = loops[0].step(tok, pos), loops[1].step(tok, pos)
            same_decode = same_decode and torch.equal(a, b.to_local())
        del loops
    launches = {name: k.launches for name, k in kernels.items()}   # ... and ends here
    wall, decode_s = time.perf_counter() - t_path, time.perf_counter() - t_decode
    check(prefill_launches == want,
          f"{cfg.name} mesh prefill launched the kernels {prefill_launches} times, want {want}")
    check(launches == prefill_launches, f"{cfg.name} mesh ServeLoop launched a kernel: {launches}")
    check(same_prefill, f"{cfg.name}: the (1, 1) mesh's prefill logits differ from the unsharded ones")
    check(same_decode is not False, f"{cfg.name}: the (1, 1) mesh's decode logits differ from the unsharded ones")
    print(f"{cfg.name} on the (1, 1) mesh: prefill {prefill_s:.3f} s (warm), logits bit for bit: "
          f"{same_prefill}; launches {prefill_launches}; {steps if decoder else 0} ServeLoop decode "
          f"steps bit for bit: {same_decode} ({decode_s:.2f} s with the caches); the mesh path "
          f"{wall:.2f} s", flush=True)
    return dict(prefill_s=prefill_s, wall_s=wall, decode_s=decode_s, launches=prefill_launches,
                prefill_bit_for_bit=same_prefill, decode_bit_for_bit=same_decode), launches


def phase_lm_path(device, i, mesh):
    """Phases 5-6, 8-9 or 11-12: `LM_PATHS[i]` through `phase_lm` with its
    mesh path, its cuts of time (`LM_REDUCED`) in its report."""
    arch, S, cut, yard_cut = LM_PATHS[i]
    rep, launches, meshed = phase_lm(device, arch, S, cut, yard_cut=yard_cut, mesh=mesh)
    if arch in LM_REDUCED:
        rep["reduced"] = LM_REDUCED[arch]
        print(f"{arch} reduced: " + "; ".join(LM_REDUCED[arch]), flush=True)
    return rep, launches, meshed


def phase_models(device):
    """Phase 19: each of `MODEL_PATHS` through `phase_lm` at its published
    widths and depth (its yardsticks on a cut where one is given). Returns
    (reports by arch, each kernel's launches by arch)."""
    import torch

    reports, launches = {}, {}
    for arch, B, S, yard_cut in MODEL_PATHS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep, n, _ = phase_lm(device, arch, S, {}, B=B, yard_cut=yard_cut)
        rep.update(wall_s=time.perf_counter() - t0, reduced=MODEL_REDUCED[arch])
        reports[arch], launches[arch] = rep, n
        print(f"{arch}: phase 19 part {rep['wall_s']:.2f} s; reduced: "
              + "; ".join(MODEL_REDUCED[arch]), flush=True)
    return reports, launches


def moe_oracle(p, cfg, x):
    """The MoE layer ``p`` on tokens x (T, d), token by token: each token's
    kept assignments (an expert's first ``capacity`` in the reference's
    dispatch order: token by token, by rank), each its gate times that
    expert's SwiGLU of the token, summed, plus the shared experts and the
    dense residual. Returns (out (T, d), the dropped assignments)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe

    w, ids, _ = moe.router_topk(p["router"], x, cfg.top_k)
    T, E = x.shape[0], cfg.n_experts
    capacity = moe.capacity_of(cfg, T, E)
    load, dropped = [0] * E, 0
    out = torch.zeros_like(x)
    for t, (experts, gates) in enumerate(zip(ids.tolist(), w.tolist())):
        for e, g in zip(experts, gates):
            load[e] += 1
            if load[e] > capacity:
                dropped += 1
                continue
            h = F.silu(x[t] @ p["w_gate"][e]) * (x[t] @ p["w_up"][e])
            out[t] += g * (h @ p["w_down"][e])
    for extra in ("shared", "dense_res"):
        if extra in p:
            out += moe.dense_ffn(p[extra], cfg, x)
    return out, dropped


def moe_mla_checks(params, cfg, batch) -> dict:
    """Phase 20's gates on one model, at the FFN norm of the prompt's token
    embeddings at the first MoE layer. bf16: the layer on every prompt token
    twice, bit for bit. float32: the layer on `MOE_TOKENS` of them sampled
    against `moe_oracle`, with the dropped assignments equal; with MLA, the
    decode of the first `MLA_POSITIONS` positions against `forward`'s
    logits there."""
    import torch

    from repro_torch.models import model as M, moe
    from repro_torch.models.layers import rms_norm

    out = {}
    tokens = batch["tokens"]
    blk = next(b for b in params.layers if b.is_moe)
    x = rms_norm(params.embed[tokens[0]], blk.ffn_ln, cfg.norm_eps)
    if cfg.dtype == "bfloat16":
        first, second = (moe.moe_ffn_local(blk.ffn, cfg, x)[0] for _ in range(2))
        check(torch.equal(first, second), f"{cfg.name}: two bf16 runs of the MoE layer differ")
        out["bf16_runs_equal"] = True
        print(f"{cfg.name} MoE layer, bf16, {x.shape[0]} tokens: two runs bit for bit equal",
              flush=True)
        return out
    gen = torch.Generator(device=x.device).manual_seed(20)
    xs = x[torch.randperm(x.shape[0], generator=gen, device=x.device)[:MOE_TOKENS]]
    t0 = time.perf_counter()
    got, _ = moe.moe_ffn_local(blk.ffn, cfg, xs)
    want, dropped = moe_oracle(blk.ffn, cfg, xs)
    torch.cuda.synchronize()
    w, ids, _ = moe.router_topk(blk.ffn["router"], xs, cfg.top_k)
    capacity = moe.capacity_of(cfg, MOE_TOKENS, cfg.n_experts)
    slots = moe._dispatch_tables(ids, w, cfg.n_experts, capacity)[2]
    dropped_layer = int((slots == cfg.n_experts * capacity).sum())
    scale = float(want.abs().max())
    err = (got - want).abs()
    ratio = float((err / (MOE_ORACLE_TOL * scale + MOE_ORACLE_TOL * want.abs())).max())
    out.update(moe_tokens=MOE_TOKENS, capacity=capacity, dropped=dropped_layer,
               dropped_oracle=dropped, oracle_max_abs_err=float(err.max()), oracle_scale=scale,
               oracle_gate_ratio=ratio, oracle_s=time.perf_counter() - t0)
    print(f"{cfg.name} MoE layer, float32, {MOE_TOKENS} sampled tokens, capacity {capacity}: "
          f"{dropped_layer} assignments dropped (the oracle's count {dropped}); vs the per-token "
          f"oracle max abs err {out['oracle_max_abs_err']:.4g} (|oracle| <= {scale:.4g}), "
          f"{ratio:.3g} of the tolerance", flush=True)
    check(dropped_layer == dropped,
          f"{cfg.name}: the layer dropped {dropped_layer} assignments, the oracle {dropped}")
    check(ratio <= 1.0, f"{cfg.name}: the MoE layer differs from its per-token oracle by "
          f"{out['oracle_max_abs_err']} ({ratio} of the tolerance)")
    if cfg.use_mla:
        n = MLA_POSITIONS
        full = M.prefill(params, cfg, batch, use_kernel=False)[:, :n].float().clone()
        cache = M.init_cache(cfg, tokens.shape[0], n, tokens.device)
        steps = [M.decode_step(params, cfg, tokens[:, pos:pos + 1], pos, cache)[0]
                 for pos in range(n)]
        gap = float((torch.cat(steps, dim=1).float() - full).abs().max())
        out.update(mla_positions=n, mla_decode_gap=gap, mla_logit_scale=float(full.abs().max()))
        print(f"{cfg.name} MLA: float32 decode of the first {n} positions vs forward's logits: "
              f"max abs gap {gap:.4g} (|logit| <= {out['mla_logit_scale']:.4g}; gate "
              f"{MLA_DECODE_TOL})", flush=True)
        check(gap <= MLA_DECODE_TOL, f"{cfg.name}: MLA decode differs from forward by {gap}")
    return out


def phase_moe(device):
    """Phase 20: each of `MOE_PATHS` through `phase_lm` with `moe_mla_checks`.
    Returns (reports by arch, each kernel's launches by arch)."""
    import torch

    reports, launches = {}, {}
    for arch, B, S, cut, yard_cut in MOE_PATHS:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep, n, _ = phase_lm(device, arch, S, cut, B=B, yard_cut=yard_cut, checks=moe_mla_checks)
        rep.update(wall_s=time.perf_counter() - t0, reduced=MOE_REDUCED[arch])
        reports[arch], launches[arch] = rep, n
        print(f"{arch}: phase 20 part {rep['wall_s']:.2f} s; reduced: "
              + "; ".join(MOE_REDUCED[arch]), flush=True)
    return reports, launches


def p4_rows(device, rows: int, seed: int, N: int = 10, K: int = 50, pad=None):
    """Rows of the ``iid_rayleigh`` family (padded into the bucket ``pad``)
    with the full-payload start's payload, rate floor and round-robin warm
    start, as logits: (params, kappa1, payload, rmin, z, w, w_tot, X0)."""
    import torch

    from repro_torch.core import pad_params, pgd
    from repro_torch.core.allocator import equal_start
    from repro_torch.scenarios import get_family

    params = get_family("iid_rayleigh").sample_batch(seed, rows, N=N, K=K, device=device)
    if pad is not None:
        params = pad_params(params, *pad)
    _, P0, X0 = equal_start(params)
    kappa1 = torch.ones(rows, device=device)
    return (params, kappa1, params.D + params.C, params.C / params.t_sc_max,
            *pgd._pgd_start(params, P0, X0), X0)


def p4_bound(mode: str, rows: int, steps: int, N: int = 10, K: int = 50):
    """(ms, 'operations'|'special functions'|'bytes'): the least time of a
    call: `P4_OPS` an entry and step at one float32 operation a lane and
    clock, or 16 special functions a clock and SM (`EXP_PER_S`), or each
    row's inputs read and outputs written once."""
    ops, sfu = P4_OPS[mode]
    entries = rows * steps * N * K
    nk = (5 if mode == "pgd" else 4) * N * K + (2 * K if mode == "pgd" else 0)
    nbytes = 4 * rows * (nk + 6 * N + K + 1)
    cands = ((entries * ops / (FP32_FLOPS_PER_S / 2) * 1e3, "operations"),
             (entries * sfu / EXP_PER_S * 1e3, "special functions"),
             (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    return max(cands)


def phase_p4_adam(device):
    """Phase 22: the Adam loops' kernel (`kernels/p4_adam`) at the allocation
    benchmark's shapes and at `P4_EXTRA`, timed on the device beside its
    bound and the eager loop, and each timed call's final decode held to the
    eager loop's (P4 loss gap, in the median, and the share of identical
    hardened X); held to the eager loop for one step on every entry of the
    main path's rows and over 800 steps on every row of `P4_CHECK_ROWS`."""
    import torch

    from repro_torch.core import pgd
    from repro_torch.core.allocator import harden_x
    from repro_torch.core.pgd import PGDConfig
    from repro_torch.kernels.p4_adam import kernel as p4_kernel, ops as p4_ops

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().with_name("tests")))
    import p4_adam_checks

    cases, n0 = [], p4_kernel.launches
    shapes = [(mode, 10, 50, None, rows, steps) for mode, rows, steps in P4_CASES] + list(P4_EXTRA)
    for mode, N, K, pad, rows, steps in shapes:
        params, kappa1, payload, rmin, z, w, w_tot, X0 = p4_rows(device, rows, rows, N, K, pad)
        cfg = PGDConfig(steps=steps)
        if mode == "pgd":
            routes = (lambda: p4_ops.pgd_loop(params, kappa1, payload, rmin, z, w, w_tot, cfg),
                      lambda: pgd._pgd_loop(params, kappa1, payload, rmin, z, w, w_tot, cfg))
        else:
            Xb = harden_x(X0, params.N, params.K, params.dev_mask, params.sc_mask)
            args = (params, kappa1, payload, rmin, Xb, w, w_tot, steps, cfg.lr, cfg.penalty_rate)
            routes = (lambda: p4_ops.power_loop(*args), lambda: pgd._power_loop(*args))
        last = [None, None]                       # each route's last (P, X)
        keep = lambda i: lambda: last.__setitem__(i, routes[i]()[:2])
        before = p4_kernel.launches
        ms = cuda_ms(keep(0), 3)
        check(p4_kernel.launches - before == 4, f"p4_adam {mode} {rows}: not one launch a call")
        plain_ms = cuda_ms(keep(1), 1)
        bound_ms, bound_by = p4_bound(mode, rows, steps, params.N, params.K)
        shape = (params.N, params.K) if pad is None else (N, K, "padded", pad)
        loss = [p4_adam_checks.p4_loss(params, kappa1, payload, rmin, P, X, cfg) for P, X in last]
        gap = (loss[0] - loss[1]) / loss[1].abs()
        hard = [harden_x(X, params.N, params.K, params.dev_mask, params.sc_mask) for _, X in last]
        same = float(torch.all((hard[0] == hard[1]).flatten(1), dim=1).float().mean())
        cases.append(dict(mode=mode, shape=shape, rows=rows, steps=steps, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, loss_gap=float(gap.median()),
                          loss_gap_max=float(gap.abs().max()), same_hardened_x=same))
        print(f"p4_adam {mode} ({rows} rows x {steps} steps, N K {shape}): device {ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms ({bound_by}, {100 * bound_ms / ms:.1f}% reached), "
              f"eager loop {plain_ms:.1f} ms ({plain_ms / ms:.1f}x); against it: relative P4 "
              f"loss gap median {float(gap.median()):.3e}, max |gap| {float(gap.abs().max()):.3e}, "
              f"identical hardened X {same:.4f}", flush=True)
        check(bool(torch.isfinite(loss[0]).all()), f"p4_adam {mode} {shape}: a non-finite loss")
        check(float(gap.median()) <= P4_LOSS_GAP,
              f"p4_adam {mode} {shape}: median relative loss gap {float(gap.median())} > {P4_LOSS_GAP}")
        check(same >= p4_adam_checks.P4_SAME_X,
              f"p4_adam {mode} {shape}: identical hardened X on a share {same} < {p4_adam_checks.P4_SAME_X}")
        del params, z, w, w_tot, X0, routes, last, hard
        torch.cuda.empty_cache()

    # every entry of the main path's rows, one step, both modes
    for mode in ("pgd", "power"):
        p4_adam_checks.one_step_check(device, (10, 50), None, mode, rows=P4_CASES[0][1])
        torch.cuda.empty_cache()
    print(f"p4_adam one step on {P4_CASES[0][1]} rows, both modes: every entry within the "
          "one-step gates", flush=True)
    gaps, finite, same = p4_adam_checks.loss_gaps(device, 10, 50, rows=P4_CHECK_ROWS)
    check(finite, "p4_adam: a non-finite loss")
    med, worst = float(gaps.median()), float(gaps.abs().max())
    print(f"p4_adam vs eager loop, {P4_CHECK_ROWS} rows x 800 steps: relative P4 loss gap median "
          f"{med:.3e} (gate {P4_LOSS_GAP}), max |gap| {worst:.3e} (gate "
          f"{p4_adam_checks.P4_ROW_GAP}), identical hardened X {same:.4f} (gate "
          f"{p4_adam_checks.P4_SAME_X})", flush=True)
    check(med <= P4_LOSS_GAP, f"p4_adam: median relative loss gap {med} > {P4_LOSS_GAP}")
    check(worst <= p4_adam_checks.P4_ROW_GAP,
          f"p4_adam: a row's relative loss gap {worst} > {p4_adam_checks.P4_ROW_GAP}")
    check(same >= p4_adam_checks.P4_SAME_X,
          f"p4_adam: identical hardened X on a share {same} < {p4_adam_checks.P4_SAME_X}")
    return dict(cases=cases, loss_gap=med, loss_gap_max=worst, same_hardened_x=same,
                launches=p4_kernel.launches - n0)


#: calls of `core.pgd.solve_p4_pgd` and `core.pgd.power_given_x` on the card
#: since `zero_launches` (`count_adam_calls` installs the count); and each
#: allocator path's p4_adam launches, filed by `only_objective_launched`
ADAM_CALLS = [0]
P4_BY_PATH: dict = {}


def count_adam_calls() -> None:
    """Count every call of the two Adam loops on CUDA tensors, under each
    name the allocator and the baselines look them up by."""
    import functools

    from repro_torch.core import allocator, baselines, pgd

    def counted(fn):
        @functools.wraps(fn)
        def call(params, *args, **kwargs):
            ADAM_CALLS[0] += bool(params.g.is_cuda)
            return fn(params, *args, **kwargs)
        return call

    for name in ("solve_p4_pgd", "power_given_x"):
        wrapped = counted(getattr(pgd, name))
        for mod in (pgd, allocator, baselines):
            if hasattr(mod, name):
                setattr(mod, name, wrapped)


def zero_launches():
    """Set every kernel's launch count to 0 (the start of a path)."""
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.p4_adam import kernel as p4_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel

    kernel.launches = flash_kernel.launches = wkv_kernel.launches = scan_kernel.launches = 0
    p4_kernel.launches = ADAM_CALLS[0] = 0


def check_no_lm_kernel(what: str) -> None:
    """No flash, WKV or selective-scan launch since `zero_launches` (the
    allocator paths, and training, which takes the plain sequence mixers
    as the reference's does)."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel

    check(flash_kernel.launches == wkv_kernel.launches == scan_kernel.launches == 0,
          f"{what} launched the flash, the WKV or the selective-scan kernel")


def only_objective_launched(what: str) -> int:
    """The end of an allocator path: its objective-kernel launches; no LM
    kernel may have launched, and the Adam loops' kernel exactly once for
    each of the path's Adam loops on the card (filed in `P4_BY_PATH`)."""
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.kernels.p4_adam import kernel as p4_kernel

    check_no_lm_kernel(what)
    check(p4_kernel.launches == ADAM_CALLS[0],
          f"{what}: {p4_kernel.launches} p4_adam launches for {ADAM_CALLS[0]} Adam loops on the card")
    P4_BY_PATH[what] = p4_kernel.launches
    print(f"{what}: {p4_kernel.launches} p4_adam launches, one for each Adam loop", flush=True)
    return kernel.launches


def phase_families(device, iid_pgd):
    """Phase 13: each scenario family's Table-I batch through Alg. A2 (PGD)
    and the four baselines. ``iid_pgd`` is phase 3's (params, result) on the
    same ``iid_rayleigh`` draw; the other families' solves run at the
    reference's smoke depth (`FAMILY_REDUCED`)."""
    import torch

    from repro_torch.core import Weights, solve_batch
    from repro_torch.core import baselines as B
    from repro_torch.core.system import feasible, report
    from repro_torch.launch.fedsem_e2e import SMOKE_ALLOCATOR
    from repro_torch.scenarios import build_classes, get_family, list_families

    cfg = SMOKE_ALLOCATOR
    w = Weights.ones(device)
    out = {}
    zero_launches()                                   # the families' path starts here
    for name in list_families():
        params = get_family(name).sample_batch(0, FAMILY_B, N=10, K=50, device=device)
        check(params.g.is_cuda and params.g.shape == (FAMILY_B, 10, 50), f"{name}: not drawn on the card")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "iid_rayleigh":
            check(torch.equal(params.g, iid_pgd[0].g), "iid_rayleigh: not phase 3's draw")
            res, wall = iid_pgd[1], None
        else:
            res = solve_batch(params, w, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check_allocation(params, res, f"families[{name}]")
        a2 = report(params, w, res.alloc)["objective"]
        bases = {
            "equal": B.equal_allocation(params),
            "comm_only": B.comm_opt_only(params, w, 1),
            "comp_only": B.comp_opt_only(params, w),
            "random": B.random_allocation(params, 2),
        }
        rec = dict(solve_s=wall, a2_mean=float(a2.mean()), baselines={},
                   reduced=None if wall is None else FAMILY_REDUCED)
        for bname, alloc in bases.items():
            what = f"families[{name}] {bname}"
            for leaf in ("f", "P", "X", "rho"):
                check(bool(torch.isfinite(getattr(alloc, leaf)).all()), f"{what}: non-finite {leaf}")
            if bname == "comm_only":           # PGD's relaxed X, as the reference's
                X = alloc.X
                check(bool(((X >= 0) & (X <= 1)).all() and (X.sum(dim=-2) <= 1 + 1e-6).all()),
                      f"{what}: X outside [0, 1] or a subcarrier owned more than once")
            else:
                check_binary_x(params, alloc.X, what)
            obj = report(params, w, alloc)["objective"]
            ok = feasible(params, alloc)
            worse = (a2 > obj + 1e-3) & ok
            check(not bool(worse.any()), f"{what}: Alg. A2 worse than a feasible baseline on "
                  f"{int(worse.sum())} scenarios ({a2[worse].tolist()} > {obj[worse].tolist()})")
            rec["baselines"][bname] = dict(infeasible=int((~ok).sum()), mean=float(obj.mean()))
        out[name] = rec
        infeasible = {b: r["infeasible"] for b, r in rec["baselines"].items()}
        print(f"families[{name}] B={FAMILY_B} N=10 K=50: solve_batch[pgd] "
              + (f"{wall:.3f} s" if wall is not None else "phase 3's")
              + f", Alg. A2 mean objective {rec['a2_mean']:.6g}, feasible; baselines' mean "
              + ", ".join(f"{b} {r['mean']:.6g}" for b, r in rec["baselines"].items())
              + f"; infeasible baselines (not compared): {infeasible}", flush=True)
    print(f"families reduced: {FAMILY_REDUCED}", flush=True)
    n = only_objective_launched("the families' path")    # ... and ends here
    check(n > 0, "the families' path never launched the objective kernel")
    classes = build_classes()
    print("hetero_classes device classes: " + "; ".join(
        f"{c.arch}: c {c.c_cycles:.6g}, f_max {c.f_max_hz:.3g} Hz, p_max {c.p_max_dbm} dBm"
        for c in classes), flush=True)
    return out, n, [c._asdict() for c in classes]


def sweep_pair(params, w, levels, what: str):
    """One exhaustive sweep with the kernel and one with its plain version
    on the same card tensors: the same answer (or, on a tie, values within
    phase 2's tolerance), one kernel launch per chunk of assignments and
    none plain. Returns (kernel result, plain result, record)."""
    import torch

    from repro_torch.core.exhaustive import default_chunk, solve_exhaustive
    from repro_torch.core.system import feasible, report
    from repro_torch.kernels.fedsem_objective import kernel

    N, K = params.N, params.K
    G = (len(levels["f_levels"]) * len(levels["p_levels_dbm"])) ** N * len(levels["rho_levels"])
    chunk = default_chunk(G, N)
    want_launches = -(-N**K // chunk)
    runs, rec = {}, {"launch_shape": [chunk, G, N]}
    for route, use_kernel in (("kernel", True), ("plain", False)):
        before = kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex = solve_exhaustive(params, w, **levels, use_kernel=use_kernel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = kernel.launches - before
        check(n == (want_launches if use_kernel else 0),
              f"{what} {route}: {n} kernel launches, want {want_launches if use_kernel else 0}")
        runs[route] = ex
        rec[route] = dict(wall_s=wall, launches=n, candidates_per_s=ex.n_evaluated / wall,
                          value=float(ex.value))
    k, p = runs["kernel"], runs["plain"]
    same = all(torch.equal(getattr(k.alloc, leaf), getattr(p.alloc, leaf)) for leaf in ("f", "P", "X", "rho"))
    vk, vp = float(k.value), float(p.value)
    check(abs(vk - vp) <= ATOL + RTOL * abs(vp), f"{what}: kernel value {vk} vs plain {vp}")
    check(k.n_evaluated == p.n_evaluated, f"{what}: candidate counts differ")
    for route, ex in runs.items():
        obj = float(report(params, w, ex.alloc)["objective"])
        check(abs(float(ex.value) - obj) <= 1e-5 * abs(obj), f"{what} {route}: value {float(ex.value)} "
              f"!= report objective {obj}")
        check(bool(feasible(params, ex.alloc)), f"{what} {route}: infeasible allocation")
    rec.update(same_allocation=same, n_evaluated=k.n_evaluated)
    if not same:
        print(f"{what}: tie: kernel and plain sweeps pick different candidates, values {vk} and {vp}",
              flush=True)
    return k, p, rec


def phase_oracle(device):
    """Phase 14: the exhaustive oracle through the objective kernel: Table
    II's full grid, then the oracle gate's sweep per family."""
    import numpy as np
    import torch

    from repro_torch.core import AllocatorConfig, Weights, solve
    from repro_torch.core import baselines as B
    from repro_torch.core.system import report
    from repro_torch.scenarios import get_family, list_families

    w = Weights.ones(device)
    levels = {k: np.linspace(*v) for k, v in TABLE2_LEVELS.items()}
    params = get_family("iid_rayleigh").sample(0, N=4, K=5, device=device)
    zero_launches()                                   # the exhaustive path starts here
    ex, _, table2 = sweep_pair(params, w, levels, "Table II sweep")
    gate = {}
    for name in list_families():
        p = get_family(name).sample(2, N=3, K=4, device=device)
        p_hi_dbm = 10.0 * np.log10(float(p.p_max.min())) + 30.0
        gate_levels = dict(f_levels=np.linspace(0.25e9, float(p.f_max.min()), 4),
                           p_levels_dbm=np.linspace(4.0, p_hi_dbm, 3), rho_levels=np.linspace(0.2, 1.0, 4))
        _, _, gate[name] = sweep_pair(p, w, gate_levels, f"oracle gate sweep [{name}]")
    launches = only_objective_launched("the exhaustive path")    # ... and ends here
    check(tuple(table2["launch_shape"]) == SWEEP_SHAPES[0] and table2["kernel"]["launches"] == 1024
          and all(tuple(g["launch_shape"]) == SWEEP_SHAPES[1] and g["kernel"]["launches"] == 2
                  for g in gate.values()),
          f"the sweeps' launches are not phase 2's shapes: {table2['launch_shape']}, "
          f"{[g['launch_shape'] for g in gate.values()]}")
    for route in ("kernel", "plain"):
        r = table2[route]
        print(f"Table II sweep (N 4, K 5, {table2['n_evaluated']} candidates) {route}: "
              f"{r['wall_s']:.4f} s wall, {r['candidates_per_s']:.6g} candidates/s, "
              f"{r['launches']} kernel launches at {tuple(table2['launch_shape'])}, "
              f"value {r['value']:.8g}", flush=True)
    print(f"Table II sweep: kernel and plain give the same allocation: {table2['same_allocation']}; "
          f"the oracle gate's sweeps: " + ", ".join(
              f"{n} {g['kernel']['wall_s']:.4f} s kernel / {g['plain']['wall_s']:.4f} s plain, "
              f"same {g['same_allocation']}" for n, g in gate.items()), flush=True)

    busy = profile_sweep(params, w, levels)

    # Table II's comparison, on the port's draw: Alg. A2 (PGD) and the equal baseline
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a2 = solve(params, w, AllocatorConfig(inner="pgd"))
    torch.cuda.synchronize()
    a2_s = time.perf_counter() - t0
    a2_obj = float(report(params, w, a2.alloc)["objective"])
    eq_obj = float(report(params, w, B.equal_allocation(params))["objective"])
    oracle = float(ex.value)
    projected_years = (4.0**10) * (3.0**10) * 5 * (10.0**50) / table2["kernel"]["candidates_per_s"] / 3.15e7
    claims = {"exhaustive_not_much_better": oracle >= a2_obj - 0.35 * abs(a2_obj),
              "proposed_beats_equal": a2_obj < eq_obj,
              "exhaustive_intractable_at_scale": projected_years > 1e6}
    print(f"Table II instance: Alg. A2 (pgd) objective {a2_obj:.8g} in {a2_s:.3f} s, oracle {oracle:.8g}, "
          f"equal allocation {eq_obj:.8g}; claims (printed, not gated): {claims}", flush=True)
    return dict(table2=table2, gate=gate, profile=busy, a2_objective=a2_obj, a2_s=a2_s,
                equal_objective=eq_obj, claims=claims), launches


def profile_sweep(params, w, levels) -> dict:
    """Where one Table II kernel sweep's time goes: the device's busy time
    (its own events in a `torch.profiler` trace) and the objective kernel's
    share of it, against the unprofiled wall time of a second sweep."""
    import torch

    from repro_torch.core.exhaustive import solve_exhaustive

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve_exhaustive(params, w, **levels, use_kernel=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with device_profile() as prof:
        solve_exhaustive(params, w, **levels, use_kernel=True)
        torch.cuda.synchronize()
    on_dev = device_rows(prof)
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    kern = [e for e in on_dev if "fedsem_objective_kernel" in e.key]
    kernel_ms = sum(e.self_device_time_total for e in kern) / 1e3
    kernel_n = sum(e.count for e in kern)
    check(busy_ms > 0 and kernel_n > 0, "the sweep's profile saw no device time or no kernel")
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    out = dict(wall_s=wall, device_busy_ms=busy_ms, busy_share=busy_ms / 1e3 / wall,
               kernel_ms=kernel_ms, kernel_launches=kernel_n,
               top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])
    print(f"Table II kernel sweep, warm: {wall:.4f} s wall; device busy {busy_ms:.3f} ms "
          f"({100 * out['busy_share']:.1f}% of wall), the kernel {kernel_ms:.3f} ms in "
          f"{kernel_n} launches ({1e3 * kernel_ms / max(kernel_n, 1):.3f} us each)", flush=True)
    for key, ms, count in out["top"]:
        print(f"  {ms:9.3f} ms  x{count:<7d} {key[:90]}")
    return out


class FirstCalls(dict):
    """An `AllocService` solver cache that records each key's first-call
    time (``first_call_s``, ending in a synchronize) and every cold call's
    trace (``cold_traces``), for phase 15's report."""

    def __init__(self):
        super().__init__()
        self.first_call_s, self.cold_traces = {}, []

    def __setitem__(self, key, program):
        import torch

        def timed(*args):
            t0 = time.perf_counter()
            out = program(*args)
            torch.cuda.synchronize()
            self.first_call_s.setdefault(key, time.perf_counter() - t0)
            if "warm-refine" not in key:
                self.cold_traces.append(out.trace.cpu())
            return out
        super().__setitem__(key, timed)


def check_completions(requests, completions, what: str) -> None:
    """Every request answered once, with a binary, feasible allocation of
    its exact shape whose `Completion.objective` is `system.objective` on
    the exact-shape scenario to rtol 1e-5."""
    import torch

    from repro_torch.core import Weights
    from repro_torch.core.system import feasible, objective

    check(sorted(c.req_id for c in completions) == list(range(len(requests))),
          f"{what}: not every request answered exactly once")
    for c in completions:
        p = requests[c.req_id]
        a = c.alloc
        check(a.X.shape == (p.N, p.K), f"{what}: request {c.req_id} answered at shape {tuple(a.X.shape)}")
        for leaf in ("f", "P", "X", "rho"):
            check(bool(torch.isfinite(getattr(a, leaf)).all()), f"{what}: non-finite {leaf}")
        check_binary_x(p, a.X, f"{what} request {c.req_id}")
        check(bool((a.X.sum(dim=-1) >= 1).all()), f"{what}: a device owns no subcarrier")
        check(bool(feasible(p, a)), f"{what}: request {c.req_id} infeasible")
        want = float(objective(p, Weights.ones(p.device), a))
        check(abs(c.objective - want) <= 1e-5 * abs(want),
              f"{what}: request {c.req_id} objective {c.objective} != system.objective {want}")


def serving_summary(svc, completions, makespan_s: float, what: str) -> dict:
    """Phase 15's numbers of one pass, printed and returned."""
    import numpy as np

    lat = [c.latency_s for c in completions]
    m = svc.metrics.summary()
    out = dict(requests=len(completions), flushes=m["batches"], makespan_s=makespan_s,
               throughput_rps=len(completions) / makespan_s,
               latency_p50_s=float(np.percentile(lat, 50)), latency_p99_s=float(np.percentile(lat, 99)),
               solve_s=list(svc.metrics.solves_s.sample), mean_batch_size=m["mean_batch_size"],
               cache_misses=m["cache_misses"], cache_hits=m["cache_hits"], compile_s=m["compile_s"])
    print(f"serving[{what}]: {out['requests']} requests in {out['flushes']} flushes, makespan "
          f"{makespan_s:.3f} s, {out['throughput_rps']:.4f} req/s; latency p50 "
          f"{out['latency_p50_s']:.3f} s, p99 {out['latency_p99_s']:.3f} s; solve_s per flush "
          + ", ".join(f"{t:.3f}" for t in out["solve_s"]), flush=True)
    return out


def serve_once(svc, requests):
    """Submit ``requests`` and drain: (completions, solve seconds)."""
    for p in requests:
        svc.submit(p)
    return svc.drain(now=0.0)


def profile_flush(svc, requests) -> dict:
    """One cold flush (solvers already called once) under `torch.profiler`
    (device activity only: the host's trace of a flush is slow to read
    back): the device's busy time and the objective kernel's."""
    with device_profile(cpu=False) as prof:
        done, solve_s = serve_once(svc, requests)
    on_dev = device_rows(prof)
    busy_s = sum(e.self_device_time_total for e in on_dev) / 1e6
    kern = [e for e in on_dev if "fedsem_objective_kernel" in e.key]
    check(busy_s > 0 and sum(e.count for e in kern) > 0,
          "the serving flush's profile saw no device time or no kernel")
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    out = dict(requests=len(done), solve_s_profiled=solve_s, device_busy_s=busy_s,
               kernel_ms=sum(e.self_device_time_total for e in kern) / 1e3,
               kernel_launches=sum(e.count for e in kern),
               top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])
    return out


class Counting:
    """Replace ``module.name`` with a wrapper that counts its calls (and
    records each call's launch shape for the kernel's `launch`) until
    `restore`."""

    def __init__(self, counts, key, module, name, shape_of=None):
        self.module, self.name, self.orig = module, name, getattr(module, name)

        def wrapped(*args, **kwargs):
            counts[key if shape_of is None else shape_of(*args)] += 1
            return self.orig(*args, **kwargs)
        setattr(module, name, wrapped)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def phase_serving(device):
    """Phase 15: the allocation service at Table-I width on the card: the
    real-clock driver, its virtual replay and a warm pass, then the plain
    scoring path and one profiled flush."""
    import collections

    import torch

    from repro_torch.core import Weights, default_accuracy
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.launch.fedsem_e2e import SMOKE_ALLOCATOR
    from repro_torch.scenarios import DEFAULT_STREAM_BBAR
    from repro_torch.serve import (
        AllocService, BatchPolicy, RealClockDriver, ServeConfig, WarmStartConfig,
        entry_from_alloc, iters_to_converge, pace_stream, poisson_arrivals, request_signature,
        run_load, same_hardened_assignments, scenario_stream,
    )

    cfg = ServeConfig(policy=BatchPolicy(max_batch=SERVE_MAX_BATCH, max_wait_s=SERVE_MAX_WAIT_S),
                      allocator=SMOKE_ALLOCATOR)          # `SERVE_REDUCED`
    J = cfg.allocator.outer_iters
    cold_launches, warm_launches = J + 2, 2 * J + 3     # trace, selection, scoring; + refine
    check((cold_launches, warm_launches) == (4, 7), "unexpected launch counts per flush")
    requests = scenario_stream(0, SERVE_REQUESTS, scenario="iid_rayleigh", sizes=SERVE_SIZES,
                               bbar=DEFAULT_STREAM_BBAR, device=device)
    check(all(p.g.is_cuda for p in requests), "the stream was not drawn on the card")
    arrivals = poisson_arrivals(1, SERVE_REQUESTS, SERVE_RATE_HZ)
    programs = FirstCalls()
    shapes = collections.Counter()
    report = dict(reduced=SERVE_REDUCED)
    print(f"serving reduced: {SERVE_REDUCED}", flush=True)
    zero_launches()                                   # the serving path starts here
    counting = Counting(shapes, None, kernel, "launch", lambda a: (a.B, a.G, a.N))
    try:
        # (a) the real-clock driver, paced arrivals, then a drain
        real_svc = AllocService(cfg, executables=programs, device=device)
        driver = RealClockDriver(real_svc)
        futures, t_start = pace_stream(driver, requests, arrivals)
        driver.close(timeout=SERVE_TIMEOUT_S)
        real = [f.result(timeout=0.0) for f in futures]
        report["real"] = serving_summary(real_svc, real, driver.now() - t_start, "real clock")
        check_completions(requests, real, "serving (real clock)")
        n_a = kernel.launches
        check(n_a == cold_launches * real_svc.metrics.batches,
              f"real clock: {n_a} kernel launches for {real_svc.metrics.batches} cold flushes")

        # (b) the same stream and arrivals on the virtual clock
        virt_svc = AllocService(cfg, executables=programs, device=device)
        virt = run_load(virt_svc, requests, arrivals)
        report["virtual"] = serving_summary(virt_svc, virt.completions, virt.makespan_s, "virtual clock")
        check_completions(requests, virt.completions, "serving (virtual clock)")
        n_b = kernel.launches - n_a
        check(n_b == cold_launches * virt_svc.metrics.batches,
              f"virtual clock: {n_b} kernel launches for {virt_svc.metrics.batches} cold flushes")
        check(same_hardened_assignments(real, virt.completions),
              "the real-clock driver and its virtual replay disagree on some request's X")

        # (c) warm: the cache holds (a)'s solutions, so every request hits;
        # the stream again, all at once
        wcfg = WarmStartConfig()
        warm_svc = AllocService(cfg._replace(warmstart=wcfg), executables=programs, device=device)
        w, acc = Weights.ones(device), default_accuracy(device)
        for c in real:
            warm_svc.warm_cache.put(request_signature(requests[c.req_id], w, acc, wcfg),
                                    entry_from_alloc(c.alloc, c.objective))
        n_traces = len(programs.cold_traces)
        warm = run_load(warm_svc, requests, [0.0] * len(requests))
        report["warm"] = serving_summary(warm_svc, warm.completions, warm.makespan_s, "warm")
        check_completions(requests, warm.completions, "serving (warm)")
        check(all(c.warm_hit for c in warm.completions), "warm pass: a request missed the cache")
        n_c = kernel.launches - n_a - n_b
        check(n_c == warm_launches * warm_svc.metrics.batches,
              f"warm: {n_c} kernel launches for {warm_svc.metrics.batches} flushes with a hit")
        cold_obj = {c.req_id: c.objective for c in virt.completions}
        for c in warm.completions:
            cold = cold_obj[c.req_id]
            check(c.objective <= cold + 1e-5 * max(1.0, abs(cold)),
                  f"warm: request {c.req_id} objective {c.objective} > cold {cold}")
        # the cold traces of the warm flushes' rows (their real rows lead)
        occupancy = warm_svc.metrics.occupancy.sample
        cold_iters = [iters_to_converge(t[i]) for t, occ in zip(programs.cold_traces[n_traces:], occupancy)
                      for i in range(round(occ * SERVE_MAX_BATCH))]
        stats = warm_svc.warm_cache.stats()
        m = warm_svc.metrics.summary()
        report["warm"].update(hit_rate=stats["warm_cache_hit_rate"], warm_iters_mean=m["warm_iters_mean"],
                              cold_iters_mean=sum(cold_iters) / len(cold_iters),
                              improved=sum(c.objective < cold_obj[c.req_id] for c in warm.completions))
        print(f"serving[warm]: hit rate {stats['warm_cache_hit_rate']:.3f}; outer iterations to "
              f"converge {report['warm']['warm_iters_mean']:.3f} warm vs "
              f"{report['warm']['cold_iters_mean']:.3f} cold on the same rows; "
              f"{report['warm']['improved']} of {len(warm.completions)} objectives improved", flush=True)

        # the small bucket's requests at cut depth (a full-depth flush holds
        # too many events for the profiler): a kernel flush, the same under
        # the profiler, and the plain scoring path
        small = [p for p in requests if (p.N, p.K) == SERVE_SIZES[1]][:SERVE_MAX_BATCH]
        check(bool(small), f"the stream holds no {SERVE_SIZES[1]} request")
        cut = cfg._replace(allocator=cut_configs()["pgd"])
        cut_programs = {}
        n_before = kernel.launches
        twin, twin_s = serve_once(AllocService(cut, cut_programs, device=device), small)
        prof = profile_flush(AllocService(cut, cut_programs, device=device), small)
        check(kernel.launches - n_before == 2 * (cut.allocator.outer_iters + 2),
              "the cut-depth flushes' launches")
        plain_cfg = cut._replace(allocator=cut.allocator._replace(use_kernel_objective=False))
        n_before = kernel.launches
        plain, plain_s = serve_once(AllocService(plain_cfg, device=device), small)
        check(kernel.launches == n_before, "the plain scoring path launched the kernel")
    finally:
        counting.restore()
    launches = only_objective_launched("the serving path")    # ... and ends here

    by_id = {c.req_id: c for c in twin}
    for c in plain:
        k = by_id[c.req_id]
        for leaf in ("f", "P", "X", "rho"):
            check(torch.equal(getattr(c.alloc, leaf), getattr(k.alloc, leaf)),
                  f"plain scoring path: request {c.req_id}'s {leaf} differs from the kernel path's")
        check(abs(c.objective - k.objective) <= ATOL + RTOL * abs(k.objective),
              f"plain scoring path: request {c.req_id} objective {c.objective} vs kernel {k.objective}")
    busy = prof["device_busy_s"] / twin_s
    report.update(first_call_s={str(k): v for k, v in programs.first_call_s.items()},
                  launch_shapes={str(k): v for k, v in shapes.items()}, launches=launches,
                  profile=dict(prof, unprofiled_solve_s=twin_s, busy_share=busy),
                  plain_solve_s=plain_s)
    for key, t in programs.first_call_s.items():
        print(f"serving cache: first call {t:.3f} s for bucket {key[0][:2]}, {key[1]} slots"
              + (f", warm-refine {key[-1]} candidate(s)" if "warm-refine" in key else ""), flush=True)
    print(f"serving: {launches} kernel launches ({cold_launches} per cold flush, {warm_launches} per "
          f"flush with a hit, 0 on the plain path); launch shapes {dict(shapes)}", flush=True)
    print(f"serving, one cold flush of {prof['requests']} {SERVE_SIZES[1]} requests at cut depth "
          f"(1 outer iteration, 100 PGD steps), profiled: device busy {prof['device_busy_s']:.4f} s "
          f"= {100 * busy:.2f}% of the unprofiled flush's {twin_s:.3f} s "
          f"({prof['solve_s_profiled']:.3f} s profiled); the kernel {prof['kernel_ms']:.3f} ms in "
          f"{prof['kernel_launches']} launches; the plain scoring path's flush {plain_s:.3f} s, "
          "the same allocations", flush=True)
    for key, ms, count in prof["top"]:
        print(f"  {ms:9.3f} ms  x{count:<7d} {key[:90]}")

    # the kernel at the serving path's launch shapes, against its plain version
    report["kernel_cases"] = serving_kernel_cases(device, shapes)
    return report, launches


def serving_kernel_cases(device, shapes) -> list:
    """The objective kernel at each launch shape of the serving path that
    phase 2 does not time: graph-replay time, plain version, bound."""
    import torch

    from repro_torch.kernels.fedsem_objective import kernel, ref

    gen = torch.Generator(device=device).manual_seed(4321)
    ab = tuple(torch.tensor(v, device=device) for v in AB)
    timed = {(16, 3, 10), (48, 1, 10), (64, 8192, 8)} | set(SWEEP_SHAPES)
    cases = []
    for B, G, N in sorted(set(shapes) - timed):
        args, mask, kap = grid_inputs(gen, B, G, N, device)
        kw = dict(xi=XI, eta=ETA, check_feasible=False)
        run_k = lambda: kernel.objective_batch(*args, mask, *kap, *AB, **kw)
        run_p = lambda: ref.objective_grid_batch(*args, *kap, accuracy_ab=ab, dev_mask=mask, **kw)
        err = compare(run_k(), run_p(), f"serving objective_batch{(B, G, N)}")
        prep = kernel.prepare(*args, mask, *kap, *AB, **kw)
        case = dict(shape=[B, G, N], launches=shapes[(B, G, N)], max_abs_err=err,
                    ms=graph_ms(lambda: kernel.launch(prep)), plain_ms=graph_ms(run_p),
                    **dict(zip(("bound_ms", "bound_by"), bound(B, G, N, False))))
        cases.append(case)
        print(f"serving objective_batch{(B, G, N)} x{case['launches']}: device kernel "
              f"{case['ms']:.6f} ms, plain {case['plain_ms']:.6f} ms, bound {case['bound_ms']:.7f} ms "
              f"({case['bound_by']}); max abs err {err:.3g}", flush=True)
    torch.cuda.synchronize()
    return cases


def profile_round(job, backend_of, seed: int) -> dict:
    """One round of ``job`` (a one-round `SemComJob`) in two windows of
    `torch.profiler` (device activity only: a CPU-side trace of a solve is
    too large to read back in time): the round's training, measurements and
    bookkeeping, with the allocation answered at once by a recorded
    backend; and the allocation alone, one flush of the service. The
    round is their sum. Solvers and kernels are called once before."""
    import torch

    from repro_torch.fl import AllocationBackend

    class Answered(AllocationBackend):
        def __init__(self, alloc):
            self.alloc = alloc

        def open(self, scenarios, weights):
            pass

        def allocate(self, rnd):
            return self.alloc

    def window(fn):
        with device_profile(cpu=False) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_dev = device_rows(prof)
        busy = sum(e.self_device_time_total for e in on_dev) / 1e6
        kern = sum(e.count for e in on_dev if "fedsem_objective_kernel" in e.key)
        return out, wall, busy, kern

    seen = {}
    backend = backend_of()
    open_, allocate = backend.open, backend.allocate
    backend.open = lambda scenarios, weights: seen.update(args=(scenarios, weights)) or open_(
        scenarios, weights)
    backend.allocate = lambda rnd: seen.setdefault("alloc", allocate(rnd))
    job.run(seed, backend)                                   # first calls
    _, train_wall, train_busy, train_kern = window(lambda: job.run(seed, Answered(seen["alloc"])))
    backend = backend_of()
    backend.open(*seen["args"])
    _, alloc_wall, alloc_busy, alloc_kern = window(lambda: backend.allocate(0))
    check(train_busy > 0 and alloc_busy > 0 and alloc_kern > 0 and train_kern == 0,
          "the profiled round saw no device time, or the kernel where it does not belong")
    round_wall, round_busy = train_wall + alloc_wall, train_busy + alloc_busy
    return dict(round_wall_s=round_wall, round_busy_s=round_busy, alloc_wall_s=alloc_wall,
                alloc_busy_s=alloc_busy, alloc_kernel_launches=alloc_kern, train_wall_s=train_wall,
                train_busy_s=train_busy, busy_share=round_busy / round_wall,
                alloc_busy_share=alloc_busy / alloc_wall, train_busy_share=train_busy / train_wall)


def phase_fedsem(device):
    """Phase 16: `repro_torch.launch.fedsem_e2e`'s four phases at the
    reference's full harness, cut to `FEDSEM_ROUNDS` rounds and the
    allocator to its smoke depth; every
    allocation's launches counted; the sharding pass; one round profiled;
    the kernel at the phase's launch shapes."""
    import collections

    import torch

    from repro_torch.core import Weights, scenario_mesh, solve_batch, stack_params
    from repro_torch.fl import ServiceBackend, alloc_backend, fold_seed, sample_round_scenarios
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.launch import fedsem_e2e as e2e
    from repro_torch.serve import AllocService
    from repro_torch.serve import service as service_mod

    _, serve_cfg, specs, rounds, ae, batch, eval_batch = e2e.harness_config(
        smoke=False, rounds=FEDSEM_ROUNDS)
    cut = e2e.SMOKE_ALLOCATOR
    serve_cfg = serve_cfg._replace(allocator=cut)
    per_solve = cut.outer_iters + 1               # the trace entries and the selection
    report = dict(reduced=FEDSEM_REDUCED, jobs_spec=specs, rounds=rounds, ae=ae._asdict(),
                  batch=batch, eval_batch=eval_batch, policy=serve_cfg.policy._asdict())
    counts, shapes = collections.Counter(), collections.Counter()
    patches = [Counting(counts, "solve", service_mod, "solve_batch"),
               Counting(counts, "solve", alloc_backend, "solve_batch"),
               Counting(counts, "score", service_mod, "batch_objectives"),
               Counting(shapes, None, kernel, "launch", lambda a: (a.B, a.G, a.N))]
    zero_launches()                                   # the closed loop starts here
    try:
        e2e_report = e2e.run_e2e(FEDSEM_SEED, cut, serve_cfg, specs, rounds, ae, batch, eval_batch,
                                 device=device, log=lambda m: print(f"fedsem {m}", flush=True))
    finally:
        for patch in patches:
            patch.restore()
    launches = only_objective_launched("the FedSem closed loop")    # ... and ends here
    expected = per_solve * counts["solve"] + counts["score"]
    print(f"fedsem: {launches} objective-kernel launches = {per_solve} x {counts['solve']} solves "
          f"+ {counts['score']} flush scorings ({expected} expected); launch shapes {dict(shapes)}",
          flush=True)
    check(counts["solve"] > 0 and launches == expected,
          f"fedsem: {launches} kernel launches, {expected} expected from the solves and flushes")
    eq, refit, nonint = (e2e_report[k] for k in ("equivalence", "refit", "noninterference"))
    check(eq["equivalent"], f"fedsem: ServiceBackend != PlannedBackend on X or rho: {eq}")
    check(refit["ok"], f"fedsem: the refit was not applied or is not monotone: {refit}")
    check(all(j["rounds"] == rounds for j in e2e_report["jobs"]), "fedsem: a job did not complete")
    check(nonint["ok"], f"fedsem: a solo re-run differs from its co-tenanted run: {nonint}")
    check(e2e_report["ok"], "fedsem_e2e's gates")
    for j in e2e_report["jobs"]:
        for key in ("loss", "rho", "energy", "objective"):
            check(all(map(math.isfinite, j[key])), f"fedsem: job {j['job']} has a non-finite {key}")
        print(f"fedsem job {j['job']}: loss {fmt(j['loss'])}; rho {fmt(j['rho'])}; energy "
              f"{fmt(j['energy'])} J; objective {fmt(j['objective'])}; proxy accuracy "
              f"{fmt(j['proxy_accuracy'])}; refit at round {j['refit_round']}", flush=True)
    svc = e2e_report["service"]
    print(f"fedsem service: {svc['completed']} requests in {svc['batches']} flushes, latency p95 "
          f"{svc['latency_p95_s']:.3f} s, p50 {svc['latency_p50_s']:.3f} s, occupancy "
          f"{svc['batch_occupancy_mean']:.3f}; wall per e2e phase "
          + ", ".join(f"{k} {v:.2f} s" for k, v in e2e_report["wall_s"].items()), flush=True)
    report.update(e2e=e2e_report, launches=launches, solves=counts["solve"],
                  flushes=counts["score"], launch_shapes={str(k): v for k, v in shapes.items()})

    # the sharding pass: phase 1's planned batch on the card's scenario mesh
    t0 = time.perf_counter()
    probe = e2e.make_job(specs[0], rounds, ae, batch, eval_batch, device=device)
    scen = sample_round_scenarios(fold_seed(FEDSEM_SEED, 100), probe.cfg.fl, e2e.upload_bits(probe),
                                  device)
    pb, w, mesh = stack_params(scen), Weights.ones(device), scenario_mesh()
    n0 = kernel.launches
    single = solve_batch(pb, w, cut)
    n1 = kernel.launches
    sharded = solve_batch(pb, w, cut, mesh=mesh)
    n2 = kernel.launches
    check(torch.equal(sharded.alloc.X, single.alloc.X), "fedsem: the sharded solve's X differs")
    check(n1 - n0 == per_solve and n2 - n1 == per_solve * len(mesh),
          f"fedsem: launches unsharded {n1 - n0}, sharded {n2 - n1} on {len(mesh)} device(s)")
    svc_sharded = AllocService(serve_cfg._replace(shard_batch=True), device=device)
    slots = torch.cuda.device_count() * serve_cfg.policy.max_batch
    check(svc_sharded.mesh == mesh and svc_sharded._full_slots == slots,
          f"fedsem: a sharded service of {svc_sharded._full_slots} slots, {slots} expected")
    by_sharded, _ = serve_once(svc_sharded, scen)
    by_single, _ = serve_once(AllocService(serve_cfg, device=device), scen)
    x_of = {c.req_id: c.alloc.X for c in by_single}
    check(len(by_sharded) == len(scen) and all(torch.equal(c.alloc.X, x_of[c.req_id]) for c in by_sharded),
          "fedsem: the sharded service's X differs from the unsharded service's")
    report["sharding"] = dict(mesh=[str(d) for d in mesh], slots=slots, launches_single=n1 - n0,
                              launches_sharded=n2 - n1, wall_s=time.perf_counter() - t0)
    print(f"fedsem sharding: mesh {report['sharding']['mesh']}; the planned batch's X sharded == "
          f"unsharded ({n2 - n1} and {n1 - n0} launches); a shard_batch service of {slots} slots "
          f"answers the {len(scen)} rounds as the unsharded one", flush=True)

    # one round's device busy share, training against allocation
    job = e2e.make_job(specs[2], 1, ae, batch, eval_batch, device=device)
    programs: dict = {}
    prof = profile_round(job, lambda: ServiceBackend(AllocService(serve_cfg, programs, device=device)),
                         fold_seed(FEDSEM_SEED, 400))
    report["profile"] = prof
    print(f"fedsem round profile ({job.cfg.name}, N {job.cfg.fl.n_clients}, K "
          f"{job.cfg.fl.n_subcarriers}, device activity profiled): round {prof['round_wall_s']:.3f} s, "
          f"device busy {prof['round_busy_s']:.4f} s ({100 * prof['busy_share']:.2f}%); allocation "
          f"(one flush) {prof['alloc_wall_s']:.3f} s, busy {prof['alloc_busy_s']:.4f} s "
          f"({100 * prof['alloc_busy_share']:.2f}%, {prof['alloc_kernel_launches']} kernel launches); "
          f"training, measurements and the rest {prof['train_wall_s']:.3f} s, busy "
          f"{prof['train_busy_s']:.4f} s ({100 * prof['train_busy_share']:.2f}%)", flush=True)

    # the kernel at the phase's launch shapes, against its plain version
    report["kernel_cases"] = serving_kernel_cases(device, shapes)
    return report, launches


def params_of(tree) -> int:
    """The parameters of an LM tree, counted from its tensors."""
    from repro_torch.core.types import tree_leaves

    return sum(x.numel() for x in tree_leaves(tree))


def train_batch(gen, vocab: int, B: int, S: int) -> dict:
    """One (B, S) batch of tokens drawn uniformly from ``gen`` (labels: the
    tokens shifted by one)."""
    import torch

    toks = torch.randint(0, vocab, (B, S + 1), generator=gen, device=gen.device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def profile_step(step_fn, state, batch) -> dict:
    """One train step under `torch.profiler` (device activity): its wall
    time and the device's busy time and share."""
    import torch

    with device_profile(cpu=False) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = device_rows(prof)
    busy = sum(e.self_device_time_total for e in on_dev) / 1e6
    check(busy > 0, "the profiled train step saw no device time")
    products = sum(e.self_device_time_total for e in on_dev
                   if any(m in e.key.lower() for m in PRODUCT_MARKS)) / 1e6
    top = sorted(on_dev, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    return state, float(metrics["loss"]), dict(
        wall_s=wall, busy_s=busy, busy_share=busy / wall, products_s=products,
        launches=sum(e.count for e in on_dev),
        top=[(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top])


def dry_run_process():
    """`launch.dryrun.lower_pair` of phase 17's model and batch on a (1, 1)
    fake mesh, in a process of its own (a process has one default group):
    its per-device cost and predicted memory, as JSON on its stdout."""
    code = ("import json, sys; sys.path.insert(0, 'src')\n"
            "from repro_torch.configs.registry import get_config\n"
            "from repro_torch.launch import dryrun as D\n"
            f"cost, mem, _ = D.lower_pair(get_config({TRAIN_ARCH!r}), 'train_4k', D.fake_mesh((1, 1)), "
            f"batch={TRAIN_B}, seq={TRAIN_S})\n"
            "print(json.dumps({'cost': cost, 'memory': mem}))\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())     # a failed phase stops it too
    return proc


def train_on_mesh(cfg, state, batch, mesh, dry):
    """Phase 17's mesh step: `loss_fn` of the current state under the
    (1, 1) mesh (the vocab-sharded cross-entropy) against mesh=None's, and
    one train step on the state placed on the mesh (views: the step updates
    the state in place), its grad_norm against mesh=None's on the same
    state, counted by `launch.op_cost.OpCost`; the dry run's (``dry``, the
    `dry_run_process`) per-device dot FLOPs against that count, its
    predicted peak beside the measured one. Returns (the state, report)."""
    import torch

    from repro_torch.launch import op_cost, train as T
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import OptState, global_norm, value_and_grad
    from repro_torch.parallel import sharding as SH

    t_path = time.perf_counter()
    specs = SH.param_specs(state.params)
    placed = [SH.shard_tree(mesh, specs, t) for t in (state.params, state.opt.mu, state.opt.nu)]
    with torch.no_grad():
        plain_loss = float(M.loss_fn(state.params, cfg, batch))
        mesh_loss = float(M.loss_fn(placed[0], cfg, batch, mesh=mesh))
    step = T.build_train_step(cfg, mesh=mesh, lr=TRAIN_LR, clip=TRAIN_CLIP)
    # the gradients' comparison without the atomics of the embedding's
    # backward (a bf16 scatter-add sums in another order each run), as
    # phase 17(b)'s; two plain runs give the spread that remains
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain_norms = []
        for _ in range(2):
            _, grads = value_and_grad(lambda p: M.loss_fn(p, cfg, batch), state.params)
            plain_norms.append(float(global_norm(grads)))
            del grads
        plain_norm = plain_norms[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()                               # the mesh step's path starts here
        t0 = time.perf_counter()
        with op_cost.OpCost() as cost:
            stepped, metrics = step(T.TrainState(placed[0], OptState(state.opt.step, placed[1], placed[2])),
                                    batch)
            step_loss, mesh_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch.use_deterministic_algorithms(False)
    check_no_lm_kernel("the mesh train step")         # ... and ends here
    out, err = dry.communicate(timeout=600)
    check(dry.returncode == 0, f"the dry run failed: {err[-2000:]}")
    predicted = json.loads(out.strip().splitlines()[-1])
    rel_loss = abs(mesh_loss - plain_loss) / abs(plain_loss)
    rel_norm = abs(mesh_norm - plain_norm) / abs(plain_norm)
    rel_flops = abs(predicted["cost"]["flops"] - cost.flops) / cost.flops
    peak_pred = predicted["memory"]["total_hbm_bytes"]
    check(rel_loss <= 1e-5, f"train on the mesh: loss {mesh_loss} vs mesh=None's {plain_loss} ({rel_loss:.3g})")
    check(abs(step_loss - mesh_loss) <= 1e-5 * abs(mesh_loss),
          f"train on the mesh: the step's loss {step_loss} is not its loss_fn's {mesh_loss}")
    check(rel_norm <= 1e-4, f"train on the mesh: grad_norm {mesh_norm} vs mesh=None's {plain_norm} "
          f"({rel_norm:.3g})")
    check(math.isfinite(mesh_norm), "train on the mesh: grad_norm not finite")
    check(rel_flops <= 0.01, f"the dry run's per-device dot FLOPs {predicted['cost']['flops']:.6g} vs the "
          f"step's {cost.flops:.6g} ({rel_flops:.3g} relative)")
    report = dict(plain_loss=plain_loss, mesh_loss=mesh_loss, loss_rel=rel_loss, plain_grad_norms=plain_norms,
                  mesh_grad_norm=mesh_norm, grad_norm_rel=rel_norm, step_s=step_s, step_cost=cost.as_dict(),
                  dry_run=predicted, dry_flops_rel=rel_flops, peak_bytes=peak, predicted_peak_bytes=peak_pred,
                  wall_s=time.perf_counter() - t_path)
    print(f"train {TRAIN_ARCH} on the (1, 1) mesh: loss {mesh_loss:.7g} (vocab-sharded CE) vs mesh=None "
          f"{plain_loss:.7g} (rel {rel_loss:.3g}); one step: grad_norm {mesh_norm:.7g} vs mesh=None "
          f"{plain_norm:.7g} (rel {rel_norm:.3g}; two mesh=None runs {fmt(plain_norms)}), "
          f"{1e3 * step_s:.1f} ms under OpCost; dot FLOPs: step "
          f"{cost.flops:.6g}, dry run {predicted['cost']['flops']:.6g} (rel {rel_flops:.3g}); peak "
          f"memory: measured {peak / 2**30:.3f} GiB, dry run {peak_pred / 2**30:.3f} GiB (ratio "
          f"{peak_pred / peak:.3f}); the mesh part {report['wall_s']:.2f} s", flush=True)
    return T.TrainState(state.params, OptState(stepped.opt.step, state.opt.mu, state.opt.nu)), report


def phase_train(device, mesh):
    """Phase 17: (a) Qwen2.5-3B at full width trains `TRAIN_STEPS` steps of
    `launch.train.build_train_step` on one batch, its step-0 loss held
    against the flash kernel's forward, then one more step on the (1, 1)
    ``mesh`` (`train_on_mesh`); (b) the smoke variants of the other
    trained families, remat on against off."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.models.config import smoke_variant
    from repro_torch.models.layers import cross_entropy
    from repro_torch.optim.optimizers import value_and_grad

    # (a) the full-width model; the dry run of its step traces beside it
    dry = dry_run_process()
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = T.init_state(cfg, torch.Generator(device).manual_seed(0), TRAIN_LR)
    n_params = params_of(state.params)
    batch = train_batch(torch.Generator(device).manual_seed(1), cfg.vocab, TRAIN_B, TRAIN_S)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the loss through the flash kernel (forward only, no grad): the kernel
    # and the training path must compute one function at full width
    n0 = flash_kernel.launches
    with torch.no_grad():
        logits, _ = M.forward(state.params, cfg, batch, use_kernel=True)
        kernel_loss = float(cross_entropy(logits, batch["labels"]))
        del logits
    check(flash_kernel.launches - n0 == cfg.n_layers,
          f"train: the kernel forward launched flash {flash_kernel.launches - n0} times, want "
          f"{cfg.n_layers}")

    step_fn = T.build_train_step(cfg, lr=TRAIN_LR, clip=TRAIN_CLIP)
    zero_launches()                                   # the training path starts here
    losses, norms, walls = [], [], []
    for i in range(TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    state, last_loss, prof = profile_step(step_fn, state, batch)
    losses.append(last_loss)
    with torch.no_grad():
        after = float(M.loss_fn(state.params, cfg, batch))
    peak = torch.cuda.max_memory_allocated(device)
    check_no_lm_kernel("the full-width train steps")         # ... and ends here
    check(all(map(math.isfinite, losses + norms + [after])),
          f"train: a non-finite loss or grad norm: {losses}, {norms}, {after}")
    check(after < losses[0], f"train: the loss after {TRAIN_STEPS} steps ({after}) is not below "
          f"step 0's ({losses[0]})")
    rel = abs(kernel_loss - losses[0]) / abs(losses[0])
    check(rel <= TRAIN_KERNEL_RTOL, f"train: step 0's loss {losses[0]} and the flash kernel's "
          f"{kernel_loss} differ by {rel:.3g} relative (> {TRAIN_KERNEL_RTOL})")
    try:
        value_and_grad(lambda p: M.loss_fn(p, cfg, batch, use_kernel=True), state.params)
    except RuntimeError as err:
        check("use_kernel=False" in str(err), f"train: the refusal does not name the plain route: {err}")
    else:
        raise SmokeFailure("train: loss_fn(use_kernel=True) with trainable leaves did not raise")
    check_no_lm_kernel("the refused kernel loss")
    step_s = sorted(walls[1:])[len(walls[1:]) // 2]         # the median warm step
    tokens = TRAIN_B * TRAIN_S
    report = dict(arch=TRAIN_ARCH, reduced=TRAIN_REDUCED, params=n_params, batch=TRAIN_B,
                  seq=TRAIN_S, lr=TRAIN_LR, clip=TRAIN_CLIP, init_s=init_s, losses=losses,
                  grad_norms=norms, loss_after=after, kernel_loss=kernel_loss,
                  kernel_loss_rel=rel, step_walls_s=walls, step_s=step_s,
                  tokens_per_s=tokens / step_s,
                  mfu_bf16_dense=6.0 * n_params * tokens / step_s / BF16_FLOPS_PER_S,
                  peak_memory_bytes=peak, profiled_step=prof)
    print(f"train {TRAIN_ARCH}: {n_params / 1e9:.4f} B parameters (bf16), B {TRAIN_B}, S "
          f"{TRAIN_S}; losses {fmt(losses)} -> {after:.5g} after {TRAIN_STEPS} steps; grad norms "
          f"{fmt(norms)}; flash-kernel loss {kernel_loss:.6g} vs step 0's {losses[0]:.6g} (rel "
          f"{rel:.3g}); step walls {fmt(walls)} s, median warm step {1e3 * step_s:.1f} ms, "
          f"{tokens / step_s:.1f} tokens/s, mfu_bf16_dense {100 * report['mfu_bf16_dense']:.2f}% "
          f"(6 N tokens / step / 989 TFLOP/s); peak memory {peak / 2**30:.2f} GiB; profiled step "
          f"{1e3 * prof['wall_s']:.1f} ms, device busy {1e3 * prof['busy_s']:.1f} ms "
          f"({100 * prof['busy_share']:.2f}%; matrix products {1e3 * prof['products_s']:.1f} ms; "
          f"{prof['launches']} launches; top {prof['top']})", flush=True)
    state, report["mesh"] = train_on_mesh(cfg, state, batch, mesh, dry)
    del state, batch, step_fn
    torch.cuda.empty_cache()

    # (b) the smoke variants: bigram batches, remat on against off
    report["smoke"] = {}
    for arch, cut in TRAIN_SMOKE:
        scfg = smoke_variant(get_config(arch)).scaled(**cut)
        gen = torch.Generator(device).manual_seed(2)
        sstate = T.init_state(scfg, gen, TRAIN_LR)
        stream = token_stream(gen, scfg.vocab, TRAIN_B, TRAIN_S)
        batches = [next(stream) for _ in range(3)]
        batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in batches]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            grads = [value_and_grad(lambda p: M.loss_fn(p, scfg, batches[0], remat=r), sstate.params)[1]
                     for r in (True, False)]
        finally:
            torch.use_deterministic_algorithms(False)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])))
        del grads
        aux = None
        if scfg.n_experts:                                # the MoE term in the loss
            with torch.no_grad():
                logits, aux = M.forward(sstate.params, scfg, batches[0], use_kernel=False)
                ce = float(cross_entropy(logits, batches[0]["labels"]))
                total = float(M.loss_fn(sstate.params, scfg, batches[0]))
            aux = float(aux)
            want_total = ce + 0.01 * aux / scfg.n_layers
            check(aux > 0 and abs(total - want_total) <= 1e-6 * abs(want_total),
                  f"train {arch} smoke: loss {total} is not the cross-entropy {ce} + 0.01 x aux "
                  f"{aux} / {scfg.n_layers}")
        sstep = T.build_train_step(scfg, lr=TRAIN_LR, clip=TRAIN_CLIP)
        slosses = []
        t1 = time.perf_counter()
        for b in batches:
            sstate, m = sstep(sstate, b)
            slosses.append(float(m["loss"]))
        wall = time.perf_counter() - t1
        check_no_lm_kernel(f"the {arch} smoke train steps")
        check(same, f"train {arch} smoke: remat on and off give different gradients")
        check(all(map(math.isfinite, slosses)) and slosses[-1] < slosses[0],
              f"train {arch} smoke: losses {slosses} not finite and decreasing")
        report["smoke"][arch] = dict(cut=cut, losses=slosses, remat_equal=same, wall_s=wall, aux=aux)
        print(f"train {arch} smoke: losses {fmt(slosses)} over 3 steps ({wall:.2f} s); remat on == "
              f"off: {same}" + ("" if aux is None else f"; aux term {aux:.6g} in the loss"), flush=True)
    return report


class KeptShares:
    """Wrap `fl.federated.magnitude_quantile` to record, for each leaf of
    every upload, its size, how many entries lie above and at its
    threshold, and the quantile q asked for; and `topk_sparsify` to time the
    sparsification (ending in a synchronize)."""

    def __init__(self, federated):
        import torch

        self.federated, self.rows, self.seconds = federated, [], 0.0
        self.quantile, self.topk = federated.magnitude_quantile, federated.topk_sparsify

        def quantile(a, q):
            t = self.quantile(a, q)
            self.rows.append((a.numel(), int(torch.sum(a > t)), int(torch.sum(a >= t)), float(q)))
            return t

        def topk(update, frac):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.topk(update, frac)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        federated.magnitude_quantile, federated.topk_sparsify = quantile, topk

    def restore(self):
        self.federated.magnitude_quantile, self.federated.topk_sparsify = self.quantile, self.topk


def phase_federated_lm(device):
    """Phase 18: (a) `launch.federated_lm`'s own computation (the smoke
    Qwen2.5-3B, 4 clients, 8 rounds, `PlannedBackend` at the smoke
    allocator depth), every solve's objective-kernel launches counted; (b)
    one round of Qwen2.5-3B at full width (2 clients, one local SGD step,
    compression on), every leaf of every upload sparsified at rho."""
    import collections
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import tree_leaves
    from repro_torch.fl import PlannedBackend, alloc_backend, federated, run_fl
    from repro_torch.launch import federated_lm
    from repro_torch.launch import fedsem_e2e as e2e
    from repro_torch.models import model as M
    from repro_torch.models.config import smoke_variant

    def recorded(backend, rho=None):
        """``backend`` with its allocations and its open + allocate wall kept;
        with ``rho``, each allocation's rho replaced by it."""
        seen = dict(allocs=[], alloc_s=0.0, solved_rho=[])
        open_, allocate = backend.open, backend.allocate

        def timed(fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            seen["alloc_s"] += time.perf_counter() - t0
            return out

        def answer(rnd):
            a = timed(allocate, rnd)
            seen["solved_rho"].append(float(a.rho))
            if rho is not None:
                a = dataclasses.replace(a, rho=torch.full_like(a.rho, rho))
            seen["allocs"].append(a)
            return a
        backend.open = lambda scenarios, weights: timed(open_, scenarios, weights)
        backend.allocate = answer
        return backend, seen

    # (a) the example's computation
    cfg = smoke_variant(get_config(FED_ARCH))
    fl_cfg = federated_lm.fl_config(FED_ROUNDS, FED_CLIENTS)
    cut = e2e.SMOKE_ALLOCATOR                         # FED_REDUCED
    per_solve = cut.outer_iters + 1                   # the trace entries and the selection
    backend, seen = recorded(PlannedBackend(cut))
    counts = collections.Counter()
    patch = Counting(counts, "solve", alloc_backend, "solve_batch")
    zero_launches()                                   # the federated LM path starts here
    t0 = time.perf_counter()
    try:
        _, hist = federated_lm.run(cfg, fl_cfg, device=device, backend=backend)
    finally:
        patch.restore()
    wall = time.perf_counter() - t0
    launches = only_objective_launched("the federated LM run")     # ... and ends here
    losses = [h.loss for h in hist]
    check(counts["solve"] > 0 and launches == per_solve * counts["solve"],
          f"federated LM: {launches} kernel launches, {per_solve} x {counts['solve']} solves expected")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"federated LM: the loss did not fall: {losses}")
    for rnd, a in enumerate(seen["allocs"]):
        check(bool(((a.X == 0) | (a.X == 1)).all()) and bool((a.X.sum(dim=-2) == 1).all()),
              f"federated LM round {rnd}: X is not binary with every subcarrier owned once")
    check(len(seen["allocs"]) == FED_ROUNDS, f"federated LM: {len(seen['allocs'])} allocations")
    report = dict(arch=FED_ARCH, reduced=FED_REDUCED, rounds=FED_ROUNDS, clients=FED_CLIENTS,
                  losses=losses,
                  rho=[h.rho for h in hist], energy=[h.energy for h in hist],
                  t_fl=[h.t_fl for h in hist], solves=counts["solve"], launches=launches,
                  wall_s=wall, alloc_s=seen["alloc_s"])
    print(f"federated LM ({FED_ARCH} smoke, {FED_CLIENTS} clients, {FED_ROUNDS} rounds): losses "
          f"{fmt(losses)}; rho {fmt(report['rho'])}; energy {fmt(report['energy'])} J; "
          f"{launches} objective-kernel launches = {per_solve} x {counts['solve']} solves; wall "
          f"{wall:.2f} s, allocation {seen['alloc_s']:.2f} s", flush=True)

    # (b) one round at full width, the solved allocation's rho held at
    # FED_FULL_RHO (the solve answers rho 1 here, where every leaf's
    # threshold is its minimum and every entry stays)
    full = get_config(FED_ARCH)
    torch.cuda.empty_cache()
    params = M.init_params(full, torch.Generator(device).manual_seed(0)).tree
    torch.cuda.synchronize()
    full_cfg = fl_cfg._replace(rounds=1, n_clients=FED_FULL_CLIENTS,
                               n_subcarriers=4 * FED_FULL_CLIENTS, local_steps=1)
    backend, seen = recorded(PlannedBackend(cut), rho=FED_FULL_RHO)
    kept = KeptShares(federated)
    zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        out, hist = run_fl(
            0, params, lambda p, b, gen: M.loss_fn(p, full, b),
            lambda gen, i: train_batch(gen, full.vocab, federated_lm.BATCH, FED_FULL_SEQ),
            full_cfg, backend=backend)
        finite = all(bool(torch.all(torch.isfinite(x))) for x in tree_leaves(out))
        torch.cuda.synchronize()
    finally:
        kept.restore()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    full_launches = only_objective_launched("the full-width FL round")
    check(full_launches == cut.outer_iters + 1, f"full-width FL round: {full_launches} kernel "
          f"launches, {cut.outer_iters + 1} expected (one solve)")
    check(finite, "full-width FL round: the aggregated parameters are not finite")
    n_leaves = len(tree_leaves(params))
    check(len(kept.rows) == FED_FULL_CLIENTS * n_leaves,
          f"full-width FL round: {len(kept.rows)} leaves sparsified, want {FED_FULL_CLIENTS} x {n_leaves}")
    rho = hist[0].rho
    check(abs(rho - FED_FULL_RHO) < 1e-7 and all(q == 1.0 - rho for *_, q in kept.rows),
          f"full-width FL round: rho {rho}, not {FED_FULL_RHO}")
    bad = [(n, gt, ge) for n, gt, ge, q in kept.rows
           if not (gt <= (1.0 - q) * n + 1 and ge >= (1.0 - q) * n - 1)]
    check(not bad, f"full-width FL round: leaves not sparsified at rho {rho}: {bad[:4]}")
    # leaves whose threshold sits on a tie (most bf16 updates round to 0):
    # every entry at the threshold stays, as in the reference
    tied = sum(ge - gt > 1 for _, gt, ge, _ in kept.rows)
    biggest = max(kept.rows)
    # untied float32 leaves of the embedding's and the largest stacked
    # leaf's sizes, sparsified at FED_PROBE_RHO, keep rho n entries each
    del out
    probes = []
    for seed, shape in enumerate({tuple(x.shape) for x in (params["embed"],
                                                           max(tree_leaves(params), key=torch.numel))}):
        probe = KeptShares(federated)
        draw = torch.randn(shape, generator=torch.Generator(device).manual_seed(3 + seed),
                           device=device)
        try:
            sparse = federated.topk_sparsify({"w": draw}, FED_PROBE_RHO)["w"]
        finally:
            probe.restore()
        (n, gt, ge, q), = probe.rows
        kept_now = int(torch.count_nonzero(sparse))
        check(gt <= FED_PROBE_RHO * n + 1 and ge >= FED_PROBE_RHO * n - 1 and kept_now == ge,
              f"full-width FL round: a float32 leaf of {n} entries at rho {FED_PROBE_RHO}: {gt} "
              f"above and {ge} at or above the threshold, {kept_now} kept")
        probes.append(dict(shape=list(shape), entries=n, above=gt, at_or_above=ge,
                           kept_nonzero=kept_now, seconds=probe.seconds))
        del draw, sparse
    report["full"] = dict(arch=FED_ARCH, params=params_of(params),
                          clients=FED_FULL_CLIENTS,
                          seq=FED_FULL_SEQ, batch=federated_lm.BATCH, loss=hist[0].loss, rho=rho,
                          solved_rho=seen["solved_rho"], leaves=n_leaves, tied_leaves=tied,
                          largest_leaf=biggest[0], wall_s=wall,
                          alloc_s=seen["alloc_s"], rest_s=wall - seen["alloc_s"],
                          peak_memory_bytes=peak, launches=full_launches,
                          sparsify_s=kept.seconds, probe_rho=FED_PROBE_RHO, probes=probes,
                          kept_share_range=[min(ge / n for n, _, ge, _ in kept.rows),
                                            max(gt / n for n, gt, _, _ in kept.rows)])
    print(f"federated LM full width ({FED_ARCH}, {report['full']['params'] / 1e9:.4f} B, "
          f"{FED_FULL_CLIENTS} clients, 1 local step, batch {federated_lm.BATCH} x {FED_FULL_SEQ}): "
          f"loss {hist[0].loss:.5g}, rho {rho:.6g} (solved {fmt(seen['solved_rho'])}); "
          f"{len(kept.rows)} uploads' leaves sparsified at rho, {tied} with their threshold on a "
          f"tie (largest {biggest[0]} entries: {biggest[1]} above, {biggest[2]} at or above the "
          f"threshold); round {wall:.2f} s = allocation {seen['alloc_s']:.2f} s + the rest "
          f"{wall - seen['alloc_s']:.2f} s (the sparsification {kept.seconds:.2f} s of it); "
          + "; ".join(f"a float32 leaf of {pr['entries']} entries at rho {FED_PROBE_RHO}: "
                      f"{pr['kept_nonzero']} kept, {pr['above']} above and {pr['at_or_above']} at "
                      f"or above the threshold ({pr['seconds']:.2f} s)" for pr in probes)
          + f"; peak memory {peak / 2**30:.2f} GiB", flush=True)
    return report, launches + full_launches


def check_paper_allocation(method: str, params, w, alloc, reports, what: str) -> None:
    """One allocation a paper driver made (`paper.common.watch`): finite
    leaves; X binary with each subcarrier owned once (comm_only: PGD's
    relaxed X, each subcarrier owned at most once); Alg. A2 also gives every
    device a subcarrier and is feasible, and so is the oracle; each row's
    objective is `report` of its own allocation (rtol 1e-6; the oracle's is
    the kernel's value, phase 14's rtol 1e-5)."""
    import torch

    from repro_torch.core import tree_index
    from repro_torch.core.system import feasible, report

    if method == "proposed":
        check_allocation(params, alloc, what)
        alloc = alloc.alloc
    else:
        for name in ("f", "P", "X", "rho"):
            check(bool(torch.isfinite(getattr(alloc, name)).all()), f"{what}: non-finite {name}")
        if method == "comm_only":
            check(bool(((alloc.X >= 0) & (alloc.X <= 1)).all()
                       and (alloc.X.sum(dim=-2) <= 1 + 1e-5).all()),
                  f"{what}: relaxed X out of [0, 1] or a subcarrier owned more than once")
        else:
            check_binary_x(params, alloc.X, what)
        if method == "exhaustive":
            check(bool(feasible(params, alloc).all()), f"{what}: infeasible oracle allocation")
    rtol = 1e-5 if method == "exhaustive" else 1e-6
    for i, row in enumerate(reports):
        want = float(report(tree_index(params, i), tree_index(w, i), tree_index(alloc, i))["objective"])
        check(abs(row["objective"] - want) <= rtol * abs(want) + 1e-6,
              f"{what}: row {i} objective {row['objective']} != report() of its allocation {want}")


def phase_paper(device):
    """Phase 21: the paper's seven drivers (`repro_torch.paper`, quick grids)
    and the three examples at Table-I width, the allocator cut
    (`PAPER_REDUCED`); every allocation checked as it is made, the
    objective kernel's launches counted per driver; fig4's sweep again with
    the plain scoring, for identical X, P and rho."""
    import torch

    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.launch import fedsem_autoencoder, quickstart, serve_scenarios
    from repro_torch.paper import common, fig4_pmax
    from repro_torch.paper.run import DRIVERS

    cut = cut_configs()["sca"]
    out_dir = ROOT / "build" / "paper_smoke"    # the drivers' CSVs, beside the kernels
    seen = []                 # (driver, method, allocation) of every allocation
    current = [""]            # the driver running

    def watcher(method, params, w, alloc, reports):
        check_paper_allocation(method, params, w, alloc, reports, f"{current[0]}[{method}]")
        seen.append((current[0], method, alloc))

    out = {"reduced": PAPER_REDUCED, "drivers": {}, "examples": {}}
    zero_launches()                              # the paper path starts here
    with common.watch(watcher):
        for name, mod in DRIVERS.items():
            current[0] = name
            allocator = cut._replace(outer_iters=2) if name == "alg_analysis" else cut
            before = kernel.launches
            t0 = time.perf_counter()
            rows, claims = mod.run(quick=True, device=device, allocator=allocator, out_dir=out_dir)
            wall = time.perf_counter() - t0
            n = kernel.launches - before
            check(n >= 1, f"{name}: the objective kernel never launched")
            solves = sum(1 for d, m, _ in seen if d == name and m == "proposed")
            out["drivers"][name] = dict(wall_s=wall, launches=n, solves=solves, rows=len(rows),
                                        claims=claims)
            print(f"paper[{name}]: {wall:.2f} s, {solves} solves, {n} objective-kernel launches, "
                  f"{len(rows)} rows; claims (recorded, not gated: cut allocator depth on the "
                  f"port's draws): " + ", ".join(f"{k}={v}" for k, v in claims.items()), flush=True)

    # the three examples
    t0 = time.perf_counter()
    before = kernel.launches
    params, res, rows = quickstart.run(device, cut)
    check_allocation(params, res, "quickstart")
    check(all(math.isfinite(float(r["objective"])) for r in rows.values()),
          "quickstart: a non-finite objective")
    out["examples"]["quickstart"] = dict(
        wall_s=time.perf_counter() - t0, launches=kernel.launches - before,
        objectives={k: float(r["objective"]) for k, r in rows.items()})

    t0 = time.perf_counter()
    before = kernel.launches
    requests, result = serve_scenarios.run(device, cut._replace(inner="pgd"))
    check_completions(requests, result.completions, "serve_scenarios")
    out["examples"]["serve_scenarios"] = dict(
        wall_s=time.perf_counter() - t0, launches=kernel.launches - before,
        flushes=result.summary["batches"], latency_p50_s=result.summary["latency_p50_s"])

    t0 = time.perf_counter()
    before = kernel.launches
    ae_rows, fit = fedsem_autoencoder.run(PAPER_AE_ROUNDS, PAPER_AE_RHOS, device, out_dir,
                                          cut._replace(inner="pgd"))
    check(all(math.isfinite(r["psnr_db"]) and 0.0 <= r["proxy_accuracy"] <= 1.0 for r in ae_rows)
          and 0.05 <= float(fit.b) <= 0.95, "fedsem_autoencoder: a non-finite row or a bad fit")
    check((out_dir / "ae_accuracy.csv").is_file() and (out_dir / "ae_accuracy_fit.csv").is_file(),
          "fedsem_autoencoder: its CSVs were not written")
    out["examples"]["fedsem_autoencoder"] = dict(
        wall_s=time.perf_counter() - t0, launches=kernel.launches - before,
        fit=[float(fit.a), float(fit.b)], rows=ae_rows)
    for name, ex in out["examples"].items():
        check(ex["launches"] >= 1, f"{name}: the objective kernel never launched")
        print(f"paper[{name}]: {ex['wall_s']:.2f} s, {ex['launches']} objective-kernel launches",
              flush=True)
    launches = only_objective_launched("the paper path")    # ... and ends here

    # fig4's sweep with the plain scoring: identical X, P and rho
    w = common.weights(device=device)
    sweep = common.sample_sweep(0, [{"p_max_dbm": p} for p in fig4_pmax.PMAX_DBM[1::2]],
                                device=device)
    main = [a.alloc for d, m, a in seen if d == "fig4_pmax" and m == "proposed"]
    check(len(main) == 2, f"fig4_pmax: {len(main)} Alg. A2 solves, not 2")
    before = kernel.launches
    for inner, on in zip(("sca", "pgd"), main):
        off, _ = common.solve_proposed(sweep, w, inner, device=device,
                                       allocator=cut._replace(use_kernel_objective=False))
        for leaf in ("X", "P", "rho"):
            check(torch.equal(getattr(off.alloc, leaf), getattr(on, leaf)),
                  f"fig4_pmax[{inner}]: use_kernel_objective=False changes {leaf}")
    check(kernel.launches == before, "the plain scoring path launched the kernel")
    print("paper[fig4_pmax] use_kernel_objective=False: identical X, P, rho (sca, pgd)", flush=True)
    print(f"paper reduced: {PAPER_REDUCED}", flush=True)
    out["launches"] = launches
    return out, launches


def fmt(xs) -> str:
    return "[" + ", ".join(f"{x:.5g}" for x in xs) + "]"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=pathlib.Path, help="also write the full report as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one short solve per config (device busy share)")
    args = ap.parse_args()
    t_script = time.perf_counter()
    # torch.compile's caches (phase 4's flex_attention) stay inside the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "torch_compile" / sub))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return EXIT_NO_CARD
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the port (src/repro_torch) is not beside this script", file=sys.stderr)
        return EXIT_NO_PORT
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.fedsem_objective import kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.p4_adam import kernel as p4_kernel
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_kernel

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_adam_calls()

    # phase 1: build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    all_kernels = (kernel, flash_kernel, wkv_kernel, scan_kernel, p4_kernel)
    with concurrent.futures.ThreadPoolExecutor(len(all_kernels)) as pool:
        builds = [pool.submit(k.build) for k in all_kernels]
        built = [b.result() for b in builds]
    for k in all_kernels:
        k.load()
    build_s = time.perf_counter() - t0
    phase_s = {}

    def timed(label, fn, *fn_args, **kwargs):
        """Run phase(s) ``label`` and print their wall time."""
        t = time.perf_counter()
        out = fn(*fn_args, **kwargs)
        phase_s[label] = time.perf_counter() - t
        print(f"phase {label}: {phase_s[label]:.2f} s", flush=True)
        return out

    for path, log in built:
        print(f"build: {path.name} (all builds together: {build_s:.2f} s)", flush=True)
        for line in log.strip().splitlines():
            print(f"  ptxas: {line.strip()}")
    # the WKV6, scan, flash and Adam-loop kernels: registers of every instantiation, no spills
    ptxas = {}
    for k in (wkv_kernel, scan_kernel, flash_kernel, p4_kernel):
        name = k.__name__.split(".")[-2]
        rep = ptxas_report(built[all_kernels.index(k)][1])
        if not rep:
            print(f"ptxas {name}: library built earlier, no report", flush=True)
            continue
        regs = sorted(r["registers"] for r in rep.values())
        spills = {f: r["spill_bytes"] for f, r in rep.items() if r["spill_bytes"]}
        main_fn = next(f for f in rep if MAIN_INSTANTIATION[name] in f)
        ptxas[name] = dict(main=rep[main_fn], registers=[regs[0], regs[-1]],
                           instantiations=len(rep), spilling=spills)
        print(f"ptxas {name}: {len(rep)} instantiations, {regs[0]}-{regs[-1]} registers, main "
              f"path's {rep[main_fn]['registers']} registers, {rep[main_fn]['stack_bytes']} bytes "
              f"stack; spills: {spills or 'none'}", flush=True)
        check(not spills, f"{name}: ptxas spills registers: {spills}")
    flash_sass = flash_tensor_core_sass(built[all_kernels.index(flash_kernel)][0])
    for dt, by_hd in flash_sass.items():
        print(f"flash {dt} kernel SASS: " + ", ".join(
            f"hd {hd}: {n} HGMMA{FLASH_SASS[dt][1]}" for hd, n in sorted(by_hd.items())), flush=True)
    phase_s["1"] = time.perf_counter() - t0
    print(f"phase 1: {phase_s['1']:.2f} s", flush=True)

    # phase 2: kernel vs plain version
    cases = timed("2", phase_kernel, device)
    for c in cases:
        print(f"{c['entry']}{tuple(c['shape'])} feasible={c['check_feasible']}: device "
              f"kernel {c['ms']:.6f} ms, plain {c['plain_ms']:.6f} ms, bound "
              f"{c['bound_ms']:.6f} ms ({c['bound_by']}); per eager call: wrapper "
              f"{c['wrapper_ms']:.5f} ms, plain {c['plain_eager_ms']:.5f} ms; "
              f"max abs err {c['max_abs_err']:.3g}", flush=True)

    # phase 3: the allocator slice
    solves, launches, iid_pgd = timed("3", phase_slice, device)
    profiled = timed("3 (--profile)", phase_profile, device) if args.profile else None

    # phase 4: the flash kernel vs its plain version
    flash_cases = timed("4", phase_flash, device)

    # phases 5 and 6: the Gemma-2 slice (prefill, then ServeLoop)
    # the (1, 1) mesh on the card (a one-process group), for phases 5, 8, 11 and 17
    from repro_torch.launch.mesh import open_mesh

    mesh = open_mesh()
    lm, gemma_launches, gemma_mesh = timed("5-6", phase_lm_path, device, 0, mesh)

    # phase 7: the WKV6 kernel vs its plain version
    wkv_cases = timed("7", phase_wkv, device)

    # phases 8 and 9: the RWKV slice (prefill, then ServeLoop)
    rwkv, rwkv_launches, rwkv_mesh = timed("8-9", phase_lm_path, device, 1, mesh)
    main_wkv = next(c for c in wkv_cases if c["case"] == WKV_MAIN)

    # phase 10: the selective-scan kernel vs its plain version
    scan_cases = timed("10", phase_scan, device)

    # phases 11 and 12: the Jamba slice (prefill, then ServeLoop)
    jamba, jamba_launches, jamba_mesh = timed("11-12", phase_lm_path, device, 2, mesh)
    main_scan = next(c for c in scan_cases if c["case"] == SCAN_MAIN)
    paths = {"gemma2_2b": gemma_launches, "rwkv6_1_6b": rwkv_launches,
             "jamba_1_5_large_398b": jamba_launches, "gemma2_2b (1, 1) mesh": gemma_mesh,
             "rwkv6_1_6b (1, 1) mesh": rwkv_mesh, "jamba_1_5_large_398b (1, 1) mesh": jamba_mesh}
    by_path = lambda name: {arch: n[name] for arch, n in paths.items() if n[name]}

    # phase 13: the scenario families and the baselines
    families, families_launches, classes = timed("13", phase_families, device, iid_pgd)

    # phase 14: the exhaustive oracle through the objective kernel
    oracle, oracle_launches = timed("14", phase_oracle, device)

    # phase 15: the allocation service on the card
    serving, serving_launches = timed("15", phase_serving, device)

    # phase 16: the FedSem closed loop (FL-trained SemCom jobs over the service)
    fedsem, fedsem_launches = timed("16", phase_fedsem, device)
    # phase 17: LM training (Qwen2.5-3B at full width; the smoke families)
    training = timed("17", phase_train, device, mesh)

    # phase 18: federated LM fine-tuning over the allocator
    fedlm, fedlm_launches = timed("18", phase_federated_lm, device)

    # phase 19: Gemma-2 9B, StarCoder2-3B, HuBERT X-Large and Pixtral-12B
    models, model_launches = timed("19", phase_models, device)
    paths.update(model_launches)

    # phase 20: Arctic-480B and DeepSeek-V3 (MoE and MLA) at their published widths
    moe_models, moe_launches = timed("20", phase_moe, device)
    paths.update(moe_launches)

    # phase 21: the paper's figure and table drivers and the three examples
    paper, paper_launches = timed("21", phase_paper, device)

    # phase 22: the Adam loops' kernel at the allocation benchmark's shapes
    p4_adam = timed("22", phase_p4_adam, device)
    main_p4 = p4_adam["cases"][0]
    objective_by_path = {"solve_batch": launches, "families": families_launches,
                         "exhaustive": oracle_launches, "serving": serving_launches,
                         "fedsem": fedsem_launches, "federated_lm": fedlm_launches,
                         "paper": paper_launches}

    trace_case = next(c for c in cases if c["shape"] == [48, 1, 10] and not c["check_feasible"])
    main_flash = next(c for c in flash_cases if c["case"] == "gemma2_2b global")
    record = {"kernels": [{
        "name": "fedsem_objective_batch",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fedsem_objective/csrc/objective.cu",
        "replaces": "src/repro/kernels/fedsem_objective/kernel.py:171",
        "launches": sum(objective_by_path.values()),
        "launches_by_path": objective_by_path,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": trace_case["ms"],
        "plain_ms": trace_case["plain_ms"],
        "bound_ms": trace_case["bound_ms"],
        "bound_by": trace_case["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:78",
        "launches": sum(by_path("flash_attention").values()),
        "launches_by_path": by_path("flash_attention"),
        "max_abs_err": max(c["max_abs_err"] for c in flash_cases),
        "ms": main_flash["ms"],
        "plain_ms": main_flash["plain_ms"],
        "bound_ms": main_flash["bound_ms"],
        "bound_by": main_flash["bound_by"],
        "library_ms": main_flash["library_ms"],
        "ptxas": ptxas.get("flash_attention"),
    }, {
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:47",
        "launches": sum(by_path("rwkv6_scan").values()),
        "launches_by_path": by_path("rwkv6_scan"),
        "max_abs_err": max(c["max_abs_err"] for c in wkv_cases),
        "ms": main_wkv["ms"],
        "plain_ms": main_wkv["plain_ms"],
        "bound_ms": main_wkv["bound_ms"],
        "bound_by": main_wkv["bound_by"],
        "library_ms": None,
        "ptxas": ptxas.get("rwkv6_scan"),
    }, {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:48",
        "launches": sum(by_path("mamba_scan").values()),
        "launches_by_path": by_path("mamba_scan"),
        "max_abs_err": max(c["max_abs_err"] for c in scan_cases),
        "ms": main_scan["ms"],
        "plain_ms": main_scan["plain_ms"],
        "bound_ms": main_scan["bound_ms"],
        "bound_by": main_scan["bound_by"],
        "library_ms": None,
        "ptxas": ptxas.get("mamba_scan"),
    }, {
        "name": "p4_adam",
        "route": "cuda",
        "source": "src/repro_torch/kernels/p4_adam/csrc/p4_adam.cu",
        "replaces": None,
        "launches": sum(P4_BY_PATH.values()),
        "launches_by_path": dict(P4_BY_PATH),
        "loss_gap": p4_adam["loss_gap"],
        "loss_gap_max": p4_adam["loss_gap_max"],
        "ms": main_p4["ms"],
        "plain_ms": main_p4["plain_ms"],
        "bound_ms": main_p4["bound_ms"],
        "bound_by": main_p4["bound_by"],
        "library_ms": None,
        "ptxas": ptxas.get("p4_adam"),
    }]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            dict(build_s=build_s, flash_sass=flash_sass, cases=cases, solves=solves,
                 profile=profiled, flash_cases=flash_cases, lm=lm, wkv_cases=wkv_cases, rwkv=rwkv,
                 scan_cases=scan_cases, jamba=jamba, families=families, classes=classes,
                 oracle=oracle, serving=serving, fedsem=fedsem, training=training,
                 federated_lm=fedlm, models=models, moe_models=moe_models, paper=paper,
                 p4_adam=p4_adam, record=record,
                 card=smi, phase_s=phase_s, script_s=time.perf_counter() - t_script),
            indent=1, default=str))
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"chip_smoke: all 22 phases passed in {time.perf_counter() - t_script:.2f} s", flush=True)
    print(json.dumps(record))
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
