#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device      the card's name and power limit (``nvidia-smi``), torch/CUDA
                 versions, both TF32 flags;
  2. build       nvcc build of every kernel source, in seconds, with the
                 registers of every variant, any that spill, and each
                 library's tensor-core instructions (``cuobjdump -sass``:
                 HGMMA for wgmma, HMMA for mma.sync);
  3. kernel      each kernel against its plain PyTorch version on the card
                 (the f32 commit: accepted rows within rtol = atol = 1e-6 for
                 f32 or one bf16 ulp; the quantized-wire commit: r' and every
                 row bit-equal; rejected rows bit-equal for both), and at the
                 main-path shape its time beside the plain version, a
                 one-call library yardstick where one exists, and the card's
                 bound; both commits (the quantized one on the int8 and the
                 bf16 grid) by their own device time (profiler; the quantized
                 int8 one also by pass: maxima, commit, memset), by CUDA
                 events behind a sleep (``events_ms``), with L2 cold (64 MB
                 written before each call), and by the host's rate of
                 back-to-back calls; the quantized commit with its launch
                 shape (tiles, and each pass's thread blocks and shared
                 memory per block);
  4. histo       the main path: ``run_experiment`` at the paper's full width
                 (224 px, P = 1,639,705 params per node, N = 4) — centralized,
                 local and swarm rows; every commit must launch the fedavg
                 kernel once;
  5. fisher      a fisher/ring ``SwarmSession`` at the same width for 2
                 rounds; every commit must launch the importance-weighted
                 kernel once; then one profiled round;
  6. histo_int8  ``run_experiment`` at the same width on the int8
                 error-feedback wire (``wire_block`` 512): every commit must
                 launch the quantized-wire kernel once, the f32 kernel never;
  7. fisher_int8 the fisher/ring session on the int8 wire for 2 rounds; every
                 commit must launch the quantized importance form once; then
                 one profiled round;
  8. checkpoint  that session saved at paper width and restored into a fresh
                 one; one more round on both must agree bit for bit (cuDNN
                 set deterministic for the round);
  9. parity      one small round on the card against the same round on the
                 CPU (plain commit, CPU convs), TF32 off, params at 1e-4;
  9b. faults     the fault plane at the same width on the int8 wire
                 (fedavg/full, quorum 2, 2 steps a round at batch 16):
                 ``run_plan`` over a 7-round plan of seed 7 (crash node 1 at
                 round 1, back at 3; straggle node 3 at 3; drop node 0 at 4;
                 corrupt node 2 at 5; preempt at 6); every inactive gate
                 off, ``wire_ok`` false only for node 2 in round 5, whose
                 committed row is its pre-sync row bit for bit, round 5's
                 flip pattern on the card equal to the same call on the CPU,
                 the preempted run equal to a twin without the preempt bit
                 for bit (cuDNN deterministic), one quantized commit a round
                 and no f32 commit; the wall time of every round, the sync's
                 time with idle and armed signals beside a plain sync, the
                 device time of a checksum and of an armed flip; then two
                 rounds of a fisher/ring session whose train step returns
                 its gradient (the true-Fisher 4-tuple): one quantized imp
                 commit a round, stats finite and non-zero;
 9c. dryrun     (run after ``merge_one``, before ``histo``) the dry run
                 (`repro_torch.launch.dryrun`): five pairs at full width
                 as model rank 15 of data index 0 on the ``(16, 16)``
                 production mesh in a fake world of 256 ranks, each played
                 on ``meta`` and then on the card with the CUDA kernels
                 (the rank's shard and compute blocks allocated alone,
                 values from a seed): (a) train_4k × Hymba-1.5B (one split
                 step, 8 of 32 layers), (b) prefill_32k × nemotron-4-15b,
                 (c) decode_32k × deepseek-coder-33b (one decode step),
                 under the sharding profile ``default``; (d) (a)'s pair
                 under ``--profile dp`` (one row, the replica group's
                 all_reduce) and (e) prefill_32k × Hymba-1.5B at full depth
                 under ``--profile zero3`` (the stored serving form, 2 rows
                 of 32,768); the meta peak within 10 % of
                 ``max_memory_allocated`` above the memory before the pair,
                 the FLOPs (FlopCounterMode's formulas and the kernels'
                 work) and the kernels' calls equal, the step's profiled
                 device time beside its roofline bound; then flash and
                 ``ssd_scan`` at every shape the pairs launch them at
                 (``dryrun.CARD_FLASH``, ``CARD_SSD``) against their plain
                 versions on a slice (one bf16 ulp; SSD y 2e-2, state
                 1e-4), with times, bounds and SDPA; flash's and SSD's
                 launches on the card (``launches_dryrun``) must be more
                 than 0;
 10. lora_kernel the fused LoRA matmul against its plain version on the card
                 (the reference's tolerance: 2e-5 f32, 2e-2 bf16) at the
                 zoo head's train, validation and test shapes, the
                 reference's four sweep shapes and ragged ones, a zero-B
                 case equal to x @ W, and the autograd Function's
                 gradients (x, W, A, B, scale) against autograd through the
                 plain version at 1e-5; times at the zoo shape and at
                 (M, K, N, r) = (128, 1024, 256, 64) beside the plain
                 version, the unfused cuBLAS form (three calls, never used
                 by the port) and the card's bound: device time per call
                 from the profiler, and the host clock's time per call;
                 beside them the device time of a one-element kernel
                 (``zero_``), the floor under any launch;
 11. hetero      the heterogeneous model-zoo swarm: ``run_scenario`` over
                 the five cells of ``scenario_grid`` at the
                 ``ScenarioRunConfig`` defaults (N = 4, 16 px, feat 16,
                 hidden 16, rank 4, 24 steps, int8 wire); per cell the LoRA
                 kernel must launch, the quantized commit once per sync and
                 the f32 commit never, 180 payload values per node, the wire
                 at most 5 % of a full f32 sync, finite per-site AUCs and the
                 reference's row keys; then one profiled zoo round and a
                 card-vs-CPU parity of one zoo round (TF32 off, payload rows
                 at 1e-4);
 12. flash_kernel the flash attention kernel against its plain version
                 (``attention_ref``): the reference's sweep shapes at 2e-5
                 (f32) and its bf16 case at 3e-2, ragged and strided cases,
                 and Hymba-1.5B's prefill shapes (q [1,25,S,64] at both of
                 the serve phase's prompt lengths S = 256 and 2048, K/V
                 [1,5,T,64] bf16, T its max_len) with window 0 and 1024
                 within one bf16 ulp (atol 2e-4, rtol 8e-3); there the
                 kernel's device time (and the same calls timed by
                 ``events_ms``, the clock ``device_ms`` falls back to) and
                 TFLOP/s beside the plain version's, one
                 ``scaled_dot_product_attention`` call
                 (``enable_gqa``, the mask as a boolean tensor; never used
                 by the port), at window 0 also one with ``is_causal=True``
                 and no mask (the summary takes the faster), and the bound;
                 then the families' full-width shapes (``FAMILY_FLASH``:
                 granite-moe's q [1,24,2048,64] and [1,24,256,64] in a
                 2064-deep lane, a GQA group of 3, and part (g)'s split
                 step [4,24,256,64] and gate [2,24,256,64] over 256 keys,
                 whole and head-parallel ([4,12,256,64] over
                 [4,4,256,64], [2,12,256,64]); internvl2's
                 [4,14,2048,64], a group of 7; seamless's non-causal
                 encoder [4,16,1024,64]; minicpm-2b's [1,36,2048,64] and
                 [1,36,256,64] in a 2064-deep lane and its training step's
                 [4,36,256,64] over 256 keys, a group of 1; q, K and V
                 strided views of [B,S,H,D] and [B,T,Hkv,D], as the path
                 gives them) held at the same tolerance and timed beside
                 the plain version, one SDPA call and the bound;
                 then the bf16 D = 128 body at nemotron-4-15b's and
                 deepseek-coder-33b's shapes (``WIDE_FLASH``: q
                 [1,48,2048,128] and [1,56,2048,128] over 8 KV heads,
                 causal, K/V [1,8,2048,128]; then as their served paths
                 give them, q strided and K/V strided views of a
                 2064-deep cache, nemotron's q [1,48,2048,128] and
                 [1,48,256,128] and deepseek's at batch 4) at the
                 same tolerance: device time with L2 warm and cold (64 MB
                 written before each call), beside the plain version, one
                 SDPA call and the bound (``d128``); then both D = 16
                 bodies (``D16_FLASH``, f32 at 2e-5 and bf16 within one
                 ulp: the engine example's [32, 4, 32, 16] over 2 KV
                 heads, [1, 4, 2048, 16] causal with windows 0 and 64, a
                 non-causal [2, 4, 256, 16] and a ragged GQA case) with
                 their times beside the plain version, one SDPA call and
                 the bound (``d16``); head dims 8 and 48 must raise; then
                 the query-offset form (``QOFF_FLASH``: a
                 sequence-parallel rank's rows at q_off.. over the whole
                 K/V; part (h)'s [2,25,1024,64] over [2,5,2048,64] at
                 q_off 0 and 1,024, windows 0 and 1,024, then one D = 16
                 and one D = 128 shape in each dtype, then (h)'s twin's
                 [2,25,2048,64] over the same keys at q_off 0) within one
                 bf16 ulp (f32 within 1.2e-6); part (j)'s served
                 prefills: Hymba's [2,25,128,64] over [2,5,256,64] at
                 q_off 0 and 128 and the whole-residual [2,25,255,64]
                 over [2,5,255,64], windows 0 and 1,024, and granite's
                 head-parallel [2,12,256,64] and [2,12,255,64] over 4 KV
                 heads (``FAMILY_FLASH``); the odd steps' whole-residual
                 calls: Hymba's [2,25,2047,64] over [2,5,2047,64] and
                 seamless's encoder [2,8,1023,64], its cross-attention
                 [2,8,255,64] over 1,023 keys and its causal decoder
                 [2,8,255,64] (``FAMILY_FLASH``); with times beside
                 the plain version, one SDPA call with the boolean mask and
                 the bound (``q_off``);
 13. ssd_kernel  the SSD scan kernel against its plain version: the
                 reference's sweep at 1e-4 (f32) and Hymba's (1, S, 50,
                 64, 16, 256) at S = 2048 and 256 and Mamba2's (1, 2048,
                 32, 64, 128, 256) bf16 shapes, then part (h)'s (2, 2048,
                 25 or 50, 64, 16, 256) (a model rank's heads, the twin's)
                 with x, B and C strided views of the conv's output as
                 ``ssm_block`` passes them, y at 2e-2 and the f32 final
                 state at 1e-4, then part (j)'s (2, 256, 25, 64, 16, 256)
                 and (2, 255, 25, 64, 16, 255) (a model rank's heads of a
                 served prefill, the residual cut and whole), there the
                 kernel's and the plain version's states each against the
                 plain version evaluated in f64, then (h)'s odd step's
                 (2, 2048, 25, 64, 16, 256) on the padded copies; a_log per batch row (the trainer's folded
                 nodes) against one row at a time with a shared [H] (the
                 serving path's stride 0), bit for bit; times, TFLOP/s and
                 bounds (C·Bᵀ at the bf16 tensor-core rate, the rest at the
                 f32 rate; no single PyTorch call computes it);
 14. merge_one   the one-node commit through ``kernels.ops.merge_op``: each
                 node of a [4, 1,639,705] f32 swarm state committed alone
                 (the counted path) equals the all-nodes kernel's row bit
                 for bit; bit-equal to its plain version under an accepting
                 and a rejecting gate; timed beside one
                 ``torch.where(g, w @ x, x[self_idx])``, and by CUDA events
                 with the gate and self_idx as Python values (passed by
                 value) and as device tensors;
 15. lm_parity   the smoke variants of hymba-1.5b, minicpm-2b and
                 mamba2-370m, and nemotron-4-15b's and deepseek-coder-33b's
                 at head dim 128 with their GQA groups (6 and 7 heads over
                 one: flash's f32 D = 128 body), in f32 on the card against
                 the CPU (TF32 off): prefill logits and 4 decode steps
                 within 1e-4;
 16. serve       the LM serving path at full width: hymba-1.5b in bf16, an
                 N = 4 ensemble initialised on the card from
                 ``torch.Generator`` seeds, ``ServeEngine`` in consensus
                 mode with 4 slots and seq buckets (256, 2048), one
                 captured CUDA graph per dispatch key and pool buffer
                 (``repro_torch.launch.capture``). Three waves, the counts
                 set to 0 before each: a cold one (8 requests of 16 new
                 tokens, prompts of 2048 and 256 tokens, a ``swap()`` of a
                 second ensemble while requests are in flight) in which
                 every key it dispatches is built exactly once (flash and
                 SSD launches = 4 nodes × 32 layers × (8 prefills + the
                 builds' warm-up passes)); a warm one with the same traffic
                 and a swap back (no build; launches = 4 × 32 × 8); and one
                 of 4 new tokens with node 1 failed and restored mid-flight
                 (no build; a decode-only tick profiled). Every request
                 must finish;
                 two requests of the cold wave (one per version) served
                 again outside the engine, node by node at the engine's
                 shapes, must give the same tokens; ``generate()`` of batch
                 4 cold (its two programs built) and warm (flash and SSD 32
                 launches each); on the card every program's body ran
                 eagerly only in its one warm-up (each under
                 ``torch.cuda.set_sync_debug_mode("error")``). Lines
                 ``serve_builds`` (per key: builds, seconds, capture
                 seconds per buffer, launches per replay), ``serve``
                 (tokens/s, p50/p99 latency, prefill and decode-tick times
                 over the warm wave, the cold wave's wall and build time
                 apart, the profiled tick's busy share, host ops and
                 launches, peak memory) and ``serve_replay`` (on warm keys,
                 a decode tick: the body called eagerly against a replay,
                 in turns (eager, replay), wall, device time and busy
                 share; the 2,048-token prefill replayed under the
                 profiler, its flash and SSD kernel records equal to its
                 launches), each with
                 the card's name and power limit;
 16b. train_grads the flash and SSD autograd Functions (kernel forward,
                 plain backward, vmap rule) under torch.func.vmap(grad) over
                 2 nodes at Hymba-1.5B's (q [4,25,256,64], K/V [4,5,256,64],
                 windows 0 and 1024; SSD [4,256,50,64], N 16) and
                 Mamba2-370M's (SSD [8,256,32,64], N 128) training shapes,
                 f32 and bf16, against autograd through the plain versions
                 (1e-4 / 2e-2 of 1 + |want|), and the folded forward against
                 a per-node loop bit for bit;
 16c. train_parity one train step of the hybrid and of the moe (granite)
                 smoke variant in f32 on the card (flash and SSD kernels,
                 the MoE's backward) against the CPU (TF32 off): the loss
                 within 1e-5 relative, AdamW's moments within 1e-3 of each
                 leaf's largest magnitude, the update within 1 % of its
                 norm, params within 2·lr, launches as ``TRAIN_PARITY``;
 16d. train      the LM trainer at full width through its CLI entry point
                 (``repro_torch.launch.train.run``), counts set to 0 before
                 each path: Mamba2-370M (bf16, f32 A_log/D/dt_bias) as an
                 N = 4 swarm, ``--sync-every 2 --steps 4 --batch 8 --seq
                 256``, on the f32 and on the int8 wire, and Hymba-1.5B and
                 granite-moe-3b (bf16, its routers' weights f32) each as
                 one learner, 2 steps at ``--batch 4 --seq 256``; each with
                 finite params and losses, changed f32 leaves and the
                 predicted launches (``TRAIN_PATHS``), its last round's
                 (step's) wall and tokens/s, then one profiled round (step):
                 device time per step, busy share, peak memory;
 16e. families_parity the smoke variants of granite-moe-3b, internvl2-1b
                 (with patch embeddings) and seamless-m4t-medium (its
                 encoder output) in f32 on the card against the CPU (TF32
                 off): prefill logits and 4 decode steps within 1e-4, and
                 the MoE's expert ids and keep masks equal;
 16f. families_serve one model of each new family at full width in bf16
                 (random weights from seeded generators), counts set to 0
                 before each: granite-moe-3b behind ``ServeEngine`` (N = 4,
                 4 slots, buckets (256, 2048), captured graphs, a cold and
                 a warm wave of 8 requests of 16 tokens, no hot swap; flash
                 = 4 × 32 a prefill); internvl2-1b's ``model.prefill`` of
                 256 patch embeddings + 1,792 tokens at batch 4 (flash 24)
                 then 16 replays of the captured decode step;
                 seamless-m4t-medium's ``encode`` of 4 × 1024 frames
                 (flash 12, ``causal=False``) copied into the step
                 buffers' ``enc_out``, then 32 replays of the captured
                 decode step. Each: wall, tokens/s, a profiled prefill (or
                 encode) and decode tick (device time, busy share), peak
                 allocated and reserved memory, launches against the
                 prediction;
 16f'. wide_serve the three dense configs not run at full width before,
                 bf16, random weights from seeded generators, the counts
                 set to 0 before each path, the step programs' caches
                 cleared before each and after the phase: nemotron-4-15b
                 behind ``ServeEngine`` at N = 1 (as granite-moe above: 4
                 slots, buckets (256, 2048), a cold and a warm wave of 8
                 requests of 16 tokens, no hot swap, the warm wave building
                 nothing; flash 32 a prefill, 256 in the warm wave), its
                 warm decode key and 2048 prefill key run eagerly against a
                 replay (tokens equal; wall, device time, busy share);
                 deepseek-coder-33b through ``generate`` at batch 4,
                 prompts of 2048, 16 new tokens, ``max_len`` 2064, its
                 weights initialised into the step buffers' params and
                 handed back (no copy: the buffer unwritten), cold (flash
                 124: the prefill build's warm-up and its replay) then warm
                 (flash 62), the same tokens, each program's body eagerly
                 against a replay (tokens equal), a profiled prefill and
                 decode step; minicpm-2b behind the engine at N = 4 as
                 nemotron (flash 160 a prefill, 1,280 in the warm wave),
                 then trained plain through ``launch/train.run`` (2 steps
                 at 4 × 256, as ``hymba_plain``; flash 80). Each line: the
                 card, memory allocated before the path, its peak (under
                 the card's), walls, tokens/s, prefill and tick times and
                 busy shares, launches against the prediction;
 16g. remat     activation checkpointing at full width: granite-moe-3b and
                 Hymba-1.5B (bf16), two ``make_train_step`` steps at batch 4
                 × 256 from the same init and batches with
                 ``TrainConfig(remat=False)`` then ``remat=True``: peak
                 allocated (above what was held) and reserved, each step's
                 wall, the first step's flash/SSD launches (one a layer,
                 two with remat: the recompute runs the kernels again), the
                 first step's loss bit-equal and its params within 2·lr
                 plus one bf16 ulp; at 8 layers, its first moment (0.1·g)
                 in f32 within 1e-3 of each leaf's largest magnitude (the
                 bf16 moments' differences reported);
 16h. host      the host backend (``SwarmSession(..., backend="host")``)
                 at the paper CNN's full width, N = 4, fedavg/full and
                 fisher/ring, three rounds of two steps with node 3 leaving
                 and rejoining, each round from the engine backend's state
                 and held against the engine's round (params within the
                 session tests' 1e-4, after the local steps but for a
                 few strays within 2·Σlr and each node's update within
                 1 % of its norm; gates equal outside the 1e-4 margin);
                 counts set to 0 before each host round: one
                 ``fused_merge_all`` launch a sync (plain, then ``imp``);
                 round walls, the engine's round wall, one more host
                 round's wall (the fisher/ring path's under the profiler:
                 its device-busy share);
 16i. gossip    the gossip backend (``SwarmSession(..., backend=
                 "gossip")``, `repro_torch.core.gossip`): (a) on a world of
                 one NCCL rank in this process (4 nodes a rank), the paper
                 CNN at full width from a shared start state (two local
                 steps on the engine backend), fedavg/full on the f32
                 wire, fisher/ring on the int8 wire and fedavg/dynamic on
                 the int8 wire with node 3 absent: a gossip session round
                 (no kernel launch: the commit is the where-select), then
                 from its state the commit after 6 settling syncs (the
                 reference's settled regime) held against the engine
                 backend's within 1e-5 (gates equal); the schedule each
                 picks, sync walls, counted and predicted bytes; (b)
                 Mamba2-370M at full width on the same world (ring fedavg,
                 f32 wire, 8 × 256 tokens a node): a round, the next
                 round's local steps and its gossip sync, ``ssd_scan``
                 launches equal to the prediction, the sync held against
                 the engine backend's from the same state (1e-5, one bf16
                 ulp in the bf16 slots), step and sync walls, tokens/s,
                 peak memory, counted against predicted bytes, then one
                 profiled round's busy share; (c) 4 gloo ranks spawned on
                 the one card (one node each), every schedule of the slice
                 on every wire it takes (``GOSSIP_C``), each commit held
                 against the engine backend's (within 1e-5; the fisher
                 side channel on the bf16 wire within bf16 rounding), sync
                 walls and counted bytes; (d) 4 more gloo ranks on the
                 card, spawned together with (c), as a two-level mesh of 2 pods × 2 nodes
                 (``make_two_level_swarm_mesh``), the CNN at full width,
                 ring, int8, ``self_weight`` 0.7: the cost model's picks
                 (the hierarchical forms at ``cross_pod_cost`` 10, the
                 flat ring forms at 5), each setting's commit after 6
                 settling syncs held against an f64 numpy oracle within
                 1e-5 (the pod-ring mix of pod aggregates; the flat
                 forms' ring merge), the bytes each rank handed, by link
                 class, against the cost model at the padded width, sync
                 walls; then a 4-round fault plan (node 1 crashed at round
                 1, back at 3) with a preempt at round 3 (a collective
                 save → fresh session → load) against the same plan
                 without it, bit for bit (params, moments, statistics,
                 every wire leaf), for both hierarchical schedules and the
                 flat ring q8 (the CNN's AdamW steps; the fisher form the
                 reference's fault-test decay step), with the checkpoint's
                 bytes and save and load seconds; (e) inner (model) sharding within a
                 node: Mamba2-370M at its published width, 2 of its 48
                 layers, on 4 gloo ranks as 2
                 nodes × model 2 (``make_swarm_mesh(2, model=2)``, the
                 rules' ``param_specs``), fedavg/full, 2 steps a round of
                 8 × 256 tokens a node, 2 rounds on the f32 wire (the cost
                 model picks ``fedavg_psum``) and 2 on the int8 wire
                 (``gathered_rows``: the q8 psums drop out), against an
                 unsharded twin of the same 2 nodes on 2 gloo ranks from
                 the same init and batches (the twin's int8 run with specs
                 of size-1 axes, which pick the same schedule): the f32
                 params after each round and the gates bit for bit (if the
                 twin is not bit-reproducible, a second twin run bounds
                 the difference), the int8 commit after the first sync
                 within 1e-5 (one bf16 ulp in the bf16 slots) of an f64
                 oracle of the per-shard block grid, each rank's pick,
                 the bytes it handed per sync against the twin's and the
                 cost model's, resident memory between rounds and the
                 peaks of the local steps and of the sync against the
                 twin's (the twin spawned together with the sharded
                 world), round and sync walls, ``ssd_scan`` launches
                 against the prediction, and one f32 checkpoint of the
                 sharded session equal byte for byte (SHA-256) to the
                 twin's; (f) split compute within a node: the same model
                 on 4 gloo ranks as 2 nodes × data 2
                 (``make_swarm_mesh(2, data=2)``, the rules' specs) whose
                 ``TrainStep`` runs split (each layer gathered just in
                 time inside remat's checkpoint, 4 of a node's 8 rows a
                 data rank, gradients and AdamW on the shard), 2 rounds
                 of fedavg/full on the f32 wire at lr 7.5e-5, against an
                 unsharded twin on 2: the gates equal on every rank, the
                 node losses within rtol 1e-5 at the first step (the same
                 params) and 1e-3 after it (bf16 updates rounded apart),
                 the whole node's params
                 after each round within rtol 3·2⁻⁸, atol 6e-4 (bf16) and
                 1e-4, 1e-4 (f32 leaves), each kind's largest difference,
                 ``ssd_scan`` launches (48 a rank), the gather and
                 gradient bytes of a step (the gradient reduced onto the
                 shard: a reduce_scatter, a reduce to the owner and an
                 all_reduce of the blocks the data group keeps) and the
                 split gate's gathers of a sync against the layout's
                 count, exactly, each gate's peak above the memory
                 allocated before it, the steps' peak and resident memory
                 against the twin's, and step, round and sync walls; (h)
                 tensor parallelism: Hymba-1.5B at its published widths, 2
                 of 32 layers, bf16, remat, 2 rows of 2,048 tokens, on 4
                 gloo ranks as 2 nodes × model 2 against an unsharded twin
                 on 2 (spawned with (e)'s and (f)'s): attention
                 sequence-parallel through flash's query offset (windows 0
                 and 1,024), 25 of 50 SSM heads a rank, ff and vocab over
                 2; the gates equal, losses and metrics within 1e-3 of the
                 twin's, the params within (f)'s tolerances, every byte
                 kind of a step and of the split gate against the
                 layout's count (`_tp_bytes`) exactly, flash and
                 ``ssd_scan`` launches as predicted, walls and peaks; (g)
                 granite-moe-3b-a800m at its published widths, 2 of 32
                 layers, bf16, remat, on 8 gloo ranks as 2 nodes × data 2
                 × model 2 with the rules' specs, tensor-parallel over
                 each model group (attention head-parallel, 20 of 40
                 experts a rank, the vocab over 2): one round of 2 split
                 steps and a fedavg/full sync on the f32 wire whose gate
                 scores each node twice, through the split gate and
                 through the whole-node gather (the two nodes' whole
                 gathers one after the other), metrics within 1e-3 and
                 gates equal, each gate's peak above the memory allocated
                 before it within its count from the layout and the
                 validation rows' shapes (the whole-node gate's at least
                 two nodes' slots), the compute block's size against the
                 whole layer's, every byte kind of a step and of the gate
                 against the layout's count exactly, flash launches as
                 predicted, and step and sync walls and every rank's peak;
                 (j) serving under tensor parallelism in (h)'s world after
                 its round: node position 0's model group (node, data,
                 model) = (1, 1, 2) serves Hymba-1.5B (the K/V cache on
                 the head dim: 5 KV heads over 2; 25 of 50 SSM heads a
                 rank), position 1's granite-moe-3b-a800m (the cache on
                 4 of 8 KV heads; 20 of 40 experts), each at its published
                 widths and all 32 layers in bf16 from the seed-0 init,
                 its compute blocks sliced once from the node, through
                 ``generate`` with a mesh: 2 rows, a 256-token prompt (the
                 residual cut on the sequence) and one of 255 (whole), 16
                 new tokens, ``max_len`` 272; then a prefill and 4 decode
                 steps alone; each against its unsharded twin on model
                 rank 0 (captured programs): both ranks' streams and
                 logits equal, a 2-layer f32 check within 1e-4 of the
                 twin's with the streams equal, at full depth the logits
                 and the twin's against the twin's weights evaluated in
                 f32, the model group's at most ``GOSSIP_J_BF16_RATIO``
                 times as far as the twin's, within the bound that gives
                 of the twin's and the streams equal wherever the twin's
                 top-2 margin exceeds twice that bound, every
                 byte kind of a prefill, a token and each ``generate``
                 against ``_tp_serve_bytes`` exactly, flash and
                 ``ssd_scan`` launches as counted (one a layer a prefill),
                 the rank's values its compute blocks', resident memory,
                 serving peaks and cache bytes against the twin's,
                 prefill, token and ``generate`` walls (host copies and
                 TCP: no speedup claimed); (k) the enc-dec served over a
                 model group in (i)'s world after its round: each node
                 position's (1, 1, 2) group serves seamless-m4t-medium at
                 its published widths and 12 + 12 layers in bf16 (self
                 cache on 8 of 16 KV heads, ``enc_out`` whole), 2 rows of
                 1,024 frames encoded by ``encode_step_for`` (the residual
                 cut, one gather of the output), a prompt of 8 tokens fed
                 one at a time through ``serve_step_for``'s decode step
                 and 8 new tokens, against its unsharded twin on model
                 rank 0, with (j)'s checks (a 2 + 2-layer f32 check, the
                 full-depth rule, values, memory, cache bytes, an
                 encode's and a token's bytes against
                 ``_tp_serve_bytes``, flash 12 an encode and none a
                 decode step, walls); and after (h)'s and (i)'s rounds
                 one split step each from the seed-0 init at
                 ``GOSSIP_ODD_LR`` on a sequence the model group does not
                 divide (2 rows of 2,047 tokens; 1,023 frames and 255
                 tokens: the whole residual) against the twin's step on
                 the same batch: the loss within 1e-3, the params within
                 (f)'s tolerances, the gradient leaf by leaf against the
                 twin weights' f32 gradient at most
                 ``GOSSIP_J_BF16_RATIO`` times as far as the twin's,
                 every byte kind against ``_tp_bytes``, the launches.
                 One card shows no inter-card traffic: (a)/(b) are one
                 rank's NCCL calls, (c)-(k) go through host memory;
 16j. examples  (run after ``host``, before ``gossip``) the twins of the
                 reference's examples through their ``main`` at the
                 reference's default sizes (the protocol's depth cut to
                 one round of 20 of its 400 steps), the counts set to 0 before
                 each (the memory of the serving paths released first): ``examples/torch_engine_swarm.py`` (the
                 tiny LM, head dim 16, N = 4: 3 rounds of 5 steps,
                 ``leave(3)``, 3 more; gates each round, node 3 out of every
                 merge after the leave, one ``fused_merge_all`` a round,
                 flash's f32 D = 16 body at [32, 4, 32, 16]: its launches
                 are ``launches_d16``), ``torch_histopathology_swarm.py``
                 (the §4 protocol, 3 scenarios of 20 steps in a temporary
                 working directory: three JSON files, nine finite report
                 rows each with AUC in [0, 1], exactly 1 ``fused_merge_all``
                 launch a scenario and nothing else) and
                 ``torch_serve_demo.py`` (4 smoke families, [4, 16] tokens
                 each, flash and ``ssd_scan`` launched; the consensus
                 ensemble's 6 requests done); each twin's seconds and peak
                 memory;
 17. timing      how many device times the profiler read, how many traces
                 ``device_ms`` discarded for lost kernel records, how
                 many times it fell back to CUDA events, every phase's
                 seconds and the script's;
 18. kernels     the per-kernel summary line (each kernel's achieved
                 TFLOP/s among its numbers; flash's launches of its D = 128
                 body on the wide_serve paths, ``launches_d128``, of
                 its D = 16 body on the engine example's, ``launches_d16``,
                 and flash's and SSD's in the dry run's card ranks,
                 ``launches_dryrun``, must be more than 0), then the ``ok``
                 line.

The kernel phases (3, 10, 12-14) run before the paths 4-9b and 11: in a
process that has run those paths, most of ``torch.profiler``'s traces on
the H100 lose kernel records, and ``device_ms`` would fall back to CUDA
events.

Exits non-zero, printing no result, without a CUDA device or without the
repository's sources beside it. Imports nothing of the JAX package.
"""
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# memory rate (bytes/s), f32 non-tensor-core peak and bf16 tensor-core peak
# (flop/s) by card, from NVIDIA's data sheets (dense, at the full power
# limit)
CARDS = (("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100", 3.35e12, 67e12, 989e12))
SOURCES = {"fused_merge": "src/repro_torch/csrc/fused_merge.cu",
           "fused_quant_merge": "src/repro_torch/csrc/fused_quant_merge.cu",
           "lora_matmul": "src/repro_torch/csrc/lora_matmul.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu"}
# kernel → (source stem, the TPU kernel body it replaces)
KERNELS = {
    "fused_merge_all": ("fused_merge",
                        "src/repro/kernels/fused_merge.py:114"),
    "fused_merge_all_imp": ("fused_merge",
                            "src/repro/kernels/fused_merge.py:126"),
    "fused_quant_merge_all": ("fused_quant_merge",
                              "src/repro/kernels/fused_merge.py:206"),
    "fused_quant_merge_all_imp": ("fused_quant_merge",
                                  "src/repro/kernels/fused_merge.py:226"),
    "lora_matmul": ("lora_matmul", "src/repro/kernels/lora_matmul.py:26"),
    "fused_merge": ("fused_merge", "src/repro/kernels/fused_merge.py:69"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:24"),
    "ssd_scan": ("ssd_scan", "src/repro/kernels/ssd_scan.py:25")}
N, P = 4, 1_639_705
WIRE_BLOCK = 512
# the device records of one quantized commit: its two kernels and the
# int8 maxima array's memset
QUANT_KERNELS = ("quant_merge_kernel", "Memset")
QUANT_PASSES = ("quant_merge_kernel_max", "quant_merge_kernel_commit",
                "Memset")


def mma_counts(build, stems):
    """{library: {"HGMMA": n, "HMMA": n}} from ``cuobjdump -sass`` (the
    tensor-core instructions each library holds: HGMMA is wgmma, HMMA
    mma.sync), or "not available" where the toolkit lacks cuobjdump."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {stem: "not available" for stem in stems}
    # one cuobjdump a library, all started together
    procs = {stem: subprocess.Popen(
        [str(tool), "-sass", str(build.library_path(stem))],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for stem in stems}
    out = {}
    for stem, proc in procs.items():
        sass = proc.communicate(timeout=120)[0]
        out[stem] = {op: len(re.findall(rf"\b{op}\b", sass))
                     for op in ("HGMMA", "HMMA")}
    return out


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_rates(name):
    """(memory rate, f32 peak, bf16 tensor-core peak) of the card."""
    for key, bw, flops, bf16 in CARDS:
        if key in name:
            return bw, flops, bf16
    raise RuntimeError(f"no memory/flop rates on record for {name!r}")


def bound(nbytes, flops, bw, rate):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over ``rate``."""
    bytes_ms, flops_ms = nbytes / bw * 1e3, flops / rate * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def tflops(flops, ms):
    """Achieved rate: the operations the function needs over its time."""
    return flops / (ms * 1e-3) / 1e12


def time_ms(fn, iters=50, warm=20, repeats=7):
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, from CUDA events, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


TIMERS = {"profiler": 0, "events": 0, "traces_discarded": 0}


def device_ms(fn, iters=200, warm=20, tries=2, match=None):
    """Device time per call: the CUDA kernels' own time summed over
    ``iters`` calls under ``torch.profiler``, over ``iters``. Where one call
    takes microseconds, CUDA events around back-to-back calls measure the
    host's rate of enqueueing them (the Python wrapper), not the card.

    The profiler's CUPTI trace on the H100 now and then loses kernel
    records: some of a session's, or all of them. A call launches the same
    kernels every time, so a trace is kept only if each kernel's record
    count is a whole multiple of ``iters``; otherwise it is discarded and
    the calls traced again. After ``tries`` discarded traces the time is
    taken with ``events_ms`` instead. ``TIMERS`` counts the readings of
    each clock and the traces discarded. With ``match`` (a string or a
    tuple of them), only the kernels whose name holds one are summed (a
    wrapper's own small copies left out); the CUDA-event fallback cannot
    separate them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (match is None or any(
                    m in e.key for m in ((match,) if isinstance(match, str)
                                         else match)))]
        if cuda and all(e.count % iters == 0 for e in cuda):
            TIMERS["profiler"] += 1
            return sum(e.self_device_time_total for e in cuda) / 1e3 / iters
        TIMERS["traces_discarded"] += 1
    print("device_ms: the profiler lost kernel records in every trace; "
          "timing with CUDA events", file=sys.stderr, flush=True)
    TIMERS["events"] += 1
    return events_ms(fn, iters)


def events_ms(fn, iters=200):
    """Device time per call from CUDA events around ``iters`` back-to-back
    calls, enqueued while the card spins in ``torch.cuda._sleep`` for
    longer than the host takes to enqueue them, so that the calls run
    without gaps between them and the events read the card, not the host."""
    import torch
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0        # an upper bound on enqueueing
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 10 ** 7
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    per_s = cycles / (start.elapsed_time(end) * 1e-3)
    torch.cuda._sleep(int(1.2 * host_s * per_s))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_commit(got, want, x, gates):
    """Max |got − want| over accepted rows; raises outside the tolerance or
    when a rejected row is not the input row ``x`` bit for bit."""
    import torch
    g = gates.to(torch.bool)
    if not torch.equal(got[~g], x[~g]):
        raise AssertionError("rejected rows differ from the input rows")
    if not g.any():
        return 0.0
    a, b = got[g].float(), want[g].float()
    err = (a - b).abs()
    if got.dtype == torch.bfloat16:
        limit = b.abs() * 2.0 ** -7          # one bf16 ulp bounds the spacing
    else:
        limit = 1e-6 + 1e-6 * b.abs()
    if bool((err > limit).any()):
        raise AssertionError(f"kernel disagrees with plain: max err "
                             f"{float(err.max())}")
    return float(err.max())


def phase_kernels(dev, bw, peak):
    import torch
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels.ref import fused_merge_all_plain

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {}
    for form in ("fused_merge_all", "fused_merge_all_imp"):
        imp_form = form.endswith("imp")
        max_err = 0.0
        for n, d, dtype in ((N, P, torch.float32), (64, 777, torch.float32),
                            (4, 2048, torch.bfloat16)):
            x = torch.randn(n, d, device=dev, generator=gen).to(dtype)
            W = torch.rand(n, n, device=dev, generator=gen)
            W = W / W.sum(1, keepdim=True)
            f = (torch.rand(n, d, device=dev, generator=gen) + 0.1
                 if imp_form else None)
            for name, gates in (("accept", torch.ones(n, dtype=torch.bool)),
                                ("reject", torch.zeros(n, dtype=torch.bool)),
                                ("mixed", torch.arange(n) % 2 == 0)):
                gates = gates.to(dev)
                got = fm.fused_merge_all(x, W, gates, f)
                want = fused_merge_all_plain(x, W, gates, f)
                torch.cuda.synchronize()
                max_err = max(max_err, check_commit(got, want, x, gates))
        # time at the main-path shape, every gate accepting
        x = torch.randn(N, P, device=dev, generator=gen)
        W = torch.full((N, N), 1.0 / N, device=dev)
        f = torch.rand(N, P, device=dev, generator=gen) + 0.1 if imp_form else None
        g = torch.ones(N, dtype=torch.bool, device=dev)
        # the kernel's own device time (profiler; the wrapper's gate cast
        # left out), CUDA events behind a sleep, with L2 cold (a 64 MB
        # buffer written before each call: x alone is 26 MB), and the
        # host's rate of back-to-back calls
        call = lambda: fm.fused_merge_all(x, W, g, f)
        ms = device_ms(call, match="merge_all_kernel")
        ev_ms = events_ms(call)
        flush = torch.empty(16 * 2 ** 20, device=dev)
        cold_ms = device_ms(lambda: (flush.zero_(), call()), iters=50,
                            match="merge_all_kernel")
        host_ms = time_ms(call)
        plain_ms = time_ms(lambda: fused_merge_all_plain(x, W, g, f), iters=20)
        if imp_form:
            lib = lambda: torch.where(g[:, None], (W @ (f * x))
                                      / (W @ f).clamp_min(1e-30), x)
            nbytes = 3 * N * P * 4 + N * N * 4 + N
            flops = N * N * P * 4 + N * P
        else:
            lib = lambda: torch.where(g[:, None], W @ x, x)
            nbytes = 2 * N * P * 4 + N * N * 4 + N
            flops = N * N * P * 2
        library_ms = time_ms(lib, iters=20)
        bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
        stats[form] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms, tflops=tflops(flops, ms),
                           bound_ms=max(bytes_ms, flops_ms),
                           bound_by="bytes" if bytes_ms >= flops_ms
                           else "operations")
        emit("kernel", name=form, shape=[N, P], kernel_ms=ms,
             events_ms=ev_ms, cold_l2_ms=cold_ms, host_rate_ms=host_ms,
             **{k: v for k, v in stats[form].items() if k != "ms"})
    return stats


def phase_quant_kernels(dev, bw, peak):
    """The quantized-wire commit against its plain version: r' and every
    committed row bit-equal. Main-path shape with the paper CNN's real block
    grid (conv leaves gathered through ``perm``), and N = 64 at D = 777."""
    import torch
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.core import comms
    from repro_torch.core.flat import FlatLayout
    from repro_torch.experiments import histo
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels.ref import fused_quant_merge_all_plain

    layout = FlatLayout.of_module(histo._model(PAPER_FULL))
    if layout.size != P:
        raise AssertionError(f"{layout.size} params per node, want {P}")
    gen = torch.Generator(device=dev).manual_seed(1)
    stats = {}
    for form in ("fused_quant_merge_all", "fused_quant_merge_all_imp"):
        imp_form = form.endswith("imp")
        for wire in ("int8", "bf16"):
            for n, shape in ((N, layout), (64, 777)):
                d = P if shape is layout else shape
                grid = comms.wire_grid(shape, wire, WIRE_BLOCK, device=dev)
                x = torch.randn(n, d, device=dev, generator=gen)
                r = x + 0.01 * torch.randn(n, d, device=dev, generator=gen)
                W = torch.rand(n, n, device=dev, generator=gen)
                W = W / W.sum(1, keepdim=True)
                f = (torch.rand(n, d, device=dev, generator=gen) + 0.1
                     if imp_form else None)
                for gates in (torch.ones(n, dtype=torch.bool),
                              torch.zeros(n, dtype=torch.bool),
                              torch.arange(n) % 2 == 0):
                    gates = gates.to(dev)
                    got, rp = fm.fused_quant_merge_all(x, r, W, gates, f,
                                                       grid=grid)
                    want, wrp = fused_quant_merge_all_plain(x, r, W, gates, f,
                                                            grid=grid)
                    torch.cuda.synchronize()
                    if not torch.equal(rp, wrp):
                        raise AssertionError(
                            f"{form} {wire} N={n}: r' differs from plain, "
                            f"max err {float((rp - wrp).abs().max())}")
                    check_commit(got, want, x, gates)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"{form} {wire} N={n}: committed differs from "
                            f"plain, max err {float((got - want).abs().max())}")
            # time at the main-path shape, every gate accepting: device
            # time (profiler), CUDA events behind a sleep, with L2 cold (a
            # 64 MB buffer written before each call, as a round's local
            # steps would leave it), and the host's rate of back-to-back
            # calls
            grid = comms.wire_grid(layout, wire, WIRE_BLOCK, device=dev)
            x = torch.randn(N, P, device=dev, generator=gen)
            r = x + 0.01 * torch.randn(N, P, device=dev, generator=gen)
            W = torch.full((N, N), 1.0 / N, device=dev)
            f = (torch.rand(N, P, device=dev, generator=gen) + 0.1
                 if imp_form else None)
            g = torch.ones(N, dtype=torch.bool, device=dev)
            call = lambda: fm.fused_quant_merge_all(x, r, W, g, f, grid=grid)
            ms = device_ms(call, match=QUANT_KERNELS)
            passes = ({k: device_ms(call, match=k) for k in QUANT_PASSES}
                      if wire == "int8" else None)
            ev_ms = events_ms(call)
            host_ms = time_ms(call)
            flush = torch.empty(16 * 2 ** 20, device=dev)
            cold_ms = device_ms(lambda: (flush.zero_(), call()), iters=50,
                                match=QUANT_KERNELS)
            plain_ms = time_ms(lambda: fused_quant_merge_all_plain(
                x, r, W, g, f, grid=grid), iters=10)
            # x and r (and f) read once, committed and r' written once; the
            # quantize step (int8: |v|, max, v/s, rint, 2 clamps, q·s, the
            # sub and the add) is ~10 f32 operations per element
            nbytes = (5 if imp_form else 4) * N * P * 4 + N * N * 4 + N
            flops = (4 * N * N * P + N * P if imp_form
                     else 2 * N * N * P) + 10 * N * P
            bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
            row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                       library_ms=None, tflops=tflops(flops, ms),
                       bound_ms=max(bytes_ms, flops_ms),
                       bound_by="bytes" if bytes_ms >= flops_ms
                       else "operations")
            emit("kernel", name=form, wire=wire, shape=[N, P],
                 segments=int(grid.segments.shape[0]),
                 gathered=grid.perm is not None, kernel_ms=ms,
                 passes_ms=passes, events_ms=ev_ms, cold_l2_ms=cold_ms,
                 host_rate_ms=host_ms,
                 launch=fm.quant_launch_shape(grid, N),
                 **{k: v for k, v in row.items() if k != "ms"})
            if wire == "int8":      # the main path's wire
                stats[form] = row
    return stats


def phase_histo(dev, wire=None):
    import torch
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.core.flat import FlatLayout
    from repro_torch.experiments import histo
    from repro_torch.kernels import fused_merge as fm

    round_s = []

    class TimedSession(histo.SwarmSession):
        """Synchronized wall time of every round the experiment runs: each
        sync of the engine is followed by a device sync and a time mark."""

        def run_rounds(self, batches, val):
            sync = self.engine.sync
            marks = []

            def timed_sync(*args, **kw):
                out = sync(*args, **kw)
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
                return out

            self.engine.sync = timed_sync
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return super().run_rounds(batches, val)
            finally:
                del self.engine.sync
                round_s.extend(b - a for a, b in zip([t0] + marks, marks))

    swarm = SwarmConfig(n_nodes=4, sync_every=5, topology="full",
                        merge="fedavg", lora_only=False, val_threshold=0.8,
                        **(wire or {}))
    ecfg = histo.HistoExperimentConfig(
        n_train=512, n_test=128, image_size=PAPER_FULL.image_size,
        batch_size=16, steps=10, swarm=swarm, growth=PAPER_FULL.growth,
        stem=PAPER_FULL.stem, feat_dim=PAPER_FULL.feat_dim,
        hidden=PAPER_FULL.hidden, n_blocks=PAPER_FULL.n_blocks,
        layers_per_block=PAPER_FULL.layers_per_block)
    torch.cuda.reset_peak_memory_stats()
    plain_session = histo.SwarmSession
    histo.SwarmSession = TimedSession
    try:
        fm.reset_launches()
        t0 = time.perf_counter()
        result = histo.run_experiment(ecfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(fm.LAUNCHES)
    finally:
        histo.SwarmSession = plain_session
    print(histo.summarize(result), flush=True)
    rows = [result["centralized"], *result["local"], *result["swarm"]]
    if len(rows) != 9:
        raise AssertionError("expected 1 centralized + 4 local + 4 swarm rows")
    for rep in rows:
        vals = [rep[k] for k in ("auc", "sensitivity", "specificity", "f1",
                                 "dbi")]
        if not all(v == v and abs(v) != float("inf") for v in vals):
            raise AssertionError(f"non-finite report row {rep}")
        if not 0.0 <= rep["auc"] <= 1.0:
            raise AssertionError(f"AUC out of range {rep['auc']}")
    log = result["sync_log"]
    if len(log) != 2 or any(len(s["gates"]) != 4 for s in log):
        raise AssertionError(f"expected 2 sync rounds of 4 gates, got {log}")
    form = "fused_quant_merge_all" if wire else "fused_merge_all"
    if launches != {k: 2 if k == form else 0 for k in fm.LAUNCHES}:
        raise AssertionError(f"commit launches {launches}, want 2 {form}")
    size = FlatLayout.of_module(histo._model(ecfg)).size
    if size != P:
        raise AssertionError(f"{size} params per node, want {P}")
    emit("histo_int8" if wire else "histo", params_per_node=size,
         nodes=swarm.n_nodes, wire=swarm.wire_dtype,
         image_size=ecfg.image_size,
         gates=[s["gates"] for s in log], round_seconds=round_s,
         total_seconds=seconds,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches)
    return launches


def _session(dev, cfg, ecfg, shards):
    """A SwarmSession built as the experiment builds its swarm."""
    from repro_torch.core.flat import FlatLayout
    from repro_torch.experiments import histo
    from repro_torch.optim import adamw_init

    model = histo._model(ecfg)
    layout = FlatLayout.of_module(model)
    step, _ = histo._make_model_fns(ecfg, model, layout)
    flat = layout.flatten(histo._init_params(ecfg, model))
    return histo.SwarmSession(
        cfg, step, histo._make_eval_fn(cfg, model, layout), params=flat,
        opt_state=adamw_init(flat), data_sizes=[len(y) for _, y in shards],
        layout=layout, device=dev)


def _round_data(ecfg, shards, rounds, t):
    import torch
    from repro_torch.experiments import histo
    vals, trains = [], []
    for x, y in shards:
        n_val = max(8, int(len(y) * ecfg.val_frac))
        vals.append((x[:n_val], y[:n_val]))
        trains.append((x[n_val:], y[n_val:]))
    xs, ys = histo._batch_stream(ecfg, trains)
    xs = torch.from_numpy(xs).reshape((rounds, t) + xs.shape[1:])
    ys = torch.from_numpy(ys.astype("int64")).reshape((rounds, t)
                                                      + ys.shape[1:])
    return xs, ys, histo._stack_vals(vals)


def phase_fisher(dev, wire=None):
    import torch
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.data import make_histo_dataset, paper_splits, shard_to_nodes
    from repro_torch.experiments import histo
    from repro_torch.kernels import fused_merge as fm

    cfg = SwarmConfig(n_nodes=4, sync_every=5, topology="ring",
                      merge="fisher", lora_only=False, val_threshold=0.8,
                      **(wire or {}))
    ecfg = histo.HistoExperimentConfig(
        n_train=256, image_size=224, batch_size=16, steps=10, swarm=cfg,
        growth=PAPER_FULL.growth, stem=PAPER_FULL.stem,
        feat_dim=PAPER_FULL.feat_dim, hidden=PAPER_FULL.hidden)
    x, y = make_histo_dataset(ecfg.n_train, size=224, noise=ecfg.noise,
                              class_probs=ecfg.class_probs, seed=1)
    shards = shard_to_nodes(x, y, paper_splits(ecfg.n_train), seed=1)
    xs, ys, val = _round_data(ecfg, shards, 2, 5)
    xs, ys = xs.to(dev), ys.to(dev)
    val = tuple(torch.from_numpy(v).to(dev) for v in val)
    sess = _session(dev, cfg, ecfg, shards)
    fm.reset_launches()
    round_s, gates = [], []
    for r in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = sess.round((xs[r], ys[r]), val)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        gates.append(log["gates"].tolist())
    launches = dict(fm.LAUNCHES)
    form = "fused_quant_merge_all_imp" if wire else "fused_merge_all_imp"
    if launches != {k: 2 if k == form else 0 for k in fm.LAUNCHES}:
        raise AssertionError(f"commit launches {launches}, want 2 {form}")
    if not bool(torch.isfinite(sess.state.params).all()):
        raise AssertionError("non-finite params after the fisher rounds")
    emit("fisher_int8" if wire else "fisher", gates=gates,
         round_seconds=round_s, launches=launches)
    phase_profile(sess, (xs[1], ys[1]), val, "fisher_int8" if wire
                  else "fisher")
    return launches, (sess, cfg, ecfg, shards, (xs[0], ys[0]), val)


def phase_profile(sess, batch, val, path):
    """One more round under ``torch.profiler``: device time by kernel, the
    device's busy share of the round's wall time, the commit kernel's time
    and that of the scatter/gather/index kernels (on the int8 wire, the
    per-block max-abs and scale gathers of ``comms.wire_effective``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sess.round(batch, val)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((us, evt.count, evt.key[:90]))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels) / 1e6
    def ms_of(*words):
        return sum(us for us, _, k in kernels
                   if any(w in k for w in words)) / 1e3

    emit("profile", path=path, round_wall_s=wall, device_busy_s=busy,
         device_busy_share=busy / wall,
         commit_kernel_ms=ms_of("merge_all_kernel", "quant_merge_kernel"),
         lora_kernel_ms=ms_of("lora_kernel"),
         lora_kernel_calls=sum(c for _, c, k in kernels
                               if "lora_kernel" in k),
         scatter_gather_ms=ms_of("scatter", "gather", "index"),
         top=[{"kernel": k, "ms": us / 1e3, "calls": c}
              for us, c, k in kernels[:12]])


def phase_checkpoint(dev, run):
    """Save the int8 fisher session at paper width, restore it into a fresh
    session, run one more round on both, and hold them equal bit for bit
    (params, AdamW moments, statistics, wire reference, counters, rng)."""
    import os
    import tempfile

    import torch

    sess, cfg, ecfg, shards, batch, val = run
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "swarm.msgpack")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.save(path)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            fresh = _session(dev, cfg, ecfg, shards)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh.load(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        a, b = sess.state, fresh.state
        for field in ("params", "stats", "wire", "active"):
            if not torch.equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"restored {field} differs")
        sess.round(batch, val)
        fresh.round(batch, val)
        torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    a, b = sess.state, fresh.state
    same = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
            for f in ("params", "stats", "wire", "active")}
    same.update({f"opt_{k}": bool(torch.equal(a.opt_state[k], b.opt_state[k]))
                 for k in a.opt_state})
    same["counters"] = ((a.round, a.step, a.rng.tolist())
                        == (b.round, b.step, b.rng.tolist()))
    emit("checkpoint", bytes=size, save_seconds=save_s,
         load_seconds=load_s, round=b.round, bit_identical=same)
    if not all(same.values()):
        raise AssertionError(f"resumed session diverged: {same}")


def phase_parity(dev):
    """One small fedavg round and one fisher/ring round on the card against
    the same rounds on the CPU, with cuDNN TF32 off for the comparison."""
    import torch
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.data import make_histo_dataset, paper_splits, shard_to_nodes
    from repro_torch.experiments import histo

    ecfg = histo.HistoExperimentConfig(
        n_train=160, image_size=16, batch_size=8, steps=3, growth=4, stem=8,
        feat_dim=32, hidden=16, n_blocks=1, layers_per_block=2)
    x, y = make_histo_dataset(ecfg.n_train, size=16, noise=0.6, seed=0)
    shards = shard_to_nodes(x, y, paper_splits(ecfg.n_train), seed=0)
    xs, ys, val = _round_data(ecfg, shards, 1, 3)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for merge, topology in (("fedavg", "full"), ("fisher", "ring")):
            cfg = SwarmConfig(n_nodes=4, sync_every=3, topology=topology,
                              merge=merge, lora_only=False, val_threshold=0.8)
            res = {}
            for d in (dev, "cpu"):
                sess = _session(d, cfg, ecfg, shards)
                log = sess.round((xs[0], ys[0]), val)
                res[d] = (sess.state.params.cpu(), log["gates"].cpu())
            err = float((res[dev][0] - res["cpu"][0]).abs().max())
            if err > 1e-4 or not torch.equal(res[dev][1], res["cpu"][1]):
                raise AssertionError(f"{merge}: card vs CPU params err {err}, "
                                     f"gates {res[dev][1]} vs {res['cpu'][1]}")
            out[merge] = err
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    emit("parity", max_abs_err=out)


# the fault phase's plan at N = 4: rounds, local steps a round, the corrupt
# sync and its sender
FAULT_ROUNDS, FAULT_T, CORRUPT_ROUND, CORRUPT_NODE = 7, 2, 5, 2


def _fault_plan(preempt=True):
    from repro_torch.faults import FaultPlan
    plan = (FaultPlan(N, FAULT_ROUNDS, seed=7)
            .crash(1, at=1, rejoin=3)
            .straggle(3, at=3)
            .drop(0, at=4)
            .corrupt(CORRUPT_NODE, at=CORRUPT_ROUND))
    return plan.preempt(at=6) if preempt else plan


def _true_fisher_step(ecfg, model, layout):
    """The protocol's train step (`experiments.histo`) returning its
    gradient as a 4th output: the true-Fisher hook's 4-tuple."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.cnn import bce_loss, forward_cnn, one_hot
    from repro_torch.optim import adamw_update_, make_schedule

    tc = TrainConfig(lr=ecfg.lr, warmup_steps=20, max_steps=ecfg.steps,
                     weight_decay=1e-4, schedule="cosine")
    sched = make_schedule(tc)

    def loss(flat, x, y):
        return bce_loss(forward_cnn(model, layout.unflatten(flat), x),
                        one_hot(y, 3))

    def step(params, opt_state, batch, s):
        x, y = batch
        g, l = torch.func.grad_and_value(loss)(params, x, y)
        params, opt_state = adamw_update_(params, g, opt_state, tc,
                                          sched(opt_state["count"]))
        return params, opt_state, {"loss": l}, g

    return step


def phase_faults(dev, smi):
    """The fault plane on the int8 wire at paper width: ``run_plan`` over a
    7-round plan (crash + rejoin, straggle, drop, a corrupt sender, a
    preempt), checked against the plan and against a twin without the
    preempt, bit for bit; then the sync's time with idle and armed signals
    beside a plain one, and two rounds of a true-Fisher session. ``smi``:
    the card's name and power limit, printed beside the times."""
    import os
    import tempfile

    import torch
    from repro_torch.configs.base import SwarmConfig
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.core import comms
    from repro_torch.core.flat import FlatLayout
    from repro_torch.data import make_histo_dataset, paper_splits, shard_to_nodes
    from repro_torch.experiments import histo
    from repro_torch.faults import flip_payload_bits, idle_signals, run_plan
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.optim import adamw_init

    cfg = SwarmConfig(n_nodes=N, sync_every=FAULT_T, topology="full",
                      merge="fedavg", lora_only=False, val_threshold=0.8,
                      wire_dtype="int8", wire_block=WIRE_BLOCK, quorum=2)
    ecfg = histo.HistoExperimentConfig(
        n_train=256, image_size=PAPER_FULL.image_size, batch_size=16,
        steps=FAULT_ROUNDS * FAULT_T, swarm=cfg, growth=PAPER_FULL.growth,
        stem=PAPER_FULL.stem, feat_dim=PAPER_FULL.feat_dim,
        hidden=PAPER_FULL.hidden, n_blocks=PAPER_FULL.n_blocks,
        layers_per_block=PAPER_FULL.layers_per_block)
    x, y = make_histo_dataset(ecfg.n_train, size=ecfg.image_size,
                              noise=ecfg.noise, class_probs=ecfg.class_probs,
                              seed=2)
    shards = shard_to_nodes(x, y, paper_splits(ecfg.n_train), seed=2)
    xs, ys, val = _round_data(ecfg, shards, FAULT_ROUNDS, FAULT_T)
    xs, ys = xs.to(dev), ys.to(dev)
    val = tuple(torch.from_numpy(v).to(dev) for v in val)
    layout = FlatLayout.of_module(histo._model(ecfg))
    if layout.size != P:
        raise AssertionError(f"{layout.size} params per node, want {P}")

    def batches(r):
        return xs[r], ys[r]

    def make():
        return _session(dev, cfg, ecfg, shards)

    # the preempt's twin must replay the rounds bit for bit
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # the plan, the corrupt round's sync watched (its inputs and
            # its committed params)
            first = make()
            sync, armed = first.engine.sync, {}

            def watched_sync(params, val, active=None, stats=None,
                             wire=None, faults=None):
                corrupt = faults is not None and bool(faults.corrupt.any())
                if corrupt:
                    # the sync's inputs as it sees them: the session
                    # writes the commit back into its own params buffer
                    armed.update(args=_clone((params, val, active, stats,
                                              wire)), faults=faults)
                out = sync(params, val, active, stats=stats, wire=wire,
                           faults=faults)
                if corrupt:
                    armed["committed"] = out[0].clone()
                return out

            first.engine.sync = watched_sync
            marks = []
            fm.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess, logs = run_plan(
                first, _fault_plan(), batches, val, make_session=make,
                checkpoint_path=os.path.join(tmp, "preempt.msgpack"),
                on_round=lambda r, lg: marks.append(time.perf_counter()))
            torch.cuda.synchronize()
            plan_s = time.perf_counter() - t0
            launches = dict(fm.LAUNCHES)
            del first.engine.sync
            # the twin: the same plan without the preempt
            twin, twin_logs = run_plan(make(), _fault_plan(preempt=False),
                                       batches, val)
            torch.cuda.synchronize()
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    round_s = [b - a for a, b in zip([t0] + marks, marks)]
    if launches != {k: FAULT_ROUNDS if k == "fused_quant_merge_all" else 0
                    for k in fm.LAUNCHES}:
        raise AssertionError(f"commit launches {launches}, want "
                             f"{FAULT_ROUNDS} fused_quant_merge_all")
    lowered = _fault_plan().lower()
    for lg in logs:
        r = lg["round"]
        if lg["gates"][~lg["active"]].any():
            raise AssertionError(f"round {r}: an inactive node's gate is on "
                                 f"{lg['gates']} {lg['active']}")
        if not (lg["wire_ok"] == ~lowered.corrupt[r]).all():
            raise AssertionError(f"round {r}: wire_ok {lg['wire_ok']}, want "
                                 f"{~lowered.corrupt[r]}")
    if sum(lg["preempted"] for lg in logs) != 1:
        raise AssertionError("the plan's preempt never ran")
    # the quarantined sender kept its own pre-sync params, bit for bit
    params, val_r, active, stats, wire = armed["args"]
    if not torch.equal(armed["committed"][CORRUPT_NODE],
                       params[CORRUPT_NODE]):
        raise AssertionError("the corrupt sender's row changed in its sync")
    # the round's flip pattern on the card equals the same call on the CPU
    sig = armed["faults"]
    eff = comms.wire_effective(params, wire, first.engine._wire_grid(params))
    card = flip_payload_bits(eff, sig.corrupt, sig.key, layout)
    host = flip_payload_bits(eff.cpu(), sig.corrupt, sig.key, layout)
    if not torch.equal(card.cpu().view(torch.int32), host.view(torch.int32)):
        raise AssertionError("the flip pattern on the card differs from "
                             "the CPU's")
    flipped = (card != eff).sum(1).tolist()
    if [i for i, c in enumerate(flipped) if c] != [CORRUPT_NODE]:
        raise AssertionError(f"flips by row {flipped}")
    # the preempted run equals the uninterrupted twin, bit for bit
    a, b = sess.state, twin.state
    same = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
            for f in ("params", "wire", "active")}
    same.update({f"opt_{k}": bool(torch.equal(a.opt_state[k],
                                              b.opt_state[k]))
                 for k in a.opt_state})
    same["counters"] = ((a.round, a.step, a.rng.tolist())
                        == (b.round, b.step, b.rng.tolist()))
    same["gates"] = all((la["gates"] == lb["gates"]).all()
                        for la, lb in zip(logs, twin_logs))
    if not all(same.values()):
        raise AssertionError(f"the preempted run diverged from its twin: "
                             f"{same}")

    # the sync's wall time (synchronized host clock): plain, with idle
    # signals, armed — in turns, the order reversed every other repeat
    eng = first.engine
    calls = {
        "plain": lambda: eng.sync(params, val_r, active, stats=stats,
                                  wire=wire),
        "idle": lambda: eng.sync(params, val_r, active, stats=stats,
                                 wire=wire, faults=idle_signals(N)),
        "armed": lambda: eng.sync(params, val_r, active, stats=stats,
                                  wire=wire, faults=sig)}
    for _ in range(2):
        for fn in calls.values():
            fn()
    sync_s = {k: [] for k in calls}
    for rep in range(7):
        for k in (list(calls) if rep % 2 == 0 else list(calls)[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            calls[k]()
            torch.cuda.synchronize()
            sync_s[k].append(time.perf_counter() - t)
    # device time of the fault plane's own work in a sync: one checksum of
    # θ̂' (an idle sync takes two), one armed flip; and the one-off index
    ref = eng._ref_index(params)
    ops_ms = {
        "checksum": device_ms(lambda: comms.payload_checksum(eff, ref),
                              iters=20),
        "flip": device_ms(lambda: flip_payload_bits(eff, sig.corrupt,
                                                    sig.key, ref), iters=20),
        "ref_index": device_ms(lambda: comms.ref_index(layout, dev),
                               iters=5)}

    # true Fisher: a fisher/ring session whose train step returns its
    # gradient; every commit is one launch of the quantized imp form
    fcfg = SwarmConfig(n_nodes=N, sync_every=FAULT_T, topology="ring",
                       merge="fisher", lora_only=False, val_threshold=0.8,
                       wire_dtype="int8", wire_block=WIRE_BLOCK)
    model = histo._model(ecfg)
    flat = layout.flatten(histo._init_params(ecfg, model))
    fsess = histo.SwarmSession(
        fcfg, _true_fisher_step(ecfg, model, layout),
        histo._make_eval_fn(fcfg, model, layout), params=flat,
        opt_state=adamw_init(flat), data_sizes=[len(y) for _, y in shards],
        layout=layout, device=dev)
    fm.reset_launches()
    fisher_gates = [fsess.round(batches(r), val)["gates"].tolist()
                    for r in range(2)]
    fisher_launches = dict(fm.LAUNCHES)
    if fisher_launches != {k: 2 if k == "fused_quant_merge_all_imp" else 0
                           for k in fm.LAUNCHES}:
        raise AssertionError(f"true-Fisher commit launches {fisher_launches}")
    st = fsess.state.stats
    if not bool(torch.isfinite(st).all()) or not bool((st != 0).any()):
        raise AssertionError("true-Fisher stats not finite and non-zero")

    emit("faults", card=smi, plan=[[e.kind, e.node, e.round, e.until]
                         for e in _fault_plan().events],
         nodes=N, params_per_node=P, wire="int8", quorum=cfg.quorum,
         steps_per_round=FAULT_T,
         active=[lg["active"].tolist() for lg in logs],
         gates=[lg["gates"].tolist() for lg in logs],
         wire_ok=[lg["wire_ok"].tolist() for lg in logs],
         flips_by_node=flipped, round_seconds=round_s, plan_seconds=plan_s,
         sync_seconds={k: dict(median=sorted(v)[len(v) // 2], min=min(v),
                               all=v) for k, v in sync_s.items()},
         fault_ops_ms=ops_ms, preempt_bit_identical=same, launches=launches,
         true_fisher=dict(gates=fisher_gates, launches=fisher_launches,
                          stats_mean=float(st.mean()),
                          stats_max=float(st.max())))
    return {k: v + fisher_launches[k] for k, v in launches.items()}


# (M, K, N, r, dtype name): the zoo head's train, validation and test
# shapes, the reference's sweep shapes (tests/test_kernels.py), ragged ones
LORA_SHAPES = ((8, 16, 16, 4, "float32"), (24, 16, 16, 4, "float32"),
               (160, 16, 16, 4, "float32"), (128, 256, 128, 8, "float32"),
               (256, 512, 384, 16, "float32"),
               (128, 1024, 256, 64, "float32"),
               (256, 256, 256, 16, "bfloat16"), (37, 70, 45, 3, "float32"),
               (33, 65, 31, 128, "float32"), (37, 70, 45, 5, "bfloat16"))
LORA_ZOO = (8, 16, 16, 4)
LORA_SWEEP = (128, 1024, 256, 64)


def _lora_inputs(dev, gen, m, k, n, r, dtype):
    import torch
    dt = getattr(torch, dtype)

    def t(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen)
                * scale).to(dt)

    return (t(m, k), t(k, n, scale=k ** -0.5), t(k, r, scale=k ** -0.5),
            t(r, n, scale=r ** -0.5),
            torch.tensor(1.5, dtype=torch.float32, device=dev))


def _lora_bound(m, k, n, r, bw, peak, itemsize=4):
    """(bound_ms, bound_by): each input read once (and the f32 scale), the
    output written once; 2·M·N·K + 2·M·K·r + 2·M·r·N f32 operations."""
    nbytes = (m * k + k * n + k * r + r * n + m * n) * itemsize + 4
    flops = 2 * m * n * k + 2 * m * k * r + 2 * m * r * n
    bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations")


def phase_lora_kernel(dev, bw, peak):
    """The fused LoRA matmul against its plain version on the card, its
    gradient, and its times beside the plain version, the unfused cuBLAS
    form and the bound."""
    import torch
    from repro_torch.kernels import lora_matmul as lm
    from repro_torch.kernels.ref import lora_matmul_plain

    gen = torch.Generator(device=dev).manual_seed(2)
    max_err = 0.0
    for m, k, n, r, dtype in LORA_SHAPES:
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        x, w, a, b, s = _lora_inputs(dev, gen, m, k, n, r, dtype)
        for bb, want in ((b, lora_matmul_plain(x, w, a, b, s)),
                         (torch.zeros_like(b),
                          (x.float() @ w.float()).to(x.dtype))):
            got = lm.lora_matmul(x, w, a, bb, s)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if bool((err > tol + tol * want.float().abs()).any()):
                raise AssertionError(f"lora_matmul {(m, k, n, r, dtype)}: "
                                     f"max err {float(err.max())}")
            if dtype == "float32":
                max_err = max(max_err, float(err.max()))
    # the autograd Function (kernel forward) against autograd through the
    # plain version, at the zoo's train shape with a live low-rank path
    x, w, a, b, s = _lora_inputs(dev, gen, *LORA_ZOO, "float32")
    gy = torch.randn(LORA_ZOO[0], LORA_ZOO[2], device=dev, generator=gen)

    def grads(fn):
        return torch.func.grad(lambda *v: (fn(*v) * gy).sum(),
                               argnums=(0, 1, 2, 3, 4))(x, w, a, b, s)

    before = lm.LAUNCHES["lora_matmul"]
    got = grads(lm.lora_apply)
    if lm.LAUNCHES["lora_matmul"] != before + 1:
        raise AssertionError("the gradient's forward did not launch the "
                             "kernel")
    want = grads(lora_matmul_plain)
    grad_err = {}
    for name, g, h in zip(("x", "w", "a", "b", "scale"), got, want):
        if not torch.allclose(g, h, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"lora grad {name}: max err "
                                 f"{float((g - h).abs().max())}")
        grad_err[name] = float((g - h).abs().max())

    # device time per call (profiler) and, beside it, the host clock's
    # time per call of back-to-back calls (CUDA events)
    out = {}
    for label, (m, k, n, r) in (("zoo", LORA_ZOO), ("sweep", LORA_SWEEP)):
        x, w, a, b, s = _lora_inputs(dev, gen, m, k, n, r, "float32")
        fns = {"kernel": lambda: lm.lora_matmul(x, w, a, b, s),
               "plain": lambda: lora_matmul_plain(x, w, a, b, s),
               "unfused_cublas": lambda: torch.addmm(x @ w, x @ a, b,
                                                     alpha=1.5)}
        bound_ms, bound_by = _lora_bound(m, k, n, r, bw, peak)
        out[label] = dict(shape=[m, k, n, r], bound_ms=bound_ms,
                          bound_by=bound_by)
        for name, fn in fns.items():
            out[label][f"{name}_ms"] = device_ms(fn)
            out[label][f"{name}_host_ms"] = time_ms(fn)
    # the device time of a one-element kernel: what a launch costs at least
    one = torch.empty(1, device=dev)
    floor_ms = device_ms(one.zero_)
    emit("lora_kernel", shapes=[list(t) for t in LORA_SHAPES],
         max_abs_err_f32=max_err, grad_max_abs_err=grad_err,
         launch_floor_ms=floor_ms, timings=out,
         tolerance={"float32": 2e-5, "bfloat16": 2e-2, "grad": 1e-5})
    zoo = out["zoo"]
    m, k, n, r = LORA_ZOO
    return {"lora_matmul": dict(
        max_abs_err=max_err, ms=zoo["kernel_ms"], plain_ms=zoo["plain_ms"],
        library_ms=None, tflops=tflops(2 * m * n * k + 2 * m * k * r
                                       + 2 * m * r * n, zoo["kernel_ms"]),
        bound_ms=zoo["bound_ms"],
        bound_by=zoo["bound_by"])}


ROW_KEYS = {"scenario", "partition", "families", "shard_sizes", "n_synth",
            "schedule", "payload_class", "payload_params",
            "wire_bytes_per_sync", "full_f32_bytes_per_sync", "retraces",
            "rounds", "per_site", "site_auc_spread",
            "site_sensitivity_spread", "worst_site_auc", "oracle",
            "oracle_gap_auc", "gates_last", "wire_fraction_of_full",
            "fairness_ok_last", "worst_site_gate_metric"}


def phase_hetero(dev):
    """``run_scenario`` over the five cells at the defaults, with the
    launch counts set to 0 just before each cell and read just after."""
    import math

    import torch
    from repro_torch.experiments import scenarios
    from repro_torch.kernels import LAUNCHES, reset_launches

    rcfg = scenarios.ScenarioRunConfig()
    rounds = rcfg.steps // rcfg.swarm.sync_every
    total = {}
    cells = []
    for scn in scenarios.scenario_grid():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = scenarios.run_scenario(scn, rcfg, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        want = {k: 0 for k in LAUNCHES}
        want.update(fused_quant_merge_all=rounds,
                    lora_matmul=launches["lora_matmul"])
        if launches["lora_matmul"] < 1 or launches != want:
            raise AssertionError(f"{scn.name}: launches {launches}, want "
                                 f"{rounds} quantized commits, the LoRA "
                                 "kernel, nothing else")
        if set(row) != ROW_KEYS:
            raise AssertionError(f"{scn.name}: row keys "
                                 f"{sorted(set(row) ^ ROW_KEYS)} differ")
        aucs = [r["auc"] for r in row["per_site"]]
        if row["payload_params"] != 180 or row["rounds"] != rounds:
            raise AssertionError(f"{scn.name}: payload "
                                 f"{row['payload_params']}, rounds "
                                 f"{row['rounds']}")
        if not row["wire_fraction_of_full"] <= 0.05:
            raise AssertionError(f"{scn.name}: wire fraction "
                                 f"{row['wire_fraction_of_full']}")
        if not all(math.isfinite(v) and 0.0 <= v <= 1.0
                   for v in aucs + [row["oracle"]["auc"]]):
            raise AssertionError(f"{scn.name}: per-site AUCs {aucs}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        cells.append(dict(scenario=scn.name, seconds=seconds,
                          launches={k: v for k, v in launches.items() if v},
                          site_auc=aucs, oracle_auc=row["oracle"]["auc"],
                          gates_last=row["gates_last"],
                          wire_fraction_of_full=row["wire_fraction_of_full"],
                          wire_bytes_per_sync=row["wire_bytes_per_sync"],
                          shard_sizes=row["shard_sizes"]))
    emit("hetero", nodes=rcfg.n_nodes, steps=rcfg.steps, rounds=rounds,
         payload_params=180, cells=cells,
         total_seconds=sum(c["seconds"] for c in cells), launches=total)

    # one profiled zoo round (the iid cell's session, first round)
    cell = scenarios.prepare(scenarios.scenario_grid()[0], rcfg, device=dev)
    t = rcfg.swarm.sync_every
    cell.session.round((cell.xs[:t], cell.ys[:t]), cell.val)
    phase_profile(cell.session, (cell.xs[t:2 * t], cell.ys[t:2 * t]),
                  cell.val, "hetero")
    return total


def phase_hetero_parity(dev):
    """One zoo round of the paper-split cell on the card against the same
    round on the CPU (plain kernels, CPU convs), cuDNN TF32 off."""
    import torch
    from repro_torch.experiments import scenarios

    rcfg = scenarios.ScenarioRunConfig()
    scn = scenarios.scenario_grid()[1]
    t = rcfg.swarm.sync_every
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        res = {}
        for d in (dev, "cpu"):
            cell = scenarios.prepare(scn, rcfg, device=d)
            log = cell.session.round((cell.xs[:t], cell.ys[:t]), cell.val)
            res[d] = (cell.session.state.params.cpu(), log["gates"].cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((res[dev][0] - res["cpu"][0]).abs().max())
    if err > 1e-4 or not torch.equal(res[dev][1], res["cpu"][1]):
        raise AssertionError(f"zoo round: card vs CPU payload err {err}, "
                             f"gates {res[dev][1]} vs {res['cpu'][1]}")
    emit("hetero_parity", scenario=scn.name, max_abs_err=err,
         gates=res[dev][1].tolist())


# (B, H, Hkv, S, T, D, causal, window, dtype name): the reference's flash
# sweep (tests/test_kernels.py), its bf16 case, a ragged and a strided case
FLASH_SWEEP = ((1, 4, 4, 128, 128, 64, True, 0, "float32"),
               (2, 4, 2, 256, 256, 64, True, 0, "float32"),
               (1, 8, 2, 256, 256, 64, True, 64, "float32"),
               (1, 4, 1, 128, 128, 128, True, 0, "float32"),
               (2, 2, 2, 128, 128, 64, False, 0, "float32"),
               (1, 2, 2, 128, 128, 64, True, 0, "bfloat16"),
               (2, 6, 3, 77, 90, 32, True, 20, "float32"))
# the families phase's flash shapes at full width (name, B, H, Hkv, S, T,
# causal; D = 64, bf16): granite-moe's engine prefills (a GQA group of 3,
# one node's prompt of 2048 or 256 in a 2064-deep lane), internvl2's
# prefill of 256 patches + 1,792 tokens at batch 4 (a group of 7, the same
# depth), seamless's bidirectional encoder (batch 4, 1024 frames),
# minicpm-2b's engine prefills (36 heads, a group of 1) and its training
# step (batch 4 at 256 tokens, no cache); granite-moe's split step of part
# (g) (a data rank's 4 rows at 256 tokens, no cache) and its gate's score
# (GOSSIP_G_VAL's 2 rows), whole (one model rank) and head-parallel over 2
# model ranks (12 of 24 heads, 4 of 8 KV heads); seamless's calls in part
# (i) (2 rows of 1,024 frames and 256 tokens, its step's and its gate's
# alike), head-parallel over 2 model ranks (8 of 16 heads) and in the
# unsharded twin: the encoder's unmasked self-attention, the decoder's
# cross-attention over the encoder output and its causal self-attention;
# granite-moe's head-parallel prefills of part (j) (2 rows of 256 tokens,
# the residual cut, and of 255, the residual whole; a model rank's 12
# heads over its 4 KV heads of its own K/V); seamless's odd step after
# part (i)'s round (2 rows of 1,023 frames and 255 tokens, both stacks in
# the whole-residual form, a model rank's 8 heads): its encoder, its
# decoder's cross-attention over the 1,023 frames and its causal
# self-attention (part (k)'s encode of 1,024 frames is seamless_tp_enc's
# shape)
FAMILY_FLASH = (("granite", 1, 24, 8, 2048, 2064, True),
                ("granite_256", 1, 24, 8, 256, 2064, True),
                ("granite_train", 4, 24, 8, 256, 256, True),
                ("granite_gate", 2, 24, 8, 256, 256, True),
                ("granite_tp_train", 4, 12, 4, 256, 256, True),
                ("granite_tp_gate", 2, 12, 4, 256, 256, True),
                ("internvl2", 4, 14, 2, 2048, 2064, True),
                ("seamless", 4, 16, 16, 1024, 1024, False),
                ("minicpm", 1, 36, 36, 2048, 2064, True),
                ("minicpm_256", 1, 36, 36, 256, 2064, True),
                ("minicpm_train", 4, 36, 36, 256, 256, True),
                ("seamless_tp_enc", 2, 8, 8, 1024, 1024, False),
                ("seamless_tp_cross", 2, 8, 8, 256, 1024, False),
                ("seamless_tp_dec", 2, 8, 8, 256, 256, True),
                ("seamless_twin_enc", 2, 16, 16, 1024, 1024, False),
                ("seamless_twin_cross", 2, 16, 16, 256, 1024, False),
                ("seamless_twin_dec", 2, 16, 16, 256, 256, True),
                ("granite_j_tp", 2, 12, 4, 256, 256, True),
                ("granite_j_tp_odd", 2, 12, 4, 255, 255, True),
                ("seamless_odd_enc", 2, 8, 8, 1023, 1023, False),
                ("seamless_odd_cross", 2, 8, 8, 255, 1023, False),
                ("seamless_odd_dec", 2, 8, 8, 255, 255, True))
# flash's bf16 D = 128 body (csrc/flash_attention.cu: kWG = 2,
# hop::launch<128>) at the attention shapes of nemotron-4-15b (48 heads
# over 8 KV heads, a GQA group of 6) and deepseek-coder-33b (56 over 8, a
# group of 7): one causal prefill of 2048 tokens, (name, B, H, Hkv, S, T,
# K/V strided); S = T with contiguous K/V, then as the served paths give
# them: q a strided view of [B, S, H, 128], K/V strided views of a
# [B, 2064, 8, 128] cache (2064 = 32 key tiles of 64 and 16 more),
# nemotron's engine prefills of 2048 and 256 tokens at batch 1 and
# deepseek's generate at batch 4
WIDE_FLASH = (("nemotron-4-15b", 1, 48, 8, 2048, 2048, False),
              ("deepseek-coder-33b", 1, 56, 8, 2048, 2048, False),
              ("nemotron-4-15b_served", 1, 48, 8, 2048, 2064, True),
              ("nemotron-4-15b_served_256", 1, 48, 8, 256, 2064, True),
              ("deepseek-coder-33b_served", 4, 56, 8, 2048, 2064, True))
# flash's D = 16 bodies (f32::launch<16>, hop::launch<16>: the 32-byte
# swizzle, m64n16k16 for P·V), each in f32 and bf16: (name, B, H, Hkv, S,
# T, causal, window). The engine example's model (d_model 64 over 4 heads,
# 2 KV heads; examples/torch_engine_swarm.py) at its training and gate
# shape, the 4 nodes' batches of 8 folded into the batch axis; a long
# causal prompt with windows 0 and 64; a bidirectional call; GQA 2:1...3:1
# with a ragged T and a window
D16_FLASH = (("engine", 32, 4, 2, 32, 32, True, 0),
             ("long", 1, 4, 2, 2048, 2048, True, 0),
             ("long_w64", 1, 4, 2, 2048, 2048, True, 64),
             ("noncausal", 2, 4, 2, 256, 256, False, 0),
             ("ragged", 2, 6, 3, 77, 90, True, 20))
# flash's query-offset form (a sequence-parallel rank's S query rows at
# positions q_off.. over the whole T keys), (name, B, H, Hkv, S, T, D,
# q_off, window, dtype): part (h)'s Hymba-1.5B shapes (2 rows of 2048
# tokens over 2 model ranks: 1024 rows a rank at q_off 0 and 1024, the
# global layer's window 0 and the sliding layer's 1024), then one D = 16
# and one D = 128 shape in each dtype, then the whole-sequence calls of
# (h)'s unsharded twin (q_off 0: 2 rows of 2048 over the same 2048 keys),
# then part (j)'s served prefills: 2 rows of 256 tokens, 128 rows a rank
# at q_off 0 and 128 over the prompt's 256 keys, and the prompt of 255
# the model group does not divide (the residual whole: every rank's 255
# rows at q_off 0), then the odd step after part (h)'s round: 2 rows of
# 2,047 tokens, the residual whole, every rank's sequence-parallel
# attention over all 25 heads and all 2,047 keys
QOFF_FLASH = tuple(("hymba_h", 2, 25, 5, 1024, 2048, 64, off, w, "bfloat16")
                   for off in (0, 1024) for w in (0, 1024)) + tuple(
    (f"d{d}", 1, 4, 2, s, 2 * s, d, s, w, dt)
    for d, s, w in ((16, 512, 0), (128, 512, 256))
    for dt in ("float32", "bfloat16")) + tuple(
    ("hymba_h_twin", 2, 25, 5, 2048, 2048, 64, 0, w, "bfloat16")
    for w in (0, 1024)) + tuple(
    ("hymba_j", 2, 25, 5, 128, 256, 64, off, w, "bfloat16")
    for off in (0, 128) for w in (0, 1024)) + tuple(
    ("hymba_j_odd", 2, 25, 5, 255, 255, 64, 0, w, "bfloat16")
    for w in (0, 1024)) + tuple(
    ("hymba_odd", 2, 25, 5, 2047, 2047, 64, 0, w, "bfloat16")
    for w in (0, 1024))
# the f32 body's limit with a query offset: one bf16 ulp does not apply;
# the D = 128 body reads 1.19e-6 at QOFF_FLASH's d128 row (and as much on
# the whole sequence's matching rows, no offset)
QOFF_F32_TOL = 1.2e-6
# flash's f32 D = 64 body as examples/torch_serve_demo.py launches it
# (name, B, H, Hkv, S, T, causal), q, K and V strided views of [B, S, H, D]
# and [B, T, Hkv, D]: the minicpm-2b and phi3.5-moe smoke prefills (8
# tokens over a 64-deep cache, GQA groups of 1 and 4), seamless's
# bidirectional encoder (16 frames) and the consensus ensemble's
# 16-token bucket over its 48-deep cache
EXAMPLE_FLASH = (("minicpm", 4, 4, 4, 8, 64, True),
                 ("phi3.5-moe", 4, 4, 1, 8, 64, True),
                 ("seamless", 4, 4, 4, 16, 16, False),
                 ("ensemble", 1, 4, 4, 16, 48, True))
# the serve phase: Hymba-1.5B, prompts of these lengths, 16 new tokens
SERVE_SEQ = (256, 2048)
SERVE_NEW = 16
SERVE_MAX_LEN = SERVE_SEQ[-1] + SERVE_NEW


def _flash_pairs(s, t, causal, window):
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return s * t
    return sum(min(i + 1, t, window or i + 1) for i in range(s))


def phase_flash_kernel(dev, bw, peak, bf16_peak):
    """The flash kernel against its plain version on the card; at Hymba's
    prefill shapes its device time beside the plain version's, one SDPA
    call's and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain

    gen = torch.Generator(device=dev).manual_seed(3)

    def inputs(b, h, hkv, s, t, d, dtype):
        dt = getattr(torch, dtype)
        return tuple(torch.randn(*shape, device=dev, generator=gen).to(dt)
                     for shape in ((b, h, s, d), (b, hkv, t, d),
                                   (b, hkv, t, d)))

    max_err = 0.0
    for b, h, hkv, s, t, d, causal, window, dtype in FLASH_SWEEP:
        tol = 3e-2 if dtype == "bfloat16" else 2e-5
        q, k, v = inputs(b, h, hkv, s, t, d, dtype)
        # K/V as a [B, T, Hkv, D] cache seen through a transpose (no copy)
        ks = k.transpose(1, 2).contiguous().transpose(1, 2)
        vs = v.transpose(1, 2).contiguous().transpose(1, 2)
        got = fa.flash_attention(q, ks, vs, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if bool((err > tol + tol * want.float().abs()).any()):
            raise AssertionError(f"flash {(b, h, hkv, s, t, d, causal, window, dtype)}: "
                                 f"max err {float(err.max())}")
        if dtype == "float32":
            max_err = max(max_err, float(err.max()))
    for name, b, h, hkv, s, t, causal in EXAMPLE_FLASH:
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in inputs(b, h, hkv, s, t, 64, "float32"))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got - want).abs()
        if bool((err > 2e-5 + 2e-5 * want.abs()).any()):
            raise AssertionError(f"flash at the serve example's {name} "
                                 f"shape: max err {float(err.max())}")
        max_err = max(max_err, float(err.max()))
    out = {}
    # at Hymba's shapes both sides work in f32 on the same bf16 inputs and
    # round once to bf16, so they may differ by one bf16 ulp (2^-7 of the
    # value) where the f32 sums straddle a rounding boundary
    atol, rtol = 2e-4, 8e-3
    h, hkv, d, t = 25, 5, 64, SERVE_MAX_LEN
    for s in SERVE_SEQ:
        q, k, v = inputs(1, h, hkv, s, t, d, "bfloat16")
        for window in (0, 1024):
            got = fa.flash_attention(q, k, v, window=window)
            want = flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if bool((err > atol + rtol * want.float().abs()).any()):
                raise AssertionError(f"flash at Hymba's shape, S {s}, window "
                                     f"{window}: max err {float(err.max())}")
            qpos = torch.arange(s, device=dev)[:, None]
            kpos = torch.arange(t, device=dev)[None, :]
            mask = kpos <= qpos
            if window:
                mask = mask & (kpos > qpos - window)
            row = dict(s=s, window=window, max_abs_err_bf16=float(err.max()),
                       kernel_ms=device_ms(lambda: fa.flash_attention(
                           q, k, v, window=window), iters=20, warm=3),
                       # the clock device_ms falls back to, on the same calls
                       kernel_events_ms=events_ms(lambda: fa.flash_attention(
                           q, k, v, window=window), iters=20),
                       plain_ms=device_ms(lambda: flash_attention_plain(
                           q, k, v, window=window), iters=5, warm=2))
            try:
                row["library_ms"] = device_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True),
                    iters=20, warm=3)
            except RuntimeError as exc:  # the yardstick only, never the port
                row["library_ms"], row["library_error"] = None, str(exc)[:200]
            if not window:
                # is_causal with no mask: aligned top-left, so for T >= S
                # the same mask as the boolean one (SDPA's causal kernels)
                try:
                    row["library_causal_ms"] = device_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True),
                        iters=20, warm=3)
                except RuntimeError as exc:
                    row["library_causal_ms"] = None
                    row["library_causal_error"] = str(exc)[:200]
            pairs = _flash_pairs(s, t, True, window)
            nbytes = 2 * (2 * h * s * d + 2 * hkv * t * d)
            row["gflop"] = 4 * h * d * pairs / 1e9
            row["tflops"] = tflops(4 * h * d * pairs, row["kernel_ms"])
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, 4 * h * d * pairs, bw, bf16_peak)
            out[(s, window)] = row
    families = {}
    for name, fb, fh, fhkv, fs, ft, causal in FAMILY_FLASH:
        q, k, v = inputs(fb, fh, fhkv, fs, ft, d, "bfloat16")
        # as the path gives them: q [B, S, H, D] and K/V [B, T, Hkv, D]
        # (the cache, the encoder's or the training step's projection)
        # seen through a transpose
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if bool((err > atol + rtol * want.float().abs()).any()):
            raise AssertionError(f"flash at {name}'s shape: max err "
                                 f"{float(err.max())}")
        flops = 4 * fh * d * fb * _flash_pairs(fs, ft, causal, 0)
        row = dict(q=[fb, fh, fs, d], kv=[fb, fhkv, ft, d], causal=causal,
                   max_abs_err_bf16=float(err.max()),
                   kernel_ms=device_ms(lambda: fa.flash_attention(
                       q, k, v, causal=causal), iters=20, warm=3),
                   plain_ms=device_ms(lambda: flash_attention_plain(
                       q, k, v, causal=causal), iters=5, warm=2))
        # is_causal is top-left aligned, as the kernel's mask is, so for
        # T >= S it computes the same function
        try:
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True),
                iters=20, warm=3)
        except RuntimeError as exc:  # the yardstick only, never the port
            row["library_ms"], row["library_error"] = None, str(exc)[:200]
        row["gflop"] = flops / 1e9
        row["tflops"] = tflops(flops, row["kernel_ms"])
        row["bound_ms"], row["bound_by"] = bound(
            2 * fb * (2 * fh * fs * d + 2 * fhkv * ft * d), flops, bw,
            bf16_peak)
        families[name] = row
    wide = {}
    flush = torch.empty(16 * 2 ** 20, device=dev)    # 64 MB, past the L2
    for name, fb, fh, fhkv, fs, ft, strided in WIDE_FLASH:
        wd = 128
        q, k, v = inputs(fb, fh, fhkv, fs, ft, wd, "bfloat16")
        if strided:
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                       for x in (q, k, v))
        got = fa.flash_attention(q, k, v)
        want = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if bool((err > atol + rtol * want.float().abs()).any()):
            raise AssertionError(f"flash D = 128 at {name}'s shape: max err "
                                 f"{float(err.max())}")
        flops = 4 * fh * wd * fb * _flash_pairs(fs, ft, True, 0)
        call = lambda: fa.flash_attention(q, k, v)
        row = dict(q=[fb, fh, fs, wd], kv=[fb, fhkv, ft, wd], causal=True,
                   kv_strided=strided, gqa_group=fh // fhkv,
                   max_abs_err_bf16=float(err.max()),
                   kernel_ms=device_ms(call, iters=20, warm=3,
                                       match="flash_kernel"),
                   # L2 cold: 64 MB written before each call
                   cold_l2_ms=device_ms(lambda: (flush.zero_(), call()),
                                        iters=20, warm=3,
                                        match="flash_kernel"),
                   plain_ms=device_ms(lambda: flash_attention_plain(
                       q, k, v), iters=5, warm=2))
        try:
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                iters=20, warm=3)
        except RuntimeError as exc:  # the yardstick only, never the port
            row["library_ms"], row["library_error"] = None, str(exc)[:200]
        row["gflop"] = flops / 1e9
        row["tflops"] = tflops(flops, row["kernel_ms"])
        row["bound_ms"], row["bound_by"] = bound(
            2 * fb * (2 * fh * fs * wd + 2 * fhkv * ft * wd), flops, bw,
            bf16_peak)
        wide[name] = row
    del flush
    d16 = _flash_d16(dev, inputs, bw, peak, bf16_peak)
    qoff = _flash_qoff(dev, inputs, bw, peak, bf16_peak)
    max_err = max(max_err, max(r["max_abs_err"] for r in qoff.values()
                               if r["dtype"] == "float32"))
    max_err = max(max_err, max(r["max_abs_err"] for r in d16.values()
                               if r["dtype"] == "float32"))
    emit("flash_kernel", sweep=[list(c) for c in FLASH_SWEEP],
         examples=[list(c) for c in EXAMPLE_FLASH], max_abs_err_f32=max_err,
         hymba={f"s{s}_w{w}": r for (s, w), r in out.items()},
         families=families, d128=wide, d16=d16, q_off=qoff,
         shape=dict(q=[1, h, list(SERVE_SEQ), d], kv=[1, hkv, t, d],
                    dtype="bfloat16"),
         rate="bf16 tensor cores", tolerance={"float32": 2e-5,
                                              "q_off_float32": QOFF_F32_TOL,
                                              "bfloat16": 3e-2,
                                              "hymba": [atol, rtol]})
    g = out[(SERVE_SEQ[-1], 0)]
    # the summary's yardstick: the faster of the two SDPA calls that compute
    # this function (at window 0 the boolean mask and is_causal agree)
    libs = [g[key] for key in ("library_ms", "library_causal_ms")
            if g.get(key) is not None]
    return {"flash_attention": dict(
        max_abs_err=max_err, ms=g["kernel_ms"], plain_ms=g["plain_ms"],
        library_ms=min(libs) if libs else None, tflops=g["tflops"],
        bound_ms=g["bound_ms"], bound_by=g["bound_by"])}


def _flash_qoff(dev, inputs, bw, peak, bf16_peak):
    """Flash's query-offset form at ``QOFF_FLASH`` against the plain
    version (bf16 within one ulp: atol 2e-4, rtol 8e-3; f32 within
    ``QOFF_F32_TOL``; beside it, reported, the body's error on the whole
    q_off + S query rows' matching rows), q and K/V strided as the
    sequence-parallel path gives them, each with its device time, the
    plain version's, one SDPA call's with the boolean mask (never used by
    the port) and the bound (the pairs the offset mask keeps)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain

    rows = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, b, h, hkv, s, t, d, off, window, dtype in QOFF_FLASH:
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in inputs(b, h, hkv, s, t, d, dtype))
        call = lambda: fa.flash_attention(q, k, v, window=window, q_off=off)
        got = call()
        want = flash_attention_plain(q, k, v, window=window, q_off=off)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        # the body's own error on the whole sequence's matching rows
        qf = torch.cat([torch.randn(b, h, off, d, device=dev,
                                    generator=gen).to(q.dtype), q], 2)
        own = (fa.flash_attention(qf, k, v, window=window)[:, :, off:]
               .float() - flash_attention_plain(
                   qf, k, v, window=window)[:, :, off:].float()).abs()
        tol = (QOFF_F32_TOL, 0.0) if dtype == "float32" else (2e-4, 8e-3)
        if bool((err > tol[0] + tol[1] * want.float().abs()).any()):
            raise AssertionError(f"flash q_off {name} {(off, window, dtype)}"
                                 f": max err {float(err.max())}, the "
                                 f"whole sequence's {float(own.max())}")
        qpos = off + torch.arange(s, device=dev)[:, None]
        kpos = torch.arange(t, device=dev)[None, :]
        mask = kpos <= qpos
        if window:
            mask = mask & (kpos > qpos - window)
        pairs = int(mask.sum())
        flops = 4 * h * d * b * pairs
        row = dict(q=[b, h, s, d], kv=[b, hkv, t, d], q_off=off,
                   window=window, dtype=dtype, max_abs_err=float(err.max()),
                   whole_sequence_err=float(own.max()),
                   kernel_ms=device_ms(call, iters=20, warm=3,
                                       match="flash_kernel"),
                   plain_ms=device_ms(lambda: flash_attention_plain(
                       q, k, v, window=window, q_off=off), iters=5,
                       warm=2))
        try:
            row["library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True),
                iters=20, warm=3)
        except RuntimeError as exc:  # the yardstick only, never the port
            row["library_ms"], row["library_error"] = None, str(exc)[:200]
        row["gflop"] = flops / 1e9
        row["tflops"] = tflops(flops, row["kernel_ms"])
        row["bound_ms"], row["bound_by"] = bound(
            q.element_size() * b * (2 * h * s * d + 2 * hkv * t * d), flops,
            bw, peak if dtype == "float32" else bf16_peak)
        rows[f"{name}_o{off}_w{window}_{dtype}"] = row
    return rows


def _flash_d16(dev, inputs, bw, peak, bf16_peak):
    """Flash's D = 16 bodies at ``D16_FLASH``, f32 and bf16, against the
    plain version (f32 at the sweep's 2e-5, bf16 within one ulp: atol
    2e-4, rtol 8e-3), each with its device time, the plain version's, one
    SDPA call's (``is_causal`` at window 0, else the boolean mask; never
    used by the port) and the bound (the f32 body's operations at the f32
    rate, the bf16 body's at the tensor cores'). A head dim outside
    ``HEAD_DIMS`` must raise on the card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_plain

    d = 16
    rows = {}
    for dtype, tol, rate in (("float32", (2e-5, 2e-5), peak),
                             ("bfloat16", (2e-4, 8e-3), bf16_peak)):
        for name, b, h, hkv, s, t, causal, window in D16_FLASH:
            q, k, v = inputs(b, h, hkv, s, t, d, dtype)
            call = lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window)
            got = call()
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if bool((err > tol[0] + tol[1] * want.float().abs()).any()):
                raise AssertionError(f"flash D = 16 {name} {dtype}: max err "
                                     f"{float(err.max())}")
            if causal and window:
                qpos = torch.arange(s, device=dev)[:, None]
                kpos = torch.arange(t, device=dev)[None, :]
                mask = (kpos <= qpos) & (kpos > qpos - window)
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
            else:
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
            flops = 4 * h * d * b * _flash_pairs(s, t, causal, window)
            row = dict(q=[b, h, s, d], kv=[b, hkv, t, d], causal=causal,
                       window=window, dtype=dtype,
                       max_abs_err=float(err.max()),
                       kernel_ms=device_ms(call, iters=20, warm=3,
                                           match="flash_kernel"),
                       plain_ms=device_ms(lambda: flash_attention_plain(
                           q, k, v, causal=causal, window=window), iters=5,
                           warm=2))
            try:
                row["library_ms"] = device_ms(lib, iters=20, warm=3)
            except RuntimeError as exc:  # the yardstick only, never the port
                row["library_ms"], row["library_error"] = None, str(exc)[:200]
            row["gflop"] = flops / 1e9
            row["tflops"] = tflops(flops, row["kernel_ms"])
            row["bound_ms"], row["bound_by"] = bound(
                q.element_size() * b * (2 * h * s * d + 2 * hkv * t * d),
                flops, bw, rate)
            rows[f"{name}_{dtype}"] = row
    for bad in (8, 48):
        q, k, v = inputs(1, 2, 2, 16, 16, bad, "float32")
        try:
            fa.flash_attention(q, k, v)
        except ValueError:
            continue
        raise AssertionError(f"flash took head dim {bad} on the card")
    return rows


# (B, S, H, P, N, chunk): the reference's SSD sweep, then Hymba's prefill
# shapes at the serve phase's two prompt lengths and Mamba2-370M's
SSD_SWEEP = ((1, 64, 2, 32, 16, 16), (2, 128, 3, 32, 16, 32),
             (1, 256, 4, 64, 128, 64), (2, 96, 2, 32, 8, 32))
# mamba2-370m's smoke prefill in examples/torch_serve_demo.py (B, S, H, P,
# N, chunk; one group): 8 tokens at chunk min(16, 8), x, B and C strided
# views of the in-projection's [B, S, 544] output, as the model passes them
SSD_EXAMPLE = (4, 8, 8, 64, 16, 8)
# (name, (B, S, H, P, N, chunk), conv): with ``conv`` x, B and C are
# strided views of one [B, S, H·P + 2N] conv output, as ``ssm_block``
# passes them: part (h)'s calls, a model rank's 25 of Hymba's 50 heads and
# the unsharded twin's 50, 2 rows of 2048; part (j)'s served prefills, a
# model rank's 25 heads over 2 rows of 256 tokens and of 255 (one chunk
# of 255: the model pads to no chunk multiple); the odd step after part
# (h)'s round, a model rank's 25 heads over 2 rows of 2,047 tokens padded
# to 2,048 (x, B and C the padded copies: contiguous)
SSD_MODELS = (("hymba", (1, 2048, 50, 64, 16, 256), False),
              ("hymba256", (1, 256, 50, 64, 16, 256), False),
              ("mamba2", (1, 2048, 32, 64, 128, 256), False),
              ("hymba_h_tp", (2, 2048, 25, 64, 16, 256), True),
              ("hymba_h_twin", (2, 2048, 50, 64, 16, 256), True),
              ("hymba_j_tp", (2, 256, 25, 64, 16, 256), True),
              ("hymba_j_tp_odd", (2, 255, 25, 64, 16, 255), True),
              ("hymba_odd_tp", (2, 2048, 25, 64, 16, 256), False))
# part (j)'s rows also evaluate the plain version in f64: the kernel's and
# the plain version's final state each against it, reported (at one chunk
# of 255 the f32 cumsum reaches |cum| of about 400, whose ulp bounds both
# f32 forms; the state is held to the kernel against its plain version
# within 1e-4, as every row)
SSD_F64_ROWS = ("hymba_j_tp", "hymba_j_tp_odd")


def ssd_bound(b, s, h, p, n, chunk, g, bw, peak, bf16_peak, itemsize=2):
    """(bound_ms, bound_by, flops, bytes) of one bf16 call: x, dt, a_log,
    B, C in, y and the f32 state out; per chunk C·Bᵀ over the causal pairs
    (2N each) once per group, bf16 operands at the tensor-core rate, and
    per head the pairs' weighted x (2P each) and the carried state's
    2·L·N·P twice, f32 operands at the f32 rate. The operation time is the
    sum of the two."""
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * itemsize + \
        b * s * h * 4 + h * 4 + b * h * p * n * 4
    pairs, chunks = chunk * (chunk + 1) // 2, s // chunk
    f32_ops = b * h * chunks * (pairs * 2 * p + 4 * chunk * n * p)
    bf16_ops = b * g * chunks * pairs * 2 * n
    bytes_ms = nbytes / bw * 1e3
    ops_ms = (f32_ops / peak + bf16_ops / bf16_peak) * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations", f32_ops + bf16_ops, nbytes)


def phase_ssd_kernel(dev, bw, peak, bf16_peak):
    import torch
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_plain

    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(b, s, h, p, n, dtype, g=1):
        dt = getattr(torch, dtype)
        x = torch.randn(b, s, h, p, device=dev, generator=gen).to(dt)
        d = torch.rand(b, s, h, device=dev, generator=gen) * 0.1 + 0.05
        alog = torch.log(torch.linspace(1, 16, h, device=dev))
        bm = (torch.randn(b, s, g, n, device=dev, generator=gen) * 0.5).to(dt)
        cm = (torch.randn(b, s, g, n, device=dev, generator=gen) * 0.5).to(dt)
        return x, d, alog, bm, cm

    max_err = 0.0
    for b, s, h, p, n, chunk in SSD_SWEEP:
        args = inputs(b, s, h, p, n, "float32", g=h)
        y, st = ss.ssd_scan(*args, chunk=chunk)
        yw, sw = ssd_scan_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        for got, want in ((y, yw), (st, sw)):
            err = (got - want).abs()
            if bool((err > 1e-4 + 1e-4 * want.abs()).any()):
                raise AssertionError(f"ssd {(b, s, h, p, n, chunk)}: max err "
                                     f"{float(err.max())}")
            max_err = max(max_err, float(err.max()))
    # the serve example's mamba2 prefill: x, B and C views of one
    # projection, a_log shared, held as the sweep
    b, s, h, p, n, chunk = SSD_EXAMPLE
    proj = torch.randn(b, s, h * p + 2 * n, device=dev, generator=gen)
    proj[..., h * p:] *= 0.5
    x = proj[..., :h * p].unflatten(-1, (h, p))
    bm = proj[..., h * p:h * p + n].unsqueeze(2)
    cm = proj[..., h * p + n:].unsqueeze(2)
    args = (x, torch.rand(b, s, h, device=dev, generator=gen) * 0.1 + 0.05,
            torch.log(torch.linspace(1, 16, h, device=dev)), bm, cm)
    y, st = ss.ssd_scan(*args, chunk=chunk)
    yw, sw = ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    for got, want in ((y, yw), (st, sw)):
        err = (got - want).abs()
        if bool((err > 1e-4 + 1e-4 * want.abs()).any()):
            raise AssertionError(f"ssd at the serve example's mamba2 shape "
                                 f"{SSD_EXAMPLE}: max err {float(err.max())}")
        max_err = max(max_err, float(err.max()))
    # a_log per batch row (the trainer's nodes folded into the batch)
    # against one row at a time with a shared [H] (stride 0, the serving
    # path's form): bit for bit, both dtypes
    for dtype in ("float32", "bfloat16"):
        x, d, alog, bm, cm = inputs(4, 512, 32, 64, 128, dtype)
        per_row = torch.stack([alog + 0.1 * i for i in range(4)])
        y, st = ss.ssd_scan(x, d, per_row, bm, cm, chunk=256)
        for i in range(4):
            yi, si = ss.ssd_scan(x[i:i + 1], d[i:i + 1], per_row[i],
                                 bm[i:i + 1], cm[i:i + 1], chunk=256)
            if not (torch.equal(y[i:i + 1], yi)
                    and torch.equal(st[i:i + 1], si)):
                raise AssertionError(f"ssd a_log per row differs from the "
                                     f"shared form at row {i} ({dtype})")
    rows = {}
    for name, (b, s, h, p, n, chunk), conv in SSD_MODELS:
        args = inputs(b, s, h, p, n, "bfloat16")
        if conv:
            x, d, alog, bm, cm = args
            out = torch.cat([x.flatten(2), bm.flatten(2), cm.flatten(2)], -1)
            x = out[..., :h * p].unflatten(-1, (h, p))
            bm = out[..., h * p:h * p + n].unflatten(-1, (1, n))
            cm = out[..., h * p + n:].unflatten(-1, (1, n))
            args = (x, d, alog, bm, cm)
        y, st = ss.ssd_scan(*args, chunk=chunk)
        yw, sw = ssd_scan_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        errs = []
        # y in bf16; the final state f32 on both sides
        for got, want, tol in ((y.float(), yw.float(), 2e-2),
                               (st, sw, 1e-4)):
            err = (got - want).abs()
            if bool((err > tol + tol * want.abs()).any()):
                raise AssertionError(f"ssd at {name}'s shape: max err "
                                     f"{float(err.max())}")
            errs.append(float(err.max()))
        f64 = {}
        if name in SSD_F64_ROWS:
            s64 = ssd_scan_plain(*args, chunk=chunk, acc=torch.float64)[1]
            f64 = dict(state_err_vs_f64={
                "kernel": float((st.double() - s64).abs().max()),
                "plain": float((sw.double() - s64).abs().max())})
        bms, by, flops, nbytes = ssd_bound(b, s, h, p, n, chunk, 1, bw, peak,
                                           bf16_peak)
        ms = device_ms(lambda: ss.ssd_scan(*args, chunk=chunk), iters=20,
                       warm=3)
        rows[name] = dict(
            shape=[b, s, h, p, n, chunk], conv_views=conv,
            max_abs_err_y=errs[0],
            max_abs_err_state=errs[1], **f64, gflop=flops / 1e9,
            mbytes=nbytes / 1e6,
            kernel_ms=ms, tflops=tflops(flops, ms),
            plain_ms=device_ms(lambda: ssd_scan_plain(*args, chunk=chunk),
                               iters=5, warm=2),
            bound_ms=bms, bound_by=by)
    emit("ssd_kernel", sweep=[list(c) for c in SSD_SWEEP],
         example=list(SSD_EXAMPLE),
         max_abs_err_f32=max_err, models=rows,
         a_log_per_row_bit_equal=True,
         rate="C·Bᵀ at the bf16 tensor-core rate, the rest at the f32 rate",
         tolerance={"float32": 1e-4, "bfloat16": 2e-2, "state": 1e-4})
    hy = rows["hymba"]
    return {"ssd_scan": dict(
        max_abs_err=max_err, ms=hy["kernel_ms"], plain_ms=hy["plain_ms"],
        library_ms=None, tflops=hy["tflops"], bound_ms=hy["bound_ms"],
        bound_by=hy["bound_by"])}


def phase_dryrun(dev, smi):
    """Phase 9c: `repro_torch.launch.dryrun.card_phase` (see the module
    docstring)."""
    from repro_torch.launch import dryrun
    out = dryrun.card_phase(device_ms)
    for row in out["pairs"]:
        print(f"dryrun: ({row['pair']}) {row['arch']} × {row['shape']} "
              f"({row['profile']}) rank {row['rank']}: "
              f"peak meta {row['meta_peak'] / 2**30:.3f} GiB, card "
              f"{row['card_peak'] / 2**30:.3f} GiB; device "
              f"{row['device_ms']:.1f} ms against the roofline's "
              f"{row['bound_ms']:.1f} ms", file=sys.stderr, flush=True)
    emit("dryrun", nvidia_smi=smi, **out)
    return out


def phase_merge_one(dev, bw, peak):
    """The one-node commit through ``ops.merge_op``: the path (each node of
    a [4, P] state committed alone, counted) against the all-nodes kernel,
    then against its plain version, and its time."""
    import torch
    from repro_torch.core.topology import ring_matrix
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels import fused_merge as fm
    from repro_torch.kernels.ref import fused_merge_ref

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(N, P, device=dev, generator=gen)
    W = torch.as_tensor(ring_matrix(N, 0.5), dtype=torch.float32, device=dev)
    gates = torch.tensor([True, False, True, True], device=dev)
    reset_launches()
    rows = [ops.merge_op(x, W[i], i, gates[i]) for i in range(N)]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches != {k: N if k == "fused_merge" else 0 for k in LAUNCHES}:
        raise AssertionError(f"one-node commits launched {launches}")
    if not torch.equal(torch.stack(rows), fm.fused_merge_all(x, W, gates)):
        raise AssertionError("one-node commits differ from the all-nodes "
                             "kernel")
    w = W[0]
    for gate in (True, False):
        got = ops.merge_op(x, w, 0, gate)
        want = fused_merge_ref(x, w, 0, gate)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"one-node commit (gate {gate}) differs "
                                 f"from plain: max err "
                                 f"{float((got - want).abs().max())}")
    g = torch.tensor(True, device=dev)
    ms = device_ms(lambda: ops.merge_op(x, w, 0, g), iters=50)
    # the gate and self_idx as Python values go to the kernel by value; as
    # 0-d device tensors the kernel reads them: CUDA events around calls
    # read the host's share too
    host_ms = {"python": time_ms(lambda: ops.merge_op(x, w, 0, True)),
               "device_tensor": time_ms(lambda: ops.merge_op(x, w, 0, g))}
    plain_ms = device_ms(lambda: fused_merge_ref(x, w, 0, g), iters=20)
    library_ms = device_ms(lambda: torch.where(g, w @ x, x[0]), iters=50)
    bms, by = bound((N + 1) * P * 4 + N * 4, 2 * N * P, bw, peak)
    emit("merge_one", shape=[N, P], launches=launches, kernel_ms=ms,
         events_ms=host_ms, plain_ms=plain_ms, library_ms=library_ms,
         bound_ms=bms, bound_by=by, bit_equal=True)
    return ({"fused_merge": dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms,
                                 tflops=tflops(2 * N * P, ms), bound_ms=bms,
                                 bound_by=by)}, launches)


# the lm_parity phase's smoke variants: three at their smoke widths, and
# nemotron-4-15b's and deepseek-coder-33b's at their real head dim and GQA
# group (flash's f32 D = 128 body on a model path: the prefill of 36
# tokens into a 48-deep cache)
LM_PARITY = (("hymba-1.5b", {}), ("minicpm-2b", {}), ("mamba2-370m", {}),
             ("nemotron-4-15b", dict(head_dim=128, n_heads=6, n_kv_heads=1)),
             ("deepseek-coder-33b", dict(head_dim=128, n_heads=7,
                                         n_kv_heads=1)))


def phase_lm_parity(dev):
    """The smoke variants in f32 on the card against the CPU: prefill
    logits and 4 decode steps (TF32 off)."""
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for arch, upd in LM_PARITY:
            model = build_model(smoke_variant(get_config(arch))
                                .replace(**upd))
            flat = model.init(torch.Generator().manual_seed(0), "cpu")
            rng = torch.Generator().manual_seed(1)
            toks = torch.randint(0, 512, (2, 40), generator=rng)
            res = {}
            for d in ("cpu", dev):
                params = model.layout.unflatten(flat.to(d))
                caches = model.init_cache(2, 48, d)
                lg, caches = model.prefill(params, {"tokens": toks[:, :36]
                                                    .to(d)}, caches)
                outs = [lg[:, -1]]
                for i in range(4):
                    lg, caches = model.decode(params, toks[:, 36 + i:37 + i]
                                              .to(d), caches, 36 + i)
                    outs.append(lg[:, -1])
                res[d] = torch.stack(outs).cpu()
            err = float((res[dev] - res["cpu"]).abs().max())
            if not err <= 1e-4 or not bool(torch.isfinite(res[dev]).all()):
                raise AssertionError(f"{arch}: card vs CPU logits err {err}")
            errs[model.cfg.name + ("-d128" if upd else "")] = err
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    emit("lm_parity", max_abs_err=errs, tolerance=1e-4, steps=5)


def _replay_consensus(model, params, req, bucket, dev):
    """``req``'s consensus tokens [new, N] served again outside the engine,
    from the same ensemble ``params`` [N, P]: each node's prefill of the
    prompt on a fresh one-lane cache, then its decode fed the served
    tokens, at the engine's decode shape (``bucket`` rows, every row this
    request), and the same aggregation over the nodes. The engine's rows
    do not mix, so its slot, version and cache bookkeeping must give these
    tokens bit for bit."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import make_logits_step
    from repro_torch.serve.engine import aggregate_logits, tree_map

    step = make_logits_step(model)
    n_nodes = params.shape[0]
    views = [model.layout.unflatten(params[i]) for i in range(n_nodes)]
    mask = torch.ones(n_nodes, dtype=torch.bool, device=dev)
    length = len(req.prompt)
    prompt = torch.as_tensor(req.prompt, device=dev).to(torch.long)[None]
    caches, logits = [], []
    for n in range(n_nodes):
        lane = model.init_cache(1, SERVE_MAX_LEN, dev)
        lg, _ = step(views[n], prompt, lane, 0)
        logits.append(lg[0, length - 1])
        caches.append(tree_map(lambda t: t.repeat(
            (bucket,) + (1,) * (t.dim() - 1)), lane))
    out = [aggregate_logits(torch.stack(logits)[:, None], "consensus",
                            node_mask=mask)[:, 0]]
    commit = torch.ones(bucket, dtype=torch.bool, device=dev)
    for k in range(1, len(req.node_tokens)):
        fed = req.node_tokens[k - 1]
        pos = torch.full((bucket,), length + k - 1, dtype=torch.long,
                         device=dev)
        logits = [step(views[n], torch.full((bucket, 1), int(fed[n]),
                                            dtype=torch.long, device=dev),
                       caches[n], pos, commit=commit)[0][:, -1]
                  for n in range(n_nodes)]
        out.append(aggregate_logits(torch.stack(logits), "consensus",
                                    node_mask=mask)[:, 0])
    return np.stack([o.cpu().numpy() for o in out])


def _busy(prof, wall):
    """A profiled stretch of ``wall`` seconds: the device's busy time and
    share, host-side ops and kernel launches, the top host ops and
    kernels."""
    import torch
    cuda_t = torch.autograd.DeviceType.CUDA
    evts = prof.key_averages()
    cuda = [e for e in evts if e.device_type == cuda_t]
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in cuda)
    host = sorted((e for e in evts if e.device_type != cuda_t),
                  key=lambda e: -e.self_cpu_time_total)
    dev_top = sorted(cuda, key=lambda e: -getattr(
        e, "self_device_time_total", 0.0))
    return dict(wall_s=wall, device_busy_s=busy / 1e6,
                device_busy_share=busy / 1e6 / wall,
                host_ops=sum(e.count for e in evts if e.key.startswith(
                    "aten::") and e.device_type != cuda_t),
                kernel_launches=sum(e.count for e in cuda),
                top_host=[{"op": e.key[:60], "calls": e.count,
                           "self_ms": e.self_cpu_time_total / 1e3}
                          for e in host[:10]],
                top_device=[{"kernel": e.key[:80], "calls": e.count,
                             "ms": getattr(e, "self_device_time_total",
                                           0.0) / 1e3}
                            for e in dev_top[:8]])


def _timed_runs(fn, runs=3):
    """Host-clock seconds of ``runs`` synchronized calls of ``fn``."""
    import torch
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _profiled(fn, runs=1):
    """``fn``'s wall (median of ``runs`` synchronized calls, no profiler),
    then one call under the profiler: its device busy time, the busy share
    of the unprofiled wall, host ops, launches and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls = _timed_runs(fn, runs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = _busy(prof, pwall)
    wall = sorted(walls)[len(walls) // 2]
    return dict(wall_s=wall, walls_s=walls, device_s=busy["device_busy_s"],
                busy_share=busy["device_busy_s"] / wall,
                profiled_wall_s=pwall, host_ops=busy["host_ops"],
                kernel_launches=busy["kernel_launches"],
                top_device=busy["top_device"][:5])


def _eager_vs_replay(prog, out=None, state=(), turns=4):
    """A warm program's body called eagerly against ``run()`` (a replay),
    from the same inputs, in ``turns`` timed turns, each a
    :func:`_profiled` group of calls: 4 are eager, replay, replay, eager;
    2 are eager, replay; 0 calls each once, untimed.
    ``out``, where given, are the tokens the program writes: zeroed before
    each turn (unless ``state`` holds it) and read after it, and every turn
    must give the same (``tokens``). ``state`` are inputs that the body
    advances itself (generate's ``tok`` and ``pos``), set back before each
    turn."""
    import torch
    order = (("eager", prog.body), ("replay", prog.run),
             ("replay_2", prog.run), ("eager_2", prog.body))
    saved = [t.clone() for t in state]
    res, got = {}, []
    for name, fn in order[:max(turns, 2)]:
        for t, v in zip(state, saved):
            t.copy_(v)
        if out is not None and not any(out is t for t in state):
            out.zero_()
        if turns:
            res[name] = _profiled(fn)
        else:
            fn()
        if out is not None:
            torch.cuda.synchronize()
            got.append(out.clone())
    if out is not None:
        res["tokens"] = dict(equal=all(torch.equal(got[0], g)
                                       for g in got[1:]),
                             eager=got[0].reshape(-1)[:8].tolist(),
                             replay=got[1].reshape(-1)[:8].tolist())
    return res


def _profiled_replay_launches(prog, tries=4):
    """One replay of a prefill program under the profiler: the flash and
    SSD (``chunk_out``) kernel records against the ``LAUNCHES`` the replay
    added; a trace whose records fall short is traced again (the
    profiler's short traces on the H100 lose records now and then, see
    ``device_ms``), up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import LAUNCHES
    for attempt in range(1, tries + 1):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prog.run()
            torch.cuda.synchronize()
        added = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        records = {"flash_attention": sum(e.count for e in cuda
                                          if "flash_kernel" in e.key),
                   "ssd_scan": sum(e.count for e in cuda
                                   if "chunk_out_kernel" in e.key)}
        if records == added:
            return dict(launches=added, records=records, traces=attempt)
        TIMERS["traces_discarded"] += 1
    raise AssertionError(f"profiled replay: kernel records {records}, "
                         f"launches {added} in {tries} traces")


def phase_serve(dev, smi):
    """The LM serving path at Hymba-1.5B width through captured programs,
    counts set to 0 just before each wave and read just after it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.capture import WARMUP
    from repro_torch.launch.serve import (generate, prefill_step_for,
                                          serve_step_for)
    from repro_torch.models import build_model
    from repro_torch.serve import BucketPolicy, ServeEngine

    cfg = get_config("hymba-1.5b")
    model = build_model(cfg)
    size = model.layout.size
    per_prefill = N * cfg.n_layers       # flash / SSD launches a prefill
    buckets = (1, 2, 4)
    grid = ({("decode", b) for b in buckets}
            | {("prefill", s, b) for s in SERVE_SEQ for b in buckets})

    def ensemble(seed):
        buf = torch.empty((N, size), dtype=torch.bfloat16, device=dev)
        for i in range(N):
            model.init(torch.Generator(device=dev).manual_seed(seed + i), dev,
                       out=buf[i])
        return buf

    prefill_s, decode_s = [], []   # (length, s, built), (s, built)

    class TimedEngine(ServeEngine):
        """Synchronized host time of each prefill (all N nodes) by prompt
        length and of each decode dispatch, each marked with whether it
        found its key's program built (else its time holds the build)."""

        def _prefill_commit(self, version, prompt, slot, length):
            built = self._built(("prefill", prompt.shape[0], self._bucket),
                                version)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._prefill_commit(version, prompt, slot, length)
            prefill_s.append((length, time.perf_counter() - t0, built))
            return out

        def _decode_commit(self, version, tokens, pos, live):
            built = self._built(("decode", tokens.shape[1]), version)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._decode_commit(version, tokens, pos, live)
            decode_s.append((time.perf_counter() - t0, built))
            return out

    t0 = time.perf_counter()
    ens_a, ens_b = ensemble(100), ensemble(200)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = np.random.default_rng(0)
    short, long_ = SERVE_SEQ
    lengths = (long_, short, long_, short, short, long_, short, long_)
    prompts = [gen.integers(0, cfg.vocab_size, n) for n in lengths]
    eng = TimedEngine(model, ens_a, mode="consensus", max_len=SERVE_MAX_LEN,
                      max_slots=4, device=dev,
                      policy=BucketPolicy(batch_buckets=buckets,
                                          seq_buckets=SERVE_SEQ))

    def wave(swap_to=None, max_new=SERVE_NEW, flip=False,
             profile_tick=False):
        """Four requests, two ticks (node 1 failed between them with
        ``flip``, restored after), a swap to ``swap_to`` while they are in
        flight, four more requests, drained; launch counts set to 0 just
        before. Returns (requests, swapped-to version, wall s, the
        profiled decode-only tick, launches)."""
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new) for p in prompts[:4]]
        eng.step()
        if flip:
            eng.fail_node(1)
        eng.step()
        if flip:
            eng.restore_node(1)
        swapped = eng.swap(swap_to) if swap_to is not None else None
        reqs += [eng.submit(p, max_new) for p in prompts[4:]]
        tick = None
        while len(eng.queue) or eng.live_count:
            if profile_tick and tick is None and not len(eng.queue) \
                    and eng.live_count == 4 \
                    and all(len(r.node_tokens) > 1 for r in reqs[4:]):
                # one decode-only tick under the profiler, on a built key
                traces = eng.total_traces
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    eng.step()
                    torch.cuda.synchronize()
                    twall = time.perf_counter() - t1
                if eng.total_traces != traces:
                    raise AssertionError("the profiled tick built a program")
                tick = _busy(prof, twall)
            else:
                eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for i, r in enumerate(reqs):
            if r.status != "done" or len(r.tokens) != max_new:
                raise AssertionError(f"request {r.rid}: {r.status}, "
                                     f"{len(r.tokens)} tokens")
            toks = np.stack(r.node_tokens)
            if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
                raise AssertionError(f"request {r.rid}: {toks.tolist()}")
            if swapped is not None and i >= 4 and r.param_version != swapped:
                raise AssertionError(f"request {r.rid} ran on version "
                                     f"{r.param_version}, not {swapped}")
        return reqs, swapped, wall, tick, dict(LAUNCHES)

    def check_launches(launches, prefills, what):
        want = {k: 0 for k in LAUNCHES}
        want.update(flash_attention=per_prefill * prefills,
                    ssd_scan=per_prefill * prefills)
        if launches != want:
            raise AssertionError(f"{what}: launches {launches}, want {want}")

    # wave 1, cold: every key it dispatches is built at its first dispatch
    torch.cuda.reset_peak_memory_stats()
    reqs1, swapped, wall1, _, launches1 = wave(swap_to=ens_b)
    if reqs1[0].param_version != 0:
        raise AssertionError(f"request {reqs1[0].rid} ran on version "
                             f"{reqs1[0].param_version}")
    built = dict(eng.trace_counts)
    if not set(built) <= grid or any(v != 1 for v in built.values()):
        raise AssertionError(f"builds {built} off the grid or repeated")
    if set(eng.programs) != {(k, i) for k in built
                             for i in range(len(eng.slot.pool))} \
            or len(eng.slot.pool) != 2:
        raise AssertionError(f"programs {sorted(map(str, eng.programs))}")
    warm_passes = sum(p.eager_calls for (k, _), p in eng.programs.items()
                      if k[0] == "prefill")
    # warm-up passes run on the card too: launches = prefills + warm-ups
    check_launches(launches1, len(reqs1) + warm_passes, "wave 1")
    mark = len(prefill_s), len(decode_s)
    # wave 2, warm: the same traffic on the built keys, a swap back
    reqs2, _, wall2, _, launches2 = wave(swap_to=ens_a)
    check_launches(launches2, len(reqs2), "wave 2")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.max_memory_reserved() / 2 ** 30
    if dict(eng.trace_counts) != built:
        raise AssertionError(f"wave 2 built: {dict(eng.trace_counts)}")
    # wave 3: node 1 failed and restored mid-flight, no new build; one
    # decode-only tick profiled (out of the timed wave 2: processing the
    # trace takes seconds of host time)
    reqs3, _, wall3, tick, launches3 = wave(max_new=4, flip=True,
                                            profile_tick=True)
    if tick is None:
        raise AssertionError("no decode-only tick was profiled")
    check_launches(launches3, len(reqs3), "wave 3")
    if dict(eng.trace_counts) != built or len(eng.slot.pool) != 2:
        raise AssertionError(f"wave 3 built: {dict(eng.trace_counts)}")
    # a long request of the first version and a short one of the swapped
    # version, served again outside the engine: their tokens must match
    decode_bucket, = {key[1] for key in eng.trace_counts
                      if key[0] == "decode"}
    replayed = {}
    for r, params in ((reqs1[0], ens_a), (reqs1[4], ens_b)):
        again = _replay_consensus(model, params, r, decode_bucket, dev)
        if not np.array_equal(again, np.stack(r.node_tokens)):
            raise AssertionError(
                f"request {r.rid}: served {np.stack(r.node_tokens)[:, 0]}, "
                f"replayed {again[:, 0]}")
        replayed[r.rid] = dict(prompt=len(r.prompt), version=r.param_version,
                               tokens=again[:, 0].tolist())
    # generate: a cold call builds its two programs, a warm one replays
    prompt = torch.as_tensor(np.stack([gen.integers(0, cfg.vocab_size, short)
                                       for _ in range(4)]))
    gens = {}
    for name in ("cold", "warm"):
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = generate(model, ens_b[0], prompt, SERVE_NEW, short + SERVE_NEW,
                       device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        gens[name] = dict(seconds=seconds, tokens_per_s=4 * SERVE_NEW / seconds,
                          launches={k: v for k, v in LAUNCHES.items() if v})
        if tuple(out.shape) != (4, SERVE_NEW) or not bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"generate gave {tuple(out.shape)}")
    if (LAUNCHES["flash_attention"], LAUNCHES["ssd_scan"]) != (
            cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"warm generate launches {dict(LAUNCHES)}")
    gen_progs = (serve_step_for(model, 4, short + SERVE_NEW, torch.device(dev)),
                 prefill_step_for(model, 4, short, short + SERVE_NEW,
                                  torch.device(dev)))
    # on the card a body runs eagerly only in its warm-up
    calls = [p.eager_calls for p in list(eng.programs.values()) + list(
        gen_progs)]
    if any(c != WARMUP for c in calls) or not all(
            p.captured for p in list(eng.programs.values()) + list(gen_progs)):
        raise AssertionError(f"eager body calls {calls}, want {WARMUP} each")
    # eager against replay on warm keys, and a profiled replayed prefill's
    # kernel records against its launches
    versus, records = {}, {}
    prog = eng.programs[("decode", decode_bucket), 0]
    # two turns (eager, replay), as wide_serve's nemotron-4-15b engine
    # runs them on its decode key
    versus["decode"] = _eager_vs_replay(prog, turns=2)
    for n in SERVE_SEQ[-1:]:
        prog = eng.programs[("prefill", n, decode_bucket), 0]
        eng._stage_prefill(gen.integers(0, cfg.vocab_size, n), 0, n)
        # the tick only: a profiled eager prefill's trace takes about 10 s
        # a turn to process, and wide_serve runs a 2048-token prefill key
        # eagerly against its replay (nemotron-4-15b's); the 2048-token
        # prefill's replay alone is profiled (every wave holds the
        # 256-token key's launches to the count)
        records[n] = _profiled_replay_launches(prog)
        if records[n]["launches"] != {"flash_attention": per_prefill,
                                      "ssd_scan": per_prefill}:
            raise AssertionError(f"replayed prefill {n}: {records[n]}")
    lat = sorted(r.latency_s for r in reqs2)
    warm_prefill = {n: [t for m, t, b in prefill_s[mark[0]:] if m == n]
                    for n in SERVE_SEQ}
    warm_ticks = [t for t, _ in decode_s[mark[1]:]]
    emit("serve_builds", card=smi, keys={
        str(k): dict(builds=v, seconds=eng.build_seconds[k],
                     capture_s=[eng.programs[k, i].capture_s
                                for i in range(len(eng.slot.pool))],
                     launches_per_replay=eng.programs[k, 0].launches)
        for k, v in sorted(built.items())},
         build_seconds_total=sum(eng.build_seconds.values()),
         programs=len(eng.programs), pool_buffers=len(eng.slot.pool),
         warmup_passes=WARMUP, sync_debug_mode_in_warmups="error",
         eager_body_calls=sum(calls),
         replays=sum(p.replays for p in eng.programs.values()))
    emit("serve", card=smi, arch=cfg.name, dtype=cfg.param_dtype, nodes=N,
         params_per_node=size, ensemble_gib=N * size * 2 / 2 ** 30,
         requests=len(reqs2), new_tokens=SERVE_NEW, prompt_lengths=lengths,
         max_len=SERVE_MAX_LEN, init_seconds=init_s,
         cold_wave=dict(wall_seconds=wall1,
                        tokens_per_s=len(reqs1) * SERVE_NEW / wall1,
                        build_seconds=sum(eng.build_seconds.values()),
                        prefill_s=[[m, t, b] for m, t, b in
                                   prefill_s[:mark[0]]],
                        launches={k: v for k, v in launches1.items() if v}),
         wall_seconds=wall2, tokens_per_s=len(reqs2) * SERVE_NEW / wall2,
         latency_p50_s=float(np.percentile(lat, 50)),
         latency_p99_s=float(np.percentile(lat, 99)),
         prefill_s={str(n): v for n, v in warm_prefill.items()},
         decode_tick_s=dict(n=len(warm_ticks),
                            median=float(np.median(warm_ticks)),
                            max=float(max(warm_ticks))),
         profiled_decode_tick=tick, peak_mem_gib=peak_gib,
         peak_reserved_gib=reserved_gib,
         launches={k: v for k, v in launches2.items() if v},
         flip_wave=dict(wall_seconds=wall3, requests=len(reqs3),
                        new_tokens=4),
         dispatch_keys=sorted(map(str, eng.trace_counts)),
         generate=dict(batch=4, prompt=short, **gens), replayed=replayed)
    emit("serve_replay", card=smi, eager_vs_replay=versus,
         profiled_replay=records)
    return launches2


# the families phases: the smoke variants held card vs CPU, then one model
# of each family at full width (bf16, random weights from seeded
# generators, published widths and depths)
FAMILIES = ("granite-moe-3b-a800m", "internvl2-1b", "seamless-m4t-medium")
VLM_BATCH, VLM_TEXT = 4, 1792          # + 256 patches = 2048 positions
ENC_BATCH, ENC_NEW = 4, 32             # 1024 frames each, 32 decode steps


def phase_families_parity(dev):
    """The moe, vlm and enc-dec smoke variants in f32 on the card against
    the CPU (TF32 off): the prefill logits (a vlm's with its patch
    embeddings; seamless's encoder output instead) and 4 decode steps
    within 1e-4, and the MoE's expert ids and keep masks equal."""
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import build_model, nest
    from repro_torch.models import moe
    from repro_torch.models.encdec import encode
    from repro_torch.models.transformer import layer_params

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, routing = {}, {}
    try:
        for arch in FAMILIES:
            cfg = smoke_variant(get_config(arch))
            model = build_model(cfg)
            flat = model.init(torch.Generator().manual_seed(0), "cpu")
            rng = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=rng)
            extra = {}
            if cfg.family == "vlm":
                extra["patch_embeds"] = torch.randn(
                    2, cfg.n_patches, cfg.frontend_dim, generator=rng)
            if cfg.is_encdec:
                extra["frames"] = torch.randn(
                    2, cfg.enc_seq_len, cfg.frontend_dim, generator=rng)
            x = torch.randn(2, 36, cfg.d_model, generator=rng)
            res = {}
            for d in ("cpu", dev):
                params = model.layout.unflatten(flat.to(d))
                caches = model.init_cache(2, 48, d)
                if cfg.is_encdec:
                    enc = encode(nest(params), cfg, extra["frames"].to(d))
                    caches["enc_out"].copy_(enc)
                    outs, start, fed = [enc], 0, toks[:, :4]
                else:  # a vlm's patches sit before its 36 tokens
                    batch = {"tokens": toks[:, :36].to(d),
                             **{k: v.to(d) for k, v in extra.items()}}
                    lg, caches = model.prefill(params, batch, caches)
                    outs, fed = [lg[:, -1]], toks[:, 36:40]
                    start = 36 + (cfg.n_patches if cfg.family == "vlm"
                                  else 0)
                for i in range(4):
                    lg, caches = model.decode(params, fed[:, i:i + 1].to(d),
                                              caches, start + i)
                    outs.append(lg[:, -1])
                res[d] = [o.float().cpu() for o in outs]
                if cfg.family == "moe":
                    lp = layer_params(nest(params)["layers"], 0)["moe"]
                    _, ids, _ = moe.route(lp, x.to(d), cfg)
                    _, keep, _ = moe.dispatch(ids, cfg)
                    res[d, "routing"] = (ids.cpu(), keep.cpu())
            err = max(float((a - b).abs().max())
                      for a, b in zip(res[dev], res["cpu"]))
            if not err <= 1e-4 or not all(bool(torch.isfinite(o).all())
                                          for o in res[dev]):
                raise AssertionError(f"{arch}: card vs CPU err {err}")
            errs[arch] = err
            if cfg.family == "moe":
                (ids, keep), (cids, ckeep) = (res[dev, "routing"],
                                              res["cpu", "routing"])
                bad = (ids != cids).nonzero().tolist()
                if bad or not torch.equal(keep, ckeep):
                    raise AssertionError(f"{arch}: expert ids differ at "
                                         f"{bad[:20]}, keep equal "
                                         f"{torch.equal(keep, ckeep)}")
                routing[arch] = dict(assignments=ids.numel(),
                                     kept=int(keep.sum()), ids_equal=True,
                                     keep_equal=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    emit("families_parity", max_abs_err=errs, tolerance=1e-4, steps=5,
         moe_routing=routing)


def _memory():
    import torch
    return dict(peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
                card_gib=torch.cuda.get_device_properties(0).total_memory
                / 2 ** 30)


def _engine_serve(dev, arch, nodes, seed, turns=0):
    """``arch`` at full width behind ``ServeEngine``: ``nodes`` nodes
    initialised on the card from seeds ``seed``, ``seed + 1``, ..., 4
    slots, seq buckets (256, 2048), captured programs, a cold wave of 8
    requests (its keys built) and a warm one of the same traffic (no
    build; flash launches = nodes × layers a prefill), no hot swap. The
    warm decode key and the warm 2048 prefill key then run their body
    eagerly against a replay: their tokens must be equal, in ``turns``
    timed turns (:func:`_eager_vs_replay`)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.serve import BucketPolicy, ServeEngine

    cfg = get_config(arch)
    model = build_model(cfg)
    size = model.layout.size
    per_prefill = nodes * cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ens = torch.empty((nodes, size), dtype=torch.bfloat16, device=dev)
    for i in range(nodes):
        model.init(torch.Generator(device=dev).manual_seed(seed + i), dev,
                   out=ens[i])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(model, ens, mode="consensus", max_len=SERVE_MAX_LEN,
                      max_slots=4, device=dev,
                      policy=BucketPolicy(batch_buckets=(1, 2, 4),
                                          seq_buckets=SERVE_SEQ))
    del ens
    gen = np.random.default_rng(3)
    short, long_ = SERVE_SEQ
    lengths = (long_, short, long_, short, short, long_, short, long_)
    prompts = [gen.integers(0, cfg.vocab_size, n) for n in lengths]

    def wave():
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reqs = [eng.submit(p, SERVE_NEW) for p in prompts[:4]]
        eng.step()
        reqs += [eng.submit(p, SERVE_NEW) for p in prompts[4:]]
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        for r in reqs:
            toks = np.stack(r.node_tokens)
            if r.status != "done" or len(r.tokens) != SERVE_NEW or not (
                    (toks >= 0) & (toks < cfg.vocab_size)).all():
                raise AssertionError(f"{arch} request {r.rid}: {r.status}")
        return reqs, wall, dict(LAUNCHES)

    reqs1, wall1, _ = wave()
    built = dict(eng.trace_counts)
    reqs2, wall2, launches = wave()
    if dict(eng.trace_counts) != built:
        raise AssertionError(f"the warm wave built {dict(eng.trace_counts)}")
    predicted = per_prefill * len(reqs2)
    if launches["flash_attention"] != predicted or any(
            v for k, v in launches.items() if k != "flash_attention"):
        raise AssertionError(f"{arch} launches {launches}, predicted "
                             f"flash {predicted}")
    decode_bucket = max(k[1] for k in built if k[0] == "decode")
    prog = eng.programs[("decode", decode_bucket), 0]
    tick = _profiled(prog.run)
    versus = {"decode": _eager_vs_replay(prog, eng._out, turns=turns)}
    pre = {}
    for n in SERVE_SEQ:
        prog = eng.programs[("prefill", n, decode_bucket), 0]
        eng._stage_prefill(gen.integers(0, cfg.vocab_size, n), 0, n)
        pre[str(n)] = _profiled(prog.run)
        reset_launches()
        prog.run()
        torch.cuda.synchronize()
        if LAUNCHES["flash_attention"] != per_prefill:
            raise AssertionError(f"a replayed prefill launched "
                                 f"{dict(LAUNCHES)}")
        if n == long_:
            versus[f"prefill_{n}"] = _eager_vs_replay(prog, eng._out,
                                                      turns=turns)
    unequal = [k for k, v in versus.items() if not v["tokens"]["equal"]]
    if unequal:
        raise AssertionError(f"{arch}: eager and replayed tokens differ "
                             f"at {unequal}: {versus}")
    lat = sorted(r.latency_s for r in reqs2)
    return dict(arch=cfg.name, nodes=nodes, params_per_node=size,
                ensemble_gib=nodes * size * 2 / 2 ** 30,
                pool_buffers=len(eng.slot.pool), init_seconds=init_s,
                requests=len(reqs2), new_tokens=SERVE_NEW,
                prompt_lengths=lengths, max_len=SERVE_MAX_LEN,
                cold_wave=dict(wall_s=wall1,
                               builds={str(k): v for k, v in built.items()},
                               build_seconds=sum(eng.build_seconds.values())),
                wall_s=wall2, tokens_per_s=len(reqs2) * SERVE_NEW / wall2,
                latency_p50_s=float(np.percentile(lat, 50)),
                latency_p99_s=float(np.percentile(lat, 99)),
                decode_tick=dict(bucket=decode_bucket, **tick),
                prefill_replay=pre,
                flash_launches=dict(warm_wave=launches["flash_attention"],
                                    predicted=predicted,
                                    per_prefill=per_prefill),
                eager_vs_replay=versus, **_memory())


def _vlm_serve(dev):
    """internvl2-1b: ``model.prefill`` of 256 patch embeddings + 1,792
    tokens at batch 4 into the step buffers' caches (24 flash launches),
    then 16 replays of the captured decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_step_for, step_buffers
    from repro_torch.models import build_model

    cfg = get_config(FAMILIES[1])
    model = build_model(cfg)
    s = cfg.n_patches + VLM_TEXT
    max_len = s + SERVE_NEW
    torch.cuda.reset_peak_memory_stats()
    st = step_buffers(model, VLM_BATCH, max_len, torch.device(dev))
    decode = serve_step_for(model, VLM_BATCH, max_len, torch.device(dev))
    model.init(torch.Generator(device=dev).manual_seed(400), dev,
               out=st.params)
    gen = torch.Generator(device=dev).manual_seed(401)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT),
                                     device=dev, generator=gen),
             "patch_embeds": torch.randn(VLM_BATCH, cfg.n_patches,
                                         cfg.frontend_dim, device=dev,
                                         generator=gen)}

    def prefill():
        logits, _ = model.prefill(st.views, batch, st.caches)
        st.tok.copy_(torch.argmax(logits[:, -1], dim=-1, keepdim=True))
        st.pos.fill_(s)

    def serve():
        prefill()
        out = [st.tok.clone()]
        for _ in range(SERVE_NEW - 1):
            decode.run()
            out.append(st.tok.clone())
        return torch.cat(out, dim=1)

    reset_launches()
    prefill()
    torch.cuda.synchronize()
    if dict((k, v) for k, v in LAUNCHES.items() if v) != {
            "flash_attention": cfg.n_layers}:
        raise AssertionError(f"internvl2 prefill launches {dict(LAUNCHES)}")
    pre = _profiled(prefill)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tuple(out.shape) != (VLM_BATCH, SERVE_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"internvl2 tokens {out.tolist()}")
    st.pos.fill_(s)    # the profiled ticks write positions s .. s + 3
    tick = _profiled(decode.run)
    return dict(arch=cfg.name, batch=VLM_BATCH, patches=cfg.n_patches,
                text_tokens=VLM_TEXT, positions=s, new_tokens=SERVE_NEW,
                params=model.layout.size, wall_s=wall,
                tokens_per_s=VLM_BATCH * SERVE_NEW / wall,
                prefill=pre, decode_tick=tick,
                flash_launches=dict(per_prefill=cfg.n_layers,
                                    predicted=cfg.n_layers),
                **_memory())


def _encdec_serve(dev):
    """seamless-m4t-medium: ``encode`` of 4 × 1024 frames (12 flash
    launches, ``causal=False``), the output copied into the step buffers'
    ``enc_out``, then 32 replays of the captured decode step (its S = 1
    attention plain; the cross K/V recomputed from ``enc_out`` every
    step)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_step_for, step_buffers
    from repro_torch.models import build_model, nest
    from repro_torch.models.encdec import encode

    cfg = get_config(FAMILIES[2])
    model = build_model(cfg)
    max_len = ENC_NEW
    torch.cuda.reset_peak_memory_stats()
    st = step_buffers(model, ENC_BATCH, max_len, torch.device(dev))
    decode = serve_step_for(model, ENC_BATCH, max_len, torch.device(dev))
    model.init(torch.Generator(device=dev).manual_seed(500), dev,
               out=st.params)
    gen = torch.Generator(device=dev).manual_seed(501)
    frames = torch.randn(ENC_BATCH, cfg.enc_seq_len, cfg.frontend_dim,
                         device=dev, generator=gen)
    tree = nest(st.views)

    def encode_():
        st.caches["enc_out"].copy_(encode(tree, cfg, frames))

    def serve():
        encode_()
        for t in st.caches["self"]:
            t["k"].zero_()
            t["v"].zero_()
        st.tok.zero_()
        st.pos.zero_()
        out = []
        for _ in range(ENC_NEW):
            decode.run()
            out.append(st.tok.clone())
        return torch.cat(out, dim=1)

    reset_launches()
    encode_()
    torch.cuda.synchronize()
    if dict((k, v) for k, v in LAUNCHES.items() if v) != {
            "flash_attention": cfg.n_enc_layers}:
        raise AssertionError(f"seamless encode launches {dict(LAUNCHES)}")
    enc = _profiled(encode_)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if LAUNCHES["flash_attention"] != cfg.n_enc_layers:
        raise AssertionError(f"seamless serve launches {dict(LAUNCHES)}")
    if tuple(out.shape) != (ENC_BATCH, ENC_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"seamless tokens {out.tolist()}")
    if not bool(torch.isfinite(st.caches["enc_out"]).all()):
        raise AssertionError("seamless: non-finite encoder output")
    st.pos.zero_()     # the profiled ticks write positions 0 .. 3
    tick = _profiled(decode.run)
    return dict(arch=cfg.name, batch=ENC_BATCH, frames=cfg.enc_seq_len,
                new_tokens=ENC_NEW, params=model.layout.size, wall_s=wall,
                tokens_per_s=ENC_BATCH * ENC_NEW / wall, encode=enc,
                decode_tick=tick,
                flash_launches=dict(per_encode=cfg.n_enc_layers,
                                    predicted=cfg.n_enc_layers,
                                    causal=False),
                **_memory())


def phase_families_serve(dev, smi):
    """One model of each new family served at full width on the card, the
    counts set to 0 just before each path's measured run."""
    out = {}
    for name, fn in (("moe", lambda: _engine_serve(dev, FAMILIES[0], N,
                                                   300)),
                     ("vlm", lambda: _vlm_serve(dev)),
                     ("encdec", lambda: _encdec_serve(dev))):
        held = _release_serving()
        out[name] = dict(held_before_gib=held, **fn())
        emit("families_serve", card=smi, path=name, **out[name])
    return out


def _release_serving():
    """Drop the cached step programs and their buffers (``step_buffers``
    is an ``lru_cache``: it would keep a model's params alive into the next
    phase), collect the engines' reference cycles and hand the freed blocks
    back to the card; returns the GiB still allocated."""
    import gc
    import torch
    from repro_torch.launch import serve as lserve

    for cached in (lserve.step_buffers, lserve.serve_step_for,
                   lserve.prefill_step_for):
        cached.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2 ** 30


# the wide_serve phase: deepseek-coder-33b's generate at this batch (its
# weights fit the card once: 62.1 GiB in bf16); minicpm-2b trained plain
# at the train phase's plain shapes (40 layers, one flash launch each a
# step: the backward is plain)
WIDE_BATCH = 4
WIDE_TRAIN = ("minicpm_plain",
              ["--arch", "minicpm-2b", "--steps", "2", "--batch", "4",
               "--seq", "256"],
              {"flash_attention": 2 * 40})


def _generate_wide(dev, arch, seed):
    """``arch`` at full width through ``generate``: its weights initialised
    straight into the step buffers' params (``model.init(..., out=
    st.params)``, one copy on the card) and handed back as ``params``, so
    nothing is copied; batch 4, prompts of 2048 tokens, 16 new tokens,
    ``max_len`` 2064. A cold run (its prefill and decode programs built:
    flash once a layer in the prefill's warm-up and once in its replay),
    then a warm one (once a layer), the same tokens; then each program's
    body eagerly against a replay (tokens equal), and a profiled prefill
    and decode tick."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.capture import WARMUP
    from repro_torch.launch.serve import (generate, prefill_step_for,
                                          serve_step_for, step_buffers)
    from repro_torch.models import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    d = torch.device(dev)
    b, s = WIDE_BATCH, SERVE_SEQ[-1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = step_buffers(model, b, SERVE_MAX_LEN, d)
    model.init(torch.Generator(device=dev).manual_seed(seed), dev,
               out=st.params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ptr, version = st.params.data_ptr(), st.params._version
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (b, s)))
    runs, toks = {}, {}
    for name in ("cold", "warm"):
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks[name] = generate(model, st.params, prompt, SERVE_NEW,
                              SERVE_MAX_LEN, device=dev).cpu()
        runs[name] = dict(wall_s=time.perf_counter() - t1,
                          launches={k: v for k, v in LAUNCHES.items() if v},
                          allocated_gib=torch.cuda.memory_allocated()
                          / 2 ** 30)
    if st.params.data_ptr() != ptr or st.params._version != version:
        raise AssertionError(f"{arch}: generate wrote into the step "
                             "buffers' params")
    predicted = {"cold": {"flash_attention": (WARMUP + 1) * cfg.n_layers},
                 "warm": {"flash_attention": cfg.n_layers}}
    for name, want in predicted.items():
        if runs[name]["launches"] != want:
            raise AssertionError(f"{arch} {name}: launches "
                                 f"{runs[name]['launches']}, predicted {want}")
    out = toks["warm"]
    if tuple(out.shape) != (b, SERVE_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()) or \
            not torch.equal(out, toks["cold"].to(out.dtype)):
        raise AssertionError(f"{arch} tokens {toks}")
    prefill = prefill_step_for(model, b, s, SERVE_MAX_LEN, d)
    decode = serve_step_for(model, b, SERVE_MAX_LEN, d)
    programs = {}
    for name, prog in (("prefill", prefill), ("decode", decode)):
        if not prog.captured or prog.eager_calls != WARMUP:
            raise AssertionError(f"{arch} {name}: captured {prog.captured}, "
                                 f"eager passes {prog.eager_calls}")
        programs[name] = dict(capture_s=prog.capture_s,
                              launches_per_replay=prog.launches)
    # the prefill first: it sets tok and pos for the decode
    versus = {"prefill": _eager_vs_replay(prefill, st.tok, turns=0),
              "decode": _eager_vs_replay(decode, st.tok, (st.tok, st.pos),
                                         turns=0)}
    if not all(v["tokens"]["equal"] for v in versus.values()):
        raise AssertionError(f"{arch}: eager and replayed tokens differ "
                             f"{versus}")
    pre = _profiled(prefill.run)
    tick = _profiled(decode.run)           # positions 2048 .. 2051
    warm = runs["warm"]["wall_s"]
    return dict(arch=cfg.name, params=model.layout.size,
                params_gib=model.layout.size * 2 / 2 ** 30,
                init_seconds=init_s, batch=b, prompt_length=s,
                new_tokens=SERVE_NEW, max_len=SERVE_MAX_LEN, runs=runs,
                tokens_per_s=b * SERVE_NEW / warm, programs=programs,
                eager_vs_replay=versus, prefill=pre, decode_tick=tick,
                flash_launches=dict(cold=runs["cold"]["launches"],
                                    warm=runs["warm"]["launches"][
                                        "flash_attention"],
                                    predicted=predicted),
                **_memory())


def phase_wide_serve(dev, smi):
    """The three dense configs not yet run at full width, the counts set to
    0 just before each path's measured run: nemotron-4-15b behind
    ``ServeEngine`` at N = 1 and deepseek-coder-33b through ``generate``
    (flash's bf16 D = 128 body on a served path: K/V strided views of a
    2064-deep cache), minicpm-2b behind the engine at N = 4, then trained
    plain. Each line holds the memory allocated before the path and its
    peak, which must stay under the card's. Returns flash's D = 128
    launches on the paths' measured runs."""
    out = {}
    for name, fn in (
            ("nemotron_engine",
             lambda: _engine_serve(dev, "nemotron-4-15b", 1, 600,
                                   turns=2)),
            ("deepseek_generate",
             lambda: _generate_wide(dev, "deepseek-coder-33b", 700)),
            ("minicpm_engine",
             lambda: _engine_serve(dev, "minicpm-2b", N, 800))):
        held = _release_serving()
        t0 = time.perf_counter()
        row = fn()
        if not row["peak_allocated_gib"] < row["card_gib"]:
            raise AssertionError(f"{name}: peak {row['peak_allocated_gib']} "
                                 f"GiB, the card {row['card_gib']}")
        out[name] = dict(held_before_gib=held,
                         seconds=time.perf_counter() - t0, **row)
        emit("wide_serve", card=smi, path=name, **out[name])
    _release_serving()
    name, argv, predicted = WIDE_TRAIN
    _train_path(name, argv, predicted, dev, smi, phase="wide_serve")
    _release_serving()
    return (out["nemotron_engine"]["flash_launches"]["warm_wave"]
            + out["deepseek_generate"]["flash_launches"]["warm"])


# the train phase's gradient checks: (name, flash q/K/V shapes and windows
# or SSD shapes) at Hymba-1.5B's and Mamba2-370M's training shapes, batch
# 4 / 8 at 256 tokens, two nodes under vmap
GRAD_FLASH = (("hymba", 4, 25, 5, 256, 64, (0, 1024)),)
GRAD_SSD = (("hymba", 4, 256, 50, 64, 16, 256), ("mamba2", 8, 256, 32, 64,
                                                 128, 256))
# the train phase's paths: (name, CLI arguments, predicted launches). A
# vmapped train step runs one flash and one SSD launch per layer for all N
# nodes (the vmap rules fold the nodes into the batch; the backwards are
# plain PyTorch); a sync scores the params and the candidate (one vmapped
# forward each) and commits in one launch over the f32 value vector.
# Mamba2-370M: 48 SSD layers, no attention; 4 steps in 2 rounds: 4 x 48
# training launches + 2 syncs x 2 scores x 48. Hymba-1.5B: 32 layers, each
# one flash and one SSD launch a step, 2 steps (the second timed alone).
# Granite-moe-3b: 32 layers, one flash launch each a step, 2 steps.
TRAIN_PATHS = (
    ("mamba2_f32_wire",
     ["--arch", "mamba2-370m", "--swarm-nodes", "4", "--sync-every", "2",
      "--steps", "4", "--batch", "8", "--seq", "256"],
     {"ssd_scan": 4 * 48 + 2 * 2 * 48, "fused_merge_all": 2}),
    ("mamba2_int8_wire",
     ["--arch", "mamba2-370m", "--swarm-nodes", "4", "--sync-every", "2",
      "--steps", "4", "--batch", "8", "--seq", "256", "--wire-dtype",
      "int8"],
     {"ssd_scan": 4 * 48 + 2 * 2 * 48, "fused_quant_merge_all": 2}),
    ("hymba_plain",
     ["--arch", "hymba-1.5b", "--steps", "2", "--batch", "4", "--seq",
      "256"],
     {"flash_attention": 2 * 32, "ssd_scan": 2 * 32}),
    ("granite_plain",
     ["--arch", "granite-moe-3b-a800m", "--steps", "2", "--batch", "4",
      "--seq", "256"],
     {"flash_attention": 2 * 32}),
)


def _grad_check(fn, plain, inputs, nodes, tol):
    """vmap(grad) over ``nodes`` of a linear loss through the kernel
    Function ``fn`` against the same through the plain version ``plain``
    (autograd): the max abs gradient error, raising beyond ``tol`` (as
    ``|got - want| <= tol * (1 + |want|)``); then the vmapped forward
    against a per-node loop, bit for bit."""
    import torch
    with torch.no_grad():
        outs = torch.func.vmap(fn)(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for i in range(nodes):
            one = fn(*(t[i] for t in inputs))
            one = one if isinstance(one, tuple) else (one,)
            if not all(torch.equal(a[i], b) for a, b in zip(outs, one)):
                raise AssertionError("vmap fold differs from the node loop")
    gen = torch.Generator(device=outs[0].device).manual_seed(0)
    weights = [torch.randn(o.shape[1:], generator=gen, device=o.device)
               for o in outs]

    def loss(f):
        def inner(*args):
            out = f(*args)
            out = out if isinstance(out, tuple) else (out,)
            return sum(torch.sum(o.float() * w) for o, w in zip(out, weights))
        return inner

    argn = tuple(range(len(inputs)))
    got = torch.func.vmap(torch.func.grad(loss(fn), argnums=argn))(*inputs)
    want = torch.func.vmap(torch.func.grad(loss(plain),
                                           argnums=argn))(*inputs)
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("non-finite gradient")
        if bool(((g - w).abs() > tol * (1 + w.abs())).any()):
            raise AssertionError(f"gradient error {float((g - w).abs().max())}"
                                 f" beyond {tol}")
        err = max(err, float((g - w).abs().max()))
    return err


def phase_train_grads(dev):
    """The flash and SSD Functions (kernel forward, plain backward, vmap
    rule) under torch.func.vmap(grad) over 2 nodes at Hymba-1.5B's and
    Mamba2-370M's training shapes, f32 and bf16, against autograd through
    the plain versions; the folded forward against a per-node loop, bit
    for bit."""
    import functools
    import torch
    from repro_torch.kernels.flash_attention import flash_apply
    from repro_torch.kernels.ref import flash_attention_plain, ssd_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_apply

    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out = {}
    nodes = 2
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        dn = str(dtype).split(".")[-1]
        for name, b, h, hkv, s, d, windows in GRAD_FLASH:
            q = randn(nodes, b, h, s, d).to(dtype)
            k = randn(nodes, b, hkv, s, d).to(dtype)
            v = randn(nodes, b, hkv, s, d).to(dtype)
            for w in windows:
                out[f"flash_{name}_w{w}_{dn}"] = _grad_check(
                    functools.partial(flash_apply, causal=True, window=w),
                    functools.partial(flash_attention_plain, causal=True,
                                      window=w), (q, k, v), nodes, tol)
        for name, b, s, h, p, n, chunk in GRAD_SSD:
            x = randn(nodes, b, s, h, p).to(dtype)
            dt = torch.nn.functional.softplus(randn(nodes, b, s, h) - 2.0)
            a_log = torch.log(torch.linspace(1, 16, h, device=dev)) \
                + randn(nodes, h, scale=0.1)
            bm = randn(nodes, b, s, 1, n, scale=0.5).to(dtype)
            cm = randn(nodes, b, s, 1, n, scale=0.5).to(dtype)
            out[f"ssd_{name}_{dn}"] = _grad_check(
                functools.partial(ssd_apply, chunk=chunk),
                functools.partial(ssd_scan_plain, chunk=chunk),
                (x, dt, a_log, bm, cm), nodes, tol)
    torch.cuda.synchronize()
    emit("train_grads", max_abs_err=out, nodes=nodes,
         tolerance={"float32": 1e-4, "bfloat16": 2e-2},
         tolerance_form="|got - want| <= tol * (1 + |want|)")


# the train_parity phase's smoke variants and each one's launches a step
# (one flash launch a layer, and one SSD launch an SSM layer, in the
# forward; the backwards are plain)
TRAIN_PARITY = (("hymba-1.5b", {"flash_attention": 2, "ssd_scan": 2}),
                ("granite-moe-3b-a800m", {"flash_attention": 2}))


def phase_train_parity(dev):
    """One train step of the hybrid and of the moe smoke variant (f32) on
    the card, the forward through the flash (and SSD) kernels and the
    backward through their Functions and, for the moe, through the
    router's sorted gate values, the index copy into the experts' buffer,
    the gather back and the aux term, against the same step on the CPU
    through the plain versions, from the same init and batch (TF32 off),
    at lr 1e-4 from the first step (no warmup): the loss within 1e-5
    relative; AdamW's moments (0.1·g and 0.05·g² of the clipped gradient)
    of every leaf within 1e-3 of the leaf's largest magnitude; the update
    p − init within 1 % of its norm on the CPU; every param within 2·lr
    (AdamW moves a param whose gradient sits at the rounding floor by up
    to ±lr in either run)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import build_model

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = TrainConfig(warmup_steps=0, max_steps=10, remat=False)
    tol = {"loss_rel": 1e-5, "params_abs": 2 * tc.lr,
           "moments_rel_to_leaf_max": 1e-3, "update_norm_rel": 1e-2}
    try:
        for arch, predicted in TRAIN_PARITY:
            model = build_model(smoke_variant(get_config(arch)))
            step = make_train_step(model, tc)
            p, o = init_train_state(model, torch.Generator().manual_seed(0),
                                    "cpu")
            rng = np.random.default_rng(0)
            toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                                 (4, 65)))
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            res = {}
            reset_launches()
            for d in ("cpu", dev):
                # copies: the step updates its params and moments in place
                moved = {k: v.clone().to(d) for k, v in o.items()}
                pp, oo, m = step(p.clone().to(d), moved, {k: v.to(d)
                                                  for k, v in batch.items()})
                res[d] = (pp.cpu(), {k: oo[k].cpu() for k in ("mu", "nu")},
                          float(m["loss"]))
            launches = {k: v for k, v in LAUNCHES.items() if v}
            (pc, oc, lc), (pg, og, lg) = res["cpu"], res[dev]
            loss_err = abs(lg - lc) / abs(lc)
            p_err = float((pg - pc).abs().max())
            values = model.layout.value_layout
            moment_err = {}
            for key in ("mu", "nu"):
                got, want = values.unflatten(og[key]), values.unflatten(
                    oc[key])
                moment_err[key] = max(
                    float((got[path] - want[path]).abs().max()
                          / want[path].abs().max().clamp(min=1e-30))
                    for path in want)
            update_err = float((pg - pc).norm() / (pc - p).norm())
            if not (loss_err <= tol["loss_rel"]
                    and p_err <= tol["params_abs"]
                    and max(moment_err.values())
                    <= tol["moments_rel_to_leaf_max"]
                    and update_err <= tol["update_norm_rel"]):
                raise AssertionError(
                    f"{arch} train step card vs CPU: loss {loss_err}, "
                    f"params {p_err}, moments {moment_err}, update "
                    f"{update_err}")
            if launches != predicted:
                raise AssertionError(f"{arch} card train step launches "
                                     f"{launches}, predicted {predicted}")
            emit("train_parity", arch=model.cfg.name, lr=tc.lr,
                 loss_rel_err=loss_err, params_max_abs_err=p_err,
                 moment_err_rel_to_leaf_max=moment_err,
                 update_norm_rel_err=update_err, tolerance=tol,
                 launches=launches)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _wide_changed(model, params, dev):
    """True when every wide (f32) leaf of ``params`` [N, P] or [P] differs
    from its initial value somewhere."""
    import torch
    init = model.layout.unflatten(model.init(
        torch.Generator(device=dev).manual_seed(0), dev))
    now = model.layout.unflatten(params)
    return {path: bool((now[path].float() - init[path].float()).abs().max()
                       > 0) for path in sorted(model.layout.wide)}


def _train_path(name, argv, predicted, dev, smi, phase="train"):
    """One path of :func:`phase_train` (or of another ``phase``), its line
    printed under that phase; returns its launch counts."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train

    args = train.parse_args(argv)
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = train.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in LAUNCHES.items() if v}
    if counts != predicted:
        raise AssertionError(f"{name}: launches {counts}, predicted "
                             f"{predicted}")
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    if not peak < torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError(f"{name}: peak {peak} B past the card's memory")
    model, sess = res["model"], res.get("session")
    n = args.swarm_nodes or 1
    walls = res["walls"]
    # the last round (step) alone: the first one's wall holds the
    # allocator's growth and the kernels' first calls
    per_block = walls[-1][1] - walls[-2][1]
    steps_block = walls[-1][0] - walls[-2][0]
    params = sess.state.params if sess is not None else res["params"]
    if not bool(torch.isfinite(model.layout.values(params)).all()):
        raise AssertionError(f"{name}: non-finite params")
    wide = _wide_changed(model, params, dev)
    if not all(wide.values()):
        raise AssertionError(f"{name}: wide leaves unchanged {wide}")
    # one more round (step) under the profiler, on fresh tokens
    rng = np.random.default_rng(1)

    def toks(*shape):
        a = rng.integers(0, model.cfg.vocab_size, shape + (args.seq + 1,))
        return {"tokens": torch.from_numpy(a[..., :-1]).to(dev),
                "labels": torch.from_numpy(a[..., 1:]).to(dev)}

    sync_mem = {}
    if sess is not None:
        block, val = toks(steps_block, n, args.batch), toks(n, 8)
        sync = sess.engine.sync

        def measured_sync(*a, **kw):
            # the sync's own peak, above what the round holds before it
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = sync(*a, **kw)
            torch.cuda.synchronize()
            sync_mem.update(
                held_before_gib=before / 2 ** 30,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                extra_gib=(torch.cuda.max_memory_allocated() - before)
                / 2 ** 30)
            return out

        def fn():
            return sess.round(block, val)["train"]["loss"]
    else:
        batch = toks(args.batch)

        def fn():
            return res["step_fn"](res["params"], res["opt_state"],
                                  batch)[2]["loss"]
    torch.cuda.synchronize()
    # device records only: a round's host ops would make the trace slow to
    # process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses = fn().float().cpu()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    busy = _busy(prof, pwall)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    if sess is not None:
        # one more round, outside the trace, for the sync's memory
        sess.engine.sync = measured_sync
        try:
            sess.round(block, val)
        finally:
            del sess.engine.sync
    tokens = steps_block * n * args.batch * args.seq
    emit(phase, path=name, nvidia_smi=smi, argv=argv, held_before_gib=held,
         values_per_node=model.layout.n_values,
         slots_per_node=model.layout.size, wide_values=model.layout.n_wide,
         wide_changed=wide, steps=res["steps"], wall_s=wall,
         walls=[[st, w] for st, w in walls],
         step_wall_s=per_block / steps_block,
         tokens_per_s=tokens / per_block, profiled_wall_s=pwall,
         device_s_per_step=busy["device_busy_s"] / steps_block,
         busy_share=busy["device_busy_share"],
         kernel_launches_profiled=busy["kernel_launches"],
         top_device=busy["top_device"][:6],
         loss_profiled=[float(x) for x in losses.reshape(-1)],
         peak_allocated_gib=peak / 2 ** 30,
         peak_reserved_gib=reserved / 2 ** 30,
         card_memory_gib=torch.cuda.get_device_properties(0).total_memory
         / 2 ** 30, sync_memory=sync_mem,
         launches=counts, predicted=predicted, sync_log=res["sync_log"])
    return counts


def phase_train(dev, smi):
    """The LM trainer at full width through its CLI entry point
    (``repro_torch.launch.train.run`` on parsed arguments), counts set to 0
    just before each path and read just after: Mamba2-370M as an N = 4
    swarm on the f32 and the int8 wire, Hymba-1.5B and granite-moe-3b each
    as one learner. Each
    path's params and losses finite, its wide (f32) leaves changed, its
    launches equal to the prediction; then one more round (step) of it
    under the profiler for the device time and busy share."""
    all_counts = {}
    for name, argv, predicted in TRAIN_PATHS:
        # the serving phases' cached step programs hold their buffers
        _release_serving()
        for k, v in _train_path(name, argv, predicted, dev, smi).items():
            all_counts[k] = all_counts.get(k, 0) + v
    return all_counts


# the remat phase's paths: (name, arch) at the train phase's plain shapes
# (batch 4, 256 tokens); a step launches each flash / SSD kernel once a
# layer in the forward and, with remat, once more in the recompute
REMAT_PATHS = (("granite_plain", "granite-moe-3b-a800m"),
               ("hymba_plain", "hymba-1.5b"))
REMAT_BATCH, REMAT_SEQ, REMAT_STEPS = 4, 256, 2
# the gradient check's depth (one global-attention layer of Hymba's eight)
REMAT_GRAD_LAYERS = 8


def _parts_err(layout, a, b, atol, chunk=1 << 26):
    """Two slot buffers' values compared part by part (a wide leaf's f32
    value read as f32, never as two 16-bit slots), chunk by chunk on
    ``a``'s device: the max abs difference, and the largest excess over
    ``atol`` plus, in a 16-bit part, one ulp of the value (2^-7 of it in
    bf16) — a value whose update rounds the other way lands one ulp
    apart."""
    err, excess = 0.0, float("-inf")
    for pa, pb in zip(layout.parts(a), layout.parts(b)):
        ulp = 2.0 ** -7 if pa.element_size() == 2 else 0.0
        for i in range(0, pa.shape[-1], chunk):
            x = pa[i:i + chunk].float()
            y = pb[i:i + chunk].to(x.device).float()
            d = (x - y).abs()
            err = max(err, float(d.max()))
            excess = max(excess, float((d - atol - ulp * y.abs()).max()))
    return err, excess


def _remat_moments(cfg, batch, dev):
    """AdamW's first moment (0.1·g) after one step from the seed-0 init,
    remat off and on, of ``cfg`` at its width with its depth cut to
    ``REMAT_GRAD_LAYERS``: in its own bf16 (remat off twice) and in f32
    from the same values (TF32 off). Returns {(dtype, remat, run): {path:
    mu}} on the card."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    cut = cfg.replace(n_layers=REMAT_GRAD_LAYERS)
    m16 = build_model(cut)
    p16, _ = init_train_state(m16, torch.Generator(device=dev).manual_seed(0),
                              dev)
    m32 = build_model(cut.replace(param_dtype="float32",
                                  compute_dtype="float32"))
    p32 = m32.layout.flatten({k: v.float() for k, v in
                              m16.layout.unflatten(p16).items()})
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dt, model, p, remat, run in (
                ("bf16", m16, p16, False, 0), ("bf16", m16, p16, False, 1),
                ("bf16", m16, p16, True, 0), ("f32", m32, p32, False, 0),
                ("f32", m32, p32, True, 0)):
            step = make_train_step(model, TrainConfig(
                remat=remat, warmup_steps=0, max_steps=10))
            q = p.clone()
            _, o, _ = step(q, adamw_init(model.layout.parts(q)), batch)
            out[dt, remat, run] = model.layout.value_layout.unflatten(
                o["mu"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _leaf_rel_err(got, want):
    """The largest per-leaf max |got − want| over the leaf's largest
    magnitude, of two {path: tensor} dicts."""
    return max(float((got[k].float() - w.float()).abs().max()
                     / w.float().abs().max().clamp(min=1e-30))
               for k, w in want.items())


def _remat_run(model, remat, batches, dev, ref=None, atol=0.0):
    """``REMAT_STEPS`` steps of ``make_train_step(model, TrainConfig(remat=
    remat))`` from the seed-0 init: the last step's wall, the peak memory
    over the steps (above what was held before) and the first step's
    launches; the first step's loss and params, kept on the host (``ref``
    None) or held against ``ref``'s."""
    import gc
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    p, o = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                            dev)
    step = make_train_step(model, TrainConfig(remat=remat, warmup_steps=0,
                                              max_steps=10))
    walls, first = [], {}
    for k, batch in enumerate(batches):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step(p, o, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if k == 0:
            launches = {name: v for name, v in LAUNCHES.items() if v}
            first["loss"] = m["loss"].float().cpu()
            if ref is None:
                first["params"] = p.cpu()
            else:
                first["params_err"] = _parts_err(model.layout, p,
                                                 ref["params"], atol)
    out = dict(step_walls_s=walls, launches_first_step=launches,
               peak_allocated_gib=(torch.cuda.max_memory_allocated() - held)
               / 2 ** 30,
               peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
               params_gib=p.numel() * p.element_size() / 2 ** 30)
    del p, o, step
    return out, first


def phase_remat(dev, smi):
    """Activation checkpointing (``TrainConfig(remat=True)``,
    `repro_torch.models.remat`) at full width, beside ``remat=False`` in
    the same call: granite-moe-3b and Hymba-1.5B, batch 4 at 256 tokens,
    two steps each from the same init and batches. Peak allocated (above
    what was held before) and reserved, the second step's wall, the first
    step's flash/SSD launches (with remat twice a layer: the forward and
    the recompute); the first step's loss bit-equal and the params after
    it within 2·lr (AdamW moves a param whose gradient sits at the
    rounding floor by up to ±lr in either run) plus, for the bf16 values,
    one bf16 ulp of the value (a value whose update rounds the other way).
    The gradient, through the first step's AdamW first moment (0.1·g), at
    the same width cut to ``REMAT_GRAD_LAYERS`` layers (the kernels run in
    the recompute): in f32 (TF32 off) remat on against off within 1e-3 of
    each leaf's largest magnitude (``phase_train_parity``'s tolerance). In
    bf16 the two differ by the order the backward sums in: reported, beside
    the plain step run twice and each one's distance to the f32 moment
    from the same values."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    _release_serving()
    lr = 1e-4
    for name, arch in REMAT_PATHS:
        model = build_model(get_config(arch))
        layers = model.cfg.n_layers
        rng = np.random.default_rng(2)
        batches = []
        for _ in range(REMAT_STEPS):
            a = torch.from_numpy(rng.integers(
                0, model.cfg.vocab_size, (REMAT_BATCH, REMAT_SEQ + 1)))
            batches.append({"tokens": a[:, :-1].to(dev),
                            "labels": a[:, 1:].to(dev)})
        res = {}
        res[False], plain = _remat_run(model, False, batches, dev)
        res[True], first = _remat_run(model, True, batches, dev, plain,
                                      2 * lr)
        per_layer = {False: 1, True: 2}
        for remat in (False, True):
            want = {"flash_attention": per_layer[remat] * layers}
            if model.cfg.family in ("ssm", "hybrid"):
                want["ssd_scan"] = per_layer[remat] * layers
            if res[remat]["launches_first_step"] != want:
                raise AssertionError(
                    f"{name} remat={remat}: launches "
                    f"{res[remat]['launches_first_step']}, predicted {want}")
        loss_equal = bool(torch.equal(first["loss"], plain["loss"]))
        p_err, excess = first["params_err"]
        plain_loss = float(plain["loss"])
        del plain
        mu = _remat_moments(model.cfg, batches[0], dev)
        f32, b16 = mu["f32", False, 0], mu["bf16", False, 0]
        mu_err = {"f32": _leaf_rel_err(mu["f32", True, 0], f32),
                  "bf16": _leaf_rel_err(mu["bf16", True, 0], b16),
                  "bf16_plain_twice": _leaf_rel_err(mu["bf16", False, 1],
                                                    b16),
                  "bf16_plain_vs_f32": _leaf_rel_err(b16, f32),
                  "bf16_remat_vs_f32": _leaf_rel_err(mu["bf16", True, 0],
                                                     f32)}
        del f32, b16
        del mu
        if not loss_equal or not excess <= 0 or not mu_err["f32"] <= 1e-3:
            raise AssertionError(f"{name}: remat first-step loss "
                                 f"{float(first['loss'])}, without remat "
                                 f"{plain_loss}; params {p_err}, {excess} "
                                 f"beyond 2·lr + one bf16 ulp; first "
                                 f"moments {mu_err} of the leaf max")
        emit("remat", card=smi, path=name, arch=arch, batch=REMAT_BATCH,
             seq=REMAT_SEQ, layers=layers, loss_bit_equal=loss_equal,
             first_loss=float(first["loss"]),
             mu_err_rel_to_leaf_max=mu_err, mu_layers=REMAT_GRAD_LAYERS,
             mu_tolerance={"f32": 1e-3},
             params_max_abs_err=p_err,
             params_tolerance="2·lr + one bf16 ulp of the value",
             params_excess_over_tolerance=excess, lr=lr,
             plain={k: v for k, v in res[False].items()},
             remat={k: v for k, v in res[True].items()},
             peak_allocated_saved_gib=res[False]["peak_allocated_gib"]
             - res[True]["peak_allocated_gib"],
             step_wall_ratio=res[True]["step_walls_s"][-1]
             / res[False]["step_walls_s"][-1])
        del model


# the host phase: rounds of sync_every local steps, per merge/topology
HOST_ROUNDS, HOST_T = 3, 2
HOST_PATHS = (("fedavg", "full", "fused_merge_all"),
              ("fisher", "ring", "fused_merge_all_imp"))


# values of the local-steps half allowed past the per-value limit, per
# value held (AdamW turns a gradient at the rounding floor into ±lr)
HOST_STRAY = 1e-5


def _host_params_err(got, want, layout, what, start=None, lr_sum=0.0):
    """``tests/torch_parity.check_flat``: within 1e-4 + 1e-4·|want|, the
    head's FC biases (fed to a batch-statistics BN, so their gradient is
    rounding noise that AdamW turns into ±lr steps) within 2e-3. After
    local steps from ``start`` (the unvmapped and the vmapped convolutions
    round differently) at most ``HOST_STRAY`` of the values past that
    limit, each within twice the steps' summed lr (a value whose gradient
    sits at the rounding floor moves by ±lr a step in either run, as
    ``phase_train_parity`` allows 2·lr), and each node's update p − start
    (the biases aside) within 1 % of the engine's norm (a skipped step or
    another batch moves it by the whole norm). Returns the max abs
    differences (the rest, the biases), how many values are past the
    limit, and the largest update error."""
    import numpy as np
    noise = np.zeros(got.shape[1], bool)
    for leaf in layout.leaves:
        if leaf.path in ("head.fc1.b", "head.fc2.b"):
            noise[leaf.offset:leaf.offset + leaf.size] = True
    err = np.abs(got - want)[:, ~noise]
    past = err > 1e-4 + 1e-4 * np.abs(want[:, ~noise])
    n_past, upd = int(past.sum()), 0.0
    ok = n_past == 0
    if start is not None:
        ok = (n_past <= HOST_STRAY * err.size
              and not (err[past] > 2 * lr_sum).any())
        for i in range(got.shape[0]):
            dg = got[i, ~noise].astype(np.float64) - start[i, ~noise]
            dw = want[i, ~noise].astype(np.float64) - start[i, ~noise]
            norm = np.linalg.norm(dw)
            e = (np.linalg.norm(dg - dw) / norm if norm
                 else float(np.abs(dg).max() > 0))
            upd = max(upd, float(e))
        ok = ok and upd <= 1e-2
    bias = np.abs(got - want)[:, noise]
    if not ok or (bias > 2e-3).any():
        raise AssertionError(f"{what}: host vs engine params "
                             f"{float(err.max())}, {n_past} past 1e-4 "
                             f"(biases {float(bias.max())}), update "
                             f"{upd}, lr summed {lr_sum}")
    return float(err.max()), float(bias.max()), n_past, upd


def _clone(v):
    """A copy of a tensor, or of a dict of them, that owns its storage (a
    session updates its state in place)."""
    import torch
    if isinstance(v, dict):
        return {k: _clone(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_clone(x) for x in v)
    return v.clone() if isinstance(v, torch.Tensor) else v


def _cloned_state(st):
    """A copy of a session state whose tensors own their storage."""
    import dataclasses
    return dataclasses.replace(st, **{f.name: _clone(getattr(st, f.name))
                                      for f in dataclasses.fields(st)})


def phase_host(dev, smi):
    """The host backend (``SwarmSession(..., backend="host")``,
    `repro_torch.core.swarm`) at the paper CNN's full width (224², feat_dim
    1152), N = 4, on the histo shards: fedavg/full and fisher/ring, three
    rounds of two local steps each, node 3 leaving for the second round and
    rejoining for the third, against the engine backend on the same seed,
    data and membership (cuDNN TF32 off, deterministic), each round from
    the engine's state and held against the engine's in two halves: the
    local steps, then the sync (propose, the host-side gate, the commit)
    from the same post-step state; params within the session tests'
    tolerances after each half (after the local steps, a few strays
    within twice the steps' summed lr and each node's update within 1 %
    of the engine's: ``_host_params_err``), gate bits equal where the
    engine's margin |merged − 0.8·local| clears 1e-4. (Whole rounds drift further
    apart: the fisher merge's ratio of Δθ² masses amplifies the local
    steps' differences.) The counts are set
    to 0 just before each host round: one ``fused_merge_all`` launch a
    sync, the plain form for fedavg and the importance form for fisher.
    Then one more host round, timed (the last path's under the profiler:
    its device-busy share)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import SwarmConfig, TrainConfig
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.core.flat import FlatLayout
    from repro_torch.data import make_histo_dataset, paper_splits, shard_to_nodes
    from repro_torch.experiments import histo
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.optim import adamw_init, make_schedule

    cudnn = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for merge, topology, form in HOST_PATHS:
            cfg = SwarmConfig(n_nodes=N, sync_every=HOST_T,
                              topology=topology, merge=merge,
                              lora_only=False, val_threshold=0.8)
            ecfg = histo.HistoExperimentConfig(
                n_train=256, image_size=PAPER_FULL.image_size, batch_size=16,
                steps=(HOST_ROUNDS + 1) * HOST_T, swarm=cfg,
                growth=PAPER_FULL.growth, stem=PAPER_FULL.stem,
                feat_dim=PAPER_FULL.feat_dim, hidden=PAPER_FULL.hidden,
                n_blocks=PAPER_FULL.n_blocks,
                layers_per_block=PAPER_FULL.layers_per_block)
            x, y = make_histo_dataset(ecfg.n_train, size=ecfg.image_size,
                                      noise=ecfg.noise,
                                      class_probs=ecfg.class_probs, seed=3)
            shards = shard_to_nodes(x, y, paper_splits(ecfg.n_train), seed=3)
            xs, ys, val = _round_data(ecfg, shards, HOST_ROUNDS + 1, HOST_T)
            xs, ys = xs.to(dev), ys.to(dev)
            val = tuple(torch.from_numpy(v).to(dev) for v in val)
            vlist = [tuple(v[i] for v in val) for i in range(N)]
            eng = _session(dev, cfg, ecfg, shards)
            model = histo._model(ecfg)
            layout = FlatLayout.of_module(model)
            step, _ = histo._make_model_fns(ecfg, model, layout)
            veval = histo._make_eval_fn(cfg, model, layout)

            def eval_one(p, v):
                return float(veval(p[None], tuple(t[None] for t in v))[0])

            # the protocol's schedule (`experiments.histo._make_model_fns`)
            sched = make_schedule(TrainConfig(
                lr=ecfg.lr, warmup_steps=20, max_steps=ecfg.steps,
                weight_decay=1e-4, schedule="cosine"))
            flat = layout.flatten(histo._init_params(ecfg, model))
            host = histo.SwarmSession(
                cfg, step, eval_one, params=flat, opt_state=adamw_init(flat),
                data_sizes=[len(y) for _, y in shards], layout=layout,
                backend="host", device=dev)
            # each round from the engine's state, in two halves: the local
            # steps (the host's unvmapped against the engine's vmapped:
            # rounding apart), then the sync from the engine's post-step
            # state (the host loop's propose, host gate and commit against
            # the engine's on the same inputs); the counts are set to 0
            # just before each host round and read just after it
            launches, walls, hlogs, errs = {}, [], [], []
            for r in range(HOST_ROUNDS):
                for sess in (eng, host):
                    if r == 1:
                        sess.leave(3)
                    if r == 2:
                        sess.join(3)
                host.load_state(_cloned_state(eng.state))
                hb = [[(xs[r, k, i], ys[r, k, i]) for i in range(N)]
                      for k in range(HOST_T)]
                count = int(eng.state.opt_state["count"][0])
                start = eng.state.params.cpu().numpy()
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                host.run_local(hb)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eng.run_local((xs[r], ys[r]))
                lr_sum = sum(float(sched(torch.tensor(count + k)))
                             for k in range(HOST_T))
                local_err = _host_params_err(
                    host.state.params.cpu().numpy(),
                    eng.state.params.cpu().numpy(), layout,
                    f"{merge} round {r} local steps", start, lr_sum)
                host.load_state(_cloned_state(eng.state))
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                hlogs.append(host.round([], vlist))
                torch.cuda.synchronize()
                walls.append((t1 - t0) + (time.perf_counter() - t2))
                for k, v in LAUNCHES.items():
                    if v:
                        launches[k] = launches.get(k, 0) + v
                committed, elog = eng._sync(val)
                eng._commit(committed)
                del committed
                ml = elog["metric_local"].cpu().numpy()
                mm = elog["metric_merged"].cpu().numpy()
                clear = np.abs(mm - 0.8 * ml) >= 1e-4
                eg = elog["gates"].cpu().numpy()
                if not np.array_equal(np.asarray(hlogs[r]["gates"])[clear],
                                      eg[clear]):
                    raise AssertionError(f"{merge} round {r}: host gates "
                                         f"{hlogs[r]['gates']}, engine {eg}")
                sync_err = _host_params_err(
                    host.state.params.cpu().numpy(),
                    eng.state.params.cpu().numpy(), layout,
                    f"{merge} round {r} sync")
                errs.append(dict(local_steps=local_err, sync=sync_err))
            if launches != {form: HOST_ROUNDS}:
                raise AssertionError(f"host {merge}: launches {launches}, "
                                     f"want {HOST_ROUNDS} {form}")
            gates = [lg["gates"] for lg in hlogs]
            hb = [[(xs[-1, k, i], ys[-1, k, i]) for i in range(N)]
                  for k in range(HOST_T)]
            torch.cuda.synchronize()
            # the last path's round alone under the profiler (its host ops
            # take seconds to process; the paths share the host loop)
            profiled = (merge, topology) == HOST_PATHS[-1][:2]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) if profiled \
                    else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                host.round(hb, vlist)
                torch.cuda.synchronize()
                pwall = time.perf_counter() - t0
            busy = _busy(prof, pwall) if profiled else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.round((xs[-1], ys[-1]), val)
            torch.cuda.synchronize()
            eng_wall = time.perf_counter() - t0
            emit("host", card=smi, merge=merge, topology=topology, nodes=N,
                 params_per_node=layout.size, image_size=ecfg.image_size,
                 rounds=HOST_ROUNDS, steps_per_round=HOST_T,
                 membership="leave(3) for round 1, join(3) for round 2",
                 gates=gates, params_err_vs_engine=errs,
                 launches=launches, round_walls_s=walls,
                 engine_round_wall_s=eng_wall,
                 **{"host_round_wall_s": pwall} if not profiled else dict(
                     profiled_wall_s=pwall,
                     device_busy_s=busy["device_busy_s"],
                     device_busy_share=busy["device_busy_share"],
                     kernel_launches_profiled=busy["kernel_launches"],
                     host_ops_profiled=busy["host_ops"],
                     top_host=busy["top_host"][:5],
                     top_device=busy["top_device"][:5]))
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn



# the examples phase: the twins of the reference's examples, run through
# their ``main`` at the reference's default sizes (examples/torch_*.py),
# the §4 protocol's depth cut from its 400 steps (a sync every 20) to one
# round of 20, to keep the script well inside its time limit (phase
# ``histo`` runs the protocol at paper width over rounds)
EXAMPLE_HISTO_STEPS, EXAMPLE_HISTO_SYNC = 20, 20


def _example(script):
    """An example script of the checkout as a module (``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "example_" + Path(script).stem, ROOT / "examples" / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _finite_row(row, what):
    if not all(_all_finite(v) for v in row.values()) or \
            not 0.0 <= row["auc"] <= 1.0:
        raise AssertionError(f"{what}: report row {row}")


def phase_examples(dev, smi):
    """The three example twins at the reference's default sizes (the
    protocol at ``EXAMPLE_HISTO_STEPS``), run by
    ``_examples_run`` in a process of their own, as a user runs an
    example: in this process, after the paths above, the eager protocol
    ran at half its speed on an H100 (239.6 s against 124-148 s alone).
    Emits the child's rows;
    returns (the launches of the three runs, the engine run's flash
    launches: its D = 16 body's)."""
    import tempfile

    held = _release_serving()
    tmp = tempfile.mkdtemp(prefix="examples_")
    wall, (out,) = _gossip_spawn(_examples_child, tmp, dev, "examples",
                                 world=1)
    emit("examples", card=smi, held_before_gib=held, child_wall_s=wall,
         **out["rows"])
    return out["counts"], out["d16"]


def _examples_child(rank, world, init, tmp, dev):
    """The spawned process of ``phase_examples`` (``_gossip_spawn``'s
    signature; ``init`` unused): ``_examples_run``, its result saved to
    ``tmp/examples0.pt``."""
    import torch
    rows, counts, d16 = _examples_run(dev)
    torch.save(dict(rows=rows, counts=counts, d16=d16),
               f"{tmp}/examples{rank}.pt")


def _examples_run(dev):
    """The three example twins at the reference's default sizes (the
    protocol at EXAMPLE_HISTO_STEPS), each through its ``main`` on the card, the counts set to 0 just before each
    run (each histo scenario's too) and read just after: the engine
    session (3 rounds, ``leave(3)``, 3 more, ``join(3)``; flash's f32 D = 16
    body and one ``fused_merge_all`` a round), the §4 protocol (3
    scenarios of EXAMPLE_HISTO_STEPS steps, in a temporary working
    directory; a commit every EXAMPLE_HISTO_SYNC steps, nothing else
    launched) and the serving demo (4 families,
    then the consensus ensemble; flash and ``ssd_scan``). Each twin's
    seconds and peak memory. Returns (its rows, the launches of the three
    runs, the engine run's flash launches)."""
    import os
    import tempfile
    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels import LAUNCHES, reset_launches

    counts, rows = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rows[name] = dict(seconds=time.perf_counter() - t0,
                          launches={k: v for k, v in LAUNCHES.items() if v},
                          # the flags this run had, in this process
                          matmul_allow_tf32=torch.backends.cuda.matmul
                          .allow_tf32,
                          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                          **_memory())
        for k, v in LAUNCHES.items():
            counts[k] = counts.get(k, 0) + v
        return out

    # the engine session: flash at [32, 4, 32, 16] f32 (the train step's and
    # the gate's forward, one launch a layer a call), a commit a round
    eng = _example("torch_engine_swarm.py")
    out = run("engine", lambda: eng.main([]))
    rounds = 2 * eng.ROUNDS
    gates, left = out["gates"], out["left"]["gates"]
    if gates.shape != (eng.ROUNDS, eng.N_NODES) or \
            left.shape != (eng.ROUNDS, eng.N_NODES) or left[:, 3].any():
        raise AssertionError(f"engine example gates {gates} / {left}")
    if int(out["session"].state.round) != rounds or \
            not out["session"].active.all():
        raise AssertionError("engine example: rounds or membership")
    if not _all_finite(out["losses"]) or not _all_finite(
            out["left"]["losses"]):
        raise AssertionError("engine example: non-finite losses")
    got = rows["engine"]["launches"]
    d16 = got.get("flash_attention", 0)
    # flash a layer a call: 30 local steps, and the gate's local and merged
    # scores every round
    flash_predicted = eng.CFG.n_layers * (rounds * eng.SYNC_EVERY
                                          + 2 * rounds)
    if got.get("fused_merge_all") != rounds or d16 != flash_predicted or \
            set(got) != {"fused_merge_all", "flash_attention"}:
        raise AssertionError(f"engine example launches {got}, flash "
                             f"predicted {flash_predicted}")
    rows["engine"].update(
        rounds=rounds, gates=gates.tolist(), left_gates=left.tolist(),
        last_losses=out["left"]["losses"][-1, -1].tolist(),
        flash_predicted=flash_predicted,
        flash_q=[eng.N_NODES * eng.BATCH, eng.CFG.n_heads, eng.SEQ,
                 eng.CFG.head_dim])
    del out

    # the protocol, in a temporary working directory (its JSON goes to
    # experiments/histo_torch/ under it)
    histo = _example("torch_histopathology_swarm.py")
    per = []
    inner = histo.run_experiment

    def counted(cfg, **kw):
        reset_launches()
        r = inner(cfg, **kw)
        torch.cuda.synchronize()
        per.append({k: v for k, v in LAUNCHES.items() if v})
        for k, v in LAUNCHES.items():
            counts[k] = counts.get(k, 0) + v
        return r

    histo.run_experiment = counted
    tmp, cwd = tempfile.mkdtemp(prefix="histo_example_"), os.getcwd()
    os.chdir(tmp)
    try:
        run("histo", lambda: histo.main(
            ["--steps", str(EXAMPLE_HISTO_STEPS)]))
        names = sorted(os.listdir(histo.OUT))
        results = {n: json.loads(Path(histo.OUT, n).read_text())
                   for n in names}
    finally:
        os.chdir(cwd)
    rows["histo"]["launches"] = per
    want = {"fused_merge_all": EXAMPLE_HISTO_STEPS // EXAMPLE_HISTO_SYNC}
    if names != ["scarcity25.json", "scarcity5.json", "unbalanced.json"] or \
            per != [want] * 3:
        raise AssertionError(f"histo example: files {names}, launches {per}")
    report = {}
    for n, r in results.items():
        reps = [r["centralized"]] + r["local"] + r["swarm"]
        if len(reps) != 9:
            raise AssertionError(f"histo example {n}: {len(reps)} rows")
        for rep in reps:
            _finite_row(rep, n)
        report[n[:-5]] = dict(
            sizes=r["config"]["sizes"],
            centralized_auc=r["centralized"]["auc"],
            local_auc=[x["auc"] for x in r["local"]],
            swarm_auc=[x["auc"] for x in r["swarm"]],
            recovery=r["recovery"],
            last_gates=r["sync_log"][-1]["gates"])
    rows["histo"].update(scenarios=report)

    # the serving demo: 4 families through generate / the decode loop, then
    # the consensus ensemble behind ServeEngine
    serve = _example("torch_serve_demo.py")
    out = run("serve", lambda: serve.main([]))
    for arch in serve.ARCHS:
        tok = out[arch]["tokens"]
        vocab = smoke_variant(get_config(arch)).vocab_size
        if tuple(tok.shape) != (serve.BATCH, serve.MAX_NEW) or not bool(
                ((tok >= 0) & (tok < vocab)).all()):
            raise AssertionError(f"serve example {arch}: tokens {tok}")
    reqs = out["ensemble"]["requests"]
    if len(reqs) != 6 or any(r.status != "done" or len(r.tokens) != 8
                             for r in reqs):
        raise AssertionError(f"serve example ensemble: {reqs}")
    got = rows["serve"]["launches"]
    if not got.get("flash_attention", 0) > 0 or \
            not got.get("ssd_scan", 0) > 0:
        raise AssertionError(f"serve example launches {got}")
    rows["serve"].update(
        ms_per_token={a: out[a]["seconds"] / serve.MAX_NEW * 1e3
                      for a in serve.ARCHS},
        ensemble_s=out["ensemble"]["seconds"],
        ensemble_builds=out["ensemble"]["total_traces"])
    return rows, counts, d16


def _all_finite(a) -> bool:
    import numpy as np
    return bool(np.isfinite(np.asarray(a)).all())

# the gossip phase (``phase_gossip``). (a) on a world of one NCCL rank, the
# paper CNN at full width: (name, merge, topology, wire, absent node)
GOSSIP_A = (("fedavg_full_f32", "fedavg", "full", "f32", None),
            ("fisher_ring_int8", "fisher", "ring", "int8", None),
            ("fedavg_dynamic_int8_absent3", "fedavg", "dynamic", "int8", 3))
# (c) a world of 4 gloo ranks on the one card, one node each: every
# schedule of the slice on every wire it takes, (schedule, merge, topology,
# wire); each is the one the cost model picks for its setting
GOSSIP_C = tuple(
    [(s, m, t, w) for s, m, t in (("ring_ppermute", "fedavg", "ring"),
                                  ("ring_topo_ppermute", "fisher", "ring"),
                                  ("gathered_rows", "fedavg", "dynamic"),
                                  ("gathered_topo_stack", "fisher",
                                   "dynamic"))
     for w in ("f32", "bf16", "int8")]
    + [("fedavg_psum", "fedavg", "full", "f32"),
       ("fisher_psum", "fisher", "full", "f32"),
       ("fedavg_psum_q8", "fedavg", "full", "int8"),
       ("fisher_psum_q8", "fisher", "full", "int8")])
GOSSIP_WORLD = 4
# (d) the two-level mesh (2 pods × 2 nodes) on the 4 gloo ranks: (name,
# merge, cross_pod_cost) of each setting; the pod ring mixes at this self
# weight (asymmetric: s·own pod + (1 − s)·the other)
GOSSIP_D = (("hier_fedavg_ring_q8", "fedavg", 10.0),
            ("hier_fisher_ring_q8", "fisher", 10.0),
            ("ring_ppermute", "fedavg", 5.0),
            ("ring_topo_ppermute", "fisher", 5.0))
GOSSIP_D_SW = 0.7
GOSSIP_D_PODS = (2, 2)
# the fault plan of (d): rounds, the crashed node's (node, at, rejoin), the
# preempt's round; run for each of these settings of GOSSIP_D with its
# local step: the CNN's AdamW steps ("train"), or the reference's fault
# tests' decay θ ← 0.999·θ ("decay"; `tests/test_faults_spmd.py`), for the
# fisher form, whose int8 mass stream diverges under the CNN's steps (its
# Σ (F+eps) crosses the wire as int8 deltas, as in the reference; where F
# is small against its block's largest value the reconstruction falls to
# 0 or below and the reference's clamp at 1e-30 turns the ratio huge).
# Four rounds: the crash at 1, the rejoin and the preempt at 3
GOSSIP_D_ROUNDS = 4
GOSSIP_D_CRASH = (1, 1, 3)
GOSSIP_D_PREEMPT = 3
GOSSIP_D_PLANS = {"hier_fedavg_ring_q8": "train",
                  "hier_fisher_ring_q8": "decay",
                  "ring_ppermute": "train"}
# syncs that only advance a stateful wire (the params unchanged) before the
# compared commit: the reference's settled regime (its mesh-wire tests)
GOSSIP_SETTLE = 6
GOSSIP_TOL = 1e-5
GOSSIP_TIMEOUT = 600


def _gossip_ecfg(cfg):
    from repro_torch.configs.paper_histo import PAPER_FULL
    from repro_torch.experiments import histo
    return histo.HistoExperimentConfig(
        n_train=256, image_size=PAPER_FULL.image_size, batch_size=16,
        steps=4, swarm=cfg, growth=PAPER_FULL.growth, stem=PAPER_FULL.stem,
        feat_dim=PAPER_FULL.feat_dim, hidden=PAPER_FULL.hidden,
        n_blocks=PAPER_FULL.n_blocks,
        layers_per_block=PAPER_FULL.layers_per_block)


def _gossip_cfg(merge, topology, wire):
    from repro_torch.configs.base import SwarmConfig
    # every gate opens (threshold 0) but an absent node's
    return SwarmConfig(n_nodes=N, sync_every=2, topology=topology,
                       merge=merge, lora_only=False, val_threshold=0.0,
                       wire_dtype=wire, wire_block=WIRE_BLOCK)


def _gossip_base(dev):
    """The CNN at full width on the histo shards, and a start state: the
    shared init after two engine-backend local steps on a fisher/ring
    session (the nodes' params differ, their Δθ² mass is non-zero)."""
    import torch
    from repro_torch.core.flat import FlatLayout
    from repro_torch.data import (make_histo_dataset, paper_splits,
                                  shard_to_nodes)
    from repro_torch.experiments import histo

    cfg = _gossip_cfg("fisher", "ring", "f32")
    ecfg = _gossip_ecfg(cfg)
    x, y = make_histo_dataset(ecfg.n_train, size=ecfg.image_size,
                              noise=ecfg.noise, class_probs=ecfg.class_probs,
                              seed=5)
    shards = shard_to_nodes(x, y, paper_splits(ecfg.n_train), seed=5)
    xs, ys, val = _round_data(ecfg, shards, 2, 2)
    xs, ys = xs.to(dev), ys.to(dev)
    val = tuple(torch.from_numpy(v).to(dev) for v in val)
    eng = _session(dev, cfg, ecfg, shards)
    eng.run_local((xs[0], ys[0]))
    model = histo._model(ecfg)
    layout = FlatLayout.of_module(model)
    return dict(params=eng.state.params.clone(),
                stats=eng.state.stats.clone(), val=val, xs=xs, ys=ys,
                sizes=[float(len(y)) for _, y in shards], layout=layout,
                model=model, ecfg=ecfg)


def _gossip_state(base, merge, wire):
    """A setting's start state: the params (bf16-representable for the bf16
    wire, whose stateless cast is then exact) and the importance mass
    (None for mean/fedavg; zero on the int8 wire, where the engine backend
    round-trips the mass statelessly and only zero mass crosses exactly)."""
    import torch
    p = base["params"]
    if wire == "bf16":
        p = p.to(torch.bfloat16).to(torch.float32)
    st = None
    if merge in ("fisher", "gradmatch"):
        st = (torch.zeros_like(base["stats"]) if wire == "int8"
              else base["stats"])
    return p, st


def _gossip_commit(engine, params, val, active, stats, settle):
    """``settle`` syncs that only advance the wire (at least one, which
    also warms the path up), then the compared commit from the same
    params: (committed, log, the commit sync's synchronized wall)."""
    import torch
    wire = engine._auto_wire(params, None)
    for _ in range(max(settle, 1)):
        _, log = engine.sync(params, val, active, stats=stats, wire=wire)
        wire = log.get("wire", wire)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    committed, log = engine.sync(params, val, active, stats=stats, wire=wire)
    torch.cuda.synchronize()
    return committed, log, time.perf_counter() - t0


def _engine_reference(base, veval, merge, topology, wire, active):
    """The engine backend's commit of a setting from its start state."""
    from repro_torch.core.engine import SwarmEngine
    cfg = _gossip_cfg(merge, topology, wire)
    p, st = _gossip_state(base, merge, wire)
    eng = SwarmEngine(cfg, None, veval, data_sizes=base["sizes"],
                      layout=base["layout"])
    return _gossip_commit(eng, p, base["val"], active, st,
                          0 if wire == "f32" else GOSSIP_SETTLE)


def _gossip_hold(got, want, gates_g, gates_e, what, cast_mass=False):
    """A gossip commit against the engine backend's: gates equal, params
    within 1e-5 (rtol and atol). ``cast_mass``: the fisher side channel
    (F⊙θ ⊕ F) on the bf16 wire, cast to bf16 as products (the reference's
    stateless cast), which the engine's error-fed bf16 wire does not do:
    within its bf16 rounding, 2^-8 of the largest value. Returns the max
    abs difference."""
    import torch
    if not torch.equal(gates_g.cpu(), gates_e.cpu()):
        raise AssertionError(f"gossip {what}: gates {gates_g} vs {gates_e}")
    diff = (got - want).abs()
    err = float(diff.max())
    if cast_mass:
        lim = 2.0 ** -8 * float(want.abs().max())
        if err > lim:
            raise AssertionError(f"gossip {what}: {err} from the engine "
                                 f"backend's (limit {lim})")
    elif bool((diff > GOSSIP_TOL * (1 + want.abs())).any()):
        raise AssertionError(f"gossip {what}: params {err} from the engine "
                             "backend's")
    return err


def _gossip_world1(dev, smi, base):
    """(a) The paper CNN on a world of one NCCL rank (4 nodes a rank): a
    gossip session round per setting (no kernel launches: the gossip
    commit is the where-select), then from its state the settled commit
    against the engine backend's."""
    import torch
    from repro_torch.core.session import SwarmSession
    from repro_torch.experiments import histo
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.optim import adamw_init

    mesh, axis = make_swarm_mesh(N)
    model, layout, ecfg = base["model"], base["layout"], base["ecfg"]
    step, _ = histo._make_model_fns(ecfg, model, layout)
    flat = layout.flatten(histo._init_params(ecfg, model)).to(dev)
    for name, merge, topology, wire, absent in GOSSIP_A:
        cfg = _gossip_cfg(merge, topology, wire)
        veval = histo._make_eval_fn(cfg, model, layout)
        sess = SwarmSession(cfg, step, veval,
                            params=list(base["params"].unbind(0)),
                            opt_state=adamw_init(flat),
                            data_sizes=base["sizes"], layout=layout,
                            device=dev, backend="gossip", mesh=mesh,
                            axis=axis)
        if absent is not None:
            sess.leave(absent)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log = sess.round((base["xs"][1], base["ys"][1]), base["val"])
        torch.cuda.synchronize()
        round_wall = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        if launches:
            raise AssertionError(f"gossip {name}: the round launched "
                                 f"{launches}; its commit is the select")
        round_bytes = sess.counted_sync_bytes
        st0 = sess.state
        state = dict(base, params=st0.params.clone(),
                     stats=None if st0.stats is None else st0.stats.clone())
        p, st = _gossip_state(state, merge, wire)
        settle = 0 if wire == "f32" else GOSSIP_SETTLE
        got, glog, gwall = _gossip_commit(sess.engine, p, base["val"],
                                          st0.active, st, settle)
        want, elog, ewall = _engine_reference(state, veval, merge, topology,
                                              wire, st0.active)
        err = _gossip_hold(got, want, glog["gates"], elog["gates"], name)
        emit("gossip_a", setting=name, card=smi, world=1, backend="nccl",
             nodes=N, params_per_node=layout.size,
             schedule=sess.sync_schedule.name,
             describe=sess.sync_schedule.describe(sess.payload_params),
             mass="zero" if st is not None and wire == "int8"
             else ("Δθ² of the local steps" if st is not None else None),
             round_gates=log["gates"].tolist(), round_wall_s=round_wall,
             round_bytes=round_bytes, settle_syncs=settle,
             gossip_sync_wall_s=gwall, engine_sync_wall_s=ewall,
             max_abs_err_vs_engine=err, tolerance=GOSSIP_TOL,
             gates=glog["gates"].tolist(),
             counted_bytes=sess.counted_sync_bytes,
             predicted_link_bytes=sess.predicted_link_bytes,
             note="one rank: its collectives are a single NCCL rank's "
                  "calls, no inter-card traffic")
        del sess, got, want


def _gossip_mamba(dev, smi):
    """(b) Mamba2-370M at full width, N = 4 on a world of one NCCL rank, as
    the train phase's f32-wire path runs it (ring fedavg, 8 × 256 tokens a
    node, 2 steps a round): a round, the next round's local steps and its
    gossip sync, counted together (``ssd_scan`` in every step and every
    gate score); the sync held against the engine backend's from the same
    state; then one profiled round."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.engine import SwarmEngine
    from repro_torch.core.session import SwarmSession
    from repro_torch.data import make_lm_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    mesh, axis = make_swarm_mesh(N)
    steps, t, batch, seq = 4, 2, 8, 256
    lcfg = get_config("mamba2-370m")
    model = build_model(lcfg)
    layout = model.layout
    tc = TrainConfig(lr=1e-3, warmup_steps=max(steps // 10, 1),
                     max_steps=steps, remat=False)
    step_fn = train.make_train_step(model, tc)
    streams = [make_lm_stream(256, seq, lcfg.vocab_size, seed=i,
                              topic_bias=1.0) for i in range(N)]
    veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
        layout.unflatten(p), v, remat=False)[0]))
    cfg = _gossip_cfg("fedavg", "ring", "f32")
    ps = [model.init(torch.Generator(device=dev).manual_seed(0), dev)
          for _ in range(N)]
    sess = SwarmSession(cfg, lambda p, o, b, s: step_fn(p, o, b),
                        lambda p, v: veval(p, v), params=ps,
                        opt_state=adamw_init(layout.parts(ps[0])),
                        data_sizes=[len(s["tokens"]) for s in streams],
                        layout=layout, device=dev, backend="gossip",
                        mesh=mesh, axis=axis)
    del ps
    rng = np.random.default_rng(0)

    def to_dev(arrays):
        return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

    def draw():
        idx = [rng.integers(0, len(s["tokens"]), (t, batch))
               for s in streams]
        return to_dev({k: np.stack([s[k][i] for s, i in zip(streams, idx)],
                                   axis=1) for k in streams[0]})

    vals = to_dev({k: np.stack([s[k][:8] for s in streams])
                   for k in streams[0]})
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log1 = sess.round(draw(), vals)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sess.run_local(draw())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    st = sess.state
    p0 = st.params.clone()
    committed, glog = sess.engine.sync(st.params, sess._mine(vals, 0),
                                       st.active, stats=st.stats,
                                       wire=st.wire)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    # 4 steps, one SSD launch a layer each (the vmap rule folds the nodes),
    # and 2 syncs scoring the params and the candidate; no merge kernel
    layers = lcfg.n_layers
    predicted = {"ssd_scan": steps * layers + 2 * 2 * layers}
    if launches != predicted:
        raise AssertionError(f"gossip mamba2: launches {launches}, "
                             f"predicted {predicted}")
    counted = sess.engine.sync_bytes
    eng = SwarmEngine(cfg, None, lambda p, v: veval(p, v),
                      data_sizes=[len(s["tokens"]) for s in streams],
                      layout=layout)
    want, elog = eng.sync(p0, vals, st.active)
    del p0
    if not torch.equal(glog["gates"], elog["gates"]):
        raise AssertionError(f"gossip mamba2: gates {glog['gates']} vs "
                             f"{elog['gates']}")
    errs = [_parts_err(layout, committed[i], want[i], GOSSIP_TOL)
            for i in range(N)]
    if max(e[1] for e in errs) > 0:
        raise AssertionError(f"gossip mamba2: sync vs the engine's {errs}")
    del want
    sess._commit(committed)
    del committed
    if not bool(torch.isfinite(layout.values(sess.state.params)).all()):
        raise AssertionError("gossip mamba2: non-finite params")
    block = draw()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t4 = time.perf_counter()
        losses = sess.round(block, vals)["train"]["loss"].float().cpu()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t4
    busy = _busy(prof, pwall)
    tokens = t * N * batch * seq
    emit("gossip_b", card=smi, arch="mamba2-370m", world=1, backend="nccl",
         nodes=N, batch=batch, seq=seq, steps_per_round=t,
         values_per_node=layout.n_values, slots_per_node=layout.size,
         schedule=sess.sync_schedule.name,
         describe=sess.sync_schedule.describe(sess.payload_params),
         round_wall_s=t1 - t0, step_wall_s=(t2 - t1) / t,
         tokens_per_s=tokens / (t2 - t1), sync_wall_s=t3 - t2,
         launches=launches, predicted=predicted,
         peak_allocated_gib=peak / 2 ** 30,
         peak_reserved_gib=reserved / 2 ** 30,
         counted_bytes=counted,
         predicted_link_bytes=sess.predicted_link_bytes,
         predicted_sync_bytes=sess.predicted_sync_bytes,
         sync_err_vs_engine=[e[0] for e in errs],
         tolerance="1e-5, plus one bf16 ulp in the bf16 slots",
         round1_gates=log1["gates"].tolist(),
         profiled_wall_s=pwall, busy_share=busy["device_busy_share"],
         device_busy_s=busy["device_busy_s"],
         kernel_launches_profiled=busy["kernel_launches"],
         top_device=busy["top_device"][:6],
         loss_profiled=[float(x) for x in losses.reshape(-1)],
         note="one rank: the all_gather is a single NCCL rank's call, no "
              "inter-card traffic")
    del sess


def _gossip_rank(rank, world, init, tmp, dev):
    """(c) One of the 4 gloo ranks on ``cuda:0``: every ``GOSSIP_C`` setting
    from the start state ``tmp/state.pt``, its settled commit and sync wall
    and the bytes it handed to the collectives, into
    ``tmp/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.session import SwarmSession
    from repro_torch.core.flat import FlatLayout
    from repro_torch.experiments import histo
    from repro_torch.launch.mesh import make_swarm_mesh

    dev = torch.device(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        saved = torch.load(f"{tmp}/state.pt")
        base = dict(params=saved["params"].to(dev),
                    stats=saved["stats"].to(dev), sizes=saved["sizes"])
        val = tuple(v.to(dev) for v in saved["val"])
        mesh, axis = make_swarm_mesh(N)
        out = {}
        for sched, merge, topology, wire in GOSSIP_C:
            cfg = _gossip_cfg(merge, topology, wire)
            ecfg = _gossip_ecfg(cfg)
            model = histo._model(ecfg)
            layout = FlatLayout.of_module(model)
            veval = histo._make_eval_fn(cfg, model, layout)
            p, st = _gossip_state(base, merge, wire)
            sess = SwarmSession(cfg, None, veval, params=list(p.unbind(0)),
                                data_sizes=base["sizes"], layout=layout,
                                device=dev, backend="gossip", mesh=mesh,
                                axis=axis)
            if sess.sync_schedule.name != sched:
                raise AssertionError(f"{merge}/{topology}/{wire} picked "
                                     f"{sess.sync_schedule.name}, not {sched}")
            got, log, wall = _gossip_commit(
                sess.engine, p[mesh.rows], sess._mine(val, 0),
                sess.state.active, None if st is None else st[mesh.rows],
                0 if wire == "f32" else GOSSIP_SETTLE)
            out[f"{sched}/{wire}"] = dict(
                committed=got.cpu(), gates=log["gates"].cpu(), wall=wall,
                counted=sess.engine.sync_bytes,
                predicted=sess.predicted_link_bytes,
                payload=sess.payload_params)
            del sess
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _decay_step(p, o, b, s):
    """The reference's fault tests' local step: θ ← 0.999·θ."""
    return p * 0.999, o, {"loss": (p * 0).sum()}


def _gossip_d_cfg(merge, cross):
    import dataclasses
    return dataclasses.replace(_gossip_cfg(merge, "ring", "int8"),
                               cross_pod_cost=cross, self_weight=GOSSIP_D_SW)


def _gossip_rank_d(rank, world, init, tmp, dev):
    """(d) One of the 4 gloo ranks on ``cuda:0`` as node ``rank % 2`` of pod
    ``rank // 2``: each ``GOSSIP_D`` setting's pick and settled commit from
    the start state, its sync wall and bytes; then each ``GOSSIP_D_PLANS``
    setting's fault plan with and without the preempt (real local steps of
    the CNN, cuDNN deterministic), equal bit for bit, and one more timed
    collective save and load; into ``tmp/hier<r>.pt``."""
    import functools
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.core.flat import FlatLayout
    from repro_torch.core.session import SwarmSession
    from repro_torch.experiments import histo
    from repro_torch.faults import FaultPlan, run_plan
    from repro_torch.launch.mesh import make_two_level_swarm_mesh
    from repro_torch.optim import adamw_init

    dev = torch.device(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    # the preempted run and its twin replay the same local steps
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        saved = torch.load(f"{tmp}/state.pt")
        params = saved["params"].to(dev)
        stats = saved["stats"].to(dev)
        sizes = saved["sizes"]
        val = tuple(v.to(dev) for v in saved["val"])
        batches = (saved["xs"].to(dev), saved["ys"].to(dev))
        mesh, axis = make_two_level_swarm_mesh(*GOSSIP_D_PODS)
        out = {"settings": {}, "plans": {}}
        ecfg = _gossip_ecfg(_gossip_d_cfg("fedavg", 10.0))
        model = histo._model(ecfg)
        layout = FlatLayout.of_module(model)
        step, _ = histo._make_model_fns(ecfg, model, layout)
        flat0 = layout.flatten(histo._init_params(ecfg, model)).to(dev)

        def session(name, merge, cross, local=None):
            cfg = _gossip_d_cfg(merge, cross)
            sess = SwarmSession(
                cfg, {None: None, "train": step,
                      "decay": _decay_step}[local],
                histo._make_eval_fn(cfg, model, layout),
                params=list(params.unbind(0)),
                opt_state=adamw_init(flat0) if local else None,
                data_sizes=sizes, layout=layout, device=dev,
                backend="gossip", mesh=mesh, axis=axis)
            if sess.sync_schedule.name != name:
                raise AssertionError(f"(d) {merge} at cross_pod_cost "
                                     f"{cross} picked "
                                     f"{sess.sync_schedule.name}, not {name}")
            return sess

        for name, merge, cross in GOSSIP_D:
            sess = session(name, merge, cross)
            st = stats[mesh.rows] if merge == "fisher" else None
            got, log, wall = _gossip_commit(
                sess.engine, params[mesh.rows], sess._mine(val, 0),
                sess.state.active, st, GOSSIP_SETTLE)
            out["settings"][name] = dict(
                committed=got.cpu(), gates=log["gates"].cpu(), wall=wall,
                counted=sess.engine.sync_bytes,
                predicted=sess.predicted_link_bytes)
            del sess, got
        node, at, back = GOSSIP_D_CRASH
        plan = FaultPlan(N, GOSSIP_D_ROUNDS, seed=0).crash(node, at=at,
                                                           rejoin=back)
        for name, merge, cross in [g for g in GOSSIP_D
                                   if g[0] in GOSSIP_D_PLANS]:
            path = os.path.join(tmp, f"preempt_{name}.msgpack")
            mk = functools.partial(session, name, merge, cross,
                                   GOSSIP_D_PLANS[name])
            twin, tlogs = run_plan(mk(), plan, batches, val)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess, logs = run_plan(mk(), plan.preempt(at=GOSSIP_D_PREEMPT),
                                  batches, val, make_session=mk,
                                  checkpoint_path=path)
            torch.cuda.synchronize()
            plan_wall = time.perf_counter() - t0
            a, b = twin.state, sess.state
            equal = {f: _trees_equal(getattr(a, f), getattr(b, f))
                     for f in ("params", "opt_state", "stats", "wire",
                               "active")}
            equal["rng"] = bool((a.rng == b.rng).all())
            equal["counters"] = (a.round, a.step) == (b.round, b.step)
            # one more collective save and load, timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.save(path)
            save_s = time.perf_counter() - t0
            fresh = mk()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh.load(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            equal["reloaded"] = _trees_equal(fresh.state.wire, b.wire) and \
                bool(torch.equal(fresh.state.params, b.params))
            out["plans"][name] = dict(
                equal=equal, plan_wall=plan_wall, save_s=save_s,
                load_s=load_s, file_bytes=os.path.getsize(path),
                gates=[lg["gates"].tolist() for lg in logs],
                twin_gates=[lg["gates"].tolist() for lg in tlogs],
                preempted=[lg["preempted"] for lg in logs],
                active=[lg["active"].tolist() for lg in logs],
                wire_keys=sorted(b.wire), params=b.params.cpu())
            del twin, sess, fresh, a, b
        torch.save(out, f"{tmp}/hier{rank}.pt")
    finally:
        dist.destroy_process_group()


def _trees_equal(a, b) -> bool:
    """Two state fields (tensors, or dicts of them) equal bit for bit."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k])
                                            for k in a)
    if a is None or b is None:
        return a is b
    return bool(torch.equal(a, b))


def _gossip_d_oracle(base, name, merge):
    """The settled commit of a (d) setting in f64 numpy, [N, P]: the
    hierarchical forms mix the pod aggregates over the pod ring (fedavg:
    the size-weighted pod averages; fisher: Σ (F+eps)⊙θ over Σ (F+eps), F
    the statistics normalized to a mean of 1), the flat ring forms mix the
    nodes over the ring (fisher: the ratio over ring neighbours)."""
    import numpy as np
    from repro_torch.core.topology import ring_matrix

    theta = base["params"].double().cpu().numpy()
    eps = 1e-8
    F = None
    if merge == "fisher":
        st = base["stats"].double().cpu().numpy()
        mean = st.mean()
        F = (st / mean if mean > 0 else st) + eps
    if name.startswith("hier_"):
        k, per = GOSSIP_D_PODS
        pods = [slice(q * per, (q + 1) * per) for q in range(k)]
        Wp = ring_matrix(k, GOSSIP_D_SW)
        if merge == "fedavg":
            s = np.asarray(base["sizes"], np.float64)
            agg = np.stack([s[p] @ theta[p] / s[p].sum() for p in pods])
            return np.repeat(Wp @ agg, per, 0)
        num = np.stack([(F[p] * theta[p]).sum(0) for p in pods])
        den = np.stack([F[p].sum(0) for p in pods])
        return np.repeat((Wp @ num) / (Wp @ den), per, 0)
    R = ring_matrix(N, GOSSIP_D_SW)
    if merge == "fedavg":
        return R @ theta
    return (R @ (F * theta)) / (R @ F)


def _gossip_priced(counted, link, group):
    """What a rank handed over on one link class, priced as the cost model
    prices a rank's traffic (a gathered tensor arrives from each of the
    ``group`` ranks, a ring all_reduce moves 2(n−1)/n of its input)."""
    factor = {"ring": 1.0, "all_to_all": 1.0, "all_gather": float(group),
              "all_reduce": 2.0 * (group - 1) / group}
    kinds = counted["by_link_collective"].get(link, {})
    return sum(factor[k] * v for k, v in kinds.items())


def _gossip_two_level(dev, smi, base, spawned):
    """(d) 4 gloo ranks on the one card as 2 pods × 2 nodes (``spawned``:
    the wall and the ranks' records): each setting's pick and settled
    commit against the f64 oracle, its bytes by link class against the
    cost model at the padded width, then each fault plan's preempted run
    against its twin, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import comms, gossip

    spawn_wall, ranks = spawned
    layout = base["layout"]
    k, per = GOSSIP_D_PODS
    rows = {}
    for name, merge, cross in GOSSIP_D:
        got = torch.cat([r["settings"][name]["committed"]
                         for r in ranks]).double().numpy()
        gates = ranks[0]["settings"][name]["gates"]
        if not bool(gates.all()):
            raise AssertionError(f"(d) {name}: gates {gates}")
        want = _gossip_d_oracle(base, name, merge)
        diff = np.abs(got - want)
        err = float(diff.max())
        if (diff > GOSSIP_TOL * (1 + np.abs(want))).any():
            raise AssertionError(f"(d) {name}: commit {err} from the oracle")
        hier = name.startswith("hier_")
        grid = gossip.padded_grid(layout, WIRE_BLOCK, per if hier else 1)
        sched = comms.pick_schedule(_gossip_d_cfg(merge, cross),
                                    mesh_shape=GOSSIP_D_PODS)
        model = sched.bytes_by_link_class(grid.padded)
        priced = []
        for r in ranks:
            c = r["settings"][name]["counted"]
            intra = _gossip_priced(c, "intra", per)
            cross_b = _gossip_priced(c, "cross", per if hier else N)
            priced.append(dict(intra=intra, cross=cross_b))
            # cross: exactly; intra: fedavg beside the pod mass's scalar
            # all_reduce (2(n−1)/n · 4 bytes), fisher less one f32 payload
            # (the model prices the gather of both streams, the schedule
            # gathers their ratio, as the reference's does)
            want_intra = (model["intra"] + 2.0 * (per - 1) / per * 4
                          if name == "hier_fedavg_ring_q8"
                          else model["intra"] - 4 * grid.padded
                          if hier else 0.0)
            if cross_b != model["cross"] or intra != want_intra:
                raise AssertionError(f"(d) {name}: priced {priced[-1]}, "
                                     f"model {model}, intra want "
                                     f"{want_intra}")
        rows[name] = dict(
            cross_pod_cost=cross, max_abs_err_vs_oracle=err,
            tolerance=GOSSIP_TOL, padded_width=grid.padded,
            model_link_bytes=model, priced_link_bytes=priced[0],
            counted_bytes=ranks[0]["settings"][name]["counted"],
            predicted_link_bytes=ranks[0]["settings"][name]["predicted"],
            sync_wall_s=[r["settings"][name]["wall"] for r in ranks])
    ratio = {m: rows[f"hier_{m}_ring_q8"]["priced_link_bytes"]["cross"]
             / rows[flat]["priced_link_bytes"]["cross"]
             for m, flat in (("fedavg", "ring_ppermute"),
                             ("fisher", "ring_topo_ppermute"))}
    if max(ratio.values()) > 0.35:
        raise AssertionError(f"(d) cross-pod bytes hier / flat {ratio}")
    plans = {}
    node, at, back = GOSSIP_D_CRASH
    for name, local in GOSSIP_D_PLANS.items():
        per_rank = [r["plans"][name] for r in ranks]
        for r, pr in enumerate(per_rank):
            if not all(pr["equal"].values()):
                raise AssertionError(f"(d) {name} rank {r}: preempted run "
                                     f"vs twin {pr['equal']}")
            if pr["gates"] != pr["twin_gates"]:
                raise AssertionError(f"(d) {name}: gates differ")
        p0 = per_rank[0]
        if p0["preempted"] != [i == GOSSIP_D_PREEMPT
                               for i in range(GOSSIP_D_ROUNDS)]:
            raise AssertionError(f"(d) {name}: preempted {p0['preempted']}")
        for i, (act, gates) in enumerate(zip(p0["active"], p0["gates"])):
            if act[node] != (not at <= i < back) or any(
                    g and not a for g, a in zip(gates, act)):
                raise AssertionError(f"(d) {name} round {i}: active {act}, "
                                     f"gates {gates}")
        want_keys = (["left", "ref"] if name.startswith("hier_")
                     else ["left", "ref", "right"])
        if p0["wire_keys"] != want_keys:
            raise AssertionError(f"(d) {name}: wire {p0['wire_keys']}")
        final = torch.cat([pr["params"] for pr in per_rank])
        if not bool(torch.isfinite(final).all()):
            raise AssertionError(f"(d) {name}: non-finite params")
        plans[name] = dict(
            local_step=local, bit_identical=True,
            file_bytes=p0["file_bytes"],
            save_s=[pr["save_s"] for pr in per_rank],
            load_s=[pr["load_s"] for pr in per_rank],
            plan_wall_s=[pr["plan_wall"] for pr in per_rank],
            gates=p0["gates"])
    emit("gossip_d", card=smi, world=GOSSIP_WORLD, backend="gloo",
         mesh={"pod": k, "node": per}, device=f"{dev} (all ranks)",
         nodes=N, params_per_node=layout.size, wire_block=WIRE_BLOCK,
         self_weight=GOSSIP_D_SW, settle_syncs=GOSSIP_SETTLE,
         spawn_wall_s=spawn_wall, settings=rows,
         cross_ratio_hier_over_flat=ratio,
         plan=dict(rounds=GOSSIP_D_ROUNDS, crash=GOSSIP_D_CRASH,
                   preempt_at=GOSSIP_D_PREEMPT, runs=plans),
         note="4 ranks on one card: gloo stages CUDA tensors through host "
              "memory, so the walls are host copies and gloo's TCP "
              "transport, not links between pods")


def _gossip_spawn(fn, tmp, dev, tag, world=GOSSIP_WORLD):
    """``fn(rank, world, init, tmp, dev)`` on ``world`` spawned ranks:
    (its wall, each rank's ``tmp/<tag><r>.pt``), as ``_gossip_spawn_all``
    gives them for one world."""
    return _gossip_spawn_all(tmp, dev, (fn, tag, world))[0]


def _gossip_spawn_all(tmp, dev, *worlds):
    """Each ``(fn, tag, world)`` of ``worlds``: ``fn(rank, world, init,
    tmp, dev)`` on ``world`` spawned ranks, every world started at once on
    the one card and joined within GOSSIP_TIMEOUT (a failed rank raises
    here, every live one is terminated). Returns, a world each, its wall
    (from the start to its last rank's exit) and each rank's
    ``tmp/<tag><r>.pt``."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    ctxs = [mp.start_processes(fn, args=(world, f"file://{tmp}/rdv_{tag}",
                                         tmp, str(dev)),
                               nprocs=world, join=False,
                               start_method="spawn")
            for fn, tag, world in worlds]
    walls = [None] * len(ctxs)
    deadline = time.time() + GOSSIP_TIMEOUT
    try:
        while None in walls:
            for i, ctx in enumerate(ctxs):
                if walls[i] is None and ctx.join(timeout=1):
                    walls[i] = time.perf_counter() - t0
            if None in walls and time.time() > deadline:
                raise TimeoutError(f"gossip worlds {worlds}: ranks still "
                                   f"running after {GOSSIP_TIMEOUT} s")
    finally:
        for ctx in ctxs:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(30)
    return [(wall, [torch.load(f"{tmp}/{tag}{r}.pt") for r in range(world)])
            for wall, (_, tag, world) in zip(walls, worlds)]


def _gossip_world4(dev, smi, base, spawned):
    """(c) 4 gloo ranks on the one card (``spawned``: the wall and the
    ranks' records); each setting's committed rows against the engine
    backend's commit of it."""
    import torch
    from repro_torch.core import gossip
    from repro_torch.experiments import histo

    spawn_wall, ranks = spawned
    layout, model, ecfg = base["layout"], base["model"], base["ecfg"]
    active = torch.ones(N, dtype=torch.bool, device=dev)
    rows = {}
    for sched, merge, topology, wire in GOSSIP_C:
        key = f"{sched}/{wire}"
        got = torch.cat([r[key]["committed"] for r in ranks]).to(dev)
        gates = ranks[0][key]["gates"]
        cfg = _gossip_cfg(merge, topology, wire)
        veval = histo._make_eval_fn(cfg, model, layout)
        want, elog, ewall = _engine_reference(base, veval, merge, topology,
                                              wire, active)
        err = _gossip_hold(got, want, gates, elog["gates"], key,
                           cast_mass=wire == "bf16" and merge == "fisher")
        # what a rank hands over, priced as the cost model prices a
        # rank's traffic (tests/test_torch_gossip.py)
        width = layout.size
        if wire == "int8":
            width = gossip.padded_grid(
                layout, WIRE_BLOCK,
                GOSSIP_WORLD if "psum" in sched else 1).padded
        factor = {"ring": 1.0, "all_to_all": 1.0,
                  "all_gather": float(GOSSIP_WORLD),
                  "all_reduce": 2.0 * (GOSSIP_WORLD - 1) / GOSSIP_WORLD}
        counted = ranks[0][key]["counted"]
        priced = sum(factor[k] * v for k, v in
                     counted["by_collective"].items())
        rows[key] = dict(max_abs_err_vs_engine=err,
                         sync_wall_s=[r[key]["wall"] for r in ranks],
                         engine_sync_wall_s=ewall, counted_bytes=counted,
                         counted_priced=priced, width=width,
                         predicted_link_bytes=ranks[0][key]["predicted"])
    emit("gossip_c", card=smi, world=GOSSIP_WORLD, backend="gloo",
         device=f"{dev} (all ranks)", nodes=N, params_per_node=layout.size,
         settle_syncs=GOSSIP_SETTLE, tolerance=GOSSIP_TOL,
         spawn_wall_s=spawn_wall, settings=rows,
         note="4 ranks on one card: gloo stages CUDA tensors through host "
              "memory, so these walls are host copies and gloo's TCP "
              "transport, not NVLink")


# (e) inner (model) sharding: Mamba2-370M at its published width, its
# depth cut to GOSSIP_E_LAYERS of 48 (on an H100 the part took 286-338 s at
# 48, two 8.8 GB checkpoints among them, 111-136 s at 8 and 104-106 s at 4;
# (f) 51-75 s at 8, 58 s at 4), 2 nodes × model 2 on 4 gloo ranks against
# an unsharded twin on 2
GOSSIP_E_NODES, GOSSIP_E_MODEL = 2, 2
GOSSIP_E_LAYERS = 2
GOSSIP_E_ROUNDS = 2
GOSSIP_E_STEPS, GOSSIP_E_BATCH, GOSSIP_E_SEQ = 2, 8, 256
GOSSIP_E_WIRES = ("f32", "int8")
GOSSIP_E_PICKS = {"f32": "fedavg_psum", "int8": "gathered_rows"}


def _gossip_e_cfg(wire):
    from repro_torch.configs.base import SwarmConfig
    return SwarmConfig(n_nodes=GOSSIP_E_NODES, sync_every=GOSSIP_E_STEPS,
                       topology="full", merge="fedavg", lora_only=False,
                       val_threshold=0.0, wire_dtype=wire,
                       wire_block=WIRE_BLOCK)


def _gossip_e_oracle(local, pre, weights, got):
    """The first int8 fedavg sync against an f64 oracle of the per-shard
    block grid: ``pre`` [N, n_values] the nodes' shard values before the
    sync (zero wire tables), each leaf of the shard's layout ``local`` (no
    conv: stored order is the reference's) zero-padded to whole wire
    blocks and quantized in f32 as the reference's core does (scale
    max|v|/127, round half to even, clip ±127), the merge Σ_j w_j deq_j
    in f64; ``got`` [n_values] the rank's committed values. Chunk by chunk
    of whole blocks. Returns (max abs error, its largest excess over 1e-5
    plus, in a bf16 leaf, one bf16 ulp of the oracle's value)."""
    import torch
    w = torch.as_tensor(weights, dtype=torch.float64, device=pre.device)
    c127 = torch.full((), 127.0, device=pre.device)
    step = WIRE_BLOCK << 15
    err, excess = 0.0, float("-inf")
    for lf in local.value_layout.leaves:
        ulp = 0.0 if lf.offset < local.n_wide else 2.0 ** -7
        for a in range(0, lf.size, step):
            n = min(step, lf.size - a)
            at = lf.offset + a
            v = torch.nn.functional.pad(pre[:, at:at + n],
                                        (0, (-n) % WIRE_BLOCK)).view(
                pre.shape[0], -1, WIRE_BLOCK)
            scale = v.abs().amax(-1, keepdim=True) / c127
            q = torch.clamp(torch.round(v / torch.where(scale > 0, scale,
                                                        1.0)), -127.0, 127.0)
            want = w @ (q * scale).reshape(pre.shape[0], -1)[:, :n].double()
            d = (got[at:at + n].double() - want).abs()
            err = max(err, float(d.max()))
            excess = max(excess, float((d - GOSSIP_TOL
                                        - ulp * want.abs()).max()))
            del v, scale, q, want, d
    return err, excess


def _gossip_rank_e(rank, world, init, tmp, dev):
    """(e) One gloo rank on ``cuda:0``: with a world of 4, block ``m`` of
    node ``rank // 2`` (2 nodes × model 2, the rules' specs); with a world
    of 2, node ``rank`` whole (the twin; its int8 run with specs over
    size-1 axes, which pick the int8 schedule of the sharded run). Mamba2-370M
    at full width, GOSSIP_E_ROUNDS rounds on each wire from the seed-0 init
    and the seeded batches, then (f32) one collective save. Into
    ``tmp/<tag><r>.pt``: picks, gates, hashes of the whole node's params
    after each round (gathered), walls, memory, bytes, launches, the int8
    oracle's excess and the checkpoint's SHA-256."""
    import dataclasses
    import hashlib
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import gossip
    from repro_torch.core.session import SwarmSession
    from repro_torch.data import make_lm_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    dev = torch.device(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    sharded = world == GOSSIP_E_NODES * GOSSIP_E_MODEL
    repeat = os.environ.get("GOSSIP_E_REPEAT") == "1"
    tag = ("eshard" if sharded else "etwin2" if repeat else "etwin")
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh, axis = (make_swarm_mesh(GOSSIP_E_NODES, model=GOSSIP_E_MODEL)
                      if sharded else make_swarm_mesh(GOSSIP_E_NODES))
        lcfg = dataclasses.replace(get_config("mamba2-370m"),
                                   n_layers=GOSSIP_E_LAYERS)
        model = build_model(lcfg)
        layout = model.layout
        step_fn = train.make_train_step(model, TrainConfig(
            lr=1e-3, warmup_steps=1, max_steps=2 * GOSSIP_E_ROUNDS,
            remat=False))
        veval = torch.func.vmap(lambda p, v: 1.0 / (1.0 + model.loss_fn(
            layout.unflatten(p), v, remat=False)[0]))
        streams = [make_lm_stream(64, GOSSIP_E_SEQ, lcfg.vocab_size, seed=i,
                                  topic_bias=1.0)
                   for i in range(GOSSIP_E_NODES)]
        sizes = [float(len(st["tokens"])) for st in streams]
        weights = np.asarray(sizes) / sum(sizes)

        def to_dev(arrays):
            return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

        vals = to_dev({k: np.stack([st[k][:8] for st in streams])
                       for k in streams[0]})
        out = {"coords": dict(mesh.coords), "rows": (mesh.rows.start,
                                                     mesh.rows.stop),
               "wires": {}}
        wires = ("f32",) if repeat else GOSSIP_E_WIRES
        for wire in wires:
            specs = None
            if sharded:
                specs = param_specs(layout, mesh)
            elif wire == "int8":
                specs = param_specs(layout, {"node": GOSSIP_E_NODES,
                                             "data": 1, "model": 1})
            p0 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
            sess = SwarmSession(
                _gossip_e_cfg(wire), lambda p, o, b, s: step_fn(p, o, b),
                lambda p, v: veval(p, v), params=p0,
                opt_state=adamw_init(layout.parts(p0)), data_sizes=sizes,
                layout=layout, device=dev, backend="gossip", mesh=mesh,
                axis=axis, param_specs=specs)
            del p0
            eng = sess.engine
            rec = {"schedule": sess.sync_schedule.name,
                   "slots": int(sess.state.params.shape[-1]),
                   "values": int(eng.layout.n_values if eng.layout
                                 is not None else 0),
                   "rounds": []}
            # the cost model at the rank's payload width (int8: each leaf
            # of the shard padded to whole wire blocks)
            width = (sum(-(-lf.size // WIRE_BLOCK) * WIRE_BLOCK
                         for lf in eng._payload_layout(dev).leaves)
                     if wire == "int8" else rec["values"])
            rec["model_link_bytes"] = sess.sync_schedule.bytes_by_link_class(
                width)
            sync_log = {}
            sync = eng.sync

            def timed_sync(params, val, *a, **kw):
                # the local steps' peak ends where the sync starts
                torch.cuda.synchronize()
                sync_log["steps_peak"] = torch.cuda.max_memory_allocated()
                if wire == "int8" and not sync_log.get("pre_done"):
                    sync_log["pre"] = gossip.all_gather(
                        mesh, eng.layout.values(params), kind=None)
                    sync_log["pre_done"] = True
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = sync(params, val, *a, **kw)
                torch.cuda.synchronize()
                sync_log["wall"] = time.perf_counter() - t0
                sync_log["peak"] = torch.cuda.max_memory_allocated()
                return res

            eng.sync = timed_sync
            rng = np.random.default_rng(0)
            reset_launches()
            for r in range(GOSSIP_E_ROUNDS):
                idx = [rng.integers(0, len(st["tokens"]),
                                    (GOSSIP_E_STEPS, GOSSIP_E_BATCH))
                       for st in streams]
                batch = to_dev({k: np.stack([st[k][i] for st, i in
                                             zip(streams, idx)], axis=1)
                                for k in streams[0]})
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                log = sess.round(batch, vals)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                after = torch.cuda.memory_allocated()
                node = eng.node_tensor(sess.state.params, kind=None)
                digest = hashlib.sha256(
                    node.view(torch.int16).cpu().numpy().tobytes()
                ).hexdigest()
                rec["rounds"].append(dict(
                    gates=log["gates"].tolist(),
                    metric_merged=log["metric_merged"].tolist(),
                    loss=log["train"]["loss"].float().cpu().tolist(),
                    wall=wall, sync_wall=sync_log["wall"],
                    resident_before=resident, resident_after=after,
                    steps_peak=sync_log["steps_peak"],
                    sync_peak=sync_log["peak"], params_sha256=digest,
                    counted=sess.counted_sync_bytes))
                if wire == "int8" and r == 0:
                    # the first sync's commit against the per-shard oracle
                    # (a rejected node: its own values bit for bit)
                    pre = sync_log.pop("pre")
                    got = eng.layout.values(sess.state.params)[0]
                    gate = bool(log["gates"][mesh.rows.start])
                    torch.cuda.empty_cache()
                    if gate:
                        err, excess = _gossip_e_oracle(eng.layout, pre,
                                                       weights, got)
                    else:
                        err = excess = float((got - pre[mesh.rank]).abs()
                                             .max())
                    rec["oracle"] = dict(gate=gate, max_abs_err=err,
                                         excess=excess)
                    del pre, got
                if wire == "f32" and r == GOSSIP_E_ROUNDS - 1 and not sharded:
                    torch.save(node.cpu(), f"{tmp}/{tag}_params{rank}.pt")
                if wire == "f32" and r == GOSSIP_E_ROUNDS - 1 and sharded \
                        and mesh.coords["model"] == 0:
                    torch.save(node.cpu(), f"{tmp}/{tag}_params{rank}.pt")
                del node, batch, log
            rec["launches"] = {k: v for k, v in LAUNCHES.items() if v}
            if wire == "f32" and not repeat:
                path = os.path.join(tmp, f"{tag}.msgpack")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sess.save(path)
                rec["save_s"] = time.perf_counter() - t0
                if os.path.exists(path) and rank == 0:
                    h = hashlib.sha256()
                    with open(path, "rb") as f:
                        for chunk in iter(lambda: f.read(1 << 26), b""):
                            h.update(chunk)
                    rec["file_sha256"] = h.hexdigest()
                    rec["file_bytes"] = os.path.getsize(path)
                    os.remove(path)
                dist.barrier()
            out["wires"][wire] = rec
            eng.sync = sync
            del sess, eng
            torch.cuda.empty_cache()
        torch.save(out, f"{tmp}/{tag}{rank}.pt")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _expandable_segments():
    """Spawned ranks that share the card with others: segments that grow
    keep the allocator's reserve from fragmenting across the rounds."""
    import os
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def _gossip_inner(dev, smi, tmp, etwin, eshard):
    """(e) The twin (2 ranks, a node each) and the sharded world (4
    ranks, 2 nodes × model 2), spawned together on the card (``etwin``,
    ``eshard``: each world's wall and its ranks' records); a second twin
    run only when the sharded f32 params differ from the first's. Raises
    on any failed check."""
    import os
    import torch

    (twin_wall, twin), (shard_wall, shard) = etwin, eshard
    node_of = {r: shard[r]["rows"][0] for r in range(len(shard))}
    rows = {}
    # a step launches SSD once a layer (the vmap rule folds the node), a
    # sync twice a layer (the gate scores the params and the candidate)
    predicted = {"ssd_scan": GOSSIP_E_ROUNDS * (GOSSIP_E_STEPS + 2)
                 * GOSSIP_E_LAYERS}
    for wire in GOSSIP_E_WIRES:
        t = [r["wires"][wire] for r in twin]
        sh = [r["wires"][wire] for r in shard]
        for rec in t + sh:
            if rec["schedule"] != GOSSIP_E_PICKS[wire]:
                raise AssertionError(f"(e) {wire}: picked {rec['schedule']}")
            if rec["launches"] != predicted:
                raise AssertionError(f"(e) {wire}: launches "
                                     f"{rec['launches']}, predicted "
                                     f"{predicted}")
        for k in range(GOSSIP_E_ROUNDS):
            gates = {tuple(rec["rounds"][k]["gates"]) for rec in t + sh}
            if len(gates) != 1:
                raise AssertionError(f"(e) {wire} round {k}: gates {gates}")
        rows[wire] = dict(
            schedule=sh[0]["schedule"],
            slots_sharded=[rec["slots"] for rec in sh],
            slots_twin=t[0]["slots"],
            gates=[rec["gates"] for rec in sh[0]["rounds"]],
            loss_twin=[rr["loss"] for rr in t[0]["rounds"]],
            round_wall_s={"sharded": [[rr["wall"] for rr in rec["rounds"]]
                                      for rec in sh],
                          "twin": [[rr["wall"] for rr in rec["rounds"]]
                                   for rec in t]},
            sync_wall_s={"sharded": [[rr["sync_wall"] for rr in
                                      rec["rounds"]] for rec in sh],
                         "twin": [[rr["sync_wall"] for rr in rec["rounds"]]
                                  for rec in t]},
            resident_gib={
                "sharded": [rec["rounds"][-1]["resident_after"] / 2 ** 30
                            for rec in sh],
                "twin": [rec["rounds"][-1]["resident_after"] / 2 ** 30
                         for rec in t]},
            steps_peak_gib={
                "sharded": [max(rr["steps_peak"] for rr in rec["rounds"])
                            / 2 ** 30 for rec in sh],
                "twin": [max(rr["steps_peak"] for rr in rec["rounds"])
                         / 2 ** 30 for rec in t]},
            sync_peak_gib={
                "sharded": [max(rr["sync_peak"] for rr in rec["rounds"])
                            / 2 ** 30 for rec in sh],
                "twin": [max(rr["sync_peak"] for rr in rec["rounds"])
                         / 2 ** 30 for rec in t]},
            counted_bytes={"sharded": sh[0]["rounds"][-1]["counted"],
                           "twin": t[0]["rounds"][-1]["counted"]},
            model_link_bytes={"sharded": sh[0]["model_link_bytes"],
                              "twin": t[0]["model_link_bytes"]},
            launches=sh[0]["launches"], predicted=predicted)
        payload = lambda rec: sum(rec["rounds"][-1]["counted"][
            "by_collective"].values())
        rows[wire]["bytes_ratio"] = [payload(rec) / payload(t[node_of[r]])
                                     for r, rec in enumerate(sh)]
        rows[wire]["resident_ratio"] = [
            rec["rounds"][-1]["resident_after"]
            / t[node_of[r]]["rounds"][-1]["resident_after"]
            for r, rec in enumerate(sh)]
        rows[wire]["steps_peak_ratio"] = [
            max(rr["steps_peak"] for rr in rec["rounds"])
            / max(rr["steps_peak"] for rr in t[node_of[r]]["rounds"])
            for r, rec in enumerate(sh)]
    # f32: each round's whole-node params against the twin's, bit for bit
    f32 = "f32"
    same = all(shard[r]["wires"][f32]["rounds"][k]["params_sha256"]
               == twin[node_of[r]]["wires"][f32]["rounds"][k]["params_sha256"]
               for r in range(len(shard)) for k in range(GOSSIP_E_ROUNDS))
    bound = None
    if not same:
        # the twin run again: the sharded run is held to its run-to-run
        # difference
        os.environ["GOSSIP_E_REPEAT"] = "1"
        try:
            _, _ = _gossip_spawn(_gossip_rank_e, tmp, dev, "etwin2",
                                 world=GOSSIP_E_NODES)
        finally:
            del os.environ["GOSSIP_E_REPEAT"]
        bound, err = 0.0, 0.0
        for i in range(GOSSIP_E_NODES):
            a = torch.load(f"{tmp}/etwin_params{i}.pt").float()
            b = torch.load(f"{tmp}/etwin2_params{i}.pt").float()
            c = torch.load(f"{tmp}/eshard_params{2 * i}.pt").float()
            bound = max(bound, float((a - b).abs().max()))
            err = max(err, float((c - a).abs().max()))
        if err > bound:
            raise AssertionError(f"(e) f32: sharded params {err} from the "
                                 f"twin's, beyond its run-to-run {bound}")
        rows[f32]["params_err_vs_twin"] = err
    rows[f32]["bit_identical"] = same
    rows[f32]["twin_run_to_run"] = bound
    o = [rec["wires"]["int8"]["oracle"] for rec in shard + twin]
    if any(x["excess"] > 0 for x in o):
        raise AssertionError(f"(e) int8: commit vs the per-shard oracle {o}")
    rows["int8"]["oracle_max_abs_err"] = {
        "sharded": [x["max_abs_err"] for x in o[:len(shard)]],
        "twin": [x["max_abs_err"] for x in o[len(shard):]]}
    sha_t = twin[0]["wires"][f32]["file_sha256"]
    sha_s = shard[0]["wires"][f32]["file_sha256"]
    if sha_t != sha_s:
        raise AssertionError("(e) the sharded checkpoint differs from the "
                             "twin's")
    for name in os.listdir(tmp):
        if name.startswith(("etwin", "eshard")) and "_params" in name:
            os.remove(os.path.join(tmp, name))
    emit("gossip_e", card=smi, arch="mamba2-370m", layers=GOSSIP_E_LAYERS,
         backend="gloo",
         device=f"{dev} (all ranks)",
         mesh={"node": GOSSIP_E_NODES, "data": 1, "model": GOSSIP_E_MODEL},
         twin_world=GOSSIP_E_NODES, nodes=GOSSIP_E_NODES,
         batch=GOSSIP_E_BATCH, seq=GOSSIP_E_SEQ,
         steps_per_round=GOSSIP_E_STEPS, rounds=GOSSIP_E_ROUNDS,
         wire_block=WIRE_BLOCK, spawn_wall_s={"twin": twin_wall,
                                              "sharded": shard_wall},
         checkpoint=dict(file_bytes=twin[0]["wires"][f32]["file_bytes"],
                         sha256_equal=True,
                         save_s={"twin": [r["wires"][f32]["save_s"]
                                          for r in twin],
                                 "sharded": [r["wires"][f32]["save_s"]
                                             for r in shard]}),
         settings=rows, tolerance_int8="1e-5, plus one bf16 ulp in the "
         "bf16 slots",
         note="4 + 2 gloo ranks on one card, both worlds at once: "
              "gloo stages CUDA tensors through host memory, so the walls "
              "are host copies and TCP, not NVLink")



# (f) split compute within a node: the model of (e) on 4 gloo ranks as 2
# nodes × data 2 (``make_swarm_mesh(2, data=2)``) whose TrainStep runs
# split (each layer gathered just in time, 4 of a node's 8 rows a data
# rank, gradients and AdamW on the shard), against an unsharded twin on 2
GOSSIP_F_DATA = 2
#: lr 7.5e-5 without warmup: the bf16 leaves' atol 6e-4 is 2 · 4 steps ·
#: lr, an element whose gradient changes sign between the two sums stepping
#: ±lr apart a step (test_torch_train's bf16 bound: 2 · 3 steps · 1e-4)
GOSSIP_F_LR = 7.5e-5
#: (rtol, atol) of the whole node's params against the twin's, by kind
GOSSIP_F_TOL = {"bf16": (3 * 2 ** -8, 6e-4), "f32": (1e-4, 1e-4)}
#: the node losses' rtol against the twin's: the first step's (the same
#: params; the forward on 4 of a node's 8 rows), then every later step's
#: (bf16 params whose updates rounded apart: a bf16 weight's gradient is
#: rounded per data rank before the f32 sum, once in the twin)
GOSSIP_F_LOSS_RTOL = (1e-5, 1e-3)


def _axis_names(entry):
    return () if entry is None else (
        tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))


def _split_bytes(shard, n_layers, rest_itemsize, remat=True):
    """A split step's bytes by kind and a split gate's a score, counted
    from the shard layout and the specs: each cut leaf's block of the
    unscanned unit once and of every layer once (twice with remat: the
    recompute gathers again), 8-byte aligned, into the all_gathers
    (``layer_gather``; a gate score's are ``gate_gather``); the gradient's
    f32 blocks over the data group by how ``data`` cuts each leaf: within
    a layer, a reduce_scatter that sends the other D − 1 data ranks their
    blocks (``grad_reduce_scatter``); only on the layer axis, a reduce to
    the layer's one data rank, which every other one sends its block
    (``grad_reduce_owner``); not at all, an all_reduce of the rank's
    block (``grad_reduce``), each for the layers the data group holds
    (those of its model index where ``model`` cuts the layer axis).
    ``rest_itemsize``: the bytes of a value that is not a wide (f32)
    leaf's. Returns ``(step kinds, gate bytes a score)``. The CPU tests
    hold the port's counts to it too (``tests/torch_gossip_world.py``)."""
    pad = lambda n: -(-n // 8) * 8
    d = shard.sizes.get("data", 1)
    m = shard.sizes.get("model", 1)
    unit = layer = 0
    grads = {"grad_reduce_scatter": 0, "grad_reduce_owner": 0,
             "grad_reduce": 0}
    for full, local in zip(shard.full.leaves, shard.local.leaves):
        stacked = full.path.startswith("layers.")
        block = local.size // (local.shape[0] if stacked else 1)
        if full.shape != local.shape:   # a leaf no axis cuts moves nothing
            itemsize = 4 if full.wide else rest_itemsize
            if stacked:
                layer += pad(block * itemsize)
            else:
                unit += pad(block * itemsize)
        if d == 1:
            continue
        spec = tuple(shard.specs.get(full.path) or ())
        cut = {k: _axis_names(e) for k, e in enumerate(spec)
               if local.shape[full.ref_axes[k]]
               != full.shape[full.ref_axes[k]]}
        on_layer = cut.get(0, ()) if stacked else ()
        within = {a for k, names in cut.items() for a in names
                  if not (stacked and k == 0)}
        depth = n_layers if stacked else 1
        held = depth // m if "model" in on_layer else depth
        if "data" in on_layer:
            if on_layer != ("data",):
                raise ValueError(f"{full.path}: {on_layer} on its layers")
            grads["grad_reduce_owner"] += (depth - depth // d) * block * 4
        elif "data" in within:
            grads["grad_reduce_scatter"] += held * (d - 1) * block * 4
        else:
            grads["grad_reduce"] += held * block * 4
    step = {"layer_gather": unit + (2 if remat else 1) * n_layers * layer}
    if d > 1:
        step.update(grads)
    return step, unit + n_layers * layer


def _tp_bytes(shard, cfg, n_layers, rest_itemsize, rows, seq, split_rows,
              remat=True, val=None, frames=None):
    """A tensor-parallel split step's bytes by kind (one microbatch of
    ``rows`` rows of ``seq`` tokens on this rank's data index;
    ``split_rows``: the data ranks took rows of their own) and, with
    ``val`` = (rows, seq), a split gate's a score, counted from the shard
    layout, the specs and the placement (`repro_torch.sharding.rules.
    placement`, ``compute_cut``): ``layer_gather`` (``gate_gather``), for
    each leaf's layer and each rank of the shard group, the elements of
    the rank's compute block in each stored block it does not hold, sent
    by the stored block's holder of index ``r mod holders`` (the unit
    once, every layer once, a checkpointed layer twice with remat);
    ``grad_to_shard``, the f32 elements of this rank's compute block in
    each stored block, to each other holder (of its data index where the
    rows are whole); the model group's activations: per block an
    all_gather of the normed sequence (``tp_gather``, the rank's cut), a
    reduce_scatter per row-parallel output (``tp_reduce_scatter``, the
    f32 sum's other M − 1 cuts), the SSM norm's f32 sums of squares
    (``tp_all_reduce``), each collective's transpose in the backward (a
    reduce_scatter for a gather, a gather for a reduce_scatter), a
    checkpointed block's forward twice with remat; the embedding's
    all_to_all (``tp_all_to_all``, the M − 1 chunks a rank sends) or
    reduce_scatter, the final norm's gather and the loss's three f32
    all_reduces a token. An enc-dec (``n_layers`` the decoder's depth,
    ``cfg.n_enc_layers`` the encoder's, ``frames`` the encoder's length,
    ``cfg.enc_seq_len`` by default): its encoder blocks (never
    checkpointed) on the frames, the encoder output's one gather (and its
    reduce_scatter back), and each decoder block's cross-attention, which
    gathers its normed rows only where it is head-parallel. Where M does
    not divide ``seq`` (or ``frames``) that stack runs in the
    whole-residual form (`repro_torch.sharding.tensor`: no gathers, each
    row-parallel output's f32 all_reduce in the forward and again in the
    backward); where it does not divide the padded vocab the logits are
    whole and the loss moves nothing. Returns ``(step kinds, gate kinds or
    None)``."""
    from repro_torch.sharding.rules import compute_cut, placement

    m = shard.sizes.get("model", 1)
    place = placement(cfg, m)
    n_group = shard.group_size
    coords = [shard.coords_of(g) for g in range(n_group)]
    me = coords.index({a: shard.coords.get(a, 0) for a in shard.sizes})
    data = [c.get("data", 0) for c in coords]
    encdec = cfg.is_encdec
    frames = cfg.enc_seq_len if frames is None else frames
    # each stack's depth and whether remat gathers its layers twice
    stacks = ({"enc_layers": (cfg.n_enc_layers, False),
               "dec_layers": (n_layers, True)} if encdec
              else {"layers": (n_layers, True)})

    def inside(box, blk):
        n = 1
        for (a, la), ivs in zip(box, blk):
            n *= sum(max(0, min(a + la, c + lc) - max(a, c))
                     for c, lc in ivs)
        return n

    unit = grads = 0
    layers = {top: 0 for top in stacks}
    for leaf in shard.full.leaves:
        top = leaf.path.split(".")[0]
        stacked = top in stacks
        shape = leaf.shape[1:] if stacked else leaf.shape
        item = 4 if leaf.wide else rest_itemsize
        comp = [compute_cut(cfg, place, leaf.path, shape, c.get("model", 0))
                for c in coords]
        stored = []
        for c in coords:
            box, span = [(0, n) for n in shape], None
            for dim, start, length in shard._cuts(leaf, c):
                if stacked and dim == 0:
                    span = (start, length)
                else:
                    box[dim - stacked] = (start, length)
            stored.append((tuple(box), span))
        for i in range(stacks[top][0] if stacked else 1):
            holders = {}
            for g, (box, span) in enumerate(stored):
                if span is None or span[0] <= i < span[0] + span[1]:
                    holders.setdefault(box, []).append(g)
            for box, hs in holders.items():
                for r in range(n_group):
                    src = r if r in hs else hs[r % len(hs)]
                    if src == me != r:
                        n = inside(box, comp[r]) * item
                        if stacked:
                            layers[top] += n
                        else:
                            unit += n
                mine = inside(box, comp[me]) * 4
                grads += mine * sum(1 for h in hs if h != me and (
                    split_rows or data[h] == data[me]))

    c = 4 if cfg.compute_dtype == "float32" else 2
    d = cfg.d_model

    def add(to, kind, n):
        to[kind] = to.get(kind, 0) + n

    def moves(rows, seq):
        """The gather into a block of ``rows`` × ``seq`` and a
        row-parallel output's reduce_scatter (where M does not divide
        ``seq``, the whole residual: no gather, and an f32 all_reduce of
        the output both ways): ``(gather_in, row_out)``, each adding its
        forward and backward bytes to two dicts."""
        x = rows * seq * d
        lg, rs = x // m * c, x * 4 * (m - 1) // m
        whole = seq % m != 0

        def gather_in(fwd, bwd):
            if not whole:
                add(fwd, "tp_gather", lg)
                add(bwd, "tp_reduce_scatter", rs)

        def row_out(fwd, bwd, item=c):
            if whole:
                add(fwd, "tp_all_reduce", x * 4)
                add(bwd, "tp_all_reduce", x * 4)
            else:
                add(fwd, "tp_reduce_scatter", rs)
                add(bwd, "tp_gather", x // m * item)

        return gather_in, row_out

    def block(rows, seq):
        """A decoder-only or decoder block's (forward, backward) by kind."""
        fwd, bwd = {}, {}
        gather_in, row_out = moves(rows, seq)
        gather_in(fwd, bwd)
        if cfg.family in ("ssm", "hybrid") and place.ssm_heads:
            add(fwd, "tp_all_reduce", rows * seq * 4)
            add(bwd, "tp_all_reduce", rows * seq * 4)
            row_out(fwd, bwd)
        if cfg.family != "ssm" and place.attention == "heads":
            row_out(fwd, bwd)
        if encdec and place.attention == "heads":   # cross-attention
            gather_in(fwd, bwd)
            row_out(fwd, bwd)
        if cfg.family == "moe":
            gather_in(fwd, bwd)
            if place.experts:
                row_out(fwd, bwd, 4)
        elif cfg.family != "ssm" and place.ff:
            gather_in(fwd, bwd)
            row_out(fwd, bwd)
        return fwd, bwd

    def enc_block(rows):
        """An encoder block's (forward, backward) by kind."""
        fwd, bwd = {}, {}
        gather_in, row_out = moves(rows, frames)
        gather_in(fwd, bwd)
        if place.attention == "heads":
            row_out(fwd, bwd)
        if place.ff:
            gather_in(fwd, bwd)
            row_out(fwd, bwd)
        return fwd, bwd

    def rest(rows, seq, grad):
        """The embedding, the encoder output's gather, the final norm's
        gather and the loss, by kind: in the whole-residual form the
        d_model-cut lookup's gather of its columns (a reduce_scatter
        back) or the vocab-cut one's all_reduce (both ways), no final
        gather; the loss's three all_reduces only where the logits are
        vocab-cut."""
        out = {}
        x = rows * seq * d
        lg, rs = x // m * c, x * 4 * (m - 1) // m
        whole = seq % m != 0
        if place.embed == "d_model" and whole:
            add(out, "tp_gather", rows * seq * (d // m) * c)
            if grad:
                add(out, "tp_reduce_scatter", rs)
        elif place.embed == "d_model":
            n = (m - 1) * rows * (seq // m) * (d // m) * c
            add(out, "tp_all_to_all", n * (2 if grad else 1))
        elif place.embed == "vocab" and whole:
            add(out, "tp_all_reduce", x * 4 * (2 if grad else 1))
        elif place.embed == "vocab":
            add(out, "tp_reduce_scatter", rs)
            if grad:
                add(out, "tp_gather", lg)
        if encdec:
            gather_in, _ = moves(rows, frames)
            gather_in(out, out if grad else {})
        gather_in, _ = moves(rows, seq)
        gather_in(out, out if grad else {})
        if place.vocab:
            add(out, "tp_all_reduce", 3 * rows * seq * 4)
        return out

    def total(rows, seq, grad, passes):
        out = rest(rows, seq, grad)
        parts = [(block(rows, seq), n_layers, passes)]
        if encdec:
            parts.append((enc_block(rows), cfg.n_enc_layers, 1))
        for (fwd, bwd), depth, times in parts:
            for kinds, k in ((fwd, times * depth),
                             (bwd, depth if grad else 0)):
                for kind, v in kinds.items():
                    add(out, kind, v * k)
        return {k: v for k, v in out.items() if v}

    passes = 2 if remat else 1
    step = total(rows, seq, True, passes)
    step["layer_gather"] = unit + sum(
        (passes if twice else 1) * layers[top]
        for top, (_, twice) in stacks.items())
    step["grad_to_shard"] = grads
    gate = None
    if val is not None:
        gate = total(val[0], val[1], False, 1)
        gate["gate_gather"] = unit + sum(layers.values())
    return step, gate


def _tp_serve_bytes(cfg, model, rows, seq, max_len, encode=False):
    """A model rank's bytes by kind of one served forward over a model
    group of ``model`` ranks (`repro_torch.launch.serve` with a mesh):
    ``rows`` rows of ``seq`` tokens (a prefill; ``seq`` = 1 a decode step
    against a ``max_len``-deep cache), the greedy pick's gather of the
    last position's vocab-cut logits included (none where the logits are
    whole), counted from the config and the placement alone. Where M
    divides ``seq`` the residual is cut: per block an all_gather of the
    normed rows (``tp_gather``, the rank's cut), a reduce_scatter per
    row-parallel output (``tp_reduce_scatter``, the f32 sum's other M − 1
    cuts), the SSM norm's f32 sums of squares (``tp_all_reduce``), the
    embedding's all_to_all (``tp_all_to_all``) or reduce_scatter and the
    final norm's gather. Otherwise the residual is whole: no gather, an
    f32 all_reduce of every row-parallel output and of the SSM norm's
    squares, a decode step's partial scores over a head-dim cut of the
    cache ``[B, nh, T]`` in f32, and the embedding's gather of its d_model
    cut (or all_reduce of a vocab-cut lookup). An enc-dec's decoder block
    adds its cross-attention's gather and row-parallel output where it is
    head-parallel; with ``encode`` (``seq`` its frames) the count is an
    encode's: its encoder blocks and the output's one gather (none in the
    whole form)."""
    from repro_torch.sharding.rules import cache_cut, placement
    place = placement(cfg, model)
    m, d = model, cfg.d_model
    f = 2 if cfg.compute_dtype == "bfloat16" else 4
    whole = seq % m != 0
    rs = rows * seq
    heads = place.attention == "heads"
    out = {"tp_gather": 0, "tp_reduce_scatter": 0, "tp_all_reduce": 0,
           "tp_all_to_all": 0}

    def add(kind, n):
        out[kind] += n

    def row_parallel():
        if whole:
            add("tp_all_reduce", rs * d * 4)
        else:
            add("tp_reduce_scatter", (m - 1) * rs * d * 4 // m)

    def enter():
        if not whole:
            add("tp_gather", rs * d * f // m)

    if encode:
        for _ in range(cfg.n_enc_layers):
            enter()
            if heads:
                row_parallel()
            if place.ff:
                enter()
                row_parallel()
        enter()
        return {k: v for k, v in out.items() if v}
    if place.embed == "d_model":
        add("tp_gather" if whole else "tp_all_to_all",
            rs * (d // m) * f * (1 if whole else m - 1) // (1 if whole
                                                            else m))
    elif place.embed == "vocab":
        if whole:
            add("tp_all_reduce", rs * d * 4)
        else:
            add("tp_reduce_scatter", (m - 1) * rs * d * 4 // m)
    for _ in range(cfg.n_layers):
        enter()
        if cfg.family != "ssm":
            if heads:
                row_parallel()
            elif (seq == 1 and cache_cut(cfg, place) == "head_dim"):
                add("tp_all_reduce", rows * cfg.n_heads * max_len * 4)
                row_parallel()
        if cfg.is_encdec and heads:     # cross-attention
            enter()
            row_parallel()
        if cfg.family in ("ssm", "hybrid") and place.ssm_heads:
            add("tp_all_reduce", rs * 4)
            row_parallel()
        if cfg.family != "ssm":
            if cfg.family == "moe":
                enter()
                if place.experts:
                    row_parallel()
            elif place.ff:
                enter()
                row_parallel()
    enter()
    if place.vocab:
        add("tp_gather", rows * (cfg.padded_vocab // m) * f)
    return {k: v for k, v in out.items() if v}


def _gate_meter(eng, log, split_and_whole=False, barrier=None):
    """Wrap the engine's gate scores (``_gate_scores``, a call a score)
    to record each call's peak allocated above the memory allocated before
    it and its metrics into ``log``; with ``split_and_whole`` each call
    scores through the split gate and then through the whole-node gather
    (``barrier(fn)`` runs the latter, a node position at a time), and
    returns the split gate's. Returns the unwrapped function."""
    import torch
    orig = eng._gate_scores

    def measured(rows, val):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = orig(rows, val)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def scores(rows, val):
        out, peak = measured(rows, val)
        log.setdefault("split" if eng.split_gate else "whole", []).append(
            dict(metric=out.float().cpu().tolist(), peak=peak))
        if split_and_whole:
            eng.split_gate = False
            try:
                whole, wpeak = barrier(lambda: measured(rows, val))
            finally:
                eng.split_gate = True
            log.setdefault("whole", []).append(
                dict(metric=whole.float().cpu().tolist(), peak=wpeak))
        return out

    eng._gate_scores = scores
    return orig


def _gossip_rank_f(rank, world, init, tmp, dev):
    """(f) One gloo rank on ``cuda:0``: with a world of 4, data block
    ``rank % 2`` of node ``rank // 2`` (node, data, model) = (2, 2, 1),
    the rules' specs, the TrainStep split; with a world of 2, node
    ``rank`` whole (the twin: it writes its node's params after each round
    to ``tmp``). Mamba2-370M at full width, GOSSIP_E_LAYERS layers, remat,
    fedavg/full on the f32 wire, GOSSIP_E_ROUNDS rounds of GOSSIP_E_STEPS
    steps from the seed-0 init and (e)'s seeded batches. Into
    ``tmp/<tag><r>.pt``: gates, node losses, step, round and sync walls,
    memory, the step's counted bytes and the layout's count, launches and,
    on a sharded rank of data index 0, each round's largest difference
    from the twin's node by leaf kind."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.session import SwarmSession
    from repro_torch.data import make_lm_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    dev = torch.device(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    sharded = world == GOSSIP_E_NODES * GOSSIP_F_DATA
    tag = "fshard" if sharded else "ftwin"
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh, axis = (make_swarm_mesh(GOSSIP_E_NODES, data=GOSSIP_F_DATA)
                      if sharded else make_swarm_mesh(GOSSIP_E_NODES))
        lcfg = dataclasses.replace(get_config("mamba2-370m"),
                                   n_layers=GOSSIP_E_LAYERS)
        model = build_model(lcfg)
        layout = model.layout
        step = train.make_train_step(model, TrainConfig(
            lr=GOSSIP_F_LR, warmup_steps=0, max_steps=10, remat=True))
        streams = [make_lm_stream(64, GOSSIP_E_SEQ, lcfg.vocab_size, seed=i,
                                  topic_bias=1.0)
                   for i in range(GOSSIP_E_NODES)]
        sizes = [float(len(st["tokens"])) for st in streams]

        def to_dev(arrays):
            return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

        vals = to_dev({k: np.stack([st[k][:8] for st in streams])
                       for k in streams[0]})
        p0 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        # the gate's metric with its split form: the sharded world scores
        # each node a layer at a time, the twin vmapped over its node
        sess = SwarmSession(
            _gossip_e_cfg("f32"), step, train.make_swarm_eval(model),
            params=p0, opt_state=adamw_init(layout.parts(p0)),
            data_sizes=sizes, layout=layout, device=dev, backend="gossip",
            mesh=mesh, axis=axis,
            param_specs=param_specs(layout, mesh) if sharded else None)
        del p0
        eng = sess.engine
        if eng.splits != sharded or eng.split_gate != sharded:
            raise AssertionError(f"(f) rank {rank}: splits={eng.splits}, "
                                 f"split_gate={eng.split_gate}")
        node_of = mesh.rows.start
        out = {"coords": dict(mesh.coords), "node": node_of,
               "slots": int(sess.state.params.shape[-1]),
               "values": layout.n_values, "rounds": []}
        if sharded:
            out["bytes_from_layout"], gate = _split_bytes(
                eng.shard, GOSSIP_E_LAYERS,
                sess.state.params.element_size())
            # a sync scores the params and the candidate of its one node
            out["gate_bytes_from_layout"] = 2 * mesh.per * gate
        gates_log = {}
        _gate_meter(eng, gates_log)
        log_t = {"steps": []}
        sync, local_steps = eng.sync, eng.local_steps

        def timed_sync(*a, **kw):
            torch.cuda.synchronize()
            log_t["steps_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = sync(*a, **kw)
            torch.cuda.synchronize()
            log_t["sync"] = time.perf_counter() - t0
            return res

        def timed_steps(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = local_steps(*a, **kw)
            torch.cuda.synchronize()
            log_t["steps"].append(time.perf_counter() - t0)
            return res

        eng.sync, eng.local_steps = timed_sync, timed_steps
        rng = np.random.default_rng(0)
        reset_launches()
        for r in range(GOSSIP_E_ROUNDS):
            idx = [rng.integers(0, len(st["tokens"]),
                                (GOSSIP_E_STEPS, GOSSIP_E_BATCH))
                   for st in streams]
            batch = to_dev({k: np.stack([st[k][i] for st, i in
                                         zip(streams, idx)], axis=1)
                            for k in streams[0]})
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            log_t["steps"] = []
            gates_log.clear()
            t0 = time.perf_counter()
            log = sess.round(batch, vals)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sync_bytes = sess.counted_sync_bytes
            rec = dict(gates=log["gates"].tolist(),
                       loss=log["train"]["loss"][:, 0].float().cpu().tolist(),
                       wall=wall, sync_wall=log_t["sync"],
                       step_walls=list(log_t["steps"]),
                       resident_before=resident,
                       resident_after=torch.cuda.memory_allocated(),
                       steps_peak=log_t["steps_peak"],
                       step_bytes=sess.counted_step_bytes,
                       gate_bytes={k: sync_bytes[k] for k in
                                   ("gate_gather", "shard_gather")
                                   if k in sync_bytes},
                       gate_peaks=[g["peak"] for g in
                                   gates_log.get("split", [])
                                   + gates_log.get("whole", [])])
            node = eng.node_tensor(sess.state.params, kind=None)[0]
            if not sharded:
                torch.save(node.cpu(), f"{tmp}/ftwin_params_r{r}_n{rank}.pt")
            elif mesh.coords["data"] == 0:
                twin = torch.load(f"{tmp}/ftwin_params_r{r}_n{node_of}.pt"
                                  ).to(dev)
                got, want = layout.values(node), layout.values(twin)
                w = layout.n_wide
                diffs = {}
                for kind, sl in (("f32", slice(0, w)),
                                 ("bf16", slice(w, None))):
                    rtol, atol = GOSSIP_F_TOL[kind]
                    d = (got[sl] - want[sl]).abs()
                    diffs[kind] = dict(
                        max_abs=float(d.max()),
                        excess=float((d - atol - rtol * want[sl].abs())
                                     .max()),
                        changed=int((got[sl] != want[sl]).sum()),
                        values=int(d.numel()))
                rec["vs_twin"] = diffs
                del twin, got, want, d
            del node, batch, log
            out["rounds"].append(rec)
        out["launches"] = {k: v for k, v in LAUNCHES.items() if v}
        eng.sync, eng.local_steps = sync, local_steps
        torch.save(out, f"{tmp}/{tag}{rank}.pt")
        del sess, eng
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _gossip_split(dev, smi, tmp, ftwin):
    """(f) The split world (4 ranks, 2 nodes × data 2) on the card, after
    its twin (2 ranks, a node each; ``ftwin``: its wall and its ranks'
    records), whose params each split round is held against. Raises on
    any failed check."""
    import os

    twin_wall, twin = ftwin
    try:
        with _expandable_segments():
            shard_wall, shard = _gossip_spawn(
                _gossip_rank_f, tmp, dev, "fshard",
                world=GOSSIP_E_NODES * GOSSIP_F_DATA)
    finally:
        for name in os.listdir(tmp):
            if name.startswith("ftwin_params"):
                os.remove(os.path.join(tmp, name))
    # a step launches SSD twice a layer (the forward and remat's
    # recompute), a sync twice a layer (the gate scores params and
    # candidate)
    predicted = {"ssd_scan": GOSSIP_E_ROUNDS * (2 * GOSSIP_E_STEPS + 2)
                 * GOSSIP_E_LAYERS}
    for rec in twin + shard:
        if rec["launches"] != predicted:
            raise AssertionError(f"(f) launches {rec['launches']}, "
                                 f"predicted {predicted}")
    worst = {"f32": {"max_abs": 0.0, "excess": float("-inf")},
             "bf16": {"max_abs": 0.0, "excess": float("-inf")}}
    for k in range(GOSSIP_E_ROUNDS):
        gates = {tuple(rec["rounds"][k]["gates"]) for rec in twin + shard}
        if len(gates) != 1:
            raise AssertionError(f"(f) round {k}: gates {gates}")
        for rec in shard:
            want = twin[rec["node"]]["rounds"][k]["loss"]
            got = rec["rounds"][k]["loss"]
            for j, (g, w) in enumerate(zip(got, want)):
                rtol = GOSSIP_F_LOSS_RTOL[0 if k == j == 0 else 1]
                if abs(g - w) > rtol * abs(w):
                    raise AssertionError(
                        f"(f) round {k}: node {rec['node']} losses {got}, "
                        f"the twin's {want} (rtol {rtol})")
            counted = rec["rounds"][k]["step_bytes"]
            for kind, n in rec["bytes_from_layout"].items():
                if counted.get(kind, 0) != n:
                    raise AssertionError(f"(f) {kind}: counted "
                                         f"{counted.get(kind)}, the "
                                         f"layout's {n}")
            gate = rec["rounds"][k]["gate_bytes"]
            if gate != {"gate_gather": rec["gate_bytes_from_layout"]}:
                raise AssertionError(f"(f) the split gate's bytes {gate}, "
                                     "the layout's "
                                     f"{rec['gate_bytes_from_layout']}")
            for kind, d in rec["rounds"][k].get("vs_twin", {}).items():
                worst[kind]["max_abs"] = max(worst[kind]["max_abs"],
                                             d["max_abs"])
                worst[kind]["excess"] = max(worst[kind]["excess"],
                                            d["excess"])
                if d["excess"] > 0:
                    raise AssertionError(f"(f) round {k}: {kind} params "
                                         f"beyond the tolerance: {d}")
    gib = lambda b: b / 2 ** 30
    peak = lambda rec: max(rr["steps_peak"] for rr in rec["rounds"])
    emit("gossip_f", card=smi, arch="mamba2-370m", layers=GOSSIP_E_LAYERS,
         backend="gloo", device=f"{dev} (all ranks)",
         mesh={"node": GOSSIP_E_NODES, "data": GOSSIP_F_DATA, "model": 1},
         twin_world=GOSSIP_E_NODES, batch=GOSSIP_E_BATCH,
         rows_per_data_rank=GOSSIP_E_BATCH // GOSSIP_F_DATA,
         seq=GOSSIP_E_SEQ, steps_per_round=GOSSIP_E_STEPS,
         rounds=GOSSIP_E_ROUNDS, remat=True, lr=GOSSIP_F_LR,
         spawn_wall_s={"twin": twin_wall, "split": shard_wall},
         gates=[rec["gates"] for rec in shard[0]["rounds"]],
         loss={"split": [[rr["loss"] for rr in rec["rounds"]]
                         for rec in shard],
               "twin": [[rr["loss"] for rr in rec["rounds"]]
                        for rec in twin],
               "rtol_first_step": GOSSIP_F_LOSS_RTOL[0],
               "rtol_later_steps": GOSSIP_F_LOSS_RTOL[1],
               "largest_rel_diff": max(
                   abs(g - w) / abs(w) for rec in shard
                   for rr, tr in zip(rec["rounds"],
                                     twin[rec["node"]]["rounds"])
                   for g, w in zip(rr["loss"], tr["loss"]))},
         vs_twin=dict(worst, tolerance={k: {"rtol": v[0], "atol": v[1]}
                                        for k, v in GOSSIP_F_TOL.items()},
                      by_round=[[rec["rounds"][k].get("vs_twin")
                                 for rec in shard]
                                for k in range(GOSSIP_E_ROUNDS)]),
         slots={"split": [rec["slots"] for rec in shard],
                "twin": twin[0]["slots"]},
         resident_gib={"split": [gib(rec["rounds"][-1]["resident_after"])
                                 for rec in shard],
                       "twin": [gib(rec["rounds"][-1]["resident_after"])
                                for rec in twin]},
         steps_peak_gib={"split": [gib(peak(rec)) for rec in shard],
                         "twin": [gib(peak(rec)) for rec in twin]},
         steps_peak_ratio=[peak(rec) / peak(twin[rec["node"]])
                           for rec in shard],
         step_bytes={"counted": [rec["rounds"][-1]["step_bytes"]
                                 for rec in shard],
                     "from_layout": [rec["bytes_from_layout"]
                                     for rec in shard],
                     "whole_unit_all_reduce": 4 * shard[0]["values"]},
         gate_bytes={"counted": [rec["rounds"][-1]["gate_bytes"]
                                 for rec in shard],
                     "from_layout": [rec["gate_bytes_from_layout"]
                                     for rec in shard]},
         gate_peak_gib={"split": [[[gib(b) for b in rr["gate_peaks"]]
                                   for rr in rec["rounds"]]
                                  for rec in shard],
                        "twin": [[[gib(b) for b in rr["gate_peaks"]]
                                  for rr in rec["rounds"]] for rec in twin]},
         step_wall_s={"split": [[rr["step_walls"] for rr in rec["rounds"]]
                                for rec in shard],
                      "twin": [[rr["step_walls"] for rr in rec["rounds"]]
                               for rec in twin]},
         round_wall_s={"split": [[rr["wall"] for rr in rec["rounds"]]
                                 for rec in shard],
                       "twin": [[rr["wall"] for rr in rec["rounds"]]
                                for rec in twin]},
         sync_wall_s={"split": [[rr["sync_wall"] for rr in rec["rounds"]]
                                for rec in shard],
                      "twin": [[rr["sync_wall"] for rr in rec["rounds"]]
                               for rec in twin]},
         launches=shard[0]["launches"], predicted=predicted,
         note="6 gloo ranks on one card, one world after the other: gloo "
              "stages CUDA tensors through host memory, so the walls are "
              "host copies and TCP, not NVLink")


# (g) the MoE family's split step and the split gate: granite-moe-3b-a800m
# at its published widths, GOSSIP_G_LAYERS of 32 layers, bf16, remat, on 8
# gloo ranks as (node, data, model) = GOSSIP_G_MESH with the rules' specs
# (experts and the layer axis of o and the experts over model; q, k, v's
# layer axis and the experts' and o's inner dims over data), tensor-
# parallel over each model group (attention head-parallel, 8 KV heads over
# 2; 20 of 40 experts a rank; the vocab 49,408 over 2; the residual cut
# on the sequence); one round of GOSSIP_G_STEPS split steps at
# GOSSIP_G_BATCH rows (half a data rank) and one fedavg/full sync on the
# f32 wire, its gate scored twice a score
GOSSIP_G_ARCH = "granite-moe-3b-a800m"
GOSSIP_G_LAYERS = 2
GOSSIP_G_MESH = (2, 2, 2)
GOSSIP_G_STEPS, GOSSIP_G_BATCH, GOSSIP_G_SEQ = 2, 8, 256
#: the validation rows a node scores its gate on (rows, tokens)
GOSSIP_G_VAL = (2, 256)
GOSSIP_G_LR = 1e-4
#: the head's bytes a logit beside the params: the logits as the head
#: writes them, masked, in f32 and logsumexp's f32 temporary (2 + 2 + 4 + 4)
GOSSIP_G_LOGIT_BYTES = 12
#: the same under tensor parallelism, a logit of the rank's vocab cut: the
#: logits as the head writes them, masked (2 + 2), and the vocab-parallel
#: cross entropy's f32 copy, its shift by the max and the exps (4 + 4 + 4)
GOSSIP_G_TP_LOGIT_BYTES = 16
#: the split gate's metric against the whole-node gate's, relative: the
#: bf16 loss tolerance of a split step's later steps (GOSSIP_F_LOSS_RTOL),
#: the split forward summing each layer's shares over the model group
GOSSIP_G_METRIC_RTOL = GOSSIP_F_LOSS_RTOL[1]


def _moe_block_bytes(cfg, tokens, experts=None):
    """An MoE block's activations at ``tokens`` rows·positions under
    ``no_grad`` (`repro_torch.models.moe.moe`), every one counted as if
    alive at once: the T·k assignments' rows (the dispatched copy, the
    gathered outputs, their gate-weighted copy, the f32 sum: 2 + 2 + 2 + 4
    bytes a value), the [E, cap + 1, D] dispatch buffer and [E, cap, D]
    outputs, and the experts' gate, up and their product [E, cap, F], all
    in bf16 (``experts``: the rank's experts under tensor parallelism).
    Bytes."""
    k, d = cfg.top_k, cfg.d_model
    e = experts or cfg.n_experts
    rows, seq = GOSSIP_G_VAL
    cap = rows * int(max(1, round(seq * k / e * cfg.capacity_factor)))
    return (tokens * k * d * (2 + 2 + 2 + 4) + 2 * e * (2 * cap + 1) * d
            + 3 * 2 * e * cap * cfg.d_ff_expert)


def _gossip_g_counts(shard, cfg, model=1):
    """Each gate's peak allocated above the memory before it, counted
    from the layout and the validation rows' shapes, as the largest of the
    moments that hold the most. The split gate holds the unscanned unit
    (its compute blocks over ``model`` ranks) throughout and, beside it,
    at a layer's gather the layer that ran (the loop still binds it), the
    exchange's buffers (tensor-parallel: the pieces sent and received, at
    most a compute block each; else the rank's contribution) and the
    gathered layer; in a block one layer and the block's activations
    (:func:`_moe_block_bytes`, the rank's experts); at the head the last
    layer and the logits (GOSSIP_G_LOGIT_BYTES each, the rank's vocab
    cut). The whole-node gate holds the shard group's slots as the
    all_gather receives them and the node's slots assembled, then the
    node and the head's or a block's bytes. Bytes."""
    import numpy as np
    from repro_torch.models.gather import NodeSplit
    from repro_torch.sharding.rules import placement
    from repro_torch.sharding.tensor import TensorPlan

    class _View:
        world_size, rank = model, 0

    tp = (TensorPlan(_View(), placement(cfg, model), cfg) if model > 1
          else None)
    plan = NodeSplit(shard, None, None, dtype=_dtype(cfg.param_dtype),
                     tensor=tp)
    whole = lambda cut: sum(int(np.prod(s)) * dt.itemsize
                            for s, dt in zip(cut.shapes, cut.dtypes))
    held = lambda cut: sum(int(np.prod(s)) * dt.itemsize
                           for s, dt in zip(cut.cshapes, cut.dtypes))
    cut = plan.cuts["layers"]
    rows, seq = GOSSIP_G_VAL
    itemsize = _dtype(cfg.param_dtype).itemsize
    node = shard.full.size * itemsize
    whole_block = _moe_block_bytes(cfg, rows * seq)
    whole_head = rows * seq * cfg.padded_vocab * GOSSIP_G_LOGIT_BYTES
    if tp is None:
        unit, layer = whole(plan.unit), whole(cut)
        exchange = (plan.unit.nbytes, cut.nbytes)
        head, block = whole_head, whole_block
    else:
        unit, layer = held(plan.unit), held(cut)
        exchange = (2 * unit, 2 * layer)
        head = (rows * seq * cfg.padded_vocab // model
                * GOSSIP_G_TP_LOGIT_BYTES + rows * seq * cfg.d_model
                * itemsize)
        block = _moe_block_bytes(cfg, rows * seq, cfg.n_experts // model)
    return {"split": unit + max(exchange[0], 2 * layer + exchange[1],
                                layer + max(head, block)),
            "whole": max(shard.group_size * shard.local.size * itemsize
                         + node, node + max(whole_head, whole_block)),
            "two_nodes": 2 * node}


def _dtype(name):
    import torch
    return getattr(torch, name)


def _gossip_rank_g(rank, world, init, tmp, dev):
    """(g) One gloo rank on ``cuda:0``: block ``(d, m)`` of node ``rank //
    4`` of GOSSIP_G_MESH, granite-moe-3b-a800m at GOSSIP_G_LAYERS layers
    from the seed-0 init, the TrainStep split and the `SwarmEval` split
    gate; one round. At the sync each score runs through the split gate
    and then through the whole-node gather (node positions one after the
    other). Into ``tmp/g<r>.pt``: gates, both gates' metrics and peaks,
    counted and layout bytes, walls, memory, launches."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.engine import gate_decisions
    from repro_torch.core.session import SwarmSession
    from repro_torch.data import make_lm_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    dev = torch.device(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    n, d, m = GOSSIP_G_MESH
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh, axis = make_swarm_mesh(n, data=d, model=m)
        cfg = dataclasses.replace(get_config(GOSSIP_G_ARCH),
                                  n_layers=GOSSIP_G_LAYERS)
        model = build_model(cfg)
        layout = model.layout
        step = train.make_train_step(model, TrainConfig(
            lr=GOSSIP_G_LR, warmup_steps=0, max_steps=10, remat=True))
        streams = [make_lm_stream(32, GOSSIP_G_SEQ, cfg.vocab_size, seed=i,
                                  topic_bias=1.0) for i in range(n)]
        rng = np.random.default_rng(0)

        def to_dev(arrays):
            return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

        vrows, vseq = GOSSIP_G_VAL
        vals = to_dev({k: np.stack([st[k][-vrows:, :vseq] for st in streams])
                       for k in streams[0]})
        idx = [rng.integers(0, len(st["tokens"]) - vrows,
                            (GOSSIP_G_STEPS, GOSSIP_G_BATCH))
               for st in streams]
        batch = to_dev({k: np.stack([st[k][i] for st, i in
                                     zip(streams, idx)], axis=1)
                        for k in streams[0]})
        scfg = dataclasses.replace(_gossip_e_cfg("f32"),
                                   sync_every=GOSSIP_G_STEPS)
        # a session starts from the node whole (its params and AdamW
        # moments tiled over the 2 nodes, about 27 GiB, then sharded):
        # the ranks build theirs one at a time
        sess = None
        for r in range(world):
            if r == rank:
                p0 = model.init(torch.Generator(device=dev).manual_seed(0),
                                dev)
                sess = SwarmSession(
                    scfg, step, train.make_swarm_eval(model), params=p0,
                    opt_state=adamw_init(layout.parts(p0)),
                    data_sizes=[float(len(st["tokens"])) for st in streams],
                    layout=layout, device=dev, backend="gossip", mesh=mesh,
                    axis=axis, param_specs=param_specs(layout, mesh))
                del p0
                torch.cuda.empty_cache()
            dist.barrier()
        eng = sess.engine
        if not (eng.splits and eng.split_gate):
            raise AssertionError(f"(g) rank {rank}: splits={eng.splits}, "
                                 f"split_gate={eng.split_gate}")
        step_count, gate = _tp_bytes(
            eng.shard, cfg, GOSSIP_G_LAYERS, sess.state.params.element_size(),
            GOSSIP_G_BATCH // d, GOSSIP_G_SEQ, True, val=GOSSIP_G_VAL)
        position = mesh.rows.start

        def by_position(fn):
            # the whole-node gathers a node position at a time, every rank's
            # cached blocks released first: the card holds the four ranks
            # of one node's gathered slots at once
            res = None
            for q in range(n):
                torch.cuda.empty_cache()
                dist.barrier()
                if q == position:
                    res = fn()
            torch.cuda.empty_cache()
            dist.barrier()
            return res

        gates_log, log_t = {}, {"steps": []}
        _gate_meter(eng, gates_log, split_and_whole=True,
                    barrier=by_position)
        sync, local_steps = eng.sync, eng.local_steps

        def timed_sync(*a, **kw):
            torch.cuda.synchronize()
            log_t["steps_peak"] = torch.cuda.max_memory_allocated()
            log_t["sync_resident"] = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            res = sync(*a, **kw)
            torch.cuda.synchronize()
            log_t["sync"] = time.perf_counter() - t0
            return res

        def timed_steps(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = local_steps(*a, **kw)
            torch.cuda.synchronize()
            log_t["steps"].append(time.perf_counter() - t0)
            log_t.setdefault("step_bytes", []).append(
                dict(sess.engine.step_bytes))
            return res

        eng.sync, eng.local_steps = timed_sync, timed_steps
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        log = sess.round(batch, vals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in LAUNCHES.items() if v}
        eng.sync, eng.local_steps = sync, local_steps
        split, whole = gates_log["split"], gates_log["whole"]
        mine = torch.ones(mesh.per, dtype=torch.bool)
        thr = scfg.val_threshold

        def bits(rec):
            ml, mm = (torch.tensor(r["metric"]) for r in rec)
            return (gate_decisions(mm, ml, thr) & mine).tolist()

        sync_bytes = sess.counted_sync_bytes
        # the layer a rank receives: its compute blocks, against the whole
        from repro_torch.models.gather import NodeSplit
        cut = NodeSplit(eng.shard, None, None, dtype=_dtype(cfg.param_dtype),
                        tensor=train.tensor_plan(model, mesh)).cuts["layers"]
        out = dict(
            coords=dict(mesh.coords), node=position,
            layer_block_bytes=sum(int(np.prod(s)) * t.itemsize
                                  for s, t in zip(cut.cshapes, cut.dtypes)),
            layer_whole_bytes=sum(int(np.prod(s)) * t.itemsize
                                  for s, t in zip(cut.shapes, cut.dtypes)),
            gates=log["gates"].tolist(),
            gates_split=bits(split), gates_whole=bits(whole),
            metric_split=[r["metric"] for r in split],
            metric_whole=[r["metric"] for r in whole],
            peak_split=[r["peak"] for r in split],
            peak_whole=[r["peak"] for r in whole],
            counts=_gossip_g_counts(eng.shard, cfg, m),
            loss=log["train"]["loss"][:, 0].float().cpu().tolist(),
            step_bytes=log_t["step_bytes"], step_from_layout=step_count,
            gate_bytes={k: v for k, v in sync_bytes.items()
                        if k in ("gate_gather", "shard_gather")
                        or k.startswith("tp_")},
            gate_from_layout={k: 2 * mesh.per * v for k, v in gate.items()},
            # the whole-node gate: two all_gathers of the rank's slot rows
            shard_from_layout=2 * sess.state.params.numel()
            * sess.state.params.element_size(),
            whole_unit_grad_reduce=4 * layout.n_values,
            wall=wall, step_walls=log_t["steps"], sync_wall=log_t["sync"],
            resident=resident, sync_resident=log_t["sync_resident"],
            steps_peak=log_t["steps_peak"],
            peak=torch.cuda.max_memory_allocated(),
            reserved=torch.cuda.max_memory_reserved(),
            local_values=eng.shard.local.n_values,
            node_values=layout.n_values, launches=launches)
        torch.save(out, f"{tmp}/g{rank}.pt")
        del sess, eng, batch, vals
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _gossip_moe(dev, smi, tmp):
    """(g) The 8 ranks of GOSSIP_G_MESH on the card, alone. Raises on any
    failed check."""
    import math
    n, d, m = GOSSIP_G_MESH
    with _expandable_segments():
        wall, ranks = _gossip_spawn(_gossip_rank_g, tmp, dev, "g",
                                    world=n * d * m)
    # flash once a layer in a step's forward and again in remat's
    # recompute, and once a layer a gate score: the params and the
    # candidate, each through the split gate and the whole-node gather
    predicted = {"flash_attention": GOSSIP_G_LAYERS
                 * (2 * GOSSIP_G_STEPS + 2 * 2)}
    gates = {tuple(rec["gates"]) for rec in ranks}
    if len(gates) != 1:
        raise AssertionError(f"(g) gates {gates}")
    for r, rec in enumerate(ranks):
        if rec["launches"] != predicted:
            raise AssertionError(f"(g) rank {r}: launches "
                                 f"{rec['launches']}, predicted {predicted}")
        # the split gate divides each layer's work over the model group:
        # its bf16 sums run in another order than the whole node's
        for a, b in zip(rec["metric_split"], rec["metric_whole"]):
            for x, y in zip(a, b):
                if abs(x - y) > GOSSIP_G_METRIC_RTOL * abs(y):
                    raise AssertionError(
                        f"(g) rank {r}: split gate {rec['metric_split']}"
                        f", whole-node {rec['metric_whole']}")
        mine = rec["gates"][rec["node"]:rec["node"] + 1]
        if not rec["gates_split"] == rec["gates_whole"] == mine:
            raise AssertionError(
                f"(g) rank {r}: gates split {rec['gates_split']}, whole "
                f"{rec['gates_whole']}, the session's {mine}")
        for sb in rec["step_bytes"]:
            for kind, nbytes in rec["step_from_layout"].items():
                if sb.get(kind, 0) != nbytes:
                    raise AssertionError(f"(g) rank {r} {kind}: counted "
                                         f"{sb.get(kind)}, the layout's "
                                         f"{nbytes}")
        want = dict(rec["gate_from_layout"],
                    shard_gather=rec["shard_from_layout"])
        if rec["gate_bytes"] != want:
            raise AssertionError(f"(g) rank {r}: gate bytes "
                                 f"{rec['gate_bytes']}, the layout's {want}")
        counts = rec["counts"]
        for kind in ("split", "whole"):
            if max(rec[f"peak_{kind}"]) > counts[kind]:
                raise AssertionError(
                    f"(g) rank {r}: the {kind} gate's peak "
                    f"{rec[f'peak_{kind}']} above its count {counts[kind]}")
        if min(rec["peak_whole"]) < counts["two_nodes"]:
            raise AssertionError(
                f"(g) rank {r}: the whole-node gate's peak "
                f"{rec['peak_whole']} below two nodes' slots "
                f"{counts['two_nodes']}")
        for loss in rec["loss"]:
            if not math.isfinite(loss):
                raise AssertionError(f"(g) rank {r}: loss {rec['loss']}")
    gib = lambda b: b / 2 ** 30
    first = ranks[0]
    emit("gossip_g", card=smi, arch=GOSSIP_G_ARCH, layers=GOSSIP_G_LAYERS,
         backend="gloo", device=f"{dev} (all ranks)",
         mesh=dict(zip(("node", "data", "model"), GOSSIP_G_MESH)),
         tensor_parallel=True,
         layer_block_gib=gib(first["layer_block_bytes"]),
         layer_whole_gib=gib(first["layer_whole_bytes"]),
         metric_rtol=GOSSIP_G_METRIC_RTOL,
         batch=GOSSIP_G_BATCH, rows_per_data_rank=GOSSIP_G_BATCH // d,
         seq=GOSSIP_G_SEQ, steps=GOSSIP_G_STEPS, val=GOSSIP_G_VAL,
         remat=True, lr=GOSSIP_G_LR, spawn_wall_s=wall,
         gates=first["gates"],
         loss=[rec["loss"] for rec in ranks],
         metrics={"split": [rec["metric_split"] for rec in ranks],
                  "whole": [rec["metric_whole"] for rec in ranks],
                  "bit_equal": all(rec["metric_split"] == rec["metric_whole"]
                                   for rec in ranks)},
         gate_peak_gib={k: [[gib(b) for b in rec[f"peak_{k}"]]
                            for rec in ranks] for k in ("split", "whole")},
         gate_count_gib={k: gib(first["counts"][k])
                         for k in ("split", "whole", "two_nodes")},
         step_bytes={"counted": [rec["step_bytes"][-1] for rec in ranks],
                     "from_layout": [rec["step_from_layout"]
                                     for rec in ranks],
                     "grad_sum": [sum(v for k, v in
                                      rec["step_bytes"][-1].items()
                                      if k.startswith("grad_"))
                                  for rec in ranks],
                     "whole_unit_all_reduce": first["whole_unit_grad_reduce"]},
         gate_bytes={"counted": [rec["gate_bytes"] for rec in ranks],
                     "split_from_layout": first["gate_from_layout"],
                     "whole_from_layout": first["shard_from_layout"]},
         values={"local": [rec["local_values"] for rec in ranks],
                 "node": first["node_values"]},
         step_wall_s=[rec["step_walls"] for rec in ranks],
         sync_wall_s=[rec["sync_wall"] for rec in ranks],
         round_wall_s=[rec["wall"] for rec in ranks],
         resident_gib=[gib(rec["resident"]) for rec in ranks],
         sync_resident_gib=[gib(rec["sync_resident"]) for rec in ranks],
         steps_peak_gib=[gib(rec["steps_peak"]) for rec in ranks],
         peak_gib=[gib(rec["peak"]) for rec in ranks],
         reserved_gib=[gib(rec["reserved"]) for rec in ranks],
         launches=first["launches"], predicted=predicted,
         note="8 gloo ranks on one card: the collectives go through host "
              "memory and TCP, not NVLink; the sync's walls hold both "
              "gates, the whole-node one a node position at a time")


# (h) the hybrid family tensor-parallel: Hymba-1.5B at its published
# widths, GOSSIP_H_LAYERS of 32 layers (a global-attention layer, then a
# sliding one of window 1024), bf16, remat, as (node, data, model) =
# GOSSIP_H_MESH on 4 gloo ranks against its unsharded twin on 2 (a node
# each): attention sequence-parallel (5 KV heads over 2: a rank's 1,024
# query rows at q_off 0 or 1,024 over the whole 2,048 keys), 25 of 50 SSM
# heads a rank with the gated norm's all_reduce, ff 5,504 and the vocab
# 32,256 over 2, the residual cut on the sequence; one round of
# GOSSIP_H_STEPS steps of GOSSIP_H_BATCH rows and a fedavg/full sync on
# the f32 wire, the split gate against the twin's
GOSSIP_H_ARCH = "hymba-1.5b"
GOSSIP_H_LAYERS = 2
GOSSIP_H_MESH = (2, 1, 2)
GOSSIP_H_STEPS, GOSSIP_H_BATCH, GOSSIP_H_SEQ = 2, 2, 2048
GOSSIP_H_VAL = (2, 2048)
# after the round, one more split step from the seed-0 init on a sequence
# the model group does not divide (the whole residual): the first
# GOSSIP_<PART>_ODD tokens of the round's first batch (and an enc-dec's
# first GOSSIP_<PART>_ODD_FRAMES frames), against its twin's step
GOSSIP_H_ODD, GOSSIP_H_ODD_FRAMES = 2047, None
# the odd step's lr: one AdamW step from the same init moves a value by at
# most lr, so the two nodes differ by at most 2 · lr where a gradient at
# the rounding floor changes sign between the two sums (no merge after it
# halves that, as the round's does: PR 31's (h) round read 7.51e-5 = lr on
# its f32 leaves); GOSSIP_F_TOL's f32 atol 1e-4 is 2 · this lr. The step
# is held by its gradient too, as (j) holds its bf16 logits: against the
# twin's weights' gradient evaluated in f32 on the same batch, each
# leaf's largest difference over its largest magnitude, the split's worst
# leaf at most GOSSIP_J_BF16_RATIO times the twin's worst (a block summed
# twice or dropped is off by its whole size)
GOSSIP_ODD_LR = 5e-5
# (i) seamless-m4t-medium tensor-parallel: GOSSIP_I_LAYERS of its 12
# encoder and of its 12 decoder layers, rows of GOSSIP_I_FRAMES frames and
# GOSSIP_I_SEQ target tokens
GOSSIP_I_ARCH = "seamless-m4t-medium"
GOSSIP_I_LAYERS = 2
GOSSIP_I_MESH = (2, 1, 2)
GOSSIP_I_STEPS, GOSSIP_I_BATCH, GOSSIP_I_SEQ = 2, 2, 256
GOSSIP_I_FRAMES = 1024
GOSSIP_I_VAL = (2, 256)
GOSSIP_I_ODD, GOSSIP_I_ODD_FRAMES = 255, 1023


def _tp_part(part, name):
    """Part ``part``'s (``"h"``, ``"i"``) setting ``GOSSIP_<PART>_<name>``,
    read when called (a rehearsal on the CPU sets them first)."""
    return globals()[f"GOSSIP_{part.upper()}_{name}"]


def _gossip_rank_h(rank, world, init, tmp, dev):
    """(h) Hymba-1.5B: :func:`_gossip_rank_tp` of part h."""
    _gossip_rank_tp("h", rank, world, init, tmp, dev)


def _gossip_rank_i(rank, world, init, tmp, dev):
    """(i) seamless-m4t-medium: :func:`_gossip_rank_tp` of part i."""
    _gossip_rank_tp("i", rank, world, init, tmp, dev)


def _gossip_rank_tp(part, rank, world, init, tmp, dev):
    """(h), (i) One gloo rank on ``cuda:0``: with a world of 4, model block
    ``rank % 2`` of node ``rank // 2`` of the part's MESH, the rules'
    specs, the TrainStep and the split gate tensor-parallel; with a world
    of 2, node ``rank`` whole (the twin: it writes its node's params to
    ``tmp``). The part's ARCH at LAYERS layers (an enc-dec: LAYERS encoder
    and LAYERS decoder layers, its frames drawn on the card from a seeded
    generator) from the seed-0 init, lr GOSSIP_F_LR. Into
    ``tmp/<tag><r>.pt``: gates, node losses, metrics, walls, memory,
    counted and layout bytes, launches, on a sharded rank each stack's
    compute block against its whole layer, and on a sharded rank of model
    index 0 the largest difference from the twin's node by leaf kind."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.session import SwarmSession
    from repro_torch.data import make_lm_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_swarm_mesh
    from repro_torch.models import build_model
    from repro_torch.models.gather import NodeSplit
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.rules import param_specs

    C = lambda name: _tp_part(part, name)
    dev = torch.device("cuda", 0) if str(dev).startswith("cuda") else \
        torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n, d, m = C("MESH")
    sharded = world == n * d * m
    tag = f"{part}shard" if sharded else f"{part}twin"
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh, axis = (make_swarm_mesh(n, data=d, model=m) if sharded
                      else make_swarm_mesh(n))
        cfg = get_config(C("ARCH"))
        depth = dict(n_layers=C("LAYERS"))
        if cfg.is_encdec:
            depth["n_enc_layers"] = C("LAYERS")
        cfg = dataclasses.replace(cfg, **depth)
        model = build_model(cfg)
        layout = model.layout
        step = train.make_train_step(model, TrainConfig(
            lr=GOSSIP_F_LR, warmup_steps=0, max_steps=10, remat=True))
        steps, rows, seq = C("STEPS"), C("BATCH"), C("SEQ")
        streams = [make_lm_stream(8, seq, cfg.vocab_size, seed=i,
                                  topic_bias=1.0) for i in range(n)]
        rng = np.random.default_rng(0)

        def to_dev(arrays):
            return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

        vrows, vseq = C("VAL")
        vals = to_dev({k: np.stack([st[k][-vrows:, :vseq] for st in streams])
                       for k in streams[0]})
        idx = [rng.integers(0, len(st["tokens"]) - vrows, (steps, rows))
               for st in streams]
        batch = to_dev({k: np.stack([st[k][i] for st, i in
                                     zip(streams, idx)], axis=1)
                        for k in streams[0]})
        if cfg.is_encdec:   # the stub front end's frames, made on the card
            gen = torch.Generator(device=dev).manual_seed(1)
            shape = (C("FRAMES"), cfg.frontend_dim)
            batch["frames"] = torch.randn((steps, n, rows) + shape,
                                          generator=gen, device=dev)
            vals["frames"] = torch.randn((n, vrows) + shape, generator=gen,
                                         device=dev)
        scfg = dataclasses.replace(_gossip_e_cfg("f32"), sync_every=steps)
        # a session starts from the node whole (its params and AdamW
        # moments tiled over the 2 nodes: about 17 GiB for (i), then
        # sharded): the ranks build theirs one at a time
        sess = None
        for r in range(world):
            if r == rank:
                p0 = model.init(torch.Generator(device=dev).manual_seed(0),
                                dev)
                sess = SwarmSession(
                    scfg, step, train.make_swarm_eval(model), params=p0,
                    opt_state=adamw_init(layout.parts(p0)),
                    data_sizes=[float(len(st["tokens"])) for st in streams],
                    layout=layout, device=dev, backend="gossip", mesh=mesh,
                    axis=axis,
                    param_specs=param_specs(layout, mesh) if sharded
                    else None)
                del p0
                torch.cuda.empty_cache()
            dist.barrier()
        eng = sess.engine
        if eng.splits != sharded or eng.split_gate != sharded:
            raise AssertionError(f"({part}) rank {rank}: splits="
                                 f"{eng.splits}, split_gate="
                                 f"{eng.split_gate}")
        node_of = mesh.rows.start
        out = {"coords": dict(mesh.coords), "node": node_of}
        if sharded:
            frames = C("FRAMES") if cfg.is_encdec else None
            out["step_from_layout"], gate = _tp_bytes(
                eng.shard, cfg, C("LAYERS"),
                sess.state.params.element_size(), rows, seq, False,
                val=C("VAL"), frames=frames)
            out["gate_from_layout"] = {k: 2 * mesh.per * v
                                       for k, v in gate.items()}
            # the layer a rank receives: its compute blocks, against the
            # whole layer, a stack each
            cuts = NodeSplit(eng.shard, None, None,
                             dtype=sess.state.params.dtype,
                             tensor=train.tensor_plan(model, mesh)).cuts
            nbytes = lambda shapes, cut: sum(
                int(np.prod(sh)) * t.itemsize
                for sh, t in zip(shapes, cut.dtypes))
            out["blocks"] = {top: dict(block=nbytes(cut.cshapes, cut),
                                       whole=nbytes(cut.shapes, cut))
                             for top, cut in cuts.items()}
        log_t = {"steps": []}
        sync, local_steps = eng.sync, eng.local_steps

        def timed_sync(*a, **kw):
            torch.cuda.synchronize()
            log_t["steps_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = sync(*a, **kw)
            torch.cuda.synchronize()
            log_t["sync"] = time.perf_counter() - t0
            log_t["sync_peak"] = torch.cuda.max_memory_allocated()
            return res

        def timed_steps(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = local_steps(*a, **kw)
            torch.cuda.synchronize()
            log_t["steps"].append(time.perf_counter() - t0)
            log_t.setdefault("step_bytes", []).append(
                dict(eng.step_bytes or {}))
            return res

        eng.sync, eng.local_steps = timed_sync, timed_steps
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        log = sess.round(batch, vals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng.sync, eng.local_steps = sync, local_steps
        sync_bytes = sess.counted_sync_bytes
        out.update(
            gates=log["gates"].tolist(),
            metrics=[log["metric_local"].float().cpu().tolist(),
                     log["metric_merged"].float().cpu().tolist()],
            loss=log["train"]["loss"][:, 0].float().cpu().tolist(),
            wall=wall, step_walls=log_t["steps"], sync_wall=log_t["sync"],
            resident=resident, steps_peak=log_t["steps_peak"],
            sync_peak=log_t["sync_peak"],
            step_bytes=log_t.get("step_bytes", []),
            gate_bytes={k: v for k, v in sync_bytes.items()
                        if k in ("gate_gather", "shard_gather")
                        or k.startswith("tp_")},
            launches={k: v for k, v in LAUNCHES.items() if v})
        node = eng.node_tensor(sess.state.params, kind=None)[0]
        if not sharded:
            torch.save(node.cpu(), f"{tmp}/{part}twin_params_n{rank}.pt")
        elif mesh.coords["model"] == 0:
            twin = torch.load(f"{tmp}/{part}twin_params_n{node_of}.pt").to(
                dev)
            got, want = layout.values(node), layout.values(twin)
            w = layout.n_wide
            diffs = {}
            for kind, sl in (("f32", slice(0, w)), ("bf16", slice(w, None))):
                rtol, atol = GOSSIP_F_TOL[kind]
                dd = (got[sl] - want[sl]).abs()
                if not dd.numel():   # seamless keeps no leaf in f32
                    continue
                diffs[kind] = dict(
                    max_abs=float(dd.max()),
                    excess=float((dd - atol - rtol * want[sl].abs()).max()),
                    changed=int((got[sl] != want[sl]).sum()),
                    values=int(dd.numel()))
            out["vs_twin"] = diffs
        # the session released before the odd step: the ranks of every
        # world spawned together share the card's memory
        shard = eng.shard
        del sess, eng, node
        torch.cuda.empty_cache()
        out["odd"] = _gossip_odd_step(part, model, shard, mesh, batch,
                                      node_of, tmp, rank, dev)
        torch.save(out, f"{tmp}/{tag}{rank}.pt")
        torch.cuda.empty_cache()
        if part == "h" and sharded:
            # (j) in the same world: each node position's model group
            # serves one of GOSSIP_J_ARCHS
            torch.save(_gossip_rank_j(mesh, dev), f"{tmp}/jserve{rank}.pt")
        if part == "i" and sharded:
            # (k) in the same world: each node position's model group
            # serves the enc-dec
            torch.save(_gossip_rank_k(mesh, dev), f"{tmp}/kserve{rank}.pt")
    finally:
        dist.destroy_process_group()


def _gossip_odd_step(part, model, shard, mesh, batch, node, tmp, rank, dev):
    """(h), (i) One step from the seed-0 init at GOSSIP_ODD_LR on the
    part's ODD tokens (and ODD_FRAMES frames) of the round's first batch
    of node ``node``, which the model group does not divide: on a sharded
    rank (``shard`` its `repro_torch.core.flat.ShardLayout`, None on a
    twin rank) the split step in the whole-residual form (its bytes by kind
    beside `_tp_bytes`'s count, its launches; on model index 0 the node
    after it against the twin's by leaf kind within GOSSIP_F_TOL, and its
    gradient's distance from the f32 gradient), on a twin rank the whole
    node's step, after the gradient of the same weights in f32 on the same
    batch (its gradient's distance from that; the node and the f32
    gradient, by leaf, written to ``tmp``). Returns the record: loss,
    wall, launches, bytes, the differences from the twin and from the f32
    gradient."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    C = lambda name: _tp_part(part, name)
    seq, frames = C("ODD"), C("ODD_FRAMES")
    b = {k: batch[k][0, node][:, :seq] for k in ("tokens", "labels")}
    if frames:
        b["frames"] = batch["frames"][0, node][:, :frames]
    layout = model.layout
    step = train.make_train_step(model, TrainConfig(
        lr=GOSSIP_ODD_LR, warmup_steps=0, max_steps=10, remat=True))
    p0 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    rec = dict(seq=seq, frames=frames, lr=GOSSIP_ODD_LR)
    seen, update = {}, train.adamw_update_

    def captured(parts, grads, *a, **kw):
        seen["grads"] = [g.detach().clone() for g in grads]
        return update(parts, grads, *a, **kw)

    def by_leaf(lay, grads):
        return {q: t.float() for q, t in lay.value_layout.unflatten(
            lay.values(lay.join(grads))).items()}

    sharded = shard is not None
    if not sharded:     # the gradient of the same weights in f32, first
        import dataclasses
        m32 = build_model(dataclasses.replace(
            model.cfg, param_dtype="float32", compute_dtype="float32"))
        flat = torch.empty(m32.layout.size, dtype=torch.float32, device=dev)
        views, src = m32.layout.unflatten(flat), layout.unflatten(p0)
        for path, t in views.items():
            t.copy_(src[path])
        parts = m32.layout.parts(flat)
        loss, vjp_fn, _ = torch.func.vjp(
            lambda q: m32.loss_fn(m32.layout.unflatten_parts(q), b,
                                  remat=True), parts, has_aux=True)
        (g,) = vjp_fn(torch.ones_like(loss), retain_graph=False,
                      create_graph=False)
        g32 = {q: t.cpu() for q, t in by_leaf(m32.layout, g).items()}
        del m32, flat, views, src, parts, loss, vjp_fn, g
        torch.cuda.empty_cache()
    train.adamw_update_ = captured
    reset_launches()
    mesh.reset_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sharded:
            ps = shard.shard(p0[None])[0]
            del p0
            ps, _, met = step.split(ps, adamw_init(shard.local.parts(ps)),
                                    b, shard=shard, mesh=mesh)
        else:
            p, _, met = step(p0, adamw_init(layout.parts(p0)), b)
        torch.cuda.synchronize()
    finally:
        train.adamw_update_ = update
    rec.update(wall=time.perf_counter() - t0, loss=float(met["loss"]),
               launches={k: v for k, v in LAUNCHES.items() if v})
    if not sharded:
        mine = by_leaf(layout, seen["grads"])
        rel = _grad_rel(mine, g32)
        rec["grad_rel"] = dict(twin=max(rel.values()),
                               twin_leaf=max(rel, key=rel.get))
        torch.save(dict(params=p.cpu(), f32=g32),
                   f"{tmp}/{part}twin_params_odd_n{rank}.pt")
        return rec
    rec["bytes"] = {k: v for k, v in mesh.counts.items()
                    if k != "step_control"}
    rec["from_layout"] = _tp_bytes(
        shard, model.cfg, C("LAYERS"), ps.element_size(), b["tokens"].shape[0],
        seq, False, frames=frames)[0]
    node_p = shard.gather(ps[None], mesh.shard_view, kind=None)[0]
    grads = shard.gather(shard.local.join(seen["grads"])[None],
                         mesh.shard_view, kind=None)[0]
    if mesh.coords["model"] == 0:
        twin = torch.load(f"{tmp}/{part}twin_params_odd_n{node}.pt")
        got = layout.values(node_p)
        want = layout.values(twin["params"].to(dev))
        w = layout.n_wide
        rec["vs_twin"] = {}
        for kind, sl in (("f32", slice(0, w)), ("bf16", slice(w, None))):
            rtol, atol = GOSSIP_F_TOL[kind]
            dd = (got[sl] - want[sl]).abs()
            if dd.numel():
                rec["vs_twin"][kind] = dict(
                    max_abs=float(dd.max()),
                    excess=float((dd - atol - rtol * want[sl].abs()).max()),
                    changed=int((got[sl] != want[sl]).sum()),
                    values=int(dd.numel()))
        split = _grad_rel({q: t.float() for q, t in
                           layout.value_layout.unflatten(
                               layout.values(grads)).items()}, twin["f32"])
        worst = max(split, key=split.get)
        rec["grad_rel"] = dict(split=split[worst], leaf=worst,
                               leaves=len(split), ratio=GOSSIP_J_BF16_RATIO)
    return rec


def _grad_rel(got, f32):
    """``{leaf: max |got − f32| / max |f32|}`` of two gradients by leaf,
    on the device ``got`` lies on (``f32`` there or on the host)."""
    return {q: float((t - f32[q].to(t.device)).abs().max()
                     / f32[q].to(t.device).abs().max().clamp(min=1e-30))
            for q, t in got.items()}


def _gossip_odd_launches(part):
    """The flash (and SSD) launches of the part's odd step: each
    checkpointed layer's mixers in the forward and in remat's recompute;
    an enc-dec's encoder layers once, its decoder's self- and
    cross-attention each as a checkpointed layer's."""
    layers = _tp_part(part, "LAYERS")
    if part == "i":
        return {"flash_attention": layers + 2 * 2 * layers}
    return {"flash_attention": 2 * layers, "ssd_scan": 2 * layers}


def _gossip_tp_launches(part):
    """The flash (and SSD) launches a rank of part ``part`` makes in its
    round: once a layer's mixer in each step's forward and again in
    remat's recompute, and once a layer's mixer a gate score (params,
    candidate); an enc-dec's encoder layers (never checkpointed) once a
    step and once a score, its decoder layers' self- and cross-attention
    each as a checkpointed layer's."""
    layers, steps = _tp_part(part, "LAYERS"), _tp_part(part, "STEPS")
    if part == "i":
        return {"flash_attention": layers * (steps + 2)
                + 2 * layers * (2 * steps + 2)}
    launches = layers * (2 * steps + 2)
    return {"flash_attention": launches, "ssd_scan": launches}


def _gossip_tp(part, dev, smi, tmp, twin):
    """(h), (i) The tensor-parallel world (4 ranks, 2 nodes × model 2) on
    the card, after its twin (2 ranks, a node each; ``twin``: its wall
    and its ranks' records), whose params the split round is held
    against. Raises on any failed check."""
    import math
    import os

    C = lambda name: _tp_part(part, name)
    twin_wall, twin = twin
    n, d, m = C("MESH")
    rank_fn = {"h": _gossip_rank_h, "i": _gossip_rank_i}[part]
    try:
        with _expandable_segments():
            wall, ranks = _gossip_spawn(rank_fn, tmp, dev, f"{part}shard",
                                        world=n * d * m)
    finally:
        for name in os.listdir(tmp):
            if name.startswith(f"{part}twin_params"):
                os.remove(os.path.join(tmp, name))
    predicted = _gossip_tp_launches(part)
    # the split forward divides each layer's work over the model group:
    # its bf16 losses within the later steps' tolerance from the first
    rtol = GOSSIP_F_LOSS_RTOL[1]
    gates = {tuple(rec["gates"]) for rec in twin + ranks}
    if len(gates) != 1:
        raise AssertionError(f"({part}) gates {gates}")
    for r, rec in enumerate(twin + ranks):
        if rec["launches"] != predicted:
            raise AssertionError(f"({part}) rank {r}: launches "
                                 f"{rec['launches']}, predicted {predicted}")
    for r, rec in enumerate(ranks):
        tw = twin[rec["node"]]
        for g, w in zip(rec["loss"], tw["loss"]):
            if abs(g - w) > rtol * abs(w):
                raise AssertionError(f"({part}) rank {r}: losses "
                                     f"{rec['loss']}, the twin's "
                                     f"{tw['loss']}")
        for a, b in zip(rec["metrics"], tw["metrics"]):
            if any(abs(x - y) > rtol * abs(y) for x, y in zip(a, b)):
                raise AssertionError(f"({part}) rank {r}: metrics "
                                     f"{rec['metrics']}, the twin's "
                                     f"{tw['metrics']}")
        for sb in rec["step_bytes"]:
            for kind, nbytes in rec["step_from_layout"].items():
                if sb.get(kind, 0) != nbytes:
                    raise AssertionError(f"({part}) rank {r} {kind}: "
                                         f"counted {sb.get(kind)}, the "
                                         f"layout's {nbytes}")
        if rec["gate_bytes"] != rec["gate_from_layout"]:
            raise AssertionError(f"({part}) rank {r}: gate bytes "
                                 f"{rec['gate_bytes']}, the layout's "
                                 f"{rec['gate_from_layout']}")
        for kind, dd in rec.get("vs_twin", {}).items():
            if dd["excess"] > 0:
                raise AssertionError(f"({part}) rank {r}: {kind} params "
                                     f"beyond the tolerance: {dd}")
        for top, b in rec["blocks"].items():
            if not b["block"] < b["whole"]:
                raise AssertionError(f"({part}) rank {r}: a {top} compute "
                                     f"block of {b['block']} bytes, the "
                                     f"whole layer's {b['whole']}")
        for loss in rec["loss"]:
            if not math.isfinite(loss):
                raise AssertionError(f"({part}) rank {r}: loss "
                                     f"{rec['loss']}")
        # the odd step: the whole residual against the twin's step
        odd, tw_odd = rec["odd"], tw["odd"]
        if odd["bytes"] != odd["from_layout"]:
            raise AssertionError(f"({part}) rank {r} odd step: bytes "
                                 f"{odd['bytes']}, the layout's "
                                 f"{odd['from_layout']}")
        if not (math.isfinite(odd["loss"]) and abs(
                odd["loss"] - tw_odd["loss"]) <= rtol * abs(tw_odd["loss"])):
            raise AssertionError(f"({part}) rank {r} odd step: loss "
                                 f"{odd['loss']}, the twin's "
                                 f"{tw_odd['loss']}")
        for kind, dd in odd.get("vs_twin", {}).items():
            if dd["excess"] > 0:
                raise AssertionError(f"({part}) rank {r} odd step: {kind} "
                                     f"params beyond the tolerance: {dd}")
        gr = odd.get("grad_rel")
        if gr and not gr["split"] <= gr["ratio"] * tw_odd["grad_rel"]["twin"]:
            raise AssertionError(f"({part}) rank {r} odd step: gradient "
                                 f"{gr} from the f32 gradient, the twin's "
                                 f"{tw_odd['grad_rel']}")
        if odd["launches"] != _gossip_odd_launches(part) or \
                tw_odd["launches"] != odd["launches"]:
            raise AssertionError(f"({part}) rank {r} odd step: launches "
                                 f"{odd['launches']}, the twin's "
                                 f"{tw_odd['launches']}, predicted "
                                 f"{_gossip_odd_launches(part)}")
    if not any("vs_twin" in rec["odd"] for rec in ranks):
        raise AssertionError(f"({part}) odd step: no rank held the twin")
    gib = lambda b: b / 2 ** 30
    extra = {}
    if part == "i":
        extra["frames"] = C("FRAMES")
    emit(f"gossip_{part}", card=smi, arch=C("ARCH"), layers=C("LAYERS"),
         backend="gloo", device=f"{dev} (all ranks)",
         mesh=dict(zip(("node", "data", "model"), C("MESH"))),
         tensor_parallel=True, twin_world=n, batch=C("BATCH"),
         seq=C("SEQ"), steps=C("STEPS"), val=C("VAL"), **extra,
         remat=True, lr=GOSSIP_F_LR,
         spawn_wall_s={"twin": twin_wall, "split": wall},
         gates=ranks[0]["gates"],
         loss={"split": [rec["loss"] for rec in ranks],
               "twin": [rec["loss"] for rec in twin], "rtol": rtol},
         metrics={"split": [rec["metrics"] for rec in ranks],
                  "twin": [rec["metrics"] for rec in twin]},
         vs_twin=dict([(r, rec["vs_twin"]) for r, rec in enumerate(ranks)
                       if "vs_twin" in rec],
                      tolerance={k: {"rtol": v[0], "atol": v[1]}
                                 for k, v in GOSSIP_F_TOL.items()}),
         layer_block_gib={top: {k: gib(v) for k, v in b.items()}
                          for top, b in ranks[0]["blocks"].items()},
         step_bytes={"counted": [rec["step_bytes"][-1] for rec in ranks],
                     "from_layout": [rec["step_from_layout"]
                                     for rec in ranks]},
         gate_bytes={"counted": [rec["gate_bytes"] for rec in ranks],
                     "from_layout": [rec["gate_from_layout"]
                                     for rec in ranks]},
         step_wall_s={"split": [rec["step_walls"] for rec in ranks],
                      "twin": [rec["step_walls"] for rec in twin]},
         sync_wall_s={"split": [rec["sync_wall"] for rec in ranks],
                      "twin": [rec["sync_wall"] for rec in twin]},
         round_wall_s={"split": [rec["wall"] for rec in ranks],
                       "twin": [rec["wall"] for rec in twin]},
         resident_gib={"split": [gib(rec["resident"]) for rec in ranks],
                       "twin": [gib(rec["resident"]) for rec in twin]},
         steps_peak_gib={"split": [gib(rec["steps_peak"]) for rec in ranks],
                         "twin": [gib(rec["steps_peak"]) for rec in twin]},
         sync_peak_gib={"split": [gib(rec["sync_peak"]) for rec in ranks],
                        "twin": [gib(rec["sync_peak"]) for rec in twin]},
         launches=ranks[0]["launches"], predicted=predicted,
         odd_step=dict(
             seq=C("ODD"), frames=C("ODD_FRAMES"),
             loss={"split": [rec["odd"]["loss"] for rec in ranks],
                   "twin": [rec["odd"]["loss"] for rec in twin]},
             lr=GOSSIP_ODD_LR,
             vs_twin={r: rec["odd"]["vs_twin"] for r, rec in
                      enumerate(ranks) if "vs_twin" in rec["odd"]},
             grad_rel={"split": {r: rec["odd"]["grad_rel"] for r, rec in
                                 enumerate(ranks)
                                 if "grad_rel" in rec["odd"]},
                       "twin": [rec["odd"]["grad_rel"] for rec in twin]},
             bytes={"counted": [rec["odd"]["bytes"] for rec in ranks],
                    "from_layout": [rec["odd"]["from_layout"]
                                    for rec in ranks]},
             wall_s={"split": [rec["odd"]["wall"] for rec in ranks],
                     "twin": [rec["odd"]["wall"] for rec in twin]},
             launches=ranks[0]["odd"]["launches"],
             predicted=_gossip_odd_launches(part)),
         note="gloo ranks on one card: the collectives go through host "
              "memory and TCP, not NVLink")
    if part == "h":
        _gossip_j_check(smi, tmp)
    if part == "i":
        _gossip_k_check(smi, tmp)


# (j) serving under tensor parallelism, in (h)'s world of 2 node positions
# × model 2 after its round: position i's model group (node, data, model)
# = (1, 1, 2) serves GOSSIP_J_ARCHS[i] at its published widths and depth
# (GOSSIP_J_LAYERS: None) in bf16, from the seed-0 init, against its
# unsharded twin on model rank 0; first the same at GOSSIP_J_F32_LAYERS
# layers in f32. Traffic: GOSSIP_J_ROWS rows, a prompt of GOSSIP_J_SEQ
# tokens (the residual cut on the sequence) and one of GOSSIP_J_ODD (M
# does not divide it: the residual whole), GOSSIP_J_NEW new tokens each
GOSSIP_J_ARCHS = ("hymba-1.5b", "granite-moe-3b-a800m")
GOSSIP_J_LAYERS = None
GOSSIP_J_ROWS, GOSSIP_J_SEQ, GOSSIP_J_ODD, GOSSIP_J_NEW = 2, 256, 255, 16
GOSSIP_J_MAX_LEN = GOSSIP_J_SEQ + GOSSIP_J_NEW
GOSSIP_J_F32_LAYERS = 2
# the f32 check's logits against the twin's. At bf16 and full depth both
# are held against the twin's weights evaluated in f32 (teacher-forced on
# the twin's stream): the model group's logits at most GOSSIP_J_BF16_RATIO
# times as far from it as the twin's own, so within a bound of (1 + the
# ratio) times the twin's distance of the twin's logits, the streams equal
# wherever the twin's top-2 margin exceeds twice that bound
GOSSIP_J_F32_TOL = 1e-4
GOSSIP_J_BF16_RATIO = 2.0
# decode steps a token's wall is averaged over
GOSSIP_J_TOKEN_RUNS = 4


def _gossip_j_cfg(arch, f32):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if f32:
        return dataclasses.replace(cfg, n_layers=GOSSIP_J_F32_LAYERS,
                                   param_dtype="float32",
                                   compute_dtype="float32")
    if GOSSIP_J_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=GOSSIP_J_LAYERS)
    return cfg


def _gossip_j_serve(cfg, mesh, dev, prompts):
    """One config served by ``generate`` (over ``mesh``'s model group, or
    unsharded with ``mesh`` None: its programs captured) on each prompt,
    then a prefill of the first prompt and GOSSIP_J_TOKEN_RUNS decode
    steps alone: tokens, logits, walls, launches, bytes by kind (of the
    model group), resident memory (the step buffers: params and caches),
    the caches' bytes, the peak above what was held before, the params'
    values and the programs' modes; the peak while it was built (over a
    model group the node whole beside the blocks) apart. The buffers are
    released after."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as lserve
    from repro_torch.models import build_model

    b, t, new = GOSSIP_J_ROWS, GOSSIP_J_MAX_LEN, GOSSIP_J_NEW
    on = () if mesh is None else (mesh,)
    model = build_model(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = lserve.step_buffers(model, b, t, dev, *on)
    gen = torch.Generator(device=dev).manual_seed(0)
    if mesh is None:
        model.init(gen, dev, out=st.params)
    else:     # the node whole, sliced once into the rank's blocks
        node = model.init(gen, dev)
        st.load(node)
        del node
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    rec = dict(resident=torch.cuda.memory_allocated() - held,
               build_peak=torch.cuda.max_memory_allocated() - held,
               cache_bytes=sum(x.numel() * x.element_size()
                               for x in lserve.tree_leaves(st.caches)),
               param_values=st.layout.n_values, runs={})
    torch.cuda.reset_peak_memory_stats()
    counts = mesh.reset_counts if mesh is not None else (lambda: None)
    for seq, prompt in prompts.items():
        reset_launches()
        counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = lserve.generate(model, st.params, prompt, new, t, dev,
                                       *on, with_logits=True)
        torch.cuda.synchronize()
        rec["runs"][seq] = dict(
            tokens=toks.cpu(), logits=logits.float().cpu(),
            wall=time.perf_counter() - t0,
            launches={k: v for k, v in LAUNCHES.items() if v},
            bytes={} if mesh is None else dict(mesh.counts))
    seq = next(iter(prompts))
    pre = lserve.prefill_step_for(model, b, seq, t, dev, *on)
    dec = lserve.serve_step_for(model, b, t, dev, *on)
    for name, prog, runs in (("prefill", pre, 1),
                             ("token", dec, GOSSIP_J_TOKEN_RUNS)):
        counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            prog.run()
        torch.cuda.synchronize()
        rec[f"{name}_wall"] = (time.perf_counter() - t0) / runs
        rec[f"{name}_bytes"] = {} if mesh is None else {
            k: v // runs for k, v in mesh.counts.items()}
    rec.update(peak=torch.cuda.max_memory_allocated() - held,
               eager_pool=st.graphs.eager, captured=dec.captured,
               eager_calls=[pre.eager_calls, dec.eager_calls])
    del st, pre, dec
    _release_serving()
    return rec


def _gossip_rank_j(mesh, dev):
    """(j) On one rank of (h)'s world: its node position's arch, served
    over its model group in f32 at GOSSIP_J_F32_LAYERS layers, then in
    bf16 at full depth, each followed by the unsharded twin on model rank
    0 (the other rank waits). Returns the records, the rank's compute
    block count against the node's and the placement."""
    import dataclasses
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (cache_cut, compute_blocks,
                                            placement)

    dev = torch.device(dev)
    arch = GOSSIP_J_ARCHS[mesh.rows.start]
    mrank = mesh.coords["model"]
    gen = torch.Generator().manual_seed(7)
    vocab = _gossip_j_cfg(arch, False).vocab_size
    prompts = {n: torch.randint(0, vocab, (GOSSIP_J_ROWS, n),
                                generator=gen).to(dev)
               for n in (GOSSIP_J_SEQ, GOSSIP_J_ODD)}
    out = dict(arch=arch, model_rank=mrank)
    for tag, f32 in (("f32", True), ("bf16", False)):
        cfg = _gossip_j_cfg(arch, f32)
        out[tag] = dict(tp=_gossip_j_serve(cfg, mesh, dev, prompts))
        if mrank == 0:
            out[tag]["twin"] = twin = _gossip_j_serve(cfg, None, dev,
                                                      prompts)
            if not f32:
                out[tag]["f32_eval"] = _gossip_j_f32_eval(
                    cfg, dev, prompts,
                    {n: run["tokens"] for n, run in twin["runs"].items()})
        dist.barrier(group=mesh.model_view.group)
    cfg = _gossip_j_cfg(arch, False)
    place = placement(cfg, mesh.inner["model"])
    layout = build_model(cfg).layout
    blocks = compute_blocks(layout, cfg, place, mrank)
    out.update(place=dataclasses.asdict(place),
               cache_cut=cache_cut(cfg, place),
               block_values=sum(math.prod(sum(n for _, n in iv)
                                          for iv in ivs)
                                for ivs in blocks.values()),
               node_values=layout.n_values, n_layers=cfg.n_layers)
    return out


def _gossip_j_launches(cfg):
    """Flash (and SSD) launches of one ``generate`` over a model group:
    one a layer in its prefill, none in the decode steps."""
    out = {"flash_attention": cfg.n_layers}
    if cfg.family == "hybrid":
        out["ssd_scan"] = cfg.n_layers
    return out


def _gossip_j_f32_eval(cfg, dev, prompts, streams):
    """The served bf16 weights (the seed-0 init of ``cfg``) evaluated in
    f32 on each prompt followed by the twin's stream ``streams[seq]`` [B,
    new]: the f32 logits each of the twin's tokens was picked from [B,
    new, V], teacher-forced in one forward."""
    import dataclasses
    import torch
    from repro_torch.models import build_model

    model = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, param_dtype="float32",
                                          compute_dtype="float32"))
    node = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    flat = torch.empty(m32.layout.size, dtype=torch.float32, device=dev)
    views, src = m32.layout.unflatten(flat), model.layout.unflatten(node)
    for path, t in views.items():
        t.copy_(src[path])
    del node, src
    out = {}
    with torch.no_grad():
        for seq, prompt in prompts.items():
            toks = torch.cat([prompt, streams[seq][:, :-1].to(
                device=dev, dtype=torch.long)], dim=1)
            caches = m32.init_cache(toks.shape[0], toks.shape[1], dev)
            logits, _ = m32.decode(views, toks, caches, 0)
            out[seq] = logits[:, seq - 1:].cpu()
            del caches, logits
    del flat, views
    torch.cuda.empty_cache()
    return out


def _gossip_j_stream(tp, twin, f32, ratio):
    """The bf16 check of one prompt's streams [B, new] and logits [B, new,
    V] against the twin's and against ``f32`` (the twin's weights in f32,
    teacher-forced on the twin's stream), along each row while the
    streams agree (the step where they part included: its context was
    the same): the model group's largest distance from ``f32`` at most
    ``ratio`` times the twin's; its logits within the bound (1 + ratio)
    times the twin's distance of the twin's; the tokens equal wherever
    the twin's top-2 margin exceeds twice that bound. Returns a dict of
    the distances, the bound, the smallest margin met and the steps
    compared, held by their margin and parted at a small margin."""
    import torch
    top2 = torch.topk(twin["logits"], 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    dist = lambda a, b: (a - b).abs().amax(-1)           # [B, new]
    d_tp, d_twin = dist(tp["logits"], f32), dist(twin["logits"], f32)
    d_pair = dist(tp["logits"], twin["logits"])
    rows, new = tp["tokens"].shape
    seen = torch.zeros((rows, new), dtype=torch.bool)
    for r in range(rows):
        for i in range(new):
            seen[r, i] = True
            if tp["tokens"][r, i] != twin["tokens"][r, i]:
                break
    tp_f32, twin_f32 = float(d_tp[seen].max()), float(d_twin[seen].max())
    bound = (1 + ratio) * twin_f32
    out = dict(max_abs_logit_diff=float(d_pair[seen].max()), bound=bound,
               tp_from_f32=tp_f32, twin_from_f32=twin_f32,
               smallest_margin=float(margin[seen].min()),
               steps_compared=int(seen.sum()),
               steps_margin_held=int((seen & (margin > 2 * bound)).sum()),
               parted_at_small_margin=int((seen & (
                   tp["tokens"] != twin["tokens"])).sum()),
               streams_equal=bool(torch.equal(tp["tokens"],
                                              twin["tokens"])))
    if tp_f32 > ratio * twin_f32 or out["max_abs_logit_diff"] > bound:
        raise AssertionError(f"(j) logits {out}")
    parted = seen & (tp["tokens"] != twin["tokens"]) & (margin > 2 * bound)
    if bool(parted.any()):
        raise AssertionError(f"(j) the streams part where the twin's "
                             f"margin exceeds twice the bound: {out}")
    return out


def _gossip_j_check(smi, tmp):
    """(j) The model groups' records against their twins', the layout's
    byte counts and the launch counts; emits ``gossip_j``. Raises on any
    failed check."""
    import torch

    recs = [torch.load(f"{tmp}/jserve{r}.pt") for r in range(4)]
    gib = lambda n: n / 2 ** 30
    b, t, new = GOSSIP_J_ROWS, GOSSIP_J_MAX_LEN, GOSSIP_J_NEW
    models = {}
    for pos, arch in enumerate(GOSSIP_J_ARCHS):
        ranks = recs[2 * pos:2 * pos + 2]
        row = dict(arch=arch, place=ranks[0]["place"],
                   cache_cut=ranks[0]["cache_cut"])
        for tag in ("f32", "bf16"):
            cfg = _gossip_j_cfg(arch, tag == "f32")
            twin = ranks[0][tag]["twin"]
            tps = [r[tag]["tp"] for r in ranks]
            want_launch = _gossip_j_launches(cfg)
            checks = {}
            for seq in (GOSSIP_J_SEQ, GOSSIP_J_ODD):
                a, c = tps[0]["runs"][seq], tps[1]["runs"][seq]
                if not (torch.equal(a["tokens"], c["tokens"])
                        and torch.equal(a["logits"], c["logits"])):
                    raise AssertionError(f"(j) {arch} {tag} S={seq}: the "
                                         "two model ranks disagree")
                if not bool(torch.isfinite(a["logits"][..., :cfg.vocab_size])
                            .all()):
                    raise AssertionError(f"(j) {arch} {tag}: logits not "
                                         "finite")
                for r, tp in enumerate(tps):
                    got = tp["runs"][seq]["launches"]
                    if got != want_launch:
                        raise AssertionError(f"(j) {arch} {tag} rank {r}: "
                                             f"launches {got}, the count "
                                             f"{want_launch}")
                    want_bytes = _tp_serve_bytes(cfg, 2, b, seq, t)
                    tok = _tp_serve_bytes(cfg, 2, b, 1, t)
                    total = {k: want_bytes.get(k, 0) + (new - 1) * tok.get(
                        k, 0) for k in set(want_bytes) | set(tok)}
                    if tp["runs"][seq]["bytes"] != total:
                        raise AssertionError(
                            f"(j) {arch} {tag} rank {r} S={seq}: bytes "
                            f"{tp['runs'][seq]['bytes']}, the layout's "
                            f"{total}")
                w = twin["runs"][seq]
                v = cfg.vocab_size
                if tag == "f32":
                    err = float((a["logits"][..., :v] - w["logits"][..., :v])
                                .abs().max())
                    if err > GOSSIP_J_F32_TOL or not torch.equal(
                            a["tokens"], w["tokens"]):
                        raise AssertionError(f"(j) {arch} f32 S={seq}: "
                                             f"logits {err} from the twin's,"
                                             " or the streams differ")
                    checks[seq] = dict(max_abs_logit_diff=err,
                                       streams_equal=True)
                else:
                    checks[seq] = _gossip_j_stream(
                        {"tokens": a["tokens"], "logits": a["logits"][..., :v]},
                        {"tokens": w["tokens"], "logits": w["logits"][..., :v]},
                        ranks[0][tag]["f32_eval"][seq][..., :v],
                        GOSSIP_J_BF16_RATIO)
            for r, tp in enumerate(tps):
                for name, seq in (("prefill", GOSSIP_J_SEQ), ("token", 1)):
                    want_bytes = _tp_serve_bytes(cfg, 2, b, seq, t)
                    if tp[f"{name}_bytes"] != want_bytes:
                        raise AssertionError(
                            f"(j) {arch} {tag} rank {r} {name} bytes "
                            f"{tp[f'{name}_bytes']}, the layout's "
                            f"{want_bytes}")
                if not tp["eager_pool"] or tp["captured"]:
                    raise AssertionError(f"(j) {arch} rank {r}: the model "
                                         "group's programs must run eager")
                if not tp["resident"] < twin["resident"]:
                    raise AssertionError(f"(j) {arch} {tag} rank {r}: "
                                         f"resident {tp['resident']}, the "
                                         f"twin's {twin['resident']}")
            if twin["eager_pool"] or (torch.cuda.is_available()
                                      and not twin["captured"]):
                raise AssertionError(f"(j) {arch}: the twin's programs "
                                     "must be captured")
            row[tag] = dict(
                layers=cfg.n_layers, checks=checks,
                resident_gib={"tp": [gib(x["resident"]) for x in tps],
                              "twin": gib(twin["resident"])},
                peak_above_held_gib={"tp": [gib(x["peak"]) for x in tps],
                                     "twin": gib(twin["peak"])},
                build_peak_gib={"tp": [gib(x["build_peak"]) for x in tps],
                                "twin": gib(twin["build_peak"])},
                cache_gib={"tp": [gib(x["cache_bytes"]) for x in tps],
                           "twin": gib(twin["cache_bytes"])},
                param_values={"tp": [x["param_values"] for x in tps],
                              "twin": twin["param_values"]},
                generate_wall_s={str(seq): {
                    "tp": [x["runs"][seq]["wall"] for x in tps],
                    "twin": twin["runs"][seq]["wall"]}
                    for seq in (GOSSIP_J_SEQ, GOSSIP_J_ODD)},
                prefill_wall_s={"tp": [x["prefill_wall"] for x in tps],
                                "twin": twin["prefill_wall"]},
                token_wall_s={"tp": [x["token_wall"] for x in tps],
                              "twin": twin["token_wall"]},
                bytes={"prefill": tps[0]["prefill_bytes"],
                       "token": tps[0]["token_bytes"],
                       "generate": {str(seq): tps[0]["runs"][seq]["bytes"]
                                    for seq in (GOSSIP_J_SEQ,
                                                GOSSIP_J_ODD)},
                       "layout_equal": True},
                launches={"tp": tps[0]["runs"][GOSSIP_J_SEQ]["launches"],
                          "twin": twin["runs"][GOSSIP_J_SEQ]["launches"],
                          "count": want_launch},
                eager_calls=tps[0]["eager_calls"])
        for r, rec in enumerate(ranks):
            if rec["bf16"]["tp"]["param_values"] != rec["block_values"] or \
                    not rec["block_values"] < rec["node_values"]:
                raise AssertionError(f"(j) {arch} rank {r}: "
                                     f"{rec['bf16']['tp']['param_values']} "
                                     f"values held, its blocks "
                                     f"{rec['block_values']}, the node's "
                                     f"{rec['node_values']}")
        row.update(block_values=[rec["block_values"] for rec in ranks],
                   node_values=ranks[0]["node_values"])
        models[arch] = row
    emit("gossip_j", card=smi, backend="gloo", mesh={"node": 1, "data": 1,
                                                     "model": 2},
         world="(h)'s 4 ranks: node position i's model group serves "
               "GOSSIP_J_ARCHS[i]", rows=GOSSIP_J_ROWS,
         prompts=[GOSSIP_J_SEQ, GOSSIP_J_ODD], new=GOSSIP_J_NEW,
         max_len=GOSSIP_J_MAX_LEN, f32_tol=GOSSIP_J_F32_TOL,
         bf16_ratio=GOSSIP_J_BF16_RATIO, models=models,
         note="gloo ranks on one card: the collectives go through host "
              "memory and TCP, not NVLink; the model group's programs run "
              "eager, the twin's are captured")


# (k) the enc-dec family served over a model group, in (i)'s world of 2
# node positions × model 2 after its round: each position's model group
# (node, data, model) = (1, 1, 2) serves GOSSIP_K_ARCH at its published
# widths and depth in bf16 (from the seed-(10 + position) init) against
# its unsharded twin on model rank 0; first the same at GOSSIP_K_F32_LAYERS
# encoder and decoder layers in f32. Traffic: GOSSIP_K_ROWS rows of the
# config's 1,024 frames encoded over the group (the residual cut, the
# output gathered once), then a prompt of GOSSIP_K_PROMPT tokens fed one
# at a time and GOSSIP_K_NEW new tokens (every decode step in the whole
# form; the self cache cut on the KV heads, the encoder output whole)
GOSSIP_K_ARCH = "seamless-m4t-medium"
GOSSIP_K_ROWS, GOSSIP_K_PROMPT, GOSSIP_K_NEW = 2, 8, 8
GOSSIP_K_MAX_LEN = GOSSIP_K_PROMPT + GOSSIP_K_NEW
GOSSIP_K_F32_LAYERS = 2


def _gossip_k_cfg(f32):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(GOSSIP_K_ARCH)
    if f32:
        return dataclasses.replace(
            cfg, n_layers=GOSSIP_K_F32_LAYERS,
            n_enc_layers=GOSSIP_K_F32_LAYERS, param_dtype="float32",
            compute_dtype="float32")
    return cfg


def _gossip_k_serve(cfg, mesh, dev, seed, frames, prompt):
    """The enc-dec ``cfg`` served over ``mesh``'s model group (or
    unsharded with ``mesh`` None: its programs captured): ``frames``
    encoded into the caches' ``enc_out`` by the encode step, then
    ``prompt`` fed token by token through the decode step and GOSSIP_K_NEW
    tokens generated. Returns the tokens, each new token's logits, the
    encode's and the decode steps' walls, launches and bytes by kind (of
    the model group), resident memory (params and caches), the caches'
    bytes, the peak above what was held before, the params' values and
    the programs' modes; the peak while it was built apart. The buffers
    are released after."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as lserve
    from repro_torch.models import build_model

    b, t, new = GOSSIP_K_ROWS, GOSSIP_K_MAX_LEN, GOSSIP_K_NEW
    on = () if mesh is None else (mesh,)
    counts = mesh.reset_counts if mesh is not None else (lambda: None)
    model = build_model(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = lserve.step_buffers(model, b, t, dev, *on)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mesh is None:
        model.init(gen, dev, out=st.params)
    else:     # the node whole, sliced once into the rank's blocks
        node = model.init(gen, dev)
        st.load(node)
        del node
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    rec = dict(resident=torch.cuda.memory_allocated() - held,
               build_peak=torch.cuda.max_memory_allocated() - held,
               cache_bytes=sum(x.numel() * x.element_size()
                               for x in lserve.tree_leaves(st.caches)),
               param_values=st.layout.n_values)
    torch.cuda.reset_peak_memory_stats()
    enc = lserve.encode_step_for(model, b, t, dev, *on)
    dec = lserve.serve_step_for(model, b, t, dev, *on)
    for x in lserve.tree_leaves(st.caches):
        x.zero_()
    st.frames.copy_(frames)
    reset_launches()
    counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc.run()
    torch.cuda.synchronize()
    rec.update(encode_wall=time.perf_counter() - t0,
               encode_launches={k: v for k, v in LAUNCHES.items() if v},
               encode_bytes={} if mesh is None else dict(mesh.counts))
    reset_launches()
    counts()
    out, seen = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(prompt.shape[1]):
        st.tok.copy_(prompt[:, i:i + 1])
        st.pos.fill_(i)
        dec.run()
    out.append(st.tok.clone())
    seen.append(st.logits.clone())
    for _ in range(new - 1):
        dec.run()
        out.append(st.tok.clone())
        seen.append(st.logits.clone())
    torch.cuda.synchronize()
    steps = prompt.shape[1] + new - 1
    rec.update(tokens=torch.cat(out, 1).cpu(),
               logits=torch.stack(seen, 1).float().cpu(),
               token_wall=(time.perf_counter() - t0) / steps, steps=steps,
               token_launches={k: v for k, v in LAUNCHES.items() if v},
               token_bytes={} if mesh is None else dict(mesh.counts),
               peak=torch.cuda.max_memory_allocated() - held,
               eager_pool=st.graphs.eager, captured=dec.captured,
               encode_captured=enc.captured,
               eager_calls=[enc.eager_calls, dec.eager_calls])
    del st, enc, dec
    _release_serving()
    return rec


def _gossip_k_f32_eval(cfg, dev, seed, frames, prompt, stream):
    """The served bf16 weights (the seed ``seed`` init of ``cfg``)
    evaluated in f32: ``frames`` encoded, then ``prompt`` followed by the
    twin's stream [B, new] teacher-forced in one decoder forward; the f32
    logits each of the twin's tokens was picked from [B, new, V]."""
    import dataclasses
    import torch
    from repro_torch.models import build_model

    model = build_model(cfg)
    m32 = build_model(dataclasses.replace(cfg, param_dtype="float32",
                                          compute_dtype="float32"))
    node = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    flat = torch.empty(m32.layout.size, dtype=torch.float32, device=dev)
    views, src = m32.layout.unflatten(flat), model.layout.unflatten(node)
    for path, t in views.items():
        t.copy_(src[path])
    del node, src
    with torch.no_grad():
        toks = torch.cat([prompt, stream[:, :-1].to(device=dev,
                                                    dtype=torch.long)], 1)
        caches = m32.init_cache(toks.shape[0], toks.shape[1], dev)
        caches["enc_out"].copy_(m32.encode(views, frames))
        logits, _ = m32.decode(views, toks, caches, 0)
        out = logits[:, prompt.shape[1] - 1:].cpu()
    del flat, views, caches, logits
    torch.cuda.empty_cache()
    return out


def _gossip_rank_k(mesh, dev):
    """(k) On one rank of (i)'s world: the enc-dec served over its node
    position's model group in f32 at GOSSIP_K_F32_LAYERS layers, then in
    bf16 at full depth, each followed by the unsharded twin on model rank
    0 (the other rank waits). Returns the records, the rank's compute
    block count against the node's and the placement."""
    import dataclasses
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.sharding.rules import (cache_cut, compute_blocks,
                                            placement)

    dev = torch.device(dev)
    pos = mesh.rows.start
    seed = 10 + pos
    mrank = mesh.coords["model"]
    cfg = _gossip_k_cfg(False)
    gen = torch.Generator(device=dev).manual_seed(20 + pos)
    frames = torch.randn((GOSSIP_K_ROWS, cfg.enc_seq_len, cfg.frontend_dim),
                         generator=gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (GOSSIP_K_ROWS,
                                               GOSSIP_K_PROMPT),
                           generator=gen, device=dev)
    out = dict(model_rank=mrank, position=pos)
    for tag, f32 in (("f32", True), ("bf16", False)):
        c = _gossip_k_cfg(f32)
        out[tag] = dict(tp=_gossip_k_serve(c, mesh, dev, seed, frames,
                                           prompt))
        if mrank == 0:
            out[tag]["twin"] = twin = _gossip_k_serve(c, None, dev, seed,
                                                      frames, prompt)
            if not f32:
                out[tag]["f32_eval"] = _gossip_k_f32_eval(
                    c, dev, seed, frames, prompt, twin["tokens"])
        dist.barrier(group=mesh.model_view.group)
    place = placement(cfg, mesh.inner["model"])
    layout = build_model(cfg).layout
    blocks = compute_blocks(layout, cfg, place, mrank)
    out.update(place=dataclasses.asdict(place),
               cache_cut=cache_cut(cfg, place),
               block_values=sum(math.prod(sum(n for _, n in iv)
                                          for iv in ivs)
                                for ivs in blocks.values()),
               node_values=layout.n_values)
    return out


def _gossip_k_check(smi, tmp):
    """(k) Each model group's records against its twin's, the layout's
    byte counts and the launch counts; emits ``gossip_k``. Raises on any
    failed check."""
    import torch

    recs = [torch.load(f"{tmp}/kserve{r}.pt") for r in range(4)]
    gib = lambda n: n / 2 ** 30
    b, t = GOSSIP_K_ROWS, GOSSIP_K_MAX_LEN
    groups = {}
    for pos in range(2):
        ranks = recs[2 * pos:2 * pos + 2]
        row = dict(place=ranks[0]["place"], cache_cut=ranks[0]["cache_cut"])
        for tag in ("f32", "bf16"):
            cfg = _gossip_k_cfg(tag == "f32")
            v = cfg.vocab_size
            twin = ranks[0][tag]["twin"]
            tps = [r[tag]["tp"] for r in ranks]
            a, c = tps
            if not (torch.equal(a["tokens"], c["tokens"])
                    and torch.equal(a["logits"], c["logits"])):
                raise AssertionError(f"(k) {tag} position {pos}: the two "
                                     "model ranks disagree")
            if not bool(torch.isfinite(a["logits"][..., :v]).all()):
                raise AssertionError(f"(k) {tag}: logits not finite")
            enc_bytes = _tp_serve_bytes(cfg, 2, b, cfg.enc_seq_len, t,
                                        encode=True)
            tok = _tp_serve_bytes(cfg, 2, b, 1, t)
            want_launch = {"flash_attention": cfg.n_enc_layers}
            for r, tp in enumerate(tps + [twin]):
                if tp["encode_launches"] != want_launch or \
                        tp["token_launches"]:
                    raise AssertionError(
                        f"(k) {tag} rank {r}: launches an encode "
                        f"{tp['encode_launches']}, the decode steps "
                        f"{tp['token_launches']}; the count {want_launch}, "
                        "none")
            for r, tp in enumerate(tps):
                steps = tp["steps"]
                if tp["encode_bytes"] != enc_bytes or tp["token_bytes"] != {
                        k: steps * n for k, n in tok.items()}:
                    raise AssertionError(
                        f"(k) {tag} rank {r}: bytes an encode "
                        f"{tp['encode_bytes']} ({enc_bytes} counted), "
                        f"{steps} steps {tp['token_bytes']} ({tok} a step "
                        "counted)")
                if not tp["eager_pool"] or tp["captured"]:
                    raise AssertionError(f"(k) rank {r}: the model group's "
                                         "programs must run eager")
                if not tp["resident"] < twin["resident"]:
                    raise AssertionError(f"(k) {tag} rank {r}: resident "
                                         f"{tp['resident']}, the twin's "
                                         f"{twin['resident']}")
            if twin["eager_pool"] or (torch.cuda.is_available() and not (
                    twin["captured"] and twin["encode_captured"])):
                raise AssertionError("(k): the twin's programs must be "
                                     "captured")
            if tag == "f32":
                err = float((a["logits"][..., :v] - twin["logits"][..., :v])
                            .abs().max())
                if err > GOSSIP_J_F32_TOL or not torch.equal(
                        a["tokens"], twin["tokens"]):
                    raise AssertionError(f"(k) f32 position {pos}: logits "
                                         f"{err} from the twin's, or the "
                                         "streams differ")
                check = dict(max_abs_logit_diff=err, streams_equal=True)
            else:
                check = _gossip_j_stream(
                    {"tokens": a["tokens"], "logits": a["logits"][..., :v]},
                    {"tokens": twin["tokens"],
                     "logits": twin["logits"][..., :v]},
                    ranks[0][tag]["f32_eval"][..., :v], GOSSIP_J_BF16_RATIO)
            row[tag] = dict(
                layers=[cfg.n_enc_layers, cfg.n_layers], check=check,
                resident_gib={"tp": [gib(x["resident"]) for x in tps],
                              "twin": gib(twin["resident"])},
                peak_above_held_gib={"tp": [gib(x["peak"]) for x in tps],
                                     "twin": gib(twin["peak"])},
                build_peak_gib={"tp": [gib(x["build_peak"]) for x in tps],
                                "twin": gib(twin["build_peak"])},
                cache_gib={"tp": [gib(x["cache_bytes"]) for x in tps],
                           "twin": gib(twin["cache_bytes"])},
                param_values={"tp": [x["param_values"] for x in tps],
                              "twin": twin["param_values"]},
                encode_wall_s={"tp": [x["encode_wall"] for x in tps],
                               "twin": twin["encode_wall"]},
                token_wall_s={"tp": [x["token_wall"] for x in tps],
                              "twin": twin["token_wall"]},
                bytes={"encode": tps[0]["encode_bytes"],
                       "token": {k: n // tps[0]["steps"] for k, n in
                                 tps[0]["token_bytes"].items()},
                       "layout_equal": True},
                launches={"encode": tps[0]["encode_launches"],
                          "count": want_launch},
                eager_calls=tps[0]["eager_calls"])
        for r, rec in enumerate(ranks):
            if rec["bf16"]["tp"]["param_values"] != rec["block_values"] or \
                    not rec["block_values"] < rec["node_values"]:
                raise AssertionError(f"(k) rank {r}: "
                                     f"{rec['bf16']['tp']['param_values']} "
                                     f"values held, its blocks "
                                     f"{rec['block_values']}, the node's "
                                     f"{rec['node_values']}")
        row.update(block_values=[rec["block_values"] for rec in ranks],
                   node_values=ranks[0]["node_values"])
        groups[pos] = row
    emit("gossip_k", card=smi, backend="gloo", arch=GOSSIP_K_ARCH,
         mesh={"node": 1, "data": 1, "model": 2},
         world="(i)'s 4 ranks: each node position's model group serves "
               "the enc-dec", rows=GOSSIP_K_ROWS,
         frames=_gossip_k_cfg(False).enc_seq_len, prompt=GOSSIP_K_PROMPT,
         new=GOSSIP_K_NEW, max_len=GOSSIP_K_MAX_LEN,
         f32_tol=GOSSIP_J_F32_TOL, bf16_ratio=GOSSIP_J_BF16_RATIO,
         groups=groups,
         note="gloo ranks on one card: the collectives go through host "
              "memory and TCP, not NVLink; the model group's programs run "
              "eager, the twin's are captured")


def phase_gossip(dev, smi):
    """The gossip backend (`repro_torch.core.gossip`, ``SwarmSession(...,
    backend="gossip")``): (a) and (b) on a world of one NCCL rank in this
    process, then (c) on 4 gloo ranks spawned on the one card together
    with (d) on 4 more as a two-level mesh, (e) inner sharding on 4
    together with an unsharded twin on 2 and (f)'s, (h)'s and (i)'s twins
    on 2 each, then (f) the split step on 4, (h) Hymba-1.5B
    tensor-parallel on 4 and, in the same world, (j) Hymba-1.5B and
    granite-moe-3b served over a model group each, (i)
    seamless-m4t-medium (the enc-dec family) tensor-parallel on 4, and
    last (g) granite-moe-3b split and tensor-parallel on 8."""
    import gc
    import tempfile
    import torch
    import torch.distributed as dist

    base = _gossip_base(dev)
    tmp = tempfile.mkdtemp(prefix="gossip_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rdv",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        _gossip_world1(dev, smi, base)
        gc.collect()
        torch.cuda.empty_cache()
        _gossip_mamba(dev, smi)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="gossip_world4_")
    torch.save(dict(params=base["params"].cpu(), stats=base["stats"].cpu(),
                    sizes=base["sizes"],
                    val=tuple(v.cpu() for v in base["val"]),
                    xs=base["xs"][1].cpu(), ys=base["ys"][1].cpu()),
               f"{tmp}/state.pt")
    # (c) and (d) spawned together, 8 ranks sharing the card
    t0 = time.perf_counter()
    world4, hier = _gossip_spawn_all(tmp, dev, (_gossip_rank, "rank", 4),
                                     (_gossip_rank_d, "hier", 4))
    _gossip_world4(dev, smi, base, world4)
    _gossip_two_level(dev, smi, base, hier)
    TIMERS["gossip_cd_s"] = time.perf_counter() - t0
    del base
    gc.collect()
    torch.cuda.empty_cache()
    # (e)'s twin and sharded world and (f)'s twin spawned together, 8
    # ranks sharing the card; then (f)'s split world, which reads its
    # twin's params
    t0 = time.perf_counter()
    with _expandable_segments():
        etwin, eshard, ftwin, htwin, itwin = _gossip_spawn_all(
            tmp, dev, (_gossip_rank_e, "etwin", GOSSIP_E_NODES),
            (_gossip_rank_e, "eshard", GOSSIP_E_NODES * GOSSIP_E_MODEL),
            (_gossip_rank_f, "ftwin", GOSSIP_E_NODES),
            (_gossip_rank_h, "htwin", GOSSIP_H_MESH[0]),
            (_gossip_rank_i, "itwin", GOSSIP_I_MESH[0]))
    _gossip_inner(dev, smi, tmp, etwin, eshard)
    TIMERS["gossip_e_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _gossip_split(dev, smi, tmp, ftwin)
    TIMERS["gossip_f_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _gossip_tp("h", dev, smi, tmp, htwin)
    TIMERS["gossip_h_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _gossip_tp("i", dev, smi, tmp, itwin)
    TIMERS["gossip_i_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _gossip_moe(dev, smi, tmp)
    TIMERS["gossip_g_s"] = time.perf_counter() - t0


def main() -> int:
    start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bw, peak, bf16_peak = card_rates(kind)
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         memory_rate=bw, f32_peak=peak, bf16_peak=bf16_peak)

    t0 = time.perf_counter()
    build.build(list(SOURCES))
    variants = {}
    for stem in SOURCES:
        ptxas = build.BUILD_LOG.get(stem, {}).get("ptxas", "")
        variants[stem] = dict(
            registers=[int(ln.split("Used ")[1].split()[0])
                       for ln in ptxas.splitlines() if "registers" in ln],
            spilling=[ln.strip() for ln in ptxas.splitlines()
                      if "spill" in ln and "0 bytes spill stores, 0 bytes "
                      "spill loads" not in ln])
    emit("build", seconds=time.perf_counter() - t0,
         build_seconds={k: v["seconds"] for k, v in build.BUILD_LOG.items()},
         variants=variants, mma_instructions=mma_counts(build, SOURCES))

    def timed(name, fn, *args):
        # each phase's seconds into the timing line, and as it ends onto
        # stderr (a run cut by its time limit still shows them)
        t0 = time.perf_counter()
        out = fn(*args)
        TIMERS[f"{name}_s"] = time.perf_counter() - t0
        print(f"chip_smoke: {name} {TIMERS[f'{name}_s']:.1f} s "
              f"(at {time.perf_counter() - start:.1f} s)", file=sys.stderr,
              flush=True)
        return out

    stats = timed("kernel", phase_kernels, dev, bw, peak)
    stats.update(timed("quant_kernel", phase_quant_kernels, dev, bw, peak))
    stats.update(timed("lora_kernel", phase_lora_kernel, dev, bw, peak))
    # the LM slice's kernels and the one-node commit's path are timed before
    # the swarm paths: once a process has run those, most of the profiler's
    # traces lose kernel records (device_ms)
    stats.update(timed("flash_kernel", phase_flash_kernel, dev, bw, peak,
                       bf16_peak))
    stats.update(timed("ssd_kernel", phase_ssd_kernel, dev, bw, peak,
                       bf16_peak))
    mstats, counts = timed("merge_one", phase_merge_one, dev, bw, peak)
    stats.update(mstats)
    # each path runs with the launch counts set to 0 just before it; a
    # kernel's launches are those of the first path that carries it
    launches = {k: v for k, v in counts.items() if v}
    # the dry run's three ranks on the card, while its memory is free
    dry = timed("dryrun", phase_dryrun, dev, smi)
    for name in ("flash_attention", "ssd_scan"):
        stats[name]["launches_dryrun"] = dry["launches"].get(name, 0)

    def path(name, fn, *args):
        counts = timed(name, fn, *args)
        launches.update({k: v for k, v in counts.items()
                         if v and k not in launches})

    path("histo", phase_histo, dev)
    path("fisher", lambda: phase_fisher(dev)[0])
    path("histo_int8", phase_histo, dev, dict(wire_dtype="int8",
                                              wire_block=WIRE_BLOCK))
    counts, run = timed("fisher_int8", phase_fisher, dev,
                        dict(wire_dtype="int8", wire_block=WIRE_BLOCK))
    launches.update({k: v for k, v in counts.items()
                     if v and k not in launches})
    timed("checkpoint", phase_checkpoint, dev, run)
    timed("parity", phase_parity, dev)
    path("faults", phase_faults, dev, smi)
    path("hetero", phase_hetero, dev)
    timed("hetero_parity", phase_hetero_parity, dev)
    # the LM slice: parity, serving
    timed("lm_parity", phase_lm_parity, dev)
    path("serve", phase_serve, dev, smi)
    # the trainer: gradient checks, card vs CPU, then the full-width paths
    timed("train_grads", phase_train_grads, dev)
    timed("train_parity", phase_train_parity, dev)
    path("train", phase_train, dev, smi)
    # the moe, vlm and enc-dec families: card vs CPU, then full width
    timed("families_parity", phase_families_parity, dev)
    timed("families_serve", phase_families_serve, dev, smi)
    # nemotron-4-15b, deepseek-coder-33b and minicpm-2b at full width
    stats["flash_attention"]["launches_d128"] = timed(
        "wide_serve", phase_wide_serve, dev, smi)
    # activation checkpointing, then the host loop
    timed("remat", phase_remat, dev, smi)
    timed("host", phase_host, dev, smi)
    # the twins of the reference's examples at their default sizes
    counts, stats["flash_attention"]["launches_d16"] = timed(
        "examples", phase_examples, dev, smi)
    launches.update({k: v for k, v in counts.items()
                     if v and k not in launches})
    # the gossip backend: one NCCL rank, then 4 gloo ranks on the card
    timed("gossip", phase_gossip, dev, smi)

    kernels = [dict(name=name, route="cuda", source=SOURCES[stem],
                    replaces=replaces, launches=launches.get(name, 0),
                    **stats[name])
               for name, (stem, replaces) in KERNELS.items()]
    if any(k["launches"] < 1 for k in kernels) or \
            not stats["flash_attention"]["launches_d128"] > 0 or \
            not stats["flash_attention"]["launches_d16"] > 0 or \
            not stats["flash_attention"]["launches_dryrun"] > 0 or \
            not stats["ssd_scan"]["launches_dryrun"] > 0:
        raise AssertionError(f"a kernel of the path never launched: {kernels}")
    TIMERS["script_s"] = time.perf_counter() - start
    emit("timing", **TIMERS)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
