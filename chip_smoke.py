#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_lightning_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``), and the build of
   every kernel from ``ray_lightning_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together);
2. kernels: each kernel against its plain PyTorch version on the card
   at the serve and training paths' shapes (max abs error within 2e-2;
   flash_bwd's dq, dk, dv in relative L2 within 1e-3), timed with CUDA events beside its plain version, a
   PyTorch library call computing the same function (a yardstick the
   port never calls) and its bound (bytes at 3.35 TB/s or flops at
   989 TFLOP/s, whichever is larger, from this run's inputs): flash_fwd
   at the serve shapes (B=1) and the training shape (B=8, T=1024),
   flash_bwd at B=8, T=128, 200 (ragged) and 1024, flash_decode at 16
   slots, flash_decode_paged at the same shape with page sizes 16 and 64
   under the identity table and a permuted one (each also equal, bit for
   bit, to flash_decode on the same logical cache; timed beside SDPA on
   the slot-contiguous cache); both decode kernels equal bit for bit
   over two calls;
3. serve: gpt2-small at full width (12 layers, 12 heads, n_embd 768,
   vocab 50304, context 1024), bf16, seeded weights, buckets
   (128, 256, 512, 1024), 16 slots; 16 requests from two tenants over
   all four buckets, 32 new tokens each, through ``Scheduler`` ->
   ``ServeWorker.serve_step`` -> ``ServeEngine``, whose programs are
   CUDA graphs captured at setup (one prefill per bucket and the
   decode; none captured again while serving).  Every request must
   complete; the greedy tokens of four of them (one per bucket) must
   pass the teacher-forced parity rule against the whole-sequence
   forward with the plain attention (a bf16 near-tie within 2e-2 is
   allowed); each kernel must have launched exactly once per layer per
   prefill (flash_fwd) or decode step (flash_decode), counted from 0
   just before the serve loop;
4. train: ``Trainer(max_steps=N).fit(GPTLightningModule("gpt2-small",
   batch_size=8))`` at full width, T=1024, bf16-resident params with the
   fp32 master, N=20 steps (warmup 2): every loss finite and the last
   below the first; flash_fwd and flash_bwd each launched exactly 12 x N
   times in the fit, counted from 0 at its start; one step's gradients
   against the same model with plain attention (``attention_impl="dot"``,
   plain autograd) on the same weights and batch, per-tensor relative L2
   error within 2e-2; the first 3 losses of a 3-step fit of that model
   within 2e-2 of the flash run's; step ms (median after the first two,
   host wall, synced), tokens/s, peak memory and MFU (model flops over
   989 TFLOP/s);
5. profile: where a decode step, a bucket-1024 prefill and a train step
   spend their time (host wall, device kernel time by name, device busy
   share): the serve programs' eager steps (``engine.run_eager``, the
   graphs' sources) for the categories, and their graphs' replays
   beside them;
6. paged serve, with the earlier engine and trainer freed: gpt2-small at
   full width, 16 slots, the same buckets, ``ServeEngine(paged=
   PageConfig(page_size=16))`` under ``RLT_DECODE_IMPL=paged``; 24
   requests from two tenants, each tenant's prompts its 256-token system
   prefix (16 pages) and a distinct 16-64-token tail, arriving in waves
   of 4 every 6 steps, 32 new tokens each.  Every request completes and
   passes the teacher-forced parity rule against a cold whole-sequence
   forward with plain attention; at least half of the admissions reuse
   a prefix (page copy + suffix steps), so fewer prefill tokens are
   computed than requested; flash_decode_paged launches 12 times per
   decode step and per suffix step, flash_fwd 12 per cold prefill,
   flash_decode never; TTFT p50, decode-step, suffix-step and kv-copy
   ms, tokens/s, one paged decode step profiled; the programs replay
   graphs (the suffix step one a slot) and none is captured again;
7. speculative serve: the same engine with ``SpecConfig(k=4)`` and the
   default draft (the first 6 of 12 layers, its parameters the target's
   tensors) over 16 such requests: every request completes with greedy
   parity, ``emitted == accepted + corrected``, flash_decode_paged
   launches 12 x (k+1) per verify and 6 x (k+1) per draft round (k
   drafts and the last draft's row), flash_fwd 12 per prefill and 6 per
   draft prefill; acceptance, tokens per target forward, round ms, one
   round profiled; then a full-clone draft (12 layers) over the same 16
   requests, 1 + 6 (k+1) tokens each, must reach acceptance 0.9;
8. long context, with the serve engines and the gpt2-small trainer freed:
   (a) flash_fwd and flash_bwd at the long-context path's shapes
   against their plain versions over all heads (run in head groups so
   their [B, g, T, T] scores fit), timed beside them, SDPA and their
   bounds, the backward's delta, dk/dv and dq passes each timed alone
   with CUDA events (their own entry points, counted apart):
   B=8 T=2048 H=32 (gpt2-1p3b), B=2 T=4096, B=1 T=8192 and B=1 T=16384
   at H=12; (b) ``Trainer(max_steps=6).fit(GPTLightningModule(
   "gpt2-1p3b", batch_size=8))`` at full width and depth (24 layers, 32
   heads, n_embd 2048), T=2048, remat "full", chunked CE 16: finite
   losses, the first batch's loss lower after the fit, flash_fwd 2 x 24
   and flash_bwd 24 launches a step, step ms, tokens/s, MFU, peak
   memory, one more step profiled; (c) a 2-layer cut of it at B=1,
   T=2048: gradients with flash against ``attention_impl="dot"`` (both
   under remat; per-tensor relative L2 within 2e-2) and remat "full"
   against "off" (within 1e-6); (d) 3-step fits at gpt2-small width with
   ``block_size`` T = 4096, 8192, 16384, B = max(1, 8192 // T), remat
   "full", chunked CE 16 at T >= 8192 (benchmarks/bench_longcontext.py's
   shapes): finite losses, 2 x 12 flash_fwd and 12 flash_bwd launches a
   step, step ms and peak memory; the T=16384 step profiled;
9. BERT and the folded routes, everything earlier freed: (a) flash_fwd
   and flash_bwd at the shapes where the JAX package folds its heads to
   [B*H, T, D] (``tpu_rows`` asserted for each): GPT-2 XL's 25 heads of
   64 at B=8 T=1024 (rows 5 + 10, causal) and B=4 T=2048 (rows 4 + 11 +
   12), bert-base B=32 T=512 H=12 non-causal under
   ``RLT_FLASH_BLOCK_Q=K=128`` (rows 5 + 15 + 16; by default rows 1 + 6,
   the same kernels), and the tiny fits' D=32 shapes; each against the
   plain versions, timed as in phase 8; (b) ``Trainer(max_steps=20).fit(
   BertMLMModule("bert-base", batch_size=32))`` at full width (12
   layers, 12 heads, n_embd 768, vocab 30592, T=512), fp32 params, bf16
   compute: finite losses, the last below the first, flash_fwd and
   flash_bwd 12 x 20 launches (rows 1 + 6, non-causal), step ms,
   tokens/s, MFU (6 x (12 L C^2 + V C) x B T + 12 B L T^2 C over 989
   TFLOP/s), peak memory, one step profiled; one step's gradients
   against ``attention_impl="dot"`` on the same weights, tokens and mask
   (per-tensor relative L2 within 2e-2); its launches count again for
   rows 5 + 15 + 16, the route the block override gives the JAX package
   (the port reads no block size: the override runs the same launches);
   a 10-step ``BertLightningModule("bert-base", batch_size=32)``
   fine-tune (accuracy logged); (c) 8-step fits at GPT-2 XL's width cut
   to 4 layers, block_size 1024 at B=8 (rows 5 + 10 causal) and 2048 at
   B=4 (rows 4 + 11 + 12), 4 + 4 launches a step, step ms, tokens/s,
   MFU; 5-step fits of the tiny BERT (rows 5 + 10 non-causal, D=32) and
   of the tiny GPT at block_size 1024 (rows 5 + 10) and 2048 (rows 4 +
   11 + 12), B=8, 2 + 2 launches a step; (d) at GPT-2 XL's width cut to
   2 layers, B=2, T=1024 (rows 5 + 10) and T=2048 (rows 4 + 11 + 12):
   one step's gradients against ``attention_impl="dot"`` on the same
   weights and tokens, per-tensor relative L2 within 2e-2, one launch of
   each kernel a layer;
10. the trainer, everything earlier freed: ``GPTLightningModule(
   "gpt2-small", batch_size=8)`` at full width (bf16 params, the fp32
   master), 4 train and 2 validation batches an epoch, a validation
   every 2 steps, ``gradient_clip_val=1.0``, ``precision="bf16"``, the
   default ``ModelCheckpoint``, an ``EarlyStopping`` on ``val_loss``
   that must not trigger and the CSV logger, all under a temporary
   ``default_root_dir``: (a) two uninterrupted 2-epoch fits equal bit
   for bit (params, master, mu, nu, count, counters; a failure names
   the tensors that differ); (b) a 1-epoch fit (``best_model_path``
   exists, ``metrics.csv`` a row per logged step), ``save_checkpoint``
   (its bytes against the state's tensor bytes, its seconds), and a new
   ``Trainer(max_epochs=2, ckpt_path=...)`` equal to (a) bit for bit,
   its restore timed; (c) ``trainer.predict`` over 2 batches: flash_fwd
   12 launches a batch, flash_bwd none, every argmax token within the
   bf16 near-tie rule (atol = rtol = 2e-2) of plain attention's logits
   on the same weights;
   (d) three 4-step fits at dropout 0.1 from one init: the same trainer
   seed equal bit for bit, another seed not.  Each fit's launches are
   checked (12 x steps for both kernels, plus 12 a validation batch for
   flash_fwd) and added to rows 1 and 6;
11. plugins, everything earlier freed, each run under a temporary
   ``default_root_dir`` with the default ``ModelCheckpoint`` and a
   validation batch at the end: (a) ``Trainer(plugins=[RayPlugin(
   num_workers=1)], max_steps=8).fit(GPTLightningModule("gpt2-small",
   batch_size=8))`` (T=1024, DDP: the worker's gradients summed over its
   one rank by NCCL) equal bit for bit to the in-process fit from the
   same seed (every weight on the driver, ``global_step``,
   ``callback_metrics``; ``best_model_path`` exists); (b) ``RayShardedPlugin(
   num_workers=1)`` (ZeRO-1) fine-tuning ``BertLightningModule(
   "bert-base", batch_size=32)`` (T=512) for 10 steps, equal bit for bit
   to the in-process fit, its checkpoint equal to the in-process one
   tensor for tensor, and resumed from it in process for 2 more steps;
   (c) each fit's launches counted where it ran (a module-level
   callback, ``PluginProbe``, sends the worker's counts through
   ``session.put_queue``): 12 a step for both kernels, 12 a validation
   batch more for flash_fwd; the workers' counts are added to rows 1 and
   6; (d) the fit call to the end of the first step, the median step in
   the worker and in process, the result round trip's bytes and
   seconds, and the phase's seconds, beside the card's name and power
   limit;
12. tune, everything earlier freed, under a temporary ``local_dir``,
   each trial's ``Trainer`` under its trial's directory: (a) BASELINE
   config #3, ``tune.run`` of 4 ``LightningMNISTClassifier`` trials
   (``tune_mnist``'s space: ``layer_1`` in {32, 64, 128}, ``layer_2``
   in {64, 128, 256}, ``lr`` loguniform(1e-4, 1e-1), ``batch_size`` in
   {32, 64, 128}; MNIST's split sizes, 60000 and 10000, from
   ``synthetic_mnist``) under ``PopulationBasedTraining(metric="loss",
   perturbation_interval=1, hyperparam_mutations={"lr", "batch_size"})``
   with ``stop={"training_iteration": 6}``, each fit a
   ``RayPlugin(num_workers=1)`` worker on the card relaying a checkpoint
   and a report each epoch: every trial ``TERMINATED``, at least one
   exploit, each trial's fits starting at step 0 and then at each of its
   donor checkpoints' ``global_step``, every worker on a ``cuda``
   device, the best ``mean_accuracy`` above 0.5 (chance 0.1); the
   sweep's wall, each fit's start-up, the reports and relays by count;
   (b) ``tune.run`` over ``grid_search`` of two lrs, each trial
   gpt2-small at full width (B=8, T=1024) under
   ``RayPlugin(num_workers=1)``, 6 steps with a validation (a report and
   a ~1.49 GB checkpoint relay) at steps 3 and 6: each trial 2 reports,
   its last relayed checkpoint equal bit for bit to the driver's
   ``_trained_state``, the worker's launches 12 x (6 + 2) and 12 x 6
   (``PluginProbe``); ``analysis.best_checkpoint`` resumed in process
   for one step (12 + 12 launches); each relay's bytes and seconds,
   split into the worker's dump and serialize, the queue (pickle,
   socket, unpickle) and the driver's write, with GB/s; the sweep's wall
   against the sum of its fits; (c) two in-process gpt2-small trials of
   4 steps with ``get_tune_resources(num_workers=1, use_gpu=True)`` at
   ``max_concurrent_trials=2``: each ``Trainer`` given no device trains
   on its leased card (``leased_devices == ["cuda:0"]`` on one card),
   the one lease serializes them (their train intervals do not
   overlap), 2 x 12 x 4 launches of each kernel.  The tune path's
   launches of rows 1 and 6: (b)'s workers, (b)'s resume and (c);
13. ResNet and the sharded example, everything earlier freed, each run
   under a temporary ``default_root_dir``: (a) BASELINE config #2,
   ``ResNetLightningModule("resnet50", batch_size=128)`` (CIFAR stem,
   32x32x3, bf16, synthetic CIFAR-10 of 128 x 35 images:
   benchmarks/bench_native_baseline.py's 3 warm-up and 30 timed steps)
   under ``RayPlugin(num_workers=1)`` and in process from the same seed,
   cuDNN deterministic with autotuning off in both (the worker through
   ``init_hook=cudnn_deterministic``): every weight and running
   statistic on the driver, ``global_step`` and ``callback_metrics``
   equal bit for bit; every running mean off zero; no launch of the 16
   kernels (ResNet runs none); ``predict`` over 2 batches equal to the
   argmax of ``ResNet(x, train=False)`` on the same weights; steps/s
   per card, images/s and the median step (steps 4-33, synced) in the
   worker and in process, the fit call to the end of the first step,
   the result round trip's bytes and seconds, peak memory, the model
   FLOPs of a step (``FlopCounterMode``) and the MFU they give, the
   median step without cuDNN's deterministic algorithms (13 steps), and
   a 5-step ``TorchProfilerCallback`` window in process (device ms a
   step by category, the busy share of those steps' synced wall,
   kernels a step); (b) the sharded example
   (``examples/ray_ddp_sharded_example.train``) at gpt2-small, B=8,
   T=1024, in one worker under ZeRO-1 for 4 steps: its epoch line
   (relayed to the driver), peak memory, and the worker's launches
   (``PluginProbe``), 12 a step for both kernels, added to rows 1 and 6;
14. the loop engine (``Trainer(steps_per_execution=k,
   cache_train_dataset=...)``: each full chunk of k steps one CUDA graph
   replay), everything earlier freed, each fit under a temporary
   ``default_root_dir`` and held against the eager k=1 fit from the same
   seed: the same ``global_step`` and per-step losses (so the same
   batches: the cached fits' batches are the streamed ones'), every
   param, buffer and optimizer tensor bit for bit, one capture and one
   replay a full chunk.  (a) BASELINE config #1
   (benchmarks/bench_mnist.py:23-50): ``LightningMNISTClassifier(config=
   {"batch_size": 128})`` over 128 x 40 samples at k=1 (the double-
   buffered stream, against the unbuffered one), 128 x 64 at k=32 and
   128 x 128 at k=64 with the cache, 4 epochs each; (b) BASELINE config
   #2 cached (benchmarks/bench_resnet50.py:31-35): resnet50 at B=128,
   bf16, k=8 with the cache, 32 steps, in process and under
   ``RayPlugin(num_workers=1, init_hook=cudnn_deterministic)``, beside
   the streamed eager fit; (c) gpt2-small at B=8, T=1024, k=4, 16 steps:
   12 x 4 launches of flash_fwd and of flash_bwd a replay, counted
   through the graph, and 12 x (16 + the warm-up step) in the fit, added
   to rows 1 and 6.  For each fit: steps/s per card and images/s or
   tokens/s (synced marks at each epoch for MNIST, each dispatch
   otherwise; the first epoch or dispatch, which captures, and the
   profiled one left out), captures, replays, launches a replay, the
   capture's ms and pool bytes, one dispatch under ``torch.profiler``
   (device ms, kernels, busy share of its synced wall), peak memory;
15. the serving front door, run after phase 7:
   ``Server(GPTLightningModule("gpt2-small"), num_workers=1,
   buckets=(128, 256, 512, 1024), max_batch_slots=16,
   max_new_tokens=32, seed=seed)`` on the card (one persistent serve
   actor, its engine's programs captured at its setup), phase 3's 16
   requests from two tenants through ``submit``: every request
   completes, the tokens equal phase 3's in-process tokens request by
   request, the worker's ``serve_stats`` show flash_fwd 12 x its
   prefills and flash_decode 12 x its decode steps (added to rows 1 and
   13) and no capture after setup; TTFT p50, the pump's step ms, the
   engine's decode and prefill ms in the worker, tokens/s, ``start()``'s
   seconds by part (spawn, setup, of which the captures), the captures'
   ms and pool bytes;
16. the fleet, run first, the driver off CUDA until its near-tie checks:
   gpt2-small at full width, ``RLT_DECODE_IMPL=paged``, page 16, every
   replica ``num_workers=1`` with 16 slots and 32 new tokens; the
   traffic is ``benchmarks/bench_fleet.py`` ``record_trace``'s shape
   (read, not imported): 64 requests, alice and bob behind 256-token
   system prompts, carol cold, suffixes of 3-8 tokens, Beta(1.2, 2.0)
   arrivals over 0.8 s.  (a) one ``Server`` (unpaged) at 1x and 2x, the
   reference; (b) ``FleetServer(replicas=2, tenant_quotas={"carol":
   2})`` at 1x and 2x: every request completes, carol never holds more
   than 2 in flight, prefix hits; (c) a prefill and a decode replica
   with ``raw`` and ``fp8`` on the wire at 2x: no failover, ``ships +
   skipped`` = 64, ``raw`` rows installed bit for bit (a probe through
   ``export_kv`` on both sides), fp8 compression >= 3.0, then one
   chaos-dropped ship failing over after ``RLT_PEER_RETRIES`` = 2;
   (d) federation over the ``groups=`` shape (each group's first
   request alone, then the rest at 2x, own tenants, no slack): hits and
   ships > 0; (e) one replica, bounds [1, 2], at 4x: a grow in the
   burst, a shrink in the idle tail, nothing lost; (f) on (b)'s fleet,
   the whole trace at once and replica 0's worker killed while it holds
   admitted and queued requests: its queued ones complete elsewhere,
   its admitted ones fail with ``FleetReplicaLost`` caused by the
   death, the fleet grows back to two.  Tokens equal (a)'s, or diverge
   from them at a near-tie: teacher-forced over the shared prefix, the
   two tokens within 2e-2 in the plain-attention forward (fp32 logits),
   on the card, or else equal bit for bit one of the engine's own
   serving paths for the request, replayed in process (fp8's are
   counted, not held); every replica's launches (rows 1, 13, 14) from
   its worker stats, no capture after setup;
17. the one-card training ladder, before phase 18: (a) gpt2-medium at
   its full width (1024, 16 heads) cut to 8 of its 24 layers
   (``LADDER_MEDIUM_LAYERS``, so that phase 21 fits the run's time
   limit) at B=8, T=1024, bf16: one step's gradients under remat "off",
   "dots", "dots_no_batch" and "full" bit for bit with "off"'s, the
   step's peak memory ordered off >= dots >= dots_no_batch >= full,
   then a 6-step fit under each (rows 1 and 6; step ms, MFU by PERF.md
   section 2's formula, peak memory) and two more steps under
   torch.profiler (device ms by category, busy share), and "dots" at
   ``steps_per_execution=4`` (the selective checkpoint captured in a CUDA
   graph) against its eager fit bit for bit; (b) gpt2-moe-8e (768 wide,
   cut to 6 of its 12 layers, ``LADDER_MOE_LAYERS``, as gpt2-medium for
   phase 21; 8 experts, top-2, capacity 1.25, every second block
   routed) the same
   under "off", "dots", "dots_moe_act", "dots_moe" and "full" (peak
   memory off >= dots_moe >= dots_moe_act >= dots >= full), with
   ``moe_aux`` and MFU over the active parameters; (c) gpt2-small at
   dropout 0.1 (B=8, T=1024) and the bert-base masked LM (B=32, T=512)
   at ``steps_per_execution=4`` against their eager k=1 fits bit for bit,
   one capture and two replays, each replay launching the draw kernel
   ``philox_uniform`` as k eager steps do; (d) MNIST B=128 eager (BASELINE
   config #1) through the native prefetcher and through the Python path
   in turns: the same batches, the fits bit for bit, step ms of each;
   (e) ``csrc/philox.cu`` against its plain version bit for bit (on the
   card and on the CPU) at the main path's shapes, timed beside
   ``torch.rand`` and its bound.
18. Sharded: gpt2-1p3b at full width, its depth cut to 4 of its 24
    layers so the whole run fits its time limit with phases 19 and 20
    (``SHARD_LAYERS``; T=2048, bf16,
    remat "full"). (a) ``RaySpmdPlugin(num_workers=1, strategy="fsdp")``
    at B=8 for one epoch of 3 steps, its weights bit for bit with the
    in-process ``strategy="ddp"`` fit; step ms, peak memory, the rank's
    resident parameter and optimizer bytes (against the specs' count,
    and the specs' at W=2, 4, 8); then ``save_sharded_checkpoint``
    (bytes, blocking and whole seconds). (c) that checkpoint restored in
    one process (seconds): the weights bit for bit, one more step bit for
    bit with the uninterrupted DDP fit. (b) ``SpmdStrategy(
    gpt_partition_rules(), tensor=2)`` over two ranks from that
    checkpoint, at B=2: NCCL with two cards, else both ranks on card 0
    over gloo (``RLT_ONE_CARD_GLOO=1``; the leg logs which): the restore
    bit for bit with the checkpoint's parameters, the first step's loss
    and whole gradients against the unsharded step on rank 0 within 2e-2
    (per-tensor relative L2), three losses against the unsharded fit
    from the checkpoint within 2e-2.  Its launches ((a), (c), both ranks
    of (b); not the references' or the checks') go to rows 3 and 9 under
    ``sharded``, with their B=2 H=16 shape timed.
19. The parallel axes (everything earlier freed first): the three
    examples at their defaults, each over four ranks (NCCL with four
    cards, else all on card 0 over gloo, ``RLT_ONE_CARD_GLOO=1``, a
    host-bound correctness leg; the log says which), bf16, seeded
    weights, synthetic tokens, 3 steps a leg, (a) and (c) with their
    depth cut to 6 of their 12 layers (``PAR_LAYERS``: the run fits its
    time limit with phase 20).  (a) The long-context example:
    gpt2-small, T=8192, ``attention_impl="ring"``,
    ``SpmdStrategy(("data", "sequence"), sequence=4)``, B=1, each rank
    its 2048 positions.  (b) The pipeline example: ``PipelinedGPT(
    "gpt2-small", n_microbatches=4)``, ``PipelineStrategy(stages=4)``,
    B=8, T=1024; each rank launches flash_fwd and flash_bwd (3 layers) x
    4 microbatches a step, asserted.  (c) The MoE example: gpt2-moe-8e,
    (expert=2, tensor=2), B=8, T=1024; each rank 6 + 6 ("dots"
    recomputes the forward) flash_fwd and 6 flash_bwd a step at 6
    heads, asserted.  In each, rank 0 holds the first step's loss and
    whole gradients (and (c)'s ``moe_aux``) against the one-process step
    from the same weights (the ring's with ``attention_impl="flash"``)
    within 2e-2, and the three losses against a one-process fit within
    2e-2; step ms and each rank's peak memory are reported, with (a)'s
    ring and (b)'s pipeline bytes a step counted from the shapes.  (b)'s
    and (c)'s launches go to rows 1 and 6 under ``pipeline`` and
    ``moe_ep``, with their B=2 H=12 and B=8 H=6 shapes timed.
20. The comm plane: gpt2-small at full width (768, vocab 50304, bf16,
    T=1024) cut to 6 of its 12 layers (``COMM_LAYERS``, so that phase 21
    fits the run's time limit), random weights from the seed, over four ranks
    (NCCL with four cards, else all on card 0 over gloo), B=2 a rank,
    3 steps a leg, every policy on ``axes=("data",)``, all under one
    ``Trainer(plugins=[RayPlugin(num_workers=4)])``: its own fit is the
    off leg (``comm_policy=CommPolicy()``); then in each of its workers
    (``CommLegs``, start-up paid once) every other leg is a ``Trainer(
    comm_policy=...)`` fit nested inside the ranks' process group: no
    policy, int8 flat (one collective a gradient), int8 bucketed at 32
    MiB and its ``barrier_sync`` twin, int8 / fp8 / int4 with
    ``hierarchy=2`` (fp32 within pairs) and int8 with stochastic
    rounding (these in 32 MiB buckets), ZeRO-1 int8 with
    ``param_gather="bf16"`` in 32 MiB gather buckets, and over NCCL int8
    at ``steps_per_execution=2``, graphed; then ``comm.calibrate`` times
    the intra-host link and writes its cache under
    ``build/comm_calibration``.  Checks: the off leg's end state
    equals the no-policy leg's bit for bit (state digests); each
    compressed leg's first-step synced gradients within the codec's
    bound (the JAX tests' ``PSUM_TOL`` times the largest local
    gradient) of DDP's fp32 mean of the same gradients (ZeRO-1: the
    shards its own compressed reduce-scatter produced in that step,
    against the same slices of the mean); the last step's
    recorded collectives (comm/audit.py) equal ``GradSync``'s byte
    model by tag, exactly, on every rank, and the hierarchical legs
    move no codec bytes inside a pair and fp32 there; the residual
    nonzero after step 1; the three losses within 5% of the no-policy
    leg's; the calibration measured the intra-host link; the graphed
    leg captured once; each rank launched 12 flash_fwd and 12
    flash_bwd a step, and the stochastic rounding leg one
    ``philox_uniform`` a bucket for each of its two compressed phases.  Printed per leg: the median step ms of steps
    2-3 over the ranks, the exposed comm (that minus the no-policy
    leg's), the wire bytes a rank a step, peak memory, beside the
    card's name and power limit.  Its launches (every leg's ranks, not
    the checks') go to rows 1 and 6 and ``philox_uniform`` under
    ``comm``.
21. Serving under the training strategies (last): gpt2-1p3b at full
    width (2048, 32 heads of 64, vocab 50304, context 2048, bf16),
    seeded weights built whole on each rank and cut to its pieces,
    ``max_batch_slots=8``, the buckets ``resolve_buckets`` gives for
    2048, 16 requests with prompts of 100-1,500 tokens from the seed
    ((b) and (c) serve 8, one wave of the slots, and over gloo (a)
    too), 24 new tokens each; every rank on card 0 over gloo
    (``RLT_ONE_CARD_GLOO=1``: eager programs, every exchange through
    host copies), or with four cards one rank a card over NCCL (every
    program one CUDA graph).  (ref) the unsharded engine in this process
    on card 0.  (a) ``Server(num_workers=2, strategy=SpmdStrategy(
    gpt_partition_rules(), tensor=2))`` at 24 layers; (c) the same with
    paged prefix reuse (page 16, the paged kernel) and speculation (k=4,
    a 2-layer draft sharing the target's pieces) on prompts that share
    a 512-token prefix, then a one-token tail, or a 4-16 token tail for
    the last (a prefix hit replays its tail one suffix call a token, so
    the last one's suffix steps read rows its earlier ones wrote); (b)
    ``Server(num_workers=1, devices_per_worker=2, strategy="fsdp")``,
    (d) ``data=2 x tensor=2`` over four ranks and
    (e) a disaggregated ``FleetServer`` of two tensor=2 replicas (raw
    KV ships), each at 4 layers over gloo on one card with its own
    (ref) at that depth (24 over NCCL).  Checks: every rank's pieces
    equal (ref)'s slices bit for bit (fingerprints of the bits); every
    leg's tokens equal (ref)'s or leave them only at a near-tie within
    F1's 0.036; (a)'s first decode step's logits (eager, their argmax
    the served decode program's tokens) no farther from the fp32
    forward of the same weights than the largest of 0.036 and (ref)'s
    own two bf16 routes (flash kernels, plain attention); each rank's
    KV bytes its block's share of (ref)'s (half under tensor=2); (c)
    reused prefixes; (e)'s shipped rows installed bit for bit; each
    rank's launches match its calls (flash_fwd n_layer a prefill, the
    decode kernel n_layer a decode or suffix step, the draft's and the
    verify's per query); the NCCL legs graphed, the gloo legs ungraphed
    with the reason; no leg on fewer ranks than it asked for.  Printed per leg beside the card: TTFT p50,
    decode step ms, tokens/s, start s, KV bytes and peak memory a rank.
    Then rows 1, 13 and 14 at its shapes (flash_fwd at B=1, T up to
    2048, H=16 and 32; the decode kernels at S=4 and 8, L=2048, H=16 and
    32 against their plain versions and the split plan's arithmetic),
    their launches under ``serve_parallel`` (by rank in
    ``serve_parallel_by_rank``).
22. The elastic plane (``elastic_phase``): ``Trainer(max_steps=8,
    elastic={...}).fit(GPTLightningModule("gpt2-small"))`` under
    ``RayPlugin(num_workers=2, strategy="zero1")`` at full width and
    depth (12 layers, C=768, T=1024, batch 2 a rank, the module's
    AdamW), rank 1 killed at step 5 (``RLT_FAULT=kill:rank=1,step=5``);
    NCCL with two cards, else both ranks on card 0 over gloo.  The
    parity route (``redundancy=1``, a parity tick every step, so the
    escrow is overwritten 4 times before the kill; snapshots every 2
    steps): resumed at step 5 with 0 snapshot restores on one rank at
    batch 4, rank 1's optimizer shard rebuilt from parity with the
    digest rank 1 sent (both printed), a bf16 leaf among the rebuilt
    ones, final params within 1e-6 (largest absolute difference) of a
    clean mirror: two ranks to step 5 (the replay route's first fleet
    saves its state there, before the fault fires), then one rank at
    batch 4 in this process, the same program as the shrunk fleet's;
    and a control, the mirror with rank 1's first moments zeroed at its
    restore, past that bar.  The replay
    route (redundancy off, run first): resumed at step 2 or 4 with one
    restore.  Each
    fleet's ranks launch rows 1 and 6 12 times a step they ran.
    Printed beside the card: each parity tick's wire bytes and seconds
    against the declared bytes, each snapshot's blocking seconds, the
    recovery's seconds (from the driver's catch and from the kill to
    the shrunk fleet's first step).  Then rows 1 and 6 at the shrunk
    fleet's B=4 T=1024 H=12, their launches under ``elastic``.

The next-to-last line is the ``{"kernels": [...]}`` JSON record, one
entry per TPU kernel row, 1 to 16 (``launches`` from the path phases
that route to it by ``tpu_rows``, each counted from 0 just before its
phase; rows 1 and 6 also carry their non-causal times under
``noncausal``), then the port-only draw kernel ``philox_uniform``
(``row`` null, ``replaces`` naming the JAX draws it stands in for); the
last is ``{"ok": true, "device": {...}}``.  Without
CUDA the script prints an error and exits 1.

``--fwd-only`` builds the kernels and runs flash_fwd alone at every TPU
row 1-5 shape (``fwd_rows``: checked against its plain version and for
determinism, timed beside SDPA, TFLOP/s), then exits; no path is driven.
``--bwd-only`` does the same for flash_bwd at every row 6-12, 15, 16
shape (``bwd_rows``), its passes timed alone as well; ``--decode-only``
for flash_decode and flash_decode_paged (rows 13, 14) at the serve
paths' decode shapes (``decode_rows``: 16 slots at mixed positions and
at 272-352, one and four slots at 1023; pages 16 and 64, identity and
permuted tables; GB/s, host us a call, a sweep of the split's chunk).
Each is the A/B tool for a kernel's versions: unpack each tree (``git
archive``) under ``build/``, copy this script in, and run it from each
in turns (a tree without per-pass entry points times the whole backward
only).  ``--trainer-only`` checks and times flash_fwd and flash_bwd
(rows 1 and 6, as phase 2 does), runs phase 10 alone, and prints the
kernels line (rows 1 and 6, phase 10's launches) and the last line.
``--plugin-only`` builds the kernels, runs phase 11 before anything in
this process touches CUDA (and fails if CUDA is initialised here after
its plugin fits: the driver of a plugin run stays off the card), then
checks and times rows 1 and 6 as phase 2 does and prints the kernels
line (phase 11's worker launches) and the last line.  ``--tune-only``
does the same for phase 12: the driver stays off CUDA through (a) and
(b)'s sweeps (their trials train only in workers), then rows 1 and 6
and the kernels line (the tune path's launches).  ``--resnet-only``
does the same for phase 13: the driver stays off CUDA through the
resnet50 worker fit and the sharded example, then the in-process parts,
rows 1 and 6 and the kernels line (the sharded example's launches).
``--loop-only`` does the same for phase 14: the driver stays off CUDA
through (b)'s worker fit, then the in-process fits, rows 1 and 6 and the
kernels line (the phase's gpt2-small launches).  ``--server-only`` runs
phase 15 with the driver off CUDA, then phase 3 for the tokens to hold
it against, then checks and times rows 1 and 13 and prints the kernels
line (phase 15's worker launches) and the last line.  ``--fleet-only``
runs phase 16 alone (its legs with the driver off CUDA, then the
near-tie checks), then checks and times rows 1, 13 and 14 and prints
their kernels line (the fleet's worker launches) and the last line.
``--ladder-only`` checks and times rows 1 and 6 and ``philox_uniform``,
runs phase 17 alone, and prints their kernels line (the ladder's
launches) and the last line.  ``--sharded-only`` runs phase 18 alone,
then checks and times rows 3 and 9 at its shapes and prints their
kernels line (its launches) and the last line.  ``--parallel-only``
runs phase 19 alone, then checks and times rows 1 and 6 at its shapes
and prints their kernels line (its launches) and the last line.
``--comm-only`` does the same for phase 20 (rows 1 and 6 at B=2 T=1024
H=12, and ``philox_uniform``, whose launches there are the stochastic
rounding leg's draws).  ``--serve-parallel-only`` runs phase 21 alone,
then checks and times rows 1, 13 and 14 at its shapes and prints their
kernels line (its ranks' launches) and the last line; with four cards
(``python chip_smoke.py --serve-parallel-only`` on a four-card host) its
legs run over NCCL.  ``--serve-parallel-logits 0,1,2`` reads phase 21's
check of (a)'s first-step logits at each seed given, beside a control
with bf16 row-parallel sums (``serve_parallel_logits``), then F16's fp32
leg there: gpt2-1p3b in fp32 with TF32 off (plain attention and the
dense decode: the kernels take bf16), a tensor=2 ``Server``'s
first-step logits against the unsharded fp32 forward, beside the bar of
(ref)'s own two fp32 routes (its programs, the whole-sequence forward)
(``sp_fp32_logits``), and prints the last line.  ``--elastic-only`` runs phase 22 alone, then checks and times
rows 1 and 6 at the shrunk fleet's shape and prints their kernels line
(the elastic fits' launches) and the last line.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import functools
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from ray_lightning_tpu_torch import (  # noqa: E402
    Callback, EarlyStopping, Trainer)
from ray_lightning_tpu_torch.core.module import StepContext  # noqa: E402
from ray_lightning_tpu_torch.models.bert import (  # noqa: E402
    CONFIGS as BERT_CONFIGS, BertLightningModule, BertMLMModule)
from ray_lightning_tpu_torch.models.gpt import (  # noqa: E402
    CONFIGS, GPT, GPTLightningModule)
from ray_lightning_tpu_torch.ops import _kernels  # noqa: E402
from ray_lightning_tpu_torch.ops import flash_attention as fa  # noqa: E402
from ray_lightning_tpu_torch.ops import flash_decode as fd  # noqa: E402
from ray_lightning_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain, tpu_rows)
from ray_lightning_tpu_torch.ops.flash_decode import (  # noqa: E402
    flash_decode_attention, flash_decode_attention_plain,
    flash_decode_paged_attention, flash_decode_paged_attention_plain)
from ray_lightning_tpu_torch.serve import (  # noqa: E402
    PageConfig, Scheduler, ServeEngine, Server, ServeWorker, SpecConfig,
    bucket_for, pad_to_bucket)
from ray_lightning_tpu_torch.serve.fleet import (  # noqa: E402
    FleetReplicaLost, FleetServer)
from ray_lightning_tpu_torch import tune  # noqa: E402
from ray_lightning_tpu_torch.tune.integration import (  # noqa: E402
    _CheckpointPayload, _TuneCheckpointCallback)

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
#: bf16 tolerance of the package's parity tests (tests/test_ops.py)
BF16_TOL = 2e-2
#: lse is fp32 from the same bf16 operands: only summation order and
#: the fast exp differ
LSE_TOL = 1e-3
#: (atol, rtol) of a decode kernel against ``flash_decode_split_plain``,
#: the same arithmetic: about a bf16 ulp of the output (only the order
#: of fp32 sums differs)
SPLIT_TOL = (1e-3, 8e-3)
#: L2 is 50 MB: writing 256 MB between launches evicts it
FLUSH_BYTES = 256 * 2 ** 20

H, D = 12, 64
C = H * D
#: the training path's shape: gpt2-small at B=8, T=1024 (bench.py)
TRAIN_B, TRAIN_T = 8, 1024
TRAIN_STEPS = 20
#: gradient parity against plain attention: per-tensor relative L2
GRAD_TOL = 2e-2
#: flash_bwd against its plain backward: per-tensor relative L2.  The
#: two share every rounding point and differ only in summation order;
#: a fault confined to one 64-row tile moves a T=1024 gradient's
#: relative L2 by a few percent, far past this limit
BWD_TOL = 1e-3
SERVE_BUCKETS = (128, 256, 512, 1024)
SERVE_SLOTS = 16
NEW_TOKENS = 32
PROMPT_LENS = (17, 64, 100, 128, 150, 200, 256, 300, 400, 512, 600, 700,
               800, 900, 950, 990)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


#: GPU cycles of the ``torch.cuda._sleep`` that holds the stream while
#: the host queues a timed loop (~50 ms at H100 clocks, longer than a slow
#: host takes to queue 30 autograd backward calls): the events then time
#: the kernels back to back, not the host's launch rate
HOLD_CYCLES = 100_000_000
#: the same after each flush (~0.1 ms, longer than a wrapper's host time)
FLUSH_HOLD_CYCLES = 200_000


def time_ms(fn, *, iters: int = 30, warmup: int = 3,
            flush: "torch.Tensor | None" = None, clean: bool = False
            ) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, timed with CUDA
    events behind a device-side sleep, so the host's launch cost stays
    out of the timing.  With ``flush`` each launch is timed alone after
    a write of it that evicts L2, so its inputs come from device memory
    cold (and L2 holds dirty lines, written back while ``fn`` reads);
    with ``clean`` too, after a read of it instead (L2 clean)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    total = 0.0
    pairs = []
    for _ in range(iters):
        if clean:
            flush.max()
        else:
            flush.zero_()
        # the host queues the launch while the stream sleeps, so a slow
        # host's wrapper time never falls between the events
        torch.cuda._sleep(FLUSH_HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    for start, end in pairs:
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, flops: float) -> "tuple[float, str]":
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name: str, row: int, replaces: str, shape: str, err: float,
           r: dict, tol: float = BF16_TOL, source: "str | None" = None
           ) -> dict:
    """One entry of the ``kernels`` JSON line, for TPU kernel ``row``
    (PERF.md's table).  ``max_abs_err``/``ms`` and ``max_err``/
    ``kernel_ms`` carry the same numbers under the two names readers of
    the line use; ``launches`` is filled in from the path phases."""
    return {
        "name": name, "row": row, "route": "cuda",
        "source": source or f"ray_lightning_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "shape": shape,
        "max_abs_err": err, "max_err": err, "tol": tol,
        "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    }


def check_close(name: str, err: float, tol: float) -> None:
    if not err <= tol:        # also catches NaN
        raise AssertionError(f"{name}: max abs error {err} > tol {tol}")


# -- phase 2: kernels --------------------------------------------------------


def kernel_flash_fwd(gen: torch.Generator) -> dict:
    """flash_fwd at B=1, H=12, D=64, causal, bf16, on the strided q/k/v
    views of a fused qkv projection (the prefill's layout).  Timed with
    a warm L2, as the prefill finds q/k/v just written by the qkv
    projection."""
    worst = 0.0
    rows = {}
    for T in (128, 200, 1024):
        qkv = torch.randn(1, T, 3 * C, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (x.view(1, T, H, D) for x in qkv.split(C, dim=-1))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all())
        log(f"  flash_fwd T={T}: max_abs_err {err:.3e} (tol {BF16_TOL}), "
            f"lse max_abs_err {lse_err:.3e} (tol {LSE_TOL}), "
            f"finite {finite}")
        check_close(f"flash_fwd T={T}", err, BF16_TOL)
        check_close(f"flash_fwd lse T={T}", lse_err, LSE_TOL)
        if not finite:
            raise AssertionError(f"flash_fwd T={T}: non-finite output")
        worst = max(worst, err)
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        plain_ms = time_ms(
            lambda: flash_attention_fwd_plain(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        nbytes = 4 * T * C * 2 + H * T * 4        # q, k, v, o; fp32 lse
        flops = 4 * H * D * T * (T + 1) / 2       # QK^T + PV, causal
        b_ms, b_by = bound(nbytes, flops)
        log(f"  flash_fwd T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows[T] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
    entry = record("flash_fwd", 1,
                   "ray_lightning_tpu/ops/flash_attention.py:298",
                   "B=1 T=1024 H=12 D=64 causal bf16", worst, rows[1024])
    entry["ms_by_T"] = {str(t): rows[t]["ms"] for t in rows}
    entry["train_shape"] = fwd_train_shape(gen)
    return entry


def fwd_train_shape(gen: torch.Generator) -> dict:
    """flash_fwd at the training shape (B=8, T=1024, fused-qkv views),
    timed as the serve rows are, with its bound and the SDPA yardstick."""
    B, T = TRAIN_B, TRAIN_T
    qkv = torch.randn(B, T, 3 * C, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (x.view(B, T, H, D) for x in qkv.split(C, dim=-1))
    o, _ = flash_attention_fwd(q, k, v, causal=True)
    o_ref, _ = flash_attention_fwd_plain(q, k, v, causal=True)
    err = (o.float() - o_ref.float()).abs().max().item()
    check_close(f"flash_fwd B={B} T={T}", err, BF16_TOL)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: flash_attention_fwd_plain(q, k, v,
                                                         causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    nbytes = B * (4 * T * C * 2 + H * T * 4)
    flops = B * 4 * H * D * T * (T + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    log(f"  flash_fwd B={B} T={T}: max_abs_err {err:.3e}; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by})")
    return dict(shape=f"B={B} T={T} H=12 D=64 causal bf16", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)


def rel_l2(got, want) -> float:
    """||got - want|| / ||want||, the denominator at least that of a
    tensor of RMS 1e-3: dq and dk at T=1 are zero but for rounding."""
    got, want = got.float(), want.float()
    floor = 1e-3 * want.numel() ** 0.5
    return ((got - want).norm() / want.norm().clamp_min(floor)).item()


def max_over_rms(got, want) -> float:
    """max |got - want| over the RMS of ``want`` (reported beside the
    relative L2: it sees an error confined to a few rows)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.pow(2).mean().sqrt()).item()


def kernel_flash_bwd(gen: torch.Generator) -> dict:
    """flash_bwd at B=8, H=12, D=64, causal, bf16, on the fused-qkv
    views, at T=128, 200 (ragged) and 1024, against the plain backward
    on the same o, lse and dO: each of dq, dk, dv within ``BWD_TOL``
    in relative L2, its max abs error over RMS reported.  Timed at T=1024
    beside the plain version and the SDPA backward
    (``torch.autograd.grad`` of ``scaled_dot_product_attention`` with a
    retained graph, the backward alone)."""
    B = TRAIN_B
    worst = worst_abs = worst_mr = 0.0
    for T in (128, 200, TRAIN_T):
        qkv = torch.randn(B, T, 3 * C, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (x.view(B, T, H, D) for x in qkv.split(C, dim=-1))
        do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        errs = {n: rel_l2(a, b) for n, a, b in zip(names, got, want)}
        mrs = {n: max_over_rms(a, b) for n, a, b in zip(names, got, want)}
        abs_err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        log(f"  flash_bwd T={T}: relative L2 "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f" (tol {BWD_TOL}); max abs error over RMS "
            + ", ".join(f"{n} {e:.3e}" for n, e in mrs.items())
            + f"; max abs error {abs_err:.3e}; finite {finite}")
        for n, e in errs.items():
            if not e <= BWD_TOL:        # also catches NaN
                raise AssertionError(f"flash_bwd {n} T={T}: relative L2 "
                                     f"{e} > tol {BWD_TOL}")
        if not finite:
            raise AssertionError(f"flash_bwd T={T}: non-finite output")
        worst = max(worst, *errs.values())
        worst_mr = max(worst_mr, *mrs.values())
        worst_abs = max(worst_abs, abs_err)
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=True))
    plain_ms = time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), iters=10)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    gout = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), gout, retain_graph=True))
    del out
    T = TRAIN_T
    # q, k, v, o, dO read and dq, dk, dv written, fp32 lse read; five
    # causal [T, T] products of T^2 D multiply-adds over two a head
    nbytes = B * (8 * T * C * 2 + H * T * 4)
    flops = B * H * 5 * 2 * D * T * (T + 1) / 2
    b_ms, b_by = bound(nbytes, flops)
    log(f"  flash_bwd B={B} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa backward {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
    entry = record("flash_bwd", 6,
                   "ray_lightning_tpu/ops/flash_attention.py:329",
                   f"B={B} T={T} H=12 D=64 causal bf16", worst_abs,
                   dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by), tol=BWD_TOL)
    entry.update(err_metric="per-tensor relative L2 (tol applies)",
                 rel_l2=worst, max_abs_over_rms=worst_mr)
    return entry


def kernel_flash_decode(gen: torch.Generator, flush) -> dict:
    """flash_decode at S=16, L=1024, H=12, D=64, bf16; positions span
    the tile edges and the ends, the rest random."""
    S, L = SERVE_SLOTS, 1024
    positions = decode_positions(gen, S, L)
    qkv = torch.randn(S, 1, 3 * C, generator=gen, device="cuda").to(
        torch.bfloat16)
    q = qkv[..., :C].view(S, 1, H, D)
    kc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    vc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    o = flash_decode_attention(q, kc, vc, positions)
    again = flash_decode_attention(q, kc, vc, positions)
    o_ref = flash_decode_attention_plain(q, kc, vc, positions)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    finite = bool(torch.isfinite(o.float()).all())
    same = torch.equal(o, again)
    log(f"  flash_decode S={S} L={L}: max_abs_err {err:.3e} "
        f"(tol {BF16_TOL}), finite {finite}, two calls equal {same}, "
        f"positions {positions.tolist()}")
    check_close("flash_decode", err, BF16_TOL)
    if not finite or not same:
        raise AssertionError(f"flash_decode: finite {finite}, two calls "
                             f"equal {same}")
    ms = time_ms(lambda: flash_decode_attention(q, kc, vc, positions),
                 flush=flush)
    plain_ms = time_ms(
        lambda: flash_decode_attention_plain(q, kc, vc, positions),
        flush=flush)
    mask = (torch.arange(L, device="cuda")[None, :]
            <= positions[:, None].long())[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), flush=flush)
    live_rows = int((positions.long() + 1).sum())
    nbytes = 2 * S * C * 2 + 2 * live_rows * C * 2 + S * 4
    flops = 4 * live_rows * C
    b_ms, b_by = bound(nbytes, flops)
    log(f"  flash_decode: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
        f"{live_rows} live rows, L2 flushed before each launch")
    return record("flash_decode", 13,
                  "ray_lightning_tpu/ops/flash_decode.py:158",
                  "S=16 L=1024 H=12 D=64 bf16, mixed positions", err,
                  dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by))


def decode_positions(gen, S: int, L: int) -> torch.Tensor:
    """The decode checks' positions: the tile edges and the ends, the
    rest random."""
    fixed = [0, 1, 127, 128, 500, 1023]
    rand = torch.randint(0, L, (S - len(fixed),), generator=gen,
                         device="cuda")
    return torch.cat([torch.tensor(fixed, device="cuda"),
                      rand]).to(torch.int32)


def kernel_flash_decode_paged(gen, flush) -> dict:
    """flash_decode_paged (TPU row 14) at the row-13 shape, S=16, L=1024,
    H=12, D=64, bf16, mixed positions, page sizes 16 and 64: the slot
    cache's page view under the identity table (the engine's) and the
    same logical cache scattered over a random permutation of the
    physical pages.  Each within ``BF16_TOL`` of the plain version; the
    identity table equals the slot-contiguous kernel bit for bit, and so
    does the permuted one (the same rows, read in the same order).
    Timed at page size 16 with L2 flushed before each launch; the
    yardstick is SDPA on the slot-contiguous cache (the same function
    without the indirection)."""
    S, L = SERVE_SLOTS, 1024
    positions = decode_positions(gen, S, L)
    q = torch.randn(S, 1, 3 * C, generator=gen, device="cuda").to(
        torch.bfloat16)[..., :C].view(S, 1, H, D)
    kc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    vc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    flat = flash_decode_attention(q, kc, vc, positions)
    worst = 0.0
    timed = {}
    for ps in (16, 64):
        P = L // ps
        ident = torch.arange(S * P, dtype=torch.int32,
                             device="cuda").view(S, P)
        perm = torch.randperm(S * P, generator=gen, device="cuda").to(
            torch.int32).view(S, P)
        kp, vp = kc.view(S * P, ps, H, D), vc.view(S * P, ps, H, D)
        # logical page p of slot s stored at physical page perm[s, p]
        kq, vq = torch.empty_like(kp), torch.empty_like(vp)
        kq[perm.flatten().long()] = kp
        vq[perm.flatten().long()] = vp
        for name, args in (("identity", (kp, vp, ident)),
                           ("permuted", (kq, vq, perm))):
            o = flash_decode_paged_attention(q, args[0], args[1],
                                             positions, args[2])
            again = flash_decode_paged_attention(q, args[0], args[1],
                                                 positions, args[2])
            o_ref = flash_decode_paged_attention_plain(
                q, args[0], args[1], positions, args[2])
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs().max().item()
            same = torch.equal(o, flat) and torch.equal(o, again)
            log(f"  flash_decode_paged page {ps} {name} table: max_abs_err "
                f"{err:.3e} (tol {BF16_TOL}), equal to flash_decode and "
                f"to a second call {same}")
            check_close(f"flash_decode_paged page {ps} {name}", err,
                        BF16_TOL)
            if not same or not bool(torch.isfinite(o.float()).all()):
                raise AssertionError(
                    f"flash_decode_paged page {ps} {name}: not the slot-"
                    f"contiguous kernel's output, or two calls differ")
            worst = max(worst, err)
            timed[(ps, name)] = (
                lambda a=args: flash_decode_paged_attention(
                    q, a[0], a[1], positions, a[2]),
                lambda a=args: flash_decode_paged_attention_plain(
                    q, a[0], a[1], positions, a[2]))
    ms_by = {f"page{ps}_{name}": time_ms(fn, flush=flush)
             for (ps, name), (fn, _) in timed.items()}
    plain_ms = time_ms(timed[(16, "identity")][1], flush=flush)
    mask = (torch.arange(L, device="cuda")[None, :]
            <= positions[:, None].long())[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), flush=flush)
    flat_ms = time_ms(lambda: flash_decode_attention(q, kc, vc, positions),
                      flush=flush)
    live_rows = int((positions.long() + 1).sum())
    live_pages = int((positions.long() // 16 + 1).sum())
    # q and o, the live K/V rows, positions, the live pages' table entries
    nbytes = (2 * S * C * 2 + 2 * live_rows * C * 2 + S * 4
              + live_pages * 4)
    b_ms, b_by = bound(nbytes, 4 * live_rows * C)
    ms = ms_by["page16_identity"]
    log(f"  flash_decode_paged: kernel {ms:.4f} ms (page 16, identity; "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms_by.items())
        + f"), flash_decode {flat_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa on the slot cache {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}); {live_rows} live rows, L2 flushed before each launch")
    entry = record(
        "flash_decode_paged", 14,
        "ray_lightning_tpu/ops/flash_decode.py:166",
        "S=16 L=1024 H=12 D=64 bf16, page 16, identity table, mixed "
        "positions", worst,
        dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
             bound_by=b_by),
        source="ray_lightning_tpu_torch/csrc/flash_decode.cu")
    entry.update(ms_by_table=ms_by, flash_decode_ms_same_inputs=flat_ms,
                 library="scaled_dot_product_attention on the "
                         "slot-contiguous cache (no page table)")
    return entry


# -- phase 3: serve ----------------------------------------------------------


def check_parity(ref: GPT, req) -> "tuple[int, int]":
    """Teacher-forced greedy parity on the engine's own tokens: each
    generated token is the reference argmax, or a near-tie within the
    bf16 tolerance.  One causal forward over prompt + generated[:-1]
    gives every step's reference logits.  Returns (exact, near-ties)."""
    gen = [int(t) for t in req.result(0)]
    prompt = [int(t) for t in req.tokens]
    seq = torch.tensor([prompt + gen[:-1]], device="cuda")
    with torch.inference_mode():
        logits = ref(seq)[0, len(prompt) - 1:].float()
    if logits.shape[0] != len(gen) or not torch.isfinite(logits).all():
        raise AssertionError(f"request {req.id}: bad reference logits")
    exact = ties = 0
    for i, tok in enumerate(gen):
        best = int(logits[i].argmax())
        if tok == best:
            exact += 1
        elif logits[i, tok] >= logits[i, best] - BF16_TOL:
            ties += 1
        else:
            raise AssertionError(
                f"request {req.id} (prompt {len(prompt)}) step {i}: token "
                f"{tok} logit {float(logits[i, tok]):.4f} vs argmax {best} "
                f"{float(logits[i, best]):.4f}")
    return exact, ties


def serve_phase(seed: int) -> dict:
    module = GPTLightningModule("gpt2-small")
    cfg = module.config
    t0 = time.monotonic()
    engine = ServeEngine(module, buckets=SERVE_BUCKETS, slots=SERVE_SLOTS,
                         max_seq_len=cfg.block_size, seed=seed,
                         device="cuda").setup()
    log(f"  engine setup {time.monotonic() - t0:.2f} s: kv "
        f"{engine.kv_spec.shape}, decode attention {engine.decode_kernel}, "
        + graph_line(engine.stats()))
    if engine.decode_kernel != "flash_decode":
        raise AssertionError(f"decode runs {engine.decode_kernel}, not the "
                             f"flash_decode kernel")
    sched = Scheduler(buckets=engine.buckets, slots=engine.slots,
                      max_seq_len=engine.max_seq_len,
                      default_max_new_tokens=NEW_TOKENS)
    worker = ServeWorker(engine)
    rng = np.random.default_rng(seed)
    reqs = [sched.submit(rng.integers(0, cfg.vocab_size, n),
                         tenant=("alice", "bob")[i % 2])
            for i, n in enumerate(PROMPT_LENS)]

    calls0 = dict(engine.calls)
    secs0 = dict(engine.seconds)
    _kernels.reset_launches()
    t0 = time.monotonic()
    steps = 0
    while not sched.idle():
        plan = sched.plan()
        if plan is None or steps > 10_000:
            raise AssertionError("scheduler stalled with work left")
        sched.apply(plan, worker.serve_step(plan))
        steps += 1
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    prefills = engine.calls["prefill"] - calls0["prefill"]
    decodes = engine.calls["decode"] - calls0["decode"]

    if not all(r.done() and r.error is None for r in reqs):
        raise AssertionError("not every request completed")
    for r in reqs:
        toks = r.result(0)
        if len(toks) != NEW_TOKENS or toks.min() < 0 \
                or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.id}: bad tokens {toks}")
    n_layer = cfg.n_layer
    want = {"flash_fwd": n_layer * prefills,
            "flash_decode": n_layer * decodes}
    for name, n in want.items():
        if launches[name] != n or n == 0:
            raise AssertionError(
                f"{name} launched {launches[name]} times in the serve "
                f"phase; {n_layer} layers x steps want {n}")
    log(f"  {len(reqs)} requests done in {steps} steps, {wall:.3f} s; "
        f"{prefills} prefills, {decodes} decode steps; launches "
        f"{launches} (= {n_layer} x steps)")
    graphs = check_graphs(engine, [f"prefill_{b}" for b in SERVE_BUCKETS]
                          + ["decode"])

    # reference: the same weights, whole-sequence forward, plain attention
    ref = GPT(dataclasses.replace(engine.model.config,
                                  attention_impl="dot"))
    ref.load_state_dict(engine.model.state_dict())
    ref.to(dtype=torch.bfloat16).eval()
    by_bucket = {}
    for r in reqs:
        by_bucket[r.bucket] = r      # the longest prompt of each bucket
    checked = []
    for b in SERVE_BUCKETS:
        r = by_bucket[b]
        exact, ties = check_parity(ref, r)
        checked.append((len(r.tokens), b, exact, ties))
        log(f"  parity: prompt {len(r.tokens)} (bucket {b}): {exact} "
            f"exact, {ties} near-ties of {NEW_TOKENS}")

    ttfts = sorted(r.ttft_s for r in reqs)
    tokens = sum(len(r.result(0)) for r in reqs)
    decode_ms = (engine.seconds["decode"] - secs0["decode"]) / decodes * 1e3
    prefill_ms = ((engine.seconds["prefill"] - secs0["prefill"])
                  / prefills * 1e3)
    stats = {
        "ttft_p50_ms": float(np.percentile(ttfts, 50)) * 1e3,
        "decode_step_ms": decode_ms,
        "prefill_ms": prefill_ms,
        "tokens_per_s": tokens / wall,
        "wall_s": wall,
        "requests": len(reqs),
        "prefills": prefills,
        "decode_steps": decodes,
        "parity_checked": checked,
        "graphs": graphs,
    }
    log(f"  serve: TTFT p50 {stats['ttft_p50_ms']:.2f} ms, decode step "
        f"{decode_ms:.3f} ms, prefill {prefill_ms:.3f} ms, "
        f"{stats['tokens_per_s']:.1f} tokens/s")
    log("serve " + json.dumps(stats))
    return {"launches": launches, "engine": engine,
            "tokens": [r.result(0).tolist() for r in reqs]}


def graph_line(stats: dict) -> str:
    """An engine's graphs: captures per program, capture ms, pool."""
    return (f"{sum(stats['captures'].values())} graphs "
            f"{stats['captures']} captured in {stats['capture_ms']:.1f} "
            f"ms, pool {stats['pool_bytes'] / 2 ** 20:.1f} MB")


def check_graphs(engine, programs: list) -> dict:
    """Each of ``programs`` captured once at setup (the suffix one graph
    a slot) and nothing captured since: the engine's ``captures``,
    ``recaptures``, capture ms and pool bytes, logged."""
    st = engine.stats()
    want = {p: engine.slots if p == "suffix" else 1 for p in programs}
    if st["captures"] != want or any(st["recaptures"].values()):
        raise AssertionError(f"graphs: captures {st['captures']} (want "
                             f"{want}), recaptures {st['recaptures']}")
    log(f"  graphs: recaptures {st['recaptures']}; " + graph_line(st))
    return {k: st[k] for k in ("captures", "recaptures", "capture_ms",
                               "pool_bytes")}


# -- phase 4: train -----------------------------------------------------------


class StepClock(Callback):
    """Per-step host wall (synced before and after the step) and loss."""

    def __init__(self):
        self.ms: "list[float]" = []
        self.losses: "list[float]" = []

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - self._t0) * 1e3)
        self.losses.append(float(outputs["loss"]))


def fit(module, steps: int, seed: int):
    clock = StepClock()
    trainer = Trainer(max_steps=steps, enable_checkpointing=False,
                      logger=False, num_sanity_val_steps=0,
                      limit_val_batches=0, seed=seed, callbacks=[clock],
                      device="cuda")
    trainer.fit(module)
    return trainer, clock


def gpt2_small(attention_impl: str = "auto"):
    cfg = dataclasses.replace(CONFIGS["gpt2-small"],
                              attention_impl=attention_impl)
    return GPTLightningModule(cfg, batch_size=TRAIN_B, warmup_steps=2,
                              dataset_size=TRAIN_B * TRAIN_STEPS)


def first_batch(module):
    return tuple(x.to("cuda") for x in next(iter(module.train_dataloader())))


def step_grads(attention_impl: str, seed: int, batch) -> dict:
    """One step's gradients of the loss on ``batch`` for gpt2-small with
    the seeded init cast to bf16, as the trainer makes it."""
    return module_grads(gpt2_small(attention_impl), seed, batch)


def module_grads(module, seed: int, batch) -> dict:
    """One step's gradients of ``module``'s loss on ``batch`` from its
    seeded init cast to bf16, as the trainer makes it."""
    module.init_params(torch.Generator(device="cuda").manual_seed(seed))
    module.model.to(dtype=module.param_dtype)
    params = dict(module.model.named_parameters())
    loss = module.training_step(StepContext(module, training=True), batch)
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def grads_rel_l2(got: dict, want: dict) -> dict:
    """Per-tensor relative L2 error of one gradient dict against
    another."""
    return {k: ((got[k].float() - want[k].float()).norm()
                / want[k].float().norm().clamp_min(1e-30)).item()
            for k in want}


def model_flops_per_step(cfg, B: int, T: int, causal: bool = True,
                         lm_head: bool = True) -> float:
    """6 x (matmul params + the vocab head, if any) x tokens + attention:
    the QK^T and PV products, 2 T^2 C multiply-adds a layer per sequence
    forward, over two when causal, times 3 for forward and backward."""
    L, Cm, V = cfg.n_layer, cfg.n_embd, cfg.vocab_size
    return (6 * B * T * (12 * L * Cm * Cm + lm_head * V * Cm)
            + (6 if causal else 12) * B * L * T * T * Cm)


def check_fit(clock, trainer, launches: dict, n_layer: int, n: int,
              what: str, remat: bool = True) -> None:
    """Every step ran with a finite loss, and per step each layer
    launched flash_bwd once and flash_fwd once, or twice under remat
    (the forward and its recompute in the backward pass)."""
    losses = clock.losses
    if len(losses) != n or trainer.global_step != n:
        raise AssertionError(f"{what}: fit ran {len(losses)} steps, want {n}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite loss: {losses}")
    want = {"flash_fwd": (1 + remat) * n_layer * n, "flash_bwd": n_layer * n}
    for name, w in want.items():
        if launches[name] != w:
            raise AssertionError(
                f"{what}: {name} launched {launches[name]} times; "
                f"{n_layer} layers x {n} steps (remat {remat}) want {w}")


def fit_stats(module, clock, B: int, T: int, card: str,
              first: int, causal: bool = True) -> dict:
    cfg = module.config
    step_ms = float(np.median(clock.ms[first:]))
    # the classifier has no vocab head
    flops = model_flops_per_step(
        cfg, B, T, causal, not isinstance(module, BertLightningModule))
    return {"card": card, "batch": B, "seq": T, "layers": cfg.n_layer,
            "heads": cfg.n_head, "n_embd": cfg.n_embd,
            "step_ms_median": step_ms, "step_ms": clock.ms,
            "tokens_per_s": B * T / (step_ms / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "model_flops_per_step": flops,
            "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
            "losses": clock.losses}


def train_phase(seed: int, card: str) -> dict:
    n = TRAIN_STEPS
    module = gpt2_small()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.monotonic()
    trainer, clock = fit(module, n, seed)
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    losses = clock.losses
    log(f"  fit: {n} steps in {wall:.2f} s (set-up included); losses "
        + " ".join(f"{x:.4f}" for x in losses))
    cfg = module.config
    check_fit(clock, trainer, launches, cfg.n_layer, n, "gpt2-small",
              remat=False)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    log(f"  launches in the fit: {launches} (= {cfg.n_layer} x {n} for "
        f"flash_fwd and flash_bwd)")
    p_dtypes = {str(p.dtype) for p in module.model.parameters()}
    master = trainer.state.opt_state.master
    log(f"  params {sorted(p_dtypes)}, fp32 master of {len(master)} "
        f"tensors")

    stats = fit_stats(module, clock, TRAIN_B, TRAIN_T, card, first=2)
    stats.update(steps=n, memory_before_fit_gb=base_gb)
    log(f"  [{card}] step {stats['step_ms_median']:.3f} ms (median of "
        f"steps 3-{n}, host wall, synced), {stats['tokens_per_s']:.0f} "
        f"tokens/s, peak memory {stats['peak_memory_gb']:.2f} GB "
        f"({base_gb:.2f} GB held before the fit: the serve engine), model "
        f"flops {stats['model_flops_per_step'] / 1e12:.3f} TFLOP a step "
        f"(6 x (12 L C^2 + V C) x B T + 6 B L T^2 C), MFU "
        f"{stats['mfu']:.4f} of 989 TFLOP/s")

    # the profile phase runs the fit's own step on its state and batch
    batch = first_batch(module)

    def train_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch)

    # gradient parity: one step from the same weights and batch, plain
    # attention under autograd as the reference
    g_flash = step_grads("auto", seed, batch)
    g_dot = step_grads("dot", seed, batch)
    rel = grads_rel_l2(g_flash, g_dot)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    log(f"  grad parity vs dot attention: per-tensor relative L2 max "
        f"{worst[0][1]:.3e} ({worst[0][0]}), median "
        f"{float(np.median(list(rel.values()))):.3e} (tol {GRAD_TOL}); "
        f"worst: " + ", ".join(f"{k} {v:.3e}" for k, v in worst[:4]))
    if not all(np.isfinite(v) and v <= GRAD_TOL for v in rel.values()):
        raise AssertionError(f"gradient parity: {worst[:4]}")
    del g_flash, g_dot
    torch.cuda.empty_cache()

    # the same data: the dataset's draws depend on its size
    _, dot_clock = fit(gpt2_small("dot"), 3, seed)
    diffs = [abs(a - b) for a, b in zip(losses[:3], dot_clock.losses)]
    log(f"  first 3 losses: flash {losses[:3]}, dot {dot_clock.losses}; "
        f"abs diff {max(diffs):.3e} (tol {BF16_TOL})")
    if len(dot_clock.losses) != 3 or not max(diffs) <= BF16_TOL:
        raise AssertionError("first 3 losses disagree with the dot run")
    stats.update(grad_rel_l2_max=worst[0][1], loss_diff_first3=max(diffs))
    log("train " + json.dumps(stats))
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats, "train_step": train_step}


def _device_us(event) -> float:
    """Device time of a kernel-side profiler event (0 for host ops,
    whose self device time would count their kernels a second time)."""
    from torch.autograd import DeviceType
    if event.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


#: device-kernel name fragments -> the layer they belong to
CATEGORIES = (("flash_", "attention kernels"),
              # full-fp32 products (TF32 off): the chunked CE's logits
              ("sgemm", "GEMM fp32"), ("nvjet_sss", "GEMM fp32"),
              ("f32f32_f32f32", "GEMM fp32"), ("nvjet", "GEMM"),
              ("gemm", "GEMM"), ("cutlass", "GEMM"), ("xmma", "GEMM"),
              ("multi_tensor_apply", "optimizer (foreach)"),
              ("layer_norm", "layer norm"), ("reduce_kernel", "reductions"),
              ("index", "gather / scatter"), ("scatter", "gather / scatter"),
              ("gather", "gather / scatter"), ("elementwise", "elementwise"))


def category(name: str) -> str:
    low = name.lower()
    return next((c for frag, c in CATEGORIES if frag in low), "other")


def profile_fn(kind: str, fn, steps: int) -> dict:
    """``fn`` timed bare (host clock, ending in a sync) and under
    torch.profiler over ``steps`` calls after one warm call: device
    kernel time by name and by category, the device busy share (kernel
    time over the profiled wall; the profiler's own host cost makes it a
    lower bound), the top host ops."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / steps * 1e3
    averages = prof.key_averages()
    events = [e for e in averages if _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in events) / steps / 1e3
    top = sorted(events, key=_device_us, reverse=True)[:12]
    by_cat: "dict[str, float]" = {}
    for e in events:
        c = category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + _device_us(e) / steps / 1e3
    host_top = sorted((e for e in averages if _device_us(e) == 0),
                      key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    out = {
        "host_ms": bare_ms, "profiled_host_ms": prof_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / prof_ms if prof_ms else None,
        "device_share_of_bare_ms": device_ms / bare_ms,
        "kernels_launched": sum(e.count for e in events) // steps,
        "top_device_ms": [[e.key[:100], _device_us(e) / steps / 1e3]
                          for e in top],
        "device_ms_by_category": dict(sorted(
            by_cat.items(), key=lambda kv: -kv[1])),
        "top_host_self_ms": {
            e.key[:60]: e.self_cpu_time_total / steps / 1e3
            for e in host_top},
        "host_calls": {e.key[:60]: e.count // steps for e in host_top},
    }
    log(f"  {kind}: host {bare_ms:.3f} ms/step bare, {prof_ms:.3f} "
        f"profiled; device {device_ms:.3f} ms "
        f"({out['kernels_launched']} kernels); busy share "
        f"{out['device_busy_share']:.3f} of the profiled wall, "
        f"{out['device_share_of_bare_ms']:.3f} of the bare one")
    for name, ms in out["device_ms_by_category"].items():
        log(f"    device {ms:.4f} ms  [{name}]")
    for name, ms in out["top_device_ms"]:
        log(f"    device {ms:.4f} ms  {name}")
    for name, ms in out["top_host_self_ms"].items():
        log(f"    host {ms:.4f} ms  {out['host_calls'][name]}x {name}")
    return out


def profile_phase(engine, train_step, steps: int = 5) -> dict:
    """Where the time goes: ``steps`` decode steps with all 16 slots live
    at position 512, one prefill at bucket 1024 and one gpt2-small train
    step at B=8, T=1024 (``train_step()``, 3 times), each through
    :func:`profile_fn`.  The serve programs twice: their eager steps
    (``engine.run_eager``: a kernel per op, so the categories) and their
    graphs' replays (what serving runs: the host's share gone)."""
    S = engine.slots
    toks = np.ones(S, np.int32)
    pos = np.full(S, 512, np.int32)
    prompt = np.ones((1, 1024), np.int32)
    out = {
        "decode": profile_fn(
            "decode (eager step)",
            lambda: engine.run_eager("decode", toks, pos), steps),
        "decode_replay": profile_fn(
            "decode (graph replay)", lambda: engine.decode(toks, pos),
            steps),
        "prefill_1024": profile_fn(
            "prefill_1024 (eager step)",
            lambda: engine.run_eager("prefill_1024", prompt, [0], [1000]),
            steps),
        "prefill_1024_replay": profile_fn(
            "prefill_1024 (graph replay)",
            lambda: engine.prefill(0, prompt, 1000, 1024), steps),
        "train_step": profile_fn("train_step", train_step, 3),
    }
    if not out["decode"]["device_ms"] > 0:
        raise AssertionError("the profiler saw no device time")
    log("profile " + json.dumps(out))
    return out


# -- phases 6 and 7: paged serve with prefix reuse, speculative serve --------

#: paged KV: tokens per page, and each tenant's shared system prefix (16
#: pages) ahead of a distinct tail of 16-64 tokens
PAGE_SIZE = 16
SYSTEM_PREFIX = 256
PAGED_REQUESTS = 24
SPEC_REQUESTS = 16
#: speculation depth; the default draft is the first 6 of 12 layers
SPEC_K = 4
#: arrivals: waves of this many requests, this many steps apart
WAVE, WAVE_GAP = 4, 6


@contextlib.contextmanager
def scoped_env(**values: str):
    """Environment variables set for the block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def decode_impl(value: str):
    """``RLT_DECODE_IMPL`` set for the block, restored after it."""
    return scoped_env(RLT_DECODE_IMPL=value)


def tenant_traffic(seed: int, vocab: int, n: int) -> list:
    """``n`` (tenant, prompt) pairs from two tenants: each tenant's
    prompts share its 256-token system prefix, then a distinct random
    tail of 16-64 tokens."""
    rng = np.random.default_rng(seed)
    prefix = {t: rng.integers(0, vocab, SYSTEM_PREFIX)
              for t in ("alice", "bob")}
    out = []
    for i in range(n):
        t = ("alice", "bob")[i % 2]
        tail = rng.integers(0, vocab, int(rng.integers(16, 65)))
        out.append((t, np.concatenate([prefix[t], tail])))
    return out


def serve_in_waves(sched, worker, traffic) -> "tuple[list, int]":
    """Submit ``traffic`` in waves of ``WAVE``, ``WAVE_GAP`` steps apart,
    and step until every request is done."""
    reqs, steps, i = [], 0, 0
    while i < len(traffic) or not sched.idle():
        if i < len(traffic) and steps % WAVE_GAP == 0:
            reqs += [sched.submit(p, tenant=t)
                     for t, p in traffic[i:i + WAVE]]
            i += WAVE
        plan = sched.plan()
        if plan is not None:
            sched.apply(plan, worker.serve_step(plan))
        steps += 1
        if steps > 20_000:
            raise AssertionError("scheduler stalled with work left")
    torch.cuda.synchronize()
    return reqs, steps


def check_requests(reqs, engine, new_tokens: int = NEW_TOKENS
                   ) -> "tuple[int, int]":
    """Every request completed with ``new_tokens`` valid tokens, and each
    passes the teacher-forced parity rule against a cold whole-sequence
    forward with plain attention on the engine's weights.  Returns
    (exact, near-ties) over all of them."""
    vocab = engine.model.config.vocab_size
    for r in reqs:
        if not (r.done() and r.error is None):
            raise AssertionError(f"request {r.id} did not complete")
        toks = r.result(0)
        if len(toks) != new_tokens or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"request {r.id}: bad tokens {toks}")
    ref = GPT(dataclasses.replace(engine.model.config,
                                  attention_impl="dot"))
    ref.load_state_dict(engine.model.state_dict())
    ref.to(dtype=torch.bfloat16).eval()
    exact = ties = 0
    for r in reqs:
        e, t = check_parity(ref, r)
        exact, ties = exact + e, ties + t
    del ref
    return exact, ties


def calls_since(engine, calls0: dict, secs0: dict) -> "tuple[dict, dict]":
    return ({k: engine.calls[k] - calls0[k] for k in engine.calls},
            {k: engine.seconds[k] - secs0[k] for k in engine.seconds})


def per_call_ms(secs: dict, calls: dict, name: str):
    return secs[name] / calls[name] * 1e3 if calls[name] else None


def ttft_ms(reqs, which=None) -> "float | None":
    xs = [r.ttft_s for r in reqs if which is None or which(r)]
    return float(np.percentile(xs, 50)) * 1e3 if xs else None


def paged_serve_phase(seed: int, card: str) -> dict:
    """gpt2-small at full width, 16 slots, buckets (128, 256, 512, 1024),
    page size 16, ``RLT_DECODE_IMPL=paged``: two tenants' prompts behind
    their shared 256-token prefixes, in waves.  The decode steps and the
    prefix-reuse suffix steps launch flash_decode_paged once per layer,
    at least half of the admissions reuse a prefix, every request passes
    greedy parity against a cold forward."""
    pages = PageConfig(enabled=True, page_size=PAGE_SIZE)
    with decode_impl("paged"):
        module = GPTLightningModule("gpt2-small")
        cfg = module.config
        engine = ServeEngine(module, buckets=SERVE_BUCKETS,
                             slots=SERVE_SLOTS, max_seq_len=cfg.block_size,
                             seed=seed, device="cuda", paged=pages).setup()
    if engine.decode_kernel != "paged":
        raise AssertionError(f"decode runs {engine.decode_kernel}, not the "
                             f"paged kernel")
    log("  paged engine: " + graph_line(engine.stats()))
    sched = Scheduler(buckets=engine.buckets, slots=engine.slots,
                      max_seq_len=engine.max_seq_len,
                      default_max_new_tokens=NEW_TOKENS, paged=pages)
    traffic = tenant_traffic(seed, cfg.vocab_size, PAGED_REQUESTS)
    calls0, secs0 = dict(engine.calls), dict(engine.seconds)
    _kernels.reset_launches()
    t0 = time.monotonic()
    reqs, steps = serve_in_waves(sched, ServeWorker(engine), traffic)
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    calls, secs = calls_since(engine, calls0, secs0)
    n = cfg.n_layer
    want = {"flash_decode_paged": n * (calls["decode"] + calls["suffix"]),
            "flash_fwd": n * calls["prefill"], "flash_decode": 0}
    for name, w in want.items():
        if launches[name] != w:
            raise AssertionError(
                f"{name} launched {launches[name]} times in the paged "
                f"serve phase; {n} layers x steps want {w}")
    if not calls["decode"] or not calls["suffix"]:
        raise AssertionError(f"paged phase ran no decode or suffix: {calls}")
    st = sched.pages.stats()
    if not st["prefill_tokens_computed"] < st["prefill_tokens_requested"] \
            or 2 * st["reused_prefills"] < len(reqs):
        raise AssertionError(f"prefix reuse too rare: {st}")
    exact, ties = check_requests(reqs, engine)
    graphs = check_graphs(engine, [f"prefill_{b}" for b in SERVE_BUCKETS]
                          + ["decode", "kv_copy", "suffix"])
    stats = {
        "card": card, "requests": len(reqs), "steps": steps,
        "wall_s": wall, "calls": calls, "graphs": graphs,
        "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
        "ttft_p50_ms": ttft_ms(reqs),
        "decode_step_ms": per_call_ms(secs, calls, "decode"),
        "suffix_step_ms": per_call_ms(secs, calls, "suffix"),
        "kv_copy_ms": per_call_ms(secs, calls, "kv_copy"),
        "prefill_ms": per_call_ms(secs, calls, "prefill"),
        "pages": st, "parity_exact": exact, "parity_near_ties": ties,
    }
    log(f"  paged: {len(reqs)} requests in {steps} steps, {wall:.3f} s; "
        f"calls {calls}; launches {launches} (= {n} x (decode + suffix) "
        f"and {n} x prefills); prefill tokens computed "
        f"{st['prefill_tokens_computed']} of "
        f"{st['prefill_tokens_requested']} requested, "
        f"{st['reused_prefills']} reused admissions; parity {exact} exact, "
        f"{ties} near-ties")
    log(f"  [{card}] paged: TTFT p50 {stats['ttft_p50_ms']:.2f} ms, decode "
        f"step {stats['decode_step_ms']:.3f} ms, suffix step "
        f"{stats['suffix_step_ms']:.3f} ms, kv copy "
        f"{stats['kv_copy_ms']:.3f} ms, cold prefill "
        f"{stats['prefill_ms']:.3f} ms, {stats['tokens_per_s']:.1f} "
        f"tokens/s")
    S = engine.slots
    toks, pos = np.ones(S, np.int32), np.full(S, 512, np.int32)
    stats["profile_decode"] = profile_fn(
        "decode_paged", lambda: engine.decode(toks, pos), 5)
    log("paged " + json.dumps(stats))
    del engine, sched, reqs
    free_cuda()
    return {"launches": launches, "stats": stats}


def spec_run(seed: int, draft_layers: int, n_requests: int,
             new_tokens: int = NEW_TOKENS):
    """A speculative engine (k = SPEC_K, the given draft depth) on the
    paged engine, serving ``n_requests`` of the tenant traffic."""
    pages = PageConfig(enabled=True, page_size=PAGE_SIZE)
    spec = SpecConfig(enabled=True, k=SPEC_K, draft_layers=draft_layers)
    with decode_impl("paged"):
        module = GPTLightningModule("gpt2-small")
        engine = ServeEngine(module, buckets=SERVE_BUCKETS,
                             slots=SERVE_SLOTS,
                             max_seq_len=module.config.block_size,
                             seed=seed, device="cuda", paged=pages,
                             spec=spec).setup()
    if engine.decode_kernel != "paged":
        raise AssertionError(f"decode runs {engine.decode_kernel}")
    if not engine.stats()["spec"]["draft_shares_weights"]:
        raise AssertionError("the draft holds weights of its own")
    sched = Scheduler(buckets=engine.buckets, slots=engine.slots,
                      max_seq_len=engine.max_seq_len,
                      default_max_new_tokens=new_tokens, paged=pages,
                      spec=spec)
    traffic = tenant_traffic(seed + 1, module.config.vocab_size,
                             n_requests)
    calls0, secs0 = dict(engine.calls), dict(engine.seconds)
    _kernels.reset_launches()
    t0 = time.monotonic()
    reqs, steps = serve_in_waves(sched, ServeWorker(engine), traffic)
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    calls, secs = calls_since(engine, calls0, secs0)
    return engine, sched, reqs, steps, wall, launches, calls, secs


def spec_serve_phase(seed: int, card: str) -> dict:
    """Speculative decoding, k = 4, the default draft (the first 6 of 12
    layers, sharing the target's tensors) on the paged engine, over the
    tenant traffic: every request completes with greedy parity, the
    fold's identity ``emitted == accepted + corrected`` holds, a verify
    launches flash_decode_paged 12 x (k+1) times and a draft round
    6 x (k+1); then a full-clone-draft run (12 layers) over the same
    requests must reach acceptance 0.9: the draft is the target, and
    only rounding separates its 16-row GEMMs from the verify's 80-row
    ones, which flips an argmax where random weights leave near-ties."""
    engine, sched, reqs, steps, wall, launches, calls, secs = spec_run(
        seed, 0, SPEC_REQUESTS)
    n, nd, k = engine.model.config.n_layer, engine.draft_layers, SPEC_K
    want = {"flash_decode_paged": n * (calls["decode"] + calls["suffix"])
            + n * (k + 1) * calls["verify"] + nd * (k + 1) * calls["draft"],
            "flash_fwd": n * calls["prefill"] + nd * calls["draft_prefill"],
            "flash_decode": 0}
    for name, w in want.items():
        if launches[name] != w:
            raise AssertionError(
                f"{name} launched {launches[name]} times in the spec phase; "
                f"want {w} (calls {calls})")
    if not calls["verify"]:
        raise AssertionError("no speculative round ran")
    sp = sched.stats()["spec"]
    if sp["emitted"] != sp["accepted"] + sp["corrected"]:
        raise AssertionError(f"spec fold identity broken: {sp}")
    exact, ties = check_requests(reqs, engine)
    graphs = check_graphs(
        engine, [f"{p}_{b}" for p in ("prefill", "draft_prefill")
                 for b in SERVE_BUCKETS]
        + ["decode", "kv_copy", "suffix", "draft", "verify"])
    rounds = calls["verify"]
    stats = {
        "card": card, "requests": len(reqs), "steps": steps, "wall_s": wall,
        "graphs": graphs,
        "k": k, "draft_layers": nd, "calls": calls, "spec": sp,
        "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
        "ttft_p50_ms": ttft_ms(reqs),
        "round_ms": (secs["draft"] + secs["verify"]) / rounds * 1e3,
        "draft_ms": per_call_ms(secs, calls, "draft"),
        "verify_ms": per_call_ms(secs, calls, "verify"),
        "parity_exact": exact, "parity_near_ties": ties,
    }
    log(f"  spec (k={k}, draft {nd} of {n} layers): {len(reqs)} requests in "
        f"{steps} steps, {wall:.3f} s; calls {calls}; launches {launches}; "
        f"parity {exact} exact, {ties} near-ties")
    log(f"  [{card}] spec: acceptance {sp['acceptance_rate']}, "
        f"{sp['tokens_per_target_forward']} tokens per target forward, "
        f"round {stats['round_ms']:.3f} ms (draft {stats['draft_ms']:.3f}, "
        f"verify {stats['verify_ms']:.3f}), TTFT p50 "
        f"{stats['ttft_p50_ms']:.2f} ms, {stats['tokens_per_s']:.1f} "
        f"tokens/s")
    S = engine.slots
    toks, pos = np.ones(S, np.int32), np.full(S, 512, np.int32)

    def spec_round():
        engine.verify(toks, pos, engine.draft(toks, pos))

    stats["profile_round"] = profile_fn("spec_round", spec_round, 5)
    del engine, sched, reqs
    free_cuda()

    # 1 + 6 (k+1) tokens: the first from the prefill, then six whole
    # rounds, so no round is cut short by max_new (a cut round counts
    # its unemitted drafts as not accepted)
    clone_tokens = 1 + 6 * (k + 1)
    engine, sched, reqs, _, wall, _, _, _ = spec_run(
        seed, n, SPEC_REQUESTS, clone_tokens)
    clone = sched.stats()["spec"]
    check_requests(reqs, engine, clone_tokens)
    log(f"  spec full-clone draft ({n} layers): acceptance "
        f"{clone['acceptance_rate']}, {clone['tokens_per_target_forward']} "
        f"tokens per target forward, {len(reqs)} requests in {wall:.3f} s")
    if not clone["acceptance_rate"] >= 0.9:
        raise AssertionError(f"full-clone draft acceptance {clone}")
    stats["full_clone"] = clone
    log("spec " + json.dumps(stats))
    del engine, sched, reqs
    free_cuda()
    return {"launches": launches, "stats": stats}


# -- phase 15: the serving front door ----------------------------------------


def server_phase(seed: int, card: str) -> dict:
    """gpt2-small at full width behind ``Server(num_workers=1)``: one
    serve actor on the card, its engine's programs captured at setup;
    phase 3's 16 requests from two tenants through ``submit``.  Every
    request completes with 32 tokens; in the worker flash_fwd launched
    12 x its prefills and flash_decode 12 x its decode steps (counted
    from the end of its setup) and nothing was captured after setup.
    Returns the tokens (held against phase 3's by the caller), the
    launches and the figures: TTFT p50, the pump's step ms, the engine's
    decode ms in the worker, tokens/s, ``start()``'s seconds by part,
    the captures' ms and pool bytes."""
    module = GPTLightningModule("gpt2-small")
    cfg = module.config
    t0 = time.monotonic()
    server = Server(module, num_workers=1, buckets=SERVE_BUCKETS,
                    max_batch_slots=SERVE_SLOTS, max_new_tokens=NEW_TOKENS,
                    seed=seed).start()
    try:
        start_s = time.monotonic() - t0
        setup = server.stats()["workers"][0]
        rng = np.random.default_rng(seed)
        t0 = time.monotonic()
        reqs = [server.submit(rng.integers(0, cfg.vocab_size, n),
                              tenant=("alice", "bob")[i % 2])
                for i, n in enumerate(PROMPT_LENS)]
        tokens = [r.result(600).tolist() for r in reqs]
        wall = time.monotonic() - t0
        server.drain()
        st = server.stats()
    finally:
        server.shutdown()
    w = st["workers"][0]
    n = cfg.n_layer
    launches = {k: w["kernel_launches"][k] - setup["kernel_launches"][k]
                for k in ServeEngine.KERNELS}
    calls = {k: w["calls"][k] - setup["calls"][k] for k in w["calls"]}
    want = {"flash_fwd": n * calls["prefill"],
            "flash_decode": n * calls["decode"], "flash_decode_paged": 0}
    if launches != want or not calls["prefill"] or not calls["decode"]:
        raise AssertionError(f"server phase: worker launches {launches}, "
                             f"{n} layers x steps want {want}")
    if any(w["recaptures"].values()) or not w["captures"]:
        raise AssertionError(f"server phase: captures {w['captures']}, "
                             f"recaptures {w['recaptures']}")
    if not all(len(t) == NEW_TOKENS and 0 <= min(t)
               and max(t) < cfg.vocab_size for t in tokens):
        raise AssertionError("server phase: bad tokens")
    pump = st["pump"]
    stats = {
        "card": card, "requests": len(reqs), "wall_s": wall,
        "start_s": start_s, "start": st["start"],
        "setup_s": st["setup"][0]["setup_s"],
        "ttft_p50_ms": ttft_ms(reqs),
        "pump_step_ms": pump["step_s"] / pump["steps"] * 1e3,
        "pump_steps": pump["steps"],
        "decode_step_ms": w["seconds"]["decode"] / w["calls"]["decode"] * 1e3,
        "prefill_ms": w["seconds"]["prefill"] / w["calls"]["prefill"] * 1e3,
        "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
        "calls": calls, "captures": w["captures"],
        "capture_ms": w["capture_ms"], "pool_bytes": w["pool_bytes"],
    }
    log(f"  server: {len(reqs)} requests in {pump['steps']} pump steps, "
        f"{wall:.3f} s; worker calls {calls}; launches {launches} (= {n} x "
        f"steps); recaptures {w['recaptures']}")
    log(f"  [{card}] server: start {start_s:.2f} s (spawn "
        f"{st['start']['spawn_s']:.2f}, setup {st['start']['setup_s']:.2f} "
        f"of which captures {st['start']['capture_s']:.2f}); TTFT p50 "
        f"{stats['ttft_p50_ms']:.2f} ms, pump step "
        f"{stats['pump_step_ms']:.3f} ms, engine decode "
        f"{stats['decode_step_ms']:.3f} ms, prefill "
        f"{stats['prefill_ms']:.3f} ms, {stats['tokens_per_s']:.1f} "
        f"tokens/s; captures {w['capture_ms']:.1f} ms, pool "
        f"{w['pool_bytes'] / 2 ** 20:.1f} MB")
    log("server " + json.dumps(stats))
    return {"launches": launches, "tokens": tokens, "stats": stats}


def check_same_tokens(got: list, want: list) -> None:
    """Phase 15's tokens against phase 3's, request by request."""
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if bad or len(got) != len(want):
        raise AssertionError(f"server phase: requests {bad} differ from "
                             f"the in-process serve phase's tokens")
    log(f"  server tokens equal the in-process serve phase's "
        f"({len(got)} requests)")


# -- phase 16: the fleet -------------------------------------------------------

#: benchmarks/bench_fleet.py ``record_trace``'s shape (read, not imported)
#: at gpt2-small width: 64 requests, alice and bob behind their shared
#: 256-token system prompts, carol cold with a 256-token prompt of her
#: own, suffixes of 3-8 tokens, arrivals front-loaded (Beta(1.2, 2.0)
#: over 0.8 s); the ``groups=`` shape for the federation leg
FLEET_REQUESTS = 64
FLEET_DURATION_S = 0.8
FLEET_GROUPS = 8
#: the chaos leg's bounded retries (``RLT_PEER_RETRIES``)
FLEET_RETRIES = 2
#: the most one replay or one fleet event may take
FLEET_WAIT_S = 300.0


def fleet_trace(seed: int, vocab: int, groups: "int | None" = None) -> list:
    """``(at_s, tenant, prompt)`` records of the phase's traffic, sorted
    by arrival (module constants)."""
    rng = np.random.default_rng(seed)
    out = []
    if groups is not None:
        shared = {f"g{i}": rng.integers(0, vocab, SYSTEM_PREFIX)
                  for i in range(groups)}
        for i in range(FLEET_REQUESTS):
            tenant = f"g{i % groups}"
            suffix = rng.integers(0, vocab, int(rng.integers(3, 9)))
            at = (i + float(rng.uniform(0, 0.5))) * FLEET_DURATION_S \
                / FLEET_REQUESTS
            out.append((at, tenant, np.concatenate([shared[tenant],
                                                    suffix])))
    else:
        shared = {t: rng.integers(0, vocab, SYSTEM_PREFIX)
                  for t in ("alice", "bob")}
        tenants = ("alice", "bob", "carol")
        for i in range(FLEET_REQUESTS):
            tenant = tenants[i % 3]
            suffix = rng.integers(0, vocab, int(rng.integers(3, 9)))
            head = shared.get(tenant)
            if head is None:
                head = rng.integers(0, vocab, SYSTEM_PREFIX)
            out.append((float(rng.beta(1.2, 2.0)) * FLEET_DURATION_S,
                        tenant, np.concatenate([head, suffix])))
    return sorted(out, key=lambda r: r[0])


def replay(endpoint, trace: list, multiplier: float,
           scramble: bool = False) -> dict:
    """Submit ``trace`` to a ``Server`` or ``FleetServer`` at its arrival
    times compressed ``multiplier``-fold, wait for every request; the
    leg's tokens/s, TTFT p50/p99 (ms) and the handles.  ``scramble``
    gives every request a tenant of its own."""
    t0 = time.monotonic()
    handles = []
    for i, (at, tenant, prompt) in enumerate(trace):
        delay = t0 + at / multiplier - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        handles.append(endpoint.submit(
            prompt, tenant=f"{tenant}~{i}" if scramble else tenant,
            max_new_tokens=NEW_TOKENS))
    errors = []
    for h in handles:
        try:
            h.result(FLEET_WAIT_S)
        except TimeoutError:
            raise
        except Exception as e:      # noqa: BLE001 - each leg checks them
            errors.append(e)
    wall = time.monotonic() - t0
    ttft = np.asarray([h.ttft_s for h in handles if h.ttft_s is not None])
    done = [h for h in handles if h.error is None]
    return {"handles": handles, "errors": errors, "wall_s": wall,
            "tokens_per_s": sum(len(h.result(0)) for h in done) / wall,
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3}


def leg_line(name: str, leg: dict) -> str:
    return (f"{name}: {leg['tokens_per_s']:.1f} tokens/s, TTFT p50 "
            f"{leg['ttft_p50_ms']:.2f} ms, p99 {leg['ttft_p99_ms']:.2f} ms, "
            f"wall {leg['wall_s']:.3f} s")


class ReplicaStats:
    """Each replica's worker stats right after its start and just before
    its shutdown (a wrapper around the fleet's own replica factory), for
    the launches and captures of the phase."""

    def __init__(self):
        self.records: list = []

    def wrap(self, server) -> object:
        rec = {"setup": None, "final": None}
        self.records.append(rec)
        start, shutdown = server.start, server.shutdown

        def counted_start():
            out = start()
            rec["setup"] = server.stats()["workers"]
            return out

        def counted_shutdown(graceful: bool = True):
            if server._started and server._error is None:
                rec["final"] = server.stats()["workers"]
            shutdown(graceful=graceful)

        server.start, server.shutdown = counted_start, counted_shutdown
        return server

    def fleet(self, **kw) -> FleetServer:
        holder = {}
        fleet = FleetServer(
            GPTLightningModule("gpt2-small"),
            replica_factory=lambda rid: self.wrap(
                holder["fleet"]._default_factory(rid)), **kw)
        holder["fleet"] = fleet
        return fleet

    def launches(self) -> dict:
        """Launches while serving, summed over the replicas whose worker
        lived to its shutdown; raises on a capture after setup."""
        out = {k: 0 for k in ServeEngine.KERNELS}
        for rec in self.records:
            if rec["setup"] is None or rec["final"] is None:
                continue
            for w0, w in zip(rec["setup"], rec["final"]):
                if any(w["recaptures"].values()) or not w["captures"]:
                    raise AssertionError(
                        f"fleet phase: captures {w['captures']}, "
                        f"recaptures {w['recaptures']}")
                for k in out:
                    out[k] += (w["kernel_launches"][k]
                               - w0["kernel_launches"][k])
        return out

    def memory(self) -> list:
        """Each replica worker's device memory (allocated, reserved) and
        its graphs' pool as set up."""
        return [{k: w[k] for k in ("memory_allocated", "memory_reserved",
                                   "pool_bytes", "capture_ms")}
                for rec in self.records if rec["setup"]
                for w in rec["setup"]]


def same_or_tie(got: list, want: list, trace: list, what: str,
                ties: list) -> int:
    """Requests whose tokens equal the reference leg's; the rest go to
    ``ties`` for the near-tie check at the phase's end.  Returns the
    count of equal ones."""
    equal = 0
    for (_, _, prompt), a, b in zip(trace, got, want):
        if a == b:
            equal += 1
        else:
            ties.append((what, prompt, a, b))
    return equal


class EnginePaths:
    """The serving paths the fleet can give one request, replayed in
    process on one paged engine with the replicas' seeded weights (phase
    6's engine): a cold prefill and decode, a prefix reuse of its own
    whole pages, and the disaggregated pair (one token from a cold
    prefill, then the prompt and that token served as a reuse of the
    prompt's pages, or cold)."""

    def __init__(self, seed: int):
        self.pages = PageConfig(enabled=True, page_size=PAGE_SIZE)
        with decode_impl("paged"):
            self.engine = ServeEngine(
                GPTLightningModule("gpt2-small"), buckets=SERVE_BUCKETS,
                slots=SERVE_SLOTS, max_seq_len=1024, seed=seed,
                device="cuda", paged=self.pages).setup()

    def serve(self, prompts: list, n: int) -> list:
        """``prompts`` one after another on a fresh scheduler (so each
        may reuse the last one's pages); the last one's tokens."""
        sched = Scheduler(buckets=SERVE_BUCKETS, slots=SERVE_SLOTS,
                          max_seq_len=1024, paged=self.pages,
                          default_max_new_tokens=NEW_TOKENS)
        worker = ServeWorker(self.engine)
        for i, p in enumerate(prompts):
            req = sched.submit(p, max_new_tokens=n if i == len(prompts) - 1
                               else 1)
            while not sched.idle():
                sched.apply(plan := sched.plan(), worker.serve_step(plan))
        return req.result(0).tolist()

    def candidates(self, prompt, n: int, disagg: bool) -> dict:
        out = {"cold": self.serve([prompt], n),
               "reuse": self.serve([prompt, prompt], n)}
        if disagg:
            t1 = out["cold"][0]
            prompt2 = np.concatenate([prompt, [t1]])
            out["disagg"] = [t1] + self.serve([prompt, prompt2], n - 1)
            out["disagg_cold"] = [t1] + self.serve([prompt2], n - 1)
        return out


def check_ties(ties: list, seed: int, strict: bool = True) -> dict:
    """Each request whose tokens differ from the reference leg's (a), on
    the card with the engines' seeded weights and the plain-attention
    bf16 forward of ``check_parity``: the two streams are equal up to
    their first divergence, and there, teacher-forced over their shared
    prefix, the two tokens' reference logits lie within 2e-2 (a
    near-tie; after it each stream is its own greedy continuation).
    The logits are the fp32 product of the forward's final hidden state
    with the embedding: rounded to bf16 (the model's own output) they
    step by 0.0156 near 2.25, and two candidates a hair over one step
    apart would read as 0.0312.  A request past that bar passes only if
    its tokens are, bit for bit, those of one of the engine's own
    serving paths for it (``EnginePaths``: a reuse replays the suffix a
    token at a time where (a) prefilled it, and bf16 then orders two
    tokens ~0.03 apart differently); it is counted, with its gap.  Also
    counted, not held: the tokens of each stream past 2e-2 below the
    argmax of those logits, teacher-forced over the stream itself
    (``check_parity``'s rule; the reference leg's own cold path leaves
    such tokens too).  ``strict=False`` (the fp8 leg) counts the
    failures instead."""
    out = {"checked": len(ties), "failed": 0, "max_gap": 0.0,
           "engine_path": {}, "engine_path_gaps": [],
           "tokens_past_tol": 0, "tokens_past_tol_ref": 0}
    if not ties:
        return out
    module = GPTLightningModule("gpt2-small")
    model = module.configure_decode_model(device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    ref = GPT(dataclasses.replace(model.config, attention_impl="dot"),
              device="cuda")
    ref.load_state_dict(model.state_dict())
    ref.to(dtype=torch.bfloat16).eval()
    del model

    def logits(prompt, gen):
        seq = torch.tensor([[int(t) for t in prompt] + list(gen[:-1])],
                           device="cuda")
        with torch.inference_mode():
            x, _ = ref.hidden_with_kv(seq)
            x = x[0, len(prompt) - 1:].float()
            return x @ ref.wte.weight.float().t()

    def past_tol(prompt, gen) -> int:
        lg = logits(prompt, gen)
        return sum(int(lg[i].max() - lg[i, t] > BF16_TOL)
                   for i, t in enumerate(gen))

    far = []
    for what, prompt, got, want in ties:
        n = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        lg = logits(prompt, got[:n + 1])
        gap = abs(float(lg[n, got[n]] - lg[n, want[n]]))
        out["max_gap"] = max(out["max_gap"], gap)
        out["tokens_past_tol"] += past_tol(prompt, got)
        out["tokens_past_tol_ref"] += past_tol(prompt, want)
        if not torch.isfinite(lg).all() or gap > BF16_TOL:
            far.append((what, prompt, got, n, gap))
    del ref
    free_cuda()
    failed = []
    if far and strict:
        paths = EnginePaths(seed)
        for what, prompt, got, n, gap in far:
            cands = paths.candidates(prompt, len(got),
                                     what.startswith("(c)"))
            hit = next((k for k, v in cands.items() if v == got), None)
            if hit is None:
                failed.append(f"fleet {what} (prompt {len(prompt)}): "
                              f"diverges from (a) at step {n}, reference "
                              f"logits {gap:.4f} apart, and from every "
                              f"engine path ({sorted(cands)})")
            else:
                out["engine_path"][hit] = out["engine_path"].get(hit, 0) + 1
                out["engine_path_gaps"].append(gap)
        del paths
        free_cuda()
    elif far:
        failed = far
    out["failed"] = len(failed)
    if strict and failed:
        raise AssertionError(f"{len(failed)} of {len(ties)} requests "
                             f"differ from (a) past a near-tie and from "
                             f"the engine's paths: " + "; ".join(failed))
    return out


def fleet_phase(seed: int, card: str) -> dict:
    """Phase 16 (module docstring): legs (a)-(f) of the fleet with the
    driver off CUDA, then the near-tie checks on the card."""
    t_phase = time.monotonic()
    vocab = GPTLightningModule("gpt2-small").config.vocab_size
    trace = fleet_trace(seed, vocab)
    groups = fleet_trace(seed + 1, vocab, groups=FLEET_GROUPS)
    kw = dict(num_workers=1, buckets=SERVE_BUCKETS,
              max_batch_slots=SERVE_SLOTS, max_new_tokens=NEW_TOKENS,
              seed=seed)
    counts = ReplicaStats()
    ties, ties_fp8 = [], []
    out: dict = {"card": card, "leg_s": {}}
    marks = [time.monotonic()]

    def mark(leg: str) -> None:
        marks.append(time.monotonic())
        out["leg_s"][leg] = marks[-1] - marks[-2]

    def outputs(leg):
        return [h.result(0).tolist() for h in leg["handles"]]

    with scoped_env(RLT_DECODE_IMPL="paged",
                    RLT_PEER_RETRIES=str(FLEET_RETRIES),
                    RLT_PEER_BACKOFF_S="0.01", RLT_KVSHIP_TIMEOUT_S="0.05"):
        # (a) the reference: one Server, a plain (unpaged) engine
        t0 = time.monotonic()
        ref_server = counts.wrap(Server(GPTLightningModule("gpt2-small"),
                                        **kw)).start()
        out["ref_start_s"] = time.monotonic() - t0
        try:
            ref1 = replay(ref_server, trace, 1.0)
            ref2 = replay(ref_server, trace, 2.0)
            ref_groups = replay(ref_server, groups, 2.0)
        finally:
            ref_server.shutdown()
        want, want_groups = outputs(ref1), outputs(ref_groups)
        if outputs(ref2) != want:
            raise AssertionError("fleet (a): the 2x replay's tokens differ "
                                 "from the 1x replay's")
        log("  fleet (a) " + leg_line("1x", ref1) + "; "
            + leg_line("2x", ref2))
        out["a"] = {m: {k: v for k, v in leg.items()
                        if k not in ("handles", "errors")}
                    for m, leg in (("1x", ref1), ("2x", ref2))}
        mark("a")

        # (b) two pooled replicas, carol at a fleet-wide quota of 2;
        # (f) on the same fleet: a worker killed mid-replay
        t0 = time.monotonic()
        fleet = counts.fleet(replicas=2, autoscale=False,
                             tenant_quotas={"carol": 2}, **kw).start()
        out["b_start_s"] = time.monotonic() - t0
        try:
            peak = [0]
            stop = threading.Event()

            def watch_quota():
                while not stop.is_set():
                    with fleet._lock:
                        peak[0] = max(peak[0], fleet._tenant_inflight.get(
                            "carol", 0))
                    time.sleep(0.0005)

            watcher = threading.Thread(target=watch_quota, daemon=True)
            watcher.start()
            legs = {m: replay(fleet, trace, m) for m in (1.0, 2.0)}
            stop.set()
            watcher.join()
            if peak[0] > 2 or peak[0] < 1:
                raise AssertionError(f"fleet (b): carol peaked at {peak[0]} "
                                     f"in flight (quota 2)")
            pages = fleet.pages_stats()
            if not pages["prefix_hits"] > 0:
                raise AssertionError(f"fleet (b): no prefix hit: {pages}")
            out["b"] = {"pages": pages, "carol_peak": peak[0]}
            for m, leg in legs.items():
                if leg["errors"]:
                    raise AssertionError(f"fleet (b) {m}x: {leg['errors']}")
                equal = same_or_tie(outputs(leg), want, trace, f"(b) {m}x",
                                    ties)
                shares = {}
                for h in leg["handles"]:
                    shares[h.replica] = shares.get(h.replica, 0) + 1
                out["b"][f"{m:g}x"] = {
                    "tokens_per_s": leg["tokens_per_s"],
                    "ttft_p50_ms": leg["ttft_p50_ms"],
                    "ttft_p99_ms": leg["ttft_p99_ms"],
                    "equal": equal, "shares": shares}
                log(f"  fleet (b) " + leg_line(f"{m:g}x", leg)
                    + f"; {equal} of {len(trace)} equal to (a); replica "
                    f"shares {shares}")
            log(f"  fleet (b) reuse {pages['prefix_reuse_ratio']}, prefix "
                f"hits {pages['prefix_hits']}, carol peak {peak[0]}")
            mark("b")
            out["f"] = failover_leg(fleet, trace, want, ties)
        finally:
            fleet.shutdown(graceful=False)
        mark("f")

        # (c) disaggregated: a prefill and a decode replica, raw and fp8
        out["c"] = {}
        for codec in ("raw", "fp8"):
            out["c"][codec] = disagg_leg(counts, kw, trace, want, codec,
                                         ties if codec == "raw"
                                         else ties_fp8, vocab)
            mark(f"c_{codec}")

        # (d) federation over the groups trace: each group's first
        # request served alone (they land on replica 0 and retain there
        # as advertised donors), then the rest at 2x, stickiness
        # defeated (own tenants, no slack): a prefix held by the busier
        # replica is fetched, not routed to.  Raw on the wire, so a
        # fetched prefix is bit for bit the one prefilled, and the
        # tokens answer to (a)'s bar (fp8's are (c)'s to count)
        t0 = time.monotonic()
        fleet = counts.fleet(replicas=2, autoscale=False,
                             fleet={"prefix_fed": True, "sticky_slack": 0,
                                    "kvship_codec": "raw"}, **kw).start()
        try:
            first, rest, seen = [], [], set()
            for i, rec in enumerate(groups):
                (rest if rec[1] in seen else first).append(i)
                seen.add(rec[1])
            got = {}
            for i in first:
                got[i] = fleet.generate(groups[i][2], tenant=f"g~{i}",
                                        max_new_tokens=NEW_TOKENS,
                                        timeout=FLEET_WAIT_S).tolist()
            at0 = groups[rest[0]][0]
            leg = replay(fleet, [(groups[i][0] - at0,) + groups[i][1:]
                                 for i in rest], 2.0, scramble=True)
            got.update({i: h.result(0).tolist()
                        for i, h in zip(rest, leg["handles"])})
            fed = fleet.status()["fleet"]["federation"]
            pages = fleet.pages_stats()
        finally:
            fleet.shutdown()
        if leg["errors"] or not (fed["hits"] > 0 and fed["ships"] > 0) \
                or fed["failovers"]:
            raise AssertionError(f"fleet (d): {fed} {leg['errors']}")
        equal = same_or_tie([got[i] for i in range(len(groups))],
                            want_groups, groups, "(d)", ties)
        out["d"] = {"federation": fed, "pages": pages, "equal": equal,
                    "warm": len(first), "tokens_per_s": leg["tokens_per_s"],
                    "ttft_p50_ms": leg["ttft_p50_ms"],
                    "ttft_p99_ms": leg["ttft_p99_ms"],
                    "leg_s": time.monotonic() - t0}
        log(f"  fleet (d) {len(first)} warm, then " + leg_line("2x", leg)
            + f"; federation hits {fed['hits']}, ships {fed['ships']}, "
            f"fetches {fed['fetches']}, skipped {fed['skipped']}, wire "
            f"{fed['bytes_wire']} B; reuse {pages['prefix_reuse_ratio']}, "
            f"remote imports {pages.get('remote_imports')}, federated "
            f"reuse {pages.get('federated_reuse_ratio')}; {equal} of "
            f"{len(groups)} equal to (a)")

        mark("d")
        # (e) autoscale 1 -> 2 -> 1 under the trace at 4x
        out["e"] = autoscale_leg(counts, kw, trace, want, ties)
        mark("e")

    out["launches"] = counts.launches()
    out["replica_memory"] = counts.memory()
    out["phase_s"] = time.monotonic() - t_phase
    return {"out": out, "ties": ties, "ties_fp8": ties_fp8,
            "launches": out["launches"]}


def failover_leg(fleet, trace: list, want: list, ties: list) -> dict:
    """(f): the whole trace at once (so each replica holds a queue), and
    replica 0's worker killed once it holds admitted and queued
    requests: its queued ones complete on the survivor, its in-flight
    ones fail with ``FleetReplicaLost`` caused by the death, and the
    fleet grows back to two replicas."""
    victim = fleet._replicas[min(fleet._replicas)]
    pid = victim.server.stats()["workers"][0]["pid"]
    sched = victim.server.scheduler
    handles = [fleet.submit(p, tenant=t, max_new_tokens=NEW_TOKENS)
               for _, t, p in trace]
    t0 = time.monotonic()
    while not (sched.queued_count and sched.active_count):
        if time.monotonic() - t0 > FLEET_WAIT_S:
            raise AssertionError("fleet (f): the victim never held a queue")
        time.sleep(0.0005)
    held = (sched.active_count, sched.queued_count)
    os.kill(pid, signal.SIGKILL)
    lost, done = [], []
    for r, h, w in zip(trace, handles, want):
        try:
            done.append((r, h.result(FLEET_WAIT_S).tolist(), w))
        except TimeoutError:
            raise
        except Exception:       # noqa: BLE001 - checked below
            lost.append(h)
    for h in lost:
        cause = repr(h.error.__cause__)
        if not isinstance(h.error, FleetReplicaLost) or "died" not in cause:
            raise AssertionError(f"fleet (f): request {h.id} failed with "
                                 f"{h.error!r} (cause {cause})")
    event = fleet.failovers[0] if fleet.failovers else {}
    if not lost or not event.get("requeued") \
            or event["failed"] != len(lost):
        raise AssertionError(f"fleet (f): lost {len(lost)}, event {event}")
    equal = same_or_tie([d[1] for d in done], [d[2] for d in done],
                        [d[0] for d in done], "(f)", ties)
    t0 = time.monotonic()
    while sum(r.state == "serving" for r in fleet._replicas.values()) < 2:
        if time.monotonic() - t0 > FLEET_WAIT_S:
            raise AssertionError("fleet (f): no replacement replica")
        time.sleep(0.05)
    regrow_s = time.monotonic() - t0
    log(f"  fleet (f): killed replica {victim.id}'s worker holding "
        f"{held[0]} admitted and {held[1]} queued; requeued "
        f"{event['requeued']}, lost {len(lost)} (FleetReplicaLost, caused "
        f"by the death), {len(done)} completed ({equal} equal to (a)); "
        f"back to 2 replicas {regrow_s:.2f} s after the last request")
    return {"held": held, "requeued": event["requeued"], "lost": len(lost),
            "completed": len(done), "equal": equal, "regrow_s": regrow_s}


def disagg_leg(counts: ReplicaStats, kw: dict, trace: list, want: list,
               codec: str, ties: list, vocab: int) -> dict:
    """(c) for one codec: the trace at 2x over a prefill and a decode
    replica; with ``raw`` one more ship held bit for bit through
    ``export_kv`` on both sides, then the chaos leg."""
    fleet = counts.fleet(replicas=2, autoscale=False,
                         fleet={"roles": ("prefill", "decode"),
                                "kvship_codec": codec}, **kw).start()
    try:
        leg = replay(fleet, trace, 2.0)
        kv = dict(fleet.status()["fleet"]["kvship"])
        log_ = list(fleet.ship_log)
        if leg["errors"] or kv["failovers"] or not kv["ships"] \
                or kv["ships"] + kv["skipped"] != len(trace):
            raise AssertionError(f"fleet (c) {codec}: {kv} {leg['errors']}")
        equal = same_or_tie([h.result(0).tolist() for h in leg["handles"]],
                            want, trace, f"(c) {codec}", ties)
        res = {"kvship": kv, "equal": equal,
               "tokens_per_s": leg["tokens_per_s"],
               "ttft_p50_ms": leg["ttft_p50_ms"],
               "ttft_p99_ms": leg["ttft_p99_ms"]}
        by_bucket: dict = {}
        for rec in log_:
            if rec["status"] == "ok":
                by_bucket.setdefault(rec["bucket"], []).append(rec["ms"])
        res["ship_ms"] = {b: {"n": len(v), "p50": float(np.median(v)),
                              "max": float(max(v))}
                          for b, v in sorted(by_bucket.items())}
        if codec == "fp8" and not kv["compression_ratio"] >= 3.0:
            raise AssertionError(f"fleet (c) fp8: {kv}")
        log(f"  fleet (c) {codec} " + leg_line("2x", leg) + f"; ships "
            f"{kv['ships']}, skipped {kv['skipped']}, wire "
            f"{kv['bytes_wire']} B, raw {kv['bytes_raw']} B, ratio "
            f"{kv['compression_ratio']}, ship ms by bucket "
            f"{res['ship_ms']}; {equal} of {len(trace)} equal to (a)")
        if codec == "raw":
            res.update(raw_bits(fleet, vocab))
            fleet.arm_kvship_drop(1)
            at, tenant, prompt = trace[0]
            got = fleet.generate(prompt, tenant=tenant,
                                 max_new_tokens=NEW_TOKENS,
                                 timeout=FLEET_WAIT_S).tolist()
            kv2 = fleet.status()["fleet"]["kvship"]
            if kv2["failovers"] != 1 or kv2["retries"] != FLEET_RETRIES:
                raise AssertionError(f"fleet (c) chaos: {kv2}")
            same_or_tie([got], [want[0]], [trace[0]], "(c) chaos", ties)
            res["chaos"] = {"failovers": kv2["failovers"],
                            "retries": kv2["retries"],
                            "equal": got == want[0]}
            log(f"  fleet (c) chaos: failovers {kv2['failovers']}, retries "
                f"{kv2['retries']}, tokens equal to (a): {got == want[0]}")
    finally:
        fleet.shutdown()
    return res


def raw_bits(fleet, vocab: int) -> dict:
    """One more ship, then the donor rows on both sides through
    ``export_kv``: under ``raw`` the decode replica's rows equal the
    prefill replica's bit for bit over the shipped whole pages."""
    rng = np.random.default_rng(12345)
    prompt = rng.integers(0, vocab, SYSTEM_PREFIX + 5)
    n0 = fleet.kvship["ships"]
    fleet.generate(prompt, tenant="probe", max_new_tokens=NEW_TOKENS,
                   timeout=FLEET_WAIT_S)
    if fleet.kvship["ships"] != n0 + 1:
        raise AssertionError(f"fleet (c) raw: the probe did not ship: "
                             f"{fleet.kvship}")
    src, dst = (next(r for r in fleet._replicas.values() if r.role == role)
                for role in ("prefill", "decode"))
    a = src.server.export_kv(prompt)
    b = dst.server.export_kv(prompt)
    if a is None or b is None or a[2] != b[2]:
        raise AssertionError("fleet (c) raw: a side lost the probe's donor")
    n = a[2]
    for x, y in zip(a[:2], b[:2]):
        if not torch.equal(x[:, :, :n], y[:, :, :n]):
            raise AssertionError("fleet (c) raw: installed rows differ from "
                                 "the exported ones")
    log(f"  fleet (c) raw: the decode replica's {n} rows equal the prefill "
        f"replica's bit for bit ({a[0].dtype})")
    return {"bitwise_rows": n}


def autoscale_leg(counts: ReplicaStats, kw: dict, trace: list, want: list,
                  ties: list) -> dict:
    """(e): one replica, bounds [1, 2], the trace at 4x: a grow during
    the burst, a shrink in the idle tail, no request lost."""
    fleet = counts.fleet(replicas=1, fleet={
        "min_replicas": 1, "max_replicas": 2, "grow_queue_depth": 4.0,
        "patience_ticks": 1, "cooldown_s": 0.5, "tick_interval_s": 0.05},
        **kw).start()
    try:
        leg = replay(fleet, trace, 4.0)
        t0 = time.monotonic()
        while fleet.autoscaler.stats()["shrinks"] < 1 \
                or len(fleet._replicas) != 1:
            if time.monotonic() - t0 > FLEET_WAIT_S:
                raise AssertionError(f"fleet (e): no shrink: "
                                     f"{fleet.autoscaler.stats()}")
            time.sleep(0.05)
        st = fleet.autoscaler.stats()
        late = fleet.generate(trace[0][2], tenant=trace[0][1],
                              max_new_tokens=NEW_TOKENS,
                              timeout=FLEET_WAIT_S).tolist()
    finally:
        fleet.shutdown()
    if leg["errors"] or st["grows"] < 1 or fleet.failed:
        raise AssertionError(f"fleet (e): {st} {leg['errors']}")
    equal = same_or_tie([h.result(0).tolist() for h in leg["handles"]]
                        + [late], want + [want[0]], trace + [trace[0]],
                        "(e)", ties)
    events = [{k: e[k] for k in ("action", "reason", "seconds", "ok")}
              for e in st["events"]]
    log(f"  fleet (e) " + leg_line("4x", leg) + f"; events {events}; "
        f"{equal} equal")
    return {"events": events, "equal": equal,
            "tokens_per_s": leg["tokens_per_s"],
            "ttft_p50_ms": leg["ttft_p50_ms"],
            "ttft_p99_ms": leg["ttft_p99_ms"]}


def run_fleet_phase(seed: int, card: str) -> dict:
    """Phase 16 and its checks: the legs with the driver off CUDA (when
    it was off before), then the near-tie checks on the card."""
    cuda_before = torch.cuda.is_initialized()
    phase = fleet_phase(seed, card)
    if not cuda_before and torch.cuda.is_initialized():
        raise AssertionError("the driver initialised CUDA in the fleet phase")
    out = phase["out"]
    out["driver_off_cuda"] = not cuda_before
    out["ties"] = check_ties(phase["ties"], seed)
    out["ties_fp8"] = check_ties(phase["ties_fp8"], seed, strict=False)
    fp8 = out["c"]["fp8"]
    fp8["equal_share"] = fp8["equal"] / FLEET_REQUESTS
    t = out["ties"]
    log(f"  fleet near-ties: {t['checked']} requests differ from (a): "
        f"{t['checked'] - len(t['engine_path_gaps'])} at a near-tie "
        f"(<= {BF16_TOL}), {len(t['engine_path_gaps'])} past it (gaps "
        f"{[round(g, 4) for g in t['engine_path_gaps']]}) each bit for bit "
        f"an engine path {t['engine_path']}; largest gap "
        f"{t['max_gap']:.4f}; tokens past {BF16_TOL} below the reference "
        f"argmax: "
        f"{t['tokens_past_tol']} in theirs, {t['tokens_past_tol_ref']} in "
        f"(a)'s; fp8: {fp8['equal']} of {FLEET_REQUESTS} equal to (a), "
        f"{out['ties_fp8']['failed']} of {out['ties_fp8']['checked']} "
        f"others diverging past a near-tie (recorded, not fatal)")
    log(f"  [{card}] fleet: launches {phase['launches']}, replica memory "
        f"{out['replica_memory']}, phase {out['phase_s']:.1f} s")
    log("fleet " + json.dumps(out, default=str))
    return phase


# -- phase 8: long context ---------------------------------------------------

#: gpt2-1p3b at full width and depth (24 layers, 32 heads, n_embd 2048,
#: vocab 50304) at its block size T=2048, remat "full", chunked CE 16
BIG_B = 8
BIG_STEPS = 6
#: the long-context shapes of benchmarks/bench_longcontext.py:38-43:
#: gpt2-small width, block_size T, remat "full", chunked CE 16 at
#: T >= 8192, B = max(1, 8192 // T)
LONG_TS = (4096, 8192, 16384)
LONG_STEPS = 3
#: remat "full" against "off": the same kernels and GEMMs in the same
#: order, so the gradients should agree bit for bit
REMAT_TOL = 1e-6
#: a plain version's [B, heads, T, T] fp32 scores stay within this many
#: bytes: it runs over the heads in groups
PLAIN_SCORE_BYTES = 2 ** 30


def long_batch(T: int) -> int:
    return max(1, 8192 // T)


def long_module(T: int):
    cfg = dataclasses.replace(CONFIGS["gpt2-small"], block_size=T,
                              remat=True, chunked_ce=16 if T >= 8192 else 0)
    B = long_batch(T)
    return GPTLightningModule(cfg, batch_size=B, warmup_steps=2,
                              dataset_size=B * LONG_STEPS)


def attention_inputs(gen, B: int, T: int, heads: int, d: int = D):
    """q, k, v as the split views of a fused qkv projection, and dO."""
    c = heads * d
    qkv = torch.randn(B, T, 3 * c, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (x.view(B, T, heads, d) for x in qkv.split(c, dim=-1))
    do = torch.randn(B, T, heads, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    return q, k, v, do


def by_heads(plain, q, *rest, lse=None, causal: bool = True):
    """``plain`` over groups of heads (heads are independent), so its
    [B, g, T, T] fp32 scores stay within ``PLAIN_SCORE_BYTES``; outputs
    concatenated back over the heads (dim 2 of [B, T, H, D], dim 1 of an
    lse [B, H, T])."""
    B, T, heads, _ = q.shape
    g = max(1, min(heads, PLAIN_SCORE_BYTES // (B * T * T * 4)))
    parts = []
    for h in range(0, heads, g):
        args = [x[:, :, h:h + g] for x in (q, *rest)]
        if lse is not None:
            args.insert(4, lse[:, h:h + g])
        parts.append(plain(*args, causal=causal))
    return tuple(torch.cat([p[i] for p in parts],
                           dim=1 if t.dim() == 3 else 2)
                 for i, t in enumerate(parts[0]))


def bwd_bounds(B: int, T: int, heads: int, d: int, causal: bool) -> dict:
    """The bound of the whole backward and of each of its passes, each
    input read once and each output written once: the products of
    T(T+1)/2 d multiply-adds a head when causal, T^2 d when not, two
    flops each; five for the backward (s, dp, dv, dk, dq), four for the
    dk/dv pass, three for the dq pass."""
    c = heads * d
    tri = B * heads * 2 * d * T * ((T + 1) / 2 if causal else T)
    stat = B * heads * T * 4            # an fp32 [B, H, T] row statistic
    return {
        "bwd": bound(B * 8 * T * c * 2 + stat, 5 * tri),
        # o, dO in; delta out
        "delta": bound(B * 2 * T * c * 2 + stat, 0),
        # q, k, v, dO, lse, delta in; dk, dv out
        "dkdv": bound(B * 6 * T * c * 2 + 2 * stat, 4 * tri),
        # q, k, v, dO, lse, delta in; dq out
        "dq": bound(B * 5 * T * c * 2 + 2 * stat, 3 * tri),
        "tri_flops": tri,
    }


def bwd_pass_ms(q, k, v, o, lse, do, causal: bool,
                iters: int = 20) -> dict:
    """Device ms of each pass of ``flash_bwd`` (delta, dk/dv, dq), each
    launched alone through its own entry point (``flash_attention_bwd_
    passes``) and timed with CUDA events over ``iters`` launches; after
    one run of the three in order, so dk/dv and dq read a real delta.
    Empty where the package has no per-pass entry points (a tree from
    before them, run for an A/B comparison)."""
    passes_of = getattr(fa, "flash_attention_bwd_passes", None)
    if passes_of is None:
        return {}
    passes, _ = passes_of(q, k, v, o, lse, do, causal=causal)
    for fn in passes.values():
        fn()
    return {name: time_ms(fn, iters=iters, warmup=2)
            for name, fn in passes.items()}


def long_kernel_shape(gen, B: int, T: int, heads: int, causal: bool = True,
                      d: int = D) -> dict:
    """flash_fwd and flash_bwd at one shape, causal or not, bf16, on
    fused-qkv views: against the plain versions over all heads (in
    groups), timed beside them, the SDPA yardstick and their bounds; the
    backward's delta, dk/dv and dq passes timed alone with CUDA events."""
    shape = (f"B={B} T={T} H={heads} D={d} "
             f"{'causal' if causal else 'non-causal'} bf16")
    q, k, v, do = attention_inputs(gen, B, T, heads, d)
    c = heads * d
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    o_ref, lse_ref = by_heads(flash_attention_fwd_plain, q, k, v,
                              causal=causal)
    want = by_heads(flash_attention_bwd_plain, q, k, v, o, do, lse=lse,
                    causal=causal)
    torch.cuda.synchronize()
    fwd_err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    del o_ref, lse_ref
    names = ("dq", "dk", "dv")
    errs = {n: rel_l2(a, b) for n, a, b in zip(names, got, want)}
    abs_errs = {n: (a.float() - b.float()).abs().max().item()
                for n, a, b in zip(names, got, want)}
    bwd_abs = max(abs_errs.values())
    finite = (bool(torch.isfinite(o.float()).all())
              and all(bool(torch.isfinite(a.float()).all()) for a in got))
    del got, want
    log(f"  {shape}: flash_fwd max_abs_err {fwd_err:.3e} (tol {BF16_TOL}), "
        f"lse {lse_err:.3e} (tol {LSE_TOL}); flash_bwd relative L2 "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {BWD_TOL}), max abs {bwd_abs:.3e}; finite {finite}")
    check_close(f"flash_fwd {shape}", fwd_err, BF16_TOL)
    check_close(f"flash_fwd lse {shape}", lse_err, LSE_TOL)
    for n, e in errs.items():
        check_close(f"flash_bwd {n} {shape} (relative L2)", e, BWD_TOL)
    if not finite:
        raise AssertionError(f"{shape}: non-finite kernel output")

    fwd_ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal),
                     iters=10, warmup=2)
    fwd_plain_ms = time_ms(lambda: by_heads(flash_attention_fwd_plain,
                                            q, k, v, causal=causal),
                           iters=2, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), iters=10, warmup=2)
    bwd_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal),
                     iters=10, warmup=2)
    bwd_plain_ms = time_ms(lambda: by_heads(flash_attention_bwd_plain, q, k,
                                            v, o, do, lse=lse,
                                            causal=causal),
                           iters=2, warmup=1)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    gout = do.transpose(1, 2)
    bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), gout, retain_graph=True), iters=10, warmup=2)
    del out
    passes = bwd_pass_ms(q, k, v, o, lse, do, causal)

    # each input read once, each output written once (``bwd_bounds``)
    bb = bwd_bounds(B, T, heads, d, causal)
    fwd_b = bound(B * 4 * T * c * 2 + B * heads * T * 4,
                  2 * bb["tri_flops"])                    # q k v o; QK PV
    bwd_b, dkdv_b, dq_b = bb["bwd"], bb["dkdv"], bb["dq"]
    dkdv_ms = passes["dkdv"]
    dq_ms = passes["dq"]
    log(f"  {shape}: flash_fwd {fwd_ms:.4f} ms (plain {fwd_plain_ms:.4f}, "
        f"sdpa {fwd_lib_ms:.4f}, bound {fwd_b[0]:.5f} {fwd_b[1]}); "
        f"flash_bwd {bwd_ms:.4f} ms (plain {bwd_plain_ms:.4f}, sdpa "
        f"backward {bwd_lib_ms:.4f}, bound {bwd_b[0]:.5f} {bwd_b[1]}); "
        f"passes (CUDA events): delta {passes['delta']:.4f} (bound "
        f"{bb['delta'][0]:.5f}), dk/dv {dkdv_ms:.4f} (bound "
        f"{dkdv_b[0]:.5f}), dq {dq_ms:.4f} (bound {dq_b[0]:.5f})")

    def part(ms, plain_ms, lib_ms, b, err, tol, **extra):
        return dict(shape=shape, max_abs_err=err, tol=tol, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b[0],
                    bound_by=b[1], **extra)

    def bwd_part(ms, b, tensors, **extra):
        return part(ms, bwd_plain_ms, bwd_lib_ms, b,
                    max(abs_errs[n] for n in tensors), BWD_TOL,
                    err_metric="per-tensor relative L2 (tol applies)",
                    rel_l2=max(errs[n] for n in tensors), **extra)

    pass_extra = dict(plain_and_library_compute="dq, dk and dv together",
                      pass_ms_from="CUDA events over launches of the pass "
                                   "alone")
    return {
        "fwd": part(fwd_ms, fwd_plain_ms, fwd_lib_ms, fwd_b, fwd_err,
                    BF16_TOL, lse_max_abs_err=lse_err),
        "bwd": bwd_part(bwd_ms, bwd_b, names, passes_ms=passes),
        "dkdv": bwd_part(dkdv_ms, dkdv_b, ("dk", "dv"), **pass_extra),
        "dq": bwd_part(dq_ms, dq_b, ("dq",), **pass_extra),
    }


def long_kernel_entries(gen) -> "dict[int, dict]":
    """The ``kernels`` entries of TPU kernel rows 2, 3, 7, 8 and 9 at the
    long-context path's shapes: gpt2-1p3b's (B=8, T=2048, H=32), where
    the JAX package takes rows 3 + 9, and the long-context ones at
    gpt2-small width (H=12): T=4096 (B=2) and 8192 (B=1), rows 3 + 7 +
    8, and T=16384 (B=1), rows 2 + 7 + 8.  Each entry carries its first
    shape's numbers and every shape under ``by_shape``."""
    shapes = {2048: (BIG_B, 32)}
    shapes.update({T: (long_batch(T), H) for T in LONG_TS})
    res = {T: long_kernel_shape(gen, B, T, heads)
           for T, (B, heads) in shapes.items()}
    src = "ray_lightning_tpu/ops/flash_attention.py"
    rows = {3: ("flash_fwd", ":673", "fwd", (2048, 4096, 8192)),
            9: ("flash_bwd", ":753", "bwd", (2048,)),
            7: ("flash_bwd", ":465", "dkdv", LONG_TS),
            8: ("flash_bwd", ":511", "dq", LONG_TS),
            2: ("flash_fwd", ":349", "fwd", (16384,))}
    entries = {}
    for row, (name, line, key, ts) in rows.items():
        first = res[ts[0]][key]
        e = record(name, row, src + line, first["shape"],
                   first["max_abs_err"], first, tol=first["tol"])
        e.update({k: v for k, v in first.items() if k not in e})
        if key in ("dkdv", "dq"):
            e["pass"] = {"dkdv": "dk/dv", "dq": "dq"}[key]
        e["by_shape"] = {str(T): res[T][key] for T in ts}
        entries[row] = e
    return entries


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def big_fit(seed: int, card: str) -> dict:
    """gpt2-1p3b through ``Trainer.fit`` at full width and depth, B=8,
    T=2048: finite losses, the launch counts of remat, and the first
    batch's loss lower after the fit than at its first step (the
    trained model, evaluated on the batch it started from: each step's
    loss is on a new batch, whose spread is as large as six steps'
    progress).  One more step of the fit's own state is profiled."""
    module = GPTLightningModule("gpt2-1p3b", batch_size=BIG_B,
                                warmup_steps=2,
                                dataset_size=BIG_B * BIG_STEPS)
    cfg = module.config
    free_cuda()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.monotonic()
    trainer, clock = fit(module, BIG_STEPS, seed)
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    stats = fit_stats(module, clock, BIG_B, cfg.block_size, card, first=2)
    log(f"  gpt2-1p3b fit: {BIG_STEPS} steps in {wall:.2f} s (set-up "
        f"included), remat {module.model.remat_policy}; losses "
        + " ".join(f"{x:.4f}" for x in clock.losses))
    check_fit(clock, trainer, launches, cfg.n_layer, BIG_STEPS, "gpt2-1p3b")
    batch = first_batch(module)
    with torch.no_grad():
        after = float(module._loss(StepContext(module, training=False),
                                   batch))
    log(f"  launches {launches} (= 2 x {cfg.n_layer} x {BIG_STEPS} "
        f"flash_fwd, {cfg.n_layer} x {BIG_STEPS} flash_bwd); first batch "
        f"loss {clock.losses[0]:.4f} at step 1, {after:.4f} after the fit")
    if not after < clock.losses[0]:
        raise AssertionError(f"gpt2-1p3b: the first batch's loss did not "
                             f"fall ({clock.losses[0]} -> {after})")
    n_params = sum(p.numel() for p in module.model.parameters())
    stats.update(params=n_params, memory_before_fit_gb=base_gb,
                 first_batch_loss_after=after)
    log(f"  [{card}] gpt2-1p3b B={BIG_B} T={cfg.block_size}: step "
        f"{stats['step_ms_median']:.3f} ms (median of steps 3-{BIG_STEPS}, "
        f"host wall, synced), {stats['tokens_per_s']:.0f} tokens/s, MFU "
        f"{stats['mfu']:.4f} ({stats['model_flops_per_step'] / 1e12:.3f} "
        f"TFLOP a step), peak memory {stats['peak_memory_gb']:.2f} GB "
        f"({base_gb:.2f} GB held before the fit), {n_params / 1e9:.4f} B "
        f"params")

    def train_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch)

    stats["profile"] = profile_fn("train_step_gpt2_1p3b", train_step, 1)
    del trainer, module, batch, train_step
    free_cuda()
    return {"launches": launches, "stats": stats}


def remat_grad_parity(seed: int) -> dict:
    """A 2-layer cut of gpt2-1p3b at B=1, T=2048: one step's gradients
    with flash attention against ``attention_impl="dot"`` (both under
    remat "full"; per-tensor relative L2 within ``GRAD_TOL``), and remat
    "full" against "off" with flash (within ``REMAT_TOL``)."""
    def module(attention_impl="auto", remat=True):
        cfg = dataclasses.replace(CONFIGS["gpt2-1p3b"], n_layer=2,
                                  remat=remat,
                                  attention_impl=attention_impl)
        return GPTLightningModule(cfg, batch_size=1, dataset_size=1)

    batch = first_batch(module())
    g_flash = module_grads(module(), seed, batch)
    g_dot = module_grads(module("dot"), seed, batch)
    rel = grads_rel_l2(g_flash, g_dot)
    del g_dot
    g_off = module_grads(module(remat=False), seed, batch)
    rel_remat = grads_rel_l2(g_flash, g_off)
    identical = all(torch.equal(g_flash[k], g_off[k]) for k in g_off)
    del g_flash, g_off
    free_cuda()
    worst = max(rel.items(), key=lambda kv: kv[1])
    worst_remat = max(rel_remat.items(), key=lambda kv: kv[1])
    B, T = batch[0].shape
    log(f"  2-layer gpt2-1p3b B={B} T={T}: flash vs dot per-tensor "
        f"relative L2 max {worst[1]:.3e} ({worst[0]}), median "
        f"{float(np.median(list(rel.values()))):.3e} (tol {GRAD_TOL}); "
        f"remat full vs off max {worst_remat[1]:.3e} ({worst_remat[0]}; "
        f"tol {REMAT_TOL}), bit-identical {identical}")
    if not all(np.isfinite(v) and v <= GRAD_TOL for v in rel.values()):
        raise AssertionError(f"flash vs dot gradients: {worst}")
    if not all(np.isfinite(v) and v <= REMAT_TOL
               for v in rel_remat.values()):
        raise AssertionError(f"remat full vs off gradients: {worst_remat}")
    return {"grad_rel_l2_flash_vs_dot_max": worst[1],
            "grad_rel_l2_remat_vs_off_max": worst_remat[1],
            "remat_bit_identical": identical}


def long_fits(seed: int, card: str) -> dict:
    """The long-context fits: ``LONG_STEPS`` steps at each T of
    ``LONG_TS`` (finite losses, remat launch counts, step ms, peak
    memory); one more step of the T=16384 fit profiled."""
    out = {}
    for T in LONG_TS:
        module = long_module(T)
        B = long_batch(T)
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        trainer, clock = fit(module, LONG_STEPS, seed)
        launches = _kernels.launch_counts()
        check_fit(clock, trainer, launches, module.config.n_layer,
                  LONG_STEPS, f"T={T}")
        stats = fit_stats(module, clock, B, T, card, first=1)
        stats["launches"] = launches
        log(f"  [{card}] T={T} B={B} (gpt2-small width, remat "
            f"{module.model.remat_policy}, chunked CE "
            f"{module.config.chunked_ce}): losses "
            + " ".join(f"{x:.4f}" for x in clock.losses)
            + f"; step {stats['step_ms_median']:.3f} ms (median of steps "
            f"2-{LONG_STEPS}), {stats['tokens_per_s']:.0f} tokens/s, MFU "
            f"{stats['mfu']:.4f}, peak memory "
            f"{stats['peak_memory_gb']:.2f} GB; launches {launches}")
        if T == LONG_TS[-1]:
            batch = first_batch(module)

            def train_step():
                trainer.state, _ = trainer._train_step(trainer.state, batch)

            stats["profile"] = profile_fn(f"train_step_T{T}", train_step, 1)
            del batch, train_step
        out[T] = stats
        del trainer, module
    free_cuda()
    return out


def long_context_phase(seed: int, card: str) -> dict:
    """Phase 8 (the serve engines and the gpt2-small trainer already
    freed): the kernel entries of rows 2, 3, 7, 8 and 9, the gpt2-1p3b
    fit, the 2-layer gradient parity, the long-context fits.  Returns
    the entries (launches filled in from the fits) and the stats."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    entries = long_kernel_entries(gen)
    free_cuda()
    big = big_fit(seed, card)
    parity = remat_grad_parity(seed)
    longs = long_fits(seed, card)
    fwd = {T: longs[T]["launches"]["flash_fwd"] for T in LONG_TS}
    bwd = {T: longs[T]["launches"]["flash_bwd"] for T in LONG_TS}
    by_path = {
        3: {"gpt2-1p3b": big["launches"]["flash_fwd"],
            "T4096": fwd[4096], "T8192": fwd[8192]},
        9: {"gpt2-1p3b": big["launches"]["flash_bwd"]},
        7: {f"T{T}": bwd[T] for T in LONG_TS},
        8: {f"T{T}": bwd[T] for T in LONG_TS},
        2: {"T16384": fwd[16384]},
    }
    for row, e in entries.items():
        e["launches"] = sum(by_path[row].values())
        e["launches_by_path"] = by_path[row]
    stats = {"gpt2_1p3b": big["stats"], "grad_parity": parity,
             "long": {str(T): v for T, v in longs.items()}}
    log("longctx " + json.dumps(stats))
    return {"entries": [entries[r] for r in sorted(entries)],
            "stats": stats}


# -- phase 9: BERT and the folded routes ----------------------------------------

#: bert-base masked LM at benchmarks/bench_bert_zero1.py's shape (B=32,
#: max_len 512); the steps of each fit of this phase
BERT_B = 32
BERT_STEPS = 20
FINETUNE_STEPS = 10
FOLDED_STEPS = 5
#: RLT_FLASH_BLOCK_Q/K below T=512: the JAX package then runs bert-base on
#: rows 5, 15 and 16
OVERRIDE_BLOCK = 128
#: GPT-2 XL's published width (n_embd 1600, 25 heads of 64, vocab 50257
#: padded to 50304; Radford et al. 2019, the gpt2-xl config.json), its 48
#: layers cut to XL_LAYERS: the heads do not pack, so the JAX package
#: folds them (rows 5 + 10 at T=1024, rows 4 + 11 + 12 at T=2048)
XL_LAYERS = 4
XL_STEPS = 8
XL_BATCH = {1024: 8, 2048: 4}
FA_SRC = "ray_lightning_tpu/ops/flash_attention.py"
#: the folded rows' kernel shapes: name -> (B, T, H, D, causal, blocks).
#: GPT-2 XL's 25 heads of 64 do not pack, so the JAX package folds them:
#: T=1024 one block, T=2048 the triangular grid; bert-base under the
#: override; the tiny fits' shapes (h=2, d=32)
FOLDED_SHAPES = {
    "xl_T1024": (8, 1024, 25, 64, True, None),
    "xl_T2048": (4, 2048, 25, 64, True, None),
    "base_T512": (BERT_B, 512, 12, 64, False, OVERRIDE_BLOCK),
    "tiny_T64": (8, 64, 2, 32, False, None),
    "tiny_T1024": (8, 1024, 2, 32, True, None),
    "tiny_T2048": (8, 2048, 2, 32, True, None),
}
#: TPU kernel row -> (kernel, def line, part of the shape's result, the
#: shapes at which the JAX package runs it; the first is the entry's)
FOLDED_ROWS = {
    4: ("flash_fwd", ":149", "fwd", ("xl_T2048", "tiny_T2048")),
    5: ("flash_fwd", ":98", "fwd",
        ("xl_T1024", "base_T512", "tiny_T64", "tiny_T1024")),
    10: ("flash_bwd", ":1190", "bwd", ("xl_T1024", "tiny_T64",
                                       "tiny_T1024")),
    11: ("flash_bwd", ":1225", "dkdv", ("xl_T2048", "tiny_T2048")),
    12: ("flash_bwd", ":1269", "dq", ("xl_T2048", "tiny_T2048")),
    15: ("flash_bwd", ":994", "dkdv", ("base_T512",)),
    16: ("flash_bwd", ":1045", "dq", ("base_T512",)),
}


def folded_kernel_entries(gen) -> "tuple[dict[int, dict], dict]":
    """The ``kernels`` entries of TPU kernel rows 4, 5, 10, 11, 12, 15 and
    16, each at the shapes where the JAX package's dispatch
    (``tpu_rows``, asserted here) takes it; and the bert-base shape's
    result, which is also rows 1 and 6 non-causal (the default blocks)."""
    res = {}
    for name, (B, T, heads, d, causal, blk) in FOLDED_SHAPES.items():
        fwd_row, bwd_rows = tpu_rows(T, heads, d, causal, blk, blk)
        want = {r for r, (_, _, _, names) in FOLDED_ROWS.items()
                if name in names}
        if want != {fwd_row, *bwd_rows}:
            raise AssertionError(f"{name}: tpu_rows gives {fwd_row}, "
                                 f"{bwd_rows}; the table says {want}")
        res[name] = long_kernel_shape(gen, B, T, heads, causal, d)
        free_cuda()
    if tpu_rows(512, 12, 64, False) != (1, (6,)):
        raise AssertionError("bert-base by default: not rows 1 and 6")
    entries = {}
    for row, (kname, line, part, names) in FOLDED_ROWS.items():
        first = res[names[0]][part]
        e = record(kname, row, FA_SRC + line, first["shape"],
                   first["max_abs_err"], first, tol=first["tol"])
        e.update({k: v for k, v in first.items() if k not in e})
        if part in ("dkdv", "dq"):
            e["pass"] = {"dkdv": "dk/dv", "dq": "dq"}[part]
        e["by_shape"] = {n: res[n][part] for n in names}
        entries[row] = e
    return entries, res["base_T512"]


def path_run(path: str, module, steps: int, seed: int, T: int, causal: bool,
             card: str, first: int = 1) -> "tuple[dict, Trainer]":
    """``steps`` of ``Trainer.fit`` of ``module`` (remat off), launches
    counted from 0 at its start: finite losses, flash_fwd and flash_bwd
    each once per layer per step.  ``rows`` are the TPU kernel rows the
    JAX package takes at the shape (``tpu_rows``).  Returns the run's
    record and the trainer."""
    cfg = module.config
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    trainer, clock = fit(module, steps, seed)
    launches = _kernels.launch_counts()
    check_fit(clock, trainer, launches, cfg.n_layer, steps, path,
              remat=False)
    rows = tpu_rows(T, cfg.n_head, cfg.head_dim, causal)
    stats = fit_stats(module, clock, module.batch_size, T, card, first,
                      causal)
    log(f"  [{card}] {path}: B={module.batch_size} T={T} H={cfg.n_head} "
        f"D={cfg.head_dim} {'causal' if causal else 'non-causal'}, rows "
        f"{rows}; losses " + " ".join(f"{x:.4f}" for x in clock.losses)
        + f"; step {stats['step_ms_median']:.3f} ms; launches {launches}")
    return {"path": path, "rows": rows, "launches": launches,
            "stats": stats}, trainer


def bert_grad_parity(seed: int, tokens) -> dict:
    """One step's gradients of bert-base's masked-LM loss with flash
    attention against ``attention_impl="dot"``, on the same seeded
    weights, tokens and mask: per-tensor relative L2 within
    ``GRAD_TOL``."""
    mask = torch.rand(tokens.shape, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(
                          seed)) < 0.15

    def grads(impl):
        cfg = dataclasses.replace(BERT_CONFIGS["bert-base"],
                                  attention_impl=impl)
        module = BertMLMModule(cfg, batch_size=BERT_B)
        module.init_params(torch.Generator(device="cuda").manual_seed(seed))
        params = dict(module.model.named_parameters())
        loss = module._mlm_loss(StepContext(module, training=True), tokens,
                                mask=mask)
        return dict(zip(params, torch.autograd.grad(loss,
                                                    list(params.values()))))

    g_flash = grads("auto")
    g_dot = grads("dot")
    rel = grads_rel_l2(g_flash, g_dot)
    del g_flash, g_dot
    free_cuda()
    worst = sorted(rel.items(), key=lambda kv: -kv[1])
    log(f"  bert-base grad parity vs dot attention: per-tensor relative L2 "
        f"max {worst[0][1]:.3e} ({worst[0][0]}), median "
        f"{float(np.median(list(rel.values()))):.3e} (tol {GRAD_TOL}); "
        f"{int(mask.sum())} of {mask.numel()} positions masked")
    if not all(np.isfinite(v) and v <= GRAD_TOL for v in rel.values()):
        raise AssertionError(f"bert-base gradient parity: {worst[:4]}")
    return {"grad_rel_l2_max": worst[0][1], "grad_rel_l2_worst": worst[:4]}


def bert_runs(seed: int, card: str) -> "tuple[list, dict]":
    """bert-base at full width: the 20-step masked-LM fit (rows 1 + 6,
    non-causal), its profiled step and gradient parity; the 10-step
    fine-tune (rows 1 + 6).  The masked-LM fit's launches are counted a
    second time under the route ``RLT_FLASH_BLOCK_Q=K=128`` gives the JAX
    package (rows 5 + 15 + 16): the port reads no block size, so that
    override runs the very same launches."""
    T = BERT_CONFIGS["bert-base"].max_len
    mlm, trainer = path_run("bert_mlm", BertMLMModule(
        "bert-base", batch_size=BERT_B, train_size=BERT_B * BERT_STEPS),
        BERT_STEPS, seed, T, False, card, first=2)
    losses = mlm["stats"]["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bert-base MLM loss did not fall: "
                             f"{losses[0]} -> {losses[-1]}")
    module = trainer.lightning_module
    if any(p.dtype != torch.float32 for p in module.model.parameters()):
        raise AssertionError("bert-base params are not fp32-resident")
    stats = mlm["stats"]
    log(f"  [{card}] bert-base MLM B={BERT_B} T={T}: step "
        f"{stats['step_ms_median']:.3f} ms (median of steps 3-{BERT_STEPS}, "
        f"host wall, synced), {stats['tokens_per_s']:.0f} tokens/s, MFU "
        f"{stats['mfu']:.4f} ({stats['model_flops_per_step'] / 1e12:.3f} "
        f"TFLOP a step: 6 x (12 L C^2 + V C) x B T + 12 B L T^2 C), peak "
        f"memory {stats['peak_memory_gb']:.2f} GB")
    batch = first_batch(module)

    def train_step():
        trainer.state, _ = trainer._train_step(trainer.state, batch)

    stats["profile"] = profile_fn("train_step_bert_base", train_step, 2)
    del trainer, module, train_step
    free_cuda()
    stats["grad_parity"] = bert_grad_parity(seed, batch[0])
    del batch

    over = {"path": f"bert_mlm@block{OVERRIDE_BLOCK}",
            "rows": tpu_rows(T, 12, 64, False, OVERRIDE_BLOCK,
                             OVERRIDE_BLOCK),
            "launches": mlm["launches"], "stats": {}}
    tune, trainer = path_run("bert_finetune", BertLightningModule(
        "bert-base", batch_size=BERT_B, train_size=BERT_B * FINETUNE_STEPS),
        FINETUNE_STEPS, seed, T, False, card, first=2)
    acc = trainer.callback_metrics.get("train_accuracy")
    del trainer
    log(f"  bert-base fine-tune: train_accuracy {acc} (epoch mean)")
    if acc is None or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"fine-tune logged no accuracy: {acc}")
    tune["stats"]["train_accuracy"] = acc
    if (mlm["rows"], over["rows"], tune["rows"]) != (
            (1, (6,)), (5, (15, 16)), (1, (6,))):
        raise AssertionError("bert-base routes: "
                             f"{mlm['rows']}, {over['rows']}, {tune['rows']}")
    return [mlm, over, tune], stats


def folded_fits(seed: int, card: str) -> list:
    """The fits whose heads fold: GPT-2 XL's width cut to XL_LAYERS
    layers with block_size 1024 (B=8, rows 5 + 10 causal) and 2048 (B=4,
    rows 4 + 11 + 12), the folded rows' path at a public width; then the
    tiny fits (h=2, d=32), the D=32 kernels on a path: the tiny BERT
    (T=64, non-causal: rows 5 + 10) and the tiny GPT with block_size
    1024 and 2048, B=8.  The tiny fits' step times are the host's."""
    runs = []
    for T, B in XL_BATCH.items():
        cfg = dataclasses.replace(CONFIGS["gpt2-small"], n_layer=XL_LAYERS,
                                  n_head=25, n_embd=1600, block_size=T)
        runs.append(path_run(
            f"gpt_xl{XL_LAYERS}_T{T}", GPTLightningModule(
                cfg, batch_size=B, warmup_steps=2,
                dataset_size=B * XL_STEPS),
            XL_STEPS, seed, T, True, card, first=2)[0])
        free_cuda()
    runs.append(path_run("bert_tiny", BertMLMModule("tiny"), FOLDED_STEPS,
                         seed, 64, False, card)[0])
    for T in (1024, 2048):
        cfg = dataclasses.replace(CONFIGS["tiny"], block_size=T)
        runs.append(path_run(
            f"gpt_tiny_T{T}", GPTLightningModule(
                cfg, batch_size=8, warmup_steps=2,
                dataset_size=8 * FOLDED_STEPS),
            FOLDED_STEPS, seed, T, True, card)[0])
    want = [(5, (10,)), (4, (11, 12)), (5, (10,)), (5, (10,)),
            (4, (11, 12))]
    if [r["rows"] for r in runs] != want:
        raise AssertionError(f"folded routes: {[r['rows'] for r in runs]}")
    return runs


#: the gradient check at GPT-2 XL's width: layers and batch
XL_GRAD_LAYERS = 2
XL_GRAD_B = 2


def xl_grad_parity(seed: int) -> dict:
    """One step's gradients at GPT-2 XL's width (n_embd 1600, 25 heads of
    64), cut to ``XL_GRAD_LAYERS`` layers, at T=1024 (the JAX package's
    rows 5 + 10) and T=2048 (rows 4 + 11 + 12): flash attention against
    ``attention_impl="dot"`` on the same seeded weights and tokens,
    per-tensor relative L2 within ``GRAD_TOL``; the flash step launches
    flash_fwd and flash_bwd once per layer."""
    out = {}
    for T, rows in ((1024, (5, (10,))), (2048, (4, (11, 12)))):
        if tpu_rows(T, 25, 64, True) != rows:
            raise AssertionError(f"XL T={T}: not rows {rows}")

        def module(impl):
            cfg = dataclasses.replace(
                CONFIGS["gpt2-small"], n_layer=XL_GRAD_LAYERS, n_head=25,
                n_embd=1600, block_size=T, attention_impl=impl)
            return GPTLightningModule(cfg, batch_size=XL_GRAD_B,
                                      dataset_size=XL_GRAD_B)

        batch = first_batch(module("auto"))
        _kernels.reset_launches()
        g_flash = module_grads(module("auto"), seed, batch)
        launches = _kernels.launch_counts()
        g_dot = module_grads(module("dot"), seed, batch)
        rel = grads_rel_l2(g_flash, g_dot)
        del g_flash, g_dot, batch
        free_cuda()
        worst = max(rel.items(), key=lambda kv: kv[1])
        log(f"  {XL_GRAD_LAYERS}-layer GPT-2 XL width B={XL_GRAD_B} T={T} "
            f"(rows {rows}): flash vs dot per-tensor relative L2 max "
            f"{worst[1]:.3e} ({worst[0]}), median "
            f"{float(np.median(list(rel.values()))):.3e} (tol {GRAD_TOL}); "
            f"launches flash_fwd {launches['flash_fwd']}, flash_bwd "
            f"{launches['flash_bwd']}")
        if not all(np.isfinite(v) and v <= GRAD_TOL for v in rel.values()):
            raise AssertionError(f"XL T={T} flash vs dot gradients: {worst}")
        if (launches["flash_fwd"], launches["flash_bwd"]) != (
                XL_GRAD_LAYERS, XL_GRAD_LAYERS):
            raise AssertionError(f"XL T={T} gradient step launches: "
                                 f"{launches}")
        out[f"T{T}"] = {"rows": rows, "grad_rel_l2_max": worst[1],
                        "grad_rel_l2_worst": worst}
    return out


def folded_phase(seed: int, card: str) -> dict:
    """Phase 9 (everything earlier freed): the folded rows' kernel
    entries, the bert-base runs, the folded fits, the gradient check at
    GPT-2 XL's width (``xl_grad_parity``).  Returns the entries
    by row, the path runs (each with its rows and launches) and the
    bert-base shape's kernel result (rows 1 and 6 non-causal)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    entries, base = folded_kernel_entries(gen)
    runs, bert_stats = bert_runs(seed, card)
    runs += folded_fits(seed, card)
    free_cuda()
    xl_grads = xl_grad_parity(seed)
    log("bert " + json.dumps({
        "mlm": bert_stats, "xl_grad_parity": xl_grads,
        "runs": {r["path"]: {"rows": r["rows"], "launches": r["launches"],
                             **{k: v for k, v in r["stats"].items()
                                if k != "profile"}} for r in runs}}))
    return {"entries": entries, "runs": runs, "base": base}


# -- phase 10: the trainer: checkpoint and resume, predict, dropout -----------

#: phase 10's fits: 4 train batches and 2 validation batches an epoch, a
#: validation every 2 steps, clipping, the bf16 batch cast, a metrics row
#: a step, 2 predict batches
TRAINER_ARGS = dict(limit_train_batches=4, limit_val_batches=2,
                    val_check_interval=2, gradient_clip_val=1.0,
                    precision="bf16", log_every_n_steps=1,
                    limit_predict_batches=2)
TRAINER_STEPS = 4


class PhaseLog(Callback):
    """Per train step its loss; the validation batches run (the sanity
    check's included) and the global steps at which validations end."""

    def __init__(self):
        self.losses: "list[float]" = []
        self.val_batches = 0
        self.val_steps: "list[int]" = []

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self.losses.append(float(outputs["loss"]))

    def on_validation_batch_end(self, trainer, module, outputs, batch,
                                batch_idx):
        self.val_batches += 1

    def on_validation_end(self, trainer, module):
        if not trainer.sanity_checking:
            self.val_steps.append(trainer.global_step)


def trainer_run(root: str, seed: int, epochs: int, ckpt=None,
                restore_s: "list | None" = None) -> dict:
    """``GPTLightningModule("gpt2-small", batch_size=8)`` at full width
    through ``Trainer.fit`` with ``TRAINER_ARGS``, the default
    ``ModelCheckpoint``, an ``EarlyStopping`` on ``val_loss`` that does
    not trigger and the CSV logger, all under ``root``; from ``ckpt``
    when given (its restore timed into ``restore_s``).  Each kernel's
    launches are counted from 0 at the fit's start and checked: 12 a
    train step for both, 12 a validation batch for flash_fwd."""
    log_cb = PhaseLog()
    stop = EarlyStopping(monitor="val_loss", patience=100)
    trainer = Trainer(max_epochs=epochs, seed=seed, callbacks=[log_cb, stop],
                      default_root_dir=root, device="cuda", **TRAINER_ARGS)
    if restore_s is not None:
        restore = trainer._restore_checkpoint

        def timed(path, module):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore(path, module)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)

        trainer._restore_checkpoint = timed
    module = GPTLightningModule("gpt2-small", batch_size=TRAIN_B)
    _kernels.reset_launches()
    t0 = time.monotonic()
    trainer.fit(module, ckpt_path=ckpt)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _kernels.launch_counts()
    steps, layers = len(log_cb.losses), module.config.n_layer
    want = {"flash_fwd": layers * (steps + log_cb.val_batches),
            "flash_bwd": layers * steps}
    if any(launches[k] != w for k, w in want.items()) \
            or not np.isfinite(log_cb.losses).all():
        raise AssertionError(f"trainer run: launches {launches}, want "
                             f"{want}; losses {log_cb.losses}")
    if trainer.should_stop:
        raise AssertionError("EarlyStopping stopped the fit")
    return dict(trainer=trainer, module=module, log=log_cb, stop=stop,
                launches={k: launches[k] for k in want}, wall_s=wall)


def state_of(run: dict) -> dict:
    """Clones of the params, the fp32 master and both moments by name,
    and the counters, after a run."""
    trainer, module = run["trainer"], run["module"]
    opt = trainer.state.opt_state.state_dict()
    opt = opt.get("1", opt)                     # chain(clip, tx): tx's
    tensors = {f"param {k}": v.clone()
               for k, v in module.model.state_dict().items()}
    tensors.update({f"master {k}": v.clone()
                    for k, v in opt["master"].items()})
    for part in ("mu", "nu"):
        tensors.update({f"{part} {k}": v.clone()
                        for k, v in opt["inner"][part].items()})
    return dict(tensors=tensors, count=opt["inner"]["count"],
                step=trainer.state.step, global_step=trainer.global_step,
                current_epoch=trainer.current_epoch,
                early_stopping=(run["stop"].state_dict() if "stop" in run
                                else None))


def check_same_state(got: dict, want: dict, what: str) -> None:
    """Bit for bit on every tensor (``torch.equal``, dtypes too) and
    equal counters; the error names the tensors that differ."""
    diff = [k for k, w in want["tensors"].items()
            if got["tensors"][k].dtype != w.dtype
            or not torch.equal(got["tensors"][k], w)]
    counters = {k: (got[k], want[k]) for k in
                ("count", "step", "global_step", "current_epoch",
                 "early_stopping") if got[k] != want[k]}
    if diff or counters or set(got["tensors"]) != set(want["tensors"]):
        raise AssertionError(
            f"{what}: {len(diff)} of {len(want['tensors'])} tensors differ "
            f"(first {diff[:8]}), counters {counters}")
    log(f"  {what}: {len(want['tensors'])} tensors equal bit for bit, "
        f"count {got['count']}, global_step {got['global_step']}, "
        f"current_epoch {got['current_epoch']}")


def predict_parity(run: dict) -> dict:
    """``trainer.predict`` over 2 batches (forward only: flash_fwd 12 a
    batch, flash_bwd never): each argmax token passes the teacher-forced
    near-tie rule against the same weights with plain attention
    (``attention_impl="dot"``) on the same batch, at the package's bf16
    tolerance, atol = rtol = 2e-2: its reference logit within 2e-2 (1 +
    |argmax logit|) of the argmax's.  The logits are bf16 products, so
    one ulp at |logit| in [4, 8) is 0.03125: an absolute 2e-2 alone
    would refuse a one-ulp tie (ROADMAP.md F1: the JAX package's own dot
    and flash routes differ by 0.036 at this width)."""
    trainer, module = run["trainer"], run["module"]
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds = trainer.predict(module)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    n, layers = len(preds), module.config.n_layer
    if n != 2 or launches["flash_fwd"] != layers * n \
            or launches["flash_bwd"] != 0:
        raise AssertionError(f"predict: {n} batches, launches {launches}; "
                             f"want 2, flash_fwd {layers * n}, flash_bwd 0")
    ref = GPT(dataclasses.replace(module.config, attention_impl="dot"),
              device="cuda")
    ref.load_state_dict(module.model.state_dict())
    exact = ties = beyond = 0
    worst = 0.0
    for (x, _), pred in zip(module.predict_dataloader(), preds):
        if tuple(pred.shape) != (TRAIN_B, TRAIN_T):
            raise AssertionError(f"predict shape {tuple(pred.shape)}")
        with torch.inference_mode():
            logits = ref(x.to("cuda"))
        pred = pred.to("cuda")
        best = logits.max(dim=-1)
        got = logits.gather(-1, pred[..., None].long())[..., 0]
        gap = best.values - got
        allowed = BF16_TOL * (1 + best.values.abs())
        if not torch.isfinite(logits).all() or not bool((gap <= allowed)
                                                         .all()):
            i = int((gap - allowed).argmax())
            raise AssertionError(
                f"predict: a token {float(gap.flatten()[i]):.4f} below the "
                f"dot argmax {float(best.values.flatten()[i]):.4f} (allowed "
                f"{float(allowed.flatten()[i]):.4f})")
        hit = int((pred == best.indices).sum())
        exact += hit
        ties += pred.numel() - hit
        worst = max(worst, float(gap.max()))
        beyond += int((gap > BF16_TOL).sum())
        del logits
    log(f"  predict: {n} batches of [{TRAIN_B}, {TRAIN_T}] in {wall:.3f} s; "
        f"launches {launches}; tokens vs dot attention: {exact} exact, "
        f"{ties} near-ties (widest gap {worst:.4f}, {beyond} past an "
        f"absolute {BF16_TOL})")
    del ref
    return dict(launches=launches, exact=exact, near_ties=ties,
                widest_gap=worst, past_abs_tol=beyond, wall_s=wall)


class FixedInit(GPTLightningModule):
    """gpt2-small whose init ignores the trainer's seed (seed 0), so
    two trainer seeds differ in their dropout masks alone."""

    def init_params(self, generator):
        return super().init_params(
            torch.Generator(device=generator.device).manual_seed(0))


def dropout_run(seed: int) -> dict:
    """A 4-step fit at dropout 0.1 (no validation, checkpoint or log)."""
    log_cb = PhaseLog()
    trainer = Trainer(max_steps=TRAINER_STEPS, seed=seed, callbacks=[log_cb],
                      limit_val_batches=0, num_sanity_val_steps=0,
                      enable_checkpointing=False, logger=False,
                      device="cuda")
    module = FixedInit(dataclasses.replace(CONFIGS["gpt2-small"],
                                           dropout=0.1), batch_size=TRAIN_B)
    _kernels.reset_launches()
    trainer.fit(module)
    launches = _kernels.launch_counts()
    layers = module.config.n_layer
    if len(log_cb.losses) != TRAINER_STEPS \
            or not np.isfinite(log_cb.losses).all() \
            or launches["flash_fwd"] != layers * TRAINER_STEPS \
            or launches["flash_bwd"] != layers * TRAINER_STEPS:
        raise AssertionError(f"dropout fit: losses {log_cb.losses}, "
                             f"launches {launches}")
    return dict(trainer=trainer, module=module, log=log_cb,
                launches=launches)


def trainer_phase(seed: int, card: str) -> dict:
    """Phase 10 (module docstring): (a) two uninterrupted 2-epoch fits
    equal bit for bit; (b) a 1-epoch fit, ``save_checkpoint``, a resume
    with ``max_epochs=2`` equal to (a) bit for bit; (c) predict parity;
    (d) dropout fits, the same seed equal, another seed not."""
    base = tempfile.mkdtemp(prefix="rlt_trainer_phase_")
    launches = {"flash_fwd": 0, "flash_bwd": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    try:
        log(f"  disk free under {base}: "
            f"{shutil.disk_usage(base).free / 1e9:.1f} GB")
        # (a) determinism control
        whole = []
        for i in range(2):
            root = os.path.join(base, f"whole{i}")
            run = trainer_run(root, seed, 2)
            add(run["launches"])
            whole.append(dict(state=state_of(run), losses=run["log"].losses,
                              val_steps=run["log"].val_steps,
                              files=sorted(os.listdir(os.path.join(
                                  root, "checkpoints")))))
            log(f"  (a) fit {i}: {len(run['log'].losses)} steps in "
                f"{run['wall_s']:.2f} s (set-up, validations and "
                f"checkpoints included); validations at steps "
                f"{run['log'].val_steps}; checkpoints {whole[-1]['files']}")
            del run
            shutil.rmtree(root)
            free_cuda()
        check_same_state(whole[1]["state"], whole[0]["state"],
                         "(a) two uninterrupted fits")
        if whole[0]["losses"] != whole[1]["losses"]:
            raise AssertionError("(a): the two fits' losses differ")

        # (b) fit 1 epoch, save_checkpoint, resume with max_epochs=2
        root = os.path.join(base, "half")
        run = trainer_run(root, seed, 1)
        add(run["launches"])
        best = run["trainer"].checkpoint_callback.best_model_path
        if not os.path.exists(best):
            raise AssertionError(f"(b): best_model_path {best!r} missing")
        with open(os.path.join(root, "logs", "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        want_rows = (len(run["log"].losses) + 1 + len(run["log"].val_steps))
        step_rows = sorted(int(r["step"]) for r in rows if r.get("loss"))
        if len(rows) != want_rows \
                or step_rows != list(range(1, TRAINER_STEPS + 1)):
            raise AssertionError(f"(b): metrics.csv has {len(rows)} rows, "
                                 f"want {want_rows}; loss rows at steps "
                                 f"{step_rows}")
        path = os.path.join(base, "resume.ckpt")
        state = run["trainer"].state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run["trainer"].save_checkpoint(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        opt = state.opt_state.state_dict()["1"]
        tensor_bytes = sum(
            t.numel() * t.element_size() for t in
            [*run["module"].model.state_dict().values(),
             *opt["master"].values(), *opt["inner"]["mu"].values(),
             *opt["inner"]["nu"].values()])
        n_params = sum(p.numel() for p in run["module"].model.parameters())
        log(f"  (b) fit 1 epoch: {len(run['log'].losses)} steps; "
            f"best_model_path {os.path.basename(best)}; metrics.csv "
            f"{len(rows)} rows")
        del run, state, opt
        shutil.rmtree(root)
        free_cuda()
        restore_s = []
        resumed = trainer_run(os.path.join(base, "resumed"), seed, 2,
                              ckpt=path, restore_s=restore_s)
        add(resumed["launches"])
        check_same_state(state_of(resumed), whole[0]["state"],
                         "(b) resumed vs uninterrupted")
        if resumed["log"].losses != whole[0]["losses"][TRAINER_STEPS:]:
            raise AssertionError(
                f"(b): resumed losses {resumed['log'].losses} vs "
                f"{whole[0]['losses'][TRAINER_STEPS:]}")
        log(f"  [{card}] checkpoint {nbytes} bytes ({nbytes / 1e9:.4f} GB; "
            f"tensors {tensor_bytes} bytes: {n_params} params in bf16, the "
            f"fp32 master, bf16 mu, fp32 nu); save_checkpoint "
            f"{save_s:.3f} s, restore {restore_s[0]:.3f} s (synced)")

        # (c) predict on the resumed weights
        pred = predict_parity(resumed)
        add(pred["launches"])
        del resumed
        free_cuda()

        # (d) dropout
        runs = []
        for s in (seed, seed, seed + 1):
            run = dropout_run(s)
            add(run["launches"])
            runs.append(dict(state=state_of(run), losses=run["log"].losses))
            del run
            free_cuda()
        check_same_state(runs[1]["state"], runs[0]["state"],
                         "(d) dropout 0.1, the same seed")
        if runs[0]["losses"] != runs[1]["losses"]:
            raise AssertionError("(d): the same seed's losses differ")
        other = [k for k, v in runs[0]["state"]["tensors"].items()
                 if not torch.equal(v, runs[2]["state"]["tensors"][k])]
        if not other or runs[2]["losses"][0] == runs[0]["losses"][0]:
            raise AssertionError("(d): another seed drew the same masks")
        log(f"  (d) dropout 0.1: losses seed {seed} {runs[0]['losses']}, "
            f"seed {seed + 1} {runs[2]['losses']}; {len(other)} tensors "
            f"differ across seeds")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    stats = {"card": card, "checkpoint_bytes": nbytes,
             "checkpoint_tensor_bytes": tensor_bytes, "params": n_params,
             "save_checkpoint_s": save_s, "restore_s": restore_s[0],
             "losses": whole[0]["losses"],
             "val_steps": whole[0]["val_steps"],
             "checkpoints": whole[0]["files"],
             "predict_exact": pred["exact"],
             "predict_near_ties": pred["near_ties"],
             "predict_widest_gap": pred["widest_gap"],
             "predict_past_abs_tol": pred["past_abs_tol"],
             "predict_s": pred["wall_s"],
             "dropout_losses": [r["losses"] for r in runs],
             "launches": launches}
    log("trainer " + json.dumps(stats))
    return {"launches": launches, "stats": stats}


# -- phase 11: plugins ----------------------------------------------------------

#: phase 11's fits: a validation of one batch at the end, no sanity pass,
#: a metrics row a step, the default ModelCheckpoint
PLUGIN_ARGS = dict(limit_val_batches=1, num_sanity_val_steps=0,
                   log_every_n_steps=1)
PLUGIN_GPT_STEPS = 8
PLUGIN_BERT_STEPS = 10
#: the in-process resume of the ZeRO-1 checkpoint runs this many more steps
PLUGIN_RESUME_STEPS = 2
#: each plugin run's bound (``RayPlugin(timeout_s=...)``)
PLUGIN_TIMEOUT_S = 600
#: the reports of ``PluginProbe``, filled on the driver (the workers'
#: queue items call ``record_probe`` there)
PROBES: list = []


def record_probe(report: dict) -> None:
    PROBES.append(report)


class PluginProbe(Callback):
    """In the fit's process, worker or driver: each kernel's launches
    counted from 0 at the fit's start, each step's synced wall time, the
    validation batches and the wall clock at the end of the first step;
    at the fit's end the report goes to ``record_probe`` on the driver
    (through ``session.put_queue`` from a worker).  Module level, and
    referred to as ``chip_smoke.PluginProbe``, so a worker can import it:
    the payload is pickled by import path."""

    def _sync(self, trainer) -> None:
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    def on_fit_start(self, trainer, module):
        _kernels.reset_launches()
        self.step_ms, self.val_batches, self.first_step_at = [], 0, None
        if trainer.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(trainer.device)

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        self._sync(trainer)
        self.t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self._sync(trainer)
        self.step_ms.append((time.perf_counter() - self.t0) * 1e3)
        if self.first_step_at is None:
            self.first_step_at = time.time()

    def on_validation_batch_end(self, trainer, module, outputs, batch,
                                batch_idx):
        self.val_batches += 1

    def on_fit_end(self, trainer, module):
        report = {"launches": _kernels.launch_counts(),
                  "rank": trainer.global_rank,
                  "step_ms": self.step_ms, "val_batches": self.val_batches,
                  "first_step_at": self.first_step_at,
                  "device": str(trainer.device),
                  "world_size": trainer.world_size,
                  "peak_bytes": (torch.cuda.max_memory_allocated(
                      trainer.device) if trainer.device.type == "cuda"
                      else None)}
        if trainer.plugin.remote:
            from ray_lightning_tpu_torch import session
            session.put_queue(functools.partial(record_probe, report))
        else:
            record_probe(report)


def plugin_fit(this, plugin, module, steps: int, seed: int, root: str,
               ckpt: "str | None" = None, callbacks=(), ranks: int = 1
               ) -> dict:
    """``steps`` of ``Trainer.fit`` under ``plugin`` (``None``: in this
    process, on the card) with ``this.PluginProbe`` (and ``callbacks``
    after it); the trainer, the module, the probe's report (the first of
    the ``ranks`` reports: ``reports``) and the fit's wall seconds."""
    kw = (dict(plugins=[plugin]) if plugin is not None
          else dict(device="cuda"))
    trainer = Trainer(max_steps=steps, seed=seed,
                      callbacks=[this.PluginProbe(), *callbacks],
                      default_root_dir=root, **PLUGIN_ARGS, **kw)
    this.PROBES.clear()
    t0 = time.time()
    trainer.fit(module, ckpt_path=ckpt)
    wall = time.time() - t0
    if len(this.PROBES) != ranks:
        raise AssertionError(f"{len(this.PROBES)} probe reports, want "
                             f"{ranks}")
    reports = list(this.PROBES)
    this.PROBES.clear()
    return dict(trainer=trainer, module=module, report=reports[0],
                reports=reports, t0=t0, wall_s=wall)


def check_probe(run: dict, layers: int, steps: int, what: str) -> dict:
    """The fit ran ``steps`` steps on the card, each kernel launched 12 a
    step (12 a validation batch more for flash_fwd), counted where the
    fit ran."""
    rep = run["report"]
    want = {"flash_fwd": layers * (steps + rep["val_batches"]),
            "flash_bwd": layers * steps}
    got = {k: rep["launches"][k] for k in want}
    if got != want or len(rep["step_ms"]) != steps \
            or not rep["device"].startswith("cuda") \
            or rep["val_batches"] < 1:
        raise AssertionError(f"{what}: launches {got}, want {want}; "
                             f"{len(rep['step_ms'])} steps on "
                             f"{rep['device']}, {rep['val_batches']} "
                             f"validation batches")
    return got


def trained_state(run: dict) -> dict:
    """The fit's weights by name, on the host: the driver's rehydrated
    ``_trained_state`` after a plugin fit, the model after an in-process
    one."""
    module = run["module"]
    if run["trainer"].plugin.remote:
        return module._trained_state
    return {k: v.detach().cpu() for k, v in
            module.model.state_dict().items()}


def check_bitwise(got: dict, want: dict, what: str) -> int:
    diff = [k for k, w in want.items()
            if k not in got or got[k].dtype != w.dtype
            or not torch.equal(got[k], w)]
    if diff or set(got) != set(want):
        raise AssertionError(f"{what}: {len(diff)} of {len(want)} tensors "
                             f"differ (first {diff[:8]})")
    return len(want)


def check_same_run(plugin: dict, local: dict, what: str) -> int:
    """Bit for bit on every weight; the same counters and metrics."""
    n = check_bitwise(trained_state(plugin), trained_state(local), what)
    pt, lt = plugin["trainer"], local["trainer"]
    if (pt.global_step, pt.current_epoch, pt.callback_metrics) != (
            lt.global_step, lt.current_epoch, lt.callback_metrics):
        raise AssertionError(
            f"{what}: counters or metrics differ: "
            f"{(pt.global_step, pt.current_epoch, pt.callback_metrics)} vs "
            f"{(lt.global_step, lt.current_epoch, lt.callback_metrics)}")
    return n


def ckpt_tensors(path: str) -> dict:
    """A checkpoint's ``state`` tensors by path, on the host."""
    out = {}

    def walk(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            elif isinstance(v, torch.Tensor):
                out[f"{prefix}{k}"] = v
            else:
                out[f"{prefix}{k}"] = torch.tensor(v)

    walk("", Trainer.load_checkpoint_dict(path, "cpu")["state"])
    return out


def plugin_phase(seed: int, driver_off_cuda: bool) -> dict:
    """Phase 11 (module docstring): (a) gpt2-small under
    ``RayPlugin(num_workers=1)`` against the in-process fit, (b) bert-base
    fine-tuning under ``RayShardedPlugin(num_workers=1)`` against the
    in-process fit, both checkpoints equal, the ZeRO-1 checkpoint resumed
    in process; (c) launches counted in the worker; (d) timings; (e) with
    ``driver_off_cuda``, the plugin fits run before anything touches CUDA
    here, and CUDA is still uninitialised after them."""
    import chip_smoke as this   # the module by name: workers import it
    from ray_lightning_tpu_torch import RayPlugin, RayShardedPlugin
    t_phase = time.monotonic()
    base = tempfile.mkdtemp(prefix="rlt_plugin_phase_")
    gpt = lambda: GPTLightningModule("gpt2-small", batch_size=TRAIN_B)
    bert = lambda: BertLightningModule(
        "bert-base", batch_size=BERT_B,
        train_size=BERT_B * (PLUGIN_BERT_STEPS + PLUGIN_RESUME_STEPS))
    try:
        ddp_plugin = RayPlugin(num_workers=1, timeout_s=PLUGIN_TIMEOUT_S)
        ddp = plugin_fit(this, ddp_plugin, gpt(), PLUGIN_GPT_STEPS, seed,
                         os.path.join(base, "ddp"))
        zero_plugin = RayShardedPlugin(num_workers=1,
                                       timeout_s=PLUGIN_TIMEOUT_S)
        zero = plugin_fit(this, zero_plugin, bert(), PLUGIN_BERT_STEPS,
                          seed, os.path.join(base, "zero1"))
        if driver_off_cuda and torch.cuda.is_initialized():
            raise AssertionError("(e) the driver initialised CUDA during "
                                 "the plugin fits")
        log(f"  (e) driver CUDA initialised after the plugin fits: "
            f"{torch.cuda.is_initialized()}")
        local_gpt = plugin_fit(this, None, gpt(), PLUGIN_GPT_STEPS, seed,
                               os.path.join(base, "local_gpt"))
        n_gpt = check_same_run(ddp, local_gpt, "(a) gpt2-small RayPlugin "
                               "vs in-process")
        best = ddp["trainer"].checkpoint_callback.best_model_path
        if not best or not os.path.exists(best):
            raise AssertionError(f"(a) best_model_path {best!r} missing")
        log(f"  (a) gpt2-small DDP W=1: {n_gpt} tensors, global_step, "
            f"callback_metrics {ddp['trainer'].callback_metrics} equal to "
            f"the in-process fit bit for bit; best_model_path "
            f"{os.path.basename(best)}")
        local_bert = plugin_fit(this, None, bert(), PLUGIN_BERT_STEPS, seed,
                                os.path.join(base, "local_bert"))
        n_bert = check_same_run(zero, local_bert, "(b) bert-base "
                                "RayShardedPlugin vs in-process")
        zckpt = zero["trainer"].checkpoint_callback.best_model_path
        lckpt = local_bert["trainer"].checkpoint_callback.best_model_path
        n_ckpt = check_bitwise(ckpt_tensors(zckpt), ckpt_tensors(lckpt),
                               "(b) ZeRO-1 checkpoint vs in-process")
        meta = Trainer.load_checkpoint_dict(zckpt, "cpu")
        if (meta["world_size"], meta["strategy"]) != (1, "zero1"):
            raise AssertionError(f"(b) checkpoint world_size/strategy "
                                 f"{meta['world_size']}, {meta['strategy']}")
        resumed = plugin_fit(this, None, bert(),
                             PLUGIN_BERT_STEPS + PLUGIN_RESUME_STEPS, seed,
                             os.path.join(base, "resumed"), ckpt=zckpt)
        layers = 12
        check_probe(resumed, layers, PLUGIN_RESUME_STEPS,
                    "(b) in-process resume of the ZeRO-1 checkpoint")
        if resumed["trainer"].global_step != \
                PLUGIN_BERT_STEPS + PLUGIN_RESUME_STEPS:
            raise AssertionError(f"(b) resume ended at step "
                                 f"{resumed['trainer'].global_step}")
        log(f"  (b) bert-base ZeRO-1 W=1: {n_bert} tensors, global_step, "
            f"callback_metrics {zero['trainer'].callback_metrics} equal to "
            f"the in-process fit bit for bit; its checkpoint equal to the "
            f"in-process one ({n_ckpt} tensors: params, moments, count); "
            f"resumed in process for {PLUGIN_RESUME_STEPS} steps to step "
            f"{resumed['trainer'].global_step}")
        launches = {"flash_fwd": 0, "flash_bwd": 0}
        timings = {}
        for name, run, local, steps in (
                ("gpt2-small ddp", ddp, local_gpt, PLUGIN_GPT_STEPS),
                ("bert-base zero1", zero, local_bert, PLUGIN_BERT_STEPS)):
            got = check_probe(run, layers, steps, f"(c) {name} worker")
            check_probe(local, layers, steps, f"(c) {name} in-process")
            for k in launches:
                launches[k] += got[k]
            rt = run["trainer"].plugin.last_result
            timings[name] = {
                "worker_start_to_first_step_s":
                    run["report"]["first_step_at"] - run["t0"],
                "in_process_start_to_first_step_s":
                    local["report"]["first_step_at"] - local["t0"],
                "worker_step_ms_median":
                    float(np.median(run["report"]["step_ms"][2:])),
                "in_process_step_ms_median":
                    float(np.median(local["report"]["step_ms"][2:])),
                "state_stream_bytes": rt["state_stream_bytes"],
                "round_trip_s": rt["round_trip_s"],
                "plugin_fit_s": run["wall_s"], "in_process_fit_s":
                    local["wall_s"], "worker_launches": got}
            log(f"  (c) {name}: worker launches {got} (12 x {steps} steps, "
                f"+12 x {run['report']['val_batches']} validation batch "
                f"for flash_fwd)")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    card = card_line()
    for name, t in timings.items():
        log(f"  (d) [{card}] {name}: fit call to the end of the first step "
            f"{t['worker_start_to_first_step_s']:.3f} s in the worker "
            f"(spawn, import, rendezvous, build, init) vs "
            f"{t['in_process_start_to_first_step_s']:.3f} s in process; "
            f"median step {t['worker_step_ms_median']:.3f} ms in the worker "
            f"vs {t['in_process_step_ms_median']:.3f} ms in process (steps "
            f"3+, synced); result round trip "
            f"{t['state_stream_bytes']} bytes in "
            f"{t['round_trip_s']:.3f} s; fit {t['plugin_fit_s']:.3f} s vs "
            f"{t['in_process_fit_s']:.3f} s")
    stats = {"card": card, "timings": timings, "launches": launches,
             "phase_s": time.monotonic() - t_phase}
    log("plugin " + json.dumps(stats))
    return {"launches": launches, "stats": stats}


# -- phase 12: tune -----------------------------------------------------------

#: (a) BASELINE config #3: a PBT sweep over MNIST, 4 trials of
#: ``tune_mnist``'s space at MNIST's split sizes, 3 reports each (6
#: until phase 18 needed the time: each restarted fit costs a worker's
#: start-up)
PBT_TRIALS = 4
PBT_ITERATIONS = 3
PBT_TRAIN_SIZE, PBT_VAL_SIZE = 60000, 10000
#: train batches an epoch (``limit_train_batches``; ``None``: the whole
#: epoch): the cut that keeps the phase in its budget, never the data
#: or the widths
PBT_TRAIN_BATCHES = None
#: (b) gpt2-small trials: steps, and a validation (a report and a
#: checkpoint relay) every ``TUNE_VAL_EVERY`` of them
TUNE_GPT_STEPS = 6
TUNE_VAL_EVERY = 3
TUNE_LRS = (1e-4, 3e-4)
#: (c) the in-process trials' steps
LEASE_STEPS = 4
#: each plugin run's bound inside a trial
TUNE_TIMEOUT_S = 600
#: what the trials' fits relayed, filled on the driver in each trial's
#: thread: (trial id, item)
TUNE_EVENTS: list = []
#: the checkpoint relays' sizes and times, filled on the driver
RELAYS: list = []


def record_tune_event(item: dict) -> None:
    TUNE_EVENTS.append((tune.get_trial_id(), item))


def tune_relay(trainer, item: dict) -> None:
    """To ``record_tune_event`` on the driver: through the worker queue
    from a worker, by a call in process."""
    if trainer.plugin.remote:
        from ray_lightning_tpu_torch import session
        session.put_queue(functools.partial(record_tune_event, item))
    else:
        record_tune_event(item)


class TuneProbe(Callback):
    """In a trial's fit, worker or driver: the device, the pid and the
    ``global_step`` the fit starts at (after a restore), then the wall
    clock at the end of its first step (referred to as
    ``chip_smoke.TuneProbe``: a worker imports it by name)."""

    def on_fit_start(self, trainer, module):
        self.first = None
        tune_relay(trainer, {"device": str(trainer.device),
                             "pid": os.getpid(),
                             "start_step": trainer.global_step})

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        if self.first is None:
            self.first = time.time()
            tune_relay(trainer, {"first_step_at": self.first})


class LeaseSpan(Callback):
    """In process: the wall clock when training starts and ends."""

    def on_train_start(self, trainer, module):
        self.t0 = time.time()

    def on_train_end(self, trainer, module):
        record_tune_event({"span": (self.t0, time.time()),
                           "device": str(trainer.device)})


class TimedPayload(_CheckpointPayload):
    """``_CheckpointPayload`` that also records, on the driver, its
    bytes, the worker's dump and serialize seconds, the seconds from the
    worker's send to the driver's call (pickle, socket, unpickle, the
    drain's wait) and the driver's write."""

    def __init__(self, blob, step, filename, dump_s, serialize_s, sent_at):
        super().__init__(blob, step, filename)
        self.dump_s, self.serialize_s, self.sent_at = (dump_s, serialize_s,
                                                       sent_at)

    def __call__(self):
        t_call = time.time()
        super().__call__()
        RELAYS.append({"trial": tune.get_trial_id(), "step": self.step,
                       "bytes": len(self.blob), "dump_s": self.dump_s,
                       "serialize_s": self.serialize_s,
                       "queue_s": t_call - self.sent_at,
                       "write_s": time.time() - t_call})


class TimedCheckpoint(_TuneCheckpointCallback):
    """``_TuneCheckpointCallback`` with its dump and serialize timed in
    the worker and a ``TimedPayload`` sent."""

    def _fire(self, event, trainer, module):
        if event in self._on and not trainer.sanity_checking:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt = trainer.dump_checkpoint()
            t1 = time.perf_counter()
            if trainer.is_global_zero:
                blob = trainer.serialize_checkpoint(ckpt)
                t2 = time.perf_counter()
                self._relay(TimedPayload(blob, trainer.global_step,
                                         self._filename, t1 - t0, t2 - t1,
                                         time.time()))


class TimedReportCheckpoint(tune.TuneReportCheckpointCallback):
    """``TuneReportCheckpointCallback`` whose checkpoint relay is timed."""

    def __init__(self, metrics=None, on="validation_end"):
        super().__init__(metrics, on=on)
        self._checkpoint = TimedCheckpoint("checkpoint", on)


def by_trial(key: str) -> dict:
    """``trial id -> [item[key], ...]`` over ``TUNE_EVENTS``, in order."""
    out: dict = {}
    for tid, item in TUNE_EVENTS:
        if key in item:
            out.setdefault(tid, []).append(item[key])
    return out


def startups(fit_calls: dict) -> list:
    """Each fit's seconds from the trainable's fit call to the end of
    its first step (the worker's spawn, import, rendezvous, data, init
    and first step)."""
    firsts = by_trial("first_step_at")
    return [f - c for tid, calls in fit_calls.items()
            for c, f in zip(calls, firsts.get(tid, []))]


def pbt_sweep(base: str, seed: int) -> dict:
    """(a) BASELINE config #3 (module docstring): 4 MNIST trials under
    PBT, each a ``RayPlugin(num_workers=1)`` fit on the card; checks and
    counts."""
    from ray_lightning_tpu_torch import LightningMNISTClassifier, RayPlugin
    restores: "list[tuple[str, int]]" = []
    fit_calls: dict = {}

    def trainable(config, checkpoint_dir=None):
        ckpt = None
        if checkpoint_dir:
            ckpt = os.path.join(checkpoint_dir, "checkpoint")
            restores.append((tune.get_trial_id(), int(
                Trainer.load_checkpoint_dict(ckpt, "cpu")["global_step"])))
        tid = tune.get_trial_id()
        fit_calls.setdefault(tid, []).append(time.time())
        log(f"  (a) {tid} fit {len(fit_calls[tid])} with {config}"
            + (f" from step {restores[-1][1]}" if ckpt else ""))
        trainer = Trainer(
            plugins=[RayPlugin(num_workers=1, timeout_s=TUNE_TIMEOUT_S)],
            max_epochs=10 * PBT_ITERATIONS, seed=seed,
            limit_train_batches=PBT_TRAIN_BATCHES, num_sanity_val_steps=0,
            enable_checkpointing=False, default_root_dir=tune.get_trial_dir(),
            callbacks=[TuneProbe(), TimedReportCheckpoint(
                {"loss": "ptl/val_loss",
                 "mean_accuracy": "ptl/val_accuracy"})])
        trainer.fit(LightningMNISTClassifier(
            config, train_size=PBT_TRAIN_SIZE, val_size=PBT_VAL_SIZE),
            ckpt_path=ckpt)

    space = {"layer_1": tune.choice([32, 64, 128]),
             "layer_2": tune.choice([64, 128, 256]),
             "lr": tune.loguniform(1e-4, 1e-1),
             "batch_size": tune.choice([32, 64, 128])}
    TUNE_EVENTS.clear()         # trial ids repeat across sweeps
    n_relays = len(RELAYS)
    t0 = time.time()
    analysis = tune.run(
        trainable, config=space, num_samples=PBT_TRIALS, seed=seed,
        scheduler=tune.PopulationBasedTraining(
            metric="loss", mode="min", perturbation_interval=1,
            hyperparam_mutations={"lr": tune.loguniform(1e-4, 1e-1),
                                  "batch_size": [32, 64, 128]}),
        stop={"training_iteration": PBT_ITERATIONS},
        resources_per_trial=tune.get_tune_resources(num_workers=1,
                                                    use_gpu=True),
        local_dir=base, name="pbt_mnist")
    wall = time.time() - t0
    trials = analysis.trials
    if [t.status for t in trials] != ["TERMINATED"] * PBT_TRIALS:
        raise AssertionError(f"(a) trial statuses {trials}: "
                             f"{[t.error for t in trials if t.error]}")
    if not restores:
        raise AssertionError("(a) no PBT exploit happened")
    starts = by_trial("start_step")
    for t in trials:
        want = [0] + [s for tid, s in restores if tid == t.trial_id]
        if starts.get(t.trial_id) != want:
            raise AssertionError(
                f"(a) {t.trial_id}: fits started at steps "
                f"{starts.get(t.trial_id)}, its restores' donor steps "
                f"{want[1:]}")
    devices = sorted({d for ds in by_trial("device").values() for d in ds})
    if not devices or not all(d.startswith("cuda") for d in devices):
        raise AssertionError(f"(a) worker devices {devices}")
    best = analysis.best_result
    if not best["mean_accuracy"] > 0.5:
        raise AssertionError(f"(a) best mean_accuracy "
                             f"{best['mean_accuracy']} (chance 0.1)")
    ups = startups(fit_calls)
    relays = RELAYS[n_relays:]
    stats = {
        "wall_s": wall, "trials": len(trials), "exploits": len(restores),
        "fits": sum(len(c) for c in fit_calls.values()),
        "reports": sum(len(t.history) for t in trials),
        "checkpoint_relays": len(relays),
        "relay_bytes_median": float(np.median([r["bytes"] for r in relays])),
        "worker_startup_s": {"min": min(ups), "median": float(np.median(ups)),
                             "max": max(ups)},
        "best_config": analysis.best_config,
        "best_loss": best["loss"], "best_mean_accuracy":
            best["mean_accuracy"], "devices": devices,
        "train_batches_per_epoch": PBT_TRAIN_BATCHES}
    log(f"  (a) PBT over MNIST: {len(trials)} trials TERMINATED in "
        f"{wall:.1f} s, {len(restores)} exploits (each restarted fit began "
        f"at its donor checkpoint's global_step), {stats['fits']} fits, "
        f"{stats['reports']} reports, {len(relays)} checkpoint relays; "
        f"workers on {devices}; best {analysis.best_config} loss "
        f"{best['loss']:.4f} accuracy {best['mean_accuracy']:.4f}; worker "
        f"start-up {stats['worker_startup_s']}")
    return stats


def gpt_sweep(base: str, seed: int) -> dict:
    """(b) gpt2-small at full width under ``RayPlugin(num_workers=1)``
    in a grid over lr: each trial's two reports and ~1.49 GB checkpoint
    relays, the last relayed checkpoint against the driver's weights bit
    for bit, the worker's launches; the timings."""
    from ray_lightning_tpu_torch import RayPlugin
    fits: dict = {}
    n_relays = len(RELAYS)

    def trainable(config):
        module = GPTLightningModule("gpt2-small", batch_size=TRAIN_B,
                                    lr=config["lr"])
        trainer = Trainer(
            plugins=[RayPlugin(num_workers=1, timeout_s=TUNE_TIMEOUT_S)],
            max_steps=TUNE_GPT_STEPS, val_check_interval=TUNE_VAL_EVERY,
            limit_val_batches=1, check_val_every_n_epoch=10**6,
            num_sanity_val_steps=0, enable_checkpointing=False, seed=seed,
            default_root_dir=tune.get_trial_dir(),
            callbacks=[PluginProbe(), TimedReportCheckpoint(
                on="validation_end")])
        PROBES.clear()
        t0 = time.time()
        trainer.fit(module)
        fits[tune.get_trial_id()] = dict(
            trainer=trainer, module=module, t0=t0, wall_s=time.time() - t0,
            report=PROBES.pop())

    t0 = time.time()
    analysis = tune.run(
        trainable, config={"lr": tune.grid_search(list(TUNE_LRS))},
        metric="val_loss", mode="min", seed=seed,
        # a bound past the fit's own end (two reports)
        stop={"training_iteration": TUNE_GPT_STEPS // TUNE_VAL_EVERY + 1},
        resources_per_trial=tune.get_tune_resources(num_workers=1,
                                                    use_gpu=True),
        local_dir=base, name="gpt2_small")
    wall = time.time() - t0
    launches = {"flash_fwd": 0, "flash_bwd": 0}
    per_trial = {}
    for t in analysis.trials:
        if t.status != "TERMINATED" or len(t.history) != 2:
            raise AssertionError(f"(b) {t}: {len(t.history)} reports, "
                                 f"want 2; {t.error}")
        run = fits[t.trial_id]
        got = check_probe(run, 12, TUNE_GPT_STEPS, f"(b) {t.trial_id}")
        if run["report"]["val_batches"] != 2:
            raise AssertionError(f"(b) {t.trial_id}: "
                                 f"{run['report']['val_batches']} "
                                 f"validation batches, want 2")
        for k in launches:
            launches[k] += got[k]
        ckpt = Trainer.load_checkpoint_dict(
            os.path.join(t.latest_checkpoint, "checkpoint"), "cpu")
        if ckpt["global_step"] != TUNE_GPT_STEPS:
            raise AssertionError(f"(b) last checkpoint at step "
                                 f"{ckpt['global_step']}")
        n = check_bitwise({**ckpt["state"]["params"],
                           **ckpt["state"]["model_state"]},
                          run["module"]._trained_state,
                          f"(b) {t.trial_id} relayed checkpoint vs the "
                          f"driver's weights")
        per_trial[t.trial_id] = {
            "lr": t.config["lr"], "val_loss": t.last_result["val_loss"],
            "fit_s": run["wall_s"], "tensors_equal": n,
            "worker_startup_s": run["report"]["first_step_at"] - run["t0"],
            "worker_step_ms_median":
                float(np.median(run["report"]["step_ms"][2:])),
            "worker_launches": got}
    relays = RELAYS[n_relays:]
    if len(relays) != 2 * len(analysis.trials):
        raise AssertionError(f"(b) {len(relays)} checkpoint relays, want "
                             f"{2 * len(analysis.trials)}")
    for r in relays:
        r["total_s"] = r["dump_s"] + r["serialize_s"] + r["queue_s"] \
            + r["write_s"]
        r["gb_per_s"] = r["bytes"] / r["total_s"] / 1e9
    stats = {"wall_s": wall, "sum_of_fits_s": sum(
        f["wall_s"] for f in fits.values()), "trials": per_trial,
        "relays": relays, "launches": launches,
        "best_checkpoint": os.path.basename(analysis.best_checkpoint)}
    log(f"  (b) gpt2-small grid over lr {list(TUNE_LRS)}: 2 trials x 2 "
        f"reports; each last relayed checkpoint equals the driver's "
        f"weights bit for bit; worker launches {launches}; sweep "
        f"{wall:.1f} s against {stats['sum_of_fits_s']:.1f} s of fits")
    for r in relays:
        log(f"  (b) relay {r['trial']} step {r['step']}: {r['bytes']} bytes "
            f"in {r['total_s']:.3f} s ({r['gb_per_s']:.3f} GB/s): dump "
            f"{r['dump_s']:.3f} + serialize {r['serialize_s']:.3f} in the "
            f"worker, queue {r['queue_s']:.3f}, write {r['write_s']:.3f} "
            f"on the driver")
    return {"analysis": analysis, "stats": stats, "launches": launches}


def resume_best(analysis, seed: int, root: str) -> dict:
    """(b) ``analysis.best_checkpoint`` resumed in process for one more
    step on the card: its launches (12 + 12) and the step it ends at."""
    path = os.path.join(analysis.best_checkpoint, "checkpoint")
    step = int(Trainer.load_checkpoint_dict(path, "cpu")["global_step"])
    trainer = Trainer(max_steps=step + 1, seed=seed, limit_val_batches=0,
                      num_sanity_val_steps=0, enable_checkpointing=False,
                      logger=False, device="cuda", default_root_dir=root)
    _kernels.reset_launches()
    trainer.fit(GPTLightningModule("gpt2-small", batch_size=TRAIN_B),
                ckpt_path=path)
    got = {k: _kernels.launch_counts()[k] for k in ("flash_fwd",
                                                    "flash_bwd")}
    loss = trainer.callback_metrics.get("loss")
    if trainer.global_step != step + 1 or got != {
            "flash_fwd": 12, "flash_bwd": 12} or not np.isfinite(loss):
        raise AssertionError(f"(b) resume of the best checkpoint: step "
                             f"{trainer.global_step}, launches {got}, "
                             f"loss {loss}")
    log(f"  (b) best checkpoint resumed in process from step {step} to "
        f"{trainer.global_step}: loss {loss:.4f}, launches {got}")
    return got


def lease_sweep(base: str, seed: int) -> dict:
    """(c) two in-process gpt2-small trials, each asking for one GPU, at
    max_concurrent_trials=2: on one card the lease serializes them;
    each trains on its leased card; their launches."""
    devices: dict = {}

    def trainable(config):
        trainer = Trainer(
            max_steps=LEASE_STEPS, seed=seed, limit_val_batches=0,
            num_sanity_val_steps=0, enable_checkpointing=False,
            default_root_dir=tune.get_trial_dir(),
            callbacks=[LeaseSpan(), tune.TuneReportCallback(
                on="train_epoch_end")])
        if trainer.device is not None:
            raise AssertionError(f"(c) device {trainer.device} before the "
                                 f"fit took the lease")
        trainer.fit(GPTLightningModule("gpt2-small", batch_size=TRAIN_B))
        devices[tune.get_trial_id()] = str(trainer.device)

    n = len(TUNE_EVENTS)
    _kernels.reset_launches()
    t0 = time.time()
    analysis = tune.run(
        trainable, config={"tag": tune.grid_search([0, 1])},
        resources_per_trial=tune.get_tune_resources(num_workers=1,
                                                    use_gpu=True),
        max_concurrent_trials=2, metric="loss", seed=seed,
        local_dir=base, name="leases")
    wall = time.time() - t0
    got = {k: _kernels.launch_counts()[k] for k in ("flash_fwd",
                                                    "flash_bwd")}
    spans = [it["span"] for _, it in TUNE_EVENTS[n:] if "span" in it]
    want = 2 * 12 * LEASE_STEPS
    for t in analysis.trials:
        if t.status != "TERMINATED" or t.leased_devices != [
                devices.get(t.trial_id)] or not devices[
                t.trial_id].startswith("cuda"):
            raise AssertionError(f"(c) {t}: leased {t.leased_devices}, "
                                 f"trained on {devices.get(t.trial_id)}; "
                                 f"{t.error}")
    (a0, a1), (b0, b1) = spans
    one_card = torch.cuda.device_count() == 1
    if one_card and not (a1 <= b0 or b1 <= a0):
        raise AssertionError(f"(c) the train intervals {spans} overlap on "
                             f"one card")
    if one_card and set(devices.values()) != {"cuda:0"}:
        raise AssertionError(f"(c) devices {devices}")
    if got != {"flash_fwd": want, "flash_bwd": want}:
        raise AssertionError(f"(c) launches {got}, want {want} each")
    log(f"  (c) 2 in-process trials at max_concurrent_trials=2 leased "
        f"{[t.leased_devices for t in analysis.trials]}, trained on "
        f"{sorted(devices.values())} one after the other (train intervals "
        f"{[(round(a, 3), round(b, 3)) for a, b in spans]}), launches "
        f"{got}; sweep {wall:.1f} s")
    return {"launches": got, "stats": {"wall_s": wall, "devices": devices,
                                       "spans": spans}}


def tune_phase(seed: int, driver_off_cuda: bool) -> dict:
    """Phase 12 (module docstring), run in this script's module by name,
    ``chip_smoke``: its workers import the callbacks and relayed items
    from there, and the driver's records must be that module's too."""
    import chip_smoke as this
    return this.run_tune_phase(seed, driver_off_cuda)


def run_tune_phase(seed: int, driver_off_cuda: bool) -> dict:
    """Phase 12: (a) PBT over MNIST, (b) gpt2-small trials in
    ``RayPlugin`` workers with ~1.49 GB checkpoint relays and the best
    checkpoint resumed in process, (c) in-process trials on a leased
    card; the tune path's launches of rows 1 and 6.  With
    ``driver_off_cuda``, (a) and (b)'s sweeps run before anything here
    touches CUDA, and CUDA is still uninitialised after them."""
    t_phase = time.monotonic()
    base = tempfile.mkdtemp(prefix="rlt_tune_phase_")
    TUNE_EVENTS.clear()
    RELAYS.clear()
    try:
        pbt = pbt_sweep(base, seed)
        gpt = gpt_sweep(base, seed)
        if driver_off_cuda and torch.cuda.is_initialized():
            raise AssertionError("the driver initialised CUDA during the "
                                 "actor trials")
        log(f"  driver CUDA initialised after the actor trials: "
            f"{torch.cuda.is_initialized()}")
        resumed = resume_best(gpt["analysis"], seed,
                              os.path.join(base, "resume"))
        leases = lease_sweep(base, seed)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    launches = {k: gpt["launches"][k] + resumed[k] + leases["launches"][k]
                for k in ("flash_fwd", "flash_bwd")}
    stats = {"card": card_line(), "pbt": pbt, "gpt": gpt["stats"],
             "leases": leases["stats"], "resume_launches": resumed,
             "launches": launches, "phase_s": time.monotonic() - t_phase}
    log("tune " + json.dumps(stats, default=str))
    return {"launches": launches, "stats": stats}


# -- phase 13: ResNet-50 under RayPlugin, the sharded example ------------------

#: BASELINE config #2 (benchmarks/bench_native_baseline.py:267-277):
#: resnet50 with the CIFAR stem at B=128, 3 warm-up steps and 30 timed,
#: ``train_size = B * (3 + 30 + 2)``
RESNET_B = 128
RESNET_WARMUP, RESNET_TIMED = 3, 30
RESNET_STEPS = RESNET_WARMUP + RESNET_TIMED
#: the in-process profile: ``torch.profiler`` over this many steps after
#: ``RESNET_WARMUP``, in a fit of its own
RESNET_PROFILE_STEPS = 5
#: the in-process fit without cuDNN's deterministic algorithms (its
#: timed steps against the deterministic fit's: the cost of bit-equality)
RESNET_FREE_STEPS = 13
#: the sharded example's model and steps (B=8, T=1024, one worker)
SHARDED_MODEL = "gpt2-small"
SHARDED_STEPS = 4
#: ResNet's device kernels by name fragment -> the layer they belong to
RESNET_CATEGORIES = (
    ("multi_tensor_apply", "optimizer"),
    ("conv", "conv"), ("xmma", "conv"), ("fprop", "conv"),
    ("dgrad", "conv"), ("wgrad", "conv"), ("implicit", "conv"),
    ("cudnn", "conv"), ("nhwc", "conv"), ("nchw", "conv"),
    ("elementwise", "BN and elementwise"), ("reduce", "BN and elementwise"),
    ("vectorized", "BN and elementwise"), ("unrolled", "BN and elementwise"))


def cudnn_deterministic() -> None:
    """cuDNN's deterministic algorithms and no autotuning: the same
    algorithms in a worker and in this process (``RayPlugin``'s
    ``init_hook`` in the worker; module level, so it can be sent)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resnet_category(name: str) -> str:
    low = name.lower()
    return next((c for frag, c in RESNET_CATEGORIES if frag in low), "other")


def resnet_module():
    from ray_lightning_tpu_torch import ResNetLightningModule
    return ResNetLightningModule(
        "resnet50", batch_size=RESNET_B,
        train_size=RESNET_B * (RESNET_STEPS + 2), val_size=2 * RESNET_B)


def step_stats(report: dict) -> dict:
    """Median step ms over the timed steps, steps/s per card, images/s."""
    ms = float(np.median(report["step_ms"][RESNET_WARMUP:]))
    return {"step_ms_median": ms, "steps_per_s_per_card": 1e3 / ms,
            "images_per_s": RESNET_B * 1e3 / ms}


def resnet_profile(this, seed: int, root: str) -> dict:
    """An in-process fit with ``TorchProfilerCallback`` over steps
    ``[RESNET_WARMUP, RESNET_WARMUP + RESNET_PROFILE_STEPS)``: device ms
    a step by category, the busy share of those steps' synced wall, the
    kernels a step."""
    from ray_lightning_tpu_torch.utils.profiling import TorchProfilerCallback
    n = RESNET_PROFILE_STEPS
    prof = TorchProfilerCallback(start_step=RESNET_WARMUP, num_steps=n,
                                 log_dir=os.path.join(root, "trace"))
    run = plugin_fit(this, None, resnet_module(), RESNET_WARMUP + n, seed,
                     root, callbacks=[prof])
    if prof.profile is None or not os.path.exists(prof.trace_path):
        raise AssertionError("the profiler wrote no trace")
    events = [e for e in prof.profile.key_averages() if _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in events) / n / 1e3
    if not device_ms > 0:
        raise AssertionError("the profiler saw no device time")
    by_cat: "dict[str, float]" = {}
    for e in events:
        c = resnet_category(e.key)
        by_cat[c] = by_cat.get(c, 0.0) + _device_us(e) / n / 1e3
    wall_ms = float(np.mean(run["report"]["step_ms"][RESNET_WARMUP:]))
    top = sorted(events, key=_device_us, reverse=True)[:10]
    return {"device_ms_per_step": device_ms,
            "profiled_step_ms": wall_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernels_per_step": sum(e.count for e in events) / n,
            "device_ms_by_category": dict(sorted(
                by_cat.items(), key=lambda kv: -kv[1])),
            "top_device_ms": [[e.key[:90], _device_us(e) / n / 1e3]
                              for e in top]}


def step_flops(module, seed: int) -> float:
    """Model FLOPs of one training step's forward and backward at
    ``RESNET_B`` (``FlopCounterMode``: convs and products), on the fit's
    weights and its first batch."""
    from torch.utils.flop_counter import FlopCounterMode
    x, y = next(iter(module.train_dataloader()))
    x, y = x.cuda(), y.cuda().long()
    model = module.model
    with FlopCounterMode(display=False) as counter:
        loss = F.cross_entropy(model(x, True).float(), y)
        loss.backward()
    model.zero_grad(set_to_none=True)
    return float(counter.get_total_flops())


def sharded_example_run(this, seed: int, root: str) -> dict:
    """The sharded example's ``train`` at gpt2-small in one worker for
    ``SHARDED_STEPS`` steps (ZeRO-1 over NCCL at W=1), with
    ``this.PluginProbe``: its epoch line (printed here, relayed from the
    worker), the worker's launches, peak memory and steps."""
    from ray_lightning_tpu_torch.examples import ray_ddp_sharded_example
    this.PROBES.clear()
    t0 = time.time()
    trainer = ray_ddp_sharded_example.train(
        num_workers=1, model_size=SHARDED_MODEL, batch_size=TRAIN_B,
        dataset_size=TRAIN_B * SHARDED_STEPS,
        callbacks=[this.PluginProbe()], default_root_dir=root,
        timeout_s=PLUGIN_TIMEOUT_S)
    wall = time.time() - t0
    if len(this.PROBES) != 1:
        raise AssertionError(f"{len(this.PROBES)} probe reports, want 1")
    rep = this.PROBES.pop()
    layers = CONFIGS[SHARDED_MODEL].n_layer
    want = {"flash_fwd": layers * SHARDED_STEPS,
            "flash_bwd": layers * SHARDED_STEPS}
    got = {k: rep["launches"][k] for k in want}
    metrics = trainer.callback_metrics
    if got != want or trainer.global_step != SHARDED_STEPS \
            or not rep["device"].startswith("cuda") \
            or not metrics.get("peak_memory_mb", 0) > 0 \
            or not np.isfinite(metrics.get("loss", np.nan)):
        raise AssertionError(f"(b) sharded example: launches {got}, want "
                             f"{want}; step {trainer.global_step} on "
                             f"{rep['device']}; metrics {metrics}")
    return {"launches": got, "wall_s": wall,
            "epoch_time_s": metrics["epoch_time_s"],
            "peak_memory_mb": metrics["peak_memory_mb"],
            "step_ms_median": float(np.median(rep["step_ms"][1:])),
            "strategy": trainer.strategy.name}


def resnet_phase(seed: int, driver_off_cuda: bool) -> dict:
    """Phase 13 (module docstring): (a) BASELINE config #2, resnet50 on
    synthetic CIFAR-10 at B=128 in bf16, under ``RayPlugin(num_workers=1)``
    and in process from the same seed, bit for bit with cuDNN
    deterministic in both; timings, start-up, round trip, peak memory, a
    profiled window, FLOPs and MFU; the cost of determinism; (b) the
    sharded example at gpt2-small in one worker.  With
    ``driver_off_cuda`` the worker fits run before anything here touches
    CUDA, and CUDA is still uninitialised after them."""
    import chip_smoke as this   # the module by name: workers import it
    from ray_lightning_tpu_torch import RayPlugin, ResNet
    t_phase = time.monotonic()
    base = tempfile.mkdtemp(prefix="rlt_resnet_phase_")
    try:
        worker = plugin_fit(this, RayPlugin(
            num_workers=1, timeout_s=PLUGIN_TIMEOUT_S,
            init_hook=this.cudnn_deterministic), resnet_module(),
            RESNET_STEPS, seed, os.path.join(base, "ddp"))
        sharded = sharded_example_run(this, seed, os.path.join(base,
                                                               "sharded"))
        log(f"  (b) sharded example, gpt2-small, ZeRO-1 in one worker: "
            f"{SHARDED_STEPS} steps, worker launches {sharded['launches']}, "
            f"epoch {sharded['epoch_time_s']:.3f} s, peak memory "
            f"{sharded['peak_memory_mb']:.0f} MB, median step "
            f"{sharded['step_ms_median']:.3f} ms")
        if driver_off_cuda and torch.cuda.is_initialized():
            raise AssertionError("the driver initialised CUDA during the "
                                 "worker fits")
        log(f"  driver CUDA initialised after the worker fits: "
            f"{torch.cuda.is_initialized()}")
        cudnn_deterministic()
        local = plugin_fit(this, None, resnet_module(), RESNET_STEPS, seed,
                           os.path.join(base, "local"))
        n = check_same_run(worker, local, "(a) resnet50 RayPlugin vs "
                           "in-process")
        for run, what in ((worker, "worker"), (local, "in-process")):
            rep = run["report"]
            if any(rep["launches"].values()) \
                    or len(rep["step_ms"]) != RESNET_STEPS \
                    or not rep["device"].startswith("cuda"):
                raise AssertionError(
                    f"(a) {what}: launches {rep['launches']} (ResNet "
                    f"launches none of the 16 kernels), "
                    f"{len(rep['step_ms'])} steps on {rep['device']}")
        state = trained_state(local)
        means = {k: v for k, v in state.items()
                 if k.endswith("running_mean")}
        still = [k for k, v in means.items() if not v.abs().sum() > 0]
        if not means or still:
            raise AssertionError(f"(a) {len(means)} running means, "
                                 f"{len(still)} still zero: {still[:4]}")
        loss = local["trainer"].callback_metrics["loss"]
        if not np.isfinite(loss):
            raise AssertionError(f"(a) loss {loss}")
        log(f"  (a) resnet50 B={RESNET_B} bf16 W=1: {n} tensors (params "
            f"and running statistics), global_step, callback_metrics "
            f"{local['trainer'].callback_metrics} equal to the in-process "
            f"fit bit for bit (cuDNN deterministic in both); every one of "
            f"{len(means)} running means off zero")

        module = local["module"]
        pt = Trainer(device="cuda", limit_predict_batches=2, logger=False,
                     enable_checkpointing=False, seed=seed,
                     default_root_dir=os.path.join(base, "predict"))
        preds = pt.predict(module)
        loader = module.predict_dataloader()
        xs = [x for (x, _), _ in zip(loader, range(2))]
        model = module.model
        with torch.no_grad():
            want = [model(x.cuda(), False).argmax(-1).cpu() for x in xs]
        if len(preds) != 2 or not all(torch.equal(p.cpu(), w)
                                      for p, w in zip(preds, want)):
            raise AssertionError("(a) predict differs from ResNet(x, "
                                 "train=False) on the same weights")
        assert isinstance(model, ResNet)
        flops = step_flops(module, seed)
        del pt, preds
        free_cuda()

        torch.backends.cudnn.deterministic = False
        free = plugin_fit(this, None, resnet_module(), RESNET_FREE_STEPS,
                          seed, os.path.join(base, "free"))
        cudnn_deterministic()
        profile = resnet_profile(this, seed, os.path.join(base, "profile"))
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(base, ignore_errors=True)
    card = card_line()
    w, ll = step_stats(worker["report"]), step_stats(local["report"])
    free_ms = float(np.median(free["report"]["step_ms"][RESNET_WARMUP:]))
    rt = worker["trainer"].plugin.last_result
    stats = {
        "card": card, "worker": w, "in_process": ll,
        "worker_start_to_first_step_s":
            worker["report"]["first_step_at"] - worker["t0"],
        "in_process_start_to_first_step_s":
            local["report"]["first_step_at"] - local["t0"],
        "state_stream_bytes": rt["state_stream_bytes"],
        "round_trip_s": rt["round_trip_s"],
        "worker_peak_bytes": worker["report"]["peak_bytes"],
        "in_process_peak_bytes": local["report"]["peak_bytes"],
        "step_flops": flops,
        "mfu_in_process": flops / (ll["step_ms_median"] / 1e3)
        / BF16_FLOPS_PER_S,
        "mfu_worker": flops / (w["step_ms_median"] / 1e3)
        / BF16_FLOPS_PER_S,
        "nondeterministic_step_ms_median": free_ms,
        "deterministic_cost_ms": ll["step_ms_median"] - free_ms,
        "profile": profile, "sharded_example": sharded,
        "phase_s": time.monotonic() - t_phase}
    log(f"  (a) [{card}] resnet50 B={RESNET_B}: steps/s per card "
        f"{w['steps_per_s_per_card']:.3f} in the worker, "
        f"{ll['steps_per_s_per_card']:.3f} in process; images/s "
        f"{w['images_per_s']:.1f} / {ll['images_per_s']:.1f}; median step "
        f"{w['step_ms_median']:.3f} / {ll['step_ms_median']:.3f} ms "
        f"(steps {RESNET_WARMUP + 1}-{RESNET_STEPS}, synced); fit call to "
        f"the end of the first step "
        f"{stats['worker_start_to_first_step_s']:.3f} s / "
        f"{stats['in_process_start_to_first_step_s']:.3f} s; round trip "
        f"{rt['state_stream_bytes']} bytes in {rt['round_trip_s']:.3f} s; "
        f"peak memory {stats['worker_peak_bytes'] / 1e9:.3f} / "
        f"{stats['in_process_peak_bytes'] / 1e9:.3f} GB")
    log(f"  (a) [{card}] model FLOPs a step {flops:.4e} (FlopCounterMode), "
        f"MFU {stats['mfu_in_process']:.4f} in process, "
        f"{stats['mfu_worker']:.4f} in the worker (989 TFLOP/s bf16); "
        f"without cuDNN determinism the median step is {free_ms:.3f} ms "
        f"({stats['deterministic_cost_ms']:+.3f} ms for determinism)")
    log(f"  (a) [{card}] profiled steps {RESNET_WARMUP + 1}-"
        f"{RESNET_WARMUP + RESNET_PROFILE_STEPS} in process: device "
        f"{profile['device_ms_per_step']:.3f} ms a step of "
        f"{profile['profiled_step_ms']:.3f} ms (busy share "
        f"{profile['device_busy_share']:.3f}), "
        f"{profile['kernels_per_step']:.0f} kernels a step")
    for name, ms in profile["device_ms_by_category"].items():
        log(f"    device {ms:.4f} ms  [{name}]")
    for name, ms in profile["top_device_ms"]:
        log(f"    device {ms:.4f} ms  {name}")
    log("resnet " + json.dumps(stats))
    return {"launches": sharded["launches"], "stats": stats}


# -- phase 14: the loop engine -------------------------------------------------

#: (a) BASELINE config #1's three cells (benchmarks/bench_mnist.py:23-50):
#: (train batches of ``LOOP_MNIST_B``, k, cache)
LOOP_MNIST_B = 128
LOOP_MNIST_CELLS = ((40, 1, False), (64, 32, False), (128, 64, True))
#: epoch 1 captures, epochs 2-3 are timed, epoch 4 holds the profile
LOOP_MNIST_EPOCHS = 4
#: (b) BASELINE config #2 cached (benchmarks/bench_resnet50.py:31-35):
#: k=8 over 4 chunks (one capture, one profiled, two timed)
LOOP_RESNET_K, LOOP_RESNET_STEPS = 8, 32
#: (c) gpt2-small at B=8, T=1024 with k=4 over 4 chunks
LOOP_GPT_K, LOOP_GPT_STEPS = 4, 16
#: the reports of ``LoopProbe``, filled on the driver
LOOP_PROBES: list = []


def record_loop_probe(report: dict) -> None:
    LOOP_PROBES.append(report)


class LoopProbe(Callback):
    """In the fit's process: the kernels' launches from 0 at the fit's
    start, synced time marks (each dispatch's end, or each epoch's start
    and end with ``per_dispatch=False``, so a streamed step is not
    synced), each dispatch's loss tensors, one dispatch from the step
    ``profile_at`` under ``torch.profiler`` (device time, kernels, busy
    share of its synced wall), peak memory and the chunk graphs' stats.
    The report goes to ``record_loop_probe`` on the driver (from a worker
    through ``session.put_queue``).  ``needs_batch = False``: the cached
    path collates no host batch for it."""

    needs_batch = False

    def __init__(self, profile_at: int, per_dispatch: bool):
        self.profile_at = profile_at
        self.per_dispatch = per_dispatch

    def _mark(self, trainer) -> None:
        torch.cuda.synchronize(trainer.device)
        self.marks.append((time.perf_counter(), trainer.global_step,
                           self._profiled))
        self._profiled = False

    def on_fit_start(self, trainer, module):
        _kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(trainer.device)
        self.marks, self.losses = [], []
        self._prof = self.profile = None
        self._profiled = False

    def on_train_epoch_start(self, trainer, module):
        if not self.per_dispatch:
            self._profiled = False
            self._mark(trainer)

    def on_train_epoch_end(self, trainer, module):
        if not self.per_dispatch:
            self._mark(trainer)

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        if self._prof is None and self.profile is None \
                and trainer.global_step >= self.profile_at:
            torch.cuda.synchronize(trainer.device)
            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._prof_at = (time.perf_counter(), trainer.global_step)

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self.losses.append(outputs["loss"])
        if self._prof is not None:
            torch.cuda.synchronize(trainer.device)
            wall_ms = (time.perf_counter() - self._prof_at[0]) * 1e3
            self._prof.__exit__(None, None, None)
            events = [e for e in self._prof.key_averages()
                      if _device_us(e) > 0]
            device_ms = sum(_device_us(e) for e in events) / 1e3
            self.profile = {
                "steps": trainer.global_step - self._prof_at[1],
                "wall_ms": wall_ms, "device_ms": device_ms,
                "device_busy_share": device_ms / wall_ms,
                "kernels": sum(e.count for e in events)}
            self._prof = None
            self._profiled = True
        if self.per_dispatch:
            self._mark(trainer)

    def on_fit_end(self, trainer, module):
        losses = [float(x) for t in self.losses
                  for x in t.detach().float().reshape(-1).cpu()]
        report = {"launches": _kernels.launch_counts(), "marks": self.marks,
                  "losses": losses, "profile": self.profile,
                  "graph_stats": dict(trainer.graph_stats),
                  "peak_bytes": torch.cuda.max_memory_allocated(
                      trainer.device),
                  "device": str(trainer.device),
                  "global_step": trainer.global_step}
        if trainer.plugin.remote:
            from ray_lightning_tpu_torch import session
            session.put_queue(functools.partial(record_loop_probe, report))
        else:
            record_loop_probe(report)


def steady_rate(marks: list, per_dispatch: bool) -> dict:
    """Steps/s over the timed intervals: between consecutive dispatch
    ends (the first dispatch, which holds the capture, the warm-up and
    set-up, ends before the first), or each epoch's start and end from
    the second epoch on; an interval that held the profile is left
    out."""
    if per_dispatch:
        spans = [(b[0] - a[0], b[1] - a[1], b[2])
                 for a, b in zip(marks, marks[1:])]
    else:
        spans = [(b[0] - a[0], b[1] - a[1], b[2])
                 for a, b in zip(marks[2::2], marks[3::2])]
    timed = [(dt, n) for dt, n, profiled in spans if not profiled]
    if not timed:
        raise AssertionError(f"no timed interval among {len(spans)}")
    secs, steps = sum(dt for dt, _ in timed), sum(n for _, n in timed)
    return {"timed_steps": steps, "timed_s": secs,
            "steps_per_s_per_card": steps / secs}


def loop_fit(this, module, root: str, per_dispatch: bool, profile_at: int,
             plugin=None, **kw) -> dict:
    """One fit with ``this.LoopProbe``: in process on the card, or under
    ``plugin``; the trainer, the module and the probe's report."""
    where = (dict(plugins=[plugin]) if plugin is not None
             else dict(device="cuda"))
    trainer = Trainer(enable_checkpointing=False, logger=False,
                      num_sanity_val_steps=0, limit_val_batches=0,
                      seed=0, default_root_dir=root,
                      callbacks=[this.LoopProbe(profile_at, per_dispatch)],
                      **where, **kw)
    this.LOOP_PROBES.clear()
    trainer.fit(module)
    if len(this.LOOP_PROBES) != 1:
        raise AssertionError(f"{len(this.LOOP_PROBES)} loop reports, want 1")
    report = this.LOOP_PROBES.pop()
    report["rate"] = steady_rate(report["marks"], per_dispatch)
    state = None
    if plugin is None:
        state = {k: v.detach().clone() for k, v in
                 module.model.state_dict().items()}
        state.update({f"opt/{k}": v.detach().clone() for k, v in
                      ckpt_like(trainer.state.opt_state.state_dict()).items()})
    return dict(trainer=trainer, module=module, report=report, state=state)


def ckpt_like(tree, prefix: str = "") -> dict:
    """A nested state dict's tensors (and ints, as tensors) by path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(ckpt_like(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (v if isinstance(v, torch.Tensor)
                                   else torch.tensor(v))
    return out


def check_loop_fit(run: dict, ref: dict, what: str, k: int, steps: int,
                   per_replay: "dict | None" = None) -> dict:
    """``run`` against the eager k=1 ``ref`` on the same seed: the same
    ``global_step`` and per-step losses (so the same batches), the end
    state bit for bit (params, buffers and, in process, the optimizer
    state); one capture, each full chunk one replay, the kernels'
    launches a replay as ``per_replay`` says."""
    rep, want = run["report"], ref["report"]
    if not rep["global_step"] == want["global_step"] == steps:
        raise AssertionError(f"{what}: global_step {rep['global_step']}, "
                             f"eager {want['global_step']}, want {steps}")
    if rep["losses"] != want["losses"]:
        raise AssertionError(f"{what}: per-step losses differ from the "
                             f"eager fit's (first 4: {rep['losses'][:4]} vs "
                             f"{want['losses'][:4]})")
    got = run["state"] if run["state"] is not None \
        else run["module"]._trained_state
    ref_state = {n: t.cpu() for n, t in ref["state"].items()
                 if n in got}
    n = check_bitwise({n: t.cpu() for n, t in got.items()}, ref_state,
                      f"{what} against the eager k=1 fit")
    gs = rep["graph_stats"]
    if k > 1:
        if gs["captures"] != 1 or gs["replays"] != steps // k:
            raise AssertionError(f"{what}: {gs['captures']} captures and "
                                 f"{gs['replays']} replays, want 1 and "
                                 f"{steps // k}")
        if per_replay is not None and gs["launches_per_replay"] != per_replay:
            raise AssertionError(f"{what}: launches a replay "
                                 f"{gs['launches_per_replay']}, want "
                                 f"{per_replay}")
    return {"tensors_equal": n}


def loop_line(name: str, run: dict, B: int, unit: str,
              per_sample: int = 1) -> dict:
    """One fit's figures (the phase's log line and JSON)."""
    rep = run["report"]
    rate = rep["rate"]["steps_per_s_per_card"]
    gs = rep["graph_stats"]
    prof = rep["profile"] or {}
    out = {"steps_per_s_per_card": rate,
           f"{unit}_per_s": rate * B * per_sample,
           "captures": gs.get("captures", 0),
           "replays": gs.get("replays", 0),
           "launches_per_replay": gs.get("launches_per_replay", {}),
           "capture_ms": gs.get("capture_ms", []),
           "pool_bytes": gs.get("pool_bytes", []),
           "profiled": prof, "peak_bytes": rep["peak_bytes"],
           "timed_steps": rep["rate"]["timed_steps"]}
    log(f"  {name}: {rate:.2f} steps/s per card, "
        f"{out[f'{unit}_per_s']:.1f} {unit}/s ({out['timed_steps']} timed "
        f"steps); captures {out['captures']}, replays {out['replays']}, "
        f"launches a replay {out['launches_per_replay']}, capture ms "
        f"{[round(x, 1) for x in out['capture_ms']]}, pool bytes "
        f"{out['pool_bytes']}; profiled dispatch of {prof.get('steps')} "
        f"steps: device {prof.get('device_ms', 0):.3f} ms of "
        f"{prof.get('wall_ms', 0):.3f} ms (busy "
        f"{prof.get('device_busy_share', 0):.3f}), {prof.get('kernels')} "
        f"kernels; peak {rep['peak_bytes'] / 1e9:.3f} GB")
    return out


def loop_mnist(this, base: str) -> dict:
    """(a) the three cells of BASELINE config #1, each against its eager
    k=1 fit (the k=1 cell, whose stream double-buffers, against the
    unbuffered one)."""
    from ray_lightning_tpu_torch import LightningMNISTClassifier
    out = {}
    for batches, k, cache in LOOP_MNIST_CELLS:
        def module():
            return LightningMNISTClassifier(
                config={"batch_size": LOOP_MNIST_B},
                train_size=LOOP_MNIST_B * batches)
        steps = batches * LOOP_MNIST_EPOCHS
        at = batches * (LOOP_MNIST_EPOCHS - 1)
        name = f"mnist b{LOOP_MNIST_B} x {batches} k={k}" + \
            (" cache" if cache else "")
        with scoped_env(RLT_STREAM_PREFETCH="0" if k == 1 else "1"):
            ref = loop_fit(this, module(), os.path.join(base, "m_ref"),
                           False, at, max_epochs=LOOP_MNIST_EPOCHS)
        run = loop_fit(this, module(), os.path.join(base, "m_run"), False,
                       at, max_epochs=LOOP_MNIST_EPOCHS,
                       steps_per_execution=k, cache_train_dataset=cache)
        eq = check_loop_fit(run, ref, f"(a) {name}", k, steps, {})
        out[name] = {**loop_line(f"(a) {name}", run, LOOP_MNIST_B,
                                 "images"),
                     "eager": loop_line(f"(a) {name}, eager k=1"
                                        + (" unbuffered" if k == 1 else ""),
                                        ref, LOOP_MNIST_B, "images"),
                     **eq}
    return out


def loop_resnet_module():
    from ray_lightning_tpu_torch import ResNetLightningModule
    return ResNetLightningModule(
        "resnet50", batch_size=RESNET_B,
        train_size=RESNET_B * LOOP_RESNET_STEPS, val_size=2 * RESNET_B)


def loop_gpt_module():
    return GPTLightningModule(CONFIGS["gpt2-small"], batch_size=TRAIN_B,
                              warmup_steps=2,
                              dataset_size=TRAIN_B * LOOP_GPT_STEPS)


def loop_phase(seed: int, driver_off_cuda: bool) -> dict:
    """Phase 14 (module docstring): the loop engine on the card.  (b)'s
    worker fit runs first, so with ``driver_off_cuda`` nothing here
    touches CUDA before it ends."""
    import chip_smoke as this   # the module by name: workers import it
    from ray_lightning_tpu_torch import RayPlugin
    t_phase = time.monotonic()
    base = tempfile.mkdtemp(prefix="rlt_loop_phase_")
    K, N = LOOP_RESNET_K, LOOP_RESNET_STEPS
    launches: "dict[str, int]" = {}

    def add(report):
        for name, n in report["launches"].items():
            launches[name] = launches.get(name, 0) + n

    try:
        t0 = time.time()
        worker = loop_fit(this, loop_resnet_module(),
                          os.path.join(base, "r_worker"), True, 2 * K,
                          plugin=RayPlugin(
                              num_workers=1, timeout_s=PLUGIN_TIMEOUT_S,
                              init_hook=this.cudnn_deterministic),
                          max_steps=N, steps_per_execution=K,
                          cache_train_dataset=True)
        worker_wall = time.time() - t0
        if driver_off_cuda and torch.cuda.is_initialized():
            raise AssertionError("the driver initialised CUDA during the "
                                 "worker fit")
        results = {"mnist": loop_mnist(this, base)}
        free_cuda()

        cudnn_deterministic()
        r_ref = loop_fit(this, loop_resnet_module(),
                         os.path.join(base, "r_ref"), True, 2 * K,
                         max_steps=N)
        r_run = loop_fit(this, loop_resnet_module(),
                         os.path.join(base, "r_run"), True, 2 * K,
                         max_steps=N, steps_per_execution=K,
                         cache_train_dataset=True)
        name = f"resnet50 b{RESNET_B} bf16 k={K} cache"
        eq = check_loop_fit(r_run, r_ref, f"(b) {name} in process", K, N,
                            {})
        eq_w = check_loop_fit(worker, r_ref, f"(b) {name} in one worker",
                              K, N, {})
        results["resnet"] = {
            "in_process": {**loop_line(f"(b) {name} in process", r_run,
                                       RESNET_B, "images"), **eq},
            "worker": {**loop_line(f"(b) {name} in one RayPlugin worker",
                                   worker, RESNET_B, "images"), **eq_w,
                       "fit_wall_s": worker_wall},
            "eager": loop_line(f"(b) resnet50 b{RESNET_B} bf16 streamed "
                               f"eager k=1 in process", r_ref, RESNET_B,
                               "images")}
        torch.backends.cudnn.deterministic = False
        del r_ref, r_run, worker
        free_cuda()

        layers = CONFIGS["gpt2-small"].n_layer
        G, M = LOOP_GPT_K, LOOP_GPT_STEPS
        g_ref = loop_fit(this, loop_gpt_module(), os.path.join(base, "g"),
                         True, 2 * G, max_steps=M)
        add(g_ref["report"])
        g_run = loop_fit(this, loop_gpt_module(), os.path.join(base, "g"),
                         True, 2 * G, max_steps=M, steps_per_execution=G)
        add(g_run["report"])
        per_replay = {"flash_fwd": layers * G, "flash_bwd": layers * G}
        name = f"gpt2-small b{TRAIN_B} T{TRAIN_T} k={G}"
        eq = check_loop_fit(g_run, g_ref, f"(c) {name}", G, M, per_replay)
        warm = g_run["report"]["graph_stats"]["warmup_steps"]
        for rep, n in ((g_ref["report"], M), (g_run["report"], M + warm)):
            want = {"flash_fwd": layers * n, "flash_bwd": layers * n}
            got = {k: rep["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"(c) launches {got}, want {want} (12 "
                                     f"layers x steps, the warm-up step "
                                     f"included)")
        results["gpt"] = {
            "graphed": {**loop_line(f"(c) {name}", g_run, TRAIN_B, "tokens",
                                    TRAIN_T), **eq},
            "eager": loop_line(f"(c) gpt2-small b{TRAIN_B} T{TRAIN_T} eager "
                               f"k=1", g_ref, TRAIN_B, "tokens", TRAIN_T)}
        del g_ref, g_run
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(base, ignore_errors=True)
    results.update(card=card_line(), phase_s=time.monotonic() - t_phase,
                   launches=launches)
    log("loop " + json.dumps(results))
    return {"launches": launches, "stats": results}


def attribute(by_row: dict, runs: list) -> None:
    """Add each path run's launches to the rows it takes: flash_fwd's to
    its forward row, flash_bwd's to each backward row."""
    for r in runs:
        fwd_row, bwd_rows = r["rows"]
        for row, name in [(fwd_row, "flash_fwd")] + [
                (b, "flash_bwd") for b in bwd_rows]:
            e = by_row[row]
            e.setdefault("launches_by_path", {})[r["path"]] = \
                r["launches"][name]
            e["launches"] = sum(e["launches_by_path"].values())


def speed_order(entries: list) -> list:
    """The kernel entries in the order the speed work takes them: first
    those slower than their library call, the largest factor first; then
    the rest by launches x (ms - bound), the most device time above the
    bound first."""
    def slower(e):
        return bool(e["library_ms"]) and e["ms"] > e["library_ms"]

    return (sorted((e for e in entries if slower(e)),
                   key=lambda e: -e["ms"] / e["library_ms"])
            + sorted((e for e in entries if not slower(e)),
                     key=lambda e: -e["launches"] * (e["ms"] - e["bound_ms"])))


#: the forward's shapes of TPU kernel rows 1-5 on the paths above:
#: (row, B, T, H, causal)
FWD_ROW_SHAPES = (
    (1, 1, 1024, 12, True), (1, 8, 1024, 12, True),
    (1, 32, 512, 12, False), (5, 8, 1024, 25, True),
    (4, 4, 2048, 25, True), (3, 8, 2048, 32, True),
    (2, 1, 16384, 12, True))


#: launches whose host wall gives ``fwd_rows``' host cost per call
HOST_CALLS = 2000


def fwd_rows(gen) -> list:
    """``--fwd-only``: flash_fwd alone at every row 1-5 shape, on fused-qkv
    views, against its plain version over all heads (o within BF16_TOL,
    lse within LSE_TOL), two launches equal bit for bit, timed with CUDA
    events beside SDPA and its bound; achieved TFLOP/s from the causal
    (or full) product count.  First the host's cost of a call at a small
    shape (its wall over ``HOST_CALLS`` calls queued without a sync)."""
    q, k, v, _ = attention_inputs(gen, 1, 128, H)
    flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        flash_attention_fwd(q, k, v)
    host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    log(f"  host: {host_us:.2f} us a flash_attention_fwd call at B=1 T=128 "
        f"(the wrapper's checks and allocations, the launch)")
    out = [dict(host_us_per_call=host_us)]
    for row, B, T, heads, causal in FWD_ROW_SHAPES:
        q, k, v, _ = attention_inputs(gen, B, T, heads)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o2, lse2 = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = by_heads(flash_attention_fwd_plain, q, k, v,
                                  causal=causal)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        same = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        del o_ref, lse_ref, o2, lse2
        shape = f"B={B} T={T} H={heads} {'causal' if causal else 'full'}"
        check_close(f"flash_fwd {shape}", err, BF16_TOL)
        check_close(f"flash_fwd lse {shape}", lse_err, LSE_TOL)
        if not same:
            raise AssertionError(f"flash_fwd {shape}: two launches differ")
        ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal),
                     iters=20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), iters=20)
        flops = 4 * B * heads * D * T * ((T + 1) / 2 if causal else T)
        b_ms, b_by = bound(B * (4 * T * heads * D * 2 + heads * T * 4),
                           flops)
        log(f"  row {row} {shape}: max_abs_err {err:.3e}, lse {lse_err:.3e}"
            f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), sdpa "
            f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), kernel/sdpa "
            f"{ms / lib_ms:.2f}x")
        out.append(dict(row=row, shape=shape, max_abs_err=err,
                        lse_max_abs_err=lse_err, ms=ms, library_ms=lib_ms,
                        bound_ms=b_ms, bound_by=b_by,
                        tflops=flops / ms / 1e9))
        del q, k, v, o, lse
        free_cuda()
    return out


#: the backward's shapes of TPU kernel rows 6-12, 15 and 16 on the paths
#: above: (rows, B, T, H, D, causal)
BWD_ROW_SHAPES = (
    ("6", 8, 1024, 12, 64, True), ("6, 15, 16", 32, 512, 12, 64, False),
    ("9", 8, 2048, 32, 64, True), ("7, 8", 2, 4096, 12, 64, True),
    ("7, 8", 1, 8192, 12, 64, True), ("7, 8", 1, 16384, 12, 64, True),
    ("10", 8, 1024, 25, 64, True), ("10", 8, 64, 2, 32, False),
    ("10", 8, 1024, 2, 32, True), ("11, 12", 4, 2048, 25, 64, True),
    ("11, 12", 8, 2048, 2, 32, True))


def bwd_rows(gen) -> list:
    """``--bwd-only``: flash_bwd alone at every row 6-12, 15, 16 shape, on
    fused-qkv views, the forward's o and lse, against the plain backward
    over all heads (dq, dk, dv within ``BWD_TOL`` relative L2), two calls
    equal bit for bit; the whole backward and each pass timed with CUDA
    events beside the SDPA backward and the bounds; achieved TFLOP/s
    over the five products the bound counts and over the seven the
    kernel computes (s and dp in both passes)."""
    out = []
    for rows, B, T, heads, d, causal in BWD_ROW_SHAPES:
        shape = (f"B={B} T={T} H={heads} D={d} "
                 f"{'causal' if causal else 'full'}")
        q, k, v, do = attention_inputs(gen, B, T, heads, d)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = by_heads(flash_attention_bwd_plain, q, k, v, o, do, lse=lse,
                        causal=causal)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        errs = {n: rel_l2(a, b) for n, a, b in zip(names, got, want)}
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
        del got, again, want
        for n, e in errs.items():
            check_close(f"flash_bwd {n} {shape} (relative L2)", e, BWD_TOL)
        if not (same and finite):
            raise AssertionError(f"flash_bwd {shape}: two calls equal "
                                 f"{same}, finite {finite}")
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal), iters=20)
        passes = bwd_pass_ms(q, k, v, o, lse, do, causal)
        qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out_t = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out_t, (qg, kg, vg), do.transpose(1, 2), retain_graph=True),
            iters=20)
        del out_t
        bb = bwd_bounds(B, T, heads, d, causal)
        tri = bb["tri_flops"]
        log(f"  rows {rows} {shape}: relative L2 "
            + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
            + f"; kernel {ms:.4f} ms ({5 * tri / ms / 1e9:.1f} TFLOP/s of "
            f"5 products, {7 * tri / ms / 1e9:.1f} of 7), sdpa backward "
            f"{lib_ms:.4f} ms, bound {bb['bwd'][0]:.5f} ms "
            f"({bb['bwd'][1]}), kernel/sdpa {ms / lib_ms:.2f}x"
            + "".join(f"; {n} {t:.4f} (bound {bb[n][0]:.5f})"
                      for n, t in passes.items()))
        out.append(dict(rows=rows, shape=shape, rel_l2=errs,
                        deterministic=same, ms=ms, library_ms=lib_ms,
                        bound_ms=bb["bwd"][0], bound_by=bb["bwd"][1],
                        passes_ms=passes,
                        pass_bound_ms={n: bb[n][0] for n in passes},
                        tflops_5=5 * tri / ms / 1e9,
                        tflops_7=7 * tri / ms / 1e9))
        del q, k, v, do, o, lse
        free_cuda()
    return out


#: ``--decode-only``'s chunk sweep (rows a split; the plan's pick is one)
DECODE_CHUNKS = (64, 128, 192, 256, 384, 512, 1024)


@contextlib.contextmanager
def decode_chunk(chunk: int):
    """The decode wrappers take ``chunk`` rows a split inside: they look
    the plan up by its name in ``ops/flash_decode.py``."""
    plan = fd.decode_split_plan
    fd.decode_split_plan = lambda S, H, L, sms: (chunk, -(-L // chunk))
    try:
        yield
    finally:
        fd.decode_split_plan = plan


def decode_shapes(gen) -> list:
    """``--decode-only``'s shapes at L=1024, H=12, D=64: the smoke's 16
    slots with ``decode_positions``; one and four slots at position
    1023; 16 slots at positions 272-352, the contexts of the paged and
    spec phases (a 256-token prefix, a 16-64-token tail, up to 32 new
    tokens)."""
    mid = torch.randint(272, 353, (SERVE_SLOTS,), generator=gen,
                        device="cuda").to(torch.int32)
    full = torch.full((4,), 1023, dtype=torch.int32, device="cuda")
    return [("S=16 mixed", decode_positions(gen, SERVE_SLOTS, 1024)),
            ("S=1 pos 1023", full[:1].clone()),
            ("S=4 pos 1023", full),
            ("S=16 pos 272-352", mid)]


def decode_rows(gen) -> list:
    """``--decode-only``: rows 13 and 14 alone at ``decode_shapes``. Each
    shape: the slot-contiguous kernel and the paged one at page sizes 16
    and 64, identity and permuted tables, against the plain version
    (``BF16_TOL``), two calls equal bit for bit, every paged output
    equal to the slot-contiguous one; each timed with CUDA events, L2
    flushed before each launch, beside SDPA on the slot cache and the
    bound from the live rows, with GB/s of the bytes the bound counts;
    the host's us per call; the kernel against
    ``flash_decode_split_plain`` (the same split arithmetic) to about a
    bf16 ulp (``SPLIT_TOL``). The slot-contiguous kernel is also timed
    at each of ``DECODE_CHUNKS`` (the split plan's pick among them)."""
    L = 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = []
    for label, positions in decode_shapes(gen):
        S = positions.numel()
        q = torch.randn(S, 1, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        kc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        vc = torch.randn(S, L, H, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        flat = flash_decode_attention(q, kc, vc, positions)
        ok = torch.equal(flat, flash_decode_attention(q, kc, vc, positions))
        want = flash_decode_attention_plain(q, kc, vc, positions)
        errs = {"flat": (flat.float() - want.float()).abs().max().item()}
        plan = fd.decode_split_plan(S, H, L, sms)
        split = fd.flash_decode_split_plain(q, kc, vc, positions,
                                            plan[0]).float()
        split_err = ((flat.float() - split).abs()
                     - SPLIT_TOL[1] * split.abs()).max().item()
        fns = {"flat": lambda: flash_decode_attention(q, kc, vc, positions)}
        for ps in (16, 64):
            P = L // ps
            ident = torch.arange(S * P, dtype=torch.int32,
                                 device="cuda").view(S, P)
            perm = torch.randperm(S * P, generator=gen, device="cuda").to(
                torch.int32).view(S, P)
            kp, vp = kc.view(S * P, ps, H, D), vc.view(S * P, ps, H, D)
            kq, vq = torch.empty_like(kp), torch.empty_like(vp)
            kq[perm.flatten().long()] = kp
            vq[perm.flatten().long()] = vp
            for name, a in (("identity", (kp, vp, ident)),
                            ("permuted", (kq, vq, perm))):
                key = f"page{ps}_{name}"
                o = flash_decode_paged_attention(q, a[0], a[1], positions,
                                                 a[2])
                ok = ok and torch.equal(o, flat) and torch.equal(
                    o, flash_decode_paged_attention(q, a[0], a[1],
                                                    positions, a[2]))
                errs[key] = (o.float() - want.float()).abs().max().item()
                fns[key] = (lambda a=a: flash_decode_paged_attention(
                    q, a[0], a[1], positions, a[2]))
        torch.cuda.synchronize()
        for key, err in errs.items():
            check_close(f"decode {label} {key}", err, BF16_TOL)
        check_close(f"decode {label} flat vs split arithmetic, past "
                    f"rtol {SPLIT_TOL[1]}", split_err, SPLIT_TOL[0])
        if not ok:
            raise AssertionError(f"decode {label}: a paged output is not the "
                                 f"slot-contiguous one, or two calls differ")
        ms = {key: time_ms(fn, flush=flush) for key, fn in fns.items()}
        mask = (torch.arange(L, device="cuda")[None, :]
                <= positions[:, None].long())[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        lib_ms = time_ms(sdpa, flush=flush)
        live_rows = int((positions.long() + 1).sum())
        nbytes = 2 * S * C * 2 + 2 * live_rows * C * 2 + S * 4
        b_ms, b_by = bound(nbytes, 4 * live_rows * C)
        # yardsticks timed the same way: a one-element fill (the timing's
        # floor) and one read of as many bytes as the live rows hold
        tiny = torch.empty(1, device="cuda")
        floor_ms = time_ms(tiny.zero_, flush=flush)
        live = torch.empty(nbytes // 2, dtype=torch.bfloat16, device="cuda")
        read_ms = time_ms(live.sum, flush=flush)
        # and with L2 evicted by a read (clean, as the serve step leaves it
        # after the weights' reads)
        clean = {key: time_ms(fn, flush=flush, clean=True)
                 for key, fn in (("flat", fns["flat"]),
                                 ("page16_identity", fns["page16_identity"]),
                                 ("sdpa", sdpa), ("read", live.sum),
                                 ("floor", tiny.zero_))}
        # and back to back, the bytes in L2: the kernel's own latency
        warm = {key: time_ms(fn) for key, fn in (
            ("flat", fns["flat"]), ("page16_identity",
                                    fns["page16_identity"]),
            ("sdpa", sdpa), ("read", live.sum), ("floor", tiny.zero_))}
        del live
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS // 4):
            fns["flat"]()
        host_us = (time.perf_counter() - t0) / (HOST_CALLS // 4) * 1e6
        torch.cuda.synchronize()
        row = dict(shape=f"{label} L={L} H={H} D={D}", live_rows=live_rows,
                   max_abs_err=errs, ms=ms, library_ms=lib_ms, bound_ms=b_ms,
                   bound_by=b_by, gbps={k: nbytes / v / 1e6
                                        for k, v in ms.items()},
                   floor_ms=floor_ms, read_ms=read_ms, clean_l2_ms=clean,
                   warm_l2_ms=warm, host_us_per_call=host_us, plan=plan,
                   split_err_past_rtol=split_err)
        row["ms_by_chunk"] = {}
        for c in DECODE_CHUNKS:
            with decode_chunk(c):
                row["ms_by_chunk"][c] = time_ms(fns["flat"], flush=flush)
        log(f"  {label}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + f" ms; sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"floor {floor_ms:.4f} ms, read of the bytes {read_ms:.4f} ms, "
            f"clean L2: " + ", ".join(f"{k} {v:.4f}" for k, v in clean.items())
            + "; warm L2: " + ", ".join(f"{k} {v:.4f}" for k, v in warm.items())
            + " ms; "
            f"{live_rows} live rows, flat {row['gbps']['flat']:.0f} GB/s, "
            f"kernel/sdpa {ms['flat'] / lib_ms:.2f}x, host "
            f"{host_us:.2f} us a call; max_abs_err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; vs split arithmetic {split_err:.2e} past rtol; plan {plan}"
            + "; by chunk " + ", ".join(
                f"{c} {t:.4f}" for c, t in row["ms_by_chunk"].items()))
        out.append(row)
        del q, kc, vc, fns
        free_cuda()
    return out


# -- phase 17: the one-card training ladder ----------------------------------

#: (a) gpt2-medium and (b) gpt2-moe-8e at full width, B=8, T=1024, bf16
LADDER_B = 8
LADDER_STEPS = 6
LADDER_POLICIES = ("off", "dots", "dots_no_batch", "full")
MOE_LADDER_POLICIES = ("off", "dots", "dots_moe_act", "dots_moe", "full")
#: (c) graphed draws: 8 steps at k=4 (two replays) against k=1
DRAW_K, DRAW_STEPS = 4, 8
#: (d) BASELINE config #1 (benchmarks/bench_mnist.py:23-50): MNIST B=128,
#: eager, 128 batches an epoch, 3 epochs, the last two timed
NATIVE_MNIST_B, NATIVE_MNIST_BATCHES, NATIVE_MNIST_EPOCHS = 128, 128, 3
PHILOX_SRC = "ray_lightning_tpu_torch/csrc/philox.cu"
#: the dropout site of gpt2-small at B=8, T=1024: the draw's main shape
PHILOX_SHAPE = (TRAIN_B, TRAIN_T, C)


#: gpt2-medium's depth in (a) and gpt2-moe-8e's in (b), cut from 24 and
#: 12 at their full widths to pay for phases 21 and 22 inside the run's
#: time limit
LADDER_MEDIUM_LAYERS = 8
LADDER_MOE_LAYERS = 6


def ladder_config(name: str):
    """``CONFIGS[name]`` cut to its ladder depth."""
    depth = {"gpt2-medium": LADDER_MEDIUM_LAYERS,
             "gpt2-moe-8e": LADDER_MOE_LAYERS}
    return dataclasses.replace(CONFIGS[name], n_layer=depth[name])


def add_counts(total: dict, counts: dict) -> dict:
    """``total`` with each kernel's ``counts`` added to it."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def ladder_module(name: str, policy: str, steps: int = LADDER_STEPS):
    cfg = dataclasses.replace(ladder_config(name), remat=True,
                              remat_policy=policy)
    return GPTLightningModule(cfg, batch_size=LADDER_B, warmup_steps=2,
                              dataset_size=LADDER_B * steps)


def policy_grads(module, seed: int, batch) -> "tuple[dict, int]":
    """One step's gradients of ``module`` from its seeded init cast to
    bf16, as ``module_grads``, and the peak device bytes of the forward
    and backward above what the model held before them."""
    module.init_params(torch.Generator(device="cuda").manual_seed(seed))
    module.model.to(dtype=module.param_dtype)
    params = dict(module.model.named_parameters())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = module.training_step(StepContext(module, training=True), batch)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    torch.cuda.synchronize()
    return grads, torch.cuda.max_memory_allocated() - base


def active_params(model, cfg) -> float:
    """Parameters a token's FLOPs touch: the routed layers' expert
    weights at top_k / n_experts (the JAX package's count,
    benchmarks/bench_native_baseline.py:161-170)."""
    total = moe = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if ".moe." in name:
            moe += p.numel()
    if moe and cfg.n_experts:
        return total - moe + moe * cfg.moe_top_k / cfg.n_experts
    return float(total)


def ladder_policies(name: str, policies: tuple, seed: int, card: str,
                    order: tuple) -> dict:
    """(a) / (b): one step's gradients under each policy bit for bit with
    "off"'s and their peak memory ordered as ``order`` says; then a
    ``LADDER_STEPS`` fit under each policy (finite losses, rows 1 and 6
    once a layer a step, twice for flash_fwd under remat): step ms, MFU
    and peak memory."""
    cfg = ladder_config(name)
    rows = tpu_rows(cfg.block_size, cfg.n_head, cfg.head_dim, True)
    if rows != (1, (6,)):
        raise AssertionError(f"{name}: rows {rows}, want (1, (6,))")
    batch = first_batch(ladder_module(name, "off"))
    ref, peaks = None, {}
    for policy in policies:
        grads, peaks[policy] = policy_grads(ladder_module(name, policy),
                                            seed, batch)
        if ref is None:
            ref = grads
            continue
        check_bitwise(grads, ref, f"{name} {policy}: one step's gradients "
                      f"against 'off'")
        del grads
        free_cuda()
    del ref, batch
    free_cuda()
    log(f"  [{card}] {name} B={LADDER_B} T={cfg.block_size}: gradients "
        f"bit for bit under {list(policies)}; peak bytes of a step "
        + ", ".join(f"{p} {b / 1e9:.3f} GB" for p, b in peaks.items()))
    ordered = [peaks[p] for p in order]
    if ordered != sorted(ordered, reverse=True):
        raise AssertionError(f"{name}: peak memory not ordered "
                             f"{' >= '.join(order)}: {peaks}")
    fits, total = {}, {}
    for policy in policies:
        module = ladder_module(name, policy)
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        trainer, clock = fit(module, LADDER_STEPS, seed)
        launches = _kernels.launch_counts()
        add_counts(total, launches)
        check_fit(clock, trainer, launches, cfg.n_layer, LADDER_STEPS,
                  f"{name} {policy}", remat=policy != "off")
        stats = fit_stats(module, clock, LADDER_B, cfg.block_size, card,
                          first=2)
        if cfg.n_experts:
            # the JAX package's MoE MFU: active parameters, attention as
            # 4 L B T^2 C, times 3 (bench_native_baseline.py:167-170)
            n = active_params(module.model, cfg)
            flops = 3 * (2 * n * LADDER_B * cfg.block_size + 4 * cfg.n_layer
                         * LADDER_B * cfg.block_size ** 2 * cfg.n_embd)
            stats.update(active_params=n, model_flops_per_step=flops,
                         mfu=flops / (stats["step_ms_median"] / 1e3)
                         / BF16_FLOPS_PER_S,
                         moe_aux=float(trainer.callback_metrics["moe_aux"]))
        stats.update(launches=launches, policy=policy,
                     step_peak_bytes=peaks[policy])
        batch = first_batch(module)

        def train_step():
            trainer.state, _ = trainer._train_step(trainer.state, batch)

        # where the step's time goes: device time against the host wall
        stats["profile"] = profile_fn(f"{name} {policy} train step",
                                      train_step, 2)
        log(f"  [{card}] {name} {policy}: step "
            f"{stats['step_ms_median']:.3f} ms (median of steps 3-"
            f"{LADDER_STEPS}), {stats['tokens_per_s']:.0f} tokens/s, MFU "
            f"{stats['mfu']:.4f} ({stats['model_flops_per_step'] / 1e12:.3f}"
            f" TFLOP a step), peak memory {stats['peak_memory_gb']:.2f} GB"
            + (f", moe_aux {stats['moe_aux']:.4f}" if cfg.n_experts else "")
            + "; losses " + " ".join(f"{x:.4f}" for x in clock.losses))
        fits[policy] = stats
        del trainer, module, clock, batch, train_step
        free_cuda()
    return {"fits": fits, "step_peak_bytes": peaks, "rows": rows,
            "launches": total}


def graphed_dots(this, seed: int, base: str) -> dict:
    """(a) continued: gpt2-medium under "dots" at k=4 (a selective
    checkpoint inside a CUDA graph) against its eager k=1 fit bit for
    bit, 8 steps: a replay runs no Python, so this is the step without
    the checkpoint's host cost."""
    cfg = ladder_config("gpt2-medium")
    free_cuda()
    ref = loop_fit(this, ladder_module("gpt2-medium", "dots", DRAW_STEPS),
                   os.path.join(base, "m_ref"), True, 10 ** 9,
                   max_steps=DRAW_STEPS)
    free_cuda()
    run = loop_fit(this, ladder_module("gpt2-medium", "dots", DRAW_STEPS),
                   os.path.join(base, "m_run"), True, 10 ** 9,
                   max_steps=DRAW_STEPS, steps_per_execution=DRAW_K)
    eq = check_loop_fit(run, ref, "(a) gpt2-medium dots graphed", DRAW_K,
                        DRAW_STEPS, {"flash_fwd": 2 * cfg.n_layer * DRAW_K,
                                     "flash_bwd": cfg.n_layer * DRAW_K})
    out = {**loop_line(f"(a) gpt2-medium dots k={DRAW_K}", run, LADDER_B,
                       "sequences"),
           "eager": loop_line("(a) gpt2-medium dots k=1", ref, LADDER_B,
                              "sequences"),
           "launches": add_counts(dict(ref["report"]["launches"]),
                                  run["report"]["launches"]), **eq}
    log(f"  (a) gpt2-medium dots: k={DRAW_K} equals k=1 bit for bit "
        f"({eq['tensors_equal']} tensors, {DRAW_STEPS} losses)")
    del ref, run
    free_cuda()
    return out


def graphed_draws(this, seed: int, base: str) -> dict:
    """(c) gpt2-small at dropout 0.1 and bert-base masked LM at k=4
    against their eager k=1 fits bit for bit (losses, parameters,
    optimizer state), one capture and one replay a chunk, the draw kernel
    launched in each replay as in k eager steps."""
    cfg = dataclasses.replace(CONFIGS["gpt2-small"], dropout=0.1)
    legs = {
        "gpt2-small dropout 0.1": (
            lambda: GPTLightningModule(cfg, batch_size=TRAIN_B,
                                       warmup_steps=2,
                                       dataset_size=TRAIN_B * DRAW_STEPS),
            cfg.n_layer, 2 * cfg.n_layer),
        "bert-base mlm": (
            lambda: BertMLMModule("bert-base", batch_size=BERT_B,
                                  train_size=BERT_B * DRAW_STEPS),
            BERT_CONFIGS["bert-base"].n_layer, 1)}
    out = {"launches": {}}
    for name, (make, layers, draws) in legs.items():
        free_cuda()
        ref = loop_fit(this, make(), os.path.join(base, "d_ref"), True,
                       10 ** 9, max_steps=DRAW_STEPS)
        free_cuda()
        run = loop_fit(this, make(), os.path.join(base, "d_run"), True,
                       10 ** 9, max_steps=DRAW_STEPS,
                       steps_per_execution=DRAW_K)
        per_replay = {"flash_fwd": layers * DRAW_K,
                      "flash_bwd": layers * DRAW_K,
                      "philox_uniform": draws * DRAW_K}
        eq = check_loop_fit(run, ref, f"(c) {name}", DRAW_K, DRAW_STEPS,
                            per_replay)
        if ref["report"]["launches"]["philox_uniform"] \
                != draws * DRAW_STEPS:
            raise AssertionError(f"(c) {name}: the eager fit drew "
                                 f"{ref['report']['launches']} times")
        for rep in (ref["report"], run["report"]):
            add_counts(out["launches"], rep["launches"])
        out[name] = {**loop_line(f"(c) {name} k={DRAW_K}", run, 1, "steps"),
                     "eager": loop_line(f"(c) {name} k=1", ref, 1, "steps"),
                     **eq}
        log(f"  (c) {name}: k={DRAW_K} equals k=1 bit for bit "
            f"({eq['tensors_equal']} tensors, {DRAW_STEPS} losses)")
        del ref, run
    return out


class EpochClock(Callback):
    """Synced wall of each training epoch (its batches' loading
    included), and the losses."""

    def on_fit_start(self, trainer, module):
        self.epochs, self.losses = [], []

    def on_train_epoch_start(self, trainer, module):
        torch.cuda.synchronize()
        self._t0, self._s0 = time.perf_counter(), trainer.global_step

    def on_train_epoch_end(self, trainer, module):
        torch.cuda.synchronize()
        self.epochs.append(((time.perf_counter() - self._t0) * 1e3,
                            trainer.global_step - self._s0))

    def on_train_batch_end(self, trainer, module, outputs, batch, idx):
        self.losses.append(outputs["loss"])


def native_mnist(seed: int) -> dict:
    """(d) BASELINE config #1 eager through the native prefetcher and
    through the Python path in one call: the loaders' batches equal,
    the fits' losses and weights bit for bit, and step ms each (an
    epoch's synced wall over its steps, epochs 2-3)."""
    from ray_lightning_tpu_torch import LightningMNISTClassifier, native

    def module():
        return LightningMNISTClassifier(
            config={"batch_size": NATIVE_MNIST_B},
            train_size=NATIVE_MNIST_B * NATIVE_MNIST_BATCHES)

    loaders = {}
    for path, env in (("native", "1"), ("python", "0")):
        with scoped_env(RLT_NATIVE=env):
            before = native.stats["batches"]
            loaders[path] = [tuple(t.clone() for t in b)
                             for b in module().train_dataloader()]
            served = native.stats["batches"] - before
        if (served > 0) != (path == "native"):
            raise AssertionError(f"(d) the {path} loader: the native "
                                 f"runtime served {served} batches "
                                 f"(build failures "
                                 f"{native.stats['build_failures']})")
    same = len(loaders["native"]) == len(loaders["python"]) and all(
        torch.equal(a, b) for x, y in zip(loaders["native"],
                                          loaders["python"])
        for a, b in zip(x, y))
    if not same:
        raise AssertionError("(d) native and Python batches differ")
    out = {}
    for path, env in (("native", "1"), ("python", "0"), ("native2", "1"),
                      ("python2", "0")):
        with scoped_env(RLT_NATIVE=env):
            clock = EpochClock()
            m = module()
            before = native.stats["batches"]
            trainer = Trainer(max_epochs=NATIVE_MNIST_EPOCHS,
                              enable_checkpointing=False, logger=False,
                              num_sanity_val_steps=0, limit_val_batches=0,
                              seed=seed, callbacks=[clock], device="cuda")
            trainer.fit(m)
            served = native.stats["batches"] - before
        want = NATIVE_MNIST_BATCHES * NATIVE_MNIST_EPOCHS
        if (served == want) != path.startswith("native") or (
                path.startswith("python") and served):
            raise AssertionError(f"(d) {path} fit: the runtime served "
                                 f"{served} of {want} batches")
        ms = [w / n for w, n in clock.epochs[1:]]
        out[path] = {"step_ms": ms, "step_ms_mean": float(np.mean(ms)),
                     "losses": [float(x) for x in clock.losses],
                     "state": {k: v.detach().clone() for k, v in
                               m.model.state_dict().items()},
                     "served": served}
    if out["native"]["losses"] != out["python"]["losses"]:
        raise AssertionError("(d) native and Python fits' losses differ")
    check_bitwise(out["native"]["state"], out["python"]["state"],
                  "(d) native against Python fit")
    for v in out.values():
        del v["state"]
    log(f"  (d) MNIST B={NATIVE_MNIST_B} eager, {NATIVE_MNIST_BATCHES} "
        f"batches x {NATIVE_MNIST_EPOCHS} epochs: batches equal, fits bit "
        f"for bit; step ms (epochs 2-{NATIVE_MNIST_EPOCHS}, loading "
        f"included) native {out['native']['step_ms_mean']:.4f} / "
        f"{out['native2']['step_ms_mean']:.4f}, python "
        f"{out['python']['step_ms_mean']:.4f} / "
        f"{out['python2']['step_ms_mean']:.4f} (native, python, native, "
        f"python)")
    return out


def kernel_philox(gen: torch.Generator) -> dict:
    """(e) ``csrc/philox.cu`` against its plain version bit for bit at
    the main path's shapes (gpt2-small's dropout site, bert-base's MLM
    mask, phase 20's stochastic rounding of a 32 MiB bucket: its
    reduce-scatter's ``[W, blocks, 64]`` rows and its all-gather's one
    row, odd sizes), on the card and on the CPU; timed at gpt2-small's
    dropout site beside ``torch.rand`` of the shape (the yardstick) and
    the bound: 4 bytes written an element (and 16 read) over HBM."""
    from ray_lightning_tpu_torch.ops import random as trandom
    key = torch.randint(0, 2 ** 32, (2,), generator=gen, device="cuda",
                        dtype=torch.int64)
    stream = 0x1234_5678_9ABC
    blocks = COMM_BUCKET // 4 // COMM_RANKS // 64
    for shape in (PHILOX_SHAPE, (BERT_B, 512), (COMM_RANKS, blocks, 64),
                  (1, blocks, 64), (3,), (1023, 5)):
        got = trandom.philox_uniform(key, stream, shape)
        want = trandom.philox_uniform_plain(key, stream, shape)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(
                got.cpu(), trandom.philox_uniform_plain(key.cpu(), stream,
                                                        shape)):
            raise AssertionError(f"philox_uniform {shape}: not the plain "
                                 f"version's bits")
    err = (got - want).abs().max().item()
    n = int(np.prod(PHILOX_SHAPE))
    ms = time_ms(lambda: trandom.philox_uniform(key, stream, PHILOX_SHAPE))
    plain_ms = time_ms(lambda: trandom.philox_uniform_plain(
        key, stream, PHILOX_SHAPE), iters=5)
    lib_ms = time_ms(lambda: torch.rand(PHILOX_SHAPE, device="cuda"))
    b_ms = (4 * n + 16) / HBM_BYTES_PER_S * 1e3
    log(f"  philox_uniform {PHILOX_SHAPE}: bit for bit with its plain "
        f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.rand "
        f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms (bytes), "
        f"{4 * n / (ms / 1e3) / 1e9:.1f} GB/s")
    return {
        "name": "philox_uniform", "row": None, "route": "cuda",
        "source": PHILOX_SRC,
        "replaces": "none (port-only: jax.random draws, "
                    "ray_lightning_tpu/core/module.py:77)",
        "shape": "B=8 T=1024 C=768 float32 (gpt2-small dropout site)",
        "max_abs_err": err, "max_err": err, "tol": 0.0,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": "bytes", "library_ms": lib_ms}


def ladder_phase(seed: int, card: str) -> dict:
    """Phase 17 (module docstring): the one-card training ladder.  Its
    launches are the sum of its fits' (each counted from 0 at the fit's
    start), not the gradient comparisons'."""
    import chip_smoke as this   # loop_fit's probe reports by name
    t_phase = time.monotonic()
    log("  (a) gpt2-medium")
    medium = ladder_policies("gpt2-medium", LADDER_POLICIES, seed, card,
                             LADDER_POLICIES)
    with tempfile.TemporaryDirectory() as base:
        medium["graphed_dots"] = graphed_dots(this, seed, base)
    log("  (b) gpt2-moe-8e")
    moe = ladder_policies("gpt2-moe-8e", MOE_LADDER_POLICIES, seed, card,
                          ("off", "dots_moe", "dots_moe_act", "dots",
                           "full"))
    with tempfile.TemporaryDirectory() as base:
        log("  (c) graphed draws")
        drawn = graphed_draws(this, seed, base)
    log("  (d) native prefetch")
    mnist = native_mnist(seed)
    total = {}
    for counts in (medium["launches"], medium["graphed_dots"]["launches"],
                   moe["launches"], drawn["launches"]):
        add_counts(total, counts)
    for name in ("flash_fwd", "flash_bwd", "philox_uniform"):
        if not total.get(name):
            raise AssertionError(f"the ladder launched {name} no time")
    out = {"launches": total, "gpt2_medium": medium, "gpt2_moe_8e": moe,
           "graphed_draws": drawn, "native_mnist": mnist,
           "seconds": time.monotonic() - t_phase}
    log("ladder " + json.dumps(out, default=str))
    return out


# -- phase 18: sharded training beyond ZeRO-1 ----------------------------

SHARD_MODEL = "gpt2-1p3b"
#: its depth in phase 18, cut from 24 so the whole run fits its time
#: limit with phases 19 and 20 (full width: C=2048, 32 heads, T=2048)
SHARD_LAYERS = 4


def shard_config():
    return dataclasses.replace(CONFIGS[SHARD_MODEL], n_layer=SHARD_LAYERS)
#: (a): FSDP at B=8 in one worker, against the in-process DDP fit
SHARD_B = 8
SHARD_STEPS = 3
#: (b): tensor=2 over two ranks at B=2 (the gloo leg's host traffic is
#: B x T x C bf16 a row-parallel sum), TP_STEPS more steps
TP_B = 2
TP_STEPS = 3
SHARD_TIMEOUT_S = 900
#: F1's bf16 bar: the first step's loss and gradients, and a few steps'
#: losses, against the unsharded step
SHARD_TOL = 2e-2
#: the per-rank bytes a parameter element costs under GPT's AdamW: bf16
#: param, fp32 master, bf16 mu, fp32 nu
STATE_BYTES = {"param": 2, "optimizer": 4 + 2 + 4}
#: the reports of ``ShardProbe``, filled on the driver
SHARD_REPORTS: list = []


def record_shard(report: dict) -> None:
    SHARD_REPORTS.append(report)


def _relay_shard(trainer, report: dict) -> None:
    if trainer.plugin.remote:
        from ray_lightning_tpu_torch import session
        session.put_queue(functools.partial(record_shard, report))
    else:
        record_shard(report)


def _resident_bytes(trainer, module) -> dict:
    from ray_lightning_tpu_torch.core.steps import _state_tensors
    return {"param": sum(p.numel() * p.element_size()
                         for p in module.model.parameters()),
            "optimizer": sum(t.numel() * t.element_size() for t in
                             _state_tensors(trainer.state.opt_state))}


class ShardProbe(Callback):
    """(a) in its worker: each rank's resident parameter and optimizer
    bytes, then a sharded save of the fit's end state (its blocking and
    whole seconds), relayed to ``record_shard``.  Module level, as
    ``chip_smoke.ShardProbe``: the payload is pickled by import path."""

    def __init__(self, ckdir: str):
        self.ckdir = ckdir

    def on_fit_end(self, trainer, module):
        report = {"rank": trainer.global_rank,
                  "resident": _resident_bytes(trainer, module)}
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        t0 = time.perf_counter()
        trainer.save_sharded_checkpoint(self.ckdir)
        trainer.wait_for_checkpoints()
        report.update(save_s=time.perf_counter() - t0,
                      save_stage_s=trainer.checkpoint_stats["save_stage_s"])
        _relay_shard(trainer, report)


def _grads(module, batch, seed: int, step: int):
    """The loss and gradients of the module's train step on ``batch``
    (the step's entropy as the trainer makes it)."""
    ctx = StepContext(module, training=True, rng=(seed, step, 0),
                      device=batch[0].device)
    params = dict(module.model.named_parameters())
    loss = module.training_step(ctx, batch)
    return loss.detach().float(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


class TensorParallelProbe(Callback):
    """(b) in each worker: at the first step's start, the restored blocks
    gathered whole are checked against the checkpoint's parameters (rank
    0 reads them in one process) bit for bit; the first step's loss and
    its gradients gathered whole against the unsharded step's on rank 0
    (its model built from those whole parameters) in per-tensor relative
    L2.  The launches of these checks are taken back from the path's
    count.  Every step's loss, and rank 0's results, are relayed."""

    def __init__(self, ckdir: str, seed: int):
        self.ckdir, self.seed = ckdir, seed

    def on_fit_start(self, trainer, module):
        self.losses, self.checked = [], None
        self.restore_s = trainer.checkpoint_stats.get("restore_s")

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        if self.checked is not None:
            return
        before = _kernels.launch_counts()
        layout = trainer._layout
        dev = trainer.device
        batch = tuple(x.to(dev) for x in batch)
        loss, grads = _grads(module, batch, self.seed, trainer.state.step)
        sync = layout.grad_sync()
        names = list(grads)
        if sync is not None:
            grads = dict(zip(names, sync([grads[n] for n in names])))
        full_p = {n: layout.full_tensor(n, p.detach()) for n, p in
                  module.model.named_parameters()}
        full_g = {n: layout.full_tensor(n, g) for n, g in grads.items()}
        self.checked = {"rank": trainer.global_rank,
                        "heads_per_rank": module.model.h[0].attn.n_head
                        // layout.mesh.shape["tensor"],
                        "restore_s": self.restore_s,
                        "backend": layout.mesh.backend}
        if trainer.global_rank == 0:
            self.checked.update(self._check(trainer, module, layout, batch,
                                            loss, full_p, full_g))
        del full_p, full_g, grads
        after = _kernels.launch_counts()
        _kernels.add_launches({k: before.get(k, 0) - v
                               for k, v in after.items()})
        torch.cuda.empty_cache()

    def _check(self, trainer, module, layout, batch, loss, full_p, full_g):
        import torch.distributed.checkpoint as dcp
        from ray_lightning_tpu_torch.utils.checkpoint import \
            ShardedCheckpointer
        root = ShardedCheckpointer(self.ckdir)
        step = root.latest_step()
        want = {f"params/{n}": torch.empty(layout.params[n].storage,
                                           dtype=p.dtype)
                for n, p in full_p.items()}
        dcp.load(want, storage_reader=dcp.FileSystemReader(
            f"{self.ckdir}/{step}"), no_dist=True)
        restored_equal = all(torch.equal(
            p.cpu().reshape(layout.params[n].storage), want[f"params/{n}"])
            for n, p in full_p.items())
        del want
        ref = GPTLightningModule(module.config,
                                 batch_size=module.batch_size)
        ref.setup_model(trainer.device)
        ref.model.to(dtype=ref.param_dtype)
        ref.model.load_state_dict(full_p)
        ref_loss, ref_g = _grads(ref, batch, self.seed, trainer.state.step)
        errs = grads_rel_l2(full_g, ref_g)
        del ref, ref_g
        worst = max(errs, key=errs.get)
        return {"restored_equal": restored_equal,
                "loss": float(loss), "unsharded_loss": float(ref_loss),
                "grad_rel_l2_max": errs[worst], "grad_worst": worst,
                "grad_tensors": len(errs)}

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        self.losses.append(float(outputs["loss"]))

    def on_fit_end(self, trainer, module):
        _relay_shard(trainer, {**self.checked, "losses": self.losses})


class StateAt(Callback):
    """In process: the whole parameters on the host after global step
    ``at`` (``None``: right after the restore, before any step)."""

    def __init__(self, at: "int | None"):
        self.at, self.state = at, None

    def _take(self, trainer, module):
        self.state = {k: v.to("cpu", copy=True) for k, v in
                      trainer._full_state(module.model).items()}

    def on_train_start(self, trainer, module):
        if self.at is None:
            self._take(trainer, module)

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        if trainer.global_step == self.at:
            self._take(trainer, module)


def _same_state(got: dict, want: dict, what: str) -> None:
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    if set(got) != set(want) or bad:
        raise AssertionError(f"{what}: {len(bad)} tensors differ "
                             f"({bad[:3]}), keys equal {set(got) == set(want)}")


def check_launches(what: str, got: dict, want: dict) -> None:
    """The path's kernels launched as many times as its shape says."""
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _spec_bytes(world: int) -> dict:
    """Each rank's resident bytes at gpt2-1p3b under ``"fsdp"`` on W
    ranks, from the specs (parallel/layout.py on an abstract mesh)."""
    from ray_lightning_tpu_torch.parallel.layout import ShardLayout
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    from ray_lightning_tpu_torch.parallel.strategy import FullyShardedStrategy
    model = GPTLightningModule(shard_config()).configure_model("meta")
    layout = ShardLayout({k: tuple(p.shape) for k, p in
                          model.named_parameters()}, FullyShardedStrategy(),
                         Mesh.abstract(("data",), {"data": world}))
    return {k: layout.local_bytes(b) for k, b in STATE_BYTES.items()}


def _local_fit(module, steps: int, seed: int, root: str, strategy: str,
               ckpt=None, callbacks=()):
    clock = StepClock()
    trainer = Trainer(max_steps=steps, seed=seed, strategy=strategy,
                      callbacks=[clock, *callbacks], device="cuda",
                      default_root_dir=root, enable_checkpointing=False,
                      logger=False, num_sanity_val_steps=0,
                      limit_val_batches=0)
    trainer.fit(module, ckpt_path=ckpt)
    return trainer, clock


def sharded_phase(seed: int, card: str) -> dict:
    """Phase 18 (module docstring): gpt2-1p3b at full width, 8 layers
    under (a) ``RaySpmdPlugin(num_workers=1, strategy="fsdp")`` against
    the in-process DDP fit bit for bit, (b) tensor=2 over two ranks
    (NCCL on two cards, else both on card 0 over gloo) from (a)'s
    sharded checkpoint, against the unsharded step, (c) that checkpoint
    restored in one process and one more step against the uninterrupted
    fit bit for bit.  Its launches are (a)'s, (b)'s two ranks' and
    (c)'s, not the references' or the checks'."""
    import chip_smoke as this
    from ray_lightning_tpu_torch import RaySpmdPlugin
    from ray_lightning_tpu_torch.models.gpt import gpt_partition_rules
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    t_phase = time.monotonic()
    cfg = shard_config()
    L, H32 = cfg.n_layer, cfg.n_head
    rows32 = tpu_rows(cfg.block_size, H32, cfg.head_dim, True)
    rows16 = tpu_rows(cfg.block_size, H32 // 2, cfg.head_dim, True)
    log(f"  tpu_rows H={H32}: {rows32}, H={H32 // 2}: {rows16}")
    total: dict = {}
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory() as base:
        ckdir = os.path.join(base, "sharded")

        def module_a():
            # an epoch of SHARD_STEPS: the save at (a)'s end is at an
            # epoch's end, where a resume and the uninterrupted fit agree
            return GPTLightningModule(cfg, batch_size=SHARD_B,
                                      warmup_steps=2,
                                      dataset_size=SHARD_B * SHARD_STEPS)

        log("  (a) RaySpmdPlugin(num_workers=1, strategy='fsdp')")
        this.SHARD_REPORTS.clear()
        run_a = plugin_fit(this, RaySpmdPlugin(
            num_workers=1, strategy="fsdp", timeout_s=SHARD_TIMEOUT_S),
            module_a(),
            SHARD_STEPS, seed, base, callbacks=[this.ShardProbe(ckdir)])
        [probe_a] = this.SHARD_REPORTS
        rep = run_a["report"]
        want = {"flash_fwd": L * (2 * SHARD_STEPS + rep["val_batches"]),
                "flash_bwd": L * SHARD_STEPS}
        got = {k: rep["launches"].get(k, 0) for k in want}
        check_launches("(a)", got, want)
        add_counts(total, rep["launches"])
        state_a = run_a["module"]._trained_state
        ck_bytes = _dir_bytes(ckdir)
        step_ms = float(np.median(rep["step_ms"][1:]))
        out["a"] = {"step_ms": rep["step_ms"], "step_ms_median": step_ms,
                    "peak_gb": (rep["peak_bytes"] or 0) / 1e9,
                    "resident_bytes_w1": probe_a["resident"],
                    "resident_bytes_from_specs": {
                        w: _spec_bytes(w) for w in (1, 2, 4, 8)},
                    "checkpoint_bytes": ck_bytes,
                    "save_s": probe_a["save_s"],
                    "save_stage_s": probe_a["save_stage_s"],
                    "launches": got}
        log(f"  [{card}] (a) fsdp W=1: step {step_ms:.3f} ms (median of "
            f"steps 2-{SHARD_STEPS}), peak {out['a']['peak_gb']:.2f} GB, "
            f"resident {probe_a['resident']}; sharded save "
            f"{ck_bytes / 1e9:.3f} GB in {probe_a['save_s']:.2f} s "
            f"(blocking {probe_a['save_stage_s']:.2f} s)")
        if probe_a["resident"] != _spec_bytes(1):
            raise AssertionError(f"(a): resident {probe_a['resident']} != "
                                 f"the specs' {_spec_bytes(1)}")

        log("  (a') in-process strategy='ddp', then one more step")
        free_cuda()
        at = StateAt(SHARD_STEPS)
        tr, clock = _local_fit(module_a(), SHARD_STEPS + 1, seed, base,
                               "ddp", callbacks=[at])
        _same_state(state_a, at.state, "(a) fsdp worker vs in-process ddp")
        uninterrupted = {k: v.cpu() for k, v in
                         tr.lightning_module._trained_state.items()}
        out["a"]["ddp_step_ms"] = clock.ms
        del tr, at
        free_cuda()

        log("  (c) the sharded checkpoint restored in one process")
        _kernels.reset_launches()
        first = StateAt(None)
        tr, clock = _local_fit(module_a(), SHARD_STEPS + 1, seed, base,
                               "fsdp", ckpt=ckdir, callbacks=[first])
        add_counts(total, _kernels.launch_counts())
        _same_state(first.state, state_a, "(c) W=1 restore")
        _same_state({k: v.cpu() for k, v in
                     tr.lightning_module._trained_state.items()},
                    uninterrupted, "(c) resumed step vs uninterrupted")
        out["c"] = {"checkpoint_bytes": ck_bytes,
                    "save_s": probe_a["save_s"],
                    "restore_s_w1": tr.checkpoint_stats["restore_s"],
                    "step_ms": clock.ms}
        log(f"  [{card}] (c) restore W=1 {out['c']['restore_s_w1']:.2f} s "
            f"(warm page cache), params bit for bit, one more step bit "
            f"for bit with the uninterrupted fit")
        del tr, first, uninterrupted, state_a
        free_cuda()

        two_cards = torch.cuda.device_count() >= 2
        leg = "nccl" if two_cards else "gloo on card 0"
        log(f"  (b) SpmdStrategy(gpt_partition_rules(), tensor=2) over two "
            f"ranks: {leg}")
        strategy = SpmdStrategy(gpt_partition_rules(),
                                ("data", "fsdp", "tensor"), {"tensor": 2})
        this.SHARD_REPORTS.clear()
        with scoped_env(**({} if two_cards else
                           {"RLT_ONE_CARD_GLOO": "1"})):
            run_b = plugin_fit(this, RaySpmdPlugin(
                num_workers=2, strategy=strategy,
                timeout_s=SHARD_TIMEOUT_S),
                GPTLightningModule(cfg, batch_size=TP_B,
                                   warmup_steps=2),
                SHARD_STEPS + TP_STEPS, seed, base, ckpt=ckdir,
                callbacks=[this.TensorParallelProbe(ckdir, seed)], ranks=2)
        reps = {r["rank"]: r for r in this.SHARD_REPORTS}
        rep = run_b["report"]
        b0 = reps[0]
        want = {"flash_fwd": 2 * L * (2 * TP_STEPS + rep["val_batches"]),
                "flash_bwd": 2 * L * TP_STEPS}
        tp_counts = {k: sum(r["launches"].get(k, 0)
                            for r in run_b["reports"]) for k in want}
        check_launches("(b), both ranks", tp_counts, want)
        if b0["heads_per_rank"] != H32 // 2:
            raise AssertionError(f"(b): {b0['heads_per_rank']} heads a "
                                 f"rank, want {H32 // 2}")
        add_counts(total, tp_counts)
        if not b0["restored_equal"]:
            raise AssertionError("(b): the tensor=2 restore differs from "
                                 "the checkpoint's parameters")
        loss_err = abs(b0["loss"] - b0["unsharded_loss"]) / abs(
            b0["unsharded_loss"])
        log(f"  [{card}] (b) {leg}: restore {b0['restore_s']:.2f} s, params "
            f"bit for bit; first step loss {b0['loss']:.5f} vs unsharded "
            f"{b0['unsharded_loss']:.5f} (rel {loss_err:.2e}), gradients "
            f"max rel L2 {b0['grad_rel_l2_max']:.3e} ({b0['grad_worst']}) "
            f"over {b0['grad_tensors']} tensors (tol {SHARD_TOL}); step ms "
            f"{rep['step_ms']}")
        if loss_err > SHARD_TOL or b0["grad_rel_l2_max"] > SHARD_TOL:
            raise AssertionError(f"(b): the first step is off the "
                                 f"unsharded one: {b0}")

        log("  (b') the unsharded fit from the checkpoint, B=2, in process")
        free_cuda()
        tr, clock = _local_fit(GPTLightningModule(
            cfg, batch_size=TP_B, warmup_steps=2),
            SHARD_STEPS + TP_STEPS, seed, base, "ddp", ckpt=ckdir)
        del tr
        free_cuda()
        rel = [abs(a - b) / abs(b) for a, b in zip(b0["losses"],
                                                   clock.losses)]
        log(f"  (b) losses {b0['losses']} vs unsharded {clock.losses}: "
            f"max rel {max(rel):.2e} (tol {SHARD_TOL})")
        if len(rel) != TP_STEPS or max(rel) > SHARD_TOL:
            raise AssertionError(f"(b): losses off the unsharded fit: "
                                 f"{b0['losses']} vs {clock.losses}")
        out["b"] = {"leg": leg, "step_ms": rep["step_ms"],
                    "step_ms_median": float(np.median(rep["step_ms"][1:])),
                    "peak_gb_rank0": (rep["peak_bytes"] or 0) / 1e9,
                    "restore_s": {r: v["restore_s"] for r, v in
                                  reps.items()},
                    "first_step": {k: b0[k] for k in (
                        "loss", "unsharded_loss", "grad_rel_l2_max",
                        "grad_worst")},
                    "losses": b0["losses"], "unsharded_losses": clock.losses,
                    "launches": tp_counts}
    out.update(launches=total, rows={"H=32": rows32, "H=16": rows16},
               seconds=time.monotonic() - t_phase)
    log("sharded " + json.dumps(out, default=str))
    return out


def sharded_kernel_entries(gen, shapes=((SHARD_B, 1), (TP_B, 2))
                           ) -> "dict[int, dict]":
    """Rows 3 and 9 at the sharded path's shapes ``(B, tensor)``:
    gpt2-1p3b's B=8 at H=32 ((a), (c)) and B=2 at H=16 a rank ((b))."""
    src = "ray_lightning_tpu/ops/flash_attention.py"
    cfg = CONFIGS[SHARD_MODEL]
    res = {f"B={b} H={cfg.n_head // t}": long_kernel_shape(
        gen, b, cfg.block_size, cfg.n_head // t) for b, t in shapes}
    entries = {}
    for row, name, line, key in ((3, "flash_fwd", ":673", "fwd"),
                                 (9, "flash_bwd", ":753", "bwd")):
        first = next(iter(res.values()))[key]
        e = record(name, row, src + line, first["shape"],
                   first["max_abs_err"], first, tol=first["tol"])
        e.update({k: v for k, v in first.items() if k not in e})
        e["by_shape"] = {s: r[key] for s, r in res.items()}
        entries[row] = e
    return entries


# -- phase 19: the sequence, stage and expert axes -------------------------

PAR_RANKS = 4
PAR_STEPS = 3
#: F1's bf16 bar, as phase 18's
PAR_TOL = 2e-2
#: (a)'s context: the long-context example's default
RING_T = 8192
#: (a)'s and (c)'s depth, cut from 12 so the run fits its time limit
PAR_LAYERS = 6
#: (b)'s schedule: the pipeline example's defaults
PIPE_STAGES, PIPE_MICRO, PIPE_B = 4, 4, 8
#: the reports of ``ParallelProbe``, relayed to this process
PAR_REPORTS: list = []


def record_parallel(report: dict) -> None:
    PAR_REPORTS.append(report)


def _reference_module(module):
    """The one-process module of a leg: the same config (the ring's with
    ``attention_impl="flash"``), no mesh."""
    from ray_lightning_tpu_torch.models.pipeline_gpt import PipelinedGPT
    if isinstance(module, PipelinedGPT):
        return PipelinedGPT(module.config,
                            n_microbatches=module.n_microbatches,
                            batch_size=module.batch_size)
    cfg = module.config
    if cfg.attention_impl == "ring":
        cfg = dataclasses.replace(cfg, attention_impl="flash")
    return GPTLightningModule(cfg, batch_size=module.batch_size)


def _routed(model) -> list:
    """The model's routed layers (ops/moe.py ``MoEMLP``), in order."""
    from ray_lightning_tpu_torch.ops.moe import MoEMLP
    return [m for m in model.modules() if isinstance(m, MoEMLP)]


def _free_routing(errs: dict, flips: list) -> dict:
    """The gradients against a reference that routed on its own: the
    worst tensors, and each routed layer's share of tokens whose top-k
    choices differ from this rank's."""
    worst = sorted(errs, key=errs.get, reverse=True)[:4]
    return {"grad_rel_l2_worst": {k: errs[k] for k in worst},
            "tokens_routed_otherwise": flips}


class ParallelProbe(Callback):
    """(19) in each worker of a leg: at the first step's start, this
    rank's loss and gradients of that step, synced as the step syncs
    them and gathered whole; on rank 0 the one-process step on the
    whole batch (a sequence leg's slices joined) from those whole
    weights, with no mesh published, compared in per-tensor relative
    L2 (and ``moe_aux``).  A routed model's reference runs twice: on its
    own top-k choices (reported, with the share of tokens routed
    otherwise: near-tied gates flip under bf16 rounding, and each flip
    moves a token's whole gradient between experts) and on this rank's
    choices (held to the bar).  The checks' launches are taken back from the
    path's count.  Every step's loss, and rank 0's results, are relayed
    to ``record_parallel``.  Module level, as ``chip_smoke.
    ParallelProbe``: the payload is pickled by import path."""

    def __init__(self, seed: int):
        self.seed = seed

    def on_fit_start(self, trainer, module):
        self.losses, self.checked = [], None

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        if self.checked is not None:
            return
        from ray_lightning_tpu_torch.ops.moe import total_aux_loss
        from ray_lightning_tpu_torch.parallel.mesh import (
            all_gather_along, axis_group, set_current_mesh)
        before = _kernels.launch_counts()
        layout, dev = trainer._layout, trainer.device
        batch = tuple(x.to(dev) for x in batch)
        loss, grads = _grads(module, batch, self.seed, trainer.state.step)
        aux = total_aux_loss(module.model)
        names = list(grads)
        sync = layout.grad_sync()
        if sync is not None:
            grads = dict(zip(names, sync([grads[n] for n in names])))
        full_p = {n: layout.full_tensor(n, p.detach()) for n, p in
                  module.model.named_parameters()}
        full_g = {n: layout.full_tensor(n, g) for n, g in grads.items()}
        sp = axis_group("sequence", layout.mesh)
        if sp is not None:
            batch = tuple(all_gather_along(x, 1, sp.group) for x in batch)
        self.checked = {"rank": trainer.global_rank,
                        "backend": layout.mesh.backend,
                        "mesh": dict(layout.mesh.shape)}
        if trainer.global_rank == 0:
            ref = _reference_module(module)
            routes = [m.last_idx for m in _routed(module.model)]
            set_current_mesh(None)
            try:
                ref.setup_model(dev)
                if ref.param_dtype is not None:
                    ref.model.to(dtype=ref.param_dtype)
                ref.model.load_state_dict(full_p)
                ref_loss, ref_g = _grads(ref, batch, self.seed,
                                         trainer.state.step)
                if routes:
                    # the free reference's top-k choices against this
                    # rank's, then the reference again on this rank's
                    # choices: the gradients held to the bar are those
                    # of one routing
                    free = _free_routing(grads_rel_l2(full_g, ref_g), [
                        (m.last_idx != r).any(-1).float().mean().item()
                        for m, r in zip(_routed(ref.model), routes)])
                    self.checked["free_routing"] = free
                    for m, r in zip(_routed(ref.model), routes):
                        m.pinned_idx = r
                    ref_loss, ref_g = _grads(ref, batch, self.seed,
                                             trainer.state.step)
                ref_aux = total_aux_loss(ref.model)
            finally:
                set_current_mesh(layout.mesh)
            errs = grads_rel_l2(full_g, ref_g)
            worst = max(errs, key=errs.get)
            self.checked.update(
                loss=float(loss), unsharded_loss=float(ref_loss),
                grad_rel_l2_max=errs[worst], grad_worst=worst,
                grad_tensors=len(errs),
                moe_aux=None if aux is None else float(aux),
                unsharded_moe_aux=None if ref_aux is None
                else float(ref_aux))
            del ref, ref_g
        del full_p, full_g, grads
        after = _kernels.launch_counts()
        _kernels.add_launches({k: before.get(k, 0) - v
                               for k, v in after.items()})
        torch.cuda.empty_cache()

    def on_train_batch_end(self, trainer, module, outputs, batch, i):
        self.losses.append(float(outputs["loss"]))

    def on_fit_end(self, trainer, module):
        report = {**self.checked, "losses": self.losses}
        if trainer.plugin.remote:
            from ray_lightning_tpu_torch import session
            session.put_queue(functools.partial(record_parallel, report))
        else:
            record_parallel(report)


def parallel_leg(this, name: str, train, local_module, seed: int,
                 base: str, leg: str, **train_kw) -> dict:
    """One leg of phase 19: ``train`` (an example's entry point) over
    ``PAR_RANKS`` workers for ``PAR_STEPS`` steps with the probes, then
    ``local_module`` fit in this process for as many steps; the first
    step's loss and gradients and the losses held within
    ``PAR_TOL``.  Returns the per-rank reports and the checks."""
    this.PROBES.clear()
    this.PAR_REPORTS.clear()
    t0 = time.monotonic()
    train(max_steps=PAR_STEPS, default_root_dir=base,
          callbacks=[this.PluginProbe(), this.ParallelProbe(seed)],
          **train_kw)
    wall = time.monotonic() - t0
    probes = sorted(this.PROBES, key=lambda r: r["rank"])
    reps = {r["rank"]: r for r in this.PAR_REPORTS}
    this.PROBES.clear()
    this.PAR_REPORTS.clear()
    if len(probes) != PAR_RANKS or sorted(reps) != list(range(PAR_RANKS)):
        raise AssertionError(f"({name}): {len(probes)} probe and "
                             f"{sorted(reps)} rank reports")
    r0 = reps[0]
    free_cuda()
    clock = StepClock()
    Trainer(max_steps=PAR_STEPS, seed=seed, callbacks=[clock],
            device="cuda", default_root_dir=base, precision="bf16",
            enable_checkpointing=False, logger=False,
            num_sanity_val_steps=0, limit_val_batches=0).fit(local_module)
    free_cuda()
    loss_err = abs(r0["loss"] - r0["unsharded_loss"]) / abs(
        r0["unsharded_loss"])
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], clock.losses)]
    out = {"leg": leg, "backend": r0["backend"], "mesh": r0["mesh"],
           "wall_s": wall,
           "step_ms": [p["step_ms"] for p in probes],
           "step_ms_median": float(np.median(
               [m for p in probes for m in p["step_ms"][1:]])),
           "peak_gb": [(p["peak_bytes"] or 0) / 1e9 for p in probes],
           "launches": [{k: p["launches"].get(k, 0) for k in
                         ("flash_fwd", "flash_bwd")} for p in probes],
           "first_step": {k: r0[k] for k in (
               "loss", "unsharded_loss", "grad_rel_l2_max", "grad_worst",
               "grad_tensors", "moe_aux", "unsharded_moe_aux")},
           "free_routing": r0.get("free_routing"),
           "losses": r0["losses"], "one_process_losses": clock.losses,
           "one_process_step_ms": clock.ms}
    log(f"  ({name}) {leg}: step {out['step_ms_median']:.1f} ms (median "
        f"of steps 2-{PAR_STEPS} over the ranks), peak "
        f"{', '.join(f'{g:.2f}' for g in out['peak_gb'])} GB a rank; "
        f"first step loss {r0['loss']:.5f} vs one process "
        f"{r0['unsharded_loss']:.5f} (rel {loss_err:.2e}), gradients max "
        f"rel L2 {r0['grad_rel_l2_max']:.3e} ({r0['grad_worst']}) over "
        f"{r0['grad_tensors']} tensors; losses {r0['losses']} vs "
        f"{clock.losses} (tol {PAR_TOL}); launches a rank "
        f"{out['launches']}")
    bad = (loss_err > PAR_TOL or not r0["grad_rel_l2_max"] <= PAR_TOL
           or len(rel) != PAR_STEPS or not max(rel) <= PAR_TOL)
    if r0["moe_aux"] is not None:
        aux_err = abs(r0["moe_aux"] - r0["unsharded_moe_aux"]) / abs(
            r0["unsharded_moe_aux"])
        out["moe_aux_rel"] = aux_err
        log(f"  ({name}) moe_aux {r0['moe_aux']:.5f} vs one process "
            f"{r0['unsharded_moe_aux']:.5f} (rel {aux_err:.2e}); the "
            f"reference on its own routing: {r0['free_routing']}")
        bad = bad or not aux_err <= PAR_TOL
    if bad:
        raise AssertionError(f"({name}): off the one-process run: {out}")
    return out


def parallel_phase(seed: int, card: str) -> dict:
    """Phase 19 (module docstring): the long-context, pipeline and MoE
    examples at their defaults over four ranks (NCCL with four cards,
    else all on card 0 over gloo), each against the one-process run.
    Its launches are (b)'s and (c)'s ranks' (rows 1 and 6 under
    ``pipeline`` and ``moe_ep``), not the references' or the checks'."""
    import chip_smoke as this
    from ray_lightning_tpu_torch.examples import (ray_longcontext_example,
                                                  ray_moe_example,
                                                  ray_pipeline_example)
    from ray_lightning_tpu_torch.models.pipeline_gpt import PipelinedGPT
    t_phase = time.monotonic()
    nccl = torch.cuda.device_count() >= PAR_RANKS
    leg = ("nccl, one rank a card" if nccl else
           "gloo, all four ranks on card 0: every exchange through the "
           "host (a correctness leg, host-bound)")
    small = CONFIGS["gpt2-small"]
    out: dict = {"card": card, "leg": leg}
    with tempfile.TemporaryDirectory() as base, scoped_env(
            **({} if nccl else {"RLT_ONE_CARD_GLOO": "1"})):
        free_cuda()
        T = RING_T
        log(f"  (a) ring attention: gpt2-small at {PAR_LAYERS} layers, "
            f"T={T}, sequence={PAR_RANKS}, B=1 ({leg})")
        out["a"] = parallel_leg(
            this, "a", ray_longcontext_example.train,
            GPTLightningModule(dataclasses.replace(
                small, block_size=T, n_layer=PAR_LAYERS,
                attention_impl="flash"), dataset_size=8, batch_size=1),
            seed, base, leg, seq_len=T, n_layer=PAR_LAYERS)
        Tl, R = T // PAR_RANKS, PAR_RANKS
        kv = 1 * Tl * small.n_embd * 4          # one of k / v, fp32
        out["a"]["ring_bytes_a_step_a_rank"] = PAR_LAYERS * kv * (
            2 * (R - 1) + 4 * (R - 1) + 2)

        L, S, M, B = small.n_layer, PIPE_STAGES, PIPE_MICRO, PIPE_B
        log(f"  (b) pipeline: PipelinedGPT(gpt2-small, n_microbatches={M}),"
            f" stages={S}, B={B}, T={small.block_size} ({leg})")
        out["b"] = parallel_leg(
            this, "b", ray_pipeline_example.train,
            PipelinedGPT("gpt2-small", n_microbatches=M, dataset_size=64,
                         batch_size=B), seed, base, leg)
        # each rank computes M microbatches through its L / S layers, in
        # the forward and in the backward, each step
        per_step = (L // S) * M
        want = {"flash_fwd": per_step * PAR_STEPS,
                "flash_bwd": per_step * PAR_STEPS}
        for r, got in enumerate(out["b"]["launches"]):
            check_launches(f"(b) rank {r}", got, want)
        act = (B // M) * small.block_size * small.n_embd * 2
        out["b"]["launches_formula"] = (
            "flash_fwd = flash_bwd = (n_layer / stages) x microbatches x "
            f"steps = {L // S} x {M} x {PAR_STEPS} a rank")
        out["b"]["bytes_a_step_a_rank"] = {
            "p2p": 2 * (M + S - 1) * act,
            "all_reduce": 2 * B * small.block_size * small.n_embd * 2}

        moe = dataclasses.replace(CONFIGS["gpt2-moe-8e"],
                                  n_layer=PAR_LAYERS)
        log(f"  (c) experts: gpt2-moe-8e at {PAR_LAYERS} layers, expert=2, "
            f"tensor=2, B=8, T={moe.block_size} ({leg})")
        out["c"] = parallel_leg(
            this, "c", ray_moe_example.train,
            GPTLightningModule(moe, dataset_size=64, batch_size=8), seed,
            base, leg, n_layer=PAR_LAYERS)
        # every layer's attention on H/2 heads; "dots" recomputes it in
        # the backward
        fwd = moe.n_layer * (2 if moe.remat and moe.remat_policy != "off"
                             else 1)
        want = {"flash_fwd": fwd * PAR_STEPS,
                "flash_bwd": moe.n_layer * PAR_STEPS}
        for r, got in enumerate(out["c"]["launches"]):
            check_launches(f"(c) rank {r}", got, want)
    out["launches"] = {
        path: {k: sum(r[k] for r in out[x]["launches"])
               for k in ("flash_fwd", "flash_bwd")}
        for path, x in (("pipeline", "b"), ("moe_ep", "c"))}
    out["seconds"] = time.monotonic() - t_phase
    log("parallel " + json.dumps(out, default=str))
    return out


def parallel_kernel_entries(gen) -> "dict[int, dict]":
    """Rows 1 and 6 at phase 19's shapes: a microbatch of (b), B=2
    T=1024 H=12, and a tensor=2 rank of (c), B=8 T=1024 H=6."""
    src = "ray_lightning_tpu/ops/flash_attention.py"
    res = {f"B={b} H={h}": long_kernel_shape(gen, b, 1024, h)
           for b, h in ((PIPE_B // PIPE_MICRO, 12), (8, 6))}
    entries = {}
    for row, name, line, key in ((1, "flash_fwd", ":298", "fwd"),
                                 (6, "flash_bwd", ":329", "bwd")):
        first = next(iter(res.values()))[key]
        e = record(name, row, src + line, first["shape"],
                   first["max_abs_err"], first, tol=first["tol"])
        e.update({k: v for k, v in first.items() if k not in e})
        e["by_shape"] = {s: r[key] for s, r in res.items()}
        entries[row] = e
    return entries


# -- phase 20: the comm plane --------------------------------------------------

COMM_RANKS = 4
#: gpt2-small's depth here, cut from 12 at its full width (phases 21 and
#: 22 fit the run's time limit): a step's time is its collectives, one a
#: gradient tensor or bucket
COMM_LAYERS = 6
COMM_STEPS = 3
COMM_B = 2
COMM_BUCKET = 32 << 20
COMM_TIMEOUT_S = 900
#: the JAX convergence bar: each loss within 5% of the uncompressed
#: fit's (``tests/test_comm.py:331-470``)
COMM_LOSS_BAR = 0.05
#: the fast groups of the hierarchical legs: pairs of ranks
COMM_PAIR = 2
#: the reports of ``CommProbe``, relayed to (or recorded in) this process
COMM_REPORTS: list = []


def record_comm(report: dict) -> None:
    COMM_REPORTS.append(report)


def comm_legs(nccl: bool) -> list:
    """Phase 20's legs: ``(name, zero1, policy kwargs or None, k)``, every
    policy on ``axes=("data",)`` (auto is inert on one host).  int8 flat
    syncs one gradient a collective; the hierarchical and stochastic
    legs sync in the 32 MiB buckets, as a run would (one card's gloo
    pays its host copies and Python on each gradient: gpt2-small has
    148, 76 at ``COMM_LAYERS``)."""
    hier = dict(hierarchy=COMM_PAIR, bucket_bytes=COMM_BUCKET)
    legs = [("none", False, None, 1),
            ("int8", False, dict(compress="int8"), 1),
            ("int8_hier2", False, dict(compress="int8", **hier), 1),
            ("fp8_hier2", False, dict(compress="fp8", **hier), 1),
            ("int4_hier2", False, dict(compress="int4", **hier), 1),
            ("int8_bkt32M", False, dict(compress="int8",
                                        bucket_bytes=COMM_BUCKET), 1),
            ("int8_bkt32M_barrier", False, dict(
                compress="int8", bucket_bytes=COMM_BUCKET,
                barrier_sync=True), 1),
            ("int8_sr", False, dict(compress="int8",
                                    bucket_bytes=COMM_BUCKET,
                                    stochastic_rounding=True), 1),
            ("zero1_int8_pg_bf16", True, dict(
                compress="int8", param_gather="bf16",
                gather_bucket_bytes=COMM_BUCKET), 1)]
    if nccl:
        legs.append(("int8_k2_graphed", False, dict(compress="int8"), 2))
    return legs


def comm_config():
    """gpt2-small at full width (768, vocab 50304, bf16, T=1024) cut to
    ``COMM_LAYERS``."""
    return dataclasses.replace(CONFIGS["gpt2-small"], n_layer=COMM_LAYERS)


def comm_module(cfg=None):
    """``comm_config()`` (``cfg``: the driver's, carried to the workers),
    random weights from the seed, B=2 a rank, one epoch of 3 steps a
    rank."""
    return GPTLightningModule(cfg or comm_config(),
                              batch_size=COMM_B,
                              dataset_size=COMM_B * COMM_RANKS * COMM_STEPS)


def state_digest(state: dict) -> str:
    """sha256 of every tensor's bytes, by name: bit-for-bit equality of
    two states without moving them."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().to("cpu").contiguous()
        h.update(k.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class CommProbe(Callback):
    """(20) in each rank of a leg: per step the synced wall time and the
    loss; at the first step's start the leg's codec over that step's
    local gradients against DDP's fp32 mean of the same gradients (both
    in this rank, the check's launches taken back); the last step's
    collectives recorded (comm/audit.py) beside the byte model of the
    leg's ``GradSync``; the residual's max after the first step; peak
    memory, launches, graph stats, and rank 0's end-state digest.
    Module level, referred to as ``chip_smoke.CommProbe``: a worker
    imports it."""

    def __init__(self, seed: int):
        self.seed = seed

    def _sync(self, trainer):
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    def on_fit_start(self, trainer, module):
        _kernels.reset_launches()
        if trainer.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(trainer.device)
        self.losses, self.step_ms = [], []
        self.grad_check, self.res_max = None, None
        self.window = self.log = None

    def _first_step_check(self, trainer, module, batch) -> dict:
        import torch.distributed as dist

        from ray_lightning_tpu_torch.ops.random import Key, key_words
        from ray_lightning_tpu_torch.parallel.strategy import average_grads
        before = _kernels.launch_counts()
        dev = trainer.device
        batch = tuple(x.to(dev) for x in batch)
        _, grads = _grads(module, batch, self.seed, trainer.state.step)
        local = list(grads.values())
        ref = average_grads(local)
        sync, out = trainer._grad_sync, {}
        if sync is not None:
            residual = ([torch.zeros(g.shape, dtype=torch.float32, device=dev)
                         for g in local] if sync.error_feedback else None)
            key = (Key(torch.from_numpy(key_words(
                self.seed, 1 << 20, trainer.global_rank)).to(dev))
                if sync.policy.stochastic_rounding else None)
            got, _ = sync.sync_step(local, residual, key=key)
            amax = torch.stack([g.float().abs().max() for g in local]).max()
            if dist.get_backend() == "gloo":
                amax = amax.cpu()
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            amax = float(amax)
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, ref)]
            worst = int(np.argmax(errs))
            out = {"max_abs": errs[worst], "tensor": list(grads)[worst],
                   "local_max": amax, "ratio": errs[worst] / amax}
            del got, residual
        del grads, local, ref
        after = _kernels.launch_counts()
        _kernels.add_launches({k: before.get(k, 0) - v
                               for k, v in after.items()})
        return out

    def _zero1_check(self, trainer) -> None:
        """ZeRO-1: the first step's own compressed reduce-scatter
        (``Zero1Optimizer._comm_grad_shards``, wrapped for that one
        call) read back: each group's shard it produced against the same
        slice of DDP's fp32 mean of the step's local gradients."""
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.strategy import average_grads
        opt = trainer._tx.tx

        def capture(grads, d):
            del opt._comm_grad_shards                 # this call only
            local = list(grads.values())
            ref = dict(zip(grads, average_grads([g.float() for g in local])))
            amax = torch.stack([g.float().abs().max() for g in local]).max()
            shards = opt._comm_grad_shards(grads, d)
            if dist.get_backend() == "gloo":
                amax = amax.cpu()
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            errs = {}
            for g, k in zip(opt.groups, opt.keys):
                want = g.flatten([ref[n] for n in g.names])
                if g.shards > 1:
                    want = want[g.lo:g.hi]
                errs[k] = float((shards[k].float() - want).abs().max())
            worst = max(errs, key=errs.get)
            self.grad_check = {"max_abs": errs[worst], "tensor": worst,
                               "local_max": float(amax),
                               "ratio": errs[worst] / float(amax)}
            return shards

        opt._comm_grad_shards = capture

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        if self.grad_check is None:
            sync = trainer._grad_sync
            if sync is not None and sync.zero1:
                self.grad_check = {}        # filled by the step itself
                self._zero1_check(trainer)
            else:
                self.grad_check = self._first_step_check(trainer, module,
                                                         batch)
        if trainer.global_step == COMM_STEPS - 1:
            from ray_lightning_tpu_torch.comm import audit
            self.window = audit.recording()
            self.log = self.window.__enter__()
        self._sync(trainer)
        self.t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self._sync(trainer)
        self.step_ms.append((time.perf_counter() - self.t0) * 1e3)
        self.losses.extend(outputs["loss"].float().reshape(-1).tolist())
        if self.window is not None:
            self.window.__exit__(None, None, None)
            self.window = None
        opt = trainer.state.opt_state
        if self.res_max is None and getattr(opt, "residual", None):
            self.res_max = max(float(r.abs().max())
                               for r in opt.residual.values())

    def on_fit_end(self, trainer, module):
        from ray_lightning_tpu_torch.comm import audit
        sync = trainer._grad_sync
        recs = self.log.records if self.log is not None else []
        tags = sorted({r.tag for r in recs})
        model, draws = None, 0
        if sync is not None:
            if sync.policy.stochastic_rounding:
                # a draw a bucket for each of its two compressed phases
                from ray_lightning_tpu_torch.comm.collectives import (
                    partition_buckets)
                draws = 2 * len(self.step_ms) * len(partition_buckets(
                    [4 * p.numel() for p in module.model.parameters()],
                    sync.policy.bucket_bytes))
            if sync.zero1:
                model = trainer._tx.tx.comm_wire_bytes()
            else:
                model = {"grad_sync": sum(sync.step_wire_bytes(
                    [p.numel() for p in module.model.parameters()]
                ).values())}
        report = {
            "rank": trainer.global_rank,
            "backend": str(trainer._mesh.backend),
            "sync": None if sync is None else sync.describe(),
            "losses": self.losses, "step_ms": self.step_ms,
            "peak_bytes": (torch.cuda.max_memory_allocated(trainer.device)
                           if trainer.device.type == "cuda" else 0),
            "launches": {k: _kernels.launch_counts().get(k, 0)
                         for k in ("flash_fwd", "flash_bwd",
                                   "philox_uniform")},
            "draws_model": draws,
            "grad_check": self.grad_check, "residual_max": self.res_max,
            "wire_bytes": audit.total_wire_bytes(recs),
            "bytes_by_tag": {t: audit.total_wire_bytes(recs, tags=(t,))
                             for t in tags},
            "model_bytes": model,
            "codec_by_link": audit.wire_bytes_by_link(
                recs, COMM_PAIR, dtypes=("s8", "u8", "bf16"),
                tags=("grad_sync",)),
            "f32_by_link": audit.wire_bytes_by_link(
                recs, COMM_PAIR, dtypes=("f32",), ops=(
                    "all-to-all", "all-gather"), tags=("grad_sync",)),
            "graph": {k: trainer.graph_stats.get(k) for k in (
                "captures", "replays", "ungraphed")},
        }
        if trainer.is_global_zero:
            report["digest"] = state_digest(trainer._full_state(
                module.model))
        if trainer.plugin.remote:
            from ray_lightning_tpu_torch import session
            session.put_queue(functools.partial(record_comm, report))
        else:
            record_comm(report)


#: each rank's nested legs, relayed to this process by ``CommLegs``
COMM_RANK_RESULTS: list = []


def record_comm_rank(result: dict) -> None:
    COMM_RANK_RESULTS.append(result)


class CommLegs(Callback):
    """(20) in each ``RayPlugin`` worker, after the off leg's fit: every
    other leg as a ``Trainer(comm_policy=...)`` fit nested in this
    worker, inside the ranks' process group (start-up paid once, as the
    JAX package's worker-side nested fits run), then the link
    calibration (comm/calibrate.py, collective); each rank's
    ``CommProbe`` reports and the calibration go to
    ``record_comm_rank``.  Module level, referred to as
    ``chip_smoke.CommLegs``: a worker imports it."""

    def __init__(self, legs: list, seed: int, cache_dir: str):
        self.legs, self.seed, self.cache_dir = legs, seed, cache_dir
        # this process's config rides to the workers with the callback
        self.cfg = comm_config()

    def on_fit_end(self, trainer, module):
        from ray_lightning_tpu_torch import session
        from ray_lightning_tpu_torch.comm import CommPolicy
        from ray_lightning_tpu_torch.comm.calibrate import calibrated
        dev, out = trainer.device, {"rank": trainer.global_rank}
        with tempfile.TemporaryDirectory() as root:
            for name, zero1, pol, k in self.legs:
                COMM_REPORTS.clear()
                t0 = time.monotonic()
                Trainer(device=dev, strategy="zero1" if zero1 else "ddp",
                        comm_policy=(None if pol is None else CommPolicy(
                            axes=("data",), **pol)),
                        max_steps=COMM_STEPS, steps_per_execution=k,
                        seed=self.seed, callbacks=[CommProbe(self.seed)],
                        enable_checkpointing=False, logger=False,
                        num_sanity_val_steps=0, limit_val_batches=0,
                        default_root_dir=root).fit(comm_module(self.cfg))
                out[name] = {**COMM_REPORTS[-1],
                             "fit_s": time.monotonic() - t0}
                COMM_REPORTS.clear()
                free_cuda()
        out["calibrate"] = calibrated(self.cache_dir, force=True,
                                      device=dev)
        session.put_queue(functools.partial(record_comm_rank, out))


def _median_ms(reports: list) -> float:
    """The median over the ranks of steps 2 to the last (the first pays
    set-up)."""
    return float(np.median([m for r in reports for m in r["step_ms"][1:]]))


def comm_phase(seed: int, card: str, platform: str = "cuda") -> dict:
    """Phase 20 (module docstring): gpt2-small at full width and
    ``COMM_LAYERS`` over four ranks (NCCL with four cards, else all on
    card 0 over gloo) under
    ``RayPlugin(num_workers=4)``: the off leg's fit, then every other
    leg nested in its workers (``CommLegs``); the checks raise.  Its
    launches are every leg's ranks' (rows 1 and 6 under ``comm``), not
    the checks'.  ``platform="cpu"``: every rank a CPU process over
    gloo (a dry run of the phase's code)."""
    import chip_smoke as this
    from ray_lightning_tpu_torch import RayPlugin
    from ray_lightning_tpu_torch.comm import CommPolicy
    from ray_lightning_tpu_torch.comm.selfcheck import PSUM_TOL
    t_phase = time.monotonic()
    nccl = platform != "cpu" and torch.cuda.device_count() >= COMM_RANKS
    leg = ("nccl, one rank a card" if nccl else
           "gloo, all four ranks on card 0: every exchange through the "
           "host (a correctness leg, host-bound)")
    legs = comm_legs(nccl)
    out: dict = {"card": card, "leg": leg, "legs": {}}
    cache_dir = str(ROOT / "build" / "comm_calibration")
    with tempfile.TemporaryDirectory() as base, scoped_env(
            **({} if nccl else {"RLT_ONE_CARD_GLOO": "1"})):
        this.COMM_REPORTS.clear()
        this.COMM_RANK_RESULTS.clear()
        module = comm_module()
        Trainer(plugins=[RayPlugin(num_workers=COMM_RANKS, platform=platform,
                                   timeout_s=COMM_TIMEOUT_S)],
                comm_policy=CommPolicy(), max_steps=COMM_STEPS, seed=seed,
                callbacks=[this.CommProbe(seed),
                           this.CommLegs(legs, seed, cache_dir)],
                enable_checkpointing=False, logger=False,
                num_sanity_val_steps=0, limit_val_batches=0,
                default_root_dir=base).fit(module)
        off = sorted(this.COMM_REPORTS, key=lambda r: r["rank"])
        ranks = sorted(this.COMM_RANK_RESULTS, key=lambda r: r["rank"])
        this.COMM_REPORTS.clear()
        this.COMM_RANK_RESULTS.clear()
        off_digest = state_digest(module._trained_state)
        del module
    if len(off) != COMM_RANKS or len(ranks) != COMM_RANKS:
        raise AssertionError(f"comm phase: {len(off)} off-leg and "
                             f"{len(ranks)} leg reports, want "
                             f"{COMM_RANKS} each")
    out["wall_s"] = time.monotonic() - t_phase
    # -- the checks
    problems = []
    none = [r["none"] for r in ranks]
    if off[0].get("digest") != off_digest or none[0]["digest"] != off_digest:
        problems.append("the off leg's end state differs from the fit "
                        "without a policy")
    if any(r["sync"] is not None for r in off + none):
        problems.append("the off / no-policy legs built a GradSync")
    ref_ms = _median_ms(none)
    base_loss = none[0]["losses"]
    total = {"flash_fwd": 0, "flash_bwd": 0, "philox_uniform": 0}
    for r in off + [x[name] for x in ranks for name, *_ in legs]:
        for k in total:
            total[k] += r["launches"][k]
    for name, zero1, pol, k in legs:
        reps = [x[name] for x in ranks]
        r0 = reps[0]
        res = {"sync": r0["sync"], "backend": r0["backend"],
               "step_ms_median": _median_ms(reps),
               "exposed_comm_ms": _median_ms(reps) - ref_ms,
               "wire_bytes_a_rank_a_step": [r["wire_bytes"] for r in reps],
               "bytes_by_tag": r0["bytes_by_tag"],
               "model_bytes": r0["model_bytes"],
               "peak_gb": [r["peak_bytes"] / 1e9 for r in reps],
               "losses": r0["losses"], "grad_check": r0["grad_check"],
               "residual_max": r0["residual_max"], "graph": r0["graph"],
               "fit_s": [r["fit_s"] for r in reps],
               "launches": [r["launches"] for r in reps]}
        out["legs"][name] = res
        # a graphed leg's capture runs one eager warm-up step first
        n = comm_config().n_layer * (COMM_STEPS + (k > 1))
        for i, r in enumerate(reps):
            want = {"flash_fwd": n, "flash_bwd": n,
                    "philox_uniform": r["draws_model"]}
            if r["launches"] != want:
                problems.append(f"{name} rank {i}: launches {r['launches']}"
                                f", want {want}")
        if pol is None:
            continue
        mode = pol["compress"]
        rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], base_loss)]
        if len(rel) != COMM_STEPS or not max(rel) <= COMM_LOSS_BAR:
            problems.append(f"{name}: losses {r0['losses']} off the "
                            f"uncompressed {base_loss} beyond "
                            f"{COMM_LOSS_BAR}")
        for i, r in enumerate(reps):
            g = r["grad_check"]
            if not g or not g["ratio"] <= PSUM_TOL[mode]:
                problems.append(f"{name} rank {i}: first-step synced "
                                f"gradients {g} beyond {PSUM_TOL[mode]}")
        if not (r0["residual_max"] or 0) > 0:
            problems.append(f"{name}: residual zero after the first step")
        if k == 1:
            for i, r in enumerate(reps):
                got = {t: r["bytes_by_tag"].get(t, 0)
                       for t in r["model_bytes"]}
                if got != r["model_bytes"]:
                    problems.append(f"{name} rank {i}: recorded bytes {got}"
                                    f" != the model {r['model_bytes']}")
                if pol.get("hierarchy") and not (
                        r["codec_by_link"]["ici"] == 0
                        and r["f32_by_link"]["ici"] > 0):
                    problems.append(
                        f"{name} rank {i}: codec {r['codec_by_link']}, "
                        f"f32 {r['f32_by_link']} by link: the pairs' "
                        f"phases must stay fp32")
        elif not (r0["graph"]["captures"] == 1
                  and r0["graph"]["ungraphed"] is None):
            problems.append(f"{name}: graph stats {r0['graph']}")
        log(f"  {name} ({r0['sync']}, {r0['backend']}): step "
            f"{res['step_ms_median']:.1f} ms, exposed comm "
            f"{res['exposed_comm_ms']:+.1f} ms, wire "
            f"{res['wire_bytes_a_rank_a_step'][0] / 1e6:.2f} MB a rank a "
            f"step (model {r0['model_bytes']}), peak "
            f"{max(res['peak_gb']):.2f} GB; first-step gradients "
            f"{r0['grad_check']}; losses {r0['losses']} vs {base_loss} "
            f"[{card}]")
    cal = ranks[0]["calibrate"]
    out["calibrate"] = cal
    if "ici" not in cal.get("measured", ()) or not os.path.exists(
            cal.get("cache") or ""):
        problems.append(f"calibrate measured {cal.get('measured')} "
                        f"({cal.get('ici_error') or cal.get('error')}), "
                        f"cache {cal.get('cache')}")
    log(f"  none: step {ref_ms:.1f} ms; off through RayPlugin: step "
        f"{_median_ms(off):.1f} ms, digest equal: "
        f"{off[0].get('digest') == off_digest == none[0]['digest']}; "
        f"calibrated intra-host {cal.get('ici_gbps')} GB/s over "
        f"{cal.get('backend')} ({cal.get('measured')}) [{card}]")
    out["launches"] = {"comm": total}
    out["seconds"] = time.monotonic() - t_phase
    log("comm " + json.dumps(out, default=str))
    if problems:
        raise AssertionError("comm phase: " + "; ".join(problems))
    return out


def comm_kernel_entries(gen) -> "dict[int, dict]":
    """Rows 1 and 6 at phase 20's shape: a rank's B=2 T=1024 H=12."""
    src = "ray_lightning_tpu/ops/flash_attention.py"
    r = long_kernel_shape(gen, COMM_B, 1024, 12)
    entries = {}
    for row, name, line, key in ((1, "flash_fwd", ":298", "fwd"),
                                 (6, "flash_bwd", ":329", "bwd")):
        e = record(name, row, src + line, r[key]["shape"],
                   r[key]["max_abs_err"], r[key], tol=r[key]["tol"])
        e.update({k: v for k, v in r[key].items() if k not in e})
        e["by_shape"] = {f"B={COMM_B} H=12": r[key]}
        entries[row] = e
    return entries


# -- phase 21: serving under the training strategies -----------------------

SP_MODEL = "gpt2-1p3b"
SP_SLOTS = 8
SP_REQUESTS = 16
#: (b)'s and (c)'s requests, and (a)'s over gloo: one wave of the 8
#: slots.  Over gloo on one card each of (a)'s steps is its host-staged
#: collectives, FSDP moves the model through host copies each step, and
#: each of (c)'s speculative rounds is a draft and a verify
SP_SLOW_REQUESTS = 8
SP_NEW_TOKENS = 24
#: the main legs' prompt lengths; (c)'s prompts share one SP_PREFIX-token
#: prefix (whole pages), then a tail of their own: a prefix hit replays
#: its tail through the suffix step, one call of (c)'s 24 layers over
#: gloo a token.  ``SP_TAIL``'s range for all but the last request
#: (one token: one call), ``SP_LONG_TAIL``'s for the last, whose suffix
#: steps then read the KV rows its own earlier suffix steps wrote
SP_PROMPT_LENS = (100, 1500)
SP_PREFIX = 512
SP_TAIL = (1, 2)
SP_LONG_TAIL = (4, 17)
SP_SPEC_K, SP_DRAFT_LAYERS = 4, 2
SP_PAGE = 16
#: (b), (d) and (e)'s depth over gloo on one card, where every exchange
#: runs through host copies and FSDP moves the model each step (full
#: depth over NCCL)
SP_SHALLOW = 4
#: F1's dot-vs-flash spread at gpt2-small width: a leg's tokens may leave
#: (ref)'s only at a near-tie this close; (a)'s first-step logits lie no
#: farther from the fp32 forward of the same weights than the larger of
#: it and (ref)'s own two bf16 routes (``sp_dot_logits``)
SP_SPREAD = 0.036
SP_TIMEOUT_S = 600.0


def sp_paged_spec() -> dict:
    """(c)'s options: paging (page 16) and speculation (k=4, a 2-layer
    draft)."""
    return {"paged": PageConfig(True, SP_PAGE),
            "spec": SpecConfig(True, k=SP_SPEC_K,
                               draft_layers=SP_DRAFT_LAYERS)}


def sp_tensor2(data: int = 1):
    from ray_lightning_tpu_torch.models.gpt import gpt_partition_rules
    from ray_lightning_tpu_torch.parallel.strategy import SpmdStrategy
    return SpmdStrategy(gpt_partition_rules(), ("data", "tensor"),
                        {"data": data, "tensor": 2})


def sp_prompts(seed: int, vocab: int, shared: bool = False) -> list:
    rng = np.random.default_rng(seed + 2100 + shared)
    if shared:
        prefix = rng.integers(0, vocab, SP_PREFIX)
        tails = rng.integers(*SP_TAIL, SP_SLOW_REQUESTS)
        tails[-1] = rng.integers(*SP_LONG_TAIL)
        return [np.concatenate([prefix, rng.integers(0, vocab, int(n))])
                for n in tails]
    return [rng.integers(0, vocab, int(n))
            for n in rng.integers(*SP_PROMPT_LENS, SP_REQUESTS)]


def param_digest(t: torch.Tensor) -> int:
    """An exact fingerprint of ``t``'s bits: the int64 sum (wrapping) of
    each element's bits times a weight of its position, on its device.
    Equal bits give equal fingerprints; any change, two elements
    swapped included, changes it but for a ~2^-64 chance."""
    flat = t.detach().contiguous().view(-1)
    bits = flat.view({2: torch.int16, 4: torch.int32}[
        flat.element_size()]).long()
    pos = torch.arange(flat.numel(), device=flat.device, dtype=torch.long)
    return int((bits * (pos * 2654435761 % 4294967291 + 1)).sum())


def sp_digests(engine) -> dict:
    """(in a rank, ``Server.call_ranks``) name -> (shape, fingerprint)
    of this rank's pieces."""
    return {n: (tuple(p.shape), param_digest(p))
            for n, p in engine.model.named_parameters()}


def sp_ref_digests(model, strategy, shape: dict, rank: int) -> dict:
    """The same of (ref)'s whole weights as ``rank``'s layout on a mesh
    of ``shape`` cuts them."""
    from ray_lightning_tpu_torch.parallel.mesh import Mesh
    names = tuple(shape)
    layout = strategy.layout(model, Mesh(names, [shape[a] for a in names],
                                         rank))
    out = {}
    for n, p in model.named_parameters():
        local = p.data if layout is None else layout.local_of(n, p.data)
        out[n] = (tuple(local.shape), param_digest(local))
        del local
    return out


def sp_first_logits(engine, prompts: list, served: bool = True):
    """(in a rank, and in process) slot s of this rank's block prefilled
    with prompt ``lo + s`` by the engine's prefill programs, then one
    decode step at the first tokens, eager: its fp32 logits over the
    whole vocab ``[S, V]`` (under tensor the ranks' vocab-split logits
    gathered); with ``served``, the engine's decode program (the one
    that serves) on the same inputs must give their argmax.  Returns
    ``(first tokens, logits)`` from a leader, ``None`` from the others.
    The slots are free again after it (the next prefill rewrites
    them)."""
    lo, _ = engine.slot_block
    firsts, lens = [], []
    for s in range(engine.slots):
        p = prompts[lo + s]
        b = bucket_for(len(p), engine.buckets)
        firsts.append(engine.prefill(s, pad_to_bucket(p, b), len(p), b))
        lens.append(len(p))
    dev = engine.device
    with torch.inference_mode():
        logits = engine.model.decode(
            torch.tensor(firsts, dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            engine._k, engine._v, impl=engine.decode_kernel,
            page_table=engine.page_table)
        out = logits.float().cpu().numpy()
    if served:
        # the program rewrites the rows the eager step wrote, the same
        tokens = engine.decode(np.array(firsts, np.int32),
                               np.array(lens, np.int32))
        if not np.array_equal(tokens, out.argmax(-1)):
            raise AssertionError(
                f"rank {engine.mesh.rank if engine.mesh else 0}: the "
                f"served decode gave {tokens.tolist()}, the eager "
                f"logits' argmax {out.argmax(-1).tolist()}")
    return (firsts, out) if engine.leader else None


def sp_first_logits_bf16_sum(engine, prompts: list):
    """The control of (a)'s logits bar: :func:`sp_first_logits` with
    every row-parallel sum done as bf16 arithmetic would do it (each
    rank's partial rounded to bf16, their sum rounded to bf16) instead
    of the port's fp32 sum rounded once (parallel/tensor.py
    ``row_parallel``).  Eager forwards only see the change: over NCCL
    the prefill's graph keeps the fp32 sum."""
    from ray_lightning_tpu_torch.parallel import tensor as pt
    forward = pt._RowParallel.__dict__["forward"]

    def bf16_sum(ctx, x, w, tp):
        part = pt.mm32(x, w.t()).to(x.dtype).float()
        return pt.all_reduce(part, tp.group).to(x.dtype).float()

    pt._RowParallel.forward = staticmethod(bf16_sum)
    try:
        return sp_first_logits(engine, prompts, served=False)
    finally:
        pt._RowParallel.forward = forward


def sp_dot_logits(model, prompts: list, firsts: list,
                  dtype: "torch.dtype | None" = None) -> np.ndarray:
    """(ref)'s weights through the whole-sequence forward with plain
    attention (``attention_impl="dot"``), teacher-forced over each
    prompt and its first token: the next token's fp32 logits ``[S,
    V]``, F1's "dot" side of the first decode step; with ``dtype``
    (fp32) that forward computed in it, the same bf16 weights upcast."""
    dev = model.wte.weight.device
    cfg = dataclasses.replace(model.config, attention_impl="dot")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    ref = GPT(cfg, device=dev)
    ref.load_state_dict(model.state_dict())
    ref.requires_grad_(False)
    out = []
    with torch.inference_mode():
        for p, t in zip(prompts, firsts):
            x, _ = ref.hidden_with_kv(torch.tensor(
                [[int(v) for v in p] + [int(t)]], device=dev))
            out.append(ref.head(x[0, -1]).float().cpu().numpy())
    del ref
    free_cuda()
    return np.stack(out)


def sp_ref_logits(ref: "SpRef", prompts: list) -> tuple:
    """(ref)'s first decode step's logits at its first ``SP_SLOTS``
    prompts: through its programs (the flash kernels), and through
    plain attention in bf16 and in fp32 (``sp_dot_logits``)."""
    firsts, flash = sp_first_logits(ref.engine, prompts)
    model, head = ref.engine.model, prompts[:SP_SLOTS]
    return (flash, sp_dot_logits(model, head, firsts),
            sp_dot_logits(model, head, firsts, torch.float32))


def sp_logits_check(this, what: str, server, prompts: list,
                    ref_logits: tuple, survey: bool = False) -> dict:
    """A tensor=2 ``Server``'s first decode step's logits
    (``sp_first_logits``) against (ref)'s (``sp_ref_logits``).  Each
    bf16 route's distance from the fp32 forward of the same weights:
    the server's may be no larger than the largest of (ref)'s own two
    routes' (flash kernels, plain attention) and F1's 0.036.  A
    ``survey`` only reads it, and reads beside it the control, the same
    step with bf16 row-parallel sums (``sp_first_logits_bf16_sum``):
    whether the bar sees that change."""
    def leader(fn):
        return next(o for o in server.call_ranks(fn, prompts)
                    if o is not None)[1]

    routes = {"tensor2": leader(this.sp_first_logits)}
    if survey:
        routes["control_bf16_sum"] = leader(this.sp_first_logits_bf16_sum)
    got = routes["tensor2"]
    flash, dot, exact = ref_logits
    routes.update(ref_flash=flash, ref_dot=dot)
    far = {k: float(np.abs(v - exact).max()) for k, v in routes.items()}
    bar = max(SP_SPREAD, far["ref_flash"], far["ref_dot"])
    res = {"max_abs_diff": float(np.abs(got - flash).max()),
           "ref_dot_vs_flash": float(np.abs(dot - flash).max()),
           "from_fp32": far, "bar": bar,
           "argmax_equal": int((got.argmax(-1) == flash.argmax(-1)).sum())}
    if survey:
        res["control_within_bar"] = far["control_bf16_sum"] <= bar
    elif not np.isfinite(got).all() or not far["tensor2"] <= bar:
        raise AssertionError(f"{what}: first-step logits {res}")
    return res


def sp_no_tf32(engine=None) -> tuple:
    """(in a rank, and in process) TF32 off for matmuls and cuDNN: the
    fp32 leg's products in fp32; the flags as set."""
    del engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def sp_fp32_logits(this, seed: int, prompts: list, buckets: tuple,
                   card: str) -> dict:
    """F16's fp32 leg at one seed: gpt2-1p3b in fp32 (``dtype=float32``,
    ``RLT_BF16_PARAMS=0``) with TF32 off, (ref) unsharded in process and
    a tensor=2 ``Server``.  The flash kernels take bf16 only, so an fp32
    model serves through plain attention (``attention_impl="dot"``) and
    the dense decode (``RLT_DECODE_IMPL=dense``).  The tensor=2 first
    decode step's logits (``sp_first_logits``: its prefill and decode
    programs) against the unsharded fp32 forward over the whole sequence
    (``sp_dot_logits``); the bar is (ref)'s own two fp32 routes' distance:
    its engine programs (prefill, then the cached decode) against that
    forward.  Also read: the tensor=2 logits against (ref)'s programs
    (the same route, the row-parallel sums apart), beside the CPU tests'
    fp32 bar of 2e-5.  Read, not gated."""
    cfg = dataclasses.replace(CONFIGS[SP_MODEL], dtype=torch.float32,
                              attention_impl="dot")
    with scoped_env(RLT_BF16_PARAMS="0", RLT_DECODE_IMPL="dense",
                    NVIDIA_TF32_OVERRIDE="0"):
        flags = {"driver": sp_no_tf32()}
        ref = SpRef(seed, cfg.n_layer, buckets, cfg=cfg, decode="dense")
        firsts, engine = sp_first_logits(ref.engine, prompts)
        dot = sp_dot_logits(ref.engine.model, prompts[:SP_SLOTS], firsts)
        del ref
        free_cuda()
        server = Server(GPTLightningModule(cfg), num_workers=2,
                        strategy=sp_tensor2(), buckets=buckets,
                        max_batch_slots=SP_SLOTS, seed=seed)
        server.start()
        try:
            flags["ranks"] = server.call_ranks(this.sp_no_tf32)
            got = next(o for o in server.call_ranks(this.sp_first_logits,
                                                    prompts)
                       if o is not None)[1]
        finally:
            server.shutdown()
    far = float(np.abs(got - dot).max())
    bar = float(np.abs(engine - dot).max())
    res = {"from_fp32_forward": far, "bar_ref_programs_vs_forward": bar,
           "within_bar": far <= bar,
           "tensor2_vs_ref_programs": float(np.abs(got - engine).max()),
           "cpu_bar": 2e-5,
           "argmax_equal": int((got.argmax(-1) == dot.argmax(-1)).sum()),
           "finite": bool(np.isfinite(got).all()), "tf32": flags}
    log(f"  [{card}] seed {seed} fp32: {res}")
    return res


def serve_parallel_logits(seeds: list, card: str) -> dict:
    """``--serve-parallel-logits``: phase 21's check of (a)'s first-step
    logits, and its control, read at each seed: (ref) at full depth in
    process, then (a)'s ``Server`` (tensor=2) started for the probes
    alone; then F16's fp32 leg (``sp_fp32_logits``).  Read, not gated,
    so that every seed reports."""
    import chip_smoke as this
    from ray_lightning_tpu_torch.serve.buckets import resolve_buckets
    cfg = CONFIGS[SP_MODEL]
    buckets = resolve_buckets(None, cfg.block_size)
    nccl = torch.cuda.device_count() >= 4
    out: dict = {"card": card, "seeds": {}}
    with scoped_env(**({} if nccl else {"RLT_ONE_CARD_GLOO": "1"})):
        for seed in seeds:
            prompts = sp_prompts(seed, cfg.vocab_size)
            ref = SpRef(seed, cfg.n_layer, buckets)
            ref_logits = sp_ref_logits(ref, prompts)
            del ref
            free_cuda()
            server = Server(GPTLightningModule(cfg), num_workers=2,
                            strategy=sp_tensor2(), buckets=buckets,
                            max_batch_slots=SP_SLOTS, seed=seed)
            server.start()
            try:
                res = sp_logits_check(this, f"seed {seed}", server,
                                      prompts, ref_logits, survey=True)
            finally:
                server.shutdown()
            log(f"  [{card}] seed {seed}: {res}")
            out["seeds"][seed] = res
            free_cuda()
            res["fp32"] = sp_fp32_logits(this, seed, prompts, buckets, card)
            free_cuda()
    log("serve_parallel_logits " + json.dumps(out))
    return out


class SpRef:
    """(ref): the unsharded engine in this process on card 0, from the
    legs' seed, its programs captured, with (c)'s paging and speculation
    (their programs idle unless a scheduler plans them) on the paged
    decode kernel, which equals the flat one bit for bit (``cfg`` and
    ``decode``: another config and decode route); serves prompts
    through its own scheduler, plain or with (c)'s options, and gives
    teacher-forced logits for the near-tie rule."""

    def __init__(self, seed: int, layers: int, buckets: tuple,
                 cfg=None, decode: str = "paged"):
        cfg = dataclasses.replace(cfg or CONFIGS[SP_MODEL], n_layer=layers)
        with decode_impl(decode):
            self.engine = ServeEngine(
                GPTLightningModule(cfg), buckets=buckets, slots=SP_SLOTS,
                max_seq_len=cfg.block_size, seed=seed, device="cuda",
                **sp_paged_spec()).setup()
        self.layers = layers

    def serve(self, prompts: list, paged_spec: bool = False
              ) -> "tuple[list, dict]":
        eng = self.engine
        sched = Scheduler(buckets=eng.buckets, slots=SP_SLOTS,
                          max_seq_len=eng.max_seq_len,
                          default_max_new_tokens=SP_NEW_TOKENS,
                          **(sp_paged_spec() if paged_spec else {}))
        worker = ServeWorker(eng)
        calls0, secs0 = dict(eng.calls), dict(eng.seconds)
        t0 = time.monotonic()
        reqs = [sched.submit(p) for p in prompts]
        while not sched.idle():
            plan = sched.plan()
            if plan is not None:
                sched.apply(plan, worker.serve_step(plan))
        wall = time.monotonic() - t0
        calls, secs = calls_since(eng, calls0, secs0)
        return [r.result(0).tolist() for r in reqs], {
            "ttft_p50_ms": ttft_ms(reqs), "wall_s": wall,
            "decode_step_ms": per_call_ms(secs, calls, "decode"),
            "tokens_per_s": len(reqs) * SP_NEW_TOKENS / wall,
            "kv_bytes": eng.stats()["kv_bytes"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}

    def gap(self, prompt, got: list, want: list) -> "tuple[int, float]":
        """The first step where ``got`` leaves ``want`` and, teacher-forced
        over their shared prefix, the two tokens' logits apart."""
        n = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        model = self.engine.model
        seq = torch.tensor([[int(t) for t in prompt] + list(got[:n])],
                           device=self.engine.device)
        with torch.inference_mode():
            x, _ = model.hidden_with_kv(seq)
            lg = model.head(x[0, -1]).float()
        return n, abs(float(lg[got[n]] - lg[want[n]]))


def sp_check_tokens(what: str, ref: SpRef, prompts: list, got: list,
                    want: list) -> dict:
    """Each request's tokens equal (ref)'s, or leave them only at a
    near-tie within ``SP_SPREAD`` (F1: bf16 row-parallel sums order
    their terms unlike one GEMM)."""
    equal, gaps = 0, []
    for prompt, a, b in zip(prompts, got, want):
        if len(a) != SP_NEW_TOKENS:
            raise AssertionError(f"{what}: {len(a)} tokens, want "
                                 f"{SP_NEW_TOKENS}")
        if a == b:
            equal += 1
            continue
        n, gap = ref.gap(prompt, a, b)
        gaps.append(gap)
        if not gap <= SP_SPREAD:
            raise AssertionError(
                f"{what}: a request (prompt {len(prompt)}) leaves (ref)'s "
                f"tokens at step {n}, its logits {gap:.4f} apart "
                f"(> {SP_SPREAD})")
    return {"equal": equal, "near_ties": len(gaps),
            "max_gap": max(gaps, default=0.0)}


def sp_check_ranks(what: str, setup: list, final: list, n_layer: int,
                   nccl: bool, spec: bool,
                   require: tuple = ("prefill", "decode")
                   ) -> "tuple[dict, list]":
    """Every rank's serving launches (counted from after its probes)
    match its calls, it ran the ``require``d programs, and its programs
    are graphed over NCCL, eager over gloo with the reason said; returns
    the launches summed and by rank."""
    total = {k: 0 for k in ServeEngine.KERNELS}
    by_rank = []
    for w0, w in zip(setup, final):
        got = {k: w["kernel_launches"][k] - w0["kernel_launches"][k]
               for k in ServeEngine.KERNELS}
        calls = {k: w["calls"][k] - w0["calls"][k] for k in w["calls"]}
        fwd = n_layer * calls["prefill"]
        dec = n_layer * (calls["decode"] + calls["suffix"])
        if spec:
            k1, dl = SP_SPEC_K + 1, SP_DRAFT_LAYERS
            fwd += dl * calls["draft_prefill"]
            dec += k1 * dl * calls["draft"] + k1 * n_layer * calls["verify"]
        paged = w["decode_kernel"] == "paged"
        want = {"flash_fwd": fwd,
                "flash_decode": 0 if paged else dec,
                "flash_decode_paged": dec if paged else 0}
        ran = {"prefill": calls["prefill"],
               "decode": calls["decode"] + calls["verify"]}
        if got != want or not all(ran[k] for k in require):
            raise AssertionError(f"{what}: rank {w['rank']} launched "
                                 f"{got}, its calls {calls} want {want}")
        if nccl and (w["ungraphed"] or not w["captures"]
                     or any(w["recaptures"].values())):
            raise AssertionError(f"{what}: rank {w['rank']} over NCCL: "
                                 f"ungraphed {w['ungraphed']}, captures "
                                 f"{w['captures']}, recaptures "
                                 f"{w['recaptures']}")
        if not nccl and (not w["ungraphed"] or w["captures"]):
            raise AssertionError(f"{what}: rank {w['rank']} over gloo: "
                                 f"ungraphed {w['ungraphed']!r}, captures "
                                 f"{w['captures']}")
        add_counts(total, got)
        by_rank.append(got)
    return total, by_rank


def sp_rank_lines(what: str, card: str, stats: dict, ranks: list) -> None:
    log(f"  [{card}] {what}: TTFT p50 {stats['ttft_p50_ms']:.2f} ms, "
        f"decode step {stats['decode_step_ms']:.3f} ms, "
        f"{stats['tokens_per_s']:.1f} tokens/s, start "
        f"{stats['start_s']:.2f} s, serving {stats['wall_s']:.2f} s; KV "
        + ", ".join(f"{w['kv_bytes'] / 2 ** 20:.1f} MiB" for w in ranks)
        + " a rank; peak memory "
        + ", ".join(f"{w.get('max_memory_allocated', 0) / 1e9:.2f} GB"
                    for w in ranks)
        + "; " + (ranks[0]["ungraphed"] or
                  f"graphed: {sum(ranks[0]['captures'].values())} "
                  f"captures a rank"))


def sp_weights(this, what: str, server, ref: SpRef) -> int:
    """Each rank's pieces equal the matching slices of (ref)'s weights
    bit for bit (fingerprints); the tensors checked."""
    got = server.call_ranks(this.sp_digests)
    n = 0
    for rank, dig in enumerate(got):
        want = sp_ref_digests(ref.engine.model, server.strategy,
                              server.mesh_shape, rank)
        bad = sorted(k for k in want if dig.get(k) != want[k])
        if bad or set(dig) != set(want):
            raise AssertionError(f"{what}: rank {rank}'s pieces differ "
                                 f"from (ref)'s slices: {bad[:6]}")
        n += len(dig)
    free_cuda()
    return n


def sp_kv_share(what: str, ranks: list, ref_kv: int) -> None:
    """Each rank's KV bytes are its block's share of (ref)'s cache."""
    for w in ranks:
        lo, hi = w["slot_block"]
        hlo, hhi = w["head_block"] or (0, CONFIGS[SP_MODEL].n_head)
        share = ref_kv * (hi - lo) * (hhi - hlo) // (
            SP_SLOTS * CONFIGS[SP_MODEL].n_head)
        if w["kv_bytes"] != share:
            raise AssertionError(f"{what}: rank {w['rank']} holds "
                                 f"{w['kv_bytes']} KV bytes, its share of "
                                 f"(ref)'s {ref_kv} is {share}")


def sp_server_leg(this, what: str, server, ref: SpRef, prompts: list,
                  want: list, card: str, nccl: bool, ranks: int,
                  spec: bool = False, ref_logits=None) -> dict:
    """One ``Server`` leg: start, every rank's pieces against (ref)'s,
    (with ``ref_logits``) the first decode step's logits against
    (ref)'s, then the prompts; tokens, launches, graphs, KV share and
    the figures."""
    t0 = time.monotonic()
    server.start()
    start_s = time.monotonic() - t0
    try:
        setup = server.stats()["workers"]
        if len(setup) != ranks or len({w["pid"] for w in setup}) != ranks:
            raise AssertionError(f"{what}: {len(setup)} ranks, want "
                                 f"{ranks}")
        t_chk = time.monotonic()
        tensors = sp_weights(this, what, server, ref)
        res: dict = {"ranks": ranks, "mesh": dict(server.mesh_shape),
                     "tensors_bitwise": tensors}
        if ref_logits is not None:
            res["first_logits"] = sp_logits_check(this, what, server,
                                                  prompts, ref_logits)
        checks_s = time.monotonic() - t_chk
        base = server.stats()["workers"]
        t1 = time.monotonic()
        reqs = [server.submit(p) for p in prompts]
        tokens = [r.result(SP_TIMEOUT_S).tolist() for r in reqs]
        wall = time.monotonic() - t1
        server.drain()
        st = server.stats()
    finally:
        server.shutdown()
    final = st["workers"]
    n_layer = server.module.config.n_layer
    launches, by_rank = sp_check_ranks(what, base, final, n_layer, nccl,
                                       spec)
    lead = next(w for w in final if w["leader"])
    w0 = next(w for w in base if w["rank"] == lead["rank"])
    dec = lead["calls"]["decode"] - w0["calls"]["decode"]
    dsec = lead["seconds"]["decode"] - w0["seconds"]["decode"]
    if spec:
        dec = lead["calls"]["verify"] - w0["calls"]["verify"]
        dsec = sum(lead["seconds"][k] - w0["seconds"][k]
                   for k in ("draft", "verify", "decode"))
    res.update(
        card=card, start_s=start_s, checks_s=checks_s, wall_s=wall,
        ttft_p50_ms=ttft_ms(reqs),
        decode_step_ms=dsec / dec * 1e3 if dec else None,
        tokens_per_s=len(reqs) * SP_NEW_TOKENS / wall,
        kv_bytes=[w["kv_bytes"] for w in final],
        peak_memory=[w.get("max_memory_allocated") for w in final],
        ungraphed=final[0]["ungraphed"], launches=launches,
        launches_by_rank=by_rank,
        tokens=sp_check_tokens(what, ref, prompts, tokens, want),
        scheduler={k: st["scheduler"].get(k) for k in ("pages", "spec")})
    sp_kv_share(what, final, ref.engine.stats()["kv_bytes"])
    sp_rank_lines(what, card, res, final)
    log(f"  {what}: {res['tokens']['equal']} of {len(prompts)} requests "
        f"equal to (ref)'s, {res['tokens']['near_ties']} past a near-tie "
        f"(widest {res['tokens']['max_gap']:.4f}); {tensors} pieces bit "
        f"for bit with (ref)'s slices; launches by rank {by_rank}"
        + (f"; first-step logits {res['first_logits']}"
           if "first_logits" in res else ""))
    return res


def sp_fleet_leg(this, what: str, fleet, ref: SpRef, prompts: list,
                 want: list, card: str, nccl: bool) -> dict:
    """(e): the disaggregated fleet; each replica's ranks as a
    ``Server`` leg's, the shipped rows installed bit for bit."""
    t0 = time.monotonic()
    fleet.start()
    start_s = time.monotonic() - t0
    try:
        reps = sorted(fleet._replicas.values(), key=lambda r: r.role)
        tensors = sum(sp_weights(this, f"{what} {r.role}", r.server, ref)
                      for r in reps)
        base = [r.server.stats()["workers"] for r in reps]
        t1 = time.monotonic()
        handles = [fleet.submit(p) for p in prompts]
        tokens = [h.result(SP_TIMEOUT_S).tolist() for h in handles]
        wall = time.monotonic() - t1
        kv = dict(fleet.status()["fleet"]["kvship"])
        bits = raw_bits(fleet, CONFIGS[SP_MODEL].vocab_size)
        final = [r.server.stats()["workers"] for r in reps]
    finally:
        fleet.shutdown()
    if not kv["ships"] or kv["failovers"]:
        raise AssertionError(f"{what}: kvship {kv}")
    launches, by_rank = {k: 0 for k in ServeEngine.KERNELS}, []
    n_layer = fleet.module.config.n_layer
    for rep, b, f in zip(reps, base, final):
        got, ranks = sp_check_ranks(f"{what} {rep.role}", b, f, n_layer,
                                    nccl, False, require=())
        add_counts(launches, got)
        by_rank += ranks
        sp_kv_share(f"{what} {rep.role}", f, ref.engine.stats()["kv_bytes"])
    ttfts = [h.ttft_s for h in handles if h.ttft_s is not None]
    res = {"card": card, "start_s": start_s, "wall_s": wall,
           "ttft_p50_ms": float(np.percentile(ttfts, 50)) * 1e3,
           "decode_step_ms": None,
           "tokens_per_s": len(handles) * SP_NEW_TOKENS / wall,
           "kvship": {k: kv[k] for k in ("ships", "skipped", "bytes_wire",
                                         "bytes_raw")},
           "bitwise_rows": bits["bitwise_rows"], "tensors_bitwise": tensors,
           "kv_bytes": [w["kv_bytes"] for f in final for w in f],
           "peak_memory": [w.get("max_memory_allocated") for f in final
                           for w in f],
           "launches": launches, "launches_by_rank": by_rank,
           "tokens": sp_check_tokens(what, ref, prompts, tokens, want)}
    dec = [(w["seconds"]["decode"] - w0["seconds"]["decode"],
            w["calls"]["decode"] - w0["calls"]["decode"])
           for rep, b, f in zip(reps, base, final) if rep.role == "decode"
           for w0, w in zip(b, f) if w["leader"]]
    if dec and dec[0][1]:
        res["decode_step_ms"] = dec[0][0] / dec[0][1] * 1e3
    sp_rank_lines(what, card, res, [w for f in final for w in f])
    log(f"  {what}: ships {kv['ships']} (skipped {kv['skipped']}); "
        f"{res['tokens']['equal']} of {len(prompts)} equal to (ref)'s, "
        f"{res['tokens']['near_ties']} near-ties; launches by rank "
        f"{by_rank}")
    return res


def serve_parallel_phase(seed: int, card: str) -> dict:
    """Phase 21 (module docstring): ``Server`` under the training
    strategies at gpt2-1p3b's full width.  Its launches are the legs'
    ranks' while serving, summed (and by rank), not (ref)'s or the
    probes'."""
    import chip_smoke as this
    from ray_lightning_tpu_torch.serve.buckets import resolve_buckets
    t_phase = time.monotonic()
    nccl = torch.cuda.device_count() >= 4
    leg = ("nccl, one rank a card: every program one CUDA graph" if nccl
           else "gloo, every rank on card 0 (RLT_ONE_CARD_GLOO=1): eager "
                "programs, every exchange through host copies")
    cfg = CONFIGS[SP_MODEL]
    vocab = cfg.vocab_size
    shallow = cfg.n_layer if nccl else SP_SHALLOW
    buckets = resolve_buckets(None, cfg.block_size)
    prompts = sp_prompts(seed, vocab)
    shared = sp_prompts(seed, vocab, shared=True)
    out: dict = {"card": card, "leg": leg, "legs": {},
                 "buckets": list(buckets)}
    kw = dict(buckets=buckets, max_batch_slots=SP_SLOTS,
              max_new_tokens=SP_NEW_TOKENS, seed=seed)
    log(f"  (ref) the unsharded engine in process, {cfg.n_layer} layers")
    ref = SpRef(seed, cfg.n_layer, buckets)
    want, out["ref"] = ref.serve(prompts)
    want_shared, out["ref_paged_spec"] = ref.serve(shared, paged_spec=True)
    ref_logits = sp_ref_logits(ref, prompts)
    log(f"  [{card}] (ref): TTFT p50 {out['ref']['ttft_p50_ms']:.2f} ms, "
        f"decode step {out['ref']['decode_step_ms']:.3f} ms, "
        f"{out['ref']['tokens_per_s']:.1f} tokens/s, KV "
        f"{out['ref']['kv_bytes'] / 2 ** 20:.1f} MiB, peak memory "
        f"{out['ref']['peak_memory_gb']:.2f} GB")

    def module(layers):
        return GPTLightningModule(dataclasses.replace(cfg, n_layer=layers))

    # over gloo on one card (a) serves one wave of the slots, as (b) and
    # (c) do: its 24 layers' host-staged collectives set the phase's clock
    n_a = len(prompts) if nccl else SP_SLOW_REQUESTS
    with scoped_env(**({} if nccl else {"RLT_ONE_CARD_GLOO": "1"})):
        log(f"  (a) Server(num_workers=2, tensor=2), {cfg.n_layer} layers, "
            f"{n_a} requests ({leg})")
        out["legs"]["a"] = sp_server_leg(
            this, "(a) tensor=2", Server(module(cfg.n_layer), num_workers=2,
                                         strategy=sp_tensor2(), **kw),
            ref, prompts[:n_a], want[:n_a], card, nccl, 2,
            ref_logits=ref_logits)
        log(f"  (c) tensor=2, paged prefix reuse, speculation k="
            f"{SP_SPEC_K} with a {SP_DRAFT_LAYERS}-layer draft")
        out["legs"]["c"] = sp_server_leg(
            this, "(c) tensor=2 paged+spec", Server(
                module(cfg.n_layer), num_workers=2, strategy=sp_tensor2(),
                worker_env={"RLT_DECODE_IMPL": "paged"}, **sp_paged_spec(),
                **kw),
            ref, shared, want_shared, card, nccl, 2, spec=True)
        # the first request prefills whole; every later one is a prefix
        # hit that computes its tail alone, the long one's included
        pages = out["legs"]["c"]["scheduler"]["pages"]
        tails = [len(p) - SP_PREFIX for p in shared]
        if not pages or pages["reused_prefills"] != len(shared) - 1 \
                or pages["prefill_tokens_computed"] \
                != SP_PREFIX + sum(tails):
            raise AssertionError(f"(c): want {len(shared) - 1} prefix hits "
                                 f"computing their tails {tails[1:]}: "
                                 f"{pages}")
        if shallow != ref.layers:
            del ref
            free_cuda()
            log(f"  (ref) again at {shallow} layers")
            ref = SpRef(seed, shallow, buckets)
            want, out["ref_shallow"] = ref.serve(prompts)
        log(f"  (b) Server(num_workers=1, devices_per_worker=2, "
            f"strategy='fsdp'), {shallow} layers")
        n = SP_SLOW_REQUESTS
        out["legs"]["b"] = sp_server_leg(
            this, "(b) fsdp", Server(module(shallow), num_workers=1,
                                     devices_per_worker=2, strategy="fsdp",
                                     **kw),
            ref, prompts[:n], want[:n], card, nccl, 2)
        log(f"  (d) Server(num_workers=4, data=2 x tensor=2), {shallow} "
            f"layers")
        out["legs"]["d"] = sp_server_leg(
            this, "(d) data=2 x tensor=2", Server(
                module(shallow), num_workers=4,
                strategy=sp_tensor2(data=2), **kw),
            ref, prompts, want, card, nccl, 4)
        log(f"  (e) FleetServer(roles=(prefill, decode)) of two tensor=2 "
            f"replicas, {shallow} layers")
        out["legs"]["e"] = sp_fleet_leg(
            this, "(e) disaggregated tensor=2", FleetServer(
                module(shallow), replicas=2, autoscale=False,
                fleet={"roles": ("prefill", "decode"),
                       "kvship_codec": "raw"},
                num_workers=2, strategy=sp_tensor2(), **kw),
            ref, prompts, want, card, nccl)
    del ref
    free_cuda()
    total = {k: 0 for k in ServeEngine.KERNELS}
    for name, res in out["legs"].items():
        add_counts(total, res["launches"])
    for k in ("flash_fwd", "flash_decode", "flash_decode_paged"):
        if not total[k]:
            raise AssertionError(f"phase 21 launched {k} no time")
    out.update(launches=total, seconds=time.monotonic() - t_phase,
               launches_by_rank={k: v["launches_by_rank"]
                                 for k, v in out["legs"].items()})
    log("serve_parallel " + json.dumps(out, default=str))
    return out


def sp_positions(gen, S: int, L: int) -> torch.Tensor:
    """Decode positions over a cache of ``L`` rows: the ends and tile
    edges first, the rest random."""
    fixed = [0, L - 1, 1023, 1024, 127, 128, 2000, 500][:S]
    rand = torch.randint(0, L, (S - len(fixed),), generator=gen,
                         device="cuda")
    return torch.cat([torch.tensor(fixed, device="cuda"),
                      rand]).to(torch.int32)


def sp_decode_shape(gen, flush, S: int, heads: int, L: int) -> dict:
    """flash_decode and flash_decode_paged (page 16, identity table) at
    one of phase 21's per-rank shapes: each within ``BF16_TOL`` of its
    plain version, the flat kernel within ``SPLIT_TOL`` of the split
    plan's plain arithmetic (L=2048 is new to the plan), the paged one
    equal to it bit for bit; timed with L2 flushed beside SDPA."""
    c = heads * D
    positions = sp_positions(gen, S, L)
    q = torch.randn(S, 1, heads, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    kc = torch.randn(S, L, heads, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    vc = torch.randn(S, L, heads, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    flat = flash_decode_attention(q, kc, vc, positions)
    want = flash_decode_attention_plain(q, kc, vc, positions)
    plan = fd.decode_split_plan(S, heads, L, fd._sm_count(0))
    split = fd.flash_decode_split_plain(q, kc, vc, positions,
                                        plan[0]).float()
    P = L // 16
    ident = torch.arange(S * P, dtype=torch.int32, device="cuda").view(S, P)
    kp, vp = kc.view(S * P, 16, heads, D), vc.view(S * P, 16, heads, D)
    paged = flash_decode_paged_attention(q, kp, vp, positions, ident)
    paged_ref = flash_decode_paged_attention_plain(q, kp, vp, positions,
                                                   ident)
    torch.cuda.synchronize()
    err = (flat.float() - want.float()).abs().max().item()
    perr = (paged.float() - paged_ref.float()).abs().max().item()
    split_err = ((flat.float() - split).abs() - SPLIT_TOL[0]
                 - SPLIT_TOL[1] * split.abs()).max().item()
    shape = f"S={S} L={L} H={heads} D={D}"
    log(f"  {shape}: flash_decode max_abs_err {err:.3e}, split plan "
        f"{plan} excess over the split tolerance {split_err:.3e}; "
        f"flash_decode_paged {perr:.3e}, equal to flash_decode "
        f"{torch.equal(paged, flat)}")
    check_close(f"flash_decode {shape}", err, BF16_TOL)
    check_close(f"flash_decode_paged {shape}", perr, BF16_TOL)
    if not split_err <= 0 or not torch.equal(paged, flat) \
            or not bool(torch.isfinite(flat.float()).all()):
        raise AssertionError(f"{shape}: split excess {split_err}, paged "
                             f"equal {torch.equal(paged, flat)}")
    mask = (torch.arange(L, device="cuda")[None, :]
            <= positions[:, None].long())[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kc, vc))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), flush=flush)
    live = int((positions.long() + 1).sum())
    pages = int((positions.long() // 16 + 1).sum())
    rows = {}
    for name, fn, plain, extra, e in (
            ("flash_decode",
             lambda: flash_decode_attention(q, kc, vc, positions),
             lambda: flash_decode_attention_plain(q, kc, vc, positions),
             0, err),
            ("flash_decode_paged",
             lambda: flash_decode_paged_attention(q, kp, vp, positions,
                                                  ident),
             lambda: flash_decode_paged_attention_plain(q, kp, vp,
                                                        positions, ident),
             pages * 4, perr)):
        b_ms, b_by = bound(2 * S * c * 2 + 2 * live * c * 2 + S * 4 + extra,
                           4 * live * c)
        rows[name] = dict(shape=shape, max_abs_err=e,
                          ms=time_ms(fn, flush=flush),
                          plain_ms=time_ms(plain, flush=flush),
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                          live_rows=live)
        log(f"  {name} {shape}: kernel {rows[name]['ms']:.4f} ms, plain "
            f"{rows[name]['plain_ms']:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}); {live} live rows, L2 flushed")
    return rows


def sp_fwd_shape(gen, T: int, heads: int) -> dict:
    """flash_fwd (row 1) at a prefill of phase 21: B=1, ``T`` tokens,
    ``heads`` heads (16 a tensor rank's, 32 (ref)'s) of the fused qkv,
    causal, against its plain version; timed warm beside SDPA."""
    c = heads * D
    qkv = torch.randn(1, T, 3 * c, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (x.view(1, T, heads, D) for x in qkv.split(c, dim=-1))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    shape = f"B=1 T={T} H={heads} D={D} causal"
    check_close(f"flash_fwd {shape}", err, BF16_TOL)
    check_close(f"flash_fwd lse {shape}", lse_err, LSE_TOL)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = time_ms(lambda: flash_attention_fwd_plain(q, k, v,
                                                         causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    b_ms, b_by = bound(4 * T * c * 2 + heads * T * 4,
                       4 * heads * D * T * (T + 1) / 2)
    log(f"  flash_fwd {shape}: max_abs_err {err:.3e}, lse {lse_err:.3e}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
        f"ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def sp_kernel_entries(gen) -> "dict[int, dict]":
    """Rows 1, 13 and 14 at phase 21's shapes: flash_fwd at B=1, T=512,
    1024 and 2048, H=16 (a tensor rank's prefill) and T=2048 H=32
    ((ref)'s); the decode kernels at S=8 and 4, L=2048, H=16 and 32, one
    entry a row with its first shape's numbers and ``by_shape``."""
    L = CONFIGS[SP_MODEL].block_size
    fwd = {f"T={t} H={h}": sp_fwd_shape(gen, t, h)
           for t, h in ((2048, 16), (1024, 16), (512, 16), (2048, 32))}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dec = {f"S={s} H={h}": sp_decode_shape(gen, flush, s, h, L)
           for s, h in ((8, 16), (8, 32), (4, 16), (4, 32))}
    del flush
    entries = {}
    for row, name, src, by in (
            (1, "flash_fwd", "ray_lightning_tpu/ops/flash_attention.py:298",
             fwd),
            (13, "flash_decode", "ray_lightning_tpu/ops/flash_decode.py:158",
             {k: v["flash_decode"] for k, v in dec.items()}),
            (14, "flash_decode_paged",
             "ray_lightning_tpu/ops/flash_decode.py:166",
             {k: v["flash_decode_paged"] for k, v in dec.items()})):
        first = next(iter(by.values()))
        e = record(name, row, src, first["shape"], first["max_abs_err"],
                   first, source="ray_lightning_tpu_torch/csrc/"
                   + ("flash_fwd.cu" if row == 1 else "flash_decode.cu"))
        e["by_shape"] = by
        entries[row] = e
    return entries


# -- phase 22: the elastic plane ------------------------------------------------

ELASTIC_MODEL = "gpt2-small"
ELASTIC_RANKS = 2
#: a rank's batch; the shrunk fleet's one rank takes both ranks' (4)
ELASTIC_B = 2
ELASTIC_STEPS = 8
ELASTIC_KILL_STEP = 5
ELASTIC_FAULT = f"kill:rank=1,step={ELASTIC_KILL_STEP}"
ELASTIC_SNAPSHOT_EVERY = 2
#: the JAX chaos tests' bar on the final params (``tests/test_failure.py``):
#: bf16 sums in another order across one rank or two; printed beside
#: the bar held here
ELASTIC_TOL = 2e-2
#: the bar held here, on the largest absolute difference: the parity
#: route's shrunk fleet and the clean mirror run the same one-rank
#: program from the same step-5 state (the kernels sum in a fixed
#: order), so they agree to the bit; a step's AdamW update at lr 3e-4
#: in warm-up moves a parameter up to ~2e-4, and a restore that loses
#: the rebuilt moments lies past this bar (``LoseMoments``, the control)
ELASTIC_MIRROR_TOL = 1e-6
ELASTIC_TIMEOUT_S = 600
#: each rank's latest ``ElasticProbe`` report, relayed to this process
ELASTIC_REPORTS: list = []


def record_elastic(report: dict) -> None:
    ELASTIC_REPORTS.append(report)


class ElasticProbe(Callback):
    """(22) in each rank of every fleet: after each step, the rank's
    launches since its fleet started, the step's batch and synced
    seconds, the wall time, and the snapshotter's and the parity
    manager's stats, relayed to the driver (a rank's latest wins, so a
    rank killed at a step's end has sent that step's).  Module level,
    referred to as ``chip_smoke.ElasticProbe``: a worker imports it."""

    def __init__(self, leg: str):
        self.leg = leg

    def _sync(self, trainer):
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    def on_fit_start(self, trainer, module):
        _kernels.reset_launches()
        self.step_s: list = []
        self.first = None
        self.fit_start = time.time()

    def on_train_batch_start(self, trainer, module, batch, batch_idx):
        self._sync(trainer)
        if self.first is None:
            self.first = trainer.global_step
        self.t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        self._sync(trainer)
        self.step_s.append(time.perf_counter() - self.t0)
        es = trainer._elastic_state or {}
        snap = trainer._snapshotter
        red = trainer._redundancy
        report = {
            "leg": self.leg, "attempt": es.get("restarts", 0),
            "rank": trainer.global_rank, "world": trainer.world_size,
            "first_step": self.first, "step": trainer.global_step,
            "batch": int(batch[0].shape[0]), "step_s": list(self.step_s),
            "wall": time.time(), "fit_start": self.fit_start,
            "launches": {k: _kernels.launch_counts().get(k, 0)
                         for k in ("flash_fwd", "flash_bwd")},
            "snapshot": None if snap is None else dict(snap.stats),
            "parity": None if red is None else dict(red.stats),
        }
        if trainer.plugin.remote:
            from ray_lightning_tpu_torch import session
            session.put_queue(functools.partial(record_elastic, report))
        else:
            record_elastic(report)


def elastic_module(batch: int = ELASTIC_B):
    """gpt2-small at full width and depth (12 layers, C=768, T=1024),
    random weights from the seed, its own AdamW (fp32 master, bf16 first
    moments), one epoch of ``ELASTIC_STEPS`` global batches."""
    return GPTLightningModule(
        ELASTIC_MODEL, batch_size=batch,
        dataset_size=ELASTIC_B * ELASTIC_RANKS * ELASTIC_STEPS)


def elastic_fit(this, leg: str, root: str, seed: int, *, workers: int,
                max_steps: int, elastic: dict, fault: "str | None" = None,
                platform: str = "cuda", callbacks: tuple = ()):
    """One ``Trainer(elastic=...).fit`` of ``elastic_module()`` under
    ``RayPlugin(num_workers=workers, strategy="zero1")``."""
    from ray_lightning_tpu_torch import RayPlugin
    module = elastic_module()
    trainer = Trainer(
        plugins=[RayPlugin(num_workers=workers, strategy="zero1",
                           platform=platform,
                           timeout_s=ELASTIC_TIMEOUT_S,
                           worker_env={"RLT_FAULT": fault} if fault else {})],
        max_epochs=10, max_steps=max_steps, seed=seed,
        callbacks=[this.ElasticProbe(leg), *callbacks], elastic=elastic,
        enable_checkpointing=False,
        logger=False, num_sanity_val_steps=0, limit_val_batches=0,
        log_every_n_steps=1, default_root_dir=root)
    t0 = time.monotonic()
    trainer.fit(module)
    return trainer, module, time.monotonic() - t0


def elastic_reports(this, leg: str) -> "dict[tuple, dict]":
    """``(attempt, rank) -> the rank's last report`` of one leg (relayed
    to ``this``, the module a worker's relay names)."""
    out: dict = {}
    for r in this.ELASTIC_REPORTS:
        if r["leg"] == leg:
            out[(r["attempt"], r["rank"])] = r
    return out


def check_elastic_fleets(leg: str, reps: dict, resumed: int,
                         problems: list) -> dict:
    """Each fleet's ranks: the batch and world it ran at (2 ranks at
    ``ELASTIC_B``, then one at twice that), and rows 1 and 6 launched
    ``n_layer`` times a step it ran; their launches, summed."""
    n_layer = CONFIGS[ELASTIC_MODEL].n_layer
    fleets = {0: (ELASTIC_RANKS, ELASTIC_B),
              1: (1, ELASTIC_B * ELASTIC_RANKS)}
    total = {"flash_fwd": 0, "flash_bwd": 0}
    for attempt, (world, batch) in fleets.items():
        ranks = sorted(r for a, r in reps if a == attempt)
        if ranks != list(range(world)):
            problems.append(f"{leg} fleet {attempt}: reports from ranks "
                            f"{ranks}, want {world}")
            continue
        for rank in ranks:
            r = reps[(attempt, rank)]
            ran = r["step"] - r["first_step"]
            want = {"flash_fwd": n_layer * ran, "flash_bwd": n_layer * ran}
            if (r["world"], r["batch"]) != (world, batch) \
                    or r["launches"] != want or not ran:
                problems.append(
                    f"{leg} fleet {attempt} rank {rank}: world {r['world']}"
                    f" batch {r['batch']} launches {r['launches']} over "
                    f"{ran} steps, want world {world} batch {batch} "
                    f"launches {want}")
            for k in total:
                total[k] += r["launches"][k]
        first = reps[(attempt, 0)]["first_step"]
        if attempt == 1 and first != resumed:
            problems.append(f"{leg}: the shrunk fleet started at step "
                            f"{first}, resumed at {resumed}")
    return total


def elastic_tick_lines(leg: str, rep: dict, reps: dict, card: str) -> None:
    """The parity ticks' wire bytes and seconds against the declared
    bytes, each snapshot's seconds, and the recovery's seconds."""
    for (attempt, rank), r in sorted(reps.items()):
        par, snap = r["parity"], r["snapshot"]
        if par:
            ticks = ", ".join(
                f"{b / 1e6:.1f} MB in {s:.3f} s ("
                + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + ")"
                for b, s, parts in zip(
                    par["parity_tick_bytes"], par["parity_tick_seconds"],
                    par["parity_tick_parts"]))
            log(f"  {leg} fleet {attempt} rank {rank}: parity ticks [{ticks}]"
                f" against {par.get('declared_parity_bytes', 0) / 1e6:.1f} "
                f"MB declared a step; skipped {par['parity_skipped']} "
                f"[{card}]")
        if snap:
            log(f"  {leg} fleet {attempt} rank {rank}: snapshots "
                f"{snap['snapshots']} (skipped {snap['skipped']}, failed "
                f"{snap['failed']}), blocking seconds each "
                f"{[round(x, 3) for x in snap['save_seconds_each']]}, stalls "
                f"{snap['stall_seconds']:.3f} s; step seconds "
                f"{[round(x, 3) for x in r['step_s']]} [{card}]")


class MirrorSave(Callback):
    """(22) in each rank of the replay route's first fleet: at the kill
    step, before the fault fires (the fault injector runs after the
    caller's callbacks), a sharded save of the state, waited for: the
    first half of the parity route's clean mirror (two ranks, no fault
    yet, to that step).  The fleet's snapshot in flight is waited for
    first, so the two checkpointers' collectives do not interleave."""

    needs_batch = False

    def __init__(self, step: int, directory: str):
        self.step, self.directory = step, directory

    def on_train_batch_end(self, trainer, module, outputs, batch, batch_idx):
        if trainer.global_step == self.step \
                and not (trainer._elastic_state or {}).get("restarts"):
            trainer.wait_for_checkpoints()
            trainer.save_sharded_checkpoint(self.directory)
            trainer.wait_for_checkpoints()


class LoseMoments(Callback):
    """(22) the mirror's planted control: after the restore, rank 1's
    half of the first moments (the second half of each ZeRO-1 flat
    vector, rank 1's shard at two ranks) set to 0, as a recovery that
    lost the rebuilt shard's moments would leave them."""

    needs_batch = False

    def on_train_start(self, trainer, module):
        state = trainer.state.opt_state
        while not hasattr(state, "mu"):
            state = state.inner
        for flat in state.mu.values():
            flat = flat.view(-1)
            flat[flat.numel() - flat.numel() // 2:].zero_()


def elastic_mirror(seed: int, platform: str, mirror: str, root: str,
                   control: bool = False) -> "dict[str, torch.Tensor]":
    """The clean mirror's second half, in this process: one rank at the
    doubled batch from the two-rank step-5 state to step 8; its final
    params (``control``: with ``LoseMoments``)."""
    module = elastic_module(ELASTIC_B * ELASTIC_RANKS)
    Trainer(device=platform, strategy="zero1", max_epochs=10,
            max_steps=ELASTIC_STEPS, seed=seed,
            resume_from_checkpoint=os.path.join(mirror,
                                                str(ELASTIC_KILL_STEP)),
            callbacks=[LoseMoments()] if control else [],
            enable_checkpointing=False, logger=False,
            num_sanity_val_steps=0, limit_val_batches=0,
            default_root_dir=root).fit(module)
    return {k: v.float().cpu() for k, v in module._trained_state.items()}


def max_abs_gap(got: dict, want: dict) -> "tuple[float, str | None]":
    """The largest absolute difference over the tensors of ``got`` and
    ``want`` (which must name the same tensors), and its tensor's
    name."""
    if set(got) != set(want):
        raise AssertionError(f"the states name other tensors: "
                             f"{sorted(set(got) ^ set(want))[:4]}")
    worst, worst_k = -1.0, None
    for k, w in want.items():
        d = float((got[k] - w).abs().max())
        if d > worst:
            worst, worst_k = d, k
    return worst, worst_k


def elastic_phase(seed: int, card: str, platform: str = "cuda") -> dict:
    """Phase 22 (module docstring): ``Trainer(max_steps=8, elastic=...)``
    of gpt2-small under ``RayPlugin(num_workers=2, strategy="zero1")``
    with rank 1 killed at step 5 (``RLT_FAULT``), over NCCL with two
    cards, else both ranks on card 0 over gloo.  The replay route
    (redundancy off), held to its route, resumed step and restore count;
    its first fleet also saves its state at step 5, before the kill
    (``MirrorSave``).  The parity route (``redundancy=1``), against a
    clean mirror: that step-5 state (two ranks, fault-free to there),
    then one rank at batch 4 in this process to step 8.  The checks
    raise.  ``platform="cpu"``: every rank a CPU process over gloo (a
    dry run of the phase's code)."""
    import chip_smoke as this
    t_phase = time.monotonic()
    nccl = platform != "cpu" \
        and torch.cuda.device_count() >= ELASTIC_RANKS
    out: dict = {"card": card, "model": ELASTIC_MODEL,
                 "leg": ("nccl, one rank a card" if nccl else
                         "gloo, both ranks on card 0"), "legs": {}}
    problems: list = []
    total = {"flash_fwd": 0, "flash_bwd": 0}
    this.ELASTIC_REPORTS.clear()
    with tempfile.TemporaryDirectory() as base, scoped_env(
            **({} if nccl else {"RLT_ONE_CARD_GLOO": "1"})):
        # -- the replay route, and the mirror's first half
        mirror = os.path.join(base, "mirror")
        trainer, module, fit_s = elastic_fit(
            this, "replay", os.path.join(base, "replay"), seed,
            workers=ELASTIC_RANKS, max_steps=ELASTIC_STEPS,
            fault=ELASTIC_FAULT, platform=platform,
            elastic={"snapshot_every_n_steps": ELASTIC_SNAPSHOT_EVERY,
                     "snapshot_dir": os.path.join(base, "replay_snap"),
                     "max_restarts": 2},
            callbacks=[this.MirrorSave(ELASTIC_KILL_STEP, mirror)])
        del module
        rep = trainer._elastic_report
        reps = elastic_reports(this, "replay")
        if rep.get("recovery") != "replay" \
                or rep.get("resumed_step") not in (2, 4) \
                or rep.get("snapshot_restores", 0) != 1 \
                or trainer.global_step != ELASTIC_STEPS:
            problems.append(f"replay route: report {rep}, global step "
                            f"{trainer.global_step}")
        else:
            counts = check_elastic_fleets("replay", reps,
                                          rep["resumed_step"], problems)
            for k in total:
                total[k] += counts[k]
        log(f"  replay route: fit {fit_s:.1f} s; recovery "
            f"{rep.get('recovery')} from step {rep.get('resumed_step')}, "
            f"snapshot restores {rep.get('snapshot_restores', 0)}, "
            f"recovery {rep.get('recovery_seconds', float('nan')):.2f} s "
            f"[{card}]")
        elastic_tick_lines("replay", rep, reps, card)
        out["legs"]["replay"] = {
            "fit_s": fit_s, "report": rep,
            "fleets": {f"{a}/{r}": v for (a, r), v in reps.items()}}
        free_cuda()

        # -- the parity route
        trainer, module, fit_s = elastic_fit(
            this, "parity", os.path.join(base, "parity"), seed,
            workers=ELASTIC_RANKS, max_steps=ELASTIC_STEPS,
            fault=ELASTIC_FAULT, platform=platform,
            elastic={"snapshot_every_n_steps": ELASTIC_SNAPSHOT_EVERY,
                     "snapshot_dir": os.path.join(base, "parity_snap"),
                     "max_restarts": 2, "redundancy": 1})
        rep = trainer._elastic_report
        reps = elastic_reports(this, "parity")
        got = {k: v.float().cpu() for k, v in module._trained_state.items()}
        del module
        if (rep.get("recovery"), rep.get("resumed_step"),
                rep.get("snapshot_restores", 0), trainer.global_step,
                rep.get("workers"), rep.get("failed_fleet_parity_ticks")
                ) != ("parity", ELASTIC_KILL_STEP, 0, ELASTIC_STEPS, 1,
                      ELASTIC_KILL_STEP):
            problems.append(f"parity route: report {rep}, global step "
                            f"{trainer.global_step}")
        if not rep.get("dead_digest") \
                or rep.get("dead_digest") != rep.get("escrowed_digest"):
            problems.append(f"parity route: rebuilt shard "
                            f"{rep.get('dead_digest')} != escrowed "
                            f"{rep.get('escrowed_digest')}")
        rebuilt = rep.get("rebuilt_leaves") or {}
        if "bfloat16" not in rebuilt.values():
            problems.append(f"parity route: no bf16 moment among the "
                            f"rebuilt leaves {rebuilt}")
        counts = check_elastic_fleets("parity", reps, ELASTIC_KILL_STEP,
                                      problems)
        for k in total:
            total[k] += counts[k]
        dead = reps.get((0, 1))
        first_wall = trainer.first_step_wall
        from_kill = (first_wall - dead["wall"]
                     if dead and first_wall else None)
        log(f"  parity route: fit {fit_s:.1f} s; recovery "
            f"{rep.get('recovery')} at step {rep.get('resumed_step')}, "
            f"snapshot restores {rep.get('snapshot_restores', 0)}; rank 1's "
            f"shard rebuilt {rep.get('dead_digest')} vs escrowed "
            f"{rep.get('escrowed_digest')} (leaves {rebuilt}); recovery "
            f"{rep.get('recovery_seconds', float('nan')):.2f} s from the "
            f"driver's catch (probe and harvest "
            f"{rep.get('probe_and_harvest_seconds') or 0:.2f} s, rebuild "
            f"{rep.get('reconstruct_seconds') or 0:.2f} s), "
            f"{from_kill if from_kill is None else round(from_kill, 2)} s "
            f"from the kill to the shrunk fleet's first step [{card}]")
        elastic_tick_lines("parity", rep, reps, card)
        out["legs"]["parity"] = {
            "fit_s": fit_s, "report": rep, "from_kill_s": from_kill,
            "fleets": {f"{a}/{r}": v for (a, r), v in reps.items()}}
        free_cuda()

        # -- the mirror's second half: one rank at the doubled batch from
        # the replay fleet's step-5 state, here; then the control, which
        # the bar must see
        t0 = time.monotonic()
        want = elastic_mirror(seed, platform, mirror,
                              os.path.join(base, "mirror_fit"))
        ref_s = time.monotonic() - t0
        worst, worst_k = max_abs_gap(got, want)
        if worst > ELASTIC_MIRROR_TOL:
            problems.append(f"parity route: params {worst:.3e} ({worst_k}) "
                            f"from the clean mirror, past "
                            f"{ELASTIC_MIRROR_TOL}")
        del want
        t0 = time.monotonic()
        lost, lost_k = max_abs_gap(got, elastic_mirror(
            seed, platform, mirror, os.path.join(base, "control_fit"),
            control=True))
        control_s = time.monotonic() - t0
        if lost <= ELASTIC_MIRROR_TOL:
            problems.append(f"parity route: the control (rank 1's first "
                            f"moments lost) lies {lost:.3e} from it, within "
                            f"the bar {ELASTIC_MIRROR_TOL}")
        log(f"  parity route against the clean mirror (two ranks to step "
            f"{ELASTIC_KILL_STEP}, saved by the replay route's first fleet "
            f"before its kill; one rank at batch "
            f"{ELASTIC_B * ELASTIC_RANKS} to {ELASTIC_STEPS} here, "
            f"{ref_s:.1f} s): max abs diff {worst:.3e} ({worst_k}), bar "
            f"{ELASTIC_MIRROR_TOL} (the JAX chaos tests' {ELASTIC_TOL} as "
            f"atol = rtol); the control, rank 1's first moments lost at "
            f"the restore ({control_s:.1f} s): {lost:.3e} ({lost_k}) "
            f"[{card}]")
        out["legs"]["parity"].update(
            max_abs_diff=worst, worst=worst_k, mirror_s=ref_s,
            control_max_abs_diff=lost, control_worst=lost_k,
            control_s=control_s)
        del got
    this.ELASTIC_REPORTS.clear()
    out["launches"] = total
    out["seconds"] = time.monotonic() - t_phase
    log("elastic " + json.dumps(out, default=str))
    if problems:
        raise AssertionError("elastic phase: " + "; ".join(problems))
    return out


def elastic_kernel_entries(gen) -> "dict[int, dict]":
    """Rows 1 and 6 at the shrunk fleet's shape: one rank's B=4 T=1024
    H=12 (the two-rank fleet's B=2 is phase 20's)."""
    src = "ray_lightning_tpu/ops/flash_attention.py"
    B = ELASTIC_B * ELASTIC_RANKS
    r = long_kernel_shape(gen, B, 1024, 12)
    entries = {}
    for row, name, line, key in ((1, "flash_fwd", ":298", "fwd"),
                                 (6, "flash_bwd", ":329", "bwd")):
        e = record(name, row, src + line, r[key]["shape"],
                   r[key]["max_abs_err"], r[key], tol=r[key]["tol"])
        e.update({k: v for k, v in r[key].items() if k not in e})
        e["by_shape"] = {f"B={B} H=12": r[key]}
        entries[row] = e
    return entries


def check_actor_starts() -> None:
    """Every actor of the run forked from the backend's fork server
    (cluster/forkserver.py): none fell back to a fresh interpreter."""
    from ray_lightning_tpu_torch.cluster import get_backend
    stats = get_backend().start_stats()
    log(f"actor starts: {stats['forked']} forked, {stats['spawned']} "
        f"spawned; the fork server's imports {stats['preload_s']:.1f} s")
    if stats["spawned"] or not stats["forked"]:
        raise AssertionError(f"actors spawned past the fork server: {stats}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fwd-only", action="store_true",
                    help="build, then flash_fwd alone at the row 1-5 "
                         "shapes (fwd_rows); no path is driven")
    ap.add_argument("--bwd-only", action="store_true",
                    help="build, then flash_bwd alone at the row 6-12, "
                         "15, 16 shapes (bwd_rows); no path is driven")
    ap.add_argument("--decode-only", action="store_true",
                    help="build, then flash_decode and flash_decode_paged "
                         "alone at the row 13-14 shapes (decode_rows); no "
                         "path is driven")
    ap.add_argument("--trainer-only", action="store_true",
                    help="build, check and time flash_fwd and flash_bwd "
                         "(rows 1 and 6), then run phase 10 (the trainer: "
                         "checkpoint and resume, predict, dropout) alone")
    ap.add_argument("--plugin-only", action="store_true",
                    help="build, run phase 11 (RayPlugin and "
                         "RayShardedPlugin) with the driver off CUDA, then "
                         "check and time flash_fwd and flash_bwd (rows 1 "
                         "and 6)")
    ap.add_argument("--resnet-only", action="store_true",
                    help="build, run phase 13 (resnet50 under RayPlugin "
                         "and in process, the sharded example) with the "
                         "driver off CUDA until its worker fits end, then "
                         "check and time flash_fwd and flash_bwd (rows 1 "
                         "and 6)")
    ap.add_argument("--loop-only", action="store_true",
                    help="build, run phase 14 (the loop engine: MNIST "
                         "k=1/32/64+cache, resnet50 k=8+cache in process "
                         "and in one RayPlugin worker, gpt2-small k=4) with "
                         "the driver off CUDA until its worker fit ends, "
                         "then check and time flash_fwd and flash_bwd (rows "
                         "1 and 6)")
    ap.add_argument("--server-only", action="store_true",
                    help="build, run phase 15 (Server over one serve "
                         "actor) with the driver off CUDA, then phase 3 "
                         "in process for its tokens, then check and time "
                         "flash_fwd and flash_decode (rows 1 and 13)")
    ap.add_argument("--fleet-only", action="store_true",
                    help="build, run phase 16 (FleetServer: pooled, "
                         "disaggregated raw and fp8, federation, "
                         "autoscale, failover) with the driver off CUDA, "
                         "then its near-tie checks, then check and time "
                         "flash_fwd, flash_decode and flash_decode_paged "
                         "(rows 1, 13 and 14)")
    ap.add_argument("--ladder-only", action="store_true",
                    help="build, check and time flash_fwd, flash_bwd and "
                         "philox_uniform, then run phase 17 (the one-card "
                         "training ladder: gpt2-medium and gpt2-moe-8e "
                         "under the remat policies, graphed draws, the "
                         "native prefetcher) alone")
    ap.add_argument("--sharded-only", action="store_true",
                    help="build, run phase 18 (gpt2-1p3b: FSDP under "
                         "RaySpmdPlugin against DDP, tensor=2 over two "
                         "ranks, the sharded checkpoint), then check and "
                         "time flash_fwd and flash_bwd at its shapes "
                         "(rows 3 and 9)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="build, run phase 19 (ring attention, the GPipe "
                         "pipeline and expert parallelism over four ranks), "
                         "then check and time flash_fwd and flash_bwd at "
                         "its shapes (rows 1 and 6)")
    ap.add_argument("--comm-only", action="store_true",
                    help="build, run phase 20 (the comm plane: gpt2-small "
                         "over four ranks under every codec, hierarchy, "
                         "bucketing and ZeRO-1 leg), then check and time "
                         "flash_fwd and flash_bwd at its shape (rows 1 and "
                         "6) and philox_uniform")
    ap.add_argument("--serve-parallel-only", action="store_true",
                    help="build, run phase 21 (Server under the training "
                         "strategies at gpt2-1p3b width: tensor=2, FSDP "
                         "by devices, paged reuse and speculation under "
                         "tensor=2, data=2 x tensor=2, a disaggregated "
                         "tensor=2 fleet), then check and time flash_fwd, "
                         "flash_decode and flash_decode_paged at its "
                         "shapes (rows 1, 13 and 14)")
    ap.add_argument("--serve-parallel-logits", metavar="SEEDS",
                    help="build, then read phase 21's check of (a)'s "
                         "first-step logits and its control (bf16 "
                         "row-parallel sums) at each of the comma-"
                         "separated seeds")
    ap.add_argument("--tune-only", action="store_true",
                    help="build, run phase 12 (Tune: PBT over MNIST, "
                         "gpt2-small trials under RayPlugin, in-process "
                         "leases) with the driver off CUDA until its actor "
                         "trials end, then check and time flash_fwd and "
                         "flash_bwd (rows 1 and 6)")
    ap.add_argument("--elastic-only", action="store_true",
                    help="build, run phase 22 (the elastic plane: gpt2-"
                         "small under RayPlugin(num_workers=2, strategy="
                         "'zero1') with rank 1 killed at step 5, recovered "
                         "by parity and by snapshot replay), then check and "
                         "time flash_fwd and flash_bwd at the shrunk "
                         "fleet's shape (rows 1 and 6)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1

    log(card_line())
    driver_off_cuda = (args.plugin_only or args.tune_only or args.resnet_only
                       or args.loop_only or args.server_only
                       or args.fleet_only)
    # the whole run starts with phase 16, the driver off CUDA
    full = not (driver_off_cuda or args.fwd_only or args.bwd_only
                or args.decode_only or args.trainer_only
                or args.ladder_only or args.sharded_only
                or args.parallel_only or args.comm_only
                or args.serve_parallel_only or args.serve_parallel_logits
                or args.elastic_only)
    if not (driver_off_cuda or full):  # the device's name initialises CUDA
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}")
    if full or args.elastic_only:
        # the actors' fork server imports torch while the kernels build
        from ray_lightning_tpu_torch.cluster import get_backend
        get_backend().start_fork_server()
    build_s = _kernels.build()
    log(f"build: {build_s:.2f} s for {sorted(_kernels.REGISTRY)}")
    by_source = {k.source: k for k in _kernels.REGISTRY.values()}
    for source, k in sorted(by_source.items()):
        for line in k.build_log.splitlines():
            if any(w in line for w in ("registers", "spill", "entry "
                                       "function", "wgmma", "warning")):
                log(f"  ptxas {source}: {line.strip()}")

    fleet = None
    if args.fleet_only or full:
        log("fleet phase")
        t0 = time.monotonic()
        fleet = run_fleet_phase(args.seed, card_line())
        log(f"fleet phase: {time.monotonic() - t0:.1f} s")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}")
    if args.fleet_only:
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        log("kernel phase (rows 1, 13 and 14)")
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        entries = [kernel_flash_fwd(gen), kernel_flash_decode(gen, flush),
                   kernel_flash_decode_paged(gen, flush)]
        del flush
        for e in entries:
            e["launches_by_path"] = {"fleet": fleet["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"]["fleet"]
        log(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if args.server_only:
        log("server phase")
        t0 = time.monotonic()
        server = server_phase(args.seed, card_line())
        log(f"server phase: {time.monotonic() - t0:.1f} s")
        if torch.cuda.is_initialized():
            raise AssertionError("the driver initialised CUDA in the "
                                 "server phase")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}")
        log("serve phase (phase 3, for its tokens)")
        served = serve_phase(args.seed)
        check_same_tokens(server["tokens"], served["tokens"])
        del served
        free_cuda()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        log("kernel phase (rows 1 and 13)")
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        entries = [kernel_flash_fwd(gen), kernel_flash_decode(gen, flush)]
        del flush
        for e in entries:
            e["launches_by_path"] = {"server": server["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"]["server"]
        log(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if driver_off_cuda:
        path, run = (("plugin", plugin_phase) if args.plugin_only
                     else ("tune", tune_phase) if args.tune_only
                     else ("loop", loop_phase) if args.loop_only
                     else ("resnet", resnet_phase))
        log(f"{path} phase")
        t0 = time.monotonic()
        phase = run(args.seed, driver_off_cuda=True)
        log(f"{path} phase: {time.monotonic() - t0:.1f} s")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}")
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        log("kernel phase (rows 1 and 6)")
        entries = [kernel_flash_fwd(gen), kernel_flash_bwd(gen)]
        for e in entries:
            e["launches_by_path"] = {path: phase["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"][path]
        log(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.fwd_only:
        log("flash_fwd rows " + json.dumps(fwd_rows(gen)))
        return 0
    if args.bwd_only:
        log("flash_bwd rows " + json.dumps(bwd_rows(gen)))
        return 0
    if args.decode_only:
        log("flash_decode rows " + json.dumps(decode_rows(gen)))
        return 0
    if args.sharded_only:
        log("sharded phase")
        sharded = sharded_phase(args.seed, card_line())
        log(f"sharded phase: {sharded['seconds']:.1f} s")
        free_cuda()
        log("kernel phase (rows 3 and 9 at the sharded shapes)")
        entries = sharded_kernel_entries(gen)
        for e in entries.values():
            e["launches_by_path"] = {"sharded": sharded["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"]["sharded"]
        log(json.dumps({"kernels": [entries[3], entries[9]]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.parallel_only:
        log("parallel phase")
        par = parallel_phase(args.seed, card_line())
        log(f"parallel phase: {par['seconds']:.1f} s")
        free_cuda()
        log("kernel phase (rows 1 and 6 at the parallel shapes)")
        entries = parallel_kernel_entries(gen)
        for e in entries.values():
            e["launches_by_path"] = {path: par["launches"][path][e["name"]]
                                     for path in ("pipeline", "moe_ep")}
            e["launches"] = sum(e["launches_by_path"].values())
        log(json.dumps({"kernels": [entries[1], entries[6]]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.comm_only:
        log("comm phase")
        comm = comm_phase(args.seed, card_line())
        log(f"comm phase: {comm['seconds']:.1f} s")
        free_cuda()
        log("kernel phase (rows 1 and 6 at the comm shape, "
            "philox_uniform)")
        entries = comm_kernel_entries(gen)
        entries = [entries[1], entries[6], kernel_philox(gen)]
        for e in entries:
            e["launches_by_path"] = {"comm": comm["launches"]["comm"][
                e["name"]]}
            e["launches"] = e["launches_by_path"]["comm"]
        log(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.elastic_only:
        log("elastic phase")
        el = elastic_phase(args.seed, card_line())
        log(f"elastic phase: {el['seconds']:.1f} s")
        free_cuda()
        log("kernel phase (rows 1 and 6 at the shrunk fleet's shape)")
        entries = elastic_kernel_entries(gen)
        for e in entries.values():
            e["launches_by_path"] = {"elastic": el["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"]["elastic"]
        check_actor_starts()
        log(json.dumps({"kernels": [entries[1], entries[6]]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.serve_parallel_logits:
        serve_parallel_logits([int(x) for x in
                               args.serve_parallel_logits.split(",")],
                              card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.serve_parallel_only:
        log("serve parallel phase")
        sp = serve_parallel_phase(args.seed, card_line())
        log(f"serve parallel phase: {sp['seconds']:.1f} s")
        free_cuda()
        log("kernel phase (rows 1, 13 and 14 at the serve parallel "
            "shapes)")
        entries = sp_kernel_entries(gen)
        for e in entries.values():
            e["launches_by_path"] = {"serve_parallel":
                                     sp["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"]["serve_parallel"]
            e["serve_parallel_by_rank"] = {
                leg: [r[e["name"]] for r in ranks]
                for leg, ranks in sp["launches_by_rank"].items()}
        check_actor_starts()
        log(json.dumps({"kernels": [entries[1], entries[13], entries[14]]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.ladder_only:
        log("kernel phase (rows 1 and 6, philox_uniform)")
        entries = [kernel_flash_fwd(gen), kernel_flash_bwd(gen),
                   kernel_philox(gen)]
        free_cuda()
        log("ladder phase")
        ladder = ladder_phase(args.seed, card_line())
        log(f"ladder phase: {ladder['seconds']:.1f} s")
        for e in entries:
            e["launches_by_path"] = {"ladder": ladder["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"]["ladder"]
        log(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.trainer_only:
        log("kernel phase (rows 1 and 6)")
        entries = [kernel_flash_fwd(gen), kernel_flash_bwd(gen)]
        free_cuda()
        log("trainer phase")
        t0 = time.monotonic()
        trainer = trainer_phase(args.seed, card_line())
        log(f"trainer phase: {time.monotonic() - t0:.1f} s")
        for e in entries:
            e["launches_by_path"] = {"trainer":
                                     trainer["launches"][e["name"]]}
            e["launches"] = e["launches_by_path"]["trainer"]
        log(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    log("kernel phase")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    entries = [kernel_flash_fwd(gen), kernel_flash_bwd(gen),
               kernel_flash_decode(gen, flush),
               kernel_flash_decode_paged(gen, flush)]
    del flush
    torch.cuda.empty_cache()

    card = card_line()
    log("serve phase")
    served = serve_phase(args.seed)
    log("train phase")
    trained = train_phase(args.seed, card)
    for e in entries:
        by_path = {"serve": served["launches"][e["name"]],
                   "train": trained["launches"][e["name"]]}
        e["launches"] = sum(by_path.values())
        e["launches_by_path"] = by_path

    log("profile phase")
    profile_phase(served["engine"], trained["train_step"])
    served_tokens = served["tokens"]
    del served, trained
    free_cuda()

    t0 = time.monotonic()
    log("paged serve phase")
    paged = paged_serve_phase(args.seed, card)
    log("spec serve phase")
    spec = spec_serve_phase(args.seed, card)
    for e in entries:
        e["launches_by_path"].update(
            paged_serve=paged["launches"][e["name"]],
            spec_serve=spec["launches"][e["name"]])
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"paged and spec serve phases: {time.monotonic() - t0:.1f} s")

    log("server phase")
    t0 = time.monotonic()
    server = server_phase(args.seed, card)
    check_same_tokens(server["tokens"], served_tokens)
    for e in entries:
        e["launches_by_path"]["server"] = server["launches"].get(
            e["name"], 0)
        e["launches_by_path"]["fleet"] = fleet["launches"].get(e["name"], 0)
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"server phase: {time.monotonic() - t0:.1f} s")

    log("long-context phase")
    t0 = time.monotonic()
    entries += long_context_phase(args.seed, card)["entries"]
    log(f"long-context phase: {time.monotonic() - t0:.1f} s")

    log("folded and BERT phase")
    t0 = time.monotonic()
    folded = folded_phase(args.seed, card)
    by_row = {e["row"]: e for e in entries}
    by_row.update(folded["entries"])
    attribute(by_row, folded["runs"])
    by_row[1]["noncausal"] = folded["base"]["fwd"]
    by_row[6]["noncausal"] = folded["base"]["bwd"]
    entries = [by_row[r] for r in sorted(by_row)]
    if sorted(by_row) != list(range(1, 17)) \
            or not all(e["launches"] > 0 for e in entries):
        raise AssertionError("the kernels line must hold rows 1-16, each "
                             "launched on a path: " + str(
                                 {r: e.get("launches") for r, e in
                                  by_row.items()}))
    log(f"folded and BERT phase: {time.monotonic() - t0:.1f} s")

    log("trainer phase")
    t0 = time.monotonic()
    free_cuda()
    trainer = trainer_phase(args.seed, card)
    for row in (1, 6):
        e = by_row[row]
        e["launches_by_path"]["trainer"] = trainer["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"trainer phase: {time.monotonic() - t0:.1f} s")

    log("plugin phase")
    t0 = time.monotonic()
    free_cuda()
    plugin = plugin_phase(args.seed, driver_off_cuda=False)
    for row in (1, 6):
        e = by_row[row]
        e["launches_by_path"]["plugin"] = plugin["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"plugin phase: {time.monotonic() - t0:.1f} s")

    log("tune phase")
    t0 = time.monotonic()
    free_cuda()
    tuned = tune_phase(args.seed, driver_off_cuda=False)
    for row in (1, 6):
        e = by_row[row]
        e["launches_by_path"]["tune"] = tuned["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"tune phase: {time.monotonic() - t0:.1f} s")

    log("resnet phase")
    t0 = time.monotonic()
    free_cuda()
    resnet = resnet_phase(args.seed, driver_off_cuda=False)
    for row in (1, 6):
        e = by_row[row]
        e["launches_by_path"]["resnet"] = resnet["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"resnet phase: {time.monotonic() - t0:.1f} s")

    log("loop phase")
    t0 = time.monotonic()
    free_cuda()
    loop = loop_phase(args.seed, driver_off_cuda=False)
    for row in (1, 6):
        e = by_row[row]
        e["launches_by_path"]["loop"] = loop["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"loop phase: {time.monotonic() - t0:.1f} s")

    log("ladder phase")
    free_cuda()
    philox = kernel_philox(gen)
    ladder = ladder_phase(args.seed, card)
    for row in (1, 6):
        e = by_row[row]
        e["launches_by_path"]["ladder"] = ladder["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    philox["launches_by_path"] = {
        path: phase["launches"].get("philox_uniform", 0)
        for path, phase in (("trainer", trainer), ("plugin", plugin),
                            ("tune", tuned), ("resnet", resnet),
                            ("loop", loop), ("ladder", ladder))}
    philox["launches"] = sum(philox["launches_by_path"].values())
    entries.append(philox)
    log(f"ladder phase: {ladder['seconds']:.1f} s")

    log("sharded phase")
    free_cuda()
    sharded = sharded_phase(args.seed, card)
    free_cuda()
    h16 = sharded_kernel_entries(gen, shapes=((TP_B, 2),))
    for row in (3, 9):
        e = by_row[row]
        e["by_shape"].update(h16[row]["by_shape"])
        e["launches_by_path"]["sharded"] = sharded["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"sharded phase: {sharded['seconds']:.1f} s")

    log("parallel phase")
    free_cuda()
    par = parallel_phase(args.seed, card)
    free_cuda()
    shapes = parallel_kernel_entries(gen)
    for row in (1, 6):
        e = by_row[row]
        e.setdefault("by_shape", {}).update(shapes[row]["by_shape"])
        for path in ("pipeline", "moe_ep"):
            e["launches_by_path"][path] = par["launches"][path][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"parallel phase: {par['seconds']:.1f} s")

    log("comm phase")
    free_cuda()
    comm = comm_phase(args.seed, card)
    free_cuda()
    for row in (1, 6):
        e = by_row[row]
        e["launches_by_path"]["comm"] = comm["launches"]["comm"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    philox["launches_by_path"]["comm"] = comm["launches"]["comm"][
        "philox_uniform"]
    philox["launches"] = sum(philox["launches_by_path"].values())
    log(f"comm phase: {comm['seconds']:.1f} s")

    log("serve parallel phase")
    free_cuda()
    sp = serve_parallel_phase(args.seed, card)
    free_cuda()
    shapes = sp_kernel_entries(gen)
    for row in (1, 13, 14):
        e = by_row[row]
        e.setdefault("by_shape", {}).update(
            {f"serve_parallel {k}": v
             for k, v in shapes[row]["by_shape"].items()})
        e["launches_by_path"]["serve_parallel"] = sp["launches"][e["name"]]
        e["serve_parallel_by_rank"] = {
            leg: [r[e["name"]] for r in ranks]
            for leg, ranks in sp["launches_by_rank"].items()}
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"serve parallel phase: {sp['seconds']:.1f} s")

    log("elastic phase")
    free_cuda()
    el = elastic_phase(args.seed, card)
    free_cuda()
    shapes = elastic_kernel_entries(gen)
    for row in (1, 6):
        e = by_row[row]
        e.setdefault("by_shape", {}).update(
            {f"elastic {k}": v for k, v in shapes[row]["by_shape"].items()})
        e["launches_by_path"]["elastic"] = el["launches"][e["name"]]
        e["launches"] = sum(e["launches_by_path"].values())
    log(f"elastic phase: {el['seconds']:.1f} s")
    check_actor_starts()
    log("speed order (rows slower than their library call by that factor, "
        "then by launches x (ms - bound)): " + ", ".join(
            f"{e['name'] if e['row'] is None else 'row %d' % e['row']} "
            + (f"{e['ms'] / e['library_ms']:.2f}x"
               if e["library_ms"] and e["ms"] > e["library_ms"] else
               f"{e['launches'] * (e['ms'] - e['bound_ms']):.1f}")
            for e in speed_order(entries)))

    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
