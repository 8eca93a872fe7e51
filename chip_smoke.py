#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vil_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --only kernels,serve_rpe   # the build and those parts alone

Phases, one line each; any failure raises and the exit code is not 0:

1. device  — refuse to run without CUDA; the card's name and power limit.
2. build   — compile ``vil_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, one
   nvcc per source, all at once; the SASS census of the dense kernels, of
   the sliding-chunk forwards B1, B7a, B5 and B5h, of the sliding-chunk
   backwards B2, B7b, B6 and B6h and of the fused block's forward B9a and
   backward B9b
   (``tools/sass_census.py``, with each kernel's registers): their bf16
   instances must hold wgmma (HGMMA) and cp.async (LDGSTS) instructions.
3. kernels — each kernel against its plain PyTorch version on the same
   inputs: the forwards (with their log-sum-exp against ``torch.logsumexp``
   of the plain scores) and the backwards (with the same upstream gradient)
   at the shapes of ViL-Small 224² at batch 64, in f32 and bf16, plus biased,
   padded, cyclic 1×2 and 2×2 and long-sequence cases, and the dense kernels
   at every head dim (8-128) at N 1, 63, 64 and 65, and each kernel of part
   highres at its shapes (timed per call: 14x14, 37x37, 19x19 grids, W 6, 8
   and 12; B5/B6 at two modes on 37x37 and W 12; dense N 577, 4097, 1024 and
   144; the fused block at W 12 and W 8), in bf16 also to a
   limit on max|err| / max|ref| of out, dq, dk and dv (and of out, dq, dk,
   dv, dk_glo, dv_glo and dbias of B1/B2, B5/B6 and B7a/B7b); the
   sampled-neighbour kernels of random-shift training (B5, B6) at two modes
   per stage and on biased, padded and cyclic grids, W 9 and head dim 128;
   B2 and B6 take the forward's out. Kernel, plain and library times (CUDA
   events, median of 20; the library call is
   ``scaled_dot_product_attention``, for the sliding-chunk kernels on the
   materialised key neighbourhood, whose concatenation is timed on its own
   line), and each kernel's bound on this card. The dense kernels are also
   timed at N=4097, ViL-Small 1024²'s stage-3 length, where the JAX package
   switches to its q-tiled kernels.
4. serve   — ViL-Small 224², 1000 classes, bf16, batch 64, random seeded
   weights: six requests of uint8 images; the launch counts must be 3
   (sliding-chunk forward) and 9 (dense forward) per forward and 0 for the
   backwards; then the same weights in f32 with the kernels and with the
   plain versions must agree, and in bf16 (the path's own types) too.
5. train   — the ViL-Small 224² training step of configs/msvit.yaml (AdamW
   with the no-decay set, mixup/cutmix with soft-target CE and label
   smoothing 0.1, drop path 0.1, f32 parameters under bf16 compute) at batch
   64 for six steps; launches must rise by 3, 3, 9 and 9 per step (B1, B2,
   B3, B4) and every loss be finite. Then one f32 step with the kernels and
   one with the plain versions, from the same weights, images and generator
   seed: losses and every parameter gradient must agree; then the same pair
   of steps in bf16 compute, each parameter gradient to a looser limit.
6. train_shift — the same step with random shifting (MODE 1, one sampled
   neighbour mode per attention block drawn each step from a seeded CPU
   generator, printed): launches must rise by 3, 3, 9 and 9 per step for the
   sampled-neighbour pair (B5, B6) and the dense pair, and by 0 for B1 and
   B2; then the f32 kernels-vs-plain step with the first step's modes.
7. serve_fused — phase 4 in the fused-kernel configuration (TPU.FUSED_LN and
   the fused attention block, ``recipe.vil_small(..., fused=True)``): per
   forward 3 fused-block (B9a), 30 LayerNorm (B8a) and 9 dense launches and
   no sliding-chunk one; f32 logits kernels vs plain, then the fused
   configuration's f32 logits against the classic one's, same weights.
8. train_fused — phase 5 in the fused configuration: per step B9a 3, B9b 3,
   B8a 30, B8b 30, B3 9, B4 9, and 0 for B1, B2, B5, B6; then the f32
   kernels-vs-plain step.
9. serve_spatial — spatial (chunk-row) parallelism on a process group of one
   card (``nccl``, set up from a ``FileStore`` under build/; the halos go
   through the exchange, sent by NCCL to the rank itself): the ViL-Small
   224² bf16 batch-64 forward through ``parallel.spatial_forward``, six
   requests; per forward 3 halo-input forward (B7a) and 9 dense launches and
   no B1. The classic serve forward is timed before it, same weights and
   images, outside its launch counts. Then, as a path of its own
   (``spatial_bwd``, counted apart), one autograd backward through
   ``spatial_local_attention_kernel`` at stage 1's shape on the same group:
   B7a 1 and B7b 1, B7b inside the halo exchange's adjoint, which returns the
   halo rows' gradients over NCCL (its gradients against the plain spatial
   tier). Last, f32 logits spatial vs classic and spatial kernels vs plain.
10. probe — the layout probe tool (``vil_tpu_torch.tools.layout_probe``):
   producer GEMM → P → consumer GEMM in both schemes, its census of copy ops
   and its time per pass.
11. serve_rpe — phase 4 on ViL-Small RPE (``recipe.vil_small(..., rpe=True)``:
   relative position bias in every stage), its biases assembled once by
   ``models.precompute_rpe_cache``: B1 3 and B3 9 per forward, each with its
   bias; the cached logits equal, bit for bit, those of a model that
   assembles the biases in the forward; f32 and bf16 logits kernels vs
   plain as in phase 4, and the f32 pair again with every table drawn at
   σ 1, beside the logits' change from zero tables (what a dropped bias
   moves them by).
12. train_rpe — phase 5 on ViL-Small RPE: launches rise by 3, 3, 9 and 9 per
   step; the f32 step pair holds the tables' gradients with every other
   (and again with the tables at σ 1), then the bf16 pair.
13. shift_rpe — the f32 kernels-vs-plain random-shift step pair of ViL-Small
   RPE, at the recipe's first draw of modes (printed) and again with the
   tables at σ 1: B5, B6 with the [g2l | self | sampled] bias, 3 each a
   kernel step, B3, B4 9.
14. train_fused_rpe — the same pair in the fused configuration: B9a, B9b 3,
   B8a, B8b 30, B3, B4 9 a kernel step.
15. experiment — the entry point users run, ``python -m
   vil_tpu_torch.run_experiment`` (config, data pipeline, trainer,
   checkpoints), driven in-process through its ``main(argv)`` on
   configs/msvit.yaml's recipe at ViL-Small's full width and depth, batch 64
   (the yaml's 256, cut), the synthetic set (512 images: 8 steps an epoch, 8
   eval batches): two epochs, random shift in the first (VIL_MODE_SWITCH
   0.5), MODE 0 in the second; a resume of the same directory to three
   epochs (from the ``last_checkpoint`` tag at epoch 2, step 16, at the
   schedule's LR there; its steps 2..8 under ``torch.profiler`` for the
   card's busy share, ``ProfiledSteps``'s window as in phase 20); the last checkpoint reloaded under EVALUATE, its eval bit
   for bit the run's; the same eval in f32 with the kernels and with the
   plain versions (TPU.USE_PALLAS), loss to LOSS_TOL and top1 equal. Each
   run's launches must equal the formula from the trainer's own counts
   (random-shift and MODE-0 steps, eval batches, the best checkpoint's
   eval); per epoch the median batch_time, data_time and img/s, and the peak
   memory, are printed.
16. efficient — the paper's other attention families on ViL-Small 224² at
   batch 64 (``recipe.VARIANTS``: linformer f256 with SHARE_KV, srformer f8/f4,
   performer f256, global-only and unshared-global ViL), each a path of its
   own: REQUESTS bf16 serving forwards on uint8 images and STEPS bf16
   training steps of the recipe (walls the median of all but the first, as
   on the other paths; peak memory, parameters and ops/flops.py's GMACs
   printed), then one f32 forward and one f32 step with the kernels and
   with the plain versions from the same weights (logits to LOGITS_TOL, loss
   to LOSS_TOL, every parameter gradient to PARAM_GRAD_TOL of its max|ref|);
   the launches held exactly: per forward B3 9 (and B1 3 with unshared
   weights), per step also B4 9 (and B2 3), nothing else. Then the performer
   through ``run_experiment.main(argv)`` (path ``experiment_performer``):
   two epochs of 8 steps and a resume to three; its projection buffers must
   change before exactly the steps a fresh ``RedrawSchedule`` names, the
   resumed run's count must start afresh, the checkpoint's buffers be the
   last step's and the last redraw the draw keyed by (seed, step).
17. highres — high resolution at full width, at full depth but where
   ``HIGHRES_ARCH`` cuts it to ViL-Small's (``HIGHRES``,
   ``recipe.vil``): ViL-Medium-Deep 384² (since PR 23 at ViL-Small's
   depth) served at batch 64 (``serve_384``: 14x14 chunks of W 7 pad 2, 7x7
   pad 1, dense N 577 and 144; B1 3, B3 9 a forward, 5 and 17 at full
   depth) and trained at 64 (``train_384``: B1, B2 3, B3, B4 9 a step);
   ViL-Small 1024² served at batch 8 (``serve_1024``: 37x37 pad 3, 19x19 pad
   5, dense N 4097 and 1024; B1 3, B3 9), trained at 8 at MODE 0
   (``train_1024``) and at random shift (``shift_1024``: B5, B6 3, B3, B4 9,
   B1, B2 0); ViL-Base-Deep-384 (since PR 23 at ViL-Small's depth) served
   and trained at batch 32 (``base_deep_384``: 16x16 W 6, 6x6 W 8; B1 3, B3
   9 a forward, B2 3, B4 9 more a step; 9 and 25 at full depth). Each:
   REQUESTS forwards and/or STEPS steps (walls the
   median of all but the first, img/s, GMACs an image from ops/flops.py,
   peak memory), PROFILED more under torch.profiler (the card's time, idle
   share, top families); launches exact per forward and step; then the f32
   and the bf16 pair, kernels vs plain versions from the same weights, at
   the batch the plain versions' memory allows (64, 8, 8, 2, 2, 4): logits
   to LOGITS_TOL and BF16_LOGITS_TOL, a step's loss and every gradient to
   LOSS_TOL, PARAM_GRAD_TOL and BF16_PARAM_GRAD_TOL. The same with relative
   position bias in every stage (``recipe.vil(..., rpe=True)``, served from
   ``precompute_rpe_cache``): ViL-Medium-Deep RPE 384² served and trained at
   batch 64 (``serve_384_rpe``, ``train_384_rpe``; pairs at 8) and ViL-Small
   RPE 1024² at batch 8 (``serve_1024_rpe``, ``train_1024_rpe``; pairs at 2),
   launches as their APE twins', each table's f32 gradient error printed
   apart. Then ``finetune_384``:
   configs/msvit_384finetune.yaml through ``run_experiment.main(argv)`` on
   ViL-Medium-Wide 384² (W 8 with 64 rows a chunk, W 12 with 144 in three
   slices) from a .pth of a seeded ViL-Medium-Wide 224² under the
   reference's names, batch 32, one epoch of 8 QHM steps and its eval: every
   parameter after the load bit for bit the CPU importer's, each logged LR
   the schedule's, launches the trainer's counts, the f32 eval kernels vs
   plain (loss to LOSS_TOL, top1 equal).
18. train_spatial — training over a ('data', 'spatial') mesh: ViL-Small
   1024²'s recipe step at batch 8, bf16, on an ``nccl`` group of one card,
   the image's rows split over it (``engine.TrainStep`` with a
   ``parallel.Mesh``): STEPS steps and PROFILED more, launches exact per step
   (B7a 3, B7b 3, B3 9, B4 9, no B1/B2), beside the classic train_1024 step
   from the same weights in the same phase (outside the path's counts; wall,
   device time, idle, peak memory); one bf16 step spatial vs classic from
   the same weights and batch (every gradient to BF16_PARAM_GRAD_TOL) and
   one f32 step of ViL-Small with stage 3 cut to one block at batch 2 (loss
   to LOSS_TOL, gradients to PARAM_GRAD_TOL of their max|ref|). With two
   cards or more, the multi-card phase: the step at D 2 in two spawned
   ``nccl`` ranks, and with four cards or more at D 4 in four, against the
   one-rank step; on one card a line says it was not run.
19. experiment_spatial — ``run_experiment.main`` with TPU.MESH_AXES
   ['data','spatial'] and MESH_SHAPE [1,1] on an ``nccl`` group of one:
   phase 15's recipe cut to one MODE-0 epoch of 8 steps (the loader's
   threads cut to 0), its eval, one checkpoint and the best checkpoint's
   eval; launches from the trainer's counts (B7a, B7b for B1, B2), every
   logged loss against the same run without the mesh.
20. from_vil_tpu — what ``vil_tpu``'s users hold, through ``run_experiment.main``
   (configs/msvit.yaml's recipe, ViL-Small 224² at full width and depth,
   batch 64, MODE 0): a Trainer of the recipe takes two steps, and its
   weights and AdamW state are written as ``vil_tpu``'s OUTPUT_DIR (a flax
   msgpack file by ``flax_msgpack_bytes``, an encoder of flax's format kept
   here, since the card's host has no flax; the header ``.json`` and the
   ``last_checkpoint`` tag) and in the port's format; EVALUATE from
   MODEL.MODEL_PATH on each file, loss and top1 bit for bit equal (the
   file's size and the load's seconds printed); a resume of the ``vil_tpu``
   directory for one epoch of 8 steps, its first step against the source
   Trainer's same step on the same batch (loss to LOSS_TOL, every parameter
   to PARAM_GRAD_TOL of its max|ref|); a TSV of 1024 seeded JPEGs at 256²:
   ``tools/data_bench``'s img/s at batch 256 for 'grain' at 8 worker
   processes, the
   native reader asserted in use, then one MODE-0 epoch of
   ``run_experiment.main`` on the TSV with DATALOADER.BACKEND 'grain'
   (median batch_time and data_time, img/s, the card's busy share under
   ``torch.profiler``); last, the eval transform's batches of the TSV from
   'grain' and from 'threads', bit for bit. Every run of the CLI holds its
   launches to the trainer's counts.
21. train_drop — phase 5 at MODEL.VIT.DROP 0.1 (``run_train(drop=0.1)``): the
   same launches a step, the dropout masks drawn from the step's generator,
   the f32 and bf16 kernels-vs-plain step pairs from the same seed.
22. self_chunk — the self-only (mode -1) instances of B5/B6 against their
   plain versions (phase 3's self cases: ViL-Small's stage 1 and 2 shapes,
   a padded biased grid, SW_EXACT -1, W 9, head dim 128, the RPE bias of
   mode -1 from tables; bf16 and f32), then ViL-Small 224² served and
   trained at mode -1 (the self-only pair 3, B3, B4 9 a step; no B1/B2/B5/
   B6), its f32 and bf16 logits and step gradients kernels vs plain.
23. train_remat — ViL-Small 224² at batch 64 under TPU.REMAT '',
   'minimal' and 'full' (ViL-Medium-Deep 384² left out: REMAT at high
   resolution runs in spatial_options): the first step's gradients
   against the '' step's (and whether bit for bit), step walls, device time,
   peak memory, the launches a step with the recomputed B1 and B3.
24. resnet — ResNet-50 224² at batch 64 (bf16 compute, cuDNN convolutions,
   no kernel of the port): serve and train walls, device time, peak memory;
   the card's f32 logits, loss, running statistics and gradients against
   the CPU's from the same weights and images (the gradients to twice the
   CPU's own f32 error against its f64 step); ``run_experiment.main`` with
   MODEL.ARCH resnet50: one epoch and its eval, its resume to two, equal to
   an uninterrupted run of two.
25. shift_spatial — random shift under the split: shift_1024's step
   (ViL-Small 1024², MODE 1, batch 8, bf16, per-block modes keyed by
   (seed, step)) on a ('data', 'spatial') mesh of one card (``nccl``):
   launches exact per step (the sampled-neighbour halo pair B5h, B6h 3
   each, B3, B4 9; no B5/B6, B7a/B7b), beside the classic shift_1024 step
   from the same weights, which must draw the same modes (outside the
   path's counts; wall, device time, idle share, peak memory); one bf16 step
   spatial vs classic at the same modes (every gradient to
   BF16_PARAM_GRAD_TOL) and one f32 step on the mesh, kernels vs plain
   versions (ViL-Small with stage 3 cut to one block, batch 2). With two
   cards or more, the same multi-card phase as phase 18 at these modes.
26. self_spatial — ViL-Small 224² at mode -1 on the one-card mesh: serving
   forwards through ``parallel.spatial_forward(..., mode=-1)`` (the
   self-only B5 3, B3 9) and steps at mode -1 (the self-only pair 3 each,
   B3, B4 9), on each rank's rows without an exchange; f32 logits and one
   f32 step against the classic self_chunk path's.
27. experiment_spatial_shift — phase 19 with phase 15's recipe: two epochs,
   random shift in the first (B5h, B6h), MODE 0 in the second (B7a, B7b),
   every logged loss against the same run without the mesh.
28. spatial_options — train_spatial's step on the one-card mesh as two
   paths: train_spatial_remat (TPU.REMAT '', 'minimal', 'full': B7a 3 → 6,
   B3 9 → 18 a step) and train_spatial_drop (MODEL.VIT.DROP 0.1, then with
   REMAT 'full'); each setting's first step's gradients against the path's
   first setting (bit for bit) and the classic one-rank step (bf16 limit),
   its wall, device time, peak memory and collectives a step; and the time
   of drawing the whole stage-1 hidden mask against a rank's part of it.
   The parts train_tp and train_fsdp (phases 18's sharded twins, above the
   experiment_tp part) run, in the same spawns, the paths train_tp_remat,
   train_tp_drop and resnet_tp ('tp', 1 × 3 ranks: REMAT 'full' and
   'minimal', DROP 0.1, ResNet-50 whole on every rank) and
   train_fsdp_remat and resnet_fsdp ('fsdp' over 2 ranks), each REMAT case
   against its twin without REMAT bit for bit (B1 3 → 6, B3 9 → 18 a step),
   with its peaks a rank and collectives a step (under 'tp' one step each;
   'fsdp' also its walls and device time).
29. train_spatial_tp, train_spatial_fsdp — heads and rows split at once:
   train_spatial's step (ViL-Small 1024², batch 8, bf16) under
   TPU.PARAM_SHARDING 'tp' on a (1, 2, 3) ('data', 'spatial', 'model') mesh
   (a rank's H/3 heads of its rows) and under 'fsdp' on a (2, 2) ('data',
   'spatial') mesh, the mesh ``parallel.mesh_from_cfg``'s, ranks spawned
   on the card over gloo (nccl with a card a rank): at MODE 0, with random
   shift and under REMAT 'full' (the paths ``<part>``, ``<part>_shift`` and
   ``<part>_remat``): launches exact on rank 0 (B7a 3, B7b 3, B3 9, B4 9 a
   step; B5h/B6h with random shift; B7a 6 and B3 18 under REMAT), the
   gradients against the classic one-rank step at BF16_PARAM_GRAD_TOL,
   REMAT bit for bit; walls, device time, peak memory a rank, collectives
   and bytes a step; ``run_experiment.main`` on the (2, 2) mesh for one
   epoch. With four cards, (1, 2, 2) over nccl; on one a line says so.
30. resnet_spatial — a ResNet on a spatial axis: ResNet-50 1024², batch 8,
   on a (1, 2) ('data', 'spatial') mesh, two ranks sharing the card over
   gloo, each 16 of the image's 32 blocks of 32 rows (halo convolutions and
   max-pool, BatchNorm and the pool summed over both): a bf16 step and its
   timed and profiled ones beside the one-rank step's, printed against it;
   an f32 step at 2 images whose gradients are held, each, to twice the
   same gradient's error in the one-rank f32 step against the one-rank f64
   step; no kernel of the
   port (cuDNN's convolutions). Part train_tp's spawn also trains the five
   attention families of ``recipe.VARIANTS`` under 'tp' (the paths
   ``train_tp_<family>``: B3 9, B4 9 a step at H/3 heads, B1 3, B2 3 for
   the unshared ViL), their bf16 gradients against the one-rank step (the
   srformer's ``proj_sr`` gradient cancels through the instance norm:
   those of its parameters that bf16's rounding alone moves by more than
   the limit are printed, and every gradient is held by an f32 step
   of the shallow srformer at 2 images, ``proj_sr``'s to SR_CONV_TOL).
Phase 9 also serves ViL-Small RPE (tables at σ 1) through the spatial route
and holds its f32 logits to the classic forward's and to the plain versions'.

Phase 3 also holds the LayerNorm kernels (B8a, B8b) at the six row shapes of
ViL-Small's block pre-norms, with ``F.layer_norm`` as their library call, and
at C 100 and 1000 (no 16-byte vectors) at 1 and 3000 rows, a second B8b
launch bit for bit; the fused-block kernels (B9a, B9b) at stage 1 and 2, on
biased, padded, cyclic 2×2 and 3×3 grids, with and without global rows, at
C 48-320, and at stage 1's width with q, k and v biases as large as the
products (no single PyTorch call computes the fused block; in bf16 B9a's y,
q, k, v, attn and lse and every B9b gradient also to max|err| / max|ref|
with no floor, and a second B9b launch bit for bit), then the card's time
per step (``torch.profiler``) beside the event time of B5, of B9a (by part:
projections, attention, output projection), of B9b (attention, products, the
rest), of B8a and of B8b (rows, reduction) (``card_times``), the
halo-input kernels (B7a, B7b) on every shard of stage 1 and 2 split over 1, 2
and 4 ranks, of a biased padded grid split over 3, of a cyclic 1×2 grid, and
of an SW_EXACT 1 (a mask row per query pixel) and a W 4 grid split over 1
and 2 (at the end of the phase also on ViL-Small 1024²'s 37×37 and 19×19
grids whole, timed as train_spatial's B7b, and on the ragged shards of the
splits of 2 and 4 ranks, 20/17 and 10/10/10/7 rows, 10/9 and 5/5/5/4, with
and without a bias from tables, each shard timed), in f32 and bf16 (the
shards' outputs together must equal B1's on the
whole grid, their dK/dV folded onto the rows' owners B2's; SDPA on the
materialised halo neighbourhood as the library call; a bf16 operand off a
16-byte boundary must raise ValueError); their sampled-neighbour form B5h,
B6h (random shift under the split) the same way at every mode 1..8 on
ViL-Small 224²'s stage 1 and 2 split over 1, 2 and 4 ranks and on 1024²'s
37×37 grid whole and split 20/17 and 10/10/10/7, on a biased padded grid
without global rows, SW_EXACT -1 at W 4 and with the RPE bias of modes 2
and 5 from tables (against B5 and B6 on the whole grid, each shard's bound
printed, a second backward bit for bit, modes 1 and 6 timed per shard
beside SDPA on the materialised [glo | self | sampled] keys), last at the
path's shapes (1024², batch 8, one rank, timed as a shift_spatial step);
and P's two entry points against
``x * 2``, exactly, at the probe's shape (event time, the time of 100 calls
between one pair of events, and the card's time by ``torch.profiler``, each
beside ``torch.mul``'s), on a ragged shape, on a view one element into its
storage and on a slice.

Phase 3 ends with ViL-Small RPE's biased kernels at its step's shapes, each
bias assembled from tables drawn at σ 1 by the model's own assembly: B3 with
(6, 197, 197) and (12, 49, 49), B1/B2 and B9a/B9b with (3, 49, 442), B5/B6 at
modes 1..8 with (3, 49, 99) in front order, B7a/B7b split over 2 ranks; each
timed per call with its bias (SDPA with the bias in its mask beside it); the
biased B2 and B4 launched twice, bit for bit (their dbias partials by chunk
and image groups). Last, the high-resolution cases, with the biased B4 at
N 4097, batch 8 (one group of 8 images) and B2 on the 37x37 grid at batch 2
(bit for bit again), and the dense bias's assembly (the gather against the
skew, forward and backward, equal bit for bit) at the paths' grids. Then
``vil_tpu``'s BF16_EXP (``BF16_EXP_CASES``): B1/B2, B5/B6, the self-only
B5/B6, B7a/B7b, B5h/B6h and B9a/B9b in bf16 under ``VIL_TPU_BF16_EXP`` 1
and 0, each against the f32 plain version at the limits above and against
the plain versions' bf16 emulation of its setting, their stage-1 shapes
timed under both.

Each path of phases 4-30 sets the launch counts to 0 before it and reads
them after it; a kernel that none of them launched fails the run. The last line is ``{"ok": true, "device": {...}}``; the line
before it holds every kernel's record (``launches`` is the sum over the
paths, ``launches_serve``, ``launches_train``, ``launches_shift``,
``launches_serve_fused``, ``launches_train_fused``, ``launches_serve_spatial``,
``launches_spatial_bwd``, ``launches_probe``, ``launches_serve_rpe``,
``launches_train_rpe``, ``launches_shift_rpe``, ``launches_train_fused_rpe``,
``launches_experiment``, ``launches_linformer``, ``launches_srformer``,
``launches_performer``, ``launches_global``, ``launches_unshared``,
``launches_experiment_performer``, ``launches_serve_384``,
``launches_train_384``, ``launches_serve_1024``, ``launches_train_1024``,
``launches_shift_1024``, ``launches_base_deep_384``, ``launches_serve_384_rpe``,
``launches_train_384_rpe``, ``launches_serve_1024_rpe``,
``launches_train_1024_rpe``, ``launches_finetune_384``,
``launches_train_spatial``, ``launches_experiment_spatial``, ``launches_train_tp``,
``launches_train_tp_shift``, ``launches_train_fsdp``, ``launches_experiment_tp``,
``launches_from_vil_tpu``, ``launches_train_drop``, ``launches_self_chunk``, ``launches_train_remat``,
``launches_resnet``, ``launches_shift_spatial``, ``launches_self_spatial``,
``launches_experiment_spatial_shift``, ``launches_train_tp_remat``,
``launches_train_tp_drop``, ``launches_resnet_tp``, ``launches_train_fsdp_remat``,
``launches_resnet_fsdp``, ``launches_train_spatial_remat``,
``launches_train_spatial_drop``, ``launches_train_spatial_tp``,
``launches_train_spatial_tp_shift``, ``launches_train_spatial_tp_remat``,
``launches_train_spatial_fsdp``, ``launches_train_spatial_fsdp_shift``,
``launches_train_spatial_fsdp_remat``, ``launches_train_tp_linformer``,
``launches_train_tp_srformer``, ``launches_train_tp_performer``,
``launches_train_tp_global``, ``launches_train_tp_unshared`` and
``launches_resnet_spatial`` each path's;
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are per step of the
training path that runs the kernel: MODE 0, random shift for B5/B6, mode
-1 for their self-only instances, fused for B8/B9, train_spatial for B7b
and shift_spatial for B5h/B6h (one rank); for B7a per spatial serving
forward on one rank (no LSE); for P per call at the probe's shape), and the line before that the card as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 64
REQUESTS = 6  # the first is the warm-up, left out of the img/s median
STEPS = 6  # training steps; the first is the warm-up
F32_TOL = 1e-4  # kernel vs plain, f32 inputs: f32 sums in another order
BF16_TOL = 2e-2  # kernel on bf16 inputs vs plain in f32 on the same values
LSE_TOL = 2e-5  # kernel vs logsumexp of the plain scores, either dtype (measured ≤ 3.8e-6)
# backward, max|err| / max(1, max|ref|) (measured ≤ 2.4e-6 and ≤ 3.4e-3)
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# bf16 dense kernels: max|err| / max|ref| of out, dq, dk and dv, with no floor.
# The limits above are absolute below |ref| 1, where the dense outputs of the
# main path lie (|out| ≈ 0.02 at stage 3). Measured ≤ 7.1e-3 over the cases;
# a forward that skips the rescale of o across key tiles reads 3.0e-2-1.5 at
# N > 64, δ = 0 in the backward 0.12-4.5.
DENSE_SCALED_TOL = 2e-2
# bf16 sliding-chunk kernels B1/B2, B5/B6 and B7a/B7b: the same ratio for
# out, dq, dk, dv, dk_glo, dv_glo and (biased cases) dbias, with no floor
# (dq, the global keys' gradients and dbias lie far below 1 at these shapes);
# and for every gradient of the fused block's backward B9b (BLOCK_GRADS).
CHUNK_SCALED_TOL = 2e-2
BLOCK_GRADS = ("dx", "dWq", "dbq", "dWk", "dbk", "dWv", "dbv", "dWo", "dbo", "dk_glo",
               "dv_glo", "dbias")
# and the same ratio for what the fused block's forward B9a writes
BLOCK_FWD_OUTS = ("y", "q", "k", "v", "attn", "lse")
LOGITS_TOL = 1e-3  # whole model in f32, kernels vs plain versions
LOSS_TOL = 1e-4  # one f32 training step, kernels vs plain versions
PARAM_GRAD_TOL = 1e-4  # the same step: max|err| / max|ref| per parameter (measured 1.7e-6)
# the same paths in bf16, kernels vs plain versions from the same weights:
# logits max|err| / max|ref| (measured 5.2e-3; an all-zero dense forward
# 0.35); one step's parameter gradients ‖err‖ / ‖ref‖, the largest over the
# parameters (measured 9.9e-3; δ = 0 in the dense backward 0.20). Plain bf16
# vs plain f32 reads 1.7e-2 and 1.9e-2: a sound bf16 kernel of another
# rounding order may come near that.
BF16_LOGITS_TOL = 2.5e-2
# the RPE paths' f32 logits with every table at σ 1, kernels vs plain: at
# most this share of the logits' change from zero tables (and LOGITS_TOL),
# so that a dropped or misplaced bias, which moves them by about that change,
# fails however small the change is at random weights
RPE_SHARE_TOL = 1e-2
BF16_PARAM_GRAD_TOL = 2.5e-2
# the srformer's proj_sr gradient in f32, max|err| / max|ref|: it reaches its
# weights through the instance norm, whose gradient takes out each channel's
# mean, and the sum that is left cancels; tests/test_torch_efficient.py's
# SR_CONV_TOL['model'] (the split against one rank on the CPU read 7.6e-5)
SR_CONV_TOL = 3e-4
# experiment_spatial: each logged loss of the bf16 recipe on the mesh of one
# card against the same run without the mesh (B7a/B7b for B1/B2, the halo
# rows' gradients added after the kernel): the steps' small differences in
# the gradients' rounding reach the loss through AdamW's updates
EXPERIMENT_LOSS_TOL = 1e-3
# H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median time of one call in ms, by CUDA events, after two warm-ups."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, by=None):
    """The card's time of one call in ms: the time of the kernels that
    ``torch.profiler`` records over ``reps`` calls (after two warm-ups),
    over ``reps``. The host's share of a call is its event time less this.
    With ``by`` (a function of a kernel's name) {by(name): ms} instead."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            key = by(e.key) if by else None
            groups[key] = groups.get(key, 0.0) + us / 1e3 / reps
    return groups if by else sum(groups.values())


def burst_ms(fn, reps: int = 100) -> float:
    """Time of one call in ms from ``reps`` calls between one pair of CUDA
    events, after two warm-ups: the host's work of a call hides behind the
    card's where it is the shorter."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe_split(torch) -> dict:
    """P's time per call at the probe's shape in bf16, for ``consume_base``
    (the base layout), ``consume_perm`` (its permuted view) and, on the same
    views, the library call ``torch.mul(x, 2)``: {name: {"event": median of
    20 calls each between a pair of events (the record's ms), "burst": 100
    calls between one pair, "device": the card's time, ``device_ms``}}. It
    times whichever ``vil_tpu_torch`` is importable, so another tree's P
    can be timed by this same function."""
    from vil_tpu_torch.tools import layout_probe as lp

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(lp.B, lp.MX, lp.MY, lp.W2, lp.C, generator=gen,
                    device="cuda").to(torch.bfloat16)
    xt = x.permute(1, 2, 3, 0, 4)
    calls = {"consume_base": lambda: lp.consume_base(x),
             "consume_perm": lambda: lp.consume_perm(xt),
             "torch.mul base": lambda: torch.mul(x, 2),
             "torch.mul perm": lambda: torch.mul(xt, 2)}
    return {name: {"event": time_ms(fn), "burst": burst_ms(fn), "device": device_ms(fn)}
            for name, fn in calls.items()}


# the rows and widths of the fused training step's LayerNorm launches, with
# their counts: the image and global rows of the chunked stages' attention
# and MLP pre-norms, then the dense stages' tokens
LN_STEP = ((200704, 96, 2), (64, 96, 2), (50176, 192, 4), (64, 192, 4), (12608, 384, 16),
           (3136, 768, 2))


def card_times(torch, family) -> dict:
    """Per step, bf16 at ViL-Small 224² batch 64: B5 per random-shift step
    (mode 1: stage 1 once, stage 2 twice); B9a (with the LSE and the saved q
    and attn, as training calls it), B9b, B8a and B8b per fused training
    step (stage 1 once, stage 2 twice; the LayerNorms at ``LN_STEP``):
    {"B5" | "B9a" | "B9b" | "B8a" | "B8b": {"event": median of 20 steps each
    between a pair of events, "device": the card's time by ``device_ms``,
    "parts": that time by ``family`` (a kernel name's group)}}. It times
    whichever ``vil_tpu_torch`` is importable, so another tree's kernels can
    be timed by this same function."""
    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops.kernels import (
        layer_norm_bwd, layer_norm_fwd, mask_to_additive, vil_block_bwd, vil_block_fwd,
        vil_mode_attention_fwd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev) * scale).to(
        torch.bfloat16)
    H, w2 = 3, 49
    mode_calls, fwd_calls, block_calls = [], [], []
    for mx, C in ((8, 96), (4, 192)):  # stage 1, stage 2
        M, shape = C // H, (BATCH, mx, mx, w2, C)
        masks = [torch.from_numpy(mask_to_additive(masks_lib.invalid_mask(
            mx, mx, 0, 0, 7, 0, mode), mx, mx, w2, 1)).to(dev) for mode in (0, 1)]
        ops = [randn(*shape, scale=M ** -0.5) for _ in range(3)] + [randn(BATCH, 1, C)] * 2
        mode_calls.append(lambda ops=ops, mask=masks[1]: vil_mode_attention_fwd(
            *ops, None, mask, H, 1, with_lse=True))
        ws = [randn(C, C, scale=C ** -0.5 * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
        bs = [torch.randn(C, generator=gen, device=dev) * 0.02 for _ in range(4)]
        args = [randn(*shape), ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
                randn(BATCH, 1, C), randn(BATCH, 1, C), None]
        fwd_calls.append(lambda args=args, mask=masks[0]: vil_block_fwd(
            *args, mask, H, with_lse=True, saved=True))
        _, k, v, lse, q, attn = fwd_calls[-1]()
        block_calls.append(lambda args=args, mask=masks[0], g=randn(*shape), lse=lse,
                           saved=(q, k, v, attn): vil_block_bwd(*args, g, mask, lse, H, saved))
    ln_fwd, ln_bwd = [], []
    for rows, C, count in LN_STEP:
        x, dy = randn(rows, C), randn(rows, C)
        gamma, beta = torch.ones(C, device=dev), torch.zeros(C, device=dev)
        ln_fwd += [lambda x=x, gamma=gamma, beta=beta: layer_norm_fwd(x, gamma, beta)] * count
        ln_bwd += [lambda x=x, gamma=gamma, dy=dy: layer_norm_bwd(x, gamma, dy)] * count
    steps = {
        "B5": lambda: (mode_calls[0](), mode_calls[1](), mode_calls[1]()),
        "B9a": lambda: (fwd_calls[0](), fwd_calls[1](), fwd_calls[1]()),
        "B9b": lambda: (block_calls[0](), block_calls[1](), block_calls[1]()),
        "B8a": lambda: [call() for call in ln_fwd],
        "B8b": lambda: [call() for call in ln_bwd],
    }
    out = {}
    for name, step in steps.items():
        parts = device_ms(step, by=family)
        out[name] = {"event": time_ms(step), "device": sum(parts.values()), "parts": parts}
    return out


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(moved_bytes: int, flops: float) -> tuple[float, float]:
    """(ms at the HBM rate, ms at the dense bf16 rate) for one call."""
    return moved_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3


def check_kernels(torch, records, self_only=False):
    """Phase 3. Fills ``records[name]`` with errors and per-step times. With
    ``self_only`` the self-only (mode -1) cases alone (part self_chunk),
    which the phase itself leaves out. Its cases run the bf16 sliding-chunk
    kernels under ``VIL_TPU_BF16_EXP`` 0, the f32 exponent their limits
    against the f32 plain versions were measured on (PRs 6-22);
    ``check_bf16_exp`` then holds them under both settings."""
    saved = os.environ.get("VIL_TPU_BF16_EXP")
    os.environ["VIL_TPU_BF16_EXP"] = "0"
    try:
        check_kernel_cases(torch, records, self_only)
    finally:
        if saved is None:
            os.environ.pop("VIL_TPU_BF16_EXP", None)
        else:
            os.environ["VIL_TPU_BF16_EXP"] = saved


def check_kernel_cases(torch, records, self_only):
    """Phase 3's cases (``check_kernels``)."""
    import torch.nn.functional as F

    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops import sliding_chunk as sc
    from vil_tpu_torch.ops.kernels import (
        full_attention_bwd, full_attention_bwd_reference, full_attention_fwd,
        full_attention_reference, layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
        layer_norm_reference, mask_to_additive, vil_attention_bwd,
        vil_attention_bwd_reference, vil_attention_fwd, vil_attention_halo_bwd,
        vil_attention_halo_bwd_reference, vil_attention_halo_fwd,
        vil_attention_halo_reference, vil_attention_reference, vil_block_bwd,
        vil_block_bwd_reference, vil_block_fwd, vil_block_fwd_reference, vil_block_reference,
        vil_mode_attention_bwd, vil_mode_attention_bwd_reference, vil_mode_attention_fwd,
        vil_mode_attention_halo_bwd, vil_mode_attention_halo_bwd_reference,
        vil_mode_attention_halo_fwd, vil_mode_attention_halo_reference,
        vil_mode_attention_reference,
    )
    from vil_tpu_torch.ops.kernels.vil_attention_halo import halo_neighborhood
    from vil_tpu_torch.ops.kernels.vil_mode_attention_halo import halo_sampled_neighborhood
    from vil_tpu_torch.models.attention import sliding_chunk_rpe_bias
    from vil_tpu_torch.tools import layout_probe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale
    cast = lambda ts, dtype: [None if t is None else t.to(dtype) for t in ts]

    def max_err(out, ref):
        return (out.float() - ref.float()).abs().max().item()

    def rel_err(out, ref):
        return max_err(out, ref) / max(1.0, ref.float().abs().max().item())

    def scaled_err(out, ref):
        """max|err| / max|ref| with no floor (max|err| where ref is all 0)."""
        top = ref.float().abs().max().item()
        return max_err(out, ref) / top if top else max_err(out, ref)

    def check(what, err, tol):
        if not err <= tol:
            raise AssertionError(f"{what}: error {err} > {tol}")

    def same_bits(what, grads, again):
        """A second launch's gradients equal the first's bit for bit."""
        same = all(torch.equal(x, y) for x, y in zip(grads, again) if x is not None)
        phase("kernels", f"{what}: a second launch bit for bit: {same}")
        if not same:
            raise AssertionError(f"{what}: a second launch gave other bits")

    def chunk_scaled(out, ref, grads, refs):
        """Scaled errors of a bf16 sliding-chunk forward's out and its
        backward's dq, dk, dv, dk_glo, dv_glo and (biased) dbias."""
        names = ("out", "dq", "dk", "dv", "dk_glo", "dv_glo", "dbias")
        return {n: scaled_err(x, r) for n, x, r in zip(names, (out, *grads), (ref, *refs))
                if r is not None}

    def scaled_text(errs, tol=CHUNK_SCALED_TOL):
        return ("; scaled " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                + f" (tol {tol:g})") if errs else ""

    def account(name, per_step, ms, plain_ms, moved, flops, library_ms=None):
        """Add one launch shape's per-step share to the kernel's record."""
        rec = records[name]
        t_bytes, t_ops = bound_ms(moved, flops)
        rec["ms"] += per_step * ms
        rec["plain_ms"] += per_step * plain_ms
        rec["bound_ms"] += per_step * max(t_bytes, t_ops)
        rec["_bytes_ms"] += per_step * t_bytes
        rec["_ops_ms"] += per_step * t_ops
        if library_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + per_step * library_ms
        return (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} "
                f"ms ({'bytes' if t_bytes >= t_ops else 'operations'})")

    def sdpa_times(q, k, v, g, attn_mask=None):
        """(forward ms, backward-alone ms, forward+backward ms) of
        scaled_dot_product_attention on the same values (q is pre-scaled, so
        scale=1), (batch, H, rows, M) operands."""
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask, scale=1.0)
        with torch.no_grad():
            fwd = time_ms(sdpa)
        o = sdpa()
        bwd = time_ms(lambda: torch.autograd.grad(o, leaves, g, retain_graph=True))
        both = time_ms(lambda: torch.autograd.grad(sdpa(), leaves, g))
        return fwd, bwd, both

    def chunk_case(label, B, nx, ny, w, C, H, nglo, exact, with_bias, mode=0, per_step=0.0,
                   bias=None, timed=False, repeat=False):
        """A sliding-chunk case: B1/B2 at mode 0, B5/B6 (the sampled
        neighbour of ``mode``) at modes 1..8, their self-only instances at
        mode -1. ``per_step`` is the case's share of one training step's
        launches; ``timed`` times it without a share. ``bias`` (f32, front
        order) replaces the random one. With ``repeat`` the backward is
        launched again and must give the same bits."""
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        w2, M = w * w, C // H
        cols = nglo + (9 if mode == 0 else 1 if mode == -1 else 2) * w2
        if mode == 0:  # B2 and B6 take the forward's out (their bf16 kernels' δ)
            name, fwd = "vil_attention", vil_attention_fwd
            bwd = lambda *a, bias, g, out, lse: vil_attention_bwd(*a, bias, g, out, mask, lse, H)
            fwd_ref, bwd_ref = vil_attention_reference, vil_attention_bwd_reference
            tail = ()
        else:  # through vil_self_attention_fwd / _bwd at mode -1
            name = "vil_self_attention" if mode == -1 else "vil_mode_attention"
            fwd = vil_mode_attention_fwd
            bwd = lambda *a, bias, g, out, lse: vil_mode_attention_bwd(*a, bias, g, out, mask,
                                                                       lse, H, mode)
            fwd_ref, bwd_ref = vil_mode_attention_reference, vil_mode_attention_bwd_reference
            tail = (mode,)
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(mx, my, padx, pady, w, exact, mode), mx, my, w2, nglo,
        )).to(dev)
        acts = [randn(B, mx, my, w2, C, scale=C ** -0.25) for _ in range(3)]
        acts += [randn(B, nglo, C) if nglo else None for _ in range(2)]
        g0 = randn(B, mx, my, w2, C)
        if bias is None and with_bias:
            bias = randn(H, w2, cols, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a = cast(acts, dtype)
            g = g0.to(dtype)
            a32 = cast(a, torch.float32)
            out, lse = fwd(*a, bias, mask, H, *tail, with_lse=True)
            ref, ref_lse = fwd_ref(*a32, bias, mask, H, *tail, with_lse=True)
            grads = bwd(*a, bias=bias, g=g, out=out, lse=lse)
            refs = bwd_ref(*a32, bias, g.float(), mask, H, *tail)
            if repeat:
                same_bits(f"{name}_bwd {label} {str(dtype)[6:]}", grads,
                          bwd(*a, bias=bias, g=g, out=out, lse=lse))
            torch.cuda.synchronize()
            e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
            e_grad = max(rel_err(x, r) for x, r in zip(grads, refs) if r is not None)
            e_abs = max(max_err(x, r) for x, r in zip(grads, refs) if r is not None)
            dt = str(dtype)[6:]
            e_scaled = chunk_scaled(out, ref, grads, refs) if dtype == torch.bfloat16 else {}
            phase("kernels", f"{name} {label} {dt}: out {e_out:.3e} (tol {tol:g}), lse "
                             f"{e_lse:.3e} (tol {LSE_TOL:g}); grads rel {e_grad:.3e} "
                             f"(tol {GRAD_TOL[dt]:g}){scaled_text(e_scaled)}")
            check(f"{name} fwd {label} {dt}", e_out, tol)
            check(f"{name} lse {label} {dt}", e_lse, LSE_TOL)
            check(f"{name} bwd {label} {dt}", e_grad, GRAD_TOL[dt])
            for n, e in e_scaled.items():
                check(f"{name} {n} scaled {label} {dt}", e, CHUNK_SCALED_TOL)
            if (per_step or timed) and dtype == torch.bfloat16:  # the training step's type
                if per_step:
                    records[f"{name}_fwd"]["max_abs_err"] = max(
                        records[f"{name}_fwd"]["max_abs_err"], e_out)
                    records[f"{name}_bwd"]["max_abs_err"] = max(
                        records[f"{name}_bwd"]["max_abs_err"], e_abs)
                # the library comparator: SDPA over the materialised
                # [glo ‖ neighbourhood] keys, one batch row per (image, chunk),
                # the bias added to the mask
                heads = lambda t: t.view(B * mx * my, -1, H, M).transpose(1, 2)

                def materialise():
                    kv = []
                    for t, t_glo in ((a[1], a[3]), (a[2], a[4])):
                        nbh = sc.neighborhood(t, mode)  # (B, mx, my, K·W², C)
                        if nglo:
                            nbh = torch.cat([t_glo[:, None, None].expand(B, mx, my, nglo, C),
                                             nbh], dim=3)
                        kv.append(heads(nbh))
                    return kv

                cat_ms = time_ms(materialise)
                k_cat, v_cat = materialise()
                full_mask = (mask[:, :, None] if bias is None else
                             mask[:, :, None] + bias[None, None]).to(dtype)
                attn_mask = (full_mask[None].expand(B, -1, -1, -1, -1, -1)
                             .reshape(B * mx * my, full_mask.shape[2], -1, cols))
                lib_fwd, lib_bwd, lib_both = sdpa_times(heads(a[0]), k_cat, v_cat, heads(g),
                                                        attn_mask)
                act = B * mx * my * w2 * C
                fwd_flops = 4.0 * act * cols
                msg = account(
                    f"{name}_fwd", per_step,
                    time_ms(lambda: fwd(*a, bias, mask, H, *tail, with_lse=True)),
                    time_ms(lambda: fwd_ref(*a, bias, mask, H, *tail, with_lse=True)),
                    nbytes(*a, bias, mask, out, lse), fwd_flops, lib_fwd)
                share = f"x{per_step:g} per step" if per_step else "per call"
                phase("kernels", f"  {name}_fwd with lse, {share}: {msg}, SDPA "
                                 f"forward {lib_fwd:.4f} ms")
                msg = account(
                    f"{name}_bwd", per_step,
                    time_ms(lambda: bwd(*a, bias=bias, g=g, out=out, lse=lse)),
                    time_ms(lambda: bwd_ref(*a, bias, g, mask, H, *tail)),
                    nbytes(*a, bias, mask, lse, g, *grads), 2.5 * fwd_flops, lib_bwd)
                phase("kernels", f"  {name}_bwd, {share}: {msg}, SDPA backward "
                                 f"{lib_bwd:.4f} ms, SDPA forward+backward {lib_both:.4f} ms")
                phase("kernels", f"  concatenating the [glo | {cols // w2}-chunk] keys and "
                                 f"values for SDPA (not in its times): {cat_ms:.4f} ms")
                if mode == 0:
                    serve_ms = time_ms(lambda: fwd(*a, bias, mask, H))
                    phase("kernels", f"  {name}_fwd without lse (serving): {serve_ms:.4f} ms")

    def full_case(label, B, N, C, H, with_bias, per_step=0, timed=False, bias=None,
                  repeat=False):
        """A dense case; ``timed`` times it without a share of the step.
        ``bias`` (f32) replaces the random one. With ``repeat`` the backward
        is launched again and must give the same bits."""
        M = C // H
        acts = [randn(B, N, C, scale=C ** -0.25) for _ in range(3)]
        g0 = randn(B, N, C)
        if bias is None and with_bias:
            bias = randn(H, N, N, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a = cast(acts, dtype)
            g = g0.to(dtype)
            a32 = cast(a, torch.float32)
            out, lse = full_attention_fwd(*a, bias, H, with_lse=True)
            ref, ref_lse = full_attention_reference(*a32, bias, H, with_lse=True)
            grads = full_attention_bwd(*a, bias, g, out, lse, H)
            refs = full_attention_bwd_reference(*a32, bias, g.float(), H)
            if repeat:
                same_bits(f"full_attention_bwd {label} {str(dtype)[6:]}", grads,
                          full_attention_bwd(*a, bias, g, out, lse, H))
            torch.cuda.synchronize()
            e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
            e_grad = max(rel_err(x, r) for x, r in zip(grads, refs) if r is not None)
            e_abs = max(max_err(x, r) for x, r in zip(grads, refs) if r is not None)
            dt = str(dtype)[6:]
            scaled = ""
            if dtype == torch.bfloat16:
                e_scaled = {n: scaled_err(x, r) for n, x, r in
                            zip(("out", "dq", "dk", "dv"), (out, *grads[:3]), (ref, *refs[:3]))}
                scaled = ("; scaled " + ", ".join(f"{n} {e:.3e}" for n, e in e_scaled.items())
                          + f" (tol {DENSE_SCALED_TOL:g})")
            phase("kernels", f"full_attention {label} {dt}: out {e_out:.3e} (tol {tol:g}), lse "
                             f"{e_lse:.3e} (tol {LSE_TOL:g}); grads rel {e_grad:.3e} "
                             f"(tol {GRAD_TOL[dt]:g}){scaled}")
            check(f"full fwd {label} {dt}", e_out, tol)
            check(f"full lse {label} {dt}", e_lse, LSE_TOL)
            check(f"full bwd {label} {dt}", e_grad, GRAD_TOL[dt])
            if dtype == torch.bfloat16:
                for n, e in e_scaled.items():
                    check(f"full {n} scaled {label} {dt}", e, DENSE_SCALED_TOL)
            if (per_step or timed) and dtype == torch.bfloat16:
                if per_step:
                    records["full_attention_fwd"]["max_abs_err"] = max(
                        records["full_attention_fwd"]["max_abs_err"], e_out)
                    records["full_attention_bwd"]["max_abs_err"] = max(
                        records["full_attention_bwd"]["max_abs_err"], e_abs)
                # the library comparator: SDPA on the same values, heads as a
                # batch dimension
                lib_fwd, lib_bwd, lib_both = sdpa_times(
                    *(t.view(B, N, H, M).transpose(1, 2) for t in (*a, g)),
                    attn_mask=None if bias is None else bias.to(dtype)[None])
                fwd_flops = 4.0 * B * N * N * C
                share = f"x{per_step} per step" if per_step else "per call"
                msg = account(
                    "full_attention_fwd", per_step,
                    time_ms(lambda: full_attention_fwd(*a, bias, H, with_lse=True)),
                    time_ms(lambda: full_attention_reference(*a, bias, H, with_lse=True)),
                    nbytes(*a, bias, out, lse), fwd_flops, lib_fwd)
                phase("kernels", f"  full_attention_fwd with lse, {share}: {msg}, "
                                 f"SDPA forward {lib_fwd:.4f} ms")
                msg = account(
                    "full_attention_bwd", per_step,
                    time_ms(lambda: full_attention_bwd(*a, bias, g, out, lse, H)),
                    time_ms(lambda: full_attention_bwd_reference(*a, bias, g, H)),
                    nbytes(*a, bias, lse, g, *grads), 2.5 * fwd_flops, lib_bwd)
                phase("kernels", f"  full_attention_bwd, {share}: {msg}, SDPA "
                                 f"backward {lib_bwd:.4f} ms, SDPA forward+backward "
                                 f"{lib_both:.4f} ms")
                serve_ms = time_ms(lambda: full_attention_fwd(*a, bias, H))
                phase("kernels", f"  full_attention_fwd without lse (serving): {serve_ms:.4f} ms")

    def ln_case(rows, C, per_step=0):
        """A LayerNorm case: B8a and B8b at (rows, C), ``per_step`` of the
        fused training step's launches; B8b launched twice, bit for bit."""
        x0, dy0 = randn(rows, C, scale=2.0) + 0.5, randn(rows, C)
        gamma, beta = randn(C, scale=0.2) + 1.0, randn(C, scale=0.1)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, dy = x0.to(dtype), dy0.to(dtype)
            y = layer_norm_fwd(x, gamma, beta)
            grads = layer_norm_bwd(x, gamma, dy)
            again = layer_norm_bwd(x, gamma, dy)
            ref = layer_norm_reference(x.float(), gamma, beta)
            refs = layer_norm_bwd_reference(x.float(), gamma, dy.float())
            torch.cuda.synchronize()
            e_out = max_err(y, ref)
            e_grad = max(rel_err(a, r) for a, r in zip(grads, refs))
            differ = [n for n, a, b in zip(("dx", "dgamma", "dbeta"), grads, again)
                      if not torch.equal(a, b)]
            dt = str(dtype)[6:]
            phase("kernels", f"layer_norm ({rows},{C}) {dt}: y {e_out:.3e} (tol {tol:g}); "
                             f"dx, dgamma, dbeta rel {e_grad:.3e} (tol {GRAD_TOL[dt]:g}); a "
                             f"second backward bitwise equal: {not differ}")
            check(f"layer_norm fwd ({rows},{C}) {dt}", e_out, tol)
            check(f"layer_norm bwd ({rows},{C}) {dt}", e_grad, GRAD_TOL[dt])
            if differ:
                raise AssertionError(f"layer_norm bwd ({rows},{C}) {dt}: two launches differ "
                                     f"in {differ}")
            if not (per_step and dtype == torch.bfloat16):
                continue
            records["layer_norm_fwd"]["max_abs_err"] = max(
                records["layer_norm_fwd"]["max_abs_err"], e_out)
            records["layer_norm_bwd"]["max_abs_err"] = max(
                records["layer_norm_bwd"]["max_abs_err"],
                max(max_err(a, r) for a, r in zip(grads, refs)))
            # the library: F.layer_norm on the same bf16 values, γ and β in
            # bf16 as nn.LayerNorm keeps them; its backward timed alone on a
            # saved forward
            leaves = [t.detach().requires_grad_() for t in (x, gamma.to(dtype), beta.to(dtype))]
            lib = lambda: F.layer_norm(leaves[0], (C,), leaves[1], leaves[2], 1e-6)
            with torch.no_grad():
                lib_fwd = time_ms(lib)
            y_lib = lib()
            lib_bwd = time_ms(lambda: torch.autograd.grad(y_lib, leaves, dy, retain_graph=True))
            elems = rows * C
            msg = account("layer_norm_fwd", per_step,
                          time_ms(lambda: layer_norm_fwd(x, gamma, beta)),
                          time_ms(lambda: layer_norm_reference(x, gamma, beta)),
                          nbytes(x, gamma, beta, y), 8.0 * elems, lib_fwd)
            phase("kernels", f"  layer_norm_fwd ({rows},{C}), x{per_step} per step: {msg}, "
                             f"F.layer_norm {lib_fwd:.4f} ms")
            msg = account("layer_norm_bwd", per_step,
                          time_ms(lambda: layer_norm_bwd(x, gamma, dy)),
                          time_ms(lambda: layer_norm_bwd_reference(x, gamma, dy)),
                          nbytes(x, gamma, dy, *grads), 16.0 * elems, lib_bwd)
            phase("kernels", f"  layer_norm_bwd ({rows},{C}), x{per_step} per step: {msg}, "
                             f"F.layer_norm backward {lib_bwd:.4f} ms")

    def block_case(label, B, nx, ny, w, C, H, nglo, with_bias, per_step=0, bias_scale=0.02,
                   backward=True, bias=None, timed=False):
        """A fused-block case: B9a and (``backward``) B9b, ``per_step`` of the
        fused training step's launches (``timed``: timed without a share);
        q, k, v and output biases of ``bias_scale`` (bq scale-folded).
        ``bias`` (the f32 score bias, front order) replaces the random one."""
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        w2, M = w * w, C // H
        cols = nglo + 9 * w2
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(mx, my, padx, pady, w, 0, 0), mx, my, w2, nglo)).to(dev)
        x0, g0 = randn(B, mx, my, w2, C), randn(B, mx, my, w2, C)
        # wq and bq scale-folded as the model passes them
        w0 = [randn(C, C, scale=C ** -0.5 * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
        b0 = [randn(C, scale=bias_scale * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
        glo0 = [randn(B, nglo, C) if nglo else None for _ in range(2)]
        if bias is None and with_bias:
            bias = randn(H, w2, cols, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x, g = x0.to(dtype), g0.to(dtype)
            ws = [t.to(dtype) for t in w0]
            ops = [x, ws[0], b0[0], ws[1], b0[1], ws[2], b0[2], ws[3], b0[3],
                   *cast(glo0, dtype), bias]
            ops32 = [None if t is None else t.float() for t in ops]
            y, k, v, lse, q, attn = vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)
            grads = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn)) if backward else ()
            refs = vil_block_bwd_reference(*ops32, g.float(), mask, H) if backward else ()
            ry, rk, rv = vil_block_reference(*ops32, mask, H)
            # the LSE of the plain attention over the kernel's own q and k
            r_lse = vil_attention_reference(*(t.float() for t in (q, k, v)), *ops32[9:11],
                                            bias, mask, H, with_lse=True)[1]
            torch.cuda.synchronize()
            e_out = max(max_err(a, r) for a, r in ((y, ry), (k, rk), (v, rv)))
            e_lse = max_err(lse, r_lse)
            # dbk (index 4) is held at dWk's scale: its exact value is 0 (a
            # shift common to a query's scores leaves its softmax alone), so
            # what comes out is the rounding of a sum over the rows of terms
            # of dWk's size
            e_grad = max((max_err(a, r) / max(1.0, refs[3 if i == 4 else i].abs().max().item())
                          for i, (a, r) in enumerate(zip(grads, refs)) if r is not None),
                         default=0.0)
            e_abs = max((max_err(a, r) for a, r in zip(grads, refs) if r is not None),
                        default=0.0)
            dt = str(dtype)[6:]
            e_scaled, same, differ = {}, "" if backward else "; forward only", []
            if dtype == torch.bfloat16:
                # B9a's outputs, and every gradient, to max|err| / max|ref|
                # with no floor (dbk at dWk's scale, as above), and a second
                # B9b launch bit for bit
                fwd_refs = vil_block_fwd_reference(*ops32, mask, H, with_lse=True)
                for n, a, r in zip(BLOCK_FWD_OUTS, (y, q, k, v, attn, lse), fwd_refs):
                    e_scaled[n] = scaled_err(a, r)
                for i, (n, a, r) in enumerate(zip(BLOCK_GRADS, grads, refs)):
                    if r is not None:
                        e_scaled[n] = max_err(a, r) / refs[3 if i == 4 else i].abs().max().item()
                if backward:
                    again = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))
                    differ = [n for n, a, b in zip(BLOCK_GRADS, grads, again)
                              if a is not None and not torch.equal(a, b)]
                    same = f"; a second launch bitwise equal: {not differ}"
            phase("kernels", f"vil_block {label} {dt}: y, k, v {e_out:.3e} (tol {tol:g}), lse "
                             f"{e_lse:.3e} (tol {LSE_TOL:g}); grads rel {e_grad:.3e} "
                             f"(tol {GRAD_TOL[dt]:g}){scaled_text(e_scaled)}{same}")
            check(f"vil_block fwd {label} {dt}", e_out, tol)
            check(f"vil_block lse {label} {dt}", e_lse, LSE_TOL)
            check(f"vil_block bwd {label} {dt}", e_grad, GRAD_TOL[dt])
            for n, e in e_scaled.items():
                check(f"vil_block {n} scaled {label} {dt}", e, CHUNK_SCALED_TOL)
            if differ:
                raise AssertionError(f"vil_block bwd {label}: two launches differ in {differ}")
            if not ((per_step or timed) and dtype == torch.bfloat16):
                continue
            if per_step:
                records["vil_block_fwd"]["max_abs_err"] = max(
                    records["vil_block_fwd"]["max_abs_err"], e_out)
                records["vil_block_bwd"]["max_abs_err"] = max(
                    records["vil_block_bwd"]["max_abs_err"], e_abs)
            share = f"x{per_step} per step" if per_step else "per call"
            R = B * mx * my * w2
            attn_flops = 4.0 * R * C * cols
            fwd_in = (x, *ws, *b0, *cast(glo0, dtype), bias, mask)
            msg = account("vil_block_fwd", per_step,
                          time_ms(lambda: vil_block_fwd(*ops, mask, H, with_lse=True,
                                                        saved=True)),
                          time_ms(lambda: vil_block_reference(*ops, mask, H)),
                          nbytes(*fwd_in, y, k, v, lse), 8.0 * R * C * C + attn_flops)
            phase("kernels", f"  vil_block_fwd with lse, q and attn, {share}: "
                             f"{msg}; no single PyTorch call computes the block (library: "
                             f"null)")
            msg = account("vil_block_bwd", per_step,
                          time_ms(lambda: vil_block_bwd(*ops, g, mask, lse, H,
                                                        (q, k, v, attn))),
                          time_ms(lambda: vil_block_bwd_reference(*ops, g, mask, H)),
                          nbytes(*fwd_in, q, k, v, attn, g, lse, *grads),
                          16.0 * R * C * C + 2.5 * attn_flops + 4.0 * R * C * nglo)
            phase("kernels", f"  vil_block_bwd from the saved q, k, v, attn, {share}: {msg}; "
                             f"library: null")
            serve_ms = time_ms(lambda: vil_block_fwd(*ops, mask, H))
            phase("kernels", f"  vil_block_fwd without lse (serving): {serve_ms:.4f} ms")

    def halo_case(label, B, nx, ny, w, C, H, nglo, exact, with_bias, splits, per_fwd=0,
                  per_bwd=0, bias=None, timed=False, mode=0):
        """Halo-input cases: at mode 0 B7a and B7b, at modes 1..8 (random
        shift) their sampled-neighbour form B5h and B6h, on every shard of
        the grid split over each D of ``splits`` (equal shards), or into the
        chunk-row counts of each tuple of ``splits`` (a ragged split: every
        shard's kernels timed in bf16), against their plain versions; the
        shards together against B1 and B2 (B5 and B6 at ``mode``) on the
        whole grid. ``per_fwd`` is the case's share of one spatial serving
        forward's B7a launches on one rank (D = 1), or of one shift_spatial
        step's B5h launches, ``per_bwd`` its share of one train_spatial
        step's B7b launches (shift_spatial's B6h); with ``per_fwd``,
        ``per_bwd`` or ``timed`` every equal split's shard 0 is timed (all
        its shards do the same work; SDPA with the bias in its mask). At
        modes 1..8 every case prints its bound per shard, and the first
        shard's backward is launched twice, bit for bit."""
        padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
        w2, M = w * w, C // H
        cols = nglo + (9 if mode == 0 else 2) * w2
        if mode == 0:
            name, tail = "vil_attention_halo", ()
            h_fwd, h_bwd = vil_attention_halo_fwd, vil_attention_halo_bwd
            h_fwd_ref, h_bwd_ref = vil_attention_halo_reference, vil_attention_halo_bwd_reference
            whole_fwd, whole_bwd, whole = vil_attention_fwd, vil_attention_bwd, ("B1", "B2")
            nbh_of = halo_neighborhood
        else:
            name, tail = "vil_mode_attention_halo", (mode,)
            h_fwd, h_bwd = vil_mode_attention_halo_fwd, vil_mode_attention_halo_bwd
            h_fwd_ref = vil_mode_attention_halo_reference
            h_bwd_ref = vil_mode_attention_halo_bwd_reference
            whole_fwd, whole_bwd, whole = vil_mode_attention_fwd, vil_mode_attention_bwd, ("B5",
                                                                                           "B6")
            nbh_of = lambda t: halo_sampled_neighborhood(t, mode)
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(mx, my, padx, pady, w, exact, mode), mx, my, w2,
            nglo)).to(dev)
        acts = [randn(B, mx, my, w2, C, scale=C ** -0.25) for _ in range(3)]
        acts += [randn(B, nglo, C) if nglo else None for _ in range(2)]
        g0 = randn(B, mx, my, w2, C)
        if bias is None and with_bias:
            bias = randn(H, w2, cols, scale=0.5)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            a = cast(acts, dtype)
            g = g0.to(dtype)
            dt = str(dtype)[6:]
            b1_out, b1_lse = whole_fwd(*a, bias, mask, H, *tail, with_lse=True)
            b2_grads = whole_bwd(*a, bias, g, b1_out, mask, b1_lse, H, *tail)
            for split in splits:
                ragged = not isinstance(split, int)
                counts = list(split) if ragged else [mx // split] * split
                D = len(counts)
                outs, e_out, e_lse, e_grad, e_abs, e_scaled = [], 0.0, 0.0, 0.0, 0.0, {}
                dk, dv = (torch.zeros(B, mx, my, w2, C, device=dev) for _ in range(2))
                shards = []
                for sh, n in enumerate(counts):
                    lo = sum(counts[:sh])
                    rows = [(lo - 1) % mx, *range(lo, lo + n), (lo + n) % mx]
                    ops = [a[0][:, lo:lo + n].contiguous(), a[1][:, rows].contiguous(),
                           a[2][:, rows].contiguous(), a[3], a[4], bias]
                    m_rows = mask[lo:lo + n]
                    gs = g[:, lo:lo + n].contiguous()
                    ops32 = cast(ops, torch.float32)
                    out, lse = h_fwd(*ops, m_rows, H, *tail, with_lse=True)
                    ref, ref_lse = h_fwd_ref(*ops32, m_rows, H, *tail, with_lse=True)
                    grads = h_bwd(*ops, gs, out, m_rows, lse, H, *tail)
                    refs = h_bwd_ref(*ops32, gs.float(), m_rows, H, *tail)
                    if mode and sh == 0:
                        same_bits(f"{name}_bwd {label}, D {D} {dt}", grads,
                                  h_bwd(*ops, gs, out, m_rows, lse, H, *tail))
                    torch.cuda.synchronize()
                    if dtype == torch.bfloat16:
                        for n, e in chunk_scaled(out, ref, grads, refs).items():
                            e_scaled[n] = max(e_scaled.get(n, 0.0), e)
                    e_out, e_lse = max(e_out, max_err(out, ref)), max(e_lse, max_err(lse, ref_lse))
                    e_grad = max(e_grad, *(rel_err(x, r) for x, r in zip(grads, refs)
                                           if r is not None))
                    e_abs = max(e_abs, *(max_err(x, r) for x, r in zip(grads, refs)
                                         if r is not None))
                    outs.append(out)
                    for e, row in enumerate(rows):  # the halo rows' owners
                        dk[:, row] += grads[1][:, e].float()
                        dv[:, row] += grads[2][:, e].float()
                    shards.append((ops, m_rows, gs, out, lse, grads))
                e_b1 = max_err(torch.cat(outs, dim=1), b1_out)
                e_b2 = max(rel_err(dk, b2_grads[1]), rel_err(dv, b2_grads[2]))
                phase("kernels", f"{name} {label}, D {D} (rows {counts}) {dt}: "
                                 f"out {e_out:.3e} (tol {tol:g}), lse {e_lse:.3e} (tol "
                                 f"{LSE_TOL:g}); grads rel {e_grad:.3e} (tol {GRAD_TOL[dt]:g})"
                                 f"{scaled_text(e_scaled)}; shards vs {whole[0]} on the whole "
                                 f"grid {e_b1:.3e}, folded dK/dV vs {whole[1]} rel {e_b2:.3e}")
                check(f"{name} fwd {label} D {D} {dt}", e_out, tol)
                check(f"{name} lse {label} D {D} {dt}", e_lse, LSE_TOL)
                check(f"{name} bwd {label} D {D} {dt}", e_grad, GRAD_TOL[dt])
                check(f"{name} shards vs {whole[0]} {label} D {D} {dt}", e_b1, tol)
                check(f"{name} folded dK/dV {label} D {D} {dt}", e_b2, GRAD_TOL[dt])
                for n, e in e_scaled.items():
                    check(f"{name} {n} scaled {label} D {D} {dt}", e, CHUNK_SCALED_TOL)
                if dtype != torch.bfloat16:
                    continue
                fwd_flops = [4.0 * B * n * my * w2 * C * cols for n in counts]
                if mode:  # each shard's bound: q, K/V with halos, mask, out, lse / g, grads
                    bounds = [max(*bound_ms(nbytes(*o, m, out, lse), f)) for (o, m, _, out, lse, _),
                              f in zip(shards, fwd_flops)]
                    bwd_bounds = [max(*bound_ms(nbytes(*o, m, lse, gg, *gr), 2.5 * f))
                                  for (o, m, gg, _, lse, gr), f in zip(shards, fwd_flops)]
                    phase("kernels", f"  {name} {label}, rows {counts}, per shard: bound fwd "
                                     f"{[round(b, 4) for b in bounds]} ms, bwd "
                                     f"{[round(b, 4) for b in bwd_bounds]} ms")
                if ragged:  # each shard's kernels, as a training step launches them
                    times = [(time_ms(lambda: h_fwd(*o, m, H, *tail, with_lse=True)),
                              time_ms(lambda: h_bwd(*o, gg, out, m, lse, H, *tail)))
                             for o, m, gg, out, lse, _ in shards]
                    phase("kernels", f"  {name} {label}, rows {counts}, per shard: "
                                     f"fwd with lse {[round(f, 4) for f, _ in times]} ms, bwd "
                                     f"{[round(b, 4) for _, b in times]} ms")
                    continue
                if not (per_fwd or per_bwd or timed):
                    continue
                mxs = counts[0]
                if per_fwd:
                    records[f"{name}_fwd"]["max_abs_err"] = max(
                        records[f"{name}_fwd"]["max_abs_err"], e_out)
                    records[f"{name}_bwd"]["max_abs_err"] = max(
                        records[f"{name}_bwd"]["max_abs_err"], e_abs)
                ops, m_rows, gs, out, lse, grads = shards[0]
                heads = lambda t: t.view(B * mxs * my, -1, H, M).transpose(1, 2)

                def materialise():  # [glo ‖ halo neighbourhood] keys, values
                    kv = []
                    for t, t_glo in ((ops[1], ops[3]), (ops[2], ops[4])):
                        nbh = nbh_of(t)
                        if nglo:
                            nbh = torch.cat([t_glo[:, None, None].expand(B, mxs, my, nglo, C),
                                             nbh], dim=3)
                        kv.append(heads(nbh))
                    return kv

                k_cat, v_cat = materialise()
                rows_mask = (m_rows[:, :, None] if bias is None else
                             m_rows[:, :, None] + bias[None, None]).to(dtype)
                attn_mask = (rows_mask[None].expand(B, -1, -1, -1, -1, -1)
                             .reshape(B * mxs * my, rows_mask.shape[2], -1, cols))
                lib_fwd, lib_bwd, _ = sdpa_times(heads(ops[0]), k_cat, v_cat, heads(gs), attn_mask)
                fwd_ms = time_ms(lambda: h_fwd(*ops, m_rows, H, *tail))
                fwd_lse_ms = time_ms(lambda: h_fwd(*ops, m_rows, H, *tail, with_lse=True))
                bwd_ms = time_ms(lambda: h_bwd(*ops, gs, out, m_rows, lse, H, *tail))
                fwd_plain = time_ms(lambda: h_fwd_ref(*ops, m_rows, H, *tail))
                bwd_plain = time_ms(lambda: h_bwd_ref(*ops, gs, m_rows, H, *tail))
                fwd_bytes = nbytes(*ops, m_rows, out)
                bwd_bytes = nbytes(*ops, m_rows, lse, gs, *grads)
                one_rank = D == 1  # the records hold the one-rank paths
                # B7a's record is a serving forward's (no LSE), B5h's a
                # training step's (with it)
                f_msg = account(f"{name}_fwd", per_fwd * one_rank,
                                fwd_lse_ms if mode else fwd_ms, fwd_plain,
                                fwd_bytes + (nbytes(lse) if mode else 0), fwd_flops[0], lib_fwd)
                b_msg = account(f"{name}_bwd", per_bwd * one_rank, bwd_ms, bwd_plain,
                                bwd_bytes, 2.5 * fwd_flops[0], lib_bwd)
                fwd_kind = "with lse" if mode else "serving, no lse"
                phase("kernels", f"  {name}_fwd {label}, D {D}, per shard ({fwd_kind}): "
                                 f"{f_msg}, SDPA forward {lib_fwd:.4f} ms; "
                                 f"{'without' if mode else 'with'} lse "
                                 f"{(fwd_ms if mode else fwd_lse_ms):.4f} ms")
                phase("kernels", f"  {name}_bwd {label}, D {D}, per shard: {b_msg}, "
                                 f"SDPA backward {lib_bwd:.4f} ms")

    def probe_case():
        """P's two entry points: exactly 2x at the probe's shape in bf16, in
        the base layout and on its permuted view (both the flat path, timed
        with the card's share of a call), then on a ragged shape, on views
        that start off a 16-byte boundary (the flat path's scalar tail and
        head) and on a slice (the strided path)."""
        x = randn(layout_probe.B, layout_probe.MX, layout_probe.MY, layout_probe.W2,
                  layout_probe.C).to(torch.bfloat16)
        xt = x.permute(1, 2, 3, 0, 4)
        split = probe_split(torch)
        for name, fn, arg in (("consume_base", layout_probe.consume_base, x),
                              ("consume_perm", layout_probe.consume_perm, xt)):
            y = fn(arg)
            torch.cuda.synchronize()
            err = max_err(y, arg * 2)
            path = layout_probe.probe_path(arg.shape, arg.stride())
            phase("kernels", f"{name} (P) {tuple(arg.shape)} bf16, strides {arg.stride()}, "
                             f"path {path}: max|err| vs x*2 {err:.3e} (tol 0)")
            check(f"{name} vs x*2", err, 0.0)
            records[name]["max_abs_err"] = err
            lib = split["torch.mul " + name[len("consume_"):]]
            msg = account(name, 1, split[name]["event"],
                          time_ms(lambda: layout_probe.scale2_reference(arg)),
                          nbytes(arg, y), float(arg.numel()), lib["event"])
            phase("kernels", f"  {name} per call: {msg}, library torch.mul "
                             f"{lib['event']:.4f} ms; the card's time {split[name]['device']:.4f} "
                             f"ms (torch.mul {lib['device']:.4f}), 100 calls between one pair "
                             f"of events {split[name]['burst']:.4f} ms a call (torch.mul "
                             f"{lib['burst']:.4f})")
        # the flat path's scalar head and tail, and the strided path
        flat = randn(3 * 2 * 2 * 7 * 5 + 8).to(torch.bfloat16)
        cases = [(f"ragged (3,2,2,7,5), {lead} element(s) into its storage",
                  flat[lead:lead + 420].view(3, 2, 2, 7, 5)) for lead in (0, 1)]
        cases.append(("a slice of the base layout, [:, 1:7]", x[:, 1:7]))
        for label, arg in cases:
            for name, fn, view in (("consume_base", layout_probe.consume_base, arg),
                                   ("consume_perm", layout_probe.consume_perm,
                                    arg.permute(1, 2, 3, 0, 4))):
                y = fn(view)
                torch.cuda.synchronize()
                err = max_err(y, view * 2)
                path = layout_probe.probe_path(view.shape, view.stride())
                phase("kernels", f"{name} (P) {label} bf16, path {path}: max|err| vs x*2 "
                                 f"{err:.3e} (tol 0)")
                check(f"{name} {label} vs x*2", err, 0.0)

    def tables(rows, H, nglo):
        """(local table, g2l, g2g) at σ 1."""
        return (randn(rows, H), randn(2, H, nglo) if nglo else None,
                randn(H, nglo, nglo) if nglo else None)

    if self_only:
        # the self-only instances of B5/B6 (mode -1): ViL-Small 224²'s
        # sliding-chunk blocks (a mode -1 step's launches), a padded grid
        # with a bias, SW_EXACT -1, two 64-row slices a chunk (W 9), head
        # dim 128 without global rows, and the RPE bias of its stages from
        # tables (front order [g2l | self])
        chunk_case("self stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False, -1,
                   per_step=1)
        chunk_case("self stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0, False, -1,
                   per_step=2)
        chunk_case("self biased, padded 3x4 grid, nglo 2", 2, 19, 25, 7, 64, 2, 2, 0, True, -1,
                   repeat=True)
        chunk_case("self SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False, -1)
        chunk_case("self W 9, 3x3 grid, biased, nglo 1", 2, 27, 27, 9, 64, 2, 1, 0, True, -1)
        chunk_case("self 3x3 grid, nglo 0, head dim 128", 2, 21, 21, 7, 256, 2, 0, 0, False, -1)
        for mx, C in ((8, 96), (4, 192)):
            table, g2l, _ = tables(27 * 27, 3, 1)
            chunk_case(f"self RPE (64,{mx},{mx},49,{C}) H3, bias (3,49,50) from tables", 64,
                       7 * mx, 7 * mx, 7, C, 3, 1, 0, True, -1, timed=True,
                       bias=sliding_chunk_rpe_bias(table, g2l, 7, -1))
        return

    # ViL-Small 224²: stage 1 (1 block) and stage 2 (2 blocks) sliding-chunk
    chunk_case("stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False, per_step=1)
    chunk_case("stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0, False, per_step=2)
    chunk_case("biased, padded 3x3 grid, nglo 2", 2, 19, 20, 7, 64, 2, 2, 0, True)
    chunk_case("SW_EXACT 1, 2x2 grid, nglo 0", 2, 13, 14, 7, 32, 1, 0, 1, True)
    chunk_case("SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False)
    chunk_case("cyclic 1x2 grid, nglo 5", 2, 7, 14, 7, 64, 2, 5, 0, False)
    # the same blocks in random-shift training, at two sampled neighbours
    # each: a step's share is the mean over the two modes
    for mode in (1, 6):
        chunk_case(f"mode {mode} stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False,
                   mode, per_step=0.5)
        chunk_case(f"mode {mode} stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0,
                   False, mode, per_step=1)
    chunk_case("mode 3 biased, padded 3x4 grid, nglo 2", 2, 19, 25, 7, 64, 2, 2, 0, True, 3)
    chunk_case("mode 2 cyclic 1x2 grid (sampled = self)", 2, 7, 14, 7, 32, 1, 1, 0, False, 2)
    chunk_case("mode 7 cyclic 2x2 grid, biased, nglo 0", 2, 13, 14, 7, 32, 1, 0, 0, True, 7)
    chunk_case("mode 5 SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False, 5)
    # W 9: two 64-row slices a chunk and 163 columns in 3 key tiles; and a
    # head dim of 128 on a 3x3 grid without global rows
    chunk_case("mode 8 W 9, 3x3 grid, biased, nglo 1", 2, 27, 27, 9, 64, 2, 1, 0, True, 8)
    chunk_case("mode 6 3x3 grid, nglo 0, head dim 128", 2, 21, 21, 7, 256, 2, 0, 0, False, 6)
    # stage 3 (8 blocks) and stage 4 (1 block) dense
    full_case("stage3 (64,197,384) H6", 64, 197, 384, 6, False, 8)
    full_case("stage4 (64,49,768) H12", 64, 49, 768, 12, False, 1)
    full_case("biased N 130", 2, 130, 96, 3, True)
    full_case("N 1025", 2, 1025, 192, 3, False)
    # every head dim at N ragged against the 64-row tiles (bf16 runs on the
    # tensor cores, whose k-depth 16 pads M = 8)
    for M in (8, 16, 32, 64, 128):
        for N in (1, 63, 64, 65):
            full_case(f"M {M} N {N}{' biased' if N % 2 else ''}", 3, N, 2 * M, 2, N % 2 == 1)
    # ViL-Small 1024² stage 3: the q-tiled tiers' length (B3t, B4b)
    full_case("N 4097", 1, 4097, 384, 6, False, timed=True)
    # the fused configuration's block pre-norms, per training step: the image
    # rows and global rows of the chunked stages' 3 blocks (attention and
    # MLP norms), then the 9 dense blocks' tokens
    for rows, C, per_step in LN_STEP:
        ln_case(rows, C, per_step)
    # and at C 100 and 1000 (C % 8 != 0: no 16-byte vectors) at 1 and 3000 rows
    for rows, C in ((1, 100), (3000, 100), (1, 1000), (3000, 1000)):
        ln_case(rows, C)
    # and its fused blocks: stage 1 (1 block), stage 2 (2 blocks)
    block_case("stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, False, per_step=1)
    block_case("stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, False, per_step=2)
    block_case("biased, padded, cyclic 2x2 grid", 2, 13, 14, 7, 64, 2, 1, True)
    block_case("biased, padded 3x3 grid, nglo 0, C 48", 2, 19, 20, 7, 48, 3, 0, True)
    # a ragged last row tile (3 x 4 x 49 rows), two global rows, head dim 128;
    # C 320 (two blocks along the products' columns) on a cyclic 3x3 grid
    block_case("cyclic 2x2 grid, nglo 2, C 128 H1", 3, 14, 14, 7, 128, 1, 2, False)
    block_case("biased cyclic 3x3 grid, C 320 H5", 2, 21, 21, 7, 320, 5, 1, True)
    # q, k and v biases as large as the products, for B9a's bias epilogue: a
    # dropped bias reads about 1.5e-2 scaled at the model's 0.02, under the
    # limit, and far above it here. B9b is not held here: rounding dS to bf16
    # (as the TPU kernel does) leaves each query's dS row a small sum, which
    # the keys' common bias multiplies into dq, so dWq and dbq read about
    # twice their usual error, the TPU kernel's own too
    # (tests/test_torch_fused.py::test_vil_block_bf16_with_large_qkv_biases_
    # matches_pallas; PERF.md §6)
    block_case("stage1 width, biases as large as the products", 4, 56, 56, 7, 96, 3, 1, False,
               bias_scale=1.0, backward=False)
    # relative position bias (ViL-Small RPE): every biased kernel at the RPE
    # step's shapes, its bias assembled from tables drawn at σ 1 by the
    # model's own assembly (front order [g2l | local]; the dense one with g2g
    # and g2l), checked as above (dbias too) and timed per call with the bias
    from vil_tpu_torch.models.attention import full_rpe_bias

    full_case("RPE stage3 (64,197,384) H6, bias (6,197,197) from tables", 64, 197, 384, 6,
              True, timed=True, bias=full_rpe_bias(*tables(27 * 27, 6, 1), 14, 14), repeat=True)
    full_case("RPE stage4 (64,49,768) H12, bias (12,49,49) from tables", 64, 49, 768, 12,
              True, timed=True, bias=full_rpe_bias(*tables(13 * 13, 12, 0), 7, 7), repeat=True)
    for stage, mx, C in ((1, 8, 96), (2, 4, 192)):
        table, g2l, _ = tables(27 * 27, 3, 1)
        shape = f"stage{stage} (64,{mx},{mx},49,{C}) H3"
        chunk_case(f"RPE {shape}, bias (3,49,442) from tables", 64, 7 * mx, 7 * mx, 7, C, 3,
                   1, 0, True, timed=True, bias=sliding_chunk_rpe_bias(table, g2l, 7),
                   repeat=True)
        block_case(f"RPE {shape}, bias (3,49,442) from tables", 64, 7 * mx, 7 * mx, 7, C, 3,
                   1, True, timed=True, bias=sliding_chunk_rpe_bias(table, g2l, 7))
        # every sampled neighbour at stage 2, modes 1 and 6 at stage 1
        for mode in range(1, 9) if stage == 2 else (1, 6):
            chunk_case(f"RPE mode {mode} {shape}, bias (3,49,99) from tables, front order",
                       64, 7 * mx, 7 * mx, 7, C, 3, 1, 0, True, mode, timed=mode in (1, 6),
                       bias=sliding_chunk_rpe_bias(table, g2l, 7, mode))
    table, g2l, _ = tables(27 * 27, 3, 1)
    halo_case("RPE stage1 (64,8,8,49,96) H3, bias (3,49,442) from tables", 64, 56, 56, 7, 96,
              3, 1, 0, True, (2,), bias=sliding_chunk_rpe_bias(table, g2l, 7), timed=True)
    # the card's time of B5, B9a, B9b, B8a and B8b per step beside their
    # event time, B9a's, B9b's and B8b's by part
    from vil_tpu_torch.tools.profile_step import family

    for name, t in card_times(torch, family).items():
        parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(t["parts"].items()))
        phase("kernels", f"{name} per step, bf16: event {t['event']:.4f} ms, the card's time "
                         f"{t['device']:.4f} ms ({parts})")
    # spatial parallelism: the halo-input kernels on every shard of stage 1
    # (1 block) and stage 2 (2 blocks) over 1, 2 and 4 ranks
    halo_case("stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False, (1, 2, 4),
              per_fwd=1)
    halo_case("stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0, False, (1, 2, 4),
              per_fwd=2)
    halo_case("biased, padded 3x3 grid, nglo 2", 2, 19, 20, 7, 64, 2, 2, 0, True, (1, 3))
    halo_case("cyclic 1x2 grid", 2, 7, 14, 7, 32, 1, 1, 0, False, (1,))
    # a mask row per query pixel (Wq = W², read per element), and W² = 16,
    # whose 145 columns leave the last 64-key tile ragged
    halo_case("SW_EXACT 1, nglo 0, biased", 2, 26, 20, 7, 64, 2, 0, 1, True, (1, 2))
    halo_case("SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False, (1, 2))
    # the tensor-core B7a copies rows 16 bytes at a time: a bf16 operand
    # off a 16-byte boundary must raise, not be read wrongly
    q = randn(2, 2, 2, 49, 64).to(torch.bfloat16)
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    q_off.copy_(q)
    kv_ext = [randn(2, 4, 2, 49, 64).to(torch.bfloat16) for _ in range(2)]
    glo = [randn(2, 1, 64).to(torch.bfloat16) for _ in range(2)]
    try:
        vil_attention_halo_fwd(q_off, *kv_ext, *glo, None,
                               torch.zeros(2, 2, 1, 1 + 9 * 49, device=dev), 2)
    except ValueError as e:
        phase("kernels", f"vil_attention_halo bf16 q 2 bytes off a 16-byte boundary: raises "
                         f"ValueError ({e})")
    else:
        raise AssertionError("a misaligned bf16 halo forward did not raise")
    probe_case()
    # high resolution (part highres), each timed per call, last so that the
    # cases above draw what they drew before these were added: ViL-Medium-Deep
    # 384² (14x14 chunks pad 2, 7x7 pad 1; N 577, 144), ViL-Small 1024²
    # (37x37 pad 3, 19x19 pad 5; N 4097, 1024), the _384 windows: W 6 (36
    # rows), W 8 (64) and W 12 (144 rows in three 64-row slices, the last
    # holding 16; 1297 columns)
    chunk_case("384^2 stage1 (64,14,14,49,96) H3, pad 2", 64, 96, 96, 7, 96, 3, 1, 0, False,
               timed=True)
    chunk_case("1024^2 stage1 (1,37,37,49,96) H3, pad 3", 1, 256, 256, 7, 96, 3, 1, 0, False,
               timed=True)
    chunk_case("1024^2 stage2 (8,19,19,49,192) H3, pad 5", 8, 128, 128, 7, 192, 3, 1, 0, False,
               timed=True)
    chunk_case("W 6 (32,16,16,36,96) H3", 32, 96, 96, 6, 96, 3, 1, 0, False, timed=True)
    chunk_case("W 8 (32,12,12,64,192) H3", 32, 96, 96, 8, 192, 3, 1, 0, False, timed=True)
    chunk_case("W 12 (32,4,4,144,384) H6", 32, 48, 48, 12, 384, 6, 1, 0, False, timed=True)
    # W 12 biased on a padded 3x3 grid: the last slice's 16 rows in dbias
    chunk_case("W 12 biased, padded 3x3 grid, nglo 2", 2, 26, 30, 12, 64, 2, 2, 0, True)
    chunk_case("mode 4 W 12 biased, padded 3x3 grid", 2, 26, 30, 12, 64, 2, 1, 0, True, 4)
    for mode in (1, 6):
        chunk_case(f"mode {mode} 1024^2 stage1 (1,37,37,49,96) H3, pad 3", 1, 256, 256, 7, 96,
                   3, 1, 0, False, mode, timed=True)
        chunk_case(f"mode {mode} W 12 (32,4,4,144,384) H6", 32, 48, 48, 12, 384, 6, 1, 0,
                   False, mode, timed=True)
    full_case("384^2 stage3 (64,577,384) H6", 64, 577, 384, 6, False, timed=True)
    full_case("384^2 stage3 (32,577,512) H8", 32, 577, 512, 8, False, timed=True)
    full_case("1024^2 stage3 (8,4097,384) H6", 8, 4097, 384, 6, False, timed=True)
    full_case("1024^2 stage4 (8,1024,768) H12", 8, 1024, 768, 12, False, timed=True)
    full_case("384^2 stage4 (64,144,768) H12", 64, 144, 768, 12, False, timed=True)
    block_case("W 12 (32,4,4,144,384) H6", 32, 48, 48, 12, 384, 6, 1, False, timed=True)
    block_case("W 8 (32,12,12,64,192) H3", 32, 96, 96, 8, 192, 3, 1, False, timed=True)
    # relative position bias at high resolution (the RPE paths of part
    # highres): B4 with ViL-Small RPE 1024²'s stage-3 bias (one group of all
    # 8 images a block, one (6, 4097, 4097) partial) and B2 on its 37x37
    # grid (chunk groups of 15 at batch 2), each launched twice
    from vil_tpu_torch.models.attention import full_rpe_bias_skew

    full_case("RPE 1024^2 stage3 (8,4097,384) H6, bias (6,4097,4097) from tables", 8, 4097,
              384, 6, True, timed=True, repeat=True,
              bias=full_rpe_bias_skew(*tables(127 * 127, 6, 1), 64, 64))
    table, g2l, _ = tables(27 * 27, 3, 1)
    chunk_case("RPE 1024^2 stage1 (2,37,37,49,96) H3, pad 3, bias (3,49,442) from tables", 2,
               256, 256, 7, 96, 3, 1, 0, True, timed=True, repeat=True,
               bias=sliding_chunk_rpe_bias(table, g2l, 7))
    # the dense bias's assembly at the RPE paths' dense grids: the gather
    # (index_put_ backward) and the skew (slices and sums), equal bit for bit
    for wx, H, nglo in ((64, 6, 1), (32, 12, 0), (24, 6, 1), (12, 12, 0)):
        leaves = [t.requires_grad_() for t in tables((2 * wx - 1) ** 2, H, nglo) if t is not None]
        msg, built = [], {}
        for kind, assemble in (("gather", full_rpe_bias), ("skew", full_rpe_bias_skew)):
            make = lambda: assemble(*leaves, *[None] * (3 - len(leaves)), wx, wx)
            built[kind] = make()
            ct = torch.ones_like(built[kind])
            fwd_ms = time_ms(lambda: make().detach())
            bwd_ms = time_ms(lambda: torch.autograd.grad(built[kind], leaves, ct,
                                                         retain_graph=True))
            msg.append(f"{kind} forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms")
        same = torch.equal(built["gather"], built["skew"])
        phase("kernels", f"dense RPE bias ({H},{nglo + wx * wx},{nglo + wx * wx}) from tables "
                         f"on a {wx}x{wx} grid: {'; '.join(msg)}; equal bit for bit {same}")
        if not same:
            raise AssertionError(f"the skew assembly differs from the gather at {wx}x{wx}")
    # ViL-Small 1024² under the split (the path train_spatial, and the splits
    # of 2 and 4 ranks, parallel.row_split): B7a/B7b on one rank's whole
    # grid, timed as one train_spatial step's B7b launches (stage 1 once,
    # stage 2 twice), then on the ragged shards of 2 and 4 ranks (the last
    # holding the pad rows), with and without a bias from tables
    halo_case("1024^2 stage1 (8,37,37,49,96) H3, pad 3", 8, 256, 256, 7, 96, 3, 1, 0, False,
              (1,), per_bwd=1)
    halo_case("1024^2 stage2 (8,19,19,49,192) H3, pad 5", 8, 128, 128, 7, 192, 3, 1, 0, False,
              (1,), per_bwd=2)
    table, g2l, _ = tables(27 * 27, 3, 1)
    for what, bias in (("", None), (", bias (3,49,442) from tables",
                                    sliding_chunk_rpe_bias(table, g2l, 7))):
        halo_case(f"1024^2 stage1 (2,37,37,49,96) H3, pad 3{what}", 2, 256, 256, 7, 96, 3, 1, 0,
                  False, ((20, 17), (10, 10, 10, 7)), bias=bias)
        halo_case(f"1024^2 stage2 (8,19,19,49,192) H3, pad 5{what}", 8, 128, 128, 7, 192, 3, 1,
                  0, False, ((10, 9), (5, 5, 5, 4)), bias=bias)
    # random shift under the split (the paths shift_spatial and
    # experiment_spatial_shift): the sampled-neighbour halo kernels B5h/B6h at
    # every mode on ViL-Small 224²'s stage 1 and 2 split over 1, 2 and 4 ranks
    # (modes 1 and 6 timed per shard beside SDPA) and on 1024²'s 37x37 grid
    # whole and on the ragged shards of 2 and 4 ranks; a biased padded grid
    # without global rows, SW_EXACT -1 at W 4, the RPE bias of a mode from
    # tables (front order [g2l | self | sampled]); last the path's own shapes,
    # ViL-Small 1024² at batch 8 on one rank, timed as a shift_spatial step
    # (stage 1 once, stage 2 twice, the mean of modes 1 and 6)
    for mode in range(1, 9):
        timed = mode in (1, 6)
        halo_case(f"mode {mode} stage1 (64,8,8,49,96) H3", 64, 56, 56, 7, 96, 3, 1, 0, False,
                  (1, 2, 4), mode=mode, timed=timed)
        halo_case(f"mode {mode} stage2 (64,4,4,49,192) H3", 64, 28, 28, 7, 192, 3, 1, 0, False,
                  (1, 2, 4), mode=mode, timed=timed)
        halo_case(f"mode {mode} 1024^2 stage1 (2,37,37,49,96) H3, pad 3", 2, 256, 256, 7, 96, 3,
                  1, 0, False, (1, (20, 17), (10, 10, 10, 7)), mode=mode)
    halo_case("mode 3 biased, padded 3x3 grid, nglo 0", 2, 19, 20, 7, 64, 2, 0, 0, True, (1, 3),
              mode=3)
    halo_case("mode 7 SW_EXACT -1, W 4", 3, 14, 15, 4, 48, 3, 1, -1, False, (1, 2), mode=7)
    table, g2l, _ = tables(27 * 27, 3, 1)
    for mode in (2, 5):
        halo_case(f"RPE mode {mode} stage1 (64,8,8,49,96) H3, bias (3,49,99) from tables", 64, 56,
                  56, 7, 96, 3, 1, 0, True, (2, (3, 3, 2)), mode=mode,
                  bias=sliding_chunk_rpe_bias(table, g2l, 7, mode), timed=True)
    # the tensor-core B5h copies rows 16 bytes at a time, as B7a does
    q_off = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(q.shape)
    q_off.copy_(q)
    try:
        vil_mode_attention_halo_fwd(q_off, *kv_ext, *glo, None,
                                    torch.zeros(2, 2, 1, 1 + 2 * 49, device=dev), 2, 4)
    except ValueError as e:
        phase("kernels", f"vil_mode_attention_halo bf16 q 2 bytes off a 16-byte boundary: "
                         f"raises ValueError ({e})")
    else:
        raise AssertionError("a misaligned bf16 sampled-neighbour halo forward did not raise")
    for mode in (1, 6):
        halo_case(f"mode {mode} 1024^2 stage1 (8,37,37,49,96) H3, pad 3", 8, 256, 256, 7, 96, 3,
                  1, 0, False, (1,), mode=mode, per_fwd=0.5, per_bwd=0.5)
        halo_case(f"mode {mode} 1024^2 stage2 (8,19,19,49,192) H3, pad 5", 8, 128, 128, 7, 192,
                  3, 1, 0, False, (1, (10, 9), (5, 5, 5, 4)), mode=mode, per_fwd=1, per_bwd=1)
    # vil_tpu's BF16_EXP: every bf16 sliding-chunk kernel under both settings
    check_bf16_exp(torch, randn, cast, chunk_scaled, scaled_text, scaled_err, rel_err, max_err)


# the kernels whose bf16 bodies take vil_tpu's BF16_EXP (the sliding-chunk
# forwards and backwards, their halo, sampled-neighbour and self-only forms,
# the fused block's attention), each at ViL-Small 224²'s stage 1 (batch 64;
# the halo forms on the first shard of D 2) and on a small biased grid:
# (label, kind, mode, B, nx, ny, C, H, nglo, biased)
BF16_EXP_CASES = (
    ("B1/B2 stage1 (64,8,8,49,96) H3", "chunk", 0, 64, 56, 56, 96, 3, 1, False),
    ("B1/B2 biased, padded 3x3 grid, nglo 2", "chunk", 0, 2, 19, 20, 64, 2, 2, True),
    ("B5/B6 mode 3 stage1", "chunk", 3, 64, 56, 56, 96, 3, 1, False),
    ("B5/B6 mode 6 biased, padded 3x4 grid", "chunk", 6, 2, 19, 25, 64, 2, 2, True),
    ("self-only B5/B6 stage1", "chunk", -1, 64, 56, 56, 96, 3, 1, False),
    ("B7a/B7b stage1, D 2", "halo", 0, 64, 56, 56, 96, 3, 1, False),
    ("B7a/B7b biased, padded 3x3 grid, D 3", "halo", 0, 2, 19, 20, 64, 2, 2, True),
    ("B5h/B6h mode 6 stage1, D 2", "halo", 6, 64, 56, 56, 96, 3, 1, False),
    ("B5h/B6h mode 2 biased, padded 3x3 grid, D 3", "halo", 2, 2, 19, 20, 64, 2, 1, True),
    ("B9a/B9b stage1 (64,8,8,49,96) H3", "block", 0, 64, 56, 56, 96, 3, 1, False),
    ("B9a/B9b biased, padded, cyclic 2x2 grid", "block", 0, 2, 13, 14, 64, 2, 1, True),
)


def check_bf16_exp(torch, randn, cast, chunk_scaled, scaled_text, scaled_err, rel_err, max_err):
    """Phase 3's BF16_EXP cases (``BF16_EXP_CASES``): each bf16 kernel pair
    under ``VIL_TPU_BF16_EXP`` 1 (``vil_tpu``'s default, the port's too) and
    0, each against the plain versions' bf16 emulation of its own setting
    (``neighbourhood_attention_bf16`` and its backward) at phase 3's limits
    (out to BF16_TOL, the LSE's rms to LSE_TOL, the gradients to GRAD_TOL of
    max(1, max|ref|), every output and gradient to CHUNK_SCALED_TOL of
    max|ref|; B9a's attention on its own q, k, v), and against the f32
    plain version: under 0 at the same limits, asserted (phase 3's cases);
    under 1 printed, the readings over those limits listed at the end (the
    rounded exponent's own error, which ``vil_tpu``'s kernels carry too;
    ROADMAP.md §C). The relative rms errors against both settings'
    emulations are printed; the stage-1 cases timed under both settings
    (CUDA events, median of 20). The switch is restored after."""
    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops import sliding_chunk as sc
    from vil_tpu_torch.ops.kernels import (
        mask_to_additive, vil_attention_bwd, vil_attention_bwd_reference, vil_attention_fwd,
        vil_attention_halo_bwd, vil_attention_halo_bwd_reference, vil_attention_halo_fwd,
        vil_attention_halo_reference, vil_attention_reference, vil_mode_attention_bwd,
        vil_mode_attention_bwd_reference, vil_mode_attention_fwd,
        vil_mode_attention_halo_bwd, vil_mode_attention_halo_bwd_reference,
        vil_mode_attention_halo_fwd, vil_mode_attention_halo_reference,
        vil_mode_attention_reference)
    from vil_tpu_torch.ops.kernels.vil_attention import (
        bf16_exp, neighbourhood_attention_bf16, neighbourhood_attention_bf16_bwd)
    from vil_tpu_torch.ops.kernels.vil_attention_halo import halo_neighborhood
    from vil_tpu_torch.ops.kernels.vil_mode_attention_halo import halo_sampled_neighborhood

    dev = torch.device("cuda")
    rms = lambda t: t.float().pow(2).mean().sqrt().item()
    rel_rms = lambda x, r: rms(x.float() - r.float()) / max(rms(r), 1e-30)
    saved = os.environ.get("VIL_TPU_BF16_EXP")
    over = []  # (case, what, reading, limit) of BF16_EXP 1 over the f32 limits

    def hold(setting, label, checks, against_f32):
        """Raise on a check over its limit, or, under BF16_EXP 1 against the
        f32 plain version, list it."""
        for what, err, tol in checks:
            if err <= tol:
                continue
            if against_f32 and setting == "1":
                over.append((label, what, err, tol))
            else:
                raise AssertionError(f"BF16_EXP {setting} {label} {what}: error {err} > {tol}")

    try:
        for label, kind, mode, B, nx, ny, C, H, nglo, biased in BF16_EXP_CASES:
            w, w2 = 7, 49
            padx, pady, mx, my = sc.chunk_grid(nx, ny, w)
            cols = nglo + (9 if mode == 0 else 1 if mode == -1 else 2) * w2
            mask = torch.from_numpy(mask_to_additive(
                masks_lib.invalid_mask(mx, my, padx, pady, w, 0, mode), mx, my, w2,
                nglo)).to(dev)
            bias = randn(H, w2, cols, scale=0.5) if biased else None
            a = cast([randn(B, mx, my, w2, C, scale=C ** -0.25) for _ in range(3)]
                     + [randn(B, nglo, C) if nglo else None for _ in range(2)], torch.bfloat16)
            g = randn(B, mx, my, w2, C).to(torch.bfloat16)
            tail = () if mode == 0 else (mode,)
            if kind == "block":
                block_exp(torch, label, randn, a[0], g, a[3:], bias, mask, H, scaled_err,
                          max_err, scaled_text, rel_rms, neighbourhood_attention_bf16, hold)
                continue
            if kind == "halo":  # the first shard of D equal or ragged shards
                D = 2 if B == 64 else 3
                n = -(-mx // D)
                rows = [mx - 1, *range(n), n % mx]
                ops = [a[0][:, :n].contiguous(), a[1][:, rows].contiguous(),
                       a[2][:, rows].contiguous(), a[3], a[4], bias]
                mask, g = mask[:n], g[:, :n].contiguous()
                nbh = (halo_neighborhood if mode == 0 else
                       lambda t: halo_sampled_neighborhood(t, mode))
                fwd, bwd = ((vil_attention_halo_fwd, vil_attention_halo_bwd) if mode == 0 else
                            (vil_mode_attention_halo_fwd, vil_mode_attention_halo_bwd))
                fwd_ref, bwd_ref = ((vil_attention_halo_reference,
                                     vil_attention_halo_bwd_reference) if mode == 0 else
                                    (vil_mode_attention_halo_reference,
                                     vil_mode_attention_halo_bwd_reference))
            else:
                ops = [*a, bias]
                nbh = lambda t: sc.neighborhood(t, mode)
                fwd, bwd = ((vil_attention_fwd, vil_attention_bwd) if mode == 0 else
                            (vil_mode_attention_fwd, vil_mode_attention_bwd))
                fwd_ref, bwd_ref = ((vil_attention_reference, vil_attention_bwd_reference)
                                    if mode == 0 else
                                    (vil_mode_attention_reference,
                                     vil_mode_attention_bwd_reference))
            ops32 = cast(ops, torch.float32)
            ref, ref_lse = fwd_ref(*ops32, mask, H, *tail, with_lse=True)
            refs = bwd_ref(*ops32, g.float(), mask, H, *tail)
            emu = {on: neighbourhood_attention_bf16(*ops[:5], bias, mask, H, nbh, on,
                                                    with_lse=True) for on in (True, False)}
            times = {}
            for setting in ("1", "0"):
                os.environ["VIL_TPU_BF16_EXP"] = setting
                on = bf16_exp()
                out, lse = fwd(*ops, mask, H, *tail, with_lse=True)
                grads = bwd(*ops, g, out, mask, lse, H, *tail)
                emu_grads = {e: neighbourhood_attention_bf16_bwd(*ops[:5], bias, g, out, lse,
                                                                 mask, H, nbh, e)
                             for e in (True, False)}
                torch.cuda.synchronize()
                e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
                e_grad = max(rel_err(x, r) for x, r in zip(grads, refs) if r is not None)
                e_scaled = chunk_scaled(out, ref, grads, refs)
                e_emu = chunk_scaled(out, emu[on][0], grads, emu_grads[on])
                # the LSE in rms: where the kernel's sums and the emulation's put
                # a shifted score on opposite sides of a bf16 rounding boundary,
                # that P moves by a bf16 step of its exponent (the maximum reads
                # ≈ 1e-4 at stage 1, the rms ≈ 1e-6)
                emu_out, emu_lse = max_err(out, emu[on][0]), rms(lse - emu[on][1])
                emu_grad = max(rel_err(x, r) for x, r in zip(grads, emu_grads[on])
                               if r is not None)
                vs = {e: [rel_rms(out, emu[e][0])] + [rel_rms(x, r) for x, r in
                                                      zip(grads[:3], emu_grads[e][:3])]
                      for e in (True, False)}
                phase("kernels", f"BF16_EXP {setting}, {label}: against f32 plain out "
                                 f"{e_out:.3e} (tol {BF16_TOL:g}), lse {e_lse:.3e} (tol "
                                 f"{LSE_TOL:g}), grads rel {e_grad:.3e} (tol "
                                 f"{GRAD_TOL['bfloat16']:g}){scaled_text(e_scaled)}")
                phase("kernels", f"BF16_EXP {setting}, {label}: against its own setting's "
                                 f"emulation out {emu_out:.3e}, lse rms {emu_lse:.3e} (max "
                                 f"{max_err(lse, emu[on][1]):.3e}), grads rel "
                                 f"{emu_grad:.3e}{scaled_text(e_emu)}; relative rms of out, dq, "
                                 f"dk, dv against the emulation with BF16_EXP "
                                 f"{[f'{v:.3e}' for v in vs[True]]}, without "
                                 f"{[f'{v:.3e}' for v in vs[False]]}")
                limits = lambda o, l, gr, sc: (
                    ("out", o, BF16_TOL), ("lse", l, LSE_TOL), ("grads", gr, GRAD_TOL["bfloat16"]),
                    *((f"{n} scaled", e, CHUNK_SCALED_TOL) for n, e in sc.items()))
                hold(setting, label, limits(e_out, e_lse, e_grad, e_scaled), True)
                hold(setting, label, [(f"{w} vs emulation", e, t) for w, e, t in
                                      limits(emu_out, emu_lse, emu_grad, e_emu)], False)
                if B == 64:
                    times[setting] = (time_ms(lambda: fwd(*ops, mask, H, *tail, with_lse=True)),
                                      time_ms(lambda: bwd(*ops, g, out, mask, lse, H, *tail)))
            if times:
                phase("kernels", f"BF16_EXP times, {label}, a call: forward with lse "
                                 f"{times['1'][0]:.4f} ms (on) / {times['0'][0]:.4f} (off), "
                                 f"backward {times['1'][1]:.4f} / {times['0'][1]:.4f}")
        phase("kernels", f"BF16_EXP 1 readings over the f32 plain version's limits (the "
                         f"rounded exponent's own error): {len(over)} "
                         + "; ".join(f"{c}: {w} {e:.3e} (limit {t:g})" for c, w, e, t in over))
    finally:
        if saved is None:
            os.environ.pop("VIL_TPU_BF16_EXP", None)
        else:
            os.environ["VIL_TPU_BF16_EXP"] = saved


def block_exp(torch, label, randn, x, g, glo, bias, mask, H, scaled_err, max_err, scaled_text,
              rel_rms, emulate, hold):
    """A fused-block BF16_EXP case (``check_bf16_exp``): B9a and B9b under
    both settings against the f32 plain versions (y, q, k, v, attn and the
    LSE, every gradient, to CHUNK_SCALED_TOL of max|ref|, dbk at dWk's scale;
    the gradients to GRAD_TOL of max(1, max|ref|); ``hold``: asserted under
    0, listed under 1), and B9a's attention output against the emulation on
    B9a's own q, k, v (its setting's held to CHUNK_SCALED_TOL, both
    printed); at batch 64 timed under both."""
    from vil_tpu_torch.ops import sliding_chunk as sc
    from vil_tpu_torch.ops.kernels import (vil_block_bwd, vil_block_bwd_reference,
                                           vil_block_fwd, vil_block_fwd_reference)

    C, B = x.shape[-1], x.shape[0]
    M = C // H
    w = [randn(C, C, scale=C ** -0.5 * (M ** -0.5 if i == 0 else 1.0)).to(torch.bfloat16)
         for i in range(4)]
    b = [randn(C, scale=0.02 * (M ** -0.5 if i == 0 else 1.0)) for i in range(4)]
    ops = [x, w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3], *glo, bias]
    ops32 = [None if t is None else t.float() for t in ops]
    fwd_refs = vil_block_fwd_reference(*ops32, mask, H, with_lse=True)
    refs = vil_block_bwd_reference(*ops32, g.float(), mask, H)
    nbh = lambda t: sc.neighborhood(t, 0)
    times = {}
    for setting in ("1", "0"):
        os.environ["VIL_TPU_BF16_EXP"] = setting
        y, k, v, lse, q, attn = vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)
        grads = vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))
        torch.cuda.synchronize()
        errs = {n: scaled_err(a, r) for n, a, r in zip(BLOCK_FWD_OUTS, (y, q, k, v, attn, lse),
                                                       fwd_refs)}
        errs.update({n: max_err(a, r) / refs[3 if i == 4 else i].abs().max().item()
                     for i, (n, a, r) in enumerate(zip(BLOCK_GRADS, grads, refs))
                     if r is not None})
        e_grad = max(max_err(a, r) / max(1.0, refs[3 if i == 4 else i].abs().max().item())
                     for i, (a, r) in enumerate(zip(grads, refs)) if r is not None)
        emu = {e: emulate(q, k, v, *glo, bias, mask, H, nbh, e) for e in (True, False)}
        own = scaled_err(attn, emu[setting == "1"])
        phase("kernels", f"BF16_EXP {setting}, {label}: against f32 plain grads rel "
                         f"{e_grad:.3e} (tol {GRAD_TOL['bfloat16']:g}){scaled_text(errs)}; "
                         f"attn against its own setting's emulation on B9a's q, k, v scaled "
                         f"{own:.3e}, relative rms with BF16_EXP {rel_rms(attn, emu[True]):.3e}, "
                         f"without {rel_rms(attn, emu[False]):.3e}")
        hold(setting, label, [*((f"{n} scaled", e, CHUNK_SCALED_TOL) for n, e in errs.items()),
                              ("grads", e_grad, GRAD_TOL["bfloat16"])], True)
        hold(setting, label, [("attn vs emulation", own, CHUNK_SCALED_TOL)], False)
        if B == 64:
            times[setting] = (
                time_ms(lambda: vil_block_fwd(*ops, mask, H, with_lse=True, saved=True)),
                time_ms(lambda: vil_block_bwd(*ops, g, mask, lse, H, (q, k, v, attn))))
    if times:
        phase("kernels", f"BF16_EXP times, {label}, a call: forward with lse {times['1'][0]:.4f} "
                         f"ms (on) / {times['0'][0]:.4f} (off), backward {times['1'][1]:.4f} / "
                         f"{times['0'][1]:.4f}")


def launch_counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def draw_tables(torch, model, std: float, seed: int = 7) -> None:
    """Every relative-position table of ``model`` drawn at σ ``std`` (0: all
    zero) from a CPU generator, so one seed gives the same tables on any
    device and in any dtype."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "relative_position" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * std)


def run_serve(torch, kernels, fused=False, rpe=False):
    """Phase 4 (with ``fused`` phase 7, with ``rpe`` phase 11): the inference
    path of ViL-Small 224² (with ``rpe`` ViL-Small RPE, served from
    ``precompute_rpe_cache``)."""
    from vil_tpu_torch.models import precompute_rpe_cache
    from vil_tpu_torch.train import recipe

    name = "serve_fused" if fused else "serve_rpe" if rpe else "serve"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(REQUESTS)]
    model = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev, fused=fused,
                             rpe=rpe).eval()
    if rpe:
        precompute_rpe_cache(model)
    for fn in kernels:
        fn.launches = 0
    secs = []
    with torch.inference_mode():
        for x in images:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
                raise AssertionError(f"bad logits {tuple(logits.shape)}")
    launches = launch_counts(kernels)
    per_forward = ({"vil_block_fwd": 3, "layer_norm_fwd": 30} if fused else
                   {"vil_attention_fwd": 3})
    want = {fn.__name__: 0 for fn in kernels}
    want.update({k: n * REQUESTS for k, n in per_forward.items()},
                full_attention_fwd=9 * REQUESTS)
    what = "ViL-Small RPE 224^2 bf16, biases from precompute_rpe_cache," if rpe else \
        "ViL-Small 224^2 bf16"
    phase(name, f"{what} batch {BATCH}: {REQUESTS} requests, "
                f"launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    img_s = BATCH / statistics.median(secs[1:])
    phase(name, f"bf16 forward: median {statistics.median(secs[1:]) * 1e3:.3f} ms "
                f"per batch, {img_s:.1f} img/s (requests 2..{REQUESTS}); first "
                f"request {secs[0] * 1e3:.1f} ms")
    if rpe:
        # the cache serves what the tables give: the same bits as a model
        # that assembles its biases in every forward, same weights
        with torch.inference_mode():
            cached = model(images[0])
            uncached = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev,
                                        rpe=True).eval()(images[0])
        same = torch.equal(cached, uncached)
        phase(name, f"bf16 logits with precompute_rpe_cache vs assembled in the forward: "
                    f"bitwise equal {same}")
        if not same:
            raise AssertionError("the cached biases give other logits than the assembled")
    del model

    # f32 logits: kernels vs plain versions; in the fused configuration also
    # against the classic configuration's kernels, from the same weights
    x = images[0]
    outs = {}
    with torch.inference_mode():
        for key, use_kernels, f in (("kernels", True, fused), ("plain", False, fused),
                                    ("classic", True, False)):
            if key == "classic" and not fused:
                continue
            m = recipe.vil_small(torch.float32, torch.float32, use_kernels, dev, fused=f,
                                 rpe=rpe).eval()
            outs[key] = m(x)
            del m
    for other in [k for k in ("plain", "classic") if k in outs]:
        err = (outs["kernels"] - outs[other]).abs().max().item()
        what = ("kernels vs plain versions" if other == "plain" else
                "fused vs classic configuration (both with the kernels)")
        phase(name, f"f32 logits, {what}: max|err| {err:.3e} (tol {LOGITS_TOL:g}); "
                    f"|logits| max {outs[other].abs().max().item():.3f}")
        if not (torch.isfinite(outs["kernels"]).all() and err <= LOGITS_TOL):
            raise AssertionError(f"f32 logits disagree ({what}): {err}")
    if rpe:
        check_big_tables(torch, name, lambda use_kernels: recipe.vil_small(
            torch.float32, torch.float32, use_kernels, dev, rpe=True).eval(), x)
    if not fused:
        # the path's own types: bf16 logits, kernels (the dense ones on the
        # tensor cores) vs plain versions, same weights; bf16's own error,
        # plain bf16 vs plain f32, printed beside it as its scale
        with torch.inference_mode():
            for key, use_kernels in (("bf16 kernels", True), ("bf16 plain", False)):
                m = recipe.vil_small(torch.bfloat16, torch.bfloat16, use_kernels, dev,
                                     rpe=rpe).eval()
                outs[key] = m(x).float()
                del m
        scaled = lambda a, b: ((outs[a] - outs[b]).abs().max() / outs[b].abs().max()).item()
        err, own = scaled("bf16 kernels", "bf16 plain"), scaled("bf16 plain", "plain")
        phase(name, f"bf16 logits, kernels vs plain versions: max|err| / max|ref| {err:.3e} "
                    f"(tol {BF16_LOGITS_TOL:g}); plain bf16 vs plain f32 {own:.3e}")
        if not (torch.isfinite(outs["bf16 kernels"]).all() and err <= BF16_LOGITS_TOL):
            raise AssertionError(f"bf16 logits disagree: {err}")
    return launches


def check_big_tables(torch, name, build, x, forward=None):
    """The RPE paths' f32 logits check with every table drawn at σ 1, where
    the bias moves the scores as much as q·k does: ``build(use_kernels)``
    makes the model, ``forward(model, x)`` (default: ``model(x)``) serves
    it. Kernels vs plain versions to LOGITS_TOL and to RPE_SHARE_TOL of the
    logits' max|Δ| between these tables and zero tables: what a dropped bias
    would move them by."""
    forward = forward or (lambda m, x: m(x))
    outs = {}
    with torch.inference_mode():
        for key, use_kernels, std in (("kernels", True, 1.0), ("plain", False, 1.0),
                                      ("zero tables", True, 0.0)):
            m = build(use_kernels)
            draw_tables(torch, m, std)
            outs[key] = forward(m, x)
            del m
    err = (outs["kernels"] - outs["plain"]).abs().max().item()
    moved = (outs["plain"] - outs["zero tables"]).abs().max().item()
    tol = min(LOGITS_TOL, RPE_SHARE_TOL * moved)
    phase(name, f"f32 logits, tables at σ 1, kernels vs plain versions: max|err| {err:.3e} "
                f"(tol {tol:.3e}: {RPE_SHARE_TOL:g} of the {moved:.3e} that zero tables move "
                f"them by; |logits| max {outs['plain'].abs().max().item():.3f})")
    if not (torch.isfinite(outs["kernels"]).all() and err <= tol):
        raise AssertionError(f"f32 logits with σ-1 tables disagree: {err} > {tol}")


def f32_grad_errors(grads_k: dict, grads_p: dict) -> tuple[float, str, float]:
    """max|err| / max|ref| of each parameter's gradient, kernels (``grads_k``)
    against plain versions (``grads_p``): (the largest, its parameter, the
    largest over the relative-position tables)."""
    grad_err, worst, table_err = 0.0, "", 0.0
    for param, ref in grads_p.items():
        if ref.numel() == 0:  # the (1, 0, C) position table of a stage without globals
            continue
        err = ((grads_k[param] - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if "relative_position" in param:
            table_err = max(table_err, err)
        if not math.isfinite(err) or err > grad_err:
            grad_err, worst = err, param
    return grad_err, worst, table_err


def bf16_grad_blocks(grads: dict):
    """Each parameter's gradient; the q, k and v rows of a fused
    projection's weight each on its own, where dq and dk, which
    near-uniform attention keeps small, would be lost in dv's norm. A
    block's relative-position tables go as one vector: the g2g and g2l
    gradients are a few sums per head over the batch of dS terms that cancel
    (a softmax row's dS sums to 0), whose bf16 rounding alone moves them by
    3.4e-2 of their norm (plain bf16 vs plain f32, PR 12); the f32 step
    holds each table alone."""
    import torch

    tables = {}
    for n, t in grads.items():
        if "relative_position" in n:
            tables.setdefault(n.rsplit(".", 1)[0], []).append(t.flatten())
            continue
        parts = 3 if n.endswith("qkv.weight") else 2 if n.endswith("kv.weight") else 1
        names = ("q", "k", "v")[3 - parts:] if parts > 1 else ("",)
        for part, rows in zip(names, t.chunk(parts)):
            yield n + (f"[{part}]" if part else ""), rows
    for block, parts in tables.items():
        yield block + ".[relative-position tables]", torch.cat(parts)


def bf16_grad_worst(grads: dict, refs: dict) -> tuple[float, str]:
    """The largest ‖err‖ / ‖ref‖ over ``bf16_grad_blocks``, and its block."""
    grads = dict(bf16_grad_blocks(grads))
    errs = {n: ((grads[n] - r).norm() / r.norm()).item()
            for n, r in bf16_grad_blocks(refs) if r.norm() > 0}
    name = max(errs, key=lambda n: (not math.isfinite(errs[n]), errs[n]))
    return errs[name], name


def run_train(torch, kernels, random_shift=False, fused=False, rpe=False, drop=0.0):
    """Phase 5 (with ``random_shift`` phase 6, with ``fused`` phase 8, with
    ``rpe`` phase 12, with ``drop`` part train_drop): the training step of
    ViL-Small 224² at batch 64 (with ``rpe`` ViL-Small RPE, with ``drop`` at
    MODEL.VIT.DROP ``drop``, its masks drawn from the step's generator, the
    same for the kernels and the plain versions). With ``rpe`` and
    ``random_shift`` or ``fused`` (phases 13, 14) the path is the f32
    kernels-vs-plain step pair alone, its launches counted over the kernels'
    steps."""
    from vil_tpu_torch.train import engine, recipe

    if rpe:
        name = "shift_rpe" if random_shift else "train_fused_rpe" if fused else "train_rpe"
    elif drop:
        name = "train_drop"
    else:
        name = "train_shift" if random_shift else "train_fused" if fused else "train"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    per_step = {fn.__name__: 0 for fn in kernels}
    per_step.update(full_attention_fwd=9, full_attention_bwd=9)
    if fused:
        per_step.update(vil_block_fwd=3, vil_block_bwd=3, layer_norm_fwd=30, layer_norm_bwd=30)
    else:
        chunk = "vil_mode_attention" if random_shift else "vil_attention"
        per_step.update({f"{chunk}_fwd": 3, f"{chunk}_bwd": 3})
    steps_run = not (rpe and (random_shift or fused))
    if steps_run:
        model = recipe.vil_small(torch.bfloat16, torch.float32, device=dev, fused=fused, rpe=rpe,
                                 drop=drop)
        step = recipe.train_step(model, dev, random_shift)
        step_gen = torch.Generator(device=dev).manual_seed(3)
        for fn in kernels:
            fn.launches = 0
        secs, losses, modes = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(STEPS):
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(images, labels, step_gen)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(metrics["loss"].item())
            modes.append(metrics.get("modes"))
            rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
            if rose != per_step:
                raise AssertionError(f"step {i}: launches rose by {rose}, want {per_step}")
        launches = launch_counts(kernels)
        what = ("ViL-Small RPE 224^2" if rpe else f"ViL-Small 224^2 at DROP {drop}" if drop else
                "ViL-Small 224^2")
        phase(name, f"{what} bf16 compute, f32 parameters, batch {BATCH}: {STEPS} "
                    f"steps, launches {launches} ({per_step} per step)")
        if random_shift:
            phase(name, "per-block modes drawn by the step (12 blocks; the 9 dense blocks "
                        f"ignore theirs): {modes}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses not finite: {losses}")
        med = statistics.median(secs[1:])
        phase(name, f"step: median {med * 1e3:.3f} ms, {BATCH / med:.1f} img/s "
                    f"(steps 2..{STEPS}); first step {secs[0] * 1e3:.1f} ms; losses "
                    f"{', '.join(f'{v:.4f}' for v in losses)}; peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, step
    else:
        # the recipe's first draw of per-block modes (its mode generator,
        # seed 0): the step the six-step run would take first
        modes = [engine.sample_vil_modes(torch.Generator().manual_seed(0), 12)
                 if random_shift else None]
        if random_shift:
            phase(name, f"per-block modes (12 blocks; the 9 dense blocks ignore theirs): "
                        f"{modes[0]}")
        for fn in kernels:
            fn.launches = 0

    def one_step(dtype, use_kernels, std=None):
        """One step from the recipe's weights (with ``std`` every table
        drawn at σ ``std``), the same images, draws and (random shift) the
        first step's modes: (loss, parameter gradients)."""
        m = recipe.vil_small(dtype, torch.float32, use_kernels, dev, fused=fused, rpe=rpe,
                             drop=drop)
        if std is not None:
            draw_tables(torch, m, std)
        s = recipe.train_step(m, dev, random_shift)
        loss = s(images, labels, torch.Generator(device=dev).manual_seed(3),
                 modes=modes[0])["loss"].item()
        return loss, {n: p.grad.clone() for n, p in m.named_parameters()}

    # one f32 step, kernels vs plain versions; with RPE also with every
    # table at σ 1, where the bias moves the scores as much as q·k does
    for std in (None, 1.0) if rpe else (None,):
        (loss_k, grads_k), (loss_p, grads_p) = one_step(torch.float32, True, std), one_step(
            torch.float32, False, std)
        loss_err = abs(loss_k - loss_p)
        grad_err, worst, table_err = f32_grad_errors(grads_k, grads_p)
        tables = (f"; the {sum('relative_position' in n for n in grads_p)} tables' max rel "
                  f"err {table_err:.3e}" if rpe else "")
        what = "f32 step" + (", tables at σ 1" if std else "")
        phase(name, f"{what}, kernels vs plain versions: loss {loss_k:.6f} vs {loss_p:.6f} "
                    f"(|err| {loss_err:.3e}, tol {LOSS_TOL:g}); parameter gradients max "
                    f"rel err {grad_err:.3e} at {worst} (tol {PARAM_GRAD_TOL:g}){tables}")
        if not (loss_err <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{what} disagrees: loss {loss_err}, gradients {grad_err}")
        if std is None:
            grads_f32 = grads_p  # the recipe's tables: bf16's scale below
    if not steps_run:
        launches = launch_counts(kernels)
        want = {k: 2 * n for k, n in per_step.items()}  # two kernel steps
        phase(name, f"launches over the two f32 kernel steps {launches} (want {want})")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
    if not (random_shift or fused):
        # the path's own types: one bf16-compute step, kernels (the dense
        # backward on the tensor cores) vs plain versions; bf16's own error,
        # plain bf16 vs plain f32, printed beside it as its scale
        (bf_loss_k, bf_k), (bf_loss_p, bf_p) = one_step(torch.bfloat16, True), one_step(
            torch.bfloat16, False)
        (err, at), (own, own_at) = bf16_grad_worst(bf_k, bf_p), bf16_grad_worst(bf_p, grads_f32)
        alone = ""
        if rpe:  # each table alone, printed: what joining them leaves out

            def table_worst(grads, refs):
                return max(((grads[n] - r).norm() / r.norm()).item()
                           for n, r in refs.items() if "relative_position" in n and r.norm() > 0)

            alone = (f"; each table alone (printed, not held) {table_worst(bf_k, bf_p):.3e}, "
                     f"plain bf16 vs plain f32 {table_worst(bf_p, grads_f32):.3e}")
        phase(name, f"bf16 step, kernels vs plain versions: loss {bf_loss_k:.6f} vs "
                    f"{bf_loss_p:.6f}; parameter gradients max ‖err‖ / ‖ref‖ {err:.3e} at {at} "
                    f"(tol {BF16_PARAM_GRAD_TOL:g}); plain bf16 vs plain f32 {own:.3e} at "
                    f"{own_at}{alone}")
        if not (math.isfinite(bf_loss_k) and err <= BF16_PARAM_GRAD_TOL):
            raise AssertionError(f"bf16 step disagrees: gradients {err} at {at}")
    return launches


class OneRankGroup:
    """A process group of this one card (``nccl``, from a ``FileStore``
    under build/), left and its store removed on exit."""

    def __init__(self, tag: str):
        self.store = os.path.join(REPO, "build", f"{tag}_store.{os.getpid()}")

    def __enter__(self):
        from vil_tpu_torch import parallel

        os.makedirs(os.path.dirname(self.store), exist_ok=True)
        parallel.init_process_group(self.store, 0, 1, backend="nccl")
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        if os.path.exists(self.store):
            os.remove(self.store)


def run_serve_spatial(torch, kernels):
    """Phase 9: spatial (chunk-row) parallelism of ViL-Small 224² on a
    process group of one card, through ``parallel.spatial_forward``, and
    one backward through the spatial kernel tier. Returns the launch counts
    of the two paths: the serving forwards, and the backward."""
    import torch.distributed as dist

    from vil_tpu_torch import parallel
    from vil_tpu_torch.ops import masks as masks_lib
    from vil_tpu_torch.ops.kernels import mask_to_additive
    from vil_tpu_torch.train import recipe

    name = "serve_spatial"
    dev = torch.device("cuda")
    with OneRankGroup("spatial"):
        gen = torch.Generator(device=dev).manual_seed(1)
        images = [torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                                dtype=torch.uint8) for _ in range(REQUESTS)]
        model = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev).eval()
        forward = lambda m, x: parallel.spatial_forward(m, parallel.shard_image(x, m))

        def timed(fn):
            secs = []
            with torch.inference_mode():
                for x in images:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits = fn(x)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
                        raise AssertionError(f"bad logits {tuple(logits.shape)}")
            return secs

        # the classic forward first, same weights and images, outside the
        # path's launch counts
        classic = timed(model)
        for fn in kernels:
            fn.launches = 0
        secs = timed(lambda x: forward(model, x))
        launches = launch_counts(kernels)
        want = {fn.__name__: 0 for fn in kernels}
        want.update(vil_attention_halo_fwd=3 * REQUESTS, full_attention_fwd=9 * REQUESTS)
        phase(name, f"ViL-Small 224^2 bf16 batch {BATCH} on a group of "
                    f"{parallel.get_world_size()} ({dist.get_backend()}): {REQUESTS} requests, "
                    f"launches {launches} (want {want})")
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        med, med_c = statistics.median(secs[1:]), statistics.median(classic[1:])
        phase(name, f"bf16 spatial forward: median {med * 1e3:.3f} ms per batch, "
                    f"{BATCH / med:.1f} img/s (requests 2..{REQUESTS}); first request "
                    f"{secs[0] * 1e3:.1f} ms; classic forward in the same phase "
                    f"{med_c * 1e3:.3f} ms, {BATCH / med_c:.1f} img/s")
        del model

        # the spatial_bwd path: one backward through the kernel tier at
        # stage 1's shape, B7b inside the halo exchange's adjoint, against
        # the plain spatial tier
        mask = torch.from_numpy(mask_to_additive(
            masks_lib.invalid_mask(8, 8, 0, 0, 7, 0, 0), 8, 8, 49, 1)).to(dev)
        shapes = [(BATCH, 8, 8, 49, 96)] * 3 + [(BATCH, 1, 96)] * 2
        ops = [torch.randn(*s, generator=gen, device=dev) * 96 ** -0.25 for s in shapes]
        g_out = torch.randn(*shapes[0], generator=gen, device=dev)
        route = type(parallel.halo_rows(ops[1].requires_grad_())[0].grad_fn).__name__
        if route != "_HaloExchangeBackward":
            raise AssertionError(f"the halos bypass the exchange: grad_fn {route}")
        grads = {}
        for fn in kernels:
            fn.launches = 0
        for tier, fn in (("kernels", parallel.spatial_local_attention_kernel),
                         ("plain", parallel.spatial_local_attention)):
            dtype = torch.bfloat16 if tier == "kernels" else torch.float32
            leaves = [t.detach().to(dtype).requires_grad_() for t in ops]
            fn(*leaves, None, mask, 3).backward(g_out.to(dtype))
            grads[tier] = [t.grad.float() for t in leaves]
        launches_bwd = launch_counts(kernels)
        want = {fn.__name__: 0 for fn in kernels}
        want.update(vil_attention_halo_fwd=1, vil_attention_halo_bwd=1)
        phase(name, f"spatial_bwd: halos through {route} over {dist.get_backend()}; launches "
                    f"{launches_bwd} (want {want})")
        if launches_bwd != want:
            raise AssertionError(f"spatial backward launch counts {launches_bwd} != {want}")
        errs = [(k - p).abs().max().item() / max(1.0, p.abs().max().item())
                for k, p in zip(grads["kernels"], grads["plain"])]
        phase(name, f"spatial_bwd: backward through spatial_local_attention_kernel, stage 1 "
                    f"({BATCH},8,8,49,96) bf16: dq, dk, dv, dk_glo, dv_glo rel err vs the plain "
                    f"spatial tier in f32 {max(errs):.3e} (tol {GRAD_TOL['bfloat16']:g})")
        if not max(errs) <= GRAD_TOL["bfloat16"]:
            raise AssertionError(f"spatial backward disagrees: {errs}")

        # f32 logits: spatial vs classic (kernels), spatial kernels vs plain
        x, outs = images[0], {}
        with torch.inference_mode():
            for use_kernels in (True, False):
                m = recipe.vil_small(torch.float32, torch.float32, use_kernels, dev).eval()
                outs[use_kernels] = forward(m, x)
                if use_kernels:
                    outs["classic"] = m(x)
                del m
        for other, what in ((False, "spatial kernels vs spatial plain versions"),
                            ("classic", "spatial vs classic forward (both with the kernels)")):
            err = (outs[True] - outs[other]).abs().max().item()
            phase(name, f"f32 logits, {what}: max|err| {err:.3e} (tol {LOGITS_TOL:g}); "
                        f"|logits| max {outs[other].abs().max().item():.3f}")
            if not (torch.isfinite(outs[True]).all() and err <= LOGITS_TOL):
                raise AssertionError(f"f32 logits disagree ({what}): {err}")
        # the same on ViL-Small RPE with its tables at σ 1: the bias through
        # the halo kernels, g2g and g2l[0] through the spread global branch
        with torch.inference_mode():
            m = recipe.vil_small(torch.float32, torch.float32, True, dev, rpe=True).eval()
            draw_tables(torch, m, 1.0)
            spatial_rpe, classic_rpe = forward(m, x), m(x)
            del m
        err = (spatial_rpe - classic_rpe).abs().max().item()
        phase(name, f"f32 logits, ViL-Small RPE (tables at σ 1), spatial vs classic forward "
                    f"(both with the kernels): max|err| {err:.3e} (tol {LOGITS_TOL:g}); "
                    f"|logits| max {classic_rpe.abs().max().item():.3f}")
        if not (torch.isfinite(spatial_rpe).all() and err <= LOGITS_TOL):
            raise AssertionError(f"f32 RPE logits disagree (spatial vs classic): {err}")
        check_big_tables(torch, name, lambda use_kernels: recipe.vil_small(
            torch.float32, torch.float32, use_kernels, dev, rpe=True).eval(), x, forward)
    return launches, launches_bwd


# ViL-Small 1024² at batch 8 under the split: the path train_spatial; its
# f32 step pair on ViL-Small with stage 3 cut to one block, at batch 2
SPATIAL_IMG, SPATIAL_BATCH, SPATIAL_PAIR = 1024, 8, 2
SHALLOW_VIL_SMALL = ("l1,h3,d96,n1,s1,g1,p4,f7_l2,h3,d192,n2,s1,g1,p2,f7_"
                     "l3,h6,d384,n1,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7")


def spatial_step_pair(torch, dtype, batch, arch, images, labels, mesh, modes=None,
                      runs=None):
    """One recipe step of ViL-Small 1024² (``arch``, computed in ``dtype``,
    f32 parameters) from its seeded weights, classic and on ``mesh``, from
    the same images, labels and draws, at the per-block ``modes`` of random
    shift where given: {"classic": (loss, gradients), "spatial": (loss,
    gradients)}. ``runs`` replaces the pair: {label: (mesh, use_kernels)}."""
    from vil_tpu_torch.train import recipe

    dev = torch.device("cuda")
    out = {}
    runs = runs or {"classic": (None, True), "spatial": (mesh, True)}
    for label, (on, use_kernels) in runs.items():
        m = recipe.vil("vil_small", SPATIAL_IMG, dtype, torch.float32, use_kernels, dev,
                       arch=arch)
        s = recipe.train_step(m, dev, modes is not None, batch=SPATIAL_BATCH, mesh=on, seed=0)
        loss = s(images[:batch], labels[:batch], torch.Generator(device=dev).manual_seed(3),
                 modes=modes)["loss"].item()
        out[label] = (loss, {n: p.grad.clone() for n, p in m.named_parameters()})
        del m, s
        torch.cuda.empty_cache()
    return out


def run_train_spatial(torch, kernels):
    """Phase 18 (``train_spatial``): the training step of ViL-Small 1024² at
    batch 8 (the recipe of ``train_1024``) on a ('data', 'spatial') mesh of
    one card: an ``nccl`` group of one, the image's rows split over it
    (``engine.TrainStep`` with a ``parallel.Mesh``), the chunked stages
    through B7a and B7b, the halos and their gradients through the exchange.
    The classic ``train_1024`` step from the same weights runs first, outside
    the path's counts; each takes STEPS steps and PROFILED more under
    torch.profiler. Launches exact: B7a 3, B7b 3, B3 9, B4 9 a step, no
    B1/B2. Then one bf16 step, spatial vs classic, from the same weights and
    batch (gradients to BF16_PARAM_GRAD_TOL), and one f32 step of the
    shallow model at batch 2 (loss to LOSS_TOL, gradients to PARAM_GRAD_TOL
    of their max|ref|). With more than one card, the multi-card phase."""
    from vil_tpu_torch import parallel
    from vil_tpu_torch.tools.profile_step import kernel_ms
    from vil_tpu_torch.train import recipe

    name = "train_spatial"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(SPATIAL_BATCH, SPATIAL_IMG, SPATIAL_IMG, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (SPATIAL_BATCH,), generator=gen, device=dev)
    with OneRankGroup(name):
        mesh = parallel.Mesh(spatial=parallel.SpatialContext.of(None))
        walls, launches = {}, None
        for label, on, chunk in (("classic", None, "vil_attention"),
                                 ("spatial", mesh, "vil_attention_halo")):
            per_step = {fn.__name__: 0 for fn in kernels}
            per_step.update({f"{chunk}_fwd": 3, f"{chunk}_bwd": 3, "full_attention_fwd": 9,
                             "full_attention_bwd": 9})
            model = recipe.vil("vil_small", SPATIAL_IMG, torch.bfloat16, torch.float32,
                               device=dev)
            step = recipe.train_step(model, dev, batch=SPATIAL_BATCH, mesh=on)
            step_gen = torch.Generator(device=dev).manual_seed(3)
            secs, losses = [], []

            def timed():
                before = launch_counts(kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step(images, labels, step_gen)["loss"].item())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
                if rose != per_step:
                    raise AssertionError(f"{name} {label} step {len(secs)}: launches rose by "
                                         f"{rose}, want {per_step}")

            if on is not None:  # the path: its counts from 0
                for fn in kernels:
                    fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            for _ in range(STEPS):
                timed()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(PROFILED):
                    timed()
            if on is not None:
                launches = launch_counts(kernels)
            device = sum(kernel_ms(prof).values()) / PROFILED
            med = statistics.median(secs[1:STEPS])
            walls[label] = (med, device)
            phase(name, f"{label} ViL-Small {SPATIAL_IMG}^2 bf16 batch {SPATIAL_BATCH}"
                        f"{' on a group of 1 (nccl)' if on else ''}: median {med * 1e3:.3f} ms, "
                        f"{SPATIAL_BATCH / med:.1f} img/s (steps 2..{STEPS}), first "
                        f"{secs[0] * 1e3:.1f} ms; device {device:.3f} ms a step "
                        f"(torch.profiler over {PROFILED} more), idle "
                        f"{100 * (1 - device / med / 1e3):.1f}%; peak memory "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
                        f"{', '.join(f'{v:.4f}' for v in losses)}")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{name} {label}: losses not finite: {losses}")
            del model, step
            torch.cuda.empty_cache()
        want = {fn.__name__: 0 for fn in kernels}
        want.update(vil_attention_halo_fwd=3 * (STEPS + PROFILED),
                    vil_attention_halo_bwd=3 * (STEPS + PROFILED),
                    full_attention_fwd=9 * (STEPS + PROFILED),
                    full_attention_bwd=9 * (STEPS + PROFILED))
        phase(name, f"launches {({k: v for k, v in launches.items() if v})} (want "
                    f"{({k: v for k, v in want.items() if v})}, the rest 0); spatial / classic "
                    f"wall {walls['spatial'][0] / walls['classic'][0]:.3f}, device "
                    f"{walls['spatial'][1] / walls['classic'][1]:.3f}")
        if launches != want:
            raise AssertionError(f"{name}: launch counts {launches} != {want}")

        # the path's own types: one bf16 step, spatial vs classic
        bf = spatial_step_pair(torch, torch.bfloat16, SPATIAL_BATCH, "", images, labels, mesh)
        err, at = bf16_grad_worst(bf["spatial"][1], bf["classic"][1])
        phase(name, f"bf16 step, batch {SPATIAL_BATCH}, spatial vs classic: loss "
                    f"{bf['spatial'][0]:.6f} vs {bf['classic'][0]:.6f}; parameter gradients max "
                    f"‖err‖ / ‖ref‖ {err:.3e} at {at} (tol {BF16_PARAM_GRAD_TOL:g})")
        if not (math.isfinite(bf["spatial"][0]) and err <= BF16_PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: bf16 step disagrees: gradients {err} at {at}")
        one_rank = bf["spatial"]
        del bf
        # f32, the shallow model: the halo kernels' f32 bodies against B1/B2's
        f32 = spatial_step_pair(torch, torch.float32, SPATIAL_PAIR, SHALLOW_VIL_SMALL, images,
                                labels, mesh)
        loss_err = abs(f32["spatial"][0] - f32["classic"][0])
        grad_err, worst, _ = f32_grad_errors(f32["spatial"][1], f32["classic"][1])
        phase(name, f"f32 step, ViL-Small with stage 3 cut to one block, batch {SPATIAL_PAIR}, "
                    f"spatial vs classic: loss {f32['spatial'][0]:.6f} vs {f32['classic'][0]:.6f} "
                    f"(|err| {loss_err:.3e}, tol {LOSS_TOL:g}); parameter gradients max rel err "
                    f"{grad_err:.3e} at {worst} (tol {PARAM_GRAD_TOL:g})")
        if not (loss_err <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: f32 step disagrees: loss {loss_err}, gradients "
                                 f"{grad_err} at {worst}")
        del f32
        torch.cuda.empty_cache()
    run_multicard(torch, images, labels, one_rank)
    return launches


SPATIAL_OPTION_STEPS = 3  # steps of each setting: the first compared, the others timed
# the paths' settings (REMAT, DROP): the first of each path is its twin
SPATIAL_OPTIONS = {"train_spatial_remat": (("", 0.0), ("minimal", 0.0), ("full", 0.0)),
                   "train_spatial_drop": (("", 0.1), ("full", 0.1))}


def run_spatial_options(torch, kernels) -> dict:
    """Part ``spatial_options``: train_spatial's step (ViL-Small 1024²,
    batch 8, bf16, the one-card ('data', 'spatial') mesh of an ``nccl``
    group of one) as two paths, each with counts of its own:
    ``train_spatial_remat`` at TPU.REMAT '', 'minimal' and 'full', and
    ``train_spatial_drop`` at MODEL.VIT.DROP 0.1, then with REMAT 'full'
    (each mask of the whole value drawn, this rank's rows kept). Each
    setting from the same weights, images and generator: SPATIAL_OPTION_STEPS
    steps (the first one's collectives counted, ``parallel.count_collectives``),
    one more under torch.profiler, the peak memory; launches exact a step
    (B7a 3, B7b 3, B3 9, B4 9; under REMAT B7a 6 and B3 18: the recompute).
    The first step's gradients against the path's first setting (bit for
    bit) and against the classic one-rank step at the same DROP (the bf16
    limit), which runs first, outside the counts. Then the cost of drawing
    the whole mask where a rank of two holds part of it: the stage-1 MLP's
    hidden mask of the whole grid against the first rank's 20 of 37 chunk
    rows, CUDA events. Returns {path: launches}."""
    from vil_tpu_torch import parallel
    from vil_tpu_torch.train import recipe

    name = "spatial_options"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(SPATIAL_BATCH, SPATIAL_IMG, SPATIAL_IMG, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (SPATIAL_BATCH,), generator=gen, device=dev)

    def model_step(remat, drop, on):
        m = recipe.vil("vil_small", SPATIAL_IMG, torch.bfloat16, torch.float32, device=dev,
                       remat=remat, drop=drop)
        return m, recipe.train_step(m, dev, batch=SPATIAL_BATCH, mesh=on, seed=0)

    run = lambda step: step(images, labels, torch.Generator(device=dev).manual_seed(3))
    classic = {}
    for drop in sorted({d for settings in SPATIAL_OPTIONS.values() for _, d in settings}):
        m, s = model_step("", drop, None)
        loss = run(s)["loss"].item()
        classic[drop] = (loss, {n: p.grad.clone() for n, p in m.named_parameters()})
        del m, s
        torch.cuda.empty_cache()
    paths = {}
    with OneRankGroup(name):
        mesh = parallel.Mesh(spatial=parallel.SpatialContext.of(None))
        for path, settings in SPATIAL_OPTIONS.items():
            for fn in kernels:
                fn.launches = 0
            twin = None
            for remat, drop in settings:
                per_step = {fn.__name__: 0 for fn in kernels}
                again = 2 if remat else 1
                per_step.update(vil_attention_halo_fwd=3 * again, vil_attention_halo_bwd=3,
                                full_attention_fwd=9 * again, full_attention_bwd=9)
                model, step = model_step(remat, drop, mesh)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                secs, losses = [], []
                for i in range(SPATIAL_OPTION_STEPS):
                    before = launch_counts(kernels)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with parallel.count_collectives() as issued:
                        losses.append(run(step)["loss"].item())
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
                    if rose != per_step or not math.isfinite(losses[-1]):
                        raise AssertionError(f"{path} REMAT {remat!r} DROP {drop} step {i}: "
                                             f"launches {rose} (want {per_step}), loss "
                                             f"{losses[-1]}")
                    if i == 0:
                        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
                        first = issued
                before = launch_counts(kernels)
                device, _ = step_device_ms(torch, lambda: run(step))
                for fn in kernels:  # the profiled step is not the path's
                    fn.launches = before[fn.__name__]
                peak = torch.cuda.max_memory_allocated() / 2**30
                med = statistics.median(secs[1:])
                err, at = bf16_grad_worst(grads, classic[drop][1])
                held = (f"against the classic one-rank step (DROP {drop}) max ‖err‖ / ‖ref‖ "
                        f"{err:.3e} at {at} (tol {BF16_PARAM_GRAD_TOL:g})")
                same = True
                if twin is not None:
                    same = all(torch.equal(grads[n], g) for n, g in twin.items())
                    held += f"; against REMAT '' bit for bit {same}"
                phase(path, f"ViL-Small {SPATIAL_IMG}^2 bf16 batch {SPATIAL_BATCH} on the "
                            f"one-card mesh, REMAT {remat!r}, DROP {drop}: step median "
                            f"{med * 1e3:.3f} ms ({SPATIAL_BATCH / med:.1f} img/s, steps "
                            f"2..{SPATIAL_OPTION_STEPS}), device {device:.3f} ms (torch.profiler, "
                            f"one step), idle {100 * (1 - device / med / 1e3):.1f}%, peak memory "
                            f"{peak:.2f} GiB; launches a step "
                            f"{ {k: v for k, v in per_step.items() if v} }; a step's "
                            f"{collectives_line(first)}; losses "
                            f"{', '.join(f'{v:.4f}' for v in losses)}; first step's gradients "
                            f"{held}")
                if not (err <= BF16_PARAM_GRAD_TOL and same):
                    raise AssertionError(f"{path} REMAT {remat!r} DROP {drop}: gradients "
                                         f"{err} at {at}, bit for bit {same}")
                twin = twin or grads
                del model, step, grads
                torch.cuda.empty_cache()
            paths[path] = launch_counts(kernels)
    # the draw of a whole mask where a rank holds part of it: ViL-Small
    # 1024²'s stage-1 MLP hidden (37x37 chunks of 49, 384 features), against
    # the first rank's 20 chunk rows of a split of 2
    g = torch.Generator(device=dev).manual_seed(0)
    whole = (SPATIAL_BATCH, 37, 37, 49, 384)
    part = (SPATIAL_BATCH, 20, 37, 49, 384)
    ms_whole = time_ms(lambda: torch.rand(whole, generator=g, device=dev) < 0.9)
    ms_part = time_ms(lambda: torch.rand(part, generator=g, device=dev) < 0.9)
    phase(name, f"dropout draw at stage 1's hidden, ViL-Small {SPATIAL_IMG}^2 batch "
                f"{SPATIAL_BATCH}: the whole grid's mask {ms_whole:.3f} ms "
                f"({math.prod(whole) * 4 / 2**20:.0f} MiB of f32 uniforms) against a rank's "
                f"20 of 37 chunk rows {ms_part:.3f} ms (CUDA events, median of 20)")
    return paths


def multicard_rank(rank, world, store, inputs, result):
    """One rank of the multi-card phase: ViL-Small 1024²'s bf16 recipe step
    from the seeded weights, its rows split over ``world`` cards (``nccl``,
    a ('data', 'spatial') mesh of 1 × world), on the batch of ``inputs``
    (at its per-block ``modes`` of random shift where it holds them);
    rank 0 writes its loss and gradients to ``result``."""
    import torch

    sys.path.insert(0, REPO)
    from vil_tpu_torch import parallel
    from vil_tpu_torch.train import recipe

    parallel.init_process_group(store, rank, world, backend="nccl")
    try:
        dev = torch.device("cuda", rank)
        data = torch.load(inputs, map_location=dev)
        mesh = parallel.create_mesh((1, world), ("data", "spatial"))
        on = parallel.Mesh(spatial=parallel.SpatialContext.of(mesh.get_group("spatial")))
        model = recipe.vil("vil_small", SPATIAL_IMG, torch.bfloat16, torch.float32, device=dev)
        modes = data.get("modes")
        step = recipe.train_step(model, dev, modes is not None, batch=SPATIAL_BATCH, mesh=on,
                                 seed=0)
        gen = torch.Generator(device=dev)
        loss = step(data["images"], data["labels"], gen.manual_seed(3),
                    modes=modes)["loss"].item()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        secs = []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(data["images"], data["labels"], gen.manual_seed(3), modes=modes)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if rank == 0:
            torch.save({"loss": loss, "secs": secs, "grads": grads}, result)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_multicard(torch, images, labels, one_rank, modes=None):
    """The multi-card phase, with more than one card: the train_spatial
    step (shift_spatial's, at its per-block ``modes``, where they are given)
    at D 2, and at D 4 where four cards exist (the ragged split 280, 280,
    280, 184 rows), each in D spawned ``nccl`` ranks, one card each, its
    first step's gradients against the one-rank step's (``one_rank``: loss,
    gradients) at BF16_PARAM_GRAD_TOL; then STEPS more steps timed on rank 0
    (the weights move, so only the first is compared). On one card it only
    says so."""
    path = "train_spatial" if modes is None else "shift_spatial"
    cards = torch.cuda.device_count()
    if cards < 2:
        phase("multicard", f"multi-card phase of {path} not run: {cards} card")
        return
    import torch.multiprocessing as mp

    for world in (w for w in (2, 4) if w <= cards):
        tmp = os.path.join(REPO, "build", f"multicard.{os.getpid()}.{path}.{world}")
        os.makedirs(tmp, exist_ok=True)
        inputs, result = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "result.pt")
        torch.save({"images": images.cpu(), "labels": labels.cpu(), "modes": modes}, inputs)
        t0 = time.perf_counter()
        mp.spawn(multicard_rank, args=(world, os.path.join(tmp, "store"), inputs, result),
                 nprocs=world)
        got = torch.load(result)
        grads = {n: g.to(images.device) for n, g in got["grads"].items()}
        err, at = bf16_grad_worst(grads, one_rank[1])
        med = statistics.median(got["secs"])
        phase("multicard", f"{path} at D {world} on {world} cards (nccl, {cards} "
                           f"present), {time.perf_counter() - t0:.1f} s with start-up: loss "
                           f"{got['loss']:.6f} vs one rank {one_rank[0]:.6f}; gradients max "
                           f"‖err‖ / ‖ref‖ {err:.3e} at {at} (tol {BF16_PARAM_GRAD_TOL:g}); step "
                           f"median {med * 1e3:.3f} ms (steps 2..{STEPS + 1} on rank 0)")
        if not (math.isfinite(got["loss"]) and err <= BF16_PARAM_GRAD_TOL):
            raise AssertionError(f"multicard: the D {world} step disagrees: gradients {err} at "
                                 f"{at}")


def run_experiment_spatial(torch, kernels):
    """Phase 19 (``experiment_spatial``): ``run_experiment.main`` on a
    ('data', 'spatial') mesh of one card (TPU.MESH_AXES ['data','spatial'],
    MESH_SHAPE [1,1], an ``nccl`` group of one), phase 15's recipe cut to one
    MODE-0 epoch of 8 steps, its eval, one checkpoint and the best
    checkpoint's eval; launches from the trainer's counts (B7a, B7b in place
    of B1, B2). The same run without the mesh first, outside the path's
    counts; the loader's threads cut to 0, so that both read the same
    batches: every logged loss to EXPERIMENT_LOSS_TOL."""
    import shutil

    name = "experiment_spatial"
    args = EXPERIMENT_ARGS[:EXPERIMENT_ARGS.index("OPTIM.EPOCHS")] + [
        "OPTIM.EPOCHS", "1", "MODEL.VIT.MSVIT.MODE", "0", "LOG_FREQ", "1",
        "DATALOADER.WORKERS", "0"]
    runs = {}
    with OneRankGroup(name):
        for label, mesh in (("without the mesh", []),
                            ("mesh", ["TPU.MESH_AXES", "['data','spatial']",
                                      "TPU.MESH_SHAPE", "[1,1]"])):
            out = os.path.join(REPO, "build", f"chip_{name}_{len(runs)}")
            shutil.rmtree(out, ignore_errors=True)
            argv = args + mesh
            argv[argv.index("--output_dir") + 1] = out
            if mesh:
                for fn in kernels:
                    fn.launches = 0
            runs[label] = run_cli(torch, kernels, name, label, argv)
            files = sorted(os.listdir(out))
            if mesh and not {"checkpoint_1.ckpt", "model_best.ckpt", "config.yaml"} <= set(files):
                raise AssertionError(f"{name}: {out} holds {files}")
        launches = launch_counts(kernels)
    losses = {k: [r["loss"] for r in t.steps_log] for k, t in runs.items()}
    err = max(abs(a - b) for a, b in zip(losses["mesh"], losses["without the mesh"]))
    evals = {k: [(e["top1"], e["loss"]) for e in t.evals] for k, t in runs.items()}
    phase(name, f"{len(losses['mesh'])} steps on the mesh: losses "
                f"{', '.join(f'{v:.4f}' for v in losses['mesh'])}; max |err| against the run "
                f"without the mesh {err:.3e} (tol {EXPERIMENT_LOSS_TOL:g}); evals (top1, loss) "
                f"{evals['mesh']} vs {evals['without the mesh']}")
    if not (len(losses["mesh"]) == len(losses["without the mesh"]) == 8
            and err <= EXPERIMENT_LOSS_TOL):
        raise AssertionError(f"{name}: the mesh's losses differ: {losses}")
    return launches


SHIFT_SPATIAL_STEPS = 3  # timed steps of shift_spatial's two runs; the first is the warm-up


def run_shift_spatial(torch, kernels):
    """Part ``shift_spatial``: shift_1024's step (ViL-Small 1024², the MODE 1
    recipe at batch 8, bf16, per-block modes drawn by the step keyed by
    (seed, step)) on a ('data', 'spatial') mesh of one card (an ``nccl``
    group of one, the halos through the exchange), the chunked stages
    through the sampled-neighbour halo kernels B5h and B6h. The classic
    shift_1024 step from the same weights runs first, outside the path's
    counts; each takes SHIFT_SPATIAL_STEPS steps and PROFILED more under
    torch.profiler (wall, device time, idle share, peak memory), and the two
    must draw the same modes. Launches exact: B5h 3, B6h 3, B3 9, B4 9 a
    step (B3t/B4b 8 of them, at N 4097), nothing else. Then one bf16 step,
    spatial vs classic, from the same weights and modes (gradients to
    BF16_PARAM_GRAD_TOL), and one f32 step on the mesh of ViL-Small with
    stage 3 cut to one block at batch 2, kernels vs plain versions (loss to
    LOSS_TOL, gradients to PARAM_GRAD_TOL of their max|ref|)."""
    from vil_tpu_torch import parallel
    from vil_tpu_torch.tools.profile_step import family, kernel_ms
    from vil_tpu_torch.train import recipe

    name = "shift_spatial"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(SPATIAL_BATCH, SPATIAL_IMG, SPATIAL_IMG, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (SPATIAL_BATCH,), generator=gen, device=dev)
    with OneRankGroup(name):
        mesh = parallel.Mesh(spatial=parallel.SpatialContext.of(None))
        walls, launches, drawn = {}, None, {}
        for label, on, chunk in (("shift_1024", None, "vil_mode_attention"),
                                 ("shift_spatial", mesh, "vil_mode_attention_halo")):
            per_step = {fn.__name__: 0 for fn in kernels}
            per_step.update({f"{chunk}_fwd": 3, f"{chunk}_bwd": 3, "full_attention_fwd": 9,
                             "full_attention_bwd": 9})
            model = recipe.vil("vil_small", SPATIAL_IMG, torch.bfloat16, torch.float32,
                               device=dev)
            step = recipe.train_step(model, dev, True, batch=SPATIAL_BATCH, mesh=on, seed=0)
            step_gen = torch.Generator(device=dev).manual_seed(3)
            secs, losses, modes = [], [], []

            def timed():
                before = launch_counts(kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metrics = step(images, labels, step_gen)
                losses.append(metrics["loss"].item())
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                modes.append(metrics["modes"])
                rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
                if rose != per_step:
                    raise AssertionError(f"{label} step {len(secs)}: launches rose by {rose}, "
                                         f"want {per_step}")

            if on is not None:  # the path: its counts from 0
                for fn in kernels:
                    fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            for _ in range(SHIFT_SPATIAL_STEPS):
                timed()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(PROFILED):
                    timed()
            if on is not None:
                launches = launch_counts(kernels)
            families = {}
            for kernel, ms in kernel_ms(prof).items():
                families[family(kernel)] = families.get(family(kernel), 0.0) + ms
            device = sum(families.values()) / PROFILED
            med = statistics.median(secs[1:SHIFT_SPATIAL_STEPS])
            walls[label], drawn[label] = (med, device), modes
            top = ", ".join(f"{k} {v / PROFILED:.3f}" for k, v in
                            sorted(families.items(), key=lambda kv: -kv[1])[:8])
            phase(name, f"{label}: ViL-Small {SPATIAL_IMG}^2 MODE 1 bf16 batch {SPATIAL_BATCH}"
                        f"{' on a group of 1 (nccl)' if on else ''}: median {med * 1e3:.3f} ms, "
                        f"{SPATIAL_BATCH / med:.1f} img/s (steps 2..{SHIFT_SPATIAL_STEPS}), "
                        f"first {secs[0] * 1e3:.1f} ms; device {device:.3f} ms a step "
                        f"(torch.profiler over {PROFILED} more: {top}), idle "
                        f"{100 * (1 - device / med / 1e3):.1f}%; peak memory "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
                        f"{', '.join(f'{v:.4f}' for v in losses)}; modes of the first step "
                        f"{modes[0]}")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{name} {label}: losses not finite: {losses}")
            del model, step
            torch.cuda.empty_cache()
        if drawn["shift_1024"] != drawn["shift_spatial"]:
            raise AssertionError(f"{name}: the runs drew other modes: {drawn}")
        steps = SHIFT_SPATIAL_STEPS + PROFILED
        want = {fn.__name__: 0 for fn in kernels}
        want.update(vil_mode_attention_halo_fwd=3 * steps, vil_mode_attention_halo_bwd=3 * steps,
                    full_attention_fwd=9 * steps, full_attention_bwd=9 * steps)
        phase(name, f"launches {({k: v for k, v in launches.items() if v})} (want "
                    f"{({k: v for k, v in want.items() if v})}, the rest 0); spatial / classic "
                    f"wall {walls['shift_spatial'][0] / walls['shift_1024'][0]:.3f}, device "
                    f"{walls['shift_spatial'][1] / walls['shift_1024'][1]:.3f}")
        if launches != want:
            raise AssertionError(f"{name}: launch counts {launches} != {want}")

        modes = drawn["shift_spatial"][0]
        bf = spatial_step_pair(torch, torch.bfloat16, SPATIAL_BATCH, "", images, labels, mesh,
                               modes)
        err, at = bf16_grad_worst(bf["spatial"][1], bf["classic"][1])
        phase(name, f"bf16 step at modes {modes}, batch {SPATIAL_BATCH}, spatial vs classic: "
                    f"loss {bf['spatial'][0]:.6f} vs {bf['classic'][0]:.6f}; parameter "
                    f"gradients max ‖err‖ / ‖ref‖ {err:.3e} at {at} (tol "
                    f"{BF16_PARAM_GRAD_TOL:g})")
        if not (math.isfinite(bf["spatial"][0]) and err <= BF16_PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: bf16 step disagrees: gradients {err} at {at}")
        one_rank = bf["spatial"]
        del bf
        # f32 on the mesh: B5h/B6h's f32 bodies against the plain spatial tier
        f32 = spatial_step_pair(torch, torch.float32, SPATIAL_PAIR, SHALLOW_VIL_SMALL, images,
                                labels, mesh, modes[:5],
                                runs={"kernels": (mesh, True), "plain": (mesh, False)})
        loss_err = abs(f32["kernels"][0] - f32["plain"][0])
        grad_err, worst, _ = f32_grad_errors(f32["kernels"][1], f32["plain"][1])
        phase(name, f"f32 step on the mesh at modes {modes[:5]}, ViL-Small with stage 3 cut to "
                    f"one block, batch {SPATIAL_PAIR}, kernels vs plain versions: loss "
                    f"{f32['kernels'][0]:.6f} vs {f32['plain'][0]:.6f} (|err| {loss_err:.3e}, "
                    f"tol {LOSS_TOL:g}); parameter gradients max rel err {grad_err:.3e} at "
                    f"{worst} (tol {PARAM_GRAD_TOL:g})")
        if not (loss_err <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: f32 step disagrees: loss {loss_err}, gradients "
                                 f"{grad_err} at {worst}")
        del f32
        torch.cuda.empty_cache()
    run_multicard(torch, images, labels, one_rank, modes)
    return launches


def run_self_spatial(torch, kernels):
    """Part ``self_spatial``: ViL-Small 224² (bf16 compute, f32 parameters,
    batch 64) at mode -1 on a ('data', 'spatial') mesh of one card (an
    ``nccl`` group of one): REQUESTS serving forwards through
    ``parallel.spatial_forward(..., mode=-1)`` (the self-only B5 3, B3 9 a
    forward) and STEPS training steps at mode -1 on the mesh (the self-only
    pair 3 each, B3, B4 9 a step), on each rank's rows without an exchange;
    nothing else launched. Then the f32 logits and one f32 step's loss and
    gradients on the mesh against the classic self_chunk path's (no mesh)
    from the same weights, images and generator, at LOGITS_TOL, LOSS_TOL and
    PARAM_GRAD_TOL."""
    from vil_tpu_torch import parallel
    from vil_tpu_torch.train import recipe

    name = "self_spatial"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    per_forward = {fn.__name__: 0 for fn in kernels}
    per_forward.update(vil_self_attention_fwd=3, full_attention_fwd=9)
    per_step = dict(per_forward, vil_self_attention_bwd=3, full_attention_bwd=9)
    with OneRankGroup(name):
        mesh = parallel.Mesh(spatial=parallel.SpatialContext.of(None))
        model = recipe.vil_small(torch.bfloat16, torch.float32, device=dev)
        step = recipe.train_step(model, dev, mesh=mesh)
        rows = parallel.shard_image(images, model)

        def serve():
            with torch.inference_mode():
                out = parallel.spatial_forward(model.eval(), rows, mode=-1)
            if out.shape != (BATCH, 1000) or not torch.isfinite(out).all():
                raise AssertionError(f"{name}: logits bad: {tuple(out.shape)}")

        losses = []
        train = lambda: losses.append(step(images, labels,
                                           torch.Generator(device=dev).manual_seed(3),
                                           modes=-1)["loss"].item())
        for fn in kernels:
            fn.launches = 0
        medians = []
        for want, run, count in ((per_forward, serve, REQUESTS), (per_step, train, STEPS)):
            secs = []
            for i in range(count):
                before = launch_counts(kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
                if rose != want:
                    raise AssertionError(f"{name} run {i}: launches rose by {rose}, want {want}")
            medians.append(statistics.median(secs[1:]))
        launches = launch_counts(kernels)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses not finite: {losses}")
        phase(name, f"ViL-Small 224^2 at mode -1 on a group of 1 (nccl), bf16 compute, f32 "
                    f"parameters, batch {BATCH}: {REQUESTS} spatial_forward calls, median "
                    f"{medians[0] * 1e3:.3f} ms ({BATCH / medians[0]:.1f} img/s); {STEPS} "
                    f"steps, median {medians[1] * 1e3:.3f} ms ({BATCH / medians[1]:.1f} "
                    f"img/s), losses {', '.join(f'{v:.4f}' for v in losses)}; launches "
                    f"{ {k: v for k, v in launches.items() if v} } "
                    f"({ {k: v for k, v in per_step.items() if v} } a step)")
        del model, step

        def run_f32(on):
            """f32 logits and one step's (loss, gradients) at mode -1, on
            the mesh or classic, from the recipe's weights."""
            m = recipe.vil_small(torch.float32, torch.float32, True, dev)
            with torch.inference_mode():
                logits = (parallel.spatial_forward(m.eval(), parallel.shard_image(images, m),
                                                   mode=-1) if on else
                          m.eval()(images, mode=-1)).float()
            s = recipe.train_step(m, dev, mesh=on)
            loss = s(images, labels, torch.Generator(device=dev).manual_seed(3),
                     modes=-1)["loss"].item()
            return logits, loss, {n: p.grad.clone() for n, p in m.named_parameters()}

        (lg_s, loss_s, grads_s), (lg_c, loss_c, grads_c) = run_f32(mesh), run_f32(None)
    lg_err, loss_err = (lg_s - lg_c).abs().max().item(), abs(loss_s - loss_c)
    grad_err, worst, _ = f32_grad_errors(grads_s, grads_c)
    phase(name, f"f32 at mode -1, mesh vs classic (self_chunk's path): logits max|err| "
                f"{lg_err:.3e} (tol {LOGITS_TOL:g}); step loss {loss_s:.6f} vs {loss_c:.6f} "
                f"(|err| {loss_err:.3e}, tol {LOSS_TOL:g}); parameter gradients max rel err "
                f"{grad_err:.3e} at {worst} (tol {PARAM_GRAD_TOL:g})")
    if not (lg_err <= LOGITS_TOL and loss_err <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
        raise AssertionError(f"{name}: f32 disagrees: logits {lg_err}, loss {loss_err}, "
                             f"gradients {grad_err} at {worst}")
    return launches


def run_experiment_spatial_shift(torch, kernels):
    """Part ``experiment_spatial_shift``: ``run_experiment.main`` with
    TPU.MESH_AXES ['data','spatial'] and MESH_SHAPE [1,1] on an ``nccl``
    group of one, phase 15's recipe (MODEL.VIT.MSVIT.MODE 1, VIL_MODE_SWITCH
    0.5 of 2 epochs: random shift in the first, MODE 0 in the second; the
    loader's threads cut to 0, its evals and checkpoints); launches from the
    trainer's counts (B5h, B6h in the first epoch, B7a, B7b in the second),
    every logged loss against the same run without the mesh first, outside
    the path's counts, at EXPERIMENT_LOSS_TOL."""
    import shutil

    name = "experiment_spatial_shift"
    args = EXPERIMENT_ARGS + ["DATALOADER.WORKERS", "0"]
    runs = {}
    with OneRankGroup(name):
        for label, mesh in (("without the mesh", []),
                            ("mesh", ["TPU.MESH_AXES", "['data','spatial']",
                                      "TPU.MESH_SHAPE", "[1,1]"])):
            out = os.path.join(REPO, "build", f"chip_{name}_{len(runs)}")
            shutil.rmtree(out, ignore_errors=True)
            argv = args + mesh
            argv[argv.index("--output_dir") + 1] = out
            if mesh:
                for fn in kernels:
                    fn.launches = 0
            runs[label] = run_cli(torch, kernels, name, label, argv)
        launches = launch_counts(kernels)
    trainer = runs["mesh"]
    losses = {k: [r["loss"] for r in t.steps_log] for k, t in runs.items()}
    shifted = [r["random_shift"] for r in trainer.steps_log]
    err = max(abs(a - b) for a, b in zip(losses["mesh"], losses["without the mesh"]))
    evals = {k: [(e["top1"], e["loss"]) for e in t.evals] for k, t in runs.items()}
    phase(name, f"{len(losses['mesh'])} steps on the mesh (random shift {shifted.count(True)}, "
                f"MODE 0 {shifted.count(False)}): losses "
                f"{', '.join(f'{v:.4f}' for v in losses['mesh'])}; max |err| against the run "
                f"without the mesh {err:.3e} (tol {EXPERIMENT_LOSS_TOL:g}); evals (top1, loss) "
                f"{evals['mesh']} vs {evals['without the mesh']}")
    if not (len(losses["mesh"]) == len(losses["without the mesh"]) == 16
            and shifted == [True] * 8 + [False] * 8 and err <= EXPERIMENT_LOSS_TOL):
        raise AssertionError(f"{name}: the mesh's run differs: {losses}, random shift {shifted}")
    if not (launches["vil_mode_attention_halo_fwd"] and launches["vil_attention_halo_bwd"]):
        raise AssertionError(f"{name}: B5h or B7b not launched: {launches}")
    return launches


# parameter sharding (parts ``train_tp``, ``train_fsdp``): train_tp
# (ViL-Small 224² over a ('data', 'model') mesh of 1 × 3 ranks),
# train_tp_shift (the same with random shift), train_tp_remat,
# train_tp_drop, resnet_tp, and train_fsdp (FSDP over a data axis of 2),
# train_fsdp_remat, resnet_fsdp, each rank a process. On one card the ranks share it over a gloo group (NCCL refuses
# two ranks on one card); where the host has a card a rank, over nccl.
# Their f32 pairs run the shallow ViL-Small at SHARD_PAIR images a replica
TP_RANKS, FSDP_RANKS, SHARD_PAIR = 3, 2, 2
# the attention families under 'tp' (train_tp_families): recipe.VARIANTS' names
TP_FAMILIES = ("linformer", "srformer", "performer", "global", "unshared")
SHARD_STEPS = 2  # steps of a sharded path: the first compared, the second timed
SHARD_DIR = os.path.join(REPO, "build", "chip_sharding")


def shard_mesh(torch, data: int, model: int):
    """This rank's ``parallel.Mesh`` on a (data, model) mesh over the
    default group (a model axis of 1: the data axis alone)."""
    from vil_tpu_torch import parallel

    if model == 1:
        return parallel.Mesh(data, torch.distributed.get_rank())
    dm = parallel.create_mesh((data, model), ("data", "model"))
    return parallel.Mesh(data, dm.get_local_rank("data"),
                         model=parallel.TensorParallel.of(dm.get_group("model")),
                         data_group=dm.get_group("data"))


def shard_rank(rank, world, spec_path):
    """One rank of a sharded path (``spec_path``: the spec ``run_sharded``
    saved). For each case the model (this rank's shard of the heads under
    'tp', sliced by ``parallel.fully_shard`` under 'fsdp') takes ``steps``
    recipe steps on its replica's images: the first one's loss and
    gradients (and updated parameters) are gathered whole, the launches of
    all of them counted; then one step under torch.profiler (device time)
    and one with every collective inside a synchronised clock (their wall
    share); the bytes of parameters and moments held and the peak memory of
    every rank. Rank 0 writes the results."""
    import torch

    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from vil_tpu_torch import parallel
    from vil_tpu_torch.ops.kernels import KERNELS
    from vil_tpu_torch.train import recipe

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent: f32 is f32
    torch.backends.cudnn.allow_tf32 = False
    spec = torch.load(spec_path, weights_only=False)
    nccl = torch.cuda.device_count() >= world
    dev = torch.device("cuda", rank if nccl else 0)
    torch.cuda.set_device(dev)
    parallel.init_process_group(spec["store"], rank, world, backend="nccl" if nccl else "gloo",
                                local_rank=rank if nccl else None)
    out = {"backend": "nccl" if nccl else "gloo", "cases": {}}
    try:
        data = torch.load(spec["inputs"], map_location=dev)
        if "mesh_opts" in spec:  # beside a spatial axis: the entry point's own mesh
            from vil_tpu_torch.config import get_default_cfg

            cfg = get_default_cfg()
            cfg.merge_from_list(spec["mesh_opts"])
            mesh, sharding = parallel.mesh_from_cfg(cfg), cfg.TPU.PARAM_SHARDING
        else:
            mesh = shard_mesh(torch, spec["data"], spec["model"])
            sharding = "tp" if spec["model"] > 1 else "fsdp"
        keyed = spec["data"] > 1  # the replicas' draws keyed by (seed, step, replica)
        share = spec.get("batch", BATCH) // spec["data"]
        out["walls"] = {"start": time.perf_counter() - t_start}
        for case in spec["cases"]:
            t_case = time.perf_counter()
            on = mesh if case["mesh"] else parallel.Mesh(spec["data"], mesh.data_rank)
            model = shard_model(torch, case, dev, on, sharding if case["mesh"] else "")
            if sharding == "fsdp" and case["mesh"]:
                parallel.fully_shard(model, on)
            step = shard_step(torch, model, case, dev, on, keyed)
            lo = mesh.data_rank * share
            images = data["images"][lo:lo + case["batch"]]
            labels = data["labels"][lo:lo + case["batch"]]
            gen = torch.Generator(device=dev)

            def run():  # the draws of the one-rank reference
                return step(images, labels, None if keyed else gen.manual_seed(3),
                            modes=case["modes"])

            for fn in KERNELS:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            t_built = time.perf_counter()
            with parallel.count_collectives() as issued:
                loss = run()["loss"].item()
            t_first = time.perf_counter()

            def whole(n, t):
                return (model.param_shards[n].gather(t) if n in model.param_shards
                        else t).cpu()

            got = {"loss": loss, "collectives": issued,
                   "grads": {n: whole(n, p.grad) for n, p in model.named_parameters()}}
            if case["dtype"] == torch.float32:  # the f32 pair checks the update too
                got["params"] = {n: whole(n, p.detach()) for n, p in model.named_parameters()}
            secs = []
            for _ in range(case["steps"] - 1):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize(dev)
                secs.append(time.perf_counter() - t0)
            got["launches"] = {fn.__name__: fn.launches for fn in KERNELS}
            got["secs"] = secs
            if case["profile"]:
                got["device_ms"], got["copy_ms"] = step_device_ms(torch, run)
            if case["profile"] and case["clocked"]:
                names = ("all_reduce", "all_gather", "all_gather_into_tensor",
                         "reduce_scatter_tensor")
                originals, spent = {n: getattr(dist, n) for n in names}, [0.0]

                def clocked(fn):
                    def call(*a, **k):
                        torch.cuda.synchronize(dev)
                        t = time.perf_counter()
                        r = fn(*a, **k)
                        torch.cuda.synchronize(dev)
                        spent[0] += time.perf_counter() - t
                        return r
                    return call

                for n, fn in originals.items():
                    setattr(dist, n, clocked(fn))
                try:
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize(dev)
                    got["instrumented_s"] = time.perf_counter() - t0
                finally:
                    for n, fn in originals.items():
                        setattr(dist, n, fn)
                got["collective_s"] = spent[0]
            held = parallel.param_bytes(model, step.optimizer)
            got["per_rank"] = parallel.all_gather((*held, torch.cuda.max_memory_allocated(dev)))
            out["cases"][case["name"]] = got
            out["walls"][case["name"]] = (t_built - t_case, t_first - t_built,
                                          time.perf_counter() - t_first)
            del model, step
            torch.cuda.empty_cache()
        if spec.get("cli"):  # the entry point on the same mesh, every rank
            from vil_tpu_torch import run_experiment as cli

            for fn in KERNELS:
                fn.launches = 0
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            trainer = cli.main(spec["cli"])
            torch.cuda.synchronize(dev)
            want, formula = experiment_want(trainer, KERNELS)
            out["cli"] = {"wall": time.perf_counter() - t0, "formula": formula, "want": want,
                          "launches": {fn.__name__: fn.launches for fn in KERNELS},
                          "losses": [r["loss"] for r in trainer.steps_log],
                          "evals": [(e["top1"], e["loss"]) for e in trainer.evals]}
        if rank == 0:
            torch.save(out, spec["result"])
    finally:
        dist.destroy_process_group()


def resnet_cfg(dtype: str, img: int = 224):
    """ResNet-50 of the zoo at ``img`` px (INPUT.IMAGE_SIZE, what a spatial
    split cuts) through ``build_model``'s tree: 1000 classes, ``dtype``
    compute, AdamW as the recipe's."""
    from vil_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_list(["MODEL.ARCH", "resnet50", "DATA.NUM_CLASSES", "1000",
                         "TPU.COMPUTE_DTYPE", dtype, "OPTIM.OPT", "adamw", "OPTIM.LR", "1e-3",
                         "OPTIM.WD", "0.05", "INPUT.IMAGE_SIZE", str(img)])
    return cfg


def shard_model(torch, case, dev, mesh, sharding):
    """A sharded path's model on ``mesh``: the recipe's ViL-Small of
    ``case`` at its image size (one of ``recipe.VARIANTS``' attention
    families where it names one, at the case's ARCH where it gives one;
    this model rank's shard under 'tp'), at
    its REMAT and DROP, or ResNet-50 (whole on every model rank; its
    BatchNorms over the data and spatial axes; parameters in f64 for an f64
    case, else f32), from seeded weights."""
    from vil_tpu_torch.models import build_model
    from vil_tpu_torch.train import recipe

    if case["resnet"]:
        dtype = "bfloat16" if case["dtype"] == torch.bfloat16 else "float32"
        wide = torch.float64 if case["dtype"] == torch.float64 else torch.float32
        return build_model(resnet_cfg(dtype, case["img"]), device=dev, mesh=mesh,
                           dtype=case["dtype"], param_dtype=wide,
                           generator=torch.Generator().manual_seed(0))
    variant = dict(recipe.VARIANTS.get(case["variant"], {}))
    variant["arch"] = case["arch"] or variant.get("arch", "")
    return recipe.vil("vil_small", case["img"], case["dtype"], torch.float32, device=dev,
                      mesh=mesh, sharding=sharding, remat=case["remat"], drop=case["drop"],
                      **variant)


def shard_step(torch, model, case, dev, mesh, keyed):
    """The recipe's step for a ViL; for the ResNet AdamW and cross-entropy
    without mixup (its BatchNorms couple the replicas' images: a mixup
    keyed by the replica would give no one-rank twin)."""
    from vil_tpu_torch.train import engine, loss, optim, recipe

    if case["resnet"]:
        return engine.make_train_step(model, loss.cross_entropy,
                                      optim.get_opt(resnet_cfg("float32"), model), device=dev,
                                      seed=0, mesh=mesh)
    # on a spatial axis the modes are keyed by the seed (injected here)
    split = mesh is not None and mesh.spatial is not None
    return recipe.train_step(model, dev, case["shift"], batch=case["step_batch"], mesh=mesh,
                             seed=0 if keyed or split else None)


def collectives_line(issued) -> str:
    """A step's collectives (``parallel.count_collectives``) by kind: count
    and MiB this rank handed over."""
    kinds = {}
    for name, sent in issued:
        n, b = kinds.get(name, (0, 0))
        kinds[name] = (n + 1, b + sent)
    total = sum(b for _, b in kinds.values())
    return (f"{len(issued)} collectives, {total / 2**20:.2f} MiB ("
            + ", ".join(f"{k} {n} / {b / 2**20:.2f} MiB" for k, (n, b) in sorted(kinds.items()))
            + ")")


def step_device_ms(torch, run) -> tuple[float, float]:
    """The card's time of one ``run()`` under torch.profiler: (everything,
    the copies and fills among it)."""
    from vil_tpu_torch.tools.profile_step import kernel_ms

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    ms = kernel_ms(prof)
    return sum(ms.values()), sum(v for k, v in ms.items() if "Memcpy" in k or "Memset" in k)


def one_rank_ref(torch, dtype, arch, parts, shift, modes, keyed, drop=0.0, resnet=False,
                 img=224, step_batch=BATCH, variant=""):
    """The one-rank recipe step from the seeded weights, without a process
    group, on each data replica's ``parts`` (images, labels): one part with
    the tp ranks' generator, or (``keyed``) each replica's step with its
    draws keyed by (0, 0, replica) (``parallel.Mesh(D, d)``), the gradients
    averaged and, in f32, one AdamW update taken from the average. Returns
    (loss, gradients, updated parameters or None, the update's LR), on the
    host. ``drop``: MODEL.VIT.DROP. ``resnet``: ResNet-50's step without
    mixup on every part's images at once (its BatchNorms take the whole
    batch's statistics, as on the mesh). ``img``: the model's image size;
    ``step_batch``: the ViL's recipe step's batch; ``variant``: one of
    ``recipe.VARIANTS``' attention families."""
    from vil_tpu_torch import parallel
    from vil_tpu_torch.train import recipe

    dev = parts[0][0].device
    if resnet:
        case = dict(resnet=True, dtype=dtype, img=img)
        m = shard_model(torch, case, dev, None, "")
        s = shard_step(torch, m, case, dev, None, False)
        loss = s(torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))["loss"]
        return loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()}, None, None
    losses, grads = [], []
    for d, (images, labels) in enumerate(parts):
        m = shard_model(torch, dict(resnet=False, dtype=dtype, img=img, arch=arch, drop=drop,
                                    remat="", variant=variant), dev, None, "replicated")
        s = recipe.train_step(m, dev, shift, batch=step_batch, seed=0 if keyed else None,
                              mesh=parallel.Mesh(len(parts), d) if keyed else None)
        gen = None if keyed else torch.Generator(device=dev).manual_seed(3)
        losses.append(s(images, labels, gen, modes=modes)["loss"].item())
        grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
        del m, s
        torch.cuda.empty_cache()
    if dtype != torch.float32:
        return (sum(losses) / len(parts),
                {n: (sum(g[n] for g in grads) / len(parts)).cpu() for n in grads[0]}, None, None)
    m = shard_model(torch, dict(resnet=False, dtype=dtype, img=224, arch=arch, drop=0.0,
                                remat="", variant=variant), dev, None, "replicated")
    s = recipe.train_step(m, dev, shift, batch=BATCH)
    lr = s.schedule(0)
    for n, p in m.named_parameters():
        p.grad = sum(g[n] for g in grads) / len(parts)
    for group in s.optimizer.param_groups:
        group["lr"] = lr
    s.optimizer.step()
    return (sum(losses) / len(parts), {n: p.grad.cpu() for n, p in m.named_parameters()},
            {n: p.detach().cpu() for n, p in m.named_parameters()}, lr)


def run_sharded(torch, name, world, data, model, cases, images, labels, **extra):
    """Spawn ``world`` ranks of ``shard_rank`` on a (data, model) mesh, or
    on the mesh of ``extra``'s ``mesh_opts`` (TPU.MESH_AXES, MESH_SHAPE and
    PARAM_SHARDING; ``batch``: the global batch; ``cli``: the entry point's
    arguments, run after the cases); returns rank 0's results."""
    import shutil

    import torch.multiprocessing as mp

    tmp = os.path.join(SHARD_DIR, f"{name}.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    spec = {"store": os.path.join(tmp, "store"), "inputs": os.path.join(tmp, "inputs.pt"),
            "result": os.path.join(tmp, "result.pt"), "data": data, "model": model,
            "cases": cases, **extra}
    torch.save({"images": images.cpu(), "labels": labels.cpu()}, spec["inputs"])
    torch.save(spec, os.path.join(tmp, "spec.pt"))
    t0 = time.perf_counter()
    try:
        mp.spawn(shard_rank, args=(world, os.path.join(tmp, "spec.pt")), nprocs=world)
        got = torch.load(spec["result"], weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walls = got["walls"]
    cases_s = "; ".join(f"{k} {b:.1f} build, {f:.1f} first step, {r:.1f} the rest"
                        for k, (b, f, r) in ((k, v) for k, v in walls.items() if k != "start"))
    layout = (f"{extra['mesh_opts'][3]} {extra['mesh_opts'][1]}" if "mesh_opts" in extra else
              f"{data} data x {model} model")
    phase(name, f"{world} ranks ({layout}) over {got['backend']}, "
                f"{torch.cuda.device_count()} card(s) present: {time.perf_counter() - t0:.1f} s; "
                f"rank 0 up in {walls['start']:.1f} s, then (s) {cases_s}")
    return got


def check_sharded(torch, name, what, got, ref, dtype, one_rank, own_tol=None):
    """Hold a sharded case to its one-rank reference: bf16 gradients to
    BF16_PARAM_GRAD_TOL (‖err‖ / ‖ref‖ per parameter); f32 loss to
    LOSS_TOL, gradients to PARAM_GRAD_TOL of max|ref| (those named in
    ``own_tol``, {parameter: limit}, to their own limit) and the updated
    parameters, where the gradient is resolved (≥ 1e-4 of its max|ref|, or
    twice its own limit), to
    a quarter of the update's LR (AdamW's first update moves each by about
    ±LR: a slice updated from another's gradient moves by 2·LR). Prints
    the walls, the collectives' share and what each rank holds."""
    loss, grads, params, lr = ref
    dev = torch.device("cuda")
    mine = {n: g.to(dev) for n, g in got["grads"].items()}
    refs = {n: g.to(dev) for n, g in grads.items()}
    if dtype == torch.bfloat16:
        err, at = bf16_grad_worst(mine, refs)
        ok = math.isfinite(got["loss"]) and err <= BF16_PARAM_GRAD_TOL
        msg = (f"parameter gradients max ‖err‖ / ‖ref‖ {err:.3e} at {at} "
               f"(tol {BF16_PARAM_GRAD_TOL:g})")
    else:
        own_tol = own_tol or {}
        err, at, _ = f32_grad_errors(mine, {n: g for n, g in refs.items() if n not in own_tol})
        own = {n: f32_grad_errors(mine, {n: refs[n]})[0] for n in own_tol}
        loss_err = abs(got["loss"] - loss)
        upd = 0.0
        for n, g in grads.items():
            floor = max(1e-4, 2 * own_tol.get(n, 0.0))  # no sign flipped by the error
            keep = g.abs() >= floor * g.abs().max() if g.numel() else g.bool()
            if keep.any():
                upd = max(upd, (got["params"][n] - params[n])[keep].abs().max().item())
        ok = (loss_err <= LOSS_TOL and err <= PARAM_GRAD_TOL and upd <= 0.25 * lr
              and all(e <= own_tol[n] for n, e in own.items()))
        msg = (f"|loss err| {loss_err:.3e} (tol {LOSS_TOL:g}); parameter gradients max rel err "
               f"{err:.3e} at {at} (tol {PARAM_GRAD_TOL:g})"
               + "".join(f", {n} {e:.3e} (tol {own_tol[n]:g})" for n, e in own.items())
               + f"; updated parameters max |err| {upd:.3e} (tol {0.25 * lr:.3g}, LR {lr:.3g})")
    phase(name, f"{what}: loss {got['loss']:.6f} vs one rank {loss:.6f}; {msg}")
    if not ok:
        raise AssertionError(f"{name} {what} disagrees: {msg}")
    phase(name, f"{what}: a step's {collectives_line(got['collectives'])} on rank 0")
    held = ", ".join(f"{p / 2**20:.1f} + {m / 2**20:.1f} MiB (peak {pk / 2**30:.2f} GiB)"
                     for p, m, pk in got["per_rank"])
    if got["secs"]:
        med = statistics.median(got["secs"])
        phase(name, f"{what}: step median {med * 1e3:.3f} ms on rank 0 (steps "
                    f"2..{len(got['secs']) + 1}; one rank {one_rank[0] * 1e3:.3f} ms, ratio "
                    f"{med / one_rank[0]:.3f})")
    if "device_ms" in got:
        share = (f"; collectives {100 * got['collective_s'] / got['instrumented_s']:.1f}% of an "
                 f"instrumented step ({got['collective_s'] * 1e3:.1f} of "
                 f"{got['instrumented_s'] * 1e3:.1f} ms)" if "collective_s" in got else "")
        phase(name, f"{what}: device {got['device_ms']:.3f} ms a step on rank 0, "
                    f"{got['copy_ms']:.3f} of it copies and fills (torch.profiler, one step; one "
                    f"rank {one_rank[1]:.3f}, {one_rank[2]:.3f}){share}")
    phase(name, f"{what}: parameters + optimizer moments held per rank between steps, and "
                f"peak memory: {held}")


def check_shard_launches(kernels, name, got, per_step, steps) -> dict:
    """Rank 0's launches over a case's ``steps`` steps: ``per_step`` each,
    every other kernel 0 (the layout probe's too, which the ranks do not
    import). Returns them."""
    got = {fn.__name__: got.get(fn.__name__, 0) for fn in kernels}
    want = {fn.__name__: 0 for fn in kernels}
    want.update({k: v * steps for k, v in per_step.items()})
    phase(name, f"launches on rank 0 over {steps} steps "
                f"{({k: v for k, v in got.items() if v})} (want "
                f"{({k: v for k, v in want.items() if v})}, the rest 0)")
    if got != want:
        raise AssertionError(f"{name}: launch counts {got} != {want}")
    return got


def shard_case(name, dtype, arch, steps, shift, batch, modes, profile=False, remat="",
               drop=0.0, resnet=False, mesh=True, img=224, step_batch=BATCH, clocked=True,
               variant=""):
    """A case of ``shard_rank``; with random shift, the first of ``modes``
    for each of the model's blocks; with ``profile``, one step more under
    torch.profiler and (``clocked``) one with its collectives clocked; ``remat``
    (TPU.REMAT) and ``drop`` (MODEL.VIT.DROP) of the ViL (ViL-Small at
    ``img`` px, the recipe's step at ``step_batch`` images a step; ``variant``
    one of ``recipe.VARIANTS``' attention families), or ResNet-50 at ``img``
    px (``resnet``); ``mesh`` False: each rank its replica's step on the
    data axis alone, without sharding."""
    from vil_tpu_torch.models.arch import parse_arch

    depth = sum(c.num_blocks for c in parse_arch(arch)) if arch else len(modes)
    return dict(name=name, dtype=dtype, arch=arch, steps=steps, shift=shift, batch=batch,
                modes=modes[:depth] if shift else None, profile=profile, remat=remat,
                drop=drop, resnet=resnet, mesh=mesh, img=img, step_batch=step_batch,
                clocked=clocked, variant=variant)


_SHARD_INPUTS: list = []  # shard_inputs' result, taken once a run


def shard_inputs(torch):
    """The sharded paths' batch, the recipe's first draw of per-block modes,
    and the one-rank step in this call: its median wall, its device time and
    the bytes of parameters and optimizer moments it holds. Taken once a
    run."""
    if _SHARD_INPUTS:
        return _SHARD_INPUTS[0]
    from vil_tpu_torch import parallel
    from vil_tpu_torch.train import engine, recipe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    modes = engine.sample_vil_modes(torch.Generator().manual_seed(0), 12)
    model = recipe.vil_small(torch.bfloat16, torch.float32, device=dev)
    step = recipe.train_step(model, dev)
    secs = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(images, labels, torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    device, copies = step_device_ms(
        torch, lambda: step(images, labels, torch.Generator(device=dev).manual_seed(3)))
    one_rank = (statistics.median(secs[1:]), device, copies)
    whole = parallel.param_bytes(model, step.optimizer)
    phase("sharding", f"one rank, ViL-Small 224^2 bf16 batch {BATCH}: step median "
                      f"{one_rank[0] * 1e3:.3f} ms (steps 2..{STEPS}); device {device:.3f} ms, "
                      f"{copies:.3f} of it copies and fills (torch.profiler, one step); "
                      f"parameters + optimizer moments {whole[0] / 2**20:.1f} + "
                      f"{whole[1] / 2**20:.1f} MiB")
    del model, step
    torch.cuda.empty_cache()
    _SHARD_INPUTS.append((images, labels, modes, one_rank, whole))
    return _SHARD_INPUTS[0]


REMAT_PER_STEP = {"vil_attention_fwd": 6, "vil_attention_bwd": 3, "full_attention_fwd": 18,
                  "full_attention_bwd": 9}  # ViL-Small under REMAT: the forwards twice
PLAIN_PER_STEP = {"vil_attention_fwd": 3, "vil_attention_bwd": 3, "full_attention_fwd": 9,
                  "full_attention_bwd": 9}


def check_twin(torch, name, what, got, twin, twin_what):
    """A case against its twin in the same spawn (REMAT against the same
    mesh's step without it, FSDP against the data axis without FSDP): the
    first step's gradients equal bit for bit (else raises; the bf16 error
    printed), and beside each other each one's peak memory a rank and its
    collectives a step on rank 0."""
    same = got["loss"] == twin["loss"] and all(
        torch.equal(g, twin["grads"][n]) for n, g in got["grads"].items())
    dev = torch.device("cuda")
    err, at = bf16_grad_worst({n: g.to(dev) for n, g in got["grads"].items()},
                              {n: g.to(dev) for n, g in twin["grads"].items()})
    peaks = lambda c: ", ".join(f"{pk / 2**30:.2f}" for _, _, pk in c["per_rank"])
    phase(name, f"{what} vs {twin_what}: loss {got['loss']:.6f} vs {twin['loss']:.6f}, "
                f"gradients bit for bit {same} (max ‖err‖ / ‖ref‖ {err:.3e} at {at}); peak "
                f"memory a rank {peaks(got)} GiB against {peaks(twin)}; collectives a step "
                f"on rank 0: {collectives_line(got['collectives'])} against "
                f"{collectives_line(twin['collectives'])}")
    if not same:
        raise AssertionError(f"{name}: {what} differs from {twin_what}: {err} at {at}")


def run_train_tp(torch, kernels) -> dict:
    """Part ``train_tp``: the paths train_tp and train_tp_shift, ViL-Small
    224² with the recipe's step (bf16 compute, f32 parameters, AdamW, mixup,
    drop path) at batch 64 under TPU.PARAM_SHARDING 'tp' on a ('data',
    'model') mesh of 1 × 3 ranks (H/3 = 1, 1, 2, 4 heads a rank, C/3
    channels), at MODE 0 and with random shift (the recipe's first draw of
    per-block modes, injected), every rank the whole batch and the one-rank
    step's generator; in the same spawn the paths train_tp_remat (REMAT
    'full' and 'minimal', one held step each),
    train_tp_drop (MODEL.VIT.DROP 0.1), resnet_tp (ResNet-50 224², whole on
    every model rank, one step and its timed and profiled ones) and the
    attention families (train_tp_families: one step each of the linformer,
    srformer, performer, only-global and unshared-global ViL-Small of
    ``recipe.VARIANTS``, a rank its H/3 heads, the paths
    ``train_tp_<family>``). Launches exact on rank 0 over SHARD_STEPS steps
    (one with random shift, under REMAT, at DROP 0.1 or for a family: their
    walls and device time are not taken again; PERF.md §5 keeps the earlier
    readings): B1 3, B2 3 (B5 3, B6 3 with random shift), B3 9, B4 9 a step; under REMAT B1 6 and B3 18 (the recompute);
    B3 9, B4 9 for a family (and B1 3, B2 3 for the unshared one); none for
    the ResNet. The first step's loss and gradients, gathered whole, against
    the one-rank step from the same weights and batch in bf16 (with the
    dropout's masks of the same generator) and, for the shallow model at
    SHARD_PAIR images, in f32 (updated parameters too); each REMAT case's
    against train_tp's, bit for bit, with both peaks and collectives. Then
    the multi-card phase, where the host has the cards. Returns {path:
    launches}."""
    from vil_tpu_torch.train import recipe

    images, labels, modes, one_rank, _ = shard_inputs(torch)
    cases = [shard_case("train_tp", torch.bfloat16, "", SHARD_STEPS, False, BATCH, modes,
                        profile=True),
             shard_case("tp_f32", torch.float32, SHALLOW_VIL_SMALL, 1, False, SHARD_PAIR,
                        modes),
             shard_case("train_tp_shift", torch.bfloat16, "", 1, True, BATCH, modes),
             shard_case("tp_shift_f32", torch.float32, SHALLOW_VIL_SMALL, 1, True, SHARD_PAIR,
                        modes)]
    extra = [shard_case("tp_remat_full", torch.bfloat16, "", 1, False, BATCH, modes,
                        remat="full"),
             shard_case("tp_remat_minimal", torch.bfloat16, "", 1, False, BATCH, modes,
                        remat="minimal"),
             shard_case("train_tp_drop", torch.bfloat16, "", 1, False, BATCH, modes, drop=0.1),
             shard_case("resnet_tp", torch.bfloat16, "", SHARD_STEPS, False, BATCH, modes,
                        profile=True, clocked=False, resnet=True)]
    families = [shard_case(f"train_tp_{v}", torch.bfloat16, "", 1, False, BATCH, modes,
                           variant=v) for v in TP_FAMILIES]
    # the srformer's gradients held in f32, as tp_f32 holds the ViL's
    sr_f32 = shard_case("tp_srformer_f32", torch.float32,
                        recipe.stage_feats(SHALLOW_VIL_SMALL, 8, 4), 1, False, SHARD_PAIR, modes,
                        variant="srformer")
    got = run_sharded(torch, "train_tp", TP_RANKS, 1, TP_RANKS,
                      cases + extra + families + [sr_f32], images, labels)
    paths = {}
    for c in cases + extra[2:] + families + [sr_f32]:
        path = ("train_tp_shift" if c["shift"] else "train_tp" if c in cases else
                f"train_tp_{c['variant']}" if c["variant"] else c["name"])
        parts = [(images[:c["batch"]], labels[:c["batch"]])]
        ref = one_rank_ref(torch, c["dtype"], c["arch"], parts, c["shift"], c["modes"], False,
                           c["drop"], c["resnet"], variant=c["variant"])
        case, own_tol = got["cases"][c["name"]], None
        if c is sr_f32:
            own_tol = {n: SR_CONV_TOL for n in ref[1] if n.endswith("proj_sr.weight")}
        elif c["variant"] == "srformer":
            case, ref = unheld_srformer(torch, path, case, ref, parts)
        kind = "bf16" if c["dtype"] == torch.bfloat16 else "f32 shallow"
        check_sharded(torch, path, f"{kind} step, batch {c['batch']}", case, ref, c["dtype"],
                      one_rank, own_tol)
    for c in cases[::2] + extra[2:3]:
        chunk = "vil_mode_attention" if c["shift"] else "vil_attention"
        paths[c["name"]] = check_shard_launches(
            kernels, c["name"], got["cases"][c["name"]]["launches"],
            {f"{chunk}_fwd": 3, f"{chunk}_bwd": 3, "full_attention_fwd": 9,
             "full_attention_bwd": 9}, c["steps"])
    # the families: B3/B4 at H/3 heads in the dense stages; the sliding-chunk
    # pair in stages 1-2 for the unshared-global ViL alone
    for c in families:
        per_step = {"full_attention_fwd": 9, "full_attention_bwd": 9}
        if c["variant"] == "unshared":
            per_step.update(vil_attention_fwd=3, vil_attention_bwd=3)
        paths[c["name"]] = check_shard_launches(kernels, c["name"],
                                                got["cases"][c["name"]]["launches"], per_step,
                                                c["steps"])
    paths["resnet_tp"] = check_shard_launches(kernels, "resnet_tp",
                                              got["cases"]["resnet_tp"]["launches"], {},
                                              SHARD_STEPS)
    paths["train_tp_remat"] = remat_paths(torch, kernels, "train_tp_remat", got, extra[:2],
                                          "train_tp", "the same 'tp' step without REMAT")
    run_multicard_tp(torch, images, labels, modes, one_rank)
    return paths


def unheld_srformer(torch, name, case, ref, parts):
    """The srformer's bf16 step: the parameters whose one-rank bf16
    gradient is off the one-rank f32 step's (same weights and batch) by
    more than BF16_PARAM_GRAD_TOL (‖err‖ / ‖ref‖), which the bf16 limit
    cannot tell from a fault, printed, each against the one-rank bf16 step
    beside that step's own error; returns the case and the reference
    without them, for ``check_sharded``. ``proj_sr`` reaches its weights
    through the instance norm, whose gradient takes out each channel's
    mean, and the sum that is left cancels (SR_CONV_TOL), so bf16's
    rounding moves it by a large share of its norm on one rank as on the
    mesh (0.22-0.47 against f32 on one rank). The srformer's f32 pair
    (``tp_srformer_f32``) holds every gradient."""
    dev = torch.device("cuda")
    exact = one_rank_ref(torch, torch.float32, "", parts, False, None, False,
                         variant="srformer")[1]
    loss, grads, params, lr = ref
    rel = lambda a, b: ((a.to(dev) - b.to(dev)).norm() / b.to(dev).norm()).item()
    own = {n: rel(g, exact[n]) for n, g in grads.items() if exact[n].norm() > 0}
    apart = sorted(n for n, e in own.items() if e > BF16_PARAM_GRAD_TOL)
    phase(name, f"bf16: {len(apart)} of {len(grads)} parameters off the one-rank f32 step by "
                f"more than the bf16 limit on one rank, printed and not held here "
                f"(‖err‖ / ‖ref‖ against the one-rank bf16 step; the one-rank bf16 step's "
                f"own against its f32 step):")
    for n in apart:
        phase(name, f"  {n}: {rel(case['grads'][n], grads[n]):.3e}; own {own[n]:.3e}")
    case = dict(case, grads={n: g for n, g in case["grads"].items() if n not in apart})
    return case, (loss, {n: g for n, g in grads.items() if n not in apart}, params, lr)


def remat_paths(torch, kernels, name, got, cases, twin, twin_what) -> dict:
    """The REMAT cases of a sharded path, 'full' then 'minimal': each
    against its twin without REMAT (bit for bit) and printed as
    ``check_sharded`` prints (wall, device time, collectives' share); their
    launches each exact (REMAT_PER_STEP) and summed for the path."""
    total = {fn.__name__: 0 for fn in kernels}
    for c in cases:
        case = got["cases"][c["name"]]
        check_twin(torch, name, f"REMAT {c['remat']!r}", case, got["cases"][twin], twin_what)
        one = check_shard_launches(kernels, f"{name} {c['remat']!r}", case["launches"],
                                   REMAT_PER_STEP, c["steps"])
        total = {k: total[k] + one[k] for k in total}
        if case["secs"]:
            phase(name, f"REMAT {c['remat']!r}: step median "
                        f"{statistics.median(case['secs']) * 1e3:.3f} ms on rank 0 "
                        f"(steps 2..{len(case['secs']) + 1}); device {case['device_ms']:.3f} ms "
                        f"a step, {case['copy_ms']:.3f} of it copies and fills (torch.profiler, "
                        f"one step)")
    return total


def run_train_fsdp(torch, kernels) -> dict:
    """Part ``train_fsdp``: the same step under TPU.PARAM_SHARDING 'fsdp'
    over a data axis of 2 ranks, each its 32 images with draws keyed by its
    replica: the parameters of at least 2^14 elements and their Adam moments
    held as 1/2 slices between steps, gathered a block at a time,
    gradients reduce-scattered. Launches exact on rank 0: the one-rank
    step's, B1 3, B2 3, B3 9, B4 9 a step (under REMAT B1 6, B3 18). The
    first step's averaged gradients against the one-rank steps of the two
    replicas (bf16; f32 for the shallow model at SHARD_PAIR images a rank,
    updated parameters too); the bytes each rank holds against the
    replicated run's, and its peak memory. In the same spawn the paths
    train_fsdp_remat (REMAT 'full' and 'minimal', each against train_fsdp
    bit for bit) and resnet_fsdp (ResNet-50 224², 32 images a rank, its
    BatchNorms over both: against the same step on the data axis without
    FSDP bit for bit, and, printed, against the one-rank step on the 64
    images; no kernel of the port). Returns {path: launches}."""
    images, labels, modes, one_rank, whole = shard_inputs(torch)
    cases = [shard_case("train_fsdp", torch.bfloat16, "", SHARD_STEPS, False, BATCH // 2,
                        modes, profile=True),
             shard_case("fsdp_f32", torch.float32, SHALLOW_VIL_SMALL, 1, False, SHARD_PAIR,
                        modes)]
    extra = [shard_case("fsdp_remat_full", torch.bfloat16, "", SHARD_STEPS, False, BATCH // 2,
                        modes, profile=True, clocked=False, remat="full"),
             shard_case("fsdp_remat_minimal", torch.bfloat16, "", SHARD_STEPS, False,
                        BATCH // 2, modes, profile=True, clocked=False,
                        remat="minimal"),
             shard_case("resnet_fsdp", torch.bfloat16, "", SHARD_STEPS, False, BATCH // 2,
                        modes, profile=True, clocked=False, resnet=True),
             shard_case("resnet_data", torch.bfloat16, "", 1, False, BATCH // 2, modes,
                        resnet=True, mesh=False)]
    got = run_sharded(torch, "train_fsdp", FSDP_RANKS, FSDP_RANKS, 1, cases + extra, images,
                      labels)
    share = BATCH // FSDP_RANKS
    for c in cases:
        parts = [(images[d * share:d * share + c["batch"]],
                  labels[d * share:d * share + c["batch"]]) for d in range(FSDP_RANKS)]
        ref = one_rank_ref(torch, c["dtype"], c["arch"], parts, False, None, True)
        kind = "bf16" if c["dtype"] == torch.bfloat16 else "f32 shallow"
        check_sharded(torch, "train_fsdp", f"{kind} step, {c['batch']} images a rank", got["cases"][c["name"]], ref, c["dtype"],
                      one_rank)
    launches = check_shard_launches(
        kernels, "train_fsdp", got["cases"]["train_fsdp"]["launches"],
        {"vil_attention_fwd": 3, "vil_attention_bwd": 3, "full_attention_fwd": 9,
         "full_attention_bwd": 9}, SHARD_STEPS)
    params, moments, _ = got["cases"]["train_fsdp"]["per_rank"][0]
    phase("train_fsdp", f"held by rank 0 between steps {params / 2**20:.1f} + "
                        f"{moments / 2**20:.1f} MiB against the replicated run's "
                        f"{whole[0] / 2**20:.1f} + {whole[1] / 2**20:.1f} MiB")
    if not (params < whole[0] and moments < whole[1]):
        raise AssertionError(f"train_fsdp: a rank holds {params} + {moments} bytes, the "
                             f"replicated run {whole}")
    paths = {"train_fsdp": launches}
    paths["train_fsdp_remat"] = remat_paths(torch, kernels, "train_fsdp_remat", got, extra[:2],
                                            "train_fsdp", "the same 'fsdp' step without REMAT")
    # the ResNet: against the data axis without FSDP (the same BatchNorm
    # sums), and, printed, against one rank on the whole batch
    res = got["cases"]["resnet_fsdp"]
    check_twin(torch, "resnet_fsdp", "ResNet-50 under 'fsdp'", res, got["cases"]["resnet_data"],
               "the data axis without FSDP")
    ref = one_rank_ref(torch, torch.bfloat16, "", [(images, labels)], False, None, False,
                       resnet=True)
    dev = torch.device("cuda")
    err, at = bf16_grad_worst({n: g.to(dev) for n, g in res["grads"].items()},
                              {n: g.to(dev) for n, g in ref[1].items()})
    phase("resnet_fsdp", f"against one rank on the {BATCH} images (printed: two replicas' "
                         f"BatchNorm sums add in another order, and a BatchNorm gradient "
                         f"cancels): loss {res['loss']:.6f} vs {ref[0]:.6f}, gradients max "
                         f"‖err‖ / ‖ref‖ {err:.3e} at {at}; step median "
                         f"{statistics.median(res['secs']) * 1e3:.3f} ms on rank 0, device "
                         f"{res['device_ms']:.3f} ms a step")
    if not math.isfinite(res["loss"]):
        raise AssertionError(f"resnet_fsdp: loss {res['loss']}")
    paths["resnet_fsdp"] = check_shard_launches(kernels, "resnet_fsdp", res["launches"], {},
                                                SHARD_STEPS)
    return paths


# heads and rows split at once (parts train_spatial_tp, train_spatial_fsdp):
# part → (TPU.MESH_AXES, TPU.MESH_SHAPE, TPU.PARAM_SHARDING)
SPLIT_MESHES = {"train_spatial_tp": (("data", "spatial", "model"), (1, 2, 3), "tp"),
                "train_spatial_fsdp": (("data", "spatial"), (2, 2), "fsdp")}
# a step's launches on a spatial axis: B7a/B7b at MODE 0, B5h/B6h with random
# shift, and under REMAT 'full' the forwards twice
SPLIT_PER_STEP = {"": {"vil_attention_halo_fwd": 3, "vil_attention_halo_bwd": 3,
                       "full_attention_fwd": 9, "full_attention_bwd": 9},
                  "shift": {"vil_mode_attention_halo_fwd": 3, "vil_mode_attention_halo_bwd": 3,
                            "full_attention_fwd": 9, "full_attention_bwd": 9},
                  "remat": {"vil_attention_halo_fwd": 6, "vil_attention_halo_bwd": 3,
                            "full_attention_fwd": 18, "full_attention_bwd": 9}}
_SPLIT_INPUTS: list = []  # split_inputs' result, taken once a run


def split_inputs(torch):
    """train_spatial's batch (ViL-Small 1024², 8 images), the recipe's first
    draw of per-block modes and the classic one-rank step in this call: its
    median wall over STEPS steps (the first left out) and its device time
    and copies under torch.profiler (one step). Taken once a run."""
    if _SPLIT_INPUTS:
        return _SPLIT_INPUTS[0]
    from vil_tpu_torch.train import engine, recipe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randn(SPATIAL_BATCH, SPATIAL_IMG, SPATIAL_IMG, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (SPATIAL_BATCH,), generator=gen, device=dev)
    modes = engine.sample_vil_modes(torch.Generator().manual_seed(0), 12)
    torch.cuda.reset_peak_memory_stats()
    model = recipe.vil("vil_small", SPATIAL_IMG, torch.bfloat16, torch.float32, device=dev)
    step = recipe.train_step(model, dev, batch=SPATIAL_BATCH)
    run = lambda: step(images, labels, torch.Generator(device=dev).manual_seed(3))
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    device, copies = step_device_ms(torch, run)
    one_rank = (statistics.median(secs[1:]), device, copies)
    phase("split", f"one rank, ViL-Small {SPATIAL_IMG}^2 bf16 batch {SPATIAL_BATCH}: step median "
                   f"{one_rank[0] * 1e3:.3f} ms (steps 2..3); device {device:.3f} ms, {copies:.3f} "
                   f"of it copies and fills (torch.profiler, one step); peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, step
    torch.cuda.empty_cache()
    _SPLIT_INPUTS.append((images, labels, modes, one_rank))
    return _SPLIT_INPUTS[0]


def run_split_sharded(torch, kernels, name: str) -> dict:
    """Parts ``train_spatial_tp`` and ``train_spatial_fsdp``: train_spatial's
    step (ViL-Small 1024², batch 8, bf16 compute, f32 parameters, the
    recipe's AdamW, mixup and drop path) with heads and rows split at once,
    its ranks sharing the card over gloo (nccl where the host has a card a
    rank): under 'tp' on a (1, 2, 3) ('data', 'spatial', 'model') mesh, each
    rank its model group's H/3 heads (1, 1, 2, 4) of its spatial group's
    rows (20/17 chunk rows at stage 1); under 'fsdp' on a (2, 2) ('data',
    'spatial') mesh, each replica 4 images, its rows over 2 ranks, the
    parameters sliced over the data axis. The mesh is the entry point's
    (``parallel.mesh_from_cfg``). Per part three cases: MODE 0 (one step and
    one more under torch.profiler: the device time; the wall of a timed
    step is not taken again, PERF.md §5 keeps the earlier reading), random
    shift (the recipe's
    first draw of per-block modes, injected) and REMAT 'full'. Launches
    exact on rank 0 (SPLIT_PER_STEP: B7a 3, B7b 3, B3 9, B4 9 a step at H/3
    or H heads; B5h/B6h with random shift; B7a 6, B3 18 under REMAT); the
    first step's loss and gradients,
    gathered whole, against the classic one-rank step from the same weights
    and batch (the two replicas' keyed steps averaged under 'fsdp') at
    BF16_PARAM_GRAD_TOL; REMAT bit for bit the MODE-0 case. Printed: walls,
    device time, the collectives and bytes a step, what each rank holds and
    its peak. The 'fsdp' spawn then runs ``run_experiment.main`` on its
    mesh for one epoch (ViL-Small 224², DATALOADER.BSZ 16, 8 steps), its
    launches held to the trainer's counts. Returns {path: launches}."""
    import shutil

    images, labels, modes, one_rank = split_inputs(torch)
    axes, shape, sharding = SPLIT_MESHES[name]
    data, world = shape[0], math.prod(shape)
    mesh_opts = ["TPU.MESH_AXES", str(list(axes)), "TPU.MESH_SHAPE", str(list(shape)),
                 "TPU.PARAM_SHARDING", sharding]
    share = SPATIAL_BATCH // data
    split = dict(img=SPATIAL_IMG, step_batch=SPATIAL_BATCH)
    cases = [shard_case(name, torch.bfloat16, "", 1, False, share, modes,
                        profile=True, clocked=False, **split),
             shard_case(f"{name}_shift", torch.bfloat16, "", 1, True, share, modes, **split),
             shard_case(f"{name}_remat", torch.bfloat16, "", 1, False, share, modes,
                        remat="full", **split)]
    extra = {}
    if sharding == "fsdp":
        cli_dir = os.path.join(SHARD_DIR, f"{name}_cli.{os.getpid()}")
        shutil.rmtree(cli_dir, ignore_errors=True)
        args = EXPERIMENT_ARGS[:EXPERIMENT_ARGS.index("DATALOADER.BSZ")]
        args[args.index("--output_dir") + 1] = cli_dir
        extra["cli"] = args + ["DATALOADER.BSZ", "16", "OPTIM.EPOCHS", "1",
                               "MODEL.VIT.MSVIT.MODE", "0", "LOG_FREQ", "1",
                               "DATALOADER.WORKERS", "0", *mesh_opts]
    got = run_sharded(torch, name, world, data, 1, cases, images, labels, mesh_opts=mesh_opts,
                      batch=SPATIAL_BATCH, **extra)
    parts = [(images[d * share:(d + 1) * share], labels[d * share:(d + 1) * share])
             for d in range(data)]
    paths = {}
    for c, kind in zip(cases, ("", "shift", "remat")):
        case = got["cases"][c["name"]]
        if kind == "remat":
            check_twin(torch, name, "REMAT 'full'", case, got["cases"][name],
                       f"the same {sharding!r} step without REMAT")
        else:
            ref = one_rank_ref(torch, torch.bfloat16, "", parts, c["shift"], c["modes"],
                               data > 1, **split)
            check_sharded(torch, c["name"], f"bf16 step, {share} images a replica", case, ref,
                          torch.bfloat16, one_rank)
        paths[c["name"]] = check_shard_launches(kernels, c["name"], case["launches"],
                                                SPLIT_PER_STEP[kind], c["steps"])
    if "cli" in got:
        cli = got["cli"]
        shown = {k: v for k, v in cli["launches"].items() if v or cli["want"][k]}
        phase(name, f"run_experiment.main on the mesh: {cli['wall']:.1f} s on rank 0; losses "
                    f"{', '.join(f'{v:.4f}' for v in cli['losses'])}; evals (top1, loss) "
                    f"{cli['evals']}; launches on rank 0 {shown} (the rest 0), want "
                    f"{ {k: cli['want'][k] for k in shown} } from {cli['formula']}")
        if cli["launches"] != cli["want"] or not all(math.isfinite(v) for v in cli["losses"]):
            raise AssertionError(f"{name}: the entry point's run on the mesh: launches "
                                 f"{cli['launches']} != {cli['want']} or losses {cli['losses']}")
        shutil.rmtree(extra["cli"][extra["cli"].index("--output_dir") + 1], ignore_errors=True)
    run_multicard_split(torch, name, images, labels, modes, one_rank)
    return paths


RESNET_SPATIAL_IMG, RESNET_SPATIAL_BATCH, RESNET_SPATIAL_PAIR = 1024, 8, 2


def run_resnet_spatial(torch, kernels) -> dict:
    """Part ``resnet_spatial``: ResNet-50 at 1024², batch 8, on a (1, 2)
    ('data', 'spatial') mesh (``parallel.mesh_from_cfg``), two ranks sharing
    the card over gloo, each the rows of 16 of the image's 32 blocks of 32
    rows: its convolutions and max-pool read their halo rows from the other
    rank (through the host), its BatchNorms and the global pool sum over
    both. First the one-rank bf16 step in this process (median wall of
    steps 2..3, device time under torch.profiler, peak memory). In the
    spawn: SHARD_STEPS bf16 steps and one more under torch.profiler, then
    one f32 step at RESNET_SPATIAL_PAIR images. The bf16 step's loss and
    gradients are printed against the one-rank step's (a BatchNorm gradient
    cancels, as resnet_fsdp prints it); each of the f32 step's gradients is
    held, as part resnet holds the card's f32, to twice the same gradient's
    own error in the one-rank f32 step against the one-rank f64 step
    (‖err‖ / ‖ref‖; both one-rank steps in this process after the spawn)
    plus 1e-5, and printed against the one-rank f32 step. No kernel of the port
    runs (cuDNN's convolutions, as ``vil_tpu``'s XLA): every count 0.
    Printed: walls, device time, the collectives and bytes a step, what
    each rank holds and its peak. Returns {path: launches}."""
    dev = torch.device("cuda")
    img, batch, pair = RESNET_SPATIAL_IMG, RESNET_SPATIAL_BATCH, RESNET_SPATIAL_PAIR
    gen = torch.Generator(device=dev).manual_seed(4)
    images = torch.randn(batch, img, img, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
    one = dict(resnet=True, dtype=torch.bfloat16, img=img)
    model = shard_model(torch, one, dev, None, "")
    step = shard_step(torch, model, one, dev, None, False)
    torch.cuda.reset_peak_memory_stats()
    first = step(images, labels)["loss"].item()
    bf16_ref = (first, {n: p.grad.clone() for n, p in model.named_parameters()})
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(images, labels)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    device, copies = step_device_ms(torch, lambda: step(images, labels))
    one_rank = (statistics.median(secs), device, copies)
    phase("resnet_spatial", f"one rank, ResNet-50 {img}^2 bf16 batch {batch}: step median "
                            f"{one_rank[0] * 1e3:.3f} ms (steps 2..3); device {device:.3f} ms, "
                            f"{copies:.3f} of it copies and fills (torch.profiler, one step); "
                            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, step
    torch.cuda.empty_cache()
    mesh_opts = ["TPU.MESH_AXES", "['data', 'spatial']", "TPU.MESH_SHAPE", "[1, 2]",
                 "TPU.PARAM_SHARDING", "replicated"]
    cases = [shard_case("resnet_spatial", torch.bfloat16, "", SHARD_STEPS, False, batch, (),
                        profile=True, clocked=False, resnet=True, img=img),
             shard_case("resnet_spatial_f32", torch.float32, "", 1, False, pair, (),
                        resnet=True, img=img)]
    got = run_sharded(torch, "resnet_spatial", 2, 1, 1, cases, images, labels,
                      mesh_opts=mesh_opts, batch=batch)
    res, f32 = got["cases"]["resnet_spatial"], got["cases"]["resnet_spatial_f32"]
    err, at = bf16_grad_worst({n: g.to(dev) for n, g in res["grads"].items()},
                              {n: g.to(dev) for n, g in bf16_ref[1].items()})
    phase("resnet_spatial", f"bf16 step against one rank (printed: the halves' BatchNorm sums "
                            f"add in another order, and a BatchNorm gradient cancels): loss "
                            f"{res['loss']:.6f} vs {bf16_ref[0]:.6f}, gradients max ‖err‖ / "
                            f"‖ref‖ {err:.3e} at {at}")
    if not math.isfinite(res["loss"]):
        raise AssertionError(f"resnet_spatial: loss {res['loss']}")
    # the f32 step against the one-rank f32 and f64 steps from the same weights
    part = [(images[:pair], labels[:pair])]
    refs = {dt: one_rank_ref(torch, dt, "", part, False, None, False, resnet=True, img=img)
            for dt in (torch.float32, torch.float64)}
    exact = {n: g.to(dev) for n, g in refs[torch.float64][1].items()}

    def errs(grads):
        return {n: ((g.to(dev).double() - exact[n]).norm() / exact[n].norm()).item()
                for n, g in grads.items() if exact[n].norm() > 0}

    split, own = errs(f32["grads"]), errs(refs[torch.float32][1])
    share = {n: e / (2 * own[n] + 1e-5) for n, e in split.items()}  # of each leaf's limit
    at = max(share, key=share.get)
    split_at, one_at = max(split, key=split.get), max(own, key=own.get)
    pair_err, pair_at = bf16_grad_worst(
        {n: g.to(dev) for n, g in f32["grads"].items()},
        {n: g.to(dev) for n, g in refs[torch.float32][1].items()})
    loss_err = abs(f32["loss"] - refs[torch.float32][0])
    phase("resnet_spatial", f"f32 step, batch {pair}: loss {f32['loss']:.6f} vs one rank "
                            f"{refs[torch.float32][0]:.6f} (|err| {loss_err:.3e}, tol "
                            f"{LOSS_TOL:g}); gradients against the one-rank f64 step, ‖err‖ / "
                            f"‖ref‖, each leaf to twice the one-rank f32 step's own error "
                            f"+ 1e-5: the largest share of its limit {share[at]:.3f} at {at} "
                            f"(split {split[at]:.3e}, one rank {own[at]:.3e}); worst split f32 "
                            f"{split[split_at]:.3e} at {split_at}, worst one-rank f32 "
                            f"{own[one_at]:.3e} at {one_at}; split against the one-rank f32 "
                            f"{pair_err:.3e} at {pair_at}")
    if not (loss_err <= LOSS_TOL and share[at] <= 1.0):
        raise AssertionError(f"resnet_spatial f32 step disagrees: loss {loss_err}, gradient "
                             f"{at} {split[at]} > {2 * own[at] + 1e-5}")
    phase("resnet_spatial", f"bf16: a step's {collectives_line(res['collectives'])} on rank 0")
    held = ", ".join(f"{p / 2**20:.1f} + {m / 2**20:.1f} MiB (peak {pk / 2**30:.2f} GiB)"
                     for p, m, pk in res["per_rank"])
    med = statistics.median(res["secs"])
    phase("resnet_spatial", f"bf16: step median {med * 1e3:.3f} ms on rank 0 (steps "
                            f"2..{len(res['secs']) + 1}; one rank {one_rank[0] * 1e3:.3f} ms, "
                            f"ratio {med / one_rank[0]:.3f}); device {res['device_ms']:.3f} ms a "
                            f"step on rank 0, {res['copy_ms']:.3f} of it copies and fills "
                            f"(torch.profiler, one step; one rank {one_rank[1]:.3f}, "
                            f"{one_rank[2]:.3f}); parameters + optimizer moments held per rank "
                            f"between steps, and peak memory: {held}")
    return {"resnet_spatial": check_shard_launches(kernels, "resnet_spatial", res["launches"],
                                                   {}, SHARD_STEPS)}


def run_multicard_split(torch, name, images, labels, modes, one_rank):
    """The spatial-and-model multi-card phase, where the host has four
    cards: the MODE-0 case of train_spatial_tp on a (1, 2, 2) mesh over
    nccl, a card a rank, against the one-rank step. Elsewhere it only says
    so."""
    cards = torch.cuda.device_count()
    if name != "train_spatial_tp":
        return
    if cards < 4:
        phase("multicard", f"(1, 2, 2) ('data', 'spatial', 'model') over nccl not run: {cards} "
                           f"card(s)")
        return
    case = shard_case(name, torch.bfloat16, "", SHARD_STEPS, False, SPATIAL_BATCH, modes,
                      img=SPATIAL_IMG, step_batch=SPATIAL_BATCH)
    opts = ["TPU.MESH_AXES", "['data', 'spatial', 'model']", "TPU.MESH_SHAPE", "[1, 2, 2]",
            "TPU.PARAM_SHARDING", "tp"]
    got = run_sharded(torch, "multicard", 4, 1, 1, [case], images, labels, mesh_opts=opts,
                      batch=SPATIAL_BATCH)
    ref = one_rank_ref(torch, torch.bfloat16, "", [(images, labels)], False, None, False,
                       img=SPATIAL_IMG, step_batch=SPATIAL_BATCH)
    check_sharded(torch, "multicard", "train_spatial_tp at (1, 2, 2) on 4 cards over nccl",
                  got["cases"][name], ref, torch.bfloat16, one_rank)


def run_experiment_tp(torch, kernels) -> dict:
    """Part ``experiment_tp``: ``run_experiment.main`` on a ('data',
    'model') mesh of one card (TPU.MESH_AXES ['data','model'], MESH_SHAPE
    [1,1], an ``nccl`` group of one) with TPU.PARAM_SHARDING 'tp', then
    'fsdp' (its slices gathered and its gradients reduce-scattered through
    the group), phase 15's recipe cut to one MODE-0 epoch of 8 steps, as
    experiment_spatial; launches from the trainers' counts. The run without
    sharding first, outside the path's counts: every logged loss to
    EXPERIMENT_LOSS_TOL. Then the 'fsdp' run's checkpoint, written whole,
    resumes a replicated Trainer: at epoch 1, step 8, its weights bit for
    bit the sharded model's, gathered. Returns {"experiment_tp": launches}."""
    import shutil

    from vil_tpu_torch import parallel
    from vil_tpu_torch.run_experiment import config_from_args, parse_args
    from vil_tpu_torch.train.trainer import Trainer

    name = "experiment_tp"
    args = EXPERIMENT_ARGS[:EXPERIMENT_ARGS.index("OPTIM.EPOCHS")] + [
        "OPTIM.EPOCHS", "1", "MODEL.VIT.MSVIT.MODE", "0", "LOG_FREQ", "1",
        "DATALOADER.WORKERS", "0"]
    mesh = ["TPU.MESH_AXES", "['data','model']", "TPU.MESH_SHAPE", "[1,1]"]
    runs, outs = {}, {}
    with OneRankGroup(name):
        for label, extra in (("without sharding", []),
                             ("tp", mesh + ["TPU.PARAM_SHARDING", "tp"]),
                             ("fsdp", mesh + ["TPU.PARAM_SHARDING", "fsdp"])):
            outs[label] = os.path.join(REPO, "build", f"chip_{name}_{label.split()[0]}")
            shutil.rmtree(outs[label], ignore_errors=True)
            argv = args + extra
            argv[argv.index("--output_dir") + 1] = outs[label]
            if label == "tp":  # the path: its counts from 0
                for fn in kernels:
                    fn.launches = 0
            runs[label] = run_cli(torch, kernels, name, label, argv)
        launches = launch_counts(kernels)
        argv = list(args)
        argv[argv.index("--output_dir") + 1] = outs["fsdp"]
        gathered = parallel.full_state_dict(runs["fsdp"].model)
        resumed = Trainer(config_from_args(parse_args(argv)))
        same = all(torch.equal(v, gathered[k].to(v.device))
                   for k, v in resumed.model.state_dict().items())
        phase(name, f"the 'fsdp' run's checkpoint resumes a replicated Trainer at epoch "
                    f"{resumed.start_epoch}, step {resumed.train_step.step}; its weights "
                    f"{'equal' if same else 'differ from'} the sharded model's, gathered, bit "
                    f"for bit; sharded leaves {len(runs['fsdp'].model.param_shards)} (fsdp), "
                    f"{len(runs['tp'].model.param_shards)} (tp at a model axis of 1)")
        if not (same and resumed.start_epoch == 1 and resumed.train_step.step == 8
                and not resumed.model.param_shards and runs["fsdp"].model.param_shards):
            raise AssertionError(f"{name}: the fsdp checkpoint does not resume a replicated "
                                 f"Trainer")
        del resumed
    losses = {k: [r["loss"] for r in t.steps_log] for k, t in runs.items()}
    ref = losses["without sharding"]
    for label in ("tp", "fsdp"):
        err = max(abs(a - b) for a, b in zip(losses[label], ref))
        phase(name, f"{label}: {len(losses[label])} steps, losses "
                    f"{', '.join(f'{v:.4f}' for v in losses[label])}; max |err| against the run "
                    f"without sharding {err:.3e} (tol {EXPERIMENT_LOSS_TOL:g}); evals (top1, "
                    f"loss) {[(e['top1'], e['loss']) for e in runs[label].evals]}")
        if not (len(losses[label]) == len(ref) == 8 and err <= EXPERIMENT_LOSS_TOL):
            raise AssertionError(f"{name} {label}: the losses differ: {losses}")
    return {name: launches}


def run_multicard_tp(torch, images, labels, modes, one_rank):
    """The sharded multi-card phase, where the host has the cards: train_tp's
    bf16 step at a model axis of 2 over nccl, a card a rank (ViL-Small's
    stages 1-2, H 3, stay whole; 3-4 split), and at (data 2, model 2) on four
    cards (draws keyed by the replica), each against the one-rank step. On
    one card it only says so."""
    cards = torch.cuda.device_count()
    if cards < 2:
        phase("multicard", f"sharded multi-card phase not run: {cards} card")
        return
    for data, model in ((1, 2), (2, 2)):
        if data * model > cards:
            continue
        case = shard_case("train_tp", torch.bfloat16, "", SHARD_STEPS, False, BATCH // data,
                          modes)
        got = run_sharded(torch, "multicard", data * model, data, model, [case], images,
                          labels)
        parts = [(images[d * (BATCH // data):(d + 1) * (BATCH // data)],
                  labels[d * (BATCH // data):(d + 1) * (BATCH // data)]) for d in range(data)]
        ref = one_rank_ref(torch, torch.bfloat16, "", parts, False, None, data > 1)
        check_sharded(torch, "multicard", f"train_tp at (data {data}, model {model}) on "
                      f"{data * model} cards", got["cases"]["train_tp"], ref, torch.bfloat16,
                      one_rank)


def run_probe(torch, kernels):
    """Phase 10: the layout probe tool, once: P between two GEMMs in both
    schemes, its census of copy ops and its time per pass."""
    from vil_tpu_torch.tools import layout_probe

    for fn in kernels:
        fn.launches = 0
    results = layout_probe.run()
    launches = launch_counts(kernels)
    for scheme, res in results.items():
        copies = ", ".join(f"{k} {v:g}" for k, v in res["copies"].items())
        phase("probe", f"[{scheme}] ({layout_probe.B}, {layout_probe.MX}, {layout_probe.MY}, "
                       f"{layout_probe.W2}, {layout_probe.C}) bf16, GEMM -> P -> GEMM: copy ops "
                       f"per pass {copies}; {res['ms']:.4f} ms per pass")
    phase("probe", f"launches {launches}")
    others = [n for n, v in launches.items() if v and n not in ("consume_base", "consume_perm")]
    if not (launches["consume_base"] and launches["consume_perm"]) or others:
        raise AssertionError(f"probe launches {launches}")
    return launches


EXPERIMENT_DIR = os.path.join(REPO, "build", "chip_experiment")
# the CLI's arguments: configs/msvit.yaml's recipe on the synthetic set, the
# batch cut to 64, two epochs, random shift for the first
EXPERIMENT_ARGS = ["--config-file", os.path.join(REPO, "configs", "msvit.yaml"),
                   "--output_dir", EXPERIMENT_DIR, "--seed", "0",
                   "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                   "DATALOADER.BSZ", str(BATCH), "OPTIM.EPOCHS", "2", "MODEL.VIT.MSVIT.MODE", "1",
                   "MODEL.VIT.MSVIT.VIL_MODE_SWITCH", "0.5", "LOG_FREQ", "1"]


def block_counts(model) -> tuple[int, int]:
    """(sliding-chunk blocks, dense blocks) of an MsViT: the launches of B1
    (B2; B5, B6) and of B3 (B4) per forward (per step)."""
    from vil_tpu_torch.models.attention import FullAttention, VilAttention

    return (sum(isinstance(m, VilAttention) for m in model.modules()),
            sum(isinstance(m, FullAttention) for m in model.modules()))


def experiment_want(trainer, kernels) -> tuple[dict, str]:
    """The launches a run of the CLI must have made, from the trainer's own
    counts and its model's blocks (ViL-Small: 3 sliding-chunk, 9 dense): per
    random-shift step B5, B6 one per sliding-chunk block and B3, B4 one per
    dense block; per MODE-0 step B1, B2 and B3, B4 the same (B7a, B7b for
    B1, B2 and B5h, B6h for B5, B6 on a mesh with a spatial axis); per eval
    batch (the best
    checkpoint's eval included) B1 (B7a) and B3; none with the plain
    versions."""
    want = {fn.__name__: 0 for fn in kernels}
    shift, mode0, ev = trainer.steps_run[True], trainer.steps_run[False], trainer.eval_batches
    formula = (f"{shift} random-shift steps, {mode0} MODE-0 steps, {ev} eval batches "
               f"(best-checkpoint eval {'ran' if trainer.best_evaluated else 'did not run'})")
    if not trainer.cfg.TPU.USE_PALLAS:
        return want, formula + ", plain versions"
    chunk, dense = block_counts(trainer.model)
    split = trainer.mesh.spatial is not None
    local = "vil_attention_halo" if split else "vil_attention"
    sampled = "vil_mode_attention_halo" if split else "vil_mode_attention"
    want.update(full_attention_fwd=dense * (shift + mode0 + ev),
                full_attention_bwd=dense * (shift + mode0))
    want.update({f"{local}_fwd": chunk * (mode0 + ev), f"{local}_bwd": chunk * mode0,
                 f"{sampled}_fwd": chunk * shift, f"{sampled}_bwd": chunk * shift})
    return want, formula + f", {chunk} sliding-chunk and {dense} dense blocks" + (
        ", on a spatial mesh" if local != "vil_attention" else "")


def run_cli(torch, kernels, name: str, label: str, argv: list):
    """One in-process run of ``python -m vil_tpu_torch.run_experiment`` for
    the path ``name``: its wall, its launches held to the trainer's counts
    (``experiment_want``) and its losses finite. Returns the Trainer."""
    from vil_tpu_torch import run_experiment as cli

    before = launch_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
    want, formula = experiment_want(trainer, kernels)
    shown = {k: v for k, v in rose.items() if v or want[k]}
    phase(name, f"{label}: {wall:.1f} s; launches {shown} (the rest 0); want "
                f"{ {k: want[k] for k in shown} } from {formula}")
    if rose != want:
        raise AssertionError(f"{label}: launches {rose} != {want}")
    losses = [r["loss"] for r in trainer.steps_log] + [e["loss"] for e in trainer.evals]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: losses not finite: {losses}")
    return trainer


class ProfiledSteps:
    """Train steps ``first`` to ``first + count - 1`` of the next run
    (counted from 1, by ``engine.TrainStep`` calls) under ``torch.profiler``,
    the card's activity alone (which keeps the profiler's own work small):
    the window's wall, the loop's work between the steps included, and the
    card's kernel time in it, in seconds. Their ratio is the busy share of a
    steady window, after the loader's start-up."""

    def __init__(self, torch, first: int, count: int):
        self.torch, self.first, self.count = torch, first, count
        self.wall = self.device = 0.0

    def __enter__(self):
        from vil_tpu_torch.tools.profile_step import kernel_ms
        from vil_tpu_torch.train import engine

        torch, rec, call = self.torch, self, engine.TrainStep.__call__
        calls = []

        def profiled(step, *args, **kwargs):
            calls.append(None)
            if len(calls) == rec.first:
                torch.cuda.synchronize()
                rec.prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                rec.prof.__enter__()
                rec.t0 = time.perf_counter()
            out = call(step, *args, **kwargs)
            if len(calls) == rec.first + rec.count - 1:
                torch.cuda.synchronize()
                rec.wall = time.perf_counter() - rec.t0
                rec.prof.__exit__(None, None, None)
                rec.device = sum(kernel_ms(rec.prof).values()) / 1e3
            return out

        self._restore = (engine.TrainStep, call)
        engine.TrainStep.__call__ = profiled
        return self

    def __exit__(self, *exc):
        cls, call = self._restore
        cls.__call__ = call


def run_experiment_path(torch, kernels):
    """Phase 15: the port's entry point, ``python -m vil_tpu_torch.run_experiment``,
    driven in-process through its ``main(argv)`` at ViL-Small's full width
    and depth: two epochs (random shift, then MODE 0), a resume to a third
    epoch, a reload of the last checkpoint under EVALUATE (bit for bit), and
    the same eval in f32 with the kernels and with the plain versions."""
    import shutil

    from vil_tpu_torch.train import schedulers

    name = "experiment"
    shutil.rmtree(EXPERIMENT_DIR, ignore_errors=True)
    for fn in kernels:
        fn.launches = 0

    run = lambda label, argv: run_cli(torch, kernels, name, label, argv)

    def epochs(trainer, label):
        for epoch in sorted({r["epoch"] for r in trainer.steps_log}):
            rows = [r for r in trainer.steps_log if r["epoch"] == epoch]
            batch = statistics.median(r["batch_time"] for r in rows[1:])
            data = statistics.median(r["data_time"] for r in rows[1:])
            mode = "random shift" if rows[0]["random_shift"] else "MODE 0"
            losses = ", ".join(f"{r['loss']:.4f}" for r in rows)
            phase(name, f"{label} epoch {epoch} ({mode}, {len(rows)} steps): median batch_time "
                        f"{batch * 1e3:.3f} ms, data_time {data * 1e3:.3f} ms (steps "
                        f"2..{len(rows)}), {BATCH / batch:.1f} img/s; losses {losses}")

    # 1. two epochs: random shift in epoch 0 (< 0.5 * 2), MODE 0 in epoch 1
    torch.cuda.reset_peak_memory_stats()
    first = run("two-epoch run", EXPERIMENT_ARGS)
    flags = [(r["epoch"], r["random_shift"]) for r in first.steps_log]
    if flags != [(0, True)] * 8 + [(1, False)] * 8 or first.eval_batches != 8 * 2 + 8:
        raise AssertionError(f"two-epoch run: (epoch, random shift) per step {flags}, "
                             f"{first.eval_batches} eval batches (want 8 x 3)")
    epochs(first, "two-epoch run")
    mode0_wall = statistics.median(r["batch_time"] for r in first.steps_log[9:])
    phase(name, f"two-epoch run evals: " + "; ".join(
        f"top1 {e['top1']:.4f} loss {e['loss']:.6f}" for e in first.evals)
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del first

    # 2. a resume to three epochs, its MODE-0 steps 2..8 under torch.profiler
    # for the card's busy share (the profiler's host work lengthens the wall,
    # so the share is a lower bound)
    argv = EXPERIMENT_ARGS[:EXPERIMENT_ARGS.index("OPTIM.EPOCHS") + 1] + ["3"] + \
        EXPERIMENT_ARGS[EXPERIMENT_ARGS.index("OPTIM.EPOCHS") + 2:]
    with ProfiledSteps(torch, 2, 7) as profiled:
        resumed = run("resume to 3 epochs", argv)
    log = resumed.steps_log
    want_lr = schedulers.get_lr_schedule(resumed.cfg)(16)
    phase(name, f"resume: start epoch {resumed.start_epoch}, first step {log[0]['step']}, its "
                f"LR {log[0]['lr']!r} (get_lr_schedule at step 16: {want_lr!r}); "
                f"{len(log)} steps, random shift {sorted({r['random_shift'] for r in log})}")
    if not (resumed.start_epoch == 2 and log[0]["step"] == 16 and log[0]["lr"] == want_lr
            and len(log) == 8 and not any(r["random_shift"] for r in log)):
        raise AssertionError("the resume did not start at epoch 2, step 16, at its LR, MODE 0")
    epochs(resumed, "resume (profiled)")
    steps = profiled.count
    device = profiled.device / steps
    phase(name, f"resume epoch 2, steps 2..{steps + 1} under torch.profiler: wall "
                f"{profiled.wall * 1e3 / steps:.3f} ms per step, device {device * 1e3:.3f} ms "
                f"per step, busy {100 * profiled.device / profiled.wall:.1f}%; against the "
                f"two-epoch run's unprofiled MODE-0 median wall {mode0_wall * 1e3:.3f} ms: idle "
                f"{100 * (1 - device / mode0_wall):.1f}%")
    last = resumed.evals[0]  # after epoch 2, from checkpoint_3's weights
    for f in ("checkpoint_1.ckpt", "checkpoint_2.ckpt", "checkpoint_3.ckpt",
              "checkpoint_1.ckpt.json", "checkpoint_2.ckpt.json", "checkpoint_3.ckpt.json",
              "last_checkpoint", "config.yaml"):
        if not os.path.isfile(os.path.join(EXPERIMENT_DIR, f)):
            raise AssertionError(f"{f} missing from {EXPERIMENT_DIR}")
    del resumed

    # 3. the last checkpoint reloaded under EVALUATE: its eval bit for bit
    ckpt = os.path.join(EXPERIMENT_DIR, "checkpoint_3.ckpt")

    def evaluate(label, *opts):
        out = os.path.join(EXPERIMENT_DIR, label)
        argv = EXPERIMENT_ARGS + ["EVALUATE", "True", "MODEL.MODEL_PATH", ckpt, *opts]
        argv[argv.index("--output_dir") + 1] = out
        return run(f"EVALUATE {label}", argv).evals[-1]

    reload = evaluate("reload")
    phase(name, f"reload of checkpoint_3: top1 {reload['top1']!r} loss {reload['loss']!r}; the "
                f"run's eval after epoch 2 top1 {last['top1']!r} loss {last['loss']!r}")
    if (reload["top1"], reload["loss"]) != (last["top1"], last["loss"]):
        raise AssertionError("the reloaded checkpoint's eval differs from the run's")

    # 4. the same eval in f32, kernels vs plain versions
    f32_k = evaluate("f32_kernels", "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS", "True")
    f32_p = evaluate("f32_plain", "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS", "False")
    err = abs(f32_k["loss"] - f32_p["loss"])
    phase(name, f"f32 eval of checkpoint_3, kernels vs plain versions: loss {f32_k['loss']:.6f} "
                f"vs {f32_p['loss']:.6f} (|err| {err:.3e}, tol {LOSS_TOL:g}); top1 "
                f"{f32_k['top1']} vs {f32_p['top1']}")
    if not (err <= LOSS_TOL and f32_k["top1"] == f32_p["top1"]):
        raise AssertionError(f"f32 eval disagrees: loss {err}, top1 {f32_k['top1']} vs "
                             f"{f32_p['top1']}")
    return launch_counts(kernels)


def efficient_per_pass(variant: dict) -> tuple[dict, dict]:
    """The kernels of one forward and of one training step of a recipe
    variant: the dense stages 3-4 (9 blocks) through B3 (and B4), and with
    unshared global weights the sliding-chunk stages 1-2 (3 blocks) through
    B1 (and B2); the efficient families reach no kernel."""
    forward, step = {"full_attention_fwd": 9}, {"full_attention_fwd": 9, "full_attention_bwd": 9}
    if not variant.get("sharew", True):
        forward["vil_attention_fwd"] = 3
        step.update(vil_attention_fwd=3, vil_attention_bwd=3)
    return forward, step


def run_efficient(torch, kernels) -> dict:
    """The paper's other attention families on ViL-Small 224², 1000 classes,
    batch 64 (``recipe.VARIANTS``: linformer, srformer, performer, global,
    unshared), each a path with its own launch counts: a bf16 serving
    forward on uint8 images (``REQUESTS``), ``STEPS`` bf16 training steps of
    the recipe (AdamW, mixup, drop path 0.1), timed as the other paths are
    (the median of all but the first), then the f32 forward and step with
    the kernels and with the plain versions from the same weights; the
    launches of each part held exactly. Then the performer through the
    entry point (``run_efficient_experiment``). Returns {path: launches}."""
    from vil_tpu_torch.ops import flops
    from vil_tpu_torch.train import recipe

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    served = torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    paths = {}
    for name, variant in recipe.VARIANTS.items():
        t_path = time.perf_counter()
        per_fwd, per_step = efficient_per_pass(variant)
        cfg = recipe.vil_small_cfg(**variant).MODEL.VIT.MSVIT

        def want(**times):
            """Launches of ``times[part]`` passes of each part."""
            out = {fn.__name__: 0 for fn in kernels}
            for part, n in times.items():
                for k, v in (per_fwd if part == "fwd" else per_step).items():
                    out[k] += v * n
            return out

        def held(what, rose, expect):
            if rose != expect:
                raise AssertionError(f"{name} {what}: launches {rose} != {expect}")

        for fn in kernels:
            fn.launches = 0
        # serving: bf16 parameters and compute
        model = recipe.vil_small(torch.bfloat16, torch.bfloat16, device=dev, **variant).eval()
        n_params = sum(p.numel() for p in model.parameters())
        n_buffers = sum(b.numel() for b in model.buffers())
        macs = flops.model_macs(cfg.ARCH, 224, cfg.ATTN_TYPE, sharew=cfg.SHARE_W,
                                share_kv=cfg.SHARE_KV)
        secs = []
        with torch.inference_mode():
            for _ in range(REQUESTS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = model(served)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        if logits.shape != (BATCH, 1000) or not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: bad serving logits {tuple(logits.shape)}")
        held("serving", launch_counts(kernels), want(fwd=REQUESTS))
        serve_ms = statistics.median(secs[1:]) * 1e3
        del model

        # training: f32 parameters under bf16 compute, the recipe's step
        before = launch_counts(kernels)
        model = recipe.vil_small(torch.bfloat16, torch.float32, device=dev, **variant)
        step = recipe.train_step(model, dev)
        step_gen = torch.Generator(device=dev).manual_seed(3)
        torch.cuda.reset_peak_memory_stats()
        secs, losses = [], []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(images, labels, step_gen)["loss"].item())
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses not finite: {losses}")
        rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
        held("training", rose, want(step=STEPS))
        train_ms = statistics.median(secs[1:]) * 1e3
        del model, step
        phase("efficient", f"{name} (ATTN_TYPE {cfg.ATTN_TYPE}, ONLY_GLOBAL {cfg.ONLY_GLOBAL}, "
                           f"SHARE_W {cfg.SHARE_W}, SHARE_KV {cfg.SHARE_KV}; stage 1-2 f "
                           f"{cfg.ARCH.split('_')[0].rsplit(',f', 1)[1]}, "
                           f"{cfg.ARCH.split('_')[1].rsplit(',f', 1)[1]}): {n_params / 1e6:.2f} M "
                           f"parameters, {n_buffers} buffer values, {macs['gmacs']:.3f} GMACs an "
                           f"image (ops/flops.py); serve bf16 batch {BATCH}: median "
                           f"{serve_ms:.3f} ms ({BATCH / serve_ms * 1e3:.1f} img/s, requests "
                           f"2..{REQUESTS}); train step: median {train_ms:.3f} ms "
                           f"({BATCH / train_ms * 1e3:.1f} img/s, steps 2..{STEPS}), "
                           f"losses {', '.join(f'{v:.4f}' for v in losses)}, peak memory "
                           f"{peak:.2f} GiB; launches per forward {per_fwd}, per step {per_step}")

        # f32, kernels vs plain versions: the forward, then one step
        before = launch_counts(kernels)
        outs = {}
        for key, use_kernels in (("kernels", True), ("plain", False)):
            m = recipe.vil_small(torch.float32, torch.float32, use_kernels, dev, **variant)
            with torch.inference_mode():
                logits = m.eval()(served)
            s = recipe.train_step(m, dev)
            loss = s(images, labels, torch.Generator(device=dev).manual_seed(3))["loss"].item()
            outs[key] = logits, loss, {n: p.grad.clone() for n, p in m.named_parameters()}
            del m, s
        rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
        held("f32 pair", rose, want(fwd=1, step=1))
        (lk, loss_k, gk), (lp, loss_p, gp) = outs["kernels"], outs["plain"]
        logit_err = (lk - lp).abs().max().item()
        grad_err, worst, _ = f32_grad_errors(gk, gp)
        phase("efficient", f"{name} f32, kernels vs plain versions: logits max|err| "
                           f"{logit_err:.3e} (tol {LOGITS_TOL:g}); step loss {loss_k:.6f} vs "
                           f"{loss_p:.6f} (|err| {abs(loss_k - loss_p):.3e}, tol {LOSS_TOL:g}); "
                           f"parameter gradients max rel err {grad_err:.3e} at {worst} (tol "
                           f"{PARAM_GRAD_TOL:g}); the path {time.perf_counter() - t_path:.1f} s")
        if not (torch.isfinite(lk).all() and logit_err <= LOGITS_TOL
                and abs(loss_k - loss_p) <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: f32 kernels vs plain disagree: logits {logit_err}, "
                                 f"loss {abs(loss_k - loss_p)}, gradients {grad_err} at {worst}")
        paths[name] = launch_counts(kernels)
    paths["experiment_performer"] = run_efficient_experiment(torch, kernels)
    return paths


EFFICIENT_EXPERIMENT_DIR = os.path.join(REPO, "build", "chip_experiment_performer")


def run_efficient_experiment(torch, kernels) -> dict:
    """The performer through ``python -m vil_tpu_torch.run_experiment``'s
    ``main(argv)``: configs/msvit.yaml's recipe with ATTN_TYPE performer at
    ViL-Small's width and depth, batch 64, the synthetic set (8 steps an
    epoch), two epochs and then a resume to three. The projection buffers
    must change before exactly the steps that a ``RedrawSchedule`` names
    (counted afresh by each run, as in ``vil_tpu``) and before no other, the
    last redraw must be the draw keyed by (seed, step), the resumed run must
    load the checkpoint's buffers bit for bit and its schedule count afresh;
    launches B3 9 a step and an eval batch, B4 9 a step, no other."""
    import shutil

    from vil_tpu_torch import run_experiment as cli
    from vil_tpu_torch.models.attention_efficient import gaussian_orthogonal_random_matrix
    from vil_tpu_torch.train import engine, recipe
    from vil_tpu_torch.train.redraw import RedrawSchedule
    from vil_tpu_torch.train.trainer import Trainer

    name = "experiment_performer"
    shutil.rmtree(EFFICIENT_EXPERIMENT_DIR, ignore_errors=True)
    argv = list(EXPERIMENT_ARGS)
    argv[argv.index("--output_dir") + 1] = EFFICIENT_EXPERIMENT_DIR
    i = argv.index("MODEL.VIT.MSVIT.MODE")
    argv[i:i + 4] = ["MODEL.VIT.MSVIT.ATTN_TYPE", "performer", "MODEL.VIT.MSVIT.ARCH",
                     recipe.VARIANTS["performer"]["arch"]]
    watch = {"last": None, "changed": []}

    def projections(model):
        return {n: b.clone() for n, b in model.named_buffers() if n.endswith("projection_matrix")}

    init, call = Trainer.__init__, engine.TrainStep.__call__

    def watched_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        watch["last"] = watch["loaded"] = projections(self.model)

    def watched_call(self, *args, **kwargs):
        now = projections(self.model)
        if any(not torch.equal(b, watch["last"][n]) for n, b in now.items()):
            watch["changed"].append(self.step)
        watch["last"] = now
        return call(self, *args, **kwargs)

    def schedule(epochs, steps=8, start=0):
        sched, out, step = RedrawSchedule(), [], start
        for epoch in epochs:
            sched.set_epoch(epoch)
            for _ in range(steps):
                if sched.should_redraw():
                    out.append(step)
                step += 1
        return out, sched.calls_since_last

    for fn in kernels:
        fn.launches = 0
    Trainer.__init__, engine.TrainStep.__call__ = watched_init, watched_call
    try:
        for label, epochs, start in (("two-epoch run", 2, 0), ("resume to 3 epochs", 3, 16)):
            watch["changed"] = []
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer = cli.main(argv[:argv.index("OPTIM.EPOCHS") + 1] + [str(epochs)]
                               + argv[argv.index("OPTIM.EPOCHS") + 2:])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
            steps, ev = sum(trainer.steps_run.values()), trainer.eval_batches
            expect = {fn.__name__: 0 for fn in kernels}
            expect.update(full_attention_fwd=9 * (steps + ev), full_attention_bwd=9 * steps)
            want_steps, want_count = schedule(range(trainer.start_epoch, epochs), start=start)
            rows = trainer.steps_log
            batch = statistics.median(r["batch_time"] for r in rows[1:]) * 1e3
            phase(name, f"{label}: {wall:.1f} s, start epoch {trainer.start_epoch}, {steps} "
                        f"steps, {ev} eval batches; median batch_time {batch:.3f} ms "
                        f"({BATCH / batch * 1e3:.1f} img/s); the projections changed before steps {watch['changed']}, the "
                        f"trainer redrew before {trainer.redraw_steps}, a fresh RedrawSchedule "
                        f"names {want_steps}; its count after the run "
                        f"{trainer.redraw_schedule.calls_since_last} (a fresh schedule's "
                        f"{want_count}); launches {({k: v for k, v in rose.items() if v})}")
            if not (watch["changed"] == trainer.redraw_steps == want_steps
                    and trainer.redraw_schedule.calls_since_last == want_count
                    and trainer.start_epoch == start // 8
                    and trainer.train_step.step == 8 * epochs):
                raise AssertionError(f"{label}: redraws {watch['changed']} / "
                                     f"{trainer.redraw_steps} != {want_steps}, or the count or "
                                     f"the start is wrong")
            if rose != expect:
                raise AssertionError(f"{label}: launches {rose} != {expect}")
            losses = [r["loss"] for r in rows] + [e["loss"] for e in trainer.evals]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{label}: losses not finite: {losses}")
            if start == 0:
                # the buffers the last step saw are the checkpoint's, and the
                # last redraw is the draw keyed by (seed, step, 2)
                ckpt = torch.load(os.path.join(EFFICIENT_EXPERIMENT_DIR, "checkpoint_2.ckpt"),
                                  map_location="cpu", weights_only=True)["model"]
                gen = torch.Generator().manual_seed(
                    engine.keyed_seed(trainer.cfg.TPU.SEED, want_steps[-1], 2))
                for n, b in watch["last"].items():
                    draw = gaussian_orthogonal_random_matrix(*b.shape, generator=gen)
                    if not (torch.equal(ckpt[n], b.cpu()) and torch.equal(draw, b.cpu())):
                        raise AssertionError(f"{n}: the checkpoint's or the keyed draw differs "
                                             f"from the buffer the last step saw")
            elif not all(torch.equal(b.cpu(), ckpt[n]) for n, b in watch["loaded"].items()):
                raise AssertionError("the resumed run did not load the checkpoint's buffers")
            del trainer
    finally:
        Trainer.__init__, engine.TrainStep.__call__ = init, call
    return launch_counts(kernels)


# the high-resolution paths (part ``highres``): path → (zoo model, image px,
# batch, the batch of the f32 and bf16 kernels-vs-plain pairs, serves,
# trains, random shift, relative position bias). The pairs' batches are cut
# where the plain versions' memory would not fit: the plain dense attention
# keeps (B, H, N, N) f32 scores and probabilities, about 0.8 GB an image and
# a block at N 4097; the RPE pairs' to keep the part near its time
HIGHRES = {
    "serve_384": ("vil_medium_deep", 384, 64, 64, True, False, False, False),
    "train_384": ("vil_medium_deep", 384, 64, 8, False, True, False, False),
    "serve_1024": ("vil_small", 1024, 8, 8, True, False, False, False),
    "train_1024": ("vil_small", 1024, 8, 2, False, True, False, False),
    "shift_1024": ("vil_small", 1024, 8, 2, False, True, True, False),
    "base_deep_384": ("vil_base_deep_384", 384, 32, 4, True, True, False, False),
    "serve_384_rpe": ("vil_medium_deep", 384, 64, 8, True, False, False, True),
    "train_384_rpe": ("vil_medium_deep", 384, 64, 8, False, True, False, True),
    "serve_1024_rpe": ("vil_small", 1024, 8, 2, True, False, False, True),
    "train_1024_rpe": ("vil_small", 1024, 8, 2, False, True, False, True),
}
PROFILED = 2  # requests or steps of a path under torch.profiler, after the timed ones
# paths whose depth is cut (PR 23, to keep the whole run in its time), each to
# ViL-Small's depth (2 stage-2 and 8 stage-3 blocks) at its own widths and
# windows: ViL-Base-Deep 384² (8 and 24 in the zoo) and ViL-Medium-Deep 384²
# (4 and 16); PR 15's and PR 16's figures at full depth stand in PERF.md
_MEDIUM_DEEP_CUT = "l1,h3,d96,n1,s1,g1,p4,f7_l2,h3,d192,n2,s1,g1,p2,f7_l3,h6,d384,n8,s0,g1,p2,f7_" \
                   "l4,h12,d768,n1,s0,g0,p2,f7"
HIGHRES_ARCH = {"base_deep_384": "l1,h3,d96,n1,s1,g1,p4,f6_l2,h3,d192,n2,s1,g1,p2,f8_"
                                 "l3,h6,d384,n8,s0,g1,p2,f7_l4,h12,d768,n1,s0,g0,p2,f7",
                **dict.fromkeys(("serve_384", "train_384", "serve_384_rpe", "train_384_rpe"),
                                _MEDIUM_DEEP_CUT)}


def run_highres_path(torch, kernels, name: str) -> dict:
    """One high-resolution path of ``HIGHRES`` at full width (the depth of
    ``HIGHRES_ARCH`` where it names the path),
    seeded random weights (``recipe.vil``), bf16 compute: ``REQUESTS``
    serving forwards of uint8 images (bf16 parameters) and/or ``STEPS``
    training steps of the recipe (f32 parameters; ``recipe.train_step``,
    random shift where asked), each then ``PROFILED`` more under
    ``torch.profiler``; the launches of every forward and step held exactly
    (B1 and B3 per sliding-chunk and dense block a forward, B2 and B4 more a
    step; B5, B6 in place of B1, B2 at random shift). Then the f32 pair and
    the bf16 pair, kernels vs plain versions from the same weights, at the
    path's pair batch: logits (serving) to LOGITS_TOL and BF16_LOGITS_TOL,
    one step's loss and every parameter gradient (training) to LOSS_TOL,
    PARAM_GRAD_TOL and BF16_PARAM_GRAD_TOL. With RPE the model has relative
    position bias in every stage (its tables drawn by ``recipe.vil``),
    serves from ``precompute_rpe_cache`` and prints its tables' gradient
    errors apart. Returns the path's launches."""
    from vil_tpu_torch.models import precompute_rpe_cache
    from vil_tpu_torch.ops import flops
    from vil_tpu_torch.tools.profile_step import family, kernel_ms
    from vil_tpu_torch.train import engine, recipe

    arch_name, img, batch, pair, serves, trains, shift, rpe = HIGHRES[name]
    dev = torch.device("cuda")
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    served = torch.randint(0, 256, (batch, img, img, 3), generator=gen, device=dev,
                           dtype=torch.uint8)
    images = torch.randn(batch, img, img, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
    arch = HIGHRES_ARCH.get(name, "")
    macs = flops.model_macs(recipe.vil_cfg(arch_name, img, rpe=rpe, arch=arch).MODEL.VIT.MSVIT.ARCH,
                            img)
    what = (f"{arch_name}{' RPE' if rpe else ''}{' (depth cut)' if arch else ''} {img}^2 bf16 "
            f"batch {batch}")
    phase(name, f"{what}: {macs['gmacs']:.3f} GMACs an image (ops/flops.py), "
                f"{macs['params'] / 1e6:.2f} M parameters")
    want = {fn.__name__: 0 for fn in kernels}

    def measure(label, call, per_call, count):
        """``count`` timed calls, each one's launches held to ``per_call``,
        then PROFILED more under torch.profiler: the walls, the card's time
        and idle share, the top families and the peak memory."""

        def timed():
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
            expect = {k: per_call.get(k, 0) for k in rose}
            if rose != expect:
                raise AssertionError(f"{name} {label} {len(secs)}: launches rose by {rose}, "
                                     f"want {expect}")

        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(count):
            timed()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILED):
                timed()
        for k, v in per_call.items():
            want[k] += v * (count + PROFILED)
        by_name = kernel_ms(prof)
        device = sum(by_name.values()) / PROFILED
        fams = {}
        for kernel, ms in by_name.items():
            fams[family(kernel)] = fams.get(family(kernel), 0.0) + ms / PROFILED
        top = ", ".join(f"{f} {ms:.3f}" for f, ms in sorted(fams.items(), key=lambda kv: -kv[1])[:8])
        med = statistics.median(secs[1:count])  # the first is the warm-up
        phase(name, f"{label}: median {med * 1e3:.3f} ms, {batch / med:.1f} img/s ({label}s "
                    f"2..{count}), first {secs[0] * 1e3:.1f} ms; device {device:.3f} ms a {label} "
                    f"(torch.profiler over {PROFILED} more), idle {100 * (1 - device / med / 1e3):.1f}%;"
                    f" top families (ms) {top}; peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    for fn in kernels:
        fn.launches = 0
    modes0 = None
    if serves:
        model = recipe.vil(arch_name, img, torch.bfloat16, torch.bfloat16, device=dev, arch=arch,
                           rpe=rpe).eval()
        if rpe:
            precompute_rpe_cache(model)
        chunk, dense = block_counts(model)

        def serve():
            with torch.inference_mode():
                logits = model(served)
            if logits.shape != (batch, 1000) or not torch.isfinite(logits).all():
                raise AssertionError(f"{name}: bad logits {tuple(logits.shape)}")

        measure("request", serve, {"vil_attention_fwd": chunk, "full_attention_fwd": dense},
                REQUESTS)
        del model
    if trains:
        model = recipe.vil(arch_name, img, torch.bfloat16, torch.float32, device=dev, rpe=rpe,
                           arch=arch)
        chunk, dense = block_counts(model)
        step = recipe.train_step(model, dev, shift, batch=batch)
        step_gen = torch.Generator(device=dev).manual_seed(3)
        losses, modes = [], []

        def train():
            metrics = step(images, labels, step_gen)
            losses.append(metrics["loss"].item())
            modes.append(metrics.get("modes"))

        pre = "vil_mode_attention" if shift else "vil_attention"
        measure("step", train, {f"{pre}_fwd": chunk, f"{pre}_bwd": chunk,
                                "full_attention_fwd": dense, "full_attention_bwd": dense}, STEPS)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses not finite: {losses}")
        phase(name, f"losses {', '.join(f'{v:.4f}' for v in losses)}"
                    + (f"; per-block modes drawn by the step {modes}" if shift else ""))
        # the recipe's first draw of per-block modes, for the step pairs
        modes0 = engine.sample_vil_modes(torch.Generator().manual_seed(0), model.depth) \
            if shift else None
        del model, step
    launches = launch_counts(kernels)
    phase(name, f"{what}: launches {({k: v for k, v in launches.items() if v})} (want "
                f"{({k: v for k, v in want.items() if v})}, the rest 0)")
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != {want}")
    torch.cuda.empty_cache()

    def build(dtype, param_dtype, use_kernels):
        return recipe.vil(arch_name, img, dtype, param_dtype, use_kernels, dev, rpe=rpe,
                          arch=arch)

    if serves:  # logits, kernels vs plain versions, in f32 then bf16
        x, outs = served[:pair], {}
        with torch.inference_mode():
            for key, dtype, use_kernels in (("kernels", torch.float32, True),
                                            ("plain", torch.float32, False),
                                            ("bf16 kernels", torch.bfloat16, True),
                                            ("bf16 plain", torch.bfloat16, False)):
                m = build(dtype, dtype, use_kernels).eval()
                outs[key] = m(x).float()
                del m
                torch.cuda.empty_cache()
        err = (outs["kernels"] - outs["plain"]).abs().max().item()
        scaled = lambda a, b: ((outs[a] - outs[b]).abs().max() / outs[b].abs().max()).item()
        bf_err, own = scaled("bf16 kernels", "bf16 plain"), scaled("bf16 plain", "plain")
        phase(name, f"batch {pair}: f32 logits, kernels vs plain versions: max|err| {err:.3e} "
                    f"(tol {LOGITS_TOL:g}), |logits| max {outs['plain'].abs().max().item():.3f}; "
                    f"bf16 logits max|err| / max|ref| {bf_err:.3e} (tol {BF16_LOGITS_TOL:g}), "
                    f"plain bf16 vs plain f32 {own:.3e}")
        if not (torch.isfinite(outs["kernels"]).all() and err <= LOGITS_TOL):
            raise AssertionError(f"{name}: f32 logits disagree: {err}")
        if not (torch.isfinite(outs["bf16 kernels"]).all() and bf_err <= BF16_LOGITS_TOL):
            raise AssertionError(f"{name}: bf16 logits disagree: {bf_err}")
        del outs
    if trains:

        def one_step(dtype, use_kernels):
            """One step of the recipe from its weights, the same images,
            draws and (random shift) modes: (loss, parameter gradients)."""
            m = build(dtype, torch.float32, use_kernels)
            s = recipe.train_step(m, dev, shift, batch=batch)
            loss = s(images[:pair], labels[:pair], torch.Generator(device=dev).manual_seed(3),
                     modes=modes0)["loss"].item()
            grads = {n: p.grad.clone() for n, p in m.named_parameters()}
            del m, s
            torch.cuda.empty_cache()
            return loss, grads

        (loss_k, grads_k), (loss_p, grads_p) = (one_step(torch.float32, True),
                                                one_step(torch.float32, False))
        grad_err, worst, _ = f32_grad_errors(grads_k, grads_p)
        if rpe:  # each table's f32 gradient error apart, as phase 12 holds them
            errs = {n: ((grads_k[n] - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
                    for n, r in grads_p.items() if "relative_position" in n}
            top = sorted(errs.items(), key=lambda kv: -kv[1])
            phase(name, f"batch {pair}: f32 step, the {len(errs)} tables' gradients, kernels vs "
                        f"plain versions, max|err| / max|ref| (tol {PARAM_GRAD_TOL:g}), the five "
                        f"largest: " + ", ".join(f"{n} {e:.3e}" for n, e in top[:5]))
        del grads_k
        (bf_loss_k, bf_k), (bf_loss_p, bf_p) = (one_step(torch.bfloat16, True),
                                                one_step(torch.bfloat16, False))
        (bf_err, at), (own, own_at) = bf16_grad_worst(bf_k, bf_p), bf16_grad_worst(bf_p, grads_p)
        phase(name, f"batch {pair}{f', modes {modes0}' if shift else ''}: f32 step, kernels vs "
                    f"plain versions: loss {loss_k:.6f} vs {loss_p:.6f} (|err| "
                    f"{abs(loss_k - loss_p):.3e}, tol {LOSS_TOL:g}); parameter gradients max rel "
                    f"err {grad_err:.3e} at {worst} (tol {PARAM_GRAD_TOL:g}); bf16 step: loss "
                    f"{bf_loss_k:.6f} vs {bf_loss_p:.6f}, gradients max ‖err‖ / ‖ref‖ {bf_err:.3e} "
                    f"at {at} (tol {BF16_PARAM_GRAD_TOL:g}), plain bf16 vs plain f32 {own:.3e} at "
                    f"{own_at}")
        if not (abs(loss_k - loss_p) <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: f32 step disagrees: loss {abs(loss_k - loss_p)}, "
                                 f"gradients {grad_err} at {worst}")
        if not (math.isfinite(bf_loss_k) and bf_err <= BF16_PARAM_GRAD_TOL):
            raise AssertionError(f"{name}: bf16 step disagrees: gradients {bf_err} at {at}")
        del grads_p, bf_k, bf_p
    torch.cuda.empty_cache()
    phase(name, f"the path {time.perf_counter() - t_path:.1f} s")
    return launches


FINETUNE_DIR = os.path.join(REPO, "build", "chip_finetune")
# configs/msvit_384finetune.yaml on ViL-Medium-Wide 384² (its f8/f12
# windows), from a 224² ViL-Medium-Wide .pth: the synthetic set at 384²,
# batch 32 (the yaml's 256, cut): one epoch of 8 steps and its eval; the
# recipe's own QHM, cosine schedule and FINETUNE.USE_TRAIN_AUG False
FINETUNE_ARGS = ["--config-file", os.path.join(REPO, "configs", "msvit_384finetune.yaml"),
                 "--output_dir", FINETUNE_DIR, "--seed", "0",
                 "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                 "DATALOADER.BSZ", "32", "OPTIM.EPOCHS", "1",
                 "MODEL.ARCH", "vil_medium_wide_384", "LOG_FREQ", "1"]


def run_finetune(torch, kernels) -> dict:
    """The 384² fine-tune recipe through ``run_experiment.main(argv)``: a
    seeded ViL-Medium-Wide 224² model saved under the reference's names
    (``torch_import.reference_key``; ``module.`` prefixes under ``net``) as
    a .pth (each tensor moved by seeded noise off its init), loaded by the
    Trainer into ViL-Medium-Wide 384² (MODEL.MODEL_PATH)
    and trained one epoch of 8 steps, then its eval. Every parameter right
    after the load must equal, bit for bit, what ``import_torch_checkpoint``
    gives for the file on the CPU (the x/y position embeddings resized);
    each logged LR must be ``get_lr_schedule``'s at its step; launches equal
    the trainer's counts (``experiment_want``); the f32 eval of the
    checkpoint, kernels vs plain versions, to LOSS_TOL, top1 equal."""
    import shutil

    from vil_tpu_torch.models import build_model
    from vil_tpu_torch.train import recipe, schedulers
    from vil_tpu_torch.train.trainer import Trainer
    from vil_tpu_torch.utils import torch_import

    name = "finetune_384"
    t_path = time.perf_counter()
    shutil.rmtree(FINETUNE_DIR, ignore_errors=True)
    os.makedirs(FINETUNE_DIR)
    pth = os.path.join(FINETUNE_DIR, "vil_medium_wide_224.pth")
    # seeded weights, every tensor moved off its init (zero biases, unit
    # norms) as training would, so that a tensor the load missed shows
    source = recipe.vil("vil_medium_wide", 224, torch.float32, device="cpu")
    noise = torch.Generator().manual_seed(1)
    state = {"module." + torch_import.reference_key(n):
             p.detach() + 0.02 * torch.randn(p.shape, generator=noise)
             for n, p in source.named_parameters()}
    torch.save({"net": state, "epoch": 300}, pth)
    del source
    phase(name, f"{os.path.relpath(pth, REPO)}: {len(state)} tensors of a seeded ViL-Medium-Wide "
                f"224^2 under the reference's names ({time.perf_counter() - t_path:.1f} s)")
    loaded = {}
    init = Trainer.__init__

    def watched_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        loaded["params"] = {n: p.detach().cpu().clone() for n, p in self.model.named_parameters()}

    for fn in kernels:
        fn.launches = 0

    run = lambda label, argv: run_cli(torch, kernels, name, label, argv)

    Trainer.__init__ = watched_init
    try:
        torch.cuda.reset_peak_memory_stats()
        trainer = run("fine-tune epoch", FINETUNE_ARGS + ["MODEL.MODEL_PATH", pth])
    finally:
        Trainer.__init__ = init
    cfg, log = trainer.cfg, trainer.steps_log
    # the load, against the CPU importer on a model built from the same tree
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(cfg.TPU.SEED))
    fresh = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    torch_import.load_into_model(pth, cpu)
    differ = [n for n, p in cpu.named_parameters() if not torch.equal(p, loaded["params"][n])]
    kept = [n for n, p in cpu.named_parameters() if p.numel() and torch.equal(p, fresh[n])]
    resized = {n: f"{tuple(state['module.' + torch_import.reference_key(n)].shape)} -> "
                  f"{tuple(p.shape)}" for n, p in cpu.named_parameters()
               if p.shape != state["module." + torch_import.reference_key(n)].shape}
    phase(name, f"{cfg.MODEL.ARCH} {cfg.INPUT.IMAGE_SIZE}^2 from {os.path.basename(pth)} "
                f"({len(state)} tensors): {len(loaded['params'])} parameters after the load, "
                f"{len(differ)} differ from the CPU importer's bit for bit, {len(kept)} kept "
                f"their init; resized {resized}")
    if differ or kept or not resized:
        raise AssertionError(f"the fine-tune load: differ {differ}, kept {kept}, resized {resized}")
    del cpu, fresh, loaded["params"]
    # the schedule and the run
    schedule = schedulers.get_lr_schedule(cfg)
    wrong = [(r["step"], r["lr"]) for r in log if r["lr"] != schedule(r["step"])]
    batch = statistics.median(r["batch_time"] for r in log[1:])
    data = statistics.median(r["data_time"] for r in log[1:])
    ev = trainer.evals[0]
    lrs = ", ".join(f"{r['lr']:.6g}" for r in log)
    losses = ", ".join(f"{r['loss']:.4f}" for r in log)
    phase(name, f"{len(log)} steps of OPTIM.OPT {cfg.OPTIM.OPT} at LR {lrs} (get_lr_schedule's: "
                f"{'all' if not wrong else wrong}; warm-up {cfg.SOLVER.WARMUP_EPOCHS} epochs of "
                f"{cfg.SOLVER.STEPS_PER_EPOCH} steps); median batch_time {batch * 1e3:.3f} ms, "
                f"data_time {data * 1e3:.3f} ms (steps 2..{len(log)}), "
                f"{cfg.DATALOADER.BSZ / batch:.1f} img/s; losses {losses}; eval top1 "
                f"{ev['top1']:.4f} loss "
                f"{ev['loss']:.6f} over {ev['images']} images; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if wrong or len(log) != 8 or cfg.OPTIM.OPT != "qhm" or cfg.FINETUNE.USE_TRAIN_AUG:
        raise AssertionError(f"the fine-tune run: {len(log)} steps, LR off the schedule at {wrong}")
    del trainer
    # the f32 eval of the checkpoint, kernels vs plain versions
    ckpt = os.path.join(FINETUNE_DIR, "checkpoint_1.ckpt")
    evals = {}
    for key, use_kernels in (("kernels", "True"), ("plain", "False")):
        argv = FINETUNE_ARGS + ["EVALUATE", "True", "MODEL.MODEL_PATH", ckpt,
                                "TPU.COMPUTE_DTYPE", "float32", "TPU.USE_PALLAS", use_kernels]
        argv[argv.index("--output_dir") + 1] = os.path.join(FINETUNE_DIR, f"f32_{key}")
        evals[key] = run(f"EVALUATE f32 {key}", argv).evals[-1]
    f32_k, f32_p = evals["kernels"], evals["plain"]
    err = abs(f32_k["loss"] - f32_p["loss"])
    phase(name, f"f32 eval of checkpoint_1, kernels vs plain versions: loss {f32_k['loss']:.6f} "
                f"vs {f32_p['loss']:.6f} (|err| {err:.3e}, tol {LOSS_TOL:g}); top1 "
                f"{f32_k['top1']} vs {f32_p['top1']}")
    if not (err <= LOSS_TOL and f32_k["top1"] == f32_p["top1"]):
        raise AssertionError(f"f32 eval disagrees: loss {err}, top1 {f32_k['top1']} vs "
                             f"{f32_p['top1']}")
    phase(name, f"the path {time.perf_counter() - t_path:.1f} s")
    return launch_counts(kernels)


def run_highres(torch, kernels) -> dict:
    """Part ``highres``: the paths of ``HIGHRES``, then ``finetune_384``.
    Returns {path: launches}."""
    paths = {name: run_highres_path(torch, kernels, name) for name in HIGHRES}
    paths["finetune_384"] = run_finetune(torch, kernels)
    return paths


# ---------------------------------------------------------------- from_vil_tpu

def _msgpack_head(out: bytearray, n: int, small: int, tiny_limit: int, codes: tuple) -> None:
    """A msgpack length header: ``small | n`` below ``tiny_limit``, else the
    8-, 16- or 32-bit form of ``codes`` (``None`` where there is none)."""
    if n < tiny_limit:
        out.append(small | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += n.to_bytes(2, "big")
    else:
        out.append(codes[2])
        out += n.to_bytes(4, "big")


def _msgpack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out += bytes((fixed[len(data)], code))
    else:
        _msgpack_head(out, len(data), 0, 0, (0xC7, 0xC8, 0xC9))
        out.append(code)
    out += data


def _msgpack_pack(obj, out: bytearray) -> None:
    """Append ``obj`` as ``msgpack.packb(obj, default=flax's ext hook,
    strict_types=True)`` writes it: maps, str, bin, ints, floats, bool,
    nil, lists, and numpy arrays (ext 1) and scalars (ext 3) as flax's
    ``_msgpack_ext_pack`` records them."""
    import struct

    import numpy as np

    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (np.ndarray, np.generic)):  # before float: np.float64 is one
        arr = np.asarray(obj)
        record = bytearray()
        _msgpack_pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], record)
        _msgpack_ext(out, 1 if isinstance(obj, np.ndarray) else 3, bytes(record))
    elif isinstance(obj, dict):
        _msgpack_head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key, val in obj.items():
            _msgpack_pack(key, out)
            _msgpack_pack(val, out)
    elif isinstance(obj, (list, tuple)):
        _msgpack_head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for val in obj:
            _msgpack_pack(val, out)
    elif isinstance(obj, str):
        data = obj.encode()
        _msgpack_head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _msgpack_head(out, len(obj), 0, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, int):
        if 0 <= obj < 128 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < top:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    break
        else:
            for code, fmt, bottom in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                      (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if obj >= bottom:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    break
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    else:
        raise TypeError(f"no msgpack form for {type(obj).__name__}")


def flax_msgpack_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` of a state dict (nested dicts with
    string keys and numpy leaves), byte for byte, without flax or msgpack:
    the card's host has neither (``tests/test_torch_flax_msgpack.py`` holds
    the two equal). The package only reads this format
    (``vil_tpu_torch/utils/flax_msgpack.py``)."""
    out = bytearray()
    _msgpack_pack(tree, out)
    return bytes(out)


FROM_VIL_DIR = os.path.join(REPO, "build", "chip_from_vil_tpu")
# configs/msvit.yaml's recipe at batch 64 on the synthetic set, MODE 0: the
# run whose two steps are written as vil_tpu's state, and its resume
FROM_VIL_ARGS = ["--config-file", os.path.join(REPO, "configs", "msvit.yaml"),
                 "--output_dir", FROM_VIL_DIR, "--seed", "0",
                 "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
                 "DATALOADER.BSZ", str(BATCH), "OPTIM.EPOCHS", "2", "MODEL.VIT.MSVIT.MODE", "0",
                 "LOG_FREQ", "1"]
SOURCE_STEPS = 2  # recipe steps before vil_tpu's state is written
# 1024 JPEGs (2048 up to PR 22): an epoch of 16 steps on the TSV
TSV_IMAGES, TSV_SIZE, BENCH_BATCH = 1024, 256, 256
# 'grain' at 8 workers, the host's cores: the sweep over 0, 4, 8 and 16
# workers (their figures stand in PERF.md) took most of the part's time;
# no threads loader (its rates through the Python and the native reader,
# 295 and 287 img/s in PR 22's run, stand there too)
BENCH_WORKERS = (8,)
BENCH_READERS = ()


def _argv(base: list, out: str, *opts) -> list:
    argv = base + list(opts)
    argv[argv.index("--output_dir") + 1] = out
    return argv


def flax_tree(named: dict) -> dict:
    """Port tensors by name as a flax tree: ``weight`` → ``kernel``
    transposed (Linear, Conv2d) or ``scale`` (LayerNorm), numpy f32, the
    inverse of ``utils.jax_import``'s mapping."""
    import numpy as np

    tree = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight":
            leaf = "scale"
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def write_vil_tpu_dir(out: str, trainer, epoch: int) -> str:
    """``trainer``'s model and AdamW state as ``vil_tpu``'s Checkpointer writes
    them with CKPT_BACKEND 'msgpack': the payload {params, opt_state, buffers,
    step} with the trainer's ``{"inner", "lr_scale"}`` wrapper around
    ``optax.adamw``'s chain (ScaleByAdamState, the masked decay, the
    schedule's count; ``with_wd0``'s masked element in front under WD0), the
    header ``.json`` and the ``last_checkpoint`` tag. Returns the file."""
    import numpy as np
    import torch

    model, optimizer, step = trainer.model, trainer.optimizer, trainer.train_step
    if not isinstance(optimizer, torch.optim.Adam):
        raise AssertionError(f"the recipe's optimizer is {type(optimizer).__name__}")
    params = dict(model.named_parameters())
    state = {n: optimizer.state[p] for n, p in params.items()}
    count = np.array(int(next(iter(state.values()))["step"]), np.int32)
    chain = {"0": {"count": count,
                   "mu": flax_tree({n: st["exp_avg"] for n, st in state.items()}),
                   "nu": flax_tree({n: st["exp_avg_sq"] for n, st in state.items()})},
             "1": {"inner_state": {}}, "2": {"count": np.array(step.step, np.int32)}}
    if trainer.cfg.OPTIM.WD0 > 0:
        chain = {"0": {"inner_state": {}}, "1": chain}
    buffers = dict(model.named_buffers())
    payload = {"params": flax_tree(params),
               "opt_state": {"inner": chain, "lr_scale": np.array(step.lr_scale, np.float32)},
               "buffers": {"buffers": flax_tree(buffers)} if buffers else {},
               "step": np.array(step.step, np.int32)}
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"checkpoint_{epoch}.ckpt")
    with open(path, "wb") as f:
        f.write(flax_msgpack_bytes(payload))
    with open(path + ".json", "w") as f:
        json.dump({"arch": trainer.cfg.MODEL.VIT.MSVIT.ARCH, "epoch": epoch,
                   "best_acc": trainer.best_acc}, f)
    with open(os.path.join(out, "last_checkpoint"), "w") as f:
        f.write(os.path.basename(path))
    return path


def run_from_vil_tpu(torch, kernels) -> dict:
    """Part ``from_vil_tpu`` (phase 20): the entry point fed by what
    ``vil_tpu`` users hold. ViL-Small 224² at full width and depth, batch 64,
    configs/msvit.yaml's recipe at MODE 0:

    (a) a Trainer of the recipe takes SOURCE_STEPS steps; its weights and
        AdamW state are written as ``vil_tpu``'s OUTPUT_DIR (flax msgpack,
        ``write_vil_tpu_dir``) and in the port's format; EVALUATE from each
        file through ``run_experiment.main``: loss and top1 bit for bit
        equal; the load's seconds and the file's size;
    (b) a resume of the ``vil_tpu`` directory for one epoch of 8 steps; its
        first step against the same step of the source Trainer on the same
        batch: loss to LOSS_TOL, every parameter to PARAM_GRAD_TOL of its
        max|ref|;
    (c) a TSV of TSV_IMAGES seeded JPEGs at TSV_SIZE²: ``tools/data_bench``'s
        rates at batch BENCH_BATCH, the native reader asserted in use; one
        MODE-0 epoch of ``run_experiment.main`` on the TSV with
        DATALOADER.BACKEND 'grain' (medians of batch_time and data_time,
        img/s, the card's busy share under ``torch.profiler``);
    (d) the eval transform's batches of the TSV from 'grain' and from
        'threads', bit for bit.

    Every run of the CLI holds its launches to the trainer's counts."""
    import gc
    import shutil

    import numpy as np

    from vil_tpu_torch import run_experiment as cli
    from vil_tpu_torch.data import loader as data_loader
    from vil_tpu_torch.data import native
    from vil_tpu_torch.data.grain_loader import GrainDataLoader
    from vil_tpu_torch.models import build_model
    from vil_tpu_torch.tools import data_bench
    from vil_tpu_torch.train import engine, optim
    from vil_tpu_torch.train.trainer import Trainer
    from vil_tpu_torch.utils.checkpoint import Checkpointer

    name = "from_vil_tpu"
    shutil.rmtree(FROM_VIL_DIR, ignore_errors=True)
    for fn in kernels:
        fn.launches = 0
    run = lambda label, argv: run_cli(torch, kernels, name, label, argv)  # noqa: E731

    # (a) the source: SOURCE_STEPS recipe steps, written in both formats
    source = Trainer(cli.config_from_args(cli.parse_args(_argv(
        FROM_VIL_ARGS, os.path.join(FROM_VIL_DIR, "source")))))
    source.trainloader.sampler.set_epoch(0)
    batches = iter(source.trainloader)
    for _ in range(SOURCE_STEPS):
        images, targets = next(batches)
        source.train_step(source._to_device(images), source._to_device(targets))
    batches.close()
    vil_dir = os.path.join(FROM_VIL_DIR, "vil_tpu_run")
    t0 = time.perf_counter()
    vil_file = write_vil_tpu_dir(vil_dir, source, epoch=1)
    written = time.perf_counter() - t0
    port_file = source.checkpointer.save(1, source.model, source.optimizer,
                                         source.train_step.step, source.train_step.lr_scale)
    size = os.path.getsize(vil_file)
    # the load's time, into a model and optimizer of their own
    probe = build_model(source.cfg, device=source.device)
    probe_opt = optim.get_opt(source.cfg, probe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    header = Checkpointer("", arch=source.cfg.MODEL.VIT.MSVIT.ARCH).load(
        probe, probe_opt, vil_file, resume=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(probe.state_dict().values(),
                                                  source.model.state_dict().values()))
    phase(name, f"vil_tpu's OUTPUT_DIR written: {os.path.relpath(vil_file, REPO)}, "
                f"{size / 2**20:.1f} MiB (params, AdamW mu and nu, step {header['step']}) in "
                f"{written:.2f} s; the port's load of it (model and optimizer, resume) "
                f"{load_s:.3f} s; the weights bit for bit the source's: {same}")
    if not (same and header["step"] == SOURCE_STEPS and header["epoch"] == 1):
        raise AssertionError(f"{name}: the load differs from the source ({header})")
    del probe, probe_opt
    evals = {}
    for label, path in (("the port's file", port_file), ("vil_tpu's file", vil_file)):
        argv = _argv(FROM_VIL_ARGS, os.path.join(FROM_VIL_DIR, f"eval_{len(evals)}"),
                     "EVALUATE", "True", "MODEL.MODEL_PATH", path)
        t0 = time.perf_counter()
        trainer = run(f"EVALUATE from {label}", argv)
        evals[label] = trainer.evals[-1], time.perf_counter() - t0
        del trainer
    (port_eval, port_wall), (vil_eval, vil_wall) = evals.values()
    phase(name, f"EVALUATE from vil_tpu's file: top1 {vil_eval['top1']!r} loss "
                f"{vil_eval['loss']!r} ({vil_wall:.1f} s); from the port's file of the same "
                f"model: top1 {port_eval['top1']!r} loss {port_eval['loss']!r} "
                f"({port_wall:.1f} s)")
    if (vil_eval["top1"], vil_eval["loss"]) != (port_eval["top1"], port_eval["loss"]):
        raise AssertionError(f"{name}: EVALUATE from vil_tpu's file differs")

    # (b) a resume of vil_tpu's directory, its first step against the source's
    first = {}
    call = engine.TrainStep.__call__

    def watched(self, images, targets, *args, **kwargs):
        if first:
            return call(self, images, targets, *args, **kwargs)
        first["batch"] = (images.clone(), targets.clone())
        out = call(self, images, targets, *args, **kwargs)
        first["loss"] = float(out["loss"])
        first["params"] = {n: p.detach().float().clone()
                           for n, p in self.model.named_parameters()}
        return out

    engine.TrainStep.__call__ = watched
    try:
        t0 = time.perf_counter()
        resumed = run("resume of vil_tpu's OUTPUT_DIR", _argv(FROM_VIL_ARGS, vil_dir))
        resume_wall = time.perf_counter() - t0
    finally:
        engine.TrainStep.__call__ = call
    log = resumed.steps_log
    if not (resumed.start_epoch == 1 and log[0]["step"] == SOURCE_STEPS and len(log) == 8):
        raise AssertionError(f"{name}: the resume started at epoch {resumed.start_epoch}, "
                             f"step {log[0]['step']}, {len(log)} steps")
    del resumed
    want = source.train_step(*first["batch"])
    loss_err = abs(first["loss"] - float(want["loss"]))
    worst, worst_name = 0.0, ""
    for n, p in source.model.named_parameters():
        ref = p.detach().float()
        if not ref.numel():
            continue
        err = (first["params"][n] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if err > worst:
            worst, worst_name = err, n
    phase(name, f"resume: {resume_wall:.1f} s for 8 steps, their eval and the best "
                f"checkpoint's eval; its first step (step {SOURCE_STEPS}) against the source's "
                f"on the same batch: loss {first['loss']:.6f} vs {float(want['loss']):.6f} "
                f"(|err| {loss_err:.3e}, tol {LOSS_TOL:g}); parameters max|err|/max|ref| "
                f"{worst:.3e} at {worst_name or '-'} (tol {PARAM_GRAD_TOL:g})")
    if not (loss_err <= LOSS_TOL and worst <= PARAM_GRAD_TOL):
        raise AssertionError(f"{name}: the resumed step differs from the source's")
    del source, first, want
    gc.collect()

    # (c) the TSV: the loader's rates, then one epoch through grain
    root = os.path.join(FROM_VIL_DIR, "tsv")
    t0 = time.perf_counter()
    yaml_path = data_bench.make_tsv(root, TSV_IMAGES, TSV_SIZE, seed=0)
    phase(name, f"TSV of {TSV_IMAGES} JPEGs at {TSV_SIZE}², "
                f"{os.path.getsize(os.path.join(root, 'train.tsv')) / 2**20:.1f} MiB, written in "
                f"{time.perf_counter() - t0:.1f} s")
    data_bench.run(root, TSV_IMAGES, TSV_SIZE, BENCH_BATCH, BENCH_WORKERS, sets=("tsv",),
                   report=lambda line: phase(name, f"data_bench: {line}"),
                   readers=BENCH_READERS)
    reader = data_bench.tsv_dataset(yaml_path, None).img_tsv
    reader.seek(0)
    if native.get_lib() is None or not isinstance(reader._native, native.NativeRowReader):
        raise AssertionError(f"{name}: the native TSV reader is not in use")
    phase(name, f"native reader in use: {os.path.relpath(str(native.library_path()), REPO)}")
    tsv_args = ["DATA.TRAIN", f"('{yaml_path}',)", "DATA.TEST", f"('{yaml_path}',)",
                "OPTIM.EPOCHS", "1", "DATALOADER.BACKEND", "grain"]
    steps = TSV_IMAGES // BATCH
    with ProfiledSteps(torch, 2, steps - 1) as profiled:
        t0 = time.perf_counter()
        tsv_run = run("one epoch on the TSV through grain",
                      _argv(FROM_VIL_ARGS, os.path.join(FROM_VIL_DIR, "tsv_run"), *tsv_args))
        tsv_wall = time.perf_counter() - t0
    if not isinstance(tsv_run.trainloader, GrainDataLoader):
        raise AssertionError(f"{name}: the TSV run did not load through grain")
    rows = tsv_run.steps_log
    batch_time = statistics.median(r["batch_time"] for r in rows[1:])
    data_time = statistics.median(r["data_time"] for r in rows[1:])
    workers = tsv_run.cfg.DATALOADER.WORKERS
    phase(name, f"TSV epoch through grain ({workers} workers, {len(rows)} steps, "
                f"{tsv_wall:.1f} s with its evals): median batch_time {batch_time * 1e3:.3f} ms, "
                f"data_time {data_time * 1e3:.3f} ms (steps 2..{len(rows)}), "
                f"{BATCH / batch_time:.1f} img/s; first batch's data_time "
                f"{rows[0]['data_time'] * 1e3:.1f} ms (the workers' start); steps 2..{steps} "
                f"under torch.profiler (the card's activity): wall {profiled.wall:.3f} s, device "
                f"{profiled.device:.3f} s ({profiled.device * 1e3 / (steps - 1):.3f} ms a step), "
                f"busy {100 * profiled.device / profiled.wall:.1f}%")
    if len(rows) != steps or not profiled.wall:
        raise AssertionError(f"{name}: {len(rows)} steps on the TSV, want {steps}")
    del tsv_run
    gc.collect()

    # (d) the eval transform's batches, grain against threads
    cfg = cli.config_from_args(cli.parse_args(_argv(
        FROM_VIL_ARGS, os.path.join(FROM_VIL_DIR, "tsv_eval"), *tsv_args)))
    cfg.defrost()
    got = {}
    for backend in ("grain", "threads"):
        cfg.DATALOADER.BACKEND = backend
        got[backend] = list(data_loader.make_epoch_data_loader(cfg, is_train=False,
                                                               drop_last=False)[0])
    same = len(got["grain"]) == len(got["threads"]) == TSV_IMAGES // BATCH and all(
        np.array_equal(a, b) for ga, gb in zip(got["grain"], got["threads"])
        for a, b in zip(ga, gb))
    phase(name, f"eval batches of the TSV, grain vs threads ({cfg.DATALOADER.WORKERS} each): "
                f"{len(got['grain'])} batches, dtype {got['grain'][0][0].dtype}, equal bit "
                f"for bit: {same}")
    if not same:
        raise AssertionError(f"{name}: grain's eval batches differ from the threads loader's")
    del got
    gc.collect()
    return launch_counts(kernels)


# the parts ``--only`` picks from: phase 3, then the main paths in run order
def run_self_chunk(torch, kernels, records):
    """Part self_chunk: the self-only (mode -1) instances of B5/B6 against
    their plain versions (phase 3's self cases, ``check_kernels(...,
    self_only=True)``), then ViL-Small 224² (bf16 compute, f32 parameters,
    batch 64) served at mode -1 (STEPS forwards: the self-only forward 3 and
    B3 9 a forward) and trained at mode -1 (STEPS steps: the self-only pair 3
    each, B3, B4 9 a step; B1, B2, B5, B6 none); then the f32 and bf16
    logits and one step's gradients, kernels vs plain versions from the same
    weights, images and generator."""
    from vil_tpu_torch.train import recipe

    name = "self_chunk"
    check_kernels(torch, records, self_only=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    per_forward = {fn.__name__: 0 for fn in kernels}
    per_forward.update(vil_self_attention_fwd=3, full_attention_fwd=9)
    per_step = dict(per_forward, vil_self_attention_bwd=3, full_attention_bwd=9)
    model = recipe.vil_small(torch.bfloat16, torch.float32, device=dev)
    step = recipe.train_step(model, dev)

    def serve():
        with torch.inference_mode():
            out = model.eval()(images, mode=-1)
        if out.shape != (BATCH, 1000) or not torch.isfinite(out).all():
            raise AssertionError(f"mode -1 logits bad: {tuple(out.shape)}")

    losses = []
    train = lambda: losses.append(step(images, labels, torch.Generator(device=dev).manual_seed(3),
                                       modes=-1)["loss"].item())
    for fn in kernels:
        fn.launches = 0
    medians = []
    for want, run in ((per_forward, serve), (per_step, train)):
        secs = []
        for i in range(STEPS):
            before = launch_counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
            if rose != want:
                raise AssertionError(f"mode -1 run {i}: launches rose by {rose}, want {want}")
        medians.append(statistics.median(secs[1:]))
    launches = launch_counts(kernels)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mode -1 losses not finite: {losses}")
    phase(name, f"ViL-Small 224^2 at mode -1, bf16 compute, f32 parameters, batch {BATCH}: "
                f"{STEPS} forwards, median {medians[0] * 1e3:.3f} ms ({BATCH / medians[0]:.1f} "
                f"img/s); {STEPS} steps, median {medians[1] * 1e3:.3f} ms "
                f"({BATCH / medians[1]:.1f} img/s), losses "
                f"{', '.join(f'{v:.4f}' for v in losses)}; launches {launches} "
                f"({ {k: v for k, v in per_step.items() if v} } a step)")
    del model, step

    def pair(dtype, use_kernels):
        """Logits and one step's (loss, gradients) at mode -1 from the
        recipe's weights."""
        m = recipe.vil_small(dtype, torch.float32, use_kernels, dev)
        with torch.inference_mode():
            logits = m.eval()(images, mode=-1).float()
        s = recipe.train_step(m, dev)
        loss = s(images, labels, torch.Generator(device=dev).manual_seed(3),
                 modes=-1)["loss"].item()
        return logits, loss, {n: p.grad.clone() for n, p in m.named_parameters()}

    (lg_k, loss_k, grads_k), (lg_p, loss_p, grads_p) = (pair(torch.float32, True),
                                                         pair(torch.float32, False))
    lg_err, loss_err = (lg_k - lg_p).abs().max().item(), abs(loss_k - loss_p)
    grad_err, worst, _ = f32_grad_errors(grads_k, grads_p)
    phase(name, f"f32 at mode -1, kernels vs plain versions: logits max|err| {lg_err:.3e} (tol "
                f"{LOGITS_TOL:g}); step loss |err| {loss_err:.3e} (tol {LOSS_TOL:g}); "
                f"parameter gradients max rel err {grad_err:.3e} at {worst} (tol "
                f"{PARAM_GRAD_TOL:g})")
    if not (lg_err <= LOGITS_TOL and loss_err <= LOSS_TOL and grad_err <= PARAM_GRAD_TOL):
        raise AssertionError(f"mode -1 f32 disagrees: logits {lg_err}, loss {loss_err}, "
                             f"gradients {grad_err}")
    (bl_k, bf_loss_k, bf_k), (bl_p, _, bf_p) = (pair(torch.bfloat16, True),
                                                pair(torch.bfloat16, False))
    lg_err = ((bl_k - bl_p).abs().max() / bl_p.abs().max()).item()
    err, at = bf16_grad_worst(bf_k, bf_p)
    own, own_at = bf16_grad_worst(bf_p, grads_p)
    phase(name, f"bf16 at mode -1, kernels vs plain versions: logits max|err| / max|ref| "
                f"{lg_err:.3e} (tol {BF16_LOGITS_TOL:g}); step gradients max ‖err‖ / ‖ref‖ "
                f"{err:.3e} at {at} (tol {BF16_PARAM_GRAD_TOL:g}); plain bf16 vs plain f32 "
                f"{own:.3e} at {own_at}")
    if not (math.isfinite(bf_loss_k) and lg_err <= BF16_LOGITS_TOL
            and err <= BF16_PARAM_GRAD_TOL):
        raise AssertionError(f"mode -1 bf16 disagrees: logits {lg_err}, gradients {err}")
    return launches


# part train_remat: (zoo name, image size, batch): ViL-Small 224²
# (ViL-Medium-Deep 384² is left out: REMAT at high resolution runs in the
# part spatial_options, at ViL-Small 1024²)
REMAT_MODELS = (("vil_small", 224, BATCH),)
REMAT_STEPS = 3  # steps of each REMAT setting; the first is held, the others timed


def run_train_remat(torch, kernels):
    """Part train_remat: the recipe's bf16 step of each of REMAT_MODELS at
    batch 64 under TPU.REMAT '', 'minimal' and 'full', each from the same weights, images and generator: the first
    step's gradients against the '' step's (BF16_PARAM_GRAD_TOL on
    ‖err‖ / ‖ref‖, and whether they are equal bit for bit), the median wall
    of the later steps, one more step's card time under torch.profiler, the
    peak memory, and the launches a step: the forward kernels (B1, B3) once
    more under a REMAT, their recompute in the backward."""
    from vil_tpu_torch.train import recipe

    name = "train_remat"
    dev = torch.device("cuda")
    for fn in kernels:
        fn.launches = 0
    for arch, img, batch in REMAT_MODELS:
        gen = torch.Generator(device=dev).manual_seed(6)
        images = torch.randn(batch, img, img, 3, generator=gen, device=dev)
        labels = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
        ref = None
        for remat in ("", "minimal", "full"):
            model = recipe.vil(arch, img, torch.bfloat16, torch.float32, device=dev, remat=remat)
            chunk, dense = block_counts(model)
            again = 2 if remat else 1
            want = {fn.__name__: 0 for fn in kernels}
            want.update(vil_attention_fwd=again * chunk, vil_attention_bwd=chunk,
                        full_attention_fwd=again * dense, full_attention_bwd=dense)
            step = recipe.train_step(model, dev, batch=batch)
            run = lambda: step(images, labels, torch.Generator(device=dev).manual_seed(3))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            secs = []
            for i in range(REMAT_STEPS):
                before = launch_counts(kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = run()["loss"].item()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                rose = {k: v - before[k] for k, v in launch_counts(kernels).items()}
                if rose != want or not math.isfinite(loss):
                    raise AssertionError(f"{arch} {img}^2 REMAT {remat!r} step {i}: launches "
                                         f"{rose} (want {want}), loss {loss}")
                if i == 0:
                    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            device, _ = step_device_ms(torch, run)
            med = statistics.median(secs[1:])
            held = ""
            if ref is None:
                ref = grads
            else:
                err, at = bf16_grad_worst(grads, ref)
                same = all(torch.equal(grads[n], ref[n]) for n in ref)
                held = (f"; first step's gradients against REMAT '' max ‖err‖ / ‖ref‖ "
                        f"{err:.3e} at {at} (tol {BF16_PARAM_GRAD_TOL:g}), bit for bit {same}")
                if not err <= BF16_PARAM_GRAD_TOL:
                    raise AssertionError(f"{arch} REMAT {remat!r} gradients disagree: {err}")
            phase(name, f"{arch} {img}^2 batch {batch}, REMAT {remat!r}: step median "
                        f"{med * 1e3:.3f} ms ({batch / med:.1f} img/s, steps 2..{REMAT_STEPS}), "
                        f"device {device:.3f} ms, peak memory {peak:.2f} GiB; launches a "
                        f"step { {k: v for k, v in want.items() if v} }{held}")
            del model, step, grads
            torch.cuda.empty_cache()
        del ref
    return launch_counts(kernels)


RESNET_DIR = os.path.join(REPO, "build", "chip_resnet")
# the CLI on ResNet-50: configs/msvit.yaml's recipe (AdamW, mixup, label
# smoothing) with MODEL.ARCH resnet50 on the synthetic set, the data
# pipeline's own draws off (no flip, crop or erasing), so that a resumed run
# sees what an uninterrupted one sees
RESNET_ARGS = ["--config-file", os.path.join(REPO, "configs", "msvit.yaml"),
               "--output_dir", RESNET_DIR, "--seed", "0", "MODEL.ARCH", "resnet50",
               "DATA.TRAIN", "('synthetic',)", "DATA.TEST", "('synthetic',)",
               "DATALOADER.BSZ", str(BATCH), "LOG_FREQ", "1",
               "AUG.TIMM_AUG.USE_TRANSFORM", "True", "AUG.TIMM_AUG.HFLIP", "0.0",
               "AUG.TIMM_AUG.VFLIP", "0.0", "AUG.TIMM_AUG.AUTO_AUGMENT", "",
               "AUG.TIMM_AUG.RE_PROB", "0.0", "AUG.SCALE", "(1.0, 1.0)", "AUG.RATIO",
               "(1.0, 1.0)"]
RESNET_HOST_BATCH = 2  # images of the card-vs-CPU comparison


def run_resnet(torch, kernels):
    """Part resnet: ResNet-50 224² (``build_model``, MODEL.ARCH resnet50,
    bf16 compute over f32 parameters, channels-last, its convolutions by
    cuDNN) served (REQUESTS forwards of uint8 images, batch 64) and trained
    (STEPS steps of AdamW, batch 64), peak memory; then in f32 (no TF32) the
    card's eval logits, one training step's loss, gradients and running
    statistics against the CPU's from the same weights and images
    (RESNET_HOST_BATCH images), the gradients held to twice the CPU's own
    f32 error against its f64 step (f32 sums over a channel's terms, which
    cancel at random weights, leave both a few percent of a BatchNorm
    gradient's norm); then ``run_experiment.main`` with MODEL.ARCH
    resnet50: one epoch of 8 steps and its eval, a resume of it to two
    epochs, and an uninterrupted run of two epochs that the cut and resumed
    one equals (cuDNN deterministic for these runs). No kernel of the port
    runs on this path."""
    import shutil

    from vil_tpu_torch.config import get_default_cfg
    from vil_tpu_torch.models import build_model
    from vil_tpu_torch.train import engine, loss, optim

    name = "resnet"
    dev = torch.device("cuda")
    for fn in kernels:
        fn.launches = 0

    def cfg_of(dtype):
        cfg = get_default_cfg()
        cfg.merge_from_list(["MODEL.ARCH", "resnet50", "DATA.NUM_CLASSES", "1000",
                             "TPU.COMPUTE_DTYPE", dtype, "OPTIM.OPT", "adamw", "OPTIM.LR",
                             "1e-3", "OPTIM.WD", "0.05"])
        return cfg

    cfg = cfg_of("bfloat16")
    gen = torch.Generator(device=dev).manual_seed(7)
    uint8 = torch.randint(0, 256, (BATCH, 224, 224, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    images = torch.randn(BATCH, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    step = engine.make_train_step(model, loss.cross_entropy, optim.get_opt(cfg, model),
                                  device=dev, seed=0)
    torch.cuda.reset_peak_memory_stats()
    serve_secs, step_secs, losses = [], [], []
    for i in range(REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model.eval()(uint8)
        torch.cuda.synchronize()
        serve_secs.append(time.perf_counter() - t0)
        if out.dtype != torch.float32 or out.shape != (BATCH, 1000) or \
                not torch.isfinite(out).all():
            raise AssertionError(f"resnet50 logits bad: {out.dtype} {tuple(out.shape)}")
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    stats0 = model.bn1.running_var.clone()
    for i in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(images, labels)["loss"].item())
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t0)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    device, _ = step_device_ms(torch, lambda: step(images, labels))
    serve, train = statistics.median(serve_secs[1:]), statistics.median(step_secs[1:])
    moved = not torch.equal(stats0, model.bn1.running_var)
    phase(name, f"ResNet-50 224^2 bf16 compute, f32 parameters, batch {BATCH}: serve median "
                f"{serve * 1e3:.3f} ms ({BATCH / serve:.1f} img/s, requests 2..{REQUESTS}), "
                f"peak {serve_peak:.2f} GiB; train median {train * 1e3:.3f} ms "
                f"({BATCH / train:.1f} img/s, steps 2..{STEPS}), device {device:.3f} ms a "
                f"step, peak {train_peak:.2f} GiB; losses "
                f"{', '.join(f'{v:.4f}' for v in losses)}; running statistics updated {moved}")
    if not (all(math.isfinite(v) for v in losses) and moved):
        raise AssertionError(f"resnet50 steps: losses {losses}, statistics moved {moved}")
    del model, step

    # the card's f32 against the CPU's, same weights and images
    n = RESNET_HOST_BATCH
    x_host, y_host = images[:n].cpu(), labels[:n].cpu()
    runs = {}
    for key, where, dtype in (("card", dev, torch.float32), ("cpu", "cpu", torch.float32),
                              ("cpu f64", "cpu", torch.float64)):
        m = build_model(cfg_of("float32"), device=where, dtype=dtype, param_dtype=dtype,
                        generator=torch.Generator().manual_seed(0))
        x = x_host.to(where, dtype)
        with torch.inference_mode():
            served = m.eval()(x).cpu().double()
        lo = loss.cross_entropy(m.train()(x), y_host.to(where))
        lo.backward()
        runs[key] = (served, lo.item(),
                     {k: p.grad.cpu().double() for k, p in m.named_parameters()},
                     {k: b.cpu().double() for k, b in m.named_buffers()})
        del m
    exact = runs["cpu f64"]

    def worst(key):
        grads = runs[key][2]
        errs = {k: ((grads[k] - r).norm() / r.norm()).item() for k, r in exact[2].items()
                if r.norm() > 0}
        at = max(errs, key=errs.get)
        return errs[at], at

    lg_err = (runs["card"][0] - runs["cpu"][0]).abs().max().item()
    loss_err = abs(runs["card"][1] - runs["cpu"][1])
    stat_err = max((runs["card"][3][k] - v).abs().max().item() for k, v in runs["cpu"][3].items())
    (card_err, card_at), (cpu_err, cpu_at) = worst("card"), worst("cpu")
    grad_tol = 2 * cpu_err + 1e-5
    phase(name, f"f32 card vs CPU (batch {n}, cuDNN TF32 {torch.backends.cudnn.allow_tf32}): "
                f"eval logits max|err| {lg_err:.3e} (tol {LOGITS_TOL:g}); training loss |err| "
                f"{loss_err:.3e} (tol {LOSS_TOL:g}); running statistics max|err| {stat_err:.3e} "
                f"(tol {LOSS_TOL:g}); gradients against the CPU's f64 step, max ‖err‖ / ‖ref‖: "
                f"card f32 {card_err:.3e} at {card_at}, CPU f32 {cpu_err:.3e} at {cpu_at} (tol "
                f"{grad_tol:.3e}: twice the CPU's)")
    if not (lg_err <= LOGITS_TOL and loss_err <= LOSS_TOL and stat_err <= LOSS_TOL
            and card_err <= grad_tol):
        raise AssertionError(f"resnet50 f32 card vs CPU disagrees: logits {lg_err}, loss "
                             f"{loss_err}, statistics {stat_err}, gradients {card_err}")

    # the entry point: one epoch and its eval, its resume to two, and an
    # uninterrupted run of two
    shutil.rmtree(RESNET_DIR, ignore_errors=True)
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def cli(label, out, epochs):
        argv = list(RESNET_ARGS) + ["OPTIM.EPOCHS", str(epochs)]
        argv[argv.index("--output_dir") + 1] = out
        return run_cli(torch, kernels, name, label, argv)

    try:
        cut = cli("one epoch", os.path.join(RESNET_DIR, "cut"), 1)
        resumed = cli("resume to two epochs", os.path.join(RESNET_DIR, "cut"), 2)
        whole = cli("two epochs uninterrupted", os.path.join(RESNET_DIR, "whole"), 2)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    got = [r["loss"] for r in cut.steps_log + resumed.steps_log]
    want = [r["loss"] for r in whole.steps_log]
    err = max((abs(a - b) for a, b in zip(got, want)), default=math.inf)
    batch_time = statistics.median(r["batch_time"] for r in cut.steps_log[1:])
    phase(name, f"run_experiment MODEL.ARCH resnet50: epoch 0, {len(cut.steps_log)} steps "
                f"(median batch_time {batch_time * 1e3:.3f} ms, {BATCH / batch_time:.1f} img/s), "
                f"its eval top1 {cut.evals[0]['top1']:.4f}; the resume started at epoch "
                f"{resumed.start_epoch}, step {resumed.steps_log[0]['step']}; the 16 losses "
                f"against the uninterrupted run's: max|err| {err:.3e} (tol {LOSS_TOL:g}), equal "
                f"bit for bit {got == want}; evals after epoch 1 top1 "
                f"{resumed.evals[0]['top1']:.4f} and {whole.evals[1]['top1']:.4f}")
    if not (len(got) == len(want) == 16 and err <= LOSS_TOL and resumed.start_epoch == 1
            and resumed.steps_log[0]["step"] == 8 and cut.evals):
        raise AssertionError(f"resnet50 resume differs from the uninterrupted run: {err}")
    return launch_counts(kernels)


PARTS = ("kernels", "serve", "train", "shift", "serve_fused", "train_fused", "serve_spatial",
         "probe", "serve_rpe", "train_rpe", "shift_rpe", "train_fused_rpe", "experiment",
         "efficient", "highres", "train_spatial", "experiment_spatial", "train_tp", "train_fsdp",
         "experiment_tp", "from_vil_tpu", "train_drop", "self_chunk", "train_remat", "resnet",
         "shift_spatial", "self_spatial", "experiment_spatial_shift", "spatial_options",
         "train_spatial_tp", "train_spatial_fsdp", "resnet_spatial")


def only_arg(argv) -> "set | None":
    """``--only a,b``: run the build and those parts alone, to read their
    checks; they pass or fail as in the whole run, which alone prints the
    records and the result line. None (no argument): every part."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only" or not set(argv[1].split(",")) <= set(PARTS):
        raise SystemExit(f"usage: chip_smoke.py [--only part,...], parts {', '.join(PARTS)}")
    return set(argv[1].split(","))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    only = only_arg(sys.argv[1:])
    sys.path.insert(0, REPO)
    from vil_tpu_torch.ops.kernels import KERNELS, build
    from vil_tpu_torch.tools import layout_probe

    kernels = (*KERNELS, *layout_probe.KERNELS)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", f"{kind} x{torch.cuda.device_count()}; torch {torch.__version__}, "
                    f"CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    phase("build", f"{os.path.relpath(lib_path, REPO)} from vil_tpu_torch/csrc "
                   f"(nvcc {' '.join(build.NVCC_FLAGS[:2])}, one process per source) in "
                   f"{time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        kernel = ""
        for line in log.read_text().splitlines():
            if "Function properties for" in line:
                kernel = line.split("Function properties for", 1)[1].strip()
            if "spill" in line and not line.strip().startswith("0 bytes stack"):
                phase("build", f"{kernel}: {line.strip()}")
    # the dense kernels' and the sliding-chunk forwards' and backwards'
    # instructions: the bf16 ones on the tensor cores (HGMMA) with their
    # tiles by cp.async (LDGSTS), at each of the five head dims the dense
    # forward, B1, B7a, B5, B9a's attention, and both passes of each
    # backward (B9b's attention too), and B9a's two and B9b's three products
    # at each of their four widths (1-4 64-column sub-tiles); each with its
    # registers
    from vil_tpu_torch.tools import sass_census

    t_census = time.perf_counter()
    every = sass_census.census("")  # one disassembly of the library (~30 s), every kernel
    for match, want in (("full_attention", 15), ("vil_attention_fwd", 5),
                        ("vil_attention_bwd", 10), ("vil_attention_halo_fwd", 5),
                        ("vil_attention_halo_bwd", 10), ("vil_mode_attention_fwd", 10),
                        ("vil_mode_attention_bwd", 20), ("vil_block_fwd", 13),
                        ("vil_block_bwd", 22), ("vil_mode_attention_halo_fwd", 5),
                        ("vil_mode_attention_halo_bwd", 10)):
        census = {name: counts for name, counts in every.items() if match in name}
        for name, counts in sorted(census.items()):
            phase("build", f"SASS {name}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
            if "wgmma" in name and not (counts["HGMMA"] and counts["LDGSTS"]):
                raise AssertionError(f"{name}: no wgmma or no cp.async in its SASS: {counts}")
        if sum("wgmma" in name for name in census) < want:
            raise AssertionError(f"{match}: fewer than {want} wgmma kernels: {sorted(census)}")
    phase("build", f"SASS census in {time.perf_counter() - t_census:.1f} s")

    sources = {
        "vil_attention_fwd": ("vil_tpu_torch/csrc/vil_attention_fwd.cu",
                              "vil_tpu/ops/pallas/vil_kernel.py:1086"),
        "vil_attention_bwd": ("vil_tpu_torch/csrc/vil_attention_bwd.cu",
                              "vil_tpu/ops/pallas/vil_backward.py:1576"),
        "full_attention_fwd": ("vil_tpu_torch/csrc/full_attention_fwd.cu",
                               "vil_tpu/ops/pallas/full_attention.py:127"),
        "full_attention_bwd": ("vil_tpu_torch/csrc/full_attention_bwd.cu",
                               "vil_tpu/ops/pallas/full_attention.py:664"),
        "vil_mode_attention_fwd": ("vil_tpu_torch/csrc/vil_mode_attention_fwd.cu",
                                   "vil_tpu/ops/pallas/vil_mode_kernel.py:559"),
        "vil_mode_attention_bwd": ("vil_tpu_torch/csrc/vil_mode_attention_bwd.cu",
                                   "vil_tpu/ops/pallas/vil_mode_kernel.py:678"),
        "layer_norm_fwd": ("vil_tpu_torch/csrc/layer_norm.cu",
                           "vil_tpu/ops/pallas/layer_norm.py:108"),
        "layer_norm_bwd": ("vil_tpu_torch/csrc/layer_norm.cu",
                           "vil_tpu/ops/pallas/layer_norm.py:135"),
        "vil_block_fwd": ("vil_tpu_torch/csrc/vil_block_fwd.cu",
                          "vil_tpu/ops/pallas/vil_block.py:512"),
        "vil_block_bwd": ("vil_tpu_torch/csrc/vil_block_bwd.cu",
                          "vil_tpu/ops/pallas/vil_block.py:603"),
        "vil_attention_halo_fwd": ("vil_tpu_torch/csrc/vil_attention_halo_fwd.cu",
                                   "vil_tpu/ops/pallas/vil_kernel.py:821"),
        "vil_attention_halo_bwd": ("vil_tpu_torch/csrc/vil_attention_halo_bwd.cu",
                                   "vil_tpu/ops/pallas/vil_backward.py:757"),
        # mode -1: no Pallas kernel in vil_tpu, which runs its XLA tier there
        "vil_self_attention_fwd": ("vil_tpu_torch/csrc/vil_mode_attention_fwd.cu",
                                   "vil_tpu/models/attention.py:768"),
        "vil_self_attention_bwd": ("vil_tpu_torch/csrc/vil_mode_attention_bwd.cu",
                                   "vil_tpu/models/attention.py:768"),
        # random shift under the split: the mode kernels as vil_tpu runs them
        # on a shard, after neighborhood_spatial's gather
        "vil_mode_attention_halo_fwd": ("vil_tpu_torch/csrc/vil_mode_attention_halo_fwd.cu",
                                        "vil_tpu/ops/pallas/vil_mode_kernel.py:665"),
        "vil_mode_attention_halo_bwd": ("vil_tpu_torch/csrc/vil_mode_attention_halo_bwd.cu",
                                        "vil_tpu/ops/pallas/vil_mode_kernel.py:786"),
        "consume_base": ("vil_tpu_torch/csrc/layout_probe.cu", "tools/layout_probe.py:36"),
        "consume_perm": ("vil_tpu_torch/csrc/layout_probe.cu", "tools/layout_probe.py:48"),
    }
    records = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": "", "library_ms": None,
                      "_bytes_ms": 0.0, "_ops_ms": 0.0}
               for name, (src, rep) in sources.items()}
    # the main paths, each with its launch counts (serve_spatial's run also
    # gives the spatial_bwd path's)
    runs = {
        "serve": lambda: run_serve(torch, kernels),
        "train": lambda: run_train(torch, kernels),
        "shift": lambda: run_train(torch, kernels, random_shift=True),
        "serve_fused": lambda: run_serve(torch, kernels, fused=True),
        "train_fused": lambda: run_train(torch, kernels, fused=True),
        "serve_spatial": lambda: run_serve_spatial(torch, kernels),
        "probe": lambda: run_probe(torch, kernels),
        # ViL-Small RPE: the biased paths
        "serve_rpe": lambda: run_serve(torch, kernels, rpe=True),
        "train_rpe": lambda: run_train(torch, kernels, rpe=True),
        "shift_rpe": lambda: run_train(torch, kernels, random_shift=True, rpe=True),
        "train_fused_rpe": lambda: run_train(torch, kernels, fused=True, rpe=True),
        # the entry point users run: config, data pipeline, trainer, checkpoints
        "experiment": lambda: run_experiment_path(torch, kernels),
        # the paper's other attention families, a path each, and the
        # performer through the entry point
        "efficient": lambda: run_efficient(torch, kernels),
        # high resolution: ViL-Medium-Deep 384², ViL-Small 1024², the _384
        # windows and the 384² fine-tune recipe
        "highres": lambda: run_highres(torch, kernels),
        # training over a ('data', 'spatial') mesh: ViL-Small 1024²'s step on
        # a group of one card (and on two, where there are), then the entry
        # point on the mesh
        "train_spatial": lambda: run_train_spatial(torch, kernels),
        "experiment_spatial": lambda: run_experiment_spatial(torch, kernels),
        # parameter sharding: tensor parallelism over heads (3 ranks, MODE 0
        # and random shift), FSDP over 2 ranks, both through the entry point
        "train_tp": lambda: run_train_tp(torch, kernels),
        "train_fsdp": lambda: run_train_fsdp(torch, kernels),
        "experiment_tp": lambda: run_experiment_tp(torch, kernels),
        # what vil_tpu's users hold: its checkpoints (eval, resume) and a TSV
        # set through the native reader and the grain loader's processes
        "from_vil_tpu": lambda: run_from_vil_tpu(torch, kernels),
        # the rest of vil_tpu's build_model: dropout, the self chunk alone
        # (mode -1: the self-only instances of B5/B6), TPU.REMAT and the
        # ResNet zoo
        "train_drop": lambda: run_train(torch, kernels, drop=0.1),
        "self_chunk": lambda: run_self_chunk(torch, kernels, records),
        "train_remat": lambda: run_train_remat(torch, kernels),
        "resnet": lambda: run_resnet(torch, kernels),
        # random shift and mode -1 under the split: shift_1024's step on the
        # one-card mesh (B5h/B6h), ViL-Small 224² at mode -1 on it, and the
        # entry point's random-shift epoch on it
        "shift_spatial": lambda: run_shift_spatial(torch, kernels),
        "self_spatial": lambda: run_self_spatial(torch, kernels),
        "experiment_spatial_shift": lambda: run_experiment_spatial_shift(torch, kernels),
        # TPU.REMAT and MODEL.VIT.DROP on the split: train_spatial's step at
        # each REMAT and at DROP 0.1 on the one-card mesh (the REMAT, DROP
        # and ResNet paths of 'tp' and 'fsdp' run in the parts train_tp and
        # train_fsdp)
        "spatial_options": lambda: run_spatial_options(torch, kernels),
        # heads and rows split at once: train_spatial's step under 'tp' on a
        # (1, 2, 3) ('data', 'spatial', 'model') mesh and under 'fsdp' on a
        # (2, 2) ('data', 'spatial') mesh, the entry point on the second
        "train_spatial_tp": lambda: run_split_sharded(torch, kernels, "train_spatial_tp"),
        "train_spatial_fsdp": lambda: run_split_sharded(torch, kernels, "train_spatial_fsdp"),
        # a ResNet on a spatial axis: ResNet-50 1024² on a (1, 2) ('data',
        # 'spatial') mesh, halo convolutions and pooling, BatchNorm and the
        # pool summed over the two ranks
        "resnet_spatial": lambda: run_resnet_spatial(torch, kernels),
    }
    if only is None or "kernels" in only:
        t_part = time.perf_counter()
        check_kernels(torch, records)
        phase("kernels", f"phase 3 in {time.perf_counter() - t_part:.1f} s")
    paths = {}
    for name, run in runs.items():
        if only is not None and name not in only:
            continue
        t_part = time.perf_counter()
        if name == "serve_spatial":
            paths["serve_spatial"], paths["spatial_bwd"] = run()
        elif name in ("efficient", "highres", "train_tp", "train_fsdp", "experiment_tp",
                      "spatial_options", "train_spatial_tp", "train_spatial_fsdp",
                      "resnet_spatial"):
            paths.update(run())
        else:
            paths[name] = run()
        phase(name, f"part {name} in {time.perf_counter() - t_part:.1f} s")
    if only is not None:
        phase("done", f"part of the run ({', '.join(sorted(only))}): every check passed; "
                      f"no record and no result line")
        return 0
    for name, rec in records.items():
        rec["launches"] = sum(counts[name] for counts in paths.values())
        for path, counts in paths.items():
            rec[f"launches_{path}"] = counts[name]
        rec["bound_by"] = "bytes" if rec.pop("_bytes_ms") >= rec.pop("_ops_ms") else "operations"
        per_path = ", ".join(f"{path} {counts[name]}" for path, counts in paths.items())
        phase("record", f"{name}: {rec['ms']:.3f} ms per step of its path (plain "
                        f"{rec['plain_ms']:.3f}, bound {rec['bound_ms']:.4f} by {rec['bound_by']}, "
                        f"library {rec['library_ms']}), launches {rec['launches']} ({per_path})")
    idle = [name for name, rec in records.items() if not rec["launches"]]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")

    print(card, flush=True)
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
