#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``biscuit_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --unit-bwd-passes [--root CHECKOUT]
    python3 chip_smoke.py --preprocess [--root CHECKOUT]
    python3 chip_smoke.py --slide
    python3 chip_smoke.py --serve
    python3 chip_smoke.py --stats | --pretrained | --resnet
    python3 chip_smoke.py --int8 | --parallel | --lockstep
    python3 chip_smoke.py --bn-train

The second form only profiles the unit backward pass by pass at
UNIT_PASS_GEOMETRIES (one line a geometry), the third only times the
preprocess kernel (row 1) and one request's preprocess stage, and the
kernel at PREPROCESS_VARIANTS too where the checkout's plan takes a
cluster size (one line); both import ``biscuit_torch`` from CHECKOUT when given (to
time another checkout's kernels in the same call). The fourth builds and
runs phase slide alone (one line), the fifth phase serve alone (a line an
artifact, then the phase's), the sixth phase stats, pretrained or resnet
alone (one line), the seventh phase int8, parallel or lockstep alone
(one line), the eighth builds ``csrc/bn_train.cu`` alone (its ptxas
entries on the build line) and prints its two kernel rows. The first
form runs
these phases, each printing one JSON line:

1. env: torch/CUDA versions and ``nvidia-smi`` name and power limit (also
   printed raw on a line of its own); TF32 off for the f32 comparisons.
2. build: every kernel of the main path built from ``biscuit_torch/csrc``,
   and the native data plane from ``csrc/native`` at the same time;
   ptxas: the registers, spills and shared memory of the sepconv GEMM
   (``csrc/sepconv_gemm.cuh``) in the two sources that run it (the middle
   flow and fused block rows add the GEMM's plan: column tile, cluster
   size, stages, dynamic shared memory, registers), of the unit
   backward's GEMMs and depthwise pass, and of each instantiation of the
   MC head's pass kernel (``pass_kernel<SEG, CP>``).
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (256 tiles of 299 px, K=30), with its error and
   tolerance, its median time over fresh inputs (CUDA events), the plain
   version's time, a library yardstick's time where one exists, and its
   bound (the larger of bytes / HBM rate and operations / peak rate).
   The preprocess row repeats its output bit for bit and adds its
   kernel's device time (``device_ms``, torch.profiler) and its launch
   plan (cluster size, pixels a CTA, threads, shared memory, grid, and
   the clusters the card holds at once). The MC head is held at
   HEAD_CLASSES (2, 33 and 128, padded to 16, 64 and 128; the published
   head's numbers at the top level, each count's under ``by_classes``,
   with the module head's time, ``module_ms``, beside the others); at
   each it repeats one seed bit for bit, shows its two device
   kernels in a ``profile`` (torch.profiler device time by kernel), as
   the middle flow (with its GEMM and depthwise time a unit,
   ``unit_ms``, and the byte floor of its two-pass design) and the fused
   block and depthwise rows do per geometry, and gives its host
   time a call (``host_us``, 50 calls enqueued without a synchronize).
   The two unit-backward kernels are held at the 147x147 64->128 and the
   19x19 728->728 geometries at batch 128, their weights laid out as the
   training path passes them; their ms, plain ms, library ms and bound
   are the two geometries' added; each repeats its outputs bit for bit,
   and its profile must hold only UNIT_BWD_KERNELS (so that the train
   phase's ``unit_bwd_kernels_ms`` covers the unit backward); each
   geometry adds its ``group_route``: the kernel's two entries of a
   lockstep group (``unit_bwd_sums``, then the backward from the sums) at
   one rank, equal to the one call bit for bit, and their time; then at
   two ranks, each half of the batch (the second's gy and p shifted by 1,
   so that a half's own sums are far from the batch's) fed the two
   halves' summed sums and the batch's pixel count, against the plain
   version of that half with
   the same sums and against the plain version on the whole batch, at
   the row's tolerances (``two_halves_rel_err``). The fused strided block
   is held at the four serving geometries (entry0 147^2 64->128, entry1
   74^2 128->256, entry2 37^2 256->728, exit 19^2 728->728->1024) at 256
   tiles, its library yardstick the port's eval-mode ``XceptionBlock``;
   the depthwise 3x3 at 147^2 x 128 and 19^2 x 728 in bf16, with its
   gradients held against autograd of its plain version; each row adds
   its geometries. The train-mode BatchNorm op (``ops/bn_train.py``)
   gives rows ``bn_train_fwd`` (its sums and forward apply) and
   ``bn_train_bwd`` (the backward's) at BN_GEOMETRIES, batch 128, bf16:
   the apply passes bit for bit against their plain versions from the
   kernel's sums, the sums within 2e-5 of their terms' magnitudes and
   repeated bit for bit, each geometry's roofline share and profile,
   ``F.batch_norm(training=True)`` and its backward as the library
   yardstick. Every training phase holds its launches to
   ``train_launches``: 40 ``bn_train_fwd`` and 6 ``bn_train_bwd`` an
   Xception step, 53 and 53 a ResNet-50 one (whose phase also counts the
   BatchNorm inputs that are not channels-last). Rows 1, 2 and 4 add ``by_dtype.float32``: the same
   shapes with f32 out (row 1, within PREPROCESS_F32_TOL of the plain f32
   chain) or f32 x (row 2 within MIDDLE_F32_TOL of its largest value,
   which x rounded to bf16 and the output rounded to bf16 must miss; row
   4 at its bf16 bound, and its residual alone, BN1's scale and shift
   zero, within RESIDUAL_F32_TOL of its largest value, which x rounded
   to bf16 must miss), each repeated bit
   for bit, with its time, the plain version's, the library's (row 2
   cuDNN and torch.matmul in f32, row 4 the f32 XceptionBlock) and its
   bound with 4-byte activations; the top-level numbers stay bf16's.
4. main: ``UncertaintyInterface`` at the published width (Xception-299,
   2x1024 head, dropout 0.1, K=30) with seeded random weights answers R
   requests of 256 uint8 tiles; the launch counts are zeroed just before
   and read just after; the outputs are checked, and at dropout 0 the
   kernel path is held against the plain versions on the same model.
   main_fused_blocks: the same with ``fuse_blocks=True`` (the fully fused
   trunk, 4 fused-block launches a request), its features held against
   the plain-version composition and against phase main's composition.
   main_f32: hp.nature2022 with ``compute_dtype="float32"`` (seeded
   random weights, its logits spread over request 0's features) answers
   the same R requests, default trunk then ``fuse_blocks=True``: rows 1-3
   once a request, row 4 four times with ``fuse_blocks``; the kernels'
   f32 features on request 0 within 3e-2 of ``model.features`` (the f32
   module trunk, TF32 off), the dropout-0 means within 2e-2 of the plain
   head on those (spread > 0.2); tiles/s and ``stage_ms`` beside the
   bf16 phases' tiles/s.
   main_wide_head: one request through the same model with a 33-class
   head (``WIDE_HEAD_CLASSES``), which launches rows 1-3 once; its mean
   rows sum to 1, and its dropout-0 head is held against the plain
   version on its features.
   predict: main-path steps 1-6 from disk. PREDICT_TILES smooth random
   299-px tiles for each of the PREDICT_LABELS slides, written as PNGs
   (filter 0, ``encode_png``) into tfrecords by the port's writer
   (seconds and bytes printed), then ``score_tiles`` over them (hp with
   uq=True, K=30), with the default trunk and with ``fuse_blocks=True``:
   one warm-up call each, then a timed one with the launch counts zeroed
   just before and read just after (rows 1-3 once a batch, row 4 four
   times a batch with ``fuse_blocks``); the rows (order, slides,
   locations, labels) and outputs checked; the pooled features of each
   batch the path gives the kernels (128, 128 and 44 real rows) held
   against the plain versions for both trunks; and, with the logits
   layer set so the probabilities spread over the tiles
   (``decisive_logits_``: a random head gives every tile about 0.5), the
   dropout-0 means of both trunks against the plain-version path (the
   f32 preprocess of float tiles, library convs, the module head).
   It prints tiles/s from disk, the batcher's read + decode seconds
   alone, after the warm-up (the decoded tiles must equal the written
   ones bit for bit), the device time of the same batches (CUDA events
   around the interface calls) and the PNG decode time by row filter,
   of ``data/png.py`` and of Pillow.
   evaluate: where pandas is installed, ``evaluate_project`` over those
   tfrecords in a Project built in a temporary directory, its four
   files checked, then ``threshold.apply`` on its tile frame at the
   median uncertainty; where it is not, one line saying so.
   int8: the opt-in w8a8 trunk (``ops/int8_trunk.py``) on phase main's
   model, its logits spread over request 0's features
   (``decisive_logits_``), with ``int8_trunk=True`` and a
   ``calibration_path``: the calibration request (request 0, 256 tiles:
   rows 1 and 3 once, row 2 twice, the answer's and the calibrator's f32
   forward's; equal bit for bit to the bf16 interface's answer), then
   REQUESTS int8 requests (rows 1-3 once each) timed beside the bf16
   default's in the same call, each stage's device time (preprocess,
   trunk, head) and peak memory, and the device time by kernel of one
   int8 request; on request 1 (not calibrated on) the pooled features'
   cosine against the bf16 trunk (> 0.98) and the dropout-0 means within
   INT8_MEAN_TOL of the bf16 path's (spread > 0.2); a second interface
   from the saved scales serving int8 from its first request, equal to
   the first bit for bit; with ``BISCUIT_INT8_MIDDLE=1`` a calibration
   request and REQUESTS int8 requests with no row-2 launch; and
   ``torch._int_mm`` (cuBLASLt) at INT8_MM_SHAPES equal to the f64
   product, timed beside a bf16 matmul of the same shape.
   parallel: two processes (this script with ``--parallel-child``, each
   bounded by CHILD_TIMEOUT_S and killed at it) share the card and meet
   through a ``TCPStore`` on localhost (``parallel/distributed.py``).
   ``predict_tfrecords_distributed`` of phase predict's 300 tiles,
   written as PAR_TFRECORDS tfrecords, through a kernels servable of
   hp.nature2022 at batch PAR_BATCH: each process's merged frame equals
   the single-process call's bit for bit (each tfrecord in its own
   batches at the same seeds), its rows those of ``predict_tfrecords``
   over the whole list, rows 1-3 once a tfrecord in all; then
   ``Experiment.run`` of ZD's step 2 with ``n_submeshes=1`` in each
   process over a project of PAR_SLIDES slides: the 3 folds, PAR_STEPS
   steps each, claimed through the store, each trained once (34 strip
   launches a step in all); then ``load_sharded_servable`` over this
   process's cards, equal to ``Servable`` at the shard's seed bit for
   bit. It prints each stage's seconds and each process's.
   lockstep: lockstep data parallelism (``parallel/lockstep.py``) with
   LS_RANKS processes (this script with ``--lockstep-child``, each
   bounded by CHILD_TIMEOUT_S) sharing the card over gloo, the kernels
   built before they start. First LS_STEPS fused-trunk steps of
   hp.nature2022 ('xyrjb', dropout 0.1) on seeded weights at a global
   batch of LS_BATCH, as one process here and as the group (each rank on
   its rows, kernel row 6 on its two-entry route): step 1's loss within
   LS_LOSS_RTOL of one process's, the ranks' weights bit-identical after
   the steps (SHA-256), 34 strip launches a step a rank; it prints s/step
   and tiles/s of both (steps 2 on), and the collectives and bytes a step
   of a rank with the host seconds spent in them (``collective_s``; the
   gradient bucket's share ``bucket_s``). Then one step with augmentation
   and dropout off, against one process's (``step1_distance``): every
   BatchNorm's batch statistics within LS_STAT_LIMIT, and the gradients
   within LS_GRAD_RATIO times the noise floor (relative L2), the floor
   being one process's own gradient on the batch with its rows
   reversed; a control, the same step with the BN collectives off (each
   half of the batch as one process, the gradients averaged), must fail
   both gates. Then, over a mesh that spans the processes, one
   ``train_project``
   fold of LS_TP_STEPS steps on phase train_project's project (the model
   dir checked by ``check_model_dir``; rows 1-3 once, on main) and
   ``Experiment.run``'s step 2 of ZD (3 folds of LS_TP_STEPS steps, each
   trained once by the group).
   depthwise_entry: one forward and backward through
   ``depthwise_conv3x3``, the standalone op's own entry point.
5. train: ``make_train_step`` of ``hp.nature2022`` (Xception-299 bf16,
   2x1024 head, dropout 0.1, Adam 1e-4 with the 0.98/512 decay, 'xyrjb',
   batch 128) on seeded random weights: one warm-up step, then counted
   steps with the launch counts zeroed just before and read just after
   (34 strip-kernel unit backwards per step); one step with the plane
   kernel, counted on its own; and at batch 32, augment off and dropout
   0, the gradients of one kernel step held against one plain-version
   step from the same weights and batch.
   train_project: ``Project.train`` of the same hp with uq=True at K,
   early stopping on, 3-fold, on TP_SLIDES slides of TP_TILES smooth PNG
   tiles written by the port's writer (labels 0/1 paired in 3 sites):
   TP_STEPS steps an epoch over TP_EPOCHS, a one-batch validation check
   and an in-run checkpoint every TP_STEPS steps, the epoch models
   saved; each fold with its launch counts zeroed just before and read
   just after (34 strip launches a step, rows 1-3 once a validation
   batch of each recorded epoch) and its model dir checked; an epoch
   model, loaded by ``UncertaintyInterface`` and rescored, against its
   CSV; fold 1 relaunched without its results log and newest
   checkpoint (it resumes and records epoch 2). It prints the seconds a
   fold (the first apart), ``train_log.csv``'s rows, the host's read +
   decode of a fold's training batches against the step's device time
   on the same batches, and the seconds of an in-run and an epoch save.
   experiment: where pandas and scipy are installed,
   ``Experiment.run`` of ZD (5 slides a class) with the default hp
   ("nature2022", Xception-299, K=30) over a training project of
   EX_TRAIN and an evaluation project of EX_EVAL slides of EX_TILES
   smooth PNG tiles: steps 2, 3, 5 and 6 (3 CV folds, 3 UQ CV folds, the
   FULL model, its evaluation), each step timed, with the launch counts
   zeroed just before the first and read just after the last (34 strip
   launches a training step, rows 1-3 once a batch of UQ validation or
   evaluation tiles); every model dir, experiments.csv, the eval dir, a
   rerun that trains nothing, and ``results``' rows and AUCs checked;
   where they are not, one line saying so. No figure is drawn.
   slide: whole slides on the card. The native data plane
   (``data/native_loader.py``, built with g++ beside the kernels in phase
   build, which prints its capabilities and which libtiff it found) writes
   SLIDE_COUNT synthetic H&E-like slides of SLIDE_PX square (tissue on
   about half, 19 x 19 positions at 302 um and 1 mpp) as JPEG tiled TIFFs;
   ``WSI`` must open them through ``TiledTiff``. hp.nature2022 with uq at
   K, seeded LeCun weights and ``decisive_logits_`` over slide 0's tissue
   tiles, saved as model dirs at dropout 0.1 and 0. Then, each with its
   launch counts zeroed just before and read just after: ``Heatmap`` of
   each slide with Otsu QC (rows 1-3 once a batch of 64; the -99 cells
   the QC mask; host tile reads and scoring timed apart); the dropout-0
   ``Heatmap`` held against the plain path (2e-2, probabilities spread
   > 0.2); ``export_tiles_by_uncertainty`` at the heatmap's median
   uncertainty (every tissue tile exported once, each on its side of the
   threshold); ``Project.extract_tiles`` of both slides, the tfrecords
   read by ``TileBatcher`` with and without ``use_native`` (bit for bit),
   the read + decode per tile by Pillow, the native reader on 1 and on
   every core, and Pillow in a thread pool of 1 and every core, and the
   tiles scored from the native batches at dropout 0 (rows 1-3 once a
   batch; within 2e-2 of the heatmap's cells); ``score_gan_tiles`` of
   GAN_TILES 512-px crops (rows 2-3 once a batch of 64, row 1 never; the
   card's resize within 1e-3 of the CPU's); ``generate_features`` of
   MOSAIC_TILES tiles a slide (no launch), the slide map and a 10 x 10
   mosaic.
   serve: servables (``serve.py``, ``torch.export``) of hp.nature2022 at
   K, seeded LeCun weights, ``decisive_logits_`` over the tissue tiles of
   a SERVE_SLIDE_PX slide, saved at dropout 0.1 and 0: four artifacts at
   batch TILES, each exported, loaded and timed over SERVE_REQUESTS
   requests (a line each: export s, bytes, load s, tiles/s, host s a
   request to the call's return): (a) the kernels' ops, default trunk,
   with the feature program; (b) the kernels with ``fuse_blocks=True``;
   (a0) as (a) from the dropout-0 save; (c) portable, exported on the
   CPU and moved to the card, from the dropout-0 save. The live
   ``UncertaintyInterface`` (both trunks) answers the same requests at
   the same seeds beside them; (a) and (b) must equal it bit for bit,
   repeat a seed and differ between two seeds; launches zeroed before
   and read after each request (rows 1-3 once, row 4 four times in (b),
   none in (c)); at dropout 0 (c) within 2e-2 of (a0) on the tissue
   tiles (spread > 0.2); ``predict_tfrecords`` over phase predict's
   tiles, written again (rows 1-3 once a batch; columns, rows, labels);
   ``Heatmap`` of the slide from (a0) within 2e-2 of the model dir's;
   the device time by kernel of one request of (a), (b) and the live
   interface (``kernel_profile``);
   ``generate_features`` from (a) (rows 1-3 once a batch). Phases main
   and main_fused_blocks time a kernel's call through its registered op
   against its wrapper (``op_dispatch``).
   stats: the device statistics backend (``ops/threshold_device.py``) on
   synthetic CV frames from ``stats_frame`` (f32 columns, slides of about
   STATS_TILES tiles, scores on a 1/1024 grid so exact Youden ties occur):
   ``detect`` with ``backend="host"`` and ``"device"`` at STATS_ROWS rows
   (one warm-up each, then the median of 3; the host once at 4e6 rows),
   ``tile_pred``/``tile_uq`` equal to the host's, the rest within 1e-6,
   no HostFallback, the group table repeated bit for bit; ``from_cv``
   over 3 folds and ``apply(level="patient")`` on an external frame of
   STATS_CV_ROWS rows through both; no kernel launch. It prints each
   size's seconds, their ratio and bytes each way, and the crossover.
   pretrained: the Keras import at full width. Phase main's seeded model
   at dropout 0, its logits spread (``decisive_logits_``), written as a
   Keras full-model ``.npz`` (``keras_export``: the inverse of
   ``models/pretrained.keras_layer_map`` plus the head's Dense layers),
   imported by ``python -m biscuit_torch.cli.import_model`` into a model
   dir whose arrays must equal the source's (a BN variance within one
   f32 ulp); ``UncertaintyInterface`` over it answers REQUESTS requests
   (rows 1-3 once each), its means within 2e-2 of the source model's at
   the same seeds (spread > 0.2); the trunk staged as
   ``xception_imagenet.npz`` under a temporary
   ``BISCUIT_PRETRAINED_DIR`` with ``hp.pretrained="imagenet"``:
   ``init_model`` grafts it (the trunk equals the file, the head the
   fresh init), then 2 training steps at TRAIN_BATCH (34 row-6 launches
   a step).
   resnet: ``hp.model="resnet50"`` (299 px, 2x1024 head, dropout 0.1,
   K) with seeded random weights: ``UncertaintyInterface`` answers
   REQUESTS requests (rows 1 and 3 once each, nothing else), tiles/s and
   ``stage_ms`` (preprocess, trunk, head); the pooled features within
   3e-2 of the plain composition (the preprocess's plain version, the
   f32 module trunk); the dropout-0 means within 2e-2 of
   ``use_kernel=False`` (spread > 0.2); ``export_servable`` of its model
   dir, loaded and called once, equal bit for bit to the live interface
   (rows 1 and 3 once); 2 training steps at TRAIN_BATCH on the module
   path (no launch), tiles/s and peak memory. No MFU: ``models/flops.py``
   counts Xception only.
6. the kernels line (launches: the serving phases for kernels 1-4, the
   depthwise entry phase, the training phase, with phases main_f32's,
   int8's,
   parallel's, lockstep's, train_project's, experiment's, slide's,
   serve's, pretrained's and resnet's added to kernels 1-4 and 6); 7. the
   last
   line
   ``{"ok": true, "device": ...}``.

Any failed check raises, so the script exits non-zero and prints no last
line. It needs one CUDA card; without one it exits 1 at once.
"""

from __future__ import annotations

import importlib.util
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

TILES = 256           # tiles per request
TILE_PX = 299
K = 30
SEED = 0              # weights, tiles and kernel inputs
REQUESTS = 3          # counted requests on the main path
N_TIMED = 11          # timed runs per kernel, each on fresh inputs
N_PLAIN = 3           # timed runs of the plain versions
TRAIN_BATCH = 128     # hp.nature2022's batch size
TRAIN_STEPS = 5       # counted training steps
CHECK_BATCH = 32      # batch of the kernel-vs-plain gradient check
UNITS_PER_STEP = 34   # sep+BN units of Xception: 6 entry, 24 middle, 4 exit
# Train-mode BatchNorms a step through ops/bn_train, forward and back:
# Xception's 34 units forward (their backward is the unit kernel's) and
# its 2 stem and 4 residual BatchNorms both ways; ResNet-50's 53.
BN_TRAIN_A_STEP = {"xception": (40, 6), "resnet50": (53, 53)}
# (H = W, C) of the BatchNorm kernel rows, batch TRAIN_BATCH: Xception's
# largest (entry0's units), a middle-flow unit, ResNet-50's stage 0.
BN_GEOMETRIES = ((147, 128), (19, 728), (75, 256))
# (H = W, CI, CO, relu_first) of the unit-backward kernel rows: entry0's
# first unit and a middle-flow unit.
UNIT_GEOMETRIES = ((147, 64, 128, False), (19, 728, 728, True))
SERVING = ("fused_preprocess", "fused_middle_flow", "mcd_head")
BLOCKS_PER_REQUEST = 4     # entry0-2 and the exit block, with fuse_blocks
HEAD_DEVICE_KERNELS = 2    # mcd_head: layer 1, then the pass kernel
# Class counts of kernel row 3: the published head; a tissue-of-origin
# head over TCGA's 33 tumour types, which phase main_wide_head also
# serves; the widest head the kernel takes.
HEAD_CLASSES = (2, 33, 128)
WIDE_HEAD_CLASSES = 33
# (H = W, Cin, F0, F1, relu_first) of the strided blocks on the serving
# path at 299 px: entry0, entry1 (the even-size pool), entry2, exit.
BLOCK_GEOMETRIES = ((147, 64, 128, 128, False), (74, 128, 256, 256, True),
                    (37, 256, 728, 728, True), (19, 728, 728, 1024, True))
# (H = W, C) of the depthwise 3x3 rows: entry0's second conv and the
# middle flow's.
DW_GEOMETRIES = ((147, 128), (19, 728))
# The device kernels of csrc/fused_unit_bwd.cu, by what the profiler's
# names hold: its two GEMMs are instantiations of sepconv_gemm.cuh's
# sepconv_gemm_kernel, told apart from the serving path's by their A
# loaders, UbDgradA and UbWgradA.
UNIT_BWD_KERNELS = ("ub_bn_sums_kernel", "ub_bn_finalize_kernel",
                    "UbDgradA", "UbWgradA", "ub_dw_bwd_kernel",
                    "ub_reduce_kernel")
# (H = W, CI, CO, relu_first) of the per-pass profile of the unit
# backward (``--unit-bwd-passes``): UNIT_GEOMETRIES, entry2's first unit
# and the exit tail's last, whose bound is operations.
UNIT_PASS_GEOMETRIES = UNIT_GEOMETRIES + ((37, 256, 728, True),
                                          (10, 1536, 2048, True))
# Launches of the preprocess kernel timed side by side (``--preprocess``),
# (cluster size, threads a CTA): 8 CTAs of 134 KB, one an SM, and 16 of
# 67 KB, three an SM, at three thread counts.
PREPROCESS_VARIANTS = ((8, 1024), (16, 192), (16, 256), (16, 320))
# Row 1 with f32 out against the plain f32 chain: the kernel's approximate
# base-2 logarithms and exponentials (about 1e-7 relative) and its sums in
# another order, with no bf16 rounding after them.
PREPROCESS_F32_TOL = 1e-3
# Row 2 with f32 x against its plain version, as a share of the largest
# value: a flipped bf16 rounding of one GEMM input moves an output by
# about ulp(a)·|pw| (~2e-5 at the serving width), and 3e-4 leaves room
# for dozens of them in one value; x read as bf16 (2**-9 relative,
# carried to the output by block 0's residual) or the output stored as
# bf16 lands at about 2e-3 to 3e-3, and both must miss it.
MIDDLE_F32_TOL = 3e-4
# Row 4 with f32 x, the residual alone (BN1's scale and shift zero, so y1
# and the pool are exact zeros) against the plain version's f32 product:
# the kernel's two-term bf16 split of x is 2**-16 relative, x rounded to
# bf16 within 2**-8, about 1e-3 of the residual's largest value.
RESIDUAL_F32_TOL = 1e-4
# Phase predict: the labels of the slides written to tfrecords, and the
# tiles a slide (300 tiles: batches of 128, 128 and 44 real rows).
PREDICT_LABELS = (0, 1, 0)
PREDICT_TILES = 100
OUTCOME = "cohort"
# Phase train_project: 6 slides (labels 0/1 paired in 3 sites) of 64
# tiles, 3 folds of 2 epochs of TP_STEPS steps, a validation check and an
# in-run checkpoint every TP_STEPS steps (at each epoch's end).
TP_SLIDES = 6
TP_TILES = 64
TP_STEPS = 5
TP_EPOCHS = (1, 2)
TP_FOLDS = 3
# Phase experiment: Experiment.run of ZD (5 slides a class) over a
# training project of EX_TRAIN slides (two a site) and an evaluation
# project of EX_EVAL, EX_TILES tiles a slide, steps EX_STEPS.
EX_TRAIN = 10
EX_EVAL = 4
EX_TILES = 32
EX_STEPS = (2, 3, 5, 6)
# Phase slide: SLIDE_COUNT synthetic H&E-like slides of SLIDE_PX square at
# the default 1 mpp (19 x 19 grid positions at 302 um), written as JPEG
# tiled TIFFs of SLIDE_TIFF_TILE tiles; GAN_TILES 512-px GAN tiles; the
# mosaic over MOSAIC_TILES extracted tiles a slide.
SLIDE_COUNT = 2
SLIDE_PX = 6000
SLIDE_TIFF_TILE = 256
GAN_TILES = 128
GAN_PX = 512
MOSAIC_TILES = 100
SERVE_REQUESTS = 3    # counted requests a servable, and of the live paths
SERVE_SLIDE_PX = 3000  # phase serve's slide: 9 x 9 positions at 302 um
# Phase stats: detect at STATS_ROWS rows (STATS_CV_ROWS is a published
# nested-CV fold, biscuit_tpu/threshold.py:30-32), slides of about
# STATS_TILES tiles; from_cv over 3 folds and apply on an external frame
# of STATS_CV_ROWS rows.
STATS_ROWS = (100_000, 400_000, 1_000_000, 4_000_000)
STATS_CV_ROWS = 400_000
STATS_TILES = 1300
INT8_MM_SHAPES = ((TILES * 74 * 74, 128, 256), (TILES * 19 * 19, 728, 728),
                  (TILES * 10 * 10, 1536, 2048))
INT8_MEAN_TOL = 0.05     # tests/test_int8_trunk.py's bound against f32
PAR_TFRECORDS = 6        # phase predict's 300 tiles, 50 a tfrecord
PAR_BATCH = 64           # the parallel phase's servable batch
PAR_STEPS = 2            # training steps a fold, cross-process scheduling
PAR_SLIDES = 10
PAR_TILES = 32
CHILD_TIMEOUT_S = 300

# Phase lockstep.
LS_BATCH = 128           # the group's batch: hp.nature2022's, 64 a rank
LS_RANKS = 2             # processes sharing the card
LS_STEPS = 4             # steps of the step comparison: 1 checked, 3 timed
LS_LOSS_RTOL = 1e-3      # step-1 loss, two ranks against one process
# Step 1 with augment and dropout off, against one process, two gates,
# each set between the sound runs and a control that must fail it (the
# same step with the BN collectives off; PERF.md, phase lockstep). Every
# BatchNorm's batch statistics within LS_STAT_LIMIT of its largest value
# (measured: rows reversed 2.6e-3, the group 2.8e-3, the control 3.0e-2).
# The gradients' relative L2 over the model within LS_GRAD_RATIO times
# the noise floor, one process against itself on the batch with its rows
# reversed: the bf16 backward at random weights is a third noise, so a
# reordering alone moves it 0.341 (the group 1.017x that, the control
# 1.345x).
LS_STAT_LIMIT = 1e-2
LS_GRAD_RATIO = 1.15
LS_TP_STEPS = 2          # train_project fold and each Experiment.run fold



def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, inputs, warmup: int = 2):
    """Median per-call time in ms: calls enqueued back to back, one CUDA
    event between consecutive calls, each call on its own input."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(inputs) + 1)]
    events[0].record()
    for i, inp in enumerate(inputs):
        fn(inp)
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(
        events[i].elapsed_time(events[i + 1]) for i in range(len(inputs)))


def bound_ms(n_bytes: float, ops: dict):
    """(bound in ms, 'bytes' or 'operations'): the larger of the HBM time
    and the slowest unit's operation time at the published peaks."""
    from biscuit_torch.models.flops import (
        H100_HBM_BYTES_PER_S,
        H100_PEAK_BF16,
        H100_PEAK_F32,
    )

    peak = {"bf16": H100_PEAK_BF16, "f32": H100_PEAK_F32}
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = max(v / peak[kind] for kind, v in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PLAN_KEYS = ("tile_n", "cluster", "stages", "smem_bytes", "registers",
             "local_bytes", "resident_blocks")


def gemm_plans(source: str, *shape) -> list:
    """The plans of csrc/sepconv_gemm.cuh's GEMMs that the kernel of
    ``source`` runs at ``shape`` (its launcher's arguments): column tile,
    cluster size, ring stages, dynamic shared memory, and
    registers and local bytes a thread as the runtime reports them, and
    the blocks resident at once (the persistent grid)."""
    import ctypes

    from biscuit_torch.ops import _build

    k = len(PLAN_KEYS)
    n = k if source == "fused_middle_flow" else 3 * k
    out = (ctypes.c_int * n)()
    fn = _build.bound(source, f"{source}_gemm_plan",
                      [ctypes.c_int] * len(shape)
                      + [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(*shape, out), source)
    return [dict(zip(PLAN_KEYS, out[i:i + k])) for i in range(0, n, k)]


def ptxas_entries(log: str, names) -> list:
    """ptxas's registers, spills and shared memory for each compiled entry
    function whose (mangled) name holds one of ``names``."""
    out, keep = [], False
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            keep = any(n in m.group(1) for n in names)
            if keep:
                out.append({"function": m.group(1), "info": []})
        elif keep and ("registers" in ln or "spill" in ln or "smem" in ln):
            out[-1]["info"].append(ln.split(":", 1)[-1].strip())
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def train_launches(steps: int, arch: str = "xception",
                   unit_bwd: str = "unit_bwd_strips") -> dict:
    """The kernel launches of ``steps`` training steps of ``arch`` at
    full width: Xception's unit backwards on ``unit_bwd``, and each
    network's train-mode BatchNorms through ops/bn_train."""
    fwd, bwd = BN_TRAIN_A_STEP[arch]
    want = {"bn_train_fwd": fwd * steps, "bn_train_bwd": bwd * steps}
    if arch == "xception":
        want[unit_bwd] = UNITS_PER_STEP * steps
    return want


def encode_png(img, filters=0) -> bytes:
    """An 8-bit PNG of a (H, W), (H, W, 1-4) uint8 image, with ``filters``
    the row filter of every row (0-4) or of each row (a sequence of H):
    the tiles of phase predict, and test input for ``data/png.py``."""
    import struct
    import zlib

    import numpy as np

    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    kinds = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    rows = (x - preds[kinds, np.arange(h)]) & 0xFF
    data = np.concatenate([kinds[:, None], rows.reshape(h, -1)], axis=1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(data.astype(np.uint8).tobytes()))
            + chunk(b"IEND", b""))


def preprocess_device_ms(torch, run, calls: int) -> float:
    """Device time a call of the preprocess kernel (torch.profiler), over
    ``calls`` calls made by ``run``: every device kernel whose name holds
    "preprocess", so that it reads another checkout's kernel too."""
    prof = kernel_profile(torch, run, top=20)
    return sum(r["ms"] for r in prof["top"]
               if "preprocess" in r["kernel"]) / calls


def preprocess_plan(plan) -> dict:
    """A launch plan of the preprocess kernel, and how many of its
    clusters the card holds at once."""
    from biscuit_torch.ops.fused_preprocess import max_active_clusters

    return {"cluster": plan.cluster, "chunk": plan.chunk,
            "threads": plan.threads, "smem_bytes": plan.smem,
            "grid": plan.grid, "max_active_clusters": max_active_clusters(plan)}


def kernel_preprocess(torch, gen):
    from biscuit_torch.data.normalize import ReinhardFastNormalizer
    from biscuit_torch.ops.fused_preprocess import (
        fused_preprocess,
        fused_preprocess_reference,
        launch_plan,
    )

    norm = ReinhardFastNormalizer()
    shape = (TILES, TILE_PX, TILE_PX, 3)
    xs = [torch.randint(0, 256, shape, generator=gen, device="cuda",
                        dtype=torch.uint8) for _ in range(N_TIMED)]
    got = fused_preprocess(xs[0], norm).float()
    ref = fused_preprocess_reference(xs[0], norm, torch.float32)
    err = (got - ref).abs().max().item()
    tol = 2e-2   # bf16 output: half an ulp is 2**-7 at |x| in [2, 4)
    check(err <= tol, f"fused_preprocess: max abs err {err} > {tol}")
    del got, ref
    again = fused_preprocess(xs[0], norm)
    check(torch.equal(again, fused_preprocess(xs[0], norm)),
          "fused_preprocess: the same tiles repeat bit for bit")
    del again
    ms = cuda_ms(torch, lambda x: fused_preprocess(x, norm), xs)
    device = preprocess_device_ms(
        torch, lambda: [fused_preprocess(x, norm) for x in xs], len(xs))
    plain = cuda_ms(torch, lambda x: fused_preprocess_reference(
        x, norm, torch.bfloat16), xs[:N_PLAIN], warmup=1)
    px = TILES * TILE_PX * TILE_PX
    b, by = bound_ms(px * 3 * (1 + 2), {"f32": 60.0 * px})
    return {"name": "fused_preprocess", "max_abs_err": err, "tol": tol,
            "ms": ms, "device_ms": device, "plain_ms": plain,
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "plan": preprocess_plan(launch_plan(*shape[:3])),
            "by_dtype": {"float32": preprocess_f32(torch, norm, xs)}}


def preprocess_f32(torch, norm, xs) -> dict:
    """Row 1 with f32 out (the TPU kernel's ``out_dtype``) on the same
    tiles: its error against the plain f32 chain, a repeat bit for bit,
    its median time over the fresh inputs, the plain version's, and the
    bound with 4-byte outputs."""
    from biscuit_torch.ops.fused_preprocess import (
        fused_preprocess,
        fused_preprocess_reference,
    )

    f32 = torch.float32
    got = fused_preprocess(xs[0], norm, out_dtype=f32)
    err = (got - fused_preprocess_reference(xs[0], norm, f32)).abs().max()
    err = err.item()
    check(err <= PREPROCESS_F32_TOL, f"fused_preprocess f32: max abs err "
                                     f"{err} > {PREPROCESS_F32_TOL}")
    check(torch.equal(got, fused_preprocess(xs[0], norm, out_dtype=f32)),
          "fused_preprocess f32: the same tiles repeat bit for bit")
    del got
    ms = cuda_ms(torch, lambda x: fused_preprocess(x, norm, out_dtype=f32),
                 xs)
    plain = cuda_ms(torch, lambda x: fused_preprocess_reference(x, norm, f32),
                    xs[:N_PLAIN], warmup=1)
    px = TILES * TILE_PX * TILE_PX
    b, by = bound_ms(px * 3 * (1 + 4), {"f32": 60.0 * px})
    return {"max_abs_err": err, "tol": PREPROCESS_F32_TOL,
            "repeats_bit_for_bit": True, "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": b, "bound_by": by}


def preprocess_compare(torch, gen):
    """Row 1 of this checkout (``--preprocess``, ``--root``): its call
    time (CUDA events between calls enqueued back to back), its kernel's
    device time (torch.profiler), its host time a call (50 calls enqueued
    without a synchronize), one request's preprocess stage as
    ``stage_breakdown`` times it (CUDA events around
    ``inference_preprocess`` after a synchronize, median of 5, and the
    host time of that call), and, where the checkout's launch plan takes
    a cluster size, each of PREPROCESS_VARIANTS launched as it is. One
    line."""
    from biscuit_torch.data.normalize import (
        ReinhardFastNormalizer,
        inference_preprocess,
    )
    from biscuit_torch.ops import fused_preprocess as fp

    norm = ReinhardFastNormalizer()
    shape = (TILES, TILE_PX, TILE_PX, 3)
    xs = [torch.randint(0, 256, shape, generator=gen, device="cuda",
                        dtype=torch.uint8) for _ in range(N_TIMED)]
    ref = fp.fused_preprocess_reference(xs[0], norm, torch.float32)
    out = {"phase": "preprocess", "biscuit_torch": fp.__file__,
           "max_abs_err": (fp.fused_preprocess(xs[0], norm).float()
                           - ref).abs().max().item(),
           "ms": cuda_ms(torch, lambda x: fp.fused_preprocess(x, norm), xs),
           "device_ms": preprocess_device_ms(
               torch, lambda: [fp.fused_preprocess(x, norm) for x in xs],
               len(xs)),
           "profile": kernel_profile(torch, lambda: fp.fused_preprocess(
               xs[0], norm), top=6)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fp.fused_preprocess(xs[0], norm)
    out["host_us"] = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    stage, host = [], []
    with torch.inference_mode():
        for i in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            t0 = time.perf_counter()
            inference_preprocess(xs[i], norm)
            host.append((time.perf_counter() - t0) * 1e6)
            ev[1].record()
            torch.cuda.synchronize()
            stage.append(ev[0].elapsed_time(ev[1]))
    out["stage_ms"] = statistics.median(stage)
    out["stage_ms_runs"] = stage
    out["stage_host_us"] = statistics.median(host)
    if hasattr(fp, "_launch"):
        import dataclasses

        coef = fp.coefficients(norm, xs[0].device)
        for cluster, threads in PREPROCESS_VARIANTS:
            plan = dataclasses.replace(
                fp.launch_plan(*shape[:3], cluster=cluster), threads=threads)
            dst = torch.empty(shape, dtype=torch.bfloat16, device="cuda")

            def run(x, plan=plan, dst=dst):
                fp._launch(x, dst, coef, plan)

            run(xs[0])
            err = (dst.float() - ref).abs().max().item()
            check(err <= 2e-2, f"fused_preprocess, cluster {cluster}, "
                               f"{threads} threads: max abs err {err}")
            out[f"cluster_{cluster}_threads_{threads}"] = {
                **preprocess_plan(plan), "max_abs_err": err,
                "ms": cuda_ms(torch, run, xs),
                "device_ms": preprocess_device_ms(
                    torch, lambda: [run(x) for x in xs], len(xs))}
    emit(out)


def library_middle(torch, x, dw, pw, sc, sh):
    """The same function from library calls: per unit a cuDNN depthwise
    conv and a torch.matmul in x's dtype, bf16 or f32 (the port never
    calls this)."""
    import torch.nn.functional as F

    n, h, w, c = x.shape
    taps = dw.transpose(1, 2).reshape(-1, c, 1, 3, 3).to(x.dtype)
    pw = pw.to(x.dtype)
    y = x
    for b in range(dw.shape[0] // 3):
        res = y
        for u in range(3):
            uid = b * 3 + u
            a = F.conv2d(torch.relu(y).permute(0, 3, 1, 2), taps[uid],
                         padding=1, groups=c).permute(0, 2, 3, 1)
            y = (a.reshape(-1, c) @ pw[uid]).reshape(n, h, w, c)
            y = (y * sc[uid] + sh[uid]).to(x.dtype)
        y = y + res
    return y


def kernel_middle(torch, gen):
    from biscuit_torch.models.flops import H100_HBM_BYTES_PER_S
    from biscuit_torch.ops.fused_sepconv import (
        fused_middle_flow,
        fused_middle_flow_reference,
    )

    u, c, hw = 24, 728, 19

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std

    dw = normal((u, 9, c), 0.15)
    pw = normal((u, c, c), 0.15 / c ** 0.5).to(torch.bfloat16)
    sc = 0.8 + 0.4 * torch.rand((u, c), generator=gen, device="cuda")
    sh = normal((u, c), 0.05)
    xs = [normal((TILES, hw, hw, c), 1.0).to(torch.bfloat16)
          for _ in range(N_TIMED)]
    got = fused_middle_flow(xs[0], dw, pw, sc, sh).float()
    ref = fused_middle_flow_reference(xs[0], dw, pw, sc, sh).float()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # f32 sums in another order can flip a bf16 rounding of a unit's
    # input; 24 units and the bf16 output allow ~1% of the largest value.
    tol = 1e-2 * scale
    check(err <= tol, f"fused_middle_flow: max abs err {err} > {tol}")
    ms = cuda_ms(torch, lambda x: fused_middle_flow(x, dw, pw, sc, sh), xs)
    plain = cuda_ms(torch, lambda x: fused_middle_flow_reference(
        x, dw, pw, sc, sh), xs[:N_PLAIN], warmup=1)
    lib = cuda_ms(torch, lambda x: library_middle(torch, x, dw, pw, sc, sh),
                  xs)
    m = TILES * hw * hw
    n_bytes = 2 * m * c * 2 + u * (9 * c * 4 + c * c * 2 + 2 * c * 4)
    b, by = bound_ms(n_bytes, {"bf16": 2.0 * m * c * c * u,
                               "f32": 18.0 * m * c * u})
    # The floor of the two-pass design, whose f32 carry crosses HBM: per
    # unit the depthwise reads it and writes the bf16 GEMM input, the GEMM
    # reads that and writes the carry, and reads the residual every third.
    two_pass = u * m * c * (4 + 2 + 2 + 4) + (u // 3) * m * c * 4
    prof = kernel_profile(torch, lambda: fused_middle_flow(xs[0], dw, pw, sc,
                                                           sh), top=6)
    per_unit = {part: sum(r["ms"] for r in prof["top"]
                          if any(k in r["kernel"] for k in names)) / u
                for part, names in (("gemm", ("sepconv_gemm",)),
                                    ("depthwise", ("dw_staged", "dw_narrow")))}
    row = {"name": "fused_middle_flow", "max_abs_err": err, "tol": tol,
           "max_abs_ref": scale, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "bound_ms": b, "bound_by": by,
           "two_pass_bytes_ms": two_pass / H100_HBM_BYTES_PER_S * 1e3,
           "unit_ms": per_unit, "profile": prof,
           "gemm_plan": gemm_plans("fused_middle_flow", TILES, hw, hw, c)[0]}
    del xs
    torch.cuda.empty_cache()
    # f32 x (an f32 model's middle flow), the same weights.
    xs = [normal((TILES, hw, hw, c), 1.0) for _ in range(N_TIMED)]
    got = fused_middle_flow(xs[0], dw, pw, sc, sh)
    ref = fused_middle_flow_reference(xs[0], dw, pw, sc, sh)
    check(got.dtype == ref.dtype == torch.float32, "f32 in, f32 out")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = MIDDLE_F32_TOL * scale
    # The gate bites: the plain version on x rounded to bf16, and its
    # output rounded to bf16, must both miss it.
    x_bf16_err = (fused_middle_flow_reference(
        xs[0].to(torch.bfloat16).float(), dw, pw, sc, sh)
        - ref).abs().max().item()
    out_bf16_err = (ref.to(torch.bfloat16).float() - ref).abs().max().item()
    check(err <= tol < min(x_bf16_err, out_bf16_err),
          f"fused_middle_flow f32: max abs err {err}, x rounded to bf16 "
          f"{x_bf16_err}, out rounded to bf16 {out_bf16_err}, bound {tol}")
    check(torch.equal(got, fused_middle_flow(xs[0], dw, pw, sc, sh)),
          "fused_middle_flow f32: repeats bit for bit")
    del got, ref
    ms = cuda_ms(torch, lambda x: fused_middle_flow(x, dw, pw, sc, sh), xs)
    plain = cuda_ms(torch, lambda x: fused_middle_flow_reference(
        x, dw, pw, sc, sh), xs[:N_PLAIN], warmup=1)
    lib = cuda_ms(torch, lambda x: library_middle(torch, x, dw, pw, sc, sh),
                  xs)
    n_bytes = 2 * m * c * 4 + u * (9 * c * 4 + c * c * 2 + 2 * c * 4)
    b, by = bound_ms(n_bytes, {"bf16": 2.0 * m * c * c * u,
                               "f32": 18.0 * m * c * u})
    row["by_dtype"] = {"float32": {
        "max_abs_err": err, "tol": tol, "max_abs_ref": scale,
        "max_abs_err_x_bf16": x_bf16_err, "max_abs_err_out_bf16": out_bf16_err,
        "repeats_bit_for_bit": True, "ms": ms, "plain_ms": plain,
        "library_ms": lib, "bound_ms": b, "bound_by": by,
        "profile": kernel_profile(torch, lambda: fused_middle_flow(
            xs[0], dw, pw, sc, sh), top=6)}}
    return row


def library_head(torch, feats, w1, b1, w2, b2, w3, b3):
    """The head at dropout 0 from F.linear calls, K passes batched."""
    import torch.nn.functional as F

    h = torch.relu(F.linear(feats.to(torch.bfloat16), w1.t(), b1.to(torch.bfloat16)))
    h = h.repeat(K, 1)
    h = torch.relu(F.linear(h, w2.t(), b2.to(torch.bfloat16)))
    p = torch.softmax(F.linear(h, w3.t(), b3.to(torch.bfloat16)).float(), -1)
    p = p.view(K, feats.shape[0], -1)
    return p.mean(0), p.std(0, correction=0)


def module_head(torch, head, feats):
    """The module head, as the interface runs a head the kernel does not
    take: ``mc_dropout_head`` with ``use_kernel=False`` (K f32 passes of
    the ``Head`` module, torch dropout)."""
    from types import SimpleNamespace

    from biscuit_torch.train.uq import mc_dropout_head

    model = SimpleNamespace(head=head, dropout=head.dropout, head_logits=head)
    return mc_dropout_head(model, feats, seed=7, k=K, use_kernel=False)


def head_case(torch, fs, c: int):
    """Kernel row 3 at C classes (F = 2048, H = 1024, K, dropout 0.1, TILES
    tiles): the kernel against its plain version at dropout 0 and 0.1,
    a repeat bit for bit, its device kernels a call, and the times of the
    kernel, the plain version, the F.linear chain, the module head and
    the bound. The logits weights are scaled up 8 times, so that the
    softmax is far from uniform and the std at dropout 0.1 is large beside
    its limit: a kernel whose std is wrong cannot pass."""
    from biscuit_torch.models.xception import Head
    from biscuit_torch.ops.mcd_head import (
        head_weights,
        mcd_head,
        mcd_head_reference,
    )

    f, hdim = 2048, 1024
    torch.manual_seed(1)
    head = Head(f, c, 2, hdim, 0.1).cuda()
    with torch.no_grad():
        head.logits.weight.mul_(8.0)
    wts = head_weights(head)
    out = {"classes": c}
    errs = []
    for rate, tol in ((0.0, 1e-3), (0.1, 2e-3)):
        # Same Philox stream in both: compare exactly, up to f32 sum order
        # (which may flip a bf16 rounding of a hidden unit).
        km, ks = mcd_head(fs[0], *wts, k=K, dropout=rate, seed=1234)
        rm, rs = mcd_head_reference(fs[0], *wts, k=K, dropout=rate, seed=1234)
        check(tuple(km.shape) == (TILES, c), f"mcd_head C={c}: shape")
        err_m = (km - rm).abs().max().item()
        err_s = (ks - rs).abs().max().item()
        # At dropout 0.1 the std is also held to a twentieth of its own
        # largest value.
        tol_s = tol if rate == 0 else min(tol, 0.05 * rs.max().item())
        check(err_m <= tol, f"mcd_head C={c} dropout {rate}: mean max abs "
                            f"err {err_m} > {tol}")
        check(err_s <= tol_s, f"mcd_head C={c} dropout {rate}: std max abs "
                              f"err {err_s} > {tol_s}")
        check(bool((km.sum(-1) - 1).abs().max() < 1e-3),
              f"mcd_head C={c}: mean rows sum to 1")
        err = max(err_m, err_s)
        errs.append(err)
        out[f"max_abs_err_dropout_{rate}"] = err
        out[f"std_max_abs_err_dropout_{rate}"] = err_s
        out[f"tol_dropout_{rate}"] = tol
        out[f"std_tol_dropout_{rate}"] = tol_s
    # Far from uniform: some tile's mean is twice 1 / C (above 0.75 at
    # C = 2).
    out["mean_max"] = rm.max().item()
    check(out["mean_max"] > min(2.0 / c, 0.75),
          f"mcd_head C={c}: softmax near uniform, max mean {out['mean_max']}")
    out["std_max"], out["std_mean"] = rs.max().item(), rs.mean().item()
    again = mcd_head(fs[0], *wts, k=K, dropout=0.1, seed=1234)
    check(torch.equal(again[0], km) and torch.equal(again[1], ks),
          f"mcd_head C={c}: one seed repeats bit for bit")
    out["max_abs_err"] = max(errs)
    out["ms"] = cuda_ms(torch, lambda x: mcd_head(x, *wts, k=K, dropout=0.1,
                                                  seed=7), fs)
    prof = kernel_profile(torch, lambda: mcd_head(fs[0], *wts, k=K,
                                                  dropout=0.1, seed=7), top=6)
    out["device_kernels"] = sum(r["calls"] for r in prof["top"])
    check(out["device_kernels"] == HEAD_DEVICE_KERNELS,
          f"mcd_head C={c}: {out['device_kernels']} device kernels a call, "
          f"expected {HEAD_DEVICE_KERNELS}")
    out["profile"] = prof
    # Host time a call: 50 calls enqueued with no synchronize between them.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        mcd_head(fs[0], *wts, k=K, dropout=0.1, seed=7)
    out["host_us"] = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    out["plain_ms"] = cuda_ms(torch, lambda x: mcd_head_reference(
        x, *wts, k=K, dropout=0.1, seed=7), fs[:N_PLAIN], warmup=1)
    out["library_ms"] = cuda_ms(torch, lambda x: library_head(torch, x, *wts),
                                fs)
    with torch.inference_mode():
        out["module_ms"] = cuda_ms(torch, lambda x: module_head(torch, head, x),
                                   fs[:N_PLAIN], warmup=1)
        out["module_profile"] = kernel_profile(
            torch, lambda: module_head(torch, head, fs[0]), top=4)
    n_bytes = (TILES * f * 4 + (f * hdim + hdim * hdim + hdim * c) * 2
               + (2 * hdim + c) * 4 + 2 * TILES * c * 4)
    ops = 2.0 * TILES * (f * hdim + K * (hdim * hdim + hdim * c))
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, {"bf16": ops})
    return out


def kernel_head(torch, gen):
    """Row 3 at HEAD_CLASSES: the published head's numbers at the top
    level, every class count's under ``by_classes``; ``max_abs_err`` is
    the largest of them all."""
    fs = [torch.randn((TILES, 2048), generator=gen, device="cuda")
          for _ in range(N_TIMED)]
    cases = [head_case(torch, fs, c) for c in HEAD_CLASSES]
    out = {"name": "mcd_head", **cases[0],
           "max_abs_err": max(case["max_abs_err"] for case in cases),
           "by_classes": {str(case["classes"]): {
               k: v for k, v in case.items() if k != "profile"}
               for case in cases}}
    return out


def library_unit_bwd(torch, a, taps, wpw, gamma, beta, relu_first):
    """The unit's backward as one library call: autograd through cuDNN's
    depthwise and 1x1 convs and ``F.batch_norm`` in training mode (the
    port never calls this). Returns a function of the output gradient."""
    import torch.nn.functional as F

    ci, co = wpw.shape
    leaves = [t.detach().clone().requires_grad_()
              for t in (a, taps, wpw, gamma, beta)]
    x, tp, wp, g, b = leaves
    r = torch.relu(x) if relu_first else x
    d = F.conv2d(r.permute(0, 3, 1, 2),
                 tp.t().reshape(ci, 1, 3, 3).to(a.dtype), padding=1,
                 groups=ci)
    p = F.conv2d(d, wp.t().reshape(co, ci, 1, 1).to(a.dtype))
    y = F.batch_norm(p, None, None, g, b, True, 0.0, 1e-5)
    y = y.permute(0, 2, 3, 1)
    return lambda gy: torch.autograd.grad(y, leaves, gy, retain_graph=True)


def unit_bwd_inputs(torch, gen, n, hw, ci, co, relu_first):
    """Seeded inputs of one unit backward on the card: (a, the forward's
    weights, the backward's arguments). The weights are given as the
    training path gives them (``train/fused_train.py``): the (9, CI) taps
    and the (CI, CO) Wpw are transposed views of f32 tensors laid out as
    the modules hold them, (CI, 9) and (CO, CI)."""
    from biscuit_torch.ops.fused_unit_bwd import unit_fwd

    def normal(shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    a = normal((n, hw, hw, ci)).to(torch.bfloat16)
    taps = normal((ci, 9), 0.2).t()
    wpw = normal((co, ci), ci ** -0.5).t()
    gamma, beta = 1 + normal((co,), 0.1), normal((co,), 0.1)
    gy = normal((n, hw, hw, co)).to(torch.bfloat16)
    _, mu, var, (r, d, p) = unit_fwd(a, taps, wpw, gamma, beta, 1e-5,
                                     relu_first)
    args = (gy, r, d, p, taps, wpw, gamma, mu, var, 1e-5, relu_first)
    return a, (taps, wpw, gamma, beta), args


def unit_bwd_bound(n, hw, ci, co):
    """(bound ms, by) of one unit backward: one read of gy, p, r, d, one
    write of da, and the BN sums' read of gy and p; 4 CI CO bf16
    operations and the depthwise's f32 work a pixel."""
    m = n * hw * hw
    n_bytes = m * (2 * co + 3 * ci) * 2 + 2 * m * co * 2
    return bound_ms(n_bytes, {"bf16": 2.0 * m * 2 * ci * co,
                              "f32": 2.0 * m * (18 * ci + 6 * co)})


def kernel_unit_bwd(torch, gen):
    """Both unit-backward kernels against the plain version at each of
    UNIT_GEOMETRIES, batch TRAIN_BATCH; one row per kernel, its times and
    bound added over the geometries. Each kernel also repeats its outputs
    bit for bit, and its profile holds only the kernels of
    UNIT_BWD_KERNELS, so that ``unit_bwd_kernels_ms`` covers it all."""
    from biscuit_torch.ops.fused_unit_bwd import (
        unit_bwd_plane,
        unit_bwd_reference,
        unit_bwd_strips,
        unit_bwd_sums,
    )

    kernels = {"unit_bwd_plane": unit_bwd_plane,
               "unit_bwd_strips": unit_bwd_strips}

    def group_route(fn, args, sums=None, m=None):
        """The kernel's two entries (the sums, then the rest from them):
        the route of a lockstep group. At one rank (``sums`` None) the
        one call's five outputs, dgamma and dbeta being the sums; given a
        group's ``sums`` and pixel count ``m``, this rank's (da, dwdw,
        dwpw)."""
        gy, p, mu, var, eps = args[0], args[3], args[7], args[8], args[9]
        if sums is not None:
            return fn(*args, sums=sums, m=m)[:3]
        sums = unit_bwd_sums(gy, p, mu, var, eps)
        return fn(*args, sums=sums, m=gy[..., 0].numel())[:3] + (
            sums[1], sums[0])

    def two_halves(fn, args, tols, where):
        """The group route at two ranks: each half of the batch fed the
        two halves' summed sums and the batch's pixel count. The second
        half's gy and p are shifted by 1, so that each half's own sums are
        far from the batch's (a route that kept a rank's own sums or
        pixel count would fail). Each half's (da, dwdw, dwpw) against the
        plain version of the same half with the same sums and m, and the
        halves put together (da row by row, the weight gradients and the
        sums added) against the plain version on the whole batch, each
        within the row's tolerance. Returns the relative errors."""
        gy, p = (t.clone() for t in (args[0], args[3]))
        n = gy.shape[0] // 2
        gy[n:] += 1
        p[n:] += 1
        args = (gy, args[1], args[2], p) + tuple(args[4:])
        mu, var, eps = args[7], args[8], args[9]
        want = unit_bwd_reference(*args)
        halves = [tuple(t[i * n:(i + 1) * n].contiguous()
                        for t in args[:4]) + tuple(args[4:])
                  for i in range(2)]
        sums = (unit_bwd_sums(halves[0][0], halves[0][3], mu, var, eps)
                + unit_bwd_sums(halves[1][0], halves[1][3], mu, var, eps))
        m = gy[..., 0].numel()
        outs = [group_route(fn, h, sums, m) for h in halves]
        torch.cuda.synchronize()
        errs = {}
        for i, h in enumerate(halves):
            plain = unit_bwd_reference(*h, sums=sums, m=m)
            for key, g, w in zip(("da", "dwdw", "dwpw"), outs[i], plain):
                g, w = g.float(), w.float()
                check(bool(torch.isfinite(g).all()),
                      f"{where} half {i} {key} finite")
                errs[f"half{i}_{key}"] = e = (
                    (g - w).abs().max().item() / w.abs().max().item())
                check(e <= tols[key], f"{where} half {i} {key} from the "
                                      f"group's sums: relative error {e} > "
                                      f"{tols[key]}")
        whole = (torch.cat([outs[0][0], outs[1][0]]), outs[0][1] + outs[1][1],
                 outs[0][2] + outs[1][2], sums[1], sums[0])
        for key, g, w in zip(tols, whole, want):
            g, w = g.float(), w.float()
            errs[f"whole_{key}"] = e = (
                (g - w).abs().max().item() / w.abs().max().item())
            check(e <= tols[key], f"{where} two halves against the whole "
                                  f"batch, {key}: relative error {e} > "
                                  f"{tols[key]}")
        return errs
    rows = {name: {"name": name, "geometries": [], "ms": 0.0,
                   "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0} for name in kernels}
    # da is bf16 and the kernel factors the BN backward as the TPU kernel
    # does, so a bf16 rounding of gp may flip: 1e-2 of the largest da;
    # the f32 weight and BN gradients 5e-3 of their largest value.
    tols = {"da": 1e-2, "dwdw": 5e-3, "dwpw": 5e-3, "dgamma": 5e-3,
            "dbeta": 5e-3}
    for hw, ci, co, relu_first in UNIT_GEOMETRIES:
        n = TRAIN_BATCH
        a, (taps, wpw, gamma, beta), args = unit_bwd_inputs(
            torch, gen, n, hw, ci, co, relu_first)
        want = unit_bwd_reference(*args)
        plain = cuda_ms(torch, lambda x: unit_bwd_reference(*x),
                        [args] * N_PLAIN, warmup=1)
        lib_fn = library_unit_bwd(torch, a, taps, wpw, gamma, beta,
                                  relu_first)
        lib = cuda_ms(torch, lib_fn, [args[0]] * N_TIMED)
        del lib_fn
        b, by = unit_bwd_bound(n, hw, ci, co)
        for name, fn in kernels.items():
            got = fn(*args)
            again = fn(*args)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{name}: the same inputs repeat bit for bit")
            del again
            errs, abs_errs = {}, {}
            for key, g, w in zip(tols, got, want):
                g, w = g.float(), w.float()
                check(bool(torch.isfinite(g).all()), f"{name} {key} finite")
                abs_errs[key] = (g - w).abs().max().item()
                errs[key] = abs_errs[key] / w.abs().max().item()
                check(errs[key] <= tols[key],
                      f"{name} {hw}x{hw} {ci}->{co} {key}: relative error "
                      f"{errs[key]} > {tols[key]}")
            ms = cuda_ms(torch, lambda x: fn(*x), [args] * N_TIMED)
            prof = kernel_profile(torch, lambda: fn(*args), top=8,
                                  only=UNIT_BWD_KERNELS)
            route = group_route(fn, args)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(route, got)),
                  f"{name}: the group route at one rank equals the one "
                  f"call bit for bit")
            del route
            halves_err = two_halves(fn, args, tols,
                                    f"{name} {hw}x{hw} {ci}->{co}")
            route_ms = cuda_ms(torch, lambda x: group_route(fn, x),
                               [args] * N_TIMED)
            row = rows[name]
            row["geometries"].append({
                "hw": hw, "ci": ci, "co": co, "batch": n,
                "relu_first": relu_first, "rel_err": errs, "tol": tols,
                "abs_err": abs_errs,
                "ms": ms, "plain_ms": plain, "library_ms": lib,
                "bound_ms": b, "bound_by": by, "profile": prof,
                "group_route": {"bit_for_bit_at_one_rank": True,
                                "ms": route_ms,
                                "two_halves_rel_err": halves_err}})
            row["ms"] += ms
            row["plain_ms"] += plain
            row["library_ms"] += lib
            row["bound_ms"] += b
            row["max_abs_err"] = max(row["max_abs_err"],
                                     max(abs_errs.values()))
        del a, want, args
        torch.cuda.empty_cache()
    for row in rows.values():
        row["bound_by"] = max(row["geometries"],
                              key=lambda g: g["bound_ms"])["bound_by"]
    return list(rows.values())


def unit_bwd_passes(torch, gen):
    """Per-pass device time of both unit-backward kernels at each of
    UNIT_PASS_GEOMETRIES, batch TRAIN_BATCH (``--unit-bwd-passes``): one
    line a geometry with each kernel's ms (CUDA events, N_TIMED calls),
    its profile, the autograd yardstick's ms and the bound. It names no
    kernel, so that it profiles another checkout's kernels too
    (``--root``)."""
    from biscuit_torch.ops.fused_unit_bwd import (
        unit_bwd_plane,
        unit_bwd_strips,
    )

    for hw, ci, co, relu_first in UNIT_PASS_GEOMETRIES:
        n = TRAIN_BATCH
        a, (taps, wpw, gamma, beta), args = unit_bwd_inputs(
            torch, gen, n, hw, ci, co, relu_first)
        lib_fn = library_unit_bwd(torch, a, taps, wpw, gamma, beta,
                                  relu_first)
        out = {"phase": "unit_bwd_passes", "hw": hw, "ci": ci, "co": co,
               "batch": n, "library_ms": cuda_ms(torch, lib_fn,
                                                  [args[0]] * N_TIMED)}
        del lib_fn
        out["bound_ms"], out["bound_by"] = unit_bwd_bound(n, hw, ci, co)
        for name, fn in (("unit_bwd_strips", unit_bwd_strips),
                         ("unit_bwd_plane", unit_bwd_plane)):
            out[name] = {
                "ms": cuda_ms(torch, lambda x: fn(*x), [args] * N_TIMED),
                "profile": kernel_profile(torch, lambda: fn(*args), top=12)}
        emit(out)
        del a, args
        torch.cuda.empty_cache()


def kernel_fused_block(torch, gen):
    """The fused strided block against its plain version at each of
    BLOCK_GEOMETRIES at TILES tiles; its times and bound added over the
    geometries. The library yardstick is the eval-mode XceptionBlock
    module the weights come from (cuDNN convs, BN, pool), which the fused
    path never calls."""
    from biscuit_torch.models.xception import XceptionBlock
    from biscuit_torch.ops.fused_block import (
        fused_strided_block,
        fused_strided_block_reference,
        stack_block_weights,
    )

    row = {"name": "fused_block", "geometries": [], "ms": 0.0,
           "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0}
    f32_rows = []
    # f32 sums in another order can flip a bf16 rounding of a0, a1 or y1:
    # 1e-2 of the largest value.
    tol_rel = 1e-2
    for hw, cin, f0, f1, relu_first in BLOCK_GEOMETRIES:
        block = XceptionBlock(cin, (f0, f1), 2, relu_first)
        init_random_(torch, block, SEED + hw)
        block = block.cuda().eval()
        wts = stack_block_weights(block)
        xs = [torch.randn((TILES, hw, hw, cin), generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(N_TIMED)]
        got = fused_strided_block(xs[0], wts, relu_first).float()
        ref = fused_strided_block_reference(xs[0], wts, relu_first).float()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "fused_block finite")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check(err <= tol_rel * scale, f"fused_block {hw}^2 {cin}->{f0}->{f1}:"
                                      f" max abs err {err} > {tol_rel * scale}")
        del got, ref
        ms = cuda_ms(torch, lambda x: fused_strided_block(x, wts, relu_first),
                     xs)
        plain = cuda_ms(torch, lambda x: fused_strided_block_reference(
            x, wts, relu_first), xs[:N_PLAIN], warmup=1)
        with torch.inference_mode():
            lib = cuda_ms(torch, lambda x: block(x.permute(0, 3, 1, 2)), xs)
        m, h2 = TILES * hw * hw, -(-hw // 2)
        m2 = TILES * h2 * h2
        n_bytes = (m * cin * 2 + m2 * f1 * 2
                   + sum(t.numel() * t.element_size() for t in wts))
        b, by = bound_ms(n_bytes, {
            "bf16": 2.0 * m * (cin * f0 + f0 * f1) + 2.0 * m2 * cin * f1,
            "f32": 18.0 * m * (cin + f0) + 2.0 * m * (f0 + f1)})
        row["geometries"].append({
            "hw": hw, "cin": cin, "f0": f0, "f1": f1, "tiles": TILES,
            "gemm_plan": dict(zip(("gemm0", "gemm1", "residual"), gemm_plans(
                "fused_block", TILES, hw, hw, cin, f0, f1))),
            "relu_first": relu_first, "max_abs_err": err,
            "tol": tol_rel * scale, "max_abs_ref": scale, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": b,
            "bound_by": by,
            "profile": kernel_profile(
                torch, lambda: fused_strided_block(xs[0], wts, relu_first),
                top=6)})
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b)):
            row[key] += v
        row["max_abs_err"] = max(row["max_abs_err"], err)
        del xs
        torch.cuda.empty_cache()
        f32_rows.append(fused_block_f32(torch, gen, block, wts, hw, cin, f0,
                                        f1, relu_first, tol_rel))
        del block, wts
        torch.cuda.empty_cache()
    row["bound_by"] = max(row["geometries"],
                          key=lambda g: g["bound_ms"])["bound_by"]
    f32 = {"geometries": f32_rows}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        f32[key] = sum(g[key] for g in f32_rows)
    for key in ("max_abs_err", "residual_rel_err"):
        f32[key] = max(g[key] for g in f32_rows)
    f32["bound_by"] = max(f32_rows, key=lambda g: g["bound_ms"])["bound_by"]
    row["by_dtype"] = {"float32": f32}
    return row


def fused_block_f32(torch, gen, block, wts, hw, cin, f0, f1, relu_first,
                    tol_rel) -> dict:
    """Row 4 with f32 x at one geometry: the block against its plain
    version (tol_rel of the largest value), the residual alone (BN1's
    scale and shift zero) within RESIDUAL_F32_TOL of its largest value,
    where x rounded to bf16 must miss it (the gate bites), a repeat bit
    for bit, the kernel's, plain version's and the f32 eval-mode
    XceptionBlock's median times, and the bound with f32 x and out."""
    from biscuit_torch.ops.fused_block import (
        fused_strided_block,
        fused_strided_block_reference,
    )

    what = f"fused_block f32 {hw}^2 {cin}->{f0}->{f1}"
    xs = [torch.randn((TILES, hw, hw, cin), generator=gen, device="cuda")
          for _ in range(N_TIMED)]
    got = fused_strided_block(xs[0], wts, relu_first)
    ref = fused_strided_block_reference(xs[0], wts, relu_first)
    check(got.dtype == ref.dtype == torch.float32, f"{what}: f32 out")
    check(bool(torch.isfinite(got).all()), f"{what}: finite")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    check(err <= tol_rel * scale, f"{what}: max abs err {err} > "
                                  f"{tol_rel * scale}")
    check(torch.equal(got, fused_strided_block(xs[0], wts, relu_first)),
          f"{what}: repeats bit for bit")
    del got, ref
    zero = torch.zeros(f1, device="cuda")
    res_only = tuple(wts[:6]) + (zero, zero) + tuple(wts[8:])
    got = fused_strided_block(xs[0], res_only, relu_first)
    ref = fused_strided_block_reference(xs[0], res_only, relu_first)
    r_scale = ref.abs().max().item()
    res_err = (got - ref).abs().max().item() / r_scale
    bf16_err = (fused_strided_block_reference(
        xs[0].to(torch.bfloat16).float(), res_only, relu_first)
        - ref).abs().max().item() / r_scale
    check(res_err <= RESIDUAL_F32_TOL < bf16_err,
          f"{what}: residual rel err {res_err}, x rounded to bf16 "
          f"{bf16_err}, bound {RESIDUAL_F32_TOL}")
    del got, ref
    ms = cuda_ms(torch, lambda x: fused_strided_block(x, wts, relu_first),
                 xs)
    plain = cuda_ms(torch, lambda x: fused_strided_block_reference(
        x, wts, relu_first), xs[:N_PLAIN], warmup=1)
    with torch.inference_mode():
        lib = cuda_ms(torch, lambda x: block(x.permute(0, 3, 1, 2)), xs)
    m, h2 = TILES * hw * hw, -(-hw // 2)
    m2 = TILES * h2 * h2
    n_bytes = (m * cin * 4 + m2 * f1 * 4
               + sum(t.numel() * t.element_size() for t in wts))
    b, by = bound_ms(n_bytes, {
        "bf16": 2.0 * m * (cin * f0 + f0 * f1) + 2.0 * m2 * cin * f1,
        "f32": 18.0 * m * (cin + f0) + 2.0 * m * (f0 + f1)})
    return {"hw": hw, "cin": cin, "f0": f0, "f1": f1, "tiles": TILES,
            "max_abs_err": err, "tol": tol_rel * scale, "max_abs_ref": scale,
            "residual_rel_err": res_err, "residual_tol": RESIDUAL_F32_TOL,
            "residual_rel_err_x_bf16": bf16_err, "repeats_bit_for_bit": True,
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b,
            "bound_by": by,
            "profile": kernel_profile(
                torch, lambda: fused_strided_block(xs[0], wts, relu_first),
                top=8)}


def bf16_ulp(torch, v):
    """One bf16 ulp at each value of v (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def kernel_depthwise(torch, gen):
    """The depthwise 3x3 against its plain version at each of
    DW_GEOMETRIES (bf16, TILES images): the forward, and dx and dk of one
    backward against autograd of the plain version; times of the forward,
    added over the geometries. Library: F.conv2d(groups=C)."""
    import torch.nn.functional as F

    from biscuit_torch.ops.depthwise import (
        depthwise_conv3x3,
        depthwise_conv3x3_reference,
    )

    row = {"name": "depthwise3x3", "geometries": [], "ms": 0.0,
           "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0}
    # Forward and dx: nine f32 taps in the same order on both sides, so
    # at most a rounding tie flips: one bf16 ulp of each value. dk: f32
    # sums over N*H*W products in another order: 1e-4 of the largest.
    tol_dk = 1e-4
    for hw, c in DW_GEOMETRIES:
        shape = (TILES, hw, hw, c)
        k = 0.3 * torch.randn((3, 3, 1, c), generator=gen, device="cuda")
        xs = [torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(N_TIMED)]
        g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        outs = {}
        for name, fn in (("kernel", depthwise_conv3x3),
                         ("plain", depthwise_conv3x3_reference)):
            xg, kg = xs[0].clone().requires_grad_(), k.clone().requires_grad_()
            y = fn(xg, kg)
            outs[name] = (y.detach(), *torch.autograd.grad(y, (xg, kg), g))
            del xg, kg, y
        torch.cuda.synchronize()
        errs = {}
        for key, got, want in zip(("y", "dx", "dk"), outs["kernel"],
                                  outs["plain"]):
            got, want = got.float(), want.float()
            check(bool(torch.isfinite(got).all()), f"depthwise3x3 {key} finite")
            errs[key] = (got - want).abs().max().item()
            if key == "dk":
                ok = errs[key] <= tol_dk * want.abs().max().item()
            else:
                ok = bool(((got - want).abs() <= bf16_ulp(torch, want)).all())
            check(ok, f"depthwise3x3 {hw}^2 x {c} {key}: max abs err "
                      f"{errs[key]}")
        del outs
        ms = cuda_ms(torch, lambda x: depthwise_conv3x3(x, k), xs)
        plain = cuda_ms(torch, lambda x: depthwise_conv3x3_reference(x, k),
                        xs[:N_PLAIN], warmup=1)
        w = k.reshape(3, 3, c).permute(2, 0, 1)[:, None].to(torch.bfloat16)
        lib = cuda_ms(torch, lambda x: F.conv2d(x.permute(0, 3, 1, 2), w,
                                                padding=1, groups=c), xs)
        m = TILES * hw * hw
        b, by = bound_ms(2 * m * c * 2 + 9 * c * 4, {"f32": 18.0 * m * c})
        row["geometries"].append({
            "hw": hw, "c": c, "tiles": TILES, "dtype": "bfloat16",
            "max_abs_err": errs, "tol": {"y": "1 bf16 ulp", "dx": "1 bf16 ulp",
                                         "dk": f"{tol_dk} of max"},
            "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b,
            "bound_by": by,
            "profile": kernel_profile(
                torch, lambda: depthwise_conv3x3(xs[0], k), top=3)})
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", b)):
            row[key] += v
        row["max_abs_err"] = max(row["max_abs_err"], errs["y"])
        del xs, g
        torch.cuda.empty_cache()
    row["bound_by"] = max(row["geometries"],
                          key=lambda g: g["bound_ms"])["bound_by"]
    return row


def kernel_bn_train(torch, gen):
    """ops/bn_train's kernels against their plain versions at each of
    BN_GEOMETRIES (bf16, TRAIN_BATCH images): row ``bn_train_fwd`` (the
    sums and the forward apply) and row ``bn_train_bwd`` (the backward's
    sums and apply), each with its time, plain time and bound added over
    the geometries, each way one call (the apply taking its own sums).
    The apply passes must equal the plain versions' bit for bit from the
    kernel's sums, and the one call the sums then the apply; the sums lie
    within 2e-5 of the sums of their terms' magnitudes (f32 in another
    order), and two runs give the same bits. Library yardstick: ``F.batch_norm(training=True)`` on
    the channels-last NCHW view, its forward and its autograd backward.
    Bound: 6 bytes an element forward, 10 backward, over 3.35 TB/s."""
    import torch.nn.functional as F

    from biscuit_torch.ops.bn_train import (
        bn_apply,
        bn_apply_bwd,
        bn_apply_bwd_reference,
        bn_apply_reference,
        bn_sums,
        bn_sums_reference,
        launch_plan,
    )

    eps = 1e-5
    rows = {d: {"name": f"bn_train_{d}", "geometries": [], "ms": 0.0,
                "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                "max_abs_err": 0.0} for d in ("fwd", "bwd")}
    for hw, c in BN_GEOMETRIES:
        shape = (TRAIN_BATCH, hw, hw, c)
        m = TRAIN_BATCH * hw * hw
        xs = [(2 * torch.randn(shape, generator=gen, device="cuda") + 0.5)
              .to(torch.bfloat16) for _ in range(N_TIMED)]
        gy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(c, generator=gen, device="cuda")

        def fwd(x):
            return bn_apply(x, w, b, eps)

        def fwd_plain(x):
            return bn_apply_reference(x, w, b, eps)

        def bwd(x, mu, var):
            return bn_apply_bwd(gy, x, mu, var, w, eps)

        def bwd_plain(x, mu, var):
            return bn_apply_bwd_reference(gy, x, mu, var, w, eps)

        x = xs[0]
        sums = bn_sums(x)
        y, mu, var = bn_apply(x, w, b, eps, sums, m)
        want = bn_apply_reference(x, w, b, eps, sums, m)
        check(all(torch.equal(g, r) for g, r in zip((y, mu, var), want)),
              f"bn_train_fwd {hw}^2 x {c}: apply bit for bit")
        check(all(torch.equal(g, r) for g, r in zip(fwd(x), (y, mu, var))),
              f"bn_train_fwd {hw}^2 x {c}: one call bit for bit")
        back = bn_sums(x, gy, mu, var, eps)
        gx, _ = bn_apply_bwd(gy, x, mu, var, w, eps, back, m)
        check(torch.equal(gx, bn_apply_bwd_reference(gy, x, mu, var, w, eps,
                                                     back, m)[0]),
              f"bn_train_bwd {hw}^2 x {c}: apply bit for bit")
        check(all(torch.equal(g, r) for g, r in zip(bwd(x, mu, var),
                                                    (gx, back))),
              f"bn_train_bwd {hw}^2 x {c}: one call bit for bit")
        again = (bn_sums(x), bn_sums(x, gy, mu, var, eps))
        check(torch.equal(again[0], sums) and torch.equal(again[1], back),
              f"bn_train {hw}^2 x {c}: sums repeat bit for bit")
        xf, gf = x.reshape(-1, c).float(), gy.reshape(-1, c).float()
        xh = (xf - mu) * torch.rsqrt(var + eps)
        errs = {}
        for d, got, ref, scale in (
                ("fwd", sums, bn_sums_reference(x),
                 torch.stack([xf.abs().sum(0), xf.square().sum(0)])),
                ("bwd", back, bn_sums_reference(x, gy, mu, var, eps),
                 torch.stack([gf.abs().sum(0), (gf * xh).abs().sum(0)]))):
            rel = ((got - ref).abs() / scale).max().item()
            check(rel <= 2e-5, f"bn_train_{d} {hw}^2 x {c}: sums {rel} of "
                               f"their terms' magnitudes")
            errs[d] = rel
        del xf, gf, xh

        xr = [t.permute(0, 3, 1, 2) for t in xs]     # channels-last NCHW
        lib_x = xr[0].detach().requires_grad_()
        lib_y = F.batch_norm(lib_x, None, None, w, b, True, 0.0, eps)
        lib_g = gy.permute(0, 3, 1, 2)
        times = {
            "fwd": (cuda_ms(torch, fwd, xs),
                    cuda_ms(torch, fwd_plain, xs[:N_PLAIN], warmup=1),
                    cuda_ms(torch, lambda t: F.batch_norm(
                        t, None, None, w, b, True, 0.0, eps), xr)),
            "bwd": (cuda_ms(torch, lambda t: bwd(t, mu, var), xs),
                    cuda_ms(torch, lambda t: bwd_plain(t, mu, var),
                            xs[:N_PLAIN], warmup=1),
                    cuda_ms(torch, lambda _: torch.autograd.grad(
                        lib_y, lib_x, lib_g, retain_graph=True), xs))}
        profiles = {"fwd": kernel_profile(torch, lambda: fwd(x), top=4),
                    "bwd": kernel_profile(torch, lambda: bwd(x, mu, var),
                                          top=4)}
        for d, per_elem in (("fwd", 6), ("bwd", 10)):
            ms, plain, lib = times[d]
            bound, by = bound_ms(per_elem * m * c, {"f32": 0.0})
            rows[d]["geometries"].append({
                "hw": hw, "c": c, "batch": TRAIN_BATCH, "dtype": "bfloat16",
                "sums_err_of_magnitudes": errs[d], "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                "bound_by": by, "roofline": bound / ms,
                "plan": launch_plan(m, c, torch.bfloat16),
                "profile": profiles[d]})
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", bound)):
                rows[d][key] += v
            rows[d]["max_abs_err"] = max(rows[d]["max_abs_err"], errs[d])
        del xs, xr, gy, lib_x, lib_y, lib_g, x, y, gx
        torch.cuda.empty_cache()
    for row in rows.values():
        row["bound_by"] = "bytes"
        row["roofline"] = row["bound_ms"] / row["ms"]
    return [rows["fwd"], rows["bwd"]]


def depthwise_entry(torch, gen, card: str):
    """The standalone op's own path: one forward and backward through
    ``depthwise_conv3x3`` at entry0's 147^2 x 128 (bf16, TILES images),
    with the launch counts zeroed just before and read just after."""
    from biscuit_torch.ops import _build
    from biscuit_torch.ops.depthwise import depthwise_conv3x3

    hw, c = DW_GEOMETRIES[0]
    x = torch.randn((TILES, hw, hw, c), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    k = (0.3 * torch.randn((3, 3, 1, c), generator=gen,
                           device="cuda")).requires_grad_()
    _build.reset_launch_counts()
    y = depthwise_conv3x3(x, k)
    dx, dk = torch.autograd.grad(y, (x, k), torch.ones_like(y))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    for name, count in launches.items():
        want = 2 if name == "depthwise3x3" else 0
        check(count == want, f"{name}: {count} launches in one forward and "
                             f"backward of depthwise_conv3x3")
    check(bool(torch.isfinite(dx).all() and torch.isfinite(dk).all()),
          "depthwise_conv3x3 finite gradients")
    return {"phase": "depthwise_entry", "hw": hw, "c": c, "tiles": TILES,
            "card": card, "launches": launches}, launches


def init_random_(torch, model, seed: int) -> None:
    """Seeded random weights: LeCun-normal convs (Flax's default), PyTorch's default Linear
    init, and BatchNorm affine and running statistics drawn near identity
    (so folding them is not trivial)."""
    from biscuit_torch.models.xception import BatchNorm, Conv

    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, Conv):
            fan_in = mod.weight[0].numel()
            mod.weight.data = torch.randn(mod.weight.shape, generator=gen) * (
                1.0 / fan_in) ** 0.5
        elif isinstance(mod, BatchNorm):
            c = mod.num_features
            mod.weight.data = 0.8 + 0.4 * torch.rand(c, generator=gen)
            mod.bias.data = 0.05 * torch.randn(c, generator=gen)
            mod.running_mean.data = 0.05 * torch.randn(c, generator=gen)
            mod.running_var.data = 0.8 + 0.4 * torch.rand(c, generator=gen)
        elif isinstance(mod, torch.nn.Linear):
            mod.reset_parameters()


def stage_breakdown(torch, ui, tiles, repeats: int = 3):
    """Median device time of each stage of one request, from CUDA events
    between the stages (the request's own calls, in its order), and the
    host time of the preprocess call (``preprocess_host_us``)."""
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.ops.fused_sepconv import fused_middle_flow
    from biscuit_torch.ops.mcd_head import mcd_head

    names = ("preprocess", "entry_flow", "middle_flow", "exit_flow", "head")
    runs = {name: [] for name in names}
    host = []
    with torch.inference_mode():
        for _ in range(repeats):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            t0 = time.perf_counter()
            x = inference_preprocess(tiles, ui.wsi_normalizer)
            host.append((time.perf_counter() - t0) * 1e6)
            ev[1].record()
            h = ui.model.trunk_entry(x)
            ev[2].record()
            h = fused_middle_flow(h, *ui._mid_wts)
            ev[3].record()
            f = ui.model.trunk_exit(h)
            ev[4].record()
            mcd_head(f, *ui._head_wts, k=ui.k, dropout=ui.model.dropout)
            ev[5].record()
            torch.cuda.synchronize()
            for i, name in enumerate(names):
                runs[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {**{name: statistics.median(v) for name, v in runs.items()},
            "preprocess_host_us": statistics.median(host)}


def kernel_profile(torch, run, top: int = 12, only=None):
    """Device time by kernel name over one call of ``run``
    (torch.profiler); the CPU-side operator events, which repeat their
    kernels' time, are left out. With ``only`` (names), fails if a device
    kernel's name holds none of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    total = sum(us for us, _, _ in rows)
    unit_bwd = sum(us for us, key, _ in rows
                   if any(k in key for k in UNIT_BWD_KERNELS))
    if only is not None:
        stray = [key for _, key, _ in rows if not any(k in key for k in only)]
        check(not stray, f"device kernels outside {only}: {stray}")
    return {"device_ms": total / 1e3, "unit_bwd_kernels_ms": unit_bwd / 1e3,
            "top": [{"kernel": key[:90], "ms": us / 1e3, "calls": n}
                    for us, key, n in rows[:top]]}


def serving_setup(torch, seed: int, n_requests: int):
    """hp.nature2022's model with seeded random weights on the card, and
    n_requests + 1 requests of TILES uint8 tiles (the last one a
    warm-up)."""
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model

    hp = nature2022_params()
    model = build_model(hp)
    init_random_(torch, model, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (TILES, TILE_PX, TILE_PX, 3)
    requests = [torch.randint(0, 256, shape, generator=gen, device="cuda",
                              dtype=torch.uint8)
                for _ in range(n_requests + 1)]
    return hp, model.cuda().eval(), requests


def serve(torch, ui, requests, n_requests: int, per_request: dict):
    """Warm up on the last request, then answer the first n_requests with
    the launch counts zeroed just before and read just after; check the
    counts (per_request launches of each kernel named there, 0 of the
    rest) and the output contract. Returns (outputs, seconds, launches)."""
    from biscuit_torch.ops import _build

    ui(requests[-1])                        # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs, secs = [], []
    for tiles in requests[:n_requests]:
        t0 = time.perf_counter()
        outs.append(ui(tiles))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    for name, count in launches.items():
        want = per_request.get(name, 0) * n_requests
        check(count == want,
              f"{name}: {count} launches for {n_requests} requests, "
              f"expected {want}")
    for mean, std in outs:
        check(tuple(mean.shape) == (TILES, 2) and tuple(std.shape) == (TILES, 2),
              "output shape")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(std).all()),
              "finite outputs")
        check(float((mean.sum(-1) - 1).abs().max()) <= 1e-3, "rows sum to 1")
        check(float(std.min()) >= 0, "std >= 0")
    return outs, secs, launches


def held_features(what: str, got, want):
    """max |got - want| within 3e-2 of want's largest feature: the bf16
    trunk rounds every conv output to bf16 on both paths, and a flipped
    rounding early on moves the pooled features by ~1e-2 relative."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(err <= 3e-2 * scale, f"{what}: max abs err {err} > {3e-2 * scale}")
    return err, scale


def main_path(torch, hp, model, requests, n_requests: int, card: str):
    from biscuit_torch.ops.fused_preprocess import (
        fused_preprocess,
        fused_preprocess_reference,
    )
    from biscuit_torch.ops.fused_sepconv import fused_middle_flow_reference
    from biscuit_torch.ops.mcd_head import mcd_head, mcd_head_reference
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    ui = UncertaintyInterface.from_model(model, hp, device="cuda", seed=SEED)
    check(ui.k == K and ui.hp.dropout == 0.1 and ui.hp.tile_px == TILE_PX,
          "published configuration")
    outs, secs, launches = serve(torch, ui, requests, n_requests,
                                 {name: 1 for name in SERVING})
    with torch.inference_mode():
        from biscuit_torch.ops import library
        from biscuit_torch.ops.mcd_head import seed_tensor

        feats = torch.randn((TILES, 2048), device="cuda", generator=torch
                            .Generator(device="cuda").manual_seed(SEED))
        seed_t = seed_tensor(SEED)
        dispatch = op_dispatch(
            torch, lambda: library.mcd_head(feats, list(ui._head_wts), seed_t,
                                            K, ui.model.dropout),
            lambda: mcd_head(feats, *ui._head_wts, k=K,
                             dropout=ui.model.dropout, seed=seed_t),
            (), len(SERVING), secs)
        del feats
    stage_ms = stage_breakdown(torch, ui, requests[1])
    prof = kernel_profile(torch, lambda: ui(requests[1]))

    # Dropout 0: the kernel path against the plain versions, same model.
    with torch.inference_mode():
        tiles = requests[0]
        xk = fused_preprocess(tiles, ui.wsi_normalizer)
        fk = trunk_features(model, xk, True, ui._mid_wts)
        xp = fused_preprocess_reference(tiles, ui.wsi_normalizer,
                                        torch.bfloat16)
        hp_mid = fused_middle_flow_reference(model.trunk_entry(xp),
                                             *ui._mid_wts)
        fp = model.trunk_exit(hp_mid)
        feat_err, feat_scale = held_features("features", fk, fp)
        km, _ = mcd_head(fk, *ui._head_wts, k=K, dropout=0.0, seed=0)
        rm, _ = mcd_head_reference(fp, *ui._head_wts, k=K, dropout=0.0)
        head_err = (km - rm).abs().max().item()
        check(head_err <= 2e-2, f"dropout-0 mean: max abs err {head_err}")
    return {
        "phase": "main", "model": "xception", "tile_px": TILE_PX, "k": K,
        "dropout": hp.dropout, "hidden": [hp.hidden_layer_width] * 2,
        "requests": n_requests, "tiles_per_request": TILES,
        "request_s": secs, "tiles_per_s": TILES * n_requests / sum(secs),
        "card": card, "launches": launches,
        "mean_of_mean": outs[0][0].mean(0).tolist(),
        "mean_of_std": outs[0][1].mean(0).tolist(),
        "features_max_abs_err": feat_err, "features_tol": 3e-2 * feat_scale,
        "features_max_abs": feat_scale, "dropout0_mean_max_abs_err": head_err,
        "op_dispatch": dispatch, "stage_ms": stage_ms, "profile": prof,
    }, launches


def stage_breakdown_fused(torch, ui, tiles, repeats: int = 3):
    """Median device time of each stage of one request of the fully fused
    trunk, from CUDA events between the stages (the request's own calls,
    in its order), and the host time of the preprocess call."""
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.ops.fused_block import fused_strided_block, trunk_blocks
    from biscuit_torch.ops.fused_sepconv import fused_middle_flow
    from biscuit_torch.ops.mcd_head import mcd_head

    names = ("preprocess", "stem", "entry_blocks", "middle_flow",
             "exit_block", "exit_tail", "head")
    blocks = trunk_blocks(ui.model.backbone)
    runs = {name: [] for name in names}
    host = []
    with torch.inference_mode():
        for _ in range(repeats):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
            ev[0].record()
            t0 = time.perf_counter()
            x = inference_preprocess(tiles, ui.wsi_normalizer)
            host.append((time.perf_counter() - t0) * 1e6)
            ev[1].record()
            h = ui.model.trunk_stem(x).contiguous()
            ev[2].record()
            for blk, wts in zip(blocks[:-1], ui._block_wts[:-1]):
                h = fused_strided_block(h, wts, blk.relu_first)
            ev[3].record()
            h = fused_middle_flow(h, *ui._mid_wts)
            ev[4].record()
            h = fused_strided_block(h, ui._block_wts[-1], blocks[-1].relu_first)
            ev[5].record()
            f = ui.model.trunk_exit_tail(h)
            ev[6].record()
            mcd_head(f, *ui._head_wts, k=ui.k, dropout=ui.model.dropout)
            ev[7].record()
            torch.cuda.synchronize()
            for i, name in enumerate(names):
                runs[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {**{name: statistics.median(v) for name, v in runs.items()},
            "preprocess_host_us": statistics.median(host)}


def main_fused_blocks(torch, hp, model, requests, n_requests: int,
                      card: str):
    """Phase main with ``fuse_blocks=True`` on the same model and
    requests: the fully fused trunk, its launches, output contract, stage
    times, and at dropout 0 its features against the plain-version
    composition and against phase main's default composition."""
    from biscuit_torch.ops.fused_block import (
        fused_strided_block_reference,
        trunk_blocks,
    )
    from biscuit_torch.ops.fused_preprocess import (
        fused_preprocess,
        fused_preprocess_reference,
    )
    from biscuit_torch.ops.fused_sepconv import fused_middle_flow_reference
    from biscuit_torch.ops.mcd_head import mcd_head, mcd_head_reference
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    ui = UncertaintyInterface.from_model(model, hp, device="cuda", seed=SEED,
                                         fuse_blocks=True)
    check(ui._block_wts is not None and len(ui._block_wts) ==
          BLOCKS_PER_REQUEST, "four strided blocks stacked")
    per_request = {name: 1 for name in SERVING}
    per_request["fused_block"] = BLOCKS_PER_REQUEST
    outs, secs, launches = serve(torch, ui, requests, n_requests, per_request)
    with torch.inference_mode():
        from biscuit_torch.ops import library
        from biscuit_torch.ops.fused_block import fused_strided_block

        x = torch.randn((TILES, 19, 19, 728), device="cuda", generator=torch
                        .Generator(device="cuda").manual_seed(SEED)).to(
                            torch.bfloat16)
        exit_wts, relu = ui._block_wts[-1], trunk_blocks(
            model.backbone)[-1].relu_first
        dispatch = op_dispatch(
            torch, lambda: library.fused_strided_block(x, list(exit_wts),
                                                       int(relu)),
            lambda: fused_strided_block(x, exit_wts, relu), (),
            len(SERVING) + BLOCKS_PER_REQUEST, secs)
        del x
    stage_ms = stage_breakdown_fused(torch, ui, requests[1])
    prof = kernel_profile(torch, lambda: ui(requests[1]))

    with torch.inference_mode():
        tiles = requests[0]
        xk = fused_preprocess(tiles, ui.wsi_normalizer)
        fk = trunk_features(model, xk, True, ui._mid_wts, True, ui._block_wts)
        fd = trunk_features(model, xk, True, ui._mid_wts)   # phase main's
        xp = fused_preprocess_reference(tiles, ui.wsi_normalizer,
                                        torch.bfloat16)
        blocks = trunk_blocks(model.backbone)
        h = model.trunk_stem(xp).contiguous()
        for blk, wts in zip(blocks[:-1], ui._block_wts[:-1]):
            h = fused_strided_block_reference(h, wts, blk.relu_first)
        h = fused_middle_flow_reference(h, *ui._mid_wts)
        h = fused_strided_block_reference(h, ui._block_wts[-1],
                                          blocks[-1].relu_first)
        fp = model.trunk_exit_tail(h)
        del h
        plain_err, plain_scale = held_features("fused-block features vs plain",
                                               fk, fp)
        default_err, default_scale = held_features(
            "fused-block features vs the default composition", fk, fd)
        km, _ = mcd_head(fk, *ui._head_wts, k=K, dropout=0.0, seed=0)
        rm, _ = mcd_head_reference(fp, *ui._head_wts, k=K, dropout=0.0)
        head_err = (km - rm).abs().max().item()
        check(head_err <= 2e-2, f"dropout-0 mean: max abs err {head_err}")
    return {
        "phase": "main_fused_blocks", "model": "xception",
        "tile_px": TILE_PX, "k": K, "dropout": hp.dropout,
        "fuse_blocks": True, "requests": n_requests,
        "tiles_per_request": TILES, "request_s": secs,
        "tiles_per_s": TILES * n_requests / sum(secs), "card": card,
        "launches": launches,
        "mean_of_mean": outs[0][0].mean(0).tolist(),
        "mean_of_std": outs[0][1].mean(0).tolist(),
        "features_vs_plain_max_abs_err": plain_err,
        "features_vs_plain_tol": 3e-2 * plain_scale,
        "features_vs_default_max_abs_err": default_err,
        "features_vs_default_tol": 3e-2 * default_scale,
        "dropout0_mean_max_abs_err": head_err,
        "op_dispatch": dispatch, "stage_ms": stage_ms, "profile": prof,
    }, launches


def main_wide_head(torch, hp, requests, card: str):
    """One request of TILES tiles through hp.nature2022's Xception-299 with
    a WIDE_HEAD_CLASSES-class head (seeded random weights): the interface
    routes it to the MC head kernel, and the request launches each
    serving kernel once (counts zeroed just before, read just after).
    Its mean rows sum to 1, and at dropout 0 the kernel's head on its
    features is within 1e-3 of the plain version's."""
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.models.xception import XceptionClassifier
    from biscuit_torch.ops import _build
    from biscuit_torch.ops.mcd_head import mcd_head, mcd_head_reference
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    c = WIDE_HEAD_CLASSES
    model = XceptionClassifier(
        arch="xception", num_classes=c, hidden_layers=hp.hidden_layers,
        hidden_width=hp.hidden_layer_width, dropout=hp.dropout,
        compute_dtype=torch.bfloat16 if hp.compute_dtype == "bfloat16"
        else torch.float32)
    init_random_(torch, model, SEED)
    ui = UncertaintyInterface.from_model(model.cuda().eval(), hp,
                                         device="cuda", seed=SEED)
    check(ui._use_kernel, f"a {c}-class head routes to the MC head kernel")
    ui(requests[-1])                        # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    mean, std = ui(requests[0])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _build.launch_counts()
    for name, count in launches.items():
        want = 1 if name in SERVING else 0
        check(count == want, f"{name}: {count} launches for one {c}-class "
                             f"request, expected {want}")
    check(tuple(mean.shape) == (TILES, c) and tuple(std.shape) == (TILES, c),
          f"{c}-class output shape")
    check(bool(torch.isfinite(mean).all() and torch.isfinite(std).all()),
          f"{c}-class outputs finite")
    row_sum_err = float((mean.sum(-1) - 1).abs().max())
    check(row_sum_err <= 1e-3, f"{c}-class mean rows sum to 1")
    check(float(std.min()) >= 0, f"{c}-class std >= 0")
    with torch.inference_mode():
        x = inference_preprocess(requests[0], ui.wsi_normalizer)
        feats = trunk_features(ui.model, x, True, ui._mid_wts)
        km, _ = mcd_head(feats, *ui._head_wts, k=K, dropout=0.0)
        rm, _ = mcd_head_reference(feats, *ui._head_wts, k=K, dropout=0.0)
        head_err = (km - rm).abs().max().item()
    check(head_err <= 1e-3, f"{c}-class dropout-0 head: max abs err "
                            f"{head_err}")
    del ui, model
    return {"phase": "main_wide_head", "classes": c, "tile_px": TILE_PX,
            "k": K, "dropout": hp.dropout, "tiles_per_request": TILES,
            "request_s": secs, "tiles_per_s": TILES / secs, "card": card,
            "launches": launches, "row_sum_max_abs_err": row_sum_err,
            "dropout0_head_max_abs_err": head_err,
            "mean_of_std": float(std.mean())}, launches


def main_f32(torch, requests, n_requests: int, bf16_rows, tf32_default,
             card: str):
    """Phase main_f32: hp.nature2022 with ``compute_dtype="float32"`` (the
    published Xception-299 at full width and depth, 2x1024 head, dropout
    0.1, K) with seeded random weights answers the same n_requests
    requests through ``UncertaintyInterface``, default trunk then
    ``fuse_blocks=True``: rows 1-3 once a request and row 4 four times
    with ``fuse_blocks`` (counts zeroed just before, read just after);
    the f32 features of the kernels' trunk on request 0 within 3e-2 of
    the largest of ``model.features`` (the module trunk in f32, TF32 off)
    on the same preprocessed tiles, since the kernels round every
    pointwise product's input (34 units) and the blocks' y1 to bf16,
    about 2**-9 each, where the module trunk rounds nothing; with the
    logits spread over those features (``decisive_logits_``), the
    dropout-0 means of the kernel head on them within 2e-2 of the plain
    head on the module features, spread over 0.2 or more. It prints
    tiles/s and ``stage_ms`` beside the bf16 rows' tiles/s of this run,
    and tiles/s once more with TF32 as the library had it at start-up
    (``tf32_default``: matmul, cuDNN), since the port leaves that setting
    to its caller."""
    import dataclasses

    from biscuit_torch.data.normalize import (
        inference_preprocess,
        make_normalizer,
    )
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.ops.mcd_head import mcd_head, mcd_head_reference
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    hp = dataclasses.replace(nature2022_params(), compute_dtype="float32")
    model = build_model(hp)
    init_random_(torch, model, SEED)
    model = model.cuda().eval()
    check(model.compute_dtype == torch.float32, "an f32 model")
    with torch.inference_mode():
        x0 = inference_preprocess(requests[0], make_normalizer(hp.normalizer))
        fm = model.features(x0)
    decisive_logits_(torch, model, fm)
    row = {"phase": "main_f32", "model": "xception", "compute_dtype":
           "float32", "tile_px": TILE_PX, "k": K, "dropout": hp.dropout,
           "requests": n_requests, "tiles_per_request": TILES, "card": card,
           "bf16_tiles_per_s": {r["phase"]: r["tiles_per_s"]
                                for r in bf16_rows}}
    total = {}
    for fuse in (False, True):
        ui = UncertaintyInterface.from_model(model, hp, device="cuda",
                                             seed=SEED, fuse_blocks=fuse)
        check(ui.k == K and ui._fused and ui._use_kernel,
              "the f32 model routes to the kernels")
        per_request = {name: 1 for name in SERVING}
        if fuse:
            per_request["fused_block"] = BLOCKS_PER_REQUEST
        outs, secs, launches = serve(torch, ui, requests, n_requests,
                                     per_request)
        add_launches(total, launches)
        flags = torch.backends.cuda.matmul, torch.backends.cudnn
        off = tuple(f.allow_tf32 for f in flags)
        for f, on in zip(flags, tf32_default):
            f.allow_tf32 = on
        try:
            _, tf32_secs, tf32_launches = serve(torch, ui, requests,
                                                n_requests, per_request)
        finally:
            for f, on in zip(flags, off):
                f.allow_tf32 = on
        add_launches(total, tf32_launches)
        stage_ms = (stage_breakdown_fused if fuse else stage_breakdown)(
            torch, ui, requests[1])
        prof = kernel_profile(torch, lambda: ui(requests[1]))
        with torch.inference_mode():
            fk = trunk_features(model, x0, True, ui._mid_wts, fuse,
                                ui._block_wts)
            check(fk.dtype == torch.float32, "f32 features")
            feat_err, feat_scale = held_features(
                f"f32 features (fuse_blocks={fuse}) vs model.features", fk,
                fm)
            km, _ = mcd_head(fk, *ui._head_wts, k=K, dropout=0.0, seed=0)
            rm, _ = mcd_head_reference(fm, *ui._head_wts, k=K, dropout=0.0)
            spread = float(rm[:, 1].max() - rm[:, 1].min())
            head_err = (km - rm).abs().max().item()
        check(spread > 0.2, f"f32 dropout-0 means spread {spread}")
        check(head_err <= 2e-2, f"f32 dropout-0 mean: max abs err {head_err}")
        row["fuse_blocks" if fuse else "default"] = {
            "request_s": secs, "tiles_per_s": TILES * n_requests / sum(secs),
            "launches": launches,
            "tf32_default": {
                "matmul": tf32_default[0], "cudnn": tf32_default[1],
                "request_s": tf32_secs,
                "tiles_per_s": TILES * n_requests / sum(tf32_secs)},
            "mean_of_mean": outs[0][0].mean(0).tolist(),
            "mean_of_std": outs[0][1].mean(0).tolist(),
            "features_max_abs_err": feat_err,
            "features_tol": 3e-2 * feat_scale, "features_max_abs": feat_scale,
            "dropout0_mean_max_abs_err": head_err,
            "dropout0_mean_spread": spread, "stage_ms": stage_ms,
            "profile": prof}
        del ui
        torch.cuda.empty_cache()
    del model, x0, fm
    torch.cuda.empty_cache()
    return row, total


def smooth_tiles(n: int, seed: int):
    """n smooth random colour fields with mild noise, uint8 (n, TILE_PX,
    TILE_PX, 3): four plane waves a tile mixed into RGB about a random
    base colour, and noise of +-2 levels. Unlike uniform noise they
    compress (about 200 KB a PNG with filter 0, so the Python CRC of the
    tfrecord writer takes seconds, not minutes), and no tile is constant
    (a constant tile's standardization amplifies rounding noise)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = (2 * np.pi / TILE_PX) * np.arange(TILE_PX, dtype=np.float32)
    out = np.empty((n, TILE_PX, TILE_PX, 3), np.uint8)
    for i in range(n):
        fy, fx = rng.uniform(-2, 2, (2, 4, 1)).astype(np.float32) * pos
        fy += rng.uniform(0, 2 * np.pi, (4, 1)).astype(np.float32)
        # cos(fy + fx), wave by wave, as products of row and column terms.
        waves = (np.cos(fy)[:, :, None] * np.cos(fx)[:, None, :]
                 - np.sin(fy)[:, :, None] * np.sin(fx)[:, None, :])
        field = waves.reshape(4, -1).T @ rng.uniform(
            -30, 30, (4, 3)).astype(np.float32)
        field += rng.uniform(90, 170, 3).astype(np.float32)
        field += rng.integers(-2, 3, field.shape, dtype=np.int8)
        out[i] = np.clip(np.rint(field), 0, 255).reshape(TILE_PX, TILE_PX, 3)
    return out


def write_tfrecords(tiles, directory: str):
    """One tfrecord a slide of PREDICT_LABELS, PREDICT_TILES PNG tiles
    each (filter 0), by the port's writer; returns the paths, the labels
    and the bytes written."""
    import os

    from biscuit_torch.data.tfrecord import TFRecordWriter

    os.makedirs(directory)
    paths, n_bytes = [], 0
    for s in range(len(PREDICT_LABELS)):
        paths.append(os.path.join(directory, f"slide{s}.tfrecords"))
        with TFRecordWriter(paths[-1]) as w:
            for t in range(PREDICT_TILES):
                w.write_tile(f"slide{s}",
                             encode_png(tiles[s * PREDICT_TILES + t]),
                             loc_x=TILE_PX * (t % 10),
                             loc_y=TILE_PX * (t // 10))
        n_bytes += os.path.getsize(paths[-1])
    labels = {f"slide{s}": y for s, y in enumerate(PREDICT_LABELS)}
    return paths, labels, n_bytes


def decode_ms_by_filter(tile, repeats: int = 5) -> dict:
    """Median host ms to decode one tile by ``data/png.decode_png`` and,
    where it is installed, by Pillow (``Image.open(...).convert("RGB")``),
    with each row filter forced on every row and as Pillow writes it (a
    filter chosen row by row), and the PNG's size."""
    import io

    from biscuit_torch.data.png import decode_png

    decoders = {"ms": decode_png}
    if importlib.util.find_spec("PIL") is not None:
        import numpy as np
        from PIL import Image

        decoders["pillow_ms"] = lambda raw: np.asarray(
            Image.open(io.BytesIO(raw)).convert("RGB"))
        buf = io.BytesIO()
        Image.fromarray(tile).save(buf, format="PNG")
    encodings = [(name, encode_png(tile, kind)) for name, kind in (
        ("none", 0), ("sub", 1), ("up", 2), ("average", 3), ("paeth", 4))]
    if "pillow_ms" in decoders:
        encodings.append(("pillow_written", buf.getvalue()))
    out = {}
    for name, raw in encodings:
        out[name] = {"png_kb": len(raw) / 1e3}
        for key, decode in decoders.items():
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                img = decode(raw)
                times.append((time.perf_counter() - t0) * 1e3)
                check(img.tobytes() == tile.tobytes(),
                      f"PNG {name}: {key} decode")
            out[name][key] = statistics.median(times)
    return out


def decisive_logits_(torch, model, feats, span: float = 2.0) -> None:
    """Set the logits layer of ``model``'s head so that, at dropout 0,
    its class-1 probabilities spread over the tiles whose pooled features
    are the rows of ``feats``: the logit difference is s (h . w - c), w
    the first principal direction of the last hidden layer h on ``feats``,
    c the median of h . w and s = span / (its max - min), so with span 2
    the probabilities run from about 0.27 to 0.73. A random head gives
    every tile about 0.5, where a wrong kernel, or a tile scored in
    another's row, stays within a probability tolerance of 2e-2."""
    head = model.head
    with torch.no_grad():
        h = feats.float()
        for i in range(head.hidden_layers):
            h = torch.relu(getattr(head, f"hidden{i}")(h))
        h = h.double()
        w = torch.linalg.svd(h - h.mean(0), full_matrices=False).Vh[0]
        score = h @ w
        s = span / (score.max() - score.min())
        c = score.median()
        head.logits.weight.copy_(torch.stack([-w, w]) * s / 2)
        head.logits.bias.copy_(torch.stack([c, -c]) * s / 2)


def predict_phase(torch, hp, model, tmp: str, card: str):
    """Main-path steps 1-6 from disk: PREDICT_TILES tiles of each of the
    PREDICT_LABELS slides written as PNG tfrecords, then scored by
    ``score_tiles`` (hp with uq=True at K), with the default and the
    ``fuse_blocks`` trunk, each with its launch counts zeroed just before
    its timed call and read just after; the rows and outputs checked; the
    pooled features of each batch the path gives the kernels (the last
    with 44 real rows) held against the plain-version path; and, with the
    logits layer set so the probabilities spread (``decisive_logits_``),
    the dropout-0 means of both trunks against the plain-version path.
    Also times the batcher alone (host read + decode), the interface on
    the same batches already on the card (device time) and the PNG
    decoders by filter."""
    import dataclasses
    import os

    import numpy as np

    from biscuit_torch.data.pipeline import TileBatcher
    from biscuit_torch.ops import _build
    from biscuit_torch.ops.fused_preprocess import (
        fused_preprocess,
        fused_preprocess_reference,
    )
    from biscuit_torch.ops.fused_sepconv import fused_middle_flow_reference
    from biscuit_torch.train.trainer import score_tiles
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    hp = dataclasses.replace(hp, uq=True, uq_samples=K)
    n = len(PREDICT_LABELS) * PREDICT_TILES
    t0 = time.perf_counter()
    tiles = smooth_tiles(n, SEED)
    tiles_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths, labels, n_bytes = write_tfrecords(tiles, os.path.join(tmp, "tfr"))
    write_s = time.perf_counter() - t0

    for fuse in (False, True):                  # warm-up
        score_tiles(model, hp, paths, labels, fuse_blocks=fuse)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = list(TileBatcher(paths, labels, hp.batch_size, shuffle=False,
                               tile_px=TILE_PX))
    host_s = time.perf_counter() - t0
    masks = [b["mask"] for b in batches]
    check(np.concatenate([b["image"][m] for b, m in zip(batches, masks)])
          .tobytes() == tiles.tobytes(), "decoded tiles equal the written")

    t = np.arange(n) % PREDICT_TILES
    runs = {}
    for fuse in (False, True):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rows, probs, unc = score_tiles(model, hp, paths, labels,
                                       fuse_blocks=fuse)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _build.launch_counts()
        for name, count in launches.items():
            want = len(batches) if name in SERVING else 0
            if fuse and name == "fused_block":
                want = BLOCKS_PER_REQUEST * len(batches)
            check(count == want, f"{name}: {count} launches for "
                                 f"{len(batches)} batches from tfrecords "
                                 f"(fuse_blocks={fuse}), expected {want}")
        check(list(rows["slide"]) == [f"slide{i // PREDICT_TILES}"
                                      for i in range(n)],
              "rows in tfrecord order")
        check(np.array_equal(rows["loc_x"], TILE_PX * (t % 10))
              and np.array_equal(rows["loc_y"], TILE_PX * (t // 10)),
              "locations as written")
        check(np.array_equal(rows["y_true"], np.repeat(PREDICT_LABELS,
                                                       PREDICT_TILES)),
              "y_true from the labels")
        check(probs.shape == unc.shape == (n, 2), "output shape")
        check(bool(np.isfinite(probs).all() and np.isfinite(unc).all()),
              "finite outputs")
        check(float(np.abs(probs.sum(1) - 1).max()) <= 1e-3, "rows sum to 1")
        check(float(unc.min()) >= 0, "std >= 0")
        runs[fuse] = {"score_tiles_s": secs, "tiles_per_s_from_disk": n / secs,
                      "launches": launches,
                      "mean_of_mean": probs.mean(0).tolist(),
                      "mean_of_std": unc.mean(0).tolist()}

    # Device time of the same batches: the interface score_tiles builds,
    # called back to back on the batches already on the card.
    on_card = [torch.from_numpy(b["image"]).cuda() for b in batches]
    for fuse in (False, True):     # leaves ui the fuse_blocks interface
        ui = UncertaintyInterface.from_model(model, hp, k=K, device="cuda",
                                             seed=42, fuse_blocks=fuse)
        ui(on_card[0])
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(on_card) + 1)]
        ev[0].record()
        for i, x in enumerate(on_card):
            ui(x)
            ev[i + 1].record()
        torch.cuda.synchronize()
        runs[fuse]["device_ms"] = [ev[i].elapsed_time(ev[i + 1])
                                   for i in range(len(on_card))]
        runs[fuse]["device_s"] = sum(runs[fuse]["device_ms"]) / 1e3

    # The pooled features of each batch as the path gives it to the
    # kernels (128, 128, then 44 real rows of 128), both trunks against
    # the plain versions, on the real rows (padding rows are constant
    # tiles, whose standardization amplifies rounding noise).
    feat = {"default": [], "fuse_blocks": []}
    plain_feats = []
    with torch.inference_mode():
        for i, (x, m) in enumerate(zip(on_card, masks)):
            m = torch.from_numpy(m).cuda()
            xk = fused_preprocess(x, ui.wsi_normalizer)
            xp = fused_preprocess_reference(x, ui.wsi_normalizer,
                                            torch.bfloat16)
            fp = model.trunk_exit(fused_middle_flow_reference(
                model.trunk_entry(xp), *ui._mid_wts))[m]
            for name, fk in (
                    ("default", trunk_features(model, xk, True, ui._mid_wts)),
                    ("fuse_blocks", trunk_features(model, xk, True,
                                                   ui._mid_wts, True,
                                                   ui._block_wts))):
                err, scale = held_features(
                    f"batch {i} ({int(m.sum())} rows), {name} features",
                    fk[m], fp)
                feat[name].append({"rows": int(m.sum()), "max_abs_err": err,
                                   "tol": 3e-2 * scale})
            plain_feats.append(fp)
    del on_card, xk, xp

    # Dropout 0, with probabilities that differ by tile: score_tiles
    # against the plain-version path (the exact f32 preprocess of float
    # tiles, library convs, the module head).
    decisive_logits_(torch, model, torch.cat(plain_feats))
    del plain_feats
    model.dropout = model.head.dropout = 0.0
    plain = UncertaintyInterface.from_model(model, hp, k=K, device="cuda",
                                            use_kernel=False,
                                            fused_trunk=False)
    want0 = np.concatenate([
        plain(torch.from_numpy(tiles[i:i + hp.batch_size]).cuda().float())[0]
        .cpu().numpy() for i in range(0, n, hp.batch_size)])
    spread = float(np.ptp(want0[:, 1]))
    check(spread > 0.2, f"dropout-0 probabilities spread {spread} <= 0.2")
    for fuse in (False, True):
        _, p0, _ = score_tiles(model, hp, paths, labels, fuse_blocks=fuse)
        err0 = float(np.abs(p0 - want0).max())
        check(err0 <= 2e-2, f"dropout-0 mean from tfrecords "
                            f"(fuse_blocks={fuse}): max abs err {err0}")
        runs[fuse]["dropout0_mean_max_abs_err"] = err0
    model.dropout = model.head.dropout = hp.dropout
    return {
        "phase": "predict", "model": "xception", "tile_px": TILE_PX, "k": K,
        "dropout": hp.dropout, "slides": len(PREDICT_LABELS),
        "tiles": n, "batch": hp.batch_size, "batches": len(batches),
        "last_batch_rows": int(masks[-1].sum()),
        "tiles_gen_s": tiles_s, "write_s": write_s, "bytes_written": n_bytes,
        "host_read_decode_s": host_s, **runs[False],
        "fuse_blocks": runs[True], "features": feat,
        "dropout0_ptp": spread,
        "dropout0_min_dist_to_half": float(np.abs(want0[:, 1] - 0.5).min()),
        "dropout0_tol": 2e-2,
        "decode_by_filter": decode_ms_by_filter(tiles[0]), "card": card,
    }


def evaluate_phase(torch, hp, model, tmp: str, card: str):
    """``evaluate_project`` over phase predict's tfrecords in a Project
    built in ``tmp``, then ``threshold.apply`` on its tile frame at a
    fixed tile threshold (the median uncertainty). Needs pandas."""
    import dataclasses
    import os

    import pandas as pd

    from biscuit_torch import threshold, utils
    from biscuit_torch.project import Project
    from biscuit_torch.train.evaluate import evaluate_project
    from biscuit_torch.train.trainer import save_checkpoint

    hp = dataclasses.replace(hp, uq=True, uq_samples=K)
    model_path = save_checkpoint(os.path.join(tmp, "models"), model, hp, 1,
                                 OUTCOME, "smoke", None)
    ann = os.path.join(tmp, "annotations.csv")
    pd.DataFrame({"patient": [f"patient{s}" for s in range(3)],
                  "slide": [f"slide{s}" for s in range(3)],
                  OUTCOME: [f"class{y}" for y in PREDICT_LABELS]}).to_csv(
                      ann, index=False)
    project = Project(os.path.join(tmp, "project"), annotations=ann,
                      name="smoke", create=True)
    project.add_source("smoke", tfrecords=os.path.join(tmp, "tfr"))
    t0 = time.perf_counter()
    res = evaluate_project(project, model_path, OUTCOME)
    secs = time.perf_counter() - t0
    files = {"results_log.csv", "tile_predictions_eval.csv",
             f"slide_predictions_{OUTCOME}_eval.csv",
             f"patient_predictions_{OUTCOME}_eval.csv"}
    check(set(os.listdir(res["eval_dir"])) == files, "the eval-dir files")
    tiles = pd.read_csv(os.path.join(res["eval_dir"],
                                     "tile_predictions_eval.csv"))
    check(len(tiles) == len(PREDICT_LABELS) * PREDICT_TILES, "tile rows")
    utils.rename_cols(tiles, OUTCOME)
    tile_uq = float(tiles["uncertainty"].median())
    results, _ = threshold.apply(tiles, tile_uq=tile_uq, slide_uq=None)
    check(set(results) == {"auc", "percent_incl", "acc", "sensitivity",
                           "specificity"}, "threshold.apply's keys")
    check(0 < results["percent_incl"] <= 1, "percent_incl in (0, 1]")
    return {"phase": "evaluate", "eval_dir": os.path.basename(
                res["eval_dir"]), "seconds": secs,
            **{k: list(res[k]) for k in ("tile", "slide", "patient")},
            "tile_uq": tile_uq,
            "apply": {k: float(v) for k, v in results.items()},
            "card": card}


def train_batch(torch, gen, n: int):
    """Random uint8 tiles, 0/1 labels and a full mask on the card."""
    tiles = torch.randint(0, 256, (n, TILE_PX, TILE_PX, 3), generator=gen,
                          device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 2, (n,), generator=gen, device="cuda")
    return tiles, labels, torch.ones(n, device="cuda")


def running_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if "running_" in k}


def gradient_check(torch, model0, hp, normalizer, gen):
    """One step of the kernel path (unit backwards on the strip kernel)
    and one of the plain-version path from the same weights and batch,
    augment off and dropout 0; their gradients compared tensor by
    tensor (not the updated weights: Adam's first step is about
    lr * sign(g), which turns rounding noise into full-size steps)."""
    import copy

    from biscuit_torch.train.trainer import make_optimizer, make_train_step

    hp = hp.copy()
    hp.augment, hp.dropout = "", 0.0
    batch = train_batch(torch, gen, CHECK_BATCH)
    grads, losses = {}, {}
    for backend in ("auto", "reference"):
        m = copy.deepcopy(model0).cuda()
        m.head.dropout = 0.0
        step = make_train_step(m, make_optimizer(hp, m.parameters()), hp,
                               normalizer, fused_trunk=True, backend=backend)
        losses[backend] = float(step(*batch, gen)["loss"])
        grads[backend] = {n: p.grad.detach().clone()
                          for n, p in m.named_parameters()}
        del m, step
    want, got = grads["reference"], grads["auto"]
    tree_max = max(g.abs().max().item() for g in want.values())
    # The two paths run the same forward; the kernel sums in another
    # order and factors the BN backward as the TPU kernel does, so bf16
    # roundings of gp and da flip here and there and move through 34
    # units: 5e-2 of each tensor's largest value. A tensor whose plain
    # gradient is near zero (largest value under 1e-2 of the tree's
    # largest) carries noise on the scale of the gradients it is summed
    # from, not its own, and is held to 1e-3 of the tree's largest
    # gradient instead; those tensors are listed in the line.
    tol, near_zero, floor = 5e-2, 1e-2, 1e-3
    worst = {"rel": 0.0, "name": None}
    floor_only, failed = {}, {}
    for name, w in want.items():
        check(bool(torch.isfinite(got[name]).all()), f"{name} grad finite")
        scale = w.abs().max().item()
        diff = (got[name] - w).abs().max().item()
        rel = diff / max(scale, 1e-30)
        entry = {"rel": rel, "max_over_tree_max": scale / tree_max,
                 "diff_over_tree_max": diff / tree_max}
        if rel <= tol:
            if rel > worst["rel"]:
                worst = {"rel": rel, "name": name}
        elif scale <= near_zero * tree_max and diff <= floor * tree_max:
            floor_only[name] = entry
        else:
            failed[name] = entry
    check(not failed, f"gradients beyond tolerance: {failed}")
    check(abs(losses["auto"] - losses["reference"])
          <= 1e-6 * abs(losses["reference"]), f"same forward: {losses}")
    return {"batch": CHECK_BATCH, "loss": losses["auto"],
            "loss_plain": losses["reference"], "tensors": len(want),
            "tol": tol, "near_zero_of_tree_max": near_zero,
            "floor_of_tree_max": floor, "tree_max": tree_max,
            "worst_rel_err": worst["rel"], "worst_tensor": worst["name"],
            "passed_on_floor_only": floor_only}


def train_path(torch, seed: int, card: str):
    """The training step of hp.nature2022 on the card (see the module
    docstring); returns (the train line, strip launches, plane launches)."""
    import copy
    import math

    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.flops import (
        H100_PEAK_BF16,
        train_flops_per_tile,
    )
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.ops import _build
    from biscuit_torch.train.trainer import make_optimizer, make_train_step

    hp = nature2022_params()
    check(hp.batch_size == TRAIN_BATCH and hp.augment == "xyrjb"
          and hp.dropout == 0.1 and hp.tile_px == TILE_PX
          and hp.optimizer == "Adam" and hp.learning_rate == 1e-4
          and hp.compute_dtype == "bfloat16", "published configuration")
    normalizer = make_normalizer(hp.normalizer)
    model0 = build_model(hp)
    init_random_(torch, model0, seed)
    model = copy.deepcopy(model0).cuda()
    tx = make_optimizer(hp, model.parameters())
    step = make_train_step(model, tx, hp, normalizer)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = [train_batch(torch, gen, TRAIN_BATCH)
               for _ in range(TRAIN_STEPS + 1)]
    step(*batches[-1], gen)                 # warm-up (cuDNN plans, build)
    torch.cuda.synchronize()
    before = running_stats(model)
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launch_counts()
    outs, secs = [], []
    for b in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        outs.append(step(*b, gen))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, count in launches.items():
        want = train_launches(TRAIN_STEPS).get(name, 0)
        check(count == want, f"{name}: {count} launches in {TRAIN_STEPS} "
                             f"training steps, expected {want}")
    losses = [float(o["loss"]) for o in outs]
    accs = [float(o["acc"]) for o in outs]
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    check(all(0.0 <= a <= 1.0 for a in accs), f"accuracies in [0, 1] {accs}")
    after = running_stats(model)
    check(all(not torch.equal(before[k], after[k]) for k in before),
          "every running statistic changed")
    check(all(bool(torch.isfinite(v).all()) for v in after.values())
          and all(bool(torch.isfinite(p).all()) for p in model.parameters()),
          "finite weights and statistics")
    tiles_s = TRAIN_BATCH * TRAIN_STEPS / sum(secs)
    flops = train_flops_per_tile(hp.model, hp.tile_px, hp.hidden_layer_width,
                                 hp.hidden_layers)
    prof = kernel_profile(torch, lambda: step(*batches[0], gen), top=15)

    plane_step = make_train_step(model, tx, hp, normalizer, backend="plane")
    _build.reset_launch_counts()
    plane_loss = float(plane_step(*batches[1], gen)["loss"])
    torch.cuda.synchronize()
    plane_launches = _build.launch_counts()
    for name, count in plane_launches.items():
        want = train_launches(1, unit_bwd="unit_bwd_plane").get(name, 0)
        check(count == want, f"{name}: {count} launches in the plane-kernel "
                             f"step, expected {want}")
    check(math.isfinite(plane_loss), "plane-kernel step: finite loss")
    del step, plane_step, batches, outs, tx, model
    torch.cuda.empty_cache()

    grad_check = gradient_check(torch, model0, hp, normalizer, gen)
    return {
        "phase": "train", "model": hp.model, "tile_px": hp.tile_px,
        "batch": TRAIN_BATCH, "augment": hp.augment, "dropout": hp.dropout,
        "optimizer": hp.optimizer, "learning_rate": hp.learning_rate,
        "steps": TRAIN_STEPS, "step_s": secs,
        "steps_per_s": TRAIN_STEPS / sum(secs), "tiles_per_s": tiles_s,
        "train_flops_per_tile": flops,
        "mfu_bf16": flops * tiles_s / H100_PEAK_BF16,
        "max_memory_allocated_bytes": peak, "card": card,
        "losses": losses, "accs": accs, "launches": launches,
        "plane_step": {"loss": plane_loss, "launches": plane_launches},
        "gradient_check": grad_check, "profile": prof,
    }, launches, plane_launches


def write_project(tmp: str, name: str, n_slides: int, n_tiles: int,
                  seed: int, classes):
    """A Project ``name`` in ``tmp``: ``n_tiles`` smooth tiles for each of
    ``n_slides`` slides, slide s of class ``classes[s % 2]``, site s // 2
    and its own patient, as PNG tfrecords by the port's writer, with an
    annotations CSV; returns (project, seconds to write)."""
    import os

    import pandas as pd

    from biscuit_torch.data.tfrecord import TFRecordWriter
    from biscuit_torch.project import Project

    t0 = time.perf_counter()
    tiles = smooth_tiles(n_slides * n_tiles, seed)
    tfr = os.path.join(tmp, f"{name}_tfr")
    os.makedirs(tfr)
    for s in range(n_slides):
        with TFRecordWriter(os.path.join(tfr, f"{name}{s}.tfrecords")) as w:
            for t in range(n_tiles):
                w.write_tile(f"{name}{s}", encode_png(tiles[s * n_tiles + t]),
                             loc_x=TILE_PX * (t % 8), loc_y=TILE_PX * (t // 8))
    ann = os.path.join(tmp, f"{name}_annotations.csv")
    pd.DataFrame({"patient": [f"{name}p{s}" for s in range(n_slides)],
                  "slide": [f"{name}{s}" for s in range(n_slides)],
                  OUTCOME: [classes[s % 2] for s in range(n_slides)],
                  "site": [f"{name}site{s // 2}" for s in range(n_slides)]}
                 ).to_csv(ann, index=False)
    project = Project(os.path.join(tmp, name), annotations=ann, name=name,
                      create=True)
    project.add_source(name, tfrecords=tfr)
    return project, time.perf_counter() - t0


def check_model_dir(model_dir: str, k, epochs, log_steps, hp):
    """The model-dir contract of one fold (SURVEY.md §2.4) for the
    recorded ``epochs``: manifest, params.json, the prediction CSVs with
    finite probabilities, the six AUC/AP columns, the epoch checkpoints,
    and a train log of ``log_steps`` with finite losses; returns the rows
    of the results and train logs."""
    import os

    import numpy as np
    import pandas as pd

    files = set(os.listdir(model_dir))
    base = f"{OUTCOME}-smoke-HP0-kfold{k}"
    want = {"slide_manifest.csv", "params.json", "train_log.csv",
            "results_log.csv", "ckpt"}
    for e in epochs:
        want |= {f"tile_predictions_val_epoch{e}.csv",
                 f"patient_predictions_{OUTCOME}_val_epoch{e}.csv",
                 f"slide_predictions_{OUTCOME}_val_epoch{e}.csv",
                 f"{base}_epoch{e}"}
    check(want <= files, f"fold {k}: missing {sorted(want - files)}")
    man = pd.read_csv(os.path.join(model_dir, "slide_manifest.csv"))
    val = sorted(man.loc[man["dataset"] == "validation", "slide"])
    check(len(man) == TP_SLIDES and len(val) == 2
          and {int(v[-1]) % 2 for v in val} == {0, 1}
          and len({int(v[-1]) // 2 for v in val}) == 1,
          f"fold {k}: manifest {man.to_dict('list')}")
    with open(os.path.join(model_dir, "params.json")) as f:
        meta = json.load(f)
    check(meta["kfold"] == k and meta["hp"] == hp.to_dict()
          and meta["outcome_labels"] == ["class0", "class1"],
          f"fold {k}: params.json")
    log = pd.read_csv(os.path.join(model_dir, "results_log.csv"))
    check(list(log["model_name"]) == [f"{OUTCOME}-smoke-HP0_epoch{e}"
                                      for e in epochs],
          f"fold {k}: results_log rows {list(log['model_name'])}")
    for col in ("patient_auc", "patient_ap", "slide_auc", "slide_ap",
                "tile_auc", "tile_ap"):
        for cell in log[col]:
            (v,) = json.loads(cell)[OUTCOME]
            check(0.0 <= v <= 1.0, f"fold {k}: {col} {v}")
    for e in epochs:
        tiles = pd.read_csv(os.path.join(
            model_dir, f"tile_predictions_val_epoch{e}.csv"))
        p = tiles[[f"{OUTCOME}_y_pred0", f"{OUTCOME}_y_pred1"]].to_numpy()
        u = tiles[[f"{OUTCOME}_uncertainty0",
                   f"{OUTCOME}_uncertainty1"]].to_numpy()
        check(len(tiles) == 2 * TP_TILES and sorted(set(tiles["slide"]))
              == val, f"fold {k} epoch {e}: tile rows")
        check(bool(np.isfinite(p).all() and np.isfinite(u).all()
                   and np.abs(p.sum(1) - 1).max() <= 1e-3
                   and u.min() >= 0), f"fold {k} epoch {e}: tile values")
        for f in ("model.msgpack", "params.json"):
            check(os.path.exists(os.path.join(model_dir, f"{base}_epoch{e}",
                                              f)), f"fold {k}: {f}")
    train_log = pd.read_csv(os.path.join(model_dir, "train_log.csv"))
    check(list(train_log["step"]) == log_steps
          and bool(np.isfinite(train_log["loss"]).all()),
          f"fold {k}: train_log {train_log.to_dict('list')}")
    return log.to_dict("records"), train_log.to_dict("records")


def train_project_phase(torch, tmp: str, card: str):
    """``Project.train`` of hp.nature2022 (Xception-299 bf16, 2x1024,
    dropout 0.1, 'xyrjb', batch 128) with uq=True at K, early stopping
    on, 3-fold, on TP_SLIDES slides of TP_TILES tiles: TP_STEPS
    steps an epoch over TP_EPOCHS, a validation check of one batch and an
    in-run checkpoint every TP_STEPS steps, the epoch models saved. The
    folds run as three calls with ``val_k=[k]``, which is what one call
    does fold by fold, each with the launch counts zeroed just before and
    read just after: 34 strip-kernel launches a step, rows 1-3 once for
    each validation batch of each recorded epoch, nothing else. Each
    fold's model dir is checked; fold 1's last epoch model, loaded by
    ``UncertaintyInterface``, rescored on the validation tiles, gives its
    CSV's values. Then fold 1 is relaunched without its results log and
    its newest checkpoint: it reuses the dir, resumes at step TP_STEPS
    (epoch 1 covered) and records epoch 2. Also times the host's read +
    decode of the training batches, the step's device time on the same
    batches already on the card, and one in-run and one epoch save."""
    import dataclasses
    import gc
    import os
    import shutil

    import numpy as np
    import pandas as pd

    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.data.pipeline import TileBatcher
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.ops import _build
    from biscuit_torch.train.checkpoint import RunCheckpointer
    from biscuit_torch.train.trainer import (
        init_model,
        make_optimizer,
        make_train_step,
        save_checkpoint,
        score_tiles,
    )
    from biscuit_torch.train.uq import UncertaintyInterface

    hp = dataclasses.replace(nature2022_params(), uq=True, uq_samples=K,
                             epochs=list(TP_EPOCHS), ema_observations=1)
    check(hp.batch_size == TRAIN_BATCH and hp.augment == "xyrjb"
          and hp.dropout == 0.1 and hp.model == "xception"
          and hp.early_stop and hp.compute_dtype == "bfloat16",
          "published configuration")
    project, write_s = write_project(tmp, "tp", TP_SLIDES, TP_TILES,
                                     SEED + 1, ("class0", "class1"))
    kw = dict(params=hp, val_k_fold=TP_FOLDS,
              steps_per_epoch_override=TP_STEPS, validate_on_batch=TP_STEPS,
              validation_steps=1, save_model=True, checkpoint_every=TP_STEPS)
    steps = TP_STEPS * max(TP_EPOCHS)
    total = {}
    folds = []
    for k in range(1, TP_FOLDS + 1):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        (model_dir,) = project.train(OUTCOME, "smoke", val_k=[k], **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _build.launch_counts()
        rows, train_log = check_model_dir(model_dir, k, TP_EPOCHS,
                                          [1, steps], hp)
        for name, count in launches.items():
            want = train_launches(steps).get(
                name, len(TP_EPOCHS) if name in SERVING else 0)
            check(count == want, f"fold {k}: {name} {count} launches, "
                                 f"expected {want}")
            total[name] = total.get(name, 0) + count
        ckpts = sorted(os.listdir(os.path.join(model_dir, "ckpt")), key=int)
        check(ckpts == [str(TP_STEPS), str(steps)], f"fold {k}: ckpt {ckpts}")
        folds.append({"fold": k, "seconds": secs, "launches": launches,
                      "dir": os.path.basename(model_dir),
                      "early_stop_batch": rows[-1].get("early_stop_batch"),
                      "train_log": train_log,
                      "results": [{c: r[c] for c in r if c.endswith("auc")}
                                  for r in rows]})
        gc.collect()
        torch.cuda.empty_cache()

    # The saved model of fold 1's last epoch gives its CSV's values.
    first = os.path.join(project.models_dir, folds[0]["dir"])
    ui = UncertaintyInterface(os.path.join(
        first, f"{OUTCOME}-smoke-HP0-kfold1_epoch{TP_EPOCHS[-1]}"), seed=42)
    check(not ui.model.training, "the loaded model is in eval mode")
    dataset = project.dataset(hp.tile_px, hp.tile_um)
    labels, _ = dataset.labels(OUTCOME)
    man = pd.read_csv(os.path.join(first, "slide_manifest.csv"))
    val_tfr = [p for p in dataset.tfrecords() if os.path.basename(p)[:-10]
               in set(man.loc[man["dataset"] == "validation", "slide"])]
    _, probs, unc = score_tiles(ui.model, hp, val_tfr, labels)
    csv = pd.read_csv(os.path.join(
        first, f"tile_predictions_val_epoch{TP_EPOCHS[-1]}.csv"))
    rescore_err = float(max(
        np.abs(probs - csv[[f"{OUTCOME}_y_pred0", f"{OUTCOME}_y_pred1"]]
               .to_numpy()).max(),
        np.abs(unc - csv[[f"{OUTCOME}_uncertainty0",
                          f"{OUTCOME}_uncertainty1"]].to_numpy()).max()))
    check(rescore_err <= 1e-6, f"rescored epoch model: max abs err "
                               f"{rescore_err} from its CSV")
    del ui

    # Relaunch fold 1 as if it had died after its first checkpoint.
    os.remove(os.path.join(first, "results_log.csv"))
    shutil.rmtree(os.path.join(first, "ckpt", str(steps)))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    (again,) = project.train(OUTCOME, "smoke", val_k=[1], **kw)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    resume_launches = _build.launch_counts()
    check(again == first and len(os.listdir(project.models_dir)) == TP_FOLDS,
          "the relaunch reuses fold 1's dir")
    check_model_dir(again, 1, TP_EPOCHS[-1:], [steps], hp)
    for name, count in resume_launches.items():
        want = train_launches(steps - TP_STEPS).get(
            name, 1 if name in SERVING else 0)
        check(count == want, f"resumed fold 1: {name} {count} launches, "
                             f"expected {want}")
        total[name] += count
    gc.collect()
    torch.cuda.empty_cache()

    # Host read + decode of one fold's training batches against the
    # step's device time on the same batches, and the two saves.
    train_tfr = [p for p in dataset.tfrecords() if p not in val_tfr]
    t0 = time.perf_counter()
    batches = list(TileBatcher(train_tfr, labels, hp.batch_size,
                               shuffle=True, seed=1, tile_px=hp.tile_px))
    host_s = time.perf_counter() - t0
    model = init_model(build_model(hp), hp,
                       torch.Generator().manual_seed(SEED)).cuda()
    tx = make_optimizer(hp, model.parameters())
    step = make_train_step(model, tx, hp, make_normalizer(hp.normalizer))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    on_card = [[torch.from_numpy(np.asarray(b[key], np.float32 if key ==
                                            "mask" else None)).cuda()
                for key in ("image", "label", "mask")] for b in batches]
    step(*on_card[0], gen)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(len(on_card) + 1)]
    ev[0].record()
    for i, b in enumerate(on_card):
        step(*b, gen)
        ev[i + 1].record()
    torch.cuda.synchronize()
    device_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(on_card))]
    saves = RunCheckpointer(os.path.join(tmp, "save_timing"), every=1)
    t0 = time.perf_counter()
    saves.save(1, model, tx, gen)
    ckpt_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(os.path.join(saves.dir, "1", "state.pt"))
    t0 = time.perf_counter()
    save_checkpoint(os.path.join(tmp, "save_timing"), model, hp, 1, OUTCOME,
                    "smoke", 1)
    epoch_save_s = time.perf_counter() - t0
    del model, tx, step, on_card
    gc.collect()
    torch.cuda.empty_cache()
    n = sum(int(b["mask"].sum()) for b in batches)
    return {
        "phase": "train_project", "model": hp.model, "tile_px": hp.tile_px,
        "batch": hp.batch_size, "k": K, "slides": TP_SLIDES,
        "tiles_a_slide": TP_TILES, "folds": TP_FOLDS,
        "steps_per_epoch": TP_STEPS, "epochs": list(TP_EPOCHS),
        "tfrecords_write_s": write_s,
        "first_fold_s": folds[0]["seconds"],
        "other_folds_s": [f["seconds"] for f in folds[1:]],
        "fold_runs": folds, "rescore_max_abs_err": rescore_err,
        "resume": {"seconds": resume_s, "launches": resume_launches,
                   "steps": steps - TP_STEPS},
        "host_read_decode_s": host_s, "host_tiles": n,
        "host_ms_a_tile": 1e3 * host_s / n,
        "device_step_ms": device_ms,
        "device_ms_a_tile": sum(device_ms) / (len(device_ms) * hp.batch_size),
        "ckpt_save_s": ckpt_s, "ckpt_bytes": ckpt_bytes,
        "epoch_save_s": epoch_save_s, "launches": total, "card": card,
    }, total


def check_experiment_dir(model_dir: str, uq: bool, full: bool):
    """The model-dir contract of one of the protocol's trainings: the
    manifest and params.json; for a CV fold the epoch-1 results row with
    its six AUC/AP cells in [0, 1] and the prediction CSVs with finite
    probabilities (and uncertainties with UQ); for the FULL model its
    epoch-1 model. Returns the manifest's training and validation slide
    counts."""
    import os

    import numpy as np
    import pandas as pd

    files = set(os.listdir(model_dir))
    label = "EXP_ZD_FULL" if full else "EXP_ZD_UQ" if uq else "EXP_ZD"
    want = {"slide_manifest.csv", "params.json", "results_log.csv"}
    if full:
        want.add(f"{OUTCOME}-{label}-HP0_epoch1")
    else:
        want |= {"tile_predictions_val_epoch1.csv",
                 f"patient_predictions_{OUTCOME}_val_epoch1.csv",
                 f"slide_predictions_{OUTCOME}_val_epoch1.csv"}
    check(want <= files, f"{model_dir}: missing {sorted(want - files)}")
    man = pd.read_csv(os.path.join(model_dir, "slide_manifest.csv"))
    n_train = int((man["dataset"] == "training").sum())
    n_val = int((man["dataset"] == "validation").sum())
    with open(os.path.join(model_dir, "params.json")) as f:
        meta = json.load(f)
    check(meta["label"] == label and meta["hp"]["uq"] == (uq or full)
          and meta["hp"]["model"] == "xception"
          and meta["hp"]["batch_size"] == TRAIN_BATCH, f"{model_dir}: hp")
    log = pd.read_csv(os.path.join(model_dir, "results_log.csv"))
    check(list(log["model_name"]) == [f"{OUTCOME}-{label}-HP0_epoch1"],
          f"{model_dir}: results_log rows")
    if full:
        check(n_val == 0 and n_train == EX_TRAIN, f"{model_dir}: manifest")
        for f in ("model.msgpack", "params.json"):
            check(os.path.exists(os.path.join(
                model_dir, f"{OUTCOME}-{label}-HP0_epoch1", f)),
                f"{model_dir}: epoch model {f}")
        return n_train, n_val
    check(n_val > 0 and n_train + n_val == EX_TRAIN, f"{model_dir}: manifest")
    for col in ("patient_auc", "patient_ap", "slide_auc", "slide_ap",
                "tile_auc", "tile_ap"):
        (v,) = json.loads(log[col][0])[OUTCOME]
        check(0.0 <= v <= 1.0, f"{model_dir}: {col} {v}")
    tiles = pd.read_csv(os.path.join(model_dir,
                                     "tile_predictions_val_epoch1.csv"))
    p = tiles[[f"{OUTCOME}_y_pred0", f"{OUTCOME}_y_pred1"]].to_numpy()
    check(len(tiles) == n_val * EX_TILES and bool(np.isfinite(p).all())
          and np.abs(p.sum(1) - 1).max() <= 1e-3, f"{model_dir}: tile rows")
    check((f"{OUTCOME}_uncertainty1" in tiles) == uq,
          f"{model_dir}: uncertainty columns")
    if uq:
        u = tiles[f"{OUTCOME}_uncertainty1"].to_numpy()
        check(bool(np.isfinite(u).all() and u.min() >= 0),
              f"{model_dir}: uncertainty values")
    return n_train, n_val


def experiment_phase(torch, tmp: str, card: str):
    """``Experiment(train, [eval]).run({"ZD": ...}, steps=EX_STEPS)`` with
    the default hp ("nature2022": Xception-299 bf16, 2x1024, dropout 0.1,
    K=30, batch 128) on the card, over a training project of EX_TRAIN
    slides and an evaluation project of EX_EVAL (``write_project``): 3 CV
    folds (step 2), 3 UQ CV folds (step 3), the FULL model (step 5, its
    steps from ``find_cv_early_stop``) and its evaluation (step 6); step
    1 does not apply to ZD and step 4 needs >= 50 slides. One ``run``
    call, each step timed from its "[Step n]" line to the next, with the
    launch counts zeroed just before and read just after:
    34 strip launches a training step (a fold's steps are its training
    tiles // 128) and rows 1-3 once a batch of the UQ folds' validation
    tiles and of the evaluation, nothing else. Then every model dir, the
    annotations, the eval dir, a second run of steps 2, 3 and 5 (no new
    model dir, "already done"), and ``results``: its 'none' and 'all'
    arms 3 rows each and one eval row, finite AUCs in [0, 1]."""
    import contextlib
    import gc
    import io
    import math
    import os

    import numpy as np
    import pandas as pd

    from biscuit_torch import utils
    from biscuit_torch.experiment import Experiment
    from biscuit_torch.ops import _build

    class StepClock(io.TextIOBase):
        """Passes ``run``'s output on, noting when each step's bold
        "[Step n]" heading is printed."""

        def __init__(self, out):
            self.out, self.starts = out, []

        def write(self, text):
            m = re.search(r"\033\[1m\[Step (\d)\]", text)
            if m:
                self.starts.append((m.group(1), time.perf_counter()))
            return self.out.write(text)

        def flush(self):
            self.out.flush()

    train_P, train_s = write_project(tmp, "extrain", EX_TRAIN, EX_TILES,
                                     SEED + 2, ("LUAD", "LUSC"))
    eval_P, eval_s = write_project(tmp, "exeval", EX_EVAL, EX_TILES,
                                   SEED + 3, ("LUAD", "LUSC"))
    exp = Experiment(train_P, [eval_P], outdir=os.path.join(tmp, "results"))
    zd = {"ZD": {"out1": EX_TRAIN // 2, "out2": EX_TRAIN // 2}}
    clock = StepClock(sys.stdout)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(clock):
        exp.run(zd, steps=list(EX_STEPS))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = _build.launch_counts()
    run_s = t_end - t0
    ends = [t for _, t in clock.starts[1:]] + [t_end]
    step_s = {n: end - start for (n, start), end in zip(clock.starts, ends)}
    check(list(step_s) == [str(n) for n in EX_STEPS],
          f"the steps that ran: {list(step_s)}")
    gc.collect()
    torch.cuda.empty_cache()

    ann = pd.read_csv(os.path.join(train_P.root, "experiments.csv"))
    check((ann["include_ZD"] == "include").sum() == EX_TRAIN,
          "experiments.csv: include_ZD")
    steps = 0
    uq_batches = 0
    for label, uq in (("EXP_ZD", False), ("EXP_ZD_UQ", True)):
        for d in utils.find_cv(train_P, label, outcome=OUTCOME):
            n_train, n_val = check_experiment_dir(d, uq, False)
            steps += max(1, n_train * EX_TILES // TRAIN_BATCH)
            if uq:
                uq_batches += math.ceil(n_val * EX_TILES / TRAIN_BATCH)
    full = utils.find_model(train_P, "EXP_ZD_FULL", outcome=OUTCOME)
    check_experiment_dir(full, True, True)
    stop = utils.find_cv_early_stop(train_P, "EXP_ZD", outcome=OUTCOME)
    steps += stop or EX_TRAIN * EX_TILES // TRAIN_BATCH
    eval_dir = utils.find_eval(eval_P, "EXP_ZD_FULL", outcome=OUTCOME)
    check(set(os.listdir(eval_dir)) == {
        "results_log.csv", "tile_predictions_eval.csv",
        f"slide_predictions_{OUTCOME}_eval.csv",
        f"patient_predictions_{OUTCOME}_eval.csv"}, "the eval-dir files")
    eval_batches = math.ceil(EX_EVAL * EX_TILES / TRAIN_BATCH)
    for name, count in launches.items():
        want = train_launches(steps).get(
            name, uq_batches + eval_batches if name in SERVING else 0)
        check(count == want, f"experiment: {name} {count} launches, "
                             f"expected {want}")

    before = sorted(os.listdir(train_P.models_dir))
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        exp.run(zd, steps=[2, 3, 5])
    rerun_s = time.perf_counter() - t0
    check(sorted(os.listdir(train_P.models_dir)) == before
          and out.getvalue().count("already done") == 3,
          f"the rerun trains nothing: {out.getvalue()!r}")

    t0 = time.perf_counter()
    df, eval_dfs = exp.results(["ZD"], uq=True, eval=True)
    results_s = time.perf_counter() - t0
    ev = eval_dfs[eval_P.name]
    check(sorted(df["uq"]) == ["all"] * 3 + ["none"] * 3 and len(ev) == 1,
          f"results rows: {df['uq'].tolist()}, {len(ev)} eval")
    aucs = np.concatenate([
        df[[c for c in df if c.endswith("_auc")]].to_numpy(np.float64)
        .ravel(), ev[["patient_auc", "slide_auc"]].to_numpy(np.float64)
        .ravel()])
    check(bool(np.isfinite(aucs).all() and (aucs >= 0).all()
               and (aucs <= 1).all()), f"results AUCs {aucs.tolist()}")
    return {
        "phase": "experiment", "model": "xception", "tile_px": TILE_PX,
        "batch": TRAIN_BATCH, "k": K, "train_slides": EX_TRAIN,
        "eval_slides": EX_EVAL, "tiles_a_slide": EX_TILES,
        "steps": list(EX_STEPS), "tfrecords_write_s": train_s + eval_s,
        "step_s": step_s,
        "run_s": run_s, "rerun_s": rerun_s, "results_s": results_s,
        "training_steps": steps, "early_stop_batch": stop,
        "cv": df.to_dict("records"), "eval": ev.to_dict("records"),
        "launches": launches, "card": card,
    }, launches


def he_slide(seed: int, px: int = SLIDE_PX):
    """A synthetic H&E-like RGB slide, uint8 (px, px, 3): a near-white
    background (236-251) and a disc of tissue over about half the area,
    pink stroma under low-frequency waves with purple 8-px 'nuclei' and
    +-12 levels of noise; no region is constant."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = np.arange(px, dtype=np.float32)
    wave = np.zeros((px, px), np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(0.002, 0.01, 2)
        py, ph = rng.uniform(0, 2 * np.pi, 2)
        wave += np.outer(np.cos(fy * pos + py), np.cos(fx * pos + ph))
    cy, cx = px / 2 + rng.uniform(-px / 30, px / 30, 2)
    disc = ((pos[:, None] - cy) ** 2 + (pos[None, :] - cx) ** 2
            < (0.4 * px) ** 2)
    nuclei = np.repeat(np.repeat(rng.random((px // 8 + 1, px // 8 + 1))
                                 < 0.15, 8, 0), 8, 1)[:px, :px] & disc
    img = rng.integers(236, 252, (px, px, 3), dtype=np.uint8)
    noise = rng.integers(-12, 13, (px, px, 3), dtype=np.int16)
    for c, (base, amp, dark) in enumerate(((205, 25, 95), (120, 30, 60),
                                           (165, 20, 140))):
        tissue = np.where(nuclei, dark, base + amp * wave) + noise[..., c]
        img[..., c] = np.where(disc, np.clip(tissue, 0, 255), img[..., c])
    return img


def slide_phase(torch, tmp: str, card: str):
    """Whole slides on the card (see the docstring, phase slide).
    Returns (row, launches of rows 1-3 on the slide path)."""
    import dataclasses
    import io
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import pandas as pd
    from PIL import Image

    from biscuit_torch.data import native_loader
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.data.pipeline import TileBatcher
    from biscuit_torch.data.slide import WSI
    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.data.tfrecord import (
        TFRecordWriter,
        load_index,
        read_example_at,
    )
    from biscuit_torch.gan import resize_batch, score_gan_tiles
    from biscuit_torch.heatmap import Heatmap, export_tiles_by_uncertainty
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.mosaic import (
        generate_features,
        generate_mosaic,
        slide_map_from_features,
    )
    from biscuit_torch.ops import _build
    from biscuit_torch.project import Project
    from biscuit_torch.train.trainer import save_checkpoint
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    def counted(fn):
        """fn() with the launch counts zeroed just before and read just
        after: (its result, the counts, its seconds)."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, _build.launch_counts(), time.perf_counter() - t0

    def check_launches(what, launches, per_kernel):
        for name, count in launches.items():
            want = per_kernel.get(name, 0)
            check(count == want, f"{what}: {count} {name} launches, "
                                 f"expected {want}")

    caps = native_loader.capabilities()
    row = {"phase": "slide", "card": card, "capabilities": caps,
           "tiff_library": native_loader.tiff_library(),
           "slide_px": SLIDE_PX, "tiff_tile": SLIDE_TIFF_TILE,
           "tile_px": TILE_PX, "tile_um": 302, "k": K}
    print(f"bn_capabilities: {json.dumps(caps)} (libtiff: "
          f"{row['tiff_library']})", flush=True)
    check(caps["tiff"], "the TIFF reader needs a libtiff on this host")

    # 1. Slides: two H&E-like 6000-px JPEG tiled TIFFs.
    slides_dir = os.path.join(tmp, "slides")
    os.makedirs(slides_dir)
    paths, imgs, t_gen, t_write = [], [], 0.0, 0.0
    for s in range(SLIDE_COUNT):
        t0 = time.perf_counter()
        imgs.append(he_slide(SEED + s))
        t_gen += time.perf_counter() - t0
        paths.append(os.path.join(slides_dir, f"wsi{s}.svs"))
        t0 = time.perf_counter()
        native_loader.write_tiled_tiff(paths[-1], imgs[-1],
                                       tile=SLIDE_TIFF_TILE, jpeg=True)
        t_write += time.perf_counter() - t0
    row.update(slides_gen_s=t_gen, slides_write_s=t_write,
               slide_bytes=[os.path.getsize(p) for p in paths])

    hp = dataclasses.replace(nature2022_params(), uq=True, uq_samples=K)
    hp0 = dataclasses.replace(hp, dropout=0.0)
    wsis = [WSI(p, hp.tile_px, hp.tile_um, qc="otsu") for p in paths]
    for w in wsis:
        check(w._tiled is not None, f"{w.path} opened through TiledTiff")
        check((w.grid_x, w.grid_y) == (19, 19), "19 x 19 grid at 302 um")
    tissue = []
    for w in wsis:
        m = np.zeros((w.grid_y, w.grid_x), bool)
        for i, j, x, y in w.coords():
            m[j, i] = w._tile_is_tissue(x, y)
        tissue.append(m)
    n_tissue = [int(m.sum()) for m in tissue]
    check(all(0.3 * 361 < n < 0.7 * 361 for n in n_tissue),
          f"tissue tiles {n_tissue} of 361: Otsu QC drops about half")
    row["tissue_tiles"] = n_tissue

    # The model: seeded LeCun weights, its logits layer set from the
    # plain features of slide 0's tissue tiles so that the probabilities
    # spread; saved at dropout 0.1 and 0.
    model = build_model(hp)
    init_random_(torch, model, SEED)
    model = model.cuda().eval()
    t0 = time.perf_counter()
    tiles0 = [(it["loc"], it["image"])
              for it in wsis[0].build_generator(include_loc="grid")()]
    row["read_tiles_s"] = time.perf_counter() - t0
    x0 = np.stack([t for _, t in tiles0])
    norm = make_normalizer(hp.normalizer)
    with torch.inference_mode():
        feats = torch.cat([trunk_features(model, inference_preprocess(
            torch.from_numpy(x0[i:i + 64]).cuda().float(), norm), False)
            for i in range(0, len(x0), 64)])
    decisive_logits_(torch, model, feats)
    del feats
    model_dir = save_checkpoint(os.path.join(tmp, "models"), model, hp, 1,
                                OUTCOME, "slide", None)
    model0_dir = save_checkpoint(os.path.join(tmp, "models"), model, hp0, 1,
                                 OUTCOME, "slide0", None)

    # 2. Heatmaps on the card: slide 1 first (warm-up), then slide 0;
    # rows 1-3 once a batch each.
    path_launches = {name: 0 for name in SERVING}
    hms, hm_rows = [], []
    for s in (1, 0):
        hm, launches, secs = counted(lambda: Heatmap(paths[s], model_dir,
                                                     qc="otsu"))
        check_launches(f"Heatmap of slide {s}", launches,
                       {n: hm.timings["batches"] for n in SERVING})
        for name in SERVING:
            path_launches[name] += launches[name]
        unscored = hm.uncertainty[..., 0] == -99.0
        check(np.array_equal(~unscored, tissue[s]),
              f"slide {s}: the -99 cells are the QC mask's")
        check(bool(np.array_equal(unscored, hm.logits[..., 1] == -99.0)),
              "logits and uncertainty masked alike")
        p = hm.logits[~unscored]
        check(bool(np.isfinite(p).all()) and float(np.abs(
            p.sum(-1) - 1).max()) <= 1e-3, "heatmap rows sum to 1")
        check(float(hm.uncertainty[~unscored].min()) >= 0, "std >= 0")
        hms.append(hm)
        hm_rows.append({"slide": s, "seconds": secs, **hm.timings,
                        "tiles_per_s": hm.timings["tiles"] / secs,
                        "launches": {n: launches[n] for n in SERVING}})
    hm = hms[1]
    row["heatmap"] = hm_rows

    # The dropout-0 grid against the plain path on the card (f32
    # preprocess of float tiles, library convs, the module head).
    hm0, launches, _ = counted(lambda: Heatmap(paths[0], model0_dir,
                                               qc="otsu"))
    check_launches("dropout-0 Heatmap", launches,
                   {n: hm0.timings["batches"] for n in SERVING})
    for name in SERVING:
        path_launches[name] += launches[name]
    model.dropout = model.head.dropout = 0.0
    plain = UncertaintyInterface.from_model(model, hp0, k=K, device="cuda",
                                            use_kernel=False,
                                            fused_trunk=False)
    want = np.concatenate([plain(torch.from_numpy(
        x0[i:i + 64]).cuda().float())[0].float().cpu().numpy()
        for i in range(0, len(x0), 64)])
    model.dropout = model.head.dropout = hp.dropout
    got = np.stack([hm0.logits[j, i] for (i, j), _ in tiles0])
    err0 = float(np.abs(got - want).max())
    spread = float(np.ptp(want[:, 1]))
    check(spread > 0.2, f"dropout-0 probabilities spread {spread} <= 0.2")
    check(err0 <= 2e-2, f"dropout-0 heatmap: max abs err {err0}")
    row.update(dropout0_max_abs_err=err0, dropout0_ptp=spread,
               dropout0_tol=2e-2)

    # 3. Tiles exported by uncertainty at the heatmap's median.
    unc = hm.uncertainty[..., 0]
    tile_uq = float(np.median(unc[unc > -99]))
    out = os.path.join(tmp, "export")
    (n_incl, n_excl), launches, secs = counted(
        lambda: export_tiles_by_uncertainty(paths[0], model_dir, tile_uq,
                                            out, qc="otsu"))
    n_batches = -(-n_tissue[0] // 64)
    check_launches("export_tiles_by_uncertainty", launches,
                   {n: n_batches for n in SERVING})
    for name in SERVING:
        path_launches[name] += launches[name]
    files = {d: os.listdir(os.path.join(out, d))
             for d in ("uq_incl", "uq_excl")}
    check((len(files["uq_incl"]), len(files["uq_excl"])) == (n_incl, n_excl)
          and n_incl + n_excl == n_tissue[0],
          f"exported {n_incl} + {n_excl} of {n_tissue[0]} tissue tiles")
    cells = set()
    for d, names in files.items():
        for name in names:
            _, i, j, u = name[:-4].rsplit("-", 3)
            cells.add((int(j), int(i)))
            check((float(u) < tile_uq + 5e-6) if d == "uq_incl"
                  else (float(u) >= tile_uq - 5e-6),
                  f"{d}/{name} against the threshold {tile_uq}")
    check(cells == set(zip(*np.where(tissue[0]))),
          "the exported tiles are the tissue cells")
    row["export"] = {"tile_uq": tile_uq, "incl": n_incl, "excl": n_excl,
                     "heatmap_incl": int(((unc > -99) & (unc < tile_uq))
                                         .sum()),
                     "seconds": secs}

    # 4. Extraction into tfrecords, then the native and default decodes.
    ann = os.path.join(tmp, "slides.csv")
    pd.DataFrame({"patient": [f"p{s}" for s in range(SLIDE_COUNT)],
                  "slide": [f"wsi{s}" for s in range(SLIDE_COUNT)],
                  OUTCOME: ["LUAD", "LUSC"][:SLIDE_COUNT]}).to_csv(
                      ann, index=False)
    project = Project(os.path.join(tmp, "wsi_project"), annotations=ann,
                      name="wsi", create=True)
    project.add_source("WSI", slides=slides_dir,
                       tfrecords=os.path.join(tmp, "wsi_tfr"))
    t0 = time.perf_counter()
    report = project.extract_tiles(tile_px=hp.tile_px, tile_um=hp.tile_um,
                                   qc="otsu", report_pdf=False)
    extract_s = time.perf_counter() - t0
    check([(r["slide"], r["tiles"], r["grid"]) for r in report]
          == [(f"wsi{s}", n_tissue[s], "19x19") for s in range(SLIDE_COUNT)],
          f"extraction report {report}")
    tfrs = project.dataset(tile_px=hp.tile_px, tile_um=hp.tile_um
                           ).tfrecords()
    check(len(tfrs) == SLIDE_COUNT, "one tfrecord a slide")
    n_ext = sum(n_tissue)
    row["extract"] = {"seconds": extract_s, "tiles": n_ext,
                      "tiles_per_s": n_ext / extract_s,
                      "bytes": sum(os.path.getsize(p) for p in tfrs)}

    def read_all(**kw):
        t0 = time.perf_counter()
        batches = list(TileBatcher(tfrs, {}, hp.batch_size, shuffle=False,
                                   tile_px=hp.tile_px, **kw))
        return batches, time.perf_counter() - t0

    default, default_s = read_all()
    native, native_s = read_all(use_native=True)
    for b, nb in zip(default, native):
        check(b["image"].tobytes() == nb["image"].tobytes()
              and b["slide"] == nb["slide"]
              and np.array_equal(b["loc"], nb["loc"]),
              "native and default batches bit for bit")
    check(len(default) == len(native), "as many batches")
    # The tiles are the heatmap's pixels: the same cells, and at dropout
    # 0 the same probabilities within 2e-2.
    decode = {"tiles": n_ext, "pillow_batcher_ms": default_s / n_ext * 1e3,
              "native_batcher_ms": native_s / n_ext * 1e3}
    offsets = [load_index(p) for p in tfrs]
    threads = os.cpu_count() or 1
    for nt in (1, threads):
        t0 = time.perf_counter()
        ok = sum(native_loader.native_read_decode_batch(
            p, o, hp.tile_px, threads=nt)[4] for p, o in zip(tfrs, offsets))
        decode[f"native_{nt}_threads_ms"] = ((time.perf_counter() - t0)
                                             / n_ext * 1e3)
        decode[f"native_{nt}_threads_decoded"] = int(ok)
    raws = []
    for p, o in zip(tfrs, offsets):
        with open(p, "rb") as f:
            raws += [read_example_at(f, int(off))["image_raw"] for off in o]

    def pillow(raw):
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))

    for nt in (1, threads):
        with ThreadPoolExecutor(nt) as pool:
            t0 = time.perf_counter()
            list(pool.map(pillow, raws))
            decode[f"pillow_{nt}_threads_ms"] = ((time.perf_counter() - t0)
                                                 / n_ext * 1e3)
    decode["threads"] = threads
    row["decode"] = decode

    ui0 = UncertaintyInterface(model0_dir)

    def score_native():
        out = []
        for b in TileBatcher(tfrs, {}, hp.batch_size, shuffle=False,
                             tile_px=hp.tile_px, use_native=True):
            p, _ = ui0(torch.from_numpy(b["image"]).cuda())
            out.append((b, p.float().cpu().numpy()))
        return out

    scored, launches, secs = counted(score_native)
    check_launches("scoring the extracted tiles", launches,
                   {n: len(scored) for n in SERVING})
    for name in SERVING:
        path_launches[name] += launches[name]
    err = 0.0
    for b, p in scored:
        for r in np.where(b["mask"])[0]:
            if b["slide"][r] == "wsi0":
                i, j = b["loc"][r]
                err = max(err, float(np.abs(p[r] - hm0.logits[j, i]).max()))
    check(err <= 2e-2, f"extracted tiles against the dropout-0 heatmap: "
                       f"{err}")
    row["score_extracted"] = {"seconds": secs, "batches": len(scored),
                              "tiles_per_s": n_ext / secs,
                              "vs_heatmap_max_abs_err": err}

    # 5. GAN tiles: 512-px crops of the slides' tissue, resized on the
    # card; rows 2-3 once a batch, row 1 never (float tiles).
    rng = np.random.default_rng(SEED)
    gan_paths = []
    for s in range(SLIDE_COUNT):
        gan_paths.append(os.path.join(tmp, f"gan{s}.tfrecords"))
        lo, hi = int(SLIDE_PX * 0.3), int(SLIDE_PX * 0.7) - GAN_PX
        with TFRecordWriter(gan_paths[-1]) as w:
            for t in range(GAN_TILES // SLIDE_COUNT):
                y, x = rng.integers(lo, hi, 2)
                buf = io.BytesIO()
                Image.fromarray(imgs[s][y:y + GAN_PX, x:x + GAN_PX]).save(
                    buf, format="PNG")
                w.write_tile(f"gan{s}", buf.getvalue(), loc_x=int(x),
                             loc_y=int(y))
    df, launches, secs = counted(lambda: score_gan_tiles(
        model_dir, gan_paths, outcome=OUTCOME, batch_size=64,
        gan_px=GAN_PX))
    gan_batches = -(-GAN_TILES // 64)
    check_launches("score_gan_tiles", launches,
                   {"fused_middle_flow": gan_batches,
                    "mcd_head": gan_batches})
    for name in SERVING:
        path_launches[name] += launches[name]
    vals = df[[c for c in df.columns if c.startswith(f"{OUTCOME}_y_pred")
               or c.startswith(f"{OUTCOME}_uncertainty")]].to_numpy()
    check(len(df) == GAN_TILES and bool(np.isfinite(vals).all()),
          "GAN frame: a finite row a tile")
    sample = np.stack([imgs[0][y:y + GAN_PX, x:x + GAN_PX] for y, x in
                       rng.integers(lo, hi, (16, 2))])
    on_card = resize_batch(torch.from_numpy(sample).cuda(), hp.tile_px)
    on_cpu = resize_batch(torch.from_numpy(sample), hp.tile_px)
    resize_err = float((on_card.cpu() - on_cpu).abs().max())
    check(resize_err <= 1e-3, f"resize on the card vs the CPU: {resize_err}")
    row["gan"] = {"tiles": GAN_TILES, "seconds": secs,
                  "tiles_per_s": GAN_TILES / secs,
                  "launches": {n: launches[n] for n in SERVING},
                  "resize_max_abs_err": resize_err, "resize_tol": 1e-3}

    # 6. Mosaic: features of MOSAIC_TILES tiles a slide, no kernel.
    (feats, meta, mtiles), launches, feat_s = counted(
        lambda: generate_features(model_dir, tfrs, max_tiles=MOSAIC_TILES,
                                  keep_tiles=True, k=K))
    check_launches("generate_features", launches, {})
    n_m = SLIDE_COUNT * MOSAIC_TILES
    check(feats.shape == (n_m, 2048) and bool(np.isfinite(feats).all())
          and mtiles.shape == (n_m, TILE_PX, TILE_PX, 3) and len(meta) == n_m,
          "features of every tile")
    t0 = time.perf_counter()
    smap = slide_map_from_features(feats, meta, mtiles)
    umap_s = time.perf_counter() - t0
    smap.label_by_slide()
    check(smap.coords.shape == (n_m, 2) and bool(np.isfinite(
        smap.coords).all()) and sorted(set(smap.labels)) == [0.0, 1.0],
          "slide map")
    t0 = time.perf_counter()
    canvas = generate_mosaic(feats, meta, mtiles, grid=10)
    mosaic_s = time.perf_counter() - t0
    check(canvas.shape == (10 * TILE_PX, 10 * TILE_PX, 3), "mosaic canvas")
    row["mosaic"] = {"tiles": n_m, "features_s": feat_s,
                     "embed_method": smap.embed_method, "embed_s": umap_s,
                     "mosaic_s": mosaic_s,
                     "cells_filled": int((canvas.reshape(
                         10, TILE_PX, 10, TILE_PX, 3) != 255).any(
                             axis=(1, 3, 4)).sum())}
    for w in wsis:
        w.close()
    row["launches"] = path_launches
    return row, path_launches


def serve_phase_on_predict_tiles(torch, tmp: str, card: str):
    """Phase serve over phase predict's tiles, written again into
    tfrecords under ``tmp`` (the same seed, so the same tiles)."""
    import os

    tiles = smooth_tiles(len(PREDICT_LABELS) * PREDICT_TILES, SEED)
    paths, labels, _ = write_tfrecords(tiles, os.path.join(tmp, "tfr"))
    del tiles
    return serve_phase(torch, tmp, paths, labels, card)


def op_dispatch(torch, op, direct, args, ops_a_request: int,
                request_s, calls: int = 50) -> dict:
    """Host time a call of a serving kernel through its registered op
    (``ops/library.py``, the live path's route) and through its wrapper
    directly, each over ``calls`` calls enqueued without a synchronize,
    alternated twice (op, direct, direct, op); and what the difference
    costs a request of ``ops_a_request`` op calls, in % of the median
    request."""
    runs = {"op": [], "direct": []}
    for name in ("op", "direct", "direct", "op"):
        fn = op if name == "op" else direct
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        runs[name].append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    op_us, direct_us = min(runs["op"]), min(runs["direct"])
    return {"op_us": op_us, "direct_us": direct_us,
            "ops_a_request": ops_a_request,
            "overhead_pct": (op_us - direct_us) * ops_a_request
            / (statistics.median(request_s) * 1e6) * 100}


def serve_phase(torch, tmp: str, tfrecords, labels, card: str):
    """Servables on the card (see the docstring, phase serve). Returns
    (row, launches of rows 1-4 over the phase's counted runs)."""
    import dataclasses
    import os

    import numpy as np

    from biscuit_torch import serve as sv_mod
    from biscuit_torch.data import native_loader
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.data.slide import WSI
    from biscuit_torch.heatmap import Heatmap
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.mosaic import generate_features
    from biscuit_torch.ops import _build
    from biscuit_torch.train.trainer import save_checkpoint
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    def counted(fn):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, _build.launch_counts(), time.perf_counter() - t0

    path_launches = {name: 0 for name in _build.KERNELS}

    def check_launches(what, launches, per_kernel):
        for name, count in launches.items():
            want = per_kernel.get(name, 0)
            check(count == want, f"{what}: {count} {name} launches, "
                                 f"expected {want}")
            path_launches[name] += count

    row = {"phase": "serve", "card": card, "tiles_per_request": TILES,
           "requests": SERVE_REQUESTS, "k": K}
    # A slide for the heatmaps and the dropout-0 comparisons, and the
    # model: seeded LeCun weights, its logits set from the plain features
    # of the slide's tissue tiles so that the probabilities spread; saved
    # at dropout 0.1 and 0.
    slide = os.path.join(tmp, "serve_wsi.svs")
    native_loader.write_tiled_tiff(slide, he_slide(SEED + 5, SERVE_SLIDE_PX),
                                   tile=SLIDE_TIFF_TILE, jpeg=True)
    hp = dataclasses.replace(nature2022_params(), uq=True, uq_samples=K)
    hp0 = dataclasses.replace(hp, dropout=0.0)
    tissue = np.stack([it["image"] for it in WSI(
        slide, hp.tile_px, hp.tile_um, qc="otsu").build_generator()()])
    check(32 <= len(tissue) <= TILES, f"{len(tissue)} tissue tiles")
    model = build_model(hp)
    init_random_(torch, model, SEED)
    model = model.cuda().eval()
    with torch.inference_mode():
        feats = trunk_features(model, inference_preprocess(
            torch.from_numpy(tissue).cuda().float(),
            make_normalizer(hp.normalizer)), False)
    decisive_logits_(torch, model, feats)
    del feats
    model_dir = save_checkpoint(os.path.join(tmp, "serve_models"), model,
                                hp, 1, OUTCOME, "serve", None)
    model0_dir = save_checkpoint(os.path.join(tmp, "serve_models"), model,
                                 hp0, 1, OUTCOME, "serve0", None)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    requests = [torch.randint(0, 256, (TILES, TILE_PX, TILE_PX, 3),
                              generator=gen, device="cuda",
                              dtype=torch.uint8)
                for _ in range(SERVE_REQUESTS + 1)]
    seeds = [(SEED << 32) | i for i in range(SERVE_REQUESTS)]

    def timed(call):
        """Warm up on the last request, then the counted requests at
        ``seeds``, the launch counts zeroed before each and read after:
        (outputs, host seconds a request to the end of its synchronize,
        host seconds to the call's return, launches a request)."""
        call(requests[-1], 99)
        torch.cuda.synchronize()
        outs, secs, enq, launches = [], [], [], []
        for tiles, seed in zip(requests, seeds):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            outs.append(call(tiles, seed))
            enq.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches.append(_build.launch_counts())
        return outs, secs, enq, launches

    # The live interface, both trunks, on the same requests and seeds.
    live = {}
    for fuse in (False, True):
        ui = UncertaintyInterface.from_model(model, hp, device="cuda",
                                             seed=SEED, fuse_blocks=fuse)
        outs, secs, enq, _ = timed(lambda t, s: ui(t, seed=s))
        live[fuse] = outs
        row["live_fuse_blocks" if fuse else "live"] = {
            "request_s": secs, "host_s": enq,
            "tiles_per_s": TILES * len(secs) / sum(secs),
            "profile": kernel_profile(torch, lambda: ui(requests[1],
                                                        seed=seeds[1]),
                                      top=20)}
    del ui

    specs = (("a", model_dir, dict(with_features=True)),
             ("b", model_dir, dict(fuse_blocks=True, with_features=False)),
             ("a0", model0_dir, dict(with_features=False)),
             ("c", model0_dir, dict(use_kernels=False, device="cpu",
                                    platforms=["cuda", "cpu"],
                                    with_features=False)))
    per_request = {"a": {n: 1 for n in SERVING}, "b": {n: 1 for n in SERVING},
                   "a0": {n: 1 for n in SERVING}, "c": {}}
    per_request["b"]["fused_block"] = BLOCKS_PER_REQUEST
    servables, arts = {}, {}
    for name, src, kw in specs:
        t0 = time.perf_counter()
        path = sv_mod.export_servable(
            src, os.path.join(tmp, f"{name}.biscuit"), batch_size=TILES,
            k=K, **kw)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sv = sv_mod.load_servable(path)
        load_s = time.perf_counter() - t0
        check(sv.device.type == "cuda", f"artifact {name} serves on the card")
        outs, secs, enq, launches = timed(
            lambda t, s: sv.call_exact(t, seed=s))
        for i, got in enumerate(launches):
            check_launches(f"artifact {name}, request {i}", got,
                           per_request[name])
        art = {"export_s": export_s, "bytes": os.path.getsize(path),
               "programs": sorted(sv.header["programs"]), "load_s": load_s,
               "request_s": secs, "host_s": enq,
               "tiles_per_s": TILES * len(secs) / sum(secs),
               "use_kernels": sv.header["use_kernels"],
               "fuse_blocks": sv.header["fuse_blocks"],
               "platforms": list(sv.platforms),
               "launches_a_request": {n: c for n, c in launches[0].items()
                                      if c}}
        for mean, std in outs:
            check(tuple(mean.shape) == tuple(std.shape) == (TILES, 2),
                  f"artifact {name}: output shape")
            check(bool(torch.isfinite(mean).all() and torch.isfinite(std)
                       .all()), f"artifact {name}: finite outputs")
            check(float((mean.sum(-1) - 1).abs().max()) <= 1e-3,
                  f"artifact {name}: rows sum to 1")
        if name in ("a", "b"):
            # The live interface at the same seeds: the same kernels on
            # the same inputs, so bit for bit.
            err = max(float((g - w).abs().max())
                      for o, lo in zip(outs, live[name == "b"])
                      for g, w in zip(o, lo))
            check(err == 0.0, f"artifact {name} vs the live interface: "
                              f"max abs err {err}")
            again = sv.call_exact(requests[0], seed=seeds[0])
            other = sv.call_exact(requests[0], seed=seeds[0] + 1)
            check(all(torch.equal(x, y) for x, y in zip(again, outs[0])),
                  f"artifact {name}: one seed, equal outputs")
            check(not torch.equal(other[0], outs[0][0]),
                  f"artifact {name}: two seeds, different outputs")
            art["vs_live_max_abs_err"] = err
            art["mean_of_std"] = outs[0][1].mean(0).tolist()
            art["profile"] = kernel_profile(
                torch, lambda: sv.call_exact(requests[1], seed=seeds[1]),
                top=20)
        row[name] = art
        servables[name], arts[name] = sv, path
        emit({"phase": "serve_artifact", "artifact": name, **art})
    del live, requests

    # Dropout 0: the portable artifact (c) against the kernels' (a0) on
    # the slide's tissue tiles, whose probabilities spread.
    m0 = servables["a0"](tissue, seed=0)[0].cpu().numpy()
    mc = servables["c"](tissue, seed=0)[0].cpu().numpy()
    spread = float(np.ptp(m0[:, 1]))
    err_c = float(np.abs(mc - m0).max())
    check(spread > 0.2, f"dropout-0 probabilities spread {spread} <= 0.2")
    check(err_c <= 2e-2, f"dropout 0: artifact c vs a0, max abs err {err_c}")
    row.update(c_vs_a0_max_abs_err=err_c, dropout0_ptp=spread,
               dropout0_tol=2e-2)

    # predict_tfrecords over phase predict's tfrecords: rows 1-3 once a
    # batch of TILES.
    n = len(PREDICT_LABELS) * PREDICT_TILES
    n_batches = -(-n // TILES)
    df, launches, secs = counted(lambda: sv_mod.predict_tfrecords(
        servables["a"], tfrecords, labels=labels, outcome=OUTCOME,
        seed=SEED))
    check_launches("predict_tfrecords", launches,
                   {k: n_batches for k in SERVING})
    check(list(df.columns) == [
        "slide", "loc_x", "loc_y", f"{OUTCOME}_y_true0",
        f"{OUTCOME}_y_pred0", f"{OUTCOME}_y_pred1",
        f"{OUTCOME}_uncertainty0", f"{OUTCOME}_uncertainty1"],
        f"predict_tfrecords columns {list(df.columns)}")
    check(len(df) == n and list(df.slide) == [
        f"slide{i // PREDICT_TILES}" for i in range(n)],
        "predict_tfrecords rows in tfrecord order")
    check(np.array_equal(df[f"{OUTCOME}_y_true0"].to_numpy(),
                         np.repeat(PREDICT_LABELS, PREDICT_TILES)),
          "predict_tfrecords y_true")
    probs = df[[f"{OUTCOME}_y_pred0", f"{OUTCOME}_y_pred1"]].to_numpy()
    check(bool(np.isfinite(probs).all())
          and float(np.abs(probs.sum(1) - 1).max()) <= 1e-3,
          "predict_tfrecords probabilities")
    row["predict_tfrecords"] = {"tiles": n, "batches": n_batches,
                                "seconds": secs, "tiles_per_s": n / secs}

    # Heatmaps of the slide at dropout 0: from artifact a0 (one batch of
    # TILES) and from the model dir (batches of 64).
    hm_a, launches, secs_a = counted(lambda: Heatmap(slide, arts["a0"],
                                                     qc="otsu"))
    check_launches("Heatmap from artifact a0", launches,
                   {k: hm_a.timings["batches"] for k in SERVING})
    hm_d, launches, secs_d = counted(lambda: Heatmap(slide, model0_dir,
                                                     qc="otsu"))
    check_launches("Heatmap from the model dir", launches,
                   {k: hm_d.timings["batches"] for k in SERVING})
    check(np.array_equal(hm_a.logits == -99, hm_d.logits == -99),
          "heatmap masks")
    err_hm = float(np.abs(hm_a.logits - hm_d.logits).max())
    check(err_hm <= 2e-2, f"heatmap from artifact vs model dir: {err_hm}")
    row["heatmap"] = {"tiles": hm_a.timings["tiles"],
                      "artifact_s": secs_a, "model_dir_s": secs_d,
                      "artifact_batches": hm_a.timings["batches"],
                      "model_dir_batches": hm_d.timings["batches"],
                      "max_abs_err": err_hm, "tol": 2e-2}

    # Features from artifact a: rows 1-3 once a batch.
    (feats, meta, _), launches, secs = counted(lambda: generate_features(
        servables["a"], tfrecords, max_tiles=PREDICT_TILES))
    check_launches("generate_features from artifact a", launches,
                   {k: n_batches for k in SERVING})
    check(feats.shape == (n, 2048) and bool(np.isfinite(feats).all())
          and len(meta) == n, f"features {feats.shape}")
    row["features"] = {"tiles": n, "seconds": secs,
                       "features_k": servables["a"].features_k}
    row["launches"] = path_launches
    return row, path_launches


# ---------------------------------------------------------------------------
# Phases stats, pretrained and resnet
# ---------------------------------------------------------------------------

def stats_frame(seed: int, rows: int, tiles_per_slide: int = STATS_TILES):
    """A synthetic cross-validation tile frame of ``rows`` rows, from
    ``seed``: slides of about ``tiles_per_slide`` tiles in contiguous rows,
    label = slide index % 2, a fifth of the slides hard (70% of their tiles
    wrong, half of those confident), two slides of one label a patient; ``y_pred`` and ``uncertainty`` quantized
    to 1/1024, so exact Youden ties occur, and held as f32 with
    ``y_true``."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(seed)
    n = max(4, round(rows / tiles_per_slide))
    idx = np.repeat(np.arange(n), rng.multinomial(rows, np.full(n, 1.0 / n)))
    label = idx % 2
    hard = (rng.random(n) < 0.2)[idx]
    ok = rng.random(rows) < np.where(hard, 0.3, 0.85)
    pred = np.where(ok == label.astype(bool), rng.uniform(0.5, 1.0, rows),
                    rng.uniform(0.0, 0.5, rows))
    # Confident where right, mostly; on hard slides half the wrong tiles
    # are confident too, so the tile filter leaves wrong slides.
    confident = np.where(ok, rng.random(rows) < 0.9,
                         hard & (rng.random(rows) < 0.5))
    unc = np.where(confident, rng.uniform(0, 0.2, rows),
                   rng.uniform(0.1, 0.5, rows))
    names = np.array([f"slide{i:05d}" for i in range(n)], dtype=object)
    # Slides i and i + 2 (one label) make a patient.
    patients = np.array([f"pt{i // 4 * 2 + i % 2:05d}" for i in range(n)],
                        dtype=object)
    return pd.DataFrame({
        "slide": names[idx], "patient": patients[idx],
        "y_true": label.astype(np.float32),
        "y_pred": (np.round(pred * 1024) / 1024).astype(np.float32),
        "uncertainty": (np.round(unc * 1024) / 1024).astype(np.float32)})


def same_thresholds(what: str, dev, host, exact=("tile_pred", "tile_uq")):
    """Device results against the host's: the keys in ``exact`` equal,
    every other number within 1e-6 (None where the host has None)."""
    import math

    for k, want in host.items():
        got = dev[k]
        if want is None or got is None:
            check(got is None and want is None, f"{what}.{k}: {got} {want}")
        elif k in exact:
            check(got == want, f"{what}.{k}: {got!r} != {want!r}")
        else:
            check((math.isnan(got) and math.isnan(want))
                  or abs(got - want) <= 1e-6, f"{what}.{k}: {got} {want}")


def stats_phase(torch, card: str):
    """The device statistics backend at published scale (see the
    docstring, phase stats). Returns (row, launches)."""
    from biscuit_torch import threshold as th
    from biscuit_torch.ops import _build
    from biscuit_torch.ops import threshold_device as td

    def timed(fn, runs):
        secs, out = [], None
        for _ in range(runs):
            t0 = time.perf_counter()
            out = fn()
            secs.append(time.perf_counter() - t0)
        return statistics.median(secs), out

    _build.reset_launch_counts()
    sizes = []
    for i, rows in enumerate(STATS_ROWS):
        df = stats_frame(SEED + i, rows)
        n_slides = df["slide"].nunique()
        host_runs = 1 if rows >= 4_000_000 else 3
        th.detect(df.copy(), backend="device")              # warm-up
        if host_runs > 1:
            th.detect(df.copy(), backend="host")
        dev_s, dev = timed(lambda: th.detect(df.copy(), backend="device"), 3)
        host_s, host = timed(lambda: th.detect(df.copy(), backend="host"),
                             host_runs)
        # The timed device runs went through the dispatcher, which runs a
        # HostFallback on the host: the backend alone must give the same.
        direct = td.detect_device(df.copy(), device="cuda")
        check(direct == dev, f"{rows} rows: a HostFallback was taken")
        same_thresholds(f"detect {rows}", dev[0], host[0])
        same_thresholds(f"detect {rows} auc", {"auc": dev[1]},
                        {"auc": host[1]})
        check(host[0]["slide_uq"] is not None, "a slide UQ threshold")
        g1 = td._tile_stages(df, "detect", "detect", "slide", "cuda")[3]
        g2 = td._tile_stages(df, "detect", "detect", "slide", "cuda")[3]
        check(all((g1[k] == g2[k]).all() for k in g1),
              f"{rows} rows: the group table repeats bit for bit")
        sizes.append({
            "rows": rows, "slides": n_slides, "host_s": host_s,
            "device_s": dev_s, "host_over_device": host_s / dev_s,
            "host_runs": host_runs, "thresholds": dev[0], "auc": dev[1],
            "host_to_device_bytes": 16 * rows,
            "device_to_host_bytes": 2 * 8 * (4 * td._CAND_K + 3)
            + 4 * 8 * (n_slides + 1)})
        del df
    crossover = None
    for a, b in zip(sizes, sizes[1:]):
        ra, rb = a["host_over_device"], b["host_over_device"]
        if ra < 1 <= rb:
            import math

            t = math.log(ra) / (math.log(ra) - math.log(rb))
            crossover = a["rows"] * (b["rows"] / a["rows"]) ** t
    if crossover is None:
        crossover = (f"below {STATS_ROWS[0]}"
                     if sizes[0]["host_over_device"] >= 1
                     else f"above {STATS_ROWS[-1]}")

    folds = [stats_frame(SEED + 10 + k, STATS_CV_ROWS) for k in range(3)]
    cv = {}
    for backend in ("host", "device"):
        th.from_cv([d.copy() for d in folds], backend=backend)
        cv[backend] = timed(lambda: th.from_cv([d.copy() for d in folds],
                                               backend=backend), 1)
    same_thresholds("from_cv", cv["device"][1], cv["host"][1])
    ext = stats_frame(SEED + 20, STATS_CV_ROWS)
    patients = dict(zip(ext["slide"], ext["patient"]))
    applied = {}
    for backend in ("host", "device"):
        thresholds = cv[backend][1]
        applied[backend] = timed(lambda: th.apply(
            ext.copy(), level="patient", patients=patients,
            backend=backend, **thresholds), 1)
    same_thresholds("apply", applied["device"][1][0], applied["host"][1][0],
                    exact=())
    launches = _build.launch_counts()
    check(not any(launches.values()),
          f"the statistics launch no kernel of the path: {launches}")
    return {"phase": "stats", "card": card, "tiles_per_slide": STATS_TILES,
            "detect": sizes, "crossover_rows": crossover,
            "from_cv": {"folds": 3, "rows": STATS_CV_ROWS,
                        "host_s": cv["host"][0], "device_s": cv["device"][0],
                        "thresholds": cv["device"][1]},
            "apply_patient": {"rows": STATS_CV_ROWS,
                              "host_s": applied["host"][0],
                              "device_s": applied["device"][0],
                              "results": applied["device"][1][0]},
            "launches": launches}, launches


def keras_export(model) -> dict:
    """``model``'s weights as a Keras full-model export, {layer: {weight:
    array}} in graph order: the trunk through the inverse of
    ``models/pretrained.keras_layer_map`` (depthwise kernels back to
    (H, W, I, 1), the BN variance shifted back by the eps difference), then
    the head's Dense layers under Keras auto-names (dense, dense_1, ...)."""
    from biscuit_torch.models.convert import to_flax
    from biscuit_torch.models.pretrained import (
        _FLAX_BN_EPS,
        _KERAS_BN_EPS,
        keras_layer_map,
    )

    params, stats = to_flax(model.state_dict())
    out = {}
    for path, (name, kind) in keras_layer_map(model.arch).items():
        p, s = params["backbone"], stats["backbone"]
        for k in path:
            p, s = p[k], s.get(k, {})
        if kind == "conv":
            out[name] = {"kernel": p["kernel"]}
        elif kind == "sepconv":
            out[name] = {"depthwise_kernel": p["depthwise"]["kernel"]
                         .transpose(0, 1, 3, 2),
                         "pointwise_kernel": p["pointwise"]["kernel"]}
        else:
            out[name] = {"gamma": p["scale"], "beta": p["bias"],
                         "moving_mean": s["mean"],
                         "moving_variance": s["var"]
                         - (_KERAS_BN_EPS - _FLAX_BN_EPS)}
    head = params["head"]
    for i in range(len(head)):
        layer = head["logits" if i == len(head) - 1 else f"hidden{i}"]
        out["dense" if i == 0 else f"dense_{i}"] = {
            "kernel": layer["kernel"], "bias": layer["bias"]}
    return out


def save_keras(path: str, layers: dict) -> None:
    import numpy as np

    np.savez(path, **{f"{layer}/{w}": a for layer, ws in layers.items()
                      for w, a in ws.items()})


def same_trees(what: str, got, want) -> int:
    """Every array of ``got`` equal to ``want``'s, except a BN variance,
    within one f32 ulp (the eps shift and back); returns the count."""
    import numpy as np

    n = 0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            n += same_trees(f"{what}/{k}", g, w)
            continue
        g, w = np.asarray(g), np.asarray(w)
        if k == "var":
            ulp = np.spacing(np.abs(w).astype(np.float32))
            check(bool((np.abs(g - w) <= ulp).all()), f"{what}/{k} ulp")
        else:
            check(np.array_equal(g, w), f"{what}/{k} equal")
        n += 1
    return n


def pretrained_phase(torch, tmp: str, card: str):
    """The Keras import at full width (see the docstring, phase
    pretrained). Returns (row, launches)."""
    import os

    from biscuit_torch.data.normalize import (
        inference_preprocess,
        make_normalizer,
    )
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.convert import read_msgpack, to_flax
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.ops import _build
    from biscuit_torch.train.trainer import (
        init_model,
        make_optimizer,
        make_train_step,
    )
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    hp, model, requests = serving_setup(torch, SEED, REQUESTS)
    hp.dropout = model.dropout = model.head.dropout = 0.0
    with torch.inference_mode():
        feats = trunk_features(model, inference_preprocess(
            requests[0], make_normalizer(hp.normalizer)))
    decisive_logits_(torch, model, feats)
    del feats
    path = os.path.join(tmp, "full.npz")
    t0 = time.perf_counter()
    layers = keras_export(model)
    save_keras(path, layers)
    n_layers = len(layers)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "biscuit_torch.cli.import_model", path,
         os.path.join(tmp, "models"), "--dropout", "0"],
        capture_output=True, text=True, timeout=600)
    import_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"import_model: {proc.stderr[-2000:]}")
    model_dir = proc.stdout.strip().splitlines()[-1]
    src_p, src_s = to_flax(model.state_dict())
    saved = read_msgpack(os.path.join(model_dir, "model.msgpack"))
    arrays = (same_trees("params", saved["params"], src_p)
              + same_trees("batch_stats", saved["batch_stats"], src_s))

    ui_src = UncertaintyInterface.from_model(model, hp, device="cuda",
                                             seed=SEED)
    ui = UncertaintyInterface(model_dir, device="cuda", seed=SEED)
    check(ui.k == K and ui.hp.dropout == 0.0, "imported hp")
    outs, secs, launches = serve(torch, ui, requests, REQUESTS,
                                 {name: 1 for name in SERVING})
    err = spread = 0.0
    for tiles in requests[:REQUESTS]:
        want, _ = ui_src(tiles, seed=SEED)
        got, _ = ui(tiles, seed=SEED)
        err = max(err, (got - want).abs().max().item())
        spread = max(spread, float(want[:, 1].max() - want[:, 1].min()))
    check(err <= 2e-2, f"imported means: max abs err {err}")
    check(spread > 0.2, f"probabilities spread {spread}")
    del ui, ui_src, requests
    torch.cuda.empty_cache()

    # hp.pretrained: init_model grafts the staged trunk, the head is fresh.
    stage = os.path.join(tmp, "stage")
    os.makedirs(stage)
    save_keras(os.path.join(stage, "xception_imagenet.npz"),
               {k: v for k, v in layers.items() if not k.startswith("dense")})
    del layers
    hp2 = nature2022_params()
    fresh = to_flax(init_model(build_model(hp2), hp2,
                               torch.Generator().manual_seed(SEED))
                    .state_dict())[0]["head"]
    old = os.environ.get("BISCUIT_PRETRAINED_DIR")
    os.environ["BISCUIT_PRETRAINED_DIR"] = stage
    try:
        hp2.pretrained = "imagenet"
        t0 = time.perf_counter()
        model2 = init_model(build_model(hp2), hp2,
                            torch.Generator().manual_seed(SEED))
        init_s = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["BISCUIT_PRETRAINED_DIR"]
        else:
            os.environ["BISCUIT_PRETRAINED_DIR"] = old
    got_p, got_s = to_flax(model2.state_dict())
    same_trees("grafted params", got_p["backbone"], src_p["backbone"])
    same_trees("grafted stats", got_s["backbone"], src_s["backbone"])
    same_trees("fresh head", got_p["head"], fresh)
    del model, src_p, src_s, saved
    model2 = model2.cuda()
    step = make_train_step(model2, make_optimizer(hp2, model2.parameters()),
                           hp2, make_normalizer(hp2.normalizer))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batches = [train_batch(torch, gen, TRAIN_BATCH) for _ in range(2)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(step(*b, gen)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_launches = _build.launch_counts()
    for name, count in step_launches.items():
        want = train_launches(2).get(name, 0)
        check(count == want, f"{name}: {count} launches in 2 steps from "
                             f"the grafted trunk, expected {want}")
    import math

    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    del step, model2, batches
    torch.cuda.empty_cache()
    for name, count in step_launches.items():
        launches[name] += count
    return {"phase": "pretrained", "card": card, "model": "xception",
            "tile_px": TILE_PX, "k": K, "requests": REQUESTS,
            "keras_layers": n_layers,
            "npz_bytes": os.path.getsize(path), "write_s": write_s,
            "import_s": import_s, "arrays_checked": arrays,
            "request_s": secs, "tiles_per_s": TILES * REQUESTS / sum(secs),
            "dropout0_mean_max_abs_err": err, "spread": spread,
            "graft_init_s": init_s, "train_step_s": step_s,
            "train_losses": losses, "launches": launches}, launches


def resnet_stage_ms(torch, ui, tiles, repeats: int = 3):
    """Median device time of a ResNet request's stages (CUDA events):
    preprocess (kernel 1), the module trunk, the head (kernel 3)."""
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.ops.mcd_head import mcd_head

    names = ("preprocess", "trunk", "head")
    runs = {name: [] for name in names}
    with torch.inference_mode():
        for _ in range(repeats):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x = inference_preprocess(tiles, ui.wsi_normalizer)
            ev[1].record()
            f = ui.model.features(x)
            ev[2].record()
            mcd_head(f, *ui._head_wts, k=ui.k, dropout=ui.model.dropout)
            ev[3].record()
            torch.cuda.synchronize()
            for i, name in enumerate(names):
                runs[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {name: statistics.median(v) for name, v in runs.items()}


def resnet_phase(torch, tmp: str, card: str):
    """The ResNet family on the card (see the docstring, phase resnet).
    Returns (row, launches)."""
    import copy
    import math
    import os

    from biscuit_torch import serve as sv_mod
    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.ops import _build
    from biscuit_torch.ops.fused_preprocess import (
        fused_preprocess,
        fused_preprocess_reference,
    )
    from biscuit_torch.train.trainer import (
        make_optimizer,
        make_train_step,
        save_checkpoint,
    )
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    hp = nature2022_params()
    hp.model = "resnet50"
    model = build_model(hp)
    check(model.arch == "resnet50" and hp.dropout == 0.1
          and hp.hidden_layer_width == 1024, "resnet50 configuration")
    init_random_(torch, model, SEED)
    model = model.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    shape = (TILES, TILE_PX, TILE_PX, 3)
    requests = [torch.randint(0, 256, shape, generator=gen, device="cuda",
                              dtype=torch.uint8)
                for _ in range(REQUESTS + 1)]
    ui = UncertaintyInterface.from_model(model, hp, device="cuda", seed=SEED)
    check(not ui._fused and ui._use_kernel, "module trunk, head kernel")
    per_request = {"fused_preprocess": 1, "mcd_head": 1}
    outs, secs, launches = serve(torch, ui, requests, REQUESTS, per_request)
    stage_ms = resnet_stage_ms(torch, ui, requests[1])

    with torch.inference_mode():
        tiles = requests[0]
        fk = trunk_features(model, fused_preprocess(tiles, ui.wsi_normalizer))
        f32 = copy.deepcopy(model)
        f32.backbone.compute_dtype = torch.float32
        fp = f32.features(fused_preprocess_reference(tiles,
                                                     ui.wsi_normalizer))
        del f32
        feat_err, feat_scale = held_features("resnet features", fk, fp)
        # Dropout 0, logits spread: the kernel path against the module
        # head (use_kernel=False) on the same model.
        decisive_logits_(torch, model, fk)
        model.dropout = model.head.dropout = 0.0
        hp0 = hp.copy()
        hp0.dropout = 0.0
        kern = UncertaintyInterface.from_model(model, hp0, device="cuda")
        plain = UncertaintyInterface.from_model(model, hp0, device="cuda",
                                                use_kernel=False)
        km, _ = kern(tiles, seed=SEED)
        pm, _ = plain(tiles, seed=SEED)
        head_err = (km - pm).abs().max().item()
        spread = float(pm[:, 1].max() - pm[:, 1].min())
        check(head_err <= 2e-2, f"dropout-0 means: max abs err {head_err}")
        check(spread > 0.2, f"probabilities spread {spread}")
        model.dropout = model.head.dropout = hp.dropout

    # The servable: rows 1 and 3 as ops in the program, equal to the live
    # interface over the model dir bit for bit at the same seed.
    model_dir = save_checkpoint(os.path.join(tmp, "models"), model, hp, 1,
                                OUTCOME, "RN", None)
    t0 = time.perf_counter()
    art = sv_mod.export_servable(model_dir, os.path.join(tmp, "rn.biscuit"),
                                 batch_size=TILES, with_features=False)
    export_s = time.perf_counter() - t0
    sv = sv_mod.load_servable(art)
    live = UncertaintyInterface(model_dir, seed=SEED)
    sv.call_exact(requests[1], seed=SEED)          # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = sv.call_exact(requests[0], seed=SEED)
    torch.cuda.synchronize()
    art_launches = _build.launch_counts()
    for name, count in art_launches.items():
        check(count == per_request.get(name, 0),
              f"artifact: {count} launches of {name}")
    want = live(requests[0], seed=SEED)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "the artifact equals the live interface bit for bit")
    del sv, live, ui, kern, plain, requests, outs
    torch.cuda.empty_cache()

    # Two training steps, module path (no unit-backward kernel). In the
    # warm-up step, the BatchNorms whose input is not channels-last (the
    # op copies those to NHWC).
    from biscuit_torch.models.xception import BatchNorm

    normalizer = make_normalizer(hp.normalizer)
    tx = make_optimizer(hp, model.parameters())
    model.train()
    step = make_train_step(model, tx, hp, normalizer)
    batches = [train_batch(torch, gen, TRAIN_BATCH) for _ in range(3)]
    bn_inputs = []
    hooks = [mod.register_forward_pre_hook(lambda mod, args: bn_inputs.append(
        args[0].permute(0, 2, 3, 1).is_contiguous()))
        for mod in model.modules() if isinstance(mod, BatchNorm)]
    step(*batches[-1], gen)                           # warm-up
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    check(len(bn_inputs) == BN_TRAIN_A_STEP["resnet50"][0],
          f"{len(bn_inputs)} train-mode BatchNorms in a ResNet-50 step")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, step_s = [], []
    for b in batches[:2]:
        t0 = time.perf_counter()
        losses.append(float(step(*b, gen)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    step_launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, count in step_launches.items():
        want = train_launches(2, "resnet50").get(name, 0)
        check(count == want, f"{name}: {count} launches in 2 ResNet-50 "
                             f"steps, expected {want}")
    check(all(math.isfinite(v) for v in losses), f"finite losses {losses}")
    del step, tx, model, batches
    torch.cuda.empty_cache()
    for name, count in (*art_launches.items(), *step_launches.items()):
        launches[name] += count
    return {"phase": "resnet", "card": card, "model": hp.model,
            "tile_px": TILE_PX, "k": K, "dropout": hp.dropout,
            "hidden": [hp.hidden_layer_width] * 2, "requests": REQUESTS,
            "tiles_per_request": TILES, "request_s": secs,
            "tiles_per_s": TILES * REQUESTS / sum(secs), "stage_ms": stage_ms,
            "features_max_abs_err": feat_err,
            "features_tol": 3e-2 * feat_scale, "features_max_abs": feat_scale,
            "dropout0_mean_max_abs_err": head_err, "spread": spread,
            "servable": {"export_s": export_s, "bytes": os.path.getsize(art),
                         "launches": art_launches},
            "train": {"batch": TRAIN_BATCH, "steps": 2, "step_s": step_s,
                      "tiles_per_s": TRAIN_BATCH * 2 / sum(step_s),
                      "losses": losses, "max_memory_allocated_bytes": peak,
                      "launches": step_launches,
                      "bn_inputs_not_channels_last": bn_inputs.count(False)},
            "launches": launches}, launches


def int8_stage_ms(torch, ui, tiles, int8: bool, repeats: int = 3):
    """Median device time of a request's preprocess, trunk and head
    (CUDA events between the request's own calls), with the int8 trunk
    or the bf16 one."""
    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.ops.int8_trunk import trunk_features_int8
    from biscuit_torch.train.uq import mc_dropout_head, trunk_features

    names = ("preprocess", "trunk", "head")
    runs = {name: [] for name in names}
    with torch.inference_mode():
        for _ in range(repeats):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            x = inference_preprocess(tiles, ui.wsi_normalizer)
            ev[1].record()
            if int8:
                f = trunk_features_int8(ui.model, x, ui._qw, True, ui._mid_wts)
            else:
                f = trunk_features(ui.model, x, True, ui._mid_wts)
            ev[2].record()
            mc_dropout_head(ui.model, f, 0, ui.k, True, ui._head_wts)
            ev[3].record()
            torch.cuda.synchronize()
            for i, name in enumerate(names):
                runs[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {name: statistics.median(v) for name, v in runs.items()}


def counted(torch, fn, want: dict, what: str):
    """``fn()`` with the launch counts zeroed just before and read just
    after; fails unless each kernel launched ``want.get(name, 0)``
    times. Returns (fn's result, seconds, launches)."""
    from biscuit_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _build.launch_counts()
    for name, count in launches.items():
        check(count == want.get(name, 0),
              f"{what}: {name} launched {count} times, expected "
              f"{want.get(name, 0)}")
    return out, secs, launches


def add_launches(total: dict, launches: dict) -> None:
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count


def cosine_min(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1))).min())


def int8_phase(torch, hp, model, requests, tmp: str, card: str):
    """The opt-in w8a8 trunk at full width (see the docstring, phase
    int8). Returns (row, launches of the counted requests)."""
    import os

    from biscuit_torch.data.normalize import inference_preprocess
    from biscuit_torch.ops.int8_trunk import int8_matmul, trunk_features_int8
    from biscuit_torch.ops.mcd_head import mcd_head
    from biscuit_torch.train.uq import UncertaintyInterface, trunk_features

    t_phase = time.perf_counter()
    head = model.head.logits
    saved_head = (head.weight.detach().clone(), head.bias.detach().clone())
    ui = UncertaintyInterface.from_model(model, hp, device="cuda")
    with torch.inference_mode():
        x0 = inference_preprocess(requests[0], ui.wsi_normalizer)
        f0 = trunk_features(model, x0, True, ui._mid_wts).clone()
    decisive_logits_(torch, model, f0)
    del ui, x0, f0
    cal_path = os.path.join(tmp, "int8_calibration.json")
    plain = UncertaintyInterface.from_model(model, hp, device="cuda",
                                            seed=SEED)
    q8 = UncertaintyInterface.from_model(model, hp, device="cuda", seed=SEED,
                                         int8_trunk=True,
                                         calibration_path=cal_path)
    check(q8._CALIB_MIN_TILES == TILES, "one request calibrates")
    launches = {}
    once = {name: 1 for name in SERVING}
    # The calibration request: answered as without int8 (rows 1-3 once),
    # plus the calibrator's f32 forward through the middle-flow kernel.
    torch.cuda.reset_peak_memory_stats()
    cal_out, cal_s, got = counted(
        torch, lambda: q8(requests[0]),
        {**once, "fused_middle_flow": 2}, "calibration request")
    cal_peak = torch.cuda.max_memory_allocated()
    add_launches(launches, got)
    check(q8._qw is not None and os.path.exists(cal_path),
          "calibrated and saved after one request")
    for a, b in zip(cal_out, plain(requests[0])):
        check(torch.equal(a, b), "the calibration request equals the bf16 "
                                 "path bit for bit")

    torch.cuda.reset_peak_memory_stats()
    outs8, secs8, got = serve(torch, q8, requests, REQUESTS, once)
    peak8 = torch.cuda.max_memory_allocated()
    add_launches(launches, got)
    torch.cuda.reset_peak_memory_stats()
    _, secs16, _ = serve(torch, plain, requests, REQUESTS, once)
    peak16 = torch.cuda.max_memory_allocated()
    stage8 = int8_stage_ms(torch, q8, requests[1], True)
    stage16 = int8_stage_ms(torch, plain, requests[1], False)
    prof8 = kernel_profile(torch, lambda: q8(requests[1]))

    # Features and dropout-0 means of a request that did not calibrate.
    with torch.inference_mode():
        x1 = inference_preprocess(requests[1], q8.wsi_normalizer)
        f8 = trunk_features_int8(model, x1, q8._qw, True, q8._mid_wts)
        f16 = trunk_features(model, x1, True, q8._mid_wts)
        cos = cosine_min(torch, f8, f16)
        check(cos > 0.98, f"int8 features: min cosine {cos} <= 0.98")
        m8, _ = mcd_head(f8, *q8._head_wts, k=K, dropout=0.0, seed=0)
        m16, _ = mcd_head(f16, *q8._head_wts, k=K, dropout=0.0, seed=0)
        spread = float(m16[:, 1].max() - m16[:, 1].min())
        check(spread > 0.2, f"dropout-0 probabilities spread {spread}")
        mean_err = float((m8 - m16).abs().max())
        check(mean_err <= INT8_MEAN_TOL,
              f"int8 dropout-0 means: max abs err {mean_err}")
        del x1, f8, f16

    # A second interface from the saved scales: int8 from its first call,
    # equal to the first interface bit for bit.
    q8b = UncertaintyInterface.from_model(model, hp, device="cuda", seed=SEED,
                                          int8_trunk=True,
                                          calibration_path=cal_path)
    check(q8b._qw is not None, "the saved calibration loads")
    out_b, _, got = counted(torch, lambda: q8b(requests[1], seed=77), once,
                            "first request from a saved calibration")
    add_launches(launches, got)
    for a, b in zip(out_b, q8(requests[1], seed=77)):
        check(torch.equal(a, b), "saved scales serve bit for bit")
    del q8b

    # The middle quantized too: no middle-flow launch once calibrated.
    os.environ["BISCUIT_INT8_MIDDLE"] = "1"
    try:
        qm = UncertaintyInterface.from_model(model, hp, device="cuda",
                                             seed=SEED, int8_trunk=True)
        _, qm_cal_s, got = counted(torch, lambda: qm(requests[0]), once,
                                   "calibration request, int8 middle")
        add_launches(launches, got)
        outs_m, secs_m, got = serve(torch, qm, requests, REQUESTS,
                                    {"fused_preprocess": 1, "mcd_head": 1})
        add_launches(launches, got)
        check(any(n.startswith("middle") for n in qm._scales),
              "middle sites calibrated")
        with torch.inference_mode():
            x1 = inference_preprocess(requests[1], qm.wsi_normalizer)
            cos_m = cosine_min(torch, trunk_features_int8(
                model, x1, qm._qw, True), trunk_features(
                model, x1, True, plain._mid_wts))
        check(cos_m > 0.98, f"int8-middle features: min cosine {cos_m}")
        stage_m = int8_stage_ms(torch, qm, requests[1], True)
        del qm, x1
    finally:
        del os.environ["BISCUIT_INT8_MIDDLE"]

    # The int8 product alone: exact against f64 at three of the trunk's
    # shapes, and its time beside a bf16 matmul of the same shape.
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mm = []
    for rows, k, n in INT8_MM_SHAPES:
        a = torch.randint(-127, 128, (rows, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        wt = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        got_mm = int8_matmul(a, wt)
        exact = torch.equal(got_mm.double(), a.double() @ wt.double().t())
        check(exact, f"_int_mm at {rows}x{k}x{n} equals the f64 product")
        ab, wb = a.bfloat16(), wt.bfloat16()
        mm.append({"rows": rows, "k": k, "n": n, "exact": exact,
                   "int8_ms": cuda_ms(torch, lambda _: int8_matmul(a, wt),
                                      [None] * N_TIMED),
                   "bf16_ms": cuda_ms(torch, lambda _: ab @ wb.t(),
                                      [None] * N_TIMED)})
        del a, wt, ab, wb, got_mm
    torch.cuda.empty_cache()
    with torch.no_grad():
        head.weight.copy_(saved_head[0])
        head.bias.copy_(saved_head[1])
    return {
        "phase": "int8", "model": "xception", "tile_px": TILE_PX, "k": K,
        "dropout": hp.dropout, "requests": REQUESTS,
        "tiles_per_request": TILES, "card": card,
        "phase_s": time.perf_counter() - t_phase,
        "calibration_request_s": cal_s,
        "calibration_peak_bytes": cal_peak,
        "int8": {"request_s": secs8,
                 "tiles_per_s": TILES * REQUESTS / sum(secs8),
                 "stage_ms": stage8, "max_memory_allocated_bytes": peak8,
                 "mean_of_mean": outs8[0][0].mean(0).tolist(),
                 "profile": prof8},
        "bf16": {"request_s": secs16,
                 "tiles_per_s": TILES * REQUESTS / sum(secs16),
                 "stage_ms": stage16, "max_memory_allocated_bytes": peak16},
        "int8_middle": {"calibration_request_s": qm_cal_s,
                        "request_s": secs_m,
                        "tiles_per_s": TILES * REQUESTS / sum(secs_m),
                        "stage_ms": stage_m, "features_min_cosine": cos_m},
        "features_min_cosine": cos, "dropout0_ptp": spread,
        "dropout0_mean_max_abs_err": mean_err,
        "dropout0_tol": INT8_MEAN_TOL, "int_mm": mm, "launches": launches,
    }, launches


def parallel_child(rank: int, args_path: str) -> int:
    """One of the two processes of phase parallel: joins the store, scores
    its claims of the tfrecords, then trains its claims of the folds;
    writes its frame (pickle) and a JSON line of seconds and launches."""
    import os

    import torch

    from biscuit_torch import serve as sv_mod
    from biscuit_torch.experiment import Experiment
    from biscuit_torch.ops import _build
    from biscuit_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args_path) as f:
        args = json.load(f)
    t0 = time.perf_counter()
    distributed.initialize(args["addr"], 2, rank, timeout_s=120)
    torch.zeros(1, device="cuda")
    sv = sv_mod.load_servable(args["artifact"])
    out = {"rank": rank, "init_s": time.perf_counter() - t0}
    distributed.barrier("ready")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    df = sv_mod.predict_tfrecords_distributed(sv, args["tfrecords"],
                                              args["workdir"], seed=SEED)
    torch.cuda.synchronize()
    out["score_s"] = time.perf_counter() - t0
    out["score_launches"] = _build.launch_counts()
    df.to_pickle(f"{args['out']}_{rank}.pkl")
    exp = Experiment(args["train_root"], outdir=os.path.join(
        args["train_root"], f"results{rank}"))
    exp.train_kwargs = {"n_submeshes": 1,
                        "steps_per_epoch_override": PAR_STEPS}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    exp.run({"ZD": {"out1": PAR_SLIDES // 2, "out2": PAR_SLIDES // 2}},
            steps=[2])
    torch.cuda.synchronize()
    out["folds_s"] = time.perf_counter() - t0
    out["fold_launches"] = _build.launch_counts()
    with open(f"{args['out']}_{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def parallel_phase(torch, tmp: str, card: str):
    """Two processes sharing the card through a TCPStore on localhost (see
    the docstring, phase parallel). Returns (row, launches)."""
    import dataclasses
    import os
    import socket

    import pandas as pd

    from biscuit_torch import serve as sv_mod
    from biscuit_torch.data.tfrecord import TFRecordWriter
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.models.xception import build_model
    from biscuit_torch.ops import _build
    from biscuit_torch.train.trainer import save_checkpoint

    stage = {}
    t_phase = t0 = time.perf_counter()
    hp = dataclasses.replace(nature2022_params(), uq=True, uq_samples=K)
    model = build_model(hp)
    init_random_(torch, model, SEED + 7)
    model_dir = save_checkpoint(os.path.join(tmp, "pmodel"), model, hp,
                                epoch=1, outcome=OUTCOME, label="PAR",
                                kfold=None)
    del model
    art = sv_mod.export_servable(model_dir, os.path.join(tmp, "p.biscuit"),
                                 batch_size=PAR_BATCH, with_features=False)
    stage["export_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    per = len(PREDICT_LABELS) * PREDICT_TILES // PAR_TFRECORDS
    tiles = smooth_tiles(per * PAR_TFRECORDS, SEED)
    tfr = os.path.join(tmp, "ptfr")
    os.makedirs(tfr)
    paths = []
    for s in range(PAR_TFRECORDS):
        paths.append(os.path.join(tfr, f"pslide{s}.tfrecords"))
        with TFRecordWriter(paths[-1]) as w:
            for t in range(per):
                w.write_tile(f"pslide{s}", encode_png(tiles[s * per + t]),
                             loc_x=TILE_PX * t, loc_y=0)
    del tiles
    train_P, _ = write_project(tmp, "ptrain", PAR_SLIDES, PAR_TILES,
                               SEED + 4, ("LUAD", "LUSC"))
    stage["write_s"] = time.perf_counter() - t0

    # One process: the same call, the same seed (each tfrecord alone in
    # its batches, as in the group), and the whole list in one call.
    sv = sv_mod.load_servable(art)
    single_wd = os.path.join(tmp, "scored_single")
    single, stage["single_score_s"], single_launches = counted(
        torch, lambda: sv_mod.predict_tfrecords_distributed(
            sv, paths, single_wd, seed=SEED),
        {name: PAR_TFRECORDS for name in SERVING}, "single-process scoring")
    whole = sv_mod.predict_tfrecords(sv, paths, seed=SEED)
    check(whole[["slide", "loc_x", "loc_y"]].equals(
        single[["slide", "loc_x", "loc_y"]]), "rows of the merged frame")
    launches = dict(single_launches)

    # The group.
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = {"addr": f"127.0.0.1:{port}", "artifact": art, "tfrecords": paths,
            "workdir": os.path.join(tmp, "scored"),
            "train_root": train_P.root, "out": os.path.join(tmp, "child")}
    args_path = os.path.join(tmp, "child_args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    t0 = time.perf_counter()
    logs = [open(os.path.join(tmp, f"child{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-child",
         str(r), args_path], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__))) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    stage["group_s"] = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"child{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"child {r} exited {p.returncode}")
    children = []
    for r in range(2):
        with open(f"{args['out']}_{r}.json") as f:
            children.append(json.load(f))
    frames = [pd.read_pickle(f"{args['out']}_{r}.pkl") for r in range(2)]
    for r, frame in enumerate(frames):
        check(frame.equals(single), f"process {r}'s merged frame equals the "
                                    "single-process one bit for bit")
    for name in SERVING:
        n = sum(c["score_launches"][name] for c in children)
        check(n == PAR_TFRECORDS, f"{name}: {n} launches in the group's "
                                  f"scoring, expected {PAR_TFRECORDS}")
    dirs = sorted(os.listdir(train_P.models_dir))
    check(sorted(d[6:] for d in dirs) == [
        f"{OUTCOME}-EXP_ZD-HP0-kfold{k}" for k in (1, 2, 3)],
        f"each fold trained once: {dirs}")
    for d in dirs:
        check(os.path.exists(os.path.join(train_P.models_dir, d,
                                          "results_log.csv")),
              f"{d} completed")
    strips = sum(c["fold_launches"]["unit_bwd_strips"] for c in children)
    want = UNITS_PER_STEP * PAR_STEPS * 3
    check(strips == want, f"unit_bwd_strips: {strips} launches for 3 folds "
                          f"of {PAR_STEPS} steps, expected {want}")
    for c in children:
        add_launches(launches, c["score_launches"])
        add_launches(launches, c["fold_launches"])

    # The sharded servable over this process's one card.
    sh = sv_mod.load_sharded_servable(art)
    check(sh.n_shards == torch.cuda.device_count(), "one shard a card")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    req = torch.randint(0, 256, (sh.global_batch, TILE_PX, TILE_PX, 3),
                        generator=gen, device="cuda", dtype=torch.uint8)
    got, stage["sharded_call_s"], sh_launches = counted(
        torch, lambda: sh.call_exact(req, seed=5),
        {name: sh.n_shards for name in SERVING}, "sharded servable")
    add_launches(launches, sh_launches)
    want_out = sv.call_exact(req[:PAR_BATCH], seed=sv_mod._fold_seed(5, 0))
    for a, b in zip(got, want_out):
        check(torch.equal(a[:PAR_BATCH], b),
              "sharded servable equals the servable bit for bit")
    return {
        "phase": "parallel", "processes": 2, "card": card,
        "phase_s": time.perf_counter() - t_phase,
        "tfrecords": PAR_TFRECORDS, "tiles": len(single),
        "servable_batch": PAR_BATCH, "folds": 3, "steps_a_fold": PAR_STEPS,
        "stage_s": stage, "children": children,
        "merged_equals_single": "bit for bit (each tfrecord in its own "
                                "batches, at the same seeds)",
        "launches": launches,
    }, launches


def lockstep_batches(torch, seed: int):
    """The step comparison's LS_STEPS global batches, the same in every
    process: tiles, labels, mask on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [train_batch(torch, gen, LS_BATCH) for _ in range(LS_STEPS)]


def lockstep_steps(torch, hp, seed: int, group=None, steps: int = LS_STEPS,
                   reverse: bool = False, share=None):
    """``steps`` fused-trunk steps of ``hp`` on seeded weights and
    batches, as one process (``group`` None; ``reverse`` reverses the rows
    of each batch, which leaves the step's function as it is; ``share``
    r keeps only the rows rank r of a group would hold) or as one rank of
    a group on its rows; returns (each step's seconds and loss, the
    launches of the steps, the collectives and bytes of one step and a
    checksum of the weights after; step 1's ``tree``, f32 on the host:
    each parameter's gradient as ``grad/<name>`` and each BatchNorm's
    batch statistics as ``stat/<buffer>``, recovered from the running
    blend)."""
    import hashlib

    from biscuit_torch.data.normalize import make_normalizer
    from biscuit_torch.models.xception import MOMENTUM, build_model
    from biscuit_torch.ops import _build
    from biscuit_torch.train.trainer import make_optimizer, make_train_step

    model = build_model(hp)
    init_random_(torch, model, seed)
    model = model.cuda()
    tx = make_optimizer(hp, model.parameters())
    step = make_train_step(model, tx, hp, make_normalizer(hp.normalizer),
                           group=group)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = lockstep_batches(torch, seed)[:steps]
    if group is not None:
        share = group.rank
    if share is not None:
        n = LS_BATCH // LS_RANKS
        batches = [[t[share * n:][:n] for t in b] for b in batches]
    elif reverse:
        batches = [[t.flip(0) for t in b] for b in batches]
    stats0 = {k: v.float().cpu() for k, v in running_stats(model).items()}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    secs, losses, comm = [], [], []
    for i, b in enumerate(batches):
        before = (group.collectives, group.bytes, group.seconds,
                  group.bucket_seconds) if group else None
        t0 = time.perf_counter()
        out = step(*b, gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(out["loss"]))
        if group is not None:
            comm.append([now - was for now, was in zip(
                (group.collectives, group.bytes, group.seconds,
                 group.bucket_seconds), before)])
        if i == 0:
            tree = {f"grad/{k}": p.grad.detach().float().cpu()
                    for k, p in model.named_parameters()}
            for k, v in running_stats(model).items():
                tree[f"stat/{k}"] = (v.float().cpu() - MOMENTUM * stats0[k]
                                     ) / (1.0 - MOMENTUM)
    launches = _build.launch_counts()
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    return {"loss": losses[0], "losses": losses, "step_s": secs,
            "launches": launches,
            "collectives_a_step": comm[-1][0] if comm else 0,
            "bytes_a_step": comm[-1][1] if comm else 0,
            "collective_s": [c[2] for c in comm],
            "bucket_s": [c[3] for c in comm],
            "params_sha256": digest.hexdigest()}, tree


def clean_hp(hp):
    """``hp`` with augmentation and dropout off (the gradient check)."""
    hp = hp.copy()
    hp.augment, hp.dropout = "", 0.0
    return hp


def rel_l2(got, want) -> float:
    return float((got - want).norm() / want.norm())


def bn_off_tree(trees):
    """Rank 0's step-1 tree in a group whose BatchNorm collectives are
    off, from its ranks' one-process steps on their rows: the mean of
    their gradients (equal shares and full masks, so the group's loss is
    the mean of theirs), and its own batch statistics."""
    return {k: sum(t[k] for t in trees) / len(trees)
            if k.startswith("grad/") else trees[0][k] for k in trees[0]}


def tree_distance(torch, got, want) -> dict:
    """How far a step-1 tree is from another: the gradients' relative L2
    over the model and their largest difference over the largest
    gradient; for the BatchNorms' statistics the largest, over them, of
    each one's largest difference over its largest value; and by block of
    the model (``by_block``) the largest of its leaves' distances (the
    relative L2 of a gradient, the above of a statistic)."""
    keys = [k for k in want if k.startswith("grad/")]
    g = torch.cat([got[k].reshape(-1) for k in keys])
    w = torch.cat([want[k].reshape(-1) for k in keys])
    leaf = {}
    for k in want:
        if k.startswith("grad/"):
            leaf[k] = rel_l2(got[k], want[k])
        else:
            leaf[k] = float((got[k] - want[k]).abs().max()
                            / want[k].abs().max())
    stats = [v for k, v in leaf.items() if k.startswith("stat/")]
    blocks = {}
    for k, v in leaf.items():
        kind, name = k.split("/")
        parts = name.split(".")
        block = parts[1] if parts[0] == "backbone" else parts[0]
        blocks.setdefault(f"{kind}/{block}", []).append(v)
    return {"grad_rel_l2": rel_l2(g, w),
            "grad_max_rel": float((g - w).abs().max() / w.abs().max()),
            "stat_max_rel": max(stats),
            "by_block": {b: max(v) for b, v in blocks.items()}}


def lockstep_child(rank: int, args_path: str) -> int:
    """One of the LS_RANKS processes of phase lockstep: joins the store,
    runs the step comparison as one rank of a group on the shared card,
    then one ``train_project`` fold and ``Experiment.run``'s step 2 over
    a mesh that spans the processes; writes a JSON line of its numbers
    (rank 0 also its step-1 gradient)."""
    import dataclasses
    import os

    import torch

    from biscuit_torch.experiment import Experiment
    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.ops import _build
    from biscuit_torch.parallel import distributed
    from biscuit_torch.parallel.lockstep import run_ranks
    from biscuit_torch.parallel.mesh import Mesh
    from biscuit_torch.project import Project

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args_path) as f:
        args = json.load(f)
    t0 = time.perf_counter()
    distributed.initialize(args["addr"], LS_RANKS, rank, timeout_s=120)
    torch.zeros(1, device="cuda")
    out = {"rank": rank, "init_s": time.perf_counter() - t0}
    mesh = Mesh(["cuda:0"], spans_processes=True)
    hp = nature2022_params()

    def steps(group):
        group.barrier("ready")
        group.connect()
        row, _ = lockstep_steps(torch, hp, SEED + 11, group)
        row["backend"] = group.backend
        row["clean"], tree = lockstep_steps(torch, clean_hp(hp), SEED + 11,
                                            group, steps=1)
        return row, tree

    out["steps"], tree = run_ranks(mesh, steps, name="steps")
    if rank == 0:
        torch.save(tree, f"{args['out']}_tree.pt")
    del tree
    torch.cuda.empty_cache()

    tp_hp = dataclasses.replace(hp, uq=True, uq_samples=K, epochs=[1])
    project = Project(args["tp_root"])
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    (model_dir,) = project.train(
        OUTCOME, "smoke", params=tp_hp, val_k=[1], val_k_fold=TP_FOLDS,
        steps_per_epoch_override=LS_TP_STEPS, validate_on_batch=LS_TP_STEPS,
        validation_steps=1, save_model=True, checkpoint_every=LS_TP_STEPS,
        mesh=mesh)
    torch.cuda.synchronize()
    out["train_project"] = {"seconds": time.perf_counter() - t0,
                            "model_dir": model_dir,
                            "launches": _build.launch_counts()}
    torch.cuda.empty_cache()

    exp = Experiment(args["ex_root"], outdir=os.path.join(
        args["ex_root"], f"results{rank}"))
    exp.train_kwargs = {"steps_per_epoch_override": LS_TP_STEPS}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    exp.run({"ZD": {"out1": PAR_SLIDES // 2, "out2": PAR_SLIDES // 2}},
            steps=[2])
    torch.cuda.synchronize()
    out["experiment"] = {"seconds": time.perf_counter() - t0,
                         "launches": _build.launch_counts()}
    with open(f"{args['out']}_{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def lockstep_phase(torch, tmp: str, card: str):
    """Lockstep data parallelism on the card (see the docstring, phase
    lockstep). Returns (row, launches)."""
    import dataclasses
    import os
    import socket

    from biscuit_torch.hp import nature2022_params
    from biscuit_torch.ops import _build

    t_phase = time.perf_counter()
    hp = nature2022_params()
    check(hp.batch_size == LS_BATCH and hp.augment == "xyrjb"
          and hp.dropout == 0.1 and hp.compute_dtype == "bfloat16",
          "published configuration")
    single, _ = lockstep_steps(torch, hp, SEED + 11)
    clean, clean_tree = lockstep_steps(torch, clean_hp(hp), SEED + 11,
                                       steps=1)
    rev, rev_tree = lockstep_steps(torch, clean_hp(hp), SEED + 11, steps=1,
                                   reverse=True)
    shares = [lockstep_steps(torch, clean_hp(hp), SEED + 11, steps=1,
                             share=r) for r in range(LS_RANKS)]
    distance = {"rows_reversed": tree_distance(torch, rev_tree, clean_tree),
                "bn_collectives_off": tree_distance(
                    torch, bn_off_tree([t for _, t in shares]),
                    clean_tree)}
    shares = [row for row, _ in shares]
    del rev_tree
    torch.cuda.empty_cache()
    tp, _ = write_project(tmp, "tp", TP_SLIDES, TP_TILES, SEED + 1,
                          ("class0", "class1"))
    ex, _ = write_project(tmp, "lsx", PAR_SLIDES, PAR_TILES, SEED + 4,
                          ("LUAD", "LUSC"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = {"addr": f"127.0.0.1:{port}", "tp_root": tp.root,
            "ex_root": ex.root, "out": os.path.join(tmp, "lschild")}
    args_path = os.path.join(tmp, "lschild_args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    t0 = time.perf_counter()
    logs = [open(os.path.join(tmp, f"lschild{r}.log"), "w")
            for r in range(LS_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--lockstep-child",
         str(r), args_path], stdout=logs[r], stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for r in range(LS_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    group_s = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"lschild{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"lockstep child {r} exited {p.returncode}")
    children = []
    for r in range(LS_RANKS):
        with open(f"{args['out']}_{r}.json") as f:
            children.append(json.load(f))

    # The step comparison.
    ranks = [c["steps"] for c in children]
    check(all(r["backend"] == "gloo" for r in ranks),
          "two ranks on one card: gloo")
    check(len({r["params_sha256"] for r in ranks}) == 1,
          "the ranks' weights are bit-identical after the steps")
    check(len({tuple(r["losses"]) for r in ranks}) == 1,
          "every rank reads the group's losses")
    loss_err = abs(ranks[0]["loss"] - single["loss"])
    check(loss_err <= LS_LOSS_RTOL * abs(single["loss"]),
          f"step-1 loss {ranks[0]['loss']} against one process's "
          f"{single['loss']}")
    tree = torch.load(f"{args['out']}_tree.pt")
    check(all(bool(torch.isfinite(v).all()) for v in tree.values()),
          "finite step-1 gradients and statistics")
    distance["group"] = tree_distance(torch, tree, clean_tree)
    del tree, clean_tree
    floor = distance["rows_reversed"]["grad_rel_l2"]
    grad_l2 = distance["group"]["grad_rel_l2"]
    grad_max = distance["group"]["grad_max_rel"]
    gates = {"stat_max_rel": LS_STAT_LIMIT,
             "grad_rel_l2": LS_GRAD_RATIO * floor}
    for metric, limit in gates.items():
        got = distance["group"][metric]
        check(got <= limit, f"step 1, {metric}: the group's {got} > {limit}")
        ctrl = distance["bn_collectives_off"][metric]
        check(ctrl > limit, f"step 1, {metric}: the control with the BN "
                            f"collectives off passes the gate ({ctrl} <= "
                            f"{limit}), so the gate cannot tell")
    runs = [("one process", single, LS_STEPS), ("one process, clean", clean,
                                                 1), ("rows reversed", rev, 1)]
    runs += [(f"share {r}", row, 1) for r, row in enumerate(shares)]
    for r, c in enumerate(ranks):
        runs += [(f"rank {r}", c, LS_STEPS), (f"rank {r}, clean", c["clean"],
                                              1)]
    for who, row, steps in runs:
        for name, count in row["launches"].items():
            want = train_launches(steps).get(name, 0)
            check(count == want, f"{who}: {name} {count} launches in "
                                 f"{steps} steps, expected {want}")

    # The fold and the protocol step over the spanning mesh.
    tp_dir = children[0]["train_project"]["model_dir"]
    check(all(c["train_project"]["model_dir"] == tp_dir for c in children)
          and len(os.listdir(tp.models_dir)) == 1,
          "one model dir, named alike on every rank")
    tp_hp = dataclasses.replace(hp, uq=True, uq_samples=K, epochs=[1])
    check_model_dir(tp_dir, 1, (1,), [1], tp_hp)
    launches = {name: 0 for name in _build.KERNELS}
    for row in (single, clean, rev, *shares):
        add_launches(launches, row["launches"])
    for r, c in enumerate(children):
        add_launches(launches, c["steps"]["launches"])
        add_launches(launches, c["steps"]["clean"]["launches"])
        for what, steps, serving in (
                ("train_project", LS_TP_STEPS, 1 if r == 0 else 0),
                ("experiment", 3 * LS_TP_STEPS, 0)):
            got = c[what]["launches"]
            for name, count in got.items():
                want = train_launches(steps).get(
                    name, serving if name in SERVING else 0)
                check(count == want, f"rank {r} {what}: {name} {count} "
                                     f"launches, expected {want}")
            add_launches(launches, got)
    dirs = sorted(os.listdir(ex.models_dir))
    check(sorted(d[6:] for d in dirs) == [
        f"{OUTCOME}-EXP_ZD-HP0-kfold{k}" for k in (1, 2, 3)],
        f"each fold trained once, by the group: {dirs}")
    for d in dirs:
        check(os.path.exists(os.path.join(ex.models_dir, d,
                                          "results_log.csv")),
              f"{d} completed")
    timed = slice(1, None)

    def rate(row):
        s = statistics.mean(row["step_s"][timed])
        return {"s_a_step": s, "tiles_per_s": LS_BATCH / s,
                "step_s": row["step_s"], "losses": row["losses"]}

    return {
        "phase": "lockstep", "processes": LS_RANKS, "card": card,
        "model": hp.model, "batch": LS_BATCH, "steps": LS_STEPS,
        "phase_s": time.perf_counter() - t_phase, "group_s": group_s,
        "one_process": rate(single), "group": rate(ranks[0]),
        "rank_init_s": [c["init_s"] for c in children],
        "step1_loss_abs_err": loss_err, "loss_rtol": LS_LOSS_RTOL,
        "clean_step1_loss": {"one_process": clean["loss"],
                             "rows_reversed": rev["loss"],
                             "group": ranks[0]["clean"]["loss"]},
        "step1_grad_rel_l2": grad_l2, "step1_grad_max_rel": grad_max,
        "grad_noise_floor_rel_l2": floor, "step1_gates": gates,
        "step1_distance": distance,
        "params_sha256_equal": True,
        "collectives_a_step": ranks[0]["collectives_a_step"],
        "collective_bytes_a_step": ranks[0]["bytes_a_step"],
        "collective_s": [r["collective_s"] for r in ranks],
        "bucket_s": [r["bucket_s"] for r in ranks],
        "train_project_s": [c["train_project"]["seconds"]
                            for c in children],
        "experiment_s": [c["experiment"]["seconds"] for c in children],
        "launches": launches,
    }, launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of biscuit_torch "
                                 "on one CUDA card (see the docstring).")
    ap.add_argument("--unit-bwd-passes", action="store_true",
                    help="only the per-pass profile of the unit backward at "
                         "UNIT_PASS_GEOMETRIES")
    ap.add_argument("--preprocess", action="store_true",
                    help="only row 1 and one request's preprocess stage")
    ap.add_argument("--slide", action="store_true",
                    help="only the build and phase slide")
    ap.add_argument("--serve", action="store_true",
                    help="only the build and phase serve")
    ap.add_argument("--stats", action="store_true",
                    help="only the build and phase stats")
    ap.add_argument("--pretrained", action="store_true",
                    help="only the build and phase pretrained")
    ap.add_argument("--resnet", action="store_true",
                    help="only the build and phase resnet")
    ap.add_argument("--int8", action="store_true",
                    help="only the build and phase int8")
    ap.add_argument("--parallel", action="store_true",
                    help="only the build and phase parallel")
    ap.add_argument("--parallel-child", nargs=2, metavar=("RANK", "ARGS"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--lockstep", action="store_true",
                    help="only the build, the unit-backward kernel rows "
                         "(whose group route the phase runs) and phase "
                         "lockstep")
    ap.add_argument("--lockstep-child", nargs=2, metavar=("RANK", "ARGS"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--bn-train", action="store_true",
                    help="only the build of csrc/bn_train.cu and its two "
                         "kernel rows")
    ap.add_argument("--root", help="import biscuit_torch from this checkout "
                                   "(with --unit-bwd-passes or --preprocess)")
    opts = ap.parse_args(argv)
    if opts.root:
        sys.path.insert(0, opts.root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if opts.parallel_child:
        return parallel_child(int(opts.parallel_child[0]),
                              opts.parallel_child[1])
    if opts.lockstep_child:
        return lockstep_child(int(opts.lockstep_child[0]),
                              opts.lockstep_child[1])
    from biscuit_torch.ops import _build

    tf32_default = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})
    if opts.unit_bwd_passes:
        t0 = time.perf_counter()
        _build.build_all((_build.SOURCE["unit_bwd_strips"],))
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "biscuit_torch": _build.__file__})
        unit_bwd_passes(torch, torch.Generator(device="cuda").manual_seed(SEED))
        return 0
    if opts.bn_train:
        t0 = time.perf_counter()
        _build.build_all((_build.SOURCE["bn_train_fwd"],))
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": ptxas_entries(_build.build_log("bn_train"),
                                     ("bn_",))})
        for row in kernel_bn_train(
                torch, torch.Generator(device="cuda").manual_seed(SEED)):
            emit({"phase": "kernel", **row, "card": card})
        return 0
    if opts.preprocess:
        t0 = time.perf_counter()
        _build.build_all((_build.SOURCE["fused_preprocess"],))
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "biscuit_torch": _build.__file__,
              "ptxas": [ln.strip() for ln in _build.build_log(
                  "fused_preprocess").splitlines()
                  if "registers" in ln or "spill" in ln]})
        preprocess_compare(torch,
                           torch.Generator(device="cuda").manual_seed(SEED))
        return 0

    import threading

    from biscuit_torch.data import native_loader

    # The native data plane builds with g++ while nvcc builds the kernels;
    # loaded from here on, it also computes the tfrecord writers' CRC32C.
    native = {}

    def build_native():
        t = time.perf_counter()
        try:
            native_loader.load()
        except BaseException as e:  # re-raised below, after nvcc
            native["error"] = e
        native["seconds"] = time.perf_counter() - t

    native_thread = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    native_thread.start()
    _build.build_all()
    native_thread.join()
    if "error" in native:
        raise native["error"]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "native_seconds": native["seconds"],
          "native": {"library": str(native_loader.lib_path()),
                     "capabilities": native_loader.capabilities(),
                     "tiff_library": native_loader.tiff_library()},
          "ptxas": {name: [ln.strip() for ln in _build.build_log(name)
                           .splitlines() if "registers" in ln or "spill" in ln]
                    for name in _build.SOURCES}})
    # The sepconv GEMM, instantiation by instantiation.
    emit({"phase": "ptxas", **{
        name: ptxas_entries(_build.build_log(name), ("sepconv_gemm_kernel",))
        for name in ("fused_middle_flow", "fused_block")},
        "fused_unit_bwd": ptxas_entries(
            _build.build_log("fused_unit_bwd"),
            ("UbDgradA", "UbWgradA", "ub_dw_bwd_kernel")),
        "mcd_head": ptxas_entries(_build.build_log("mcd_head"),
                                  ("pass_kernel",))})

    if opts.slide:
        with tempfile.TemporaryDirectory() as tmp:
            emit(slide_phase(torch, tmp, card)[0])
        return 0
    if opts.serve:
        with tempfile.TemporaryDirectory() as tmp:
            emit(serve_phase_on_predict_tiles(torch, tmp, card)[0])
        return 0
    if opts.stats:
        emit(stats_phase(torch, card)[0])
        return 0
    if opts.pretrained:
        with tempfile.TemporaryDirectory() as tmp:
            emit(pretrained_phase(torch, tmp, card)[0])
        return 0
    if opts.resnet:
        with tempfile.TemporaryDirectory() as tmp:
            emit(resnet_phase(torch, tmp, card)[0])
        return 0
    if opts.int8:
        hp, model, requests = serving_setup(torch, SEED, REQUESTS)
        with tempfile.TemporaryDirectory() as tmp:
            emit(int8_phase(torch, hp, model, requests, tmp, card)[0])
        return 0
    if opts.parallel:
        with tempfile.TemporaryDirectory() as tmp:
            emit(parallel_phase(torch, tmp, card)[0])
        return 0
    if opts.lockstep:
        for row in kernel_unit_bwd(torch, torch.Generator(
                device="cuda").manual_seed(SEED)):
            emit({"phase": "kernel", **row, "card": card})
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            emit(lockstep_phase(torch, tmp, card)[0])
        return 0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for fn in (kernel_preprocess, kernel_middle, kernel_head):
        rows.append(fn(torch, gen))
        torch.cuda.empty_cache()
    rows += kernel_unit_bwd(torch, gen)
    for fn in (kernel_fused_block, kernel_depthwise):
        rows.append(fn(torch, gen))
        torch.cuda.empty_cache()
    rows += kernel_bn_train(torch, gen)
    torch.cuda.empty_cache()
    for row in rows:
        row["card"] = card
        emit({"phase": "kernel", **row})

    hp, model, requests = serving_setup(torch, SEED, REQUESTS)
    main_row, launches = main_path(torch, hp, model, requests, REQUESTS,
                                   card)
    emit(main_row)
    torch.cuda.empty_cache()
    fused_row, fused_launches = main_fused_blocks(torch, hp, model, requests,
                                                  REQUESTS, card)
    emit(fused_row)
    torch.cuda.empty_cache()
    wide_row, wide_launches = main_wide_head(torch, hp, requests, card)
    emit(wide_row)
    torch.cuda.empty_cache()
    f32_row, f32_launches = main_f32(torch, requests, REQUESTS,
                                     (main_row, fused_row), tf32_default,
                                     card)
    emit(f32_row)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        emit(predict_phase(torch, hp, model, tmp, card))
        if importlib.util.find_spec("pandas") is None:
            emit({"phase": "evaluate",
                  "skipped": "pandas is not installed on this machine"})
        else:
            emit(evaluate_phase(torch, hp, model, tmp, card))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        int8_row, int8_launches = int8_phase(torch, hp, model, requests, tmp,
                                             card)
    emit(int8_row)
    del model, requests
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        par_row, par_launches = parallel_phase(torch, tmp, card)
    emit(par_row)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ls_row, ls_launches = lockstep_phase(torch, tmp, card)
    emit(ls_row)
    torch.cuda.empty_cache()
    dw_row, dw_launches = depthwise_entry(torch, gen, card)
    emit(dw_row)
    torch.cuda.empty_cache()
    train_row, strip_launches, plane_launches = train_path(torch, SEED, card)
    emit(train_row)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tp_row, tp_launches = train_project_phase(torch, tmp, card)
    emit(tp_row)
    torch.cuda.empty_cache()
    if any(importlib.util.find_spec(m) is None for m in ("pandas", "scipy")):
        emit({"phase": "experiment",
              "skipped": "pandas or scipy is not installed on this machine"})
        ex_launches = {}
    else:
        with tempfile.TemporaryDirectory() as tmp:
            ex_row, ex_launches = experiment_phase(torch, tmp, card)
        emit(ex_row)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        slide_row, slide_launches = slide_phase(torch, tmp, card)
    emit(slide_row)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        serve_row, serve_launches = serve_phase_on_predict_tiles(torch, tmp,
                                                                 card)
    emit(serve_row)
    torch.cuda.empty_cache()
    stats_row, stats_launches = stats_phase(torch, card)
    emit(stats_row)
    with tempfile.TemporaryDirectory() as tmp:
        pt_row, pt_launches = pretrained_phase(torch, tmp, card)
    emit(pt_row)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        rn_row, rn_launches = resnet_phase(torch, tmp, card)
    emit(rn_row)
    launches["fused_block"] = fused_launches["fused_block"]
    launches["depthwise3x3"] = dw_launches["depthwise3x3"]
    launches["unit_bwd_strips"] = strip_launches["unit_bwd_strips"]
    launches["unit_bwd_plane"] = plane_launches["unit_bwd_plane"]
    for name in ("bn_train_fwd", "bn_train_bwd"):
        launches[name] = strip_launches[name] + plane_launches[name]
    for phase_launches in (wide_launches, f32_launches, int8_launches,
                           par_launches,
                           ls_launches, tp_launches, ex_launches,
                           slide_launches, serve_launches, stats_launches,
                           pt_launches, rn_launches):
        for name, count in phase_launches.items():
            launches[name] += count

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [
        {"name": r["name"], "route": "cuda",
         "source": f"biscuit_torch/csrc/{_build.SOURCE[r['name']]}.cu",
         "replaces": _build.REPLACES[r["name"]],
         "launches": launches[r["name"]],
         **{k: r[k] for k in keys}} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
