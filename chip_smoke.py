"""Smoke test of the PyTorch port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line) if it
fails:
  1. the card's name and power limit, and which host libraries import;
  2. build every CUDA kernel of the port from `pixelspointspolygons_torch/csrc`
     (one nvcc per source, all started together);
  3. each kernel against its plain PyTorch version on the card, at the shapes
     the main path gives it and beyond them (the AFM at 4096 segments), with
     CUDA-event timings and its bound; the AFM kernel's division-free
     quotient against IEEE division on every operand of the main path; the
     voxelizer's pillar sums on 16 clouds of 200,000 points at the caps 4,
     64 and 512 in float32 and float64, bitwise equal to the plain version
     and to themselves over ten calls, and so on the layouts of
     `ops/pillar_layouts.py` (runs over many chunks, runs of a cap or a
     chunk and one more or less, empty pillars, a sample of padding only, a
     cap above N, a 5 x 7 grid; all of them at 16 x 200,000 points; the
     dense encoder's 65,536 pillars, timed at cap 4 beside cap 64); the
     kernel's registers, shared memory and spills (ptxas) and blocks per
     SM; timed warm (back-to-back calls, and in a CUDA graph) and cold (the
     L2 flushed by a 256 MB write before each call) beside the two
     `index_add_` calls they replace; the PillarFeatureNet's ordered
     backward (`csrc/run_sums.cu`) bitwise equal to its plain version at 64
     channels on those layouts flattened as `PillarCanvas` flattens them
     (dump cells included; float32, float64 and bfloat16 at every cap on the
     small ones, float32 on the 16 x 200,000-point one at cap 64 and float64
     on the dense grid at cap 4) and over three calls, its ptxas usage
     and blocks per SM, timed warm, in a CUDA graph and cold on the main
     path's ids (cap 64) beside its plain version and the `index_put_` it
     replaced, at 384 channels too, and on the dense grid; on the main
     path's ids bitwise equal to its plain version at 64 and 384 channels;
  4. the training path: HiSup-image training (HRNetV2-W48, 224 px, head
     width 256, batch 16) through the trainer for 2 train steps, 1 val step
     and the val-IoU pass (the val split polygonized), with every kernel
     launch counter set to 0 just before and read just after; then step
     time, peak memory, the host loader's time per batch, the step cut at
     its layers with its convolutions' operation rate, and the trained
     model's output on the card against the same model on the CPU;
  5. the predict path: the 32-tile test split predicted from the training's
     `latest` checkpoint and evaluated through `cli/predict.py`'s functions,
     with the counters set to 0 just before and read just after (it
     launches no kernel of the port); tiles per second, each batch's device
     time (forward + junction extraction, CUDA events), host-stage time and
     wall time, the metric dict; 1 tile's maps on the card against the
     CPU's and the junction candidates of the same maps on both; the host
     stage alone on the ground-truth masks and corners of the 32 tiles;
  6. the Pix2Poly predict path: a seeded random Pix2Poly-image at full width
     (ViT-S/8 at 224 px, 6-layer decoder, 192 vertex slots) written as
     `latest` in the trainer's format, the 32-tile test split predicted and
     evaluated through `cli/predict.py`'s functions with the counters set to
     0 just before and read just after (no kernel of the port runs: 0 AFM
     launches); tiles per second, each batch's device time cut into encoder,
     decode loop and ScoreNets (CUDA events), the decode loop's host time
     and steps, host-stage and wall time, the metric dict; the fixed-length
     decode of `bench.py` (385 steps, Sinkhorn) on a batch of 16, timed and
     cut at its stages, its steps replayed from their CUDA graph held
     bitwise to the step run as it is, and one replayed decode step profiled
     (aten calls, kernels, the card's busy share); on 1 tile the card against the CPU (encoder
     tokens, teacher-forced logits and their argmax, raw scores) and the
     KV-cached decode against a full re-forward, for the model and for a
     copy whose embeddings are redrawn at unit scale and whose
     cross-attention is sharpened, so that its tokens vary with position
     and image; with that copy, on the batch of 16, the early exit against
     the fixed length, with an EOS bias that makes rows stop at different
     steps;
  7. Pix2Poly-image training at full width (batch 16), float32, through the
     trainer of `cli/train.py` on the synthetic split: 2 train steps, 1 val
     step and the val-IoU pass (the val split greedy-decoded and scored),
     with the counters set to 0 just before and read just after (0 AFM
     launches); step time, the step cut by CUDA events into encoder,
     decoder, ScoreNets, Sinkhorn, losses, backward and optimizer, the
     Sinkhorn's forward and backward alone, peak memory, the val IoU and
     its wall time; one train step on 2 tiles on the card and on the CPU
     from the same weights (losses and gradients);
  8. the same training at bfloat16 (`host.compute_dtype=bfloat16`) from the
     same initial weights, its first step's losses against the float32
     run's;
  9. Pix2Poly prediction at bfloat16 of the 32-tile test split from that
     training's `latest`, with the counters set to 0 just before and read
     just after, timed per batch as in 6; on 1 tile the card's bfloat16
     against the CPU's (encoder tokens, the first 128 decode steps' tokens
     outside near-ties, teacher-forced logits, raw scores), for the model
     and, on 2 tiles, for the varied copy (unsharpened) of 6's seeded
     random model, whose tokens vary;
     the bfloat16 fixed-length decode of `bench.py` cut at its stages and
     one step profiled, with the same step of the float32 model of the
     same weights (a bfloat16 step must make no more aten calls: the
     weights are cast once per decode; each busy share is over that
     model's own step); then `bench_torch.py`'s measurement with few
     iterations, its JSON line on a line of its own (`spread_pct` null:
     not measured from fewer than 5 repeats);
 10. HiSup-image training at bfloat16 (`host.compute_dtype=bfloat16`) from
     the same seed and weights as 4, with the counters set to 0 just
     before and read just after (3 AFM launches): step time, the step by
     layer, peak memory, the val IoU, its first step's losses against the
     float32 run's, and the card against the CPU at bfloat16 on 1 tile;
 11. HiSup prediction at bfloat16 of the test split from that training's
     `latest`, as in 5 (0 AFM launches);
 12. pretrained encoders and the warm start: a timm-layout ViT-S/8 file
     and a reference-layout HRNetV2-W48 file written from seeded numpy,
     grafted by the Pix2Poly and HiSup trainers' set-up
     (`pretrained=true checkpoint_file=...`) and one train step each, and
     a HiSup set-up with `init_weights_from` the float32 training's
     checkpoint and one step; the tensors loaded and kept at init, and the
     grafted tensors on the card against the file's;
 13. `graft_entry_torch.entry()` on the card against the CPU;
 14. the FFL predict path: a seeded random FFL-image at full width (ViT-S/8
     at 224 px, `ViTCNNEncoder`, heads of width 256; its seg head shifted
     and sharpened so that its maps have contours) written as `latest`, the
     32-tile test split predicted and evaluated through `cli/predict.py`'s
     functions with the counters set to 0 just before and read just after
     (0 AFM launches, 0 failed batches, the four prediction files); tiles
     per second, each batch's forward (CUDA events), contours (host), ACM
     (CUDA events, its steps, rings, vertices, bucket and rings dropped)
     and post-processing (host), peak memory, the metric dict; on 2 tiles
     the card's seg and crossfield against the CPU's, and the ACM's 500
     steps on the card against the CPU from the same float16 maps; the
     ACM's 500 steps at the whole batch's packing replayed from their CUDA
     graph against the loop of `acm_step`, bitwise, both timed in turns;
     one step of the loop profiled (aten calls, kernels, the card's busy
     share); the
     polygonizer on maps that the ground truth implies, evaluated (IoU
     bound); `cli.predict_demo` on one tile;
 15. FFL-image training at full width (batch 16) through the trainer of
     `cli/train.py`, from a seeded model drawn on the CPU and taken up by
     `init_weights_from`, at float32 (the ground-truth cache emptied first,
     so the loader is cold): 2 train steps, 1 val step and the val-IoU pass
     (the ACM on the model's maps) with the counters set to 0 just before
     and read just after (0 AFM launches); step time, the step cut by CUDA
     events into forward, losses, backward and Adam, one forward traced,
     peak memory, the host loader's ms per batch cold and warm, each loss
     term of the first step, the val IoU with its ACM's rings, vertices and
     bucket; one float32 step on 2 tiles on the card against the CPU
     (losses and gradients); ASM on the ground truth's maps of one test
     batch (IoU bound; skeleton, optimization and post-processing ms), its
     optimization on 2 tiles on the card against the CPU, and one ASM step
     profiled. (Its bfloat16 half, the first step's losses against
     float32's and the bfloat16 maps on the card against the CPU on 1 tile,
     and its bfloat16 prediction moved into phase 26, from the same seeded
     weights);
 16. the LiDAR voxelizer and PillarFeatureNet on the synthetic train split's
     first batch of 16 clouds at 200,000 points, at the per-pillar caps 4,
     64 and 512: the assignment on the card against the CPU (points, pillar
     ids, kept masks, counts and features bitwise equal), a seeded
     PillarCanvas in train mode on 1 cloud against the CPU, the assignment,
     the canvas forward and its backward timed with their peak memory, and
     one call profiled (K6's baseline, ROADMAP §2);
 17. HiSup-LiDAR training at full width (`experiment=hisup_lidar`,
     pointpillars_vit_cnn) through the trainer, 2 train + 1 val steps and
     the val-IoU pass with the counters set to 0 just before and read just
     after (3 AFM launches): step time, the step cut into targets,
     voxelization with the PFN, the ViT, the heads, losses, backward and
     AdamW, peak memory, the host loader's ms per batch, the val IoU; one
     float32 step on 1 tile on the card against the CPU (losses and
     gradients); one bfloat16 step from the same weights on the same batch,
     its losses against the float32 run's first;
 18. Pix2Poly early-fusion prediction (`experiment=p2p_fusion`) of the
     32-tile test split from a seeded random model, through
     `cli/predict.py`'s functions (0 AFM launches): tiles/s, the encoder's
     ms per batch, the split predicted again and its prediction file equal
     byte for byte; the encoder run three times on a batch of 16 with the
     pillar sums taken by `index_add_` (atomics) and three times by the
     port's kernel, each stage (decorated features, canvas, fusion conv,
     tokens) compared bitwise with the first call's and the first stage
     that differs printed for each; the encoder tokens on 1 tile on the
     card against the CPU;
 19. one train step at batch 16 each of p2p_lidar, hisup_fusion (1 AFM
     launch), ffl_lidar and ffl_fusion through their trainers' set-up: step
     time, peak memory, finite losses, a forward on 1 tile on the card
     against the CPU;
 20. `cli.predict_demo` for ffl_lidar on one tile from a `.laz` file that
     the port's `write_laz` wrote from the tile's points;
 21. training from the device cache (`training.device_cache=true`), each
     part failing the run on its own: FFL-image at float32 and bfloat16
     from phase 15's seeded weights (2 train + 1 val steps and the val-IoU
     pass; the run fails if the trainer fell back to the host loader): the
     step, the batcher's ms per batch, the pack and upload seconds and
     bytes, the peak, the wall ms per train batch from the cache and from
     the host loader in turns, and the first float32 step's losses against
     a step on the host loader's batch of the same tiles; the cache's
     first batch on the card against the CPU (FFL-image, HiSup-fusion,
     Pix2Poly-image); HiSup-LiDAR from the cache with remat (3 AFM
     launches): the step and its layers, the peak, the cache's point cap,
     the voxelizer and PFN at that cap; one HiSup-LiDAR step with remat
     against one without from the same weights on the same batch (losses,
     gradients, BatchNorm buffers, peak and ms); one hisup_fusion step with
     remat (peak); Pix2Poly-image from the cache (0 AFM launches).
 22. data parallel on the one card (`parallel.py`, the synchronised
     BatchNorms of `models/layers.py`, DDP), the script's own process
     joining a group of one over NCCL for each DDP step and leaving it
     after: HiSup-image at float32, one DDP step against two plain steps
     from the same weights on the same batch (losses, gradients, every
     BatchNorm buffer), then 2 turns each of DDP and plain steps in turns
     (median ms, peak, the collectives of a DDP step: two per BatchNorm, an
     all-gather and an all-reduce, and DDP's gradient buckets; 2 AFM
     launches a DDP turn); Pix2Poly-image and
     FFL-image, one DDP step against one plain step (losses, ms, peak, 0
     AFM launches); two gloo ranks on the one card, spawned here, running
     the tiny HRNet HiSup and the tiny fusion Pix2Poly on the two halves
     of a batch against the one-process step on the whole batch on the
     card; ROADMAP 3.16's float32 gradient against float64 on the card
     and the CPU.
 23. the remaining encoders at full width, each in a model root of its own:
     FFL over UNet-ResNet101 and ConvNeXt-V2-T (training, a step on the
     card against the CPU and float64 on the card, 8 test tiles
     predicted), Pix2Poly
     over DINOv2 ViT-S/14 grafted from a seeded file (training, the val
     figure, the split predicted, the card against the CPU), then the
     DINOv2 and image-resolution ablation twins on 4 test tiles and their
     LaTeX tables;
 24. the last script twins, each through its `main`: `cli.postprocess_oracle`
     (every family's post-processing on the ground truth's outputs, on the
     card and the CPU, each row above its quality floor),
     `cli.measure_predict_e2e` over phase 6's seeded Pix2Poly-image on 4
     test tiles (its JSON line), `cli.profile train` and `generate` (each trace's size,
     its export's seconds and the decode's kernels in it),
     `cli.gather_pretrained_models` over the earlier phases' checkpoints
     and `cli.droplidar50_ablation` over phase 18's seeded fusion model
     on 4 test tiles (its two rows must be equal);
 25. the LiDAR and fusion grid, each part failing the run on its own and
     printing its seconds, the counters set to 0 just before each
     prediction or training and read just after: (a) `cli.modality_ablation`
     over its nine experiments at their own configs (the fusion rows at
     `country: all`), the six LiDAR and fusion rows on the first 16 test
     tiles and the three image rows on 4, each row's `best_val_iou` an
     earlier phase's checkpoint or a seeded model; every row present with
     finite IoU and C-IoU, 0 AFM launches, the pillar sums once a batch on
     the LiDAR and fusion rows and never on the image rows; each LiDAR and
     fusion row's split predicted again and its file held byte for byte;
     (b) `cli.lidar_density_ablation`, its eight caps over one seeded
     FFL-LiDAR whose weights every cap's model loads strictly, on 4 test
     tiles; (c) `cli.all_countries`, its three fusion rows at `country=all`
     on 4 test tiles, as (a); (d) `experiment=hisup_lidar
     encoder=pointpillars` (the dense encoder at 512 px, 256 x 256 pillars
     at cap 4) through phase 17's path (5 AFM launches, the pillar sums
     once a forward, one float32 step on 1 tile on the card against the
     CPU, an eval forward on 2 tiles card against CPU), its 16-tile test
     split predicted twice from `latest` (the files byte for byte) and
     evaluated, and FFL over the same encoder (`experiment=ffl_lidar
     encoder=pointpillars`) one train step at batch 16 through its
     trainer's set-up (the pillar sums once, 0 AFM launches; step time,
     peak) and an eval forward on 2 tiles on the card against the CPU and
     against itself; (e) `run_type=release` (8 loader threads, the train split
     shuffled): the first 3 train batches of hisup_lidar and p2p_fusion
     from 8 threads and from 0 bitwise equal, hisup_lidar trained 4 steps
     from the 8-thread loader (4 AFM launches), the loader's ms per batch
     at 8 and 0 threads in turns, `cli.measure_predict_e2e` over phase 18's
     seeded p2p_fusion on 16 test tiles (its line must report 16 tiles).
 26. a trained FFL: FFL-image (ViT-S/8 at 224 px) trained from FFL_SEED's
     weights through `cli.train`'s `main` at bfloat16 from the device
     cache on the synthetic split at its own counts (256 train, 32 val, 32
     test tiles) for 11 epochs of 16 steps, the AFM and pillar-sums
     counters set to 0 just before and read just after (0 launches of
     each): every epoch's loss terms, val loss, the LR of its last step,
     the loss weights its steps used and its seconds; the val IoU and
     C-IoU at epochs 4, 9 and 10; the peak at epochs 0 and 10; the
     ground-truth and pack seconds and the upload's. It fails unless every
     loss is finite, each epoch's last LR is the schedule's, the weights at
     epochs 0, 5 and 10 are `weights_for_epoch`'s, `best_val_iou`,
     `latest` and `epoch_10` exist and the val IoU at epoch 10 is at least
     0.6. Then a 12th epoch resumed from `latest` through `cli.train`
     (start epoch 11, steps 176 before and 192 after), and the 32-tile test
     split predicted from `best_val_iou` at bfloat16 through
     `cli/predict.py`'s functions twice (0 AFM launches, 0 failed batches,
     the two files byte for byte, IoU at least 0.6), beside phase 14's
     seeded model. Its split is written and packed (`cli.prebuild_caches`)
     by a process of its own started with phase 1 and joined here. It
     holds phase 15's bfloat16 checks, which moved here:
     its first step's losses against a float32 step from the same weights
     on the same batch (FFL_BF16_LOSS_TOL), the bfloat16 maps of those
     weights on the card against the CPU on 1 tile, and its prediction's
     (compute dtype, float16 maps, failed batches, launches).
 27. repeatable training (ROADMAP 3.25): every phase runs on the card under
     the entry points' set-up (`device.set_deterministic`: deterministic
     algorithms that raise, cuDNN deterministic, cuBLAS's fixed workspace;
     printed at the start and again here), and each training path runs
     twice in one process from one seed, the same weights, optimizer,
     schedule and data, for 2 steps (REPEAT_STEPS), its kernel counters set
     to 0 just before each run and read just after: the batches, every
     step's losses, every gradient of the first step, every parameter and
     buffer (the BatchNorm running statistics) and the optimizer's state
     must be bitwise equal, and so must the AFM, pillar-sums and run-sums
     launches; on a mismatch the first module in forward order whose
     gradient differs is printed. The phases that build a path's trainer
     run it (`train_twice`): hisup_image at float32 and bfloat16 (phases 4
     and 10), p2p_image at both (7-8) and ffl_image at float32 (15), batch
     16 at full width, from the host loader; ffl_image from the device cache
     at float32 and bfloat16 (21: its bfloat16 path, batch 16 at full width,
     takes the cache's batches); hisup_lidar from the host loader (17),
     HiSup-image's DDP step at world size 1 over NCCL (22, one batch for
     both steps), FFL over UNet-ResNet101 and ConvNeXt-V2-T (23) and
     HiSup-LiDAR over the dense encoder at 512 px (25 (d)). This phase runs
     p2p_fusion (batch 16, host loader) and hisup_fusion with remat from the
     device cache (batch 8, REPEAT_FUSION_BATCH: the time), prints the
     table and fails unless every path of TRAIN_REPEAT_PATHS was held.
The repeat checks (ROADMAP 3.21): every prediction path predicts twice
from the same weights on the same tiles, and the two must be bitwise equal:
hisup_image, p2p_image and ffl_image on the first test batch of phases 5,
6 and 14 (device outputs and polygons; FFL's ACM runs its 500 steps on the
card), p2p_fusion's whole split in phase 18 (the prediction file byte for
byte), and two eval forwards on 2 tiles of phase 17's hisup_lidar and on
1 tile of phase 19's p2p_lidar, hisup_fusion, ffl_lidar and ffl_fusion.
Each LiDAR and fusion path sets the pillar_sums counter to 0 just before it
and reads it just after, and fails if the kernel was launched no time.
They run in the order 1-5, 10-15, 6-9, 16-27; each phase prints its
seconds. The run has 1,200 s, and its host-bound phases read up to a third
slower on one machine than on another, so depth is cut where a path is
driven at full width elsewhere: 2 train steps before phase 25
(TRAIN_STEPS), 4 tiles for the ablation twins (ABLATION_TEST_TILES), 16
for the modality ablation's LiDAR and fusion rows (GRID_LIDAR_TEST_TILES),
1 tile for the dense HiSup step on the CPU (DENSE_CPU_TILES), each cut
named beside its constant. The line before the last is the card's name and power limit, the
one before it a JSON object with every kernel's numbers; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import itertools
import json
import math
import mmap
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
T0 = time.perf_counter()
CARD = torch.device("cuda")

# published peaks of one H100 SXM (dense): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations the AFM needs per (pixel, valid segment) pair: 1 add (the
# numerator, from a column term and a row term), 1 div, 2 clamp, 2 x (FMA
# as 2 + 1 sub) for the offsets, 1 mul + 1 FMA for the distance, 1 compare.
# A column term (px - x1) * dx and a row term (py - y1) * dy cost 2 each,
# per valid segment and column or row. The per-pixel encoding is left out.
AFM_OPS_PER_PAIR = 14
AFM_OPS_PER_TERM = 2
# the count with both terms computed for every pair (2 sub, 2 mul more),
# which the kernel's first version was measured against; printed beside
AFM_OPS_PER_PAIR_UNSHARED = 18

B, L, S = 16, 256, 224
# the training paths before phase 25 take TRAIN_STEPS steps on the first
# TRAIN_STEPS * B tiles of the train split (4 before phase 25 came: cut for
# the run's time); phase 25's dense HiSup-LiDAR and its release run take
# GRID_TRAIN_STEPS, the train split's whole TRAIN_TILES
TRAIN_STEPS, VAL_STEPS = 2, 1
GRID_TRAIN_STEPS = 4
TRAIN_TILES = GRID_TRAIN_STEPS * B
TEST_TILES = 32  # 2 batches: the predictor's one batch in flight runs
# phase 25 (d)'s test split on the dense encoder's 512 px tiles (one batch:
# a 32-tile split took 18 s to predict twice and 9 s to evaluate)
DENSE_TEST_TILES = 16
# the steady-state step and its cut by layer of phase 17 and phase 25 (d),
# on the first STEADY_BATCHES train batches (a median of 2)
STEADY_BATCHES = 2
# the card's probability maps against the CPU's, on MAP_TILES tiles of a test
# batch (the CPU's full-width HRNet forward takes about 2 s a tile; 2 tiles
# before a cut for the run's time): the
# training phase holds the raw outputs to 1e-3 of their range, and a softmax
# or sigmoid moves by less than its input does
MAP_TOL = 1e-3
MAP_TILES = 1
# polygonizing the ground truth's own masks and corners gives it back up to
# merged touching buildings (tiles of row houses), so its IoU stays below 1
ORACLE_MIN_IOU = 0.95
# Pix2Poly, card against CPU: float32 with TF32 off on both, summed in other
# orders through 12 encoder blocks and 6 decoder layers: 1e-3 relative to
# the largest value; two tokens whose logits are closer than P2P_NEAR_TIE
# may swap between the devices
P2P_REL_TOL = 1e-3
P2P_NEAR_TIE = 1e-3
# (2 tiles before a cut for the run's time)
P2P_CPU_TILES = 1
# the early-exit check raises EOS's output bias so that every row of the
# batch stops by this step
P2P_EXIT_BY = 150
# the fixed-length decode replayed from its CUDA graph is held to its step
# run as it is over this many steps (every step replays the same graph)
P2P_GRAPH_CHECK_STEPS = 64
P2P_SEED = 0
P2P_SHARPEN = 4.0
# Pix2Poly training, one step on 2 tiles from the trainer's initial weights,
# float32 (TF32 off) on the card and on the CPU, and the exact gradient
# (float64 on the CPU): losses to 1e-4 relative; each float32 gradient to
# 1e-3 of the exact one in relative L2 over all parameters (the float32
# sums through 12 encoder blocks, 6 decoder layers and 100 Sinkhorn
# iterations read 2.6e-4 on an NVIDIA H100 80GB HBM3 and 5.0e-4 on the
# CPU; PERF.md). Not from the trained weights: after a few updates the
# ScoreNets' train-mode BatchNorm divides by the variance of nearly equal
# vertex-pair features, and a float32 gradient strays about ten times
# further from the exact one on either device.
P2P_TRAIN_CPU_TILES = 2
P2P_LOSS_TOL = 1e-4
P2P_GRAD_TOL = 1e-3
# the bfloat16 run's first step against the float32 run's, from the same
# weights on the same batch: bfloat16 rounds every layer's output to 8
# significant bits; the CPU tests read 3e-3 on the loss at a tiny width
P2P_BF16_LOSS_TOL = 5e-2
# bfloat16 on the card against bfloat16 on the CPU: each layer's output is
# rounded to 8 bits (2^-9 relative), and the two devices sum products in
# other orders, so elements differ by an ulp here and there, more through 12
# encoder blocks and 6 decoder layers: 5e-2 in relative L2; the two greedy
# decodes are compared token by token up to where they part at a step whose
# top-2 logit gap on the CPU is under P2P_BF16_NEAR_TIE_ULPS ulps of its
# largest logit. The trained checkpoint emits one token, so the check also
# runs on `p2p_chain`'s copy of the seeded random model on
# P2P_BF16_CHAIN_TILES tiles, which must compare at least
# P2P_BF16_MIN_DECODE decode positions and P2P_BF16_MIN_DISTINCT tokens.
# Both compare the first P2P_BF16_CHECK_STEPS decode steps: the CPU's
# bfloat16 decode is the script's costliest comparison (97.6 s for all 385
# steps on 2 + 8 tiles on the card's host, PERF.md); 2 tiles of 128 steps
# still give 256 positions (4 tiles, 17.3 s on the CPU, gave 512 and 104
# distinct tokens before the cut for the run's time), and the 8 tiles' 385
# steps gave 151 tokens.
P2P_BF16_REL_L2 = 5e-2
P2P_BF16_NEAR_TIE_ULPS = 8
P2P_BF16_SUBLAYER, P2P_BF16_CHAIN_TILES = 0.5, 2
P2P_BF16_MIN_DECODE, P2P_BF16_MIN_DISTINCT = 100, 10
P2P_BF16_CHECK_STEPS = 128
# the pretrained-encoder files are drawn from this seed
PRETRAINED_SEED = 3
# HiSup at bfloat16: the first train step's losses against float32's from
# the same weights on the same batch, 1e-2 relative (bfloat16 rounds each
# layer's output to 8 bits; the losses are float32 means over the batch).
# The card against the CPU at bfloat16 on BF16_EVAL_TILES of the first
# step's batch (the CPU's bfloat16 convolutions are slow), from the first step's weights
# in eval mode: each head within 5e-2 in relative L2, through about 40
# rounded layers. Not in train mode: there, from the same weights, each
# side strays 31-65 % from float32 and 20-49 % from the other (NVIDIA H100
# 80GB HBM3 and its host, PERF.md), as JAX's bfloat16 strays in train mode
# at a tiny width (tests/test_torch_hisup_bf16.py); nor after the 4 updates,
# where eval mode read 2-7 % apart.
HISUP_BF16_LOSS_TOL = 1e-2
HISUP_BF16_CPU_TILES = 2
HISUP_BF16_REL_L2 = 5e-2
# the eval-mode bfloat16 checks (HiSup, FFL) take the first BF16_EVAL_TILES
# of those tiles: in eval mode each tile's output depends on that tile alone
BF16_EVAL_TILES = 1
# the port's twin of __graft_entry__.entry() on the card against the CPU,
# float32 with TF32 off: 1e-3 of the largest value, as Pix2Poly above
ENTRY_REL_TOL = 1e-3
# bench_torch.py inside the smoke run: few iterations (its own defaults are
# 20 iterations in each of 5 repeats; 2 repeats before a cut for the run's
# time)
BENCH_ITERS, BENCH_REPEATS = 1, 1
# FFL-image: the seeded random model's weights; its seg and crossfield on
# FFL_CPU_TILES tiles on the card against the CPU, float32 with TF32 off on
# both, within FFL_MAP_TOL (seg in [0, 1], crossfield in [-2, 2]: the maps
# of MAP_TOL above)
FFL_SEED = 0
FFL_SEG_QUANTILE, FFL_SEG_SHARPEN = 0.7, 10.0
FFL_CPU_TILES = 2
FFL_MAP_TOL = 1e-3
# the ACM's 500 steps on the card against the CPU from the same maps. Each
# step's gradient differs in its last bits (CUDA's complex products and
# sums against the CPU's), and the ACM amplifies such differences: its
# crossfield term reads the pixel at each edge's rounded midpoint, so a
# vertex crossing a pixel boundary a step earlier or later takes another
# path. On the CPU, a synthetic tile's contours nudged by 4 ulps part from
# the unnudged run after 500 steps by up to 1.32 px, 46 % of the vertices
# beyond 1e-3 px (tests/test_torch_ffl_polygonize.py::
# test_acm_amplifies_last_bit_differences; ROADMAP 3.9). So
# the bulk is held (median ACM_BOUNDS[1] px), the parted share
# (ACM_BOUNDS[2] of the vertices beyond ACM_FAR_PX) and the largest
# parting (ACM_BOUNDS[0] px, about the distance the vertices travel); the
# quality of the result is held by FFL_ORACLE_MIN_IOU below.
ACM_FAR_PX = 1e-3
ACM_BOUNDS = (2.0, 1e-4, 0.25)
# FP32 operations of one ACM step per position, counted from `_acm_loss`:
# about 80 in the loss (edge, norm, rounded midpoint, complex z^4 + c2 z^2
# + c0 and its squared modulus, the bilinear level term, the length), twice
# that in its gradient, 6 in the update
ACM_OPS_PER_VERTEX_STEP = 250
# the polygonizer on the ground truth's maps (ffl_oracle_maps): IoU 0.9700
# at its first reading on an NVIDIA H100 80GB HBM3 (700 W); merged touching
# buildings (row houses) keep it below 1, as HiSup's, whose bound
# (ORACLE_MIN_IOU) it takes
FFL_ORACLE_MIN_IOU = 0.95
# FFL training (phase 15) starts from FFL_SEED's weights drawn on the CPU
# (as phase 14's, without its seg-head shift), taken up through
# `init_weights_from` by both dtypes' runs:
# - one float32 step on HISUP_BF16_CPU_TILES tiles on the card and on the
#   CPU: the losses to 1e-4 relative and the two gradients to 2e-3 of each
#   other in relative L2 over all parameters: each float32 gradient within
#   1e-3 of the exact one, as Pix2Poly's (the two read 2.36e-4 apart on an
#   NVIDIA H100 80GB HBM3 at 700 W, PERF.md);
# - the bfloat16 run's first step against the float32 run's, from the same
#   weights on the same batch, relative: the total and the seg and
#   alignment terms 1e-2 (HiSup's); seg_interior_crossfield 5e-2
#   (Pix2Poly's: it aligns the field with the seg's normalized gradient,
#   whose direction bfloat16's steps turn where the seg is nearly flat);
#   crossfield_smooth 0.5: it is the mean |Laplacian| of a field that is
#   smooth at these weights, and bfloat16's rounding of every layer adds
#   roughness (0.263 apart on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md);
# - the card's bfloat16 maps against the CPU's on BF16_EVAL_TILES, from the
#   first step's weights in eval mode: 5e-2 in relative L2, as HiSup's;
# - prediction at bfloat16: phase 26's trained model on the whole test
#   split (phase 15's 2-step model on the first 16 test tiles before phase
#   26 came).
FFL_LOSS_TOL, FFL_GRAD_TOL = 1e-4, 2e-3
FFL_BF16_LOSS_TOL = {"loss": 1e-2, "seg": 1e-2, "crossfield_align": 1e-2, "crossfield_align90": 1e-2,
                     "seg_interior_crossfield": 5e-2, "crossfield_smooth": 0.5}
FFL_BF16_REL_L2 = 5e-2
# ASM on the ground truth's maps of one test batch: IoU at least
# ASM_ORACLE_MIN_IOU (0.8380 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md:
# the skeleton merges touching buildings). Its optimization on
# ASM_CPU_TILES of those tiles on the card against the CPU: RMSprop divides
# each gradient by its own running size, so a gradient at the rounding
# noise steps by lr·sign(noise) and last-bit differences grow faster than
# in the ACM (ROADMAP 3.10; tests/test_torch_ffl_asm.py: on the CPU, JAX's
# run parts from itself by a median of 0.14 px when its start is nudged by
# 4 ulps, from the port's by 7.6e-6 px after one step). So one step is held
# by its median (ASM_ONE_STEP_MEDIAN_PX) and its share beyond ACM_FAR_PX
# (ASM_ONE_STEP_SHARE), the 300 steps by their median (ASM_MEDIAN_PX); the
# quality of the result is held by the IoU.
ASM_ORACLE_MIN_IOU = 0.80
ASM_CPU_TILES = 2
ASM_ONE_STEP_MEDIAN_PX, ASM_ONE_STEP_SHARE = 1e-4, 0.02
ASM_MEDIAN_PX = 0.1
# LiDAR and early fusion (phases 16-20):
# - the pillar assignment on the card against the CPU: points, pillar ids,
#   kept masks, per-pillar counts and decorated features bitwise equal (the
#   same stable sort; `csrc/pillar_sums.cu` adds each pillar's centroid sum
#   in the CPU's order);
# - the train-mode PillarCanvas of LIDAR_CANVAS_TILES clouds (2 before a cut
#   for the run's time) and its
#   running statistics within LIDAR_CANVAS_TOL of the CPU's, relative to the
#   largest value (float32, TF32 off; the Dense and max are exact
#   operations on the same rows, the BatchNorm statistics sum 400,000 rows
#   in other orders: the CPU tests read 3e-7 against float64);
# - HiSup-LiDAR training, one float32 step on LIDAR_CPU_TILES tiles (phase
#   17; 2 before a cut for the run's time: the CPU's step took 21.5 s, and
#   the two gradients read 1.26e-4 apart) or HISUP_BF16_CPU_TILES (phase 25
#   (d)) on the card and on the CPU: losses within LIDAR_LOSS_TOL relative,
#   the two gradients within LIDAR_GRAD_TOL in relative L2 over all
#   parameters (a float32 HiSup gradient through train-mode BatchNorms on a
#   2-tile batch lies up to 1e-2 from the exact one,
#   tests/test_torch_slice.py);
# - its first step at bfloat16 against float32's from the same weights on
#   the same batch: LIDAR_BF16_LOSS_TOL relative (Pix2Poly's bound; the
#   PFN's inputs, pixel coordinates up to 224, round to 8 bits: steps of 1
#   px above 128, as flax's `dtype=bfloat16` rounds them);
# - one step of each other LiDAR and fusion experiment, then a forward on
#   LIDAR_FWD_TILES tiles (2 before a cut for the run's time) on the card
#   against the CPU: LIDAR_FWD_TOL relative to each
#   output's largest value at float32 (check_against_cpu's bound), and
#   HISUP_BF16_REL_L2 in relative L2 at bfloat16. hisup_fusion (HRNetV2-W48
#   and the pillar ViT) runs at LIDAR_STEP_DTYPE's dtype.
LIDAR_CAPS = (4, 64, 512)
# csrc/run_sums.cu launches in a LiDAR train step's backward: the gather of
# the first PFN layer's pooled rows, and each of the two layers' tie counts
RUN_SUMS_PER_STEP = 3
# the gradient rows phase 3 holds it to its plain version at: the first
# PFN layer's width
RUN_SUMS_CHANNELS = 64
LIDAR_SEED = 0
LIDAR_CANVAS_TILES = 1
LIDAR_CANVAS_TOL = 1e-4
LIDAR_CPU_TILES = 1
LIDAR_FWD_TILES = 1
LIDAR_LOSS_TOL, LIDAR_GRAD_TOL = 1e-4, 1e-2
LIDAR_BF16_LOSS_TOL = 5e-2
LIDAR_FWD_TOL = 1e-3
LIDAR_STEP_DTYPE = {"p2p_lidar": "float32", "hisup_fusion": "float32", "ffl_lidar": "float32",
                    "ffl_fusion": "float32"}
# The device cache and remat (phase 21):
# - FFL-image from the cache, its first float32 step's losses against a step
#   from the same weights on the host loader's batch of the same tiles, each
#   term within FFL_CACHE_LOSS_TOL relative: the two batches differ in the
#   Gaussian noise field (another generator, the same sigma: a random
#   perturbation of every pixel by up to 7/255, which moves a random model's
#   crossfield terms most), the colour jitter's HSV arithmetic (the cache's
#   own, not cv2's) and the float16 rounding of the images and targets (the
#   host path's alone); with GaussNoise left out of both, each term within
#   FFL_CACHE_NOISELESS_TOL (the HSV arithmetic and the float16 rounding
#   move pixels by ~1e-3 of their range);
# - the cache's batch on the card against the same batch of the same pack
#   on the CPU, GaussNoise left out (the two generators give other
#   streams): every leaf but the images and the clouds equal; the images
#   within CACHE_IMAGE_TOL absolute (normalized pixels up to ~3; each
#   image's jitter mean is summed in another order, and the card divides
#   by a host scalar as a product with its reciprocal); the clouds equal as
#   sets (the shuffle's generators differ);
# - HiSup-LiDAR, one step with remat and two without from the same weights
#   on the same cached batch: losses within REMAT_LOSS_TOL relative, every
#   BatchNorm buffer within REMAT_STATS_TOL relative to its largest value,
#   gradients within REMAT_GRAD_TOL in relative L2, or within
#   REMAT_NOISE_FACTOR times the two plain steps' own distance where that
#   is larger. Not equal: the forward is repeatable (the voxelizer's sums
#   are ordered, `csrc/pillar_sums.cu`, and the repeat checks hold every
#   prediction path), but the backward still sums atomically in no fixed
#   order (the scatter-max's gradient, the convolutions' weight gradients),
#   so gradients differ from one backward to the next (the remat step's
#   read 1.0 to 2.4 times the plain pair's distance of 2.1e-5 to 2.4e-5 on
#   an NVIDIA H100 80GB HBM3 at 700 W while the voxelizer's sums were still
#   atomic, PERF.md). A second update of the
#   running statistics would move them by a tenth of the batch statistics,
#   a recompute of other numbers would move the gradient far more.
FFL_CACHE_LOSS_TOL, FFL_CACHE_NOISELESS_TOL = 5e-2, 5e-3
CACHE_IMAGE_TOL = 1e-5
REMAT_LOSS_TOL, REMAT_GRAD_TOL, REMAT_STATS_TOL, REMAT_NOISE_FACTOR = 1e-6, 1e-5, 1e-6, 10.0
# Data parallel (phase 22), one card:
# - HiSup-image at world size 1 over NCCL (DDP and the synchronised
#   BatchNorms, `parallel.py`, `models/layers.py`) against the plain step
#   from the same weights on the same batch: losses within DDP_LOSS_TOL
#   relative, every BatchNorm buffer within DDP_STATS_TOL relative to its
#   largest value. The gradient is not held to the plain step's: the
#   synchronised layers sum in another order than cuDNN's batch norm, and
#   the float32 gradient through 323 BatchNorms carries each order's
#   rounding (9.05e-3 between the two at batch 16 where two plain steps
#   read 3.15e-6 apart on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md). Each is held
#   against the float64 gradient of the same step on the batch's first
#   DDP_EXACT_ROWS tiles (float64 at batch 16 would not fit): the DDP
#   step's no farther from it than DDP_EXACT_FACTOR times the plain step's
#   plus DDP_EXACT_FLOOR, as tests/test_torch_ddp.py holds the CPU's (an
#   error in the synchronised backward moves the gradient by O(1): the
#   unsynchronised control there reads 1.1);
# - Pix2Poly-image and FFL-image: the first DDP step's losses against the
#   plain step's from the same weights, DDP_LOSS_TOL;
# - two gloo ranks on the one card, each on its half of a batch of 8, the
#   tiny HRNet HiSup and the tiny fusion Pix2Poly of `graft_entry_torch.py`
#   (HiSup at DDP_TINY_SIZE px) against the one-process step on the whole
#   batch on the card: in float32 the losses and buffers (the bounds
#   above), in float64 the gradient within DDP64_GRAD_TOL in relative L2,
#   or DDP_NOISE_FACTOR times two one-process steps' own distance where
#   that is larger (the backward's scatter-max gradient and weight
#   gradients sum atomically in no fixed order: Pix2Poly's float64 gradient
#   read 1.2e-7 to 1.5e-7 from the one-process step's while the voxelizer's
#   sums were atomic too, and about 1e-15 since they are ordered, PERF.md).
#   Not in float32: a ReLU input within a rounding
#   of 0 takes either side with the order of a sum, and one such element
#   moves a tiny model's gradient by 1e-2 (tests/test_torch_ddp.py holds
#   the same cases to JAX and to float64 on the CPU);
# - ROADMAP 3.16: the tiny HRNet HiSup's float32 gradient against its
#   float64 gradient at DRIFT_SIZE px, batch 2, on the card (cuDNN, TF32
#   off) and on the CPU (one thread and the thread pool), printed.
DDP_LOSS_TOL, DDP_STATS_TOL, DDP_NOISE_FACTOR = 1e-5, 1e-5, 10.0
DDP_EXACT_ROWS, DDP_EXACT_FACTOR, DDP_EXACT_FLOOR = 4, 2.0, 1e-5
# 2 turns each (4 before phase 25 came, cut for the run's time)
DDP_TURNS = 2
DDP_TINY_SIZE, DDP_TINY_ROWS = 32, 8
DDP64_GRAD_TOL = 1e-9
# how long a gloo rank, started with phase 22, waits for its go file
GLOO_WAIT_S = 1200
DRIFT_SIZE = 64
# The remaining encoders (phase 23), float32 with TF32 off, at the widths
# the config tree ships:
# - FFL over UNet-ResNet101 and over ConvNeXt-V2-T at 224 px (decoder 256):
#   phase 15's training path (CNX_TRAIN_STEPS steps each), its
#   card-against-CPU step (FFL_LOSS_TOL, FFL_GRAD_TOL) and prediction of the
#   first PHASE23_TEST_TILES test tiles from `latest`; ConvNeXt's one
#   bfloat16 step from the first step's weights on the same 2 tiles against
#   the float32 step on the card, per term within FFL_BF16_LOSS_TOL;
# - Pix2Poly over DINOv2 ViT-S/14: a file in DINOv2's layout with the real
#   `dinov2_vits14` grid of DINO_GRID x DINO_GRID positions, grafted by the
#   trainer's set-up (every trunk tensor equal to the file's after the
#   resampling), CNX_TRAIN_STEPS steps, the val figure, the 32-tile split
#   predicted, and the card against the CPU on P2P_CPU_TILES tiles
#   (P2P_REL_TOL, as phase 6);
# - the ablation twins on the card: `cli.dino_v2_ablation` for each encoder
#   in a model root of its own (ROADMAP 3.19: the two rows read one
#   checkpoint path), `cli.image_res_ablation` with the 224 px tiles for
#   both rows (the 512 row a seeded UNet-ResNet101 at 512, whose polygons
#   land on the 512 grid: ROADMAP 3.18), each on ABLATION_TEST_TILES tiles,
#   and `cli.csv_results_to_latex`.
CNX_TRAIN_STEPS = 2
DINO_GRID = 37
# the UNet's card-against-CPU step, its gradient held against float64 (a
# step on the card: on the CPU it took about 16 s a tile), on the first
# UNET_EXACT_TILES of the first batch; ConvNeXt's on
# HISUP_BF16_CPU_TILES, where its float32 gradients on one tile read 2.95e-4
# (card, NVIDIA H100 80GB HBM3 at 700 W) and 1.56e-4 (CPU) from float64,
# too near the bound to hold
UNET_EXACT_TILES = 1
# The last script twins (phase 24), each through its `main` on the card:
# - `cli.postprocess_oracle`: each row held to tests/test_postprocess_quality.py's
#   floors (IoU, C-IoU, NR), which the JAX script's rows clear on the CPU;
#   the same command with `device=cpu`: the HiSup and Pix2Poly rows (host
#   code) equal, the FFL rows within ORACLE_CPU_TOL (the ACM and ASM are
#   chaotic at the ulp level, ROADMAP 3.9 and 3.10; the bound of
#   tests/test_torch_script_twins.py, the twin against JAX on the CPU);
# - `cli.measure_predict_e2e` over phase 6's seeded Pix2Poly-image (all 385
#   decode steps: a random model emits no EOS) under
#   `run_type.test_subset=ABLATION_TEST_TILES`: it must report those tiles,
#   every pass writing the same set of image ids;
# - `cli.profile train` (3 traced runs) and `generate` (PROFILE_GENERATE_RUNS
#   traced runs): the greedy decode takes one argmax a step, so the
#   generate trace holds at least runs x max_len - 1 launches of the
#   argmax's reduction kernel; the train trace, the decoder's embedding and
#   its backward once a run and a kernel for every matrix product;
# - `cli.gather_pretrained_models` over the model root of phases 4-22,
#   `cli.droplidar50_ablation` over phase 18's seeded p2p_fusion in a root of
#   its own (ROADMAP 3.15: its two rows predict with one model on the same
#   inputs, so they must be equal; they read IoU 0.1094 and 0.1070 while
#   the voxelizer's centroid sums were atomic, ROADMAP 3.21).
ORACLE_FLOORS = {
    "ffl.acm.tol_1": (0.88, 0.70, 0.75),
    "hisup": (0.85, 0.70, 0.78),
    "pix2poly": (0.85, 0.75, 0.85),
    "ffl.asm.tol_1": (0.78, 0.65, 0.78),
}
ORACLE_CPU_TOL = 0.02
ORACLE_ASM_TILES = 4
PROFILE_GENERATE_RUNS = 1
# Repeatable prediction (ROADMAP 3.21): each path below predicts
# twice from the same weights on the same tiles in one process, and the two
# results must be bitwise equal (every tensor and array byte for byte, the
# prediction file byte for byte). Training is not held so: its backward
# sums atomically in no fixed order (the notes on phases 21 and 22).
REPEAT_PATHS = ("hisup_image", "p2p_image", "ffl_image", "hisup_lidar", "p2p_fusion", "p2p_lidar",
                "hisup_fusion", "ffl_lidar", "ffl_fusion", "ffl_lidar_dense", "ffl_image_trained_split")
# the fusion encoder's stages, in order, for the isolation in phase 18
FUSION_STAGES = ("features", "canvas", "fusion_conv", "tokens")
FUSION_INDEX_ADD_RUNS = 3
PHASE23_TEST_TILES = 8
# the ablation twins of phases 23-25 predict the first ABLATION_TEST_TILES
# of the test split, one batch (16, then 8 before phase 26 came: cuts
# for the run's time; every path runs the whole split elsewhere)
ABLATION_TEST_TILES = 4
# The LiDAR and fusion grid (phase 25):
# - `cli.modality_ablation`'s LiDAR and fusion rows on the first
#   GRID_LIDAR_TEST_TILES test tiles, one batch (the whole 32-tile split
#   before phase 26 came, cut for the run's time: phase 18 predicts
#   p2p_fusion's whole split twice, phase 26 a trained FFL's);
#   `cli.lidar_density_ablation` and `cli.all_countries` on
#   ABLATION_TEST_TILES, each row's
#   `best_val_iou` an earlier phase's checkpoint or a model seeded from
#   GRID_SEED;
# - under `run_type=release`, the first RELEASE_BATCHES train batches of the
#   8-thread loader against the 0-thread loader, and
#   `cli.measure_predict_e2e` on RELEASE_TEST_TILES test tiles.
GRID_SEED = 0
GRID_LIDAR_TEST_TILES = 16
RELEASE_BATCHES = 3
# the loader timed at 8 and 0 threads in turns over its first batches
LOADER_TURN_BATCHES = 2
RELEASE_TEST_TILES = 16
# phase 25 (d)'s dense HiSup step on the card against the CPU on
# DENSE_CPU_TILES tiles (2 before phase 26 came: the CPU step at 512 px
# took 19.8 s; phase 17 holds HiSup-LiDAR's on 1 tile too)
DENSE_CPU_TILES = 1
# phase 25 (d) also steps FFL over the dense encoder once (`ffl_lidar
# encoder=pointpillars`), its eval forward on DENSE_FFL_CPU_TILES tiles on
# the card against the CPU (LIDAR_FWD_TOL)
DENSE_FFL_CPU_TILES = 2
# Phase 26, a trained FFL: FFL-image at bfloat16 from FFL_SEED's weights
# through `cli.train` on the synthetic split at its own counts (256 train,
# 32 val and 32 test tiles, in a dataset root of its own) from the device
# cache, TRAINED_EPOCHS epochs of 16 steps: epochs 0-10 cross both of the
# loss weights' switches (5 and 10), the val IoU runs at epochs 4, 9 and 10
# and `save_every` writes epoch_10. The val IoU at the last epoch and the
# test split's IoU from `best_val_iou` must reach TRAINED_MIN_IOU (the JAX
# package's run on this data passed 0.69 at epoch 4; the BatchNorm fault it
# once had pinned its val IoU at the ground truth's coverage, 0.085); the
# LR of each epoch's last step equals the schedule's to TRAINED_LR_RTOL;
# the peak device memory of the last epoch is within TRAINED_PEAK_RTOL of
# the first's. Then one more epoch resumed from `latest`.
TRAINED_EPOCHS = 11
TRAINED_WEIGHT_EPOCHS = (0, 5, 10)
TRAINED_MIN_IOU = 0.6
TRAINED_LR_RTOL = 1e-6
TRAINED_PEAK_RTOL = 0.05


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)



def timm_vit_state(dim: int, depth: int, patch: int, grid: int, seed: int, split_qkv: bool = False,
                   dinov2: bool = False) -> dict[str, torch.Tensor]:
    """A state_dict in the layout of a timm VisionTransformer (DINO ViT-S/8
    at dim 384, depth 12, patch 8, grid 28), drawn from a seeded numpy
    generator: attention as one fused `qkv` or (`split_qkv`) as separate
    `q`/`k`/`v` projections, and (`dinov2`) DINOv2's LayerScale gammas."""
    r = np.random.RandomState(seed)

    def t(*shape, base=0.0):
        return torch.from_numpy((base + 0.05 * r.standard_normal(shape)).astype(np.float32))

    sd = {"cls_token": t(1, 1, dim), "pos_embed": t(1, grid * grid + 1, dim),
          "patch_embed.proj.weight": t(dim, 3, patch, patch), "patch_embed.proj.bias": t(dim),
          "norm.weight": t(dim, base=1.0), "norm.bias": t(dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        if split_qkv:
            sd.update({f"{p}attn.{x}.{leaf}": t(dim, dim) if leaf == "weight" else t(dim)
                       for x in "qkv" for leaf in ("weight", "bias")})
        else:
            sd.update({p + "attn.qkv.weight": t(3 * dim, dim), p + "attn.qkv.bias": t(3 * dim)})
        sd.update({p + "norm1.weight": t(dim, base=1.0), p + "norm1.bias": t(dim),
                   p + "attn.proj.weight": t(dim, dim), p + "attn.proj.bias": t(dim),
                   p + "norm2.weight": t(dim, base=1.0), p + "norm2.bias": t(dim),
                   p + "mlp.fc1.weight": t(4 * dim, dim), p + "mlp.fc1.bias": t(4 * dim),
                   p + "mlp.fc2.weight": t(dim, 4 * dim), p + "mlp.fc2.bias": t(dim)})
        if dinov2:
            sd.update({p + "ls1.gamma": t(dim, base=0.1), p + "ls2.gamma": t(dim, base=0.1)})
    return sd


def hrnet_reference_state(encoder, seed: int, drop: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """A state_dict in the reference HRNetV2's layout (the ImageNet
    HRNetV2-W48 file's module names: `layer1.0.conv1`, `stage3.1.branches.2.0.bn1`,
    `last_layer.3`, ...) for the modules the port's `encoder` has, drawn
    from a seeded numpy generator; modules whose reference name starts with
    one of `drop` are left out (a partial file)."""
    from pixelspointspolygons_torch.utils.torch_port import _hrnet_entries

    r = np.random.RandomState(seed)
    target = encoder.state_dict()
    sd = {}
    for ref, ours, kind in _hrnet_entries():
        if f"{ours}.weight" not in target or ref.startswith(drop):
            continue
        leaves = ("weight", "bias") if kind == "conv" else ("weight", "bias", "running_mean", "running_var")
        for leaf in leaves:
            if f"{ours}.{leaf}" in target:
                shape = tuple(target[f"{ours}.{leaf}"].shape)
                value = 0.05 * r.standard_normal(shape)
                if leaf == "running_var" or (kind == "bn" and leaf == "weight"):
                    value = 1.0 + np.abs(value)
                sd[f"{ref}.{leaf}"] = torch.from_numpy(value.astype(np.float32))
    return sd


def cuda_ms(fn, launches: int, rounds: int) -> float:
    """Median over `rounds` of the mean time of `launches` back-to-back
    calls, by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def graph_ms(fn, launches: int, rounds: int) -> float:
    """Median over `rounds` of the mean device time of `launches` calls
    captured in one CUDA graph: the kernels' time without the host's cost
    of each call, which back-to-back eager calls (`cuda_ms`) include when a
    kernel is shorter than it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return statistics.median(per)


def cold_ms(fn, rounds: int, flush_bytes: int = 256 << 20) -> float:
    """Median over `rounds` of one call's time by CUDA events, the L2 cache
    (50 MB) flushed before each call by a write of `flush_bytes` outside
    the events. The host enqueues the call while the write runs (about 0.1
    ms for 256 MB), so the events hold the device's time of the call and
    not the host's."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.int32, device=CARD)
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end))
    return statistics.median(per)


def smoke_overrides(train_tiles: int, experiment: str = "hisup_image") -> list[str]:
    """`experiment` on the synthetic split (TRAIN_TILES, 16 and TEST_TILES
    tiles) under the debug run type, training on its first `train_tiles`."""
    return [
        f"experiment={experiment}",
        "dataset=synthetic",
        "run_type=debug",
        f"experiment.dataset.num_train={TRAIN_TILES}",
        "experiment.dataset.num_val=16",
        f"experiment.dataset.num_test={TEST_TILES}",
        f"run_type.train_subset={train_tiles}",
        "run_type.val_subset=null",
        "run_type.test_subset=null",
        "experiment.model.batch_size=16",
        "experiment.model.num_epochs=1",
        "training.save_every=0",
    ]


def phase_host() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    libs = {}
    # the port needs cv2, yaml, PIL and scipy; matplotlib and pandas are
    # printed for information (the port draws with cv2 and writes csv itself)
    for mod in ("cv2", "yaml", "PIL", "scipy", "matplotlib", "pandas"):
        try:
            importlib.import_module(mod)
            libs[mod] = True
        except ImportError:
            libs[mod] = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; host libraries: {libs}", flush=True)
    return smi


def phase_build() -> None:
    from pixelspointspolygons_torch.ops import build

    t0 = time.perf_counter()
    built = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {sorted(built) or 'all cached'}", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}", flush=True)


def afm_inputs(cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """B=16 samples of L=256 segments at 224 px: 12 with the edges of
    synthetic training tiles, 3 with 256 random segments, 1 with none."""
    from pixelspointspolygons_torch.data.loader import build_loader

    loader = build_loader(cfg, "train")
    batch = next(iter(loader))
    lines = np.zeros((B, L, 4), np.float32)
    valid = np.zeros((B, L), bool)
    lines[:12] = batch["edges"][:12]
    valid[:12] = batch["edges_valid"][:12]
    rng = np.random.RandomState(0)
    lines[12:15] = rng.uniform(0, S, (3, L, 4)).astype(np.float32)
    valid[12:15] = True
    dev = torch.device("cuda")
    return torch.from_numpy(lines).to(dev), torch.from_numpy(valid).to(dev)


def afm_against_plain(lines: torch.Tensor, valid: torch.Tensor, what: str) -> float:
    """The AFM kernel against its plain version at S x S; returns the map's
    max abs error. Labels exact: the same IEEE roundings in the same order
    (--fmad=false, and a quotient with the bits of the division); map 1e-5:
    the kernel's logf and torch's log may differ by an ulp (|map| <= 14, so
    an ulp is under 1e-6)."""
    from pixelspointspolygons_torch.ops.afm import afm, afm_cuda

    got_map, got_lab = afm_cuda(lines, valid, S, S)
    want_map, want_lab = afm(lines, valid, S, S)
    torch.cuda.synchronize()
    n_bad = int((got_lab != want_lab).sum())
    err = float((got_map - want_map).abs().max())
    print(f"afm {what}: label mismatches {n_bad}, map max abs err {err:.3g} (tol 1e-5)", flush=True)
    if n_bad:
        fail(f"afm {what}: labels differ from the plain version at {n_bad} pixels")
    if not err <= 1e-5:
        fail(f"afm {what}: map differs from the plain version by {err}")
    empty = ~valid.any(dim=1)
    if float(got_map[empty].abs().sum()) != 0.0 or int(got_lab[empty].abs().sum()) != 0:
        fail(f"afm {what}: a sample with no valid segment must give zeros")
    return err


def phase_afm(cfg) -> dict:
    from pixelspointspolygons_torch.ops.afm import (
        afm,
        afm_cuda,
        division_mismatches,
        division_operands,
        kernel_config,
    )

    conf = kernel_config()
    print(f"afm kernel built with a {conf['rows']}x{conf['cols']} tile of pixels per thread, "
          f"{conf['warps']} warps per block, chunks of {conf['chunk']} segments", flush=True)
    lines, valid = afm_inputs(cfg)
    err = afm_against_plain(lines, valid, f"{B}x{L} -> {S}x{S} (main path)")
    num, den = division_operands(lines, valid, S, S)
    bad, signed_zero = division_mismatches(num, den)
    print(f"afm quotient vs IEEE division on all {num.numel()} operands of the main path: "
          f"{bad} differ, {signed_zero} differ only in the sign of zero", flush=True)
    if bad:
        fail(f"afm: the reciprocal quotient differs from IEEE division on {bad} operands")
    del num, den
    rng = np.random.RandomState(1)
    big = rng.uniform(0, S, (2, 4096, 4)).astype(np.float32)
    big[:, ::3] = np.round(big[:, ::3])
    big_valid = rng.rand(2, 4096) < 0.7
    afm_against_plain(torch.from_numpy(big).cuda(), torch.from_numpy(big_valid).cuda(), f"2x4096 -> {S}x{S}")

    ms = cuda_ms(lambda: afm_cuda(lines, valid, S, S), launches=20, rounds=5)
    device_ms = graph_ms(lambda: afm_cuda(lines, valid, S, S), launches=20, rounds=5)
    plain_ms = cuda_ms(lambda: afm(lines, valid, S, S), launches=2, rounds=3)
    segments = int(valid.sum())
    pairs = segments * S * S
    ops = pairs * AFM_OPS_PER_PAIR + segments * 2 * S * AFM_OPS_PER_TERM
    nbytes = lines.numel() * 4 + valid.numel() + B * 2 * S * S * 4 + B * S * S * 4
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((t_ops, "operations"), (t_bytes, "bytes"))
    unshared_ms = pairs * AFM_OPS_PER_PAIR_UNSHARED / PEAK_FP32_FLOPS * 1e3
    print(
        f"afm: kernel {ms:.4f} ms ({device_ms:.4f} ms replayed in a CUDA graph), plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}; "
        f"{pairs} pixel-segment pairs, {ops/1e9:.4f} GFLOP, {nbytes/1e6:.2f} MB); "
        f"{unshared_ms:.5f} ms at {AFM_OPS_PER_PAIR_UNSHARED} operations per pair with unshared terms",
        flush=True,
    )
    return {
        "name": "afm",
        "route": "cuda",
        "source": "pixelspointspolygons_torch/csrc/afm.cu",
        "replaces": "pixelspointspolygons_tpu/ops/afm_pallas.py:74",
        "launches": None,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the AFM
    }


def lidar_batch(overrides: list[str]) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The synthetic train split's first batch of 16 clouds at 200,000
    points on the card (points, valid) and the encoder's pillar grid."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import build_loader, to_device

    cfg = compose(overrides)
    enc = cfg.experiment.encoder
    card = to_device(next(iter(build_loader(cfg, "train"))), CARD, ("lidar", "lidar_mask"))
    grid = dict(width=float(enc.in_width), height=float(enc.in_height), voxel_x=float(enc.in_voxel_size.x),
                voxel_y=float(enc.in_voxel_size.y))
    return card["lidar"], card["lidar_mask"], grid


def index_add_pillar_sums(pts_s: torch.Tensor, pid_s: torch.Tensor, cap: int, n_cells: int):
    """The voxelizer's sums as the port took them before `csrc/pillar_sums.cu`:
    two `index_add_` calls over flat ids (CUDA atomics, no fixed order),
    with `pillar_sums`'s contract. The yardstick of phase 3 and the negative
    control of the isolation in phase 18; the port never calls it."""
    from pixelspointspolygons_torch.ops.segment import rank_in_run
    from pixelspointspolygons_torch.ops.voxelize import cell_offsets

    B, N, C = pts_s.shape
    keep = (pid_s < n_cells) & (rank_in_run(pid_s) < cap)
    flat = (torch.where(keep, pid_s, n_cells) + cell_offsets(B, n_cells, pts_s.device)).reshape(-1)
    w = keep.to(pts_s.dtype)[..., None]
    sums = pts_s.new_zeros((B * (n_cells + 1), C)).index_add_(0, flat, (pts_s * w).reshape(B * N, C))
    cnts = pts_s.new_zeros((B * (n_cells + 1), 1)).index_add_(0, flat, w.reshape(B * N, 1))
    return sums.reshape(B, n_cells + 1, C), cnts.reshape(B, n_cells + 1).to(torch.int32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bytes (a NaN equals itself, -0 differs from +0)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8), b.contiguous().reshape(-1).view(torch.uint8)))


def sums_layouts_against_plain() -> int:
    """The kernel bitwise against its plain version, and against itself over
    ten calls, on each layout of `ops/pillar_layouts.py` (runs over many
    chunks and a tile, runs of a cap or a chunk and one more or less, empty
    pillars, a sample of padding only, a cap above N, a grid that leaves
    the kernel's pass short; and all of them at 16 x 200,000 points) in
    float32 and float64 at the caps LIDAR_CAPS. Returns the number of
    cases."""
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums, pillar_sums_cuda
    from pixelspointspolygons_torch.ops.pillar_layouts import dense_layout, large_layout, small_layouts

    cases = 0
    for dtype in (np.float32, np.float64):
        layouts = {**small_layouts(dtype), "large": large_layout(dtype), "dense": dense_layout(dtype)}
        for name, (pts, pid, n_cells) in layouts.items():
            pts_s, pid_s = torch.from_numpy(pts).to(CARD), torch.from_numpy(pid).to(CARD)
            for cap in LIDAR_CAPS:
                got = pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
                want = pillar_sums(pts_s, pid_s, cap, n_cells)
                again = [pillar_sums_cuda(pts_s, pid_s, cap, n_cells) for _ in range(10)]
                torch.cuda.synchronize()
                equal = all(same_bits(g, w) for g, w in zip(got, want))
                repeat = all(same_bits(g, a) for r in again for g, a in zip(got, r))
                if not (equal and repeat):
                    fail(f"pillar_sums on the layout {name} ({np.dtype(dtype).name}, cap {cap}): the kernel differs "
                         f"from its plain version ({equal}) or from itself ({repeat})")
                cases += 1
    return cases


def sums_times(pts_s: torch.Tensor, pid_s: torch.Tensor, cap: int, n_cells: int, what: str) -> dict:
    """CUDA-event times of `pillar_sums_cuda` on sorted points warm
    (back-to-back calls, and replayed in a CUDA graph), cold (the L2
    flushed before each call), of the plain version and of the two
    `index_add_` calls it replaced, and the bound."""
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums, pillar_sums_cuda

    B, N, C = pts_s.shape
    kept = int(pillar_sums(pts_s, pid_s, cap, n_cells)[1].sum())
    ms = cuda_ms(lambda: pillar_sums_cuda(pts_s, pid_s, cap, n_cells), launches=20, rounds=5)
    graph = graph_ms(lambda: pillar_sums_cuda(pts_s, pid_s, cap, n_cells), launches=20, rounds=5)
    cold = cold_ms(lambda: pillar_sums_cuda(pts_s, pid_s, cap, n_cells), rounds=7)
    plain_ms = cuda_ms(lambda: pillar_sums(pts_s, pid_s, cap, n_cells), launches=2, rounds=3)
    library_ms = cuda_ms(lambda: index_add_pillar_sums(pts_s, pid_s, cap, n_cells), launches=10, rounds=5)
    # the least bytes: each kept coordinate read once, the sums and counts
    # written once (the padding and the ids past a pillar's cap need not be
    # read); one add per kept coordinate
    size = pts_s.element_size()
    nbytes = kept * C * size + B * (n_cells + 1) * (C * size + 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, kept * C / PEAK_FP32_FLOPS * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    whole_ms = (pts_s.numel() * size + pid_s.numel() * 8) / PEAK_BYTES_PER_S * 1e3
    print(f"pillar_sums {what}: kernel {ms:.5f} ms warm ({graph:.5f} ms replayed in a CUDA graph), "
          f"{cold:.5f} ms cold (L2 flushed), plain {plain_ms:.3f} ms, the two index_add_ calls it "
          f"replaces {library_ms:.4f} ms (CUDA events); bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB of kept points and outputs; {whole_ms:.5f} ms to read all "
          f"{(pts_s.numel() * size + pid_s.numel() * 8) / 1e6:.1f} MB of points and ids once)", flush=True)
    return {"ms": ms, "graph_ms": graph, "cold_ms": cold, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "kept": kept, "n_cells": n_cells, "cap": cap}


def phase_pillar_sums() -> dict:
    """Phase 3, the voxelizer's kernel: `pillar_sums_cuda` against its plain
    version `pillar_sums` on the synthetic train split's first 16 clouds at
    200,000 points, sorted as `assign_pillars` sorts them, at the caps
    LIDAR_CAPS in float32 and float64: sums and counts bitwise equal, and
    ten calls in a row too; the same on the layouts the kernel splits its
    work on; the kernel's registers, shared memory and spills (ptxas) and
    its blocks per SM; CUDA-event times of the kernel warm (back-to-back
    calls, and replayed in a CUDA graph: the device's time without the
    host's) and cold (one call after the L2 is flushed), of the plain
    version and of the two `index_add_` calls it replaces, and the bound;
    the same times on the dense encoder's grid (65,536 pillars, cap 4)."""
    from pixelspointspolygons_torch.ops import build
    from pixelspointspolygons_torch.ops.pillar_layouts import DENSE_CAP, dense_layout
    from pixelspointspolygons_torch.ops.voxelize import (
        pillar_sums,
        pillar_sums_cuda,
        sort_by_pillar,
        sums_kernel_config,
    )

    conf = sums_kernel_config()
    tile = 32 * conf["warps"] * conf["scan"]
    design = (f"a block a tile of {tile} sorted rows of one sample, owning the pillars whose runs start in it; a "
              f"padding tile stops after one read; one coalesced read of the tile's ids and the next "
              f"{32 * conf['warps']} finds every owned pillar's start and the last one's end (a longer run's end "
              f"searched); {conf['per_warp']} pillars a warp, their kept points staged as 16-byte units by "
              f"cp.async in chunks of {conf['stage_bytes']} bytes, two buffers a warp; one lane a (pillar, "
              f"coordinate) adds its points in sorted order")
    print(f"pillar_sums kernel: {design}; {conf['blocks_per_sm_float']} blocks per SM in float32, "
          f"{conf['blocks_per_sm_double']} in float64", flush=True)
    log_path = build.library_path("pillar_sums") + ".log"  # written when the library was built
    build_log = ""
    if os.path.isfile(log_path):
        with open(log_path) as f:
            build_log = f.read()
    for entry, usage in build.ptxas_usage(build_log, "pillar_sums_kernel").items():
        kind = "float32" if "kernelIf" in entry else "float64" if "kernelId" in entry else entry
        print(f"pillar_sums ptxas, {kind}: {usage}", flush=True)
    print(f"pillar_sums on {sums_layouts_against_plain()} layout cases (float32 and float64, caps {LIDAR_CAPS}): "
          f"bitwise equal to the plain version and over ten calls", flush=True)

    pts, valid, grid = lidar_batch(lidar_overrides("hisup_lidar"))
    rows = {}
    for dtype in (torch.float32, torch.float64):
        pts_s, pid_s, n_cells = sort_by_pillar(pts.to(dtype), valid, **grid)
        B, N, C = pts_s.shape
        for cap in LIDAR_CAPS:
            got = pillar_sums_cuda(pts_s, pid_s, cap, n_cells)
            want = pillar_sums(pts_s, pid_s, cap, n_cells)
            again = [pillar_sums_cuda(pts_s, pid_s, cap, n_cells) for _ in range(10)]
            torch.cuda.synchronize()
            equal = all(same_bits(g, w) for g, w in zip(got, want))
            repeat = all(same_bits(g, a) for r in again for g, a in zip(got, r))
            kept = int(got[1].sum())
            print(f"pillar_sums {B}x{N} points ({str(dtype)[6:]}), cap {cap}: {kept} points kept in "
                  f"{int((got[1] > 0).sum())} pillars; sums and counts bitwise equal to the plain version {equal}, "
                  f"ten more calls bitwise equal {repeat}", flush=True)
            if not (equal and repeat):
                fail(f"pillar_sums (cap {cap}, {dtype}): the kernel differs from its plain version ({equal}) or "
                     f"from itself ({repeat})")
            if dtype == torch.float32:
                rows[cap] = sums_times(pts_s, pid_s, cap, n_cells, f"cap {cap}")
    # the dense encoder's grid (encoder=pointpillars, phase 25): 256 x 256
    # pillars of 2 px at cap 4, the synthetic clouds' padding share
    pts_s, pid_s, n_cells = dense_layout()
    pts_s, pid_s = torch.from_numpy(pts_s).to(CARD), torch.from_numpy(pid_s).to(CARD)
    dense = sums_times(pts_s, pid_s, DENSE_CAP, n_cells, f"dense grid ({n_cells} pillars, cap {DENSE_CAP})")
    print(f"pillar_sums on the dense grid against cap 64 on the 784-pillar grid: graph {dense['graph_ms']:.5f} "
          f"against {rows[64]['graph_ms']:.5f} ms, cold {dense['cold_ms']:.5f} against {rows[64]['cold_ms']:.5f} ms",
          flush=True)
    main = rows[64]  # the cap of every LiDAR and fusion encoder of the config tree
    return {
        "name": "pillar_sums",
        "route": "cuda",
        "source": "pixelspointspolygons_torch/csrc/pillar_sums.cu",
        "replaces": "none (the TPU's XLA scatter-add, pixelspointspolygons_tpu/ops/voxelize.py:81)",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],  # two index_add_ calls, the route it replaced
        "graph_ms": main["graph_ms"],  # the device's time, replayed in a CUDA graph
        "cold_ms": main["cold_ms"],
        "design": design,
        "by_cap": rows,
        "dense": dense,
    }


def run_sums_ids(pid_s: torch.Tensor, cap: int, n_cells: int) -> torch.Tensor:
    """The PillarFeatureNet's flat ids for sorted pillar ids (B, N) at
    `cap`, as `PillarCanvas` gives them: each kept point's pillar, every
    other row its sample's dump cell, offset by sample."""
    from pixelspointspolygons_torch.ops.segment import rank_in_run
    from pixelspointspolygons_torch.ops.voxelize import cell_offsets

    keep = (pid_s < n_cells) & (rank_in_run(pid_s) < cap)
    return (torch.where(keep, pid_s, n_cells) + cell_offsets(pid_s.shape[0], n_cells, pid_s.device)).reshape(-1)


def run_rows(n: int, channels: int, seed: int, dtype: torch.dtype) -> torch.Tensor:
    """(n, channels) rows drawn on the card from `seed`, spanning nine orders
    of magnitude with either sign: a sum in any other order than the rows'
    gives other bits."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    scale = 10.0 ** (torch.rand((n, 1), generator=gen, device=CARD) * 9.0 - 3.0)
    return (torch.randn((n, channels), generator=gen, device=CARD) * scale).to(dtype)


def run_sums_layouts_against_plain() -> int:
    """`run_sums_cuda` bitwise against its plain version, and against itself
    over three calls, at RUN_SUMS_CHANNELS channels on the layouts of
    `ops/pillar_layouts.py`, flattened as the PillarFeatureNet flattens
    them: the small ones (`run_layouts`: the pillar sums' and the run sums'
    own edges) at the caps LIDAR_CAPS in float32, float64 and
    bfloat16, the 16 x 200,000-point one at cap 64 in float32 and the dense
    grid at its cap 4 in float64 (the plain version takes seconds there: a
    loop over the longest chain). Returns the number of cases."""
    from pixelspointspolygons_torch.ops.pillar_layouts import DENSE_CAP, dense_layout, large_layout, run_layouts
    from pixelspointspolygons_torch.ops.run_sums import run_sums, run_sums_cuda

    cases = [(name, pid, n_cells, cap, dtype) for name, (_, pid, n_cells) in run_layouts().items()
             for cap in LIDAR_CAPS for dtype in (torch.float32, torch.float64, torch.bfloat16)]
    _, pid, n_cells = large_layout()
    cases.append(("large", pid, n_cells, 64, torch.float32))
    _, pid, n_cells = dense_layout()
    cases.append(("dense", pid, n_cells, DENSE_CAP, torch.float64))
    for i, (name, pid, n_cells, cap, dtype) in enumerate(cases):
        pid_s = torch.from_numpy(pid).to(CARD)
        B = pid_s.shape[0]
        ids = run_sums_ids(pid_s, cap, n_cells)
        x = run_rows(len(ids), RUN_SUMS_CHANNELS, i, dtype)
        S = B * (n_cells + 1)
        got = run_sums_cuda(x, ids, S, B)
        want = run_sums(x, ids, S)
        again = [run_sums_cuda(x, ids, S, B) for _ in range(3)]
        torch.cuda.synchronize()
        equal, repeat = same_bits(got, want), all(same_bits(got, a) for a in again)
        if not (equal and repeat):
            err = (got.double() - want.double()).abs().max().item()
            fail(f"run_sums on the layout {name} ({str(dtype)[6:]}, cap {cap}): the kernel differs from its plain "
                 f"version ({equal}, largest gap {err:.3e}) or from itself ({repeat})")
    return len(cases)


def run_sums_plain_check(x: torch.Tensor, ids: torch.Tensor, S: int, B: int, what: str) -> float:
    """One call of the plain version `run_sums` (seconds: a loop over the
    longest chain), held bitwise against `run_sums_cuda` on the same
    inputs; returns the plain version's CUDA-event ms."""
    from pixelspointspolygons_torch.ops.run_sums import run_sums, run_sums_cuda

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = run_sums(x, ids, S)
    end.record()
    got = run_sums_cuda(x, ids, S, B)
    torch.cuda.synchronize()
    if not same_bits(got, want):
        err = (got.double() - want.double()).abs().max().item()
        fail(f"run_sums {what}: the kernel differs from its plain version (largest gap {err:.3e})")
    return start.elapsed_time(end)


def run_sums_times(x: torch.Tensor, ids: torch.Tensor, S: int, B: int, what: str, plain: bool = True) -> dict:
    """CUDA-event times of `run_sums_cuda` warm (back-to-back calls, and
    replayed in a CUDA graph), cold (the L2 flushed before each call), of
    the plain version (with `plain`, whose result the kernel's must equal
    bitwise) and of the route it replaced (`index_put_` with accumulate,
    autograd's backward of `pooled[pillar_id]`), and the bound."""
    from pixelspointspolygons_torch.ops.run_sums import run_sums_cuda

    ms = cuda_ms(lambda: run_sums_cuda(x, ids, S, B), launches=10, rounds=5)
    graph = graph_ms(lambda: run_sums_cuda(x, ids, S, B), launches=10, rounds=3)
    cold = cold_ms(lambda: run_sums_cuda(x, ids, S, B), rounds=5)
    plain = run_sums_plain_check(x, ids, S, B, what) if plain else None
    library = cuda_ms(lambda: x.new_zeros((S, x.shape[1])).index_put_((ids,), x, accumulate=True), launches=2,
                      rounds=3)
    size = x.element_size()
    nbytes = x.numel() * size + ids.numel() * 8 + S * x.shape[1] * size
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, x.numel() / PEAK_FP32_FLOPS * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    print(f"run_sums {what}: kernel {ms:.5f} ms warm ({graph:.5f} ms replayed in a CUDA graph), {cold:.5f} ms cold "
          f"(L2 flushed), plain {plain} ms{' (bitwise equal to the kernel)' if plain else ''}, index_put_ with accumulate (the route it replaced) {library:.4f} ms "
          f"(CUDA events); bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB of rows, ids and sums)",
          flush=True)
    return {"ms": ms, "graph_ms": graph, "cold_ms": cold, "plain_ms": plain, "library_ms": library,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}


def phase_run_sums() -> dict:
    """Phase 3, the PillarFeatureNet's backward kernel: `run_sums_cuda`
    against its plain version `run_sums` on the layouts of
    `ops/pillar_layouts.py` (bitwise, and over three calls); its registers,
    shared memory and spills (ptxas) and blocks per SM; on the synthetic
    train split's first 16 clouds at 200,000 points, at cap 64 (the main
    path's ids): at 64 channels (the gather's gradient and the first
    layer's tie count) times of the kernel warm, in a CUDA graph and cold,
    of the plain version and of the `index_put_` it replaced; at 384 (the
    second layer's) the kernel's time warm and the plain version's; at both
    widths the kernel bitwise equal to the plain version; and times on the
    dense encoder's grid."""
    from pixelspointspolygons_torch.ops import build
    from pixelspointspolygons_torch.ops.pillar_layouts import DENSE_CAP, dense_layout
    from pixelspointspolygons_torch.ops.run_sums import run_sums_config
    from pixelspointspolygons_torch.ops.voxelize import sort_by_pillar

    conf = run_sums_config()
    design = (f"one launch of {conf['warps']}-warp blocks, {conf['smem_bytes']} bytes of dynamic shared memory "
              f"(float32): a block per (sample, 32 channels) walks the sample's dump-cell chain, "
              f"{conf['warps'] - 1} producer warps copying only its dump rows, compacted, by cp.async into a ring "
              f"of {conf['stages']} slots of {conf['tile_bytes']} bytes, +0.0 after them, under full and empty "
              f"mbarriers while warp 0 adds every slot's rows in order, {conf['group_rows']} rows read ahead, "
              f"without a branch, lane c channel c; "
              f"the other blocks take {conf['run_tile_rows']} positions of a sample, stop after one read of their "
              f"ids where no pillar run starts, else find the runs' starts and ends in that read and add each "
              f"run's rows in order, staged by cp.async, lane c channel c")
    print(f"run_sums kernel: {design}; blocks per SM: {conf['blocks_per_sm_float']} float32, "
          f"{conf['blocks_per_sm_double']} float64, {conf['blocks_per_sm_bfloat16']} bfloat16", flush=True)
    log_path = build.library_path("run_sums") + ".log"
    build_log = ""
    if os.path.isfile(log_path):
        with open(log_path) as f:
            build_log = f.read()
    ptxas = build.ptxas_usage(build_log, "run_sums_kernel")
    for entry, usage in ptxas.items():
        kind = ("float32" if "kernelIf" in entry else "float64" if "kernelId" in entry
                else "bfloat16" if "bfloat16" in entry else entry)
        print(f"run_sums ptxas, {kind}: {usage}", flush=True)
    print(f"run_sums on {run_sums_layouts_against_plain()} layout cases ({RUN_SUMS_CHANNELS} channels): bitwise "
          f"equal to the plain version and over three calls", flush=True)

    pts, valid, grid = lidar_batch(lidar_overrides("hisup_lidar"))
    _, pid_s, n_cells = sort_by_pillar(pts, valid, **grid)
    B = pid_s.shape[0]
    ids = run_sums_ids(pid_s, 64, n_cells)
    S = B * (n_cells + 1)
    # the chain's length: the longest sample's dump rows, one dependent add each
    dump_rows = int((ids.reshape(B, -1) == torch.arange(1, B + 1, device=CARD)[:, None] * (n_cells + 1) - 1)
                    .sum(dim=1).max())
    print(f"run_sums main path ids: the longest sample holds {dump_rows} dump rows of {pid_s.shape[1]}", flush=True)
    main = run_sums_times(run_rows(len(ids), RUN_SUMS_CHANNELS, 0, torch.float32), ids, S, B,
                          f"main path ids ({B} x {pid_s.shape[1]} rows, cap 64), {RUN_SUMS_CHANNELS} channels")
    from pixelspointspolygons_torch.ops.run_sums import run_sums_cuda

    wide = run_rows(len(ids), 384, 1, torch.float32)
    wide_ms = cuda_ms(lambda: run_sums_cuda(wide, ids, S, B), launches=5, rounds=3)
    wide_plain = run_sums_plain_check(wide, ids, S, B, "on the main path's ids at 384 channels")
    wide_bound = (wide.numel() * 4 + ids.numel() * 8 + S * 384 * 4) / PEAK_BYTES_PER_S * 1e3
    print(f"run_sums main path ids at 384 channels (the second PFN layer's tie count): kernel {wide_ms:.4f} ms warm, "
          f"plain {wide_plain:.1f} ms (bitwise equal to the kernel), bound {wide_bound:.4f} ms (bytes)", flush=True)
    del wide
    torch.cuda.empty_cache()
    _, pid, n_cells = dense_layout()
    pid_s = torch.from_numpy(pid).to(CARD)
    ids = run_sums_ids(pid_s, DENSE_CAP, n_cells)
    dense = run_sums_times(run_rows(len(ids), RUN_SUMS_CHANNELS, 2, torch.float32), ids,
                           pid_s.shape[0] * (n_cells + 1), pid_s.shape[0],
                           f"dense grid ({n_cells} pillars, cap {DENSE_CAP}), {RUN_SUMS_CHANNELS} channels", plain=False)
    return {
        "name": "run_sums",
        "route": "cuda",
        "source": "pixelspointspolygons_torch/csrc/run_sums.cu",
        "replaces": ("none (the backward of the PillarFeatureNet's gather and segment max, XLA scatter-adds: "
                     "pixelspointspolygons_tpu/models/pointpillars.py:31-57)"),
        "launches": None,
        "max_abs_err": 0.0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],  # index_put_ with accumulate, the route it replaced
        "graph_ms": main["graph_ms"],
        "cold_ms": main["cold_ms"],
        "design": design,
        "config": conf,
        "longest_dump_rows": dump_rows,
        "ptxas": ptxas,
        "wide_ms": wide_ms,
        "wide_plain_ms": wide_plain,
        "dense": dense,
    }


def record_steps(trainer, step_losses: list, iou_pass_s: list, first: dict | None = None,
                 loader_ms: list | None = None) -> None:
    """Have the trainer's set-up wrap its train step so that it records
    each step's metrics, and time its val-IoU pass. With `first`, the first
    step's weights and HISUP_BF16_CPU_TILES samples of its batch are copied
    into it (to the host, so that the copy adds nothing to the peak). With
    `loader_ms`, the host ms of each train batch the loader builds."""
    def timed_predict_and_eval(epoch, run=trainer.predict_and_eval):
        t = time.perf_counter()
        iou = run(epoch)
        torch.cuda.synchronize()
        iou_pass_s.append(time.perf_counter() - t)
        return iou

    def setup_and_record(run=trainer.setup):
        run()
        step = trainer._train_step

        def recorded(state, batch, *args):
            if first is not None and not first:
                first["state"] = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
                first["batch"] = {k: v[:HISUP_BF16_CPU_TILES].cpu() for k, v in batch.items()}
            metrics = step(state, batch, *args)
            step_losses.append(metrics)
            return metrics

        trainer._train_step = recorded
        if loader_ms is not None:
            make = trainer.train_loader._make_batch

            def timed(idxs):
                t = time.perf_counter()
                out = make(idxs)
                loader_ms.append((time.perf_counter() - t) * 1e3)
                return out

            trainer.train_loader._make_batch = timed

    trainer.predict_and_eval = timed_predict_and_eval
    trainer.setup = setup_and_record


def phase_train(cfg_overrides: list[str], dtype: str = "float32") -> tuple[dict, dict]:
    """HiSup-image training at full width through the trainer that
    `cli/train.py` builds, at `dtype`: 4 train + 1 val steps and the val-IoU
    pass with the kernel counters set to 0 just before and read just after,
    then the steady-state step, its parts and the card against the CPU."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer

    cfg = compose(cfg_overrides + [f"host.compute_dtype={dtype}"])
    trainer = HiSupTrainer(cfg)
    iou_pass_s, step_losses, first = [], [], {}
    record_steps(trainer, step_losses, iou_pass_s, first if dtype == "bfloat16" else None)
    torch.cuda.reset_peak_memory_stats()
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"afm": afm_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    n_train, n_val = len(trainer.train_loader), len(trainer.val_loader)
    model = trainer.state.model
    losses = [{k: float(v) for k, v in m.items()} for m in step_losses]
    print(
        f"main path ({dtype}): {n_train} train + {n_val} val steps and the val-IoU pass in {wall:.1f} s "
        f"(set-up included), peak memory {peak/2**30:.2f} GiB; launches {launches}; model computes in "
        f"{model.compute_dtype}, parameters {next(model.parameters()).dtype}",
        flush=True,
    )
    print(f"history ({dtype}): " + json.dumps(history), flush=True)
    print(f"step losses ({dtype}): " + json.dumps(losses), flush=True)
    if (n_train, n_val) != (TRAIN_STEPS, VAL_STEPS) or len(losses) != n_train:
        fail(f"expected {TRAIN_STEPS} train and {VAL_STEPS} val steps, got {n_train}, {n_val}, {len(losses)}")
    if not all(np.isfinite(v) for k, v in history.items() if k != "epoch"):
        fail(f"non-finite losses ({dtype}): {history}")
    if launches["afm"] != n_train + n_val:
        fail(f"afm launched {launches['afm']} times ({dtype}), expected {n_train + n_val}")
    if model.compute_dtype != getattr(torch, dtype) or next(model.parameters()).dtype != torch.float32:
        fail(f"HiSup ({dtype}): the model computes in {model.compute_dtype}")
    if not trainer.manager.exists("latest") or not trainer.manager.exists("best_val_loss"):
        fail("trainer wrote no latest/best_val_loss checkpoint")
    val_iou = history.get("val_iou")
    if val_iou is None or not 0.0 <= val_iou <= 1.0 or len(iou_pass_s) != 1:
        fail(f"the val-IoU pass gave no IoU in [0, 1]: {val_iou}")
    # best_val_iou is written only above the initial best (0.0), which a
    # 4-step model need not reach
    print(f"val-IoU pass ({dtype}): {n_val * B} val tiles polygonized in {iou_pass_s[0] * 1e3:.1f} ms (wall), "
          f"val IoU {val_iou:.4f}, best_val_iou written: {trainer.manager.exists('best_val_iou')}", flush=True)

    # steady state on the same batches (not part of the counted run)
    t = time.perf_counter()
    host = list(trainer.train_loader)
    loader_ms = (time.perf_counter() - t) * 1e3 / len(host)
    batches = list(device_prefetch(host, trainer.device, _DEV_KEYS))
    trainer._train_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    times = []
    for batch in batches:
        t = time.perf_counter()
        trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    t = time.perf_counter()
    trainer._val_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t) * 1e3
    print(f"train step ({dtype}) {step_ms:.1f} ms (median of {len(times)}: {[round(x, 1) for x in times]}), "
          f"val step {val_ms:.1f} ms, host loader {loader_ms:.1f} ms per batch", flush=True)
    parts = [step_parts(trainer, batch) for batch in batches]
    breakdown = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    print(f"train step ({dtype}) by layer (ms, CUDA events, median of {len(parts)}): {json.dumps(breakdown)}",
          flush=True)
    flops = conv_flops(trainer.state.model, batches[0]["images"])
    peak_flops = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    print(
        f"convolutions ({dtype}): {flops / 1e12:.3f} TFLOP in the forward, about twice that in the backward; "
        f"forward {flops / breakdown['forward'] / 1e9:.1f} TFLOP/s, "
        f"backward {2 * flops / breakdown['backward'] / 1e9:.1f} TFLOP/s "
        f"(peak {peak_flops / 1e12:.0f} TFLOP/s at {dtype}, TF32 off)",
        flush=True,
    )
    profile_forward(trainer, batches[0]["images"], dtype)
    if dtype == "float32":
        check_against_cpu(trainer, batches[0])
    else:
        hisup_bf16_card_against_cpu(trainer.cfg, first)
    train_twice(f"hisup_image_{dtype}", trainer, batches, (), {"afm": True, "pillar_sums": False, "run_sums": False})
    return launches, {"step_ms": step_ms, "val_ms": val_ms, "peak_bytes": peak, "iou_pass_ms": iou_pass_s[0] * 1e3,
                      "val_iou": val_iou, "losses": losses, "breakdown": breakdown,
                      "output_dir": cfg.output_dir}


def hisup_bf16_card_against_cpu(cfg, first: dict) -> None:
    """The bfloat16 model on the card against the same on the CPU, from the
    first train step's weights, in eval mode on BF16_EVAL_TILES tiles of its
    batch: each head within HISUP_BF16_REL_L2 in relative L2 (the CPU path
    is held to flax's bfloat16 by tests/test_torch_hisup_bf16.py). Each
    side's distance from the same weights' float32 output on the card is
    printed beside it."""
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup

    images = first["batch"]["images"][:BF16_EVAL_TILES]
    models = {}
    for name, dev, dtype in (("card", CARD, torch.bfloat16), ("cpu", torch.device("cpu"), torch.bfloat16),
                             ("float32", CARD, torch.float32)):
        models[name] = build_hisup(cfg, device=dev, dtype=dtype)
        models[name].load_state_dict(first["state"])
        models[name].eval()
    with torch.no_grad():
        out = models["card"]({"images": images.to(CARD)})
        ref = models["float32"]({"images": images.to(CARD)})
        t = time.perf_counter()
        out_cpu = models["cpu"]({"images": images})
        cpu_s = time.perf_counter() - t
    if any(v.dtype != torch.bfloat16 for v in list(out.values()) + list(out_cpu.values())):
        fail(f"the bfloat16 HiSup gave {[v.dtype for v in out.values()]}")
    apart = {k: round(rel_l2(out[k], v), 5) for k, v in out_cpu.items()}
    card = {k: round(rel_l2(out[k], ref[k]), 5) for k in ref}
    cpu = {k: round(rel_l2(out_cpu[k], ref[k]), 5) for k in ref}
    print(f"HiSup bfloat16 card vs CPU on {len(images)} tiles from the first step's weights, eval mode (CPU bfloat16 "
          f"forward {cpu_s:.1f} s), relative L2 per head: {apart} (tol {HISUP_BF16_REL_L2}); from the float32 output "
          f"of the same weights: card {card}, CPU {cpu}", flush=True)
    bad = [k for k, v in apart.items() if not v <= HISUP_BF16_REL_L2]
    if bad:
        fail(f"bfloat16 HiSup on the card differs from the CPU at {bad}: {apart}")


def profile_call(fn, what: str, top: int = 10) -> dict:
    """`fn()` traced once by torch.profiler after a warm-up call: its wall
    time, the host's top-level aten calls, the kernels launched and their
    device time, the card's busy share, and the kernels that take the
    most, summed over their launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    aten = [e for e in events if e.name.startswith("aten::")
            and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    busy_ms = sum(sum(v) for v in by_name.values()) / 1e3
    print(f"{what} traced (torch.profiler): {wall_ms:.1f} ms wall, {len(aten)} top-level aten calls, {len(kernels)} "
          f"kernels, {busy_ms:.2f} ms of kernel time (the card busy {100 * busy_ms / wall_ms:.1f} %); most: "
          + "; ".join(f"{k[:80]} x{len(v)} {sum(v) / 1e3:.2f} ms" for k, v in rows[:top]), flush=True)
    return {"wall_ms": wall_ms, "aten": len(aten), "kernels": len(kernels), "kernel_ms": busy_ms,
            "busy_share": busy_ms / wall_ms}


def profile_forward(trainer, images: torch.Tensor, what: str, top: int = 10) -> None:
    """One train-mode forward (no grad) traced by `profile_call`, on a copy
    of the model, whose BatchNorm statistics the train-mode forwards update
    in place of the trainer's."""
    import copy

    model = copy.deepcopy(trainer.state.model).train()
    with torch.no_grad():
        profile_call(lambda: model({"images": images}), f"forward ({what}; one train-mode forward, no grad)", top)


def step_parts(trainer, batch: dict) -> dict:
    """One train step cut at its layers by CUDA events on the stream: the
    targets (with the AFM kernel), forward, losses, backward and AdamW. The
    same calls as train/hisup_step.py::make_train_step."""
    from pixelspointspolygons_torch.models.hisup.model import encode_targets, hisup_losses

    state = trainer.state
    weights = {k: float(v) for k, v in trainer.cfg.experiment.model.loss_weights.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    targets = encode_targets(batch, S)
    ev[1].record()
    state.model.train()
    outputs = state.model({"images": batch["images"]})
    ev[2].record()
    total = sum(weights[k] * v for k, v in hisup_losses(outputs, targets).items())
    ev[3].record()
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    ev[4].record()
    state.optimizer.step()
    ev[5].record()
    torch.cuda.synchronize()
    names = ("targets", "forward", "losses", "backward", "optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def conv_flops(model, images: torch.Tensor) -> int:
    """Operations of the forward's convolutions (2 per multiply-add), from
    the output shapes that a hook on every convolution sees in one forward."""
    total = 0

    def count(mod, args, out):
        nonlocal total
        total += 2 * out.numel() * (mod.in_channels // mod.groups) * math.prod(mod.kernel_size)

    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d))]
    handles = [m.register_forward_hook(count) for m in convs]
    try:
        with torch.no_grad():
            model.eval()({"images": images})
    finally:
        for h in handles:
            h.remove()
    return total


def check_against_cpu(trainer, batch: dict) -> None:
    """The trained model and the targets on the card against the same model
    and batch on the CPU, on one sample (the CPU path is held to the JAX
    package by tests/test_torch_*.py)."""
    import copy

    from pixelspointspolygons_torch.models.hisup.model import encode_targets

    small = {k: v[:1] for k, v in batch.items()}
    cpu_batch = {k: v.cpu() for k, v in small.items()}
    t_gpu = encode_targets(small, S)
    t_cpu = encode_targets(cpu_batch, S)
    for k in ("jloc", "joff"):
        if not torch.equal(t_gpu[k].cpu(), t_cpu[k]):
            fail(f"encode_targets {k} differs between card and CPU")
    afm_err = float((t_gpu["afmap"].cpu() - t_cpu["afmap"]).abs().max())

    model = trainer.state.model.eval()
    cpu_model = copy.deepcopy(model).cpu().eval()
    with torch.no_grad():
        out_gpu = model({"images": small["images"]})
        out_cpu = cpu_model({"images": cpu_batch["images"]})
    worst = 0.0
    for k, v in out_cpu.items():
        g = out_gpu[k].cpu()
        if g.shape != v.shape or not torch.isfinite(g).all():
            fail(f"model output {k}: shape {tuple(g.shape)} or non-finite values")
        worst = max(worst, float((g - v).abs().max() / v.abs().max().clamp(min=1e-6)))
    # float32 on both sides with TF32 off; cuDNN and the CPU sum convolutions
    # in different orders, through HRNet's ~100 layers: 1e-3 relative
    print(f"card vs CPU: afmap max abs err {afm_err:.3g} (tol 1e-5), model outputs max rel err {worst:.3g} (tol 1e-3)",
          flush=True)
    if not afm_err <= 1e-5:
        fail(f"afmap differs between card and CPU by {afm_err}")
    if not worst <= 1e-3:
        fail(f"model output differs between card and CPU by {worst} (relative)")


def phase_predict(cfg_overrides: list[str], dtype: str = "float32") -> dict:
    """The test split predicted at `dtype` from the training's `latest`
    checkpoint and evaluated, through the functions `cli/predict.py::main`
    calls; at float32 also the maps against the CPU's and the host stage
    on the ground truth."""
    from pixelspointspolygons_torch.cli.evaluate import evaluate
    from pixelspointspolygons_torch.cli.predict import get_predictor
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.utils.coco import CocoIndex

    cfg = compose(cfg_overrides + [f"host.compute_dtype={dtype}", "evaluation=test", "checkpoint=latest"])
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    predictor = get_predictor(cfg)
    pred_file = predictor.predict_dataset(cfg.evaluation.split)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = evaluate(cfg, pred_file)
    t2 = time.perf_counter()
    launches = afm_cuda.launches
    if predictor.device.type != CARD.type or predictor.model.compute_dtype != getattr(torch, dtype):
        fail(f"the predictor ran on {predictor.device} in {predictor.model.compute_dtype}")
    if launches:
        fail(f"the predict path ({dtype}) launched the afm kernel {launches} times, expected 0")

    try:
        with open(pred_file) as f:
            anns = json.load(f)
        with open(pred_file.replace(".json", "_time.json")) as f:
            timing = json.load(f)
    except (OSError, ValueError) as e:
        fail(f"prediction file {pred_file}: {e}")
    test_ids = set(CocoIndex(cfg.experiment.dataset.annotations["test"]).imgs)
    if timing["num_images"] != TEST_TILES or len(test_ids) != TEST_TILES:
        fail(f"predicted {timing['num_images']} of {len(test_ids)} test tiles, expected {TEST_TILES}")
    if not {a["image_id"] for a in anns} <= test_ids:
        fail("the prediction file holds image ids outside the test split")
    bad = [k for k in ("IoU", "C-IoU", "AP") if not np.isfinite(results.get(k, np.nan))]
    if bad:
        fail(f"non-finite metrics {bad}: {results}")

    times = predictor.batch_times
    device = [t["device_ms"] for t in times]
    host = [t["host_ms"] for t in times]
    walls = [t["wall_ms"] for t in times]
    tiles_s = 1.0 / timing["prediction_time"]
    print(f"predict path ({dtype}): {TEST_TILES} tiles in {len(times)} batches of {B}, {tiles_s:.2f} tiles/s "
          f"(the predictor's own s/tile over its loop); set-up, loop and file {(t1 - t0):.2f} s, "
          f"evaluation {(t2 - t1):.2f} s; {len(anns)} polygons; afm launches {launches}", flush=True)
    for i, t in enumerate(times):
        print(f"  batch {i}: device {t['device_ms']:.2f} ms (forward + junction extraction, CUDA events), "
              f"host stage {t['host_ms']:.2f} ms, wall {t['wall_ms']:.2f} ms", flush=True)
    print(f"  sums: device {sum(device):.1f} ms, host stage {sum(host):.1f} ms, wall {sum(walls):.1f} ms "
          f"(device + host stage in series would be {sum(device) + sum(host):.1f} ms)", flush=True)
    print(f"metrics ({dtype}): " + json.dumps(results), flush=True)
    out = {"tiles_s": tiles_s, "device_ms": device, "host_ms": host, "wall_ms": walls,
           "n_polygons": len(anns), "results": results, "launches": launches}
    if dtype == "float32":
        check_maps_against_cpu(cfg, predictor)
        out.update(phase_oracle(cfg, predictor))
        predict_repeat("hisup_image", predictor)
    return out


def check_maps_against_cpu(cfg, predictor) -> None:
    """MAP_TILES tiles' probability maps on the card against the same model
    on the CPU; then the junction candidates of the card's maps, extracted
    on the card and on the CPU, must be the same pixels."""
    import copy

    from pixelspointspolygons_torch.data.loader import build_loader, to_device
    from pixelspointspolygons_torch.models.hisup.model import extract_junctions

    batch = {k: v[:MAP_TILES] for k, v in next(iter(build_loader(cfg, "test", eval_mode=True))).items()}

    def maps(model, device):
        with torch.inference_mode():
            out = model.eval()(to_device(batch, device, ("images",)))
            return {
                "remask": torch.softmax(out["remask"], dim=1)[:, 1],
                "jloc": torch.softmax(out["jloc"], dim=1),
                "joff": torch.sigmoid(out["joff"]) - 0.5,
            }

    card = maps(predictor.model, torch.device("cuda"))
    t = time.perf_counter()
    cpu = maps(copy.deepcopy(predictor.model).cpu(), torch.device("cpu"))
    cpu_s = time.perf_counter() - t
    errs = {k: float((card[k].cpu() - v).abs().max()) for k, v in cpu.items()}
    print(f"card vs CPU on {MAP_TILES} tiles of a test batch (CPU forward {cpu_s:.1f} s): max abs err {errs} "
          f"(tol {MAP_TOL})",
          flush=True)
    if not all(e <= MAP_TOL for e in errs.values()):
        fail(f"the card's maps differ from the CPU's: {errs}")

    k, th = predictor.junc_topk, predictor.junc_threshold
    zero = torch.zeros_like(card["joff"])  # then a point is its pixel's centre
    got = extract_junctions(card["jloc"], zero, topk=k, th=th)
    want = extract_junctions(card["jloc"].cpu(), zero.cpu(), topk=k, th=th)
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    pts = extract_junctions(card["jloc"], card["joff"], topk=k, th=th)[0]
    pts_cpu = extract_junctions(card["jloc"].cpu(), card["joff"].cpu(), topk=k, th=th)[0]
    pts_err = float((pts.cpu() - pts_cpu).abs().max())
    scores = got[1].cpu()
    ties = int(sum(len(r[r > 0]) - len(torch.unique(r[r > 0])) for r in scores))
    print(f"junction candidates of the card's maps, card vs CPU: same pixels {same} "
          f"({scores.shape[1]} per tile, {ties} tied nonzero scores), points max abs err {pts_err:.3g} (tol 1e-6)",
          flush=True)
    if not same or not pts_err <= 1e-6:
        fail("extract_junctions picks other pixels on the card than on the CPU")


def phase_oracle(cfg, predictor) -> dict:
    """The host stage alone on the test tiles' ground-truth masks and
    corners: what polygonizing building shapes costs, which a 4-step
    model's masks do not show."""
    from pixelspointspolygons_torch.data.loader import build_loader
    from pixelspointspolygons_torch.eval.metrics import compute_iou_ciou
    from pixelspointspolygons_torch.predict.predictor_hisup import batch_annotations
    from pixelspointspolygons_torch.utils.coco import CocoIndex

    anns, ms = [], []
    for batch in build_loader(cfg, "test", eval_mode=True):
        arrays = (batch["mask"].astype(np.float32), batch["junctions"].astype(np.float32),
                  batch["junc_valid"].astype(np.float32))
        t = time.perf_counter()
        polys, scores = predictor._host_stage(arrays)
        ms.append((time.perf_counter() - t) * 1e3)
        anns.extend(batch_annotations(batch, polys, scores))
    gt = CocoIndex(cfg.experiment.dataset.annotations["test"])
    iou = compute_iou_ciou(gt, gt.load_res(anns))
    print(f"host stage on the ground truth: {[round(x, 2) for x in ms]} ms per batch of {B} "
          f"({sum(ms) / TEST_TILES:.2f} ms per tile), {len(anns)} polygons for {len(gt.anns)} buildings, "
          f"IoU {iou['IoU']:.4f} C-IoU {iou['C-IoU']:.4f} (IoU at least {ORACLE_MIN_IOU})", flush=True)
    if not iou["IoU"] >= ORACLE_MIN_IOU:
        fail(f"polygonizing the ground truth gave IoU {iou['IoU']}")
    return {"oracle_host_ms": ms, "oracle_iou": iou["IoU"]}


def ffl_oracle_maps(polygons: list, size: int) -> tuple[np.ndarray, np.ndarray]:
    """FFL maps that the ground truth of one tile implies: seg (1, S, S) the
    buildings' mask (rasterized as the dataset's masks are) blurred as
    tests/test_ffl.py blurs its square (7x7, sigma 2); crossfield (4, S, S)
    from each building's frame, u along its first edge as the complex
    direction dy + i dx (the polygonizer's (y, x) convention) and v = i u,
    and the axis-aligned frame (u = 1, v = i) on the background. The
    synthetic buildings are rectangles and L-shapes rotated as a whole, so
    one frame fits every edge of a building; the first edge that is not cut
    along the tile's border by the clipping gives it."""
    import cv2

    from pixelspointspolygons_torch.ops.crossfield import uv_to_c0c2
    from pixelspointspolygons_torch.utils.coco import seg_to_mask

    mask = np.zeros((size, size), np.float32)
    u = np.full((size, size), 1.0 + 0.0j, np.complex64)
    for poly in polygons:
        poly = np.asarray(poly, np.float64).reshape(-1, 2)  # (x, y)
        inside = seg_to_mask([poly.ravel().tolist()], size, size) > 0
        mask[inside] = 1.0
        for a, b in zip(poly, np.roll(poly, -1, axis=0)):
            on_border = [(a[k] == b[k]) and (a[k] <= 0 or a[k] >= size - 1) for k in (0, 1)]
            if math.hypot(*(b - a)) >= 1.0 and not any(on_border):
                dx, dy = b - a
                u[inside] = complex(dy, dx) / math.hypot(dx, dy)
                break
    seg = cv2.GaussianBlur(mask, (7, 7), 2.0)
    u_t = torch.from_numpy(u)
    c0, c2 = uv_to_c0c2(u_t, 1j * u_t)
    return seg[None], torch.stack([c0.real, c0.imag, c2.real, c2.imag]).numpy()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the largest |want|."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"shape {tuple(got.shape)} against {tuple(want.shape)}, or non-finite values")
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def phase_pix2poly(overrides: list[str], device: str = "cuda") -> dict:
    """Pix2Poly-image prediction at full width from a seeded random model,
    through the functions `cli/predict.py::main` calls, then its checks."""
    from pixelspointspolygons_torch.cli.evaluate import evaluate
    from pixelspointspolygons_torch.cli.predict import get_predictor
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import build_loader, to_device
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer, build_pix2poly
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.train.state import TrainState, linear_warmup_decay, make_optimizer, make_scheduler
    from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager
    from pixelspointspolygons_torch.utils.coco import CocoIndex

    dev = torch.device(device)
    cfg = compose(overrides + ["evaluation=test", "checkpoint=latest"])
    tokenizer = Tokenizer(cfg)
    model = build_pix2poly(cfg, tokenizer, device=dev, generator=torch.Generator(device=dev).manual_seed(P2P_SEED))
    lr = float(cfg.experiment.model.learning_rate)
    opt = make_optimizer("adamw", model.parameters(), lr)
    CheckpointManager(cfg.output_dir).save(
        "latest", TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(lr, 1000), lr)), 0, cfg
    )
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt

    afm_cuda.launches = 0
    t0 = time.perf_counter()
    predictor = get_predictor(cfg, dev)
    pred_file = predictor.predict_dataset(cfg.evaluation.split)
    sync(dev)
    t1 = time.perf_counter()
    results = evaluate(cfg, pred_file)
    t2 = time.perf_counter()
    launches = afm_cuda.launches
    if predictor.device.type != dev.type:
        fail(f"the Pix2Poly predictor ran on {predictor.device}")
    if launches:
        fail(f"the Pix2Poly predict path launched the afm kernel {launches} times, expected 0")
    try:
        with open(pred_file) as f:
            anns = json.load(f)
        with open(pred_file.replace(".json", "_time.json")) as f:
            timing = json.load(f)
    except (OSError, ValueError) as e:
        fail(f"Pix2Poly prediction file {pred_file}: {e}")
    test_ids = set(CocoIndex(cfg.experiment.dataset.annotations["test"]).imgs)
    if timing["num_images"] != len(test_ids):
        fail(f"Pix2Poly predicted {timing['num_images']} of {len(test_ids)} test tiles")
    if not {a["image_id"] for a in anns} <= test_ids:
        fail("the Pix2Poly prediction file holds image ids outside the test split")
    bad = [k for k in ("IoU", "C-IoU", "AP") if not np.isfinite(results.get(k, np.nan))]
    if bad:
        fail(f"Pix2Poly: non-finite metrics {bad}: {results}")

    times = predictor.batch_times
    tiles_s = 1.0 / timing["prediction_time"]
    print(f"pix2poly predict path: {timing['num_images']} tiles in {len(times)} batches, {tiles_s:.2f} tiles/s "
          f"(the predictor's own s/tile over its loop), {n_params} parameters; set-up, loop and file "
          f"{t1 - t0:.2f} s, evaluation {t2 - t1:.2f} s; {len(anns)} polygons; afm launches {launches}", flush=True)
    for i, t in enumerate(times):
        if dev.type == "cuda":
            print(f"  batch {i}: device {t['device_ms']:.2f} ms = encoder {t['encoder_ms']:.2f} + decode loop "
                  f"{t['decode_ms']:.2f} ({t['steps']} steps, {t['decode_ms'] / t['steps']:.3f} ms/step) + ScoreNets "
                  f"{t['scorenet_ms']:.2f} (CUDA events); decode loop host {t['decode_host_ms']:.2f} ms; "
                  f"host stage {t['host_ms']:.2f} ms; wall {t['wall_ms']:.2f} ms", flush=True)
    print("pix2poly metrics: " + json.dumps(results), flush=True)
    if dev.type == "cuda":
        predict_repeat("p2p_image", predictor)

    batch = next(iter(build_loader(cfg, "test", tokenizer=tokenizer, eval_mode=True)))
    inputs = to_device(batch, dev, ("images",))
    fixed = p2p_fixed_length(predictor.model, inputs, tokenizer, dev)
    few = {"images": inputs["images"][:P2P_CPU_TILES]}
    p2p_card_against_cpu(predictor.model, few, tokenizer, "the checkpoint's model", P2P_REL_TOL)
    varied = p2p_varied(predictor.model)
    p2p_card_against_cpu(varied, few, tokenizer, "its varied copy", None)
    exits = p2p_early_exit(varied, inputs, tokenizer)
    return {"tiles_s": tiles_s, "batch_times": times, "results": results, "fixed": fixed, "exit_stops": exits}


def p2p_varied(model, sharpen: float = P2P_SHARPEN):
    """A copy of `model` whose greedy decode varies with the position and
    the image. At flax's init (embeddings of std 1/16 and 0.02) every
    decoder position sees nearly the same input, and cross-attention
    averages over the 784 image tokens, so the decode repeats one or two
    tokens and every tile gets the same sequence. The copy redraws the token
    and position embeddings at unit scale from a seed and sharpens the
    cross-attention (its q and k weights times `sharpen`), so the token
    checks compare many different argmaxes and rows stop at different
    steps."""
    import copy

    m = copy.deepcopy(model).eval()
    dev = m.bin_score.device
    g = torch.Generator(device=dev).manual_seed(P2P_SEED + 1)
    with torch.no_grad():
        for p in (m.decoder.embedding.weight, m.decoder.decoder_pos_embed, m.decoder.encoder_pos_embed):
            p.copy_(torch.randn(p.shape, generator=g, device=dev))
        for layer in m.decoder.layers():
            layer.cross_attn.q.weight.mul_(sharpen)
            layer.cross_attn.k.weight.mul_(sharpen)
    return m


def p2p_chain(model, tokenizer):
    """A copy of `model` whose greedy decode walks one cycle through every
    coordinate token, for the bfloat16 token check. Sharpened attention
    (`p2p_varied`) varies the decode at float32, but at bfloat16 an ulp of
    its large logits moves the attention itself, and unsharpened a random
    model repeats a few tokens and its flat logits tie within tens of steps.
    Here, after `p2p_varied`'s unit-scale embeddings, the output projection
    reads the input token's own direction: row j sums the unit embeddings
    of the tokens whose successor is j, on a cycle through the coordinate
    tokens drawn from a seed (BOS, EOS and PAD lead to its start). Each
    layer's three sublayers are scaled by P2P_BF16_SUBLAYER, and the
    position embeddings by the same, so that the embedding of the input
    token sets the argmax by a clear margin while attention, the image and
    the cache still move the logits."""
    m = p2p_varied(model, sharpen=1.0)
    dec = m.decoder
    emb = dec.embedding.weight
    special = {tokenizer.BOS_code, tokenizer.EOS_code, tokenizer.PAD_code}
    coords = [t for t in range(emb.shape[0]) if t not in special]
    perm = torch.randperm(len(coords), generator=torch.Generator().manual_seed(P2P_SEED + 2)).tolist()
    order = [coords[i] for i in perm]
    succ = torch.full((emb.shape[0],), order[0], dtype=torch.long)
    succ[order] = torch.tensor(order[1:] + order[:1])
    with torch.no_grad():
        for layer in dec.layers():
            for lin in (layer.self_attn.o, layer.cross_attn.o, layer.ffn.dense1):
                lin.weight.mul_(P2P_BF16_SUBLAYER)
                lin.bias.mul_(P2P_BF16_SUBLAYER)
        dec.decoder_pos_embed.mul_(P2P_BF16_SUBLAYER)
        w = torch.zeros_like(dec.output.weight)
        w.index_add_(0, succ.to(w.device), emb / emb.norm(dim=1, keepdim=True))
        dec.output.weight.copy_(w)
        dec.output.bias.zero_()
    return m


def p2p_fixed_length(model, inputs: dict, tokenizer, dev: torch.device, rounds: int = 1, what: str = "") -> dict:
    """The fixed-length decode of `bench.py` (eos_code=None, Sinkhorn
    permutation) on one batch: tiles/s as the median of `rounds` calls of
    `greedy_generate`, synchronized at both ends; then one run cut at its
    stages by CUDA events, whose tokens and permutation must equal the
    call's."""
    from pixelspointspolygons_torch.models.pix2poly import greedy_decode, greedy_generate
    from pixelspointspolygons_torch.models.pix2poly.model import _greedy_decode
    from pixelspointspolygons_torch.ops.sinkhorn import log_optimal_transport

    steps = model.max_len - 1
    n = inputs["images"].shape[0]
    walls = []
    with torch.inference_mode():
        for _ in range(rounds):
            sync(dev)
            t = time.perf_counter()
            tokens, perm = greedy_generate(model, inputs, tokenizer.BOS_code, steps)
            sync(dev)
            walls.append(time.perf_counter() - t)
        if dev.type != "cuda":
            return {"tiles_s": n / statistics.median(walls)}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        enc = model.encode(inputs)
        ev[1].record()
        t = time.perf_counter()
        tok2, feats, ran = greedy_decode(model, enc, tokenizer.BOS_code, steps)
        host_ms = (time.perf_counter() - t) * 1e3
        ev[2].record()
        scores = model.raw_scores_from_feats(feats)
        ev[3].record()
        V = scores.shape[1]
        perm2 = torch.softmax(log_optimal_transport(scores, model.bin_score, model.sinkhorn_iterations)[:, :V, :V], -1)
        ev[4].record()
        torch.cuda.synchronize()
        short = min(steps, P2P_GRAPH_CHECK_STEPS)
        graphed = greedy_decode(model, enc, tokenizer.BOS_code, short)
        looped = _greedy_decode(model, enc, tokenizer.BOS_code, short, None, capture=False)
    if not torch.equal(tok2, tokens) or not float((perm2 - perm).abs().max()) <= 1e-6:
        fail("the staged fixed-length decode differs from greedy_generate's")
    if not all(same_bits(a, b) for a, b in zip(graphed[:2], looped[:2])) or graphed[2] != looped[2]:
        fail(f"the fixed-length decode replayed from its CUDA graph differs from its step run as it is over {short} "
             f"steps")
    print(f"pix2poly fixed-length decode{what}: the steps replayed from one CUDA graph bitwise equal to the step run "
          f"as it is over {short} steps (tokens and feats)", flush=True)
    names = ("encoder", "decode", "scorenets", "sinkhorn")
    ms = {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(names)}
    out = {"tiles_s": n / statistics.median(walls), "walls_ms": [w * 1e3 for w in walls], "steps": ran,
           "decode_host_ms": host_ms, "ms_per_step": ms["decode"] / ran, **{f"{k}_ms": v for k, v in ms.items()}}
    print(f"pix2poly fixed-length decode{what} (bench.py's mode) on a batch of {n}: {out['tiles_s']:.2f} tiles/s "
          f"(median of {rounds}: {[round(w * 1e3, 1) for w in walls]} ms); one run cut by CUDA events: encoder "
          f"{ms['encoder']:.2f} ms, decode loop {ms['decode']:.2f} ms for {ran} steps ({out['ms_per_step']:.3f} ms/step; "
          f"host {host_ms:.2f} ms), ScoreNets {ms['scorenets']:.2f} ms, Sinkhorn ({model.sinkhorn_iterations} "
          f"iterations) {ms['sinkhorn']:.2f} ms", flush=True)
    out.update(p2p_decode_profile(model, enc, tokenizer, what))
    return out


def p2p_decode_profile(model, enc: torch.Tensor, tokenizer, what: str = "") -> dict:
    """What one step of the decode costs, as `greedy_decode` runs it on the
    card (each step after the first replayed from its CUDA graph): the
    step's time unprofiled (host clock, synchronized), from decodes of 8
    and up to 264 steps (their difference, medians of 3, so the set-up and
    the capture, whose time varies by more than 16 steps, drop out); from
    torch.profiler traces of decodes of 8 and 24 steps the kernels recorded
    and their summed device time, whose share of the unprofiled step is the
    device's busy share; and from traces of the same step run as it is (the
    operations the graph holds) the host's top-level aten calls a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pixelspointspolygons_torch.models.pix2poly import greedy_decode
    from pixelspointspolygons_torch.models.pix2poly.model import _greedy_decode

    far = min(264, model.max_len - 1)
    walls = {8: [], far: []}
    with torch.inference_mode():
        greedy_decode(model, enc, tokenizer.BOS_code, 8)  # warm-up
        for _ in range(3):
            for steps in walls:
                torch.cuda.synchronize()
                t = time.perf_counter()
                greedy_decode(model, enc, tokenizer.BOS_code, steps)
                torch.cuda.synchronize()
                walls[steps].append(time.perf_counter() - t)
    ms_per_step = (statistics.median(walls[far]) - statistics.median(walls[8])) * 1e3 / (far - 8)

    def traced(capture: bool) -> list[float]:
        counts = []
        for steps in (8, 24):
            with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _greedy_decode(model, enc, tokenizer.BOS_code, steps, None, capture=capture)
                torch.cuda.synchronize()
            events = prof.events()
            aten = [e for e in events if e.name.startswith("aten::")
                    and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
            kernels = [e for e in events if e.device_type == DeviceType.CUDA]
            counts.append((len(aten), len(kernels), sum(e.time_range.elapsed_us() for e in kernels)))
        return [(b - a) / 16 for a, b in zip(*counts)]

    replayed, as_is = traced(True), traced(False)
    out = {"aten_per_step": as_is[0], "kernels_per_step": replayed[1], "kernel_us_per_step": replayed[2],
           "replayed_aten_per_step": replayed[0], "profiled_step_ms": ms_per_step}
    if replayed[1] <= 0:
        print("pix2poly decode step profile: the profiler recorded no device kernels (busy share not measured)",
              flush=True)
        return out
    out["busy_share"] = replayed[2] / (ms_per_step * 1e3)
    print(f"pix2poly decode step profile{what} (torch.profiler, steps 8..24): the step holds {as_is[0]:.1f} "
          f"top-level aten calls; replayed from its graph, {replayed[0]:.1f} aten calls and {replayed[1]:.1f} kernels "
          f"per step, {replayed[2]:.1f} us of kernel time per step: the card is busy "
          f"{100 * out['busy_share']:.1f} % of this model's {ms_per_step:.3f} ms step (unprofiled, steps 8..{far}, "
          f"medians of 3)", flush=True)
    return out


def p2p_card_against_cpu(model, inputs: dict, tokenizer, what: str, logits_tol: float | None) -> None:
    """On a few tiles: the model on the card against a copy on the CPU
    (encoder tokens, teacher-forced logits, raw scores of the same feats),
    and the KV-cached decode against a full re-forward. Teacher-forcing
    the decode's own tokens makes each position's argmax the one that the
    chain of full re-forwards would take, as long as the chain has agreed so
    far (the decoder is causal), so one forward checks the whole chain.
    Positions after the first generated PAD are left out of the token
    checks: there the full forward masks the PAD input and the cache does
    not. `logits_tol=None` prints the logits' error without holding it to a
    tolerance: in `p2p_varied`'s sharpened copy a few positions split their
    attention between nearly tied image tokens, where the rounding of the
    two devices moves the logits by more than in the model itself; the
    argmax checks still hold there, outside near-ties."""
    import copy

    from pixelspointspolygons_torch.models.pix2poly import greedy_decode

    steps = model.max_len - 1
    cpu_model = copy.deepcopy(model).cpu().eval()
    t = time.perf_counter()
    with torch.inference_mode():
        enc = model.encode(inputs)
        enc_cpu = cpu_model.encode({"images": inputs["images"].cpu()})
        tokens, feats, _ = greedy_decode(model, enc, tokenizer.BOS_code, steps)
        bos = torch.full_like(tokens[:, :1], tokenizer.BOS_code)
        tgt = torch.cat([bos, tokens[:, :-1]], dim=1)
        logits, _ = model.decoder(enc, tgt)
        logits_cpu, _ = cpu_model.decoder(enc_cpu, tgt.cpu())
        scores = model.raw_scores_from_feats(feats)
        scores_cpu = cpu_model.raw_scores_from_feats(feats.cpu())
    cpu_s = time.perf_counter() - t
    errs = {"encoder": rel_err(enc, enc_cpu), "logits": rel_err(logits, logits_cpu), "raw scores": rel_err(scores, scores_cpu)}
    tokens = tokens.cpu()
    is_pad = tokens == tokenizer.PAD_code
    first_pad = torch.where(is_pad.any(1), is_pad.float().argmax(1), torch.full_like(tokens[:, 0], steps))
    valid = torch.arange(steps)[None] <= first_pad[:, None]

    def against_tokens(lg):
        top2 = lg.float().cpu().topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1] > P2P_NEAR_TIE) & valid
        wrong = (lg.cpu().argmax(-1) != tokens) & clear
        return int(wrong.sum()), int((valid & ~clear).sum())

    cpu_wrong, cpu_ties = against_tokens(logits_cpu)
    kv_wrong, kv_ties = against_tokens(logits)
    tols = {"encoder": P2P_REL_TOL, "logits": logits_tol, "raw scores": P2P_REL_TOL}
    print(f"pix2poly card vs CPU, {what}, on {tokens.shape[0]} tiles (CPU {cpu_s:.1f} s): max rel err {errs} "
          f"(tol {tols}); CPU argmax against the card's tokens: {cpu_wrong} differ at {int(valid.sum())} positions "
          f"compared, {cpu_ties} near-ties (top-2 gap <= {P2P_NEAR_TIE}); {len(torch.unique(tokens))} distinct tokens",
          flush=True)
    print(f"pix2poly KV-cached decode vs full re-forward on the card, {what}: {kv_wrong} tokens differ, "
          f"{kv_ties} near-ties", flush=True)
    if not all(tol is None or errs[k] <= tol for k, tol in tols.items()):
        fail(f"Pix2Poly on the card differs from the CPU ({what}): {errs}")
    if cpu_wrong:
        fail(f"the CPU's teacher-forced argmax differs from the card's tokens at {cpu_wrong} positions")
    if kv_wrong:
        fail(f"the KV-cached decode differs from the full re-forward at {kv_wrong} positions")


def p2p_early_exit(model, inputs: dict, tokenizer) -> list[int]:
    """The early exit against the fixed length on the card, with a copy of
    the model whose EOS output bias is raised just enough that every row
    emits EOS by step P2P_EXIT_BY (rows stop where their gap between the top
    logit and EOS's first falls below the raise, so at different steps):
    tokens equal up to each row's EOS and PAD after it, the raw scores over
    the vertices decoded before EOS within 1e-4, and fewer steps run."""
    import copy

    from pixelspointspolygons_torch.models.pix2poly import greedy_decode
    from pixelspointspolygons_torch.models.pix2poly.model import _greedy_decode

    bos, eos, pad = tokenizer.BOS_code, tokenizer.EOS_code, tokenizer.PAD_code
    steps = model.max_len - 1
    m = copy.deepcopy(model).eval()
    with torch.inference_mode():
        enc = m.encode(inputs)
        _, feats, _ = greedy_decode(m, enc, bos, steps)
        logits = m.decoder.output(feats)
        gap = logits.max(dim=-1).values - logits[..., eos]
        m.decoder.output.bias[eos] += float(gap[:, :P2P_EXIT_BY].min(dim=1).values.max()) + 1e-3
        ref_tokens, ref_feats, _ = greedy_decode(m, enc, bos, steps)
        t = time.perf_counter()
        tokens, feats, ran = greedy_decode(m, enc, bos, steps, eos_code=eos)
        sync(enc.device)
        exit_ms = (time.perf_counter() - t) * 1e3
        loop = _greedy_decode(m, enc, bos, steps, eos, capture=False)
    if enc.device.type == "cuda" and not (same_bits(loop[0], tokens) and same_bits(loop[1], feats) and loop[2] == ran):
        fail(f"early exit: the decode replayed from its CUDA graph differs from its step run as it is (steps {ran} "
             f"and {loop[2]})")
    with torch.inference_mode():
        ref_scores = m.raw_scores_from_feats(ref_feats).cpu()
        scores = m.raw_scores_from_feats(feats).cpu()
    ref_tokens, tokens = ref_tokens.cpu(), tokens.cpu()
    has = (ref_tokens == eos).any(1)
    stops = torch.where(has, (ref_tokens == eos).float().argmax(1) + 1, torch.full_like(has, steps, dtype=torch.long))
    worst = 0.0
    for b, stop in enumerate(stops.tolist()):
        if not torch.equal(tokens[b, :stop], ref_tokens[b, :stop]) or not (tokens[b, stop:] == pad).all():
            fail(f"early exit: row {b} differs from the fixed-length decode before its EOS at step {stop}")
        nv = (stop - 1) // 2
        if nv:
            worst = max(worst, float((scores[b, :nv, :nv] - ref_scores[b, :nv, :nv]).abs().max()))
    print(f"pix2poly early exit vs fixed length (EOS bias raised): rows stop at steps {stops.tolist()}, "
          f"the loop ran {ran} of {steps} steps in {exit_ms:.1f} ms (host clock); raw scores over the decoded "
          f"vertices max abs err {worst:.3g} (tol 1e-4)", flush=True)
    if not worst <= 1e-4:
        fail(f"early exit: raw scores differ from the fixed length by {worst}")
    if len(set(stops.tolist())) < 2 or not ran < steps:
        fail(f"early exit: the rows did not stop at different steps before the end ({stops.tolist()}, ran {ran})")
    return stops.tolist()


def phase_p2p_train(overrides: list[str], dtype: str, steps: int = TRAIN_STEPS, name: str = "pix2poly",
                    after_setup=None, card_against_cpu: bool = True) -> dict:
    """Pix2Poly-image training at full width through the trainer that
    `cli/train.py` builds, at `dtype`: `steps` train + 1 val steps and the
    val-IoU pass with the kernel counters set to 0 just before and read just
    after, then the steady-state step, its parts and (float32, with
    `card_against_cpu`) the card against the CPU. `after_setup(trainer)`
    runs between the trainer's set-up and its first step; `name` heads the
    lines."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.train.trainer_pix2poly import _DEV_KEYS, Pix2PolyTrainer

    cfg = compose(overrides + [f"host.compute_dtype={dtype}"])
    trainer = Pix2PolyTrainer(cfg, device=CARD)
    iou_pass_s, step_losses = [], []
    record_steps(trainer, step_losses, iou_pass_s)
    if after_setup is not None:
        def set_up(run=trainer.setup):
            run()
            after_setup(trainer)
        trainer.setup = set_up
    torch.cuda.reset_peak_memory_stats()
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = afm_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    n_train, n_val = len(trainer.train_loader), len(trainer.val_loader)
    model = trainer.state.model
    print(f"{name} train path ({dtype}): {n_train} train + {n_val} val steps and the val-IoU pass in {wall:.1f} s "
          f"(set-up included), peak memory {peak / 2**30:.2f} GiB; afm launches {launches}; model computes in "
          f"{model.compute_dtype}, parameters {next(model.parameters()).dtype}", flush=True)
    print(f"{name} history ({dtype}): " + json.dumps(history), flush=True)
    print(f"{name} step losses ({dtype}): " + json.dumps([{k: float(v) for k, v in m.items()} for m in step_losses]),
          flush=True)
    if (n_train, n_val) != (steps, VAL_STEPS) or len(step_losses) != n_train:
        fail(f"{name}: expected {steps} train and {VAL_STEPS} val steps, got {n_train}, {n_val}, "
             f"{len(step_losses)}")
    if not all(np.isfinite(v) for k, v in history.items() if k != "epoch"):
        fail(f"{name} ({dtype}): non-finite losses: {history}")
    if launches:
        fail(f"the Pix2Poly train path launched the afm kernel {launches} times, expected 0")
    if model.compute_dtype != getattr(torch, dtype) or next(model.parameters()).dtype != torch.float32:
        fail(f"{name} ({dtype}): the model computes in {model.compute_dtype}")
    if not trainer.manager.exists("latest") or not trainer.manager.exists("best_val_loss"):
        fail("the Pix2Poly trainer wrote no latest/best_val_loss checkpoint")
    val_iou = history.get("val_iou")
    if val_iou is None or not 0.0 <= val_iou <= 1.0 or len(iou_pass_s) != 1:
        fail(f"the Pix2Poly val-IoU pass gave no IoU in [0, 1]: {val_iou}")
    print(f"{name} val-IoU pass ({dtype}): {n_val * B} val tiles decoded and scored in {iou_pass_s[0] * 1e3:.1f} ms "
          f"(wall), val IoU {val_iou:.4f}", flush=True)

    # steady state on the same batches (not part of the counted run)
    losses = [{k: float(v) for k, v in m.items()} for m in step_losses]
    host = list(trainer.train_loader)
    batches = list(device_prefetch(host, trainer.device, _DEV_KEYS))
    trainer._train_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    times = []
    for batch in batches:
        t = time.perf_counter()
        trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    t = time.perf_counter()
    trainer._val_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t) * 1e3
    parts = [p2p_step_parts(trainer, batch) for batch in batches]
    breakdown = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    print(f"{name} train step ({dtype}) {step_ms:.1f} ms (median of {len(times)}: {[round(x, 1) for x in times]}), "
          f"val step {val_ms:.1f} ms", flush=True)
    print(f"{name} train step ({dtype}) by layer (ms, CUDA events, median of {len(parts)}): {json.dumps(breakdown)}",
          flush=True)
    out = {"step_ms": step_ms, "val_ms": val_ms, "peak_bytes": peak, "iou_pass_ms": iou_pass_s[0] * 1e3,
           "val_iou": val_iou, "losses": losses, "breakdown": breakdown, "launches": launches,
           "output_dir": cfg.output_dir}
    if dtype == "float32" and card_against_cpu:
        p2p_train_card_against_cpu(trainer, batches[0])
    if name == "pix2poly":
        train_twice(f"p2p_image_{dtype}", trainer, batches, (trainer.generator,),
                    {"afm": False, "pillar_sums": False, "run_sums": False})
    return out


def p2p_step_parts(trainer, batch: dict) -> dict:
    """One Pix2Poly train step cut at its layers by CUDA events on the
    stream, with the calls of train/pix2poly_step.py (Pix2Poly.forward is
    the encoder, the decoder and perm_from_feats); then the Sinkhorn's
    forward and backward alone on the step's scores."""
    from pixelspointspolygons_torch.models.layers import widen
    from pixelspointspolygons_torch.ops.sinkhorn import log_optimal_transport
    from pixelspointspolygons_torch.train.pix2poly_step import model_inputs, perm_bce_loss, token_ce_loss

    state, model, m = trainer.state, trainer.state.model, trainer.cfg.experiment.model
    vw, pw, pad = float(m.vertex_loss_weight), float(m.perm_loss_weight), trainer.tokenizer.PAD_code
    y = batch["y"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(10)]
    model.train()
    ev[0].record()
    enc = model.encode(model_inputs(batch))
    ev[1].record()
    logits, feats = model.decoder(enc, y[:, :-1])
    ev[2].record()
    scores = model.raw_scores_from_feats(feats)
    ev[3].record()
    V = scores.shape[1]
    iters = model.sinkhorn_iterations
    perm = torch.softmax(log_optimal_transport(scores.to(widen(scores.dtype)), model.bin_score, iters)[:, :V, :V], -1)
    ev[4].record()
    total = vw * token_ce_loss(logits, y[:, 1:], pad) + pw * perm_bce_loss(perm, batch["y_perm"])
    ev[5].record()
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    ev[6].record()
    state.optimizer.step()
    ev[7].record()
    s = scores.detach().float().requires_grad_()
    z = log_optimal_transport(s, model.bin_score.detach(), iters)[:, :V, :V]
    sink = perm_bce_loss(torch.softmax(z, -1), batch["y_perm"])
    ev[8].record()
    sink.backward()
    ev[9].record()
    torch.cuda.synchronize()
    names = ("encoder", "decoder", "scorenets", "sinkhorn", "losses", "backward", "optimizer")
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["sinkhorn_alone_fwd"] = ev[7].elapsed_time(ev[8])
    out["sinkhorn_alone_bwd"] = ev[8].elapsed_time(ev[9])
    return out


def p2p_train_card_against_cpu(trainer, batch: dict) -> None:
    """One float32 train step on P2P_TRAIN_CPU_TILES tiles, on the card and
    on the CPU with fresh AdamW states, and the same loss's gradient in
    float64 on the CPU, from the trainer's initial weights (its seed): the
    losses and each float32 gradient against the exact one are held to
    bounds (the CPU path is held to the JAX package by
    tests/test_torch_train_pix2poly.py)."""
    from pixelspointspolygons_torch.models.pix2poly import build_pix2poly
    from pixelspointspolygons_torch.train.pix2poly_step import _losses, make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler

    cfg, m = trainer.cfg, trainer.cfg.experiment.model
    vw, pw, pad = float(m.vertex_loss_weight), float(m.perm_loss_weight), trainer.tokenizer.PAD_code
    lr = float(m.learning_rate)
    seed = torch.Generator(device=CARD).manual_seed(int(cfg.get("seed", 42)))
    sd = build_pix2poly(cfg, trainer.tokenizer, device=CARD, generator=seed).state_dict()
    small = {k: v[:P2P_TRAIN_CPU_TILES] for k, v in batch.items()}
    host = {k: v.cpu() for k, v in small.items()}
    step = make_train_step(vw, pw, pad)

    def state_on(sd, device, dtype=torch.float32):
        model = build_pix2poly(cfg, trainer.tokenizer, device=device, dtype=dtype).to(dtype)
        model.load_state_dict(sd)
        opt = make_optimizer("adamw", model.parameters(), lr, weight_decay=float(m.weight_decay), b2=0.95)
        return TrainState(model, opt, make_scheduler(opt, lambda n: lr, lr))

    def grads(state):
        return {n: p.grad.detach().cpu().double() for n, p in state.model.named_parameters()}

    def rel(a, b):
        return (sum(float(((a[k] - b[k]) ** 2).sum()) for k in b) / sum(float((b[k] ** 2).sum()) for k in b)) ** 0.5

    card, cpu, exact = state_on(sd, CARD), state_on(sd, torch.device("cpu")), state_on(sd, "cpu", torch.float64)
    got = step(card, small)
    t = time.perf_counter()
    want = step(cpu, host)
    _losses(exact.model.train(), {k: v.double() if v.is_floating_point() else v for k, v in host.items()},
            vw, pw, pad)["loss"].backward()
    cpu_s = time.perf_counter() - t
    loss_err = {k: abs(float(got[k]) / float(want[k]) - 1.0) for k in want}
    g_card, g_cpu, g_exact = grads(card), grads(cpu), grads(exact)
    errs = {"card vs exact": rel(g_card, g_exact), "CPU vs exact": rel(g_cpu, g_exact),
            "card vs CPU": rel(g_card, g_cpu)}
    print(f"pix2poly train step card vs CPU on {P2P_TRAIN_CPU_TILES} tiles from the initial weights (float32; CPU "
          f"float32 and float64 {cpu_s:.1f} s): losses {({k: round(float(v), 6) for k, v in want.items()})}, "
          f"rel err {loss_err}; gradients rel L2 {errs} (tol {P2P_LOSS_TOL} and {P2P_GRAD_TOL} against the exact "
          f"one)", flush=True)
    if not all(e <= P2P_LOSS_TOL for e in loss_err.values()):
        fail(f"the Pix2Poly train step's losses differ between card and CPU: {loss_err}")
    if not (errs["card vs exact"] <= P2P_GRAD_TOL and errs["CPU vs exact"] <= P2P_GRAD_TOL):
        fail(f"the Pix2Poly train step's float32 gradients stray from the exact one: {errs}")


def phase_p2p_predict_bf16(overrides: list[str]) -> dict:
    """Pix2Poly prediction at bfloat16 from the bfloat16 training's
    `latest`, through the functions `cli/predict.py::main` calls, then the
    card against the CPU, the decode step's calls against float32's, and
    bench_torch.py."""
    import bench_torch
    from pixelspointspolygons_torch.cli.evaluate import evaluate
    from pixelspointspolygons_torch.cli.predict import get_predictor
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import build_loader, to_device
    from pixelspointspolygons_torch.models.pix2poly import build_pix2poly
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    dev = CARD
    cfg = compose(overrides + ["host.compute_dtype=bfloat16", "evaluation=test", "checkpoint=latest"])
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    predictor = get_predictor(cfg, dev)
    pred_file = predictor.predict_dataset(cfg.evaluation.split)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = evaluate(cfg, pred_file)
    launches = afm_cuda.launches
    model = predictor.model
    if launches:
        fail(f"the bfloat16 Pix2Poly predict path launched the afm kernel {launches} times, expected 0")
    if model.compute_dtype != torch.bfloat16:
        fail(f"the Pix2Poly predictor computes in {model.compute_dtype}, not bfloat16")
    with open(pred_file.replace(".json", "_time.json")) as f:
        timing = json.load(f)
    if timing["num_images"] != TEST_TILES:
        fail(f"bfloat16 Pix2Poly predicted {timing['num_images']} of {TEST_TILES} test tiles")
    bad = [k for k in ("IoU", "C-IoU", "AP") if not np.isfinite(results.get(k, np.nan))]
    if bad:
        fail(f"bfloat16 Pix2Poly: non-finite metrics {bad}: {results}")
    times = predictor.batch_times
    tiles_s = 1.0 / timing["prediction_time"]
    print(f"pix2poly predict path (bfloat16): {timing['num_images']} tiles in {len(times)} batches, {tiles_s:.2f} tiles/s "
          f"(the predictor's own s/tile over its loop); set-up, loop and file {t1 - t0:.2f} s; afm launches {launches}",
          flush=True)
    for i, t in enumerate(times):
        if t["device_ms"] is not None:
            print(f"  batch {i}: device {t['device_ms']:.2f} ms = encoder {t['encoder_ms']:.2f} + decode loop "
                  f"{t['decode_ms']:.2f} ({t['steps']} steps, {t['decode_ms'] / t['steps']:.3f} ms/step) + ScoreNets "
                  f"{t['scorenet_ms']:.2f} (CUDA events); decode loop host {t['decode_host_ms']:.2f} ms; "
                  f"host stage {t['host_ms']:.2f} ms; wall {t['wall_ms']:.2f} ms", flush=True)
    print("pix2poly metrics (bfloat16): " + json.dumps(results), flush=True)

    batch = next(iter(build_loader(cfg, "test", tokenizer=predictor.tokenizer, eval_mode=True)))
    inputs = to_device(batch, dev, ("images",))
    few = {"images": inputs["images"][:P2P_CPU_TILES]}
    p2p_bf16_card_against_cpu(model, few, predictor.tokenizer, "the checkpoint's model")
    random_model = build_pix2poly(cfg, predictor.tokenizer, device=dev, dtype=torch.bfloat16,
                                  generator=torch.Generator(device=dev).manual_seed(P2P_SEED))
    chain = p2p_chain(random_model, predictor.tokenizer)
    counts = p2p_bf16_card_against_cpu(chain, {"images": inputs["images"][:P2P_BF16_CHAIN_TILES]},
                                       predictor.tokenizer, "the chain copy of the seeded random model")
    del random_model, chain
    if counts["decode_positions"] < P2P_BF16_MIN_DECODE or counts["distinct"] < P2P_BF16_MIN_DISTINCT:
        fail(f"the bfloat16 token check of the chain copy compared {counts['decode_positions']} decode positions "
             f"and {counts['distinct']} distinct tokens, fewer than {P2P_BF16_MIN_DECODE} and {P2P_BF16_MIN_DISTINCT}")
    fixed = p2p_fixed_length(model, inputs, predictor.tokenizer, dev, what=" (bfloat16)")
    f32 = build_pix2poly(cfg, predictor.tokenizer, device=dev, dtype=torch.float32).eval()
    f32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        enc32 = f32.encode(inputs)
    calls32 = p2p_decode_profile(f32, enc32, predictor.tokenizer, " (float32, same weights)")
    if not fixed["aten_per_step"] <= calls32["aten_per_step"]:
        fail(f"a bfloat16 decode step makes {fixed['aten_per_step']} aten calls, more than float32's "
             f"{calls32['aten_per_step']}: a weight is cast per step")
    del f32, enc32

    bench = bench_torch.run(batch=B, iters=BENCH_ITERS, repeats=BENCH_REPEATS, device=dev.type)
    print(json.dumps(bench), flush=True)
    if bench["spread_pct"] is None:
        print(f"bench_torch.py spread_pct: not measured ({BENCH_REPEATS} repeats; it needs 5)", flush=True)
    if not bench["value"] > 0 or bench["compute_dtype"] != "bfloat16":
        fail(f"bench_torch.py gave {bench}")
    return {"tiles_s": tiles_s, "batch_times": times, "results": results, "fixed": fixed,
            "aten_per_step_f32": calls32["aten_per_step"], "bench": bench, "launches": launches}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"shape {tuple(got.shape)} against {tuple(want.shape)}, or non-finite values")
    return float((got - want).norm() / want.norm().clamp(min=1e-12))


def p2p_bf16_card_against_cpu(model, inputs: dict, tokenizer, what: str) -> dict:
    """bfloat16 on the card against bfloat16 on the CPU, on a few tiles:
    encoder tokens, the teacher-forced logits of the card's tokens and the
    raw scores of the card's feats, each within P2P_BF16_REL_L2 in relative
    L2; the two greedy decodes token by token, each row up to the first
    position where they part at a near-tie on the CPU (margins from the CPU
    decode's own logits: there either token is right, and nothing after it
    can be compared); and the CPU's argmax teacher-forced with the card's
    tokens at every position outside near-ties. Returns the counts of
    decode positions and of distinct tokens compared."""
    import copy

    from pixelspointspolygons_torch.models.pix2poly import greedy_decode

    steps = min(model.max_len - 1, P2P_BF16_CHECK_STEPS)
    cpu_model = copy.deepcopy(model).cpu().eval()
    with torch.inference_mode():
        enc = model.encode(inputs)
        tokens, feats, _ = greedy_decode(model, enc, tokenizer.BOS_code, steps)
        t = time.perf_counter()
        enc_cpu = cpu_model.encode({"images": inputs["images"].cpu()})
        tokens_cpu, feats_cpu, _ = greedy_decode(cpu_model, enc_cpu, tokenizer.BOS_code, steps)
        cpu_s = time.perf_counter() - t
        tokens, tokens_cpu = tokens[:, :steps], tokens_cpu[:, :steps]
        logits_cpu_decode = cpu_model.decoder.output(feats_cpu).float()
        bos = torch.full_like(tokens[:, :1], tokenizer.BOS_code)
        tgt = torch.cat([bos, tokens[:, :-1]], dim=1)
        logits, _ = model.decoder(enc, tgt)
        logits_cpu, _ = cpu_model.decoder(enc_cpu, tgt.cpu())
        scores = model.raw_scores_from_feats(feats)
        scores_cpu = cpu_model.raw_scores_from_feats(feats.cpu())
    if enc.dtype != torch.bfloat16 or feats.dtype != torch.bfloat16 or logits.dtype != torch.bfloat16:
        fail(f"the bfloat16 model computed in {enc.dtype}, {feats.dtype}, {logits.dtype}")
    errs = {"encoder": rel_l2(enc, enc_cpu), "logits": rel_l2(logits, logits_cpu),
            "raw scores": rel_l2(scores, scores_cpu)}
    def clear_of(logits):
        """Where the top-2 gap is at least P2P_BF16_NEAR_TIE_ULPS ulps of the top logit."""
        top2 = logits.float().topk(2, dim=-1).values
        ulp = torch.exp2(torch.floor(torch.log2(top2[..., 0].abs().clamp(min=1e-30))) - 7)
        return (top2[..., 0] - top2[..., 1]) >= P2P_BF16_NEAR_TIE_ULPS * ulp

    clear = clear_of(logits_cpu_decode)
    tokens = tokens.cpu()
    compared = wrong = parted = 0
    seen = set()
    for b in range(tokens.shape[0]):
        differ = torch.nonzero(tokens[b] != tokens_cpu[b])
        first = int(differ[0]) if len(differ) else steps
        if first < steps and bool(clear[b, first]):
            wrong += 1
        parted += first < steps
        compared += first
        seen |= set(tokens[b, :first].tolist())
    # teacher-forced with the card's tokens, the CPU's argmax at every clear
    # position up to the first generated PAD (as the float32 check)
    is_pad = tokens == tokenizer.PAD_code
    first_pad = torch.where(is_pad.any(1), is_pad.float().argmax(1), torch.full_like(tokens[:, 0], steps))
    clear_tf = clear_of(logits_cpu) & (torch.arange(steps)[None] <= first_pad[:, None])
    wrong_tf = int(((logits_cpu.float().argmax(-1) != tokens) & clear_tf).sum())
    seen |= set(tokens[clear_tf].tolist())
    print(f"pix2poly bfloat16 card vs CPU, {what}, on {tokens.shape[0]} tiles (CPU encoder and decode {cpu_s:.1f} s): "
          f"rel L2 {errs} (tol {P2P_BF16_REL_L2}); decode tokens equal at {compared} of {tokens.shape[0] * steps} "
          f"positions, {parted} rows part at a near-tie (top-2 gap under {P2P_BF16_NEAR_TIE_ULPS} ulps), {wrong} "
          f"outside one; teacher-forced with the card's tokens, the CPU's argmax differs at {wrong_tf} of "
          f"{int(clear_tf.sum())} clear positions; {len(seen)} distinct tokens compared, "
          f"{len(torch.unique(tokens))} generated", flush=True)
    if not all(e <= P2P_BF16_REL_L2 for e in errs.values()):
        fail(f"bfloat16 Pix2Poly on the card differs from the CPU ({what}): {errs}")
    if wrong or wrong_tf:
        fail(f"the card's bfloat16 tokens differ from the CPU's outside near-ties ({what}): {wrong} in the decode, "
             f"{wrong_tf} teacher-forced")
    return {"decode_positions": compared, "distinct": len(seen)}


def grafted_equal_file(module, values: dict) -> int:
    """How many of `values` (port names → the file's arrays after the key
    map) differ from the module's tensors on the card, bit for bit."""
    tensors = module.state_dict()
    return sum(not torch.equal(tensors[k].cpu(), torch.from_numpy(np.ascontiguousarray(v))) for k, v in values.items())


def one_train_step(trainer, dev_keys) -> dict:
    """The trainer's own train step on its first train batch."""
    from pixelspointspolygons_torch.data.loader import device_prefetch

    batch = next(iter(device_prefetch(trainer.train_loader, trainer.device, dev_keys)))
    metrics = {k: float(v) for k, v in trainer._train_step(trainer.state, batch).items()}
    torch.cuda.synchronize()
    if not all(np.isfinite(v) for v in metrics.values()) or trainer.state.step != 1:
        fail(f"{type(trainer).__name__}: the step gave {metrics} at update {trainer.state.step}")
    return metrics


def phase_pretrained(hisup_overrides: list[str], p2p_overrides: list[str], float32_latest: str) -> dict:
    """Pretrained encoders and the warm start at full width: a timm-layout
    ViT-S/8 file and a reference-layout HRNetV2-W48 file, written from
    seeded numpy, grafted by the trainers' set-up (`pretrained=true
    checkpoint_file=...`), then one train step each; then a HiSup set-up
    with `init_weights_from` the float32 training's checkpoint and one
    step. The grafted tensors on the card must equal the file's."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.models.pix2poly.factory import encoder_config
    from pixelspointspolygons_torch.train import trainer_hisup, trainer_pix2poly
    from pixelspointspolygons_torch.utils.torch_port import port_hrnet, port_timm_vit

    os.makedirs(WORK, exist_ok=True)
    vit_file, hrnet_file = os.path.join(WORK, "vit_s8_timm.pth"), os.path.join(WORK, "hrnetv2_w48.pth")
    # files of the widths the configs build: ViT-S/8 at 224 px (a 28x28
    # grid, 12 blocks of 384) and HRNetV2-W48
    vit = encoder_config(compose(p2p_overrides))
    grid = vit["img_size"] // vit["patch_size"]
    torch.save({"model": timm_vit_state(vit["dim"], 12, vit["patch_size"], grid, seed=PRETRAINED_SEED)}, vit_file)
    hrnet = build_hisup(compose(hisup_overrides), device="meta").encoder
    # the ImageNet file has no HRNetV2 head (`last_layer.*`): it keeps its init
    hr_sd = hrnet_reference_state(hrnet, seed=PRETRAINED_SEED, drop=("last_layer.",))
    torch.save({"state_dict": hr_sd}, hrnet_file)
    out = {}

    def set_up(cls, overrides):
        trainer = cls(compose(overrides))
        trainer.generator = torch.Generator(device=CARD).manual_seed(int(trainer.cfg.get("seed", 42)))
        t = time.perf_counter()
        trainer.setup()
        return trainer, time.perf_counter() - t

    trainer, setup_s = set_up(trainer_pix2poly.Pix2PolyTrainer, p2p_overrides + [
        "experiment.encoder.pretrained=true", f"experiment.encoder.checkpoint_file={vit_file}"])
    trunk = trainer.state.model.encoder.vit
    values = port_timm_vit(torch.load(vit_file, weights_only=True)["model"])
    values = {k: v for k, v in values.items() if k in trunk.state_dict()}
    bad = grafted_equal_file(trunk, values)
    metrics = one_train_step(trainer, trainer_pix2poly._DEV_KEYS)
    n_trunk = len(trunk.state_dict())
    print(f"pretrained ViT-S/8 (timm layout, {len(values)} tensors): set-up with the graft {setup_s:.1f} s; "
          f"{len(values)} tensors loaded, {n_trunk - len(values)} kept at init, {bad} differ from the file on the "
          f"card; one Pix2Poly step {metrics}", flush=True)
    if bad or len(values) != n_trunk:
        fail(f"the ViT graft: {bad} tensors differ from the file, {n_trunk - len(values)} not loaded")
    out["vit"] = {"loaded": len(values), "kept": n_trunk - len(values)}
    del trainer, trunk

    trainer, setup_s = set_up(trainer_hisup.HiSupTrainer, hisup_overrides + [
        "experiment.encoder.hrnet.pretrained=true", f"experiment.encoder.hrnet.checkpoint_file={hrnet_file}"])
    encoder = trainer.state.model.encoder
    values, loaded, skipped = port_hrnet(torch.load(hrnet_file, weights_only=True)["state_dict"],
                                         encoder.state_dict())
    bad = grafted_equal_file(encoder, values)
    metrics = one_train_step(trainer, trainer_hisup._DEV_KEYS)
    kept = sorted(set(encoder.state_dict()) - set(values))
    print(f"pretrained HRNetV2-W48 (reference layout, no head): set-up with the graft {setup_s:.1f} s; "
          f"{len(values)} tensors loaded ({len(loaded)} modules), {len(kept)} kept at init ({kept}), "
          f"{bad} differ from the file on the card; one HiSup step {metrics}", flush=True)
    if bad or any(not k.startswith(("last_conv1.", "last_bn.", "last_conv2.")) for k in kept):
        fail(f"the HRNet graft: {bad} tensors differ from the file, tensors kept at init {kept}")
    n_trunk = len(encoder.state_dict())
    out["hrnet"] = {"loaded": len(values), "kept": n_trunk - len(values)}
    del trainer, encoder

    trainer, setup_s = set_up(trainer_hisup.HiSupTrainer, hisup_overrides + [f"init_weights_from={float32_latest}"])
    want = torch.load(float32_latest, map_location="cpu", weights_only=True)["model"]
    got = trainer.state.model.state_dict()
    bad = sum(not torch.equal(got[k].cpu(), want[k]) for k in want)
    fresh = trainer.state.step == 0 and trainer.start_epoch == 0 and not trainer.state.optimizer.state
    metrics = one_train_step(trainer, trainer_hisup._DEV_KEYS)
    print(f"warm start from {float32_latest}: set-up {setup_s:.1f} s; {len(want) - bad} of {len(got)} tensors "
          f"taken up, {bad} differ; fresh optimizer and schedule: {fresh}; one HiSup step {metrics}", flush=True)
    if bad or set(want) != set(got) or not fresh:
        fail(f"the warm start: {bad} tensors differ from the checkpoint, fresh optimizer {fresh}")
    out["warm_start"] = {"loaded": len(want) - bad, "kept": len(got) - len(want) + bad}
    return out


def phase_entry() -> dict:
    """`graft_entry_torch.entry()` (the twin of `__graft_entry__.entry()`)
    on the card against the same function on the CPU."""
    import graft_entry_torch

    fn, args = graft_entry_torch.entry()
    t = time.perf_counter()
    logits, perm = fn(*args)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t) * 1e3
    cpu_fn, cpu_args = graft_entry_torch.entry("cpu")
    t = time.perf_counter()
    cpu_logits, cpu_perm = cpu_fn(*cpu_args)
    cpu_s = time.perf_counter() - t
    errs = {"logits": rel_err(logits, cpu_logits), "perm": rel_err(perm, cpu_perm)}
    print(f"entry twin (graft_entry_torch.entry): logits {tuple(logits.shape)} {logits.dtype}, perm "
          f"{tuple(perm.shape)} {perm.dtype}; card {card_ms:.1f} ms (first call), CPU {cpu_s:.1f} s; card vs CPU "
          f"max rel err {errs} (tol {ENTRY_REL_TOL})", flush=True)
    if logits.device.type != CARD.type or not all(e <= ENTRY_REL_TOL for e in errs.values()):
        fail(f"the entry twin on {logits.device} differs from the CPU: {errs}")
    return errs


def phase_ffl(overrides: list[str]) -> dict:
    """FFL-image prediction at full width from a seeded random model,
    through the functions `cli/predict.py::main` calls, then its checks:
    the forward on the card against the CPU, the ACM on the card against the
    CPU, one ACM step profiled, the polygonizer on the ground truth, and
    `cli.predict_demo`."""
    from pixelspointspolygons_torch.cli.evaluate import evaluate
    from pixelspointspolygons_torch.cli.predict import get_predictor
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.ffl import build_ffl
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.train.state import TrainState, linear_warmup_decay, make_optimizer, make_scheduler
    from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager
    from pixelspointspolygons_torch.utils.coco import CocoIndex

    cfg = compose(overrides + ["evaluation=test", "checkpoint=latest"])
    model = ffl_seeded_model(cfg)
    lr = float(cfg.experiment.model.learning_rate)
    opt = make_optimizer("adam", model.parameters(), lr)
    CheckpointManager(cfg.output_dir).save(
        "latest", TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(lr, 1000), lr)), 0, cfg
    )
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt

    afm_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    predictor = get_predictor(cfg)
    pred_file = predictor.predict_dataset(cfg.evaluation.split)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = evaluate(cfg, pred_file)
    t2 = time.perf_counter()
    launches = afm_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    if predictor.device.type != CARD.type or predictor.polygonizer.device.type != CARD.type:
        fail(f"the FFL predictor ran on {predictor.device}")
    if launches:
        fail(f"the FFL predict path launched the afm kernel {launches} times, expected 0")
    if predictor.failed_batches:
        fail(f"FFL prediction: {predictor.failed_batches} batches failed (see the warnings above)")
    keys = [f"acm.tol_{t}" for t in cfg.experiment.polygonization.acm_method.tolerance]
    files = [pred_file, pred_file.replace(".json", "_time.json")] + [pred_file.replace(".json", f"_{k}.json")
                                                                     for k in keys]
    try:
        per_key = {}
        for path in files:
            with open(path) as f:
                per_key[path] = json.load(f)
    except (OSError, ValueError) as e:
        fail(f"FFL prediction file: {e}")
    anns, timing = per_key[files[0]], per_key[files[1]]
    test_ids = set(CocoIndex(cfg.experiment.dataset.annotations["test"]).imgs)
    if timing["num_images"] != TEST_TILES or len(test_ids) != TEST_TILES:
        fail(f"FFL predicted {timing['num_images']} of {len(test_ids)} test tiles, expected {TEST_TILES}")
    if not all({a["image_id"] for a in per_key[f]} <= test_ids for f in files[2:] + files[:1]):
        fail("an FFL prediction file holds image ids outside the test split")
    if anns != per_key[pred_file.replace(".json", "_acm.tol_1.json")]:
        fail("the canonical FFL prediction file is not the acm.tol_1 file")
    bad = [k for k in ("IoU", "C-IoU") if not np.isfinite(results.get(k, np.nan))]
    if bad:
        fail(f"FFL: non-finite metrics {bad}: {results}")

    times = predictor.batch_times
    tiles_s = 1.0 / timing["prediction_time"]
    print(f"ffl predict path: {timing['num_images']} tiles in {len(times)} batches of {B}, {tiles_s:.2f} tiles/s "
          f"(the predictor's own s/tile over its loop), {n_params} parameters; set-up, loop and files "
          f"{t1 - t0:.2f} s, evaluation {t2 - t1:.2f} s; polygons per file "
          f"{ {k: len(per_key[pred_file.replace('.json', f'_{k}.json')]) for k in keys} }; afm launches {launches}; "
          f"failed batches {predictor.failed_batches}; peak memory {peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)
    for i, t in enumerate(times):
        print(f"  batch {i}: forward {t['device_ms']:.2f} ms (CUDA events); contours {t['contours_ms']:.2f} ms (host); "
              f"ACM {t['acm_ms']:.2f} ms ({t['acm_steps']} steps, CUDA events, "
              f"{t['acm_ms'] / max(t['acm_steps'], 1):.3f} ms/step) over {t['rings']} rings, {t['vertices']} vertices, "
              f"bucket {t['bucket']}, {t['dropped']} rings dropped; post-processing {t['post_ms']:.2f} ms (host); "
              f"host stage {t['host_ms']:.2f} ms; wall {t['wall_ms']:.2f} ms", flush=True)
    print("ffl metrics: " + json.dumps(results), flush=True)
    predict_repeat("ffl_image", predictor)

    acm = ffl_acm_against_cpu(predictor, ffl_forward_against_cpu(cfg, predictor))
    oracle = ffl_oracle(cfg, predictor)
    demo_s = ffl_demo(overrides)
    return {"tiles_s": tiles_s, "batch_times": times, "results": results, "launches": launches, "peak_bytes": peak,
            "acm": acm, "oracle": oracle, "demo_s": demo_s}


def ffl_seeded_model(cfg):
    """The full-width FFL of `cfg` with weights drawn on the CPU from
    FFL_SEED (as the entry twin's: a generator on the card draws others).
    At these weights the seg head's output stays near 0.5 (0.39-0.69 on 2
    test tiles; all above 0.5 in another torch version's draw), so whether
    the maps have contours at all depends on the draw, and without them the
    ACM optimizes nothing; so its output layer is shifted and sharpened, as
    a trained model's is sharp: the logits become FFL_SEG_SHARPEN x (logit -
    its FFL_SEG_QUANTILE quantile over 2 test tiles on the card). Returns
    the model on the card."""
    from pixelspointspolygons_torch.data.loader import INPUT_KEYS, build_loader, to_device
    from pixelspointspolygons_torch.models.ffl import build_ffl

    model = build_ffl(cfg, generator=torch.Generator().manual_seed(FFL_SEED)).to(CARD).eval()
    batch = next(iter(build_loader(cfg, "test", eval_mode=True)))
    with torch.inference_mode():
        seg = model(to_device({k: v[:2] for k, v in batch.items()}, CARD, INPUT_KEYS))["seg"]
    shift = float(torch.quantile(torch.logit(seg.double()).flatten(), FFL_SEG_QUANTILE))
    with torch.no_grad():
        model.seg_out.weight.mul_(FFL_SEG_SHARPEN)
        model.seg_out.bias.sub_(shift).mul_(FFL_SEG_SHARPEN)
    print(f"ffl seeded model: seg {float(seg.min()):.4f}..{float(seg.max()):.4f} on 2 test tiles; seg head shifted by "
          f"{shift:.4f} and sharpened x{FFL_SEG_SHARPEN}", flush=True)
    return model


def ffl_forward_against_cpu(cfg, predictor) -> tuple:
    """The model's seg and crossfield on FFL_CPU_TILES test tiles on the card
    against a copy on the CPU; returns the first test batch's float16 maps
    on the card (the predictor's forward)."""
    import copy

    from pixelspointspolygons_torch.data.loader import build_loader, to_device

    batch = next(iter(build_loader(cfg, "test", eval_mode=True)))
    few = {"images": batch["images"][:FFL_CPU_TILES]}
    with torch.inference_mode():
        card = predictor.model.eval()(to_device(few, CARD, ("images",)))
        t = time.perf_counter()
        cpu = copy.deepcopy(predictor.model).cpu().eval()(to_device(few, torch.device("cpu"), ("images",)))
        cpu_s = time.perf_counter() - t
    errs = {k: float((card[k].cpu() - v).abs().max()) for k, v in cpu.items()}
    print(f"ffl card vs CPU on {FFL_CPU_TILES} test tiles (CPU forward {cpu_s:.1f} s): max abs err {errs} "
          f"(tol {FFL_MAP_TOL})", flush=True)
    if set(errs) != {"seg", "crossfield"} or not all(e <= FFL_MAP_TOL for e in errs.values()):
        fail(f"the FFL model's maps on the card differ from the CPU's: {errs}")
    maps = predictor.forward(to_device(batch, CARD, ("images",)))
    return maps["seg"], maps["crossfield"]


def acm_card_against_cpu(poly, maps: tuple, what: str, bounds: tuple) -> dict:
    """The ACM's steps on the packed contours of `maps` (seg, crossfield
    tensors on the card) on the card and on the CPU from the same values,
    position by position; fails outside `bounds` = (max px, median px,
    largest share of the vertices beyond ACM_FAR_PX) or if no vertex
    moved."""
    from pixelspointspolygons_torch.predict import ffl_polygonize as fp

    seg, crossfield = (m.float().cpu().numpy() for m in maps)
    level = float(poly.cfg.common_params.init_data_level)
    packed = fp.pack_contours([fp.extract_contours_flagged(seg[b, 0], level) for b in range(len(seg))])
    vmask = packed[1]
    card = poly._optimize(packed[:5], seg[:, 0], crossfield, maps)
    card_ms = poly.stats["acm_ms"]
    t = time.perf_counter()
    cpu = poly._optimize(packed[:5], seg[:, 0], crossfield, tuple(m.cpu() for m in maps))
    cpu_s = time.perf_counter() - t
    d = np.abs(card - cpu)[vmask].max(axis=1)
    moved = float(np.abs(cpu - packed[0])[vmask].max())
    out = {"max_px": float(d.max()), "median_px": float(np.median(d)), "far_share": float((d > ACM_FAR_PX).mean()),
           "card_ms": card_ms, "vertices": int(vmask.sum())}
    print(f"ffl ACM card vs CPU, {what} ({len(packed[5])} rings, {out['vertices']} vertices, bucket {len(vmask)}, "
          f"{packed[6]} dropped; card {card_ms:.1f} ms, CPU {cpu_s:.1f} s, {poly.stats['acm_steps']} steps; vertices "
          f"moved up to {moved:.3f} px): |card - CPU| max {out['max_px']:.3g} px, median {out['median_px']:.3g} px, "
          f"99th percentile {np.quantile(d, 0.99):.3g} px, {100 * out['far_share']:.2f} % beyond {ACM_FAR_PX} px "
          f"(bounds: max {bounds[0]}, median {bounds[1]}, share beyond {ACM_FAR_PX} px {bounds[2]})", flush=True)
    got = (out["max_px"], out["median_px"], out["far_share"])
    if moved <= 0.1 or any(g > b for g, b in zip(got, bounds)):
        fail(f"ACM on the card against the CPU, {what}: outside the bounds, or no vertex moved")
    return out


def ffl_acm_against_cpu(predictor, maps: tuple) -> dict:
    """ACM on FFL_CPU_TILES tiles of one batch (the CPU's 500 steps over
    all 16 would take about a minute) on the card and on the CPU from the
    same float16-rounded maps (the card's forward); then one ACM step
    profiled on the card at the whole batch's packing, the predict path's
    size."""
    from pixelspointspolygons_torch.predict import ffl_polygonize as fp

    poly = predictor.polygonizer
    out = acm_card_against_cpu(poly, tuple(m[:FFL_CPU_TILES] for m in maps),
                               f"{FFL_CPU_TILES} tiles of the seeded model's first test batch", ACM_BOUNDS)
    seg, _ = (m.float().cpu().numpy() for m in maps)
    level = float(poly.cfg.common_params.init_data_level)
    packed = fp.pack_contours([fp.extract_contours_flagged(seg[b, 0], level) for b in range(len(seg))])
    args = [torch.from_numpy(a).to(CARD) for a in (packed[0], packed[1], packed[2].astype(np.int64),
                                                     packed[3].astype(np.int64), packed[4])]
    seg_d, cf_d = (m.float() for m in maps)
    profile = ffl_acm_profile((*args[:4], seg_d[:, 0], cf_d, args[4]), fp.acm_kwargs(poly.cfg.acm_method))
    return {**out, "profile_vertices": int(packed[1].sum()), "profile_bucket": len(packed[1]), **profile}


def ffl_acm_profile(args: tuple, kw: dict) -> dict:
    """The ACM's steps replayed from their CUDA graph against the loop of
    `acm_step` on the same packing, bitwise, and both timed; then what one
    step of the loop costs on the card, from runs of 1 and 11 steps (their
    difference over 10 steps, so the set-up drops out): the step's time
    unprofiled (host clock, synchronized), and from torch.profiler traces
    the host's top-level aten calls, the kernels launched and their summed
    device time; the card's busy share is that time over the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pixelspointspolygons_torch.predict.ffl_polygonize import acm_optimize

    runs = {}
    for graph in (False, True, False, True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = acm_optimize(*args, **{**kw, "graph": graph})
        torch.cuda.synchronize()
        runs.setdefault(graph, []).append(((time.perf_counter() - t) * 1e3, got))
    same = all(torch.equal(got, runs[False][0][1]) for r in runs.values() for _, got in r)
    print(f"ffl ACM, {kw['steps']} steps at {len(args[0])} positions: replayed from one captured step "
          f"{[round(ms, 1) for ms, _ in runs[True]]} ms, the loop {[round(ms, 1) for ms, _ in runs[False]]} ms "
          f"(host clock, in turns); all four bitwise equal {same}", flush=True)
    if not same:
        fail("the ACM's steps replayed from their CUDA graph differ from the loop's")

    def run(steps):
        acm_optimize(*args, **{**kw, "steps": steps, "graph": False})
        torch.cuda.synchronize()

    run(2)  # warm-up
    walls = {}
    for steps in (1, 11):
        t = time.perf_counter()
        run(steps)
        walls[steps] = time.perf_counter() - t
    ms_per_step = (walls[11] - walls[1]) * 1e3 / 10
    counts = []
    for steps in (1, 11):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(steps)
        events = prof.events()
        aten = [e for e in events if e.name.startswith("aten::")
                and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        counts.append((len(aten), len(kernels), sum(e.time_range.elapsed_us() for e in kernels)))
    per = [(b - a) / 10 for a, b in zip(*counts)]
    # the least time of the whole loop: its inputs read once and its output
    # written once, or ACM_OPS_PER_VERTEX_STEP operations per position and
    # step at the FP32 peak
    n, steps = len(args[0]), kw["steps"]
    nbytes = sum(t.numel() * t.element_size() for t in args) + args[0].numel() * 4
    t_ops = n * steps * ACM_OPS_PER_VERTEX_STEP / PEAK_FP32_FLOPS * 1e3
    bound_ms, bound_by = max((t_ops, "operations"), (nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"))
    out = {"aten_per_step": per[0], "kernels_per_step": per[1], "kernel_us_per_step": per[2],
           "step_ms": ms_per_step, "loop_bound_ms": bound_ms, "loop_bound_by": bound_by,
           "graph_ms": [ms for ms, _ in runs[True]], "loop_ms": [ms for ms, _ in runs[False]]}
    print(f"ffl ACM loop bound at {n} positions: {bound_ms:.4f} ms for {steps} steps ({bound_by}; "
          f"{nbytes / 1e6:.2f} MB, {n * steps * ACM_OPS_PER_VERTEX_STEP / 1e9:.3f} GFLOP)", flush=True)
    if per[1] <= 0:
        print("ffl ACM step profile: the profiler recorded no device kernels (busy share not measured)", flush=True)
        return out
    out["busy_share"] = per[2] / (ms_per_step * 1e3)
    print(f"ffl ACM step profile (K5 baseline; torch.profiler, steps 1..11, {len(args[0])} positions): "
          f"{per[0]:.1f} top-level aten calls and {per[1]:.1f} kernels per step, {per[2]:.1f} us of kernel time "
          f"per step: the card is busy {100 * out['busy_share']:.1f} % of the {ms_per_step:.3f} ms step "
          f"(unprofiled, steps 1..11)", flush=True)
    return out


def ffl_oracle(cfg, predictor) -> dict:
    """The polygonizer on the card on maps that the test split's ground
    truth implies (`ffl_oracle_maps`), evaluated as a prediction: what the
    contours, the ACM and the post-processing give on building shapes,
    which a random model's maps do not show."""
    from pixelspointspolygons_torch.eval.metrics import compute_iou_ciou
    from pixelspointspolygons_torch.utils.coco import CocoIndex, generate_coco_ann

    gt = CocoIndex(cfg.experiment.dataset.annotations["test"])
    size = int(cfg.experiment.encoder.in_size)
    key = f"tol_{cfg.experiment.polygonization.acm_method.get('eval_tolerance', 1)}"
    ids = sorted(gt.imgs)
    anns, ms = [], []
    for k in range(0, len(ids), B):
        chunk = ids[k:k + B]
        maps = [ffl_oracle_maps([s for a in gt.imgToAnns.get(i, []) for s in a["segmentation"]], size) for i in chunk]
        seg, cf = np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])
        t = time.perf_counter()
        out = predictor.polygonizer(seg, cf, maps=(torch.from_numpy(seg).to(CARD), torch.from_numpy(cf).to(CARD)))
        ms.append((time.perf_counter() - t) * 1e3)
        for i, polys in zip(chunk, out["acm"][key]):
            anns.extend(generate_coco_ann(polys, i))
    iou = compute_iou_ciou(gt, gt.load_res(anns))
    maps = [ffl_oracle_maps([s for a in gt.imgToAnns.get(i, []) for s in a["segmentation"]], size)
            for i in ids[:FFL_CPU_TILES]]
    acm = acm_card_against_cpu(predictor.polygonizer, tuple(torch.from_numpy(np.stack([m[j] for m in maps])).to(CARD)
                                                            for j in (0, 1)),
                               f"{FFL_CPU_TILES} tiles' ground-truth maps", ACM_BOUNDS)
    print(f"ffl polygonizer on the ground truth (card ACM): {[round(x, 1) for x in ms]} ms per batch of {B}, "
          f"{len(anns)} polygons for {len(gt.anns)} buildings, IoU {iou['IoU']:.4f} C-IoU {iou['C-IoU']:.4f} "
          f"(IoU at least {FFL_ORACLE_MIN_IOU})", flush=True)
    if not iou["IoU"] >= FFL_ORACLE_MIN_IOU:
        fail(f"the FFL polygonizer on the ground truth gave IoU {iou['IoU']}")
    return {"ms": ms, "iou": iou["IoU"], "c_iou": iou["C-IoU"], "acm": acm}


def ffl_demo(overrides: list[str]) -> float:
    """`cli.predict_demo` on one test tile, in the work directory (it writes
    its png where it runs)."""
    from pixelspointspolygons_torch.cli import predict_demo
    from pixelspointspolygons_torch.config import compose

    cfg = compose(overrides)
    test_dir = os.path.join(cfg.experiment.dataset.in_path, "images", "test")
    image = os.path.join(test_dir, sorted(os.listdir(test_dir))[0])
    cwd = os.getcwd()
    os.chdir(WORK)
    try:
        t = time.perf_counter()
        polys, out_file = predict_demo.main(overrides + ["checkpoint=latest", f"+image_file={image}"])
        demo_s = time.perf_counter() - t
        ok = os.path.isfile(out_file)
    finally:
        os.chdir(cwd)
    print(f"ffl predict_demo on {os.path.basename(image)}: {len(polys)} polygons, {out_file} written {ok}, "
          f"{demo_s:.2f} s", flush=True)
    if not ok:
        fail("cli.predict_demo wrote no png")
    return demo_s


def phase_ffl_train(overrides: list[str], dtype: str, steps: int = TRAIN_STEPS, name: str = "ffl",
                    cold: bool = True, exact_tiles: int = 0) -> dict:
    """FFL-image training at full width through the trainer that
    `cli/train.py` builds, at `dtype`: `steps` train + 1 val steps and the
    val-IoU pass with the kernel counters set to 0 just before and read
    just after (with `cold`, the float32 run from an empty ground-truth
    cache, so its loader is cold), then the steady-state step, its parts,
    one forward traced, and the card against the CPU (with `exact_tiles`,
    on that many tiles and its gradient against float64's). `name` heads
    its lines."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.train.trainer_ffl import FFL_BATCH_KEYS, FFLTrainer

    cfg = compose(overrides + [f"host.compute_dtype={dtype}"])
    cold = cold and dtype == "float32"
    if cold:
        shutil.rmtree(os.path.join(cfg.experiment.dataset.in_path, "ffl_cache_torch"), ignore_errors=True)
    trainer = FFLTrainer(cfg, device=CARD)
    iou_pass_s, step_losses, first, cold_ms = [], [], {}, []
    record_steps(trainer, step_losses, iou_pass_s, first, cold_ms)
    torch.cuda.reset_peak_memory_stats()
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = afm_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    n_train, n_val = len(trainer.train_loader), len(trainer.val_loader)
    model = trainer.state.model
    losses = [{k: float(v) for k, v in m.items()} for m in step_losses]
    print(f"{name} train path ({dtype}): {n_train} train + {n_val} val steps and the val-IoU pass in {wall:.1f} s "
          f"(set-up included), peak memory {peak / 2**30:.2f} GiB; afm launches {launches}; model computes in "
          f"{model.compute_dtype}, parameters {next(model.parameters()).dtype}", flush=True)
    print(f"{name} history ({dtype}): " + json.dumps(history), flush=True)
    print(f"{name} step losses ({dtype}), the first step's terms first: " + json.dumps(losses), flush=True)
    if (n_train, n_val) != (steps, VAL_STEPS) or len(losses) != n_train:
        fail(f"{name}: expected {steps} train and {VAL_STEPS} val steps, got {n_train}, {n_val}, {len(losses)}")
    if not all(np.isfinite(v) for k, v in history.items() if k != "epoch"):
        fail(f"{name} ({dtype}): non-finite losses: {history}")
    if launches:
        fail(f"the {name} train path launched the afm kernel {launches} times, expected 0")
    if model.compute_dtype != getattr(torch, dtype) or next(model.parameters()).dtype != torch.float32:
        fail(f"{name} ({dtype}): the model computes in {model.compute_dtype}")
    if not trainer.manager.exists("latest") or not trainer.manager.exists("best_val_loss"):
        fail("the FFL trainer wrote no latest/best_val_loss checkpoint")
    val_iou = history.get("val_iou")
    if val_iou is None or not 0.0 <= val_iou <= 1.0 or len(iou_pass_s) != 1:
        fail(f"the FFL val-IoU pass gave no IoU in [0, 1]: {val_iou}")
    acm = trainer._predictor.polygonizer.stats
    print(f"{name} val-IoU pass ({dtype}): {n_val * B} val tiles polygonized in {iou_pass_s[0] * 1e3:.1f} ms (wall), "
          f"val IoU {val_iou:.4f}; its ACM {acm['acm_ms']:.1f} ms ({acm['acm_steps']} steps, CUDA events) over "
          f"{acm['rings']} rings, {acm['vertices']} vertices, bucket {acm['bucket']}, {acm['dropped']} rings dropped; "
          f"contours {acm['contours_ms']:.1f} ms, post-processing {acm['post_ms']:.1f} ms (host)", flush=True)

    # steady state on the same batches (not part of the counted run)
    t = time.perf_counter()
    host = list(trainer.train_loader)
    warm_ms = (time.perf_counter() - t) * 1e3 / len(host)
    batches = list(device_prefetch(host, trainer.device, FFL_BATCH_KEYS))
    weights = trainer._weights_for_epoch(0)
    trainer._train_step(trainer.state, batches[0], weights)
    torch.cuda.synchronize()
    times = []
    for batch in batches:
        t = time.perf_counter()
        trainer._train_step(trainer.state, batch, weights)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    t = time.perf_counter()
    trainer._val_step(trainer.state, batches[0], weights)
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t) * 1e3
    parts = [ffl_step_parts(trainer, batch, weights) for batch in batches]
    breakdown = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    cold = statistics.median(cold_ms) if cold else None
    print(f"{name} train step ({dtype}) {step_ms:.1f} ms (median of {len(times)}: {[round(x, 1) for x in times]}), "
          f"val step {val_ms:.1f} ms; host loader per batch of {B}: "
          + (f"cold {cold:.1f} ms (the ground truth computed; median of the run's {len(cold_ms)}: "
             f"{[round(x, 1) for x in cold_ms]}), " if cold is not None else "")
          + f"warm {warm_ms:.1f} ms (from the cache)", flush=True)
    print(f"{name} train step ({dtype}) by layer (ms, CUDA events, median of {len(parts)}): {json.dumps(breakdown)}",
          flush=True)
    profile_forward(trainer, batches[0]["images"], f"{name} {dtype}")
    if exact_tiles:
        first["batch"] = {k: v[:exact_tiles] for k, v in first["batch"].items()}
    if dtype == "float32":
        card_losses = ffl_train_card_against_cpu(cfg, first, name, exact=bool(exact_tiles))
    else:
        ffl_bf16_card_against_cpu(cfg, first)
    train_twice(f"ffl_image_{dtype}" if name == "ffl" else name.replace(" ", "_"), trainer, batches, (weights,),
                {"afm": False, "pillar_sums": False, "run_sums": False})
    return {"first": first, "card_losses": card_losses if dtype == "float32" else None, "step_ms": step_ms,
            "val_ms": val_ms, "peak_bytes": peak, "iou_pass_ms": iou_pass_s[0] * 1e3, "val_iou": val_iou, "losses": losses, "breakdown": breakdown, "launches": launches,
            "loader_cold_ms": cold, "loader_warm_ms": warm_ms, "val_acm": dict(acm)}


def ffl_step_parts(trainer, batch: dict, weights: dict) -> dict:
    """One FFL train step cut by CUDA events on the stream into forward,
    losses, backward and Adam, with the calls of train/ffl_step.py."""
    from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
    from pixelspointspolygons_torch.train.ffl_step import model_inputs

    state = trainer.state
    loss_fn, _ = make_ffl_loss(trainer.cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    state.model.train()
    ev[0].record()
    outputs = state.model(model_inputs(batch))
    ev[1].record()
    total, _ = loss_fn(outputs, batch, weights)
    ev[2].record()
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    ev[3].record()
    state.optimizer.step()
    ev[4].record()
    torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(("forward", "losses", "backward", "optimizer"))}


def ffl_train_card_against_cpu(cfg, first: dict, name: str = "ffl", exact: bool = False) -> dict:
    """One float32 train step on the tiles of `first` (HISUP_BF16_CPU_TILES
    of the first batch, or fewer) from the trainer's initial weights, on
    the card and on the CPU with fresh Adam states: the losses and the
    gradients (the CPU path is
    held to the JAX package by tests/test_torch_train_ffl.py). With
    `exact`, the gradients are held against the same step in float64,
    taken on the card (as phase 22's float64 gradients are), instead: the
    card's float32 no farther from it than
    DDP_EXACT_FACTOR times the CPU's float32, plus DDP_EXACT_FLOOR (a deep
    trunk of train-mode BatchNorms on 2 tiles makes either float32 gradient
    stray from the exact one, as HiSup's does: ROADMAP 3.16). Returns the
    card's losses."""
    from pixelspointspolygons_torch.models.ffl import build_ffl
    from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
    from pixelspointspolygons_torch.train.ffl_step import make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler

    lr = float(cfg.experiment.model.learning_rate)
    loss_fn, weights_for_epoch = make_ffl_loss(cfg)
    step = make_train_step(loss_fn)

    def state_on(device, dtype=torch.float32):
        model = build_ffl(cfg, device=device, dtype=dtype)
        model.load_state_dict(first["state"])
        model.to(dtype)
        opt = make_optimizer("adam", model.parameters(), lr)
        return TrainState(model, opt, make_scheduler(opt, lambda n: lr, lr))

    def grads(state):
        return {n: p.grad.detach().cpu().double() for n, p in state.model.named_parameters()}

    card, cpu = state_on(CARD), state_on(torch.device("cpu"))
    got = step(card, {k: v.to(CARD) for k, v in first["batch"].items()}, weights_for_epoch(0))
    t = time.perf_counter()
    want = step(cpu, first["batch"], weights_for_epoch(0))
    cpu_s = time.perf_counter() - t
    loss_err = {k: abs(float(got[k]) / float(want[k]) - 1.0) for k in want}
    g_card, g_cpu = grads(card), grads(cpu)
    grad_err = grad_rel_l2(g_card, g_cpu)
    print(f"{name} train step card vs CPU on {len(first['batch']['images'])} tiles from the initial weights (float32; "
          f"CPU step {cpu_s:.1f} s): losses {({k: round(float(v), 6) for k, v in want.items()})}, rel err "
          f"{loss_err} (tol {FFL_LOSS_TOL}); gradients rel L2 {grad_err:.3g}"
          + ("" if exact else f" (tol {FFL_GRAD_TOL})"), flush=True)
    grads_ok = grad_err <= FFL_GRAD_TOL
    if exact:
        ref = state_on(CARD, torch.float64)
        step(ref, {k: (v.double() if v.is_floating_point() else v).to(CARD) for k, v in first["batch"].items()},
             weights_for_epoch(0))
        g_exact = grads(ref)
        del ref
        card_err, cpu_err = grad_rel_l2(g_card, g_exact), grad_rel_l2(g_cpu, g_exact)
        tol = DDP_EXACT_FACTOR * cpu_err + DDP_EXACT_FLOOR
        print(f"{name} train step gradients against float64 on the card, relative L2: card {card_err:.3g}, CPU "
              f"float32 {cpu_err:.3g} (tol {tol:.3g})", flush=True)
        grads_ok = card_err <= tol
    if not all(e <= FFL_LOSS_TOL for e in loss_err.values()) or not grads_ok:
        fail(f"the {name} train step differs between card and CPU: losses {loss_err}, gradients {grad_err}")
    return {k: float(v) for k, v in got.items()}


def ffl_bf16_card_against_cpu(cfg, first: dict) -> None:
    """The bfloat16 FFL on the card against the same on the CPU, from the
    first train step's weights, in eval mode on BF16_EVAL_TILES tiles of its
    batch: each map within FFL_BF16_REL_L2 in relative L2 (the CPU path is
    held to flax's bfloat16 by tests/test_torch_ffl_bf16.py). Each side's
    distance from the same weights' float32 maps on the card beside it."""
    from pixelspointspolygons_torch.models.ffl import build_ffl

    images = first["batch"]["images"][:BF16_EVAL_TILES]
    models = {}
    for name, dev, dtype in (("card", CARD, torch.bfloat16), ("cpu", torch.device("cpu"), torch.bfloat16),
                             ("float32", CARD, torch.float32)):
        models[name] = build_ffl(cfg, device=dev, dtype=dtype)
        models[name].load_state_dict(first["state"])
        models[name].eval()
    with torch.no_grad():
        out = models["card"]({"images": images.to(CARD)})
        ref = models["float32"]({"images": images.to(CARD)})
        t = time.perf_counter()
        out_cpu = models["cpu"]({"images": images})
        cpu_s = time.perf_counter() - t
    if any(v.dtype != torch.bfloat16 for v in list(out.values()) + list(out_cpu.values())):
        fail(f"the bfloat16 FFL gave {[v.dtype for v in out.values()]}")
    apart = {k: round(rel_l2(out[k], v), 5) for k, v in out_cpu.items()}
    card = {k: round(rel_l2(out[k], ref[k]), 5) for k in ref}
    cpu = {k: round(rel_l2(out_cpu[k], ref[k]), 5) for k in ref}
    print(f"ffl bfloat16 card vs CPU on {len(images)} tiles from the first step's weights, eval mode (CPU bfloat16 "
          f"forward {cpu_s:.1f} s), relative L2 per map: {apart} (tol {FFL_BF16_REL_L2}); from the float32 maps of "
          f"the same weights: card {card}, CPU {cpu}", flush=True)
    if set(apart) != {"seg", "crossfield"} or not all(v <= FFL_BF16_REL_L2 for v in apart.values()):
        fail(f"bfloat16 FFL on the card differs from the CPU: {apart}")


def phase_ffl_predict_tiles(overrides: list[str], dtype: str, name: str, tiles: int,
                            checkpoint: str = "latest") -> dict:
    """FFL prediction at `dtype` from `checkpoint`, through the functions
    `cli/predict.py::main` calls, on the first `tiles` test tiles."""
    from pixelspointspolygons_torch.cli.evaluate import evaluate
    from pixelspointspolygons_torch.cli.predict import get_predictor
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    cfg = compose(overrides + [f"host.compute_dtype={dtype}", "evaluation=test", f"checkpoint={checkpoint}",
                               f"run_type.test_subset={tiles}"])
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    predictor = get_predictor(cfg)
    pred_file = predictor.predict_dataset(cfg.evaluation.split)
    torch.cuda.synchronize()
    results = evaluate(cfg, pred_file)
    wall = time.perf_counter() - t0
    launches = afm_cuda.launches
    with open(pred_file.replace(".json", "_time.json")) as f:
        timing = json.load(f)
    if predictor.model.compute_dtype != getattr(torch, dtype) or predictor.map_dtype != torch.float16:
        fail(f"{name} prediction at {dtype}: the model computes in {predictor.model.compute_dtype}")
    if launches or predictor.failed_batches or timing["num_images"] != tiles:
        fail(f"{name} prediction at {dtype}: {launches} afm launches, {predictor.failed_batches} failed batches, "
             f"{timing['num_images']} tiles")
    if not all(np.isfinite(results.get(k, np.nan)) for k in ("IoU", "C-IoU")):
        fail(f"{name} prediction at {dtype}: non-finite metrics {results}")
    tiles_s = 1.0 / timing["prediction_time"]
    print(f"{name} predict path ({dtype}): {timing['num_images']} tiles in {len(predictor.batch_times)} batches of {B}, "
          f"{tiles_s:.2f} tiles/s (the predictor's own s/tile over its loop); set-up, loop, files and evaluation "
          f"{wall:.2f} s; afm launches {launches}; failed batches {predictor.failed_batches}; IoU "
          f"{results['IoU']:.4f}", flush=True)
    for i, t in enumerate(predictor.batch_times):
        print(f"  batch {i}: forward {t['device_ms']:.2f} ms (CUDA events); contours {t['contours_ms']:.2f} ms (host); "
              f"ACM {t['acm_ms']:.2f} ms ({t['acm_steps']} steps, CUDA events) over {t['rings']} rings, "
              f"{t['vertices']} vertices, bucket {t['bucket']}, {t['dropped']} rings dropped; post-processing "
              f"{t['post_ms']:.2f} ms (host); host stage {t['host_ms']:.2f} ms; wall {t['wall_ms']:.2f} ms", flush=True)
    return {"tiles_s": tiles_s, "batch_times": predictor.batch_times, "launches": launches, "results": results,
            "pred_file": pred_file}


def ffl_asm_oracle(overrides: list[str], device: torch.device) -> dict:
    """`method=[asm]` on the maps that the first B test tiles' ground truth
    implies (`ffl_oracle_maps`), on `device`, evaluated against those
    tiles: the IoU, the wall ms and the ASM's stages."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data import ensure_synthetic_dataset
    from pixelspointspolygons_torch.eval.metrics import compute_iou_ciou
    from pixelspointspolygons_torch.predict.ffl_polygonize import Polygonizer
    from pixelspointspolygons_torch.utils.coco import CocoIndex, generate_coco_ann

    cfg = compose(overrides + ["experiment.polygonization.method=[asm]"])
    ensure_synthetic_dataset(cfg)
    gt = CocoIndex(cfg.experiment.dataset.annotations["test"])
    ids = sorted(gt.imgs)[:B]
    gt = CocoIndex({**gt.dataset, "images": [gt.imgs[i] for i in ids],
                    "annotations": [a for a in gt.dataset["annotations"] if a["image_id"] in ids]})
    size = int(cfg.experiment.encoder.in_size)
    maps = [ffl_oracle_maps([s for a in gt.imgToAnns.get(i, []) for s in a["segmentation"]], size) for i in ids]
    seg, cf = np.stack([m[0] for m in maps]), np.stack([m[1] for m in maps])
    poly = Polygonizer(cfg.experiment.polygonization, device=device)
    t = time.perf_counter()
    out = poly(seg, cf, maps=(torch.from_numpy(seg).to(device), torch.from_numpy(cf).to(device)))
    wall_ms = (time.perf_counter() - t) * 1e3
    key = f"tol_{cfg.experiment.polygonization.asm_method.tolerance[0]}"
    anns = [a for i, polys in zip(ids, out["asm"][key]) for a in generate_coco_ann(polys, i)]
    iou = compute_iou_ciou(gt, gt.load_res(anns))
    return {"iou": iou["IoU"], "c_iou": iou["C-IoU"], "polygons": len(anns), "buildings": len(gt.anns),
            "wall_ms": wall_ms, "stats": dict(poly.stats["asm"]), "seg": seg, "cf": cf, "poly": poly}


def phase_ffl_asm(overrides: list[str]) -> dict:
    """ASM on the card: the ground truth's maps of one batch (IoU bound;
    the batch's ms split into skeleton, optimization and post-processing);
    its optimization on ASM_CPU_TILES tiles on the card against the CPU,
    after one step and after all; one step profiled at the batch's
    packing."""
    from pixelspointspolygons_torch.predict import ffl_asm

    res = ffl_asm_oracle(overrides, CARD)
    st = res["stats"]
    print(f"ffl ASM on the ground truth's maps of {B} test tiles (card): {res['wall_ms']:.1f} ms (wall) = skeleton "
          f"{st['skeleton_ms']:.1f} ms (host) + optimization {st['optimize_ms']:.1f} ms ({st['steps']} steps, CUDA "
          f"events) + post-processing {st['post_ms']:.1f} ms (host), contours {res['poly'].stats['contours_ms']:.1f} "
          f"ms; {st['nodes']} nodes, {st['paths']} paths, bucket {st['bucket']}, {st['dropped']} paths dropped; "
          f"{res['polygons']} polygons for {res['buildings']} buildings, IoU {res['iou']:.4f} C-IoU "
          f"{res['c_iou']:.4f} (IoU at least {ASM_ORACLE_MIN_IOU})", flush=True)
    if not res["iou"] >= ASM_ORACLE_MIN_IOU or st["steps"] <= 0:
        fail(f"ASM on the ground truth gave IoU {res['iou']}")

    mc = res["poly"].cfg.asm_method
    seg, cf = res["seg"][:ASM_CPU_TILES], res["cf"][:ASM_CPU_TILES]
    packed = ffl_asm.pack_skeletons(ffl_asm.skeleton_graphs(mc, seg))
    valid = packed[2]

    def asm_args(packed, seg, cf, device, steps=None):
        schedule, kw = ffl_asm.asm_kwargs(mc, steps)
        t = [torch.from_numpy(a).to(device) for a in packed[:7]]
        for i in (1, 4, 5):
            t[i] = t[i].long()
        maps = [torch.from_numpy(m).to(device) for m in (seg[:, 0], cf)]
        return t, maps, torch.from_numpy(schedule).to(device), kw

    def optimize(device, steps=None):
        t, maps, schedule, kw = asm_args(packed, seg, cf, device, steps)
        return ffl_asm.asm_optimize(*t, *maps, schedule, **kw).cpu().numpy()

    parted = {}
    for steps in (1, None):
        card = optimize(CARD, steps)
        cpu = optimize(torch.device("cpu"), steps)
        d = np.abs(card - cpu)[valid].max(1)
        parted["one" if steps else "all"] = {"max_px": float(d.max()), "median_px": float(np.median(d)),
                                             "far_share": float((d > ACM_FAR_PX).mean())}
    moved = float(np.abs(cpu - packed[0])[valid].max())
    print(f"ffl ASM card vs CPU on {ASM_CPU_TILES} tiles' ground-truth maps ({int(valid.sum())} nodes, bucket "
          f"{len(valid)}; nodes moved up to {moved:.3f} px): after one step {parted['one']} (median at most "
          f"{ASM_ONE_STEP_MEDIAN_PX} px, at most {ASM_ONE_STEP_SHARE} beyond {ACM_FAR_PX} px); after "
          f"{st['steps']} steps {parted['all']} (median at most {ASM_MEDIAN_PX} px; the share beyond {ACM_FAR_PX} px "
          f"printed, ROADMAP 3.10)", flush=True)
    if (moved <= 0.1 or parted["one"]["median_px"] > ASM_ONE_STEP_MEDIAN_PX
            or parted["one"]["far_share"] > ASM_ONE_STEP_SHARE or parted["all"]["median_px"] > ASM_MEDIAN_PX):
        fail(f"ASM on the card against the CPU: outside the bounds, or no node moved: {parted}")
    # the step at the whole batch's packing, the predict path's size
    whole = ffl_asm.pack_skeletons(ffl_asm.skeleton_graphs(mc, res["seg"]))
    profile = ffl_asm_profile(*asm_args(whole, res["seg"], res["cf"], CARD))
    return {"oracle": {k: v for k, v in res.items() if k not in ("seg", "cf", "poly")}, "parted": parted,
            "profile": profile}


def ffl_asm_profile(tensors: list, maps: list, schedule: torch.Tensor, kw: dict) -> dict:
    """One ASM step on the card, from runs of 1 and 11 steps (their
    difference over 10, so the set-up drops out): the step's wall time
    unprofiled (host clock, synchronized), and from torch.profiler traces
    the top-level aten calls, the kernels and their device time per step;
    the busy share is that time over the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pixelspointspolygons_torch.predict.ffl_asm import asm_optimize

    def run(steps):
        asm_optimize(*tensors, *maps, schedule[:steps], **kw)
        torch.cuda.synchronize()

    run(2)  # warm-up
    walls = {}
    for steps in (1, 11):
        t = time.perf_counter()
        run(steps)
        walls[steps] = time.perf_counter() - t
    ms_per_step = (walls[11] - walls[1]) * 1e3 / 10
    counts = []
    for steps in (1, 11):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(steps)
        events = prof.events()
        aten = [e for e in events if e.name.startswith("aten::")
                and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        counts.append((len(aten), len(kernels), sum(e.time_range.elapsed_us() for e in kernels)))
    per = [(b - a) / 10 for a, b in zip(*counts)]
    out = {"aten_per_step": per[0], "kernels_per_step": per[1], "kernel_us_per_step": per[2], "step_ms": ms_per_step}
    if per[1] <= 0:
        print("ffl ASM step profile: the profiler recorded no device kernels (busy share not measured)", flush=True)
        return out
    out["busy_share"] = per[2] / (ms_per_step * 1e3)
    print(f"ffl ASM step profile (K5; torch.profiler, steps 1..11, {len(tensors[0])} nodes): {per[0]:.1f} top-level "
          f"aten calls and {per[1]:.1f} kernels per step, {per[2]:.1f} us of kernel time per step: the card is busy "
          f"{100 * out['busy_share']:.1f} % of the {ms_per_step:.3f} ms step (unprofiled, steps 1..11)", flush=True)
    return out


def phase_ffl_training(overrides: list[str], smi: str) -> dict:
    """Phase 15: FFL-image training at float32 from FFL_SEED's weights
    (drawn on the CPU, taken up through `init_weights_from`), and ASM. Its
    bfloat16 half (the first step against float32's, the maps on the card
    against the CPU) and its bfloat16 prediction are phase 26's, from the
    same weights."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.ffl import build_ffl

    init = os.path.join(WORK, "ffl_seeded_init.pt")
    model = build_ffl(compose(overrides), generator=torch.Generator().manual_seed(FFL_SEED))
    torch.save({"model": model.state_dict()}, init)
    del model
    overrides = overrides + [f"init_weights_from={init}"]
    t = phase_ffl_train(overrides, "float32")
    print(f"ffl train path (float32): train step {t['step_ms']:.1f} ms, val step {t['val_ms']:.1f} ms, val-IoU "
          f"pass {t['iou_pass_ms']:.1f} ms (val IoU {t['val_iou']:.4f}), peak {t['peak_bytes']} bytes, loader "
          f"cold {t['loader_cold_ms']} and warm {t['loader_warm_ms']:.1f} ms per batch, by layer "
          f"{json.dumps({k: round(v, 2) for k, v in t['breakdown'].items()})}, card {smi}", flush=True)
    asm = phase_ffl_asm(overrides)
    return {"float32": t, "asm": asm}


# --- LiDAR and early fusion (phases 16-20) -------------------------------------


# --- repeatable prediction (ROADMAP 3.21) ---------------------------------------------

# path -> the pillar_sums launches of its two predictions
REPEATS: dict[str, list[int]] = {}


def leaves(x, path: str = ""):
    """(path, leaf) pairs of nested dicts, lists and tuples, in order."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, x


def leaf_bits(x) -> tuple:
    """A leaf's kind, dtype, shape and bytes."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return "tensor", str(t.dtype), tuple(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(x)
        return "array", str(a.dtype), a.shape, a.tobytes()
    if isinstance(x, float):
        return "float", np.float64(x).tobytes()
    return type(x).__name__, x


def hold_repeat(path: str, first, second, launches) -> None:
    """Fail unless two predictions of `path` are bitwise equal, leaf by leaf
    (the same structure, every tensor, array and file byte for byte);
    record the path with the pillar_sums launches of each prediction."""
    a = [(p, leaf_bits(x)) for p, x in leaves(first)]
    b = [(p, leaf_bits(x)) for p, x in leaves(second)]
    differ = [p for (p, x), (q, y) in zip(a, b) if p != q or x != y]
    if len(a) != len(b):
        differ.append(f"{len(a)} against {len(b)} leaves")
    size = sum(len(x[-1]) if isinstance(x[-1], bytes) else 1 for _, x in a)
    print(f"repeat check {path}: two predictions from the same weights on the same tiles, {len(a)} leaves "
          f"({size} bytes), bitwise equal {not differ}; pillar_sums launches {list(launches)}", flush=True)
    if differ:
        fail(f"{path}: two predictions from the same weights on the same tiles differ at {differ[:8]}")
    REPEATS[path] = list(launches)


# --- repeatable training (phase 27, ROADMAP 3.25) ---------------------------------

# every training path of the port, each run twice from one seed, the same
# weights and the same data; the phase that builds the path's trainer runs
# it, phase 27 the ones no earlier phase builds, and checks them all
TRAIN_REPEAT_PATHS = (
    "hisup_image_float32", "hisup_image_bfloat16", "p2p_image_float32", "p2p_image_bfloat16",
    "ffl_image_float32", "ffl_image_cache_float32", "ffl_image_cache_bfloat16", "hisup_lidar", "p2p_fusion",
    "hisup_fusion_cache_remat", "hisup_image_ddp", "ffl_unetresnet101", "ffl_convnext", "hisup_lidar_dense")
REPEAT_STEPS = 2
# phase 27's own paths: p2p_fusion at batch 16, hisup_fusion from the cache
# with remat at REPEAT_FUSION_BATCH (8: the time)
REPEAT_FUSION_BATCH = 8
# path -> what its two runs held (tensors, bytes, each run's kernel launches)
TRAIN_REPEATS: dict[str, dict] = {}


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.run_sums import run_sums_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda

    return {"afm": afm_cuda, "pillar_sums": pillar_sums_cuda, "run_sums": run_sums_cuda}


def deterministic_flags() -> dict:
    """The process's settings that `device.set_deterministic` makes."""
    return {"use_deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
            "warn_only": torch.is_deterministic_algorithms_warn_only_enabled(),
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "CUBLAS_WORKSPACE_CONFIG": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            "fill_uninitialized_memory": torch.utils.deterministic.fill_uninitialized_memory}


def check_deterministic(where: str) -> None:
    flags = deterministic_flags()
    print(f"{where}: {json.dumps(flags)}", flush=True)
    want = {"use_deterministic_algorithms": True, "warn_only": False, "cudnn.deterministic": True,
            "cudnn.benchmark": False, "CUBLAS_WORKSPACE_CONFIG": ":4096:8", "fill_uninitialized_memory": False}
    if flags != want:
        fail(f"{where}: the deterministic set-up is not in force: {flags}, expected {want}")


def number_calls(model, order: dict) -> list:
    """Hooks that number each module of `model` into `order` (name -> the
    rank of its first call); remove them after."""
    def hook(name):
        def record(module, inputs):
            order.setdefault(name, len(order))
        return record

    return [m.register_forward_pre_hook(hook(name)) for name, m in model.named_modules()]


def training_run(trainer, batches, args: tuple, order: dict | None = None) -> dict:
    """REPEAT_STEPS train steps through the trainer's own step, from the
    seeds set anew, with the kernel counters set to 0 just before and read
    just after. `batches()` gives the steps' batches. With `order`, each
    module's first call is numbered into it. Returns the batches, every
    step's losses, the first step's gradients, then every parameter and
    buffer, the optimizer's state and the launches."""
    state, model = trainer.state, trainer.state.model
    seed = int(trainer.cfg.get("seed", 42))
    torch.manual_seed(seed)
    if getattr(trainer, "generator", None) is not None:
        trainer.generator.manual_seed(seed)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    hooks = [] if order is None else number_calls(model, order)
    data = batches()
    losses, grads = [], {}
    try:
        for s in range(REPEAT_STEPS):
            metrics = trainer._train_step(state, data[s % len(data)], *args)
            losses.append({k: v.detach().clone() for k, v in metrics.items()})
            if s == 0:
                grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    optim = {f"{i}.{k}": v.detach().clone() for i, st in state.optimizer.state_dict()["state"].items()
             for k, v in st.items() if isinstance(v, torch.Tensor)}
    return {"batches": data[:REPEAT_STEPS], "losses": losses, "grads": grads,
            "state": {k: v.detach().clone() for k, v in model.state_dict().items()}, "optimizer": optim,
            "launches": {k: c.launches for k, c in counters.items()}}


def runs_differ(first: dict, second: dict) -> tuple[list, list, int]:
    """The leaves of two runs' records (but their launches), the paths where
    they differ (tensors compared bitwise on their device) and the bytes
    compared."""
    a = list(leaves({k: v for k, v in first.items() if k != "launches"}))
    b = list(leaves({k: v for k, v in second.items() if k != "launches"}))
    differ = [p for (p, x), (q, y) in zip(a, b) if p != q or not (
        same_bits(x, y) if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) else leaf_bits(x) == leaf_bits(y))]
    if len(a) != len(b):
        differ.append(f"{len(a)} against {len(b)} leaves")
    size = sum(x.numel() * x.element_size() for _, x in a if isinstance(x, torch.Tensor))
    return a, differ, size


def first_differing_module(order: dict, a: dict, b: dict) -> str:
    """The first module in forward order whose gradient differs between two
    runs' (name -> gradient), with the parameter and its largest gap."""
    differ = [n for n in a if n not in b or not same_bits(a[n], b[n])]
    if not differ:
        return "none"

    def rank(n):
        mod = n.rpartition(".")[0]
        return order.get(mod, len(order)), n

    n = min(differ, key=rank)
    gap = (a[n].double() - b[n].double()).abs().max().item() if n in b else float("nan")
    return f"{n.rpartition('.')[0] or '(model)'} ({n}, largest gap {gap:.3e}; {len(differ)} of {len(a)} differ)"


def train_twice(path: str, trainer, batches, args: tuple = (), expect: dict | None = None) -> dict:
    """Phase 27's check on one training path: from a snapshot of the
    trainer's weights, buffers, optimizer and schedule, two runs of
    REPEAT_STEPS steps from one seed on the same data (`training_run`),
    held bitwise: the batches, the losses, every gradient of the first
    step, every parameter and buffer (the BatchNorm running statistics),
    the optimizer's state and the kernel launches. `expect` names kernels
    that must launch in a run. On a mismatch prints the first module in
    forward order whose gradient differs, then fails. Leaves the trainer
    at its snapshot."""
    import copy

    state, model = trainer.state, trainer.state.model
    snap = {"model": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()),
            "scheduler": copy.deepcopy(state.scheduler.state_dict()), "step": state.step}
    fetch = batches if callable(batches) else (lambda: list(batches))
    runs, order = [], {}
    t0 = time.perf_counter()
    for run in range(2):
        model.load_state_dict(snap["model"])
        state.optimizer.load_state_dict(copy.deepcopy(snap["optimizer"]))
        state.scheduler.load_state_dict(snap["scheduler"])
        state.step = snap["step"]
        runs.append(training_run(trainer, fetch, args, order if run == 0 else None))
    wall = time.perf_counter() - t0
    model.load_state_dict(snap["model"])
    state.optimizer.load_state_dict(snap["optimizer"])
    state.scheduler.load_state_dict(snap["scheduler"])
    state.step = snap["step"]
    a, differ, size = runs_differ(runs[0], runs[1])
    launches = [r["launches"] for r in runs]
    losses = {k: float(v) for k, v in runs[0]["losses"][-1].items()}
    print(f"train repeat {path}: two runs of {REPEAT_STEPS} steps from one seed, the same weights and data, "
          f"{len(a)} tensors ({size} bytes: batches, losses, step-1 gradients, parameters and buffers, optimizer "
          f"state) bitwise equal {not differ}; launches {launches}; last losses {json.dumps(losses)}; "
          f"{wall:.1f} s", flush=True)
    if differ:
        print(f"train repeat {path}: first module in forward order whose gradient differs: "
              f"{first_differing_module(order, runs[0]['grads'], runs[1]['grads'])}; differing: {differ[:12]}",
              flush=True)
        fail(f"{path}: two training runs from one seed differ at {differ[:8]}")
    if launches[0] != launches[1]:
        fail(f"{path}: the two training runs launched the kernels {launches[0]} and {launches[1]} times")
    missing = [k for k, want in (expect or {}).items() if bool(launches[0][k]) != want]
    if missing:
        fail(f"{path}: kernel launches {launches[0]} against the expected {expect}")
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"{path}: non-finite losses {losses}")
    TRAIN_REPEATS[path] = {"tensors": len(a), "bytes": size, "launches": launches[0], "wall_s": wall}
    del runs
    gc.collect()
    return TRAIN_REPEATS[path]


def phase_repeat_training(smi: str) -> dict:
    """Phase 27: every training path run twice in one process from one seed
    (ROADMAP 3.25). The paths whose trainer an earlier phase builds were run
    there (`train_twice`); this phase prints the flags, runs p2p_fusion
    (batch 16, float32) and hisup_fusion from the device cache with remat
    (batch REPEAT_FUSION_BATCH, float32), and fails if a path was not held."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer
    from pixelspointspolygons_torch.train import trainer_pix2poly

    check_deterministic("phase 27, deterministic set-up")
    # p2p_fusion from the host loader
    cfg = compose(lidar_overrides("p2p_fusion") + ["host.compute_dtype=float32"])
    torch.cuda.empty_cache()
    trainer = trainer_pix2poly.Pix2PolyTrainer(cfg, device=CARD)
    trainer.generator = torch.Generator(device=CARD).manual_seed(int(cfg.get("seed", 42)))
    trainer.setup()
    host = list(itertools.islice(iter(trainer.train_loader), REPEAT_STEPS))
    batches = list(device_prefetch(host, CARD, trainer_pix2poly._DEV_KEYS))
    train_twice("p2p_fusion", trainer, batches, (trainer.generator,),
                {"afm": False, "pillar_sums": True, "run_sums": True})
    del trainer, batches, host
    # hisup_fusion from the device cache, with remat
    cfg = compose(lidar_overrides("hisup_fusion") + [
        "host.compute_dtype=float32", "training.remat=true", "training.device_cache=true",
        f"experiment.model.batch_size={REPEAT_FUSION_BATCH}", f"run_type.train_subset={REPEAT_STEPS * REPEAT_FUSION_BATCH}"])
    torch.cuda.empty_cache()
    trainer = HiSupTrainer(cfg, device=CARD)
    trainer.generator = torch.Generator(device=CARD).manual_seed(int(cfg.get("seed", 42)))
    trainer.setup()
    if trainer.cache is None:
        fail("hisup_fusion with remat: the trainer took the host loader, not the device cache")
    train_twice("hisup_fusion_cache_remat", trainer,
                lambda: list(itertools.islice(trainer.epoch_batches("train", 0, _DEV_KEYS), REPEAT_STEPS)), (),
                {"afm": True, "pillar_sums": True, "run_sums": True})
    del trainer
    torch.cuda.empty_cache()
    missing = [p for p in TRAIN_REPEAT_PATHS if p not in TRAIN_REPEATS]
    print(f"train repeats: {len(TRAIN_REPEATS)} training paths gave the same bits twice from one seed: "
          f"{json.dumps(TRAIN_REPEATS)}; card {smi}", flush=True)
    if missing:
        fail(f"the training repeat checks did not run for {missing}")
    return dict(TRAIN_REPEATS)


def predict_repeat(path: str, predictor) -> None:
    """The first test batch predicted twice through `predictor` (its device
    outputs as fetched to the host, then its host stage's polygons), held
    by `hold_repeat`."""
    from pixelspointspolygons_torch.data.loader import INPUT_KEYS, build_loader, to_device
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda

    cfg = predictor.cfg
    batch = next(iter(build_loader(cfg, cfg.evaluation.split, tokenizer=getattr(predictor, "tokenizer", None),
                                   eval_mode=True)))
    runs, launches = [], []
    for _ in range(2):
        pillar_sums_cuda.launches = 0
        outputs = predictor._fetch(predictor._dispatch(to_device(batch, predictor.device, INPUT_KEYS)))
        polygons = predictor.assemble(*outputs) if hasattr(predictor, "assemble") else predictor._host_stage(outputs)
        torch.cuda.synchronize()
        launches.append(pillar_sums_cuda.launches)
        runs.append({"outputs": outputs, "polygons": polygons})
    hold_repeat(path, runs[0], runs[1], launches)


def forward_repeat(path: str, model, name: str, batch: dict, y_input=None) -> None:
    """Two eval-mode forwards of `model` (family `name`) on `batch`, every
    output held by `hold_repeat`."""
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda

    runs, launches = [], []
    for _ in range(2):
        pillar_sums_cuda.launches = 0
        runs.append(model_outputs(model, name, batch, y_input))
        torch.cuda.synchronize()
        launches.append(pillar_sums_cuda.launches)
    hold_repeat(path, runs[0], runs[1], launches)


def fusion_isolation(model, inputs: dict) -> dict:
    """The early-fusion encoder of `model` (Pix2Poly, eval mode) on one
    batch of test tiles, FUSION_INDEX_ADD_RUNS times with the voxelizer's
    sums taken by `index_add_pillar_sums` (atomics, the port's route before
    `csrc/pillar_sums.cu`) and as many times with the port's own route; each
    stage of FUSION_STAGES compared bitwise with the first run's: the
    decorated features of `assign_pillars`, the PillarCanvas, the fusion
    conv, the encoder's tokens. Prints the first stage that differs for
    each route; fails if the port's route differs at any stage."""
    from pixelspointspolygons_torch.ops import voxelize

    enc = model.encoder
    canvas = enc.pillar_canvas

    def stages() -> dict:
        out = {}

        def features(module, args):
            points, valid = args
            out["features"] = voxelize.assign_pillars(points, valid, max_points_per_voxel=module.max_points_per_voxel,
                                                      **module.grid).features

        hooks = [canvas.register_forward_pre_hook(features),
                 canvas.register_forward_hook(lambda m, a, o: out.__setitem__("canvas", o)),
                 enc.fusion_conv.register_forward_hook(lambda m, a, o: out.__setitem__("fusion_conv", o))]
        try:
            with torch.no_grad():
                out["tokens"] = model.eval().encode(inputs)
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        return {k: out[k] for k in FUSION_STAGES}

    found = {}
    for route in ("index_add_", "pillar_sums"):
        original = voxelize.pillar_sums_auto
        if route == "index_add_":
            voxelize.pillar_sums_auto = index_add_pillar_sums
        try:
            runs = [stages() for _ in range(FUSION_INDEX_ADD_RUNS)]
        finally:
            voxelize.pillar_sums_auto = original
        spread = {k: max(float((r[k].float() - runs[0][k].float()).abs().max()) for r in runs[1:]) for k in FUSION_STAGES}
        differ = [k for k in FUSION_STAGES if any(not same_bits(r[k], runs[0][k]) for r in runs[1:])]
        found[route] = {"first": differ[0] if differ else None, "differ": differ, "max_abs": spread}
        print(f"fusion encoder isolation ({route} centroid sums): {len(runs)} calls on {inputs['images'].shape[0]} test "
              f"tiles; stages that differ from the first call {differ or 'none'}; largest difference by stage {spread}",
              flush=True)
        print(f"first stage that differs ({route} centroid sums): {found[route]['first'] or 'none'}", flush=True)
    if found["pillar_sums"]["differ"]:
        fail(f"the fusion encoder is not repeatable with the port's pillar sums: {found['pillar_sums']}")
    return found


def lidar_overrides(experiment: str) -> list[str]:
    """The smoke split for a LiDAR or fusion experiment: the same synthetic
    tiles as the image phases (country CH, which the fusion experiments'
    `country: all` would otherwise regenerate), each cloud padded to the
    encoder's max_num_points (200,000)."""
    return smoke_overrides(TRAIN_STEPS * B, experiment=experiment) + ["experiment.dataset.country=CH"]


def phase_voxelizer(overrides: list[str]) -> dict:
    """Phase 16: the voxelizer and the PillarFeatureNet on the synthetic
    train split's first batch of 16 clouds at 200,000 points, at the
    per-pillar caps 4, 64 and 512: the pillar assignment on the card
    against the CPU (points, pillar ids, kept masks, counts and decorated
    features bitwise equal), the train-mode canvas of a
    seeded PillarCanvas on LIDAR_CANVAS_TILES clouds within
    LIDAR_CANVAS_TOL, the assignment, the canvas forward and its forward
    with backward timed by CUDA events on all 16 with their peak memory,
    and one call of assignment and canvas forward profiled (the baseline of
    K6, ROADMAP §2)."""
    import copy

    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.layers import init_flax_defaults
    from pixelspointspolygons_torch.models.pointpillars import PillarCanvas
    from pixelspointspolygons_torch.ops.voxelize import assign_pillars

    pts, valid, grid = lidar_batch(overrides)
    cpu = {"lidar": pts.cpu(), "lidar_mask": valid.cpu()}
    dim = int(compose(overrides).experiment.encoder.patch_feature_dim)
    print(f"voxelizer input: {tuple(pts.shape)} points ({pts.dtype}), {int(valid.sum())} valid "
          f"({float(valid.float().mean()) * 100:.1f} %), grid {grid}, PFN channels (64, {dim})", flush=True)
    out = {}
    for cap in LIDAR_CAPS:
        a = assign_pillars(pts, valid, max_points_per_voxel=cap, **grid)
        c = assign_pillars(cpu["lidar"], cpu["lidar_mask"], max_points_per_voxel=cap, **grid)
        torch.cuda.synchronize()
        for name in ("points", "pillar_id", "keep"):
            if not torch.equal(getattr(a, name).cpu(), getattr(c, name)):
                fail(f"voxelizer (cap {cap}): {name} differs between the card and the CPU")
        flat = (a.pillar_id + torch.arange(B, device=CARD)[:, None] * (a.n_cells + 1)).reshape(-1)
        counts = torch.bincount(flat[a.keep.reshape(-1)], minlength=B * (a.n_cells + 1)).cpu()
        cflat = (c.pillar_id + torch.arange(B)[:, None] * (c.n_cells + 1)).reshape(-1)
        if not torch.equal(counts, torch.bincount(cflat[c.keep.reshape(-1)], minlength=B * (c.n_cells + 1))):
            fail(f"voxelizer (cap {cap}): the per-pillar counts differ between the card and the CPU")
        feat_err = float((a.features.cpu() - c.features).abs().max())
        if not same_bits(a.features.cpu(), c.features):
            fail(f"voxelizer (cap {cap}): decorated features differ between the card and the CPU by {feat_err} px")

        canvas_cpu = PillarCanvas(max_points_per_voxel=cap, feat_channels=(64, dim), **grid)
        init_flax_defaults(canvas_cpu, torch.Generator().manual_seed(LIDAR_SEED))
        canvas = copy.deepcopy(canvas_cpu).to(CARD).train()
        n = LIDAR_CANVAS_TILES
        with torch.no_grad():
            got = canvas(pts[:n], valid[:n]).cpu()
            t = time.perf_counter()
            want = canvas_cpu.train()(cpu["lidar"][:n], cpu["lidar_mask"][:n])
            cpu_s = time.perf_counter() - t
        canvas_err = float((got - want).abs().max() / want.abs().max())
        stats_err = max(float((canvas.state_dict()[k].cpu() - v).abs().max() / v.abs().max().clamp(min=1e-12))
                        for k, v in canvas_cpu.state_dict().items() if "running" in k)
        if not (canvas_err <= LIDAR_CANVAS_TOL and stats_err <= LIDAR_CANVAS_TOL):
            fail(f"PillarCanvas (cap {cap}): the card differs from the CPU by {canvas_err} (canvas), "
                 f"{stats_err} (running statistics), relative")

        canvas.load_state_dict(canvas_cpu.state_dict())
        assign_ms = cuda_ms(lambda: assign_pillars(pts, valid, max_points_per_voxel=cap, **grid), 5, 3)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: canvas(pts, valid), 3, 3)

        def fwd_bwd():
            canvas(pts, valid).sum().backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_bwd_ms = cuda_ms(fwd_bwd, 2, 3)
        peak = torch.cuda.max_memory_allocated() - base
        kept = int(a.keep.sum())
        pillars = int((counts > 0).sum())
        out[cap] = {"assign_ms": assign_ms, "canvas_fwd_ms": fwd_ms, "canvas_fwd_bwd_ms": fwd_bwd_ms,
                    "fwd_bwd_peak_bytes": peak, "kept": kept, "pillars": pillars, "feat_err": feat_err,
                    "canvas_err": canvas_err}
        print(f"voxelizer cap {cap}: {kept} points kept in {pillars} pillars (card = CPU bitwise: points, ids, masks, "
              f"counts, decorated features); train-mode canvas on {n} "
              f"clouds rel err {canvas_err:.3g}, running statistics {stats_err:.3g} (tol {LIDAR_CANVAS_TOL}; CPU "
              f"{cpu_s:.1f} s); on {B} clouds (CUDA events): assignment {assign_ms:.2f} ms, canvas forward "
              f"{fwd_ms:.2f} ms, forward and backward {fwd_bwd_ms:.2f} ms, its peak {peak / 2**30:.2f} GiB above "
              f"the inputs", flush=True)
        if cap == 64:
            with torch.no_grad():
                out["profile"] = profile_call(lambda: canvas(pts, valid), f"assignment and canvas forward (K6 "
                                              f"baseline; cap {cap}, {B} clouds, train mode, no grad)")
        del canvas, canvas_cpu, a, c
    return out


def lidar_step_parts(trainer, batch: dict) -> dict:
    """One HiSup-LiDAR train step cut by CUDA events on the stream into the
    targets (with the AFM kernel), voxelization with the PillarFeatureNet,
    the ViT (the conv pyramid of the dense encoder), the map head with
    HiSup's heads, the losses, the backward and AdamW; the calls of
    train/hisup_step.py::make_train_step."""
    from pixelspointspolygons_torch.models.hisup.model import encode_targets, hisup_losses
    from pixelspointspolygons_torch.models.vit import token_map_head

    state = trainer.state
    model, enc = state.model, state.model.encoder
    weights = {k: float(v) for k, v in trainer.cfg.experiment.model.loss_weights.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    dense = not hasattr(enc, "pp_vit")  # PointPillarsDenseEncoder: the canvas, then its conv pyramid
    model.train()
    ev[0].record()
    targets = encode_targets(batch, S)
    ev[1].record()
    canvas = (enc if dense else enc.pp_vit).pillar_canvas(batch["lidar"], batch["lidar_mask"])
    ev[2].record()
    if dense:
        feats = enc.pyramid(canvas)
    else:
        b, ny, nx, c = canvas.shape
        tokens = enc.pp_vit.vit(tokens=canvas.reshape(b, ny * nx, c))[:, 1:]
    ev[3].record()
    outputs = model.heads(feats if dense else token_map_head(tokens, enc.conv0, enc.bn0, enc.out_size))
    ev[4].record()
    total = sum(weights[k] * v for k, v in hisup_losses(outputs, targets).items())
    ev[5].record()
    state.optimizer.zero_grad(set_to_none=True)
    total.backward()
    ev[6].record()
    state.optimizer.step()
    ev[7].record()
    torch.cuda.synchronize()
    names = ("targets", "voxelize_pfn", "pyramid" if dense else "vit", "head", "losses", "backward", "optimizer")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def lidar_train_card_against_cpu(cfg, first: dict, name: str = "hisup_lidar") -> dict:
    """One float32 train step on the tiles of `first` (of the first batch),
    from the first step's weights, on the card and on the CPU with
    fresh AdamW states: losses within LIDAR_LOSS_TOL relative, the two
    gradients within LIDAR_GRAD_TOL of each other in relative L2 over all
    parameters (the CPU path is held to the JAX package by
    tests/test_torch_slice_lidar.py)."""
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.train.hisup_step import make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler

    m = cfg.experiment.model
    lr = float(m.learning_rate)
    step = make_train_step({k: float(v) for k, v in m.loss_weights.items()}, S)
    res = {}
    for where, dev in (("card", CARD), ("cpu", torch.device("cpu"))):
        model = build_hisup(cfg, device=dev)
        model.load_state_dict(first["state"])
        opt = make_optimizer("adamw", model.parameters(), lr, weight_decay=float(m.weight_decay))
        state = TrainState(model, opt, make_scheduler(opt, lambda n: lr, lr))
        t = time.perf_counter()
        metrics = step(state, {k: v.to(dev) for k, v in first["batch"].items()})
        res[where] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
                     time.perf_counter() - t)
    (got, g_card, _), (want, g_cpu, cpu_s) = res["card"], res["cpu"]
    loss_err = {k: abs(got[k] / want[k] - 1.0) for k in want}
    grad_err = (sum(float(((g_card[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
                / sum(float((g_cpu[k] ** 2).sum()) for k in g_cpu)) ** 0.5
    print(f"{name} train step card vs CPU on {len(first['batch']['lidar'])} tiles from the first step's weights "
          f"(float32; CPU {cpu_s:.1f} s): losses {want}, rel err {loss_err} (tol {LIDAR_LOSS_TOL}); gradients rel L2 "
          f"{grad_err:.3g} (tol {LIDAR_GRAD_TOL})", flush=True)
    if not all(e <= LIDAR_LOSS_TOL for e in loss_err.values()):
        fail(f"the HiSup-LiDAR step's losses differ between card and CPU: {loss_err}")
    if not grad_err <= LIDAR_GRAD_TOL:
        fail(f"the HiSup-LiDAR step's gradients differ between card and CPU by {grad_err}")
    return {"loss_err": loss_err, "grad_err": grad_err}


def phase_hisup_lidar_train(overrides: list[str], name: str = "hisup_lidar",
                            encoder: str = "PointPillarsViTCNNEncoder", bf16_step: bool = True,
                            steps: int = TRAIN_STEPS, cpu_tiles: int = LIDAR_CPU_TILES) -> dict:
    """Phase 17: HiSup-LiDAR training at full width (pointpillars_vit_cnn:
    ViT-S/8 on a 28 x 28 pillar canvas, cap 64, heads of width 256, batch
    16, 200,000 points a cloud) through the trainer that `cli/train.py`
    builds: `steps` train + 1 val steps and the val-IoU pass with the
    kernel counters set to 0 just before and read just after (AFM once a
    step, the pillar sums once a forward); then the steady-state step and
    its parts on the first STEADY_BATCHES batches, the host loader, one
    step on `cpu_tiles` tiles on the card against the CPU, two eval
    forwards held bitwise (`name`), and with `bf16_step` one bfloat16 step
    on the first batch from the same weights against the float32 run's
    first step. Phase 25 runs it for the dense encoder (`encoder`)."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.run_sums import run_sums_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train.hisup_step import make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer

    cfg = compose(overrides + ["host.compute_dtype=float32"])
    trainer = HiSupTrainer(cfg, device=CARD)
    iou_pass_s, step_losses, first, loader_ms = [], [], {}, []
    record_steps(trainer, step_losses, iou_pass_s, first, loader_ms)
    torch.cuda.reset_peak_memory_stats()
    afm_cuda.launches = pillar_sums_cuda.launches = run_sums_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, pillar_launches, run_launches = afm_cuda.launches, pillar_sums_cuda.launches, run_sums_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    run_loader_ms = list(loader_ms)
    n_train, n_val = len(trainer.train_loader), len(trainer.val_loader)
    model = trainer.state.model
    losses = [{k: float(v) for k, v in m.items()} for m in step_losses]
    print(f"{name} train path (float32): {n_train} train + {n_val} val steps and the val-IoU pass in {wall:.1f} s "
          f"(set-up included), peak memory {peak / 2**30:.2f} GiB; afm launches {launches}, pillar_sums launches "
          f"{pillar_launches}, run_sums launches {run_launches}; encoder {type(model.encoder).__name__}", flush=True)
    print(f"{name} history: " + json.dumps(history), flush=True)
    print(f"{name} step losses: " + json.dumps(losses), flush=True)
    if (n_train, n_val) != (steps, VAL_STEPS) or len(losses) != n_train:
        fail(f"{name}: expected {steps} train and {VAL_STEPS} val steps, got {n_train}, {n_val}, "
             f"{len(losses)}")
    if not all(np.isfinite(v) for k, v in history.items() if k != "epoch"):
        fail(f"{name}: non-finite losses: {history}")
    if launches != n_train + n_val:
        fail(f"afm launched {launches} times in HiSup-LiDAR training, expected {n_train + n_val}")
    # a forward a train and a val step, and a batch of the val-IoU pass
    if pillar_launches != n_train + 2 * n_val:
        fail(f"{name}: the pillar_sums kernel launched {pillar_launches} times, expected {n_train + 2 * n_val}")
    # a train step's backward: the gather once, the two segment maxes' tie counts
    if run_launches != RUN_SUMS_PER_STEP * n_train:
        fail(f"{name}: the run_sums kernel launched {run_launches} times, expected {RUN_SUMS_PER_STEP * n_train}")
    if type(model.encoder).__name__ != encoder or first["batch"].get("images") is not None:
        fail(f"{name}: not the {encoder} on a LiDAR-only batch")
    if not trainer.manager.exists("latest") or not trainer.manager.exists("best_val_loss"):
        fail("the HiSup-LiDAR trainer wrote no latest/best_val_loss checkpoint")
    val_iou = history.get("val_iou")
    if val_iou is None or not 0.0 <= val_iou <= 1.0 or len(iou_pass_s) != 1:
        fail(f"the HiSup-LiDAR val-IoU pass gave no IoU in [0, 1]: {val_iou}")
    print(f"{name} val-IoU pass: {n_val * B} val tiles polygonized in {iou_pass_s[0] * 1e3:.1f} ms (wall), "
          f"val IoU {val_iou:.4f}", flush=True)

    trainer.train_loader.set_epoch(0)
    host = [b for _, b in zip(range(STEADY_BATCHES), trainer.train_loader)]
    batches = list(device_prefetch(host, trainer.device, _DEV_KEYS))
    trainer._train_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    times = []
    for batch in batches:
        t = time.perf_counter()
        trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times)
    t = time.perf_counter()
    trainer._val_step(trainer.state, batches[0])
    torch.cuda.synchronize()
    val_ms = (time.perf_counter() - t) * 1e3
    parts = [lidar_step_parts(trainer, batch) for batch in batches]
    breakdown = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    loader = statistics.median(run_loader_ms)
    print(f"{name} train step (float32) {step_ms:.1f} ms (median of {len(times)}: "
          f"{[round(x, 1) for x in times]}), val step {val_ms:.1f} ms; host loader {loader:.1f} ms per batch of {B} "
          f"(median of the run's {len(run_loader_ms)}: {[round(x, 1) for x in run_loader_ms]})", flush=True)
    print(f"{name} train step by layer (ms, CUDA events, median of {len(parts)}): {json.dumps(breakdown)}",
          flush=True)
    small = {**first, "batch": {k: v[:cpu_tiles] for k, v in first["batch"].items()}}
    card_cpu = lidar_train_card_against_cpu(cfg, small, name)
    train_twice(name, trainer, batches, (), {"afm": True, "pillar_sums": True, "run_sums": True})
    if bf16_step:
        forward_repeat(name, model, "hisup", {k: v[:2] for k, v in batches[0].items()})
    out = {"step_ms": step_ms, "val_ms": val_ms, "peak_bytes": peak, "iou_pass_ms": iou_pass_s[0] * 1e3,
           "val_iou": val_iou, "losses": losses, "breakdown": breakdown, "launches": launches,
           "pillar_launches": pillar_launches, "run_launches": run_launches, "loader_ms": loader, "card_cpu": card_cpu}
    if not bf16_step:
        out["forward_err"] = forward_against_cpu(name, model, "hisup", {k: v[:2] for k, v in batches[0].items()},
                                                 "float32")
        return out

    # one bfloat16 step from the same initial weights on the same first batch
    bcfg = compose(overrides + ["host.compute_dtype=bfloat16"])
    bmodel = build_hisup(bcfg, device=CARD, dtype=torch.bfloat16)
    bmodel.load_state_dict(first["state"])
    lr = float(bcfg.experiment.model.learning_rate)
    opt = make_optimizer("adamw", bmodel.parameters(), lr, weight_decay=float(bcfg.experiment.model.weight_decay))
    bstep = make_train_step({k: float(v) for k, v in bcfg.experiment.model.loss_weights.items()}, S)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    got = {k: float(v) for k, v in bstep(TrainState(bmodel, opt, make_scheduler(opt, lambda n: lr, lr)),
                                         batches[0]).items()}
    torch.cuda.synchronize()
    bf16_ms, bf16_peak = (time.perf_counter() - t) * 1e3, torch.cuda.max_memory_allocated()
    loss_err = {k: abs(got[k] / losses[0][k] - 1.0) for k in losses[0]}
    print(f"hisup_lidar first train step at bfloat16 from the same weights on the same batch: {got}; float32 "
          f"{losses[0]}; rel diff {loss_err} (tol {LIDAR_BF16_LOSS_TOL}); {bf16_ms:.1f} ms (its first call), peak "
          f"{bf16_peak / 2**30:.2f} GiB", flush=True)
    if not all(e <= LIDAR_BF16_LOSS_TOL for e in loss_err.values()):
        fail(f"the bfloat16 HiSup-LiDAR step's losses differ from float32's by {loss_err}")
    return {**out, "bf16_loss_err": loss_err}


def phase_p2p_fusion_predict(overrides: list[str]) -> dict:
    """Phase 18: Pix2Poly early-fusion prediction (early_fusion_vit at full
    width) of the 32-tile test split from a seeded random model written as
    `latest`, through the functions `cli/predict.py::main` calls, with the
    counters set to 0 just before and read just after (0 AFM launches);
    tiles per second and the encoder's ms per batch; on P2P_CPU_TILES tiles
    the encoder tokens on the card against the CPU (P2P_REL_TOL); the split
    predicted once more and its prediction file held to the first byte for
    byte; and the isolation of the encoder's stages (`fusion_isolation`)."""
    from pixelspointspolygons_torch.cli.predict import predict_and_evaluate
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import INPUT_KEYS, build_loader, to_device
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer, build_pix2poly
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train.state import TrainState, linear_warmup_decay, make_optimizer, make_scheduler
    from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager

    cfg = compose(overrides + ["evaluation=test", "checkpoint=latest"])
    tokenizer = Tokenizer(cfg)
    model = build_pix2poly(cfg, tokenizer, device=CARD, generator=torch.Generator(device=CARD).manual_seed(P2P_SEED))
    lr = float(cfg.experiment.model.learning_rate)
    opt = make_optimizer("adamw", model.parameters(), lr)
    CheckpointManager(cfg.output_dir).save(
        "latest", TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(lr, 1000), lr)), 0, cfg)
    del model, opt
    afm_cuda.launches = pillar_sums_cuda.launches = 0
    t0 = time.perf_counter()
    predictor, results = predict_and_evaluate(cfg, CARD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, pillar_launches = afm_cuda.launches, pillar_sums_cuda.launches
    with open(cfg.evaluation.pred_file.replace(".json", "_time.json")) as f:
        timing = json.load(f)
    encoder = type(predictor.model.encoder).__name__
    if launches or not pillar_launches or timing["num_images"] != TEST_TILES or encoder != "EarlyFusionViTEncoder":
        fail(f"p2p_fusion prediction: {launches} afm launches, {pillar_launches} pillar_sums launches, "
             f"{timing['num_images']} tiles, encoder {encoder}")
    if not all(np.isfinite(results.get(k, np.nan)) for k in ("IoU", "C-IoU")):
        fail(f"p2p_fusion: non-finite metrics {results}")
    times = predictor.batch_times
    tiles_s = 1.0 / timing["prediction_time"]
    enc_ms = [t["encoder_ms"] for t in times]
    print(f"p2p_fusion predict path: {timing['num_images']} tiles in {len(times)} batches of {B}, {tiles_s:.2f} "
          f"tiles/s (the predictor's own s/tile over its loop), set-up, loop, files and evaluation {wall:.1f} s; "
          f"encoder {[round(x, 2) for x in enc_ms]} ms per batch (CUDA events), decode loop "
          f"{[round(t['decode_ms'], 1) for t in times]} ms ({[t['steps'] for t in times]} steps), ScoreNets "
          f"{[round(t['scorenet_ms'], 2) for t in times]} ms; afm launches {launches}, pillar_sums launches "
          f"{pillar_launches}; IoU {results['IoU']:.4f}", flush=True)
    with open(cfg.evaluation.pred_file, "rb") as f:
        first_file = f.read()
    pillar_sums_cuda.launches = 0
    predictor.predict_dataset(cfg.evaluation.split)
    torch.cuda.synchronize()
    with open(cfg.evaluation.pred_file, "rb") as f:
        hold_repeat("p2p_fusion", first_file, f.read(), (pillar_launches, pillar_sums_cuda.launches))

    batch = next(iter(build_loader(cfg, "test", tokenizer=tokenizer, eval_mode=True)))
    isolation = fusion_isolation(predictor.model, to_device(batch, CARD, INPUT_KEYS))
    small = {k: v[:P2P_CPU_TILES] for k, v in batch.items()}
    cpu_model = build_pix2poly(cfg, tokenizer)
    cpu_model.load_state_dict({k: v.cpu() for k, v in predictor.model.state_dict().items()})
    with torch.no_grad():
        got = predictor.model.eval().encode(to_device(small, CARD, INPUT_KEYS)).cpu()
        want = cpu_model.eval().encode(to_device(small, torch.device("cpu"), INPUT_KEYS))
    err = float((got - want).abs().max() / want.abs().max())
    print(f"p2p_fusion encoder tokens card vs CPU on {P2P_CPU_TILES} tiles: {tuple(got.shape)}, max rel err {err:.3g} "
          f"(tol {P2P_REL_TOL})", flush=True)
    if not err <= P2P_REL_TOL:
        fail(f"p2p_fusion encoder tokens differ between card and CPU by {err}")
    return {"tiles_s": tiles_s, "encoder_ms": enc_ms, "batch_times": times, "launches": launches,
            "pillar_launches": pillar_launches, "results": results, "token_err": err, "isolation": isolation}


def model_outputs(model, name: str, batch: dict, y_input=None) -> dict:
    """The eval-mode outputs of a model of family `name` on `batch`."""
    from pixelspointspolygons_torch.data.loader import INPUT_KEYS

    inputs = {k: batch[k] for k in INPUT_KEYS if k in batch}
    with torch.no_grad():
        if name == "pix2poly":
            logits, perm = model.eval()(inputs, y_input)
            return {"logits": logits, "perm": perm}
        return dict(model.eval()(inputs))


def forward_against_cpu(path: str, model, name: str, small: dict, dtype: str) -> dict:
    """An eval forward of `model` (family `name`) on the tiles of `small`
    on the card against a copy on the CPU: LIDAR_FWD_TOL relative to each
    output's largest value at float32, HISUP_BF16_REL_L2 in relative L2 at
    bfloat16; and two forwards on the card held bitwise (`forward_repeat`)."""
    import copy

    y_input = small["y"][:, :-1] if name == "pix2poly" else None
    cpu_model = copy.deepcopy(model).cpu()
    got = model_outputs(model, name, small, y_input)
    forward_repeat(path, model, name, small, y_input)
    want = model_outputs(cpu_model, name, {k: v.cpu() for k, v in small.items()},
                         None if y_input is None else y_input.cpu())
    if dtype == "float32":
        errs = {k: float((got[k].cpu().float() - v.float()).abs().max() / v.float().abs().max().clamp(min=1e-12))
                for k, v in want.items()}
    else:
        errs = {k: rel_l2(got[k].cpu(), v) for k, v in want.items()}
    tol = LIDAR_FWD_TOL if dtype == "float32" else HISUP_BF16_REL_L2
    print(f"{path}: eval forward on {len(small['lidar'])} tiles card vs CPU {errs} (tol {tol}, "
          + ("max relative" if dtype == "float32" else "relative L2") + ")", flush=True)
    if not all(e <= tol for e in errs.values()):
        fail(f"{path}: the forward differs between the card and the CPU: {errs}")
    return errs


def phase_lidar_steps() -> dict:
    """Phase 19: one train step at batch 16 through the trainers' set-up
    for p2p_lidar, hisup_fusion (at LIDAR_STEP_DTYPE's dtype), ffl_lidar
    and ffl_fusion, with the counters set to 0 just before and read just
    after (hisup_fusion's targets launch the AFM once), a second step
    timed, the peak memory of both, and a forward on LIDAR_FWD_TILES tiles
    from the stepped weights on the card against the CPU (LIDAR_FWD_TOL relative
    to each output's largest value)."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train import trainer_ffl, trainer_hisup, trainer_pix2poly

    trainers = {"pix2poly": (trainer_pix2poly.Pix2PolyTrainer, trainer_pix2poly._DEV_KEYS),
                "hisup": (trainer_hisup.HiSupTrainer, trainer_hisup._DEV_KEYS),
                "ffl": (trainer_ffl.FFLTrainer, trainer_ffl.FFL_BATCH_KEYS)}
    out = {}
    for experiment, dtype in LIDAR_STEP_DTYPE.items():
        cfg = compose(lidar_overrides(experiment) + [f"host.compute_dtype={dtype}"])
        name = cfg.experiment.model.name
        cls, keys = trainers[name]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = cls(cfg, device=CARD)
        trainer.generator = torch.Generator(device=CARD).manual_seed(int(cfg.get("seed", 42)))
        trainer.setup()
        batch = next(iter(device_prefetch(trainer.train_loader, CARD, keys)))
        if name == "ffl":
            args = (trainer._weights_for_epoch(0),)
        else:
            args = (trainer.generator,) if name == "pix2poly" else ()
        afm_cuda.launches = pillar_sums_cuda.launches = 0
        metrics = {k: float(v) for k, v in trainer._train_step(trainer.state, batch, *args).items()}
        torch.cuda.synchronize()
        launches, pillar_launches = afm_cuda.launches, pillar_sums_cuda.launches
        t = time.perf_counter()
        trainer._train_step(trainer.state, batch, *args)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated()
        want_launches = 1 if name == "hisup" else 0
        if not all(np.isfinite(v) for v in metrics.values()) or launches != want_launches or not pillar_launches:
            fail(f"{experiment}: the step gave {metrics} with {launches} afm launches (expected {want_launches}) and "
                 f"{pillar_launches} pillar_sums launches")

        model = trainer.state.model
        print(f"{experiment} ({dtype}, encoder {type(model.encoder).__name__}): one train step at batch {B}: losses "
              f"{ {k: round(v, 6) for k, v in metrics.items()} }, afm launches {launches}; the next step {step_ms:.1f} "
              f"ms; peak {peak / 2**30:.2f} GiB", flush=True)
        errs = forward_against_cpu(experiment, model, name, {k: v[:LIDAR_FWD_TILES] for k, v in batch.items()},
                                   dtype)
        out[experiment] = {"step_ms": step_ms, "peak_bytes": peak, "launches": launches, "losses": metrics,
                           "errs": errs, "dtype": dtype, "pillar_launches": pillar_launches}
        del trainer, model, batch
    return out


def phase_ffl_lidar_demo() -> float:
    """Phase 20: `cli.predict_demo` on one test tile of ffl_lidar from a
    seeded random model written as `latest`, its LiDAR from a .laz file
    that the port's `write_laz` wrote from the tile's points."""
    from pixelspointspolygons_torch.cli import predict_demo
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.dataset import P3Dataset, load_lidar_file
    from pixelspointspolygons_torch.laz import read_laz, write_laz
    from pixelspointspolygons_torch.models.ffl import build_ffl
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train.state import TrainState, linear_warmup_decay, make_optimizer, make_scheduler
    from pixelspointspolygons_torch.utils.checkpoint import CheckpointManager

    overrides = lidar_overrides("ffl_lidar")
    cfg = compose(overrides)
    model = build_ffl(cfg, device=CARD, generator=torch.Generator(device=CARD).manual_seed(FFL_SEED))
    lr = float(cfg.experiment.model.learning_rate)
    opt = make_optimizer("adam", model.parameters(), lr)
    CheckpointManager(cfg.output_dir).save(
        "latest", TrainState(model, opt, make_scheduler(opt, linear_warmup_decay(lr, 1000), lr)), 0, cfg)
    del model, opt
    info = next(iter(P3Dataset(cfg, "test").coco.imgs.values()))
    pts = load_lidar_file(os.path.join(cfg.experiment.dataset.in_path, info["lidar_path"]))
    laz_file = os.path.join(WORK, "ffl_lidar_tile.laz")
    nbytes = write_laz(laz_file, pts)
    back = read_laz(laz_file)
    laz_err = float(np.abs(back - pts).max())
    cwd = os.getcwd()
    os.chdir(WORK)
    try:
        t = time.perf_counter()
        pillar_sums_cuda.launches = 0
        polys, out_file = predict_demo.main(overrides + ["checkpoint=latest", f"+lidar_file={laz_file}"])
        pillar_launches = pillar_sums_cuda.launches
        demo_s = time.perf_counter() - t
        ok = os.path.isfile(out_file)
    finally:
        os.chdir(cwd)
    print(f"ffl_lidar predict_demo from {os.path.basename(laz_file)} ({len(pts)} points, {nbytes} bytes, decoded "
          f"within {laz_err:.3g} of the tile's points): {len(polys)} polygons, {out_file} written {ok}, {demo_s:.2f} s; "
          f"pillar_sums launches {pillar_launches}", flush=True)
    if not ok or not laz_err <= 0.0051 or not pillar_launches:
        fail(f"ffl_lidar predict_demo wrote no png, or the .laz round trip moved the points, or it launched the "
             f"pillar_sums kernel {pillar_launches} times")
    return pillar_launches


# --- the device cache and remat (phase 21) ------------------------------------------


def batcher_times(cache, epoch: int = 0) -> tuple[list, list]:
    """Per batch of one epoch of `cache`: the ms of one `next(epoch_batches)`
    by CUDA events (from an idle card) and by the host clock to a
    synchronize."""
    it = cache.epoch_batches(epoch)
    events, wall = [], []
    while True:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        batch = next(it, None)
        end.record()
        torch.cuda.synchronize()
        if batch is None:
            return events, wall
        events.append(start.elapsed_time(end))
        wall.append((time.perf_counter() - t) * 1e3)


def cache_setup_line(trainer) -> str:
    return "; ".join(f"{split}: {c.n} tiles, {c.nbytes} bytes, packed or loaded in {c.pack_s:.2f} s, uploaded in "
                     f"{c.upload_s:.3f} s" for split, c in trainer.cache.items())


def epoch_wall_ms(trainer, batches, *args) -> float:
    """Host ms per train step over `batches` (their making included), to a
    synchronize at the end."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = 0
    for batch in batches:
        trainer._train_step(trainer.state, batch, *args)
        n += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def run_cached_trainer(cls, cfg, what: str) -> tuple:
    """The trainer of `cfg` (training.device_cache=true) through train():
    4 train + 1 val steps and the val-IoU pass with the counters set to 0
    just before and read just after; fails if it took the host loader."""
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda

    torch.cuda.empty_cache()
    trainer = cls(cfg, device=CARD)
    iou_pass_s, step_losses, first = [], [], {}
    record_steps(trainer, step_losses, iou_pass_s, first)
    torch.cuda.reset_peak_memory_stats()
    afm_cuda.launches = pillar_sums_cuda.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, peak = afm_cuda.launches, torch.cuda.max_memory_allocated()
    pillar_launches = pillar_sums_cuda.launches
    if trainer.cache is None:
        fail(f"{what}: the trainer took the host loader, not the device cache")
    n_train, n_val = len(trainer.cache["train"]), len(trainer.cache["val"])
    losses = [{k: float(v) for k, v in m.items()} for m in step_losses]
    print(f"{what} from the device cache: {n_train} train + {n_val} val steps and the val-IoU pass in {wall:.1f} s "
          f"(set-up included), peak {peak / 2**30:.2f} GiB, afm launches {launches}; cache {cache_setup_line(trainer)}",
          flush=True)
    print(f"{what} history: " + json.dumps(history), flush=True)
    if (n_train, n_val) != (TRAIN_STEPS, VAL_STEPS) or len(losses) != n_train:
        fail(f"{what}: expected {TRAIN_STEPS} train and {VAL_STEPS} val steps, got {n_train}, {n_val}, {len(losses)}")
    if not all(np.isfinite(v) for k, v in history.items() if k != "epoch"):
        fail(f"{what}: non-finite losses: {history}")
    val_iou = history.get("val_iou")
    if val_iou is None or not 0.0 <= val_iou <= 1.0 or len(iou_pass_s) != 1:
        fail(f"{what}: the val-IoU pass gave no IoU in [0, 1]: {val_iou}")
    return trainer, {"launches": launches, "peak_bytes": peak, "losses": losses, "first": first,
                     "val_iou": val_iou, "iou_pass_ms": iou_pass_s[0] * 1e3, "pillar_launches": pillar_launches}


def steady_step_ms(trainer, batches: list, *args) -> float:
    trainer._train_step(trainer.state, batches[0], *args)
    torch.cuda.synchronize()
    times = []
    for batch in batches:
        t = time.perf_counter()
        trainer._train_step(trainer.state, batch, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def ffl_step_losses(cfg, state_dict: dict, batch: dict, weights: dict) -> dict:
    """The losses of one float32 FFL train step from `state_dict` on `batch`."""
    from pixelspointspolygons_torch.models.ffl import build_ffl
    from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
    from pixelspointspolygons_torch.train.ffl_step import make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler

    model = build_ffl(cfg, device=CARD)
    model.load_state_dict(state_dict)
    lr = float(cfg.experiment.model.learning_rate)
    opt = make_optimizer("adam", model.parameters(), lr)
    loss_fn, _ = make_ffl_loss(cfg)
    state = TrainState(model, opt, make_scheduler(opt, lambda n: lr, lr))
    return {k: float(v) for k, v in make_train_step(loss_fn)(state, batch, weights).items()}


def ffl_losses_against_host(cfg, loader, cache, state_dict: dict, weights: dict, got: dict, tol: float,
                            what: str) -> dict:
    """`got`, the losses of a step on the cache's first batch of epoch 0,
    against a step from the same weights on the host loader's batch of the
    same tiles; each term within `tol` relative."""
    from pixelspointspolygons_torch.data.loader import to_device
    from pixelspointspolygons_torch.train.trainer_ffl import FFL_BATCH_KEYS

    order = np.arange(cache.n)
    np.random.RandomState(cache.seed).shuffle(order)
    loader.set_epoch(0)
    host = to_device(loader._make_batch(order[:B]), CARD, FFL_BATCH_KEYS)
    want = ffl_step_losses(cfg, state_dict, host, weights)
    err = {k: abs(got[k] / want[k] - 1.0) for k in want}
    print(f"{what}: first step from the cache {got}; from the host loader's batch of the same tiles {want}; rel diff "
          f"{err} (tol {tol})", flush=True)
    if set(err) != set(got) or not all(e <= tol for e in err.values()):
        fail(f"{what}: the cache's first-step losses differ from the host loader's by {err}")
    return err


def ffl_cache_train(overrides: list[str], dtype: str, smi: str) -> dict:
    """FFL-image from the device cache at `dtype`: the run, the step, the
    batcher, the wall per train batch from the cache and from the host
    loader in turns; at float32 the first step's losses against a step on
    the host loader's batch of the same tiles from the same weights."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.device_cache import FFLDeviceCache
    from pixelspointspolygons_torch.data.loader import build_loader
    from pixelspointspolygons_torch.train.trainer_ffl import FFL_BATCH_KEYS, FFLTrainer

    cfg = compose(overrides + [f"host.compute_dtype={dtype}", "training.device_cache=true"])
    what = f"ffl_image ({dtype})"
    trainer, run = run_cached_trainer(FFLTrainer, cfg, what)
    if run["launches"]:
        fail(f"{what} from the cache launched the afm kernel {run['launches']} times, expected 0")
    cache = trainer.cache["train"]
    events, wall = batcher_times(cache)
    weights = trainer._weights_for_epoch(0)
    batches = [{k: b[k] for k in FFL_BATCH_KEYS if k in b} for b in cache.epoch_batches(0)]
    step_ms = steady_step_ms(trainer, batches, weights, None)
    turns = []
    for source in ("cache", "host"):
        saved = trainer.cache
        trainer.cache = saved if source == "cache" else None
        turns.append((source, epoch_wall_ms(trainer, trainer.epoch_batches("train", 1, FFL_BATCH_KEYS), weights, None)))
        trainer.cache = saved
    by = {src: [round(ms, 1) for s, ms in turns if s == src] for src in ("cache", "host")}
    print(f"{what} from the cache: train step {step_ms:.1f} ms (median of {len(batches)}); batcher per batch of {B}: "
          f"{[round(x, 3) for x in events]} ms (CUDA events), {[round(x, 3) for x in wall]} ms (host clock); wall per "
          f"train batch, in turns: cache {by['cache']} ms, host loader {by['host']} ms; peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; val IoU {run['val_iou']:.4f}; card {smi}", flush=True)
    out = {"step_ms": step_ms, "batcher_ms": statistics.median(events), "batcher_wall_ms": statistics.median(wall),
           "wall_cache_ms": by["cache"], "wall_host_ms": by["host"], **run,
           "cache_bytes": sum(c.nbytes for c in trainer.cache.values()),
           "pack_s": {k: c.pack_s for k, c in trainer.cache.items()},
           "upload_s": {k: c.upload_s for k, c in trainer.cache.items()}}
    train_twice(f"ffl_image_cache_{dtype}", trainer,
                lambda: list(itertools.islice(trainer.epoch_batches("train", 0, FFL_BATCH_KEYS), REPEAT_STEPS)),
                (weights, None), {"afm": False, "pillar_sums": False, "run_sums": False})
    if dtype != "float32":
        return out

    # the first step's losses against a step on the host loader's batch of
    # the same tiles (the loader's per-item streams give the same D4 and
    # jitter), from the same weights; then the same without GaussNoise
    out["loss_err"] = ffl_losses_against_host(cfg, trainer.train_loader, cache, run["first"]["state"], weights,
                                              run["losses"][0], FFL_CACHE_LOSS_TOL, what)
    quiet = compose(overrides + ["host.compute_dtype=float32", "experiment.encoder.augmentations=[D4,ColorJitter,Normalize]"])
    quiet_cache = FFLDeviceCache(quiet, "train", CARD)
    first = {k: v for k, v in next(iter(quiet_cache.epoch_batches(0))).items() if k in FFL_BATCH_KEYS}
    quiet_loader = build_loader(quiet, "train")
    got = ffl_step_losses(quiet, run["first"]["state"], first, weights)
    out["noiseless_loss_err"] = ffl_losses_against_host(quiet, quiet_loader, quiet_cache, run["first"]["state"],
                                                        weights, got, FFL_CACHE_NOISELESS_TOL, f"{what} without noise")
    return out


def cache_card_against_cpu(p2p_overrides: list[str], ffl_overrides: list[str]) -> dict:
    """The cache's first train batch of epoch 0 on the card against the same
    batch on the CPU, from the same pack, GaussNoise left out: FFL-image,
    HiSup-fusion and Pix2Poly-image."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data import device_cache as dc
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer

    out = {}
    for experiment, overrides in (("ffl_image", ffl_overrides), ("hisup_fusion", lidar_overrides("hisup_fusion")),
                                  ("p2p_image", p2p_overrides)):
        cfg = compose(overrides)
        augs = [a for a in cfg.experiment.encoder.augmentations if a != "GaussNoise"]
        cfg.experiment.encoder.augmentations = augs
        family = cfg.experiment.model.name
        if family == "pix2poly":
            card, cpu = (dc.P2PDeviceCache(cfg, "train", Tokenizer(cfg), d) for d in (CARD, "cpu"))
        elif family == "hisup":
            card, cpu = (dc.HiSupDeviceCache(cfg, "train", d) for d in (CARD, "cpu"))
        else:
            card, cpu = (dc.FFLDeviceCache(cfg, "train", d) for d in (CARD, "cpu"))
        got, want = next(iter(card.epoch_batches(0))), next(iter(cpu.epoch_batches(0)))
        if set(got) != set(want):
            fail(f"cache {experiment}: the card's batch has leaves {sorted(got)}, the CPU's {sorted(want)}")
        equal, image_err = [], None
        for k, w in want.items():
            g = got[k].cpu() if torch.is_tensor(got[k]) else torch.from_numpy(np.asarray(got[k]))
            w = w if torch.is_tensor(w) else torch.from_numpy(np.asarray(w))
            if k in ("lidar", "lidar_mask"):
                continue
            if k == "images":
                image_err = float((g - w).abs().max())
                if not image_err <= CACHE_IMAGE_TOL:
                    fail(f"cache {experiment}: the card's images differ from the CPU's by {image_err}")
            elif g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"cache {experiment}: leaf {k} differs between the card and the CPU")
            else:
                equal.append(k)
        if "lidar" in want:
            pts, mask = got["lidar"].cpu(), got["lidar_mask"].cpu()
            if not torch.equal(mask.sum(1), want["lidar_mask"].sum(1)):
                fail(f"cache {experiment}: the clouds' point counts differ between the card and the CPU")
            for b in range(B):
                g, w = pts[b][mask[b]].numpy(), want["lidar"][b][want["lidar_mask"][b]].numpy()
                if not np.array_equal(g[np.lexsort(g.T[::-1])], w[np.lexsort(w.T[::-1])]):
                    fail(f"cache {experiment}: cloud {b} differs between the card and the CPU as a set")
            equal.append("lidar (as sets)")
        print(f"cache {experiment}: the card's first batch (augmentations {augs}) against the CPU's: equal {equal}; "
              f"images max abs err {image_err} (tol {CACHE_IMAGE_TOL})", flush=True)
        out[experiment] = {"equal": equal, "image_err": image_err}
        del card, cpu
    return out


def hisup_lidar_cache_remat(smi: str) -> dict:
    """HiSup-LiDAR from the cache with remat through the trainer (5 AFM
    launches), its step, layers, peak, the cache's cap, the voxelizer and
    PFN at that cap; then one step with remat and one without from the same
    weights on the same cached batch."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.ops.voxelize import assign_pillars
    from pixelspointspolygons_torch.train.hisup_step import make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer

    cfg = compose(lidar_overrides("hisup_lidar") + ["host.compute_dtype=float32", "training.device_cache=true",
                                                    "training.remat=true"])
    trainer, run = run_cached_trainer(HiSupTrainer, cfg, "hisup_lidar (float32, remat)")
    if not run["pillar_launches"]:
        fail("HiSup-LiDAR training from the cache launched the pillar_sums kernel no time")
    if run["launches"] != TRAIN_STEPS + VAL_STEPS:
        fail(f"afm launched {run['launches']} times in HiSup-LiDAR training from the cache, expected "
             f"{TRAIN_STEPS + VAL_STEPS}")
    cache = trainer.cache["train"]
    cap = int(cache.dev["lidar"].shape[1])
    events, wall = batcher_times(cache)
    batches = [{k: b[k] for k in _DEV_KEYS if k in b} for b in cache.epoch_batches(0)]
    step_ms = steady_step_ms(trainer, batches)
    parts = [lidar_step_parts(trainer, batch) for batch in batches]
    breakdown = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    enc = cfg.experiment.encoder
    pts, valid = batches[0]["lidar"], batches[0]["lidar_mask"]
    grid = dict(width=float(enc.in_width), height=float(enc.in_height), voxel_x=float(enc.in_voxel_size.x),
                voxel_y=float(enc.in_voxel_size.y), max_points_per_voxel=int(enc.max_num_points_per_voxel))
    canvas = trainer.state.model.encoder.pp_vit.pillar_canvas
    assign_ms = cuda_ms(lambda: assign_pillars(pts, valid, **grid), 5, 3)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: canvas(pts, valid), 3, 3)
    print(f"hisup_lidar from the cache with remat: train step {step_ms:.1f} ms (median of {len(batches)}); the plain "
          f"step by layer on the cached batches (ms, CUDA events): {json.dumps(breakdown)}; peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; point cap {cap} (the host loader's {int(enc.max_num_points)}), "
          f"{int(valid.sum())} valid points in the first batch; at that cap on {B} clouds: assignment "
          f"{assign_ms:.2f} ms, canvas forward {fwd_ms:.2f} ms; batcher per batch {[round(x, 3) for x in events]} ms "
          f"(CUDA events), {[round(x, 3) for x in wall]} ms (host clock); val IoU {run['val_iou']:.4f}; card {smi}",
          flush=True)

    # one step with remat and two without, from the same weights on the same batch
    sd = {k: v.detach().clone() for k, v in trainer.state.model.state_dict().items()}
    weights = {k: float(v) for k, v in cfg.experiment.model.loss_weights.items()}
    lr = float(cfg.experiment.model.learning_rate)
    del trainer
    res = []
    for remat in (False, False, True):
        torch.cuda.empty_cache()
        model = build_hisup(cfg, device=CARD)
        model.load_state_dict(sd)
        opt = make_optimizer("adamw", model.parameters(), lr, weight_decay=float(cfg.experiment.model.weight_decay))
        state = TrainState(model, opt, make_scheduler(opt, lambda n: lr, lr))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        metrics = make_train_step(weights, S, remat=remat)(state, batches[0])
        torch.cuda.synchronize()
        ms, peak = (time.perf_counter() - t) * 1e3, torch.cuda.max_memory_allocated()
        res.append(({k: float(v) for k, v in metrics.items()},
                    {n: p.grad.detach().double() for n, p in model.named_parameters()},
                    {n: b.detach().clone() for n, b in model.named_buffers()}, ms, peak))
        del model, opt, state

    def gaps(a, b) -> tuple[float, float, float]:
        loss = max(abs(b[0][k] / a[0][k] - 1.0) for k in a[0])
        grad = (sum(float(((b[1][k] - a[1][k]) ** 2).sum()) for k in a[1])
                / sum(float((a[1][k] ** 2).sum()) for k in a[1])) ** 0.5
        stats = max(float((b[2][k] - a[2][k]).abs().max() / a[2][k].abs().max().clamp(min=1e-12)) for k in a[2])
        return loss, grad, stats

    plain, again, remat_run = res
    noise = gaps(plain, again)
    loss_err, grad_err, stats_err = gaps(plain, remat_run)
    grad_tol = max(REMAT_GRAD_TOL, REMAT_NOISE_FACTOR * noise[1])
    b0, b1 = plain[2], remat_run[2]
    moved = max(float((b0[k] - sd[k]).abs().max() / sd[k].abs().max().clamp(min=1e-12)) for k in b0)
    counts = [k for k in b0 if k.endswith("num_batches_tracked")]
    ms0, peak0, ms1, peak1 = plain[3], plain[4], remat_run[3], remat_run[4]
    print(f"hisup_lidar one step with remat against one without (same weights, same cached batch): losses rel diff "
          f"{loss_err:.3g} (tol {REMAT_LOSS_TOL}), gradients rel L2 {grad_err:.3g} (tol {grad_tol:.3g}: two plain "
          f"steps read {noise[1]:.3g} apart, losses {noise[0]:.3g}, buffers {noise[2]:.3g}), BatchNorm buffers "
          f"({len(b0)}, num_batches_tracked: {len(counts)}) rel diff {stats_err:.3g} (tol {REMAT_STATS_TOL}; one "
          f"update moved them by up to {moved:.3g}); step {ms0:.1f} and {again[3]:.1f} ms, peak {peak0 / 2**30:.2f} "
          f"GiB without, {ms1:.1f} ms and {peak1 / 2**30:.2f} GiB with remat (first calls); card {smi}", flush=True)
    if not (loss_err <= REMAT_LOSS_TOL and grad_err <= grad_tol and stats_err <= REMAT_STATS_TOL):
        fail(f"remat: the step differs from the plain one: losses {loss_err}, gradients {grad_err}, "
             f"buffers {stats_err}")
    if set(b0) != set(b1) or any(not torch.equal(b0[k], b1[k]) for k in counts):
        fail("remat: the BatchNorm counts differ from the plain step's")
    return {"step_ms": step_ms, "breakdown": breakdown, "cap": cap, "assign_ms": assign_ms, "canvas_fwd_ms": fwd_ms,
            "batcher_ms": statistics.median(events), **run,
            "remat": {"loss_err": loss_err, "grad_err": grad_err, "stats_err": stats_err, "noise": noise,
                      "plain_ms": ms0, "remat_ms": ms1, "plain_peak": peak0, "remat_peak": peak1}}


def hisup_fusion_remat_step(smi: str) -> dict:
    """One hisup_fusion step at float32, batch 16, with remat, through the
    trainer's set-up on the host loader's first batch (1 AFM launch), as
    phase 19 runs it without remat."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer

    cfg = compose(lidar_overrides("hisup_fusion") + ["host.compute_dtype=float32", "training.remat=true"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = HiSupTrainer(cfg, device=CARD)
    trainer.generator = torch.Generator(device=CARD).manual_seed(int(cfg.get("seed", 42)))
    trainer.setup()
    batch = next(iter(device_prefetch(trainer.train_loader, CARD, _DEV_KEYS)))
    afm_cuda.launches = pillar_sums_cuda.launches = 0
    metrics = {k: float(v) for k, v in trainer._train_step(trainer.state, batch).items()}
    torch.cuda.synchronize()
    launches, pillar_launches = afm_cuda.launches, pillar_sums_cuda.launches
    t = time.perf_counter()
    trainer._train_step(trainer.state, batch)
    torch.cuda.synchronize()
    step_ms, peak = (time.perf_counter() - t) * 1e3, torch.cuda.max_memory_allocated()
    print(f"hisup_fusion (float32, remat): one train step at batch {B}: losses "
          f"{ {k: round(v, 6) for k, v in metrics.items()} }, afm launches {launches}; the next step {step_ms:.1f} ms; "
          f"peak {peak / 2**30:.2f} GiB (phase 19 takes the same step without remat); card {smi}", flush=True)
    if launches != 1 or not pillar_launches or not all(np.isfinite(v) for v in metrics.values()):
        fail(f"hisup_fusion with remat: {metrics} with {launches} afm launches (expected 1) and {pillar_launches} "
             f"pillar_sums launches")
    del trainer, batch
    return {"step_ms": step_ms, "peak_bytes": peak, "launches": launches, "pillar_launches": pillar_launches}


def p2p_cache_train(overrides: list[str], smi: str) -> dict:
    """Pix2Poly-image from the device cache at float32: 4 train + 1 val steps
    and the val-IoU pass (0 AFM launches), the step and the batcher."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.train.trainer_pix2poly import _DEV_KEYS, Pix2PolyTrainer

    cfg = compose(overrides + ["host.compute_dtype=float32", "training.device_cache=true"])
    trainer, run = run_cached_trainer(Pix2PolyTrainer, cfg, "p2p_image (float32)")
    if run["launches"]:
        fail(f"Pix2Poly from the cache launched the afm kernel {run['launches']} times, expected 0")
    cache = trainer.cache["train"]
    events, wall = batcher_times(cache)
    batches = [{k: b[k] for k in _DEV_KEYS if k in b} for b in cache.epoch_batches(0)]
    step_ms = steady_step_ms(trainer, batches, trainer.generator)
    print(f"p2p_image from the cache: train step {step_ms:.1f} ms (median of {len(batches)}); batcher per batch "
          f"{[round(x, 3) for x in events]} ms (CUDA events), {[round(x, 3) for x in wall]} ms (host clock); peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB; card {smi}", flush=True)
    del trainer
    return {"step_ms": step_ms, "batcher_ms": statistics.median(events), **run}


def phase_device_cache(ffl_overrides: list[str], p2p_overrides: list[str], smi: str) -> dict:
    """Phase 21: training from the device cache and HiSup's remat."""
    ffl_overrides = ffl_overrides + [f"init_weights_from={os.path.join(WORK, 'ffl_seeded_init.pt')}"]
    ffl = {dtype: ffl_cache_train(ffl_overrides, dtype, smi) for dtype in ("float32", "bfloat16")}
    card_cpu = cache_card_against_cpu(p2p_overrides, ffl_overrides)
    lidar = hisup_lidar_cache_remat(smi)
    fusion = hisup_fusion_remat_step(smi)
    p2p = p2p_cache_train(p2p_overrides, smi)
    return {"ffl": ffl, "card_cpu": card_cpu, "hisup_lidar": lidar, "hisup_fusion": fusion, "p2p": p2p}


# --- data parallel (phase 22) ---------------------------------------------------------


@contextlib.contextmanager
def world_of_one(dev: torch.device):
    """A process group of this one process for the block (NCCL on the card,
    gloo on the CPU): the port's data-parallel path at world size 1."""
    from pixelspointspolygons_torch.parallel import destroy_distributed, free_port, init_distributed

    init_distributed(dev.type, world_size=1, rank=0, init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        yield
    finally:
        destroy_distributed()


def unwrap(state) -> None:
    """Drop the DDP wrapper (and its reducer's hooks) before the group goes."""
    state.ddp = None
    gc.collect()


def timed_step(trainer, batch: dict, args: tuple) -> tuple[dict, float, int]:
    """(metrics, ms, peak bytes) of one train step of the trainer."""
    dev = trainer.device
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    metrics = {k: float(v) for k, v in trainer._train_step(trainer.state, batch, *args).items()}
    sync(dev)
    ms = (time.perf_counter() - t) * 1e3
    return metrics, ms, torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def ddp_turn(trainer, batch: dict, args: tuple) -> dict:
    """Under a group of one: DDP around the model (as the trainers' set-up
    puts it under a group), one step (DDP builds its buckets in the first
    backward), then one timed step with the collectives it issued and the
    AFM launches of both steps."""
    from pixelspointspolygons_torch import parallel
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    with world_of_one(trainer.device):
        trainer.state.wrap()
        afm_cuda.launches = 0
        trainer._train_step(trainer.state, batch, *args)
        parallel.collectives.clear()
        metrics, ms, peak = timed_step(trainer, batch, args)
        out = {"metrics": metrics, "ms": ms, "peak": peak, "collectives": dict(parallel.collectives),
               "launches": afm_cuda.launches}
        unwrap(trainer.state)
    return out


def plain_turn(trainer, batch: dict, args: tuple) -> dict:
    metrics, ms, peak = timed_step(trainer, batch, args)
    return {"metrics": metrics, "ms": ms, "peak": peak}


def first_steps(trainer, batch: dict, args: tuple, plain_runs: int) -> list:
    """From the same weights on the same batch: one step at world size 1
    through DDP, then `plain_runs` plain steps; each gives (metrics,
    gradients, buffers)."""
    state = trainer.state
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    out = []
    for ddp in [True] + [False] * plain_runs:
        state.model.load_state_dict(sd)
        with world_of_one(trainer.device) if ddp else contextlib.nullcontext():
            if ddp:
                state.wrap()
            metrics = {k: float(v) for k, v in trainer._train_step(state, batch, *args).items()}
            if ddp:
                unwrap(state)
        out.append((metrics, {n: p.grad.detach().clone() for n, p in state.model.named_parameters()},
                    {n: b.detach().clone() for n, b in state.model.named_buffers()}))
    state.model.load_state_dict(sd)
    return out


def step_gaps(a: tuple, b: tuple) -> tuple[float, float, float]:
    """(losses, gradients, buffers) of step b against step a: the largest
    relative loss difference, the gradient's relative L2, the largest
    buffer difference relative to the buffer's largest value."""
    loss = max(abs(b[0][k] / a[0][k] - 1.0) for k in a[0])
    return loss, grad_rel_l2(b[1], a[1]), max(
        (float((b[2][k] - a[2][k]).abs().max() / a[2][k].abs().max().clamp(min=1e-12)) for k in a[2]), default=0.0)


def grad_rel_l2(got: dict, want: dict) -> float:
    return (sum(float(((got[k].double().cpu() - want[k].double().cpu()) ** 2).sum()) for k in want)
            / sum(float((want[k].double() ** 2).sum()) for k in want)) ** 0.5


def hisup_loss_grads(model, batch: dict, size: int, weights: dict, dtype: torch.dtype) -> dict:
    """The gradient of HiSup's five weighted losses (the train step's) of
    `model` in `dtype` on `batch`, its targets from the float32 batch (the
    AFM kernel takes float32) widened to `dtype`; on the CPU."""
    from pixelspointspolygons_torch.models.hisup.model import encode_targets, hisup_losses

    targets = {k: v.to(dtype) if v.is_floating_point() else v for k, v in encode_targets(batch, size).items()}
    model.train().zero_grad(set_to_none=True)
    losses = hisup_losses(model({"images": batch["images"].to(dtype)}), targets)
    sum(weights[k] * v for k, v in losses.items()).backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def against_exact(what: str, ddp: dict, plain: dict, exact: dict) -> dict:
    """The DDP step's float32 gradient no farther from the float64 one than
    DDP_EXACT_FACTOR times the plain float32 step's, plus DDP_EXACT_FLOOR."""
    got, base = grad_rel_l2(ddp, exact), grad_rel_l2(plain, exact)
    tol = DDP_EXACT_FACTOR * base + DDP_EXACT_FLOOR
    print(f"{what}: gradient against float64, relative L2: DDP {got:.3g}, plain {base:.3g} (tol {tol:.3g}); DDP "
          f"against plain {grad_rel_l2(ddp, plain):.3g}", flush=True)
    if got > tol:
        fail(f"{what}: the DDP step's gradient lies {got} from float64, the plain step's {base}")
    return {"ddp": got, "plain": base}


def ddp_against_plain(what: str, ddp: tuple, plain: tuple, again: tuple) -> dict:
    """The DDP step's losses and BatchNorm buffers against the plain step's
    from the same weights on the same batch (its gradient printed beside
    the two plain steps' own distance: `against_exact` holds it)."""
    noise = step_gaps(plain, again)
    loss, grad, stats = step_gaps(plain, ddp)
    print(f"{what}: the DDP step against the plain step from the same weights on the same batch: losses rel diff "
          f"{loss:.3g} (tol {DDP_LOSS_TOL}), BatchNorm buffers rel diff {stats:.3g} (tol {DDP_STATS_TOL}), gradients "
          f"rel L2 {grad:.3g} (two plain steps read {noise[1]:.3g} apart, losses {noise[0]:.3g}, buffers "
          f"{noise[2]:.3g})", flush=True)
    if not (loss <= DDP_LOSS_TOL and stats <= DDP_STATS_TOL):
        fail(f"{what}: the DDP step differs from the plain one: losses {loss}, buffers {stats}")
    return {"loss_err": loss, "grad_err": grad, "stats_err": stats, "noise": noise}


def ddp_trainer(cls, cfg, keys: tuple, dev: torch.device):
    """The trainer's set-up without a group (its model bare), its first
    train batch on the device and the train step's extra arguments."""
    from pixelspointspolygons_torch.data.loader import device_prefetch

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    trainer = cls(cfg, device=dev)
    trainer.generator = torch.Generator(device=dev).manual_seed(int(cfg.get("seed", 42)))
    trainer.setup()
    batch = next(iter(device_prefetch(trainer.train_loader, dev, keys)))
    name = cfg.experiment.model.name
    args = (trainer._weights_for_epoch(0),) if name == "ffl" else (trainer.generator,) if name == "pix2poly" else ()
    return trainer, batch, args


def ddp_hisup(overrides: list[str], smi: str, dev: torch.device = CARD) -> dict:
    """HiSup-image float32 at world size 1 over NCCL against the plain step:
    the first step from the same weights, then DDP_TURNS turns each of DDP
    and plain, in turns (median ms, peak, collectives per step, AFM
    launches)."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.models.layers import BatchNorm
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer

    cfg = compose(overrides + ["host.compute_dtype=float32"])
    trainer, batch, args = ddp_trainer(HiSupTrainer, cfg, _DEV_KEYS, dev)
    n_norms = sum(isinstance(m, BatchNorm) for m in trainer.state.model.modules())
    ddp, plain, again = first_steps(trainer, batch, args, 2)
    check = ddp_against_plain(f"hisup_image (float32, world size 1, batch {B})", ddp, plain, again)
    del ddp, plain, again
    # the gradients against float64's, on the batch's first DDP_EXACT_ROWS tiles
    small = {k: v[:DDP_EXACT_ROWS] for k, v in batch.items()}
    (_, ddp, _), (_, plain, _) = first_steps(trainer, small, args, 1)
    model64 = build_hisup(cfg, device=dev, dtype=torch.float64).double()
    model64.load_state_dict(trainer.state.model.state_dict())
    weights = {k: float(v) for k, v in cfg.experiment.model.loss_weights.items()}
    exact = hisup_loss_grads(model64, small, int(cfg.experiment.model.decoder.in_feature_size), weights,
                             torch.float64)
    check["exact"] = against_exact(f"hisup_image (float32, world size 1, batch {DDP_EXACT_ROWS})", ddp, plain, exact)
    del ddp, plain, exact, model64
    turns = {"ddp": [], "plain": []}
    for _ in range(DDP_TURNS):
        turns["ddp"].append(ddp_turn(trainer, batch, args))
        turns["plain"].append(plain_turn(trainer, batch, args))
    coll = turns["ddp"][-1]["collectives"]
    launches = sum(t["launches"] for t in turns["ddp"])
    out = {kind: {"ms": [t["ms"] for t in ts], "peak": max(t["peak"] for t in ts)} for kind, ts in turns.items()}
    med = {kind: statistics.median(v["ms"]) for kind, v in out.items()}
    print(f"hisup_image data parallel (float32, batch {B}, world size 1): DDP step {med['ddp']:.1f} ms "
          f"{[round(x, 1) for x in out['ddp']['ms']]}, plain step {med['plain']:.1f} ms "
          f"{[round(x, 1) for x in out['plain']['ms']]} (in turns), +{100 * (med['ddp'] / med['plain'] - 1):.2f} %; "
          f"peak {out['ddp']['peak'] / 2**30:.2f} and {out['plain']['peak'] / 2**30:.2f} GiB; collectives per DDP "
          f"step {coll} ({n_norms} BatchNorms); afm launches in the DDP steps {launches}; card {smi}", flush=True)
    if coll.get("batch_norm") != 2 * n_norms or not coll.get("bucket"):
        fail(f"hisup DDP step: collectives {coll}, expected 2 per BatchNorm ({n_norms}) and the gradient buckets")
    if launches != (2 * DDP_TURNS if dev.type == "cuda" else 0):
        fail(f"hisup DDP steps launched the afm kernel {launches} times, expected {2 * DDP_TURNS}")
    with world_of_one(trainer.device):
        trainer.state.wrap()
        train_twice("hisup_image_ddp", trainer, [batch], (), {"afm": True, "pillar_sums": False, "run_sums": False})
        unwrap(trainer.state)
    del trainer, batch
    return {**out, "median_ms": med, "collectives": coll, "n_norms": n_norms, "launches": launches, "check": check}


def ddp_one_step(name: str, overrides: list[str], smi: str, dev: torch.device = CARD) -> dict:
    """Pix2Poly-image or FFL-image float32: the first DDP step's losses
    against the plain step's from the same weights, then one plain and one
    DDP turn (ms, peak)."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.train import trainer_ffl, trainer_pix2poly

    cls, keys = ((trainer_pix2poly.Pix2PolyTrainer, trainer_pix2poly._DEV_KEYS) if name == "pix2poly"
                 else (trainer_ffl.FFLTrainer, trainer_ffl.FFL_BATCH_KEYS))
    cfg = compose(overrides + ["host.compute_dtype=float32"])
    trainer, batch, args = ddp_trainer(cls, cfg, keys, dev)
    (ddp, _, _), (plain, _, _) = first_steps(trainer, batch, args, 1)
    loss = max(abs(ddp[k] / plain[k] - 1.0) for k in plain)
    turns = {"plain": plain_turn(trainer, batch, args), "ddp": ddp_turn(trainer, batch, args)}
    print(f"{name} data parallel (float32, batch {B}, world size 1): DDP step {turns['ddp']['ms']:.1f} ms, plain step "
          f"{turns['plain']['ms']:.1f} ms; peak {turns['ddp']['peak'] / 2**30:.2f} and "
          f"{turns['plain']['peak'] / 2**30:.2f} GiB; collectives per DDP step {turns['ddp']['collectives']}; first "
          f"step losses DDP {ddp} against plain {plain}, rel diff {loss:.3g} (tol {DDP_LOSS_TOL}); afm launches "
          f"{turns['ddp']['launches']}; card {smi}", flush=True)
    if loss > DDP_LOSS_TOL or turns["ddp"]["launches"]:
        fail(f"{name} DDP step: losses {loss} from the plain step's, {turns['ddp']['launches']} afm launches")
    del trainer, batch
    return {"loss_err": loss, **{k: {"ms": v["ms"], "peak": v["peak"]} for k, v in turns.items()},
            "launches": turns["ddp"]["launches"], "collectives": turns["ddp"]["collectives"]}


def tiny_cases() -> dict:
    """The two tiny models of the gloo check and their global batches:
    {name: (family, batch)}; the Pix2Poly halves hold 13 and 5 targets a row."""
    import graft_entry_torch as entry

    hisup = entry.dryrun_batches(DDP_TINY_ROWS, size=DDP_TINY_SIZE)["hisup"]
    p2p = entry.dryrun_batches(DDP_TINY_ROWS, seed=1)["pix2poly"]
    r = np.random.RandomState(2)
    p2p["y"][:] = 34
    p2p["y"][:, 0] = 32
    for b in range(DDP_TINY_ROWS):
        n = 12 if b < DDP_TINY_ROWS // 2 else 4
        p2p["y"][b, 1:n + 1] = r.randint(0, 32, n)
        p2p["y"][b, n + 1] = 33
    return {"hisup_hrnet": ("hisup", hisup), "pix2poly_fusion": ("pix2poly", p2p)}


def tiny_step(family: str, batch: dict, dev: torch.device, dtype: torch.dtype = torch.float32) -> tuple:
    """One train step of the tiny model of `family` (weights from seed 0
    on the CPU) computing in `dtype` on `batch` (numpy, float32: the
    targets' AFM takes float32) on `dev`, through DDP under a group:
    (global metrics, gradients, buffers), on the CPU."""
    import graft_entry_torch as entry
    from pixelspointspolygons_torch.parallel import all_reduce_mean
    from pixelspointspolygons_torch.train import hisup_step, pix2poly_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler

    gen = torch.Generator().manual_seed(0)
    model = (entry.tiny_hisup("hrnet", gen, DDP_TINY_SIZE, dtype) if family == "hisup"
             else entry.tiny_pix2poly(gen, dtype)).to(dev)
    opt = make_optimizer("adamw", model.parameters(), 1e-4)
    state = TrainState(model, opt, make_scheduler(opt, lambda n: 1e-4, 1e-4))
    state.wrap()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if family == "hisup":
        metrics = hisup_step.make_train_step(entry.HISUP_WEIGHTS, DDP_TINY_SIZE)(state, batch)
    else:
        metrics = pix2poly_step.make_train_step(1.0, 10.0, 34)(state, batch)
    means = all_reduce_mean(torch.stack([metrics[k].double() for k in metrics])).tolist()
    return (dict(zip(metrics, means)), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()})


def _gloo_rank(rank: int, go: str, out_file: str, dev_type: str, spawned: float) -> None:
    """One of two gloo ranks on card 0 (or the CPU): it reaches the device,
    waits for the file `go` (which names the group's address), then takes
    each tiny case's DDP step on this rank's half; rank 0 saves the
    results, with the seconds from its spawn (`spawned`, the parent's
    clock) to this call, to the device reached, to `go`, to the group
    formed and to the steps done."""
    import torch.distributed as dist

    from pixelspointspolygons_torch.device import set_deterministic, set_tf32

    marks = {"entered": time.time() - spawned}
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device(dev_type)
    set_deterministic(dev)
    set_tf32(False)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    marks["ready"] = time.time() - spawned
    deadline = time.time() + GLOO_WAIT_S
    while not os.path.isfile(go):
        if time.time() > deadline:
            raise TimeoutError(f"gloo rank {rank}: no {go} after {GLOO_WAIT_S} s")
        time.sleep(0.05)
    with open(go) as f:
        init_method = f.read().strip()
    marks["released"] = time.time() - spawned
    dist.init_process_group("gloo", init_method=init_method, world_size=2, rank=rank)
    try:
        marks["group"] = time.time() - spawned
        half = DDP_TINY_ROWS // 2
        results = {(name, dtype): tiny_step(family, {k: v[rank * half:(rank + 1) * half] for k, v in batch.items()},
                                            dev, dtype)
                   for name, (family, batch) in tiny_cases().items() for dtype in (torch.float32, torch.float64)}
        marks["steps"] = time.time() - spawned
        if rank == 0:
            torch.save({"results": results, "seconds": marks}, out_file)
    finally:
        dist.destroy_process_group()


def start_gloo_ranks(dev: torch.device = CARD) -> dict:
    """Spawn the two ranks of `gloo_on_the_card` (daemons: they end with
    this process) at the start of phase 22, so that their start, about
    9 s to the card, runs beside the phase's first steps; each waits for
    its go file before it takes a step."""
    go = os.path.join(WORK, "gloo_go.txt")
    out_file = os.path.join(WORK, "gloo_ranks.pt")
    for path in (go, out_file):
        if os.path.exists(path):
            os.remove(path)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, go, out_file, dev.type, time.time()), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    return {"procs": procs, "go": go, "out_file": out_file}


def gloo_on_the_card(smi: str, ranks: dict, dev: torch.device = CARD) -> dict:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), spawned by `start_gloo_ranks` and released here with the
    group's address: the tiny HRNet HiSup's and the tiny fusion
    Pix2Poly's DDP steps on the two halves, with the synchronised
    BatchNorms' and DDP's collectives on CUDA tensors, against the
    one-process step on the whole batch on the card (twice: the atomics'
    own spread)."""
    from pixelspointspolygons_torch.parallel import free_port

    procs, out_file = ranks["procs"], ranks["out_file"]
    with open(ranks["go"] + ".tmp", "w") as f:
        f.write(f"tcp://127.0.0.1:{free_port()}")
    os.replace(ranks["go"] + ".tmp", ranks["go"])
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    if any(p.exitcode for p in procs):
        fail(f"gloo ranks on the card exited with {[p.exitcode for p in procs]}")
    saved = torch.load(out_file, weights_only=False)
    got = saved["results"]
    print(f"gloo rank 0, seconds from its spawn: {json.dumps({k: round(v, 2) for k, v in saved['seconds'].items()})}",
          flush=True)
    out = {"rank0_s": saved["seconds"]}
    for name, (family, batch) in tiny_cases().items():
        what = f"{name}, 2 gloo ranks on the card"
        plain, again = tiny_step(family, batch, dev), tiny_step(family, batch, dev)
        out[name] = ddp_against_plain(what, got[(name, torch.float32)], plain, again)
        plain64, again64 = tiny_step(family, batch, dev, torch.float64), tiny_step(family, batch, dev, torch.float64)
        grad, noise = grad_rel_l2(got[(name, torch.float64)][1], plain64[1]), grad_rel_l2(again64[1], plain64[1])
        tol = max(DDP64_GRAD_TOL, DDP_NOISE_FACTOR * noise)
        print(f"{what}: the float64 DDP step's gradient against the float64 one-process step's, relative L2 "
              f"{grad:.3g} (tol {tol:.3g}: two one-process steps read {noise:.3g} apart)", flush=True)
        if grad > tol:
            fail(f"{what}: the float64 DDP step's gradient lies {grad} from the one-process step's")
        out[name]["grad64_err"] = grad
    return out


def float64_drift(smi: str, dev: torch.device = CARD) -> dict:
    """ROADMAP 3.16: the tiny HRNet HiSup's float32 gradient of the five
    weighted losses against its float64 gradient, at DRIFT_SIZE px and
    batch 2 from the same weights and targets, on the card (cuDNN, TF32
    off) and on the CPU with one thread and with the thread pool."""
    import graft_entry_torch as entry

    batch = {k: torch.from_numpy(v) for k, v in entry.dryrun_batches(2, seed=3, size=DRIFT_SIZE)["hisup"].items()}

    def grads(on, dtype):
        model = entry.tiny_hisup("hrnet", torch.Generator().manual_seed(0), DRIFT_SIZE, dtype).to(on)
        return hisup_loss_grads(model, {k: v.to(on) for k, v in batch.items()}, DRIFT_SIZE, entry.HISUP_WEIGHTS, dtype)

    rel = grad_rel_l2
    out = {"card": rel(grads(dev, torch.float32), grads(dev, torch.float64))}
    threads = torch.get_num_threads()
    exact = grads(torch.device("cpu"), torch.float64)
    out["cpu_pool"] = rel(grads(torch.device("cpu"), torch.float32), exact)
    torch.set_num_threads(1)
    try:
        out["cpu_one_thread"] = rel(grads(torch.device("cpu"), torch.float32), exact)
    finally:
        torch.set_num_threads(threads)
    print(f"ROADMAP 3.16: the tiny HRNet HiSup's float32 gradient against float64 ({DRIFT_SIZE} px, batch 2), "
          f"relative L2: card {out['card']:.3g} (cuDNN, TF32 off), CPU {out['cpu_pool']:.3g} ({threads} threads), "
          f"CPU {out['cpu_one_thread']:.3g} (one thread); card {smi}", flush=True)
    return out


def phase_data_parallel(overrides: list[str], p2p_overrides: list[str], ffl_overrides: list[str], smi: str) -> dict:
    """Phase 22: data-parallel training on the one card."""
    ranks = start_gloo_ranks()
    hisup = ddp_hisup(overrides, smi)
    others = {name: ddp_one_step(name, o, smi) for name, o in (("pix2poly", p2p_overrides), ("ffl", ffl_overrides))}
    gloo = gloo_on_the_card(smi, ranks)
    drift = float64_drift(smi)
    return {"hisup": hisup, **others, "gloo": gloo, "drift": drift}


# --- the remaining encoders and the ablation twins (phase 23) -------------------


def ffl_bf16_step_losses(cfg, first: dict) -> dict:
    """One bfloat16 FFL train step on the card from the first step's weights
    on its HISUP_BF16_CPU_TILES tiles (as `ffl_train_card_against_cpu`'s
    float32 step)."""
    from pixelspointspolygons_torch.models.ffl import build_ffl
    from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
    from pixelspointspolygons_torch.train.ffl_step import make_train_step
    from pixelspointspolygons_torch.train.state import TrainState, make_optimizer, make_scheduler

    lr = float(cfg.experiment.model.learning_rate)
    loss_fn, weights_for_epoch = make_ffl_loss(cfg)
    model = build_ffl(cfg, device=CARD, dtype=torch.bfloat16)
    model.load_state_dict(first["state"])
    opt = make_optimizer("adam", model.parameters(), lr)
    state = TrainState(model, opt, make_scheduler(opt, lambda n: lr, lr))
    got = make_train_step(loss_fn)(state, {k: v.to(CARD) for k, v in first["batch"].items()}, weights_for_epoch(0))
    return {k: float(v) for k, v in got.items()}


def p2p_predict_split(overrides: list[str], name: str) -> dict:
    """The test split predicted from `latest` and evaluated through the
    functions `cli/predict.py::main` calls, with the kernel counters set to
    0 just before and read just after."""
    from pixelspointspolygons_torch.cli.evaluate import evaluate
    from pixelspointspolygons_torch.cli.predict import get_predictor
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    cfg = compose(overrides + ["evaluation=test", "checkpoint=latest"])
    afm_cuda.launches = 0
    t0 = time.perf_counter()
    predictor = get_predictor(cfg, CARD)
    pred_file = predictor.predict_dataset(cfg.evaluation.split)
    torch.cuda.synchronize()
    results = evaluate(cfg, pred_file)
    wall = time.perf_counter() - t0
    launches = afm_cuda.launches
    with open(pred_file.replace(".json", "_time.json")) as f:
        timing = json.load(f)
    if launches or timing["num_images"] != TEST_TILES or not np.isfinite(results.get("IoU", np.nan)):
        fail(f"{name} prediction: {launches} afm launches, {timing['num_images']} tiles, metrics {results}")
    tiles_s = 1.0 / timing["prediction_time"]
    times = predictor.batch_times
    print(f"{name} predict path: {timing['num_images']} tiles in {len(times)} batches of {B}, {tiles_s:.2f} tiles/s "
          f"(the predictor's own s/tile over its loop); set-up, loop, file and evaluation {wall:.2f} s; afm launches "
          f"{launches}; IoU {results['IoU']:.4f}", flush=True)
    for i, t in enumerate(times):
        print(f"  batch {i}: encoder {t['encoder_ms']:.2f} ms, decode loop {t['decode_ms']:.2f} ms ({t['steps']} steps), "
              f"ScoreNets {t['scorenet_ms']:.2f} ms (CUDA events); decode loop host {t['decode_host_ms']:.2f} ms; "
              f"wall {t['wall_ms']:.2f} ms", flush=True)
    return {"tiles_s": tiles_s, "batch_times": times, "results": results, "launches": launches,
            "predictor": predictor, "cfg": cfg}


def phase_dinov2(overrides: list[str], smi: str) -> dict:
    """Pix2Poly over DINOv2 ViT-S/14 at full width: a seeded file in
    DINOv2's layout grafted by the trainer's set-up, CNX_TRAIN_STEPS steps
    with the val figure, the split predicted, the card against the CPU."""
    from pixelspointspolygons_torch.data.loader import build_loader, to_device
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer
    from pixelspointspolygons_torch.utils.torch_port import interpolate_pos_embed, port_dinov2_vit

    dino_file = os.path.join(WORK, "dinov2_vits14.pth")
    torch.save({"model": timm_vit_state(384, 12, 14, DINO_GRID, seed=PRETRAINED_SEED, dinov2=True)}, dino_file)
    overrides = overrides + ["experiment.encoder.pretrained=true", f"experiment.encoder.checkpoint_file={dino_file}"]
    graft = {}

    def check_graft(trainer):
        trunk = trainer.state.model.encoder.vit
        values = port_dinov2_vit(torch.load(dino_file, weights_only=True)["model"])
        n_tokens = trunk.state_dict()["pos_embed"].shape[1]
        values["pos_embed"] = interpolate_pos_embed(values["pos_embed"], n_tokens)
        graft.update(loaded=len(values), trunk=len(trunk.state_dict()), differ=grafted_equal_file(trunk, values),
                     tokens=(DINO_GRID ** 2 + 1, n_tokens))

    t = phase_p2p_train(overrides, "float32", steps=CNX_TRAIN_STEPS, name="pix2poly vit_dinov2",
                        after_setup=check_graft, card_against_cpu=False)
    print(f"pix2poly vit_dinov2 graft (DINOv2 layout, pos_embed {graft['tokens'][0]} -> {graft['tokens'][1]} tokens): "
          f"{graft['loaded']} of the trunk's {graft['trunk']} tensors loaded, {graft['differ']} differ from the file "
          f"on the card", flush=True)
    if graft["differ"] or graft["loaded"] != graft["trunk"]:
        fail(f"the DINOv2 graft: {graft}")
    import cv2

    figure = os.path.join(t["output_dir"], "runs", "images", "val_prediction_0.png")
    img = cv2.imread(figure)
    print(f"pix2poly vit_dinov2 val figure {figure}: {None if img is None else img.shape}, pixel std "
          f"{None if img is None else round(float(img.std()), 2)}", flush=True)
    if img is None or not img.std() > 0:
        fail(f"the Pix2Poly trainer logged no val figure at {figure}")
    pred = p2p_predict_split(overrides, "pix2poly vit_dinov2")
    tokenizer = Tokenizer(pred["cfg"])
    batch = next(iter(build_loader(pred["cfg"], "test", tokenizer=tokenizer, eval_mode=True)))
    few = {"images": to_device(batch, CARD, ("images",))["images"][:P2P_CPU_TILES]}
    p2p_card_against_cpu(pred["predictor"].model, few, tokenizer, "vit_dinov2 after its steps", P2P_REL_TOL)
    print(f"pix2poly vit_dinov2: train step {t['step_ms']:.1f} ms, peak {t['peak_bytes'] / 2**30:.2f} GiB, val IoU "
          f"{t['val_iou']:.4f}; predict {pred['tiles_s']:.2f} tiles/s, encoder "
          f"{statistics.median(b['encoder_ms'] for b in pred['batch_times']):.2f} ms and decode loop "
          f"{statistics.median(b['decode_ms'] for b in pred['batch_times']):.2f} ms per batch of {B} (medians); "
          f"card {smi}", flush=True)
    latest = os.path.join(t["output_dir"], "checkpoints", "latest.pt")
    return {"train": t, "predict": {k: v for k, v in pred.items() if k not in ("predictor", "cfg")}, "latest": latest}


def ablation_overrides(root: str) -> list[str]:
    """The smoke split of the other phases for an ablation twin, whose runs
    name their experiments, under the model root `root`."""
    return [o for o in smoke_overrides(TRAIN_STEPS * B) if not o.startswith("experiment=")] + [
        f"host.model_root={root}"]


def as_best_val_iou(cfg, checkpoint: str | None = None, model=None) -> None:
    """`checkpoint` (a trainer's `.pt`) or `model`'s weights written as the
    `best_val_iou` checkpoint of `cfg`'s output directory."""
    ckpt_dir = os.path.join(cfg.output_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    if checkpoint is not None:
        shutil.copyfile(checkpoint, os.path.join(ckpt_dir, "best_val_iou.pt"))
    else:
        torch.save({"model": model.state_dict(), "epoch": 0, "cfg": cfg.to_dict()},
                   os.path.join(ckpt_dir, "best_val_iou.pt"))


def phase_ablations(p2p_vit_latest: str, dino_latest: str, ffl_vit_latest: str) -> dict:
    """The ablation twins on the first ABLATION_TEST_TILES test tiles and
    the paper table on the card, with the counters set to 0 just before and
    read just after (0 AFM launches)."""
    from pixelspointspolygons_torch.cli import csv_results_to_latex, dino_v2_ablation, image_res_ablation
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.ffl import build_ffl
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    def overrides(root: str) -> list[str]:
        return ablation_overrides(root) + [f"run_type.test_subset={ABLATION_TEST_TILES}"]

    t0 = time.perf_counter()
    afm_cuda.launches = 0
    dino_csvs = []
    for enc, latest in (("vit", p2p_vit_latest), ("vit_dinov2", dino_latest)):
        root = os.path.join(WORK, f"ablation_{enc}")
        as_best_val_iou(compose(["experiment=p2p_image", f"encoder={enc}"] + overrides(root)), latest)
        encoders, dino_v2_ablation.ENCODERS = dino_v2_ablation.ENCODERS, [enc]
        try:
            with contextlib.chdir(root):
                df = dino_v2_ablation.main(overrides(root))
        finally:
            dino_v2_ablation.ENCODERS = encoders
        if list(df.get("encoder", [])) != [enc]:
            fail(f"cli.dino_v2_ablation gave no row for {enc}: {df}")
        dino_csvs.append(os.path.join(root, "dino_v2_ablation.csv"))

    root = os.path.join(WORK, "ablation_res")
    res_over = overrides(root) + ["experiment.dataset.size=224"]
    rows = [compose(["experiment=ffl_image", "evaluation=test", "checkpoint=best_val_iou", *extra] + res_over)
            for _, extra in image_res_ablation.CONFIGS]
    as_best_val_iou(rows[0], ffl_vit_latest)
    unet512 = build_ffl(rows[1], device=CARD, generator=torch.Generator(device=CARD).manual_seed(FFL_SEED))
    as_best_val_iou(rows[1], model=unet512)
    del unet512
    with contextlib.chdir(root):
        df = image_res_ablation.main(res_over)
    if list(df.get("in_size", [])) != [224, 512]:
        fail(f"cli.image_res_ablation did not run both rows: {df}")
    with open(rows[1].evaluation.pred_file) as f:
        far = max((max(a["segmentation"][0][0::2] + [0]) for a in json.load(f)), default=0.0)
    print(f"image_res_ablation, the 512 row on 224 px tiles (ROADMAP 3.18): the model's maps are "
          f"{rows[1].experiment.model.decoder.in_feature_size} px and its polygons reach x = {far:.1f}", flush=True)
    launches = afm_cuda.launches
    tables = {
        "dino_v2": csv_results_to_latex.main(dino_csvs + ["type=all", "caption=DINOv2 ablation (smoke run)"]),
        "image_res": csv_results_to_latex.main([os.path.join(root, "image_res_ablation.csv"), "type=resolution",
                                                "caption=Image resolution ablation (smoke run)"]),
    }
    wall = time.perf_counter() - t0
    print(f"ablation twins and tables in {wall:.1f} s; afm launches {launches}", flush=True)
    if launches or not all(tables.values()):
        fail(f"the ablation twins: {launches} afm launches, tables {list(tables)}")
    return {"launches": launches, "wall_s": wall, "far_x_512": far}


def phase_remaining_encoders(smi: str) -> dict:
    """Phase 23: FFL over UNet-ResNet101 and ConvNeXt-V2-T, Pix2Poly over
    DINOv2 ViT-S/14, each in a model root of its own, then the ablation
    twins on the card."""
    t0 = time.perf_counter()
    out = {}
    ffl = smoke_overrides(TRAIN_STEPS * B, experiment="ffl_image")
    for enc, exact_tiles in (("unetresnet101", UNET_EXACT_TILES), ("convnext", HISUP_BF16_CPU_TILES)):
        over = ffl + [f"encoder={enc}", f"experiment.encoder.in_size={S}", f"run_type.train_subset={CNX_TRAIN_STEPS * B}",
                      f"host.model_root={os.path.join(WORK, 'outputs_' + enc)}"]
        name = f"ffl {enc}"
        t = phase_ffl_train(over, "float32", steps=CNX_TRAIN_STEPS, name=name, cold=False, exact_tiles=exact_tiles)
        pred = phase_ffl_predict_tiles(over, "float32", name=name, tiles=PHASE23_TEST_TILES)
        out[enc] = {"train": t, "predict": pred}
        print(f"{name}: train step {t['step_ms']:.1f} ms, peak {t['peak_bytes'] / 2**30:.2f} GiB, val IoU "
              f"{t['val_iou']:.4f}, by layer {json.dumps({k: round(v, 2) for k, v in t['breakdown'].items()})}; predict "
              f"{pred['tiles_s']:.2f} tiles/s, forward "
              f"{statistics.median(b['device_ms'] for b in pred['batch_times']):.2f} ms per batch of {B} (median); "
              f"card {smi}", flush=True)
        if enc == "convnext":
            from pixelspointspolygons_torch.config import compose

            bf16 = ffl_bf16_step_losses(compose(over), t["first"])
            f32 = t["card_losses"]
            err = {k: abs(bf16[k] / f32[k] - 1.0) for k in f32}
            print(f"{name}: one bfloat16 step from the first step's weights on its {len(t['first']['batch']['images'])} tiles "
                  f"{bf16}, float32 {f32}; rel diff {err} (tol {FFL_BF16_LOSS_TOL})", flush=True)
            if set(err) != set(FFL_BF16_LOSS_TOL) or any(e > FFL_BF16_LOSS_TOL[k] for k, e in err.items()):
                fail(f"the bfloat16 ConvNeXt FFL step's losses differ from float32's by {err}")
            out[enc]["bf16_err"] = err
        t.pop("first")
        gc.collect()
        torch.cuda.empty_cache()
    p2p = smoke_overrides(TRAIN_STEPS * B, experiment="p2p_image") + [
        "encoder=vit_dinov2", f"run_type.train_subset={CNX_TRAIN_STEPS * B}",
        f"host.model_root={os.path.join(WORK, 'outputs_vit_dinov2')}"]
    out["vit_dinov2"] = phase_dinov2(p2p, smi)
    gc.collect()
    torch.cuda.empty_cache()
    from pixelspointspolygons_torch.config import compose

    p2p_vit = compose(smoke_overrides(TRAIN_STEPS * B, "p2p_image"))
    ffl_vit = compose(ffl)
    out["ablations"] = phase_ablations(os.path.join(p2p_vit.output_dir, "checkpoints", "latest.pt"),
                                       out["vit_dinov2"]["latest"],
                                       os.path.join(ffl_vit.output_dir, "checkpoints", "latest.pt"))
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 23 (the remaining encoders and the ablation twins) in {out['wall_s']:.1f} s; card {smi}", flush=True)
    return out


# --- the last script twins (phase 24) ----------------------------------------------


@contextlib.contextmanager
def timed_calls(module, names: tuple[str, ...]):
    """Host seconds of each function `names` of `module` while the block runs
    (the module's `main` calls them through its globals), by name."""
    seconds: dict[str, float] = {}
    originals = {n: getattr(module, n) for n in names}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return call

    for name, fn in originals.items():
        setattr(module, name, timed(name, fn))
    try:
        yield seconds
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def twin_oracle() -> dict:
    """`cli.postprocess_oracle model=all` at the script's defaults and the
    ASM on ORACLE_ASM_TILES tiles, on the card and with `device=cpu`: each
    card row above its floor, the CPU's rows against the card's."""
    from pixelspointspolygons_torch.cli import postprocess_oracle
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    commands = {"all": ["model=all"],
                "asm": ["model=ffl", "experiment.polygonization.method=[asm]", f"n={ORACLE_ASM_TILES}"]}
    reports, seconds = {}, {}
    afm_cuda.launches = 0
    for where, extra in (("card", []), ("cpu", ["device=cpu"])):
        for key, args in commands.items():
            with timed_calls(postprocess_oracle, ("oracle_ffl", "oracle_hisup", "oracle_pix2poly")) as s:
                reports[where, key] = postprocess_oracle.main(args + extra)
            seconds[where, key] = {k: round(v, 3) for k, v in s.items()}
            print(f"cli.postprocess_oracle {' '.join(args + extra)}: seconds by branch {seconds[where, key]}",
                  flush=True)
        if where == "card":
            launches = afm_cuda.launches
    card = {**reports["card", "all"], **reports["card", "asm"]}
    low = {row: (card.get(row), floors) for row, floors in ORACLE_FLOORS.items()
           if row not in card or not all(card[row][k] > f for k, f in zip(("IoU", "C-IoU", "NR"), floors))}
    gaps = {}
    for key in commands:
        got, want = reports["cpu", key], reports["card", key]
        if list(got) != list(want):
            fail(f"postprocess_oracle {key}: rows on the CPU {list(got)}, on the card {list(want)}")
        for row in want:
            gaps[row] = max(abs(got[row][k] - want[row][k]) for k in want[row])
    print(f"postprocess_oracle card against CPU, largest gap per row: {gaps} (HiSup and Pix2Poly equal; FFL within "
          f"{ORACLE_CPU_TOL}); floors (IoU, C-IoU, NR) {ORACLE_FLOORS}; afm launches {launches}", flush=True)
    if low:
        fail(f"postprocess_oracle rows at or under their floors: {low}")
    if gaps["hisup"] or gaps["pix2poly"] or not all(g <= ORACLE_CPU_TOL for g in gaps.values()):
        fail(f"postprocess_oracle's rows on the card and the CPU differ: {gaps}")
    return {"card": card, "gaps": gaps, "seconds": {f"{w}_{k}": v for (w, k), v in seconds.items()},
            "launches": launches}


def twin_predict_timer(seeded_latest: str, smi: str) -> dict:
    """`cli.measure_predict_e2e experiment=p2p_image checkpoint=latest` over
    phase 6's seeded model in a model root of its own, on the split's first
    ABLATION_TEST_TILES tiles (the whole split before phase 25 came, cut
    for the run's time; ROADMAP 3.22: it reports the tiles it predicted),
    every pass's prediction file holding the same image ids."""
    from pixelspointspolygons_torch.cli import measure_predict_e2e
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.utils.coco import CocoIndex

    args = smoke_overrides(TRAIN_STEPS * B, "p2p_image") + [
        f"host.model_root={os.path.join(WORK, 'twins_p2p')}", "evaluation=test", "checkpoint=latest",
        f"run_type.test_subset={ABLATION_TEST_TILES}"]
    cfg = compose(args)
    os.makedirs(os.path.join(cfg.output_dir, "checkpoints"), exist_ok=True)
    shutil.copyfile(seeded_latest, os.path.join(cfg.output_dir, "checkpoints", "latest.pt"))
    ids = []
    get_predictor = measure_predict_e2e.get_predictor

    def recorded(*a, **kw):
        predictor = get_predictor(*a, **kw)
        predict = predictor.predict_dataset

        def predict_dataset(split):
            path = predict(split)
            with open(path) as f:
                ids.append(sorted({ann["image_id"] for ann in json.load(f)}))
            return path

        predictor.predict_dataset = predict_dataset
        return predictor

    measure_predict_e2e.get_predictor = recorded
    afm_cuda.launches = 0
    try:
        report = measure_predict_e2e.main(args)
    finally:
        measure_predict_e2e.get_predictor = get_predictor
    launches = afm_cuda.launches
    test_ids = set(CocoIndex(cfg.experiment.dataset.annotations["test"]).imgs)
    print(f"cli.measure_predict_e2e (seeded p2p_image, float32, all {Tokenizer(cfg).max_len - 1} decode steps): "
          f"{report['warm_tiles_per_s']} tiles/s warm, cold {report['cold_s']} s against a warm median "
          f"of {report['warm_s_median']} s; {len(ids)} passes wrote {[len(i) for i in ids]} image ids; afm launches "
          f"{launches}; card {smi}", flush=True)
    if report["tiles"] != ABLATION_TEST_TILES or len(ids) != 4 or any(i != ids[0] for i in ids) or not set(ids[0]) <= test_ids:
        fail(f"cli.measure_predict_e2e: {report['tiles']} tiles, image ids per pass {ids}")
    return {"report": report, "launches": launches}


def trace_counts(path: str) -> tuple[collections.Counter, collections.Counter]:
    """(kernel names, CPU operator names) of a Chrome trace the profiler
    wrote, counted by a scan of its text: a generate trace holds millions of
    events, which `json.load` would hold as tens of GiB of objects."""
    kernels, ops = collections.Counter(), collections.Counter()
    pattern = re.compile(rb'"cat":\s*"(kernel|cpu_op)",\s*"name":\s*"((?:[^"\\]|\\.)*)"')
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as m:
        for match in pattern.finditer(m):
            (kernels if match.group(1) == b"kernel" else ops)[match.group(2).decode()] += 1
    return kernels, ops


def twin_profile(smi: str) -> dict:
    """`cli.profile TRACE_DIR train` and `generate`: each trace's size, the
    export's seconds and the decode's kernels in it."""
    from pixelspointspolygons_torch.cli import profile
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer
    from pixelspointspolygons_torch.ops.afm import afm_cuda

    steps = Tokenizer(compose(["experiment=p2p_image", "run_type=debug"])).max_len - 1
    trace_dir = os.path.join(WORK, "twins_trace")
    out = {}
    afm_cuda.launches = 0
    for mode, runs in (("train", 3), ("generate", PROFILE_GENERATE_RUNS)):
        t0 = time.perf_counter()
        got = profile.main([trace_dir, mode, str(runs)])
        wall = time.perf_counter() - t0
        if not os.path.isfile(got["path"]):
            fail(f"cli.profile {mode} wrote no trace at {got['path']}")
        size = os.path.getsize(got["path"])
        t0 = time.perf_counter()
        kernels, ops = trace_counts(got["path"])
        scan = time.perf_counter() - t0
        argmax = sum(n for k, n in kernels.items() if "ArgMax" in k)
        products = ops["aten::mm"] + ops["aten::addmm"] + ops["aten::bmm"]
        print(f"cli.profile {mode} ({runs} traced runs): {size / 1e6:.1f} MB, export {got['export_s']:.2f} s, the "
              f"command {wall:.1f} s; "
              f"{sum(kernels.values())} kernel events ({len(kernels)} kernels), {sum(ops.values())} CPU operators, "
              f"{argmax} argmax reductions, {products} matrix products (scanned in {scan:.1f} s); card {smi}",
              flush=True)
        if mode == "generate" and argmax < runs * steps:
            fail(f"the generate trace holds {argmax} argmax kernels, expected at least {runs} x {steps}")
        if mode == "train" and not (ops["aten::embedding"] >= 3 and sum(kernels.values()) >= products > 0
                                    and ops["autograd::engine::evaluate_function: EmbeddingBackward0"] >= 3):
            fail(f"the train trace lacks the decoder's operations or kernels: {products} products, "
                 f"{sum(kernels.values())} kernel events, {ops['aten::embedding']} embeddings")
        out[mode] = {"mb": size / 1e6, "export_s": got["export_s"], "wall_s": wall, "kernel_events": sum(kernels.values()),
                     "cpu_ops": sum(ops.values())}
        os.remove(got["path"])
    out["launches"] = afm_cuda.launches
    return out


def twin_gather_and_droplidar(fusion_latest: str, smi: str) -> dict:
    """`cli.gather_pretrained_models` over the model root of the earlier
    phases, and `cli.droplidar50_ablation` over phase 18's seeded p2p_fusion
    written as `best_val_iou` in a root of its own."""
    from pixelspointspolygons_torch.cli import droplidar50_ablation, gather_pretrained_models
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda

    afm_cuda.launches = 0
    args = ablation_overrides(os.environ["P3_MODEL_ROOT"])
    present = [exp for exp in gather_pretrained_models.EXPERIMENTS if os.path.isfile(
        os.path.join(compose([f"experiment={exp}"] + args).output_dir, "checkpoints", "best_val_iou.pt"))]
    root = os.path.join(WORK, "twins_gather")
    os.makedirs(root, exist_ok=True)
    with contextlib.chdir(root):
        gathered = gather_pretrained_models.main(args)
    copied = sorted(os.listdir(os.path.join(root, "gathered_pretrained"))) if gathered else []
    print(f"cli.gather_pretrained_models: gathered {gathered}, skipped {len(gather_pretrained_models.EXPERIMENTS) - len(gathered)}",
          flush=True)
    if not present or gathered != present or copied != sorted(present):
        fail(f"cli.gather_pretrained_models gathered {gathered} ({copied} copied); the earlier phases wrote {present}")

    root = os.path.join(WORK, "twins_droplidar")
    args = ablation_overrides(root) + ["experiment.dataset.country=CH", f"run_type.test_subset={ABLATION_TEST_TILES}"]
    as_best_val_iou(compose(["experiment=p2p_fusion", "experiment.lidar_dropout=0.5", "evaluation=test",
                             "checkpoint=best_val_iou"] + args), fusion_latest)
    t0 = time.perf_counter()
    pillar_sums_cuda.launches = 0
    with contextlib.chdir(root):
        df = droplidar50_ablation.main(args)
    wall = time.perf_counter() - t0
    launches, pillar_launches = afm_cuda.launches, pillar_sums_cuda.launches
    if list(df.get("variant", [])) != ["with_lidar", "no_lidar"] or set(df["num_images"]) != {ABLATION_TEST_TILES}:
        fail(f"cli.droplidar50_ablation did not score both rows on the split: {df}")
    rows = df.drop(columns=["variant", "prediction_time"]).to_dict("records")
    differ = {k: (a, rows[1][k]) for k, a in rows[0].items() if not (a == rows[1][k] or a != a and rows[1][k] != rows[1][k])}
    print(f"cli.droplidar50_ablation in {wall:.1f} s (ROADMAP 3.15): the two rows differ in {differ or 'nothing'}; afm "
          f"launches {launches}, pillar_sums launches {pillar_launches}; card {smi}", flush=True)
    if differ or not pillar_launches:
        fail(f"cli.droplidar50_ablation: its two rows predict with one model on the same inputs and differ in "
             f"{differ}, or it launched the pillar_sums kernel {pillar_launches} times")
    return {"gathered": gathered, "differ": differ, "wall_s": wall, "launches": launches,
            "pillar_launches": pillar_launches}


def phase_script_twins(seeded_p2p: str, fusion_latest: str, smi: str) -> dict:
    """Phase 24: the last script twins on the card, each through its `main`,
    with the AFM counter set to 0 just before each and read just after."""
    t0 = time.perf_counter()
    out = {"oracle": twin_oracle(), "predict_e2e": twin_predict_timer(seeded_p2p, smi), "profile": twin_profile(smi),
           "gather_droplidar": twin_gather_and_droplidar(fusion_latest, smi)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 24 (the last script twins) in {out['wall_s']:.1f} s; card {smi}", flush=True)
    return out


# --- the LiDAR and fusion grid (phase 25) ------------------------------------------


@contextlib.contextmanager
def counted_predictions(module, rows: dict, repeat: tuple[str, ...] = (), prefix: str = "grid"):
    """While the block runs, each predictor that `module.get_predictor` gives
    sets the kernel counters to 0 just before each `predict_dataset` and
    reads them just after; records by experiment its tiles, batches,
    tiles/s (the predictor's `*_time.json`), wall seconds and launches in
    `rows`; and, for the experiments in `repeat`, predicts the split a
    second time and holds the prediction file to the first byte for byte
    (`hold_repeat`, path `<prefix>_<experiment>`)."""
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda

    get_predictor = module.get_predictor

    def counted(cfg, *args, **kwargs):
        predictor = get_predictor(cfg, *args, **kwargs)
        predict = predictor.predict_dataset
        exp = str(cfg.experiment.name)

        def predict_dataset(split):
            afm_cuda.launches = pillar_sums_cuda.launches = 0
            t0 = time.perf_counter()
            path = predict(split)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(path.replace(".json", "_time.json")) as f:
                timing = json.load(f)
            row = {"tiles": timing["num_images"], "batches": math.ceil(timing["num_images"] / B),
                   "tiles_s": 1.0 / timing["prediction_time"], "wall_s": wall, "afm": afm_cuda.launches,
                   "pillar_sums": [pillar_sums_cuda.launches], "country": str(cfg.experiment.dataset.country),
                   "encoder": type(predictor.model.encoder).__name__}
            if exp in repeat:
                with open(path, "rb") as f:
                    first = f.read()
                afm_cuda.launches = pillar_sums_cuda.launches = 0
                predict(split)
                torch.cuda.synchronize()
                row["afm"] += afm_cuda.launches
                row["pillar_sums"].append(pillar_sums_cuda.launches)
                with open(path, "rb") as f:
                    hold_repeat(f"{prefix}_{exp}", first, f.read(), row["pillar_sums"])
            rows[exp] = row
            return path

        predictor.predict_dataset = predict_dataset
        return predictor

    module.get_predictor = counted
    try:
        yield rows
    finally:
        module.get_predictor = get_predictor


def rounded(metrics: dict) -> dict:
    return {k: round(float(v), 4) if isinstance(v, (int, float, np.number)) else v for k, v in metrics.items()}


def hold_rows(what: str, df, column: str, want: list, rows: dict, lidar: set, smi: str) -> None:
    """Fail unless the twin's DataFrame has a row for each of `want` in
    order, each with finite IoU and C-IoU, no AFM launch, and the pillar
    sums launched once a batch on each LiDAR or fusion row (every
    prediction of it) and no time on an image row; print each row."""
    got = [str(v) for v in df.get(column, [])]
    if got != [str(w) for w in want]:
        fail(f"{what}: rows {got}, expected every one of {want} (a [skip] line is a failure here)")
    for record in df.to_dict("records"):
        exp = str(record[column]) if column == "experiment" else f"lidar_density_mnv{record[column]}"
        row = rows.get(exp)
        metrics = {k: v for k, v in record.items() if k != column}
        if row is None or not all(np.isfinite(metrics.get(k, np.nan)) for k in ("IoU", "C-IoU")):
            fail(f"{what} {exp}: no prediction recorded, or non-finite metrics {metrics}")
        per_pass = row["batches"] if exp in lidar else 0
        print(f"{what} {exp} ({row['encoder']}, country {row['country']}): {row['tiles']} tiles, {row['tiles_s']:.2f} "
              f"tiles/s (its *_time.json), {row['wall_s']:.1f} s; afm launches {row['afm']}, pillar_sums launches "
              f"{row['pillar_sums']} (expected {per_pass} a prediction); metrics "
              f"{json.dumps(rounded(metrics))}; card {smi}", flush=True)
        if row["afm"] or any(n != per_pass for n in row["pillar_sums"]):
            fail(f"{what} {exp}: {row['afm']} afm launches, pillar_sums {row['pillar_sums']} (expected {per_pass} a "
                 f"prediction)")


def grid_checkpoints(root: str, earlier: dict) -> dict:
    """Each experiment of the modality grid written as `best_val_iou` under
    `root`: an earlier phase's checkpoint where `earlier` names one, else a
    seeded random model of its own (FFL's seg head shifted so its maps have
    contours, `ffl_seeded_model`). Returns the source of each."""
    from pixelspointspolygons_torch.cli import modality_ablation
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.hisup.factory import build_hisup
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer, build_pix2poly

    sources = {}
    for exp in modality_ablation.EXPERIMENTS:
        cfg = compose([f"experiment={exp}", "evaluation=test", "checkpoint=best_val_iou"] + ablation_overrides(root))
        path = earlier.get(exp)
        if path:
            as_best_val_iou(cfg, path)
            sources[exp] = os.path.relpath(path, WORK)
            continue
        family = cfg.experiment.model.name
        gen = torch.Generator(device=CARD).manual_seed(GRID_SEED)
        if family == "ffl":
            model = ffl_seeded_model(cfg)
        elif family == "hisup":
            model = build_hisup(cfg, device=CARD, generator=gen)
        else:
            model = build_pix2poly(cfg, Tokenizer(cfg), device=CARD, generator=gen)
        as_best_val_iou(cfg, model=model)
        sources[exp] = "seeded"
        del model
    return sources


def grid_modality(root: str, earlier: dict, smi: str) -> dict:
    """(a) `cli.modality_ablation` over its nine experiments at their own
    configs (the fusion rows at `country: all`): the six LiDAR and fusion
    rows on the first GRID_LIDAR_TEST_TILES test tiles, each predicted
    twice and held byte for byte, then the three image rows on the first
    ABLATION_TEST_TILES."""
    from pixelspointspolygons_torch.cli import _ablation, modality_ablation
    from pixelspointspolygons_torch.config import compose

    t0 = time.perf_counter()
    sources = grid_checkpoints(root, earlier)
    print(f"modality grid checkpoints (best_val_iou): {json.dumps(sources)}", flush=True)
    experiments = list(modality_ablation.EXPERIMENTS)
    lidar = {e for e in experiments if compose([f"experiment={e}", "run_type=debug"]).experiment.encoder.use_lidar}
    rows, frames = {}, []
    # the image rows on ABLATION_TEST_TILES: phases 5, 6 and 14 predict their whole splits
    runs = (((e for e in experiments if e in lidar), [f"run_type.test_subset={GRID_LIDAR_TEST_TILES}"]),
            ((e for e in experiments if e not in lidar), [f"run_type.test_subset={ABLATION_TEST_TILES}"]))
    with counted_predictions(_ablation, rows, tuple(lidar), "modality"), contextlib.chdir(root):
        for subset, extra in runs:
            modality_ablation.EXPERIMENTS = list(subset)
            try:
                frames.append(modality_ablation.main(ablation_overrides(root) + extra))
            finally:
                modality_ablation.EXPERIMENTS = experiments
    import pandas as pd

    df = pd.concat(frames, ignore_index=True)
    order = [e for e in experiments if e in lidar] + [e for e in experiments if e not in lidar]
    hold_rows("modality_ablation", df, "experiment", order, rows, lidar, smi)
    fusion = {e: rows[e]["country"] for e in modality_ablation.EXPERIMENTS if e.endswith("_fusion")}
    tiles = {e: rows[e]["tiles"] for e in experiments}
    if set(fusion.values()) != {"all"} or any(n != (GRID_LIDAR_TEST_TILES if e in lidar else ABLATION_TEST_TILES)
                                               for e, n in tiles.items()):
        fail(f"modality_ablation: the fusion rows' countries {fusion}, or tiles by row {tiles}")
    wall = time.perf_counter() - t0
    print(f"phase 25 (a) cli.modality_ablation: 9 rows in {wall:.1f} s; card {smi}", flush=True)
    return {"rows": rows, "sources": sources, "wall_s": wall}


def grid_density(root: str, smi: str) -> dict:
    """(b) `cli.lidar_density_ablation`: one seeded FFL-LiDAR written as the
    `best_val_iou` of each of the eight caps (a cap changes the pillars'
    grouping, not the parameters: each cap's model loads the weights
    strictly), on the first ABLATION_TEST_TILES test tiles."""
    from pixelspointspolygons_torch.cli import _ablation, lidar_density_ablation
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.ffl import build_ffl

    t0 = time.perf_counter()
    over = ablation_overrides(root) + [f"run_type.test_subset={ABLATION_TEST_TILES}"]
    cfgs = {m: compose([f"experiment=lidar_density_ablation{m}", "evaluation=test", "checkpoint=best_val_iou"] + over)
            for m in lidar_density_ablation.DENSITIES}
    model = ffl_seeded_model(cfgs[lidar_density_ablation.DENSITIES[0]])
    weights = model.state_dict()
    for m, cfg in cfgs.items():
        if int(cfg.experiment.encoder.max_num_points_per_voxel) != m:
            fail(f"lidar_density_ablation{m}: its encoder's cap is {cfg.experiment.encoder.max_num_points_per_voxel}")
        try:
            build_ffl(cfg, device=CARD).load_state_dict(weights)
        except RuntimeError as e:
            fail(f"lidar_density_ablation{m}: the seeded weights do not load: {e}")
        as_best_val_iou(cfg, model=model)
    del model, weights
    rows = {}
    with counted_predictions(_ablation, rows), contextlib.chdir(root):
        df = lidar_density_ablation.main(over)
    hold_rows("lidar_density_ablation", df, "max_num_points_per_voxel", lidar_density_ablation.DENSITIES, rows,
              set(rows), smi)
    by_cap = {m: {"IoU": float(r["IoU"]), "s": rows[f"lidar_density_mnv{m}"]["wall_s"]}
              for m, r in zip(df["max_num_points_per_voxel"], df.to_dict("records"))}
    wall = time.perf_counter() - t0
    print(f"phase 25 (b) cli.lidar_density_ablation: IoU and prediction seconds by cap {json.dumps(by_cap)}; "
          f"{wall:.1f} s; card {smi}", flush=True)
    return {"rows": rows, "by_cap": by_cap, "wall_s": wall}


def grid_countries(root: str, smi: str) -> dict:
    """(c) `cli.all_countries`: its three fusion rows at `country=all` on the
    first ABLATION_TEST_TILES test tiles, from (a)'s checkpoints; each
    predicted twice and held byte for byte."""
    from pixelspointspolygons_torch.cli import _ablation, all_countries

    t0 = time.perf_counter()
    rows = {}
    over = ablation_overrides(root) + [f"run_type.test_subset={ABLATION_TEST_TILES}"]
    with counted_predictions(_ablation, rows, tuple(all_countries.EXPERIMENTS), "countries"), contextlib.chdir(root):
        df = all_countries.main(over)
    hold_rows("all_countries", df, "experiment", all_countries.EXPERIMENTS, rows, set(all_countries.EXPERIMENTS), smi)
    if {r["country"] for r in rows.values()} != {"all"}:
        fail(f"all_countries: rows at {[r['country'] for r in rows.values()]}, not all at country=all")
    wall = time.perf_counter() - t0
    print(f"phase 25 (c) cli.all_countries: 3 rows in {wall:.1f} s; card {smi}", flush=True)
    return {"rows": rows, "wall_s": wall}


def grid_dense(smi: str) -> dict:
    """(d) `experiment=hisup_lidar encoder=pointpillars` (the dense encoder on
    512 px synthetic tiles, 256 x 256 pillars at cap 4) through phase 17's
    path, then its test split predicted from `latest` twice, the two files
    held byte for byte, and evaluated."""
    from pixelspointspolygons_torch.cli.evaluate import evaluate
    from pixelspointspolygons_torch.cli.predict import get_predictor
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda

    t0 = time.perf_counter()
    over = smoke_overrides(GRID_TRAIN_STEPS * B, "hisup_lidar") + [
        "encoder=pointpillars", f"experiment.dataset.num_test={DENSE_TEST_TILES}"]
    enc = compose(over).experiment.encoder
    print(f"hisup_lidar_dense: {enc.name} at {enc.in_size} px, pillars of {enc.in_voxel_size.x} px, cap "
          f"{enc.max_num_points_per_voxel}, {enc.max_num_points} points a cloud", flush=True)
    train = phase_hisup_lidar_train(over, "hisup_lidar_dense", "PointPillarsDenseEncoder", bf16_step=False,
                                    steps=GRID_TRAIN_STEPS, cpu_tiles=DENSE_CPU_TILES)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = compose(over + ["evaluation=test", "checkpoint=latest"])
    predictor = get_predictor(cfg, CARD)
    files, launches = [], []
    for _ in range(2):
        afm_cuda.launches = pillar_sums_cuda.launches = 0
        path = predictor.predict_dataset(cfg.evaluation.split)
        torch.cuda.synchronize()
        launches.append((afm_cuda.launches, pillar_sums_cuda.launches))
        with open(path, "rb") as f:
            files.append(f.read())
    hold_repeat("hisup_lidar_dense_split", files[0], files[1], [p for _, p in launches])
    with open(path.replace(".json", "_time.json")) as f:
        timing = json.load(f)
    results = evaluate(cfg, path)
    batches = math.ceil(timing["num_images"] / B)
    print(f"hisup_lidar_dense predict path: {timing['num_images']} tiles at {1.0 / timing['prediction_time']:.2f} "
          f"tiles/s; (afm, pillar_sums) launches per prediction {launches}; metrics "
          f"{json.dumps(rounded(results))}; card {smi}", flush=True)
    if timing["num_images"] != DENSE_TEST_TILES or any(lp != (0, batches) for lp in launches) or not all(
            np.isfinite(results.get(k, np.nan)) for k in ("IoU", "C-IoU")):
        fail(f"hisup_lidar_dense prediction: {timing['num_images']} tiles, launches {launches}, metrics {results}")
    del predictor
    wall = time.perf_counter() - t0
    print(f"phase 25 (d) hisup_lidar with the dense encoder: train step {train['step_ms']:.1f} ms, by layer "
          f"{json.dumps({k: round(v, 2) for k, v in train['breakdown'].items()})}, peak "
          f"{train['peak_bytes'] / 2**30:.2f} GiB, val IoU {train['val_iou']:.4f}, host loader {train['loader_ms']:.1f} "
          f"ms per batch; {wall:.1f} s; card {smi}", flush=True)
    return {**train, "predict_launches": launches, "tiles_s": 1.0 / timing["prediction_time"], "results": results,
            "wall_s": wall}


def release_overrides(experiment: str) -> list[str]:
    """`experiment` under the config tree's default run type (release: 8
    loader threads, the train split shuffled, no subsets), with only the
    overrides that bound the synthetic split and the run's steps, the
    split's counts the other phases'."""
    return [f"experiment={experiment}", "dataset=synthetic", f"experiment.dataset.num_train={TRAIN_TILES}",
            "experiment.dataset.num_val=16", f"experiment.dataset.num_test={TEST_TILES}",
            "experiment.model.num_epochs=1", "training.save_every=0"]


def grid_release(fusion_latest: str, smi: str) -> dict:
    """(e) `run_type=release` on the card's host: the first RELEASE_BATCHES
    train batches of hisup_lidar and p2p_fusion from the 8-thread loader
    and a 0-thread loader of the same seed, bitwise equal; hisup_lidar
    trained GRID_TRAIN_STEPS steps through the trainer from the 8-thread loader
    (AFM once a step); the loader's ms per batch at 8 and 0 threads in
    turns; `cli.measure_predict_e2e` on the seeded p2p_fusion under
    release with `run_type.test_subset=RELEASE_TEST_TILES`."""
    from pixelspointspolygons_torch.cli import measure_predict_e2e
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import build_loader, device_prefetch
    from pixelspointspolygons_torch.models.pix2poly import Tokenizer
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train.trainer_hisup import _DEV_KEYS, HiSupTrainer

    t0 = time.perf_counter()
    out = {}
    for exp in ("hisup_lidar", "p2p_fusion"):
        cfg = compose(release_overrides(exp))
        tok = {"tokenizer": Tokenizer(cfg)} if exp.startswith("p2p") else {}
        threaded = build_loader(cfg, "train", **tok)
        plain = build_loader(compose(release_overrides(exp) + ["run_type.num_workers=0"]), "train", **tok)
        if (cfg.run_type.name, threaded.num_workers, plain.num_workers, threaded.shuffle) != ("release", 8, 0, True):
            fail(f"{exp} under release: run type {cfg.run_type.name}, threads {threaded.num_workers} and "
                 f"{plain.num_workers}, shuffle {threaded.shuffle}")
        got = [b for _, b in zip(range(RELEASE_BATCHES), threaded)]
        want = [b for _, b in zip(range(RELEASE_BATCHES), plain)]
        a, b = [(p, leaf_bits(x)) for p, x in leaves(got)], [(p, leaf_bits(x)) for p, x in leaves(want)]
        differ = [p for (p, x), (q, y) in zip(a, b) if p != q or x != y] + ([] if len(a) == len(b) else ["length"])
        ids = [batch["image_id"].tolist() for batch in got]
        print(f"{exp} under release (country {cfg.experiment.dataset.country}): the first {len(got)} train batches "
              f"from 8 threads and from 0, {len(a)} leaves, bitwise equal {not differ}; image ids {ids}", flush=True)
        if differ or len(got) != RELEASE_BATCHES:
            fail(f"{exp} under release: the 8-thread batches differ from the 0-thread ones at {differ[:8]}")
        out[exp] = {"ids": ids}

    cfg = compose(release_overrides("hisup_lidar"))
    trainer = HiSupTrainer(cfg, device=CARD)
    trainer.generator = torch.Generator(device=CARD).manual_seed(int(cfg.get("seed", 42)))
    trainer.setup()
    loader_ms = {8: [], 0: []}
    for turn in (8, 0, 8, 0):
        trainer.train_loader.num_workers = turn
        batches = iter(trainer.train_loader)
        t = time.perf_counter()
        for _ in range(LOADER_TURN_BATCHES):
            next(batches)
        loader_ms[turn].append((time.perf_counter() - t) * 1e3 / LOADER_TURN_BATCHES)
        del batches  # its threads finish the batches in flight
    trainer.train_loader.num_workers = 8
    afm_cuda.launches = pillar_sums_cuda.launches = 0
    losses, step_ms = [], []
    t = time.perf_counter()
    for batch in device_prefetch(trainer.train_loader, CARD, _DEV_KEYS):
        metrics = trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        losses.append({k: float(v) for k, v in metrics.items()})
        step_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
    launches = (afm_cuda.launches, pillar_sums_cuda.launches)
    print(f"hisup_lidar under release: {len(losses)} train steps from the 8-thread loader, wall ms a step (loader "
          f"included) {[round(x, 1) for x in step_ms]}; (afm, pillar_sums) launches {launches}; losses {losses}; the "
          f"loader alone {json.dumps({k: [round(x, 1) for x in v] for k, v in loader_ms.items()})} ms per batch at 8 "
          f"and 0 threads, in turns; card {smi}", flush=True)
    if len(losses) != GRID_TRAIN_STEPS or launches != (GRID_TRAIN_STEPS, GRID_TRAIN_STEPS) or not all(
            np.isfinite(v) for m in losses for v in m.values()):
        fail(f"hisup_lidar under release: {len(losses)} steps, launches {launches}, losses {losses}")
    out["hisup_lidar"].update(losses=losses, step_ms=step_ms, loader_ms=loader_ms, launches=launches)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    args = release_overrides("p2p_fusion") + [f"host.model_root={os.path.join(WORK, 'release')}", "evaluation=test",
                                              "checkpoint=latest", f"run_type.test_subset={RELEASE_TEST_TILES}"]
    cfg = compose(args)
    os.makedirs(os.path.join(cfg.output_dir, "checkpoints"), exist_ok=True)
    shutil.copyfile(fusion_latest, os.path.join(cfg.output_dir, "checkpoints", "latest.pt"))
    afm_cuda.launches = pillar_sums_cuda.launches = 0
    report = measure_predict_e2e.main(args)
    launches = (afm_cuda.launches, pillar_sums_cuda.launches)
    per_pass = math.ceil(RELEASE_TEST_TILES / B)
    print(f"cli.measure_predict_e2e p2p_fusion under release (8 loader threads, test subset {RELEASE_TEST_TILES}): "
          f"{json.dumps(report)}; (afm, pillar_sums) launches {launches}; card {smi}", flush=True)
    if report["tiles"] != RELEASE_TEST_TILES or launches != (0, 4 * per_pass):
        fail(f"cli.measure_predict_e2e under release: {report['tiles']} tiles, launches {launches} (expected "
             f"{RELEASE_TEST_TILES} tiles and (0, {4 * per_pass}))")
    out["predict_e2e"] = {"report": report, "launches": launches}
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 25 (e) run_type=release: {out['wall_s']:.1f} s; card {smi}", flush=True)
    return out


def phase_grid(earlier: dict, fusion_latest: str, smi: str) -> dict:
    """Phase 25: the LiDAR and fusion grid through the port's entry points,
    each part failing the run on its own and printing its seconds, the
    kernel counters set to 0 just before each prediction or training and
    read just after."""
    root = os.path.join(WORK, "grid")
    out = {"modality": grid_modality(root, earlier, smi)}
    out["density"] = grid_density(root, smi)
    out["countries"] = grid_countries(root, smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["dense"] = grid_dense(smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["dense_ffl"] = grid_dense_ffl(smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["release"] = grid_release(fusion_latest, smi)
    return out


def grid_dense_ffl(smi: str) -> dict:
    """(d), FFL: `experiment=ffl_lidar encoder=pointpillars` (the dense
    encoder at 512 px, `decoder.in_feature_dim` 32 by `config/model/ffl.yaml`)
    one train step at batch 16 through its trainer's set-up with the
    counters set to 0 just before and read just after (the pillar sums
    once, 0 AFM launches), the next step timed, the peak, and an eval
    forward on DENSE_FFL_CPU_TILES tiles on the card against the CPU and
    against a second forward on the card (`forward_against_cpu`)."""
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.data.loader import device_prefetch
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train.trainer_ffl import FFL_BATCH_KEYS, FFLTrainer

    t0 = time.perf_counter()
    cfg = compose(smoke_overrides(GRID_TRAIN_STEPS * B, "ffl_lidar") + ["encoder=pointpillars"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = FFLTrainer(cfg, device=CARD)
    trainer.generator = torch.Generator(device=CARD).manual_seed(int(cfg.get("seed", 42)))
    trainer.setup()
    model = trainer.state.model
    batch = next(iter(device_prefetch(trainer.train_loader, CARD, FFL_BATCH_KEYS)))
    weights = trainer._weights_for_epoch(0)
    afm_cuda.launches = pillar_sums_cuda.launches = 0
    metrics = {k: float(v) for k, v in trainer._train_step(trainer.state, batch, weights).items()}
    torch.cuda.synchronize()
    launches, pillar_launches = afm_cuda.launches, pillar_sums_cuda.launches
    t = time.perf_counter()
    trainer._train_step(trainer.state, batch, weights)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"ffl_lidar_dense (float32, encoder {type(model.encoder).__name__} at {cfg.experiment.encoder.in_size} px, "
          f"decoder width {cfg.experiment.model.decoder.in_feature_dim}): one train step at batch {B}: losses "
          f"{ {k: round(v, 6) for k, v in metrics.items()} }, afm launches {launches}, pillar_sums launches "
          f"{pillar_launches}; the next step {step_ms:.1f} ms; peak {peak / 2**30:.2f} GiB", flush=True)
    if not all(np.isfinite(v) for v in metrics.values()) or launches or pillar_launches != 1:
        fail(f"ffl_lidar_dense: the step gave {metrics} with {launches} afm launches (expected 0) and "
             f"{pillar_launches} pillar_sums launches (expected 1)")
    if type(model.encoder).__name__ != "PointPillarsDenseEncoder":
        fail(f"ffl_lidar_dense: the encoder is {type(model.encoder).__name__}")
    errs = forward_against_cpu("ffl_lidar_dense", model, "ffl",
                               {k: v[:DENSE_FFL_CPU_TILES] for k, v in batch.items()}, "float32")
    wall = time.perf_counter() - t0
    print(f"phase 25 (d) ffl_lidar with the dense encoder: step {step_ms:.1f} ms, peak {peak / 2**30:.2f} GiB; "
          f"{wall:.1f} s; card {smi}", flush=True)
    del trainer, model, batch
    return {"step_ms": step_ms, "peak_bytes": peak, "launches": launches, "pillar_launches": pillar_launches,
            "losses": metrics, "errs": errs, "wall_s": wall}


def _prebuild_trained(out_file: str) -> None:
    """Phase 26's synthetic split written and its train and val splits
    packed for the device cache (`cli.prebuild_caches`, host only), in a
    process of its own held to one core, so that the phases it runs beside
    keep the others (on all of them it slowed phase 4 by about 10 s); its
    seconds and rows to `out_file`."""
    import cv2

    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    cv2.setNumThreads(1)
    torch.set_num_threads(1)
    from pixelspointspolygons_torch.cli import prebuild_caches

    t = time.perf_counter()
    rows = prebuild_caches.main(["ffl_image", "train", "val", *trained_overrides()])
    with open(out_file, "w") as f:
        json.dump({"s": time.perf_counter() - t, "rows": rows}, f)


def start_trained_prebuild() -> dict:
    """Start `_prebuild_trained` beside the first phases (a daemon: it ends
    with this process); phase 26 joins it."""
    os.makedirs(WORK, exist_ok=True)
    out_file = os.path.join(WORK, "trained_prebuild.json")
    if os.path.exists(out_file):
        os.remove(out_file)
    proc = multiprocessing.get_context("spawn").Process(target=_prebuild_trained, args=(out_file,), daemon=True)
    proc.start()
    return {"proc": proc, "out_file": out_file, "t0": time.perf_counter()}


@contextlib.contextmanager
def first_step(trainer_cls, first: dict):
    """While open, the first train step of a `trainer_cls` run leaves in
    `first` its weights before the step (on the host), its batch (on the
    card) and its losses."""
    saved = trainer_cls.setup

    def setup(self):
        saved(self)
        step = self._train_step

        def recorded(state, batch, *args):
            if first:
                return step(state, batch, *args)
            first["state"] = {k: v.detach().to("cpu", copy=True) for k, v in state.model.state_dict().items()}
            first["batch"] = {k: v.clone() for k, v in batch.items()}
            metrics = step(state, batch, *args)
            first["losses"] = {k: float(v) for k, v in metrics.items()}
            return metrics

        self._train_step = recorded

    trainer_cls.setup = setup
    try:
        yield first
    finally:
        trainer_cls.setup = saved


def trained_overrides(extra: tuple[str, ...] = ()) -> list[str]:
    """Phase 26's run: FFL-image at bfloat16 from the device cache on the
    synthetic split at its own counts, in a dataset and model root of its
    own (the 64-tile tree of the other phases is not rebuilt)."""
    return ["experiment=ffl_image", "dataset=synthetic", "run_type=debug",
            f"host.dataset_root={os.path.join(WORK, 'trained', 'data')}",
            f"host.model_root={os.path.join(WORK, 'trained', 'outputs')}",
            "run_type.train_subset=null", "run_type.val_subset=null", "run_type.test_subset=null",
            "experiment.model.batch_size=16", "host.compute_dtype=bfloat16", "training.device_cache=true",
            f"experiment.model.num_epochs={TRAINED_EPOCHS}",
            f"init_weights_from={os.path.join(WORK, 'ffl_seeded_init.pt')}", *extra]


def phase_trained_ffl(seeded: dict, prebuild: dict, smi: str) -> dict:
    """Phase 26: FFL-image trained for TRAINED_EPOCHS epochs through
    `cli.train`'s `main` (its epochs recorded by `trained_run.record_epochs`)
    from the split that `prebuild` (`start_trained_prebuild`) wrote and
    packed, one epoch more resumed from `latest`, and the test split
    predicted from `best_val_iou` twice; `seeded` is phase 14's prediction
    of the same split by a seeded model, printed beside."""
    from pixelspointspolygons_torch.cli import train as cli_train
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.models.ffl.losses import make_ffl_loss
    from pixelspointspolygons_torch.ops.afm import afm_cuda
    from pixelspointspolygons_torch.ops.voxelize import pillar_sums_cuda
    from pixelspointspolygons_torch.train.state import cosine_with_warmup
    from pixelspointspolygons_torch.train.trainer_ffl import FFLTrainer
    from trained_run import epoch_line, record_epochs

    t0 = time.perf_counter()
    prebuild["proc"].join()
    if prebuild["proc"].exitcode != 0 or not os.path.exists(prebuild["out_file"]):
        fail(f"phase 26: the split's prebuild process ended with {prebuild['proc'].exitcode}")
    with open(prebuild["out_file"]) as f:
        prep = json.load(f)
    print(f"trained ffl: the split written and its train and val splits packed by cli.prebuild_caches in "
          f"{prep['s']:.1f} s ({prep['rows']} rows), in a process started {t0 - prebuild['t0']:.1f} s before this "
          f"phase; waited {time.perf_counter() - t0:.1f} s for it", flush=True)
    overrides = trained_overrides()
    cfg = compose(overrides)
    ds = cfg.experiment.dataset
    epochs, trainers, first = [], [], {}
    gc.collect()
    torch.cuda.empty_cache()
    afm_cuda.launches = pillar_sums_cuda.launches = 0
    with record_epochs(FFLTrainer, epochs, trainers), first_step(FFLTrainer, first):
        history = cli_train.main(overrides)
    torch.cuda.synchronize()
    launches = (afm_cuda.launches, pillar_sums_cuda.launches)
    train_s = time.perf_counter() - t0
    trainer = trainers[0]
    if trainer.cache is None:
        fail("phase 26: the FFL trainer took the host loader, not the device cache")
    steps = len(trainer.cache["train"])
    print(f"trained ffl: {ds.num_train} train, {ds.num_val} val tiles, batch {B}, {cfg.host.compute_dtype}, "
          f"{len(epochs)} epochs of {steps} steps (the host loader's {len(trainer.train_loader)}) in {train_s:.1f} s "
          f"(set-up included); ground truth and pack, then upload: {cache_setup_line(trainer)}; (afm, pillar_sums) "
          f"launches {launches}", flush=True)
    for rec in epochs:
        print("  " + epoch_line(rec), flush=True)
    _, weights_for_epoch = make_ffl_loss(cfg)
    base_lr = float(cfg.experiment.model.learning_rate)
    schedule = cosine_with_warmup(base_lr, steps * TRAINED_EPOCHS)
    lr_err = [abs(r["lr_last"] / schedule(r["step"] - 1) - 1.0) for r in epochs]
    weights_ok = all(epochs[e]["weights"] == weights_for_epoch(e) and epochs[e]["weights_constant"]
                     for e in TRAINED_WEIGHT_EPOCHS)
    losses_ok = all(np.isfinite(v) for r in epochs for k, v in r.items()
                    if k == "loss" or k.startswith(("val_", "seg", "crossfield")))
    val = {r["epoch"]: (r["val_iou"], r["val_ciou"]) for r in epochs if "val_iou" in r}
    peaks = (epochs[0]["peak_bytes"], epochs[-1]["peak_bytes"])
    names = ("best_val_iou", "latest", f"epoch_{TRAINED_EPOCHS - 1}")
    written = {n: trainer.manager.exists(n) for n in names}
    print(f"trained ffl: val IoU and C-IoU by epoch {json.dumps(val)}; LR at each epoch's last step against the "
          f"schedule, largest relative difference {max(lr_err):.3g} (tol {TRAINED_LR_RTOL}); weights at epochs "
          f"{TRAINED_WEIGHT_EPOCHS} as `weights_for_epoch`: {weights_ok}; peak at epochs 0 and "
          f"{TRAINED_EPOCHS - 1}: {peaks[0] / 2**30:.3f} and {peaks[1] / 2**30:.3f} GiB; checkpoints {written}; "
          f"card {smi}", flush=True)
    if len(epochs) != TRAINED_EPOCHS or steps != len(trainer.train_loader) or steps * B != ds.num_train:
        fail(f"phase 26: {len(epochs)} epochs of {steps} steps (the host loader's {len(trainer.train_loader)})")
    if launches != (0, 0) or not losses_ok or not np.isfinite(history["loss"]):
        fail(f"phase 26: launches {launches}, finite losses {losses_ok}")
    if max(lr_err) > TRAINED_LR_RTOL or not weights_ok or not all(written.values()):
        fail(f"phase 26: LR error {max(lr_err)}, weights {weights_ok}, checkpoints {written}")
    if sorted(val) != [4, 9, TRAINED_EPOCHS - 1] or val[TRAINED_EPOCHS - 1][0] < TRAINED_MIN_IOU:
        fail(f"phase 26: the val IoU at epoch {TRAINED_EPOCHS - 1} is below {TRAINED_MIN_IOU}: {val}")
    if abs(peaks[1] / peaks[0] - 1.0) > TRAINED_PEAK_RTOL:
        fail(f"phase 26: the peak at the last epoch {peaks[1]} is not within {TRAINED_PEAK_RTOL} of the first's "
             f"{peaks[0]}")
    step_before = int(trainer.state.step)
    del trainer, trainers[:]
    gc.collect()
    torch.cuda.empty_cache()

    # phase 15's bfloat16 checks: the first step against a float32 step from the same weights on the same batch,
    # and the maps on the card against the CPU from those weights
    f32 = ffl_step_losses(compose(overrides + ["host.compute_dtype=float32"]), first["state"], first["batch"],
                          weights_for_epoch(0))
    loss_err = {k: abs(first["losses"][k] / f32[k] - 1.0) for k in f32}
    print(f"trained ffl: the first step (bfloat16, from the cache) against a float32 step from the same weights on "
          f"the same batch: bfloat16 {first['losses']}, float32 {f32}; rel diff {loss_err} (tol {FFL_BF16_LOSS_TOL})",
          flush=True)
    if set(loss_err) != set(FFL_BF16_LOSS_TOL) or any(e > FFL_BF16_LOSS_TOL[k] for k, e in loss_err.items()):
        fail(f"the bfloat16 FFL step's losses differ from float32's by {loss_err}")
    ffl_bf16_card_against_cpu(cfg, {"state": first["state"],
                                    "batch": {k: v[:BF16_EVAL_TILES].cpu() for k, v in first["batch"].items()}})
    del first

    # one more epoch, resumed from `latest` at full width
    t = time.perf_counter()
    resumed_epochs, resumed = [], []
    afm_cuda.launches = 0
    with record_epochs(FFLTrainer, resumed_epochs, resumed):
        more = cli_train.main(overrides + ["checkpoint=latest", f"experiment.model.num_epochs={TRAINED_EPOCHS + 1}"])
    torch.cuda.synchronize()
    trainer = resumed[0]
    print(f"trained ffl resumed from latest: start epoch {trainer.start_epoch}, steps {step_before} before and "
          f"{trainer.state.step} after, {time.perf_counter() - t:.1f} s; "
          + "; ".join(epoch_line(r) for r in resumed_epochs), flush=True)
    if (trainer.start_epoch, step_before, int(trainer.state.step), len(resumed_epochs)) != (
            TRAINED_EPOCHS, steps * TRAINED_EPOCHS, steps * (TRAINED_EPOCHS + 1), 1) or afm_cuda.launches or not all(
            np.isfinite(v) for k, v in more.items() if k != "epoch"):
        fail(f"phase 26: the resume started at epoch {trainer.start_epoch} from step {step_before} and ended at "
             f"{trainer.state.step}; afm launches {afm_cuda.launches}; {more}")
    del trainer, resumed[:]
    gc.collect()
    torch.cuda.empty_cache()

    # the test split from best_val_iou, twice
    preds, files = [], []
    for _ in range(2):
        preds.append(phase_ffl_predict_tiles(overrides, "bfloat16", "trained ffl", ds.num_test, "best_val_iou"))
        with open(preds[-1]["pred_file"], "rb") as f:
            files.append(f.read())
    hold_repeat("ffl_image_trained_split", files[0], files[1], [0, 0])
    pred = preds[0]
    iou = pred["results"]["IoU"]
    for what, p in (("trained (best_val_iou, bfloat16)", pred), ("seeded (phase 14, float32)", seeded)):
        bt = p["batch_times"]
        print(f"ffl test split, {what}: {p['tiles_s']:.2f} tiles/s; per batch ACM "
              f"{[round(t['acm_ms'], 1) for t in bt]} ms, rings {[t['rings'] for t in bt]}, vertices "
              f"{[t['vertices'] for t in bt]}; IoU {p['results']['IoU']:.4f}, C-IoU {p['results']['C-IoU']:.4f}",
              flush=True)
    if iou < TRAINED_MIN_IOU or any(p["launches"] for p in preds):
        fail(f"phase 26: the test split's IoU from best_val_iou is {iou} (floor {TRAINED_MIN_IOU}); afm launches "
             f"{[p['launches'] for p in preds]}")
    wall = time.perf_counter() - t0
    print(f"phase 26 trained ffl: val IoU {val[TRAINED_EPOCHS - 1][0]:.4f} at epoch {TRAINED_EPOCHS - 1}, test IoU "
          f"{iou:.4f}; {wall:.1f} s; card {smi}", flush=True)
    return {"epochs": epochs, "val": val, "launches": launches, "predict_launches": pred["launches"], "test_iou": iou,
            "wall_s": wall}


# phase label -> its seconds, and when the last phase ended
PHASE_S: dict[str, float] = {}
PHASE_END = [T0]


def host_peak_gib() -> float:
    """The process's peak resident memory so far (getrusage's maxrss, KiB on
    Linux), GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def phase_done(label: str) -> None:
    """Print the seconds since the previous phase ended, and the host's
    peak resident memory so far, on a line of the phase's own, and keep the
    seconds for the run's table."""
    now = time.perf_counter()
    PHASE_S[label] = now - PHASE_END[0]
    PHASE_END[0] = now
    gc.collect()
    print(f"phase {label} took {PHASE_S[label]:.1f} s ({now - T0:.1f} s into the run); host peak resident memory "
          f"{host_peak_gib():.1f} GiB", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    os.environ["P3_DATASET_ROOT"] = os.path.join(WORK, "data")
    os.environ["P3_MODEL_ROOT"] = os.path.join(WORK, "outputs")
    from pixelspointspolygons_torch.config import compose
    from pixelspointspolygons_torch.device import set_deterministic, set_tf32

    # before any tensor reaches the card: cuBLAS reads its workspace setting
    # when its handle is created
    set_deterministic(CARD)
    set_tf32(False)
    smi = phase_host()
    print(f"card: {smi}", flush=True)
    check_deterministic("deterministic set-up, for every phase")
    phase_build()
    trained_prebuild = start_trained_prebuild()
    phase_done("1-2")
    overrides = smoke_overrides(TRAIN_STEPS * B)
    afm_row = phase_afm(compose(overrides))
    pillar_row = phase_pillar_sums()
    run_row = phase_run_sums()
    phase_done("3")
    launches, train = phase_train(overrides)
    phase_done("4")
    afm_row["launches"] = launches["afm"]
    print(f"main path: train step {train['step_ms']:.1f} ms, val step {train['val_ms']:.1f} ms, "
          f"val-IoU pass {train['iou_pass_ms']:.1f} ms, peak {train['peak_bytes']} bytes, card {smi}", flush=True)
    # the bfloat16 run below writes its own `latest` in the same directory
    float32_latest = os.path.join(WORK, "hisup_float32_latest.pt")
    shutil.copyfile(os.path.join(train["output_dir"], "checkpoints", "latest.pt"), float32_latest)
    pred = phase_predict(overrides)
    phase_done("5")
    print(f"predict path: {pred['tiles_s']:.2f} tiles/s, device {statistics.median(pred['device_ms']):.2f} ms and "
          f"host stage {statistics.median(pred['host_ms']):.2f} ms per batch of {B} (medians), "
          f"host stage on the ground truth {statistics.median(pred['oracle_host_ms']):.2f} ms per batch, "
          f"IoU {pred['results']['IoU']:.4f}, card {smi}", flush=True)
    p2p_overrides = smoke_overrides(TRAIN_STEPS * B, experiment="p2p_image")
    launches_bf16, train_bf16 = phase_train(overrides, "bfloat16")
    phase_done("10")
    loss_err = {k: abs(train_bf16["losses"][0][k] / train["losses"][0][k] - 1.0) for k in train["losses"][0]}
    print(f"HiSup first train step from the same weights on the same batch: float32 {train['losses'][0]}, "
          f"bfloat16 {train_bf16['losses'][0]}; rel diff {loss_err} (tol {HISUP_BF16_LOSS_TOL})", flush=True)
    if not all(e <= HISUP_BF16_LOSS_TOL for e in loss_err.values()):
        fail(f"the bfloat16 HiSup step's losses differ from float32's by {loss_err}")
    pred_bf16 = phase_predict(overrides, "bfloat16")
    phase_done("11")
    for dtype, t in (("float32", train), ("bfloat16", train_bf16)):
        print(f"HiSup train path ({dtype}): train step {t['step_ms']:.1f} ms, val step {t['val_ms']:.1f} ms, "
              f"val-IoU pass {t['iou_pass_ms']:.1f} ms (val IoU {t['val_iou']:.4f}), peak {t['peak_bytes']} bytes, "
              f"by layer {json.dumps({k: round(v, 2) for k, v in t['breakdown'].items()})}, card {smi}", flush=True)
    for dtype, p in (("float32", pred), ("bfloat16", pred_bf16)):
        print(f"HiSup predict path ({dtype}): {p['tiles_s']:.2f} tiles/s, device "
              f"{statistics.median(p['device_ms']):.2f} ms and host stage {statistics.median(p['host_ms']):.2f} ms "
              f"per batch of {B} (medians), IoU {p['results']['IoU']:.4f}, card {smi}", flush=True)
    grafts = phase_pretrained(overrides, p2p_overrides, float32_latest)
    print(f"pretrained and warm start (tensors loaded and kept at init): {json.dumps(grafts)}, card {smi}", flush=True)
    phase_done("12")
    phase_entry()
    phase_done("13")
    ffl_overrides = smoke_overrides(TRAIN_STEPS * B, experiment="ffl_image")
    ffl = phase_ffl(ffl_overrides)
    phase_done("14")
    bt = ffl["batch_times"]
    med = {k: statistics.median(t[k] for t in bt) for k in ("device_ms", "contours_ms", "acm_ms", "post_ms")}
    print(f"ffl predict path: {ffl['tiles_s']:.2f} tiles/s; per batch of {B} (medians): forward "
          f"{med['device_ms']:.2f} ms, contours {med['contours_ms']:.2f} ms, ACM {med['acm_ms']:.2f} ms, "
          f"post-processing {med['post_ms']:.2f} ms; ACM step {ffl['acm']['step_ms']:.3f} ms "
          f"({ffl['acm']['aten_per_step']:.1f} aten calls, {ffl['acm']['kernels_per_step']:.1f} kernels); "
          f"IoU {ffl['results']['IoU']:.4f}; ground-truth IoU {ffl['oracle']['iou']:.4f}; peak "
          f"{ffl['peak_bytes'] / 2**30:.2f} GiB, card {smi}", flush=True)
    ffl_train = phase_ffl_training(ffl_overrides, smi)
    phase_done("15")
    p2p = phase_pix2poly(p2p_overrides)
    phase_done("6")
    # the training below writes its own `latest` in the same directory
    p2p_seeded = os.path.join(WORK, "p2p_seeded_latest.pt")
    shutil.copyfile(os.path.join(compose(p2p_overrides).output_dir, "checkpoints", "latest.pt"), p2p_seeded)
    bt = p2p["batch_times"]
    med = {k: statistics.median(t[k] for t in bt) for k in ("encoder_ms", "decode_ms", "scorenet_ms", "host_ms")}
    print(f"pix2poly predict path: {p2p['tiles_s']:.2f} tiles/s; per batch of {B} (medians): encoder "
          f"{med['encoder_ms']:.2f} ms, decode loop {med['decode_ms']:.2f} ms, ScoreNets {med['scorenet_ms']:.2f} ms, "
          f"host stage {med['host_ms']:.2f} ms; fixed-length decode {p2p['fixed']['tiles_s']:.2f} tiles/s, "
          f"{p2p['fixed']['ms_per_step']:.3f} ms per decode step; IoU {p2p['results']['IoU']:.4f}, card {smi}",
          flush=True)
    trained = {dtype: phase_p2p_train(p2p_overrides, dtype) for dtype in ("float32", "bfloat16")}
    phase_done("7-8")
    first = {dtype: t["losses"][0] for dtype, t in trained.items()}
    loss_err = {k: abs(first["bfloat16"][k] / first["float32"][k] - 1.0) for k in first["float32"]}
    print(f"pix2poly first train step from the same weights on the same batch: float32 {first['float32']}, "
          f"bfloat16 {first['bfloat16']}; rel diff {loss_err} (tol {P2P_BF16_LOSS_TOL})", flush=True)
    if not all(e <= P2P_BF16_LOSS_TOL for e in loss_err.values()):
        fail(f"the bfloat16 train step's losses differ from float32's by {loss_err}")
    for dtype, t in trained.items():
        print(f"pix2poly train path ({dtype}): train step {t['step_ms']:.1f} ms, val step {t['val_ms']:.1f} ms, "
              f"val-IoU pass {t['iou_pass_ms']:.1f} ms (val IoU {t['val_iou']:.4f}), peak {t['peak_bytes']} bytes, "
              f"by layer {json.dumps({k: round(v, 2) for k, v in t['breakdown'].items()})}, card {smi}", flush=True)
    pbf = phase_p2p_predict_bf16(p2p_overrides)
    phase_done("9")
    bt = pbf["batch_times"]
    med = {k: statistics.median(t[k] for t in bt) for k in ("encoder_ms", "decode_ms", "scorenet_ms", "host_ms")}
    print(f"pix2poly predict path (bfloat16): {pbf['tiles_s']:.2f} tiles/s; per batch of {B} (medians): encoder "
          f"{med['encoder_ms']:.2f} ms, decode loop {med['decode_ms']:.2f} ms, ScoreNets {med['scorenet_ms']:.2f} ms, "
          f"host stage {med['host_ms']:.2f} ms; fixed-length decode {pbf['fixed']['tiles_s']:.2f} tiles/s, "
          f"{pbf['fixed']['ms_per_step']:.3f} ms per decode step, {pbf['fixed']['aten_per_step']:.1f} aten calls per "
          f"step (float32 {pbf['aten_per_step_f32']:.1f}); bench_torch {pbf['bench']['value']} tiles/s, "
          f"vs_baseline {pbf['bench']['vs_baseline']}, card {smi}", flush=True)
    vox = phase_voxelizer(lidar_overrides("hisup_lidar"))
    phase_done("16")
    lidar = phase_hisup_lidar_train(lidar_overrides("hisup_lidar"))
    phase_done("17")
    print(f"hisup_lidar train path: train step {lidar['step_ms']:.1f} ms, val step {lidar['val_ms']:.1f} ms, val-IoU "
          f"pass {lidar['iou_pass_ms']:.1f} ms (val IoU {lidar['val_iou']:.4f}), peak {lidar['peak_bytes']} bytes "
          f"({lidar['peak_bytes'] / 2**30:.2f} GiB), host loader {lidar['loader_ms']:.1f} ms per batch, by layer "
          f"{json.dumps({k: round(v, 2) for k, v in lidar['breakdown'].items()})}; voxelizer and PFN at cap 64 on "
          f"{B} clouds: assignment {vox[64]['assign_ms']:.2f} ms, canvas forward {vox[64]['canvas_fwd_ms']:.2f} ms, "
          f"forward and backward {vox[64]['canvas_fwd_bwd_ms']:.2f} ms; card {smi}", flush=True)
    fusion = phase_p2p_fusion_predict(lidar_overrides("p2p_fusion"))
    phase_done("18")
    fusion_seeded = os.path.join(WORK, "p2p_fusion_seeded_latest.pt")
    shutil.copyfile(os.path.join(compose(lidar_overrides("p2p_fusion")).output_dir, "checkpoints", "latest.pt"),
                    fusion_seeded)
    print(f"p2p_fusion predict path: {fusion['tiles_s']:.2f} tiles/s, encoder "
          f"{statistics.median(fusion['encoder_ms']):.2f} ms per batch of {B} (median), card {smi}", flush=True)
    steps = phase_lidar_steps()
    phase_done("19")
    for experiment, t in steps.items():
        print(f"{experiment} ({t['dtype']}): train step {t['step_ms']:.1f} ms, peak {t['peak_bytes']} bytes "
              f"({t['peak_bytes'] / 2**30:.2f} GiB), afm launches {t['launches']}, card {smi}", flush=True)
    demo_launches = phase_ffl_lidar_demo()
    phase_done("20")
    cached = phase_device_cache(ffl_overrides, p2p_overrides, smi)
    phase_done("21")
    for dtype, t in cached["ffl"].items():
        print(f"ffl_image from the device cache ({dtype}): train step {t['step_ms']:.1f} ms, batcher "
              f"{t['batcher_ms']:.3f} ms per batch, wall per train batch from the cache {t['wall_cache_ms']} ms and "
              f"from the host loader {t['wall_host_ms']} ms, peak {t['peak_bytes'] / 2**30:.2f} GiB, cache "
              f"{t['cache_bytes']} bytes; card {smi}", flush=True)
    hl = cached["hisup_lidar"]
    print(f"hisup_lidar from the device cache with remat: train step {hl['step_ms']:.1f} ms, peak "
          f"{hl['peak_bytes'] / 2**30:.2f} GiB, point cap {hl['cap']}, PFN forward {hl['canvas_fwd_ms']:.2f} ms; one "
          f"step without remat {hl['remat']['plain_ms']:.1f} ms at {hl['remat']['plain_peak'] / 2**30:.2f} GiB, with "
          f"{hl['remat']['remat_ms']:.1f} ms at {hl['remat']['remat_peak'] / 2**30:.2f} GiB; hisup_fusion with remat "
          f"peak {cached['hisup_fusion']['peak_bytes'] / 2**30:.2f} GiB; p2p_image from the cache step "
          f"{cached['p2p']['step_ms']:.1f} ms; card {smi}", flush=True)
    ddp = phase_data_parallel(overrides, p2p_overrides, ffl_overrides, smi)
    phase_done("22")
    rest = phase_remaining_encoders(smi)
    phase_done("23")
    twins = phase_script_twins(p2p_seeded, fusion_seeded, smi)
    phase_done("24")
    latest = {exp: os.path.join(compose(over).output_dir, "checkpoints", "latest.pt") for exp, over in (
        ("p2p_image", p2p_overrides), ("ffl_image", ffl_overrides), ("hisup_lidar", lidar_overrides("hisup_lidar")))}
    grid = phase_grid({"hisup_image": float32_latest, "p2p_fusion": fusion_seeded, **latest}, fusion_seeded, smi)
    phase_done("25")
    trained_ffl = phase_trained_ffl(ffl, trained_prebuild, smi)
    phase_done("26")
    repeats = phase_repeat_training(smi)
    phase_done("27")
    rows = {part: grid[part]["rows"] for part in ("modality", "density", "countries")}
    missing = [p for p in REPEAT_PATHS if p not in REPEATS]
    print(f"repeat checks: {len(REPEATS)} prediction paths held bitwise equal from one prediction to the next; "
          f"pillar_sums launches of each prediction {json.dumps(REPEATS)}", flush=True)
    if missing:
        fail(f"the repeat checks did not run for {missing}")
    afm_row["launches_by_path"] = {
        "hisup_train": launches["afm"], "hisup_predict": 0, "pix2poly_predict": 0,
        "pix2poly_train_float32": trained["float32"]["launches"],
        "pix2poly_train_bfloat16": trained["bfloat16"]["launches"], "pix2poly_predict_bfloat16": pbf["launches"],
        "hisup_train_bfloat16": launches_bf16["afm"], "hisup_predict_bfloat16": pred_bf16["launches"],
        "ffl_predict": ffl["launches"],
        "ffl_train_float32": ffl_train["float32"]["launches"],
        "ffl_train_bfloat16": trained_ffl["launches"][0],
        "ffl_predict_bfloat16": trained_ffl["predict_launches"],
        "hisup_lidar_train": lidar["launches"], "p2p_fusion_predict": fusion["launches"],
        **{f"{e}_step": t["launches"] for e, t in steps.items()},
        "hisup_lidar_train_cache_remat": hl["launches"], "hisup_fusion_step_remat": cached["hisup_fusion"]["launches"],
        "ffl_train_cache_float32": cached["ffl"]["float32"]["launches"],
        "ffl_train_cache_bfloat16": cached["ffl"]["bfloat16"]["launches"],
        "pix2poly_train_cache": cached["p2p"]["launches"],
        "hisup_train_ddp": ddp["hisup"]["launches"], "pix2poly_train_ddp": ddp["pix2poly"]["launches"],
        "ffl_train_ddp": ddp["ffl"]["launches"],
        **{f"ffl_{e}_{p}": rest[e][p]["launches"] for e in ("unetresnet101", "convnext") for p in ("train", "predict")},
        "pix2poly_vit_dinov2_train": rest["vit_dinov2"]["train"]["launches"],
        "pix2poly_vit_dinov2_predict": rest["vit_dinov2"]["predict"]["launches"],
        "ablation_twins": rest["ablations"]["launches"],
        "postprocess_oracle": twins["oracle"]["launches"],
        "measure_predict_e2e": twins["predict_e2e"]["launches"],
        "profile": twins["profile"]["launches"],
        "gather_and_droplidar50": twins["gather_droplidar"]["launches"],
        **{f"grid_{part}": sum(r["afm"] for r in rs.values()) for part, rs in rows.items()},
        "hisup_lidar_dense_train": grid["dense"]["launches"],
        "hisup_lidar_dense_predict": sum(a for a, _ in grid["dense"]["predict_launches"]),
        "ffl_lidar_dense_step": grid["dense_ffl"]["launches"],
        "release_hisup_lidar_train": grid["release"]["hisup_lidar"]["launches"][0],
        "release_measure_predict_e2e": grid["release"]["predict_e2e"]["launches"][0],
    }
    pillar_row["launches_by_path"] = {
        "hisup_lidar_train": lidar["pillar_launches"], "p2p_fusion_predict": fusion["pillar_launches"],
        **{f"{e}_step": t["pillar_launches"] for e, t in steps.items()}, "ffl_lidar_predict_demo": demo_launches,
        "hisup_lidar_train_cache_remat": hl["pillar_launches"],
        "hisup_fusion_step_remat": cached["hisup_fusion"]["pillar_launches"],
        "droplidar50_ablation": twins["gather_droplidar"]["pillar_launches"],
        **{f"{part}_{exp}": sum(r["pillar_sums"]) for part, rs in rows.items() for exp, r in rs.items()
           if sum(r["pillar_sums"])},
        "hisup_lidar_dense_train": grid["dense"]["pillar_launches"],
        "hisup_lidar_dense_predict": sum(p for _, p in grid["dense"]["predict_launches"]),
        "ffl_lidar_dense_step": grid["dense_ffl"]["pillar_launches"],
        "release_hisup_lidar_train": grid["release"]["hisup_lidar"]["launches"][1],
        "release_measure_predict_e2e": grid["release"]["predict_e2e"]["launches"][1],
        **{f"repeat_{p}": n for p, n in REPEATS.items()},
    }
    pillar_row["launches"] = lidar["pillar_launches"]
    run_row["launches"] = lidar["run_launches"]
    run_row["launches_by_path"] = {"hisup_lidar_train": lidar["run_launches"],
                                   "hisup_lidar_dense_train": grid["dense"]["run_launches"],
                                   **{f"repeat_{p}": r["launches"]["run_sums"] for p, r in repeats.items()}}
    if not all(run_row["launches_by_path"][k] for k in ("hisup_lidar_train", "hisup_lidar_dense_train",
                                                         "repeat_hisup_lidar", "repeat_p2p_fusion")):
        fail(f"the run_sums kernel did not launch on a LiDAR training path: {run_row['launches_by_path']}")
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}", flush=True)
    print(f"smoke run: {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": [afm_row, pillar_row, run_row]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
