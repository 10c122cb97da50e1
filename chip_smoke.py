#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``rgbnomore_tpu_torch/csrc/``
with ``nvcc`` for ``sm_90a`` and the host JPEG codec with ``g++``, holds each
kernel against its plain PyTorch version on the card, then drives the port's
paths at full width: ViT-Ti evaluation over the cropped DCT wire (K=48
``mask16`` rows, batch 256) through ``Trainer.evaluate`` and its train step
over the K=16 wire (batch 256) through ``Trainer.train_step``; then SwinV2-T
(float32) the same two ways (eval batch 256, train batch 128, 32x32 blocks)
and JPEG files through the host codec and ``DctCroppedLoader`` into the
SwinV2 eval; then mixed precision: ViT-B/16 and SwinV2-T under their bf16
presets, and ViT-Ti in fp16 with the loss scaler; then the trainer users
run: ``train_and_eval`` with dropout, checkpoints and an exact resume, the
data-parallel path over NCCL, and the train and eval CLIs; then the CLI's
default model, ViT-S/16 with the separate DCT embedding, the other
embeddings at its width (the concatenated one's attention at 294 tokens),
SwinV2-T's absolute position embedding, the packed and dense transfers
(the augmentation kernel's dense entry) and the benchmark harness; then the
RGB domain (ViT-S/16 and SwinV2-T on pixels decoded on the card, every RGB
transfer, the CLIs, the benchmark) and the DCT RandAugment ops outside the
augmentation kernel's set; then the rest of the harness: the reference
``.pth`` import, FLOP counts and a profiler trace, the model summary and
``--stage_data``; last SwinV2-B at window 16 (256-token windows).  It
checks that every kernel of each path was launched and that what comes
out is right.

Phases, each raising on failure (the script then exits non-zero):
  1. card: print ``nvidia-smi --query-gpu=name,power.limit`` for the card;
  2. build: compile the kernels, one ``nvcc`` per source, started together,
     and the host codec beside them; fail where ptxas serialises the
     ``wgmma`` products of the half-precision attention kernels or of #6;
  3. kernels: each kernel (attention forward and backward in float32 and
     their bf16 and fp16 variants, the fused flip + RandAugment + ToRange
     stage through its dense entry and through its wire reader, window
     attention forward and backward, #6's float32 Linear forward, input
     gradient and weight gradient at ViT-S's and SwinV2-T's shapes, the
     weight gradient twice for the same bits) against its plain
     version at the main paths' shapes and the JAX package's test shapes,
     then timed with CUDA events beside its plain version, its bound and,
     where one exists, a PyTorch library call.  The
     attention and window attention kernels compute in 3xTF32 on the tensor
     cores: their report adds that bound beside the float32 CUDA cores'
     (``bound_ms`` is the tensor cores', the least time for the work as
     they do it), each bound's share, and their device time without the
     host's launch overhead from ``torch.profiler``; two runs of each
     backward must give the same bits.  The window kernels are timed at
     every SwinV2-T stage, unshifted and shifted, summed over one train
     step and one eval batch, and reported with their ``ptxas`` registers
     and spills.  The tiled window kernels #3L and #4L (windows of 65-256
     tokens) run at SwinV2-B/w16's stage shapes at batch 256: the forward
     and its four gradients against float64 and the plain version within
     2e-5 of the largest entry, which a TF32-rounded control must fail,
     two runs bit-identical, times beside the bounds, the plain version
     and SDPA summed over one train step; and at SwinV2-T's shapes beside
     #3 and #4;
  4. slice: 512 images through the ViT-Ti ``Trainer.evaluate`` with launch
     counts; the pipeline on the card against the CPU, logits of the kernel
     path against the plain path and against the CPU;
  5. breakdown: the time of each stage of one eval step, and of each kernel
     of one forward (``torch.profiler``);
  6. train: 1 + 20 steps of the ViT-Ti ``Trainer.train_step`` on one
     repeated batch of 256 images (warmup 1, lr 3e-3) with launch counts (1
     wire launch of the input stage, 12 attention forward and 12 attention
     backward launches per step), finite losses and a last loss below the
     first; one step's loss and gradients on the card against the CPU at 8
     images; the time of each kernel of one step;
  7. swin eval: 512 images of 32x32 blocks through the SwinV2-T
     ``Trainer.evaluate`` (1 wire launch and 12 window-attention launches
     per batch); logits of the kernel path against the plain path and the
     card against the CPU; img/s and the forward's kernels;
  8. codec: 256 JPEGs written by the port's codec through
     ``DctCroppedLoader(mode="full")``: decode held to a closed form, host
     decode img/s per thread count, one batch through the SwinV2 eval;
  9. swin train: 1 + 10 steps of the SwinV2-T ``Trainer.train_step`` at
     batch 128 with drop path (1 wire launch, 12 window forward and 24
     window backward launches per step: each backward is a per-chunk pass
     and the reduction of the bias gradient), finite falling losses, the
     card against the CPU at 4 images, the kernels and the peak memory;
 10. vitb: ViT-B/16 as its preset gives it (bf16), 1 + 10 train steps at
     batch 512 (12 bf16 attention forward and 12 backward launches per
     step, none of the float32 kernels), the peak memory, 512 images
     through the eval, one step card vs CPU at 2 images, the kernels of a
     step;
 11. swin amp: SwinV2-T under its bf16 preset, 1 + 10 train steps (the
     window kernels stay float32, 12 + 24 launches per step) and 512
     images through the eval, the kernels of a step;
 12. fp16: ViT-Ti with ``ampdtype fp16`` and the loss scaler, 1 + 10 steps
     with fp16 attention launches, and a step made non-finite on purpose
     that must skip
     (parameters and AdamW state bit-identical, schedule count advanced,
     scale x0.625);
 13. determinism: two SwinV2-T train steps from one state with
     ``cfg.train.deterministic``, in a child process (``--determinism``),
     must leave bit-identical parameters; the same without the flag is
     reported beside it;
 14. trainer: dropout's cost (the ViT-Ti step at drop 0 and 0.1 in turns:
     ms a step and peak memory); then 1,280 JPEGs written by the port's
     codec and ``train_and_eval`` of ViT-Ti at batch 256, drop 0.1, 2
     epochs of 3 steps, a checkpoint per epoch, TensorBoard on, with
     ``cfg.train.deterministic``, each run a child process (``--trainer``):
     straight, epoch 1 alone (stopped after its checkpoint) and a run
     resumed from that checkpoint, whose parameters and AdamW moments must
     be bit-identical to the straight run's; launch counts per run (1 wire
     launch, 12 attention forward and 12 backward per train step; 1 and 12
     per eval batch); per-epoch train and eval img/s, the checkpoint's size
     and save and restore times, the TensorBoard event files, peak memory;
 15. ddp: three ViT-Ti steps and an eval in a process group of one over
     NCCL (``--ddp``), through the data-parallel path (gradient all-reduce,
     mixup's ring, eval sums all-reduced), bit-identical to the plain
     ``Trainer`` from the same state; NCCL's version and the world size;
 16. cli: ``python -m rgbnomore_tpu_torch.cli --train --eval`` for one
     epoch on the phase-14 corpus writes its weights, and ``python -m
     rgbnomore_tpu_torch.eval --loadpath`` on them reproduces its test
     result;
 17. vits: ViT-S/16 as the CLI's defaults build it (``vits``, embed_type 2
     with sub-blocks, float32) at full width: 1 + 5 train steps at the
     preset's batch of 1024 (512 where that does not fit the card) with 1
     wire, 12 #1 and 12 #2 launches a step, and #6's 52 forward, 50 input
     gradient and 52 weight gradient launches (52 an eval batch), finite
     falling losses, the peak memory; one step card vs CPU at 2 images; the
     kernels of a step; 512 images through the eval;
 18. embed: ViT-S's width at batch 256, 1 + 3 train steps and 512 eval
     images each for embed_type 2 without sub-blocks, embed_type 3 (294
     tokens: #1 and #2 at N = 294) and embed_type 3 under bf16 (#1h's tiled
     kernel and #2h's key groups at N = 294, none of the float32 kernels);
 19. ape: SwinV2-T with its absolute position embedding, one train step and
     one eval batch, logits card vs CPU;
 20. packed: ViT-Ti through ``Trainer(transfer="packed")`` and ``"dense"``
     on the phase-14 JPEGs, 1 + 3 train steps each with 1 launch of #5's
     dense entry a step and none of its wire reader, one eval batch, the
     pipeline stage card vs CPU;
 21. benchmark: ``python -m rgbnomore_tpu_torch.cli --benchmark 20`` prints
     the six FPS metrics, each > 0, and ``python -m rgbnomore_tpu_torch.bench``
     its one line;
 22. rgb: ViT-S/16 with ``--domain rgb`` (the paper's RGB baseline: pixels
     decoded on the card from ``RgbCroppedLoader``'s K=63 window rows of
     the phase-14 JPEGs, ``AUGLIST_RGB`` at magnitude 10, lr 1e-3) at full
     width: 1 + 5 train steps at the preset's batch of 1,024 (512 where that
     does not fit) with 12 #1, 12 #2 and no #5 launch a step, finite losses,
     the step's and the input stage's peak memory; one step card vs CPU at
     2 images; the input stage split (decode, residual resample, flip +
     RandAugment, range) and each part card vs CPU at 4 images; the
     kernels of a step; 512 images through the eval; the host decode
     img/s at 1 and 8 threads;
 23. rgb paths: SwinV2-T ``--domain rgb`` under its bf16 preset (12 #3 and
     24 #4 launches a step), ViT-Ti through the dense (``RgbCanvasLoader``)
     and packed (``make_packed_rgb_decode``) RGB transfers, 1 + 2 steps and
     an eval batch each; the train and eval CLIs with ``--domain rgb``;
     ``--benchmark 5`` with ``--domain rgb`` and with ``--model_arch
     swinv2`` (its drop path in the fwd+bwd step), six metrics > 0 each;
 24. dct ops: one ViT-Ti step on the cropped DCT wire with the ops outside
     the augmentation kernel's set (Rotate, ShearX, ShearY, Equalize,
     Solarize, Invert, FreqEnhance): no #5 launch, the step and its input
     stage card vs CPU, each op forced card vs CPU;
 25. harness: a reference-named ViT-S/16 (embed_type 2, random qkv rows)
     saved as a bare ``.pth`` and as an epoch checkpoint with ``module.``
     names, imported by ``load_torch_checkpoint`` (one state dict from
     both, loaded strictly): 512 images through the eval (12 #1 launches a
     batch), logits card vs CPU at 4 images, 1 + 3 train steps at the
     preset's batch; SwinV2-T through ``import_swin_state_dict``, one eval
     batch (12 #3 launches), logits card vs CPU; ``model_flops`` on the card
     equal to the CPU's for both, GFLOP an image and achieved TFLOP/s; a
     ``utils/profiling.trace`` of 3 ViT-Ti train steps whose trace file
     names #1's, #2's and #5w's kernels as often as their launch counters
     say; ``--stage_data`` on ILSVRC-shaped tars (512x512 4:2:0 out, val
     split by class), the eval CLI at ``--verbose 2`` logging the model
     summary (its total the model's parameter count) on the imported
     weights, and ViT-Ti trained one epoch on the staged corpus by the CLI;
 26. swinv2b: SwinV2-B at window 16 under its bf16 preset at batch 256, 1 +
     10 train steps with the counters reset before each step: #3L 22, #4L
     88 (22 calls x 4 kernels), #3 2 and #4 4 a step, finite falling
     losses, the peak memory; one eval batch (#3L 22, #3 2).

Phase 3 also holds #1, #2, #1h and #2h (bf16) at ViT-S's shapes (256, 6,
196, 64) and (256, 6, 294, 64).  On every cropped path the input stage is
one launch of the augmentation kernel's wire reader per eval batch and per
train step, with no launch of its dense entry and no call of the plain
unpack; on the packed and dense paths it is one launch of the dense entry
per train step; on the RGB paths and the seven-op DCT step it is tensor code, with no
launch of either.

Every comparison of a SwinV2 first sets the scales of its blocks'
res-post norms, which start at 0 (each block then is the identity and no
attention reaches the logits), to random values.  The model paths are fed
rows written in the ``mask16`` layout of ``DctCroppedLoader`` from seeded
synthetic coefficient planes (``write_rows``, which this script shares with
the tests in ``tests/torch_port_support.py``; ``tests/test_torch_port_eval.py``
holds it against the port's pipeline); the codec phase reads real JPEG
files.  Each model's train steps and evaluation run through one loop each
(``train_path``, ``eval_path``), which read the port's launch counters after
every step.  A step's split by stage is the port's own spans': ``python3
tools/port_span_gaps.py --workload <cell> --seed <n> --out chiprun_out/gaps``
names each gap in a benchmark cell's device work by its span.  The last two
lines of standard output are the kernel report and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the rows, weights, tars and trace readers this script shares with the tests
sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from torch_port_support import (  # noqa: E402
    SWIN_REFERENCE_NAMES,
    VIT_EMBED_REFERENCE_NAMES,
    VIT_REFERENCE_NAMES,
    kernel_instance,
    launches as counted_launches,
    pack_mask16,  # noqa: F401  (portbench/tests read it here)
    port_spans,
    random_wire_rows,
    reference_state_dict,
    row_fields,
    spans_per_step,
    synthetic_planes,
    tf32_rna,
    val_names,
    write_imagenet_tars,
    write_rows,
)

SEED = 0
BATCH = 256
N_IMAGES = 512
GRID = 28  # ViT-Ti block grid: 28x28 blocks, 14x14 patches of 16 px, 196 tokens
K_EVAL = 48
ATTN_SCALE = 1.0 / math.sqrt(192)  # ViT-Ti: 1/sqrt(emb_size)
ATTN_SHAPES = [(256, 3, 196, 64), (2, 3, 49, 32), (2, 3, 128, 128)]
# the Pallas test's tolerance (tests/test_pallas_attention.py:21-30)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
# (shape, scale) of the backward checks: the main path's, the Pallas
# gradient test's (tests/test_pallas_attention.py:33-50) and the forward's
BWD_CASES = [((256, 3, 196, 64), ATTN_SCALE), ((1, 2, 52, 24), 0.13),
             ((2, 3, 49, 32), ATTN_SCALE), ((2, 3, 128, 128), ATTN_SCALE)]
# the Pallas gradient test's tolerance
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
# the Pallas augmentation test's tolerance on the [-1, 1] output
# (tests/test_pallas_augpipe.py:75-76)
AUG_TOL = dict(atol=2e-6, rtol=0)
K_TRAIN = 16
TRAIN_STEPS = 20  # counted steps of the train phase, after one warm-up step
CPU_GRAD_BATCH = 8
# the loss and gradients on the card against the CPU (measured on an H100:
# 7e-8 and 5e-7), with 20x room for float32 sums in other orders
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5  # of the largest gradient entry in the model
# logits after 12 float32 blocks whose sums run in another order than the
# plain path's (and than the CPU's)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, dense TF32 and bf16 / fp16
# FLOP/s of the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_H16_FLOP_PER_S = 989e12
# the half-precision attention kernels (#1 and #2 on bf16 and fp16 inputs):
# the main paths' shapes, ViT-B's eval batch of 256 (the vitb preset, 12
# heads of 64), ViT-Ti's (the fp16 path) and ViT-B's train batch of 512,
# then the float32 kernels' check shapes and two past the keys the kernels
# hold at once (N > 256; N > 128 at D > 64); the first three are timed
H16_SHAPES = [(256, 12, 196, 64), (256, 3, 196, 64), (512, 12, 196, 64), (2, 3, 197, 64),
              (1, 2, 52, 24), (2, 3, 49, 32), (2, 3, 128, 128), (1, 2, 300, 64),
              (1, 2, 200, 128)]
H16_TIMED = 3
VITB_SCALE = 1.0 / math.sqrt(768)  # ViT-B: 1/sqrt(emb_size)
# A kernel's and the plain version's outputs against a float32 reference on
# the same rounded inputs: a few units of the dtype's rounding (2^-8 bf16,
# 2^-11 fp16) on outputs of order 1; gradients as a share of the largest
# reference entry.  The kernel against the plain version: the sum of the
# two errors, twice the tolerance.
H16_FWD_TOL = {"bfloat16": dict(atol=2**-6, rtol=2**-7),
               "float16": dict(atol=2**-9, rtol=2**-10)}
H16_GRAD_TOL = {"bfloat16": 2**-5, "float16": 2**-8}
# ViT-B/16 (generate_config("vitb", "dct")): bf16, 12 x 768, 12 heads of 64,
# 28x28 blocks, 1000 classes; the preset's batch of 512 on one card
VITB_TRAIN_STEPS = 10  # counted steps, after one warm-up step
VITB_CPU_BATCH = 2
# one bf16 train step on the card against the CPU: the loss and the global
# gradient norm relative, each gradient entry as a share of the largest
# entry in the model.  Both sides round every product and activation to
# bf16 (2^-8), in other orders and with other kernels.
# (measured on an H100: 7.9e-5 and 3.9e-3)
BF16_LOSS_RTOL = 2**-8
BF16_GRAD_RTOL = 2**-5
FP16_STEPS = 10  # counted fp16 ViT-Ti steps with the loss scaler, after a warm-up
# SwinV2-T (generate_config("swinv2", "dct"), float32): 32x32 blocks (256
# px), patch 4 -> 64x64 tokens, windows of 8x8 = 64 tokens, head dim 32
SWIN_GRID = 32
SWIN_EVAL_BATCH = 256
SWIN_TRAIN_BATCH = 128
SWIN_TRAIN_STEPS = 10  # counted steps of the swin train phase, after a warm-up
SWIN_CPU_BATCH = 4
# (windows per image, heads, shifted-block patterns) of the four stages; the
# last stage's 8x8 map is one window, so neither of its blocks shifts
SWIN_STAGES = [(64, 3, 64), (16, 6, 16), (4, 12, 4), (1, 24, None)]
SWIN_BLOCKS_PER_STAGE = (2, 2, 6, 2)
WIN_N, WIN_D = 64, 32
# the Pallas window tests' tolerances (tests/test_pallas_attention.py:97, :120)
WIN_TOL = dict(atol=2e-5, rtol=1e-5)
# (bw, h, n, d, P) of the JAX tests (bw 4 / 8 / 12, two pair patterns = four
# of the port's) checked beside the main path's
WIN_JAX_CASES = [(4, 2, 16, 8, 4), (8, 2, 16, 8, 4), (12, 2, 16, 8, 4)]
# SwinV2-B/w16 (generate_config("swinv2b", "dct"): bf16 AMP, the window
# kernels float32): 32x32 blocks -> 64x64 tokens, windows of 16x16 = 256
# tokens in stages 1-3 (#3L, #4L), stage 4's 8x8 map one window of 64 (#3,
# #4); head dim 32; the preset's batch of 256 on one card
SWINB_BATCH = 256
SWINB_TRAIN_STEPS = 10  # counted steps, after one warm-up step
# (windows per image, heads, N, shifted-block patterns) of the four stages:
# stage 3's 16x16 map is one window, so none of its 18 blocks shifts
SWINB_STAGES = [(16, 4, 256, 16), (4, 8, 256, 4), (1, 16, 256, None), (1, 32, 64, None)]
SWINB_BLOCKS_PER_STAGE = (2, 2, 18, 2)
# #3L and #4L against float64, as a share of the reference's largest entry,
# output by output: 3xTF32 leaves about float32's own error (the float32
# plain version's); operands rounded once to TF32 (2^-11) read 5.7e-4 or
# more on the card tests' shapes.  The card tests' TILED_TOL; the kernel
# phase checks that the TF32-rounded control fails it.
TILED_TOL = 2e-5
N_CODEC = 256  # JPEG files of the codec phase
N_CELL_IMAGES = 16  # of them, constant 16x16 colour cells at quality 100
# the trainer phases: ViT-Ti at its preset's width, batch 256, on JPEGs the
# port's codec writes.  1,280 files with a 20% minival leave 1,024 to train
# on (4 batches of 256, capped at 3 steps an epoch) and a minival of one
# full batch; the test split is the first 256 files
N_TRAINER = 1280
TRAINER_SPLIT = 0.2
TRAINER_STEPS = 3  # max_steps_per_epoch
TRAINER_EPOCHS = 2
TRAINER_DROP = 0.1
DROP_AB_STEPS = 10  # counted steps of each side of the dropout A/B, after a warm-up
# ViT-S/16 (the CLI's defaults: vits, embed_type 2 with sub-blocks), float32:
# the attention kernels at its 196 tokens and at embed_type 3's 294
# (196 luma + 2 x 49 chroma tokens), 6 heads of 64, scale 1/sqrt(384)
VITS_ATTN_SHAPES = [(256, 6, 196, 64), (256, 6, 294, 64)]
VITS_SCALE = 1.0 / math.sqrt(384)
# the preset's batch of 1024 (a global batch over GPUs) where it fits one
# card, else 512
VITS_BATCHES = (1024, 512)
VITS_TRAIN_STEPS = 5  # counted steps, after one warm-up step
VITS_CPU_BATCH = 2
# the RGB domain (--domain rgb, the paper's baseline): ViT-S/16 on pixels
# decoded on the card from RgbCroppedLoader's K=63 mask16 window rows,
# AUGLIST_RGB at magnitude 10, lr 1e-3, at the preset's batch of 1024 (512
# where that does not fit), on the trainer corpus's JPEGs
RGB_BATCHES = (1024, 512)
RGB_TRAIN_STEPS = 5  # counted steps, after one warm-up step
RGB_CPU_BATCH = 2
RGB_STAGE_BATCH = 4  # images of the input stage's card-vs-CPU check
RGB_PATH_STEPS = 2  # counted steps of SwinV2-T and the full-canvas transfers
# the RGB input stage on the card against the CPU, from the same input at
# each stage: the decode is integer arithmetic but for the IDCT's rounding,
# so a sample at exactly .5 may land a level apart; the resample's float32
# sums run in another order (1e-2 of a level is 1e-4 relative at 255); the
# augmentation's filters and colour products likewise, where a rounding
# difference may cross a threshold (Posterize, Solarize) in a rare pixel
RGB_DECODE_ATOL = 1.0
RGB_DECODE_SHARE = 1e-3  # pixels allowed a level apart
RGB_LEVEL_ATOL = 1e-2
RGB_AUG_SHARE = 1e-3  # pixels allowed beyond RGB_LEVEL_ATOL after RandAugment
# the DCT RandAugment ops outside the kernel's set, on the card against the
# CPU: tests/test_ops_geometry.py's 1e-2 on coefficients (the DFT route's
# products sum in another order), 1e-5 on the [-1, 1] output
DCT_OPS = ["Rotate", "ShearX", "ShearY", "Equalize", "Solarize", "Invert", "FreqEnhance"]
DCT_OPS_ATOL = 1e-2
# the harness phase (module 7): train steps of the imported ViT-S at the
# preset's batch and of the traced ViT-Ti, images of the card-vs-CPU logits,
# and the ILSVRC-shaped tars it stages: classes, JPEGs a class (320x240),
# val images (named as ImageNet's, classed by assets/val_wnid_map.csv.gz)
HARNESS_STEPS = 3
HARNESS_CPU_IMAGES = 4
STAGE_CLASSES, STAGE_PER_CLASS, STAGE_VAL = ("n01440764", "n01443537"), 16, 4
STAGE_BATCH = 8
# the kernels' names in a torch.profiler trace, by launch counter
TRACE_KERNELS = {"attention_fwd_kernel": "fused_attention", "delta_kernel": "fused_attention_bwd",
                 "dkdv_kernel": "fused_attention_bwd", "dq_kernel": "fused_attention_bwd",
                 "augpipe_kernel": "wire_flip_aug_range"}

# a ViT-Ti train step's port spans below ``rgbnm.step`` on the card (the
# step draws for itself), and how often a step opens each
VIT_STEP_SPANS = {"rgbnm.draw": 1, "rgbnm.pipeline": 1, "rgbnm.pipeline.policy": 1,
                  "rgbnm.mixup": 1, "rgbnm.forward": 1, "rgbnm.backward": 1,
                  "rgbnm.optimizer": 1, "rgbnm.attn.fwd": 12, "rgbnm.attn.bwd": 12}

# (tag, generate_config arguments, embedding, tokens) of the embed phase
EMBED_PATHS = [
    ("embed2 no_subblock", dict(modelver=2, subblock=False), "PatchEmbeddingDCTSeparate", 196),
    ("embed3", dict(modelver=3), "PatchEmbeddingDCTConcat", 294),
    ("embed3 bf16", dict(modelver=3, amp=True, ampdtype="bf16"), "PatchEmbeddingDCTConcat",
     294),
]
EMBED_STEPS = 3  # counted steps of each embed path, after one warm-up step
PACKED_STEPS = 3  # counted steps of each full-canvas transfer, after one warm-up step
# the dequantized crop of the full-canvas transfers, card against CPU:
# float32 sums of up to 512 products of coefficients up to 1,024 in
# another order; 1e-2 is 1e-5 of the coefficients' range
PACKED_CROP_ATOL = 1e-2
# kernel library -> {kernel<template args>: "registers, spill bytes"}, from
# the build logs' ptxas lines
PTXAS: dict[str, dict[str, str]] = {}
# kernel library -> the notes (C75xx) in which ptxas says that it
# serialises a kernel's wgmma products, and why
WGMMA_NOTES: dict[str, list[str]] = {}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


# ---------------------------------------------------------------- timing
def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_ms(fn, reps: int = 10) -> float | None:
    """The device time of one ``fn()``: for each kernel that ``torch.profiler``
    sees over ``reps`` calls after a warm-up, its mean time per launch times
    its launches per call (its count over ``reps``, rounded), summed; the
    host's launch overhead, which ``time_ms`` counts, is left out.  The
    profiler drops a launch now and then on the H100 (8 of 10
    counted), so a plain sum over ``reps`` would read low, and now and then
    sees nothing at all: that window is taken again, up to three times.
    None where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window where the profiler saw nothing is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
                    for e in prof.key_averages() if e.count and e.self_device_time_total > 0)
        if total:
            return total / 1e3
    return None


def product_bounds_ms(flop: float, nbytes: float, products: int = 3) -> dict:
    """The least times, in ms, of a kernel that does ``flop`` float32 FLOP
    of matrix products and moves ``nbytes``: ``f32`` with the products on
    the CUDA cores, ``tc`` with them on the tensor cores in ``products``
    TF32 products per float32 product (3xTF32; two where one operand is
    exact in TF32), each against the bytes; each with what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    out = {}
    for tag, t_ops in (("f32", flop / PEAK_F32_FLOP_PER_S),
                       ("tc", products * flop / PEAK_TF32_FLOP_PER_S)):
        out[tag] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations")
    return out


def attention_bound_ms(b: int, h: int, n: int, d: int) -> dict:
    """Least times for softmax(QKᵀ)V on the card (``product_bounds_ms``):
    q, k, v read and o written once in float32, against 4*N^2*D*B*H FLOP
    (QKᵀ and PV)."""
    return product_bounds_ms(4 * n * n * d * b * h, 4 * b * h * n * d * 4)


def product_kernel_entry(ms: float, bounds: dict) -> dict:
    """The bound keys of a kernel that computes its products in 3xTF32:
    ``bound_ms`` is the least time for the work as it does it (the tensor
    cores' bound), ``bound_f32_ms`` the bound of float32 CUDA cores beside
    it, each with its share of ``ms``."""
    (tc, tc_by), (f32, f32_by) = bounds["tc"], bounds["f32"]
    return {"bound_ms": tc, "bound_by": tc_by, "bound_tc_ms": tc, "bound_f32_ms": f32,
            "bound_f32_by": f32_by, "bound_share": tc / ms, "bound_f32_share": f32 / ms}


# ---------------------------------------------------------------- phases
def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi listed no card")
    return out[0]


def phase_build() -> None:
    """The kernels (one ``nvcc`` per source, all at once) and, beside them,
    the host codec against the port's own libjpeg headers."""
    from rgbnomore_tpu_torch.native import build as codec_build
    from rgbnomore_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    codec = {}
    worker = threading.Thread(target=lambda: codec.update(path=codec_build.build()))
    worker.start()
    paths = cuda_build.build()
    kernels_s = time.perf_counter() - t0
    worker.join()
    check("path" in codec, "the host codec did not build")
    print(f"build: {len(paths)} kernel libraries in {kernels_s:.1f} s; host codec "
          f"{codec['path'].name} linked with {codec_build.jpeg_link_args()}, both in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in paths.items():
        # one "template args: registers, spill bytes" entry per compiled kernel
        entries, args, notes = {}, "?", []
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            note = re.search(r"\((C75\d\d)\) Potential Performance Loss: ([^']*) (?:in|for) the "
                             r"function '([^']*)'", line)
            if note:
                notes.append(f"{note.group(1)} {kernel_instance(note.group(3))}: {note.group(2)}")
            elif "Compiling entry function" in line:
                args = kernel_instance(line.split("'")[1])
            elif "spill stores" in line:
                spills = re.findall(r"(\d+) bytes spill", line)
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                entries[args] = f"{regs} regs, spills {'/'.join(spills)} B"
        PTXAS[name] = entries
        WGMMA_NOTES[name] = notes
        print(f"build: {name}: " + "; ".join(f"{k} {v}" for k, v in entries.items()), flush=True)
        for note in notes:
            print(f"build: {name}: ptxas {note}", flush=True)
        check(not ((name.startswith("attention_h16") or name == "linear_tf32x3") and notes),
              f"ptxas serialises the wgmma products of {name}: {notes}")


def kernel_attention_fwd(gen) -> dict:
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.attention import attention_plain, fused_attention

    max_err = 0.0
    with torch.inference_mode():
        for shape in ATTN_SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
            got = fused_attention(q, k, v, ATTN_SCALE)
            want = attention_plain(q, k, v, ATTN_SCALE)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            check(torch.allclose(got, want, **ATTN_TOL),
                  f"fused_attention {shape}: max abs err {err} beyond {ATTN_TOL}")
            print(f"kernels: fused_attention {shape} max abs err {err:.3e}", flush=True)
        b, h, n, d = ATTN_SHAPES[0]
        q, k, v = (torch.randn(ATTN_SHAPES[0], generator=gen, device="cuda") for _ in range(3))
        ms = time_ms(lambda: fused_attention(q, k, v, ATTN_SCALE))
        plain_ms = time_ms(lambda: attention_plain(q, k, v, ATTN_SCALE))
        library_ms = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=ATTN_SCALE))
        dev_ms = device_ms(lambda: fused_attention(q, k, v, ATTN_SCALE))
        dev_library_ms = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=ATTN_SCALE))
    bounds = product_kernel_entry(ms, attention_bound_ms(b, h, n, d))
    print(f"kernels: fused_attention {ATTN_SHAPES[0]} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms; device time {ms_text(dev_ms)}, sdpa's "
          f"{ms_text(dev_library_ms)}; "
          f"bound 3xTF32 {bounds['bound_tc_ms']:.4f} ms "
          f"({bounds['bound_by']}, {100 * bounds['bound_share']:.1f}% of it), float32 "
          f"{bounds['bound_f32_ms']:.4f} ms ({bounds['bound_f32_by']}, "
          f"{100 * bounds['bound_f32_share']:.1f}%)", flush=True)
    return {
        "name": "fused_attention", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/attention.py:39",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        **bounds, "library_ms": library_ms, "device_ms": dev_ms,
        "library_device_ms": dev_library_ms,
    }


def kernel_attention_bwd(gen) -> dict:
    """The backward kernel's gradients (through ``fused_attention``'s
    autograd Function) against autograd through ``attention_plain``; then
    the backward alone timed beside the plain backward and SDPA's, each
    from a forward already taken."""
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.attention import (
        attention_bwd_plain,
        attention_plain,
        fused_attention,
        fused_attention_bwd,
        fused_attention_fwd,
    )

    max_err = 0.0
    for shape, scale in BWD_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fused_attention(*leaves, scale).backward(g)
        want = attention_bwd_plain(q, k, v, g, scale)
        torch.cuda.synchronize()
        for tag, leaf, w in zip("qkv", leaves, want):
            err = float((leaf.grad - w).abs().max())
            max_err = max(max_err, err)
            check(torch.allclose(leaf.grad, w, **GRAD_TOL),
                  f"fused_attention_bwd {shape} d{tag}: max abs err {err} beyond {GRAD_TOL}")
        print(f"kernels: fused_attention_bwd {shape} scale {scale:.4f} max abs err "
              f"{max_err:.3e}", flush=True)
    b, h, n, d = BWD_CASES[0][0]
    q, k, v, g = (torch.randn((b, h, n, d), generator=gen, device="cuda") for _ in range(4))
    out, lse = fused_attention_fwd(q, k, v, ATTN_SCALE, with_lse=True)
    # every sum runs in a fixed order: two runs give the same bits
    first = fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE)
    again = fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE)
    for tag, a, b_ in zip("qkv", first, again):
        check(torch.equal(a, b_), f"fused_attention_bwd {(b, h, n, d)} d{tag} differs between runs")
    print(f"kernels: fused_attention_bwd {(b, h, n, d)}: two runs bit-identical", flush=True)
    del first, again
    ms = time_ms(lambda: fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = attention_plain(*leaves, ATTN_SCALE)
    plain_ms = time_ms(lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True),
                       reps=10, warmup=2)
    sdpa_out = F.scaled_dot_product_attention(*leaves, scale=ATTN_SCALE)
    library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    dev_ms = device_ms(lambda: fused_attention_bwd(q, k, v, out, lse, g, ATTN_SCALE))
    dev_library_ms = device_ms(
        lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    # the five products of the VJP; q, k, v, out, dout and lse read once,
    # dq, dk, dv written once
    bounds = product_kernel_entry(ms, product_bounds_ms(
        10 * n * n * d * b * h, (8 * q.numel() + lse.numel()) * 4))
    print(f"kernels: fused_attention_bwd {(b, h, n, d)} {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa backward {library_ms:.4f} ms; device time {ms_text(dev_ms)}, sdpa backward's "
          f"{ms_text(dev_library_ms)}; bound 3xTF32 {bounds['bound_tc_ms']:.4f} ms "
          f"({bounds['bound_by']}, {100 * bounds['bound_share']:.1f}% of it), float32 "
          f"{bounds['bound_f32_ms']:.4f} ms ({bounds['bound_f32_by']}, "
          f"{100 * bounds['bound_f32_share']:.1f}%)", flush=True)
    return {
        "name": "fused_attention_bwd", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/attention.py:51",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        **bounds, "library_ms": library_ms, "device_ms": dev_ms,
        "library_device_ms": dev_library_ms,
    }


def h16_bound_ms(flop: float, nbytes: float) -> tuple[float, str]:
    """The least time, in ms, of a kernel that does ``flop`` FLOP of bf16 or
    fp16 products on the tensor cores and moves ``nbytes``, and which of
    the two bounds it."""
    t_ops, t_bytes = flop / PEAK_H16_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def kernel_attention_h16(gen) -> list[dict]:
    """Kernels #1 and #2 on bf16 and fp16 inputs (``csrc/attention_h16_fwd.cu``,
    ``csrc/attention_h16_bwd.cu``), through ``fused_attention`` and its
    autograd Function: at every shape of ``H16_SHAPES`` the output and the
    gradients against the plain version in the same dtype (``attention_plain``
    and autograd through it), and both against a float32 reference on the
    same rounded inputs; two backward runs bit-identical; fp16 with an
    output gradient up to 2^13 (loss-scaled), whose dO V^T passes fp16's
    range, finite and within tolerance wherever the reference is; the
    shapes past the keys the kernels hold at once (N > 256; N > 128 at D >
    64) take their key-tiled paths.  Then
    each timed at ViT-B's eval and train and ViT-Ti's shapes beside the
    plain version, SDPA on the same inputs (its backward too), and the
    bound: 4 N^2 D (10 N^2 D) FLOP per (batch, head) at the tensor cores'
    bf16 rate against q, k, v, o (and dO, dq, dk, dv, lse) moved once.  Returns
    four entries: forward and backward, bf16 and fp16, each with the ptxas
    line of its main-path instance (D = 64, N = 196)."""
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.attention import (
        attention_bwd_plain,
        attention_plain,
        fused_attention,
        fused_attention_h16_bwd,
        fused_attention_h16_fwd,
    )

    def rel(a, b) -> float:
        return float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    entries = []
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).removeprefix("torch.")
        tag = "bf16" if dtype == torch.bfloat16 else "fp16"
        ftol, gtol = H16_FWD_TOL[name], H16_GRAD_TOL[name]
        fwd_err = bwd_err = 0.0
        for shape in H16_SHAPES:
            scale = VITB_SCALE if shape[1] == 12 else ATTN_SCALE
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fused_attention(*leaves, scale)
            out.backward(g)
            with torch.inference_mode():
                plain = attention_plain(q, k, v, scale)
                ref = attention_plain(q.float(), k.float(), v.float(), scale)
            plain_grads = attention_bwd_plain(q, k, v, g, scale)
            ref_grads = attention_bwd_plain(q.float(), k.float(), v.float(), g.float(), scale)
            torch.cuda.synchronize()
            err = float((out.detach() - plain).abs().max())
            fwd_err = max(fwd_err, err)
            e_kernel = float((out.detach().float() - ref).abs().max())
            e_plain = float((plain.float() - ref).abs().max())
            check(torch.allclose(out.detach().float(), ref, **ftol),
                  f"fused_attention {tag} {shape}: err against float32 {e_kernel} beyond {ftol}")
            check(torch.allclose(plain.float(), ref, **ftol),
                  f"attention_plain {tag} {shape}: err against float32 {e_plain} beyond {ftol}")
            check(torch.allclose(out.detach().float(), plain.float(), atol=2 * ftol["atol"],
                                 rtol=2 * ftol["rtol"]),
                  f"fused_attention {tag} {shape}: max abs err {err} against plain beyond "
                  f"2x {ftol}")
            g_kernel, g_plain, g_pair = [], [], []
            for leaf, p_, r_ in zip(leaves, plain_grads, ref_grads):
                g_kernel.append(rel(leaf.grad, r_))
                g_plain.append(rel(p_, r_))
                g_pair.append(rel(leaf.grad, p_.float()))
                bwd_err = max(bwd_err, float((leaf.grad - p_).abs().max()))
            check(max(g_kernel) <= gtol and max(g_plain) <= gtol and max(g_pair) <= 2 * gtol,
                  f"fused_attention_bwd {tag} {shape}: gradient errors of the largest entry: "
                  f"kernel {g_kernel}, plain {g_plain} against float32 (tolerance {gtol}), "
                  f"kernel against plain {g_pair} (2x)")
            print(f"kernels: fused_attention {tag} {shape}: fwd err against float32 kernel "
                  f"{e_kernel:.2e} plain {e_plain:.2e}, against plain {err:.2e}; gradients "
                  f"(share of the largest entry) kernel {max(g_kernel):.2e} plain "
                  f"{max(g_plain):.2e}, against plain {max(g_pair):.2e}", flush=True)
            del q, k, v, g, leaves, out, plain, ref, plain_grads, ref_grads
        b, h, n, d = H16_SHAPES[0]
        q, k, v, g = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        out, lse = fused_attention_h16_fwd(q, k, v, VITB_SCALE, with_lse=True)
        first = fused_attention_h16_bwd(q, k, v, out, lse, g, VITB_SCALE)
        again = fused_attention_h16_bwd(q, k, v, out, lse, g, VITB_SCALE)
        for t, a, b_ in zip("qkv", first, again):
            check(torch.equal(a, b_), f"fused_attention_bwd {tag} d{t} differs between runs")
        del first, again
        if dtype == torch.float16:
            # loss-scaled output gradients at ViT-B's scale: "random", dO ~
            # N(0, 1) x 2^13, whose dO V^T passes fp16's 65504; "aligned",
            # dO = 8000 V and q = k = 1.6 sqrt(64 / D) N(0, 1), whose dS
            # reaches about 1.7e5 while dq, dk, dv stay inside fp16's range;
            # at ViT-B's head and at the backward's key-group instances (N
            # past 256; N past 128 at D > 64)
            cases = [("random", (8, 12, 196, 64))] + [
                ("aligned", shape) for shape in ((8, 12, 196, 64), (1, 2, 300, 64),
                                                 (1, 2, 200, 128))]
            for kind, shape in cases:
                x, hv, hg = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
                if kind == "random":
                    hq, hk = x.half(), torch.randn(shape, generator=gen, device="cuda").half()
                    hv, hg = hv.half(), (hg * 2.0**13).half()
                else:
                    hq = (1.6 * (64 / shape[-1]) ** 0.5 * x).half()
                    hk, hv = hq.clone(), hv.half()
                    hg = (8000.0 * hv.float()).half()
                hout, hlse = fused_attention_h16_fwd(hq, hk, hv, VITB_SCALE, with_lse=True)
                got = fused_attention_h16_bwd(hq, hk, hv, hout, hlse, hg, VITB_SCALE)
                want = attention_bwd_plain(hq.float(), hk.float(), hv.float(), hg.float(),
                                           VITB_SCALE)
                dp = torch.einsum("bhqd,bhkd->bhqk", hg.float(), hv.float())
                p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", hq.float(), hk.float())
                              * VITB_SCALE - hlse[..., None])
                ds_max = float((p * (dp - (hg.float() * hout.float()).sum(-1, keepdim=True)))
                               .abs().max())
                dp_max = float(dp.abs().max())
                errs = [rel(a, w) for a, w in zip(got, want)]
                check(dp_max > 65504 and (ds_max > 65504) == (kind == "aligned"),
                      f"fp16 large dO {kind}: max |dP| {dp_max}, max |dS| {ds_max}")
                for t, a, w, e in zip("qkv", got, want, errs):
                    finite_ref = torch.isfinite(w.half())
                    check(bool(torch.isfinite(a)[finite_ref].all()) and e <= gtol,
                          f"fused_attention_bwd fp16 large dO {kind} d{t}: not finite where the "
                          f"float32 reference is, or err {e} beyond {gtol}")
                print(f"kernels: fused_attention_bwd fp16 {shape}, loss-scaled dO ({kind}: max "
                      f"|dO V^T| {dp_max:.3e}, max |dS| {ds_max:.3e}): finite, errs "
                      f"{[f'{e:.1e}' for e in errs]}", flush=True)
                del x, hq, hk, hv, hg, hout, hlse, got, want, dp, p

        per_shape = {}
        for shape in H16_SHAPES[:H16_TIMED]:
            b, h, n, d = shape
            scale = VITB_SCALE if h == 12 else ATTN_SCALE
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            with torch.inference_mode():
                r = {"ms": time_ms(lambda: fused_attention_h16_fwd(q, k, v, scale)),
                     "device_ms": device_ms(lambda: fused_attention_h16_fwd(q, k, v, scale)),
                     "plain_ms": time_ms(lambda: attention_plain(q, k, v, scale), reps=10,
                                         warmup=2),
                     "library_ms": time_ms(
                         lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                     "library_device_ms": device_ms(
                         lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))}
            r["bound_ms"], r["bound_by"] = h16_bound_ms(4 * n * n * d * b * h,
                                                        4 * q.numel() * 2)
            out, lse = fused_attention_h16_fwd(q, k, v, scale, with_lse=True)
            rb = {"ms": time_ms(lambda: fused_attention_h16_bwd(q, k, v, out, lse, g, scale)),
                  "device_ms": device_ms(
                      lambda: fused_attention_h16_bwd(q, k, v, out, lse, g, scale))}
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            plain_out = attention_plain(*leaves, scale)
            rb["plain_ms"] = time_ms(
                lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True), reps=10,
                warmup=2)
            sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
            rb["library_ms"] = time_ms(
                lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
            rb["library_device_ms"] = device_ms(
                lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
            rb["bound_ms"], rb["bound_by"] = h16_bound_ms(10 * n * n * d * b * h,
                                                          8 * q.numel() * 2 + lse.numel() * 4)
            per_shape[shape] = (r, rb)
            for what, x in (("fused_attention", r), ("fused_attention_bwd", rb)):
                print(f"kernels: {what} {tag} {shape}: {x['ms']:.4f} ms (device "
                      f"{ms_text(x['device_ms'])}), plain {x['plain_ms']:.4f} ms, sdpa "
                      f"{x['library_ms']:.4f} ms (device {ms_text(x['library_device_ms'])}); "
                      f"bound {x['bound_ms']:.4f} ms ({x['bound_by']}, "
                      f"{100 * x['bound_ms'] / x['ms']:.1f}% of it)", flush=True)
            del q, k, v, g, out, lse, leaves, plain_out, sdpa_out
        for i, (what, src, line, err) in enumerate((
                ("fused_attention", "attention_h16_fwd.cu", 39, fwd_err),
                ("fused_attention_bwd", "attention_h16_bwd.cu", 51, bwd_err))):
            main = per_shape[H16_SHAPES[0]][i]
            lib = src.removesuffix(".cu")
            entries.append({
                "name": f"{what}_{tag}", "route": "cuda",
                "source": f"rgbnomore_tpu_torch/csrc/{src}",
                "replaces": f"rgbnomore_tpu/ops/pallas/attention.py:{line}",
                "dtype": name, "launches": None, "max_abs_err": err,
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                "device_ms": main["device_ms"], "library_device_ms": main["library_device_ms"],
                "per_shape": {str(list(sh)): r[i] for sh, r in per_shape.items()},
                # the instances of the main path's shape: D = 64, N = 196
                "ptxas": {k_: v_ for k_, v_ in PTXAS.get(lib, {}).items()
                          if ("half" if tag == "fp16" else "bfloat16") in k_
                          and re.search(r",1,13[,>]", k_)},
                "wgmma_notes": WGMMA_NOTES.get(lib, [])})
    return entries


def kernel_augpipe() -> dict:
    """The fused flip + RandAugment + ToRange kernel against its plain
    version: each of the 16 ops forced with the explicit policy and flip of
    ``tests/test_pallas_augpipe.py:56-76`` at its shape, policies drawn
    from AUGLIST_DCT at SwinV2-T's (128, 32x32) and from both presets at the
    ViT-Ti's (256, 28x28); then timed at the ViT-Ti's and SwinV2-T's."""
    import torch

    from rgbnomore_tpu_torch.augment.randaugment import RandAugmentDCT
    from rgbnomore_tpu_torch.ops.augpipe import (
        SUPPORTED_OPS,
        flip_aug_range_plain,
        fused_flip_aug_range,
    )
    from rgbnomore_tpu_torch.train.config import AUGLIST_DCT, AUGLIST_DCT_VITTI

    rng = np.random.default_rng(SEED)

    def coeffs(b, grid):
        """Uniform in [-1100, 1100], beyond the clamp range, as the Pallas test."""
        y = rng.uniform(-1100, 1100, (b, 1, grid, grid, 8, 8)).astype(np.float32)
        c = rng.uniform(-1100, 1100, (b, 2, grid // 2, grid // 2, 8, 8)).astype(np.float32)
        return torch.from_numpy(y).cuda(), torch.from_numpy(c).cuda()

    def compare(tag, y, c, policy, flip, **kw):
        gy, gc = fused_flip_aug_range(y, c, policy, flip, **kw)
        wy, wc = flip_aug_range_plain(y, c, policy, flip, **kw)
        torch.cuda.synchronize()
        err = max(float((gy - wy).abs().max()), float((gc - wc).abs().max()))
        check(torch.allclose(gy, wy, **AUG_TOL) and torch.allclose(gc, wc, **AUG_TOL),
              f"fused_flip_aug_range {tag}: max abs err {err} beyond {AUG_TOL}")
        return err

    forced = (torch.zeros((3, 1), dtype=torch.int32), torch.tensor([[1.0], [-1.0], [1.0]]),
              torch.tensor([[4], [0], [10]], dtype=torch.int32),
              torch.tensor([[6], [2], [0]], dtype=torch.int32),
              torch.tensor([[True], [False], [True]]))
    forced_flip = torch.tensor([False, True, False])
    y, c = coeffs(3, 12)
    max_err = max(compare(name, y, c, forced, forced_flip, ops_list=[name], num_ops=1,
                          magnitude=5) for name in sorted(SUPPORTED_OPS))
    print(f"kernels: fused_flip_aug_range, each of {len(SUPPORTED_OPS)} ops forced at "
          f"(3, 12x12): max abs err {max_err:.3e}", flush=True)
    gen = torch.Generator().manual_seed(SEED)
    for tag, auglist, batch, grid in (
            ("AUGLIST_DCT", AUGLIST_DCT, SWIN_TRAIN_BATCH, SWIN_GRID),
            ("AUGLIST_DCT", AUGLIST_DCT, BATCH, GRID),
            ("AUGLIST_DCT_VITTI", AUGLIST_DCT_VITTI, BATCH, GRID)):
        aug = RandAugmentDCT(ops_list=list(auglist), num_ops=2, magnitude=3, grid=grid)
        policy = aug.draw_policy(gen, batch, grid, grid)
        flip = torch.rand(batch, generator=gen) < 0.5
        y, c = coeffs(batch, grid)
        kw = dict(ops_list=list(auglist), num_ops=2, magnitude=3)
        err = compare(tag, y, c, policy, flip, **kw)
        max_err = max(max_err, err)
        print(f"kernels: fused_flip_aug_range {tag} drawn at ({batch}, {grid}x{grid}): max abs "
              f"err {err:.3e}", flush=True)
        if grid == SWIN_GRID:
            policy_d, flip_d = tuple(p.cuda() for p in policy), flip.cuda()
            swin_ms = time_ms(lambda: fused_flip_aug_range(y, c, policy_d, flip_d, **kw))
            print(f"kernels: fused_flip_aug_range ({batch}, {grid}x{grid}) {swin_ms:.4f} ms",
                  flush=True)
    # timed with the last (the ViT-Ti) policy already on the card
    policy, flip = tuple(p.cuda() for p in policy), flip.cuda()
    ms = time_ms(lambda: fused_flip_aug_range(y, c, policy, flip, **kw))
    dev_ms = device_ms(lambda: fused_flip_aug_range(y, c, policy, flip, **kw))
    plain_ms = time_ms(lambda: flip_aug_range_plain(y, c, policy, flip, **kw), reps=10, warmup=2)
    # y and c read once and written once; per coefficient the entry clamp,
    # a multiply and a clamp per round and ToRange's multiply-add
    elements = y.numel() + c.numel()
    t_bytes = 2 * elements * 4 / PEAK_BYTES_PER_S
    t_ops = elements * (4 + 3 * kw["num_ops"]) / PEAK_F32_FLOP_PER_S
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes > t_ops else "operations")
    print(f"kernels: fused_flip_aug_range ({BATCH}, {GRID}x{GRID}) {ms:.4f} ms (device "
          f"{ms_text(dev_ms)}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"{100 * bound_ms / ms:.1f}%), no library call", flush=True)
    return {
        "name": "fused_flip_aug_range", "route": "cuda",
        "source": "rgbnomore_tpu_torch/csrc/augpipe.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/augpipe.py:345",
        "entry": "the dense reader (augpipe_fwd): the TPU kernel's own contract, launched "
                 "once a train step by the packed and dense transfers; the cropped paths "
                 "launch the same kernel's wire reader (augpipe_wire)",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "device_ms": dev_ms,
    }


def wire_read_bytes(rows: np.ndarray, grid: int, k: int, fmt: str) -> int:
    """The wire bytes that a stage must read for these rows: per block its
    8-byte mask, its scale, its int16 DC and the values of its first
    min(set bits, K) slots; per sample mask16q's quant tables."""
    from rgbnomore_tpu_torch.data.loader import packed_layout

    f = row_fields(rows, packed_layout(grid, k, fmt))
    value_bytes = 2 if fmt == "mask16w" else 1
    total = 3 * 64 * 2 * rows.shape[0] if fmt == "mask16q" else 0
    for tag in ("y", "c"):
        set_bits = np.unpackbits(f[f"i{tag}"], axis=-1).sum(axis=-1)
        total += set_bits.size * (8 + 1 + 2) + int(np.minimum(set_bits, k).sum()) * value_bytes
    return total


def kernel_augpipe_wire() -> dict:
    """The same kernel's wire reader (``wire_flip_aug_range`` for the train
    stage, ``wire_to_range`` for eval) against its plain version (split ->
    unpack -> flip + RandAugment + ToRange, or -> ToRange): each of the 16
    ops forced at (3, 12x12) for each wire format, rows random beyond what
    the packer writes (``random_wire_rows``); then at the four shapes of the
    main paths on rows that ``write_rows`` packs from synthetic planes, as
    the slice and train phases feed them: the ViT-Ti train stage (256,
    28x28, K=16; both presets drawn), SwinV2-T's (128, 32x32, K=16), the
    ViT-Ti eval stage (256, 28x28, K=48) and SwinV2-T's (256, 32x32, K=48);
    train within AUG_TOL, eval bit-exact (``torch.equal``); random rows of
    each format at the ViT-Ti shapes besides.  Each main shape is timed
    beside the plain version, with its device time and its bytes bound: the
    wire bytes its rows need (``wire_read_bytes``) read once and the dense
    float32 planes written once."""
    import torch

    from rgbnomore_tpu_torch.augment.pipeline import make_cropped_train_pipeline
    from rgbnomore_tpu_torch.ops.augpipe import (
        SUPPORTED_OPS,
        WIRE_FORMATS,
        wire_flip_aug_range,
        wire_flip_aug_range_plain,
        wire_to_range,
        wire_to_range_plain,
    )
    from rgbnomore_tpu_torch.train.config import AUGLIST_DCT, AUGLIST_DCT_VITTI

    rng = np.random.default_rng(SEED + 5)

    def held(tag, rows, flip=None, policy=None, **kw):
        """Max abs err of the kernel against its plain version on ``rows``."""
        packed = torch.from_numpy(rows).cuda()
        if policy is None:
            got, want = wire_to_range(packed, **kw), wire_to_range_plain(packed, **kw)
        else:
            got = wire_flip_aug_range(packed, flip, policy, **kw)
            want = wire_flip_aug_range_plain(packed, flip, policy, **kw)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        if policy is None:
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"wire_to_range {tag}: max abs err {err}, not bit-exact")
        else:
            check(all(torch.allclose(g, w, **AUG_TOL) for g, w in zip(got, want)),
                  f"wire_flip_aug_range {tag}: max abs err {err} beyond {AUG_TOL}")
        return err

    forced = (torch.zeros((3, 1), dtype=torch.int32), torch.tensor([[1.0], [-1.0], [1.0]]),
              torch.tensor([[4], [0], [10]], dtype=torch.int32),
              torch.tensor([[6], [2], [0]], dtype=torch.int32),
              torch.tensor([[True], [False], [True]]))
    forced_flip = torch.tensor([False, True, False])
    max_err = 0.0
    for fmt in WIRE_FORMATS:
        rows = random_wire_rows(rng, 3, 12, K_TRAIN, fmt)
        err = max(held(f"{name} {fmt}", rows, forced_flip, forced, target=12, k=K_TRAIN, fmt=fmt,
                       ops_list=[name], num_ops=1, magnitude=5) for name in sorted(SUPPORTED_OPS))
        max_err = max(max_err, err)
        print(f"kernels: wire_flip_aug_range {fmt}, each of {len(SUPPORTED_OPS)} ops forced at "
              f"(3, 12x12): max abs err {err:.3e}", flush=True)
    gen = torch.Generator().manual_seed(SEED)
    vit_pipe = make_cropped_train_pipeline(target=GRID, auglist=list(AUGLIST_DCT_VITTI),
                                           num_ops=2, magnitude=3, k=K_TRAIN)
    for fmt in WIRE_FORMATS:  # every format at the ViT-Ti shapes, random rows
        flip, policy, _ = vit_pipe.draw(gen, BATCH)
        err = held(f"{fmt} random rows ({BATCH}, {GRID}x{GRID})",
                   random_wire_rows(rng, BATCH, GRID, K_TRAIN, fmt), flip, policy, target=GRID,
                   k=K_TRAIN, fmt=fmt, ops_list=list(AUGLIST_DCT_VITTI), num_ops=2, magnitude=3)
        held(f"{fmt} random rows ({BATCH}, {GRID}x{GRID})",
             random_wire_rows(rng, BATCH, GRID, K_EVAL, fmt), target=GRID, k=K_EVAL, fmt=fmt)
        max_err = max(max_err, err)
        print(f"kernels: wire reader {fmt}, random rows at ({BATCH}, {GRID}x{GRID}): train "
              f"max abs err {err:.3e}, eval bit-exact", flush=True)

    shapes = {"vit_train": (BATCH, GRID, K_TRAIN, [AUGLIST_DCT, AUGLIST_DCT_VITTI]),
              "swin_train": (SWIN_TRAIN_BATCH, SWIN_GRID, K_TRAIN, [AUGLIST_DCT]),
              "vit_eval": (BATCH, GRID, K_EVAL, None),
              "swin_eval": (SWIN_EVAL_BATCH, SWIN_GRID, K_EVAL, None)}
    per_shape = {}
    for tag, (batch, grid, k, presets) in shapes.items():
        rows = vit_rows(rng, batch, k, grid=grid)
        packed = torch.from_numpy(rows).cuda()
        kw = dict(target=grid, k=k, fmt="mask16")
        if presets is None:
            held(f"{tag} ({batch}, {grid}x{grid}, K={k})", rows, **kw)
            fn = functools.partial(wire_to_range, packed, **kw)
            plain = functools.partial(wire_to_range_plain, packed, **kw)
            ops = 0
        else:
            for auglist in presets:  # the last is the path's own list
                kw.update(ops_list=list(auglist), num_ops=2, magnitude=3)
                pipe = make_cropped_train_pipeline(target=grid, auglist=list(auglist), num_ops=2,
                                                   magnitude=3, k=k)
                flip, policy, _ = pipe.draw(gen, batch)
                max_err = max(max_err, held(f"{tag} ({batch}, {grid}x{grid}, K={k})", rows,
                                            flip, policy, **kw))
            flip, policy = flip.cuda(), tuple(p.cuda() for p in policy)
            fn = functools.partial(wire_flip_aug_range, packed, flip, policy, **kw)
            plain = functools.partial(wire_flip_aug_range_plain, packed, flip, policy, **kw)
            ops = 3 * kw["num_ops"]
        ms, dev_ms = time_ms(fn), device_ms(fn)
        plain_ms = time_ms(plain, reps=10, warmup=2)
        read, written = wire_read_bytes(rows, grid, k, "mask16"), sum(t.numel() * 4 for t in fn())
        t_bytes = (read + written) / PEAK_BYTES_PER_S
        # per coefficient: the decode (rank, test, scale), the entry clamp,
        # ToRange, and a multiply and a clamp per round
        t_ops = written / 4 * (8 + ops) / PEAK_F32_FLOP_PER_S
        bound = max(t_bytes, t_ops) * 1e3
        per_shape[tag] = {"shape": [batch, grid, k], "ms": ms, "device_ms": dev_ms,
                          "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": "bytes" if t_bytes > t_ops else "operations",
                          "wire_bytes": read, "dense_bytes": written}
        print(f"kernels: {'wire_to_range' if presets is None else 'wire_flip_aug_range'} {tag} "
              f"({batch}, {grid}x{grid}, K={k}): {ms:.4f} ms (device {ms_text(dev_ms)}), plain "
              f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({per_shape[tag]['bound_by']}: "
              f"{read / 1e6:.2f} MB of wire read, {written / 1e6:.2f} MB written; "
              f"{100 * bound / ms:.1f}% of it, "
              f"{'not measured' if dev_ms is None else f'{100 * bound / dev_ms:.1f}%'} of the "
              f"device time)", flush=True)
    main = per_shape["vit_train"]
    return {
        "name": "augpipe_wire", "route": "cuda", "source": "rgbnomore_tpu_torch/csrc/augpipe.cu",
        "replaces": "rgbnomore_tpu/ops/pallas/augpipe.py:345",
        "entry": "the wire reader (augpipe_wire) of the same kernel: wire_flip_aug_range "
                 "(train) and wire_to_range (eval) read the mask16 rows themselves, with the "
                 "unpack of rgbnomore_tpu/augment/pipeline.py:89-136 in the same launch",
        "launches": None, "max_abs_err": max_err, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "device_ms": main["device_ms"], "per_shape": per_shape,
    }


def window_cases(batch: int) -> list[tuple]:
    """(bw, h, n, d, P) of SwinV2-T's window attention at ``batch``: each
    stage unshifted (P = 1) and, where it shifts, shifted (P = nW)."""
    cases = []
    for wins, heads, shifted in SWIN_STAGES:
        cases.append((batch * wins, heads, WIN_N, WIN_D, 1))
        if shifted:
            cases.append((batch * wins, heads, WIN_N, WIN_D, shifted))
    return cases


def window_inputs(gen, case):
    """q (cosine-normalized, times SwinV2's initial logit scale 10), k
    (normalized), v, the output gradient and a bias with a shift-mask-like
    -100 on about a quarter of each pattern's entries."""
    import torch

    bw, h, n, d, p = case
    q, k, v, g = (torch.randn((bw, h, n, d), generator=gen, device="cuda") for _ in range(4))
    q = 10.0 * q / q.norm(dim=-1, keepdim=True)
    k = k / k.norm(dim=-1, keepdim=True)
    bias = 16.0 * torch.rand((p, h, n, n), generator=gen, device="cuda")
    if p > 1:
        bias = bias - 100.0 * (torch.rand((p, 1, n, n), generator=gen, device="cuda") < 0.25)
    return q.contiguous(), k.contiguous(), v, g, bias.contiguous()


def window_bounds_ms(case) -> tuple[dict, dict]:
    """(forward, backward) bounds on the card (``product_bounds_ms``): q, k,
    v (and dO) read once, o (dq, dk, dv) written once, the bias read (and
    its gradient written) once, in float32; against 4 N^2 D (10 N^2 D) FLOP
    of products per (window, head)."""
    bw, h, n, d, p = case
    qkv = bw * h * n * d * 4
    bias = p * h * n * n * 4
    return (product_bounds_ms(4 * n * n * d * bw * h, 4 * qkv + bias),
            product_bounds_ms(10 * n * n * d * bw * h, 7 * qkv + 2 * bias))


@functools.cache
def benchmark_bounds():
    """The benchmark's own bounds, ``portbench/bounds.py`` (it imports
    nothing), loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench", "bounds.py")
    spec = importlib.util.spec_from_file_location("portbench_bounds", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def window_blocks(batch: int) -> list[tuple[tuple, int]]:
    """(case, blocks) of one SwinV2-T pass at ``batch``: each stage's even
    blocks unshifted, its odd ones shifted (stage 4, one window, never
    shifts)."""
    out = []
    for (wins, heads, shifted), n_blocks in zip(SWIN_STAGES, SWIN_BLOCKS_PER_STAGE):
        n_shift = n_blocks // 2 if shifted else 0
        out.append(((batch * wins, heads, WIN_N, WIN_D, 1), n_blocks - n_shift))
        if n_shift:
            out.append(((batch * wins, heads, WIN_N, WIN_D, shifted), n_shift))
    return out


def sdpa_mask(bias, bw: int):
    """The (P, H, N, N) bias as SDPA's (BW, H, N, N) ``attn_mask``, window w
    on pattern w % P: a broadcast view where P = 1, a copy otherwise."""
    p, h, n, _ = bias.shape
    if p == 1:
        return bias.expand(bw, h, n, n)
    return bias.expand(bw // p, p, h, n, n).reshape(bw, h, n, n)


def kernel_window_attention(gen) -> tuple[dict, dict]:
    """Kernels #3 and #4 against their plain versions at every SwinV2-T
    stage shape of the train batch (unshifted and shifted) and the JAX
    tests' shapes, with two backward runs bit-identical; then timed at each
    stage, unshifted and shifted, beside the plain versions, the bounds and
    SDPA (``attn_mask`` = the bias expanded to every window, ``scale=1``;
    its backward with the bias requiring grad), with the kernels' device
    time from ``torch.profiler``; the forward also at the eval batch.  The
    sums over one train step (12 forward, 12 backward calls) and one eval
    batch (12 forward calls) take each block's own case.  The report's
    numbers are stage 1, unshifted, the largest launch, with the sums and
    the main path's ``ptxas`` lines beside them."""
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_bwd,
        window_attention_bwd_plain,
        window_attention_plain,
    )

    fwd_err = bwd_err = 0.0
    for case in window_cases(SWIN_TRAIN_BATCH) + WIN_JAX_CASES:
        q, k, v, g, bias = window_inputs(gen, case)
        with torch.inference_mode():
            got = window_attention(q, k, v, bias)
            want = window_attention_plain(q, k, v, bias)
        grads = window_attention_bwd(q, k, v, bias, g)
        again = window_attention_bwd(q, k, v, bias, g)
        wgrads = window_attention_bwd_plain(q, k, v, bias, g)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        fwd_err = max(fwd_err, err)
        check(torch.allclose(got, want, **WIN_TOL),
              f"window_attention {case}: max abs err {err} beyond {WIN_TOL}")
        errs = []
        for tag, a, b, w in zip("qkvb", grads, again, wgrads):
            check(torch.equal(a, b), f"window_attention_bwd {case} d{tag} differs between runs")
            errs.append(float((a - w).abs().max()))
            check(torch.allclose(a, w, **GRAD_TOL),
                  f"window_attention_bwd {case} d{tag}: max abs err {errs[-1]} beyond {GRAD_TOL}")
        bwd_err = max(bwd_err, *errs)
        print(f"kernels: window_attention {case} fwd max abs err {err:.3e}, bwd dq/dk/dv/db "
              f"{'/'.join(f'{e:.1e}' for e in errs)}", flush=True)
        del q, k, v, g, bias, got, want, grads, again, wgrads

    def forward_times(case) -> dict:
        q, k, v, _, bias = window_inputs(gen, case)
        mask = sdpa_mask(bias, case[0])
        with torch.inference_mode():
            out = {"ms": time_ms(lambda: window_attention(q, k, v, bias)),
                   "device": device_ms(lambda: window_attention(q, k, v, bias)),
                   "plain": time_ms(lambda: window_attention_plain(q, k, v, bias),
                                    reps=10, warmup=2),
                   "sdpa": time_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, scale=1.0)),
                   "sdpa_device": device_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, scale=1.0))}
        out["bound"] = window_bounds_ms(case)[0]
        return out

    def backward_times(case) -> dict:
        q, k, v, g, bias = window_inputs(gen, case)
        out = {"ms": time_ms(lambda: window_attention_bwd(q, k, v, bias, g)),
               "device": device_ms(lambda: window_attention_bwd(q, k, v, bias, g))}
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        res = window_attention_plain(*leaves)
        out["plain"] = time_ms(lambda: torch.autograd.grad(res, leaves, g, retain_graph=True),
                               reps=10, warmup=2)
        res = F.scaled_dot_product_attention(*leaves[:3], attn_mask=sdpa_mask(leaves[3], case[0]),
                                             scale=1.0)
        out["sdpa"] = time_ms(lambda: torch.autograd.grad(res, leaves, g, retain_graph=True))
        out["sdpa_device"] = device_ms(
            lambda: torch.autograd.grad(res, leaves, g, retain_graph=True))
        out["bound"] = window_bounds_ms(case)[1]
        return out

    def line(tag, case, r) -> str:
        (tc, tc_by), (f32, _) = r["bound"]["tc"], r["bound"]["f32"]
        return (f"kernels: {tag} {case}: {r['ms']:.4f} ms (device {ms_text(r['device'])}), plain "
                f"{r['plain']:.4f}, sdpa {r['sdpa']:.4f} (device {ms_text(r['sdpa_device'])}); "
                f"bound 3xTF32 {tc:.4f} ({tc_by}, {100 * tc / r['ms']:.1f}%), float32 "
                f"{f32:.4f} ({100 * f32 / r['ms']:.1f}%)")

    def sums(rows: dict, blocks) -> dict:
        """Sums over one pass's 12 calls, each block at its own case."""
        total = {}
        for key in ("ms", "device", "plain", "sdpa", "sdpa_device"):
            vals = [rows[case][key] for case, _ in blocks]
            total[key] = (None if any(x is None for x in vals)
                          else sum(nb * x for x, (_, nb) in zip(vals, blocks)))
        for key in ("tc", "f32"):
            total[key] = sum(nb * rows[case]["bound"][key][0] for case, nb in blocks)
        return total

    train, fwd_rows, bwd_rows = window_blocks(SWIN_TRAIN_BATCH), {}, {}
    for case, _ in train:
        fwd_rows[case] = forward_times(case)
        print(line("window_attention", case, fwd_rows[case]), flush=True)
        bwd_rows[case] = backward_times(case)
        print(line("window_attention_bwd", case, bwd_rows[case]), flush=True)
    evals, eval_rows = window_blocks(SWIN_EVAL_BATCH), {}
    for case, _ in evals:
        eval_rows[case] = forward_times(case)
        print(line("window_attention", case, eval_rows[case]), flush=True)
    step = {"fwd": sums(fwd_rows, train), "bwd": sums(bwd_rows, train),
            "eval": sums(eval_rows, evals)}
    for tag, what in (("fwd", f"per train step of {SWIN_TRAIN_BATCH}, forward"),
                      ("bwd", f"per train step of {SWIN_TRAIN_BATCH}, backward"),
                      ("eval", f"per eval batch of {SWIN_EVAL_BATCH}, forward")):
        t = step[tag]
        print(f"kernels: window_attention {what} (12 calls): {t['ms']:.4f} ms (device "
              f"{ms_text(t['device'])}), plain {t['plain']:.4f}, sdpa {t['sdpa']:.4f} (device "
              f"{ms_text(t['sdpa_device'])}); bound 3xTF32 {t['tc']:.4f}, float32 "
              f"{t['f32']:.4f}", flush=True)

    def entry(name, source, replaces, err, r, lib, kernel, per_pass):
        bounds = product_kernel_entry(r["ms"], r["bound"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": None, "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain"],
                **bounds, "library_ms": r["sdpa"], "device_ms": r["device"],
                "library_device_ms": r["sdpa_device"],
                "ptxas": {k: v for k, v in PTXAS.get(lib, {}).items() if kernel in k},
                "per_pass": per_pass}

    main = train[0][0]  # stage 1, unshifted
    fwd = entry("window_attention", "rgbnomore_tpu_torch/csrc/window_attention_fwd.cu",
                "rgbnomore_tpu/ops/pallas/attention.py:156", fwd_err, fwd_rows[main],
                "window_attention_fwd", f"<{(WIN_D + 15) // 16},{(WIN_N + 15) // 16}>",
                {"train_step": step["fwd"], "eval_batch": step["eval"]})
    bwd = entry("window_attention_bwd", "rgbnomore_tpu_torch/csrc/window_attention_bwd.cu",
                "rgbnomore_tpu/ops/pallas/attention.py:170", bwd_err, bwd_rows[main],
                "window_attention_bwd", f"<{(WIN_D + 15) // 16},{(WIN_N + 15) // 16}>",
                {"train_step": step["bwd"]})
    return fwd, bwd


def swinb_blocks(batch: int) -> list[tuple[tuple, int]]:
    """(case, blocks) of one SwinV2-B/w16 pass at ``batch``, (bw, h, n, d,
    P) as ``window_blocks``: each stage's even blocks unshifted, its odd
    ones shifted where the stage has more than one window."""
    out = []
    for (wins, heads, n, shifted), n_blocks in zip(SWINB_STAGES, SWINB_BLOCKS_PER_STAGE):
        n_shift = n_blocks // 2 if shifted else 0
        out.append(((batch * wins, heads, n, WIN_D, 1), n_blocks - n_shift))
        if n_shift:
            out.append(((batch * wins, heads, n, WIN_D, shifted), n_shift))
    return out


def tiled_inputs(gen, case):
    """As ``window_inputs`` (q cosine-normalized times 10, k normalized, v
    and the output gradient N(0, 1), a 16 U(0, 1) bias), with SwinV2's own
    -100 shift mask (``models/swinv2.py:_shift_attn_mask``) on the P
    patterns of a shifted block of square windows."""
    import torch

    from rgbnomore_tpu_torch.models.swinv2 import _shift_attn_mask

    bw, h, n, d, p = case
    q, k, v, g = (torch.randn((bw, h, n, d), generator=gen, device="cuda") for _ in range(4))
    q = 10.0 * q / q.norm(dim=-1, keepdim=True)
    k = k / k.norm(dim=-1, keepdim=True)
    bias = 16.0 * torch.rand((p, h, n, n), generator=gen, device="cuda")
    if p > 1:
        ws = math.isqrt(n)
        side = ws * math.isqrt(p)
        bias = bias + torch.from_numpy(_shift_attn_mask(side, side, ws, ws // 2)).cuda()[:, None]
    return q.contiguous(), k.contiguous(), v, g, bias.contiguous()


TILED_OUTPUTS = ("out", "dq", "dk", "dv", "db")


def tiled_errors(got, q, k, v, bias, g) -> dict:
    """Errors of the outputs ``got`` (out, dq, dk, dv, db) as shares of the
    float64 reference's largest entry, output by output: ``kernel`` (got
    against float64), ``vs_plain`` (got against the float32 plain version),
    ``plain`` (the plain version against float64) and ``control`` (float64
    on q, k, v and dO rounded once to TF32, against float64).  The
    references run over slices of whole bias patterns, about 2^26 logits a
    slice; the bias gradients are summed over the slices."""
    import torch

    from rgbnomore_tpu_torch.ops.window_attention import window_attention_plain

    def grads(xq, xk, xv, xg, dtype):
        leaves = [x.detach().to(dtype).requires_grad_(True) for x in (xq, xk, xv, bias)]
        with torch.enable_grad():
            out = window_attention_plain(*leaves)
            return (out.detach(), *torch.autograd.grad(out, leaves, xg.to(dtype)))

    bw, h, n, _ = q.shape
    p = bias.shape[0]
    step = max(1, (1 << 26) // (h * n * n * p)) * p
    err = {who: [0.0] * 5 for who in ("kernel", "vs_plain", "plain", "control")}
    top = [0.0] * 4
    dbs = {who: torch.zeros(bias.shape, dtype=torch.float64, device=q.device)
           for who in ("ref", "plain", "control")}
    for s in range(0, bw, step):
        part = [x[s:s + step] for x in (q, k, v, g)]
        ref = grads(*part, torch.float64)
        plain = grads(*part, torch.float32)
        control = grads(*(tf32_rna(x) for x in part), torch.float64)
        mine = [x[s:s + step] for x in got[:4]]
        for i in range(4):
            top[i] = max(top[i], float(ref[i].abs().max()))
            for who, a, b in (("kernel", mine[i], ref[i]), ("vs_plain", mine[i], plain[i]),
                              ("plain", plain[i], ref[i]), ("control", control[i], ref[i])):
                err[who][i] = max(err[who][i], float((a.double() - b.double()).abs().max()))
        for who, res in (("ref", ref), ("plain", plain), ("control", control)):
            dbs[who] += res[4].double()
        del ref, plain, control
    for i in range(4):
        for who in err:
            err[who][i] /= top[i]
    db_top = float(dbs["ref"].abs().max())
    for who, a, b in (("kernel", got[4], dbs["ref"]), ("vs_plain", got[4], dbs["plain"]),
                      ("plain", dbs["plain"], dbs["ref"]),
                      ("control", dbs["control"], dbs["ref"])):
        err[who][4] = float((a.double() - b).abs().max()) / db_top
    return {who: dict(zip(TILED_OUTPUTS, e)) for who, e in err.items()}


def sdpa_windows(q, k, v, bias):
    """SDPA with the (P, H, N, N) bias as its float ``attn_mask``, ``scale=1``:
    the windows viewed (BW / P, P H, N, D), so that one broadcast view of
    the bias, (1, P H, N, N), gives each window its own pattern."""
    import torch.nn.functional as F

    bw, h, n, d = q.shape
    p = bias.shape[0]
    qs, ks, vs = (x.view(bw // p, p * h, n, d) for x in (q, k, v))
    mask = bias.view(1, p * h, n, n).expand(bw // p, p * h, n, n)
    return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=1.0)


def kernel_window_attention_tiled(gen) -> tuple[dict, dict]:
    """Kernels #3L and #4L (windows of 65-256 tokens) at each SwinV2-B/w16
    shape of a train step at batch 256 (stages 1-3, unshifted and
    shifted): the forward through ``window_attention`` and its four
    gradients against float64 and the float32 plain version
    (``tiled_errors``) within ``TILED_TOL`` of the largest entry, a
    TF32-rounded control beyond it on every output, two runs of each giving
    the same bits; then each shape timed beside the bounds, the plain
    version and SDPA, with its device time, and the times summed over one
    step's 24 calls (stage 4's two on #3 and #4).  Last, the tiled pair at
    SwinV2-T's shapes (N = 64) against #3 and #4, device time per train
    step of 128: what keeping both pairs rests on.  The report's numbers
    are stage 1, unshifted."""
    import torch

    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_bwd,
        window_attention_plain,
        window_attention_tiled_bwd,
        window_attention_tiled_fwd,
    )

    blocks = swinb_blocks(SWINB_BATCH)
    checked = ("kernel", "vs_plain", "plain")
    worst = {part: dict.fromkeys(checked, 0.0) for part in ("fwd", "bwd")}
    for case, _ in blocks:
        if case[2] <= WIN_N:
            continue
        q, k, v, g, bias = tiled_inputs(gen, case)
        with torch.inference_mode():
            routed = window_attention(q, k, v, bias)
        out, lse = window_attention_tiled_fwd(q, k, v, bias, lse=True)
        out2, lse2 = window_attention_tiled_fwd(q, k, v, bias, lse=True)
        got = (out, *window_attention_tiled_bwd(q, k, v, bias, out, lse, g))
        again = (out2, *window_attention_tiled_bwd(q, k, v, bias, out2, lse2, g))
        torch.cuda.synchronize()
        check(torch.equal(routed, out) and torch.equal(lse, lse2),
              f"window_attention_tiled {case}: window_attention or a second run differs")
        for tag, a, b in zip(TILED_OUTPUTS, got, again):
            check(torch.equal(a, b), f"window_attention_tiled {case} {tag} differs between runs")
        errs = tiled_errors(got, q, k, v, bias, g)
        for tag in TILED_OUTPUTS:
            for who in checked:
                check(errs[who][tag] < TILED_TOL, f"window_attention_tiled {case} {tag}: {who} "
                      f"error {errs[who][tag]:.2e} of the largest entry, beyond {TILED_TOL}")
            check(errs["control"][tag] > TILED_TOL,
                  f"window_attention_tiled {case} {tag}: the TF32-rounded control reads "
                  f"{errs['control'][tag]:.2e}, within {TILED_TOL}")
        for who in checked:
            worst["fwd"][who] = max(worst["fwd"][who], errs[who]["out"])
            worst["bwd"][who] = max(worst["bwd"][who],
                                    *(errs[who][t] for t in TILED_OUTPUTS[1:]))
        print(f"kernels: window_attention_tiled {case} of the float64 largest entry, out/dq/dk/"
              f"dv/db: " + "; ".join(f"{who} " + "/".join(f"{e:.1e}" for e in errs[who].values())
                                     for who in errs), flush=True)
        del q, k, v, g, bias, routed, out, out2, lse, lse2, got, again
        torch.cuda.empty_cache()

    def times(case) -> tuple[dict, dict]:
        q, k, v, g, bias = tiled_inputs(gen, case)
        if case[2] > WIN_N:
            out, lse = window_attention_tiled_fwd(q, k, v, bias, lse=True)
            bwd = lambda: window_attention_tiled_bwd(q, k, v, bias, out, lse, g)  # noqa: E731
        else:
            bwd = lambda: window_attention_bwd(q, k, v, bias, g)  # noqa: E731
        with torch.inference_mode():
            fwd = {"ms": time_ms(lambda: window_attention(q, k, v, bias)),
                   "device": device_ms(lambda: window_attention(q, k, v, bias)),
                   "plain": time_ms(lambda: window_attention_plain(q, k, v, bias),
                                    reps=10, warmup=2),
                   "sdpa": time_ms(lambda: sdpa_windows(q, k, v, bias)),
                   "sdpa_device": device_ms(lambda: sdpa_windows(q, k, v, bias))}
        back = {"ms": time_ms(bwd), "device": device_ms(bwd)}
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        res = window_attention_plain(*leaves)
        back["plain"] = time_ms(lambda: torch.autograd.grad(res, leaves, g, retain_graph=True),
                                reps=10, warmup=2)
        res = sdpa_windows(*leaves)
        gs = g.view_as(res)
        back["sdpa"] = time_ms(lambda: torch.autograd.grad(res, leaves, gs, retain_graph=True))
        back["sdpa_device"] = device_ms(
            lambda: torch.autograd.grad(res, leaves, gs, retain_graph=True))
        fwd["bound"], back["bound"] = window_bounds_ms(case)
        fwd["bench"], back["bench"] = (1e3 * benchmark_bounds().window_bound_s(*case, b)
                                       for b in (False, True))
        return fwd, back

    def line(tag, case, r) -> str:
        (tc, tc_by), (f32, _) = r["bound"]["tc"], r["bound"]["f32"]
        return (f"kernels: {tag} {case}: {r['ms']:.4f} ms (device {ms_text(r['device'])}), plain "
                f"{r['plain']:.4f}, sdpa {r['sdpa']:.4f} (device {ms_text(r['sdpa_device'])}); "
                f"bound 3xTF32 {tc:.4f} ({tc_by}, {100 * tc / r['ms']:.1f}%), the benchmark's "
                f"{r['bench']:.4f} ({100 * r['bench'] / r['ms']:.1f}%), float32 {f32:.4f} "
                f"({100 * f32 / r['ms']:.1f}%)")

    rows = {}
    for case, _ in blocks:
        rows[case] = times(case)
        torch.cuda.empty_cache()
        for tag, r in zip(("window_attention_tiled", "window_attention_tiled_bwd"), rows[case]):
            print(line(tag if case[2] > WIN_N else tag.replace("_tiled", ""), case, r),
                  flush=True)
    step = {}
    for i, tag in enumerate(("fwd", "bwd")):
        step[tag] = {key: None if any(rows[c][i][key] is None for c, _ in blocks)
                     else sum(nb * rows[c][i][key] for c, nb in blocks)
                     for key in ("ms", "device", "plain", "sdpa", "sdpa_device", "bench")}
        for key in ("tc", "f32"):
            step[tag][key] = sum(nb * rows[c][i]["bound"][key][0] for c, nb in blocks)
        t = step[tag]
        print(f"kernels: window_attention {tag} per SwinV2-B/w16 train step of {SWINB_BATCH} "
              f"(24 calls, 22 tiled): {t['ms']:.4f} ms (device {ms_text(t['device'])}), plain "
              f"{t['plain']:.4f}, sdpa {t['sdpa']:.4f} (device {ms_text(t['sdpa_device'])}); "
              f"bound 3xTF32 {t['tc']:.4f}, the benchmark's {t['bench']:.4f}, float32 "
              f"{t['f32']:.4f}",
              flush=True)

    # the tiled pair where #3 and #4 run: SwinV2-T's stages at its train batch
    pair_ms = {"#3/#4": [0.0, 0.0], "#3L/#4L": [0.0, 0.0]}
    for case, nb in window_blocks(SWIN_TRAIN_BATCH):
        q, k, v, g, bias = window_inputs(gen, case)
        out, lse = window_attention_tiled_fwd(q, k, v, bias, lse=True)
        pairs = {"#3/#4": (lambda: window_attention(q, k, v, bias),
                           lambda: window_attention_bwd(q, k, v, bias, g)),
                 "#3L/#4L": (lambda: window_attention_tiled_fwd(q, k, v, bias),
                             lambda: window_attention_tiled_bwd(q, k, v, bias, out, lse, g))}
        got = {}
        with torch.inference_mode():
            for who, calls in pairs.items():
                got[who] = [device_ms(call) for call in calls]
        for who, ms in got.items():
            for i in range(2):
                pair_ms[who][i] += nb * (math.nan if ms[i] is None else ms[i])
        print(f"kernels: window_attention {case} device fwd / bwd: " + ", ".join(
            f"{who} {ms_text(ms[0])} / {ms_text(ms[1])}" for who, ms in got.items()), flush=True)
    print(f"kernels: window_attention per SwinV2-T train step of {SWIN_TRAIN_BATCH} (12 calls), "
          f"device fwd / bwd: " + ", ".join(f"{who} {ms[0]:.4f} / {ms[1]:.4f} ms"
                                            for who, ms in pair_ms.items()), flush=True)

    def entry(name, source, r, lib, part, per_pass):
        nc = (WIN_D + 15) // 16
        return {"name": name, "route": "cuda", "source": source,
                "replaces": "rgbnomore_tpu/ops/pallas/attention.py:156 (fwd), :170 (bwd) past "
                            "64 tokens",
                "launches": None, "max_err_of_largest": worst[part]["kernel"],
                "max_err_of_largest_vs_plain": worst[part]["vs_plain"], "ms": r["ms"],
                "plain_ms": r["plain"], **product_kernel_entry(r["ms"], r["bound"]),
                "bound_bench_ms": r["bench"], "library_ms": r["sdpa"], "device_ms": r["device"],
                "library_device_ms": r["sdpa_device"],
                "ptxas": {key: val for key, val in PTXAS.get(lib, {}).items()
                          if key.endswith((f"<{nc}>", "<>"))},
                "per_pass": per_pass}

    main = blocks[0][0]  # stage 1, unshifted
    fwd = entry("window_attention_tiled", "rgbnomore_tpu_torch/csrc/window_attention_tiled_fwd.cu",
                rows[main][0], "window_attention_tiled_fwd", "fwd",
                {"train_step": step["fwd"], "swinv2t_train_step_device": pair_ms})
    bwd = entry("window_attention_tiled_bwd",
                "rgbnomore_tpu_torch/csrc/window_attention_tiled_bwd.cu", rows[main][1],
                "window_attention_tiled_bwd", "bwd", {"train_step": step["bwd"]})
    return fwd, bwd


def kernel_attention_vits(report: dict, gen) -> None:
    """#1, #2 (float32) and #1h, #2h (bf16) at ViT-S's shapes: the grouped
    and separate embeddings' 196 tokens and the concatenated one's 294,
    where #1h takes its tiled kernel with the online softmax and #2h its key
    groups.  Each against its plain version (the float32 kernels at the
    Pallas tests' tolerances; bf16 against a float32 reference on the same
    rounded inputs and against the plain version at twice that), then timed
    beside the plain version and SDPA, with its device time and bound; kept
    under each entry's ``vits_shapes``."""
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops.attention import (
        attention_bwd_plain,
        attention_plain,
        fused_attention,
        fused_attention_bwd,
        fused_attention_fwd,
        fused_attention_h16_bwd,
        fused_attention_h16_fwd,
    )

    def rel(a, b) -> float:
        return float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()), 1e-30)

    scale = VITS_SCALE
    for shape in VITS_ATTN_SHAPES:
        b, h, n, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            half = dtype == torch.bfloat16
            fwd, bwd = ((fused_attention_h16_fwd, fused_attention_h16_bwd) if half
                        else (fused_attention_fwd, fused_attention_bwd))
            names = (("fused_attention_bf16", "fused_attention_bwd_bf16") if half
                     else ("fused_attention", "fused_attention_bwd"))
            tag = "bf16" if half else "float32"
            q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                          for _ in range(4))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fused_attention(*leaves, scale)
            out.backward(g)
            with torch.inference_mode():
                plain = attention_plain(q, k, v, scale)
            plain_grads = attention_bwd_plain(q, k, v, g, scale)
            torch.cuda.synchronize()
            fwd_err = float((out.detach() - plain).abs().max())
            bwd_err = max(float((leaf.grad - p).abs().max())
                          for leaf, p in zip(leaves, plain_grads))
            if half:
                ftol, gtol = H16_FWD_TOL["bfloat16"], H16_GRAD_TOL["bfloat16"]
                with torch.inference_mode():
                    ref = attention_plain(q.float(), k.float(), v.float(), scale)
                ref_grads = attention_bwd_plain(q.float(), k.float(), v.float(), g.float(),
                                                scale)
                o = out.detach().float()
                check(torch.allclose(o, ref, **ftol) and torch.allclose(
                    o, plain.float(), atol=2 * ftol["atol"], rtol=2 * ftol["rtol"]),
                      f"fused_attention bf16 {shape}: err against float32 "
                      f"{float((o - ref).abs().max())}, against plain {fwd_err}, beyond {ftol}")
                g_ref = max(rel(leaf.grad, r) for leaf, r in zip(leaves, ref_grads))
                g_pair = max(rel(leaf.grad, p) for leaf, p in zip(leaves, plain_grads))
                check(g_ref <= gtol and g_pair <= 2 * gtol,
                      f"fused_attention_bwd bf16 {shape}: gradient errors of the largest "
                      f"entry {g_ref} against float32, {g_pair} against plain; tolerance {gtol}")
                del ref, ref_grads
            else:
                check(torch.allclose(out.detach(), plain, **ATTN_TOL),
                      f"fused_attention {shape}: max abs err {fwd_err} beyond {ATTN_TOL}")
                check(all(torch.allclose(leaf.grad, p, **GRAD_TOL)
                          for leaf, p in zip(leaves, plain_grads)),
                      f"fused_attention_bwd {shape}: max abs err {bwd_err} beyond {GRAD_TOL}")
            del leaves, out, plain, plain_grads
            with torch.inference_mode():
                rf = {"ms": time_ms(lambda: fwd(q, k, v, scale)),
                      "device_ms": device_ms(lambda: fwd(q, k, v, scale)),
                      "plain_ms": time_ms(lambda: attention_plain(q, k, v, scale), reps=10,
                                          warmup=2),
                      "library_ms": time_ms(
                          lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                      "library_device_ms": device_ms(
                          lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)),
                      "max_abs_err": fwd_err}
            o, lse = fwd(q, k, v, scale, with_lse=True)
            rb = {"ms": time_ms(lambda: bwd(q, k, v, o, lse, g, scale)),
                  "device_ms": device_ms(lambda: bwd(q, k, v, o, lse, g, scale)),
                  "max_abs_err": bwd_err}
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            plain_out = attention_plain(*leaves, scale)
            rb["plain_ms"] = time_ms(
                lambda: torch.autograd.grad(plain_out, leaves, g, retain_graph=True), reps=10,
                warmup=2)
            del plain_out
            sdpa_out = F.scaled_dot_product_attention(*leaves, scale=scale)
            rb["library_ms"] = time_ms(
                lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
            rb["library_device_ms"] = device_ms(
                lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
            if half:
                rf["bound_ms"], rf["bound_by"] = h16_bound_ms(4 * n * n * d * b * h,
                                                              4 * q.numel() * 2)
                rb["bound_ms"], rb["bound_by"] = h16_bound_ms(
                    10 * n * n * d * b * h, 8 * q.numel() * 2 + lse.numel() * 4)
            else:
                rf.update(product_kernel_entry(rf["ms"], attention_bound_ms(b, h, n, d)))
                rb.update(product_kernel_entry(rb["ms"], product_bounds_ms(
                    10 * n * n * d * b * h, (8 * q.numel() + lse.numel()) * 4)))
            for name, r in zip(names, (rf, rb)):
                report[name].setdefault("vits_shapes", {})[str(list(shape))] = r
                print(f"kernels: {name} {tag} {shape} (ViT-S): {r['ms']:.4f} ms (device "
                      f"{ms_text(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, sdpa "
                      f"{r['library_ms']:.4f} ms (device {ms_text(r['library_device_ms'])}); "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max abs err against "
                      f"plain {r['max_abs_err']:.2e}", flush=True)
            del q, k, v, g, o, lse, leaves, sdpa_out
            torch.cuda.empty_cache()


# (tag, rows M, in K, out N) of #6's shapes: ViT-S/16's four block Linears at
# batches 1,024 and 256 (196 tokens), a SwinV2-T stage-1 block's at batch 128
# (4,096 tokens) and its first patch merging; then SwinV2's qkv products,
# stage by stage, at the benchmark cells' batches (SwinV2-T 512, SwinV2-B/w16
# 256), whose weight is in bf16 under the presets' AMP
LINEAR_SHAPES = [
    *((f"vits{b} {name}", b * 196, k, n) for b in (1024, 256)
      for name, k, n in (("qkv", 384, 1152), ("proj", 384, 384), ("mlp1", 384, 1536),
                         ("mlp2", 1536, 384))),
    *((f"swin128 {name}", 128 * 4096, k, n)
      for name, k, n in (("proj", 96, 96), ("mlp1", 96, 384), ("mlp2", 384, 96))),
    ("swin128 reduction", 128 * 1024, 384, 192),
]
SWIN_QKV_SHAPES = [
    *((f"swinv2t s{i + 1} qkv", 512 * tokens, k, 3 * k)
      for i, (tokens, k) in enumerate(((4096, 96), (1024, 192), (256, 384), (64, 768)))),
    *((f"swinv2b s{i + 1} qkv", 256 * tokens, k, 3 * k)
      for i, (tokens, k) in enumerate(((4096, 128), (1024, 256), (256, 512), (64, 1024)))),
]
LINEAR_WRAPPERS = ("linear_tf32x3_fwd", "linear_tf32x3_dgrad", "linear_tf32x3_wgrad")


def kernel_linear(gen) -> list[dict]:
    """#6 (``ops/linear.py``): the forward, input gradient and weight
    gradient at ``LINEAR_SHAPES`` and ``SWIN_QKV_SHAPES``, each against its
    plain version (``mm_tf32x3``) and float64 (max abs errors; the kernel
    within 2e-5 of the largest float64 entry of each), the weight gradient
    and bias gradient repeated bit for bit; each timed beside its 3xTF32
    bound, the plain version and cuBLAS float32 (``library_ms``:
    ``F.linear``, ``dy @ w``, ``dy.T @ x`` with ``dy.sum(0)``).  At
    SwinV2's qkv shapes the weight is rounded to bf16, and the forward and
    input gradient run again with the weight in bf16 (``weight`` "bf16":
    its zero lo half left out, two products a k step): checked as above and
    equal to the float32 weight's three-product launch bit for bit, timed
    beside the two-product bound.  One entry per product, its shapes under
    ``shapes``."""
    import torch
    import torch.nn.functional as F

    from rgbnomore_tpu_torch.ops import linear as L

    entries = {name: {"name": name, "route": "cuda",
                      "source": "rgbnomore_tpu_torch/csrc/linear_tf32x3.cu",
                      "replaces": "none (the JAX package's Dense products run in XLA)",
                      "launches": None, "max_abs_err": 0.0, "shapes": []}
               for name in LINEAR_WRAPPERS}
    for tag, m, k, n in LINEAR_SHAPES + SWIN_QKV_SHAPES:
        qkv = (tag, m, k, n) in SWIN_QKV_SHAPES
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5
        if qkv:  # the presets' qkv weight, rounded to bf16 before the product
            w = w.bfloat16().float()
        b = torch.randn(n, generator=gen, device="cuda")
        dy = torch.randn(m, n, generator=gen, device="cuda")
        wt = w.T.contiguous()
        # (wrapper, weight, kernel, plain, library, float64)
        runs = [
            ("linear_tf32x3_fwd", "float32", lambda: L.linear_fwd(x, w, b),
             lambda: L.linear_plain(x, w, b), lambda: F.linear(x, w, b),
             lambda: F.linear(x.double(), w.double(), b.double())),
            ("linear_tf32x3_dgrad", "float32", lambda: L.linear_dgrad(dy, w),
             lambda: L.mm_tf32x3(dy, wt), lambda: dy @ w, lambda: dy.double() @ w.double()),
            ("linear_tf32x3_wgrad", "float32", lambda: L.linear_wgrad(dy, x),
             lambda: (L.mm_tf32x3(dy.T.contiguous(), x.T.contiguous()), dy.sum(0)),
             lambda: (dy.T @ x, dy.sum(0)),
             lambda: (dy.double().T @ x.double(), dy.double().sum(0))),
        ]
        if qkv:
            wh = w.bfloat16()
            runs += [(name, "bf16", kernel, plain, library, exact)
                     for (name, _, _, plain, library, exact), kernel in zip(
                         runs[:2], (lambda: L.linear_fwd(x, wh, b),
                                    lambda: L.linear_dgrad(dy, wh)))]
        flop = 2 * m * n * k
        three = {}  # the float32 weight's forward and input gradient
        for name, weight, kernel, plain, library, exact in runs:
            got, want, ref = kernel(), plain(), exact()
            torch.cuda.synchronize()
            got, want, ref = ((t,) if torch.is_tensor(t) else t for t in (got, want, ref))
            err = max(float((g - p).abs().max()) for g, p in zip(got, want))
            gap = max(float((g - p).abs().max() / r.abs().max())
                      for g, p, r in zip(got, want, ref))
            rel = max(float((g.double() - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref))
            plain_rel = max(float((p.double() - r).abs().max() / r.abs().max())
                            for p, r in zip(want, ref))
            label = f"{name} {tag} ({weight} weight)"
            check(rel < 2e-5, f"{label}: {rel:.3e} of the largest float64 entry")
            check(gap < 2e-5, f"{label}: {gap:.3e} of the largest float64 entry from plain")
            if name == "linear_tf32x3_wgrad":
                again = kernel()
                check(all(torch.equal(g, a) for g, a in zip(got, again)),
                      f"{label}: the weight gradient differs between two runs")
            elif weight == "bf16":
                check(torch.equal(got[0], three.pop(name)),
                      f"{label}: differs from the float32 weight's three products")
            elif qkv:
                three[name] = got[0]
            del got, want, ref
            reps = 10 if m > 100_000 else 30
            ms = time_ms(kernel, reps=reps)
            plain_ms = time_ms(plain, reps=5, warmup=1)
            library_ms = time_ms(library, reps=reps)
            # X or dY read and the output written once (the weight is small)
            nbytes = 4 * (m * k + m * n + n * k)
            products = 2 if weight == "bf16" else 3
            bounds = product_kernel_entry(ms, product_bounds_ms(flop, nbytes, products))
            row = {"tag": tag, "m": m, "k": k, "n": n, "weight": weight, "max_abs_err": err,
                   "plain_gap": gap, "rel_err": rel, "plain_rel_err": plain_rel, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, **bounds}
            entries[name]["shapes"].append(row)
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
            print(f"kernels: {name} {tag} (M {m}, K {k}, N {n}, {weight} weight) {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, cuBLAS float32 {library_ms:.4f} ms; bound "
                  f"{products}xTF32 {bounds['bound_tc_ms']:.4f} ms ({bounds['bound_by']}, "
                  f"{100 * bounds['bound_share']:.1f}%); max abs err against plain {err:.3e}, "
                  f"of the largest float64 entry {rel:.3e} (plain {plain_rel:.3e})"
                  + ("; equal to the float32 weight's bit for bit" if weight == "bf16" else ""),
                  flush=True)
        del x, w, b, dy, wt
        torch.cuda.empty_cache()
    for entry in entries.values():  # the headline: ViT-S at batch 1,024, mlp1
        head = next(r for r in entry["shapes"] if r["tag"] == "vits1024 mlp1")
        entry.update({key: head[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "bound_share")})
        entry["ptxas"] = PTXAS.get("linear_tf32x3", {})
        entry["wgmma_notes"] = WGMMA_NOTES.get("linear_tf32x3", [])
    return list(entries.values())


def phase_kernels() -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    report = {"fused_attention": kernel_attention_fwd(gen)}
    report["fused_attention_bwd"] = kernel_attention_bwd(gen)
    for entry in kernel_attention_h16(gen):
        report[entry["name"]] = entry
    report["fused_flip_aug_range"] = kernel_augpipe()
    report["augpipe_wire"] = kernel_augpipe_wire()
    report["window_attention"], report["window_attention_bwd"] = kernel_window_attention(gen)
    report["window_attention_tiled"], report["window_attention_tiled_bwd"] = (
        kernel_window_attention_tiled(gen))
    kernel_attention_vits(report, gen)
    for entry in kernel_linear(gen):
        report[entry["name"]] = entry
    return report


# the input stage's wrappers: the kernel's dense entry and its wire reader's
# train and eval entries
AUGPIPE_WRAPPERS = ("fused_flip_aug_range", "wire_flip_aug_range", "wire_to_range")
# the port's launch counters (``rgbnm.launch.<counter>`` in ``utils/profiling.
# totals()``) by the names this script reports them under
LAUNCH_COUNTERS = {"fused_attention": "fused_attention_fwd",
                   "fused_attention_bwd": "fused_attention_bwd",
                   "fused_attention_h16": "fused_attention_h16_fwd",
                   "fused_attention_h16_bwd": "fused_attention_h16_bwd",
                   "window_attention": "window_attention_fwd",
                   "window_attention_bwd": "window_attention_bwd",
                   "window_attention_tiled": "window_attention_tiled_fwd",
                   "window_attention_tiled_bwd": "window_attention_tiled_bwd",
                   **{name: name for name in AUGPIPE_WRAPPERS},
                   **{name: name for name in LINEAR_WRAPPERS}}


@contextlib.contextmanager
def plain_unpacks():
    """Counts the calls of the plain mask16 unpack (``augment.pipeline.
    unpack_coefficients_mask``) made while the block runs: a path that the
    wire reader carries makes none."""
    from rgbnomore_tpu_torch.augment import pipeline

    unpack, calls = pipeline.unpack_coefficients_mask, []

    def counted(*args, **kw):
        calls.append(1)
        return unpack(*args, **kw)

    pipeline.unpack_coefficients_mask = counted
    try:
        yield calls
    finally:
        pipeline.unpack_coefficients_mask = unpack


def check_no_input_kernel(report: dict, path: str, launches: dict) -> None:
    """A path whose input stage is tensor code (the RGB domain, a DCT op
    list outside the kernel's set): no launch of #5's dense entry nor of its
    wire reader; the path's zero is kept per path."""
    got = {name: launches[name] for name in AUGPIPE_WRAPPERS}
    check(not any(got.values()), f"{path}: input stage launches {got}, want none")
    for name, wrappers in (("fused_flip_aug_range", ("fused_flip_aug_range",)),
                           ("augpipe_wire", ("wire_flip_aug_range", "wire_to_range"))):
        by_path = report[name].setdefault("launches_by_path", {})
        by_path[path] = sum(launches[w] for w in wrappers)
        report[name]["launches"] = sum(by_path.values())


def check_input_stage(report: dict, path: str, launches: dict, unpacks: int, *,
                      eval_batches: int = 0, train_steps: int = 0,
                      dense_steps: int | None = None) -> None:
    """On the cropped wire: one wire launch per eval batch and per train
    step, no launch of the dense entry and no plain unpack on ``path``.  On
    the full-canvas transfers (``dense_steps`` given): one launch of the
    dense entry per train step (``dense_steps``) and none of the wire
    reader; the rows are unpacked, dequantized and cropped by tensor code
    first.  The #5 entries' launches are kept per path, and their
    ``launches`` is the sum over the paths."""
    if dense_steps is None:
        want = {"fused_flip_aug_range": 0, "wire_flip_aug_range": train_steps,
                "wire_to_range": eval_batches}
    else:
        want, unpacks = {"fused_flip_aug_range": dense_steps, "wire_flip_aug_range": 0,
                         "wire_to_range": 0}, 0
    got = {name: launches[name] for name in want}
    check(got == want and unpacks == 0,
          f"{path}: input stage launches {got} and {unpacks} plain unpacks; want {want} and none")
    for name, wrappers in (("fused_flip_aug_range", ("fused_flip_aug_range",)),
                           ("augpipe_wire", ("wire_flip_aug_range", "wire_to_range"))):
        by_path = report[name].setdefault("launches_by_path", {})
        by_path[path] = sum(got[w] for w in wrappers)
        report[name]["launches"] = sum(by_path.values())


def phase_slice(report: dict):
    import copy

    import torch

    from rgbnomore_tpu_torch.ops.attention import attention_plain, fused_attention
    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=SEED)
    trainer = Trainer(cfg, device="cuda")  # full-width ViT-Ti, seeded init
    check(trainer.packed_k_eval == K_EVAL and trainer.eval_fmt == "mask16",
          f"eval wire is K={trainer.packed_k_eval} {trainer.eval_fmt}")
    t0 = time.perf_counter()
    rows = vit_rows(np.random.default_rng(SEED), N_IMAGES, K_EVAL)
    print(f"slice: wrote {N_IMAGES} rows of {rows.shape[1]} B in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # one attention launch per encoder block
    eval_path(report, "vit eval", trainer, {"fused_attention": cfg.model.depth}, rows)

    model = trainer.model
    cpu_model = copy.deepcopy(model).cpu()
    batch = {"packed": rows[:BATCH]}
    packed = trainer.put_batch(batch)["packed"]
    with torch.inference_mode():
        yd, cd, _, _ = trainer.eval_pipe(packed)
        # the pipeline on the card is bit-exact against the CPU
        yc, cc, _, _ = trainer.eval_pipe(torch.from_numpy(batch["packed"]))
        check(torch.equal(yd.cpu(), yc) and torch.equal(cd.cpu(), cc),
              "pipeline on the card differs from the CPU")
        got = model(yd, cd)
        mhas = [getattr(model, f"encoder_{i}").mha for i in range(model.depth)]
        for m in mhas:
            m.attention = attention_plain
        want = model(yd, cd)
        for m in mhas:
            m.attention = fused_attention
        cpu_logits = cpu_model(yc[:8], cc[:8])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **LOGIT_TOL),
          f"kernel-path logits vs plain path: max abs err {err} beyond {LOGIT_TOL}")
    # argmax agrees except where the plain path's top two are within tolerance
    a_got, a_want = got.argmax(-1), want.argmax(-1)
    rows_off = (a_got != a_want).nonzero().flatten()
    gaps = (want[rows_off, a_want[rows_off]] - want[rows_off, a_got[rows_off]]).abs()
    check(bool((gaps <= LOGIT_TOL["atol"]).all()),
          f"argmax differs on {rows_off.tolist()} with logit gaps {gaps.tolist()}")
    cpu_err = float((got[:8].cpu() - cpu_logits).abs().max())
    check(torch.allclose(got[:8].cpu(), cpu_logits, **LOGIT_TOL),
          f"card logits vs CPU: max abs err {cpu_err} beyond {LOGIT_TOL}")
    check(bool(torch.isfinite(got).all()) and got.shape == (BATCH, cfg.model.classes),
          f"logits {tuple(got.shape)} not finite or not (batch, classes)")
    print(f"slice: logits kernel vs plain max abs err {err:.3e} "
          f"({len(rows_off)} argmax ties), card vs CPU {cpu_err:.3e}", flush=True)
    return trainer, batch


def phase_breakdown(trainer, batch: dict, tag: str = "breakdown") -> None:
    """Where one eval step's time goes on the card: CUDA-event medians of
    each stage, and the device time of one forward by kernel, from
    ``torch.profiler`` (reported as not measured where it sees none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rgbnomore_tpu_torch.train.steps import eval_sums

    model = trainer.model.eval()
    n = batch["packed"].shape[0]
    with torch.inference_mode():
        upload_ms = time_ms(lambda: trainer.put_batch(batch), reps=10, warmup=2)
        packed = trainer.put_batch(batch)["packed"]
        pipe_ms = time_ms(lambda: trainer.eval_pipe(packed), reps=10, warmup=2)
        y, c, labels, weights = trainer.eval_pipe(packed)
        fwd_ms = time_ms(lambda: model(y, c), reps=20, warmup=3)
        logits = model(y, c)
        sums_ms = time_ms(lambda: eval_sums(logits, labels, weights), reps=10, warmup=2)
        print(f"{tag}: per batch of {n}: upload {upload_ms:.3f} ms, pipeline {pipe_ms:.3f} ms, "
              f"forward {fwd_ms:.3f} ms ({n / fwd_ms * 1e3:.1f} img/s), sums {sums_ms:.3f} ms",
              flush=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(y, c)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    if not total:
        print(f"{tag}: torch.profiler saw no device time, kernels not measured")
        return
    print(f"{tag}: forward device time {total / 1e3:.3f} ms in {len(events)} kernels")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"{tag}: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / total:5.1f}% x{e.count:<4d} {e.key[:80]}")


def phase_train(report: dict):
    """The train step at full width: launch counts, finite losses and the
    loss falling over 20 steps on one repeated batch (warmup 1, lr 3e-3).
    256 images with labels ``arange % 1000`` leave 744 classes unused, whose
    logits alone make the loss fall from ln 1000."""
    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=SEED, epochs=1,
                          warmup_steps=1, lr=3e-3)
    trainer = Trainer(cfg, device="cuda")
    pipe = trainer.train_pipe
    check(pipe.k == K_TRAIN and pipe.fmt == "mask16" and pipe.num_ops == 2
          and pipe.magnitude == 3 and pipe.ops_list == list(cfg.train.auglist),
          f"train wire K={pipe.k} {pipe.fmt}, {pipe.num_ops} ops at {pipe.magnitude}")
    trainer.create_state(steps_per_epoch=TRAIN_STEPS + 1)
    rows = vit_rows(np.random.default_rng(SEED + 1), BATCH, K_TRAIN)
    packed = trainer.put_batch({"packed": rows})["packed"]
    launches = train_path(report, "vit train", trainer, packed, TRAIN_STEPS,
                          {"fused_attention": 12, "fused_attention_bwd": 12})
    for name in ("fused_attention", "fused_attention_bwd"):
        report[name]["launches"] = launches[name]
    return trainer, packed, rows


def phase_train_vs_cpu(rows: np.ndarray) -> None:
    """One ViT-Ti step's loss and gradients on the card (kernels) against
    the CPU (plain versions), from the same seeded parameters, rows and
    draws, at full width on 8 images."""
    from rgbnomore_tpu_torch.train.config import generate_config

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=CPU_GRAD_BATCH, seed=SEED)
    step_card_vs_cpu("train", cfg, rows[:CPU_GRAD_BATCH])


def step_card_vs_cpu(tag: str, cfg, rows: np.ndarray, prepare=None, loss_rtol=LOSS_RTOL,
                     grad_rtol=GRAD_RTOL, stage_from_cpu: bool = False) -> None:
    """One train step's loss and gradients on the card (kernels) against the
    CPU (plain versions), from the same seeded parameters (then ``prepare``
    on each model), rows and draws.  Tolerance: float32 sums in other orders
    (cuBLAS against the CPU's GEMMs, the kernels' tiles against einsum)
    through every block and back; a parameter is held to GRAD_RTOL of the
    largest gradient entry in the model, so an entry whose gradient is zero
    in exact arithmetic and rounding noise here (the key third of each ViT
    qkv bias) is held to that noise's scale.  Mixed precision passes its
    own tolerances.  ``stage_from_cpu``: the card's step takes the CPU
    input stage's output (moved to the card), for an input stage in tensor
    code whose rounding-level differences may cross a threshold of a later
    op (Posterize, Solarize, a clamp); its own card-vs-CPU check is apart."""
    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    n = rows.shape[0]
    card, cpu = Trainer(cfg, device="cuda"), Trainer(cfg, device="cpu")
    if prepare is not None:
        prepare(card.model)
        prepare(cpu.model)
    draws = cpu.draw(n)
    if stage_from_cpu:
        with torch.no_grad():
            stage = cpu.train_pipe(torch.from_numpy(rows), draws.flip, draws.policy, draws.crop)
        card.train_pipe = lambda *args: tuple(t.to(card.device) for t in stage)
    loss_card = float(card.compute_grads(card.put_batch({"packed": rows})["packed"], draws))
    loss_cpu = float(cpu.compute_grads(torch.from_numpy(rows), draws))
    grads_card = {k: p.grad.cpu() for k, p in card.model.named_parameters()}
    grads_cpu = {k: p.grad for k, p in cpu.model.named_parameters()}
    norm_card = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_card.values()])))
    norm_cpu = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads_cpu.values()])))
    gmax = max(float(g.abs().max()) for g in grads_cpu.values())
    worst = max(((float((grads_card[k] - g).abs().max()) / gmax, k)
                 for k, g in grads_cpu.items()))
    rel = {k: float((grads_card[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
           for k, g in grads_cpu.items()}
    worst_own = max((v, k) for k, v in rel.items() if not k.endswith("qkv.bias"))
    print(f"{tag}: card vs CPU at {n} images: loss {loss_card:.7f} vs "
          f"{loss_cpu:.7f}, grad norm {norm_card:.7f} vs {norm_cpu:.7f}, worst gradient "
          f"err {worst[0]:.3e} of the largest entry ({worst[1]}), worst relative to its own "
          f"largest entry {worst_own[0]:.3e} ({worst_own[1]})", flush=True)
    check(abs(loss_card - loss_cpu) <= loss_rtol * abs(loss_cpu),
          f"{tag}: loss card {loss_card} vs CPU {loss_cpu} beyond rtol {loss_rtol}")
    check(abs(norm_card - norm_cpu) <= grad_rtol * norm_cpu,
          f"{tag}: grad norm card {norm_card} vs CPU {norm_cpu} beyond rtol {grad_rtol}")
    check(worst[0] <= grad_rtol,
          f"{tag}: gradient of {worst[1]}: err {worst[0]} of the largest entry, beyond "
          f"{grad_rtol}")


def phase_train_breakdown(trainer, packed, tag: str = "breakdown") -> None:
    """The device time of one ``Trainer.train_step`` by kernel, from
    ``torch.profiler``.  The step's split by stage is the port's own spans'
    (``python3 tools/port_span_gaps.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(packed)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    dev_total = sum(e.self_device_time_total for e in events)
    if not dev_total:
        print(f"{tag}: torch.profiler saw no device time, kernels not measured")
        return
    print(f"{tag}: train step device time {dev_total / 1e3:.3f} ms in {len(events)} kernels")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"{tag}: {e.self_device_time_total / 1e3:8.3f} ms "
              f"{100 * e.self_device_time_total / dev_total:5.1f}% x{e.count:<4d} {e.key[:80]}")


def swin_config(batch: int, **kw):
    """SwinV2-T as the repo presets it (``generate_config("swinv2", "dct")``:
    embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24), window 8, drop path
    0.2, 32x32 blocks, 1000 classes), in float32 (``cfg.train.amp = False``):
    the float32 phases hold the window kernels to float32 references; the
    preset's own bf16 AMP runs in ``phase_swin_amp``."""
    from rgbnomore_tpu_torch.train.config import generate_config

    cfg = generate_config("swinv2", "dct", batchsize=batch, seed=SEED, **kw)
    cfg.train.amp = False
    return cfg


def perturb_norms(model, seed: int = SEED) -> None:
    """Set the scales of every SwinV2 block's norm1 and norm2 to U(0.5, 1.5)
    and their biases to N(0, 0.1^2), from a seeded generator: at their init
    of 0 every block is the identity and no attention reaches the logits."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith((".norm1", ".norm2")):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.1)


def phase_swin_eval(report: dict):
    """512 images of 32x32 blocks on the K=48 wire through the SwinV2-T
    ``Trainer.evaluate`` (norms perturbed), 12 window-attention launches per
    batch; logits of the kernel path against the plain path, and the card
    against the CPU at 4 images."""
    import copy

    import torch

    from rgbnomore_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_plain,
    )
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = swin_config(SWIN_EVAL_BATCH)
    trainer = Trainer(cfg, device="cuda")
    perturb_norms(trainer.model)
    check(trainer.packed_k_eval == K_EVAL and trainer.eval_fmt == "mask16",
          f"swin eval wire is K={trainer.packed_k_eval} {trainer.eval_fmt}")
    rows = vit_rows(np.random.default_rng(SEED + 2), N_IMAGES, K_EVAL, grid=SWIN_GRID)
    eval_path(report, "swin eval", trainer, {"window_attention": 12}, rows)

    model = trainer.model
    cpu_model = copy.deepcopy(model).cpu()
    attns = [b.attn for b in model.blocks()]
    batch = {"packed": rows[:SWIN_EVAL_BATCH]}
    with torch.inference_mode():
        yd, cd, _, _ = trainer.eval_pipe(trainer.put_batch(batch)["packed"])
        got = model(yd, cd)
        for a in attns:
            a.attention = window_attention_plain
        want = model(yd, cd)
        for a in attns:
            a.attention = window_attention
        cpu_logits = cpu_model(yd[:SWIN_CPU_BATCH].cpu(), cd[:SWIN_CPU_BATCH].cpu())
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **LOGIT_TOL),
          f"swin logits kernel vs plain: max abs err {err} beyond {LOGIT_TOL}")
    cpu_err = float((got[:SWIN_CPU_BATCH].cpu() - cpu_logits).abs().max())
    check(torch.allclose(got[:SWIN_CPU_BATCH].cpu(), cpu_logits, **LOGIT_TOL),
          f"swin logits card vs CPU: max abs err {cpu_err} beyond {LOGIT_TOL}")
    check(bool(torch.isfinite(got).all()) and got.shape == (SWIN_EVAL_BATCH, cfg.model.classes),
          f"swin logits {tuple(got.shape)} not finite or not (batch, classes)")
    print(f"swin eval: logits kernel vs plain max abs err {err:.3e} (logits up to "
          f"{float(want.abs().max()):.3f}), card vs CPU {cpu_err:.3e}", flush=True)
    return trainer, batch


def cell_image(rng: np.random.Generator, size: int = 256):
    """RGB uint8 (3, size, size) of constant 16x16 cells, and each cell's
    colour (size/16, size/16, 3): every 8x8 luma block and, after 4:2:0
    subsampling, every chroma block is constant, so a JPEG of it at quality
    100 has no AC terms and DCs of 8 * (level - 128)."""
    cells = rng.integers(0, 256, (size // 16, size // 16, 3)).astype(np.uint8)
    img = np.repeat(np.repeat(cells, 16, axis=0), 16, axis=1)
    return np.ascontiguousarray(img.transpose(2, 0, 1)), cells.astype(np.float64)


def phase_codec(trainer) -> None:
    """JPEG files through the host codec: 256 files written by the port's
    codec (16 of constant colour cells at quality 100, 240 photo-like ones
    of 500x375 or 375x500 at quality 90), read by ``DctCroppedLoader``
    (the SwinV2 eval: whole-image resize to 32x32 blocks, K=48) at 1, 2, 4
    and 8 decode threads.  The cell images' DC planes are held to JFIF's
    colour conversion within one level and their AC masks to empty; one
    batch then runs through the SwinV2 eval."""
    from rgbnomore_tpu_torch import codec
    from rgbnomore_tpu_torch.data.index import load_index
    from rgbnomore_tpu_torch.data.loader import DctCroppedLoader, row_views
    from rgbnomore_tpu_torch.ops.cuda_build import BUILD_DIR

    rng = np.random.default_rng(SEED + 3)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lines, cells = ["Filepath,Label"], []
        t0 = time.perf_counter()
        for i in range(N_CODEC):
            path = f"{tmp}/img{i:03d}.jpg"
            if i < N_CELL_IMAGES:
                img, colours = cell_image(rng)
                cells.append(colours)
                codec.write_tensor(path, img, quality=100)
            else:
                h, w = (375, 500) if i % 2 else (500, 375)
                ys, xs = np.mgrid[0:h, 0:w]
                f = 0.01 + 0.05 * rng.random(3)
                img = np.stack([(128 + 90 * np.sin(ys * f[ch] + ch) * np.cos(xs * f[2 - ch])
                                 + 12 * rng.standard_normal((h, w))).clip(0, 255)
                                for ch in range(3)]).astype(np.uint8)
                codec.write_tensor(path, img, quality=90)
            lines.append(f"{path},{i % 1000}")
        with open(f"{tmp}/index.csv", "w") as fh:
            fh.write("\n".join(lines) + "\n")
        print(f"codec: wrote {N_CODEC} JPEGs in {time.perf_counter() - t0:.1f} s", flush=True)
        ds = load_index(f"{tmp}/index.csv")
        rates = {}
        for threads in (1, 2, 4, 8):
            ldr = DctCroppedLoader(ds, SWIN_EVAL_BATCH, target=SWIN_GRID, k=K_EVAL,
                                   mode="full", num_threads=threads)
            t0 = time.perf_counter()
            batches = list(ldr)
            rates[threads] = N_CODEC / (time.perf_counter() - t0)
        print("codec: host decode + full resize + pack to 32x32 blocks, K=48: " + ", ".join(
            f"{t} threads {r:.1f} img/s" for t, r in rates.items()), flush=True)
    check(len(batches) == 1 and batches[0]["weights"].sum() == N_CODEC,
          f"loader gave {len(batches)} batches")
    rows = batches[0]["packed"]
    worst = 0.0
    for i, colours in enumerate(cells):
        v = row_views(rows[i], ldr.layout)
        r, g, b = colours[..., 0], colours[..., 1], colours[..., 2]
        luma = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
        want_y = np.repeat(np.repeat(luma, 2, axis=0), 2, axis=1)  # 2x2 blocks per cell
        got = [v["dy"][0], v["dc"][0], v["dc"][1]]
        for plane, want in zip(got, (want_y, cb, cr)):
            err = float(np.abs(plane / 8.0 + 128.0 - want).max())
            worst = max(worst, err)
            check(err <= 1.0, f"codec: image {i} DC off by {err} levels from the closed form")
        check(not v["iy"].any() and not v["ic"].any(),
              f"codec: image {i} of constant blocks kept AC terms")
    print(f"codec: {len(cells)} cell images: DCs within {worst:.3f} levels of the closed "
          f"form, no AC terms", flush=True)
    res = trainer.evaluate(batches)
    check(res["count"] == N_CODEC and math.isfinite(res["loss"]),
          f"codec: swin eval of the decoded batch gave {res}")
    print(f"codec: one batch of {N_CODEC} decoded JPEGs through the SwinV2-T eval: {res}",
          flush=True)


def phase_swin_train(report: dict):
    """The SwinV2-T train step at batch 128 with drop path 0.2: launch counts
    (1 augmentation, 12 window forward, 24 window backward: 12 per-chunk
    passes and 12 reductions), finite losses falling over 1 + 10 steps on one
    repeated batch (warmup 1, lr 3e-3), and the peak device memory."""
    from rgbnomore_tpu_torch.train.config import AUGLIST_DCT
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = swin_config(SWIN_TRAIN_BATCH, epochs=1, warmup_steps=1, lr=3e-3)
    trainer = Trainer(cfg, device="cuda")
    pipe = trainer.train_pipe
    check(pipe.k == K_TRAIN and pipe.fmt == "mask16" and pipe.num_ops == 2
          and pipe.magnitude == 3 and pipe.ops_list == list(AUGLIST_DCT)
          and pipe.target == SWIN_GRID,
          f"swin train wire K={pipe.k} {pipe.fmt}, {pipe.num_ops} ops at {pipe.magnitude}")
    check(abs(trainer.model.drop_path_rates[-1] - 0.2) < 1e-9, "swin drop path is not 0.2")
    trainer.create_state(steps_per_epoch=SWIN_TRAIN_STEPS + 1)
    rows = vit_rows(np.random.default_rng(SEED + 4), SWIN_TRAIN_BATCH, K_TRAIN, grid=SWIN_GRID)
    packed = trainer.put_batch({"packed": rows})["packed"]
    launches = train_path(report, "swin train", trainer, packed, SWIN_TRAIN_STEPS,
                          {"window_attention": 12, "window_attention_bwd": 24})
    for name in ("window_attention", "window_attention_bwd"):
        report[name]["launches"] = launches[name]
    return trainer, packed, rows


def reset_launches() -> None:
    """The port's spans and counters, the launch counts among them, to 0."""
    from rgbnomore_tpu_torch.utils import profiling

    profiling.reset()


def all_launches() -> dict:
    """Every kernel wrapper's launch count (``LAUNCH_COUNTERS``)."""
    return {name: counted_launches(c) for name, c in LAUNCH_COUNTERS.items()}


def check_launches(tag: str, got: dict, want: dict) -> None:
    """``want`` gives the launches of some kernels; every other attention
    and window kernel must have none (``fused_flip_aug_range`` and the wire
    reader are ``check_input_stage``'s)."""
    skip = set(AUGPIPE_WRAPPERS) | set(LINEAR_WRAPPERS)
    full = {name: want.get(name, 0) for name in got if name not in skip}
    seen = {name: got[name] for name in full}
    check(seen == full, f"{tag}: launches {seen}, want {full}")


def check_swin_linear(tag: str, launches: dict, want: tuple) -> None:
    """SwinV2 under bf16 AMP: its float32 qkv products (every block's but the
    first) on #6, ``want`` = (forward, input-gradient, weight-gradient)
    launches and the bf16 products on ``F.linear`` (every bf16 ``Linear``
    and the first block's qkv), counted in ``rgbnm.linear.library``."""
    from rgbnomore_tpu_torch.utils import profiling

    got = {w: launches[w] for w in LINEAR_WRAPPERS}
    got["library"] = profiling.totals()["counters"].get("rgbnm.linear.library", 0)
    check(got == dict(zip((*LINEAR_WRAPPERS, "library"), want)),
          f"{tag}: #6 and library products {got}, want {want}")


def vitb_config(**kw):
    """ViT-B/16 as the repo presets it (``generate_config("vitb", "dct")``:
    bf16 AMP, 12 x 768, 12 heads of 64, patch 16 over 28x28 blocks = 196
    tokens, 1000 classes, lr 1e-3, batch 512), its batch per device for one
    card (``update_runtime``); warmup 1 over one epoch, so that 11 steps
    move the loss (the preset warms up over 10,000 steps)."""
    import torch

    from rgbnomore_tpu_torch.train.config import generate_config, update_runtime

    cfg = generate_config("vitb", "dct", seed=SEED, epochs=1, warmup_steps=1, **kw)
    m = cfg.model
    check(cfg.train.amp and m.amp_dtype == "bf16" and m.embed_size == 768 and m.depth == 12
          and m.heads == 12 and m.head_size == 64 and m.dct_blocks == GRID
          and m.classes == 1000 and cfg.train.lr == 1e-3
          and cfg.train.batch_size == kw.get("batchsize", 512),
          f"the vitb preset changed: {cfg}")
    return update_runtime(cfg, torch.cuda.device_count())


def phase_vitb(report: dict):
    """ViT-B/16 under its bf16 preset at full width: 1 + 10 train steps at
    the preset's batch of 512 on the K=16 wire, 12 bf16 attention forward
    and 12 backward launches per step and none of the float32 kernels,
    finite falling losses, the peak memory; then 512 images on the K=48
    wire through ``Trainer.evaluate`` (12 bf16 forward launches per batch of
    256)."""
    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = vitb_config()
    batch = cfg.train.batch_per_device
    trainer = Trainer(cfg, device="cuda")
    check(trainer.compute_dtype == torch.bfloat16, f"vitb computes in {trainer.compute_dtype}")
    trainer.create_state(steps_per_epoch=VITB_TRAIN_STEPS + 1)
    check(trainer.loss_scale is None, "bf16 made loss scaler state")
    rng = np.random.default_rng(SEED + 6)
    rows = vit_rows(rng, batch, K_TRAIN, classes=cfg.model.classes)
    packed = trainer.put_batch({"packed": rows})["packed"]
    launches = train_path(report, "vitb train", trainer, packed, VITB_TRAIN_STEPS,
                          {"fused_attention_h16": 12, "fused_attention_h16_bwd": 12})
    report["fused_attention_bf16"]["launches"] = launches["fused_attention_h16"]
    report["fused_attention_bwd_bf16"]["launches"] = launches["fused_attention_h16_bwd"]
    eval_path(report, "vitb eval", trainer, {"fused_attention_h16": 12},
              vit_rows(rng, N_IMAGES, K_EVAL))
    return trainer, packed, rows


def phase_swin_amp(report: dict):
    """SwinV2-T under its own preset, bf16 AMP, at train batch 128: 1 + 10
    steps with drop path, 12 window forward and 24 window backward launches
    per step (the window kernels stay float32 under AMP, as the JAX
    package's call site casts around them) and no ViT attention launch,
    the 11 float32 qkv products a step on #6 (forward, input and weight
    gradients) and 41 bf16 products a forward on ``F.linear``, finite
    falling losses, the peak memory; 512 images through ``Trainer.evaluate``
    in batches of 256 (12 window launches and 11 #6 forwards each)."""
    import torch

    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = generate_config("swinv2", "dct", batchsize=SWIN_TRAIN_BATCH, seed=SEED, epochs=1,
                          warmup_steps=1, lr=3e-3)
    check(cfg.train.amp and cfg.model.amp_dtype == "bf16", "the swinv2 preset is not bf16 AMP")
    trainer = Trainer(cfg, device="cuda")
    check(trainer.compute_dtype == torch.bfloat16, f"swinv2 computes in {trainer.compute_dtype}")
    trainer.create_state(steps_per_epoch=SWIN_TRAIN_STEPS + 1)
    rng = np.random.default_rng(SEED + 7)
    packed = trainer.put_batch({"packed": vit_rows(rng, SWIN_TRAIN_BATCH, K_TRAIN,
                                                   grid=SWIN_GRID)})["packed"]
    # 11 float32 qkv products a step; 40 bf16 Linears and the first qkv a forward
    train_path(report, "swin amp train", trainer, packed, SWIN_TRAIN_STEPS,
               {"window_attention": 12, "window_attention_bwd": 24}, linear=(11, 11, 11, 41))
    eval_path(report, "swin amp eval", trainer, {"window_attention": 12},
              vit_rows(rng, N_IMAGES, K_EVAL, grid=SWIN_GRID), linear=(11, 0, 0, 41))
    return trainer, packed


def phase_fp16(report: dict) -> None:
    """ViT-Ti with ``ampdtype fp16`` and the hand-written loss scaler, batch
    256: 1 + 10 steps with 12 fp16 attention forward and 12 backward
    launches each, the scale unchanged at 2^15 and 11 good steps (and the
    share of heads whose dO the backward's range guard divides); then a
    step whose gradients are non-finite
    on purpose (an infinite weight): the parameters, the AdamW moments and
    AdamW's count stay bit-identical, the schedule's count advances, the
    scale backs off to x0.625; with the weight restored the next step
    updates again."""
    import torch

    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer
    from rgbnomore_tpu_torch.train.scaler import BACKOFF, INIT_SCALE

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=SEED, epochs=1,
                          warmup_steps=1, lr=3e-3, amp=True, ampdtype="fp16")
    trainer = Trainer(cfg, device="cuda")
    check(trainer.compute_dtype == torch.float16, f"fp16 computes in {trainer.compute_dtype}")
    trainer.create_state(steps_per_epoch=FP16_STEPS + 3)
    scaler = trainer.loss_scale
    check(scaler is not None and float(scaler.scale) == INIT_SCALE
          and int(scaler.good_steps) == 0, "fp16 loss scaler not at 2^15")
    rng = np.random.default_rng(SEED + 8)
    rows = vit_rows(rng, BATCH, K_TRAIN)
    packed = trainer.put_batch({"packed": rows})["packed"]

    losses = [trainer.train_step(packed)]  # warm-up
    torch.cuda.synchronize()
    # the heads whose dO the backward kernel divides (fp16's range guard:
    # 2 max |dO_i| max |V_j| >= 2^15), read from each backward's inputs
    from rgbnomore_tpu_torch.ops.attention import _FusedAttention

    kernel_backward, bounds = _FusedAttention.backward, []

    def watched_backward(ctx, dout):
        v = ctx.saved_tensors[2]
        bounds.append(2 * dout.float().norm(dim=-1).amax(-1) * v.float().norm(dim=-1).amax(-1))
        return kernel_backward(ctx, dout)

    _FusedAttention.backward = staticmethod(watched_backward)
    reset_launches()
    try:
        for _ in range(FP16_STEPS):
            losses.append(trainer.train_step(packed))
        torch.cuda.synchronize()
    finally:
        _FusedAttention.backward = staticmethod(kernel_backward)
    launches = all_launches()
    bound = torch.stack(bounds)
    guarded = f"{int((bound >= 2.0**15).sum())} of {bound.numel()}"
    check_launches("fp16 train", launches, {"fused_attention_h16": 12 * FP16_STEPS,
                                            "fused_attention_h16_bwd": 12 * FP16_STEPS})
    report["fused_attention_fp16"]["launches"] = launches["fused_attention_h16"]
    report["fused_attention_bwd_fp16"]["launches"] = launches["fused_attention_h16_bwd"]
    losses = [float(v) for v in losses]
    scale, good = float(trainer.loss_scale.scale), int(trainer.loss_scale.good_steps)
    check(all(math.isfinite(v) for v in losses), f"fp16 losses not finite: {losses}")
    check(scale == INIT_SCALE and good == FP16_STEPS + 1,
          f"fp16 scaler after {FP16_STEPS + 1} finite steps: scale {scale}, good {good}")
    print(f"fp16 train: {FP16_STEPS} steps of {BATCH} (ViT-Ti, fp16, loss scaler) | launches "
          f"{launches} | losses {[round(v, 4) for v in losses]} | scale {scale}, good steps "
          f"{good} | attention heads whose dO the range guard divides: {guarded} (largest "
          f"bound on |dS| {float(bound.max()):.4g})", flush=True)

    adamw, opt = trainer.optimizer.opt, trainer.optimizer
    weight = trainer.model.patchembed.projection.weight
    saved = weight.detach()[0, 0].clone()
    with torch.no_grad():
        weight[0, 0] = float("inf")
    params = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    moments = {id(p): {k: v.clone() for k, v in adamw.state[p].items()}
               for p in trainer.model.parameters()}
    count, scale = opt.count, float(trainer.loss_scale.scale)
    loss = float(trainer.train_step(packed))
    torch.cuda.synchronize()
    check(not math.isfinite(loss), f"the poisoned step's loss is finite: {loss}")
    same_params = all(torch.equal(p, params[k]) for k, p in trainer.model.named_parameters())
    same_moments = all(torch.equal(v, moments[id(p)][k]) for p in trainer.model.parameters()
                       for k, v in adamw.state[p].items())
    new_scale, new_good = float(trainer.loss_scale.scale), int(trainer.loss_scale.good_steps)
    check(same_params and same_moments and opt.count == count + 1
          and new_scale == scale * BACKOFF and new_good == 0,
          f"skipped step: parameters bit-identical {same_params}, moments and AdamW's count "
          f"bit-identical {same_moments}, schedule count {count} -> {opt.count}, scale "
          f"{scale} -> {new_scale}, good steps {new_good}")
    with torch.no_grad():
        weight[0, 0] = saved
    adam_steps = float(adamw.state[weight]["step"])
    loss = float(trainer.train_step(packed))
    check(math.isfinite(loss) and float(adamw.state[weight]["step"]) == adam_steps + 1
          and int(trainer.loss_scale.good_steps) == 1
          and float(trainer.loss_scale.scale) == new_scale,
          f"the step after the skip: loss {loss}, AdamW count {adam_steps} -> "
          f"{float(adamw.state[weight]['step'])}, good steps "
          f"{int(trainer.loss_scale.good_steps)}")
    print(f"fp16 overflow: an infinite weight skipped the step: parameters, AdamW moments and "
          f"count bit-identical, schedule count {count} -> {count + 1}, scale {scale} -> "
          f"{new_scale}; restored, the next step updated (loss {loss:.4f}, AdamW count "
          f"{adam_steps:.0f} -> {adam_steps + 1:.0f})", flush=True)


def swin_steps_from_one_state(cfg) -> tuple[list[float], bool]:
    """Two SwinV2-T train steps of ``cfg`` at batch 128, each from the same
    seeded state, rows and draws (two Trainers): their losses, and whether
    every parameter after them is bit-identical."""
    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(SEED + 4)
    rows = vit_rows(rng, SWIN_TRAIN_BATCH, K_TRAIN, grid=SWIN_GRID)
    losses, params, draws = [], [], None
    for _ in range(2):
        trainer = Trainer(cfg, device="cuda")
        trainer.create_state(steps_per_epoch=2)
        if draws is None:
            draws = trainer.draw(SWIN_TRAIN_BATCH)
        losses.append(float(trainer.train_step(trainer.put_batch({"packed": rows})["packed"],
                                               draws)))
        params.append({k: p.detach().clone() for k, p in trainer.model.named_parameters()})
        del trainer
    same = losses[0] == losses[1] and all(torch.equal(params[0][k], params[1][k])
                                          for k in params[0])
    return losses, same


def run_child(tag: str, args: list[str], timeout: int = 600) -> dict:
    """``chip_smoke.py <args>`` in a child process; its last line's JSON."""
    res = subprocess.run([sys.executable, __file__, *args], capture_output=True, text=True,
                         timeout=timeout)
    check(res.returncode == 0, f"{tag} child exit {res.returncode}: {res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def determinism_child() -> int:
    """The child of ``phase_determinism``: ``swin_steps_from_one_state`` with
    ``cfg.train.deterministic`` set, in a process whose first cuBLAS handle
    is made after ``configure_determinism``; prints one JSON line."""
    import os

    import torch

    losses, same = swin_steps_from_one_state(swin_config(SWIN_TRAIN_BATCH, epochs=1,
                                                         warmup_steps=1, lr=3e-3,
                                                         deterministic=True))
    print(json.dumps({"determinism": {
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "losses": losses, "bit_identical": same}}))
    return 0


def phase_determinism() -> None:
    """Is SwinV2-T's train step bit-reproducible on the card?  With
    ``cfg.train.deterministic`` (``configure_determinism``), in a child
    process: this one made its cuBLAS handles long ago.  Two steps from one
    state must give bit-identical parameters, or the phase fails.  The same
    two steps without the flag, in this process, are reported beside it."""
    got = run_child("determinism", ["--determinism"])["determinism"]
    off_losses, off_same = swin_steps_from_one_state(swin_config(
        SWIN_TRAIN_BATCH, epochs=1, warmup_steps=1, lr=3e-3))
    print(f"determinism: SwinV2-T train step at batch {SWIN_TRAIN_BATCH}, twice from one "
          f"state: with cfg.train.deterministic (deterministic algorithms "
          f"{got['deterministic_algorithms']}, CUBLAS_WORKSPACE_CONFIG "
          f"{got['cublas_workspace_config']}) bit-identical: {got['bit_identical']} (losses "
          f"{got['losses']}); without it: {off_same} (losses {off_losses})", flush=True)
    check(got["deterministic_algorithms"] and got["bit_identical"],
          f"SwinV2-T's deterministic train step is not bit-reproducible: {got}")


def trainer_config(**kw):
    """ViT-Ti as its preset gives it (12 x 192, 3 heads, 28x28 blocks, 1000
    classes, float32, AUGLIST_DCT_VITTI), at batch 256, seed 0, 2 epochs,
    warmup 2, dropout 0.1 and ``cfg.train.deterministic``; ``kw`` overrides
    ``generate_config``'s arguments."""
    from rgbnomore_tpu_torch.train.config import generate_config

    args = dict(modelver=1, batchsize=BATCH, seed=SEED, epochs=TRAINER_EPOCHS, warmup_steps=2,
                drop=TRAINER_DROP, deterministic=True)
    cfg = generate_config("vitti", "dct", **{**args, **kw})
    cfg.train.split = TRAINER_SPLIT
    return cfg


def phase_dropout_cost(rows: np.ndarray) -> None:
    """Dropout's cost: the ViT-Ti train step at batch 256 on one resident
    batch at drop 0 (the step without dropout) and at drop 0.1, in turns (0,
    0.1, 0.1, 0), each 1 + 10 steps: ms a step (CUDA-synchronised host
    clock) and the peak device memory after the warm-up; then the kernels
    of a step at drop 0.1."""
    import torch

    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    out = {0.0: [], TRAINER_DROP: []}
    for drop in (0.0, TRAINER_DROP, TRAINER_DROP, 0.0):
        cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=SEED, epochs=1,
                              warmup_steps=1, lr=3e-3, drop=drop)
        trainer = Trainer(cfg, device="cuda")
        trainer.create_state(steps_per_epoch=DROP_AB_STEPS + 1)
        packed = trainer.put_batch({"packed": rows})["packed"]
        trainer.train_step(packed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [trainer.train_step(packed) for _ in range(DROP_AB_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / DROP_AB_STEPS
        check(all(math.isfinite(float(v)) for v in losses), f"dropout {drop}: losses {losses}")
        out[drop].append((ms, torch.cuda.max_memory_allocated() / 2**30))
        if drop and len(out[drop]) == 2:
            phase_train_breakdown(trainer, packed, "dropout breakdown")
        del trainer, packed
        torch.cuda.empty_cache()
    for drop, runs in out.items():
        print(f"dropout cost: ViT-Ti train step at batch {BATCH}, drop {drop}: " + ", ".join(
            f"{ms:.3f} ms ({BATCH * 1e3 / ms:.1f} img/s), peak {gib:.3f} GiB"
            for ms, gib in runs), flush=True)


def write_trainer_corpus(root: str) -> tuple[str, str]:
    """``N_TRAINER`` photo-like JPEGs of 320x240 or 240x320 (40x30 blocks)
    at quality 90 written by the port's codec, labels ``i % 1000``; the
    train index lists them all, the test index the first 256."""
    from rgbnomore_tpu_torch import codec

    rng = np.random.default_rng(SEED + 5)
    lines = []
    t0 = time.perf_counter()
    for i in range(N_TRAINER):
        h, w = (240, 320) if i % 2 else (320, 240)
        ys, xs = np.mgrid[0:h, 0:w]
        f = 0.01 + 0.05 * rng.random(3)
        img = np.stack([(128 + 90 * np.sin(ys * f[ch] + ch) * np.cos(xs * f[2 - ch])
                         + 12 * rng.standard_normal((h, w))).clip(0, 255)
                        for ch in range(3)]).astype(np.uint8)
        path = f"{root}/t{i:04d}.jpg"
        codec.write_tensor(path, img, quality=90)
        lines.append(f"{path},{i % 1000}")
    index_train, index_val = f"{root}/index_train.csv", f"{root}/index_test.csv"
    for index, rows in ((index_train, lines), (index_val, lines[:BATCH])):
        with open(index, "w") as fh:
            fh.write("\n".join(["Filepath,Label", *rows]) + "\n")
    print(f"trainer: wrote {N_TRAINER} JPEGs in {time.perf_counter() - t0:.1f} s", flush=True)
    return index_train, index_val


class Preempted(Exception):
    """Ends a trainer child right after a checkpoint, as a lost job ends."""


def trainer_child(spec: dict) -> int:
    """A child of ``phase_trainer``: ``train_and_eval`` of ``trainer_config``
    on the card, from the checkpoint directory ``spec["load_ckpt_dir"]`` if
    given, stopped by ``Preempted`` right after the checkpoint of epoch
    ``spec["stop_after"]`` if given.  The launch counts are set to 0 just
    before the run and read just after; each checkpoint's save and restore
    are timed (host clock, synchronised).  Prints one JSON line."""
    import torch

    from rgbnomore_tpu_torch.train import checkpoint as ckpt
    from rgbnomore_tpu_torch.train import loop

    save, restore = ckpt.save_checkpoint, ckpt.restore_checkpoint
    saves, restores = [], []

    def timed_save(ckpt_dir, trainer, epoch, metrics=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(ckpt_dir, trainer, epoch, metrics)
        saves.append({"epoch": epoch, "s": time.perf_counter() - t0,
                      "bytes": path.stat().st_size})
        if epoch == spec.get("stop_after"):
            raise Preempted
        return path

    def timed_restore(ckpt_dir, trainer, step=None):
        t0 = time.perf_counter()
        meta = restore(ckpt_dir, trainer, step)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        return meta

    ckpt.save_checkpoint, ckpt.restore_checkpoint = timed_save, timed_restore
    cfg = trainer_config()
    reset_launches()
    results, stopped = {}, False
    t0 = time.perf_counter()
    try:
        results = loop.train_and_eval(
            cfg, spec["index_train"], spec["index_val"], savepath=spec["savepath"],
            load_ckpt_dir=spec.get("load_ckpt_dir", ""), max_steps_per_epoch=TRAINER_STEPS,
            num_threads=8, device="cuda")
    except Preempted:
        stopped = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    try:
        import tensorboard  # noqa: F401
        has_tb = True
    except ImportError:
        has_tb = False
    events = list(loop.tensorboard_dir(spec["savepath"], cfg).rglob("events.out.tfevents*"))
    print(json.dumps({"trainer": {
        "stopped": stopped, "wall_s": wall, "launches": launches, "saves": saves,
        "restores": restores, "history": results.get("history", []),
        "test": results.get("test"), "tensorboard": has_tb, "event_files": len(events),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "deterministic": torch.are_deterministic_algorithms_enabled()}}))
    return 0


def check_trainer_launches(tag: str, launches: dict, steps: int) -> int:
    """A ``train_and_eval`` run's launches: per train step 1 wire launch, 12
    attention forward and 12 backward; per eval batch 1 wire launch and 12
    attention forward; nothing else.  Returns the eval batches."""
    evals = launches["wire_to_range"]
    want = {"fused_attention": 12 * (steps + evals), "fused_attention_bwd": 12 * steps,
            "wire_flip_aug_range": steps, "wire_to_range": evals}
    check_launches(tag, launches, want)
    check(launches["wire_flip_aug_range"] == steps and launches["fused_flip_aug_range"] == 0
          and evals > 0, f"{tag}: input stage launches {launches}, want {steps} train steps")
    return evals


def phase_trainer(tmp: str, index_train: str, index_val: str) -> None:
    """``train_and_eval`` as users run it, ViT-Ti at full width, batch 256,
    drop 0.1, 2 epochs of 3 steps, a checkpoint per epoch, TensorBoard on,
    with ``cfg.train.deterministic``, each run in a child process (the flag
    must precede the first cuBLAS handle): straight through, then epoch 1
    alone, stopped after its checkpoint, and a third run that restores it
    and runs epoch 2.  The resumed run's final parameters and AdamW state
    must be bit-identical to the straight run's."""
    import torch

    from rgbnomore_tpu_torch.train.checkpoint import checkpoint_dir
    from rgbnomore_tpu_torch.train.loop import make_loaders

    train_loader = make_loaders(trainer_config(), index_train, index_val,
                                num_threads=8)["train"]
    t0 = time.perf_counter()
    n = sum(int(b["weights"].sum()) for b in train_loader.iter_cycle(TRAINER_STEPS))
    print(f"trainer: host decode of the train loader alone (random-resized crop to "
          f"{GRID}x{GRID} blocks, K={K_TRAIN}, 8 threads): {n / (time.perf_counter() - t0):.1f} "
          f"img/s over {n} images", flush=True)
    runs = {}
    for name, extra in (("straight", {}), ("epoch 1", {"stop_after": 0}),
                        ("resumed", {"load_ckpt_dir": str(checkpoint_dir(
                            f"{tmp}/resumed/vitti.pt", "vitti_dct"))})):
        save_dir = "straight" if name == "straight" else "resumed"
        spec = {"index_train": index_train, "index_val": index_val,
                "savepath": f"{tmp}/{save_dir}/vitti.pt", **extra}
        got = run_child(f"trainer {name}", ["--trainer", json.dumps(spec)])["trainer"]
        check(got["deterministic"], f"trainer {name}: deterministic algorithms off")
        runs[name] = got
    straight, first, resumed = runs["straight"], runs["epoch 1"], runs["resumed"]
    check(first["stopped"] and not straight["stopped"] and not resumed["stopped"],
          "trainer: the epoch-1 run did not stop at its checkpoint")
    for name, steps in (("straight", TRAINER_EPOCHS * TRAINER_STEPS),
                        ("epoch 1", TRAINER_STEPS), ("resumed", TRAINER_STEPS)):
        evals = check_trainer_launches(f"trainer {name}", runs[name]["launches"], steps)
        print(f"trainer {name}: {steps} train steps and {evals} eval batches in "
              f"{runs[name]['wall_s']:.1f} s, launches {runs[name]['launches']}", flush=True)
    want = torch.load(checkpoint_dir(f"{tmp}/straight/vitti.pt", "vitti_dct") / "epoch_1.pt",
                      map_location="cpu", weights_only=True)
    got = torch.load(checkpoint_dir(f"{tmp}/resumed/vitti.pt", "vitti_dct") / "epoch_1.pt",
                     map_location="cpu", weights_only=True)
    same_params = want["model"].keys() == got["model"].keys() and all(
        torch.equal(want["model"][k], got["model"][k]) for k in want["model"])
    ws, gs = want["optimizer"]["state"], got["optimizer"]["state"]
    same_moments = ws.keys() == gs.keys() and all(
        torch.equal(ws[i][k], gs[i][k]) for i in ws for k in ("exp_avg", "exp_avg_sq", "step"))
    weights = torch.load(f"{tmp}/resumed/vitti.pt", map_location="cpu", weights_only=True)
    same_weights = all(torch.equal(weights[k], want["model"][k]) for k in want["model"])
    print(f"trainer: resumed run (epoch 1, stop, restore, epoch 2) against the straight run: "
          f"parameters bit-identical {same_params}, AdamW moments and counts {same_moments}, "
          f"weights file {same_weights}; schedule counts {got['count']} / {want['count']}; "
          f"test {resumed['test']} / {straight['test']}", flush=True)
    check(same_params and same_moments and same_weights and got["count"] == want["count"]
          and resumed["test"] == straight["test"],
          "trainer: the resumed run is not bit-identical to the straight run")
    for h in straight["history"] + resumed["history"]:
        run = "straight" if h in straight["history"] else "resumed"
        print(f"trainer {run}: epoch {h['epoch'] + 1}: train {h['train_img_s']:.1f} img/s, "
              f"eval {h['eval_img_s']:.1f} img/s (minival + trainval, host decode included), "
              f"loss {h['train_loss']:.4f}", flush=True)
    size = straight["saves"][-1]["bytes"]
    save_s = ", ".join(f"{entry['s']:.3f}" for entry in straight["saves"])
    print(f"trainer: checkpoint {size} bytes ({size / 2**20:.1f} MiB), saved in {save_s} s, "
          f"restored in {resumed['restores'][0]:.3f} s", flush=True)
    tb = (f"{straight['event_files']} event file(s) written" if straight["tensorboard"]
          else "tensorboard is not installed here: the writer logged instead "
               f"({straight['event_files']} event files)")
    print(f"trainer: TensorBoard: {tb}; peak memory of the straight run "
          f"{straight['peak_gib']:.3f} GiB (torch.cuda.max_memory_allocated)", flush=True)
    check(not straight["tensorboard"] or straight["event_files"] == 1,
          f"trainer: tensorboard is installed but {straight['event_files']} event files")


def ddp_child() -> int:
    """The child of ``phase_ddp``: three ViT-Ti train steps at batch 256
    (drop 0.1, mixup) and the eval of two batches, with the plain
    ``Trainer``, then the same from the same seeded state in a process
    group of one over NCCL, which takes the data-parallel path (gradient
    all-reduce, mixup's ring, eval sums all-reduced), each collective
    counted.  Prints one JSON line."""
    import socket

    import torch
    import torch.distributed as dist

    from rgbnomore_tpu_torch import parallel
    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = trainer_config(epochs=1)
    rng = np.random.default_rng(SEED + 6)
    train_rows = [vit_rows(rng, BATCH, K_TRAIN) for _ in range(3)]
    eval_rows = [{"packed": vit_rows(rng, BATCH, K_EVAL)} for _ in range(2)]

    def run():
        trainer = Trainer(cfg, device="cuda")
        trainer.create_state(steps_per_epoch=len(train_rows))
        losses = [float(trainer.train_step(trainer.put_batch({"packed": r})["packed"]))
                  for r in train_rows]
        return trainer, losses, trainer.evaluate(eval_rows)

    plain, plain_losses, plain_eval = run()
    calls = {"all_reduce_mean_": 0, "ring_roll": 0, "all_reduce_sum_": 0}
    for name in calls:
        fn = getattr(parallel, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(parallel, name, counted)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    parallel.init_distributed(f"localhost:{port}", num_processes=1, process_id=0,
                              device="cuda")
    ddp, ddp_losses, ddp_eval = run()
    backend, world = dist.get_backend(), dist.get_world_size()
    dist.destroy_process_group()
    pp, dp = dict(plain.model.named_parameters()), dict(ddp.model.named_parameters())
    po, do = plain.optimizer.opt.state_dict()["state"], ddp.optimizer.opt.state_dict()["state"]
    print(json.dumps({"ddp": {
        "distributed": ddp.distributed, "backend": backend, "world": world,
        "nccl": ".".join(map(str, torch.cuda.nccl.version())), "calls": calls,
        "losses": [plain_losses, ddp_losses], "eval": [plain_eval, ddp_eval],
        "params_same": all(torch.equal(pp[k], dp[k]) for k in pp),
        "moments_same": all(torch.equal(po[i][k], do[i][k])
                            for i in po for k in ("exp_avg", "exp_avg_sq"))}}))
    return 0


def phase_ddp() -> None:
    """The data-parallel path on the one card: a process group of one over
    NCCL, in a child process with ``cfg.train.deterministic``, must give
    parameters, AdamW moments, losses and eval sums bit-identical to the
    plain ``Trainer``'s from the same state."""
    got = run_child("ddp", ["--ddp"])["ddp"]
    want_calls = {"all_reduce_mean_": 3, "ring_roll": 3, "all_reduce_sum_": 1}
    print(f"ddp: backend {got['backend']}, world size {got['world']}, NCCL {got['nccl']}; "
          f"collectives {got['calls']}; 3 ViT-Ti steps at batch {BATCH} (drop "
          f"{TRAINER_DROP}, mixup) against the plain Trainer: parameters bit-identical "
          f"{got['params_same']}, AdamW moments {got['moments_same']}, losses "
          f"{got['losses'][1]} / {got['losses'][0]}, eval {got['eval'][1]} / {got['eval'][0]}",
          flush=True)
    check(got["distributed"] and got["backend"] == "nccl" and got["world"] == 1
          and got["calls"] == want_calls, f"ddp: the data-parallel path did not run: {got}")
    check(got["params_same"] and got["moments_same"] and got["losses"][0] == got["losses"][1]
          and got["eval"][0] == got["eval"][1],
          "ddp: the process group of one is not bit-identical to the plain Trainer")


def phase_cli(tmp: str, index_train: str, index_val: str) -> None:
    """The CLIs on the card: ``python -m rgbnomore_tpu_torch.cli --train
    --eval`` for one epoch of 3 steps of ViT-Ti at batch 256 on the trainer
    corpus must exit 0 and write its weights; ``python -m
    rgbnomore_tpu_torch.eval --loadpath`` on them must score its test
    split's result again (both with ``--deterministic``)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    weights = f"{tmp}/cli/vitti.pt"
    common = ["--model_arch", "vitti", "--embed_type", "1", "--indexpaths",
              f"{index_train},{index_val}", "--batch", str(BATCH), "--seed", str(SEED),
              "--num_cpus", "8", "--deterministic", "--warmup_steps", "2", "--verbose", "0"]
    out = {}
    for name, args in (("cli", ["-m", "rgbnomore_tpu_torch.cli", "--train", "--eval",
                                "--epochs", "1", "--max_steps_per_epoch", str(TRAINER_STEPS),
                                "--savepath", weights, *common]),
                       ("eval", ["-m", "rgbnomore_tpu_torch.eval", "--loadpath", weights,
                                 *common])):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                             timeout=600)
        check(res.returncode == 0, f"{name} CLI exit {res.returncode}: {res.stderr[-4000:]}")
        out[name] = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"cli: python {' '.join(args[:2])} exited 0 in {time.perf_counter() - t0:.1f} s: "
              f"test {out[name]['test']}", flush=True)
        if name == "cli":
            check(Path(weights).is_file(), f"cli: no weights file at {weights}")
    check(out["eval"]["test"] == out["cli"]["test"] and out["cli"]["test"]["count"] == BATCH,
          f"cli: the eval CLI scored {out['eval']['test']}, the run {out['cli']['test']}")
    print("cli: the eval CLI on the run's weights file reproduces its test result", flush=True)


# ------------------------------------------------- ViT-S, embeddings, APE
def vits_config(**kw):
    """ViT-S/16 as the CLI's defaults build it (``--model_arch vits
    --embed_type 2``: 12 x 384, 6 heads of 64, the separate sub-block DCT
    embedding, 28x28 blocks = 196 tokens, 1000 classes, float32, lr 3e-3,
    the preset's global batch of 1024); warmup 1 over one epoch, so that a
    few steps move the loss.  ``kw`` overrides ``generate_config``'s
    arguments."""
    from rgbnomore_tpu_torch.train.config import generate_config

    args = dict(modelver=2, subblock=True, seed=SEED, epochs=1, warmup_steps=1)
    cfg = generate_config("vits", "dct", **{**args, **kw})
    m = cfg.model
    check(m.embed_size == 384 and m.depth == 12 and m.heads == 6 and m.head_size == 64
          and m.dct_blocks == GRID and m.classes == 1000 and m.patch_size == 16
          and cfg.train.lr == 3e-3, f"the vits preset changed: {cfg}")
    return cfg


def record_launches(report: dict, path: str, launches: dict) -> None:
    """Keep each attention and window kernel's launches on ``path`` under its
    report entry's ``launches_by_path`` (the half-precision wrappers' count
    under the entry of the path's dtype, bf16 here)."""
    names = {"fused_attention": "fused_attention", "fused_attention_bwd": "fused_attention_bwd",
             "fused_attention_h16": "fused_attention_bf16",
             "fused_attention_h16_bwd": "fused_attention_bwd_bf16",
             "window_attention": "window_attention",
             "window_attention_bwd": "window_attention_bwd",
             **{name: name for name in LINEAR_WRAPPERS}}
    for wrapper, entry in names.items():
        if launches.get(wrapper):
            report[entry].setdefault("launches_by_path", {})[path] = launches[wrapper]


def vit_rows(rng: np.random.Generator, n: int, k: int, classes: int = 1000,
             grid: int = GRID) -> np.ndarray:
    """``n`` rows of the ViT's 28x28 grid (or SwinV2's ``grid``) on the
    K-``k`` wire, labels ``arange % classes``."""
    y, c = synthetic_planes(rng, n, grid)
    return write_rows(y, c, (np.arange(n) % classes).astype(np.int32), k)


def used_class_loss(trainer, packed, draws) -> float:
    """The batch's cross-entropy over only the classes its labels use, in
    eval mode, without mixup, on one fixed draw.  The head's bias cannot
    lower it by pushing the unused classes' logits down, so it falls only
    as the model tells the used classes apart."""
    import torch

    trainer.model.eval()
    with torch.inference_mode():
        *inputs, labels, _ = trainer.train_pipe(packed, draws.flip, draws.policy, draws.crop)
        labels = labels.long()
        used = torch.unique(labels)
        logits = trainer.model(*inputs).float()[:, used]
        return float(torch.nn.functional.cross_entropy(logits, torch.searchsorted(used, labels)))


def train_path(report: dict, tag: str, trainer, packed, steps: int, want: dict,
               tensor_stage: bool = False, linear: tuple | None = None) -> dict:
    """1 + ``steps`` train steps on one resident batch, the counters read
    after each counted step: 1 wire launch a step, ``want`` launches a step
    of the attention and window kernels and none of the others, ``linear``
    (``check_swin_linear``) where given; finite losses, the last below the
    first; the peak memory from the warm-up on.  Returns the launches of
    the counted steps.  ``tensor_stage``: an input stage in tensor code (the
    RGB domain, a DCT op list outside the kernel's set), which launches no
    #5 entry and unpacks its rows itself, and no check of the falling loss
    (the RGB rows are photographs of the trainer corpus, and RandAugment at
    magnitude 10 moves each step's batch far).  With few steps and rows
    that leave classes unused, the falling loss is a check of the head and
    of the gradient path only: the head's bias lowers it by pushing the
    unused classes' logits down, and ``step_card_vs_cpu`` holds the
    backbone's gradients.  The loss over the used classes
    (``used_class_loss``) before and after the steps is printed beside it,
    and not checked."""
    import torch

    batch = (packed["labels"] if isinstance(packed, dict) else packed).shape[0]
    fixed = trainer.draw(batch)
    used_before = used_class_loss(trainer, packed, fixed)
    torch.cuda.reset_peak_memory_stats()
    losses = [trainer.train_step(packed)]  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    total = collections.Counter()
    with plain_unpacks() as unpacks:
        t0 = time.perf_counter()
        for _ in range(steps):
            reset_launches()  # the counters are the host's: no synchronise
            losses.append(trainer.train_step(packed))
            step = all_launches()
            check_launches(tag, step, want)
            if linear is not None:
                check_swin_linear(tag, step, linear)
            total.update(step)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: total[name] for name in LAUNCH_COUNTERS}
    if tensor_stage:
        check_no_input_kernel(report, tag.replace(" ", "_"), launches)
    else:
        check_input_stage(report, tag.replace(" ", "_"), launches, len(unpacks),
                          train_steps=steps)
    record_launches(report, tag.replace(" ", "_"), launches)
    losses = [float(v) for v in losses]
    used_after = used_class_loss(trainer, packed, fixed)
    print(f"{tag}: {steps} steps of {batch} in {train_s:.3f} s, {steps * batch / train_s:.1f} "
          f"img/s (pipeline + step, one resident batch) | launches {launches} | losses "
          f"{[round(v, 4) for v in losses]} | loss over the used classes, eval mode, one "
          f"fixed draw: {used_before:.5f} -> {used_after:.5f} | peak memory {peak_gib:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    check(all(math.isfinite(v) for v in losses), f"{tag}: losses not finite: {losses}")
    check(tensor_stage or losses[-1] < losses[0],
          f"{tag}: loss did not fall over {steps} steps: {losses}")
    return launches


def eval_path(report: dict, tag: str, trainer, want_per_batch: dict,
              rows: np.ndarray | None = None, linear: tuple | None = None) -> None:
    """``rows`` (``N_IMAGES`` ViT rows on the K=48 wire where None) through
    ``Trainer.evaluate`` in batches of ``BATCH``: one wire launch,
    ``want_per_batch`` attention or window launches and none of the others
    and ``linear`` (``check_swin_linear``) where given a batch, finite sums
    over every image."""
    if rows is None:
        rows = vit_rows(np.random.default_rng(SEED + 11), N_IMAGES, K_EVAL)
    n = rows.shape[0]
    batches = [{"packed": rows[i:i + BATCH]} for i in range(0, n, BATCH)]
    trainer.evaluate(batches[:1])  # warm-up
    reset_launches()
    with plain_unpacks() as unpacks:
        t0 = time.perf_counter()
        res = trainer.evaluate(batches)
        eval_s = time.perf_counter() - t0
    launches = all_launches()
    check_input_stage(report, tag.replace(" ", "_"), launches, len(unpacks),
                      eval_batches=len(batches))
    check_launches(tag, launches, {k: v * len(batches) for k, v in want_per_batch.items()})
    if linear is not None:
        check_swin_linear(tag, launches, tuple(v * len(batches) for v in linear))
    record_launches(report, tag.replace(" ", "_"), launches)
    check(res["count"] == n and math.isfinite(res["loss"])
          and math.isfinite(res["accuracy"]), f"{tag}: eval gave {res}")
    print(f"{tag}: {res} | {n / eval_s:.1f} img/s (upload + pipeline + forward, rows "
          f"premade, batches of {BATCH}) | launches {launches}", flush=True)


def phase_vits(report: dict):
    """ViT-S/16 with the CLI's default embedding at full width: 1 + 5 train
    steps at the preset's batch of 1024 (512 where 1024 does not fit one
    card: the preset's batch is the global one) with 1 wire, 12 #1 and 12 #2
    launches a step, finite falling losses, the peak memory; then 512
    images through the eval."""
    import gc

    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(SEED + 10)
    for batch in VITS_BATCHES:
        cfg = vits_config(batchsize=batch)
        trainer = Trainer(cfg, device="cuda")
        embed = type(trainer.model.patchembed).__name__
        check(embed == "PatchEmbeddingDCTSeparateSubblock" and trainer.compute_dtype ==
              torch.float32, f"vits builds {embed} in {trainer.compute_dtype}")
        trainer.create_state(steps_per_epoch=VITS_TRAIN_STEPS + 1)
        # labels of 256 classes, as phase 6's: the 744 unused classes' logits
        # make the loss fall in a few steps (with every class of a batch of
        # 1,024 used once, 5 steps from ln 1000 move it by less than its
        # noise); the falling loss checks the head and the gradient path,
        # step_card_vs_cpu the backbone's gradients (train_path)
        rows = vit_rows(rng, batch, K_TRAIN, classes=BATCH)
        packed = trainer.put_batch({"packed": rows})["packed"]
        torch.cuda.reset_peak_memory_stats()
        try:
            train_path(report, "vits train", trainer, packed, VITS_TRAIN_STEPS,
                       {"fused_attention": 12, "fused_attention_bwd": 12})
        except torch.cuda.OutOfMemoryError as exc:
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"vits train: batch {batch} does not fit one card (peak {peak:.2f} GiB "
                  f"before: {str(exc).splitlines()[0]})", flush=True)
            del trainer, packed, exc
            gc.collect()
            torch.cuda.empty_cache()
            continue
        break
    else:
        check(False, f"vits train: no batch of {VITS_BATCHES} fits one card")
    step_card_vs_cpu("vits train", vits_config(batchsize=VITS_CPU_BATCH),
                     rows[:VITS_CPU_BATCH])
    phase_train_breakdown(trainer, packed, "vits breakdown")
    eval_path(report, "vits eval", trainer, {"fused_attention": 12})
    # #6 on every float32 Linear: 52 a forward (3 in the embedding, 4 in each
    # of 12 blocks, the head's first), no input gradient for the embedding's
    # two projections of the data
    linear = {path: {w: report[w].get("launches_by_path", {}).get(path, 0)
                     for w in LINEAR_WRAPPERS} for path in ("vits_train", "vits_eval")}
    want = {"vits_train": dict(zip(LINEAR_WRAPPERS, (52 * VITS_TRAIN_STEPS,
                                                     50 * VITS_TRAIN_STEPS,
                                                     52 * VITS_TRAIN_STEPS))),
            "vits_eval": dict(zip(LINEAR_WRAPPERS, (52 * N_IMAGES // BATCH, 0, 0)))}
    check(linear == want, f"vits: #6 launches {linear}, want {want}")
    del trainer, packed
    gc.collect()
    torch.cuda.empty_cache()


def phase_embed(report: dict) -> None:
    """ViT-S's width with the other embeddings, at batch 256: 1 + 3 train
    steps and 512 images through the eval each, for embed_type 2 without
    sub-blocks (196 tokens), embed_type 3 in float32 (294 tokens: #1 and #2
    at N = 294) and embed_type 3 under bf16 AMP (#1h's tiled kernel and
    #2h's key groups at N = 294, none of the float32 kernels)."""
    import gc

    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(SEED + 12)
    for tag, kw, embed, tokens in EMBED_PATHS:
        cfg = vits_config(batchsize=BATCH, **kw)
        trainer = Trainer(cfg, device="cuda")
        got = type(trainer.model.patchembed).__name__
        with torch.inference_mode():
            y = torch.zeros((1, 1, GRID, GRID, 8, 8), device="cuda")
            c = torch.zeros((1, 2, GRID // 2, GRID // 2, 8, 8), device="cuda")
            n = trainer.model.patchembed(y, c).shape[1]
        check(got == embed and n == tokens, f"{tag}: {got} with {n} tokens, want {embed}, "
              f"{tokens}")
        half = trainer.compute_dtype == torch.bfloat16
        fwd, bwd = (("fused_attention_h16", "fused_attention_h16_bwd") if half
                    else ("fused_attention", "fused_attention_bwd"))
        trainer.create_state(steps_per_epoch=EMBED_STEPS + 1)
        packed = trainer.put_batch({"packed": vit_rows(rng, BATCH, K_TRAIN)})["packed"]
        print(f"{tag}: {got}, {n} tokens, {trainer.compute_dtype}", flush=True)
        train_path(report, f"{tag} train", trainer, packed, EMBED_STEPS, {fwd: 12, bwd: 12})
        eval_path(report, f"{tag} eval", trainer, {fwd: 12})
        del trainer, packed
        gc.collect()
        torch.cuda.empty_cache()


def phase_ape(report: dict) -> None:
    """SwinV2-T (float32) with its absolute position embedding (``ape``,
    drawn at N(0, 1) so that it moves the logits, norms perturbed): one
    train step at batch 128 (1 wire, 12 window forward and 24 backward
    launches) and one eval batch of 256 (1 wire, 12 window launches); the
    logits of 4 images on the card against the CPU."""
    import copy

    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer

    cfg = swin_config(SWIN_TRAIN_BATCH, epochs=1, warmup_steps=1, lr=3e-3)
    cfg.model.ape = True
    trainer = Trainer(cfg, device="cuda")
    ape = trainer.model.absolute_pos_embed
    check(ape is not None and tuple(ape.shape) == (1, 64 * 64, 96),
          f"ape: absolute_pos_embed {None if ape is None else tuple(ape.shape)}")
    perturb_norms(trainer.model)
    with torch.no_grad():
        ape.copy_(torch.randn(ape.shape, generator=torch.Generator().manual_seed(SEED)))
    cpu_model = copy.deepcopy(trainer.model).cpu().eval()
    trainer.create_state(steps_per_epoch=2)
    rng = np.random.default_rng(SEED + 13)
    rows = vit_rows(rng, SWIN_TRAIN_BATCH, K_TRAIN, grid=SWIN_GRID)
    packed = trainer.put_batch({"packed": rows})["packed"]
    reset_launches()
    with plain_unpacks() as unpacks:
        loss = float(trainer.train_step(packed))
        torch.cuda.synchronize()
    launches = all_launches()
    check_input_stage(report, "ape_train", launches, len(unpacks), train_steps=1)
    check_launches("ape train", launches, {"window_attention": 12, "window_attention_bwd": 24})
    record_launches(report, "ape_train", launches)
    check(math.isfinite(loss) and ape.grad is not None and bool(ape.grad.abs().max() > 0),
          f"ape train: loss {loss}, the embedding got no gradient")
    rows = vit_rows(rng, SWIN_EVAL_BATCH, K_EVAL, grid=SWIN_GRID)
    trainer.model.load_state_dict(cpu_model.state_dict())  # the weights before the step
    reset_launches()
    with plain_unpacks() as unpacks:
        res = trainer.evaluate([{"packed": rows}])
    launches = all_launches()
    check_input_stage(report, "ape_eval", launches, len(unpacks), eval_batches=1)
    check_launches("ape eval", launches, {"window_attention": 12})
    record_launches(report, "ape_eval", launches)
    check(res["count"] == SWIN_EVAL_BATCH and math.isfinite(res["loss"]),
          f"ape eval gave {res}")
    without = copy.deepcopy(cpu_model)
    with torch.no_grad():
        without.absolute_pos_embed.zero_()
    with torch.inference_mode():
        yd, cd, _, _ = trainer.eval_pipe(trainer.put_batch({"packed": rows})["packed"])
        yd, cd = yd[:SWIN_CPU_BATCH], cd[:SWIN_CPU_BATCH]
        got = trainer.model.eval()(yd, cd).cpu()
        want = cpu_model(yd.cpu(), cd.cpu())
        moved = float((without(yd.cpu(), cd.cpu()) - want).abs().max())
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **LOGIT_TOL),
          f"ape: logits card vs CPU max abs err {err} beyond {LOGIT_TOL}")
    check(moved > 100 * LOGIT_TOL["atol"], f"ape: the embedding moves the logits by {moved}")
    print(f"ape: train loss {loss:.4f}, eval {res}; logits card vs CPU max abs err {err:.3e} "
          f"(the embedding moves them by {moved:.3f})", flush=True)


def phase_packed(report: dict, index_train: str, index_val: str) -> None:
    """ViT-Ti through ``Trainer(transfer="packed")`` (``DctPackedLoader``,
    the mask wire at K=16 on the 64-block canvas) and ``"dense"``
    (``DctCanvasLoader``) on the trainer corpus: 1 + 3 train steps each, 1
    launch of #5's dense entry a step and none of its wire reader; one eval
    batch; the pipeline stage on the card against the CPU on the same batch
    and draws: the dequantized crop, then the dense entry against its plain
    version on the card's crop."""
    import torch

    from rgbnomore_tpu_torch.ops.augpipe import flip_aug_range_plain
    from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders

    for transfer in ("packed", "dense"):
        cfg = trainer_config(epochs=1, warmup_steps=1, drop=0.0, deterministic=False)
        trainer = Trainer(cfg, device="cuda", transfer=transfer)
        loaders = make_loaders(cfg, index_train, index_val, num_threads=8,
                               global_batch=BATCH, transfer=transfer)
        batches = [b for _, b in zip(range(PACKED_STEPS + 1), loaders["train"])]
        check(len(batches) == PACKED_STEPS + 1, f"{transfer}: {len(batches)} train batches")
        trainer.create_state(steps_per_epoch=PACKED_STEPS + 1)
        losses = [float(trainer.train_step(trainer.upload(batches[0])))]  # warm-up
        inputs = [trainer.upload(b) for b in batches[1:]]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for x in inputs:
            losses.append(trainer.train_step(x))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = all_launches()
        check_input_stage(report, f"{transfer}_train", launches, 0,
                          dense_steps=PACKED_STEPS)
        check_launches(f"{transfer} train", launches,
                       {"fused_attention": 12 * PACKED_STEPS,
                        "fused_attention_bwd": 12 * PACKED_STEPS})
        record_launches(report, f"{transfer}_train", launches)
        losses = [float(v) for v in losses]
        check(all(math.isfinite(v) for v in losses), f"{transfer}: losses {losses}")
        print(f"{transfer} train: {PACKED_STEPS} steps of {BATCH} in {train_s:.3f} s, "
              f"{PACKED_STEPS * BATCH / train_s:.1f} img/s (batches uploaded first) | launches "
              f"{launches} | losses {[round(v, 4) for v in losses]}", flush=True)

        test = next(iter(loaders["test"]))
        reset_launches()
        res = trainer.evaluate([test])
        launches = all_launches()
        check_input_stage(report, f"{transfer}_eval", launches, 0, dense_steps=0)
        check_launches(f"{transfer} eval", launches, {"fused_attention": 12})
        record_launches(report, f"{transfer}_eval", launches)
        check(res["count"] == BATCH and math.isfinite(res["loss"]),
              f"{transfer} eval gave {res}")
        print(f"{transfer} eval: {res} | launches {launches}", flush=True)

        # the stage on the card against the CPU, the same batch and draws
        cpu = Trainer(cfg, device="cpu", transfer=transfer)
        draws = cpu.draw(BATCH)
        pipe, cpu_pipe = trainer.train_pipe, cpu.train_pipe
        with torch.inference_mode():
            card_in, cpu_in = trainer.upload(batches[1]), cpu.upload(batches[1])
            yd, cd, _, _ = pipe.dequantized(card_in)
            yd, cd = pipe.rrc.crop(yd, cd, draws.crop)
            yc, cc, _, _ = cpu_pipe.dequantized(cpu_in)
            yc, cc = cpu_pipe.rrc.crop(yc, cc, draws.crop)
            crop_err = max(float((yd.cpu() - yc).abs().max()), float((cd.cpu() - cc).abs().max()))
            reset_launches()
            got = pipe(card_in, draws.flip, draws.policy, draws.crop)
            check(all_launches()["fused_flip_aug_range"] == 1,
                  f"{transfer}: the stage did not launch the dense entry once")
            want = flip_aug_range_plain(yd.cpu(), cd.cpu(), draws.policy, draws.flip,
                                        ops_list=pipe.ops_list, num_ops=pipe.num_ops,
                                        magnitude=pipe.magnitude)
            cpu_out = cpu_pipe(cpu_in, draws.flip, draws.policy, draws.crop)
        kern_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got[:2], want))
        stage_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got[:2], cpu_out[:2]))
        check(crop_err <= PACKED_CROP_ATOL,
              f"{transfer}: crop card vs CPU max abs err {crop_err} beyond {PACKED_CROP_ATOL}")
        check(kern_err <= AUG_TOL["atol"],
              f"{transfer}: dense entry vs plain max abs err {kern_err} beyond {AUG_TOL}")
        check(torch.equal(got[2].cpu(), cpu_out[2]) and torch.equal(got[3].cpu(), cpu_out[3]),
              f"{transfer}: labels or weights differ card vs CPU")
        print(f"{transfer}: pipeline stage card vs CPU: crop max abs err {crop_err:.3e} "
              f"(coefficients up to {float(yc.abs().max()):.1f}), dense entry vs plain "
              f"{kern_err:.3e}, whole stage {stage_err:.3e}", flush=True)
        packed_stage_split(transfer, pipe, card_in, draws)
        del trainer, cpu, inputs, batches


def packed_stage_split(transfer: str, pipe, inputs, draws) -> None:
    """Where the full-canvas train stage's time goes on the card: the
    unpack of the packed rows (none for the dense canvases), the
    dequantization, the random resized crop's two batched products and #5's
    dense entry, each alone (``utils.timing.timeit_fifo``, CUDA events), and
    the whole stage as ``Trainer.train_step`` runs it."""
    import torch

    from rgbnomore_tpu_torch.augment.pipeline import (
        dequantize,
        split_packed_batch,
        unpack_fields,
    )
    from rgbnomore_tpu_torch.ops.augpipe import fused_flip_aug_range
    from rgbnomore_tpu_torch.utils.timing import timeit_fifo

    def unpack(x):
        if not pipe.packed:
            return x["y"], x["cbcr"], x["quant"]
        f = split_packed_batch(x, pipe.canvas, pipe.k, pipe.fmt)
        return (*unpack_fields(f, pipe.fmt), f["quant"])

    with torch.inference_mode():
        yq, cq, quant = unpack(inputs)
        yd, cd = dequantize(yq, cq, quant)
        yr, cr = pipe.rrc.crop(yd, cd, draws.crop)
        parts = {
            "unpack": (unpack, (inputs,)),
            "dequantize": (dequantize, (yq, cq, quant)),
            "crop": (pipe.rrc.crop, (yd, cd, draws.crop)),
            "dense entry #5": (lambda y, c: fused_flip_aug_range(
                y, c, draws.policy, draws.flip, ops_list=pipe.ops_list,
                num_ops=pipe.num_ops, magnitude=pipe.magnitude), (yr, cr)),
            "whole stage": (pipe, (inputs, draws.flip, draws.policy, draws.crop)),
        }
        if not pipe.packed:
            del parts["unpack"]  # the dense canvases arrive unpacked
        ms = {name: 1e3 * timeit_fifo(fn, args, depth=10, repeats=5)
              for name, (fn, args) in parts.items()}
    print(f"{transfer} stage split (batch {yd.shape[0]}, {pipe.canvas}-block canvas): "
          + ", ".join(f"{name} {v:.3f} ms" for name, v in ms.items()), flush=True)


def phase_benchmark(index_train: str, index_val: str) -> None:
    """The harness users run: ``python -m rgbnomore_tpu_torch.cli
    --benchmark 20`` for ViT-Ti on the trainer corpus at batch 64 (so that
    the 256 test files make 4 batches) prints the six FPS metrics, each >
    0; ``python -m rgbnomore_tpu_torch.bench`` (loader threads 8) prints its
    one line with ``value`` and ``device_step_imgs_per_sec`` > 0 and no
    ``vs_baseline``."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    runs = (("benchmark", ["-m", "rgbnomore_tpu_torch.cli", "--benchmark", "20", "--model_arch",
                           "vitti", "--embed_type", "1", "--indexpaths",
                           f"{index_train},{index_val}", "--batch", "64", "--seed", str(SEED),
                           "--num_cpus", "8", "--verbose", "0"]),
            ("bench", ["-m", "rgbnomore_tpu_torch.bench"]))
    out, lines = {}, {}
    for name, args in runs:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                             timeout=900, env={**os.environ, "RGBNM_BENCH_THREADS": "8"})
        check(res.returncode == 0, f"{name}: exit {res.returncode}: {res.stdout[-2000:]} "
              f"{res.stderr[-4000:]}")
        lines[name] = res.stdout.strip().splitlines()
        out[name] = json.loads(lines[name][-1])
        print(f"{name}: python {' '.join(args[:2])} exited 0 in "
              f"{time.perf_counter() - t0:.1f} s: {out[name]}", flush=True)
    six = {"train_loader_fps", "test_loader_fps", "model_fbp_fps", "model_fwd_fps",
           "train_pipeline_fps", "test_pipeline_fps"}
    check(set(out["benchmark"]) == six and all(v > 0 for v in out["benchmark"].values()),
          f"benchmark: {out['benchmark']}")
    line = out["bench"]
    check(len(lines["bench"]) == 1 and "error" not in line and "vs_baseline" not in line
          and line.get("value", 0) > 0 and line.get("device_step_imgs_per_sec", 0) > 0
          and line.get("n_gpus", 0) >= 1, f"bench printed {lines['bench']}")


# ------------------------------------------------- RGB domain, DCT ops
def rgb_config(arch: str = "vits", **kw):
    """``arch`` in the RGB domain as its preset and ``--domain rgb`` give it
    (ViT-S/16: 12 x 384, 6 heads of 64, patch 16, 224 px, 196 tokens, lr
    1e-3, wd 1e-4, AUGLIST_RGB at magnitude 10 in 2 rounds), seed 0, warmup
    1 over one epoch, the trainer corpus's 20% minival; ``kw`` overrides
    ``generate_config``'s arguments."""
    from rgbnomore_tpu_torch.train.config import AUGLIST_RGB, generate_config

    cfg = generate_config(arch, "rgb", **{**dict(seed=SEED, epochs=1, warmup_steps=1), **kw})
    cfg.train.split = TRAINER_SPLIT
    t = cfg.train
    check(cfg.model.domain == "RGB" and t.lr == 1e-3 and t.wd == 1e-4 and t.augstr == 10
          and t.num_ops == 2 and list(t.auglist) == list(AUGLIST_RGB),
          f"the RGB preset changed: {cfg}")
    return cfg


def rgb_eval(report: dict, tag: str, trainer, batches: list, want_per_batch: dict) -> dict:
    """``trainer.evaluate`` over ``batches`` (loader batches) with launch
    counts: ``want_per_batch`` attention launches a batch and no #5 launch;
    finite sums over every weighted row."""
    trainer.evaluate(batches[:1])  # warm-up
    reset_launches()
    t0 = time.perf_counter()
    res = trainer.evaluate(batches)
    eval_s = time.perf_counter() - t0
    launches = all_launches()
    check_no_input_kernel(report, tag.replace(" ", "_"), launches)
    check_launches(tag, launches, {k: v * len(batches) for k, v in want_per_batch.items()})
    record_launches(report, tag.replace(" ", "_"), launches)
    n = sum(float(b["weights"].sum()) for b in batches)
    check(res["count"] == n and math.isfinite(res["loss"]), f"{tag}: eval gave {res}")
    print(f"{tag}: {res} | {n / eval_s:.1f} img/s (upload + decode + resample + forward, "
          f"rows premade) | launches {launches}", flush=True)
    return res


def rgb_stage_split(trainer, packed, rows: np.ndarray) -> None:
    """The RGB input stage: each of its parts on the card at the train batch
    (CUDA events: decode, residual resample, flip + RandAugment, range, and
    the whole stage as the step runs it), then each part on the card against
    the CPU on ``RGB_STAGE_BATCH`` rows, every part from the CPU's output of
    the part before it."""
    import torch

    from rgbnomore_tpu_torch.augment.rgb import to_unit_range
    from rgbnomore_tpu_torch.utils.timing import timeit_fifo

    pipe = trainer.train_pipe
    flip, policy, _ = pipe.draw(torch.Generator().manual_seed(SEED), packed.shape[0])
    with torch.inference_mode():
        pixels, geom, _, _ = pipe.decode(packed)
        img = pipe.resample(pixels, geom)
        aug = pipe.augment(img, flip, policy)
        parts = {"decode": (lambda x: pipe.decode(x)[0], (packed,)),
                 "residual resample": (pipe.resample, (pixels, geom)),
                 "flip + RandAugment": (pipe.augment, (img, flip, policy)),
                 "range": (to_unit_range, (aug,)),
                 "whole stage": (pipe, (packed, flip, policy))}
        ms = {name: 1e3 * timeit_fifo(fn, args, depth=3, repeats=3, warmup=1)
              for name, (fn, args) in parts.items()}
    print(f"rgb stage split (batch {packed.shape[0]}, 224 px): " + ", ".join(
        f"{name} {v:.3f} ms" for name, v in ms.items()), flush=True)
    del pixels, geom, img, aug

    n = RGB_STAGE_BATCH
    card_rows, cpu_rows = torch.from_numpy(rows[:n]).cuda(), torch.from_numpy(rows[:n])
    flip, policy = flip[:n], tuple(p[:n] for p in policy)
    with torch.inference_mode():
        px_card, geom_card, _, _ = pipe.decode(card_rows)
        px_cpu, geom_cpu, _, _ = pipe.decode(cpu_rows)
        dec = (px_card.cpu() - px_cpu).abs()
        res_card = pipe.resample(px_cpu.cuda(), geom_cpu.cuda()).cpu()
        res_cpu = pipe.resample(px_cpu, geom_cpu)
        res_err = float((res_card - res_cpu).abs().max())
        aug_card = pipe.augment(res_cpu.cuda(), flip, policy).cpu()
        aug_cpu = pipe.augment(res_cpu, flip, policy)
        aug_off = (aug_card - aug_cpu).abs()
        rng_err = float((to_unit_range(aug_cpu.cuda()).cpu() - to_unit_range(aug_cpu)).abs().max())
    share = float((dec > 0).float().mean())
    aug_share = float((aug_off > RGB_LEVEL_ATOL).float().mean())
    print(f"rgb stage card vs CPU at {n} images: decode max {float(dec.max()):.0f} level(s), "
          f"{share:.2e} of pixels apart; resample max abs err {res_err:.3e} levels; flip + "
          f"RandAugment {aug_share:.2e} of pixels beyond {RGB_LEVEL_ATOL} (max "
          f"{float(aug_off.max()):.3e}); range {rng_err:.3e}", flush=True)
    check(float(dec.max()) <= RGB_DECODE_ATOL and share <= RGB_DECODE_SHARE,
          f"rgb decode card vs CPU: max {float(dec.max())}, {share} of pixels apart")
    check(res_err <= RGB_LEVEL_ATOL, f"rgb resample card vs CPU: {res_err}")
    check(aug_share <= RGB_AUG_SHARE, f"rgb RandAugment card vs CPU: {aug_share} of pixels")
    check(rng_err == 0.0, f"rgb range card vs CPU: {rng_err}")


def phase_rgb(report: dict, index_train: str, index_val: str) -> None:
    """ViT-S/16 with ``--domain rgb`` at full width through
    ``RgbCroppedLoader`` and ``Trainer``: 1 + 5 train steps at the preset's
    batch of 1,024 (512 where that does not fit) with 12 #1, 12 #2 and no #5
    launch a step, finite losses, the step's peak memory and the input
    stage's own; one step card vs CPU at 2 images; the input stage split and
    card vs CPU; the kernels of a step; 512 images through the
    eval (12 #1 launches a batch); the host decode img/s at 1 and 8
    threads."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from rgbnomore_tpu_torch.data.index import load_index
    from rgbnomore_tpu_torch.data.loader import RgbCroppedLoader
    from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders

    for batch in RGB_BATCHES:
        cfg = rgb_config(batchsize=batch)
        m = cfg.model
        check(m.embed_size == 384 and m.depth == 12 and m.heads == 6 and m.head_size == 64
              and m.patch_size == 16 and m.input_size == 224, f"the vits preset changed: {m}")
        trainer = Trainer(cfg, device="cuda")
        embed = type(trainer.model.patchembed).__name__
        check(embed == "PatchEmbeddingRGB" and trainer.packed_k == 63
              and trainer.compute_dtype == torch.float32,
              f"rgb vits builds {embed} at K={trainer.packed_k} in {trainer.compute_dtype}")
        loaders = make_loaders(cfg, index_train, index_val, num_threads=8, global_batch=batch)
        t0 = time.perf_counter()
        rows = next(iter(loaders["train"]))["packed"]
        print(f"rgb vits: {batch} train rows of {rows.shape[1]} B decoded and packed in "
              f"{time.perf_counter() - t0:.2f} s (8 threads)", flush=True)
        trainer.create_state(steps_per_epoch=RGB_TRAIN_STEPS + 1)
        packed = trainer.put_batch({"packed": rows})["packed"]
        torch.cuda.reset_peak_memory_stats()
        try:
            train_path(report, "rgb vits train", trainer, packed, RGB_TRAIN_STEPS,
                       {"fused_attention": 12, "fused_attention_bwd": 12}, tensor_stage=True)
        except torch.cuda.OutOfMemoryError as exc:
            print(f"rgb vits train: batch {batch} does not fit one card: "
                  f"{str(exc).splitlines()[0]}", flush=True)
            del trainer, packed, exc
            gc.collect()
            torch.cuda.empty_cache()
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            trainer.train_pipe(packed, *trainer.train_pipe.draw(trainer.generator, batch))
        stage_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"rgb vits train: batch {batch}, peak memory {peak:.2f} GiB "
              f"(torch.cuda.max_memory_allocated); the input stage alone "
              f"{stage_peak:.2f} GiB above the resident state", flush=True)
        break
    else:
        check(False, f"rgb vits train: no batch of {RGB_BATCHES} fits one card")
    step_card_vs_cpu("rgb vits train", rgb_config(batchsize=RGB_CPU_BATCH),
                     rows[:RGB_CPU_BATCH], stage_from_cpu=True)
    rgb_stage_split(trainer, packed, rows)
    phase_train_breakdown(trainer, packed, "rgb vits breakdown")
    ds = load_index(index_train)
    eval_ldr = RgbCroppedLoader(ds, BATCH, size=224, k=63, mode="center", num_threads=8)
    batches = [b for _, b in zip(range(N_IMAGES // BATCH), eval_ldr)]
    rgb_eval(report, "rgb vits eval", trainer, batches, {"fused_attention": 12})
    del trainer, packed
    gc.collect()
    torch.cuda.empty_cache()
    rates = {}
    for threads in (1, 8):
        ldr = RgbCroppedLoader(ds, BATCH, size=224, k=63, mode="train", num_threads=threads)
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            ldr._decode_batch(pool, np.arange(BATCH))
            rates[threads] = BATCH / (time.perf_counter() - t0)
    print("rgb host decode (RgbCroppedLoader, train boxes, 224 px window, K=63): " + ", ".join(
        f"{t} thread(s) {r:.1f} img/s" for t, r in rates.items()), flush=True)


def phase_rgb_paths(report: dict, tmp: str, index_train: str, index_val: str) -> None:
    """The other RGB paths: SwinV2-T ``--domain rgb`` under its bf16 preset
    (its convolution stem; 1 + 2 steps with 12 #3 and 24 #4 launches a step,
    one eval batch with 12); ViT-Ti through ``transfer="dense"``
    (``RgbCanvasLoader``) and ``"packed"`` (``DctPackedLoader`` rows decoded
    by ``make_packed_rgb_decode``), 1 + 2 steps and an eval batch each; the
    train and eval CLIs with ``--domain rgb``; ``--benchmark 5`` with
    ``--domain rgb`` and with ``--model_arch swinv2`` (its drop path in the
    fwd+bwd step)."""
    import gc
    from pathlib import Path

    import torch

    from rgbnomore_tpu_torch.train.loop import Trainer, make_loaders

    cfg = rgb_config("swinv2", batchsize=SWIN_TRAIN_BATCH)
    check(cfg.model.input_size == 256 and cfg.model.patch_size == 4 and cfg.train.amp
          and cfg.model.drop_path == 0.2, f"the swinv2 RGB preset changed: {cfg.model}")
    paths = [("rgb swin", cfg, "cropped", {"window_attention": 12, "window_attention_bwd": 24},
              {"window_attention": 12})]
    for transfer in ("dense", "packed"):
        paths.append((f"rgb {transfer}", rgb_config("vitti", batchsize=BATCH), transfer,
                      {"fused_attention": 12, "fused_attention_bwd": 12},
                      {"fused_attention": 12}))
    for tag, cfg, transfer, per_step, per_batch in paths:
        trainer = Trainer(cfg, device="cuda", transfer=transfer)
        loaders = make_loaders(cfg, index_train, index_val, num_threads=8,
                               global_batch=cfg.train.batch_size, transfer=transfer)
        batch = next(iter(loaders["train"]))
        trainer.create_state(steps_per_epoch=RGB_PATH_STEPS + 1)
        inputs = trainer.upload(batch)
        embed = getattr(trainer.model, "patch_embed", None) or trainer.model.patchembed
        print(f"{tag}: {type(embed).__name__}, transfer {transfer}, {trainer.compute_dtype}",
              flush=True)
        train_path(report, f"{tag} train", trainer, inputs, RGB_PATH_STEPS, per_step,
                   tensor_stage=True)
        rgb_eval(report, f"{tag} eval", trainer, [next(iter(loaders["test"]))], per_batch)
        del trainer, inputs, batch
        gc.collect()
        torch.cuda.empty_cache()

    root = Path(__file__).resolve().parent
    weights = f"{tmp}/cli_rgb/vitti.pt"
    common = ["--domain", "rgb", "--model_arch", "vitti", "--indexpaths",
              f"{index_train},{index_val}", "--batch", str(BATCH), "--seed", str(SEED),
              "--num_cpus", "8", "--warmup_steps", "2", "--verbose", "0"]
    out = {}
    for name, args in (("rgb cli", ["-m", "rgbnomore_tpu_torch.cli", "--train", "--eval",
                                    "--epochs", "1", "--max_steps_per_epoch",
                                    str(TRAINER_STEPS), "--savepath", weights, *common]),
                       ("rgb eval cli", ["-m", "rgbnomore_tpu_torch.eval", "--loadpath",
                                         weights, *common]),
                       ("rgb benchmark", ["-m", "rgbnomore_tpu_torch.cli", "--benchmark", "5",
                                          "--domain", "rgb", "--indexpaths",
                                          f"{index_train},{index_val}", "--batch", "32",
                                          "--num_cpus", "8", "--verbose", "0"]),
                       ("swin benchmark", ["-m", "rgbnomore_tpu_torch.cli", "--benchmark", "5",
                                           "--model_arch", "swinv2", "--indexpaths",
                                           f"{index_train},{index_val}", "--batch", "32",
                                           "--num_cpus", "8", "--verbose", "0"])):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, *args], cwd=root, capture_output=True, text=True,
                             timeout=600)
        check(res.returncode == 0, f"{name}: exit {res.returncode}: {res.stderr[-4000:]}")
        out[name] = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{name}: python {' '.join(args[:2])} exited 0 in {time.perf_counter() - t0:.1f} s:"
              f" {out[name]}", flush=True)
    run, again = out["rgb cli"]["test"], out["rgb eval cli"]["test"]
    check(Path(weights).is_file() and run["count"] == again["count"] == BATCH
          and run["accuracy"] == again["accuracy"]
          and math.isclose(run["loss"], again["loss"], rel_tol=1e-6),
          f"rgb cli: the eval CLI scored {again}, the run {run}")
    six = {"train_loader_fps", "test_loader_fps", "model_fbp_fps", "model_fwd_fps",
           "train_pipeline_fps", "test_pipeline_fps"}
    for name in ("rgb benchmark", "swin benchmark"):
        check(set(out[name]) == six and all(v > 0 for v in out[name].values()),
              f"{name}: {out[name]}")


def phase_dct_ops(report: dict) -> None:
    """The DCT RandAugment ops outside the kernel's set: one ViT-Ti train
    step on the cropped DCT wire with ``--ops_list`` Rotate, ShearX, ShearY,
    Equalize, Solarize, Invert, FreqEnhance (the stage in tensor code: no #5
    launch; 12 #1 and 12 #2); its step on the card against the CPU (the
    same input stage) and its input stage card vs CPU; then each op forced
    on one batch, card vs CPU."""
    import torch

    from rgbnomore_tpu_torch.augment.randaugment import RandAugmentDCT
    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    def config(batch):
        return generate_config("vitti", "dct", modelver=1, batchsize=batch, seed=SEED,
                               epochs=1, warmup_steps=1, lr=3e-3, auglist=",".join(DCT_OPS))

    cfg = config(BATCH)
    trainer = Trainer(cfg, device="cuda")
    check(not trainer.train_pipe.fused and trainer.train_pipe.ops_list == DCT_OPS,
          f"dct ops: the pipeline is fused={trainer.train_pipe.fused}")
    trainer.create_state(steps_per_epoch=2)
    rng = np.random.default_rng(SEED + 14)
    rows = vit_rows(rng, BATCH, K_TRAIN)
    packed = trainer.put_batch({"packed": rows})["packed"]
    train_path(report, "dct ops train", trainer, packed, 1,
               {"fused_attention": 12, "fused_attention_bwd": 12}, tensor_stage=True)
    step_card_vs_cpu("dct ops train", config(CPU_GRAD_BATCH), rows[:CPU_GRAD_BATCH],
                     stage_from_cpu=True)
    cpu = Trainer(config(CPU_GRAD_BATCH), device="cpu")
    draws = cpu.draw(CPU_GRAD_BATCH)
    with torch.inference_mode():
        got = trainer.train_pipe(packed[:CPU_GRAD_BATCH], draws.flip, draws.policy)
        want = cpu.train_pipe(torch.from_numpy(rows[:CPU_GRAD_BATCH]), draws.flip, draws.policy)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    print(f"dct ops: input stage card vs CPU max abs err {err:.3e} on [-1, 1]", flush=True)
    check(err <= DCT_OPS_ATOL / 1020, f"dct ops: input stage card vs CPU {err}")
    y, c = synthetic_planes(rng, CPU_GRAD_BATCH, GRID)
    y, c = torch.from_numpy(y), torch.from_numpy(c)
    n = CPU_GRAD_BATCH
    sign = torch.tensor([1.0, -1.0] * (n // 2))[:, None]
    zeros = torch.zeros((n, 1), dtype=torch.int32)
    policy = (zeros, sign, zeros, zeros, torch.zeros((n, 1), dtype=torch.bool))
    errs = {}
    for op in DCT_OPS:
        aug = RandAugmentDCT(ops_list=[op], num_ops=1, magnitude=cfg.train.augstr, grid=GRID)
        with torch.inference_mode():
            gy, gc = aug.apply(y.cuda(), c.cuda(), tuple(p.cuda() for p in policy))
            wy, wc = aug.apply(y, c, policy)
        errs[op] = max(float((gy.cpu() - wy).abs().max()), float((gc.cpu() - wc).abs().max()))
        moved = float((wy - torch.clamp(y, -1024, 1016)).abs().max())
        check(errs[op] <= DCT_OPS_ATOL and moved > 1.0,
              f"dct ops: {op} card vs CPU max abs err {errs[op]}, moves the input by {moved}")
    print("dct ops: each op forced on " + f"{n} images, card vs CPU max abs err: " + ", ".join(
        f"{op} {e:.3e}" for op, e in errs.items()), flush=True)


# ------------------------------------------------------- harness (module 7)
def logits_card_vs_cpu(tag: str, trainer, cpu_model, rows: np.ndarray) -> float:
    """The eval pipeline on the card, then the logits of ``trainer.model``
    on the card against ``cpu_model`` on the CPU on the same planes; returns
    the max abs error (checked at ``LOGIT_TOL``)."""
    import torch

    with torch.inference_mode():
        y, c, _, _ = trainer.eval_pipe(trainer.put_batch({"packed": rows})["packed"])
        got = trainer.model.eval()(y, c).cpu()
        want = cpu_model.eval()(y.cpu(), c.cpu())
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, **LOGIT_TOL),
          f"{tag}: logits card vs CPU max abs err {err} beyond {LOGIT_TOL}")
    return err


def flops_card_vs_cpu(tag: str, card_model, cpu_model, cfg) -> float:
    """``model_flops`` at batch 1 on the card and on the CPU: equal, or the
    phase fails; returns the count."""
    from rgbnomore_tpu_torch.train.config import example_inputs
    from rgbnomore_tpu_torch.utils.profiling import model_flops

    card = model_flops(card_model, *example_inputs(cfg, 1, device="cuda"))
    cpu = model_flops(cpu_model, *example_inputs(cfg, 1, device="cpu"))
    check(card == cpu and card > 0, f"{tag}: model_flops {card} on the card, {cpu} on the CPU")
    return card


def timed_steps(trainer, packed, steps: int) -> float:
    """Seconds a train step over ``steps`` steps after a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(packed)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def harness_import(report: dict, tmp: str, card: str) -> str:
    """(a) A reference-named ViT-S/16 (the CLI's default, embed_type 2) as
    a bare ``.pth`` and as an epoch checkpoint with ``module.`` names:
    ``load_torch_checkpoint`` gives one state dict from both, which the
    port's model loads strictly; 512 images through ``Trainer.evaluate`` (1
    wire and 12 #1 launches a batch) and 4 images' logits card vs CPU; the
    same for SwinV2-T through ``import_swin_state_dict``, one eval batch (12
    #3 launches).  (b) ``model_flops`` on the card equal to the CPU's for
    both, GFLOP per image, and the achieved TFLOP/s of the imported ViT-S's
    train step at the preset's batch (3 x forward FLOPs x batch / step
    time) and of both evals.  Returns the imported ViT-S's weights file."""
    import gc

    import torch

    from rgbnomore_tpu_torch.train.config import build_model
    from rgbnomore_tpu_torch.train.loop import Trainer
    from rgbnomore_tpu_torch.train.torch_import import (
        import_swin_state_dict,
        load_torch_checkpoint,
    )

    cfg = vits_config(batchsize=VITS_BATCHES[0])
    cpu_model = build_model(cfg, device="cpu")
    rules = VIT_REFERENCE_NAMES + VIT_EMBED_REFERENCE_NAMES[(2, True)]
    ref = reference_state_dict(cpu_model, rules, np.random.default_rng(SEED + 20), 0.02)
    torch.save(ref, f"{tmp}/vits.pth")
    torch.save({"epoch": 0, "model_state_dict": {f"module.{k}": v for k, v in ref.items()}},
               f"{tmp}/vits_epoch.ckpt")
    m = cfg.model
    kw = dict(num_heads=m.heads, head_size=m.head_size, depth=m.depth, ver=m.version,
              use_subblock=m.subblock)
    sd = load_torch_checkpoint(f"{tmp}/vits.pth", **kw)
    other = load_torch_checkpoint(f"{tmp}/vits_epoch.ckpt", **kw)
    check(sd.keys() == other.keys() and all(torch.equal(sd[k], other[k]) for k in sd),
          "import: the epoch checkpoint imports to other tensors than the bare .pth")
    cpu_model.load_state_dict(sd, strict=True)
    trainer = Trainer(cfg, device="cuda")
    trainer.model.load_state_dict(sd, strict=True)
    eval_path(report, "import vits eval", trainer, {"fused_attention": 12})
    rng = np.random.default_rng(SEED + 21)
    err = logits_card_vs_cpu("import vits", trainer, cpu_model,
                             vit_rows(rng, HARNESS_CPU_IMAGES, K_EVAL))
    weights = f"{tmp}/vits_imported.pt"
    torch.save(trainer.model.state_dict(), weights)
    print(f"import: ViT-S/16 (embed_type 2) from a reference-named .pth and an epoch "
          f"checkpoint ({len(ref)} tensors), loaded strictly; logits card vs CPU max abs err "
          f"{err:.3e} on {HARNESS_CPU_IMAGES} images", flush=True)

    vits_flops = flops_card_vs_cpu("vits", trainer.model, cpu_model, cfg)
    batch = cfg.train.batch_size
    eval_rows = [{"packed": vit_rows(rng, BATCH, K_EVAL)}]
    trainer.evaluate(eval_rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.evaluate(eval_rows)
    vits_eval_s = time.perf_counter() - t0
    trainer.create_state(steps_per_epoch=HARNESS_STEPS + 1)
    packed = trainer.put_batch({"packed": vit_rows(rng, batch, K_TRAIN)})["packed"]
    trainer.train_step(packed)  # warm-up
    reset_launches()
    with plain_unpacks() as unpacks:
        step_s = timed_steps(trainer, packed, HARNESS_STEPS)
    launches = all_launches()
    check_input_stage(report, "import_vits_train", launches, len(unpacks),
                      train_steps=HARNESS_STEPS)
    check_launches("import vits train", launches,
                   {"fused_attention": 12 * HARNESS_STEPS,
                    "fused_attention_bwd": 12 * HARNESS_STEPS})
    record_launches(report, "import_vits_train", launches)
    del trainer, packed
    gc.collect()
    torch.cuda.empty_cache()

    cfg = swin_config(SWIN_EVAL_BATCH)
    cpu_model = build_model(cfg, device="cpu")
    ref = reference_state_dict(cpu_model, SWIN_REFERENCE_NAMES, np.random.default_rng(SEED + 22),
                               0.02)
    sd = import_swin_state_dict(ref, depths=tuple(cfg.model.depth))
    cpu_model.load_state_dict(sd, strict=True)
    trainer = Trainer(cfg, device="cuda")
    trainer.model.load_state_dict(sd, strict=True)
    rows = vit_rows(rng, SWIN_EVAL_BATCH, K_EVAL, grid=SWIN_GRID)
    trainer.evaluate([{"packed": rows}])  # warm-up
    reset_launches()
    with plain_unpacks() as unpacks:
        t0 = time.perf_counter()
        res = trainer.evaluate([{"packed": rows}])
        swin_eval_s = time.perf_counter() - t0
    launches = all_launches()
    check_input_stage(report, "import_swin_eval", launches, len(unpacks), eval_batches=1)
    check_launches("import swin eval", launches, {"window_attention": 12})
    record_launches(report, "import_swin_eval", launches)
    check(res["count"] == SWIN_EVAL_BATCH and math.isfinite(res["loss"]),
          f"import swin eval gave {res}")
    err = logits_card_vs_cpu("import swin", trainer, cpu_model, rows[:HARNESS_CPU_IMAGES])
    print(f"import: SwinV2-T from a reference-named state dict through "
          f"import_swin_state_dict, eval {res}; logits card vs CPU max abs err {err:.3e} "
          f"on {HARNESS_CPU_IMAGES} images", flush=True)
    swin_flops = flops_card_vs_cpu("swinv2", trainer.model, cpu_model, cfg)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    print(f"profiling: model_flops card == CPU: ViT-S/16 {vits_flops / 1e9:.6f} and SwinV2-T "
          f"{swin_flops / 1e9:.6f} GFLOP an image (forward); {card}", flush=True)
    print(f"profiling: ViT-S/16 train step at batch {batch}: {step_s * 1e3:.3f} ms, "
          f"{3 * vits_flops * batch / step_s / 1e12:.2f} TFLOP/s achieved (3 x forward); eval "
          f"(upload + pipeline + forward) at {BATCH}: "
          f"{vits_flops * BATCH / vits_eval_s / 1e12:.2f} TFLOP/s; SwinV2-T eval at "
          f"{SWIN_EVAL_BATCH}: {swin_flops * SWIN_EVAL_BATCH / swin_eval_s / 1e12:.2f} "
          f"TFLOP/s; {card}", flush=True)
    return weights


def read_trace(logdir: str) -> dict:
    """The one trace file in ``logdir``: its path, how often it names each
    kernel of ``TRACE_KERNELS``, its device kernels, its host launches, the
    port's spans (``port_spans``), the
    times into its window of the launches with no kernel (matched by
    correlation id), and each kernel's start on the device's clock less its
    launch's on the host's, in µs."""
    import collections
    import glob

    files = glob.glob(f"{logdir}/*.pt.trace.json")
    check(len(files) == 1, f"trace: {files} in {logdir}, want one trace file")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    pattern = re.compile(r"::(" + "|".join(TRACE_KERNELS) + r")\b")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = collections.Counter(m.group(1) for e in kernels
                               for m in [pattern.search(e.get("name", ""))] if m)
    started = {e["args"].get("correlation"): e["ts"] for e in kernels}
    launched = [e for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]]
    t0 = min(e["ts"] for e in events if e.get("ph") == "X")
    return {"path": files[0], "seen": dict(seen), "kernels": len(kernels),
            "launches": len(launched), "spans": port_spans(events),
            "dropped": [e["ts"] - t0 for e in launched
                        if e["args"].get("correlation") not in started],
            "lags": [started[e["args"]["correlation"]] - e["ts"] for e in launched
                     if e["args"].get("correlation") in started]}


def harness_trace(report: dict, tmp: str, card: str) -> None:
    """(b) ``utils/profiling.trace`` over 3 ViT-Ti train steps at batch 256:
    one trace file, which names #1's, #2's three and #5w's kernels exactly
    as many times as their launch counters say, and holds every port span
    of a train step (``VIT_STEP_SPANS``) as often a step inside its
    ``rgbnm.step``; the step's achieved
    TFLOP/s from 3 steps timed without the profiler.  Each trace follows a
    profiler session of the CUDA activity alone (``device_ms``); late in
    this script a bare ``torch.profiler`` session then lost the first fifty
    or so kernels of its block on the H100 (``tools/trace_drop_ab.py``), so
    one bare session is read beside ``trace``'s."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from rgbnomore_tpu_torch.train.config import build_model, example_inputs, generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer
    from rgbnomore_tpu_torch.utils.profiling import model_flops, trace

    cfg = generate_config("vitti", "dct", modelver=1, batchsize=BATCH, seed=SEED, epochs=1,
                          warmup_steps=1)
    flops = model_flops(build_model(cfg, device="cpu"), *example_inputs(cfg, 1, device="cpu"))
    trainer = Trainer(cfg, device="cuda")
    trainer.create_state(steps_per_epoch=4 * HARNESS_STEPS + 8)
    packed = trainer.put_batch({"packed": vit_rows(np.random.default_rng(SEED + 23), BATCH,
                                                   K_TRAIN)})["packed"]
    trainer.train_step(packed)  # warm-up
    step_s = timed_steps(trainer, packed, HARNESS_STEPS)
    device_ms(lambda: trainer.train_step(packed), reps=1)
    with plain_unpacks(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                  on_trace_ready=tensorboard_trace_handler(f"{tmp}/bare")):
        timed_steps(trainer, packed, HARNESS_STEPS)
    bare = read_trace(f"{tmp}/bare")
    device_ms(lambda: trainer.train_step(packed), reps=1)
    logdir = f"{tmp}/trace"
    reset_launches()
    with plain_unpacks() as unpacks, trace(logdir):
        timed_steps(trainer, packed, HARNESS_STEPS)
    launches = all_launches()
    check_input_stage(report, "harness_trace", launches, len(unpacks), train_steps=HARNESS_STEPS)
    check_launches("harness trace", launches, {"fused_attention": 12 * HARNESS_STEPS,
                                               "fused_attention_bwd": 12 * HARNESS_STEPS})
    record_launches(report, "harness_trace", launches)
    got = read_trace(logdir)
    want = {name: launches[counter] for name, counter in TRACE_KERNELS.items()}
    for tag, t in (("a bare torch.profiler session", bare), ("utils/profiling.trace", got)):
        lags = t["lags"]
        print(f"trace: {tag}: {t['launches']} launches on the host, {len(t['dropped'])} with "
              f"no kernel (at {[round(x) for x in t['dropped'][:4]]} us into the window); names "
              f"{t['seen']}; kernel start less launch: least "
              f"{min(lags, default=float('nan')):.1f} us, median "
              f"{statistics.median(lags) if lags else float('nan'):.1f} us", flush=True)
    check(got["seen"] == want, f"trace: the kernels named {got['seen']} times, want {want}")
    steps, outside = spans_per_step(got["spans"])
    check(len(steps) == HARNESS_STEPS and not outside
          and all(st["spans"] == VIT_STEP_SPANS for st in steps),
          f"trace: port spans a step {steps} (outside any step: {outside}), want "
          f"{HARNESS_STEPS} steps of {VIT_STEP_SPANS}")
    print(f"trace: {HARNESS_STEPS} rgbnm.step spans (steps {[st['index'] for st in steps]}), "
          f"each over {VIT_STEP_SPANS}", flush=True)
    print(f"trace: {os.path.basename(got['path'])} ({os.path.getsize(got['path']) / 2**20:.1f} "
          f"MiB, {got['kernels']} device kernels in 3 ViT-Ti steps) names {got['seen']}, as the "
          f"launch counters say", flush=True)
    print(f"profiling: ViT-Ti {flops / 1e9:.6f} GFLOP an image (forward); train step at batch "
          f"{BATCH}: {step_s * 1e3:.3f} ms, {3 * flops * BATCH / step_s / 1e12:.2f} TFLOP/s "
          f"achieved (3 x forward); {card}", flush=True)


def run_cli(tag: str, args: list[str]) -> tuple[dict, str]:
    """``python -m <args>`` from the checkout's root: exit 0, or the phase
    fails; returns its last line's JSON and its standard error."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *args], cwd=root, capture_output=True,
                         text=True, timeout=600)
    check(res.returncode == 0, f"{tag}: exit {res.returncode}: {res.stderr[-4000:]}")
    print(f"{tag}: python -m {args[0]} exited 0 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return json.loads(res.stdout.strip().splitlines()[-1]), res.stderr


def harness_cli(tmp: str, vits_weights: str) -> None:
    """(d) ``--stage_data`` on ILSVRC-shaped tars: every staged JPEG 512x512
    in 4:2:0, the val images in their classes' directories; the index CSVs
    (``build_index_csv``).  (c) The eval CLI at ``--verbose 2`` on the
    imported ViT-S/16's weights over the staged val split logs the model
    summary, whose total is the model's parameter count.  (d) ViT-Ti trains
    one epoch on the staged corpus and is scored, through the CLI."""
    from rgbnomore_tpu_torch import codec
    from rgbnomore_tpu_torch.data.staging import build_index_csv, load_valprep_mapping
    from rgbnomore_tpu_torch.train.config import build_model

    src = str(write_imagenet_tars(tmp, np.random.default_rng(SEED + 24), STAGE_CLASSES,
                                  STAGE_PER_CLASS, STAGE_VAL, size=(320, 240)))
    staged = f"{tmp}/staged"
    run_cli("stage", ["rgbnomore_tpu_torch.cli", "--stage_data", "--datapath", src,
                      "--temp_datapath", staged, "--num_cpus", "8"])
    mapping = load_valprep_mapping()
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(staged) for f in fs)
    want_val = {f"{staged}/val/{mapping[n]}/{n}" for n in val_names(STAGE_VAL)}
    check(len(files) == len(STAGE_CLASSES) * STAGE_PER_CLASS + STAGE_VAL
          and want_val <= set(files), f"stage: staged {files}")
    for path in files:
        _, _, y, cbcr = codec.read_coefficients(path)
        check(y.shape == (1, 64, 64, 8, 8) and cbcr is not None
              and cbcr.shape == (2, 32, 32, 8, 8),
              f"stage: {path} has luma {y.shape}, chroma {None if cbcr is None else cbcr.shape}")
    index = {}
    for split in ("train", "val"):
        index[split] = f"{tmp}/staged_{split}.csv"
        build_index_csv(staged, index[split], split)
    print(f"stage: {len(files)} JPEGs staged at 512x512 4:2:0, val split into "
          f"{len({os.path.dirname(p) for p in want_val})} class directories", flush=True)

    indexpaths = f"{index['train']},{index['val']}"
    common = ["--indexpaths", indexpaths, "--batch", str(STAGE_BATCH), "--num_cpus", "8",
              "--seed", str(SEED)]
    out, err = run_cli("summary", ["rgbnomore_tpu_torch.eval", "--loadpath", vits_weights,
                                   "--verbose", "2", *common])
    n_params = sum(p.numel() for p in build_model(vits_config(), device="cpu").parameters())
    check(f"Total Parameters: {n_params:,} " in err and "PatchEmbeddingDCTSeparateSubblock" in err
          and out["test"]["count"] == STAGE_VAL,
          f"summary: the eval CLI's log has no table totalling {n_params:,}: {err[-3000:]}")
    print(f"summary: the eval CLI at --verbose 2 logged the model summary, Total Parameters: "
          f"{n_params:,} (ViT-S/16 embed_type 2); the imported weights scored {out['test']} on "
          f"the staged val split", flush=True)
    weights = f"{tmp}/staged_vitti.pt"
    out, _ = run_cli("staged train", [
        "rgbnomore_tpu_torch.cli", "--train", "--eval", "--model_arch", "vitti",
        "--embed_type", "1", "--epochs", "1", "--warmup_steps", "1", "--savepath", weights,
        "--verbose", "1", *common])
    check(os.path.isfile(weights) and len(out["history"]) == 1
          and math.isfinite(out["history"][0]["train_loss"])
          and out["test"]["count"] == STAGE_VAL,
          f"staged train: {out}")
    print(f"staged train: ViT-Ti, one epoch on the staged corpus: train loss "
          f"{out['history'][0]['train_loss']:.4f}, test {out['test']}", flush=True)


def phase_harness(report: dict) -> None:
    """The rest of the harness (module 7): the reference ``.pth`` import,
    ``model_flops`` and the trace, the model summary, ``--stage_data``."""
    import tempfile

    from rgbnomore_tpu_torch.ops.cuda_build import BUILD_DIR

    t0 = time.perf_counter()
    card = phase_card()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        weights = harness_import(report, tmp, card)
        harness_trace(report, tmp, card)
        harness_cli(tmp, weights)
    print(f"harness: {time.perf_counter() - t0:.1f} s", flush=True)

def phase_swinv2b(report: dict) -> None:
    """SwinV2-B at window 16 under its own preset (``generate_config(
    "swinv2b", "dct")``: bf16 AMP, embed 128, depths (2, 2, 18, 2), heads
    (4, 8, 16, 32), window 16, drop path 0.5) at batch 256 on the K=16
    wire: 1 + 10 train steps on one repeated batch (warmup 1, lr 1e-3), the
    counters read after each counted step: #3L 22 and #4L 88 (22 calls x 4
    kernels), #3 2 and #4 4 (stage 4's blocks), #6 23 / 23 / 23 (the float32
    qkv products), 77 bf16 products on ``F.linear``, one wire launch, no ViT
    attention; finite falling losses; the peak memory; then one eval batch
    of 256 (#3L 22, #3 2, #6 23)."""
    import torch

    from rgbnomore_tpu_torch.train.config import generate_config
    from rgbnomore_tpu_torch.train.loop import Trainer

    torch.cuda.empty_cache()
    cfg = generate_config("swinv2b", "dct", batchsize=SWINB_BATCH, seed=SEED, epochs=1,
                          warmup_steps=1, lr=1e-3)
    m = cfg.model
    check(m.arch == "swinv2" and m.embed_size == 128 and tuple(m.depth) == (2, 2, 18, 2)
          and tuple(m.heads) == (4, 8, 16, 32) and m.window_size == 16 and m.drop_path == 0.5
          and m.dct_blocks == SWIN_GRID and cfg.train.amp and m.amp_dtype == "bf16",
          f"the swinv2b preset changed: {m}")
    trainer = Trainer(cfg, device="cuda")
    check(abs(trainer.model.drop_path_rates[-1] - 0.5) < 1e-9, "swinv2b drop path is not 0.5")
    trainer.create_state(steps_per_epoch=SWINB_TRAIN_STEPS + 1)
    rng = np.random.default_rng(SEED + 9)
    packed = trainer.put_batch({"packed": vit_rows(rng, SWINB_BATCH, K_TRAIN,
                                                   grid=SWIN_GRID)})["packed"]
    want = {"window_attention_tiled": 22, "window_attention_tiled_bwd": 88,
            "window_attention": 2, "window_attention_bwd": 4}
    # 23 float32 qkv products; 76 bf16 Linears and the first qkv a forward
    train_path(report, "swinv2b train", trainer, packed, SWINB_TRAIN_STEPS, want,
               linear=(23, 23, 23, 77))
    for name, n in want.items():
        report[name].setdefault("launches_by_path", {})["swinv2b_train_step"] = n
    eval_path(report, "swinv2b eval", trainer, {"window_attention_tiled": 22,
                                                "window_attention": 2},
              vit_rows(rng, SWINB_BATCH, K_EVAL, grid=SWIN_GRID), linear=(23, 0, 0, 77))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import rgbnomore_tpu_torch  # noqa: F401  (fails here when run outside a checkout)

    # a float32 reference compares in float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--determinism"]:
        return determinism_child()
    if len(sys.argv) == 3 and sys.argv[1] == "--trainer":
        return trainer_child(json.loads(sys.argv[2]))
    if sys.argv[1:] == ["--ddp"]:
        return ddp_child()
    print(phase_card(), flush=True)
    phase_build()
    report = phase_kernels()
    trainer, batch = phase_slice(report)
    phase_breakdown(trainer, batch)
    del trainer
    trainer, packed, vit_rows = phase_train(report)
    phase_train_vs_cpu(vit_rows)
    phase_train_breakdown(trainer, packed)
    del trainer, packed
    trainer, batch = phase_swin_eval(report)
    phase_breakdown(trainer, batch, "swin breakdown")
    phase_codec(trainer)
    del trainer, batch
    trainer, packed, rows = phase_swin_train(report)
    step_card_vs_cpu("swin train", swin_config(SWIN_CPU_BATCH), rows[:SWIN_CPU_BATCH],
                     perturb_norms)
    phase_train_breakdown(trainer, packed, "swin breakdown")
    del trainer, packed
    trainer, packed, rows = phase_vitb(report)
    step_card_vs_cpu("vitb train", vitb_config(batchsize=VITB_CPU_BATCH), rows[:VITB_CPU_BATCH],
                     loss_rtol=BF16_LOSS_RTOL, grad_rtol=BF16_GRAD_RTOL)
    phase_train_breakdown(trainer, packed, "vitb breakdown")
    del trainer, packed
    trainer, packed = phase_swin_amp(report)
    phase_train_breakdown(trainer, packed, "swin amp breakdown")
    del trainer, packed
    phase_fp16(report)
    phase_determinism()
    phase_dropout_cost(vit_rows)
    from rgbnomore_tpu_torch.ops.cuda_build import BUILD_DIR

    phase_vits(report)
    phase_embed(report)
    phase_ape(report)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        index_train, index_val = write_trainer_corpus(tmp)
        phase_trainer(tmp, index_train, index_val)
        phase_ddp()
        phase_cli(tmp, index_train, index_val)
        phase_packed(report, index_train, index_val)
        phase_benchmark(index_train, index_val)
        phase_rgb(report, index_train, index_val)
        phase_rgb_paths(report, tmp, index_train, index_val)
    phase_dct_ops(report)
    phase_harness(report)
    phase_swinv2b(report)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
