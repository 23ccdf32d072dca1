#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dl4ds_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs nvcc

Phases, each of which exits non-zero on failure:
  1. check for a CUDA device, print the card's name and power limit, build
     every kernel from `dl4ds_tpu_torch/csrc/` with nvcc (one process per
     source, all started together);
  2. hold K1 (the channel-attention gate) against its plain PyTorch version
     on the card at the shapes the flagship path gives it (f32 and bf16),
     forward and backward (the backward against the plain version run in
     float64, each gradient within 1e-5 of its max |ref|, the same bits
     twice), also at the training gates' shapes and on its other paths; check
     that the shapes ran every regime of its launch plan (block, stream)
     and that each launches the kernels it should (the kernel
     library's own count of its launches);
     time both directions with CUDA events, and check the gate's autograd
     backward;
  3. drive the flagship path: full-width `predict` of the resnet_spc x4
     model (128x128 LR -> 512x512 HR, 2 static variables, 1 predictor) on 16
     grids at batch 8, count the kernel launches it made, and compare grid 0
     with the same model and weights run on the CPU;
  4. hold K2 (the ConvLSTM layer, inference variant) against its plain
     version with TF32 off at the six layer shapes of the recresnet_spc
     model and at width 64, time both, check its other paths (T = 1, the
     input launch alone; other kernel sizes; channel counts that are not
     multiples of 4 or 8; Cin 1 and 2; F 4, 5, 12 and 72; frames of 5x7
     and 17x17 and wider than a tile; both channel slices, chunk widths
     and stage depths of the launch plan) and that its bits repeat, and
     check that a layer whose weights require grad runs K2's training
     variant and K3 for its gradient;
  5. drive the spatio-temporal path: full-width `predict(time_window=4)` of
     the recresnet_spc x4 model on 19 grids (16 windows of 4) at batch 8,
     count its launches, and compare grid 0 and the last 4 grids with the
     same model run on the CPU;
  6. hold K2's training variant (ys and the cs, zs residuals) and K3 (the
     BPTT backward: dx, dWx, dbx, dWh; the chain steps and dx in the tile
     of csrc/convlstm_seq.cu, the weight gradients in csrc/convlstm_bwd.cu)
     against their plain versions with TF32 off at the six layer shapes of
     a recresnet_spc training step (batch 128, T 4, 16x16 LR patches), at
     width 64 and on their other paths (T = 1, odd F, F = 12, 1x3, 3x5, 7x7
     and 9x9 kernels, ragged tiles, 5x7 and 17x17 frames with Cin 1 and 2,
     x without a gradient, dx at 16 and 32 channels a block), check that
     two runs of K2-train and of K3 give the same bits, and time both
     kernels against their plain versions and their two bounds (float32,
     3xTF32), K3 also by launch kind (chain, dx, weight gradients, reduce;
     torch.profiler); then hold K4 (the same chain steps, writing dzs)
     against its plain version run in float64 and the split route (K4, then
     the float32 GEMM tail) against the plain BPTT in float64, at the six
     layer shapes of the width-64 training step and on K4's other paths
     (T = 1, odd F, F = 12, 16, 32 and 72, 1x3, 3x5 and 7x7), with K2's
     training variant that feeds them, check that their bits repeat, time
     K2-train, K4 and the tail against their bounds and K2-train and K4
     against their plain versions, and check that the shapes ran every
     compiled body and stage kind of the chain-step and dx tile;
  7. drive recurrent training: `SupervisedTrainer(time_window=4)` on the
     recresnet_spc x4 configuration of bench_suite.py (256 grids of
     128x128, 64x64 patches, batch 128, mae) for 2 epochs of 20 steps with
     validation and test, count the launches of K2 (both variants), K3 and
     K4 against what `dispatch_info` routes, require finite losses, time the
     steps (patches/s on the host clock, one step on CUDA events), then run
     3 steps at batch 16 from one seed on the GPU (TF32 off, PyTorch's own
     convolutions) and on the CPU in float64 and compare the losses and
     the parameters;
  8. drive the same training at width 64 (bench_suite.py's
     recresnet_spc_width64: n_filters 64, attention) for 2 epochs of 10
     steps at batch 128, print each ConvLSTM layer's route, count the
     launches against the routes, require finite losses, time the steps,
     and compare 3 steps at batch 4 on the GPU with the CPU;
  9. hold K6 (the fused per-image SSIM) against its plain version run in
     float64 at the DSSIM loss's shape in a flagship training step
     ([128, 64, 64, 1]) and on its other paths (the minimal 11x11 image,
     ragged tiles, a 512x512 grid, channels folded, a 5-D input, other
     filter sizes), and its backward against `ssim_backward_reference` in
     float64 for both images and max_val; check that its bits repeat, that
     both regimes (image, tiles) ran each way and launched what they should,
     time it against its plain version and its bound, and check dssim_mae's
     value and y_pred gradient through K6 against the same loss on the plain
     path (CPU);
 10. drive the flagship training: `SupervisedTrainer('resnet', 'spc',
     scale=4, patch_size=64, batch_size=128, n_filters=8, n_blocks=6,
     attention=True, loss='dssim_mae')` (bench.py's configuration) on 256
     grids of 128x128 for 2 epochs of 20 steps with validation and test;
     first hold and time K1 at the step's gate shapes (forward and
     backward against their plain versions), then count the launches of K1
     (its gates per forward x the forwards; its backward a gate a training
     step) and K6 (one a loss each way), require finite losses, time the
     steps, and compare 3 steps at batch 16 on the GPU (PyTorch's own
     convolutions) with the CPU in float64;
 11. print the `kernels` JSON line, then, last, the device JSON line.

Imports nothing of JAX. Weights come from the port's own seeded init.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
# 3xTF32: three TF32 products for each float32 one, at the 495 TFLOP/s of
# dense TF32 on the tensor cores (K2's products)
TF32X3_FLOPS = 495e12 / 3
BATCH = 8
LR, SCALE = 128, 4
N_FILTERS, N_BLOCKS = 8, 6
N_GRIDS = 16
# per-sample gate shapes (H, W, C) of one flagship forward: six residual
# blocks at LR, then the output head at HR
K1_SHAPES = ([(LR, LR, N_FILTERS * (i + 1)) for i in range(N_BLOCKS)]
             + [(LR * SCALE, LR * SCALE, N_FILTERS)])
K1_TOL = {'float32': dict(atol=1e-5, rtol=0.0),      # f32 sum order only
          'bfloat16': dict(atol=1e-6, rtol=1e-2)}    # ~2 bf16 ulps
# K1's backward against `_channel_attention_backward` run in float64 on the
# same inputs: each gradient's max |d| within K1_BWD_TOL of its max |ref|
# (float32 sums over up to 512*512 pixels and 128 samples); a bfloat16 dx is
# rounded to bfloat16, half an ulp: up to BF16_RTOL of |ref| more
K1_BWD_TOL, BF16_RTOL = 1e-5, 2.0 ** -8
# The serving head's weight gradients (K1_SHAPES[-1] at batch 8) sum 8
# per-sample terms of about +-300 to a few units (db1 3.5), so the terms'
# float32 rounding exceeds K1_BWD_TOL of max |ref| (float32 db1 4.6e-5 from
# float64 on the H100); there the scale is the largest sum of the samples'
# terms in magnitude (`_check_k1_backward`), both readings printed.
K1_CANCELLING = (BATCH,) + K1_SHAPES[-1]
# K1's other paths, ((B, H, W, C), Cr): H*W*C not a multiple of a 16-byte
# pack (4-byte copies), samples of 35 and 561 pixels, a channel
# count whose pack period passes the block's 512 threads (a thread sums a
# whole channel), Cr 1; float32 and bfloat16 each, with the weights at the
# model's Glorot scale (at 0.5, C = 1030 puts the gate's pre-activations in
# the hundreds, where two float32 orders of its 1030-term dot products
# already differ by more than K1_TOL)
K1_OTHER_PATHS = [((3, 5, 7, 5), 2), ((1, 33, 17, 3), 1),
                  ((1, 4, 4, 1030), 257), ((2, 9, 9, 600), 150)]
# the regimes of K1's launch plan (`_ca_plan`), every one of which phase 2
# must run, and the kernel launches a call of each makes, each way
CA_REGIMES = {'block': 1, 'stream': 2}
# GPU (TF32 off) vs CPU forward of the whole model: f32 convs summed in
# other orders over ~20 layers, as in the CPU parity tests against JAX
PREDICT_TOL = dict(atol=1e-4, rtol=1e-4)
# spatio-temporal path: recresnet_spc x4 (BASELINE config 4), 2 recurrent
# blocks after the stem, 16 windows of 4 from 19 grids
REC_T, REC_BLOCKS, REC_GRIDS = 4, 2, 19
# (Cin, F, k) of the six ConvLSTM layers of one forward: the stem block
# takes the grid and the predictor, every block is a 5x5 then a 3x3 layer
K2_LAYERS = [layer for cin in [2] + [N_FILTERS] * REC_BLOCKS
             for layer in ((cin, N_FILTERS, 5), (N_FILTERS, N_FILTERS, 3))]
K2_WIDE = [(64, 64, 5), (64, 64, 3)]    # production width, bench_suite.py
K2_WIDE_LR = 32
# (B, T, H, W, Cin, F, kh, kw) of the kernel's other paths: T = 1 (the input
# launch alone), 1x3 and 7x7 kernels, channel counts that are not multiples
# of 4 (4-byte copies), frames of 5x7 and 17x17 (pixel counts that are not
# a multiple of the tile) and wider than a tile, Cin 1 and 2 (one k-step a
# stage), F 4, 5, 12 and 72 (channels past F in the last slice). With the
# shapes above they run both channel slices (8 and 16 channels a block),
# both chunk widths and both stage depths of the launch plan.
K2_OTHER_PATHS = [(2, 1, 9, 41, 3, 6, 1, 3), (4, 1, 16, 16, 8, 72, 5, 5),
                  (8, 3, 72, 100, 4, 4, 5, 5), (8, 3, 72, 100, 5, 5, 7, 7),
                  (8, 2, 40, 40, 6, 12, 3, 3), (4, 3, 5, 7, 1, 4, 3, 3),
                  (4, 3, 17, 17, 2, 5, 5, 5), (64, 2, 17, 17, 1, 12, 5, 5),
                  (16, 3, 5, 7, 2, 72, 3, 3), (32, 2, 16, 16, 64, 72, 5, 5),
                  (128, 2, 16, 16, 16, 16, 7, 7)]
# kernel vs plain version with TF32 off: f32 sums in another order. The
# training variant's zs residual (the pre-activations, sums of up to
# kh*kw*(Cin + F) products, printed with their max |zs|) is held to
# K2_TOL times max(1, max |zs|)
K2_TOL = 1e-5
# training path: recresnet_spc x4 trained as bench_suite.py's
# measure_supervised does (256 grids of 128x128, 64x64 HR patches, batch
# 128, mae), float32; 2 epochs of 20 steps, 2 validation and 2 test steps
TRAIN_GRIDS, TRAIN_HR, TRAIN_PATCH, TRAIN_BATCH = 256, 128, 64, 128
TRAIN_LR = TRAIN_PATCH // SCALE
TRAIN_EPOCHS, TRAIN_STEPS, TRAIN_VAL_STEPS, TRAIN_TEST_STEPS = 2, 20, 2, 2
# the K1 gates of a flagship training step (batch 128, 16x16 LR patches):
# six residual blocks at C = 8..48, then the 64x64x8 head; phase 10 checks
# them against the model's own gates
K1_TRAIN_SHAPES = ([(TRAIN_BATCH, TRAIN_LR, TRAIN_LR, N_FILTERS * (i + 1))
                    for i in range(N_BLOCKS)]
                   + [(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, N_FILTERS)])
# (Cin, F, k) of the six ConvLSTM layers of a training step: the stem block
# takes the one grid channel (no predictors, no statics)
K3_LAYERS = [layer for cin in [1] + [N_FILTERS] * REC_BLOCKS
             for layer in ((cin, N_FILTERS, 5), (N_FILTERS, N_FILTERS, 3))]
# (B, T, H, W, Cin, F, kh, kw, x needs a gradient) of K2-train's and K3's
# other paths: T = 1 (no chain, no dWh), 1x3 and odd F (4-byte copies in
# the chain, dx and weight-gradient tiles), 3x5 with ragged tiles, 5x7 and
# 17x17 frames with Cin 1 and 2 (K2's ragged pixel tiles), two gate chunks
# in the weight gradient (F = 12), 7x7 (4 channels a weight-gradient
# chunk, more than 48 KB of shared memory), 9x9 (two tap chunks), x without
# a gradient (no dx launch), frames wider than a tile, and dx at 16 (Cin 13,
# 4-byte copies) and 32 channels a block. With the training shapes and
# those of K4 below they run every compiled body of the chain-step and dx
# tile (8, 16, 32 and 64 channels a block) and every stage kind of its
# plan; phase 6 checks that (`PLAN_BODIES`).
K3_OTHER_PATHS = [(2, 1, 9, 41, 3, 6, 1, 3, True),
                  (3, 3, 20, 37, 5, 5, 3, 5, True),
                  (4, 3, 5, 7, 1, 4, 3, 3, True),
                  (3, 2, 17, 17, 2, 5, 5, 5, True),
                  (2, 3, 40, 40, 6, 12, 3, 3, True),
                  (2, 2, 19, 23, 8, 4, 7, 7, True),
                  (4, 3, 16, 16, 2, 8, 5, 5, False),
                  (2, 2, 12, 20, 4, 8, 5, 5, True),
                  (8, 2, 72, 100, 4, 4, 5, 5, True),
                  (16, 2, 64, 96, 5, 5, 3, 3, True),
                  (8, 2, 72, 100, 3, 6, 7, 7, True),
                  (2, 2, 12, 12, 8, 8, 9, 9, True),
                  (64, 2, 16, 16, 32, 8, 3, 3, True),
                  (48, 3, 16, 16, 13, 8, 5, 5, True)]
# K3 against its plain version run in float64 on the same inputs (cuDNN's
# float32 weight gradient is itself off by 9e-3 of max |ref| at 5x5 and 64
# channels, TF32 off, deterministic or not; float64 on the card agrees with
# float64 on the CPU within 1e-15), each gradient's max |d| over its max
# |ref|: float32 sums of kh*kw*4F products (dx) or of all B*T*H*W pixels in
# 256-pixel partials (the weights)
K3_DX_TOL, K3_W_TOL = 1e-5, 1e-5
# GPU (TF32 off) against CPU training steps: the losses are means over
# 16*4*64*64 pixels; Adam's update lr*g/(|g|+1e-7) turns a difference of
# 1e-9 in a small gradient into up to 1e-5 in a parameter each step. Every
# training phase holds the GPU, with PyTorch's own convolutions, against
# the CPU in float64: at n_filters 8 too a float32 run is no reference,
# since the CPU's float32 run ends 1.7e-4 from float64 after 3 steps while
# the GPU's, with K2's 3xTF32 products, ends 1.6e-7 from it (3.7e-7 with
# cuDNN; tools/torch_train_parity.py --width 8 --batch 16 on an H100 80GB
# HBM3 at 700 W)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-4
# width-64 training path: bench_suite.py's recresnet_spc_width64 (n_filters
# 64, attention, which adds nothing without aux inputs) trained as phase 7,
# 2 epochs of 10 steps; 3 steps at batch 4 against the CPU in float64, at
# the same tolerances. At width 64 a float32 run is not a reference: Adam's
# lr*g/(|g|+1e-7) turns float32 noise in near-zero gradients into
# parameter differences of up to lr a step, so the CPU's own float32 run
# ends 3.3e-4 from its float64 one; and the GPU's convolutions there are
# PyTorch's own, since cuDNN's float32 ones at 64 channels (TF32 off) put
# the head's parameters 1.2e-3 from float64 (with PyTorch's: 3.0e-5;
# tools/torch_train_parity.py on an H100 SXM at 700 W)
WIDE_F, WIDE_STEPS, WIDE_CPU_BATCH = 64, 10, 4
WIDE_LAYERS = [layer for cin in [1] + [WIDE_F] * REC_BLOCKS
               for layer in ((cin, WIDE_F, 5), (WIDE_F, WIDE_F, 3))]
# (B, T, H, W, Cin, F, kh, kw, x needs a gradient) of K4's other paths: T = 1
# (no recurrent sum, the gate epilogue only), 1x3 with odd F and no dx, 3x5
# with odd F and ragged tiles, F = 12 (two slices of 8 channels), 7x7 with
# F = 4 (half the block's channels past F), F = 16 at 3x3 at batch 16 (8
# channels a block: too few blocks at 16) and 128 (16 a block), F = 32 (32
# a block), F = 72 (slices of 8; at batch 40 two slices of 64 with one tap
# row a stage; also on 17x17 frames with Cin 1, K2's ragged pixel tiles
# feeding it).
K4_OTHER_PATHS = [(2, 1, 9, 41, 3, 6, 3, 3, True),
                  (2, 2, 17, 17, 1, 72, 3, 3, True),
                  (2, 3, 9, 11, 3, 5, 1, 3, False),
                  (3, 3, 20, 37, 5, 5, 3, 5, True),
                  (2, 3, 40, 40, 6, 12, 3, 3, True),
                  (2, 2, 19, 23, 8, 4, 7, 7, True),
                  (16, 4, 16, 16, 16, 16, 3, 3, True),
                  (2, 3, 12, 20, 4, 72, 5, 5, True),
                  (128, 2, 16, 16, 16, 16, 3, 3, True),
                  (128, 2, 16, 16, 8, 32, 5, 5, True),
                  (40, 2, 16, 16, 4, 72, 7, 7, True)]
# the chain-step and dx tile's compiled bodies (kernel, channels a block)
# and its plan's stage kinds (cw, all or one tap row), every one of which
# phase 6 must run
PLAN_BODIES = {(kind, ns) for kind in ('chain', 'dx') for ns in (8, 16, 32, 64)}
PLAN_STAGES = {(8, 'all'), (4, 'all'), (8, 'one')}
# K4's dzs against its plain version run in float64, to K2_TOL times
# max(1, max |dzs|); the split route's gradients against the plain BPTT in
# float64 to K3's tolerances (float32 GEMMs over up to 131,072 pixels)
K4_TOL = 1e-5
# fused SSIM (K6): the DSSIM loss's shape in a flagship training step, then
# the kernel's other paths: the minimal image (one output), ragged tiles, a
# full 512x512 grid (many row and column tiles), channels folded into the
# image axis, and a 5-D input; then other filter sizes, (shape, taps,
# sigma): the compiled maximum and a small one
K6_SHAPES = [(TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 1), (1, 11, 11, 1),
             (3, 13, 37, 1), (8, 512, 512, 1), (4, 64, 64, 3),
             (2, 3, 64, 64, 1)]
K6_FILTERS = [((2, 40, 40, 1), 25, 3.0), ((2, 20, 33, 1), 3, 0.8)]
# K6 against its plain version run in float64, per image: float32 sums of
# 11 taps of moments up to max_val^2 and of up to 512*512 SSIM terms
K6_TOL = 1e-5
# K6's backward against `ssim_backward_reference` run in float64: each
# gradient's max |d| within K6_BWD_TOL of its max |ref| (the derivative
# maps divide by B2, small where a patch is flat: relative to max |ref|),
# or within twice the plain version's own float32 error
# (`_check_k6_backward`)
K6_BWD_TOL = 1e-5
# K6's regimes (`_ssim_plan`), each of which phase 9 must run both ways,
# and the launches a call of each makes, forward and backward
SSIM_REGIMES = {('fwd', 'image'): 1, ('fwd', 'tiles'): 1,
                ('bwd', 'image'): 1, ('bwd', 'tiles'): 2}
# the loss through K6 against the plain path: value rtol, gradient atol of
# max |g| (float32 sums in another order)
LOSS_RTOL, LOSS_GRAD_TOL = 1e-5, 1e-4
# flagship training: bench.py's configuration (resnet_spc x4, n_filters 8,
# n_blocks 6, attention) trained with dssim_mae on the data of phase 7; 3
# steps at batch 16 against the CPU in float64, at the tolerances of phase
# 7. A float32 run is no reference here either: with cuDNN's float32
# convolutions (TF32 off) 3 Adam steps end 2.6e-4 from float64 (1.0e-3 with
# mae), with PyTorch's own 4.8e-7, and the CPU's float32 run 9.0e-6 (3.0e-4
# with mae) (tools/torch_train_parity.py --model resnet_spc --batch 16 on an
# H100 SXM at 700 W)
FLAG_LOSS, FLAG_CPU_BATCH = 'dssim_mae', 16


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip()


def device_times(torch, fn, reps=20, l2_flush=None):
    """Device times of `reps` calls of fn() in ms, from CUDA events around
    each call. A long device sleep is queued first, so the host has
    enqueued every call before the device reaches them: host overhead stays
    out of the events. With `l2_flush` (a buffer larger than L2), it is
    rewritten before each call, so each call finds its input in device
    memory, not in L2."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        if l2_flush is not None:
            l2_flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def paired_ms(torch, kernel, plain, l2_flush):
    """Median device ms of the kernel and of its plain version, timed in
    turns (plain, kernel, kernel, plain) so that clock drift falls on both."""
    p1 = device_times(torch, plain, l2_flush=l2_flush)
    k = (device_times(torch, kernel, l2_flush=l2_flush)
         + device_times(torch, kernel, l2_flush=l2_flush))
    p2 = device_times(torch, plain, l2_flush=l2_flush)
    return statistics.median(k), statistics.median(p1 + p2)


def kernel_launches(torch, lib, fn):
    """The kernels one call of fn() launches, by the kernel library's own
    count of its successful launches (`dl4ds_ca_launched`,
    `dl4ds_ssim_launched`), after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    before = lib()
    fn()
    torch.cuda.synchronize()
    return lib() - before


def _gate_case(torch, gen, dev, shape, cr, dtype, glorot=False):
    """x, the gate's weights (float32) and dy for K1 at x's shape; the
    weights' scale 0.5, or with `glorot` that of the model's Glorot init,
    sqrt(2 / (C + Cr))."""
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = (2.0 / (c + cr)) ** 0.5 if glorot else 0.5
    weights = (torch.randn((c, cr), generator=gen, device=dev) * scale,
               torch.randn((cr,), generator=gen, device=dev) * 0.1,
               torch.randn((cr, c), generator=gen, device=dev) * scale,
               torch.randn((c,), generator=gen, device=dev) * 0.1)
    return x, weights, torch.randn(shape, generator=gen, device=dev).to(dtype)


def k1_bwd_bound_ms(x, cr):
    """K1's backward by bytes: x and dy read once, dx written once, and the
    weights and their gradients."""
    c = x.shape[-1]
    return ((3 * x.numel() * x.element_size() + 4 * (2 * c * cr + c + cr))
            / HBM_BYTES_PER_S * 1e3)


def _check_k1_backward(torch, fo, x, weights, dy, label):
    """K1's backward kernel (on the forward kernel's saved mean and gate)
    against `_channel_attention_backward` run in float64 on the same
    inputs, each gradient within K1_BWD_TOL of its scale (a bfloat16 dx
    also within BF16_RTOL of |ref|), and the same bits twice. The scale is
    max |ref|; for the weight gradients at K1_CANCELLING, sums of a term a
    sample that cancel, it is the largest sum of the samples' terms in
    magnitude. Returns {gradient: (max|d| / scale, max|d| / max|ref|)}."""
    _, m, g = fo._launch(x, *weights)
    got = fo._launch_backward(x, *weights, dy, m, g)
    again = fo._launch_backward(x, *weights, dy, m, g)
    x64, dy64 = x.double(), dy.double()
    w64 = [t.double() for t in weights]
    ref = fo._channel_attention_backward(x64, *w64, dy64)
    maxes = [r.abs().max().item() for r in ref]
    scales = list(maxes)
    if tuple(x.shape) == K1_CANCELLING:
        mags = [torch.zeros_like(r) for r in ref[1:]]
        for i in range(x.shape[0]):
            terms = fo._channel_attention_backward(x64[i:i + 1], *w64,
                                                   dy64[i:i + 1])[1:]
            for mag, t in zip(mags, terms):
                mag += t.abs()
        scales[1:] = [t.max().item() for t in mags]
    torch.cuda.synchronize()
    errs = {}
    for name, a, a2, r, scale, biggest in zip(
            ('dx', 'dw1', 'db1', 'dw2', 'db2'), got, again, ref, scales,
            maxes):
        if not torch.equal(a, a2):
            fail(f'K1 backward {label} {name}: two runs gave different bits')
        d = (a.double() - r).abs()
        rtol = BF16_RTOL if name == 'dx' and x.dtype == torch.bfloat16 \
            else 0.0
        if not bool((d <= K1_BWD_TOL * scale + rtol * r.abs()).all()):
            fail(f'K1 backward {label} {name}: max|d| {d.max().item():.3e} '
                 f'against the float64 plain version, scale {scale:.3e} '
                 f'(max|ref| {biggest:.3e}; tolerance {K1_BWD_TOL} of the '
                 f'scale' + (f', rtol {rtol}' if rtol else '') + ')')
        worst = d.max().item()
        errs[name] = (worst / scale if scale else worst,
                      worst / biggest if biggest else worst)
    return errs


def _k1_bwd_errors(errs):
    """`_check_k1_backward`'s readings as text: max|d| over the scale, and
    over max|ref| where the scale differs."""
    return ', '.join(f'{k} {a:.1e}' + (f' ({b:.1e} of max|ref|)'
                                        if b != a else '')
                     for k, (a, b) in errs.items())


def phase_kernels(torch, tds, report):
    """Phase 2: K1 against its plain versions at the path's shapes, forward
    and backward, in every regime of its launch plan."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    from dl4ds_tpu_torch.ops.fused_ops import FusedChannelAttention
    fca, ref = tds.fused_channel_attention, tds.channel_attention_reference
    dev = torch.device('cuda')
    limits = fo._ca_limits(dev)
    print(f'K1 plan limits: {limits[0]} SMs, {limits[1]} bytes of dynamic '
          f'shared memory a block', flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = []
    for h, w, c in K1_SHAPES:
        cr = max(int(c / 4), 1)
        x32, weights, dy32 = _gate_case(torch, gen, dev, (BATCH, h, w, c), cr,
                                        torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((str(dtype).split('.')[-1], x32.to(dtype), weights,
                          dy32.to(dtype)))

    rows = []
    for name, x, weights, dy in cases:      # every shape checked first
        y = fca(x, *weights)
        y_ref = ref(x, *weights)
        torch.cuda.synchronize()
        if y.shape != x.shape or y.dtype != x.dtype:
            fail(f'K1 {name} {tuple(x.shape)}: got {y.shape} {y.dtype}')
        diff = (y.float() - y_ref.float()).abs()
        tol = K1_TOL[name]
        err = diff.max().item()
        if not bool((diff <= tol['atol']
                     + tol['rtol'] * y_ref.float().abs()).all()):
            fail(f'K1 {name} {tuple(x.shape)}: max|d| {err:.3e} outside '
                 f'atol {tol["atol"]} rtol {tol["rtol"]}')
        bwd_err = _check_k1_backward(torch, fo, x, weights, dy,
                                     f'{name} x{list(x.shape)}')
        plan = fo._ca_plan(tuple(x.shape), weights[0].shape[1], x.dtype,
                           *limits)
        rows.append(dict(dtype=name, shape=list(x.shape),
                         cr=weights[0].shape[1], max_abs_err=err,
                         bwd_rel_err=bwd_err, regime=plan['regime'],
                         parts=plan['parts']))

    for row, (name, x, weights, dy) in zip(rows, cases):   # then timed
        c, cr = x.shape[-1], weights[0].shape[1]
        ms, plain_ms = paired_ms(torch, lambda: fca(x, *weights),
                                 lambda: ref(x, *weights), flush)
        _, m, g = fo._launch(x, *weights)
        bwd_ms, bwd_plain_ms = paired_ms(
            torch, lambda: fo._launch_backward(x, *weights, dy, m, g),
            lambda: fo._channel_attention_backward(x, *weights, dy, m, g),
            flush)
        n_bytes = 2 * x.numel() * x.element_size() + 4 * (2 * c * cr + c + cr)
        n_ops = 2 * x.numel() + 4 * BATCH * c * cr
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   library_ms=None, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                   bwd_bound_ms=k1_bwd_bound_ms(x, cr))
        print(f'K1 {name:8s} x{row["shape"]} cr={cr:2d} {row["regime"]} '
              f'({row["parts"]} blocks a sample)  max|d| '
              f'{row["max_abs_err"]:.3e}  kernel {ms:.4f} ms  plain '
              f'{plain_ms:.4f} ms  bound {bound_ms:.4f} ms  library_ms null '
              f'(no single PyTorch call computes the gate); backward '
              f'max|d|/scale ' + _k1_bwd_errors(row['bwd_rel_err'])
              + f' (same bits twice)  kernel {bwd_ms:.4f} ms  plain '
              f'{bwd_plain_ms:.4f} ms  bound {row["bwd_bound_ms"]:.4f} ms',
              flush=True)

    # the training gates and the other paths, both dtypes: forward and
    # backward against the plain versions; then every regime's launches
    ran = {}
    other = [(shape, max(int(shape[-1] / 4), 1)) for shape in K1_TRAIN_SHAPES]
    for (shape, cr), dtype in [(case, dt) for case in other + K1_OTHER_PATHS
                               for dt in (torch.float32, torch.bfloat16)]:
        x, weights, dy = _gate_case(torch, gen, dev, shape, cr, dtype,
                                    glorot=(shape, cr) in K1_OTHER_PATHS)
        name = str(dtype).split('.')[-1]
        err = (fca(x, *weights).float() - ref(x, *weights).float()).abs()
        tol = K1_TOL[name]
        if not bool((err <= tol['atol'] + tol['rtol']
                     * ref(x, *weights).float().abs()).all()):
            fail(f'K1 {name} x{list(shape)}: max|d| {err.max().item():.3e}')
        bwd_err = _check_k1_backward(torch, fo, x, weights, dy,
                                     f'{name} x{list(shape)}')
        plan = fo._ca_plan(shape, cr, dtype, *limits)
        ran.setdefault(plan['regime'], (x, weights, dy, plan))
        print(f'K1 {name:8s} x{list(shape)} cr={cr} {plan["regime"]} '
              f'({plan["parts"]} blocks a sample, {plan["vec"]}-element '
              f'packs): max|d| {err.max().item():.3e}; backward '
              + _k1_bwd_errors(bwd_err),
              flush=True)
    for row, (_, x, weights, dy) in zip(rows, cases):
        plan = fo._ca_plan(tuple(x.shape), weights[0].shape[1], x.dtype,
                           *limits)
        ran.setdefault(plan['regime'], (x, weights, dy, plan))
    if set(ran) != set(CA_REGIMES):
        fail(f'phase 2 ran K1 in the regimes {sorted(ran)}, not all of '
             f'{sorted(CA_REGIMES)}')
    lib = fo._ca_lib().dl4ds_ca_launched
    for regime, (x, weights, dy, plan) in sorted(ran.items()):
        _, m, g = fo._launch(x, *weights)
        fwd = kernel_launches(torch, lib, lambda: fo._launch(x, *weights))
        bwd = kernel_launches(
            torch, lib, lambda: fo._launch_backward(x, *weights, dy, m, g))
        print(f'K1 {regime} regime at x{list(x.shape)}: {fwd} forward and '
              f'{bwd} backward kernel launches a call', flush=True)
        if fwd != CA_REGIMES[regime] or bwd != CA_REGIMES[regime]:
            fail(f'K1 {regime} regime launched {fwd} forward and {bwd} '
                 f'backward kernels, expected {CA_REGIMES[regime]} each')

    # gradient: the autograd.Function's backward against autograd through
    # the plain version, on the card
    c, cr = 16, 4
    x = torch.randn((2, LR, LR, c), generator=gen, device=dev)
    params = [torch.randn(s, generator=gen, device=dev) * 0.5
              for s in ((c, cr), (cr,), (cr, c), (c,))]
    dy = torch.randn_like(x)
    leaves = [t.clone().requires_grad_() for t in [x] + params]
    got = torch.autograd.grad(FusedChannelAttention.apply(*leaves), leaves, dy)
    leaves = [t.clone().requires_grad_() for t in [x] + params]
    want = torch.autograd.grad(ref(*leaves), leaves, dy)
    grad_err = 0.0
    for name, g, r in zip(('x', 'w1', 'b1', 'w2', 'b2'), got, want):
        d = (g - r).abs().max().item()
        grad_err = max(grad_err, d)
        if not torch.allclose(g, r, atol=1e-4, rtol=1e-4):
            fail(f'K1 backward d{name}: max|d| {d:.3e}')
    print(f'K1 backward through autograd vs autograd through the plain '
          f'version: max|d| {grad_err:.3e} (atol 1e-4, rtol 1e-4)', flush=True)
    report['k1_rows'] = rows
    report['k1_limits'] = dict(n_sm=limits[0], smem=limits[1])


def phase_predict(torch, tds, report):
    """Phase 3: the main path, full-width predict on the card."""
    import numpy as np
    fca = tds.fused_channel_attention
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=4, n_aux_channels=2,
        lr_size=(LR, LR), n_filters=N_FILTERS, n_blocks=N_BLOCKS,
        attention=True)
    net = model.init(seed=0, device='cuda')
    rng = np.random.default_rng(0)
    hr_size = LR * SCALE
    hr = rng.standard_normal((N_GRIDS, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((N_GRIDS, hr_size, hr_size, 1)).astype(
        'float32')
    kwargs = dict(scale=SCALE, array_in_hr=True, static_vars=[topo, mask],
                  predictors=[pred], batch_size=BATCH)

    fca.launches = fca.bwd_launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    launches, bwd_launches = fca.launches, fca.bwd_launches
    expected = len(K1_SHAPES) * (-(-N_GRIDS // BATCH))
    print(f'predict: {model.param_count(net)} parameters, output '
          f'{y.shape}, K1 launches {launches} (expected {expected}), K1 '
          f'backward launches {bwd_launches} (expected 0)', flush=True)
    if y.shape != (N_GRIDS, hr_size, hr_size, 1):
        fail(f'predict output shape {y.shape}')
    if not np.isfinite(y).all():
        fail('predict output is not finite')
    if launches != expected:
        fail(f'K1 launched {launches} times on the main path, expected '
             f'{expected}')
    if bwd_launches != 0:
        fail(f"K1's backward launched {bwd_launches} times while serving")
    report['k1_launches'] = launches
    report['k1_bwd_launches'] = bwd_launches

    t0 = time.perf_counter()
    tds.predict((model, net), hr, **kwargs)
    predict_s = time.perf_counter() - t0
    x = torch.randn((BATCH, LR, LR, 4), device='cuda')
    aux = torch.randn((BATCH, hr_size, hr_size, 2), device='cuda')
    with torch.inference_mode():
        fwd_ms = statistics.median(
            device_times(torch, lambda: net(x, aux), reps=10))
    card = torch.cuda.get_device_name(0)
    print(f'predict {N_GRIDS} grids 512x512 at batch {BATCH} (TF32 convs, '
          f'the default): {N_GRIDS / predict_s:.2f} grids/s end to end '
          f'(host clock, data assembly and copy out included); forward '
          f'alone {fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.2f} grids/s '
          f'(CUDA events); {card}', flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    y32 = tds.predict((model, net), hr, **kwargs)
    net_cpu = copy.deepcopy(net).cpu()
    y_cpu = tds.predict((model, net_cpu), hr[:1], device='cpu',
                        **dict(kwargs, predictors=[pred[:1]]))
    diff = np.abs(y32[0] - y_cpu[0])
    err = float(diff.max())
    ok = bool((diff <= PREDICT_TOL['atol']
               + PREDICT_TOL['rtol'] * np.abs(y_cpu[0])).all())
    print(f'predict grid 0, GPU (TF32 off) vs CPU: max|d| {err:.3e}, '
          f'max|y| {float(np.abs(y_cpu).max()):.3e} (atol '
          f'{PREDICT_TOL["atol"]}, rtol {PREDICT_TOL["rtol"]})', flush=True)
    if not ok:
        fail(f'predict on the GPU disagrees with the CPU: max|d| {err:.3e}')
    report.update(predict_grids_per_s=N_GRIDS / predict_s,
                  forward_ms=fwd_ms)


def k2_work(x, wx, wh):
    """(flops, bytes) a ConvLSTM layer needs: the input conv at every step,
    the recurrent conv from the second step on (h_{-1} = 0), x and the
    weights read once, ys written once. K2's bound_ms counts these flops
    at the float32 rate outside the tensor cores, as every kernel's does;
    `bound_3xtf32_ms` at the 3xTF32 rate its products run at."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    flops = 2 * b * h * w * kh * kw * f4 * (t * cin + (t - 1) * (f4 // 4))
    n_bytes = 4 * (x.numel() + wx.numel() + f4 + wh.numel()
                   + b * t * h * w * f4 // 4)
    return flops, n_bytes


def phase_convlstm(torch, tds, report):
    """Phase 4: K2 against its plain version with TF32 off, at the layer
    shapes of the recresnet_spc forward and at width 64."""
    from dl4ds_tpu_torch.models.blocks import ConvLSTM2D
    from dl4ds_tpu_torch.ops.convlstm import _fwd_plan
    fcl, ref = tds.fused_convlstm, tds.convlstm_reference
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(shape, LR) for shape in dict.fromkeys(K2_LAYERS)]
    cases += [(shape, K2_WIDE_LR) for shape in K2_WIDE]
    rows = []
    for i, ((cin, f, k), size) in enumerate(cases):
        layer = ConvLSTM2D(cin, f, (k, k))      # Keras init: glorot, orth.
        layer.reset_parameters(torch.Generator().manual_seed(i))
        wx, bx, wh = (p.detach().to(dev) for p in (
            layer.input_conv.kernel, layer.input_conv.bias,
            layer.cell.recurrent_conv.kernel))
        x = torch.randn((BATCH, REC_T, size, size, cin), generator=gen,
                        device=dev)
        with torch.no_grad():
            ys = fcl(x, wx, bx, wh)
            want = ref(x, wx, bx, wh)[0]
        torch.cuda.synchronize()
        err = (ys - want).abs().max().item()
        if ys.shape != want.shape or not err <= K2_TOL:
            fail(f'K2 x{list(x.shape)} F={f} k={k}: shape {tuple(ys.shape)}, '
                 f'max|d| {err:.3e} against atol {K2_TOL}')
        with torch.no_grad():
            ms, plain_ms = paired_ms(torch, lambda: fcl(x, wx, bx, wh),
                                     lambda: ref(x, wx, bx, wh), flush)
        flops, n_bytes = k2_work(x, wx, wh)
        bound_ms = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        bound_3x = max(flops / TF32X3_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        rows.append(dict(x=list(x.shape), f=f, k=k, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_3xtf32_ms=bound_3x, gflop=flops / 1e9,
                         bound_by=('operations' if flops / F32_FLOPS
                                   >= n_bytes / HBM_BYTES_PER_S
                                   else 'bytes')))
        print(f'K2 x{list(x.shape)} F={f} k={k}  max|d| {err:.3e}  kernel '
              f'{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} '
              f'ms, 3xTF32 {bound_3x:.4f} ms ({flops / 1e9:.2f} GFLOP)  '
              f'library_ms null (no single PyTorch call computes a ConvLSTM '
              f'layer)', flush=True)

    # the kernel's other paths, checked and not timed (K2_OTHER_PATHS), with
    # the launch plan each takes; two runs must give the same bits
    for i, (b, t, h, w, cin, f, kh, kw) in enumerate(K2_OTHER_PATHS):
        layer = ConvLSTM2D(cin, f, (kh, kw))
        layer.reset_parameters(torch.Generator().manual_seed(len(cases) + i))
        wx, bx, wh = (p.detach().to(dev) for p in (
            layer.input_conv.kernel, layer.input_conv.bias,
            layer.cell.recurrent_conv.kernel))
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev)
        with torch.no_grad():
            ys = fcl(x, wx, bx, wh)
            again = fcl(x, wx, bx, wh)
            err = (ys - ref(x, wx, bx, wh)[0]).abs().max().item()
        plan = _fwd_plan(b, t, h, w, kh, kw, f, n_sm)
        print(f'K2 x{list(x.shape)} F={f} k={kh}x{kw} (plan: {plan["fs"]} '
              f'channels a block, {plan["th"]}x{plan["tw"]} pixels, '
              f'{plan["cw"]} channels x {plan["rps"]} tap rows a stage)  '
              f'max|d| {err:.3e}', flush=True)
        if not err <= K2_TOL:
            fail(f'K2 x{list(x.shape)} F={f} k={kh}x{kw}: max|d| {err:.3e} '
                 f'against atol {K2_TOL}')
        if not torch.equal(ys, again):
            fail(f'K2 x{list(x.shape)} F={f} k={kh}x{kw}: two runs gave '
                 f'different bits')

    # weights that require grad: the layer runs K2's training variant (2
    # step launches) and its gradient K3 (2 chain steps, the Wx and Wh
    # passes and their reduction; x needs no gradient, so no dx)
    layer = ConvLSTM2D(2, N_FILTERS, (3, 3))
    layer.reset_parameters(torch.Generator().manual_seed(99))
    layer = layer.to(dev)
    before = (fcl.launches, fcl.train_launches, fcl.bwd_launches)
    layer(torch.randn((1, 2, 8, 8, 2), device=dev)).square().sum().backward()
    torch.cuda.synchronize()
    got = tuple(n - m for n, m in zip(
        (fcl.launches, fcl.train_launches, fcl.bwd_launches), before))
    grads = [p.grad for p in layer.parameters()]
    print(f'K2 with CUDA weights that require grad: K2 inference, training '
          f'and K3 launches {got} (expected (0, 2, 5))', flush=True)
    if got != (0, 2, 5) or not all(
            g is not None and bool(torch.isfinite(g).all()) for g in grads):
        fail(f'a ConvLSTM layer with weights that require grad launched '
             f'{got} (expected (0, 2, 5)) or gave non-finite gradients')
    by_shape = {(r['x'][-1], r['f'], r['k']): r for r in rows
                if r['x'][2] == LR}
    report['k2_rows'] = rows
    report['k2_forward'] = [by_shape[shape] for shape in K2_LAYERS]


def phase_recurrent_predict(torch, tds, report):
    """Phase 5: the spatio-temporal path, full-width predict(time_window=4)
    of recresnet_spc on the card."""
    import numpy as np
    fca, fcl = tds.fused_channel_attention, tds.fused_convlstm
    model = tds.recnet_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=2, n_aux_channels=2,
        lr_size=(LR, LR), time_window=REC_T, n_filters=N_FILTERS,
        n_blocks=REC_BLOCKS)
    net = model.init(seed=0, device='cuda')
    rng = np.random.default_rng(1)
    hr_size = LR * SCALE
    hr = rng.standard_normal((REC_GRIDS, hr_size, hr_size)).astype('float32')
    topo = rng.standard_normal((hr_size, hr_size)).astype('float32')
    mask = (rng.random((hr_size, hr_size)) > 0.5).astype('float32')
    pred = rng.standard_normal((REC_GRIDS, hr_size, hr_size, 1)).astype(
        'float32')
    kwargs = dict(scale=SCALE, time_window=REC_T, static_vars=[topo, mask],
                  predictors=[pred], batch_size=BATCH)
    n_windows = REC_GRIDS - REC_T + 1

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    fca.launches = fcl.launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    k2_launches, k1_launches = fcl.launches, fca.launches
    expected = len(K2_LAYERS) * REC_T * (-(-n_windows // BATCH))
    print(f'recurrent predict: {model.name}, {model.param_count(net)} '
          f'parameters, output {y.shape}, K2 launches {k2_launches} '
          f'(expected {expected}), K1 launches {k1_launches} (expected 0)',
          flush=True)
    if y.shape != (REC_GRIDS, hr_size, hr_size, 1):
        fail(f'recurrent predict output shape {y.shape}')
    if not np.isfinite(y).all():
        fail('recurrent predict output is not finite')
    if k2_launches != expected or k1_launches != 0:
        fail(f'the recurrent path launched K2 {k2_launches} times and K1 '
             f'{k1_launches} times, expected {expected} and 0')
    report['k2_launches'] = k2_launches

    t0 = time.perf_counter()
    tds.predict((model, net), hr, **kwargs)
    predict_s = time.perf_counter() - t0
    x = torch.randn((BATCH, REC_T, LR, LR, 2), device='cuda')
    aux = torch.randn((BATCH, hr_size, hr_size, 2), device='cuda')
    with torch.inference_mode():
        fwd_ms = statistics.median(
            device_times(torch, lambda: net(x, aux), reps=10))
    card = torch.cuda.get_device_name(0)
    print(f'recurrent predict {REC_GRIDS} grids 512x512 ({n_windows} '
          f'windows of {REC_T}) at batch {BATCH} (TF32 convs in the head, '
          f'the default; K2 is float32 FMA): '
          f'{REC_GRIDS / predict_s:.2f} grids/s end to end (host clock, data '
          f'assembly and copy out included); forward alone {fwd_ms:.3f} ms = '
          f'{BATCH / fwd_ms * 1e3:.2f} windows/s (CUDA events); {card}',
          flush=True)

    torch.backends.cudnn.allow_tf32 = False
    y32 = tds.predict((model, net), hr, **kwargs)
    net_cpu = copy.deepcopy(net).cpu()
    err = 0.0
    for name, sl, got in (('grid 0', slice(0, REC_T), y32[:1]),
                          (f'the last {REC_T} grids',
                           slice(REC_GRIDS - REC_T, REC_GRIDS),
                           y32[-REC_T:])):
        want = tds.predict((model, net_cpu), hr[sl], device='cpu',
                           **dict(kwargs, predictors=[pred[sl]]))[:len(got)]
        diff = np.abs(got - want)
        ok = bool((diff <= PREDICT_TOL['atol']
                   + PREDICT_TOL['rtol'] * np.abs(want)).all())
        print(f'recurrent predict {name}, GPU (TF32 off) vs CPU: max|d| '
              f'{float(diff.max()):.3e}, max|y| {float(np.abs(want).max()):.3e}'
              f' (atol {PREDICT_TOL["atol"]}, rtol {PREDICT_TOL["rtol"]})',
              flush=True)
        if not ok:
            fail(f'recurrent predict on the GPU disagrees with the CPU on '
                 f'{name}: max|d| {float(diff.max()):.3e}')
        err = max(err, float(diff.max()))
    report.update(rec_predict_grids_per_s=REC_GRIDS / predict_s,
                  rec_forward_ms=fwd_ms, rec_cpu_err=err)


def kernel_split_ms(torch, fn, groups, reps=10):
    """Device ms a call of fn() spends in each group of kernels ({group:
    name fragments}; kernels of no group fall under 'other'), from
    torch.profiler's device events over `reps` calls after 3 warm-up ones.
    Fails when the profiler records no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        fail('the profiler recorded no device kernel')
    out = dict.fromkeys(list(groups) + ['other'], 0.0)
    for e in kernels:
        group = next((g for g, keys in groups.items()
                      if any(k in e.name for k in keys)), 'other')
        out[group] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


# K3's kernels by launch kind (csrc/convlstm_seq.cu, csrc/convlstm_bwd.cu)
K3_KERNELS = {'chain': ('chain_step',), 'dx': ('dx_frames',),
              'wgrad': ('wgrad_tile',), 'reduce': ('wgrad_reduce',)}


def _note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, need_dx, n_sm):
    """Add the chain-step and dx tile's bodies (kernel, channels a block)
    and stage kinds that this layer's backward runs to `reached`; returns
    them as text."""
    plans = [('chain', conv._seq_plan(b, h, w, kh, kw, f, n_sm))]
    if need_dx:
        plans.append(('dx', conv._seq_plan(b * t, h, w, kh, kw, cin, n_sm)))
    for kind, p in plans:
        reached.add((kind, p['ns']))
        reached.add((p['cw'], 'all' if p['rps'] == kh else 'one'))
    return ', '.join(f'{kind} {p["ns"]} channels x {p["th"]}x{p["tw"]} '
                     f'pixels, stage {p["cw"]} x {p["rps"]}'
                     for kind, p in plans)


def k3_work(x, wx, wh, need_dx):
    """(flops, bytes) of the layer's BPTT: dx (when x needs it) and dWx
    over all T steps, the dh chain and dWh over T-1 (h_{-1} = 0, and no
    recurrent term at the last step); x, the weights, zs, cs, ys and dys
    read once, dx and the three parameter gradients written once."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    per_x = 2 * b * t * h * w * kh * kw * cin * f4
    per_h = 2 * b * (t - 1) * h * w * kh * kw * f * f4
    flops = (2 if need_dx else 1) * per_x + 2 * per_h
    n_bytes = 4 * ((2 if need_dx else 1) * x.numel() + 2 * wx.numel() + f4
                   + 2 * wh.numel() + b * t * h * w * (f4 + 3 * f))
    return flops, n_bytes


def _layer_weights(torch, cin, f, kh, kw, seed, dev):
    from dl4ds_tpu_torch.models.blocks import ConvLSTM2D
    layer = ConvLSTM2D(cin, f, (kh, kw))          # Keras init
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    return tuple(p.detach().to(dev) for p in (
        layer.input_conv.kernel, layer.input_conv.bias,
        layer.cell.recurrent_conv.kernel))


def _check_k2_train(torch, conv, x, wx, bx, wh, label):
    """K2's training variant against its plain version on one input, and
    the same bits in a second run. Returns the residuals (ys, cs, zs) and
    [max |d| of ys, cs, zs, max |zs|]."""
    with torch.no_grad():
        got = conv._launch(x, wx, bx, wh, train=True)
        again = conv._launch(x, wx, bx, wh, train=True)
        want = conv.convlstm_train_reference(x, wx, bx, wh)
    torch.cuda.synchronize()
    fwd_err = [(a - b).abs().max().item() for a, b in zip(got, want)]
    zs_scale = max(1.0, want[2].abs().max().item())
    if not (max(fwd_err[:2]) <= K2_TOL and fwd_err[2] <= K2_TOL * zs_scale):
        fail(f'K2-train {label}: ys, cs, zs max|d| {fwd_err} against atol '
             f'{K2_TOL} ({K2_TOL * zs_scale:.2e} for zs)')
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f'K2-train {label}: two runs gave different bits')
    return got, fwd_err + [zs_scale]


def _check_grads(torch, grads, again, ref, need_dx, what):
    """Each of the backward's gradients (dx, dwx, dbx, dwh; dx None without
    need_dx) against the plain BPTT in float64, max |d| over max |ref|
    within K3's tolerances, and the same bits in a second run. Returns the
    errors by name."""
    errs = {}
    for name, g, r, tol in zip(('dx', 'dwx', 'dbx', 'dwh'), grads, ref,
                               (K3_DX_TOL, K3_W_TOL, K3_W_TOL, K3_W_TOL)):
        if g is None:
            if need_dx or name != 'dx':
                fail(f'{what}: no {name}')
            continue
        if g.shape != r.shape:
            fail(f'{what}: {name} shape {tuple(g.shape)}, expected '
                 f'{tuple(r.shape)}')
        scale = max(r.abs().max().item(), 1e-30)
        errs[name] = (g.double() - r).abs().max().item() / scale
        if not errs[name] <= tol:
            fail(f'{what}: {name} max|d| / max|ref| {errs[name]:.3e} '
                 f'against {tol}')
    if not all(torch.equal(a, b) for a, b in zip(grads, again)
               if a is not None):
        fail(f'{what}: two runs gave different bits')
    return errs


def _check_k3_case(torch, conv, x, wx, bx, wh, dys, need_dx, label):
    """K2's training variant and K3 against their plain versions on one
    input; the plain backward takes the kernel's residuals, in float64 (and
    in float32, whose own error is returned). Returns the errors and the
    kernel's outputs."""
    (ys, cs, zs), fwd_err = _check_k2_train(torch, conv, x, wx, bx, wh,
                                            label)
    with torch.no_grad():
        args = (x, wx, wh, zs, cs, ys, dys)
        grads = conv._launch_backward(*args, need_dx)
        again = conv._launch_backward(*args, need_dx)
        ref = conv.convlstm_backward_reference(*(u.double() for u in args))
        ref32 = conv.convlstm_backward_reference(*args)
    torch.cuda.synchronize()
    errs = _check_grads(torch, grads, again, ref, need_dx, f'K3 {label}')
    errs['plain_f32'] = max(
        (g.double() - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
        for g, r in zip(ref32, ref))
    return fwd_err, errs, (ys, cs, zs)


def phase_convlstm_grad(torch, tds, report):
    """Phase 6: K2's training variant and K3 against their plain versions
    with TF32 off, at the layer shapes of a recresnet_spc training step, at
    width 64 and on their other paths; timed at the first two."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    reached = report.setdefault('plan_reached', set())
    cases = [((cin, f, k, k), TRAIN_BATCH, TRAIN_LR, cin != 1)
             for cin, f, k in dict.fromkeys(K3_LAYERS)]
    cases += [((cin, f, k, k), BATCH, K2_WIDE_LR, True)
              for cin, f, k in K2_WIDE]
    rows = []
    for i, ((cin, f, kh, kw), b, size, need_dx) in enumerate(cases):
        wx, bx, wh = _layer_weights(torch, cin, f, kh, kw, 100 + i, dev)
        x = torch.randn((b, REC_T, size, size, cin), generator=gen, device=dev)
        dys = torch.randn((b, REC_T, size, size, f), generator=gen,
                          device=dev)
        label = f'x{list(x.shape)} F={f} k={kh}'
        fwd_err, errs, (ys, cs, zs) = _check_k3_case(
            torch, conv, x, wx, bx, wh, dys, need_dx, label)
        with torch.no_grad():
            k2_ms, k2_plain_ms = paired_ms(
                torch, lambda: conv._launch(x, wx, bx, wh, train=True),
                lambda: conv.convlstm_train_reference(x, wx, bx, wh), flush)
            k3_ms, k3_plain_ms = paired_ms(
                torch, lambda: conv._launch_backward(
                    x, wx, wh, zs, cs, ys, dys, need_dx),
                lambda: conv.convlstm_backward_reference(
                    x, wx, wh, zs, cs, ys, dys), flush)
        flops, n_bytes = k2_work(x, wx, wh)
        n_bytes += 4 * 5 * ys.numel()                # cs and zs written
        k2_bound = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        k2_bound_3x = max(flops / TF32X3_FLOPS,
                          n_bytes / HBM_BYTES_PER_S) * 1e3
        k3_flops, k3_bytes = k3_work(x, wx, wh, need_dx)
        k3_bound = max(k3_flops / F32_FLOPS,
                       k3_bytes / HBM_BYTES_PER_S) * 1e3
        k3_bound_3x = max(k3_flops / TF32X3_FLOPS,
                          k3_bytes / HBM_BYTES_PER_S) * 1e3
        with torch.no_grad():
            k3_split = kernel_split_ms(torch, lambda: conv._launch_backward(
                x, wx, wh, zs, cs, ys, dys, need_dx), K3_KERNELS)
        plans = _note_plans(conv, reached, b, REC_T, size, size, cin, f, kh,
                            kw, need_dx, n_sm)
        rows.append(dict(
            x=list(x.shape), f=f, k=kh, dx=need_dx, ys_cs_zs_err=fwd_err[:3],
            max_abs_zs=fwd_err[3],
            grad_rel_err=errs, k2_ms=k2_ms, k2_plain_ms=k2_plain_ms,
            k2_bound_ms=k2_bound, k2_bound_3xtf32_ms=k2_bound_3x,
            k2_gflop=flops / 1e9, k3_ms=k3_ms,
            k3_plain_ms=k3_plain_ms, k3_bound_ms=k3_bound,
            k3_bound_3xtf32_ms=k3_bound_3x, k3_split_ms=k3_split,
            k3_gflop=k3_flops / 1e9))
        print(f'K2-train {label}  ys, cs, zs max|d| '
              + ' '.join(f'{e:.3e}' for e in fwd_err[:3])
              + f' (max|zs| {fwd_err[3]:.2f})  same bits twice  kernel '
              f'{k2_ms:.4f} ms  plain {k2_plain_ms:.4f} ms  bound '
              f'{k2_bound:.4f} ms, 3xTF32 {k2_bound_3x:.4f} ms '
              f'({flops / 1e9:.3f} GFLOP)', flush=True)
        print(f'K3 {label}{"" if need_dx else " (no dx)"}  max|d|/max|ref| '
              + ' '.join(f'{k} {v:.2e}' for k, v in errs.items())
              + f'  same bits twice  kernel {k3_ms:.4f} ms  plain '
              f'{k3_plain_ms:.4f} ms  bound {k3_bound:.4f} ms, 3xTF32 '
              f'{k3_bound_3x:.4f} ms ({k3_flops / 1e9:.3f} GFLOP)  by launch '
              + ' '.join(f'{k} {v:.4f}' for k, v in k3_split.items())
              + f' ms (profiler)  plans: {plans}  library_ms null (no '
              f'single PyTorch call computes a ConvLSTM layer or its BPTT)',
              flush=True)

    for i, (b, t, h, w, cin, f, kh, kw, need_dx) in enumerate(
            K3_OTHER_PATHS):
        wx, bx, wh = _layer_weights(torch, cin, f, kh, kw, 200 + i, dev)
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev)
        dys = torch.randn((b, t, h, w, f), generator=gen, device=dev)
        label = f'x{list(x.shape)} F={f} k={kh}x{kw}'
        fwd_err, errs, _ = _check_k3_case(torch, conv, x, wx, bx, wh, dys,
                                          need_dx, label)
        plans = _note_plans(conv, reached, b, t, h, w, cin, f, kh, kw,
                            need_dx, n_sm)
        print(f'K2-train/K3 {label} ({plans}{"" if need_dx else "; no dx"})'
              f'  ys, cs, zs max|d| ' + ' '.join(f'{e:.3e}' for e in fwd_err[:3])
              + f' (max|zs| {fwd_err[3]:.2f})'
              + f'  max|d|/max|ref| '
              + ' '.join(f'{k} {v:.2e}' for k, v in errs.items()), flush=True)
    by_shape = {(r['x'][-1], r['f'], r['k']): r for r in rows
                if r['x'][0] == TRAIN_BATCH}
    report['k3_rows'] = rows
    report['k3_step'] = [by_shape[shape] for shape in K3_LAYERS]


def k4_work(zs, wh):
    """(flops, bytes) of K4, the sequential chain: the recurrent convT from
    the second-to-last step down (no recurrent term at the last); zs, cs,
    dys and wh read once, dzs written once."""
    b, t, h, w, f4 = zs.shape
    kh, kw = wh.shape[:2]
    flops = 2 * b * (t - 1) * h * w * kh * kw * f4 * (f4 // 4)
    return flops, 4 * (2 * zs.numel() + zs.numel() // 2 + wh.numel())


def tail_work(x, wx, wh, need_dx):
    """(flops, bytes) of the split route's GEMM tail: dWx (and dx) over all
    T steps, dWh over T-1; x, ys (T-1 steps), dzs and the weights read
    once, dx and the three parameter gradients written once."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    per_x = 2 * b * t * h * w * kh * kw * cin * f4
    per_h = 2 * b * (t - 1) * h * w * kh * kw * f * f4
    flops = (2 if need_dx else 1) * per_x + per_h
    n_bytes = 4 * ((2 if need_dx else 1) * x.numel() + b * (t - 1) * h * w * f
                   + b * t * h * w * f4 + 2 * (wx.numel() + wh.numel() + f4))
    return flops, n_bytes


def _check_k4_case(torch, conv, x, wx, bx, wh, dys, need_dx, label):
    """K2's training variant against its plain version, K4 against its
    plain version in float64, and the split route's four gradients against
    the plain BPTT in float64, on one input; two runs of each must give the
    same bits. Returns (dzs error over max(1, max |ref|), the f32 plain
    chain's own, the gradients' errors over max |ref|, K2's training
    variant's errors), and the residuals."""
    (ys, cs, zs), fwd_err = _check_k2_train(torch, conv, x, wx, bx, wh,
                                            label)
    with torch.no_grad():
        dzs = conv._launch_seq(zs, cs, dys, wh)
        dzs_again = conv._launch_seq(zs, cs, dys, wh)
        seq64 = conv.convlstm_seq_reference(zs.double(), cs.double(),
                                            dys.double(), wh.double())
        seq32 = conv.convlstm_seq_reference(zs, cs, dys, wh)
        args = (x, wx, wh, zs, cs, ys, dys)
        grads = conv._backward('split', *args, need_dx)
        again = conv._backward('split', *args, need_dx)
        ref = conv.convlstm_backward_reference(*(u.double() for u in args))
    torch.cuda.synchronize()
    scale = max(1.0, seq64.abs().max().item())
    dzs_err = (dzs.double() - seq64).abs().max().item() / scale
    plain_err = (seq32.double() - seq64).abs().max().item() / scale
    if dzs.shape != seq64.shape or not dzs_err <= K4_TOL:
        fail(f'K4 {label}: dzs shape {tuple(dzs.shape)}, max|d| / max(1, '
             f'max|ref|) {dzs_err:.3e} against {K4_TOL}')
    if not torch.equal(dzs, dzs_again):
        fail(f'K4 {label}: two runs gave different bits')
    errs = _check_grads(torch, grads, again, ref, need_dx,
                        f'split route {label}')
    return (dzs_err, plain_err, errs, fwd_err), (ys, cs, zs, dzs)


def phase_convlstm_split(torch, tds, report):
    """Phase 6, second part: K4 and the split route against their plain
    versions in float64 at the six layer shapes of the width-64 training
    step and on K4's other paths, with K2's training variant that feeds
    them; K2-train, K4 and the tail timed at the first."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    reached = report.setdefault('plan_reached', set())
    rows = []
    for i, (cin, f, k) in enumerate(dict.fromkeys(WIDE_LAYERS)):
        wx, bx, wh = _layer_weights(torch, cin, f, k, k, 400 + i, dev)
        x = torch.randn((TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, cin),
                        generator=gen, device=dev)
        dys = torch.randn((TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, f),
                          generator=gen, device=dev)
        need_dx = cin != 1
        label = f'x{list(x.shape)} F={f} k={k}'
        errors, (ys, cs, zs, dzs) = _check_k4_case(
            torch, conv, x, wx, bx, wh, dys, need_dx, label)
        dzs_err, plain_err, errs, fwd_err = errors
        with torch.no_grad():
            k2_ms, k2_plain_ms = paired_ms(
                torch, lambda: conv._launch(x, wx, bx, wh, train=True),
                lambda: conv.convlstm_train_reference(x, wx, bx, wh), flush)
            k4_ms, k4_plain_ms = paired_ms(
                torch, lambda: conv._launch_seq(zs, cs, dys, wh),
                lambda: conv.convlstm_seq_reference(zs, cs, dys, wh), flush)
            tail_ms = statistics.median(device_times(
                torch, lambda: conv.convlstm_backward_tail(
                    x, wx, wh, ys, dzs, need_dx), l2_flush=flush))
        k2_flops, k2_bytes = k2_work(x, wx, wh)
        k2_bytes += 4 * 5 * ys.numel()               # cs and zs written
        k2_bound = max(k2_flops / F32_FLOPS, k2_bytes / HBM_BYTES_PER_S) * 1e3
        k2_bound_3x = max(k2_flops / TF32X3_FLOPS,
                          k2_bytes / HBM_BYTES_PER_S) * 1e3
        flops, n_bytes = k4_work(zs, wh)
        k4_bound = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        k4_bound_3x = max(flops / TF32X3_FLOPS,
                          n_bytes / HBM_BYTES_PER_S) * 1e3
        plans = _note_plans(conv, reached, TRAIN_BATCH, REC_T, TRAIN_LR,
                            TRAIN_LR, cin, f, k, k, False, n_sm)
        t_flops, t_bytes = tail_work(x, wx, wh, need_dx)
        tail_bound = max(t_flops / F32_FLOPS, t_bytes / HBM_BYTES_PER_S) * 1e3
        rows.append(dict(x=list(x.shape), f=f, k=k, dx=need_dx,
                         dzs_rel_err=dzs_err, plain_f32_dzs_err=plain_err,
                         grad_rel_err=errs, ys_cs_zs_err=fwd_err[:3],
                         max_abs_zs=fwd_err[3], k2_ms=k2_ms,
                         k2_plain_ms=k2_plain_ms, k2_bound_ms=k2_bound,
                         k2_bound_3xtf32_ms=k2_bound_3x,
                         k2_gflop=k2_flops / 1e9, k4_ms=k4_ms,
                         k4_plain_ms=k4_plain_ms, k4_bound_ms=k4_bound,
                         k4_bound_3xtf32_ms=k4_bound_3x,
                         k4_gflop=flops / 1e9, tail_ms=tail_ms,
                         tail_bound_ms=tail_bound, tail_gflop=t_flops / 1e9))
        print(f'K2-train {label}  ys, cs, zs max|d| '
              + ' '.join(f'{e:.3e}' for e in fwd_err[:3])
              + f' (max|zs| {fwd_err[3]:.2f})  same bits twice  kernel '
              f'{k2_ms:.4f} ms  plain {k2_plain_ms:.4f} ms  bound '
              f'{k2_bound:.4f} ms, 3xTF32 {k2_bound_3x:.4f} ms '
              f'({k2_flops / 1e9:.2f} GFLOP)', flush=True)
        print(f'K4 {label}  dzs max|d|/max(1, max|ref|) {dzs_err:.2e} '
              f'(plain f32 {plain_err:.2e}); split route'
              f'{"" if need_dx else " (no dx)"} max|d|/max|ref| '
              + ' '.join(f'{n} {v:.2e}' for n, v in errs.items())
              + f'  same bits twice  K4 {k4_ms:.4f} ms  plain '
              f'{k4_plain_ms:.4f} ms  bound {k4_bound:.4f} ms, 3xTF32 '
              f'{k4_bound_3x:.4f} ms ({flops / 1e9:.2f} GFLOP; {plans})  '
              f'tail (float32 GEMMs) '
              f'{tail_ms:.4f} ms  bound {tail_bound:.4f} ms '
              f'({t_flops / 1e9:.2f} GFLOP)  library_ms null (no single '
              f'PyTorch call computes the chain)', flush=True)
        del x, dys, ys, cs, zs, dzs
        torch.cuda.empty_cache()

    for i, (b, t, h, w, cin, f, kh, kw, need_dx) in enumerate(K4_OTHER_PATHS):
        wx, bx, wh = _layer_weights(torch, cin, f, kh, kw, 500 + i, dev)
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev)
        dys = torch.randn((b, t, h, w, f), generator=gen, device=dev)
        label = f'x{list(x.shape)} F={f} k={kh}x{kw}'
        (dzs_err, plain_err, errs, _), _ = _check_k4_case(
            torch, conv, x, wx, bx, wh, dys, need_dx, label)
        rows.append(dict(x=list(x.shape), f=f, k=[kh, kw], dx=need_dx,
                         dzs_rel_err=dzs_err, plain_f32_dzs_err=plain_err,
                         grad_rel_err=errs))
        plans = _note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, False,
                            n_sm)
        print(f'K4/split {label}{"" if need_dx else " (no dx)"} ({plans})  dzs '
              f'max|d|/max(1, max|ref|) {dzs_err:.2e} (plain f32 '
              f'{plain_err:.2e})  max|d|/max|ref| '
              + ' '.join(f'{n} {v:.2e}' for n, v in errs.items()), flush=True)
    by_shape = {(r['x'][-1], r['f'], r['k']): r for r in rows
                if 'k4_ms' in r}
    missing = (PLAN_BODIES | PLAN_STAGES) - reached
    print(f'chain-step and dx tile: ran bodies and stage kinds '
          f'{sorted(map(str, reached))}', flush=True)
    if missing:
        fail(f'phase 6 ran no shape of the chain-step and dx tile\'s '
             f'{sorted(map(str, missing))}')
    report['plan_reached'] = sorted(map(str, reached))
    report['k4_rows'] = rows
    report['k4_step'] = [by_shape[shape] for shape in WIDE_LAYERS]


def _counters(tds):
    """(name, function, attribute) of every launch counter of the port."""
    fcl = tds.fused_convlstm
    return [('K2-train', fcl, 'train_launches'),
            ('K2 inference', fcl, 'launches'), ('K3', fcl, 'bwd_launches'),
            ('K4', fcl, 'seq_launches'),
            ('K1', tds.fused_channel_attention, 'launches'),
            ('K1 backward', tds.fused_channel_attention, 'bwd_launches'),
            ('K6', tds.fused_ssim_per_image, 'launches'),
            ('K6 backward', tds.fused_ssim_per_image, 'bwd_launches')]


def _expected_launches(conv, layers, steps, eval_steps):
    """{counter: launches} of `steps` training steps and `eval_steps`
    validation or test steps of a recurrent model with these (Cin, F, k)
    ConvLSTM layers, by `dispatch_info`'s route of each: K3 a layer is T
    chain steps, dx (not for the stem, whose input needs no gradient), the
    Wx and Wh passes and one reduction; K4 a layer is T chain steps."""
    k3 = k4 = 0
    for cin, f, k in layers:
        x_shape = (TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, cin)
        route = conv.dispatch_info(x_shape, (k, k, cin, 4 * f),
                                   (k, k, f, 4 * f))['path']
        if route == 'fused':
            k3 += REC_T + (cin != 1) + 3
        else:
            k4 += REC_T
    n = len(layers) * REC_T
    return {'K2-train': steps * n, 'K2 inference': eval_steps * n,
            'K3': steps * k3, 'K4': steps * k4, 'K1': 0, 'K1 backward': 0,
            'K6': 0, 'K6 backward': 0}


def _training_config(**model):
    """SupervisedTrainer arguments of a training phase: 256 seeded grids of
    128x128, 64x64 HR patches, scale 4, and the model's `model` options."""
    import numpy as np
    rng = np.random.default_rng(0)
    data = rng.standard_normal(
        (TRAIN_GRIDS, TRAIN_HR, TRAIN_HR, 1)).astype('float32')
    return dict(backbone='resnet', upsampling='spc', data_train=data,
                data_val=data[:64], data_test=data[:64], scale=SCALE,
                patch_size=TRAIN_PATCH, verbose=False, **model)


def _drive_training(torch, tds, config, label, steps, expected, cpu_batch,
                    shares):
    """Drive training through SupervisedTrainer(**config) on the card at
    batch 128 (2 epochs of `steps` steps, validation and test), with every
    launch counter set to 0 just before and read just after, against
    `expected` ({counter: launches}); require finite losses; time the steps
    (host clock, and one step on CUDA events, with the kernels' shares of it
    from `shares`, {name: ms}); then 3 steps at `cpu_batch` from one seed on
    the GPU (TF32 off, PyTorch's own float32 convolutions, not cuDNN's) and
    on the CPU in float64. Returns the launches and the numbers."""
    import numpy as np
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = tds.SupervisedTrainer(
        batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS, steps_per_epoch=steps,
        validation_steps=TRAIN_VAL_STEPS, test_steps=TRAIN_TEST_STEPS,
        **config)
    counters = _counters(tds)
    for _, fn, attr in counters:
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    got = {name: getattr(fn, attr) for name, fn, attr in counters}
    losses = tr.fithist['loss'] + tr.fithist['val_loss'] + [tr.test_loss]
    print(f'training: {tr.model.name}, {label}, '
          f'{tr.model.param_count(tr.net)} parameters, batch {TRAIN_BATCH}, '
          f'{TRAIN_EPOCHS} epochs of {steps} steps in {run_s:.2f} s; '
          f'history {tr.fithist}, test loss {tr.test_loss:.6f}; launches '
          f'{got} (expected {expected})', flush=True)
    if got != expected:
        fail(f'training ({label}) launched {got}, expected {expected}')
    if not all(np.isfinite(v) for v in losses):
        fail(f'training ({label}) gave non-finite losses {losses}')

    # speed: steps with their batch synthesis on the host clock, and one
    # step alone on CUDA events
    gen = torch.Generator().manual_seed(1)
    idx = tr.ds_train.epoch_indices(gen, steps=steps)
    tr.net.train()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(steps):
        tr.train_step(tr.ds_train(idx[c], generator=gen))
    torch.cuda.synchronize()
    patches_per_s = steps * TRAIN_BATCH / (time.perf_counter() - t0)
    batch = tr.ds_train(idx[0], generator=gen)
    step_ms = statistics.median(
        device_times(torch, lambda: tr.train_step(batch), reps=10))
    del tr, batch
    print(f'training step at batch {TRAIN_BATCH}, {label} (TF32 convs, the '
          f'default; the port\'s kernels and the GEMM tail are float32): '
          f'{patches_per_s:.1f} patches/s end to end (host clock, batch '
          f'synthesis included); one step {step_ms:.3f} ms (CUDA events) = '
          f'{TRAIN_BATCH / step_ms * 1e3:.1f} patches/s; of which '
          + ', '.join(f'{name} {ms:.3f} ms ({100 * ms / step_ms:.1f}%)'
                      for name, ms in shares.items())
          + f', timed alone above; {torch.cuda.get_device_name(0)}',
          flush=True)

    # 3 steps from one seed on the GPU and on the CPU
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for device, dtype in (('cuda', torch.float32), ('cpu', torch.float64)):
        torch.backends.cudnn.enabled = device == 'cpu'
        small = tds.SupervisedTrainer(batch_size=cpu_batch, epochs=1,
                                      device=device, **config)
        small.setup_datagen()
        small.setup_model()
        small.net.to(dtype)
        small.setup_optimizer()
        small.net.train()
        gen = torch.Generator().manual_seed(3)
        idx = small.ds_train.epoch_indices(gen, steps=3)
        losses = []
        for c in range(3):
            batch = small.ds_train(idx[c], generator=gen)
            losses.append(small.train_step(
                {k: None if v is None else v.to(dtype)
                 for k, v in batch.items()}).item())
        runs[device] = (losses, {n: p.detach().cpu().double() for n, p in
                                 small.net.named_parameters()})
    torch.backends.cudnn.enabled = True
    (gpu_losses, gpu_params), (cpu_losses, cpu_params) = (runs['cuda'],
                                                          runs['cpu'])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses,
                                                       cpu_losses))
    param_err = max((gpu_params[n] - cpu_params[n]).abs().max().item()
                    for n in cpu_params)
    print(f'3 training steps at batch {cpu_batch}, {label}, GPU (TF32 off, '
          f'PyTorch\'s own float32 convolutions, not cuDNN\'s) vs CPU '
          f'(float64): losses {gpu_losses} vs {cpu_losses}, max relative difference {loss_err:.3e} (rtol '
          f'{TRAIN_LOSS_RTOL}); parameters max|d| {param_err:.3e} (atol '
          f'{TRAIN_PARAM_ATOL})', flush=True)
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL):
        fail(f'GPU training steps ({label}) disagree with the CPU: losses '
             f'{loss_err:.3e}, parameters {param_err:.3e}')
    return got, dict(patches_per_s=patches_per_s, step_ms=step_ms,
                     run_s=run_s, cpu_loss_rel_err=loss_err,
                     cpu_param_err=param_err)


def _print_routes(conv, layers):
    for cin, f, k in dict.fromkeys(layers):
        info = conv.dispatch_info(
            (TRAIN_BATCH, REC_T, TRAIN_LR, TRAIN_LR, cin), (k, k, cin, 4 * f),
            (k, k, f, 4 * f))
        print(f'ConvLSTM layer (Cin {cin}, F {f}, {k}x{k}) at batch '
              f'{TRAIN_BATCH}: backward route {info["path"]} '
              f'({info["reason"]})', flush=True)


def phase_training(torch, tds, report):
    """Phase 7: recurrent training of BASELINE config 4 on the card."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    step = report['k3_step']
    _print_routes(conv, K3_LAYERS)
    got, numbers = _drive_training(
        torch, tds, _training_config(loss='mae', time_window=REC_T,
                                     n_blocks=REC_BLOCKS,
                                     n_filters=N_FILTERS),
        f'n_filters {N_FILTERS}', TRAIN_STEPS,
        _expected_launches(conv, K3_LAYERS, TRAIN_EPOCHS * TRAIN_STEPS,
                           TRAIN_EPOCHS * TRAIN_VAL_STEPS + TRAIN_TEST_STEPS),
        16, {'K2-train': sum(r['k2_ms'] for r in step),
             'K3': sum(r['k3_ms'] for r in step)})
    report.update(k2_train_launches=got['K2-train'],
                  train_k2_inference_launches=got['K2 inference'],
                  k3_launches=got['K3'], train_k4_launches=got['K4'])
    report.update({f'train_{k}': v for k, v in numbers.items()})


def phase_wide_training(torch, tds, report):
    """Phase 8: recurrent training at width 64 on the card."""
    import dl4ds_tpu_torch.ops.convlstm as conv
    step = report['k4_step']
    _print_routes(conv, WIDE_LAYERS)
    got, numbers = _drive_training(
        torch, tds, _training_config(loss='mae', time_window=REC_T,
                                     n_blocks=REC_BLOCKS, n_filters=WIDE_F,
                                     attention=True),
        f'n_filters {WIDE_F}', WIDE_STEPS,
        _expected_launches(conv, WIDE_LAYERS, TRAIN_EPOCHS * WIDE_STEPS,
                           TRAIN_EPOCHS * TRAIN_VAL_STEPS + TRAIN_TEST_STEPS),
        WIDE_CPU_BATCH,
        {'K2-train': sum(r['k2_ms'] for r in step),
         'K4': sum(r['k4_ms'] for r in step),
         'the GEMM tail': sum(r['tail_ms'] for r in step)})
    report.update(wide_k2_train_launches=got['K2-train'],
                  wide_k2_inference_launches=got['K2 inference'],
                  wide_k3_launches=got['K3'], k4_launches=got['K4'])
    report.update({f'wide_{k}': v for k, v in numbers.items()})


def k6_work(shape, k):
    """(flops, bytes) of K6 on [..., H, W, C] images with k taps: the five
    moments' horizontal pass over every row (H x Wv outputs) and vertical
    pass (Hv x Wv), k multiply-adds each, for every image and channel; both
    images read once, one float per output written."""
    *lead, h, w, c = shape
    n_out = math.prod(lead)
    hv, wv = h - k + 1, w - k + 1
    flops = 2 * 5 * k * (h * wv + hv * wv) * n_out * c
    return flops, 4 * (2 * n_out * c * h * w + n_out)


def k6_bwd_work(shape, k, n_grads):
    """(flops, bytes) of K6's backward with n_grads image gradients: the
    forward's moments again, then `2 + n_grads` derivative maps (d mu11 =
    d mu22, d mu12, and d mu1 or d mu2 for each image asked) filtered back,
    vertically over H x Wv and horizontally over H x W, k multiply-adds
    each; both images and g read once, the gradients written once."""
    *lead, h, w, c = shape
    n_img = math.prod(lead) * c
    flops = k6_work(shape, k)[0] + 2 * (2 + n_grads) * k * (
        h * (w - k + 1) + h * w) * n_img
    return flops, 4 * ((2 + n_grads) * n_img * h * w + 2 * math.prod(lead))


def _ssim_pair(torch, shape, gen, dev):
    """An image in [0, 1) and a noisy copy clipped to [0, 1]."""
    a = torch.rand(shape, generator=gen, device=dev)
    b = (a + 0.1 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    return a, b


def _check_k6_backward(torch, fo, a, b, max_val, g, k, sigma, label):
    """K6's backward kernel against `ssim_backward_reference` run in float64
    on the same inputs, for both images and max_val, and the same bits
    twice. Each gradient's max |d| is within K6_BWD_TOL of its max |ref|,
    or no further from float64 than twice the plain version run in float32
    on the same inputs: max_val's sums S's derivatives in c1 and c2, which
    hold 1 - L and 1 - C, cancelling where the images agree. Returns
    {gradient: (max|d| / max|ref|, the plain float32 version's)}."""
    from dl4ds_tpu_torch.ops.ssim import ssim_backward_reference
    args = (k, sigma, 0.01, 0.03)
    got = fo._launch_ssim_backward(a, b, max_val, g, *args)
    again = fo._launch_ssim_backward(a, b, max_val, g, *args)
    ref = ssim_backward_reference(a.double(), b.double(), max_val.double(),
                                  g.double(), *args)
    plain = ssim_backward_reference(a, b, max_val, g, *args)
    torch.cuda.synchronize()
    errs = {}
    for name, x, x2, r, p in zip(('img1', 'img2', 'max_val'), got, again,
                                 ref, plain):
        if not torch.equal(x, x2):
            fail(f'K6 backward {label} {name}: two runs gave different bits')
        d = (x.double() - r).abs().max().item()
        dp = (p.double() - r).abs().max().item()
        scale = r.abs().max().item()
        if not (d <= K6_BWD_TOL * scale or d <= 2 * dp):
            fail(f'K6 backward {label} {name}: max|d| {d:.3e} against the '
                 f'float64 plain version, max|ref| {scale:.3e} (tolerance '
                 f'{K6_BWD_TOL} of max|ref|, or twice the plain float32 '
                 f'version\'s {dp:.3e})')
        errs[name] = (d / scale, dp / scale)
    return errs


def phase_ssim(torch, tds, report):
    """Phase 9: K6 against its plain versions in float64 at the DSSIM loss's
    shape and on its other paths, forward and backward; timed at the first;
    dssim_mae through K6 against the plain path."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    from dl4ds_tpu_torch.ops.ssim import ssim, ssim_backward_reference
    fss = tds.fused_ssim_per_image
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(9)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(shape, 11, 1.5) for shape in K6_SHAPES] + K6_FILTERS
    rows, ran = [], {}
    for i, (shape, k, sigma) in enumerate(cases):
        a, b = _ssim_pair(torch, shape, gen, dev)
        # the loss passes its data range as a device scalar
        max_val = (torch.maximum(a.amax(), b.amax())
                   - torch.minimum(a.amin(), b.amin())) if i == 0 else 1.0
        kw = dict(filter_size=k, filter_sigma=sigma)
        got = fss(a, b, max_val, **kw)
        again = fss(a, b, max_val, **kw)
        m64 = max_val.double() if torch.is_tensor(max_val) else max_val
        ref = ssim(a.double(), b.double(), m64, **kw)
        ref32 = ssim(a, b, max_val, **kw)
        torch.cuda.synchronize()
        label = f'x{list(shape)} {k} taps'
        if got.shape != ref.shape:
            fail(f'K6 {label}: shape {tuple(got.shape)}, expected '
                 f'{tuple(ref.shape)}')
        err = (got.double() - ref).abs().max().item()
        plain_err = (ref32.double() - ref).abs().max().item()
        if not err <= K6_TOL:
            fail(f'K6 {label}: max|d| {err:.3e} against the float64 plain '
                 f'version, atol {K6_TOL}')
        if not torch.equal(got, again):
            fail(f'K6 {label}: two runs gave different bits')
        mv = max_val if torch.is_tensor(max_val) else torch.full(
            (), max_val, device=dev)
        g = torch.rand(got.shape, generator=gen, device=dev) + 0.5
        bwd_err = _check_k6_backward(torch, fo, a, b, mv, g, k, sigma, label)
        plan = fo._ssim_plan(shape, k, fo._ssim_limit(dev))
        for direction in ('fwd', 'bwd'):
            ran.setdefault((direction, plan[direction]['regime']),
                           (a, b, mv, g, k, sigma))
        row = dict(shape=list(shape), taps=k, max_abs_err=err,
                   plain_f32_err=plain_err, bwd_rel_err=bwd_err,
                   regimes=[plan['fwd']['regime'], plan['bwd']['regime']])
        if i == 0:
            ms, plain_ms = paired_ms(torch, lambda: fss(a, b, max_val),
                                     lambda: ssim(a, b, max_val), flush)
            # the backward as the loss takes it: the prediction's and the
            # range's gradients
            need = (False, True, True)
            bwd_ms, bwd_plain_ms = paired_ms(
                torch, lambda: fo._launch_ssim_backward(
                    a, b, max_val, g, 11, 1.5, 0.01, 0.03, need),
                lambda: ssim_backward_reference(a, b, max_val, g, need=need),
                flush)
            # what the parent ran: autograd through the plain version
            leaves = [b.clone().requires_grad_(),
                      max_val.clone().requires_grad_()]
            autograd_ms = statistics.median(device_times(
                torch, lambda: torch.autograd.grad(ssim(a, *leaves), leaves,
                                                   g), l2_flush=flush))
            flops, n_bytes = k6_work(shape, k)
            bound_ms = max(flops / F32_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
            bflops, bbytes = k6_bwd_work(shape, k, 1)
            bwd_bound_ms = max(bflops / F32_FLOPS,
                               bbytes / HBM_BYTES_PER_S) * 1e3
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=('operations' if flops / F32_FLOPS
                                 >= n_bytes / HBM_BYTES_PER_S else 'bytes'),
                       mflop=flops / 1e6, mbytes=n_bytes / 1e6,
                       bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                       bwd_bound_ms=bwd_bound_ms,
                       bwd_bound_by=('operations' if bflops / F32_FLOPS
                                     >= bbytes / HBM_BYTES_PER_S
                                     else 'bytes'),
                       autograd_bwd_ms=autograd_ms)
        rows.append(row)
        print(f'K6 {label} {row["regimes"][0]}/{row["regimes"][1]}  max|d| '
              f'{err:.3e} against float64 (plain f32 {plain_err:.3e})  same '
              f'bits twice; backward max|d|/max|ref| (plain f32) '
              + ', '.join(f'{n} {v[0]:.1e} ({v[1]:.1e})'
                          for n, v in bwd_err.items())
              + (f'  kernel {row["ms"]:.4f} ms  plain {row["plain_ms"]:.4f} '
                 f'ms  bound {row["bound_ms"]:.4f} ms ({row["mflop"]:.1f} '
                 f'MFLOP, {row["mbytes"]:.2f} MB)  library_ms null (no '
                 f'single PyTorch call computes SSIM); backward (img2, '
                 f'max_val) kernel {row["bwd_ms"]:.4f} ms  plain '
                 f'{row["bwd_plain_ms"]:.4f} ms  bound '
                 f'{row["bwd_bound_ms"]:.4f} ms ({row["bwd_bound_by"]}); '
                 f'autograd through the plain version '
                 f'{row["autograd_bwd_ms"]:.4f} ms' if i == 0 else ''),
              flush=True)
    if set(ran) != set(SSIM_REGIMES):
        fail(f'phase 9 ran K6 in {sorted(ran)}, not all of '
             f'{sorted(SSIM_REGIMES)}')
    lib = fo._ssim_lib().dl4ds_ssim_launched
    for (direction, regime), (a, b, mv, g, k, sigma) in sorted(ran.items()):
        args = (a, b, mv, k, sigma, 0.01, 0.03)
        n = kernel_launches(
            torch, lib, (lambda: fo._launch_ssim(*args)) if direction == 'fwd'
            else (lambda: fo._launch_ssim_backward(a, b, mv, g, *args[3:])))
        print(f'K6 {direction} {regime} at x{list(a.shape)}: {n} kernel '
              f'launches a call', flush=True)
        if n != SSIM_REGIMES[(direction, regime)]:
            fail(f'K6 {direction} {regime} launched {n} kernels, expected '
                 f'{SSIM_REGIMES[(direction, regime)]}')

    # dssim_mae through K6, forward and backward, against the same loss on
    # the CPU, which runs the plain versions
    shape = K6_SHAPES[0]
    y_true = torch.randn(shape, generator=gen, device=dev)
    y_pred = torch.randn(shape, generator=gen, device=dev)
    lossf = getattr(tds.losses, FLAG_LOSS)
    results = []
    for d in ('cuda', 'cpu'):
        pred = y_pred.detach().to(d).requires_grad_()
        before = (fss.launches, fss.bwd_launches)
        value = lossf(y_true.to(d), pred)
        value.backward()
        launched = (fss.launches - before[0], fss.bwd_launches - before[1])
        results.append((value.item(), pred.grad.cpu(), launched))
    (v_gpu, g_gpu, n_gpu), (v_cpu, g_cpu, n_cpu) = results
    loss_err = abs(v_gpu - v_cpu) / abs(v_cpu)
    grad_err = ((g_gpu - g_cpu).abs().max() / g_cpu.abs().max()).item()
    print(f'{FLAG_LOSS} x{list(shape)} (standard normal, so both arrays '
          f'are shifted) through K6 vs the plain path (CPU): loss '
          f'{v_gpu:.8f} vs '
          f'{v_cpu:.8f}, relative {loss_err:.2e} (rtol {LOSS_RTOL}); y_pred '
          f'gradient max|d|/max|g| {grad_err:.2e} (atol {LOSS_GRAD_TOL} of '
          f'max|g|); K6 (forward, backward) launches {n_gpu} on the GPU, '
          f'{n_cpu} on the CPU', flush=True)
    if (n_gpu, n_cpu) != ((1, 1), (0, 0)):
        fail(f'{FLAG_LOSS} launched K6 {n_gpu} times on the GPU and {n_cpu} '
             f'on the CPU, expected (1, 1) and (0, 0)')
    if not (loss_err <= LOSS_RTOL and grad_err <= LOSS_GRAD_TOL):
        fail(f'{FLAG_LOSS} through K6 disagrees with the plain path: loss '
             f'{loss_err:.3e}, gradient {grad_err:.3e}')
    report['k6_rows'] = rows
    report['k6_loss_check'] = dict(loss_rel_err=loss_err,
                                   grad_rel_err=grad_err)


def _gate_inputs(torch, tds, config):
    """The input shapes of the flagship's K1 gates in a training step, in
    order, read by hooks on one forward of a training batch."""
    from dl4ds_tpu_torch.models.blocks import ChannelAttention2D
    tr = tds.SupervisedTrainer(batch_size=TRAIN_BATCH, epochs=1, **config)
    tr.setup_datagen()
    tr.setup_model()
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append(tuple(inp[0].shape)))
        for m in tr.net.modules() if isinstance(m, ChannelAttention2D)]
    gen = torch.Generator().manual_seed(0)
    batch = tr.ds_train(tr.ds_train.epoch_indices(gen, steps=1)[0],
                        generator=gen)
    with torch.no_grad():
        tr.net(batch['lr'], batch['aux'])
    for h in hooks:
        h.remove()
    return shapes


def phase_flagship_training(torch, tds, report):
    """Phase 10: the flagship training with dssim_mae on the card: K1 timed
    at the step's gate shapes (kernel and plain, forward and backward, the
    backward also held against the float64 plain version), then the
    trainer driven as phases 7 and 8."""
    from dl4ds_tpu_torch.ops import fused_ops as fo
    fca, ref = tds.fused_channel_attention, tds.channel_attention_reference
    config = _training_config(loss=FLAG_LOSS, n_filters=N_FILTERS,
                              n_blocks=N_BLOCKS, attention=True)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(10)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    shapes = _gate_inputs(torch, tds, config)
    if shapes != K1_TRAIN_SHAPES:
        fail(f'the flagship step\'s gates are {shapes}, not the '
             f'{K1_TRAIN_SHAPES} phase 2 checked')
    rows = []
    for shape in shapes:
        c = shape[-1]
        cr = max(int(c / 4), 1)
        x, weights, dy = _gate_case(torch, gen, dev, shape, cr, torch.float32)
        err = (fca(x, *weights) - ref(x, *weights)).abs().max().item()
        if not err <= K1_TOL['float32']['atol']:
            fail(f'K1 x{list(shape)}: max|d| {err:.3e}')
        bwd_err = _check_k1_backward(torch, fo, x, weights, dy,
                                     f'training gate x{list(shape)}')
        ms, plain_ms = paired_ms(torch, lambda: fca(x, *weights),
                                 lambda: ref(x, *weights), flush)
        _, m, g = fo._launch(x, *weights)
        bwd_ms, bwd_plain_ms = paired_ms(
            torch, lambda: fo._launch_backward(x, *weights, dy, m, g),
            lambda: fo._channel_attention_backward(x, *weights, dy, m, g),
            flush)
        n_bytes = 2 * x.numel() * 4 + 4 * (2 * c * cr + c + cr)
        n_ops = 2 * x.numel() + 4 * shape[0] * c * cr
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3
        rows.append(dict(shape=list(shape), cr=cr, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bwd_rel_err=bwd_err, bwd_ms=bwd_ms,
                         bwd_plain_ms=bwd_plain_ms,
                         bwd_bound_ms=k1_bwd_bound_ms(x, cr)))
        print(f'K1 training gate x{list(shape)} cr={cr}  max|d| {err:.3e}  '
              f'kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound '
              f'{bound_ms:.4f} ms (bytes); backward max|d|/max|ref| '
              + _k1_bwd_errors(bwd_err)
              + f'  kernel {bwd_ms:.4f} ms  plain {bwd_plain_ms:.4f} ms  '
              f'bound {rows[-1]["bwd_bound_ms"]:.4f} ms (bytes)', flush=True)
    report['k1_train_rows'] = rows
    per_forward = len(rows)
    forwards = (TRAIN_EPOCHS * (TRAIN_STEPS + TRAIN_VAL_STEPS)
                + TRAIN_TEST_STEPS)
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    expected = {'K2-train': 0, 'K2 inference': 0, 'K3': 0, 'K4': 0,
                'K1': per_forward * forwards,
                'K1 backward': per_forward * steps, 'K6': forwards,
                'K6 backward': steps}
    k6 = report['k6_rows'][0]
    got, numbers = _drive_training(
        torch, tds, config, f'n_filters {N_FILTERS}, {FLAG_LOSS}',
        TRAIN_STEPS, expected, FLAG_CPU_BATCH,
        {'K1 forward': sum(r['ms'] for r in rows),
         'K1 backward': sum(r['bwd_ms'] for r in rows),
         'K6': k6['ms'], 'K6 backward': k6['bwd_ms']})
    report.update(flag_k1_launches=got['K1'],
                  flag_k1_bwd_launches=got['K1 backward'],
                  k6_launches=got['K6'], k6_bwd_launches=got['K6 backward'],
                  flag_k1_per_forward=per_forward)
    report.update({f'flag_{k}': v for k, v in numbers.items()})


def main():
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device (torch.cuda.is_available() is False)')
    repo = Path(__file__).resolve().parent
    if not (repo / 'dl4ds_tpu_torch' / '__init__.py').is_file():
        fail(f'no dl4ds_tpu_torch package beside {Path(__file__).name}')
    sys.path.insert(0, str(repo))
    import dl4ds_tpu_torch as tds
    from dl4ds_tpu_torch.ops import _build
    if any(m == 'jax' or m.startswith(('jax.', 'dl4ds_tpu.'))
           or m == 'dl4ds_tpu' for m in sys.modules):
        fail('the port imported JAX or the JAX package')

    card = card_line()
    print(f'card: {card}', flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (seconds, log) in built.items():
        print(f'built {name} in {seconds:.1f} s', flush=True)
        print(log, file=sys.stderr, flush=True)
    print(f'kernel build: {time.perf_counter() - t0:.1f} s', flush=True)

    report = {}
    phase_kernels(torch, tds, report)
    phase_predict(torch, tds, report)
    phase_convlstm(torch, tds, report)
    phase_recurrent_predict(torch, tds, report)
    phase_convlstm_grad(torch, tds, report)
    phase_convlstm_split(torch, tds, report)
    phase_training(torch, tds, report)
    phase_wide_training(torch, tds, report)
    phase_ssim(torch, tds, report)
    phase_flagship_training(torch, tds, report)

    f32 = [r for r in report['k1_rows'] if r['dtype'] == 'float32']
    k1 = {'name': 'K1_channel_attention', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/channel_attention.cu',
          'replaces': 'dl4ds_tpu/ops/pallas_ops.py:39',
          'launches': report['k1_launches'],
          'max_abs_err': max(r['max_abs_err'] for r in f32),
          'ms': sum(r['ms'] for r in f32),
          'plain_ms': sum(r['plain_ms'] for r in f32),
          'bound_ms': sum(r['bound_ms'] for r in f32),
          'bound_by': 'bytes', 'library_ms': None,
          'bwd_ms': sum(r['bwd_ms'] for r in f32),
          'bwd_bound_ms': sum(r['bwd_bound_ms'] for r in f32),
          'bwd_plain_ms': sum(r['bwd_plain_ms'] for r in f32),
          'bwd_launches': report['k1_bwd_launches'],
          'work': f'the {len(f32)} gates of one float32 forward at batch '
                  f'{BATCH}, summed (regimes '
                  f'{[r["regime"] for r in f32]}); bwd_* the backward '
                  f'kernel at the same shapes (serving runs none)'}
    fwd = report['k2_forward']
    k2 = {'name': 'K2_convlstm', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/convlstm.cu',
          'sources': ['dl4ds_tpu_torch/csrc/convlstm.cu',
                      'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
          'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:219',
          'launches': report['k2_launches'],
          'max_abs_err': max(r['max_abs_err'] for r in report['k2_rows']),
          'ms': sum(r['ms'] for r in fwd),
          'plain_ms': sum(r['plain_ms'] for r in fwd),
          'bound_ms': sum(r['bound_ms'] for r in fwd),
          'bound_3xtf32_ms': sum(r['bound_3xtf32_ms'] for r in fwd),
          'bound_by': 'operations', 'library_ms': None,
          'work': f'the {len(fwd)} ConvLSTM layers of one float32 '
                  f'recresnet_spc forward at batch {BATCH}, T {REC_T}, '
                  f'summed; products in 3xTF32 on the tensor cores '
                  f'(bound_3xtf32_ms at {TF32X3_FLOPS / 1e12:.0f} TFLOP/s)'}
    step = report['k3_step']
    k3_rows = report['k3_rows']
    step_work = (f'the {len(step)} ConvLSTM layers of one float32 '
                 f'recresnet_spc training step at batch {TRAIN_BATCH}, T '
                 f'{REC_T}, {TRAIN_LR}x{TRAIN_LR}, summed')
    k2_train = {'name': 'K2_convlstm_train', 'route': 'cuda',
                'source': 'dl4ds_tpu_torch/csrc/convlstm.cu',
                'sources': ['dl4ds_tpu_torch/csrc/convlstm.cu',
                            'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
                'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:219',
                'launches': report['k2_train_launches'],
                'max_abs_err': max(max(r['ys_cs_zs_err'][:2])
                                   for r in k3_rows + report['k4_rows']
                                   if 'ys_cs_zs_err' in r),
                'ms': sum(r['k2_ms'] for r in step),
                'plain_ms': sum(r['k2_plain_ms'] for r in step),
                'bound_ms': sum(r['k2_bound_ms'] for r in step),
                'bound_3xtf32_ms': sum(r['k2_bound_3xtf32_ms']
                                       for r in step),
                'bound_by': 'operations', 'library_ms': None,
                'work': step_work + ' (save_residuals=True: ys, cs, zs); '
                        'max_abs_err is that of ys and cs; at width '
                        f'{WIDE_F} the six layers took '
                        f'{sum(r["k2_ms"] for r in report["k4_step"]):.4f} '
                        f'ms (plain '
                        f'{sum(r["k2_plain_ms"] for r in report["k4_step"]):.4f}'
                        f', bound '
                        f'{sum(r["k2_bound_ms"] for r in report["k4_step"]):.4f}'
                        f', 3xTF32 '
                        f'{sum(r["k2_bound_3xtf32_ms"] for r in report["k4_step"]):.4f}'
                        f' ms)'}
    k3 = {'name': 'K3_convlstm_bptt', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
          'sources': ['dl4ds_tpu_torch/csrc/convlstm_seq.cu',
                      'dl4ds_tpu_torch/csrc/convlstm_bwd.cu',
                      'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
          'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:335',
          'launches': report['k3_launches'],
          'max_abs_err': max(max(v for k, v in r['grad_rel_err'].items()
                                 if k != 'plain_f32') for r in k3_rows),
          'ms': sum(r['k3_ms'] for r in step),
          'plain_ms': sum(r['k3_plain_ms'] for r in step),
          'bound_ms': sum(r['k3_bound_ms'] for r in step),
          'bound_3xtf32_ms': sum(r['k3_bound_3xtf32_ms'] for r in step),
          'bound_by': 'operations', 'library_ms': None,
          'split_ms': {k: sum(r['k3_split_ms'][k] for r in step)
                       for k in list(K3_KERNELS) + ['other']},
          'work': step_work + '; the chain steps and dx run the tile of '
                  'convlstm_seq.cu, the weight gradients and their '
                  'reduction convlstm_bwd.cu; split_ms is the time by launch '
                  'kind (torch.profiler); products in 3xTF32 '
                  f'(bound_3xtf32_ms at {TF32X3_FLOPS / 1e12:.0f} TFLOP/s); '
                  'max_abs_err is max|d| / max|ref| of dx, dWx, dbx and dWh '
                  'against the plain version in float64'}
    wide = report['k4_step']
    k4 = {'name': 'K4_convlstm_seq', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/convlstm_seq.cu',
          'sources': ['dl4ds_tpu_torch/csrc/convlstm_seq.cu',
                      'dl4ds_tpu_torch/csrc/tf32_mma.cuh'],
          'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:269',
          'launches': report['k4_launches'],
          'max_abs_err': max(r['dzs_rel_err'] for r in report['k4_rows']),
          'ms': sum(r['k4_ms'] for r in wide),
          'plain_ms': sum(r['k4_plain_ms'] for r in wide),
          'bound_ms': sum(r['k4_bound_ms'] for r in wide),
          'bound_3xtf32_ms': sum(r['k4_bound_3xtf32_ms'] for r in wide),
          'bound_by': 'operations', 'library_ms': None,
          'work': f'the sequential BPTT chain of the {len(wide)} ConvLSTM '
                  f'layers of one float32 recresnet_spc training step at '
                  f'width {WIDE_F}, batch {TRAIN_BATCH}, T {REC_T}, '
                  f'{TRAIN_LR}x{TRAIN_LR}, summed; products in 3xTF32; '
                  f'max_abs_err is max|d| / '
                  f'max(1, max|ref|) of dzs against the plain chain in '
                  f'float64; the split route\'s float32 GEMM tail (cuBLAS, '
                  f'not a kernel of the port) took '
                  f'{sum(r["tail_ms"] for r in wide):.4f} ms against a '
                  f'{sum(r["tail_bound_ms"] for r in wide):.4f} ms bound'}
    gates = report['k1_train_rows']
    k1_train = {'name': 'K1_channel_attention_train', 'route': 'cuda',
                'source': 'dl4ds_tpu_torch/csrc/channel_attention.cu',
                'replaces': 'dl4ds_tpu/ops/pallas_ops.py:39',
                'launches': report['flag_k1_launches'],
                'max_abs_err': max(r['max_abs_err'] for r in gates),
                'ms': sum(r['ms'] for r in gates),
                'plain_ms': sum(r['plain_ms'] for r in gates),
                'bound_ms': sum(r['bound_ms'] for r in gates),
                'bound_by': 'bytes', 'library_ms': None,
                'bwd_ms': sum(r['bwd_ms'] for r in gates),
                'bwd_bound_ms': sum(r['bwd_bound_ms'] for r in gates),
                'bwd_plain_ms': sum(r['bwd_plain_ms'] for r in gates),
                'bwd_launches': report['flag_k1_bwd_launches'],
                'work': f'the {len(gates)} gates of one float32 flagship '
                        f'training step at batch {TRAIN_BATCH}, summed, '
                        f'forward and backward (bwd_*, held against the '
                        f'float64 plain version)'}
    k6_rows = report['k6_rows']
    k6_step = k6_rows[0]
    k6 = {'name': 'K6_ssim', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/ssim.cu',
          'replaces': 'dl4ds_tpu/ops/pallas_ops.py:145',
          'launches': report['k6_launches'],
          'max_abs_err': max(r['max_abs_err'] for r in k6_rows),
          'ms': k6_step['ms'], 'plain_ms': k6_step['plain_ms'],
          'bound_ms': k6_step['bound_ms'], 'bound_by': k6_step['bound_by'],
          'library_ms': None,
          'bwd_ms': k6_step['bwd_ms'], 'bwd_bound_ms': k6_step['bwd_bound_ms'],
          'bwd_plain_ms': k6_step['bwd_plain_ms'],
          'bwd_launches': report['k6_bwd_launches'],
          'work': f'the per-image SSIM of the {FLAG_LOSS} loss of one '
                  f'flagship training step, x{k6_step["shape"]}, 11 taps; '
                  f'max_abs_err is per image against the plain version in '
                  f'float64 over {len(k6_rows)} shapes; bwd_* the backward '
                  f'kernel for y_pred and the range (bwd_plain_ms '
                  f'ssim_backward_reference; autograd through the plain ssim '
                  f'took {k6_step["autograd_bwd_ms"]:.4f} ms)'}
    print(json.dumps({'k1_shapes': report['k1_rows']}), flush=True)
    print(json.dumps({'k2_shapes': report['k2_rows']}), flush=True)
    print(json.dumps({'k3_shapes': k3_rows}), flush=True)
    print(json.dumps({'k4_shapes': report['k4_rows']}), flush=True)
    print(json.dumps({'k6_shapes': k6_rows}), flush=True)
    print(json.dumps({'k1_train_shapes': gates}), flush=True)
    print(json.dumps({k: v for k, v in report.items()
                      if not k.startswith(('k1_', 'k2_', 'k3_', 'k4_',
                                           'k6_rows'))}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': [k1, k2, k2_train, k3, k4, k1_train, k6]}),
          flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
