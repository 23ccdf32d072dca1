#!/usr/bin/env python3
"""Where the device time of a PyTorch port training step goes.

    python3 torch_train_profile.py [--model recresnet_spc|resnet_spc]
        [--loss mae] [--batch 128] [--reps 5] [--width 8] [--attention]
                                                     # from the repo root

Builds the training configuration of `chip_smoke.py` phase 7 (BASELINE
config 4 as bench_suite.py's measure_supervised trains it:
`SupervisedTrainer('resnet', 'spc', time_window=4, n_blocks=2,
n_filters=8, scale=4, patch_size=64, loss='mae')` on 256 seeded grids of
128x128, float32, TF32 convs as PyTorch's default), with `--width 64
--attention` that of phase 8 (bench_suite.py's recresnet_spc_width64), or
with `--model resnet_spc --attention` the flagship of phase 10 (bench.py's
resnet_spc: n_blocks 6, no time window; `--loss dssim_mae` as phase 10
trains it). Runs 3 warm-up steps, then `reps` steps (batch synthesis,
forward, backward, Adam) under `torch.profiler` on one GPU, and prints one
JSON line: device time per kernel group and for the top kernels, the device
time inside the backwards of K1 and K6 (read from record_function ranges
put around them here), the device's busy share over the profiled
window, launches and the host clock per step (the profiler slows the host;
chip_smoke.py times the steps without it). Fails when the profiler records
no device kernel.
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

# kernel-name fragments -> group; the first match wins
# (cuDNN's convolutions first; GEMMs with no convolution in their name,
# cuBLAS's among them, then fall to 'gemm')
GROUPS = [('K1_channel_attention', ('ca_fwd_resident', 'ca_bwd_resident',
                                     'ca_stream_sums', 'ca_stream_apply')),
          ('K6_ssim', ('ssim_image', 'ssim_tiles', 'ssim_pixels')),
          # the chain step: K3's on route 'fused' (n_filters 8), K4's on
          # 'split' (n_filters 64)
          ('K3_K4_chain_step', ('chain_step',)),
          ('K2_convlstm', ('convlstm_tile',)),
          ('K3_convlstm_bptt', ('dx_frames', 'wgrad_tile', 'wgrad_reduce')),
          ('adam', ('multi_tensor_apply', 'adam')),
          ('conv', ('conv', 'cudnn', 'implicit', 'winograd', 'fprop',
                    'nchw', 'nhwc', 'wgrad', 'dgrad')),
          ('gemm', ('gemm', 'xmma', 'sm90', 'sm80', 'cutlass')),
          ('cat', ('cat',)),
          ('reduce', ('reduce',)),
          ('elementwise', ('elementwise', 'vectorized', 'unrolled'))]


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


# autograd Functions whose backward is read apart from their forward (both
# are kernels of the same group): the device time inside a record_function
# range around the backward
ANNOTATED = {'K1_backward': ('fused_ops', 'FusedChannelAttention'),
             'K6_backward': ('fused_ops', 'FusedSSIM')}


def annotate_backwards(torch, ops):
    for label, (module, cls) in ANNOTATED.items():
        fn = getattr(getattr(ops, module), cls)
        inner = fn.backward

        def backward(ctx, *grads, inner=inner, label=label):
            with torch.profiler.record_function(label):
                return inner(ctx, *grads)
        fn.backward = staticmethod(backward)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--width', type=int, default=8, help='n_filters')
    ap.add_argument('--attention', action='store_true')
    ap.add_argument('--model', choices=('recresnet_spc', 'resnet_spc'),
                    default='recresnet_spc')
    ap.add_argument('--loss', default='mae')
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit('torch_train_profile: no CUDA device')
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import dl4ds_tpu_torch as tds
    import dl4ds_tpu_torch.ops as ops
    annotate_backwards(torch, ops)

    data = np.random.default_rng(0).standard_normal(
        (256, 128, 128, 1)).astype('float32')
    model = (dict(time_window=4, n_blocks=2)
             if args.model == 'recresnet_spc' else dict(n_blocks=6))
    tr = tds.SupervisedTrainer(
        'resnet', 'spc', data_train=data, data_val=data[:64],
        data_test=data[:64], scale=4, patch_size=64, batch_size=args.batch,
        loss=args.loss, n_filters=args.width, attention=args.attention,
        verbose=False, **model)
    tr.setup_datagen()
    tr.setup_model()
    tr.setup_optimizer()
    tr.net.train()
    gen = torch.Generator().manual_seed(0)
    idx = tr.ds_train.epoch_indices(gen, steps=3 + args.reps)
    for c in range(3):
        tr.train_step(tr.ds_train(idx[c], generator=gen))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in range(3, 3 + args.reps):
            tr.train_step(tr.ds_train(idx[c], generator=gen))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # the device events, without the ranges that record_function
    # annotations (such as Optimizer.step) also draw on the device's line
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device
               if not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        sys.exit('torch_train_profile: the profiler recorded no device '
                 'kernel')
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] += us
        by_group[group_of(e.name)] += us
    # the kernels inside each annotated range of the device's line (one
    # stream: a range holds exactly the kernels launched inside it)
    ranges = [e for e in device if e.name in ANNOTATED
              and getattr(e, 'is_user_annotation', False)]
    annotated = {label: None for label in ANNOTATED}
    for r in ranges:
        inside = sum(e.time_range.end - e.time_range.start for e in kernels
                     if e.time_range.start >= r.time_range.start
                     and e.time_range.end <= r.time_range.end)
        annotated[r.name] = (annotated[r.name] or 0.0) + inside
    busy_us = sum(by_name.values())
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    per = 1e3 * args.reps                 # us summed over reps -> ms a step
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    print(json.dumps({
        'device': torch.cuda.get_device_name(0), 'model': tr.model.name,
        'loss': args.loss, 'width': args.width, 'attention': args.attention,
        'batch': args.batch, 'reps': args.reps,
        'kernel_launches_per_step': len(kernels) / args.reps,
        'annotation_ranges_skipped': len(device) - len(kernels),
        'device_busy_ms_per_step': busy_us / per,
        'device_span_ms_per_step': span_us / per,
        'device_busy_share': busy_us / span_us,
        'host_ms_per_step': wall_s * 1e3 / args.reps,
        'patches_per_s_host': args.batch * args.reps / wall_s,
        'groups_ms_per_step': {g: v / per for g, v in sorted(
            by_group.items(), key=lambda kv: -kv[1])},
        'backward_ms_per_step': {
            k: None if v is None else v / per for k, v in annotated.items()},
        'top_kernels_ms_per_step': [[n[:90], v / per] for n, v in top],
    }))


if __name__ == '__main__':
    main()
