#!/usr/bin/env python3
"""Where the device time of a PyTorch port training step goes.

    python3 torch_train_profile.py [--model recresnet_spc|resnet_spc|
        convnet_pin|unet_pin|recresnet_pin|recconvnet_spc|
        recdensenet_spc] [--loss mae] [--batch 128] [--reps 5]
        [--width 8] [--attention] [--graphed] [--dtype bf16] [--mos]
        [--state convnext|bn_mc|recurrent] [--cgan [--time-window 4]]
        [--stream]
        # from the repo root

Builds the training configuration of `chip_smoke.py` phase 7 (BASELINE
config 4 as bench_suite.py's measure_supervised trains it:
`SupervisedTrainer('resnet', 'spc', time_window=4, n_blocks=2, n_filters=8,
scale=4, patch_size=64, loss='mae')` on 256 seeded grids of 128x128,
float32, TF32 convs as PyTorch's default), with `--width 64 --attention`
that of phase 8 (bench_suite.py's recresnet_spc_width64), or with `--model
resnet_spc --attention` the flagship of phase 10 (bench.py's resnet_spc:
n_blocks 6, no time window; `--loss dssim_mae` as phase 10 trains it); with
`--model convnet_pin` or `--model unet_pin` BASELINE configs 1 and 3 as
`chip_smoke.py` phase 14 trains them (bench_suite.py's convnet_pin_4x,
n_blocks 6, and unet_pin_4x, n_blocks 4 with the 'rc' decoder: the pre-
upsampled 64x64 patches, n_filters 8); with `--model recresnet_pin`
`chip_smoke.py` phase 17's (a) (time window 4, n_blocks 6, its ConvLSTM
layers on the 64x64 HR frames), with `--model recconvnet_spc` or
`recdensenet_spc` its (b) (phase 7's configuration with the merge
swapped); `--stream` streams the training batches from host RAM
(`data_in_hbm=False`: `HostStreamer`, each batch copied into the step's
inputs; graphed, `reps` streamed replays); `--dtype bf16` trains the bfloat16
model (float32 parameters, Adam and loss; bfloat16 convolutions and
kernels); `--mos` trains the flagship of `chip_smoke.py` phase 13 MOS-style,
from given LR arrays with two statics, a predictor and season channels
(`--batch`, `--dtype` and the model options above are still read; the model
is phase 13's); `--state` trains `chip_smoke.py` phase 15's (a) convnext_spc
with the localized layer on whole 128x128 grids (pass `--batch 32`, as phase
15 trains it), (b) the flagship with bn, 'mcdrop' and an EMA, or (c)
recresnet_spc with ln and 'mcspatialdrop' (`--batch` and `--dtype` still
read); `--cgan` trains `chip_smoke.py` phase 16's CGAN pair, (a) the bench's
(bench_suite.py's cgan_resnet_spc_4x) or with `--time-window 4` (b) the
spatio-temporal one, one fused G+D step a step (`--batch` and `--dtype`
still read). Runs 3 warm-up steps, then `reps` steps (batch synthesis, forward,
backward, Adam) under `torch.profiler` on one GPU, and prints one JSON line:
device time per kernel group and for the top kernels, every kernel's
launches and device time a step (`kernels_per_step`), the device time inside
the backwards of K1 and K6 (read from record_function ranges put around them
here), the device's busy share over the profiled window, launches and the
host clock per step (the profiler slows the host; chip_smoke.py times the
steps without it). With `--graphed` the steps are those
`SupervisedTrainer.run` replays: the step captured as a CUDA graph
(`training/graphs.py`), a chunk of `reps` plan rows uploaded and replayed
once to warm up, then once more under the profiler (the backwards are not
read apart there: no range runs inside a replay). Fails when the profiler
records no device kernel. """

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
          # the chain step: K3's on route 'fused', K4's on 'split' (the
          # same tile under two kernel names)
          ('K3_chain_step', ('chain_step',)),
          ('K4_chain_step', ('split_chain',)),
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
ANNOTATED = {'K1_backward': ('fused_ops', '_FusedGate'),
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
    ap.add_argument('--model', choices=('recresnet_spc', 'resnet_spc',
                                        'convnet_pin', 'unet_pin',
                                        'recresnet_pin', 'recconvnet_spc',
                                        'recdensenet_spc'),
                    default='recresnet_spc')
    ap.add_argument('--loss', default='mae')
    ap.add_argument('--graphed', action='store_true',
                    help='profile replays of the captured step')
    ap.add_argument('--dtype', choices=('f32', 'bf16'), default='f32')
    ap.add_argument('--mos', action='store_true',
                    help="chip_smoke.py phase 13's MOS training")
    ap.add_argument('--state', choices=('convnext', 'bn_mc', 'recurrent'),
                    help="chip_smoke.py phase 15's training (a), (b), (c)")
    ap.add_argument('--cgan', action='store_true',
                    help="chip_smoke.py phase 16's CGAN training")
    ap.add_argument('--time-window', type=int, choices=(4,),
                    help='with --cgan: the spatio-temporal pair, (b)')
    ap.add_argument('--stream', action='store_true',
                    help='stream the batches from the host')
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
    if not args.graphed:
        annotate_backwards(torch, ops)

    dtype = {'f32': torch.float32, 'bf16': torch.bfloat16}[args.dtype]
    if args.cgan:
        import chip_smoke
        config = chip_smoke._cgan_config(recurrent=bool(args.time_window),
                                         dtype=dtype)
        config['batch_size'] = args.batch
        tr = tds.CGANTrainer(data_in_hbm=not args.stream, **config)
        tr.setup_datagen()
        tr.setup_model()
        tr.setup_optimizer(args.reps)
        tr.train_net.train()
        model, arch = tr.generator, config['generator_params']
    elif args.mos or args.state:
        import chip_smoke
        config = (chip_smoke._state_config(args.state) if args.state
                  else chip_smoke._mos_config(tds)[0])
        tr = tds.SupervisedTrainer(batch_size=args.batch, dtype=dtype,
                                   data_in_hbm=not args.stream, **config)
    else:
        data = np.random.default_rng(0).standard_normal(
            (256, 128, 128, 1)).astype('float32')
        model = {'recresnet_spc': dict(time_window=4, n_blocks=2),
                 'resnet_spc': dict(n_blocks=6),
                 'convnet_pin': dict(backbone='convnet', upsampling='pin',
                                     n_blocks=6),
                 'unet_pin': dict(backbone='unet', upsampling='pin',
                                  n_blocks=4),
                 'recresnet_pin': dict(upsampling='pin', time_window=4,
                                       n_blocks=6),
                 'recconvnet_spc': dict(backbone='convnet', time_window=4,
                                        n_blocks=2),
                 'recdensenet_spc': dict(backbone='densenet', time_window=4,
                                         n_blocks=2)}[args.model]
        model.setdefault('backbone', 'resnet')
        model.setdefault('upsampling', 'spc')
        tr = tds.SupervisedTrainer(
            data_train=data, data_val=data[:64],
            data_test=data[:64], scale=4, patch_size=64,
            batch_size=args.batch, loss=args.loss, n_filters=args.width,
            attention=args.attention, verbose=False, dtype=dtype,
            data_in_hbm=not args.stream, **model)
    if not args.cgan:
        tr.setup_datagen()
        tr.setup_model()
        tr.setup_optimizer()
        tr.net.train()
        model, arch = tr.model, tr.architecture_params
    gen = torch.Generator().manual_seed(0)
    if args.graphed:
        from dl4ds_tpu_torch.training.supervised import StepRunner
        runner = StepRunner(tr, args.reps, {},
                            loss_shape=(4,) if args.cgan else ())
        if args.stream:
            def steps():
                runner.train_stream(tr.ds_train, args.reps)
            steps()
        else:
            runner.train(tr.ds_train.plan(gen, args.reps))
            plan = tr.ds_train.plan(gen, args.reps)

            def steps():
                runner.train(plan)
    elif args.stream:
        batches = tr.ds_train.stream(1, 3 + args.reps)
        for _ in range(3):
            tr.train_step(tr.ds_train.build(**next(batches)))

        def steps():
            for raw in batches:
                tr.train_step(tr.ds_train.build(**raw))
    else:
        idx = tr.ds_train.epoch_indices(gen, steps=3 + args.reps)
        for c in range(3):
            tr.train_step(tr.ds_train(idx[c], generator=gen))

        def steps():
            for c in range(3, 3 + args.reps):
                tr.train_step(tr.ds_train(idx[c], generator=gen))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps()
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
    count = defaultdict(int)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] += us
        count[e.name] += 1
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
        'device': torch.cuda.get_device_name(0), 'model': model.name,
        'dtype': args.dtype, 'mos': args.mos, 'state': args.state,
        'cgan': args.cgan, 'time_window': args.time_window,
        'stream': args.stream,
        'input_channels': model.input_shape[-1],
        'aux_channels': (model.aux_shape or (0,))[-1],
        'loss': tr.loss, 'width': arch['n_filters'],
        'attention': arch.get('attention', False),
        'batch': args.batch, 'reps': args.reps,
        'mode': 'graphed' if args.graphed else 'eager',
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
        'kernels_per_step': [[n, count[n] / args.reps, v / per] for n, v in
                             sorted(by_name.items(),
                                    key=lambda kv: (-count[kv[0]], -kv[1]))],
    }))


if __name__ == '__main__':
    main()
