#!/usr/bin/env python3
"""Where the device time of a PyTorch port forward goes.

    python3 tools/torch_forward_profile.py [--model resnet_spc] [--batch 8]
                                           [--reps 5] [--dtype bf16]
                                           [--cudnn-benchmark]

Builds one of the port's full-width models with seeded weights (TF32 convs
as PyTorch's default):
  resnet_spc     the flagship, `net_postupsampling('resnet', 'spc', scale=4,
                 n_channels=4, n_aux_channels=2, lr_size=(128, 128),
                 n_filters=8, n_blocks=6, attention=True)`;
  recresnet_spc  the spatio-temporal model, `recnet_postupsampling('resnet',
                 'spc', scale=4, n_channels=2, n_aux_channels=2,
                 lr_size=(128, 128), time_window=4, n_filters=8,
                 n_blocks=2)`;
in the model dtype `--dtype` (f32, the default, or bf16: float32
parameters, bfloat16 convolutions and kernels), with cuDNN's algorithm
search (`torch.backends.cudnn.benchmark`) on under `--cudnn-benchmark`.
It runs `reps` forwards at `batch` under `torch.profiler` on one GPU and
prints one JSON line: device time per kernel group and for the top kernels,
the device's busy share over the profiled window, and the host clock per
forward. Fails when the profiler records no device kernel.
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

# kernel-name fragments -> group; the first match wins
GROUPS = [('K1_channel_attention', ('ca_fwd_resident', 'ca_stream_sums',
                                     'ca_stream_apply')),
          ('K2_convlstm', ('convlstm_tile',)),
          ('conv', ('conv', 'cudnn', 'xmma', 'implicit', 'winograd', 'sm90',
                    'gemm', 'nchw', 'nhwc')),
          ('cat', ('cat',)),
          ('elementwise', ('elementwise', 'vectorized', 'unrolled'))]


def group_of(name):
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', choices=('resnet_spc', 'recresnet_spc'),
                    default='resnet_spc')
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--dtype', choices=('f32', 'bf16'), default='f32')
    ap.add_argument('--cudnn-benchmark', action='store_true')
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit('torch_forward_profile: no CUDA device')
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import dl4ds_tpu_torch as tds

    dtype = {'f32': torch.float32, 'bf16': torch.bfloat16}[args.dtype]
    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    if args.model == 'resnet_spc':
        model = tds.net_postupsampling(
            'resnet', 'spc', scale=4, n_channels=4, n_aux_channels=2,
            lr_size=(128, 128), n_filters=8, n_blocks=6, attention=True,
            dtype=dtype)
    else:
        model = tds.recnet_postupsampling(
            'resnet', 'spc', scale=4, n_channels=2, n_aux_channels=2,
            lr_size=(128, 128), time_window=4, n_filters=8, n_blocks=2,
            dtype=dtype)
    net = model.init(0, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    x = torch.randn((args.batch, *model.input_shape), generator=gen,
                    device='cuda')
    aux = torch.randn((args.batch, 512, 512, 2), generator=gen,
                      device='cuda')
    with torch.inference_mode():
        for _ in range(3):
            net(x, aux)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                net(x, aux)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        sys.exit('torch_forward_profile: the profiler recorded no device '
                 'kernel')
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] += us
        by_group[group_of(e.name)] += us
    busy_us = sum(by_name.values())
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    per = 1e3 * args.reps             # us summed over reps -> ms per forward
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        'device': torch.cuda.get_device_name(0), 'model': model.name,
        'dtype': args.dtype, 'cudnn_benchmark': args.cudnn_benchmark,
        'batch': args.batch, 'reps': args.reps,
        'kernel_launches_per_forward': len(kernels) / args.reps,
        'device_busy_ms_per_forward': busy_us / per,
        'device_span_ms_per_forward': span_us / per,
        'device_busy_share': busy_us / span_us,
        'host_ms_per_forward': wall_s * 1e3 / args.reps,
        'groups_ms_per_forward': {g: v / per for g, v in sorted(
            by_group.items(), key=lambda kv: -kv[1])},
        'top_kernels_ms_per_forward': [[n[:90], v / per] for n, v in top],
    }))


if __name__ == '__main__':
    main()
