#!/usr/bin/env python3
"""Where the device time of the port's deep ensemble goes.

    python3 tools/torch_ensemble_profile.py [--members 4] [--steps 5]
        [--model resnet_spc|recresnet_spc]

Builds the flagship (`net_postupsampling('resnet', 'spc', scale=4,
n_filters=8, n_blocks=6, attention=True)`, bench.py's widths), or with
`--model recresnet_spc` BASELINE config 4 (T 4, n_blocks 2, n_filters 8,
the ConvLSTM layers through K2-K4's member mode), as a stack of
`--members` members (`parallel.init_ensemble`), then profiles on one GPU,
under `torch.profiler`, `--steps` eager ensemble steps
(`parallel.make_ensemble_step`, mae, bootstrap on) at batch 128 on
chip_smoke.py phase 10's data (64x64 HR patches), and `predict_ensemble`
of 16 LR grids of 128x128 (16 windows of 4 for the recurrent model; TF32
convs, PyTorch's default). For each it
prints the span on the host clock, the device's busy time and share, and
the device time and kernel count a call by kernel group. Fails without a
CUDA device or when the profiler records no device kernel.
"""

import argparse
import collections
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# (group, name fragments) of a kernel, first match first
GROUPS = (('K1', ('ca_fwd', 'ca_bwd', 'ca_stream')), ('K6', ('ssim',)),
          ('K2', ('convlstm_tile',)), ('K4', ('split_chain',)),
          ('K3', ('chain_step', 'dx_frames', 'wgrad_tile', 'wgrad_reduce')),
          ('conv', ('conv', 'xmma', 'cudnn', 'implicit', 'winograd',
                    'fprop', 'dgrad', 'wgrad')),
          ('gemm', ('gemm', 'gemv')), ('adam', ('adam',)),
          ('reduce', ('reduce',)), ('elementwise', ('elementwise',
                                                    'vectorized')))


def group(name):
    low = name.lower()
    for label, parts in GROUPS:
        if any(p in low for p in parts):
            return label
    return 'other'


def profile(torch, label, fn, calls):
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit(f'{label}: the profiler recorded no device kernel')
    busy = sum(e.device_time for e in kernels) / 1e3 / calls
    ms, count = collections.Counter(), collections.Counter()
    for e in kernels:
        ms[group(e.name)] += e.device_time / 1e3 / calls
        count[group(e.name)] += 1 / calls
    print(f'{label}: span {span:.3f} ms a call (host clock, under the '
          f'profiler), device busy {busy:.3f} ms ({100 * busy / span:.1f}%), '
          f'{len(kernels) / calls:.0f} kernels; '
          + ', '.join(f'{g} {t:.3f} ms ({count[g]:.0f})'
                      for g, t in ms.most_common()), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--members', type=int, default=4)
    ap.add_argument('--steps', type=int, default=5)
    ap.add_argument('--model', choices=('resnet_spc', 'recresnet_spc'),
                    default='resnet_spc')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import dl4ds_tpu_torch as tds
    from dl4ds_tpu_torch import parallel
    from dl4ds_tpu_torch.ops import _build
    _build.build_all()
    recurrent = args.model == 'recresnet_spc'
    config = (cs._rec_config() if recurrent else cs._training_config(
        loss='mae', n_filters=cs.N_FILTERS, n_blocks=cs.N_BLOCKS,
        attention=True))
    model, batches = cs._ensemble_batches(torch, tds, config, cs.TRAIN_BATCH,
                                          args.steps + 1)
    stacked = parallel.init_ensemble(model, args.members, seed=0)
    es = parallel.make_ensemble_step(model, loss='mae', bootstrap=True)
    opt = es.init_opt(stacked)
    gen = torch.Generator(device='cuda').manual_seed(0)
    x = np.random.default_rng(0).standard_normal(
        (cs.N_GRIDS, cs.LR, cs.LR, 1)).astype('float32')
    if recurrent:
        x = np.stack([np.random.default_rng(0).standard_normal(
            (cs.REC_T, cs.LR, cs.LR, 1)).astype('float32')] * cs.N_GRIDS)

    def step(i):
        b = batches[i]
        es.step(stacked, opt, b['lr'], b['hr'], gen)
    step(args.steps)                        # warm-up: cuDNN's choices
    parallel.predict_ensemble(model, stacked, x)
    profile(torch, f'{args.model} ensemble step, {args.members} members, '
                   f'batch {cs.TRAIN_BATCH}', step, args.steps)
    profile(torch, f'{args.model} predict_ensemble, {args.members} members, '
                   f'{cs.N_GRIDS} inputs {tuple(x.shape[1:])}',
            lambda i: parallel.predict_ensemble(model, stacked, x), 3)
    print(cs.card_line(), flush=True)


if __name__ == '__main__':
    main()
