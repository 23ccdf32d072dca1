#!/usr/bin/env python3
"""How far float32 training steps of the port land from float64 ones.

    python3 tools/torch_train_parity.py [--width 64] [--batch 4]
        [--model recresnet_spc|resnet_spc] [--loss mae]     # repo root

Runs 3 Adam steps of the recurrent recresnet_spc x4 training configuration
of `chip_smoke.py` phases 7 and 8 (`SupervisedTrainer('resnet', 'spc',
time_window=4, n_blocks=2, n_filters=width, attention=True, patch_size=64,
loss='mae')` on 256 seeded grids of 128x128), or with `--model resnet_spc`
the flagship of phase 10 (n_blocks 6, no time window; `--loss dssim_mae` as
phase 10 trains it), from one seed, four ways: on
the GPU in float32 with cuDNN's convolutions and with PyTorch's own (TF32
off, cuDNN deterministic), and on the CPU in float32 and in float64. Prints
one JSON line: for each float32 run, the largest relative difference of its
3 losses and the largest parameter difference from the float64 run, with
the tensors that differ most. Fails without a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--width', type=int, default=64)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--model', choices=('recresnet_spc', 'resnet_spc'),
                    default='recresnet_spc')
    ap.add_argument('--loss', default='mae')
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_train_parity: no CUDA device')
    sys.path.insert(0, str(ROOT))
    import dl4ds_tpu_torch as tds
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    data = np.random.default_rng(0).standard_normal(
        (256, 128, 128, 1)).astype('float32')
    model = (dict(time_window=4, n_blocks=2)
             if args.model == 'recresnet_spc' else dict(n_blocks=6))
    config = dict(backbone='resnet', upsampling='spc', data_train=data,
                  data_val=data[:64], data_test=data[:64], scale=4,
                  patch_size=64, loss=args.loss, n_filters=args.width,
                  attention=True, verbose=False, **model)
    runs = {}
    for name, device, dtype, cudnn in (
            ('gpu_cudnn', 'cuda', torch.float32, True),
            ('gpu_own_convs', 'cuda', torch.float32, False),
            ('cpu_float32', 'cpu', torch.float32, True),
            ('cpu_float64', 'cpu', torch.float64, True)):
        torch.backends.cudnn.enabled = cudnn
        tr = tds.SupervisedTrainer(batch_size=args.batch, epochs=1,
                                   device=device, **config)
        tr.setup_datagen()
        tr.setup_model()
        tr.net.to(dtype)
        tr.setup_optimizer()
        tr.net.train()
        gen = torch.Generator().manual_seed(3)
        idx = tr.ds_train.epoch_indices(gen, steps=3)
        losses = []
        for c in range(3):
            batch = tr.ds_train(idx[c], generator=gen)
            losses.append(tr.train_step(
                {k: None if v is None else v.to(dtype)
                 for k, v in batch.items()}).item())
        runs[name] = (losses, {n: p.detach().cpu().double()
                               for n, p in tr.net.named_parameters()})
    torch.backends.cudnn.enabled = True
    ref_losses, ref = runs.pop('cpu_float64')
    out = {'device': torch.cuda.get_device_name(0), 'model': args.model,
           'loss': args.loss, 'width': args.width, 'batch': args.batch,
           'steps': 3}
    for name, (losses, params) in runs.items():
        diffs = sorted(((params[n] - ref[n]).abs().max().item(), n)
                       for n in ref)
        out[name] = {
            'loss_rel_diff': max(abs(a - b) / abs(b)
                                 for a, b in zip(losses, ref_losses)),
            'param_max_abs_diff': diffs[-1][0],
            'largest': [[n, d] for d, n in diffs[-3:]]}
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
