#!/usr/bin/env python3
"""Per-launch device times of the ConvLSTM backward's kernels on one GPU.

    python3 tools/torch_chain_probe.py [--reps 30]   # from the repo root

At the layer shapes of the two recurrent training paths (batch 128, T 4,
16x16 LR patches; F 8 and 64, 3x3 and 5x5), with seeded random inputs,
float32, it times on CUDA events (medians of `reps` launches after 3 warm-up
ones, the launches queued behind a device sleep) each launch kind as the
backward's plans (`ops/convlstm.py` `_seq_plan`, `_wgrad_plan`) run it:
  chain  a chain step with its recurrent term (step 1) and the last step,
         which runs the gate epilogue alone (csrc/convlstm_seq.cu);
  dx     K3's dx over all B*T frames, at Cin = F (the same tile);
  wgrad  K3's Wx pass (Cin = F, with db) and Wh pass (csrc/convlstm_bwd.cu).
Prints one line per launch kind and shape, the card's name and power limit,
and one JSON object. Fails without a CUDA device.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH, T, SIZE = 128, 4, 16


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=30)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_chain_probe: no CUDA device')
    sys.path.insert(0, str(ROOT))
    import dl4ds_tpu_torch.ops.convlstm as conv
    from chip_smoke import device_times
    from dl4ds_tpu_torch.ops import _build
    _build.build_all(['convlstm_seq', 'convlstm_bwd'])
    card = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    dev = torch.device('cuda')
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(7)
    seq, bwd = conv._seq_lib(), conv._bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    b, t, h, w = BATCH, T, SIZE, SIZE

    def us(fn):
        return 1e3 * statistics.median(device_times(torch, fn, reps=args.reps))

    rows = []
    for f in (8, 64):
        for k in (3, 5):
            randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
            zs, dzs = randn(b, t, h, w, 4 * f), randn(b, t, h, w, 4 * f)
            cs, dys, x = (randn(b, t, h, w, f) for _ in range(3))
            wht = conv._flip_t(0.1 * randn(k, k, f, 4 * f))
            wxt = conv._flip_t(0.1 * randn(k, k, f, 4 * f))
            dcs = torch.zeros((b, h, w, f), device=dev)
            dx = torch.empty_like(x)
            p = conv._seq_plan(b, h, w, k, k, f, n_sm)
            pd = conv._seq_plan(b * t, h, w, k, k, f, n_sm)
            geo = [p[q] for q in ('ns', 'th', 'tw', 'cw', 'rps')]
            geod = [pd[q] for q in ('ns', 'th', 'tw', 'cw', 'rps')]
            row = {'f': f, 'k': k, 'plan': geo}
            for step, name in ((1, 'chain_us'), (t - 1, 'chain_last_us')):
                row[name] = us(lambda: seq.dl4ds_convlstm_seq_step(
                    zs.data_ptr(), cs.data_ptr(), dys.data_ptr(),
                    wht.data_ptr(), dzs.data_ptr(), dcs.data_ptr(), b, t,
                    step, h, w, f, k, k, *geo, stream))
            row['dx_us'] = us(lambda: seq.dl4ds_convlstm_dx(
                dzs.data_ptr(), wxt.data_ptr(), dx.data_ptr(), b * t, h, w, f,
                f, k, k, *geod, stream))
            for t_skip, name in ((0, 'wgrad_x_us'), (1, 'wgrad_h_us')):
                pw = conv._wgrad_plan(b, t, t_skip, h, w, f, f, k, k, n_sm)
                part = torch.empty((pw['n_chunks'], k * k * f * 4 * f + 4 * f),
                                   device=dev)
                row[name] = us(lambda: bwd.dl4ds_convlstm_wgrad(
                    x.data_ptr(), dzs.data_ptr(), part.data_ptr(),
                    pw['n_chunks'], int(t_skip == 0), b, t, t_skip, h, w, f,
                    f, k, k, *(pw[q] for q in ('tph', 'tpw', 'tpb', 'cwc',
                                               'tpc')), stream))
            rows.append(row)
            print(f'F {f} {k}x{k} (plan {geo}): chain step '
                  f'{row["chain_us"]:.1f} us, last step (epilogue alone) '
                  f'{row["chain_last_us"]:.1f} us, dx {row["dx_us"]:.1f} us, '
                  f'Wx {row["wgrad_x_us"]:.1f} us, Wh {row["wgrad_h_us"]:.1f}'
                  f' us', flush=True)
    print(card, flush=True)
    print(json.dumps({'device': torch.cuda.get_device_name(0), 'card': card,
                      'batch': b, 't': t, 'size': SIZE, 'rows': rows}),
          flush=True)


if __name__ == '__main__':
    main()
