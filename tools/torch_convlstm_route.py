#!/usr/bin/env python3
"""The ConvLSTM backward's route table: one layer's whole backward timed by
each route on one GPU.

    python3 tools/torch_convlstm_route.py [--out route_table.json]
                                          [--dtype bf16] [--size 64]
                                          [--widths 8]

For every layer shape F in {8, 16, 32, 64}, Cin in {1, F}, k in {3, 5} (the
six layer shapes of both recresnet_spc training paths among them: n_filters
8, BASELINE config 4, and n_filters 64, bench_suite.py's
recresnet_spc_width64), at batch 128, T 4 and 16x16 LR patches (`--size`:
64 for the 64x64 HR frames of recnet_pin; `--widths`: a subset of F),
float32, it
runs K2's training variant once for the residuals, then times the backward by
each route on CUDA events with the 50 MB L2 flushed before each call, in
turns (fused, split, split, fused):
  fused  K3: the chain steps and dx (csrc/convlstm_seq.cu), then the
         weight gradients and their reduction (csrc/convlstm_bwd.cu);
  split  K4, the same chain steps, then `convlstm_backward_tail`'s float32
         GEMMs;
and K4 and the tail alone. dx is formed except for Cin = 1 (the stem layer,
whose input needs no gradient). Both routes are held against the plain BPTT
run in float64 (max |d| / max |ref| of dx, dWx, dbx and dWh at most 1e-5).
Prints one line per shape and one JSON object with the table, the card's
name and power limit, and whether `dispatch_info` picks the faster route of
every shape; writes the JSON to --out too. Fails without a CUDA device or
when a route disagrees with the reference.

With `--dtype bf16` the layers are bfloat16 (the bfloat16 forms of K2, K3
and K4, and the tail's bfloat16 GEMMs), `dispatch_info` is asked with
itemsize 2, the bounds are at the bfloat16 mma.sync peak, and each route's
gradients are held against the plain tail run in float64 on the chain's
own dzs (each within 1e-2 of max |ref|: one rounding to bfloat16).
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TOL = {'f32': 1e-5, 'bf16': 1e-2}
# the products' ceilings: float32 outside the tensor cores, and the
# bfloat16 mma.sync peak (tools/torch_mma_peak.py, NVIDIA H100 80GB HBM3,
# 700 W)
PEAK_FLOPS = {'f32': 67e12, 'bf16': 643e12}
BATCH, T, SIZE = 128, 4, 16
WIDTHS = (8, 16, 32, 64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=None)
    ap.add_argument('--dtype', choices=('f32', 'bf16'), default='f32')
    ap.add_argument('--size', type=int, default=SIZE,
                    help='frame height and width')
    ap.add_argument('--widths', type=int, nargs='+', default=WIDTHS,
                    help='layer widths F')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_convlstm_route: no CUDA device')
    sys.path.insert(0, str(ROOT))
    import dl4ds_tpu_torch.ops.convlstm as conv
    from chip_smoke import _layer_weights, device_times
    from dl4ds_tpu_torch.ops import _build
    for name, (seconds, log) in _build.build_all().items():
        print(f'built {name} in {seconds:.1f} s\n{log}', file=sys.stderr,
              flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    dev = torch.device('cuda')
    dtype = {'f32': torch.float32, 'bf16': torch.bfloat16}[args.dtype]
    tol, peak = TOL[args.dtype], PEAK_FLOPS[args.dtype]
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    b, t, s = BATCH, T, args.size
    rows = []
    for f in args.widths:
        for cin in dict.fromkeys((1, f)):
            for k in (3, 5):
                wx, bx, wh = (u.to(dtype) for u in _layer_weights(
                    torch, cin, f, k, k, 300 + f + k, dev))
                x = torch.randn((b, t, s, s, cin), generator=gen,
                                device=dev).to(dtype)
                dys = torch.randn((b, t, s, s, f), generator=gen,
                                  device=dev).to(dtype)
                need_dx = cin != 1
                with torch.no_grad():
                    ys, cs, zs = conv._launch(x, wx, bx, wh, train=True)
                    res = (x, wx, wh, zs, cs, ys, dys)
                    if args.dtype == 'f32':
                        ref = conv.convlstm_backward_reference(
                            *(u.double() for u in res))
                    else:
                        dzs = conv._launch_seq(zs, cs, dys, wh)
                        ref = conv.convlstm_backward_tail(
                            *(u.double() for u in (x, wx, wh, ys, dzs)))
                    errs = {}
                    for route in ('fused', 'split'):
                        got = conv._backward(route, *res, need_dx)
                        errs[route] = max(
                            (g.double() - r).abs().max().item()
                            / max(r.abs().max().item(), 1e-30)
                            for g, r in zip(got, ref) if g is not None)
                        if not errs[route] <= tol:
                            sys.exit(f'torch_convlstm_route: {route} at '
                                     f'(Cin {cin}, F {f}, {k}x{k}) is off '
                                     f'by {errs[route]:.3e} of max |ref|')
                    del ref
                    def route_times(route):
                        return device_times(
                            torch, lambda: conv._backward(route, *res,
                                                          need_dx),
                            l2_flush=flush)
                    f1, s1 = route_times('fused'), route_times('split')
                    s2, f2 = route_times('split'), route_times('fused')
                    dzs = conv._launch_seq(zs, cs, dys, wh)
                    seq_ms = statistics.median(device_times(
                        torch, lambda: conv._launch_seq(zs, cs, dys, wh),
                        l2_flush=flush))
                    tail_ms = statistics.median(device_times(
                        torch, lambda: conv.convlstm_backward_tail(
                            x, wx, wh, ys, dzs, need_dx), l2_flush=flush))
                    del dzs
                fused_ms = statistics.median(f1 + f2)
                split_ms = statistics.median(s1 + s2)
                taps = k * k * b * s * s
                seq_flops = 2 * (t - 1) * taps * f * 4 * f
                tail_flops = 2 * taps * 4 * f * ((2 if need_dx else 1) * t
                                                 * cin + (t - 1) * f)
                info = conv.dispatch_info(x.shape, wx.shape, wh.shape,
                                          x.element_size())
                faster = 'split' if split_ms < fused_ms else 'fused'
                row = dict(cin=cin, f=f, k=k, dx=need_dx, fused_ms=fused_ms,
                           split_ms=split_ms, seq_ms=seq_ms, tail_ms=tail_ms,
                           seq_bound_ms=seq_flops / peak * 1e3,
                           tail_bound_ms=tail_flops / peak * 1e3,
                           fused_err=errs['fused'], split_err=errs['split'],
                           faster=faster, route=info['path'])
                rows.append(row)
                print(f'Cin {cin:2d} F {f:2d} {k}x{k}'
                      f'{"" if need_dx else " (no dx)"}  fused (K3) '
                      f'{fused_ms:.4f} ms  split {split_ms:.4f} ms (K4 '
                      f'{seq_ms:.4f}, bound {row["seq_bound_ms"]:.4f}; tail '
                      f'{tail_ms:.4f}, bound {row["tail_bound_ms"]:.4f})  '
                      f'faster: {faster}  dispatch_info: {info["path"]}  '
                      f'err fused {errs["fused"]:.2e} split '
                      f'{errs["split"]:.2e}', flush=True)
                del x, dys, ys, cs, zs, res
                torch.cuda.empty_cache()
    out = {'device': torch.cuda.get_device_name(0), 'card': card,
           'dtype': args.dtype, 'batch': b, 't': t, 'size': s, 'rows': rows,
           'table_matches': all(r['faster'] == r['route'] for r in rows)}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out) + '\n')


if __name__ == '__main__':
    main()
