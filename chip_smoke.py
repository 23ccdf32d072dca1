#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dl4ds_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs nvcc

Phases, each of which exits non-zero on failure:
  1. check for a CUDA device, print the card's name and power limit, build
     every kernel from `dl4ds_tpu_torch/csrc/` with nvcc;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it (f32 and bf16), time both with CUDA
     events, and check the gate's autograd backward;
  3. drive the main path: full-width `predict` of the flagship resnet_spc x4
     model (128x128 LR -> 512x512 HR, 2 static variables, 1 predictor) on 16
     grids at batch 8, count the kernel launches it made, and compare grid 0
     with the same model and weights run on the CPU;
  4. print the `kernels` JSON line, then, last, the device JSON line.

Imports nothing of JAX. Weights come from the port's own seeded init.
"""

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
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
# GPU (TF32 off) vs CPU forward of the whole model: f32 convs summed in
# other orders over ~20 layers, as in the CPU parity tests against JAX
PREDICT_TOL = dict(atol=1e-4, rtol=1e-4)


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


def phase_kernels(torch, tds, report):
    """Phase 2: K1 against its plain version at the path's shapes."""
    from dl4ds_tpu_torch.ops.fused_ops import FusedChannelAttention
    fca, ref = tds.fused_channel_attention, tds.channel_attention_reference
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = []
    for h, w, c in K1_SHAPES:
        cr = max(int(c / 4), 1)
        x32 = torch.randn((BATCH, h, w, c), generator=gen, device=dev)
        weights = (torch.randn((c, cr), generator=gen, device=dev) * 0.5,
                   torch.randn((cr,), generator=gen, device=dev) * 0.1,
                   torch.randn((cr, c), generator=gen, device=dev) * 0.5,
                   torch.randn((c,), generator=gen, device=dev) * 0.1)
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((str(dtype).split('.')[-1], x32.to(dtype), weights))

    rows = []
    for name, x, weights in cases:          # every shape checked first
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
        rows.append(dict(dtype=name, shape=list(x.shape),
                         cr=weights[0].shape[1], max_abs_err=err))

    for row, (name, x, weights) in zip(rows, cases):   # then timed
        c, cr = x.shape[-1], weights[0].shape[1]
        ms, plain_ms = paired_ms(torch, lambda: fca(x, *weights),
                                 lambda: ref(x, *weights), flush)
        n_bytes = 2 * x.numel() * x.element_size() + 4 * (2 * c * cr + c + cr)
        n_ops = 2 * x.numel() + 4 * BATCH * c * cr
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS) * 1e3
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   library_ms=None)
        print(f'K1 {name:8s} x{row["shape"]} cr={cr:2d}  max|d| '
              f'{row["max_abs_err"]:.3e}  kernel {ms:.4f} ms  plain '
              f'{plain_ms:.4f} ms  bound {bound_ms:.4f} ms  library_ms null '
              f'(no single PyTorch call computes the gate)', flush=True)

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
    print(f'K1 backward vs autograd through the plain version: max|d| '
          f'{grad_err:.3e} (atol 1e-4, rtol 1e-4)', flush=True)
    report['k1_rows'] = rows


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

    fca.launches = 0
    y = tds.predict((model, net), hr, **kwargs)
    launches = fca.launches
    expected = len(K1_SHAPES) * (-(-N_GRIDS // BATCH))
    print(f'predict: {model.param_count(net)} parameters, output '
          f'{y.shape}, K1 launches {launches} (expected {expected})',
          flush=True)
    if y.shape != (N_GRIDS, hr_size, hr_size, 1):
        fail(f'predict output shape {y.shape}')
    if not np.isfinite(y).all():
        fail('predict output is not finite')
    if launches != expected:
        fail(f'K1 launched {launches} times on the main path, expected '
             f'{expected}')
    report['k1_launches'] = launches

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
          'work': f'the {len(f32)} gates of one float32 forward at batch '
                  f'{BATCH}, summed'}
    print(json.dumps({'k1_shapes': report['k1_rows']}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': [k1]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
