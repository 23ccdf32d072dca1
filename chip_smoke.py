#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`dl4ds_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs nvcc

Phases, each of which exits non-zero on failure:
  1. check for a CUDA device, print the card's name and power limit, build
     every kernel from `dl4ds_tpu_torch/csrc/` with nvcc (one process per
     source, all started together);
  2. hold K1 (the channel-attention gate) against its plain PyTorch version
     on the card at the shapes the flagship path gives it (f32 and bf16),
     time both with CUDA events, and check the gate's autograd backward;
  3. drive the flagship path: full-width `predict` of the resnet_spc x4
     model (128x128 LR -> 512x512 HR, 2 static variables, 1 predictor) on 16
     grids at batch 8, count the kernel launches it made, and compare grid 0
     with the same model and weights run on the CPU;
  4. hold K2 (the ConvLSTM layer) against its plain version with TF32 off at
     the six layer shapes of the recresnet_spc model and at width 64, time
     both, check its other paths (other kernel sizes, channel counts that
     are not multiples of 4 or 8, one and two rows a thread), and check
     that weights that require grad raise;
  5. drive the spatio-temporal path: full-width `predict(time_window=4)` of
     the recresnet_spc x4 model on 19 grids (16 windows of 4) at batch 8,
     count its launches, and compare grid 0 and the last 4 grids with the
     same model run on the CPU;
  6. print the `kernels` JSON line, then, last, the device JSON line.

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
# spatio-temporal path: recresnet_spc x4 (BASELINE config 4), 2 recurrent
# blocks after the stem, 16 windows of 4 from 19 grids
REC_T, REC_BLOCKS, REC_GRIDS = 4, 2, 19
# (Cin, F, k) of the six ConvLSTM layers of one forward: the stem block
# takes the grid and the predictor, every block is a 5x5 then a 3x3 layer
K2_LAYERS = [layer for cin in [2] + [N_FILTERS] * REC_BLOCKS
             for layer in ((cin, N_FILTERS, 5), (N_FILTERS, N_FILTERS, 3))]
K2_WIDE = [(64, 64, 5), (64, 64, 3)]    # production width, bench_suite.py
K2_WIDE_LR = 32
# (B, T, H, W, Cin, F, kh, kw) of the kernel's other paths: with the shapes
# above they run each of its six bodies (1 or 2 rows a thread x 3x3, 5x5 or
# any other size)
K2_OTHER_PATHS = [(2, 3, 9, 41, 3, 6, 1, 3), (8, 3, 72, 100, 4, 4, 5, 5),
                  (8, 3, 72, 100, 5, 5, 7, 7), (8, 2, 40, 40, 6, 12, 3, 3)]
# kernel vs plain version with TF32 off: f32 sums in another order
K2_TOL = 1e-5


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


def k2_work(x, wx, wh):
    """(flops, bytes) a ConvLSTM layer needs: the input conv at every step,
    the recurrent conv from the second step on (h_{-1} = 0), x and the
    weights read once, ys written once."""
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
    from dl4ds_tpu_torch.ops.convlstm import _rows_per_thread
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
        rows.append(dict(x=list(x.shape), f=f, k=k, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         gflop=flops / 1e9,
                         bound_by=('operations' if flops / F32_FLOPS
                                   >= n_bytes / HBM_BYTES_PER_S
                                   else 'bytes')))
        print(f'K2 x{list(x.shape)} F={f} k={k}  max|d| {err:.3e}  kernel '
              f'{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} '
              f'ms ({flops / 1e9:.2f} GFLOP)  library_ms null (no single '
              f'PyTorch call computes a ConvLSTM layer)', flush=True)

    # the kernel's other paths, checked and not timed: a kernel size other
    # than 3x3 and 5x5, channel counts that are not multiples of 4 (scalar
    # loads), an odd F and F = 4 (the one channel group padded past F), two
    # channel groups, ragged tiles, and one and two rows a thread
    for i, (b, t, h, w, cin, f, kh, kw) in enumerate(K2_OTHER_PATHS):
        layer = ConvLSTM2D(cin, f, (kh, kw))
        layer.reset_parameters(torch.Generator().manual_seed(len(cases) + i))
        wx, bx, wh = (p.detach().to(dev) for p in (
            layer.input_conv.kernel, layer.input_conv.bias,
            layer.cell.recurrent_conv.kernel))
        x = torch.randn((b, t, h, w, cin), generator=gen, device=dev)
        with torch.no_grad():
            err = (fcl(x, wx, bx, wh)
                   - ref(x, wx, bx, wh)[0]).abs().max().item()
        py = _rows_per_thread(b, h, w, f, n_sm)
        print(f'K2 x{list(x.shape)} F={f} k={kh}x{kw} ({py} rows a thread)  '
              f'max|d| {err:.3e}', flush=True)
        if not err <= K2_TOL:
            fail(f'K2 x{list(x.shape)} F={f} k={kh}x{kw}: max|d| {err:.3e} '
                 f'against atol {K2_TOL}')

    layer = ConvLSTM2D(2, N_FILTERS, (3, 3)).to(dev)  # weights need grad
    try:
        layer(torch.randn((1, 2, 8, 8, 2), device=dev))
    except NotImplementedError as e:
        print(f'K2 with CUDA weights that require grad raises: {e}',
              flush=True)
    else:
        fail('K2 ran with CUDA weights that require grad')
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
    fwd = report['k2_forward']
    k2 = {'name': 'K2_convlstm', 'route': 'cuda',
          'source': 'dl4ds_tpu_torch/csrc/convlstm.cu',
          'replaces': 'dl4ds_tpu/ops/pallas_convlstm.py:219',
          'launches': report['k2_launches'],
          'max_abs_err': max(r['max_abs_err'] for r in report['k2_rows']),
          'ms': sum(r['ms'] for r in fwd),
          'plain_ms': sum(r['plain_ms'] for r in fwd),
          'bound_ms': sum(r['bound_ms'] for r in fwd),
          'bound_by': 'operations', 'library_ms': None,
          'work': f'the {len(fwd)} ConvLSTM layers of one float32 '
                  f'recresnet_spc forward at batch {BATCH}, T {REC_T}, '
                  f'summed'}
    print(json.dumps({'k1_shapes': report['k1_rows']}), flush=True)
    print(json.dumps({'k2_shapes': report['k2_rows']}), flush=True)
    print(json.dumps({k: v for k, v in report.items()
                      if not k.startswith(('k1_', 'k2_'))}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': [k1, k2]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
