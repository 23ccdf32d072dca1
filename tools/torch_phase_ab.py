"""Run `chip_smoke.py`'s phases 2 to 17 (or fewer, `--last`; or the
phases `--phases` lists, such as 3,20) of two or more checkouts of the
repository in turn on one card, each in a process of its own, and print
each run's phase seconds and the scalar numbers the phases report (phase
6's per-layer times summed for a step, phase 7's and 8's eager step rates,
phase 20's int8 rates and forwards, ...), so that two commits are compared
on one machine.

    git archive <parent> | tar -x -C build/ab_parent
    python3 tools/torch_phase_ab.py build/ab_parent . . build/ab_parent
    python3 tools/torch_phase_ab.py --phases 3,20 --sites \
        build/ab_parent . . build/ab_parent

`--sites` also times, in each checkout, every int8 site as its quantized
forward calls it (the site module `quantization._Int8Conv` on the input it
met: whatever that checkout launches there, the activation's quantization,
the convolution and the bias included), each shape and summed over the
flagship's forward at batch 8 on phase 3's grids (widths 8 and 64) and
over the CLI artifact's forward (phase 21's model at batch 8), beside
phase 20's three extra sites of the zoo, and counts the int8 forward's device kernels a
batch in a torch.profiler trace.

Each argument is the root of a checkout (a directory holding
`chip_smoke.py` and `dl4ds_tpu_torch/`); each run builds that checkout's
kernels into its own `build/kernels/`. Order the roots A, B, B, A so that
drift of the card or the host over the call shows. Writes the runs as
JSON to `--out` (default build/phase_ab.json) and prints a table of every
number that differs between the roots by more than `--show` (relative,
default 0.03), and every phase's seconds, step time and rate.
Needs CUDA."""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# chip_smoke.py's phases 2 to 17 in its order: the later phases read what
# the earlier ones report
PHASES = (('2', 'phase_kernels'), ('3', 'phase_predict'),
          ('4', 'phase_convlstm'), ('5', 'phase_recurrent_predict'),
          ('6', 'phase_convlstm_grad'), ('6', 'phase_convlstm_split'),
          ('7', 'phase_training'), ('8', 'phase_wide_training'),
          ('9', 'phase_ssim'), ('10', 'phase_flagship_training'),
          ('11', 'phase_graphs'), ('12', 'phase_bf16'), ('13', 'phase_mos'),
          ('14', 'phase_pin'), ('15', 'phase_state'), ('16', 'phase_cgan'),
          ('17', 'phase_zoo_stream'))


def _step_sums(report):
    """Phase 6's and 12's per-layer times summed over a step's layers."""
    out = {}
    for key, rows in (('k3_step', report.get('k3_step')),
                      ('k4_step', report.get('k4_step'))):
        for name in ('k2_ms', 'k3_ms', 'k4_ms', 'tail_ms'):
            if rows and all(name in r for r in rows):
                out[f'{key}.{name}'] = sum(r[name] for r in rows)
    for key in ('bf16_k2_step', 'bf16_k3_step', 'bf16_k4_step',
                'bf16_k3_wide'):
        rows = report.get(key)
        if isinstance(rows, list) and rows and all('ms' in r for r in rows):
            out[f'{key}.ms'] = sum(r['ms'] for r in rows)
    return out


def _median_ms(cs, torch, fn, flush, reps=20):
    import statistics
    return statistics.median(cs.device_times(torch, fn, reps=reps,
                                             l2_flush=flush))


def _time_sites(cs, torch, calls, flush):
    """Device ms of each site call, as the forward makes it."""
    out = []
    for m, i, x in calls:
        def call(m=m, i=i, x=x):
            m.call = i
            return m(x)
        with torch.inference_mode():
            out.append(_median_ms(cs, torch, call, flush))
    return out


def _own_smoke():
    """This checkout's chip_smoke.py, whose site and trace helpers
    (`_int8_site_calls`, `_call_kernels`) `site_times` uses in every root's
    run: an older root's chip_smoke.py may lack them."""
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_ab', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def site_times(cs, torch, tds):
    """`--sites`: the checkout's int8 sites timed as its forward calls
    them, its int8 forward's device kernels a batch, and the forwards of
    each mode at widths 8 and 64 (the module docstring). `cs` is the
    root's chip_smoke.py."""
    import warnings
    from dl4ds_tpu_torch.models.blocks import Conv, ConvTranspose
    from dl4ds_tpu_torch.quantization import _Int8Conv
    warnings.simplefilter('ignore', RuntimeWarning)
    own = _own_smoke()
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device='cuda')
    hr, kwargs = cs._phase3_grids()
    out = {}
    for width in (cs.N_FILTERS, cs.Q_WIDE):
        model, net = cs._flagship_int8(tds, width=width)
        x, aux = (torch.from_numpy(a).cuda() for a in cs._served_inputs(
            torch, model, hr[:cs.BATCH], dict(kwargs, predictors=[
                kwargs['predictors'][0][:cs.BATCH]])))
        qf = tds.quantize_forward(model, net, x, aux)
        calls = own._int8_site_calls(torch, qf, (x, aux))
        ms = _time_sites(cs, torch, calls, flush)
        # the site that moves the most bytes: its input, then its output
        big = max(range(len(calls)), key=lambda j: (
            calls[j][2].numel(), calls[j][2][..., :1].numel()
            * calls[j][0].scale.shape[1]))
        tag = f'sites.w{width}'
        out[f'{tag}.n'] = len(calls)
        out[f'{tag}.sum_ms'] = sum(ms)
        out[f'{tag}.largest_ms'] = ms[big]
        out[f'{tag}.largest_x'] = str(list(calls[big][2].shape))
        for (m, _, xin), t in zip(calls, ms):     # each shape, its calls summed
            key = (f'site.w{width}.{"x".join(map(str, xin.shape))}->'
                   f'{m.scale.shape[1]}.{m.kh}x{m.kw}_ms')
            out[key] = out.get(key, 0.0) + t
        out[f'{tag}.int8_forward_kernels'] = len(own._call_kernels(
            torch, lambda: qf(x, aux)))
        m16, n16 = cs._flagship_int8(tds, width=width, dtype=torch.bfloat16)
        n16.load_state_dict(net.state_dict())
        with torch.inference_mode():
            for mode, fn in (('int8', lambda: qf(x, aux)),
                             ('f32', lambda: net(x, aux)),
                             ('bf16', lambda: n16(x, aux))):
                out[f'forward.w{width}.{mode}_ms'] = _median_ms(
                    cs, torch, fn, None, reps=10)
        del qf, calls, net, n16
        torch.cuda.empty_cache()
    # the CLI artifact's model (phase 21) at batch 8 on 32x32 LR grids
    model = tds.net_postupsampling(
        'resnet', 'spc', scale=cs.SCALE, n_channels=1, n_aux_channels=0,
        lr_size=(cs.TRAIN_PATCH // cs.SCALE,) * 2, n_filters=cs.N_FILTERS,
        n_blocks=cs.N_BLOCKS, attention=True)
    net = model.init(seed=0, device='cuda')
    x = torch.randn((cs.CLI_EXPORT_BATCH, 32, 32, 1), device='cuda')
    qf = tds.quantize_forward(model, net, x)
    calls = own._int8_site_calls(torch, qf, (x,))
    out['sites.cli.n'] = len(calls)
    out['sites.cli.sum_ms'] = sum(_time_sites(cs, torch, calls, flush))
    # phase 20's extra sites of the zoo as site modules, with a bias: a
    # width-64 3x3, the ConvNeXt depthwise 7x7 and the 'dc' head's 9x9
    # stride-2 transposed convolution
    gen = torch.Generator(device='cuda').manual_seed(20)
    for name, site, xs in (
            ('w64_3x3', Conv(64, 64, (3, 3)), (cs.BATCH, cs.LR, cs.LR, 64)),
            ('dw_7x7', Conv(8, 8, (7, 7), groups=8), (2, 64, 64, 8)),
            ('dc_9x9', ConvTranspose(8, 8, (9, 9), 2), (2, 32, 32, 8))):
        site.reset_parameters(torch.Generator().manual_seed(0))
        site.bias = torch.nn.Parameter(torch.randn(xs[-1]))
        site = site.cuda()
        x = torch.randn(xs, generator=gen, device='cuda')
        m = _Int8Conv(site, [float(x.abs().max()) / 127])
        out[f'sites.{name}_ms'] = _time_sites(cs, torch, [(m, 0, x)],
                                              flush)[0]
    return out


def run_one(root, last, phases=None, sites=False):
    """The child: phases 2 .. `last` (or the numbers in `phases`) of the
    checkout at `root`, then with `sites` `site_times`; prints one JSON
    line of its numbers last."""
    root = Path(root).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    import dl4ds_tpu_torch as tds
    import dl4ds_tpu_torch.export  # noqa: F401
    import dl4ds_tpu_torch.serve  # noqa: F401
    from dl4ds_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    report, seconds = {'phase_seconds': {}}, {}
    for number, name in PHASES + (('20', 'phase_quantization'),):
        if (phases is None and int(number) > last) or (
                phases is not None and int(number) not in phases):
            continue
        t0 = time.perf_counter()
        getattr(cs, name)(torch, tds, report)
        seconds[f'{number} {name}'] = time.perf_counter() - t0
        print(f'{root.name or root}: phase {number} ({name}) '
              f'{seconds[f"{number} {name}"]:.1f} s', flush=True)
    scalars = {k: v for k, v in report.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    scalars.update(_step_sums(report))
    for key, val in report.get('quant', {}).items():   # phase 20
        if isinstance(val, dict):
            scalars.update({f'quant.{key}.{k}': v for k, v in val.items()})
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            scalars[f'quant.{key}'] = val
    for key in ('k7_rows', 'k7_extra_rows'):
        if report.get(key):
            scalars.update({f'{key}.{k}': v for k, v in
                            cs._k7_totals(report[key]).items()
                            if isinstance(v, (int, float))})
    if sites:
        t0 = time.perf_counter()
        scalars.update(site_times(cs, torch, tds))
        seconds['sites'] = time.perf_counter() - t0
    print(json.dumps({'root': str(root), 'card': cs.card_line(),
                      'build_s': build_s, 'phase_seconds': seconds,
                      'numbers': scalars}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('roots', nargs='*')
    ap.add_argument('--last', type=int, default=17,
                    help='the last phase to run (2 to 17)')
    ap.add_argument('--phases', default=None,
                    help='the phases to run instead, comma-separated (of '
                         '2 to 17 and 20), in chip_smoke.py\'s order')
    ap.add_argument('--sites', action='store_true',
                    help='also time every int8 site as the forward calls '
                         'it (the module docstring)')
    ap.add_argument('--show', type=float, default=0.03)
    ap.add_argument('--out', default='build/phase_ab.json')
    ap.add_argument('--child', help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = (None if args.phases is None
              else {int(p) for p in args.phases.split(',')})
    if args.child:
        run_one(args.child, args.last, phases, args.sites)
        return 0
    if len(args.roots) < 2:
        ap.error('give two roots or more')
    runs = []
    for root in args.roots:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), '--child',
             root, '--last', str(args.last)]
            + ([] if args.phases is None else ['--phases', args.phases])
            + (['--sites'] if args.sites else []),
            capture_output=True, text=True)
        print(out.stdout[-4000:], flush=True)
        if out.returncode != 0:
            print(out.stderr[-8000:], file=sys.stderr, flush=True)
            print(f'{root}: exit {out.returncode}', file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    names = [r['root'] for r in runs]
    print(f'card: {runs[0]["card"]}; runs in order: {names}')
    table = [('build_s', [r['build_s'] for r in runs])]
    table += [(k, [r['phase_seconds'].get(k) for r in runs])
              for k in runs[0]['phase_seconds']]
    table += [(k, [r['numbers'].get(k) for r in runs])
              for k in sorted(runs[0]['numbers'])]
    for key, vals in table:
        got = [v for v in vals if isinstance(v, (int, float))]
        always = key.startswith(('build', '1', '2', '3', '4', '5', '6', '7',
                                 '8', '9', 'site', 'forward')) or any(
            s in key for s in ('_step.', 'patches_per_s', 'step_ms'))
        if vals and all(isinstance(v, str) for v in vals):
            print(f'{key}: ' + ', '.join(vals))
            continue
        if always or (got and min(got) > 0
                      and max(got) / min(got) - 1 > args.show):
            print(f'{key}: ' + ', '.join(
                'None' if v is None else f'{v:.6g}' for v in vals))
    return 0


if __name__ == '__main__':
    sys.exit(main())
