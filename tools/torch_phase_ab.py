"""Run `chip_smoke.py`'s phases 2 to 17 (or fewer, `--last`) of two or more
checkouts of the repository in turn on one card, each in a process of its
own, and print each run's phase seconds and the scalar numbers the phases
report (phase 6's per-layer times summed for a step, phase 7's and 8's
eager step rates, ...), so that two commits are compared on one machine.

    git archive <parent> | tar -x -C build/ab_parent
    python3 tools/torch_phase_ab.py build/ab_parent . . build/ab_parent

Each argument is the root of a checkout (a directory holding
`chip_smoke.py` and `dl4ds_tpu_torch/`); each run builds that checkout's
kernels into its own `build/kernels/`. Order the roots A, B, B, A so that
drift of the card or the host over the call shows. Writes the runs as
JSON to `--out` (default build/phase_ab.json) and prints a table of every
number that differs between the roots by more than `--show` (relative,
default 0.03), and every phase's seconds, step time and rate.
Needs CUDA."""

import argparse
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


def run_one(root, last):
    """The child: phases 2 .. `last` of the checkout at `root`; prints one
    JSON line of its numbers last."""
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
    for number, name in PHASES:
        if int(number) > last:
            break
        t0 = time.perf_counter()
        getattr(cs, name)(torch, tds, report)
        seconds[f'{number} {name}'] = time.perf_counter() - t0
        print(f'{root.name or root}: phase {number} ({name}) '
              f'{seconds[f"{number} {name}"]:.1f} s', flush=True)
    scalars = {k: v for k, v in report.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
    scalars.update(_step_sums(report))
    print(json.dumps({'root': str(root), 'card': cs.card_line(),
                      'build_s': build_s, 'phase_seconds': seconds,
                      'numbers': scalars}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('roots', nargs='*')
    ap.add_argument('--last', type=int, default=17,
                    help='the last phase to run (2 to 17)')
    ap.add_argument('--show', type=float, default=0.03)
    ap.add_argument('--out', default='build/phase_ab.json')
    ap.add_argument('--child', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        run_one(args.child, args.last)
        return 0
    if len(args.roots) < 2:
        ap.error('give two roots or more')
    runs = []
    for root in args.roots:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), '--child',
             root, '--last', str(args.last)],
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
                                 '8', '9')) or any(
            s in key for s in ('_step.', 'patches_per_s', 'step_ms'))
        if always or (got and min(got) > 0
                      and max(got) / min(got) - 1 > args.show):
            print(f'{key}: ' + ', '.join(
                'None' if v is None else f'{v:.6g}' for v in vals))
    return 0


if __name__ == '__main__':
    sys.exit(main())
