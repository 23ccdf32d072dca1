"""Compare the one-model ConvLSTM backward kernels of two or more checkouts
of the repository on one card: `chip_smoke.py` phase 6's K3 (float32,
width 8, by launch kind from the profiler), its split route's K4 step
(width 64) and a bfloat16 width-8 K3 step (by launch kind), each checkout
in a process of its own; and the `ptxas` register and spill lines of the
chain-step, dx and weight-gradient kernels of each checkout's first run.

    git archive <parent> | tar -x -C build/ab_parent
    python3 tools/torch_k3_ab.py build/ab_parent . . build/ab_parent

Each argument is the root of a checkout (holding `chip_smoke.py` and
`dl4ds_tpu_torch/`); each builds its kernels into its own `build/kernels/`.
Order the roots A, B, B, A so that drift over the call shows. Prints one
line a number with its value in each run, and the card. Needs CUDA."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

_ENTRY = re.compile(r"Compiling entry function '[^']*?"
                    r"(chain_step|split_chain|dx_frames|wgrad_tile)I(\w+?)EEvNS_")
_ARG = re.compile(r'13__nv_bfloat16|f|Li(\d+)E|Lb([01])E')


def _template_args(mangled):
    """'float, 8, false' from the mangled template arguments 'fLi8ELb0E'."""
    return ', '.join(
        m.group(1) or {'0': 'false', '1': 'true'}.get(m.group(2))
        or ('bf16' if m.group(0).startswith('13') else 'float')
        for m in _ARG.finditer(mangled))


def _registers(logs):
    """'kernel<args>: N registers[, S bytes spilled]' lines from the ptxas
    output of the chain/dx and weight-gradient sources."""
    out, name = [], None
    for src in ('convlstm_seq', 'convlstm_bwd'):
        for line in logs.get(src, (0, ''))[1].splitlines():
            m = _ENTRY.search(line)
            if m:
                name = f'{m.group(1)}<{_template_args(m.group(2))}>'
                continue
            m = re.search(r'(\d+) bytes spill stores', line)
            if m and name and int(m.group(1)):
                out.append(f'{name}: {m.group(1)} bytes spilled')
            m = re.search(r'Used (\d+) registers', line)
            if m and name:
                out.append(f'{name}: {m.group(1)} registers')
                name = None
    return out


def _bf16_k3_step(torch, cs, conv):
    """ms and ms by launch kind of the bfloat16 BPTT of phase 6's width-8
    layers, timed as phase 12 times them."""
    dev, bf = torch.device('cuda'), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {'bf16_k3_ms': 0.0}
    for j, (cin, f, k) in enumerate(cs.K3_LAYERS):
        wx, bx, wh = (u.to(bf) for u in cs._layer_weights(
            torch, cin, f, k, k, 1600 + j, dev))
        x = torch.randn((cs.TRAIN_BATCH, cs.REC_T, cs.TRAIN_LR, cs.TRAIN_LR,
                         cin), generator=gen, device=dev).to(bf)
        need_dx = cin != 1
        with torch.no_grad():
            ys, c, zs = conv._launch(x, wx, bx, wh, train=True)
            args = (x, wx, wh, zs, c, ys, torch.randn_like(ys))
            ms, _ = cs.paired_ms(
                torch, lambda: conv._launch_backward(*args, need_dx),
                lambda: conv.convlstm_backward_reference(*args), flush)
            out['bf16_k3_ms'] += ms
            split = cs.kernel_split_ms(
                torch, lambda: conv._launch_backward(*args, need_dx),
                cs.K3_KERNELS)
        for kind, v in split.items():
            out[f'bf16_k3.{kind}'] = out.get(f'bf16_k3.{kind}', 0.0) + v
    return out


def run_one(root):
    """The child: the numbers of the checkout at `root`, one JSON line
    last."""
    root = Path(root).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    import dl4ds_tpu_torch as tds
    import dl4ds_tpu_torch.ops.convlstm as conv
    from dl4ds_tpu_torch.ops import _build
    registers = _registers(_build.build_all())
    report = {}
    with contextlib.redirect_stdout(io.StringIO()):
        cs.phase_convlstm_grad(torch, tds, report)
        cs.phase_convlstm_split(torch, tds, report)
    step = report['k3_step']
    out = {'k2_ms': sum(r['k2_ms'] for r in step),
           'k3_ms': sum(r['k3_ms'] for r in step)}
    for kind in step[0]['k3_split_ms']:
        out[f'k3.{kind}'] = sum(r['k3_split_ms'].get(kind, 0) for r in step)
    for key in ('k4_ms', 'k2_ms', 'tail_ms'):
        out[f'k4_step.{key}'] = sum(r[key] for r in report['k4_step'])
    out.update(_bf16_k3_step(torch, cs, conv))
    print(json.dumps({'root': str(root), 'card': cs.card_line(),
                      'registers': registers, 'numbers': out}), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--child':
        run_one(sys.argv[2])
        return 0
    roots = sys.argv[1:]
    if len(roots) < 2:
        sys.exit(__doc__)
    runs = []
    for root in roots:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              '--child', root], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-8000:], file=sys.stderr)
            print(f'{root}: exit {out.returncode}', file=sys.stderr)
            return 1
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f'{root}: {time.perf_counter() - t0:.1f} s', flush=True)
    for run, root in zip(runs, roots):
        if run['registers']:     # a run that built its kernels
            print(f'{root} ptxas: ' + '; '.join(run['registers']))
    print(f'card: {runs[0]["card"]}; runs in order: {roots}')
    for key in runs[0]['numbers']:
        print(f'{key}: ' + ', '.join(f'{r["numbers"].get(key, 0):.5f}'
                                     for r in runs))
    return 0


if __name__ == '__main__':
    sys.exit(main())
