#!/usr/bin/env python3
"""K1's launch-plan regimes timed against each other on one GPU.

    python3 tools/torch_ca_regimes.py          # from the repo root

For the channel-attention gate's shapes on the flagship's paths (the six
128x128 serving backbone gates at batch 8, C = 8..48, and three training
gates at batch 128), float32 and bfloat16, it times the gate's forward and
backward kernels (`ops/fused_ops.py` `_launch`, `_launch_backward`) under
the plan `_ca_plan` makes from the card's limits and under a shared-memory
budget that leaves only the stream regime. Each time is the median of 20
calls on CUDA events with the 50 MB L2 flushed before each. Prints one line
per shape with each variant's regime, blocks a sample and forward/backward
ms, then the card's name and power limit. Fails without a CUDA device.
"""

import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ([(8, 128, 128, 8 * (i + 1)) for i in range(6)]
          + [(128, 16, 16, 8), (128, 16, 16, 48), (128, 64, 64, 8)])


def device_ms(torch, fn, flush, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_ca_regimes: no CUDA device')
    sys.path.insert(0, str(ROOT))
    from dl4ds_tpu_torch.ops import fused_ops as fo
    dev = torch.device('cuda:0')
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    limits = fo._ca_limits(dev)
    # a budget that no sample of these shapes fits, the stream regime's own
    # shared memory only
    variants = {'plan': limits,
                'stream': (limits[0], fo._ca_smem(2048, 8, 48, 12))}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            for shape in SHAPES:
                c = shape[-1]
                cr = max(c // 4, 1)
                x = torch.randn(shape, generator=gen, device=dev).to(dtype)
                dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
                w = [torch.randn(s, generator=gen, device=dev) * 0.5
                     for s in ((c, cr), (cr,), (cr, c), (c,))]
                cells = []
                for name, forced in variants.items():
                    fo._LIMITS['ca', dev.index] = forced
                    plan = fo._ca_plan(shape, cr, dtype, *forced)
                    _, m, g = fo._launch(x, *w)
                    fwd = device_ms(torch, lambda: fo._launch(x, *w), flush)
                    bwd = device_ms(
                        torch, lambda: fo._launch_backward(x, *w, dy, m, g),
                        flush)
                    cells.append(f'{name} ({plan["regime"]} {plan["parts"]}) '
                                 f'{fwd:.4f}/{bwd:.4f}')
                print(str(dtype).split('.')[-1], list(shape), ' | '.join(cells),
                      flush=True)
    finally:
        fo._LIMITS['ca', dev.index] = limits
    card = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f'forward/backward ms, median of 20 calls, L2 flushed; {card}')


if __name__ == '__main__':
    main()
