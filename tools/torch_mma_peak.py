#!/usr/bin/env python3
"""Peak rates of the instructions the ConvLSTM kernels' products run on, on
one GPU.

    python3 tools/torch_mma_peak.py        # from the repo root; needs nvcc

Builds tools/mma_peak.cu with the port's nvcc flags into build/tools/ and
times three loops that keep every SM busy with 8 independent chains a
thread: mma.sync.m16n8k8 TF32 products (K2 runs three for each float32
product, 3xTF32), float32 FMAs outside the tensor cores, and mma.sync
m16n8k16 bfloat16 products (one for each product of the bfloat16 forms of
K2, K3 and K4: the ceiling of their bound). Prints one JSON line with
each rate in TFLOP/s (the median of 5 timed launches on CUDA events) and the
card's name and power limit. Fails without a CUDA device.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS, BLOCKS_PER_SM = 4096, 8
FLOPS_PER_ROUND = {'mma_sync_tf32': 8 * 2 * 16 * 8 * 8,   # per warp
                   'ffma_f32': 8 * 2 * 32,
                   'mma_sync_bf16': 8 * 2 * 16 * 8 * 16}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_mma_peak: no CUDA device')
    sys.path.insert(0, str(ROOT))
    from dl4ds_tpu_torch.ops import _build
    lib_path = ROOT / 'build' / 'tools' / 'libmma_peak.so'
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib_path),
                    str(ROOT / 'tools' / 'mma_peak.cu')], check=True)
    fn = ctypes.CDLL(str(lib_path)).dl4ds_peak
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    card = subprocess.run(
        ['nvidia-smi', '--id=0', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    dev = torch.device('cuda')
    blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    out = torch.zeros(1, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for kind, (name, per_round) in enumerate(FLOPS_PER_ROUND.items()):
        times = []
        for rep in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if fn(kind, blocks, ITERS, out.data_ptr(), stream) != 0:
                sys.exit(f'torch_mma_peak: {name} did not launch')
            end.record()
            torch.cuda.synchronize()
            if rep:                       # the first launch warms up
                times.append(start.elapsed_time(end))
        flops = blocks * 8 * ITERS * per_round
        rates[name] = flops / statistics.median(times) / 1e9
    print(json.dumps({'card': card, 'tflops': rates}))


if __name__ == '__main__':
    main()
