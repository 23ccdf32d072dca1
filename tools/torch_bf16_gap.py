#!/usr/bin/env python3
"""Where a bfloat16 model's output on the GPU parts from the CPU's.

    python3 tools/torch_bf16_gap.py [--out FILE]

Builds `chip_smoke.py` phase 12's serving cases (the full-width flagship
and recresnet_spc, seeded weights and inputs) in bfloat16 and runs grid 0
through `predict` on the CPU (the plain versions, convolutions taken in
float32 and rounded once) and on the GPU in five variants, each with one
source of difference to the CPU taken away:

  card        as served: cuDNN's bfloat16 convolutions, K1's mixed mode, K2;
  plain_gate  the plain gate `channel_attention_reference(...,
              out_dtype=float32)` on the GPU in place of K1;
  plain_conv  every bfloat16 convolution taken in float32 (TF32 off) and
              rounded once, the CPU's arithmetic, in place of cuDNN's;
  plain_k2    `convlstm_reference` on the GPU in place of K2;
  all_plain   the three together;

and, on the CPU, `cpu_float64_sums`: the CPU's own run with every
bfloat16 convolution (the ConvLSTM's too) summed in float64 before its
one rounding, the sums in another order and nothing else changed.

For each it prints max|d|/max|y| and mean|d|/mean|y| against the CPU, the
share of outputs that differ at all, and the card's float32 model's
distance from the bfloat16 output as the scale. One JSON line; `--out`
also writes it to a file.
"""

import argparse
import contextlib
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def _patched(torch, plain_gate, plain_conv, plain_k2):
    import torch.nn.functional as F
    from dl4ds_tpu_torch.models import blocks
    from dl4ds_tpu_torch.ops import convlstm as conv
    from dl4ds_tpu_torch.ops import fused_ops as fo
    saved = (blocks.fused_channel_attention, blocks.Conv.forward,
             blocks.fused_convlstm)

    def gate(x, w1, b1, w2, b2, out_dtype=None):
        return fo.channel_attention_reference(x, w1, b1, w2, b2,
                                              out_dtype=out_dtype)

    def conv_forward(self, x):
        if self.dtype == torch.float32:
            return saved[1](self, x)
        w = self.weight.to(self.dtype).float()
        y = F.conv2d(x.to(self.dtype).float().permute(0, 3, 1, 2), w,
                     padding=self.padding).to(self.dtype)
        y = y.permute(0, 2, 3, 1).contiguous()
        return y if self.bias is None else y + self.bias.to(self.dtype)

    def k2(x, wx, bx, wh):
        return conv.convlstm_reference(x, wx, bx, wh)[0]

    try:
        if plain_gate:
            blocks.fused_channel_attention = gate
        if plain_conv:
            blocks.Conv.forward = conv_forward
        if plain_k2:
            blocks.fused_convlstm = k2
        yield
    finally:
        (blocks.fused_channel_attention, blocks.Conv.forward,
         blocks.fused_convlstm) = saved


@contextlib.contextmanager
def _float64_sums(torch):
    """The CPU's bfloat16 convolutions summed in float64, then rounded
    once."""
    import torch.nn.functional as F
    from dl4ds_tpu_torch.models import blocks
    from dl4ds_tpu_torch.ops import convlstm as conv
    saved = blocks.Conv.forward, conv._acc

    def conv_forward(self, x):
        if self.dtype == torch.float32:
            return saved[0](self, x)
        w = self.weight.to(self.dtype).double()
        y = F.conv2d(x.to(self.dtype).double().permute(0, 3, 1, 2), w,
                     padding=self.padding).to(self.dtype)
        y = y.permute(0, 2, 3, 1).contiguous()
        return y if self.bias is None else y + self.bias.to(self.dtype)

    try:
        blocks.Conv.forward = conv_forward
        conv._acc = lambda t: t.double() if t.dtype == torch.bfloat16 else t
        yield
    finally:
        blocks.Conv.forward, conv._acc = saved


def _distance(y, ref):
    """max|d|/max|ref|, mean|d|/mean|ref| and the share of outputs that
    differ at all."""
    import numpy as np
    d = np.abs(y - ref)
    return dict(max_rel=float(d.max() / np.abs(ref).max()),
                mean_rel=float(d.mean() / np.abs(ref).mean()),
                differ_share=float((d > 0).mean()))


VARIANTS = {'card': (False, False, False), 'plain_gate': (True, False, False),
            'plain_conv': (False, True, False),
            'plain_k2': (False, False, True), 'all_plain': (True, True, True)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    import dl4ds_tpu_torch as tds
    if not torch.cuda.is_available():
        sys.exit('no CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {'card': cs.card_line()}
    for recurrent in (False, True):
        case = cs._serving_case(tds, recurrent)
        sl, kwargs = case['cpu_slice'], dict(case['kwargs'])
        kwargs['predictors'] = [kwargs['predictors'][0][sl]]
        hr = case['hr'][sl]
        model, model32 = (case['make'](dt) for dt in (torch.bfloat16,
                                                      torch.float32))
        net = model.init(seed=0, device='cuda')
        net32 = model32.init(seed=0, device='cuda')
        y_cpu = tds.predict((model, copy.deepcopy(net).cpu()), hr,
                            device='cpu', **kwargs)[:1].astype(np.float64)
        y32 = tds.predict((model32, net32), hr, **kwargs)[:1]
        row = {}
        for name, flags in VARIANTS.items():
            with _patched(torch, *flags):
                y = tds.predict((model, net), hr, **kwargs)[:1]
            row[name] = _distance(y, y_cpu)
            if name == 'card':
                # the scale: the float32 model from the bfloat16 one
                row['float32_model'] = dict(_distance(y32, y_cpu), **{
                    'from_card_bf16': _distance(y32, y)})
        with _float64_sums(torch):
            y = tds.predict((model, copy.deepcopy(net).cpu()), hr,
                            device='cpu', **kwargs)[:1]
        row['cpu_float64_sums'] = _distance(y, y_cpu)
        out[case['label']] = row
        print(case['label'], json.dumps(row), flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')


if __name__ == '__main__':
    main()
