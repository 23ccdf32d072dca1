"""Model FLOPs of a call, counted alike on the CPU and the card: the
counterpart of `dl4ds_tpu/ops/flops.py`.

`count_flops(fn, *args, **kwargs)` runs the call once under
`torch.utils.flop_counter.FlopCounterMode` and returns the mathematical
matmul and convolution FLOPs it did, the backward's included when the call
differentiates: 2*M*N*K a product, 2*|out|*k_spatial*Cin/groups a
convolution, a transposed one over its input's grid (the JAX count divides
by the input dilation, which is the same number). Elementwise work and
reductions are not counted. The number is the numerator of a model-FLOPs
share.

The dispatch mode alone would miss the hand-written kernels or count them
by device: a `torch.library` operator is one opaque op to it, and an
extension call inside an `autograd.Function` is invisible on the card while
its plain version's products are seen on the CPU. So each kernel counts
the matmul and convolution FLOPs of its plain version, as the JAX package
counts its references on the CPU, by a formula on its shapes:

  * the operators `dl4ds_tpu_torch::channel_attention` (K1's forward),
    `::convlstm` (K2's inference variant) and `::conv_int8` (K7) through
    `register_flop_formula`, beside their fake kernels;
  * the `autograd.Function` kernels (K1's backward `_GateBackward`, K2's
    training variant and its BPTT by either route, K3 or K4 with the GEMM
    tail, in `FusedConvLSTM`, K6 both ways in `FusedSSIM` and
    `_SSIMBackward`) through `kernel_flops`, a context their bodies run
    in: while a count is under way it adds the formula and hides the body
    (the plain version on the CPU, the cuBLAS tail on the card) from the
    dispatch mode. Outside a count it does nothing.

The formulas are the products and convolutions of the JAX references'
jaxprs on the CPU, where the Pallas kernels run their references: K1 two
[B, C] x [C, Cr]-sized products forward and four backward; K2 the input
convolution over the B*T frames and T recurrent ones forward, and backward
the input convolution's weight gradient (and its dx, where asked), T
recurrent weight gradients and T - 1 recurrent dh (h starts at a constant
zero); K6 the two band products of the five stacked moments each way.
"""

import contextlib
import math

from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

__all__ = ['count_flops', 'kernel_flops', 'gate_flops', 'convlstm_flops',
           'ssim_flops', 'conv_int8_flops']

# the running totals of the kernels' formulas of the count_flops calls
# under way, innermost last (a list, not thread-local: the autograd engine
# runs a backward on threads of its own)
_COUNTS = []


@contextlib.contextmanager
def kernel_flops(flops):
    """Run a kernel's body in here. While `count_flops` is under way, add
    `flops` (a number, or a callable that gives it) to the count and hide
    the body from the dispatch-mode counter; otherwise do nothing."""
    if not _COUNTS:
        yield
        return
    _COUNTS[-1][0] += int(flops() if callable(flops) else flops)
    with _disable_current_modes():
        yield


def count_flops(fn, *args, **kwargs):
    """Mathematical matmul and convolution FLOPs of one call of
    `fn(*args, **kwargs)` (the module docstring), as a float, like the JAX
    `count_flops`. The call runs: give it the tensors of a real step, on
    the card or on the CPU, eagerly (a replayed CUDA graph dispatches
    nothing)."""
    total = [0]
    _COUNTS.append(total)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    finally:
        _COUNTS.pop()
    return float(counter.get_total_flops() + total[0])


def gate_flops(x_shape, w1_shape, backward=False):
    """K1 on x [B, H, W, C] with w1 [(M,) C, Cr]: the two products of the
    mean with w1 and of the hidden layer with w2, 2*B*C*Cr each; the
    backward four (dm, dw1, dh, dw2)."""
    per_product = 2 * x_shape[0] * x_shape[-1] * w1_shape[-1]
    return (4 if backward else 2) * per_product


def convlstm_flops(x_shape, wx_shape, backward=False, need_dx=True):
    """K2 on x [B, T, H, W, Cin] with wx [(M,) kh, kw, Cin, 4F] (the member
    mode counted as M one-member calls on B / M samples): forward the
    input convolution over the B*T frames and the T recurrent ones;
    backward the input weight gradient, its dx where `need_dx`, T
    recurrent weight gradients and T - 1 recurrent dh."""
    b, t, h, w, cin = x_shape
    kh, kw, _, f4 = wx_shape[-4:]
    f = f4 // 4
    per_pixel = 2 * b * h * w * f4 * kh * kw      # a frame's conv, / its Cin
    if not backward:
        return per_pixel * t * (cin + f)
    return per_pixel * (t * cin * (2 if need_dx else 1) + (2 * t - 1) * f)


def ssim_flops(shape, filter_size):
    """K6 on images [..., H, W, C], either way: the five stacked moments
    through the H band product ([Hv, H]) and then the W one ([Wv, W])."""
    *lead, h, w, c = shape
    hv, wv = h - filter_size + 1, w - filter_size + 1
    return 2 * 5 * math.prod(lead) * c * (w * hv * h + hv * wv * w)


def conv_int8_flops(x_shape, out_shape, kh, kw, groups):
    """K7: 2*|out|*kh*kw*Cin/groups, out [B, Ho, Wo, Co]."""
    return 2 * math.prod(out_shape) * kh * kw * (x_shape[-1] // groups)
