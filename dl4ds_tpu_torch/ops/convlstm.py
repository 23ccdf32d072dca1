"""
Fused ConvLSTM layer forward (K2), the counterpart of
`dl4ds_tpu/ops/pallas_convlstm.py`'s `fused_convlstm` (inference variant).

On a CUDA tensor `fused_convlstm` launches the hand-written Hopper kernel in
`csrc/convlstm.cu`, once per time step; on a CPU tensor it computes the plain
PyTorch version, `convlstm_reference`. There is no size-based or error-based
fallback on the GPU. The layer's gradient is the BPTT backward (K3/K4), which
is not ported yet: on the GPU an input that requires grad raises.

Weights keep the JAX layout: wx [kh, kw, Cin, 4F] (HWIO), bx [4F],
wh [kh, kw, F, 4F], gates split along 4F in the order i, f, c, o.
Activations are [B, T, H, W, C].
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ..utils import not_ported

__all__ = ['fused_convlstm', 'convlstm_reference', 'hard_sigmoid']


def hard_sigmoid(x):
    """Keras hard_sigmoid, clip(0.2 x + 0.5, 0, 1): the ConvLSTM gate
    (not `F.hardsigmoid`, which is clip(x / 6 + 0.5, 0, 1))."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _conv_same(x, w):
    """SAME-padded stride-1 conv of NHWC x [N, H, W, C] with an HWIO kernel
    (odd sizes); NHWC out."""
    kh, kw = w.shape[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def convlstm_reference(x, wx, bx, wh):
    """Plain PyTorch whole layer (transcribes `convlstm_reference`,
    dl4ds_tpu/ops/pallas_convlstm.py:82-112): the input conv over all B*T
    frames at once, then the recurrent conv, gates and state updates step by
    step. x: [B, T, H, W, Cin]; returns (ys, cs): [B, T, H, W, F]."""
    _check_kernels(x, wx, bx, wh)
    b, t, h, w, cin = x.shape
    f = wh.shape[2]
    zx = _conv_same(x.reshape(b * t, h, w, cin), wx) + bx
    zx = zx.reshape(b, t, h, w, 4 * f)
    hh = x.new_zeros((b, h, w, f))
    cc = x.new_zeros((b, h, w, f))
    ys, cs = [], []
    for i in range(t):
        z = zx[:, i] + _conv_same(hh, wh)
        zi, zf, zc, zo = torch.split(z, f, dim=-1)
        cc = hard_sigmoid(zf) * cc + hard_sigmoid(zi) * torch.tanh(zc)
        hh = hard_sigmoid(zo) * torch.tanh(cc)
        ys.append(hh)
        cs.append(cc)
    return torch.stack(ys, dim=1), torch.stack(cs, dim=1)


def _check_kernels(x, wx, bx, wh):
    if x.ndim != 5:
        raise ValueError(f'ConvLSTM x must be [B, T, H, W, Cin], got '
                         f'{tuple(x.shape)}')
    cin = x.shape[-1]
    kh, kw, f4 = wx.shape[0], wx.shape[1], wx.shape[-1]
    f = f4 // 4
    if (wx.ndim != 4 or wx.shape[2] != cin or f4 != 4 * f or f == 0
            or tuple(wh.shape) != (kh, kw, f, f4) or tuple(bx.shape) != (f4,)):
        raise ValueError(
            f'ConvLSTM weights do not match x [.., {cin}]: wx '
            f'{tuple(wx.shape)}, bx {tuple(bx.shape)}, wh {tuple(wh.shape)}')
    if kh % 2 == 0 or kw % 2 == 0:
        raise NotImplementedError(
            f'even ConvLSTM kernel {kh}x{kw}: SAME padding would be '
            f'asymmetric')


def _kernel_lib():
    lib = _build.load('convlstm')
    fn = lib.dl4ds_convlstm_step
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _rows_per_thread(b, h, w, f, n_sm):
    """Rows of output a thread computes (at one column, for a group of 8
    channels and all four gates). A block tiles 8*rows by 32 columns; rows
    is 2 unless that leaves an SM without a block."""
    blocks = b * -(-f // 8) * -(-w // 32) * -(-h // 16)
    return 2 if blocks >= n_sm else 1


def _launch(x, wx, bx, wh):
    """Run the CUDA kernel over the whole window: T step launches on the
    current stream. Returns ys [B, T, H, W, F]."""
    tensors = (x, wx, bx, wh)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            f'the ConvLSTM kernel takes float32 only, got '
            f'{[str(t.dtype) for t in tensors]}; other model dtypes are not '
            f'ported yet (ROADMAP.md queue 1, item 5)')
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise not_ported('the ConvLSTM gradient (BPTT kernels K3/K4, '
                         'recurrent training)', 7)
    _check_kernels(x, wx, bx, wh)
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    if b * t * h * w == 0:
        raise ValueError(f'ConvLSTM kernel got an empty x {tuple(x.shape)}')
    if b > 65535:
        raise ValueError(f'ConvLSTM kernel takes at most 65535 samples per '
                         f'call, got {b}')
    dev = x.device
    if dev.type != 'cuda' or any(u.device != dev for u in tensors):
        raise ValueError(f'ConvLSTM kernel needs every tensor on one CUDA '
                         f'device, got {[str(u.device) for u in tensors]}')
    # contiguous HWIO weights: a module moved with memory_format=
    # channels_last holds these 4-D kernels with permuted strides
    x, wx, bx, wh = (u.contiguous() for u in tensors)
    if x.data_ptr() % 16:           # the kernel reads x as float4
        x = x.clone()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    py = _rows_per_thread(b, h, w, f, n_sm)
    ys = torch.empty((b, t, h, w, f), dtype=torch.float32, device=dev)
    c = torch.empty((b, h, w, f), dtype=torch.float32, device=dev)
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for step in range(t):
            err = fn(x.data_ptr(), wx.data_ptr(), bx.data_ptr(),
                     wh.data_ptr(), ys.data_ptr(), c.data_ptr(), b, t, step,
                     h, w, cin, f, kh, kw, py, stream)
            if err != 0:
                raise RuntimeError(f'ConvLSTM kernel launch failed with CUDA '
                                   f'error {err} (step {step})')
            fused_convlstm.launches += 1
    return ys


def fused_convlstm(x, wx, bx, wh):
    """Whole ConvLSTM layer forward: ys [B, T, H, W, F] from x
    [B, T, H, W, Cin] (h and c start at zero).

    On CUDA tensors: the Hopper kernel, one launch per time step, float32
    only, no gradient. On CPU tensors: `convlstm_reference` (differentiable
    through autograd). `fused_convlstm.launches` counts kernel launches; the
    CPU path launches nothing."""
    if x.device.type == 'cuda':
        return _launch(x, wx, bx, wh)
    if x.device.type == 'cpu':
        return convlstm_reference(x, wx, bx, wh)[0]
    raise ValueError(f'unsupported device {x.device}')


fused_convlstm.launches = 0
