"""
The int8 convolution (K7) of the port's post-training quantization
(`dl4ds_tpu_torch/quantization.py`).

K7 replaces no Pallas kernel: it takes the place of XLA's s8 x s8 -> s32
convolution in the JAX package's int8 replay (dl4ds_tpu/quantization.py:
276-282), which no PyTorch call computes on CUDA (`F.conv2d` has no integer
path there, and `torch.ao`'s quantized convolutions are CPU engines). It
computes, for an NHWC int8 x and an int8 weight packed by `pack_weight`,

    y[b, oy, ox, co] = out_dtype(float32(sum over taps and cin of x * w)
                                 * scale[co])

with the sum exact in int32 and scale[co] = s_x * s_w[co] formed in float32
by the caller (the JAX package's `_requant_scale`): one float32 multiply,
then the cast to the model dtype (bfloat16 rounds to nearest even). With
out_dtype int32 it returns the sums themselves (the checks' form). The
geometry is a correlation with `stride`, an input dilation `dilation` and
paddings (top, bottom, left, right): the port's `Conv` (SAME, VALID,
strided SAME split smaller half first, `groups` = Cin for ConvNeXt's
depthwise 7x7) and `ConvTranspose` (dilation = its stride, the unflipped
kernel), as `lax.conv_general_dilated` takes them. Other shapes raise
ValueError.

On a CUDA tensor `conv_int8` launches the hand-written Hopper kernel in
`csrc/conv_int8.cu` (the tensor cores' `mma.sync` m16n8k32 s8, or an
integer loop for depthwise) or raises; there is no fallback. On a CPU
tensor it computes the plain version, `conv_int8_reference`. It is the
`torch.library` operator `dl4ds_tpu_torch::conv_int8` with a fake kernel,
so that `torch.export` freezes it into an int8 serving artifact.
`conv_int8.launches` counts the CUDA kernel's launches.
"""

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .flops import conv_int8_flops

__all__ = ['conv_int8', 'conv_int8_reference', 'pack_weight',
           'quantize_activation', 'conv_out_size']

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
K_STEP = 32           # the packed K's multiple: one mma k-step (kBK)
CO_STEP = 64          # the packed rows' multiple: the widest column block
MAX_K = 133_000       # 127 * 127 * K stays inside int32 below this


def _lib():
    lib = _build.load('conv_int8')
    if lib.dl4ds_conv_int8.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dl4ds_conv_int8.argtypes = [i, i, i, i] + [p] * 4 + [i] * 15 + [p]
        lib.dl4ds_conv_int8.restype = ctypes.c_int
        lib.dl4ds_conv_int8_launched.restype = ctypes.c_longlong
    return lib


def quantize_activation(x, s_x):
    """x's int8 codes at the per-tensor scale s_x (a float32 tensor):
    clamp(round(x / s_x), -127, 127), x taken in float32, a division (not a
    reciprocal's multiply) and rounding half to even, as the JAX package's
    `jnp.round(x.astype(jnp.float32) / s_x)` (dl4ds_tpu/quantization.py:
    278-279)."""
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(
        torch.int8)


def pack_weight(w_q, groups=1):
    """The layout K7 reads, made once at quantization time from int8 codes
    w_q [Co, Cin / groups, kh, kw] (torch's OIHW): for groups 1 [Co_pad,
    K_pad] with k = (ky * kw + kx) * Cin + ci, zero-padded to multiples of
    64 rows and 32 columns; for depthwise (groups = Cin = Co) [C, kh * kw]."""
    co, cin_g, kh, kw = w_q.shape
    if groups != 1:
        if cin_g != 1 or groups != co:
            raise ValueError(f'int8 convolution: groups {groups} with a '
                             f'kernel {tuple(w_q.shape)}; it takes groups 1, '
                             f'or groups = Cin = Co (depthwise)')
        return w_q.reshape(co, kh * kw).contiguous()
    k = kh * kw * cin_g
    packed = torch.zeros((-(-co // CO_STEP) * CO_STEP, -(-k // K_STEP) * K_STEP),
                         dtype=torch.int8, device=w_q.device)
    packed[:co, :k] = w_q.permute(0, 2, 3, 1).reshape(co, k)
    return packed


def _unpack(w, co, cin, kh, kw, groups):
    """`pack_weight`'s inverse: OIHW int8 [Co, Cin / groups, kh, kw]."""
    if groups != 1:
        return w.reshape(co, 1, kh, kw)
    k = kh * kw * cin
    return w[:co, :k].reshape(co, kh, kw, cin).permute(0, 3, 1, 2)


def conv_out_size(n, k, stride, dilation, pad_before, pad_after):
    """Output length of one axis: the dilated input (n - 1) * dilation + 1,
    padded, correlated with k taps at `stride`."""
    return ((n - 1) * dilation + 1 + pad_before + pad_after - k) // stride + 1


def _check(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype):
    """Raise on what K7 does not take; returns (co, ho, wo)."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f'int8 convolution: x and w must be int8, got '
                        f'{x.dtype}, {w.dtype}')
    if scale.dtype != torch.float32 or scale.dim() != 1:
        raise TypeError(f'int8 convolution: scale must be float32 [Co], got '
                        f'{scale.dtype} {tuple(scale.shape)}')
    if out_dtype not in _OUT_CODES:
        raise ValueError(f'int8 convolution: out_dtype must be float32, '
                         f'bfloat16 or int32, got {out_dtype}')
    if x.dim() != 4:
        raise ValueError(f'int8 convolution: x must be NHWC, got shape '
                         f'{tuple(x.shape)}')
    if len(pads) != 4 or min(pads) < 0:
        raise ValueError(f'int8 convolution: pads must be four paddings '
                         f'(top, bottom, left, right) >= 0, got {pads}')
    if min(kh, kw, stride, dilation) < 1:
        raise ValueError(f'int8 convolution: kernel {kh}x{kw}, stride '
                         f'{stride}, dilation {dilation}')
    b, h, wd, cin = x.shape
    co = scale.shape[0]
    if groups == 1:
        k = kh * kw * cin
        if k > MAX_K:
            raise ValueError(f'int8 convolution: K = {k} taps x channels '
                             f'would overflow the int32 sum')
        if (w.dim() != 2 or w.shape[0] < co or w.shape[0] % CO_STEP
                or w.shape[1] < k or w.shape[1] % K_STEP):
            raise ValueError(f'int8 convolution: packed weight '
                             f'{tuple(w.shape)} does not fit Co {co}, K {k}')
    elif groups == cin and co == cin:
        if tuple(w.shape) != (co, kh * kw):
            raise ValueError(f'int8 convolution: depthwise weight '
                             f'{tuple(w.shape)}, expected {(co, kh * kw)}')
    else:
        raise ValueError(f'int8 convolution: groups {groups} with Cin {cin} '
                         f'and Co {co}; it takes groups 1, or groups = Cin = '
                         f'Co (depthwise)')
    ho = conv_out_size(h, kh, stride, dilation, pads[0], pads[1])
    wo = conv_out_size(wd, kw, stride, dilation, pads[2], pads[3])
    if b == 0 or ho < 1 or wo < 1:
        raise ValueError(f'int8 convolution: empty output from x '
                         f'{tuple(x.shape)}, kernel {kh}x{kw}, pads {pads}')
    return co, ho, wo


def conv_int8_reference(x, w, scale, kh, kw, stride=1, dilation=1,
                        pads=(0, 0, 0, 0), groups=1,
                        out_dtype=torch.float32):
    """K7's plain version: the sums taken exactly, in int32 on the CPU
    (`F.conv2d` of int32 tensors; of int8 tensors it would return int8 and
    wrap) or in float64 on a CUDA tensor (exact for these sums), then
    converted to float32, multiplied by scale and cast to out_dtype (int32:
    the sums)."""
    co, _, _ = _check(x, w, scale, kh, kw, stride, dilation, pads, groups,
                      out_dtype)
    b, h, wd, cin = x.shape
    wide = torch.int32 if x.device.type == 'cpu' else torch.float64
    xt = x.permute(0, 3, 1, 2).to(wide)
    if dilation > 1:
        xd = xt.new_zeros((b, cin, (h - 1) * dilation + 1,
                           (wd - 1) * dilation + 1))
        xd[:, :, ::dilation, ::dilation] = xt
        xt = xd
    xt = F.pad(xt, (pads[2], pads[3], pads[0], pads[1]))
    weight = _unpack(w, co, cin, kh, kw, groups).to(wide)
    acc = F.conv2d(xt, weight, stride=stride, groups=groups)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()
    if out_dtype == torch.int32:
        return acc
    return (acc.to(torch.float32) * scale).to(out_dtype)


def _plan(co, cin, x, w):
    """(column tiles of 8 channels a block, input bytes a load) of a dense
    launch: the fewest tiles that cover Co, up to 8; 16-byte loads where
    Cin and the pointers allow, else 4, else 1."""
    nt = 1
    while nt < 8 and nt * 8 < co:
        nt *= 2
    vec = 1
    for v in (16, 4):
        if cin % v == 0 and x.data_ptr() % v == 0 and w.data_ptr() % 16 == 0:
            vec = v
            break
    return nt, vec


def _launch(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype):
    co, ho, wo = _check(x, w, scale, kh, kw, stride, dilation, pads, groups,
                        out_dtype)
    dev = x.device
    if any(u.device != dev for u in (w, scale)):
        raise ValueError(f'int8 convolution needs every tensor on one CUDA '
                         f'device, got {[str(u.device) for u in (x, w, scale)]}')
    x, w, scale = (u.contiguous() for u in (x, w, scale))
    if w.data_ptr() % 16:
        w = w.clone()
    b, h, wd, cin = x.shape
    y = torch.empty((b, ho, wo, co), dtype=out_dtype, device=dev)
    depthwise = int(groups != 1)
    nt, vec = _plan(co, cin, x, w) if not depthwise else (1, 1)
    if -(-b * ho * wo // 128) >= 2 ** 31:
        raise ValueError(f'int8 convolution: too many output pixels for one '
                         f'launch: {b * ho * wo}')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().dl4ds_conv_int8(
            _OUT_CODES[out_dtype], depthwise, nt, vec, x.data_ptr(),
            w.data_ptr(), scale.data_ptr(), y.data_ptr(), b, h, wd, cin, ho,
            wo, co, kh, kw, stride, dilation, pads[0], pads[2],
            w.shape[1] if not depthwise else 0,
            w.shape[0] if not depthwise else co, stream)
    if err != 0:
        raise RuntimeError(f'int8 convolution kernel launch failed with CUDA '
                           f'error {err} (x {tuple(x.shape)}, kernel '
                           f'{kh}x{kw}, groups {groups}, nt {nt}, vec {vec})')
    conv_int8.launches += 1
    return y


@torch.library.custom_op('dl4ds_tpu_torch::conv_int8', mutates_args=())
def _conv_int8_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  kh: int, kw: int, stride: int, dilation: int,
                  pads: list[int], groups: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """K7 as the operator `dl4ds_tpu_torch::conv_int8`: its CUDA kernel is
    `_launch`, its CPU kernel `conv_int8_reference`, and its fake kernel
    gives the output's shape and dtype alone, so that `torch.export` traces
    a quantized network through it and freezes the node, not the launch."""
    raise ValueError(f'unsupported device {x.device}')


@_conv_int8_op.register_kernel('cuda')
def _(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype):
    return _launch(x, w, scale, kh, kw, stride, dilation, pads, groups,
                   out_dtype)


@_conv_int8_op.register_kernel('cpu')
def _(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype):
    return conv_int8_reference(x, w, scale, kh, kw, stride, dilation, pads,
                               groups, out_dtype)


@_conv_int8_op.register_fake
def _(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype):
    ho = conv_out_size(x.shape[1], kh, stride, dilation, pads[0], pads[1])
    wo = conv_out_size(x.shape[2], kw, stride, dilation, pads[2], pads[3])
    return x.new_empty((x.shape[0], ho, wo, scale.shape[0]), dtype=out_dtype)


@register_flop_formula(torch.ops.dl4ds_tpu_torch.conv_int8)
def _(x_shape, w_shape, scale_shape, kh, kw, stride, dilation, pads, groups,
      out_dtype, out_shape=None, **kwargs):
    return conv_int8_flops(x_shape, out_shape, kh, kw, groups)


def conv_int8(x, w, scale, kh, kw, stride=1, dilation=1, pads=(0, 0, 0, 0),
              groups=1, out_dtype=torch.float32):
    """K7 on x [B, H, W, Cin] int8 and `pack_weight`'s w: y [B, Ho, Wo, Co]
    in out_dtype (float32, bfloat16, or int32 for the sums), Co =
    len(scale). The kernel on a CUDA tensor, its plain version on a CPU
    tensor (the module docstring). `conv_int8.launches` counts the CUDA
    kernel's launches."""
    return _conv_int8_op(x, w, scale, int(kh), int(kw), int(stride),
                         int(dilation), [int(p) for p in pads], int(groups),
                         out_dtype)


conv_int8.launches = 0
