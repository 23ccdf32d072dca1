"""
The int8 convolution (K7) of the port's post-training quantization
(`dl4ds_tpu_torch/quantization.py`): one int8 site in one launch.

K7 replaces no Pallas kernel: it takes the place of the JAX package's int8
replay at a site (dl4ds_tpu/quantization.py:276-282), the activation's
quantization, XLA's s8 x s8 -> s32 convolution, which no PyTorch call
computes on CUDA (`F.conv2d` has no integer path there, and `torch.ao`'s
quantized convolutions are CPU engines), and the rescale, with Flax's bias
add after them. For an NHWC x and an int8 weight packed by `pack_weight`
it computes

    x_q = clamp(round(float32(x_site) / s_x), -127, 127)
    y[b, oy, ox, co] = out_dtype(float32(sum over taps and cin of x_q * w)
                                 * scale[co]) (+ bias[co] in out_dtype)

x is the site's input, float32 or bfloat16, quantized at the per-tensor
scale s_x (a one-element float32 tensor on x's device: a division, not a
reciprocal's multiply, rounding half to even, as the JAX package's
`jnp.round(x.astype(jnp.float32) / s_x)`); x_site is x rounded to
out_dtype first (a float32 tensor entering a bfloat16 site), or x itself
for int32 sums. Or x is int8 codes, taken as they are, with no s_x (the
checks' form). The sum is exact in int32; scale[co] = s_x * s_w[co] is
formed in float32 by the caller (the JAX package's `_requant_scale`): one
float32 multiply, then the cast to the model dtype (bfloat16 rounds to
nearest even), then the bias, in out_dtype as Flax adds it (a bfloat16 sum
taken in float32 and rounded once, as PyTorch's). With out_dtype int32 it
returns the sums themselves and takes no bias. The geometry is a
correlation with `stride`, an input dilation `dilation` and paddings (top,
bottom, left, right): the port's `Conv` (SAME, VALID, strided SAME split
smaller half first, `groups` = Cin for ConvNeXt's depthwise 7x7) and
`ConvTranspose` (dilation = its stride, the unflipped kernel), as
`lax.conv_general_dilated` takes them. Other shapes raise ValueError.

On a CUDA tensor `conv_int8` launches the hand-written Hopper kernel in
`csrc/conv_int8.cu` or raises; there is no fallback. The dense kernel walks
8 x 16-pixel output tiles in persistent blocks; each tile's input window
arrives once (TMA boxes, or cp.async, in a ring of two to four stages), is
quantized once in shared memory, and feeds `mma.sync` m16n8k32 s8 for every
tap and every column block; a transposed site runs dilation x dilation
output phases, each over the taps that land on real pixels; the epilogue
rescales, casts, adds the bias and stores whole pixels. Depthwise sites
run an integer loop that quantizes as it loads. `_layout` is the plan both
sides share: the channel chunk of the window, the column block, the
packed weight's extents; `launch_plan` reports the choices the launch
makes on the card (how the window arrives, the stages, the shared memory,
the blocks an SM, the epilogue). On a
CPU tensor `conv_int8` computes the plain version, `conv_int8_reference`:
`quantize_activation`, the dilated correlation in int32 (independent of
the kernel's phase split) and the rescale and bias as above. It is the
`torch.library` operator `dl4ds_tpu_torch::conv_int8` with a fake kernel,
so that `torch.export` freezes the fused site into an int8 serving
artifact. `conv_int8.launches` counts the CUDA kernel's launches.
"""

import ctypes
import functools
from collections import namedtuple
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .flops import conv_int8_flops

__all__ = ['conv_int8', 'conv_int8_reference', 'pack_weight',
           'quantize_activation', 'conv_out_size', 'launch_plan']

_X_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
TILE_H, TILE_W = 8, 16     # the dense kernel's output tile (csrc: kTH, kTW)
MAX_COLS = 128             # channels of a column block
SMEM_PLAN = 220 * 1024     # a dense block's shared memory at float32, at most
RESIDENT = 96 * 1024       # a packed weight kept whole in shared memory, at most
MAX_K = 133_000            # 127 * 127 * K stays inside int32 below this

Layout = namedtuple('Layout', 'cc n_chunks kcp nb co_pad n_cls')


def _lib():
    lib = _build.load('conv_int8')
    if lib.dl4ds_conv_int8.argtypes is None:
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dl4ds_conv_int8.argtypes = ([i] * 4 + [p] * 6 + [i] * 4
                                        + [q] * 3 + [i] * 14 + [p])
        lib.dl4ds_conv_int8.restype = ctypes.c_int
        lib.dl4ds_conv_int8_plan.argtypes = lib.dl4ds_conv_int8.argtypes + [p]
        lib.dl4ds_conv_int8_plan.restype = ctypes.c_int
        lib.dl4ds_conv_int8_launched.restype = ctypes.c_longlong
    return lib


def _up(n, m):
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def _layout(cin, co, kh, kw, stride=1, dilation=1):
    """The dense kernel's plan, shared by `pack_weight`, the checks and the
    launch: columns in blocks of nb <= 128 (a multiple of 16, Co padded to
    co_pad = nb x blocks), which a block runs in turn over one quantized
    window; the input window in channel chunks of cc, all Cin (rounded up
    to 4) where the block's shared memory (two float32 window stages, the
    weight, whole or a chunk of a column block at a time, the int8 window
    of every chunk) fits SMEM_PLAN, else the widest chunk
    that fits; a chunk's packed k extent kcp = its taps x cc rounded up to
    one mma k step (32); a transposed site's dilation x dilation residue
    classes of taps."""
    d = dilation
    khc, kwc = -(-kh // d), -(-kw // d)
    taps = khc * kwc
    wh, ww = (TILE_H - 1) * stride + khc, (TILE_W - 1) * stride + kwc
    blocks = -(-co // MAX_COLS)
    nb = _up(-(-co // blocks), 16)
    co_pad = nb * blocks

    def smem(cc, chunked):      # csrc/conv_int8.cu `derive`, float32 x, y
        kcp = _up(taps * cc, 32)
        all_cc = -(-cin // cc) * cc
        if cc % 16 == 0:
            pitch = all_cc + (16 if (all_cc // 16) % 2 == 0 else 0)
        else:
            pitch = _up(all_cc, 4) + (4 if _up(all_cc, 4) % 32 == 0 else 0)
        stage = _up(wh * ww * cc * 4, 128)
        resident = not chunked and co_pad * (kcp + 16) <= RESIDENT
        weight = (_up((co_pad + 8) * (kcp + 16), 128) if resident
                  else 2 * _up((nb + 8) * (kcp + 16), 128))
        return (128 + 2 * stage + weight + _up(wh * ww * pitch, 128)
                + _up(kcp, 128))

    cp4 = _up(cin, 4)
    choices = [(cp4, False)] + [(c, True) for c in (256, 192, 128, 96, 64, 32, 16,
                                                    8, 4) if c < cp4]
    for cc, chunked in choices:
        if smem(cc, chunked) <= SMEM_PLAN:
            break
    else:
        raise ValueError(f'int8 convolution: a {kh}x{kw} kernel at stride '
                         f'{stride} over {co} columns does not fit one '
                         f'block\'s shared memory')
    return Layout(cc, -(-cin // cc), _up(taps * cc, 32), nb, co_pad, d * d)


def _pack_index(cin, co, kh, kw, lay, dilation):
    """(row, column) in the packed weight of each element of an OIHW weight
    [Co, Cin, kh, kw]: row = class * co_pad + co, column = chunk * kcp +
    tap * cc + ci_in_chunk, the tap (i, j) of ky = ry + d i, kx = rx + d j
    counted i * (taps a row of its class) + j."""
    d = dilation
    ky, kx = torch.arange(kh), torch.arange(kw)
    kwc = -(-(kw - kx % d) // d)                       # taps a row of kx's class
    tap = (ky // d)[:, None] * kwc[None, :] + (kx // d)[None, :]
    cls = (ky % d)[:, None] * d + (kx % d)[None, :]
    ci = torch.arange(cin)
    row = cls[None, None] * lay.co_pad + torch.arange(co)[:, None, None, None]
    col = ((ci // lay.cc)[:, None, None] * lay.kcp + tap[None] * lay.cc
           + (ci % lay.cc)[:, None, None])
    return torch.broadcast_tensors(row, col[None])


def quantize_activation(x, s_x):
    """x's int8 codes at the per-tensor scale s_x (a float32 tensor):
    clamp(round(x / s_x), -127, 127), x taken in float32, a division (not a
    reciprocal's multiply) and rounding half to even, as the JAX package's
    `jnp.round(x.astype(jnp.float32) / s_x)` (dl4ds_tpu/quantization.py:
    278-279)."""
    return torch.clamp(torch.round(x.float() / s_x), -127, 127).to(
        torch.int8)


def pack_weight(w_q, groups=1, stride=1, dilation=1):
    """The layout K7 reads, made once at quantization time from int8 codes
    w_q [Co, Cin / groups, kh, kw] (torch's OIHW) for a site of that stride
    and input dilation: for depthwise (groups = Cin = Co) [C, kh * kw]; for
    groups 1 [dilation^2 * co_pad, n_chunks * kcp] (`_layout`), zeros
    where nothing lands, each residue class of taps (ky mod dilation, kx
    mod dilation) in rows of its own, which the output phases of a
    transposed site read apart."""
    co, cin_g, kh, kw = w_q.shape
    if groups != 1:
        if cin_g != 1 or groups != co:
            raise ValueError(f'int8 convolution: groups {groups} with a '
                             f'kernel {tuple(w_q.shape)}; it takes groups 1, '
                             f'or groups = Cin = Co (depthwise)')
        return w_q.reshape(co, kh * kw).contiguous()
    lay = _layout(cin_g, co, kh, kw, stride, dilation)
    packed = torch.zeros((lay.n_cls * lay.co_pad, lay.n_chunks * lay.kcp),
                         dtype=torch.int8, device=w_q.device)
    row, col = _pack_index(cin_g, co, kh, kw, lay, dilation)
    packed[row.to(w_q.device), col.to(w_q.device)] = w_q
    return packed


def _unpack(w, co, cin, kh, kw, groups, stride=1, dilation=1):
    """`pack_weight`'s inverse: OIHW int8 [Co, Cin / groups, kh, kw]."""
    if groups != 1:
        return w.reshape(co, 1, kh, kw)
    lay = _layout(cin, co, kh, kw, stride, dilation)
    row, col = _pack_index(cin, co, kh, kw, lay, dilation)
    return w[row.to(w.device), col.to(w.device)]


def conv_out_size(n, k, stride, dilation, pad_before, pad_after):
    """Output length of one axis: the dilated input (n - 1) * dilation + 1,
    padded, correlated with k taps at `stride`."""
    return ((n - 1) * dilation + 1 + pad_before + pad_after - k) // stride + 1


def _check(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype,
           s_x, bias):
    """Raise on what K7 does not take; returns (co, ho, wo)."""
    if x.dtype not in _X_CODES or w.dtype != torch.int8:
        raise TypeError(f'int8 convolution: x must be float32, bfloat16 or '
                        f'int8 codes and w int8, got {x.dtype}, {w.dtype}')
    if x.dtype == torch.int8:
        if s_x is not None:
            raise TypeError('int8 convolution: int8 codes take no s_x')
    elif s_x is None or s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise TypeError(f'int8 convolution: a {x.dtype} x needs s_x, a '
                        f'one-element float32 tensor')
    if scale.dtype != torch.float32 or scale.dim() != 1:
        raise TypeError(f'int8 convolution: scale must be float32 [Co], got '
                        f'{scale.dtype} {tuple(scale.shape)}')
    if out_dtype not in _OUT_CODES:
        raise ValueError(f'int8 convolution: out_dtype must be float32, '
                         f'bfloat16 or int32, got {out_dtype}')
    co = scale.shape[0]
    if bias is not None and (out_dtype == torch.int32
                             or bias.dtype != out_dtype
                             or tuple(bias.shape) != (co,)):
        raise ValueError(f'int8 convolution: bias must be [{co}] in the '
                         f'output dtype {out_dtype} (none for int32 sums), '
                         f'got {bias.dtype} {tuple(bias.shape)}')
    if x.dim() != 4:
        raise ValueError(f'int8 convolution: x must be NHWC, got shape '
                         f'{tuple(x.shape)}')
    if len(pads) != 4 or min(pads) < 0:
        raise ValueError(f'int8 convolution: pads must be four paddings '
                         f'(top, bottom, left, right) >= 0, got {pads}')
    if min(kh, kw, stride, dilation) < 1 or (dilation > 1 and stride > 1):
        raise ValueError(f'int8 convolution: kernel {kh}x{kw}, stride '
                         f'{stride}, dilation {dilation}')
    b, h, wd, cin = x.shape
    if groups == 1:
        k = kh * kw * cin
        if k > MAX_K:
            raise ValueError(f'int8 convolution: K = {k} taps x channels '
                             f'would overflow the int32 sum')
        lay = _layout(cin, co, kh, kw, stride, dilation)
        if (w.dim() != 2 or tuple(w.shape) != (lay.n_cls * lay.co_pad,
                                               lay.n_chunks * lay.kcp)):
            raise ValueError(f'int8 convolution: packed weight '
                             f'{tuple(w.shape)} does not fit Co {co}, Cin '
                             f'{cin}, kernel {kh}x{kw}, stride {stride}, '
                             f'dilation {dilation}')
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


def _site_input(x, out_dtype):
    """x as the site sees it: a float x in the site's dtype (out_dtype),
    or as it is for int32 sums."""
    if out_dtype == torch.int32:
        return x
    return x.to(out_dtype)


def conv_int8_reference(x, w, scale, kh, kw, stride=1, dilation=1,
                        pads=(0, 0, 0, 0), groups=1,
                        out_dtype=torch.float32, s_x=None, bias=None):
    """K7's plain version: a float x quantized by `quantize_activation`
    (after its cast to the site's dtype), the sums taken exactly over the
    dilated, padded input, in int32 on the CPU (`F.conv2d` of int32
    tensors; of int8 tensors it would return int8 and wrap) or in float64
    on a CUDA tensor (exact for these sums), then converted to float32,
    multiplied by scale, cast to out_dtype and the bias added (int32: the
    sums)."""
    co, _, _ = _check(x, w, scale, kh, kw, stride, dilation, pads, groups,
                      out_dtype, s_x, bias)
    if x.dtype != torch.int8:
        x = quantize_activation(_site_input(x, out_dtype), s_x)
    b, h, wd, cin = x.shape
    wide = torch.int32 if x.device.type == 'cpu' else torch.float64
    xt = x.permute(0, 3, 1, 2).to(wide)
    if dilation > 1:
        xd = xt.new_zeros((b, cin, (h - 1) * dilation + 1,
                           (wd - 1) * dilation + 1))
        xd[:, :, ::dilation, ::dilation] = xt
        xt = xd
    xt = F.pad(xt, (pads[2], pads[3], pads[0], pads[1]))
    weight = _unpack(w, co, cin, kh, kw, groups, stride, dilation).to(wide)
    acc = F.conv2d(xt, weight, stride=stride, groups=groups)
    acc = acc.permute(0, 2, 3, 1).to(torch.int32).contiguous()
    if out_dtype == torch.int32:
        return acc
    y = (acc.to(torch.float32) * scale).to(out_dtype)
    return y if bias is None else y + bias


PLAN_KEYS = ('load', 'unit', 'stages', 'smem', 'blocks_per_sm', 'grid',
             'ldmatrix', 'epilogue', 'resident')


def _launch(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype,
            s_x, bias, plan=False):
    """Launch K7 on CUDA tensors (or, with `plan`, return the launch it
    would make as a dict of PLAN_KEYS: load 3 TMA over rows of (w, c), 2
    TMA over NHWC, 1 cp.async of `unit` bytes, 0 plain loads; epilogue 0
    staged in the spent stage, 1 staged apart, 2 from the registers)."""
    co, ho, wo = _check(x, w, scale, kh, kw, stride, dilation, pads, groups,
                        out_dtype, s_x, bias)
    dev = x.device
    given = [u for u in (w, scale, s_x, bias) if u is not None]
    if any(u.device != dev for u in given):
        raise ValueError(f'int8 convolution needs every tensor on one CUDA '
                         f'device, got {[str(u.device) for u in (x, *given)]}')
    if x.stride(3) != 1:
        x = x.contiguous()
    w, scale = w.contiguous(), scale.contiguous()
    if w.data_ptr() % 16:
        w = w.clone()
    b, h, wd, cin = x.shape
    y = torch.empty((b, ho, wo, co) if not plan else (1,), dtype=out_dtype,
                    device=dev)
    depthwise = int(groups != 1)
    lay = (_layout(cin, co, kh, kw, stride, dilation) if not depthwise
           else Layout(0, 0, 0, 0, 0, 0))
    round_bf16 = int(x.dtype == torch.float32 and out_dtype == torch.bfloat16)
    bias = None if bias is None else bias.contiguous()
    out = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (_X_CODES[x.dtype], _OUT_CODES[out_dtype], depthwise,
                round_bf16, x.data_ptr(),
                None if s_x is None else s_x.data_ptr(), w.data_ptr(),
                scale.data_ptr(), None if bias is None else bias.data_ptr(),
                y.data_ptr(), b, h, wd, cin, x.stride(0), x.stride(1),
                x.stride(2), ho, wo, co, kh, kw, stride, dilation, pads[0],
                pads[2], lay.cc, lay.n_chunks, lay.kcp, lay.nb, lay.co_pad,
                stream)
        err = (_lib().dl4ds_conv_int8_plan(*args, out) if plan
               else _lib().dl4ds_conv_int8(*args))
    if err != 0:
        raise RuntimeError(f'int8 convolution kernel launch failed with CUDA '
                           f'error {err} (x {x.dtype} {tuple(x.shape)}, '
                           f'kernel {kh}x{kw}, groups {groups}, {lay})')
    if plan:
        return dict(zip(PLAN_KEYS, out), **lay._asdict())
    conv_int8.launches += 1
    return y


def launch_plan(x, w, scale, kh, kw, stride=1, dilation=1, pads=(0, 0, 0, 0),
                groups=1, out_dtype=torch.float32, s_x=None, bias=None):
    """The launch `conv_int8` makes with these CUDA tensors, not made: the
    kernel's choices (PLAN_KEYS) beside `_layout`'s."""
    return _launch(x, w, scale, int(kh), int(kw), int(stride), int(dilation),
                   [int(p) for p in pads], int(groups), out_dtype, s_x, bias,
                   plan=True)


@torch.library.custom_op('dl4ds_tpu_torch::conv_int8', mutates_args=())
def _conv_int8_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  kh: int, kw: int, stride: int, dilation: int,
                  pads: list[int], groups: int, out_dtype: torch.dtype,
                  s_x: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 as the operator `dl4ds_tpu_torch::conv_int8`: its CUDA kernel is
    `_launch`, its CPU kernel `conv_int8_reference`, and its fake kernel
    gives the output's shape and dtype alone, so that `torch.export` traces
    a quantized network through it and freezes the node, not the launch."""
    raise ValueError(f'unsupported device {x.device}')


@_conv_int8_op.register_kernel('cuda')
def _(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype,
      s_x=None, bias=None):
    return _launch(x, w, scale, kh, kw, stride, dilation, pads, groups,
                   out_dtype, s_x, bias)


@_conv_int8_op.register_kernel('cpu')
def _(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype,
      s_x=None, bias=None):
    return conv_int8_reference(x, w, scale, kh, kw, stride, dilation, pads,
                               groups, out_dtype, s_x, bias)


@_conv_int8_op.register_fake
def _(x, w, scale, kh, kw, stride, dilation, pads, groups, out_dtype,
      s_x=None, bias=None):
    ho = conv_out_size(x.shape[1], kh, stride, dilation, pads[0], pads[1])
    wo = conv_out_size(x.shape[2], kw, stride, dilation, pads[2], pads[3])
    return x.new_empty((x.shape[0], ho, wo, scale.shape[0]), dtype=out_dtype)


@register_flop_formula(torch.ops.dl4ds_tpu_torch.conv_int8)
def _(x_shape, w_shape, scale_shape, kh, kw, stride, dilation, pads, groups,
      out_dtype, *args, out_shape=None, **kwargs):
    return conv_int8_flops(x_shape, out_shape, kh, kw, groups)


def conv_int8(x, w, scale, kh, kw, stride=1, dilation=1, pads=(0, 0, 0, 0),
              groups=1, out_dtype=torch.float32, s_x=None, bias=None):
    """K7 on x [B, H, W, Cin] (float32 or bfloat16 with its scale s_x, or
    int8 codes) and `pack_weight`'s w: y [B, Ho, Wo, Co] in out_dtype
    (float32, bfloat16, or int32 for the sums), Co = len(scale), plus the
    bias [Co] in out_dtype where given. The kernel on a CUDA tensor, its
    plain version on a CPU tensor (the module docstring).
    `conv_int8.launches` counts the CUDA kernel's launches."""
    return _conv_int8_op(x, w, scale, int(kh), int(kw), int(stride),
                         int(dilation), [int(p) for p in pads], int(groups),
                         out_dtype, s_x, bias)


conv_int8.launches = 0
