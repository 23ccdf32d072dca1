"""
Fused squeeze-excite channel-attention gate (K1) and fused per-image SSIM
(K6), the counterparts of `dl4ds_tpu/ops/pallas_ops.py`'s
`fused_channel_attention` and `fused_ssim_per_image`.

On a CUDA tensor `fused_channel_attention` launches the hand-written Hopper
kernel in `csrc/channel_attention.cu`, and `fused_ssim_per_image` the one in
`csrc/ssim.cu`; on a CPU tensor they compute the plain PyTorch versions,
`channel_attention_reference` and `ops.ssim.ssim`. There is no size-based or
error-based fallback on the GPU. Each gradient is a `torch.autograd.Function`
whose backward is plain tensor math, as `_fused_ca_bwd` and the fused SSIM's
backward are plain XLA in the JAX package.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .ssim import _gaussian_kernel1d, ssim

__all__ = ['fused_channel_attention', 'channel_attention_reference',
           'FusedChannelAttention', 'fused_ssim_per_image', 'FusedSSIM']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK_ELEMS = 16384        # elements one reduction block sums, at least
_GATE_SMEM_LIMIT = 48 * 1024


def _acc_dtype(x):
    """float32 sums, as the kernel takes them; float64 for a float64 x (a
    reference run)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def channel_attention_reference(x, w1, b1, w2, b2):
    """Plain PyTorch gate: y = x * sigmoid(relu(mean_HW(x) @ w1 + b1) @ w2
    + b2), with the mean and both mat-vecs in float32 and the gate rounded to
    x's dtype before the multiply, as the kernel does."""
    f32 = _acc_dtype(x)
    m = x.to(f32).mean(dim=(-3, -2))                          # [..., C]
    h = F.relu(m @ w1.to(f32) + b1.to(f32))
    g = torch.sigmoid(h @ w2.to(f32) + b2.to(f32))
    return x * g.to(x.dtype)[..., None, None, :]


def _channel_attention_backward(x, w1, b1, w2, b2, dy):
    """Gradients of the gate for x [B, H, W, C] (transcribes `_fused_ca_bwd`,
    dl4ds_tpu/ops/pallas_ops.py:88-112)."""
    f32 = _acc_dtype(x)
    hw = x.shape[-3] * x.shape[-2]
    xf = x.to(f32)
    m = xf.mean(dim=(-3, -2))                                 # [B, C]
    h_pre = m @ w1.to(f32) + b1.to(f32)
    hh = F.relu(h_pre)
    g = torch.sigmoid(hh @ w2.to(f32) + b2.to(f32))

    dyf = dy.to(f32)
    dx_direct = dyf * g[:, None, None, :]
    dg = (dyf * xf).sum(dim=(-3, -2))                         # [B, C]
    dg_pre = dg * g * (1.0 - g)
    dw2 = hh.T @ dg_pre
    db2 = dg_pre.sum(dim=0)
    dh = dg_pre @ w2.to(f32).T
    dh_pre = dh * (h_pre > 0)
    dw1 = m.T @ dh_pre
    db1 = dh_pre.sum(dim=0)
    dm = dh_pre @ w1.to(f32).T                                # [B, C]
    dx = dx_direct + dm[:, None, None, :] / hw
    return (dx.to(x.dtype), dw1.to(w1.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(b2.dtype))


def _kernel_lib():
    lib = _build.load('channel_attention')
    fn = lib.dl4ds_channel_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, i, ctypes.c_longlong, i, i,
                       i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x, w1, b1, w2, b2):
    """Run the CUDA kernel on x [B, H, W, C]; returns y like x."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'channel-attention kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('channel-attention kernel needs a contiguous NHWC x')
    bsz, h, w, c = x.shape
    cr = w1.shape[-1]
    if w1.shape != (c, cr) or b1.shape != (cr,) or w2.shape != (cr, c) \
            or b2.shape != (c,):
        raise ValueError(
            f'gate weights do not match x [.., {c}]: w1 {tuple(w1.shape)}, '
            f'b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}')
    if bsz == 0 or h * w == 0 or c == 0:
        raise ValueError(f'channel-attention kernel got an empty x {x.shape}')
    if bsz > 65535:
        raise ValueError(f'channel-attention kernel takes at most 65535 '
                         f'samples per call, got {bsz}')
    if 4 * (c + cr) > _GATE_SMEM_LIMIT:
        raise ValueError(f'channel-attention kernel takes C + Cr <= '
                         f'{_GATE_SMEM_LIMIT // 4}, got {c} + {cr}')
    dev = x.device
    w1, b1, w2, b2 = (t.to(device=dev, dtype=torch.float32).contiguous()
                      for t in (w1, b1, w2, b2))
    hw = h * w
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # enough (sample, chunk) blocks for every SM, each summing >= 16K elements
    # where the map is large enough
    chunks = max(-(-hw * c // _CHUNK_ELEMS), -(-2 * n_sm // bsz))
    rows_per_chunk = -(-hw // min(chunks, hw))
    chunks = -(-hw // rows_per_chunk)
    partial = torch.empty((bsz, chunks, c), dtype=torch.float32, device=dev)
    gate = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    vec = 16 // x.element_size()
    if c % vec or x.data_ptr() % 16 or y.data_ptr() % 16:
        vec = 1
    apply_blocks = 8 * n_sm
    fn = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 partial.data_ptr(), gate.data_ptr(), y.data_ptr(), bsz, hw,
                 c, cr, chunks, rows_per_chunk, vec, apply_blocks, stream)
    if err != 0:
        raise RuntimeError(f'channel-attention kernel launch failed with CUDA '
                           f'error {err}')
    fused_channel_attention.launches += 1
    return y


class FusedChannelAttention(torch.autograd.Function):
    """The gate on x [B, H, W, C]: the CUDA kernel forward on the GPU, the
    plain version on the CPU; plain-math backward on both."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if x.device.type == 'cuda':
            return _launch(x, w1, b1, w2, b2)
        if x.device.type == 'cpu':
            return channel_attention_reference(x, w1, b1, w2, b2)
        raise ValueError(f'unsupported device {x.device}')

    @staticmethod
    def backward(ctx, dy):
        return _channel_attention_backward(*ctx.saved_tensors, dy)


def fused_channel_attention(x, w1, b1, w2, b2):
    """Fused squeeze-excite channel attention: y = x * sigmoid((relu(mean_hw(x)
    @ w1 + b1)) @ w2 + b2).

    x: [..., H, W, C] (leading dims flattened); w1: [C, Cr]; b1: [Cr];
    w2: [Cr, C]; b2: [C]. `fused_channel_attention.launches` counts the
    CUDA kernel's launches; the CPU path launches nothing.
    """
    *_, h, w, c = x.shape
    y = FusedChannelAttention.apply(x.reshape(-1, h, w, c), w1, b1, w2, b2)
    return y.reshape(x.shape)


fused_channel_attention.launches = 0


# ---------------------------------------------------------------------------
# K6: fused per-image SSIM
# ---------------------------------------------------------------------------

_SSIM_MAX_TAPS = 25          # kMaxTaps of csrc/ssim.cu
_SSIM_TILE = (16, 32)        # output rows and columns a block (kTileH, kTileW)


def _ssim_kernel_lib():
    lib = _build.load('ssim')
    fn = lib.dl4ds_ssim
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, ctypes.c_longlong, i, i, i, i, f, f, p,
                       p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch_ssim(img1, img2, max_val, filter_size, filter_sigma, k1, k2):
    """Run the CUDA kernel on [..., H, W, C] float32 images, every leading
    dim and the channel folded into the image axis; returns the per-image
    SSIM [...], averaged over C. `max_val` is a number or a one-element
    tensor, which the kernel reads from device memory."""
    if img1.dtype != torch.float32 or img2.dtype != torch.float32:
        raise TypeError(f'SSIM kernel takes float32 images, got {img1.dtype} '
                        f'and {img2.dtype}')
    if img1.shape != img2.shape or img1.ndim < 3:
        raise ValueError(f'SSIM kernel needs two [..., H, W, C] images of one '
                         f'shape, got {tuple(img1.shape)} and '
                         f'{tuple(img2.shape)}')
    if img1.device != img2.device:
        raise ValueError(f'SSIM kernel got images on {img1.device} and '
                         f'{img2.device}')
    *lead, h, w, c = img1.shape
    if not 1 <= filter_size <= _SSIM_MAX_TAPS:
        raise ValueError(f'SSIM kernel takes filter_size 1..{_SSIM_MAX_TAPS}, '
                         f'got {filter_size}')
    if h < filter_size or w < filter_size:
        raise ValueError(
            f'image ({h}x{w}) is smaller than the {filter_size}x{filter_size} '
            f'SSIM filter window')
    n_out = math.prod(lead)
    if n_out * c == 0:
        raise ValueError(f'SSIM kernel got empty images {tuple(img1.shape)}')
    dev = img1.device
    if torch.is_tensor(max_val):
        if max_val.numel() != 1:
            raise ValueError(f'SSIM kernel takes one max_val, got shape '
                             f'{tuple(max_val.shape)}')
        max_val = max_val.detach().to(device=dev,
                                      dtype=torch.float32).reshape(())
    else:
        max_val = torch.full((), float(max_val), dtype=torch.float32,
                             device=dev)
    x = img1.movedim(-1, -3).reshape(-1, h, w).contiguous()
    y = img2.movedim(-1, -3).reshape(-1, h, w).contiguous()
    tiles = (-(-(h - filter_size + 1) // _SSIM_TILE[0])
             * -(-(w - filter_size + 1) // _SSIM_TILE[1]))
    partial = torch.empty((x.shape[0], tiles), dtype=torch.float32,
                          device=dev)
    out = torch.empty(lead, dtype=torch.float32, device=dev)
    taps = _gaussian_kernel1d(filter_size, filter_sigma)
    fn = _ssim_kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), max_val.data_ptr(),
                 taps.ctypes.data, filter_size, n_out, c, h, w, tiles, k1, k2,
                 partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'SSIM kernel launch failed with CUDA error {err}')
    fused_ssim_per_image.launches += 1
    return out


class FusedSSIM(torch.autograd.Function):
    """Per-image SSIM of [..., H, W, C] images: the CUDA kernel forward on
    the GPU, the plain version on the CPU. The backward recomputes the
    moments with the plain version under autograd on both, and gives the
    gradients of both images and of `max_val` (a tensor that requires
    grad: the DSSIM losses pass the data range of their inputs)."""

    @staticmethod
    def forward(ctx, img1, img2, max_val, filter_size, filter_sigma, k1, k2):
        ctx.params = (filter_size, filter_sigma, k1, k2)
        if torch.is_tensor(max_val):
            ctx.save_for_backward(img1, img2, max_val)
        else:
            ctx.save_for_backward(img1, img2)
            ctx.max_val = max_val
        if img1.device.type == 'cuda':
            return _launch_ssim(img1, img2, max_val, *ctx.params)
        if img1.device.type == 'cpu':
            return ssim(img1, img2, max_val, *ctx.params)
        raise ValueError(f'unsupported device {img1.device}')

    @staticmethod
    def backward(ctx, g):
        img1, img2, *max_val = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        inputs = (img1, img2, max_val[0] if max_val else ctx.max_val)
        inputs = [t.detach().requires_grad_() if n else t
                  for t, n in zip(inputs, need)]
        with torch.enable_grad():
            s = ssim(*inputs, *ctx.params)
        grads = iter(torch.autograd.grad(
            s, [t for t, n in zip(inputs, need) if n], g))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None)


def fused_ssim_per_image(img1, img2, max_val, filter_size=11,
                         filter_sigma=1.5, k1=0.01, k2=0.03):
    """Structural similarity per image of [..., H, W, C] images (for [B, H,
    W, 1], [B]), as `ops.ssim.ssim`: the five Gaussian-filtered moments,
    the SSIM algebra and the spatial mean in one kernel on the GPU, without
    a filtered map in device memory. `max_val` is a number or a 0-d tensor
    (differentiable). `fused_ssim_per_image.launches` counts the CUDA
    kernel's launches; the CPU path launches nothing."""
    return FusedSSIM.apply(img1, img2, max_val, filter_size, filter_sigma,
                           k1, k2)


fused_ssim_per_image.launches = 0
