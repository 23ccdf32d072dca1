"""
Fused squeeze-excite channel-attention gate (K1), the counterpart of
`dl4ds_tpu/ops/pallas_ops.py`'s `fused_channel_attention`.

On a CUDA tensor `fused_channel_attention` launches the hand-written Hopper
kernel in `csrc/channel_attention.cu`; on a CPU tensor it computes the plain
PyTorch version, `channel_attention_reference`. There is no size-based or
error-based fallback on the GPU. The gradient is a `torch.autograd.Function`
whose backward is plain tensor math, as `_fused_ca_bwd` is plain XLA in the
JAX package.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ['fused_channel_attention', 'channel_attention_reference',
           'FusedChannelAttention']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK_ELEMS = 16384        # elements one reduction block sums, at least
_GATE_SMEM_LIMIT = 48 * 1024


def channel_attention_reference(x, w1, b1, w2, b2):
    """Plain PyTorch gate: y = x * sigmoid(relu(mean_HW(x) @ w1 + b1) @ w2
    + b2), with the mean and both mat-vecs in float32 and the gate rounded to
    x's dtype before the multiply, as the kernel does."""
    f32 = torch.float32
    m = x.to(f32).mean(dim=(-3, -2))                          # [..., C]
    h = F.relu(m @ w1.to(f32) + b1.to(f32))
    g = torch.sigmoid(h @ w2.to(f32) + b2.to(f32))
    return x * g.to(x.dtype)[..., None, None, :]


def _channel_attention_backward(x, w1, b1, w2, b2, dy):
    """Gradients of the gate for x [B, H, W, C] (transcribes `_fused_ca_bwd`,
    dl4ds_tpu/ops/pallas_ops.py:88-112)."""
    f32 = torch.float32
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
