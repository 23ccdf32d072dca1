"""
Fused squeeze-excite channel-attention gate (K1) and fused per-image SSIM
(K6), the counterparts of `dl4ds_tpu/ops/pallas_ops.py`'s
`fused_channel_attention` and `fused_ssim_per_image`.

On a CUDA tensor `fused_channel_attention` launches the hand-written Hopper
kernels in `csrc/channel_attention.cu`, and `fused_ssim_per_image` those in
`csrc/ssim.cu`, forward and backward; on a CPU tensor they compute the plain
PyTorch versions: `channel_attention_reference` and
`_channel_attention_backward` (a transcription of `_fused_ca_bwd`), and
`ops.ssim.ssim` and `ops.ssim.ssim_backward_reference` (the closed form of
the VJP the JAX package takes through its XLA ssim). There is no size-based
or error-based fallback on the GPU. The launch plans, pure functions of the
shapes and the card's limits, are `_ca_plan` and `_ssim_plan`.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .ssim import _gaussian_kernel1d, ssim, ssim_backward_reference

__all__ = ['fused_channel_attention', 'channel_attention_reference',
           'FusedChannelAttention', 'fused_ssim_per_image', 'FusedSSIM']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_CA_THREADS = 512            # kThreads of csrc/channel_attention.cu
_CA_CHUNK_ELEMS = 16384      # elements a stream-regime chunk sums, at least
_CA_MAX_BATCH = 65535        # samples a call: one arrival counter each
_CA_COUNTER_SLOT = 65536     # the backward's count of weight-gradient chunks,
_CA_CHUNK = 16               # then one counter a chunk of 16 samples (kChunk)
_CA_MAX_WIDTH = 4096         # C + Cr
# opt-in shared memory a block keeps for static variables (both .cu files'
# kStaticSmemReserve; their limits queries subtract it)
_STATIC_SMEM_RESERVE = 1024


def _acc_dtype(x):
    """float32 sums, as the kernel takes them; float64 for a float64 x (a
    reference run)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _gate(x, w1, b1, w2, b2):
    """The per-sample mean m and gate g, [..., C], in float32 (float64 for a
    float64 x)."""
    f32 = _acc_dtype(x)
    m = x.to(f32).mean(dim=(-3, -2))                          # [..., C]
    h = F.relu(m @ w1.to(f32) + b1.to(f32))
    return m, torch.sigmoid(h @ w2.to(f32) + b2.to(f32))


def channel_attention_reference(x, w1, b1, w2, b2):
    """Plain PyTorch gate: y = x * sigmoid(relu(mean_HW(x) @ w1 + b1) @ w2
    + b2), with the mean and both mat-vecs in float32 and the gate rounded to
    x's dtype before the multiply, as the kernel does."""
    _, g = _gate(x, w1, b1, w2, b2)
    return x * g.to(x.dtype)[..., None, None, :]


def _channel_attention_backward(x, w1, b1, w2, b2, dy, m=None, g=None):
    """Gradients of the gate for x [B, H, W, C] (transcribes `_fused_ca_bwd`,
    dl4ds_tpu/ops/pallas_ops.py:88-112). m and g [B, C] are the forward's
    mean and gate where it saved them, else formed from x."""
    f32 = _acc_dtype(x)
    hw = x.shape[-3] * x.shape[-2]
    xf = x.to(f32)
    if m is None or g is None:
        m, g = _gate(x, w1, b1, w2, b2)
    m, g = m.to(f32), g.to(f32)
    h_pre = m @ w1.to(f32) + b1.to(f32)
    hh = F.relu(h_pre)

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


def _r16(n):
    return -(-n // 16) * 16


def _ca_smem(region, vec, c, cr):
    """Dynamic shared memory bytes of a K1 block (`smem_bytes` in
    `csrc/channel_attention.cu`): the sample or staging region, kThreads*vec
    partial sums, six C-vectors and two Cr-vectors."""
    return region + 4 * (_CA_THREADS * vec + 6 * c + 2 * cr)


def _ca_plan(shape, cr, dtype, n_sm, smem_per_block, aligned=True):
    """K1's launch plan, forward and backward, a pure function of x's shape
    [B, H, W, C], Cr, the dtype and the card's limits: its SMs and the
    dynamic shared memory a block may take.

    Packs are 16 bytes (`vec` elements; 1 when x or the output is not
    16-byte aligned or H*W*C is not a multiple of a pack). Regimes:
      'block'   a sample (the backward: dy's) in one block's shared memory,
                grid B; one launch.
      'stream'  the sample's H*W pixels cut into `parts` contiguous chunks
                of `ppp` pixels (the last may hold fewer, each a multiple
                of the packs), at least _CA_CHUNK_ELEMS elements and enough
                for two blocks an SM; block x of the grid (B * parts) takes
                chunk x % parts of sample x // parts; two launches, the
                second over `apply_blocks` blocks.
    The region of the block regime also holds one sample's weight-gradient
    rows (the backward's staging); the backward's region (`bwd_region`,
    `bwd_smem`) holds dy's sample and, where both fit, x's after it.
    `tools/torch_ca_regimes.py` times the two regimes against each other."""
    def cdiv(a, d):
        return -(-a // d)

    bsz, h, w, c = shape
    hw = h * w
    elem = _ELEM_BYTES[dtype]
    vec = 16 // elem if aligned and (hw * c) % (16 // elem) == 0 else 1
    staging = _r16(4 * (2 * c + 2 * cr))
    plan = dict(vec=vec, apply_blocks=0)
    region = max(_r16(hw * c * elem), staging)
    smem = _ca_smem(region, vec, c, cr)
    if smem <= smem_per_block:
        both = max(2 * _r16(hw * c * elem), staging)
        bwd_region = (both if _ca_smem(both, vec, c, cr) <= smem_per_block
                      else region)
        plan.update(regime='block', parts=1, ppp=hw, region=region, smem=smem,
                    bwd_region=bwd_region,
                    bwd_smem=_ca_smem(bwd_region, vec, c, cr), grid=bsz,
                    launches=1)
        return plan
    unit = vec // math.gcd(c, vec)      # pixels between pack boundaries
    ppp = cdiv(cdiv(hw, min(hw, max(cdiv(hw * c, _CA_CHUNK_ELEMS),
                                    cdiv(2 * n_sm, bsz)))), unit) * unit
    parts = cdiv(hw, ppp)
    smem = _ca_smem(staging, vec, c, cr)
    if smem > smem_per_block:
        raise ValueError(f'channel-attention kernel: C {c} and Cr {cr} need '
                         f'{smem} bytes of shared memory, more than the '
                         f'{smem_per_block} a block can take')
    plan.update(regime='stream', parts=parts, ppp=ppp, region=staging,
                smem=smem, bwd_region=staging, bwd_smem=smem,
                grid=bsz * parts, launches=2,
                apply_blocks=min(8 * n_sm,
                                 cdiv(bsz * hw * c // vec, _CA_THREADS)))
    return plan


_REGIME_CODES = {'block': 0, 'stream': 1}
_LIMITS = {}
_COUNTERS = {}


def _ca_lib():
    lib = _build.load('channel_attention')
    if lib.dl4ds_channel_attention.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dl4ds_ca_limits.argtypes = [i, p, p]
        lib.dl4ds_channel_attention.argtypes = (
            [i, i, i] + [p] * 10 + [i, ll, i, i, i, ll, ll, ll, i, p])
        lib.dl4ds_channel_attention_bwd.argtypes = (
            [i, i, i] + [p] * 17 + [ll, i, ll, i, i, i, ll, ll, ll, i, p])
        for fn in (lib.dl4ds_ca_limits, lib.dl4ds_channel_attention,
                   lib.dl4ds_channel_attention_bwd):
            fn.restype = ctypes.c_int
        lib.dl4ds_ca_launched.restype = ctypes.c_longlong
    return lib


def _device_index(dev):
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _ca_limits(dev):
    """(SMs, dynamic shared memory a block may take) of the card, queried
    once per device."""
    index = _device_index(dev)
    if ('ca', index) not in _LIMITS:
        n_sm, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            err = _ca_lib().dl4ds_ca_limits(index, ctypes.byref(n_sm),
                                            ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f'channel-attention limits query failed with '
                               f'CUDA error {err}')
        _LIMITS['ca', index] = (n_sm.value, smem.value)
    return _LIMITS['ca', index]


def _arrival_counters(dev, key, n):
    """A zeroed int32 tensor of at least n arrival counters for the kernels
    of `key` on `dev`, allocated once (grown when a call needs more). The
    kernels leave every counter at zero."""
    t = _COUNTERS.get((dev, key))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[(dev, key)] = t
    return t


def _check_gate(x, w1, b1, w2, b2):
    """The checks both K1 wrappers make before anything reaches the card;
    returns (B, H, W, C, Cr)."""
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
    if bsz == 0 or h * w == 0 or c == 0 or cr == 0:
        raise ValueError(f'channel-attention kernel got an empty x {x.shape} '
                         f'or Cr {cr}')
    if bsz > _CA_MAX_BATCH:
        raise ValueError(f'channel-attention kernel takes at most '
                         f'{_CA_MAX_BATCH} samples per call, got {bsz}')
    if c + cr > _CA_MAX_WIDTH:
        raise ValueError(f'channel-attention kernel takes C + Cr <= '
                         f'{_CA_MAX_WIDTH}, got {c} + {cr}')
    return bsz, h, w, c, cr


def _weights32(dev, *ws):
    return [t.to(device=dev, dtype=torch.float32).contiguous() for t in ws]


def _launch(x, w1, b1, w2, b2):
    """Run K1's forward on x [B, H, W, C]; returns y like x and the mean and
    gate [B, C] in float32, which the backward takes."""
    bsz, h, w, c, cr = _check_gate(x, w1, b1, w2, b2)
    dev = x.device
    w1, b1, w2, b2 = _weights32(dev, w1, b1, w2, b2)
    y = torch.empty_like(x)
    plan = _ca_plan((bsz, h, w, c), cr, x.dtype, *_ca_limits(dev),
                    aligned=x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    m, g = torch.empty((2, bsz, c), dtype=torch.float32, device=dev)
    stream_regime = plan['regime'] == 'stream'
    partial = (torch.empty((bsz, plan['parts'], c), dtype=torch.float32,
                           device=dev) if stream_regime else None)
    counters = _arrival_counters(
        dev, 'ca', _CA_COUNTER_SLOT + 1 + -(-_CA_MAX_BATCH // _CA_CHUNK))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ca_lib().dl4ds_channel_attention(
            _DTYPE_CODES[x.dtype], _REGIME_CODES[plan['regime']], plan['vec'],
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), m.data_ptr(), g.data_ptr(),
            partial.data_ptr() if stream_regime else None,
            counters.data_ptr(), bsz, h * w, c, cr, plan['parts'],
            plan['ppp'], plan['region'], plan['smem'], plan['apply_blocks'],
            stream)
    if err != 0:
        raise RuntimeError(f'channel-attention kernel launch failed with CUDA '
                           f'error {err} (plan {plan})')
    fused_channel_attention.launches += 1
    return y, m, g


def _launch_backward(x, w1, b1, w2, b2, dy, m, g):
    """Run K1's backward: (dx, dw1, db1, dw2, db2) from x, dy [B, H, W, C]
    and the forward's mean and gate m, g [B, C] float32."""
    bsz, h, w, c, cr = _check_gate(x, w1, b1, w2, b2)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f'channel-attention backward needs dy like x '
                         f'{tuple(x.shape)} {x.dtype}, got {tuple(dy.shape)} '
                         f'{dy.dtype}')
    if not dy.is_contiguous():
        raise ValueError('channel-attention backward needs a contiguous dy')
    for name, t in (('m', m), ('g', g)):
        if t.dtype != torch.float32 or t.shape != (bsz, c) \
                or not t.is_contiguous():
            raise ValueError(f'channel-attention backward needs {name} as a '
                             f'contiguous float32 [{bsz}, {c}], got '
                             f'{tuple(t.shape)} {t.dtype}')
    dev = x.device
    if not (dy.device == m.device == g.device == dev):
        raise ValueError('channel-attention backward got tensors on several '
                         'devices')
    w1_, b1_, w2_ = _weights32(dev, w1, b1, w2)
    dx = torch.empty_like(x)
    plan = _ca_plan((bsz, h, w, c), cr, x.dtype, *_ca_limits(dev),
                    aligned=all(t.data_ptr() % 16 == 0 for t in (x, dy, dx)))
    dw = torch.empty(2 * c * cr + c + cr, dtype=torch.float32, device=dev)
    dw1, dw2 = dw[:c * cr].view(c, cr), dw[c * cr:2 * c * cr].view(cr, c)
    db1, db2 = dw[2 * c * cr:2 * c * cr + cr], dw[2 * c * cr + cr:]
    n_chunks, n_out = -(-bsz // _CA_CHUNK), 2 * c * cr + c + cr
    rows = torch.empty(bsz * (c + 2 * cr) + n_chunks * n_out,
                       dtype=torch.float32, device=dev)
    stream_regime = plan['regime'] == 'stream'
    partial = dmh = None
    if stream_regime:
        scratch = torch.empty(bsz * c * (plan['parts'] + 1),
                              dtype=torch.float32, device=dev)
        partial, dmh = scratch[:bsz * c * plan['parts']], scratch[-bsz * c:]
    counters = _arrival_counters(
        dev, 'ca', _CA_COUNTER_SLOT + 1 + -(-_CA_MAX_BATCH // _CA_CHUNK))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ca_lib().dl4ds_channel_attention_bwd(
            _DTYPE_CODES[x.dtype], _REGIME_CODES[plan['regime']], plan['vec'],
            x.data_ptr(), dy.data_ptr(), m.data_ptr(), g.data_ptr(),
            w1_.data_ptr(), b1_.data_ptr(), w2_.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            partial.data_ptr() if stream_regime else None,
            dmh.data_ptr() if stream_regime else None, rows.data_ptr(),
            rows[bsz * (c + 2 * cr):].data_ptr(), counters.data_ptr(),
            _CA_COUNTER_SLOT, bsz, h * w, c, cr, plan['parts'], plan['ppp'], plan['bwd_region'], plan['bwd_smem'],
            plan['apply_blocks'], stream)
    if err != 0:
        raise RuntimeError(f'channel-attention backward kernel launch failed '
                           f'with CUDA error {err} (plan {plan})')
    fused_channel_attention.bwd_launches += 1
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


class FusedChannelAttention(torch.autograd.Function):
    """The gate on x [B, H, W, C]: the CUDA kernels forward and backward on
    the GPU, the plain versions on the CPU. The forward saves the per-sample
    mean and gate for the backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        if x.device.type == 'cuda':
            y, m, g = _launch(x, w1, b1, w2, b2)
        elif x.device.type == 'cpu':
            m, g = _gate(x, w1, b1, w2, b2)
            y = x * g.to(x.dtype)[..., None, None, :]
        else:
            raise ValueError(f'unsupported device {x.device}')
        ctx.save_for_backward(x, w1, b1, w2, b2, m, g)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, m, g = ctx.saved_tensors
        if x.device.type == 'cuda':
            return _launch_backward(x, w1, b1, w2, b2, dy.contiguous(), m, g)
        return _channel_attention_backward(x, w1, b1, w2, b2, dy, m, g)


def fused_channel_attention(x, w1, b1, w2, b2):
    """Fused squeeze-excite channel attention: y = x * sigmoid((relu(mean_hw(x)
    @ w1 + b1)) @ w2 + b2).

    x: [..., H, W, C] (leading dims flattened); w1: [C, Cr]; b1: [Cr];
    w2: [Cr, C]; b2: [C]. `fused_channel_attention.launches` counts the
    CUDA forward's calls, `.bwd_launches` the backward's (each one or two
    kernel launches, by `_ca_plan`); the CPU path launches nothing.
    """
    *_, h, w, c = x.shape
    y = FusedChannelAttention.apply(x.reshape(-1, h, w, c), w1, b1, w2, b2)
    return y.reshape(x.shape)


fused_channel_attention.launches = 0
fused_channel_attention.bwd_launches = 0


# ---------------------------------------------------------------------------
# K6: fused per-image SSIM
# ---------------------------------------------------------------------------

_SSIM_MAX_TAPS = 25          # kMaxTaps of csrc/ssim.cu
_SSIM_TILE = (16, 32)        # output (backward: pixel) rows and columns a tile


def _ssim_plan(shape, filter_size, smem_per_block):
    """K6's launch plan, a pure function of the [..., H, W, C] shape, the
    filter size and the dynamic shared memory a block may take.

    'image' (a direction's shared memory fits): block n of the grid (n_out
    blocks) takes output n, all its C channels' images in turn, every one of
    the Hv x Wv positions; the forward holds the image pair and the five
    row-filtered moments, the backward also the four derivative maps. One
    launch each way.
    'tiles': block x of the grid (n_img * tiles, n_img = n_out * C) takes
    the 16x32 outputs at tile x % tiles of image x // tiles (rows (tile //
    tiles_x) * 16, columns (tile % tiles_x) * 32); the forward is one
    launch, the backward's second launch takes 16x32 pixel tiles (grid n_img
    * ptiles, ptiles_x across) and is skipped when no image gradient is
    asked."""
    def cdiv(a, d):
        return -(-a // d)

    *lead, h, w, c = shape
    n_out, k = math.prod(lead), filter_size
    hv, wv = h - k + 1, w - k + 1
    th, tw = _SSIM_TILE
    rows, cols = th + k - 1, tw + k - 1
    tiles_x, ptiles_x = cdiv(wv, tw), cdiv(w, tw)
    plan = dict(n_out=n_out, n_img=n_out * c, hv=hv, wv=wv, tiles_x=tiles_x,
                tiles=tiles_x * cdiv(hv, th), ptiles_x=ptiles_x,
                ptiles=ptiles_x * cdiv(h, th))
    for direction, maps in (('fwd', 0), ('bwd', 4)):
        smem = 4 * (2 * h * w + 5 * h * wv + maps * hv * wv)
        if smem <= smem_per_block:
            plan[direction] = dict(regime='image', grid=n_out, smem=smem,
                                   launches=1)
        else:
            plan[direction] = dict(
                regime='tiles', grid=n_out * c * plan['tiles'],
                smem=4 * (2 * rows * cols + 5 * rows * tw),
                launches=1 if direction == 'fwd' else 2)
    return plan


def _ssim_lib():
    lib = _build.load('ssim')
    if lib.dl4ds_ssim.argtypes is None:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
            ctypes.c_longlong
        lib.dl4ds_ssim.argtypes = [p, p, p, p, i, ll, i, i, i, i, i, f, f, p,
                                   p, p, p]
        lib.dl4ds_ssim_bwd.argtypes = [p, p, p, p, p, i, ll, i, i, i, i, i,
                                       f, f, p, p, p, p, p, p, p]
        lib.dl4ds_ssim_limits.argtypes = [i, p]
        lib.dl4ds_ssim.restype = lib.dl4ds_ssim_bwd.restype = ctypes.c_int
        lib.dl4ds_ssim_limits.restype = ctypes.c_int
        lib.dl4ds_ssim_launched.restype = ctypes.c_longlong
    return lib


def _ssim_inputs(img1, img2, max_val, filter_size):
    """The checks both K6 wrappers make before anything reaches the card;
    returns the images folded to [N*C, H, W], max_val as a device float32
    scalar, the leading shape and (H, W, C)."""
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
    if math.prod(lead) * c == 0:
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
    return x, y, max_val, lead, (h, w, c)


def _ssim_limit(dev):
    """The dynamic shared memory a K6 block may take on the card, queried
    once per device."""
    index = _device_index(dev)
    if ('ssim', index) not in _LIMITS:
        smem = ctypes.c_int()
        with torch.cuda.device(index):
            err = _ssim_lib().dl4ds_ssim_limits(index, ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f'SSIM limits query failed with CUDA error '
                               f'{err}')
        _LIMITS['ssim', index] = smem.value
    return _LIMITS['ssim', index]


def _launch_ssim(img1, img2, max_val, filter_size, filter_sigma, k1, k2):
    """Run K6's forward on [..., H, W, C] float32 images, every leading dim
    and the channel folded into the image axis; returns the per-image SSIM
    [...], averaged over C. `max_val` is a number or a one-element tensor,
    which the kernel reads from device memory."""
    x, y, max_val, lead, (h, w, c) = _ssim_inputs(img1, img2, max_val,
                                                   filter_size)
    dev = x.device
    plan = _ssim_plan(img1.shape, filter_size, _ssim_limit(dev))
    tiles = plan['fwd']['regime'] == 'tiles'
    partial = (torch.empty(plan['fwd']['grid'], dtype=torch.float32,
                           device=dev) if tiles else None)
    counters = _arrival_counters(dev, 'ssim', plan['n_out'])
    out = torch.empty(lead, dtype=torch.float32, device=dev)
    taps = _gaussian_kernel1d(filter_size, filter_sigma)
    vec4 = (h * w) % 4 == 0 and x.data_ptr() % 16 == 0 \
        and y.data_ptr() % 16 == 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ssim_lib().dl4ds_ssim(
            x.data_ptr(), y.data_ptr(), max_val.data_ptr(), taps.ctypes.data,
            filter_size, plan['n_out'], c, h, w, int(tiles), int(vec4), k1,
            k2, partial.data_ptr() if tiles else None, counters.data_ptr(),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'SSIM kernel launch failed with CUDA error {err}')
    fused_ssim_per_image.launches += 1
    return out


def _launch_ssim_backward(img1, img2, max_val, g, filter_size, filter_sigma,
                          k1, k2, need=(True, True, True)):
    """Run K6's backward: the gradients (img1, img2, max_val) of sum(g *
    ssim) for the upstream g [...], None where `need` does not ask. max_val
    is a number or a one-element tensor; its gradient is a float32 0-d
    tensor."""
    x, y, max_val, lead, (h, w, c) = _ssim_inputs(img1, img2, max_val,
                                                   filter_size)
    if not torch.is_tensor(g) or tuple(g.shape) != tuple(lead) \
            or not g.is_floating_point() or g.device != x.device:
        raise ValueError(f'SSIM backward needs g of shape {tuple(lead)} on '
                         f'{x.device}, got {g!r:.80}')
    dev = x.device
    plan = _ssim_plan(img1.shape, filter_size, _ssim_limit(dev))
    tiles = plan['bwd']['regime'] == 'tiles'
    g = g.detach().to(torch.float32).contiguous()
    d1, d2 = (torch.empty_like(x) if n else None for n in need[:2])
    part = torch.empty(plan['bwd']['grid'] + 1, dtype=torch.float32,
                       device=dev)
    dmv = part[-1:] if need[2] else None
    maps = (torch.empty((plan['n_img'], 4, plan['hv'], plan['wv']),
                        dtype=torch.float32, device=dev) if tiles else None)
    counter = _arrival_counters(dev, 'ssim', plan['n_out'])
    taps = _gaussian_kernel1d(filter_size, filter_sigma)
    vec4 = (h * w) % 4 == 0 and x.data_ptr() % 16 == 0 \
        and y.data_ptr() % 16 == 0

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ssim_lib().dl4ds_ssim_bwd(
            x.data_ptr(), y.data_ptr(), max_val.data_ptr(), g.data_ptr(),
            taps.ctypes.data, filter_size, plan['n_out'], c, h, w,
            int(tiles), int(vec4), k1, k2, ptr(d1), ptr(d2), ptr(dmv),
            part.data_ptr(), ptr(maps), counter.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'SSIM backward kernel launch failed with CUDA '
                           f'error {err}')
    fused_ssim_per_image.bwd_launches += 1

    def unfold(t):
        return None if t is None else t.reshape(*lead, c, h, w).movedim(-3,
                                                                        -1)
    return unfold(d1), unfold(d2), None if dmv is None else dmv.reshape(())


class FusedSSIM(torch.autograd.Function):
    """Per-image SSIM of [..., H, W, C] images: the CUDA kernels forward and
    backward on the GPU, the plain versions on the CPU (`ssim`, and the
    closed-form `ssim_backward_reference`). The backward gives the gradients
    of both images and of `max_val` (a tensor that requires grad: the DSSIM
    losses pass the data range of their inputs)."""

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
        max_val = max_val[0] if max_val else ctx.max_val
        need = tuple(ctx.needs_input_grad[:3])
        if img1.device.type == 'cuda':
            d1, d2, dm = _launch_ssim_backward(img1, img2, max_val, g,
                                               *ctx.params, need=need)
        else:
            d1, d2, dm = ssim_backward_reference(img1, img2, max_val, g,
                                                 *ctx.params, need=need)
        grads = [None if d is None else d.to(t.dtype)
                 for d, t in ((d1, img1), (d2, img2))]
        if dm is not None:
            dm = dm.to(max_val.dtype).reshape(max_val.shape)
        return (*grads, dm, None, None, None, None)


def fused_ssim_per_image(img1, img2, max_val, filter_size=11,
                         filter_sigma=1.5, k1=0.01, k2=0.03):
    """Structural similarity per image of [..., H, W, C] images (for [B, H,
    W, 1], [B]), as `ops.ssim.ssim`: the five Gaussian-filtered moments,
    the SSIM algebra and the spatial mean in one kernel on the GPU, without
    a filtered map in device memory. `max_val` is a number or a 0-d tensor
    (differentiable). `fused_ssim_per_image.launches` counts the CUDA
    forward's calls, `.bwd_launches` the backward's (one kernel launch
    each way, two for a backward of images too large for one block); the
    CPU path launches nothing."""
    return FusedSSIM.apply(img1, img2, max_val, filter_size, filter_sigma,
                           k1, k2)


fused_ssim_per_image.launches = 0
fused_ssim_per_image.bwd_launches = 0
