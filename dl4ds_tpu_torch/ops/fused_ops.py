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

K1's forward is the `torch.library` operator
`dl4ds_tpu_torch::channel_attention` (its CUDA kernel `_launch`, its CPU
kernel `_plain_forward`, a fake kernel for tracing and a `vmap` rule), the
one launch site of the forward kernel: the differentiable `_FusedGate`
calls it, and with grad mode off `fused_channel_attention` calls it alone,
so that `torch.export` freezes it as one node.

The gate has two bfloat16 modes. `out_dtype=None` gives y in x's dtype
with a float32 mean and gate, the gate rounded before the multiply: the
Pallas `_kernel`'s semantics (dl4ds_tpu/ops/pallas_ops.py:39-50).
`out_dtype=torch.float32` with a bfloat16 x (the "mixed" mode) gives a
float32 y with the rounding points of `channel_attention_reference` in a
bfloat16 model (:29-36), which is the gate a bfloat16 JAX model runs
everywhere but on a TPU with DL4DS_USE_PALLAS=1: the mean, w1, w2 and
m @ w1 are bfloat16, the float32 biases promote the rest, y = x * g in
float32. Its backward takes a float32 dy and returns a bfloat16 dx, with
the rounding points of that function's VJP (`_channel_attention_backward`).

The gate has a member mode for deep ensembles: weights stacked [M, ...]
(w1 [M, C, Cr] and so on) with x [M * B, H, W, C], sample b taking the
weights of member b // B, and the weight gradients [M, ...], each summed
over its own member's samples. `torch.func.vmap` reaches it through the
`vmap` rules of `_FusedGate` and `_GateBackward`, as `vmap` of the Pallas
call reaches a grid axis over the members in JAX; on the GPU it is one
launch (each way) whose results equal M one-member launches bit for bit,
on the CPU the plain versions applied member by member. K6's `vmap` rules
(`FusedSSIM`, `_SSIMBackward`) fold the members into the image axis.
"""

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .flops import gate_flops, kernel_flops, ssim_flops
from .members import by_member, front, member_vmap
from .ssim import _gaussian_kernel1d, ssim, ssim_backward_reference

__all__ = ['fused_channel_attention', 'channel_attention_reference',
           'FusedChannelAttention', 'fused_channel_attention_band',
           'ca_band_sums', 'ca_band_apply', 'ca_band_grads', 'ca_band_dx',
           'fused_ssim_per_image', 'FusedSSIM']

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_CA_THREADS = 512            # kThreads of csrc/channel_attention.cu
_CA_CHUNK_ELEMS = 16384      # elements a stream-regime chunk sums, at least
_CA_MAX_BATCH = 65535        # samples a call: one arrival counter each
_CA_COUNTER_SLOT = 65536     # the backward's count of weight-gradient chunks
_CA_CHUNK = 16               # of each member, then one counter a chunk of 16
                             # samples of a member (kChunk)
_CA_COUNTERS = (_CA_COUNTER_SLOT + 2 * _CA_MAX_BATCH
                + -(-_CA_MAX_BATCH // _CA_CHUNK))
_CA_MAX_WIDTH = 4096         # C + Cr
# opt-in shared memory a block keeps for static variables (both .cu files'
# kStaticSmemReserve; their limits queries subtract it)
_STATIC_SMEM_RESERVE = 1024


def _acc_dtype(x):
    """float32 sums, as the kernel takes them; float64 for a float64 x (a
    reference run)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mixed(x, out_dtype):
    """Whether the gate runs its mixed mode: a bfloat16 x, a float32 y."""
    if out_dtype is None or out_dtype == x.dtype:
        return False
    if x.dtype == torch.bfloat16 and out_dtype == torch.float32:
        return True
    raise TypeError(f'channel-attention gate: out_dtype {out_dtype} with x '
                    f'{x.dtype}; it takes out_dtype None, x\'s dtype, or '
                    f'float32 with a bfloat16 x')


def _rb(t):
    """t rounded to bfloat16, held in float32."""
    return t.to(torch.bfloat16).float()


def _weights_mixed(w1, w2):
    """w1 and w2 rounded to bfloat16, as the mixed mode casts them."""
    return _rb(w1.float()), _rb(w2.float())


def _gate(x, w1, b1, w2, b2, mixed=False):
    """The per-sample mean m and gate g, [..., C], in float32 (float64 for a
    float64 x). mixed: m is the bfloat16-rounded mean, w1, w2 and m @ w1
    are rounded to bfloat16 (`channel_attention_reference` in bfloat16)."""
    return _gate_of_mean(x.to(_acc_dtype(x)).mean(dim=(-3, -2)), w1, b1, w2,
                         b2, mixed)


def _gate_of_mean(m, w1, b1, w2, b2, mixed=False):
    """(m, g) of `_gate` from the mean m [..., C] (float32, or float64)."""
    f32 = m.dtype
    if mixed:
        m = _rb(m).to(f32)
        w1r, w2r = (u.to(f32) for u in _weights_mixed(w1, w2))
        h = F.relu(_rb(m @ w1r).to(f32) + b1.to(f32))
        return m, torch.sigmoid(h @ w2r + b2.to(f32))
    h = F.relu(m @ w1.to(f32) + b1.to(f32))
    return m, torch.sigmoid(h @ w2.to(f32) + b2.to(f32))


def channel_attention_reference(x, w1, b1, w2, b2, out_dtype=None):
    """Plain PyTorch gate: y = x * sigmoid(relu(mean_HW(x) @ w1 + b1) @ w2
    + b2), with the mean and both mat-vecs in float32 and the gate rounded to
    x's dtype before the multiply, as the kernel does; with a bfloat16 x and
    out_dtype float32, the mixed mode (float32 y = x * g, the module
    docstring's rounding points)."""
    mixed = _mixed(x, out_dtype)
    _, g = _gate(x, w1, b1, w2, b2, mixed)
    if mixed:
        return x.float() * g[..., None, None, :]
    return x * g.to(x.dtype)[..., None, None, :]


def _channel_attention_backward(x, w1, b1, w2, b2, dy, m=None, g=None,
                                mixed=False):
    """Gradients of the gate for x [B, H, W, C] (transcribes `_fused_ca_bwd`,
    dl4ds_tpu/ops/pallas_ops.py:88-112): `_partial_grads`, then `_dx_of`.
    m and g [B, C] are the forward's mean and gate where it saved them,
    else formed from x. mixed: the VJP of `channel_attention_reference` in
    bfloat16 (`_partial_grads`)."""
    if m is None or g is None:
        m, g = _gate(x, w1, b1, w2, b2, mixed)
    dm, *dws = _partial_grads(x, w1, b1, w2, b2, dy, m, g, mixed)
    dx = _dx_of(x, dy, g, dm, x.shape[-3] * x.shape[-2], mixed)
    return (dx, *dws)


def _backward_mixed(x, w1, b1, w2, b2, dy, m=None, g=None):
    """The mixed mode's gradients for a bfloat16 x and a float32 dy:
    `_channel_attention_backward` with mixed=True."""
    return _channel_attention_backward(x, w1, b1, w2, b2, dy, m, g, True)


def _partial_grads(x, w1, b1, w2, b2, dy, m, g, mixed=False):
    """(dm, dw1, db1, dw2, db2) of the gate from x, dy [B, H, W, C] and the
    mean and gate m, g [B, C]: dg = sum_HW(dy x) and the MLP's backward on
    it, dm undivided. Every step is linear in dg, so on a band of rows
    (the band mode) these are the band's parts, which sum over the bands
    to the whole grid's. mixed: the VJP of `channel_attention_reference`
    in bfloat16, rounded where its casts round (each bfloat16 product or
    cast rounds once; the sums are float32): dm = bf(dh_pre) @ w1^T,
    dw1 = bf(m^T bf(dh_pre)), dw2 = bf(relu(h_pre)^T dg_pre), db1 and db2
    unrounded; w1, w2 and m @ w1 rounded as in the forward (m the rounded
    mean)."""
    f32 = _acc_dtype(dy)     # float64 sums for a float64 dy (a reference run)
    m, g = m.to(f32), g.to(f32)
    if mixed:
        w1f, w2f = (u.to(f32) for u in _weights_mixed(w1, w2))
        h_pre = _rb(m @ w1f).to(f32) + b1.to(f32)
    else:
        w1f, w2f = w1.to(f32), w2.to(f32)
        h_pre = m @ w1f + b1.to(f32)
    hh = F.relu(h_pre)
    dg = (dy.to(f32) * x.to(f32)).sum(dim=(-3, -2))            # [B, C]
    dg_pre = dg * g * (1.0 - g)
    dw2 = hh.T @ dg_pre
    db2 = dg_pre.sum(dim=0)
    dh_pre = (dg_pre @ w2f.T) * (h_pre > 0)
    db1 = dh_pre.sum(dim=0)
    if mixed:
        dw2 = _rb(dw2)
        dh_pre = _rb(dh_pre).to(f32)
        dw1 = _rb(m.T @ dh_pre)
    else:
        dw1 = m.T @ dh_pre
    dm = dh_pre @ w1f.T                                       # [B, C]
    return (dm, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _dx_of(x, dy, g, dm, hw, mixed=False):
    """dx = dy g + dm / hw, in x's dtype (mixed: bf(bf(dy g) + bf(bf(dm) /
    hw)), dy float32), from the gate g and the undivided dm [B, C] of the
    `hw` pixels the mean ran over."""
    f32 = _acc_dtype(dy)
    dyf, g = dy.to(f32), g.to(f32)
    if mixed:
        dmh = _rb(_rb(dm) / hw)
        dx = _rb(dyf * g[:, None, None, :]) + dmh[:, None, None, :]
    else:
        dx = dyf * g[:, None, None, :] + dm[:, None, None, :] / hw
    return dx.to(x.dtype)


def _r16(n):
    return -(-n // 16) * 16


def _ca_smem(region, vec, c, cr):
    """Dynamic shared memory bytes of a K1 block (`smem_bytes` in
    `csrc/channel_attention.cu`): the sample or staging region, kThreads*vec
    partial sums, six C-vectors and two Cr-vectors."""
    return region + 4 * (_CA_THREADS * vec + 6 * c + 2 * cr)


def _ca_plan(shape, cr, dtype, n_sm, smem_per_block, aligned=True,
             out_dtype=None, members=1, band=False):
    """K1's launch plan, forward and backward, a pure function of x's shape
    [B, H, W, C], Cr, x's dtype, y's (`out_dtype`, None for x's: float32
    with a bfloat16 x is the mixed mode, whose dy is float32 too), the
    member count (the member mode: B / members samples a member) and the
    card's limits: its SMs and the dynamic shared memory a block may take.
    A member's chunks are those of a one-member call on its B / members
    samples, so that the member mode's sums are that call's.

    Packs are 16 bytes of x (`vec` elements; 1 when a tensor is not 16-byte
    aligned or H*W*C is not a multiple of a pack). Regimes:
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
    `bwd_smem`) holds dy's sample and, where both fit, x's after it. In the
    mixed mode dy's sample takes 4 bytes an element and x's 2, so the block
    regime needs the backward's dy region to fit too, and a sample's
    weight-gradient rows hold one more Cr-vector (the rounded dh_pre).
    The band mode (`band`: x is a band of rows of each sample, spatial
    parallelism) always takes the stream regime's cut of the band; its
    launches are its own (`fused_channel_attention_band`).
    `tools/torch_ca_regimes.py` times the two regimes against each other."""
    def cdiv(a, d):
        return -(-a // d)

    bsz, h, w, c = shape
    hw = h * w
    elem = _ELEM_BYTES[dtype]
    out_elem = _ELEM_BYTES[dtype if out_dtype is None else out_dtype]
    vec = 16 // elem if aligned and (hw * c) % (16 // elem) == 0 else 1
    rows = 2 * c + (3 if out_elem != elem else 2) * cr
    staging = _r16(4 * rows)
    plan = dict(vec=vec, apply_blocks=0)
    region = max(_r16(hw * c * elem), staging)
    dy_region = max(_r16(hw * c * out_elem), staging)
    smem = _ca_smem(region, vec, c, cr)
    if not band and max(smem, _ca_smem(dy_region, vec, c, cr)) \
            <= smem_per_block:
        both = max(_r16(hw * c * out_elem) + _r16(hw * c * elem), staging)
        bwd_region = (both if _ca_smem(both, vec, c, cr) <= smem_per_block
                      else dy_region)
        plan.update(regime='block', parts=1, ppp=hw, region=region, smem=smem,
                    bwd_region=bwd_region,
                    bwd_smem=_ca_smem(bwd_region, vec, c, cr), grid=bsz,
                    launches=1)
        return plan
    unit = vec // math.gcd(c, vec)      # pixels between pack boundaries
    ppp = cdiv(cdiv(hw, min(hw, max(cdiv(hw * c, _CA_CHUNK_ELEMS),
                                    cdiv(2 * n_sm, bsz // members)))),
               unit) * unit
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
            [i, i, i] + [p] * 10 + [i, ll, i, i, i, ll, ll, ll, i, i, p])
        lib.dl4ds_channel_attention_bwd.argtypes = (
            [i, i, i] + [p] * 17 + [ll, i, ll, i, i, i, ll, ll, ll, i, i, p])
        lib.dl4ds_channel_attention_band.argtypes = (
            [i, i, i] + [p] * 11 + [i, ll, ll, i, i, i, ll, ll, ll, i, p])
        lib.dl4ds_channel_attention_band_bwd.argtypes = (
            [i, i, i] + [p] * 17 + [ll, i, ll, ll, i, i, i, ll, ll, ll, i, p])
        for fn in (lib.dl4ds_ca_limits, lib.dl4ds_channel_attention,
                   lib.dl4ds_channel_attention_bwd,
                   lib.dl4ds_channel_attention_band,
                   lib.dl4ds_channel_attention_band_bwd):
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
    returns (B, H, W, C, Cr, members)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'channel-attention kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('channel-attention kernel needs a contiguous NHWC x')
    bsz, h, w, c = x.shape
    cr = w1.shape[-1]
    # w1 [C, Cr], or the member mode's stack [M, C, Cr]
    lead = tuple(w1.shape[:-2])
    members = lead[0] if lead else 1
    if w1.shape != lead + (c, cr) or b1.shape != lead + (cr,) \
            or w2.shape != lead + (cr, c) or b2.shape != lead + (c,):
        raise ValueError(
            f'gate weights do not match x [.., {c}]: w1 {tuple(w1.shape)}, '
            f'b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}')
    if members == 0 or bsz % members:
        raise ValueError(f'channel-attention member mode: {bsz} samples do '
                         f'not divide over {members} members')
    if bsz == 0 or h * w == 0 or c == 0 or cr == 0:
        raise ValueError(f'channel-attention kernel got an empty x {x.shape} '
                         f'or Cr {cr}')
    if bsz > _CA_MAX_BATCH:
        raise ValueError(f'channel-attention kernel takes at most '
                         f'{_CA_MAX_BATCH} samples per call, got {bsz}')
    if c + cr > _CA_MAX_WIDTH:
        raise ValueError(f'channel-attention kernel takes C + Cr <= '
                         f'{_CA_MAX_WIDTH}, got {c} + {cr}')
    return bsz, h, w, c, cr, members


def _weights32(dev, *ws):
    return [t.to(device=dev, dtype=torch.float32).contiguous() for t in ws]


# the kernels' type codes: x's type, or the mixed mode (bfloat16 x, float32
# y and dy)
_MIXED_CODE = 2


def _type_code(x, mixed):
    return _MIXED_CODE if mixed else _DTYPE_CODES[x.dtype]


def _launch(x, w1, b1, w2, b2, mixed=False):
    """Run K1's forward on x [B, H, W, C]; returns y (like x, or float32 in
    the mixed mode) and the mean and gate [B, C] in float32, which the
    backward takes. Weights stacked [M, ...] run the member mode."""
    bsz, h, w, c, cr, members = _check_gate(x, w1, b1, w2, b2)
    dev = x.device
    w1, b1, w2, b2 = _weights32(dev, w1, b1, w2, b2)
    y = torch.empty_like(x, dtype=torch.float32 if mixed else x.dtype)
    plan = _ca_plan((bsz, h, w, c), cr, x.dtype, *_ca_limits(dev),
                    aligned=x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0,
                    out_dtype=y.dtype, members=members)
    # two allocations: a custom op's outputs may not alias one another
    m, g = (torch.empty((bsz, c), dtype=torch.float32, device=dev)
            for _ in range(2))
    stream_regime = plan['regime'] == 'stream'
    partial = (torch.empty((bsz, plan['parts'], c), dtype=torch.float32,
                           device=dev) if stream_regime else None)
    counters = _arrival_counters(dev, 'ca', _CA_COUNTERS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ca_lib().dl4ds_channel_attention(
            _type_code(x, mixed), _REGIME_CODES[plan['regime']], plan['vec'],
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), m.data_ptr(), g.data_ptr(),
            partial.data_ptr() if stream_regime else None,
            counters.data_ptr(), bsz, h * w, c, cr, plan['parts'],
            plan['ppp'], plan['region'], plan['smem'], plan['apply_blocks'],
            bsz // members, stream)
    if err != 0:
        raise RuntimeError(f'channel-attention kernel launch failed with CUDA '
                           f'error {err} (plan {plan})')
    fused_channel_attention.launches += 1
    return y, m, g


def _launch_backward(x, w1, b1, w2, b2, dy, m, g, mixed=False):
    """Run K1's backward: (dx, dw1, db1, dw2, db2) from x, dy [B, H, W, C]
    and the forward's mean and gate m, g [B, C] float32; dx like x. In the
    mixed mode dy is float32 and x bfloat16. Weights stacked [M, ...] run
    the member mode, whose weight gradients are [M, ...]."""
    bsz, h, w, c, cr, members = _check_gate(x, w1, b1, w2, b2)
    dy_dtype = torch.float32 if mixed else x.dtype
    if dy.dtype != dy_dtype or dy.shape != x.shape:
        raise ValueError(f'channel-attention backward needs dy of x\'s shape '
                         f'{tuple(x.shape)} in {dy_dtype}, got '
                         f'{tuple(dy.shape)} {dy.dtype}')
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
                    aligned=all(t.data_ptr() % 16 == 0 for t in (x, dy, dx)),
                    out_dtype=dy.dtype, members=members)
    n_out = 2 * c * cr + c + cr
    lead = w1.shape[:-2]
    dw = torch.empty(members * n_out, dtype=torch.float32, device=dev)
    nw = members * c * cr
    dw1 = dw[:nw].view(*lead, c, cr)
    dw2 = dw[nw:2 * nw].view(*lead, cr, c)
    db1 = dw[2 * nw:2 * nw + members * cr].view(*lead, cr)
    db2 = dw[2 * nw + members * cr:].view(*lead, c)
    n_chunks = members * -(-(bsz // members) // _CA_CHUNK)
    row_len = c + (3 if mixed else 2) * cr
    rows = torch.empty(bsz * row_len + n_chunks * n_out,
                       dtype=torch.float32, device=dev)
    stream_regime = plan['regime'] == 'stream'
    partial = dmh = None
    if stream_regime:
        scratch = torch.empty(bsz * c * (plan['parts'] + 1),
                              dtype=torch.float32, device=dev)
        partial, dmh = scratch[:bsz * c * plan['parts']], scratch[-bsz * c:]
    counters = _arrival_counters(dev, 'ca', _CA_COUNTERS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ca_lib().dl4ds_channel_attention_bwd(
            _type_code(x, mixed), _REGIME_CODES[plan['regime']], plan['vec'],
            x.data_ptr(), dy.data_ptr(), m.data_ptr(), g.data_ptr(),
            w1_.data_ptr(), b1_.data_ptr(), w2_.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            partial.data_ptr() if stream_regime else None,
            dmh.data_ptr() if stream_regime else None, rows.data_ptr(),
            rows[bsz * row_len:].data_ptr(), counters.data_ptr(),
            _CA_COUNTER_SLOT, bsz, h * w, c, cr, plan['parts'], plan['ppp'],
            plan['bwd_region'], plan['bwd_smem'], plan['apply_blocks'],
            bsz // members, stream)
    if err != 0:
        raise RuntimeError(f'channel-attention backward kernel launch failed '
                           f'with CUDA error {err} (plan {plan})')
    fused_channel_attention.bwd_launches += 1
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def _plain_forward(x, w1, b1, w2, b2, mixed=False):
    """(y, m, g) of the gate on the CPU: `_gate` and the multiply, member by
    member for stacked weights."""
    if w1.dim() == 3:
        return by_member(lambda xs, *w: _plain_forward(xs, *w, mixed),
                         (x,), (w1, b1, w2, b2), 3)
    m, g = _gate(x, w1, b1, w2, b2, mixed)
    y = (x.float() * g[..., None, None, :] if mixed
         else x * g.to(x.dtype)[..., None, None, :])
    return y, m, g


def _plain_backward(x, w1, b1, w2, b2, dy, m, g, mixed=False):
    """`_channel_attention_backward`, member by member for stacked weights
    (the weight gradients [M, ...])."""
    if w1.dim() == 3:
        return by_member(
            lambda xs, dys, ms, gs, *w: _channel_attention_backward(
                xs, *w, dys, ms, gs, mixed),
            (x, dy, m, g), (w1, b1, w2, b2), 1)
    return _channel_attention_backward(x, w1, b1, w2, b2, dy, m, g, mixed)


@torch.library.custom_op('dl4ds_tpu_torch::channel_attention',
                         mutates_args=())
def _channel_attention_op(x: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, mixed: bool
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K1's forward as the operator `dl4ds_tpu_torch::channel_attention`:
    (y, m, g) of the gate on x [B, H, W, C], y in x's dtype (float32 when
    `mixed`), the mean and gate [B, C] in float32, which the backward takes.
    Its CUDA kernel is `_launch`, its CPU kernel `_plain_forward`, and its
    fake kernel gives the shapes alone, so that `torch.export` traces a
    model through it and freezes the node, not the launch."""
    raise ValueError(f'unsupported device {x.device}')


@_channel_attention_op.register_kernel('cuda')
def _(x, w1, b1, w2, b2, mixed):
    return _launch(x, w1, b1, w2, b2, mixed)


@_channel_attention_op.register_kernel('cpu')
def _(x, w1, b1, w2, b2, mixed):
    return _plain_forward(x, w1, b1, w2, b2, mixed)


@_channel_attention_op.register_fake
def _(x, w1, b1, w2, b2, mixed):
    acc = _acc_dtype(x)
    return (x.new_empty(x.shape, dtype=torch.float32 if mixed else x.dtype),
            x.new_empty((x.shape[0], x.shape[-1]), dtype=acc),
            x.new_empty((x.shape[0], x.shape[-1]), dtype=acc))


@register_flop_formula(torch.ops.dl4ds_tpu_torch.channel_attention)
def _(x_shape, w1_shape, *args, out_shape=None, **kwargs):
    return gate_flops(x_shape, w1_shape)


# the gate's weights (w1, b1, w2, b2) by operand index, with their dims an
# instance
_GATE_WEIGHTS = {1: 2, 2: 1, 3: 2, 4: 1}


def _gate_vmap(gate, info, in_dims, *args):
    """The `vmap` rule of the gate's forward, `gate` (the operator or
    `_FusedGate.apply`) on (x, w1, b1, w2, b2, mixed): `member_vmap`'s, x,
    y, m and g per sample."""
    return member_vmap(gate, info, in_dims, args, (0,), _GATE_WEIGHTS,
                       'channel-attention gate')


_channel_attention_op.register_vmap(
    lambda info, in_dims, *args: _gate_vmap(_channel_attention_op, info,
                                            in_dims, *args))


class _FusedGate(torch.autograd.Function):
    """The differentiable gate on x [B, H, W, C]: forward the operator
    `dl4ds_tpu_torch::channel_attention`, backward `_GateBackward` (the CUDA
    kernels on the GPU, the plain versions on the CPU). `mixed` selects the
    mixed mode; weights stacked [M, ...] the member mode. `forward` returns
    y with the per-sample mean and gate [B, C], which the backward takes
    (outputs, not saved intermediates, as torch.func needs them).

    Under `torch.func.vmap` the `vmap` rule flattens the mapped axis into
    the batch: with mapped weights (an ensemble's members) it runs the
    member mode, else today's gate on the flattened batch. The backward is
    `_GateBackward`, a Function with a `vmap` rule of its own (under
    `vmap(grad(...))` the backward meets batched tensors), which always runs
    the member mode, so that each mapped instance gets its own weight
    gradients."""

    @staticmethod
    def forward(x, w1, b1, w2, b2, mixed=False):
        return _channel_attention_op(x, w1, b1, w2, b2, mixed)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w1, b1, w2, b2, mixed = inputs
        _, m, g = output
        ctx.mark_non_differentiable(m, g)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w1, b1, w2, b2, m, g)
        ctx.mixed = mixed

    @staticmethod
    def backward(ctx, dy, _dm, _dg):
        x, w1, b1, w2, b2, m, g = ctx.saved_tensors
        return _GateBackward.apply(x, w1, b1, w2, b2, dy, m, g,
                                   ctx.mixed) + (None,)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _gate_vmap(_FusedGate.apply, info, in_dims, *args)


class FusedChannelAttention:
    """The gate as an autograd function of (x, w1, b1, w2, b2, mixed=False)
    that returns y: `_FusedGate`, which also returns the mean and gate that
    its backward takes."""

    @staticmethod
    def apply(x, w1, b1, w2, b2, mixed=False):
        return _FusedGate.apply(x, w1, b1, w2, b2, mixed)[0]


class _GateBackward(torch.autograd.Function):
    """K1's backward as a Function of its own: (dx, dw1, db1, dw2, db2) from
    x, the weights, dy and the forward's m and g, the CUDA kernel on the GPU
    and `_plain_backward` on the CPU. Its `vmap` rule flattens the mapped
    axis into the batch and runs the member mode with the weights expanded
    to the mapped size, so that each instance's weight gradients are its
    own. It is not differentiable again."""

    @staticmethod
    def forward(x, w1, b1, w2, b2, dy, m, g, mixed):
        with kernel_flops(lambda: gate_flops(x.shape, w1.shape, True)):
            if x.device.type == 'cuda':
                return _launch_backward(x, w1, b1, w2, b2, dy.contiguous(),
                                        m, g, mixed)
            if x.device.type == 'cpu':
                return _plain_backward(x, w1, b1, w2, b2, dy, m, g, mixed)
        raise ValueError(f'unsupported device {x.device}')

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError('the channel-attention gate is '
                                  'differentiable once')

    @staticmethod
    def vmap(info, in_dims, *args):
        return member_vmap(_GateBackward.apply, info, in_dims, args,
                           (0, 5, 6, 7), _GATE_WEIGHTS,
                           'channel-attention gate', members=True,
                           out_per_sample=(0,))


def fused_channel_attention(x, w1, b1, w2, b2, out_dtype=None):
    """Fused squeeze-excite channel attention: y = x * sigmoid((relu(mean_hw(x)
    @ w1 + b1)) @ w2 + b2).

    x: [..., H, W, C] (leading dims flattened); w1: [C, Cr]; b1: [Cr];
    w2: [Cr, C]; b2: [C] (stacked [M, ...], the member mode: M members of
    the flattened samples in turn). y is in x's dtype, or float32 with
    out_dtype=torch.float32: for a bfloat16 x that is the mixed mode (the
    module docstring), the gate of a bfloat16 model.
    With grad mode on, `_FusedGate` (differentiable, under torch.func's
    transforms too, where an input's `requires_grad` does not show whether
    a transform differentiates it); with grad mode off, the operator
    `dl4ds_tpu_torch::channel_attention` alone, which `torch.export`
    freezes as one node (`export.export_forward`). Both launch the same
    forward kernel once.
    `fused_channel_attention.launches` counts the CUDA forward's calls,
    `.bwd_launches` the backward's (each one or two kernel launches, by
    `_ca_plan`); the CPU path launches nothing.
    """
    *_, h, w, c = x.shape
    args = (x.reshape(-1, h, w, c), w1, b1, w2, b2, _mixed(x, out_dtype))
    if torch.is_grad_enabled():
        y = FusedChannelAttention.apply(*args)
    else:
        y = _channel_attention_op(*args)[0]
    return y.reshape(x.shape)


fused_channel_attention.launches = 0
fused_channel_attention.bwd_launches = 0


# ---------------------------------------------------------------------------
# K1's band mode: the gate on a band of rows, its mean over the whole grid
# ---------------------------------------------------------------------------

def _band_plan(x, cr, out_dtype, tensors):
    """`_ca_plan` of a band x [B, h, W, C] in the band mode (the stream
    regime's cut), 16-byte packs where every tensor is aligned."""
    return _ca_plan(tuple(x.shape), cr, x.dtype, *_ca_limits(x.device),
                    aligned=all(t.data_ptr() % 16 == 0 for t in tensors),
                    out_dtype=out_dtype, band=True)


def _band_call(err, what, plan):
    if err != 0:
        raise RuntimeError(f'channel-attention band {what} launch failed '
                           f'with CUDA error {err} (plan {plan})')


def _check_band(x):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'channel-attention kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f'channel-attention band mode needs a contiguous '
                         f'[B, h, W, C] x, got {tuple(x.shape)}')
    if x.shape[0] > _CA_MAX_BATCH:
        raise ValueError(f'channel-attention kernel takes at most '
                         f'{_CA_MAX_BATCH} samples per call, got '
                         f'{x.shape[0]}')


def ca_band_sums(x):
    """The band mode's first stage: the per-sample channel sums [B, C] of a
    band x [B, h, W, C] (float32; float64 for a float64 x on the CPU). On a
    CUDA tensor one launch (the stream regime's sums without the gate), on
    a CPU tensor the plain sum."""
    if x.device.type == 'cpu':
        return x.to(_acc_dtype(x)).sum(dim=(-3, -2))
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    _check_band(x)
    bsz, h, w, c = x.shape
    plan = _band_plan(x, 1, None, (x,))
    sums = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    partial = torch.empty((bsz, plan['parts'], c), dtype=torch.float32,
                          device=x.device)
    counters = _arrival_counters(x.device, 'ca', _CA_COUNTERS)
    with torch.cuda.device(x.device):
        err = _ca_lib().dl4ds_channel_attention_band(
            _DTYPE_CODES[x.dtype], 0, plan['vec'], x.data_ptr(), None, None,
            None, None, None, sums.data_ptr(), None, None, partial.data_ptr(),
            counters.data_ptr(), bsz, h * w, h * w, c, 1, plan['parts'],
            plan['ppp'], plan['region'], _ca_smem(plan['region'], plan['vec'],
                                                  c, 1),
            plan['apply_blocks'], torch.cuda.current_stream(x.device)
            .cuda_stream)
    _band_call(err, 'sums', plan)
    fused_channel_attention_band.launches += 1
    return sums


def ca_band_apply(x, sums, hw, w1, b1, w2, b2, mixed=False):
    """The band mode's second stage: (y, m, g) of the gate on the band x
    [B, h, W, C] from the whole grid's sums [B, C] of `hw` pixels: m = sums
    / hw, the gate, y = x g (y float32 in the mixed mode). On a CUDA tensor
    two launches (the gate, a CTA a sample, then the stream regime's
    apply), on a CPU tensor the plain version."""
    if x.device.type == 'cpu':
        m, g = _gate_of_mean(sums / hw, w1, b1, w2, b2, mixed)
        y = (x.float() * g[..., None, None, :] if mixed
             else x * g.to(x.dtype)[..., None, None, :])
        return y, m, g
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    _check_band(x)
    bsz, h, w, c, cr, members = _check_gate(x, w1, b1, w2, b2)
    if members != 1:
        raise ValueError('the channel-attention band mode has no member mode')
    if sums.dtype != torch.float32 or sums.shape != (bsz, c) \
            or not sums.is_contiguous() or sums.device != x.device:
        raise ValueError(f'channel-attention band mode needs the sums as a '
                         f'contiguous float32 [{bsz}, {c}] on {x.device}')
    if hw < h * w:
        raise ValueError(f'the grid\'s {hw} pixels are fewer than the '
                         f'band\'s {h * w}')
    dev = x.device
    w1, b1, w2, b2 = _weights32(dev, w1, b1, w2, b2)
    y = torch.empty_like(x, dtype=torch.float32 if mixed else x.dtype)
    plan = _band_plan(x, cr, y.dtype, (x, y))
    m, g = (torch.empty((bsz, c), dtype=torch.float32, device=dev)
            for _ in range(2))
    with torch.cuda.device(dev):
        err = _ca_lib().dl4ds_channel_attention_band(
            _type_code(x, mixed), 1, plan['vec'], x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            sums.data_ptr(), m.data_ptr(), g.data_ptr(), None, None, bsz,
            h * w, hw, c, cr, plan['parts'], plan['ppp'], plan['region'],
            plan['smem'], plan['apply_blocks'],
            torch.cuda.current_stream(dev).cuda_stream)
    _band_call(err, 'gate', plan)
    fused_channel_attention_band.launches += 1
    return y, m, g


def ca_band_grads(x, w1, b1, w2, b2, dy, m, g, mixed=False):
    """The band mode's backward, first stage: the band's parts (dm, dw1,
    db1, dw2, db2) of the gradients from x, dy [B, h, W, C] and the whole
    grid's m, g [B, C], dm [B, C] float32 undivided (`_partial_grads`).
    They sum over the bands to the whole grid's. On a CUDA tensor one
    launch (the stream regime's sums of dy x, the MLP backward at each
    sample's last chunk, the weight gradients at the batch's last)."""
    if x.device.type == 'cpu':
        return _partial_grads(x, w1, b1, w2, b2, dy, m, g, mixed)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    _check_band(x)
    bsz, h, w, c, cr, members = _check_gate(x, w1, b1, w2, b2)
    if members != 1:
        raise ValueError('the channel-attention band mode has no member mode')
    dy_dtype = torch.float32 if mixed else x.dtype
    if dy.dtype != dy_dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f'channel-attention band backward needs a contiguous '
                         f'dy of x\'s shape {tuple(x.shape)} in {dy_dtype}, '
                         f'got {tuple(dy.shape)} {dy.dtype}')
    for name, t in (('m', m), ('g', g)):
        if t.dtype != torch.float32 or t.shape != (bsz, c) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'channel-attention band backward needs {name} '
                             f'as a contiguous float32 [{bsz}, {c}] on '
                             f'{x.device}')
    dev = x.device
    w1_, b1_, w2_ = _weights32(dev, w1, b1, w2)
    plan = _band_plan(x, cr, dy.dtype, (x, dy))
    n_out = 2 * c * cr + c + cr
    dw = torch.empty(n_out, dtype=torch.float32, device=dev)
    dw1, dw2 = dw[:c * cr].view(c, cr), dw[c * cr:2 * c * cr].view(cr, c)
    db1, db2 = dw[2 * c * cr:2 * c * cr + cr], dw[2 * c * cr + cr:]
    n_chunks = -(-bsz // _CA_CHUNK)
    row_len = c + (3 if mixed else 2) * cr
    rows = torch.empty(bsz * row_len + n_chunks * n_out, dtype=torch.float32,
                       device=dev)
    partial = torch.empty(bsz * c * plan['parts'], dtype=torch.float32,
                          device=dev)
    dm = torch.empty((bsz, c), dtype=torch.float32, device=dev)
    counters = _arrival_counters(dev, 'ca', _CA_COUNTERS)
    with torch.cuda.device(dev):
        err = _ca_lib().dl4ds_channel_attention_band_bwd(
            _type_code(x, mixed), 0, plan['vec'], x.data_ptr(), dy.data_ptr(),
            m.data_ptr(), g.data_ptr(), w1_.data_ptr(), b1_.data_ptr(),
            w2_.data_ptr(), None, dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), partial.data_ptr(), dm.data_ptr(),
            rows.data_ptr(), rows[bsz * row_len:].data_ptr(),
            counters.data_ptr(), _CA_COUNTER_SLOT, bsz, h * w, h * w, c, cr,
            plan['parts'], plan['ppp'], plan['bwd_region'], plan['bwd_smem'],
            plan['apply_blocks'], torch.cuda.current_stream(dev).cuda_stream)
    _band_call(err, 'backward', plan)
    fused_channel_attention_band.bwd_launches += 1
    return (dm, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


def ca_band_dx(x, dy, g, dm, hw, mixed=False):
    """The band mode's backward, second stage: dx = dy g + dm / hw on the
    band (`_dx_of`; dx like x), from the whole grid's undivided dm [B, C]
    and its `hw` pixels. On a CUDA tensor one launch (the stream regime's
    apply)."""
    if x.device.type == 'cpu':
        return _dx_of(x, dy, g, dm, hw, mixed)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    _check_band(x)
    bsz, h, w, c = x.shape
    for name, t in (('g', g), ('dm', dm)):
        if t.dtype != torch.float32 or t.shape != (bsz, c) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'channel-attention band backward needs {name} '
                             f'as a contiguous float32 [{bsz}, {c}] on '
                             f'{x.device}')
    dy_dtype = torch.float32 if mixed else x.dtype
    if dy.dtype != dy_dtype or dy.shape != x.shape or not dy.is_contiguous():
        raise ValueError(f'channel-attention band backward needs a contiguous '
                         f'dy of x\'s shape {tuple(x.shape)} in {dy_dtype}')
    if hw < h * w:
        raise ValueError(f'the grid\'s {hw} pixels are fewer than the '
                         f'band\'s {h * w}')
    dev = x.device
    dx = torch.empty_like(x)
    plan = _band_plan(x, 1, dy.dtype, (x, dy, dx))
    with torch.cuda.device(dev):
        err = _ca_lib().dl4ds_channel_attention_band_bwd(
            _type_code(x, mixed), 1, plan['vec'], x.data_ptr(), dy.data_ptr(),
            None, g.data_ptr(), None, None, None, dx.data_ptr(), None, None,
            None, None, None, dm.data_ptr(), None, None, None,
            _CA_COUNTER_SLOT, bsz, h * w, hw, c, 1, plan['parts'],
            plan['ppp'], plan['bwd_region'],
            _ca_smem(plan['bwd_region'], plan['vec'], c, 1),
            plan['apply_blocks'], torch.cuda.current_stream(dev).cuda_stream)
    _band_call(err, 'dx', plan)
    fused_channel_attention_band.bwd_launches += 1
    return dx


class _BandGate(torch.autograd.Function):
    """K1's band mode as an autograd function of (x, w1, b1, w2, b2, mixed,
    group): x a band [B, h, W, C] of each sample, the bands of `group`'s
    ranks together the grid, the gate's mean over the grid. Forward
    `ca_band_sums`, an all-reduce of the sums over `group`, `ca_band_apply`;
    backward `ca_band_grads` (the band's parts of the weight gradients,
    which the ranks' gradient reduction sums), an all-reduce of dm,
    `ca_band_dx`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, mixed, group):
        hw = x.shape[-3] * x.shape[-2] * torch.distributed.get_world_size(
            group)
        sums = ca_band_sums(x)
        torch.distributed.all_reduce(sums, group=group)
        y, m, g = ca_band_apply(x, sums, hw, w1, b1, w2, b2, mixed)
        ctx.save_for_backward(x, w1, b1, w2, b2, m, g)
        ctx.mixed, ctx.group, ctx.hw = mixed, group, hw
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, m, g = ctx.saved_tensors
        dy = dy.contiguous()
        dm, *dws = ca_band_grads(x, w1, b1, w2, b2, dy, m, g, ctx.mixed)
        torch.distributed.all_reduce(dm, group=ctx.group)
        dx = ca_band_dx(x, dy, g, dm, ctx.hw, ctx.mixed)
        return (dx, *dws, None, None)


def fused_channel_attention_band(x, w1, b1, w2, b2, group, out_dtype=None):
    """K1's band mode: the gate y = x * sigmoid(relu(m @ w1 + b1) @ w2 + b2)
    on x [B, h, W, C], this rank's band of rows of each sample, m the mean
    over the whole grid, the bands of the ranks of `group` (equal heights,
    in rank order). `out_dtype` as `fused_channel_attention`'s (float32
    with a bfloat16 x: the mixed mode). Differentiable; its weight
    gradients are this band's parts, which sum over the ranks to the
    grid's. On a CUDA tensor the kernels of `csrc/channel_attention.cu`'s
    band mode: each stage's wrapper adds one to
    `fused_channel_attention_band.launches` (the forward's two) or
    `.bwd_launches` (the backward's two)."""
    x = x.contiguous()
    return _BandGate.apply(x, w1, b1, w2, b2, _mixed(x, out_dtype), group)


fused_channel_attention_band.launches = 0
fused_channel_attention_band.bwd_launches = 0


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
    losses pass the data range of their inputs).

    Under `torch.func.vmap` the `vmap` rules fold the mapped axis into the
    images' leading axes, one launch each way, where `max_val` is shared
    (not mapped, and in the backward not asked for); a mapped `max_val`
    (the DSSIM losses under an ensemble: each member's own data range)
    takes one launch a mapped instance, since the kernel reads one
    `max_val`. The backward is `_SSIMBackward`, a Function with a `vmap`
    rule of its own."""

    @staticmethod
    def forward(img1, img2, max_val, filter_size, filter_sigma, k1, k2):
        with kernel_flops(lambda: ssim_flops(img1.shape, filter_size)):
            if img1.device.type == 'cuda':
                return _launch_ssim(img1, img2, max_val, filter_size,
                                    filter_sigma, k1, k2)
            if img1.device.type == 'cpu':
                return ssim(img1, img2, max_val, filter_size, filter_sigma,
                            k1, k2)
        raise ValueError(f'unsupported device {img1.device}')

    @staticmethod
    def setup_context(ctx, inputs, output):
        img1, img2, max_val, *params = inputs
        ctx.params = tuple(params)
        if torch.is_tensor(max_val):
            ctx.save_for_backward(img1, img2, max_val)
        else:
            ctx.save_for_backward(img1, img2)
            ctx.max_val = max_val

    @staticmethod
    def backward(ctx, g):
        img1, img2, *max_val = ctx.saved_tensors
        max_val = max_val[0] if max_val else ctx.max_val
        d1, d2, dm = _SSIMBackward.apply(img1, img2, max_val, g, *ctx.params,
                                         tuple(ctx.needs_input_grad[:3]))
        grads = [None if d is None else d.to(t.dtype)
                 for d, t in ((d1, img1), (d2, img2))]
        if dm is not None:
            dm = dm.to(max_val.dtype).reshape(max_val.shape)
        return (*grads, dm, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, img1, img2, max_val, *params):
        n = info.batch_size
        a, b = (front(t, d, n) for t, d in zip((img1, img2), in_dims))
        if in_dims[2] is None:
            return FusedSSIM.apply(a, b, max_val, *params), 0
        mv = front(max_val, in_dims[2], n)
        return torch.stack([FusedSSIM.apply(a[i], b[i], mv[i], *params)
                            for i in range(n)]), 0


class _SSIMBackward(torch.autograd.Function):
    """K6's backward as a Function: the gradients (img1, img2, max_val) of
    sum(g * ssim), None where `need` does not ask; the CUDA kernel on the
    GPU, `ssim_backward_reference` on the CPU. Its `vmap` rule folds the
    mapped axis into the images' leading axes where `max_val` is shared
    and its gradient not asked for (a shared max_val's gradient would sum
    over every instance), else launches once a mapped instance. It is not
    differentiable again."""

    @staticmethod
    def forward(img1, img2, max_val, g, filter_size, filter_sigma, k1, k2,
                need):
        args = (img1, img2, max_val, g, filter_size, filter_sigma, k1, k2)
        # the images' gradients take the band products; max_val's none
        flops = (lambda: ssim_flops(img1.shape, filter_size)
                 if need[0] or need[1] else 0)
        with kernel_flops(flops):
            if img1.device.type == 'cuda':
                return _launch_ssim_backward(*args, need=need)
            if img1.device.type == 'cpu':
                return ssim_backward_reference(*args, need=need)
        raise ValueError(f'unsupported device {img1.device}')

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError('the fused SSIM is differentiable once')

    @staticmethod
    def vmap(info, in_dims, img1, img2, max_val, g, *params):
        n = info.batch_size
        need = params[-1]
        a, b = (front(t, d, n) for t, d in zip((img1, img2), in_dims))
        gs = front(g, in_dims[3], n)
        if in_dims[2] is None and not need[2]:
            out = _SSIMBackward.apply(a, b, max_val, gs, *params)
        else:
            mv = (front(max_val, in_dims[2], n) if torch.is_tensor(max_val)
                  else [max_val] * n)
            outs = [_SSIMBackward.apply(a[i], b[i], mv[i], gs[i], *params)
                    for i in range(n)]
            out = tuple(None if o[0] is None else torch.stack(o)
                        for o in zip(*outs))
        return out, tuple(None if t is None else 0 for t in out)


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
