"""
Fused ConvLSTM layer (K2 forward; K3, or K4 and a GEMM tail, backward), the
counterpart of `dl4ds_tpu/ops/pallas_convlstm.py`'s `fused_convlstm`.

On CUDA tensors `fused_convlstm` launches the hand-written Hopper kernels:
with grad mode off, K2's inference variant (`csrc/convlstm.cu`: the input
conv over all frames with step 0's gates, then one launch per later time
step, T launches a layer; 3xTF32 tensor-core products); with it on,
`FusedConvLSTM`, whose forward is K2's training variant (the same
launches, also writing the `cs` and `zs` residuals). Its backward takes
one of two routes, chosen by `dispatch_info` from the layer's shape alone:
'fused', K3: the sequential dh/dc chain (`csrc/convlstm_seq.cu`, T
chain-step launches writing dz for every step), dx with the same tile, and
the weight gradients of `csrc/convlstm_bwd.cu`, all 3xTF32 tensor-core
tiles; or 'split', K4 (the same chain launches) followed by
`convlstm_backward_tail`, float32 GEMMs for dx, dWx, dWh and db over all
frames at once. On CPU tensors the same routing runs the
plain PyTorch versions (`convlstm_train_reference`,
`convlstm_backward_reference`, `convlstm_seq_reference`; the tail is the
same code on both devices), which are the kernels' oracles. There is no
size-based or error-based fallback on the GPU: each route launches its
kernels or raises. K2's inference variant is the `torch.library` operator
`dl4ds_tpu_torch::convlstm`, which `torch.export` freezes as one node.

Weights keep the JAX layout: wx [kh, kw, Cin, 4F] (HWIO), bx [4F],
wh [kh, kw, F, 4F], gates split along 4F in the order i, f, c, o.
Activations are [B, T, H, W, C]; the residuals are zs [B, T, H, W, 4F]
(the pre-activations, gate-major along the last axis) and cs [B, T, H, W, F].

The member mode (a deep ensemble's members in one call, K1's in
`fused_ops`): the weights stacked [M, ...] with x [M*B, ...] holding M
members of B samples in turn; sample b runs with member b // B's weights,
and the weight gradients come back [M, ...]. Every kernel plans and routes
from the per-member batch B and repeats that grid M times, so that a
member-mode call equals M one-member calls bit for bit. Under
`torch.func.vmap` over stacked weights (`parallel.make_ensemble_step`,
`predict_ensemble`) the `vmap` rules of `_FusedConvLSTM`,
`_ConvLSTMBackward` and the operator reach it. On CPU tensors it runs the
plain versions member by member. The JAX package's Pallas ConvLSTM has no
batching rule under `vmap` (its `custom_partitioning` wrappers), so its
ensembles run the XLA recurrence: the same function.

float32 and bfloat16 (every tensor in one dtype). In bfloat16 the products
accumulate in float32 and every stored tensor is bfloat16, rounded where
the JAX kernels store in the model dtype (dl4ds_tpu/ops/pallas_convlstm.py
:188-201, :235-262, :289-333, :834-851): zx after the input conv and again
after its bias, the recurrent conv, z, every gate op (the gate algebra runs
op by op in bfloat16, its constants 0.2 included), the h and c carries and
ys, zs and cs; backward, every op of the dh/dc chain, each step's dh and
dc carries and dz, dx, and the weight and bias gradients, each formed in
float32 and rounded once. The plain versions do it with PyTorch's
bfloat16 ops, each of which rounds once, and are the kernels' oracles.
"""

import contextlib
import ctypes

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .flops import convlstm_flops, kernel_flops
from .members import by_member, member_vmap

__all__ = ['fused_convlstm', 'convlstm_reference', 'convlstm_train_reference',
           'convlstm_backward_reference', 'convlstm_seq_reference',
           'convlstm_backward_tail', 'dispatch_info', 'FusedConvLSTM',
           'hard_sigmoid', 'd_hard_sigmoid']


# 0.2 as a bfloat16 multiplies a bfloat16 z, as JAX's weakly typed 0.2 does
_BF16_FIFTH = 0.2001953125


def hard_sigmoid(x):
    """Keras hard_sigmoid, clip(0.2 x + 0.5, 0, 1): the ConvLSTM gate
    (not `F.hardsigmoid`, which is clip(x / 6 + 0.5, 0, 1)); in bfloat16
    with 0.2 rounded to bfloat16 and each op rounding."""
    a = _BF16_FIFTH if x.dtype == torch.bfloat16 else 0.2
    return torch.clamp(a * x + 0.5, 0.0, 1.0)


def d_hard_sigmoid(x):
    """Derivative of `hard_sigmoid` as the JAX kernel takes it
    (`_d_hard_sigmoid`, dl4ds_tpu/ops/pallas_convlstm.py:73-79): 0.2 where
    the gate lies strictly between 0 and 1, so 0 at z = +-2.5 (autograd
    through `torch.clamp` passes the gradient at the ends). The step is
    decided in float32, as the kernels decide it, also for float64 x: a
    float64 run of the plain versions (the kernels' oracle on the card)
    then steps at the same z, where 0.2 z + 0.5 rounds to 0 or 1 in
    float32 but not in float64."""
    g = hard_sigmoid(x.float() if x.dtype == torch.float64 else x)
    return torch.where((g > 0) & (g < 1), 0.2, 0.0).to(x.dtype)


def _conv_same(x, w):
    """SAME-padded stride-1 conv of NHWC x [N, H, W, C] with an HWIO kernel
    (odd sizes); NHWC out. bfloat16 in float32, rounded once (the plain
    versions' products: `_acc`)."""
    kh, kw = w.shape[:2]
    y = F.conv2d(_acc(x).permute(0, 3, 1, 2), _acc(w).permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _conv_same_t(dz, w):
    """The adjoint of `_conv_same` in its input: dz [N, H, W, Co] -> [N, H,
    W, C] for the HWIO kernel w [kh, kw, C, Co]; bfloat16 as `_conv_same`."""
    kh, kw = w.shape[:2]
    y = F.conv_transpose2d(_acc(dz).permute(0, 3, 1, 2),
                           _acc(w).permute(3, 2, 0, 1),
                           padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1).to(dz.dtype)


def _conv_same_w(src, dz, w_shape):
    """The adjoint of `_conv_same` in its kernel: sum over the frames of
    src [N, H, W, C] and dz [N, H, W, Co] -> HWIO [kh, kw, C, Co]; for
    bfloat16 inputs formed in float32 and rounded once."""
    kh, kw, c, co = w_shape
    g = torch.nn.grad.conv2d_weight(
        _acc(src).permute(0, 3, 1, 2), (co, c, kh, kw),
        _acc(dz).permute(0, 3, 1, 2), padding=(kh // 2, kw // 2))
    return g.permute(2, 3, 1, 0).to(dz.dtype)


def _acc(t):
    """t in its accumulation dtype: float32 for bfloat16, else its own. A
    bfloat16 product of the plain versions is taken in float32 and rounded
    once, as XLA's CPU convolutions and dots are (oneDNN's bfloat16
    convolution rounds a few outputs otherwise)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _gemm(a, b):
    """a @ b rounded once to the operands' dtype: a bfloat16 GEMM with
    float32 reductions on the card (`_fp32_matmuls`), float32 and a
    rounding on the CPU (`_acc`)."""
    if a.is_cuda:
        return a @ b
    return (_acc(a) @ _acc(b)).to(a.dtype)


def convlstm_train_reference(x, wx, bx, wh, states=None):
    """Plain PyTorch whole layer with the backward's residuals (the input
    conv over all B*T frames at once, then the recurrent conv, gates and
    state updates step by step, as `convlstm_reference` and `_fwd_kernel`,
    dl4ds_tpu/ops/pallas_convlstm.py:82-112 and :244-263). x: [B, T, H, W,
    Cin]; returns (ys, cs, zs): [B, T, H, W, F] twice and [B, T, H, W, 4F],
    zs the pre-activation of every step, bias and recurrent term
    included. With `states`, the (ys, cs) of a run being checked, step t
    starts from their h_{t-1} and c_{t-1}: a recurrence held step by step,
    where one rounding flip would otherwise be carried through the later
    steps. Weights stacked [M, ...]: the member mode, member by member."""
    _check_kernels(x, wx, bx, wh)
    if wx.dim() == 5:
        return by_member(
            lambda xs, *rest: convlstm_train_reference(
                xs, *rest[-3:], states=rest[:2] if len(rest) == 5 else None),
            (x,) + tuple(states or ()), (wx, bx, wh), 3)
    b, t, h, w, cin = x.shape
    f = wh.shape[2]
    zx = _conv_same(x.reshape(b * t, h, w, cin), wx) + bx
    zx = zx.reshape(b, t, h, w, 4 * f)
    hh = x.new_zeros((b, h, w, f))
    cc = x.new_zeros((b, h, w, f))
    ys, cs, zs = [], [], []
    for i in range(t):
        if states is not None and i > 0:
            hh, cc = states[0][:, i - 1], states[1][:, i - 1]
        z = zx[:, i] + _conv_same(hh, wh)
        zi, zf, zc, zo = torch.split(z, f, dim=-1)
        cc = hard_sigmoid(zf) * cc + hard_sigmoid(zi) * torch.tanh(zc)
        hh = hard_sigmoid(zo) * torch.tanh(cc)
        ys.append(hh)
        cs.append(cc)
        zs.append(z)
    return (torch.stack(ys, dim=1), torch.stack(cs, dim=1),
            torch.stack(zs, dim=1))


def convlstm_reference(x, wx, bx, wh):
    """Plain PyTorch whole layer with the JAX signature (`convlstm_reference`,
    dl4ds_tpu/ops/pallas_convlstm.py:82-112). x: [B, T, H, W, Cin]; returns
    (ys, cs): [B, T, H, W, F]."""
    ys, cs, _ = convlstm_train_reference(x, wx, bx, wh)
    return ys, cs


def convlstm_seq_reference(zs, cs, dys, wh, given=None):
    """Plain PyTorch sequential half of the BPTT, K4's plain version
    (transcribes `_bwd_seq_kernel`, dl4ds_tpu/ops/pallas_convlstm.py:269-332):
    the reverse dh/dc chain on the saved zs and cs. Returns dzs [B, T, H, W,
    4F], the gradient of every step's pre-activations, gate-major. With
    `given`, the dzs of a run being checked, step t's recurrent term is
    taken from its dz_{t+1} (the chain held step by step). wh stacked [M,
    ...]: the member mode, member by member."""
    if wh.dim() == 5:
        return by_member(
            lambda *a: (convlstm_seq_reference(*a[:3], a[-1], given=(
                a[3] if len(a) == 5 else None)),),
            (zs, cs, dys) + (() if given is None else (given,)), (wh,), 1)[0]
    b, t, h, w, f4 = zs.shape
    f = f4 // 4
    dh_next = dc_next = zero = cs.new_zeros((b, h, w, f))
    dzs = [None] * t
    for i in reversed(range(t)):
        if given is not None and i + 1 < t:
            dh_next = _conv_same_t(given[:, i + 1], wh)
        zi, zf, zc, zo = torch.split(zs[:, i], f, dim=-1)
        gi, gf, gg, go = (hard_sigmoid(zi), hard_sigmoid(zf), torch.tanh(zc),
                          hard_sigmoid(zo))
        c_prev = cs[:, i - 1] if i > 0 else zero
        tc = torch.tanh(cs[:, i])
        dh = dys[:, i] + dh_next
        do = dh * tc
        dc = dh * go * (1 - tc * tc) + dc_next
        dz = torch.cat([dc * gg * d_hard_sigmoid(zi),
                        dc * c_prev * d_hard_sigmoid(zf),
                        dc * gi * (1 - gg * gg),
                        do * d_hard_sigmoid(zo)], dim=-1)
        dzs[i] = dz
        dh_next = _conv_same_t(dz, wh)
        dc_next = dc * gf
    return torch.stack(dzs, dim=1)


def convlstm_backward_reference(x, wx, wh, zs, cs, ys, dys):
    """Plain PyTorch BPTT of the layer (transcribes `_bwd_kernel`,
    dl4ds_tpu/ops/pallas_convlstm.py:335-432), K3's plain version: the
    reverse dh/dc chain on the saved zs, cs and ys (`convlstm_seq_reference`),
    then dx, dWx, dWh and db over the whole window with PyTorch's convolution
    adjoints. Returns (dx, dwx, dbx, dwh) in the layouts of (x, wx, bx,
    wh); weights stacked [M, ...]: the member mode, member by member."""
    if wx.dim() == 5:
        return by_member(
            lambda xs, zs_, cs_, ys_, dys_, wx_, wh_:
            convlstm_backward_reference(xs, wx_, wh_, zs_, cs_, ys_, dys_),
            (x, zs, cs, ys, dys), (wx, wh), 1)
    b, t, h, w, cin = x.shape
    f = wh.shape[2]
    dzs = convlstm_seq_reference(zs, cs, dys, wh)
    dz = dzs.reshape(b * t, h, w, 4 * f)
    dx = _conv_same_t(dz, wx).reshape(x.shape)
    dwx = _conv_same_w(x.reshape(b * t, h, w, cin), dz, wx.shape)
    dbx = _acc(dz).sum(dim=(0, 1, 2)).to(dz.dtype)
    if t > 1:   # h_{-1} = 0: step 0 adds nothing to dWh
        dz_h = dzs[:, 1:].reshape(b * (t - 1), h, w, 4 * f)
        dwh = _conv_same_w(ys[:, :-1].reshape(b * (t - 1), h, w, f), dz_h,
                           wh.shape)
    else:
        dwh = torch.zeros_like(wh)
    return dx, dwx, dbx, dwh


@contextlib.contextmanager
def _fp32_matmuls():
    """Float32 matmuls without TF32 and bfloat16 ones with float32
    reductions inside, whatever the caller set (with PyTorch's newer
    per-backend flag where it has one: reading the legacy `allow_tf32`
    raises once the new one was set). PyTorch lets cuBLAS reduce a
    bfloat16 GEMM's split-K partials in bfloat16 by default."""
    m = torch.backends.cuda.matmul
    name, value = (('fp32_precision', 'ieee') if hasattr(m, 'fp32_precision')
                   else ('allow_tf32', False))
    saved = getattr(m, name), m.allow_bf16_reduced_precision_reduction
    setattr(m, name, value)
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        setattr(m, name, saved[0])
        m.allow_bf16_reduced_precision_reduction = saved[1]


def _unfold(src, kh, kw):
    """SAME-padded neighbourhoods: src [N, H, W, C] -> [N*H*W, kh*kw*C],
    row p holding src_pad[p + (dy, dx), c] in (dy, dx, c) order, the
    layout of an HWIO kernel's first three axes."""
    n, h, w, c = src.shape
    pad = F.pad(src, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    s = pad.stride()
    win = pad.as_strided((n, h, w, kh, kw, c),
                         (s[0], s[1], s[2], s[1], s[2], s[3]))
    return win.reshape(n * h * w, kh * kw * c)


def convlstm_backward_tail(x, wx, wh, ys, dzs, need_dx=True):
    """The T-parallel half of the split BPTT (the counterpart of
    `_backward_split`'s contractions, dl4ds_tpu/ops/pallas_convlstm.py:
    840-866), over all B*T frames at once from dzs, the chain's output:
    dx = convT(dz, wx), dWx from x and dz, dWh from h_{t-1} (ys one step
    back; step 0 adds nothing) and dz of steps 1.., dbx = sum of dz.

    The weight gradients are one GEMM each over the unfolded source, [kh*kw
    *C, M] @ [M, 4F]; dx is one GEMM dz @ wx^T, [M, 4F] @ [4F, kh*kw*Cin],
    whose kh*kw taps are then added into place (unfolding dz instead would
    take kh*kw*4F floats a pixel). All products are float32 without TF32,
    whatever the caller set: the route is a matter of speed and changes the
    result only by float32 summation order. cuDNN's float32 weight gradient
    is not used: at 5x5 and 64 channels it is off by about 1e-2 of max |ref|
    (ROADMAP.md section 3). In bfloat16 each result is formed in float32 and
    rounded once, as the JAX tail's `preferred_element_type=f32` products
    and `acc_x.astype(dt)` round it (dl4ds_tpu/ops/pallas_convlstm.py:
    845-851): the weight gradients are bfloat16 GEMMs with float32
    reductions (one rounding each), dx's taps are summed in float32 and
    then rounded. The same code runs on the CPU and on the card. Returns
    (dx or None, dwx, dbx, dwh). Weights stacked [M, ...]: the member mode,
    member by member (each member's products those of its own call), the
    gradients [M, ...]."""
    if wx.dim() == 5:
        return by_member(
            lambda xs, ys_, dzs_, wx_, wh_: convlstm_backward_tail(
                xs, wx_, wh_, ys_, dzs_, need_dx), (x, ys, dzs), (wx, wh), 1)
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    dz = dzs.reshape(b * t * h * w, f4)
    with _fp32_matmuls():
        dwx = _gemm(_unfold(x.reshape(b * t, h, w, cin), kh, kw).t(),
                    dz).view(wx.shape)
        dbx = _acc(dz).sum(dim=0).to(dz.dtype)
        if t > 1:   # h_{-1} = 0: step 0 adds nothing to dWh
            src = _unfold(ys[:, :-1].reshape(b * (t - 1), h, w, f), kh, kw)
            dwh = _gemm(src.t(), dzs[:, 1:].reshape(-1, f4)).view(wh.shape)
            del src
        else:
            dwh = torch.zeros_like(wh)
        if not need_dx:
            return None, dwx, dbx, dwh
        col = (_acc(dz) @ _acc(wx).reshape(kh * kw * cin, f4).t()).view(
            b * t, h, w, kh, kw, cin)
    dx = col.new_zeros((b * t, h + kh - 1, w + kw - 1, cin))
    for dy in range(kh):
        for dxx in range(kw):
            dx[:, dy:dy + h, dxx:dxx + w] += col[:, :, :, dy, dxx]
    dx = dx[:, kh // 2:kh // 2 + h, kw // 2:kw // 2 + w].reshape(x.shape)
    return dx.to(x.dtype), dwx, dbx, dwh


def _check_shapes(x_shape, wx_shape, bx_shape, wh_shape):
    x_shape, wx_shape, bx_shape, wh_shape = map(
        tuple, (x_shape, wx_shape, bx_shape, wh_shape))
    if len(x_shape) != 5:
        raise ValueError(f'ConvLSTM x must be [B, T, H, W, Cin], got '
                         f'{x_shape}')
    cin = x_shape[-1]
    kh, kw, f4 = wx_shape[0], wx_shape[1], wx_shape[-1]
    f = f4 // 4
    if (len(wx_shape) != 4 or wx_shape[2] != cin or f4 != 4 * f or f == 0
            or wh_shape != (kh, kw, f, f4) or bx_shape != (f4,)):
        raise ValueError(
            f'ConvLSTM weights do not match x [.., {cin}]: wx {wx_shape}, '
            f'bx {bx_shape}, wh {wh_shape}')
    if kh % 2 == 0 or kw % 2 == 0:
        raise NotImplementedError(
            f'even ConvLSTM kernel {kh}x{kw}: SAME padding would be '
            f'asymmetric')


def _check_kernels(x, wx, bx, wh):
    """Check a call's shapes; returns its member count M (1 for one
    layer's weights, M for weights stacked [M, ...], whose x holds M
    members of x.shape[0] / M samples)."""
    if wx.dim() != 5:
        _check_shapes(x.shape, wx.shape, bx.shape, wh.shape)
        return 1
    m = wx.shape[0]
    if bx.dim() != 2 or wh.dim() != 5 or bx.shape[0] != m or wh.shape[0] != m:
        raise ValueError(f'ConvLSTM member stacks differ: wx '
                         f'{tuple(wx.shape)}, bx {tuple(bx.shape)}, wh '
                         f'{tuple(wh.shape)}')
    _check_shapes(x.shape, wx.shape[1:], bx.shape[1:], wh.shape[1:])
    if m == 0 or x.shape[0] % m:
        raise ValueError(f'ConvLSTM member mode: batch {x.shape[0]} does not '
                         f'divide over {m} members')
    return m


# The backward's route table, from one layer's whole backward timed by each
# route on an NVIDIA H100 80GB HBM3 at 700 W (batch 128, T 4, 16x16, F in
# {8, 16, 32, 64}, Cin in {1, F}, 3x3 and 5x5; tools/torch_convlstm_route.py,
# PERF.md): 'fused' wins every layer up to F = 32 (by 12-48%), 'split' the
# 3x3 layers at F = 64 (by 13-15%) and 1 -> 64 at 5x5 (by 4%); at 64 -> 64
# 5x5 'fused' was 2% ahead, a tie that a rule on F alone leaves to 'split'.
# bfloat16 (itemsize 2) has its own row, from the same table in bfloat16
# (`tools/torch_convlstm_route.py --dtype bf16`, PERF.md): 'split' takes
# 37-166% longer than 'fused' up to F = 32 and 1-26% longer at 64 -> 64
# (K3's bfloat16 weight pass beats the tail's bfloat16 GEMMs), 9-11% less
# only at 1 -> 64, where the tail's GEMM over Cin = 1 beats a weight pass
# of one source channel; so from F = 64 on bfloat16 splits only a layer
# narrower in than out.
_SPLIT_MIN_F = 64


def dispatch_info(x_shape, wx_shape, wh_shape, itemsize=4):
    """The backward route of a ConvLSTM layer, as a dict: the function
    `_FusedConvLSTM.backward` routes on (the port's counterpart of
    `dispatch_info`, dl4ds_tpu/ops/pallas_convlstm.py:873, whose VMEM
    budgets and lane padding are TPU facts). A pure function of the shapes
    and the element size (4 float32, 2 bfloat16; the JAX dispatch takes it
    too, :1044), from H100 measurements.

    In bfloat16 a layer from F = 64 on splits only when Cin < F.

    Returns {'path': 'fused' | 'split', 'reason': str}. 'fused' is K2's
    training variant forward and K3 backward; 'split' the same forward and
    K4 (the sequential chain) followed by `convlstm_backward_tail` (float32
    GEMMs); both run the same chain-step kernel. Even or mismatched
    kernels raise, as the kernels do."""
    _check_shapes(x_shape, wx_shape, (tuple(wx_shape)[-1],), wh_shape)
    if itemsize not in (4, 2):
        raise ValueError(f'ConvLSTM route: itemsize {itemsize} is not a '
                         f'ported dtype (4 float32, 2 bfloat16)')
    f = wh_shape[2]
    if f < _SPLIT_MIN_F:
        return {'path': 'fused',
                'reason': f'F {f} < {_SPLIT_MIN_F}: K3 is faster (measured)'}
    if itemsize == 2 and x_shape[-1] >= f:
        return {'path': 'fused',
                'reason': f'bfloat16, Cin {x_shape[-1]} >= F {f}: K3 is '
                          f'faster (measured)'}
    return {'path': 'split',
            'reason': f'F {f} >= {_SPLIT_MIN_F}: K4 and the GEMM tail are '
                      f'faster (measured)'}


def _fwd_lib():
    lib = _build.load('convlstm')
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {'dl4ds_convlstm_input': [i] + [p] * 6 + [i] * 15 + [p],
                'dl4ds_convlstm_step': [i] + [p] * 4 + [i] * 15 + [p]}
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('convlstm_bwd')
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    argtypes = {'dl4ds_convlstm_wgrad': [i] + [p] * 3 + [i] * 17 + [p],
                'dl4ds_convlstm_wgrad_reduce': [i, p, i, i64, p, p, i, i64, p,
                                                i, p]}
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _seq_lib():
    lib = _build.load('convlstm_seq')
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {'dl4ds_convlstm_seq_step': [i] + [p] * 6 + [i] * 14 + [p],
                'dl4ds_convlstm_split_step': [i] + [p] * 6 + [i] * 14 + [p],
                'dl4ds_convlstm_dx': [i] + [p] * 3 + [i] * 13 + [p]}
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


_K2_TILE_W = 32               # the widest K2 pixel tile
_K2_SMEM_BUDGET = 110 * 1024  # shared memory of a K2 block: two share an SM


def _kstep(elem):
    """k rows of one tensor-core k-step: 8 (TF32 m16n8k8, float32) or 16
    (bfloat16 m16n8k16)."""
    return 16 if elem == 2 else 8


def _k2_smem(fs, th, tw, kh, kw, cw, rps, elem=4):
    """Shared memory bytes of a K2 block (`smem_bytes` in
    `csrc/convlstm.cu`): two input tiles with their halo, 12 elements a
    pixel; two stages of weight rows (rps tap rows x kw taps x cw channels,
    padded to a k-step) of 4*fs gate channels at a row stride of 4*fs + 8;
    two k-offset tables of ints. elem: bytes an element (4, 2)."""
    kp = -(-rps * kw * cw // _kstep(elem)) * _kstep(elem)
    return (elem * (2 * (th + kh - 1) * (tw + kw - 1) * 12
                    + 2 * kp * (4 * fs + 8)) + 4 * 2 * kp)


def _fwd_plan(b, t, h, w, kh, kw, f, n_sm, elem=4):
    """K2's launch plan, a pure function of the layer's shape.

    A block (8 warps, each 2 runs of 16 pixels x the four gates of 8
    channels) computes all four gates of fs output channels for a th x tw
    pixel tile of one frame: 256 pixels at fs 8, 128 at fs 16. fs is 16
    when F > 8 and a step launch at 16 keeps every SM busy, else 8. tw =
    min(W, 32), th = min(pixels // tw, H): a 16x16 frame is one tile at fs
    8 and two at fs 16, with no idle lane. The K loop stages cw (8 or 4)
    source channels and rps (kh or 1) tap rows at a time: the largest stage
    whose double buffers fit `_K2_SMEM_BUDGET`, tried in the order (8, kh),
    (4, kh), (8, 1).

    The input launch's grid is (B*T*tiles, slices), a step launch's
    (B*tiles, slices); block x of frame (or sample) x // tiles covers tile
    x % tiles, at rows (tile // tiles_x) * th and columns (tile % tiles_x)
    * tw. Warp k takes the 8-channel sub-slice k % (fs // 8) and the
    pixels from (k // (fs // 8)) * 32 (`csrc/convlstm.cu`). elem is the
    element size (4 float32, 2 bfloat16): a bfloat16 block stages 2-byte
    elements and pads a stage's k rows to 16, the m16n8k16 k-step
    (`kstep`)."""
    def cdiv(a, d):
        return -(-a // d)

    def geometry(fs):
        tw = min(w, _K2_TILE_W)
        th = max(1, min((256 if fs == 8 else 128) // tw, h))
        tiles_x = cdiv(w, tw)
        return th, tw, tiles_x, tiles_x * cdiv(h, th)

    fs = 16 if f > 8 and b * geometry(16)[3] * cdiv(f, 16) >= n_sm else 8
    th, tw, tiles_x, tiles = geometry(fs)
    for cw, rps in ((8, kh), (4, kh), (8, 1)):
        smem = _k2_smem(fs, th, tw, kh, kw, cw, rps, elem)
        if smem <= _K2_SMEM_BUDGET:
            break
    return {'fs': fs, 'th': th, 'tw': tw, 'tiles_x': tiles_x,
            'tiles': tiles, 'slices': cdiv(f, fs), 'cw': cw, 'rps': rps,
            'smem': smem, 'input_grid': (b * t * tiles, cdiv(f, fs)),
            'step_grid': (b * tiles, cdiv(f, fs)),
            'warps': (64 // fs, fs // 8), 'm_tiles': 2,
            'kstep': _kstep(elem)}


_SEQ_TILE = 128               # pixels of a chain-step or dx block
_SEQ_SMEM_BUDGET = 110 * 1024  # shared memory of such a block: two share an SM


def _seq_smem(ns, th, tw, kh, kw, cw, rps, elem=4):
    """Shared memory bytes of a chain-step or dx block (`smem_bytes` in
    `csrc/convlstm_seq.cu`): two dz tiles with their halo, 12 elements a
    pixel; two stages of weight rows (rps tap rows x kw taps x cw channels,
    padded to a k-step) of ns output channels at a row stride of max(24, ns
    + 8); two k-offset tables of ints; at least the epilogue's th*tw rows of
    ns + 8 float32 sums. elem: bytes an element (4, 2)."""
    kp = -(-rps * kw * cw // _kstep(elem)) * _kstep(elem)
    return max(elem * (2 * (th + kh - 1) * (tw + kw - 1) * 12
                       + 2 * kp * max(24, ns + 8)) + 4 * 2 * kp,
               4 * th * tw * (ns + 8))


def _seq_plan(b, h, w, kh, kw, f, n_sm, elem=4):
    """Launch plan of the chain-step tile (K4, and K3's chain and dx), a
    pure function of the shapes: b frames (samples for a chain step, B*T
    frames for dx), f output channels (F, or Cin for dx), 4F dz channels.

    A block (8 warps) computes a th x tw pixel tile of one frame, tw =
    min(W, 32), th = min(128 // tw, H) (a 16x16 frame is two whole tiles,
    no idle lane), for ns output channels: the power of two from 8 to 64
    that covers f, halved while the launch would leave an SM without a
    block. At ns 64 the warps are 4 (pixels) x 2 (channels), each 2 m16
    pixel runs x 4 n8 channel tiles; below, 8 x 1, each one m16 run x ns/8
    tiles. The K loop stages cw (8 or 4) dz channels and rps (kh or 1) tap
    rows at a time: the largest stage whose double buffers fit
    `_SEQ_SMEM_BUDGET`, tried in the order (8, kh), (4, kh), (8, 1).

    The grid is (b*tiles, slices); block x covers tile x % tiles of frame
    x // tiles, at rows (tile // tiles_x) * th and columns (tile % tiles_x)
    * tw (`csrc/convlstm_seq.cu`). elem as `_fwd_plan`'s."""
    def cdiv(a, d):
        return -(-a // d)

    tw = min(w, 32)
    th = max(1, min(_SEQ_TILE // tw, h))
    tiles_x = cdiv(w, tw)
    tiles = tiles_x * cdiv(h, th)
    ns = 8
    while ns < min(f, 64):
        ns *= 2
    while ns > 8 and b * tiles * cdiv(f, ns) < n_sm:
        ns //= 2
    for cw, rps in ((8, kh), (4, kh), (8, 1)):
        smem = _seq_smem(ns, th, tw, kh, kw, cw, rps, elem)
        if smem <= _SEQ_SMEM_BUDGET:
            break
    warps_n = 2 if ns == 64 else 1
    return {'ns': ns, 'th': th, 'tw': tw, 'tiles_x': tiles_x,
            'tiles': tiles, 'slices': cdiv(f, ns), 'cw': cw, 'rps': rps,
            'smem': smem, 'grid': (b * tiles, cdiv(f, ns)),
            'warps': (8 // warps_n, warps_n), 'm_tiles': 2 if ns == 64 else 1,
            'n_tiles': ns // 8 // warps_n, 'kstep': _kstep(elem)}


def _wgrad_plan(b, t, t_skip, h, w, cs, f, kh, kw, n_sm):
    """Launch plan of K3's weight-gradient pass over the frames t_skip ..
    T-1 of every sample, a split-K GEMM of rows (tap, source channel) by
    4F gate columns over the pixels (`csrc/convlstm_bwd.cu`).

    Pixel tiles of tph x tpw, at most 256 pixels of one frame (tpw =
    min(W, 32)); a block sums `tpb` consecutive tiles, so that the blocks
    of the pass make about one wave of two blocks an SM. A block row is cwc
    source channels (min(C, 8), or min(C, 4) when kh*kw*8 rows would pass
    255) of up to tpc taps (at most 255 rows; the Wx pass's first chunk
    adds a row of ones for db) and 32 gate columns; grid.y counts those
    chunks. (The kernel gives each warp 2 m16 row tiles and lets the warps
    the rows leave over split the k-steps; a k-step takes 8 pixels of a
    tile in float32 and 16 in bfloat16, the kernel padding the tile's
    pixels to it.) The same plan for both dtypes. Returns a dict; n_chunks
    is the number of partial rows (grid.x)."""
    def cdiv(a, d):
        return -(-a // d)

    tpw = min(w, 32)
    tph = min(h, max(1, 256 // tpw))
    n_tiles = b * (t - t_skip) * cdiv(w, tpw) * cdiv(h, tph)
    taps = kh * kw
    cwc = min(cs, 8) if taps * min(cs, 8) <= 255 else min(cs, 4)
    tpc = min(taps, 255 // cwc)
    grid_y = cdiv(cs, cwc) * cdiv(taps, tpc) * cdiv(4 * f, 32)
    tpb = max(1, cdiv(n_tiles * grid_y, 2 * n_sm))
    return {'tph': tph, 'tpw': tpw, 'tpb': tpb, 'n_chunks': cdiv(n_tiles, tpb),
            'cwc': cwc, 'tpc': tpc, 'grid_y': grid_y}


# the kernels' element-type codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda(tensors, what):
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODES or any(u.dtype != dt for u in tensors):
        raise TypeError(
            f'the ConvLSTM {what} takes float32 or bfloat16, one dtype for '
            f'every tensor, got {[str(u.dtype) for u in tensors]}; other '
            f'model dtypes are not ported yet (ROADMAP.md queue 1, item 5)')
    dev = tensors[0].device
    if dev.type != 'cuda' or any(u.device != dev for u in tensors):
        raise ValueError(f'the ConvLSTM {what} needs every tensor on one CUDA '
                         f'device, got {[str(u.device) for u in tensors]}')
    return dev


def _aligned(u):
    """Contiguous, with a 16-byte aligned start (the kernels read float4).
    Weights are made contiguous too: a module moved with memory_format=
    channels_last holds the 4-D HWIO kernels with permuted strides."""
    u = u.contiguous()
    return u.clone() if u.data_ptr() % 16 else u


def _launch(x, wx, bx, wh, train=False):
    """Run K2 over the whole window: the input launch (the input conv over
    all B*T frames, and step 0's gates), then one launch per time step 1 ..
    T-1, on the current stream. Returns ys [B, T, H, W, F]; with train=True
    the training variant, which returns (ys, cs, zs) with the residuals cs
    [B, T, H, W, F] and zs [B, T, H, W, 4F]. Weights stacked [M, ...]: the
    member mode, planned from a member's B / M samples."""
    tensors = (x, wx, bx, wh)
    dev = _check_cuda(tensors, 'forward kernel')
    members = _check_kernels(x, wx, bx, wh)
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape[-4:]
    f = f4 // 4
    if b * t * h * w == 0:
        raise ValueError(f'ConvLSTM kernel got an empty x {tuple(x.shape)}')
    x, wx, bx, wh = (_aligned(u) for u in tensors)
    per = b // members
    plan = _fwd_plan(per, t, h, w, kh, kw, f, _n_sm(dev), x.element_size())
    if plan['input_grid'][0] * members >= 2 ** 31:
        raise ValueError(f'ConvLSTM kernel got too many pixel tiles for one '
                         f'launch: x {tuple(x.shape)}')
    empty = lambda *s: torch.empty(s, dtype=x.dtype, device=dev)  # noqa: E731
    ys = empty(b, t, h, w, f)
    zx = empty(b, t, h, w, f4)        # zs in training, a scratch in inference
    c = empty(b, t, h, w, f) if train else empty(b, h, w, f)
    code = _DTYPE_CODES[x.dtype]
    geometry = (kh, kw) + tuple(plan[k] for k in ('fs', 'th', 'tw', 'cw',
                                                  'rps')) + (int(train),)
    lib = _fwd_lib()

    def check(err, what):
        if err != 0:
            raise RuntimeError(f'ConvLSTM kernel launch failed with CUDA '
                               f'error {err} ({what})')
        if train:
            fused_convlstm.train_launches += 1
        else:
            fused_convlstm.launches += 1

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib.dl4ds_convlstm_input(
            code, x.data_ptr(), wx.data_ptr(), bx.data_ptr(), zx.data_ptr(),
            ys.data_ptr(), c.data_ptr(), b, t, h, w, cin, f, *geometry, per,
            stream), 'input conv and step 0')
        for step in range(1, t):
            check(lib.dl4ds_convlstm_step(
                code, wh.data_ptr(), zx.data_ptr(), ys.data_ptr(), c.data_ptr(), b,
                t, step, h, w, f, *geometry, per, stream), f'step {step}')
    return (ys, c, zx) if train else ys


def _flip_t(w):
    """wT [kh, kw, Co, C] from an HWIO kernel w [kh, kw, C, Co]: flipped in
    both spatial axes, channel axes swapped, so that convT(dz, w) is a SAME
    conv of dz with wT; a member stack [M, kh, kw, C, Co] member by
    member."""
    return w.flip(-4, -3).transpose(-2, -1).contiguous()


def _chain(zs, cs, dys, wh, count):
    """Run the chain-step kernel T times in reverse on the current stream,
    adding one to `fused_convlstm.<count>` a launch: K3's chain
    ('bwd_launches') or K4's ('seq_launches'), the same tile under two
    kernel names. Returns dzs [B, T, H, W, 4F]. wh stacked [M, ...]: the
    member mode, planned from a member's B / M samples."""
    b, t, h, w, f4 = zs.shape
    kh, kw, f, _ = wh.shape[-4:]
    members = wh.shape[0] if wh.dim() == 5 else 1
    per = b // members
    dev = zs.device
    plan = _seq_plan(per, h, w, kh, kw, f, _n_sm(dev), zs.element_size())
    geometry = tuple(plan[k] for k in ('ns', 'th', 'tw', 'cw', 'rps'))
    wht = _flip_t(wh)
    dzs = torch.empty_like(zs)
    dcs = torch.empty((b, h, w, f), dtype=zs.dtype, device=dev)
    lib = _seq_lib()
    fn = (lib.dl4ds_convlstm_split_step if count == 'seq_launches'
          else lib.dl4ds_convlstm_seq_step)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for step in reversed(range(t)):
        err = fn(_DTYPE_CODES[zs.dtype], zs.data_ptr(), cs.data_ptr(),
                 dys.data_ptr(), wht.data_ptr(),
                 dzs.data_ptr(), dcs.data_ptr(), b, t, step, h, w, f, kh, kw,
                 *geometry, per, stream)
        if err != 0:
            raise RuntimeError(f'ConvLSTM chain-step kernel launch failed '
                               f'with CUDA error {err} (step {step})')
        setattr(fused_convlstm, count, getattr(fused_convlstm, count) + 1)
    return dzs


def _n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch_backward(x, wx, wh, zs, cs, ys, dys, need_dx=True):
    """Run K3: the T reverse chain steps, dx over all frames (when need_dx),
    the Wx (with db) and Wh weight-gradient passes and the one reduction of
    their partials. Returns (dx or None, dwx, dbx, dwh). Weights stacked
    [M, ...]: the member mode, every launch planned from a member's B / M
    samples, the gradients [M, ...]."""
    tensors = (x, wx, wh, zs, cs, ys, dys)
    dev = _check_cuda(tensors, 'backward kernel')
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape[-4:]
    f = f4 // 4
    members = wx.shape[0] if wx.dim() == 5 else 1
    if wh.dim() != wx.dim() or members == 0 or b % members:
        raise ValueError(f'ConvLSTM backward kernel: weights wx '
                         f'{tuple(wx.shape)}, wh {tuple(wh.shape)} for a '
                         f'batch of {b}')
    if (tuple(zs.shape) != (b, t, h, w, f4)
            or any(tuple(u.shape) != (b, t, h, w, f) for u in (cs, ys, dys))):
        raise ValueError(
            f'ConvLSTM residuals do not match x {tuple(x.shape)} and F={f}: '
            f'zs {tuple(zs.shape)}, cs {tuple(cs.shape)}, ys '
            f'{tuple(ys.shape)}, dys {tuple(dys.shape)}')
    if b * t * h * w == 0:
        raise ValueError(f'ConvLSTM backward kernel got an empty x '
                         f'{tuple(x.shape)}')
    x, wx, wh, zs, cs, ys, dys = (_aligned(u) for u in tensors)
    n_sm = _n_sm(dev)
    lib = _bwd_lib()
    code = _DTYPE_CODES[x.dtype]
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    lx = kh * kw * cin * f4
    per = b // members
    plan_x = _wgrad_plan(per, t, 0, h, w, cin, f, kh, kw, n_sm)
    plan_h = _wgrad_plan(per, t, 1, h, w, f, f, kh, kw, n_sm) if t > 1 else None
    part_x = empty(members * plan_x['n_chunks'], lx + f4)
    part_h = (empty(members * plan_h['n_chunks'], kh * kw * f * f4) if t > 1
              else empty(0))
    # the reduction writes the sums in x's dtype, each rounded once
    out_x = torch.empty((members, lx + f4), dtype=x.dtype, device=dev)
    dwh = torch.empty((members, kh, kw, f, f4), dtype=x.dtype, device=dev)

    def check(err, what):
        if err != 0:
            raise RuntimeError(f'ConvLSTM backward kernel launch failed with '
                               f'CUDA error {err} ({what})')
        fused_convlstm.bwd_launches += 1

    def wgrad(src, part, plan, with_db, t_skip, cs_):
        check(lib.dl4ds_convlstm_wgrad(
            code, src.data_ptr(), dzs.data_ptr(), part.data_ptr(),
            plan['n_chunks'],
            with_db, per, t, t_skip, h, w, cs_, f, kh, kw,
            *(plan[k] for k in ('tph', 'tpw', 'tpb', 'cwc', 'tpc')), members,
            stream), 'dWx' if with_db else 'dWh')

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        dzs = _chain(zs, cs, dys, wh, 'bwd_launches')
        dx = None
        if need_dx:
            dx = torch.empty((b, t, h, w, cin), dtype=x.dtype, device=dev)
            plan = _seq_plan(per * t, h, w, kh, kw, cin, n_sm,
                             x.element_size())
            wxt = _flip_t(wx)
            check(_seq_lib().dl4ds_convlstm_dx(
                code, dzs.data_ptr(), wxt.data_ptr(), dx.data_ptr(), b * t, h, w,
                cin, f, kh, kw,
                *(plan[k] for k in ('ns', 'th', 'tw', 'cw', 'rps')), per * t,
                stream), 'dx')
        wgrad(x, part_x, plan_x, 1, 0, cin)
        if plan_h is not None:
            wgrad(ys, part_h, plan_h, 0, 1, f)
        check(lib.dl4ds_convlstm_wgrad_reduce(
            code, part_x.data_ptr(), plan_x['n_chunks'], lx + f4,
            out_x.data_ptr(), part_h.data_ptr(),
            plan_h['n_chunks'] if t > 1 else 0, dwh[0].numel(),
            dwh.data_ptr(), members, stream), 'reduce')
    dwx = out_x[:, :lx].view(members, kh, kw, cin, f4)
    if wx.dim() == 5:
        return dx, dwx, out_x[:, lx:], dwh
    return dx, dwx[0], out_x[0, lx:], dwh[0]


def _launch_seq(zs, cs, dys, wh):
    """Run K4, the sequential chain: T step launches in reverse on the
    current stream. Returns dzs [B, T, H, W, 4F]. wh stacked [M, ...]: the
    member mode."""
    tensors = (zs, cs, dys, wh)
    dev = _check_cuda(tensors, 'sequential BPTT kernel')
    b, t, h, w, f4 = zs.shape
    kh, kw, f, _ = wh.shape[-4:]
    members = wh.shape[0] if wh.dim() == 5 else 1
    if (wh.dim() not in (4, 5) or f4 != 4 * f
            or tuple(wh.shape[-1:]) != (f4,) or members == 0
            or b % members
            or any(tuple(u.shape) != (b, t, h, w, f) for u in (cs, dys))):
        raise ValueError(
            f'ConvLSTM residuals do not match wh {tuple(wh.shape)}: zs '
            f'{tuple(zs.shape)}, cs {tuple(cs.shape)}, dys {tuple(dys.shape)}')
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f'the sequential BPTT kernel takes odd kernels, got '
                         f'{kh}x{kw}')
    if b * t * h * w == 0:
        raise ValueError(f'the sequential BPTT kernel got an empty zs '
                         f'{tuple(zs.shape)}')
    zs, cs, dys, wh = (_aligned(u) for u in tensors)
    with torch.cuda.device(dev):
        return _chain(zs, cs, dys, wh, 'seq_launches')


def _backward(route, x, wx, wh, zs, cs, ys, dys, need_dx=True):
    """The layer's BPTT by `route` ('fused' or 'split'): the kernels on CUDA
    tensors, their plain versions on CPU tensors, for one layer's weights
    or a member stack. Returns (dx, dwx, dbx, dwh); dx may be None when not
    need_dx."""
    if route not in ('fused', 'split'):
        raise ValueError(f"ConvLSTM backward route must be 'fused' or "
                         f"'split', got {route!r}")
    cuda = x.device.type == 'cuda'
    if route == 'fused':
        if cuda:
            return _launch_backward(x, wx, wh, zs, cs, ys, dys, need_dx)
        return convlstm_backward_reference(x, wx, wh, zs, cs, ys, dys)
    dzs = (_launch_seq if cuda else convlstm_seq_reference)(zs, cs, dys, wh)
    return convlstm_backward_tail(x, wx, wh, ys, dzs, need_dx)


def _route(x, wx, wh):
    """`dispatch_info`'s route of a layer (a member's, for stacked
    weights); a float64 run (the CPU reference of a float32 one) routes as
    float32."""
    itemsize = 2 if x.dtype == torch.bfloat16 else 4
    return dispatch_info(x.shape, wx.shape[-4:], wh.shape[-4:],
                         itemsize)['path']


# the layer's weights (wx, bx, wh) by operand index, with their dims an
# instance
_LAYER_WEIGHTS = {1: 4, 2: 1, 3: 4}


def _layer_vmap(layer, info, in_dims, *args):
    """The `vmap` rule of the layer's forward `layer` (the operator, or
    `_FusedConvLSTM.apply` with its route) on (x, wx, bx, wh[, route]):
    `member_vmap`'s, x and the outputs per sample."""
    return member_vmap(layer, info, in_dims, args, (0,), _LAYER_WEIGHTS,
                       'ConvLSTM layer')


class _FusedConvLSTM(torch.autograd.Function):
    """The layer with its BPTT backward: forward (ys, cs, zs), on CUDA
    tensors K2's training variant, on CPU tensors its plain version; the
    residuals cs and zs are outputs, marked non-differentiable, that the
    backward takes with x, the weights and ys (outputs, not saved
    intermediates, as torch.func needs them). The backward is
    `_ConvLSTMBackward`, by `dispatch_info`'s route or the forced `route`
    (tests, the chip checks). Weights stacked [M, ...]: the member mode.

    Under `torch.func.vmap` the `vmap` rule flattens the mapped axis into
    the batch: with mapped weights (an ensemble's members) the member mode,
    else one call on the flattened batch. `_ConvLSTMBackward` has a `vmap`
    rule of its own (under `vmap(grad(...))` the backward meets batched
    tensors), which always runs the member mode, so that each mapped
    instance gets its own weight gradients."""

    @staticmethod
    def forward(x, wx, bx, wh, route=None):
        with kernel_flops(lambda: convlstm_flops(x.shape, wx.shape)):
            if x.device.type == 'cuda':
                return _launch(x, wx, bx, wh, train=True)
            if x.device.type == 'cpu':
                return convlstm_train_reference(x, wx, bx, wh)
        raise ValueError(f'unsupported device {x.device}')

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, wx, bx, wh, route = inputs
        ys, cs, zs = output
        ctx.mark_non_differentiable(cs, zs)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, wx, wh, zs, cs, ys)
        ctx.route = route

    @staticmethod
    def backward(ctx, dys, _dcs, _dzs):
        x, wx, wh, zs, cs, ys = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        grads = _ConvLSTMBackward.apply(x, wx, wh, zs, cs, ys, dys,
                                        ctx.route or _route(x, wx, wh),
                                        need_dx)
        return (grads[3] if need_dx else None,) + grads[:3] + (None,)

    @staticmethod
    def vmap(info, in_dims, *args):
        return _layer_vmap(_FusedConvLSTM.apply, info, in_dims, *args)


class FusedConvLSTM:
    """The layer as an autograd function of (x, wx, bx, wh, route=None)
    that returns ys: `_FusedConvLSTM`, which also returns the residuals
    that its backward takes. `_backward_cls` is the class of the gradient
    node that it records on ys."""

    _backward_cls = _FusedConvLSTM._backward_cls

    @staticmethod
    def apply(x, wx, bx, wh, route=None):
        return _FusedConvLSTM.apply(x, wx, bx, wh, route)[0]


class _ConvLSTMBackward(torch.autograd.Function):
    """The layer's BPTT as a Function of its own: (dwx, dbx, dwh) and, when
    `need_dx`, dx, from x, the weights, the forward's zs, cs and ys and dys,
    by `route` (`_backward`: K3, or K4 and the GEMM tail, on the GPU; the
    plain versions on the CPU). Its `vmap` rule flattens the mapped axis
    into the batch and runs the member mode with the weights expanded to
    the mapped size, so that each instance's weight gradients are its own.
    It is not differentiable again."""

    @staticmethod
    def forward(x, wx, wh, zs, cs, ys, dys, route, need_dx):
        with kernel_flops(lambda: convlstm_flops(x.shape, wx.shape, True,
                                                 need_dx)):
            dx, dwx, dbx, dwh = _backward(route, x, wx, wh, zs, cs, ys,
                                          dys.contiguous(), need_dx=need_dx)
        return (dwx, dbx, dwh) + ((dx,) if need_dx else ())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError('the ConvLSTM layer is differentiable once')

    @staticmethod
    def vmap(info, in_dims, *args):
        return member_vmap(_ConvLSTMBackward.apply, info, in_dims, args,
                           (0, 3, 4, 5, 6), {1: 4, 2: 4}, 'ConvLSTM layer',
                           members=True, out_per_sample=(3,))


@torch.library.custom_op('dl4ds_tpu_torch::convlstm', mutates_args=())
def _convlstm_op(x: torch.Tensor, wx: torch.Tensor, bx: torch.Tensor,
                 wh: torch.Tensor) -> torch.Tensor:
    """K2's inference variant as the operator `dl4ds_tpu_torch::convlstm`:
    ys [B, T, H, W, F] in x's dtype from x [B, T, H, W, Cin] (weights
    stacked [M, ...]: the member mode). Its CUDA kernel is `_launch`, its
    CPU kernel `convlstm_reference`, and its fake kernel gives the shape
    alone, so that `torch.export` traces a model through it and freezes the
    node, not the launches. Its `vmap` rule (`predict_ensemble`) is
    `_layer_vmap`'s."""
    raise ValueError(f'unsupported device {x.device}')


@_convlstm_op.register_kernel('cuda')
def _(x, wx, bx, wh):
    return _launch(x, wx, bx, wh)


@_convlstm_op.register_kernel('cpu')
def _(x, wx, bx, wh):
    return convlstm_reference(x, wx, bx, wh)[0]


@_convlstm_op.register_fake
def _(x, wx, bx, wh):
    return x.new_empty((*x.shape[:4], wx.shape[-1] // 4))


_convlstm_op.register_vmap(
    lambda info, in_dims, *args: _layer_vmap(_convlstm_op, info, in_dims,
                                             *args))


@register_flop_formula(torch.ops.dl4ds_tpu_torch.convlstm)
def _(x_shape, wx_shape, *args, out_shape=None, **kwargs):
    return convlstm_flops(x_shape, wx_shape)


def fused_convlstm(x, wx, bx, wh):
    """Whole ConvLSTM layer forward: ys [B, T, H, W, F] from x
    [B, T, H, W, Cin] (h and c start at zero; weights stacked [M, ...]:
    the member mode).

    With grad mode on, `FusedConvLSTM` (differentiable, under torch.func's
    transforms too, where an input's `requires_grad` does not show whether
    a transform differentiates it; on CUDA K2's training variant, and K3 or
    K4 with the GEMM tail as `dispatch_info` routes the layer). With grad
    mode off the operator `dl4ds_tpu_torch::convlstm`, which `torch.export`
    freezes as one node: on CUDA tensors K2's inference variant, float32 or
    bfloat16; on CPU tensors `convlstm_reference`.
    `fused_convlstm.launches` counts K2 inference launches (T a layer: the
    input launch and T-1 steps), `.train_launches` K2 training launches,
    `.bwd_launches` K3 launches and `.seq_launches` K4 launches; the CPU
    path launches nothing."""
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {x.device}')
    if torch.is_grad_enabled():
        return FusedConvLSTM.apply(x, wx, bx, wh)
    return _convlstm_op(x, wx, bx, wh)


fused_convlstm.launches = 0
fused_convlstm.train_launches = 0
fused_convlstm.bwd_launches = 0
fused_convlstm.seq_launches = 0
