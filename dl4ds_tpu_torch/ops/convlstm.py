"""
Fused ConvLSTM layer (K2 forward; K3, or K4 and a GEMM tail, backward), the
counterpart of `dl4ds_tpu/ops/pallas_convlstm.py`'s `fused_convlstm`.

On CUDA tensors `fused_convlstm` launches the hand-written Hopper kernels:
without a gradient to take, K2's inference variant (`csrc/convlstm.cu`: the
input conv over all frames with step 0's gates, then one launch per later
time step, T launches a layer; 3xTF32 tensor-core products); with one (grad
mode on and an input that requires grad), `FusedConvLSTM`, whose forward is
K2's training variant (the same launches, also writing the `cs` and `zs`
residuals). Its backward takes
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
kernels or raises.

Weights keep the JAX layout: wx [kh, kw, Cin, 4F] (HWIO), bx [4F],
wh [kh, kw, F, 4F], gates split along 4F in the order i, f, c, o.
Activations are [B, T, H, W, C]; the residuals are zs [B, T, H, W, 4F]
(the pre-activations, gate-major along the last axis) and cs [B, T, H, W, F].
"""

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ['fused_convlstm', 'convlstm_reference', 'convlstm_train_reference',
           'convlstm_backward_reference', 'convlstm_seq_reference',
           'convlstm_backward_tail', 'dispatch_info', 'FusedConvLSTM',
           'hard_sigmoid', 'd_hard_sigmoid']


def hard_sigmoid(x):
    """Keras hard_sigmoid, clip(0.2 x + 0.5, 0, 1): the ConvLSTM gate
    (not `F.hardsigmoid`, which is clip(x / 6 + 0.5, 0, 1))."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


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
    (odd sizes); NHWC out."""
    kh, kw = w.shape[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def _conv_same_t(dz, w):
    """The adjoint of `_conv_same` in its input: dz [N, H, W, Co] -> [N, H,
    W, C] for the HWIO kernel w [kh, kw, C, Co]."""
    kh, kw = w.shape[:2]
    y = F.conv_transpose2d(dz.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                           padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def _conv_same_w(src, dz, w_shape):
    """The adjoint of `_conv_same` in its kernel: sum over the frames of
    src [N, H, W, C] and dz [N, H, W, Co] -> HWIO [kh, kw, C, Co]."""
    kh, kw, c, co = w_shape
    g = torch.nn.grad.conv2d_weight(
        src.permute(0, 3, 1, 2), (co, c, kh, kw), dz.permute(0, 3, 1, 2),
        padding=(kh // 2, kw // 2))
    return g.permute(2, 3, 1, 0)


def convlstm_train_reference(x, wx, bx, wh):
    """Plain PyTorch whole layer with the backward's residuals (the input
    conv over all B*T frames at once, then the recurrent conv, gates and
    state updates step by step, as `convlstm_reference` and `_fwd_kernel`,
    dl4ds_tpu/ops/pallas_convlstm.py:82-112 and :244-263). x: [B, T, H, W,
    Cin]; returns (ys, cs, zs): [B, T, H, W, F] twice and [B, T, H, W, 4F],
    zs the pre-activation of every step, bias and recurrent term
    included."""
    _check_kernels(x, wx, bx, wh)
    b, t, h, w, cin = x.shape
    f = wh.shape[2]
    zx = _conv_same(x.reshape(b * t, h, w, cin), wx) + bx
    zx = zx.reshape(b, t, h, w, 4 * f)
    hh = x.new_zeros((b, h, w, f))
    cc = x.new_zeros((b, h, w, f))
    ys, cs, zs = [], [], []
    for i in range(t):
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


def convlstm_seq_reference(zs, cs, dys, wh):
    """Plain PyTorch sequential half of the BPTT, K4's plain version
    (transcribes `_bwd_seq_kernel`, dl4ds_tpu/ops/pallas_convlstm.py:269-332):
    the reverse dh/dc chain on the saved zs and cs. Returns dzs [B, T, H, W,
    4F], the gradient of every step's pre-activations, gate-major."""
    b, t, h, w, f4 = zs.shape
    f = f4 // 4
    dh_next = dc_next = zero = cs.new_zeros((b, h, w, f))
    dzs = [None] * t
    for i in reversed(range(t)):
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
    wh)."""
    b, t, h, w, cin = x.shape
    f = wh.shape[2]
    dzs = convlstm_seq_reference(zs, cs, dys, wh)
    dz = dzs.reshape(b * t, h, w, 4 * f)
    dx = _conv_same_t(dz, wx).reshape(x.shape)
    dwx = _conv_same_w(x.reshape(b * t, h, w, cin), dz, wx.shape)
    dbx = dz.sum(dim=(0, 1, 2))
    if t > 1:   # h_{-1} = 0: step 0 adds nothing to dWh
        dz_h = dzs[:, 1:].reshape(b * (t - 1), h, w, 4 * f)
        dwh = _conv_same_w(ys[:, :-1].reshape(b * (t - 1), h, w, f), dz_h,
                           wh.shape)
    else:
        dwh = torch.zeros_like(wh)
    return dx, dwx, dbx, dwh


@contextlib.contextmanager
def _fp32_matmuls():
    """Float32 matmuls without TF32 inside, whatever the caller set (with
    PyTorch's newer per-backend flag where it has one: reading the legacy
    `allow_tf32` raises once the new one was set)."""
    m = torch.backends.cuda.matmul
    name, value = (('fp32_precision', 'ieee') if hasattr(m, 'fp32_precision')
                   else ('allow_tf32', False))
    saved = getattr(m, name)
    setattr(m, name, value)
    try:
        yield
    finally:
        setattr(m, name, saved)


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
    (ROADMAP.md section 3). The same code runs on the CPU and on the card.
    Returns (dx or None, dwx, dbx, dwh)."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    dz = dzs.reshape(b * t * h * w, f4)
    with _fp32_matmuls():
        dwx = (_unfold(x.reshape(b * t, h, w, cin), kh, kw).t() @ dz).view(
            wx.shape)
        dbx = dz.sum(dim=0)
        if t > 1:   # h_{-1} = 0: step 0 adds nothing to dWh
            src = _unfold(ys[:, :-1].reshape(b * (t - 1), h, w, f), kh, kw)
            dwh = (src.t() @ dzs[:, 1:].reshape(-1, f4)).view(wh.shape)
            del src
        else:
            dwh = torch.zeros_like(wh)
        if not need_dx:
            return None, dwx, dbx, dwh
        col = (dz @ wx.reshape(kh * kw * cin, f4).t()).view(
            b * t, h, w, kh, kw, cin)
    dx = x.new_zeros((b * t, h + kh - 1, w + kw - 1, cin))
    for dy in range(kh):
        for dxx in range(kw):
            dx[:, dy:dy + h, dxx:dxx + w] += col[:, :, :, dy, dxx]
    dx = dx[:, kh // 2:kh // 2 + h, kw // 2:kw // 2 + w].reshape(x.shape)
    return dx, dwx, dbx, dwh


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
    _check_shapes(x.shape, wx.shape, bx.shape, wh.shape)


# The backward's route table, from one layer's whole backward timed by each
# route on an NVIDIA H100 80GB HBM3 at 700 W (batch 128, T 4, 16x16, F in
# {8, 16, 32, 64}, Cin in {1, F}, 3x3 and 5x5; tools/torch_convlstm_route.py,
# PERF.md): 'fused' wins every layer up to F = 32 (by 12-48%), 'split' the
# 3x3 layers at F = 64 (by 13-15%) and 1 -> 64 at 5x5 (by 4%); at 64 -> 64
# 5x5 'fused' was 2% ahead, a tie that a rule on F alone leaves to 'split'.
_SPLIT_MIN_F = 64


def dispatch_info(x_shape, wx_shape, wh_shape):
    """The backward route of a ConvLSTM layer, as a dict: the function
    `FusedConvLSTM.backward` routes on (the port's counterpart of
    `dispatch_info`, dl4ds_tpu/ops/pallas_convlstm.py:873, whose VMEM
    budgets and lane padding are TPU facts). A pure function of the shapes,
    from H100 measurements.

    Returns {'path': 'fused' | 'split', 'reason': str}. 'fused' is K2's
    training variant forward and K3 backward; 'split' the same forward and
    K4 (the sequential chain) followed by `convlstm_backward_tail` (float32
    GEMMs); both run the same chain-step kernel. Even or mismatched
    kernels raise, as the kernels do."""
    _check_shapes(x_shape, wx_shape, (tuple(wx_shape)[-1],), wh_shape)
    f = wh_shape[2]
    if f < _SPLIT_MIN_F:
        return {'path': 'fused',
                'reason': f'F {f} < {_SPLIT_MIN_F}: K3 is faster (measured)'}
    return {'path': 'split',
            'reason': f'F {f} >= {_SPLIT_MIN_F}: K4 and the GEMM tail are '
                      f'faster (measured)'}


def _fwd_lib():
    lib = _build.load('convlstm')
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {'dl4ds_convlstm_input': [p] * 6 + [i] * 14 + [p],
                'dl4ds_convlstm_step': [p] * 4 + [i] * 14 + [p]}
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _build.load('convlstm_bwd')
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    argtypes = {'dl4ds_convlstm_wgrad': [p] * 3 + [i] * 16 + [p],
                'dl4ds_convlstm_wgrad_reduce': [p, i, i64, p, p, i, i64, p, p]}
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


def _seq_lib():
    lib = _build.load('convlstm_seq')
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = {'dl4ds_convlstm_seq_step': [p] * 6 + [i] * 13 + [p],
                'dl4ds_convlstm_dx': [p] * 3 + [i] * 12 + [p]}
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = types
            fn.restype = ctypes.c_int
    return lib


_K2_TILE_W = 32               # the widest K2 pixel tile
_K2_SMEM_BUDGET = 110 * 1024  # shared memory of a K2 block: two share an SM


def _k2_smem(fs, th, tw, kh, kw, cw, rps):
    """Shared memory bytes of a K2 block (`smem_floats` in
    `csrc/convlstm.cu`): two input tiles with their halo, 12 floats a pixel;
    two stages of weight rows (rps tap rows x kw taps x cw channels, padded
    to 8) of 4*fs gate channels at a row stride of 4*fs + 8; two k-offset
    tables."""
    kp = -(-rps * kw * cw // 8) * 8
    return 4 * (2 * (th + kh - 1) * (tw + kw - 1) * 12
                + 2 * kp * (4 * fs + 8) + 2 * kp)


def _fwd_plan(b, t, h, w, kh, kw, f, n_sm):
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
    pixels from (k // (fs // 8)) * 32 (`csrc/convlstm.cu`)."""
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
        smem = _k2_smem(fs, th, tw, kh, kw, cw, rps)
        if smem <= _K2_SMEM_BUDGET:
            break
    return {'fs': fs, 'th': th, 'tw': tw, 'tiles_x': tiles_x,
            'tiles': tiles, 'slices': cdiv(f, fs), 'cw': cw, 'rps': rps,
            'smem': smem, 'input_grid': (b * t * tiles, cdiv(f, fs)),
            'step_grid': (b * tiles, cdiv(f, fs)),
            'warps': (64 // fs, fs // 8), 'm_tiles': 2}


_SEQ_TILE = 128               # pixels of a chain-step or dx block
_SEQ_SMEM_BUDGET = 110 * 1024  # shared memory of such a block: two share an SM


def _seq_smem(ns, th, tw, kh, kw, cw, rps):
    """Shared memory bytes of a chain-step or dx block (`smem_floats` in
    `csrc/convlstm_seq.cu`): two dz tiles with their halo, 12 floats a
    pixel; two stages of weight rows (rps tap rows x kw taps x cw channels,
    padded to 8) of ns output channels at a row stride of max(24, ns + 8);
    two k-offset tables; at least the epilogue's th*tw rows of ns + 8 sums."""
    kp = -(-rps * kw * cw // 8) * 8
    return 4 * max(2 * (th + kh - 1) * (tw + kw - 1) * 12
                   + 2 * kp * max(24, ns + 8) + 2 * kp, th * tw * (ns + 8))


def _seq_plan(b, h, w, kh, kw, f, n_sm):
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
    * tw (`csrc/convlstm_seq.cu`)."""
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
        smem = _seq_smem(ns, th, tw, kh, kw, cw, rps)
        if smem <= _SEQ_SMEM_BUDGET:
            break
    warps_n = 2 if ns == 64 else 1
    return {'ns': ns, 'th': th, 'tw': tw, 'tiles_x': tiles_x,
            'tiles': tiles, 'slices': cdiv(f, ns), 'cw': cw, 'rps': rps,
            'smem': smem, 'grid': (b * tiles, cdiv(f, ns)),
            'warps': (8 // warps_n, warps_n), 'm_tiles': 2 if ns == 64 else 1,
            'n_tiles': ns // 8 // warps_n}


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
    the rows leave over split the k-steps.)

    Returns a dict; n_chunks is the number of partial rows (grid.x)."""
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


def _check_cuda(tensors, what):
    if any(u.dtype != torch.float32 for u in tensors):
        raise TypeError(
            f'the ConvLSTM {what} takes float32 only, got '
            f'{[str(u.dtype) for u in tensors]}; other model dtypes are not '
            f'ported yet (ROADMAP.md queue 1, item 5)')
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
    [B, T, H, W, F] and zs [B, T, H, W, 4F]."""
    tensors = (x, wx, bx, wh)
    dev = _check_cuda(tensors, 'forward kernel')
    _check_kernels(x, wx, bx, wh)
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    if b * t * h * w == 0:
        raise ValueError(f'ConvLSTM kernel got an empty x {tuple(x.shape)}')
    x, wx, bx, wh = (_aligned(u) for u in tensors)
    plan = _fwd_plan(b, t, h, w, kh, kw, f, _n_sm(dev))
    if plan['input_grid'][0] >= 2 ** 31:
        raise ValueError(f'ConvLSTM kernel got too many pixel tiles for one '
                         f'launch: x {tuple(x.shape)}')
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    ys = empty(b, t, h, w, f)
    zx = empty(b, t, h, w, f4)        # zs in training, a scratch in inference
    c = empty(b, t, h, w, f) if train else empty(b, h, w, f)
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
            x.data_ptr(), wx.data_ptr(), bx.data_ptr(), zx.data_ptr(),
            ys.data_ptr(), c.data_ptr(), b, t, h, w, cin, f, *geometry,
            stream), 'input conv and step 0')
        for step in range(1, t):
            check(lib.dl4ds_convlstm_step(
                wh.data_ptr(), zx.data_ptr(), ys.data_ptr(), c.data_ptr(), b,
                t, step, h, w, f, *geometry, stream), f'step {step}')
    return (ys, c, zx) if train else ys


def _flip_t(w):
    """wT [kh, kw, Co, C] from an HWIO kernel w [kh, kw, C, Co]: flipped in
    both spatial axes, channel axes swapped, so that convT(dz, w) is a SAME
    conv of dz with wT."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _chain(zs, cs, dys, wh, count):
    """Run the chain-step kernel T times in reverse on the current stream,
    adding one to `fused_convlstm.<count>` a launch. Returns dzs [B, T, H,
    W, 4F]."""
    b, t, h, w, f4 = zs.shape
    kh, kw, f, _ = wh.shape
    dev = zs.device
    plan = _seq_plan(b, h, w, kh, kw, f, _n_sm(dev))
    geometry = tuple(plan[k] for k in ('ns', 'th', 'tw', 'cw', 'rps'))
    wht = _flip_t(wh)
    dzs = torch.empty_like(zs)
    dcs = torch.empty((b, h, w, f), dtype=torch.float32, device=dev)
    fn = _seq_lib().dl4ds_convlstm_seq_step
    stream = torch.cuda.current_stream(dev).cuda_stream
    for step in reversed(range(t)):
        err = fn(zs.data_ptr(), cs.data_ptr(), dys.data_ptr(), wht.data_ptr(),
                 dzs.data_ptr(), dcs.data_ptr(), b, t, step, h, w, f, kh, kw,
                 *geometry, stream)
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
    their partials. Returns (dx or None, dwx, dbx, dwh)."""
    tensors = (x, wx, wh, zs, cs, ys, dys)
    dev = _check_cuda(tensors, 'backward kernel')
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
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
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    lx = kh * kw * cin * f4
    plan_x = _wgrad_plan(b, t, 0, h, w, cin, f, kh, kw, n_sm)
    part_x = empty(plan_x['n_chunks'], lx + f4)
    plan_h = _wgrad_plan(b, t, 1, h, w, f, f, kh, kw, n_sm) if t > 1 else None
    part_h = (empty(plan_h['n_chunks'], kh * kw * f * f4) if t > 1
              else empty(0))
    out_x, dwh = empty(lx + f4), empty(kh, kw, f, f4)

    def check(err, what):
        if err != 0:
            raise RuntimeError(f'ConvLSTM backward kernel launch failed with '
                               f'CUDA error {err} ({what})')
        fused_convlstm.bwd_launches += 1

    def wgrad(src, part, plan, with_db, t_skip, cs_):
        check(lib.dl4ds_convlstm_wgrad(
            src.data_ptr(), dzs.data_ptr(), part.data_ptr(), plan['n_chunks'],
            with_db, b, t, t_skip, h, w, cs_, f, kh, kw,
            *(plan[k] for k in ('tph', 'tpw', 'tpb', 'cwc', 'tpc')), stream),
            'dWx' if with_db else 'dWh')

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        dzs = _chain(zs, cs, dys, wh, 'bwd_launches')
        dx = None
        if need_dx:
            dx = empty(b, t, h, w, cin)
            plan = _seq_plan(b * t, h, w, kh, kw, cin, n_sm)
            wxt = _flip_t(wx)
            check(_seq_lib().dl4ds_convlstm_dx(
                dzs.data_ptr(), wxt.data_ptr(), dx.data_ptr(), b * t, h, w,
                cin, f, kh, kw,
                *(plan[k] for k in ('ns', 'th', 'tw', 'cw', 'rps')), stream),
                'dx')
        wgrad(x, part_x, plan_x, 1, 0, cin)
        if plan_h is not None:
            wgrad(ys, part_h, plan_h, 0, 1, f)
        check(lib.dl4ds_convlstm_wgrad_reduce(
            part_x.data_ptr(), part_x.shape[0], lx + f4, out_x.data_ptr(),
            part_h.data_ptr(), part_h.shape[0], dwh.numel(), dwh.data_ptr(),
            stream), 'reduce')
    return dx, out_x[:lx].view(kh, kw, cin, f4), out_x[lx:], dwh


def _launch_seq(zs, cs, dys, wh):
    """Run K4, the sequential chain: T step launches in reverse on the
    current stream. Returns dzs [B, T, H, W, 4F]."""
    tensors = (zs, cs, dys, wh)
    dev = _check_cuda(tensors, 'sequential BPTT kernel')
    b, t, h, w, f4 = zs.shape
    kh, kw, f, _ = wh.shape
    if (f4 != 4 * f or tuple(wh.shape[3:]) != (f4,)
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
    tensors, their plain versions on CPU tensors. Returns (dx, dwx, dbx,
    dwh); dx may be None when not need_dx."""
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


class FusedConvLSTM(torch.autograd.Function):
    """The layer with its BPTT backward: on CUDA tensors K2's training
    variant forward and, by `dispatch_info`'s route, K3 or K4 and the GEMM
    tail backward; on CPU tensors their plain versions. Saves x, wx, wh and
    the residuals zs, cs, ys for the backward. `route` (internal, for tests
    and the chip checks) forces a backward route."""

    @staticmethod
    def forward(ctx, x, wx, bx, wh, route=None):
        if x.device.type == 'cuda':
            ys, cs, zs = _launch(x, wx, bx, wh, train=True)
        else:
            ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
        ctx.save_for_backward(x, wx, wh, zs, cs, ys)
        ctx.route = route
        return ys

    @staticmethod
    def backward(ctx, dys):
        x, wx, wh, zs, cs, ys = ctx.saved_tensors
        route = ctx.route or dispatch_info(x.shape, wx.shape,
                                           wh.shape)['path']
        grads = _backward(route, x, wx, wh, zs, cs, ys, dys.contiguous(),
                          need_dx=ctx.needs_input_grad[0])
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def fused_convlstm(x, wx, bx, wh):
    """Whole ConvLSTM layer forward: ys [B, T, H, W, F] from x
    [B, T, H, W, Cin] (h and c start at zero).

    With grad mode on and any input that requires grad, `FusedConvLSTM`
    (differentiable; on CUDA K2's training variant, and K3 or K4 with the
    GEMM tail as `dispatch_info` routes the layer). Otherwise, on CUDA
    tensors K2's inference variant, float32 only;
    on CPU tensors `convlstm_reference`. `fused_convlstm.launches` counts K2
    inference launches (T a layer: the input launch and T-1 steps), `.train_launches` K2 training launches,
    `.bwd_launches` K3 launches and `.seq_launches` K4 launches; the CPU path
    launches nothing."""
    if x.device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {x.device}')
    if torch.is_grad_enabled() and any(
            u.requires_grad for u in (x, wx, bx, wh)):
        return FusedConvLSTM.apply(x, wx, bx, wh)
    if x.device.type == 'cuda':
        return _launch(x, wx, bx, wh)
    return convlstm_reference(x, wx, bx, wh)[0]


fused_convlstm.launches = 0
fused_convlstm.train_launches = 0
fused_convlstm.bwd_launches = 0
fused_convlstm.seq_launches = 0
