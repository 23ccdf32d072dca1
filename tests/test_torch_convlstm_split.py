"""PyTorch port of the ConvLSTM layer's split backward against the JAX
package on the CPU: K4's plain version (`convlstm_seq_reference`, the
sequential dh/dc chain) against the interpreted `_bwd_seq_kernel`
(`_seq_pallas`), the split route (the chain, then `convlstm_backward_tail`'s
float32 GEMMs) through `FusedConvLSTM` against `jax.grad` through the JAX
split backward (`_fused(..., split=True)`, interpreted) and through the XLA
layer, the two routes against each other, and the route table
`dispatch_info`; and the chain-step tile that K4 and K3 share: its launch
plan (every output stored once) and its 3xTF32 arithmetic emulated on the
CPU against the float32 and float64 plain versions. Inputs come from numpy;
everything is float32. Tolerances as tests/test_pallas_ops.py's
split-backward test: dx 1e-5, weights and bias 1e-4; dzs 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu.ops.pallas_convlstm as jax_pallas_convlstm
import dl4ds_tpu_torch.ops.convlstm as conv
from dl4ds_tpu_torch.models.blocks import ConvLSTM2D
from dl4ds_tpu_torch.ops.convlstm import (FusedConvLSTM, _flip_t, _seq_plan,
                                          _unfold, convlstm_backward_reference,
                                          convlstm_seq_reference,
                                          convlstm_train_reference,
                                          d_hard_sigmoid, dispatch_info,
                                          hard_sigmoid)
from _torch_xla import quick_xla  # noqa: F401

# (B, T, H, W, Cin, F, kh, kw): Cin != F with F = 5, H != W with an odd W at
# 5x5, kh != kw, and the JAX package's F = 16 valley (its split route)
SPLIT_SHAPES = [(4, 3, 8, 8, 2, 5, 3, 3), (2, 2, 9, 11, 3, 3, 5, 5),
                (2, 3, 6, 9, 3, 4, 3, 5), (2, 3, 6, 8, 16, 16, 3, 3)]
GRAD_TOL = dict(dx=1e-5, dwx=1e-4, dbx=1e-4, dwh=1e-4)
# (Cin, F, k) of the six ConvLSTM layers of the two recurrent training paths
# (batch 128, T 4, 16x16 LR patches): recresnet_spc x4 at n_filters 8
# (BASELINE config 4) and at n_filters 64 (bench_suite.py's
# recresnet_spc_width64), with the route PERF.md's table gives each
CONFIG4_LAYERS = [(1, 8, 5), (8, 8, 3), (8, 8, 5), (8, 8, 3), (8, 8, 5),
                  (8, 8, 3)]
WIDTH64_LAYERS = [(1, 64, 5), (64, 64, 3), (64, 64, 5), (64, 64, 3),
                  (64, 64, 5), (64, 64, 3)]
ROUTES = {'config4': 'fused', 'width64': 'split'}


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _inputs(shape, seed=0):
    b, t, h, w, cin, f, kh, kw = shape
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return ([n(b, t, h, w, cin), 0.3 * n(kh, kw, cin, 4 * f), 0.1 * n(4 * f),
             0.3 * n(kh, kw, f, 4 * f)], n(b, t, h, w, f))


def _pack(a):
    """[B, T, H, W, C] -> the JAX kernels' rows [B, T, H, W*C]."""
    b, t, h, w, c = a.shape
    return jnp.asarray(a.reshape(b, t, h, w * c))


def _pack_gates(a):
    """[B, T, H, W, 4F] -> gate-major rows [B, T, H, 4*W*F] (gate, x, f)."""
    b, t, h, w, f4 = a.shape
    return jnp.asarray(a.reshape(b, t, h, w, 4, f4 // 4)
                       .transpose(0, 1, 2, 4, 3, 5).reshape(b, t, h, w * f4))


@pytest.mark.parametrize('shape', SPLIT_SHAPES)
def test_seq_reference_matches_the_interpreted_seq_kernel(shape):
    """dzs of the plain chain against `_seq_pallas(..., interpret=True)`,
    unpacked from the band layout (gate-major [.., 4, W, F] rows, the kh-1
    pad rows stripped)."""
    b, t, h, w, _, f, kh, kw = shape
    rng = np.random.default_rng(1)
    zs = 1.5 * rng.standard_normal((b, t, h, w, 4 * f)).astype(np.float32)
    cs, dys = (rng.standard_normal((b, t, h, w, f)).astype(np.float32)
               for _ in range(2))
    wh = 0.3 * rng.standard_normal((kh, kw, f, 4 * f)).astype(np.float32)
    bwht = jnp.swapaxes(jax_pallas_convlstm._band(jnp.asarray(wh), w), 1, 2)
    dzsp = np.asarray(jax_pallas_convlstm._seq_pallas(
        _pack_gates(zs), _pack(cs), _pack(dys), bwht, f, True, w, kw))
    assert dzsp.shape == (b, t, h + kh - 1, 4 * w * f)
    ph = (kh - 1) // 2
    want = dzsp[:, :, ph:ph + h].reshape(b, t, h, 4, w, f).transpose(
        0, 1, 2, 4, 3, 5).reshape(b, t, h, w, 4 * f)
    got = convlstm_seq_reference(*map(torch.from_numpy, (zs, cs, dys, wh)))
    assert tuple(got.shape) == (b, t, h, w, 4 * f)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _jax_grads(args, dys, path):
    if path == 'pallas_split':
        def layer(*a):
            return jax_pallas_convlstm._fused(*a, True, None, True)
    else:
        def layer(*a):
            return jax_pallas_convlstm.convlstm_reference(*a)[0]
    loss = lambda *a: jnp.sum(layer(*a) * dys)  # noqa: E731
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, args))]


def _torch_grads(args, dys, route, x_grad=True):
    leaves = [torch.from_numpy(a).requires_grad_(x_grad or i > 0)
              for i, a in enumerate(args)]
    ys = FusedConvLSTM.apply(*leaves, route)
    ys.backward(torch.from_numpy(dys))
    return [None if u.grad is None else u.grad.numpy() for u in leaves]


@pytest.mark.parametrize('path', ['pallas_split', 'xla'])
@pytest.mark.parametrize('shape', SPLIT_SHAPES)
def test_split_route_matches_jax_grad(shape, path):
    """dx, dWx, dbx and dWh of the split route against jax.grad through the
    JAX split backward (interpreted `_fwd_kernel` and `_bwd_seq_kernel`,
    then its XLA contractions) and through the XLA layer."""
    args, dys = _inputs(shape)
    want = _jax_grads(args, dys, path)
    got = _torch_grads(args, dys, 'split')
    for name, g, w in zip(('dx', 'dwx', 'dbx', 'dwh'), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=GRAD_TOL[name], err_msg=name)


@pytest.mark.parametrize('shape', SPLIT_SHAPES + [(2, 1, 5, 7, 3, 4, 3, 3)])
def test_both_routes_give_the_same_gradients(shape):
    """The two routes on the CPU (K3's and K4's plain versions, the latter
    with the GEMM tail) within 1e-5 of max(1, max |g|): float32 sums in
    another order. T = 1 has no chain and no dWh."""
    args, dys = _inputs(shape, seed=2)
    fused = _torch_grads(args, dys, 'fused')
    split = _torch_grads(args, dys, 'split')
    for name, a, b in zip(('dx', 'dwx', 'dbx', 'dwh'), fused, split):
        np.testing.assert_allclose(
            b, a, atol=1e-5 * max(1.0, float(np.abs(a).max())), rtol=0,
            err_msg=name)


def test_split_tail_without_an_input_gradient():
    """The model's first layer: x needs no gradient, so the tail forms no
    dx; the weights match the JAX split backward."""
    args, dys = _inputs(SPLIT_SHAPES[1], seed=3)
    want = _jax_grads(args, dys, 'pallas_split')
    got = _torch_grads(args, dys, 'split', x_grad=False)
    assert got[0] is None
    for name, g, w in zip(('dwx', 'dbx', 'dwh'), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL[name], err_msg=name)


def test_backward_reference_is_the_chain_and_the_conv_adjoints():
    """K3's oracle takes its chain from `convlstm_seq_reference`: the same
    dz gives its bias gradient exactly."""
    args, dys = _inputs(SPLIT_SHAPES[0], seed=4)
    x, wx, bx, wh = map(torch.from_numpy, args)
    ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    dys = torch.from_numpy(dys)
    dzs = convlstm_seq_reference(zs, cs, dys, wh)
    _, _, dbx, _ = convlstm_backward_reference(x, wx, wh, zs, cs, ys, dys)
    torch.testing.assert_close(dbx, dzs.sum(dim=(0, 1, 2, 3)), atol=0,
                               rtol=0)


@pytest.mark.parametrize('path,layers', [('config4', CONFIG4_LAYERS),
                                         ('width64', WIDTH64_LAYERS)])
def test_route_table_of_the_training_paths(path, layers):
    """The six layers of each training path route as PERF.md's table
    says."""
    for cin, f, k in layers:
        info = dispatch_info((128, 4, 16, 16, cin), (k, k, cin, 4 * f),
                             (k, k, f, 4 * f))
        assert info['path'] == ROUTES[path], (cin, f, k, info)
        assert info['reason']


def test_route_table_edges():
    """The width threshold (64, at every kernel size: both routes run the
    same chain-step kernel, so no kernel size is left to one route) and the
    kernels that no route takes."""
    def route(f, kh=3, kw=3, cin=4):
        return dispatch_info((2, 3, 8, 8, cin), (kh, kw, cin, 4 * f),
                             (kh, kw, f, 4 * f))['path']
    assert [route(f) for f in (8, 16, 32, 63, 64, 72)] == [
        'fused', 'fused', 'fused', 'fused', 'split', 'split']
    assert [route(f, 5, 5) for f in (16, 32, 63, 64)] == [
        'fused', 'fused', 'fused', 'split']
    assert route(16, 1, 3) == 'fused'
    assert route(64, 3, 5) == 'split'
    assert route(64, 7, 7) == 'split'
    assert route(64, 9, 9) == 'split'
    with pytest.raises(NotImplementedError, match='even'):
        route(64, 2, 2)
    with pytest.raises(ValueError, match='do not match'):
        dispatch_info((2, 3, 8, 8, 4), (3, 3, 4, 64), (5, 5, 16, 64))
    with pytest.raises(ValueError, match='do not match'):
        dispatch_info((2, 3, 8, 8, 4), (3, 3, 2, 64), (3, 3, 16, 64))


@pytest.mark.parametrize('f,forced,want', [(4, None, 'fused'),
                                           (64, None, 'split'),
                                           (4, 'split', 'split'),
                                           (64, 'fused', 'fused')])
def test_backward_routes_on_dispatch_info(monkeypatch, f, forced, want):
    """`FusedConvLSTM.backward` takes dispatch_info's route unless one is
    forced: 'split' runs `convlstm_seq_reference` and the tail, 'fused'
    `convlstm_backward_reference`. On CPU tensors nothing is launched."""
    calls = []
    for name in ('convlstm_seq_reference', 'convlstm_backward_reference'):
        real = getattr(conv, name)
        monkeypatch.setattr(conv, name, lambda *a, _n=name, _r=real: (
            calls.append(_n), _r(*a))[1])
    args, dys = _inputs((1, 2, 4, 5, 3, f, 3, 3), seed=5)
    fcl = conv.fused_convlstm
    before = (fcl.launches, fcl.train_launches, fcl.bwd_launches,
              fcl.seq_launches)
    grads = _torch_grads(args, dys, forced)
    # K3's oracle takes its chain from the plain chain too
    assert calls == (['convlstm_seq_reference'] if want == 'split' else
                     ['convlstm_backward_reference', 'convlstm_seq_reference'])
    assert all(np.isfinite(g).all() for g in grads)
    assert (fcl.launches, fcl.train_launches, fcl.bwd_launches,
            fcl.seq_launches) == before


def test_unknown_route_raises():
    args, dys = _inputs(SPLIT_SHAPES[0])
    with pytest.raises(ValueError, match='route'):
        _torch_grads(args, dys, 'xla')


def test_seq_kernel_wrapper_guards():
    """The CUDA wrapper of K4 checks dtype, device and kernel size before
    anything reaches the card."""
    from dl4ds_tpu_torch.ops.convlstm import _launch_seq
    args, dys = _inputs(SPLIT_SHAPES[0])
    x, wx, bx, wh = map(torch.from_numpy, args)
    _, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    res = (zs, cs, torch.from_numpy(dys), wh)
    with pytest.raises(TypeError, match='item 5'):
        _launch_seq(*(u.double() for u in res))
    with pytest.raises(ValueError, match='CUDA'):
        _launch_seq(*res)


def test_d_hard_sigmoid_steps_in_float32_for_float64_input():
    """The plain versions run in float64 are the kernels' oracle on the
    card: their gate derivative steps where the float32 gate reaches 0 or
    1 (0.2 z + 0.5 rounds to 1.0 at z = 2.4999998 in float32, not in
    float64), as the kernels step."""
    z = np.nextafter(np.float32([-2.5, 2.5]), np.float32([0, 0]))
    z = np.concatenate([z, np.linspace(-3, 3, 61, dtype=np.float32)])
    want = conv.d_hard_sigmoid(torch.from_numpy(z))
    got = conv.d_hard_sigmoid(torch.from_numpy(z).double())
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want.double().numpy())
    assert float(conv.hard_sigmoid(torch.from_numpy(z[1:2]))) == 1.0


# ---------------------------------------------------------------------------
# The chain-step tile (K4, and K3's chain and dx): plan and arithmetic
# ---------------------------------------------------------------------------

def _seq_block_outputs(plan, frames, h, w, f):
    """(frame, y, x, channel) of every output value the blocks of one
    chain-step or dx launch over `frames` frames sum, by the kernel's own
    index map (`csrc/convlstm_seq.cu`): block (bx, by), warp k, lane l, m
    tile mt, n tile j and fragment value i hold pixel m = (k // warps_n) *
    m_tiles * 16 + mt * 16 + l // 4 + 8 * (i // 2) of tile bx % tiles (m <
    th * tw), channel by * ns + ((k % warps_n) * n_tiles + j) * 8 + 2 * (l %
    4) + i % 2. The epilogue then stores each sum once, through shared
    memory, channel by channel."""
    ns, th, tw = plan['ns'], plan['th'], plan['tw']
    warps_n, wm, wn = plan['warps'][1], plan['m_tiles'], plan['n_tiles']
    bx, by, warp, lane, mt, j, i = np.ix_(
        np.arange(frames * plan['tiles']), np.arange(plan['slices']),
        np.arange(8), np.arange(32), np.arange(wm), np.arange(wn),
        np.arange(4))
    m = (warp // warps_n) * wm * 16 + mt * 16 + lane // 4 + 8 * (i // 2)
    fo = by * ns + ((warp % warps_n) * wn + j) * 8 + 2 * (lane % 4) + i % 2
    tile, frame = bx % plan['tiles'], bx // plan['tiles']
    y = (tile // plan['tiles_x']) * th + m // tw
    x = (tile % plan['tiles_x']) * tw + m % tw
    shape = np.broadcast(bx, by, warp, lane, mt, j, i).shape
    frame, y, x, fo, m = (np.broadcast_to(a, shape)
                          for a in (frame, y, x, fo, m))
    ok = (m < th * tw) & (y < h) & (x < w) & (fo < f)
    return frame[ok], y[ok], x[ok], fo[ok]


@pytest.mark.parametrize('f', [4, 5, 8, 12, 64, 72])
@pytest.mark.parametrize('b,h,w', [
    (4, 16, 16),           # the training frames: two whole tiles a frame
    (3, 5, 7),             # one ragged tile, rows clamped to H
    (1, 17, 17),           # 17 pixels a row: the last row tile ragged
    (1, 3, 300),           # wider than a tile: ragged column tiles
    (8, 32, 32)])          # 4 x 32 tiles
def test_seq_plan_covers_every_output_once(b, h, w, f):
    """Every pixel and output channel of every frame is summed by exactly
    one thread, with warps that tile the block's 128 pixels and ns
    channels."""
    plan = _seq_plan(b, h, w, 5, 5, f, n_sm=132)
    ns = plan['ns']
    warps_m, warps_n = plan['warps']
    assert ns in (8, 16, 32, 64) and warps_m * warps_n == 8
    assert warps_m * plan['m_tiles'] * 16 == 128 >= plan['th'] * plan['tw']
    assert warps_n * plan['n_tiles'] * 8 == ns
    assert plan['grid'] == (b * plan['tiles'], -(-f // ns))
    count = np.zeros((b, h, w, f), np.int64)
    np.add.at(count, _seq_block_outputs(plan, b, h, w, f), 1)
    assert (count == 1).all(), np.unique(count)


@pytest.mark.parametrize('shape,want', [
    # width-64 chain: 256 blocks of 64 channels; the 5x5 stage of all tap
    # rows fits two blocks an SM at 4 dz channels a chunk, the 3x3 at 8
    ((128, 16, 16, 5, 5, 64), (64, 8, 16, 4, 5)),
    ((128, 16, 16, 3, 3, 64), (64, 8, 16, 8, 3)),
    # width-8 chain (256 blocks) and K3's dx over the B*T frames
    ((128, 16, 16, 5, 5, 8), (8, 8, 16, 8, 5)),
    ((512, 16, 16, 3, 3, 8), (8, 8, 16, 8, 3)),
    ((2, 5, 7, 3, 3, 12), (8, 5, 7, 8, 3)),       # 2 blocks: ns 8
    ((200, 5, 7, 3, 3, 12), (16, 5, 7, 8, 3)),
    ((128, 16, 16, 5, 5, 32), (32, 8, 16, 8, 5)),
    ((8, 32, 32, 5, 5, 64), (16, 4, 32, 8, 5)),     # 64 blocks at ns 64
    ((128, 16, 16, 7, 7, 72), (64, 8, 16, 8, 1)),   # one tap row a stage
    ((128, 16, 16, 7, 7, 16), (16, 8, 16, 8, 7))])
def test_seq_plan_tiles_channels_and_stages(shape, want):
    """The chain-step tile's plan: 128-pixel tiles, ns channels (halved
    while an SM would get no block) and the deepest stage in the shared
    memory budget of two blocks an SM."""
    plan = _seq_plan(*shape, n_sm=132)
    assert tuple(plan[k] for k in ('ns', 'th', 'tw', 'cw', 'rps')) == want
    assert plan['smem'] <= 110 * 1024


def _mm3(a, b, passes=3):
    """a @ b with the kernels' tensor-core products: operands split into
    TF32 hi and lo parts, hi*lo + lo*hi + hi*hi in float32 (passes 3), or
    hi*hi alone (plain TF32, passes 1)."""
    from test_torch_convlstm import _mm_tf32
    return _mm_tf32(a, b, passes)


def _chain_emulated(zs, cs, dys, wh, passes=3):
    """The chain as the tile computes it: dh_t = dys_t + the SAME conv of
    dz_{t+1} with the flipped, transposed wh, its products in (3x)TF32;
    then the plain version's gate algebra."""
    b, t, h, w, f4 = zs.shape
    kh, kw, f, _ = wh.shape
    wht = _flip_t(wh).reshape(kh * kw * f4, f)
    dh_next = dc_next = zero = cs.new_zeros((b, h, w, f))
    dzs = [None] * t
    for i in reversed(range(t)):
        zi, zf, zc, zo = torch.split(zs[:, i], f, dim=-1)
        gi, gf, gg, go = (hard_sigmoid(zi), hard_sigmoid(zf), torch.tanh(zc),
                          hard_sigmoid(zo))
        c_prev = cs[:, i - 1] if i > 0 else zero
        tc = torch.tanh(cs[:, i])
        dh = dys[:, i] + dh_next
        dc = dh * go * (1 - tc * tc) + dc_next
        dz = torch.cat([dc * gg * d_hard_sigmoid(zi),
                        dc * c_prev * d_hard_sigmoid(zf),
                        dc * gi * (1 - gg * gg),
                        dh * tc * d_hard_sigmoid(zo)], dim=-1)
        dzs[i] = dz
        dh_next = _mm3(_unfold(dz, kh, kw), wht, passes).reshape(b, h, w, f)
        dc_next = dc * gf
    return torch.stack(dzs, dim=1)


def _layer_residuals(cin, f, k, b, seed):
    layer = ConvLSTM2D(cin, f, (k, k))
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    wx, bx, wh = (p.detach() for p in (layer.input_conv.kernel,
                                       layer.input_conv.bias,
                                       layer.cell.recurrent_conv.kernel))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, 4, 16, 16, cin)).astype(
        np.float32))
    dys = torch.from_numpy(rng.standard_normal((b, 4, 16, 16, f)).astype(
        np.float32))
    ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    return x, wx, wh, zs, cs, ys, dys


@pytest.mark.parametrize('cin,f,k', [(1, 8, 5), (8, 8, 3), (8, 8, 5),
                                     (1, 64, 5), (64, 64, 3), (64, 64, 5)])
def test_chain_3xtf32_arithmetic_keeps_float32_accuracy(cin, f, k):
    """The chain-step tile's numeric scheme, emulated on the CPU at the
    layer shapes of both training paths (T 4, 16x16, batch 2, Keras init):
    dzs in 3xTF32 stays within K4's 1e-5 of max(1, max |dzs|) of the
    float32 plain chain and of the float64 one (plain TF32, one product, is
    1e-4 off), and K3's dx from it within 1e-5 of max |dx|, as on the
    card."""
    x, wx, wh, zs, cs, ys, dys = _layer_residuals(cin, f, k, 2, f + k)
    got = _chain_emulated(zs, cs, dys, wh)
    want32 = convlstm_seq_reference(zs, cs, dys, wh)
    want64 = convlstm_seq_reference(zs.double(), cs.double(), dys.double(),
                                    wh.double())
    scale = max(1.0, want64.abs().max().item())
    assert (got - want32).abs().max().item() <= 1e-5 * scale
    assert (got.double() - want64).abs().max().item() <= 1e-5 * scale
    one_pass = _chain_emulated(zs, cs, dys, wh, passes=1)
    assert (one_pass.double() - want64).abs().max().item() > 1e-5 * scale
    b, t, h, w, f4 = zs.shape
    dx = _mm3(_unfold(got.reshape(b * t, h, w, f4), k, k),
              _flip_t(wx).reshape(k * k * f4, cin)).reshape(x.shape)
    dx64 = conv._conv_same_t(want64.reshape(b * t, h, w, f4),
                             wx.double()).reshape(x.shape)
    assert ((dx.double() - dx64).abs().max().item()
            <= 1e-5 * dx64.abs().max().item())
