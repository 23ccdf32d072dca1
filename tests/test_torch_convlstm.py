"""PyTorch port of the spatio-temporal path against the JAX package on the
CPU: the ConvLSTM layer (the plain version of K2) against the Pallas kernel
run in interpret mode and against the XLA reference, K2's launch plan (every
output stored once) and its 3xTF32 arithmetic emulated on the CPU against
the float32 and float64 plain versions, the ConvLSTM blocks and
their init, the recurrent `recresnet_spc` model with carried weights,
time-window batch synthesis and `predict(time_window=...)`. Inputs come from
numpy; everything is float32. Tolerances: 1e-5 for one layer or block
(float32 sums taken in another order), 1e-4 for a whole model (as in
`tests/test_torch_models.py`)."""

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dl4ds_tpu as dds
import dl4ds_tpu.ops.pallas_convlstm as jax_pallas_convlstm
from dl4ds_tpu.models import blocks as jax_blocks

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.models.blocks import (ChannelAttention2D, ConvLSTM2D,
                                           RecurrentConvBlock)
from dl4ds_tpu_torch.ops.convlstm import (FusedConvLSTM, _fwd_plan, _launch,
                                          _unfold, convlstm_train_reference,
                                          hard_sigmoid)
from _torch_xla import quick_xla  # noqa: F401

HR, SCALE, T = 64, 4, 3
LR = HR // SCALE
SMALL = dict(scale=SCALE, n_channels=3, lr_size=(LR, LR), time_window=T,
             n_filters=4, n_blocks=1)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _params_np(variables):
    return jax.tree_util.tree_map(np.asarray, variables['params'])


class _PallasConvLSTM2D(jax_blocks.ConvLSTM2D):
    """The JAX ConvLSTM layer with the fused Pallas path on (interpret mode
    on the CPU). Setting the class attribute `ConvLSTM2D.use_pallas` does not
    reach instances (a Flax module's field default is bound in its
    generated `__init__`), so the blocks are given this subclass instead."""
    use_pallas: Optional[bool] = True


_PallasConvLSTM2D.__name__ = 'ConvLSTM2D'     # Flax auto-names by class name


@pytest.fixture
def pallas_convlstm(monkeypatch):
    """Route the JAX package's ConvLSTM layers through the interpreted
    Pallas kernel; yields the list of its forward launches."""
    calls = []
    real = jax_pallas_convlstm._forward_pallas

    @functools.wraps(real)
    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_pallas_convlstm, '_forward_pallas', spy)
    monkeypatch.setattr(jax_blocks, 'ConvLSTM2D', _PallasConvLSTM2D)
    yield calls


# ---------------------------------------------------------------------------
# K2's plain version
# ---------------------------------------------------------------------------

# (B, T, H, W, Cin, F, k): Cin != F, H != W with an odd W, and T = 1
K2_SHAPES = [(4, 3, 8, 8, 2, 5, 3), (2, 2, 9, 11, 3, 3, 5),
             (2, 1, 6, 7, 4, 4, 3)]


def _k2_inputs(shape, seed=0):
    b, t, h, w, cin, f, k = shape
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [n(b, t, h, w, cin), 0.3 * n(k, k, cin, 4 * f), 0.1 * n(4 * f),
            0.3 * n(k, k, f, 4 * f)]


@pytest.mark.parametrize('shape', K2_SHAPES)
def test_k2_plain_matches_interpreted_pallas_and_xla(shape):
    args = _k2_inputs(shape)
    jargs = list(map(jnp.asarray, args))
    want_pallas = np.asarray(jax_pallas_convlstm.fused_convlstm(
        *jargs, interpret=True))
    want_ys, want_cs = map(np.asarray,
                           jax_pallas_convlstm.convlstm_reference(*jargs))
    targs = list(map(torch.from_numpy, args))
    got = tds.fused_convlstm(*targs).numpy()
    ys, cs = (a.numpy() for a in tds.convlstm_reference(*targs))
    assert got.shape == want_pallas.shape == shape[:4] + (shape[5],)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5)
    np.testing.assert_allclose(ys, want_ys, atol=1e-5)
    np.testing.assert_allclose(cs, want_cs, atol=1e-5)


def test_hard_sigmoid_is_keras_not_torch():
    x = np.linspace(-4, 4, 81, dtype=np.float32)
    want = np.asarray(jax_blocks._hard_sigmoid(jnp.asarray(x)))
    got = hard_sigmoid(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    assert not torch.allclose(got, F.hardsigmoid(torch.from_numpy(x)))


def test_k2_cpu_tensor_launches_no_kernel():
    before = tds.fused_convlstm.launches
    tds.fused_convlstm(*map(torch.from_numpy, _k2_inputs(K2_SHAPES[0])))
    assert tds.fused_convlstm.launches == before


@pytest.mark.parametrize('case', ['float64', 'float16', 'grad'])
def test_k2_kernel_wrapper_guards(case):
    """The CUDA wrapper's checks run before anything reaches the card: the
    kernel takes float32 or bfloat16 only, one dtype for every tensor
    (other dtypes are ROADMAP item 5), and CUDA tensors only, in both
    variants. Weights that require grad (grad mode
    on) route the layer through FusedConvLSTM, whose forward is the
    training variant."""
    x, wx, bx, wh = map(torch.from_numpy, _k2_inputs(K2_SHAPES[0]))
    if case == 'grad':
        wx.requires_grad_()
        for train in (False, True):
            with pytest.raises(ValueError, match='CUDA'):
                _launch(x, wx, bx, wh, train=train)     # the CPU device
        ys = tds.fused_convlstm(x, wx, bx, wh)
        assert isinstance(ys.grad_fn, FusedConvLSTM._backward_cls)
        with torch.no_grad():
            assert tds.fused_convlstm(x, wx, bx, wh).grad_fn is None
        return
    dtype = getattr(torch, case)
    with pytest.raises(TypeError, match='item 5'):
        _launch(x.to(dtype), wx, bx, wh)


def _k2_block_outputs(plan, frames, h, w, f):
    """(frame, y, x, channel) of every output value the blocks of one K2
    launch over `frames` frames store, by the kernel's own index map
    (`csrc/convlstm.cu`): block (bx, by), warp k, lane l, m tile mt and
    fragment value i hold pixel m = (k // nsub) * m_tiles * 16 + mt * 16 +
    l // 4 + 8 * (i // 2) of tile bx % tiles (m < th * tw), channel by * fs
    + (k % nsub) * 8 + 2 * (l % 4) + i % 2, all four gates of it."""
    fs, th, tw = plan['fs'], plan['th'], plan['tw']
    nsub, wm = fs // 8, plan['m_tiles']
    bx, by, warp, lane, mt, i = np.ix_(
        np.arange(frames * plan['tiles']), np.arange(plan['slices']),
        np.arange(8), np.arange(32), np.arange(wm), np.arange(4))
    m = (warp // nsub) * wm * 16 + mt * 16 + lane // 4 + 8 * (i // 2)
    fo = by * fs + (warp % nsub) * 8 + 2 * (lane % 4) + i % 2
    tile, frame = bx % plan['tiles'], bx // plan['tiles']
    y = (tile // plan['tiles_x']) * th + m // tw
    x = (tile % plan['tiles_x']) * tw + m % tw
    shape = np.broadcast(bx, by, warp, lane, mt, i).shape
    frame, y, x, fo, m = (np.broadcast_to(a, shape)
                          for a in (frame, y, x, fo, m))
    ok = (m < th * tw) & (y < h) & (x < w) & (fo < f)
    return frame[ok], y[ok], x[ok], fo[ok]


@pytest.mark.parametrize('f', [4, 5, 8, 12, 64, 72])
@pytest.mark.parametrize('b,t,h,w', [
    (2, 3, 16, 16),        # the training frames: whole tiles
    (2, 2, 5, 7),          # one ragged tile, rows clamped to H
    (1, 2, 17, 17),        # 17 pixels a row: the last row tile ragged
    (1, 1, 3, 300),        # wider than a tile: ragged column tiles
    (8, 4, 32, 32),        # 4 x 32 and 8 x 32 tiles
    (1, 2, 6, 40)])        # 8 channels a block: too few blocks at 16
def test_k2_plan_covers_every_output_once(b, t, h, w, f):
    """Every pixel and gate channel of every frame is stored by exactly one
    thread, in the input launch (B*T frames) and in a step launch (B
    samples), with warps that tile the block's pixels and fs channels."""
    plan = _fwd_plan(b, t, h, w, 5, 5, f, n_sm=132)
    fs = plan['fs']
    warps_m, warps_n = plan['warps']
    assert fs in (8, 16) and warps_m * warps_n == 8 and warps_n * 8 == fs
    assert plan['th'] * plan['tw'] <= warps_m * plan['m_tiles'] * 16
    assert plan['input_grid'] == (b * t * plan['tiles'], -(-f // fs))
    assert plan['step_grid'] == (b * plan['tiles'], -(-f // fs))
    for frames in (b * t, b):
        count = np.zeros((frames, h, w, f), np.int64)
        np.add.at(count, _k2_block_outputs(plan, frames, h, w, f), 1)
        assert (count == 1).all(), (frames, np.unique(count))


@pytest.mark.parametrize('shape,want', [
    # width-64 training: 1024 blocks; the 5x5 weights of all tap rows fit
    # two blocks an SM at 4 channels a chunk, the 3x3 ones at 8
    ((128, 4, 16, 16, 5, 5, 64), (16, 8, 16, 4, 5)),
    ((128, 4, 16, 16, 3, 3, 64), (16, 8, 16, 8, 3)),
    ((128, 4, 16, 16, 5, 5, 8), (8, 16, 16, 8, 5)),   # a frame a block
    ((8, 4, 32, 32, 5, 5, 64), (16, 4, 32, 4, 5)),
    ((8, 4, 128, 128, 5, 5, 8), (8, 8, 32, 8, 5)),    # recresnet_spc serving
    ((2, 1, 9, 300, 3, 3, 12), (8, 8, 32, 8, 3)),     # 60 blocks at 16
    ((4, 2, 5, 7, 3, 3, 12), (8, 5, 7, 8, 3)),
    ((2, 2, 19, 23, 7, 7, 16), (8, 11, 23, 8, 1)),
    ((128, 2, 16, 16, 7, 7, 16), (16, 8, 16, 8, 1))])  # one tap row a stage
def test_k2_plan_tiles_channels_and_stages(shape, want):
    plan = _fwd_plan(*shape, n_sm=132)
    assert tuple(plan[k] for k in ('fs', 'th', 'tw', 'cw', 'rps')) == want
    assert plan['smem'] <= 110 * 1024


def _tf32_rna(a):
    """float32 -> TF32 as `cvt.rna.tf32.f32` rounds: to 10 mantissa bits,
    to nearest, ties away from zero (on the sign-magnitude bits)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b as K2's tensor-core products: operands split into TF32 hi and
    lo parts, hi*lo + lo*hi + hi*hi accumulated in float32 (passes 3), or
    plain TF32, hi*hi alone (passes 1). Each product of two TF32 values is
    exact in float32."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _k2_emulated(x, wx, bx, wh, passes=3):
    """The layer as the kernel computes it: the input conv over all B*T
    frames hoisted, accumulators started from the bias; each step's from
    zx_t, adding the recurrent conv (none at t = 0); the products in
    (3x)TF32; then the plain version's gates. Returns (ys, cs, zs)."""
    b, t, h, w, cin = x.shape
    kh, kw, _, f4 = wx.shape
    f = f4 // 4
    zx = bx + _mm_tf32(_unfold(x.reshape(b * t, h, w, cin), kh, kw),
                       wx.reshape(-1, f4), passes)
    zx = zx.reshape(b, t, h, w, f4)
    hh = cc = x.new_zeros((b, h, w, f))
    ys, cs, zs = [], [], []
    for i in range(t):
        z = zx[:, i]
        if i > 0:
            z = z + _mm_tf32(_unfold(hh, kh, kw), wh.reshape(-1, f4),
                             passes).reshape(b, h, w, f4)
        zi, zf, zc, zo = torch.split(z, f, dim=-1)
        cc = hard_sigmoid(zf) * cc + hard_sigmoid(zi) * torch.tanh(zc)
        hh = hard_sigmoid(zo) * torch.tanh(cc)
        ys.append(hh)
        cs.append(cc)
        zs.append(z)
    return tuple(torch.stack(u, dim=1) for u in (ys, cs, zs))


@pytest.mark.parametrize('cin,f,k,b', [(1, 64, 5, 4), (64, 64, 3, 2),
                                       (64, 64, 5, 2), (8, 8, 3, 4),
                                       (2, 8, 5, 4)])
def test_k2_3xtf32_arithmetic_keeps_float32_accuracy(cin, f, k, b):
    """K2's numeric scheme, emulated on the CPU at the training frames (T 4,
    16x16, Keras init, randn x): 3xTF32 products with the hoisted input
    conv stay within K2's 1e-5 of the float32 plain version (ys and cs;
    zs within 1e-5 of max(1, max |zs|), as on the card) and of float64,
    where plain TF32, one product, does not."""
    layer = ConvLSTM2D(cin, f, (k, k))
    layer.reset_parameters(torch.Generator().manual_seed(cin * f + k))
    wx, bx, wh = (p.detach() for p in (layer.input_conv.kernel,
                                       layer.input_conv.bias,
                                       layer.cell.recurrent_conv.kernel))
    x = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (b, 4, 16, 16, cin)).astype(np.float32))
    got = _k2_emulated(x, wx, bx, wh)
    want32 = convlstm_train_reference(x, wx, bx, wh)
    want64 = convlstm_train_reference(*(u.double() for u in (x, wx, bx, wh)))
    one_pass = _k2_emulated(x, wx, bx, wh, passes=1)
    zs_scale = max(1.0, want64[2].abs().max().item())
    for name, g, w32, w64, tf32, scale in zip(
            ('ys', 'cs', 'zs'), got, want32, want64, one_pass,
            (1.0, 1.0, zs_scale)):
        assert (g - w32).abs().max().item() <= 1e-5 * scale, name
        assert (g.double() - w64).abs().max().item() <= 1e-5 * scale, name
    assert (one_pass[0] - want32[0]).abs().max().item() > 1e-5


@pytest.mark.parametrize('case', ['wh', 'bx', 'even'])
def test_k2_rejects_mismatched_weights(case):
    x, wx, bx, wh = map(torch.from_numpy, _k2_inputs(K2_SHAPES[0]))
    if case == 'wh':
        wh, err = wh[..., :-1, :], ValueError
    elif case == 'bx':
        bx, err = bx[:-1], ValueError
    else:
        wx, wh, err = wx[:2, :2], wh[:2, :2], NotImplementedError
    with pytest.raises(err):
        tds.fused_convlstm(x, wx, bx, wh)


# ---------------------------------------------------------------------------
# Blocks and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('k', [3, 5])
def test_convlstm2d_with_carried_weights_matches_jax(k):
    x = np.random.default_rng(k).standard_normal((2, 3, 7, 9, 3)).astype(
        np.float32)
    jm = jax_blocks.ConvLSTM2D(4, (k, k))
    variables = jm.init(jax.random.PRNGKey(k), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = tds.load_jax_params(ConvLSTM2D(3, 4, (k, k)), _params_np(variables))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 7, 9, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_recurrent_conv_block_with_carried_weights_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 6, 2)).astype(
        np.float32)
    jm = jax_blocks.RecurrentConvBlock(4)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    assert sorted(variables['params']) == ['ConvLSTM2D_0', 'ConvLSTM2D_1']
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = tds.load_jax_params(RecurrentConvBlock(2, 4), _params_np(variables))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_convlstm_init_is_keras():
    """Unit forget bias exactly, a glorot-bounded input kernel and an
    orthogonal recurrent kernel, as the JAX layer initialises them."""
    f, cin, k = 4, 3, 3
    tm = ConvLSTM2D(cin, f, (k, k))
    tm.reset_parameters(torch.Generator().manual_seed(0))
    jv = _params_np(jax_blocks.ConvLSTM2D(f, (k, k)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 5, 5, cin))))
    want_bias = np.zeros(4 * f, np.float32)
    want_bias[f:2 * f] = 1.0
    np.testing.assert_array_equal(tm.input_conv.bias.detach().numpy(),
                                  want_bias)
    np.testing.assert_array_equal(jv['input_conv']['bias'], want_bias)
    limit = (6.0 / (k * k * (cin + 4 * f))) ** 0.5
    for kernel in (tm.input_conv.kernel.detach().numpy(),
                   jv['input_conv']['kernel']):
        assert 0.8 * limit < np.abs(kernel).max() <= limit
    for wh in (tm.cell.recurrent_conv.kernel.detach().numpy(),
               jv['cell']['recurrent_conv']['kernel']):
        m = wh.reshape(-1, 4 * f)                       # [k*k*F, 4F]
        np.testing.assert_allclose(m.T @ m, np.eye(4 * f), atol=1e-5)


def test_model_init_keeps_convlstm_kernels_contiguous():
    """DSModel.init re-strides the Conv weights to channels-last but leaves
    the HWIO ConvLSTM kernels contiguous, as the kernel reads them."""
    net = tds.recnet_postupsampling('resnet', 'spc', n_aux_channels=2,
                                    **SMALL).init(0, device='cpu')
    for name, p in net.named_parameters():
        if '.kernel' in name:
            assert p.is_contiguous(), name
        elif p.ndim == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), name


def test_time_window_channel_attention_matches_jax():
    """The recurrent heads' gate pools over (T, H) and gates per (W, C)."""
    x = np.random.default_rng(2).standard_normal((2 * T, 5, 7, 8)).astype(
        np.float32)
    jm = jax_blocks.ChannelAttention2D(8, time_window=T)
    params = _params_np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x)))
    tm = ChannelAttention2D(8, 8, time_window=T)
    spatial = ChannelAttention2D(8, 8)
    with torch.no_grad():
        for name in ('w1', 'b1', 'w2', 'b2'):
            getattr(tm, name).copy_(torch.tensor(params[name]))
            getattr(spatial, name).copy_(torch.tensor(params[name]))
        got = tm(torch.from_numpy(x)).numpy()
        per_frame = spatial(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - per_frame).max() > 1e-3


# ---------------------------------------------------------------------------
# The recurrent model
# ---------------------------------------------------------------------------

def _rec_models(n_aux, seed):
    jm = dds.recnet_postupsampling('resnet', 'spc', n_aux_channels=n_aux,
                                   **SMALL)
    variables = jm.init(jax.random.PRNGKey(seed))
    tm = tds.recnet_postupsampling('resnet', 'spc', n_aux_channels=n_aux,
                                   **SMALL)
    net = tds.load_jax_params(tm.init(seed, device='cpu'),
                              _params_np(variables))
    return (jm, variables), (tm, net)


@pytest.mark.parametrize('path', ['xla', 'pallas'])
@pytest.mark.parametrize('n_aux', [2, 0], ids=['aux', 'no_aux'])
def test_recnet_with_carried_weights_matches_jax(n_aux, path, request):
    (jm, variables), (tm, net) = _rec_models(n_aux, seed=n_aux)
    assert tm.name == jm.name == 'recresnet_spc'
    assert tm.input_shape == jm.input_shape == (T, LR, LR, 3)
    assert tm.param_count(net) == jm.param_count(variables)
    rng = np.random.default_rng(n_aux)
    x = rng.standard_normal((2, T, LR, LR, 3)).astype(np.float32)
    aux = (rng.standard_normal((2, HR, HR, n_aux)).astype(np.float32)
           if n_aux else None)
    calls = request.getfixturevalue('pallas_convlstm') if path == 'pallas' \
        else None
    want = np.asarray(jm.apply(variables, jnp.asarray(x),
                               None if aux is None else jnp.asarray(aux),
                               training=False))
    if calls is not None:
        assert len(calls) == 2 * (SMALL['n_blocks'] + 1)   # every layer
    with torch.inference_mode():
        got = net(torch.from_numpy(x),
                  None if aux is None else torch.from_numpy(aux)).numpy()
    assert got.shape == want.shape == (2, T, HR, HR, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_recnet_head_names_follow_flax_auto_names():
    """The head's ConvBlocks are auto-named in call order: with aux the aux
    branch is ConvBlock_0, without it the gated block is."""
    for n_aux, names in ((2, ['ConvBlock_0', 'ConvBlock_1', 'ConvBlock_2']),
                         (0, ['ConvBlock_0', 'ConvBlock_1'])):
        jv = dds.recnet_postupsampling('resnet', 'spc', n_aux_channels=n_aux,
                                       **SMALL).init(jax.random.PRNGKey(0))
        jax_names = sorted(k for k in jv['params'] if k.startswith('Conv'))
        net = tds.recnet_postupsampling('resnet', 'spc', n_aux_channels=n_aux,
                                        **SMALL).init(0, device='cpu')
        assert jax_names == names
        assert sorted(k for k in net._modules if k.startswith('Conv')) \
            == names
        assert 'ChannelAttention2D_0' in jv['params'][names[-2]]


def test_load_jax_params_rejects_a_stray_convlstm_leaf():
    (_, variables), (tm, _) = _rec_models(2, seed=0)
    for where, leaf in (('input_conv', 'scale'), ('cell', 'bias')):
        params = _params_np(variables)
        layer = params['_RecBackbone_0']['RecurrentConvBlock2']['ConvLSTM2D_1']
        layer[where][leaf] = np.zeros(16, np.float32)
        with pytest.raises(KeyError, match=leaf):
            tds.load_jax_params(tm.init(0, device='cpu'), params)


@pytest.mark.parametrize('kwargs', [dict(dtype=torch.float16)])
def test_unported_recurrent_configurations_raise(kwargs):
    args = dict(backbone_block='resnet', upsampling='spc', n_aux_channels=2,
                **SMALL)
    args.update(kwargs)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tds.recnet_postupsampling(**args)


# ---------------------------------------------------------------------------
# Batch synthesis and predict
# ---------------------------------------------------------------------------

N = 6           # HR grids: 4 windows of 3


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(11)
    hr = rng.standard_normal((N, HR, HR)).astype(np.float32)
    topo = rng.standard_normal((HR, HR)).astype(np.float32)
    mask = (rng.random((HR, HR)) > 0.5).astype(np.float32)
    pred = rng.standard_normal((N, HR, HR, 2)).astype(np.float32)
    return hr, topo, mask, pred


@pytest.fixture(scope='module')
def rec_models():
    # 3 input channels: the grid and the two predictor channels
    return _rec_models(2, seed=5)


def test_batch_synthesizer_time_windows_match_jax(data):
    hr, topo, mask, pred = data
    kw = dict(upsampling='spc', scale=SCALE, batch_size=3, time_window=T,
              static_vars=[topo, mask], predictors=[pred])
    idx = np.array([3, 0, 2])
    want = dds.BatchSynthesizer(hr[..., None], None, **kw)(
        jnp.asarray(idx), jax.random.PRNGKey(0))
    synth = tds.BatchSynthesizer(hr[..., None], None, device='cpu', **kw)
    got = synth(torch.from_numpy(idx))
    assert synth.n == N - T
    assert synth.n_channels_lr == 3 and synth.n_channels_aux == 2
    assert got['lr'].shape == (3, T, LR, LR, 3)
    assert got['aux'].shape == (3, HR, HR, 2)
    for key in ('lr', 'hr', 'aux'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)
    with pytest.raises(IndexError):
        synth(torch.tensor([N - T + 1]))


class _Affine:
    def inverse_transform(self, a):
        return 2.0 * a + 1.0


def test_predict_time_window_matches_jax(data, rec_models):
    """Statics, a predictor, a ragged tail (4 windows at batch 3), the
    scaler and return_lr, end to end."""
    hr, topo, mask, pred = data
    kw = dict(scale=SCALE, time_window=T, static_vars=[topo, mask],
              predictors=[pred], batch_size=3, scaler=_Affine(),
              return_lr=True)
    want, want_lr = dds.predict(rec_models[0], hr, **kw)
    got, got_lr = tds.predict(rec_models[1], hr, device='cpu', **kw)
    assert isinstance(got, np.ndarray)
    assert got.shape == want.shape == (N, HR, HR, 1)
    assert got_lr.shape == (N - T + 1, T, LR, LR, 3)
    np.testing.assert_allclose(got_lr, np.asarray(want_lr), atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_spatiotemporal_collapse_matches_jax():
    from dl4ds_tpu.utils import spatiotemporal_to_spatial_samples as jax_st
    from dl4ds_tpu_torch.utils import spatiotemporal_to_spatial_samples
    a = np.arange(4 * T * 2 * 2).reshape(4, T, 2, 2, 1).astype(np.float32)
    np.testing.assert_array_equal(spatiotemporal_to_spatial_samples(a, T),
                                  jax_st(a, T))
    with pytest.raises(ValueError):
        spatiotemporal_to_spatial_samples(a, T + 1)


def test_predict_time_window_is_needed_and_only_for_recurrent_models(
        data, rec_models):
    hr = data[0]
    spatial = tds.net_postupsampling('resnet', 'spc', scale=SCALE,
                                     n_channels=1, n_aux_channels=0,
                                     lr_size=(LR, LR), n_filters=4,
                                     n_blocks=1)
    with pytest.raises(ValueError, match='spatial'):
        tds.predict((spatial, spatial.init(0, device='cpu')), hr,
                    scale=SCALE, time_window=T, device='cpu')
    with pytest.raises(ValueError, match='time_window'):
        tds.predict(rec_models[1], hr, scale=SCALE, device='cpu')


@pytest.mark.parametrize('kwargs', [
    dict(tile=32, mesh=object()), dict(mesh=object()), dict(quantize='int8'),
    dict(spatial_mesh=object()), dict(tile=32, halo=8, quantize='int8')])
def test_unported_recurrent_predict_modes_raise(data, rec_models, kwargs):
    """`spatial_mesh` has been ported (tests/test_torch_distributed_spatial.
    py): a spatio-temporal model is the JAX package's ValueError. `mesh`, tiled
    or not, has been ported since (the recurrent model against the JAX
    package on a 2-device mesh in tests/test_torch_distributed_serving.py):
    a mesh that is not a DeviceMesh is a TypeError. Int8 serving
    (`quantize`, tiled or not) has been ported too: those cases now serve
    the recurrent model (its int8 sites; the ConvLSTM layers stay float,
    in K2), compared with the JAX package in
    tests/test_torch_quantization.py."""
    if 'quantize' in kwargs and 'mesh' not in kwargs:
        hr, topo, mask, pred = data
        y = tds.predict(rec_models[1], hr, scale=SCALE, time_window=T,
                        static_vars=[topo, mask], predictors=[pred],
                        batch_size=3, device='cpu', **kwargs)
        assert y.shape == (N, HR, HR, 1) and np.isfinite(y).all()
        return
    err, match = ((ValueError, 'spatial models only')
                  if 'spatial_mesh' in kwargs else (TypeError, 'DeviceMesh'))
    with pytest.raises(err, match=match):
        tds.predict(rec_models[1], data[0], scale=SCALE, time_window=T,
                    device='cpu', **kwargs)
