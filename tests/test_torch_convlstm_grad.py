"""PyTorch port of the ConvLSTM layer's training path against the JAX
package on the CPU: the plain versions of K2's training variant
(`convlstm_train_reference`, with the zs/cs residuals) and of K3
(`convlstm_backward_reference`, the BPTT), reached through `FusedConvLSTM`,
held against `jax.grad` through the Pallas kernels run in interpret mode
(`_fwd_kernel` with residuals, `_bwd_kernel`) and through the XLA reference.
Also K3's weight-gradient pass: its launch plan (every gradient term written
once) and its 3xTF32 arithmetic emulated against the float32 and float64
plain versions (1e-5 of max |ref|). Inputs come from numpy; everything is
float32. Tolerances as tests/test_pallas_ops.py's gradient test: dx 1e-5,
weights and bias 1e-4; forward values and residuals 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu_torch as tds
import dl4ds_tpu.ops.pallas_convlstm as jax_pallas_convlstm
from dl4ds_tpu_torch.models.blocks import ConvLSTM2D
from dl4ds_tpu_torch.ops.convlstm import (FusedConvLSTM, _unfold, _wgrad_plan,
                                          convlstm_backward_reference,
                                          convlstm_seq_reference,
                                          convlstm_train_reference,
                                          d_hard_sigmoid, hard_sigmoid)
from dl4ds_tpu_torch.ops.convlstm import _conv_same_w as conv_same_w
from _torch_xla import quick_xla  # noqa: F401

# (B, T, H, W, Cin, F, kh, kw): the three shapes of
# tests/test_torch_convlstm.py's K2_SHAPES (Cin != F, H != W with an odd W,
# T = 1) and a kernel with kh != kw
GRAD_SHAPES = [(4, 3, 8, 8, 2, 5, 3, 3), (2, 2, 9, 11, 3, 3, 5, 5),
               (2, 1, 6, 7, 4, 4, 3, 3), (2, 3, 6, 9, 3, 4, 3, 5)]
GRAD_TOL = dict(dx=1e-5, dwx=1e-4, dbx=1e-4, dwh=1e-4)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _inputs(shape, seed=0):
    b, t, h, w, cin, f, kh, kw = shape
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return ([n(b, t, h, w, cin), 0.3 * n(kh, kw, cin, 4 * f), 0.1 * n(4 * f),
             0.3 * n(kh, kw, f, 4 * f)], n(b, t, h, w, f))


def _jax_grads(args, dys, path):
    """The VJP of ys with dys, through the interpreted Pallas kernels or the
    XLA reference."""
    if path == 'pallas':
        def layer(*a):
            return jax_pallas_convlstm.fused_convlstm(*a, interpret=True)
    else:
        def layer(*a):
            return jax_pallas_convlstm.convlstm_reference(*a)[0]
    loss = lambda *a: jnp.sum(layer(*a) * dys)  # noqa: E731
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, args))]


def _torch_grads(args, dys, x_grad=True):
    leaves = [torch.from_numpy(a).requires_grad_(x_grad or i > 0)
              for i, a in enumerate(args)]
    ys = tds.fused_convlstm(*leaves)
    ys.backward(torch.from_numpy(dys))
    return ys, [None if u.grad is None else u.grad.numpy() for u in leaves]


@pytest.mark.parametrize('path', ['pallas', 'xla'])
@pytest.mark.parametrize('shape', GRAD_SHAPES)
def test_bptt_matches_jax_grad(shape, path):
    """dx, dWx, dbx and dWh of the port's training path against jax.grad
    through the interpreted `_fwd_kernel`/`_bwd_kernel` pair and through
    the XLA layer."""
    args, dys = _inputs(shape)
    want = _jax_grads(args, dys, path)
    ys, got = _torch_grads(args, dys)
    assert isinstance(ys.grad_fn, FusedConvLSTM._backward_cls)
    for name, g, w in zip(('dx', 'dwx', 'dbx', 'dwh'), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=GRAD_TOL[name], err_msg=name)


@pytest.mark.parametrize('shape', GRAD_SHAPES)
def test_training_residuals_match_the_pallas_forward(shape):
    """ys, cs and zs of the plain training forward against `_fused_fwd`'s
    residuals, whose lanes are packed (gate, x, channel) per row."""
    args, _ = _inputs(shape)
    b, t, h, w, _, f, _, _ = shape
    ys_j, res = jax_pallas_convlstm._fused_fwd(*map(jnp.asarray, args),
                                               True, None)
    zsp, csp = np.asarray(res[3]), np.asarray(res[5])
    zs_j = zsp.reshape(b, t, h, 4, w, f).transpose(0, 1, 2, 4, 3, 5).reshape(
        b, t, h, w, 4 * f)
    ys, cs, zs = (a.numpy() for a in convlstm_train_reference(
        *map(torch.from_numpy, args)))
    assert zs.shape == (b, t, h, w, 4 * f)
    np.testing.assert_allclose(ys, np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(cs, csp.reshape(b, t, h, w, f), atol=1e-5)
    np.testing.assert_allclose(zs, zs_j, atol=1e-5)


@pytest.mark.parametrize('shape', GRAD_SHAPES[:2])
def test_fused_function_matches_autograd_through_the_reference(shape):
    """The autograd.Function on CPU tensors against autograd through
    `convlstm_reference` (they differ only where a gate sits exactly at a
    clip end, which random inputs do not hit)."""
    args, dys = _inputs(shape, seed=1)
    _, got = _torch_grads(args, dys)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    want = torch.autograd.grad(tds.convlstm_reference(*leaves)[0], leaves,
                               torch.from_numpy(dys))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5)


def test_backward_reference_takes_the_saved_residuals():
    """`convlstm_backward_reference` on the forward's residuals is the
    Function's backward: the same numbers as autograd through the
    Function."""
    args, dys = _inputs(GRAD_SHAPES[0], seed=2)
    x, wx, bx, wh = map(torch.from_numpy, args)
    ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    got = convlstm_backward_reference(x, wx, wh, zs, cs, ys,
                                      torch.from_numpy(dys))
    _, want = _torch_grads(args, dys)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_d_hard_sigmoid_is_the_jax_kernels():
    """0.2 strictly inside the clip, 0 outside and at z = +-2.5 exactly,
    as `_d_hard_sigmoid`; autograd through the clamp gives 0.2 at the
    ends."""
    z = np.concatenate([np.linspace(-4, 4, 161), [-2.5, 2.5, 0.0],
                        np.nextafter(np.float32([-2.5, 2.5]),
                                     np.float32([0, 0]))]).astype(np.float32)
    want = np.asarray(jax_pallas_convlstm._d_hard_sigmoid(jnp.asarray(z)))
    got = d_hard_sigmoid(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)
    ends = torch.tensor([-2.5, 2.5], requires_grad=True)
    (clamp_grad,) = torch.autograd.grad(hard_sigmoid(ends).sum(), ends)
    assert np.all(d_hard_sigmoid(ends.detach()).numpy() == 0.0)
    assert np.allclose(clamp_grad.numpy(), 0.2)


def test_stem_layer_without_an_input_gradient_matches_jax():
    """The model's first layer: x needs no gradient, the weights do."""
    args, dys = _inputs(GRAD_SHAPES[1], seed=3)
    want = _jax_grads(args, dys, 'pallas')
    _, got = _torch_grads(args, dys, x_grad=False)
    assert got[0] is None
    for name, g, w in zip(('dwx', 'dbx', 'dwh'), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL[name], err_msg=name)


@pytest.mark.parametrize('grad', ['on', 'no_grad', 'inference_mode'])
def test_routing_takes_the_function_only_for_a_gradient(grad):
    """With grad mode on and an input that requires grad, the layer goes
    through FusedConvLSTM; otherwise through the inference path. On CPU
    tensors neither launches a kernel."""
    args, _ = _inputs(GRAD_SHAPES[0])
    x, wx, bx, wh = map(torch.from_numpy, args)
    wx.requires_grad_()
    fcl = tds.fused_convlstm
    before = (fcl.launches, fcl.train_launches, fcl.bwd_launches)
    if grad == 'on':
        ys = fcl(x, wx, bx, wh)
        assert isinstance(ys.grad_fn, FusedConvLSTM._backward_cls)
        ys.sum().backward()
        assert wx.grad is not None
    else:
        ctx = torch.no_grad() if grad == 'no_grad' else torch.inference_mode()
        with ctx:
            ys = fcl(x, wx, bx, wh)
        assert ys.grad_fn is None
    assert (fcl.launches, fcl.train_launches, fcl.bwd_launches) == before


@pytest.mark.parametrize('args,want', [
    # the width-8 training step's passes (Wx, Wh): a 16x16 frame a tile, two
    # tiles a block for about one wave of two blocks an SM; the stem's one
    # source channel makes block rows of one channel
    ((128, 4, 0, 16, 16, 1, 8, 5, 5), (16, 16, 2, 256, 1, 25, 1)),
    ((128, 4, 0, 16, 16, 8, 8, 5, 5), (16, 16, 2, 256, 8, 25, 1)),
    ((128, 4, 1, 16, 16, 8, 8, 3, 3), (16, 16, 2, 192, 8, 9, 1)),
    # width 64 (the route table's 'fused' timing): 64 chunks a pixel chunk
    ((128, 4, 1, 16, 16, 64, 64, 5, 5), (16, 16, 94, 5, 8, 25, 64)),
    # 7x7: 4 channels a chunk; 9x9: two tap chunks of 63 and 18 taps
    ((2, 2, 0, 19, 23, 8, 4, 7, 7), (11, 23, 1, 8, 4, 49, 2)),
    ((2, 2, 1, 12, 12, 8, 8, 9, 9), (12, 12, 1, 2, 4, 63, 4)),
    # ragged: 2 x 2 tiles of a 9x41 frame, 3 channels a chunk
    ((2, 1, 0, 9, 41, 3, 6, 1, 3), (8, 32, 1, 8, 3, 3, 1))])
def test_weight_gradient_plan(args, want):
    """Pixel tiles of at most 256 pixels of one frame, as many tiles a
    block as keeps about one wave of two blocks an SM, and block rows of at
    most 255 (tap, channel) pairs."""
    plan = _wgrad_plan(*args, n_sm=132)
    assert tuple(plan[k] for k in ('tph', 'tpw', 'tpb', 'n_chunks', 'cwc',
                                   'tpc', 'grid_y')) == want


@pytest.mark.parametrize('args', [
    (128, 4, 0, 16, 16, 1, 8, 5, 5), (128, 4, 1, 16, 16, 8, 8, 3, 3),
    (2, 2, 0, 19, 23, 8, 4, 7, 7), (2, 2, 1, 12, 12, 8, 8, 9, 9),
    (2, 3, 0, 20, 37, 5, 5, 3, 5), (2, 3, 0, 40, 40, 6, 12, 3, 3)])
def test_weight_gradient_plan_covers_every_term_once(args):
    """By the kernel's index map (`csrc/convlstm_bwd.cu` `wgrad_tile`):
    the block rows of grid.y (channel chunk, tap chunk, gate chunk) write
    every (tap, channel, gate) of the gradient, and with db (the Wx pass)
    every gate of db, exactly once; the rows, 2 m16 tiles a warp, fit the
    block's 8 warps; the blocks' tile ranges cover every pixel tile once."""
    b, t, t_skip, h, w, cs, f, kh, kw = args
    with_db = t_skip == 0
    plan = _wgrad_plan(*args, n_sm=132)
    cwc, tpc, f4 = plan['cwc'], plan['tpc'], 4 * f
    n_c, n_r = -(-cs // cwc), -(-(kh * kw) // tpc)
    assert plan['grid_y'] == n_c * n_r * -(-f4 // 32)
    rows = tpc * cwc + with_db
    groups = ((rows + 15) // 16 + 1) // 2   # warps of 2 m16 row tiles
    assert rows <= 256 and groups <= 8
    count = np.zeros((kh * kw, cs, f4), np.int64)
    db = np.zeros(f4, np.int64)
    for y in range(plan['grid_y']):
        cc_i, rc_i, gc_i = y % n_c, (y // n_c) % n_r, y // (n_c * n_r)
        c0, tap0, g0 = cc_i * cwc, rc_i * tpc, gc_i * 32
        cc, ntap, gn = (min(cwc, cs - c0), min(tpc, kh * kw - tap0),
                        min(32, f4 - g0))
        m = np.arange(groups * 2 * 16)
        tl, c = m // cwc, m % cwc
        stored = (m < ntap * cwc) & (c < cc)
        for g in range(g0, g0 + gn):
            np.add.at(count, (tap0 + tl[stored], c0 + c[stored], g), 1)
            if with_db and cc_i == 0 and rc_i == 0:
                db[g] += int((m == ntap * cwc).sum())
    assert (count == 1).all(), np.unique(count)
    if with_db:
        assert (db == 1).all()
    n_tiles = b * (t - t_skip) * -(-w // plan['tpw']) * -(-h // plan['tph'])
    tpb = plan['tpb']
    assert (plan['n_chunks'] - 1) * tpb < n_tiles <= plan['n_chunks'] * tpb


def _mm3(a, b, passes=3):
    from test_torch_convlstm import _mm_tf32
    return _mm_tf32(a, b, passes)


def _wgrad_emulated(src, dz, kh, kw, passes=3):
    """sum_p unfold(src)[p] dz[p] with the kernel's tensor-core products
    ((3x)TF32; `_mm_tf32`), and db as the product of a row of ones."""
    a = _unfold(src, kh, kw)
    dz = dz.reshape(a.shape[0], -1)
    dw = _mm3(a.t().contiguous(), dz, passes)
    return dw.view(kh, kw, src.shape[-1], dz.shape[-1]), _mm3(
        torch.ones(1, a.shape[0]), dz, passes)[0]


@pytest.mark.parametrize('cin,f,k', [(1, 8, 5), (8, 8, 3), (8, 8, 5),
                                     (1, 64, 5), (64, 64, 3), (64, 64, 5)])
def test_weight_gradient_3xtf32_arithmetic_keeps_float32_accuracy(cin, f, k):
    """K3's weight-gradient scheme, emulated on the CPU at the layer shapes
    of both training paths (T 4, 16x16, batch 2, Keras init, dz from the
    plain chain): dWx, db and dWh in 3xTF32 stay within K3's 1e-5 of max
    |ref| of the float32 plain version and of float64 on the same inputs,
    where plain TF32, one product, does not."""
    layer = ConvLSTM2D(cin, f, (k, k))
    layer.reset_parameters(torch.Generator().manual_seed(f + k))
    wx, bx, wh = (p.detach() for p in (layer.input_conv.kernel,
                                       layer.input_conv.bias,
                                       layer.cell.recurrent_conv.kernel))
    rng = np.random.default_rng(f + k)
    b, t = 2, 4
    x = torch.from_numpy(rng.standard_normal((b, t, 16, 16, cin)).astype(
        np.float32))
    dys = torch.from_numpy(rng.standard_normal((b, t, 16, 16, f)).astype(
        np.float32))
    ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    dzs = convlstm_seq_reference(zs, cs, dys, wh)
    srcs = (x.reshape(b * t, 16, 16, cin),
            ys[:, :-1].reshape(b * (t - 1), 16, 16, f))
    dzs_ = (dzs.reshape(b * t, 16, 16, 4 * f),
            dzs[:, 1:].reshape(b * (t - 1), 16, 16, 4 * f))
    want = {}
    for name, src, dz in (('dwx', srcs[0], dzs_[0]),
                          ('dwh', srcs[1], dzs_[1])):
        shape = (k, k, src.shape[-1], 4 * f)
        want[name] = (conv_same_w(src, dz, shape),
                      conv_same_w(src.double(), dz.double(), shape))
    want['dbx'] = (dzs_[0].sum(dim=(0, 1, 2)),
                   dzs_[0].double().sum(dim=(0, 1, 2)))
    errs = {}
    for passes in (3, 1):
        (dwx, dbx), (dwh, _) = (_wgrad_emulated(s, d, k, k, passes)
                                for s, d in zip(srcs, dzs_))
        for name, g in (('dwx', dwx), ('dbx', dbx), ('dwh', dwh)):
            w32, w64 = want[name]
            errs[name, passes] = max((g.double() - w64).abs().max().item(),
                                     (g - w32).abs().max().item()
                                     ) / w64.abs().max().item()
    assert all(errs[name, 3] <= 1e-5 for name in ('dwx', 'dbx', 'dwh')), errs
    assert max(errs['dwx', 1], errs['dwh', 1]) > 1e-5, errs


def test_backward_kernel_wrapper_guards():
    """The CUDA wrapper of K3 checks dtype and device before anything
    reaches the card."""
    from dl4ds_tpu_torch.ops.convlstm import _launch_backward
    args, dys = _inputs(GRAD_SHAPES[0])
    x, wx, bx, wh = map(torch.from_numpy, args)
    ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    res = (x, wx, wh, zs, cs, ys, torch.from_numpy(dys))
    with pytest.raises(TypeError, match='item 5'):
        _launch_backward(*(u.double() for u in res))
    with pytest.raises(ValueError, match='CUDA'):
        _launch_backward(*res)
