"""PyTorch port of the ConvLSTM layer's split backward against the JAX
package on the CPU: K4's plain version (`convlstm_seq_reference`, the
sequential dh/dc chain) against the interpreted `_bwd_seq_kernel`
(`_seq_pallas`), the split route (the chain, then `convlstm_backward_tail`'s
float32 GEMMs) through `FusedConvLSTM` against `jax.grad` through the JAX
split backward (`_fused(..., split=True)`, interpreted) and through the XLA
layer, the two routes against each other, and the route table
`dispatch_info`. Inputs come from numpy; everything is float32. Tolerances as
tests/test_pallas_ops.py's split-backward test: dx 1e-5, weights and bias
1e-4; dzs 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu.ops.pallas_convlstm as jax_pallas_convlstm
import dl4ds_tpu_torch.ops.convlstm as conv
from dl4ds_tpu_torch.ops.convlstm import (FusedConvLSTM,
                                          convlstm_backward_reference,
                                          convlstm_seq_reference,
                                          convlstm_train_reference,
                                          dispatch_info)

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
    """The width thresholds (16 at 3x3 and smaller, 32 above), K4's
    largest kernel and the kernels that no route takes."""
    def route(f, kh=3, kw=3, cin=4):
        return dispatch_info((2, 3, 8, 8, cin), (kh, kw, cin, 4 * f),
                             (kh, kw, f, 4 * f))['path']
    assert [route(f) for f in (8, 15, 16, 32)] == ['fused', 'fused', 'split',
                                                   'split']
    assert [route(f, 5, 5) for f in (16, 31, 32, 64)] == [
        'fused', 'fused', 'split', 'split']
    assert route(16, 1, 3) == 'split'
    assert route(16, 3, 5) == 'fused'
    assert route(64, 7, 7) == 'split'
    assert route(64, 9, 9) == 'fused'
    assert route(64, 3, 5) == 'split'
    with pytest.raises(NotImplementedError, match='even'):
        route(64, 2, 2)
    with pytest.raises(ValueError, match='do not match'):
        dispatch_info((2, 3, 8, 8, 4), (3, 3, 4, 64), (5, 5, 16, 64))
    with pytest.raises(ValueError, match='do not match'):
        dispatch_info((2, 3, 8, 8, 4), (3, 3, 2, 64), (3, 3, 16, 64))


@pytest.mark.parametrize('f,forced,want', [(4, None, 'fused'),
                                           (32, None, 'split'),
                                           (4, 'split', 'split'),
                                           (32, 'fused', 'fused')])
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
