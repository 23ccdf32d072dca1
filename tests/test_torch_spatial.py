"""The port's spatial parallelism in one process, against the JAX package
on the CPU: K1's band mode (the plain versions of its stages, the partial
sums added as the all-reduce adds them) against JAX's
`channel_attention_reference` and `jax.vjp` on the whole image, f32 and
the bfloat16 mixed mode, on images cut into 2 and 3 bands; the band
mode's launch plan; a one-rank ('space',) and ('data', 'space') mesh,
which still routes every rule (the card's count), against the run
without a mesh; the exchanges at one rank; and the refusals, mirroring
the JAX package's (the multi-rank cases are
tests/test_torch_distributed_spatial.py's)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ds_tpu.ops.pallas_ops import (
    channel_attention_reference as jax_channel_attention)

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import app, distributed, parallel
from dl4ds_tpu_torch.models import blocks
from dl4ds_tpu_torch.ops import fused_ops as fo
from _torch_dp_worker import free_port
from _torch_xla import quick_xla  # noqa: F401

BF = torch.bfloat16
BF16_TOL, F32_TOL = 1e-2, 1e-5     # tests/test_torch_bf16.py's K1 tolerances


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _gate_args(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    cr = max(c // 4, 1)
    return (rng.standard_normal(shape).astype(np.float32),
            [(0.5 * rng.standard_normal((c, cr))).astype(np.float32),
             (0.1 * rng.standard_normal(cr)).astype(np.float32),
             (0.5 * rng.standard_normal((cr, c))).astype(np.float32),
             (0.1 * rng.standard_normal(c)).astype(np.float32)],
            rng.standard_normal(shape).astype(np.float32))


def _band_gate(x, ws, dy, n, mixed):
    """K1's band mode on x cut into n bands of rows, the stages' partial
    sums and dm added where the ranks' all-reduces add them: (y, dx, dw1,
    db1, dw2, db2) of the whole image."""
    hw = x.shape[1] * x.shape[2]
    xs, dys = x.chunk(n, dim=1), dy.chunk(n, dim=1)
    sums = sum(fo.ca_band_sums(b) for b in xs)
    outs = [fo.ca_band_apply(b, sums, hw, *ws, mixed) for b in xs]
    _, m, g = outs[0]
    parts = [fo.ca_band_grads(b, *ws, d, m, g, mixed)
             for b, d in zip(xs, dys)]
    dm = sum(p[0] for p in parts)
    dx = torch.cat([fo.ca_band_dx(b, d, g, dm, hw, mixed)
                    for b, d in zip(xs, dys)], dim=1)
    dws = [sum(p[k] for p in parts) for k in range(1, 5)]
    return (torch.cat([o[0] for o in outs], dim=1), dx, *dws)


@pytest.mark.parametrize('mode', ['f32', 'mixed'])
@pytest.mark.parametrize('n', [2, 3])
@pytest.mark.parametrize('shape', [(3, 6, 5, 8), (2, 12, 7, 12)])
def test_k1_band_mode_matches_jax(shape, n, mode):
    """(a) y and the five gradients of the band stages against JAX's gate
    and its VJP on the whole image: f32 within 1e-5 (the existing K1
    tests'); mixed (bfloat16 x, float32 y and dy, run eagerly in JAX) y,
    db1 and db2 within 1e-5 of max |ref|, dx, dw1 and dw2 within 1e-2 (2
    bfloat16 ulps; the bands' dw1 and dw2 are rounded before they are
    summed)."""
    x, ws, dy = _gate_args(shape, sum(shape) + n)
    mixed = mode == 'mixed'
    xj = jnp.asarray(x).astype(jnp.bfloat16) if mixed else jnp.asarray(x)
    y, vjp = jax.vjp(jax_channel_attention, xj, *map(jnp.asarray, ws))
    want = [y] + list(vjp(jnp.asarray(dy).astype(y.dtype)))
    xt = torch.from_numpy(x).to(BF) if mixed else torch.from_numpy(x)
    dyt = torch.from_numpy(dy)
    got = _band_gate(xt, [torch.from_numpy(w) for w in ws],
                     dyt if mixed else dyt.to(xt.dtype), n, mixed)
    assert got[0].dtype == torch.float32 and got[1].dtype == xt.dtype
    for name, g, r in zip(('y', 'dx', 'dw1', 'db1', 'dw2', 'db2'), got,
                          want):
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        if not mixed:
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
            continue
        tol = F32_TOL if name in ('y', 'db1', 'db2') else BF16_TOL
        assert np.abs(g - r).max() / np.abs(r).max() <= tol, name


def test_k1_fused_backward_is_the_band_stages_at_one_band():
    """The fused mode's plain backward is `_partial_grads` then `_dx_of`:
    one band's stages give its gradients bit for bit."""
    x, ws, dy = _gate_args((2, 5, 4, 8), 9)
    x, dy = torch.from_numpy(x), torch.from_numpy(dy)
    ws = [torch.from_numpy(w) for w in ws]
    want = fo._channel_attention_backward(x, *ws, dy)
    hw = x.shape[1] * x.shape[2]
    _, m, g = fo._plain_forward(x, *ws)
    dm, *dws = fo.ca_band_grads(x, *ws, dy, m, g)
    got = (fo.ca_band_dx(x, dy, g, dm, hw), *dws)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize('shape', [(128, 16, 16, 8), (8, 64, 128, 48),
                                   (16, 3, 5, 7)])
def test_band_plan_is_the_stream_regime_and_covers_every_pixel(shape):
    """The band mode always cuts a band the stream regime's way, even one
    that a block would hold; the chunks cover its pixels once."""
    for dtype in (torch.float32, BF):
        plan = fo._ca_plan(shape, max(shape[-1] // 4, 1), dtype, 132,
                           232448 - fo._STATIC_SMEM_RESERVE, band=True)
        assert plan['regime'] == 'stream'
        hw = shape[1] * shape[2]
        assert (plan['parts'] - 1) * plan['ppp'] < hw \
            <= plan['parts'] * plan['ppp']
        assert plan['bwd_region'] >= 4 * (2 * shape[-1] + 2)


@pytest.fixture
def one_rank():
    """A gloo group of one rank in the test process, destroyed after."""
    distributed.initialize(f'127.0.0.1:{free_port()}', 1, 0, device='cpu',
                           timeout=60)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def _counting(monkeypatch, names):
    """Count the calls of `blocks`' functions `names`."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(blocks, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(blocks, name, counted)
    return calls


@pytest.mark.parametrize('dims', [('space',), ('data', 'space')])
def test_one_rank_space_mesh_routes_every_rule(one_rank, monkeypatch, dims):
    """A 'space' dim of one rank still routes every rule (the halo rows of
    each 3x3 conv, K1's band mode, the replicate rule of the 'rc' head):
    run() then equals the run without a mesh within float32's sum order
    (rtol 1e-5), the batch and the rate unscaled."""
    hr = np.random.default_rng(3).standard_normal(
        (12, 16, 16, 1)).astype(np.float32)
    args = dict(data_train=hr, data_val=hr[:4], data_test=hr[:4],
                scale=4, patch_size=8, batch_size=2, epochs=2,
                steps_per_epoch=2, validation_steps=1, test_steps=1,
                n_filters=4, n_blocks=1, attention=True, loss='mae',
                device='cpu', verbose=False)
    plain = tds.SupervisedTrainer('resnet', 'rc', **args).run()
    calls = _counting(monkeypatch, ['halo_rows', 'gather_rows',
                                    'fused_channel_attention_band'])
    mesh = distributed.spatial_mesh(1, 1 if len(dims) == 2 else None)
    assert mesh.mesh_dim_names == dims
    sp = tds.SupervisedTrainer('resnet', 'rc', mesh=mesh, **args).run()
    assert sp.n_space == 1 and sp.global_batch_size == 2
    assert all(n > 0 for n in calls.values()), calls
    np.testing.assert_allclose(
        sp.fithist['loss'] + sp.fithist['val_loss'] + [sp.test_loss],
        plain.fithist['loss'] + plain.fithist['val_loss']
        + [plain.test_loss], rtol=1e-5)


def test_exchanges_at_one_rank(one_rank):
    """At one rank the halos are zeros and the joined rows the band; a
    band shorter than its halo raises."""
    group = distributed.spatial_mesh().get_group('space')
    x = torch.arange(24.0).reshape(1, 3, 4, 2).requires_grad_()
    above, below = distributed.halo_rows(x, 2, group)
    assert above.abs().sum() == 0 and below.abs().sum() == 0
    assert above.shape == (1, 2, 4, 2)
    joined = distributed.gather_rows(x, group)
    assert torch.equal(joined, x)
    joined.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    with pytest.raises(ValueError, match='shorter than the halo'):
        distributed.halo_rows(x, 4, group)
    with distributed.space_group(group):
        with pytest.raises(ValueError, match='stride 2'):
            blocks.Conv(2, 2, (3, 3), strides=2)(x.detach())
        d = tds.models.nets.ResidualDiscriminator(1, 'spc', False, 4, (4, 4))
        with pytest.raises(NotImplementedError, match='no band rule'):
            d(torch.zeros(1, 4, 4, 1), torch.zeros(1, 16, 16, 1))


def _stand_in(names, device_type='cpu'):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 device_type=device_type)


def _trainer(cls=tds.SupervisedTrainer, **kw):
    hr = np.zeros((8, 16, 16, 1), np.float32)
    if cls is tds.CGANTrainer:
        return cls('resnet', 'spc', hr, hr, scale=4, device='cpu', **kw)
    return cls('convnet', 'pin', hr, hr, hr, scale=4, batch_size=2,
               n_filters=2, n_blocks=1, verbose=False, device='cpu', **kw)


def test_trainer_mesh_refusals(one_rank):
    """(f) 'model' with 'space' is the JAX trainer's "ONE of" ValueError, an
    unknown dim a ValueError, 'model' beside 'data' or alone (tensor
    parallelism, ported: tests/test_torch_tensor_parallel.py) a trainer
    with a 'model' group, and the CGAN trainer refuses 'space' as the JAX
    one does."""
    with pytest.raises(ValueError, match='ONE of'):
        _trainer(mesh=_stand_in(('data', 'model', 'space')))
    with pytest.raises(ValueError, match='ONE of'):
        _trainer(mesh=_stand_in(('model', 'space')))
    with pytest.raises(ValueError, match="one dim 'data'"):
        _trainer(mesh=_stand_in(('data', 'rows')))
    for mesh in (distributed.tensor_mesh(1, 1), distributed.tensor_mesh(1)):
        tr = _trainer(mesh=mesh)
        assert tr.model_group is not None and tr.space_group is None
        assert tr.global_batch_size == tr.batch_size
    for dims in (('data', 'space'), ('space',)):
        with pytest.raises(NotImplementedError,
                           match='routed through SupervisedTrainer'):
            _trainer(tds.CGANTrainer, mesh=_stand_in(dims))


def test_app_mesh_shape_refusals(monkeypatch):
    """(f) `--mesh_shape`: a 'model' axis is ported, and beside 'space' it
    is the JAX trainer's "ONE of" ValueError; an unknown axis raises, and
    data x space (or x model) must be the launch's process count."""
    with pytest.raises(ValueError, match='ONE of'):
        app._parse_mesh_shape('data=1,space=2,model=2', 'cpu')
    with pytest.raises(ValueError, match="'data', 'space' and 'model'"):
        app._parse_mesh_shape('data=1,rows=2', 'cpu')
    monkeypatch.setenv('WORLD_SIZE', '1')
    with pytest.raises(ValueError, match='needs 2 processes'):
        app._parse_mesh_shape('data=1,model=2', 'cpu')
    with pytest.raises(ValueError, match='needs 2 processes'):
        app._parse_mesh_shape('data=1,space=2', 'cpu')
    with pytest.raises(ValueError, match='needs 4 processes'):
        app._parse_mesh_shape('space=4', 'cpu')


@pytest.fixture(scope='module')
def served():
    """A spatial model with an aux branch and a recurrent one, with their
    inputs."""
    kw = dict(backbone='resnet', upsampling='spc', scale=4, n_filters=2,
              n_blocks=1, lr_size=(4, 4), hr_size=(16, 16), n_channels=1)
    aux = tds.models.build_model(n_aux_channels=1, **kw)
    rec = tds.models.build_model(n_aux_channels=0, time_window=2, **kw)
    hr = np.random.default_rng(0).standard_normal(
        (4, 16, 16, 1)).astype(np.float32)
    return ((aux, aux.init(0, device='cpu')), (rec, rec.init(0,
                                                             device='cpu')),
            hr)


@pytest.mark.parametrize('kwargs, err, match', [
    (dict(quantize='int8'), ValueError, 'does not combine with spatial'),
    (dict(mesh=object()), ValueError, 'not both'),
    (dict(pad_to_multiple=8), ValueError, 'pad_to_multiple'),
    (dict(), ValueError, 'aux inputs'),
    (dict(recurrent=True), ValueError, 'spatial models only')])
def test_predict_spatial_mesh_refusals(served, kwargs, err, match):
    """(f) `predict(spatial_mesh=)` refuses quantize, a data mesh beside
    it, pad_to_multiple, an aux input and 5-D (spatio-temporal) input, as
    the JAX package does (dl4ds_tpu/inference.py:239-241, 273-293)."""
    aux_pair, rec_pair, hr = served
    recurrent = kwargs.pop('recurrent', False)
    pair = rec_pair if recurrent else aux_pair
    extra = (dict(time_window=2) if recurrent
             else dict(static_vars=[hr[0, ..., 0]]))
    with pytest.raises(err, match=match):
        tds.predict(pair, hr, scale=4, device='cpu', spatial_mesh=object(),
                    **extra, **kwargs)


def test_spatial_step_refusals(one_rank):
    """(f) the standalone step takes the sum-decomposable losses, no aux
    input and a mesh with a 'space' dim (dl4ds_tpu/parallel.py:300-312);
    its batch and band checks (:348-366)."""
    kw = dict(scale=2, n_channels=1, lr_size=(8, 8), hr_size=(16, 16),
              n_filters=2, n_blocks=1)
    model = tds.models.build_model('resnet', 'spc', n_aux_channels=0, **kw)
    aux = tds.models.build_model('resnet', 'spc', n_aux_channels=1, **kw)
    mesh = distributed.spatial_mesh()
    with pytest.raises(ValueError, match='sum-decomposable'):
        parallel.make_spatial_sharded_step(model, mesh, loss='dssim')
    with pytest.raises(ValueError, match='aux-input'):
        parallel.make_spatial_sharded_step(aux, mesh)
    with pytest.raises(ValueError, match="no 'space' axis"):
        parallel.make_spatial_sharded_step(model, distributed.global_mesh())
    step = parallel.make_spatial_sharded_step(model, mesh, halo=2)
    params = {k: v.detach().clone() for k, v in
              model.init(0, device='cpu').named_parameters()}
    x = np.zeros((2, 8, 8, 1), np.float32)
    with pytest.raises(ValueError, match='4-D'):
        step.loss_and_grads(params, x[:, None], x[:, None], 0)
    with pytest.raises(ValueError, match='target rows'):
        step.loss_and_grads(params, x, np.zeros((2, 8, 16, 1)), 0)
    loss, grads = step.loss_and_grads(params, x, np.zeros((2, 16, 16, 1)),
                                      0)
    assert np.isfinite(float(loss)) and set(grads) == set(params)
    with pytest.raises(ValueError, match='init_opt'):
        step.step(params, parallel._adam(list(params.values())[:1]), x,
                  np.zeros((2, 16, 16, 1)), 0)
