"""PyTorch port `predict` and batch synthesis against the JAX package on the
CPU, and the port's isolation from JAX. Small size: 64x64 HR grids (16x16
LR at scale 4), n_filters=4, n_blocks=2, float32."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
import dl4ds_tpu_torch as tds
from _torch_xla import quick_xla  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HR, SCALE, N = 64, 4, 5
SMALL = dict(scale=SCALE, n_channels=4, n_aux_channels=2,
             lr_size=(HR // SCALE, HR // SCALE), n_filters=4, n_blocks=2,
             attention=True)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(11)
    hr = rng.standard_normal((N, HR, HR)).astype(np.float32)
    topo = rng.standard_normal((HR, HR)).astype(np.float32)
    mask = (rng.random((HR, HR)) > 0.5).astype(np.float32)
    pred = rng.standard_normal((N, HR, HR, 1)).astype(np.float32)
    return hr, topo, mask, pred


@pytest.fixture(scope='module')
def models():
    jm = dds.net_postupsampling('resnet', 'spc', **SMALL)
    variables = jm.init(jax.random.PRNGKey(5))
    tm = tds.net_postupsampling('resnet', 'spc', **SMALL)
    net = tds.load_jax_params(tm.init(0, device='cpu'),
                              jax.tree_util.tree_map(np.asarray,
                                                     variables['params']))
    return (jm, variables), (tm, net)


class _Affine:
    def inverse_transform(self, a):
        return 2.0 * a + 1.0


def test_predict_matches_jax_with_statics_predictor_and_ragged_tail(
        data, models):
    hr, topo, mask, pred = data
    kw = dict(scale=SCALE, array_in_hr=True, static_vars=[topo, mask],
              predictors=[pred], batch_size=3)     # 5 grids: a tail of 2
    want = dds.predict(models[0], hr, **kw)
    got = tds.predict(models[1], hr, device='cpu', **kw)
    assert isinstance(got, np.ndarray)
    assert got.shape == want.shape == (N, HR, HR, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_predict_scaler_and_return_lr_match_jax(data, models):
    hr, topo, mask, pred = data
    kw = dict(scale=SCALE, static_vars=[topo, mask], predictors=[pred],
              batch_size=2, scaler=_Affine(), return_lr=True)
    want, want_lr = dds.predict(models[0], hr, **kw)
    got, got_lr = tds.predict(models[1], hr, device='cpu', **kw)
    np.testing.assert_allclose(got_lr, np.asarray(want_lr), atol=1e-5)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_predictor_run_saves_what_predict_returns(data, models, tmp_path):
    hr, topo, mask, pred = data
    kw = dict(scale=SCALE, array_in_hr=True, static_vars=[topo, mask],
              predictors=[pred], batch_size=4, device='cpu')
    y = tds.Predictor(models[1], hr, save_path=str(tmp_path), **kw).run()
    np.testing.assert_array_equal(np.load(tmp_path / 'y_hat.npy'), y)
    np.testing.assert_array_equal(tds.predict(models[1], hr, **kw), y)


def test_batch_synthesizer_matches_jax(data):
    hr, topo, mask, pred = data
    kw = dict(upsampling='spc', scale=SCALE, batch_size=N,
              static_vars=[topo, mask], predictors=[pred])
    want = dds.BatchSynthesizer(hr[..., None], None, **kw)(
        jax.numpy.arange(N), jax.random.PRNGKey(0))
    synth = tds.BatchSynthesizer(hr[..., None], None, device='cpu', **kw)
    got = synth(torch.arange(N))
    assert synth.n_channels_lr == 4 and synth.n_channels_aux == 2
    for key in ('lr', 'hr', 'aux'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize('kwargs', [
    dict(tile=32, mesh=object()), dict(mesh=object()),
    dict(spatial_mesh=object()),
    dict(quantize='int8'), dict(tile=32, halo=8, quantize='int8'),
    dict(spatial_mesh=object(), halo=8),
    dict(quantize='int8', calibration_quantile=0.999),
    dict(quantize='int8', calibration=np.zeros((2, 16, 16, 4), np.float32))])
def test_unported_predict_modes_raise(data, models, kwargs):
    """`spatial_mesh` (`halo` with it) has been ported (compared with the
    JAX package in tests/test_torch_distributed_spatial.py): this model's
    aux input is the JAX package's ValueError. `mesh`, tiled or not, has
    been ported too (compared with the
    JAX package on a 2-device mesh in
    tests/test_torch_distributed_serving.py): a mesh that is not a
    DeviceMesh is a TypeError. Int8 serving (tiled or not, the
    `calibration*` arguments with it) has been ported too: those cases now
    serve the model, or raise the JAX package's ValueError where the aux
    model gets no `calibration_aux` (compared with the JAX package in
    tests/test_torch_quantization.py)."""
    hr, topo, mask, pred = data
    if 'spatial_mesh' in kwargs:
        with pytest.raises(ValueError, match='aux inputs'):
            tds.predict(models[1], hr, scale=SCALE, static_vars=[topo, mask],
                        predictors=[pred], device='cpu', **kwargs)
        return
    if 'quantize' not in kwargs:
        with pytest.raises(TypeError, match='DeviceMesh'):
            tds.predict(models[1], hr, scale=SCALE, device='cpu', **kwargs)
        return
    kw = dict(scale=SCALE, static_vars=[topo, mask], predictors=[pred],
              batch_size=2, device='cpu', **kwargs)
    if 'calibration' in kwargs:
        with pytest.raises(ValueError, match='calibration_aux'):
            tds.predict(models[1], hr, **kw)
        return
    y = tds.predict(models[1], hr, **kw)
    assert y.shape == (N, HR, HR, 1) and np.isfinite(y).all()


def _parameters(fn):
    import inspect
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize('name', ['predict', 'Predictor'])
def test_signatures_equal_the_jax_ones(name):
    """`predict` and `Predictor` take the JAX package's parameters, in its
    order and with its defaults, `device`'s default ('cuda') apart: a
    positional call means the same in both."""
    jax_fn, port_fn = getattr(dds, name), getattr(tds, name)
    if name == 'Predictor':
        jax_fn, port_fn = jax_fn.__init__, port_fn.__init__
    want = [p if p[0] != 'device' else p[:2] + ('cuda',)
            for p in _parameters(jax_fn)]
    assert _parameters(port_fn) == want


def test_unused_options_do_nothing_and_calibration_needs_quantize(
        data, models):
    """`halo` and `calibration_quantile` take effect only with tiling or
    quantization, and do nothing without; a calibration batch without
    `quantize` is the JAX package's ValueError."""
    hr, topo, mask, pred = data
    kw = dict(scale=SCALE, static_vars=[topo, mask], predictors=[pred],
              batch_size=3, device='cpu')
    plain = tds.predict(models[1], hr, **kw)
    np.testing.assert_array_equal(
        tds.predict(models[1], hr, halo=4, calibration_quantile=0.9, **kw),
        plain)
    for extra in (dict(calibration=np.zeros((1, 16, 16, 4), np.float32)),
                  dict(calibration_aux=np.zeros((1, 64, 64, 2),
                                                np.float32))):
        with pytest.raises(ValueError, match='quantize'):
            dds.predict(models[0], hr, **dict(kw, device='TPU', **extra))
        with pytest.raises(ValueError, match='quantize'):
            tds.predict(models[1], hr, **kw, **extra)


def test_predict_does_not_fall_back_to_the_cpu(data, models):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: predict() runs there')
    hr, topo, mask, pred = data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.predict(models[1], hr, scale=SCALE, static_vars=[topo, mask],
                    predictors=[pred])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ('import sys, dl4ds_tpu_torch, dl4ds_tpu_torch.training, '
            'dl4ds_tpu_torch.losses, dl4ds_tpu_torch.ops.ssim\n'
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "flax", "dl4ds_tpu.")) or '
            'm == "dl4ds_tpu"]\n'
            'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# predict's model resolution and mode, and the factory's keywords
# ---------------------------------------------------------------------------

def _trained(hr, **kwargs):
    """A port SupervisedTrainer after two Adam steps on the CPU."""
    tr = tds.SupervisedTrainer(
        'resnet', 'spc', data_train=hr[..., None], data_val=hr[:2, ..., None],
        data_test=hr[:2, ..., None], scale=SCALE, patch_size=16,
        batch_size=2, epochs=1, steps_per_epoch=2, validation_steps=1,
        test_steps=1, n_filters=4, n_blocks=1, attention=True, device='cpu',
        verbose=False, **kwargs)
    return tr.run()


def test_predict_takes_a_trained_trainer(data):
    """As the JAX `_resolve_model` takes a trainer's `.model` and
    `.variables` (dl4ds_tpu/inference.py:83-93), the port's takes its
    `.model` and `.net`: the same bits as the (model, net) pair."""
    hr = data[0]
    tr = _trained(hr)
    assert tr.n_updates == 2
    kw = dict(scale=SCALE, batch_size=2, device='cpu')
    got = tds.predict(tr, hr, **kw)
    want = tds.predict((tr.model, tr.net), hr, **kw)
    assert got.shape == (N, HR, HR, 1)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError, match='trainer'):
        tds.predict(object(), hr, **kw)


def test_predict_runs_the_net_in_eval_mode_and_restores_its_mode(
        data, models):
    """JAX applies the model with training=False
    (dl4ds_tpu/inference.py:349-350): the port's predict runs the net in
    eval mode and gives it back in the mode it was given."""
    hr, topo, mask, pred = data
    net = models[1][1]
    seen = []
    hook = net.register_forward_hook(
        lambda module, args, out: seen.append(module.training))
    kw = dict(scale=SCALE, static_vars=[topo, mask], predictors=[pred],
              batch_size=3, device='cpu')
    try:
        for mode in (True, False):
            net.train(mode)
            tds.predict(models[1], hr, **kw)
            assert net.training is mode
            assert all(m.training is mode for m in net.modules())
    finally:
        hook.remove()
        net.eval()
    assert seen == [False] * 4           # two batches a call


def test_net_postupsampling_takes_rc_interpolation_and_remat(data):
    """The JAX signature's `rc_interpolation` and `remat`
    (dl4ds_tpu/models/__init__.py:77-84): both accepted, remat=True builds
    the same parameters with its backbone recomputing its blocks, and the
    trainer passes rc_interpolation through to the factory."""
    args = dict(SMALL, n_blocks=1)
    plain = tds.net_postupsampling('resnet', 'spc', **args)
    model = tds.net_postupsampling('resnet', 'spc', rc_interpolation='nearest',
                                   remat=False, **args)
    assert model.name == plain.name == 'resnet_spc'
    assert model.param_count(model.init(0, device='cpu')) == \
        plain.param_count(plain.init(0, device='cpu'))
    remat = tds.net_postupsampling('resnet', 'spc', remat=True, **args)
    net = remat.init(0, device='cpu')
    assert net._Backbone_0.remat and remat.config['remat']
    assert model.param_count(net) == plain.param_count(
        plain.init(0, device='cpu'))
    tr = _trained(data[0], rc_interpolation='bilinear')
    assert tr.model.name == 'resnet_spc' and tr.net is not None
