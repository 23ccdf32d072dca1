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
    dict(tile=32), dict(mesh=object()), dict(spatial_mesh=object()),
    dict(quantize='int8'), dict(pad_to_multiple=32),
    dict(time_metadata=np.arange(N).astype('datetime64[D]')),
    dict(time_metadata='auto'), dict(array_in_hr=False)])
def test_unported_predict_modes_raise(data, models, kwargs):
    hr = data[0]
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tds.predict(models[1], hr, scale=SCALE, device='cpu', **kwargs)


def test_predict_does_not_fall_back_to_the_cpu(data, models):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: predict() runs there')
    hr, topo, mask, pred = data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.predict(models[1], hr, scale=SCALE, static_vars=[topo, mask],
                    predictors=[pred])


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ('import sys, dl4ds_tpu_torch, dl4ds_tpu_torch.training\n'
            'bad = [m for m in sys.modules if m == "jax" or '
            'm.startswith(("jax.", "flax", "dl4ds_tpu.")) or '
            'm == "dl4ds_tpu"]\n'
            'assert not bad, bad\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
