"""The port's MOS path against the JAX package on the CPU: training from
given LR arrays with season channels and serving LR grids.

- Two Adam steps of a small MOS trainer (given LR, statics, a predictor,
  seasons from `time_metadata`; spatial with attention and recurrent),
  from carried weights on the JAX trainer's batches, against the JAX
  trainer's `_train_step_batch`: losses rtol 1e-5, parameters atol
  `PARAM_ATOL` (2e-6, as `tests/test_torch_training.py`).
- The trainers' checks of the given LR arrays and the season options, and a
  whole MOS `run()`.
- `predict(array_in_hr=False, time_metadata=..., scaler=...)`, the default
  `Predictor(...).run()` and the recurrent model against the JAX `predict`
  (atol 2e-4, rtol 1e-4, as `tests/test_torch_inference.py` holds
  `predict`), `pad_to_multiple` against the JAX package's padded output
  (atol/rtol 1e-4), and `predict`'s checks of the time metadata.
Small sizes, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from _torch_xla import quick_xla  # noqa: F401

HR_Y, HR_X, SCALE, PATCH = 32, 40, 4, 16
LR_Y, LR_X = HR_Y // SCALE, HR_X // SCALE
N = 12
PARAM_ATOL = 2e-6
DAYS = np.arange('2000-02-24', '2000-03-07', dtype='datetime64[D]')
SPATIAL = dict(backbone='resnet', upsampling='spc', scale=SCALE,
               patch_size=PATCH, batch_size=2, n_blocks=1, n_filters=4,
               attention=True, loss='mae', verbose=False)
RECURRENT = dict(SPATIAL, time_window=3, attention=False)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def data():
    """HR grids, LR grids that are not the coarsened HR ones, two statics
    at HR and a predictor at LR."""
    rng = np.random.default_rng(31)
    hr = rng.standard_normal((N, HR_Y, HR_X, 1)).astype(np.float32)
    lr = rng.standard_normal((N, LR_Y, LR_X, 1)).astype(np.float32)
    topo = rng.standard_normal((HR_Y, HR_X)).astype(np.float32)
    mask = (rng.random((HR_Y, HR_X)) > 0.5).astype(np.float32)
    pred = rng.standard_normal((N, LR_Y, LR_X, 1)).astype(np.float32)
    return hr, lr, topo, mask, pred


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _mos_config(data, config):
    hr, lr, topo, mask, pred = data
    return dict(config, data_train=hr, data_val=hr[:8], data_test=hr[:8],
                data_train_lr=lr, data_val_lr=lr[:8], data_test_lr=lr[:8],
                static_vars=[topo, mask], predictors_train=[pred],
                predictors_val=[pred[:8]], predictors_test=[pred[:8]],
                time_metadata=(DAYS, DAYS[:8], DAYS[:8]))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('config', [SPATIAL, RECURRENT],
                         ids=['spatial', 'recurrent'])
def test_mos_adam_steps_match_the_jax_trainer(data, config):
    """Two Adam steps on the JAX trainer's MOS batches (the LR crop of the
    given array, the statics, the predictor, the season of the batch's
    samples, which changes from winter to spring in DAYS) from the same
    weights."""
    args = _mos_config(data, config)
    # one device: the tests' 8 host devices would scale the rate by 8
    jtr = jax_supervised.SupervisedTrainer(
        save=False, learning_rate=1e-3, devices=jax.devices()[:1], **args)
    jtr.setup_datagen()
    jtr.setup_model()
    params0 = _copy_tree(jtr.variables['params'])
    state = jax_supervised.TrainState.create(
        apply_fn=jtr.model.module.apply, params=jtr.variables['params'],
        tx=jtr._build_optimizer())
    jtr._make_steps()
    batches, losses = [], []
    for i, idx in enumerate(([0, 7], [5, 2])):
        key = jax.random.PRNGKey(i)
        batch = jtr.ds_train._make_batch(jnp.asarray(idx), key)
        batches.append({k: (None if v is None else np.array(v))
                        for k, v in batch.items()})
        state, loss = jtr._train_step_batch(state, batch, key)
        losses.append(float(loss))
    seasons = {int(np.argmax(b['aux'][j, 0, 0, -4:]))
               for b in batches for j in range(2)}
    assert seasons == {0, 1}

    tr = tds.SupervisedTrainer(learning_rate=1e-3, device='cpu', **args)
    tr.setup_model()
    assert tr.model.input_shape == jtr.model.input_shape
    assert tr.model.aux_shape == jtr.model.aux_shape
    tds.load_jax_params(tr.net, params0)
    tr.setup_optimizer()
    tr.net.train()
    got = [tr.train_step({k: None if v is None else torch.from_numpy(v)
                          for k, v in b.items()}).item() for b in batches]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    want = tds.load_jax_params(tr.model.init(0, device='cpu'),
                               _copy_tree(state.params))
    params = dict(tr.net.named_parameters())
    for name, p in want.named_parameters():
        np.testing.assert_allclose(params[name].detach().numpy(),
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


def test_mos_run_takes_every_split_from_its_lr_array(data):
    """A whole MOS run; each split's synthesizer holds its LR array and
    season table, and the LR input has 1 + 1 + 2 + 4 channels, aux 2 + 4."""
    tr = tds.SupervisedTrainer(
        device='cpu', epochs=2, steps_per_epoch=2, validation_steps=1,
        test_steps=1, **_mos_config(data, SPATIAL)).run()
    assert np.isfinite(tr.test_loss)
    assert all(np.isfinite(tr.fithist['loss'] + tr.fithist['val_loss']))
    assert tr.model.input_shape[-1] == 8 and tr.model.aux_shape[-1] == 6
    for synth, lr in ((tr.ds_train, data[1]), (tr.ds_val, data[1][:8]),
                      (tr.ds_test, data[1][:8])):
        np.testing.assert_array_equal(synth.lr.numpy(), lr)
        assert synth.n_channels_lr == 8 and synth.n_channels_aux == 6
    np.testing.assert_array_equal(
        tr.ds_train.season_ids.numpy(),
        dds.dataloader.season_ids_from_time(DAYS))


@pytest.mark.parametrize('config', [SPATIAL, RECURRENT],
                         ids=['spatial', 'recurrent'])
def test_channel_counts_count_the_seasons_as_jax(data, config):
    hr = data[0]
    args = dict(config, data_train=hr, data_val=hr, data_test=hr)
    jtr = jax_supervised.SupervisedTrainer(devices=jax.devices()[:1],
                                           **args)
    tr = tds.SupervisedTrainer(device='cpu', **args)
    for preds, statics, seasons in ((None, None, None), ([1], None, None),
                                    ([1, 2], [1, 2, 3], None),
                                    (None, [1], (1, 1, 1)),
                                    ([1], [1, 2], (1, 1, 1))):
        assert (tr.channel_counts(preds, statics, seasons)
                == jtr.channel_counts(preds, statics, seasons))


@pytest.mark.parametrize('kwargs,error', [
    (dict(data_train_lr='lr[:5]'), 'same number of samples'),
    (dict(data_train_lr='lr[..., 0]'), 'at least 4D'),
    (dict(data_train_lr='lr[:, :4]'), 'Wrong `scale`'),
    (dict(season_ids=([0],)), 'season_ids'),
    (dict(season_ids=([0], [0], [0]), time_metadata=(DAYS,) * 3),
     'not both'),
    (dict(time_metadata='auto'), 'xr.DataArrays'),
    (dict(time_metadata='yearly'), 'unknown time_metadata'),
    (dict(time_metadata=DAYS), 'tuple')])
def test_mos_trainer_checks_match_jax(data, kwargs, error):
    """The given LR array's and the season options' errors, which the JAX
    trainer raises with the same words."""
    hr, lr = data[:2]
    kwargs = {k: (eval(v, {'lr': lr}) if isinstance(v, str)
                  and v.startswith('lr') else v) for k, v in kwargs.items()}
    args = dict(SPATIAL, data_train=hr, data_val=hr, data_test=hr, **kwargs)
    with pytest.raises(ValueError, match=error):
        jax_supervised.SupervisedTrainer(devices=jax.devices()[:1], **args)
    with pytest.raises(ValueError, match=error):
        tds.SupervisedTrainer(device='cpu', **args)


# ---------------------------------------------------------------------------
# Serving LR grids
# ---------------------------------------------------------------------------

def _models(n_channels, n_aux, recurrent=False, seed=3):
    lr_size = (LR_Y, LR_X)
    if recurrent:
        spec = dict(scale=SCALE, n_channels=n_channels, n_aux_channels=n_aux,
                    lr_size=lr_size, time_window=3, n_filters=4, n_blocks=1)
        jm = dds.recnet_postupsampling('resnet', 'spc', **spec)
        tm = tds.recnet_postupsampling('resnet', 'spc', **spec)
    else:
        spec = dict(scale=SCALE, n_channels=n_channels, n_aux_channels=n_aux,
                    lr_size=lr_size, n_filters=4, n_blocks=1,
                    attention=True)
        jm = dds.net_postupsampling('resnet', 'spc', **spec)
        tm = tds.net_postupsampling('resnet', 'spc', **spec)
    variables = jm.init(jax.random.PRNGKey(seed))
    net = tds.load_jax_params(tm.init(0, device='cpu'), jax.tree_util.tree_map(
        np.asarray, variables['params']))
    return (jm, variables), (tm, net)


class _Affine:
    def inverse_transform(self, a):
        return 2.0 * a + 1.0


@pytest.fixture(scope='module')
def season_models():
    # LR, the predictor, two statics and the season: 8 channels; aux 6
    return _models(8, 6)


def test_predict_lr_grids_with_seasons_matches_jax(data, season_models):
    hr, lr, topo, mask, pred = data
    kw = dict(scale=SCALE, array_in_hr=False, static_vars=[topo, mask],
              predictors=[pred], time_metadata=DAYS, batch_size=5,
              scaler=_Affine(), return_lr=True)
    want, want_lr = dds.predict(season_models[0], lr, **kw)
    got, got_lr = tds.predict(season_models[1], lr, device='cpu', **kw)
    assert got.shape == want.shape == (N, HR_Y, HR_X, 1)
    np.testing.assert_allclose(got_lr, np.asarray(want_lr), atol=1e-5)
    # the LR input is the given grids, and the season channels are
    # DAYS' seasons: winter, then spring from March on
    np.testing.assert_array_equal(got_lr[..., 0], lr[..., 0])
    np.testing.assert_array_equal(
        got_lr[:, 0, 0, -4:].argmax(-1),
        dds.dataloader.season_ids_from_time(DAYS))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_predictor_defaults_to_lr_grids_as_jax(data, season_models):
    """`Predictor` takes `array` as the LR input unless told otherwise; its
    `run` gives the JAX Predictor's output."""
    hr, lr, topo, mask, pred = data
    kw = dict(static_vars=[topo, mask], predictors=[pred],
              time_metadata=DAYS, batch_size=4)
    want = dds.Predictor(season_models[0], lr, SCALE, **kw).run()
    got = tds.Predictor(season_models[1], lr, SCALE, device='cpu',
                        **kw).run()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize('multiple', [16, 6])
def test_pad_to_multiple_matches_the_jax_padded_output(data, season_models,
                                                       multiple):
    """Edge padding of x and aux, then the crop: the JAX package's padded
    output (the gates' means see the padded pixels), not an unpadded
    run's. 8x10 LR grids pad to 16x16, or to 12x12."""
    hr, lr, topo, mask, pred = data
    kw = dict(scale=SCALE, array_in_hr=False, static_vars=[topo, mask],
              predictors=[pred], time_metadata=DAYS, batch_size=6,
              pad_to_multiple=multiple)
    want = dds.predict(season_models[0], lr, **kw)
    got = tds.predict(season_models[1], lr, device='cpu', **kw)
    assert got.shape == want.shape == (N, HR_Y, HR_X, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    plain = tds.predict(season_models[1], lr, device='cpu',
                        **dict(kw, pad_to_multiple=None))
    assert np.abs(plain - got).max() > 1e-4     # the gates saw the padding


def test_recurrent_predict_of_lr_grids_matches_jax(data):
    """Windows of 3 LR grids with the season in aux only (4 channels)."""
    hr, lr, topo, mask, pred = data
    models = _models(2, 4, recurrent=True)
    kw = dict(scale=SCALE, array_in_hr=False, predictors=[pred],
              time_window=3, time_metadata=DAYS, batch_size=4)
    want = dds.predict(models[0], lr, **kw)
    got = tds.predict(models[1], lr, device='cpu', **kw)
    assert got.shape == want.shape == (N, HR_Y, HR_X, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize('time_metadata,error', [
    (DAYS[:5], 'yields 5 samples'), ('auto', 'xr.DataArray'),
    ('daily', 'unknown time_metadata')])
def test_predict_checks_the_time_metadata_as_jax(data, season_models,
                                                 time_metadata, error):
    hr, lr, topo, mask, pred = data
    kw = dict(scale=SCALE, array_in_hr=False, static_vars=[topo, mask],
              predictors=[pred], time_metadata=time_metadata)
    with pytest.raises(ValueError, match=error):
        dds.predict(season_models[0], lr, **kw)
    with pytest.raises(ValueError, match=error):
        tds.predict(season_models[1], lr, device='cpu', **kw)
