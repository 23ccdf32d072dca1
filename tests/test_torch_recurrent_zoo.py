"""The rest of the port's spatio-temporal zoo against the JAX package on
the CPU: the pre-upsampled recurrent model `RecNetPIN` (`recnet_pin`) with
the convnet, resnet and densenet merges, with and without aux, with the
localized layer; the convnet and densenet merges of
`RecNetPostupsampling` with the 'spc', 'rc' and 'dc' heads (the densenet
head on 2 * n_filters channels); a bfloat16 forward; `save_model` /
`load_model` both ways; `build_model`'s dispatch; three Adam steps of
`SupervisedTrainer` on recresnet_pin against the JAX trainer's
`_train_step_batch`, two fused steps of a spatio-temporal 'pin'
`CGANTrainer` against the JAX `train_step` on the same dropout masks, and
`run()` then `predict` against the JAX `predict`. The same seeded numpy
inputs and the port's seeded weights, exported to the Flax tree (whose
names and shapes are held against the Flax `init`'s), go through both.

Tolerances: the models' forward and the gradients of a weighted mean of
the output atol/rtol 1e-5 (the gradients' atol scaled by their max |g|,
tests/_torch_state.py's `check_train_step`), compared in float64 (JAX
with x64 on): in float32 the sums' order alone moves a gradient by 2.6e-5
of its scale; the trainers' float32 losses rtol 1e-5 and parameters atol
1e-5 after Adam; a reloaded model and `predict` 1e-5; the bfloat16
forward by the mean criterion of tests/test_torch_bf16_models.py. Small
sizes: T 2-3, frames of 8x8 to 16x16, n_filters 4, one block."""

import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

import dl4ds_tpu as dds
from dl4ds_tpu import losses as jax_losses
from dl4ds_tpu.models import load_model as jax_load_model
from dl4ds_tpu.training import cgan as jax_cgan
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds

from _torch_state import (t, j, fed_draws, assert_tree_close,
                          check_train_step, check_bf16_forward)
from test_torch_cgan import _JitDraws
from _torch_xla import quick_xla  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
T, HW = 3, 12
PIN = dict(n_channels=2, hr_size=(HW, HW), time_window=T, n_filters=4,
           n_blocks=1, attention=True)
POST = dict(scale=4, n_channels=2, lr_size=(4, 4), time_window=T,
            n_filters=4, n_blocks=1, attention=True)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _shapes(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): tuple(v.shape) for k, v in leaves}


def _pair(jax_factory, port_factory, args, kwargs, seed=0):
    """The JAX model in float64 (call under `jax.enable_x64()`), the port's
    network in float64, and the port's seeded weights as the Flax tree
    (`export_jax_params`), in float64: its names and shapes are those of
    the Flax `init` (`jax.eval_shape`, no compile)."""
    jm = jax_factory(*args, dtype=jnp.float64, **kwargs)
    net = port_factory(*args, **kwargs).init(seed, device='cpu')
    params = tds.weights.export_jax_params(net)
    assert _shapes(params) == _shapes(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0))['params'])
    v = {'params': jax.tree_util.tree_map(
        lambda a: a.astype(np.float64), params)}
    return jm, v, net.double()


def _inputs(model, n_aux, seed, b=2, dtype=np.float64):
    x = _rand((b,) + tuple(model.input_shape), seed).astype(dtype)
    if not n_aux:
        return (x,)
    return x, _rand((b,) + tuple(model.aux_shape), seed + 1).astype(dtype)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('backbone,n_aux,localcon', [
    ('convnet', 2, True), ('resnet', 0, False), ('densenet', 2, True),
    ('densenet', 0, False)])
def test_recnet_pin_matches_jax(backbone, n_aux, localcon):
    """RecNetPIN: the backbone's ConvLSTM layers on the HR frames, then per
    frame the aux branch, the localized layer, `TransitionLast` to
    n_filters, the gate pooling over (T, H) and the output conv; forward
    and gradients (the localized layer's per-pixel weights included)."""
    kw = dict(PIN, n_aux_channels=n_aux, localcon_layer=localcon)
    with jax.enable_x64():
        jm, v, net = _pair(dds.recnet_pin, tds.recnet_pin, (backbone,), kw)
        tm = tds.recnet_pin(backbone, **kw)
        assert tm.name == jm.name == f'rec{backbone}_pin'
        assert tm.input_shape == jm.input_shape == (T, HW, HW, 2)
        assert tm.aux_shape == jm.aux_shape
        width = 8 if backbone == 'densenet' else 4
        width += 4 * bool(n_aux) + 2 * localcon
        assert v['params']['TransitionLast']['Conv_0']['kernel'].shape == \
            (1, 1, width, 4)
        out = check_train_step(jm.apply, v, net, _inputs(jm, n_aux, 3), 4,
                               tol=TOL)
    assert out.shape == (2, T, HW, HW, 1)


@pytest.mark.parametrize('backbone', ['convnet', 'densenet'])
@pytest.mark.parametrize('upsampling', ['spc', 'rc', 'dc'])
def test_recurrent_merges_match_jax(backbone, upsampling):
    """The convnet (the blocks' output) and densenet (concat of the stem's
    and the blocks' output, 2 * n_filters channels, which the head and
    `TransitionLast` are built on) merges under each post-upsampling
    head; aux on the 'rc' head."""
    n_aux = 2 if upsampling == 'rc' else 0
    kw = dict(POST, n_aux_channels=n_aux)
    with jax.enable_x64():
        jm, v, net = _pair(dds.recnet_postupsampling,
                           tds.recnet_postupsampling, (backbone, upsampling),
                           kw)
        assert jm.name == f'rec{backbone}_{upsampling}'
        ups = 4 if backbone == 'convnet' else 8
        width = ups + 4 * bool(n_aux)
        assert v['params']['TransitionLast']['Conv_0']['kernel'].shape == \
            (1, 1, width, width // 2)
        out = check_train_step(jm.apply, v, net, _inputs(jm, n_aux, 5), 6,
                               tol=TOL)
    assert out.shape == (2, T, 16, 16, 1)


def test_recnet_pin_bf16_forward_matches_jax():
    kw = dict(PIN, n_aux_channels=2, time_window=2, hr_size=(8, 8))
    net = tds.recnet_pin('densenet', **kw).init(0, device='cpu')
    check_bf16_forward(dds.recnet_pin, tds.recnet_pin, ('densenet',), kw,
                       _inputs(dds.recnet_pin('densenet', **kw), 2, 7,
                               dtype=np.float32),
                       variables={'params': tds.weights.export_jax_params(
                           net)})


def _parameters(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()]


def test_recnet_pin_signature_equals_the_jax_one():
    want = [p if p[0] != 'dtype' else (p[0], torch.float32)
            for p in _parameters(dds.recnet_pin)]
    assert _parameters(tds.recnet_pin) == want


def test_build_model_dispatches_the_recurrent_models():
    """`build_model` with a time window: 'pin' builds recnet_pin on the HR
    grid, a post-upsampling head recnet_postupsampling on the LR grid, for
    every recurrent merge; the JAX dispatcher builds the same."""
    for backbone in ('convnet', 'resnet', 'densenet'):
        for ups in ('pin', 'spc'):
            args = (backbone, ups, 4, 1, 0, (4, 4), (16, 16))
            tm = tds.build_model(*args, time_window=T, n_filters=4,
                                 n_blocks=1)
            jm = dds.build_model(*args, time_window=T, n_filters=4,
                                 n_blocks=1)
            assert (tm.name, tm.input_shape) == (jm.name, jm.input_shape)
            assert tm.module_class == type(jm.module).__name__


def test_recnet_pin_save_load_both_ways(tmp_path):
    """The port's `save_model` read by the JAX `load_model` (the module
    class and its fields), the JAX `save_model`'s orbax tree read by the
    port's `load_model`; both serve what the saved model serves."""
    kw = dict(PIN, n_aux_channels=2, localcon_layer=True)
    tm = tds.recnet_pin('densenet', **kw)
    jm = dds.recnet_pin('densenet', **kw)
    net = tm.init(0, device='cpu')
    v = {'params': tds.weights.export_jax_params(net)}
    x, aux = _inputs(jm, 2, 9, dtype=np.float32)
    with torch.no_grad():
        ref = net(t(x), t(aux)).numpy()
    port_dir, jax_dir = str(tmp_path / 'port'), str(tmp_path / 'jax')
    tds.save_model(tm, net, port_dir)
    jm2, v2 = jax_load_model(port_dir)
    assert jm2.module == jm.module.clone()
    np.testing.assert_allclose(np.asarray(jm2.apply(v2, j(x), j(aux))), ref,
                               atol=1e-5, rtol=0)
    dds.models.save_model(jm, v, jax_dir)
    assert os.path.isdir(os.path.join(jax_dir, 'variables'))
    model, net2 = tds.load_model(jax_dir, device='cpu')
    assert (model.name, model.config, model.module_class) == \
        (tm.name, tm.config, 'RecNetPIN')
    with torch.no_grad():
        np.testing.assert_allclose(net2(t(x), t(aux)).numpy(), ref,
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# The trainers against the JAX trainers
# ---------------------------------------------------------------------------



@pytest.fixture(scope='module')
def train_data():
    return _rand((10, 16, 16, 1), 21)


def test_adam_steps_match_the_jax_trainer(train_data):
    """Three Adam steps of recresnet_pin: the JAX trainer's
    `_train_step_batch` from the port trainer's initial weights (given as
    its `trained_model`), and the port's `train_step`s, on the same pin
    batches: the losses and the parameters (the ConvLSTM layers' and the
    gate's plain versions)."""
    hr = train_data
    config = dict(backbone='resnet', upsampling='pin', patch_size=8,
                  scale=4, batch_size=2, time_window=T, n_filters=4,
                  n_blocks=1, loss='mae', verbose=False,
                  learning_rate=(1e-3, 1e-4))
    tr = tds.SupervisedTrainer(data_train=hr, data_val=hr[:6],
                               data_test=hr[:6], device='cpu', **config)
    tr.setup_model()
    assert tr.model.name == 'recresnet_pin'
    params0 = tds.weights.export_jax_params(tr.net)
    jm = dds.recnet_pin('resnet', 1, 0, (8, 8), T, n_filters=4, n_blocks=1)
    jt = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        devices=jax.devices()[:1], trained_model=(jm, {'params': params0}),
        **config)
    jt.setup_datagen()
    jt.setup_model()
    state = jax_supervised.TrainState.create(
        apply_fn=jm.module.apply, params=params0, tx=jt._build_optimizer())
    jt._make_steps()
    tr.setup_optimizer()
    tr.net.train()
    for i, idx in enumerate(([0, 5], [6, 2], [3, 3])):
        key = jax.random.PRNGKey(i)
        batch = {k: (None if v is None else np.array(v)) for k, v in
                 jt.ds_train._make_batch(jnp.asarray(idx), key).items()}
        state, want = jt._train_step_batch(
            state, {k: j(v) for k, v in batch.items()}, key)
        got = tr.train_step({k: t(v) for k, v in batch.items()}).item()
        np.testing.assert_allclose(got, float(want), rtol=TOL['rtol'])
    assert_tree_close(tds.weights.export_jax_params(tr.net),
                      state.params, TOL, what='recresnet_pin')


SCALE, PATCH, B = 4, 8, 2
G_ARGS = dict(n_filters=4, n_blocks=1, attention=True)
D_ARGS = dict(n_filters=4, n_res_blocks=1, attention=True)


def _jax_tx(lr):
    return optax.flatten(optax.adam(lr, b1=0.5, eps=1e-7))


@functools.lru_cache(maxsize=None)
def _pin_gan_step():
    """The JAX `train_step` of a spatio-temporal 'pin' pair (recresnet_pin
    and D with its recurrent stem on the HR frames), jitted, its draws
    recorded."""
    lr_hw = (PATCH // SCALE,) * 2
    gen = dds.build_model('resnet', 'pin', SCALE, 1, 0, lr_hw,
                          (PATCH, PATCH), time_window=T, **G_ARGS)
    disc = dds.residual_discriminator(1, 'pin', True, SCALE, lr_hw,
                                      time_window=T, **D_ARGS)
    return _JitDraws(functools.partial(
        jax_cgan.train_step, generator=gen, discriminator=disc,
        gen_pxloss_function=jax_losses.mae, ema_decay=0.0))


def test_pin_gan_steps_match_jax():
    """Two fused G+D steps of a spatio-temporal 'pin' CGANTrainer on the
    JAX `train_step`'s batches and dropout masks (D(fake)'s drawn once,
    reused by G's loss): the four losses and both networks' parameters."""
    data = _rand((6, 16, 16, 1), 11)
    tr = tds.CGANTrainer(
        'resnet', 'pin', data, data, scale=SCALE, patch_size=PATCH,
        batch_size=B, epochs=1, time_window=T, learning_rates=(2e-4, 3e-4),
        generator_params=dict(G_ARGS), discriminator_params=dict(D_ARGS),
        device='cpu', verbose=False, save_loss_history=False)
    tr.setup_model()
    assert tr.generator.name == 'recresnet_pin'
    assert tr.discriminator.input_shape == (T, PATCH, PATCH, 1)
    gv = {'params': tds.weights.export_jax_params(tr.gen_net)}
    dv = {'params': tds.weights.export_jax_params(tr.disc_net)}
    tr.setup_optimizer(2)
    gs = jax_cgan.GenTrainState.create(apply_fn=None, params=gv['params'],
                                       tx=_jax_tx(2e-4), ema_params=None)
    ds = train_state.TrainState.create(apply_fn=None, params=dv['params'],
                                       tx=_jax_tx(3e-4))
    step = _pin_gan_step()
    tr.train_net.train()
    for i in range(2):
        batch = dict(lr=_rand((B, T, PATCH, PATCH, 1), 20 + i),
                     hr=_rand((B, T, PATCH, PATCH, 1), 40 + i), aux=None)
        (gs, ds, want), draws = step(gs, ds,
                                     {k: j(v) for k, v in batch.items()},
                                     jax.random.PRNGKey(100 + i))
        np.testing.assert_array_equal(draws[2][1], draws[0][1])
        with fed_draws(draws[:2]):
            got = tr.train_step({k: t(v) for k, v in batch.items()})
        np.testing.assert_allclose(got.numpy(), [float(v) for v in want],
                                   rtol=TOL['rtol'])
        assert_tree_close(tds.weights.export_jax_params(tr.gen_net),
                          gs.params, TOL, what='generator')
        assert_tree_close(tds.weights.export_jax_params(tr.disc_net),
                          ds.params, TOL, what='discriminator')


def test_recnet_pin_trains_and_serves_on_the_cpu(train_data):
    """`run()` of recresnet_pin with validation and test, then `predict`
    of HR grids (the LR stand-in interpolated back, `time_window` windows
    collapsed) against the JAX `predict` with the trained weights."""
    hr = train_data
    tr = tds.SupervisedTrainer(
        'resnet', 'pin', hr, hr[:6], hr[:6], scale=4, patch_size=8,
        batch_size=2, time_window=T, epochs=1, steps_per_epoch=2,
        n_filters=4, n_blocks=1, device='cpu', verbose=False).run()
    assert np.isfinite(tr.fithist['loss'] + [tr.test_loss]).all()
    y = tds.predict(tr, hr[:6], scale=4, array_in_hr=True, time_window=T,
                    device='cpu')
    jm = dds.recnet_pin('resnet', 1, 0, (16, 16), T, n_filters=4,
                        n_blocks=1)
    variables = {'params': tds.weights.export_jax_params(tr.net)}
    want = dds.predict((jm, variables), hr[:6], scale=4, array_in_hr=True,
                       time_window=T)
    np.testing.assert_allclose(y, np.asarray(want), atol=1e-5, rtol=0)
