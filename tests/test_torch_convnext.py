"""The port's ConvNeXt backbone and localized output layer against the JAX
package on the CPU: the grouped (depthwise) `Conv` and `Dense` against
Flax's, `ConvNextBlock` (layer norm with eps 1e-6 or bn, the layer-scale
`gamma`, the 1x1 residual conv, `DropPath` on JAX's draws), the convnext
backbone with its 7x7 stem and head and the aux branch's
`ConvNextBlock_aux`, `LocalizedConvBlock` and the models that place it
(`NetPostupsampling`, `NetPIN`, `UnetPIN`, `RecNetPostupsampling`), in
forward and gradient, three Adam steps of a convnext model with the
localized layer against the JAX trainer, and the bfloat16 forward.

Tolerances: forward and gradients atol/rtol 1e-4 (tests/_torch_state.py);
the trainer's losses rtol 1e-5 and parameters atol 2e-6, as
tests/test_torch_pin.py; bfloat16 by the mean criterion of
tests/test_torch_bf16_models.py. The aux input has 4 channels: the aux
block's layer norm with eps 1e-6 over 2 channels a and b is +-(a - b) /
sqrt((a - b)^2 + 4e-6), which float32's rounding of its input moves by
up to 2e-2 where a and b nearly agree, in JAX and the port alike. Small
sizes: n_filters 4, n_blocks 2, 8x8 LR grids."""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu.models import blocks as jblocks
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.models import blocks as tblocks

from _torch_state import (TOL, np_tree, t, j, load, flat, assert_tree_close,
                          check_train_step, check_bf16_forward)
from _torch_xla import quick_xla  # noqa: F401

LR, SCALE, AUX = 8, 2, 4
SPATIAL = dict(n_channels=3, lr_size=(LR, LR), n_filters=4, n_blocks=2,
               attention=True)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# Conv(groups=), Dense and the blocks
# ---------------------------------------------------------------------------

def test_depthwise_conv_matches_flax():
    """Flax's `feature_group_count` conv, its kernel [7, 7, 1, C] held
    [C, 1, 7, 7]."""
    x = _x((2, 9, 10, 5), 0)
    jm = jblocks.Conv(5, (7, 7), padding='SAME', feature_group_count=5)
    v = jm.init(jax.random.PRNGKey(0), j(x))
    assert v['params']['kernel'].shape == (7, 7, 1, 5)
    tm = tblocks.Conv(5, 5, (7, 7), groups=5)
    assert tuple(tm.weight.shape) == (5, 1, 7, 7)
    tds.load_jax_params(torch.nn.ModuleDict({'c': tm}), {'c': np_tree(
        v['params'])})
    with torch.no_grad():
        np.testing.assert_allclose(tm(t(x)).numpy(),
                                   np.asarray(jm.apply(v, j(x))), **TOL)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dense_matches_flax(dtype):
    """`nn.Dense` over the last axis, its kernel [in, out]; in bfloat16 the
    product rounded once and the bias added after (Flax eager)."""
    x = _x((2, 3, 4, 6), 1)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    jm = fnn.Dense(5, dtype=jdt)
    v = jm.init(jax.random.PRNGKey(1), j(x))
    v = jax.tree_util.tree_map(lambda a: a + 0.1, v)
    tm = tblocks.Dense(6, 5, dtype=getattr(torch, dtype))
    with torch.no_grad():
        tm.kernel.copy_(t(v['params']['kernel']))
        tm.bias.copy_(t(v['params']['bias']))
        got = tm(t(x)).float().numpy()
    want = np.asarray(jm.apply(v, j(x)).astype(jnp.float32))
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_depthwise_separable_conv_block_matches_jax():
    """`ConvBlock(depthwise_separable=True)`: each conv a depthwise conv
    without bias and a 1x1 conv (`_SeparableConv_0`, `_SeparableConv_1`),
    here under bn, so the 1x1 convs have no bias either."""
    x = _x((2, 7, 6, 3), 8)
    jm = jblocks.ConvBlock(4, normalization='bn', depthwise_separable=True)
    v = jm.init(jax.random.PRNGKey(8), j(x))
    assert sorted(v['params']) == ['_Norm_0', '_Norm_1', '_SeparableConv_0',
                                   '_SeparableConv_1']
    tm = load(tblocks.ConvBlock(3, 4, normalization='bn',
                                depthwise_separable=True), v)
    check_train_step(jm.apply, v, tm, (x,), 9)


def test_dense_init_is_lecun_normal():
    """Flax's default kernel init: a normal of variance 1 / fan_in cut at
    two standard deviations, zero bias."""
    tm = tblocks.Dense(64, 256)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    k = tm.kernel.detach().numpy()
    std = (1 / 64) ** 0.5 / .87962566103423978
    assert np.abs(k).max() <= 2 * std
    assert abs(k.std() - (1 / 64) ** 0.5) < 0.02 * (1 / 64) ** 0.5
    assert not tm.bias.detach().numpy().any()


CONVNEXT = {
    'ln': dict(),
    'bn': dict(normalization='bn'),
    'ln_gamma_1x1': dict(layer_scale_init_value=0.5, use_1x1conv=True),
    'bn_1x1': dict(normalization='bn', use_1x1conv=True),
}


@pytest.mark.parametrize('case', sorted(CONVNEXT))
def test_convnext_block_matches_jax(case):
    """7x7 depthwise conv -> layer norm (eps 1e-6) or bn -> Dense to 4 *
    filters -> gelu -> Dense -> [gamma] -> DropPath, plus the input ([1x1
    conv]), in train mode (the running statistics) and eval mode (the
    forward)."""
    kw = CONVNEXT[case]
    filters = 8 if kw.get('use_1x1conv') else 6
    x = _x((2, 9, 8, 6), 2)
    jm = jblocks.ConvNextBlock(filters, **kw)
    v = jm.init(jax.random.PRNGKey(2), j(x))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, v)
    tm = load(tblocks.ConvNextBlock(6, filters, **kw), v)
    assert set(flat(tds.weights.export_jax_variables(tm))) == set(
        flat({k: v[k] for k in v}))
    check_train_step(jm.apply, v, load(tm, v), (x,), 3)
    check_train_step(jm.apply, v, load(tm, v), (x,), 3, training=False,
                     grads=False)


def test_convnext_block_drop_path_on_jax_draws():
    """With drop_path > 0 the residual branch is dropped per sample in
    train mode, on JAX's uniform draw."""
    x = _x((4, 6, 5, 6), 4)
    jm = jblocks.ConvNextBlock(6, drop_path=0.5)
    v = jm.init(jax.random.PRNGKey(4), j(x))
    tm = load(tblocks.ConvNextBlock(6, 6, drop_path=0.5), v)
    tblocks.set_dropout_generator(tm, torch.Generator().manual_seed(0))
    check_train_step(jm.apply, v, tm, (x,), 5,
                     rngs={'dropout': jax.random.PRNGKey(5)}, eager=True)


def test_localized_conv_block_matches_jax():
    """A transition to 2 channels, then per pixel y @ local_kernel[h, w] +
    local_bias[h, w]; glorot per position; the grid is fixed."""
    x = _x((2, 7, 9, 5), 6)
    jm = jblocks.LocalizedConvBlock(filters=2)
    v = jm.init(jax.random.PRNGKey(6), j(x))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05, v)
    assert v['params']['local_kernel'].shape == (7, 9, 2, 2)
    tm = load(tds.LocalizedConvBlock(5, (7, 9)), v)
    check_train_step(jm.apply, v, tm, (x,), 7)
    with pytest.raises(ValueError, match='grid'):
        tm(t(_x((2, 8, 9, 5), 6)))
    init = tds.LocalizedConvBlock(5, (64, 64))
    init.reset_parameters(torch.Generator().manual_seed(1))
    k = init.local_kernel.detach().numpy()
    assert np.abs(k).max() <= (6 / 4) ** 0.5
    assert abs(k.std() - (2 / 4) ** 0.5) < 0.02


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

MODELS = {
    'convnext_spc': ((dds.net_postupsampling, tds.net_postupsampling),
                     ('convnext', 'spc'),
                     dict(SPATIAL, scale=SCALE, n_aux_channels=AUX),
                     ((2, LR, LR, 3), (2, LR * SCALE, LR * SCALE, AUX))),
    'convnext_spc_bn_localcon': (
        (dds.net_postupsampling, tds.net_postupsampling),
        ('convnext', 'spc'),
        dict(SPATIAL, scale=SCALE, n_aux_channels=2, normalization='bn',
             localcon_layer=True),
        ((2, LR, LR, 3), (2, LR * SCALE, LR * SCALE, 2))),
    'convnext_pin_localcon': (
        (dds.net_pin, tds.net_pin), ('convnext',),
        dict(SPATIAL, n_aux_channels=0, hr_size=(16, 16), lr_size=None,
             localcon_layer=True), ((2, 16, 16, 3),)),
    'unet_pin_localcon': (
        (dds.unet_pin, tds.unet_pin), ('unet',),
        dict(SPATIAL, n_aux_channels=2, hr_size=(16, 16), lr_size=None,
             localcon_layer=True), ((2, 16, 16, 3), (2, 16, 16, 2))),
    'recresnet_spc_localcon': (
        (dds.recnet_postupsampling, tds.recnet_postupsampling),
        ('resnet', 'spc'),
        dict(SPATIAL, scale=SCALE, n_aux_channels=2, time_window=3,
             lr_size=(6, 6), n_blocks=1, localcon_layer=True),
        ((2, 3, 6, 6, 3), (2, 12, 12, 2))),
}


def _model(name, seed=0):
    (jf, tf), args, kwargs, shapes = MODELS[name]
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    jm = jf(*args, **kwargs)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = tf(*args, **kwargs)
    net = load(tm.init(seed, device='cpu'), v)
    assert tm.param_count(net) == jm.param_count(v)
    assert set(flat(tds.weights.export_jax_variables(net))) == set(
        flat({k: v[k] for k in v}))
    inputs = tuple(_x(s, seed + 30 + i) for i, s in enumerate(shapes))
    return jm, v, tm, net, inputs, (jf, tf, args, kwargs)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_models_match_jax(name):
    """The convnext backbone (7x7 stem, `ConvNextBlock{i}` with a 1x1
    residual conv from the second, `TransitionBlock_0(stem) + b`), its aux
    branch `ConvNextBlock_aux` and 7x7 output head, and the localized layer
    at the four sites that place it: after the head (spatial), after the
    backbone (pin), after the decoder's dropout (U-Net), after the aux
    concat on the [B*T] frames (recurrent); train mode, forward and
    gradients."""
    jm, v, tm, net, inputs, _ = _model(name)
    p = v['params']
    if name.startswith('convnext'):
        assert p['_Backbone_0']['stem']['kernel'].shape[:2] == (7, 7)
        assert 'Conv_1' in p['_Backbone_0']['ConvNextBlock2']
        assert 'Conv_1' not in p['_Backbone_0']['ConvNextBlock1']
        head = p['_OutputModule_0']['ConvBlock_1']['Conv_0']['kernel']
        assert head.shape[:2] == (7, 7)
    if 'localcon' in name:
        assert 'LocalizedConvBlock_0' in p
    check_train_step(jm.module.apply, v, net, inputs, 31)


@pytest.mark.parametrize('name', ['convnext_spc_bn_localcon',
                                  'convnext_pin_localcon'])
def test_bf16_forward_matches_jax(name):
    """The bfloat16 models (the depthwise conv, the layer norms, the Dense
    layers and the localized contraction in bfloat16) by the mean
    criterion, in eval mode."""
    jm, v, tm, net, inputs, (jf, tf, args, kwargs) = _model(name)
    check_bf16_forward(jf, tf, args, kwargs, inputs, variables=v)


# ---------------------------------------------------------------------------
# Training against the JAX trainer
# ---------------------------------------------------------------------------

TRAIN = dict(backbone='convnext', upsampling='spc', scale=SCALE,
             patch_size=None, batch_size=2, n_filters=4, n_blocks=2,
             loss='mae', verbose=False, attention=True, localcon_layer=True)


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def test_convnext_localcon_adam_steps_match_the_jax_trainer():
    """Three `_train_step_batch` Adam steps of the JAX trainer on whole
    16x16 grids (the localized weights fix the grid) with 4 statics, and
    three `train_step`s of the port's trainer from its initial weights on
    its batches: the losses and the parameters after the third."""
    rng = np.random.default_rng(40)
    hr = rng.standard_normal((8, 16, 16, 1)).astype(np.float32)
    statics = [rng.standard_normal((16, 16)).astype(np.float32)
               for _ in range(AUX)]
    config = dict(TRAIN, static_vars=statics)
    jtr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:4], data_test=hr[:4], save=False,
        learning_rate=(1e-3, 1e-4), devices=jax.devices()[:1], **config)
    jtr.setup_datagen()
    jtr.setup_model()
    params0 = _copy_tree(jtr.variables['params'])
    state = jax_supervised.TrainState.create(
        apply_fn=jtr.model.module.apply, params=jtr.variables['params'],
        tx=jtr._build_optimizer())
    jtr._make_steps()
    batches, losses = [], []
    for i, idx in enumerate(([0, 5], [6, 2], [3, 3])):
        key = jax.random.PRNGKey(i)
        batch = jtr.ds_train._make_batch(jnp.asarray(idx), key)
        batches.append({k: (None if v is None else np.array(v))
                        for k, v in batch.items()})
        state, loss = jtr._train_step_batch(state, batch, key)
        losses.append(float(loss))
    tr = tds.SupervisedTrainer(
        data_train=hr, data_val=hr[:4], data_test=hr[:4], device='cpu',
        learning_rate=(1e-3, 1e-4), **config)
    tr.setup_model()
    assert tr.model.name == jtr.model.name == 'convnext_spc'
    tds.load_jax_params(tr.net, params0)
    tr.setup_optimizer()
    tr.net.train()
    got = [tr.train_step({k: t(v) for k, v in b.items()}).item()
           for b in batches]
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    assert_tree_close(tds.weights.export_jax_params(tr.net),
                      _copy_tree(state.params), dict(atol=2e-6, rtol=0),
                      what='params')
