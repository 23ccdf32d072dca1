"""The port's batch and layer normalization against the JAX package on the
CPU: `_Norm` ('bn', 'ln') at rank 4 and 5 in train and eval mode, the
blocks that thread it (`ConvBlock`, `ResidualBlock`, `DenseBlock`, the
'bn' `TransitionBlock`, `RecurrentConvBlock`), the resnet, convnet,
densenet, U-Net and recurrent models with it, three Adam steps of the
trainer against the JAX trainer with the running statistics after each
step, the EMA trainer's validation with bn, and `save_model` /
`load_model` both ways with the `batch_stats` collection. The same seeded
numpy inputs and the Flax variables carried across by `load_jax_params`
go through both.

Tolerances (tests/_torch_state.py): forward, gradients (atol scaled by
max |g|) and running statistics atol/rtol 1e-4; the trainer's losses
rtol 1e-5 and parameters atol 2e-6, as tests/test_torch_pin.py. The ln
models are compared in float64 (JAX with x64 on, `dtype=jnp.float64`; the
port's network in float64): a layer norm with eps 1e-3 over 3 or 4
channels divides by the square root of a variance that float32's
rounding of its input can move by a large share where the channels
nearly agree, so the two float32 models, whose convolutions sum in other
orders, land up to 1.7e-4 apart at single pixels (the U-Net, seed 0).
The ln blocks are compared in float32. Small sizes: n_filters 4,
n_blocks 1-2, 8x8 LR grids."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu.models import blocks as jblocks
from dl4ds_tpu.models import load_model as jax_load_model
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.models import blocks as tblocks

from _torch_state import (np_tree, t, j, load, flat, assert_tree_close,
                          check_train_step)
from _torch_xla import quick_xla  # noqa: F401

LR, SCALE = 8, 2
SPATIAL = dict(n_channels=3, lr_size=(LR, LR), n_filters=4, n_blocks=1,
               attention=True, n_channels_out=3)
PARAM_ATOL = 2e-6


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _perturbed(variables, seed):
    """`variables` with the norms' leaves moved off their init (scale 1,
    bias 0, mean 0, var 1 would hide a swapped or dropped leaf): scale and
    var by up to +-10%, bias and mean by 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        names = [getattr(k, 'key', '') for k in path]
        if not any(n in ('BatchNorm_0', 'LayerNorm_0') for n in names):
            return a
        if names[-1] in ('scale', 'var'):
            return a * (1 + 0.2 * (rng.random(a.shape) - 0.5)).astype(
                a.dtype)
        return a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(move, variables)


# ---------------------------------------------------------------------------
# _Norm and the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['bn', 'ln'])
@pytest.mark.parametrize('shape', [(3, 5, 6, 4), (2, 3, 4, 5, 4)],
                         ids=['rank4', 'rank5'])
@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_norm_matches_jax(kind, shape, training):
    """Flax's BatchNorm (momentum 0.99, eps 1e-3, the biased batch variance
    E[x^2] - E[x]^2 in float32) and LayerNorm (eps 1e-3) over the channel
    axis: the output, the gradients and the moved running statistics."""
    x = (np.random.default_rng(0).standard_normal(shape) * 2 + 1).astype(
        np.float32)
    jm = jblocks._Norm(kind)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), j(x)), 1)
    tm = load(tblocks._Norm(kind, shape[-1]), v)
    assert set(flat(tds.weights.export_jax_variables(tm))) == \
        {f'params/{k}' for k in flat(v['params'])} | \
        {f'batch_stats/{k}' for k in flat(v.get('batch_stats', {}))}
    check_train_step(jm.apply, v, tm, (x,), 2, training=training)


def test_batch_norm_running_variance_is_the_biased_one():
    """After one train-mode call the running variance is 0.99 + 0.01 *
    the biased batch variance (PyTorch's BatchNorm would take the
    unbiased one, n / (n - 1) larger)."""
    x = np.random.default_rng(3).standard_normal((2, 3, 3, 2)).astype(
        np.float32)
    bn = tblocks.BatchNorm(2)
    bn.train()
    bn(t(x))
    want = 0.99 + 0.01 * x.reshape(-1, 2).var(axis=0)
    np.testing.assert_allclose(bn.var.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(bn.mean.numpy(),
                               0.01 * x.reshape(-1, 2).mean(axis=0),
                               rtol=1e-6)


BLOCKS = {
    'conv': (lambda n: jblocks.ConvBlock(4, normalization=n, attention=True),
             lambda n: tblocks.ConvBlock(3, 4, normalization=n,
                                         attention=True), (2, 7, 6, 3)),
    'residual': (lambda n: jblocks.ResidualBlock(4, normalization=n,
                                                 use_1x1conv=True),
                 lambda n: tblocks.ResidualBlock(3, 4, normalization=n,
                                                 use_1x1conv=True),
                 (2, 7, 6, 3)),
    'dense': (lambda n: jblocks.DenseBlock(4, normalization=n),
              lambda n: tblocks.DenseBlock(3, 4, normalization=n),
              (2, 7, 6, 3)),
    'recurrent': (lambda n: jblocks.RecurrentConvBlock(4, normalization=n),
                  lambda n: tblocks.RecurrentConvBlock(3, 4,
                                                       normalization=n),
                  (2, 3, 6, 5, 3)),
}


@pytest.mark.parametrize('kind', ['bn', 'ln'])
@pytest.mark.parametrize('block', sorted(BLOCKS))
def test_blocks_with_norm_match_jax(block, kind):
    """Each block's normalizations at the JAX places, its convs without
    bias under a normalization (DenseBlock's keep theirs), in train mode
    (forward, gradients, the running statistics) and in eval mode (the
    forward)."""
    jf, tf, shape = BLOCKS[block]
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jm = jf(kind)
    v = _perturbed(jm.init(jax.random.PRNGKey(4), j(x)), 5)
    tm = load(tf(kind), v)
    assert set(flat(tds.weights.export_jax_params(tm))) == set(
        flat(v['params']))
    check_train_step(jm.apply, v, load(tm, v), (x,), 6)
    check_train_step(jm.apply, v, load(tm, v), (x,), 6, training=False,
                     grads=False)


def test_transition_block_bn_branch_matches_jax():
    """With 'bn' the transition is bn -> act -> conv; with 'ln' it is the
    plain conv -> act, as in the JAX block."""
    x = np.random.default_rng(7).standard_normal((2, 5, 5, 6)).astype(
        np.float32)
    for kind in ('bn', 'ln'):
        jm = jblocks.TransitionBlock(3, normalization=kind)
        v = _perturbed(jm.init(jax.random.PRNGKey(7), j(x)), 8)
        tm = load(tblocks.TransitionBlock(6, 3, normalization=kind), v)
        assert ('_Norm_0' in v['params']) == (kind == 'bn')
        check_train_step(jm.apply, v, tm, (x,), 9)


def test_unknown_normalization_raises():
    with pytest.raises(ValueError, match='Normalization not supported'):
        tblocks.ConvBlock(3, 4, normalization='gn')


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def _model_pair(jax_factory, port_factory, args, kwargs, seed=0,
                float64=False):
    jm = jax_factory(*args, **kwargs,
                     **(dict(dtype=jnp.float64) if float64 else {}))
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(seed)), seed + 1)
    tm = port_factory(*args, **kwargs)
    net = load(tm.init(seed, device='cpu'), v)
    assert tm.param_count(net) == jm.param_count(v)
    return jm, v, tm, net.double() if float64 else net


MODELS = {
    'resnet_spc': ((dds.net_postupsampling, tds.net_postupsampling),
                   ('resnet', 'spc'),
                   dict(SPATIAL, scale=SCALE, n_aux_channels=2, n_blocks=2),
                   ((2, LR, LR, 3), (2, LR * SCALE, LR * SCALE, 2))),
    'convnet_rc': ((dds.net_postupsampling, tds.net_postupsampling),
                   ('convnet', 'rc'),
                   dict(SPATIAL, scale=SCALE, n_aux_channels=0),
                   ((2, LR, LR, 3),)),
    'densenet_dc': ((dds.net_postupsampling, tds.net_postupsampling),
                    ('densenet', 'dc'),
                    dict(SPATIAL, scale=SCALE, n_aux_channels=2),
                    ((2, LR, LR, 3), (2, LR * SCALE, LR * SCALE, 2))),
    'unet_pin': ((dds.unet_pin, tds.unet_pin), ('unet',),
                 dict(SPATIAL, n_channels=3, n_aux_channels=2,
                      hr_size=(16, 16), lr_size=None),
                 ((2, 16, 16, 3), (2, 16, 16, 2))),
    'recresnet_spc': ((dds.recnet_postupsampling,
                       tds.recnet_postupsampling), ('resnet', 'spc'),
                      dict(SPATIAL, scale=SCALE, n_aux_channels=2,
                           time_window=3, lr_size=(6, 6), n_blocks=1),
                      ((2, 3, 6, 6, 3), (2, 12, 12, 2))),
}


def _model_case(name, kind, seed=0, float64=False):
    factories, args, kwargs, shapes = MODELS[name]
    kwargs = {k: v for k, v in dict(kwargs, normalization=kind).items()
              if v is not None}
    rng = np.random.default_rng(seed + 10)
    inputs = tuple(rng.standard_normal(s).astype(
        np.float64 if float64 else np.float32) for s in shapes)
    return _model_pair(*factories, args, kwargs, seed, float64) + (inputs,)


@pytest.mark.parametrize('name,kind', [
    (name, 'bn') for name in sorted(MODELS)] + [
    ('resnet_spc', 'ln'), ('recresnet_spc', 'ln')])
def test_models_with_norm_match_jax(name, kind):
    """The models with 'bn', and the spatial and recurrent resnets with
    'ln' (three output channels: a layer norm over one channel is 0; the
    ln blocks of the other backbones are held above), in train mode, the
    forward, the gradients and the running statistics, and a bn model's
    forward in eval mode too, which `predict` uses (a layer norm has no
    mode); the ln models in float64."""
    float64 = kind == 'ln'
    with jax.enable_x64(float64):
        jm, v, tm, net, inputs = _model_case(name, kind, float64=float64)
        assert ('batch_stats' in v) == (kind == 'bn')
        assert set(flat(tds.weights.export_jax_variables(net))) == set(
            flat({k: v[k] for k in v}))
        check_train_step(jm.module.apply, v, load(net, v), inputs, 11)
        if kind == 'bn':
            check_train_step(jm.module.apply, v, load(net, v), inputs, 11,
                             training=False, grads=False)


# ---------------------------------------------------------------------------
# Training against the JAX trainer
# ---------------------------------------------------------------------------

TRAIN = dict(upsampling='spc', scale=SCALE, patch_size=16, batch_size=2,
             n_filters=4, n_blocks=2, loss='mae', verbose=False,
             attention=True, normalization='bn')


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(12)
    hr = rng.standard_normal((10, 24, 24, 1)).astype(np.float32)
    topo = rng.standard_normal((24, 24)).astype(np.float32)
    return hr, topo


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope='module')
def jax_bn_steps(data):
    """Three `_train_step_batch` Adam steps of the JAX trainer for a bn
    resnet_spc with a static, on its own batches, with the running
    statistics after each step."""
    hr, topo = data
    config = dict(TRAIN, backbone='resnet', static_vars=[topo])
    tr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        learning_rate=(1e-3, 1e-4), devices=jax.devices()[:1], **config)
    tr.setup_datagen()
    tr.setup_model()
    v0 = _copy_tree(tr.variables)
    state = jax_supervised.TrainState.create(
        apply_fn=tr.model.module.apply, params=tr.variables['params'],
        tx=tr._build_optimizer(), batch_stats=tr.variables['batch_stats'])
    tr._make_steps()
    batches, losses, stats = [], [], []
    for i, idx in enumerate(([0, 5], [6, 2], [3, 3])):
        key = jax.random.PRNGKey(i)
        batch = tr.ds_train._make_batch(jnp.asarray(idx), key)
        batches.append({k: (None if v is None else np.array(v))
                        for k, v in batch.items()})
        state, loss = tr._train_step_batch(state, batch, key)
        losses.append(float(loss))
        stats.append(_copy_tree(state.batch_stats))
    return dict(config=config, v0=v0, params3=_copy_tree(state.params),
                batches=batches, losses=losses, stats=stats)


def test_bn_adam_steps_match_the_jax_trainer(data, jax_bn_steps):
    """The port's trainer from the JAX trainer's initial variables, three
    `train_step`s on its batches: the losses, the parameters after the
    third, and the running statistics after each step (an unbiased
    variance would miss them by n / (n - 1))."""
    hr, _ = data
    tr = tds.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], device='cpu',
        learning_rate=(1e-3, 1e-4), **jax_bn_steps['config'])
    tr.setup_model()
    load(tr.net, jax_bn_steps['v0'])
    tr.setup_optimizer()
    tr.net.train()
    losses = []
    for batch, want in zip(jax_bn_steps['batches'], jax_bn_steps['stats']):
        losses.append(tr.train_step({k: t(v) for k, v in batch.items()})
                      .item())
        assert_tree_close(tds.weights.export_jax_variables(tr.net)[
            'batch_stats'], want, dict(atol=1e-5, rtol=1e-5),
            what=f'batch_stats after step {len(losses)}')
    np.testing.assert_allclose(losses, jax_bn_steps['losses'], rtol=1e-5)
    assert_tree_close(tds.weights.export_jax_params(tr.net),
                      jax_bn_steps['params3'], dict(atol=PARAM_ATOL, rtol=0),
                      what='params')


def test_ema_validation_reads_the_live_statistics(data):
    """With `ema_decay` the EMA network scores validation with the train
    network's running statistics, as the JAX trainer's eval step uses the
    EMA parameters with the live `state.batch_stats`: after two epochs its
    buffers are the train network's, and the validation loss is the JAX
    eval of (EMA params, live batch_stats) on the same batches."""
    hr, topo = data
    args = dict(TRAIN, backbone='resnet', static_vars=[topo],
                data_train=hr, data_val=hr[:6], data_test=hr[:6],
                device='cpu', epochs=2, steps_per_epoch=2,
                validation_steps=1, test_steps=1, ema_decay=0.5)
    tr = tds.SupervisedTrainer(**args).run()
    live = dict(tr.train_net.named_buffers())
    moved = [n for n, b in live.items() if n.endswith('.mean')]
    assert moved and all(live[n].abs().max() > 0 for n in moved)
    for name, buf in tr.ema_net.named_buffers():
        assert buf is live[name], name
    # the validation loss, again by JAX from the same variables and batch
    jm = dds.net_postupsampling('resnet', 'spc', scale=SCALE, n_channels=1,
                                n_aux_channels=1, lr_size=(8, 8),
                                n_filters=4, n_blocks=2, attention=True,
                                normalization='bn')
    v = tds.weights.export_jax_variables(tr.ema_net)
    batch = tr.ds_val.step_batch(tr.runner.evals['val'][0], torch.zeros(
        1, dtype=torch.long))
    out = jm.module.apply(v, j(batch['lr'].numpy()), j(batch['aux'].numpy()),
                          training=False)
    want = float(jnp.mean(jnp.abs(out - j(batch['hr'].numpy()))))
    with torch.no_grad():
        got = tr.lossf(batch['hr'], tr.eval_net()(batch['lr'], batch['aux']))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Saving and loading with batch_stats
# ---------------------------------------------------------------------------

def test_save_load_both_ways_with_batch_stats(tmp_path):
    """The port's `save_model` writes the `batch_stats` collection, which
    the JAX `load_model` reads; the JAX `save_model`'s orbax tree and its
    running statistics load into the port. Both reloads serve what the
    saved model serves."""
    jm, v, tm, net, inputs = _model_case('resnet_spc', 'bn', seed=3)
    with torch.no_grad():
        ref = net(*map(t, inputs)).numpy()
    port_dir, jax_dir = str(tmp_path / 'port'), str(tmp_path / 'jax')
    tds.save_model(tm, net, port_dir)
    jm2, v2 = jax_load_model(port_dir)
    assert 'batch_stats' in v2
    np.testing.assert_allclose(np.asarray(jm2.apply(v2, *map(j, inputs))),
                               ref, atol=1e-5, rtol=1e-5)
    dds.models.save_model(jm, v, jax_dir)
    assert os.path.isdir(os.path.join(jax_dir, 'variables'))
    _, net2 = tds.load_model(jax_dir, device='cpu')
    _, net3 = tds.load_model(port_dir, device='cpu')
    with torch.no_grad():
        for other in (net2, net3):
            np.testing.assert_allclose(other(*map(t, inputs)).numpy(), ref,
                                       atol=1e-5, rtol=1e-5)
    for (n, b), c in zip(net.named_buffers(), net3.buffers()):
        assert torch.equal(b, c), n


def test_load_jax_params_needs_the_batch_stats():
    """A bn model loaded from `params` alone would keep mean 0 and var 1:
    `load_jax_params` refuses it, naming the buffers."""
    _, v, tm, _, _ = _model_case('convnet_rc', 'bn')
    with pytest.raises(KeyError, match='BatchNorm_0.mean'):
        tds.load_jax_params(tm.init(0, device='cpu'), np_tree(v['params']))


def test_init_sets_flax_running_statistics():
    """`DSModel.init` gives every batch norm running mean 0 and variance 1,
    scale 1 and bias 0, and every layer norm scale 1 and bias 0, as Flax
    initializes them, whatever the seed."""
    for kind in ('bn', 'ln'):
        tm = tds.net_postupsampling('densenet', 'dc', scale=SCALE,
                                    n_aux_channels=2, normalization=kind,
                                    **SPATIAL)
        got = tds.weights.export_jax_variables(tm.init(5, device='cpu'))
        leaves = {k: v for k, v in flat(got).items()
                  if 'Norm_0/' in k}
        assert len(leaves) == {'bn': 4, 'ln': 2}[kind] * sum(
            1 for k in leaves if k.endswith('/scale'))
        for name, value in leaves.items():
            want = 1.0 if name.endswith(('/scale', '/var')) else 0.0
            np.testing.assert_array_equal(value, np.full_like(value, want),
                                          err_msg=name)
