"""The port's pre-upsampled ('pin') path against the JAX package on the
CPU: `NetPIN` with the convnet, resnet and densenet backbones and `UnetPIN`
with the 'rc', 'spc' and 'dc' decoders (forward and gradients in float32,
an odd grid, the depth fixed from the HR grid with its warning, a bfloat16
forward), the factories' signatures, the pin `BatchSynthesizer` (full
grids and patches, statics, predictors and given LR arrays, at the JAX
batch's offsets), three Adam steps of `SupervisedTrainer` for BASELINE
configs 1 and 3 cut to size (convnet_pin and unet_pin), `predict` and
`save_model` / `load_model` both ways, the JAX orbax tree included. The
same seeded numpy inputs and the Flax weights carried across by
`load_jax_params` go through both.

Tolerances: the models' float32 forward and gradients atol/rtol 1e-4 (the
gradients' atol scaled by their max |g|), as tests/test_torch_models.py;
the bfloat16 forward by tests/test_torch_bf16_models.py's rules; batches
1e-5 (the matmul resizes); the trainer's losses rtol 1e-5 and parameters
atol 2e-6, as tests/test_torch_training.py; `predict` and a reloaded model
1e-5. Small sizes: n_filters 4, n_blocks 2, grids of 16-40."""

import copy
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu.models import load_model as jax_load_model
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from _torch_xla import quick_xla  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
BF = torch.bfloat16
HR = 24
PIN = dict(n_channels=3, hr_size=(HR, HR), n_filters=4, n_blocks=2,
           attention=True)
UNET = dict(PIN, hr_size=(32, 32))
HR_Y, HR_X, SCALE, PATCH, N = 32, 40, 4, 16, 10
PARAM_ATOL = 2e-6
TRAIN = dict(upsampling='pin', scale=SCALE, patch_size=PATCH, batch_size=2,
             n_filters=4, n_blocks=2, loss='mae', verbose=False)
CONFIGS = {'convnet_pin': dict(TRAIN, backbone='convnet'),
           'unet_pin': dict(TRAIN, backbone='unet')}


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _pair(jax_factory, port_factory, backbone, kwargs, seed=0, dtype=None):
    jm = jax_factory(backbone, **kwargs)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = port_factory(backbone, **(kwargs if dtype is None
                                   else dict(kwargs, dtype=dtype)))
    net = tds.load_jax_params(tm.init(seed, device='cpu'),
                              _np_tree(v['params']))
    return jm, v, tm, net


def _inputs(hw, n_aux, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    if not n_aux:
        return (x,)
    return x, rng.standard_normal((2, *hw, n_aux)).astype(np.float32)


def _check_forward_and_grads(jm, params, net, inputs, seed):
    """The models' outputs and the gradients of mean(out * r) with respect
    to every parameter and the input, within TOL."""
    rest = [_j(a) for a in inputs[1:]]

    def apply(p, x):
        return jm.apply({'params': p}, x, *rest)

    @jax.jit
    def forward_and_grads(p, x, r):
        out, vjp = jax.vjp(apply, p, x)
        return (out,) + vjp(r / r.size)

    shape = jax.eval_shape(apply, params, _j(inputs[0])).shape
    r = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    want, gp, gx = forward_and_grads(params, _j(inputs[0]), jnp.asarray(r))
    x = _t(inputs[0]).requires_grad_(True)
    net.zero_grad()
    out = net(x, *map(_t, inputs[1:]))
    torch.mean(out * _t(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    got = dict(net.named_parameters())
    ref = tds.load_jax_params(copy.deepcopy(net), _np_tree(gp))
    for name, g in ref.named_parameters():
        np.testing.assert_allclose(
            got[name].grad.numpy(), g.detach().numpy(),
            atol=TOL['atol'] * max(float(g.detach().abs().max()), 1e-30),
            rtol=TOL['rtol'], err_msg=name)
    gx = np.asarray(gx)
    np.testing.assert_allclose(x.grad.numpy(), gx,
                               atol=TOL['atol'] * np.abs(gx).max(),
                               rtol=TOL['rtol'])
    return np.asarray(want)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('backbone,n_aux', [('convnet', 2), ('resnet', 0),
                                            ('densenet', 2)])
def test_net_pin_matches_jax(backbone, n_aux):
    """The backbone on the HR grid, [the aux branch], the output module."""
    jm, v, tm, net = _pair(dds.net_pin, tds.net_pin, backbone,
                           dict(PIN, n_aux_channels=n_aux))
    assert tm.name == jm.name == f'{backbone}_pin'
    assert tm.input_shape == jm.input_shape and tm.aux_shape == jm.aux_shape
    assert tm.param_count(net) == jm.param_count(v)
    out = _check_forward_and_grads(jm, v['params'], net,
                                   _inputs((HR, HR), n_aux, 1), 2)
    assert out.shape == (2, HR, HR, 1)


@pytest.mark.parametrize('decoder,n_aux', [('rc', 2), ('spc', 0),
                                           ('dc', 2)])
def test_unet_pin_matches_jax_on_an_odd_grid(decoder, n_aux):
    """The U-Net built for 32x32 on a 27x29 grid: max-pool floors (27 ->
    13 -> 6), and `pad_concat` zero-pads each upsampled map to its skip's
    size (its own grid runs in the bfloat16 and `predict` tests). The tree
    holds the names Flax gives: `EncoderBlock{i}`,
    `Bottleneck`, the auto-named upsamplers, `DecoderConvBlock{j}` and the
    aux `ConvBlock_0`."""
    jm, v, tm, net = _pair(dds.unet_pin, tds.unet_pin, 'unet',
                           dict(UNET, n_aux_channels=n_aux,
                                decoder_upsampling=decoder))
    kind = {'rc': 'ResizeConvolutionBlock', 'spc':
            'SubpixelConvolutionBlock', 'dc': 'DeconvolutionBlock'}[decoder]
    want = {'EncoderBlock1', 'EncoderBlock2', 'Bottleneck', f'{kind}_0',
            f'{kind}_1', 'DecoderConvBlock1', 'DecoderConvBlock2',
            '_OutputModule_0'} | ({'ConvBlock_0'} if n_aux else set())
    assert set(v['params']) == want
    assert tm.name == jm.name == 'unet_pin'
    assert tm.param_count(net) == jm.param_count(v)
    out = _check_forward_and_grads(jm, v['params'], net,
                                   _inputs((27, 29), n_aux, 3), 4)
    assert out.shape == (2, 27, 29, 1)


def test_unet_depth_is_fixed_from_the_hr_grid():
    """`_check_nblocks` lowers the depth, with the JAX package's warning,
    until the bottleneck keeps 2 pixels; the model keeps that depth on
    larger grids."""
    kw = dict(UNET, hr_size=(12, 20), n_blocks=4, n_aux_channels=0)
    with pytest.warns(RuntimeWarning, match='reduced 4 -> 2'):
        jm = dds.unet_pin('unet', **kw)
    with pytest.warns(RuntimeWarning, match='reduced 4 -> 2'):
        tm = tds.unet_pin('unet', **kw)
    assert tm.config['n_blocks'] == jm.module.n_blocks == 2
    assert tds.models.nets._check_nblocks((64, 64), 4) == 4
    v = jax.jit(jm.init)(jax.random.PRNGKey(0))
    net = tds.load_jax_params(tm.init(0, device='cpu'),
                              _np_tree(v['params']))
    x = _inputs((40, 36), 0, 5)[0]
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    with torch.no_grad():
        got = net(_t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('factory,args', [
    ('net_pin', ('convnet', dict(PIN, n_aux_channels=2))),
    ('unet_pin', ('unet', dict(UNET, n_aux_channels=2)))])
def test_bf16_pin_forward_matches_jax(factory, args):
    """tests/test_torch_bf16_models.py's rules: every module the two models
    share has the JAX bfloat16 model's output dtype, and the port's output
    is at most half as far from it as JAX's float32 model is."""
    backbone, kw = args
    j32 = getattr(dds, factory)(backbone, **kw)
    j16 = getattr(dds, factory)(backbone, dtype=jnp.bfloat16, **kw)
    v = jax.jit(j32.init)(jax.random.PRNGKey(0))
    net = tds.load_jax_params(
        getattr(tds, factory)(backbone, dtype=BF, **kw).init(0, device='cpu'),
        _np_tree(v['params']))
    hw = kw['hr_size']
    inputs = _inputs(hw, 2, 6)
    # eagerly, as tests/test_torch_bf16_models.py: under jit XLA keeps the
    # gate's m @ w1 in float32
    want = np.asarray(j16.apply(v, *map(_j, inputs)).astype(jnp.float32))
    y32 = np.asarray(j32.apply(v, *map(_j, inputs)))
    _, state = j16.module.apply(v, *map(_j, inputs),
                                capture_intermediates=True,
                                mutable=['intermediates'])
    want_dtypes = {}

    def walk(tree, path):
        for key, val in tree.items():
            if key == '__call__':
                y = jax.tree_util.tree_leaves(val[0])[0]
                want_dtypes['.'.join(path)] = jnp.dtype(y.dtype).name
            elif isinstance(val, dict):
                walk(val, path + [key])
    walk(state['intermediates'], [])
    got_dtypes = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=name: got_dtypes.__setitem__(
            n, str((o[0] if isinstance(o, tuple) else o).dtype).replace(
                'torch.', '')))
        for name, m in net.named_modules()]
    with torch.no_grad():
        y = net(*map(_t, inputs))
    for h in hooks:
        h.remove()
    shared = sorted(set(want_dtypes) & set(got_dtypes))
    assert len(shared) >= 10
    assert {k: got_dtypes[k] for k in shared} == \
        {k: want_dtypes[k] for k in shared}
    scale = np.abs(want).max()
    port = np.abs(y.float().numpy() - want).max() / scale
    own = np.abs(y32 - want).max() / scale
    assert own > 1e-3 and port <= 0.5 * own, (port, own)


def _parameters(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize('name', ['net_pin', 'unet_pin'])
def test_factory_signatures_equal_the_jax_ones(name):
    """The JAX parameters, in order, with the defaults; a dtype's default
    is torch's float32 for jnp's."""
    want = [p if p[0] != 'dtype' else p[:2] + (torch.float32,)
            for p in _parameters(getattr(dds, name))]
    assert _parameters(getattr(tds, name)) == want


def test_unported_pin_configurations_raise():
    with pytest.raises(NotImplementedError, match='item 5'):
        tds.build_model('convnet', 'pin', 4, 1, 0, (8, 8), (32, 32),
                        time_window=3, dtype=torch.float16)


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(21)
    hr = rng.standard_normal((N, HR_Y, HR_X, 1)).astype(np.float32)
    lr = rng.standard_normal((N, 8, 10, 1)).astype(np.float32)
    topo = rng.standard_normal((HR_Y, HR_X)).astype(np.float32)
    mask = (rng.random((HR_Y, HR_X)) > 0.5).astype(np.float32)
    pred = rng.standard_normal((N, 8, 10, 2)).astype(np.float32)
    return hr, lr, topo, mask, pred


def _jax_offsets(synth, key, b):
    """The HR crop offsets `_make_batch` draws for 'pin'
    (dl4ds_tpu/dataloader.py:683-698)."""
    key_y, key_x = jax.random.split(key)
    p = synth.patch_size
    return (np.asarray(jax.random.randint(key_y, (b,), 0,
                                          max(synth.hr_y - p, 1))),
            np.asarray(jax.random.randint(key_x, (b,), 0,
                                          max(synth.hr_x - p, 1))))


@pytest.mark.parametrize('given', [False, True], ids=['coarsened', 'given'])
@pytest.mark.parametrize('patch', [None, 14], ids=['grid', 'patches'])
@pytest.mark.parametrize('aux', [False, True], ids=['plain', 'aux'])
def test_pin_batches_match_jax(data, given, patch, aux):
    """The LR field (given, or the HR coarsened) interpolated back to the
    HR grid once (`lr_pre`), the HR and LR crops at the same HR offsets (a
    patch of 14 does not divide by the scale), the predictors at HR, the
    HR statics as LR statics, the season channels on the HR grid."""
    hr, lr, topo, mask, pred = data
    kw = dict(upsampling='pin', scale=SCALE, batch_size=3, patch_size=patch)
    if aux:
        kw.update(static_vars=[topo, mask], predictors=[pred],
                  season_ids=np.arange(N) % 4)
    array_lr = lr if given else None
    synth_j = dds.BatchSynthesizer(hr, array_lr, **kw)
    synth_t = tds.BatchSynthesizer(hr, array_lr, device='cpu', **kw)
    assert synth_t.lr_pre.shape == synth_j.lr_pre.shape == (N, HR_Y, HR_X, 1)
    assert synth_t.lr_sample_hw == synth_j.lr_sample_hw == \
        synth_t.hr_sample_hw
    assert (synth_t.n_channels_lr, synth_t.n_channels_aux) == \
        (synth_j.n_channels_lr, synth_j.n_channels_aux)
    idx = np.array([4, 0, 9])
    key = jax.random.PRNGKey(7)
    want = synth_j._make_batch(jnp.asarray(idx), key)
    offsets = _jax_offsets(synth_j, key, 3) if patch else None
    got = synth_t(torch.from_numpy(idx), offsets=offsets)
    assert got['lr'].shape[-1] == synth_t.n_channels_lr
    for name in ('lr', 'hr', 'aux'):
        if want[name] is None:
            assert got[name] is None
            continue
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-5, err_msg=name)


def test_pin_patch_offsets_are_hr_ones(data):
    hr = data[0]
    synth = tds.BatchSynthesizer(hr, None, 'pin', SCALE, 2, patch_size=14,
                                 device='cpu')
    with pytest.raises(IndexError):
        synth(torch.tensor([0, 1]), offsets=([0, HR_Y - 13], [0, 0]))
    batch = synth(torch.tensor([0, 1]), offsets=([HR_Y - 14, 3],
                                                 [HR_X - 14, 7]))
    np.testing.assert_array_equal(batch['hr'][0].numpy(),
                                  hr[0, HR_Y - 14:, HR_X - 14:])
    plan = synth.plan(torch.Generator().manual_seed(0), 50)
    assert int(plan['ys'].max()) == HR_Y - 14 - 1
    assert int(plan['xs'].max()) == HR_X - 14 - 1


# ---------------------------------------------------------------------------
# Training against the JAX trainer
# ---------------------------------------------------------------------------

def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def jax_steps(request, data):
    """Three `_train_step_batch` Adam steps of the JAX trainer for a pin
    configuration, with statics, on its own batches."""
    config = dict(CONFIGS[request.param], static_vars=list(data[2:4]))
    hr = data[0]
    tr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        learning_rate=(1e-3, 1e-4), devices=jax.devices()[:1], **config)
    tr.setup_datagen()
    tr.setup_model()
    params0 = _copy_tree(tr.variables['params'])
    state = jax_supervised.TrainState.create(
        apply_fn=tr.model.module.apply, params=tr.variables['params'],
        tx=tr._build_optimizer())
    tr._make_steps()
    batches, losses = [], []
    for i, idx in enumerate(([0, 5], [6, 2], [3, 3])):
        key = jax.random.PRNGKey(i)
        batch = tr.ds_train._make_batch(jnp.asarray(idx), key)
        batches.append({k: (None if v is None else np.array(v))
                        for k, v in batch.items()})
        state, loss = tr._train_step_batch(state, batch, key)
        losses.append(float(loss))
    return dict(name=request.param, config=config, params0=params0,
                params3=_copy_tree(state.params), batches=batches,
                losses=losses, model_name=tr.model.name)


def test_pin_adam_steps_match_the_jax_trainer(data, jax_steps):
    """BASELINE configs 1 and 3 cut to size: the port's trainer from the
    JAX trainer's initial weights, three `train_step`s on its batches; the
    K1 gate of the output head runs its plain versions both ways."""
    hr = data[0]
    tr = tds.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], device='cpu',
        learning_rate=(1e-3, 1e-4), **jax_steps['config'])
    tr.setup_model()
    assert tr.model.name == jax_steps['model_name']
    assert tr.model.input_shape == (PATCH, PATCH, 3)
    tds.load_jax_params(tr.net, jax_steps['params0'])
    tr.setup_optimizer()
    tr.net.train()
    launches = (tds.fused_channel_attention.launches,
                tds.fused_channel_attention.bwd_launches)
    losses = [tr.train_step({k: _t(v) for k, v in b.items()}).item()
              for b in jax_steps['batches']]
    np.testing.assert_allclose(losses, jax_steps['losses'], rtol=1e-5)
    want = tds.load_jax_params(tr.model.init(0, device='cpu'),
                               jax_steps['params3'])
    got = dict(tr.net.named_parameters())
    for name, p in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   err_msg=name)
    assert launches == (tds.fused_channel_attention.launches,
                        tds.fused_channel_attention.bwd_launches)
    assert tr.n_updates == 3


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_pin_trainer_runs(data, name):
    """`run()` with validation and test on the pin batches: finite losses,
    the same history twice from one seed."""
    hr = data[0]
    args = dict(CONFIGS[name], data_train=hr, data_val=hr[:6],
                data_test=hr[:6], device='cpu', epochs=2, steps_per_epoch=2,
                validation_steps=1, test_steps=1)
    a = tds.SupervisedTrainer(**args).run()
    b = tds.SupervisedTrainer(**args).run()
    assert a.fithist == b.fithist and a.test_loss == b.test_loss
    assert all(np.isfinite(v) for v in a.fithist['loss'] + [a.test_loss])
    assert a.ds_train.lr_pre is not None and a.ds_train.lr is None


# ---------------------------------------------------------------------------
# Serving and saving
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def served():
    """A convnet_pin and a unet_pin (depth 2) with statics and a predictor,
    as JAX (model, variables) and port (model, net) pairs."""
    out = {}
    for factory, backbone in (('net_pin', 'convnet'), ('unet_pin', 'unet')):
        kw = dict(n_channels=4, n_aux_channels=2, hr_size=(HR_Y, HR_X),
                  n_filters=4, n_blocks=2, attention=True)
        jm, v, tm, net = _pair(getattr(dds, factory), getattr(tds, factory),
                               backbone, kw, seed=3)
        out[backbone] = (jm, v, tm, net)
    return out


@pytest.mark.parametrize('backbone', ['convnet', 'unet'])
@pytest.mark.parametrize('in_hr', [True, False], ids=['hr', 'lr'])
def test_pin_predict_matches_jax(data, served, backbone, in_hr):
    """HR grids coarsened by `scale` and interpolated back
    (`array_in_hr=True`), or LR grids interpolated to HR, with statics and
    a predictor, a ragged tail, and `pad_to_multiple` (aux padded by a
    factor of 1); the U-Net also serves a 27x35 grid, which its 32x40
    build does not divide."""
    hr, lr, topo, mask, _ = data
    jm, v, tm, net = served[backbone]
    rng = np.random.default_rng(8)
    grids = hr[:5] if in_hr else lr[:5]
    pred = rng.standard_normal(grids.shape).astype(np.float32)
    kw = dict(scale=SCALE, array_in_hr=in_hr, static_vars=[topo, mask],
              predictors=[pred], batch_size=2)
    want = np.asarray(dds.predict((jm, v), grids, **kw), np.float32)
    got = tds.predict((tm, net), grids, device='cpu', **kw)
    assert got.shape == want.shape == (5, HR_Y, HR_X, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if in_hr:
        want = np.asarray(dds.predict((jm, v), grids, pad_to_multiple=12,
                                      **kw), np.float32)
        got = tds.predict((tm, net), grids, device='cpu', pad_to_multiple=12,
                          **kw)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if backbone == 'unet' and in_hr:
        odd = dict(kw, static_vars=[topo[:27, :35], mask[:27, :35]],
                   predictors=[pred[:, :27, :35]])
        want = np.asarray(dds.predict((jm, v), grids[:, :27, :35], **odd),
                          np.float32)
        got = tds.predict((tm, net), grids[:, :27, :35], device='cpu', **odd)
        assert got.shape == (5, 27, 35, 1)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pin_predictor_defaults_to_lr_input(data, served):
    jm, v, tm, net = served['convnet']
    _, lr, topo, mask, _ = data
    pred = np.zeros(lr[:3].shape, np.float32)
    kw = dict(static_vars=[topo, mask], predictors=[pred], batch_size=2)
    got = tds.Predictor((tm, net), lr[:3], SCALE, device='cpu', **kw).run()
    want = tds.predict((tm, net), lr[:3], SCALE, array_in_hr=False,
                       device='cpu', **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('backbone', ['convnet', 'unet'])
def test_pin_save_load_both_ways(data, served, backbone, tmp_path):
    """The port's `save_model` read by the JAX `load_model` (the module
    class and its fields), and the JAX `save_model`'s orbax tree read by
    the port's `load_model` (through tensorstore); a U-Net keeps the depth
    of its config. Both reloads serve what the saved model serves."""
    hr, _, topo, mask, _ = data
    jm, v, tm, net = served[backbone]
    x = np.random.default_rng(9).standard_normal((2, HR_Y, HR_X, 4)).astype(
        np.float32)
    aux = np.stack([np.stack([topo, mask], -1)] * 2)
    with torch.no_grad():
        ref = net(_t(x), _t(aux)).numpy()
    port_dir, jax_dir = str(tmp_path / 'port'), str(tmp_path / 'jax')
    tds.save_model(tm, net, port_dir)
    jm2, v2 = jax_load_model(port_dir)
    assert type(jm2.module).__name__ == type(jm.module).__name__
    assert jm2.module == jm.module.clone()
    np.testing.assert_allclose(
        np.asarray(jm2.apply(v2, jnp.asarray(x), jnp.asarray(aux))), ref,
        atol=1e-5, rtol=0)
    dds.models.save_model(jm, v, jax_dir)
    assert os.path.isdir(os.path.join(jax_dir, 'variables'))
    model, net2 = tds.load_model(jax_dir, device='cpu')
    assert model.name == tm.name and model.config == tm.config
    assert model.module_class == tm.module_class
    with torch.no_grad():
        np.testing.assert_allclose(net2(_t(x), _t(aux)).numpy(), ref,
                                   atol=1e-5, rtol=0)
    model3, net3 = tds.load_model(port_dir, device='cpu')
    assert model3.config == tm.config
    for (n, p), q in zip(net.named_parameters(), net3.parameters()):
        assert torch.equal(p, q), n
