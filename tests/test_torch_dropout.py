"""The port's dropout variants, `DropPath` and the random stream of
training against the JAX package on the CPU: each variant of `Dropout` at
`dim` 2 and 3, in float32 and bfloat16, held exactly against the JAX
module on JAX's own draws (recorded from `jax.random` and fed through the
port's `_dropout_mask`); the 'mc*' variants in eval mode, with and without
a generator; `DropPath`; whole models in train mode against JAX on JAX's
draws in call order; the structure of the port's own draws (keep share,
broadcast axes, the gaussian noise's moments); `remat` with dropout and bn
(the same loss, gradients and running statistics as without); and a
trainer's checkpoint resumed with bn and dropout, bit for bit.

Tolerances: the modules exactly (the same draws, the same arithmetic);
the models as tests/_torch_state.py (atol/rtol 1e-4); the port's own
draws within 5 standard errors of their expected moments. Small sizes:
n_filters 4, n_blocks 1, 8x8 LR grids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu.models import blocks as jblocks

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.models import blocks as tblocks

from _torch_state import t, j, load, jax_draws, fed_draws, check_train_step

VARIANTS = [None, 'gaussian', 'spatial', 'mcdrop', 'mcgaussiandrop',
            'mcspatialdrop']
RATE = 0.3
LR, SCALE = 8, 2


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _x(shape, dtype=np.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x if dtype == np.float32 else np.asarray(
        jnp.asarray(x).astype(jnp.bfloat16))


def _jax_dropout(module, x, training, key=0):
    """The JAX module's output and draws, eagerly."""
    rngs = {'dropout': jax.random.PRNGKey(key)} if key is not None else None
    with jax_draws() as draws:
        y = module.apply({}, j(x), training=training, rngs=rngs)
    return np.asarray(y), draws


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('dim,shape', [(2, (3, 5, 6, 4)), (3, (2, 3, 5, 6, 4)),
                                       (2, (2, 3, 5, 6, 4))],
                         ids=['dim2', 'dim3', 'dim2-rank5'])
@pytest.mark.parametrize('variant', VARIANTS)
def test_dropout_matches_jax_exactly(variant, dim, shape, dtype):
    """Train mode: the port's output on JAX's draws has the JAX module's
    bits, in the input's dtype; kept values are x / keep with keep rounded
    to the dtype as JAX's weak typing rounds it."""
    x = _x(shape, np.float32 if dtype == 'float32' else jnp.bfloat16)
    want, draws = _jax_dropout(jblocks.Dropout(RATE, variant, dim=dim), x,
                               True)
    assert len(draws) == 1
    mod = tblocks.Dropout(RATE, variant, dim=dim).train()
    mod.generator = torch.Generator().manual_seed(0)
    with fed_draws(draws):
        got = mod(t(x))
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(_bits(got.float().numpy().astype(
        want.dtype) if dtype == 'bfloat16' else got.numpy()), _bits(want))


@pytest.mark.parametrize('variant', VARIANTS)
def test_dropout_in_eval_mode(variant):
    """Eval mode: the vanilla, gaussian and spatial variants are the
    identity; the 'mc*' ones stay active. Without a generator an 'mc*'
    call is one fixed member (the JAX package's PRNGKey(0) fallback: the
    port on JAX's draw gives JAX's bits; its own draw repeats from call to
    call); with a generator the draws move on."""
    x = _x((8, 5, 5, 16))
    mod = tblocks.Dropout(RATE, variant).eval()
    if variant not in tblocks._MC_VARIANTS:
        assert mod(t(x)) is not None and torch.equal(mod(t(x)), t(x))
        want, draws = _jax_dropout(jblocks.Dropout(RATE, variant), x, False,
                                   key=None)
        assert not draws and np.array_equal(want, x)
        return
    want, draws = _jax_dropout(jblocks.Dropout(RATE, variant), x, False,
                               key=None)
    with fed_draws(draws):
        np.testing.assert_array_equal(mod(t(x)).numpy(), want)
    fixed = mod(t(x))
    assert torch.equal(fixed, mod(t(x))) and not torch.equal(fixed, t(x))
    mod.generator = torch.Generator().manual_seed(0)
    assert torch.equal(mod(t(x)), fixed)    # a seed-0 generator, afresh
    assert not torch.equal(mod(t(x)), fixed)


def test_dropout_in_train_mode_needs_a_generator():
    mod = tblocks.Dropout(RATE, 'mcdrop').train()
    with pytest.raises(ValueError, match='generator'):
        mod(torch.ones(2, 3, 3, 1))
    assert torch.equal(tblocks.Dropout(0.0).train()(torch.ones(2)),
                       torch.ones(2))


def test_dropout_factories_are_the_jax_ones():
    for name in ('MCDropout', 'MCGaussianDropout', 'MCSpatialDropout2D',
                 'MCSpatialDropout3D'):
        want = getattr(jblocks, name)(0.25)
        got = getattr(tds, name)(0.25)
        assert (got.rate, got.variant, got.dim) == (want.rate, want.variant,
                                                    want.dim), name
    got = tds.get_dropout_layer(0.1, 'spatial', dim=3)
    want = jblocks.get_dropout_layer(0.1, 'spatial', dim=3)
    assert (got.rate, got.variant, got.dim) == (want.rate, want.variant,
                                                want.dim)
    with pytest.raises(ValueError, match='dropout_variant'):
        tblocks.Dropout(0.1, 'alpha')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_drop_path_matches_jax_exactly(dtype):
    """Per-sample stochastic depth x / keep * floor(keep + U) on JAX's
    uniform draw; the identity in eval mode and at rate 0."""
    x = _x((6, 4, 5, 3), np.float32 if dtype == 'float32' else jnp.bfloat16)
    jm = jblocks.DropPath(0.4)
    with jax_draws() as draws:
        want = np.asarray(jm.apply({}, j(x), training=True,
                                   rngs={'dropout': jax.random.PRNGKey(3)}))
    mod = tds.DropPath(0.4).train()
    mod.generator = torch.Generator().manual_seed(0)
    with fed_draws(draws):
        got = mod(t(x))
    np.testing.assert_array_equal(_bits(got.float().numpy().astype(
        want.dtype) if dtype == 'bfloat16' else got.numpy()), _bits(want))
    assert torch.equal(mod.eval()(t(x)), t(x))
    assert torch.equal(tds.DropPath(0.0).train()(t(x)), t(x))


def test_the_ports_own_draws():
    """The port's draws with a fixed seed: the keep share of a mask, the
    spatial masks' broadcast axes (H, W at dim 2; T, H, W at dim 3 on a
    rank-5 input), the gaussian noise's mean 1 and variance rate / (1 -
    rate), each within 5 standard errors; the same seed gives the same
    bits, another seed others."""
    gen = torch.Generator().manual_seed(13)
    x = torch.ones(64, 16, 16, 8)
    keep = 1 - RATE
    y = tblocks.Dropout(RATE).train()
    y.generator = gen
    out = y(x)
    share = float((out != 0).float().mean())
    n = x.numel()
    assert abs(share - keep) < 5 * (keep * RATE / n) ** 0.5
    assert torch.allclose(out[out != 0], torch.tensor(1 / keep))
    for dim, shape, bcast in ((2, (8, 16, 16, 8), (1, 2)),
                              (3, (8, 3, 16, 16, 8), (1, 2, 3)),
                              (2, (8, 3, 16, 16, 8), (2, 3))):
        mod = tblocks.Dropout(RATE, 'spatial', dim=dim).train()
        mod.generator = gen
        kept = mod(torch.ones(shape)) != 0
        for ax in bcast:
            assert torch.equal(kept, kept.narrow(ax, 0, 1).expand(shape))
        other = [ax for ax in range(len(shape)) if ax not in bcast]
        assert not torch.equal(kept, kept.narrow(other[-1], 0, 1).expand(
            shape))
    g = tblocks.Dropout(RATE, 'gaussian').train()
    g.generator = gen
    noise = g(x).double()
    var = RATE / keep
    assert abs(float(noise.mean()) - 1) < 5 * (var / n) ** 0.5
    assert abs(float(noise.var()) - var) < 5 * var * (2 / n) ** 0.5
    a, b, c = (tblocks._dropout_mask((1000,), keep, torch.Generator()
                                     .manual_seed(s), torch.float32, 'cpu')
               for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

MODELS = {
    'resnet_spc_bn_mcdrop': (
        (dds.net_postupsampling, tds.net_postupsampling), ('resnet', 'spc'),
        dict(scale=SCALE, n_aux_channels=2, normalization='bn',
             dropout_rate=RATE, dropout_variant='mcdrop'),
        ((2, LR, LR, 3), (2, LR * SCALE, LR * SCALE, 2))),
    'convnet_rc_gaussian': (
        (dds.net_postupsampling, tds.net_postupsampling), ('convnet', 'rc'),
        dict(scale=SCALE, n_aux_channels=0, dropout_rate=RATE,
             dropout_variant='gaussian'), ((2, LR, LR, 3),)),
    'unet_pin_spatial': (
        (dds.unet_pin, tds.unet_pin), ('unet',),
        dict(n_aux_channels=0, hr_size=(16, 16), dropout_rate=RATE,
             dropout_variant='spatial'), ((2, 16, 16, 3),)),
    'recresnet_spc_ln_mcspatialdrop': (
        (dds.recnet_postupsampling, tds.recnet_postupsampling),
        ('resnet', 'spc'),
        dict(scale=SCALE, n_aux_channels=0, time_window=3, lr_size=(6, 6),
             normalization='ln', dropout_rate=RATE,
             dropout_variant='mcspatialdrop'), ((2, 3, 6, 6, 3),)),
}


def _model(name, seed=0):
    (jf, tf), args, kwargs, shapes = MODELS[name]
    kw = dict(dict(n_channels=3, lr_size=(LR, LR), n_filters=4, n_blocks=1,
                   attention=True, n_channels_out=3), **kwargs)
    if jf is dds.unet_pin:
        kw.pop('lr_size')
    jm = jf(*args, **kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = tf(*args, **kw)
    net = load(tm.init(seed, device='cpu'), v)
    rng = np.random.default_rng(seed + 20)
    inputs = tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)
    return jm, v, tm, net, inputs


@pytest.mark.parametrize('name', sorted(MODELS))
def test_models_with_dropout_match_jax(name):
    """A whole model in train mode on JAX's draws, in call order (the
    blocks' dropouts, the backbone's, the output head's vanilla one): the
    forward, the gradients and the running statistics; an 'mc*' model in
    eval mode on the fixed key's draws too."""
    jm, v, tm, net, inputs = _model(name)
    tblocks.set_dropout_generator(net, torch.Generator().manual_seed(0))
    check_train_step(jm.module.apply, v, net, inputs, 21, training=True,
                     rngs={'dropout': jax.random.PRNGKey(21)}, eager=True)
    if tm.config['dropout_variant'].startswith('mc'):
        tblocks.set_dropout_generator(net, None)
        check_train_step(jm.module.apply, v, load(net, v), inputs, 22,
                         training=False, eager=True)


# ---------------------------------------------------------------------------
# remat and the trainer's random stream
# ---------------------------------------------------------------------------

def _remat_step(remat, seed=4):
    tm = tds.net_postupsampling(
        'resnet', 'spc', scale=SCALE, n_channels=3, n_aux_channels=0,
        lr_size=(LR, LR), n_filters=4, n_blocks=2, attention=True,
        normalization='bn', dropout_rate=RATE, dropout_variant='spatial',
        remat=remat)
    net = tm.init(0, device='cpu').train()
    tblocks.set_dropout_generator(net, torch.Generator().manual_seed(seed))
    x = torch.from_numpy(_x((2, LR, LR, 3), seed=5))
    loss = net(x).square().mean()
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in net.named_parameters()},
            dict(net.named_buffers()))


def test_remat_replays_the_masks_and_moves_the_statistics_once():
    """A training step with `remat` recomputes each block in the backward
    pass on the masks its forward drew and moves the running statistics
    once: the same loss, gradients and buffers as without remat. (Torch's
    checkpoint would redraw the masks from the global RNG, not the
    explicit generator, and move the statistics again.)"""
    loss, grads, bufs = _remat_step(False)
    loss_r, grads_r, bufs_r = _remat_step(True)
    assert torch.equal(loss, loss_r)
    for name in grads:
        torch.testing.assert_close(grads_r[name], grads[name], rtol=0,
                                   atol=1e-7, msg=name)
    for name in bufs:
        assert torch.equal(bufs_r[name], bufs[name]), name
    assert any(b.abs().max() > 0 for n, b in bufs.items()
               if n.endswith('mean'))


SMALL = dict(backbone='resnet', upsampling='spc', scale=SCALE,
             patch_size=16, batch_size=2, n_filters=4, n_blocks=1,
             loss='mae', verbose=False, attention=True, normalization='bn',
             dropout_rate=RATE, dropout_variant='mcdrop', device='cpu')


def _trainer(hr, **kwargs):
    args = dict(SMALL, data_train=hr, data_val=hr[:6], data_test=hr[:6],
                steps_per_epoch=2, validation_steps=1, test_steps=1,
                epochs=2)
    args.update(kwargs)
    return tds.SupervisedTrainer(**args)


def _state(tr):
    return {n: p.detach().clone() for n, p in
            list(tr.train_net.named_parameters())
            + list(tr.train_net.named_buffers())}


def test_resume_with_bn_and_dropout_equals_an_unbroken_run(tmp_path):
    """Epochs with full checkpoints, the rest resumed from the one after
    epoch 1: the bits of 3 unbroken epochs, the running statistics and the
    EMA included, since the checkpoint holds the dropout generator's state
    beside the plan generator's (a resumed run does not replay the masks);
    the validation and test draws ('mcdrop' is active in eval mode) too."""
    hr = np.random.default_rng(6).standard_normal((10, 16, 16, 1)).astype(
        np.float32)
    whole = _trainer(hr, epochs=3, ema_decay=0.5).run()
    _trainer(hr, epochs=1, checkpoints_frequency=1, save_path=str(tmp_path),
             ema_decay=0.5).run()
    ckpt = tmp_path / 'checkpoints' / 'epoch-1'
    saved = torch.load(ckpt / 'checkpoint.pt', weights_only=True)
    assert 'dropout_generator' in saved
    rest = _trainer(hr, epochs=3, resume_from_checkpoint=str(ckpt),
                    ema_decay=0.5).run()
    assert rest.fithist['loss'] == whole.fithist['loss'][1:]
    assert rest.fithist['val_loss'] == whole.fithist['val_loss'][1:]
    assert rest.test_loss == whole.test_loss
    a, b = _state(rest), _state(whole)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for (n, p), q in zip(rest.ema_net.named_parameters(),
                         whole.ema_net.parameters()):
        assert torch.equal(p, q), n
    # the masks move on: the two halves of the unbroken run differ
    again = _trainer(hr, epochs=3, ema_decay=0.5).run()
    assert again.fithist == whole.fithist
