"""PyTorch port of supervised training against the JAX package on the CPU:
random-patch batch synthesis with fixed indices and offsets (the JAX and
torch random streams differ, so the JAX offsets are drawn from its key and
handed to the port), the epoch index sampler, the mae/mse losses, Adam
steps of the recurrent `recresnet_spc` and of the flagship `resnet_spc`
(attention, loss dssim_mae) from carried weights against the JAX trainer's
`_train_step_batch` on the same batches, one spatial step, the trainer's
loop and the options that are not ported yet. Small sizes, float32.
Tolerances: batches 1e-5 (the matmul resize), losses rtol 1e-5, parameters
after the Adam steps atol 2e-6 (the largest difference seen is 1.9e-7;
Adam's lr * g / (|g| + 1e-7) turns float32 noise in a small gradient into
parameter noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu import losses as jax_losses
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds

HR_Y, HR_X, SCALE, PATCH = 32, 40, 4, 16
N = 10
PARAM_ATOL = 2e-6
REC = dict(backbone='resnet', upsampling='spc', scale=SCALE, patch_size=PATCH,
           batch_size=2, time_window=3, n_blocks=1, n_filters=4, loss='mae',
           verbose=False)
# the flagship, cut to size: resnet_spc with the gates in every residual
# block and the head, trained with the DSSIM loss
FLAGSHIP = dict(REC, time_window=None, n_blocks=2, attention=True,
                loss='dssim_mae')


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(21)
    hr = rng.standard_normal((N, HR_Y, HR_X, 1)).astype(np.float32)
    topo = rng.standard_normal((HR_Y, HR_X)).astype(np.float32)
    mask = (rng.random((HR_Y, HR_X)) > 0.5).astype(np.float32)
    pred = rng.standard_normal((N, HR_Y, HR_X, 2)).astype(np.float32)
    return hr, topo, mask, pred


def _jax_offsets(synth, key, b):
    """The LR crop offsets `_make_batch` draws from `key`
    (dl4ds_tpu/dataloader.py:689-698)."""
    key_y, key_x = jax.random.split(key)
    max_y, max_x = synth.lr_y - synth.patch_lr, synth.lr_x - synth.patch_lr
    return (np.asarray(jax.random.randint(key_y, (b,), 0, max(max_y, 1))),
            np.asarray(jax.random.randint(key_x, (b,), 0, max(max_x, 1))))


@pytest.mark.parametrize('time_window', [None, 3], ids=['4d', '5d'])
@pytest.mark.parametrize('aux', [False, True], ids=['plain', 'statics'])
def test_patch_synthesis_matches_jax(data, time_window, aux):
    """Gather + crop of [B(, T), p, p, C] HR patches, their LR resize, the
    predictor crop at LR, and the statics' HR crop (aux) and LR resize
    (LR channels of spatial samples only)."""
    hr, topo, mask, pred = data
    kw = dict(upsampling='spc', scale=SCALE, batch_size=3, patch_size=PATCH,
              time_window=time_window)
    if aux:
        kw.update(static_vars=[topo, mask], predictors=[pred])
    synth_j = dds.BatchSynthesizer(hr, None, **kw)
    synth_t = tds.BatchSynthesizer(hr, None, device='cpu', **kw)
    idx = np.array([4, 0, 6])
    key = jax.random.PRNGKey(7)
    want = synth_j._make_batch(jnp.asarray(idx), key)
    offsets = _jax_offsets(synth_j, key, 3)
    got = synth_t(torch.from_numpy(idx), offsets=offsets)
    tw = () if time_window is None else (time_window,)
    assert tuple(got['hr'].shape) == (3,) + tw + (PATCH, PATCH, 1)
    assert got['lr'].shape[-1] == synth_t.n_channels_lr
    for name in ('lr', 'hr', 'aux'):
        if want[name] is None:
            assert got[name] is None
            continue
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-5, err_msg=name)


def test_patch_offsets_are_checked_and_drawn_from_the_generator(data):
    synth = tds.BatchSynthesizer(data[0], None, 'spc', SCALE, 2,
                                 patch_size=PATCH, device='cpu')
    with pytest.raises(IndexError):
        synth(torch.tensor([0, 1]), offsets=([0, synth.lr_y], [0, 0]))
    with pytest.raises(ValueError):
        synth(torch.tensor([0, 1]), offsets=([0], [0]))
    a = synth(torch.tensor([0, 1]), generator=torch.Generator().manual_seed(3))
    b = synth(torch.tensor([0, 1]), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a['hr'].numpy(), b['hr'].numpy())


@pytest.mark.parametrize('steps,batch', [(None, 3), (7, 4)])
def test_epoch_indices_wrap_one_permutation(steps, batch):
    """A permutation of the n samples, repeated when the steps need more,
    cut to [steps, batch] (default steps: n // batch), as
    dl4ds_tpu/dataloader.py:786-794."""
    hr = np.zeros((N, 8, 8, 1), np.float32)
    synth = tds.BatchSynthesizer(hr, None, 'spc', SCALE, batch, device='cpu')
    idx = synth.epoch_indices(torch.Generator().manual_seed(0), steps=steps)
    want_steps = N // batch if steps is None else steps
    assert tuple(idx.shape) == (want_steps, batch)
    flat = idx.reshape(-1).numpy()
    perm = flat[:min(N, flat.size)]
    assert len(set(perm)) == perm.size and perm.max() < N
    if flat.size > N:
        np.testing.assert_array_equal(flat[N:], np.tile(perm, 3)[:flat.size - N])
    again = synth.epoch_indices(torch.Generator().manual_seed(0), steps=steps)
    np.testing.assert_array_equal(again.numpy(), idx.numpy())


@pytest.mark.parametrize('name', ['mae', 'mse'])
def test_pixel_losses_match_jax(name):
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((2, 3, 8, 8, 1)).astype(np.float32)
            for _ in range(2))
    want = float(getattr(jax_losses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tds.losses, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert tds.utils.checkarg_loss(name) is getattr(tds.losses, name)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# Adam steps against the JAX trainer
# ---------------------------------------------------------------------------

def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jax_train_steps(hr, lr_decay_after, config):
    """Three `_train_step_batch` steps of the JAX trainer on JAX-built
    batches, with the initial and final parameters."""
    # one device: the tests' 8 host devices would scale the rate by 8
    tr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        learning_rate=(1e-3, 1e-4), lr_decay_after=lr_decay_after,
        devices=jax.devices()[:1], **config)
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
    return dict(lr_decay_after=lr_decay_after, params0=params0,
                params3=_copy_tree(state.params), batches=batches,
                losses=losses)


@pytest.fixture(scope='module', params=[1e5, 1], ids=['constant', 'decay'])
def jax_steps(request, data):
    """The recurrent model's three JAX steps; lr_decay_after=1 switches to
    the second rate from the second update on (optax's count 1 reaches the
    boundary)."""
    return _jax_train_steps(data[0], request.param, REC)


def _port_train_steps(hr, steps, config):
    """The port's trainer on the CPU from the JAX steps' initial weights,
    three `train_step`s on their batches; returns the trainer and the
    losses after checking them and the parameters against the JAX steps."""
    tr = tds.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], device='cpu',
        learning_rate=(1e-3, 1e-4), lr_decay_after=steps['lr_decay_after'],
        **config)
    tr.setup_model()
    tds.load_jax_params(tr.net, steps['params0'])
    tr.setup_optimizer()
    tr.net.train()
    losses = [tr.train_step({k: None if v is None else torch.from_numpy(v)
                             for k, v in b.items()}).item()
              for b in steps['batches']]
    np.testing.assert_allclose(losses, steps['losses'], rtol=1e-5)
    want = tds.load_jax_params(tr.model.init(0, device='cpu'),
                               steps['params3'])
    got = dict(tr.net.named_parameters())
    moved = 0.0
    for name, p in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   err_msg=name)
    for name, p in tds.load_jax_params(tr.model.init(0, device='cpu'),
                                       steps['params0']).named_parameters():
        moved = max(moved, (got[name] - p).abs().max().item())
    assert moved > 1e-4      # the steps moved the weights
    assert tr.n_updates == 3
    return tr


@pytest.mark.parametrize('route', ['fused', 'split'])
def test_recurrent_adam_steps_match_the_jax_trainer(data, jax_steps, route,
                                                    monkeypatch):
    """Three Adam steps with every ConvLSTM layer's backward forced onto
    one route: K3's plain version ('fused') or K4's with the GEMM tail
    ('split')."""
    from dl4ds_tpu_torch.ops import convlstm as conv
    monkeypatch.setattr(conv, 'dispatch_info', lambda *shapes: {
        'path': route, 'reason': 'forced by the test'})
    chains = []
    seq_reference = conv.convlstm_seq_reference
    monkeypatch.setattr(conv, 'convlstm_seq_reference', lambda *a: (
        chains.append(route), seq_reference(*a))[1])
    _port_train_steps(data[0], jax_steps, REC)
    assert len(chains) == 3 * 2 * (1 + REC['n_blocks'])  # a chain a layer


def test_flagship_dssim_adam_steps_match_the_jax_trainer(data, monkeypatch):
    """Three Adam steps of the spatial flagship with attention and loss
    dssim_mae: K1's and K6's plain versions forward, K1's plain backward,
    K6's plain backward (the closed form `ssim_backward_reference`, the
    data range's gradient included) and Adam, against the JAX trainer."""
    from dl4ds_tpu_torch.ops import fused_ops
    calls = []
    plain_ssim = fused_ops.ssim
    plain_backward = fused_ops.ssim_backward_reference
    monkeypatch.setattr(fused_ops, 'ssim', lambda *a: (
        calls.append(('forward', torch.is_grad_enabled())),
        plain_ssim(*a))[1])
    monkeypatch.setattr(fused_ops, 'ssim_backward_reference',
                        lambda *a, **k: (
                            calls.append(('backward', torch.is_grad_enabled())),
                            plain_backward(*a, **k))[1])
    steps = _jax_train_steps(data[0], 1e5, FLAGSHIP)
    launches = (tds.fused_channel_attention.launches,
                tds.fused_ssim_per_image.launches)
    tr = _port_train_steps(data[0], steps, FLAGSHIP)
    gates = [m for m in tr.net.modules()
             if isinstance(m, tds.models.blocks.ChannelAttention2D)]
    assert len(gates) == FLAGSHIP['n_blocks'] + 1
    # K6's plain forward, then its plain backward, every step
    assert calls == [('forward', False), ('backward', False)] * 3
    assert launches == (tds.fused_channel_attention.launches,
                        tds.fused_ssim_per_image.launches)


def test_spatial_adam_step_matches_jax(data):
    """One step of the spatial resnet_spc (time_window None) on a port-built
    batch, against jax.value_and_grad and optax's Adam (eps 1e-7)."""
    hr, topo, mask, _ = data
    kw = dict(REC, time_window=None, static_vars=[topo, mask],
              learning_rate=1e-3)
    tr = tds.SupervisedTrainer(data_train=hr, data_val=hr[:6],
                               data_test=hr[:6], device='cpu', **kw)
    tr.setup_datagen()
    tr.setup_model()
    jm = dds.net_postupsampling('resnet', 'spc', scale=SCALE, n_channels=3,
                                n_aux_channels=2, lr_size=(4, 4), n_filters=4,
                                n_blocks=1)
    params = _copy_tree(jm.init(jax.random.PRNGKey(2))['params'])
    tds.load_jax_params(tr.net, params)
    tr.setup_optimizer()
    tr.net.train()
    batch = tr.ds_train(torch.tensor([1, 8]), offsets=([0, 3], [5, 2]))
    assert tuple(batch['lr'].shape) == (2, 4, 4, 3)
    loss = tr.train_step(batch).item()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def loss_fn(p):
        out = jm.apply({'params': p}, jb['lr'], jb['aux'], training=True)
        return jax_losses.mae(jb['hr'], out)

    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = optax.adam(1e-3, eps=1e-7)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = tds.load_jax_params(tr.model.init(0, device='cpu'), _copy_tree(
        optax.apply_updates(params, updates)))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    got = dict(tr.net.named_parameters())
    for name, p in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def _run(hr, **kwargs):
    args = dict(REC, data_train=hr, data_val=hr[:6], data_test=hr[:6],
                device='cpu', steps_per_epoch=2, validation_steps=1,
                test_steps=1, epochs=2)
    args.update(kwargs)
    return tds.SupervisedTrainer(**args).run()


def test_run_is_reproducible_and_launches_no_kernel_on_the_cpu(data):
    fcl = tds.fused_convlstm
    before = (fcl.launches, fcl.train_launches, fcl.bwd_launches)
    a, b = _run(data[0]), _run(data[0])
    assert (fcl.launches, fcl.train_launches, fcl.bwd_launches) == before
    assert a.fithist == b.fithist and a.test_loss == b.test_loss
    assert len(a.fithist['loss']) == 2
    assert all(np.isfinite(v) for v in a.fithist['loss'] + [a.test_loss])
    assert a.n_updates == 4


def test_early_stopping_counts_patience(data):
    """With min_delta this large only the first epoch improves, so the run
    stops once `patience` epochs have not."""
    tr = _run(data[0], epochs=10, steps_per_epoch=1, early_stopping=True,
              patience=2, min_delta=1e9)
    assert len(tr.fithist['val_loss']) == 3


def test_terminate_on_nan(data):
    hr = data[0].copy()
    hr[:] = np.nan
    with pytest.warns(RuntimeWarning, match='Non-finite'):
        tr = _run(hr, epochs=5)
    assert len(tr.fithist['loss']) == 1


@pytest.mark.parametrize('kwargs', [
    dict(ema_decay=0.9), dict(lr_schedule='cosine'), dict(warmup_steps=5),
    dict(gradient_accumulation_steps=2), dict(save=True),
    dict(save_bestmodel=True), dict(checkpoints_frequency=1),
    dict(resume_from_checkpoint='ckpt'), dict(trained_model=(None, None)),
    dict(save_logs=True),
    dict(steps_per_execution=4), dict(season_ids=([0], [0], [0])),
    dict(data_val_lr=np.zeros((6, 8, 10, 1), np.float32)),
    dict(data_in_hbm=False), dict(mesh=object()), dict(devices=['cpu']),
    dict(init_weights='keras.npz'), dict(backbone='convnet'),
    dict(upsampling='pin')])
def test_unported_training_options_raise(data, kwargs):
    hr = data[0]
    args = dict(REC, data_train=hr, data_val=hr[:6], data_test=hr[:6],
                device='cpu')
    args.update(kwargs)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tds.SupervisedTrainer(**args).run()


def test_trainer_does_not_fall_back_to_the_cpu(data):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the trainer runs there')
    hr = data[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.SupervisedTrainer(data_train=hr, data_val=hr, data_test=hr,
                              **REC)
