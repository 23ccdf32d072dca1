"""The port's trainer options against the JAX trainer on the CPU: the rate
schedules against the optax schedules the JAX trainer builds, at every
update count of the run (float32 rounding: rtol 1e-6), a caller's schedule
on the device count, the JAX trainer's checks of the options, and three
Adam steps of the cut flagship (`resnet_spc`, attention, dssim_mae) from
carried weights against the JAX trainer's `_train_step_batch` on the same
batches with a cosine schedule and EMA, and with gradient accumulation over
2 microbatches (EMA gated on the commit; the first and third steps leave
the parameters as they were). Tolerances as `test_torch_training.py`:
losses rtol 1e-5, parameters and EMA atol 2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from _torch_xla import quick_xla  # noqa: F401

HR_Y, HR_X, SCALE, PATCH = 32, 40, 4, 16
N = 10
PARAM_ATOL = 2e-6
FLAGSHIP = dict(backbone='resnet', upsampling='spc', scale=SCALE,
                patch_size=PATCH, batch_size=2, n_blocks=2, n_filters=4,
                attention=True, loss='dssim_mae', verbose=False)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def hr():
    return np.random.default_rng(21).standard_normal(
        (N, HR_Y, HR_X, 1)).astype(np.float32)


def _trainers(hr, **kwargs):
    """The JAX trainer (one device: the tests' 8 host devices would scale
    the rate by 8) and the port's, with their optimizers set up."""
    args = dict(FLAGSHIP, data_train=hr, data_val=hr[:6], data_test=hr[:6],
                steps_per_epoch=4, epochs=3, **kwargs)
    jt = jax_supervised.SupervisedTrainer(devices=jax.devices()[:1],
                                          save=False, **args)
    jt.setup_datagen()
    jt.setup_model()
    tx = jt._build_optimizer()
    tt = tds.SupervisedTrainer(device='cpu', **args)
    tt.setup_model()
    tt.setup_optimizer()
    return jt, tx, tt


@pytest.mark.parametrize('kwargs', [
    dict(learning_rate=(1e-3, 1e-4), lr_decay_after=5),
    dict(learning_rate=(1e-3, 1e-4), lr_schedule='cosine'),
    dict(learning_rate=2e-3, lr_schedule='cosine'),
    dict(learning_rate=(1e-3, 1e-5), lr_schedule='warmup_cosine'),
    dict(learning_rate=(1e-3, 1e-5), lr_schedule='warmup_cosine',
         warmup_steps=5)],
    ids=['piecewise', 'cosine', 'cosine-to-0', 'warmup-cosine-default',
         'warmup-cosine-5'])
def test_schedules_match_optax(hr, kwargs):
    """The rate at every count 0 .. the run's 12 updates and past it."""
    jt, _, tt = _trainers(hr, **kwargs)
    total = 4 * 3
    for count in range(total + 3):
        c = torch.tensor(count, dtype=torch.int32)
        got = tt._schedule(c)
        want = np.float32(jt._lr(jnp.int32(count)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0,
                                   err_msg=f'count {count}')


def test_constant_rate_is_no_schedule(hr):
    jt, _, tt = _trainers(hr, learning_rate=5e-4)
    assert tt._schedule is None and jt._lr == 5e-4
    assert tt._lr.item() == np.float32(5e-4)


def test_a_callable_schedule_takes_the_device_count(hr):
    """A caller's schedule is used as given, on the int32 update count; the
    rate of each update is its value at the updates made before it."""
    seen = []

    def schedule(count):
        seen.append(count.dtype)
        return 1e-3 * 0.5 ** (count // 2).to(torch.float32)

    tr = tds.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], device='cpu',
        lr_schedule=schedule, steps_per_epoch=3, epochs=1,
        validation_steps=1, test_steps=1,
        **dict(FLAGSHIP, loss='mae', attention=False, n_blocks=1)).run()
    assert tr.n_updates == 3 and set(seen) == {torch.int32}
    assert tr._lr.item() == np.float32(1e-3 * 0.5)   # count 2's rate


@pytest.mark.parametrize('kwargs,match', [
    (dict(lr_schedule='linear'), "`lr_schedule` must be None, 'cosine'"),
    (dict(warmup_steps=-1), '`warmup_steps` must be >= 0'),
    (dict(ema_decay=1.0), r'`ema_decay` must be in \[0, 1\)'),
    (dict(ema_decay=-0.1), r'`ema_decay` must be in \[0, 1\)'),
    (dict(gradient_accumulation_steps=0), '`gradient_accumulation_steps`'),
    (dict(gradient_accumulation_steps=1.5), '`gradient_accumulation_steps`'),
    (dict(steps_per_execution=0), '`steps_per_execution`')])
def test_option_checks(hr, kwargs, match):
    """The JAX trainer's checks and messages
    (dl4ds_tpu/training/supervised.py:122-128, 147-148, 189-193)."""
    with pytest.raises(ValueError, match=match):
        tds.SupervisedTrainer(data_train=hr, data_val=hr, data_test=hr,
                              device='cpu', **FLAGSHIP, **kwargs)


# ---------------------------------------------------------------------------
# Adam steps against the JAX trainer
# ---------------------------------------------------------------------------

def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jax_steps(hr, **kwargs):
    """Three `_train_step_batch` steps of the JAX trainer (with an EMA copy
    in its state when asked, as its `run` makes it), with the parameters
    and the EMA after each."""
    jt, tx, _ = _trainers(hr, learning_rate=(1e-3, 1e-4), **kwargs)
    params0 = _copy_tree(jt.variables['params'])
    state = jax_supervised.TrainState.create(
        apply_fn=jt.model.module.apply, params=jt.variables['params'],
        tx=tx, ema_params=(jax.tree.map(jnp.array, jt.variables['params'])
                           if jt.ema_decay > 0 else None))
    jt._make_steps()
    out = dict(params0=params0, batches=[], losses=[], params=[], ema=[])
    for i, idx in enumerate(([0, 5], [6, 2], [3, 3])):
        key = jax.random.PRNGKey(i)
        batch = jt.ds_train._make_batch(jnp.asarray(idx), key)
        out['batches'].append({k: (None if v is None else np.array(v))
                               for k, v in batch.items()})
        state, loss = jt._train_step_batch(state, batch, key)
        out['losses'].append(float(loss))
        out['params'].append(_copy_tree(state.params))
        out['ema'].append(None if state.ema_params is None
                          else _copy_tree(state.ema_params))
    return out


def _check(tr, net, tree, what):
    want = tds.load_jax_params(tr.model.init(0, device='cpu'), tree)
    got = dict(net.named_parameters())
    for name, p in want.named_parameters():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   err_msg=f'{what}: {name}')


@pytest.mark.parametrize('kwargs', [
    dict(lr_schedule='cosine', ema_decay=0.9),
    dict(gradient_accumulation_steps=2, ema_decay=0.9)],
    ids=['cosine-ema', 'accumulate-2-ema'])
def test_adam_steps_match_the_jax_trainer(hr, kwargs):
    steps = _jax_steps(hr, **kwargs)
    tr = tds.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], device='cpu',
        learning_rate=(1e-3, 1e-4), steps_per_epoch=4, epochs=3,
        **FLAGSHIP, **kwargs)
    tr.setup_model()
    tds.load_jax_params(tr.net, steps['params0'])
    tr.setup_optimizer()
    tr.net.train()
    k = kwargs.get('gradient_accumulation_steps', 1)
    for i, batch in enumerate(steps['batches']):
        loss = tr.train_step({key: None if v is None else torch.from_numpy(v)
                              for key, v in batch.items()}).item()
        np.testing.assert_allclose(loss, steps['losses'][i], rtol=1e-5)
        _check(tr, tr.train_net, steps['params'][i], f'step {i} params')
        _check(tr, tr.ema_net, steps['ema'][i], f'step {i} EMA')
        assert tr.n_updates == (i + 1) // k
        assert tr.mini_step == (i + 1) % k
    if k == 2:
        # mid-cycle: no update, no EMA step
        start = tds.load_jax_params(tr.model.init(0, device='cpu'),
                                    steps['params0'])
        for tree in (steps['params'][0], steps['ema'][0]):
            back = tds.load_jax_params(tr.model.init(0, device='cpu'), tree)
            assert all(torch.equal(a, b) for a, b in zip(
                start.parameters(), back.parameters()))
        assert tr._mini.item() == 1 and tr._count.item() == 1
