"""The port's bfloat16 model dtype against the JAX package on the CPU, the
models and the trainer: the same seeded numpy inputs and the same weights
(`load_jax_params`) through both, small sizes.

- Both models' forward (the flagship with statics and a predictor, the
  recurrent one with and without them): every module's output dtype
  equals the JAX model's (`capture_intermediates`), and the port's output
  is closer to JAX's bfloat16 one than JAX's own float32 one is:
  max |port_bf16 - jax_bf16| <= 0.5 max |jax_f32 - jax_bf16| (both over
  max |jax_bf16|; the two stay within bfloat16 rounding flips of each other,
  the float32 model is about 1% away).
- Three Adam steps of the bfloat16 flagship trainer against the JAX trainer
  with dtype bfloat16, losses and parameters, at the same 0.5 ratio
  against the JAX float32 trainer.
- A bfloat16 save and load round trip, the JAX `load_model` reading a
  port-saved bfloat16 model; `predict`'s float32 return; float64 copies of
  float32 models (the chip checks' CPU reference) still running.
- How far the bfloat16 flagship moves with its sums' order alone, against
  the recurrent model (why `chip_smoke.py` compares serving by the mean).
`pytest -s` prints the distances. The kernels' bfloat16 forms are
`tests/test_torch_bf16.py`'s.
"""

import json
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

BF = torch.bfloat16
RATIO = 0.5          # port-to-JAX distance over JAX's own float32 distance

LR = 16
FLAGSHIP = dict(n_channels=2, n_aux_channels=2, lr_size=(LR, LR),
                n_filters=8, n_blocks=3, attention=True)
REC = dict(scale=4, n_channels=3, lr_size=(8, 8), time_window=4, n_filters=8,
           n_blocks=1)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _params_np(variables):
    return jax.tree_util.tree_map(np.asarray, variables['params'])


def _rel(a, b, ref):
    a, b, ref = (np.asarray(u, np.float64) for u in (a, b, ref))
    return float(np.abs(a - b).max() / np.abs(ref).max())


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _jax_pair(factory, args, seed):
    j32 = factory(*args[0], **args[1])
    j16 = factory(*args[0], dtype=jnp.bfloat16, **args[1])
    return j32, j16, j32.init(jax.random.PRNGKey(seed))


def _models(kind):
    """(JAX f32 model, JAX bf16 model, variables, port bf16 net, x, aux)."""
    rng = np.random.default_rng(3)
    if kind == 'flagship':
        j32, j16, v = _jax_pair(dds.net_postupsampling,
                                (('resnet', 'spc'), dict(scale=4, **FLAGSHIP)), 0)
        tm = tds.net_postupsampling('resnet', 'spc', scale=4, dtype=BF,
                                    **FLAGSHIP)
        x = rng.standard_normal((2, LR, LR, 2)).astype(np.float32)
        aux = rng.standard_normal((2, 4 * LR, 4 * LR, 2)).astype(np.float32)
    else:
        n_aux = 2 if kind == 'recurrent_aux' else 0
        j32, j16, v = _jax_pair(dds.recnet_postupsampling,
                                (('resnet', 'spc'),
                                 dict(n_aux_channels=n_aux, **REC)), 1)
        tm = tds.recnet_postupsampling('resnet', 'spc', n_aux_channels=n_aux,
                                       dtype=BF, **REC)
        x = rng.standard_normal((2, 4, 8, 8, 3)).astype(np.float32)
        aux = (rng.standard_normal((2, 32, 32, n_aux)).astype(np.float32)
               if n_aux else None)
    net = tds.load_jax_params(tm.init(0, device='cpu'), _params_np(v))
    return j32, j16, v, net, x, aux


def _jax_intermediates(model, v, x, aux):
    """{module path: output dtype name} of every Flax module's __call__."""
    _, state = model.module.apply(
        v, jnp.asarray(x), None if aux is None else jnp.asarray(aux),
        capture_intermediates=True, mutable=['intermediates'])
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if key == '__call__':      # a tuple's first array (the carry)
                y = jax.tree_util.tree_leaves(val[0])[0]
                out['.'.join(path)] = jnp.dtype(y.dtype).name
            elif isinstance(val, dict):
                walk(val, path + [key])
    walk(state['intermediates'], [])
    return out


@pytest.mark.parametrize('kind', ['flagship', 'recurrent_aux', 'recurrent'])
def test_forward_dtypes_and_distance_match_jax(kind, capsys):
    """The output dtype of every module the two models share equals the JAX
    model's (bfloat16 convolutions, a float32 gate and residual stream, a
    bfloat16 output), and the port's bfloat16 output is at most RATIO of
    JAX's float32-to-bfloat16 distance from JAX's bfloat16 output."""
    j32, j16, v, net, x, aux = _models(kind)
    ja = None if aux is None else jnp.asarray(aux)
    want = np.asarray(j16.apply(v, jnp.asarray(x), ja).astype(jnp.float32))
    y32 = np.asarray(j32.apply(v, jnp.asarray(x), ja))
    got_dtypes = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=name: got_dtypes.__setitem__(
            n, str(o.dtype).replace('torch.', '')))
        for name, m in net.named_modules()]
    with torch.no_grad():
        y = net(torch.from_numpy(x), None if aux is None else
                torch.from_numpy(aux))
    for h in hooks:
        h.remove()
    assert y.dtype == BF and tuple(y.shape) == want.shape
    want_dtypes = _jax_intermediates(j16, v, x, aux)
    shared = sorted(set(want_dtypes) & set(got_dtypes))
    assert len(shared) >= 10
    assert {k: got_dtypes[k] for k in shared} == \
        {k: want_dtypes[k] for k in shared}
    assert 'float32' in {want_dtypes[k] for k in shared}   # the gates
    port, own = _rel(y.float().numpy(), want, want), _rel(y32, want, want)
    with capsys.disabled():
        print(f'\n{kind} forward: max|port_bf16 - jax_bf16| {port:.3e}, '
              f'max|jax_f32 - jax_bf16| {own:.3e} (of max|jax_bf16|), '
              f'ratio {port / own:.3f}')
    assert own > 3e-3                  # bfloat16 is about 1% from float32
    assert port <= RATIO * own, (port, own)


# ---------------------------------------------------------------------------
# Training, saving, serving
# ---------------------------------------------------------------------------

HR_Y, HR_X, SCALE, PATCH, N = 32, 40, 4, 16, 10
TRAIN = dict(backbone='resnet', upsampling='spc', scale=SCALE,
             patch_size=PATCH, batch_size=2, time_window=None, n_blocks=2,
             n_filters=4, attention=True, loss='dssim_mae', verbose=False)


@pytest.fixture(scope='module')
def hr():
    return np.random.default_rng(21).standard_normal(
        (N, HR_Y, HR_X, 1)).astype(np.float32)


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jax_steps(hr, dtype, params0=None):
    """Three `_train_step_batch` Adam steps of the JAX trainer; the losses,
    the final parameters, and the batches and initial parameters used."""
    tr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        learning_rate=(1e-3, 1e-4), devices=jax.devices()[:1], dtype=dtype,
        **TRAIN)
    tr.setup_datagen()
    tr.setup_model()
    params = tr.variables['params'] if params0 is None else params0
    params0 = _copy_tree(params)
    state = jax_supervised.TrainState.create(
        apply_fn=tr.model.module.apply, params=params,
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
    return dict(params0=params0, params3=_copy_tree(state.params),
                batches=batches, losses=losses)


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(tree)])


def test_bf16_flagship_adam_steps_match_the_jax_trainer(hr, capsys):
    """Three Adam steps of the bfloat16 flagship (attention, dssim_mae) from
    the JAX trainer's initial weights on its batches: the port's losses and
    parameters are at most RATIO of the JAX float32 trainer's distance from
    the JAX bfloat16 trainer."""
    j16 = _jax_steps(hr, jnp.bfloat16)
    j32 = _jax_steps(hr, jnp.float32, j16['params0'])
    tr = tds.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], device='cpu',
        learning_rate=(1e-3, 1e-4), dtype=BF, **TRAIN)
    tr.setup_model()
    assert tr.model.dtype == BF
    tds.load_jax_params(tr.net, j16['params0'])
    tr.setup_optimizer()
    tr.net.train()
    losses = [tr.train_step({k: None if v is None else torch.from_numpy(v)
                             for k, v in b.items()}).item()
              for b in j16['batches']]
    assert all(p.dtype == torch.float32 for p in tr.net.parameters())
    want, own = np.array(j16['losses']), np.array(j32['losses'])
    port_d = np.abs(np.array(losses) - want).max()
    own_d = np.abs(own - want).max()
    assert own_d > 0 and port_d <= RATIO * own_d, (port_d, own_d)
    got = tds.weights.export_jax_params(tr.net)
    p16, p32, pt = (_flat(t) for t in (j16['params3'], j32['params3'], got))
    scale = np.abs(p16).max()
    port_p, own_p = (np.abs(pt - p16).max() / scale,
                     np.abs(p32 - p16).max() / scale)
    with capsys.disabled():
        print(f'\nflagship Adam steps: losses max|port - jax_bf16| '
              f'{port_d:.3e}, max|jax_f32 - jax_bf16| {own_d:.3e}, ratio '
              f'{port_d / own_d:.3f}; parameters {port_p:.3e} and '
              f'{own_p:.3e} of max|p|, ratio {port_p / own_p:.3f}')
    assert own_p > 0 and port_p <= RATIO * own_p, (port_p, own_p)


def test_bf16_save_load_round_trip_and_the_jax_load_model(tmp_path):
    """save_model writes dtype 'bfloat16'; load_model rebuilds a bfloat16
    model with the same float32 parameters and outputs; the JAX load_model
    reads the port-saved model as a bfloat16 Flax model whose output is
    within RATIO of its float32 distance from the port's."""
    model = tds.net_postupsampling('resnet', 'spc', scale=4, dtype=BF,
                                   **FLAGSHIP)
    net = model.init(5, device='cpu')
    tds.save_model(model, net, str(tmp_path))
    with open(os.path.join(tmp_path, 'model_config.json')) as fh:
        assert json.load(fh)['config']['dtype'] == 'bfloat16'
    model2, net2 = tds.load_model(str(tmp_path), device='cpu')
    assert model2.dtype == BF
    for (n1, p1), (n2, p2) in zip(net.named_parameters(),
                                  net2.named_parameters()):
        assert n1 == n2 and p2.dtype == torch.float32 and torch.equal(p1, p2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, LR, LR, 2)).astype(np.float32)
    aux = rng.standard_normal((2, 4 * LR, 4 * LR, 2)).astype(np.float32)
    with torch.no_grad():
        y1 = net(torch.from_numpy(x), torch.from_numpy(aux))
        y2 = net2(torch.from_numpy(x), torch.from_numpy(aux))
    assert torch.equal(y1, y2)
    jm, jv = jax_load_model(str(tmp_path))
    assert jnp.dtype(jm.module.dtype) == jnp.bfloat16
    yj = np.asarray(jm.apply(jv, jnp.asarray(x), jnp.asarray(aux))
                    .astype(jnp.float32))
    j32 = dds.net_postupsampling('resnet', 'spc', scale=4, **FLAGSHIP)
    y32 = np.asarray(j32.apply(jv, jnp.asarray(x), jnp.asarray(aux)))
    assert _rel(y1.float().numpy(), yj, yj) <= RATIO * _rel(y32, yj, yj)


def test_predict_of_a_bf16_model_returns_float32(hr):
    """predict returns float32 holding the bfloat16 model's values exactly,
    equal to the network's own bfloat16 output."""
    model = tds.net_postupsampling('resnet', 'spc', scale=4, n_channels=1,
                                   n_aux_channels=0, lr_size=(8, 10),
                                   n_filters=4, n_blocks=1, attention=True,
                                   dtype=BF)
    net = model.init(0, device='cpu')
    y, lr = tds.predict((model, net), hr[:3], scale=4, batch_size=2,
                        device='cpu', return_lr=True)
    assert y.dtype == np.float32 and y.shape == (3, HR_Y, HR_X, 1)
    np.testing.assert_array_equal(y, _bf16_np(y))
    with torch.no_grad():
        want = net(torch.from_numpy(lr)).float().numpy()
    np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize('kind', ['flagship', 'recurrent_aux'])
def test_float64_copies_still_run(kind):
    """A float32 model moved to float64 (the reference the chip checks and
    tools/torch_train_parity.py run on the CPU) keeps float64 through every
    block: the dtype threading casts only in a bfloat16 model."""
    if kind == 'flagship':
        tm = tds.net_postupsampling('resnet', 'spc', scale=4, **FLAGSHIP)
        x, aux = torch.randn(1, LR, LR, 2), torch.randn(1, 4 * LR, 4 * LR, 2)
    else:
        tm = tds.recnet_postupsampling('resnet', 'spc', n_aux_channels=2,
                                       **REC)
        x, aux = torch.randn(1, 4, 8, 8, 3), torch.randn(1, 32, 32, 2)
    net = tm.init(0, device='cpu').double()
    with torch.no_grad():
        y = net(x.double(), aux.double())
    assert y.dtype == torch.float64 and bool(torch.isfinite(y).all())



def _bf16_distances(make, hr, kwargs):
    """A bfloat16 model's `predict` on the CPU against (a) the same with
    every bfloat16 convolution (the ConvLSTM's too) summed in float64
    before its one rounding, the sums in another order and nothing else
    changed (`tools/torch_bf16_gap.py`'s CPU variant), and (b) the float32
    model with the same weights: each as (mean |d| / mean |y|, max |d| /
    max |y|)."""
    from tools.torch_bf16_gap import _float64_sums
    model, model32 = make(BF), make(torch.float32)
    y = tds.predict((model, model.init(seed=0, device='cpu')), hr,
                    device='cpu', **kwargs).astype(np.float64)
    y32 = tds.predict((model32, model32.init(seed=0, device='cpu')), hr,
                      device='cpu', **kwargs)
    with _float64_sums(torch):
        y64 = tds.predict((model, model.init(seed=0, device='cpu')), hr,
                          device='cpu', **kwargs)

    def dist(a):
        d = np.abs(a - y)
        return d.mean() / np.abs(y).mean(), d.max() / np.abs(y).max()
    return dist(y64), dist(y32)


def test_bf16_flagship_output_moves_with_the_sum_order_alone(capsys):
    """The bfloat16 flagship (the serving configuration's blocks, widths,
    statics and predictor, at 32x32 LR) moves with the order of its
    convolutions' sums alone by a mean of over 1e-4 of mean |y|, ten times
    the recurrent model's move, while staying under half the float32
    model's mean distance: its rounding flips cascade through the float32
    residual stream and the gates. So a card, whose sums run in other
    orders, meets the CPU's bfloat16 flagship in the mean, not in the max,
    and chip_smoke.py phase 12 holds bfloat16 predict against the CPU by
    mean |d| (tools/torch_bf16_gap.py splits the card's gap by cause at
    full width). Prints the distances."""
    rng = np.random.default_rng(5)
    topo = rng.standard_normal((128, 128)).astype(np.float32)
    mask = (rng.random((128, 128)) > 0.5).astype(np.float32)
    kwargs = dict(scale=4, static_vars=[topo, mask], batch_size=1)
    flag, flag32 = _bf16_distances(
        lambda dt: tds.net_postupsampling(
            'resnet', 'spc', scale=4, n_channels=4, n_aux_channels=2,
            lr_size=(32, 32), n_filters=8, n_blocks=6, attention=True,
            dtype=dt),
        rng.standard_normal((1, 128, 128)).astype(np.float32),
        dict(kwargs, array_in_hr=True, predictors=[
            rng.standard_normal((1, 128, 128, 1)).astype(np.float32)]))
    rec, rec32 = _bf16_distances(
        lambda dt: tds.recnet_postupsampling(
            'resnet', 'spc', scale=4, n_channels=2, n_aux_channels=2,
            lr_size=(32, 32), time_window=4, n_filters=8, n_blocks=2,
            dtype=dt),
        rng.standard_normal((4, 128, 128)).astype(np.float32),
        dict(kwargs, time_window=4, predictors=[
            rng.standard_normal((4, 128, 128, 1)).astype(np.float32)]))
    with capsys.disabled():
        print(f'\nsum order alone, mean and max over the bfloat16 output: '
              f'flagship {flag[0]:.2e}, {flag[1]:.2e} (float32 model '
              f'{flag32[0]:.2e}, {flag32[1]:.2e}); recurrent {rec[0]:.2e}, '
              f'{rec[1]:.2e} (float32 model {rec32[0]:.2e}, '
              f'{rec32[1]:.2e})')
    assert flag[0] > 1e-4 and flag[0] > 10 * rec[0]
    assert flag[0] < 0.5 * flag32[0] and rec[0] < 0.5 * rec32[0]
