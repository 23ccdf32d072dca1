"""The port's `predict_mc` (Monte-Carlo dropout ensembles) and `predict` of
an 'mc*' model on the CPU, against the JAX package where the semantics
are shared: the option whitelist and its TypeError, the (mean, std) and
member-stack shapes, identical members and std 0 for a model without an
'mc*' variant (the mean then `predict`'s output), one seed giving the
same bits twice and another seed others, `time_window`'s collapse and the
scaler's inverse on every member, a member equal to the JAX model run on
that member's draws (recorded from the port, fed to `jax.random`), the
fixed member of `predict`, and the members fed to
`compute_prob_metrics` as the JAX package's take them.

Tolerances: a member against JAX atol/rtol 1e-5, as tests/test_torch_pin.py
holds `predict`; the ensemble statistics exactly (numpy on the same
members). Small sizes: n_filters 4, n_blocks 1, 8x8 LR grids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import inference as tinference
from dl4ds_tpu_torch.models import blocks as tblocks

from _torch_state import load
from _torch_xla import quick_xla  # noqa: F401

LR, SCALE, N = 8, 2, 5
SPATIAL = dict(scale=SCALE, n_channels=3, n_aux_channels=1,
               lr_size=(LR, LR), n_filters=4, n_blocks=1, attention=True)
# two output channels: a layer norm over one channel is 0
REC = dict(scale=SCALE, n_channels=1, n_aux_channels=0, lr_size=(LR, LR),
           time_window=3, n_filters=4, n_blocks=1, normalization='ln',
           dropout_rate=0.3, dropout_variant='mcspatialdrop',
           n_channels_out=2)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(50)
    hr = rng.standard_normal((N, LR * SCALE, LR * SCALE)).astype(np.float32)
    topo = rng.standard_normal((LR * SCALE, LR * SCALE)).astype(np.float32)
    pred = rng.standard_normal((N, LR * SCALE, LR * SCALE, 1)).astype(
        np.float32)
    return hr, topo, pred


def _pair(variant, seed=0, **extra):
    kw = dict(SPATIAL, dropout_rate=0.3 if variant else 0.0,
              dropout_variant=variant, normalization='bn', **extra)
    jm = dds.net_postupsampling('resnet', 'spc', **kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = tds.net_postupsampling('resnet', 'spc', **kw)
    return (jm, v), (tm, load(tm.init(seed, device='cpu'), v))


@pytest.fixture(scope='module')
def mc():
    return _pair('mcdrop')


def _kw(data):
    hr, topo, pred = data
    return dict(array_in_hr=True, static_vars=[topo], predictors=[pred],
                batch_size=2, device='cpu')


@pytest.mark.parametrize('option', ['save_path', 'mesh', 'tile',
                                    'quantize'])
def test_option_whitelist_raises_as_jax(data, mc, option):
    """`predict`'s options outside the whitelist raise the JAX package's
    TypeError; `return_lr` is dropped."""
    hr = data[0]
    with pytest.raises(TypeError) as want:
        dds.predict_mc(mc[0], hr, SCALE, n_members=1, **{option: 'x'})
    with pytest.raises(TypeError) as got:
        tds.predict_mc(mc[1], hr, SCALE, n_members=1, device='cpu',
                       **{option: 'x'})
    assert str(got.value) == str(want.value)
    mean, std = tds.predict_mc(mc[1], hr, SCALE, n_members=1,
                               return_lr=True, **_kw(data))
    assert mean.shape == std.shape == (N, LR * SCALE, LR * SCALE, 1)


def test_members_shapes_seed_and_spread(data, mc):
    """(mean, std) of [N, H, W, C] and the [M, N, H, W, C] stack with
    `return_members`, the statistics numpy's over the stack; the members
    differ and std > 0; one seed gives the same bits twice, another seed
    other members; the ragged tail (5 grids at batch 2) draws too."""
    hr = data[0]
    mean, std, stack = tds.predict_mc(mc[1], hr, SCALE, n_members=4,
                                      seed=3, return_members=True,
                                      **_kw(data))
    assert stack.shape == (4, N, LR * SCALE, LR * SCALE, 1)
    np.testing.assert_array_equal(mean, stack.mean(axis=0))
    np.testing.assert_array_equal(std, stack.std(axis=0))
    assert all(not np.array_equal(stack[0], stack[k]) for k in (1, 2, 3))
    assert (std > 0).mean() > 0.5
    again = tds.predict_mc(mc[1], hr, SCALE, n_members=4, seed=3,
                           return_members=True, **_kw(data))[2]
    np.testing.assert_array_equal(again, stack)
    other = tds.predict_mc(mc[1], hr, SCALE, n_members=4, seed=4,
                           return_members=True, **_kw(data))[2]
    assert not np.array_equal(other, stack)


@pytest.mark.parametrize('variant', [None, 'spatial'])
def test_models_without_an_mc_variant_give_one_member(data, variant):
    """Without an 'mc*' variant eval mode draws nothing: the members are
    `predict`'s output, and std is 0 but for numpy's rounding of their
    mean."""
    _, (tm, net) = _pair(variant)
    hr = data[0]
    mean, std, stack = tds.predict_mc((tm, net), hr, SCALE, n_members=3,
                                      return_members=True, **_kw(data))
    want = tds.predict((tm, net), hr, SCALE, **_kw(data))
    for member in stack:
        np.testing.assert_array_equal(member, want)
    np.testing.assert_allclose(mean, want, atol=0, rtol=1e-6)
    assert np.all(std <= 1e-6 * np.abs(want))


def test_a_member_is_the_jax_model_on_its_draws(data, mc):
    """Member 0 of the port is the JAX model applied in eval mode to the
    same inputs with the port's draws of that member fed to
    `jax.random.bernoulli` in call order (the port's masks are its own
    bits, torch's Philox; the arithmetic around them is the JAX
    package's)."""
    (jm, v), (tm, net) = mc
    hr = data[0]
    kw = dict(_kw(data), batch_size=N)
    draws = []
    real = tblocks._dropout_mask

    def record(*args, **kwargs):
        draws.append(real(*args, **kwargs))
        return draws[-1]
    tblocks._dropout_mask = record
    try:
        member = tds.predict_mc((tm, net), hr, SCALE, n_members=1,
                                return_members=True, **kw)[2][0]
    finally:
        tblocks._dropout_mask = real
    assert draws and all(d.dtype == torch.bool for d in draws)
    x, aux, _ = tinference._assemble_inputs(
        tm, hr, SCALE, True, kw['static_vars'], kw['predictors'], None,
        'inter_area', torch.device('cpu'))
    queue = [jnp.asarray(d.numpy()) for d in draws]
    jax_bernoulli = jax.random.bernoulli
    jax.random.bernoulli = lambda key, p, shape: queue.pop(0)
    try:
        want = np.asarray(jm.apply(v, jnp.asarray(x.numpy()),
                                   jnp.asarray(aux.numpy()),
                                   rngs={'dropout': jax.random.PRNGKey(0)}))
    finally:
        jax.random.bernoulli = jax_bernoulli
    assert not queue
    np.testing.assert_allclose(member, want, atol=1e-5, rtol=1e-5)


def test_predict_of_an_mc_model_is_one_fixed_member(data, mc):
    """`predict` of an 'mc*' model gives the same bits call after call,
    whatever generators a trainer left on the network, and none of
    `predict_mc`'s members."""
    _, (tm, net) = mc
    hr = data[0]
    a = tds.predict((tm, net), hr, SCALE, **_kw(data))
    tblocks.set_dropout_generator(net, torch.Generator().manual_seed(9))
    b = tds.predict((tm, net), hr, SCALE, **_kw(data))
    tblocks.set_dropout_generator(net, None)
    np.testing.assert_array_equal(a, b)
    stack = tds.predict_mc((tm, net), hr, SCALE, n_members=2,
                           return_members=True, **_kw(data))[2]
    assert not np.array_equal(a, stack[0])


class _Affine:
    def inverse_transform(self, a):
        return 2.0 * a + 1.0


def test_time_window_and_scaler(data):
    """A recurrent 'mcspatialdrop' model with ln: every member collapsed
    from its windows back to N grids and inverse-scaled before the
    statistics, as `predict` finalizes one; with the dropout off the mean
    is `predict`'s output."""
    hr = data[0][..., None]
    args = dict(scale=SCALE, array_in_hr=True, time_window=3, batch_size=2,
                scaler=_Affine(), device='cpu')
    tm = tds.recnet_postupsampling('resnet', 'spc', **REC)
    net = tm.init(0, device='cpu')
    mean, std, stack = tds.predict_mc((tm, net), hr, n_members=3,
                                      return_members=True, **args)
    assert stack.shape == (3, N, LR * SCALE, LR * SCALE, 2)
    assert (std > 0).any()
    off = tds.recnet_postupsampling('resnet', 'spc',
                                    **dict(REC, dropout_rate=0.0))
    net_off = off.init(0, device='cpu')
    stack = tds.predict_mc((off, net_off), hr, n_members=2,
                           return_members=True, **args)[2]
    want = tds.predict((off, net_off), hr, **args)
    assert want.shape == (N, LR * SCALE, LR * SCALE, 2)
    for member in stack:
        np.testing.assert_array_equal(member, want)


def test_members_feed_compute_prob_metrics(data, mc):
    """The member stack is `compute_prob_metrics`' input, in the port and in
    the JAX package alike: the same CRPS map, spread-skill ratio and rank
    counts on the same members."""
    hr = data[0]
    _, _, stack = tds.predict_mc(mc[1], hr, SCALE, n_members=5,
                                 return_members=True, **_kw(data))
    y = hr[..., None]
    got = tds.compute_prob_metrics(y, stack, save_path=None, seed=1)
    want = dds.compute_prob_metrics(y, stack, save_path=None, seed=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
