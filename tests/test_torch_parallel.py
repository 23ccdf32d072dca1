"""PyTorch port's halo-tiled serving (`dl4ds_tpu_torch.parallel.predict_tiled`
and `predict(tile=, halo=)`) against the JAX package's on the CPU, with the
same weights carried across by `load_jax_params`: spc with channel
attention, 'pin', aux inputs, a grid that the tiles do not divide, and a
spatio-temporal model with time_window=3; attention-free models tiled
against untiled in the port; the receptive-field estimate, the raises and
the signatures of the module's functions. Small size: n_filters=4,
n_blocks=1, grids of 16-30 pixels, float32."""

import inspect

import jax
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu import parallel as jpar

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import parallel as tpar
from _torch_xla import quick_xla  # noqa: F401

TILE, HALO, BATCH = 8, 4, 6
TOL = dict(atol=1e-4, rtol=1e-4)      # f32 convs summed in other orders
SMALL = dict(n_filters=4, n_blocks=1)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _pair(jax_factory, port_factory, seed=3, **kw):
    """The JAX model with its variables, and the port's with the same
    weights."""
    jm = jax_factory(**kw)
    variables = jm.init(jax.random.PRNGKey(seed))
    tm = port_factory(**kw)
    net = tds.load_jax_params(tm.init(0, device='cpu'),
                              jax.tree_util.tree_map(np.asarray,
                                                     variables['params']))
    return (jm, variables), (tm, net)


def _spc(**kw):
    return dict(dict(backbone_block='resnet', upsampling='spc', scale=2,
                     n_channels=1, n_aux_channels=0, lr_size=(16, 16),
                     **SMALL), **kw)


_CASES = {
    # name: (factory kwargs, x shape, aux shape)
    'spc_attention': ('net_postupsampling', _spc(attention=True),
                      (2, 16, 24, 1), None),
    'nondivisible': ('net_postupsampling', _spc(attention=True),
                     (2, 19, 21, 1), None),
    'pin': ('net_pin', dict(backbone_block='resnet', n_channels=1,
                            n_aux_channels=0, hr_size=(24, 24),
                            attention=True, **SMALL), (2, 24, 30, 1), None),
    'aux': ('net_postupsampling', _spc(n_aux_channels=2), (2, 16, 16, 1),
            (2, 32, 32, 2)),
    'spatiotemporal': ('recnet_postupsampling', _spc(time_window=3),
                       (2, 3, 16, 16, 1), None),
}


@pytest.fixture(scope='module')
def pairs():
    out = {}
    for name, (factory, kw, _, _) in _CASES.items():
        key = (factory, tuple(sorted(kw.items())))
        if key not in out:
            out[key] = _pair(getattr(dds, factory), getattr(tds, factory),
                             **kw)
        out[name] = out[key]
    return out


@pytest.mark.parametrize('name', list(_CASES))
def test_predict_tiled_matches_jax(pairs, name):
    """The window geometry (clipped border windows, aux windows scaled by
    the aux grid's ratio, tile-major order) and the gate taken per window
    are the JAX package's: same output on the same weights."""
    _, _, xshape, auxshape = _CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(xshape).astype(np.float32)
    aux = (rng.standard_normal(auxshape).astype(np.float32)
           if auxshape is not None else None)
    (jm, variables), (tm, net) = pairs[name]
    want = jpar.predict_tiled(jm, variables, x, aux=aux, tile=TILE,
                              halo=HALO, batch_size=BATCH)
    got = tpar.predict_tiled(tm, net, x, aux=aux, tile=TILE, halo=HALO,
                             batch_size=BATCH)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('time_window', [None, 3])
def test_attention_free_tiled_equals_untiled(time_window):
    """Without a gate (attention=False, output_attention=False) and with the
    halo at the receptive-field radius, tiling changes nothing."""
    kw = _spc(output_attention=False)
    if time_window is None:
        tm, shape = tds.net_postupsampling(**kw), (2, 19, 21, 1)
    else:
        tm = tds.recnet_postupsampling(**kw, time_window=time_window)
        shape = (2, time_window, 19, 21, 1)
    net = tm.init(1, device='cpu')
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    halo = tpar.receptive_field_radius(1, time_window=time_window)
    got = tpar.predict_tiled(tm, net, x, tile=TILE, halo=halo, batch_size=4)
    with torch.inference_mode():
        want = net.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_float_dispatches_run_the_real_windows_alone():
    """Without a mesh and float, the last dispatch is short, as in JAX: a
    ragged window count (2 grids of 19x21 at tile 8: 18 windows, batch 4)
    runs 18 windows through the network, not 20 wrap-padded ones."""
    tm = tds.net_postupsampling(**_spc(attention=True))
    net = tm.init(0, device='cpu')
    rows = []
    hook = net.register_forward_pre_hook(
        lambda mod, args: rows.append(args[0].shape[0]))
    x = np.random.default_rng(5).standard_normal(
        (2, 19, 21, 1)).astype(np.float32)
    try:
        tpar.predict_tiled(tm, net, x, tile=TILE, halo=HALO, batch_size=4)
    finally:
        hook.remove()
    assert rows == [4, 4, 4, 4, 2]


@pytest.mark.parametrize('name', ['spc_attention', 'spatiotemporal'])
def test_predict_tile_routing_matches_jax(pairs, name):
    """`predict(tile=, halo=)` assembles the batch, tiles it and collapses
    the spatio-temporal windows as the JAX `predict(tile=)` does."""
    (jm, variables), (tm, net) = pairs[name]
    tw = 3 if name == 'spatiotemporal' else None
    hr = np.random.default_rng(5).standard_normal(
        (5, 38, 42)).astype(np.float32)
    kw = dict(scale=2, array_in_hr=True, time_window=tw, tile=TILE,
              halo=HALO, batch_size=BATCH)
    want = dds.predict((jm, variables), hr, **kw)
    got = tds.predict((tm, net), hr, device='cpu', **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    got_p = tds.Predictor((tm, net), hr, array_in_hr=True, device='cpu',
                          **{k: v for k, v in kw.items()
                             if k != 'array_in_hr'}).run()
    np.testing.assert_array_equal(got_p, got)


@pytest.mark.parametrize('args', [(0,), (1,), (4,), (6,), (2, 5, 3, 4),
                                  (1, 3, 2, 6, 3), (6, 3, 2, 6, 4)])
def test_receptive_field_radius_matches_jax(args):
    assert tpar.receptive_field_radius(*args) == \
        jpar.receptive_field_radius(*args)


def test_raises(pairs):
    """`mesh` is ported (tests/test_torch_distributed_serving.py): one
    that is not a DeviceMesh is a TypeError; `quantize` is ported
    (tests/test_torch_quantization.py), and a mode it does not know is the
    JAX package's ValueError; `pad_to_multiple` with `tile` is the JAX
    package's ValueError."""
    (jm, variables), (tm, net) = pairs['spc_attention']
    x = np.zeros((1, 16, 16, 1), np.float32)
    with pytest.raises(TypeError, match='DeviceMesh'):
        tpar.predict_tiled(tm, net, x, mesh=object())
    for pkg, pair in ((jpar, (jm, variables)), (tpar, (tm, net))):
        with pytest.raises(ValueError, match='mode'):
            pkg.predict_tiled(*pair, x, quantize='int4')
    hr = np.zeros((2, 32, 32), np.float32)
    for pkg, pair, kw in ((dds, (jm, variables), {}),
                          (tds, (tm, net), dict(device='cpu'))):
        with pytest.raises(ValueError, match='pad_to_multiple'):
            pkg.predict(pair, hr, scale=2, tile=8, pad_to_multiple=16, **kw)


def _parameters(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize('name', tpar.__all__)
def test_signatures_equal_the_jax_ones(name):
    """Each function of the port's `parallel` takes the JAX package's
    parameters in its order and with its defaults, but `net` in place of
    `variables`, `init_ensemble`'s `device` (default 'cuda') at the end,
    and `make_ensemble_step`'s `mesh` defaulting to None (one card);
    `SpatialShardedStep` adds `init_opt`, as `EnsembleStep` holds it;
    `TensorShardedStep` and `PipelineStep` hold JAX's fields. The port's
    own `place_params` and `gather_params` (`jax.device_put(params,
    shardings)` and its inverse) take (params, param_shardings, mesh,
    axis=None)."""
    if name in ('EnsembleStep', 'TensorShardedStep', 'PipelineStep'):
        assert getattr(tpar, name)._fields == getattr(jpar, name)._fields
        return
    if name in ('place_params', 'gather_params'):
        assert not hasattr(jpar, name)
        kind = inspect.Parameter.POSITIONAL_OR_KEYWORD
        empty = inspect.Parameter.empty
        assert _parameters(getattr(tpar, name)) == [
            ('params', kind, empty), ('param_shardings', kind, empty),
            ('mesh', kind, empty), ('axis', kind, None)]
        return
    if name == 'SpatialShardedStep':
        assert tpar.SpatialShardedStep._fields == (
            jpar.SpatialShardedStep._fields + ('init_opt',))
        return
    want = _parameters(getattr(jpar, name))
    want = [('net',) + p[1:] if p[0] == 'variables' else p for p in want]
    if name == 'make_ensemble_step':
        want = [p[:2] + (None,) if p[0] == 'mesh' else p for p in want]
    if name == 'init_ensemble':
        want.append(('device', inspect.Parameter.POSITIONAL_OR_KEYWORD,
                     'cuda'))
    assert _parameters(getattr(tpar, name)) == want
