"""The port's data-parallel serving and ensembles over processes against the
JAX package on the CPU, on the pattern of tests/
test_torch_distributed.py: the test process computes the JAX references on
2-device meshes, then spawns two torch-only ranks
(`tests/_torch_dp_serving_worker.py`) over a gloo group, once for the
module; each rank asserts that neither JAX nor the JAX package is
imported, runs every case and writes its results, which the tests read.

- `predict(mesh=)` of the flagship and of the recurrent model at 3 and 10
  samples (tests/test_inference_metrics.py:190-199), with
  `pad_to_multiple`, and `Predictor(mesh=)`, against JAX's `predict` on a
  2-device `Mesh('data')`; every rank returns the whole array, the same
  bits, and only the first worker writes `save_path`;
- `predict_tiled(mesh=)` float32 and int8 (calibrated on the first global
  dispatch) and `predict(tile=, mesh=, quantize='int8')` against JAX's;
- the ensembles against `make_ensemble_step` (bootstrap off) and
  `predict_ensemble` on a 2-device ('ensemble',) mesh with mae and a (1, 2)
  ('ensemble', 'data') mesh with dssim_mae, whose loss takes each data
  shard's own range (JAX's `shard_map`): three steps, per member, at
  tests/test_torch_ensemble.py's tolerances; `init_ensemble(mesh=)` the
  rows of the stack without a mesh; bootstrapped steps on the
  ('ensemble',) mesh equal, member by member, to the step without one;
- a spatio-temporal model's ensemble (`recnet_postupsampling`, the
  ConvLSTM layers' member mode) on the 2-device ('ensemble',) mesh, the
  same checks.
"""

import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import dl4ds_tpu as dds
from dl4ds_tpu import parallel as jpar

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import parallel as tpar

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as harness  # noqa: E402
import _torch_dp_serving_worker as worker  # noqa: E402
from _torch_xla import quick_xla  # noqa: E402,F401

WORLD = 2
WORKER_TIMEOUT = 300       # seconds for both ranks, all cases
PREDICT_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6     # tests/test_torch_ensemble.py
OUT_SHARE = 0.05           # tests/test_torch_quantization.py


@pytest.fixture(autouse=True, scope='module')
def _threads():
    torch.set_num_threads(2)


def _rel(a, b):
    """tests/test_torch_quantization.py's distance."""
    a, b = np.asarray(a, 'float32'), np.asarray(b, 'float32')
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.std(b) + 1e-12))


def _jax_pair(name):
    """The JAX model of `name` with the port's weights (seed 0)."""
    _, net = worker.pair(name)
    return (worker.model(dds, name),
            {'params': tds.weights.export_jax_params(net)})


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    """The JAX outputs on 2-device meshes, by the worker's result names."""
    data_mesh = Mesh(np.array(jax.devices()[:WORLD]), ('data',))
    want = {}
    for name in worker.MODELS:
        pair = _jax_pair(name)
        for n in worker.COUNTS:
            want[f'predict/{name}/{n}'] = dds.predict(
                pair, worker.hr_grids(name, n), mesh=data_mesh,
                **worker.predict_kw(name))
    pair = _jax_pair('flagship')
    kw = worker.predict_kw('flagship')
    hr3 = worker.hr_grids('flagship', 3)
    want['predict/padded'] = dds.predict(pair, hr3, mesh=data_mesh,
                                         pad_to_multiple=3, **kw)
    want['predictor'] = want['predict/flagship/3']
    x = worker.tile_input()
    for mode in (None, 'int8'):
        want[f'tiled/{mode}'] = jpar.predict_tiled(
            *pair, x, tile=worker.TILE, halo=worker.HALO, batch_size=3,
            mesh=data_mesh, quantize=mode)
    want['tiled/predict'] = dds.predict(pair, hr3, mesh=data_mesh, tile=2,
                                        halo=worker.HALO, quantize='int8',
                                        **kw)
    want['tiled/predict_f32'] = dds.predict(pair, hr3, tile=2,
                                            halo=worker.HALO, **kw)

    want.update(ensemble_refs(worker.MESHES))
    want.update(ensemble_refs(
        worker.REC_MESHES, worker.rec_ens_model,
        lambda: dds.recnet_postupsampling(**worker.REC_ENS),
        worker.rec_ens_data))
    path = tmp_path_factory.mktemp('dp_serving') / 'refs.npz'
    np.savez(path, unused=np.zeros(1))
    return path, want


def ensemble_refs(meshes, port_model=worker.ens_model,
                  jax_model=lambda: dds.net_postupsampling(**worker.ENS),
                  data=worker.ens_data):
    """JAX's served member stacks, step losses and final weights on each of
    the worker's ensemble `meshes`, by the worker's result names, of the
    model `jax_model()` from the port's stack of `port_model()`, on
    `data()`."""
    tm, jm = port_model(), jax_model()
    start = {'params': tds.weights.export_jax_ensemble(
        tm, tpar.init_ensemble(tm, worker.M, seed=0, device='cpu'))}
    x, y = data()
    want = {}
    for name, ((n_e, n_d), loss) in meshes.items():
        shape, names = (((n_e,), ('ensemble',)) if n_d is None
                        else ((n_e, n_d), ('ensemble', 'data')))
        mesh = Mesh(np.array(jax.devices()[:n_e * (n_d or 1)])
                    .reshape(shape), names)
        want[f'{name}/serve'] = np.asarray(jpar.predict_ensemble(
            jm, start, x, mesh=mesh, return_members=True)[2])
        es = jpar.make_ensemble_step(jm, mesh, tx=optax.adam(1e-4),
                                     loss=loss, bootstrap=False)
        v, o, losses = start, es.init_opt(start), []
        for k in range(worker.ENS_STEPS):
            v, o, ls = es.step(v, o, x, y, jax.random.PRNGKey(k))
            losses.append(np.asarray(ls))
        want[f'{name}/losses'] = np.stack(losses)
        for k, val in harness.flat(jax.tree_util.tree_map(
                np.asarray, v['params'])).items():
            want[f'{name}/end/{k}'] = val
    return want


@pytest.fixture(scope='module')
def ranks(refs):
    return harness.spawn(worker.__file__, refs[0], WORLD, WORKER_TIMEOUT)


def test_ranks_import_neither_jax_nor_the_jax_package(ranks):
    for status, _ in ranks:
        assert status['no_jax'] == []


PREDICT_KEYS = ([f'predict/{name}/{n}' for name in worker.MODELS
                 for n in worker.COUNTS] + ['predict/padded', 'predictor'])


@pytest.mark.parametrize('key', PREDICT_KEYS)
def test_predict_over_the_mesh_matches_jax(refs, ranks, key):
    """Each rank returns the whole output, the same bits, within 1e-5 of
    JAX's `predict` over its 2-device mesh (3 and 10 samples: the last
    global batch padded)."""
    _, want = refs
    res = harness.case_results(ranks, 'case_predict')
    np.testing.assert_array_equal(res[0][key], res[1][key])
    assert res[0][key].shape == np.shape(want[key])
    np.testing.assert_allclose(res[0][key], want[key], **PREDICT_TOL)


def test_only_the_first_worker_writes_the_output(ranks):
    res = harness.case_results(ranks, 'case_predict')
    assert res[0]['saved'].tolist() == ['y_hat.npy']
    assert res[1]['saved'].tolist() == ['']


@pytest.mark.parametrize('mode', ['None', 'int8'])
def test_tiled_over_the_mesh_matches_jax(refs, ranks, mode):
    """The windows shared out over the ranks (2 grids of 10x12 at tile 4:
    12 windows, dispatches of 6, the ranks 3 each): float32 within 1e-5 of
    JAX's; int8, calibrated on the first global dispatch on every rank,
    within OUT_SHARE of JAX's int8 error; the ranks the same bits."""
    _, want = refs
    key = f'tiled/{mode}'
    res = harness.case_results(ranks, 'case_tiled')
    np.testing.assert_array_equal(res[0][key], res[1][key])
    if mode == 'None':
        np.testing.assert_allclose(res[0][key], want[key], **PREDICT_TOL)
        return
    ratio = _rel(res[0][key], want[key]) / _rel(want[key], want['tiled/None'])
    print(f'tiled int8 over the mesh: ratio {ratio:.3e}')
    assert ratio <= OUT_SHARE


def test_predict_tiled_int8_over_the_mesh_matches_jax(refs, ranks):
    _, want = refs
    res = harness.case_results(ranks, 'case_tiled')
    got = res[0]['tiled/predict']
    np.testing.assert_array_equal(got, res[1]['tiled/predict'])
    ratio = (_rel(got, want['tiled/predict'])
             / _rel(want['tiled/predict'], want['tiled/predict_f32']))
    print(f'predict(tile=, mesh=, int8): ratio {ratio:.3e}')
    assert ratio <= OUT_SHARE


@pytest.mark.parametrize('name', list(worker.MESHES))
def test_ensemble_over_the_mesh_matches_jax(refs, ranks, name):
    """Each rank's members: their start the rows of the stack without a
    mesh; three steps' losses of all M members (gathered) and the members'
    final weights against JAX's step on its 2-device mesh; the served
    member stack against JAX's `predict_ensemble`."""
    check_ensemble(harness.case_results(ranks, 'case_ensembles'), refs[1],
                   name, worker.MESHES[name][0][0])


def test_recurrent_ensemble_over_the_mesh_matches_jax(refs, ranks):
    """The spatio-temporal model's ensemble on the ('ensemble',) mesh, each
    rank's members through the ConvLSTM layers' member mode: the same
    checks against JAX's step and `predict_ensemble` on its 2-device
    mesh."""
    check_ensemble(harness.case_results(ranks, 'case_ensembles_recurrent'),
                   refs[1], 'ensemble_rec', worker.REC_MESHES[
                       'ensemble_rec'][0][0])


def check_ensemble(res, want, name, n_e):
    """The ranks' results `res` of the ensemble mesh `name` against JAX's
    `want`, with `n_e` ranks on the 'ensemble' dim."""
    for r in res:
        assert bool(r[f'{name}/init_equal'])
        assert int(r[f'{name}/axis_size']) == n_e
        np.testing.assert_array_equal(r[f'{name}/losses'],
                                      res[0][f'{name}/losses'])
        np.testing.assert_array_equal(r[f'{name}/serve'],
                                      res[0][f'{name}/serve'])
        np.testing.assert_allclose(r[f'{name}/losses'], want[f'{name}/losses'],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[f'{name}/serve'], want[f'{name}/serve'],
                                   **PREDICT_TOL)
        rows = r[f'{name}/members']
        keys = [k for k in want if k.startswith(f'{name}/end/')]
        assert keys
        for key in keys:
            np.testing.assert_allclose(r[key], want[key][rows],
                                       atol=PARAM_ATOL, err_msg=key)


def test_ensemble_data_dim_takes_each_shard_s_dssim_range(refs):
    """JAX's ('ensemble', 'data') step is `shard_map`: each member's loss
    is the mean over the shards of the shard's own loss, its DSSIM range
    the shard's. The port's losses match it (above), and differ from the
    whole batch's loss, whose range is the batch's."""
    _, want = refs
    tm = worker.ens_model()
    stack = tpar.init_ensemble(tm, worker.M, seed=0, device='cpu')
    es = tpar.make_ensemble_step(tm, loss='dssim_mae', bootstrap=False)
    x, y = worker.ens_data()
    whole = es.step(stack, es.init_opt(stack), x, y, 0)[2].numpy()
    shards = want['ensemble_data/losses'][0]
    apart = np.abs(whole - shards) / shards
    print(f'per-shard DSSIM ranges move the losses by {apart.max():.3g}')
    assert apart.min() > 1e-3


def test_bootstrap_over_the_ensemble_mesh_equals_no_mesh(ranks):
    """Every rank draws the global [M, B] indices and takes its members'
    rows: the members train as the step without a mesh trains them, bit
    for bit, and the gathered losses are its losses."""
    for r in harness.case_results(ranks, 'case_ensembles'):
        assert bool(r['boot/losses_equal'])
        assert bool(r['boot/members_equal'])
