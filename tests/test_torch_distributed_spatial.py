"""The port's spatial parallelism over processes (`distributed.spatial_mesh`,
`SupervisedTrainer(mesh=)` with a 'space' dim, K1's band mode,
`parallel.make_spatial_sharded_step`, `predict(spatial_mesh=)`) against
the JAX package on the CPU.

The test process computes the JAX references and writes them to an .npz
file, then spawns the torch-only ranks of `tests/_torch_dp_spatial_worker.py`
over a gloo group, twice for the module: 2 ranks for the ('space',) and
(data 1, space 2) meshes, 4 ranks for (data 2, space 2). The tests read
what the ranks wrote:

- (a) every band rule in float64 against the whole grid, forward and
  gradients (each parameter's gradient the sum of its band ranks' parts),
  and K1's band mode through its all-reduces against JAX's
  `channel_attention_reference` and `jax.vjp`, f32 and mixed;
- (b) `predict(spatial_mesh=)` on 2 ranks against the JAX `predict` on a
  2-device ('space',) mesh, with and without attention (atol 1e-5,
  tests/test_parallel.py:121-135);
- (c) `make_spatial_sharded_step.loss_and_grads` on a 2 x 2 mesh against
  JAX's on `_mesh_2d(2, 2)` (loss rtol 1e-6, gradients rtol 1e-4, atol
  1e-6, tests/test_parallel.py:143-175), and a few steps lowering the loss;
- (d) three `train_step`s of `SupervisedTrainer` on (data 1, space 2)
  against the JAX trainer's `_train_step_batch` on `Mesh(('data', 1),
  ('space', 2))`, and of the flagship on (data 2, space 2) against `Mesh(
  ('data', 2), ('space', 2))`: losses rtol 2e-4 (tests/test_trainer_mesh.
  py:65-83), parameters and batch statistics atol 2e-6; the resnet_spc
  flagship with attention and dssim_mae, a bn model, recresnet_spc with
  time_window=2 and unet_pin (the replicate rule). `run()` on the
  ('space',) mesh, in-HBM and streamed from the host, against the port's
  own run without a mesh from the same seed (the JAX trainer's run()
  draws other batches): fithist, val_loss and test_loss rtol 2e-4, the
  ranks agreeing;
- (e) a dropout model's step under 'space' against the same step without
  it: the loss and the dropout generator's state equal bit for bit;
- (f) the band sizes that do not cut, the spatial predict's checks and
  `--mesh_shape data=1,space=2` (the refusals in one process are
  tests/test_torch_spatial.py's).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import dl4ds_tpu as dds
from dl4ds_tpu.ops.pallas_ops import (
    channel_attention_reference as jax_channel_attention)
from dl4ds_tpu.parallel import (make_spatial_sharded_step,
                                receptive_field_radius)
from dl4ds_tpu.training import supervised as jax_supervised

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as worker  # noqa: E402
import _torch_dp_spatial_worker as sp_worker  # noqa: E402
from _torch_xla import quick_xla  # noqa: F401,E402

WORKER_TIMEOUT = 300       # seconds for all ranks, all cases
PARAM_ATOL = 2e-6          # tests/test_torch_training.py
LOSS_RTOL = 2e-4           # tests/test_trainer_mesh.py:65-83
BF16_TOL, F32_TOL = 1e-2, 1e-5     # tests/test_torch_bf16.py's K1 tolerances
HR_Y, HR_X = 32, 40
BASE = dict(backbone='resnet', upsampling='spc', scale=4, patch_size=16,
            batch_size=2, n_blocks=1, n_filters=4, verbose=False)
# name: (a rank's configuration, the JAX mesh (D, S)); the JAX trainer's
# global batch is D times a rank's
CONFIGS = {
    'flagship': (dict(BASE, n_blocks=2, attention=True, loss='dssim_mae'),
                 (1, 2)),
    'bn': (dict(BASE, n_blocks=2, attention=True, normalization='bn',
                loss='mse'), (1, 2)),
    'recurrent': (dict(BASE, time_window=2, loss='mae'), (1, 2)),
    'unet_pin': (dict(BASE, backbone='unet', upsampling='pin', loss='mae'),
                 (1, 2)),
    'flagship2x2': (dict(BASE, n_blocks=2, attention=True,
                         loss='dssim_mae'), (2, 2)),
}
INDICES = {1: ([0, 5], [6, 2], [3, 3]),
           2: ([0, 5, 2, 7], [6, 2, 1, 4], [3, 3, 0, 6])}
SPC = dict(backbone_block='resnet', upsampling='spc', scale=2, n_channels=1,
           n_aux_channels=0, lr_size=(16, 16), n_filters=4, n_blocks=1)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _mesh(d, s):
    return Mesh(np.array(jax.devices()[:d * s]).reshape(d, s),
                ('data', 'space'))


def _jax_steps(hr, config, shape):
    """Three `_train_step_batch` steps of the JAX trainer on a ('data',
    'space') mesh of `shape`, its state replicated and each global batch
    placed as `run()` places it (the height sharded by its constraint)."""
    tr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        learning_rate=(1e-3, 1e-4), mesh=_mesh(*shape), **config)
    assert tr.sp_axis == 'space' and tr.n_data_shards == shape[0]
    tr.setup_datagen()
    tr.setup_model()
    out = {'params0': _np(tr.variables['params'])}
    if 'batch_stats' in tr.variables:
        out['stats0'] = _np(tr.variables['batch_stats'])
    state = jax_supervised.TrainState.create(
        apply_fn=tr.model.module.apply, params=tr.variables['params'],
        tx=tr._build_optimizer(),
        batch_stats=tr.variables.get('batch_stats'))
    state = jax.device_put(state, tr.replicated_sharding)
    tr._make_steps()
    losses = []
    for i, idx in enumerate(INDICES[shape[0]]):
        key = jax.random.PRNGKey(i)
        batch = tr.ds_train._make_batch(jnp.asarray(idx), key)
        out[f'batch{i}'] = {k: np.array(v) for k, v in batch.items()
                            if v is not None}
        batch = {k: (None if v is None
                     else jax.device_put(v, tr.batch_sharding))
                 for k, v in batch.items()}
        state, loss = tr._train_step_batch(state, batch, key)
        losses.append(float(loss))
    out['losses'] = np.array(losses)
    out['params3'] = _np(state.params)
    if state.batch_stats is not None:
        out['stats3'] = _np(state.batch_stats)
    return out


def _k1_refs():
    """The gate's inputs and JAX's y and VJP, f32 and mixed (bfloat16 x,
    run eagerly: under jit XLA keeps m @ w1 in float32)."""
    rng = np.random.default_rng(4)
    c, cr = 12, 3
    x = rng.standard_normal((3, 6, 5, c)).astype(np.float32)
    ws = [(0.5 * rng.standard_normal((c, cr))).astype(np.float32),
          (0.1 * rng.standard_normal(cr)).astype(np.float32),
          (0.5 * rng.standard_normal((cr, c))).astype(np.float32),
          (0.1 * rng.standard_normal(c)).astype(np.float32)]
    dy = rng.standard_normal(x.shape).astype(np.float32)
    out = {'x': x, 'dy': dy, **{f'w{i}': w for i, w in enumerate(ws)}}
    for mode, xj in (('f32', jnp.asarray(x)),
                     ('mixed', jnp.asarray(x).astype(jnp.bfloat16))):
        y, vjp = jax.vjp(jax_channel_attention, xj, *map(jnp.asarray, ws))
        grads = vjp(jnp.asarray(dy).astype(y.dtype))
        out[f'{mode}/y'] = np.asarray(y.astype(jnp.float32))
        for name, g in zip(('dx', 'dw0', 'dw1', 'dw2', 'dw3'), grads):
            out[f'{mode}/{name}'] = np.asarray(g.astype(jnp.float32))
    return out


def _predict_refs():
    """JAX `predict(spatial_mesh=)` on a 2-device ('space',) mesh, with and
    without attention."""
    halo = receptive_field_radius(1)
    x = np.random.default_rng(5).standard_normal(
        (1, 2 * 2 * halo, 24, 1)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:2]), ('space',))
    out = {'x': x, 'halo': halo}
    names = []
    for name, att in (('plain', False), ('attention', True)):
        kw = dict(SPC, attention=att, output_attention=att)
        model = dds.net_postupsampling(**kw)
        variables = model.init(jax.random.PRNGKey(1), batch_size=1)
        out[f'{name}/config'] = json.dumps(kw)
        out[f'{name}/params'] = _np(variables['params'])
        out[f'{name}/y'] = dds.predict((model, variables), x, scale=2,
                                       array_in_hr=False, spatial_mesh=mesh,
                                       halo=halo)
        names.append(name)
    out['names'] = json.dumps(names)
    return out


def _step_refs():
    """JAX `make_spatial_sharded_step.loss_and_grads` on `_mesh_2d(2, 2)`."""
    kw = dict(SPC, attention=False, output_attention=False)
    model = dds.net_postupsampling(**kw)
    variables = model.init(jax.random.PRNGKey(0), batch_size=1)
    halo = receptive_field_radius(1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 4 * halo, 16, 1)).astype(np.float32)
    y = rng.standard_normal((4, 8 * halo, 32, 1)).astype(np.float32)
    sss = make_spatial_sharded_step(model, _mesh(2, 2), halo=halo,
                                    loss='mae')
    loss, grads = sss.loss_and_grads(variables['params'], x, y,
                                     jax.random.PRNGKey(3))
    return {'config': json.dumps(kw), 'halo': halo, 'x': x, 'y': y,
            'params': _np(variables['params']), 'loss': float(loss),
            'grads': _np(grads)}


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    hr = np.random.default_rng(21).standard_normal(
        (10, HR_Y, HR_X, 1)).astype(np.float32)
    flat = {'hr': hr,
            'names': json.dumps([n for n, (_, s) in CONFIGS.items()
                                 if s == (1, 2)])}
    want = {}
    for name, (config, shape) in CONFIGS.items():
        want[name] = _jax_steps(hr, config, shape)
        flat[f'{name}/config'] = json.dumps(config)
        flat[f'{name}/n_batches'] = len(INDICES[shape[0]])
        for key, val in worker.flat(want[name]).items():
            flat[f'{name}/{key}'] = val
    want['k1'] = _k1_refs()
    want['predict'] = _predict_refs()
    want['step'] = _step_refs()
    for part in ('k1', 'predict', 'step'):
        for key, val in worker.flat(want[part]).items():
            flat[f'{part}/{key}'] = val
    paths = []
    for world in (2, 4):
        path = tmp_path_factory.mktemp(f'sp{world}') / 'refs.npz'
        np.savez(path, **flat)
        paths.append(path)
    return paths, want


@pytest.fixture(scope='module')
def ranks(refs):
    """The 2 ranks' results: [(status, results)] by rank."""
    return worker.spawn(sp_worker.__file__, refs[0][0], 2, WORKER_TIMEOUT)


@pytest.fixture(scope='module')
def ranks4(refs):
    """The 4 ranks' results."""
    return worker.spawn(sp_worker.__file__, refs[0][1], 4, WORKER_TIMEOUT)


_case = worker.case_results


def test_ranks_import_neither_jax_nor_the_jax_package(ranks, ranks4):
    for status, _ in ranks + ranks4:
        assert status['no_jax'] == []


@pytest.mark.parametrize('name', [n for n, _ in sp_worker.RULE_MODELS])
def test_every_band_rule_gives_the_whole_grid(ranks, name):
    """(a) float64: the joined bands' forward within 1e-12 of the whole
    grid's (relative to its max), and the sum of the band ranks' parameter
    gradients within 1e-10 of the whole grid's: no rule's gradient is a
    replicated one summed twice (that would double it)."""
    for res in _case(ranks, 'case_rules'):
        assert float(res[f'rules/{name}/fwd']) <= 1e-12
        assert float(res[f'rules/{name}/grad']) <= 1e-10


@pytest.mark.parametrize('mode', ['f32', 'mixed'])
def test_k1_band_mode_over_two_ranks_matches_jax(refs, ranks, mode):
    """(a) K1's band mode through its autograd function, the sums and dm
    all-reduced, against JAX's gate and VJP on the whole grid: f32 within
    1e-5; mixed with the bfloat16 tolerances of tests/test_torch_bf16.py
    (y, db1, db2 1e-5 of max |ref|; dx, dw1, dw2 1e-2)."""
    want = refs[1]['k1']
    for res in _case(ranks, 'case_k1_band'):
        for key in ('y', 'dx', 'dw0', 'dw1', 'dw2', 'dw3'):
            got, ref = res[f'k1/{mode}/{key}'], want[f'{mode}/{key}']
            if mode == 'f32':
                np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5,
                                           err_msg=key)
                continue
            tol = F32_TOL if key in ('y', 'dw1', 'dw3') else BF16_TOL
            rel = np.abs(got - ref).max() / np.abs(ref).max()
            assert rel <= tol, (key, rel)


@pytest.mark.parametrize('name', ['plain', 'attention'])
def test_predict_spatial_mesh_matches_jax(refs, ranks, name):
    """(b) every rank returns the whole output, within 1e-5 of JAX's."""
    want = refs[1]['predict'][f'{name}/y']
    for res in _case(ranks, 'case_predict'):
        assert res[f'predict/{name}'].shape == want.shape
        np.testing.assert_allclose(res[f'predict/{name}'], want, atol=1e-5)


def test_spatial_sharded_step_on_2x2_matches_jax(refs, ranks4):
    """(c) loss rtol 1e-6, gradients rtol 1e-4 / atol 1e-6 against JAX's
    step on `_mesh_2d(2, 2)`; the same on every rank; then four steps of
    the optimizer lower the loss."""
    want = refs[1]['step']
    grads = worker.flat(want['grads'])
    for res in _case(ranks4, 'case_step_2x2'):
        np.testing.assert_allclose(float(res['step/loss']), want['loss'],
                                   rtol=1e-6)
        for key, val in grads.items():
            np.testing.assert_allclose(res[f'step/grads/{key}'], val,
                                       rtol=1e-4, atol=1e-6, err_msg=key)
        losses = res['step/losses']
        assert losses[-1] < losses[0], losses


def _held_to_jax(res, want, name):
    np.testing.assert_allclose(res[0][f'{name}/losses'], want['losses'],
                               rtol=LOSS_RTOL)
    for kind in ('params3', 'stats3'):
        for key in (k for k in want if k.startswith(kind + '/')):
            got = res[0][f'{name}/{key}']
            for other in res[1:]:
                np.testing.assert_array_equal(got, other[f'{name}/{key}'],
                                              err_msg=key)
            np.testing.assert_allclose(got, want[key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize('name', [n for n, (_, s) in CONFIGS.items()
                                  if s == (1, 2)])
def test_three_steps_on_data1_space2_match_the_jax_trainer(refs, ranks,
                                                            name):
    """(d) losses, parameters and (bn) batch statistics after three steps
    against the JAX trainer's on the same (data 1, space 2) mesh; the
    ranks agree bit for bit."""
    _held_to_jax(_case(ranks, 'case_steps'), worker.flat(refs[1][name]),
                 name)


def test_three_steps_on_data2_space2_match_the_jax_trainer(refs, ranks4):
    """(d) the flagship on (data 2, space 2): each data row's shard of the
    global batches, its bands on two ranks."""
    _held_to_jax(_case(ranks4, 'case_steps_2x2'),
                 worker.flat(refs[1]['flagship2x2']), 'flagship2x2')


@pytest.mark.parametrize('name', list(sp_worker.RUNS))
def test_run_on_a_space_mesh_equals_the_run_without(ranks, name):
    """(d) run() on the ('space',) mesh against the port's run without a
    mesh from one seed: fithist (loss, val_loss) and test_loss rtol 2e-4,
    the final parameters and statistics atol 2e-6; every rank reports the
    same losses, and only rank 0 is the first worker."""
    res = _case(ranks, 'case_runs')
    for r in res:
        np.testing.assert_array_equal(r[f'run/{name}/space'],
                                      res[0][f'run/{name}/space'])
    np.testing.assert_allclose(res[0][f'run/{name}/space'],
                               res[0][f'run/{name}/plain'], rtol=LOSS_RTOL)
    assert [bool(r[f'run/{name}/first_worker']) for r in res] == [True,
                                                                  False]
    prefix = f'run/{name}/space/'
    for key in (k for k in res[0] if k.startswith(prefix)):
        plain = res[0][f'run/{name}/plain/' + key[len(prefix):]]
        np.testing.assert_allclose(res[0][key], plain, rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


def test_dropout_under_space_is_the_data_rows_draw(ranks):
    """(e) a row's bands draw the row's masks (the whole height from one
    generator, each keeping its rows): the step's loss and the generator's
    state after it equal those of the same step without 'space', bit for
    bit, on both ranks."""
    for res in _case(ranks, 'case_dropout'):
        assert float(res['dropout/space/loss']) == float(
            res['dropout/plain/loss'])
        np.testing.assert_array_equal(res['dropout/space/state'],
                                      res['dropout/plain/state'])


def test_band_sizes_and_the_app_mesh(ranks):
    """(f) LR rows 3 in 2 bands, H 9 in 2 bands and bands shorter than
    2*halo raise ValueError; `--mesh_shape data=1,space=2` builds the
    (data 1, space 2) mesh."""
    for res in _case(ranks, 'case_errors'):
        assert res['errors'].tolist() == ['rows do not cut', 'divisible',
                                          'band height']
        assert res['app_mesh'].tolist() == ["('data', 'space')", '(1, 2)']
