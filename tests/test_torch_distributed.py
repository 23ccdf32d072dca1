"""The port's data parallelism over processes (`dl4ds_tpu_torch.distributed`,
`SupervisedTrainer(mesh=...)`) against the JAX package on the CPU.

The test process computes the JAX references and writes them to an .npz
file, then spawns two torch-only ranks (`tests/_torch_dp_worker.py`) over a
gloo group, once for the module; each rank asserts that neither JAX nor
the JAX package is imported, runs every case and writes its results,
which the tests read:

- (a) the API, the counterpart of tests/test_distributed.py:65-82:
  `process_count`, `process_index`, `is_multi_host`, a `global_mesh` of
  size 2, an all-reduce, the differentiable sum and extremes, the
  first-worker gating and the app's `--mesh_shape data=N`;
- (b) three Adam steps against the JAX trainer on `devices=jax.devices()
  [:2]` (`n_data_shards` 2, the rate scaled x2, `_train_step_batch` on
  three global batches sharded over its 'data' axis), each rank on its half
  of each batch: the flagship (attention, dssim_mae: the DSSIM range over
  the global batch), a bn model (the moments of the global batch) and the
  recurrent model. Losses rtol 1e-5, parameters and batch_stats atol 2e-6
  (tests/test_torch_training.py's), the ranks' parameters equal bit for
  bit;
- (c) `run()` with 2 ranks x batch 4 at half the rate against one process
  x batch 8, the port's counterpart of tests/test_distributed.py:85
  `test_dp_convergence_equivalence` (rtol 5e-3, atol 1e-5), with saving on
  rank 0 alone, a resume from its checkpoint, early stopping at one epoch
  on both ranks, the streaming tier and 'vanilla' dropout drawing
  different masks a rank;
- (d) the refusals, in the test process.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import app

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as worker  # noqa: E402

WORLD = 2
WORKER_TIMEOUT = 300       # seconds for both ranks, all cases
PARAM_ATOL = 2e-6          # tests/test_torch_training.py
HR_Y, HR_X = 32, 40
BASE = dict(backbone='resnet', upsampling='spc', scale=4, patch_size=16,
            batch_size=2, n_blocks=1, n_filters=4, verbose=False)
# name: a rank's configuration; the JAX trainer's global batch is twice it
CONFIGS = {
    'flagship': dict(BASE, n_blocks=2, attention=True, loss='dssim_mae'),
    'bn': dict(BASE, n_blocks=2, attention=True, normalization='bn',
               loss='mse'),
    'recurrent': dict(BASE, time_window=3, loss='mae'),
}
# the global batches' sample indices
INDICES = ([0, 5, 2, 7], [6, 2, 1, 4], [3, 3, 0, 6])


@pytest.fixture(autouse=True, scope='module')
def _threads_and_quick_xla():
    """Two torch threads; XLA's CPU compiles of the JAX references without
    most of its optimization passes (restored after the file)."""
    torch.set_num_threads(2)
    before = jax.config.values['jax_disable_most_optimizations']
    jax.config.update('jax_disable_most_optimizations', True)
    yield
    jax.config.update('jax_disable_most_optimizations', before)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _jax_dp_steps(hr, config):
    """Three `_train_step_batch` steps of the JAX trainer on a 2-device
    'data' mesh, its state replicated and each global batch sharded as
    `run()` places them."""
    tr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        learning_rate=(1e-3, 1e-4), devices=jax.devices()[:WORLD], **config)
    assert tr.n_data_shards == WORLD
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
    for i, idx in enumerate(INDICES):
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


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    hr = np.random.default_rng(21).standard_normal(
        (10, HR_Y, HR_X, 1)).astype(np.float32)
    flat = {'hr': hr, 'names': json.dumps(list(CONFIGS))}
    want = {}
    for name, config in CONFIGS.items():
        want[name] = _jax_dp_steps(hr, config)
        flat[f'{name}/config'] = json.dumps(config)
        flat[f'{name}/n_batches'] = len(INDICES)
        for key, val in worker.flat(want[name]).items():
            flat[f'{name}/{key}'] = val
    path = tmp_path_factory.mktemp('dp') / 'refs.npz'
    np.savez(path, **flat)
    return path, want


_free_port = worker.free_port


@pytest.fixture(scope='module')
def ranks(refs):
    """Both ranks' results: [(status, results)] by rank."""
    return worker.spawn(worker.__file__, refs[0], WORLD, WORKER_TIMEOUT)


_case = worker.case_results


def test_ranks_import_neither_jax_nor_the_jax_package(ranks):
    for status, _ in ranks:
        assert status['no_jax'] == []


def test_process_group_mesh_and_collectives(ranks):
    for r, res in enumerate(_case(ranks, 'case_api')):
        assert res['api_sum'].tolist() == [3.0]
        assert res['api_sum_grad'].tolist() == 3.0
        # max 1 on rank 1, min -1 on rank 1: the gradient is rank 1's
        assert res['api_extremes'].tolist() == [1.0, -1.0]
        want = [[0.0, 0.0], [2.0, 4.0]][r]
        assert res['api_extremes_grad'].tolist() == want
        assert res['api_gating'].tolist() == [r == 0, WORLD, 2 * WORLD, r]
        assert bool(res['api_app_refused'])
        assert int(res['api_app_mesh']) == WORLD


@pytest.mark.parametrize('name', list(CONFIGS))
def test_three_adam_steps_match_the_jax_dp_trainer(refs, ranks, name):
    """Losses, parameters and (bn) batch_stats after three steps on the
    ranks' halves of the global batches, against the JAX trainer's steps
    on the whole batches over a 2-device mesh; the ranks agree bit for
    bit."""
    _, want = refs
    want = worker.flat(want[name])
    res = _case(ranks, 'case_steps')
    np.testing.assert_allclose(res[0][f'{name}/losses'], want['losses'],
                               rtol=1e-5)
    seen = 0.0
    for kind in ('params3', 'stats3'):
        keys = [k for k in want if k.startswith(kind + '/')]
        assert bool(keys) == (kind == 'params3' or name == 'bn')
        for key in keys:
            got = res[0][f'{name}/{key}']
            np.testing.assert_array_equal(got, res[1][f'{name}/{key}'],
                                          err_msg=key)
            np.testing.assert_allclose(got, want[key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
            seen = max(seen, float(np.abs(got - want[key]).max()))
    print(f'{name}: max |port - jax| of parameters and statistics {seen:.3g}')


def _one_process(**kw):
    return tds.SupervisedTrainer(**worker.run_args(
        worker._run_data(), batch_size=4 * WORLD, learning_rate=1e-3,
        **kw)).run()


def test_run_equals_one_process_at_the_global_batch(ranks):
    """2 ranks x batch 4 at half the rate (scaled x2) against one process
    x batch 8: fithist and test_loss within tests/test_distributed.py's
    tolerances; the ranks' histories equal."""
    res = _case(ranks, 'case_run')
    for key in ('run_loss', 'run_val_loss', 'run_test_loss'):
        np.testing.assert_array_equal(res[0][key], res[1][key], err_msg=key)
    one = _one_process(epochs=3)
    pairs = ((res[0]['run_loss'], one.fithist['loss']),
             (res[0]['run_val_loss'], one.fithist['val_loss']),
             (res[0]['run_test_loss'], one.test_loss))
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-5)
    seen = max(float(np.max(np.abs(np.asarray(g) - np.asarray(w))
                            / np.abs(np.asarray(w)))) for g, w in pairs)
    print(f'run(): max relative |2 ranks - 1 process| {seen:.3g}')


def test_streamed_run_equals_one_process_at_the_global_batch(ranks):
    """data_in_hbm=False: each rank streams the global batches from the
    same seed and copies its rows into its step; the losses are one
    process's at the global batch."""
    res = _case(ranks, 'case_run')
    for key in ('stream_loss', 'stream_test_loss'):
        np.testing.assert_array_equal(res[0][key], res[1][key], err_msg=key)
    one = _one_process(epochs=2, data_in_hbm=False)
    np.testing.assert_allclose(
        res[0]['stream_loss'], one.fithist['loss'] + one.fithist['val_loss'],
        rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(res[0]['stream_test_loss'], one.test_loss,
                               rtol=5e-3, atol=1e-5)


def test_only_the_first_worker_saves_and_every_rank_resumes(ranks):
    """With save=True, save_bestmodel and a checkpoint an epoch, rank 0's
    save_path holds the model, the checkpoints and the results, rank 1's
    nothing; both ranks resume from rank 0's epoch-2 checkpoint and run
    epoch 3 as the unbroken run did."""
    res = _case(ranks, 'case_run')
    files = set(res[0]['run_files'].tolist())
    assert {'best_model/checkpoint.pt', 'checkpoints/epoch-1/checkpoint.pt',
            'checkpoints/epoch-3/checkpoint.pt', 'test_loss.txt',
            'convnet_pin/variables.pkl'} <= files, files
    assert res[1]['run_files'].tolist() == ['']
    for r in res:
        np.testing.assert_array_equal(r['resume_loss'], r['run_loss'][2:])
        np.testing.assert_array_equal(r['resume_test_loss'],
                                      r['run_test_loss'])


def test_early_stopping_stops_both_ranks_at_the_same_epoch(ranks):
    """min_delta 1e9: only the first epoch improves, so both ranks stop
    after patience 2 more, at epoch 3, as one process does."""
    res = _case(ranks, 'case_run')
    np.testing.assert_array_equal(res[0]['stop_val_loss'],
                                  res[1]['stop_val_loss'])
    assert res[0]['stop_val_loss'].shape == (3,)
    one = _one_process(epochs=10, steps_per_epoch=1, early_stopping=True,
                       patience=2, min_delta=1e9)
    assert len(one.fithist['val_loss']) == 3


def test_dropout_masks_differ_across_ranks(ranks):
    """The ranks' dropout generators are seeded from (seed, rank): the same
    input gives different outputs in train mode, and the run's history is
    still one."""
    res = _case(ranks, 'case_dropout')
    assert np.abs(res[0]['dropout_out'] - res[1]['dropout_out']).max() > 0
    np.testing.assert_array_equal(res[0]['dropout_loss'],
                                  res[1]['dropout_loss'])
    np.testing.assert_array_equal(res[0]['dropout_test_loss'],
                                  res[1]['dropout_test_loss'])


@pytest.mark.parametrize('name', list(CONFIGS))
def test_one_rank_mesh_equals_no_mesh_bit_for_bit(refs, name):
    """At one rank (a gloo group in the test process, as the card runs
    NCCL at its count of one) the mesh path's reductions change no bit:
    run() with and without the mesh gives the same fithist, test_loss,
    parameters and running statistics."""
    hr = np.load(refs[0])['hr']
    args = dict(CONFIGS[name], data_train=hr, data_val=hr[:6],
                data_test=hr[:6], device='cpu', epochs=2, steps_per_epoch=2,
                validation_steps=1, test_steps=1)
    tds.distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0,
                               device='cpu', timeout=60)
    try:
        runs = [tds.SupervisedTrainer(mesh=mesh, **args).run()
                for mesh in (None, tds.distributed.global_mesh())]
    finally:
        torch.distributed.destroy_process_group()
    plain, dp = runs
    assert dp.data_group is not None and dp.n_data_shards == 1
    assert dp.fithist == plain.fithist and dp.test_loss == plain.test_loss
    want = dict(plain.train_net.state_dict())
    for key, val in dp.train_net.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), want[key].numpy(),
                                      err_msg=key)


def _stand_in_mesh(names, device_type='cpu'):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 device_type=device_type)


def _trainer(**kw):
    hr = np.zeros((8, 16, 16, 1), np.float32)
    return tds.SupervisedTrainer('convnet', 'pin', hr, hr, hr, scale=4,
                                 batch_size=2, n_filters=2, n_blocks=1,
                                 verbose=False, **kw)


@pytest.mark.parametrize('dim', ['model', 'space'])
def test_a_model_or_space_dim_is_not_ported(dim):
    """A 'model' dim (tensor parallelism) and a 'space' dim have been
    ported (tests/test_torch_tensor_parallel.py, tests/test_torch_spatial.
    py, tests/test_torch_distributed_spatial.py): at one rank (a gloo group
    in this process) the trainer takes a ('data', dim) mesh, its batch the
    data degree's; beside each other they are the JAX trainer's ValueError,
    and `--mesh_shape data=1,<dim>=2` needs a launch of 2 processes."""
    tds.distributed.initialize(f'127.0.0.1:{_free_port()}', 1, 0,
                               device='cpu', timeout=60)
    try:
        mesh = (tds.distributed.tensor_mesh(1, 1) if dim == 'model'
                else tds.distributed.spatial_mesh(1, 1))
        tr = _trainer(device='cpu', mesh=mesh)
        assert tr.global_batch_size == tr.batch_size
        assert (tr.model_group if dim == 'model' else tr.space_group) \
            is not None
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match='ONE of'):
        _trainer(device='cpu', mesh=_stand_in_mesh(('model', 'space')))
    with pytest.MonkeyPatch.context() as m:
        m.setenv('WORLD_SIZE', '1')
        with pytest.raises(ValueError, match='needs 2 processes'):
            app._parse_mesh_shape(f'data=1,{dim}=2', 'cpu')


def test_other_refusals():
    """A mesh of another device type, an unknown dim, two `devices`, a
    'model' dim in the CGAN trainer's mesh (the JAX trainer's refusal; its
    data mesh is ported, tests/test_torch_distributed_cgan.py),
    `--mesh_shape data=3` in a launch of 2 and NCCL without a card raise;
    one `devices` entry selects it."""
    with pytest.raises(ValueError, match="over 'cuda' devices"):
        _trainer(device='cpu', mesh=_stand_in_mesh(('data',), 'cuda'))
    with pytest.raises(ValueError, match="one dim 'data'"):
        _trainer(device='cpu', mesh=_stand_in_mesh(('batch',)))
    with pytest.raises(TypeError, match='DeviceMesh'):
        _trainer(device='cpu', mesh=object())
    with pytest.raises(ValueError, match='one process a device'):
        _trainer(devices=['cpu', 'cpu'])
    assert _trainer(devices=['cpu']).device == torch.device('cpu')
    hr = np.zeros((8, 16, 16, 1), np.float32)
    with pytest.raises(NotImplementedError,
                       match='routed through SupervisedTrainer'):
        tds.CGANTrainer('resnet', 'spc', hr, hr, scale=4, device='cpu',
                        mesh=_stand_in_mesh(('data', 'model')))
    with pytest.MonkeyPatch.context() as m:
        m.setenv('WORLD_SIZE', str(WORLD))
        with pytest.raises(ValueError, match='needs 3 processes'):
            app._parse_mesh_shape('data=3', 'cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tds.distributed.initialize('127.0.0.1:1', 1, 0)
    assert not torch.distributed.is_initialized()
