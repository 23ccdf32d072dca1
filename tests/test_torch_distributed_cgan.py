"""The port's data-parallel CGAN trainer (`CGANTrainer(mesh=...)`) against
the JAX package on the CPU, on the pattern of tests/
test_torch_distributed.py: the test process writes the JAX references to
an .npz file, then spawns two torch-only ranks
(`tests/_torch_dp_cgan_worker.py`) over a gloo group, once for the module;
each rank asserts that neither JAX nor the JAX package is imported, runs
every case and writes its results, which the tests read.

The discriminator's Dropout(0.4) draws a fixed mask on both sides
(`pattern` of the global batch's shape, each rank its rows; JAX's
`random.bernoulli` replaced while its step is traced), so that the runs
are free of random draws:

- (a) three fused G+D steps against the JAX trainer on
  `devices=jax.devices()[:2]` (`_train_step_batch` on global batches
  sharded over its 'data' axis), each rank on its half: the flagship
  generator with dssim_mae (its range over the global batch) and a
  recurrent pair. Losses rtol 1e-5; both nets' parameters atol 2e-6; the
  ranks bit for bit. The rates are the no-mesh trainer's (no Goyal
  scaling). The DSSIM loss within `batch_group` is JAX's over the global
  batch, and without it the mean of the halves' own, which differs;
- (b) `run()` at 2 ranks x 4 against one process x 8, saving on rank 0
  alone (checkpoints, `losses.npy`, results), and a resume from its final
  checkpoint on both ranks;
- (c) `--trainer=CGANTrainer --mesh_shape=data=2` through `app.main`;
- (d) a one-rank mesh against no mesh, bit for bit, in the test process.
"""

import contextlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

import dl4ds_tpu as dds
from dl4ds_tpu import losses as jax_losses
from dl4ds_tpu.training import cgan as jax_cgan

import dl4ds_tpu_torch as tds

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as harness  # noqa: E402
import _torch_dp_cgan_worker as worker  # noqa: E402
from _torch_xla import quick_xla  # noqa: E402,F401

WORLD = 2
WORKER_TIMEOUT = 300       # seconds for both ranks, all cases
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
N_STEPS = 3
B, SCALE = worker.B, worker.SCALE


@pytest.fixture(autouse=True, scope='module')
def _threads():
    torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@contextlib.contextmanager
def _jax_pattern():
    """JAX's dropout draws replaced by `worker.pattern` of their shape."""
    real = jax.random.bernoulli

    def bern(key, p=0.5, shape=None, *args, **kwargs):
        return jnp.asarray(worker.pattern(tuple(shape)))
    jax.random.bernoulli = bern
    try:
        yield
    finally:
        jax.random.bernoulli = real


def _models(pkg, cfg):
    patch, tw = cfg['patch_size'], cfg.get('time_window')
    lr_hw = (patch // SCALE,) * 2
    gen = pkg.build_model('resnet', 'spc', SCALE, 1, 0, lr_hw,
                          (patch, patch), time_window=tw, **worker.G_ARGS)
    disc = pkg.residual_discriminator(1, 'spc', tw is not None, SCALE, lr_hw,
                                      time_window=tw, **worker.D_ARGS)
    return gen, disc


def _jax_dp_steps(data, cfg, seed):
    """Three `_train_step_batch` steps of the JAX CGAN trainer on a
    2-device 'data' mesh, from the port's weights (drawn from seeds 3 and
    4, carried by `export_jax_params`), its states replicated and each
    global batch sharded as `run()` places them."""
    tr = jax_cgan.CGANTrainer(
        'resnet', 'spc', data, data, scale=SCALE, batch_size=B,
        learning_rates=worker.LRS, generator_params=dict(worker.G_ARGS),
        discriminator_params=dict(worker.D_ARGS),
        devices=jax.devices()[:WORLD], verbose=False,
        save_loss_history=False, **cfg)
    assert tr.n_data_shards == WORLD
    tr.generator, tr.discriminator = _models(dds, cfg)
    tr.ds_train = None
    tr._make_step()
    tg, td = _models(tds, cfg)
    gp = tds.weights.export_jax_params(tg.init(3, device='cpu'))
    dp = tds.weights.export_jax_params(td.init(4, device='cpu'))
    out = {'g0': _np(gp), 'd0': _np(dp)}

    def tx(lr):
        return optax.flatten(optax.adam(lr, b1=0.5, eps=1e-7))
    gs = jax_cgan.GenTrainState.create(apply_fn=None, params=gp,
                                       tx=tx(worker.LRS[0]), ema_params=None)
    ds = train_state.TrainState.create(apply_fn=None, params=dp,
                                       tx=tx(worker.LRS[1]))
    gs = jax.device_put(gs, tr.replicated_sharding)
    ds = jax.device_put(ds, tr.replicated_sharding)
    patch, tw = cfg['patch_size'], cfg.get('time_window')
    frames = () if tw is None else (tw,)
    rng = np.random.default_rng(seed)
    losses = []
    with _jax_pattern():
        for i in range(N_STEPS):
            batch = {'lr': rng.standard_normal(
                (WORLD * B,) + frames + (patch // SCALE,) * 2 + (1,)),
                'hr': rng.standard_normal(
                    (WORLD * B,) + frames + (patch, patch, 1))}
            batch = {k: v.astype(np.float32) for k, v in batch.items()}
            out[f'batch{i}'] = batch
            placed = {k: jax.device_put(jnp.asarray(v), tr.batch_sharding)
                      for k, v in batch.items()}
            placed['aux'] = None
            gs, ds, step = tr._train_step_batch(gs, ds, placed,
                                                jax.random.PRNGKey(i))
            losses.append([float(v) for v in step])
    out['losses'] = np.array(losses)
    out['g3'], out['d3'] = _np(gs.params), _np(ds.params)
    return out


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    data = np.random.default_rng(22).standard_normal(
        (6, 16, 16, 1)).astype(np.float32)
    flat = {'data': data, 'names': json.dumps(list(worker.CONFIGS))}
    want = {}
    for k, (name, cfg) in enumerate(worker.CONFIGS.items()):
        want[name] = _jax_dp_steps(data, cfg, 30 + k)
        flat[f'{name}/config'] = json.dumps(cfg)
        flat[f'{name}/n_batches'] = N_STEPS
        for key, val in harness.flat(want[name]).items():
            flat[f'{name}/{key}'] = val
    path = tmp_path_factory.mktemp('dp_cgan') / 'refs.npz'
    np.savez(path, **flat)
    return path, want


@pytest.fixture(scope='module')
def ranks(refs):
    return harness.spawn(worker.__file__, refs[0], WORLD, WORKER_TIMEOUT)


def test_ranks_import_neither_jax_nor_the_jax_package(ranks):
    for status, _ in ranks:
        assert status['no_jax'] == []


@pytest.mark.parametrize('name', list(worker.CONFIGS))
def test_three_fused_steps_match_the_jax_dp_trainer(refs, ranks, name):
    """The four losses and both networks' parameters after three steps on
    the ranks' halves of the global batches, against the JAX trainer's
    steps on the whole batches over a 2-device mesh; the ranks agree bit
    for bit."""
    _, want = refs
    want = harness.flat(want[name])
    res = harness.case_results(ranks, 'case_steps')
    np.testing.assert_allclose(res[0][f'{name}/losses'], want['losses'],
                               rtol=LOSS_RTOL)
    seen = 0.0
    for net in ('g3', 'd3'):
        keys = [k for k in want if k.startswith(net + '/')]
        assert keys
        for key in keys:
            got = res[0][f'{name}/{key}']
            np.testing.assert_array_equal(got, res[1][f'{name}/{key}'],
                                          err_msg=key)
            np.testing.assert_allclose(got, want[key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
            seen = max(seen, float(np.abs(got - want[key]).max()))
    print(f'{name}: max |port - jax| of G and D parameters {seen:.3g}')


def test_rates_are_not_scaled_by_the_ranks(refs, ranks):
    """The JAX CGAN trainer applies no Goyal scaling: under the mesh the
    schedules and the device rates are those of the no-mesh trainer."""
    data = np.load(refs[0])['data']
    plain = worker.trainer(data, **worker.CONFIGS['flagship'])
    plain.setup_model()
    plain.setup_optimizer(3)
    want = [plain._gen_lr, plain._disc_lr] + [lr.item()
                                              for _, lr in plain._rates]
    assert want == [2e-4, 3e-4, np.float32(2e-4), np.float32(3e-4)]
    for res in harness.case_results(ranks, 'case_steps'):
        for name in worker.CONFIGS:
            assert res[f'{name}/rates'].tolist() == want


def test_dssim_range_is_the_global_batch_s(ranks):
    """Within `batch_group` the ranks' DSSIM losses average to the loss
    over the whole batch in one process (its range the global one; the
    port's, rtol 1e-6, and JAX's, within tests/_torch_state.py's 1e-4:
    the two SSIMs' float32 sums differ by 1.5e-5 of it); outside it, to
    the mean of the halves' own-range losses, which differs."""
    yt, yp = worker.ssim_arrays()
    want = tds.losses.dssim_mae(torch.from_numpy(yt),
                                torch.from_numpy(yp)).item()
    jax_want = float(jax_losses.dssim_mae(jnp.asarray(yt), jnp.asarray(yp)))
    np.testing.assert_allclose(want, jax_want, rtol=1e-4)
    for res in harness.case_results(ranks, 'case_steps'):
        np.testing.assert_allclose(float(res['ssim_global']), want,
                                   rtol=1e-6)
        apart = abs(float(res['ssim_local']) - want) / want
        print(f'per-shard ranges move the loss by {apart:.3g} of it')
        assert apart > 1e-3


def test_run_equals_one_process_at_the_global_batch(ranks):
    """2 ranks x batch 4 against one process x batch 8 on the same masks:
    the four losses an epoch and the test loss within
    tests/test_distributed.py's tolerances; the ranks' histories equal.
    The test loss runs in chunks of a rank's batch, as the JAX trainer's
    does, each chunk's crops drawn in turn: the one process's generator is
    scored at that batch."""
    res = harness.case_results(ranks, 'case_run')
    for key in ('run_losses', 'run_test_loss'):
        np.testing.assert_array_equal(res[0][key], res[1][key], err_msg=key)
    args = worker.run_args(batch_size=worker.RUN_BATCH * WORLD, epochs=2)
    with worker.pattern_masks(0, 1):
        one = worker.trainer(args.pop('data'), **args).run()
    one.batch_size = worker.RUN_BATCH
    pairs = ((res[0]['run_losses'], worker._history(one)),
             (res[0]['run_test_loss'], one._test_loss()))
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=1e-5)
    seen = max(float(np.max(np.abs(np.asarray(g) - np.asarray(w))
                            / np.abs(np.asarray(w)))) for g, w in pairs)
    print(f'run(): max relative |2 ranks - 1 process| {seen:.3g}')


def test_only_the_first_worker_saves_and_every_rank_resumes(ranks):
    """Rank 0's save_path holds the epoch and final checkpoints,
    `losses.npy` and the saved generator, rank 1's nothing; both ranks
    restore rank 0's final checkpoint to the trained state and train on
    from it alike."""
    res = harness.case_results(ranks, 'case_run')
    files = set(res[0]['run_files'].tolist())
    assert {'checkpoints/epoch-1/checkpoint.pt',
            'checkpoints/epoch-2/checkpoint.pt',
            'checkpoints/final/checkpoint.pt', 'losses.npy',
            'cgan_resnet_spc/variables.pkl'} <= files, files
    assert res[1]['run_files'].tolist() == ['']
    for r in res:
        assert bool(r['resume_restored'])
        assert np.isfinite(r['resume_losses']).all()
    for key in ('resume_losses', 'resume_params'):
        np.testing.assert_array_equal(res[0][key], res[1][key], err_msg=key)


def test_app_trains_the_cgan_over_the_mesh(ranks):
    res = harness.case_results(ranks, 'case_app')
    for r, out in enumerate(res):
        assert out['app_mesh'].tolist() == [WORLD, 2 * WORLD, r]
        assert out['app_losses'].shape == (4, 2)
        assert np.isfinite(out['app_losses']).all()
    np.testing.assert_array_equal(res[0]['app_losses'], res[1]['app_losses'])


def test_one_rank_mesh_equals_no_mesh_bit_for_bit():
    """At one rank (a gloo group in the test process, as the card runs
    NCCL at its count of one) the flagship with dssim_mae and D's own
    dropout draws: run() with and without the mesh gives the same losses,
    test loss and parameters."""
    data = worker.run_data()
    args = dict(data_test=data[32:], patch_size=12, loss='dssim_mae',
                batch_size=2, epochs=2, steps_per_epoch=2)
    tds.distributed.initialize(f'127.0.0.1:{harness.free_port()}', 1, 0,
                               device='cpu', timeout=60)
    try:
        runs = [worker.trainer(data[:32], mesh=mesh, **args).run()
                for mesh in (None, tds.distributed.global_mesh())]
    finally:
        torch.distributed.destroy_process_group()
    plain, dp = runs
    assert dp.data_group is not None and dp.n_data_shards == 1
    np.testing.assert_array_equal(worker._history(dp),
                                  worker._history(plain))
    assert dp.test_loss == plain.test_loss
    want = dict(plain.train_net.state_dict())
    for key, val in dp.train_net.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), want[key].numpy(),
                                      err_msg=key)
