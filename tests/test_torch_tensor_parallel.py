"""The port's tensor parallelism (`distributed.tensor_mesh`,
`parallel.tensor_param_shardings`, `make_tensor_sharded_step`,
`SupervisedTrainer(mesh=)` with a 'model' dim) against the JAX package on
the CPU.

The test process computes the JAX references and writes them to an .npz
file, then spawns the torch-only ranks of `tests/_torch_dp_tp_worker.py`
over a gloo group, twice: 2 ranks for the ('model', 2) mesh, 4 ranks for
(data 2, model 2). The tests read what the ranks wrote:

- (a) `tensor_param_shardings` of `_tp_model()` (tests/test_parallel.py:
  357-390), in this process: the sharded set equals JAX's under
  `weights.load_jax_params`' name map, on the port's dims (a conv weight's
  output channels are its OIHW dim 0), at 2 and 4 ranks and with
  `min_channels`;
- (b) `make_tensor_sharded_step` on ('model', 2) and (data 2, model 2):
  three Adam steps against JAX's step on the same mesh and the unsharded
  program, loss within 1e-5 and parameters atol 2e-5
  (tests/test_parallel.py:395-440); the first gradients, gathered, against
  the unsharded ones (atol 1e-5), and on every rank the gradient rule (a
  replicated parameter's gradient equal bit for bit across the 'model'
  group); an aux model's loss and gradients and the missing aux refused
  (:443-466);
- (c) `SupervisedTrainer` on (data 2, model 2): three `train_step`s of the
  flagship with EMA 0.9, accumulation 2 and warmup_cosine, of the flagship
  with dssim_mae (K6's plain version) and of recresnet_spc (time_window 2)
  against the JAX trainer's `_train_step_batch` on the same mesh, losses
  rtol 2e-4 (tests/test_trainer_mesh.py:39-63), parameters and EMA copy
  atol 2e-6, each rank's parameters, Adam moments, accumulators and EMA
  copy shards, the global batch twice a rank's; run() on (data 2, model 2)
  against one process at the global batch and twice the rate, and on
  ('model', 2) against the run without a mesh from one seed, in-HBM and
  streamed (:107-132): fithist and test_loss rtol 2e-4, the gathered
  weights atol 2e-6; checkpoints resumed across the mesh and no mesh (the
  JAX trainer's run() draws other batches than the port's);
- (f) the refusals: bn under 'model', the CGAN trainer on a 'model' mesh,
  `--mesh_shape data=1,model=2` and its process count.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import dl4ds_tpu as dds
from dl4ds_tpu import parallel as jpar
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import parallel as tpar
from dl4ds_tpu_torch.models import blocks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as worker  # noqa: E402
import _torch_dp_tp_worker as tp_worker  # noqa: E402
from _torch_xla import quick_xla  # noqa: F401,E402

WORKER_TIMEOUT = 300       # seconds for all ranks, all cases
LOSS_TOL, STEP_ATOL, GRAD_ATOL = 1e-5, 2e-5, 1e-5   # tests/test_parallel.py
PARAM_ATOL = 2e-6          # tests/test_torch_training.py
LOSS_RTOL = 2e-4           # tests/test_trainer_mesh.py:39-63
# the dssim_mae flagship's output conv bias has a near-zero gradient, whose
# Adam steps move with its last bits: the JAX trainer's own steps on
# ('data', 2) and on (data 2, model 2) leave it 4.05e-5 apart (every other
# tensor within 5.7e-7), so that run is held in the norm of the whole
# parameter set, as chip_smoke.py's phase 24 holds its runs
DSSIM_NORM_RTOL = 1e-5
HR_Y, HR_X = 32, 40
TP = dict(backbone_block='resnet', upsampling='spc', scale=2, n_channels=1,
          n_aux_channels=0, lr_size=(8, 8), n_filters=8, n_blocks=3,
          attention=True)
BASE = dict(backbone='resnet', upsampling='spc', scale=4, patch_size=16,
            batch_size=2, n_blocks=2, n_filters=8, attention=True,
            loss='mae', verbose=False)
# a rank's configuration; the JAX trainer's global batch is twice it
CONFIGS = {
    'flagship': dict(BASE, ema_decay=0.9, gradient_accumulation_steps=2,
                     lr_schedule='warmup_cosine'),
    'dssim': dict(BASE, loss='dssim_mae'),
    'recurrent': dict(BASE, time_window=2, n_blocks=1, n_filters=4,
                      attention=False),
}
INDICES = ([0, 5, 2, 7], [6, 2, 1, 4], [3, 3, 0, 6])


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _mesh(*names_sizes):
    sizes = [s for _, s in names_sizes]
    devs = np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return Mesh(devs, tuple(n for n, _ in names_sizes))


def _stand_in(n):
    """A stand-in for a ('model',) DeviceMesh of n ranks."""
    return types.SimpleNamespace(mesh_dim_names=('model',),
                                 size=lambda i: n)


def _port_name(net, path):
    """The port's parameter name of the Flax leaf at `path`: the module
    path joined with dots, a `Conv`'s `kernel` its `weight`."""
    owner = net.get_submodule('.'.join(path[:-1]))
    leaf = ('weight' if isinstance(owner, blocks.Conv)
            and path[-1] == 'kernel' else path[-1])
    return '.'.join(path[:-1] + (leaf,))


@pytest.mark.parametrize('n,min_channels', [(2, None), (4, None), (2, 16)])
def test_tensor_param_shardings_equal_the_jax_ones(n, min_channels):
    """(a) the sharded set equals JAX's (on shapes from `jax.eval_shape`,
    nothing compiled), at least 10 leaves at 2 ranks, each sharded on its
    output-feature dim in the port's layout."""
    jm = dds.net_postupsampling(**TP)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    jspec = jpar.tensor_param_shardings(shapes['params'],
                                        _mesh(('model', n)),
                                        min_channels=min_channels)
    net = tds.net_postupsampling(**TP).build()
    spec = tpar.tensor_param_shardings(net, _stand_in(n),
                                       min_channels=min_channels)
    flat = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    want = {_port_name(net, tuple(k.key for k in path)): 'model' in tuple(s)
            for path, s in flat[0]}
    assert set(want) == set(spec)
    assert {k for k, v in want.items() if v} == \
        {k for k, d in spec.items() if d is not None}
    params = dict(net.named_parameters())
    for k, d in spec.items():
        if d is not None:
            assert d == (0 if k.endswith('.weight')
                         else params[k].dim() - 1), k
            assert params[k].shape[d] % n == 0
    if (n, min_channels) == (2, None):
        assert sum(d is not None for d in spec.values()) >= 10


def _unsharded_steps(model, params, x, y, aux=None):
    """The first loss and gradients and three Adam steps (lr 1e-3) of the
    whole program (tests/test_parallel.py:403-414)."""
    tx = optax.adam(1e-3)

    @jax.jit
    def lag(p):
        def loss_fn(p):
            out = model.module.apply({'params': p}, x, aux, training=True,
                                     rngs={'dropout': jax.random.PRNGKey(1)})
            return jnp.mean(jnp.abs(y - out.astype(jnp.float32)))
        return jax.value_and_grad(loss_fn)(p)

    @jax.jit
    def update(g, st, p):
        up, st = tx.update(g, st, p)
        return optax.apply_updates(p, up), st

    loss0, g0 = lag(params)
    p, st = params, tx.init(params)
    for _ in range(3):
        loss, g = lag(p)
        p, st = update(g, st, p)
    return dict(loss0=float(loss0), grads0=_np(g0), loss3=float(loss),
                params3=_np(p))


def _port_weights(model_fn, **kw):
    """Weights that the port draws (seed 0), as the Flax tree: JAX's init
    is not compiled (tests/test_torch_recurrent_zoo.py's way)."""
    net = getattr(tds, model_fn)(**kw).init(0, device='cpu')
    return jax.tree_util.tree_map(jnp.asarray,
                                  tds.weights.export_jax_params(net))


def _tp_refs(meshes, rng):
    """The unsharded program's first gradients and three Adam steps, and
    JAX `make_tensor_sharded_step`'s three steps from the same weights on
    each of `meshes` ({name: mesh})."""
    model = dds.net_postupsampling(**TP)
    params = _port_weights('net_postupsampling', **TP)
    x = rng.standard_normal((8, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((8, 16, 16, 1)).astype(np.float32)
    out = {'config': json.dumps(TP), 'params0': _np(params), 'x': x, 'y': y,
           'plain': _unsharded_steps(model, params, x, y)}
    for name, mesh in meshes.items():
        ts = jpar.make_tensor_sharded_step(model, mesh, tx=optax.adam(1e-3))
        p = jax.device_put(params, ts.param_shardings)
        st = ts.init_opt(p)
        for _ in range(3):
            p, st, loss = ts.step(p, st, x, y, jax.random.PRNGKey(1))
        out[name] = {'loss3': float(loss), 'params3': _np(p)}
    return out


def _aux_refs(rng):
    """JAX's `loss_and_grads` of the aux model on ('model', 2)."""
    cfg = dict(TP, n_aux_channels=1)
    model = dds.net_postupsampling(**cfg)
    params = _port_weights('net_postupsampling', **cfg)
    ts = jpar.make_tensor_sharded_step(model, _mesh(('model', 2)),
                                       tx=optax.adam(1e-3))
    x = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((4, 16, 16, 1)).astype(np.float32)
    aux = rng.standard_normal((4,) + tuple(model.aux_shape)).astype(
        np.float32)
    loss, grads = ts.loss_and_grads(jax.device_put(params,
                                                   ts.param_shardings),
                                    x, y, jax.random.PRNGKey(0), aux=aux)
    return {'config': json.dumps(cfg), 'params0': _np(params), 'x': x,
            'y': y, 'aux': aux, 'loss': float(loss), 'grads': _np(grads)}


_TRAINER_KEYS = ('backbone', 'upsampling', 'scale', 'patch_size',
                 'batch_size', 'loss', 'verbose', 'ema_decay',
                 'gradient_accumulation_steps', 'lr_schedule', 'time_window')


def _trained_model(config):
    """The JAX trainer's (model, variables) for `config`, with weights that
    the port draws: the trainer's own init is not compiled."""
    arch = {k: v for k, v in config.items() if k not in _TRAINER_KEYS}
    lr = config['patch_size'] // config['scale']
    sizes = dict(backbone=config['backbone'],
                 upsampling=config['upsampling'], scale=config['scale'],
                 n_channels=1, n_aux_channels=0, lr_size=(lr, lr),
                 hr_size=(config['patch_size'],) * 2,
                 time_window=config.get('time_window'), **arch)
    net = tds.build_model(**sizes).init(0, device='cpu')
    params = jax.tree_util.tree_map(jnp.asarray,
                                    tds.weights.export_jax_params(net))
    return dds.build_model(**sizes), {'params': params}


def _jax_steps(hr, config):
    """Three `_train_step_batch` steps of the JAX trainer on Mesh(('data',
    2), ('model', 2)), its state placed as `run()` places it (channel
    sharded) and each global batch sharded over 'data'."""
    tr = jax_supervised.SupervisedTrainer(
        data_train=hr, data_val=hr[:6], data_test=hr[:6], save=False,
        learning_rate=(1e-3, 1e-4), mesh=_mesh(('data', 2), ('model', 2)),
        trained_model=_trained_model(config), **config)
    assert tr.tp_axis == 'model' and tr.n_data_shards == 2
    tr.setup_datagen()
    tr.setup_model()
    out = {'params0': _np(tr.variables['params'])}
    state = jax_supervised.TrainState.create(
        apply_fn=tr.model.module.apply, params=tr.variables['params'],
        tx=tr._build_optimizer(),
        ema_params=(jax.tree.map(jnp.array, tr.variables['params'])
                    if tr.ema_decay > 0 else None))
    state = jax.device_put(state, tr._make_state_shardings(state))
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
    if state.ema_params is not None:
        out['ema3'] = _np(state.ema_params)
    return out


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    rng = np.random.default_rng(24)
    hr = rng.standard_normal((10, HR_Y, HR_X, 1)).astype(np.float32)
    want = {'tp': _tp_refs({'model2': _mesh(('model', 2)),
                            'data2_model2': _mesh(('data', 2),
                                                  ('model', 2))}, rng),
            'aux': _aux_refs(rng)}
    for name, config in CONFIGS.items():
        want[name] = _jax_steps(hr, config)
    common = {'hr': hr, 'names': json.dumps(list(CONFIGS))}
    for name, config in CONFIGS.items():
        common[f'{name}/config'] = json.dumps(config)
        common[f'{name}/n_batches'] = len(INDICES)
        for key, val in worker.flat(want[name]).items():
            common[f'{name}/{key}'] = val
    paths = {}
    for mode in ('tensor2', 'tensor4'):
        flat = dict(common, mode=mode)
        for part in ('tp', 'aux'):
            for key, val in worker.flat(want[part]).items():
                if key.split('/')[0] in ('config', 'params0', 'x', 'y',
                                         'aux'):
                    flat[f'{part}/{key}'] = val
        paths[mode] = tmp_path_factory.mktemp(mode) / 'refs.npz'
        np.savez(paths[mode], **flat)
    return paths, want


@pytest.fixture(scope='module')
def ranks2(refs):
    """The 2 ranks' results: [(status, results)] by rank."""
    return worker.spawn(tp_worker.__file__, refs[0]['tensor2'], 2,
                        WORKER_TIMEOUT)


@pytest.fixture(scope='module')
def ranks4(refs):
    """The 4 ranks' results."""
    return worker.spawn(tp_worker.__file__, refs[0]['tensor4'], 4,
                        WORKER_TIMEOUT)


_case = worker.case_results


def _close(res, prefix, want, atol, what):
    for key, val in worker.flat(want).items():
        np.testing.assert_allclose(res[f'{prefix}/{key}'], val, rtol=0,
                                   atol=atol, err_msg=f'{what}: {key}')


def test_ranks_import_neither_jax_nor_the_jax_package(ranks2, ranks4):
    for status, _ in ranks2 + ranks4:
        assert status['no_jax'] == []


@pytest.mark.parametrize('mesh', ['model2', 'data2_model2'])
def test_tensor_sharded_step_matches_jax_and_unsharded(refs, ranks2, ranks4,
                                                       mesh):
    """(b) three Adam steps: the last loss within 1e-5 of the unsharded
    program's and of JAX's step on the same mesh, the gathered parameters
    atol 2e-5 of both; each rank holds shards, and so do its moments."""
    ranks = ranks2 if mesh == 'model2' else ranks4
    want = refs[1]['tp']
    for res in _case(ranks, 'case_tensor_step'):
        assert bool(res['tp/shards']) and bool(res['tp/moments'])
        for ref in (want['plain'], want[mesh]):
            assert abs(float(res['tp/loss3']) - ref['loss3']) < LOSS_TOL
            _close(res, 'tp/params3', ref['params3'], STEP_ATOL, mesh)


@pytest.mark.parametrize('mesh', ['model2', 'data2_model2'])
def test_gradient_rule_on_every_rank(refs, ranks2, ranks4, mesh):
    """(b) on every rank, each replicated parameter's gradient equals the
    other 'model' ranks' bit for bit (it is never summed over the group),
    and the shards' gradients, joined, are the unsharded program's (atol
    1e-5); the first loss within 1e-5."""
    ranks = ranks2 if mesh == 'model2' else ranks4
    want = refs[1]['tp']['plain']
    for res in _case(ranks, 'case_tensor_step'):
        worst, n_rep, n_shard = res['tp/rule']
        assert worst == 0.0 and n_rep > 0 and n_shard >= 10
        assert abs(float(res['tp/loss0']) - want['loss0']) < LOSS_TOL
        _close(res, 'tp/grads0', want['grads0'], GRAD_ATOL, mesh)


def test_loss_and_grads_with_aux(refs, ranks2):
    """(b) an aux model: without aux= the step raises ValueError; with it
    the loss within 1e-5 and the gathered gradients atol 1e-5 of JAX's
    `loss_and_grads` on ('model', 2); a step gives a finite loss."""
    want = refs[1]['aux']
    for res in _case(ranks2, 'case_tensor_aux'):
        assert 'aux' in str(res['aux/missing'])
        assert abs(float(res['aux/loss']) - want['loss']) < LOSS_TOL
        _close(res, 'aux/grads', want['grads'], GRAD_ATOL, 'aux')
        assert np.isfinite(float(res['aux/step_loss']))


@pytest.mark.parametrize('name', list(CONFIGS))
def test_three_steps_on_data2_model2_match_the_jax_trainer(refs, ranks4,
                                                            name):
    """(c) losses rtol 2e-4, the gathered parameters (and EMA copy) atol
    2e-6 of the JAX trainer's on the same mesh (dssim_mae: in the norm of
    the set, within 1e-5, see DSSIM_NORM_RTOL); the ranks agree bit for
    bit; every shard a rank holds is half its parameter, and so are its
    Adam moments, accumulators and EMA copy; the global batch is the data
    degree's."""
    want = worker.flat(refs[1][name])
    res = _case(ranks4, 'case_trainer_steps')
    for r in res:
        ok, n_shards, gbs = r[f'{name}/shards']
        assert ok and n_shards > 0 and gbs == 2 * BASE['batch_size']
        np.testing.assert_allclose(r[f'{name}/losses'], want['losses'],
                                   rtol=LOSS_RTOL)
    diff = norm = 0.0
    for kind in ('params3', 'ema3'):
        for key in (k for k in want if k.startswith(kind + '/')):
            got = res[0][f'{name}/{key}']
            for other in res[1:]:
                np.testing.assert_array_equal(got, other[f'{name}/{key}'],
                                              err_msg=key)
            diff += float(((got - want[key]).astype(np.float64) ** 2).sum())
            norm += float((want[key].astype(np.float64) ** 2).sum())
            if CONFIGS[name]['loss'] != 'dssim_mae':
                np.testing.assert_allclose(got, want[key], rtol=0,
                                           atol=PARAM_ATOL, err_msg=key)
    assert (diff / norm) ** 0.5 <= DSSIM_NORM_RTOL


@pytest.mark.parametrize('tier', ['hbm', 'stream', 'dropout'])
def test_run_on_a_model_mesh_equals_the_run_without(ranks2, tier):
    """(c) run() on the ('model', 2) mesh against the port's run without a
    mesh from one seed, in-HBM, streamed and with dropout (every 'model'
    rank of a data row draws the row's masks, from the generator seeded by
    its data coordinate): fithist and test_loss rtol 2e-4, the ranks
    agreeing; only rank 0 is the first worker; `net` after
    run() is whole (gathered) and atol 2e-6 of the plain run's."""
    res = _case(ranks2, 'case_runs')
    for r in res:
        np.testing.assert_array_equal(r[f'run/{tier}/model'],
                                      res[0][f'run/{tier}/model'])
        np.testing.assert_allclose(r[f'run/{tier}/model'],
                                   r[f'run/{tier}/plain'], rtol=LOSS_RTOL)
    if tier == 'hbm':
        assert [bool(r['run/model/first_worker']) for r in res] == [True,
                                                                    False]
        for key in (k for k in res[0] if k.startswith('run/plain/net/')):
            got = res[0][key.replace('/plain/', '/model/')]
            np.testing.assert_allclose(got, res[0][key], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)


def test_checkpoints_resume_with_or_without_the_mesh(ranks2):
    """(c) a checkpoint written under ('model', 2) holds the gathered state:
    resumed with the mesh or without it, and one written without it resumed
    with it, each run's last epoch and test loss equal the full run's
    (rtol 2e-4)."""
    for r in _case(ranks2, 'case_runs'):
        full = r['run/hbm/model']
        want = np.array([full[1], full[3], full[4]])
        for key in ('model_to_model', 'model_to_plain', 'plain_to_model'):
            np.testing.assert_allclose(r[f'resume/{key}'], want,
                                       rtol=LOSS_RTOL, err_msg=key)


def test_run_on_data2_model2_equals_one_process_at_the_global_batch(ranks4):
    """(c) run() on (data 2, model 2) against one process at the global
    batch and twice the rate (the data mesh's scaled rate), from one seed:
    fithist and test_loss rtol 2e-4, the ranks agreeing."""
    res = _case(ranks4, 'case_global_batch')
    for r in res:
        np.testing.assert_array_equal(r['global/mesh'], res[0]['global/mesh'])
        np.testing.assert_allclose(r['global/mesh'], r['global/one'],
                                   rtol=LOSS_RTOL)


def test_refusals_under_model(ranks2):
    """(f) bn: the trainer's run(), the step's making and the norm within a
    model group raise the JAX package's ValueError naming 'batch-norm'; the
    CGAN trainer on a 'model' mesh the JAX trainer's NotImplementedError;
    `--mesh_shape data=1,model=2` builds the (data 1, model 2) mesh and
    `data=2,model=2` needs 4 processes."""
    for res in _case(ranks2, 'case_refusals'):
        bn_run, bn_step, bn_norm, cgan = res['refusals'].tolist()
        for msg in (bn_run, bn_step, bn_norm):
            assert 'batch-norm' in msg, msg
        assert 'SupervisedTrainer' in cgan
        assert res['app_mesh'].tolist() == ["('data', 'model')", '(1, 2)']
        assert 'needs 4 processes' in str(res['app_count'])


def test_load_jax_named_defaults_to_the_card():
    """`weights.load_jax_named` puts the whole tensors on the card unless
    device='cpu' is asked for, as every entry point of the port does
    (`utils.resolve_device`): without a GPU its default raises, naming
    device='cpu'."""
    import inspect
    import torch
    fn = tds.weights.load_jax_named
    assert inspect.signature(fn).parameters['device'].default == 'cuda'
    model = tds.net_postupsampling('resnet', 'spc', scale=2, n_channels=1,
                                   n_aux_channels=0, lr_size=(8, 8),
                                   n_filters=4, n_blocks=1)
    tree = tds.weights.export_jax_params(model.init(0, device='cpu'))
    named = fn(model, tree, device='cpu')
    assert all(t.device.type == 'cpu' for t in named.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(model, tree)
