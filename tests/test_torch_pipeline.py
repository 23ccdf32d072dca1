"""The port's pipeline parallelism (`distributed.pipeline_mesh`,
`parallel.make_pipeline_step`, the recurrent nets' `trunk_fn` hook and the
one-process stage program `_pipeline_trunk_local`) against the JAX package
on the CPU.

The test process computes the JAX references and writes them to an .npz
file, then spawns 4 torch-only ranks of `tests/_torch_dp_tp_worker.py` over
a gloo group. The tests read what the ranks wrote:

- (d) `make_pipeline_step` on ('pipe', 4) against JAX's on a 4-device
  ('pipe',) mesh and the unsharded program (tests/test_parallel.py:
  551-604): the split/merge round trip bit for bit, each stage's one block,
  the loss within 1e-5, the gradients atol 1e-5, three Adam steps atol
  2e-5; a recnet_pin densenet with ln, mse and n_micro 2 on a ('pipe',
  'data') = (2, 2) mesh (:607-639, reduced from 8 devices to 4 ranks); on
  every rank the gradient rule: the stem's and head's gradients equal bit
  for bit across 'pipe';
- (e) `_pipeline_trunk_local` at S = 2 and 4, in one process, against the
  distributed run's gradients and the unsharded program;
- (f) the validation (:642-676): the step's inputs in the ranks, the
  model and mesh refusals in this process (stand-in meshes: the checks
  come before any group is asked for).
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

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import parallel as tpar

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dp_worker as worker  # noqa: E402
import _torch_dp_tp_worker as tp_worker  # noqa: E402
from _torch_xla import quick_xla  # noqa: F401,E402

WORKER_TIMEOUT = 300       # seconds for all ranks, all cases
LOSS_TOL, GRAD_ATOL, STEP_ATOL = 1e-5, 1e-5, 2e-5   # tests/test_parallel.py
LOCAL_ATOL = 1e-6          # (e): one process against the ranks
PP = dict(backbone_block='resnet', upsampling='spc', scale=2, n_channels=1,
          n_aux_channels=0, lr_size=(8, 8), time_window=3, n_filters=4,
          n_blocks=4)
PIN = dict(backbone_block='densenet', n_channels=1, n_aux_channels=0,
           hr_size=(8, 8), time_window=2, n_filters=4, n_blocks=4,
           normalization='ln')


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _weights(factory, kw):
    """The JAX model and weights that the port draws (seed 0) as its Flax
    tree: JAX's init is not compiled."""
    net = getattr(tds.models, factory)(**kw).init(0, device='cpu')
    params = jax.tree_util.tree_map(jnp.asarray,
                                    tds.weights.export_jax_params(net))
    return getattr(dds.models, factory)(**kw), params


def _lag(model, x, y, loss):
    @jax.jit
    def lag(p):
        def loss_fn(p):
            out = model.module.apply({'params': p}, x, None, training=True,
                                     rngs={'dropout': jax.random.PRNGKey(7)})
            err = out.astype(jnp.float32) - y
            return jnp.mean(jnp.abs(err) if loss == 'mae' else err ** 2)
        return jax.value_and_grad(loss_fn)(p)
    return lag


def _pp_refs(rng):
    """recresnet_spc (tests/test_parallel.py:543-548): the unsharded loss,
    gradients and three Adam steps; JAX's pipeline on a 4-device ('pipe',)
    mesh, its loss and merged gradients and three steps."""
    model, full = _weights('recnet_postupsampling', PP)
    x = rng.standard_normal((8, 3, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((8, 3, 16, 16, 1)).astype(np.float32)
    tx = optax.adam(1e-3)
    lag = _lag(model, x, y, 'mae')

    @jax.jit
    def update(g, st, p):
        up, st = tx.update(g, st, p)
        return optax.apply_updates(p, up), st

    loss0, g0 = lag(full)
    p, st = full, tx.init(full)
    for _ in range(3):
        _, g = lag(p)
        p, st = update(g, st, p)
    out = {'config': json.dumps({'factory': 'recnet_postupsampling',
                                 'kwargs': PP}),
           'params0': _np(full), 'x': x, 'y': y,
           'plain': {'loss0': float(loss0), 'grads0': _np(g0),
                     'params3': _np(p)}}
    mesh = Mesh(np.array(jax.devices()[:4]), ('pipe',))
    ps = jpar.make_pipeline_step(model, mesh, tx=optax.adam(1e-3),
                                 loss='mae')
    parts = jax.device_put(ps.split_params(full), ps.param_shardings)
    key = jax.random.PRNGKey(7)
    loss, grads = ps.loss_and_grads(parts, x, y, key)
    out['mesh'] = {'loss0': float(loss),
                   'grads0': _np(ps.merge_params(*grads))}
    st = ps.init_opt(parts)
    for _ in range(3):
        parts, st, _ = ps.step(parts, st, x, y, key)
    out['mesh']['params3'] = _np(ps.merge_params(*parts))
    return out


def _pin_refs(rng):
    """recnet_pin densenet with ln and mse (:607-639): JAX's pipeline on a
    ('pipe', 'data') = (2, 2) mesh with n_micro 2, and the unsharded loss
    and gradients."""
    model, full = _weights('recnet_pin', PIN)
    x = rng.standard_normal((8, 2, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((8, 2, 8, 8, 1)).astype(np.float32)
    loss0, g0 = _lag(model, x, y, 'mse')(full)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('pipe', 'data'))
    ps = jpar.make_pipeline_step(model, mesh, tx=optax.adam(1e-3),
                                 loss='mse', n_micro=2)
    loss, grads = ps.loss_and_grads(
        jax.device_put(ps.split_params(full), ps.param_shardings), x, y,
        jax.random.PRNGKey(3))
    return {'config': json.dumps({'factory': 'recnet_pin', 'kwargs': PIN}),
            'params0': _np(full), 'x': x, 'y': y,
            'plain': {'loss0': float(loss0), 'grads0': _np(g0)},
            'mesh': {'loss0': float(loss),
                     'grads0': _np(ps.merge_params(*grads))}}


@pytest.fixture(scope='module')
def refs(tmp_path_factory):
    rng = np.random.default_rng(25)
    want = {'pp': _pp_refs(rng), 'pin': _pin_refs(rng)}
    flat = {'mode': 'pipe4'}
    for part in ('pp', 'pin'):
        for key, val in worker.flat(want[part]).items():
            if key.split('/')[0] in ('config', 'params0', 'x', 'y'):
                flat[f'{part}/{key}'] = val
    path = tmp_path_factory.mktemp('pipe4') / 'refs.npz'
    np.savez(path, **flat)
    return path, want


@pytest.fixture(scope='module')
def ranks(refs):
    """The 4 ranks' results: [(status, results)] by rank."""
    return worker.spawn(tp_worker.__file__, refs[0], 4, WORKER_TIMEOUT)


_case = worker.case_results


def _close(res, prefix, want, atol, what):
    for key, val in worker.flat(want).items():
        np.testing.assert_allclose(res[f'{prefix}/{key}'], val, rtol=0,
                                   atol=atol, err_msg=f'{what}: {key}')


def test_ranks_import_neither_jax_nor_the_jax_package(ranks):
    for status, _ in ranks:
        assert status['no_jax'] == []


def test_split_merge_round_trip_and_stage_slices(ranks):
    """(d) `merge_params(*split_params(p))` is `p` bit for bit (names and
    order too); 4 stages, 4 microbatches by default; each stage keeps one
    of the 4 blocks."""
    for res in _case(ranks, 'case_pipe4'):
        assert bool(res['pp/round_trip'])
        assert res['pp/sizes'].tolist() == [4, 4]
        assert res['pp/stage_blocks'].tolist() == [1]


@pytest.mark.parametrize('ref', ['plain', 'mesh'])
def test_pipeline_loss_and_grads_match(refs, ranks, ref):
    """(d) the loss within 1e-5 and the gathered, merged gradients atol
    1e-5 of the unsharded program's and of JAX's pipeline on 4 devices, on
    every rank."""
    want = refs[1]['pp'][ref]
    for res in _case(ranks, 'case_pipe4'):
        assert abs(float(res['pp/loss0']) - want['loss0']) < LOSS_TOL
        _close(res, 'pp/grads0', want['grads0'], GRAD_ATOL, ref)


@pytest.mark.parametrize('ref', ['plain', 'mesh'])
def test_three_adam_steps_match(refs, ranks, ref):
    """(d) three Adam steps (lr 1e-3): the gathered, merged parameters atol
    2e-5 of the unsharded program's and of JAX's pipeline's."""
    want = refs[1]['pp'][ref]['params3']
    for res in _case(ranks, 'case_pipe4'):
        assert np.isfinite(float(res['pp/loss3']))
        _close(res, 'pp/params3', want, STEP_ATOL, ref)


@pytest.mark.parametrize('case,prefix', [('case_pipe4', 'pp'),
                                         ('case_pipe_2x2', 'pin')])
def test_gradient_rule_over_pipe(ranks, case, prefix):
    """(d) on every rank the stem's and head's gradients (the replicated
    ones) equal the other stages' bit for bit: never summed over 'pipe'."""
    for res in _case(ranks, case):
        worst, n_rep, n_trunk = res[f'{prefix}/rule']
        assert worst == 0.0 and n_rep > 0 and n_trunk == 0


@pytest.mark.parametrize('ref', ['plain', 'mesh'])
def test_2d_pin_mesh_matches(refs, ranks, ref):
    """(d) recnet_pin densenet (ln, mse, n_micro 2) on ('pipe', 'data') =
    (2, 2): the loss within 1e-5 and the gradients atol 1e-5 of the
    unsharded program's and of JAX's on the same mesh."""
    want = refs[1]['pin'][ref]
    for res in _case(ranks, 'case_pipe_2x2'):
        assert abs(float(res['pin/loss0']) - want['loss0']) < LOSS_TOL
        _close(res, 'pin/grads0', want['grads0'], GRAD_ATOL, ref)


@pytest.mark.parametrize('stages', [2, 4])
def test_stage_program_in_one_process(refs, ranks, stages):
    """(e) `_pipeline_trunk_local` runs the S stages' ticks in one process:
    the loss and gradients within 1e-6 of the 4 ranks' and within 1e-5 of
    the unsharded program's."""
    want = refs[1]['pp']['plain']
    for res in _case(ranks, 'case_pipe_local'):
        dist = _case(ranks, 'case_pipe4')[0]
        assert abs(float(res[f'local{stages}/loss0'])
                   - want['loss0']) < LOSS_TOL
        assert abs(float(res[f'local{stages}/loss0'])
                   - float(dist['pp/loss0'])) < LOCAL_ATOL
        prefix = f'local{stages}/grads0_named/'
        for key in (k for k in res if k.startswith(prefix)):
            np.testing.assert_allclose(
                res[key], dist['pp/grads0_named/' + key[len(prefix):]],
                rtol=0, atol=LOCAL_ATOL, err_msg=key)


def test_step_inputs_are_validated(ranks):
    """(f) a batch that does not cut into n_micro microbatches and a 4-D
    input raise ValueError (tests/test_parallel.py:667-676)."""
    for res in _case(ranks, 'case_pipe4'):
        micro, rank5 = res['pp/errors'].tolist()
        assert 'n_micro' in micro and '5-D' in rank5


def _pipe_mesh(n):
    """A stand-in for a ('pipe',) DeviceMesh of n ranks."""
    return types.SimpleNamespace(mesh_dim_names=('pipe',), size=lambda i: n)


def test_pipeline_refusals():
    """(f) the spatial backbones (not homogeneous), aux inputs, n_blocks
    that do not divide, batch norm and fewer than 2 stages raise the JAX
    package's ValueErrors (tests/test_parallel.py:642-665)."""
    spatial = tds.net_postupsampling('resnet', 'spc', scale=2, n_channels=1,
                                     n_aux_channels=0, lr_size=(8, 8),
                                     n_filters=4, n_blocks=4)
    rec = tds.models.recnet_postupsampling
    for model, n, match in (
            (spatial, 4, 'homogeneous'),
            (rec(**dict(PP, n_aux_channels=2)), 4, 'aux'),
            (rec(**dict(PP, n_blocks=6)), 4, 'divisible'),
            (rec(**dict(PP, normalization='bn')), 4,
             'batch norm|batch-norm'),
            (rec(**PP), 1, '>= 2')):
        with pytest.raises(ValueError, match=match):
            tpar.make_pipeline_step(model, _pipe_mesh(n))
