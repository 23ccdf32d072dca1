"""One rank of `tests/test_torch_tensor_parallel.py` and
`tests/test_torch_pipeline.py`: the port's tensor and pipeline parallelism
over a gloo group on the CPU, without JAX.

    python tests/_torch_dp_tp_worker.py RANK WORLD PORT REFS OUT

The references' `mode` picks the cases: 'tensor2' the ('model', 2) mesh
(the standalone step, an aux model, run() against the run without a mesh,
a checkpoint across the two, the refusals), 'tensor4' the (data 2, model
2) mesh (the standalone step, the trainer's steps against the JAX
trainer's, run() against one process at the global batch), 'pipe4' the
('pipe', 4) and ('pipe', 'data') = (2, 2) meshes and the one-process
stage program. `_torch_dp_worker.run_cases` opens the group, runs the
cases in order on every rank and writes the results.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_dp_worker as base  # noqa: E402

import dl4ds_tpu_torch as tds  # noqa: E402
from dl4ds_tpu_torch import app, distributed, parallel  # noqa: E402

flat, nest = base.flat, base.nest


def _pick(refs, prefix):
    """The references under `prefix/`, the prefix stripped."""
    return {k[len(prefix) + 1:]: refs[k] for k in refs.files
            if k.startswith(prefix + '/')}


def _tree(pick, kind):
    return nest({k[len(kind) + 1:]: v for k, v in pick.items()
                 if k.startswith(kind + '/')})


def adam_1e3(params):
    """optax.adam(1e-3): lr 1e-3, betas (0.9, 0.999), eps 1e-8."""
    return torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def _named(model, tree):
    """The parameters of `model` by name, the Flax tree `tree` loaded."""
    return tds.weights.load_jax_named(model, tree, device='cpu')


def _export(model, named, prefix, res):
    """`named` (whole tensors by name) as the Flax tree, into `res` under
    `prefix`."""
    for k, v in flat(tds.weights.export_jax_named(model, named)).items():
        res[f'{prefix}/{k}'] = v


def _rule(grads, spec, group):
    """The gradient rule on this rank: the largest difference of a
    replicated parameter's gradient across the ranks of `group` (0 when
    they are equal bit for bit), and the numbers of replicated and sharded
    gradients."""
    worst, counts = 0.0, [0, 0]
    for k, g in grads.items():
        counts[spec[k] is not None] += 1
        if spec[k] is None:
            parts = distributed._ranks_of(g.contiguous(), group)
            worst = max(worst, float((parts - parts[0]).abs().max()))
    return np.array([worst] + counts)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

def case_tensor_step(rank, world, refs, out, res):
    """`make_tensor_sharded_step` on ('model', 2) or (data 2, model 2): the
    first loss and gradients (gathered) and the gradient rule, then three
    Adam steps (the last loss, the gathered parameters)."""
    pick = _pick(refs, 'tp')
    model = tds.net_postupsampling(**json.loads(str(pick['config'])))
    full = _named(model, _tree(pick, 'params0'))
    mesh = (distributed.tensor_mesh(2) if world == 2
            else distributed.tensor_mesh(2, 2))
    ts = parallel.make_tensor_sharded_step(model, mesh, tx=adam_1e3)
    spec = ts.param_shardings
    p = parallel.place_params(full, spec, mesh)
    res['tp/shards'] = np.array(all(
        p[k].shape[d] * 2 == full[k].shape[d] for k, d in spec.items()
        if d is not None))
    x, y = pick['x'], pick['y']
    loss, grads = ts.loss_and_grads(p, x, y, 0)
    res['tp/loss0'] = np.array(float(loss))
    res['tp/rule'] = _rule(grads, spec, mesh.get_group('model'))
    _export(model, parallel.gather_params(grads, spec, mesh), 'tp/grads0',
            res)
    opt = ts.init_opt(p)
    for i in range(3):
        p, opt, loss = ts.step(p, opt, x, y, i)
    res['tp/loss3'] = np.array(float(loss))
    res['tp/moments'] = np.array(all(
        opt.state[t]['exp_avg'].shape == t.shape for t in p.values()))
    _export(model, parallel.gather_params(p, spec, mesh), 'tp/params3', res)


def case_tensor_aux(rank, world, refs, out, res):
    """An aux model on ('model', 2): the missing aux refused, the loss and
    gathered gradients with it, one step."""
    pick = _pick(refs, 'aux')
    model = tds.net_postupsampling(**json.loads(str(pick['config'])))
    mesh = distributed.tensor_mesh(2)
    ts = parallel.make_tensor_sharded_step(model, mesh, tx=adam_1e3)
    p = parallel.place_params(_named(model, _tree(pick, 'params0')),
                              ts.param_shardings, mesh)
    try:
        ts.loss_and_grads(p, pick['x'], pick['y'], 0)
        res['aux/missing'] = np.array('')
    except ValueError as e:
        res['aux/missing'] = np.array(str(e))
    loss, grads = ts.loss_and_grads(p, pick['x'], pick['y'], 0,
                                    aux=pick['aux'])
    res['aux/loss'] = np.array(float(loss))
    _export(model, parallel.gather_params(grads, ts.param_shardings, mesh),
            'aux/grads', res)
    opt = ts.init_opt(p)
    _, _, loss = ts.step(p, opt, pick['x'], pick['y'], 0, aux=pick['aux'])
    res['aux/step_loss'] = np.array(float(loss))


def _trainer(refs, name, mesh, **extra):
    cfg = dict(json.loads(str(refs[f'{name}/config'])), **extra)
    data = refs['hr']
    return tds.SupervisedTrainer(
        data_train=data, data_val=data[:6], data_test=data[:6],
        device='cpu', mesh=mesh, **cfg)


def case_trainer_steps(rank, world, refs, out, res):
    """Three `train_step`s of each JAX reference configuration on (data 2,
    model 2), each data row on its half of the global batches: the losses
    averaged over the data rows, the gathered parameters (and EMA copy),
    and the shards that the rank holds."""
    mesh = distributed.tensor_mesh(2, 2)
    for name in json.loads(str(refs['names'])):
        tr = _trainer(refs, name, mesh, learning_rate=(1e-3, 1e-4))
        tr.setup_datagen()
        tr.setup_model()
        pick = _pick(refs, name)
        tds.load_jax_params(tr.net, _tree(pick, 'params0'))
        whole = {k: tuple(v.shape) for k, v in tr.net.named_parameters()}
        tr.setup_optimizer()
        tr.net.train()
        local = dict(tr.train_net.named_parameters())
        shards = [k for k, d in tr._tp_spec.items() if d is not None]
        held = [local[k].shape[tr._tp_spec[k]] * 2 ==
                whole[k][tr._tp_spec[k]] for k in shards]
        held += [tr.optimizer.state[local[k]]['exp_avg'].shape ==
                 local[k].shape for k in shards]
        if tr.ema_net is not None:
            ema = dict(tr.ema_net.named_parameters())
            held += [ema[k].shape == local[k].shape for k in shards]
        if tr._acc is not None:
            held += [a.shape == p.shape for a, p in zip(tr._acc,
                                                        tr._params)]
        res[f'{name}/shards'] = np.array([all(held), len(shards),
                                          tr.global_batch_size])
        b = tr.batch_size
        losses = []
        for i in range(int(refs[f'{name}/n_batches'])):
            batch = {}
            for key in ('lr', 'hr', 'aux'):
                arr = pick.get(f'batch{i}/{key}')
                batch[key] = (None if arr is None else torch.from_numpy(
                    arr[tr.rank * b:(tr.rank + 1) * b].copy()))
            loss = torch.tensor(tr.train_step(batch).item(),
                                dtype=torch.float64)
            torch.distributed.all_reduce(loss, group=tr.data_group)
            losses.append(float(loss) / tr.n_data_shards)
        res[f'{name}/losses'] = np.array(losses)
        for tag, net in (('params3', tr.train_net), ('ema3', tr.ema_net)):
            if net is None:
                continue
            whole_net = tr._whole_net(net)
            for k, v in flat(tds.weights.export_jax_params(whole_net)
                             ).items():
                res[f'{name}/{tag}/{k}'] = v


RUN = dict(epochs=2, steps_per_epoch=2, validation_steps=1, test_steps=1,
           seed=7)


def _losses(tr):
    return np.array(tr.fithist['loss'] + tr.fithist['val_loss']
                    + [tr.test_loss])


def case_runs(rank, world, refs, out, res):
    """run() of the flagship (EMA 0.9, accumulation 2, warmup_cosine) on the
    ('model', 2) mesh and without a mesh from one seed, in-HBM, streamed
    from the host and with 'vanilla' dropout (the data row's masks); then a checkpoint written under the mesh
    resumed with it and without it, and one written without it resumed
    with it. The gathered weights of `net` after each run."""
    mesh = distributed.tensor_mesh(2)
    name = 'flagship'
    for tag, extra in (('hbm', {}), ('stream', dict(data_in_hbm=False)),
                       ('dropout', dict(dropout_rate=0.3,
                                        dropout_variant='vanilla'))):
        for kind, m in (('model', mesh), ('plain', None)):
            tr = _trainer(refs, name, m, **extra, **RUN).run()
            res[f'run/{tag}/{kind}'] = _losses(tr)
            if tag == 'hbm':
                res[f'run/{kind}/first_worker'] = np.array(
                    tr.running_on_first_worker)
                for k, v in tr.net.state_dict().items():
                    res[f'run/{kind}/net/{k}'] = v.numpy()
    # checkpoints: epoch 1 of a 2-epoch run, resumed to its end
    saved = {}
    for kind, m in (('model', mesh), ('plain', None)):
        # the mesh's first worker writes for every rank; each plain run
        # writes its own
        path = os.path.join(out, f'ckpt_{kind}_{rank * (m is None)}') + '/'
        _trainer(refs, name, m, save=True, save_path=path,
                 checkpoints_frequency=1, **RUN).run()
        saved[kind] = os.path.join(path, 'checkpoints', 'epoch-1')
    for src, kind, m in (('model', 'model', mesh), ('model', 'plain', None),
                         ('plain', 'model', mesh)):
        tr = _trainer(refs, name, m, resume_from_checkpoint=saved[src],
                      **RUN).run()
        res[f'resume/{src}_to_{kind}'] = _losses(tr)


def case_global_batch(rank, world, refs, out, res):
    """run() on (data 2, model 2) against one process at the global batch
    (twice a rank's) and twice the rate, from one seed: the same plan."""
    cfg = json.loads(str(refs['flagship/config']))
    for kind, m, extra in (
            ('mesh', distributed.tensor_mesh(2, 2),
             dict(learning_rate=(1e-3, 1e-4))),
            ('one', None, dict(batch_size=2 * cfg['batch_size'],
                               learning_rate=(2e-3, 2e-4)))):
        tr = _trainer(refs, 'flagship', m, **RUN, **extra).run()
        res[f'global/{kind}'] = _losses(tr)


def case_refusals(rank, world, refs, out, res):
    """bn under 'model' (the trainer at run(), the step at its making, the
    norm itself within a model group), the CGAN trainer on a 'model' mesh,
    and the app's `--mesh_shape`."""
    mesh = distributed.tensor_mesh(2)
    raised = []
    data = refs['hr']
    cfg = dict(json.loads(str(refs['flagship/config'])), normalization='bn')
    tr = _trainer(refs, 'flagship', mesh, normalization='bn')
    for fn in (tr.run,
               lambda: parallel.make_tensor_sharded_step(
                   tds.net_postupsampling(
                       'resnet', 'spc', scale=2, n_channels=1,
                       n_aux_channels=0, lr_size=(8, 8), n_filters=4,
                       n_blocks=1, normalization='bn'), mesh)):
        try:
            fn()
            raised.append('')
        except ValueError as e:
            raised.append(str(e))
    norm = tds.models.blocks.BatchNorm(4)
    try:
        with distributed.model_group(mesh.get_group('model')):
            norm(torch.zeros(2, 3, 3, 4))
        raised.append('')
    except ValueError as e:
        raised.append(str(e))
    try:
        tds.CGANTrainer(cfg['backbone'], cfg['upsampling'], data, data,
                        scale=cfg['scale'], patch_size=cfg['patch_size'],
                        device='cpu', mesh=mesh)
        raised.append('')
    except NotImplementedError as e:
        raised.append(str(e))
    res['refusals'] = np.array(raised)
    parsed = app._parse_mesh_shape('data=1,model=2', 'cpu')
    res['app_mesh'] = np.array([str(parsed.mesh_dim_names),
                                str(tuple(parsed.mesh.shape))])
    try:
        app._parse_mesh_shape('data=2,model=2', 'cpu')
        res['app_count'] = np.array('')
    except ValueError as e:
        res['app_count'] = np.array(str(e))


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------

def _pipe_model(pick):
    """The model of `pick`'s configuration: {'factory': the name of the
    model function, 'kwargs': its keywords}, as the JAX side built it."""
    cfg = json.loads(str(pick['config']))
    return getattr(tds.models, cfg['factory'])(**cfg['kwargs'])


def case_pipe4(rank, world, refs, out, res):
    """`make_pipeline_step` on ('pipe', 4): the split/merge round trip, the
    loss and the gathered, merged gradients with the gradient rule, three
    Adam steps; then the validation of the step's inputs."""
    pick = _pick(refs, 'pp')
    model = _pipe_model(pick)
    full = _named(model, _tree(pick, 'params0'))
    mesh = distributed.pipeline_mesh(4)
    ps = parallel.make_pipeline_step(model, mesh, tx=adam_1e3, loss='mae')
    res['pp/sizes'] = np.array([ps.n_stages, ps.n_micro])
    again = ps.merge_params(*ps.split_params(full))
    res['pp/round_trip'] = np.array(list(again) == list(full) and all(
        torch.equal(again[k], full[k]) for k in full))
    parts = parallel.place_params(ps.split_params(full), ps.param_shardings,
                                  mesh)
    res['pp/stage_blocks'] = np.array(sorted(
        {int(v.shape[0]) for v in parts[1].values()}))
    x, y = pick['x'], pick['y']
    loss, grads = ps.loss_and_grads(parts, x, y, 0)
    res['pp/loss0'] = np.array(float(loss))
    res['pp/rule'] = _rule(grads[0], ps.param_shardings[0],
                           mesh.get_group('pipe'))
    merged = ps.merge_params(*parallel.gather_params(
        grads, ps.param_shardings, mesh))
    _export(model, merged, 'pp/grads0', res)
    for k, v in merged.items():
        res[f'pp/grads0_named/{k}'] = v.numpy()
    opt = ps.init_opt(parts)
    for i in range(3):
        parts, opt, loss = ps.step(parts, opt, x, y, i)
    res['pp/loss3'] = np.array(float(loss))
    _export(model, ps.merge_params(*parallel.gather_params(
        parts, ps.param_shardings, mesh)), 'pp/params3', res)
    raised = []
    for xs, ys in ((np.zeros((6, 3, 8, 8, 1)), np.zeros((6, 3, 16, 16, 1))),
                   (np.zeros((4, 8, 8, 1)), np.zeros((4, 16, 16, 1)))):
        try:
            ps.loss_and_grads(parts, xs, ys, 0)
            raised.append('')
        except ValueError as e:
            raised.append(str(e))
    res['pp/errors'] = np.array(raised)


def case_pipe_local(rank, world, refs, out, res):
    """The stage program in one process (`_pipeline_trunk_local`) at S = 2
    and 4: the loss and the merged gradients."""
    pick = _pick(refs, 'pp')
    model = _pipe_model(pick)
    full = _named(model, _tree(pick, 'params0'))
    n_blocks = model.build()._RecBackbone_0.n_blocks
    order = list(full)
    for s in (2, 4):
        loss, grads = parallel._pipeline_trunk_local(
            model, parallel._split_trunk(full, n_blocks), pick['x'],
            pick['y'], 0, n_stages=s, loss='mae')
        res[f'local{s}/loss0'] = np.array(float(loss))
        merged = parallel._merge_trunk(*grads, n_blocks, order)
        for k, v in merged.items():
            res[f'local{s}/grads0_named/{k}'] = v.numpy()


def case_pipe_2x2(rank, world, refs, out, res):
    """A recnet_pin densenet (ln, mse, n_micro 2) on a ('pipe', 'data') =
    (2, 2) mesh: the loss, the gathered merged gradients and the gradient
    rule over 'pipe'."""
    from torch.distributed.device_mesh import init_device_mesh
    pick = _pick(refs, 'pin')
    model = _pipe_model(pick)
    full = _named(model, _tree(pick, 'params0'))
    mesh = init_device_mesh('cpu', (2, 2), mesh_dim_names=('pipe', 'data'))
    ps = parallel.make_pipeline_step(model, mesh, tx=adam_1e3, loss='mse',
                                     n_micro=2)
    parts = parallel.place_params(ps.split_params(full), ps.param_shardings,
                                  mesh, axis='pipe')
    loss, grads = ps.loss_and_grads(parts, pick['x'], pick['y'], 0)
    res['pin/loss0'] = np.array(float(loss))
    res['pin/rule'] = _rule(grads[0], ps.param_shardings[0],
                            mesh.get_group('pipe'))
    _export(model, ps.merge_params(*parallel.gather_params(
        grads, ps.param_shardings, mesh, axis='pipe')), 'pin/grads0', res)


def main(argv):
    mode = str(np.load(argv[4])['mode'])
    cases = {'tensor2': [case_tensor_step, case_tensor_aux, case_runs,
                         case_refusals],
             'tensor4': [case_tensor_step, case_trainer_steps,
                         case_global_batch],
             'pipe4': [case_pipe4, case_pipe_local, case_pipe_2x2]}[mode]
    base.run_cases(argv, cases)


if __name__ == '__main__':
    main(sys.argv)
