"""One rank of `tests/test_torch_distributed_spatial.py`: the port's spatial
parallelism over a gloo group on the CPU, without JAX.

    python tests/_torch_dp_spatial_worker.py RANK WORLD PORT REFS OUT

At world 2 it runs the ('space',) and ('data', 'space') = (1, 2) cases, at
world 4 the (2, 2) ones; `_torch_dp_worker.run_cases` opens the group,
runs them in order on every rank and writes the results.
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
from dl4ds_tpu_torch.models import build_model  # noqa: E402
from dl4ds_tpu_torch.ops import fused_ops as fo  # noqa: E402

flat, nest = base.flat, base.nest


def _pick(refs, prefix):
    """The references under `prefix/`, the prefix stripped."""
    return {k[len(prefix) + 1:]: refs[k] for k in refs.files
            if k.startswith(prefix + '/')}


def _tree(pick, kind):
    return nest({k[len(kind) + 1:]: v for k, v in pick.items()
                 if k.startswith(kind + '/')})


def _mean_over(value, group):
    t = torch.tensor(float(value), dtype=torch.float64)
    torch.distributed.all_reduce(t, group=group)
    return float(t) / torch.distributed.get_world_size(group)


# (name, model keywords): every band rule, each held to the whole grid's
# forward and gradients in float64
RULE_MODELS = [
    ('resnet_spc_attention_bn', dict(backbone='resnet', upsampling='spc',
                                     attention=True, normalization='bn')),
    ('convnet_rc', dict(backbone='convnet', upsampling='rc')),
    ('resnet_dc', dict(backbone='resnet', upsampling='dc')),
    ('unet_pin', dict(backbone='unet', upsampling='pin')),
    ('recresnet_spc', dict(backbone='resnet', upsampling='spc',
                           time_window=2, normalization='bn')),
    ('convnext_localized', dict(backbone='convnext', upsampling='spc',
                                localcon_layer=True)),
    ('densenet_dropout', dict(backbone='densenet', upsampling='spc',
                              dropout_rate=0.3, dropout_variant='vanilla')),
    ('resnet_spatialdrop', dict(backbone='resnet', upsampling='spc',
                                dropout_rate=0.3,
                                dropout_variant='spatial')),
]


def case_rules(rank, world, refs, out, res):
    """Each band rule in float64: the bands' forward, joined, against the
    whole grid's, and the band ranks' parameter gradients of the loss
    seeded on band 0, summed, against the whole grid's gradients; the
    dropout models draw from generators seeded alike."""
    mesh = distributed.spatial_mesh()
    group = mesh.get_group('space')
    for name, kw in RULE_MODELS:
        pin = kw['upsampling'] == 'pin'
        tw = kw.get('time_window')
        h = 16 if pin else 8
        lr_hw = (h // 2, 6) if pin else (h, 12)
        model = build_model(scale=2, n_channels=1, n_aux_channels=0,
                            lr_size=lr_hw, hr_size=(2 * lr_hw[0],
                                                    2 * lr_hw[1]),
                            n_filters=4, n_blocks=2, **kw)
        net = model.init(0, device='cpu').double().train()
        rng = np.random.default_rng(0)
        shape = ((2, tw, h, 12, 1) if tw else (2, h, 12, 1)) if not pin \
            else (2, h, 12, 1)
        x = torch.from_numpy(rng.standard_normal(shape))
        params = list(net.parameters())
        with tds.models.blocks.use_dropout_generator(
                net, torch.Generator().manual_seed(5)):
            full = net(x, None)
            want = torch.autograd.grad(full.abs().mean(), params)
        with tds.models.blocks.use_dropout_generator(
                net, torch.Generator().manual_seed(5)):
            with distributed.space_group(group):
                band = net(distributed.band_rows(x, group), None)
            joined = distributed.gather_rows(band, group)
            seed = torch.tensor(float(rank == 0), dtype=torch.float64)
            got = torch.autograd.grad(joined.abs().mean(), params, seed)
        got = [g.clone() for g in got]
        for g in got:
            torch.distributed.all_reduce(g, group=group)
        res[f'rules/{name}/fwd'] = np.array(
            float((joined - full).abs().max() / full.abs().max()))
        res[f'rules/{name}/grad'] = np.array(max(
            float((a - b).abs().max() / max(b.abs().max(), 1e-300))
            for a, b in zip(got, want)))


def case_k1_band(rank, world, refs, out, res):
    """K1's band mode through its autograd function over the ranks' bands
    (the sums and dm all-reduced), f32 and mixed: y and dx joined, the
    weight gradients summed."""
    group = distributed.spatial_mesh().get_group('space')
    pick = _pick(refs, 'k1')
    for mode in ('f32', 'mixed'):
        x = torch.from_numpy(pick['x'])
        if mode == 'mixed':
            x = x.to(torch.bfloat16)
        xb = distributed.band_rows(x, group).contiguous().requires_grad_()
        ws = [torch.from_numpy(pick[f'w{i}']).requires_grad_()
              for i in range(4)]
        y = fo.fused_channel_attention_band(
            xb, *ws, group, torch.float32 if mode == 'mixed' else None)
        dy = distributed.band_rows(torch.from_numpy(pick['dy']), group)
        y.backward(dy.to(y.dtype))
        res[f'k1/{mode}/y'] = distributed.gather_rows(
            y.detach().float(), group).numpy()
        res[f'k1/{mode}/dx'] = distributed.gather_rows(
            xb.grad.float(), group).numpy()
        for i, w in enumerate(ws):
            g = w.grad.clone()
            torch.distributed.all_reduce(g, group=group)
            res[f'k1/{mode}/dw{i}'] = g.numpy()


def case_predict(rank, world, refs, out, res):
    """`predict(spatial_mesh=)` over the 2 ranks with and without
    attention, the JAX weights loaded."""
    mesh = distributed.spatial_mesh()
    for name in json.loads(str(refs['predict/names'])):
        pick = _pick(refs, f'predict/{name}')
        kw = json.loads(str(pick['config']))
        model = tds.net_postupsampling(**kw)
        net = tds.load_jax_params(model.init(0, device='cpu'),
                                  _tree(pick, 'params'))
        res[f'predict/{name}'] = tds.predict(
            (model, net), refs['predict/x'], scale=kw['scale'],
            array_in_hr=False, device='cpu', spatial_mesh=mesh,
            halo=int(refs['predict/halo']))


def _trainer(refs, name, mesh, **extra):
    cfg = dict(json.loads(str(refs[f'{name}/config'])), **extra)
    data = refs['hr']
    return tds.SupervisedTrainer(
        data_train=data, data_val=data[:6], data_test=data[:6],
        device='cpu', learning_rate=(1e-3, 1e-4), mesh=mesh, **cfg)


def _steps(refs, name, mesh):
    """Three `train_step`s of the JAX reference configuration `name` on
    this rank's data row of its global batches (the trainer keeps its
    band); the losses averaged over the data rows."""
    tr = _trainer(refs, name, mesh)
    tr.setup_datagen()
    tr.setup_model()
    pick = _pick(refs, name)
    tds.load_jax_params(tr.net, _tree(pick, 'params0'),
                        _tree(pick, 'stats0') or None)
    tr.setup_optimizer()
    tr.net.train()
    b = tr.batch_size
    losses = []
    for i in range(int(refs[f'{name}/n_batches'])):
        batch = {}
        for key in ('lr', 'hr', 'aux'):
            arr = pick.get(f'batch{i}/{key}')
            batch[key] = (None if arr is None else torch.from_numpy(
                arr[tr.rank * b:(tr.rank + 1) * b].copy()))
        loss = tr.train_step(batch).item()
        losses.append(loss if tr.data_group is None
                      else _mean_over(loss, tr.data_group))
    out = {'losses': np.array(losses)}
    for k, v in flat(tds.weights.export_jax_params(tr.net)).items():
        out[f'params3/{k}'] = v
    if any(k.startswith('stats0/') for k in pick):
        v = tds.weights.export_jax_variables(tr.net)['batch_stats']
        for k, a in flat(v).items():
            out[f'stats3/{k}'] = a
    return out


def case_steps(rank, world, refs, out, res):
    """Every configuration on the (data 1, space 2) mesh."""
    mesh = distributed.spatial_mesh(2, 1)
    for name in json.loads(str(refs['names'])):
        for k, v in _steps(refs, name, mesh).items():
            res[f'{name}/{k}'] = v


RUNS = {'flagship': {}, 'bn': {}, 'recurrent': {}, 'unet_pin': {},
        'flagship_streamed': dict(data_in_hbm=False)}


def case_runs(rank, world, refs, out, res):
    """run() of each configuration (and the flagship streamed from the
    host) on the ('space',) mesh and without a mesh, from one seed."""
    mesh = distributed.spatial_mesh()
    short = dict(epochs=2, steps_per_epoch=2, validation_steps=1,
                 test_steps=1, seed=7)
    for name, extra in RUNS.items():
        base_name = name.replace('_streamed', '')
        for tag, m in (('space', mesh), ('plain', None)):
            tr = _trainer(refs, base_name, m, **extra, **short).run()
            res[f'run/{name}/{tag}'] = np.array(
                tr.fithist['loss'] + tr.fithist['val_loss']
                + [tr.test_loss])
            if tag == 'space':
                res[f'run/{name}/first_worker'] = np.array(
                    tr.running_on_first_worker)
            for k, v in tr.train_net.state_dict().items():
                res[f'run/{name}/{tag}/{k}'] = v.numpy()


def case_dropout(rank, world, refs, out, res):
    """A 'vanilla' dropout model: a training step under the ('space',) mesh
    and the same step without it, from one seed: the loss and the dropout
    generator's state after it."""
    cfg = dict(json.loads(str(refs['flagship/config'])), dropout_rate=0.3,
               dropout_variant='vanilla', attention=False, loss='mae')
    data = refs['hr']
    pick = _pick(refs, 'flagship')
    batch = {k: None if f'batch0/{k}' not in pick else
             torch.from_numpy(pick[f'batch0/{k}']) for k in ('lr', 'hr',
                                                             'aux')}
    for tag, mesh in (('space', distributed.spatial_mesh()), ('plain', None)):
        tr = tds.SupervisedTrainer(
            data_train=data, data_val=data[:6], data_test=data[:6],
            device='cpu', mesh=mesh, seed=11, **cfg)
        tr.setup_datagen()
        tr.setup_model()
        tr.setup_optimizer()
        tr.net.train()
        res[f'dropout/{tag}/loss'] = np.array(tr.train_step(batch).item())
        res[f'dropout/{tag}/state'] = tr.dropout_generator.get_state().numpy()


def case_errors(rank, world, refs, out, res):
    """The band sizes that do not cut, the spatial predict's checks and the
    app's `--mesh_shape data=1,space=2`."""
    mesh = distributed.spatial_mesh()
    raised = []
    cfg = json.loads(str(refs['flagship/config']))
    data = refs['hr']
    try:   # LR rows 3 do not cut into 2 bands
        tds.SupervisedTrainer(
            data_train=data, data_val=data[:6], data_test=data[:6],
            device='cpu', mesh=mesh, **dict(cfg, patch_size=12)).run()
    except ValueError as e:
        raised.append('rows do not cut' if 'equal bands' in str(e) else
                      str(e))
    model = build_model('resnet', 'spc', scale=2, n_channels=1,
                        n_aux_channels=0, lr_size=(8, 8), hr_size=(16, 16),
                        n_filters=2, n_blocks=1)
    net = model.init(0, device='cpu')
    for x, halo in ((np.zeros((1, 9, 8, 1), np.float32), 2),
                    (np.zeros((1, 8, 8, 1), np.float32), 3)):
        try:
            parallel.predict_spatial_sharded(model, net, x, mesh, halo=halo)
        except ValueError as e:
            raised.append('divisible' if 'divisible' in str(e) else
                          'band height' if 'band height' in str(e)
                          else str(e))
    res['errors'] = np.array(raised)
    parsed = app._parse_mesh_shape('data=1,space=2', 'cpu')
    res['app_mesh'] = np.array([str(parsed.mesh_dim_names),
                                str(tuple(parsed.mesh.shape))])


def case_step_2x2(rank, world, refs, out, res):
    """`make_spatial_sharded_step` on the (data 2, space 2) mesh: the loss
    and gradients against JAX's, then a few steps."""
    pick = _pick(refs, 'step')
    kw = json.loads(str(pick['config']))
    model = tds.net_postupsampling(**kw)
    net = tds.load_jax_params(model.init(0, device='cpu'),
                              _tree(pick, 'params'))
    sss = parallel.make_spatial_sharded_step(
        model, distributed.spatial_mesh(2, 2), halo=int(pick['halo']))
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    loss, grads = sss.loss_and_grads(params, pick['x'], pick['y'], 3)
    res['step/loss'] = np.array(float(loss))
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(grads[k])
    for k, v in flat(tds.weights.export_jax_params(net)).items():
        res[f'step/grads/{k}'] = v
    opt = sss.init_opt(params)
    losses = []
    for i in range(4):
        params, opt, value = sss.step(params, opt, pick['x'], pick['y'], i)
        losses.append(float(value))
    res['step/losses'] = np.array(losses)


def case_steps_2x2(rank, world, refs, out, res):
    """The flagship on the (data 2, space 2) mesh."""
    for k, v in _steps(refs, 'flagship2x2',
                       distributed.spatial_mesh(2, 2)).items():
        res[f'flagship2x2/{k}'] = v


def main(argv):
    world = int(argv[2])
    cases = ([case_step_2x2, case_steps_2x2] if world == 4 else
             [case_rules, case_k1_band, case_predict, case_steps, case_runs,
              case_dropout, case_errors])
    base.run_cases(argv, cases)


if __name__ == '__main__':
    main(sys.argv)
