"""One rank of `tests/test_torch_distributed_cgan.py`: the port's
`CGANTrainer(mesh=...)` over a 2-process gloo group on the CPU, without
JAX.

    python tests/_torch_dp_cgan_worker.py RANK WORLD PORT REFS OUT

as `_torch_dp_worker.py` runs (`run_cases`). The discriminator's
Dropout(0.4) draws a fixed mask, `pattern` of the global batch's shape,
of which each rank takes its rows (`pattern_masks`); the test process
feeds the same masks to the JAX step and to the one-process runs, so that
every run compared is free of random draws.
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import dl4ds_tpu_torch as tds  # noqa: E402
from dl4ds_tpu_torch import app, distributed  # noqa: E402
from dl4ds_tpu_torch.models import blocks as tblocks  # noqa: E402
from _torch_dp_worker import (flat, mean_over_ranks, nest,  # noqa: E402
                              run_cases)

SCALE, B = 4, 2            # a rank's batch in the step cases
G_ARGS = dict(n_filters=4, n_blocks=1, attention=True)
D_ARGS = dict(n_filters=4, n_res_blocks=1, attention=True)
LRS = (2e-4, 3e-4)
KEEP = 0.6                 # the discriminator's Dropout(0.4)
# name: the trainer's options of a step case (patch 12 for the 11-tap SSIM)
CONFIGS = {'flagship': dict(loss='dssim_mae', patch_size=12),
           'recurrent': dict(loss='mae', patch_size=8, time_window=3)}
RUN_BATCH = 4              # a rank's batch in the run() cases


def pattern(shape):
    """The fixed keep-mask of a dropout draw of `shape` (batch first):
    about KEEP of the units kept, in a pattern that differs from row to
    row."""
    n = int(np.prod(shape))
    codes = (np.arange(n, dtype=np.int64) * 2654435761) % 1000
    return (codes < 1000 * KEEP).reshape(shape)


@contextlib.contextmanager
def pattern_masks(rank, world):
    """The port's dropout draws replaced by this rank's rows of `pattern`
    of the global batch (world x the local batch)."""
    real = tblocks._dropout_mask

    def feed(shape, keep, generator, dtype, device, kind='bernoulli'):
        assert kind == 'bernoulli' and abs(keep - KEEP) < 1e-6, (kind, keep)
        b = shape[0]
        full = pattern((b * world,) + tuple(shape[1:]))
        return torch.from_numpy(full[rank * b:(rank + 1) * b]).to(device)
    tblocks._dropout_mask = feed
    try:
        yield
    finally:
        tblocks._dropout_mask = real


def trainer(data, **kw):
    """A CGANTrainer on the CPU at the step cases' sizes."""
    args = dict(backbone='resnet', upsampling='spc', data_train=data,
                data_test=data, scale=SCALE, batch_size=B, epochs=1,
                generator_params=dict(G_ARGS),
                discriminator_params=dict(D_ARGS), device='cpu',
                verbose=False, save_loss_history=False, learning_rates=LRS)
    args.update(kw)
    return tds.CGANTrainer(**args)


def run_data():
    t = np.arange(40)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing='ij')
    return np.stack([np.sin(0.3 * yy + 0.1 * k) * np.cos(0.4 * xx - 0.05 * k)
                     for k in t])[..., None].astype('float32')


def run_args(**kw):
    """The run() cases' trainer: 40 grids of 16x16, patches of 8, seed 0."""
    data = run_data()
    return dict(data=data[:32], data_test=data[32:], patch_size=8,
                loss='mae', seed=0, **kw)


def ssim_arrays():
    """(y_true, y_pred) of the DSSIM range check: 2 x B 12x12 grids, the
    second half three times the first's scale, so that the halves' ranges
    differ from the whole's."""
    rng = np.random.default_rng(5)
    yt = rng.standard_normal((2 * B, 12, 12, 1)).astype(np.float32)
    yt[B:] *= 3.0
    yp = (yt + 0.3 * rng.standard_normal(yt.shape)).astype(np.float32)
    return yt, yp


def case_steps(rank, world, refs, out, res):
    """Three fused steps of each configuration on this rank's half of the
    JAX references' global batches, from their weights; the rates; the
    DSSIM loss with and without `batch_group`."""
    mesh = distributed.global_mesh()
    for name in json.loads(str(refs['names'])):
        cfg = json.loads(str(refs[f'{name}/config']))
        tr = trainer(refs['data'], mesh=mesh, **cfg)
        tr.setup_model()
        pick = {k[len(name) + 1:]: refs[k] for k in refs.files
                if k.startswith(f'{name}/')}
        for net, key in ((tr.gen_net, 'g0/'), (tr.disc_net, 'd0/')):
            tds.load_jax_params(net, nest({k[len(key):]: v for k, v in
                                           pick.items()
                                           if k.startswith(key)}))
        tr.setup_optimizer(3)
        tr.train_net.train()
        losses = []
        with pattern_masks(rank, world):
            for i in range(int(pick['n_batches'])):
                batch = {k: torch.from_numpy(
                    pick[f'batch{i}/{k}'][rank * B:(rank + 1) * B].copy())
                    for k in ('lr', 'hr')}
                batch['aux'] = None
                losses.append([mean_over_ranks(v) for v in
                               tr.train_step(batch).tolist()])
        res[f'{name}/losses'] = np.array(losses)
        for net, key in ((tr.gen_net, 'g3'), (tr.disc_net, 'd3')):
            for k, v in flat(tds.weights.export_jax_params(net)).items():
                res[f'{name}/{key}/{k}'] = v
        res[f'{name}/rates'] = np.array(
            [tr._gen_lr, tr._disc_lr] + [lr.item() for _, lr in tr._rates])
    yt, yp = (torch.from_numpy(a[rank * B:(rank + 1) * B].copy())
              for a in ssim_arrays())
    with distributed.batch_group(mesh.get_group('data')):
        inside = tds.losses.dssim_mae(yt, yp).item()
    res['ssim_global'] = np.array(mean_over_ranks(inside))
    res['ssim_local'] = np.array(mean_over_ranks(
        tds.losses.dssim_mae(yt, yp).item()))


def _history(tr):
    return np.array([tr.gentotal, tr.gengan, tr.gen_pxloss, tr.disc])


def case_run(rank, world, refs, out, res):
    """run() at a rank batch of RUN_BATCH, 2 epochs, the discriminator on
    the pattern masks; saving with a checkpoint an epoch; a resume from the
    first worker's final checkpoint on both ranks."""
    mesh = distributed.global_mesh()
    path = os.path.join(out, f'save{rank}') + '/'
    args = run_args(batch_size=RUN_BATCH, epochs=2, mesh=mesh)
    data = args.pop('data')
    with pattern_masks(rank, world):
        tr = trainer(data, save=True, save_path=path, save_loss_history=True,
                     checkpoints_frequency=1, **args).run()
    res['run_losses'] = _history(tr)
    res['run_test_loss'] = np.array(tr.test_loss)
    files = sorted(os.path.relpath(os.path.join(d, f), path)
                   for d, _, fs in os.walk(path) for f in fs)
    res['run_files'] = np.array(files or [''])
    final = os.path.join(out, 'save0', 'checkpoints', 'final')
    again = trainer(data, resume_from_checkpoint=final, **args)
    again.setup_datagen()
    again.setup_model()
    again.setup_optimizer(again._steps())
    again._restore_gan_checkpoint(final)
    res['resume_restored'] = np.array(all(
        torch.equal(a, b) for a, b in zip(
            list(again.train_net.state_dict().values())
            + again._opt_tensors(),
            list(tr.train_net.state_dict().values()) + tr._opt_tensors())))
    with pattern_masks(rank, world):
        resumed = trainer(data, resume_from_checkpoint=final,
                          **dict(args, epochs=1)).run()
    res['resume_losses'] = _history(resumed)
    res['resume_params'] = np.concatenate([
        v.reshape(-1).numpy() for v in resumed.train_net.state_dict()
        .values()])


def case_app(rank, world, refs, out, res):
    """`--trainer=CGANTrainer --mesh_shape=data=2` through `app.main`, the
    group already open: the trainer it returns trains over both ranks (the
    app's generator dropout 0.2, its masks drawn a rank)."""
    module = os.path.join(out, f'data{rank}.py')
    with open(module, 'w') as fh:
        fh.write('import numpy as np\n'
                 'rng = np.random.default_rng(0)\n'
                 "_all = rng.standard_normal((24, 16, 16, 1)).astype("
                 "'float32')\n"
                 'data_train = _all[:16]\n'
                 'data_val = data_test = _all[16:]\n'
                 'data_train_lr = data_val_lr = data_test_lr = None\n'
                 'predictors_train = predictors_val = predictors_test = '
                 'None\n'
                 'static_vars = None\n'
                 'inference_data = _all[16:]\n'
                 'inference_scaler = inference_predictors = None\n'
                 'gt_holdout_dataset = _all[16:]\n'
                 'gt_mask = np.ones((16, 16))\n')
    cfg = os.path.join(out, f'params{rank}.cfg')
    with open(cfg, 'w') as fh:
        fh.write('\n'.join([
            '--device=CPU', '--trainer=CGANTrainer', f'--mesh_shape=data={world}',
            f'--data_module={module}', '--backbone=resnet',
            '--upsampling=spc', '--scale=4', '--patch_size=8',
            '--batch_size=2', '--epochs=2', '--n_filters=4', '--n_blocks=1',
            '--n_disc_filters=4', '--n_disc_blocks=1', '--nosave',
            '--notest', '--nometrics',
            f'--save_path={os.path.join(out, f"app{rank}")}/']) + '\n')
    tr = app.main(['prog', f'--flagfile={cfg}'])
    res['app_mesh'] = np.array([tr.n_data_shards, tr.global_batch_size,
                                tr.rank])
    res['app_losses'] = _history(tr)


CASES = [case_steps, case_run, case_app]

if __name__ == '__main__':
    run_cases(sys.argv, CASES)
