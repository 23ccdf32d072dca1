"""One rank of `tests/test_torch_distributed_serving.py`: the port's
`predict(mesh=)`, `predict_tiled(mesh=)` and the ensembles over an
ensemble mesh (the flagship's, and a spatio-temporal model's on an
('ensemble',) mesh), over a 2-process gloo group on the CPU, without JAX; or,
over 4 processes, of `tests/test_torch_distributed_ensemble_mesh.py`: the
ensembles on a 2 x 2 ('ensemble', 'data') mesh.

    python tests/_torch_dp_serving_worker.py RANK WORLD PORT REFS OUT

as `_torch_dp_worker.py` runs (`run_cases`). The models' weights are drawn
here from the seeds the test process draws them from, so that both hold
the same networks.
"""

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import dl4ds_tpu_torch as tds  # noqa: E402
from dl4ds_tpu_torch import distributed, parallel  # noqa: E402
from _torch_dp_worker import flat, run_cases  # noqa: E402

SCALE, LR, T = 4, 4, 3
COUNTS = (3, 10)           # samples served, as tests/test_inference_metrics.py
BATCH = 2                  # a rank's batch
# the flagship at small width (attention in the blocks and the head) and
# the recurrent model
MODELS = {
    'flagship': dict(factory='net_postupsampling', backbone_block='resnet',
                     upsampling='spc', scale=SCALE, n_channels=1,
                     n_aux_channels=0, lr_size=(LR, LR), n_filters=4,
                     n_blocks=1, attention=True),
    'recurrent': dict(factory='recnet_postupsampling', backbone_block='resnet',
                      upsampling='spc', scale=SCALE, n_channels=1,
                      n_aux_channels=0, lr_size=(LR, LR), time_window=T,
                      n_filters=4, n_blocks=1)}
TILE, HALO, TILE_GRID = 4, 2, (10, 12)
# ensembles: tests/test_torch_ensemble.py's model, gated
ENS = dict(backbone_block='resnet', upsampling='spc', scale=2, n_channels=1,
           n_aux_channels=0, lr_size=(8, 8), n_filters=4, n_blocks=1,
           attention=True)
M, ENS_B, ENS_STEPS = 4, 8, 3
# mesh name: ((n_ensemble, n_data) of `ensemble_mesh`, the step's loss)
MESHES = {'ensemble': ((2, None), 'mae'),
          'ensemble_data': ((1, 2), 'dssim_mae')}
# the 4-rank run's mesh, both dims above 1
MESHES_2D = {'ensemble_2x2': ((2, 2), 'dssim_mae')}
# a spatio-temporal model's ensemble (tests/test_torch_ensemble_recurrent.py's
# model): the ConvLSTM layers' member mode on each rank's members
REC_ENS = dict(ENS, attention=False, time_window=T)
REC_MESHES = {'ensemble_rec': ((2, None), 'mae')}


def model(pkg, name):
    kw = dict(MODELS[name])
    return getattr(pkg, kw.pop('factory'))(**kw)


def pair(name):
    m = model(tds, name)
    return m, m.init(0, device='cpu')


def hr_grids(name, n):
    """The HR grids that give `n` samples: n grids, or n + T - 1 frames."""
    extra = T - 1 if name == 'recurrent' else 0
    return np.random.default_rng(40 + n).standard_normal(
        (n + extra, LR * SCALE, LR * SCALE)).astype(np.float32)


def predict_kw(name):
    return dict(scale=SCALE, batch_size=BATCH, array_in_hr=True,
                time_window=T if name == 'recurrent' else None)


def tile_input():
    return np.random.default_rng(7).standard_normal(
        (2,) + TILE_GRID + (1,)).astype(np.float32)


def ens_data():
    """x, y of the ensemble steps: the second half of the batch three times
    the first's scale, so that a shard's DSSIM range is not the batch's."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((ENS_B, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((ENS_B, 16, 16, 1)).astype(np.float32)
    y[ENS_B // 2:] *= 3.0
    return x, y


def ens_model():
    return tds.net_postupsampling(**ENS)


def rec_ens_data():
    """x, y of the recurrent ensemble's steps: [B, T, h, w, 1] windows."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((ENS_B, T, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((ENS_B, T, 16, 16, 1)).astype(np.float32)
    return x, y


def rec_ens_model():
    return tds.recnet_postupsampling(**REC_ENS)


def case_predict(rank, world, refs, out, res):
    """`predict(mesh=)` of both models at 3 and 10 samples (with
    `pad_to_multiple` once), `Predictor(mesh=)`, and the save on the first
    worker alone."""
    mesh = distributed.global_mesh()
    for name in MODELS:
        pr = pair(name)
        for n in COUNTS:
            res[f'predict/{name}/{n}'] = tds.predict(
                pr, hr_grids(name, n), device='cpu', mesh=mesh,
                **predict_kw(name))
    pr = pair('flagship')
    res['predict/padded'] = tds.predict(pr, hr_grids('flagship', 3),
                                        device='cpu', mesh=mesh,
                                        pad_to_multiple=3,
                                        **predict_kw('flagship'))
    res['predictor'] = tds.Predictor(
        pr, hr_grids('flagship', 3), device='cpu', mesh=mesh,
        **predict_kw('flagship')).run()
    where = os.path.join(out, f'saved{rank}')
    os.makedirs(where)
    tds.predict(pr, hr_grids('flagship', 3), device='cpu', mesh=mesh,
                save_path=where, **predict_kw('flagship'))
    res['saved'] = np.array(sorted(os.listdir(where)) or [''])


def case_tiled(rank, world, refs, out, res):
    """`predict_tiled(mesh=)` of the flagship, float32 and int8, and
    `predict(tile=, mesh=)`."""
    mesh = distributed.global_mesh()
    tm, net = pair('flagship')
    x = tile_input()
    for mode in (None, 'int8'):
        res[f'tiled/{mode}'] = parallel.predict_tiled(
            tm, net, x, tile=TILE, halo=HALO, batch_size=3, mesh=mesh,
            quantize=mode)
    res['tiled/predict'] = tds.predict(
        (tm, net), hr_grids('flagship', 3), device='cpu', mesh=mesh,
        tile=2, halo=HALO, quantize='int8', **predict_kw('flagship'))


def ensemble_runs(meshes, res, make_model=ens_model, data=ens_data):
    """On each of `meshes`: this rank's members from `init_ensemble`, 3
    steps without the bootstrap (the losses gathered, the members' final
    weights), `predict_ensemble`, of `make_model()` on `data()`. Returns
    the stack without a mesh."""
    tm = make_model()
    x, y = data()
    whole = parallel.init_ensemble(tm, M, seed=0, device='cpu')
    for name, ((n_e, n_d), loss) in meshes.items():
        mesh = distributed.ensemble_mesh(n_e, n_d)
        part = parallel._ensemble_part(mesh, 'ensemble', 'data', 'cpu')
        stack = parallel.init_ensemble(tm, M, seed=0, mesh=mesh,
                                       device='cpu')
        local = M // n_e
        rows = slice(part.member * local, (part.member + 1) * local)
        res[f'{name}/init_equal'] = np.array(all(
            torch.equal(stack[k], whole[k][rows]) for k in whole))
        res[f'{name}/members'] = np.arange(M)[rows]
        res[f'{name}/serve'] = np.stack(parallel.predict_ensemble(
            tm, stack, x, mesh=mesh, return_members=True)[2])
        es = parallel.make_ensemble_step(tm, mesh, loss=loss,
                                         bootstrap=False)
        res[f'{name}/axis_size'] = np.array(es.axis_size)
        opt = es.init_opt(stack)
        losses = []
        for k in range(ENS_STEPS):
            stack, opt, ls = es.step(stack, opt, x, y, k)
            losses.append(ls.numpy())
        res[f'{name}/losses'] = np.stack(losses)
        for k, v in flat(tds.weights.export_jax_ensemble(tm, stack)).items():
            res[f'{name}/end/{k}'] = v
    return whole


def case_ensembles(rank, world, refs, out, res):
    """`ensemble_runs` on MESHES; on the ('ensemble',) mesh, 3 bootstrapped
    steps beside the step without a mesh on the whole stack."""
    whole = ensemble_runs(MESHES, res)
    tm = ens_model()
    x, y = ens_data()
    mesh = distributed.ensemble_mesh(world)
    part = parallel._ensemble_part(mesh, 'ensemble', 'data', 'cpu')
    local = M // world
    rows = slice(part.member * local, (part.member + 1) * local)
    runs = []
    for m, stack in ((None, {k: v.clone() for k, v in whole.items()}),
                     (mesh, parallel.init_ensemble(tm, M, seed=0, mesh=mesh,
                                                   device='cpu'))):
        es = parallel.make_ensemble_step(tm, m, loss='mae', bootstrap=True)
        opt = es.init_opt(stack)
        losses = [es.step(stack, opt, x, y, 100 + k)[2]
                  for k in range(ENS_STEPS)]
        runs.append((torch.stack(losses), stack))
    (plain_losses, plain), (mesh_losses, mine) = runs
    res['boot/losses_equal'] = np.array(torch.equal(plain_losses,
                                                    mesh_losses))
    res['boot/members_equal'] = np.array(all(
        torch.equal(mine[k], plain[k][rows]) for k in plain))


def case_ensembles_2d(rank, world, refs, out, res):
    """`ensemble_runs` on MESHES_2D, over 4 ranks."""
    ensemble_runs(MESHES_2D, res)


def case_ensembles_recurrent(rank, world, refs, out, res):
    """`ensemble_runs` of the spatio-temporal model on REC_MESHES."""
    ensemble_runs(REC_MESHES, res, rec_ens_model, rec_ens_data)


CASES = [case_predict, case_tiled, case_ensembles, case_ensembles_recurrent]

if __name__ == '__main__':
    # 2 ranks run CASES; 4 ranks the 2 x 2 ensemble mesh alone
    run_cases(sys.argv, CASES if int(sys.argv[2]) == 2
              else [case_ensembles_2d])
