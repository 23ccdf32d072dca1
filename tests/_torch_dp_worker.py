"""One rank of `tests/test_torch_distributed.py`: the port's data-parallel
trainer over a 2-process gloo group on the CPU, without JAX.

    python tests/_torch_dp_worker.py RANK WORLD PORT REFS OUT

reads the JAX references from the .npz file REFS (written by the test
process) and writes its results to OUT/rank<RANK>.npz and, case by case,
'ok' or the traceback to OUT/rank<RANK>.json. Every case runs on both
ranks in the same order, so that their collectives pair up. `run_cases`
and `spawn` serve the other workers of this kind
(`_torch_dp_cgan_worker.py`, `_torch_dp_serving_worker.py`): `spawn`
starts a worker's ranks from the test process and reads their results.
"""

import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import dl4ds_tpu_torch as tds  # noqa: E402
from dl4ds_tpu_torch import app, distributed  # noqa: E402

GLOO_TIMEOUT = 120     # seconds a collective may wait for the other rank


def flat(tree, prefix=''):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f'{prefix}{key}/'))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def nest(items):
    tree = {}
    for path, val in items.items():
        *head, last = path.split('/')
        node = tree
        for key in head:
            node = node.setdefault(key, {})
        node[last] = val
    return tree


def mean_over_ranks(value):
    t = torch.tensor(float(value), dtype=torch.float64)
    torch.distributed.all_reduce(t)
    return float(t) / torch.distributed.get_world_size()


def case_api(rank, world, refs, out, res):
    """`distributed`'s API, the collectives and the first-worker gating."""
    assert distributed.process_count() == world
    assert distributed.process_index() == rank
    assert distributed.is_multi_host()
    mesh = distributed.global_mesh()
    assert mesh.size() == world and mesh.mesh_dim_names == ('data',)
    assert mesh.device_type == 'cpu'
    x = torch.tensor([rank + 1.0])
    torch.distributed.all_reduce(x)
    res['api_sum'] = x.numpy()
    # the differentiable sum: the gradient is the ranks' gradients summed
    w = torch.tensor(rank + 1.0, requires_grad=True)
    (distributed.all_reduce_sum(w, mesh.get_group('data')) * (rank + 1.0)
     ).backward()
    res['api_sum_grad'] = w.grad.numpy()
    # the extremes over the ranks, their gradient on the rank that holds
    # the extreme
    v = torch.tensor([rank * 1.0, -rank * 1.0], requires_grad=True)
    hi = distributed.global_amax(v, mesh.get_group('data'))
    lo = distributed.global_amin(v, mesh.get_group('data'))
    (hi + 2 * lo).backward()
    res['api_extremes'] = np.array([float(hi), float(lo)])
    res['api_extremes_grad'] = v.grad.numpy()
    hr = np.zeros((8, 16, 16, 1), np.float32)
    tr = tds.SupervisedTrainer('convnet', 'pin', hr, hr, hr, scale=4,
                               batch_size=2, n_filters=2, n_blocks=1,
                               device='cpu', mesh=mesh, verbose=False)
    res['api_gating'] = np.array([tr.running_on_first_worker,
                                  tr.n_data_shards, tr.global_batch_size,
                                  tr.rank])
    # the app: data=N must be the world size; the open group is reused
    try:
        app._parse_mesh_shape(f'data={world + 1}', 'cpu')
        res['api_app_refused'] = np.array(False)
    except ValueError:
        res['api_app_refused'] = np.array(True)
    res['api_app_mesh'] = np.array(
        app._parse_mesh_shape(f'data={world}', 'cpu').size())


def case_steps(rank, world, refs, out, res):
    """Three `train_step`s of each JAX reference configuration on this
    rank's half of its global batches."""
    for name in json.loads(str(refs['names'])):
        cfg = json.loads(str(refs[f'{name}/config']))
        data = refs['hr']
        tr = tds.SupervisedTrainer(
            data_train=data, data_val=data[:6], data_test=data[:6],
            device='cpu', learning_rate=(1e-3, 1e-4),
            mesh=distributed.global_mesh(), **cfg)
        tr.setup_model()
        pick = {k[len(name) + 1:]: refs[k] for k in refs.files
                if k.startswith(f'{name}/')}
        params0 = nest({k[len('params0/'):]: v for k, v in pick.items()
                        if k.startswith('params0/')})
        stats0 = nest({k[len('stats0/'):]: v for k, v in pick.items()
                       if k.startswith('stats0/')})
        tds.load_jax_params(tr.net, params0, stats0 or None)
        tr.setup_optimizer()
        tr.net.train()
        b = tr.batch_size
        losses = []
        for i in range(int(refs[f'{name}/n_batches'])):
            batch = {}
            for key in ('lr', 'hr', 'aux'):
                arr = pick.get(f'batch{i}/{key}')
                batch[key] = (None if arr is None else torch.from_numpy(
                    arr[rank * b:(rank + 1) * b].copy()))
            losses.append(mean_over_ranks(tr.train_step(batch).item()))
        res[f'{name}/losses'] = np.array(losses)
        for k, v in flat(tds.weights.export_jax_params(tr.net)).items():
            res[f'{name}/params3/{k}'] = v
        if stats0:
            v = tds.weights.export_jax_variables(tr.net)['batch_stats']
            for k, a in flat(v).items():
                res[f'{name}/stats3/{k}'] = a


def _run_data():
    t = np.arange(40)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing='ij')
    return np.stack([np.sin(0.3 * yy + 0.1 * k) * np.cos(0.4 * xx - 0.05 * k)
                     for k in t])[..., None].astype('float32')


RUN = dict(backbone='convnet', upsampling='pin', scale=4, loss='mae',
           n_filters=4, n_blocks=1, verbose=False, seed=0)


def run_args(data, **kw):
    """The arguments of `tests/test_distributed.py`'s equivalence run."""
    return dict(RUN, data_train=data[:24], data_val=data[24:32],
                data_test=data[32:], device='cpu', **kw)


def case_run(rank, world, refs, out, res):
    """run() at a rank batch of 4 and half the rate, saving; a resume from
    the first worker's checkpoint; early stopping; the streaming tier."""
    data = _run_data()
    mesh = distributed.global_mesh()
    path = os.path.join(out, f'save{rank}') + '/'
    tr = tds.SupervisedTrainer(**run_args(
        data, batch_size=4, learning_rate=5e-4, epochs=3, mesh=mesh,
        save=True, save_path=path, save_bestmodel=True,
        checkpoints_frequency=1)).run()
    res['run_loss'] = np.array(tr.fithist['loss'])
    res['run_val_loss'] = np.array(tr.fithist['val_loss'])
    res['run_test_loss'] = np.array(tr.test_loss)
    files = sorted(os.path.relpath(os.path.join(d, f), path)
                   for d, _, fs in os.walk(path) for f in fs)
    res['run_files'] = np.array(files or [''])
    first = os.path.join(out, 'save0', 'checkpoints', 'epoch-2')
    again = tds.SupervisedTrainer(**run_args(
        data, batch_size=4, learning_rate=5e-4, epochs=3, mesh=mesh,
        resume_from_checkpoint=first)).run()
    res['resume_loss'] = np.array(again.fithist['loss'])
    res['resume_test_loss'] = np.array(again.test_loss)
    stop = tds.SupervisedTrainer(**run_args(
        data, batch_size=4, learning_rate=5e-4, epochs=10, mesh=mesh,
        steps_per_epoch=1, early_stopping=True, patience=2,
        min_delta=1e9)).run()
    res['stop_val_loss'] = np.array(stop.fithist['val_loss'])
    streamed = tds.SupervisedTrainer(**run_args(
        data, batch_size=4, learning_rate=5e-4, epochs=2, mesh=mesh,
        data_in_hbm=False)).run()
    res['stream_loss'] = np.array(streamed.fithist['loss']
                                  + streamed.fithist['val_loss'])
    res['stream_test_loss'] = np.array(streamed.test_loss)


def case_dropout(rank, world, refs, out, res):
    """'vanilla' dropout: the ranks draw different masks on the same
    input, and run() keeps one history."""
    data = _run_data()
    mesh = distributed.global_mesh()
    tr = tds.SupervisedTrainer(**run_args(
        data, batch_size=4, learning_rate=5e-4, epochs=2, mesh=mesh,
        dropout_rate=0.5, dropout_variant='vanilla'))
    tr.setup_model()
    tr.setup_optimizer()
    tr.net.train()
    synth = tds.BatchSynthesizer(data, None, 'pin', 4, 2, device='cpu')
    batch = synth(torch.tensor([0, 1]))
    with torch.no_grad():
        res['dropout_out'] = tr.net(batch['lr'], batch['aux']).numpy()
    tr = tds.SupervisedTrainer(**run_args(
        data, batch_size=4, learning_rate=5e-4, epochs=2, mesh=mesh,
        dropout_rate=0.5, dropout_variant='vanilla')).run()
    res['dropout_loss'] = np.array(tr.fithist['loss'])
    res['dropout_test_loss'] = np.array(tr.test_loss)


CASES = [case_api, case_steps, case_run, case_dropout]


def main(argv):
    run_cases(argv, CASES)


def run_cases(argv, cases):
    """Open the gloo group of RANK WORLD PORT (argv[1:4]), run `cases` with
    the references of argv[4], and write the results under argv[5]."""
    rank, world, port = int(argv[1]), int(argv[2]), int(argv[3])
    refs, out = np.load(argv[4]), argv[5]
    torch.set_num_threads(1)
    status, res = {}, {}
    status['no_jax'] = [m for m in sys.modules
                        if m == 'jax' or m.startswith('jax.')
                        or m == 'dl4ds_tpu' or m.startswith('dl4ds_tpu.')]
    distributed.initialize(f'127.0.0.1:{port}', world, rank, device='cpu',
                           timeout=GLOO_TIMEOUT)
    try:
        for case in cases:
            try:
                case(rank, world, refs, out, res)
                status[case.__name__] = 'ok'
            except Exception:  # noqa: BLE001 — reported by the test
                status[case.__name__] = traceback.format_exc()
            torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out, f'rank{rank}.npz'), **res)
    with open(os.path.join(out, f'rank{rank}.json'), 'w') as fh:
        json.dump(status, fh)


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def spawn(script, refs, world, timeout):
    """Run the ranks of the worker `script` on the references file `refs`
    (a pathlib.Path), their results beside it, one thread each; returns
    [(status, results)] by rank, and fails if a rank did."""
    out = refs.parent
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT',
                        'LOCAL_RANK')}
    env.update(OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(port), str(refs),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {r} failed:\n{log}'
    results = []
    for r in range(world):
        with open(out / f'rank{r}.json') as fh:
            status = json.load(fh)
        results.append((status, dict(np.load(out / f'rank{r}.npz'))))
    return results


def case_results(ranks, name):
    """The ranks' results of a case that every rank ran to its end."""
    for r, (status, _) in enumerate(ranks):
        assert status[name] == 'ok', f'rank {r}, {name}:\n{status[name]}'
    return [res for _, res in ranks]


if __name__ == '__main__':
    main(sys.argv)
