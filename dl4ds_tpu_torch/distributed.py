"""
Multi-process data parallelism: the process group, the data mesh and the
collectives of a data-parallel step (the counterpart of
`dl4ds_tpu/distributed.py`).

The reference's world is Horovod's, one process a GPU launched by mpirun
(SURVEY.md section 2.2); the JAX package's is `jax.distributed` with one
`Mesh('data')` over every device. Here it is `torch.distributed`, one
process a device, launched by `torchrun --nproc_per_node=N` (or any
launcher that sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and
LOCAL_RANK), or with the address, the count and the rank given to
`initialize`. A CUDA device pins `cuda:{LOCAL_RANK}` and talks NCCL; gloo
is used only when device='cpu' is asked for. A failed NCCL start raises:
nothing falls back to gloo or to the CPU.

`global_mesh()` is the 1-D `DeviceMesh` whose one dim, 'data', spans the
process group; pass it as `mesh=` to `SupervisedTrainer`, `CGANTrainer`,
`predict` and `predict_tiled`. Under it each trainer rank builds its slice
of every global batch, and a step reduces across the ranks what the JAX
trainer's sharded program reduces across devices: the gradients
(`average_gradients`), the batch-norm moments, the DSSIM losses' data
range and the reported losses. `batch_group(group)` is the context in
which the batch norms and the losses take those reductions; outside it
they reduce over the local batch alone. Serving ranks each run their rows
of a global batch and `all_gather_rows` joins the outputs.
`ensemble_mesh(n_ensemble, n_data)` is the ensembles' counterpart of JAX's
`Mesh(devices, ('ensemble', 'data'))`.
"""

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ['initialize', 'is_multi_host', 'process_index', 'process_count',
           'global_mesh', 'ensemble_mesh', 'batch_group',
           'current_batch_group', 'all_reduce_sum', 'global_amax',
           'global_amin', 'average_gradients', 'all_gather_rows']

_BATCH_GROUP = None


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               device='cuda', **kwargs):
    """Open the default process group.

    `coordinator_address` ('host:port'), `num_processes` and `process_id`
    default to the launcher's MASTER_ADDR:MASTER_PORT, WORLD_SIZE and
    RANK. With device='cuda' the process pins `cuda:{LOCAL_RANK}` (LOCAL_RANK
    defaults to the rank) and opens an NCCL group bound to that device;
    with device='cpu' a gloo group. Other keywords (`timeout`, a
    `datetime.timedelta` or seconds) go to `init_process_group`. Returns
    the device this process drives."""
    if dist.is_initialized():
        raise RuntimeError('the process group is already initialized')
    kind = torch.device(device).type
    if kind not in ('cuda', 'cpu'):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if kind == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device=cuda asked for, but no CUDA device is '
                           "visible; pass device='cpu' for gloo")
    if kind == 'cuda' and not dist.is_nccl_available():
        raise RuntimeError('this PyTorch has no NCCL; the CUDA path does '
                           'not fall back to gloo')
    rank = int(process_id if process_id is not None
               else os.environ.get('RANK', 0))
    world = int(num_processes if num_processes is not None
                else os.environ.get('WORLD_SIZE', 1))
    if coordinator_address is None:
        addr = os.environ.get('MASTER_ADDR')
        port = os.environ.get('MASTER_PORT')
        if addr is None or port is None:
            raise ValueError('pass `coordinator_address` or set MASTER_ADDR '
                             'and MASTER_PORT (torchrun sets them)')
        coordinator_address = f'{addr}:{port}'
    init_method = (coordinator_address if '://' in coordinator_address
                   else f'tcp://{coordinator_address}')
    timeout = kwargs.pop('timeout', None)
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    if kind == 'cpu':
        dist.init_process_group('gloo', init_method=init_method,
                                world_size=world, rank=rank, timeout=timeout,
                                **kwargs)
        return torch.device('cpu')
    dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', rank)))
    torch.cuda.set_device(dev)
    dist.init_process_group('nccl', init_method=init_method, world_size=world,
                            rank=rank, timeout=timeout, device_id=dev,
                            **kwargs)
    return dev


def is_multi_host():
    """More than one process in the group (the JAX package's name)."""
    return process_count() > 1


def process_index():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis_name='data'):
    """The 1-D data-parallel `DeviceMesh` over every process of the group,
    its one dim named `axis_name`: 'cuda' under NCCL, 'cpu' under gloo.
    Pass it as `mesh=` to `SupervisedTrainer`."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError('call distributed.initialize() first')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def ensemble_mesh(n_ensemble=None, n_data=None):
    """The `DeviceMesh` of `parallel.make_ensemble_step` and its
    companions, the counterpart of JAX's `Mesh(devices, ('ensemble',
    'data'))`: `n_ensemble` x `n_data` processes (row-major, the data dim
    innermost), or with `n_data` None the 1-D ('ensemble',) mesh.
    `n_ensemble` defaults to the processes left over."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError('call distributed.initialize() first')
    world = dist.get_world_size()
    if n_ensemble is None:
        n_ensemble = world // (n_data or 1)
    shape = (n_ensemble,) if n_data is None else (n_ensemble, n_data)
    names = ('ensemble', 'data')[:len(shape)]
    if n_ensemble * (n_data or 1) != world:
        raise ValueError(f'a mesh of {dict(zip(names, shape))} needs '
                         f'{n_ensemble * (n_data or 1)} processes; the '
                         f'group has {world}')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


@contextlib.contextmanager
def batch_group(group):
    """Within the context, the batch norms (train mode) and the DSSIM
    losses reduce over the ranks of `group`, whose local batches together
    are the global batch; None keeps them local."""
    global _BATCH_GROUP
    outer, _BATCH_GROUP = _BATCH_GROUP, group
    try:
        yield group
    finally:
        _BATCH_GROUP = outer


def current_batch_group():
    """The group of the innermost `batch_group` context, or None."""
    return _BATCH_GROUP


class _AllReduceSum(torch.autograd.Function):
    """The sum of `x` over the ranks of `group`; its gradient is the sum of
    the ranks' gradients, the gradient of the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group):
    """Differentiable sum of `x` over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)


class _GlobalExtreme(torch.autograd.Function):
    """The max (or min) of `x` over every rank's elements, with
    `jnp.max`'s gradient over the global array: the ranks' gradients
    summed and shared evenly among the elements, on any rank, that equal
    the extreme."""

    @staticmethod
    def forward(ctx, x, group, largest):
        local = torch.amax(x) if largest else torch.amin(x)
        out = local.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX if largest
                        else dist.ReduceOp.MIN, group=group)
        ctx.group = group
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        hit = (x == out).to(grad.dtype)
        both = torch.stack([grad.reshape(()), hit.sum()])
        dist.all_reduce(both, group=ctx.group)
        return hit * (both[0] / both[1]), None, None


def global_amax(x, group):
    """The max of `x` over the ranks of `group`."""
    return _GlobalExtreme.apply(x, group, True)


def global_amin(x, group):
    """The min of `x` over the ranks of `group`."""
    return _GlobalExtreme.apply(x, group, False)


def _layout(t):
    """The (stride, size) of t's dims longer than 1, innermost first: what
    fixes the order of its elements in memory."""
    return sorted((st, n) for n, st in zip(t.shape, t.stride()) if n > 1)


def _dense(t):
    """Whether t's elements fill t.numel() consecutive slots of memory."""
    expected = 1
    for st, n in _layout(t):
        if st != expected:
            return False
        expected *= n
    return True


def average_gradients(params, group):
    """The gradients of `params` averaged over the ranks of `group`: one
    all-reduce of one flat buffer, each gradient laid in it in its memory
    order, whose views in the parameters' layouts (the fused Adam's
    condition) become the gradients. Device work only, so that a captured
    step holds it. NCCL averages in the collective (a kernel even at one
    rank); gloo, which has no average, sums and divides."""
    params = [p for p in params if p.grad is not None]
    for p in params:
        if not (_dense(p.grad) and _layout(p.grad) == _layout(p)):
            raise RuntimeError(f'a gradient of shape {tuple(p.shape)} is '
                               f'not laid out as its parameter')
    flat = torch.cat([p.grad.as_strided((p.numel(),), (1,))
                      for p in params])
    if dist.get_backend(group) == 'nccl':
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(flat, group=group)
        flat.div_(dist.get_world_size(group))
    for p, v in zip(params, flat.split([p.numel() for p in params])):
        p.grad = v.as_strided(p.shape, p.stride())


def all_gather_rows(x, group):
    """The ranks' `x` (equal shapes) concatenated along dim 0 in the order
    of their ranks in `group`, on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)
