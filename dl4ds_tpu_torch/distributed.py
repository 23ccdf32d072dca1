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
process group; pass it as `mesh=` to `SupervisedTrainer`. Under it each
rank builds its slice of every global batch, and a step reduces across
the ranks what the JAX trainer's sharded program reduces across devices:
the gradients, the batch-norm moments, the DSSIM losses' data range and
the reported losses. `batch_group(group)` is the context in which the
batch norms and the losses take those reductions; outside it they reduce
over the local batch alone.
"""

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ['initialize', 'is_multi_host', 'process_index', 'process_count',
           'global_mesh', 'batch_group', 'current_batch_group',
           'all_reduce_sum', 'global_amax', 'global_amin']

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
