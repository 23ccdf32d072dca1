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

Spatial parallelism: `spatial_mesh(n_space, n_data)` is the counterpart of
JAX's `Mesh(devices, ('data', 'space'))`, the ranks of a band group
consecutive. Each rank of a 'space' group holds a band of rows of every
sample (H, dim -3, cut into equal bands in rank order). `space_group(group)`
is the context in which the model's layers take their band rules
(models/blocks.py), from two differentiable exchanges: `halo_rows`, the
rows of the neighbouring bands that a convolution reads, and
`gather_rows`, the band's rows joined into the whole height. Both are
built from all-gathers, which a captured CUDA graph holds as it holds the
gradients' all-reduce; their backwards send each row's gradient to the
rank that owns the row.

Tensor parallelism: `tensor_mesh(n_model, n_data)` is the counterpart of
JAX's `Mesh(devices.reshape(D, M), ('data', 'model'))`, the ranks of a
'model' group consecutive. Each rank of a 'model' group holds a shard of
every wide weight (`parallel.tensor_param_shardings`), and within
`model_group(group)` the layers take their tensor rules (models/blocks.py)
from three differentiable pieces: `copy_to_group` (identity forward, the
ranks' gradients summed backward: Megatron's copy in front of a partial
computation), `gather_channels` (a column-parallel layer's channel shards
joined) and `gather_param` (a weight's shards joined at use). Pipeline
parallelism: `pipeline_mesh(n_pipe, n_data)` is JAX's ('data', 'pipe')
mesh; `rotate` hands each stage's tensor to the next, cyclically (JAX's
`ppermute`), and `broadcast_from_last` gives every stage the last one's.
All are built from all-gathers. Every backward keeps one rule: a
replicated parameter's gradient comes out identical, bit for bit, on every
rank of its 'model' or 'pipe' group, and is never summed over it; a
sharded parameter's gradient is exact on its own rank.
"""

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

__all__ = ['initialize', 'is_multi_host', 'process_index', 'process_count',
           'global_mesh', 'ensemble_mesh', 'batch_group',
           'current_batch_group', 'all_reduce_sum', 'global_amax',
           'global_amin', 'average_gradients', 'all_gather_rows',
           'spatial_mesh', 'space_group', 'current_space_group',
           'band_rows', 'halo_rows', 'gather_rows', 'mesh_group',
           'tensor_mesh', 'pipeline_mesh', 'model_group',
           'current_model_group', 'copy_to_group', 'gather_channels',
           'gather_param', 'rotate', 'broadcast_from_last']

_BATCH_GROUP = None
_SPACE = None
_MODEL = None


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


def _inner_mesh(name, n, n_data):
    """The mesh of `n_data` x `n` processes, row-major with the dim `name`
    innermost (its groups' ranks consecutive); with `n_data` None the 1-D
    (`name`,) mesh. `n` defaults to the processes left over."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError('call distributed.initialize() first')
    world = dist.get_world_size()
    if n is None:
        n = world // (n_data or 1)
    shape = (n,) if n_data is None else (n_data, n)
    names = (name,) if n_data is None else ('data', name)
    if n * (n_data or 1) != world:
        raise ValueError(f'a mesh of {dict(zip(names, shape))} needs '
                         f'{n * (n_data or 1)} processes; the group has '
                         f'{world}')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def spatial_mesh(n_space=None, n_data=None):
    """The `DeviceMesh` of spatial parallelism, the counterpart of JAX's
    `Mesh(devices.reshape(D, S), ('data', 'space'))`: `n_data` x `n_space`
    processes, row-major with the 'space' dim innermost, so that the ranks
    of a band group are consecutive; with `n_data` None the 1-D ('space',)
    mesh. `n_space` defaults to the processes left over. Pass it as `mesh=`
    to `SupervisedTrainer`, or as `spatial_mesh=` to `predict`."""
    return _inner_mesh('space', n_space, n_data)


def tensor_mesh(n_model=None, n_data=None):
    """The `DeviceMesh` of tensor parallelism, the counterpart of JAX's
    `Mesh(devices.reshape(D, M), ('data', 'model'))`: `n_data` x `n_model`
    processes, the 'model' dim innermost; with `n_data` None the 1-D
    ('model',) mesh. `n_model` defaults to the processes left over. Pass it
    as `mesh=` to `SupervisedTrainer` or to
    `parallel.make_tensor_sharded_step`."""
    return _inner_mesh('model', n_model, n_data)


def pipeline_mesh(n_pipe=None, n_data=None):
    """The `DeviceMesh` of pipeline parallelism: `n_data` x `n_pipe`
    processes, the 'pipe' dim innermost (its stages' ranks consecutive);
    with `n_data` None the 1-D ('pipe',) mesh. `n_pipe` defaults to the
    processes left over. Pass it to `parallel.make_pipeline_step`."""
    return _inner_mesh('pipe', n_pipe, n_data)


def mesh_group(mesh):
    """A process group over every rank of `mesh`: the default group when
    the mesh spans it, else a new group (every process of the default
    group must call this, as `new_group` asks)."""
    ranks = sorted(int(r) for r in mesh.mesh.flatten().tolist())
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


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


class _Space:
    """A 'space' group with its band count and the group over which batch
    norms take their moments."""

    def __init__(self, group, moments):
        self.group = group
        self.count = dist.get_world_size(group)
        self.moments = group if moments is None else moments


@contextlib.contextmanager
def space_group(group, moments=None):
    """Within the context, the model's layers take their band rules over
    the ranks of `group` (models/blocks.py): each rank holds a band of rows
    (dim -3) of every activation, band k of the group's rank k; None leaves
    them whole. A group of one rank still routes every rule. The batch
    norms take their moments over `moments` (default `group`): on a 2-D
    mesh the group of every rank, data x space."""
    global _SPACE
    outer, _SPACE = _SPACE, (None if group is None
                             else _Space(group, moments))
    try:
        yield group
    finally:
        _SPACE = outer


def current_space_group():
    """The band group of the innermost `space_group` context (an object
    with `group`, the band `count` and the `moments` group), or None."""
    return _SPACE


class _Model:
    """A 'model' group with its rank count and this rank's place in it."""

    def __init__(self, group):
        self.group = group
        self.count = dist.get_world_size(group)
        self.rank = dist.get_rank(group)


@contextlib.contextmanager
def model_group(group):
    """Within the context, the layers whose parameters are sharded take
    their tensor rules over the ranks of `group` (models/blocks.py); None
    leaves them unsharded. A group of one rank still routes every rule."""
    global _MODEL
    outer, _MODEL = _MODEL, None if group is None else _Model(group)
    try:
        yield group
    finally:
        _MODEL = outer


def current_model_group():
    """The 'model' group of the innermost `model_group` context (an object
    with `group`, the rank `count` and this process's `rank` in it), or
    None."""
    return _MODEL


def _gather_into(out, x, group):
    fn = getattr(dist, 'all_gather_single', None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_into(out, x, group):
    fn = getattr(dist, 'reduce_scatter_single', None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)


def _ranks_of(x, group):
    """The ranks' `x` (equal shapes), stacked [n, ...] in rank order."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group)
    return out.view((n,) + tuple(x.shape))


class _HaloRows(torch.autograd.Function):
    """(above, below): the `rows` rows (dim -3) of the bands above and
    below this rank's in `group`, zeros beyond the first and last bands.
    One all-gather of every rank's first and last rows; the backward
    gathers the halos' gradients the same way and adds each to the rows of
    the rank that owns them."""

    @staticmethod
    def forward(ctx, x, rows, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        h = x.shape[-3]
        ctx.rows, ctx.group, ctx.h = rows, group, h
        edges = _ranks_of(torch.stack([x.narrow(-3, 0, rows),
                                       x.narrow(-3, h - rows, rows)]), group)
        zero = x.new_zeros(edges.shape[2:])
        above = edges[r - 1, 1] if r > 0 else zero
        below = edges[r + 1, 0] if r < n - 1 else zero
        return above.clone(), below.clone()

    @staticmethod
    def backward(ctx, g_above, g_below):
        group, rows, h = ctx.group, ctx.rows, ctx.h
        n, r = dist.get_world_size(group), dist.get_rank(group)
        grads = _ranks_of(torch.stack([g_above, g_below]), group)
        dx = g_above.new_zeros(g_above.shape[:-3] + (h,)
                               + g_above.shape[-2:])
        if r > 0:
            dx.narrow(-3, 0, rows).add_(grads[r - 1, 1])
        if r < n - 1:
            dx.narrow(-3, h - rows, rows).add_(grads[r + 1, 0])
        return dx, None, None


def band_rows(x, group, dim=-3, what='a tensor'):
    """This rank's band of the rows (`dim`, H) of `x`, cut into equal bands
    over the ranks of `group` in rank order; a height that does not cut
    raises ValueError naming `what` and the sizes."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    h = x.shape[dim]
    if h % n:
        raise ValueError(f'{what} of {h} rows does not cut into {n} equal '
                         f'bands')
    return x.narrow(dim, r * (h // n), h // n)


def halo_rows(x, rows, group):
    """The `rows` rows above and below this rank's band of `x` (H dim -3),
    taken from its neighbours in `group`, as (above, below); zeros at the
    true top and bottom borders. Differentiable: each halo row's gradient
    goes back to the rank that owns the row, which adds it to its own. A
    band shorter than `rows` raises ValueError."""
    if x.shape[-3] < rows:
        raise ValueError(f'a band of {x.shape[-3]} rows is shorter than the '
                         f'halo of {rows} rows it must lend its neighbours')
    return _HaloRows.apply(x, rows, group)


class _GatherRows(torch.autograd.Function):
    """The ranks' bands joined along dim -3 in rank order; the backward
    reduce-scatters, so that each rank gets the sum of every rank's
    gradient for its own rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = _ranks_of(x, group)                  # [n, ..., h, W, C]
        return torch.cat(parts.unbind(0), dim=-3)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        n = dist.get_world_size(group)
        h = g.shape[-3] // n
        parts = torch.stack(g.split(h, dim=-3))
        out = g.new_empty(parts.shape[1:])
        _reduce_scatter_into(out, parts.flatten(0, 1), group)
        return out, None


def gather_rows(x, group):
    """The bands of `x` (H dim -3, equal on every rank) joined over the
    ranks of `group` in rank order: the whole height, on every rank.
    Differentiable: its backward is a reduce-scatter, each rank getting
    the sum of every rank's gradient for its own rows."""
    return _GatherRows.apply(x, group)


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


def average_gradients(params, group, divisor=None):
    """The gradients of `params` summed over the ranks of `group` and
    divided by `divisor` (default: the group's size, the average): one
    all-reduce of one flat buffer, each gradient laid in it in its memory
    order, whose views in the parameters' layouts (the fused Adam's
    condition) become the gradients. Device work only, so that a captured
    step holds it. For the average NCCL averages in the collective (a
    kernel even at one rank); gloo, which has no average, and any other
    divisor sum and divide (a spatial mesh sums its band ranks' partial
    gradients and averages over its data rows only)."""
    params = [p for p in params if p.grad is not None]
    for p in params:
        if not (_dense(p.grad) and _layout(p.grad) == _layout(p)):
            raise RuntimeError(f'a gradient of shape {tuple(p.shape)} is '
                               f'not laid out as its parameter')
    flat = torch.cat([p.grad.as_strided((p.numel(),), (1,))
                      for p in params])
    size = dist.get_world_size(group)
    if divisor is None and dist.get_backend(group) == 'nccl':
        dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
    else:
        dist.all_reduce(flat, group=group)
        divisor = size if divisor is None else divisor
        if divisor != 1:
            flat.div_(divisor)
    for p, v in zip(params, flat.split([p.numel() for p in params])):
        p.grad = v.as_strided(p.shape, p.stride())


def all_gather_rows(x, group):
    """The ranks' `x` (equal shapes) concatenated along dim 0 in the order
    of their ranks in `group`, on every rank."""
    return _ranks_of(x, group).flatten(0, 1)


# ---------------------------------------------------------------------------
# Tensor and pipeline parallelism: the differentiable exchanges
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; backward the sum of the ranks' gradients, each
    rank's being a partial one (Megatron's copy)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_group(x, group):
    """`x`, replicated over the ranks of `group`, handed to a computation
    that each rank does in part (a column-parallel layer's shard of the
    output channels, the first pipeline stage): the identity, whose
    backward sums the ranks' partial gradients, so that every rank gets
    the same whole gradient of x."""
    return _CopyToGroup.apply(x, group)


def _joined(x, dim, group):
    """The ranks' `x` (equal shapes) concatenated along `dim` in rank
    order."""
    parts = _ranks_of(x, group)
    if dim % x.dim() == 0:
        return parts.flatten(0, 1)
    return torch.cat(parts.unbind(0), dim=dim)


class _GatherAlong(torch.autograd.Function):
    """The ranks' shards joined along `dim`; the backward is this rank's
    slice of the gradient, which the computation after the gather,
    replicated over the group, gives every rank whole and equal. The
    gradient takes the layout of the shard (a parameter's, as the fused
    optimizer and `average_gradients` want)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.size = x.shape[dim]
        ctx.shape = tuple(x.shape)
        ctx.strides = x.stride() if _dense(x) else None
        return _joined(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        part = grad.narrow(ctx.dim, r * ctx.size, ctx.size)
        if ctx.strides is None:
            return part.contiguous(), None, None
        out = grad.new_empty_strided(ctx.shape, ctx.strides)
        return out.copy_(part), None, None


def gather_channels(x, group):
    """The channel shards (the last dim) of a column-parallel layer's
    output joined over the ranks of `group` in rank order: the whole
    activation, on every rank. Differentiable: its backward is this rank's
    slice of the gradient, which the replicated computation after it gives
    every rank whole and equal (no reduce-scatter)."""
    return _GatherAlong.apply(x, -1, group)


def gather_param(w, dim, group):
    """The whole weight from the shards of `w` (cut along `dim`, shard k on
    the group's rank k), joined at use. Differentiable: its backward is
    this rank's slice of the whole weight's gradient, which the replicated
    computation that uses it gives every rank whole and equal; the slice
    takes the shard's layout."""
    return _GatherAlong.apply(w, dim % w.dim(), group)


class _Rotate(torch.autograd.Function):
    """Stage d receives stage d-1's tensor, cyclically; the backward
    sends each gradient the other way (stage d receives stage d+1's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return _ranks_of(x, group)[(r - 1) % n].clone()

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return _ranks_of(grad, ctx.group)[(r + 1) % n].clone(), None


def rotate(x, group):
    """The tensor of the previous rank of `group` (rank d receives rank
    d-1's, rank 0 the last's), as JAX's `ppermute` with perm [(i, (i+1) %
    S)]: one all-gather. Differentiable: the backward is the reverse
    rotation. Every rank must call it with the same shape."""
    return _Rotate.apply(x, group)


class _BroadcastFromLast(torch.autograd.Function):
    """The last rank's tensor on every rank; the gradient, equal on every
    rank (the computation after it is replicated), goes to the last rank
    alone."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.last = dist.get_rank(group) == dist.get_world_size(group) - 1
        return _ranks_of(x, group)[-1].clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None


def broadcast_from_last(x, group):
    """The last rank's `x` on every rank of `group` (the counterpart of
    JAX's `psum(where(d == S - 1, x, 0))` over the pipe axis): one
    all-gather. Differentiable: the replicated gradient of the result is
    handed to the last rank once, the others getting zeros. Every rank
    must call it with the same shape."""
    return _BroadcastFromLast.apply(x, group)
