"""
One-card parallelism (the counterpart of `dl4ds_tpu/parallel.py`'s parts
that run on one device): halo-tiled serving and deep ensembles.

`predict_tiled` runs full-grid inference in halo-overlapped windows, for
grids whose activations do not fit one forward. Fixed-size windows of
`tile + 2*halo` are anchored inside the grid (clipped flush at the true
borders), so border windows see the zero padding the full-grid
convolutions see, and the tiled output equals the untiled one wherever
`halo` is at least the network's receptive-field radius. The windows are
gathered and the output placed on the device, which copies the result to
the host once.

Exactness caveat, as in the JAX package: a model with channel attention
(the zoo's output head by default) takes the gate's mean over each window,
not over the grid, so its tiled output approximates the untiled one. Build
models with `attention=False, output_attention=False` for exact tiling.

Deep ensembles: `init_ensemble` stacks `n_members` independently seeded
networks' parameters into one dict of `[M, ...]` tensors
(`torch.func.stack_module_state`), `make_ensemble_step` trains every
member in one step (`torch.func.vmap` of `torch.func.grad_and_value` over
`torch.func.functional_call`, then one Adam over the stacked tensors) and
`predict_ensemble` serves them in one vmapped forward. Under `vmap` the
channel-attention gate runs K1's member mode, one launch each way for all
members (`ops/fused_ops.py`). Spatio-temporal ensembles raise: their
ConvLSTM kernels have no member mode yet.

Over processes (one a device), the members shard over an ensemble mesh
(`distributed.ensemble_mesh()`, a `DeviceMesh` with an 'ensemble' dim and
optionally a 'data' dim, JAX's `Mesh(devices, ('ensemble', 'data'))`):
`init_ensemble(mesh=)` returns this rank's members, the process's shard of
the JAX package's global stack; the step trains them on the whole batch,
or with a 'data' dim on this rank's shard of it, each member's loss and
gradients averaged over the data dim (JAX's `shard_map` with `lax.pmean`,
dl4ds_tpu/parallel.py:508-622: the loss sees the shard alone, so a DSSIM
range is the shard's); the losses of all members and `predict_ensemble`'s
member stack are all-gathered over the 'ensemble' dim in member order.
`predict_tiled(mesh=)` shares its window dispatches out over a data mesh
(`distributed.global_mesh()`).

Spatial sharding over processes (`distributed.spatial_mesh()`, one process
a device, JAX's `Mesh(devices, ('data', 'space'))`): each rank of the
'space' dim holds a horizontal band of H / n rows of every grid, and
exchanges 2*halo boundary rows with its neighbours in the input path
(`_halo_window`: an all-gather of every rank's edge rows, windows anchored
flush inside the grid, so that the first and last bands see the true
borders). `predict_spatial_sharded` serves one grid that way and joins the
bands' outputs; `make_spatial_sharded_step` trains on it, each band's loss
and gradients taken locally and summed over the mesh. The model runs whole
on each window (K1's fused mode, pooling per window), so the results equal
the unsharded ones where `halo` covers the receptive field and the model
has no attention (dl4ds_tpu/parallel.py:255-465). The trainer's own
spatial mode (`SupervisedTrainer(mesh=spatial_mesh(...))`) is exact with
attention too: its layers take band rules instead (models/blocks.py).
"""

import collections
import copy

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, stack_module_state

from . import distributed
from .inference import _data_part, _serving
from .models.blocks import DropPath, Dropout, use_dropout_generator
from .utils import checkarg_loss, resolve_device

__all__ = ['predict_tiled', 'receptive_field_radius', 'init_ensemble',
           'make_ensemble_step', 'predict_ensemble', 'EnsembleStep',
           'make_spatial_sharded_step', 'predict_spatial_sharded',
           'SpatialShardedStep', 'tensor_param_shardings',
           'mirror_param_shardings', 'make_tensor_sharded_step',
           'TensorShardedStep', 'make_pipeline_step', 'PipelineStep',
           'place_params', 'gather_params']


def _output_scale(model):
    """Output/input spatial ratio from the model's name-suffix contract
    (names end _spc/_rc/_dc/_pin)."""
    upsampling = model.name.split('_')[-1]
    return (int(model.config['scale']) if upsampling in ('spc', 'rc', 'dc')
            else 1)


def receptive_field_radius(n_blocks, ks=3, convs_per_block=2, extra=6,
                           time_window=None):
    """Conservative receptive-field radius estimate for the zoo's backbones:
    each KxK conv adds (K-1)/2 px per side.

    Spatio-temporal models: pass `time_window` -- each ConvLSTM layer's
    recurrence convolves the hidden state once per timestep, so the
    spatial radius grows by (K-1)/2 * (T-1) per recurrent layer on top
    of the input convs (the backbone has 2 ConvLSTM layers per block,
    stem included: 2*(n_blocks+1) recurrent layers)."""
    per_conv = (ks - 1) // 2
    r = per_conv * (n_blocks * convs_per_block + extra)
    if time_window is not None and time_window > 1:
        r += per_conv * (time_window - 1) * 2 * (n_blocks + 1)
    return r


def _net_device(net):
    return next(net.parameters()).device


def _on(t, dev, dtype=torch.float32):
    """A numpy array or tensor as a `dtype` tensor on `dev`."""
    return torch.as_tensor(t).to(device=dev, dtype=dtype)


def predict_tiled(model, net, x, aux=None, tile=128, halo=32, batch_size=8,
                  mesh=None, quantize=None, calibration_quantile=None):
    """Tiled inference over [B, h, w, C] or spatio-temporal [B, T, h, w, C]
    input (LR for post-upsampling models; HR-sized for 'pin'), with the
    (DSModel, nn.Module) pair; the windows run in eval mode in batches of
    `batch_size` on the network's device. Returns float32 numpy [B(,T),
    h*s, w*s, C_out], s the model's output scale (1 for 'pin').

    `quantize` ('int8' or 'weight-only', with `calibration_quantile`)
    serves the windows through `quantization.quantize_forward`, calibrated
    on the first dispatch batch of real windows (cycled if there are fewer)
    and pinned to that batch: the windows are wrap-padded to a whole number
    of dispatches (dl4ds_tpu/parallel.py:166-200).

    `mesh` (`distributed.global_mesh()`, one process a device) shares each
    dispatch out over the ranks (dl4ds_tpu/parallel.py:161-181): a
    dispatch holds min(batch_size * ranks, ceil(n_win / ranks) * ranks)
    windows, the windows wrap-padded to a multiple of it, each rank runs
    its part on its device and an all-gather joins the window outputs, so
    that every rank places them and returns the whole grid. Quantized, every
    rank calibrates on the first global dispatch (the same windows, the
    same scales) before serving its part."""
    dev = _net_device(net)
    part = _data_part(mesh, dev)
    x = _on(x, dev)
    b = x.shape[0]
    h, w = x.shape[-3], x.shape[-2]
    scale = _output_scale(model)

    t_in_y = min(h, tile + 2 * halo)
    t_in_x = min(w, tile + 2 * halo)
    n_ty = -(-h // tile)
    n_tx = -(-w // tile)

    # aux lives on the HR(-output) grid; scale its window geometry
    s_aux = None
    if aux is not None:
        aux = _on(aux, dev)
        s_aux = aux.shape[-3] // h

    windows, aux_windows, placements = [], [], []
    for ty in range(n_ty):
        for tx in range(n_tx):
            y0, x0 = ty * tile, tx * tile
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            wy0 = min(max(y0 - halo, 0), h - t_in_y)
            wx0 = min(max(x0 - halo, 0), w - t_in_x)
            windows.append(x[..., wy0:wy0 + t_in_y, wx0:wx0 + t_in_x, :])
            if aux is not None:
                aux_windows.append(
                    aux[..., wy0 * s_aux:(wy0 + t_in_y) * s_aux,
                        wx0 * s_aux:(wx0 + t_in_x) * s_aux, :])
            # where the tile region sits inside the window, and in the output
            placements.append((y0, x0, y1 - y0, x1 - x0, y0 - wy0, x0 - wx0))

    # tile-major, then batch: window k's samples are [k*b, (k+1)*b)
    tiles = torch.cat(windows)                # [B*nt, (T,) t_in_y, t_in_x, C]
    aux_tiles = torch.cat(aux_windows) if aux is not None else None
    out_tiles = _tile_outputs(model, net, tiles, aux_tiles, batch_size, part,
                              quantize, calibration_quantile)

    c_out = out_tiles.shape[-1]
    full = torch.zeros((b, *out_tiles.shape[1:-3], h * scale, w * scale,
                        c_out), dtype=torch.float32, device=dev)
    for k, (y0, x0, ty_len, tx_len, oy, ox) in enumerate(placements):
        blk = out_tiles[k * b:(k + 1) * b]
        full[..., y0 * scale:(y0 + ty_len) * scale,
             x0 * scale:(x0 + tx_len) * scale, :] = \
            blk[..., oy * scale:(oy + ty_len) * scale,
                ox * scale:(ox + tx_len) * scale, :]
    return full.cpu().numpy()


def _wrapped(t, n):
    """The first `n` rows of `t` repeated cyclically (None stays None)."""
    if t is None or t.shape[0] == n:
        return t
    return t[torch.arange(n, device=t.device) % t.shape[0]]


def _tile_outputs(model, net, tiles, aux_tiles, batch_size, part, mode,
                  calibration_quantile):
    """The windows' outputs, in dispatches of gbs = min(batch_size * ranks,
    ceil(n_win / ranks) * ranks) windows (one rank without a mesh). Under a
    mesh (`part`'s group) or quantized, the windows are wrap-padded to a
    multiple of gbs, so that every dispatch has one shape, and the
    padding's outputs dropped; otherwise the last dispatch is short, as in
    JAX. Under a mesh this rank runs rows [rank * gbs / ranks, (rank + 1) *
    gbs / ranks) of each and the ranks' outputs are all-gathered.
    Quantized, the forward is calibrated on the first dispatch, cycled, and
    pinned to a rank's part of a dispatch (dl4ds_tpu/parallel.py:144-200)."""
    n_win, world = tiles.shape[0], part.world
    gbs = min(batch_size * world, -(-n_win // world) * world)
    n_run = (n_win if mode is None and part.group is None
             else -(-n_win // gbs) * gbs)
    local = gbs // world
    if mode is None:
        run, ctx = net, _serving(net)
    else:
        from .quantization import QuantizedForward, quantize_forward
        qf = quantize_forward(
            model, net, _wrapped(tiles, gbs),
            calibration_aux=_wrapped(aux_tiles, gbs), mode=mode,
            calibration_quantile=calibration_quantile)
        # the global dispatch's scales, pinned to this rank's part of it
        run = QuantizedForward(
            qf.module, qf.n_sites, qf.act_scales, qf.mode,
            (local,) + qf.input_shape[1:],
            None if qf.aux_shape is None else (local,) + qf.aux_shape[1:])
        ctx = torch.inference_mode()
    tiles, aux_tiles = _wrapped(tiles, n_run), _wrapped(aux_tiles, n_run)
    outs = []
    with ctx:
        for i in range(part.rank * local, n_run, gbs):
            y = run(tiles[i:i + local], aux_tiles[i:i + local]
                    if aux_tiles is not None else None).float()
            outs.append(y if part.group is None
                        else distributed.all_gather_rows(y, part.group))
    return torch.cat(outs)[:n_win]


# ---------------------------------------------------------------------------
# Spatial sharding: bands of rows over processes, halos in the input path
# ---------------------------------------------------------------------------

def _halo_window(x_band, group, n, bh, halo):
    """(the window of bh + 2*halo rows anchored flush inside the grid, the
    row of this rank's band in it) of the band x_band [B, bh, W, C]: the
    2*halo boundary rows of both neighbours in `group` (n ranks) around the
    band, zeros beyond the grid, the window's offset clipped to keep it in
    (dl4ds_tpu/parallel.py:225-248). Flush anchoring gives the first and
    last bands the true grid border, the zero padding an unsharded run
    sees. Needs n >= 2 and bh >= 2*halo. Not differentiated: the input
    path."""
    d = torch.distributed.get_rank(group)
    m = min(2 * halo, bh)
    from_above, from_below = distributed.halo_rows(x_band, m, group)
    # ext covers grid rows [d*bh - m, (d+1)*bh + m) (zeros out of range)
    ext = torch.cat([from_above, x_band, from_below], dim=1)
    off = m if d == 0 else (m - 2 * halo if d == n - 1 else m - halo)
    off = min(max(off, 0), ext.shape[1] - (bh + 2 * halo))
    return ext[:, off:off + bh + 2 * halo], m - off


def _space_part(mesh, space_axis, data_axis, what):
    """(band index, bands, band group, data index, data rows) of this rank
    on `mesh` ('space' and optionally 'data' dims)."""
    names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
    if not names:
        raise TypeError(f'`mesh` must be a DeviceMesh with named dims '
                        f'(distributed.spatial_mesh()) for {what}')
    if space_axis not in names:
        raise ValueError(f'mesh has no {space_axis!r} axis: {names}')
    data = ((mesh.get_local_rank(data_axis), mesh.size(names.index(
        data_axis))) if data_axis in names else (0, 1))
    return (mesh.get_local_rank(space_axis),
            mesh.size(names.index(space_axis)), mesh.get_group(space_axis),
            *data)


SpatialShardedStep = collections.namedtuple(
    'SpatialShardedStep', ['step', 'loss_and_grads', 'scale', 'init_opt'])


def make_spatial_sharded_step(model, mesh, tx=None, halo=32, loss='mae',
                              space_axis='space', data_axis='data'):
    """A training step whose grid height is sharded over the mesh's
    `space_axis` dim, for grids whose activations exceed one card
    (dl4ds_tpu/parallel.py:255-389). Each rank holds a horizontal band of
    every sample (and with a `data_axis` dim its data row's shard of the
    batch); the halo exchange (`_halo_window`) is in the input path, which
    is not differentiated, so each band's loss sum over the global
    denominator and its gradients are an ordinary local backward, and one
    all-reduce over the mesh sums (loss, gradients): the gradient of the
    global mean loss, exactly where `halo` >= the network's receptive-field
    radius (`receptive_field_radius`) and the model is attention- and
    norm-free (its gate pools per window, K1's fused mode).

    Returns a `SpatialShardedStep`:
      loss_and_grads(params, x, y, key) -> (loss, grads), the loss a 0-d
        tensor and grads a dict like params;
      step(params, opt_state, x, y, key) -> (params, opt_state, loss),
        updating the tensors of `params` in place;
      scale: the model's output scale (1 for 'pin');
      init_opt(params) -> the optimizer over the tensors of params
        (`tx(list(params.values()))`; `tx=None` is Adam with lr 1e-4,
        optax.adam(1e-4)'s settings) that `step` takes as opt_state.
    `params` is a dict from parameter name (`net.named_parameters()`) to
    tensor on one device, whose dtype sets the inputs'. x: [B, H, W, C]
    (LR for post-upsampling models, HR-sized for 'pin'), y: [B, H*s, W*s,
    C_out], the same global arrays on every rank; H divisible by the
    space dim's size n, H/n >= 2*halo, B divisible by the data dim's size.
    `key` (an int, or a torch.Generator from which one word is drawn)
    seeds the dropout draws with this rank's coordinates, so that no two
    ranks share masks (JAX folds the axis indices into its key). `loss`
    is 'mae' or 'mse': the windowed SSIM losses do not split over bands.
    The model must have no aux input."""
    if loss not in ('mae', 'mse'):
        raise ValueError(
            f"loss must be 'mae' or 'mse' (sum-decomposable), got {loss!r}")
    if model.aux_shape is not None:
        raise ValueError(
            'make_spatial_sharded_step does not support aux-input models '
            f'(aux_shape={model.aux_shape}): the step applies aux=None, so '
            'the aux branch would never train; build the model with '
            'n_aux_channels=0')
    scale = _output_scale(model)
    d, n_sp, sp_group, d_data, n_data = _space_part(
        mesh, space_axis, data_axis, 'make_spatial_sharded_step')
    everyone = distributed.mesh_group(mesh)
    tx = _adam if tx is None else tx

    def _validate(x, y):
        if x.dim() != 4 or y.dim() != 4:
            raise ValueError(
                'spatial sharding takes [B, H, W, C] grids (4-D); a 5-D '
                'spatio-temporal input would shard the TIME axis — use '
                'patch training or predict_tiled for those models')
        b, h = x.shape[0], x.shape[1]
        if h % n_sp:
            raise ValueError(f'H={h} must be divisible by the {space_axis} '
                             f'axis size {n_sp}')
        if n_sp > 1 and h // n_sp < 2 * halo:
            raise ValueError(f'band height H/n={h // n_sp} must be >= '
                             f'2*halo={2 * halo}')
        if b % n_data:
            raise ValueError(f'batch {b} not divisible by the {data_axis} '
                             f'axis size {n_data}')
        if y.shape[1] != h * scale:
            raise ValueError(f'target rows {y.shape[1]} != H*s = '
                             f'{h * scale}')

    def loss_and_grads(params, x, y, key):
        dev, dtype = _stack_where(params)
        x, y = _on(x, dev, dtype), _on(y, dev, dtype)
        _validate(x, y)
        b, bh = x.shape[0] // n_data, x.shape[1] // n_sp
        rows = slice(d_data * b, (d_data + 1) * b)
        x_band = x[rows, d * bh:(d + 1) * bh]
        y_band = y[rows, d * bh * scale:(d + 1) * bh * scale]
        word = (int(torch.randint(0, 2 ** 62, (1,), generator=key,
                                  device=key.device).item())
                if isinstance(key, torch.Generator) else int(key))
        gen = torch.Generator(device=dev).manual_seed(int(
            np.random.SeedSequence([word % 2 ** 63, d, d_data])
            .generate_state(1, np.uint64)[0]))
        denom = y_band.numel() * n_sp * n_data
        if n_sp > 1:
            win, crop = _halo_window(x_band, sp_group, n_sp, bh, halo)
        else:
            win, crop = x_band, 0
        net = _base_net(model, dev).train()
        held = {k: v.detach().requires_grad_() for k, v in params.items()}
        try:
            with use_dropout_generator(net, gen):
                out = functional_call(net, held, (win, None))
        finally:
            net.eval()
        out = out[:, crop * scale:(crop + bh) * scale]
        err = out.to(y.dtype) - y_band
        total = err.abs().sum() if loss == 'mae' else (err * err).sum()
        local = total / denom
        grads = torch.autograd.grad(local, list(held.values()))
        flat = torch.cat([local.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=everyone)
        parts = flat[1:].split([g.numel() for g in grads])
        return flat[0], {k: v.view_as(p) for (k, p), v in
                         zip(params.items(), parts)}

    def step(params, opt_state, x, y, key):
        _check_opt(params, opt_state)
        value, grads = loss_and_grads(params, x, y, key)
        _apply(params, opt_state, grads)
        return params, opt_state, value

    def init_opt(params):
        return tx(list(params.values()))

    return SpatialShardedStep(step, loss_and_grads, scale, init_opt)


def predict_spatial_sharded(model, net, x, mesh, halo=32, aux=None,
                            axis=None):
    """Inference with the grid height sharded over the mesh's `axis` dim
    (default: the only dim of a 1-D mesh), for grids whose activations
    exceed one card (dl4ds_tpu/parallel.py:392-465): every rank passes the
    same global x [B, H, W, C] and holds its band of H / n rows, exchanges
    `halo` rows a side with its neighbours (`_halo_window`, flush at the
    true borders), runs `net` in eval mode on its window, crops its band's
    output and all-gathers the bands: every rank returns the whole float32
    numpy [B, H*s, W*s, C']. Exact against unsharded inference where
    `halo` >= the receptive-field radius and the model has no attention
    (the gate, K1's fused mode, pools per window). H divisible by n and H/n
    >= 2*halo; with n = 1 the model runs directly."""
    if aux is not None:
        raise NotImplementedError(
            'predict_spatial_sharded does not support aux inputs; use '
            'predict_tiled (which shards aux windows alongside the input)')
    names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
    if not names:
        raise TypeError('`spatial_mesh` must be a DeviceMesh with named '
                        'dims (distributed.spatial_mesh())')
    if axis is None:
        if len(names) != 1:
            raise ValueError(
                f'mesh has axes {names}; pass axis= to choose which one '
                f'shards the grid height')
        axis = names[0]
    elif axis not in names:
        raise ValueError(f'mesh has no {axis!r} axis: {names}')
    dev = _net_device(net)
    if mesh.device_type != dev.type:
        raise ValueError(f'the mesh is over {mesh.device_type!r} devices '
                         f'but the network is on {str(dev)!r}')
    n = mesh.size(names.index(axis))
    x = _on(x, dev)
    if x.dim() != 4:
        raise ValueError('predict_spatial_sharded takes [B, H, W, C] grids '
                         '(4-D); use predict_tiled for spatio-temporal '
                         'models')
    h = x.shape[1]
    if h % n != 0:
        raise ValueError(f'H={h} must be divisible by the {axis!r} axis '
                         f'size {n}')
    bh = h // n
    if n > 1 and bh < 2 * halo:
        raise ValueError(
            f'band height H/n={bh} must be >= 2*halo={2 * halo} so edge '
            f'windows can anchor inside the grid with rows exchanged only '
            f'between neighbouring devices')
    scale = _output_scale(model)
    with _serving(net):
        if n == 1:   # degenerate mesh: no sharding, the model directly
            return net(x, None).float().cpu().numpy()
        group = mesh.get_group(axis)
        d = mesh.get_local_rank(axis)
        win, crop = _halo_window(x[:, d * bh:(d + 1) * bh], group, n, bh,
                                 halo)
        y = net(win, None)[:, crop * scale:(crop + bh) * scale]
        return distributed.gather_rows(y.float().contiguous(),
                                       group).cpu().numpy()


# ---------------------------------------------------------------------------
# Deep ensembles: members stacked on one card, trained and served by vmap
# ---------------------------------------------------------------------------

EnsembleStep = collections.namedtuple(
    'EnsembleStep', ['step', 'init_opt', 'axis_size'])


def _base_net(model, dev):
    """A network of `model` on `dev`, built once a device, that
    `functional_call` runs with a member's parameters in place of its
    own."""
    nets = model.__dict__.setdefault('_ensemble_nets', {})
    if dev not in nets:
        nets[dev] = model.init(0, device=dev)
    return nets[dev]


_EnsemblePart = collections.namedtuple(
    '_EnsemblePart', ['member', 'n_member', 'member_group', 'data',
                      'n_data', 'data_group'])
_SOLO = _EnsemblePart(0, 1, None, 0, 1, None)


def _ensemble_part(mesh, member_axis, data_axis, device_type):
    """This rank's coordinates and groups on an ensemble `mesh` (a
    `DeviceMesh` with the dim `member_axis`, over `device_type`): its
    members' coordinate and group on `member_axis`, and where `data_axis`
    is one of the mesh's dims (None: never) its data coordinate and group.
    The mesh's other dims are ignored, the ranks along them doing the same
    work, as JAX's `shard_map` replicates over the axes its specs do not
    name. One member coordinate and no groups without a mesh."""
    if mesh is None:
        return _SOLO
    names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
    if not names:
        raise TypeError('`mesh` must be a DeviceMesh with named dims '
                        '(distributed.ensemble_mesh())')
    if member_axis not in names:
        raise ValueError(f'mesh has no {member_axis!r} axis: {names}')
    if mesh.device_type != device_type:
        raise ValueError(f'the mesh is over {mesh.device_type!r} devices '
                         f'but the ensemble is on {device_type!r}')
    data = (mesh.get_local_rank(data_axis), mesh[data_axis].size(),
            mesh.get_group(data_axis)) if data_axis in names else (0, 1,
                                                                   None)
    return _EnsemblePart(mesh.get_local_rank(member_axis),
                         mesh[member_axis].size(),
                         mesh.get_group(member_axis), *data)


def _draws_dropout(net):
    return any((isinstance(m, Dropout) and m.rate > 0)
               or (isinstance(m, DropPath) and m.drop_prob > 0)
               for m in net.modules())


def _stack_where(stacked):
    """The stack's device and dtype (float32; float64 in a reference run),
    which its inputs are given."""
    leaf = next(iter(stacked.values()))
    return leaf.device, leaf.dtype


def init_ensemble(model, n_members, seed=0, mesh=None,
                  member_axis='ensemble', device='cuda'):
    """Build `n_members` networks of `model`, member k's weights drawn from a
    seed derived from (`seed`, k), and return their parameters stacked: a
    dict from parameter name (`net.named_parameters()`) to an [M, ...]
    tensor on `device`, the port's form of the JAX package's stacked
    pytree (the bits differ from JAX's `random.split`). With `mesh` (an
    ensemble mesh) it returns this rank's members alone, the M / n members
    at its coordinate on the `member_axis` dim, each with the weights its
    seed gives without a mesh (dl4ds_tpu/parallel.py:481-505); M must
    divide by the dim's size. A model with batch norm raises, as in the
    JAX package."""
    device = resolve_device(device)
    part = _ensemble_part(mesh, member_axis, None, device.type)
    if n_members % part.n_member:
        raise ValueError(
            f'{n_members} members not divisible by the {member_axis!r} '
            f'axis size {part.n_member}')
    local = n_members // part.n_member
    members = range(part.member * local, (part.member + 1) * local)
    if (model.config or {}).get('normalization') == 'bn':
        raise ValueError('ensemble training supports parameter-only models '
                         '(batch-norm statistics are per-member mutable '
                         'state); build the model without batch norm')
    nets = [model.init(int(np.random.SeedSequence((seed, k)).generate_state(
        1, np.uint64)[0]), device=device) for k in members]
    params, _ = stack_module_state(nets)
    return {name: p.detach().contiguous() for name, p in params.items()}


def _adam(params):
    """optax.adam(1e-4): Adam with lr 1e-4, betas (0.9, 0.999), eps 1e-8;
    one fused (CUDA) or foreach (CPU) update over the stacked tensors, which
    is each member's own Adam, the update being elementwise."""
    cuda = params[0].device.type == 'cuda'
    return torch.optim.Adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            fused=cuda or None)


def make_ensemble_step(model, mesh=None, tx=None, loss='mae',
                       member_axis='ensemble', data_axis='data',
                       bootstrap=True):
    """A training step that advances a whole deep ensemble at once: the
    members' losses and gradients in one `torch.func.vmap` of
    `grad_and_value` over `functional_call` (x, y and aux shared, each
    member's bootstrap resample and dropout draws its own), then one
    optimizer update over the stacked parameters.

    Returns an `EnsembleStep`:
      init_opt(stacked) -> the optimizer over the stacked tensors, which
        holds its state (`tx(list(stacked.values()))`; `tx=None` is Adam
        with lr 1e-4, optax.adam(1e-4)'s settings);
      step(stacked, opt_state, x, y, key, aux=None) -> (stacked, opt_state,
        losses[M]), updating the stacked tensors in place;
      axis_size: the mesh's `member_axis` size (1 without a mesh).
    x is [B, ...model.input_shape], y the matching HR batch, aux required
    iff the model has an aux branch (`model.aux_shape`). `key` is a
    `torch.Generator` on the stack's device or an int seed: with
    `bootstrap=True` each member trains on its own resample of the batch,
    drawn on the device from it, and the dropout draws come from it under
    vmap's randomness='different'.

    With `mesh` (an ensemble mesh, `distributed.ensemble_mesh()`) `stacked`
    is this rank's members (`init_ensemble(mesh=)`) and every rank passes
    the same x, y, aux and key (dl4ds_tpu/parallel.py:508-622). Every rank
    draws the global [M, B] bootstrap indices and takes its members' rows,
    so that an ('ensemble',) mesh trains each member of a dropout-free
    model as the step without a mesh does. A `data_axis` dim gives each
    rank its shard of the batch, B / n rows, which the bootstrap resamples
    within (JAX's stratified bootstrap), and averages each member's loss
    and gradients over the dim before the update; the loss sees the shard
    alone, as in JAX's `shard_map`. A model with dropout draws, under a
    mesh, from a generator seeded from one draw of `key` and this rank's
    coordinates, so that no two ranks share masks. The returned losses are
    all M members', gathered over the `member_axis` dim in member order."""
    lossf = checkarg_loss(loss)
    tx = _adam if tx is None else tx
    needs_aux = model.aux_shape is not None
    axis_size = _ensemble_part(mesh, member_axis, data_axis,
                               getattr(mesh, 'device_type', None)).n_member

    def step(stacked, opt_state, x, y, key, aux=None):
        if needs_aux and aux is None:
            raise ValueError(f'model {model.name!r} has an aux branch '
                             f'(aux_shape={model.aux_shape}); pass aux= to '
                             f'step() or its params never train')
        held = opt_state.param_groups[0]['params']
        if len(held) != len(stacked) or any(
                a is not b for a, b in zip(held, stacked.values())):
            raise ValueError('opt_state is not the optimizer of this stack; '
                             'make it with init_opt(stacked)')
        dev, dtype = _stack_where(stacked)
        part = _ensemble_part(mesh, member_axis, data_axis, dev.type)
        x, y = _on(x, dev, dtype), _on(y, dev, dtype)
        aux = _on(aux, dev, dtype) if needs_aux else None
        m = len(next(iter(stacked.values())))
        if x.shape[0] % part.n_data:
            raise ValueError(f'batch {x.shape[0]} not divisible by the '
                             f'{data_axis} axis size {part.n_data}')
        shard = x.shape[0] // part.n_data
        rows = slice(part.data * shard, (part.data + 1) * shard)
        x, y = x[rows], y[rows]
        aux = aux[rows] if aux is not None else None
        gen = (key if isinstance(key, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(key)))
        net = _base_net(model, dev).train()
        idx = None
        if bootstrap:
            # the global [M, n_data, B / n_data] draw (without a mesh the
            # [M, B] one), this rank's members and data shard
            idx = torch.randint(0, shard, (m * part.n_member, part.n_data,
                                           shard), generator=gen, device=dev)
            idx = idx[part.member * m:(part.member + 1) * m, part.data]
        drop = gen
        if part.member_group is not None and _draws_dropout(net):
            word = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                     device=dev).item())
            drop = torch.Generator(device=dev).manual_seed(int(
                np.random.SeedSequence([word, part.member, part.data])
                .generate_state(1, np.uint64)[0]))

        def member_loss(params, x, y, aux, idx):
            if idx is not None:
                x, y = x[idx], y[idx]
                if aux is not None:
                    aux = aux[idx]
            out = functional_call(net, params, (x, aux))
            return lossf(y, out.to(y.dtype))
        params = {k: v.detach() for k, v in stacked.items()}
        fn = torch.func.vmap(
            grad_and_value(member_loss),
            in_dims=(0, None, None, None, 0 if bootstrap else None),
            randomness='different')
        try:
            with use_dropout_generator(net, drop):
                grads, losses = fn(params, x, y, aux, idx)
        finally:
            net.eval()
        for name, p in stacked.items():
            g = grads[name]
            # a fused optimizer takes each gradient in its parameter's layout
            p.grad = (g if g.stride() == p.stride()
                      else torch.empty_like(p).copy_(g))
        losses = losses.detach()
        if part.data_group is not None:
            distributed.average_gradients(list(stacked.values()),
                                          part.data_group)
            torch.distributed.all_reduce(losses, group=part.data_group)
            losses.div_(part.n_data)
        opt_state.step()
        for p in stacked.values():
            p.grad = None
        if part.member_group is not None:
            losses = distributed.all_gather_rows(losses, part.member_group)
        return stacked, opt_state, losses

    def init_opt(stacked):
        return tx(list(stacked.values()))

    return EnsembleStep(step, init_opt, axis_size)


def predict_ensemble(model, stacked_variables, x, aux=None, mesh=None,
                     member_axis='ensemble', return_members=False):
    """Ensemble inference: every member on `x` in one vmapped eval forward
    on the stack's device, returning `(mean, std)` over the members (float32
    numpy; std the population's, as `jnp.std`) -- the downscaled field and
    its epistemic uncertainty map. With `return_members=True` the member
    stack [M, N, H, W, C] comes third, the input of
    `metrics.crps_ensemble` and `metrics.compute_prob_metrics`. With
    `mesh` (an ensemble mesh) `stacked_variables` is this rank's members:
    each rank serves its members on the whole `x`, and an all-gather over
    the `member_axis` dim builds [M, N, H, W, C] in member order on every
    rank, from which every rank computes the statistics
    (dl4ds_tpu/parallel.py:625-676)."""
    dev, dtype = _stack_where(stacked_variables)
    part = _ensemble_part(mesh, member_axis, None, dev.type)
    x = _on(x, dev, dtype)
    aux = _on(aux, dev, dtype) if aux is not None else None
    net = _base_net(model, dev)
    params = {k: v.detach() for k, v in stacked_variables.items()}
    with _serving(net):
        outs = torch.func.vmap(
            lambda p: functional_call(net, p, (x, aux)),
            randomness='same')(params).float()
    if part.member_group is not None:
        outs = distributed.all_gather_rows(outs, part.member_group)
    mean = outs.mean(dim=0).cpu().numpy()
    std = outs.std(dim=0, correction=0).cpu().numpy()
    if return_members:
        return mean, std, outs.cpu().numpy()
    return mean, std


# ---------------------------------------------------------------------------
# Tensor (channel) parallelism: wide weights sharded over a 'model' dim
# ---------------------------------------------------------------------------

TensorShardedStep = collections.namedtuple(
    'TensorShardedStep', 'step loss_and_grads init_opt param_shardings')


def _dim_names(mesh, what):
    names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
    if not names:
        raise TypeError(f'`mesh` must be a DeviceMesh with named dims for '
                        f'{what}')
    return names


def _axis_size(mesh, axis, what='tensor_param_shardings'):
    names = _dim_names(mesh, what)
    if axis not in names:
        raise ValueError(f'mesh has no {axis!r} axis: {names}')
    return mesh.size(names.index(axis))


def _data_coord(mesh, data_axis):
    """(coordinate, size, group) of this rank on the mesh's `data_axis`
    dim; (0, 1, None) where the mesh has none."""
    names = _dim_names(mesh, 'a data dim')
    if data_axis not in names:
        return 0, 1, None
    return (mesh.get_local_rank(data_axis),
            mesh.size(names.index(data_axis)), mesh.get_group(data_axis))


def _out_dim(name, t):
    """The output-feature dim of the parameter `name` in the port's layout,
    the last dim of its JAX layout: dim 0 of a `Conv`'s OIHW `weight` (the
    only parameter of that name), the last dim of every other."""
    return 0 if name.rsplit('.', 1)[-1] == 'weight' else t.dim() - 1


def tensor_param_shardings(params, mesh, model_axis='model',
                           min_channels=None):
    """The channel sharding of a network's parameters over the mesh's
    `model_axis` dim, Megatron's rule as the JAX package states it
    (dl4ds_tpu/parallel.py:686-711): a parameter of 2 dims or more whose
    output-feature dim (`_out_dim`: dim 0 of a conv's OIHW weight, the
    last dim of the others, the Flax layout's last) is divisible by the
    dim's size n and at least `min_channels` wide (default 2n) is sharded
    along that dim; everything else (biases, narrow kernels) is
    replicated. `params` is a network or a dict from
    `named_parameters()` name to tensor; returns a dict from name to the
    sharded dim, or None."""
    n = _axis_size(mesh, model_axis)
    min_c = 2 * n if min_channels is None else min_channels
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    spec = {}
    for name, t in items:
        dim = _out_dim(name, t)
        spec[name] = (dim if t.dim() >= 2 and t.shape[dim] % n == 0
                      and t.shape[dim] >= min_c else None)
    return spec


def mirror_param_shardings(state, params, p_sh, rep):
    """`p_sh` (a spec like `tensor_param_shardings`', name -> dim or None)
    mirrored onto every params-shaped part of `state`, `rep` elsewhere
    (dl4ds_tpu/parallel.py:714-741): a dict keyed by the parameters'
    names, a dict keyed by their positions (a torch optimizer's
    `state_dict()['state']`) or a list or tuple of one entry a parameter
    (the trainer's Adam states, accumulators) maps each parameter's
    tensors of its shape (the moments, the EMA copy) to its dim and its
    other entries (step counts) to `rep`; any other dict, list or tuple is
    mirrored entry by entry, anything else is `rep`. `params` (name ->
    tensor, whole or this rank's shards, as `state` holds them) fixes the
    shapes matched."""
    names = list(params)
    shapes = [tuple(params[k].shape) for k in names]
    dims = [p_sh[k] for k in names]

    def one(i, obj):
        if torch.is_tensor(obj):
            return dims[i] if tuple(obj.shape) == shapes[i] else rep
        if isinstance(obj, dict):
            return {k: one(i, v) for k, v in obj.items()}
        return rep

    def per_param(obj):
        if isinstance(obj, dict):
            if obj and set(obj) == set(names):
                return {k: one(names.index(k), v) for k, v in obj.items()}
            if obj and set(obj) == set(range(len(names))):
                return {k: one(k, v) for k, v in obj.items()}
            return None
        if (isinstance(obj, (list, tuple)) and len(obj) == len(names)
                and all(isinstance(v, dict) or (torch.is_tensor(v) and
                                                tuple(v.shape) == s)
                        for v, s in zip(obj, shapes))):
            return type(obj)(one(i, v) for i, v in enumerate(obj))
        return None

    def rec(obj):
        mirrored = per_param(obj)
        if mirrored is not None:
            return mirrored
        if isinstance(obj, dict):
            return {k: rec(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(rec(v) for v in obj)
        return rep

    return rec(state)


def _shard_axis(mesh, axis):
    """(group, size, this rank's coordinate) of the mesh's `axis` dim;
    axis None is the mesh's one dim other than 'data'."""
    names = _dim_names(mesh, 'placing parameters')
    if axis is None:
        others = [a for a in names if a != 'data']
        if len(others) != 1:
            raise ValueError(f'mesh has dims {names}; pass axis= to choose '
                             f'the one the parameters shard over')
        axis = others[0]
    if axis not in names:
        raise ValueError(f'mesh has no {axis!r} axis: {names}')
    return (mesh.get_group(axis), mesh.size(names.index(axis)),
            mesh.get_local_rank(axis))


def _map_spec(fn, params, spec):
    if isinstance(params, (tuple, list)):
        return type(params)(_map_spec(fn, p, s)
                            for p, s in zip(params, spec))
    return {k: fn(k, v, spec[k]) for k, v in params.items()}


def place_params(params, param_shardings, mesh, axis=None):
    """This rank's part of `params` (a dict from name to whole tensor, or a
    tuple of such dicts, as the pipeline's `(rest, stacked)`), by
    `param_shardings` (a dict from name to dim or None, or a tuple of
    such): of each sharded tensor the shard at this rank's coordinate on
    the mesh's `axis` dim (default its one dim other than 'data'), cut
    along its dim in rank order; every other tensor whole. Fresh tensors,
    the layout kept: the counterpart of `jax.device_put(params,
    param_shardings)`. Inverse: `gather_params`."""
    _, n, r = _shard_axis(mesh, axis)

    def part(name, t, dim):
        t = t.detach()
        if dim is None:
            return t.clone()
        if t.shape[dim] % n:
            raise ValueError(f'{name}: {t.shape[dim]} entries along dim '
                             f'{dim} do not cut into {n} shards')
        k = t.shape[dim] // n
        return t.narrow(dim, r * k, k).clone()
    return _map_spec(part, params, param_shardings)


def gather_params(params, param_shardings, mesh, axis=None):
    """The whole tensors from this rank's part of them (`place_params`'
    inverse): each sharded tensor's shards all-gathered over the mesh's
    `axis` dim and joined along its dim in rank order, on every rank;
    every other tensor as it is (copied). Every rank of the group calls
    it, in the same order."""
    group, _, _ = _shard_axis(mesh, axis)

    def whole(name, t, dim):
        t = t.detach()
        return t.clone() if dim is None else distributed._joined(t, dim,
                                                                 group)
    return _map_spec(whole, params, param_shardings)


def _shard_network(net, spec, group):
    """`net` with each parameter that `spec` shards replaced, in place, by
    this rank's shard of it in `group` (its layout kept) and its dim
    recorded in its module's `_tp_dims`, which the layers' tensor rules
    read (models/blocks.py). A sharded parameter of a module without a
    tensor rule raises NotImplementedError naming the module."""
    from .models.blocks import TENSOR_RULES
    n, r = torch.distributed.get_world_size(group), \
        torch.distributed.get_rank(group)
    modules = dict(net.named_modules())
    for name, dim in spec.items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition('.')
        owner = modules[owner_name]
        if not isinstance(owner, TENSOR_RULES):
            raise NotImplementedError(
                f'{type(owner).__name__} ({owner_name or "the network"}) has '
                f'no tensor rule for its sharded parameter {leaf!r}')
        p = getattr(owner, leaf)
        k = p.shape[dim] // n
        setattr(owner, leaf, torch.nn.Parameter(
            p.detach().narrow(dim, r * k, k).clone(),
            requires_grad=p.requires_grad))
        owner.__dict__.setdefault('_tp_dims', {})[leaf] = dim
    return net


def _whole_network(net, group):
    """A copy of the sharded `net` with every shard joined over `group`
    into its whole parameter (conv weights channels-last, as
    `DSModel.init` lays them), no `_tp_dims` left: what the JAX package's
    gathered state serves and saves. Every rank of the group calls it."""
    from .models.blocks import Conv
    whole = copy.deepcopy(net)
    for mod in whole.modules():
        dims = mod.__dict__.pop('_tp_dims', None)
        for leaf, dim in (dims or {}).items():
            p = getattr(mod, leaf)
            t = distributed._joined(p.detach(), dim, group)
            if isinstance(mod, Conv):
                t = t.contiguous(memory_format=torch.channels_last)
            setattr(mod, leaf, torch.nn.Parameter(
                t, requires_grad=p.requires_grad))
    return whole


def _has_batch_norm(module):
    from .models.blocks import BatchNorm
    return any(isinstance(m, BatchNorm) for m in module.modules())


def _key_word(key):
    """An int from `key`: an int as it is, one draw of a torch.Generator."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,), generator=key,
                                 device=key.device).item())
    return int(key)


def _seeded(dev, *words):
    """A generator on `dev` seeded from the words (numpy's SeedSequence)."""
    return torch.Generator(device=dev).manual_seed(int(
        np.random.SeedSequence([w % 2 ** 63 for w in words])
        .generate_state(1, np.uint64)[0]))


def _flat_mean(value, grads, group, n):
    """(value, grads) summed over `group` in one all-reduce and divided by
    n; unchanged without a group."""
    if group is None:
        return value, grads
    flat = torch.cat([value.reshape(1)] + [g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    flat.div_(n)
    parts = flat[1:].split([g.numel() for g in grads])
    return flat[0], [v.view_as(g) for v, g in zip(parts, grads)]


def _tensors(params):
    """The tensors of a dict, or of a tuple of dicts, in order."""
    return (list(params.values()) if isinstance(params, dict)
            else [t for d in params for t in d.values()])


def _check_opt(params, opt_state):
    held = opt_state.param_groups[0]['params']
    flat = _tensors(params)
    if len(held) != len(flat) or any(a is not b for a, b in zip(held, flat)):
        raise ValueError('opt_state is not the optimizer of these params; '
                         'make it with init_opt(params)')


def _apply(params, opt_state, grads):
    """One optimizer update of the tensors of `params` (dicts, or a tuple
    of dicts) with `grads` (the same structure), in place."""
    flat = _tensors(params)
    for p, g in zip(flat, _tensors(grads)):
        # a fused optimizer takes each gradient in its parameter's layout
        p.grad = g if g.stride() == p.stride() else \
            torch.empty_like(p).copy_(g)
    opt_state.step()
    for p in flat:
        p.grad = None


def make_tensor_sharded_step(model, mesh, tx=None, loss='mae',
                             model_axis='model', data_axis='data',
                             min_channels=None):
    """A training step whose wide weights (and optimizer moments) are
    sharded channel-wise over the mesh's `model_axis` dim, for models whose
    parameters, Adam state and activations exceed one card
    (dl4ds_tpu/parallel.py:744-853). Where the JAX package annotates the
    shardings and lets GSPMD place the collectives, each layer here takes
    its tensor rule (models/blocks.py: column-parallel convs, the other
    layers' weights gathered at use) within `distributed.model_group`; a
    `data_axis` dim gives each rank its shard of the batch, the loss and
    gradients averaged over it. Every rank of a 'model' group computes the
    loss whole and seeds its backward with 1: a replicated parameter's
    gradient comes out equal on every rank of the group, a shard's exact.

    Returns a `TensorShardedStep`:
      init_opt(params) -> the optimizer over the tensors of params
        (`tx(list(params.values()))`; `tx=None` is Adam with lr 1e-4,
        optax.adam(1e-4)'s settings), which `step` takes as opt_state;
      step(params, opt_state, x, y, key[, aux]) -> (params, opt_state,
        loss), updating the tensors of `params` in place;
      loss_and_grads(params, x, y, key[, aux]) -> (loss, grads), grads a
        dict like params (shards where params are);
      param_shardings: the spec (`tensor_param_shardings`), name -> dim or
        None; place whole parameters with `place_params(params,
        param_shardings, mesh)`.
    `params` is this rank's part of `net.named_parameters()`, on one
    device, whose dtype sets the inputs'. x, y (and aux, required iff the
    model has an aux branch) are the global arrays, the same on every
    rank. `key` (an int, or a torch.Generator from which one word is
    drawn) seeds the dropout draws with this rank's data coordinate alone,
    so that the ranks of a 'model' group draw the same masks. `loss` is
    any registry loss (the DSSIM range reduced over the data dim)."""
    lossf = checkarg_loss(loss)
    names = _dim_names(mesh, 'make_tensor_sharded_step')
    if model_axis not in names:
        raise ValueError(f'mesh has no {model_axis!r} axis: {names}')
    template = model.build()
    if _has_batch_norm(template):
        raise ValueError('tensor-sharded training supports parameter-only '
                         'models (batch-norm statistics are mutable '
                         'state); build the model without batch norm')
    spec = tensor_param_shardings(template, mesh, model_axis, min_channels)
    group = mesh.get_group(model_axis)
    d_data, n_data, data_group = _data_coord(mesh, data_axis)
    needs_aux = model.aux_shape is not None
    tx = _adam if tx is None else tx
    nets = {}

    def net_on(dev):
        if dev not in nets:
            nets[dev] = _shard_network(model.init(0, device=dev), spec,
                                       group)
        return nets[dev]

    def loss_and_grads(params, x, y, key, aux=None):
        if needs_aux and aux is None:
            raise ValueError('model takes an aux input; pass aux=')
        dev, dtype = _stack_where(params)
        x, y = _on(x, dev, dtype), _on(y, dev, dtype)
        aux = _on(aux, dev, dtype) if needs_aux else None
        if x.shape[0] % n_data:
            raise ValueError(f'batch {x.shape[0]} not divisible by the '
                             f'{data_axis} axis size {n_data}')
        b = x.shape[0] // n_data
        rows = slice(d_data * b, (d_data + 1) * b)
        x, y = x[rows], y[rows]
        aux = aux[rows] if aux is not None else None
        net = net_on(dev).train()
        held = {k: v.detach().requires_grad_() for k, v in params.items()}
        try:
            with use_dropout_generator(net, _seeded(dev, _key_word(key),
                                                    d_data)), \
                    distributed.model_group(group), \
                    distributed.batch_group(data_group):
                out = functional_call(net, held, (x, aux))
                value = lossf(y, out.to(y.dtype))
                grads = torch.autograd.grad(value, list(held.values()))
        finally:
            net.eval()
        value, grads = _flat_mean(value.detach(), list(grads), data_group,
                                  n_data)
        return value, dict(zip(params, grads))

    def step(params, opt_state, x, y, key, aux=None):
        _check_opt(params, opt_state)
        value, grads = loss_and_grads(params, x, y, key, aux)
        _apply(params, opt_state, grads)
        return params, opt_state, value

    def init_opt(params):
        return tx(list(params.values()))

    return TensorShardedStep(step, loss_and_grads, init_opt, spec)


# ---------------------------------------------------------------------------
# Pipeline parallelism: the recurrent trunk's blocks over a 'pipe' dim
# ---------------------------------------------------------------------------

PipelineStep = collections.namedtuple(
    'PipelineStep', ['step', 'loss_and_grads', 'init_opt', 'split_params',
                     'merge_params', 'param_shardings', 'n_stages',
                     'n_micro'])

_TRUNK = '_RecBackbone_0.RecurrentConvBlock'


def _trunk_prefixes(n_blocks):
    """The name prefixes of the trunk's blocks 2..n_blocks+1."""
    return [f'{_TRUNK}{i + 2}.' for i in range(n_blocks)]


def _split_trunk(params, n_blocks):
    """(rest, stacked): the trunk blocks' parameters pulled out of
    `params` (name -> tensor) and stacked on a leading [n_blocks] axis
    under their names within a block; the rest as it was."""
    prefixes = _trunk_prefixes(n_blocks)
    rest = {k: v for k, v in params.items()
            if not k.startswith(tuple(prefixes))}
    leaves = [k[len(prefixes[0]):] for k in params
              if k.startswith(prefixes[0])]
    stacked = {leaf: torch.stack([params[p + leaf] for p in prefixes])
               for leaf in leaves}
    return rest, stacked


def _merge_trunk(rest, stacked, n_blocks, order):
    """The parameters by name in `order` (a network's `named_parameters()`
    names), block i's taken from slice i of `stacked`."""
    prefixes = _trunk_prefixes(n_blocks)
    full = dict(rest)
    for i, p in enumerate(prefixes):
        for leaf, t in stacked.items():
            full[p + leaf] = t[i]
    return {k: full[k] for k in order}


def _pipeline_nets(model, dev):
    """(network, trunk block) of `model` on `dev`, built once a device:
    `functional_call` runs the network with the rest's parameters and the
    block, a copy of the trunk's first, with each stacked slice."""
    nets = model.__dict__.setdefault('_pipeline_nets', {})
    if dev not in nets:
        net = model.init(0, device=dev)
        nets[dev] = (net, copy.deepcopy(
            net._RecBackbone_0.RecurrentConvBlock2))
    return nets[dev]


def _stage_tick(block, local, d, n_micro, t, x0_mb, slot, gen_for):
    """One tick t of pipeline stage d (JAX's scan body,
    dl4ds_tpu/parallel.py:988-1011): stage 0 takes microbatch t in (every
    stage selects, so that each rank's graph reaches the stem's output),
    then the stage's blocks (`local`, name -> [blocks, ...]) run on the
    slot if it holds a microbatch (0 <= t - d < n_micro; a bubble passes
    it on unchanged). Returns the slot."""
    if t < n_micro:
        slot = torch.where(slot.new_full((), d == 0, dtype=torch.bool),
                           x0_mb[t], slot)
    if 0 <= t - d < n_micro:
        for j in range(len(next(iter(local.values())))):
            gen = gen_for(d, t, j)
            with use_dropout_generator(block, gen):
                slot = functional_call(block, {k: v[j] for k, v in
                                               local.items()}, (slot,))
    return slot


def _trunk_ticks(n_stages, n_micro, x0, stage_slots):
    """The schedule over n_micro + S - 1 ticks shared by both runs:
    `stage_slots(t, x0_mb, slots)` runs tick t and returns (the last
    stage's slot at it, the slots handed on). Returns the last stage's
    microbatches joined in batch order."""
    b = x0.shape[0]
    x0_mb = x0.reshape(n_micro, b // n_micro, *x0.shape[1:])
    outs = []
    slots = None
    for t in range(n_micro + n_stages - 1):
        last, slots = stage_slots(t, x0_mb, slots)
        if t >= n_stages - 1:           # microbatch t - (S - 1) finished
            outs.append(last)
    return torch.stack(outs).reshape(x0.shape)


def _trunk_distributed(block, local, x0, group, n_stages, n_micro, gen_for):
    """This stage's part of the trunk over the ranks of `group` (stage d =
    its rank): the stem's output enters through `copy_to_group` (JAX's P()
    in_spec sums its cotangent over 'pipe'), the slot is rotated to the
    next stage after each tick but the last, and the last stage's outputs
    are broadcast (`broadcast_from_last`). Every stage keeps its slot at
    each tick of the last stage's window, so that every rank's graph has
    the same collectives in the same order."""
    d = torch.distributed.get_rank(group)
    x0 = distributed.copy_to_group(x0, group)
    n_ticks = n_micro + n_stages - 1

    def tick(t, x0_mb, slot):
        if slot is None:
            slot = torch.zeros_like(x0_mb[0])
        slot = _stage_tick(block, local, d, n_micro, t, x0_mb, slot,
                           gen_for)
        return slot, (distributed.rotate(slot, group) if t < n_ticks - 1
                      else None)
    out = _trunk_ticks(n_stages, n_micro, x0, tick)
    return distributed.broadcast_from_last(out, group)


def _trunk_local(block, stacked, x0, n_stages, n_micro, gen_for):
    """The trunk's S stages in one process: each tick runs every stage's
    `_stage_tick` and hands each slot to the next stage's list entry."""
    bps = len(next(iter(stacked.values()))) // n_stages
    locals_ = [{k: v[d * bps:(d + 1) * bps] for k, v in stacked.items()}
               for d in range(n_stages)]

    def tick(t, x0_mb, slots):
        if slots is None:
            slots = [torch.zeros_like(x0_mb[0])] * n_stages
        new = [_stage_tick(block, locals_[d], d, n_micro, t, x0_mb,
                           slots[d], gen_for) for d in range(n_stages)]
        return new[-1], [new[(d - 1) % n_stages] for d in range(n_stages)]
    return _trunk_ticks(n_stages, n_micro, x0, tick)


def _pipeline_loss(model, parts, x, y, lossf, word, d_data, trunk):
    """(loss, (rest grads, stacked grads)) of `model` on (x, y) with its
    trunk computed by `trunk(block, stacked, x0, gen_for)`. The stem and
    head draw their dropout masks from (word, d_data), which every stage
    shares; trunk block j of stage d at tick t from (word, d_data, d, t,
    j)."""
    rest, stacked = parts
    dev = next(iter(rest.values())).device
    net, block = _pipeline_nets(model, dev)
    held_rest = {k: v.detach().requires_grad_() for k, v in rest.items()}
    held_stk = {k: v.detach().requires_grad_() for k, v in stacked.items()}
    draws = _draws_dropout(block)

    def gen_for(d, t, j):
        return _seeded(dev, word, d_data, d, t, j) if draws else None

    net.train()
    block.train()
    try:
        with use_dropout_generator(net, _seeded(dev, word, d_data)):
            out = functional_call(
                net, held_rest, (x, None),
                {'trunk_fn': lambda x0: trunk(block, held_stk, x0,
                                              gen_for)})
            value = lossf(y, out.to(y.dtype))
            leaves = list(held_rest.values()) + list(held_stk.values())
            grads = torch.autograd.grad(value, leaves)
    finally:
        net.eval()
        block.eval()
    return value.detach(), grads


def _pipeline_trunk_local(model, parts, x, y, key=0, n_stages=2,
                          n_micro=None, loss='mae'):
    """(loss, (rest grads, stacked grads)) of one pipelined step of `model`
    with its S = `n_stages` stages run in this process (`_trunk_local`),
    the whole stacked trunk in `parts` ((rest, stacked), `_split_trunk`'s):
    the stage program of `make_pipeline_step` on one device, for a card
    that cannot hold S ranks. x, y the whole batch."""
    n_micro = n_stages if n_micro is None else int(n_micro)
    rest = parts[0]
    dev, dtype = _stack_where(rest)
    x, y = _on(x, dev, dtype), _on(y, dev, dtype)
    if x.shape[0] % n_micro:
        raise ValueError(f'batch {x.shape[0]} not divisible by '
                         f'n_micro={n_micro}')
    value, grads = _pipeline_loss(
        model, parts, x, y, checkarg_loss(loss), _key_word(key), 0,
        lambda block, stk, x0, gen_for: _trunk_local(
            block, stk, x0, n_stages, n_micro, gen_for))
    return value, (dict(zip(rest, grads[:len(rest)])),
                   dict(zip(parts[1], grads[len(rest):])))


def make_pipeline_step(model, mesh, tx=None, loss='mae', n_micro=None,
                       pipe_axis='pipe', data_axis='data'):
    """A training step whose recurrent trunk is pipeline-parallel over the
    mesh's `pipe_axis` dim, GPipe's microbatch rotation
    (dl4ds_tpu/parallel.py:862-1095): the homogeneous trunk of the
    recurrent nets (blocks 2..n_blocks+1, all n_filters wide) is stacked
    on a leading [n_blocks] axis, each of the S stages holds n_blocks / S
    consecutive blocks, and over n_micro + S - 1 ticks stage 0 takes
    microbatch t in, every stage runs its blocks on its slot (one
    `_stage_tick`; K2's training variant forward on the card, and K3 or
    K4 backward) and hands it to the next (`distributed.rotate`); the last
    stage's outputs are broadcast to every stage
    (`distributed.broadcast_from_last`), whose head is replicated, as the
    stem is. The backward is autograd's through the same program: the
    reverse rotation, the last stage handed the head's gradient once, the
    stem's output's cotangents summed over the stages
    (`distributed.copy_to_group`). A `data_axis` dim gives each data row
    its shard of the batch, the loss and gradients averaged over it.

    `model` is a recurrent DSModel (`recnet_postupsampling`, `recnet_pin`),
    without batch norm or an aux input, its n_blocks divisible by S >= 2.
    `n_micro` (default S) microbatches a step; a data row's batch must
    divide by it. Returns a `PipelineStep`:
      split_params(params) -> (rest, stacked): the trunk blocks pulled out
        of `params` (name -> tensor) and stacked; place with
        `place_params((rest, stacked), param_shardings, mesh)`, which keeps
        a stage's [n_blocks / S, ...] slice;
      merge_params(rest, stacked) -> params by name (whole stacks);
      param_shardings: ({name: None}, {name: 0}), the stacked trunk
        sharded on its leading dim over the stages;
      init_opt(parts) -> the optimizer over the tensors of (rest, stacked)
        (`tx`, default Adam with lr 1e-4);
      loss_and_grads(parts, x, y, key) -> (loss, (rest grads, stacked
        grads)); step(parts, opt_state, x, y, key) -> (parts, opt_state,
        loss), updating the tensors in place.
    x [B, T, h, w, C] and y are the global arrays on every rank. `key` (an
    int or a torch.Generator) seeds the dropout draws: the stem's and
    head's from it and the data coordinate, which the stages share, and
    each trunk block's from (it, the data coordinate, stage, tick, block)
    (ROADMAP queue 3: JAX's keys leave the data coordinate out)."""
    lossf = checkarg_loss(loss)
    if not model.name.startswith('rec'):
        raise ValueError(
            'pipeline parallelism needs the homogeneous ConvLSTM trunk of '
            'the recurrent nets (recnet_postupsampling / recnet_pin); got '
            f'{model.name!r} — the spatial backbones grow filters per '
            'block, so their stages are not shape-uniform')
    if model.aux_shape is not None:
        raise ValueError(
            'make_pipeline_step does not support aux-input models '
            f'(aux_shape={model.aux_shape}); build with n_aux_channels=0')
    names = _dim_names(mesh, 'make_pipeline_step')
    if pipe_axis not in names:
        raise ValueError(f'mesh has no {pipe_axis!r} axis: {names}')
    n_stages = mesh.size(names.index(pipe_axis))
    if n_stages < 2:
        raise ValueError(f'{pipe_axis!r} axis size must be >= 2, got '
                         f'{n_stages}')
    template = model.build()
    n_blocks = template._RecBackbone_0.n_blocks
    if n_blocks % n_stages:
        raise ValueError(f'n_blocks={n_blocks} not divisible by the '
                         f'{pipe_axis} axis size {n_stages}')
    n_micro = n_stages if n_micro is None else int(n_micro)
    if n_micro < 1:
        raise ValueError(f'n_micro must be >= 1, got {n_micro}')
    if _has_batch_norm(template):
        raise ValueError('pipeline training supports parameter-only models '
                         '(batch-norm statistics are mutable per-microbatch '
                         "state); use normalization=None or 'ln'")
    group = mesh.get_group(pipe_axis)
    d_data, n_data, data_group = _data_coord(mesh, data_axis)
    tx = _adam if tx is None else tx
    order = [k for k, _ in template.named_parameters()]
    rest0, stacked0 = _split_trunk(dict(template.named_parameters()),
                                   n_blocks)
    shardings = ({k: None for k in rest0}, {k: 0 for k in stacked0})

    def split_params(params):
        return _split_trunk(params, n_blocks)

    def merge_params(rest, stacked):
        return _merge_trunk(rest, stacked, n_blocks, order)

    def _validate(x, y):
        if x.dim() != 5:
            raise ValueError('pipeline training takes spatio-temporal '
                             '[B, T, h, w, C] inputs (5-D), got '
                             f'{tuple(x.shape)}')
        b = x.shape[0]
        if b % n_data:
            raise ValueError(f'batch {b} not divisible by the {data_axis} '
                             f'axis size {n_data}')
        if (b // n_data) % n_micro:
            raise ValueError(f'per-data-shard batch {b // n_data} not '
                             f'divisible by n_micro={n_micro}')
        if y.shape[0] != b:
            raise ValueError(f'target batch {y.shape[0]} != {b}')

    def loss_and_grads(parts, x, y, key):
        rest, stacked = parts
        dev, dtype = _stack_where(rest)
        x, y = _on(x, dev, dtype), _on(y, dev, dtype)
        _validate(x, y)
        b = x.shape[0] // n_data
        rows = slice(d_data * b, (d_data + 1) * b)
        with distributed.batch_group(data_group):
            value, grads = _pipeline_loss(
                model, parts, x[rows], y[rows], lossf, _key_word(key),
                d_data, lambda block, stk, x0, gen_for: _trunk_distributed(
                    block, stk, x0, group, n_stages, n_micro, gen_for))
        value, grads = _flat_mean(value, list(grads), data_group, n_data)
        return value, (dict(zip(rest, grads[:len(rest)])),
                       dict(zip(stacked, grads[len(rest):])))

    def step(parts, opt_state, x, y, key):
        _check_opt(parts, opt_state)
        value, grads = loss_and_grads(parts, x, y, key)
        _apply(parts, opt_state, grads)
        return parts, opt_state, value

    def init_opt(parts):
        return tx(_tensors(parts))

    return PipelineStep(step, loss_and_grads, init_opt, split_params,
                        merge_params, shardings, n_stages, n_micro)
