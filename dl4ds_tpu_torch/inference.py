"""
Inference on unseen HR or LR data (the counterpart of
`dl4ds_tpu/inference.py`).

`predict` builds one whole-dataset batch on the device with
`BatchSynthesizer` (sliding windows of `time_window` grids for a
spatio-temporal model): from HR grids, which it coarsens
(`array_in_hr=True`), or from LR grids such as a coarse model's output
(`array_in_hr=False`, MOS), with the season channels of `time_metadata`.
It then runs the network over the batch in fixed-size batches under
`torch.inference_mode()`. The ragged tail is padded by repeating its last
sample, so every forward has the same shape. It runs on CUDA unless the
caller passes device='cpu'. With `mesh` (`distributed.global_mesh()`, one
process a device) each global batch is shared out over the ranks, each
running its rows on its own device, and an all-gather joins the outputs,
so that every rank returns the whole array. Modes not ported yet raise
NotImplementedError naming their ROADMAP item.

`predict` runs a model with an 'mc*' dropout as one fixed member (each
dropout draws from a generator seeded 0 afresh, the counterpart of the
JAX package's `PRNGKey(0)` fallback); `predict_mc` runs an ensemble of
members, member k drawing from a generator derived from its seed and k.
"""

import collections
import contextlib
import os

import numpy as np
import torch

from . import distributed
from .models.blocks import use_dropout_generator
from .dataloader import BatchSynthesizer, _time_coord, season_ids_from_time
from .interpolation import resize_array
from .utils import (Timing, checkarray_ndim, resolve_device,
                    spatiotemporal_to_spatial_samples, _values)

__all__ = ['Predictor', 'predict', 'predict_mc']


class Predictor:
    """Downscale unseen data with a trained network (see `predict`).

    As in the JAX package (and the reference), `Predictor` defaults
    `array_in_hr=False`, so that `array` is taken as the LR input, while
    `predict` defaults `array_in_hr=True`, so that `array` is HR data to be
    coarsened first. Pass it explicitly when switching between the two
    entry points."""

    def __init__(self, trainer, array, scale, array_in_hr=False,
                 static_vars=None, predictors=None, time_window=None,
                 time_metadata=None, interpolation='inter_area',
                 batch_size=64, scaler=None, save_path=None,
                 save_fname='y_hat.npy', return_lr=False, device='cuda',
                 mesh=None, pad_to_multiple=None, tile=None, halo=32,
                 spatial_mesh=None, quantize=None, calibration_quantile=None,
                 calibration=None, calibration_aux=None):
        self.kwargs = dict(
            trainer=trainer, array=array, scale=scale,
            array_in_hr=array_in_hr, static_vars=static_vars,
            predictors=predictors, time_window=time_window,
            time_metadata=time_metadata, interpolation=interpolation,
            batch_size=batch_size, scaler=scaler, save_path=save_path,
            save_fname=save_fname, return_lr=return_lr, device=device,
            mesh=mesh, pad_to_multiple=pad_to_multiple, tile=tile,
            halo=halo, spatial_mesh=spatial_mesh, quantize=quantize,
            calibration_quantile=calibration_quantile,
            calibration=calibration, calibration_aux=calibration_aux)

    def run(self):
        return predict(**self.kwargs)


def _resolve_model(trainer):
    """(DSModel, nn.Module) from a (model, net) pair, from a trained
    `CGANTrainer` (its `.generator` and raw `.gen_net`: the JAX
    `_resolve_model` serves a CGAN trainer's raw generator parameters, not
    the EMA ones that its `.variables` hold), or from a trainer that holds
    `.model` and `.net` (the port's `SupervisedTrainer` after its setup or
    `run`), as the JAX `_resolve_model` takes a trainer's `.model` and
    `.variables` (dl4ds_tpu/inference.py:83-93)."""
    if isinstance(trainer, (tuple, list)) and len(trainer) == 2:
        return trainer[0], trainer[1]
    if (getattr(trainer, 'generator', None) is not None
            and getattr(trainer, 'gen_net', None) is not None):
        return trainer.generator, trainer.gen_net
    if (getattr(trainer, 'model', None) is not None
            and getattr(trainer, 'net', None) is not None):
        return trainer.model, trainer.net
    raise TypeError('`trainer` must be a (DSModel, nn.Module) pair or a '
                    'trainer holding `.model` and `.net` (set up or run it '
                    'first)')


def _assemble_inputs(model, array, scale, array_in_hr, static_vars,
                     predictors, time_window, interpolation, device,
                     time_metadata=None):
    """Whole-dataset (lr, aux) batch on `device`
    (dl4ds_tpu/inference.py:98-157). With `time_window` there are
    N - time_window + 1 samples, one per window. With `array_in_hr=False`
    `array` is the LR input, and the HR grids that the synthesizer takes
    (their shape alone reaches the model) are its resize by `scale`. With
    `time_metadata` (datetime-like [N], or 'auto' for the time coordinate
    of an xr.DataArray `array`), the one-hot season channels of each
    sample are stacked as in training; only a season-conditioned model
    takes them."""
    if isinstance(time_metadata, str):
        if time_metadata != 'auto':
            raise ValueError(f'unknown time_metadata={time_metadata!r}; '
                             f"pass datetimes or 'auto'")
        time_metadata = _time_coord(array)
        if time_metadata is None:
            raise ValueError("time_metadata='auto' requires `array` to be "
                             "an xr.DataArray with a time coordinate")
    array = np.asarray(_values(array), 'float32')
    if static_vars is not None:
        static_vars = [np.asarray(_values(s)) for s in static_vars]
    n_samples = array.shape[0]
    if time_window is not None:
        n_samples -= time_window - 1
    if n_samples <= 0:
        raise ValueError(f'`array` yields no samples (shape {array.shape}, '
                         f'time_window={time_window})')
    if predictors is not None:
        predictors = np.concatenate(
            [np.asarray(_values(p)) for p in predictors], axis=-1)
    if array_in_hr:
        array_hr, array_lr = array, None
    else:
        array_lr = checkarray_ndim(array, 4, -1)
        hr_xy = (array_lr.shape[2] * scale, array_lr.shape[1] * scale)
        array_hr = resize_array(array_lr, hr_xy, interpolation,
                                squeezed=False)
    season_ids = None
    if time_metadata is not None:
        season_ids = season_ids_from_time(time_metadata, time_window)
        if season_ids.shape[0] < n_samples:
            raise ValueError(
                f'`time_metadata` yields {season_ids.shape[0]} samples, '
                f'need {n_samples}')
        season_ids = season_ids[:n_samples]
    synth = BatchSynthesizer(
        checkarray_ndim(array_hr, 4, -1), array_lr,
        upsampling=model.upsampling, scale=scale, batch_size=n_samples,
        time_window=time_window, static_vars=static_vars,
        predictors=[predictors] if predictors is not None else None,
        interpolation=interpolation, season_ids=season_ids, device=device)
    batch = synth(torch.arange(n_samples))
    return batch['lr'], batch['aux'], n_samples


def _pad_spatial_to_multiple(x, aux, multiple):
    """Edge-pad the input's spatial axes up to the next `multiple`, and aux
    by the upsampling factor (dl4ds_tpu/inference.py:160-179). Returns (x,
    aux, out_hw): the output is cropped back to `out_hw` times the model's
    upsampling factor afterwards (`_crop_padded`)."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        x = _edge_pad(x, ph, pw)
        if aux is not None:
            aux = _edge_pad(aux, ph * (aux.shape[-3] // h),
                            pw * (aux.shape[-2] // w))
    return x, aux, (h, w)


def _edge_pad(t, ph, pw):
    """`t` [..., H, W, C] with its last row repeated ph times below and its
    last column pw times to the right (numpy's 'edge' mode)."""
    rows = torch.arange(t.shape[-3] + ph, device=t.device).clamp_(
        max=t.shape[-3] - 1)
    cols = torch.arange(t.shape[-2] + pw, device=t.device).clamp_(
        max=t.shape[-2] - 1)
    return t.index_select(-3, rows).index_select(-2, cols)


def _crop_padded(out, x, out_hw):
    """Undo `_pad_spatial_to_multiple`: crop the output back to the
    unpadded grid, scaled by the model's output/input spatial ratio."""
    if out_hw is None:
        return out
    f_h = out.shape[-3] // x.shape[-3]
    f_w = out.shape[-2] // x.shape[-2]
    return out[..., :out_hw[0] * f_h, :out_hw[1] * f_w, :]


def predict(trainer, array, scale, array_in_hr=True, static_vars=None,
            predictors=None, time_window=None, time_metadata=None,
            interpolation='inter_area', batch_size=64, scaler=None,
            save_path=None, save_fname='y_hat.npy', return_lr=False,
            device='cuda', mesh=None, pad_to_multiple=None, tile=None,
            halo=32, spatial_mesh=None, quantize=None,
            calibration_quantile=None, calibration=None,
            calibration_aux=None):
    """Super-resolve/downscale `array` [N, H, W(, C)] with a (DSModel, net)
    pair or a trained `SupervisedTrainer`, and return a numpy array [N,
    H', W', n_channels_out] (and the LR inputs with `return_lr`), float32
    for every model dtype: a bfloat16 model's output values are bfloat16
    ones held exactly in float32 (the JAX package returns an `ml_dtypes`
    bfloat16 array, dl4ds_tpu/inference.py:449; numpy has no bfloat16 of
    its own).

    With `array_in_hr=True` the grids are HR data, coarsened by `scale` on
    the device (PerfectProg); with `array_in_hr=False` they are the LR
    input itself, such as a coarse model's output (MOS). The LR input is
    stacked with the predictors, the static variables and, with
    `time_metadata` (datetime-like [N], or 'auto' for an xr.DataArray's
    time coordinate), the season channels, and run through the network in
    eval mode in batches of `batch_size`. `scaler`'s inverse_transform is
    applied to the output.

    `pad_to_multiple` edge-pads the input's grid up to the next multiple
    (and aux by the upsampling factor) and crops the output back. The
    output then differs from an unpadded run near the padded border and,
    in a model with channel attention, everywhere, since the gate's mean
    sees the padded pixels, as in the JAX package.

    A spatio-temporal model needs `time_window`: it runs on the N - tw + 1
    windows of tw consecutive grids, and its [N - tw + 1, tw, ...] output
    collapses back to N grids (the first frame of every window, then the
    last window's other frames).

    Large grids: `tile=T` routes through `parallel.predict_tiled`,
    inference in halo-overlapped TxT windows (`halo` rows and columns of
    context, at least the network's receptive-field radius for exactness);
    exact against untiled inference for attention-free models
    (`attention=False, output_attention=False`). It does not combine with
    `pad_to_multiple`.

    Int8 serving: `quantize='int8'` (or 'weight-only') runs the forward
    through `quantization.quantize_forward`, every convolution through K7
    (the hand-written int8 convolution) on the card, on the batched path
    and on the tiled one. On the batched path the activation ranges are
    calibrated on `calibration` when given, a model-ready input batch (the
    tensor the network takes: LR values with any static, predictor and
    season channels stacked, after `pad_to_multiple`'s padding), with
    `calibration_aux` for a model with an HR-aux input; else on the first
    `batch_size` samples of this input. The quantized forward is pinned to
    the serving batch: its first min(batch_size, N) calibration samples,
    fewer cycled up to it, and the last partial batch padded to it. With
    `tile=` it calibrates on the first dispatch batch of real windows, and
    an explicit `calibration` raises. `calibration_quantile` picks
    quantile-clipped ranges in place of absmax (dl4ds_tpu/inference.py:
    239-341).

    `device` is where the network and the data live ('cuda' by default;
    device='cpu' must be asked for). The network must already be there.

    `mesh` (a `DeviceMesh` with the one dim 'data' over the process group,
    `distributed.global_mesh()`) serves the samples data-parallel, as the
    JAX package shards them over its mesh (dl4ds_tpu/inference.py:
    358-371): global batches of min(batch_size * ranks, ceil(N / ranks) *
    ranks) samples, the last padded, each rank running its rows of each on
    its device; the outputs are all-gathered, every rank returns the whole
    array and only the first worker writes `save_path`. With `tile=` the
    windows are shared out the same way (`parallel.predict_tiled`).

    `spatial_mesh` (a `DeviceMesh` with a 'space' dim over the process
    group, `distributed.spatial_mesh()`) shards each grid's height over
    its ranks instead (`parallel.predict_spatial_sharded`: bands of H / n
    rows, `halo` rows exchanged a side, the bands' outputs all-gathered so
    that every rank returns the whole array; exact for attention-free
    models), as the JAX package routes it (dl4ds_tpu/inference.py:239-241,
    273-293): spatial models without an aux input only, and not with
    `quantize`, `mesh` or `pad_to_multiple`.
    """
    if quantize is not None and spatial_mesh is not None:
        raise ValueError('quantize= does not combine with spatial_mesh '
                         '(one grid sharded over its height); use tile= '
                         'for quantized large-grid inference')
    if quantize is not None and mesh is not None and tile is None:
        raise ValueError('quantize= on the plain batched path does not '
                         'combine with mesh=; pass tile= as well '
                         '(quantized window dispatches shard over the '
                         'mesh) or drop mesh=')
    if quantize is not None and tile is not None and (
            calibration is not None or calibration_aux is not None):
        raise ValueError('tiled quantized inference calibrates on the '
                         'first dispatch batch of real windows; explicit '
                         '`calibration` is not supported with tile=')
    if quantize is None and (calibration is not None
                             or calibration_aux is not None):
        raise ValueError('`calibration`/`calibration_aux` only apply to '
                         'quantized inference; pass quantize= as well')
    if spatial_mesh is not None and mesh is not None:
        raise ValueError('pass either spatial_mesh (one grid sharded over '
                         'its height) or mesh (samples sharded over the '
                         'batch), not both')
    if tile is not None and pad_to_multiple is not None:
        raise ValueError('`pad_to_multiple` is redundant with tiled '
                         'inference (every window already has one shape)')
    device = resolve_device(device)
    part = _data_part(mesh, device)
    timing = Timing(part.rank == 0)
    model, net = _resolve_model(trainer)
    _check_model_inputs(model, net, time_window, device)
    x, aux, _ = _assemble_inputs(model, array, scale, array_in_hr,
                                 static_vars, predictors, time_window,
                                 interpolation, device, time_metadata)
    batch_lr = x
    if spatial_mesh is not None:
        if x.dim() == 5:
            raise ValueError('spatially-sharded inference supports spatial '
                             'models only (4-D inputs); use tile= for '
                             'spatio-temporal grids')
        if pad_to_multiple is not None:
            raise ValueError('`pad_to_multiple` is redundant with tiled/'
                             'sharded inference (one window shape already '
                             'means one compiled program)')
        if aux is not None:
            raise ValueError('spatial_mesh does not support aux inputs '
                             'yet; use tile= for tiled inference')
        from .parallel import predict_spatial_sharded
        out = predict_spatial_sharded(model, net, x, spatial_mesh, halo=halo)
        return _finalize_predict(out, batch_lr, time_window, scaler,
                                 save_path, save_fname, return_lr, timing,
                                 writes=distributed.process_index() == 0)
    if tile is not None:
        from .parallel import predict_tiled
        out = predict_tiled(model, net, x, aux=aux, tile=tile, halo=halo,
                            batch_size=batch_size, mesh=mesh,
                            quantize=quantize,
                            calibration_quantile=calibration_quantile)
        return _finalize_predict(out, batch_lr, time_window, scaler,
                                 save_path, save_fname, return_lr, timing,
                                 writes=part.rank == 0)
    out_hw = None
    if pad_to_multiple is not None:
        x, aux, out_hw = _pad_spatial_to_multiple(x, aux, pad_to_multiple)
    if quantize is not None:
        out = _quantized_apply(model, net, x, aux, batch_size, quantize,
                               calibration_quantile, calibration,
                               calibration_aux)
    else:
        out = _eval_apply(net, x, aux, batch_size, None, part)
    out = _crop_padded(out, x, out_hw)
    return _finalize_predict(out, batch_lr, time_window, scaler, save_path,
                             save_fname, return_lr, timing,
                             writes=part.rank == 0)


def _pin_batch(c, like, name, bs):
    """The first `bs` samples of a calibration batch, cycled if it holds
    fewer (the quantized forward runs at the serving batch's shape), after
    the check that it is model-ready (dl4ds_tpu/inference.py:301-310)."""
    c = torch.as_tensor(c).to(device=like.device, dtype=torch.float32)
    if c.dim() != like.dim() or c.shape[1:] != like.shape[1:]:
        raise ValueError(
            f'`{name}` must be a model-ready batch matching the assembled '
            f'input layout {("N",) + tuple(like.shape[1:])}; got '
            f'{tuple(c.shape)}')
    return c[torch.arange(bs, device=c.device) % c.shape[0]]


def _quantized_apply(model, net, x, aux, batch_size, mode,
                     calibration_quantile, calibration, calibration_aux):
    """`predict`'s batched path through `quantize_forward`, calibrated on
    `calibration` (pinned to the serving batch) or on the input's first
    batch, the last partial batch padded as `_batched_apply` pads it
    (dl4ds_tpu/inference.py:296-336)."""
    from .quantization import quantize_forward
    bs = min(batch_size, x.shape[0])
    if calibration is not None:
        calib = _pin_batch(calibration, x, 'calibration', bs)
        caux = None
        if aux is not None:
            if calibration_aux is None:
                raise ValueError('this model takes an HR-aux input; pass '
                                 '`calibration_aux` alongside `calibration`')
            caux = _pin_batch(calibration_aux, aux, 'calibration_aux', bs)
    else:
        calib = x[:bs]
        caux = aux[:bs] if aux is not None else None
    qf = quantize_forward(model, net, calib, calibration_aux=caux, mode=mode,
                          calibration_quantile=calibration_quantile)
    with torch.inference_mode():
        return _batched_apply(qf, x, aux, bs)


def _check_model_inputs(model, net, time_window, device):
    is_spatiotemporal = len(model.input_shape) == 4
    if is_spatiotemporal and time_window is None:
        raise ValueError(
            '`time_window` must be provided for spatiotemporal model')
    if not is_spatiotemporal and time_window is not None:
        raise ValueError(f'`time_window` is for spatio-temporal models; '
                         f'{model.name!r} is spatial')
    where = {p.device for p in net.parameters()}
    if where != {device}:
        raise ValueError(f'the network is on {sorted(map(str, where))}, '
                         f'predict was asked to run on {device}')


@contextlib.contextmanager
def _serving(net, generator=None):
    """`net` in eval mode under `torch.inference_mode()`, as the JAX package
    applies training=False (dl4ds_tpu/inference.py:349-350), its dropouts
    drawing from `generator` (None: an 'mc*' dropout's fixed member); the
    caller's mode and generators come back after."""
    was_training = net.training
    net.eval()
    try:
        with use_dropout_generator(net, generator), torch.inference_mode():
            yield
    finally:
        net.train(was_training)


_DataPart = collections.namedtuple('_DataPart', ['rank', 'world', 'group'])
_NO_MESH = _DataPart(0, 1, None)


def _eval_apply(net, x, aux, batch_size, generator, part=_NO_MESH):
    """`_batched_apply` of `net` under `_serving(net, generator)`."""
    with _serving(net, generator):
        return _batched_apply(net, x, aux, batch_size, part)


# the `predict` options that `predict_mc` takes, as the JAX package's
# (dl4ds_tpu/inference.py:468-476)
_MC_OPTIONS = {'array_in_hr', 'static_vars', 'predictors', 'time_window',
               'time_metadata', 'interpolation', 'batch_size', 'scaler',
               'pad_to_multiple', 'device'}


def predict_mc(trainer, array, scale, n_members=20, seed=0,
               return_members=False, **kwargs):
    """Monte-Carlo-dropout ensemble inference
    (dl4ds_tpu/inference.py:451-507): `predict` n_members times, member k's
    dropouts drawing from a generator seeded from (`seed`, k), and return
    (mean, std) over the members, with the [M, N, H, W, C] member stack as
    a third element with `return_members=True` (the input of
    `compute_prob_metrics`). The inputs are assembled once; each member
    is collapsed over `time_window` and inverse-scaled by `scaler` before
    the statistics. Takes `predict`'s options `array_in_hr`,
    `static_vars`, `predictors`, `time_window`, `time_metadata`,
    `interpolation`, `batch_size`, `scaler`, `pad_to_multiple` and
    `device` (and drops `return_lr`); any other raises TypeError.

    Only a model with an 'mc*' dropout variant draws in eval mode; for any
    other all members are identical and std is 0. The members' bits are
    not the JAX package's (torch's Philox stream, not threefry)."""
    model, net = _resolve_model(trainer)
    kw = dict(kwargs)
    kw.pop('return_lr', None)
    unknown = set(kw) - _MC_OPTIONS
    if unknown:
        raise TypeError(
            f'predict_mc got unsupported predict option(s): '
            f'{sorted(unknown)} (save_path/mesh/return_lr are predict-only)')
    device = resolve_device(kw.get('device', 'cuda'))
    time_window = kw.get('time_window')
    _check_model_inputs(model, net, time_window, device)
    x, aux, _ = _assemble_inputs(
        model, array, scale, kw.get('array_in_hr', True),
        kw.get('static_vars'), kw.get('predictors'), time_window,
        kw.get('interpolation', 'inter_area'), device,
        kw.get('time_metadata'))
    out_hw = None
    if kw.get('pad_to_multiple') is not None:
        x, aux, out_hw = _pad_spatial_to_multiple(x, aux,
                                                  kw['pad_to_multiple'])
    scaler = kw.get('scaler')
    members = []
    for k in range(n_members):
        member_seed = int(np.random.SeedSequence((seed, k)).generate_state(
            1, np.uint64)[0])
        gen = torch.Generator(device=device).manual_seed(member_seed)
        out = _eval_apply(net, x, aux, kw.get('batch_size', 64), gen)
        out = _crop_padded(out, x, out_hw)
        if out.ndim == 5 and time_window is not None:
            out = spatiotemporal_to_spatial_samples(out, time_window)
        if scaler is not None:
            out = scaler.inverse_transform(out)
        members.append(out)
    stack = np.stack(members, axis=0)
    if return_members:
        return stack.mean(axis=0), stack.std(axis=0), stack
    return stack.mean(axis=0), stack.std(axis=0)


def _data_part(mesh, device):
    """(this rank, the ranks, their group) of a serving `mesh`, a
    `DeviceMesh` with the one dim 'data' over `device`'s type; one rank
    and no group without a mesh."""
    if mesh is None:
        return _NO_MESH
    names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
    if not names:
        raise TypeError('`mesh` must be a DeviceMesh with named dims '
                        '(distributed.global_mesh())')
    if names != ('data',):
        raise ValueError(f"serving meshes have the one dim 'data'; got "
                         f'{names}')
    if mesh.device_type != device.type:
        raise ValueError(f'the mesh is over {mesh.device_type!r} devices '
                         f'but predict runs on {str(device)!r}')
    return _DataPart(mesh.get_local_rank('data'), mesh.size(),
                    mesh.get_group('data'))


def _batched_apply(apply, x, aux, batch_size, part=_NO_MESH):
    """Run `apply(xb, ab)` over fixed-size batches, padding the ragged tail
    by repeating its last sample (trimmed after), so every forward has the
    same shape. Returns the outputs as one numpy array. Under a mesh (a
    `part` of `_data_part` with a group) a batch is global: min(batch_size *
    ranks, ceil(n / ranks) * ranks) samples, a multiple of the ranks
    (dl4ds_tpu/inference.py:361-371, 428-446), of which each rank runs its
    rows; the outputs are all-gathered."""
    n = x.shape[0]
    world = part.world
    bs = min(batch_size * world, -(-n // world) * world)
    local = bs // world
    lo = part.rank * local
    outs = []
    for i in range(0, n, bs):
        xb = x[i:i + bs]
        ab = aux[i:i + bs] if aux is not None else None
        nb = xb.shape[0]
        if nb < bs:
            xb = torch.cat([xb, xb[-1:].expand(bs - nb, *xb.shape[1:])])
            if ab is not None:
                ab = torch.cat([ab, ab[-1:].expand(bs - nb, *ab.shape[1:])])
        if part.group is None:
            outs.append(apply(xb, ab)[:nb])
            continue
        y = apply(xb[lo:lo + local],
                  ab[lo:lo + local] if ab is not None else None)
        outs.append(distributed.all_gather_rows(y.float(), part.group)[:nb])
    return torch.cat(outs).float().cpu().numpy()


def _finalize_predict(out, batch_lr, time_window, scaler, save_path,
                      save_fname, return_lr, timing, writes=True):
    """5-D -> 4-D collapse, inverse scaling and .npy save
    (dl4ds_tpu/inference.py:380-394), the save where `writes` (the first
    worker of a mesh)."""
    if out.ndim == 5 and time_window is not None:
        out = spatiotemporal_to_spatial_samples(out, time_window)
    if scaler is not None:
        out = scaler.inverse_transform(out)
    if writes and save_path is not None and save_fname is not None:
        np.save(os.path.join(save_path, save_fname), out.astype('float32'))
    timing.runtime()
    if return_lr:
        return out, batch_lr.cpu().numpy()
    return out
