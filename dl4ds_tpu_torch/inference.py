"""
Inference on unseen HR data (the counterpart of `dl4ds_tpu/inference.py`).

`predict` builds one whole-dataset batch on the device with
`BatchSynthesizer` (sliding windows of `time_window` grids for a
spatio-temporal model), then runs the network over it in fixed-size batches
under `torch.inference_mode()`. The ragged tail is padded by repeating its
last sample, so every forward has the same shape. It runs on CUDA unless
the caller passes device='cpu'. Modes not ported yet raise
NotImplementedError naming their ROADMAP item.
"""

import os

import numpy as np
import torch

from .dataloader import BatchSynthesizer
from .utils import (Timing, checkarray_ndim, not_ported, resolve_device,
                    spatiotemporal_to_spatial_samples, _values)

__all__ = ['Predictor', 'predict']


class Predictor:
    """Downscale unseen data with a trained network (see `predict`).

    As in the JAX package (and the reference), `Predictor` defaults
    `array_in_hr=False` while `predict` defaults `array_in_hr=True`; this
    slice implements array_in_hr=True only, so pass it explicitly."""

    def __init__(self, trainer, array, scale, array_in_hr=False,
                 static_vars=None, predictors=None, time_window=None,
                 time_metadata=None, interpolation='inter_area',
                 batch_size=64, scaler=None, save_path=None,
                 save_fname='y_hat.npy', return_lr=False, device='cuda',
                 mesh=None, pad_to_multiple=None, tile=None,
                 spatial_mesh=None, quantize=None):
        self.kwargs = dict(
            trainer=trainer, array=array, scale=scale,
            array_in_hr=array_in_hr, static_vars=static_vars,
            predictors=predictors, time_window=time_window,
            time_metadata=time_metadata, interpolation=interpolation,
            batch_size=batch_size, scaler=scaler, save_path=save_path,
            save_fname=save_fname, return_lr=return_lr, device=device,
            mesh=mesh, pad_to_multiple=pad_to_multiple, tile=tile,
            spatial_mesh=spatial_mesh, quantize=quantize)

    def run(self):
        return predict(**self.kwargs)


def _resolve_model(trainer):
    """(DSModel, nn.Module) from a (model, net) pair or from a trainer that
    holds `.model` and `.net` (the port's `SupervisedTrainer` after its
    setup or `run`), as the JAX `_resolve_model` takes a trainer's `.model`
    and `.variables` (dl4ds_tpu/inference.py:83-93)."""
    if isinstance(trainer, (tuple, list)) and len(trainer) == 2:
        return trainer[0], trainer[1]
    if (getattr(trainer, 'model', None) is not None
            and getattr(trainer, 'net', None) is not None):
        return trainer.model, trainer.net
    raise TypeError('`trainer` must be a (DSModel, nn.Module) pair or a '
                    'trainer holding `.model` and `.net` (set up or run it '
                    'first)')


def _assemble_inputs(model, array, scale, array_in_hr, static_vars,
                     predictors, time_window, interpolation, device):
    """Whole-dataset (lr, aux) batch on `device`
    (dl4ds_tpu/inference.py:98-157, array_in_hr=True). With `time_window`
    there are N - time_window + 1 samples, one per window."""
    if not array_in_hr:
        raise not_ported('array_in_hr=False', 5)
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
    synth = BatchSynthesizer(
        checkarray_ndim(array, 4, -1), None, upsampling=model.upsampling,
        scale=scale, batch_size=n_samples, time_window=time_window,
        static_vars=static_vars,
        predictors=[predictors] if predictors is not None else None,
        interpolation=interpolation, device=device)
    batch = synth(torch.arange(n_samples))
    return batch['lr'], batch['aux'], n_samples


def predict(trainer, array, scale, array_in_hr=True, static_vars=None,
            predictors=None, time_window=None, time_metadata=None,
            interpolation='inter_area', batch_size=64, scaler=None,
            save_path=None, save_fname='y_hat.npy', return_lr=False,
            device='cuda', mesh=None, pad_to_multiple=None, tile=None,
            spatial_mesh=None, quantize=None):
    """Super-resolve/downscale the HR grids `array` [N, H, W(, C)] with a
    (DSModel, net) pair or a trained `SupervisedTrainer`: the grids are coarsened by `scale` on the device,
    stacked with the predictors and static variables, and run through the
    network in eval mode in batches of `batch_size`. Returns a numpy array
    [N, H, W, n_channels_out] (and the LR inputs with `return_lr`), float32
    for every model dtype: a bfloat16 model's output values are bfloat16
    ones held exactly in float32 (the JAX package returns an `ml_dtypes`
    bfloat16 array, dl4ds_tpu/inference.py:449; numpy has no bfloat16 of
    its own).

    A spatio-temporal model needs `time_window`: it runs on the N - tw + 1
    windows of tw consecutive grids, and its [N - tw + 1, tw, ...] output
    collapses back to N grids (the first frame of every window, then the
    last window's other frames).

    `device` is where the network and the data live ('cuda' by default;
    device='cpu' must be asked for). The network must already be there.
    """
    for value, what, item in ((time_metadata, 'time_metadata', 3),
                              (mesh, 'mesh', 10), (tile, 'tile', 10),
                              (spatial_mesh, 'spatial_mesh', 10),
                              (pad_to_multiple, 'pad_to_multiple', 5),
                              (quantize, 'quantize', 11)):
        if value is not None:
            raise not_ported(f'predict({what}=...)', item)
    device = resolve_device(device)
    timing = Timing()
    model, net = _resolve_model(trainer)
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
    x, aux, _ = _assemble_inputs(model, array, scale, array_in_hr,
                                 static_vars, predictors, time_window,
                                 interpolation, device)
    # eval mode, as the JAX package applies training=False
    # (dl4ds_tpu/inference.py:349-350); the caller's mode comes back after
    was_training = net.training
    net.eval()
    try:
        with torch.inference_mode():
            out = _batched_apply(net, x, aux, batch_size)
    finally:
        net.train(was_training)
    return _finalize_predict(out, x, time_window, scaler, save_path,
                             save_fname, return_lr, timing)


def _batched_apply(apply, x, aux, batch_size):
    """Run `apply(xb, ab)` over fixed-size batches, padding the ragged tail
    by repeating its last sample (trimmed after), so every forward has the
    same shape. Returns the outputs as one numpy array."""
    n = x.shape[0]
    bs = min(batch_size, n)
    outs = []
    for i in range(0, n, bs):
        xb = x[i:i + bs]
        ab = aux[i:i + bs] if aux is not None else None
        nb = xb.shape[0]
        if nb < bs:
            xb = torch.cat([xb, xb[-1:].expand(bs - nb, *xb.shape[1:])])
            if ab is not None:
                ab = torch.cat([ab, ab[-1:].expand(bs - nb, *ab.shape[1:])])
        outs.append(apply(xb, ab)[:nb])
    return torch.cat(outs).float().cpu().numpy()


def _finalize_predict(out, batch_lr, time_window, scaler, save_path,
                      save_fname, return_lr, timing):
    """5-D -> 4-D collapse, inverse scaling and .npy save
    (dl4ds_tpu/inference.py:380-394)."""
    if out.ndim == 5 and time_window is not None:
        out = spatiotemporal_to_spatial_samples(out, time_window)
    if scaler is not None:
        out = scaler.inverse_transform(out)
    if save_path is not None and save_fname is not None:
        np.save(os.path.join(save_path, save_fname), out.astype('float32'))
    timing.runtime()
    if return_lr:
        return out, batch_lr.cpu().numpy()
    return out
