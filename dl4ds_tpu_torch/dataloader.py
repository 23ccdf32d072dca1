"""
Device batch synthesis over whole grids
(the counterpart of `dl4ds_tpu/dataloader.py`'s `BatchSynthesizer`).

The HR dataset, predictors and static variables live on the device. A call
gathers the requested samples (windows of `time_window` consecutive grids
for a spatio-temporal model), coarsens them to the LR grid with the matmul
resize and stacks the LR channels as [lr, predictors, static_lr]; the HR
statics are the aux input. With time windows the statics go to aux only.
Random patches and season channels are not ported yet and raise.
"""

import numpy as np
import torch

from . import POSTUPSAMPLING_METHODS
from .interpolation import resize2d
from .utils import _values, not_ported, resolve_device

__all__ = ['BatchSynthesizer']


class BatchSynthesizer:
    """Device-resident batch synthesis over whole grids.

    Parameters mirror `dl4ds_tpu.BatchSynthesizer`; `device` defaults to
    CUDA, and device='cpu' must be asked for.
    """

    def __init__(self, array, array_lr, upsampling, scale, batch_size,
                 patch_size=None, time_window=None, static_vars=None,
                 predictors=None, interpolation='inter_area',
                 season_ids=None, device='cuda'):
        if patch_size is not None:
            raise not_ported('random patches', 3)
        if season_ids is not None:
            raise not_ported('season channels', 3)
        if array_lr is not None:
            raise not_ported('a given LR array', 5)
        if upsampling not in POSTUPSAMPLING_METHODS:
            raise not_ported(f'upsampling {upsampling!r}', 6)
        array = np.asarray(_values(array), 'float32')
        if array.ndim != 4:
            raise ValueError('`array` must be [n, y, x, c]')
        self.device = resolve_device(device)
        self.upsampling = upsampling
        self.scale = int(scale)
        self.batch_size = int(batch_size)
        self.interpolation = interpolation
        self.time_window = time_window
        self.n_total, self.hr_y, self.hr_x, self.n_ch = array.shape
        self.n = (self.n_total - time_window if time_window is not None
                  else self.n_total)
        self.lr_y = int(self.hr_y / scale)
        self.lr_x = int(self.hr_x / scale)
        self.hr = torch.as_tensor(array, device=self.device)
        self.pred, self.n_pred, self.static_hr, self.n_static = \
            _prep_aux_inputs((self.lr_y, self.lr_x), interpolation,
                             self.device, predictors, static_vars)
        # LR statics join the LR channels of spatial samples only
        self.static_lr = (resize2d(self.static_hr, (self.lr_y, self.lr_x),
                                   interpolation)
                          if self.static_hr is not None and time_window is None
                          else None)

    @property
    def n_channels_lr(self):
        """Total channels of the LR model input."""
        n = self.n_ch + self.n_pred
        return n if self.time_window is not None else n + self.n_static

    @property
    def n_channels_aux(self):
        return self.n_static

    def __call__(self, indices):
        """Synthesize the batch of samples `indices` [B] on the device.
        Returns dict(lr=[B(, T), h, w, C], hr=[B(, T), H, W, c],
        aux=[B, H, W, S] or None); sample i of a spatio-temporal batch is
        the window of grids i .. i + T - 1."""
        idx = torch.as_tensor(indices, dtype=torch.long, device=self.device)
        if idx.numel() and int(idx.max()) + (self.time_window or 1) \
                > self.n_total:
            raise IndexError(f'sample {int(idx.max())} reaches past the '
                             f'{self.n_total} grids')
        b = idx.shape[0]
        hr = self._gather(self.hr, idx)
        parts_lr = [resize2d(hr, (self.lr_y, self.lr_x), self.interpolation)]
        if self.pred is not None:
            parts_lr.append(self._gather(self.pred, idx))
        aux = None
        if self.static_hr is not None:
            aux = self.static_hr.expand(b, *self.static_hr.shape)
            if self.time_window is None:
                parts_lr.append(self.static_lr.expand(b,
                                                      *self.static_lr.shape))
        lr = torch.cat(parts_lr, dim=-1) if len(parts_lr) > 1 else parts_lr[0]
        return {'lr': lr, 'hr': hr, 'aux': aux}

    def _gather(self, data, idx):
        """Samples `idx` of `data` [N, ...]; with time windows [B, T, ...]
        (dl4ds_tpu/dataloader.py:629-635)."""
        if self.time_window is None:
            return data.index_select(0, idx)
        win = idx[:, None] + torch.arange(self.time_window,
                                          device=idx.device)[None, :]
        return data.index_select(0, win.reshape(-1)).reshape(
            idx.shape[0], self.time_window, *data.shape[1:])


def _prep_aux_inputs(lr_hw, interpolation, device, predictors=None,
                     static_vars=None):
    """Concat the predictors and move them to the LR grid; stack the static
    variables to [y, x, S]. Returns (pred, n_pred, statics, n_static) as
    tensors on `device` or None (dl4ds_tpu/dataloader.py:797-820)."""
    pred, n_pred = None, 0
    if predictors is not None:
        pred = (np.concatenate([_values(p) for p in predictors], axis=-1)
                if isinstance(predictors, (list, tuple))
                else _values(predictors))
        pred = torch.as_tensor(np.asarray(pred, 'float32'), device=device)
        n_pred = pred.shape[-1]
        if tuple(pred.shape[1:3]) != tuple(lr_hw):
            pred = resize2d(pred, lr_hw, interpolation)
    statics, n_static = None, 0
    if static_vars is not None:
        statics = np.stack([np.squeeze(np.asarray(_values(s), 'float32'))
                            for s in static_vars], axis=-1)
        statics = torch.as_tensor(statics, device=device)
        n_static = statics.shape[-1]
    return pred, n_pred, statics, n_static
