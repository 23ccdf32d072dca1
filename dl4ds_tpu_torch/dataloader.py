"""
Device batch synthesis (the counterpart of `dl4ds_tpu/dataloader.py`'s
`BatchSynthesizer`) and the season encoding of time metadata.

The HR dataset, a given LR dataset, predictors, static variables and the
season table live on the device. A call gathers the requested samples
(windows of `time_window` consecutive grids for a spatio-temporal model),
whole or as random patches, takes their LR input from the given LR array
(MOS) or coarsens them to the LR grid with the matmul resize
(PerfectProg), and stacks the LR channels as [lr, predictors, static_lr,
season_lr]; the aux input is [static_hr, season_hr]. With time windows the
statics and the season go to aux only. For a pre-upsampled ('pin') model
the LR input is on the HR grid: the LR field interpolated back to HR once
for the whole dataset (`lr_pre`), cropped at the HR patch offsets, with
the predictors on the HR grid and the HR statics in place of LR ones.
Patch offsets and epoch permutations are drawn from a CPU
`torch.Generator` and then moved to the device, so one seed gives the same
batches on every device. A batch has a
host half (`plan` for a whole epoch, or `__call__`'s checks and draws) and
a device half (`build`, `step_batch`), which never leaves the device.

Season ids come from time metadata through numpy's datetime64 alone
(`season_ids_from_time`), as the JAX package's come through pandas.
"""

import numpy as np
import torch

from . import POSTUPSAMPLING_METHODS
from .interpolation import resize2d
from .utils import _values, resolve_device

__all__ = ['BatchSynthesizer', '_get_season_', '_get_season_array_',
           'season_ids_from_time']


# -----------------------------------------------------------------------------
# Season encoding (dl4ds_tpu/dataloader.py:42-100, reference:
# dl4ds/dataloader.py:508-542)
# -----------------------------------------------------------------------------

_SEASONS = ['winter', 'spring', 'summer', 'autumn']
# season id of each month 1..12 (index 0 unused)
_MONTH_TO_SID = np.array([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 0], np.int32)


def _months(time_metadata):
    """Months 1..12 of datetime-like values (a datetime64 array, datetime
    objects, a pandas DatetimeIndex, an xr time coordinate's values), with
    numpy's datetime64 only."""
    t = np.asarray(_values(time_metadata))
    if t.dtype.kind != 'M':
        t = t.astype('datetime64[ns]')
    return t.astype('datetime64[M]').astype(np.int64) % 12 + 1


def _modal_month(months):
    """The most common month, the smallest on ties (scipy.stats.mode's
    rule, as the JAX package takes it with np.unique and argmax)."""
    vals, counts = np.unique(months, return_counts=True)
    return int(vals[np.argmax(counts)])


def _get_season_(time_metadata, time_window=None):
    """Season label of one time value, or with `time_window` the season of
    the modal month of the window's values."""
    months = _months(time_metadata)
    month_int = (int(months.item()) if time_window is None
                 else _modal_month(months.reshape(-1)))
    return _SEASONS[_MONTH_TO_SID[month_int]]


def season_ids_from_time(time_metadata, time_window=None):
    """[N] int32 season ids (0 = winter .. 3 = autumn) of datetime-like time
    metadata; with `time_window`, entry i is the season of the modal month
    of window [i, i + time_window), the smallest month on ties."""
    months = _months(time_metadata).reshape(-1)
    if time_window is None:
        return _MONTH_TO_SID[months]
    n = max(months.shape[0] - time_window + 1, 0)
    return np.array([_MONTH_TO_SID[_modal_month(months[i:i + time_window])]
                     for i in range(n)], np.int32)


def _get_season_array_(season, sizey, sizex):
    """One-hot 4-channel [y, x, 4] spatial season encoding."""
    if season not in _SEASONS:
        raise ValueError('``season`` not recognized')
    out = np.zeros((sizey, sizex, 4), dtype='float32')
    out[:, :, _SEASONS.index(season)] = 1.0
    return out


def _time_coord(x):
    """The 'time' coordinate values of an xr.DataArray, else None
    (dl4ds_tpu/dataloader.py:466-474); xarray is imported only here."""
    try:
        import xarray as xr
    except ImportError:
        return None
    if isinstance(x, xr.DataArray) and 'time' in x.coords:
        return x.time.values
    return None


class BatchSynthesizer:
    """Device-resident batch synthesis over whole grids.

    Parameters mirror `dl4ds_tpu.BatchSynthesizer`: `array_lr` [n, y, x,
    c] is the given LR dataset (None: coarsen `array`), `season_ids` an [n]
    table of season ids 0..3, one-hot encoded into 4 channels of the LR
    and aux inputs. `device` defaults to CUDA, and device='cpu' must be
    asked for.

    With upsampling='pin' the LR field (the given one, or `array`
    coarsened to the LR grid) is interpolated back to the HR grid once,
    `lr_pre` [n, Y, X, c] on the device (dl4ds_tpu/dataloader.py:545-556),
    and patches are cropped from it and from the HR grids at the same HR
    offsets; `patch_size` need not divide by `scale`.
    """

    def __init__(self, array, array_lr, upsampling, scale, batch_size,
                 patch_size=None, time_window=None, static_vars=None,
                 predictors=None, interpolation='inter_area',
                 season_ids=None, device='cuda'):
        array = np.asarray(_values(array), 'float32')
        if array.ndim != 4:
            raise ValueError('`array` must be [n, y, x, c]')
        self.device = resolve_device(device)
        self.upsampling = upsampling
        self.is_postups = upsampling in POSTUPSAMPLING_METHODS
        self.scale = int(scale)
        self.batch_size = int(batch_size)
        self.interpolation = interpolation
        self.time_window = time_window
        self.n_total, self.hr_y, self.hr_x, self.n_ch = array.shape
        self.n = (self.n_total - time_window if time_window is not None
                  else self.n_total)
        self.lr = None
        if array_lr is not None:
            array_lr = np.asarray(_values(array_lr), 'float32')
            if array_lr.ndim != 4 or array_lr.shape[0] != self.n_total:
                raise ValueError(
                    f'`array_lr` must be [{self.n_total}, y, x, c] beside '
                    f'`array` {array.shape}; got {array_lr.shape}')
            self.lr_y, self.lr_x = array_lr.shape[1:3]
            self.lr = torch.as_tensor(array_lr, device=self.device)
        else:
            self.lr_y = int(self.hr_y / scale)
            self.lr_x = int(self.hr_x / scale)
        self.patch_size = patch_size
        if patch_size is not None:
            if self.is_postups and patch_size % self.scale != 0:
                raise ValueError('`patch_size` must be divisible by `scale`')
            if patch_size > min(self.hr_y, self.hr_x):
                raise ValueError(
                    f'patch_size={patch_size} exceeds the HR grid '
                    f'({self.hr_y}x{self.hr_x})')
            self.patch_lr = int(patch_size / self.scale)
            if self.patch_lr > min(self.lr_y, self.lr_x):
                raise ValueError(
                    f'LR patch {self.patch_lr} exceeds the LR grid '
                    f'({self.lr_y}x{self.lr_x})')
        self.hr = torch.as_tensor(array, device=self.device)
        self.lr_pre = None
        if not self.is_postups:
            # the interpolated LR field does not depend on the crop: once a
            # dataset (dl4ds_tpu/dataloader.py:545-556)
            base = (self.lr if self.lr is not None else
                    resize2d(self.hr, (self.lr_y, self.lr_x), interpolation))
            self.lr_pre = resize2d(base, (self.hr_y, self.hr_x),
                                   interpolation)
            self.lr = None
        self.pred, self.n_pred, self.static_hr, self.n_static = \
            _prep_aux_inputs((self.lr_y, self.lr_x), interpolation,
                             self.device, predictors, static_vars,
                             hr_hw=None if self.is_postups
                             else (self.hr_y, self.hr_x))
        # LR statics join the LR channels of spatial samples only; patches
        # resize them from each crop; a 'pin' model takes the HR statics
        self.static_lr = None
        if self.static_hr is not None and time_window is None \
                and patch_size is None:
            self.static_lr = (resize2d(self.static_hr, (self.lr_y, self.lr_x),
                                       interpolation) if self.is_postups
                              else self.static_hr)
        self.season_ids = None
        if season_ids is not None:
            if len(season_ids) < self.n:
                # an index past the table would read another sample's
                # season, or fault on the device
                raise ValueError(
                    f'season_ids has {len(season_ids)} entries but the '
                    f'sampler draws indices up to {self.n - 1}')
            self.season_ids = torch.as_tensor(
                np.asarray(season_ids, np.int64), device=self.device)
            self._seasons = torch.arange(4, device=self.device)

    @property
    def hr_sample_hw(self):
        p = self.patch_size
        return (p, p) if p is not None else (self.hr_y, self.hr_x)

    @property
    def lr_sample_hw(self):
        """The grid of the model input: the HR sample's for 'pin'."""
        if not self.is_postups:
            return self.hr_sample_hw
        p = self.patch_size
        return ((self.patch_lr, self.patch_lr) if p is not None
                else (self.lr_y, self.lr_x))

    @property
    def n_channels_lr(self):
        """Total channels of the LR model input."""
        n = self.n_ch + self.n_pred
        if self.time_window is None:
            n += self.n_static + (4 if self.season_ids is not None else 0)
        return n

    @property
    def n_channels_aux(self):
        return self.n_static + (4 if self.season_ids is not None else 0)

    def __call__(self, indices, offsets=None, generator=None):
        """Synthesize the batch of samples `indices` [B] on the device.
        Returns dict(lr=[B(, T), h, w, C], hr=[B(, T), H, W, c],
        aux=[B, H, W, S] or None); sample i of a spatio-temporal batch is
        the window of grids i .. i + T - 1.

        With `patch_size`, sample i is the HR patch at HR offsets
        (scale * ys[i], scale * xs[i]) and its LR resize, where the LR
        offsets (ys, xs) = `offsets` ([2, B] integers), or, when not given,
        are drawn uniformly from [0, max(lr - patch_lr, 1)) with the CPU
        `generator` (ys first), as `_make_batch` draws them
        (dl4ds_tpu/dataloader.py:683-741). For 'pin' the offsets are HR
        ones, drawn from [0, max(hr - patch_size, 1)), and the HR patch
        and the pre-upsampled LR patch are both cropped there.

        The host half (checks, draws, one copy to the device) runs here,
        the device half in `build`."""
        idx = torch.as_tensor(indices, dtype=torch.long)
        self._check_indices(idx)
        ys = xs = None
        if self.patch_size is not None:
            ys, xs = self._patch_offsets(idx.shape[0], offsets, generator)
        return self.build(*(None if t is None else _to_device(t, self.device)
                            for t in (idx, ys, xs)))

    def plan(self, generator, steps):
        """The host half of `steps` batches, drawn in the order that
        `epoch_indices` and then one `__call__` a step draw them: the
        shuffled index matrix, then each step's ys and xs. Returns {'idx':
        [steps, B]} and, with patches, 'ys' and 'xs' [steps, B]: long CPU
        tensors, checked against the grids."""
        idx = self.epoch_indices(generator, steps=steps)
        self._check_indices(idx)
        plan = {'idx': idx}
        if self.patch_size is not None:
            offsets = [self._patch_offsets(self.batch_size, None, generator)
                       for _ in range(steps)]
            plan['ys'] = torch.stack([o[0] for o in offsets])
            plan['xs'] = torch.stack([o[1] for o in offsets])
        return plan

    def plan_buffers(self, steps):
        """Zeroed device buffers for `steps` rows of a plan (a valid plan:
        sample 0 at offset 0), like `plan`'s."""
        keys = ('idx',) + (('ys', 'xs') if self.patch_size is not None
                           else ())
        return {k: torch.zeros((steps, self.batch_size), dtype=torch.long,
                               device=self.device) for k in keys}

    def step_batch(self, plan, row):
        """The batch of row `row` (a one-element long tensor on the device)
        of a plan held on the device: the device half alone, without a host
        read, so that it can be captured in a CUDA graph."""
        return self.build(*(plan[k].index_select(0, row).view(-1)
                            if k in plan else None
                            for k in ('idx', 'ys', 'xs')))

    def build(self, idx, ys=None, xs=None):
        """The device half of `__call__`: the batch of samples `idx` [B]
        at the patch offsets (ys, xs) [B] (LR ones, HR for 'pin'), all long
        tensors on the device, checked by the host half. Device work only:
        no host read, no host copy (dl4ds_tpu/dataloader.py:683-784)."""
        b = idx.shape[0]
        static_hr = static_lr = None
        if self.patch_size is None:
            hr = self._gather(self.hr, idx)
            if self.lr_pre is not None:
                lr = self._gather(self.lr_pre, idx)
            elif self.lr is not None:
                lr = self._gather(self.lr, idx)
            else:
                lr = resize2d(hr, (self.lr_y, self.lr_x), self.interpolation)
            pred = (self._gather(self.pred, idx) if self.pred is not None
                    else None)
            if self.static_hr is not None:
                static_hr = self.static_hr.expand(b, *self.static_hr.shape)
                if self.time_window is None:
                    static_lr = self.static_lr.expand(b,
                                                      *self.static_lr.shape)
        else:
            # the model input's patch is `size` pixels at (ys, xs): LR ones,
            # or for 'pin' HR ones, where the HR patch lies too (s = 1)
            p = self.patch_size
            pin = self.lr_pre is not None
            s, size = (1, p) if pin else (self.scale, self.patch_lr)
            hr = self._gather_crop(self.hr, idx, ys * s, xs * s, p)
            if pin:
                lr = self._gather_crop(self.lr_pre, idx, ys, xs, p)
            elif self.lr is not None:
                lr = self._gather_crop(self.lr, idx, ys, xs, size)
            else:
                lr = resize2d(hr, (size, size), self.interpolation)
            pred = (self._gather_crop(self.pred, idx, ys, xs, size)
                    if self.pred is not None else None)
            if self.static_hr is not None:
                rows, cols = _crop_index(ys * s, xs * s, p)
                static_hr = self.static_hr[rows[:, :, None], cols[:, None, :]]
                if self.time_window is None:
                    static_lr = (static_hr if pin else resize2d(
                        static_hr, (size, size), self.interpolation))
        parts_lr = [lr] + ([pred] if pred is not None else [])
        parts_aux = []
        if static_hr is not None:
            parts_aux.append(static_hr)
            if static_lr is not None:
                parts_lr.append(static_lr)
        if self.season_ids is not None:
            # one-hot of the samples' seasons; an id outside 0..3 gives a
            # zero row, as jax.nn.one_hot does
            sid = self.season_ids.index_select(0, idx)
            onehot = (sid[:, None] == self._seasons).to(hr.dtype)[:, None,
                                                                   None, :]
            h_hr, w_hr = (static_hr.shape[1:3] if static_hr is not None
                          else hr.shape[-3:-1])
            parts_aux.append(onehot.expand(b, h_hr, w_hr, 4))
            if self.time_window is None:
                parts_lr.append(onehot.expand(b, *lr.shape[-3:-1], 4))
        lr = torch.cat(parts_lr, dim=-1) if len(parts_lr) > 1 else lr
        aux = (torch.cat(parts_aux, dim=-1) if len(parts_aux) > 1
               else (parts_aux[0] if parts_aux else None))
        return {'lr': lr, 'hr': hr, 'aux': aux}

    def _check_indices(self, idx):
        if idx.numel() and int(idx.max()) + (self.time_window or 1) \
                > self.n_total:
            raise IndexError(f'sample {int(idx.max())} reaches past the '
                             f'{self.n_total} grids')

    def _patch_offsets(self, b, offsets=None, generator=None):
        """Patch offsets (ys, xs) of a batch of b, LR ones (HR for 'pin'),
        as long CPU tensors: `offsets` ([2, b]) checked against the grid,
        or drawn with the CPU `generator`."""
        if self.is_postups:
            max_y = self.lr_y - self.patch_lr
            max_x = self.lr_x - self.patch_lr
        else:
            max_y = self.hr_y - self.patch_size
            max_x = self.hr_x - self.patch_size
        if offsets is None:
            ys = torch.randint(0, max(max_y, 1), (b,), generator=generator)
            xs = torch.randint(0, max(max_x, 1), (b,), generator=generator)
        else:
            ys, xs = (o.to('cpu', torch.long) if isinstance(o, torch.Tensor)
                      else torch.from_numpy(np.array(o, dtype=np.int64))
                      for o in offsets)
            if ys.shape != (b,) or xs.shape != (b,):
                raise ValueError(f'`offsets` must be [2, {b}]')
            if (ys.numel() and (int(ys.min()) < 0 or int(xs.min()) < 0
                                or int(ys.max()) > max_y
                                or int(xs.max()) > max_x)):
                raise IndexError(f'patch offsets outside [0, {max_y}] x '
                                 f'[0, {max_x}]')
        return ys, xs

    def epoch_indices(self, generator, steps=None):
        """Shuffled epoch index matrix [steps, batch_size] on the CPU: one
        permutation of the n samples, repeated when the steps need more
        (dl4ds_tpu/dataloader.py:786-794)."""
        steps = self.n // self.batch_size if steps is None else steps
        perm = torch.randperm(self.n, generator=generator)
        reps = -(-(steps * self.batch_size) // self.n)
        if reps > 1:
            perm = perm.repeat(reps)
        return perm[:steps * self.batch_size].reshape(steps, self.batch_size)

    def _gather_crop(self, data, idx, ys, xs, size):
        """Exact gather + crop of [B(, T), size, size, C] patches at the
        offsets (ys, xs) of data [N, Y, X, C]: one advanced index, which
        moves only the patches."""
        rows, cols = _crop_index(ys, xs, size)
        if self.time_window is None:
            return data[idx[:, None, None], rows[:, :, None],
                        cols[:, None, :]]
        win = idx[:, None] + torch.arange(self.time_window,
                                          device=idx.device)[None, :]
        return data[win[:, :, None, None], rows[:, None, :, None],
                    cols[:, None, None, :]]

    def _gather(self, data, idx):
        """Samples `idx` of `data` [N, ...]; with time windows [B, T, ...]
        (dl4ds_tpu/dataloader.py:629-635)."""
        if self.time_window is None:
            return data.index_select(0, idx)
        win = idx[:, None] + torch.arange(self.time_window,
                                          device=idx.device)[None, :]
        return data.index_select(0, win.reshape(-1)).reshape(
            idx.shape[0], self.time_window, *data.shape[1:])


def _to_device(t, device):
    """Move a small CPU tensor to `device`. To a GPU through pinned memory
    and without blocking: a pageable copy would make the host wait for the
    device at every batch."""
    if device.type == 'cuda' and t.device.type == 'cpu':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _crop_index(ys, xs, size):
    """Row and column indices [B, size] of patches at offsets (ys, xs)."""
    ar = torch.arange(size, device=ys.device)
    return ys[:, None] + ar, xs[:, None] + ar


def _prep_aux_inputs(lr_hw, interpolation, device, predictors=None,
                     static_vars=None, hr_hw=None):
    """Concat the predictors and move them to the LR grid, and then to the
    HR grid `hr_hw` where given ('pin'); stack the static variables to [y,
    x, S]. Returns (pred, n_pred, statics, n_static) as tensors on
    `device` or None (dl4ds_tpu/dataloader.py:797-820)."""
    pred, n_pred = None, 0
    if predictors is not None:
        pred = (np.concatenate([_values(p) for p in predictors], axis=-1)
                if isinstance(predictors, (list, tuple))
                else _values(predictors))
        pred = torch.as_tensor(np.asarray(pred, 'float32'), device=device)
        n_pred = pred.shape[-1]
        if tuple(pred.shape[1:3]) != tuple(lr_hw):
            pred = resize2d(pred, lr_hw, interpolation)
        if hr_hw is not None:
            pred = resize2d(pred, hr_hw, interpolation)
    statics, n_static = None, 0
    if static_vars is not None:
        statics = np.stack([np.squeeze(np.asarray(_values(s), 'float32'))
                            for s in static_vars], axis=-1)
        statics = torch.as_tensor(statics, device=device)
        n_static = statics.shape[-1]
    return pred, n_pred, statics, n_static
