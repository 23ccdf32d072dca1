"""
The three data tiers of `dl4ds_tpu/dataloader.py` and the season encoding
of time metadata: device batch synthesis (`BatchSynthesizer`), the
streaming tier for datasets larger than the device (`HostStreamer`), and
the reference's numpy host tier (`create_pair_hr_lr`, `create_batch_hr_lr`,
`DataGenerator`).

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

The streaming tier keeps the dataset on the host (RAM or a memmap),
gathers and crops each batch there with the native kernels (`native`) into
pinned memory and builds the rest of the batch on the device after the
copy; the host tier builds each sample in numpy with the reference's
semantics and draws.

Season ids come from time metadata through numpy's datetime64 alone
(`season_ids_from_time`), as the JAX package's come through pandas.
"""

import warnings

import numpy as np
import torch

from . import POSTUPSAMPLING_METHODS, native
from .interpolation import resize2d, resize_array
from .utils import _values, checkarray_ndim, crop_array, resolve_device

__all__ = ['create_pair_hr_lr', 'create_batch_hr_lr', 'DataGenerator',
           'BatchSynthesizer', 'HostStreamer', '_get_season_',
           '_get_season_array_', 'season_ids_from_time']


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

    `shard` = (rank, ranks) makes this a data-parallel rank's synthesizer,
    the counterpart of the JAX batch-axis sharding: `batch_size` is the
    global batch, every rank draws the same global `plan` from the same
    generator, and rank r builds its batches from columns [r*b, (r+1)*b)
    of each row, b = batch_size // ranks (`local_part`, `plan_buffers`).
    """

    def __init__(self, array, array_lr, upsampling, scale, batch_size,
                 patch_size=None, time_window=None, static_vars=None,
                 predictors=None, interpolation='inter_area',
                 season_ids=None, device='cuda', shard=None):
        array = np.asarray(_values(array), 'float32')
        if array.ndim != 4:
            raise ValueError('`array` must be [n, y, x, c]')
        self.device = resolve_device(device)
        self.shard, self.local_batch_size = _check_shard(shard, batch_size)
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
        """Zeroed device buffers for `steps` rows of this rank's part of a
        plan (a valid plan: sample 0 at offset 0)."""
        keys = ('idx',) + (('ys', 'xs') if self.patch_size is not None
                           else ())
        return {k: torch.zeros((steps, self.local_batch_size),
                               dtype=torch.long, device=self.device)
                for k in keys}

    def local_part(self, plan):
        """This rank's columns of a global plan (`plan`'s); the plan itself
        without `shard`."""
        rank, _ = self.shard
        b = self.local_batch_size
        if b == self.batch_size:
            return plan
        return {k: v[:, rank * b:(rank + 1) * b] for k, v in plan.items()}

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


def _check_shard(shard, batch_size):
    """(shard, local batch size) of a synthesizer's `shard` argument:
    (rank, ranks), the global batch an even multiple of the ranks."""
    if shard is None:
        return (0, 1), int(batch_size)
    rank, ranks = (int(v) for v in shard)
    if not 0 <= rank < ranks or batch_size % ranks:
        raise ValueError(f'`shard` must be (rank, ranks) with 0 <= rank < '
                         f'ranks dividing batch_size={batch_size}; got '
                         f'{shard}')
    return (rank, ranks), int(batch_size) // ranks


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


def _concat_predictors(predictors):
    """The predictors (a list of [n, y, x, c] arrays, or one array)
    concatenated on the channel axis, float32 numpy."""
    pred = (np.concatenate([_values(p) for p in predictors], axis=-1)
            if isinstance(predictors, (list, tuple))
            else _values(predictors))
    return np.asarray(pred, 'float32')


def _stack_statics(static_vars):
    """The static variables stacked to [y, x, S], float32 numpy."""
    return np.stack([np.squeeze(np.asarray(_values(s), 'float32'))
                     for s in static_vars], axis=-1)


def _prep_aux_inputs(lr_hw, interpolation, device, predictors=None,
                     static_vars=None, hr_hw=None):
    """Concat the predictors and move them to the LR grid, and then to the
    HR grid `hr_hw` where given ('pin'); stack the static variables to [y,
    x, S]. Returns (pred, n_pred, statics, n_static) as tensors on
    `device` or None (dl4ds_tpu/dataloader.py:797-820)."""
    pred, n_pred = None, 0
    if predictors is not None:
        pred = torch.as_tensor(_concat_predictors(predictors), device=device)
        n_pred = pred.shape[-1]
        if tuple(pred.shape[1:3]) != tuple(lr_hw):
            pred = resize2d(pred, lr_hw, interpolation)
        if hr_hw is not None:
            pred = resize2d(pred, hr_hw, interpolation)
    statics, n_static = None, 0
    if static_vars is not None:
        statics = torch.as_tensor(_stack_statics(static_vars), device=device)
        n_static = statics.shape[-1]
    return pred, n_pred, statics, n_static


# -----------------------------------------------------------------------------
# Host compat tier (dl4ds_tpu/dataloader.py:101-451, reference:
# dl4ds/dataloader.py:11-505): numpy alone, the global np.random's draws
# in the JAX package's order
# -----------------------------------------------------------------------------

def create_pair_hr_lr(array, array_lr, upsampling, scale, patch_size,
                      static_vars=None, predictors=None, season=None,
                      debug=False, interpolation='inter_area'):
    """One (HR, LR[, aux]) sample with the reference's semantics, as the
    JAX package's `create_pair_hr_lr` (dl4ds_tpu/dataloader.py:101-333): a
    random patch crop (`crop_array` on the global np.random, the same
    draws in the same order), the HR->LR coarsening (or a given LR), the
    pre-upsampling re-interpolation for 'pin', and the channels of the
    predictors, static variables and season. Its reference quirks stay:
    the ValueError on the spatio-temporal patch configurations that the
    reference crops wrongly, and the RuntimeWarning where the statics are
    cropped at LR origins on the HR grid."""
    hr_array = np.asarray(array)
    lr_is_given = array_lr is not None
    lr_array = np.asarray(array_lr) if lr_is_given else None

    is_spatiotemp = hr_array.ndim == 4
    hr_y, hr_x = (hr_array.shape[1:3] if is_spatiotemp
                  else hr_array.shape[0:2])
    ndim = 4 if is_spatiotemp else 3

    # the reference squeezes a [T, H, W, 1] window to rank 3 before
    # cropping, so crop_array crops the (time, y) axes: the device tiers
    # handle these configurations, this tier refuses them
    if is_spatiotemp and patch_size is not None and (
            upsampling == 'pin' or lr_is_given or predictors is not None):
        raise ValueError(
            'spatio-temporal patch cropping with pin / explicit LR / '
            'predictors is a reference-broken configuration in the '
            'host-compat tier (the reference crops the squeezed [t, y, x] '
            'stack as [y, x, c]); use BatchSynthesizer or HostStreamer')

    crop_y = crop_x = None
    patch_size_lr = None
    lr_array_predictors = None

    if upsampling == 'pin':
        if lr_is_given:
            lr_y, lr_x = (lr_array.shape[1:3] if is_spatiotemp
                          else lr_array.shape[0:2])
            if is_spatiotemp:
                lr_array = checkarray_ndim(lr_array, 4, -1)
            lr_resized = resize_array(lr_array, (hr_x, hr_y), interpolation,
                                      squeezed=False)
        else:
            lr_x, lr_y = int(hr_x / scale), int(hr_y / scale)
            lr_resized = resize_array(hr_array, (lr_x, lr_y), interpolation,
                                      squeezed=False)
            lr_resized = resize_array(lr_resized, (hr_x, hr_y), interpolation,
                                      squeezed=False)
        if patch_size is not None:
            hr_array, crop_y, crop_x = crop_array(
                np.squeeze(hr_array), patch_size, yx=None, position=True)
            lr_array = crop_array(np.squeeze(lr_resized), patch_size,
                                  yx=(crop_y, crop_x))
        else:
            lr_array = lr_resized
        hr_array = checkarray_ndim(hr_array, ndim, -1)
        lr_array = checkarray_ndim(lr_array, ndim, -1)

        if predictors is not None:
            predictors = np.asarray(predictors)
            pred_hw = (predictors.shape[1:3] if predictors.ndim == 4
                       else predictors.shape[0:2])
            if pred_hw != (lr_y, lr_x):
                predictors = resize_array(predictors, (lr_x, lr_y),
                                          interpolation)
            predictors = resize_array(predictors, (hr_x, hr_y), interpolation)
            predictors = checkarray_ndim(predictors, ndim, -1)
            if patch_size is not None:
                lr_array_predictors, crop_y, crop_x = crop_array(
                    predictors, patch_size, yx=(crop_y, crop_x), position=True)
            else:
                lr_array_predictors = predictors
            lr_array_predictors = checkarray_ndim(lr_array_predictors, ndim,
                                                  -1)
            lr_array = np.concatenate([lr_array, lr_array_predictors], axis=-1)

    elif upsampling in POSTUPSAMPLING_METHODS:
        if patch_size is not None:
            patch_size_lr = int(patch_size / scale)
        if lr_is_given:
            lr_y, lr_x = (lr_array.shape[1:3] if is_spatiotemp
                          else lr_array.shape[0:2])
        else:
            lr_x, lr_y = int(hr_x / scale), int(hr_y / scale)

        if predictors is not None:
            predictors = np.asarray(predictors)
            pred_hw = (predictors.shape[1:3] if predictors.ndim == 4
                       else predictors.shape[0:2])
            if pred_hw != (lr_y, lr_x):
                lr_array_predictors = resize_array(predictors, (lr_x, lr_y),
                                                   interpolation)
            else:
                lr_array_predictors = predictors
            lr_array_predictors = checkarray_ndim(lr_array_predictors, ndim,
                                                  -1)
            if patch_size is not None:
                lr_array_predictors, crop_y, crop_x = crop_array(
                    lr_array_predictors, patch_size_lr, yx=None, position=True)
                crop_y_hr, crop_x_hr = crop_y * scale, crop_x * scale
                hr_array = crop_array(np.squeeze(hr_array), patch_size,
                                      yx=(crop_y_hr, crop_x_hr))
                if lr_is_given:
                    lr_array = crop_array(lr_array, patch_size_lr,
                                          yx=(crop_y, crop_x))
            if not lr_is_given:
                new_xy = ((patch_size_lr, patch_size_lr) if patch_size
                          is not None else (lr_x, lr_y))
                lr_array = resize_array(hr_array, new_xy, interpolation,
                                        squeezed=False)
            hr_array = checkarray_ndim(hr_array, ndim, -1)
            lr_array = checkarray_ndim(lr_array, ndim, -1)
            lr_array_predictors = checkarray_ndim(lr_array_predictors, ndim,
                                                  -1)
            lr_array = np.concatenate([lr_array, lr_array_predictors], axis=-1)
        else:
            if patch_size is not None:
                if lr_is_given:
                    lr_array, crop_y, crop_x = crop_array(
                        lr_array, patch_size_lr, yx=None, position=True)
                    crop_y_hr, crop_x_hr = crop_y * scale, crop_x * scale
                    hr_array = crop_array(np.squeeze(hr_array), patch_size,
                                          yx=(crop_y_hr, crop_x_hr))
                else:
                    hr_array, crop_y, crop_x = crop_array(
                        hr_array, patch_size, yx=None, position=True)
                    lr_array = resize_array(
                        hr_array, (patch_size_lr, patch_size_lr),
                        interpolation)
            elif not lr_is_given:
                lr_array = resize_array(hr_array, (lr_x, lr_y),
                                        interpolation)
            hr_array = checkarray_ndim(hr_array, ndim, -1)
            lr_array = checkarray_ndim(lr_array, ndim, -1)
    else:
        raise ValueError(f'`upsampling` not recognized: {upsampling}')

    # static variables and season channels
    is_postups = upsampling in POSTUPSAMPLING_METHODS
    static_array_hr = []
    if static_vars is not None:
        if (is_postups and patch_size is not None
                and (lr_is_given or predictors is not None)):
            # kept from the reference (dl4ds/dataloader.py:54): crop_y and
            # crop_x are LR origins here, and the HR statics are cropped at
            # them; the device tiers align the statics
            warnings.warn(
                'host-compat tier: static_vars patches are cropped at '
                'LR-coordinate origins on the HR grid in this configuration '
                '(reference-parity bug, dl4ds/dataloader.py:54); use '
                'BatchSynthesizer or HostStreamer for aligned statics',
                RuntimeWarning, stacklevel=2)
        for var in static_vars:
            var = np.asarray(var)
            if patch_size is not None:
                var_hr = crop_array(np.squeeze(var), patch_size,
                                    yx=(crop_y, crop_x))
                var_hr = checkarray_ndim(var_hr, 3, -1)
                var_lr = (resize_array(var_hr,
                                       (patch_size_lr, patch_size_lr),
                                       interpolation)
                          if is_postups else var_hr)
            else:
                var_hr = checkarray_ndim(var, 3, -1)
                var_lr = (resize_array(var, (lr_x, lr_y), interpolation)
                          if is_postups else var_hr)
            var_lr = checkarray_ndim(var_lr, 3, -1)
            static_array_hr.append(var_hr)
            if not is_spatiotemp:
                lr_array = np.concatenate([lr_array, var_lr], axis=-1)
        static_array_hr = np.concatenate(static_array_hr, axis=-1)

    if season is not None:
        if patch_size is not None:
            hr_sz = (patch_size, patch_size)
            lr_sz = ((patch_size_lr, patch_size_lr) if is_postups
                     else (patch_size, patch_size))
        else:
            hr_sz = (hr_y, hr_x)
            lr_sz = (lr_y, lr_x) if is_postups else (hr_y, hr_x)
        season_array_hr = _get_season_array_(season, *hr_sz)
        season_array_lr = _get_season_array_(season, *lr_sz)
        static_array_hr = (np.concatenate([static_array_hr, season_array_hr],
                                          axis=-1)
                           if static_vars is not None else season_array_hr)
        if not is_spatiotemp:
            lr_array = np.concatenate([lr_array, season_array_lr], axis=-1)

    hr_array = np.asarray(hr_array, 'float32')
    lr_array = np.asarray(lr_array, 'float32')
    has_aux = static_vars is not None or season is not None
    if has_aux:
        static_array_hr = np.asarray(static_array_hr, 'float32')

    if debug:
        _print_pair(hr_array, lr_array, static_array_hr if has_aux else None,
                    None if patch_size is None else (crop_x, crop_y))

    if has_aux:
        return hr_array, lr_array, static_array_hr
    return hr_array, lr_array


def _print_pair(hr, lr, aux, crop_xy):
    """`create_pair_hr_lr(debug=True)`'s diagnostics: the shapes and the
    crop origin, then the panels of the HR and LR channels saved to
    dl4ds_pair_debug.png, best effort (dl4ds_tpu/dataloader.py:300-330)."""
    if aux is not None:
        print(f'HR array: {hr.shape}, LR array: {lr.shape}, '
              f'Auxiliary array: {aux.shape}')
    else:
        print(f'HR array: {hr.shape}, LR array: {lr.shape}')
    if crop_xy is not None:
        print(f'Crop X,Y: {crop_xy[0]}, {crop_xy[1]}')
    try:
        from .utils import plot_ndarray
        panels = [('HR array', np.squeeze(hr))]
        lr2d = np.squeeze(lr)
        if lr2d.ndim == 3:
            panels += [(f'LR array, variable {ci + 1}', lr2d[..., ci])
                       for ci in range(lr2d.shape[-1])]
        else:
            panels.append(('LR array', lr2d))
        imgs = []
        for _, img in panels:
            while img.ndim > 2:
                img = img[0]
            imgs.append(img)
        plot_ndarray(tuple(imgs), subplot_titles=[t for t, _ in panels],
                     save_fname='dl4ds_pair_debug.png')
    except Exception:  # noqa: BLE001 — the panels are a debugging aid
        pass


def create_batch_hr_lr(all_indices, index, array, array_lr, upsampling,
                       scale=4, batch_size=32, patch_size=None,
                       time_window=None, static_vars=None, predictors=None,
                       interpolation='inter_area', time_metadata=None):
    """Batch `index` of `all_indices`: `create_pair_hr_lr` over each of its
    samples (a window of `time_window` grids each), the season from
    `time_metadata` (dl4ds_tpu/dataloader.py:335-373). Returns ([lr(,
    aux)], [hr])."""
    batch_idx = all_indices[index * batch_size:(index + 1) * batch_size]
    batch_hr, batch_lr, batch_aux = [], [], []
    season_i = None
    for i in batch_idx:
        if time_window is None:
            take = i
        else:
            take = slice(i, i + time_window)
        data_i = array[take]
        data_lr_i = None if array_lr is None else array_lr[take]
        pred_i = None if predictors is None else predictors[take]
        season_i = (_get_season_(time_metadata[take], time_window)
                    if time_metadata is not None else None)
        res = create_pair_hr_lr(
            array=data_i, array_lr=data_lr_i, upsampling=upsampling,
            scale=scale, patch_size=patch_size, static_vars=static_vars,
            season=season_i, interpolation=interpolation, predictors=pred_i)
        if static_vars is not None or season_i is not None:
            hr_i, lr_i, aux_i = res
            batch_aux.append(aux_i)
        else:
            hr_i, lr_i = res
        batch_hr.append(hr_i)
        batch_lr.append(lr_i)
    batch_lr = np.asarray(batch_lr)
    batch_hr = np.asarray(batch_hr)
    if static_vars is not None or season_i is not None:
        return [batch_lr, np.asarray(batch_aux)], [batch_hr]
    return [batch_lr], [batch_hr]


class DataGenerator:
    """Shuffled epoch iterator over host-built batches, the contract of the
    reference's keras Sequence (dl4ds_tpu/dataloader.py:376-451):
    `__len__` is n_samples // batch_size (times `repeat`, an int or None),
    `__getitem__(index)` returns ([lr(, aux)], [hr]); the permutation comes
    from np.random.default_rng(seed). `time_metadata` gives the season
    channels: datetime-like [N] values, or 'auto' for `array`'s xr time
    coordinate."""

    def __init__(self, array, array_lr, backbone, upsampling, scale,
                 batch_size=32, patch_size=None, time_window=None,
                 static_vars=None, predictors=None,
                 interpolation='inter_area', repeat=None, seed=None,
                 time_metadata=None):
        if isinstance(time_metadata, str):
            if time_metadata != 'auto':
                raise ValueError(f'unknown time_metadata={time_metadata!r}; '
                                 f"pass datetimes or 'auto'")
            time_metadata = _time_coord(array)
            if time_metadata is None:
                raise ValueError("time_metadata='auto' requires `array` to "
                                 "be an xr.DataArray with a time coordinate")
        self.time_metadata = (np.asarray(_values(time_metadata))
                              if time_metadata is not None else None)
        self.array = _values(array)
        self.array_lr = _values(array_lr)
        self.batch_size = batch_size
        self.scale = scale
        self.upsampling = upsampling
        self.backbone = backbone
        self.patch_size = patch_size
        self.time_window = time_window
        self.static_vars = ([_values(s) for s in static_vars]
                            if static_vars is not None else None)
        self.predictors = (np.concatenate([_values(p) for p in predictors],
                                          axis=-1)
                           if predictors is not None else None)
        self.interpolation = interpolation
        if repeat is not None and not isinstance(repeat, int):
            raise TypeError('`repeat` must be an int (or None)')
        self.repeat = repeat
        self.n = (self.array.shape[0] - time_window if time_window is not None
                  else self.array.shape[0])
        self.indices = np.random.default_rng(seed).permutation(
            np.arange(self.n))
        if self.repeat is not None:
            self.indices = np.hstack([self.indices] * self.repeat)
        if patch_size is not None and upsampling in POSTUPSAMPLING_METHODS \
                and patch_size % scale != 0:
            raise ValueError('`patch_size` must be divisible by `scale`')

    def __len__(self):
        n_batches = self.n // self.batch_size
        return n_batches * self.repeat if self.repeat else n_batches

    def __getitem__(self, index):
        return create_batch_hr_lr(
            self.indices, index, self.array, self.array_lr,
            upsampling=self.upsampling, scale=self.scale,
            batch_size=self.batch_size, patch_size=self.patch_size,
            time_window=self.time_window, static_vars=self.static_vars,
            predictors=self.predictors, interpolation=self.interpolation,
            time_metadata=self.time_metadata)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


# -----------------------------------------------------------------------------
# Streaming tier (dl4ds_tpu/dataloader.py:797-1109)
# -----------------------------------------------------------------------------

def _resize_chunked(arr, hw, interpolation, device, chunk=64):
    """A whole dataset [n, y, x, c] resized to `hw` on `device`, `chunk`
    grids at a time, the result on the host (float32 numpy): the streaming
    tier's one-time preprocessing, for datasets that do not fit on the
    device."""
    outs = []
    for i in range(0, arr.shape[0], chunk):
        x = torch.as_tensor(np.asarray(arr[i:i + chunk], np.float32),
                            device=device)
        outs.append(resize2d(x, hw, interpolation).cpu().numpy())
    return np.ascontiguousarray(np.concatenate(outs, axis=0))


class HostStreamer:
    """Host -> device batch pipeline for datasets larger than device
    memory (dl4ds_tpu/dataloader.py:838-1109), with the JAX signature and
    `device` (CUDA unless device='cpu' is asked for).

    The dataset stays in host RAM, or on disk: a contiguous float32
    `np.memmap` (`np.load(path, mmap_mode='r')`) is kept as a view, never
    copied, and the gather reads only the pages of the patches. Each
    batch's windows are gathered and cropped by the native OpenMP kernels
    (`native`) straight into a pinned host slot; a producer thread fills
    the slots `prefetch` batches ahead and touches no CUDA state. The
    consumer copies each slot to the device on a side stream (non_blocking)
    and records an event, which the current stream waits on; a slot is
    filled again only after its event has completed (a ring of `prefetch
    + 1` slots). The LR coarsening of implicit pairs, the LR statics and
    the season one-hot run on the device after the copy (`build`), so
    only patches cross PCIe; full-grid statics are copied to the device
    once and broadcast.

    The host half equals the JAX package's under the same seed: one
    np.random.default_rng(seed), an epoch's permutation, then each batch's
    ys and xs (LR origins, HR ones for 'pin'). For 'pin' the pre-upsampled
    LR field is computed once for the whole dataset (`lr_pre`, on the
    host), as the device tier's.

    `stream` yields each batch's raw device tensors ('hr', 'lr', 'pred',
    'static', 'sid': the present ones), which `build` turns into the
    batch dict; `epochs` yields the dicts. A trainer copies the raw
    tensors into the input buffers of a captured step (`plan_buffers`,
    `step_batch`, as a `BatchSynthesizer`'s plan). With `shard` = (rank,
    ranks) every rank streams the same global batches (`batch_size` wide,
    from the same `seed`), and rank r copies rows [r*b, (r+1)*b) of each,
    b = batch_size // ranks, into buffers of its width (`local_part`,
    `plan_buffers`)."""

    def __init__(self, array, upsampling, scale, batch_size, patch_size=None,
                 time_window=None, interpolation='inter_area', prefetch=2,
                 seed=0, array_lr=None, static_vars=None, predictors=None,
                 season_ids=None, device='cuda', shard=None):
        self.device = resolve_device(device)
        self.shard, self.local_batch_size = _check_shard(shard, batch_size)
        self.array = np.ascontiguousarray(_values(array), 'float32')
        if self.array.ndim != 4:
            raise ValueError('`array` must be [n, y, x, c]')
        self.array_lr = (np.ascontiguousarray(_values(array_lr), 'float32')
                         if array_lr is not None else None)
        self.upsampling = upsampling
        self.is_postups = upsampling in POSTUPSAMPLING_METHODS
        self.scale = int(scale)
        self.batch_size = int(batch_size)
        self.patch_size = patch_size
        self.time_window = time_window
        self.interpolation = interpolation
        if prefetch < 1:
            raise ValueError('`prefetch` must be >= 1')
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        n_total, self.hr_y, self.hr_x, _ = self.array.shape
        self.n = n_total - time_window if time_window is not None else n_total
        if patch_size is not None and self.is_postups \
                and patch_size % scale != 0:
            raise ValueError('`patch_size` must be divisible by `scale`')
        if patch_size is not None and patch_size > min(self.hr_y, self.hr_x):
            raise ValueError(
                f'patch_size={patch_size} exceeds the HR grid '
                f'({self.hr_y}x{self.hr_x}) — the native gather would read '
                f'out of bounds')
        if self.array_lr is not None:
            self.lr_y, self.lr_x = self.array_lr.shape[1:3]
        else:
            self.lr_y = self.hr_y // self.scale
            self.lr_x = self.hr_x // self.scale

        def resize(a, hw):
            return _resize_chunked(a, hw, interpolation, self.device)
        self.lr_pre = None
        if upsampling == 'pin':
            base = (self.array_lr if self.array_lr is not None
                    else resize(self.array, (self.lr_y, self.lr_x)))
            self.lr_pre = resize(base, (self.hr_y, self.hr_x))
        self.pred, self.n_pred = None, 0
        if predictors is not None:
            self.pred = _concat_predictors(predictors)
            self.n_pred = self.pred.shape[-1]
            if tuple(self.pred.shape[1:3]) != (self.lr_y, self.lr_x):
                self.pred = resize(self.pred, (self.lr_y, self.lr_x))
            if upsampling == 'pin':
                self.pred = resize(self.pred, (self.hr_y, self.hr_x))
            self.pred = np.ascontiguousarray(self.pred, 'float32')
        self.static_hr, self.n_static = None, 0
        if static_vars is not None:
            self.static_hr = _stack_statics(static_vars)
            self.n_static = self.static_hr.shape[-1]
        self.season_ids = (np.asarray(season_ids, np.int32)
                           if season_ids is not None else None)
        if self.season_ids is not None and len(self.season_ids) < self.n:
            raise ValueError(
                f'season_ids has {len(self.season_ids)} entries but the '
                f'sampler draws indices up to {self.n - 1}')
        # full-grid statics go to the device once (and their LR resize,
        # for spatial post-upsampling samples), to be broadcast there
        self._static_hr_dev = self._static_lr_dev = None
        if self.static_hr is not None and patch_size is None:
            self._static_hr_dev = torch.as_tensor(self.static_hr,
                                                  device=self.device)
            if self.is_postups and time_window is None:
                self._static_lr_dev = resize2d(
                    self._static_hr_dev[None], (self.lr_y, self.lr_x),
                    interpolation)[0]
        self._seasons = torch.arange(4, device=self.device)
        self._slots = None

    # -- the host half ---------------------------------------------------
    def _raw_shapes(self):
        """{name: (shape, torch dtype)} of a batch's raw arrays."""
        b, p = self.batch_size, self.patch_size
        f32 = torch.float32
        tw = self.time_window or 1
        win = (tw,) if tw > 1 else ()
        hr_hw = (p, p) if p is not None else (self.hr_y, self.hr_x)
        lr_hw = (p // self.scale,) * 2 if p is not None else (self.lr_y,
                                                              self.lr_x)
        shapes = {'hr': ((b,) + win + hr_hw + self.array.shape[3:], f32)}
        if self.lr_pre is not None:
            shapes['lr'] = ((b,) + win + hr_hw + self.lr_pre.shape[3:], f32)
        elif self.array_lr is not None:
            shapes['lr'] = ((b,) + win + lr_hw + self.array_lr.shape[3:],
                            f32)
        if self.pred is not None:
            pred_hw = (lr_hw if self.is_postups else hr_hw)
            shapes['pred'] = ((b,) + win + pred_hw + (self.n_pred,), f32)
        if self.static_hr is not None and p is not None:
            shapes['static'] = ((b, p, p, self.n_static), f32)
        if self.season_ids is not None:
            shapes['sid'] = ((b,), torch.long)
        return shapes

    def _host_batch(self, idx, out=None):
        """The host half of the batch of samples `idx`: its patch origins
        drawn (ys, then xs), its windows gathered and cropped. Returns (hr,
        lr, pred, static_hr, sid) as the JAX `_host_batch` does (numpy;
        None where absent; static_hr None for full grids, whose statics
        the device half broadcasts), written into the arrays of `out`
        ({name: array}, a slot) when given."""
        out = out or {}
        p = self.patch_size
        tw = self.time_window or 1
        b = idx.shape[0]
        lr = pred = static_hr = None
        if p is not None:
            plr = p // self.scale
            if self.is_postups:
                # LR origins, the device tier's semantics
                ys = self.rng.integers(0, max(self.lr_y - plr, 1), size=b)
                xs = self.rng.integers(0, max(self.lr_x - plr, 1), size=b)
                ys_hr, xs_hr = ys * self.scale, xs * self.scale
                hr = native.gather_crop(self.array, idx, ys_hr, xs_hr, p, tw,
                                        out=out.get('hr'))
                if self.array_lr is not None:
                    lr = native.gather_crop(self.array_lr, idx, ys, xs, plr,
                                            tw, out=out.get('lr'))
                if self.pred is not None:
                    pred = native.gather_crop(self.pred, idx, ys, xs, plr, tw,
                                              out=out.get('pred'))
            else:
                ys_hr = self.rng.integers(0, max(self.hr_y - p, 1), size=b)
                xs_hr = self.rng.integers(0, max(self.hr_x - p, 1), size=b)
                hr = native.gather_crop(self.array, idx, ys_hr, xs_hr, p, tw,
                                        out=out.get('hr'))
                lr = native.gather_crop(self.lr_pre, idx, ys_hr, xs_hr, p,
                                        tw, out=out.get('lr'))
                if self.pred is not None:
                    pred = native.gather_crop(self.pred, idx, ys_hr, xs_hr, p,
                                              tw, out=out.get('pred'))
            if self.static_hr is not None:
                # the one statics grid cropped at each sample's origin
                static_hr = native.gather_crop(
                    self.static_hr[None], np.zeros(b, np.int64), ys_hr,
                    xs_hr, p, out=out.get('static'))
        else:
            hr = native.gather_windows(self.array, idx, tw,
                                       out=out.get('hr'))
            src_lr = self.lr_pre if self.lr_pre is not None else self.array_lr
            if src_lr is not None:
                lr = native.gather_windows(src_lr, idx, tw,
                                           out=out.get('lr'))
            if self.pred is not None:
                pred = native.gather_windows(self.pred, idx, tw,
                                             out=out.get('pred'))
        sid = None
        if self.season_ids is not None:
            sid = self.season_ids[idx]
            if 'sid' in out:
                out['sid'][:] = sid
        return hr, lr, pred, static_hr, sid

    # -- the device half -------------------------------------------------
    def build(self, hr, lr=None, pred=None, static=None, sid=None):
        """The batch dict of a batch's raw device tensors (`stream`'s):
        the LR input (given, or `hr` coarsened to the LR grid) with the
        predictors, LR statics and season channels, and the aux input of
        the HR statics (the patches `static`, or the full grid broadcast)
        and the season one-hot (dl4ds_tpu/dataloader.py:985-1046). Device
        work only, so that it can be captured in a CUDA graph."""
        tw = self.time_window
        h, w = hr.shape[-3], hr.shape[-2]
        if lr is None:
            lr = resize2d(hr, (h // self.scale, w // self.scale),
                          self.interpolation)
        b = hr.shape[0]
        h_lr, w_lr = lr.shape[-3], lr.shape[-2]
        parts_lr = [lr] + ([pred] if pred is not None else [])
        aux_parts = []
        if self.static_hr is not None:
            full_grid = static is None
            static_hr = (self._static_hr_dev.expand(
                b, *self._static_hr_dev.shape) if full_grid else static)
            aux_parts.append(static_hr)
            if tw is None:
                if not self.is_postups:
                    static_lr = static_hr
                elif full_grid:
                    static_lr = self._static_lr_dev.expand(
                        b, *self._static_lr_dev.shape)
                else:
                    static_lr = resize2d(static_hr, (h_lr, w_lr),
                                         self.interpolation)
                parts_lr.append(static_lr)
        if sid is not None:
            onehot = (sid[:, None] == self._seasons).to(hr.dtype)[:, None,
                                                                   None, :]
            aux_parts.append(onehot.expand(b, h, w, 4))
            if tw is None:
                parts_lr.append(onehot.expand(b, h_lr, w_lr, 4))
        lr = torch.cat(parts_lr, dim=-1) if len(parts_lr) > 1 else lr
        aux = (torch.cat(aux_parts, dim=-1) if len(aux_parts) > 1
               else (aux_parts[0] if aux_parts else None))
        return {'lr': lr, 'hr': hr, 'aux': aux}

    def plan_buffers(self, steps=None):
        """Zeroed device tensors of this rank's part of a batch's raw
        inputs (a valid batch), the input buffers of a captured step;
        `steps` is ignored, one batch at a time streams through them."""
        return {k: torch.zeros((self.local_batch_size,) + shape[1:],
                               dtype=dtype, device=self.device)
                for k, (shape, dtype) in self._raw_shapes().items()}

    def local_part(self, raw):
        """This rank's rows of a streamed global batch (`stream`'s); the
        batch itself without `shard`."""
        rank, _ = self.shard
        b = self.local_batch_size
        if b == self.batch_size:
            return raw
        return {k: v[rank * b:(rank + 1) * b] for k, v in raw.items()}

    def step_batch(self, plan, row=None):
        """The batch of the raw tensors in `plan` (`plan_buffers`)."""
        return self.build(**plan)

    # -- the pipeline ----------------------------------------------------
    def _ring(self):
        """The `prefetch + 1` host slots, pinned on a CUDA device:
        [{name: tensor}], allocated once."""
        if self._slots is None:
            pin = self.device.type == 'cuda'
            self._slots = [
                {k: torch.empty(shape, dtype=dtype, pin_memory=pin)
                 for k, (shape, dtype) in self._raw_shapes().items()}
                for _ in range(self.prefetch + 1)]
        return self._slots

    def stream(self, n_epochs=1, steps=None):
        """Yield `steps` batches an epoch (default n // batch_size) for
        `n_epochs` epochs, each as its raw device tensors {name: tensor}.
        Each epoch draws a permutation and wraps around it. A producer
        error is raised here; leaving early stops and joins the producer.
        A yielded batch stays valid while the caller holds it."""
        import collections
        import queue
        import threading

        steps = self.n // self.batch_size if steps is None else steps
        slots = self._ring()
        arrays = [{k: v.numpy() for k, v in slot.items()} for slot in slots]
        free, ready = queue.Queue(), queue.Queue()
        for i in range(len(slots)):
            free.put(i)
        cancel = threading.Event()
        done = object()

        def take_free():
            while not cancel.is_set():
                try:
                    return free.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        def producer():
            try:
                for _ in range(n_epochs):
                    perm = self.rng.permutation(self.n)
                    for i in range(steps):
                        slot = take_free()
                        if slot is None:
                            return
                        # wrap around the permutation, as the device
                        # tier's epoch_indices
                        pos = np.arange(i * self.batch_size,
                                        (i + 1) * self.batch_size) % self.n
                        idx = np.take(perm, pos).astype(np.int64)
                        self._host_batch(idx, arrays[slot])
                        ready.put(slot)
                ready.put(done)
            except BaseException as exc:  # noqa: BLE001 — raised below
                ready.put(exc)

        cuda = self.device.type == 'cuda'
        copier = torch.cuda.Stream(self.device) if cuda else None
        inflight = collections.deque()     # (slot, event of its copy)

        def release(wait=False):
            while inflight and (wait or inflight[0][1].query()):
                slot, event = inflight.popleft()
                event.synchronize()
                free.put(slot)
                wait = False

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                release()
                if inflight and ready.empty() and free.empty():
                    # the producer may be waiting for a slot in flight
                    release(wait=True)
                    continue
                item = ready.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                if not cuda:
                    batch = {k: v.clone() for k, v in slots[item].items()}
                    free.put(item)
                    yield batch
                    continue
                # fresh device tensors, so the copy need not wait for the
                # work queued on the current stream: it overlaps the step
                main = torch.cuda.current_stream(self.device)
                with torch.cuda.stream(copier):
                    batch = {k: v.to(self.device, non_blocking=True)
                             for k, v in slots[item].items()}
                    event = torch.cuda.Event()
                    event.record(copier)
                main.wait_event(event)
                for v in batch.values():
                    v.record_stream(main)
                inflight.append((item, event))
                yield batch
        finally:
            cancel.set()
            thread.join(timeout=10.0)
            for _, event in inflight:
                event.synchronize()

    def epochs(self, n_epochs=1, steps=None):
        """Yield the batch dicts (lr/hr/aux device tensors, as a
        `BatchSynthesizer`'s) of `stream`'s batches."""
        for raw in self.stream(n_epochs, steps):
            yield self.build(**raw)
