"""Argument checks, array helpers, the devices, run timing and the plots:
the port's copy of the JAX package's `utils.py` (dl4ds_tpu/utils.py),
with the CUDA devices in place of the JAX ones."""

import math
import os
from datetime import datetime

import numpy as np
import torch

from . import (BACKBONE_BLOCKS, DROPOUT_VARIANTS, INTERPOLATION_METHODS,
               LOSS_FUNCTIONS, UPSAMPLING_METHODS)

__all__ = ['spatial_to_spatiotemporal_samples',
           'spatiotemporal_to_spatial_samples', 'checkarray_ndim',
           'check_compatibility_upsbackb', 'checkarg_upsampling',
           'checkarg_backbone', 'checkarg_dropout_variant', 'checkarg_loss',
           'checkarg_interpolation', 'list_devices', 'set_gpu_memory_growth',
           'set_visible_gpus', 'Timing', 'crop_array', 'plot_history',
           'plot_ndarray', 'rank', 'resolve_device', 'not_ported', '_values']


def not_ported(what, item):
    """The error for a feature this port does not have yet; `item` is its
    entry in ROADMAP.md's queue 1."""
    return NotImplementedError(f'{what} is not ported yet '
                               f'(ROADMAP.md queue 1, item {item})')


def rank(x):
    """Number of dimensions of an array (reference: dl4ds/utils.py:202)."""
    return len(x.shape)


def checkarray_ndim(array, ndim=3, add_axis_position=-1):
    """Expand with a length-1 axis until the array has at least `ndim`
    dims."""
    while array.ndim < ndim:
        array = np.expand_dims(array, axis=add_axis_position)
    return array


def crop_array(array, size, yx=None, position=False, exclude_borders=False,
               get_copy=False, rng=None):
    """Square crop of a 2-5D numpy array with the reference's axis
    conventions (dl4ds_tpu/utils.py:274-316): rank 2/3 crops axes (0, 1),
    rank 4 (1, 2), rank 5 (2, 3). At `yx` = (y, x), or at an origin drawn
    y first, then x, from `rng` (default: the global `np.random`; its
    `randint`, or a `Generator`'s `integers`). With `position` returns
    (crop, y, x)."""
    if array.ndim not in (2, 3, 4, 5):
        raise TypeError('Input array is not a 2D, 3D, 4D or 5D ndarray')
    if not isinstance(size, int):
        raise TypeError('`size` must be an integer')
    ax = {2: 0, 3: 0, 4: 1, 5: 2}[array.ndim]
    ny, nx = array.shape[ax], array.shape[ax + 1]
    if size > ny or size > nx:
        raise ValueError('`size` larger than the input image size')
    if yx is not None and isinstance(yx, tuple):
        y, x = yx
    else:
        rng = rng or np.random
        randint = getattr(rng, 'randint', None) or rng.integers
        lo = 1 if exclude_borders else 0
        hi_y = ny - size - (1 if exclude_borders else 0)
        hi_x = nx - size - (1 if exclude_borders else 0)
        if hi_y <= lo - 1 or hi_x <= lo - 1 or (exclude_borders
                                                and (hi_y <= lo
                                                     or hi_x <= lo)):
            raise ValueError(
                f'cannot crop size={size} from a {ny}x{nx} grid with '
                f'exclude_borders={exclude_borders}')
        y = randint(lo, max(hi_y, lo + 1))
        x = randint(lo, max(hi_x, lo + 1))
    y0, y1 = int(y), int(y) + size
    x0, x1 = int(x), int(x) + size
    if y0 < 0 or x0 < 0 or y1 > ny or x1 > nx:
        raise RuntimeError(
            f'Cropped image cannot be obtained with size={size}, y={y}, x={x}')
    sl = [slice(None)] * array.ndim
    sl[ax] = slice(y0, y1)
    sl[ax + 1] = slice(x0, x1)
    out = array[tuple(sl)]
    if get_copy:
        out = out.copy()
    return (out, y, x) if position else out


def checkarg_upsampling(upsampling):
    if not isinstance(upsampling, str):
        raise TypeError('`upsampling` must be a string')
    if upsampling not in UPSAMPLING_METHODS:
        raise ValueError(
            f'`upsampling` not recognized. Must be one of the following: '
            f'{UPSAMPLING_METHODS}. Got {upsampling}')
    return upsampling


def checkarg_backbone(backbone):
    if not isinstance(backbone, str):
        raise TypeError('`backbone` must be a string')
    if backbone not in BACKBONE_BLOCKS:
        raise ValueError(
            f'`backbone` not recognized. Must be one of the following: '
            f'{BACKBONE_BLOCKS}. Got {backbone}')
    return backbone


def check_compatibility_upsbackb(backbone, upsampling, time_window):
    upsampling = checkarg_upsampling(upsampling)
    backbone = checkarg_backbone(backbone)
    if backbone == 'unet' and upsampling != 'pin':
        raise ValueError('`unet` backbone only works with `pin` pre-upsampling')
    if backbone in ('convnext', 'unet') and time_window is not None:
        raise ValueError(
            '`unet` and `convnext` backbones only work with spatial samples '
            '(`time_window` must be None)')
    return backbone, upsampling


def checkarg_loss(loss):
    """Resolve a loss name, one of the nine in `LOSS_FUNCTIONS`, into the
    loss callable of `losses` (a callable passes through)."""
    from . import losses
    if isinstance(loss, str):
        if loss not in LOSS_FUNCTIONS:
            raise ValueError(f'`loss` must be one of {LOSS_FUNCTIONS}, got '
                             f'{loss}')
        return getattr(losses, loss)
    if callable(loss):
        return loss
    raise TypeError(f'`loss` must be a string, one of {LOSS_FUNCTIONS}')


def checkarg_dropout_variant(dropout_variant):
    if dropout_variant is None or dropout_variant == 'vanilla':
        return dropout_variant
    if isinstance(dropout_variant, str):
        if dropout_variant not in DROPOUT_VARIANTS:
            raise ValueError(
                f'`dropout_variant` must be None or one of {DROPOUT_VARIANTS},'
                f' got {dropout_variant}')
        return dropout_variant
    raise TypeError('`dropout_variant` must be None or a string')


def checkarg_interpolation(interpolation):
    if interpolation not in INTERPOLATION_METHODS:
        raise ValueError(
            f'`interpolation` must be one of {INTERPOLATION_METHODS}, '
            f'got {interpolation}')
    return interpolation


def set_gpu_memory_growth():
    """Reference-API compat shim (dl4ds/utils.py:174-177). PyTorch's CUDA
    caching allocator grows its pool as tensors are made; its settings
    are `PYTORCH_CUDA_ALLOC_CONF`, read before the first allocation."""


def set_visible_gpus(*indices):
    """Reference-API compat shim (dl4ds/utils.py:195-199). The cards a
    process sees are set by `CUDA_VISIBLE_DEVICES` before CUDA starts; an
    entry point runs on the card its `device` names ('cuda:1')."""


def list_devices(which='local', verbose=True):
    """The CUDA devices this process sees, as `torch.device`s (reference
    analogue: dl4ds/utils.py:180-192). `which` ('local' or any other, the
    JAX package's all devices) gives one host's cards either way: the port
    runs on one host."""
    devices = [torch.device('cuda', i)
               for i in range(torch.cuda.device_count())]
    if verbose:
        print('List of devices:')
        print([f'{d}: {torch.cuda.get_device_name(d)}' for d in devices])
    return devices


def resolve_device(device):
    """`torch.device` for an entry point's `device` argument, with the
    current CUDA device's index filled in. A CUDA device without a visible
    GPU raises: the port never carries on silently on the CPU, which has to
    be asked for with device='cpu'."""
    device = torch.device(device)
    if device.type == 'cpu':
        return device
    if device.type != 'cuda':
        raise ValueError(f'unsupported device {device}')
    if not torch.cuda.is_available():
        raise RuntimeError(
            f'device={str(device)!r} but no CUDA device is available; pass '
            f"device='cpu' to run on the CPU")
    if device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def spatial_to_spatiotemporal_samples(array, time_window):
    """[n, y, x, c] -> [n - tw + 1, tw, y, x, c] sliding windows
    (dl4ds_tpu/utils.py:111-117)."""
    array = np.asarray(array)
    n_t = array.shape[0] - (time_window - 1)
    idx = np.arange(time_window)[None, :] + np.arange(n_t)[:, None]
    return array[idx]


def spatiotemporal_to_spatial_samples(array, time_window):
    """Collapse [n, tw, y, x, c] windows back to a flat sequence of grids:
    the first frame of each window, then the last window's trailing frames
    (dl4ds_tpu/utils.py:120-129)."""
    array = np.asarray(array)
    if array.shape[1] != time_window:
        raise ValueError(
            '`time_window` must be located in the second position '
            '[n_samples, time_window, lat, lon, vars]')
    return np.concatenate([array[:, 0], array[-1, 1:]], axis=0)


def _values(x):
    """Coerce xr.DataArray -> np.ndarray (xarray optional)."""
    if x is None:
        return None
    try:
        import xarray as xr
        if isinstance(x, xr.DataArray):
            return x.values
    except ImportError:
        pass
    return np.asarray(x)


class Timing:
    """Wall-clock run timing (reference: dl4ds/utils.py:206-248)."""

    sep = '-' * 80

    def __init__(self, verbose=True):
        self.verbose = verbose
        self.running_time = None
        self.checktimes = []
        self.starting_time = datetime.now()
        self.starting_time_fmt = self.starting_time.strftime('%Y-%m-%d %H:%M:%S')
        if self.verbose:
            print(self.sep)
            print(f'Starting time: {self.starting_time_fmt}')
            print(self.sep)

    def runtime(self):
        self.running_time = str(datetime.now() - self.starting_time)
        if self.verbose:
            print(self.sep)
            print(f'Final running time: {self.running_time}')
            print(self.sep)

    def checktime(self):
        checktime = str(datetime.now() - self.starting_time)
        self.checktimes.append(checktime)
        if self.verbose:
            print(self.sep)
            print(f'Timing: {checktime}')
            print(self.sep)


def plot_history(history, style='-', side=5, graphs_per_row=4,
                 customization_callback=None, path=None, single_graphs=False,
                 max_epochs='max', monitor=None, monitor_mode='max',
                 log_scale_metrics=False, title=None):
    """Plot training histories as a per-metric grid, a copy of
    dl4ds_tpu/utils.py:337 (reference: dl4ds/utils.py:409-672).

    `history` is a dict of lists (e.g. {'loss': [...], 'val_loss': [...]})
    or a list of such dicts (multiple runs overlaid); `monitor`/
    `monitor_mode` mark the best epoch of that metric; `max_epochs`
    ('max' | 'min' | int) windows the x-axis across runs; `single_graphs`
    saves one PNG per metric next to `path`; `customization_callback(axis)`
    post-styles every axis. A path-looking `style` is taken as `path`.
    Returns (figure, axes), or with `single_graphs` (figures, axes).
    """
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    _img_exts = ('.png', '.jpg', '.jpeg', '.pdf', '.svg', '.tif', '.tiff',
                 '.eps')
    if isinstance(style, str) and ('/' in style or os.sep in style
                                   or style.lower().endswith(_img_exts)):
        if path is None:
            path = style
        style = '-'
    if monitor_mode not in ('min', 'max'):
        raise ValueError(f'monitor_mode {monitor_mode!r} is not supported')
    if max_epochs not in ('min', 'max') and not isinstance(max_epochs, int):
        raise ValueError(f'max_epochs {max_epochs!r} is not supported')
    histories = history if isinstance(history, list) else [history]
    lengths = [len(next(iter(h.values()))) for h in histories if h]
    if isinstance(max_epochs, int):
        n_epochs = max_epochs
    elif max_epochs == 'min':
        n_epochs = min(lengths) if lengths else 0
    else:
        n_epochs = max(lengths) if lengths else 0

    metrics = []
    for h in histories:
        for k in h:
            base = k[4:] if k.startswith('val_') else k
            if base not in metrics:
                metrics.append(base)

    def _draw_metric(axis, metric):
        for i, h in enumerate(histories):
            run = f' run {i + 1}' if len(histories) > 1 else ''
            for prefix, key in (('Train', metric), ('Val', f'val_{metric}')):
                if key not in h:
                    continue
                vals = np.asarray(h[key], dtype=float)[:n_epochs]
                if not len(vals):
                    continue
                axis.plot(vals, style,
                          label=f'{prefix}{run} last: {vals[-1]:0.4f}')
                if monitor is not None and key == monitor:
                    best = (np.argmax(vals) if monitor_mode == 'max'
                            else np.argmin(vals))
                    axis.scatter([best], [vals[best]], marker='*', s=90,
                                 zorder=5,
                                 label=f'Best {key}: {vals[best]:0.4f} '
                                       f'(epoch {best + 1})')
        axis.set_xlabel('Epochs')
        axis.set_ylabel(metric.capitalize())
        if log_scale_metrics:
            axis.set_yscale('log')
        axis.set_title(metric.capitalize())
        axis.grid(True)
        axis.legend()
        if customization_callback is not None:
            customization_callback(axis)

    if path is not None:
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)

    if single_graphs:
        figs, all_axes = [], []
        for metric in metrics:
            fig, axis = plt.subplots(figsize=(side, side), dpi=150,
                                     constrained_layout=True)
            _draw_metric(axis, metric)
            if path is not None:
                root, ext = os.path.splitext(path)
                fig.savefig(f'{root}_{metric}{ext or ".png"}')
            figs.append(fig)
            all_axes.append(axis)
        return figs, all_axes

    n = max(len(metrics), 1)
    w = min(n, graphs_per_row)
    h = math.ceil(n / graphs_per_row)
    fig, axes = plt.subplots(h, w, figsize=(side * w, side * h), dpi=150,
                             constrained_layout=True, squeeze=False)
    flat_axes = axes.ravel()
    for metric, axis in zip(metrics, flat_axes):
        _draw_metric(axis, metric)
    for axis in flat_axes[len(metrics):]:
        axis.axis('off')
    if title is not None:
        fig.suptitle(title, fontsize=20)
    if path is not None:
        fig.savefig(path)
    return fig, axes


def plot_ndarray(data, plot_title=None, subplot_titles=None, dpi=100,
                 cmap='viridis', share_colorbar=False, lats=None, lons=None,
                 save_fname=None, interactive=False, **_ignored):
    """Multi-panel grid plot of 2-D field(s) — the static stand-in for the
    reference's `ecubevis.plot_ndarray` debug/inspection panels
    (used at dl4ds/dataloader.py:260-289 and dl4ds/metrics.py via `ecv`).

    `data`: one 2-D array, a [N, H, W] stack, or a tuple/list of 2-D
    arrays. With `lats`/`lons` (1-D coordinate vectors) the panels are
    drawn on the geographic extent with degree axis labels.
    `interactive=True` writes a self-contained interactive HTML viewer
    (time slider + hover value/lat-lon readout, `viz.interactive_panel`)
    to `save_fname` (or 'panel.html') and returns its path. Otherwise
    returns the matplotlib figure (a copy of dl4ds_tpu/utils.py:31;
    matplotlib is imported here only).
    """
    if interactive:
        from .viz import interactive_panel
        stack = ([np.squeeze(np.asarray(d)) for d in data]
                 if isinstance(data, (tuple, list)) else data)
        return interactive_panel(
            np.stack(stack) if isinstance(stack, list) else stack,
            lats=lats, lons=lons,
            save_path=save_fname or 'panel.html',
            title=plot_title or 'dl4ds_tpu interactive panel')
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    if isinstance(data, (tuple, list)):
        panels = [np.squeeze(np.asarray(d)) for d in data]
    else:
        data = np.squeeze(np.asarray(data))
        panels = [data] if data.ndim == 2 else [data[i]
                                                for i in range(data.shape[0])]
    for p in panels:
        if p.ndim != 2:
            raise ValueError('plot_ndarray expects 2-D fields (or stacks/'
                             f'tuples of them); got shape {p.shape}')
    extent = None
    origin = 'lower'
    if lats is not None and lons is not None:
        lats, lons = np.asarray(lats), np.asarray(lons)
        extent = (float(lons.min()), float(lons.max()),
                  float(lats.min()), float(lats.max()))
        if lats[0] > lats[-1]:       # descending latitude grids
            origin = 'upper'
    vmin = vmax = None
    if share_colorbar:
        vmin = min(float(np.nanmin(p)) for p in panels)
        vmax = max(float(np.nanmax(p)) for p in panels)
    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(4.6 * n, 4), dpi=dpi,
                             squeeze=False)
    for i, (ax, img) in enumerate(zip(axes[0], panels)):
        im = ax.imshow(img, cmap=cmap, origin=origin, extent=extent,
                       vmin=vmin, vmax=vmax,
                       aspect='auto' if extent else None)
        if subplot_titles is not None and i < len(subplot_titles):
            ax.set_title(subplot_titles[i], fontsize=10)
        if extent is not None:
            ax.set_xlabel('lon [deg]')
            if i == 0:
                ax.set_ylabel('lat [deg]')
        if not share_colorbar:
            fig.colorbar(im, ax=ax, shrink=0.85)
    if share_colorbar:
        fig.colorbar(im, ax=list(axes[0]), shrink=0.85)
    if plot_title:
        fig.suptitle(plot_title)
    if save_fname is not None:
        fig.savefig(save_fname, bbox_inches='tight')
        plt.close(fig)
    return fig
