"""Argument checks, array helpers, device resolution and run timing
(copies of the JAX package's `utils.py` helpers that this port needs)."""

from datetime import datetime

import numpy as np
import torch

from . import (BACKBONE_BLOCKS, DROPOUT_VARIANTS, LOSS_FUNCTIONS,
               UPSAMPLING_METHODS)

__all__ = ['checkarray_ndim', 'checkarg_upsampling', 'checkarg_backbone',
           'checkarg_dropout_variant', 'checkarg_loss',
           'check_compatibility_upsbackb', 'resolve_device', 'not_ported',
           'spatiotemporal_to_spatial_samples', 'Timing', '_values']


def not_ported(what, item):
    """The error for a feature this port does not have yet; `item` is its
    entry in ROADMAP.md's queue 1."""
    return NotImplementedError(f'{what} is not ported yet '
                               f'(ROADMAP.md queue 1, item {item})')


def checkarray_ndim(array, ndim=3, add_axis_position=-1):
    """Expand with a length-1 axis until the array has at least `ndim`
    dims."""
    while array.ndim < ndim:
        array = np.expand_dims(array, axis=add_axis_position)
    return array


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
