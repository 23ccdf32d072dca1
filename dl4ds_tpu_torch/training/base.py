"""
Base training class (the counterpart of `dl4ds_tpu/training/base.py`).

One device, no mesh: `device` defaults to CUDA and device='cpu' must be
asked for. The class ports the input validation, the scale checks, the
channel bookkeeping, the grid sizes and the loss lookup; meshes, saving and
the profiler raise until they are ported.
"""

from abc import ABC, abstractmethod

import numpy as np

from .. import POSTUPSAMPLING_METHODS
from ..utils import (check_compatibility_upsbackb, checkarg_loss, not_ported,
                     resolve_device)

__all__ = ['Trainer']


class Trainer(ABC):
    """Common training scaffolding: input validation, device, loss
    resolution and scale checks (dl4ds_tpu/training/base.py:48-189).
    `use_multiprocessing`, `model_list`, `save_path`, `show_plot` and
    `gpu_memory_growth` are accepted for the JAX package's signature and do
    nothing."""

    def __init__(self, backbone, upsampling, data_train, data_train_lr=None,
                 time_window=None, loss='mae', batch_size=64, patch_size=None,
                 scale=4, device='cuda', use_multiprocessing=False,
                 verbose=True, model_list=None, save=False, save_path=None,
                 show_plot=False, mesh=None, devices=None,
                 gpu_memory_growth=None):
        if mesh is not None or devices is not None:
            raise not_ported('`mesh` and `devices` (multi-GPU training)', 10)
        if data_train_lr is not None:
            raise not_ported('a given LR training array (`data_train_lr`)', 5)
        if save:
            raise not_ported('saving trained models (`save=True`)', 4)
        self.data_train = self._as_array(data_train, 'data_train')
        if not self.data_train.ndim > 3:
            raise ValueError(
                '`data_train` must be at least 4D [samples, lat, lon, variables]')
        self.backbone, self.upsampling = check_compatibility_upsbackb(
            backbone, upsampling, time_window)
        self.time_window = time_window
        self.model_is_spatiotemporal = (time_window is not None
                                        and time_window > 1)
        self.batch_size = batch_size
        # one device: the global batch is the batch
        self.global_batch_size = batch_size
        self.patch_size = patch_size
        self.loss = loss
        self.scale = scale
        self.device = resolve_device(device)
        self.verbose = verbose

        # scale-vs-grid checks (dl4ds_tpu/training/base.py:149-187)
        if self.patch_size is not None:
            sizes = (self.patch_size,)
        elif self.upsampling in POSTUPSAMPLING_METHODS:
            sizes = tuple(self.data_train.shape[-3:-1])   # (lat, lon)
        else:
            sizes = (self.data_train.shape[-2],)
        if self.scale is not None and any(sz % self.scale for sz in sizes):
            raise ValueError(
                f'The image size {sizes} must be divisible by `scale` '
                f'(remainder must be zero). Crop the images or set '
                f'`patch_size` accordingly')
        self.lossf = checkarg_loss(self.loss)

    @staticmethod
    def _as_array(x, name):
        try:
            import xarray as xr
            if isinstance(x, xr.DataArray):
                return x.values
        except ImportError:
            pass
        if not isinstance(x, np.ndarray):
            raise TypeError(
                f'`{name}` object must be of np.ndarray or xr.DataArray type')
        return x

    def channel_counts(self, predictors_train, static_vars):
        """Model input and aux channel counts
        (dl4ds_tpu/training/base.py:233-260): spatial samples put the
        statics into the LR input and the HR aux branch, spatio-temporal
        samples into the aux branch only."""
        n_channels = self.data_train.shape[-1]
        n_aux_channels = 0
        if static_vars is not None:
            n_aux_channels = len(static_vars)
            if not self.model_is_spatiotemporal:
                n_channels += len(static_vars)
        if predictors_train is not None:
            n_channels += len(predictors_train)
        return n_channels, n_aux_channels

    def grid_sizes(self):
        """(hr_size, lr_size) from the patch or the full grid
        (dl4ds_tpu/training/base.py:262-272)."""
        if self.patch_size is None:
            hr_h = int(self.data_train.shape[1])
            hr_w = int(self.data_train.shape[2])
            return (hr_h, hr_w), (int(hr_h / self.scale),
                                  int(hr_w / self.scale))
        hr = int(self.patch_size)
        lr = int(self.patch_size / self.scale)
        return (hr, hr), (lr, lr)

    @abstractmethod
    def run(self):
        ...

    @abstractmethod
    def setup_model(self):
        ...
