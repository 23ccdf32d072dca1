"""
Base training class (the counterpart of `dl4ds_tpu/training/base.py`).

One process drives one device: `device` defaults to CUDA and device='cpu'
must be asked for. Data parallelism runs one such process a device: a
`mesh` (`distributed.global_mesh()`, a `DeviceMesh` whose one dim 'data'
spans the process group) makes the batch a rank's slice of a global batch
`batch_size * n_data_shards` wide, and gates the printing and the files on
the first worker (dl4ds_tpu/training/base.py:98-145). A spatial mesh
(`distributed.spatial_mesh()`, dims ('data', 'space') or ('space',)) adds
bands of rows: the ranks of a 'space' group share their data row's batch,
each holding a band of its rows; the batch and the rate scale by the data
degree only. A tensor mesh (`distributed.tensor_mesh()`, dims ('data',
'model') or ('model',)) shards the wide weights over its 'model' groups,
whose ranks share their data row's batch. The class ports the
input validation, the scale checks, the channel bookkeeping, the grid
sizes, the loss lookup, the scalar log, the profiler and the saving of
results.
"""

import json
import os
import warnings
from abc import ABC, abstractmethod

import numpy as np
import torch

from .. import POSTUPSAMPLING_METHODS
from ..utils import (check_compatibility_upsbackb, checkarg_loss,
                     plot_history, resolve_device)

__all__ = ['Trainer', 'CHECKPOINT_FILE']

# the file a checkpoint directory holds (the JAX package's directories
# `best_model` and `checkpoints/epoch-<n>` hold orbax trees instead)
CHECKPOINT_FILE = 'checkpoint.pt'


class Trainer(ABC):
    """Common training scaffolding: input validation, device, data mesh,
    loss resolution, scale checks, logs, profiler and saving
    (dl4ds_tpu/training/base.py:48-341). `use_multiprocessing`,
    `model_list`, `show_plot` and `gpu_memory_growth` are accepted for the
    JAX package's signature and do nothing.

    `devices=[d]` selects `d`, as `device=d` does; a longer list raises,
    since one process drives one device here (launch one process a device
    and pass `mesh`). `mesh` is a `DeviceMesh` of the trainer's device
    type with the one dim 'data', or the dims ('data', 'space') or
    ('space',) (spatial parallelism), or ('data', 'model') or ('model',)
    (tensor parallelism)."""

    def __init__(self, backbone, upsampling, data_train, data_train_lr=None,
                 time_window=None, loss='mae', batch_size=64, patch_size=None,
                 scale=4, device='cuda', use_multiprocessing=False,
                 verbose=True, model_list=None, save=False, save_path=None,
                 show_plot=False, mesh=None, devices=None,
                 gpu_memory_growth=None):
        if devices is not None:
            devices = list(devices)
            if len(devices) != 1:
                raise ValueError(
                    f'`devices` lists {len(devices)} devices, but a process '
                    f'drives one: launch one process a device (torchrun '
                    f'--nproc_per_node=N) and pass '
                    f'mesh=distributed.global_mesh()')
            device = devices[0]
        self.data_train = self._as_array(data_train, 'data_train')
        if not self.data_train.ndim > 3:
            raise ValueError(
                '`data_train` must be at least 4D [samples, lat, lon, variables]')
        # a given LR training array (MOS; dl4ds_tpu/training/base.py:66-76)
        self.data_train_lr = (self._as_array(data_train_lr, 'data_train_lr')
                              if data_train_lr is not None else None)
        if self.data_train_lr is not None:
            if self.data_train_lr.shape[0] != self.data_train.shape[0]:
                raise ValueError(
                    '`data_train_lr` and `data_train` must contain the same '
                    'number of samples (equal 1st dim length)')
            if not self.data_train_lr.ndim > 3:
                raise ValueError(
                    '`data_train_lr` must be at least 4D '
                    '[samples, lat, lon, variables]')
        self.backbone, self.upsampling = check_compatibility_upsbackb(
            backbone, upsampling, time_window)
        self.time_window = time_window
        self.model_is_spatiotemporal = (time_window is not None
                                        and time_window > 1)
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.loss = loss
        self.scale = scale
        self.device = resolve_device(device)
        self._setup_mesh(mesh)
        # the first worker prints (dl4ds_tpu/training/base.py:124-133)
        self.verbose = verbose if self.running_on_first_worker else False
        self.save = save
        self.save_path = save_path or './'
        if not self.save_path.endswith('/'):
            self.save_path += '/'
        self.savecheckpoint_path = self.save_path

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
        if self.scale is not None and self.data_train_lr is not None:
            hr_yx = self.data_train.shape[-3:-1]
            lr_yx = self.data_train_lr.shape[-3:-1]
            if self.upsampling in POSTUPSAMPLING_METHODS:
                # a post-upsampling model upsamples LR by exactly `scale`
                if any(h != l * self.scale for h, l in zip(hr_yx, lr_yx)):
                    raise ValueError(
                        f'Wrong `scale` value: HR grid {tuple(hr_yx)} is '
                        f'not exactly {self.scale}x the LR grid '
                        f'{tuple(lr_yx)}')
            elif int(hr_yx[0] / lr_yx[0]) != int(self.scale):
                raise ValueError(
                    'Wrong `scale` value, check `data_train` and '
                    '`data_train_lr` grid sizes')
        self.lossf = checkarg_loss(self.loss)

    def _setup_mesh(self, mesh):
        """The mesh: the number of ranks, this one's data coordinate
        (`rank`), band (`space_rank`) and 'model' coordinate
        (`model_rank`), their groups and the global batch
        (dl4ds_tpu/training/base.py:98-133; the batch scales by the data
        degree, and the first worker does the IO). `mesh_group` spans
        every rank of the mesh: the batch norms' moments and the gradients'
        sum under a 'space' dim, the barriers."""
        self.mesh = mesh
        self.data_group = self.space_group = self.mesh_group = None
        self.model_group = None
        self.n_devices = self.n_data_shards = self.n_space = self.n_model = 1
        self.rank = self.space_rank = self.model_rank = 0
        if mesh is not None:
            names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
            if not names:
                raise TypeError('`mesh` must be a DeviceMesh with named dims '
                                '(distributed.global_mesh())')
            if 'model' in names and 'space' in names:
                raise ValueError("pass a mesh with ONE of 'model'/'space' "
                                 'besides data (3-D TPxSPxDP is untested)')
            if set(names) - {'data', 'model', 'space'} or len(names) > 2:
                raise ValueError(f"trainer meshes have the one dim 'data', "
                                 f"or ('data', 'space'), ('space',), "
                                 f"('data', 'model') or ('model',); got "
                                 f'{names}')
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f'the mesh is over {mesh.device_type!r} devices but the '
                    f'trainer runs on {str(self.device)!r}')
            if (self.device.type == 'cuda'
                    and self.device.index != torch.cuda.current_device()):
                raise ValueError(
                    f'this rank drives cuda:{torch.cuda.current_device()} '
                    f'(distributed.initialize pins it); the trainer was '
                    f'given {self.device}')
            self.n_devices = mesh.size()
            if 'data' in names:
                self.data_group = mesh.get_group('data')
                self.n_data_shards = mesh.size(names.index('data'))
                self.rank = mesh.get_local_rank('data')
            self.mesh_group = self.data_group
            from ..distributed import mesh_group
            if 'space' in names:
                self.space_group = mesh.get_group('space')
                self.n_space = mesh.size(names.index('space'))
                self.space_rank = mesh.get_local_rank('space')
                self.mesh_group = mesh_group(mesh)
            if 'model' in names:
                self.model_group = mesh.get_group('model')
                self.n_model = mesh.size(names.index('model'))
                self.model_rank = mesh.get_local_rank('model')
                self.mesh_group = mesh_group(mesh)
        self.global_batch_size = self.batch_size * self.n_data_shards
        # first-worker gating (dl4ds_tpu/training/base.py:124-133)
        self.running_on_first_worker = (self.rank == 0 and self.space_rank == 0
                                        and self.model_rank == 0)

    def _reduce_mean(self, t):
        """`t` (on the device) averaged over the ranks, in place; unchanged
        without a mesh."""
        if self.data_group is not None:
            torch.distributed.all_reduce(t, group=self.data_group)
            t.div_(self.n_data_shards)
        return t

    def _barrier(self):
        if self.mesh_group is not None:
            torch.distributed.barrier(group=self.mesh_group)

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

    # ------------------------------------------------------------------
    # Observability (dl4ds_tpu/training/base.py:209-231): a JSONL scalar
    # log and a torch.profiler trace
    # ------------------------------------------------------------------
    def start_profiler(self, logdir=None):
        """Begin a torch.profiler trace of the host and, on the card, of
        the device, written as `trace.json` under `logdir` (default
        save_path + 'profile') when it stops; on the first worker only."""
        if not self.running_on_first_worker:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        self._profile_dir = logdir or (self.save_path + 'profile')
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def stop_profiler(self):
        """Stop the trace, if one runs, and write it (idempotent)."""
        prof = getattr(self, '_profiler', None)
        if prof is None:
            return
        self._profiler = None
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self._profile_dir,
                                              'trace.json'))

    def log_scalars(self, step, **scalars):
        """Append one JSONL record of named scalars to
        save_path + 'scalars.jsonl', on the first worker."""
        if not self.running_on_first_worker:
            return
        os.makedirs(self.save_path, exist_ok=True)
        with open(self.save_path + 'scalars.jsonl', 'a') as fh:
            fh.write(json.dumps({'step': step, **scalars}) + '\n')

    def channel_counts(self, predictors_train, static_vars,
                       season_ids=None):
        """Model input and aux channel counts
        (dl4ds_tpu/training/base.py:233-260): spatial samples put the
        statics and the 4 season channels into the LR input and the HR aux
        branch, spatio-temporal samples into the aux branch only."""
        n_channels = self.data_train.shape[-1]
        n_aux_channels = 0
        if predictors_train is not None:
            n_channels += len(predictors_train)
        if static_vars is not None:
            n_aux_channels += len(static_vars)
        if season_ids is not None:
            n_aux_channels += 4
        if not self.model_is_spatiotemporal:
            n_channels += n_aux_channels
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

    @staticmethod
    def _checkpoint_save(path, payload):
        """torch.save `payload` as `CHECKPOINT_FILE` in the directory
        `path`, written whole or not at all."""
        os.makedirs(path, exist_ok=True)
        file = os.path.join(path, CHECKPOINT_FILE)
        torch.save(payload, file + '.tmp')
        os.replace(file + '.tmp', file)

    @staticmethod
    def _checkpoint_load(path):
        """The payload of a checkpoint: `path` is its directory or its
        file."""
        file = (path if os.path.isfile(path)
                else os.path.join(path, CHECKPOINT_FILE))
        return torch.load(file, map_location='cpu', weights_only=True)

    @abstractmethod
    def run(self):
        ...

    @abstractmethod
    def setup_model(self):
        ...

    def save_results(self, net=None, folder_prefix=None, model=None):
        """Persist the trained model (`models.save_model`: the JAX
        package's model_config.json and variables.pkl), the wall-clock
        time, the test loss and the learning-curve plot
        (dl4ds_tpu/training/base.py:301-341). Without matplotlib (a CUDA
        host may have none) the plot is left out with a RuntimeWarning;
        the rest is written. Only the first worker writes."""
        if not self.save or not self.running_on_first_worker:
            return
        prefix = folder_prefix or ''
        self.model_save_path = (self.save_path + prefix + self.backbone
                                + '_' + self.upsampling + '/')
        os.makedirs(self.model_save_path, exist_ok=True)
        model = model if model is not None else getattr(self, 'model', None)
        net = net if net is not None else getattr(self, 'net', None)
        if model is not None and net is not None:
            from ..models import save_model
            save_model(model, net, self.model_save_path)
        if getattr(self, 'timing', None) is not None and \
                self.timing.running_time is not None:
            np.savetxt(self.save_path + 'running_time.txt',
                       [self.timing.running_time], fmt='%s')
        if getattr(self, 'test_loss', None) is not None:
            np.savetxt(self.save_path + 'test_loss.txt',
                       [float(self.test_loss)], fmt='%0.6f')
        if getattr(self, 'fithist', None):
            try:
                import matplotlib.pyplot as plt
            except ImportError:
                warnings.warn('learning_curve.png not drawn: matplotlib is '
                              'not installed', RuntimeWarning)
                return
            fig, _ = plot_history(self.fithist,
                                  path=self.save_path + 'learning_curve.png')
            plt.close(fig)
