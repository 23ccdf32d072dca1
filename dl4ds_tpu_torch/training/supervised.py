"""
Supervised training procedure (the counterpart of
`dl4ds_tpu/training/supervised.py`).

One device a process. Each epoch's batches are planned on the host
first: a CPU `torch.Generator`, seeded by `seed`, draws the shuffled
indices and the patch offsets of every step (`BatchSynthesizer.plan`), so
one seed gives the same batches on every device. A step is then device
work only: the batch built from its plan row, the forward in train mode,
the loss, the backward (for a spatio-temporal model, K2's training
variant and the K3 or K4 BPTT kernels on the GPU), and, on the
optimizer's commit, the Adam update at the scheduled rate and the EMA of
the parameters. Dropout draws
from the trainer's own generator on the device, seeded from `seed`
(`dropout_generator`), which a captured step advances on each replay, as
an eager one does; a batch norm's running statistics are buffers of the
network, which the EMA network shares, so that validation scores the
averaged parameters with the live statistics, as the JAX trainer does.

On the card the step is captured once as a CUDA graph and replayed, a
chunk of `steps_per_execution` plan rows at a time (default: the whole
epoch), as the JAX trainer runs a chunk as one XLA program; validation and
test run the same way without the update. There is no eager fallback: a
capture or replay that fails raises. On the CPU the same step functions
run eagerly. Losses stay on the device and are read once an epoch. With
`data_in_hbm=False` the splits stream from the host (`HostStreamer`):
each batch is copied into the captured step's input buffers and the step
replayed, one replay a batch.

Adam uses Keras's eps of 1e-7, with its rate a device scalar set from the
schedule (optax's, `training/schedules.py`) on the device update count;
on the card it is fused and capturable. Gradient accumulation has
optax.MultiSteps' semantics: the running mean of k microbatch gradients,
one update on the k-th, the count and schedule advancing only then.

Data parallelism (`mesh`, `distributed.global_mesh()`: one process a
device) runs the JAX trainer's `Mesh('data')` semantics: every rank draws
the same global plan (`global_batch_size` wide) from `seed` and builds its
columns of it; the rate is scaled by the number of ranks (Goyal et al.,
but for a callable schedule); inside the step the batch norms take the
global batch's moments and the DSSIM losses its range
(`distributed.batch_group`), and on each commit one mean all-reduce of the
gradients, through one flat buffer (`distributed.average_gradients`),
precedes Adam (NCCL's average on the
card, captured in the step's graph; gloo's sum, divided, on the CPU). The train, validation and test losses are
averaged over the ranks, so every rank keeps the same `fithist` and
`test_loss` and stops at the same epoch; the first worker alone prints
and writes files, and the others wait for its checkpoints. Each rank
draws its dropout masks from its own generator, seeded from (seed, rank):
the JAX trainer draws one global mask and shards it.

Spatial parallelism (`mesh=distributed.spatial_mesh(n_space, n_data)`, the
JAX trainer's ('data', 'space') mesh, or ('space',)): the ranks of a data
row's 'space' group each build the row's shard of the batch, as above, and
keep a band of its rows (H, dim -3, of the model input and the aux; a
post-upsampling model's LR rows H / S, a pin model's HR rows). The model
runs within `distributed.space_group`, its layers taking their band rules
(models/blocks.py: the convs' halo rows, K1's band mode, the batch norms'
moments over every rank, the replicate rule around the ConvLSTM layers and
the upsamplers that resize); its output rows are joined again
(`distributed.gather_rows`) and the trainer's loss taken on the whole
height once per data row, so that every loss runs as without the 'space'
dim. Only the band group's first rank seeds the backward with the loss's
gradient (the others with 0), so that each parameter's gradient is the sum
of its band ranks' parts, summed over the mesh and divided by the data
degree on each commit. The losses, the rate and the dropout masks are the
data row's: a row's bands share one generator and keep their rows of its
masks. A height (or a height after a max-pool) that does not cut into
equal bands raises ValueError.

Tensor parallelism (`mesh=distributed.tensor_mesh(n_model, n_data)`, the
JAX trainer's ('data', 'model') mesh, or ('model',)): the ranks of a data
row's 'model' group each build the row's shard of the batch, and hold a
shard of every wide weight (`parallel.tensor_param_shardings`), as do
their Adam moments, gradient accumulators and EMA copy
(dl4ds_tpu/training/supervised.py:387-418). The model runs within
`distributed.model_group`, its layers taking their tensor rules
(models/blocks.py: column-parallel convs, the other weights gathered at
use); every rank computes the loss whole and seeds its backward with 1, so
that a replicated parameter's gradient is equal on every rank of the group
and a shard's exact, and the data rows are averaged on each commit. The
losses, the rate and the dropout masks are the data row's. What leaves the
trainer is whole: after `run` `net` is the gathered network (which
`predict(trainer)` and `save_results` serve), and the checkpoints hold the
gathered state, so that a run resumes with or without the 'model' dim. A
model with batch norm raises ValueError at `run`.
"""

import copy
import os
import warnings

import numpy as np
import torch

from .. import POSTUPSAMPLING_METHODS, distributed
from ..dataloader import (BatchSynthesizer, HostStreamer, _time_coord,
                          season_ids_from_time)
from ..models import build_model
from ..compat import import_keras_weights
from ..models.blocks import set_dropout_generator
from ..utils import Timing
from .base import Trainer
from .graphs import CapturedStep
from .schedules import build_schedule

__all__ = ['SupervisedTrainer']


class SupervisedTrainer(Trainer):
    """Supervised (pixel-loss) trainer, with the JAX package's signature.
    The model dtype is an architecture parameter, as in the JAX trainer:
    `dtype=torch.bfloat16` trains a bfloat16 model (float32 parameters,
    Adam and loss; the parameters are cast inside each forward, one cast a
    parameter tensor a step, which a replayed step holds too).

    `use_multiprocessing`, `model_list`, `gpu_memory_growth` and
    `show_plot` are accepted and do nothing, as in the JAX package. The
    options that are not ported raise NotImplementedError naming their
    ROADMAP item. `mesh` with the one dim 'data' trains data-parallel over
    the process group, `batch_size` being a rank's batch; a spatial mesh
    also cuts each sample into bands of rows, a tensor mesh shards the
    weights (see the module's docstring). `init_weights` loads a
    reference Keras checkpoint into the freshly built network
    (`compat.import_keras_weights`: a weight list, an `.npz`, a Keras
    model or a SavedModel path); it cannot be combined with
    `trained_model`.

    `data_in_hbm=False` streams all three splits from host RAM or from a
    memmapped file (`HostStreamer`, seeded from `seed`): each batch is
    gathered and cropped on the host into a pinned slot, copied to the
    device and into the input buffers of the captured step, which is
    replayed once a batch (`steps_per_execution` is ignored, with a
    warning); a val or test split smaller than one batch raises.

    MOS training takes the given LR arrays `data_train_lr`, `data_val_lr`
    and `data_test_lr` (each [n, y, x, c] beside its HR split, HR exactly
    `scale` times LR); PerfectProg training, without them, coarsens the HR
    data. Season channels come from `season_ids`, a (train, val, test)
    tuple of [n] id tables, or from `time_metadata`, a (train, val, test)
    tuple of datetime-like arrays or 'auto' (the splits' xr time
    coordinates).

    After `run`, `net` holds the weights to serve (the EMA ones with
    `ema_decay`), `train_net` the raw ones, and `fithist`, `test_loss` and
    `train_losses` (the last epoch's per-step losses, on the device) the
    results."""

    def __init__(self, backbone, upsampling, data_train, data_val, data_test,
                 data_train_lr=None, data_val_lr=None, data_test_lr=None,
                 predictors_train=None, predictors_val=None,
                 predictors_test=None, static_vars=None, scale=5,
                 interpolation='inter_area', patch_size=None,
                 time_window=None, batch_size=64, loss='mae', epochs=60,
                 steps_per_epoch=None, test_steps=None, validation_steps=None,
                 device='cuda', use_multiprocessing=False, model_list=None,
                 learning_rate=(1e-3, 1e-4), lr_decay_after=1e5,
                 early_stopping=False, patience=6, min_delta=0,
                 show_plot=False, save=False, save_path=None,
                 save_bestmodel=False, trained_model=None, trained_epochs=0,
                 init_weights=None, verbose=True, seed=42, mesh=None,
                 devices=None, gpu_memory_growth=None, save_logs=False,
                 profile=False, data_in_hbm=True, steps_per_execution=None,
                 checkpoints_frequency=0, resume_from_checkpoint=None,
                 season_ids=None, time_metadata=None, terminate_on_nan=True,
                 gradient_accumulation_steps=1, lr_schedule=None,
                 warmup_steps=0, ema_decay=0.0, **architecture_params):
        # the JAX trainer's checks (dl4ds_tpu/training/supervised.py:
        # 122-128, 147-148, 154-158, 189-193)
        if init_weights is not None and trained_model is not None:
            raise ValueError('`init_weights` initializes a freshly-built '
                             'model; it cannot be combined with '
                             '`trained_model` (which carries its own '
                             'variables)')
        if lr_schedule not in (None, 'cosine', 'warmup_cosine') \
                and not callable(lr_schedule):
            raise ValueError(
                f"`lr_schedule` must be None, 'cosine', 'warmup_cosine' or "
                f"a callable schedule, got {lr_schedule!r}")
        if warmup_steps < 0:
            raise ValueError('`warmup_steps` must be >= 0')
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError('`ema_decay` must be in [0, 1)')
        if (not isinstance(gradient_accumulation_steps, int)
                or gradient_accumulation_steps < 1):
            raise ValueError('`gradient_accumulation_steps` must be an '
                             'integer >= 1')
        if steps_per_execution is not None and (
                not isinstance(steps_per_execution, int)
                or steps_per_execution < 1):
            raise ValueError('`steps_per_execution` must be None or an '
                             'integer >= 1')
        super().__init__(
            backbone=backbone, upsampling=upsampling, data_train=data_train,
            data_train_lr=data_train_lr, time_window=time_window, loss=loss,
            batch_size=batch_size, patch_size=patch_size, scale=scale,
            device=device, use_multiprocessing=use_multiprocessing,
            verbose=verbose, model_list=model_list, save=save,
            save_path=save_path, show_plot=show_plot, mesh=mesh,
            devices=devices)
        if self.time_window is not None and not self.model_is_spatiotemporal:
            # time_window=1 builds a spatial model: 4-D batches
            self.time_window = None
        self.data_val = self._as_array(data_val, 'data_val')
        self.data_test = self._as_array(data_test, 'data_test')
        self.data_val_lr = (self._as_array(data_val_lr, 'data_val_lr')
                            if data_val_lr is not None else None)
        self.data_test_lr = (self._as_array(data_test_lr, 'data_test_lr')
                             if data_test_lr is not None else None)
        for name, preds in (('predictors_train', predictors_train),
                            ('predictors_val', predictors_val),
                            ('predictors_test', predictors_test)):
            if preds is not None and not isinstance(preds, list):
                raise TypeError(f'`{name}` must be a list of ndarrays')
        self.predictors_train = predictors_train
        self.predictors_val = predictors_val
        self.predictors_test = predictors_test
        self.static_vars = static_vars
        self.interpolation = interpolation
        self.epochs = epochs
        for nm, v in (('steps_per_epoch', steps_per_epoch),
                      ('validation_steps', validation_steps),
                      ('test_steps', test_steps)):
            if v is not None and v < 1:
                raise ValueError(f'`{nm}` must be >= 1 or None (0 steps '
                                 f'would evaluate to NaN)')
        self.steps_per_epoch = steps_per_epoch
        self.validation_steps = validation_steps
        self.test_steps = test_steps
        self.learning_rate = learning_rate
        self.lr_decay_after = lr_decay_after
        self.lr_schedule = lr_schedule
        self.warmup_steps = warmup_steps
        self.ema_decay = float(ema_decay)
        self.gradient_accumulation_steps = gradient_accumulation_steps
        self.steps_per_execution = steps_per_execution
        self.early_stopping = early_stopping
        self.patience = patience
        self.min_delta = min_delta
        self.architecture_params = architecture_params
        self.trained_model = trained_model
        self.trained_epochs = trained_epochs
        self.init_weights = init_weights
        self.save_bestmodel = save_bestmodel
        self.checkpoints_frequency = checkpoints_frequency
        self.resume_from_checkpoint = resume_from_checkpoint
        self.save_logs = save_logs
        self.profile = profile
        self.seed = seed
        self.data_in_hbm = data_in_hbm
        self.terminate_on_nan = terminate_on_nan
        self.season_ids = _season_tables(season_ids, time_metadata,
                                         (data_train, data_val, data_test),
                                         time_window)
        self.model = None
        self.net = None

    # ------------------------------------------------------------------
    def setup_datagen(self):
        """The batch sources of the three splits: device-resident
        synthesizers, or with `data_in_hbm=False` host streamers seeded from
        `seed` (dl4ds_tpu/training/supervised.py:236-290)."""
        common = dict(upsampling=self.upsampling, scale=self.scale,
                      batch_size=self.global_batch_size,
                      patch_size=self.patch_size,
                      time_window=self.time_window,
                      static_vars=self.static_vars,
                      interpolation=self.interpolation, device=self.device,
                      shard=(self.rank, self.n_data_shards))
        season = self.season_ids or (None, None, None)
        splits = ((self.data_train, self.data_train_lr, self.predictors_train),
                  (self.data_val, self.data_val_lr, self.predictors_val),
                  (self.data_test, self.data_test_lr, self.predictors_test))
        sources = []
        for (data, data_lr, preds), sids in zip(splits, season):
            if self.data_in_hbm:
                sources.append(BatchSynthesizer(
                    data, data_lr, predictors=preds, season_ids=sids,
                    **common))
            else:
                sources.append(HostStreamer(
                    data, array_lr=data_lr, predictors=preds,
                    season_ids=sids, seed=self.seed, **common))
        self.ds_train, self.ds_val, self.ds_test = sources
        if self.space_group is not None:
            (hr_h, _), (lr_h, _) = self.grid_sizes()
            rows = lr_h if self.upsampling in POSTUPSAMPLING_METHODS else hr_h
            if rows % self.n_space:
                raise ValueError(
                    f'the model input of {rows} rows does not cut into '
                    f'{self.n_space} equal bands (the mesh\'s \'space\' '
                    f'dim); pick a patch_size or grid it divides')

    def setup_model(self):
        """Channel bookkeeping and the model, its weights drawn from `seed`
        or imported from `init_weights`, or the given `trained_model` pair,
        whose module is copied: the caller's stays as it was
        (dl4ds_tpu/training/supervised.py:295-327)."""
        if self.trained_model is not None:
            self.model, net = self.trained_model
            self.net = copy.deepcopy(net).to(self.device)
            if self.verbose:
                print('Loading pre-trained model')
            return
        n_channels, n_aux_channels = self.channel_counts(
            self.predictors_train, self.static_vars, self.season_ids)
        (hr_height, hr_width), (lr_height, lr_width) = self.grid_sizes()
        self.model = build_model(
            backbone=self.backbone, upsampling=self.upsampling,
            scale=self.scale, n_channels=n_channels,
            n_aux_channels=n_aux_channels,
            lr_size=(lr_height, lr_width), hr_size=(hr_height, hr_width),
            time_window=self.time_window, **self.architecture_params)
        self.net = self.model.init(self.seed, device=self.device)
        if self.init_weights is not None:
            import_keras_weights(self.model, self.net, self.init_weights)
            if self.verbose:
                src = (self.init_weights
                       if isinstance(self.init_weights, str)
                       else type(self.init_weights).__name__)
                print(f'Initialized parameters from reference checkpoint: '
                      f'{src}')
        if self.verbose == 1 and self.running_on_first_worker:
            print(self.model.summary(self.net))

    def _steps(self):
        """Steps an epoch, as the JAX trainer counts them."""
        n = self.data_train.shape[0] - (self.time_window or 0)
        return (self.steps_per_epoch if self.steps_per_epoch is not None
                else n // self.global_batch_size)

    def setup_optimizer(self):
        """Adam with eps 1e-7 over the network's parameters, its state
        created now; the device scalars of the rate, the update count and
        the accumulation's mini-step; the dropout generator, seeded from
        `seed` on the device; the EMA copy, which shares the network's
        buffers (the running statistics), and the gradient accumulators
        (dl4ds_tpu/training/supervised.py:330-385, one device). On the card
        Adam is the fused, capturable one (one multi-tensor kernel an
        update), its rate the device scalar, so that an eager step and a
        replayed one compute the same bits."""
        dev = self.device
        cuda = dev.type == 'cuda'
        self._tp_spec = None
        if self.model_group is not None:
            from ..parallel import (_has_batch_norm, _shard_network,
                                    tensor_param_shardings)
            if _has_batch_norm(self.net):
                raise ValueError(
                    'tensor-parallel training supports parameter-only models '
                    '(batch-norm statistics are per-shard mutable state); '
                    'build the model without batch norm')
            self._tp_spec = tensor_param_shardings(self.net, self.mesh)
            _shard_network(self.net, self._tp_spec, self.model_group)
        self.train_net = self.net
        self._params = list(self.net.parameters())
        lr0, self._schedule = build_schedule(
            self.learning_rate, self.lr_decay_after, self.lr_schedule,
            self.warmup_steps, max(self._steps(), 1) * self.epochs,
            scale_by=self.n_data_shards)
        self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._lr = torch.full((), lr0 or 0.0, dtype=torch.float32,
                              device=dev)
        self._set_rate()
        self.optimizer = torch.optim.Adam(self._params, lr=self._lr,
                                          eps=1e-7, capturable=cuda,
                                          fused=cuda or None)
        for p in self._params:
            self.optimizer.state[p] = dict(
                step=torch.zeros((), dtype=torch.float32,
                                 device=dev if cuda else 'cpu'),
                exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
                exp_avg_sq=torch.zeros_like(
                    p, memory_format=torch.preserve_format))
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            _rank_seed(self.seed, self.rank))
        set_dropout_generator(self.net, self.dropout_generator)
        self.ema_net = None
        if self.ema_decay > 0:
            self.ema_net = copy.deepcopy(self.net)
            set_dropout_generator(self.ema_net, self.dropout_generator)
            live = dict(self.net.named_modules())
            for name, m in self.ema_net.named_modules():
                for key in m._buffers:
                    m._buffers[key] = live[name]._buffers[key]
        self._ema = (list(self.ema_net.parameters())
                     if self.ema_net is not None else None)
        self._acc = ([torch.zeros_like(p) for p in self._params]
                     if self.gradient_accumulation_steps > 1 else None)
        self._mini = torch.zeros((), dtype=torch.float32, device=dev)
        self._row = torch.zeros(1, dtype=torch.long, device=dev)
        # the loss's gradient that seeds the backward: under a 'space' dim
        # 1 on the band group's first rank and 0 on the others
        self._loss_grad = torch.full((), float(self.space_rank == 0),
                                dtype=torch.float32, device=dev)
        self.n_updates = 0
        self.mini_step = 0

    @torch.no_grad()
    def _set_rate(self):
        """The rate of the next update, from the schedule at the device
        update count (device work only)."""
        if self._schedule is None:
            return
        rate = self._schedule(self._count)
        if torch.is_tensor(rate):
            self._lr.copy_(rate)
        else:
            self._lr.fill_(float(rate))

    def _state_tensors(self):
        """Every tensor a training or evaluation step changes in place."""
        opt = [t for p in self._params
               for t in self.optimizer.state[p].values()]
        return (self._params + opt + (self._ema or []) + (self._acc or [])
                + list(self.train_net.buffers())
                + [self._lr, self._count, self._mini, self._row])

    # ------------------------------------------------------------------
    def _step(self, batch, commit=True):
        """The body of one training step on `batch`: the forward, the loss
        and the backward, then with gradient accumulation the running mean
        of the microbatch gradients (optax.MultiSteps:
        acc + (g - acc) / (mini_step + 1)), and on the commit the update at
        the scheduled rate and the EMA, decay * ema + (1 - decay) * p
        (dl4ds_tpu/training/base.py:29-49). Device work only; returns the
        loss as a device scalar."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(self.train_net, batch)
        if self.space_group is None:
            loss.backward()
        else:
            loss.backward(self._loss_grad)
        with torch.no_grad():
            if self._acc is not None:
                grads = [p.grad for p in self._params]
                torch._foreach_sub_(grads, self._acc)
                torch._foreach_div_(grads, self._mini + 1)
                torch._foreach_add_(grads, self._acc)
                if not commit:
                    torch._foreach_copy_(self._acc, grads)
                    self._mini.add_(1)
                    return loss.detach()
                torch._foreach_zero_(self._acc)
                self._mini.zero_()
            if self.space_group is not None:
                # the band ranks' parts summed, the data rows averaged
                distributed.average_gradients(self._params, self.mesh_group,
                                              divisor=self.n_data_shards)
            elif self.data_group is not None:
                distributed.average_gradients(self._params, self.data_group)
            self._set_rate()
            self.optimizer.step()
            self._count.add_(1)
            if self._ema is not None:
                torch._foreach_mul_(self._ema, self.ema_decay)
                torch._foreach_add_(self._ema, self._params,
                                    alpha=1 - self.ema_decay)
        return loss.detach()

    def _loss(self, net, batch):
        """The loss of `net` on `batch` (this rank's part of the global
        batch; under a 'space' dim its data row's), in float32 whatever the
        model dtype, as the JAX trainer casts the output
        (dl4ds_tpu/training/supervised.py:461-462). The batch norms and the
        DSSIM losses reduce over the data ranks (`batch_group`); under a
        'space' dim the model runs on this rank's band of rows with the
        band rules and the loss on the output's rows joined; under a
        'model' dim it runs with the tensor rules."""
        if self.space_group is None:
            with distributed.batch_group(self.data_group), \
                    distributed.model_group(self.model_group):
                out = net(batch['lr'], batch['aux']).float()
                return self.lossf(batch['hr'], out)
        band = {k: None if batch[k] is None else
                distributed.band_rows(batch[k], self.space_group)
                for k in ('lr', 'aux')}
        with distributed.space_group(self.space_group, self.mesh_group):
            out = net(band['lr'], band['aux']).float()
        out = distributed.gather_rows(out, self.space_group)
        with distributed.batch_group(self.data_group):
            return self.lossf(batch['hr'], out)

    def _advance(self, commit):
        """The host's count of the step just run: the mini-step, and the
        updates on a commit."""
        self.mini_step = 0 if commit else self.mini_step + 1
        self.n_updates += int(commit)

    def _commits(self):
        return self.mini_step == self.gradient_accumulation_steps - 1

    def train_step(self, batch):
        """One training step on `batch` (a synthesizer's dict; under a
        mesh this rank's part of the global batch, under a 'space' dim its
        data row's, whole, of which it keeps its band), run eagerly: the
        forward, the loss, the backward and, on the optimizer's commit
        (every step without gradient accumulation), the update. Returns
        this rank's loss as a device scalar, not read back."""
        commit = self._commits()
        loss = self._step(batch, commit)
        self._advance(commit)
        return loss

    def _plan_step(self, plan, losses, commit):
        """A training step on plan row `_row`, its loss written to
        `losses[_row]`, then the next row: the function that is captured
        on the card."""
        loss = self._step(self.ds_train.step_batch(plan, self._row), commit)
        losses.index_copy_(0, self._row, loss.view(1))
        self._row.add_(1)

    @torch.no_grad()
    def _eval_plan_step(self, net, synth, plan, losses):
        """The loss of `net` on plan row `_row` of `synth`, written to
        `losses[_row]`, then the next row."""
        loss = self._loss(net, synth.step_batch(plan, self._row))
        losses.index_copy_(0, self._row, loss.view(1))
        self._row.add_(1)

    def eval_net(self):
        """The network that validation and test score: the EMA one with
        `ema_decay` (dl4ds_tpu/training/supervised.py:514-521)."""
        return self.ema_net if self.ema_net is not None else self.train_net

    # ------------------------------------------------------------------
    def run(self):
        """Train, validate every epoch, test and save
        (dl4ds_tpu/training/supervised.py:554-770)."""
        self.timing = Timing(self.verbose)
        self.setup_datagen()
        self.setup_model()
        self.setup_optimizer()
        generator = torch.Generator().manual_seed(int(self.seed))
        if self.resume_from_checkpoint is not None:
            self.trained_epochs = self._restore_checkpoint(
                self.resume_from_checkpoint, generator)
            if self.verbose:
                print(f'Resumed from checkpoint at epoch '
                      f'{self.trained_epochs}')
        b = self.global_batch_size
        steps = self._steps()
        if steps < 1:
            raise ValueError(
                f'data_train yields no full batch (n={self.ds_train.n}, '
                f'batch_size={b}); reduce batch_size or set steps_per_epoch')
        val_steps = (self.validation_steps
                     if self.validation_steps is not None
                     else max(self.ds_val.n // b, 1))
        test_steps = (self.test_steps if self.test_steps is not None
                      else max(self.ds_test.n // b, 1))
        streaming = not self.data_in_hbm
        if streaming:
            # the streamer emits whole batches: a split smaller than one
            # would evaluate no batch (dl4ds_tpu/training/supervised.py:
            # 592-606)
            for nm, ds in (('data_val', self.ds_val),
                           ('data_test', self.ds_test)):
                if ds.n < b:
                    raise ValueError(
                        f'{nm} yields no full global batch in the '
                        f'streaming tier (n={ds.n}, global_batch_size={b}); '
                        f'reduce batch_size, use fewer devices, or set '
                        f'data_in_hbm=True')
            if self.steps_per_execution:
                warnings.warn(
                    'steps_per_execution only applies to the in-HBM tier '
                    '(data_in_hbm=True); the streaming tier dispatches one '
                    'jitted step per host batch and will ignore it',
                    RuntimeWarning)
        spe = steps if streaming else (self.steps_per_execution or steps)
        # whole chunks, so that one captured step serves every chunk;
        # `epoch_indices` wraps the permutation, so the extra steps
        # resample the epoch (dl4ds_tpu/training/supervised.py:618-647)
        steps_exec = -(-steps // spe) * spe
        if steps_exec != steps:
            warnings.warn(
                f'steps_per_execution={spe} does not divide '
                f'steps_per_epoch={steps}; each epoch runs {steps_exec} '
                f'optimizer steps (padded up to whole chunks, so that one '
                f'captured step serves every chunk)', RuntimeWarning)
        self.runner = StepRunner(self, spe, {'val': (self.ds_val, val_steps),
                                             'test': (self.ds_test,
                                                      test_steps)})

        history = {'loss': [], 'val_loss': []}
        best_val = np.inf
        patience_left = self.patience
        if self.profile:
            self.start_profiler()
        for epoch in range(self.trained_epochs, self.epochs):
            self.train_net.train()
            if streaming:
                self.train_losses = self._reduce_mean(
                    self.runner.train_stream(self.ds_train, steps))
                train_loss = self.train_losses.mean().item()
                val_loss = self.runner.evaluate_stream('val', self.ds_val,
                                                       val_steps)
            else:
                self.train_losses = self._reduce_mean(self.runner.train(
                    self.ds_train.plan(generator, steps_exec)))
                train_loss = self.train_losses.mean().item()
                val_loss = self.runner.evaluate(
                    'val', self.ds_val.plan(generator, val_steps))
            history['loss'].append(train_loss)
            history['val_loss'].append(val_loss)
            if self.terminate_on_nan and not (np.isfinite(train_loss)
                                              and np.isfinite(val_loss)):
                warnings.warn(
                    f'Non-finite loss at epoch {epoch + 1} '
                    f'(loss={train_loss}, val_loss={val_loss}); terminating '
                    f'training', RuntimeWarning)
                self.stop_profiler()
                break
            if self.profile and epoch == self.trained_epochs:
                self.stop_profiler()
            if self.save_logs:
                self.log_scalars(epoch, loss=train_loss, val_loss=val_loss)
            if self.verbose:
                print(f'Epoch {epoch + 1}/{self.epochs}  '
                      f'loss: {train_loss:.6f}  val_loss: {val_loss:.6f}')
            if (self.checkpoints_frequency > 0
                    and (epoch + 1) % self.checkpoints_frequency == 0):
                self._save_full_checkpoint(epoch + 1, generator)
            if val_loss < best_val - self.min_delta:
                best_val = val_loss
                patience_left = self.patience
                if self.save_bestmodel:
                    self._save_checkpoint('best_model')
            elif self.early_stopping:
                patience_left -= 1
                if patience_left <= 0:
                    if self.verbose:
                        print(f'Early stopping at epoch {epoch + 1}')
                    break
        self.stop_profiler()
        self.fithist = history
        self.test_loss = (
            self.runner.evaluate_stream('test', self.ds_test, test_steps)
            if streaming else self.runner.evaluate(
                'test', self.ds_test.plan(generator, test_steps)))
        # with EMA on, the public weights are the averaged ones (what
        # predict() and save_results serve); train_net keeps the raw ones
        self.net = self._whole_net(self.eval_net())
        if self.verbose:
            print(f'\nScore on the test set: {self.test_loss}')
        self.timing.runtime()
        self.save_results()
        return self

    # ------------------------------------------------------------------
    # Under a 'model' dim: the whole weights and state, gathered with the
    # spec mirrored onto them (parallel.mirror_param_shardings), and this
    # rank's shards of whole ones
    # ------------------------------------------------------------------
    def _whole_net(self, net):
        """`net`, or under a 'model' dim its gathered copy (every rank of
        the group calls this)."""
        if self.model_group is None:
            return net
        from ..parallel import _whole_network
        return _whole_network(net, self.model_group)

    def _mirrored(self, state):
        from ..parallel import mirror_param_shardings
        names = [n for n, _ in self.train_net.named_parameters()]
        if isinstance(state, dict):      # a state dict: by name
            return {k: self._tp_spec.get(k) for k in state}
        local = dict(zip(names, self._params))
        return mirror_param_shardings(state, local, self._tp_spec, None)

    def _whole_state(self, state):
        """A list of one entry a parameter (Adam's states, accumulators),
        its shards gathered over the 'model' dim into whole tensors."""
        if self.model_group is None:
            return state
        from ..distributed import _joined
        dims = self._mirrored(state)

        def whole(v, dim):
            return v if dim is None else _joined(v.detach(), dim,
                                                 self.model_group)
        return [{k: whole(v, d[k]) for k, v in e.items()}
                if isinstance(e, dict) else whole(e, d)
                for e, d in zip(state, dims)]

    def _local_state(self, state):
        """This rank's shards of a whole state (a state dict or a list of
        one entry a parameter), under a 'model' dim; else the state."""
        if self.model_group is None:
            return state
        n, r = self.n_model, self.model_rank

        def part(v, dim):
            if dim is None:
                return v
            k = v.shape[dim] // n
            return v.narrow(dim, r * k, k)
        if isinstance(state, dict):
            dims = self._mirrored(state)
            return {k: part(v, dims[k]) for k, v in state.items()}
        out = []
        for e, p, (name, _) in zip(state, self._params,
                                   self.train_net.named_parameters()):
            dim = self._tp_spec[name]
            shape = list(p.shape)
            if dim is not None:
                shape[dim] *= n
            if isinstance(e, dict):
                out.append({k: part(v, dim) if torch.is_tensor(v)
                            and list(v.shape) == shape else v
                            for k, v in e.items()})
            else:
                out.append(part(e, dim))
        return out

    def _save_checkpoint(self, name):
        """The weights that validation scores (the EMA ones with
        `ema_decay`), the ones to serve, under save_path/`name`, written
        by the first worker while the others wait."""
        state = self._whole_net(self.eval_net()).state_dict()
        if self.running_on_first_worker:
            self._checkpoint_save(
                os.path.join(self.savecheckpoint_path, name),
                {'params': _cpu(state)})
        self._barrier()

    def _save_full_checkpoint(self, epoch, generator):
        """The full training state after `epoch` epochs, for
        `resume_from_checkpoint`: parameters, Adam's state, the EMA, the
        accumulators, the counts, the epoch and the states of the plan
        generator and the dropout generator, under
        save_path/checkpoints/epoch-<epoch>, written by the first worker
        while the others wait; under a mesh the dropout generators of
        every rank, gathered first."""
        dropout_state = self.dropout_generator.get_state()
        if self.data_group is not None:
            states = [None] * self.n_data_shards
            torch.distributed.all_gather_object(states, dropout_state,
                                                group=self.data_group)
            dropout_state = states
        # the whole state, gathered over a 'model' dim on every rank
        params = self._whole_net(self.train_net).state_dict()
        opt_state = self._whole_state([self.optimizer.state[p]
                                       for p in self._params])
        ema = (self._whole_net(self.ema_net).state_dict()
               if self.ema_net is not None else None)
        acc = (self._whole_state(self._acc) if self._acc is not None
               else None)
        if not self.running_on_first_worker:
            self._barrier()
            return
        payload = {
            'params': _cpu(params),
            'opt_state': [_cpu(state) for state in opt_state],
            'n_updates': self.n_updates, 'mini_step': self.mini_step,
            'epoch': epoch, 'generator': generator.get_state(),
            'dropout_generator': dropout_state}
        if not self.data_in_hbm:
            # the streamers' draws, so that a resumed run streams on
            payload['streams'] = [ds.rng.bit_generator.state for ds in
                                  (self.ds_train, self.ds_val, self.ds_test)]
        if ema is not None:
            payload['ema_params'] = _cpu(ema)
        if acc is not None:
            payload['acc_grads'] = [t.cpu() for t in acc]
        self._checkpoint_save(os.path.join(
            self.savecheckpoint_path, 'checkpoints', f'epoch-{epoch}'),
            payload)
        self._barrier()

    @torch.no_grad()
    def _restore_checkpoint(self, path, generator):
        """Load a full checkpoint into the trainer's tensors in place and
        the generators; returns its epoch."""
        payload = self._checkpoint_load(path)
        self.train_net.load_state_dict(self._local_state(payload['params']))
        for p, saved in zip(self._params,
                            self._local_state(payload['opt_state'])):
            for key, value in saved.items():
                self.optimizer.state[p][key].copy_(value)
        if self.ema_net is not None and 'ema_params' in payload:
            self.ema_net.load_state_dict(
                self._local_state(payload['ema_params']))
        if self._acc is not None and 'acc_grads' in payload:
            for t, saved in zip(self._acc,
                                self._local_state(payload['acc_grads'])):
                t.copy_(saved)
        self.n_updates = int(payload['n_updates'])
        self.mini_step = int(payload['mini_step'])
        self._count.fill_(self.n_updates)
        self._mini.fill_(self.mini_step)
        self._set_rate()
        generator.set_state(payload['generator'])
        if 'dropout_generator' in payload:
            state = payload['dropout_generator']
            if isinstance(state, list):
                if len(state) != self.n_data_shards:
                    raise ValueError(
                        f'the checkpoint holds {len(state)} ranks\' '
                        f'dropout generators; this run has '
                        f'{self.n_data_shards}')
                state = state[self.rank]
            elif self.n_data_shards > 1:
                raise ValueError('the checkpoint holds one dropout '
                                 'generator; this run has '
                                 f'{self.n_data_shards} ranks')
            self.dropout_generator.set_state(state)
        if not self.data_in_hbm and 'streams' in payload:
            for ds, state in zip((self.ds_train, self.ds_val, self.ds_test),
                                 payload['streams']):
                ds.rng.bit_generator.state = state
        return int(payload['epoch'])


def _season_tables(season_ids, time_metadata, splits, time_window):
    """The (train, val, test) season id tables: `season_ids` as given, or
    decoded from `time_metadata`, a (train, val, test) tuple of
    datetime-like arrays or 'auto' (each split's xr time coordinate), with
    the JAX trainer's checks (dl4ds_tpu/training/supervised.py:194-231)."""
    if season_ids is not None and (not isinstance(season_ids, (tuple, list))
                                   or len(season_ids) != 3):
        raise ValueError('`season_ids` must be a (train, val, test) '
                         'tuple of int arrays')
    if season_ids is not None and time_metadata is not None:
        raise ValueError('pass either `season_ids` or `time_metadata`, '
                         'not both (time_metadata would be silently '
                         'shadowed by the explicit season_ids)')
    if time_metadata is None:
        return season_ids
    if isinstance(time_metadata, str):
        if time_metadata != 'auto':
            raise ValueError(
                f'unknown time_metadata={time_metadata!r}; pass a '
                f"(train, val, test) tuple of datetimes or 'auto'")
        time_metadata = tuple(_time_coord(a) for a in splits)
        if any(t is None for t in time_metadata):
            raise ValueError(
                "time_metadata='auto' requires all three splits to "
                "be xr.DataArrays with time coordinates")
    elif (not isinstance(time_metadata, (tuple, list))
            or len(time_metadata) != 3):
        raise ValueError('`time_metadata` must be a (train, val, '
                         "test) tuple of datetime-like arrays or "
                         "'auto'")
    return tuple(season_ids_from_time(t, time_window) for t in time_metadata)


def _rank_seed(seed, rank):
    """The dropout seed of a data-parallel rank, drawn from (seed, rank)
    so that the ranks draw different masks: `seed` itself on rank 0 (and
    without a mesh), a 32-bit word of numpy's SeedSequence elsewhere (a
    CPU generator keeps 32 bits of its seed)."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed) % 2 ** 63, rank])
               .generate_state(1)[0])


def _cpu(tensors):
    return {k: v.detach().cpu() for k, v in tensors.items()}


class StepRunner:
    """The steps of a run: the plan rows of a chunk on the device, the row
    counter and the loss buffers, with each step function captured as a
    CUDA graph on the card and called eagerly on the CPU. With a
    `HostStreamer` as a split's source, its 'plan' is the input buffers of
    one batch (`plan_buffers`), which `train_stream` and `evaluate_stream`
    fill from each streamed batch before running the step.

    The training functions are 'step' (a step with its update), or with
    gradient accumulation 'accumulate' and 'commit', replayed as the
    host's mini-step picks them; the evaluation functions are one a split
    of `evals` ({split: (synthesizer, steps)}), scoring `eval_net()`.
    Graphs share one memory pool. `graphs` maps each name to its
    `CapturedStep` on the card. A training step's loss is a float32 tensor
    of `loss_shape` (a scalar; the CGAN trainer's four losses). Under a
    data mesh each plan or streamed batch is cut to this rank's part
    (the sources' `local_part`) before it is uploaded."""

    def __init__(self, trainer, steps_per_execution, evals, loss_shape=()):
        tr = self.trainer = trainer
        dev = tr.device
        self.spe = steps_per_execution
        self.plan = tr.ds_train.plan_buffers(self.spe)
        self.losses = torch.zeros((self.spe, *loss_shape),
                                  dtype=torch.float32, device=dev)
        fns = {}
        if tr.gradient_accumulation_steps > 1:
            fns['accumulate'] = lambda: tr._plan_step(self.plan, self.losses,
                                                      False)
            fns['commit'] = lambda: tr._plan_step(self.plan, self.losses,
                                                  True)
        else:
            fns['step'] = lambda: tr._plan_step(self.plan, self.losses, True)
        self.evals, self.sources = {}, {}
        net = tr.eval_net()
        for split, (synth, steps) in evals.items():
            plan = synth.plan_buffers(steps)
            losses = torch.zeros(steps, dtype=torch.float32, device=dev)
            self.evals[split] = (plan, losses)
            self.sources[split] = synth
            fns[split] = (lambda synth=synth, plan=plan, losses=losses:
                          tr._eval_plan_step(net, synth, plan, losses))
        self.fns = fns
        self.graphs = {}
        if dev.type == 'cuda':
            state = tr._state_tensors()
            pool = None
            for name, fn in fns.items():
                if name in self.evals:
                    net.eval()
                else:
                    tr.train_net.train()
                self.graphs[name] = CapturedStep(
                    fn, state, pool=pool, rewind=[tr._row],
                    generators=[tr.dropout_generator])
                pool = self.graphs[name].pool()
            tr.train_net.train()

    def _run(self, name):
        if self.graphs:
            self.graphs[name].replay()
        else:
            self.fns[name]()

    @staticmethod
    def _upload(bufs, plan, rows):
        for key, buf in bufs.items():
            buf.copy_(plan[key][rows], non_blocking=True)

    def train(self, plan):
        """Run the training steps of `plan` (an epoch's, whole chunks),
        a chunk of rows at a time; returns their losses on the device."""
        tr = self.trainer
        n = plan['idx'].shape[0]
        plan = tr.ds_train.local_part(plan)
        if self.graphs:
            plan = {k: v.pin_memory() for k, v in plan.items()}
        out = torch.empty((n, *self.losses.shape[1:]), dtype=torch.float32,
                          device=tr.device)
        accumulate = tr.gradient_accumulation_steps > 1
        for c in range(0, n, self.spe):
            self._upload(self.plan, plan, slice(c, c + self.spe))
            tr._row.zero_()
            for _ in range(self.spe):
                commit = tr._commits()
                self._run(('commit' if commit else 'accumulate')
                          if accumulate else 'step')
                tr._advance(commit)
            out[c:c + self.spe].copy_(self.losses)
        return out

    def train_stream(self, stream, steps):
        """Run one streamed epoch of `steps` training steps: each batch of
        `stream` (a `HostStreamer`) copied into the step's input buffers on
        the current stream, then the step run (replayed on the card);
        returns their losses on the device."""
        tr = self.trainer
        accumulate = tr.gradient_accumulation_steps > 1
        tr._row.zero_()
        for raw in stream.stream(1, steps):
            self._fill(self.plan, stream.local_part(raw))
            commit = tr._commits()
            self._run(('commit' if commit else 'accumulate')
                      if accumulate else 'step')
            tr._advance(commit)
        return self.losses[:steps].clone()

    def evaluate_stream(self, split, stream, steps):
        """The mean loss of `eval_net()` over `steps` batches of `stream`,
        in eval mode, each copied into the split's input buffers."""
        tr = self.trainer
        bufs, losses = self.evals[split]
        tr.eval_net().eval()
        tr._row.zero_()
        for raw in stream.stream(1, steps):
            self._fill(bufs, stream.local_part(raw))
            self._run(split)
        return tr._reduce_mean(losses[:steps].clone()).mean().item()

    @staticmethod
    def _fill(bufs, raw):
        for key, buf in bufs.items():
            buf.copy_(raw[key], non_blocking=True)

    def evaluate(self, split, plan):
        """The mean loss of `eval_net()` over the rows of `plan` (`split`'s
        steps), in eval mode, averaged over the ranks under a mesh."""
        tr = self.trainer
        bufs, losses = self.evals[split]
        tr.eval_net().eval()
        plan = self.sources[split].local_part(plan)
        if self.graphs:
            plan = {k: v.pin_memory() for k, v in plan.items()}
        self._upload(bufs, plan, slice(None))
        tr._row.zero_()
        for _ in range(losses.shape[0]):
            self._run(split)
        return tr._reduce_mean(losses.clone()).mean().item()
