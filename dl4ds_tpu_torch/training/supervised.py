"""
Supervised training procedure (the counterpart of
`dl4ds_tpu/training/supervised.py`).

One device. Batches are built on the device by `BatchSynthesizer` from
indices and patch offsets that a CPU `torch.Generator`, seeded by `seed`,
draws, so one seed gives the same batches on every device. A step is the
forward in train mode, the loss, the backward (for a spatio-temporal model,
K2's training variant and the K3 BPTT kernels on the GPU) and an Adam
update. Losses stay on the device and are read once an epoch. Validation
and test run under `torch.no_grad()`, so the ConvLSTM layers run K2's
inference variant. Adam uses Keras's eps of 1e-7, and a 2-tuple learning
rate is optax's piecewise-constant schedule: the second rate once
`lr_decay_after` updates have been made.
"""

import warnings

import numpy as np
import torch

from ..dataloader import BatchSynthesizer
from ..models import build_model
from ..utils import Timing, not_ported
from .base import Trainer

__all__ = ['SupervisedTrainer']


class SupervisedTrainer(Trainer):
    """Supervised (pixel-loss) trainer, with the JAX package's signature.

    `use_multiprocessing`, `model_list`, `gpu_memory_growth` and
    `show_plot` are accepted and do nothing, as in the JAX package. The
    options that are not ported raise NotImplementedError naming their
    ROADMAP item: EMA, `lr_schedule`/`warmup_steps`, gradient accumulation,
    `trained_model`, checkpoints, resume, saving, logs, the profiler and
    `steps_per_execution` (4); seasons (3); `data_*_lr` (5);
    `data_in_hbm=False` (9); `mesh` and `devices` (10); `init_weights`
    (11)."""

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
        unported = [
            (data_val_lr is not None or data_test_lr is not None,
             'given LR arrays (`data_val_lr`, `data_test_lr`)', 5),
            (season_ids is not None or time_metadata is not None,
             'season channels (`season_ids`, `time_metadata`)', 3),
            (not data_in_hbm, 'host streaming (`data_in_hbm=False`)', 9),
            (init_weights is not None, 'Keras weight import (`init_weights`)',
             11),
            (ema_decay != 0.0, 'parameter EMA (`ema_decay`)', 4),
            (lr_schedule is not None or warmup_steps != 0,
             '`lr_schedule` and `warmup_steps`', 4),
            (gradient_accumulation_steps != 1, 'gradient accumulation', 4),
            (save_bestmodel or checkpoints_frequency
             or resume_from_checkpoint is not None
             or trained_model is not None,
             'checkpoints, resume and `trained_model`', 4),
            (save_logs or profile, '`save_logs` and `profile`', 4),
            (steps_per_execution is not None, '`steps_per_execution`', 4)]
        for cond, what, item in unported:
            if cond:
                raise not_ported(what, item)
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
        self.early_stopping = early_stopping
        self.patience = patience
        self.min_delta = min_delta
        self.architecture_params = architecture_params
        self.trained_epochs = trained_epochs
        self.seed = seed
        self.terminate_on_nan = terminate_on_nan
        self.model = None
        self.net = None

    # ------------------------------------------------------------------
    def setup_datagen(self):
        """Device-resident batch synthesizers for the three splits."""
        common = dict(upsampling=self.upsampling, scale=self.scale,
                      batch_size=self.global_batch_size,
                      patch_size=self.patch_size,
                      time_window=self.time_window,
                      static_vars=self.static_vars,
                      interpolation=self.interpolation, device=self.device)
        self.ds_train = BatchSynthesizer(
            self.data_train, None, predictors=self.predictors_train, **common)
        self.ds_val = BatchSynthesizer(
            self.data_val, None, predictors=self.predictors_val, **common)
        self.ds_test = BatchSynthesizer(
            self.data_test, None, predictors=self.predictors_test, **common)

    def setup_model(self):
        """Channel bookkeeping and the model, its weights drawn from
        `seed` (dl4ds_tpu/training/supervised.py:295-327)."""
        n_channels, n_aux_channels = self.channel_counts(
            self.predictors_train, self.static_vars)
        (hr_height, hr_width), (lr_height, lr_width) = self.grid_sizes()
        self.model = build_model(
            backbone=self.backbone, upsampling=self.upsampling,
            scale=self.scale, n_channels=n_channels,
            n_aux_channels=n_aux_channels,
            lr_size=(lr_height, lr_width), hr_size=(hr_height, hr_width),
            time_window=self.time_window, **self.architecture_params)
        self.net = self.model.init(self.seed, device=self.device)

    def setup_optimizer(self):
        """Adam with eps 1e-7 over the network's parameters, and the
        learning rate of each update (dl4ds_tpu/training/supervised.py:
        330-385, one device)."""
        lr = self.learning_rate
        if isinstance(lr, (tuple, list)) and len(lr) > 1:
            # optax.piecewise_constant_schedule: the scale applies once the
            # update count (0 for the first update) reaches the boundary;
            # init * scale in float32, as optax forms it
            lr0, boundary = float(lr[0]), int(self.lr_decay_after)
            lr1 = float(np.float32(lr0) * np.float32(lr[1] / lr[0]))
            self._lr = lambda count: lr0 if count < boundary else lr1
        else:
            lr0 = float(lr[0] if isinstance(lr, (tuple, list)) else lr)
            self._lr = lambda count: lr0
        self.optimizer = torch.optim.Adam(self.net.parameters(),
                                          lr=self._lr(0), eps=1e-7)
        self.n_updates = 0

    # ------------------------------------------------------------------
    def train_step(self, batch):
        """One optimizer step on `batch` (a synthesizer's dict); returns the
        loss as a device scalar, not read back."""
        out = self.net(batch['lr'], batch['aux'])
        loss = self.lossf(batch['hr'], out)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group['lr'] = self._lr(self.n_updates)
        self.optimizer.step()
        self.n_updates += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, batch):
        """The loss of `batch` without a gradient, as a device scalar."""
        return self.lossf(batch['hr'], self.net(batch['lr'], batch['aux']))

    def _evaluate(self, synth, steps, generator):
        """Mean loss over `steps` batches of one shuffled pass of `synth`,
        in eval mode."""
        self.net.eval()
        idx = synth.epoch_indices(generator, steps=steps)
        losses = [self.eval_step(synth(idx[r], generator=generator))
                  for r in range(steps)]
        return torch.stack(losses).mean().item()

    # ------------------------------------------------------------------
    def run(self):
        """Train, validate every epoch and test
        (dl4ds_tpu/training/supervised.py:554-770, without saving)."""
        self.timing = Timing(self.verbose)
        self.setup_datagen()
        self.setup_model()
        self.setup_optimizer()
        generator = torch.Generator().manual_seed(int(self.seed))
        b = self.global_batch_size
        steps = (self.steps_per_epoch if self.steps_per_epoch is not None
                 else self.ds_train.n // b)
        if steps < 1:
            raise ValueError(
                f'data_train yields no full batch (n={self.ds_train.n}, '
                f'batch_size={b}); reduce batch_size or set steps_per_epoch')
        val_steps = (self.validation_steps
                     if self.validation_steps is not None
                     else max(self.ds_val.n // b, 1))

        history = {'loss': [], 'val_loss': []}
        best_val = np.inf
        patience_left = self.patience
        for epoch in range(self.trained_epochs, self.epochs):
            self.net.train()
            idx = self.ds_train.epoch_indices(generator, steps=steps)
            losses = [self.train_step(self.ds_train(idx[c],
                                                    generator=generator))
                      for c in range(steps)]
            train_loss = torch.stack(losses).mean().item()
            val_loss = self._evaluate(self.ds_val, val_steps, generator)
            history['loss'].append(train_loss)
            history['val_loss'].append(val_loss)
            if self.terminate_on_nan and not (np.isfinite(train_loss)
                                              and np.isfinite(val_loss)):
                warnings.warn(
                    f'Non-finite loss at epoch {epoch + 1} '
                    f'(loss={train_loss}, val_loss={val_loss}); terminating '
                    f'training', RuntimeWarning)
                break
            if self.verbose:
                print(f'Epoch {epoch + 1}/{self.epochs}  '
                      f'loss: {train_loss:.6f}  val_loss: {val_loss:.6f}')
            if val_loss < best_val - self.min_delta:
                best_val = val_loss
                patience_left = self.patience
            elif self.early_stopping:
                patience_left -= 1
                if patience_left <= 0:
                    if self.verbose:
                        print(f'Early stopping at epoch {epoch + 1}')
                    break
        self.fithist = history

        test_steps = (self.test_steps if self.test_steps is not None
                      else max(self.ds_test.n // b, 1))
        self.test_loss = self._evaluate(self.ds_test, test_steps, generator)
        if self.verbose:
            print(f'\nScore on the test set: {self.test_loss}')
        self.timing.runtime()
        return self
