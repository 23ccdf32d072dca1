"""
Conditional GAN training (the counterpart of `dl4ds_tpu/training/cgan.py`,
pix2pix-style).

Losses (dl4ds_tpu/training/cgan.py:41-66):
  G: BCE(ones, D(fake)) + 100 * pixel_loss(fake, target)
  D: BCE(ones, D(real)) + BCE(zeros, D(fake))

One step is one fused G+D update, as in the JAX `train_step`: G's pass,
D's pass on the real and the generated grids, both gradients, then both
Adam updates and the generator's EMA. D(fake) is computed once and feeds
both losses, so both see one dropout mask, as the JAX step's reused key
gives it; D(real) draws its own. G's gradient is taken with D's parameters
held fixed and D's on `fake` without its gradient: two backward passes,
each restricted to its network's parameters (`torch.autograd.backward(...,
inputs=)`), so that neither computes the other's weight gradients nor
touches the other's `.grad`.

As in `SupervisedTrainer`, each epoch's batches are planned on the host
from `seed`, and on the card the step (the batch from its plan row, both
passes, both updates, the EMA) is captured once as a CUDA graph and
replayed, the whole epoch a chunk (`StepRunner`), with no eager fallback;
on the CPU the same step runs eagerly. Both optimizers are Adam with b1
0.5 and eps 1e-7 (fused and capturable on the card), each at its own
scheduled rate, accumulating over `gradient_accumulation_steps` with
optax.MultiSteps' semantics and committing together; the EMA of the
generator advances on the commit. In a bfloat16 model the losses keep the
JAX package's dtypes: the BCEs are bfloat16 (their clip bounds rounded to
bfloat16, as JAX's weak typing rounds them, so a D output of 1.0 gives
NaN), the pixel loss and G's total float32.

Data parallelism (`mesh`, `distributed.global_mesh()`: one process a
device) runs the JAX trainer's fused step sharded over 'data'
(dl4ds_tpu/training/cgan.py:139-155, 396-470): every rank draws the same
global plan (`global_batch_size` wide) from `seed` and builds its columns
of it; the step runs within `distributed.batch_group`, so that a DSSIM
pixel loss takes its range over the global batch, and on each commit one
mean all-reduce of G's and D's gradients together
(`distributed.average_gradients`, one flat buffer) precedes both Adams.
The rates are not scaled (the JAX CGAN trainer applies no Goyal scaling).
The four losses are averaged over the ranks, and each rank computes the
whole test loss, so every rank records the same values; the first worker
alone prints and writes checkpoints, `losses.npy` and results, the others
waiting for its checkpoints. Each rank's dropout masks, in both networks,
come from its own generator, seeded from (seed, rank).
"""

import copy
import os
import warnings

import numpy as np
import torch

from .. import distributed
from ..dataloader import BatchSynthesizer, HostStreamer
from ..models import build_model, residual_discriminator
from ..models.blocks import (BatchNorm, set_dropout_generator,
                             use_dropout_generator, _rounded)
from ..models.nets import _mean
from ..compat import import_keras_weights
from ..utils import Timing, resolve_device
from .base import Trainer
from .schedules import cosine_decay_schedule, warmup_cosine_decay_schedule
from .supervised import StepRunner, _cpu, _rank_seed

__all__ = ['CGANTrainer', 'load_checkpoint', 'train_step', 'generator_loss',
           'discriminator_loss']

_EPS = 1e-7


def _bce(labels, probs):
    """Binary cross-entropy on probabilities (dl4ds_tpu/training/cgan.py:
    41-46): the probabilities clipped to [1e-7, 1 - 1e-7] with the bounds
    rounded to their dtype (in bfloat16 the upper one is 1.0), as
    minimum(maximum(p, lo), hi), whose gradient is halved at a tie as
    jnp.clip's is."""
    dt, dev = probs.dtype, probs.device
    lo = torch.full((), _rounded(_EPS, dt), dtype=dt, device=dev)
    hi = torch.full((), _rounded(1.0 - _EPS, dt), dtype=dt, device=dev)
    p = torch.minimum(torch.maximum(probs, lo), hi)
    return -_mean(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))


def generator_loss(disc_generated_output, gen_output, target,
                   gen_pxloss_function, lambda_scaling_factor=100):
    """(total, gan, pixel): BCE(ones, D(fake)) + lambda * the pixel loss
    (dl4ds_tpu/training/cgan.py:49-56)."""
    gan_loss = _bce(torch.ones_like(disc_generated_output),
                    disc_generated_output)
    px_loss = gen_pxloss_function(target, gen_output)
    return gan_loss + lambda_scaling_factor * px_loss, gan_loss, px_loss


def discriminator_loss(disc_real_output, disc_generated_output):
    """BCE(ones, D(real)) + BCE(zeros, D(fake))
    (dl4ds_tpu/training/cgan.py:59-65)."""
    real_loss = _bce(torch.ones_like(disc_real_output), disc_real_output)
    gen_loss = _bce(torch.zeros_like(disc_generated_output),
                    disc_generated_output)
    return real_loss + gen_loss


def gan_gradients(generator, discriminator, batch, gen_pxloss_function,
                  lambda_scaling_factor=100):
    """Both passes of the fused step on a (lr, hr, aux) batch: G's
    gradient into the generator's `.grad` with D held fixed, then D's into
    the discriminator's `.grad` on the generated grids without their
    gradient, from one D(fake) (its dropout mask drawn once) and one
    D(real). Returns (g_total, g_gan, g_px, d_loss)."""
    lr, hr = batch['lr'], batch['hr']
    fake = generator(lr, batch['aux'])
    d_fake = discriminator(lr, fake)
    d_real = discriminator(lr, hr)
    g_total, g_gan, g_px = generator_loss(d_fake, fake, hr,
                                          gen_pxloss_function,
                                          lambda_scaling_factor)
    d_loss = discriminator_loss(d_real, d_fake)
    torch.autograd.backward(g_total, inputs=list(generator.parameters()),
                            retain_graph=True)
    torch.autograd.backward(d_loss, inputs=list(discriminator.parameters()))
    return g_total, g_gan, g_px, d_loss


def train_step(generator, discriminator, batch, gen_optimizer,
               disc_optimizer, gen_pxloss_function, lambda_scaling_factor=100,
               ema_params=None, ema_decay=0.0):
    """One fused G+D update on a (lr, hr, aux) batch, the counterpart of
    the JAX `train_step` (dl4ds_tpu/training/cgan.py:68-118): both
    gradients (`gan_gradients`), then both optimizers' steps, then with
    `ema_decay` > 0 the EMA of the generator's parameters into
    `ema_params` (a list of tensors beside them), decay * ema + (1 - decay)
    * p. Returns (g_total, g_gan, g_px, d_loss) as device scalars."""
    gen_optimizer.zero_grad(set_to_none=True)
    disc_optimizer.zero_grad(set_to_none=True)
    losses = gan_gradients(generator, discriminator, batch,
                           gen_pxloss_function, lambda_scaling_factor)
    gen_optimizer.step()
    disc_optimizer.step()
    if ema_decay > 0:
        with torch.no_grad():
            torch._foreach_mul_(ema_params, ema_decay)
            torch._foreach_add_(ema_params, list(generator.parameters()),
                                alpha=1 - ema_decay)
    return tuple(v.detach() for v in losses)


def _adam(params, lr, device):
    """Adam with b1 0.5 and Keras's eps 1e-7 (dl4ds_tpu/training/cgan.py:
    374-383) at the device rate `lr`, its state created now; fused and
    capturable on the card."""
    cuda = device.type == 'cuda'
    opt = torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-7,
                           capturable=cuda, fused=cuda or None)
    for p in params:
        opt.state[p] = dict(
            step=torch.zeros((), dtype=torch.float32,
                             device=device if cuda else 'cpu'),
            exp_avg=torch.zeros_like(p, memory_format=torch.preserve_format),
            exp_avg_sq=torch.zeros_like(
                p, memory_format=torch.preserve_format))
    return opt


class CGANTrainer(Trainer):
    """Adversarial trainer, with the JAX package's signature
    (dl4ds_tpu/training/cgan.py:121-228): a generator from the model zoo
    (`build_model` with `generator_params`) and the two-branch
    `residual_discriminator` (with `discriminator_params`), G's weights
    drawn from `seed` and D's from `seed + 1`. A `dtype` in both parameter
    dicts trains a bfloat16 pair (float32 parameters and Adam).

    `learning_rates` is one rate or a (G, D) pair; `lr_schedule` None,
    'cosine' (each rate decayed to 0 over the run), 'warmup_cosine' (a
    ramp from 0 over `warmup_steps` updates, 0 meaning a twentieth of the
    run, then the decay) or a callable of the update count, for both.
    `model_list` and `gpu_memory_growth` are accepted and do nothing.
    `mesh` (the one dim 'data') trains data-parallel over the process
    group, `batch_size` being a rank's batch (see the module's docstring);
    a 'model' or 'space' dim raises the JAX trainer's NotImplementedError.
    `devices=[d]` selects `d`; a longer list raises, one process driving
    one device. `init_weights` loads a
    reference Keras checkpoint into the generator
    (`compat.import_keras_weights`); the discriminator starts fresh.
    `data_in_hbm=False` streams the training split from host RAM or a
    memmapped file (`HostStreamer`, seeded from `seed`), each batch copied
    into the input buffers of the captured fused step, which is replayed
    once a batch; the test loss reads the test split as before.

    After `run`: `gentotal`, `gengan`, `gen_pxloss` and `disc` hold the
    last step's losses of each epoch; `gen_net` and `disc_net` the trained
    networks; `net` the generator to serve (the EMA one with `ema_decay`),
    with `model = generator`; `test_loss`. `predict(trainer)` serves the
    raw `gen_net`, as the JAX `predict` serves a CGAN trainer's raw
    generator parameters."""

    def __init__(self, backbone, upsampling, data_train, data_test,
                 data_train_lr=None, data_test_lr=None, predictors_train=None,
                 predictors_test=None, scale=5, patch_size=None,
                 time_window=None, loss='mae', epochs=60, batch_size=16,
                 learning_rates=(2e-4, 2e-4), device='cuda', model_list=None,
                 steps_per_epoch=None, interpolation='inter_area',
                 static_vars=None, checkpoints_frequency=0, save=False,
                 save_path=None, save_logs=False, save_loss_history=True,
                 generator_params=None, discriminator_params=None,
                 verbose=True, seed=42, mesh=None, devices=None,
                 gpu_memory_growth=None, resume_from_checkpoint=None,
                 data_in_hbm=True, terminate_on_nan=True,
                 gradient_accumulation_steps=1, ema_decay=0.0,
                 lr_schedule=None, warmup_steps=0, init_weights=None):
        super().__init__(
            backbone=backbone, upsampling=upsampling, data_train=data_train,
            data_train_lr=data_train_lr, time_window=time_window, loss=loss,
            batch_size=batch_size, patch_size=patch_size, scale=scale,
            device=device, verbose=verbose, model_list=model_list, save=save,
            save_path=save_path, show_plot=False, mesh=mesh, devices=devices)
        self.data_test = self._as_array(data_test, 'data_test')
        self.data_test_lr = (self._as_array(data_test_lr, 'data_test_lr')
                             if data_test_lr is not None else None)
        for name, preds in (('predictors_train', predictors_train),
                            ('predictors_test', predictors_test)):
            if preds is not None and not isinstance(preds, list):
                raise TypeError(f'`{name}` must be a list of ndarrays')
        self.predictors_train = predictors_train
        self.predictors_test = predictors_test
        self.epochs = epochs
        self.learning_rates = learning_rates
        self.steps_per_epoch = steps_per_epoch
        self.interpolation = interpolation
        self.static_vars = static_vars
        self.checkpoints_frequency = checkpoints_frequency
        self.save_loss_history = save_loss_history
        self.save_logs = save_logs
        self.generator_params = generator_params or {}
        self.discriminator_params = discriminator_params or {}
        self.init_weights = init_weights
        self.seed = seed
        self.data_in_hbm = data_in_hbm
        self.terminate_on_nan = terminate_on_nan
        if (not isinstance(gradient_accumulation_steps, int)
                or gradient_accumulation_steps < 1):
            raise ValueError('`gradient_accumulation_steps` must be an '
                             'integer >= 1')
        self.gradient_accumulation_steps = gradient_accumulation_steps
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError('`ema_decay` must be in [0, 1)')
        self.ema_decay = float(ema_decay)
        if lr_schedule not in (None, 'cosine', 'warmup_cosine') \
                and not callable(lr_schedule):
            raise ValueError(
                f"`lr_schedule` must be None, 'cosine', 'warmup_cosine' or "
                f"a callable schedule, got {lr_schedule!r}")
        if warmup_steps < 0:
            raise ValueError('`warmup_steps` must be >= 0')
        self.lr_schedule = lr_schedule
        self.warmup_steps = warmup_steps
        self.resume_from_checkpoint = resume_from_checkpoint
        self.gentotal, self.gengan, self.gen_pxloss, self.disc = [], [], [], []
        if self.time_window is not None and not self.model_is_spatiotemporal:
            # time_window <= 1 builds spatial models
            self.time_window = None
        self.model = None
        self.net = None

    def _setup_mesh(self, mesh):
        """The base class's data mesh; a 'model' or 'space' dim is the JAX
        trainer's refusal (dl4ds_tpu/training/cgan.py:151-154)."""
        names = set(getattr(mesh, 'mesh_dim_names', None) or ())
        if names & {'model', 'space'}:
            raise NotImplementedError(
                "2-D ('model'/'space') meshes are routed through "
                'SupervisedTrainer; the CGAN trainer supports the 1-D '
                "('data',) mesh")
        super()._setup_mesh(mesh)

    # ------------------------------------------------------------------
    def setup_datagen(self):
        """The batch source of the training split: the device-resident
        synthesizer, or with `data_in_hbm=False` the host streamer seeded
        from `seed` (dl4ds_tpu/training/cgan.py:317-330); under a mesh
        each plans the global batch and builds this rank's part."""
        common = dict(upsampling=self.upsampling, scale=self.scale,
                      batch_size=self.global_batch_size,
                      patch_size=self.patch_size,
                      time_window=self.time_window,
                      static_vars=self.static_vars,
                      predictors=self.predictors_train,
                      interpolation=self.interpolation, device=self.device,
                      shard=(self.rank, self.n_data_shards))
        if self.data_in_hbm:
            self.ds_train = BatchSynthesizer(
                self.data_train, self.data_train_lr, **common)
        else:
            self.ds_train = HostStreamer(
                self.data_train, array_lr=self.data_train_lr,
                seed=self.seed, **common)

    def setup_model(self):
        """Build G and D (dl4ds_tpu/training/cgan.py:230-274) on the
        device, in train mode; a batch norm in either raises, as in the JAX
        trainer."""
        n_channels, n_aux_channels = self.channel_counts(
            self.predictors_train, self.static_vars)
        (hr_h, hr_w), (lr_h, lr_w) = self.grid_sizes()
        self.generator = build_model(
            backbone=self.backbone, upsampling=self.upsampling,
            scale=self.scale, n_channels=n_channels,
            n_aux_channels=n_aux_channels, lr_size=(lr_h, lr_w),
            hr_size=(hr_h, hr_w), time_window=self.time_window,
            **self.generator_params)
        self.discriminator = residual_discriminator(
            n_channels=n_channels, scale=self.scale,
            upsampling=self.upsampling,
            is_spatiotemporal=self.model_is_spatiotemporal,
            lr_size=(lr_h, lr_w), time_window=self.time_window,
            **self.discriminator_params)
        self.gen_net = self.generator.init(self.seed, device=self.device)
        if self.init_weights is not None:
            # the generator from a reference checkpoint; the discriminator
            # starts fresh (dl4ds_tpu/training/cgan.py:252-261)
            import_keras_weights(self.generator, self.gen_net,
                                 self.init_weights)
            if self.verbose:
                src = (self.init_weights
                       if isinstance(self.init_weights, str)
                       else type(self.init_weights).__name__)
                print(f'Initialized generator from reference checkpoint: '
                      f'{src}')
        self.disc_net = self.discriminator.init(self.seed + 1,
                                                device=self.device)
        if any(isinstance(m, BatchNorm) for net in (self.gen_net,
                                                    self.disc_net)
               for m in net.modules()):
            raise NotImplementedError(
                "normalization='bn' is not supported in the CGAN trainer "
                '(the fused G+D step does not thread batch statistics '
                'through the three discriminator passes); use '
                "normalization='ln' or None — the supervised trainer "
                'supports bn')
        # both networks, for the step runner's train mode and state
        self.train_net = torch.nn.ModuleDict({'generator': self.gen_net,
                                              'discriminator': self.disc_net})
        if self.verbose == 1 and self.running_on_first_worker:
            print(self.generator.summary(self.gen_net))
            print(self.discriminator.summary(self.disc_net))

    def _steps(self):
        n = self.ds_train.n
        return (self.steps_per_epoch if self.steps_per_epoch is not None
                else int(n / self.global_batch_size))

    def _schedule(self, lr0, total):
        """A rate of the optimizers (dl4ds_tpu/training/cgan.py:352-368):
        constant (a float), or a schedule of the update count peaked at
        lr0 and decayed to 0 over `total` updates."""
        if callable(self.lr_schedule):
            return self.lr_schedule
        if self.lr_schedule is None:
            return float(lr0)
        total = max(total, 1)
        if self.lr_schedule == 'cosine':
            return cosine_decay_schedule(float(lr0), total, 0.0)
        warmup = self.warmup_steps or max(total // 20, 1)
        return warmup_cosine_decay_schedule(0.0, float(lr0), warmup, total,
                                            0.0)

    def setup_optimizer(self, steps):
        """The two Adams over G's and D's parameters at their device rates,
        the update count and the accumulation's mini-step, the gradient
        accumulators, the EMA generator (sharing the generator's buffers;
        it starts at its initial parameters) and the dropout generator on
        the device, seeded from (`seed`, rank) (`seed` itself without a
        mesh and on rank 0), which both networks draw from. The rates are
        the given ones under a mesh too, as in the JAX trainer."""
        dev = self.device
        lrs = self.learning_rates
        if isinstance(lrs, (tuple, list)) and len(lrs) > 1:
            genlr, dislr = lrs[0], lrs[1]
        else:
            genlr = dislr = lrs[0] if isinstance(lrs, (tuple, list)) else lrs
        total = steps * self.epochs
        # kept for introspection, as in the JAX trainer
        self._gen_lr = self._schedule(genlr, total)
        self._disc_lr = self._schedule(dislr, total)
        self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._rates = []
        for rate in (self._gen_lr, self._disc_lr):
            lr = torch.full((), rate if isinstance(rate, float) else 0.0,
                            dtype=torch.float32, device=dev)
            self._rates.append((rate, lr))
        self._set_rate()
        self._g_params = list(self.gen_net.parameters())
        self._d_params = list(self.disc_net.parameters())
        self._params = self._g_params + self._d_params
        self.g_optimizer = _adam(self._g_params, self._rates[0][1], dev)
        self.d_optimizer = _adam(self._d_params, self._rates[1][1], dev)
        self.dropout_generator = torch.Generator(device=dev).manual_seed(
            _rank_seed(self.seed, self.rank))
        set_dropout_generator(self.train_net, self.dropout_generator)
        self.ema_net = None
        if self.ema_decay > 0:
            self.ema_net = copy.deepcopy(self.gen_net)
            live = dict(self.gen_net.named_modules())
            for name, m in self.ema_net.named_modules():
                for key in m._buffers:
                    m._buffers[key] = live[name]._buffers[key]
        self._ema = (list(self.ema_net.parameters())
                     if self.ema_net is not None else None)
        self._acc = ([torch.zeros_like(p) for p in self._params]
                     if self.gradient_accumulation_steps > 1 else None)
        self._mini = torch.zeros((), dtype=torch.float32, device=dev)
        self._row = torch.zeros(1, dtype=torch.long, device=dev)
        self.n_updates = 0
        self.mini_step = 0

    @torch.no_grad()
    def _set_rate(self):
        """Each optimizer's rate of the next update, from its schedule at
        the device update count (device work only)."""
        for rate, lr in self._rates:
            if isinstance(rate, float):
                continue
            value = rate(self._count)
            if torch.is_tensor(value):
                lr.copy_(value)
            else:
                lr.fill_(float(value))

    def _opt_tensors(self):
        return [t for opt, params in ((self.g_optimizer, self._g_params),
                                      (self.d_optimizer, self._d_params))
                for p in params for t in opt.state[p].values()]

    def _state_tensors(self):
        """Every tensor a training step changes in place."""
        return (self._params + self._opt_tensors() + (self._ema or [])
                + (self._acc or []) + list(self.train_net.buffers())
                + [lr for _, lr in self._rates]
                + [self._count, self._mini, self._row])

    # ------------------------------------------------------------------
    def _step(self, batch, commit=True):
        """The body of one training step on `batch`: both passes and
        gradients (`gan_gradients`), then with gradient accumulation the
        running mean of the microbatch gradients of both networks
        (optax.MultiSteps), and on the commit both updates at their
        scheduled rates and the generator's EMA (dl4ds_tpu/training/
        cgan.py:68-118, base.py:29-45). Under a mesh the passes run within
        `distributed.batch_group` and the commit averages both networks'
        gradients over the ranks first. Device work only; returns this
        rank's four losses as one float32 device tensor."""
        self.g_optimizer.zero_grad(set_to_none=True)
        self.d_optimizer.zero_grad(set_to_none=True)
        with distributed.batch_group(self.data_group):
            losses = torch.stack([v.detach().float() for v in gan_gradients(
                self.gen_net, self.disc_net, batch, self.lossf)])
        with torch.no_grad():
            if self._acc is not None:
                grads = [p.grad for p in self._params]
                torch._foreach_sub_(grads, self._acc)
                torch._foreach_div_(grads, self._mini + 1)
                torch._foreach_add_(grads, self._acc)
                if not commit:
                    torch._foreach_copy_(self._acc, grads)
                    self._mini.add_(1)
                    return losses
                torch._foreach_zero_(self._acc)
                self._mini.zero_()
            if self.data_group is not None:
                distributed.average_gradients(self._params, self.data_group)
            self._set_rate()
            self.g_optimizer.step()
            self.d_optimizer.step()
            self._count.add_(1)
            if self._ema is not None:
                torch._foreach_mul_(self._ema, self.ema_decay)
                torch._foreach_add_(self._ema, self._g_params,
                                    alpha=1 - self.ema_decay)
        return losses

    def _advance(self, commit):
        self.mini_step = 0 if commit else self.mini_step + 1
        self.n_updates += int(commit)

    def _commits(self):
        return self.mini_step == self.gradient_accumulation_steps - 1

    def train_step(self, batch):
        """One fused G+D step on `batch` (a synthesizer's dict), run
        eagerly, with the update on the optimizers' commit. Returns the
        four losses (g_total, g_gan, g_px, d_loss) as a device tensor."""
        commit = self._commits()
        losses = self._step(batch, commit)
        self._advance(commit)
        return losses

    def _plan_step(self, plan, losses, commit):
        """A step on plan row `_row`, its losses written to
        `losses[_row]`, then the next row: the function that is captured
        on the card."""
        step = self._step(self.ds_train.step_batch(plan, self._row), commit)
        losses.index_copy_(0, self._row, step.view(1, -1))
        self._row.add_(1)

    def eval_net(self):
        """The generator to serve and test: the EMA one with
        `ema_decay`."""
        return self.ema_net if self.ema_net is not None else self.gen_net

    # ------------------------------------------------------------------
    def run(self):
        """Adversarial training, then the test loss and saving
        (dl4ds_tpu/training/cgan.py:313-521)."""
        self.timing = Timing(self.verbose)
        self.setup_datagen()
        self.setup_model()
        steps = self._steps()
        if steps < 1:
            raise ValueError(
                f'data_train yields no full global batch (n='
                f'{self.ds_train.n}, global_batch_size='
                f'{self.global_batch_size}); reduce batch_size, use fewer '
                f'devices, or set steps_per_epoch')
        self.setup_optimizer(steps)
        if self.resume_from_checkpoint is not None:
            self._restore_gan_checkpoint(self.resume_from_checkpoint)
            if self.verbose:
                print(f'Resumed G/D from {self.resume_from_checkpoint}')
        self.runner = StepRunner(self, steps, {}, loss_shape=(4,))
        generator = torch.Generator().manual_seed(int(self.seed))
        for epoch in range(self.epochs):
            if self.verbose:
                print(f'\nEpoch {epoch + 1}/{self.epochs}')
            self.train_net.train()
            self.train_losses = self._reduce_mean(
                self.runner.train(self.ds_train.plan(generator, steps))
                if self.data_in_hbm
                else self.runner.train_stream(self.ds_train, steps))
            # the last step's losses, as the reference records each epoch
            g_total, g_gan, g_px, d_loss = self.train_losses[-1].tolist()
            self.gentotal.append(g_total)
            self.gengan.append(g_gan)
            self.gen_pxloss.append(g_px)
            self.disc.append(d_loss)
            if self.terminate_on_nan and not (np.isfinite(g_total)
                                              and np.isfinite(d_loss)):
                warnings.warn(
                    f'Non-finite G/D loss at epoch {epoch + 1} '
                    f'(gen={g_total}, disc={d_loss}); terminating training',
                    RuntimeWarning)
                break
            if self.save_logs:
                self.log_scalars(epoch, gen_total_loss=g_total,
                                 gen_gan_loss=g_gan, gen_px_loss=g_px,
                                 disc_loss=d_loss)
            if self.verbose:
                print(f'  gen_total_loss: {g_total:.5f}  gen_crosentr_loss: '
                      f'{g_gan:.5f}  gen_px_loss: {g_px:.5f}  disc_loss: '
                      f'{d_loss:.5f}')
            if (self.checkpoints_frequency > 0
                    and (epoch + 1) % self.checkpoints_frequency == 0):
                self._save_gan_checkpoint(f'epoch-{epoch + 1}')
        if self.checkpoints_frequency > 0:
            self._save_gan_checkpoint('final')
        if self.save_loss_history and self.running_on_first_worker:
            os.makedirs(self.save_path, exist_ok=True)
            np.save(self.save_path + 'losses.npy',
                    np.array((self.gentotal, self.gengan, self.gen_pxloss,
                              self.disc)))
        self.timing.checktime()
        # with EMA on, the served generator is the averaged one
        self.net = self.eval_net()
        self.model = self.generator
        self.test_loss = self._test_loss()
        if self.verbose:
            print(f'\n{self.loss} on the test set: {self.test_loss}')
        self.timing.runtime()
        self.save_results(self.net, folder_prefix='cgan_')
        return self

    @torch.no_grad()
    def _test_loss(self):
        """The pixel loss of `net` on the test split in eval mode, over
        chunks of min(batch_size, n_test) samples weighted by their size
        (dl4ds_tpu/training/cgan.py:484-517), run eagerly; with
        `patch_size` the crops are drawn from a CPU generator seeded 0 (the
        JAX package draws its own). Under a mesh every rank computes it
        whole (the JAX trainer, on the first worker alone), the crops
        being one sequence of draws, so that the ranks hold one value."""
        ds_test = BatchSynthesizer(
            self.data_test, self.data_test_lr, upsampling=self.upsampling,
            scale=self.scale, batch_size=1, patch_size=self.patch_size,
            time_window=self.time_window, static_vars=self.static_vars,
            predictors=self.predictors_test,
            interpolation=self.interpolation, device=self.device)
        n_test = ds_test.n
        if n_test < 1:
            raise ValueError(
                f'data_test yields no evaluable sample (n_test={n_test}; '
                f'len(data_test)={len(self.data_test)}, '
                f'time_window={self.time_window})')
        eval_bs = min(self.batch_size, n_test)
        gen = torch.Generator().manual_seed(0)
        net = self.net.eval()
        loss_sum = 0.0
        with use_dropout_generator(net, None):
            for i in range(0, n_test, eval_bs):
                idx = torch.arange(i, min(i + eval_bs, n_test))
                batch = ds_test(idx, generator=gen)
                y = net(batch['lr'], batch['aux'])
                loss_sum += float(self.lossf(batch['hr'], y)) * len(idx)
        return loss_sum / n_test

    # ------------------------------------------------------------------
    def _save_gan_checkpoint(self, name):
        """The training state under save_path/checkpoints/`name`
        (dl4ds_tpu/training/cgan.py:524-536): both networks' weights, both
        optimizers' states (with the accumulated gradients), the step and
        the EMA generator, as the port's checkpoint file, written by the
        first worker while the others wait."""
        if not self.running_on_first_worker:
            self._barrier()
            return
        n_g = len(self._g_params)
        acc = self._acc or None
        payload = {
            'generator': _cpu(self.gen_net.state_dict()),
            'discriminator': _cpu(self.disc_net.state_dict()),
            'generator_opt': _opt_payload(
                self.g_optimizer, self._g_params, acc and acc[:n_g]),
            'discriminator_opt': _opt_payload(
                self.d_optimizer, self._d_params, acc and acc[n_g:]),
            'step': (self.n_updates * self.gradient_accumulation_steps
                     + self.mini_step),
            'n_updates': self.n_updates, 'mini_step': self.mini_step}
        if self.ema_net is not None:
            payload['generator_ema'] = _cpu(self.ema_net.state_dict())
        self._checkpoint_save(os.path.abspath(os.path.join(
            self.savecheckpoint_path, 'checkpoints', name)), payload)
        self._barrier()

    @torch.no_grad()
    def _restore_gan_checkpoint(self, path):
        """Load a checkpoint of `_save_gan_checkpoint` into the trainer's
        tensors in place (dl4ds_tpu/training/cgan.py:539-560); under a mesh
        every rank reads the first worker's."""
        payload = self._checkpoint_load(path)
        self.gen_net.load_state_dict(payload['generator'])
        self.disc_net.load_state_dict(payload['discriminator'])
        n_g = len(self._g_params)
        for opt, params, key, acc in (
                (self.g_optimizer, self._g_params, 'generator_opt',
                 self._acc and self._acc[:n_g]),
                (self.d_optimizer, self._d_params, 'discriminator_opt',
                 self._acc and self._acc[n_g:])):
            saved = payload[key]
            for p, state in zip(params, saved['adam']):
                for name, value in state.items():
                    opt.state[p][name].copy_(value)
            if acc and 'acc_grads' in saved:
                for t, value in zip(acc, saved['acc_grads']):
                    t.copy_(value)
        if self.ema_net is not None and 'generator_ema' in payload:
            self.ema_net.load_state_dict(payload['generator_ema'])
        self.n_updates = int(payload['n_updates'])
        self.mini_step = int(payload['mini_step'])
        self._count.fill_(self.n_updates)
        self._mini.fill_(self.mini_step)
        self._set_rate()


def _opt_payload(opt, params, acc):
    """An optimizer's state for a checkpoint: Adam's per parameter, and the
    accumulated gradients under gradient accumulation."""
    out = {'adam': [_cpu(opt.state[p]) for p in params]}
    if acc is not None:
        out['acc_grads'] = [t.cpu() for t in acc]
    return out


def load_checkpoint(checkpoint_dir, checkpoint_number, backbone, upsampling,
                    scale, input_height_width, n_static_vars=0,
                    n_predictors=0, time_window=None, n_blocks=(20, 4),
                    n_filters=(8, 32), attention=False, localcon_layer=False,
                    device='cuda'):
    """Rebuild G and D from their hyperparameters and load a CGAN
    checkpoint (dl4ds_tpu/training/cgan.py:563-597): `checkpoint_number`
    selects checkpoints/epoch-N, or 'final' for None or -1. The directory
    holds the port's checkpoint file or the JAX package's orbax tree (read
    with tensorstore, its `generator` and `discriminator` subtrees alone).
    Returns (generator, its network, discriminator, its network) on
    `device`, in eval mode."""
    from ..models import _as_numpy_tree, _read_orbax_tree
    from ..weights import load_jax_params
    spatiotemporal = time_window is not None and time_window > 1
    # spatial samples take the statics in the LR input and the aux branch,
    # spatio-temporal ones in the aux branch only
    n_channels = 1 + n_predictors + (0 if spatiotemporal else n_static_vars)
    h, w = input_height_width
    generator = build_model(
        backbone=backbone, upsampling=upsampling, scale=scale,
        n_channels=n_channels, n_aux_channels=n_static_vars,
        lr_size=(h, w), hr_size=(h, w),
        time_window=time_window if spatiotemporal else None,
        n_filters=n_filters[0], n_blocks=n_blocks[0], n_channels_out=1,
        attention=attention, localcon_layer=localcon_layer)
    discriminator = residual_discriminator(
        n_channels=n_channels, upsampling=upsampling,
        is_spatiotemporal=spatiotemporal, scale=scale, lr_size=(h, w),
        n_filters=n_filters[1], n_res_blocks=n_blocks[1],
        attention=attention, time_window=time_window)
    name = ('final' if checkpoint_number in (None, -1)
            else f'epoch-{checkpoint_number}')
    path = os.path.abspath(os.path.join(checkpoint_dir, 'checkpoints', name))
    device = resolve_device(device)
    gen_net = generator.init(0, device=device)
    disc_net = discriminator.init(0, device=device)
    if os.path.isfile(os.path.join(path, '_METADATA')):
        tree = _read_orbax_tree(path, keep=('generator', 'discriminator'))
        load_jax_params(gen_net, _as_numpy_tree(tree['generator']))
        load_jax_params(disc_net, _as_numpy_tree(tree['discriminator']))
    else:
        payload = Trainer._checkpoint_load(path)
        gen_net.load_state_dict(payload['generator'])
        disc_net.load_state_dict(payload['discriminator'])
    return generator, gen_net, discriminator, disc_net
