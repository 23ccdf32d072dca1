"""
Model building blocks (PyTorch, NHWC at every boundary).

Counterparts of `dl4ds_tpu/models/blocks.py` for the convnet, resnet,
densenet and ConvNeXt backbones, the three post-upsampling heads (sub-pixel,
resize and transposed convolutions), the U-Net's encoder and padded
concatenation, the localized (per-pixel) output layer, the ConvLSTM blocks
of the spatio-temporal models, and the train-mode state: batch and layer
normalization (`_Norm`), every dropout variant and `DropPath`.
Activations stay [B, H, W, C] ([B, T, H, W, C] through the ConvLSTM layers,
which run the fused kernel K2 on the GPU): a convolution views its input
as NCHW with channels-last strides (a permute, no copy), so the gate kernel
and the pixel shuffle see the JAX package's layout. Submodules carry the
names of the Flax parameter tree (`Conv_0`, `ChannelAttention2D_0`,
`_Norm_0/BatchNorm_0`, ...), so `weights.load_jax_params` maps one onto the
other by walking both; a batch norm's running statistics are buffers named
as the Flax `batch_stats` collection names them (`mean`, `var`).

Parameters are float32 whatever the model dtype, as Flax's `param_dtype`
keeps them; `dtype` (float32 or bfloat16) is the compute dtype, with the
JAX package's promotions: a `Conv` casts its input, weight and bias to it
and returns it, as a Flax `Conv(dtype=...)` does, the gate returns float32
(its float32 biases promote it, `channel_attention_reference`), and the
blocks add and activate in the promoted dtype, so a bfloat16 model's
residual stream is float32. `reset_parameters(generator)` draws the Keras
defaults the JAX package uses: glorot_uniform kernels and zero biases, and
for ConvLSTM2D an orthogonal recurrent kernel and the unit forget bias;
Flax's own defaults where the JAX package keeps them (lecun_normal for the
ConvNeXt block's `Dense` layers, ones and zeros for a norm's scale and bias,
running mean 0 and variance 1).

Dropout draws come from an explicit `torch.Generator` that the caller sets
on the modules (`use_dropout_generator`; the trainer's is seeded from its
`seed`, `predict_mc`'s from its seed and the member), never from the
global RNG, through one function, `_dropout_mask`. The semantics are the
JAX package's; the bits are not, since torch's Philox stream is not JAX's
threefry. An 'mc*' dropout in eval mode without a generator (`predict`)
draws from a generator seeded 0 afresh at each call, the counterpart of the
JAX package's fixed `PRNGKey(0)` mask: one deterministic member, other
bits than JAX's. That draw is the operator
`dl4ds_tpu_torch::fixed_member_draw`, so that an exported forward
(`export.export_forward`) keeps it.

Spatial parallelism: within `distributed.space_group(group)` each rank
holds a band of rows (dim -3) of every activation, and each layer takes its
band rule. A `Conv` reads kh // 2 rows of its neighbours' bands
(`distributed.halo_rows`) and convolves without padding along H (stride 1
only); the gate runs K1's band mode, its mean over the whole grid (the
recurrent heads' rank-5 gate sums its band and all-reduces the sums); a
batch norm takes the moments of every rank's rows (the context's `moments`
group); a dropout draws the mask of the whole height, from the generator
that the bands of a sample share, and keeps the band's rows; the localized
layer takes the band's rows of its per-pixel weights. The resize and
transposed-convolution upsamplers, the U-Net's max-pool and padded
concatenation and the ConvLSTM layers take the replicate rule: the bands
joined (`distributed.gather_rows`), the layer run on the whole height, the
band's rows kept (so K2-K4 run unchanged on the whole height, as the JAX
package's partition rules replicate H around its ConvLSTM kernels). The
other layers act on each row alone. A layer without a rule raises.

Tensor parallelism: a network sharded by `parallel.shard_network` holds,
on each rank of a 'model' group, a shard of each wide weight (cut along its
output-feature dim, recorded in the module's `_tp_dims`), and within
`distributed.model_group(group)` each layer that holds one takes its
tensor rule. A `Conv` (groups 1) is column-parallel: its input through
`distributed.copy_to_group`, the convolution by the rank's output channels,
the channels joined (`distributed.gather_channels`), then the replicated
bias. The other layers take the gather rule: each sharded weight joined at
use (`distributed.gather_param`) and the layer run unchanged, so the gate
runs K1 fused and the ConvLSTM layers K2-K4 on the whole weights, as
GSPMD replicates the operands of the JAX package's kernels. Activations
are whole after each gather, so norms, activations, the pixel shuffle and
dropout act as without the group; a batch norm raises ValueError (its
statistics are per-shard mutable state, as the JAX trainer says).
"""

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed import (all_reduce_sum, band_rows, copy_to_group,
                           current_batch_group, current_model_group,
                           current_space_group, gather_channels,
                           gather_param, gather_rows, halo_rows, space_group)
from ..interpolation import resize2d
from ..ops import depth_to_space, fused_channel_attention, fused_convlstm
from ..ops.fused_ops import fused_channel_attention_band
from ..utils import checkarg_dropout_variant, not_ported

MODEL_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ['MODEL_DTYPES', 'check_dtype', 'Conv', 'ConvTranspose', 'Dense',
           'get_activation', 'ChannelAttention2D', 'ConvBlock',
           'ResidualBlock', 'DenseBlock', 'TransitionBlock', 'ConvNextBlock',
           'DropPath', 'LocalizedConvBlock', 'SubpixelConvolutionBlock',
           'ResizeConvolutionBlock', 'DeconvolutionBlock', 'EncoderBlock',
           'PadConcat', 'pad_concat', 'ConvLSTM2D', 'RecurrentConvBlock',
           'Dropout', 'get_dropout_layer', 'MCDropout', 'MCGaussianDropout',
           'MCSpatialDropout2D', 'MCSpatialDropout3D', 'use_dropout_generator']


def _glorot_uniform_(tensor, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        tensor.uniform_(-limit, limit, generator=generator)


def _lecun_normal_(tensor, fan_in, generator):
    """Flax's default kernel initializer, `lecun_normal`: a normal of
    variance 1 / fan_in truncated at two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _rounded(value, dtype):
    """A Python scalar as JAX's weak typing takes it beside an array of
    `dtype`: rounded to that dtype first (keep = 0.8 is 0.80078125 in
    bfloat16). torch would keep it in float32 for a bfloat16 tensor."""
    return float(torch.tensor(value, dtype=dtype))


def _maybe(module, x):
    return x if module is None else module(x)


# ---------------------------------------------------------------------------
# Spatial parallelism: the band rules' shared pieces
# ---------------------------------------------------------------------------

def _replicated(fn, what, *xs):
    """The replicate rule: the bands of each of `xs` joined over the space
    group, `fn` on the whole height (its layers whole, no band rule), and
    this rank's rows of the result."""
    sp = current_space_group()
    full = [gather_rows(x, sp.group) for x in xs]
    with space_group(None):
        y = fn(*full)
    return band_rows(y, sp.group, what=f'the output of {what}')


def _tp_dim(module, name):
    """The dim along which `module`'s parameter `name` is sharded over the
    'model' group (`parallel.shard_network`), or None."""
    return module.__dict__.get('_tp_dims', {}).get(name)


def _model_of(module):
    """The model group that a layer holding shards runs within."""
    mg = current_model_group()
    if mg is None:
        raise RuntimeError(
            f'{type(module).__name__} holds shards of its weights: run it '
            f'within distributed.model_group(group)')
    return mg


def _whole(module, name):
    """`module`'s parameter `name` whole: joined over the model group at
    use where it is sharded (the gather rule), else as it is."""
    t = getattr(module, name)
    dim = _tp_dim(module, name)
    if dim is None or t is None:
        return t
    return gather_param(t, dim, _model_of(module).group)


def _no_band_rule(what):
    """Refuse a layer that has no band rule within a space group, as the
    JAX package refuses the trainer that would run it there (the CGAN
    discriminator: dl4ds_tpu/training/cgan.py:150-154)."""
    if current_space_group() is not None:
        raise NotImplementedError(
            f'{what} has no band rule: 2-D (\'model\'/\'space\') meshes are '
            f'routed through SupervisedTrainer')


# ---------------------------------------------------------------------------
# Dropout, DropPath and their random draws
# ---------------------------------------------------------------------------

_MC_VARIANTS = ('mcdrop', 'mcgaussiandrop', 'mcspatialdrop')


def _dropout_mask(shape, keep, generator, dtype, device, kind='bernoulli'):
    """The one random draw of a dropout call, from `generator`: 'bernoulli'
    a bool mask of `shape`, True with probability `keep` (JAX's
    `random.bernoulli`); 'normal' standard normal noise in `dtype` (the
    gaussian variants); 'uniform' U[0, 1) in `dtype` (`DropPath`). Tests
    feed JAX's own draws through it."""
    if kind == 'normal':
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    if kind == 'uniform':
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)
    return torch.rand(shape, generator=generator, device=device) < keep


class _Replay:
    """The dropout draws of one rematerialized block (`remat_call`): its
    first run, the forward, records each draw; its rerun, the backward's
    recomputation, returns them in order and updates no running
    statistics, as Flax's `nn.remat` reruns a block on the same rng keys
    and discards the rerun's `batch_stats`. The draws are kept beside the
    checkpoint (a bool mask, or the gaussian noise), since a replayed CUDA
    graph holds its generator's offset on the device, where no rerun could
    rewind it."""
    active = None

    def __init__(self):
        self.draws = []
        self.rerun = False
        self.pos = 0


def _draw(shape, keep, generator, dtype, device, kind):
    tape = _Replay.active
    if tape is not None and tape.rerun:
        tape.pos += 1
        return tape.draws[tape.pos - 1]
    value = _dropout_mask(shape, keep, generator, dtype, device, kind)
    if tape is not None:
        tape.draws.append(value)
    return value


@torch.library.custom_op('dl4ds_tpu_torch::fixed_member_draw',
                         mutates_args=())
def _fixed_member_draw(like: torch.Tensor, shape: Sequence[int],
                       keep: Optional[float], kind: str) -> torch.Tensor:
    """The draw of an 'mc*' dropout in eval mode without a generator:
    `_dropout_mask` from a generator seeded 0 afresh (one fixed member), on
    `like`'s device and in its dtype. An operator, so that `torch.export`
    freezes the draw as one node that draws the same member at every call,
    as the JAX package's artifact applies its `PRNGKey(0)` mask."""
    gen = torch.Generator(device=like.device).manual_seed(0)
    return _dropout_mask(tuple(shape), keep, gen, like.dtype, like.device,
                         kind)


@_fixed_member_draw.register_fake
def _(like, shape, keep, kind):
    dtype = torch.bool if kind == 'bernoulli' else like.dtype
    return like.new_empty(tuple(shape), dtype=dtype)


def _updates_running_stats():
    tape = _Replay.active
    return tape is None or not tape.rerun


def remat_call(block, x):
    """`block(x)` with its activations recomputed in the backward pass
    instead of kept (`torch.utils.checkpoint`), its dropout draws replayed
    and its running statistics updated once (`_Replay`)."""
    tape = _Replay()

    def run(x):
        outer, _Replay.active = _Replay.active, tape
        tape.pos = 0
        try:
            return block(x)
        finally:
            _Replay.active = outer
            tape.rerun = True
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class _Draws(nn.Module):
    """A module that draws from `generator`. A copy (deepcopy, pickle)
    holds no generator until it is given one: a generator is the state of
    the run that set it, not of the network."""

    def __getstate__(self):
        state = dict(self.__dict__)
        state['generator'] = None
        return state


class Dropout(_Draws):
    """Every dropout variant of the JAX package in one module
    (dl4ds_tpu/models/blocks.py:85-140). `variant` None/'vanilla' drops
    single elements, 'gaussian' multiplies by 1 + sqrt(rate / (1 - rate))
    * N(0, 1) drawn in x's dtype, 'spatial' drops whole channels (the mask
    broadcast over (H, W), or over (T, H, W) with `dim` 3 on a rank-5
    input); the 'mc*' variants are the same and stay active in eval mode.
    Kept values are x / keep, cast back to x's dtype.

    The draws come from `generator` (`use_dropout_generator`). Without one
    a train-mode call raises, as Flax's `make_rng` does, and an eval-mode
    'mc*' call draws from a generator seeded 0 afresh at each call: one
    fixed member, as the JAX package's `PRNGKey(0)` fallback gives one
    (other bits: torch's Philox stream is not JAX's threefry)."""

    def __init__(self, rate, variant=None, dim=2):
        super().__init__()
        self.rate = float(rate)
        self.variant = checkarg_dropout_variant(variant)
        self.dim = dim
        self.generator = None

    def extra_repr(self):
        return f'rate={self.rate}, variant={self.variant}, dim={self.dim}'

    def forward(self, x):
        if self.rate <= 0.0:
            return x
        if not (self.training or self.variant in _MC_VARIANTS):
            return x
        gen = self.generator
        if gen is None and self.training:
            raise ValueError('dropout in train mode draws from an explicit '
                             'generator: set one with `use_dropout_generator`')

        sp = current_space_group()

        def draw(shape, keep, kind):
            # under a space group the whole height's draw, then the band's
            # rows: the bands of a sample share one generator
            band = sp is not None and shape[-3] != 1
            if band:
                shape = shape[:-3] + (shape[-3] * sp.count,) + shape[-2:]
            if gen is None:
                mask = _fixed_member_draw(x, shape, keep, kind)
            else:
                mask = _draw(shape, keep, gen, dtype, x.device, kind)
            return band_rows(mask, sp.group) if band else mask
        dtype = x.dtype
        if self.variant in ('gaussian', 'mcgaussiandrop'):
            stddev = _rounded((self.rate / (1.0 - self.rate)) ** 0.5, dtype)
            z = draw(tuple(x.shape), None, 'normal')
            return x * (1.0 + stddev * z)
        keep = 1.0 - self.rate
        shape = list(x.shape)
        if self.variant in ('spatial', 'mcspatialdrop'):
            n_bcast = 3 if (self.dim == 3 and x.dim() >= 5) else 2
            for ax in range(x.dim() - 1 - n_bcast, x.dim() - 1):
                shape[ax] = 1
        mask = draw(tuple(shape), keep, 'bernoulli')
        return torch.where(mask, x / _rounded(keep, dtype), 0.0).to(dtype)


def _dropout(rate, variant, dim=2):
    """A `Dropout`, or None where it would be the identity (rate 0)."""
    return Dropout(rate, variant, dim) if rate and rate > 0 else None


def get_dropout_layer(dropout_rate=0.2, dropout_variant=None, dim=2):
    """Resolve a dropout variant name to a `Dropout`
    (dl4ds_tpu/models/blocks.py:143-148)."""
    return Dropout(dropout_rate, dropout_variant, dim=dim)


def MCDropout(rate, **kwargs):
    """Monte-Carlo dropout, active in eval mode."""
    return Dropout(rate, variant='mcdrop', **kwargs)


def MCGaussianDropout(rate, **kwargs):
    """Monte-Carlo multiplicative gaussian noise."""
    return Dropout(rate, variant='mcgaussiandrop', **kwargs)


def MCSpatialDropout2D(rate, **kwargs):
    """Monte-Carlo channel dropout over (H, W)."""
    return Dropout(rate, variant='mcspatialdrop', dim=2, **kwargs)


def MCSpatialDropout3D(rate, **kwargs):
    """Monte-Carlo channel dropout over (T, H, W)."""
    return Dropout(rate, variant='mcspatialdrop', dim=3, **kwargs)


class DropPath(_Draws):
    """Per-sample stochastic depth (dl4ds_tpu/models/blocks.py:397-409):
    in train mode x / keep * floor(keep + U), U ~ U[0, 1) a sample, drawn in
    x's dtype from `generator`; the identity in eval mode or at rate 0."""

    def __init__(self, drop_prob=0.0):
        super().__init__()
        self.drop_prob = float(drop_prob)
        self.generator = None

    def forward(self, x):
        if not self.training or self.drop_prob == 0.0:
            return x
        if self.generator is None:
            raise ValueError('DropPath in train mode draws from an explicit '
                             'generator: set one with `use_dropout_generator`')
        keep = _rounded(1.0 - self.drop_prob, x.dtype)
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        u = _draw(shape, None, self.generator, x.dtype, x.device, 'uniform')
        return x / keep * torch.floor(keep + u)


def set_dropout_generator(net, generator):
    """Point every `Dropout` and `DropPath` of `net` at `generator` (None:
    the fixed member of an 'mc*' dropout in eval mode). Returns the
    generators they held."""
    mods = [m for m in net.modules() if isinstance(m, (Dropout, DropPath))]
    saved = [m.generator for m in mods]
    for m in mods:
        m.generator = generator
    return saved


@contextlib.contextmanager
def use_dropout_generator(net, generator):
    """`set_dropout_generator` for the duration of a `with` block."""
    mods = [m for m in net.modules() if isinstance(m, (Dropout, DropPath))]
    saved = set_dropout_generator(net, generator)
    try:
        yield net
    finally:
        for m, gen in zip(mods, saved):
            m.generator = gen


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def _moments(x, dims, keepdim=False):
    """Flax's `_compute_stats`: the mean and E[x^2] - mean^2 (clipped at 0)
    over `dims`, in float32 at least (`force_float32_reductions`,
    `use_fast_variance`)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dims, keepdim=keepdim)
    var = (xf * xf).mean(dims, keepdim=keepdim) - mean * mean
    return mean, var.clamp_min(0.0)


def _global_moments(x, dims, group):
    """`_moments` over the global batch of a data mesh, as Flax's take
    them over a batch sharded by GSPMD: each rank's mean and E[x^2] over
    its local batch (the ranks' batches are equally large), averaged over
    the ranks by one all-reduce that the gradient flows back through, then
    E[x^2] - mean^2 clipped at 0. At one rank the bits are `_moments`'."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    local = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
    both = all_reduce_sum(local, group) / group.size()
    mean, sq = both[0], both[1]
    return mean, (sq - mean * mean).clamp_min(0.0)


class _NormBase(nn.Module):
    """Scale and bias over the channel axis, as Flax's `_normalize` applies
    them: (x - mean) * (rsqrt(var + eps) * scale) + bias in float32 at
    least, returned in the model dtype (bfloat16) or the promoted one."""

    def __init__(self, channels, eps, dtype):
        super().__init__()
        self.eps = eps
        self.dtype = check_dtype(dtype)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def _normalize(self, x, mean, var):
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        y = y + self.bias
        return y.to(self.dtype) if self.dtype == torch.bfloat16 else y


class BatchNorm(_NormBase):
    """Flax's `BatchNorm(momentum=0.99, epsilon=1e-3)` over every axis but
    the channels (dl4ds_tpu/models/blocks.py:166-181). Train mode
    normalizes with the batch's statistics and moves the running ones, the
    buffers `mean` and `var` (the `batch_stats` collection), by
    ra = 0.99 * ra + 0.01 * stat with the biased batch variance, as Flax
    does (PyTorch's BatchNorm takes the unbiased one); eval mode
    normalizes with the running statistics. Within
    `distributed.batch_group(group)` train mode takes the statistics of
    the global batch, the ranks' local batches together
    (`_global_moments`); within `distributed.space_group` those of every
    rank's rows (the context's `moments` group, whose ranks hold equal
    bands)."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__(channels, 1e-3, dtype)
        self.register_buffer('mean', torch.zeros(channels))
        self.register_buffer('var', torch.ones(channels))

    def reset_parameters(self, generator):
        super().reset_parameters(generator)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x):
        if current_model_group() is not None:
            raise ValueError(
                'tensor-parallel training supports parameter-only models '
                '(batch-norm statistics are per-shard mutable state); build '
                'the model without batch norm')
        if not self.training:
            return self._normalize(x, self.mean, self.var)
        dims = tuple(range(x.dim() - 1))
        sp = current_space_group()
        group = current_batch_group() if sp is None else sp.moments
        mean, var = (_moments(x, dims) if group is None
                     else _global_moments(x, dims, group))
        if _updates_running_stats():
            with torch.no_grad():
                self.mean.copy_(self.mean * 0.99 + mean * (1 - 0.99))
                self.var.copy_(self.var * 0.99 + var * (1 - 0.99))
        return self._normalize(x, mean, var)


class LayerNorm(_NormBase):
    """Flax's `LayerNorm` over the channel axis, eps 1e-3 (`_Norm`'s) or
    1e-6 (`ConvNextBlock`'s)."""

    def __init__(self, channels, eps=1e-3, dtype=torch.float32):
        super().__init__(channels, eps, dtype)

    def forward(self, x):
        mean, var = _moments(x, (-1,), keepdim=True)
        return self._normalize(x, mean, var)


class _Norm(nn.Module):
    """'bn' or 'ln' over the channel axis (dl4ds_tpu/models/blocks.py:
    166-181), on rank-4 and rank-5 activations, with Flax's tree:
    `BatchNorm_0` or `LayerNorm_0` (eps 1e-3)."""

    def __init__(self, kind, channels, dtype=torch.float32):
        super().__init__()
        if kind == 'bn':
            self.BatchNorm_0 = BatchNorm(channels, dtype)
        elif kind == 'ln':
            self.LayerNorm_0 = LayerNorm(channels, 1e-3, dtype)
        else:
            raise ValueError(f'Normalization not supported, got {kind}')
        self.child = 'BatchNorm_0' if kind == 'bn' else 'LayerNorm_0'

    def forward(self, x):
        return self._modules[self.child](x)


def _norm(kind, channels, dtype):
    """A `_Norm`, or None for normalization=None."""
    return None if kind is None else _Norm(kind, channels, dtype)


def check_dtype(dtype):
    """The model dtypes the port has: float32 and bfloat16 (every JAX
    benchmark's). Others raise, naming their ROADMAP item."""
    if dtype not in MODEL_DTYPES:
        raise not_ported(f'model dtype {dtype}', 5)
    return dtype


def get_activation(name):
    """Resolve an activation name to a torch function. None (or 'linear') is
    identity. 'gelu' is the tanh approximation, jax.nn.gelu's default."""
    if name is None or name == 'linear':
        return lambda x: x
    table = {
        'relu': F.relu,
        'gelu': lambda x: F.gelu(x, approximate='tanh'),
        'elu': F.elu,
        'selu': F.selu,
        'leaky_relu': F.leaky_relu,
        'crelu': F.relu,   # concat-relu is not used by any config path
        'sigmoid': torch.sigmoid,
        'tanh': torch.tanh,
    }
    if name not in table:
        raise ValueError(f'Unsupported activation: {name}')
    return table[name]


class Conv(nn.Module):
    """2-D convolution of an NHWC tensor, SAME-padded at stride 1 by
    default. The kernel is held in torch's OIHW layout; odd kernel sizes
    only (SAME padding is then symmetric at stride 1). With `strides` s > 1
    (the discriminator's downsampling convs) the output has ceil(n / s)
    rows for 'SAME', XLA's padding of (out - 1) * s + k - n rows split with
    the smaller half first, and (n - k) // s + 1 for 'VALID'. `groups` is
    Flax's `feature_group_count` (the ConvNeXt
    block's depthwise conv: a Flax kernel [kh, kw, 1, C] is [C, 1, kh, kw]
    here). In `dtype` bfloat16 the input, weight and bias are cast to
    it and the bias is added after the convolution's rounding, as Flax's
    `Conv` adds it (a bias inside cuDNN's convolution would be added
    before the rounding). cuDNN's bfloat16 convolution accumulates in
    float32; on the CPU the product is taken in float32 and rounded once,
    as XLA's CPU convolution takes it (oneDNN's bfloat16 convolution
    rounds a few outputs otherwise)."""

    def __init__(self, in_channels, filters, kernel_size=(3, 3),
                 use_bias=True, dtype=torch.float32, groups=1, strides=1,
                 padding='SAME'):
        super().__init__()
        self.dtype = check_dtype(dtype)
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        if kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError(
                f'even kernel {kh}x{kw}: SAME padding would be asymmetric')
        if padding not in ('SAME', 'VALID'):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f'{padding!r}')
        self.stride = int(strides)
        self.pad_mode = padding
        self.padding = ((kh // 2, kw // 2) if padding == 'SAME' else (0, 0))
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(filters, in_channels // groups, kh, kw))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(filters))
        else:
            self.register_parameter('bias', None)

    def reset_parameters(self, generator):
        o, i, kh, kw = self.weight.shape
        _glorot_uniform_(self.weight, i * kh * kw, o * kh * kw, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _same_pads(self, x):
        """XLA's SAME padding of a strided conv on x [B, H, W, C]: (left,
        right, top, bottom), the smaller half first."""
        pads = []
        for n, k in zip(x.shape[1:3], self.weight.shape[2:]):
            out = -(-n // self.stride)
            total = max((out - 1) * self.stride + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return pads[1] + pads[0]

    def forward(self, x):
        args = dict(padding=self.padding, groups=self.groups,
                    stride=self.stride)
        w, column = self.weight, None
        if _tp_dim(self, 'weight') is not None:
            if self.groups == 1:
                # column-parallel: this rank's output channels, then joined
                column = _model_of(self).group
                x = copy_to_group(x, column)
            else:
                w = _whole(self, 'weight')
        sp = current_space_group()
        if sp is not None:
            # the band rule: kh // 2 rows of the neighbouring bands, then no
            # padding along H
            if self.stride != 1 or self.pad_mode != 'SAME':
                raise ValueError(f'a conv of stride {self.stride}, padding '
                                 f'{self.pad_mode!r} has no band rule (SAME '
                                 f'at stride 1 only)')
            rows = self.padding[0]
            if rows:
                above, below = halo_rows(x, rows, sp.group)
                x = torch.cat([above, x, below], dim=-3)
            args['padding'] = (0, self.padding[1])
        xt = x.permute(0, 3, 1, 2)
        if self.stride > 1 and self.pad_mode == 'SAME':
            xt = F.pad(xt, self._same_pads(x))
            args['padding'] = 0
        if self.dtype == torch.float32:   # (also float64 reference runs)
            y = F.conv2d(xt, w, None if column is not None else self.bias,
                         **args).permute(0, 2, 3, 1).contiguous()
            if column is None:
                return y
            y = gather_channels(y, column)
            return y if self.bias is None else y + self.bias
        xt, w = xt.to(self.dtype), w.to(self.dtype)
        if x.is_cuda:
            y = F.conv2d(xt, w, **args)
        else:   # rounded once from float32, as XLA's CPU convolution
            y = F.conv2d(xt.float(), w.float(), **args).to(self.dtype)
        y = y.permute(0, 2, 3, 1).contiguous()
        if column is not None:
            y = gather_channels(y, column)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class _SeparableConv(nn.Module):
    """Depthwise-separable conv (dl4ds_tpu/models/blocks.py:256-272): a
    depthwise `Conv_0` without bias, then a 1x1 `Conv_1`."""

    def __init__(self, in_channels, filters, kernel_size=(3, 3),
                 use_bias=True, dtype=torch.float32):
        super().__init__()
        self.Conv_0 = Conv(in_channels, in_channels, kernel_size,
                           use_bias=False, dtype=dtype, groups=in_channels)
        self.Conv_1 = Conv(in_channels, filters, (1, 1), use_bias=use_bias,
                           dtype=dtype)

    def forward(self, x):
        return self.Conv_1(self.Conv_0(x))


class Dense(nn.Module):
    """Flax's `nn.Dense` over the last axis: the kernel held in the Flax
    layout [in, out] under the leaf name `kernel`, a `bias`, Flax's
    lecun_normal init. In bfloat16 it is cast as `Conv` casts: the input
    and kernel in bfloat16 (cuBLAS accumulates in float32 on the card; on
    the CPU the product is taken in float32 and rounded once), the bias
    added after the rounding."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter('bias', None)

    def reset_parameters(self, generator):
        _lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        k, bias = _whole(self, 'kernel'), _whole(self, 'bias')
        if self.dtype == torch.float32:   # (also float64 reference runs)
            y = x @ k
            return y if bias is None else y + bias
        x, k = x.to(self.dtype), k.to(self.dtype)
        y = x @ k if x.is_cuda else (x.float() @ k.float()).to(self.dtype)
        return y if bias is None else y + bias.to(self.dtype)


def _transpose_pad_before(k, s):
    """The padding before the stride-dilated input that `lax.conv_transpose`
    takes for padding='SAME' (jax._src.lax.convolution.
    _conv_transpose_padding; k + s - 2 in all)."""
    return k - 1 if s > k - 1 else int(np.ceil((k + s - 2) / 2))


class ConvTranspose(nn.Module):
    """Flax's `ConvTranspose` (transpose_kernel=False, padding='SAME', no
    bias) of an NHWC tensor: the input dilated by the stride, padded
    (`_transpose_pad_before` before it) and correlated with the unflipped
    kernel, so an [H, W] grid becomes [H*s, W*s]. The kernel is held in the
    Flax layout, HWIO [kh, kw, Cin, Co], under the leaf name `kernel`.

    It runs as `F.conv_transpose2d` with the kernel flipped: output o sums
    x[i] * K[s*i + pad_a - o], which is torch's x[i] * W[o + p - s*i] with
    W the flipped kernel and p = k - 1 - pad_a; torch's output then starts
    at the same o and is cropped to H*s (or extended by `output_padding`
    where it falls short). In bfloat16 the input and kernel are cast to it;
    on the CPU the product is taken in float32 and rounded once, as the
    port's `Conv`."""

    def __init__(self, in_channels, filters, kernel_size=(9, 9), strides=2,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        self.stride = int(strides)
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_channels, filters))
        # (padding, output_padding) of conv_transpose2d per spatial axis;
        # its output is 2 pad_a - k + 2 - s longer than H*s, and cropped
        self.geometry = []
        for k in (kh, kw):
            pad_a = _transpose_pad_before(k, self.stride)
            extra = 2 * pad_a - k + 2 - self.stride
            self.geometry.append((k - 1 - pad_a, max(-extra, 0)))

    def reset_parameters(self, generator):
        kh, kw, cin, co = self.kernel.shape
        _glorot_uniform_(self.kernel, kh * kw * cin, kh * kw * co, generator)

    def forward(self, x):
        if current_space_group() is not None:
            return _replicated(self.forward, 'a transposed conv', x)
        h, w = x.shape[1:3]
        s = self.stride
        k = _whole(self, 'kernel')
        if self.dtype == torch.bfloat16:
            x, k = x.to(self.dtype), k.to(self.dtype)
        weight = torch.flip(k, (0, 1)).permute(2, 3, 0, 1)
        (ph, oph), (pw, opw) = self.geometry
        args = dict(stride=s, padding=(ph, pw), output_padding=(oph, opw))
        xt = x.permute(0, 3, 1, 2)
        if self.dtype == torch.bfloat16 and not x.is_cuda:
            y = F.conv_transpose2d(xt.float(), weight.float(),
                                   **args).to(self.dtype)
        else:
            y = F.conv_transpose2d(xt, weight, **args)
        return y[:, :, :h * s, :w * s].permute(0, 2, 3, 1).contiguous()


class ChannelAttention2D(nn.Module):
    """Squeeze-and-excite channel attention
    (dl4ds_tpu/models/blocks.py:184-244): global average pool -> C/r -> relu
    -> nf -> sigmoid gate, run by the fused gate (the Hopper kernel on the
    GPU). Weights keep the JAX layout: w1 [C, Cr], b1 [Cr], w2 [Cr, nf],
    b2 [nf], with Cr = max(int(nf / r), 1).

    With `time_window` t > 1 (the recurrent output heads) x is [B*t, H, W, C]
    flattened from [B, t, ...], and the gate keeps the reference's rank-5
    quirk (dl4ds_tpu/models/blocks.py:223-235): the mean is over (T, H), the
    gate varies along (W, C) and is shared over (T, H). That gate is plain
    tensor math, not the K1 kernel.

    On a bfloat16 x the gate returns float32, as
    `channel_attention_reference` does in a bfloat16 model: the mean, w1,
    w2 and m @ w1 are rounded to bfloat16, the float32 biases promote the
    rest (K1's float32-output mode on the GPU). Within
    `distributed.space_group` x is a band of rows and the mean runs over
    the whole grid: K1's band mode, or for the rank-5 gate the band's sums
    all-reduced."""

    def __init__(self, in_channels, nf, r=4, time_window=None):
        super().__init__()
        cr = max(int(nf / r), 1)
        self.time_window = time_window
        self.w1 = nn.Parameter(torch.empty(in_channels, cr))
        self.b1 = nn.Parameter(torch.zeros(cr))
        self.w2 = nn.Parameter(torch.empty(cr, nf))
        self.b2 = nn.Parameter(torch.zeros(nf))

    def reset_parameters(self, generator):
        # Keras parity: the reference builds these as 1x1 convs with the
        # default glorot_uniform initializer
        _glorot_uniform_(self.w1, *self.w1.shape, generator)
        _glorot_uniform_(self.w2, *self.w2.shape, generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def forward(self, x):
        t = self.time_window
        sp = current_space_group()
        w1, b1, w2, b2 = (_whole(self, n) for n in ('w1', 'b1', 'w2', 'b2'))
        if t is not None and t > 1:
            bt, h, w, c = x.shape
            xr = x.reshape(bt // t, t, h, w, c)
            if sp is None:
                m = xr.mean(dim=(1, 2))                            # [B, W, C]
            else:   # the band's sums over (T, h), summed over the bands
                acc = torch.promote_types(x.dtype, torch.float32)
                total = all_reduce_sum(xr.to(acc).sum(dim=(1, 2)), sp.group)
                m = (total / (t * h * sp.count)).to(x.dtype)
            hdn = F.relu(m @ w1.to(m.dtype) + b1)
            g = torch.sigmoid(hdn @ w2.to(m.dtype).to(hdn.dtype) + b2)
            return (xr * g[:, None, None]).reshape(bt, h, w, c)
        out_dtype = torch.float32 if x.dtype == torch.bfloat16 else None
        if sp is not None:
            return fused_channel_attention_band(x, w1, b1, w2, b2, sp.group,
                                                out_dtype)
        return fused_channel_attention(x, w1, b1, w2, b2,
                                       out_dtype=out_dtype)


class ConvBlock(nn.Module):
    """Two-conv block (dl4ds_tpu/models/blocks.py:275-312): [dropout] ->
    conv -> [norm] -> act -> [dropout] -> conv -> [norm] -> act ->
    [channel attention]; the convs have no bias under a normalization, and
    are depthwise-separable (`_SeparableConv_0`, `_SeparableConv_1`) with
    `depthwise_separable`. `attention_time` is the recurrent heads' time
    window, for the gate's rank-5 quirk."""

    def __init__(self, in_channels, filters, ks_cl1=(3, 3), ks_cl2=(3, 3),
                 activation='relu', normalization=None, attention=False,
                 attention_time=None, dropout_rate=0.0, dropout_variant=None,
                 depthwise_separable=False, dtype=torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        use_bias = normalization is None
        conv, kind = ((_SeparableConv, '_SeparableConv')
                      if depthwise_separable else (Conv, 'Conv'))
        self.convs = (f'{kind}_0', f'{kind}_1')
        self.add_module(self.convs[0], conv(in_channels, filters, ks_cl1,
                                            use_bias=use_bias, dtype=dtype))
        self.add_module(self.convs[1], conv(filters, filters, ks_cl2,
                                            use_bias=use_bias, dtype=dtype))
        self._Norm_0 = _norm(normalization, filters, dtype)
        self._Norm_1 = _norm(normalization, filters, dtype)
        self.Dropout_0 = _dropout(dropout_rate, dropout_variant)
        self.Dropout_1 = _dropout(dropout_rate, dropout_variant)
        self.ChannelAttention2D_0 = (
            ChannelAttention2D(filters, filters, time_window=attention_time)
            if attention else None)

    def forward(self, x):
        y = self._modules[self.convs[0]](_maybe(self.Dropout_0, x))
        y = self.act(_maybe(self._Norm_0, y))
        y = self._modules[self.convs[1]](_maybe(self.Dropout_1, y))
        y = self.act(_maybe(self._Norm_1, y))
        return _maybe(self.ChannelAttention2D_0, y)


class ResidualBlock(nn.Module):
    """Residual block (dl4ds_tpu/models/blocks.py:315-346): [dropout] ->
    conv -> [norm] -> act -> [dropout] -> conv -> [norm] -> [attention] ->
    add the input ([1x1 conv] first) -> act. The gate comes before the
    residual add; the two convs have no bias under a normalization."""

    def __init__(self, in_channels, filters, activation='relu',
                 normalization=None, attention=False, dropout_rate=0.0,
                 dropout_variant=None, use_1x1conv=False,
                 dtype=torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        use_bias = normalization is None
        self.Conv_0 = Conv(in_channels, filters, (3, 3), use_bias, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias, dtype)
        self._Norm_0 = _norm(normalization, filters, dtype)
        self._Norm_1 = _norm(normalization, filters, dtype)
        self.Dropout_0 = _dropout(dropout_rate, dropout_variant)
        self.Dropout_1 = _dropout(dropout_rate, dropout_variant)
        self.ChannelAttention2D_0 = (ChannelAttention2D(filters, filters)
                                     if attention else None)
        self.Conv_2 = (Conv(in_channels, filters, (1, 1), dtype=dtype)
                       if use_1x1conv else None)

    def forward(self, x):
        y = self.Conv_0(_maybe(self.Dropout_0, x))
        y = self.act(_maybe(self._Norm_0, y))
        y = self.Conv_1(_maybe(self.Dropout_1, y))
        y = _maybe(self.ChannelAttention2D_0, _maybe(self._Norm_1, y))
        return self.act(y + _maybe(self.Conv_2, x))


class DenseBlock(nn.Module):
    """DenseNet-style block (dl4ds_tpu/models/blocks.py:349-375): a 1x1
    conv to 4 * filters -> [norm] -> act -> [dropout] -> a 3x3 conv to
    filters -> [attention], concatenated before the input: in_channels +
    filters channels out. Its convs keep their bias under a normalization,
    as the JAX block's do."""

    def __init__(self, in_channels, filters, activation='relu',
                 normalization=None, attention=False, dropout_rate=0.0,
                 dropout_variant=None, dtype=torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self.Conv_0 = Conv(in_channels, 4 * filters, (1, 1), dtype=dtype)
        self._Norm_0 = _norm(normalization, 4 * filters, dtype)
        self.Dropout_0 = _dropout(dropout_rate, dropout_variant)
        self.Conv_1 = Conv(4 * filters, filters, (3, 3), dtype=dtype)
        self.ChannelAttention2D_0 = (ChannelAttention2D(filters, filters)
                                     if attention else None)

    def forward(self, x):
        y = self.act(_maybe(self._Norm_0, self.Conv_0(x)))
        y = self.Conv_1(_maybe(self.Dropout_0, y))
        y = _maybe(self.ChannelAttention2D_0, y)
        # torch.cat promotes a float32 gate output against a bfloat16 input,
        # as jnp.concatenate does
        return torch.cat([y, x], dim=-1)


class TransitionBlock(nn.Module):
    """1x1-conv channel controller (dl4ds_tpu/models/blocks.py:378-394):
    with 'bn' bn -> act -> conv, otherwise conv -> act."""

    def __init__(self, in_channels, filters, activation='relu',
                 normalization=None, dtype=torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self._Norm_0 = (_Norm('bn', in_channels, dtype)
                        if normalization == 'bn' else None)
        self.Conv_0 = Conv(in_channels, filters, (1, 1), dtype=dtype)

    def forward(self, x):
        if self._Norm_0 is not None:
            return self.Conv_0(self.act(self._Norm_0(x)))
        return self.act(self.Conv_0(x))


class ConvNextBlock(nn.Module):
    """ConvNeXt block (dl4ds_tpu/models/blocks.py:412-449): a 7x7 depthwise
    conv -> LayerNorm (eps 1e-6; `_Norm_0` bn with normalization 'bn') ->
    `Dense` to 4 * filters -> act -> `Dense` to filters -> [layer-scale
    `gamma`, with `layer_scale_init_value` > 0] -> `DropPath`, added to the
    input ([1x1 conv] first with `use_1x1conv`)."""

    def __init__(self, in_channels, filters, drop_path=0.0,
                 layer_scale_init_value=0.0, use_1x1conv=False,
                 activation='gelu', normalization='ln', dtype=torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self.layer_scale_init_value = layer_scale_init_value
        self.Conv_0 = Conv(in_channels, in_channels, (7, 7), dtype=dtype,
                           groups=in_channels)
        if (normalization or 'ln') == 'bn':
            self._Norm_0 = _Norm('bn', in_channels, dtype)
        else:
            self.LayerNorm_0 = LayerNorm(in_channels, 1e-6, dtype)
        self.norm = '_Norm_0' if normalization == 'bn' else 'LayerNorm_0'
        self.Dense_0 = Dense(in_channels, 4 * filters, dtype=dtype)
        self.Dense_1 = Dense(4 * filters, filters, dtype=dtype)
        if layer_scale_init_value > 0:
            self.gamma = nn.Parameter(
                torch.full((filters,), float(layer_scale_init_value)))
        else:
            self.register_parameter('gamma', None)
        self.Conv_1 = (Conv(in_channels, filters, (1, 1), dtype=dtype)
                       if use_1x1conv else None)
        self.DropPath_0 = DropPath(drop_path)

    def reset_parameters(self, generator):
        if self.gamma is not None:
            with torch.no_grad():
                self.gamma.fill_(self.layer_scale_init_value)

    def forward(self, x):
        y = self._modules[self.norm](self.Conv_0(x))
        y = self.Dense_1(self.act(self.Dense_0(y)))
        if self.gamma is not None:
            y = self.gamma.to(y.dtype) * y
        return _maybe(self.Conv_1, x) + self.DropPath_0(y)


class LocalizedConvBlock(nn.Module):
    """Location-specific weights (dl4ds_tpu/models/blocks.py:452-481): a
    `TransitionBlock` to `filters` channels, then a per-pixel 1x1 layer,
    out[..., h, w, f] = sum_c y[..., h, w, c] local_kernel[h, w, c, f] +
    local_bias[h, w, f], with [H, W, filters, filters] weights, glorot per
    position. The weights fix the grid `grid` (H, W), as in the JAX
    package: training and serving use the same HR grid. The JAX package
    contracts at `precision=HIGHEST` outside any kernel; here the
    products and their sum over the `filters` input channels are float32
    element-wise arithmetic, TF32 nowhere (in bfloat16: y and the kernel
    rounded to bfloat16, the float32 sum rounded once, the bias added
    after)."""

    def __init__(self, in_channels, grid, filters=2, activation=None,
                 use_bias=True, dtype=torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        self.grid = tuple(grid)
        self.act = get_activation(activation)
        self.TransitionBlock_0 = TransitionBlock(in_channels, filters,
                                                 dtype=dtype)
        h, w = self.grid
        self.local_kernel = nn.Parameter(torch.empty(h, w, filters, filters))
        if use_bias:
            self.local_bias = nn.Parameter(torch.zeros(h, w, filters))
        else:
            self.register_parameter('local_bias', None)

    def reset_parameters(self, generator):
        *_, cin, f = self.local_kernel.shape
        _glorot_uniform_(self.local_kernel, cin, f, generator)
        if self.local_bias is not None:
            with torch.no_grad():
                self.local_bias.zero_()

    def forward(self, x):
        y = self.TransitionBlock_0(x)
        k, bias = _whole(self, 'local_kernel'), _whole(self, 'local_bias')
        grid = self.grid
        sp = current_space_group()
        if sp is not None:   # the band's rows of the per-pixel weights
            k = band_rows(k, sp.group, 0, 'the localized layer\'s grid')
            if bias is not None:
                bias = band_rows(bias, sp.group, 0)
            grid = (k.shape[0], grid[1])
        if tuple(y.shape[-3:-1]) != grid:
            raise ValueError(f'the localized layer was built for the grid '
                             f'{self.grid}, got {tuple(y.shape[-3:-1])}'
                             + (f' (a band of {grid[0]} rows expected)'
                                if sp is not None else ''))
        if self.dtype == torch.bfloat16:
            k = k.to(self.dtype).float()
            out = (y.to(self.dtype).float().unsqueeze(-1) * k).sum(-2)
            out = out.to(self.dtype)
        else:
            out = (y.unsqueeze(-1) * k.to(y.dtype)).sum(-2)
        if bias is not None:
            out = out + bias.to(out.dtype)
        return self.act(out)


class SubpixelConvolutionBlock(nn.Module):
    """Sub-pixel convolution upsampler (dl4ds_tpu/models/blocks.py:681-722):
    conv to n_filters * r^2 then pixel shuffle; composite factors 2*2=4,
    2*2*2=8, 2*5=10, 2*2*5=20, direct otherwise. As in the reference, every
    x2 stage reuses ONE conv (`conv2x`, tied weights)."""

    _STAGES = {2: (2,), 4: (2, 2), 8: (2, 2, 2), 10: (2, 5), 20: (2, 2, 5)}

    def __init__(self, scale, n_filters, in_channels=None,
                 dtype=torch.float32):
        super().__init__()
        # (factor, conv name) per stage; a name seen twice is one module.
        # `in_channels` (the U-Net decoder's) feeds the first stage alone:
        # a tied stage after it takes n_filters, as in Flax, where a second
        # input width would not fit the tied kernel
        self.stages = [(f, {2: 'conv2x', 5: 'conv5x'}.get(f, 'convNx'))
                       for f in self._STAGES.get(scale, (scale,))]
        c_in = n_filters if in_channels is None else in_channels
        for f, name in self.stages:
            if name in self._modules:
                if c_in != self._modules[name].weight.shape[1]:
                    raise ValueError(f'tied {name} takes '
                                     f'{self._modules[name].weight.shape[1]}'
                                     f' channels, not {c_in}')
                continue
            self.add_module(name, Conv(c_in, n_filters * f * f, dtype=dtype))
            c_in = n_filters

    def forward(self, x):
        for f, name in self.stages:
            x = depth_to_space(self._modules[name](x), f)
        return x


# keras.Resizing vocabulary -> resize2d modes, copied from
# dl4ds_tpu/models/blocks.py:725-732. 'gaussian' and 'mitchellcubic' are
# the JAX package's documented approximations (the nearest smooth kernels
# the matmul resize implements)
_RC_INTERP = {'bilinear': 'bilinear', 'nearest': 'nearest',
              'bicubic': 'bicubic', 'area': 'inter_area',
              'inter_area': 'inter_area', 'lanczos3': 'lanczos',
              'lanczos5': 'lanczos', 'lanczos': 'lanczos',
              'gaussian': 'bilinear', 'mitchellcubic': 'bicubic'}


class ResizeConvolutionBlock(nn.Module):
    """Interpolation upsampling, then a 3x3 conv to n_filters
    (dl4ds_tpu/models/blocks.py:735-753): the matmul `resize2d` in the
    input's dtype (a bfloat16 input is resized with bfloat16 matrices, each
    of the two contractions rounded, as the JAX resize2d takes them)."""

    def __init__(self, scale, n_filters, in_channels=None,
                 interpolation='bilinear', dtype=torch.float32):
        super().__init__()
        if interpolation not in _RC_INTERP:
            raise ValueError(
                f'unknown rc interpolation {interpolation!r}; one of '
                f'{sorted(_RC_INTERP)}')
        self.scale = scale
        self.mode = _RC_INTERP[interpolation]
        self.Conv_0 = Conv(n_filters if in_channels is None else in_channels,
                           n_filters, (3, 3), dtype=dtype)

    def forward(self, x):
        if current_space_group() is not None:
            return _replicated(self.forward, 'a resize convolution', x)
        h, w = x.shape[-3], x.shape[-2]
        y = resize2d(x, (int(h * self.scale), int(w * self.scale)),
                     self.mode)
        return self.Conv_0(y.to(x.dtype))


class DeconvolutionBlock(nn.Module):
    """Transposed-convolution upsampler (dl4ds_tpu/models/blocks.py:
    756-789), 9x9 kernels without bias: scale 4 is two stride-2 stages,
    `deconv_1of2` (no activation) and `deconv_2of2`; scale 8 is
    `deconv_1of3` and then ONE `deconv_2of3` applied twice (tied weights);
    any other scale one `deconv_x{scale}`. `output_activation` follows
    every stage but the first of a chain."""

    def __init__(self, scale, n_filters, output_activation=None,
                 in_channels=None, dtype=torch.float32):
        super().__init__()
        self.act = get_activation(output_activation)
        # (module, stride, activate) per stage; a name seen twice is one
        # module
        if scale == 4:
            plan = [('deconv_1of2', 2, False), ('deconv_2of2', 2, True)]
        elif scale == 8:
            plan = [('deconv_1of3', 2, False), ('deconv_2of3', 2, True),
                    ('deconv_2of3', 2, True)]
        else:
            plan = [(f'deconv_x{scale}', scale, True)]
        c_in = n_filters if in_channels is None else in_channels
        for name, s, _ in plan:
            if name not in self._modules:
                self.add_module(name, ConvTranspose(c_in, n_filters, (9, 9),
                                                    s, dtype=dtype))
                c_in = n_filters
        self.stages = [(name, activate) for name, _, activate in plan]

    def forward(self, x):
        for name, activate in self.stages:
            x = self._modules[name](x)
            if activate:
                x = self.act(x)
        return x


def _max_pool_2x2(x):
    """2x2 max-pool with stride 2 and VALID padding of an NHWC tensor (odd
    sizes floor), as `nn.max_pool(y, (2, 2), strides=(2, 2))`."""
    if current_space_group() is not None:
        return _replicated(_max_pool_2x2, 'a 2x2 max-pool', x)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


class EncoderBlock(nn.Module):
    """U-Net encoder step (dl4ds_tpu/models/blocks.py:792-811): a ConvBlock,
    then a 2x2 max-pool; returns (downsampled, skip)."""

    def __init__(self, in_channels, n_filters, activation=None,
                 dropout_rate=0.0, dropout_variant=None, normalization=None,
                 attention=False, dtype=torch.float32):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(
            in_channels, n_filters, activation=activation,
            normalization=normalization, attention=attention,
            dropout_rate=dropout_rate, dropout_variant=dropout_variant,
            dtype=dtype)

    def forward(self, x):
        y = self.ConvBlock_0(x)
        return _max_pool_2x2(y), y


def pad_concat(t1, t2):
    """Zero-pad two NHWC tensors at the bottom and right to the larger grid
    and concatenate them on channels, promoting their dtypes as
    jnp.concatenate does (dl4ds_tpu/models/blocks.py:824-840)."""
    if current_space_group() is not None:
        return _replicated(pad_concat, 'a padded concatenation', t1, t2)
    ty = max(t1.shape[-3], t2.shape[-3])
    tx = max(t1.shape[-2], t2.shape[-2])

    def pad_to(t):
        dy, dx = ty - t.shape[-3], tx - t.shape[-2]
        return F.pad(t, (0, 0, 0, dx, 0, dy)) if dy or dx else t
    return torch.cat([pad_to(t1), pad_to(t2)], dim=-1)


class PadConcat(nn.Module):
    """Module form of `pad_concat` (dl4ds_tpu/models/blocks.py:814-821)."""

    def forward(self, t1, t2):
        return pad_concat(t1, t2)


class _Kernel(nn.Module):
    """A conv kernel (and bias) held in the Flax layout, HWIO [kh, kw, Cin,
    Co], under the Flax leaf names `kernel` and `bias`."""

    def __init__(self, shape, use_bias=False):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(shape[-1]))
        else:
            self.register_parameter('bias', None)


class _Cell(nn.Module):
    """Holds the recurrent kernel at the Flax path `cell/recurrent_conv`."""

    def __init__(self, shape):
        super().__init__()
        self.recurrent_conv = _Kernel(shape)


class ConvLSTM2D(nn.Module):
    """ConvLSTM over [B, T, H, W, Cin] returning the sequence [B, T, H, W, F]
    (dl4ds_tpu/models/blocks.py:550-651), run by the fused layer K2 (the
    Hopper kernel on the GPU). Parameters sit at the Flax paths
    `input_conv/{kernel, bias}` and `cell/recurrent_conv/kernel`, HWIO, with
    the gates i, f, c, o along the last axis. Keras initialisers
    (dl4ds_tpu/models/blocks.py:508-547): glorot-uniform input kernel,
    orthogonal recurrent kernel, unit forget bias. x and the three
    parameters are cast to `dtype` before the layer, as the JAX block casts
    them (dl4ds_tpu/models/blocks.py:610-614), so a bfloat16 model runs K2
    in bfloat16 and its parameters receive bfloat16-rounded gradients."""

    def __init__(self, in_channels, filters, kernel_size=(3, 3),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        if kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError(
                f'even kernel {kh}x{kw}: SAME padding would be asymmetric')
        self.filters = filters
        self.input_conv = _Kernel((kh, kw, in_channels, 4 * filters),
                                  use_bias=True)
        self.cell = _Cell((kh, kw, filters, 4 * filters))

    def reset_parameters(self, generator):
        kh, kw, cin, f4 = self.input_conv.kernel.shape
        _glorot_uniform_(self.input_conv.kernel, kh * kw * cin, kh * kw * f4,
                         generator)
        wh = self.cell.recurrent_conv.kernel
        with torch.no_grad():
            # orthonormal columns of the [kh*kw*F, 4F] matrix, as Flax's
            # orthogonal() initialises an HWIO kernel
            q = torch.empty(wh.shape[-1], wh[..., 0].numel())
            nn.init.orthogonal_(q, generator=generator)
            wh.copy_(q.T.reshape(wh.shape))
            bias = self.input_conv.bias
            bias.zero_()
            bias[self.filters:2 * self.filters] = 1.0    # unit forget bias

    def forward(self, x):
        if current_space_group() is not None:
            return _replicated(self.forward, 'a ConvLSTM layer', x)
        wx = _whole(self.input_conv, 'kernel')
        bx = _whole(self.input_conv, 'bias')
        wh = _whole(self.cell.recurrent_conv, 'kernel')
        if self.dtype == torch.bfloat16:
            x, wx, bx, wh = (u.to(self.dtype) for u in (x, wx, bx, wh))
        return fused_convlstm(x, wx, bx, wh)


class RecurrentConvBlock(nn.Module):
    """Two stacked ConvLSTM layers (dl4ds_tpu/models/blocks.py:654-678) on
    [B, T, H, W, C]: [dropout] -> a ks_cl1 ConvLSTM -> [norm] -> act ->
    [dropout] -> a ks_cl2 ConvLSTM -> [norm] -> act, the dropouts with
    `dim` 3 (a spatial variant drops a channel over (T, H, W))."""

    def __init__(self, in_channels, filters, ks_cl1=(5, 5), ks_cl2=(3, 3),
                 activation='relu', normalization=None, dropout_rate=0.0,
                 dropout_variant=None, dtype=torch.float32):
        super().__init__()
        self.act = get_activation(activation)
        self.Dropout_0 = _dropout(dropout_rate, dropout_variant, dim=3)
        self.ConvLSTM2D_0 = ConvLSTM2D(in_channels, filters, ks_cl1, dtype)
        self._Norm_0 = _norm(normalization, filters, dtype)
        self.Dropout_1 = _dropout(dropout_rate, dropout_variant, dim=3)
        self.ConvLSTM2D_1 = ConvLSTM2D(filters, filters, ks_cl2, dtype)
        self._Norm_1 = _norm(normalization, filters, dtype)

    def forward(self, x):
        y = self.ConvLSTM2D_0(_maybe(self.Dropout_0, x))
        y = self.act(_maybe(self._Norm_0, y))
        y = self.ConvLSTM2D_1(_maybe(self.Dropout_1, y))
        return self.act(_maybe(self._Norm_1, y))


# the modules whose sharded parameters have a tensor rule (`_Kernel`'s
# through its ConvLSTM2D); `parallel.shard_network` refuses any other
TENSOR_RULES = (Conv, Dense, ConvTranspose, ChannelAttention2D,
                LocalizedConvBlock, _Kernel)
