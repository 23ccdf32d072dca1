"""
Model building blocks (PyTorch, NHWC at every boundary).

Counterparts of `dl4ds_tpu/models/blocks.py` for the convnet, resnet and
densenet backbones, the three post-upsampling heads (sub-pixel, resize and
transposed convolutions), the U-Net's encoder and padded concatenation,
and the ConvLSTM blocks of the spatio-temporal models.
Activations stay [B, H, W, C] ([B, T, H, W, C] through the ConvLSTM layers,
which run the fused kernel K2 on the GPU): a convolution views its input
as NCHW with channels-last strides (a permute, no copy), so the gate kernel
and the pixel shuffle see the JAX package's layout. Submodules carry the
names of the Flax parameter tree (`Conv_0`, `ChannelAttention2D_0`, ...), so
`weights.load_jax_params` maps one onto the other by walking both.

Parameters are float32 whatever the model dtype, as Flax's `param_dtype`
keeps them; `dtype` (float32 or bfloat16) is the compute dtype, with the
JAX package's promotions: a `Conv` casts its input, weight and bias to it
and returns it, as a Flax `Conv(dtype=...)` does, the gate returns float32
(its float32 biases promote it, `channel_attention_reference`), and the
blocks add and activate in the promoted dtype, so a bfloat16 model's
residual stream is float32. `reset_parameters(generator)` draws the Keras
defaults the JAX package uses: glorot_uniform kernels and zero biases, and
for ConvLSTM2D an orthogonal recurrent kernel and the unit forget bias.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..interpolation import resize2d
from ..ops import depth_to_space, fused_channel_attention, fused_convlstm
from ..utils import not_ported

MODEL_DTYPES = (torch.float32, torch.bfloat16)

__all__ = ['MODEL_DTYPES', 'check_dtype', 'Conv', 'ConvTranspose',
           'get_activation', 'ChannelAttention2D', 'ConvBlock',
           'ResidualBlock', 'DenseBlock', 'TransitionBlock',
           'SubpixelConvolutionBlock', 'ResizeConvolutionBlock',
           'DeconvolutionBlock', 'EncoderBlock', 'PadConcat', 'pad_concat',
           'ConvLSTM2D', 'RecurrentConvBlock']


def _glorot_uniform_(tensor, fan_in, fan_out, generator):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        tensor.uniform_(-limit, limit, generator=generator)


def _check_norm(normalization):
    """Only normalization=None is ported; 'bn' and 'ln' are queued."""
    if normalization in ('bn', 'ln'):
        raise not_ported(f'normalization={normalization!r}', 6)
    if normalization is not None:
        raise ValueError(f'Normalization not supported, got {normalization}')


def _check_dropout(dropout_rate):
    if dropout_rate:
        raise not_ported('dropout', 6)


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
    """SAME-padded stride-1 2-D convolution of an NHWC tensor. The kernel is
    held in torch's OIHW layout; odd kernel sizes only (SAME padding is then
    symmetric). In `dtype` bfloat16 the input, weight and bias are cast to
    it and the bias is added after the convolution's rounding, as Flax's
    `Conv` adds it (a bias inside cuDNN's convolution would be added
    before the rounding). cuDNN's bfloat16 convolution accumulates in
    float32; on the CPU the product is taken in float32 and rounded once,
    as XLA's CPU convolution takes it (oneDNN's bfloat16 convolution
    rounds a few outputs otherwise)."""

    def __init__(self, in_channels, filters, kernel_size=(3, 3),
                 use_bias=True, dtype=torch.float32):
        super().__init__()
        self.dtype = check_dtype(dtype)
        kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        if kh % 2 == 0 or kw % 2 == 0:
            raise NotImplementedError(
                f'even kernel {kh}x{kw}: SAME padding would be asymmetric')
        self.padding = (kh // 2, kw // 2)
        self.weight = nn.Parameter(torch.empty(filters, in_channels, kh, kw))
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

    def forward(self, x):
        if self.dtype == torch.float32:   # (also float64 reference runs)
            y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                         padding=self.padding)
            return y.permute(0, 2, 3, 1).contiguous()
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if x.is_cuda:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=self.padding)
        else:   # rounded once from float32, as XLA's CPU convolution
            y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float(),
                         padding=self.padding).to(self.dtype)
        y = y.permute(0, 2, 3, 1).contiguous()
        return y if self.bias is None else y + self.bias.to(self.dtype)


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
        h, w = x.shape[1:3]
        s = self.stride
        k = self.kernel
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
    rest (K1's float32-output mode on the GPU)."""

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
        if t is not None and t > 1:
            bt, h, w, c = x.shape
            xr = x.reshape(bt // t, t, h, w, c)
            m = xr.mean(dim=(1, 2))                                # [B, W, C]
            hdn = F.relu(m @ self.w1.to(m.dtype) + self.b1)
            g = torch.sigmoid(hdn @ self.w2.to(m.dtype).to(hdn.dtype)
                              + self.b2)
            return (xr * g[:, None, None]).reshape(bt, h, w, c)
        return fused_channel_attention(
            x, self.w1, self.b1, self.w2, self.b2,
            out_dtype=torch.float32 if x.dtype == torch.bfloat16 else None)


class ConvBlock(nn.Module):
    """Two-conv block (dl4ds_tpu/models/blocks.py:275-312):
    conv -> act -> conv -> act -> [channel attention]. `attention_time` is
    the recurrent heads' time window, for the gate's rank-5 quirk."""

    def __init__(self, in_channels, filters, ks_cl1=(3, 3), ks_cl2=(3, 3),
                 activation='relu', normalization=None, attention=False,
                 attention_time=None, dropout_rate=0.0, dtype=torch.float32):
        super().__init__()
        _check_norm(normalization)
        _check_dropout(dropout_rate)
        self.act = get_activation(activation)
        self.Conv_0 = Conv(in_channels, filters, ks_cl1, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, ks_cl2, dtype=dtype)
        self.ChannelAttention2D_0 = (
            ChannelAttention2D(filters, filters, time_window=attention_time)
            if attention else None)

    def forward(self, x):
        y = self.act(self.Conv_0(x))
        y = self.act(self.Conv_1(y))
        if self.ChannelAttention2D_0 is not None:
            y = self.ChannelAttention2D_0(y)
        return y


class ResidualBlock(nn.Module):
    """Residual block (dl4ds_tpu/models/blocks.py:315-346): conv -> act ->
    conv -> [attention] -> add the input ([1x1 conv] first) -> act. The gate
    comes before the residual add."""

    def __init__(self, in_channels, filters, activation='relu',
                 normalization=None, attention=False, dropout_rate=0.0,
                 use_1x1conv=False, dtype=torch.float32):
        super().__init__()
        _check_norm(normalization)
        _check_dropout(dropout_rate)
        self.act = get_activation(activation)
        self.Conv_0 = Conv(in_channels, filters, (3, 3), dtype=dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), dtype=dtype)
        self.ChannelAttention2D_0 = (ChannelAttention2D(filters, filters)
                                     if attention else None)
        self.Conv_2 = (Conv(in_channels, filters, (1, 1), dtype=dtype)
                       if use_1x1conv else None)

    def forward(self, x):
        y = self.act(self.Conv_0(x))
        y = self.Conv_1(y)
        if self.ChannelAttention2D_0 is not None:
            y = self.ChannelAttention2D_0(y)
        if self.Conv_2 is not None:
            x = self.Conv_2(x)
        return self.act(y + x)


class DenseBlock(nn.Module):
    """DenseNet-style block (dl4ds_tpu/models/blocks.py:349-375): a 1x1
    conv to 4 * filters -> act -> a 3x3 conv to filters -> [attention],
    concatenated before the input: in_channels + filters channels out."""

    def __init__(self, in_channels, filters, activation='relu',
                 normalization=None, attention=False, dropout_rate=0.0,
                 dtype=torch.float32):
        super().__init__()
        _check_norm(normalization)
        _check_dropout(dropout_rate)
        self.act = get_activation(activation)
        self.Conv_0 = Conv(in_channels, 4 * filters, (1, 1), dtype=dtype)
        self.Conv_1 = Conv(4 * filters, filters, (3, 3), dtype=dtype)
        self.ChannelAttention2D_0 = (ChannelAttention2D(filters, filters)
                                     if attention else None)

    def forward(self, x):
        y = self.Conv_1(self.act(self.Conv_0(x)))
        if self.ChannelAttention2D_0 is not None:
            y = self.ChannelAttention2D_0(y)
        # torch.cat promotes a float32 gate output against a bfloat16 input,
        # as jnp.concatenate does
        return torch.cat([y, x], dim=-1)


class TransitionBlock(nn.Module):
    """1x1-conv channel controller (dl4ds_tpu/models/blocks.py:378-394):
    conv -> act."""

    def __init__(self, in_channels, filters, activation='relu',
                 normalization=None, dtype=torch.float32):
        super().__init__()
        _check_norm(normalization)
        self.act = get_activation(activation)
        self.Conv_0 = Conv(in_channels, filters, (1, 1), dtype=dtype)

    def forward(self, x):
        return self.act(self.Conv_0(x))


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
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
    return y.permute(0, 2, 3, 1).contiguous()


class EncoderBlock(nn.Module):
    """U-Net encoder step (dl4ds_tpu/models/blocks.py:792-811): a ConvBlock,
    then a 2x2 max-pool; returns (downsampled, skip)."""

    def __init__(self, in_channels, n_filters, activation=None,
                 dropout_rate=0.0, normalization=None, attention=False,
                 dtype=torch.float32):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(
            in_channels, n_filters, activation=activation,
            normalization=normalization, attention=attention,
            dropout_rate=dropout_rate, dtype=dtype)

    def forward(self, x):
        y = self.ConvBlock_0(x)
        return _max_pool_2x2(y), y


def pad_concat(t1, t2):
    """Zero-pad two NHWC tensors at the bottom and right to the larger grid
    and concatenate them on channels, promoting their dtypes as
    jnp.concatenate does (dl4ds_tpu/models/blocks.py:824-840)."""
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
        wx, bx = self.input_conv.kernel, self.input_conv.bias
        wh = self.cell.recurrent_conv.kernel
        if self.dtype == torch.bfloat16:
            x, wx, bx, wh = (u.to(self.dtype) for u in (x, wx, bx, wh))
        return fused_convlstm(x, wx, bx, wh)


class RecurrentConvBlock(nn.Module):
    """Two stacked ConvLSTM layers (dl4ds_tpu/models/blocks.py:654-678): a
    ks_cl1 ConvLSTM -> act -> a ks_cl2 ConvLSTM -> act, on [B, T, H, W, C]."""

    def __init__(self, in_channels, filters, ks_cl1=(5, 5), ks_cl2=(3, 3),
                 activation='relu', normalization=None, dropout_rate=0.0,
                 dtype=torch.float32):
        super().__init__()
        _check_norm(normalization)
        _check_dropout(dropout_rate)
        self.act = get_activation(activation)
        self.ConvLSTM2D_0 = ConvLSTM2D(in_channels, filters, ks_cl1, dtype)
        self.ConvLSTM2D_1 = ConvLSTM2D(filters, filters, ks_cl2, dtype)

    def forward(self, x):
        return self.act(self.ConvLSTM2D_1(self.act(self.ConvLSTM2D_0(x))))
