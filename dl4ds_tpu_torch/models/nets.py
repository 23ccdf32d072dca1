"""
Network architectures (PyTorch, NHWC at every boundary).

Counterparts of `dl4ds_tpu/models/nets.py` for the post-upsampling models
with the residual backbone and the sub-pixel head: the spatial one and the
spatio-temporal (ConvLSTM) one. Submodule names follow the Flax parameter
tree (`_Backbone_0`, `ResidualBlock1`, `RecurrentConvBlock1`, ...). The other
backbones and heads raise until they are ported. `dtype` (float32 or
bfloat16) is threaded through the backbone, the aux branch, the sub-pixel
head and the output module, as the JAX package threads it; parameters stay
float32.
"""

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..utils import not_ported
from .blocks import (Conv, ConvBlock, ResidualBlock, TransitionBlock,
                     SubpixelConvolutionBlock, RecurrentConvBlock,
                     get_activation, _check_dropout, check_dtype)

__all__ = ['NetPostupsampling', 'RecNetPostupsampling']


class _Backbone(nn.Module):
    """Stem conv + N residual blocks with filters growing as i * n_filters,
    then the out conv and the merge with the stem
    (dl4ds_tpu/models/nets.py:32-119, resnet branch). With `remat` each
    block's activations are recomputed in the backward pass instead of
    kept, as `nn.remat` wraps the blocks there."""

    def __init__(self, in_channels, backbone, n_filters, n_blocks,
                 activation='relu', normalization=None, attention=False,
                 dropout_rate=0.0, remat=False, dtype=torch.float32):
        super().__init__()
        if backbone != 'resnet':
            raise not_ported(f'backbone {backbone!r}', 6)
        _check_dropout(dropout_rate)
        f0 = n_filters
        self.remat = remat
        self.act = get_activation(activation)
        self.stem = Conv(in_channels, f0, (3, 3), dtype=dtype)
        self.n_blocks = n_blocks
        c_in = f0
        for i in range(n_blocks):
            filters = f0 * (i + 1)
            self.add_module(f'ResidualBlock{i + 1}', ResidualBlock(
                c_in, filters, activation=activation,
                normalization=normalization, attention=attention,
                use_1x1conv=(i != 0), dtype=dtype))
            c_in = filters
        self.n_filters = c_in
        self.backbone_out_conv = Conv(c_in, c_in, (3, 3), dtype=dtype)
        self.TransitionBlock_0 = TransitionBlock(f0, c_in,
                                                 activation=activation,
                                                 dtype=dtype)

    def forward(self, x):
        stem = self.stem(x)
        b = stem
        for i in range(self.n_blocks):
            block = self._modules[f'ResidualBlock{i + 1}']
            if self.remat and torch.is_grad_enabled():
                # the models draw no random numbers: no RNG state to keep
                b = checkpoint(block, b, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                b = block(b)
        b = self.act(self.backbone_out_conv(b))
        return self.TransitionBlock_0(stem) + b


class _OutputModule(nn.Module):
    """Transition -> ConvBlock(attention) -> ConvBlock(n_channels_out)
    (dl4ds_tpu/models/nets.py:122-149). The first ConvBlock has no
    activation."""

    def __init__(self, in_channels, n_filters, n_channels_out,
                 output_activation=None, normalization=None, attention=True,
                 dtype=torch.float32):
        super().__init__()
        self.TransitionLast = TransitionBlock(in_channels, n_filters,
                                              dtype=dtype)
        self.ConvBlock_0 = ConvBlock(n_filters, n_filters, activation=None,
                                     normalization=normalization,
                                     attention=attention, dtype=dtype)
        self.ConvBlock_1 = ConvBlock(n_filters, n_channels_out,
                                     activation=output_activation,
                                     normalization=normalization, dtype=dtype)

    def forward(self, x):
        return self.ConvBlock_1(self.ConvBlock_0(self.TransitionLast(x)))


class _AuxBranch(nn.Module):
    """ConvBlock over the HR auxiliary input
    (dl4ds_tpu/models/nets.py:152-172)."""

    def __init__(self, in_channels, n_filters, activation='relu',
                 normalization=None, dtype=torch.float32):
        super().__init__()
        self.ConvBlock_aux = ConvBlock(in_channels, n_filters,
                                       activation=activation,
                                       normalization=normalization,
                                       dtype=dtype)

    def forward(self, s):
        return self.ConvBlock_aux(s)


class NetPostupsampling(nn.Module):
    """Spatial model with a post-upsampling head
    (dl4ds_tpu/models/nets.py:175-232). Input [B, h, w, C] at LR and an
    optional HR aux [B, h*scale, w*scale, A]; output
    [B, h*scale, w*scale, n_channels_out]. 'spc' only."""

    def __init__(self, n_channels, n_aux_channels, backbone, upsampling,
                 scale, n_channels_out=1, n_filters=8, n_blocks=6,
                 normalization=None, dropout_rate=0.0, dropout_variant=None,
                 attention=False, activation='relu', output_activation=None,
                 localcon_layer=False, output_attention=True, remat=False,
                 dtype=torch.float32):
        super().__init__()
        if upsampling != 'spc':
            raise not_ported(f'upsampling {upsampling!r}', 6)
        if localcon_layer:
            raise not_ported('localcon_layer', 6)
        _check_dropout(dropout_rate)
        check_dtype(dtype)
        self._Backbone_0 = _Backbone(n_channels, backbone, n_filters,
                                     n_blocks, activation, normalization,
                                     attention, remat=remat, dtype=dtype)
        width = self._Backbone_0.n_filters
        self.SubpixelConvolutionBlock_0 = SubpixelConvolutionBlock(
            scale, width, dtype=dtype)
        self.n_aux_channels = n_aux_channels
        if n_aux_channels > 0:
            self._AuxBranch_0 = _AuxBranch(n_aux_channels, width, activation,
                                           normalization, dtype=dtype)
        self._OutputModule_0 = _OutputModule(
            width * (2 if n_aux_channels > 0 else 1), n_filters,
            n_channels_out, output_activation, normalization,
            attention=output_attention, dtype=dtype)

    def forward(self, x, aux=None):
        if (aux is not None) != (self.n_aux_channels > 0):
            raise ValueError(f'model built for {self.n_aux_channels} aux '
                             f'channels, got aux={None if aux is None else tuple(aux.shape)}')
        x = self.SubpixelConvolutionBlock_0(self._Backbone_0(x))
        if aux is not None:
            x = torch.cat([x, self._AuxBranch_0(aux)], dim=-1)
        return self._OutputModule_0(x)


class _RecBackbone(nn.Module):
    """Spatio-temporal backbone (dl4ds_tpu/models/nets.py:378-419): a stem
    RecurrentConvBlock, N more at n_filters, then the resnet merge
    x0 + b. [B, T, h, w, C] -> [B, T, h, w, n_filters]."""

    def __init__(self, in_channels, backbone, n_filters, n_blocks,
                 activation='relu', normalization=None, dropout_rate=0.0,
                 dtype=torch.float32):
        super().__init__()
        if backbone != 'resnet':
            raise not_ported(f'recurrent backbone {backbone!r}', 7)
        _check_dropout(dropout_rate)
        self.n_blocks = n_blocks
        self.RecurrentConvBlock1 = RecurrentConvBlock(
            in_channels, n_filters, activation=activation,
            normalization=normalization, dtype=dtype)
        for i in range(n_blocks):
            self.add_module(f'RecurrentConvBlock{i + 2}', RecurrentConvBlock(
                n_filters, n_filters, activation=activation,
                normalization=normalization, dtype=dtype))

    def forward(self, x):
        x0 = b = self.RecurrentConvBlock1(x)
        for i in range(self.n_blocks):
            b = self._modules[f'RecurrentConvBlock{i + 2}'](b)
        return x0 + b


class RecNetPostupsampling(nn.Module):
    """Spatio-temporal (ConvLSTM) model with a post-upsampling head
    (dl4ds_tpu/models/nets.py:422-499). Input [B, T, h, w, C] at LR and an
    optional HR aux [B, h*scale, w*scale, A]; output
    [B, T, h*scale, w*scale, n_channels_out]. The head runs per frame on the
    [B*T]-flattened frames: the sub-pixel upsampler, the aux branch
    (`ConvBlock_0`, its output repeated over time), `TransitionLast` to half
    the channels, then the gated ConvBlock (its attention pools over (T, H))
    and the output ConvBlock. 'spc' only."""

    def __init__(self, n_channels, n_aux_channels, backbone, upsampling,
                 scale, time_window, n_channels_out=1, n_filters=8,
                 n_blocks=4, normalization=None, dropout_rate=0.0,
                 dropout_variant=None, attention=False, activation='relu',
                 output_activation=None, localcon_layer=False,
                 output_attention=True, dtype=torch.float32):
        super().__init__()
        if upsampling != 'spc':
            raise not_ported(f'upsampling {upsampling!r}', 6)
        if localcon_layer:
            raise not_ported('localcon_layer', 6)
        _check_dropout(dropout_rate)
        check_dtype(dtype)
        self.time_window = time_window
        self._RecBackbone_0 = _RecBackbone(n_channels, backbone, n_filters,
                                           n_blocks, activation,
                                           normalization, dtype=dtype)
        self.SubpixelConvolutionBlock_0 = SubpixelConvolutionBlock(
            scale, n_filters, dtype=dtype)
        self.n_aux_channels = n_aux_channels
        width = n_filters
        # Flax auto-names the head's ConvBlocks in call order, so the aux
        # branch, when there is one, takes ConvBlock_0
        names = iter(f'ConvBlock_{i}' for i in range(3))
        if n_aux_channels > 0:
            self.aux_name = next(names)
            self.add_module(self.aux_name, ConvBlock(
                n_aux_channels, n_filters, activation=activation,
                attention=attention, dtype=dtype))
            width += n_filters
        self.TransitionLast = TransitionBlock(width, width // 2, dtype=dtype)
        self.gate_name, self.out_name = next(names), next(names)
        self.add_module(self.gate_name, ConvBlock(
            width // 2, n_filters, activation=None,
            normalization=normalization, attention=output_attention,
            attention_time=time_window, dtype=dtype))
        self.add_module(self.out_name, ConvBlock(
            n_filters, n_channels_out, activation=output_activation,
            normalization=normalization, dtype=dtype))

    def forward(self, x, aux=None):
        if (aux is not None) != (self.n_aux_channels > 0):
            raise ValueError(f'model built for {self.n_aux_channels} aux '
                             f'channels, got aux={None if aux is None else tuple(aux.shape)}')
        b, t = x.shape[:2]
        if t != self.time_window:
            raise ValueError(f'model built for time_window='
                             f'{self.time_window}, got {t} frames')
        x = self._RecBackbone_0(x)
        x = self.SubpixelConvolutionBlock_0(x.reshape(b * t, *x.shape[2:]))
        if aux is not None:
            s = self._modules[self.aux_name](aux)
            # broadcast over time, [b*t] major (jnp.repeat on axis 0)
            x = torch.cat([x, s.repeat_interleave(t, dim=0)], dim=-1)
        x = self.TransitionLast(x)
        x = self._modules[self.out_name](self._modules[self.gate_name](x))
        return x.reshape(b, t, *x.shape[1:])
