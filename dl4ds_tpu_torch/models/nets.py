"""
Network architectures (PyTorch, NHWC at every boundary).

Counterparts of `dl4ds_tpu/models/nets.py`: the post-upsampling models
with the convnet, resnet, densenet or ConvNeXt backbone and the sub-pixel
('spc'), resize ('rc') or transposed-convolution ('dc') head; the
pre-upsampled models `NetPIN` and `UnetPIN`; and the spatio-temporal
(ConvLSTM) models, with the convnet, resnet or densenet merge: any of the
three heads (`RecNetPostupsampling`) or pre-upsampled (`RecNetPIN`). Every
model takes the JAX package's normalization ('bn', 'ln'), dropout (rate
and variant, at the JAX package's places) and localized output layer
(`localcon_layer`, whose weights fix the HR grid `hr_size`); and CGAN's
two-branch `ResidualDiscriminator`. Submodule
names follow the Flax parameter tree (`_Backbone_0`, `ResidualBlock1`,
`ConvNextBlock1`, `DenseBlock1`, `EncoderBlock1`, `RecurrentConvBlock1`,
`LocalizedConvBlock_0`, ...), and the input channels of every module are
counted here, where Flax infers them.
`dtype` (float32 or bfloat16) is threaded through every module, as the JAX
package threads it; parameters stay float32.
"""

import warnings

import torch
import torch.nn as nn

from ..interpolation import resize2d
from .blocks import (Conv, ConvBlock, ResidualBlock, DenseBlock,
                     TransitionBlock, ConvNextBlock, LocalizedConvBlock,
                     SubpixelConvolutionBlock, ResizeConvolutionBlock,
                     DeconvolutionBlock, EncoderBlock, RecurrentConvBlock,
                     Dense, Dropout, get_activation, pad_concat, check_dtype,
                     remat_call, _dropout, _maybe, _no_band_rule)

__all__ = ['NetPostupsampling', 'NetPIN', 'UnetPIN', 'RecNetPostupsampling',
           'RecNetPIN', 'ResidualDiscriminator', '_check_nblocks']


class _Backbone(nn.Module):
    """Stem conv + N blocks with filters growing as i * n_filters
    (dl4ds_tpu/models/nets.py:32-119): convnet `ConvBlock{i}`s and no
    merge; resnet `ResidualBlock{i}`s and `TransitionBlock_0(stem) + b`;
    densenet `DenseBlock{i}`s (each adding its filters to the channels),
    each followed by `Transition{i}` to half the channels, and
    `TransitionBackboneLast` over concat([stem, b]); for these three the
    blocks take the dropout and normalization, and the out conv, its
    activation and a dropout follow them. ConvNeXt: a 7x7 stem,
    `ConvNextBlock{i}`s (a 1x1 residual conv from the second on), and
    `TransitionBlock_0(stem) + b`, without out conv or dropout. With
    `remat` each block's activations (not the transitions') are recomputed
    in the backward pass instead of kept, as `nn.remat` wraps the blocks
    there, its dropout masks replayed and its running statistics moved
    once (`remat_call`). `n_filters` is the width it returns."""

    def __init__(self, in_channels, backbone, n_filters, n_blocks,
                 activation='relu', normalization=None, attention=False,
                 dropout_rate=0.0, dropout_variant=None, remat=False,
                 dtype=torch.float32):
        super().__init__()
        if backbone not in ('convnet', 'resnet', 'densenet', 'convnext'):
            raise ValueError(f'unsupported backbone {backbone}')
        f0 = n_filters
        self.backbone = backbone
        self.remat = remat
        self.act = get_activation(activation)
        ks = (7, 7) if backbone == 'convnext' else (3, 3)
        self.stem = Conv(in_channels, f0, ks, dtype=dtype)
        self.n_blocks = n_blocks
        block_args = dict(activation=activation, normalization=normalization,
                          dtype=dtype)
        if backbone != 'convnext':
            block_args.update(attention=attention, dropout_rate=dropout_rate,
                              dropout_variant=dropout_variant)
        c_in = filters = f0
        for i in range(n_blocks):
            filters = f0 * (i + 1)
            if backbone == 'convnet':
                self.add_module(f'ConvBlock{i + 1}', ConvBlock(
                    c_in, filters, **block_args))
                c_in = filters
            elif backbone == 'resnet':
                self.add_module(f'ResidualBlock{i + 1}', ResidualBlock(
                    c_in, filters, use_1x1conv=(i != 0), **block_args))
                c_in = filters
            elif backbone == 'convnext':
                self.add_module(f'ConvNextBlock{i + 1}', ConvNextBlock(
                    c_in, filters, drop_path=0.0, use_1x1conv=(i != 0),
                    **block_args))
                c_in = filters
            else:
                self.add_module(f'DenseBlock{i + 1}', DenseBlock(
                    c_in, filters, **block_args))
                # the JAX Transitions take TransitionBlock's default relu
                self.add_module(f'Transition{i + 1}', TransitionBlock(
                    c_in + filters, (c_in + filters) // 2, dtype=dtype))
                c_in = (c_in + filters) // 2
        self.n_filters = filters
        if backbone != 'convnext':
            self.backbone_out_conv = Conv(c_in, filters, (3, 3), dtype=dtype)
            self.Dropout_0 = _dropout(dropout_rate, dropout_variant)
        if backbone in ('resnet', 'convnext'):
            self.TransitionBlock_0 = TransitionBlock(
                f0, filters, activation=activation, dtype=dtype)
        elif backbone == 'densenet':
            self.TransitionBackboneLast = TransitionBlock(
                f0 + filters, filters, activation=activation, dtype=dtype)

    def forward(self, x):
        stem = self.stem(x)
        b = stem
        kind = {'convnet': 'ConvBlock', 'resnet': 'ResidualBlock',
                'densenet': 'DenseBlock',
                'convnext': 'ConvNextBlock'}[self.backbone]
        for i in range(self.n_blocks):
            block = self._modules[f'{kind}{i + 1}']
            if self.remat and torch.is_grad_enabled():
                b = remat_call(block, b)
            else:
                b = block(b)
            if self.backbone == 'densenet':
                b = self._modules[f'Transition{i + 1}'](b)
        if self.backbone == 'convnext':
            return self.TransitionBlock_0(stem) + b
        b = _maybe(self.Dropout_0, self.act(self.backbone_out_conv(b)))
        if self.backbone == 'resnet':
            return self.TransitionBlock_0(stem) + b
        if self.backbone == 'densenet':
            return self.TransitionBackboneLast(torch.cat([stem, b], dim=-1))
        return b


class _OutputModule(nn.Module):
    """Transition -> ConvBlock(attention) -> ConvBlock(n_channels_out)
    (dl4ds_tpu/models/nets.py:122-149), their convs `ks` (7x7 behind the
    ConvNeXt backbone). The first ConvBlock has no activation and takes
    the model's dropout rate with the vanilla variant: the JAX module
    passes it no variant."""

    def __init__(self, in_channels, n_filters, n_channels_out, ks=(3, 3),
                 output_activation=None, normalization=None, dropout_rate=0.0,
                 attention=True, dtype=torch.float32):
        super().__init__()
        self.TransitionLast = TransitionBlock(in_channels, n_filters,
                                              dtype=dtype)
        self.ConvBlock_0 = ConvBlock(n_filters, n_filters, ks, ks,
                                     activation=None,
                                     normalization=normalization,
                                     attention=attention,
                                     dropout_rate=dropout_rate, dtype=dtype)
        self.ConvBlock_1 = ConvBlock(n_filters, n_channels_out, ks, ks,
                                     activation=output_activation,
                                     normalization=normalization, dtype=dtype)

    def forward(self, x):
        return self.ConvBlock_1(self.ConvBlock_0(self.TransitionLast(x)))


class _AuxBranch(nn.Module):
    """The HR auxiliary input's branch (dl4ds_tpu/models/nets.py:152-172):
    `ConvBlock_aux`, or behind the ConvNeXt backbone `ConvNextBlock_aux`
    (with its 1x1 residual conv)."""

    def __init__(self, in_channels, backbone, n_filters, activation='relu',
                 normalization=None, dtype=torch.float32):
        super().__init__()
        if backbone == 'convnext':
            self.block = 'ConvNextBlock_aux'
            self.ConvNextBlock_aux = ConvNextBlock(
                in_channels, n_filters, drop_path=0.0, use_1x1conv=True,
                activation=activation, normalization=normalization,
                dtype=dtype)
        else:
            self.block = 'ConvBlock_aux'
            self.ConvBlock_aux = ConvBlock(in_channels, n_filters,
                                           activation=activation,
                                           normalization=normalization,
                                           dtype=dtype)

    def forward(self, s):
        return self._modules[self.block](s)


def _localcon(model, localcon_layer, in_channels, grid, dtype):
    """Add `LocalizedConvBlock_0` (2 channels, on the HR `grid`) to `model`
    with `localcon_layer`; returns the channels it adds."""
    if not localcon_layer:
        return 0
    if grid is None:
        raise ValueError('localcon_layer needs the HR grid `hr_size`: its '
                         'weights are per pixel')
    model.LocalizedConvBlock_0 = LocalizedConvBlock(in_channels, grid, 2,
                                                    dtype=dtype)
    return 2


def _with_localcon(model, x):
    lcb = model._modules.get('LocalizedConvBlock_0')
    return x if lcb is None else torch.cat([x, lcb(x)], dim=-1)


def _check_aux(n_aux_channels, aux):
    if (aux is not None) != (n_aux_channels > 0):
        raise ValueError(f'model built for {n_aux_channels} aux channels, '
                         f'got aux={None if aux is None else tuple(aux.shape)}')


def _attach_head(model, upsampling, scale, width, rc_interpolation,
                 activation=None, transition_dc=None, dtype=torch.float32):
    """Add the upsampling head of a post-upsampling model to `model`, where
    the Flax tree holds it (dl4ds_tpu/models/nets.py:205-219, 461-472),
    [.., h, w, width] -> [.., h*scale, w*scale, width], and return its
    submodules' names in call order: 'spc' `SubpixelConvolutionBlock_0`;
    'rc' `ResizeConvolutionBlock_0`; 'dc' `DeconvolutionBlock_0`, which in
    the spatial model comes after `TransitionDC`, a 1x1 conv to
    `transition_dc` (f0) channels, and takes `activation` as its output
    activation (the recurrent head has neither, as in the JAX package)."""
    if upsampling == 'spc':
        model.SubpixelConvolutionBlock_0 = SubpixelConvolutionBlock(
            scale, width, dtype=dtype)
        return ['SubpixelConvolutionBlock_0']
    if upsampling == 'rc':
        model.ResizeConvolutionBlock_0 = ResizeConvolutionBlock(
            scale, width, interpolation=rc_interpolation, dtype=dtype)
        return ['ResizeConvolutionBlock_0']
    if upsampling != 'dc':
        raise ValueError(f'bad post-upsampling: {upsampling}')
    if transition_dc is None:
        model.DeconvolutionBlock_0 = DeconvolutionBlock(scale, width,
                                                        dtype=dtype)
        return ['DeconvolutionBlock_0']
    model.TransitionDC = TransitionBlock(width, transition_dc,
                                         activation=activation, dtype=dtype)
    model.DeconvolutionBlock_0 = DeconvolutionBlock(
        scale, width, activation, in_channels=transition_dc, dtype=dtype)
    return ['TransitionDC', 'DeconvolutionBlock_0']


class NetPostupsampling(nn.Module):
    """Spatial model with a post-upsampling head
    (dl4ds_tpu/models/nets.py:175-232). Input [B, h, w, C] at LR and an
    optional HR aux [B, h*scale, w*scale, A]; output
    [B, h*scale, w*scale, n_channels_out]. Heads 'spc', 'rc' (resized with
    `rc_interpolation`) and 'dc'; with `localcon_layer` the localized
    layer's 2 channels (on the HR grid `hr_size`) join the head's output
    before the aux branch's."""

    def __init__(self, n_channels, n_aux_channels, backbone, upsampling,
                 scale, n_channels_out=1, n_filters=8, n_blocks=6,
                 normalization=None, dropout_rate=0.0, dropout_variant=None,
                 attention=False, activation='relu', output_activation=None,
                 rc_interpolation='bilinear', localcon_layer=False,
                 output_attention=True, remat=False, hr_size=None,
                 dtype=torch.float32):
        super().__init__()
        check_dtype(dtype)
        self._Backbone_0 = _Backbone(n_channels, backbone, n_filters,
                                     n_blocks, activation, normalization,
                                     attention, dropout_rate,
                                     dropout_variant, remat=remat,
                                     dtype=dtype)
        width = self._Backbone_0.n_filters
        self.head = _attach_head(self, upsampling, scale, width,
                                 rc_interpolation, activation,
                                 transition_dc=n_filters, dtype=dtype)
        c_out = width + _localcon(self, localcon_layer, width, hr_size, dtype)
        self.n_aux_channels = n_aux_channels
        if n_aux_channels > 0:
            self._AuxBranch_0 = _AuxBranch(n_aux_channels, backbone, width,
                                           activation, normalization,
                                           dtype=dtype)
            c_out += width
        ks = (7, 7) if backbone == 'convnext' else (3, 3)
        self._OutputModule_0 = _OutputModule(
            c_out, n_filters, n_channels_out, ks, output_activation,
            normalization, dropout_rate, attention=output_attention,
            dtype=dtype)

    def forward(self, x, aux=None):
        _check_aux(self.n_aux_channels, aux)
        x = self._Backbone_0(x)
        for name in self.head:
            x = self._modules[name](x)
        x = _with_localcon(self, x)
        if aux is not None:
            x = torch.cat([x, self._AuxBranch_0(aux)], dim=-1)
        return self._OutputModule_0(x)


class NetPIN(nn.Module):
    """Spatial pre-upsampled model (dl4ds_tpu/models/nets.py:235-274): the
    backbone runs on the input already interpolated to the HR grid, [B, H,
    W, C] -> [B, H, W, n_channels_out], then the optional localized layer
    (on `hr_size`) and aux branch, and the output module."""

    def __init__(self, n_channels, n_aux_channels, backbone,
                 n_channels_out=1, n_filters=8, n_blocks=6, dropout_rate=0.0,
                 dropout_variant=None, normalization=None, attention=False,
                 activation='relu', output_activation=None,
                 localcon_layer=False, output_attention=True, remat=False,
                 hr_size=None, dtype=torch.float32):
        super().__init__()
        check_dtype(dtype)
        self._Backbone_0 = _Backbone(n_channels, backbone, n_filters,
                                     n_blocks, activation, normalization,
                                     attention, dropout_rate,
                                     dropout_variant, remat=remat,
                                     dtype=dtype)
        width = self._Backbone_0.n_filters
        c_out = width + _localcon(self, localcon_layer, width, hr_size, dtype)
        self.n_aux_channels = n_aux_channels
        if n_aux_channels > 0:
            self._AuxBranch_0 = _AuxBranch(n_aux_channels, backbone, width,
                                           activation, normalization,
                                           dtype=dtype)
            c_out += width
        ks = (7, 7) if backbone == 'convnext' else (3, 3)
        self._OutputModule_0 = _OutputModule(
            c_out, n_filters, n_channels_out, ks, output_activation,
            normalization, dropout_rate, attention=output_attention,
            dtype=dtype)

    def forward(self, x, aux=None):
        _check_aux(self.n_aux_channels, aux)
        x = _with_localcon(self, self._Backbone_0(x))
        if aux is not None:
            x = torch.cat([x, self._AuxBranch_0(aux)], dim=-1)
        return self._OutputModule_0(x)


class UnetPIN(nn.Module):
    """U-Net encoder/decoder on the pre-upsampled input
    (dl4ds_tpu/models/nets.py:277-359). `EncoderBlock{i}`s with filters
    doubling per level, capped at `width_cap`; a `Bottleneck` ConvBlock
    (no normalisation; the model's dropout); per level a x2 upsampler
    ('rc', 'spc' or 'dc' `decoder_upsampling`), `pad_concat` with the
    level's skip (odd grids: max-pool floors, the padding restores the
    skip's size) and `DecoderConvBlock{j}`; then a dropout, the localized
    layer (on `hr_size`), the aux ConvBlock (Flax's `ConvBlock_0`) and the
    output module. `n_blocks` is the depth as built (`_check_nblocks` in
    the factory)."""

    def __init__(self, n_channels, n_aux_channels, backbone='unet',
                 n_channels_out=1, n_filters=8, n_blocks=6, activation='relu',
                 dropout_rate=0.0, dropout_variant=None, normalization=None,
                 attention=False, decoder_upsampling='rc',
                 rc_interpolation='bilinear', output_activation=None,
                 width_cap=256, localcon_layer=False, output_attention=True,
                 hr_size=None, dtype=torch.float32):
        super().__init__()
        check_dtype(dtype)
        if decoder_upsampling not in ('rc', 'spc', 'dc'):
            raise ValueError(
                f'bad decoder_upsampling: {decoder_upsampling}')
        self.n_blocks = n_blocks
        common = dict(normalization=normalization, attention=attention,
                      dtype=dtype)
        c_in, filters, filt_list = n_channels, n_filters, []
        for i in range(n_blocks):
            self.add_module(f'EncoderBlock{i + 1}', EncoderBlock(
                c_in, filters, activation=activation, **common))
            filt_list.append(filters)
            c_in, filters = filters, min(width_cap, filters * 2)
        self.Bottleneck = ConvBlock(c_in, filters, activation=activation,
                                    dropout_rate=dropout_rate,
                                    dropout_variant=dropout_variant,
                                    dtype=dtype)
        c_in = filters
        # (upsampler name, decoder ConvBlock name) per level; Flax
        # auto-names the upsamplers in call order
        kind = {'rc': 'ResizeConvolutionBlock', 'spc':
                'SubpixelConvolutionBlock', 'dc': 'DeconvolutionBlock'}[
                    decoder_upsampling]
        self.levels = []
        for j, filters in enumerate(reversed(filt_list)):
            if decoder_upsampling == 'rc':
                up = ResizeConvolutionBlock(2, filters, in_channels=c_in,
                                            interpolation=rc_interpolation,
                                            dtype=dtype)
            elif decoder_upsampling == 'spc':
                up = SubpixelConvolutionBlock(2, filters, in_channels=c_in,
                                              dtype=dtype)
            else:
                up = DeconvolutionBlock(2, filters, activation,
                                        in_channels=c_in, dtype=dtype)
            self.add_module(f'{kind}_{j}', up)
            self.add_module(f'DecoderConvBlock{j + 1}', ConvBlock(
                2 * filters, filters, activation=activation, **common))
            self.levels.append((f'{kind}_{j}', f'DecoderConvBlock{j + 1}'))
            c_in = filters
        self.Dropout_0 = _dropout(dropout_rate, dropout_variant)
        c_out = c_in + _localcon(self, localcon_layer, c_in, hr_size, dtype)
        self.n_aux_channels = n_aux_channels
        if n_aux_channels > 0:
            self.ConvBlock_0 = ConvBlock(n_aux_channels, c_in,
                                         activation=activation,
                                         normalization=normalization,
                                         dtype=dtype)
            c_out += c_in
        self._OutputModule_0 = _OutputModule(
            c_out, n_filters, n_channels_out, (3, 3), output_activation,
            normalization, dropout_rate, attention=output_attention,
            dtype=dtype)

    def forward(self, x, aux=None):
        _check_aux(self.n_aux_channels, aux)
        skips = []
        for i in range(self.n_blocks):
            x, skip = self._modules[f'EncoderBlock{i + 1}'](x)
            skips.append(skip)
        x = self.Bottleneck(x)
        for (up, conv), skip in zip(self.levels, reversed(skips)):
            x = self._modules[conv](pad_concat(self._modules[up](x), skip))
        x = _with_localcon(self, _maybe(self.Dropout_0, x))
        if aux is not None:
            x = torch.cat([x, self.ConvBlock_0(aux)], dim=-1)
        return self._OutputModule_0(x)


def _check_nblocks(shape, power):
    """The U-Net depth for an HR grid `shape`: `power` levels, fewer where
    the grid would fall below 2 pixels at the bottleneck, with the JAX
    package's RuntimeWarning (dl4ds_tpu/models/nets.py:362-375)."""
    requested = power
    while shape[0] // 2 ** power < 2 or shape[1] // 2 ** power < 2:
        power -= 1
    if power != requested:
        warnings.warn(
            f'`n_blocks` of the U-Net encoder reduced {requested} -> '
            f'{power} so the {shape} grid stays >= 2 px at the bottleneck',
            RuntimeWarning)
    return power


class _RecBackbone(nn.Module):
    """Spatio-temporal backbone (dl4ds_tpu/models/nets.py:378-419): a stem
    RecurrentConvBlock (normalization, no dropout), N more at n_filters
    (normalization and dropout), a dropout over (T, H, W), then the merge:
    'convnet' the blocks' output b, 'resnet' x0 + b, 'densenet' concat([x0,
    b]). [B, T, h, w, C] -> [B, T, h, w, `n_out`], n_out = n_filters (2 *
    n_filters for densenet)."""

    def __init__(self, in_channels, backbone, n_filters, n_blocks,
                 activation='relu', normalization=None, dropout_rate=0.0,
                 dropout_variant=None, dtype=torch.float32):
        super().__init__()
        if backbone not in ('convnet', 'resnet', 'densenet'):
            raise ValueError(f'unsupported recurrent backbone {backbone}')
        self.backbone = backbone
        self.n_blocks = n_blocks
        self.n_out = 2 * n_filters if backbone == 'densenet' else n_filters
        self.RecurrentConvBlock1 = RecurrentConvBlock(
            in_channels, n_filters, activation=activation,
            normalization=normalization, dtype=dtype)
        for i in range(n_blocks):
            self.add_module(f'RecurrentConvBlock{i + 2}', RecurrentConvBlock(
                n_filters, n_filters, activation=activation,
                normalization=normalization, dropout_rate=dropout_rate,
                dropout_variant=dropout_variant, dtype=dtype))
        self.Dropout_0 = _dropout(dropout_rate, dropout_variant, dim=3)

    def forward(self, x, trunk_fn=None):
        x0 = b = self.RecurrentConvBlock1(x)
        if trunk_fn is not None:
            # the pipeline's hook (parallel.make_pipeline_step): the
            # homogeneous trunk, blocks 2..n_blocks+1, computed outside from
            # the stem's output; those blocks are not run here
            b = trunk_fn(x0)
        else:
            for i in range(self.n_blocks):
                b = self._modules[f'RecurrentConvBlock{i + 2}'](b)
        b = _maybe(self.Dropout_0, b)
        if self.backbone == 'convnet':
            return b
        if self.backbone == 'resnet':
            return x0 + b
        return torch.cat([x0, b], dim=-1)


class RecNetPostupsampling(nn.Module):
    """Spatio-temporal (ConvLSTM) model with a post-upsampling head
    (dl4ds_tpu/models/nets.py:422-499). Input [B, T, h, w, C] at LR and an
    optional HR aux [B, h*scale, w*scale, A]; output
    [B, T, h*scale, w*scale, n_channels_out]. The head runs per frame on the
    [B*T]-flattened frames: the upsampler ('spc', 'rc' or 'dc'; the 'dc'
    head has no TransitionDC and no activation, as in the JAX package), the
    aux branch (`ConvBlock_0`, no normalization, its output repeated over
    time), the localized layer (on the HR grid `hr_size`), `TransitionLast`
    to half the channels, then the gated ConvBlock (its attention pools
    over (T, H); the model's dropout rate, vanilla variant) and the output
    ConvBlock."""

    def __init__(self, n_channels, n_aux_channels, backbone, upsampling,
                 scale, time_window, n_channels_out=1, n_filters=8,
                 n_blocks=4, normalization=None, dropout_rate=0.0,
                 dropout_variant=None, attention=False, activation='relu',
                 output_activation=None, rc_interpolation='bilinear',
                 localcon_layer=False, output_attention=True, hr_size=None,
                 dtype=torch.float32):
        super().__init__()
        check_dtype(dtype)
        self.time_window = time_window
        self._RecBackbone_0 = _RecBackbone(n_channels, backbone, n_filters,
                                           n_blocks, activation,
                                           normalization, dropout_rate,
                                           dropout_variant, dtype=dtype)
        # the head runs on the backbone's width: 2 * n_filters behind the
        # densenet merge (dl4ds_tpu/models/nets.py:453-454)
        width = self._RecBackbone_0.n_out
        self.head = _attach_head(self, upsampling, scale, width,
                                 rc_interpolation, dtype=dtype)
        self.n_aux_channels = n_aux_channels
        # Flax auto-names the head's ConvBlocks in call order, so the aux
        # branch, when there is one, takes ConvBlock_0
        names = iter(f'ConvBlock_{i}' for i in range(3))
        if n_aux_channels > 0:
            self.aux_name = next(names)
            self.add_module(self.aux_name, ConvBlock(
                n_aux_channels, n_filters, activation=activation,
                attention=attention, dtype=dtype))
            width += n_filters
        width += _localcon(self, localcon_layer, width, hr_size, dtype)
        self.TransitionLast = TransitionBlock(width, width // 2, dtype=dtype)
        self.gate_name, self.out_name = next(names), next(names)
        self.add_module(self.gate_name, ConvBlock(
            width // 2, n_filters, activation=None,
            normalization=normalization, attention=output_attention,
            attention_time=time_window, dropout_rate=dropout_rate,
            dtype=dtype))
        self.add_module(self.out_name, ConvBlock(
            n_filters, n_channels_out, activation=output_activation,
            normalization=normalization, dtype=dtype))

    def forward(self, x, aux=None, trunk_fn=None):
        _check_aux(self.n_aux_channels, aux)
        b, t = x.shape[:2]
        if t != self.time_window:
            raise ValueError(f'model built for time_window='
                             f'{self.time_window}, got {t} frames')
        x = self._RecBackbone_0(x, trunk_fn)
        x = x.reshape(b * t, *x.shape[2:])
        for name in self.head:
            x = self._modules[name](x)
        if aux is not None:
            s = self._modules[self.aux_name](aux)
            # broadcast over time, [b*t] major (jnp.repeat on axis 0)
            x = torch.cat([x, s.repeat_interleave(t, dim=0)], dim=-1)
        x = self.TransitionLast(_with_localcon(self, x))
        x = self._modules[self.out_name](self._modules[self.gate_name](x))
        return x.reshape(b, t, *x.shape[1:])


class RecNetPIN(nn.Module):
    """Spatio-temporal pre-upsampled model (dl4ds_tpu/models/nets.py:
    502-557). Input [B, T, H, W, C] already interpolated to the HR grid and
    an optional HR aux [B, H, W, A]; output [B, T, H, W, n_channels_out].
    The backbone's ConvLSTM layers run on the HR frames; then per frame, on
    the [B*T]-flattened frames: the aux branch (`ConvBlock_0`, no
    normalization, repeated over time), the localized layer (on `hr_size`),
    `TransitionLast` to n_filters (not half the width, unlike
    `RecNetPostupsampling`), the gated ConvBlock (its attention pools over
    (T, H)) and the output ConvBlock."""

    def __init__(self, n_channels, n_aux_channels, backbone, time_window,
                 n_channels_out=1, n_filters=8, n_blocks=6,
                 normalization=None, dropout_rate=0.0, dropout_variant=None,
                 attention=False, activation='relu', output_activation=None,
                 localcon_layer=False, output_attention=True, hr_size=None,
                 dtype=torch.float32):
        super().__init__()
        check_dtype(dtype)
        self.time_window = time_window
        self._RecBackbone_0 = _RecBackbone(n_channels, backbone, n_filters,
                                           n_blocks, activation,
                                           normalization, dropout_rate,
                                           dropout_variant, dtype=dtype)
        width = self._RecBackbone_0.n_out
        self.n_aux_channels = n_aux_channels
        names = iter(f'ConvBlock_{i}' for i in range(3))
        if n_aux_channels > 0:
            self.aux_name = next(names)
            self.add_module(self.aux_name, ConvBlock(
                n_aux_channels, n_filters, activation=activation,
                attention=attention, dtype=dtype))
            width += n_filters
        width += _localcon(self, localcon_layer, width, hr_size, dtype)
        self.TransitionLast = TransitionBlock(width, n_filters, dtype=dtype)
        self.gate_name, self.out_name = next(names), next(names)
        self.add_module(self.gate_name, ConvBlock(
            n_filters, n_filters, activation=None,
            normalization=normalization, attention=output_attention,
            attention_time=time_window, dropout_rate=dropout_rate,
            dtype=dtype))
        self.add_module(self.out_name, ConvBlock(
            n_filters, n_channels_out, activation=output_activation,
            normalization=normalization, dtype=dtype))

    def forward(self, x, aux=None, trunk_fn=None):
        _check_aux(self.n_aux_channels, aux)
        b, t = x.shape[:2]
        if t != self.time_window:
            raise ValueError(f'model built for time_window='
                             f'{self.time_window}, got {t} frames')
        x = self._RecBackbone_0(x, trunk_fn)
        x = x.reshape(b * t, *x.shape[2:])
        if aux is not None:
            s = self._modules[self.aux_name](aux)
            x = torch.cat([x, s.repeat_interleave(t, dim=0)], dim=-1)
        x = self.TransitionLast(_with_localcon(self, x))
        x = self._modules[self.out_name](self._modules[self.gate_name](x))
        return x.reshape(b, t, *x.shape[1:])


def _mean(x, dims=None):
    """jnp.mean over `dims` (all: None): a bfloat16 input summed and
    divided in float32, then rounded once."""
    dims = tuple(range(x.dim())) if dims is None else dims
    if x.dtype == torch.bfloat16:
        return x.float().mean(dims).to(x.dtype)
    return x.mean(dims)


class _Logistic(torch.autograd.Function):
    """jax.nn.sigmoid as XLA computes it: 1 / (1 + exp(-x)), each op
    rounded to x's dtype (so in bfloat16 three roundings, where
    torch.sigmoid rounds once), with its JVP's backward g * (y * (1 - y))
    in the same order."""

    @staticmethod
    def forward(ctx, x):
        y = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (y * (1 - y))


def _valid_chain_fits(hr_hw, lr_size):
    """True iff the reference's scale-5 chain (two 3x3 VALID stride-2
    convs, then a crop of 1 at the bottom and right) maps the HR grid
    `hr_hw` exactly onto `lr_size` (dl4ds_tpu/models/nets.py:583-591)."""
    def out(n):
        return (n - 3) // 2 + 1
    return tuple(out(out(n)) - 1 for n in hr_hw) == tuple(lr_size)


class ResidualDiscriminator(nn.Module):
    """Two-branch conditional discriminator
    (dl4ds_tpu/models/nets.py:560-655). Branch 1 takes the model input
    (LR, or HR for 'pin'): a stem conv, `n_res_blocks` residual blocks and
    a conv, plus the stem; a spatio-temporal discriminator's stem is a
    `RecurrentConvBlock` with layer norm, after which [B, T] is one batch
    axis. Branch 2 takes the HR candidate [B(, T), H, W, 1]: a stem conv and
    residual blocks, then down to the LR grid by two SAME stride-2 convs
    (scale 4), two VALID stride-2 convs and a bottom/right crop (scale 5
    where that lands on `lr_size`), bilinear `resize2d` (other scales), or
    for 'pin' a conv and the stem added. The branches are concatenated, a
    residual block runs over 2f channels, the mean is taken over the grid
    (and then over T), and Dropout(0.4), Dense(32), sigmoid, Dense(1),
    sigmoid give [B, 1] (the sigmoid as XLA computes it, `_Logistic`). The
    branches' residual blocks take the default relu; `activation` reaches
    the recurrent stem alone, as in the JAX module.

    The submodules carry the Flax names: `Conv_<i>` in creation order
    (the stems, branch 1's out conv, branch 2's strided or 'pin' convs),
    `RecurrentConvBlock_0`, `ResidualBlock<i>_branch1|2`, the merge's
    `ResidualBlock_0`, `Dropout_0`, `Dense_0`, `Dense_1`. The branch-2
    route is fixed here from the HR grid lr_size * scale; another grid
    that would route otherwise raises at the call."""

    def __init__(self, n_channels, upsampling, is_spatiotemporal, scale,
                 lr_size, n_filters=8, n_res_blocks=4, normalization=None,
                 activation='relu', attention=False, dtype=torch.float32):
        super().__init__()
        check_dtype(dtype)
        f = n_filters
        self.is_spatiotemporal = is_spatiotemporal
        self.lr_size = tuple(int(s) for s in lr_size)
        self.scale = scale
        self.n_res_blocks = n_res_blocks
        self.upsampling = upsampling
        names = iter(f'Conv_{i}' for i in range(6))
        block = dict(normalization=normalization, attention=attention,
                     dtype=dtype)
        if is_spatiotemporal:
            self.RecurrentConvBlock_0 = RecurrentConvBlock(
                n_channels, f, activation=activation, normalization='ln',
                dtype=dtype)
            self.stem1 = 'RecurrentConvBlock_0'
        else:
            self.stem1 = next(names)
            self.add_module(self.stem1, Conv(n_channels, f, dtype=dtype))
        for i in range(n_res_blocks):
            self.add_module(f'ResidualBlock{i + 1}_branch1',
                            ResidualBlock(f, f, **block))
        self.out1 = next(names)
        self.add_module(self.out1, Conv(f, f, dtype=dtype))
        self.stem2 = next(names)
        self.add_module(self.stem2, Conv(1, f, dtype=dtype))
        for i in range(n_res_blocks):
            self.add_module(f'ResidualBlock{i + 1}_branch2',
                            ResidualBlock(f, f, **block))
        hr_hw = tuple(s * scale for s in self.lr_size)
        self.route = self._route(hr_hw)
        self.down = []
        if self.route in ('same', 'valid'):
            pad = self.route.upper()
            for _ in range(2):
                self.down.append(next(names))
                self.add_module(self.down[-1], Conv(
                    f, f, strides=2, padding=pad, dtype=dtype))
        elif self.route == 'pin':
            self.down.append(next(names))
            self.add_module(self.down[-1], Conv(f, f, dtype=dtype))
        self.ResidualBlock_0 = ResidualBlock(2 * f, 2 * f, **block)
        self.Dropout_0 = Dropout(0.4)
        self.Dense_0 = Dense(2 * f, 32, dtype=dtype)
        self.Dense_1 = Dense(32, 1, dtype=dtype)

    def _route(self, hr_hw):
        from .. import POSTUPSAMPLING_METHODS
        if self.upsampling not in POSTUPSAMPLING_METHODS:
            return 'pin'
        if self.scale == 4:
            return 'same'
        if self.scale == 5 and _valid_chain_fits(hr_hw, self.lr_size):
            return 'valid'
        return 'resize'

    def forward(self, x, x_ref):
        _no_band_rule('the CGAN discriminator')
        bt = None
        if self.is_spatiotemporal:
            # everything after the recurrent stem runs per frame, on [B*T]
            x1 = self.RecurrentConvBlock_0(x)
            bt = tuple(x1.shape[:2])
            x1 = x1.reshape(bt[0] * bt[1], *x1.shape[2:])
            x_ref = x_ref.reshape(bt[0] * bt[1], *x_ref.shape[2:])
        else:
            x1 = self._modules[self.stem1](x)
        b = x1
        for i in range(self.n_res_blocks):
            b = self._modules[f'ResidualBlock{i + 1}_branch1'](b)
        x1 = x1 + self._modules[self.out1](b)
        x2 = c = self._modules[self.stem2](x_ref)
        for i in range(self.n_res_blocks):
            c = self._modules[f'ResidualBlock{i + 1}_branch2'](c)
        route = self._route(tuple(c.shape[1:3]))
        if route != self.route:
            raise ValueError(f'discriminator built for the HR grid '
                             f'{tuple(s * self.scale for s in self.lr_size)}'
                             f' ({self.route!r}); a {tuple(c.shape[1:3])} '
                             f'grid routes {route!r}')
        if route in ('same', 'valid'):
            x2 = self._modules[self.down[1]](self._modules[self.down[0]](c))
            if route == 'valid':
                x2 = x2[:, :-1, :-1, :]   # Cropping2D ((0, 1), (0, 1))
        elif route == 'resize':
            x2 = resize2d(c, self.lr_size, 'bilinear').to(c.dtype)
        else:
            x2 = x2 + self._modules[self.down[0]](c)
        dt = torch.promote_types(x1.dtype, x2.dtype)
        x = self.ResidualBlock_0(torch.cat([x1.to(dt), x2.to(dt)], dim=-1))
        x = _mean(x, (1, 2))
        if bt is not None:
            # the mean over the merged rows, then over T, in JAX's order
            x = _mean(x.reshape(*bt, x.shape[-1]), 1)
        x = _Logistic.apply(self.Dense_0(self.Dropout_0(x)))
        return _Logistic.apply(self.Dense_1(x))
