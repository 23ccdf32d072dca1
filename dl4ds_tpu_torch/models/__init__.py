"""
Model factories with the JAX package's signatures
(`dl4ds_tpu/models/__init__.py`). A factory returns a `DSModel`: the model's
name (with the `_spc/_rc/_dc/_pin` suffix that `predict` reads), its input
specs and how to build it. `DSModel.init(seed, device)` builds the
`nn.Module` with seeded weights, as the Flax `init` builds the variables.
"""

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from .. import POSTUPSAMPLING_METHODS
from ..utils import (checkarg_backbone, checkarg_upsampling,
                     checkarg_dropout_variant, check_compatibility_upsbackb,
                     not_ported, resolve_device)
from .nets import NetPostupsampling, RecNetPostupsampling
from . import blocks

__all__ = ['DSModel', 'net_postupsampling', 'recnet_postupsampling',
           'build_model', 'blocks']


@dataclasses.dataclass
class DSModel:
    """A configured model: how to build it, its name and input specs.

    `name` follows the reference convention '<backbone>_<upsampling>'
    (e.g. 'resnet_spc', 'recresnet_spc'). Shapes are per sample, NHWC
    (T, H, W, C for a spatio-temporal model), without batch dim.
    """
    build: Callable[[], torch.nn.Module]
    name: str
    input_shape: Tuple[int, ...]
    aux_shape: Optional[Tuple[int, ...]] = None

    @property
    def upsampling(self):
        return self.name.split('_')[-1]

    def init(self, seed, device='cuda'):
        """Build the network with weights drawn from `seed` (on the CPU, so
        a seed gives the same weights on every device), move it to `device`
        in eval mode and return it. device='cpu' must be asked for."""
        device = resolve_device(device)
        net = self.build()
        gen = torch.Generator().manual_seed(int(seed))
        for m in net.modules():
            if hasattr(m, 'reset_parameters'):
                m.reset_parameters(gen)
        net = net.to(device=device)
        # channels-last kernels match the NHWC activations the convs see;
        # only the Conv weights (OIHW) are re-strided: the ConvLSTM kernels
        # are HWIO arrays that K2 reads contiguously
        for m in net.modules():
            if isinstance(m, blocks.Conv):
                m.weight.data = m.weight.data.contiguous(
                    memory_format=torch.channels_last)
        return net.eval()

    @staticmethod
    def param_count(net):
        return sum(p.numel() for p in net.parameters())


def net_postupsampling(backbone_block, upsampling, scale, n_channels,
                       n_aux_channels, lr_size, n_channels_out=1, n_filters=8,
                       n_blocks=6, normalization=None, dropout_rate=0,
                       dropout_variant=None, attention=False,
                       activation='relu', output_activation=None,
                       rc_interpolation='bilinear', localcon_layer=False,
                       output_attention=True, remat=False,
                       dtype=torch.float32):
    """Spatial network + post-upsampling head
    (dl4ds_tpu/models/__init__.py:77-104), with the JAX signature. This
    slice builds the 'resnet' backbone with the 'spc' head in float32;
    `rc_interpolation` is read by the 'rc' head alone (not ported yet), as
    in `recnet_postupsampling`. The rest, `remat=True` (activation
    checkpointing) included, raises NotImplementedError naming its ROADMAP
    item."""
    backbone_block = checkarg_backbone(backbone_block)
    upsampling = checkarg_upsampling(upsampling)
    dropout_variant = checkarg_dropout_variant(dropout_variant)
    if dtype != torch.float32:
        raise not_ported(f'model dtype {dtype}', 5)
    if remat:
        raise not_ported('remat=True (activation checkpointing)', 4)
    h_lr, w_lr = lr_size
    build = functools.partial(
        NetPostupsampling, n_channels, n_aux_channels, backbone_block,
        upsampling, scale, n_channels_out=n_channels_out,
        n_filters=n_filters, n_blocks=n_blocks, normalization=normalization,
        dropout_rate=dropout_rate, dropout_variant=dropout_variant,
        attention=attention, activation=activation,
        output_activation=output_activation, localcon_layer=localcon_layer,
        output_attention=output_attention)
    build()   # raise now, not at init, on a configuration not ported yet
    aux_shape = ((int(h_lr * scale), int(w_lr * scale), n_aux_channels)
                 if n_aux_channels > 0 else None)
    return DSModel(build, f'{backbone_block}_{upsampling}',
                   (h_lr, w_lr, n_channels), aux_shape)


def recnet_postupsampling(backbone_block, upsampling, scale, n_channels,
                          n_aux_channels, lr_size, time_window,
                          n_channels_out=1, n_filters=8, n_blocks=4,
                          dropout_rate=0, dropout_variant=None,
                          normalization=None, attention=False,
                          activation='relu', output_activation=None,
                          rc_interpolation='bilinear', localcon_layer=False,
                          output_attention=True, dtype=torch.float32):
    """Spatio-temporal (ConvLSTM) network + post-upsampling head
    (dl4ds_tpu/models/__init__.py:157-183), named 'rec<backbone>_<ups>'.
    This slice builds the 'resnet' backbone with the 'spc' head in float32;
    the rest raises NotImplementedError naming its ROADMAP item."""
    backbone_block = checkarg_backbone(backbone_block)
    upsampling = checkarg_upsampling(upsampling)
    dropout_variant = checkarg_dropout_variant(dropout_variant)
    if dtype != torch.float32:
        raise not_ported(f'model dtype {dtype}', 5)
    h_lr, w_lr = lr_size
    build = functools.partial(
        RecNetPostupsampling, n_channels, n_aux_channels, backbone_block,
        upsampling, scale, time_window, n_channels_out=n_channels_out,
        n_filters=n_filters, n_blocks=n_blocks, normalization=normalization,
        dropout_rate=dropout_rate, dropout_variant=dropout_variant,
        attention=attention, activation=activation,
        output_activation=output_activation, localcon_layer=localcon_layer,
        output_attention=output_attention)
    build()   # raise now, not at init, on a configuration not ported yet
    aux_shape = ((int(h_lr * scale), int(w_lr * scale), n_aux_channels)
                 if n_aux_channels > 0 else None)
    return DSModel(build, f'rec{backbone_block}_{upsampling}',
                   (time_window, h_lr, w_lr, n_channels), aux_shape)


def build_model(backbone, upsampling, scale, n_channels, n_aux_channels,
                lr_size, hr_size, time_window=None, **params):
    """Single dispatcher over the model factories, as the JAX package's
    (dl4ds_tpu/models/__init__.py:309-342): a time window above 1 builds the
    spatio-temporal model. The post-upsampling factories are ported; 'pin'
    raises."""
    spatiotemporal = time_window is not None and time_window > 1
    check_compatibility_upsbackb(backbone, upsampling,
                                 time_window if spatiotemporal else None)
    if upsampling in POSTUPSAMPLING_METHODS:
        if spatiotemporal:
            return recnet_postupsampling(
                backbone_block=backbone, upsampling=upsampling, scale=scale,
                n_channels=n_channels, n_aux_channels=n_aux_channels,
                lr_size=lr_size, time_window=time_window, **params)
        return net_postupsampling(
            backbone_block=backbone, upsampling=upsampling, scale=scale,
            n_channels=n_channels, n_aux_channels=n_aux_channels,
            lr_size=lr_size, **params)
    raise not_ported(f'upsampling {upsampling!r} (recnet_pin, unet_pin, '
                     f'net_pin)', 6)
