"""
Model factories with the JAX package's signatures
(`dl4ds_tpu/models/__init__.py`). A factory returns a `DSModel`: the model's
name (with the `_spc/_rc/_dc/_pin` suffix that `predict` reads), its input
specs and how to build it. `DSModel.init(seed, device)` builds the
`nn.Module` with seeded weights, as the Flax `init` builds the variables.
"""

import dataclasses
import functools
import json
import os
import pickle
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import POSTUPSAMPLING_METHODS
from ..utils import (checkarg_backbone, checkarg_upsampling,
                     checkarg_dropout_variant, check_compatibility_upsbackb,
                     resolve_device)
from .nets import (NetPostupsampling, NetPIN, UnetPIN, RecNetPostupsampling,
                   RecNetPIN, ResidualDiscriminator, _check_nblocks)
from .blocks import check_dtype
from . import blocks

__all__ = ['DSModel', 'net_postupsampling', 'net_pin', 'unet_pin',
           'recnet_postupsampling', 'recnet_pin', 'residual_discriminator',
           'build_model',
           'save_model', 'load_model', 'blocks']


@dataclasses.dataclass
class DSModel:
    """A configured model: how to build it, its name and input specs.

    `name` follows the reference convention '<backbone>_<upsampling>'
    (e.g. 'resnet_spc', 'recresnet_spc', 'unet_pin'). Shapes are per
    sample, NHWC (T, H, W, C for a spatio-temporal model; the HR grid for
    a 'pin' model), without batch dim.
    `module_class` and `config` name the JAX package's Flax module and its
    fields, which `save_model` writes; `dtype` is the compute dtype
    (float32 or bfloat16; the parameters are float32 either way).
    """
    build: Callable[[], torch.nn.Module]
    name: str
    input_shape: Tuple[int, ...]
    aux_shape: Optional[Tuple[int, ...]] = None
    module_class: Optional[str] = None
    config: Optional[dict] = None
    dtype: torch.dtype = torch.float32

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

    def summary(self, net=None):
        """The JAX `DSModel.summary` (dl4ds_tpu/models/__init__.py:69-74):
        the name, the input and aux shapes, and with a network its
        parameter count."""
        lines = [f'Model: {self.name}',
                 f'  input: {self.input_shape}  aux: {self.aux_shape}']
        if net is not None:
            lines.append(f'  parameters: {self.param_count(net):,}')
        return '\n'.join(lines)


def net_postupsampling(backbone_block, upsampling, scale, n_channels,
                       n_aux_channels, lr_size, n_channels_out=1, n_filters=8,
                       n_blocks=6, normalization=None, dropout_rate=0,
                       dropout_variant=None, attention=False,
                       activation='relu', output_activation=None,
                       rc_interpolation='bilinear', localcon_layer=False,
                       output_attention=True, remat=False,
                       dtype=torch.float32):
    """Spatial network + post-upsampling head
    (dl4ds_tpu/models/__init__.py:77-104), with the JAX signature: the
    'convnet', 'resnet', 'densenet' or 'convnext' backbone with the 'spc',
    'rc' or 'dc' head, 'bn' or 'ln' normalization, any dropout variant, the
    localized output layer on the HR grid lr_size * scale, computing in
    `dtype` float32 or bfloat16 with float32 parameters;
    `rc_interpolation` is read by the 'rc' head alone. `remat=True`
    recomputes each backbone block's activations in the backward pass
    (`torch.utils.checkpoint`), as `nn.remat` wraps the blocks in the JAX
    package. Other dtypes raise NotImplementedError naming their ROADMAP
    item."""
    backbone_block = checkarg_backbone(backbone_block)
    upsampling = checkarg_upsampling(upsampling)
    dropout_variant = checkarg_dropout_variant(dropout_variant)
    check_dtype(dtype)
    h_lr, w_lr = lr_size
    config = dict(
        backbone=backbone_block, upsampling=upsampling, scale=scale,
        n_channels_out=n_channels_out, n_filters=n_filters,
        n_blocks=n_blocks, normalization=normalization,
        dropout_rate=dropout_rate, dropout_variant=dropout_variant,
        attention=attention, activation=activation,
        output_activation=output_activation,
        rc_interpolation=rc_interpolation, localcon_layer=localcon_layer,
        output_attention=output_attention, remat=remat)
    build = functools.partial(
        NetPostupsampling, n_channels, n_aux_channels, backbone_block,
        upsampling, scale, n_channels_out=n_channels_out,
        n_filters=n_filters, n_blocks=n_blocks, normalization=normalization,
        dropout_rate=dropout_rate, dropout_variant=dropout_variant,
        attention=attention, activation=activation,
        output_activation=output_activation,
        rc_interpolation=rc_interpolation, localcon_layer=localcon_layer,
        output_attention=output_attention, remat=remat,
        hr_size=(int(h_lr * scale), int(w_lr * scale)), dtype=dtype)
    build()   # raise now, not at init, on a configuration not ported yet
    aux_shape = ((int(h_lr * scale), int(w_lr * scale), n_aux_channels)
                 if n_aux_channels > 0 else None)
    return DSModel(build, f'{backbone_block}_{upsampling}',
                   (h_lr, w_lr, n_channels), aux_shape,
                   'NetPostupsampling', config, dtype)


def net_pin(backbone_block, n_channels, n_aux_channels, hr_size,
            n_channels_out=1, n_filters=8, n_blocks=6, dropout_rate=0,
            dropout_variant=None, normalization=None, attention=False,
            activation='relu', output_activation=None, localcon_layer=False,
            output_attention=True, remat=False, dtype=torch.float32):
    """Spatial pre-upsampled network (dl4ds_tpu/models/__init__.py:
    107-125), with the JAX signature: the 'convnet', 'resnet', 'densenet'
    or 'convnext' backbone on the input interpolated to the HR grid
    `hr_size`, named '<backbone>_pin'."""
    backbone_block = checkarg_backbone(backbone_block)
    dropout_variant = checkarg_dropout_variant(dropout_variant)
    check_dtype(dtype)
    h_hr, w_hr = hr_size
    config = dict(
        backbone=backbone_block, n_channels_out=n_channels_out,
        n_filters=n_filters, n_blocks=n_blocks, dropout_rate=dropout_rate,
        dropout_variant=dropout_variant, normalization=normalization,
        attention=attention, activation=activation,
        output_activation=output_activation, localcon_layer=localcon_layer,
        output_attention=output_attention, remat=remat)
    build = functools.partial(NetPIN, n_channels, n_aux_channels,
                              hr_size=(h_hr, w_hr), dtype=dtype, **config)
    build()   # raise now, not at init, on a configuration not ported yet
    aux_shape = (h_hr, w_hr, n_aux_channels) if n_aux_channels > 0 else None
    return DSModel(build, f'{backbone_block}_pin', (h_hr, w_hr, n_channels),
                   aux_shape, 'NetPIN', config, dtype)


def unet_pin(backbone_block, n_channels, n_aux_channels, hr_size,
             n_filters=8, n_blocks=6, n_channels_out=1, activation='relu',
             dropout_rate=0, dropout_variant=None, normalization=None,
             attention=False, decoder_upsampling='rc',
             rc_interpolation='bilinear', output_activation=None,
             width_cap=256, localcon_layer=False, output_attention=True,
             dtype=torch.float32):
    """U-Net pre-upsampled network (dl4ds_tpu/models/__init__.py:128-154),
    with the JAX signature. Its depth is fixed here from `hr_size`
    (`_check_nblocks`: fewer levels, with a RuntimeWarning, where the grid
    would fall below 2 pixels at the bottleneck), so that a patch-trained
    model keeps its parameters on a full grid."""
    backbone_block = checkarg_backbone(backbone_block)
    dropout_variant = checkarg_dropout_variant(dropout_variant)
    check_dtype(dtype)
    h_hr, w_hr = hr_size
    n_blocks = _check_nblocks((h_hr, w_hr), n_blocks)
    config = dict(
        backbone=backbone_block, n_channels_out=n_channels_out,
        n_filters=n_filters, n_blocks=n_blocks, activation=activation,
        dropout_rate=dropout_rate, dropout_variant=dropout_variant,
        normalization=normalization, attention=attention,
        decoder_upsampling=decoder_upsampling,
        rc_interpolation=rc_interpolation,
        output_activation=output_activation, width_cap=width_cap,
        localcon_layer=localcon_layer, output_attention=output_attention)
    build = functools.partial(UnetPIN, n_channels, n_aux_channels,
                              hr_size=(h_hr, w_hr), dtype=dtype, **config)
    build()   # raise now, not at init, on a configuration not ported yet
    aux_shape = (h_hr, w_hr, n_aux_channels) if n_aux_channels > 0 else None
    return DSModel(build, f'{backbone_block}_pin', (h_hr, w_hr, n_channels),
                   aux_shape, 'UnetPIN', config, dtype)


def recnet_postupsampling(backbone_block, upsampling, scale, n_channels,
                          n_aux_channels, lr_size, time_window,
                          n_channels_out=1, n_filters=8, n_blocks=4,
                          dropout_rate=0, dropout_variant=None,
                          normalization=None, attention=False,
                          activation='relu', output_activation=None,
                          rc_interpolation='bilinear', localcon_layer=False,
                          output_attention=True, dtype=torch.float32):
    """Spatio-temporal (ConvLSTM) network + post-upsampling head
    (dl4ds_tpu/models/__init__.py:157-183), named 'rec<backbone>_<ups>':
    the 'convnet', 'resnet' or 'densenet' merge with the 'spc', 'rc' or
    'dc' head, 'bn' or 'ln' normalization, any dropout variant and the
    localized layer, in `dtype` float32 or bfloat16 (float32 parameters);
    other dtypes raise NotImplementedError naming their ROADMAP item."""
    backbone_block = checkarg_backbone(backbone_block)
    upsampling = checkarg_upsampling(upsampling)
    dropout_variant = checkarg_dropout_variant(dropout_variant)
    check_dtype(dtype)
    h_lr, w_lr = lr_size
    config = dict(
        backbone=backbone_block, upsampling=upsampling, scale=scale,
        time_window=time_window, n_channels_out=n_channels_out,
        n_filters=n_filters, n_blocks=n_blocks, dropout_rate=dropout_rate,
        dropout_variant=dropout_variant, normalization=normalization,
        attention=attention, activation=activation,
        output_activation=output_activation,
        rc_interpolation=rc_interpolation, localcon_layer=localcon_layer,
        output_attention=output_attention)
    build = functools.partial(
        RecNetPostupsampling, n_channels, n_aux_channels, backbone_block,
        upsampling, scale, time_window, n_channels_out=n_channels_out,
        n_filters=n_filters, n_blocks=n_blocks, normalization=normalization,
        dropout_rate=dropout_rate, dropout_variant=dropout_variant,
        attention=attention, activation=activation,
        output_activation=output_activation,
        rc_interpolation=rc_interpolation, localcon_layer=localcon_layer,
        output_attention=output_attention,
        hr_size=(int(h_lr * scale), int(w_lr * scale)), dtype=dtype)
    build()   # raise now, not at init, on a configuration not ported yet
    aux_shape = ((int(h_lr * scale), int(w_lr * scale), n_aux_channels)
                 if n_aux_channels > 0 else None)
    return DSModel(build, f'rec{backbone_block}_{upsampling}',
                   (time_window, h_lr, w_lr, n_channels), aux_shape,
                   'RecNetPostupsampling', config, dtype)


def recnet_pin(backbone_block, n_channels, n_aux_channels, hr_size,
               time_window, n_channels_out=1, n_filters=8, n_blocks=6,
               normalization=None, dropout_rate=0, dropout_variant=None,
               attention=False, activation='relu', output_activation=None,
               localcon_layer=False, output_attention=True,
               dtype=torch.float32):
    """Spatio-temporal pre-upsampled network (dl4ds_tpu/models/__init__.py:
    186-207), with the JAX signature: the 'convnet', 'resnet' or
    'densenet' recurrent backbone on `time_window` frames interpolated to
    the HR grid `hr_size`, named 'rec<backbone>_pin'."""
    backbone_block = checkarg_backbone(backbone_block)
    dropout_variant = checkarg_dropout_variant(dropout_variant)
    check_dtype(dtype)
    h_hr, w_hr = hr_size
    config = dict(
        backbone=backbone_block, time_window=time_window,
        n_channels_out=n_channels_out, n_filters=n_filters,
        n_blocks=n_blocks, normalization=normalization,
        dropout_rate=dropout_rate, dropout_variant=dropout_variant,
        attention=attention, activation=activation,
        output_activation=output_activation, localcon_layer=localcon_layer,
        output_attention=output_attention)
    build = functools.partial(RecNetPIN, n_channels, n_aux_channels,
                              hr_size=(h_hr, w_hr), dtype=dtype, **config)
    build()   # raise now, not at init, on a configuration not ported yet
    aux_shape = (h_hr, w_hr, n_aux_channels) if n_aux_channels > 0 else None
    return DSModel(build, f'rec{backbone_block}_pin',
                   (time_window, h_hr, w_hr, n_channels), aux_shape,
                   'RecNetPIN', config, dtype)


def build_model(backbone, upsampling, scale, n_channels, n_aux_channels,
                lr_size, hr_size, time_window=None, **params):
    """Single dispatcher over the model factories, as the JAX package's
    (dl4ds_tpu/models/__init__.py:309-342): a time window above 1 builds the
    spatio-temporal model, 'pin' the pre-upsampled one (`recnet_pin` with
    a time window, `unet_pin` for the 'unet' backbone, else `net_pin`) on
    `hr_size`."""
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
    if upsampling != 'pin':
        raise ValueError(f'unrecognized upsampling: {upsampling}')
    if spatiotemporal:
        return recnet_pin(backbone_block=backbone, n_channels=n_channels,
                          n_aux_channels=n_aux_channels, hr_size=hr_size,
                          time_window=time_window, **params)
    factory = unet_pin if backbone == 'unet' else net_pin
    return factory(backbone_block=backbone, n_channels=n_channels,
                   n_aux_channels=n_aux_channels, hr_size=hr_size, **params)


def residual_discriminator(n_channels, upsampling, is_spatiotemporal, scale,
                           lr_size, n_filters=8, n_res_blocks=4,
                           normalization=None, activation='relu',
                           attention=False, time_window=None,
                           dtype=torch.float32):
    """Two-branch conditional discriminator of CGAN training
    (dl4ds_tpu/models/__init__.py:210-237), named 'discriminator'. Its
    input is the generator's input, LR-sized for the post-upsampling heads
    and HR-sized for 'pin' (T frames of it when spatio-temporal); its
    second input, `aux_shape` here as in the JAX `DSModel`, is the HR
    reference or candidate [(T,) H, W, 1]."""
    check_dtype(dtype)
    config = dict(n_channels=n_channels, upsampling=upsampling,
                  is_spatiotemporal=is_spatiotemporal, scale=scale,
                  lr_size=tuple(lr_size), n_filters=n_filters,
                  n_res_blocks=n_res_blocks, normalization=normalization,
                  activation=activation, attention=attention)
    build = functools.partial(ResidualDiscriminator, dtype=dtype, **config)
    build()   # raise now, not at init, on a configuration not ported yet
    h_lr, w_lr = lr_size
    h_in, w_in = ((h_lr, w_lr) if upsampling in POSTUPSAMPLING_METHODS
                  else (h_lr * scale, w_lr * scale))
    frames = (time_window or 1,) if is_spatiotemporal else ()
    return DSModel(build, 'discriminator', frames + (h_in, w_in, n_channels),
                   frames + (h_lr * scale, w_lr * scale, 1),
                   'ResidualDiscriminator', config, dtype)


_FACTORIES = {'NetPostupsampling': net_postupsampling,
              'NetPIN': net_pin, 'UnetPIN': unet_pin,
              'RecNetPostupsampling': recnet_postupsampling,
              'RecNetPIN': recnet_pin,
              'ResidualDiscriminator': residual_discriminator}


def save_model(model, net, path):
    """Persist a model as the JAX package's `save_model` does
    (dl4ds_tpu/models/__init__.py:245-282): `model_config.json`, the Flax
    module's class and fields with the input specs, and `variables.pkl`,
    the pickled {'params': Flax-named tree of numpy arrays} (with
    'batch_stats', the running statistics, for a model with batch norm)
    that is the JAX package's own fallback format, so that its
    `load_model` reads the model too. The config's `dtype` is the model
    dtype's name ('float32' or 'bfloat16'), as the JAX package writes
    it. `net` may be a stacked ensemble (`parallel.init_ensemble`'s dict
    of [M, ...] tensors): its tree then carries the leading member axis on
    every leaf, as the JAX package saves its stacked tree."""
    from ..weights import export_jax_ensemble, export_jax_variables
    os.makedirs(path, exist_ok=True)
    meta = {'module_class': model.module_class,
            'config': dict(model.config,
                           dtype=str(model.dtype).replace('torch.', '')),
            'name': model.name, 'input_shape': list(model.input_shape),
            'aux_shape': (list(model.aux_shape)
                          if model.aux_shape is not None else None)}
    with open(os.path.join(path, 'model_config.json'), 'w') as fh:
        json.dump(meta, fh, indent=2)
    variables = ({'params': export_jax_ensemble(model, net)}
                 if isinstance(net, dict) else export_jax_variables(net))
    with open(os.path.join(path, 'variables.pkl'), 'wb') as fh:
        pickle.dump(variables, fh)


def load_model(path, device='cuda'):
    """Rebuild a model saved by `save_model` or by the JAX package's
    `save_model` (dl4ds_tpu/models/__init__.py:285-307), from its orbax
    `variables/` directory (read through tensorstore, `_read_orbax_tree`)
    or its pickle fallback `variables.pkl`, the `batch_stats` collection
    too; returns (DSModel, nn.Module) on `device`. A stacked ensemble's
    tree (each leaf one leading member axis longer than the network's
    parameter) gives (DSModel, stacked), the stacked dict of
    `parallel.init_ensemble` on `device`."""
    from ..weights import export_jax_params, load_jax_ensemble, \
        load_jax_params
    with open(os.path.join(path, 'model_config.json')) as fh:
        meta = json.load(fh)
    factory = _FACTORIES.get(meta['module_class'])
    if factory is None:
        raise ValueError(f"{path}: unknown model class "
                         f"{meta['module_class']!r}")
    cfg = dict(meta['config'])
    name = cfg.pop('dtype', 'float32')
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f'{path}: unknown model dtype {name!r}')
    cfg['dtype'] = check_dtype(dtype)
    *frames, h, w, n_channels = meta['input_shape']
    aux = meta['aux_shape']
    if meta['module_class'] == 'ResidualDiscriminator':
        # the Flax module's fields are the factory's arguments; the time
        # window is the input's first axis
        args = dict(lr_size=tuple(cfg.pop('lr_size')),
                    time_window=frames[0] if frames else None)
    else:
        args = dict(backbone_block=cfg.pop('backbone'),
                    n_channels=n_channels,
                    n_aux_channels=aux[-1] if aux else 0)
        if 'upsampling' in cfg:
            args.update(upsampling=cfg.pop('upsampling'), lr_size=(h, w))
        else:
            # a 'pin' model's input is its HR grid; a U-Net keeps the depth
            # its config holds, which _check_nblocks fixed for that grid
            args.update(hr_size=(h, w))
    model = factory(**args, **cfg)
    var_dir = os.path.abspath(os.path.join(path, 'variables'))
    if os.path.isdir(var_dir):
        variables = _read_orbax_tree(var_dir)
    else:
        with open(os.path.join(path, 'variables.pkl'), 'rb') as fh:
            variables = pickle.load(fh)
    stats = variables.get('batch_stats')
    params = _as_numpy_tree(variables['params'])
    net = model.init(0, device=device)
    if _is_stacked(params, export_jax_params(net)):
        return model, load_jax_ensemble(model, params, device)
    net = load_jax_params(net, params,
                          None if stats is None else _as_numpy_tree(stats))
    return model, net


def _is_stacked(tree, like):
    """Whether the Flax tree's first leaf has one leading axis more than
    the same leaf of `like`, the network's own tree."""
    while isinstance(tree, dict):
        key = next(iter(tree))
        tree, like = tree[key], like.get(key, {})
    return (not isinstance(like, dict)
            and np.ndim(tree) == np.ndim(like) + 1
            and tuple(np.shape(tree)[1:]) == tuple(np.shape(like)))


def _read_orbax_tree(directory, keep=None):
    """The nested dict of numpy arrays that `orbax.checkpoint`'s
    PyTreeCheckpointer saved in `directory`, read with tensorstore alone
    (with `keep`, the top-level subtrees of those names alone).
    `_METADATA` (JSON) lists each leaf's keys under `tree_metadata` and the
    layout: with `use_ocdbt` (orbax's default) every leaf is a zarr array
    in the directory's one OCDBT store under its keys joined by '.', else
    one directory a leaf under that name; `use_zarr3` selects zarr v3."""
    try:
        import tensorstore as ts
    except ImportError as exc:
        raise ImportError(
            f'{directory} is an orbax checkpoint, which is read with the '
            f'`tensorstore` package; install it, or save the model with '
            f'variables.pkl') from exc
    with open(os.path.join(directory, '_METADATA')) as fh:
        meta = json.load(fh)
    zarr = 'zarr3' if meta.get('use_zarr3', False) else 'zarr'
    ocdbt = meta.get('use_ocdbt', True)
    tree = {}
    for leaf in meta['tree_metadata'].values():
        keys = [str(k['key']) for k in leaf['key_metadata']]
        if keep is not None and keys[0] not in keep:
            continue
        kind = leaf.get('value_metadata', {}).get('value_type', 'np.ndarray')
        if kind not in ('np.ndarray', 'jax.Array', 'scalar'):
            raise ValueError(f'{directory}: leaf {keys} holds a {kind!r}, '
                             f'not an array')
        name = '.'.join(keys)
        kvstore = ({'driver': 'ocdbt', 'base': f'file://{directory}',
                    'path': name} if ocdbt else
                   {'driver': 'file',
                    'path': os.path.join(directory, name)})
        value = ts.open({'driver': zarr, 'kvstore': kvstore}).result()
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = np.asarray(value.read().result())
    return tree


def _as_numpy_tree(tree):
    return {k: (_as_numpy_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}
