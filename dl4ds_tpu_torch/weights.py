"""Carry a Flax parameter tree across into the port's modules, and back.

The torch modules carry the Flax tree's names (explicit ones such as `stem`,
`ResidualBlock1`, `Transition1`, `EncoderBlock1`, `conv2x`, `deconv_2of3`,
`input_conv`, and Flax's auto-names such as `Conv_0`, `ChannelAttention2D_0`,
`ResizeConvolutionBlock_0`, `ConvLSTM2D_0`), so the tree and the module
hierarchy are walked together. The tree is a nested dict of numpy arrays
(`jax.tree_util.tree_map(np.asarray, variables['params'])`): the port never
sees a JAX type.
"""

import numpy as np
import torch

from .models.blocks import Conv, ConvTranspose, ChannelAttention2D, _Kernel

# modules whose parameters carry the Flax leaf names and layout: the gate's
# w1/b1/w2/b2, a ConvLSTM kernel's HWIO kernel/bias, a transposed conv's
# HWIO kernel
_SAME_LAYOUT = (ChannelAttention2D, _Kernel, ConvTranspose)

__all__ = ['load_jax_params', 'export_jax_params']


def _copy(param, value, path, done):
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f'{path}: Flax shape {tuple(value.shape)} does not '
                         f'match torch shape {tuple(param.shape)}')
    param.copy_(value)
    done.add(id(param))


def _load_conv(conv, leaves, path, done):
    expected = {'kernel'} | ({'bias'} if conv.bias is not None else set())
    if set(leaves) != expected:
        raise KeyError(f'{path}: Flax leaves {sorted(leaves)}, expected '
                       f'{sorted(expected)}')
    # Flax kernels are HWIO, torch's OIHW
    kernel = np.asarray(leaves['kernel']).transpose(3, 2, 0, 1)
    _copy(conv.weight, kernel, f'{path}/kernel', done)
    if conv.bias is not None:
        _copy(conv.bias, leaves['bias'], f'{path}/bias', done)


def _load_same_layout(module, leaves, path, done):
    """Copy leaves into a module of `_SAME_LAYOUT`."""
    params = dict(module.named_parameters(recurse=False))
    if set(leaves) != set(params):
        raise KeyError(f'{path}: Flax leaves {sorted(leaves)}, expected '
                       f'{sorted(params)}')
    for name, param in params.items():
        _copy(param, leaves[name], f'{path}/{name}', done)


def _walk(module, tree, path, done):
    for key, sub in tree.items():
        sub_path = f'{path}/{key}'
        child = module._modules.get(key)
        if child is None or not isinstance(sub, dict):
            raise KeyError(f'{sub_path}: Flax entry has no torch counterpart '
                           f'in {type(module).__name__}')
        if isinstance(child, Conv):
            _load_conv(child, sub, sub_path, done)
        elif isinstance(child, _SAME_LAYOUT):
            _load_same_layout(child, sub, sub_path, done)
        else:
            _walk(child, sub, sub_path, done)


def load_jax_params(net, params):
    """Copy the Flax `params` tree (nested dict of numpy arrays) into `net`,
    in place, and return `net`. Raises on any Flax leaf without a torch
    parameter, on any shape mismatch, and on any torch parameter left unset.
    A tied module (the spc head's `conv2x`, the x8 dc head's `deconv_2of3`)
    has one entry and is copied once."""
    done = set()
    with torch.no_grad():
        _walk(net, params, '', done)
    unset = [name for name, p in net.named_parameters() if id(p) not in done]
    if unset:
        raise KeyError(f'torch parameters without a Flax leaf: {unset}')
    return net


def export_jax_params(net):
    """The Flax `params` tree of `net`, the inverse of `load_jax_params`:
    nested dicts of float32 numpy arrays under the Flax names, conv kernels
    HWIO. A tied module is one entry, as in the Flax tree; modules without
    parameters have none."""
    def leaf(t):
        return np.ascontiguousarray(t.detach().cpu().float().numpy())

    def walk(module):
        tree = {}
        for key, child in module._modules.items():
            if child is None:
                continue
            if isinstance(child, Conv):
                sub = {'kernel': leaf(child.weight.permute(2, 3, 1, 0))}
                if child.bias is not None:
                    sub['bias'] = leaf(child.bias)
            elif isinstance(child, _SAME_LAYOUT):
                sub = {name: leaf(p) for name, p
                       in child.named_parameters(recurse=False)}
            else:
                sub = walk(child)
            if sub:
                tree[key] = sub
        return tree
    return walk(net)
