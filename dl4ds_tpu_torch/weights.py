"""Carry a Flax variable tree across into the port's modules, and back.

The torch modules carry the Flax tree's names (explicit ones such as `stem`,
`ResidualBlock1`, `Transition1`, `EncoderBlock1`, `conv2x`, `deconv_2of3`,
`input_conv`, the discriminator's `ResidualBlock1_branch1`, and Flax's
auto-names such as `Conv_0`, `ChannelAttention2D_0`, `_Norm_0`, `Dense_0`,
`ResizeConvolutionBlock_0`, `ConvLSTM2D_0`, `RecurrentConvBlock_0`), so the
tree and the module hierarchy are walked together. A leaf of the `params`
collection is a parameter of the module at its path under the same name
(a gate's w1/b1/w2/b2, a ConvLSTM's or transposed conv's HWIO `kernel`, a
`Dense` kernel [in, out], a norm's `scale` and `bias`, `gamma`,
`local_kernel`, `local_bias`), except a `Conv`'s, whose HWIO `kernel` is
held OIHW here; a leaf of the `batch_stats` collection (a batch norm's
`mean` and `var`) is a buffer. The trees are nested dicts of numpy arrays
(`jax.tree_util.tree_map(np.asarray, variables['params'])`): the port never
sees a JAX type.
"""

import numpy as np
import torch
from torch.func import stack_module_state

from .models.blocks import Conv
from .utils import resolve_device

__all__ = ['load_jax_params', 'export_jax_params', 'export_jax_variables',
           'load_jax_ensemble', 'export_jax_ensemble', 'load_jax_named',
           'export_jax_named']


def _copy(tensor, value, path, done):
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(tensor.shape):
        raise ValueError(f'{path}: Flax shape {tuple(value.shape)} does not '
                         f'match torch shape {tuple(tensor.shape)}')
    tensor.copy_(value)
    done.add(id(tensor))


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


def _walk(module, tree, path, done, buffers):
    """Copy `tree` into `module`: its leaves into the parameters (or, with
    `buffers`, the buffers) of the same name, its subtrees into the
    submodules."""
    for key, sub in tree.items():
        sub_path = f'{path}/{key}'
        if not isinstance(sub, dict):
            store = module._buffers if buffers else module._parameters
            if store.get(key) is None:
                raise KeyError(f'{sub_path}: Flax leaf has no torch '
                               f'counterpart in {type(module).__name__}')
            _copy(store[key], sub, sub_path, done)
            continue
        child = module._modules.get(key)
        if child is None:
            raise KeyError(f'{sub_path}: Flax entry has no torch counterpart '
                           f'in {type(module).__name__}')
        if isinstance(child, Conv) and not buffers:
            _load_conv(child, sub, sub_path, done)
        else:
            _walk(child, sub, sub_path, done, buffers)


def load_jax_params(net, params, batch_stats=None):
    """Copy the Flax `params` tree (nested dict of numpy arrays) into `net`,
    and the `batch_stats` tree (the running statistics of its batch norms)
    into its buffers, in place, and return `net`. Raises on any Flax leaf
    without a torch counterpart, on any shape mismatch, and on any torch
    parameter or buffer left unset (a model with batch norm needs
    `batch_stats`). A tied module (the spc head's `conv2x`, the x8 dc
    head's `deconv_2of3`) has one entry and is copied once."""
    done = set()
    with torch.no_grad():
        _walk(net, params, '', done, False)
        if batch_stats is not None:
            _walk(net, batch_stats, '', done, True)
    unset = [name for name, t in list(net.named_parameters())
             + list(net.named_buffers()) if id(t) not in done]
    if unset:
        raise KeyError(f'torch parameters and buffers without a Flax leaf '
                       f'(params, batch_stats): {unset}')
    return net


def _export(module, buffers):
    def leaf(t):
        return np.ascontiguousarray(t.detach().cpu().float().numpy())
    if isinstance(module, Conv) and not buffers:
        tree = {'kernel': leaf(module.weight.permute(2, 3, 1, 0))}
        if module.bias is not None:
            tree['bias'] = leaf(module.bias)
        return tree
    store = module._buffers if buffers else module._parameters
    tree = {name: leaf(t) for name, t in store.items() if t is not None}
    for key, child in module._modules.items():
        if child is not None:
            sub = _export(child, buffers)
            if sub:
                tree[key] = sub
    return tree


def export_jax_params(net):
    """The Flax `params` tree of `net`, the inverse of `load_jax_params`:
    nested dicts of float32 numpy arrays under the Flax names, conv kernels
    HWIO. A tied module is one entry, as in the Flax tree; modules without
    parameters have none."""
    return _export(net, False)


def export_jax_variables(net):
    """The Flax variables of `net`: {'params': ...} and, for a model with
    batch norm, its running statistics under 'batch_stats', as
    `model.init` gives them in the JAX package."""
    variables = {'params': export_jax_params(net)}
    stats = _export(net, True)
    if stats:
        variables['batch_stats'] = stats
    return variables


def _params_tree(tree):
    """The Flax `params` tree of a variables dict {'params': ...}, or the
    tree itself."""
    return tree['params'] if isinstance(tree.get('params'), dict) else tree


def load_jax_named(model, params, device='cuda'):
    """The parameters of a network of `model` by `named_parameters()` name
    (fresh tensors on `device`: the card unless device='cpu' is asked
    for, as every entry point of the port), from the JAX package's Flax `params` tree
    (or its variables {'params': ...}): the whole weights that
    `parallel.place_params` cuts into a rank's shards and a pipeline's
    `split_params` stacks, so that both packages start from one tree."""
    net = load_jax_params(model.init(0, device=resolve_device(device)),
                          _params_tree(params))
    return {k: v.detach().clone() for k, v in net.named_parameters()}


def export_jax_named(model, named):
    """The Flax `params` tree of whole tensors by name (`load_jax_named`'s
    inverse; `parallel.gather_params` and a pipeline's `merge_params` give
    them)."""
    net = model.init(0, device='cpu')
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(named[k])
    return export_jax_params(net)


def _map_leaves(fn, tree):
    return {k: (_map_leaves(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def load_jax_ensemble(model, stacked_params, device):
    """The port's stacked ensemble (a dict from parameter name to [M, ...]
    tensor on `device`, `parallel.init_ensemble`'s form) from the JAX
    package's stacked Flax tree, a leading member axis on every leaf
    (`init_ensemble`'s variables {'params': ...}, or their `params`
    tree): `load_jax_params` member by member into networks of `model`,
    then `torch.func.stack_module_state`."""
    tree = _params_tree(stacked_params)
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    nets = [load_jax_params(model.init(0, device=device),
                            _map_leaves(lambda v: np.asarray(v)[i], tree))
            for i in range(np.shape(first)[0])]
    params, _ = stack_module_state(nets)
    return {name: p.detach().contiguous() for name, p in params.items()}


def export_jax_ensemble(model, stacked):
    """The JAX package's stacked Flax `params` tree of the port's stacked
    ensemble, the inverse of `load_jax_ensemble`: `export_jax_params` of a
    network of `model` holding each member's parameters in turn, the
    members' leaves stacked on a leading axis."""
    net = model.init(0, device='cpu')
    named = dict(net.named_parameters())
    members = []
    with torch.no_grad():
        for i in range(len(next(iter(stacked.values())))):
            for name, t in stacked.items():
                named[name].copy_(t[i])
            # the exported leaves share the CPU parameters' memory
            members.append(_map_leaves(np.array, export_jax_params(net)))

    def stack(trees):
        return {k: (stack([t[k] for t in trees]) if isinstance(v, dict)
                    else np.stack([t[k] for t in trees]))
                for k, v in trees[0].items()}
    return stack(members)
