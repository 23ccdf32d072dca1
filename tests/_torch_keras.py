"""Test helpers of the Keras weight import without TensorFlow.

`keras_weight_list` writes a Flax variables tree out as the reference's
Keras-ordered weight list: each leaf method of the JAX package's
`compat._Consumer` inverted (`KerasWriter`), the block-level order and the
family walkers taken from the JAX package itself, so that the JAX import
of the list gives the tree back exactly when the helper is right.
`build_pair` builds one `tools/compat_matrix.py` case in either package,
with its input arrays."""

import copy
import os
import sys

import numpy as np

from dl4ds_tpu import compat as jax_compat

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'tools')
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)
from compat_matrix import CASES  # noqa: E402

CASES = {label: (family, cfg) for label, family, cfg in CASES}


def _flip_swap(k):
    """dc's transform (compat._Consumer.dc): a spatial flip and an in/out
    swap, its own inverse."""
    return np.transpose(k[::-1, ::-1], (0, 1, 3, 2))


class KerasWriter(jax_compat._Consumer):
    """The inverse of the JAX `_Consumer`: each leaf method appends the
    Keras tensors that the consumer's method would read into the leaves it
    is given, in the consumer's order; `take` (called by the block methods
    for densenet's dead norm1 alone) appends random arrays."""

    def __init__(self, rng):
        super().__init__([])
        self.rng = rng
        self.out = []

    def _put(self, *arrays):
        self.out += [np.array(a, dtype=np.float32) for a in arrays]

    def take(self, n=1):
        self._put(*(self.rng.standard_normal(4) for _ in range(n)))

    def conv(self, dst):
        self._put(dst['kernel'], dst['bias'])

    def conv_nobias(self, dst, transform=None):
        k = np.asarray(dst['kernel'])
        if transform is not None:
            # the one transform the consumer passes is dc's, an involution
            assert np.array_equal(transform(_flip_swap(k)), k)
            k = _flip_swap(k)
        self._put(k)

    def dense(self, dst):
        self._put(dst['kernel'], dst['bias'])

    def depthwise(self, dst):
        self._put(np.transpose(dst['kernel'], (0, 1, 3, 2)), dst['bias'])

    def layernorm(self, dst):
        self._put(dst['scale'], dst['bias'])

    def norm_params(self, dst_norm, kind):
        if kind == 'bn':
            node = dst_norm['BatchNorm_0']
            self._put(node['scale'], node['bias'])
        else:
            self.layernorm(dst_norm['LayerNorm_0'])

    def norm_stats(self, dst_norm, kind):
        if kind == 'bn':
            node = dst_norm['BatchNorm_0']
            self._put(node['mean'], node['var'])

    def attention(self, dst):
        self._put(np.asarray(dst['w1'])[None, None], dst['b1'],
                  np.asarray(dst['w2'])[None, None], dst['b2'])

    def convlstm(self, dst):
        self._put(dst['input_conv']['kernel'],
                  dst['cell']['recurrent_conv']['kernel'],
                  dst['input_conv']['bias'])

    def localized(self, dst):
        self.transition(dst['TransitionBlock_0'])
        # Keras's flat kernel lays the per-pixel weights out (H, W, F, Cin)
        self._put(np.transpose(dst['local_kernel'], (0, 1, 3, 2)).ravel())
        if 'local_bias' in dst:
            self._put(np.asarray(dst['local_bias']).ravel())


def keras_weight_list(module, variables, seed=0):
    """The Keras-ordered weight list of `variables` (a Flax tree of numpy
    arrays, 'params' and maybe 'batch_stats') for the JAX Flax `module`,
    walked by the JAX package's family walkers."""
    p = copy.deepcopy(variables['params'])
    if 'batch_stats' in variables:
        jax_compat._overlay(p, copy.deepcopy(variables['batch_stats']))
    w = KerasWriter(np.random.default_rng(seed))
    kind = type(module).__name__
    if kind in ('NetPostupsampling', 'NetPIN'):
        jax_compat._walk_sp(w, p, module, has_aux='_AuxBranch_0' in p)
    elif kind == 'UnetPIN':
        jax_compat._walk_unet(w, p, module, has_aux='ConvBlock_0' in p)
    else:
        jax_compat._walk_rec(w, p, module, has_aux='ConvBlock_2' in p)
    return w.out


def randomized(tree, seed):
    """`tree` with every leaf drawn anew, so that a misplaced tensor shows:
    normal, a kernel or matrix scaled by 1/sqrt(its fan-in) (its leading
    axes) and a vector by 0.3, so that activations stay of order one; a
    batch norm's `var` positive."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        if isinstance(v, dict):
            return {k: draw(k, u) for k, u in v.items()}
        shape = np.shape(v)
        scale = (1 / np.sqrt(np.prod(shape[:-1])) if len(shape) > 1
                 else 0.3)
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        return np.abs(a) + 0.5 if path == 'var' else a
    return draw(None, tree)


def build_pair(label, pkg, **overrides):
    """One compat-matrix case `label` built by the package `pkg`
    (`dl4ds_tpu` or `dl4ds_tpu_torch`), as tools/compat_matrix.py builds
    it (one input channel, 2 blocks of 6 filters, LR 8x8), with its input
    x and HR aux arrays (None without aux): (DSModel, x, aux)."""
    family, cfg = CASES[label]
    cfg = dict(cfg, **overrides)
    n_ch, n_blocks, n_filters = 1, 2, 6
    lr, scale = 8, cfg.get('scale', 4)
    tw, aux = cfg.get('tw', 3), cfg.get('aux', 0)
    common = dict(n_channels=n_ch, n_aux_channels=aux,
                  normalization=cfg.get('normalization'),
                  attention=cfg.get('attention', False),
                  localcon_layer=cfg.get('localcon', False))
    rng = np.random.default_rng(3)
    if family == 'post':
        m = pkg.net_postupsampling(
            cfg['backbone'], cfg['upsampling'], scale=scale,
            lr_size=(lr, lr), n_filters=n_filters, n_blocks=n_blocks,
            **common)
        shape = (2, lr, lr, n_ch)
    elif family == 'pin':
        hr = lr * scale
        m = pkg.net_pin(cfg['backbone'], hr_size=(hr, hr),
                        n_filters=n_filters, n_blocks=n_blocks,
                        n_channels_out=cfg.get('n_out', 1), **common)
        shape = (2, hr, hr, n_ch)
    elif family == 'rec':
        m = pkg.recnet_postupsampling(
            cfg['backbone'], cfg['upsampling'], scale=scale,
            lr_size=(lr, lr), time_window=tw, n_filters=n_filters,
            n_blocks=n_blocks, **common)
        shape = (2, tw, lr, lr, n_ch)
    elif family == 'recpin':
        hr = lr * scale
        m = pkg.recnet_pin(cfg['backbone'], hr_size=(hr, hr),
                           time_window=tw, n_filters=n_filters, n_blocks=1,
                           n_channels_out=cfg.get('n_out', 1), **common)
        shape = (2, tw, hr, hr, n_ch)
    else:
        hu, wu = 32, 48
        common.pop('normalization')
        m = pkg.unet_pin('unet', hr_size=(hu, wu), n_filters=n_filters,
                         n_blocks=2,
                         decoder_upsampling=cfg['decoder_upsampling'],
                         **common)
        shape = (2, hu, wu, n_ch)
    x = rng.standard_normal(shape).astype('float32')
    s = None
    if aux:
        hw = lr * scale
        s = np.random.default_rng(4).standard_normal(
            (2, hw, hw, aux)).astype('float32')
    return m, x, s
