"""Import trained weights from the TF/Keras reference (carlos-gg/dl4ds):
the port's copy of the JAX package's `compat.py` (dl4ds_tpu/compat.py).

Migration path for users switching from the reference framework: load the
weights of a reference-trained model (a ``tf.keras`` Model object, a TF
SavedModel directory, an ``.npz`` weight dump, or a plain list of arrays in
``model.weights`` order) into the equivalent network of this port, so
inference or fine-tuning continues on the GPU without retraining.

The mapping walks the Keras weight list in the reference's layer-creation
order (reference factories: dl4ds/models/sp_postups.py:14-217,
sp_preups.py:13-315, spt_postups.py:12-163, spt_preups.py:12-144) and
assigns each tensor onto the Flax-shaped variable tree of the network
(`weights.export_jax_variables`: the JAX package's names and layouts),
which mirrors that structure by construction; the tree then goes back into
the network with `weights.load_jax_params`. Every assignment is
shape-checked; the full list must be consumed exactly. The walkers read
the architecture from the `DSModel`'s `module_class` and `config`, which
hold the Flax module's class and field names.

Supported: all backbones (convnet / resnet / densenet / convnext / unet),
all upsampling modes (spc / rc / dc / pin), spatial and spatio-temporal
(ConvLSTM) families, with or without channel attention, HR-aux branch and
the localized convolutional block, and ``normalization`` in (None, 'ln',
'bn') — 'bn' maps Keras BatchNormalization [gamma, beta, moving_mean,
moving_variance] onto the batch norms' parameters and running statistics
(reference layer: dl4ds/models/blocks.py:63-71).

Known reference quirk handled here: the reference's DeconvolutionBlock
applies THREE transposed convs at scale 4 (dl4ds/models/blocks.py:522-534 —
the ``if scale == 4`` branch falls through to the generic ``else``),
producing a 16x upsample that cannot have been trained against 4x targets;
importing a dc/scale-4 model therefore raises with an explanation.

Typical use::

    import dl4ds_tpu_torch as tds
    model = tds.net_postupsampling('resnet', 'spc', scale=4, ...)
    net = model.init(0)
    tds.compat.import_keras_weights(model, net,
                                    '/path/to/reference_weights.npz')
    y = tds.predict((model, net), x_lr, scale=4)
"""

from __future__ import annotations

import copy
import os
import types
from typing import List, Sequence

import numpy as np

from .weights import export_jax_variables, load_jax_params


__all__ = ['import_keras_weights', 'load_weight_list',
           'extract_keras_weights', 'save_weights_npz']


# ---------------------------------------------------------------------------
# weight-list sources
# ---------------------------------------------------------------------------

def extract_keras_weights(tf_model) -> List[np.ndarray]:
    """``tf.keras`` Model -> list of numpy arrays in ``model.weights`` order."""
    return [np.asarray(w) for w in tf_model.weights]


def save_weights_npz(tf_model, path: str) -> None:
    """Dump a Keras model's weights to ``.npz`` (ordered ``w0000..`` keys).

    Run this in the (TF-equipped) environment that holds the reference
    model; the ``.npz`` can then be imported on a TF-less TPU host.
    """
    ws = extract_keras_weights(tf_model)
    np.savez(path, **{f'w{i:04d}': w for i, w in enumerate(ws)})


def load_weight_list(source) -> List[np.ndarray]:
    """Normalize any supported weight source into a list of numpy arrays.

    Accepts a list/tuple of arrays, an ``.npz`` path written by
    :func:`save_weights_npz`, a TF SavedModel / ``.keras`` / ``.h5`` path
    (requires TensorFlow importable), or any object with a ``.weights``
    attribute (a live Keras model).
    """
    if isinstance(source, (list, tuple)):
        return [np.asarray(w) for w in source]
    if hasattr(source, 'weights') and not isinstance(source, str):
        return extract_keras_weights(source)
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if path.endswith('.npz'):
            z = np.load(path)
            return [z[k] for k in sorted(z.files)]
        try:
            import tensorflow as tf  # noqa: PLC0415
        except ImportError as e:
            raise ImportError(
                f'loading {path!r} requires TensorFlow; either install it '
                'or convert the model to .npz with '
                'dl4ds_tpu_torch.compat.save_weights_npz in a TF environment'
            ) from e
        tfm = tf.keras.models.load_model(path, compile=False)
        return extract_keras_weights(tfm)
    raise TypeError(f'unsupported weight source: {type(source)!r}')


# ---------------------------------------------------------------------------
# the consumer: walks the Keras weight list in creation order
# ---------------------------------------------------------------------------

class _Consumer:
    """Sequential reader over the Keras weight list with shape checking."""

    def __init__(self, weights: Sequence[np.ndarray]):
        self.w = list(weights)
        self.i = 0

    def take(self, n=1):
        if self.i + n > len(self.w):
            raise ValueError(
                f'reference weight list exhausted at index {self.i} '
                f'(need {n} more of {len(self.w)}) — model config does not '
                'match the source checkpoint')
        out = self.w[self.i:self.i + n]
        self.i += n
        return out if n > 1 else out[0]

    def done(self):
        if self.i != len(self.w):
            raise ValueError(
                f'consumed {self.i} of {len(self.w)} reference weights — '
                'model config does not match the source checkpoint (extra '
                f'tensors start with shape {self.w[self.i].shape})')

    # --- leaf setters ----------------------------------------------------

    def _set(self, dst, key, val, transform=None):
        if transform is not None:
            val = transform(val)
        if key not in dst:
            raise KeyError(f'Flax tree has no leaf {key!r} here '
                           f'(has {sorted(dst)}); config mismatch')
        if tuple(dst[key].shape) != tuple(val.shape):
            raise ValueError(
                f'shape mismatch for {key!r}: flax {dst[key].shape} vs '
                f'reference {val.shape}')
        dst[key] = np.asarray(val, dtype=np.asarray(dst[key]).dtype)

    def conv(self, dst):
        """Conv2D: kernel (kh,kw,in,out) + bias — identical layouts."""
        k, b = self.take(2)
        self._set(dst, 'kernel', k)
        self._set(dst, 'bias', b)

    def conv_nobias(self, dst, transform=None):
        self._set(dst, 'kernel', self.take(), transform)

    def dense(self, dst):
        k, b = self.take(2)
        self._set(dst, 'kernel', k)
        self._set(dst, 'bias', b)

    def depthwise(self, dst):
        """Keras DepthwiseConv2D kernel (kh,kw,C,1) -> flax grouped-conv
        layout (kh,kw,1,C)."""
        k, b = self.take(2)
        self._set(dst, 'kernel', np.transpose(k, (0, 1, 3, 2)))
        self._set(dst, 'bias', b)

    def layernorm(self, dst):
        """Keras LayerNormalization [gamma, beta] -> flax [scale, bias]."""
        g, b = self.take(2)
        self._set(dst, 'scale', g)
        self._set(dst, 'bias', b)

    def norm_params(self, dst_norm, kind):
        """One _Norm module's TRAINABLE weights. Keras lists each custom
        layer's weights as trainable_weights THEN non_trainable_weights
        (verified on the actual reference models), so a bn block's
        [gamma, beta] pairs appear with the convs/attention while the
        moving statistics of ALL its norms trail at the block end —
        consume those separately with `norm_stats`. `dst_norm` is the
        MERGED _Norm node (import_keras_weights overlays batch_stats onto
        the params tree before walking, splitting back afterwards)."""
        if kind == 'bn':
            g, b = self.take(2)
            node = dst_norm['BatchNorm_0']
            self._set(node, 'scale', g)
            self._set(node, 'bias', b)
        else:
            self.layernorm(dst_norm['LayerNorm_0'])

    def norm_stats(self, dst_norm, kind):
        """One bn _Norm module's [moving_mean, moving_variance] (no-op
        for ln, which has no non-trainable weights)."""
        if kind == 'bn':
            mu, var = self.take(2)
            node = dst_norm['BatchNorm_0']
            self._set(node, 'mean', mu)
            self._set(node, 'var', var)

    def attention(self, dst):
        """ChannelAttention2D: two 1x1 convs stored as matrices w1/w2
        (reference: dl4ds/models/blocks.py:580-584)."""
        k1, b1, k2, b2 = self.take(4)
        self._set(dst, 'w1', k1[0, 0])
        self._set(dst, 'b1', b1)
        self._set(dst, 'w2', k2[0, 0])
        self._set(dst, 'b2', b2)

    def convlstm(self, dst):
        """Keras ConvLSTM2D [kernel, recurrent_kernel, bias] -> the Flax
        hoisted input_conv + cell/recurrent_conv split (gate order i,f,c,o
        matches; models/blocks.py _ConvLSTMCell)."""
        k, rk, b = self.take(3)
        self._set(dst['input_conv'], 'kernel', k)
        self._set(dst['input_conv'], 'bias', b)
        self._set(dst['cell']['recurrent_conv'], 'kernel', rk)

    # --- block-level consumers (reference creation order) ----------------

    def conv_block(self, dst, attention, norm=None):
        """ConvBlock (reference blocks.py:13-103). Keras sublayer
        (= weight) order is attribute-assignment order for TRAINABLE
        weights: conv1, conv2, [norm1, norm2], [att] — with the bn moving
        statistics of both norms trailing at the block end (trainables-
        then-stats per layer, verified on the actual reference model);
        under normalization the convs are biasless (reference
        blocks.py:49-58 use_bias)."""
        if norm is None:
            self.conv(dst['Conv_0'])
            self.conv(dst['Conv_1'])
        else:
            self.conv_nobias(dst['Conv_0'])
            self.conv_nobias(dst['Conv_1'])
            self.norm_params(dst['_Norm_0'], norm)
            self.norm_params(dst['_Norm_1'], norm)
        if attention:
            self.attention(dst['ChannelAttention2D_0'])
        if norm is not None:
            self.norm_stats(dst['_Norm_0'], norm)
            self.norm_stats(dst['_Norm_1'], norm)

    def residual_block(self, dst, attention, use_1x1conv, norm=None):
        """ResidualBlock (reference blocks.py:187-230): conv1, conv2,
        [norm1, norm2], [att] (parent __init__), then conv1x1 (subclass);
        bn moving stats trail after ALL trainables incl. the conv1x1."""
        if norm is None:
            self.conv(dst['Conv_0'])
            self.conv(dst['Conv_1'])
        else:
            self.conv_nobias(dst['Conv_0'])
            self.conv_nobias(dst['Conv_1'])
            self.norm_params(dst['_Norm_0'], norm)
            self.norm_params(dst['_Norm_1'], norm)
        if attention:
            self.attention(dst['ChannelAttention2D_0'])
        if use_1x1conv:
            self.conv(dst['Conv_2'])
        if norm is not None:
            self.norm_stats(dst['_Norm_0'], norm)
            self.norm_stats(dst['_Norm_1'], norm)

    def dense_block(self, dst, attention, norm=None):
        """DenseBlock (reference blocks.py:233-277): 1x1 conv1 (the
        subclass reassigns the parent's conv1/conv2 attributes in place,
        WITH bias even under normalization — it never passes use_bias),
        3x3 conv2, [norm1 (dead code: its output is discarded, reference
        blocks.py:262-266 applies conv1 to X), norm2], [att]."""
        self.conv(dst['Conv_0'])
        self.conv(dst['Conv_1'])
        if norm is not None:
            self.take(2)   # norm1 gamma/beta: trained, unused by forward
            self.norm_params(dst['_Norm_0'], norm)
        if attention:
            self.attention(dst['ChannelAttention2D_0'])
        if norm == 'bn':
            self.take(2)   # norm1 moving stats: dead like its gamma/beta
            self.norm_stats(dst['_Norm_0'], norm)

    def convnext_block(self, dst, use_1x1conv):
        """ConvNextBlock (reference blocks.py:131-184). Attribute order:
        dwconv, pwconv1, pwconv2, norm (ln), [conv1x1]. The factories build
        it with drop_path=0 / layer_scale=0 so there is no gamma variable."""
        self.depthwise(dst['Conv_0'])
        self.dense(dst['Dense_0'])
        self.dense(dst['Dense_1'])
        self.layernorm(dst['LayerNorm_0'])
        if use_1x1conv:
            self.conv(dst['Conv_1'])

    def transition(self, dst):
        self.conv(dst['Conv_0'])

    def spc(self, dst, scale):
        """SubpixelConvolutionBlock: only the convs its forward actually
        uses are built (reference blocks.py:401-454); x2 stages share one
        conv (weight-tied in both frameworks)."""
        used = {2: ['conv2x'], 4: ['conv2x'], 8: ['conv2x'],
                10: ['conv2x', 'conv5x'], 20: ['conv2x', 'conv5x']}.get(
                    scale, ['convNx'])
        for name in used:
            self.conv(dst[name])

    def rc(self, dst):
        self.conv(dst['Conv_0'])

    def dc(self, dst, scale):
        """DeconvolutionBlock: Keras Conv2DTranspose kernels are
        (kh,kw,out,in) and TF's transposed conv is the gradient-of-conv;
        flax nn.ConvTranspose applies the kernel unflipped, so the exact
        mapping is spatial-flip + in/out swap (verified numerically:
        max |delta| 2.4e-7 on a 9x9/stride-2/SAME layer)."""
        t = lambda k: np.transpose(k[::-1, ::-1], (0, 1, 3, 2))  # noqa: E731
        if scale == 4:
            raise ValueError(
                'cannot import a reference dc/scale-4 model: the reference '
                'DeconvolutionBlock applies a third stride-4 deconv at '
                'scale 4 (dl4ds/models/blocks.py:522-534), a 16x upsample '
                'that its own training pipeline rejects — no valid '
                'reference checkpoint exists for this config')
        if scale == 8:
            self.conv_nobias(dst['deconv_1of3'], t)
            self.conv_nobias(dst['deconv_2of3'], t)  # reused 3rd stage
        else:
            self.conv_nobias(dst[f'deconv_x{scale}'], t)

    def localized(self, dst):
        """LocalizedConvBlock (reference blocks.py:312-336): transition
        1x1 conv + LocallyConnected2D(kernel_size=1) whose kernel reshapes
        to the per-pixel [H,W,Cin,F] einsum weight."""
        self.transition(dst['TransitionBlock_0'])
        k = self.take()
        h, w, cin, f = (np.asarray(dst['local_kernel'])).shape
        # implementation=3 stores one flat kernel laid out (H, W, F, Cin)
        # row-major (verified by brute force over all axis orders)
        self._set(dst, 'local_kernel',
                  np.reshape(k, (h, w, f, cin)).transpose(0, 1, 3, 2))
        if 'local_bias' in dst:
            self._set(dst, 'local_bias',
                      np.reshape(self.take(), (h, w, f)))

    def backbone_block(self, dst, backbone, i, attention, norm=None):
        if backbone == 'convnet':
            self.conv_block(dst[f'ConvBlock{i}'], attention, norm)
        elif backbone == 'resnet':
            self.residual_block(dst[f'ResidualBlock{i}'], attention,
                                use_1x1conv=(i != 1), norm=norm)
        elif backbone == 'densenet':
            self.dense_block(dst[f'DenseBlock{i}'], attention, norm)
            self.transition(dst[f'Transition{i}'])
        elif backbone == 'convnext':
            self.convnext_block(dst[f'ConvNextBlock{i}'],
                                use_1x1conv=(i != 1))
        else:
            raise ValueError(f'unsupported backbone {backbone!r}')

    def sp_backbone(self, bb, backbone, n_blocks, attention, norm=None):
        """_Backbone (reference sp_postups.py:118-168 / sp_preups.py
        103-151): stem, N blocks, then the per-backbone merge layers.

        Keras functional models order weights by graph depth (DFS from the
        outputs, following each node's input order), not creation order.
        For convnext the stem-skip TransitionBlock ties in depth with the
        LAST ConvNextBlock and is the Add's FIRST input, so it lists
        BEFORE that block (verified on the actual reference model)."""
        self.conv(bb['stem'])
        if backbone == 'convnext':
            for i in range(1, n_blocks):
                self.backbone_block(bb, backbone, i, attention)
            self.transition(bb['TransitionBlock_0'])     # stem-skip path
            self.backbone_block(bb, backbone, n_blocks, attention)
            return
        for i in range(1, n_blocks + 1):
            self.backbone_block(bb, backbone, i, attention, norm)
        self.conv(bb['backbone_out_conv'])
        if backbone == 'resnet':
            self.transition(bb['TransitionBlock_0'])     # stem-skip path
        elif backbone == 'densenet':
            self.transition(bb['TransitionBackboneLast'])

    def output_module(self, om, norm=None):
        """_OutputModule (reference sp_postups.py:205-212): TransitionLast,
        attention ConvBlock (attention is hard-coded True in the reference
        factories), final ConvBlock."""
        self.transition(om['TransitionLast'])
        self.conv_block(om['ConvBlock_0'], attention=True, norm=norm)
        self.conv_block(om['ConvBlock_1'], attention=False, norm=norm)


# ---------------------------------------------------------------------------
# family walkers
# ---------------------------------------------------------------------------

def _walk_sp(c: _Consumer, p: dict, mod, has_aux: bool):
    """NetPostupsampling / NetPIN (reference sp_postups.py / sp_preups.py:
    stem+blocks+merge, [upsampling], [localcon], [aux], output module)."""
    is_post = hasattr(mod, 'upsampling')
    norm = mod.normalization
    c.sp_backbone(p['_Backbone_0'], mod.backbone, mod.n_blocks,
                  mod.attention, norm=norm)
    if is_post:
        if mod.upsampling == 'spc':
            c.spc(p['SubpixelConvolutionBlock_0'], mod.scale)
        elif mod.upsampling == 'rc':
            c.rc(p['ResizeConvolutionBlock_0'])
        elif mod.upsampling == 'dc':
            c.transition(p['TransitionDC'])
            c.dc(p['DeconvolutionBlock_0'], mod.scale)
    if mod.localcon_layer:
        c.localized(p['LocalizedConvBlock_0'])
    if has_aux:
        aux = p['_AuxBranch_0']
        if mod.backbone == 'convnext':
            c.convnext_block(aux['ConvNextBlock_aux'], use_1x1conv=True)
        else:
            c.conv_block(aux['ConvBlock_aux'], attention=False, norm=norm)
    c.output_module(p['_OutputModule_0'], norm=norm)


def _walk_unet(c: _Consumer, p: dict, mod, has_aux: bool):
    """UnetPIN (reference sp_preups.py:192-315): encoders, bottleneck,
    per-level upsampler + decoder block, [localcon], [aux], output module."""
    n_blocks, norm = mod.n_blocks, mod.normalization
    for j in range(1, n_blocks + 1):
        c.conv_block(p[f'EncoderBlock{j}']['ConvBlock_0'], mod.attention,
                     norm)
    c.conv_block(p['Bottleneck'], attention=False)   # norm=None (Isola)
    for j in range(n_blocks):
        if mod.decoder_upsampling == 'spc':
            c.spc(p[f'SubpixelConvolutionBlock_{j}'], 2)
        elif mod.decoder_upsampling == 'rc':
            c.rc(p[f'ResizeConvolutionBlock_{j}'])
        elif mod.decoder_upsampling == 'dc':
            c.dc(p[f'DeconvolutionBlock_{j}'], 2)
        c.conv_block(p[f'DecoderConvBlock{j + 1}'], mod.attention, norm)
    if mod.localcon_layer:
        c.localized(p['LocalizedConvBlock_0'])
    if has_aux:
        c.conv_block(p['ConvBlock_0'], attention=False, norm=norm)
    c.output_module(p['_OutputModule_0'], norm=norm)


def _walk_rec(c: _Consumer, p: dict, mod, has_aux: bool):
    """RecNetPostupsampling / RecNetPIN (reference spt_postups.py /
    spt_preups.py): ConvLSTM backbone, [aux], [upsampling], [localcon],
    inline output head. The aux ConvBlock lists BEFORE the upsampling
    layer even though the factory creates it after (spt_postups.py:
    105-141): Keras functional weight order is graph-depth order, the
    shallow aux branch (one hop from its own Input to the post-upsampling
    Concatenate) ties with the upsampler and wins the tie — verified on
    the actual reference model (recresnet_spc_aux in COMPAT.json)."""
    is_post = hasattr(mod, 'upsampling')
    norm = mod.normalization
    bb = p['_RecBackbone_0']
    for j in range(1, mod.n_blocks + 2):   # stem + n_blocks
        blk = bb[f'RecurrentConvBlock{j}']
        c.convlstm(blk['ConvLSTM2D_0'])
        c.convlstm(blk['ConvLSTM2D_1'])
        if norm is not None:   # attr order: lstm1, lstm2, norm1, norm2;
            c.norm_params(blk['_Norm_0'], norm)     # bn stats trail
            c.norm_params(blk['_Norm_1'], norm)
            c.norm_stats(blk['_Norm_0'], norm)
            c.norm_stats(blk['_Norm_1'], norm)
    # unnamed ConvBlocks take sequential auto-names in creation order:
    # [aux], attention head, final head
    n = 0
    if has_aux:
        # spt aux branch: normalization=None hardcoded in the reference
        c.conv_block(p[f'ConvBlock_{n}'], mod.attention)
        n += 1
    if is_post:
        if mod.upsampling == 'spc':
            c.spc(p['SubpixelConvolutionBlock_0'], mod.scale)
        elif mod.upsampling == 'rc':
            c.rc(p['ResizeConvolutionBlock_0'])
        elif mod.upsampling == 'dc':
            c.dc(p['DeconvolutionBlock_0'], mod.scale)
    if mod.localcon_layer:
        c.localized(p['LocalizedConvBlock_0'])
    c.transition(p['TransitionLast'])
    c.conv_block(p[f'ConvBlock_{n}'], attention=True, norm=norm)
    c.conv_block(p[f'ConvBlock_{n + 1}'], attention=False, norm=norm)


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

def _overlay(dst: dict, src: dict) -> None:
    """Insert `src`'s leaves into `dst` at the same nested paths (used to
    merge batch_stats mean/var next to the BatchNorm scale/bias so the
    walkers navigate ONE tree)."""
    for k, v in src.items():
        if hasattr(v, 'items'):
            _overlay(dst.setdefault(k, {}), v)
        else:
            dst[k] = v


def _extract(merged: dict, template: dict):
    """Pull `template`'s structure back out of the merged tree."""
    out = {}
    for k, v in template.items():
        out[k] = _extract(merged[k], v) if hasattr(v, 'items') \
            else merged[k]
    return out


def _module(model):
    """The Flax module's fields the walkers read, from a `DSModel`: its
    `config` as attributes (a field the module lacks, such as `upsampling`
    of a 'pin' model, is absent) and its class name."""
    config = getattr(model, 'config', None)
    kind = getattr(model, 'module_class', None)
    if config is None or kind is None:
        raise TypeError('import_keras_weights takes the DSModel that built '
                        f'the network, got {type(model).__name__}')
    return types.SimpleNamespace(**config), kind


def import_keras_weights(model, net, source):
    """Load reference (carlos-gg/dl4ds) Keras weights into ``net``, in
    place (dl4ds_tpu/compat.py:512).

    Parameters
    ----------
    model : DSModel
        The model built with the SAME architecture arguments the reference
        model was trained with (backbone, upsampling, scale, n_filters,
        n_blocks, attention, aux channels, localcon_layer).
    net : torch.nn.Module
        ``model.init(...)``'s network, on any device: provides the target
        tree and shapes, and takes the weights.
    source
        ``tf.keras`` Model, SavedModel path, ``.npz`` from
        :func:`save_weights_npz`, or a list of arrays in ``model.weights``
        order.

    Returns
    -------
    ``net``, every parameter (and batch-norm statistic) replaced by the
    reference's. Raises if any shape mismatches or the weight count differs.
    """
    mod, kind = _module(model)
    norm = getattr(mod, 'normalization', None)
    if norm not in (None, 'ln', 'bn'):
        raise NotImplementedError(
            f'weight import supports normalization in (None, ln, bn); '
            f'got {norm!r}')
    variables = export_jax_variables(net)
    has_bn = norm == 'bn' and 'batch_stats' in variables
    ws = load_weight_list(source)
    p = copy.deepcopy(variables['params'])
    if has_bn:
        # overlay the moving statistics onto the params tree so the
        # walkers navigate ONE tree (Keras BatchNormalization keeps all
        # four weights in one layer); split back after consumption
        _overlay(p, copy.deepcopy(variables['batch_stats']))
    c = _Consumer(ws)
    if kind in ('NetPostupsampling', 'NetPIN'):
        _walk_sp(c, p, mod, has_aux='_AuxBranch_0' in p)
    elif kind == 'UnetPIN':
        # aux branch is a bare top-level ConvBlock_0
        _walk_unet(c, p, mod, has_aux='ConvBlock_0' in p)
    elif kind in ('RecNetPostupsampling', 'RecNetPIN'):
        # aux present iff there are three unnamed head ConvBlocks
        _walk_rec(c, p, mod, has_aux='ConvBlock_2' in p)
    else:
        raise NotImplementedError(
            f'weight import not implemented for {kind}; supported: the '
            'net_postupsampling / net_pin / unet_pin / '
            'recnet_postupsampling / recnet_pin factories')
    c.done()
    return load_jax_params(
        net, _extract(p, variables['params']),
        _extract(p, variables['batch_stats']) if has_bn else None)
