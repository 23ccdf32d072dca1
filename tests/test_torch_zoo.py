"""The port's post-upsampling zoo against the JAX package on the CPU: the
blocks of the convnet and densenet backbones, the 'rc' and 'dc' heads and
the U-Net (`DenseBlock`, `EncoderBlock`, `pad_concat`,
`ResizeConvolutionBlock` in every `_RC_INTERP` mode, `DeconvolutionBlock`
at scales 2, 3, 4 and 8, the last with its tied stage), then the models:
convnet and densenet with the 'spc', 'rc' and 'dc' heads (with and
without aux, with `remat`) and the recurrent resnet's 'rc' and 'dc'
heads. The same seeded numpy inputs and the Flax weights carried across by
`load_jax_params` go through both.

Tolerances: float32 forward and gradients of a weighted mean of the
output within atol/rtol 1e-4 (the gradients' atol scaled by their max
|g|), as tests/test_torch_models.py; a bfloat16 forward by
tests/test_torch_bf16_models.py's rules (every shared module's output
dtype equal to the JAX model's, and the port's output at most half as far
from JAX's bfloat16 one as JAX's own float32 one is). Small sizes: n_filters
4, n_blocks 2, grids of 6-36."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu.models import blocks as jblocks

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.models import blocks as tblocks
from _torch_xla import quick_xla  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
BF = torch.bfloat16
RATIO = 0.5
LR, SCALE = 8, 4
SPATIAL = dict(n_channels=3, lr_size=(LR, LR), n_filters=4, n_blocks=2,
               attention=True)
REC = dict(scale=SCALE, n_channels=2, lr_size=(6, 6), time_window=3,
           n_filters=4, n_blocks=1)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=''):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f'{prefix}{key}/'))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _check_forward_and_grads(apply_jax, params, net, inputs, seed):
    """The outputs of `apply_jax(params, *inputs)` and `net(*inputs)`, and
    the gradients of mean(out * r) with respect to every parameter and the
    first input, within TOL. Returns the output."""
    rest = [_j(a) for a in inputs[1:]]

    @jax.jit
    def forward_and_grads(p, x, r):
        out, vjp = jax.vjp(lambda p, x: apply_jax(p, x, *rest), p, x)
        return (out,) + vjp(r / r.size)

    shape = jax.eval_shape(lambda p, x: apply_jax(p, x, *rest), params,
                           _j(inputs[0])).shape
    r = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    want, gp, gx = forward_and_grads(params, _j(inputs[0]), jnp.asarray(r))
    want = np.asarray(want)
    x = _t(inputs[0]).requires_grad_(True)
    net.zero_grad()
    out = net(x, *map(_t, inputs[1:]))
    torch.mean(out * _t(r)).backward()
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    got = {name: p.grad for name, p in net.named_parameters()}
    ref = tds.load_jax_params(copy.deepcopy(net), _np_tree(gp))
    assert len(got) == len(dict(ref.named_parameters()))
    for name, g in ref.named_parameters():
        scale = max(float(g.abs().max()), 1e-30)
        np.testing.assert_allclose(got[name].numpy(), g.detach().numpy(),
                                   atol=TOL['atol'] * scale,
                                   rtol=TOL['rtol'], err_msg=name)
    gx = np.asarray(gx)
    np.testing.assert_allclose(x.grad.numpy(), gx,
                               atol=TOL['atol'] * np.abs(gx).max(),
                               rtol=TOL['rtol'])
    return want


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _block_pair(jmod, tmod, *inputs, seed=0):
    variables = jmod.init(jax.random.PRNGKey(seed), *map(_j, inputs))
    tds.load_jax_params(tmod, _np_tree(variables['params']))
    return variables


@pytest.mark.parametrize('attention', [False, True])
def test_dense_block_matches_jax(attention):
    """A 1x1 conv to 4 * filters, act, a 3x3 conv, [the gate], then
    concat([y, x]): in + filters channels."""
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 3)).astype(
        np.float32)
    jm = jblocks.DenseBlock(4, attention=attention)
    tm = tblocks.DenseBlock(3, 4, attention=attention)
    v = _block_pair(jm, tm, x)
    out = _check_forward_and_grads(lambda p, x: jm.apply({'params': p}, x),
                                   v['params'], tm, (x,), 1)
    assert out.shape == (2, 9, 11, 7)
    np.testing.assert_array_equal(out[..., 4:], x)


@pytest.mark.parametrize('hw', [(12, 16), (13, 15)], ids=['even', 'odd'])
def test_encoder_block_matches_jax(hw):
    """A ConvBlock, then a 2x2 max-pool with stride 2 and VALID padding
    (odd sizes floor); returns (down, skip)."""
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(
        np.float32)
    jm = jblocks.EncoderBlock(4, activation='relu', attention=True)
    tm = tblocks.EncoderBlock(3, 4, activation='relu', attention=True)
    v = _block_pair(jm, tm, x)
    down, skip = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got_down, got_skip = tm(_t(x))
    assert tuple(got_down.shape) == down.shape == (2, hw[0] // 2,
                                                    hw[1] // 2, 4)
    np.testing.assert_allclose(got_skip.numpy(), np.asarray(skip), **TOL)
    np.testing.assert_allclose(got_down.numpy(), np.asarray(down), **TOL)
    # the gradient through the pool and the block
    gp = jax.grad(lambda p: jnp.sum(jm.apply({'params': p}, _j(x))[0]))(
        v['params'])
    tm.zero_grad()
    tm(_t(x))[0].sum().backward()
    ref = tds.load_jax_params(copy.deepcopy(tm), _np_tree(gp))
    for name, g in ref.named_parameters():
        got = dict(tm.named_parameters())[name].grad
        np.testing.assert_allclose(got.numpy(), g.detach().numpy(),
                                   atol=TOL['atol'] * float(g.abs().max()),
                                   rtol=TOL['rtol'], err_msg=name)


@pytest.mark.parametrize('shapes', [((2, 5, 7, 3), (2, 6, 6, 2)),
                                    ((1, 9, 4, 1), (1, 9, 4, 2)),
                                    ((2, 3, 8, 2), (2, 7, 5, 3))])
def test_pad_concat_matches_jax(shapes):
    """Both tensors zero-padded at the bottom and right to the larger grid,
    then concatenated on channels; dtypes promote as jnp.concatenate's."""
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    want = np.asarray(jblocks.pad_concat(jnp.asarray(a), jnp.asarray(b)))
    got = tblocks.pad_concat(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tblocks.PadConcat()(_t(a), _t(b)).numpy(),
                                  want)
    mixed = tblocks.pad_concat(_t(a).to(BF), _t(b))
    want_mixed = jblocks.pad_concat(jnp.asarray(a).astype(jnp.bfloat16),
                                    jnp.asarray(b))
    assert mixed.dtype == torch.float32 and want_mixed.dtype == jnp.float32
    np.testing.assert_array_equal(mixed.numpy(), np.asarray(want_mixed))


def test_rc_interpolation_table_is_the_jax_one():
    assert tblocks._RC_INTERP == jblocks._RC_INTERP
    with pytest.raises(ValueError, match='unknown rc interpolation'):
        tblocks.ResizeConvolutionBlock(2, 4, interpolation='cubic_spline')
    with pytest.raises(ValueError, match='unknown rc interpolation'):
        tds.net_postupsampling('convnet', 'rc', scale=2, n_aux_channels=0,
                               rc_interpolation='cubic_spline', **SPATIAL)


@pytest.mark.parametrize('mode', sorted(jblocks._RC_INTERP))
def test_resize_convolution_block_matches_jax(mode):
    """`resize2d` to the scaled grid in each mode of the table, then a 3x3
    conv to n_filters, from other input channels (the U-Net decoder's)."""
    x = np.random.default_rng(4).standard_normal((2, 5, 7, 6)).astype(
        np.float32)
    scale = 3 if mode in ('area', 'lanczos5') else 2
    jm = jblocks.ResizeConvolutionBlock(scale, 4, interpolation=mode)
    tm = tblocks.ResizeConvolutionBlock(scale, 4, in_channels=6,
                                        interpolation=mode)
    v = _block_pair(jm, tm, x)
    out = _check_forward_and_grads(lambda p, x: jm.apply({'params': p}, x),
                                   v['params'], tm, (x,), 4)
    assert out.shape == (2, 5 * scale, 7 * scale, 4)


@pytest.mark.parametrize('scale', [2, 3, 4, 8])
def test_deconvolution_block_matches_jax(scale):
    """Flax's transposed convolutions (9x9, SAME, no bias, the unflipped
    kernel on the asymmetrically padded dilated input) at every stride the
    heads use: x2, x3 (an odd scale, one stage), x4 (two stride-2 stages)
    and x8 (a stride-2 stage, then one tied stage applied twice)."""
    x = np.random.default_rng(5).standard_normal((2, 5, 6, 3)).astype(
        np.float32)
    jm = jblocks.DeconvolutionBlock(scale, 4, 'relu')
    tm = tblocks.DeconvolutionBlock(scale, 4, 'relu', in_channels=3)
    v = _block_pair(jm, tm, x)
    names = {2: ['deconv_x2'], 3: ['deconv_x3'],
             4: ['deconv_1of2', 'deconv_2of2'],
             8: ['deconv_1of3', 'deconv_2of3']}[scale]
    assert sorted(v['params']) == names
    assert [n for n, _ in tm.named_parameters()] == [f'{n}.kernel'
                                                     for n in names]
    out = _check_forward_and_grads(lambda p, x: jm.apply({'params': p}, x),
                                   v['params'], tm, (x,), 5)
    assert out.shape == (2, 5 * scale, 6 * scale, 4)


@pytest.mark.parametrize('stride', [2, 3, 4, 5, 8, 10, 12])
def test_conv_transpose_padding_is_lax_conv_transpose(stride):
    """The port's ConvTranspose against `lax.conv_transpose(padding=
    'SAME')` at strides whose torch padding needs a crop (2, 4, 8), none
    (3, 5) or output padding (10, 12: stride above the kernel's 9)."""
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((1, 4, 3, 2)).astype(np.float32)
    k = rng.standard_normal((9, 9, 2, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), 'SAME',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC')))
    tm = tblocks.ConvTranspose(2, 3, (9, 9), stride)
    with torch.no_grad():
        tm.kernel.copy_(_t(k))
        got = tm(_t(x)).numpy()
    assert got.shape == want.shape == (1, 4 * stride, 3 * stride, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def _spatial_pair(backbone, upsampling, n_aux, remat=False, dtype=None,
                  seed=0):
    kw = dict(SPATIAL, n_aux_channels=n_aux, remat=remat)
    jm = dds.net_postupsampling(backbone, upsampling, scale=SCALE, **kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = tds.net_postupsampling(backbone, upsampling, scale=SCALE,
                                **(kw if dtype is None else dict(kw,
                                                                 dtype=dtype)))
    net = tds.load_jax_params(tm.init(seed, device='cpu'),
                              _np_tree(v['params']))
    return jm, v, tm, net


def _spatial_inputs(n_aux, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, LR, LR, 3)).astype(np.float32)
    aux = (rng.standard_normal((2, LR * SCALE, LR * SCALE, n_aux)).astype(
        np.float32) if n_aux else None)
    return (x,) if aux is None else (x, aux)


@pytest.mark.parametrize('backbone,upsampling,n_aux,remat', [
    ('convnet', 'spc', 2, False), ('convnet', 'rc', 2, False),
    ('convnet', 'dc', 0, False), ('densenet', 'spc', 0, False),
    ('densenet', 'rc', 2, False), ('densenet', 'dc', 2, False),
    ('convnet', 'dc', 2, True), ('densenet', 'rc', 0, True)])
def test_postupsampling_model_matches_jax(backbone, upsampling, n_aux, remat):
    """Forward and gradients of the convnet and densenet backbones under
    each head, with and without aux, and with remat (the same parameters
    and values, the blocks recomputed in the backward pass)."""
    jm, v, tm, net = _spatial_pair(backbone, upsampling, n_aux, remat)
    assert tm.param_count(net) == jm.param_count(v)
    assert tm.name == jm.name == f'{backbone}_{upsampling}'
    assert net._Backbone_0.remat == remat
    inputs = _spatial_inputs(n_aux, 6)
    out = _check_forward_and_grads(
        lambda p, x, *a: jm.apply({'params': p}, x, *a), v['params'], net,
        inputs, 7)
    assert out.shape == (2, LR * SCALE, LR * SCALE, 1)


def test_densenet_channel_counts_and_names():
    """Each DenseBlock adds its filters, each Transition halves with //2,
    and TransitionBackboneLast takes concat([stem, b]), as in the Flax
    tree; the 'dc' head's TransitionDC goes to f0, not the width."""
    _, v, _, net = _spatial_pair('densenet', 'dc', 0)
    bb = v['params']['_Backbone_0']
    # stem 4; block 1: 4 + 4 -> 4; block 2: 4 + 8 -> 6; out conv 6 -> 8
    assert bb['Transition1']['Conv_0']['kernel'].shape == (1, 1, 8, 4)
    assert bb['Transition2']['Conv_0']['kernel'].shape == (1, 1, 12, 6)
    assert bb['TransitionBackboneLast']['Conv_0']['kernel'].shape == (
        1, 1, 12, 8)
    assert v['params']['TransitionDC']['Conv_0']['kernel'].shape == (
        1, 1, 8, 4)
    assert v['params']['DeconvolutionBlock_0']['deconv_1of2'][
        'kernel'].shape == (9, 9, 4, 8)
    assert set(_flat(tds.weights.export_jax_params(net))) == set(
        _flat(_np_tree(v['params'])))


def _rec_pair(upsampling, n_aux, dtype=None, seed=1):
    kw = dict(REC, n_aux_channels=n_aux)
    jm = dds.recnet_postupsampling('resnet', upsampling, **kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = tds.recnet_postupsampling('resnet', upsampling, **(
        kw if dtype is None else dict(kw, dtype=dtype)))
    net = tds.load_jax_params(tm.init(seed, device='cpu'),
                              _np_tree(v['params']))
    return jm, v, tm, net


def _rec_inputs(n_aux, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 6, 6, 2)).astype(np.float32)
    aux = (rng.standard_normal((2, 24, 24, n_aux)).astype(np.float32)
           if n_aux else None)
    return (x,) if aux is None else (x, aux)


@pytest.mark.parametrize('upsampling,n_aux', [('rc', 2), ('dc', 0),
                                              ('dc', 2)])
def test_recurrent_heads_match_jax(upsampling, n_aux):
    """The recurrent resnet's 'rc' and 'dc' heads on the [B*T]-flattened
    frames; the 'dc' head has no TransitionDC and no activation."""
    jm, v, tm, net = _rec_pair(upsampling, n_aux)
    assert tm.name == jm.name == f'recresnet_{upsampling}'
    assert 'TransitionDC' not in v['params']
    assert tm.param_count(net) == jm.param_count(v)
    out = _check_forward_and_grads(
        lambda p, x, *a: jm.apply({'params': p}, x, *a), v['params'], net,
        _rec_inputs(n_aux, 8), 9)
    assert out.shape == (2, 3, 24, 24, 1)


def _dtype_map(model, v, inputs):
    _, state = model.module.apply(v, *map(_j, inputs),
                                  capture_intermediates=True,
                                  mutable=['intermediates'])
    out = {}

    def walk(tree, path):
        for key, val in tree.items():
            if key == '__call__':
                y = jax.tree_util.tree_leaves(val[0])[0]
                out['.'.join(path)] = jnp.dtype(y.dtype).name
            elif isinstance(val, dict):
                walk(val, path + [key])
    walk(state['intermediates'], [])
    return out


def check_bf16_forward(factory, args, kwargs, inputs, seed=0):
    """tests/test_torch_bf16_models.py's rules for a bfloat16 model: every
    module the two models share has the JAX model's output dtype, and the
    port's output is at most RATIO of JAX's float32-to-bfloat16 distance
    from JAX's bfloat16 output (both over max |jax_bf16|)."""
    j32 = factory[0](*args, **kwargs)
    j16 = factory[0](*args, dtype=jnp.bfloat16, **kwargs)
    v = jax.jit(j32.init)(jax.random.PRNGKey(seed))
    tm = factory[1](*args, dtype=BF, **kwargs)
    net = tds.load_jax_params(tm.init(0, device='cpu'),
                              _np_tree(v['params']))
    # eagerly, as tests/test_torch_bf16_models.py: under jit XLA keeps the
    # gate's m @ w1 in float32
    want = np.asarray(j16.apply(v, *map(_j, inputs)).astype(jnp.float32))
    y32 = np.asarray(j32.apply(v, *map(_j, inputs)))
    got_dtypes = {}
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=name: got_dtypes.__setitem__(
            n, str(o[0].dtype if isinstance(o, tuple) else o.dtype)
            .replace('torch.', '')))
        for name, m in net.named_modules()]
    with torch.no_grad():
        y = net(*map(_t, inputs))
    for h in hooks:
        h.remove()
    assert y.dtype == BF and tuple(y.shape) == want.shape
    want_dtypes = _dtype_map(j16, v, inputs)
    shared = sorted(set(want_dtypes) & set(got_dtypes))
    assert len(shared) >= 10
    assert {k: got_dtypes[k] for k in shared} == \
        {k: want_dtypes[k] for k in shared}
    scale = np.abs(want).max()
    port = np.abs(y.float().numpy() - want).max() / scale
    own = np.abs(y32 - want).max() / scale
    assert own > 1e-3
    assert port <= RATIO * own, (port, own)


@pytest.mark.parametrize('backbone,upsampling,n_aux', [
    ('convnet', 'rc', 2), ('densenet', 'dc', 0)])
def test_bf16_postupsampling_forward_matches_jax(backbone, upsampling,
                                                 n_aux):
    check_bf16_forward(
        (dds.net_postupsampling, tds.net_postupsampling),
        (backbone, upsampling),
        dict(SPATIAL, scale=SCALE, n_aux_channels=n_aux),
        _spatial_inputs(n_aux, 10))


@pytest.mark.parametrize('upsampling', ['dc'])
def test_bf16_recurrent_heads_forward_match_jax(upsampling):
    check_bf16_forward(
        (dds.recnet_postupsampling, tds.recnet_postupsampling),
        ('resnet', upsampling), dict(REC, n_aux_channels=2),
        _rec_inputs(2, 11), seed=1)


@pytest.mark.parametrize('case', ['densenet_dc_x8', 'recresnet_rc'])
def test_export_jax_params_round_trips(case):
    """`export_jax_params` gives back the Flax tree it was loaded from: the
    same keys (the tied `deconv_2of3` once) and the same values."""
    if case == 'densenet_dc_x8':
        kw = dict(SPATIAL, n_aux_channels=2)
        jm = dds.net_postupsampling('densenet', 'dc', scale=8, **kw)
        tm = tds.net_postupsampling('densenet', 'dc', scale=8, **kw)
    else:
        kw = dict(REC, n_aux_channels=2)
        jm = dds.recnet_postupsampling('resnet', 'rc', **kw)
        tm = tds.recnet_postupsampling('resnet', 'rc', **kw)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(12))['params'])
    net = tds.load_jax_params(tm.init(0, device='cpu'), params)
    got, want = (_flat(t) for t in (tds.weights.export_jax_params(net),
                                    params))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if case == 'densenet_dc_x8':
        assert 'DeconvolutionBlock_0/deconv_2of3/kernel' in got
        assert tm.param_count(net) == jm.param_count({'params': params})
