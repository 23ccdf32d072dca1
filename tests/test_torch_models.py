"""PyTorch port models against the JAX package on the CPU: the flagship
post-upsampling resnet with the sub-pixel head, with the Flax weights carried
across by `load_jax_params`. Small size: 16x16 LR, n_filters=4, n_blocks=2,
batch 2, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ds_tpu.models import net_postupsampling as jax_net_postupsampling
from dl4ds_tpu.models.blocks import get_activation as jax_get_activation

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.models.blocks import get_activation
from _torch_xla import quick_xla  # noqa: F401

LR = 16
SMALL = dict(n_channels=4, n_aux_channels=2, lr_size=(LR, LR), n_filters=4,
             n_blocks=2, attention=True)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _params_np(variables):
    return jax.tree_util.tree_map(np.asarray, variables['params'])


def _pair(scale, seed=0):
    jm = jax_net_postupsampling('resnet', 'spc', scale=scale, **SMALL)
    variables = jm.init(jax.random.PRNGKey(seed))
    tm = tds.net_postupsampling('resnet', 'spc', scale=scale, **SMALL)
    net = tm.init(seed, device='cpu')
    return jm, variables, tm, net


@pytest.mark.parametrize('scale', [2, 4, 8])
def test_model_with_carried_weights_matches_jax(scale):
    jm, variables, tm, net = _pair(scale, seed=scale)
    tds.load_jax_params(net, _params_np(variables))   # raises on any leftover
    assert tm.param_count(net) == jm.param_count(variables)
    rng = np.random.default_rng(scale)
    x = rng.standard_normal((2, LR, LR, 4)).astype(np.float32)
    aux = rng.standard_normal((2, LR * scale, LR * scale, 2)).astype(
        np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(aux),
                               training=False))
    with torch.inference_mode():
        got = net(torch.from_numpy(x), torch.from_numpy(aux)).numpy()
    assert got.shape == want.shape == (2, LR * scale, LR * scale, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_spc_x2_conv_is_one_tied_module():
    _, variables, tm, net = _pair(8)
    spc = net.SubpixelConvolutionBlock_0
    assert [n for n, _ in spc.named_parameters()] == ['conv2x.weight',
                                                      'conv2x.bias']
    assert list(_params_np(variables)['SubpixelConvolutionBlock_0']) == [
        'conv2x']


def test_load_jax_params_rejects_an_unconsumed_leaf():
    _, variables, _, net = _pair(4)
    params = _params_np(variables)
    params['_Backbone_0']['ResidualBlock1']['Conv_9'] = {
        'kernel': np.zeros((1, 1, 4, 4), np.float32),
        'bias': np.zeros(4, np.float32)}
    with pytest.raises(KeyError, match='Conv_9'):
        tds.load_jax_params(net, params)


def test_load_jax_params_rejects_an_unset_torch_parameter():
    _, variables, _, net = _pair(4)
    params = _params_np(variables)
    del params['_OutputModule_0']['ConvBlock_0']['ChannelAttention2D_0']
    with pytest.raises(KeyError, match='ChannelAttention2D_0'):
        tds.load_jax_params(net, params)


def test_load_jax_params_rejects_a_shape_mismatch():
    _, variables, _, net = _pair(4)
    params = _params_np(variables)
    params['_Backbone_0']['stem']['bias'] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match='stem/bias'):
        tds.load_jax_params(net, params)


def test_init_is_seeded_and_glorot_bounded():
    tm = tds.net_postupsampling('resnet', 'spc', scale=4, **SMALL)
    a, b, c = (tm.init(s, device='cpu') for s in (3, 3, 4))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(('bias', 'b1', 'b2')):
            assert not pa.any(), name
        else:
            assert not torch.equal(pa, pc), name
    stem = a._Backbone_0.stem.weight                    # [4, 4, 3, 3]
    assert stem.abs().max() <= (6.0 / (2 * 4 * 9)) ** 0.5


@pytest.mark.parametrize('name', ['relu', 'gelu', 'elu', 'selu',
                                  'leaky_relu', 'sigmoid', 'tanh', None])
def test_activation_matches_jax(name):
    x = np.linspace(-4, 4, 41, dtype=np.float32)
    want = np.asarray(jax_get_activation(name)(jnp.asarray(x)))
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('kwargs', [dict(dtype=torch.float16)])
def test_unported_configurations_raise(kwargs):
    args = dict(backbone_block='resnet', upsampling='spc', scale=4, **SMALL)
    args.update(kwargs)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tds.net_postupsampling(**args)


def test_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: init() runs there')
    tm = tds.net_postupsampling('resnet', 'spc', scale=4, **SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init(0)
