"""PyTorch port ops against the JAX package on the CPU: the channel-attention
gate (K1) against the Pallas kernel run in interpret mode, the pixel shuffle
and the matmul resize. Inputs come from numpy; everything is float32 unless
a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ds_tpu.interpolation import resize2d as jax_resize2d
from dl4ds_tpu.ops.array import depth_to_space as jax_depth_to_space
from dl4ds_tpu.ops.pallas_ops import (
    fused_channel_attention as jax_fused_channel_attention)

from dl4ds_tpu_torch.interpolation import resize2d
from dl4ds_tpu_torch.ops import (channel_attention_reference, depth_to_space,
                                 fused_channel_attention,
                                 FusedChannelAttention)
from dl4ds_tpu_torch.ops.fused_ops import _launch


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


# (B, H, W, C, Cr): H != W, C = 8 and 12, a leading batch of 3
CA_SHAPES = [(3, 5, 7, 8, 2), (3, 6, 4, 12, 3), (3, 9, 5, 8, 2)]


def _ca_inputs(shape, seed=0):
    b, h, w, c, cr = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [f(b, h, w, c), f(c, cr) * 0.5, f(cr) * 0.1, f(cr, c) * 0.5,
            f(c) * 0.1]


@pytest.mark.parametrize('shape', CA_SHAPES)
def test_k1_forward_matches_interpreted_pallas(shape):
    args = _ca_inputs(shape)
    want = np.asarray(jax_fused_channel_attention(
        *map(jnp.asarray, args), interpret=True))
    got = fused_channel_attention(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('shape', CA_SHAPES)
def test_k1_backward_matches_jax_grad(shape):
    args = _ca_inputs(shape, seed=1)
    dy = np.random.default_rng(2).standard_normal(args[0].shape).astype(
        np.float32)
    _, vjp = jax.vjp(
        lambda *a: jax_fused_channel_attention(*a, interpret=True),
        *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = FusedChannelAttention.apply(*leaves)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, g, w in zip(('x', 'w1', 'b1', 'w2', 'b2'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=f'd{name}')


def test_k1_bf16_gate_rounding_matches_pallas():
    """The gate is rounded to x's dtype before the multiply, as the TPU
    kernel does: bf16 results agree to ~2 bf16 ulps."""
    args = _ca_inputs(CA_SHAPES[0], seed=3)
    x16 = jnp.asarray(args[0], jnp.bfloat16)
    want = np.asarray(jax_fused_channel_attention(
        x16, *map(jnp.asarray, args[1:]), interpret=True).astype(jnp.float32))
    xt = torch.from_numpy(args[0]).to(torch.bfloat16)
    got = fused_channel_attention(xt, *map(torch.from_numpy, args[1:]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6,
                               rtol=1e-2)


def test_k1_leading_dims_are_flattened():
    x, *w = _ca_inputs((6, 5, 7, 8, 2), seed=4)
    x5 = x.reshape(2, 3, 5, 7, 8)
    got = fused_channel_attention(torch.from_numpy(x5),
                                  *map(torch.from_numpy, w)).numpy()
    want = channel_attention_reference(
        torch.from_numpy(x), *map(torch.from_numpy, w)).numpy()
    np.testing.assert_array_equal(got.reshape(x.shape), want)


def test_k1_cpu_tensor_launches_no_kernel():
    before = fused_channel_attention.launches
    fused_channel_attention(*map(torch.from_numpy, _ca_inputs(CA_SHAPES[0])))
    assert fused_channel_attention.launches == before


@pytest.mark.parametrize('case', ['dtype', 'contiguity', 'w1', 'w2', 'empty'])
def test_k1_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The CUDA wrapper's checks run before anything reaches the card."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _ca_inputs(CA_SHAPES[0]))
    if case == 'dtype':
        x, err = x.double(), TypeError
    elif case == 'contiguity':
        x, err = x.transpose(1, 2), ValueError
    elif case == 'w1':
        w1, err = w1[:-1], ValueError
    elif case == 'w2':
        w2, err = w2.T, ValueError
    else:
        x, err = x[:, :0], ValueError
    with pytest.raises(err):
        _launch(x, w1, b1, w2, b2)


@pytest.mark.parametrize('ratio', [2, 5])
def test_depth_to_space_matches_jax(ratio):
    x = np.random.default_rng(ratio).standard_normal(
        (2, 3, 4, 3 * ratio * ratio)).astype(np.float32)
    want = np.asarray(jax_depth_to_space(jnp.asarray(x), ratio))
    got = depth_to_space(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_array_equal(got, want)


def test_depth_to_space_is_not_torch_pixel_shuffle_order():
    """torch.pixel_shuffle reads channels as (c, dy, dx), the JAX package as
    (dy, dx, c): with more than one output channel the two differ."""
    x = torch.arange(2 * 2 * 8, dtype=torch.float32).reshape(1, 2, 2, 8)
    ours = depth_to_space(x, 2)
    theirs = torch.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert ours.shape == theirs.shape == (1, 4, 4, 2)
    assert not torch.equal(ours, theirs)


@pytest.mark.parametrize('mode,shape,out_hw', [
    ('inter_area', (3, 64, 48, 2), (16, 12)),     # exact 4x mean pool
    ('inter_area', (3, 20, 30, 2), (15, 21)),     # fractional decimation
    ('inter_area', (2, 16, 12, 1), (40, 36)),     # upsampling: generic path
    ('bilinear', (2, 16, 24, 3), (40, 20)),
    ('bilinear', (24, 16), (12, 40)),             # rank 2
])
def test_resize2d_matches_jax(mode, shape, out_hw):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_resize2d(jnp.asarray(x), out_hw, mode))
    got = resize2d(torch.from_numpy(x), out_hw, mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
