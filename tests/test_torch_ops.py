"""PyTorch port ops against the JAX package on the CPU: the channel-attention
gate (K1) against the Pallas kernel run in interpret mode, forward and
backward, its launch plan (`_ca_plan`) at the shapes `chip_smoke.py` gives
it with the H100's limits, the pixel shuffle and the matmul resize. Inputs
come from numpy; everything is float32 unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from dl4ds_tpu.interpolation import resize2d as jax_resize2d
from dl4ds_tpu.ops.array import depth_to_space as jax_depth_to_space
from dl4ds_tpu.ops.pallas_ops import (
    fused_channel_attention as jax_fused_channel_attention)

from dl4ds_tpu_torch.interpolation import resize2d
from dl4ds_tpu_torch.ops import (channel_attention_reference, depth_to_space,
                                 fused_channel_attention,
                                 FusedChannelAttention)
from dl4ds_tpu_torch.ops.fused_ops import (
    _STATIC_SMEM_RESERVE, _ca_plan, _channel_attention_backward, _gate,
    _launch, _launch_backward)


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


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', CA_SHAPES)
def test_k1_backward_with_saved_mean_and_gate_matches_jax_vjp(shape, dtype):
    """The plain backward on the forward's saved mean and gate (what the CPU
    path and the kernel both take) against jax.vjp of the interpreted Pallas
    kernel, whose VJP `_fused_ca_bwd` forms them from x again."""
    args = _ca_inputs(shape, seed=5)
    dy = np.random.default_rng(6).standard_normal(args[0].shape).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = getattr(torch, dtype)
    _, vjp = jax.vjp(
        lambda *a: jax_fused_channel_attention(*a, interpret=True),
        jnp.asarray(args[0], jdt), *map(jnp.asarray, args[1:]))
    want = vjp(jnp.asarray(dy, jdt))
    x = torch.from_numpy(args[0]).to(tdt)
    w = list(map(torch.from_numpy, args[1:]))
    m, g = _gate(x, *w)
    got = _channel_attention_backward(x, *w, torch.from_numpy(dy).to(tdt), m,
                                      g)
    for name, a, b in zip(('x', 'w1', 'b1', 'w2', 'b2'), got, want):
        # a bfloat16 dx is rounded to bfloat16 by both: ~2 ulps
        tol = (dict(atol=1e-6, rtol=1e-2) if name == 'x' and dtype ==
               'bfloat16' else dict(atol=1e-5, rtol=1e-5))
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   err_msg=f'd{name}', **tol)


def test_k1_saved_mean_and_gate_give_the_same_backward():
    """The backward on the saved m and g equals the one that forms them
    from x, bit for bit on the CPU."""
    x, *w = map(torch.from_numpy, _ca_inputs(CA_SHAPES[1], seed=7))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    saved = _channel_attention_backward(x, *w, dy, *_gate(x, *w))
    formed = _channel_attention_backward(x, *w, dy)
    for a, b in zip(saved, formed):
        assert torch.equal(a, b)


# the H100's limits as csrc/channel_attention.cu reports them: 132 SMs, the
# 227 KB of opt-in shared memory less the static reserve
H100_CA_LIMITS = (132, 232448 - _STATIC_SMEM_RESERVE)


def _k1_chip_cases():
    """(shape, Cr, dtype) of every K1 case `chip_smoke.py` runs: the serving
    gates at batch 8, the training gates, the other paths; both dtypes."""
    shapes = ([((chip_smoke.BATCH, h, w, c), max(int(c / 4), 1))
               for h, w, c in chip_smoke.K1_SHAPES]
              + [(s, max(int(s[-1] / 4), 1))
                 for s in chip_smoke.K1_TRAIN_SHAPES]
              + chip_smoke.K1_OTHER_PATHS)
    return [(tuple(s), cr, dt) for s, cr in shapes
            for dt in (torch.float32, torch.bfloat16)]


K1_CHIP_CASES = _k1_chip_cases()


@pytest.mark.parametrize('aligned', [True, False])
@pytest.mark.parametrize('limits', [H100_CA_LIMITS, (132, 100_000),
                                    (16, 60_000)])
def test_ca_plan_covers_every_pixel_once(limits, aligned):
    """Block x takes chunk x % parts of sample x // parts: every (sample,
    pixel) once, chunks on pack boundaries, within the shared memory the
    card allows."""
    for shape, cr, dtype in K1_CHIP_CASES:
        plan = _ca_plan(shape, cr, dtype, *limits, aligned=aligned)
        b, h, w, c = shape
        hw, elem = h * w, 4 if dtype == torch.float32 else 2
        covered = np.zeros((b, hw), dtype=np.int64)
        for block in range(plan['grid']):
            sample, part = divmod(block, plan['parts'])
            p0 = part * plan['ppp']
            p1 = min(p0 + plan['ppp'], hw)
            assert p1 > p0, (shape, plan)
            assert (p0 * c) % plan['vec'] == 0 == ((p1 - p0) * c) % plan['vec']
            covered[sample, p0:p1] += 1
        assert (covered == 1).all(), (shape, plan)
        assert plan['smem'] <= limits[1] and plan['bwd_smem'] <= limits[1]
        assert plan['bwd_region'] >= plan['region'] >= 4 * (2 * c + 2 * cr)
        if plan['regime'] == 'stream':
            assert plan['launches'] == 2 and plan['apply_blocks'] >= 1
        else:
            assert plan['regime'] == 'block' and plan['launches'] == 1
            assert plan['parts'] == 1 and plan['ppp'] == hw
            assert hw * c * elem <= plan['region']
        if not aligned:
            assert plan['vec'] == 1


def test_ca_plan_picks_each_regime_for_the_chip_shapes():
    """On the H100 every training gate (up to 128 KB a sample) and every
    other path fits a block; every serving gate (0.25-8 MB a sample)
    streams, and so do the training gates once a block takes less than
    their sample."""
    def regime(shape, dtype, limits=H100_CA_LIMITS):
        return _ca_plan(shape, max(int(shape[-1] / 4), 1), dtype,
                        *limits)['regime']

    seen = {regime(s, dt) for s, _, dt in K1_CHIP_CASES}
    assert seen == set(chip_smoke.CA_REGIMES) == {'block', 'stream'}
    serving = [(chip_smoke.BATCH, h, w, c) for h, w, c in chip_smoke.K1_SHAPES]
    for dt in (torch.float32, torch.bfloat16):
        assert all(regime(s, dt) == 'block'
                   for s in chip_smoke.K1_TRAIN_SHAPES)
        assert all(regime(s, dt) == 'block'
                   for s, _ in chip_smoke.K1_OTHER_PATHS)
        assert all(regime(s, dt) == 'stream' for s in serving)
    small = (132, 40_000)
    assert [regime(s, torch.float32, small)
            for s in chip_smoke.K1_TRAIN_SHAPES] == \
        ['block'] * 3 + ['stream'] * 4


@pytest.mark.parametrize('case', ['dtype', 'dy_dtype', 'dy_shape',
                                  'dy_contiguity', 'm_shape', 'g_dtype',
                                  'w2', 'empty'])
def test_k1_backward_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The backward wrapper's checks run before anything reaches the card."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _ca_inputs(CA_SHAPES[0]))
    dy = torch.ones_like(x)
    m, g = _gate(x, w1, b1, w2, b2)
    err = ValueError
    if case == 'dtype':
        x, dy, err = x.double(), dy.double(), TypeError
    elif case == 'dy_dtype':
        dy = dy.to(torch.bfloat16)
    elif case == 'dy_shape':
        dy = dy[:, :-1]
    elif case == 'dy_contiguity':
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == 'm_shape':
        m = m[:-1]
    elif case == 'g_dtype':
        g = g.double()
    elif case == 'w2':
        w2 = w2.T
    else:
        x, dy = x[:, :0], dy[:, :0]
    with pytest.raises(err):
        _launch_backward(x, w1, b1, w2, b2, dy, m, g)


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
