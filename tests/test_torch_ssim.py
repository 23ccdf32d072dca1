"""PyTorch port of the SSIM ops, the fused SSIM (K6) and the DSSIM losses
against the JAX package on the CPU, with K6's closed-form backward
(`ssim_backward_reference`) and its launch plan (`_ssim_plan`) at the shapes
`chip_smoke.py` gives it. Inputs come from numpy, float32.

Tolerances: SSIM and MS-SSIM per image atol 1e-5 (float32 band matmuls
summed in another order); PSNR rtol 1e-6; the fused SSIM's plain path
against the interpreted Pallas kernel atol 1e-5; gradients atol 1e-4 of max
|g| (the largest difference seen is 1.2e-5 of it, MS-DSSIM through five
scales); loss values rtol 1e-5; the closed-form backward against jax.grad
atol 1e-5 of max |g| (float32 on both sides), against torch autograd in
float64 1e-12 of max |g|."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from dl4ds_tpu import losses as jax_losses
from dl4ds_tpu.ops.pallas_ops import (
    fused_ssim_per_image as jax_fused_ssim_per_image)
from dl4ds_tpu.ops.ssim import (psnr as jax_psnr, ssim as jax_ssim,
                                ssim_multiscale as jax_ssim_multiscale)

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.ops import FusedSSIM, fused_ssim_per_image
from dl4ds_tpu_torch.ops.fused_ops import (_STATIC_SMEM_RESERVE, _launch_ssim,
                                           _launch_ssim_backward, _ssim_plan)
from dl4ds_tpu_torch.ops.ssim import (psnr, ssim, ssim_backward_reference,
                                      ssim_multiscale)

MS_FACTORS4 = (0.0448, 0.2856, 0.3001, 0.2363)
GRAD_RTOL = 1e-4        # of max |g|


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _pair(shape, seed):
    """An image in [0, 1) and a noisy copy clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_grads_close(got, want, name):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, atol=GRAD_RTOL * scale, rtol=0,
                               err_msg=name)


# ---------------------------------------------------------------------------
# ssim, ssim_multiscale, psnr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('as_tensor', [False, True], ids=['float', 'tensor'])
@pytest.mark.parametrize('shape', [(3, 24, 24, 1), (2, 16, 16, 3),
                                   (2, 3, 32, 32, 1), (1, 11, 11, 1),
                                   (2, 13, 37, 1)])
def test_ssim_matches_jax(shape, as_tensor):
    a, b = _pair(shape, sum(shape))
    want = np.asarray(jax_ssim(a, b, 0.9))
    max_val = torch.tensor(0.9) if as_tensor else 0.9
    got = ssim(*_t(a, b), max_val)
    assert tuple(got.shape) == shape[:-3] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('shape,factors', [
    ((2, 176, 176, 1), None),           # the default 5 scales
    ((2, 90, 97, 1), MS_FACTORS4)],     # odd sizes: symmetric pad
    ids=['5-scales', '4-scales-odd'])
def test_ssim_multiscale_matches_jax(shape, factors):
    a, b = _pair(shape, 3)
    kw = {} if factors is None else dict(power_factors=factors)
    want = np.asarray(jax_ssim_multiscale(a, b, 1.0, **kw))
    got = ssim_multiscale(*_t(a, b), 1.0, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_psnr_matches_jax():
    a, b = _pair((3, 20, 17, 2), 4)
    want = np.asarray(jax_psnr(a, b, 1.0))
    np.testing.assert_allclose(psnr(*_t(a, b), 1.0).numpy(), want, rtol=1e-6)


@pytest.mark.parametrize('fn', [ssim, ssim_multiscale, fused_ssim_per_image],
                         ids=['ssim', 'ssim_multiscale', 'fused'])
def test_below_the_window_raises(fn):
    a, b = _t(*_pair((2, 10, 30, 1), 5))
    with pytest.raises(ValueError, match='smaller than the 11x11'):
        fn(a, b, 1.0)


def test_float64_stays_float64():
    """The plain version in float64 is the kernel's oracle on the card."""
    a, b = _pair((2, 16, 16, 1), 6)
    got = ssim(*_t(a.astype(np.float64), b.astype(np.float64)), 1.0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ssim(*_t(a, b), 1.0).numpy(),
                               atol=1e-6)


def test_filtering_runs_without_tf32(monkeypatch):
    """The band matmuls run with TF32 off whatever the caller set: sigma^2 =
    E[x^2] - mu^2 cancels."""
    mod = importlib.import_module('dl4ds_tpu_torch.ops.ssim')
    m = torch.backends.cuda.matmul
    name, on, off = (('fp32_precision', 'tf32', 'ieee')
                     if hasattr(m, 'fp32_precision')
                     else ('allow_tf32', True, False))
    seen = []
    tensordot = torch.tensordot
    monkeypatch.setattr(mod.torch, 'tensordot', lambda *a, **k: (
        seen.append(getattr(m, name)), tensordot(*a, **k))[1])
    saved = getattr(m, name)
    setattr(m, name, on)
    try:
        ssim(*_t(*_pair((1, 12, 12, 1), 7)), 1.0)
        assert getattr(m, name) == on
    finally:
        setattr(m, name, saved)
    assert seen == [off, off]


# ---------------------------------------------------------------------------
# The fused SSIM (K6) on the CPU: its plain path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(3, 24, 24, 1), (5, 16, 16, 1)])
def test_fused_ssim_matches_interpreted_pallas(shape):
    a, b = _pair(shape, 8)
    want = np.asarray(jax_fused_ssim_per_image(a, b, 1.0, interpret=True))
    got = fused_ssim_per_image(*_t(a, b), 1.0)
    assert tuple(got.shape) == shape[:1]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('shape', [(3, 24, 24, 1), (5, 16, 16, 1)])
def test_fused_ssim_gradients_match_jax(shape):
    """Gradients wrt both images and max_val, against jax.grad of the JAX
    `ssim` (the JAX fused wrapper's backward drops max_val's)."""
    a, b = _pair(shape, 9)
    weights = np.arange(1, shape[0] + 1, dtype=np.float32)
    want = jax.grad(lambda x, y, m: jnp.sum(jax_ssim(x, y, m) * weights),
                    argnums=(0, 1, 2))(a, b, jnp.float32(1.3))
    leaves = [torch.tensor(v, requires_grad=True)
              for v in (a, b, np.float32(1.3))]
    s = fused_ssim_per_image(*leaves)
    got = torch.autograd.grad((s * torch.from_numpy(weights)).sum(), leaves)
    for name, g, w in zip(('img1', 'img2', 'max_val'), got, want):
        _assert_grads_close(g.numpy(), w, name)


def test_fused_ssim_number_max_val_has_no_gradient():
    a, b = _pair((2, 12, 12, 1), 10)
    x = torch.tensor(a, requires_grad=True)
    g, = torch.autograd.grad(FusedSSIM.apply(x, torch.from_numpy(b), 1.0, 11,
                                             1.5, 0.01, 0.03).sum(), [x])
    want = jax.grad(lambda v: jnp.sum(jax_ssim(v, b, 1.0)))(a)
    _assert_grads_close(g.numpy(), want, 'img1')


def test_fused_ssim_cpu_tensor_launches_no_kernel():
    before = fused_ssim_per_image.launches
    fused_ssim_per_image(*_t(*_pair((2, 16, 16, 1), 11)), 1.0)
    assert fused_ssim_per_image.launches == before


@pytest.mark.parametrize('case', ['dtype', 'shape', 'taps', 'window',
                                  'max_val', 'empty'])
def test_k6_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The CUDA wrapper's checks run before anything reaches the card."""
    a, b = _t(*_pair((2, 16, 16, 1), 12))
    max_val, size, err = 1.0, 11, ValueError
    if case == 'dtype':
        a, err = a.double(), TypeError
    elif case == 'shape':
        b = b[:1]
    elif case == 'taps':
        size = 27
        a, b = _t(*_pair((1, 32, 32, 1), 13))
    elif case == 'window':
        a, b = a[:, :10], b[:, :10]
    elif case == 'max_val':
        max_val = torch.ones(2)
    else:
        a, b = a[:0], b[:0]
    with pytest.raises(err):
        _launch_ssim(a, b, max_val, size, 1.5, 0.01, 0.03)


# ---------------------------------------------------------------------------
# K6's backward: the closed form, and the launch plan of its kernels
# ---------------------------------------------------------------------------

# (shape, taps, sigma): one and three channels, a 5-D input, odd sizes, the
# smallest and the largest filters
BWD_CASES = [((3, 24, 24, 1), 11, 1.5), ((2, 16, 18, 3), 11, 1.5),
             ((2, 3, 20, 20, 1), 11, 1.5), ((2, 13, 37, 1), 3, 0.8),
             ((2, 13, 37, 3), 3, 0.8), ((2, 30, 33, 1), 25, 3.0)]


def _bwd_inputs(shape, seed):
    a, b = _pair(shape, seed)
    g = np.random.default_rng(seed + 1).random(shape[:-3]).astype(
        np.float32) + 0.5
    return a, b, g


@pytest.mark.parametrize('case', BWD_CASES)
def test_ssim_backward_reference_matches_jax_grad(case):
    """All three gradients against jax.grad of the JAX package's ssim, both
    sides in float64 (JAX with x64 on; the same float32 taps). In float32
    the images' gradients agree too; max_val's is not compared there: it
    sums S's derivatives over every position, and JAX's own float32 value
    lies 1.1e-5 of max |g| from float64 at the first case (the closed
    form's 9.7e-7)."""
    shape, k, sigma = case
    a, b, g = _bwd_inputs(shape, 20)
    with jax.enable_x64(True):
        want = jax.grad(
            lambda x, y, m: jnp.sum(jax_ssim(x, y, m, k, sigma) * g),
            argnums=(0, 1, 2))(*(np.float64(v) for v in (a, b, 1.3)))
        want = [np.asarray(w) for w in want]
    got = ssim_backward_reference(
        *(torch.as_tensor(np.float64(v)) for v in (a, b, 1.3, g)), k, sigma)
    for name, x, w in zip(('img1', 'img2', 'max_val'), got, want):
        assert w.dtype == np.float64
        np.testing.assert_allclose(x.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    want32 = jax.grad(
        lambda x, y: jnp.sum(jax_ssim(x, y, 1.3, k, sigma) * g),
        argnums=(0, 1))(a, b)
    got32 = ssim_backward_reference(*_t(a, b), 1.3, *_t(g), k, sigma,
                                    need=(True, True, False))
    for name, x, w in zip(('img1', 'img2'), got32, want32):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(w)).max(),
                                   err_msg=f'{name} in float32')


@pytest.mark.parametrize('case', BWD_CASES)
def test_ssim_backward_reference_matches_autograd_in_float64(case):
    shape, k, sigma = case
    a, b, g = (torch.from_numpy(v).double() for v in _bwd_inputs(shape, 21))
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_(),
              torch.tensor(1.3, dtype=torch.float64, requires_grad=True)]
    want = torch.autograd.grad((ssim(*leaves, k, sigma) * g).sum(), leaves)
    got = ssim_backward_reference(a, b, leaves[2].detach(), g, k, sigma)
    for name, x, w in zip(('img1', 'img2', 'max_val'), got, want):
        assert x.dtype == torch.float64
        assert (x - w).abs().max() <= 1e-12 * w.abs().max(), name


def test_ssim_backward_reference_skips_what_need_does_not_ask():
    a, b, g = _t(*_bwd_inputs((2, 16, 16, 1), 22))
    full = ssim_backward_reference(a, b, 1.0, g)
    part = ssim_backward_reference(a, b, 1.0, g, need=(False, True, False))
    assert part[0] is None and part[2] is None
    assert torch.equal(part[1], full[1])


def test_fused_ssim_cpu_backward_is_the_closed_form():
    """FusedSSIM's backward on the CPU is `ssim_backward_reference`."""
    a, b, g = _t(*_bwd_inputs((3, 20, 20, 1), 23))
    leaves = [a.clone().requires_grad_(), b.clone().requires_grad_(),
              torch.tensor(1.2, requires_grad=True)]
    got = torch.autograd.grad((fused_ssim_per_image(*leaves) * g).sum(),
                              leaves)
    want = ssim_backward_reference(a, b, torch.tensor(1.2), g)
    for x, w in zip(got, want):
        assert torch.equal(x, w)


H100_SMEM = 232448 - _STATIC_SMEM_RESERVE
K6_CHIP_CASES = ([(tuple(shape), 11) for shape in chip_smoke.K6_SHAPES]
                 + [(tuple(shape), k) for shape, k, _ in chip_smoke.K6_FILTERS])


@pytest.mark.parametrize('case', K6_CHIP_CASES)
def test_ssim_plan_covers_every_output_and_pixel_once(case):
    """The forward's and the backward's first launch cover every (image,
    output position) once, the backward's pixel tiles every (image, pixel)
    once, within the H100's shared memory."""
    shape, k = case
    plan = _ssim_plan(shape, k, H100_SMEM)
    *lead, h, w, c = shape
    n_img = int(np.prod(lead)) * c
    hv, wv = h - k + 1, w - k + 1
    th, tw = 16, 32
    for direction in ('fwd', 'bwd'):
        p = plan[direction]
        assert p['smem'] <= H100_SMEM
        seen = np.zeros((n_img, hv, wv), dtype=np.int64)
        if p['regime'] == 'image':      # block n: output n, all channels
            assert p['grid'] == plan['n_out'] and p['launches'] == 1
            for n in range(p['grid']):
                seen[n * c:(n + 1) * c] += 1
        else:
            assert p['grid'] == n_img * plan['tiles']
            for block in range(p['grid']):
                img, tile = divmod(block, plan['tiles'])
                y0 = (tile // plan['tiles_x']) * th
                x0 = (tile % plan['tiles_x']) * tw
                seen[img, y0:y0 + th, x0:x0 + tw] += 1
        assert (seen == 1).all(), (case, direction)
    pixels = np.zeros((n_img, h, w), dtype=np.int64)
    for block in range(n_img * plan['ptiles']):
        img, tile = divmod(block, plan['ptiles'])
        y0 = (tile // plan['ptiles_x']) * th
        x0 = (tile % plan['ptiles_x']) * tw
        pixels[img, y0:y0 + th, x0:x0 + tw] += 1
    assert (pixels == 1).all()


def test_ssim_plan_picks_each_regime_for_the_chip_shapes():
    """The loss's [128, 64, 64, 1] holds each image in a block both ways;
    the 512x512 grid tiles both ways (the backward in two launches)."""
    plans = {case: _ssim_plan(*case, H100_SMEM) for case in K6_CHIP_CASES}
    loss = plans[(tuple(chip_smoke.K6_SHAPES[0]), 11)]
    assert (loss['fwd']['regime'], loss['bwd']['regime']) == ('image',
                                                              'image')
    grid = plans[((8, 512, 512, 1), 11)]
    assert (grid['fwd']['regime'], grid['bwd']['regime']) == ('tiles',
                                                              'tiles')
    assert grid['bwd']['launches'] == 2
    assert {(d, p[d]['regime']) for p in plans.values()
            for d in ('fwd', 'bwd')} == set(chip_smoke.SSIM_REGIMES)


@pytest.mark.parametrize('case', ['dtype', 'shape', 'taps', 'window',
                                  'max_val', 'g_shape', 'g_type', 'empty'])
def test_k6_backward_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The backward wrapper's checks run before anything reaches the card."""
    a, b = _t(*_pair((2, 16, 16, 1), 24))
    max_val, size, g, err = torch.tensor(1.0), 11, torch.ones(2), ValueError
    if case == 'dtype':
        a, err = a.double(), TypeError
    elif case == 'shape':
        b = b[:1]
    elif case == 'taps':
        size = 27
        a, b = _t(*_pair((2, 32, 32, 1), 25))
    elif case == 'window':
        a, b = a[:, :10], b[:, :10]
    elif case == 'max_val':
        max_val = torch.ones(2)
    elif case == 'g_shape':
        g = torch.ones(3)
    elif case == 'g_type':
        g = torch.ones(2, dtype=torch.int32)
    else:
        a, b, g = a[:0], b[:0], g[:0]
    with pytest.raises(err):
        _launch_ssim_backward(a, b, max_val, g, size, 1.5, 0.01, 0.03)


# ---------------------------------------------------------------------------
# The DSSIM and MS-DSSIM losses
# ---------------------------------------------------------------------------

DSSIM_LOSSES = ['dssim', 'dssim_mae', 'dssim_mse', 'dssim_mae_mse']
MSDSSIM_LOSSES = ['msdssim', 'msdssim_mae', 'msdssim_mae_mse']


def _loss_inputs(case, shape, seed):
    """'shift': standard normal arrays (negative minima, the shift active);
    'extremes': y_pred holds both extremes of the two arrays, so the range's
    gradient flows into y_pred; 'tie': the two arrays share their maximum
    (maximum's gradient split between them)."""
    rng = np.random.default_rng(seed)
    if case == 'shift':
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))
    y_true = (0.25 + 0.5 * rng.random(shape)).astype(np.float32)
    y_pred = rng.random(shape).astype(np.float32)
    if case == 'extremes':
        y_pred.flat[3] = -1.5
        y_pred.flat[-5] = 2.0
    else:
        y_true.flat[7] = 3.0
        y_pred.flat[-9] = 3.0
    return y_true, y_pred


@pytest.mark.parametrize('case', ['shift', 'extremes', 'tie'])
@pytest.mark.parametrize('name', DSSIM_LOSSES + MSDSSIM_LOSSES)
def test_dssim_losses_match_jax(name, case):
    shape = (2, 96, 96, 1) if name.startswith('ms') else (3, 16, 16, 1)
    y_true, y_pred = _loss_inputs(case, shape, len(name))
    want, want_g = jax.value_and_grad(
        lambda p: getattr(jax_losses, name)(y_true, p))(y_pred)
    pred = torch.tensor(y_pred, requires_grad=True)
    got = getattr(tds.losses, name)(torch.from_numpy(y_true), pred)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _assert_grads_close(pred.grad.numpy(), want_g, name)
    if case == 'extremes':
        # the range's gradient reaches the two extreme pixels
        g = np.asarray(want_g).ravel()
        assert g[3] != 0 and g[-5] != 0


@pytest.mark.parametrize('name', tds.LOSS_FUNCTIONS)
def test_checkarg_loss_resolves_every_loss(name):
    assert tds.utils.checkarg_loss(name) is getattr(tds.losses, name)
