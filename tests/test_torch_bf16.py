"""The bfloat16 forms of the port's kernels against the JAX package on the
CPU: the same seeded numpy inputs through both, small sizes.

- K1's mixed mode (bfloat16 x, float32 y), forward and backward, against
  `channel_attention_reference` in bfloat16 and `jax.vjp` of it, eagerly,
  as the JAX model applies it: float32 values within 1e-5 of max |ref|
  (sums in another order), bfloat16 ones within 1e-2 (2 ulps).
- K2's plain bfloat16 version against the interpreted Pallas kernel
  (`fused_convlstm(..., interpret=True)`) and `convlstm_reference`; K3's and
  K4's plain versions, each route forced, against `jax.vjp` of the
  interpreted layer: within 1e-2 of max |ref|.
- The rounding points chosen against the alternatives (each gate op
  rounded; the convolution's bias after its rounding), distances printed
  with `pytest -s`.
- The kernels' bfloat16 launch plans: every output stored once, the
  m16n8k16 k-step's fragments covering a stage's k rows once, the stage
  within its shared-memory budget, and the kernels' bfloat16 arithmetic
  (exact products, float32 partials a stage, rounded at the stores)
  emulated on the CPU against the plain versions; `chip_smoke.py` phase
  12's shapes reaching every bfloat16 body.
- The wrappers take bfloat16 to the kernels and refuse float16; the route
  table's bfloat16 row.
The models, the trainer, saving and `predict` in bfloat16 are
`tests/test_torch_bf16_models.py`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu.ops.pallas_convlstm as jax_pallas_convlstm
from dl4ds_tpu.ops.pallas_ops import (
    channel_attention_reference as jax_channel_attention)

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.ops import convlstm as conv
from dl4ds_tpu_torch.ops import fused_ops as fo
from dl4ds_tpu_torch.ops.convlstm import (FusedConvLSTM, _fwd_plan, _seq_plan,
                                          _unfold, _wgrad_plan,
                                          convlstm_train_reference)
from _torch_xla import quick_xla  # noqa: F401

BF = torch.bfloat16
BF16_TOL = 1e-2      # 2 bfloat16 ulps of max |ref|
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _rel(a, b, ref):
    a, b, ref = (np.asarray(u, np.float64) for u in (a, b, ref))
    return float(np.abs(a - b).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# K1's mixed mode
# ---------------------------------------------------------------------------

def _gate_args(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    cr = max(int(c / 4), 1)
    s = (2.0 / (c + cr)) ** 0.5
    return (rng.standard_normal(shape).astype(np.float32),
            [(s * rng.standard_normal((c, cr))).astype(np.float32),
             (0.1 * rng.standard_normal(cr)).astype(np.float32),
             (s * rng.standard_normal((cr, c))).astype(np.float32),
             (0.1 * rng.standard_normal(c)).astype(np.float32)],
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize('shape', [(4, 8, 8, 16), (3, 5, 7, 5), (2, 16, 16, 8),
                                   (1, 4, 4, 40)])
def test_k1_mixed_mode_matches_jax_vjp(shape):
    """y (float32) and the five gradients of the mixed mode's plain versions
    (through `FusedChannelAttention` on the CPU) against jax.vjp of
    `channel_attention_reference` on a bfloat16 x: dx bfloat16, the weight
    gradients float32 (dw1 and dw2 bfloat16-rounded)."""
    x, w, dy = _gate_args(shape, sum(shape))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y, vjp = jax.vjp(jax_channel_attention, xb, *map(jnp.asarray, w))
    want = vjp(jnp.asarray(dy))
    assert y.dtype == jnp.float32 and want[0].dtype == jnp.bfloat16
    leaves = [torch.from_numpy(x).to(BF).requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in w]
    got = tds.fused_channel_attention(*leaves, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    got.backward(torch.from_numpy(dy))
    assert leaves[0].grad.dtype == BF
    y_np = np.asarray(y)
    assert _rel(got.detach().numpy(), y_np, y_np) <= F32_TOL
    for name, g, r in zip(('dx', 'dw1', 'db1', 'dw2', 'db2'), leaves, want):
        r = np.asarray(r.astype(jnp.float32))
        tol = F32_TOL if name in ('db1', 'db2') else BF16_TOL
        assert _rel(g.grad.float().numpy(), r, r) <= tol, name
    # the unrounded biases' gradients against the rounded weights' ones:
    # dw1 and dw2 hold bfloat16 values
    for g in (leaves[1].grad, leaves[3].grad):
        assert torch.equal(g, g.to(BF).float())


def test_k1_jitted_reference_keeps_m_w1_in_float32(capsys):
    """Under jax.jit XLA keeps the bfloat16 product m @ w1 in float32
    (excess precision inside a fusion), so the jitted gate differs from the
    eager one that the port matches exactly; rounding m alone, as the jitted
    gate does, comes within float32 sums of it. Prints the distances."""
    x, w, _ = _gate_args((4, 8, 8, 16), 0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jw = list(map(jnp.asarray, w))
    eager = np.asarray(jax_channel_attention(xb, *jw))
    jitted = np.asarray(jax.jit(jax_channel_attention)(xb, *jw))
    xt = torch.from_numpy(x).to(BF)
    wt = [torch.from_numpy(a) for a in w]
    port = fo.channel_attention_reference(xt, *wt, out_dtype=torch.float32)
    m = fo._rb(xt.float().mean(dim=(1, 2)))
    w1r, w2r = fo._weights_mixed(wt[0], wt[2])
    g = torch.sigmoid(torch.relu(m @ w1r + wt[1]) @ w2r + wt[3])
    unrounded = (xt.float() * g[:, None, None, :]).numpy()
    d_jit = _rel(port.numpy(), jitted, jitted)
    with capsys.disabled():
        print(f'\nK1 mixed, max|d|/max|y|: port against the eager reference '
              f'{_rel(port.numpy(), eager, eager):.3e}, against the jitted '
              f'one {d_jit:.3e}; m @ w1 left unrounded against the jitted '
              f'one {_rel(unrounded, jitted, jitted):.3e}')
    assert _rel(port.numpy(), eager, eager) == 0.0
    assert 0.0 < d_jit < BF16_TOL
    assert _rel(unrounded, jitted, jitted) <= F32_TOL


def test_k1_mixed_mode_plan_counts_input_and_output_bytes():
    """The block regime holds the backward's float32 dy sample too, so the
    mixed mode leaves it at a smaller sample than bfloat16 in and out, and
    its weight-gradient rows hold one more Cr-vector."""
    limits = (132, 227 * 1024 - 1024)
    shape, cr = (8, 128, 64, 12), 3          # 192 KB of float32 dy
    same = fo._ca_plan(shape, cr, BF, *limits)
    mixed = fo._ca_plan(shape, cr, BF, *limits, out_dtype=torch.float32)
    assert same['regime'] == 'block' and mixed['regime'] == 'stream'
    small = (128, 16, 16, 48)
    plan = fo._ca_plan(small, 12, BF, *limits, out_dtype=torch.float32)
    assert plan['regime'] == 'block' and plan['vec'] == 8
    assert plan['bwd_region'] == 16 * 16 * 48 * (4 + 2)   # dy and x held
    assert plan['region'] == 16 * 16 * 48 * 2
    stream = fo._ca_plan((2, 512, 512, 8), 2, BF, *limits,
                         out_dtype=torch.float32)
    assert stream['region'] == -(-4 * (2 * 8 + 3 * 2) // 16) * 16
    with pytest.raises(TypeError, match='out_dtype'):
        fo.fused_channel_attention(torch.zeros(1, 2, 2, 4), *[
            torch.zeros(s) for s in ((4, 1), (1,), (1, 4), (4,))],
            out_dtype=BF)


# ---------------------------------------------------------------------------
# K2, K3 and K4 in bfloat16
# ---------------------------------------------------------------------------

# (B, T, H, W, Cin, F, kh, kw)
CONVLSTM_SHAPES = [(2, 4, 8, 8, 1, 8, 5, 5), (2, 3, 6, 9, 3, 5, 3, 3),
                   (2, 3, 8, 8, 8, 8, 3, 5)]


def _convlstm_args(shape, seed=0):
    b, t, h, w, cin, f, kh, kw = shape
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    sx = (2.0 / (kh * kw * (cin + 4 * f))) ** 0.5
    return ([n(b, t, h, w, cin), sx * n(kh, kw, cin, 4 * f), 0.1 * n(4 * f),
             0.3 * n(kh, kw, f, 4 * f)], n(b, t, h, w, f))


@pytest.mark.parametrize('shape', CONVLSTM_SHAPES)
def test_k2_plain_bf16_matches_the_interpreted_kernel(shape):
    """ys of K2's plain bfloat16 version against the interpreted Pallas
    forward in bfloat16, and ys and cs against JAX's `convlstm_reference`
    in bfloat16; zs is bfloat16 too."""
    args, _ = _convlstm_args(shape)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    want = np.asarray(jax_pallas_convlstm.fused_convlstm(
        *jargs, interpret=True).astype(jnp.float32))
    ref_ys, ref_cs = (np.asarray(u.astype(jnp.float32)) for u in
                      jax_pallas_convlstm.convlstm_reference(*jargs))
    ys, cs, zs = convlstm_train_reference(
        *(torch.from_numpy(a).to(BF) for a in args))
    assert ys.dtype == cs.dtype == zs.dtype == BF
    assert _rel(ys.float().numpy(), want, want) <= BF16_TOL
    assert _rel(ys.float().numpy(), ref_ys, ref_ys) <= BF16_TOL
    assert _rel(cs.float().numpy(), ref_cs, ref_cs) <= BF16_TOL


@pytest.mark.parametrize('route', ['fused', 'split'])
@pytest.mark.parametrize('shape', CONVLSTM_SHAPES)
def test_k3_k4_plain_bf16_match_jax_vjp(shape, route):
    """dx, dWx, dbx and dWh of each route's plain versions in bfloat16 (K3's
    `convlstm_backward_reference`; K4's `convlstm_seq_reference` and the
    GEMM tail) against jax.vjp of the interpreted layer in bfloat16, which
    returns all four in bfloat16."""
    args, dys = _convlstm_args(shape, seed=1)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    _, vjp = jax.vjp(lambda *a: jax_pallas_convlstm.fused_convlstm(
        *a, interpret=True), *jargs)
    want = vjp(jnp.asarray(dys).astype(jnp.bfloat16))
    leaves = [torch.from_numpy(a).to(BF).requires_grad_() for a in args]
    FusedConvLSTM.apply(*leaves, route).backward(
        torch.from_numpy(dys).to(BF))
    for name, leaf, w in zip(('dx', 'dwx', 'dbx', 'dwh'), leaves, want):
        assert w.dtype == jnp.bfloat16 and leaf.grad.dtype == BF, name
        r = np.asarray(w.astype(jnp.float32))
        assert _rel(leaf.grad.float().numpy(), r, r) <= BF16_TOL, name


def test_bf16_routes_give_the_same_gradients():
    """The two routes' plain versions in bfloat16: the same chain, each
    gradient formed in float32 and rounded once, so they differ by
    rounding flips of float32 sums in another order."""
    args, dys = _convlstm_args((2, 3, 8, 8, 4, 8, 3, 3), seed=2)
    grads = {}
    for route in ('fused', 'split'):
        leaves = [torch.from_numpy(a).to(BF).requires_grad_() for a in args]
        FusedConvLSTM.apply(*leaves, route).backward(
            torch.from_numpy(dys).to(BF))
        grads[route] = [u.grad.float().numpy() for u in leaves]
    for a, b in zip(grads['fused'], grads['split']):
        assert _rel(a, b, b) <= BF16_TOL


def test_bf16_tail_is_rounded_once():
    """The tail's weight gradients are the float32 products rounded once
    to bfloat16, and its dx the float32 sum of the taps rounded once."""
    args, _ = _convlstm_args((2, 3, 6, 6, 4, 4, 3, 3), seed=3)
    x, wx, bx, wh = (torch.from_numpy(a).to(BF) for a in args)
    ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    dzs = torch.randn(zs.shape, generator=torch.Generator().manual_seed(0)
                      ).to(BF)
    dx, dwx, dbx, dwh = conv.convlstm_backward_tail(x, wx, wh, ys, dzs)
    f32 = conv.convlstm_backward_tail(x.float(), wx.float(), wh.float(),
                                      ys.float(), dzs.float())
    for got, want in zip((dx, dwx, dbx, dwh), f32):
        assert got.dtype == BF
        torch.testing.assert_close(got, want.to(BF), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# The kernels' bfloat16 plans and arithmetic
# ---------------------------------------------------------------------------

def test_bf16_mma_fragments_cover_each_k_row_once():
    """m16n8k16 with bfloat16 operands: lane quad tq reads k rows 2tq, 2tq+1
    (a0, a1, b0) and 2tq+8, 2tq+9 (a2, a3, b1) of every k-step, the kernels'
    fragment loads (`csrc/bf16_mma.cuh`): together each of the 16 rows
    once."""
    rows = sorted(k for tq in range(4) for k in (2 * tq, 2 * tq + 1,
                                                 2 * tq + 8, 2 * tq + 9))
    assert rows == list(range(16))


@pytest.mark.parametrize('shape', [(128, 4, 16, 16, 5, 5, 64),
                                   (128, 4, 16, 16, 3, 3, 8),
                                   (8, 4, 128, 128, 5, 5, 8),
                                   (2, 2, 19, 23, 7, 7, 16),
                                   (4, 2, 5, 7, 3, 3, 12)])
def test_bf16_plans_cover_every_output_within_budget(shape):
    """K2's and the chain tile's bfloat16 plans keep the float32 plans' tile
    geometry (so the float32 tests' coverage of every output holds), pad a
    stage's k rows to the 16 of an m16n8k16 step, and fit the shared-memory
    budget that leaves two blocks an SM; the weight-gradient tile padded to
    16 pixels stays within its 256."""
    b, t, h, w, kh, kw, f = shape
    for make, args, budget in (
            (_fwd_plan, (b, t, h, w, kh, kw, f, 132), conv._K2_SMEM_BUDGET),
            (_seq_plan, (b, h, w, kh, kw, f, 132), conv._SEQ_SMEM_BUDGET)):
        p32, p16 = make(*args), make(*args, elem=2)
        assert p16['kstep'] == 16 and p32['kstep'] == 8
        keys = ('th', 'tw', 'tiles', 'tiles_x', 'grid' if make is _seq_plan
                else 'input_grid', 'warps', 'm_tiles')
        assert all(p16[k] == p32[k] for k in keys)
        assert p16['smem'] <= budget
        # half the bytes an element: a stage at least as deep as float32's
        order = [(8, kh), (4, kh), (8, 1)]
        assert order.index((p16['cw'], p16['rps'])) <= order.index(
            (p32['cw'], p32['rps']))
    # the weight pass keeps its plan; its kernel pads a tile's pixels to
    # the 16 of a bfloat16 k-step within its 256-pixel tile
    wg = _wgrad_plan(b, t, 0, h, w, 8, f, kh, kw, 132)
    assert -(-wg['tph'] * wg['tpw'] // 16) * 16 <= 256


def _stage_order_conv(src, w, kh, kw, cw, rps):
    """A SAME conv of bfloat16 src [N, H, W, C] with the HWIO w as the
    kernels sum it: products exact in float32, each stage's k rows (cw
    channels x rps tap rows x kw taps, flattened (tap, channel)) summed in
    float32, the stages added to a float32 accumulator in the kernels'
    order (channel chunk, then tap rows). Returns the float32 sums."""
    n, h, wd, c = src.shape
    cols = _unfold(src.float(), kh, kw).view(n * h * wd, kh, kw, c)
    wt = w.float()
    acc = torch.zeros(n * h * wd, w.shape[-1])
    for c0 in range(0, c, cw):
        for dy in range(0, kh, rps):
            a = cols[:, dy:dy + rps, :, c0:c0 + cw].reshape(n * h * wd, -1)
            b = wt[dy:dy + rps, :, c0:c0 + cw].reshape(-1, w.shape[-1])
            acc = acc + a @ b
    return acc.view(n, h, wd, -1)


@pytest.mark.parametrize('cin,f,k', [(1, 8, 5), (8, 8, 3), (64, 64, 5),
                                     (4, 12, 7)])
def test_bf16_kernel_arithmetic_emulated(cin, f, k, capsys):
    """K2's bfloat16 scheme (the stage-ordered float32 sums of exact
    bfloat16 products, rounded where the layer stores: zx = bf(bf(conv) +
    bx), z = bf(zx_t + bf(recurrent conv)), then the plain version's
    bfloat16 gate ops) against the plain bfloat16 version, which rounds the
    same sums taken in one float32 product, held step by step (each plain
    step from the emulation's h_{t-1} and c_{t-1}): ys, cs and zs within
    BF16_TOL of max |ref| (rounding flips of float32 sums in another
    order; free-running, a flip near a gate's steep part is carried through
    the later steps, up to 1.2e-2 at 64 -> 64 5x5 over 3 steps)."""
    b, t, hh, ww = 4, 3, 16, 16
    plan = _fwd_plan(b, t, hh, ww, k, k, f, 132, elem=2)
    args, _ = _convlstm_args((b, t, hh, ww, cin, f, k, k), seed=k)
    x, wx, bx, wh = (torch.from_numpy(a).to(BF) for a in args)
    zx = _stage_order_conv(x.reshape(b * t, hh, ww, cin), wx, k, k,
                           plan['cw'], plan['rps'])
    zx = (zx.to(BF) + bx).reshape(b, t, hh, ww, 4 * f)
    h = c = x.new_zeros((b, hh, ww, f))
    ys, cs, zs = [], [], []
    for i in range(t):
        z = zx[:, i]
        if i:
            z = z + _stage_order_conv(h, wh, k, k, plan['cw'],
                                      plan['rps']).to(BF)
        zi, zf, zc, zo = torch.split(z, f, dim=-1)
        c = conv.hard_sigmoid(zf) * c + conv.hard_sigmoid(zi) * torch.tanh(zc)
        h = conv.hard_sigmoid(zo) * torch.tanh(c)
        ys.append(h)
        cs.append(c)
        zs.append(z)
    got = [torch.stack(u, dim=1) for u in (ys, cs, zs)]
    want = convlstm_train_reference(x, wx, bx, wh, states=got[:2])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == BF
        assert _rel(g.float().numpy(), w.float().numpy(),
                    w.float().numpy()) <= BF16_TOL
    free = convlstm_train_reference(x, wx, bx, wh)[0].float().numpy()
    with capsys.disabled():
        print(f'\nK2 bf16 emulated, Cin {cin} F {f} {k}x{k}: ys max|d|/'
              f'max|ref| held step by step '
              f'{_rel(got[0].float().numpy(), want[0].float().numpy(), free):.3e}, '
              f'free-running {_rel(got[0].float().numpy(), free, free):.3e}')


def test_bf16_hard_sigmoid_uses_the_bfloat16_fifth():
    """In bfloat16 the gate multiplies by 0.2 rounded to bfloat16
    (0.2001953125), as JAX's bfloat16 ops take its weakly typed 0.2."""
    z = torch.linspace(-3, 3, 97).to(BF)
    want = np.asarray(jax_pallas_convlstm._hard_sigmoid(
        jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)).astype(
            jnp.float32))
    np.testing.assert_array_equal(conv.hard_sigmoid(z).float().numpy(), want)
    want_d = np.asarray(jax_pallas_convlstm._d_hard_sigmoid(
        jnp.asarray(z.float().numpy()).astype(jnp.bfloat16)).astype(
            jnp.float32))
    np.testing.assert_array_equal(conv.d_hard_sigmoid(z).float().numpy(),
                                  want_d)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('what', ['forward', 'train', 'seq', 'backward'])
def test_convlstm_wrappers_take_bf16_to_the_kernels(what):
    """A bfloat16 layer passes every ConvLSTM wrapper's dtype check and is
    refused only for lying on the CPU (so on the card it reaches the
    bfloat16 kernels); float16 and a mix of dtypes are refused for their
    dtype."""
    args, dys = _convlstm_args((2, 3, 8, 8, 4, 8, 3, 3))
    x, wx, bx, wh = (torch.from_numpy(a).to(BF) for a in args)
    ys, cs, zs = convlstm_train_reference(x, wx, bx, wh)
    dy = torch.from_numpy(dys).to(BF)
    call = {'forward': lambda *u: conv._launch(*u),
            'train': lambda *u: conv._launch(*u, train=True),
            'seq': lambda x, wx, bx, wh: conv._launch_seq(zs.to(x.dtype),
                                                          cs.to(x.dtype),
                                                          dy.to(x.dtype), wh),
            'backward': lambda x, wx, bx, wh: conv._launch_backward(
                x, wx, wh, zs.to(x.dtype), cs.to(x.dtype), ys.to(x.dtype),
                dy.to(x.dtype))}[what]
    with pytest.raises(ValueError, match='CUDA'):
        call(x, wx, bx, wh)
    with pytest.raises(TypeError, match='item 5'):
        call(*(u.to(torch.float16) for u in (x, wx, bx, wh)))
    with pytest.raises(TypeError, match='item 5'):
        call(x, wx.float(), bx, wh.float())


@pytest.mark.parametrize('cin,f,k,f32,bf16', [
    (1, 8, 5, 'fused', 'fused'), (8, 8, 3, 'fused', 'fused'),
    (1, 32, 5, 'fused', 'fused'), (32, 32, 5, 'fused', 'fused'),
    (1, 64, 5, 'split', 'split'), (1, 64, 3, 'split', 'split'),
    (64, 64, 3, 'split', 'fused'), (64, 64, 5, 'split', 'fused'),
    (16, 72, 3, 'split', 'split')])
def test_route_table_has_a_bf16_row(cin, f, k, f32, bf16):
    """dispatch_info takes the element size, as the JAX dispatch does: the
    float32 table splits from F = 64; the bfloat16 one (PERF.md) only a
    layer narrower in than out from F = 64, since K3's bfloat16 weight pass
    beats the tail's GEMMs at 64 -> 64. The width-64 training path then
    takes both routes in bfloat16."""
    for itemsize, want in ((4, f32), (2, bf16)):
        info = conv.dispatch_info((128, 4, 16, 16, cin), (k, k, cin, 4 * f),
                                  (k, k, f, 4 * f), itemsize)
        assert info['path'] == want, (itemsize, info)


def test_route_table_refuses_other_element_sizes():
    with pytest.raises(ValueError, match='itemsize'):
        conv.dispatch_info((1, 2, 4, 4, 2), (3, 3, 2, 8), (3, 3, 2, 8), 8)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12's shapes
# ---------------------------------------------------------------------------

def test_phase12_k1_cases_run_every_mixed_body():
    """The K1 cases of `chip_smoke.py` phase 12 reach both regimes of the
    mixed mode's plan with 8- and 1-element packs at the H100's limits (132
    SMs, 227 KB less the static reserve a block), which the phase
    requires."""
    import chip_smoke
    limits = (132, 227 * 1024 - fo._STATIC_SMEM_RESERVE)
    cases = ([((chip_smoke.BATCH,) + s, max(int(s[-1] / 4), 1))
              for s in chip_smoke.K1_SHAPES]
             + [(s, max(int(s[-1] / 4), 1))
                for s in chip_smoke.K1_TRAIN_SHAPES]
             + chip_smoke.K1_OTHER_PATHS + chip_smoke.K1_MIXED_PATHS)
    seen = set()
    for shape, cr in cases:
        plan = fo._ca_plan(shape, cr, BF, *limits, out_dtype=torch.float32)
        seen.add((plan['regime'], plan['vec']))
    assert seen == {(r, v) for r in chip_smoke.CA_REGIMES for v in (8, 1)}


def test_phase12_convlstm_cases_run_every_bf16_body():
    """The ConvLSTM shapes of phase 12 run every bfloat16 body of K2 (8 or
    16 channels a block, each variant, input and step launches) and of the
    chain-step and dx tile (`chip_smoke.PLAN_BODIES`), which the phase
    requires."""
    import chip_smoke as cs
    k2 = ([(cs.BATCH, cs.REC_T, cs.LR, cs.LR) + layer
           for layer in dict.fromkeys(cs.K2_LAYERS)]
          + [(cs.BATCH, cs.REC_T, cs.K2_WIDE_LR, cs.K2_WIDE_LR) + layer
             for layer in cs.K2_WIDE]
          + [(cs.TRAIN_BATCH, cs.REC_T, cs.TRAIN_LR, cs.TRAIN_LR) + layer
             for layer in dict.fromkeys(cs.K3_LAYERS + cs.WIDE_LAYERS)])
    k2 = [(b, t, h, w, cin, f, k, k) for b, t, h, w, cin, f, k in k2]
    # both channel slices with step launches (every case runs both
    # variants, and an input launch)
    fs = {conv._fwd_plan(b, t, h, w, kh, kw, f, 132, 2)['fs']
          for b, t, h, w, cin, f, kh, kw in k2 + cs.K2_OTHER_PATHS if t > 1}
    assert fs == {8, 16}
    reached = set()
    k3 = [(cs.TRAIN_BATCH, cs.REC_T, cs.TRAIN_LR, cs.TRAIN_LR, cin, f, k, k,
           cin != 1) for cin, f, k in dict.fromkeys(cs.K3_LAYERS
                                                    + cs.WIDE_LAYERS)]
    for b, t, h, w, cin, f, kh, kw, need_dx in k3 + cs.K3_OTHER_PATHS:
        cs._note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, need_dx,
                       132, 2)
    k4 = [(cs.TRAIN_BATCH, cs.REC_T, cs.TRAIN_LR, cs.TRAIN_LR, cin, f, k, k)
          for cin, f, k in dict.fromkeys(cs.WIDE_LAYERS)]
    for b, t, h, w, cin, f, kh, kw, *_ in k4 + cs.K4_OTHER_PATHS:
        cs._note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, False,
                       132, 2, 'split')
    assert {r for r in reached
            if r[0] in ('chain', 'split chain', 'dx')} == cs.PLAN_BODIES


def test_phase6_convlstm_cases_run_every_body_and_stage():
    """The float32 shapes of phase 6 (K3's at the width-8 step, the
    width-64 forward's and its other paths; K4's at the width-64 step and
    its other paths) run every body of the chain-step and dx tile, K3's
    chain and K4's apart, and every stage kind of its plan."""
    import chip_smoke as cs
    reached = set()
    k3 = ([(cs.TRAIN_BATCH, cs.REC_T, cs.TRAIN_LR, cs.TRAIN_LR, cin, f, k, k,
            cin != 1) for cin, f, k in dict.fromkeys(cs.K3_LAYERS)]
          + [(cs.BATCH, cs.REC_T, cs.K2_WIDE_LR, cs.K2_WIDE_LR, cin, f, k, k,
              True) for cin, f, k in cs.K2_WIDE])
    for b, t, h, w, cin, f, kh, kw, need_dx in k3 + cs.K3_OTHER_PATHS:
        cs._note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, need_dx,
                       132)
    k4 = [(cs.TRAIN_BATCH, cs.REC_T, cs.TRAIN_LR, cs.TRAIN_LR, cin, f, k, k)
          for cin, f, k in dict.fromkeys(cs.WIDE_LAYERS)]
    for b, t, h, w, cin, f, kh, kw, *_ in k4 + cs.K4_OTHER_PATHS:
        cs._note_plans(conv, reached, b, t, h, w, cin, f, kh, kw, False,
                       132, route='split')
    assert reached == cs.PLAN_BODIES | cs.PLAN_STAGES


@pytest.mark.parametrize('name, counter', [
    ('void (anonymous namespace)::chain_step<float, 64>((anonymous '
     'namespace)::Args<float>)', 'K3'),
    ('void (anonymous namespace)::split_chain<__nv_bfloat16, 8>((anonymous '
     'namespace)::Args<__nv_bfloat16>)', 'K4'),
    ('void (anonymous namespace)::dx_frames<float, 16>((anonymous '
     'namespace)::Args<float>)', 'K3'),
    ('void (anonymous namespace)::dx_frames<float, 8, true>((anonymous '
     'namespace)::Args<float>)', 'K3'),
    ('void (anonymous namespace)::split_chain<float, 64, false>((anonymous '
     'namespace)::Args<float>)', 'K4'),
    ('void (anonymous namespace)::convlstm_tile<16, true, true>(...)',
     'K2-train'),
    ('void cudnn::sm90_xmma_fprop_implicit_gemm(...)', None)])
def test_device_trace_tells_k3_chain_steps_from_k4s(name, counter):
    """A device trace's kernel names give each chain step to K3 or K4 by
    the kernel's own name, whatever route the run's other layers take."""
    import chip_smoke as cs
    assert cs._kernel_counter(name) == counter


def test_phase12_expects_both_routes_on_the_bf16_width64_path():
    """In bfloat16 the width-64 path's stem layer (1 -> 64) takes the split
    route and the others K3, so phase 12 expects both K3 and K4 launches a
    step, each counted from its own kernel's name in the trace."""
    import chip_smoke as cs
    step = cs._expected_launches(conv, cs.WIDE_LAYERS, 1, 0, itemsize=2)
    assert step['K4'] == cs.REC_T
    assert step['K3'] == 5 * (cs.REC_T + 1 + 3)
    f32 = cs._expected_launches(conv, cs.WIDE_LAYERS, 1, 0)
    assert f32['K3'] == 0 and f32['K4'] == 6 * cs.REC_T


# ---------------------------------------------------------------------------
# The rounding points chosen, against the alternatives
# ---------------------------------------------------------------------------

def _gates_f32_within_step(x, wx, bx, wh):
    """K2's bfloat16 layer with the gate algebra kept in float32 inside a
    step (XLA's excess precision inside a fusion), rounding only the stored
    z, c and h: the alternative to rounding after each op."""
    b, t, h, w, cin = x.shape
    f = wh.shape[2]
    zx = conv._conv_same(x.reshape(b * t, h, w, cin), wx) + bx
    zx = zx.reshape(b, t, h, w, 4 * f)
    hh = cc = x.new_zeros((b, h, w, f))
    ys = []
    for i in range(t):
        z = (zx[:, i] + conv._conv_same(hh, wh)).float()
        zi, zf, zc, zo = torch.split(z, f, dim=-1)
        hs = lambda u: torch.clamp(0.2 * u + 0.5, 0.0, 1.0)  # noqa: E731
        c32 = hs(zf) * cc.float() + hs(zi) * torch.tanh(zc)
        cc = c32.to(BF)
        hh = (hs(zo) * torch.tanh(cc.float())).to(BF)
        ys.append(hh)
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize('shape', CONVLSTM_SHAPES)
def test_k2_rounds_each_gate_op_as_jax_does(shape, capsys):
    """Both choices for the gate algebra's rounding against JAX's bfloat16
    layer: rounding after each op (the port's) is the closer one, equal to
    it here; float32 within a step is not. Prints both distances."""
    args, _ = _convlstm_args(shape, seed=4)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    want = np.asarray(jax_pallas_convlstm.fused_convlstm(
        *jargs, interpret=True).astype(jnp.float32))
    targs = [torch.from_numpy(a).to(BF) for a in args]
    per_op = _rel(convlstm_train_reference(*targs)[0].float().numpy(), want,
                  want)
    within = _rel(_gates_f32_within_step(*targs).float().numpy(), want,
                  want)
    with capsys.disabled():
        print(f'\nK2 bf16 {shape}: max|d|/max|ref| against the interpreted '
              f'JAX kernel, rounding each gate op {per_op:.3e}, float32 '
              f'within a step {within:.3e}')
    assert per_op <= within and per_op <= 0.5 * BF16_TOL


@pytest.mark.parametrize('shape', [(8, 4, 16, 16, 1, 8, 5, 5),
                                   (8, 4, 16, 16, 8, 8, 3, 3),
                                   (4, 4, 16, 16, 64, 64, 3, 3),
                                   (4, 4, 16, 16, 1, 64, 5, 5)])
def test_differ_share_bound_tells_rounding_points_from_sum_order(
        shape, monkeypatch, capsys):
    """`chip_smoke.BF16_DIFFER_SHARE`, the share of stored bfloat16 values
    that may differ from the plain version held step by step: the plain
    layer and chain with their products summed in float64 (another sum
    order, the kernels' freedom) stay within it; the plain versions run in
    float32 with only the stored tensors rounded (float32 kept between the
    gate ops) exceed it, as `chip_smoke._check_share` requires of its
    control on the card. Prints the shares."""
    import chip_smoke as cs
    args, dys = _convlstm_args(shape, seed=11)
    x, wx, bx, wh = (torch.from_numpy(a).to(BF) for a in args)
    dys = torch.from_numpy(dys).to(BF)
    ys, cs_, zs = convlstm_train_reference(x, wx, bx, wh)
    dzs = conv.convlstm_seq_reference(zs, cs_, dys, wh)
    control = cs._differ_share(
        [u.to(BF) for u in convlstm_train_reference(
            *(u.float() for u in (x, wx, bx, wh)),
            states=(ys.float(), cs_.float()))], (ys, cs_, zs))
    chain_control = cs._differ_share(
        [conv.convlstm_seq_reference(*(u.float() for u in (zs, cs_, dys, wh)),
                                     given=dzs.float()).to(BF)], [dzs])
    monkeypatch.setattr(conv, '_acc', lambda u: u.double()
                        if u.dtype in (BF, torch.float32) else u)
    order = cs._differ_share(convlstm_train_reference(
        x, wx, bx, wh, states=(ys, cs_)), (ys, cs_, zs))
    chain_order = cs._differ_share([conv.convlstm_seq_reference(
        zs, cs_, dys, wh, given=dzs)], [dzs])
    with capsys.disabled():
        print(f'\n{shape}: stored values differing, K2 float64 sums '
              f'{order:.2e}, float32 within a step {control:.2e}; chain '
              f'{chain_order:.2e}, {chain_control:.2e}')
    assert max(order, chain_order) <= cs.BF16_DIFFER_SHARE
    assert min(control, chain_control) > cs.BF16_DIFFER_SHARE


def test_conv_bias_after_the_rounding_as_flax(capsys):
    """The port's bfloat16 Conv adds its bias after the convolution's
    rounding, as Flax's Conv does, and equals it here; a bias added before
    the rounding (inside the convolution) differs at some outputs. Prints
    both distances."""
    from dl4ds_tpu.models.blocks import Conv as JaxConv
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 16, 24)).astype(np.float32)
    jm = JaxConv(96, (3, 3), padding='SAME', dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {'params': {'kernel': v['params']['kernel'],
                    'bias': jnp.asarray(rng.standard_normal(96) * 0.3,
                                        jnp.float32)}}
    want = np.asarray(jm.apply(v, jnp.asarray(x)).astype(jnp.float32))
    tm = tds.models.blocks.Conv(24, 96, (3, 3), dtype=BF)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.asarray(
            v['params']['kernel'])).permute(3, 2, 0, 1))
        tm.bias.copy_(torch.from_numpy(np.asarray(v['params']['bias'])))
        got = tm(torch.from_numpy(x)).float().numpy()
        xb = torch.from_numpy(x).to(BF).float().permute(0, 3, 1, 2)
        fused = torch.nn.functional.conv2d(
            xb, tm.weight.to(BF).float(), tm.bias.to(BF).float(),
            padding=1).to(BF).float().permute(0, 2, 3, 1).numpy()
    after, before = _rel(got, want, want), _rel(fused, want, want)
    with capsys.disabled():
        print(f'\nbf16 Conv against Flax: bias after the rounding '
              f'{after:.3e} ({int((got != want).sum())} outputs differ), '
              f'before it {before:.3e} ({int((fused != want).sum())} of '
              f'{want.size})')
    assert after == 0.0 and before > 0.0


def test_float64_layer_routes_as_float32():
    """A float64 layer (the CPU reference the chip checks run) takes its
    gradient on the float32 row of the route table."""
    args, dys = _convlstm_args((1, 2, 4, 4, 2, 4, 3, 3))
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in args]
    conv.fused_convlstm(*leaves).backward(torch.from_numpy(dys).double())
    assert all(u.grad.dtype == torch.float64 for u in leaves)
