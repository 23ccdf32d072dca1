"""The port's `count_flops` (`dl4ds_tpu_torch/ops/flops.py`) against the JAX
package's (`dl4ds_tpu/ops/flops.py`) on the CPU: the cases of
tests/test_flops.py (a matmul, a convolution, a depthwise one, a loop, a
gradient step) and a stride-2 transposed convolution count alike; the
flagship's forward, its mae and dssim_mae steps at a small width and
recresnet_spc's step at width 8 (the 'fused' BPTT route) and 64 (the
'split' route) count exactly what the JAX `count_flops` counts of the same
model on the same inputs, and an int8 forward what it counts of its int8
replay. Each hand-written kernel counts its formula, not 0 and not its
plain version's products on top: the three operators, K1's backward, K2's
training variant with either backward route, and K6 both ways; a forced
route does not change a count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dl4ds_tpu as dds
import dl4ds_tpu_torch as tds
from dl4ds_tpu import quantization as jquant
from dl4ds_tpu.ops.flops import count_flops as jax_count
from dl4ds_tpu_torch import quantization as tquant
from dl4ds_tpu_torch.ops import flops
from dl4ds_tpu_torch.ops.convlstm import (FusedConvLSTM, _convlstm_op,
                                          dispatch_info)
from dl4ds_tpu_torch.ops.fused_ops import (_channel_attention_op,
                                           fused_channel_attention,
                                           fused_ssim_per_image)
from dl4ds_tpu_torch.ops.conv_int8 import conv_int8, pack_weight
from dl4ds_tpu_torch.weights import export_jax_params
from _torch_xla import quick_xla  # noqa: F401

count = flops.count_flops


def _conv_nhwc(x, w, stride=1, groups=1):
    """SAME correlation of NHWC x with an HWIO w, as the JAX tests' conv."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding='same' if stride == 1 else 1,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _jax_conv(x, w, groups=1):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), 'SAME', feature_group_count=groups,
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'))


def test_matmul_flops():
    a, b = torch.zeros(64, 32), torch.zeros(32, 16)
    got = count(lambda: a @ b)
    assert got == jax_count(lambda x, y: x @ y, jnp.zeros((64, 32)),
                            jnp.zeros((32, 16))) == 2 * 64 * 32 * 16


@pytest.mark.parametrize('cin,cout,groups', [(3, 16, 1), (4, 4, 4)])
def test_conv_flops(cin, cout, groups):
    x, w = (2, 8, 8, cin), (3, 3, cin // groups, cout)
    got = count(lambda: _conv_nhwc(torch.zeros(x), torch.zeros(w),
                                   groups=groups))
    want = jax_count(lambda a, b: _jax_conv(a, b, groups), jnp.zeros(x),
                     jnp.zeros(w))
    assert got == want == 2 * (2 * 8 * 8 * cout) * 9 * (cin // groups)


def test_loop_counts_each_trip():
    """The JAX scan's body times its trip count; the port's loop runs."""
    a = torch.zeros(16, 16)

    def loop():
        c = a
        for _ in range(5):
            c = c @ a
        return c

    def scan(a):
        return jax.lax.scan(lambda c, _: (c @ a, None), a, None,
                            length=5)[0]
    assert count(loop) == jax_count(scan, jnp.zeros((16, 16))) \
        == 5 * 2 * 16 ** 3


def test_grad_step_counts_backward_convs():
    x = torch.zeros(2, 8, 8, 4)
    w = torch.zeros(3, 3, 4, 4, requires_grad=True)
    fwd = count(lambda: _conv_nhwc(x, w))

    def step(x, w):
        (_conv_nhwc(x, w) ** 2).mean().backward()
    assert count(step, x, w) == 2 * fwd        # fwd + dw
    assert count(step, x.clone().requires_grad_(), w) == 3 * fwd
    jfwd = jax_count(_jax_conv, jnp.zeros((2, 8, 8, 4)),
                     jnp.zeros((3, 3, 4, 4)))
    jstep = jax_count(lambda x, w: jax.value_and_grad(
        lambda x, w: jnp.mean(_jax_conv(x, w) ** 2), argnums=(0, 1))(x, w),
        jnp.zeros((2, 8, 8, 4)), jnp.zeros((3, 3, 4, 4)))
    assert (fwd, 3 * fwd) == (jfwd, jstep)


def test_transposed_conv_counts_as_jax():
    """Stride 2, SAME: the JAX count divides by the input dilation, the
    port's counts over the input grid; the same number, both ways."""
    x = torch.zeros(2, 6, 6, 3, requires_grad=True)
    w = torch.zeros(3, 5, 4, 4, requires_grad=True)     # Cin, Cout, kh, kw

    def fwd(x, w):
        return F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2,
                                  padding=1)

    def jfwd(x, w):
        return jax.lax.conv_transpose(x, w, (2, 2), 'SAME',
                                      dimension_numbers=('NHWC', 'HWIO',
                                                         'NHWC'))
    jx, jw = jnp.zeros((2, 6, 6, 3)), jnp.zeros((4, 4, 3, 5))
    want = 2 * (2 * 6 * 6) * 16 * 3 * 5
    assert count(fwd, x, w) == jax_count(jfwd, jx, jw) == want
    step = count(lambda: fwd(x, w).square().mean().backward())
    jstep = jax_count(lambda x, w: jax.grad(
        lambda x, w: jnp.mean(jfwd(x, w) ** 2), argnums=(0, 1))(x, w),
        jx, jw)
    assert step == jstep == 3 * want


def _pair(recurrent, width, lr=16):
    kw = dict(scale=4, n_channels=1, n_aux_channels=0, lr_size=(lr, lr),
              n_filters=width, n_blocks=2, attention=True)
    if recurrent:
        kw.update(time_window=3, n_blocks=1)
        factory = 'recnet_postupsampling'
    else:
        factory = 'net_postupsampling'
    m = getattr(tds, factory)('resnet', 'spc', **kw)
    jm = getattr(dds, factory)('resnet', 'spc', **kw)
    net = m.init(0, device='cpu')
    return m, jm, net, export_jax_params(net)


def _arrays(m, batch):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, *m.input_shape)).astype('float32')
    hr = x.shape[:-3] + tuple(4 * s for s in x.shape[-3:-1]) + (1,)
    return x, rng.standard_normal(hr).astype('float32')


def _jax_step(jm, loss):
    jloss = getattr(dds.losses, loss)
    return lambda p, x, y: jax.value_and_grad(lambda p: jloss(
        y, jm.module.apply({'params': p}, x, None, training=True)))(p)


def _step(net, loss):
    def step(x, y):
        getattr(tds.losses, loss)(y, net(x, None)).backward()
    return step


@pytest.mark.parametrize('recurrent,width,losses', [
    (False, 8, ('mae', 'dssim_mae')), (True, 8, ('mae',)),
    (True, 64, ('mae',))])
def test_model_counts_are_the_jax_counts(recurrent, width, losses):
    m, jm, net, params = _pair(recurrent, width, lr=8 if recurrent else 16)
    x, y = _arrays(m, 2)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    fwd = jax_count(lambda p, x: jm.module.apply({'params': p}, x, None,
                                                 training=False), params, x)
    with torch.no_grad():
        assert count(net, tx, None) == fwd
    assert count(net, tx, None) == fwd          # with grad mode on
    if recurrent:
        f = width
        route = dispatch_info((2, 3, 8, 8, f), (3, 3, f, 4 * f),
                              (3, 3, f, 4 * f))['path']
        assert route == ('split' if width >= 64 else 'fused')
    for loss in losses:
        assert count(_step(net, loss), tx, ty) == \
            jax_count(_jax_step(jm, loss), params, x, y), loss


def test_int8_forward_counts_as_the_jax_replay():
    m, jm, net, params = _pair(False, 8)
    x, _ = _arrays(m, 2)
    with pytest.warns(RuntimeWarning, match='width-16'):
        qf = tquant.quantize_forward(m, net, torch.from_numpy(x))
    with pytest.warns(RuntimeWarning, match='width-16'):
        jqf = jquant.quantize_forward(jm, {'params': params}, x)
    got = count(qf, torch.from_numpy(x))
    assert got == jax_count(jqf, x) == count(net, torch.from_numpy(x), None)


def test_each_kernel_counts_its_formula():
    """Exactly the formula: a plain version counted on top (the CPU's
    products, which the dispatch mode sees) would add to it."""
    rng = np.random.default_rng(1)

    def t(*shape, grad=False):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            requires_grad=grad)
    # K1: the operator forward, the Function backward
    x, w1, b1, w2, b2 = t(3, 5, 6, 8, grad=True), t(8, 2), t(2), t(2, 8), \
        t(8)
    gate = flops.gate_flops(x.shape, w1.shape)
    assert gate == 2 * 2 * 3 * 8 * 2
    assert count(_channel_attention_op, x.detach(), w1, b1, w2, b2,
                 False) == gate
    assert count(lambda: fused_channel_attention(
        x, w1, b1, w2, b2).sum().backward()) == gate + 2 * gate
    # without the formulas the CPU would count K1's plain backward: five
    # products (m @ w1 again, then dw2, dh, dw1, dm), JAX's AD four
    with flops.FlopCounterMode(display=False) as naive:
        fused_channel_attention(x, w1, b1, w2, b2).sum().backward()
    assert naive.get_total_flops() == gate + 5 * gate // 2
    # K6 both ways: the formula alone, the plain version hidden
    a, b = t(2, 16, 18, 1), t(2, 16, 18, 1, grad=True)
    ssim = flops.ssim_flops(a.shape, 11)
    assert ssim == 2 * 5 * 2 * (18 * 6 * 16 + 6 * 8 * 18)
    assert count(fused_ssim_per_image, a, b.detach(), 1.0) == ssim
    assert count(lambda: fused_ssim_per_image(a, b, 1.0).sum().backward()
                 ) == 2 * ssim
    # K2: the inference operator, the training variant and either route
    xs, wx, bx, wh = t(2, 3, 6, 6, 2, grad=True), t(3, 3, 2, 16, grad=True), \
        t(16), t(3, 3, 4, 16, grad=True)
    k2 = flops.convlstm_flops(xs.shape, wx.shape)
    assert k2 == 2 * 2 * 6 * 6 * 16 * 9 * 3 * (2 + 4)
    assert count(_convlstm_op, xs.detach(), wx.detach(), bx,
                 wh.detach()) == k2
    for need_dx in (True, False):
        bwd = flops.convlstm_flops(xs.shape, wx.shape, True, need_dx)
        assert bwd == 2 * 2 * 6 * 6 * 16 * 9 * (
            3 * 2 * (2 if need_dx else 1) + 5 * 4)
        xin = xs if need_dx else xs.detach()
        for route in ('fused', 'split'):
            assert count(lambda: FusedConvLSTM.apply(
                xin, wx, bx, wh, route).sum().backward()) == k2 + bwd
    # K7: the operator
    xq = torch.randint(-127, 128, (2, 7, 7, 3), dtype=torch.int8)
    wq = pack_weight(torch.randint(-127, 128, (5, 3, 3, 3),
                                   dtype=torch.int8))
    y = conv_int8(xq, wq, torch.ones(5), 3, 3, pads=(1, 1, 1, 1))
    assert count(conv_int8, xq, wq, torch.ones(5), 3, 3, pads=(1, 1, 1, 1)) \
        == flops.conv_int8_flops(xq.shape, y.shape, 3, 3, 1) \
        == 2 * 2 * 7 * 7 * 5 * 9 * 3


def test_kernel_flops_does_nothing_outside_a_count():
    with flops.FlopCounterMode(display=False) as mode:
        with flops.kernel_flops(10 ** 9):
            torch.zeros(4, 4) @ torch.zeros(4, 4)
    assert mode.get_total_flops() == 2 * 4 ** 3
    assert not flops._COUNTS
