"""The port's int8 post-training quantization (`dl4ds_tpu_torch.quantization`,
the int8 convolution K7 in `ops/conv_int8.py`) against the JAX package's
(`dl4ds_tpu.quantization`) on the CPU, with the same weights: drawn by the
port from a seed and carried to the Flax tree by `export_jax_params` (no
JAX init compile), and the same numpy inputs.

- K7's plain version against `lax.conv_general_dilated(...,
  preferred_element_type=jnp.int32)` on the same int8 codes: the int32 sums
  equal, the float32 and bfloat16 rescaled outputs equal bit for bit.
- The weight codes and scales against `_quantize_weights`, exactly.
- `quantize_forward` against JAX's for five models: the same number of
  sites, the activation scales within rtol 1e-5 site by site (absmax and
  the 0.999 quantile), the int8 output within 5% of JAX's own int8 error
  (rel(port, jax_int8) <= 0.05 * rel(jax_int8, jax_f32), `rel` as in
  tests/test_quantization.py), weight-only within 1e-5 of max |y|. The
  recurrent model is held against the JAX model on its Pallas path, as a
  TPU runs it: a stand-in for `jax` in `dl4ds_tpu.models.blocks` answers
  'tpu' from `default_backend()`, so `ConvLSTM2D` calls `fused_convlstm`
  (in interpret mode, which its own module picks); the port's ConvLSTM is
  K2 on every device and its recurrence stays float.
- bfloat16 int8 against JAX's replay compiled with XLA's excess precision
  off, which rounds every bfloat16 op as its eager replay does (with it
  on, XLA's fusions keep bfloat16 intermediates in float32 and move the
  jitted replay farther from the eager one than int8's own error).
- `predict(quantize=)`, tiled too, against JAX's, and its ValueErrors.
- An int8 serving artifact served by `ModelServer` against `predict`.
- The narrow-width warning.

Small sizes (n_filters 8, grids of 8-16 pixels); the JAX references are
built once, in a module fixture, and the replays are jitted where their
float32 result equals the eager one.
"""

import contextlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import dl4ds_tpu as dds
import dl4ds_tpu.models.blocks as jblocks
from dl4ds_tpu import quantization as jquant

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import export as texport
from dl4ds_tpu_torch import quantization as tquant
from dl4ds_tpu_torch.ops import conv_int8 as tci
from dl4ds_tpu_torch.serve import ModelServer

from _torch_xla import quick_xla  # noqa: F401

OUT_SHARE = 0.05       # rel(port, jax_int8) over rel(jax_int8, jax_f32)
SCALE_RTOL = 1e-5      # act_scales: calibration replays the float forward
WO_REL = 1e-5          # weight-only: max |d| over max |y_jax|
K7_OP = 'dl4ds_tpu_torch.conv_int8.default'

# name: (factory, kwargs); one calibration batch of 2 each
MODELS = {
    'resnet_spc': ('net_postupsampling', dict(
        backbone_block='resnet', upsampling='spc', scale=2, n_channels=3,
        n_aux_channels=1, lr_size=(8, 8), n_filters=8, n_blocks=1,
        attention=True)),
    'convnet_pin': ('net_pin', dict(
        backbone_block='convnet', n_channels=1, n_aux_channels=0,
        hr_size=(16, 16), n_filters=8, n_blocks=1)),
    'unet_pin': ('unet_pin', dict(
        backbone_block='unet', n_channels=1, n_aux_channels=1,
        hr_size=(16, 16), n_filters=8, n_blocks=2)),
    # the 'dc' head (ConvTranspose) and ConvNeXt's depthwise 7x7
    'convnext_dc': ('net_postupsampling', dict(
        backbone_block='convnext', upsampling='dc', scale=2, n_channels=1,
        n_aux_channels=0, lr_size=(8, 8), n_filters=8, n_blocks=1)),
    'recresnet_spc': ('recnet_postupsampling', dict(
        backbone_block='resnet', upsampling='spc', scale=2, n_channels=1,
        n_aux_channels=0, lr_size=(8, 8), time_window=3, n_filters=8,
        n_blocks=1)),
}
WEIGHT_ONLY = ['resnet_spc', 'convnext_dc']


def _rel(a, b):
    a, b = np.asarray(a, 'float32'), np.asarray(b, 'float32')
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.std(b) + 1e-12))


def _np(y):
    return (y.float().numpy() if torch.is_tensor(y)
            else np.asarray(jnp.asarray(y, jnp.float32)))


class _TpuBackend:
    """`jax` as `dl4ds_tpu.models.blocks` sees it, but on a TPU: its
    `ConvLSTM2D` then takes the Pallas kernel."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return 'tpu'


@contextlib.contextmanager
def _jax_side(name):
    """A context in which the JAX model `name` runs as on a TPU (the
    recurrent one on its Pallas path), else nothing."""
    with pytest.MonkeyPatch.context() as m:
        if name.startswith('rec'):
            m.setattr(jblocks, 'jax', _TpuBackend())
        yield


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        yield


class _Refs:
    """The pairs and the JAX references, each computed once."""

    def __init__(self):
        self.cache = {}

    def _memo(self, key, fn):
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]

    def pair(self, name, dtype=None):
        """(JAX model, variables, port model, net, x, aux)."""
        def make():
            factory, kw = MODELS[name]
            jkw, tkw = dict(kw), dict(kw)
            if dtype is not None:
                jkw['dtype'], tkw['dtype'] = jnp.bfloat16, torch.bfloat16
            jm = getattr(dds, factory)(**jkw)
            tm = getattr(tds, factory)(**tkw)
            params = tds.weights.export_jax_params(tm.init(0, device='cpu'))
            variables = {'params': jax.tree_util.tree_map(jnp.asarray,
                                                          params)}
            net = tds.load_jax_params(tm.init(1, device='cpu'), params)
            rng = np.random.default_rng(len(name))
            x = rng.standard_normal((2, *tm.input_shape)).astype(np.float32)
            aux = (rng.standard_normal((2, *tm.aux_shape)).astype(np.float32)
                   if tm.aux_shape is not None else None)
            return jm, variables, tm, net, x, aux
        return self._memo(('pair', name, dtype), make)

    def jax_quant(self, name, mode='int8', quantile=None):
        """JAX's `QuantizedForward` of model `name`."""
        def make():
            jm, variables, _, _, x, aux = self.pair(name)
            with _jax_side(name):
                return jquant.quantize_forward(
                    jm, variables, x, calibration_aux=aux, mode=mode,
                    calibration_quantile=quantile)
        return self._memo(('quant', name, mode, quantile), make)

    def jax_replay(self, name, mode='int8'):
        """Its output on the calibration batch, the replay jitted."""
        def make():
            qf = self.jax_quant(name, mode)
            _, _, _, _, x, aux = self.pair(name)
            with _jax_side(name):
                if aux is None:
                    return _np(jax.jit(qf)(x))
                return _np(jax.jit(lambda a, b: qf(a, b))(x, aux))
        return self._memo(('replay', name, mode), make)

    def jax_float(self, name):
        def make():
            jm, variables, _, _, x, aux = self.pair(name)
            with _jax_side(name):
                fn = jax.jit(lambda a, b: jm.module.apply(variables, a, b,
                                                          training=False))
                return _np(fn(x, aux))
        return self._memo(('float', name), make)


@pytest.fixture(scope='module')
def refs():
    return _Refs()


# --- K7's plain version and the weight codes ------------------------------

def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# name: (x shape, OIHW weight shape, stride, groups, transposed stride)
K7_SITES = {
    '3x3': ((2, 6, 7, 5), (6, 5, 3, 3), 1, 1, None),
    '1x1': ((2, 5, 5, 8), (16, 8, 1, 1), 1, 1, None),
    'strided_same': ((2, 7, 9, 4), (8, 4, 3, 3), 2, 1, None),
    'depthwise_7x7': ((1, 9, 9, 4), (4, 1, 7, 7), 1, 4, None),
    'transposed_dc': ((1, 5, 4, 3), (4, 3, 9, 9), 1, 1, 2),
}


def _jax_int8_conv(x, w_oihw, stride, groups, transposed):
    """XLA's s8 convolution of the JAX int8 replay, int32 sums."""
    w = jnp.asarray(np.transpose(w_oihw, (2, 3, 1, 0)))          # HWIO
    dn = ('NHWC', 'HWIO', 'NHWC')
    if transposed:
        return lax.conv_transpose(jnp.asarray(x), w, (transposed,) * 2,
                                  'SAME', dimension_numbers=dn,
                                  preferred_element_type=jnp.int32)
    return lax.conv_general_dilated(
        jnp.asarray(x), w, (stride,) * 2, 'SAME', dimension_numbers=dn,
        feature_group_count=groups, preferred_element_type=jnp.int32)


def _site_module(w_oihw, stride, groups, transposed):
    """The port's Conv or ConvTranspose with that kernel (float32)."""
    co, ci, kh, kw = w_oihw.shape
    if transposed:
        m = tds.models.blocks.ConvTranspose(ci, co, (kh, kw), transposed)
        m.kernel.data = torch.from_numpy(
            np.transpose(w_oihw, (2, 3, 1, 0)).astype(np.float32))
    else:
        m = tds.models.blocks.Conv(ci * groups, co, (kh, kw), groups=groups,
                                   strides=stride)
        m.weight.data = torch.from_numpy(w_oihw.astype(np.float32))
    return m


@pytest.mark.parametrize('site', list(K7_SITES))
def test_k7_plain_equals_jax_s8_conv(site):
    """The same int8 codes give the same int32 sums, and the same float32
    and bfloat16 outputs bit for bit after the rescale (s_x * s_w[co] in
    float32, one multiply, the cast), at the geometry the port's site
    module computes (`_Int8Conv`: SAME, strided SAME, depthwise, the
    transposed convolution as a dilated correlation)."""
    xs, ws, stride, groups, transposed = K7_SITES[site]
    rng = np.random.default_rng(7)
    x, w = _codes(rng, xs), _codes(rng, ws)
    s_x = np.float32(0.0123)
    w_scale = (rng.random(ws[0]) * 1e-2).astype(np.float32)
    want = np.asarray(_jax_int8_conv(x, w, stride, groups, transposed))
    site_mod = tquant._Int8Conv(_site_module(w, stride, groups, transposed),
                                [float(s_x)])
    xt = torch.from_numpy(x)
    args = (site_mod.kh, site_mod.kw, site_mod.stride, site_mod.dilation,
            site_mod._pads(xt), site_mod.groups)
    wp = tci.pack_weight(torch.from_numpy(w), groups, site_mod.stride,
                         site_mod.dilation)
    scale = torch.tensor(s_x) * torch.from_numpy(w_scale)
    sums = tci.conv_int8_reference(xt, wp, scale, *args,
                                   out_dtype=torch.int32)
    assert sums.dtype == torch.int32
    np.testing.assert_array_equal(sums.numpy(), want)
    jscale = jnp.asarray(s_x) * jnp.asarray(w_scale)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tci.conv_int8(xt, wp, scale, *args, out_dtype=dtype)
        ref = np.asarray((jnp.asarray(want).astype(jnp.float32)
                          * jscale).astype(jdtype).astype(jnp.float32))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), ref)


# the fused site: (x dtype, site dtype, bias)
FUSED = {
    'f32': ('float32', 'float32', False),
    'f32_bias': ('float32', 'float32', True),
    'bf16_bias': ('bfloat16', 'bfloat16', True),
    'f32_into_bf16': ('float32', 'bfloat16', True),
}
_DT = {'float32': (torch.float32, jnp.float32),
       'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def _activation(rng, shape, s_x):
    """Normal values that clip past 127 s_x, and exact halves k + 1/2 of a
    power-of-two s_x, which round to even."""
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    halves = (rng.integers(-130, 130, shape) + 0.5) * s_x
    return np.where(rng.random(shape) < 0.3, halves, x).astype(np.float32)


def _jax_fused(x, w, stride, groups, transposed, s_x, w_scale, bias, site):
    """The JAX int8 replay at one site (dl4ds_tpu/quantization.py:276-282),
    eagerly: the site's input in the model dtype, its codes
    `jnp.round(x.astype(f32) / s_x)` clipped, the s8 convolution, the
    rescale cast to the model dtype, then Flax's bias in the model dtype."""
    jd = _DT[site][1]
    xv = jnp.asarray(x).astype(jd)
    s = jnp.asarray(s_x, jnp.float32)
    x_q = jnp.clip(jnp.round(xv.astype(jnp.float32) / s), -127,
                   127).astype(jnp.int8)
    acc = _jax_int8_conv(np.asarray(x_q), w, stride, groups, transposed)
    y = (acc.astype(jnp.float32) * (s * jnp.asarray(w_scale))).astype(jd)
    if bias is not None:
        y = y + jnp.asarray(bias).astype(jd)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize('case', list(FUSED))
@pytest.mark.parametrize('site', list(K7_SITES))
def test_k7_fused_plain_equals_jax_replay(site, case):
    """The fused site (`_Int8Conv` on a float activation: the codes, the
    sums, the rescale and the bias in one K7 call) equals the JAX replay's
    quantization, s8 convolution, rescale and bias bit for bit, in
    float32 and bfloat16, a float32 input to a bfloat16 site rounded to
    bfloat16 first."""
    xs, ws, stride, groups, transposed = K7_SITES[site]
    x_dt, site_dt, with_bias = FUSED[case]
    rng = np.random.default_rng(17)
    w = _codes(rng, ws)
    s_x = 2.0 ** -5
    x = _activation(rng, xs, s_x)
    bias = (rng.standard_normal(ws[0]) * 0.5).astype(np.float32)
    mod = _site_module(w.astype(np.float32), stride, groups, transposed)
    if with_bias:    # a ConvTranspose site has none of its own
        mod.bias = torch.nn.Parameter(torch.from_numpy(bias))
    else:
        bias = None
        mod.bias = None
    mod.dtype = _DT[site_dt][0]
    site_mod = tquant._Int8Conv(mod, [s_x])
    w_scale = site_mod.w_scale.numpy()
    xt = torch.from_numpy(x).to(_DT[x_dt][0])
    w_q = tci._unpack(site_mod.w, ws[0], xs[-1], *ws[2:], site_mod.groups,
                      site_mod.stride, site_mod.dilation).numpy()
    want = _jax_fused(np.asarray(xt.float()), w_q, stride, groups,
                      transposed, s_x, w_scale, bias, site_dt)
    got = site_mod(xt)
    assert got.dtype == _DT[site_dt][0] and site_mod.call == 0
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_tied_site_second_call_takes_its_own_scale():
    """A module called twice is two sites: the second call quantizes at
    s_x[1] and rescales by scale[1], as the JAX replay's next site."""
    xs, ws, stride, groups, transposed = K7_SITES['3x3']
    rng = np.random.default_rng(23)
    w = _codes(rng, ws)
    mod = _site_module(w.astype(np.float32), stride, groups, transposed)
    mod.bias.data = torch.from_numpy(rng.standard_normal(ws[0]).astype(
        np.float32))
    scales = [2.0 ** -5, 0.0173]
    site_mod = tquant._Int8Conv(mod, scales)
    w_q = tci._unpack(site_mod.w, ws[0], ws[1], 3, 3, 1).numpy()
    x0, x1 = (_activation(rng, xs, 2.0 ** -5) for _ in range(2))
    first = site_mod(torch.from_numpy(x0))
    assert site_mod.call == 1
    second = site_mod(torch.from_numpy(x1))
    assert site_mod.call == 0
    for x, s, got in ((x0, scales[0], first), (x1, scales[1], second)):
        want = _jax_fused(x, w_q, stride, groups, transposed, s,
                          site_mod.w_scale.numpy(), mod.bias.detach().numpy(),
                          'float32')
        np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(first, site_mod(torch.from_numpy(x1)))


def _phase_sums(x, packed, co, kh, kw, pads, d):
    """The dense kernel's sums of a transposed site, phase by phase, from
    the packed weight (csrc/conv_int8.cu `conv_s8_dense`): output phase
    (py, px) reads the tap class (ry, rx) = ((pad - p) mod d), its taps
    (i, j) at input (q + off + i), over the undilated input."""
    b, h, wd, cin = x.shape
    lay = tci._layout(cin, co, kh, kw, 1, d)
    ho = tci.conv_out_size(h, kh, 1, d, pads[0], pads[1])
    wo = tci.conv_out_size(wd, kw, 1, d, pads[2], pads[3])
    out = np.zeros((b, ho, wo, co), np.int64)
    xp = np.asarray(x, np.int64)
    wk = np.asarray(packed, np.int64)
    for py in range(d):
        for px in range(d):
            ry, rx = (pads[0] - py) % d, (pads[2] - px) % d
            khc, kwc = -(-(kh - ry) // d), -(-(kw - rx) // d)
            oy0, ox0 = (py + ry - pads[0]) // d, (px + rx - pads[2]) // d
            rows = wk[(ry * d + rx) * lay.co_pad:][:co]
            for qy in range(-(-(ho - py) // d)):
                for qx in range(-(-(wo - px) // d)):
                    acc = np.zeros((b, co), np.int64)
                    for i in range(khc):
                        for j in range(kwc):
                            iy, ix = qy + oy0 + i, qx + ox0 + j
                            if not (0 <= iy < h and 0 <= ix < wd):
                                continue
                            ks = [(ci // lay.cc) * lay.kcp
                                  + (i * kwc + j) * lay.cc + ci % lay.cc
                                  for ci in range(cin)]
                            acc += xp[:, iy, ix] @ rows[:, ks].T
                    out[:, qy * d + py, qx * d + px] = acc
    return out


@pytest.mark.parametrize('kernel, d', [((9, 9), 2), ((4, 4), 2), ((7, 5), 3),
                                       ((3, 3), 4)])
def test_transposed_packing_by_phase(kernel, d):
    """`pack_weight` of a transposed site keeps each residue class of taps
    (ky mod d, kx mod d) in rows of its own; unpacked, it gives back the
    kernel of the dilated form, which the plain version correlates; and
    the kernel's phase split over those rows, emulated, gives the plain
    version's sums."""
    kh, kw = kernel
    rng = np.random.default_rng(d)
    co, cin = 5, 3
    w = torch.from_numpy(_codes(rng, (co, cin, kh, kw)))
    packed = tci.pack_weight(w, 1, 1, d)
    lay = tci._layout(cin, co, kh, kw, 1, d)
    assert packed.shape == (d * d * lay.co_pad, lay.n_chunks * lay.kcp)
    np.testing.assert_array_equal(
        tci._unpack(packed, co, cin, kh, kw, 1, 1, d).numpy(), w.numpy())
    for ry in range(d):
        for rx in range(d):
            rows = packed[(ry * d + rx) * lay.co_pad:][:lay.co_pad]
            taps = (-(-(kh - ry) // d)) * (-(-(kw - rx) // d))
            assert int((rows != 0).sum()) == int(
                (w[:, :, ry::d, rx::d] != 0).sum())
            assert not rows[:, taps * lay.cc:lay.kcp].any()
    x = torch.from_numpy(_codes(rng, (2, 4, 5, cin)))
    before = [_transpose_before(k, d) for k in kernel]
    pads = (before[0], kh + d - 2 - before[0], before[1],
            kw + d - 2 - before[1])
    want = tci.conv_int8_reference(x, packed, torch.ones(co), kh, kw, 1, d,
                                   pads, out_dtype=torch.int32).numpy()
    np.testing.assert_array_equal(
        _phase_sums(x.numpy(), packed.numpy(), co, kh, kw, pads, d), want)


def _transpose_before(k, s):
    from dl4ds_tpu_torch.models.blocks import _transpose_pad_before
    return _transpose_pad_before(k, s)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_weight_codes_equal_jax(dtype):
    """Per-output-channel codes and scales equal `_quantize_weights` in
    the dtype the conv eqn sees the kernel in (a bfloat16 model's absmax,
    /127 and rounding in bfloat16), for a 3x3, a depthwise and a
    transposed kernel."""
    rng = np.random.default_rng(3)
    jd, td = ((jnp.float32, torch.float32) if dtype == 'float32'
              else (jnp.bfloat16, torch.bfloat16))
    for shape in ((8, 5, 3, 3), (6, 1, 7, 7), (4, 8, 9, 9)):
        w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        w[0] = 0.0                              # the 1e-12 floor
        jw = jnp.asarray(np.transpose(w, (2, 3, 1, 0))).astype(jd)   # HWIO
        want_q, want_s = jquant._quantize_weights(jw, (3, 2, 0, 1))
        got_q, got_s = tquant.quantize_weights(torch.from_numpy(w).to(td))
        assert got_s.dtype == td
        np.testing.assert_array_equal(
            got_q.numpy(), np.transpose(np.asarray(want_q), (3, 2, 0, 1)))
        np.testing.assert_array_equal(
            got_s.float().numpy().ravel(),
            np.asarray(want_s.astype(jnp.float32)).ravel())


def test_conv_int8_operator_and_guards():
    """`dl4ds_tpu_torch::conv_int8` passes `torch.library.opcheck` (its
    fake kernel and schema) on int8 codes and on a fused site (a float x
    with s_x and a bias); shapes K7 does not take raise ValueError, a float
    x without s_x and codes with one TypeError; a CUDA wrapper is never
    reached here."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_codes(rng, (2, 6, 6, 4)))
    wq = torch.from_numpy(_codes(rng, (8, 4, 3, 3)))
    scale = torch.rand(8)
    args = (x, tci.pack_weight(wq), scale, 3, 3, 1, 1, [1, 1, 1, 1], 1,
            torch.float32)
    torch.library.opcheck(tci._conv_int8_op, args)
    before = tci.conv_int8.launches
    y = tci.conv_int8(*args)
    assert y.shape == (2, 6, 6, 8) and tci.conv_int8.launches == before
    grouped = torch.from_numpy(_codes(rng, (8, 18)))
    with pytest.raises(ValueError, match='groups'):
        tci.pack_weight(torch.from_numpy(_codes(rng, (8, 2, 3, 3))), 2)
    for bad in (dict(groups=2, w=grouped), dict(pads=(1, 1, 1)),
                dict(w=tci.pack_weight(wq)[:, :16])):
        kw = dict(w=tci.pack_weight(wq), pads=(1, 1, 1, 1), groups=1)
        kw.update(bad)
        with pytest.raises(ValueError):
            tci.conv_int8(x, kw['w'], scale, 3, 3, 1, 1, kw['pads'],
                          kw['groups'])
    with pytest.raises(TypeError):
        tci.conv_int8(x.float(), tci.pack_weight(wq), scale, 3, 3)
    s_x, bias = torch.tensor(0.02), torch.rand(8)
    fused = (x.float(), tci.pack_weight(wq), scale, 3, 3, 1, 1, [1, 1, 1, 1],
             1, torch.float32, s_x, bias)
    torch.library.opcheck(tci._conv_int8_op, fused)
    assert tci.conv_int8(*fused).shape == (2, 6, 6, 8)
    with pytest.raises(TypeError, match='s_x'):
        tci.conv_int8(x, tci.pack_weight(wq), scale, 3, 3, s_x=s_x)
    for out_dtype, b in ((torch.int32, bias), (torch.bfloat16, bias),
                         (torch.float32, bias[:4])):
        with pytest.raises(ValueError, match='bias'):
            tci.conv_int8(x.float(), tci.pack_weight(wq), scale, 3, 3,
                          out_dtype=out_dtype, s_x=s_x, bias=b)


# --- quantize_forward against JAX's --------------------------------------

def _port_quant(refs, name, mode='int8', quantile=None):
    def make():
        _, _, tm, net, x, aux = refs.pair(name)
        qf = tds.quantize_forward(tm, net, x, calibration_aux=aux, mode=mode,
                                  calibration_quantile=quantile)
        return qf, _np(qf(x, aux))
    return refs._memo(('port', name, mode, quantile), make)


@pytest.mark.parametrize('quantile', [None, 0.999], ids=['absmax', 'q999'])
@pytest.mark.parametrize('name', list(MODELS))
def test_sites_and_scales_equal_jax(refs, name, quantile):
    """The sites (one a call of a Conv or ConvTranspose module, in call
    order) are the JAX jaxpr's conv eqns, in its order: the same count and
    the same activation scale site by site."""
    want = refs.jax_quant(name, quantile=quantile)
    qf, _ = _port_quant(refs, name, quantile=quantile)
    assert qf.n_sites == want.n_sites
    np.testing.assert_allclose(qf.act_scales, want.act_scales,
                               rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize('name', list(MODELS))
def test_int8_output_within_quantization_error(refs, name):
    """Equal sums and rescales at every site; only the float work between
    sites rounds differently, which may flip a code at a rounding
    boundary: the port lies within 5% of JAX's own int8 error."""
    y_q = refs.jax_replay(name)
    _, got = _port_quant(refs, name)
    y_f = refs.jax_float(name)
    assert got.shape == y_q.shape
    ratio = _rel(got, y_q) / _rel(y_q, y_f)
    print(f'{name}: rel(port, jax_int8) / rel(jax_int8, jax_f32) = '
          f'{ratio:.3e} (jax int8 error {_rel(y_q, y_f):.4f})')
    assert ratio <= OUT_SHARE


@pytest.mark.parametrize('name', WEIGHT_ONLY)
def test_weight_only_matches_jax(refs, name):
    """Exact codes dequantized in the model dtype, float convolutions: as
    close as the float models."""
    want = refs.jax_replay(name, mode='weight-only')
    qf, got = _port_quant(refs, name, mode='weight-only')
    assert qf.mode == 'weight-only'
    assert np.abs(got - want).max() <= WO_REL * np.abs(want).max()


def test_bf16_int8_matches_jax(refs):
    """tests/test_quantization.py's bfloat16 case: the output in the model
    dtype, the weight codes formed in bfloat16, the rescale cast to
    bfloat16 before the bias add; against JAX's replay with every bfloat16
    op rounded."""
    kw = dict(backbone_block='resnet', upsampling='spc', scale=2,
              n_channels=1, n_aux_channels=0, lr_size=(4, 4), n_filters=8,
              n_blocks=1, attention=True)
    jm = dds.net_postupsampling(**kw, dtype=jnp.bfloat16)
    jm32 = dds.net_postupsampling(**kw)
    tm = tds.net_postupsampling(**kw, dtype=torch.bfloat16)
    params = tds.weights.export_jax_params(tm.init(0, device='cpu'))
    variables = {'params': jax.tree_util.tree_map(jnp.asarray, params)}
    net = tds.load_jax_params(tm.init(1, device='cpu'), params)
    x = np.random.default_rng(0).standard_normal((2, 4, 4, 1)).astype(
        np.float32)
    jqf = jquant.quantize_forward(jm, variables, x)
    # every bfloat16 op rounded, as the eager replay rounds (XLA's excess
    # precision would keep fused intermediates in float32): equal to it
    y_q = jax.jit(jqf).lower(x).compile(
        compiler_options={'xla_allow_excess_precision': False})(x)
    y_f = jax.jit(lambda a: jm32.module.apply(variables, a, None,
                                              training=False))(x)
    qf = tds.quantize_forward(tm, net, x)
    got = qf(x)
    assert got.dtype == torch.bfloat16 and y_q.dtype == jnp.bfloat16
    np.testing.assert_allclose(qf.act_scales, jqf.act_scales,
                               rtol=SCALE_RTOL, atol=0)
    ratio = _rel(_np(got), _np(y_q)) / _rel(_np(y_q), _np(y_f))
    print(f'bfloat16 int8: ratio {ratio:.3e}')
    assert ratio <= OUT_SHARE


def test_quantize_forward_errors_equal_jax(refs):
    """The mode, the quantile range, aux, the calibration's shape: JAX's
    ValueErrors and messages; the input pinned to the calibration
    shape (JAX's replay fails at run time, the port raises ValueError)."""
    jm, variables, tm, net, x, aux = refs.pair('resnet_spc')
    cases = [dict(mode='int4'), dict(calibration_quantile=0.4),
             dict(calibration_aux=None),
             dict(calibration=x[..., :1]),
             dict(calibration_aux=aux[..., :0].copy())]
    for case in cases:
        kw = dict(calibration=x, calibration_aux=aux)
        kw.update(case)
        calib = kw.pop('calibration')
        with pytest.raises(ValueError) as want:
            jquant.quantize_forward(jm, variables, calib, **kw)
        with pytest.raises(ValueError) as got:
            tds.quantize_forward(tm, net, calib, **kw)
        assert str(got.value) == str(want.value)
    qf, _ = _port_quant(refs, 'resnet_spc')
    with pytest.raises(ValueError, match='pinned'):
        qf(x[:1], aux[:1])
    with pytest.raises(ValueError, match='aux'):
        qf(x)


# --- predict, tiled predict and artifacts ---------------------------------

N_GRIDS, BATCH = 5, 2


@pytest.fixture(scope='module')
def grids():
    rng = np.random.default_rng(11)
    hr = rng.standard_normal((N_GRIDS, 16, 16)).astype(np.float32)
    topo = rng.standard_normal((16, 16)).astype(np.float32)
    pred = rng.standard_normal((N_GRIDS, 16, 16, 1)).astype(np.float32)
    calib = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    calib_aux = rng.standard_normal((1, 16, 16, 1)).astype(np.float32)
    return hr, topo, pred, calib, calib_aux


def _predict_kw(grids, **extra):
    _, topo, pred = grids[:3]
    return dict(dict(scale=2, array_in_hr=True, static_vars=[topo],
                     predictors=[pred], batch_size=BATCH), **extra)


PREDICT_CASES = {
    # the first batch of the input, a partial last batch (5 at batch 2),
    # quantile ranges
    'default_remainder_quantile': lambda g: dict(
        quantize='int8', calibration_quantile=0.999),
    # one calibration sample cycled up to the batch, with its aux
    'calibration_cycled_aux': lambda g: dict(
        quantize='int8', calibration=g[3], calibration_aux=g[4]),
    # calibrated on the first batch of the padded input, then cropped
    'weight_only_pad_to_multiple': lambda g: dict(
        quantize='weight-only', pad_to_multiple=12),
}


@pytest.mark.parametrize('case', list(PREDICT_CASES))
def test_predict_int8_matches_jax(refs, grids, case):
    jm, variables, tm, net, _, _ = refs.pair('resnet_spc')
    opts = PREDICT_CASES[case](grids)
    kw = _predict_kw(grids, **opts)
    want = dds.predict((jm, variables), grids[0], **kw)
    got = tds.predict((tm, net), grids[0], device='cpu', **kw)
    assert got.shape == want.shape == (N_GRIDS, 16, 16, 1)
    if opts['quantize'] == 'weight-only':
        assert np.abs(got - want).max() <= WO_REL * np.abs(want).max()
        return
    y_f = dds.predict((jm, variables), grids[0], **_predict_kw(grids))
    ratio = _rel(got, want) / _rel(want, y_f)
    print(f'predict {case}: ratio {ratio:.3e}')
    assert ratio <= OUT_SHARE


def test_predictor_passes_quantize_through(refs, grids):
    _, _, tm, net, _, _ = refs.pair('resnet_spc')
    kw = _predict_kw(grids, quantize='int8', calibration=grids[3],
                     calibration_aux=grids[4])
    kw['array_in_hr'] = True
    np.testing.assert_array_equal(
        tds.Predictor((tm, net), grids[0], device='cpu', **kw).run(),
        tds.predict((tm, net), grids[0], device='cpu', **kw))


PREDICT_ERRORS = {
    'spatial_mesh': dict(quantize='int8', spatial_mesh=object()),
    'mesh_untiled': dict(quantize='int8', mesh=object()),
    'tile_calibration': dict(quantize='int8', tile=4, calibration=1),
    'calibration_alone': dict(calibration=1),
    'both_meshes': dict(spatial_mesh=object(), mesh=object()),
    'calibration_layout': dict(quantize='int8', calibration='bad'),
    'calibration_aux_missing': dict(quantize='int8', calibration='ok'),
    'calibration_aux_layout': dict(quantize='int8', calibration='ok',
                                   calibration_aux='bad'),
}


@pytest.mark.parametrize('case', list(PREDICT_ERRORS))
def test_predict_int8_errors_equal_jax(refs, grids, case):
    """JAX's five argument checks in its order, and its checks of the
    calibration batches, with its messages."""
    jm, variables, tm, net, _, _ = refs.pair('resnet_spc')
    calib, calib_aux = grids[3], grids[4]
    given = {'bad': calib[..., :1], 'ok': calib, 1: calib}
    opts = dict(PREDICT_ERRORS[case])
    if 'calibration' in opts:
        opts['calibration'] = given[opts['calibration']]
    if 'calibration_aux' in opts:
        opts['calibration_aux'] = calib_aux[..., :0].copy()
    kw = _predict_kw(grids, **opts)
    with pytest.raises(ValueError) as want:
        dds.predict((jm, variables), grids[0], **kw)
    with pytest.raises(ValueError) as got:
        tds.predict((tm, net), grids[0], device='cpu', **kw)
    assert str(got.value) == str(want.value)


def test_tiled_int8_matches_jax(refs):
    """Calibrated on the first dispatch batch of real windows, the
    windows wrap-padded to a whole number of dispatches (9 windows of a
    10x12 grid at tile 4, 8x8 with their halo, at batch 2: 5 dispatches,
    the last padded)."""
    jm, variables, tm, net, _, _ = refs.pair('resnet_spc')
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 10, 12, 3)).astype(np.float32)
    aux = rng.standard_normal((1, 20, 24, 1)).astype(np.float32)
    from dl4ds_tpu import parallel as jpar
    kw = dict(aux=aux, tile=4, halo=2, batch_size=2)
    want = jpar.predict_tiled(jm, variables, x, quantize='int8', **kw)
    got = tds.parallel.predict_tiled(tm, net, x, quantize='int8', **kw)
    # the float tiled output: the port's equals JAX's within 1e-4
    # (tests/test_torch_parallel.py)
    y_f = tds.parallel.predict_tiled(tm, net, x, **kw)
    assert got.shape == want.shape == (1, 20, 24, 1)
    ratio = _rel(got, want) / _rel(want, y_f)
    print(f'tiled int8: ratio {ratio:.3e}')
    assert ratio <= OUT_SHARE
    with pytest.raises(ValueError, match='mode'):
        tds.parallel.predict_tiled(tm, net, x, quantize='int4', **kw)


def _graph_ops(path):
    ep = torch.export.load(os.path.join(path, texport.FORWARD_FILE))
    return [str(n.target) for n in ep.graph.nodes
            if n.op == 'call_function']


def test_int8_artifact_serves_as_predict(refs, grids, tmp_path):
    """`save_serving_artifact(quantize='int8', batch=b, calibration=...)`
    freezes K7 as `dl4ds_tpu_torch::conv_int8` nodes, one a site;
    `ModelServer` pads and chunks 1 and b + 1 samples to the pinned batch,
    and answers as `predict(quantize='int8')` with the same calibration."""
    _, _, tm, net, _, _ = refs.pair('resnet_spc')
    hr, topo, pred = grids[:3]
    b = 3
    rng = np.random.default_rng(2)
    calib = rng.standard_normal((b, 8, 8, 3)).astype(np.float32)
    calib_aux = rng.standard_normal((b, 16, 16, 1)).astype(np.float32)
    path = str(tmp_path / 'int8')
    size = tds.save_serving_artifact(tm, net, path, batch=b, quantize='int8',
                                     calibration=calib,
                                     calibration_aux=calib_aux)
    assert size > 0
    qf = tds.quantize_forward(tm, net, calib, calibration_aux=calib_aux)
    assert _graph_ops(path).count(K7_OP) == qf.n_sites
    server = ModelServer(path)
    assert server.meta['quantize'] == 'int8' and server.batch == b
    assert server.health()['quantize'] == 'int8'
    assert server.meta['input_shape'] == [8, 8, 3]
    kw = _predict_kw(grids, quantize='int8', calibration=calib,
                     calibration_aux=calib_aux, batch_size=b)
    y = tds.predict((tm, net), hr[:b + 1], device='cpu',
                    **dict(kw, predictors=[pred[:b + 1]]))
    lr, aux, _ = tds.inference._assemble_inputs(
        tm, hr[:b + 1], 2, True, [topo], [pred[:b + 1]], None, 'inter_area',
        torch.device('cpu'))
    for n in (1, b + 1):
        got = server.predict(lr[:n].numpy(), aux[:n].numpy())
        assert got.shape == (n, 16, 16, 1)
        assert np.abs(got - y[:n]).max() <= 1e-5 * np.abs(y).max()
    assert server.n_device_batches == 2


def test_int8_export_refusals_equal_jax(refs):
    jm, variables, tm, net, x, aux = refs.pair('resnet_spc')
    from dl4ds_tpu import export as jexport
    for opts in (dict(batch=2), dict(batch='poly', calibration=x),
                 dict(batch=3, calibration=x),
                 dict(batch=2, calibration=x, spatial_size=(8, 8))):
        kw = dict(quantize='int8', calibration_aux=aux, **opts)
        with pytest.raises(ValueError) as want:
            jexport.export_forward(jm, variables, **kw)
        with pytest.raises(ValueError) as got:
            texport.export_forward(tm, net, **kw)
        assert str(got.value).replace('dl4ds_tpu_torch', 'dl4ds_tpu') == \
            str(want.value)


def test_narrow_width_warning():
    """tests/test_quantization.py's case: int8 at width 8 warns (with the
    card's measured rates, no TPU figure), weight-only and width 64 do
    not."""
    model = tds.net_pin('convnet', n_channels=1, n_aux_channels=0,
                        hr_size=(16, 16), n_filters=8, n_blocks=1)
    net = model.init(0, device='cpu')
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 1)).astype(
        np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter('always')
        with pytest.warns(RuntimeWarning, match='width-8') as record:
            tds.quantize_forward(model, net, x)
    text = str(record[0].message)
    assert 'H100' in text and 'TPU' not in text and 'v5e' not in text
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tds.quantize_forward(model, net, x, mode='weight-only')
    wide = tds.net_pin('convnet', n_channels=1, n_aux_channels=0,
                       hr_size=(8, 8), n_filters=64, n_blocks=1)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        tds.quantize_forward(wide, wide.init(0, device='cpu'),
                             x[:1, :8, :8])


def test_cached_matrices_made_while_serving_still_train():
    """Serving (int8 or float, under inference mode) may be the first to
    build the resize matrices of an 'rc' head or U-Net decoder and SSIM's
    band matrices, which are cached; training then saves them for
    backward, which an inference-mode tensor refuses (the int8 U-Net here
    followed by tests/test_torch_pin.py's unet_pin trainer in one process
    raised it)."""
    from dl4ds_tpu_torch.interpolation import resize2d
    from dl4ds_tpu_torch.ops.ssim import ssim
    with torch.inference_mode():
        resize2d(torch.zeros(1, 5, 7, 1), (10, 14), 'bicubic')
        ssim(torch.rand(1, 13, 13, 1), torch.rand(1, 13, 13, 1), 1.0)
    x = torch.rand(1, 5, 7, 1, requires_grad=True)
    resize2d(x, (10, 14), 'bicubic').sum().backward()
    a = torch.rand(1, 13, 13, 1, requires_grad=True)
    ssim(a, torch.rand(1, 13, 13, 1), 1.0).sum().backward()
    assert x.grad is not None and a.grad is not None


def test_every_forward_starts_at_the_first_site():
    """A tied x4 'spc' stage is two sites; its cursor is reset at every
    entry into the quantized network, so a direct call of `qf.module`
    after a forward that stopped partway takes the first site's scale
    again and equals `qf(x)`."""
    model = tds.net_postupsampling('resnet', 'spc', scale=4, n_channels=1,
                                   n_aux_channels=0, lr_size=(4, 4),
                                   n_filters=8, n_blocks=1)
    net = model.init(0, device='cpu')
    x = np.random.default_rng(0).standard_normal((2, 4, 4, 1)).astype(
        np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        qf = tds.quantize_forward(model, net, x)
    tied = [m for m in qf.module.modules()
            if isinstance(m, tquant._Int8Conv) and len(m.s_x) > 1]
    assert len(tied) == 1 and qf.n_sites == len(
        [s for m in qf.module.modules() if isinstance(m, tquant._Int8Conv)
         for s in m.s_x])
    want = _np(qf(x))
    tied[0].call = 1                    # as a failed forward leaves it
    with torch.no_grad():
        got = _np(qf.module.eval()(torch.from_numpy(x), None))
    np.testing.assert_array_equal(got, want)
    assert tied[0].call == 0
