"""
Int8 post-training quantization for serving (the counterpart of
`dl4ds_tpu/quantization.py`).

`quantize_forward(model, net, calibration)` builds a quantized forward of
any network of the zoo in three steps, as the JAX package does on the
forward's jaxpr:

1. A calibration pass runs the eval forward once on the calibration batch
   and records, at every *site*, max |x| of the site's input (or
   `calibration_quantile` of |x|), read back once at the end. A site is
   one call of a `Conv` or `ConvTranspose` module, numbered in call order,
   which is the order of the JAX jaxpr's `conv_general_dilated` eqns:
   stems, blocks, 1x1 shortcuts, separable and depthwise halves, heads.
2. Every site's weight is quantized once, per output channel, in the
   dtype the JAX conv eqn sees it in (the model dtype: a bfloat16 model's
   absmax, division and rounding run in bfloat16).
3. The quantized forward runs a copy of the network whose site modules are
   replaced. In mode 'int8' each site is one call of K7
   (`ops/conv_int8.py`), one launch on the card: the input's codes at the
   site's per-tensor scale s_x (read from device memory), the s8 x s8 ->
   s32 convolution, the rescale by s_x * s_w[co] in float32, the cast to
   the model dtype and the bias after it, in the model dtype, as Flax's
   `Conv` adds it. In mode 'weight-only' each site runs its float
   convolution (cuDNN on the card) on the dequantized weight; K7 is not
   launched.

Everything else stays float, as in the JAX package: K1's gates, `Dense`,
the localized layer's einsum, norms, pixel shuffles, and each ConvLSTM
layer whole (K2 holds its input and recurrent convolutions, as the Pallas
call holds them on a TPU; the JAX package's CPU path runs that recurrence
in XLA, whose convolutions become int8 sites there: ROADMAP.md queue 3).

The quantized forward is pinned to the calibration batch's shape, as the
JAX replay is: calibrate with the batch shape you will serve.
"""

import copy
import warnings

import torch

from .inference import _serving
from .models.blocks import Conv, ConvTranspose, _transpose_pad_before
from .ops.conv_int8 import conv_int8, pack_weight

__all__ = ['quantize_forward', 'QuantizedForward']

# Below this conv width (min(Cin, Cout) of the widest conv site) the JAX
# package warns that int8 does not pay; the port keeps the condition and
# states the card's own rates: int8 `predict` grids/s over bfloat16
# `predict` grids/s of the flagship (resnet_spc x4, 16 LR grids of 128x128
# at batch 8) at n_filters 8 and 64, the range of nine runs of
# chip_smoke.py phase 20 (the host clock spreads)
_INT8_MIN_WIDTH = 64
_CARD = 'NVIDIA H100 80GB HBM3, 700.00 W'
_CARD_RATIO = {8: (0.41, 0.57), 64: (0.27, 0.32)}


def _sites(net):
    return [m for m in net.modules() if isinstance(m, (Conv, ConvTranspose))]


def _oihw_weight(site):
    """The site's kernel [Co, Cin / groups, kh, kw] in the model dtype: the
    operand of the JAX conv eqn (Flax casts the kernel to the module's
    dtype before the convolution)."""
    w = site.weight if isinstance(site, Conv) else site.kernel.permute(3, 2,
                                                                        0, 1)
    return w.detach().to(site.dtype)


def _site_width(site):
    """min(Co, Cin / groups) of the kernel, the JAX package's width proxy."""
    if isinstance(site, Conv):
        return min(site.weight.shape[:2])
    return min(site.kernel.shape[2:])


def quantize_weights(w):
    """Per-output-channel symmetric int8 codes of w [Co, ...] in w's dtype
    (`_quantize_weights`, dl4ds_tpu/quantization.py:132-141): returns
    (w_q int8, scale [Co, 1, ...] in w's dtype). The divisors are tensors
    on w's device: a CUDA division by a host scalar multiplies by its
    reciprocal, which rounds differently."""
    dims = tuple(range(1, w.dim()))
    absmax = w.abs().amax(dim=dims, keepdim=True)
    scale = (torch.maximum(absmax, absmax.new_tensor(1e-12))
             / absmax.new_tensor(127.0))
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale


def _quantile(a, q):
    """`jnp.quantile(a, q)` of a flat float32 tensor with its 'linear' rule
    at position q * (N - 1), in float32 (`torch.quantile` refuses more than
    2^24 elements, which one HR site of the flagship already holds)."""
    n = a.numel()
    pos = (torch.tensor(q, dtype=torch.float32)
           * (torch.tensor(float(n), dtype=torch.float32) - 1))
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    ordered = torch.sort(a).values
    lo = ordered[int(min(max(low.item(), 0), n - 1))]
    hi = ordered[int(min(max(high.item(), 0), n - 1))]
    return lo * w_low.to(a.device) + hi * w_high.to(a.device)


class _Int8Conv(torch.nn.Module):
    """A site module in mode 'int8': one K7 call on the input, which K7
    quantizes at the calibrated scale s_x (after its cast to the model
    dtype), convolves with the module's packed weight, rescales by s_x *
    s_w[co] into the model dtype and adds the bias to
    (dl4ds_tpu/quantization.py:276-282). A module that the forward calls n
    times (a tied upsampling stage) is n sites, each with its own s_x: its
    calls take `s_x[i]` and `scale[i]` in turn, from the cursor `call`,
    which `_reset_cursors` sets to 0 at every entry into the network.
    Buffers: `w` the packed codes, `w_scale` s_w [Co], `s_x` [n], `scale`
    s_x[i] * s_w [n, Co] in float32, `bias` in the model dtype."""

    def __init__(self, site, act_scales):
        super().__init__()
        self.dtype = site.dtype
        self.out_dtype = (torch.bfloat16 if site.dtype == torch.bfloat16
                          else torch.float32)
        w = _oihw_weight(site)
        w_q, w_scale = quantize_weights(w)
        self.kh, self.kw = w.shape[2:]
        self.transposed = isinstance(site, ConvTranspose)
        self.groups = 1 if self.transposed else site.groups
        self.register_buffer('w_scale', w_scale.float().flatten())
        s_x = torch.tensor(act_scales, dtype=torch.float32, device=w.device)
        self.register_buffer('s_x', s_x)
        self.register_buffer('scale', s_x[:, None] * self.w_scale)
        self.call = 0
        bias = getattr(site, 'bias', None)
        self.register_buffer('bias', None if bias is None
                             else bias.detach().to(self.out_dtype).clone())
        if self.transposed:
            s = site.stride
            self.stride, self.dilation = 1, s
            self.pads = []
            for k in (self.kh, self.kw):
                before = _transpose_pad_before(k, s)
                self.pads += [before, k + s - 2 - before]
        else:
            self.stride, self.dilation = site.stride, 1
            self.same = site.pad_mode == 'SAME'
            ph, pw = site.padding
            self.pads = [ph, ph, pw, pw]
        self.register_buffer('w', pack_weight(w_q, self.groups, self.stride,
                                              self.dilation))

    def _pads(self, x):
        """(top, bottom, left, right); a strided SAME conv's depend on x,
        XLA's padding split with the smaller half first (`Conv._same_pads`)."""
        if self.transposed or self.stride == 1 or not self.same:
            return self.pads
        pads = []
        for n, k in zip(x.shape[1:3], (self.kh, self.kw)):
            total = max((-(-n // self.stride) - 1) * self.stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        return pads

    def forward(self, x):
        i = self.call
        self.call = (i + 1) % len(self.s_x)
        return conv_int8(x, self.w, self.scale[i], self.kh, self.kw,
                         self.stride, self.dilation, self._pads(x),
                         self.groups, self.out_dtype, s_x=self.s_x[i],
                         bias=self.bias)


def _reset_cursors(net, args):
    """Forward pre-hook on the quantized network: every forward starts at
    each tied site's first call, whatever an earlier one left."""
    for m in net.modules():
        if isinstance(m, _Int8Conv):
            m.call = 0


def _weight_only(site):
    """A site in mode 'weight-only': the module itself on the dequantized
    weight w_q * s_w, formed in the model dtype
    (dl4ds_tpu/quantization.py:273-275) and held exactly in the float32
    parameter, so that the site's float convolution runs as before."""
    w = _oihw_weight(site)
    w_q, w_scale = quantize_weights(w)
    w_dq = (w_q.to(site.dtype) * w_scale).float()
    new = copy.deepcopy(site)
    if isinstance(site, Conv):
        new.weight.data = w_dq.contiguous(memory_format=torch.channels_last)
    else:
        new.kernel.data = w_dq.permute(2, 3, 1, 0).contiguous()
    return new


def _device(net):
    return next(net.parameters()).device


def _on(a, dev):
    return torch.as_tensor(a).to(device=dev, dtype=torch.float32)


def _check_args(model, calibration, calibration_aux, mode,
                calibration_quantile):
    """The JAX package's checks and messages (dl4ds_tpu/quantization.py:
    180-207)."""
    if mode not in ('int8', 'weight-only'):
        raise ValueError(f"mode must be 'int8' or 'weight-only', got "
                         f'{mode!r}')
    if calibration_quantile is not None and not (
            0.5 < calibration_quantile <= 1.0):
        raise ValueError('calibration_quantile must be in (0.5, 1.0]')
    has_aux = model.aux_shape is not None
    if has_aux and calibration_aux is None:
        raise ValueError('model takes an aux input; pass calibration_aux')
    mshape = tuple(model.input_shape)
    cshape = tuple(calibration.shape[1:])
    if (len(cshape) != len(mshape) or cshape[-1] != mshape[-1]
            or cshape[:-3] != mshape[:-3]):
        raise ValueError(
            f'calibration shape {cshape} incompatible with model input '
            f'shape {mshape} (rank, channels and time dims must match; '
            f'spatial dims are free)')
    if has_aux:
        ashape = tuple(calibration_aux.shape[1:])
        if (len(ashape) != len(model.aux_shape)
                or ashape[-1] != model.aux_shape[-1]):
            raise ValueError(
                f'calibration_aux shape {ashape} incompatible with model '
                f'aux shape {tuple(model.aux_shape)}')


def _warn_narrow(width):
    (a8, b8), (a64, b64) = _CARD_RATIO[8], _CARD_RATIO[64]
    warnings.warn(
        f'int8 quantization of a width-{width} model: on an {_CARD} the '
        f'int8 path serves the flagship at {a8:.2f}-{b8:.2f}x the bfloat16 '
        f'rate at width 8 and {a64:.2f}-{b64:.2f}x at width 64, SLOWER at '
        f'both (chip_smoke.py phase 20; predict(quantize=) calibrates in '
        f'every call). Expect a slowdown; use '
        f'mode=\'weight-only\' (float math, int8 storage) or serve bf16 '
        f'instead.', RuntimeWarning, stacklevel=3)


def quantize_forward(model, net, calibration, calibration_aux=None,
                     mode='int8', calibration_quantile=None):
    """Build a quantized serving forward of `net`, a network of `model`
    (`DSModel`), on `net`'s device.

    Args:
      model: the `DSModel` (any factory output).
      net: its network (`model.init(...)`, a trainer's `.net`); it is not
        changed: the quantized forward holds its own copy.
      calibration: a representative input batch [B, ...model.input_shape]
        (spatial dims free) that sets every site's activation range and
        the one input shape the quantized forward takes.
      calibration_aux: the HR-aux calibration batch, for a model with aux.
      mode: 'int8' (K7 at every site: activations per tensor, weights per
        output channel) or 'weight-only' (int8 weights dequantized, float
        convolutions).
      calibration_quantile: None for absmax ranges, or q in (0.5, 1] to
        clip each site's range at the q-quantile of |x|.

    Returns a `QuantizedForward`; call it like the network (`qf(x[,
    aux])`). An int8 model narrower than 64 (the widest site's min(Cin,
    Co)) warns, as in the JAX package, with the card's own rates.
    """
    dev = _device(net)
    calibration = _on(calibration, dev)
    aux = None if calibration_aux is None else _on(calibration_aux, dev)
    _check_args(model, calibration, aux, mode, calibration_quantile)
    has_aux = model.aux_shape is not None
    if not has_aux:
        aux = None

    # calibration: one stat a site call, stacked and read back once
    sites = _sites(net)
    stats, order = [], []

    def record(module, args):
        a = args[0].to(module.dtype).float().abs()
        stats.append(a.max() if calibration_quantile is None
                     else _quantile(a.flatten(), calibration_quantile))
        order.append(module)

    handles = [m.register_forward_pre_hook(record) for m in sites]
    try:
        with _serving(net):
            net(calibration, aux)
    finally:
        for h in handles:
            h.remove()
    if not stats:
        raise ValueError('no convolutions found in the forward — nothing '
                         'to quantize')
    width = max(_site_width(m) for m in order)
    if mode == 'int8' and width < _INT8_MIN_WIDTH:
        _warn_narrow(width)
    act_scales = [max(float(a), 1e-12) / 127.0
                  for a in torch.stack(stats).tolist()]

    names = {id(m): name for name, m in net.named_modules()}
    calls = {}
    for site, s_x in zip(order, act_scales):
        calls.setdefault(id(site), (site, []))[1].append(s_x)
    qnet = copy.deepcopy(net)
    for site, scales in calls.values():
        parent, _, child = names[id(site)].rpartition('.')
        new = (_Int8Conv(site, scales) if mode == 'int8'
               else _weight_only(site))
        setattr(qnet.get_submodule(parent), child, new)
    if mode == 'int8':
        qnet.register_forward_pre_hook(_reset_cursors)
    return QuantizedForward(
        qnet, n_sites=len(order), act_scales=act_scales, mode=mode,
        input_shape=tuple(calibration.shape),
        aux_shape=tuple(aux.shape) if has_aux else None)


class QuantizedForward:
    """Callable quantized forward. `n_sites` is the number of quantized
    convolutions, `act_scales` their calibrated activation scales (Python
    floats, site by site), `mode` 'int8' or 'weight-only', `module` the
    quantized network (what `export.export_forward(quantize=...)`
    freezes). `qf(x[, aux])` takes numpy arrays or tensors of the
    calibration batch's shape and returns the output on the network's
    device; any other shape raises ValueError."""

    def __init__(self, module, n_sites, act_scales, mode, input_shape,
                 aux_shape=None):
        self.module = module
        self.n_sites = n_sites
        self.act_scales = act_scales
        self.mode = mode
        self.input_shape = input_shape
        self.aux_shape = aux_shape

    def __call__(self, x, aux=None):
        dev = _device(self.module)
        x = _on(x, dev)
        if tuple(x.shape) != self.input_shape:
            raise ValueError(f'the quantized forward is pinned to the '
                             f'calibration shape {self.input_shape}; got '
                             f'input {tuple(x.shape)}')
        if self.aux_shape is None:
            aux = None
        else:
            if aux is None:
                raise ValueError('model takes an aux input; pass aux')
            aux = _on(aux, dev)
            if tuple(aux.shape) != self.aux_shape:
                raise ValueError(f'the quantized forward is pinned to the '
                                 f'calibration aux shape {self.aux_shape}; '
                                 f'got aux {tuple(aux.shape)}')
        with _serving(self.module):
            return self.module(x, aux)
