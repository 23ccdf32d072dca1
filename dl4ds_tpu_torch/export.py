"""
Frozen serving artifacts through `torch.export` (the counterpart of
`dl4ds_tpu/export.py`).

`export_forward` traces a network's eval forward, weights included, into a
`torch.export.ExportedProgram`, by default with a symbolic batch, so that
one artifact serves any batch size. The hand-written kernels stay in it as
operator nodes: K1's gate as `dl4ds_tpu_torch::channel_attention`, K2's
inference variant as `dl4ds_tpu_torch::convlstm` (`ops/fused_ops.py`,
`ops/convlstm.py`), and in an int8 artifact (`quantize='int8'`) K7, the
int8 convolution, as `dl4ds_tpu_torch::conv_int8` (`ops/conv_int8.py`), at
every site of `quantization.quantize_forward`; their fake kernels let the
trace through without a launch, and the artifact launches the kernels each
time it runs on the card.
`save_serving_artifact` writes `forward.pt2` (`torch.export.save`) and
`serving_meta.json` into a directory, `load_serving_artifact` reads them
back into a callable, which `serve.ModelServer` serves without the
model-building code.

An artifact is specialised to the device of the network it was traced
from: the models branch on the device (a bfloat16 convolution on the CPU is
taken in float32 and rounded once, as XLA's CPU convolution), and a CUDA
artifact holds the kernels' nodes at every batch, the symbolic one too. The
JAX package lowers for chosen platforms instead; `platforms` here may only
name the network's own device.
"""

import json
import os

import numpy as np
import torch

# (importing the models registers the operators that an artifact names:
# the kernels' in ops/, K7's among them, the fixed-member dropout draw in
# models/blocks.py)
from .models.blocks import LocalizedConvBlock
from .parallel import _net_device
from .utils import resolve_device

__all__ = ['export_forward', 'save_serving_artifact',
           'load_serving_artifact']

FORWARD_FILE = 'forward.pt2'
META_FILE = 'serving_meta.json'
# the example batch the symbolic batch is traced at (0 and 1 specialise)
_TRACE_BATCH = 2


def _signature(model, spatial_size):
    """The per-sample input and aux shapes, with `spatial_size` (h, w) in
    place of the model's LR grid and aux on the HR grid scaled to match
    (dl4ds_tpu/export.py:88-101)."""
    in_shape = tuple(model.input_shape)
    aux_shape = (tuple(model.aux_shape)
                 if model.aux_shape is not None else None)
    if spatial_size is not None:
        h, w = map(int, spatial_size)
        in_shape = (*in_shape[:-3], h, w, in_shape[-1])
        if aux_shape is not None:
            s = model.aux_shape[-3] // model.input_shape[-3]
            aux_shape = (h * s, w * s, aux_shape[-1])
    return in_shape, aux_shape


def export_forward(model, net, batch='poly', platforms=None,
                   spatial_size=None, quantize=None, calibration=None,
                   calibration_aux=None, calibration_quantile=None):
    """Export `net`'s eval forward as a `torch.export.ExportedProgram`.

    Args:
      model: the `DSModel` (any factory output).
      net: its network; its weights are held in the program.
      batch: 'poly' for a symbolic batch (one artifact, any batch size), or
        an int for a static batch.
      platforms: None, or a list naming `net`'s device type ('cuda' or
        'cpu'); the artifact runs there. Any other raises ValueError.
      spatial_size: optional (h, w) in place of the model's LR grid: the
        models are fully convolutional, so a patch-trained model exports a
        full-grid artifact (the aux input is scaled to match). A model with
        a `LocalizedConvBlock` is bound to its grid and raises ValueError.
      quantize: None (the float forward), or 'int8' or 'weight-only' to
        freeze the quantized forward of `quantization.quantize_forward`,
        calibrated on `calibration` (with `calibration_aux` for a model
        with aux, and `calibration_quantile`). It is pinned to the
        calibration batch's shape, which is the artifact's signature: `batch`
        must equal its batch (ModelServer pads and chunks requests to it),
        'poly' and `spatial_size` raise (dl4ds_tpu/export.py:112-153). The
        `calibration*` arguments are read with `quantize` alone, and
        ignored without it, as in the JAX package.

    The input (and aux) is float32; the output has the dtype of `net`'s
    forward (a bfloat16 model's, as the JAX artifact's). The trace runs in
    eval mode with grad off (an 'mc*' dropout keeps its fixed member, K2
    its inference variant); the caller's mode comes back after. Call the
    program with `ep.module()(x[, aux])`, save it with `torch.export.save`.
    """
    device = _net_device(net)
    if platforms is not None and list(platforms) != [device.type]:
        raise ValueError(f'platforms={list(platforms)!r}: an artifact runs on '
                         f"the network's own device, {[device.type]!r} (it "
                         f'is traced there); move the network first')
    if quantize is not None:
        return _export_quantized(model, net, batch, spatial_size, quantize,
                                 calibration, calibration_aux,
                                 calibration_quantile)
    if spatial_size is not None and any(
            isinstance(m, LocalizedConvBlock) for m in net.modules()):
        raise ValueError(f'spatial_size={tuple(spatial_size)}: {model.name} '
                         f'has a LocalizedConvBlock, whose weights are bound '
                         f'to the grid of its training')
    if batch == 'poly':
        b = _TRACE_BATCH
        dim = torch.export.Dim('batch', min=1)
    else:
        b, dim = int(batch), None
    in_shape, aux_shape = _signature(model, spatial_size)
    args = (torch.zeros((b, *in_shape), device=device),)
    if aux_shape is not None:
        args += (torch.zeros((b, *aux_shape), device=device),)
    dynamic = (tuple({0: dim} for _ in args) if dim is not None else None)
    was_training = net.training
    net.eval()
    try:
        # grad off, not inference mode: inference tensors cannot be traced
        with torch.inference_mode(False), torch.no_grad():
            return torch.export.export(net, args, dynamic_shapes=dynamic)
    finally:
        net.train(was_training)


def _shape(a):
    """The shape of a numpy array, a tensor (on any device) or nested
    lists."""
    return tuple(a.shape) if hasattr(a, 'shape') else np.shape(a)


def _export_quantized(model, net, batch, spatial_size, mode, calibration,
                      calibration_aux, calibration_quantile):
    """Freeze the int8 or weight-only forward at the calibration batch's
    shape, with the JAX package's checks (dl4ds_tpu/export.py:112-153)."""
    from .quantization import quantize_forward
    if calibration is None:
        raise ValueError(f"quantize={mode!r} needs a calibration batch "
                         "(it defines the pinned export shapes)")
    if spatial_size is not None:
        raise ValueError('spatial_size cannot combine with quantize=; the '
                         'calibration array defines the export shapes '
                         '(calibrate on full grids to export a full-grid '
                         'artifact)')
    n = _shape(calibration)[0]
    if batch == 'poly':
        raise ValueError(
            "the int8 replay is shape-pinned (reshape sites pin the batch "
            f"size): pass batch=calibration.shape[0] (= {n}) and serve at "
            "that batch (dl4ds_tpu_torch.serve pads/chunks requests to a "
            "pinned batch)")
    if int(batch) != n:
        raise ValueError(f'batch={batch} != calibration batch {n}; the '
                         f'quantized replay serves exactly the calibration '
                         f'shape')
    qf = quantize_forward(model, net, calibration,
                          calibration_aux=calibration_aux, mode=mode,
                          calibration_quantile=calibration_quantile)
    device = _net_device(net)
    args = (torch.zeros(qf.input_shape, device=device),)
    if qf.aux_shape is not None:
        args += (torch.zeros(qf.aux_shape, device=device),)
    qf.module.eval()
    with torch.inference_mode(False), torch.no_grad():
        return torch.export.export(qf.module, args)


def save_serving_artifact(model, net, path, batch='poly', platforms=None,
                          spatial_size=None, quantize=None, calibration=None,
                          calibration_aux=None, calibration_quantile=None):
    """Export (`export_forward`) and write `path/forward.pt2` and
    `path/serving_meta.json`: the JAX meta's keys (`name`, `input_shape`,
    `aux_shape`, `batch`, `platforms`, `quantize`) with `torch_version` in
    place of `jax_version`; a quantized artifact's shapes are those of the
    calibration arrays. Returns the artifact's size in bytes."""
    ep = export_forward(model, net, batch=batch, platforms=platforms,
                        spatial_size=spatial_size, quantize=quantize,
                        calibration=calibration,
                        calibration_aux=calibration_aux,
                        calibration_quantile=calibration_quantile)
    os.makedirs(path, exist_ok=True)
    forward = os.path.join(path, FORWARD_FILE)
    torch.export.save(ep, forward)
    in_shape, aux_shape = _signature(model, spatial_size)
    if quantize is not None:
        # the calibration arrays are the exported signature
        in_shape = _shape(calibration)[1:]
        if calibration_aux is not None:
            aux_shape = _shape(calibration_aux)[1:]
    meta = {
        'name': model.name,
        'input_shape': list(in_shape),
        'aux_shape': list(aux_shape) if aux_shape is not None else None,
        'batch': batch,
        'platforms': [_net_device(net).type],
        'torch_version': torch.__version__,
        'quantize': quantize,
    }
    with open(os.path.join(path, META_FILE), 'w') as fh:
        json.dump(meta, fh, indent=2)
    return os.path.getsize(forward)


def load_serving_artifact(path, device=None):
    """Read a `save_serving_artifact` directory. Returns (call, meta):
    `call(x[, aux])` takes numpy arrays or tensors (as float32) and returns
    the frozen forward's output, a tensor on the artifact's device; `meta`
    is the saved JSON dict.

    The artifact runs on the device it was exported from: `device` (None:
    that one) must be of its type. A CUDA artifact without a GPU raises, as
    does a JAX package's artifact (`forward.jaxexport`)."""
    forward = os.path.join(path, FORWARD_FILE)
    if not os.path.isfile(forward):
        if os.path.isfile(os.path.join(path, 'forward.jaxexport')):
            raise ValueError(f'{path} holds a JAX artifact '
                             f'(forward.jaxexport, dl4ds_tpu.export); serve '
                             f'it with dl4ds_tpu.serve, or export the model '
                             f'again with dl4ds_tpu_torch.export')
        raise FileNotFoundError(f'{path}: no {FORWARD_FILE}')
    with open(os.path.join(path, META_FILE)) as fh:
        meta = json.load(fh)
    kind = meta['platforms'][0]
    target = resolve_device(kind if device is None else device)
    if target.type != kind:
        raise ValueError(f'{path} is a {kind!r} artifact (traced on that '
                         f'device); it cannot run on {str(target)!r}')
    program = torch.export.load(forward).module().to(target)

    def tensor(a):
        if isinstance(a, np.ndarray) and not a.flags.writeable:
            a = np.array(a)     # torch takes no read-only memory
        return torch.as_tensor(a, dtype=torch.float32, device=target)

    def call(x, aux=None):
        args = [tensor(a) for a in (x, aux) if a is not None]
        with torch.inference_mode():
            return program(*args)

    return call, meta
