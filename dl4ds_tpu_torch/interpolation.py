"""
Image resizing with OpenCV-compatible semantics, as two matmuls.

Every interpolation mode is a separable linear operator: a pair of small
dense weight matrices (H_out x H_in) and (W_out x W_in) built once on the
host with numpy, applied on the device as two float32 matmuls. The matrix
builders are a copy of the JAX package's (`dl4ds_tpu/interpolation.py`),
which are golden-tested against OpenCV there; the port's tests hold
`resize2d` against the JAX function.
"""

import functools

import numpy as np
import torch

from . import INTERPOLATION_METHODS

__all__ = ['resize_matrix', 'resize2d', 'resize_array']


# -----------------------------------------------------------------------------
# Weight-matrix construction (host-side, numpy, float64)
# -----------------------------------------------------------------------------

def _cubic_kernel(t, A=-0.75):
    """Keys cubic convolution kernel with OpenCV's A=-0.75."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    w = np.where(
        t <= 1,
        (A + 2) * t3 - (A + 3) * t2 + 1,
        np.where(t < 2, A * t3 - 5 * A * t2 + 8 * A * t - 4 * A, 0.0))
    return w


def _lanczos_kernel(t, a=4):
    """Lanczos windowed sinc, a=4 (8 taps) as in cv2.INTER_LANCZOS4."""
    t = np.asarray(t, dtype=np.float64)
    out = np.sinc(t) * np.sinc(t / a)
    return np.where(np.abs(t) < a, out, 0.0)


def _kernel_matrix(kernel, support, out_size, in_size, normalize=True):
    """Dense (out_size, in_size) matrix for a symmetric interpolation kernel
    using OpenCV's half-pixel coordinate mapping and replicate borders."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5          # sample centres
    left = np.floor(src).astype(np.int64) - support + 1
    taps = left[:, None] + np.arange(2 * support)[None, :]    # (out, 2*support)
    w = kernel(taps - src[:, None])
    if normalize:
        w = w / w.sum(axis=1, keepdims=True)
    idx = np.clip(taps, 0, in_size - 1)                       # replicate border
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.repeat(np.arange(out_size), 2 * support)
    np.add.at(mat, (rows, idx.ravel()), w.ravel())
    return mat


def _nearest_matrix(out_size, in_size):
    """cv2.INTER_NEAREST: sx = floor(dx * scale), clamped — with OpenCV's
    exact double arithmetic (scale = 1/inv_scale, not in/out; the two
    doubles differ at exact-integer boundaries)."""
    scale = 1.0 / (out_size / in_size)
    idx = np.clip(np.floor(np.arange(out_size) * scale).astype(np.int64),
                  0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    mat[np.arange(out_size), idx] = 1.0
    return mat


def _area_matrix(out_size, in_size):
    """cv2.INTER_AREA true pixel-area relation (decimation): each output
    pixel averages the input pixels whose area overlaps the output cell
    [o*scale, (o+1)*scale); boundary cells are weighted by fractional
    coverage. Integer scale reduces to exact mean pooling."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for o in range(out_size):
        start, end = o * scale, (o + 1) * scale
        i0, i1 = int(np.floor(start)), int(np.ceil(end))
        for i in range(i0, min(i1, in_size)):
            cover = min(i + 1, end) - max(i, start)
            if cover > 0:
                mat[o, i] = cover / scale
    return mat


def _area_generic_matrix(out_size, in_size):
    """cv2.INTER_AREA generic fallback (used whenever either axis zooms):
    a 2-tap variant with sx = floor(dx*scale) and
    fx = frac((dx+1) - (sx+1) * out/in), clamped at the borders."""
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    # match OpenCV's exact double arithmetic: scale derived as 1/inv_scale
    # (NOT in/out — the two doubles differ at exact-integer boundaries),
    # and fx truncated to float32 like cv2's (float) cast
    inv_scale = out_size / in_size
    scale = 1.0 / inv_scale
    for o in range(out_size):
        sx = int(np.floor(o * scale))
        fx = np.float32((o + 1) - (sx + 1) * inv_scale)
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx < 0:
            sx, fx = 0, 0.0
        if sx >= in_size - 1:
            sx, fx = max(in_size - 2, 0), 1.0
        if in_size == 1:
            mat[o, 0] = 1.0
            continue
        mat[o, sx] += 1.0 - fx
        mat[o, sx + 1] += fx
    return mat


@functools.lru_cache(maxsize=512)
def resize_matrix(interpolation, in_size, out_size, area_generic=False):
    """Return the (out_size, in_size) float32 resampling matrix for a 1-D
    resize along one axis with the given interpolation mode. For
    'inter_area', `area_generic=True` selects OpenCV's generic 2-tap path
    (used whenever either spatial axis is zoomed)."""
    if interpolation not in INTERPOLATION_METHODS:
        raise ValueError(
            f'`interpolation` must be one of {INTERPOLATION_METHODS}. '
            f'Received {interpolation}')
    if in_size == out_size and interpolation != 'nearest':
        # all kernels are interpolating at integer offsets -> identity
        m = np.eye(out_size, dtype=np.float32)
        m.flags.writeable = False
        return m
    if interpolation == 'nearest':
        m = _nearest_matrix(out_size, in_size)
    elif interpolation == 'bilinear':
        m = _kernel_matrix(lambda t: np.maximum(0, 1 - np.abs(t)), 1,
                           out_size, in_size)
    elif interpolation == 'bicubic':
        m = _kernel_matrix(_cubic_kernel, 2, out_size, in_size,
                           normalize=False)
    elif interpolation == 'lanczos':
        m = _kernel_matrix(_lanczos_kernel, 4, out_size, in_size)
    elif interpolation == 'inter_area':
        m = (_area_generic_matrix(out_size, in_size) if area_generic
             else _area_matrix(out_size, in_size))
    m = m.astype(np.float32)
    m.flags.writeable = False   # lru_cache shares this object: freeze it
    return m


# -----------------------------------------------------------------------------
# Device-side application
# -----------------------------------------------------------------------------

@functools.lru_cache(maxsize=512)
def _device_matrix(interpolation, in_size, out_size, area_generic, dtype,
                   device):
    """`resize_matrix` as a tensor of `dtype` on `device`, copied there
    once: a copy from pageable host memory at every call would stall the
    host, and cannot be made while a CUDA graph is being captured. Made
    outside inference mode even when the first call runs in it (serving),
    since the cached tensor is later saved for backward by training."""
    with torch.inference_mode(False):
        return torch.as_tensor(
            np.array(resize_matrix(interpolation, in_size, out_size,
                                   area_generic)), dtype=dtype, device=device)


def resize2d(x, out_hw, interpolation='inter_area'):
    """Resize the two spatial axes of the tensor `x` to `out_hw` (H, W).

    The spatial axes are the two of a rank-2 tensor, and (-3, -2) for rank
    >= 3 (trailing channels: [..., H, W, C]). Runs as two float32 matmuls on
    x's device; a non-float input is computed in float32. The matrices are
    copied to the device once (`_device_matrix`), so a call makes no host
    copy and no host read.
    """
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    if x.ndim == 2:
        h_in, w_in = x.shape
    else:
        h_in, w_in = x.shape[-3], x.shape[-2]
    # OpenCV uses the true area operator only when BOTH axes shrink;
    # otherwise its generic 2-tap path applies to both axes.
    generic = (interpolation == 'inter_area'
               and (h_out > h_in or w_out > w_in))
    if not x.is_floating_point():
        x = x.float()
    wy = _device_matrix(interpolation, h_in, h_out, generic, x.dtype,
                        x.device)
    wx = _device_matrix(interpolation, w_in, w_out, generic, x.dtype,
                        x.device)
    if x.ndim == 2:
        return wy @ x @ wx.T
    *lead, _, _, c = x.shape
    # contract H: [Ho, H] @ [..., H, W*C]; then W: [Wo, W] @ [..., Ho, W, C]
    y = torch.matmul(wy, x.reshape(*lead, h_in, w_in * c))
    y = y.reshape(*lead, h_out, w_in, c)
    return torch.matmul(wx, y)


def resize_array(array, newsize, interpolation='inter_area', squeezed=True,
                 keep_dynamic_range=False):
    """The reference's resize helper (dl4ds/utils.py:341-401), as the JAX
    package's `resize_array` (dl4ds_tpu/interpolation.py:197-231): a 2-D
    [y, x], 3-D [y, x, c] or 4-D [t, y, x, c] array resized to `newsize`,
    given as (X, Y), with `resize2d` in float32. Integer and bool inputs
    are forced to 'nearest' and rounded back to their dtype; `squeezed`
    drops length-1 axes; `keep_dynamic_range` clips to the input's range.
    A numpy array gives a numpy array (resized on the CPU), a tensor a
    tensor on its device."""
    is_np = not isinstance(array, torch.Tensor)
    x = torch.from_numpy(np.asarray(array)) if is_np else array
    in_dtype = x.dtype
    is_intlike = not (x.is_floating_point() or x.is_complex())
    if is_intlike:
        # nearest only selects input values: the float32 trip is exact
        interpolation = 'nearest'
    if x.ndim not in (2, 3, 4):
        raise RuntimeError(f'Wrong dimensions, got {x.ndim}')
    size_x, size_y = newsize
    x = x.to(torch.float32)
    out = resize2d(x, (size_y, size_x), interpolation)
    if squeezed:
        out = torch.squeeze(out)
    if keep_dynamic_range:
        out = torch.clamp(out, x.min(), x.max())
    if is_intlike:
        out = torch.round(out).to(in_dtype)
    elif in_dtype != torch.float32:
        out = out.to(in_dtype)
    return out.numpy() if is_np else out
