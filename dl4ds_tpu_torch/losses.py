"""
Loss library (the counterparts of `dl4ds_tpu/losses.py`): the reference's
nine losses. Each takes (y_true, y_pred) as [..., H, W, C] tensors and
returns a scalar tensor.

The DSSIM family keeps the reference's quirks for output parity: the
dynamic range is taken over both arrays, and an array whose minimum is
negative is shifted to non-negative values before SSIM
(dl4ds_tpu/losses.py:29-37). The range stays a device scalar, and its
gradient flows into `y_pred` as in the JAX package. DSSIM's SSIM is the fused
kernel K6 on the GPU (`ops.fused_ssim_per_image`); MS-DSSIM runs the plain
formulation (`ops.ssim.ssim_multiscale`) on every device, as the JAX package
runs XLA there. Inputs are computed in float32, as in the JAX package, or
in float64 where they are float64 (a reference run).
"""

import torch

from .ops.fused_ops import fused_ssim_per_image
from .ops.ssim import _as_float, ssim_multiscale

__all__ = ['mae', 'mse', 'dssim', 'dssim_mae', 'dssim_mse', 'dssim_mae_mse',
           'msdssim', 'msdssim_mae', 'msdssim_mae_mse']


def mae(y_true, y_pred):
    """Mean absolute error (L1 pixel loss)."""
    return torch.mean(torch.abs(y_true - y_pred))


def mse(y_true, y_pred):
    """Mean squared error (L2 pixel loss)."""
    d = y_true - y_pred
    return torch.mean(d * d)


def _shift_nonneg(a):
    m = torch.amin(a)
    return torch.where(m < 0, a - m, a)


def _drange(y_true, y_pred):
    """max - min over both arrays; amax/amin share the gradient evenly among
    ties, and maximum/minimum between two equal extremes, as JAX does."""
    maxv = torch.maximum(torch.amax(y_true), torch.amax(y_pred))
    minv = torch.minimum(torch.amin(y_true), torch.amin(y_pred))
    return maxv - minv


def dssim(y_true, y_pred):
    """Structural dissimilarity: mean((1 - SSIM) / 2)."""
    y_true, y_pred = _as_float(y_true), _as_float(y_pred)
    drange = _drange(y_true, y_pred)
    s = fused_ssim_per_image(_shift_nonneg(y_true), _shift_nonneg(y_pred),
                             max_val=drange, filter_size=11, filter_sigma=1.5,
                             k1=0.01, k2=0.03)
    return torch.mean((1.0 - s) / 2.0)


def dssim_mae(y_true, y_pred):
    """0.8 * DSSIM + 0.2 * MAE."""
    return 0.8 * dssim(y_true, y_pred) + 0.2 * mae(y_true, y_pred)


def dssim_mse(y_true, y_pred):
    """0.8 * DSSIM + 0.2 * MSE."""
    return 0.8 * dssim(y_true, y_pred) + 0.2 * mse(y_true, y_pred)


def dssim_mae_mse(y_true, y_pred):
    """0.6 * DSSIM + 0.2 * MAE + 0.2 * MSE."""
    return (0.6 * dssim(y_true, y_pred) + 0.2 * mae(y_true, y_pred)
            + 0.2 * mse(y_true, y_pred))


def msdssim(y_true, y_pred):
    """Multiscale structural dissimilarity with the reference's 4 power
    factors (dl4ds/losses.py:124-126); input spatial dims must be >= 88."""
    y_true, y_pred = _as_float(y_true), _as_float(y_pred)
    drange = _drange(y_true, y_pred)
    s = ssim_multiscale(
        _shift_nonneg(y_true), _shift_nonneg(y_pred), max_val=drange,
        filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03,
        power_factors=(0.0448, 0.2856, 0.3001, 0.2363))
    return torch.mean((1.0 - s) / 2.0)


def msdssim_mae(y_true, y_pred):
    """0.8 * MSDSSIM + 0.2 * MAE."""
    return 0.8 * msdssim(y_true, y_pred) + 0.2 * mae(y_true, y_pred)


def msdssim_mae_mse(y_true, y_pred):
    """0.6 * MSDSSIM + 0.2 * MAE + 0.2 * MSE."""
    return (0.6 * msdssim(y_true, y_pred) + 0.2 * mae(y_true, y_pred)
            + 0.2 * mse(y_true, y_pred))
