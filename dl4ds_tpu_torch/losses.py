"""
Pixel losses (the counterparts of `dl4ds_tpu/losses.py`). Each takes
(y_true, y_pred) as [..., H, W, C] tensors and returns a scalar tensor.
`mae` and `mse` are ported; the DSSIM and MS-DSSIM mixes wait for the SSIM
slice, and `utils.checkarg_loss` raises for their names.
"""

import torch

__all__ = ['mae', 'mse']


def mae(y_true, y_pred):
    """Mean absolute error (L1 pixel loss)."""
    return torch.mean(torch.abs(y_true - y_pred))


def mse(y_true, y_pred):
    """Mean squared error (L2 pixel loss)."""
    d = y_true - y_pred
    return torch.mean(d * d)
