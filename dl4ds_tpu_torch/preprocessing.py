"""
Data scalers with NaN-mask preservation: a copy of the JAX package's
`dl4ds_tpu/preprocessing.py` (the reference's sklearn-style scalers,
dl4ds/preprocessing.py), numpy on the host, so that the port needs nothing
of the JAX package to scale its data or to pass `predict(scaler=)`.

fit/transform/inverse_transform over numpy arrays (xarray DataArrays are
accepted and coerced when xarray is installed), axis-wise statistics with
NaN skipping, NaN fill on transform and NaN-mask restoration on inverse.
Every input is squeezed, as in the JAX package: a [N, H, W, 1] array comes
back [N, H, W].
"""

import numpy as np

__all__ = ['MinMaxScaler', 'StandardScaler']


def _to_numpy(X):
    try:
        import xarray as xr
        if isinstance(X, xr.DataArray):
            return X.values
    except ImportError:
        pass
    return np.asarray(X)


def _handle_zeros(scale):
    """Avoid division by ~0 for constant features (sklearn convention)."""
    scale = np.asarray(scale, dtype=float).copy()
    if scale.ndim == 0:
        return np.array(1.0) if scale == 0.0 else scale
    scale[scale == 0.0] = 1.0
    return scale


class _BaseScaler:
    def fit_transform(self, X, y=None):
        return self.fit(X, y).transform(X)

    def _check_fitted(self, attr):
        if not hasattr(self, attr):
            raise RuntimeError(
                f'{type(self).__name__} instance is not fitted yet. '
                "Call 'fit' before using this estimator.")


class MinMaxScaler(_BaseScaler):
    """Scale data to a value range; NaNs are ignored in fit, replaced by
    `fillnanto` in transform, and restored in inverse_transform.

    The transformation is:
        X_std = (X - X.min(axis)) / (X.max(axis) - X.min(axis))
        X_scaled = X_std * (max - min) + min,  (min, max) = value_range
    """

    def __init__(self, value_range=(0, 1), copy=True, axis=None, fillnanto=-1):
        self.value_range = value_range
        self.copy = copy
        self.axis = axis
        self.fillnanto = fillnanto

    def fit(self, X, y=None):
        if hasattr(self, 'scale_'):
            del self.scale_, self.min_, self.data_min_, self.data_max_
            del self.data_range_
        if hasattr(self, 'nan_mask'):
            del self.nan_mask   # a stale mask would re-inject NaNs
        return self.partial_fit(X, y)

    def partial_fit(self, X, y=None):
        X = np.squeeze(_to_numpy(X))
        lo, hi = self.value_range
        if lo >= hi:
            raise ValueError(
                'Minimum of desired value_range must be smaller than maximum. '
                f'Got {self.value_range}.')
        if np.any(np.isnan(X)):
            self.nan_mask = np.isnan(X)
        data_min = np.nanmin(X, axis=self.axis, keepdims=True)
        data_max = np.nanmax(X, axis=self.axis, keepdims=True)
        data_range = data_max - data_min
        self.scale_ = (hi - lo) / _handle_zeros(data_range)
        self.min_ = lo - data_min * self.scale_
        self.data_min_ = data_min
        self.data_max_ = data_max
        self.data_range_ = data_range
        return self

    def transform(self, X):
        self._check_fitted('scale_')
        X = np.squeeze(_to_numpy(X))
        if self.copy:
            X = X.copy()
        X = X * self.scale_ + self.min_
        if np.any(np.isnan(X)):
            X = np.nan_to_num(X, nan=self.fillnanto)
        return X

    def inverse_transform(self, X):
        self._check_fitted('scale_')
        X = np.squeeze(_to_numpy(X)).astype(float)
        if self.copy:
            X = X.copy()
        if hasattr(self, 'nan_mask') and X.shape == self.nan_mask.shape:
            X[self.nan_mask] = np.nan
        return (X - self.min_) / self.scale_


class StandardScaler(_BaseScaler):
    """Standardize by removing the mean and scaling to unit variance, with
    the same NaN semantics as MinMaxScaler."""

    def __init__(self, copy=True, with_mean=True, with_std=True, axis=None,
                 fillnanto=0):
        self.with_mean = with_mean
        self.with_std = with_std
        self.copy = copy
        self.axis = axis
        self.fillnanto = fillnanto

    def fit(self, X, y=None):
        if hasattr(self, 'mean_'):
            del self.mean_
        if hasattr(self, 'std_'):
            del self.std_
        if hasattr(self, 'nan_mask'):
            del self.nan_mask   # a stale mask would re-inject NaNs
        return self.partial_fit(X, y)

    def partial_fit(self, X, y=None):
        X = np.squeeze(_to_numpy(X))
        if np.any(np.isnan(X)):
            self.nan_mask = np.isnan(X)
        if self.with_mean:
            self.mean_ = np.nanmean(X, axis=self.axis, keepdims=True)
        if self.with_std:
            self.std_ = _handle_zeros(
                np.nanstd(X, axis=self.axis, keepdims=True))
        return self

    def transform(self, X):
        self._check_fitted('mean_' if self.with_mean else 'std_')
        X = np.squeeze(_to_numpy(X)).astype(float)
        if self.copy:
            X = X.copy()
        if self.with_mean:
            X = X - self.mean_
        if self.with_std:
            X = X / self.std_
        if np.any(np.isnan(X)):
            X = np.nan_to_num(X, nan=self.fillnanto)
        return X

    def inverse_transform(self, X):
        self._check_fitted('mean_' if self.with_mean else 'std_')
        X = np.squeeze(_to_numpy(X)).astype(float)
        if self.copy:
            X = X.copy()
        if hasattr(self, 'nan_mask') and X.shape == self.nan_mask.shape:
            X[self.nan_mask] = np.nan
        if self.with_std:
            X = X * self.std_
        if self.with_mean:
            X = X + self.mean_
        return X
