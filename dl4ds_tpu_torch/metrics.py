"""
Evaluation metrics suite (the counterpart of `dl4ds_tpu/metrics.py`).

Per-pixel RMSE and correlation maps, per-grid-pair metrics, PSNR, SSIM and
MAE, the normalized mean bias, plots and text/npy artifacts, and the
probabilistic scores of an ensemble (CRPS, spread-skill, rank histogram).
Everything is numpy on the host, as in the JAX package, except the
per-grid PSNR and SSIM, which run on the device: the SSIM through K6, the
fused SSIM kernel (`ops.fused_ssim_per_image`), where the JAX package
computes it with jnp on its accelerator (dl4ds_tpu/metrics.py:131). Plots
are drawn only when a `save_path` is given, with matplotlib imported then,
so that the metrics themselves need no plotting package.
"""

import os

import numpy as np
import torch

from .ops import fused_ssim_per_image
from .ops.ssim import psnr as _psnr
from .preprocessing import _to_numpy
from .utils import Timing, checkarray_ndim, resolve_device

__all__ = ['compute_rmse', 'compute_correlation', 'compute_metrics',
           'crps_ensemble', 'spread_skill', 'rank_histogram',
           'compute_prob_metrics']


def compute_rmse(y, y_hat, over='time', squared=False, n_jobs=None):
    """RMSE per grid point (over='time' -> [H, W] map) or per grid pair
    (over='space' -> list of per-sample values).

    Note: for parity with the reference (dl4ds/metrics.py:27), the per-pixel
    'time' map contains the *MSE* (sklearn mean_squared_error default),
    while 'space' honours `squared`.
    """
    y = np.asarray(y)
    y_hat = np.asarray(y_hat)
    if over == 'time':
        mse_map = np.mean((y[..., 0] - y_hat[..., 0]) ** 2, axis=0)
        # reference parity (dl4ds/metrics.py:36): pixels where the FIRST
        # frame is exactly 0 (pre-masked land/sea points) are NaN, so the
        # nanmean summary excludes them instead of averaging zeros in
        return np.where(y[0, ..., 0] == 0, np.nan, mse_map)
    if over == 'space':
        axes = tuple(range(1, y.ndim))
        mse = np.mean((y - y_hat) ** 2, axis=axes)
        return list(mse if squared else np.sqrt(mse))
    raise ValueError("`over` must be 'time' or 'space'")


def _rankdata(a, axis):
    """Average-tie ranks along `axis` (scipy, a declared dependency)."""
    from scipy.stats import rankdata
    return rankdata(a, axis=axis)


def compute_correlation(y, y_hat, over='time', mode='spearman', n_jobs=None):
    """Pearson/Spearman correlation per grid point (over='time' -> [H, W]
    map) or per grid pair (over='space' -> list), fully vectorized."""
    y = np.asarray(y, 'float64')
    y_hat = np.asarray(y_hat, 'float64')

    def pearson(a, b, axis):
        am = a - a.mean(axis=axis, keepdims=True)
        bm = b - b.mean(axis=axis, keepdims=True)
        num = (am * bm).sum(axis=axis)
        den = np.sqrt((am ** 2).sum(axis=axis) * (bm ** 2).sum(axis=axis))
        with np.errstate(invalid='ignore', divide='ignore'):
            return num / den

    if over == 'time':
        a, b = y[..., 0], y_hat[..., 0]          # [N, H, W]
        if mode == 'spearman':
            a = _rankdata(a, axis=0)
            b = _rankdata(b, axis=0)
        # reference parity: first-frame-zero (pre-masked) pixels are NaN
        return np.where(y[0, ..., 0] == 0, np.nan, pearson(a, b, axis=0))
    if over == 'space':
        n = y.shape[0]
        a = y.reshape(n, -1)
        b = y_hat.reshape(n, -1)
        if mode == 'spearman':
            a = _rankdata(a, axis=1)
            b = _rankdata(b, axis=1)
        return list(pearson(a, b, axis=1))
    raise ValueError("`over` must be 'time' or 'space'")


def _psnr_ssim(y, y_hat, drange, device):
    """Per-grid PSNR and SSIM of the float32 arrays y, y_hat [N, H, W, C]
    with data range `drange`, computed on `device`: the SSIM with K6
    (`fused_ssim_per_image`, its plain version on the CPU), the PSNR with
    `ops.ssim.psnr`, the range a 0-d float32 tensor there. Returns two
    float32 numpy arrays [N]."""
    device = resolve_device(device)
    a = torch.as_tensor(np.asarray(y, 'float32'), device=device)
    b = torch.as_tensor(np.asarray(y_hat, 'float32'), device=device)
    max_val = torch.tensor(drange, dtype=torch.float32, device=device)
    with torch.no_grad():
        psnr_vals = _psnr(a, b, max_val)
        ssim_vals = fused_ssim_per_image(a, b, max_val)
    return psnr_vals.cpu().numpy(), ssim_vals.cpu().numpy()


def compute_metrics(y_test, y_test_hat, dpi=150, plot_size_px=1000,
                    n_jobs=-1, scaler=None, mask=None, save_path=None,
                    lats=None, lons=None, projection=None, *,
                    device='cuda'):
    """Compute and report the full metric suite
    (dl4ds_tpu/metrics.py:85-240, reference: dl4ds/metrics.py:100-327).
    Returns (rmse_map, pearson_corrmap, nmeanbias).

    The per-grid PSNR and SSIM are computed on `device` ('cuda' by
    default; device='cpu' must be asked for), the SSIM through K6
    (`_psnr_ssim`); the rest is numpy on the host. With `save_path` the
    maps, the violin plots, the .npy files and the summary are written
    there (matplotlib is imported only then); without it nothing is drawn
    and the summary is printed. With `lats`/`lons` (1-D coordinate
    vectors) the maps are drawn on the geographic extent; `projection=`
    (with lats, lons and `save_path`) adds each map on that geographic
    projection as `<map>_projected.png` (`viz.plot_projected`)."""
    timing = Timing()

    y_test = np.asarray(_to_numpy(y_test), 'float32')
    y_test_hat = np.asarray(_to_numpy(y_test_hat), 'float32')
    if y_test.ndim == 5:
        y_test = np.squeeze(y_test, -1)
        y_test_hat = np.squeeze(y_test_hat, -1)
    y_test = checkarray_ndim(y_test, 4, -1)
    y_test_hat = checkarray_ndim(y_test_hat, 4, -1)

    if scaler is not None and hasattr(scaler, 'inverse_transform'):
        y_test = scaler.inverse_transform(y_test)
        y_test_hat = scaler.inverse_transform(y_test_hat)
    y_test = checkarray_ndim(np.asarray(y_test, 'float32'), 4, -1)
    y_test_hat = checkarray_ndim(np.asarray(y_test_hat, 'float32'), 4, -1)

    mask_nan = None
    if mask is not None:
        mask = np.asarray(_to_numpy(mask)).copy()
        if mask.ndim == 2:
            mask = np.expand_dims(mask, -1)
        y_test = y_test * mask
        y_test_hat = y_test_hat * mask
        mask_nan = mask.astype('float').copy()
        mask_nan[mask == 0] = np.nan
        mask = np.squeeze(mask)

    drange = float(max(y_test.max(), y_test_hat.max())
                   - min(y_test.min(), y_test_hat.min()))

    psnr_vals, ssim_vals = _psnr_ssim(y_test, y_test_hat, drange, device)
    mean_psnr, std_psnr = np.mean(psnr_vals), np.std(psnr_vals)
    mean_ssim, std_ssim = np.mean(ssim_vals), np.std(ssim_vals)
    maes_pairs = np.mean(np.abs(y_test - y_test_hat), axis=(1, 2, 3))
    mean_mae, std_mae = np.mean(maes_pairs), np.std(maes_pairs)

    # RMSE
    temp_rmse_map = compute_rmse(y_test, y_test_hat, over='time')
    spatial_rmse = compute_rmse(y_test, y_test_hat, over='space')
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, 'metrics_mse_pergridpair.npy'),
                spatial_rmse)
    mean_spatial_rmse = np.mean(spatial_rmse)
    std_spatial_rmse = np.std(spatial_rmse)
    mean_temp_rmse = np.nanmean(temp_rmse_map)
    std_temp_rmse = np.nanstd(temp_rmse_map)
    if mask is not None:
        temp_rmse_map[np.where(mask == 0)] = 0
    _plot_map(temp_rmse_map, f'RMSE map (mu = {mean_temp_rmse:.6f})',
              save_path, 'metrics_pergridpoint_rmse_map', dpi,
              cmap='viridis', lats=lats, lons=lons, projection=projection)

    # normalized per-grid-point RMSE
    norm_temp_rmse_map = temp_rmse_map / (np.mean(y_test) * 100)
    norm_mean_temp_rmse = np.nanmean(norm_temp_rmse_map)
    norm_std_temp_rmse = np.nanstd(norm_temp_rmse_map)
    if mask is not None:
        norm_temp_rmse_map[np.where(mask == 0)] = 0
    _plot_map(norm_temp_rmse_map,
              f'nRMSE map (mu = {norm_mean_temp_rmse:.6f})', save_path,
              'metrics_pergridpoint_nrmse_map', dpi, cmap='viridis',
              lats=lats, lons=lons, projection=projection)

    # normalized mean bias
    nmeanbias = np.mean(y_test_hat - y_test, axis=0)
    nmeanbias = nmeanbias / (np.mean(y_test) * 100)
    nmeanbias = np.squeeze(nmeanbias)
    if mask_nan is not None:
        nmeanbias = nmeanbias * np.squeeze(mask_nan)
    mean_nmeanbias = np.nanmean(nmeanbias)
    if mask is not None:
        nmeanbias[np.where(mask == 0)] = 0
    _plot_map(nmeanbias, f'NMBias map (mu = {mean_nmeanbias:.6f})',
              save_path, 'metrics_nmeanbias_map', dpi, cmap='viridis',
              lats=lats, lons=lons, projection=projection)

    # correlations
    spatial_spearman_corr = compute_correlation(y_test, y_test_hat,
                                                over='space')
    mean_sp_spear = np.mean(spatial_spearman_corr)
    std_sp_spear = np.std(spatial_spearman_corr)
    if save_path is not None:
        np.save(os.path.join(save_path, 'metrics_spearcorr_pergridpair.npy'),
                spatial_spearman_corr)
    spatial_pearson_corr = compute_correlation(y_test, y_test_hat,
                                               mode='pearson', over='space')
    mean_sp_pear = np.mean(spatial_pearson_corr)
    std_sp_pear = np.std(spatial_pearson_corr)
    if save_path is not None:
        np.save(os.path.join(save_path, 'metrics_pearcorr_pergridpair.npy'),
                spatial_pearson_corr)
    temp_pearson_corrmap = compute_correlation(y_test, y_test_hat,
                                               mode='pearson', over='time')
    mean_t_pear = np.nanmean(temp_pearson_corrmap)
    std_t_pear = np.nanstd(temp_pearson_corrmap)
    if mask is not None:
        temp_pearson_corrmap[np.where(mask == 0)] = 0
    _plot_map(temp_pearson_corrmap,
              f'Pearson correlation map (mu = {mean_t_pear:.6f})', save_path,
              'metrics_pergridpoint_corrpears_map', dpi, cmap='magma',
              lats=lats, lons=lons, projection=projection)

    _plot_violins(
        [(np.asarray(psnr_vals), 'PSNR', mean_psnr, std_psnr),
         (np.asarray(ssim_vals), 'SSIM', mean_ssim, std_ssim),
         (maes_pairs, 'MAE', mean_mae, std_mae),
         (np.asarray(spatial_rmse), 'RMSE', mean_spatial_rmse,
          std_spatial_rmse),
         (np.asarray(spatial_pearson_corr), 'Pearson correlation',
          mean_sp_pear, std_sp_pear),
         (np.asarray(spatial_spearman_corr), 'Spearman correlation',
          mean_sp_spear, std_sp_spear)],
        save_path, dpi)

    fh = (open(os.path.join(save_path, 'metrics_summary.txt'), 'a')
          if save_path is not None else None)
    print('Metrics on y_test and y_test_hat:\n', file=fh)
    print(f'PSNR \tmu = {mean_psnr} \tsigma = {std_psnr}', file=fh)
    print(f'SSIM \tmu = {mean_ssim} \tsigma = {std_ssim}', file=fh)
    print(f'MAE \tmu = {mean_mae} \tsigma = {std_mae}', file=fh)
    print(f'Per-grid-point RMSE \tmu = {mean_temp_rmse} '
          f'\tsigma = {std_temp_rmse}', file=fh)
    print(f'Per-grid-point nRMSE \tmu = {norm_mean_temp_rmse} '
          f'\tsigma = {norm_std_temp_rmse}', file=fh)
    print(f'Per-grid-point Spearman correlation \tmu = {mean_sp_spear} '
          f'\tsigma = {std_sp_spear}', file=fh)
    print(f'Per-grid-point Pearson correlation \tmu = {mean_t_pear} '
          f'\tsigma = {std_t_pear}', file=fh)
    print(file=fh)
    print(f'Spatial MSE \tmu = {mean_spatial_rmse} '
          f'\tsigma = {std_spatial_rmse}', file=fh)
    print(f'Spatial Spearman correlation \tmu = {mean_sp_spear} '
          f'\tsigma = {std_sp_spear}', file=fh)
    print(f'Spatial Pearson correlation \tmu = {mean_sp_pear} '
          f'\tsigma = {std_sp_pear}', file=fh)
    if fh is not None:
        fh.close()

    timing.runtime()
    return temp_rmse_map, temp_pearson_corrmap, nmeanbias


def _member_stack(members, y):
    """Coerce `members` to a float64 [M, *y.shape] array (leading member
    axis, the stacking convention of `parallel.predict_ensemble` /
    `inference.predict_mc` with return_members=True)."""
    members = np.asarray(_to_numpy(members), 'float64')
    y = np.asarray(_to_numpy(y), 'float64')
    if members.ndim != y.ndim + 1 or members.shape[1:] != y.shape:
        raise ValueError(
            f'members must be [M, *obs.shape]; got members '
            f'{members.shape} vs obs {y.shape}')
    if members.shape[0] < 1:
        raise ValueError('need at least one ensemble member')
    return members, y


def crps_ensemble(y, members, fair=True):
    """Continuous Ranked Probability Score of an ensemble forecast against
    observations, per grid point: the standard kernel (energy) form

        CRPS = E|X - y| - 1/2 E|X - X'|

    estimated from the `M` members. With ``fair=True`` (default) the
    second expectation uses the unbiased 1/(M(M-1)) normalization (the
    "fair" CRPS, Ferro 2008), which estimates the score of the underlying
    distribution rather than of the finite ensemble; ``fair=False`` gives
    the classic 1/M^2 estimator. For M == 1 both reduce to the absolute
    error |x - y| (CRPS of a point forecast).

    The pairwise term is computed via the sorted-members identity
    ``sum_{i,j} |x_i - x_j| = 2 * sum_k (2k - M + 1) x_(k)`` — O(M log M)
    per grid point instead of O(M^2).

    Parameters: `y` observations ``[...]``, `members` ensemble stack
    ``[M, ...]`` (as returned by ``predict_ensemble(...,
    return_members=True)`` / ``predict_mc(..., return_members=True)``).
    Returns the CRPS field with the shape of `y` (beyond-reference;
    the reference has no probabilistic verification).
    """
    members, y = _member_stack(members, y)
    m = members.shape[0]
    term1 = np.mean(np.abs(members - y[None]), axis=0)
    if m == 1:
        return term1
    xs = np.sort(members, axis=0)
    k = np.arange(m, dtype='float64').reshape((m,) + (1,) * y.ndim)
    # sum_{i,j} |x_i - x_j| over ordered pairs (both orders)
    pair_sum = 2.0 * np.sum((2.0 * k - m + 1.0) * xs, axis=0)
    denom = m * (m - 1) if fair else m * m
    return term1 - pair_sum / (2.0 * denom)


def spread_skill(y, members, fair=True):
    """Spread-skill diagnostics of an ensemble: returns
    ``(spread, skill, ratio)`` where `skill` is the RMSE of the ensemble
    mean, `spread` is the RMS ensemble standard deviation (ddof=1), and
    `ratio = spread_corrected / skill` with the finite-ensemble correction
    ``sqrt((M+1)/M)`` applied when ``fair=True`` (a statistically
    calibrated ensemble satisfies E[MSE of the mean] = (M+1)/M * E[var],
    so ratio ~= 1 <=> calibrated, < 1 under-dispersive, > 1
    over-dispersive).
    """
    members, y = _member_stack(members, y)
    m = members.shape[0]
    if m < 2:
        raise ValueError('spread_skill needs at least 2 members')
    skill = float(np.sqrt(np.mean((members.mean(axis=0) - y) ** 2)))
    mean_var = float(np.mean(members.var(axis=0, ddof=1)))
    spread = float(np.sqrt(mean_var))
    corr = np.sqrt((m + 1.0) / m) if fair else 1.0
    ratio = spread * corr / skill if skill > 0 else np.inf
    return spread, skill, float(ratio)


def rank_histogram(y, members, seed=0):
    """Rank (Talagrand) histogram: for every grid point, the rank of the
    observation within the sorted ensemble (ties broken uniformly at
    random with `seed`, the standard convention so that identical values
    don't pile up in one bin). Returns integer counts of length M + 1.
    A calibrated ensemble yields a flat histogram; U-shape =>
    under-dispersive, dome => over-dispersive."""
    members, y = _member_stack(members, y)
    m = members.shape[0]
    below = np.sum(members < y[None], axis=0)
    ties = np.sum(members == y[None], axis=0)
    rng = np.random.default_rng(seed)
    rank = below + rng.integers(0, ties + 1)
    return np.bincount(rank.ravel(), minlength=m + 1)


def compute_prob_metrics(y_test, members, dpi=150, save_path=None,
                         lats=None, lons=None, fair=True, seed=0,
                         scaler=None, projection=None):
    """Probabilistic verification suite for ensemble forecasts
    (deep ensembles via `parallel.predict_ensemble` or MC dropout via
    `predict_mc`, both with ``return_members=True``): per-grid-point CRPS
    map, ensemble-spread map, rank histogram, and the spread-skill ratio,
    with plot/npy/txt artifacts in the `compute_metrics` style.

    Beyond-reference capability: the reference's metrics module
    (dl4ds/metrics.py) is deterministic-only. Plots are drawn only with
    `save_path`; `projection=` adds the maps' projected companions, as in
    `compute_metrics`.

    Returns ``(crps_map, ss_ratio, rank_counts)``.
    """
    timing = Timing()
    y_test = np.asarray(_to_numpy(y_test), 'float32')
    members = np.asarray(_to_numpy(members), 'float32')
    if y_test.ndim == 5:
        y_test = np.squeeze(y_test, -1)
        members = np.squeeze(members, -1)
    y_test = checkarray_ndim(y_test, 4, -1)
    members = checkarray_ndim(members, 5, -1)
    if scaler is not None and hasattr(scaler, 'inverse_transform'):
        y_test = scaler.inverse_transform(y_test)
        members = np.stack([scaler.inverse_transform(mem)
                            for mem in members], axis=0)

    n_members = members.shape[0]
    crps_field = crps_ensemble(y_test, members, fair=fair)   # [N, H, W, C]
    crps_map = np.mean(crps_field, axis=0)[..., 0]
    mean_crps = float(np.mean(crps_field))
    spread_map = np.mean(np.std(members, axis=0, ddof=1), axis=0)[..., 0]
    spread, skill, ratio = spread_skill(y_test, members, fair=fair)
    counts = rank_histogram(y_test, members, seed=seed)

    _plot_map(crps_map, f'CRPS map (mu = {mean_crps:.6f})', save_path,
              'metrics_crps_map', dpi, cmap='viridis', lats=lats, lons=lons,
              projection=projection)
    _plot_map(spread_map, f'Ensemble spread map (sigma_bar = {spread:.6f})',
              save_path, 'metrics_spread_map', dpi, cmap='magma',
              lats=lats, lons=lons, projection=projection)
    _plot_rank_histogram(counts, save_path, dpi)

    fh = (open(os.path.join(save_path, 'metrics_prob_summary.txt'), 'a')
          if save_path is not None else None)
    print(f'Probabilistic metrics ({n_members} members):\n', file=fh)
    print(f'CRPS ({"fair" if fair else "plain"}) \tmu = {mean_crps}',
          file=fh)
    print(f'Ensemble-mean RMSE (skill) \t{skill}', file=fh)
    print(f'Ensemble spread (RMS sigma) \t{spread}', file=fh)
    print(f'Spread-skill ratio (1 = calibrated) \t{ratio}', file=fh)
    if fh is not None:
        fh.close()
    timing.runtime()
    return crps_map, ratio, counts


def _plot_rank_histogram(counts, save_path, dpi):
    if save_path is None:
        return
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4), dpi=dpi)
    n_bins = len(counts)
    ax.bar(np.arange(n_bins), counts, color='skyblue', edgecolor='k',
           linewidth=0.5)
    ax.axhline(counts.sum() / n_bins, color='crimson', linestyle='--',
               linewidth=1, label='uniform (calibrated)')
    ax.set_xlabel('observation rank within ensemble')
    ax.set_ylabel('count')
    ax.set_title('Rank histogram')
    ax.legend()
    fig.tight_layout()
    np.save(os.path.join(save_path, 'metrics_rank_histogram.npy'), counts)
    fig.savefig(os.path.join(save_path, 'metrics_rank_histogram.png'),
                bbox_inches='tight')
    plt.close(fig)


def _plot_map(arr, title, save_path, fname, dpi, cmap='viridis',
              lats=None, lons=None, projection=None):
    if save_path is None:
        return
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from .utils import plot_ndarray
    fig = plot_ndarray(np.squeeze(arr), plot_title=None,
                       subplot_titles=[title], dpi=dpi, cmap=cmap,
                       lats=lats, lons=lons)
    np.save(os.path.join(save_path, fname + '.npy'), arr)
    fig.savefig(os.path.join(save_path, fname + '.png'), bbox_inches='tight')
    plt.close(fig)
    if projection is not None and lats is not None and lons is not None:
        # the geographic companion (dl4ds_tpu/metrics.py:425-434)
        from .viz import plot_projected
        plot_projected(np.squeeze(arr), lats, lons, projection=projection,
                       cmap=cmap, plot_title=title, dpi=dpi,
                       save_fname=os.path.join(
                           save_path, fname + '_projected.png'))


def _plot_violins(entries, save_path, dpi):
    if save_path is None:
        return
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    try:
        import seaborn as sns
        sns.set_style('whitegrid')
    except ImportError:
        sns = None
    f, axes = plt.subplots(1, len(entries), figsize=(15, 5), dpi=dpi)
    for ax, (vals, title, mu, sigma) in zip(np.atleast_1d(axes), entries):
        vals = np.asarray(vals, dtype=float).ravel()
        if sns is not None:
            sns.violinplot(x=vals, ax=ax, orient='h', color='skyblue',
                           saturation=1, linewidth=0.8)
        else:
            ax.violinplot(vals, vert=False)
        ax.set_title(title)
        ax.set_xlabel(f'mu = {mu:.4f}\nsigma = {sigma:.4f}')
        ax.tick_params(labelrotation=40)
    f.tight_layout()
    f.savefig(os.path.join(save_path, 'metrics_violin_plots.png'))
    plt.close(f)
