"""The port's metrics suite against the JAX package on the CPU: the
per-pixel and per-grid RMSE and correlations, `compute_metrics` (its three
maps, the per-grid PSNR and SSIM that it computes on the device through
K6's wrapper, its .npy files and summary, with a mask, a scaler and 5-D
inputs), and the ensemble scores (`crps_ensemble`, `spread_skill`,
`rank_histogram`, `compute_prob_metrics`). Every value within 1e-5 (atol
and rtol) of the JAX one; the host-side numpy functions are copies and
agree exactly. Plots are written when a `save_path` is given and drawn
only then. Small sizes, float32."""

import os
import re

import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu.ops.ssim import psnr as jax_psnr, ssim as jax_ssim

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import metrics as port_metrics
from _torch_xla import quick_xla  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
PLOTS = ('metrics_pergridpoint_rmse_map.png',
         'metrics_pergridpoint_nrmse_map.png', 'metrics_nmeanbias_map.png',
         'metrics_pergridpoint_corrpears_map.png', 'metrics_violin_plots.png')


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def fields():
    """Truth and a noisy downscaled field, [6, 24, 20, 1], positive (a mean
    near 3, so the normalized maps stay finite), with pixels of the first
    frame at exactly 0 (NaN in the per-pixel maps), and a land mask."""
    rng = np.random.default_rng(41)
    y = (3.0 + rng.standard_normal((6, 24, 20, 1))).astype(np.float32)
    y[0, :2, :3, 0] = 0.0
    y_hat = (y + 0.3 * rng.standard_normal(y.shape)).astype(np.float32)
    mask = (rng.random((24, 20)) > 0.3).astype(np.float32)
    return y, y_hat, mask


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               err_msg=what, equal_nan=True, **TOL)


@pytest.mark.parametrize('over', ['time', 'space'])
@pytest.mark.parametrize('squared', [False, True])
def test_compute_rmse_matches_jax(fields, over, squared):
    y, y_hat, _ = fields
    _close(tds.compute_rmse(y, y_hat, over=over, squared=squared),
           dds.compute_rmse(y, y_hat, over=over, squared=squared), over)


@pytest.mark.parametrize('over', ['time', 'space'])
@pytest.mark.parametrize('mode', ['spearman', 'pearson'])
def test_compute_correlation_matches_jax(fields, over, mode):
    y, y_hat, _ = fields
    _close(tds.compute_correlation(y, y_hat, over=over, mode=mode),
           dds.compute_correlation(y, y_hat, over=over, mode=mode), mode)


def test_psnr_and_ssim_on_the_device_match_jax(fields):
    """The helper that `compute_metrics` (and the card's smoke run) calls:
    K6's wrapper for the SSIM and the port's psnr, with the data range a
    device tensor."""
    y, y_hat, _ = fields
    drange = float(max(y.max(), y_hat.max()) - min(y.min(), y_hat.min()))
    launches = tds.fused_ssim_per_image.launches
    psnr, ssim = port_metrics._psnr_ssim(y, y_hat, drange, 'cpu')
    assert tds.fused_ssim_per_image.launches == launches   # plain on the CPU
    assert psnr.dtype == ssim.dtype == np.float32 and ssim.shape == (6,)
    _close(psnr, jax_psnr(y, y_hat, drange), 'psnr')
    _close(ssim, jax_ssim(y, y_hat, drange), 'ssim')


def _summary(path, name='metrics_summary.txt'):
    """The numbers of a summary file, line by line."""
    with open(os.path.join(path, name)) as fh:
        return [[float(v) for v in re.findall(
            r'-?\d+\.\d+(?:e[-+]\d+)?|nan', line.split('\t', 1)[-1])]
            for line in fh if '\t' in line]


@pytest.mark.parametrize('variant', ['plain', 'mask', 'scaler', '5d'])
def test_compute_metrics_matches_jax(fields, tmp_path, variant):
    """The three maps, every .npy file and every number of the summary;
    the plots are written."""
    y, y_hat, mask = fields
    kw = {}
    if variant == 'mask':
        kw['mask'] = mask
    if variant == 'scaler':
        kw['scaler'] = tds.StandardScaler().fit(y)
        y, y_hat = (kw['scaler'].transform(a)[..., None] for a in (y, y_hat))
    if variant == '5d':
        y, y_hat = y[..., None], y_hat[..., None]
    jax_dir, port_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
    want = dds.compute_metrics(y, y_hat, save_path=jax_dir, **kw)
    got = tds.compute_metrics(y, y_hat, save_path=port_dir, device='cpu',
                              **kw)
    for g, w, what in zip(got, want, ('rmse map', 'correlation map',
                                      'nmeanbias')):
        assert g.shape == w.shape
        _close(g, w, what)
    npys = sorted(f for f in os.listdir(jax_dir) if f.endswith('.npy'))
    assert npys == sorted(f for f in os.listdir(port_dir)
                          if f.endswith('.npy'))
    for f in npys:
        _close(np.load(os.path.join(port_dir, f)),
               np.load(os.path.join(jax_dir, f)), f)
    got_lines, want_lines = _summary(port_dir), _summary(jax_dir)
    assert len(got_lines) == len(want_lines) == 10
    for g, w in zip(got_lines, want_lines):
        _close(g, w, 'summary')
    for f in PLOTS:
        assert os.path.getsize(os.path.join(port_dir, f)) > 0, f


def test_compute_metrics_without_a_path_draws_nothing(fields, monkeypatch,
                                                      capsys, tmp_path):
    """save_path=None writes and draws nothing (matplotlib is never
    imported: it is blocked here) and prints the summary."""
    import sys
    y, y_hat, _ = fields
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    maps = tds.compute_metrics(y, y_hat, save_path=None, device='cpu')
    assert len(maps) == 3
    out = capsys.readouterr().out
    assert 'SSIM \tmu = ' in out and 'PSNR \tmu = ' in out
    # a projection without a path draws nothing either
    assert len(tds.compute_metrics(y, y_hat, projection='robinson',
                                   device='cpu')) == 3
    with pytest.raises(ImportError):
        tds.compute_metrics(y, y_hat, save_path=str(tmp_path),
                            device='cpu')


@pytest.fixture(scope='module')
def ensemble(fields):
    rng = np.random.default_rng(43)
    y = fields[0]
    members = (y[None] + 0.5 * rng.standard_normal((5,) + y.shape)).astype(
        np.float32)
    members[:, 1, 3, 4, 0] = y[1, 3, 4, 0]      # ties with the observation
    return y, members


@pytest.mark.parametrize('fair', [True, False])
def test_ensemble_scores_match_jax(ensemble, fair):
    y, members = ensemble
    _close(tds.crps_ensemble(y, members, fair=fair),
           dds.crps_ensemble(y, members, fair=fair), 'crps')
    _close(tds.crps_ensemble(y, members[:1], fair=fair),
           dds.crps_ensemble(y, members[:1], fair=fair), 'crps, one member')
    _close(tds.spread_skill(y, members, fair=fair),
           dds.spread_skill(y, members, fair=fair), 'spread_skill')
    np.testing.assert_array_equal(tds.rank_histogram(y, members, seed=3),
                                  dds.rank_histogram(y, members, seed=3))
    with pytest.raises(ValueError, match='members'):
        tds.crps_ensemble(y, members[:, :2])
    with pytest.raises(ValueError, match='2 members'):
        tds.spread_skill(y, members[:1])


def test_compute_prob_metrics_matches_jax(ensemble, tmp_path):
    y, members = ensemble
    jax_dir, port_dir = tmp_path / 'jax', tmp_path / 'port'
    os.makedirs(jax_dir)
    os.makedirs(port_dir)
    want = dds.compute_prob_metrics(y, members, save_path=str(jax_dir),
                                    seed=2)
    got = tds.compute_prob_metrics(y, members, save_path=str(port_dir),
                                   seed=2)
    for g, w, what in zip(got, want, ('crps map', 'ratio', 'rank counts')):
        _close(g, w, what)
    for f in ('metrics_crps_map', 'metrics_spread_map',
              'metrics_rank_histogram'):
        _close(np.load(port_dir / (f + '.npy')), np.load(jax_dir / (f + '.npy')),
               f)
        assert os.path.getsize(port_dir / (f + '.png')) > 0
    assert _summary(port_dir, 'metrics_prob_summary.txt') == _summary(
        jax_dir, 'metrics_prob_summary.txt')
    # a projection without a path draws nothing (its maps: test_torch_viz)
    again = tds.compute_prob_metrics(y, members, projection='robinson',
                                     seed=2)
    for g, w, what in zip(again, want, ('crps map', 'ratio', 'rank counts')):
        _close(g, w, what)


def test_plot_ndarray_writes_the_panels(fields, tmp_path):
    y = fields[0]
    fig = tds.utils.plot_ndarray(y[:3, ..., 0], subplot_titles=['a', 'b'],
                                 share_colorbar=True,
                                 lats=np.linspace(40, 30, 24),
                                 lons=np.linspace(0, 10, 20),
                                 save_fname=str(tmp_path / 'p.png'))
    assert len(fig.axes) == 4 and os.path.getsize(tmp_path / 'p.png') > 0
    with pytest.raises(ValueError, match='2-D'):
        tds.utils.plot_ndarray(np.zeros((2, 3, 4, 5)))
