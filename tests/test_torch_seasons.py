"""The port's training data for MOS against the JAX package on the CPU:
season decoding with numpy's datetime64 (`_get_season_`,
`season_ids_from_time`, `_get_season_array_`) against the JAX package's
pandas decoding, on datetime64 arrays, datetime objects and a pandas
DatetimeIndex, with and without `time_window`, ties included; the
`MinMaxScaler` and `StandardScaler` (exact equality, NaN masks, `axis`
set and unset, the squeeze); `resize_array` in every mode, on int and
float inputs (atol 1e-6); `BatchSynthesizer` with a given LR array and
season ids, 4-D and 5-D, patches and full grids, with statics and a
predictor, against the JAX batch at the same offsets (atol 1e-5, the
matmul resize); and the port's MOS path run in a fresh process with
pandas, xarray, matplotlib and tensorstore blocked, which leaves none of
them, nor JAX, in `sys.modules`. Small sizes."""

import datetime
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu import dataloader as jax_dataloader
from dl4ds_tpu import preprocessing as jax_preprocessing

import dl4ds_tpu_torch as tds
from _torch_xla import quick_xla  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HR_Y, HR_X, SCALE, PATCH = 32, 40, 4, 16
N = 10


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# Season decoding
# ---------------------------------------------------------------------------

# daily values across every month boundary of two years, some before 1970
DAYS = np.arange('1969-10-20', '1971-03-10', dtype='datetime64[D]')
# windows whose modal month ties: two February and two March days (winter
# wins, the smaller month), and three months once each (November: autumn)
TIES = np.array(['2001-02-27', '2001-02-28', '2001-03-01', '2001-03-02',
                 '2001-11-30', '2001-12-01', '2002-01-01'],
                dtype='datetime64[D]')


def _forms(days):
    """The time-metadata forms both packages take: datetime64 at two
    resolutions, a pandas DatetimeIndex and a list of datetime objects."""
    return {'datetime64[D]': days,
            'datetime64[ns]': days.astype('datetime64[ns]'),
            'DatetimeIndex': pd.DatetimeIndex(days),
            'datetimes': [datetime.datetime.combine(d, datetime.time())
                          for d in days.astype(object)]}


@pytest.mark.parametrize('form', list(_forms(DAYS)))
@pytest.mark.parametrize('time_window', [None, 3, 30],
                         ids=['no-window', 'window-3', 'window-30'])
def test_season_ids_from_time_match_jax(form, time_window):
    days = _forms(DAYS)[form]
    want = jax_dataloader.season_ids_from_time(days, time_window)
    got = tds.dataloader.season_ids_from_time(days, time_window)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('time_window', [2, 4])
def test_windowed_ties_take_the_smallest_month(time_window):
    for form in _forms(TIES).values():
        got = tds.dataloader.season_ids_from_time(form, time_window)
        np.testing.assert_array_equal(
            got, jax_dataloader.season_ids_from_time(form, time_window))
    # [Feb 27, Feb 28, Mar 1, Mar 2]: February and March twice each
    assert tds.dataloader.season_ids_from_time(TIES[:4], 4)[0] == 0


@pytest.mark.parametrize('form', list(_forms(TIES)))
def test_get_season_matches_jax(form):
    days = _forms(TIES)[form]
    days = np.asarray(days) if form != 'datetimes' else days
    for i in range(len(TIES)):
        one = days[i]
        assert tds._get_season_(one) == dds._get_season_(one)
    for lo, hi in ((0, 4), (2, 6), (3, 7)):
        window = days[lo:hi]
        assert (tds._get_season_(window, time_window=hi - lo)
                == dds._get_season_(window, time_window=hi - lo))


def test_get_season_array_matches_jax():
    for season in ('winter', 'spring', 'summer', 'autumn'):
        np.testing.assert_array_equal(tds._get_season_array_(season, 3, 5),
                                      dds._get_season_array_(season, 3, 5))
    with pytest.raises(ValueError, match='season'):
        tds._get_season_array_('monsoon', 3, 5)


# ---------------------------------------------------------------------------
# Scalers
# ---------------------------------------------------------------------------

def _scaler_data(nan):
    rng = np.random.default_rng(4)
    x = (3.0 * rng.standard_normal((6, 5, 7, 1)) + 2.0).astype('float32')
    if nan:
        x[1, 2, 3, 0] = x[4, 0, 0, 0] = np.nan
    return x


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('name,kwargs', [
    ('MinMaxScaler', {}), ('MinMaxScaler', dict(value_range=(-1, 1))),
    ('MinMaxScaler', dict(axis=0)), ('MinMaxScaler', dict(axis=(1, 2))),
    ('StandardScaler', {}), ('StandardScaler', dict(axis=0)),
    ('StandardScaler', dict(with_mean=False, fillnanto=-9.0))])
@pytest.mark.parametrize('nan', [False, True], ids=['finite', 'nan'])
def test_scalers_equal_the_jax_scalers(name, kwargs, nan):
    """fit, transform and inverse_transform give the JAX scalers' bits:
    NaN skipped in fit, filled in transform, its mask restored in
    inverse_transform (same shape); [N, H, W, 1] comes back [N, H, W]."""
    x = _scaler_data(nan)
    port = getattr(tds, name)(**kwargs)
    ref = getattr(jax_preprocessing, name)(**kwargs)
    got, want = port.fit_transform(x), ref.fit_transform(x)
    assert got.shape == want.shape == x.shape[:-1]
    _same(got, want)
    for attr in ('scale_', 'min_', 'mean_', 'std_', 'nan_mask'):
        assert hasattr(port, attr) == hasattr(ref, attr)
        if hasattr(ref, attr):
            _same(getattr(port, attr), getattr(ref, attr))
    back, back_ref = port.inverse_transform(got), ref.inverse_transform(want)
    _same(back, back_ref)
    if nan:
        assert np.isnan(back).sum() == 2
    if 'axis' not in kwargs:
        # another shape: no mask restored
        _same(port.inverse_transform(got[:2]),
              ref.inverse_transform(want[:2]))


def test_scaler_refit_drops_the_stale_mask_and_checks_fitting():
    port = tds.StandardScaler().fit(_scaler_data(True))
    assert hasattr(port, 'nan_mask')
    port.fit(_scaler_data(False))
    assert not hasattr(port, 'nan_mask')
    with pytest.raises(RuntimeError, match='not fitted'):
        tds.MinMaxScaler().transform(np.ones(3))
    with pytest.raises(ValueError, match='value_range'):
        tds.MinMaxScaler(value_range=(1, 0)).fit(np.ones(3))


# ---------------------------------------------------------------------------
# resize_array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('interpolation', ['inter_area', 'nearest', 'bicubic',
                                           'bilinear', 'lanczos'])
@pytest.mark.parametrize('shape,newsize', [
    ((12, 20), (5, 6)), ((12, 20, 2), (40, 24)), ((3, 12, 20, 1), (10, 6)),
    ((2, 9, 9, 1), (36, 36))])
def test_resize_array_matches_jax(interpolation, shape, newsize):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype('float32')
    for kwargs in (dict(), dict(squeezed=False),
                   dict(keep_dynamic_range=True)):
        want = dds.resize_array(x, newsize, interpolation, **kwargs)
        got = tds.resize_array(x, newsize, interpolation, **kwargs)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize('dtype', ['int32', 'uint8', 'bool'])
def test_resize_array_takes_int_inputs_to_nearest(dtype):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2 if dtype == 'bool' else 200,
                     (11, 13, 1)).astype(dtype)
    want = dds.resize_array(x, (26, 22), 'bicubic')
    got = tds.resize_array(x, (26, 22), 'bicubic')
    assert got.dtype == want.dtype == x.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tds.resize_array(x, (26, 22), 'nearest'))


def test_resize_array_keeps_a_tensor_a_tensor():
    x = torch.arange(24.0).reshape(4, 6)
    got = tds.resize_array(x, (3, 2))
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (2, 3)
    np.testing.assert_allclose(got.numpy(),
                               tds.resize_array(x.numpy(), (3, 2)))
    with pytest.raises(RuntimeError, match='Wrong dimensions'):
        tds.resize_array(np.zeros(5), (2, 2))


# ---------------------------------------------------------------------------
# BatchSynthesizer with a given LR array and season ids
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def mos_data():
    """HR grids, LR grids that are not the coarsened HR ones, statics and a
    predictor at HR, a predictor at LR, and a season table."""
    rng = np.random.default_rng(8)
    hr = rng.standard_normal((N, HR_Y, HR_X, 1)).astype(np.float32)
    lr = rng.standard_normal((N, HR_Y // SCALE, HR_X // SCALE, 1)).astype(
        np.float32)
    topo = rng.standard_normal((HR_Y, HR_X)).astype(np.float32)
    mask = (rng.random((HR_Y, HR_X)) > 0.5).astype(np.float32)
    pred_hr = rng.standard_normal((N, HR_Y, HR_X, 1)).astype(np.float32)
    pred_lr = rng.standard_normal((N, HR_Y // SCALE, HR_X // SCALE,
                                   2)).astype(np.float32)
    seasons = rng.integers(0, 4, N).astype(np.int32)
    return hr, lr, topo, mask, pred_hr, pred_lr, seasons


def _jax_offsets(synth, key, b):
    """The LR crop offsets `_make_batch` draws from `key`
    (dl4ds_tpu/dataloader.py:689-698)."""
    key_y, key_x = jax.random.split(key)
    max_y, max_x = synth.lr_y - synth.patch_lr, synth.lr_x - synth.patch_lr
    return (np.asarray(jax.random.randint(key_y, (b,), 0, max(max_y, 1))),
            np.asarray(jax.random.randint(key_x, (b,), 0, max(max_x, 1))))


@pytest.mark.parametrize('patch_size', [PATCH, None], ids=['patch', 'grid'])
@pytest.mark.parametrize('time_window', [None, 3], ids=['4d', '5d'])
@pytest.mark.parametrize('inputs', ['lr', 'lr+seasons', 'all'])
def test_mos_synthesis_matches_jax(mos_data, patch_size, time_window, inputs):
    """The LR crop of the given array at the LR offsets, the HR crop at
    scale times them; channels [lr | predictors | static_lr | season_lr]
    and aux [static_hr | season_hr] (5-D: the statics and the season in
    aux only), the season from the batch's indices."""
    hr, lr, topo, mask, pred_hr, pred_lr, seasons = mos_data
    kw = dict(upsampling='spc', scale=SCALE, batch_size=3,
              patch_size=patch_size, time_window=time_window)
    if inputs != 'lr':
        kw['season_ids'] = seasons
    if inputs == 'all':
        kw.update(static_vars=[topo, mask], predictors=[pred_hr, pred_hr]
                  if time_window else [pred_lr])
    synth_j = dds.BatchSynthesizer(hr, lr, **kw)
    synth_t = tds.BatchSynthesizer(hr, lr, device='cpu', **kw)
    idx = np.array([4, 0, 6])
    key = jax.random.PRNGKey(7)
    want = synth_j._make_batch(jnp.asarray(idx), key)
    offsets = (_jax_offsets(synth_j, key, 3) if patch_size is not None
               else None)
    got = synth_t(torch.from_numpy(idx), offsets=offsets)
    assert synth_t.n_channels_lr == synth_j.n_channels_lr
    assert synth_t.n_channels_aux == synth_j.n_channels_aux
    assert got['lr'].shape[-1] == synth_t.n_channels_lr
    for name in ('lr', 'hr', 'aux'):
        if want[name] is None:
            assert got[name] is None
            continue
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-5, err_msg=name)
    if patch_size is None:
        # the LR channel is the given array's, not the coarsened HR
        lr0 = got['lr'][0] if time_window is None else got['lr'][0, 0]
        np.testing.assert_array_equal(lr0[..., 0].numpy(), lr[4, ..., 0])


def test_step_batch_gathers_the_season_on_the_device(mos_data):
    """A plan row's batch (`step_batch`, the captured half) equals
    `__call__` at the row's indices and offsets."""
    hr, lr, topo, mask, _, pred_lr, seasons = mos_data
    synth = tds.BatchSynthesizer(hr, lr, 'spc', SCALE, 3, patch_size=PATCH,
                                 static_vars=[topo, mask],
                                 predictors=[pred_lr], season_ids=seasons,
                                 device='cpu')
    plan = synth.plan(torch.Generator().manual_seed(2), 3)
    for row in range(3):
        got = synth.step_batch(plan, torch.tensor([row]))
        want = synth(plan['idx'][row], offsets=(plan['ys'][row],
                                                plan['xs'][row]))
        for key in ('lr', 'hr', 'aux'):
            assert torch.equal(got[key], want[key])
        sid = seasons[plan['idx'][row].numpy()]
        np.testing.assert_array_equal(
            got['lr'][:, 0, 0, -4:].argmax(-1).numpy(), sid)
        np.testing.assert_array_equal(
            got['aux'][:, -1, -1, -4:].argmax(-1).numpy(), sid)


def test_mos_synthesis_checks(mos_data):
    hr, lr, *_, seasons = mos_data
    with pytest.raises(ValueError, match='season_ids'):
        tds.BatchSynthesizer(hr, lr, 'spc', SCALE, 2, season_ids=seasons[:5],
                             device='cpu')
    with pytest.raises(ValueError, match='array_lr'):
        tds.BatchSynthesizer(hr, lr[:5], 'spc', SCALE, 2, device='cpu')
    with pytest.raises(ValueError, match='LR patch'):
        tds.BatchSynthesizer(hr, lr[:, :2], 'spc', SCALE, 2, patch_size=PATCH,
                             device='cpu')


# ---------------------------------------------------------------------------
# The MOS path without the packages the card's machine lacks
# ---------------------------------------------------------------------------

_MOS_SCRIPT = r'''
import sys
BLOCKED = {blocked!r}
for name in BLOCKED:
    sys.modules[name] = None          # `import name` raises ImportError
import numpy as np
import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.dataloader import season_ids_from_time

rng = np.random.default_rng(0)
days = np.arange('2000-01-01', '2000-01-13', dtype='datetime64[D]')
ids = season_ids_from_time(days, time_window=2)
assert ids.shape == (11,) and (ids == 0).all()
hr = rng.standard_normal((12, 16, 16, 1)).astype('float32')
lr = rng.standard_normal((12, 4, 4, 1)).astype('float32')
scaler = tds.StandardScaler().fit(hr)
hr_s, lr_s = scaler.transform(hr)[..., None], scaler.transform(lr)[..., None]
tr = tds.SupervisedTrainer(
    'resnet', 'spc', hr_s[:8], hr_s[8:], hr_s[8:], data_train_lr=lr_s[:8],
    data_val_lr=lr_s[8:], data_test_lr=lr_s[8:], scale=4, patch_size=8,
    batch_size=2, epochs=1, steps_per_epoch=1, validation_steps=1,
    test_steps=1, n_filters=4, n_blocks=1, attention=True, verbose=False,
    time_metadata=(days[:8], days[8:], days[8:]), device='cpu').run()
y = tds.predict(tr, lr_s[8:], scale=4, array_in_hr=False,
                time_metadata=days[8:], scaler=scaler, device='cpu')
assert y.shape == (4, 16, 16), y.shape
maps = tds.compute_metrics(hr[8:], y[..., None], save_path=None,
                           device='cpu')
assert all(np.isfinite(np.nan_to_num(m)).all() for m in maps)
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'flax', 'orbax', 'dl4ds_tpu', 'pandas', 'xarray', 'matplotlib',
    'tensorstore') and sys.modules[m] is not None)
assert not bad, bad
print('MOS path ok')
'''


@pytest.mark.parametrize('blocked', [
    (), ('pandas', 'xarray', 'matplotlib', 'tensorstore')],
    ids=['installed', 'blocked'])
def test_mos_path_needs_no_jax_pandas_or_plotting(blocked):
    """The MOS path's CPU forms (season decoding, the scalers, MOS
    training with time metadata, predict(array_in_hr=False) and
    compute_metrics(save_path=None)) in a fresh process: with the packages
    the card's machine lacks blocked they still run, and either way none
    of JAX, the JAX package, pandas, xarray, matplotlib or tensorstore is
    imported."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='2')
    out = subprocess.run(
        [sys.executable, '-c', _MOS_SCRIPT.format(blocked=blocked)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'MOS path ok' in out.stdout
