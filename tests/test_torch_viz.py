"""The port's `viz.py` and the rest of its `utils.py` against the JAX
package's: `interactive_panel`'s HTML byte for byte (lats/lons, NaNs, a
[T, H, W, C] stack), `plot_projected`, the `projection=` routes of
`compute_metrics` and `compute_prob_metrics` and `plot_ndarray(
interactive=True)`, the sample reshapes, `rank`, the checks, the device
helpers, and `plot_history` under each of its options (the drawn axes,
titles, labels, scales and files alike)."""

import os
import re
import warnings

import numpy as np
import pytest
import torch

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

import dl4ds_tpu as dds  # noqa: E402
import dl4ds_tpu_torch as tds  # noqa: E402
from dl4ds_tpu import utils as jax_utils, viz as jax_viz  # noqa: E402
from dl4ds_tpu_torch import utils, viz  # noqa: E402
from _torch_xla import quick_xla  # noqa: E402,F401


def _field(shape, seed=0, nans=True):
    a = np.random.default_rng(seed).standard_normal(shape).astype('float32')
    if nans:
        a.reshape(-1)[::7] = np.nan
    return a


def _html(fn, path, *args, **kwargs):
    out = fn(*args, save_path=str(path), **kwargs)
    assert out == os.path.abspath(str(path))
    return open(out, 'rb').read()


@pytest.mark.parametrize('shape,geo', [((12, 10), True), ((3, 12, 10), True),
                                       ((4, 12, 10, 2), False),
                                       ((2, 6, 700, 1), True)])
def test_interactive_panel_html_is_the_jax_one(tmp_path, shape, geo):
    a = _field(shape)
    h, w = shape[-2:] if len(shape) < 4 else shape[1:3]
    kw = dict(lats=np.linspace(-30, 30, h), lons=np.linspace(0, 350, w)) \
        if geo else {}
    got = _html(viz.interactive_panel, tmp_path / 'port.html', a,
                title='panel', **kw)
    want = _html(jax_viz.interactive_panel, tmp_path / 'jax.html', a,
                 title='panel', **kw)
    assert got == want
    # a CPU tensor is read as its array
    assert _html(viz.interactive_panel, tmp_path / 't.html',
                 torch.from_numpy(a), title='panel', **kw) == want


def test_interactive_panel_errors_are_the_jax_ones(tmp_path):
    cases = [(np.zeros((2, 2, 2, 2, 2)), {}), (np.full((4, 4), np.nan), {}),
             (np.zeros((4, 5)), dict(lats=np.arange(3))),
             (np.zeros((4, 5)), dict(lons=np.arange(4)))]
    for a, kw in cases:
        with pytest.raises(ValueError) as want:
            jax_viz.interactive_panel(a, save_path=str(tmp_path / 'j'), **kw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            viz.interactive_panel(a, save_path=str(tmp_path / 'p'), **kw)


def test_plot_ndarray_interactive_is_the_jax_panel(tmp_path):
    stack = [_field((8, 9), s) for s in range(3)]
    kw = dict(lats=np.arange(8.), lons=np.arange(9.), plot_title='t')
    got = utils.plot_ndarray(stack, interactive=True,
                             save_fname=str(tmp_path / 'p.html'), **kw)
    want = jax_utils.plot_ndarray(stack, interactive=True,
                                  save_fname=str(tmp_path / 'j.html'), **kw)
    assert open(got, 'rb').read() == open(want, 'rb').read()


def test_plot_projected_draws_as_the_jax_one(tmp_path):
    a = _field((3, 10, 12), nans=False)
    lats, lons = np.linspace(-60, 60, 10), np.linspace(0, 330, 12)
    for proj in ('mollweide', 'hammer'):
        paths = [fn(a, lats, lons, projection=proj, plot_title='x',
                    save_fname=str(tmp_path / f'{tag}_{proj}.png'))
                 for fn, tag in ((viz.plot_projected, 'p'),
                                 (jax_viz.plot_projected, 'j'))]
        assert all(os.path.getsize(p) > 0 for p in paths)
        assert open(paths[0], 'rb').read() == open(paths[1], 'rb').read()
    figs = [fn(a[0], lats, lons, projection='lambert')
            for fn in (viz.plot_projected, jax_viz.plot_projected)]
    assert [len(f.axes) for f in figs] == [2, 2]
    assert figs[0].axes[0].name == figs[1].axes[0].name
    for f in figs:
        plt.close(f)
    with pytest.raises(ValueError, match='lats/lons must match'):
        viz.plot_projected(a, lats[:3], lons)
    try:
        import cartopy  # noqa: F401
    except ImportError:
        with pytest.warns(RuntimeWarning, match='needs cartopy'):
            plt.close(viz.plot_projected(a[0], lats, lons,
                                         projection='robinson'))


def _files(path):
    return sorted(os.listdir(path))


def test_compute_metrics_projection_writes_the_jax_maps(tmp_path):
    y = _field((6, 16, 16, 1), 1, nans=False)
    yh = y + 0.1 * _field((6, 16, 16, 1), 2, nans=False)
    geo = dict(lats=np.linspace(-40, 40, 16), lons=np.linspace(0, 300, 16))
    for pkg, tag, kw in ((tds, 'p', dict(device='cpu')), (dds, 'j', {})):
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            pkg.compute_metrics(y, yh, dpi=50, save_path=str(tmp_path / tag),
                                projection='mollweide', **geo, **kw)
    assert _files(tmp_path / 'p') == _files(tmp_path / 'j')
    assert sum(f.endswith('_projected.png')
               for f in _files(tmp_path / 'p')) == 4
    members = np.stack([y + 0.2 * _field(y.shape, 3 + k, nans=False)
                        for k in range(4)])
    for pkg, tag in ((tds, 'pp'), (dds, 'jp')):
        os.makedirs(tmp_path / tag)
        pkg.compute_prob_metrics(y, members, dpi=50,
                                 save_path=str(tmp_path / tag),
                                 projection='hammer', **geo)
    assert _files(tmp_path / 'pp') == _files(tmp_path / 'jp')
    assert {'metrics_crps_map_projected.png',
            'metrics_spread_map_projected.png'} <= set(_files(tmp_path / 'pp'))


def test_the_rest_of_utils_equals_the_jax_utils(capsys):
    a = _field((7, 5, 4, 2), nans=False)
    for tw in (1, 3, 7):
        st = utils.spatial_to_spatiotemporal_samples(a, tw)
        np.testing.assert_array_equal(
            st, jax_utils.spatial_to_spatiotemporal_samples(a, tw))
        np.testing.assert_array_equal(
            utils.spatiotemporal_to_spatial_samples(st, tw),
            jax_utils.spatiotemporal_to_spatial_samples(st, tw))
    assert utils.rank(a) == jax_utils.rank(a) == 4
    for name in ('inter_area', 'bicubic', 'lanczos'):
        assert utils.checkarg_interpolation(name) == name
    with pytest.raises(ValueError) as want:
        jax_utils.checkarg_interpolation('cubic')
    with pytest.raises(ValueError) as got:
        utils.checkarg_interpolation('cubic')
    assert str(got.value) == str(want.value)
    assert utils.set_gpu_memory_growth() is None
    assert utils.set_visible_gpus(0, 1) is None
    devices = utils.list_devices()
    assert devices == [torch.device('cuda', i)
                       for i in range(torch.cuda.device_count())]
    assert 'List of devices:' in capsys.readouterr().out
    assert utils.list_devices('all', verbose=False) == devices
    for name in ('Trainer', 'check_compatibility_upsbackb', 'checkarg_loss',
                 'checkarg_interpolation', 'plot_history', 'list_devices',
                 'spatial_to_spatiotemporal_samples',
                 'spatiotemporal_to_spatial_samples', 'interactive_panel',
                 'plot_projected', 'compat', 'import_keras_weights'):
        assert hasattr(dds, name) and hasattr(tds, name), name


def _drawn(fig_axes):
    """What a plot_history call drew: per axis its title, labels, y scale,
    line labels and data, and the scatter points."""
    fig, axes = fig_axes
    axes = np.atleast_1d(np.asarray(axes, dtype=object)).ravel()
    out = []
    for ax in axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    ax.get_yscale(), ax.axison,
                    [(ln.get_label(), ln.get_linestyle(),
                      tuple(ln.get_ydata())) for ln in ax.get_lines()],
                    [tuple(map(tuple, c.get_offsets()))
                     for c in ax.collections]))
    suptitle = (fig._suptitle.get_text() if not isinstance(fig, list)
                and fig._suptitle is not None else None)
    return out, suptitle


HISTORIES = [{'loss': [0.9, 0.5, 0.4, 0.45], 'val_loss': [1.0, 0.6, 0.5, 0.55],
              'mae': [0.3, 0.2, 0.1, 0.1]},
             {'loss': [0.8, 0.7], 'val_loss': [0.9, 0.8]}]


@pytest.mark.parametrize('kwargs', [
    {}, dict(style='--', side=3, graphs_per_row=1),
    dict(monitor='val_loss', monitor_mode='min', title='run'),
    dict(max_epochs='min', log_scale_metrics=True),
    dict(max_epochs=3, monitor='loss'),
    dict(customization_callback=lambda ax: ax.set_xlim(0, 9))])
@pytest.mark.parametrize('many', [False, True])
def test_plot_history_options_draw_as_the_jax_ones(tmp_path, kwargs, many):
    history = HISTORIES if many else HISTORIES[0]
    got = utils.plot_history(history, path=str(tmp_path / 'p' / 'h.png'),
                             **kwargs)
    want = jax_utils.plot_history(history, path=str(tmp_path / 'j' / 'h.png'),
                                  **kwargs)
    assert _drawn(got) == _drawn(want)
    assert os.path.exists(tmp_path / 'p' / 'h.png')
    plt.close('all')


def test_plot_history_single_graphs_and_path_style(tmp_path):
    figs, axes = utils.plot_history(HISTORIES[0], single_graphs=True,
                                    path=str(tmp_path / 'p' / 'h.png'))
    jfigs, jaxes = jax_utils.plot_history(HISTORIES[0], single_graphs=True,
                                          path=str(tmp_path / 'j' / 'h.png'))
    assert len(figs) == len(jfigs) == 2
    assert _files(tmp_path / 'p') == _files(tmp_path / 'j') == \
        ['h_loss.png', 'h_mae.png']
    assert [a.get_title() for a in axes] == [a.get_title() for a in jaxes]
    # a path-looking style is the path, as in the JAX package
    utils.plot_history(HISTORIES[1], str(tmp_path / 'style.png'))
    assert os.path.exists(tmp_path / 'style.png')
    for bad in (dict(monitor_mode='mid'), dict(max_epochs='all')):
        with pytest.raises(ValueError, match='not supported'):
            utils.plot_history(HISTORIES[0], **bad)
    plt.close('all')
