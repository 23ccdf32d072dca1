"""The port's host data tiers against the JAX package on the CPU:
`crop_array` (the legacy np.random and a Generator), the reference host
tier `create_pair_hr_lr`, `create_batch_hr_lr` and `DataGenerator` under
the same global seed (their raises and warnings too), the native gather /
crop built from the port's own copy of the source with g++ (its three
functions against their numpy versions and the JAX package's, its bounds
checks, its build under build/host/), `HostStreamer` (the host half bit
for bit against the JAX `_host_batch` under the same seed, post-upsampling
and 'pin', implicit and given LR, spatial and spatio-temporal, statics,
predictors and seasons, full grids and patches; the device half; the
memmap view; an early exit; a producer error), and `data_in_hbm=False`
steps of `SupervisedTrainer` and `CGANTrainer` against the JAX trainers'
streamed steps, whose batches are the same.

Tolerances: crops, gathers, draws and the host half exact; the values the
two packages resize (the LR coarsening, the pre-upsampled 'pin' field, the
predictors moved to a grid: XLA's and torch's float32 matmuls) within
1e-6; the trainers' float32 losses rtol 1e-5 and parameters atol 1e-5
after Adam. Small sizes: 8-12 grids of 16x20, 8x8 patches, batch 2-3."""

import functools
import threading
import warnings

import jax
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

import dl4ds_tpu as dds
from dl4ds_tpu import dataloader as jdl
from dl4ds_tpu import losses as jax_losses
from dl4ds_tpu import native as jnative
from dl4ds_tpu.training import cgan as jax_cgan
from dl4ds_tpu.training import supervised as jax_supervised

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import native as tnative

from _torch_state import fed_draws, assert_tree_close
from test_torch_cgan import _JitDraws
from _torch_xla import quick_xla  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
RESIZED = 1e-6
N, HY, HX, SCALE, PATCH = 10, 16, 20, 4, 8


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(31)
    return dict(
        hr=rng.standard_normal((N, HY, HX, 1)).astype(np.float32),
        lr=rng.standard_normal((N, HY // SCALE, HX // SCALE, 1)).astype(
            np.float32),
        statics=[rng.standard_normal((HY, HX)).astype(np.float32),
                 (rng.random((HY, HX)) > 0.5).astype(np.float32)],
        pred=rng.standard_normal((N, HY // SCALE, HX // SCALE, 2)).astype(
            np.float32),
        sids=np.arange(N) % 4,
        days=np.datetime64('2001-01-01') + np.arange(N) * 40)


def _both(fn_j, fn_t, seed, **kw):
    """`fn_j(**kw)` and `fn_t(**kw)`, each from np.random.seed(seed), with
    the warnings each raised and the global state each left."""
    out = []
    for fn in (fn_j, fn_t):
        np.random.seed(seed)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            res = fn(**kw)
        out.append((res, [str(w.message) for w in caught],
                    np.random.get_state()[1].copy()))
    return out


def _equal_arrays(got, want, resized=()):
    """Arrays equal, or within RESIZED at the positions `resized`."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if i in resized:
            np.testing.assert_allclose(g, w, atol=RESIZED, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# crop_array and the reference host tier
# ---------------------------------------------------------------------------

def test_crop_array_draws_as_jax_does():
    """The same origins from the legacy global np.random (`randint`) and
    from a Generator (`integers`), on ranks 2-5 with their axes; the same
    raises."""
    a5 = _rand((2, 3, 12, 14, 2), 0)
    for arr in (a5[0, 0, :, :, 0], a5[0, 0], a5[0], a5):
        for kw in (dict(), dict(exclude_borders=True)):
            (want, _, sw), (got, _, sg) = _both(
                dds.crop_array, tds.crop_array, 5, array=arr, size=6,
                position=True, **kw)
            _equal_arrays(got[:1], want[:1])
            assert got[1:] == want[1:] and np.array_equal(sw, sg)
        want = dds.crop_array(arr, 6, rng=np.random.default_rng(3),
                              position=True)
        got = tds.crop_array(arr, 6, rng=np.random.default_rng(3),
                             position=True)
        _equal_arrays(got[:1], want[:1])
        assert got[1:] == want[1:]
    assert tds.crop_array(a5[0], 4, yx=(1, 2), get_copy=True).base is None
    for args, err in (((a5[0, 0, 0, 0, :], 2), TypeError),
                      ((a5[0], 2.0), TypeError), ((a5[0], 13), ValueError),
                      ((a5[0, 0], 11, None, False, True), ValueError)):
        for impl in (dds.crop_array, tds.crop_array):
            with pytest.raises(err):
                impl(*args)
    for impl in (dds.crop_array, tds.crop_array):
        with pytest.raises(RuntimeError):
            impl(a5[0], 6, yx=(8, 0))


def _pair_cases(d):
    hr_t = d['hr'][:3]
    return {
        'spc': (dict(array=d['hr'][0], array_lr=None, upsampling='spc'), (1,)),
        'spc_given_statics_season': (
            dict(array=d['hr'][0], array_lr=d['lr'][0], upsampling='spc',
                 static_vars=d['statics'], season='summer'), (1,)),
        'pin_predictors_statics': (
            dict(array=d['hr'][0], array_lr=None, upsampling='pin',
                 predictors=d['pred'][0], static_vars=d['statics']), (1,)),
        'rc_grid_predictors_season': (
            dict(array=d['hr'][0], array_lr=None, upsampling='rc',
                 patch_size=None, predictors=d['pred'][0],
                 season='winter'), (1,)),
        'spatiotemporal_statics': (
            dict(array=hr_t, array_lr=None, upsampling='spc',
                 static_vars=d['statics']), (1,)),
        'spatiotemporal_pin_grid': (
            dict(array=hr_t, array_lr=None, upsampling='pin',
                 patch_size=None), (1,))}


@pytest.mark.parametrize('case', ['spc', 'spc_given_statics_season',
                                  'pin_predictors_statics',
                                  'rc_grid_predictors_season',
                                  'spatiotemporal_statics',
                                  'spatiotemporal_pin_grid'])
def test_create_pair_hr_lr_equals_jax(data, case):
    """One pair from the same global seed: the same crops, the same
    warnings (the statics cropped at LR origins with a given LR), the same
    draws left on np.random; the resized LR within 1e-6."""
    kw, resized = _pair_cases(data)[case]
    kw = dict(dict(scale=SCALE, patch_size=PATCH), **kw)
    (want, warn_j, state_j), (got, warn_t, state_t) = _both(
        dds.create_pair_hr_lr, tds.create_pair_hr_lr, 7, **kw)
    _equal_arrays(got, want, resized)
    assert warn_t == warn_j and np.array_equal(state_t, state_j)
    assert bool(warn_t) == (case == 'spc_given_statics_season')


def test_create_pair_hr_lr_refuses_what_jax_refuses(data, capsys,
                                                     monkeypatch, tmp_path):
    hr_t = data['hr'][:3]
    for kw in (dict(upsampling='pin'), dict(upsampling='spc',
                                            array_lr=data['lr'][:3])):
        kw = dict(dict(array=hr_t, array_lr=None, scale=SCALE,
                       patch_size=PATCH), **kw)
        for impl in (dds.create_pair_hr_lr, tds.create_pair_hr_lr):
            with pytest.raises(ValueError, match='reference-broken'):
                impl(**kw)
            with pytest.raises(ValueError, match='not recognized'):
                impl(**dict(kw, upsampling='bad', array=hr_t[0]))
    monkeypatch.chdir(tmp_path)     # the debug panels' file lands here
    tds.create_pair_hr_lr(data['hr'][0], None, 'spc', SCALE, PATCH,
                          debug=True)
    assert 'Crop X,Y' in capsys.readouterr().out


def test_create_batch_and_data_generator_equal_jax(data):
    """`DataGenerator`'s seeded permutation, `repeat` and length, and its
    batches (each `create_batch_hr_lr` over `create_pair_hr_lr`) with
    statics, predictors and seasons from time metadata, spatial and
    spatio-temporal, against the JAX package's from the same global
    seed; the JAX raises."""
    common = dict(backbone='resnet', scale=SCALE, batch_size=3,
                  patch_size=PATCH, seed=4)
    for kw in (dict(upsampling='spc', static_vars=data['statics'],
                    predictors=[data['pred']], time_metadata=data['days'],
                    repeat=2),
               dict(upsampling='spc', time_window=3,
                    time_metadata=data['days'])):
        gj = dds.DataGenerator(data['hr'], None, **common, **kw)
        gt = tds.DataGenerator(data['hr'], None, **common, **kw)
        assert len(gt) == len(gj) and np.array_equal(gt.indices, gj.indices)
        for index in (0, len(gj) - 1):
            (want, _, sj), (got, _, st) = _both(
                gj.__getitem__, gt.__getitem__, 9, index=index)
            _equal_arrays(got[0], want[0], (0,))
            _equal_arrays(got[1], want[1])
            assert np.array_equal(sj, st)
    assert sum(1 for _ in tds.DataGenerator(data['hr'], None, upsampling='spc',
                                            **common)) == N // 3
    for kw, err in ((dict(repeat=1.5), TypeError),
                    (dict(patch_size=6), ValueError),
                    (dict(time_metadata='now'), ValueError),
                    (dict(time_metadata='auto'), ValueError)):
        for impl in (dds.DataGenerator, tds.DataGenerator):
            with pytest.raises(err):
                impl(data['hr'], None, upsampling='spc',
                     **dict(common, **kw))


# ---------------------------------------------------------------------------
# The native gather / crop
# ---------------------------------------------------------------------------

def test_native_library_builds_from_the_ports_source():
    assert tnative.available()
    path = tnative.lib_path()
    assert path.is_file() and path.parent == tnative.BUILD_DIR
    assert path.parent.parts[-2:] == ('build', 'host')
    assert tnative.SOURCE.parent.name == 'native'
    assert 'dl4ds_tpu_torch' in tnative.SOURCE.parts


@pytest.mark.parametrize('tw', [1, 3])
def test_native_functions_equal_numpy_and_jax(tw):
    """The three kernels against their numpy versions and the JAX
    package's, exactly, also written into a given `out`."""
    src = _rand((9, 12, 14, 2), 1)
    idx, ys, xs = np.array([0, 6, 2, 6]), np.array([0, 4, 1, 4]), \
        np.array([6, 0, 3, 6])
    b = src[:4] if tw == 1 else np.stack([src[:3], src[3:6], src[6:9],
                                          src[:3]])
    cases = ((tnative.gather_windows, tnative.gather_windows_reference,
              jnative.gather_windows, (src, idx, tw)),
             (tnative.gather_crop, tnative.gather_crop_reference,
              jnative.gather_crop, (src, idx, ys, xs, 8, tw)),
             (tnative.crop_batch, tnative.crop_batch_reference,
              jnative.crop_batch, (b, ys, xs, 8)))
    for fn, ref, jfn, args in cases:
        want = ref(*args)
        got = fn(*args)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jfn(*args), want)
        out = np.full(want.shape, np.nan, np.float32)
        assert fn(*args, out=out) is out
        np.testing.assert_array_equal(out, want)


def test_native_bounds_and_out_checks():
    src = _rand((5, 10, 10, 1), 2)
    with pytest.raises(IndexError, match='window'):
        tnative.gather_windows(src, np.array([3]), 3)
    with pytest.raises(IndexError, match='window'):
        tnative.gather_crop(src, np.array([-1]), [0], [0], 4)
    with pytest.raises(IndexError, match='ys'):
        tnative.gather_crop(src, np.array([0]), [7], [0], 4)
    with pytest.raises(IndexError, match='xs'):
        tnative.crop_batch(src, [0] * 5, [0, 0, 0, 0, 7], 4)
    with pytest.raises(ValueError, match='out'):
        tnative.gather_crop(src, np.array([0]), [0], [0], 4,
                            out=np.empty((1, 4, 4, 2), np.float32))
    with pytest.raises(ValueError, match='out'):
        tnative.gather_windows(src, np.array([0, 1]),
                               out=np.empty((2, 10, 10, 1), np.float64))


# ---------------------------------------------------------------------------
# HostStreamer
# ---------------------------------------------------------------------------

STREAM_CASES = [
    # (upsampling, given LR, time window, aux, patch)
    ('spc', False, None, False, PATCH), ('spc', True, None, True, PATCH),
    ('spc', False, None, True, None), ('spc', True, 3, True, None),
    ('dc', False, 3, True, PATCH), ('pin', False, None, True, PATCH),
    ('pin', True, None, False, None), ('pin', False, 3, True, PATCH)]


def _streamers(data, upsampling, given, tw, aux, patch, seed=5, b=3):
    kw = dict(upsampling=upsampling, scale=SCALE, batch_size=b,
              patch_size=patch, time_window=tw, seed=seed,
              array_lr=data['lr'] if given else None)
    if aux:
        kw.update(static_vars=data['statics'], predictors=[data['pred']],
                  season_ids=data['sids'])
    js = jdl.HostStreamer(data['hr'], **kw)
    ts = tds.HostStreamer(data['hr'], device='cpu', **kw)
    return js, ts


@pytest.mark.parametrize('case', STREAM_CASES,
                         ids=['-'.join(map(str, c)) for c in STREAM_CASES])
def test_host_streamer_equals_jax(data, case):
    """The host half (`_host_batch`: the draws, the gathers and crops, the
    statics' crops, the season ids) bit for bit against the JAX
    streamer's under the same seed, from the same pre-upsampled field and
    predictors (those the two packages resize agree within 1e-6); then
    two streamed batches of each (`epochs`, the producer's permutation
    and draws): the device half's lr, hr and aux within 1e-6."""
    js, ts = _streamers(data, *case)
    for name in ('lr_pre', 'pred', 'static_hr'):
        want, got = getattr(js, name), getattr(ts, name)
        assert (want is None) == (got is None), name
        if want is not None:
            np.testing.assert_allclose(got, want, atol=RESIZED, rtol=0)
            setattr(ts, name, np.array(want))
    idx = np.array([0, 6, 2]) if case[2] else np.array([0, 9, 2])
    want, got = js._host_batch(idx), ts._host_batch(idx)
    for w, g, name in zip(want, got, ('hr', 'lr', 'pred', 'static', 'sid')):
        if not isinstance(w, np.ndarray):
            # None, or the JAX full-grid statics sentinel: the port's
            # device half broadcasts its own copy of the grid
            assert g is None, name
            continue
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert js.rng.integers(1 << 30) == ts.rng.integers(1 << 30)
    for bj, bt in zip(js.epochs(1, 2), ts.epochs(1, 2)):
        for key in ('lr', 'hr', 'aux'):
            if bj[key] is None:
                assert bt[key] is None, key
                continue
            assert tuple(bt[key].shape) == bj[key].shape, key
            np.testing.assert_allclose(bt[key].numpy(), np.asarray(bj[key]),
                                       atol=RESIZED, rtol=0, err_msg=key)


def test_host_streamer_refuses_what_jax_refuses(data):
    for kw in (dict(patch_size=6), dict(patch_size=24)):
        for impl in (jdl.HostStreamer,
                     functools.partial(tds.HostStreamer, device='cpu')):
            with pytest.raises(ValueError):
                impl(data['hr'], 'spc', SCALE, 2, **kw)
    with pytest.raises(ValueError, match='season_ids'):
        tds.HostStreamer(data['hr'], 'spc', SCALE, 2, season_ids=[0, 1],
                         device='cpu')


def test_memmap_is_streamed_as_a_view(data, tmp_path):
    """A memmapped float32 dataset stays a view of the mapping, and
    streams the batches of the same array held in RAM."""
    path = tmp_path / 'hr.npy'
    np.save(path, data['hr'])
    mm = np.load(path, mmap_mode='r')
    ts = tds.HostStreamer(mm, 'spc', SCALE, 3, patch_size=PATCH, seed=2,
                          device='cpu')
    assert np.shares_memory(ts.array, mm)
    ram = tds.HostStreamer(data['hr'], 'spc', SCALE, 3, patch_size=PATCH,
                           seed=2, device='cpu')
    for a, b in zip(ts.epochs(2), ram.epochs(2)):
        assert torch.equal(a['hr'], b['hr']) and torch.equal(a['lr'],
                                                              b['lr'])


def _producers():
    return [th for th in threading.enumerate()
            if th.name != 'MainThread' and th.daemon and th.is_alive()]


def test_early_exit_stops_the_producer_and_errors_surface(data):
    """Leaving `epochs` early cancels and joins the producer thread; a
    producer's error is raised in the consumer; slots are reused (prefetch
    1: two slots) without a wrong batch."""
    before = set(_producers())
    ts = tds.HostStreamer(data['hr'], 'spc', SCALE, 2, patch_size=PATCH,
                          prefetch=1, seed=3, device='cpu')
    ref = tds.HostStreamer(data['hr'], 'spc', SCALE, 2, patch_size=PATCH,
                           prefetch=1, seed=3, device='cpu')
    gen = ts.epochs(n_epochs=50)
    first = [next(gen)['hr'].clone() for _ in range(3)]
    gen.close()
    assert set(_producers()) <= before
    idx = ref.rng.permutation(ref.n)
    for i, hr in enumerate(first):
        got = ref._host_batch(idx[2 * i:2 * i + 2])[0]
        np.testing.assert_array_equal(hr.numpy(), got)

    def broken(idx, out=None):
        raise OSError('disk gone')
    ts._host_batch = broken
    with pytest.raises(OSError, match='disk gone'):
        list(ts.epochs(1))
    assert set(_producers()) <= before


# ---------------------------------------------------------------------------
# The trainers' streamed steps against the JAX trainers'
# ---------------------------------------------------------------------------

def test_streamed_supervised_steps_match_jax(data):
    """`SupervisedTrainer(data_in_hbm=False).run()` for three steps of
    resnet_spc with statics and seasons, from the JAX trainer's initial
    weights: its losses and parameters against three `_train_step_batch`
    steps of the JAX trainer on its own streamer's batches (the same
    seed, the same batches); then validation and test stream."""
    hr = data['hr']
    config = dict(backbone='resnet', upsampling='spc', scale=SCALE,
                  patch_size=PATCH, batch_size=2, n_filters=4, n_blocks=1,
                  attention=True, loss='mae', static_vars=data['statics'],
                  learning_rate=(1e-3, 1e-4), verbose=False, seed=6,
                  data_in_hbm=False)
    seasons = dict(season_ids=(data['sids'], data['sids'][:6],
                               data['sids'][:6]))
    splits = dict(data_train=hr, data_val=hr[:6], data_test=hr[:6])
    tr0 = tds.SupervisedTrainer(device='cpu', **splits, **config, **seasons)
    tr0.setup_model()
    params0 = tds.weights.export_jax_params(tr0.net)
    jm = dds.net_postupsampling('resnet', 'spc', SCALE, 7, 6, (2, 2),
                                n_filters=4, n_blocks=1, attention=True)
    jt = jax_supervised.SupervisedTrainer(
        save=False, devices=jax.devices()[:1],
        trained_model=(jm, {'params': params0}), **splits, **config,
        **seasons)
    jt.setup_datagen()
    jt.setup_model()
    state = jax_supervised.TrainState.create(
        apply_fn=jm.module.apply, params=params0, tx=jt._build_optimizer())
    jt._make_steps()
    want = []
    for i, batch in enumerate(jt.ds_train.epochs(n_epochs=1, steps=3)):
        state, loss = jt._train_step_batch(state, batch,
                                           jax.random.PRNGKey(i))
        want.append(float(loss))
    tr = tds.SupervisedTrainer(
        **splits, device='cpu', epochs=1, steps_per_epoch=3,
        validation_steps=2, test_steps=1, trained_model=(tr0.model, tr0.net),
        **config, **seasons).run()
    assert isinstance(tr.ds_val, tds.HostStreamer)
    np.testing.assert_allclose(tr.train_losses.numpy(), want,
                               rtol=TOL['rtol'])
    assert_tree_close(tds.weights.export_jax_params(tr.train_net),
                      state.params, TOL, what='streamed steps')
    assert np.isfinite([tr.fithist['val_loss'][0], tr.test_loss]).all()


def test_streamed_training_checks_and_resume(data, tmp_path):
    """The streaming tier's checks (a val or test split smaller than one
    batch; `steps_per_execution` ignored with a warning), two runs from one
    seed alike, and a run resumed from its epoch-1 checkpoint streaming on
    as the uninterrupted run does."""
    hr = data['hr']
    args = dict(backbone='resnet', upsampling='spc', data_train=hr,
                data_val=hr[:4], data_test=hr[:4], scale=SCALE,
                patch_size=PATCH, batch_size=3, n_filters=4, n_blocks=1,
                device='cpu', verbose=False, data_in_hbm=False,
                steps_per_epoch=2)
    with pytest.raises(ValueError, match='data_val yields no full'):
        tds.SupervisedTrainer(**dict(args, data_val=hr[:2])).run()
    with pytest.raises(ValueError, match='data_test yields no full'):
        tds.SupervisedTrainer(**dict(args, data_test=hr[:2])).run()
    with pytest.warns(RuntimeWarning, match='steps_per_execution'):
        a = tds.SupervisedTrainer(**dict(args, epochs=2,
                                         steps_per_execution=2)).run()
    save = str(tmp_path) + '/'
    b = tds.SupervisedTrainer(**dict(args, epochs=2, save_path=save,
                                     checkpoints_frequency=1)).run()
    assert a.fithist == b.fithist
    c = tds.SupervisedTrainer(**dict(
        args, epochs=2, resume_from_checkpoint=save
        + 'checkpoints/epoch-1')).run()
    assert c.fithist['loss'] == b.fithist['loss'][1:]
    for p, q in zip(b.train_net.parameters(), c.train_net.parameters()):
        assert torch.equal(p, q)


def test_streamed_accumulation_ema_and_schedule(data):
    """With gradient accumulation over 2 microbatches, an EMA and a cosine
    schedule, `run()`'s streamed epoch (the accumulate and commit steps
    picked by the host's mini-step) gives the losses, parameters and EMA
    weights of `train_step`s on the same streamed batches."""
    hr = data['hr']
    args = dict(backbone='resnet', upsampling='spc', data_train=hr,
                data_val=hr[:4], data_test=hr[:4], scale=SCALE,
                patch_size=PATCH, batch_size=2, n_filters=4, n_blocks=1,
                attention=True, device='cpu', verbose=False,
                data_in_hbm=False, epochs=1, steps_per_epoch=4,
                validation_steps=1, test_steps=1, seed=9,
                gradient_accumulation_steps=2, ema_decay=0.9,
                lr_schedule='cosine')
    run = tds.SupervisedTrainer(**args).run()
    eager = tds.SupervisedTrainer(**args)
    eager.setup_datagen()
    eager.setup_model()
    eager.setup_optimizer()
    eager.train_net.train()
    losses = torch.stack([eager.train_step(eager.ds_train.build(**raw))
                          for raw in eager.ds_train.stream(1, 4)])
    assert run.n_updates == eager.n_updates == 2
    assert torch.equal(run.train_losses, losses)
    for a, b in ((run.train_net, eager.train_net),
                 (run.ema_net, eager.ema_net)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)


SCALE_G, B = 4, 2
G_ARGS = dict(n_filters=4, n_blocks=1, attention=True)
D_ARGS = dict(n_filters=4, n_res_blocks=1, attention=True)


@functools.lru_cache(maxsize=None)
def _gan_step():
    gen = dds.net_postupsampling('resnet', 'spc', SCALE_G, 1, 0, (2, 2),
                                 **G_ARGS)
    disc = dds.residual_discriminator(1, 'spc', False, SCALE_G, (2, 2),
                                      **D_ARGS)
    return _JitDraws(functools.partial(
        jax_cgan.train_step, generator=gen, discriminator=disc,
        gen_pxloss_function=jax_losses.mae, ema_decay=0.0))


def test_streamed_gan_steps_match_jax(data):
    """Two fused steps of `CGANTrainer(data_in_hbm=False)` through its step
    runner's streamed epoch (`train_stream`), on the JAX `train_step`'s
    dropout masks: the JAX step on the batches of the JAX trainer's
    streamer (the same seed), the four losses and both networks."""
    hr = data['hr']
    tr = tds.CGANTrainer(
        'resnet', 'spc', hr, hr[:4], scale=SCALE_G, patch_size=PATCH,
        batch_size=B, epochs=1, learning_rates=(2e-4, 3e-4), seed=8,
        generator_params=dict(G_ARGS), discriminator_params=dict(D_ARGS),
        device='cpu', verbose=False, save_loss_history=False,
        data_in_hbm=False)
    tr.setup_datagen()
    tr.setup_model()
    gv = tds.weights.export_jax_params(tr.gen_net)
    dv = tds.weights.export_jax_params(tr.disc_net)
    tr.setup_optimizer(2)
    streamer = jdl.HostStreamer(hr, 'spc', SCALE_G, B, patch_size=PATCH,
                                seed=8)
    tx = functools.partial(optax.adam, b1=0.5, eps=1e-7)
    gs = jax_cgan.GenTrainState.create(
        apply_fn=None, params=gv, tx=optax.flatten(tx(2e-4)),
        ema_params=None)
    ds = train_state.TrainState.create(apply_fn=None, params=dv,
                                       tx=optax.flatten(tx(3e-4)))
    want, draws = [], []
    for i, batch in enumerate(streamer.epochs(n_epochs=1, steps=2)):
        (gs, ds, losses), drawn = _gan_step()(gs, ds, batch,
                                              jax.random.PRNGKey(i))
        draws += drawn[:2]
        want.append([float(v) for v in losses])
    runner = tds.training.supervised.StepRunner(tr, 2, {}, loss_shape=(4,))
    tr.train_net.train()
    with fed_draws(draws):
        got = runner.train_stream(tr.ds_train, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL['rtol'])
    assert_tree_close(tds.weights.export_jax_params(tr.gen_net), gs.params,
                      TOL, what='generator')
    assert_tree_close(tds.weights.export_jax_params(tr.disc_net), ds.params,
                      TOL, what='discriminator')
    run = tds.CGANTrainer(
        'resnet', 'spc', hr, hr[:4], scale=SCALE_G, patch_size=PATCH,
        batch_size=B, epochs=2, generator_params=dict(G_ARGS),
        discriminator_params=dict(D_ARGS, attention=False), device='cpu',
        verbose=False, save_loss_history=False, data_in_hbm=False).run()
    assert np.isfinite(run.gentotal + run.disc + [run.test_loss]).all()
