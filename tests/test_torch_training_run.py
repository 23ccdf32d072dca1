"""The port trainer's loop options on the CPU, where the step functions
that the card captures as CUDA graphs run eagerly: the epoch plan against
today's per-step draws, `steps_per_execution` (whole chunks, the JAX
trainer's warning), resume from a full checkpoint against an unbroken run
(bit for bit, with EMA, accumulation and a schedule), saving (the JAX
package's files; a port-saved model loaded by the JAX `load_model`
predicts as the port does, atol 1e-5), loading (the JAX `save_model`'s
orbax tree read through tensorstore, float32 and bfloat16, predict within
1e-5 of the JAX `predict`), `trained_model`, the scalar log,
the profiler, `remat` (its gradients equal the plain ones), EMA as the
public weights, and every ported option running instead of raising.
Small sizes, float32."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import dl4ds_tpu as dds

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.training.graphs import CapturedStep
from _torch_xla import quick_xla  # noqa: F401

HR_Y, HR_X, SCALE, PATCH = 32, 40, 4, 16
N = 10
SMALL = dict(backbone='resnet', upsampling='spc', scale=SCALE,
             patch_size=PATCH, batch_size=2, n_blocks=1, n_filters=4,
             attention=True, loss='mae', verbose=False, device='cpu')


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def hr():
    return np.random.default_rng(3).standard_normal(
        (N, HR_Y, HR_X, 1)).astype(np.float32)


def _trainer(hr, **kwargs):
    args = dict(SMALL, data_train=hr, data_val=hr[:6], data_test=hr[:6],
                steps_per_epoch=3, validation_steps=2, test_steps=1,
                epochs=2)
    args.update(kwargs)
    return tds.SupervisedTrainer(**args)


def _params(net):
    return {n: p.detach().clone() for n, p in net.named_parameters()}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize('time_window', [None, 3], ids=['4d', '5d'])
def test_plan_equals_the_per_step_draws(hr, time_window):
    """`plan` draws the epoch's indices, then each step's ys and xs, as
    `epoch_indices` and one `__call__` a step draw them; the batches that
    `step_batch` builds from its rows are those of `__call__`."""
    synth = tds.BatchSynthesizer(hr, None, 'spc', SCALE, 3, patch_size=PATCH,
                                 time_window=time_window, device='cpu')
    plan = synth.plan(torch.Generator().manual_seed(5), 4)
    gen = torch.Generator().manual_seed(5)
    idx = synth.epoch_indices(gen, steps=4)
    assert torch.equal(plan['idx'], idx)
    bufs = synth.plan_buffers(4)
    for k in bufs:
        bufs[k].copy_(plan[k])
    for c in range(4):
        state = gen.get_state()
        want = synth(idx[c], generator=gen)
        gen_c = torch.Generator()
        gen_c.set_state(state)
        ys = torch.randint(0, synth.lr_y - synth.patch_lr, (3,),
                           generator=gen_c)
        xs = torch.randint(0, synth.lr_x - synth.patch_lr, (3,),
                           generator=gen_c)
        assert torch.equal(plan['ys'][c], ys)
        assert torch.equal(plan['xs'][c], xs)
        got = synth.step_batch(bufs, torch.tensor([c]))
        for key in ('lr', 'hr'):
            assert torch.equal(got[key], want[key]), key


def test_steps_per_execution_pads_whole_chunks(hr):
    """5 steps in chunks of 2 run 6 a epoch, with the JAX trainer's warning
    (dl4ds_tpu/training/supervised.py:640-647)."""
    with pytest.warns(RuntimeWarning, match='does not divide'):
        tr = _trainer(hr, steps_per_epoch=5, steps_per_execution=2).run()
    assert tr.n_updates == 12 and tuple(tr.train_losses.shape) == (6,)


def test_chunks_change_nothing_on_the_cpu(hr):
    """Chunks of 2 of a 4-step epoch give the bits of one chunk."""
    a = _trainer(hr, steps_per_epoch=4).run()
    b = _trainer(hr, steps_per_epoch=4, steps_per_execution=2).run()
    assert a.fithist == b.fithist and a.test_loss == b.test_loss
    assert _same(_params(a.net), _params(b.net))


@pytest.mark.parametrize('at', [2, 1])
def test_resume_equals_an_unbroken_run(hr, tmp_path, at):
    """Epochs with full checkpoints, then the rest resumed from the one
    after epoch `at`, give the bits of 4 unbroken epochs: parameters, Adam
    state, EMA, the accumulators (3 steps an epoch in microbatches of 2:
    after epoch 1 a microbatch is pending), the counts, the rate's schedule
    (piecewise on the update count: a cosine's length is the run's) and
    the plan generator."""
    opts = dict(ema_decay=0.9, gradient_accumulation_steps=2,
                learning_rate=(1e-3, 1e-4), lr_decay_after=2)
    whole = _trainer(hr, epochs=4, **opts).run()
    first = _trainer(hr, epochs=2, checkpoints_frequency=1,
                     save_path=str(tmp_path), **opts).run()
    assert first.fithist['loss'] == whole.fithist['loss'][:2]
    ckpt = tmp_path / 'checkpoints' / f'epoch-{at}'
    assert (ckpt / 'checkpoint.pt').is_file()
    saved = torch.load(ckpt / 'checkpoint.pt', weights_only=True)
    assert (saved['epoch'], saved['mini_step']) == (at, 3 * at % 2)
    rest = _trainer(hr, epochs=4, resume_from_checkpoint=str(ckpt),
                    **opts).run()
    assert rest.fithist['loss'] == whole.fithist['loss'][at:]
    assert rest.fithist['val_loss'] == whole.fithist['val_loss'][at:]
    assert rest.test_loss == whole.test_loss
    assert (rest.n_updates, rest.mini_step) == (whole.n_updates,
                                                whole.mini_step) == (6, 0)
    assert _same(_params(rest.train_net), _params(whole.train_net))
    assert _same(_params(rest.net), _params(whole.net))


def test_learning_curve_draws_as_the_jax_plot_history(tmp_path):
    """The learning curve of `save_results` draws what the JAX package's
    `plot_history` draws by default: one graph a metric, titled alike,
    with the same train and validation curves and labels."""
    import matplotlib.pyplot as plt
    from dl4ds_tpu.utils import plot_history as jax_plot
    from dl4ds_tpu_torch.utils import plot_history
    history = {'loss': [0.9, 0.5, 0.4], 'val_loss': [1.0, 0.7, 0.6],
               'mae': [0.3, 0.2, 0.1]}
    drawn = []
    for plot, name in ((plot_history, 'port.png'), (jax_plot, 'jax.png')):
        fig, axes = plot(history, path=str(tmp_path / name))
        assert (tmp_path / name).is_file()
        drawn.append([(a.get_title(), [(ln.get_label(), list(ln.get_ydata()))
                                       for ln in a.get_lines()])
                      for a in axes.ravel()])
        plt.close(fig)
    assert drawn[0] == drawn[1]
    assert [title for title, _ in drawn[0]] == ['Loss', 'Mae']


def test_saved_results_and_the_jax_load_model(hr, tmp_path):
    """save=True writes the JAX package's files; the JAX `load_model`
    reads the port's model_config.json and variables.pkl, and its predict
    equals the port's; the port's `load_model` gives the same bits."""
    tr = _trainer(hr, save=True, save_path=str(tmp_path),
                  save_bestmodel=True, static_vars=[hr[0, ..., 0]]).run()
    for name in ('running_time.txt', 'test_loss.txt', 'learning_curve.png',
                 'resnet_spc/model_config.json', 'resnet_spc/variables.pkl',
                 'best_model/checkpoint.pt'):
        assert (tmp_path / name).is_file(), name
    assert float(np.loadtxt(tmp_path / 'test_loss.txt')) == pytest.approx(
        tr.test_loss, abs=1e-6)
    meta = json.loads((tmp_path / 'resnet_spc/model_config.json').read_text())
    assert meta['module_class'] == 'NetPostupsampling'
    assert meta['config']['dtype'] == 'float32'
    best = torch.load(tmp_path / 'best_model/checkpoint.pt',
                      weights_only=True)['params']
    assert best.keys() == tr.net.state_dict().keys()

    path = str(tmp_path / 'resnet_spc')
    jax_model, variables = dds.models.load_model(path)
    grids = hr[6:]
    statics = [hr[0, ..., 0]]
    want = np.asarray(dds.predict((jax_model, variables), grids, scale=SCALE,
                                  array_in_hr=True, static_vars=statics,
                                  batch_size=2))
    got = tds.predict(tr, grids, scale=SCALE, array_in_hr=True,
                      static_vars=statics, batch_size=2, device='cpu')
    np.testing.assert_allclose(got, want, atol=1e-5)
    model, net = tds.models.load_model(path, device='cpu')
    assert model.name == 'resnet_spc' and _same(_params(net),
                                                _params(tr.net))


def test_load_model_refuses_an_orbax_tree(hr, tmp_path):
    """An orbax `variables/` tree, the JAX `save_model`'s default format,
    is read, not refused: through tensorstore, with neither JAX nor orbax
    involved, into the same parameters, for a float32 and a bfloat16
    flagship; the loaded model's `predict` is the JAX `predict`'s within
    1e-5."""
    import jax
    import jax.numpy as jnp
    spec = dict(scale=SCALE, n_channels=1, n_aux_channels=0,
                lr_size=(HR_Y // SCALE, HR_X // SCALE), n_filters=4,
                n_blocks=1, attention=True)
    for dtype in (jnp.float32, jnp.bfloat16):
        path = str(tmp_path / jnp.dtype(dtype).name)
        jm = dds.net_postupsampling('resnet', 'spc', dtype=dtype, **spec)
        variables = jm.init(jax.random.PRNGKey(4))
        dds.models.save_model(jm, variables, path)
        assert os.path.isdir(os.path.join(path, 'variables'))
        assert not os.path.exists(os.path.join(path, 'variables.pkl'))
        model, net = tds.models.load_model(path, device='cpu')
        assert str(model.dtype) == f'torch.{jnp.dtype(dtype).name}'
        carried = tds.load_jax_params(
            model.init(1, device='cpu'),
            jax.tree_util.tree_map(np.asarray, variables['params']))
        assert _same(_params(net), _params(carried))
        want = np.asarray(dds.predict((jm, variables), hr[:3], scale=SCALE,
                                      batch_size=2), np.float32)
        got = tds.predict((model, net), hr[:3], scale=SCALE, batch_size=2,
                          device='cpu')
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=str(dtype))


def test_orbax_read_needs_tensorstore(hr, tmp_path, monkeypatch):
    """Without tensorstore an orbax tree raises a clear ImportError; the
    pickle fallback is read as before."""
    import sys
    tr = _trainer(hr, epochs=1)
    tr.setup_model()
    tds.models.save_model(tr.model, tr.net, str(tmp_path))
    os.makedirs(tmp_path / 'variables')
    monkeypatch.setitem(sys.modules, 'tensorstore', None)
    with pytest.raises(ImportError, match='tensorstore'):
        tds.models.load_model(str(tmp_path), device='cpu')
    os.rmdir(tmp_path / 'variables')
    _, net = tds.models.load_model(str(tmp_path), device='cpu')
    assert _same(_params(net), _params(tr.net))


def test_save_model_writes_the_flax_tree(hr, tmp_path):
    """variables.pkl is {'params': the Flax tree}, numpy arrays only."""
    tr = _trainer(hr, epochs=1)
    tr.setup_model()
    tds.models.save_model(tr.model, tr.net, str(tmp_path))
    with open(tmp_path / 'variables.pkl', 'rb') as fh:
        params = pickle.load(fh)['params']
    again = tds.load_jax_params(tr.model.init(1, device='cpu'), params)
    assert _same(_params(again), _params(tr.net))
    kernel = params['_Backbone_0']['stem']['kernel']
    assert isinstance(kernel, np.ndarray) and kernel.shape == (3, 3, 1, 4)


def test_trained_model_continues_from_its_weights(hr):
    """`trained_model` skips the build; with `trained_epochs` the loop
    starts there, and the caller's module is left as it was."""
    first = _trainer(hr, epochs=1).run()
    given = _params(first.net)
    tr = _trainer(hr, epochs=1, trained_model=(first.model, first.net),
                  trained_epochs=1).run()
    assert tr.fithist['loss'] == [] and _same(_params(tr.net), given)
    more = _trainer(hr, epochs=2, trained_model=(first.model, first.net),
                    trained_epochs=1).run()
    assert len(more.fithist['loss']) == 1
    assert not _same(_params(more.net), given)
    assert _same(_params(first.net), given)


def test_scalar_log_and_profile(hr, tmp_path):
    tr = _trainer(hr, save_logs=True, profile=True,
                  save_path=str(tmp_path)).run()
    lines = (tmp_path / 'scalars.jsonl').read_text().splitlines()
    assert [json.loads(s)['step'] for s in lines] == [0, 1]
    assert json.loads(lines[1])['val_loss'] == tr.fithist['val_loss'][1]
    trace = json.loads((tmp_path / 'profile' / 'trace.json').read_text())
    assert trace['traceEvents']


def test_remat_gradients_equal_the_plain_ones(hr):
    """remat=True recomputes each backbone block in the backward pass: the
    same loss and gradients."""
    grads = []
    for remat in (False, True):
        tr = _trainer(hr, n_blocks=2, remat=remat)
        tr.setup_datagen()
        tr.setup_model()
        tr.net.train()
        batch = tr.ds_train(torch.tensor([1, 7]), offsets=([0, 3], [5, 2]))
        loss = tr.lossf(batch['hr'], tr.net(batch['lr'], batch['aux']))
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in tr.net.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=0,
                                   atol=1e-7, msg=name)


def test_ema_weights_are_the_public_ones(hr):
    """With EMA the trainer serves, validates and tests the averaged
    weights; `train_net` keeps the raw ones (dl4ds_tpu/training/
    supervised.py:740-742)."""
    tr = _trainer(hr, ema_decay=0.5).run()
    assert tr.net is tr.ema_net and tr.train_net is not tr.net
    assert not _same(_params(tr.net), _params(tr.train_net))
    y = tds.predict(tr, hr[6:], scale=SCALE, array_in_hr=True,
                    batch_size=2, device='cpu')
    y_ema = tds.predict((tr.model, tr.ema_net), hr[6:], scale=SCALE,
                        array_in_hr=True, batch_size=2, device='cpu')
    np.testing.assert_array_equal(y, y_ema)


@pytest.mark.parametrize('kwargs', [
    dict(steps_per_execution=2), dict(lr_schedule='cosine'),
    dict(lr_schedule='warmup_cosine', warmup_steps=2),
    dict(ema_decay=0.9), dict(gradient_accumulation_steps=2),
    dict(save=True), dict(save_bestmodel=True),
    dict(checkpoints_frequency=1), dict(save_logs=True), dict(profile=True),
    dict(remat=True)],
    ids=lambda kw: '-'.join(f'{k}={v}' for k, v in kw.items()))
def test_ported_options_run(hr, tmp_path, kwargs):
    """Each option that raised until it was ported (ROADMAP item 4) runs."""
    tr = _trainer(hr, epochs=1, save_path=str(tmp_path), **kwargs).run()
    assert np.isfinite(tr.test_loss) and len(tr.fithist['loss']) == 1


def test_captured_step_needs_the_card():
    """Capture is the card's: off it, CapturedStep raises, never runs the
    step eagerly in its place."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    calls = []
    with pytest.raises((RuntimeError, AssertionError)):
        CapturedStep(lambda: calls.append(1), [])
    assert calls == []
