"""The port's CGAN training against the JAX package on the CPU: the
two-branch discriminator in every branch shape (scale 4, scale 5's VALID
chain with its crop, the bilinear fallback, 'pin', spatio-temporal) in
float32 (forward and gradients, train mode on JAX's dropout draws) and
bfloat16 (the mean criterion of tests/test_torch_bf16_models.py); the BCE
and the two losses in both dtypes, a probability that rounds to 1.0 in
bfloat16 giving NaN in both; the fused G+D step against the JAX
`train_step` on the same batches and masks (one and three steps, bfloat16,
DSSIM, spatio-temporal, gradient accumulation with EMA and a
warmup-cosine schedule); the trainer's `run()`, checks and refusals; its
checkpoints both ways; `predict` of a trained trainer; saving the
discriminator both ways.

Tolerances are tests/_torch_state.py's: atol/rtol 1e-4 (forward, losses,
parameters after Adam; gradients scaled by their max |g|). A bfloat16
step is held at most half as far from JAX's bfloat16 step as JAX's own
float32 step is. Small sizes: G n_filters 4, n_blocks 1; D n_filters 4,
n_res_blocks 1; 8x8 HR patches at scale 4; batch 2."""

import copy
import functools
import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

import dl4ds_tpu as dds
from dl4ds_tpu import losses as jax_losses
from dl4ds_tpu.training import cgan as jax_cgan

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.training import cgan as tcgan

from _torch_state import (TOL, t, j, np_tree, load, fed_draws,
                          assert_tree_close)
from _torch_xla import quick_xla  # noqa: F401

SCALE, PATCH, B = 4, 8, 2
G_ARGS = dict(n_filters=4, n_blocks=1, attention=True)
D_ARGS = dict(n_filters=4, n_res_blocks=1, attention=True)


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class _JitDraws:
    """`fn` jitted, with every `jax.random.bernoulli` draw it makes (the
    JAX `Dropout`'s) recorded when it runs, in program order: the draw is
    traced with an ordered debug callback into one list, which each call
    empties first. Returns (fn's output, the call's draws), the draws as
    `jax_draws` gives them."""

    def __init__(self, fn):
        self.fn = jax.jit(fn)
        self.sink = []

    def __call__(self, *args):
        real, sink = jax.random.bernoulli, self.sink

        def draw(*a, **k):
            value = real(*a, **k)
            jax.debug.callback(
                lambda v: sink.append(('bernoulli', np.asarray(v))), value,
                ordered=True)
            return value
        jax.random.bernoulli = draw
        try:
            sink.clear()
            out = jax.block_until_ready(self.fn(*args))
            jax.effects_barrier()
        finally:
            jax.random.bernoulli = real
        return out, list(sink)


# ---------------------------------------------------------------------------
# The discriminator
# ---------------------------------------------------------------------------

# (upsampling, scale, lr_size, time_window): the four branch-2 routes
D_SHAPES = {'scale4': ('spc', 4, (2, 3), None),
            'scale5_valid': ('spc', 5, (8, 8), None),
            'resize': ('spc', 5, (3, 4), None),
            'pin': ('pin', 4, (2, 3), None),
            'spatiotemporal': ('spc', 4, (2, 3), 3)}


def _disc_pair(name, dtype=None, n_channels=2):
    ups, scale, lr, tw = D_SHAPES[name]
    kw = dict(n_channels=n_channels, upsampling=ups,
              is_spatiotemporal=tw is not None, scale=scale, lr_size=lr,
              time_window=tw, **D_ARGS)
    jm = dds.residual_discriminator(**kw, **(
        {} if dtype is None else dict(dtype=jnp.bfloat16)))
    pm = tds.residual_discriminator(**kw, **(
        {} if dtype is None else dict(dtype=torch.bfloat16)))
    return jm, pm


def logits(model, params, x, x_ref):
    """The JAX discriminator's Dense_1 output in eval mode (before the last
    sigmoid), in float32."""
    _, st = model.module.apply(
        {'params': params}, x, x_ref, mutable=['intermediates'],
        capture_intermediates=lambda m, _: m.name == 'Dense_1')
    return st['intermediates']['Dense_1']['__call__'][0].astype(jnp.float32)


@pytest.mark.parametrize('name', list(D_SHAPES))
def test_discriminator_matches_jax(name):
    """Float32 in train mode on JAX's dropout draws: the output (within
    1e-5) and the gradients of mean(out * r) with respect to every
    parameter and to both inputs; the route and the input specs as JAX
    builds them; then the bfloat16 forward by the mean criterion."""
    jm, pm = _disc_pair(name)
    net = pm.init(0, device='cpu')
    v = {'params': tds.weights.export_jax_params(net)}
    assert pm.input_shape == jm.input_shape
    assert pm.aux_shape == jm.aux_shape
    assert net.route == {'scale4': 'same', 'scale5_valid': 'valid',
                         'resize': 'resize', 'pin': 'pin',
                         'spatiotemporal': 'same'}[name]
    x = _rand((B,) + jm.input_shape, 1)
    xr = _rand((B,) + jm.aux_shape, 2)
    r = _rand((B, 1), 3)

    def f(p, a, b):
        return jm.module.apply({'params': p}, a, b, training=True,
                               rngs={'dropout': jax.random.PRNGKey(5)})

    def run(p, a, b, r):
        out, vjp = jax.vjp(f, p, a, b)
        return (out,) + vjp(r / r.size) + (logits(jm, p, a, b),)
    (out, gp, gx, gxr, y32), draws = _JitDraws(run)(v['params'], j(x),
                                                    j(xr), j(r))
    assert [d[0] for d in draws] == ['bernoulli']
    net.train()
    tds.models.blocks.set_dropout_generator(net, torch.Generator())
    xt, xrt = t(x).requires_grad_(True), t(xr).requires_grad_(True)
    with fed_draws(draws):
        got = net(xt, xrt)
    torch.mean(got * t(r)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=1e-5)
    got_g = {n: p.grad for n, p in net.named_parameters()}
    gnet = tds.load_jax_params(copy.deepcopy(net), np_tree(gp))
    for n, g in gnet.named_parameters():
        g = g.detach().numpy()
        scale = max(float(np.abs(g).max()), 1e-30)
        np.testing.assert_allclose(got_g[n].numpy(), g, rtol=TOL['rtol'],
                                   atol=TOL['atol'] * scale, err_msg=n)
    for mine, want in ((xt.grad, gx), (xrt.grad, gxr)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            mine.numpy(), want, rtol=TOL['rtol'],
            atol=TOL['atol'] * max(float(np.abs(want).max()), 1e-30))

    # bfloat16, eval mode: the logits before the last sigmoid (its output
    # is near 0.5 whatever the input) at most half as far from JAX's
    # bfloat16 ones, by mean |d| / mean |y|, as JAX's float32 ones are;
    # JAX eagerly, as the port rounds each op
    jm16, pm16 = _disc_pair(name, dtype='bf16')
    want = np.asarray(logits(jm16, v['params'], j(x), j(xr)))
    y32 = np.asarray(y32)
    net16 = load(pm16.init(0, device='cpu'), v)
    seen = []
    net16.Dense_1.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        net16(t(x), t(xr))
    assert seen[0].dtype == torch.bfloat16
    scale = np.abs(want).mean()
    port = np.abs(seen[0].float().numpy() - want).mean() / scale
    own = np.abs(y32 - want).mean() / scale
    assert own > 1e-4
    assert port <= 0.5 * own, (port, own)


# ---------------------------------------------------------------------------
# The losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_losses_match_jax(dtype):
    """`_bce`, `generator_loss` and `discriminator_loss`: values and the
    gradients with respect to both discriminator outputs and the fake, in
    the JAX package's dtypes (the BCEs in the probabilities' dtype, the
    pixel loss and G's total float32); the clip's tie halves the gradient
    in both."""
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    hi = float(jnp.asarray(1 - 1e-7, jd))
    probs = np.array([[0.3], [hi], [0.7], [2e-3]], np.float32)
    real = np.array([[0.6], [0.2], [0.9], [0.5]], np.float32)
    fake = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    target = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    lossf = (jax_losses.mae, tds.losses.mae)

    def jfn(p, r, y):
        total, gan, px = jax_cgan.generator_loss(p, y, j(target), lossf[0])
        d = jax_cgan.discriminator_loss(r, p)
        return total, gan, px, d
    args = [j(a).astype(jd) for a in (probs, real, fake)]
    want = jfn(*args)
    assert [w.dtype for w in want] == [jnp.float32, jd, jnp.float32, jd]
    grads = [jax.grad(lambda *a, k=k: jfn(*a)[k].astype(jnp.float32),
                      argnums=(0, 1, 2))(*args) for k in (0, 3)]
    ins = [t(np.asarray(a)).requires_grad_(True) for a in args]
    total, gan, px = tcgan.generator_loss(ins[0], ins[2], t(target),
                                          lossf[1])
    d = tcgan.discriminator_loss(ins[1], ins[0])
    assert [v.dtype for v in (total, gan, px, d)] == [torch.float32, td,
                                                      torch.float32, td]
    for got, w in zip((total, gan, px, d), want):
        np.testing.assert_allclose(got.float().item(),
                                   float(w.astype(jnp.float32)), **TOL)
    for k, loss in ((0, total), (1, d)):
        got = torch.autograd.grad(loss.float(), ins, allow_unused=True)
        for g, w in zip(got, grads[k]):
            w = np.asarray(w.astype(jnp.float32))
            g = np.zeros_like(w) if g is None else g.float().numpy()
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * max(
                float(np.abs(w).max()), 1e-30))
    if dtype == 'float32':
        # the tie at the upper bound: half the gradient, as jnp.clip's
        p = torch.tensor([hi], requires_grad=True)
        g = torch.autograd.grad(tcgan._bce(torch.ones(1), p), p)[0]
        jg = jax.grad(lambda q: jax_cgan._bce(jnp.ones(1), q))(
            jnp.array([hi], jnp.float32))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6)


def test_bf16_bce_of_a_saturated_probability_is_nan_in_both():
    """In bfloat16 the clip's upper bound 1 - 1e-7 rounds to 1.0 (JAX's
    weak typing; the port rounds it the same way), so a D output that
    rounds to 1.0 gives log(1 - 1.0) = -inf: NaN for label 1 (0 * -inf),
    +inf for label 0, the same in both packages, where float32 stays
    finite."""
    p = np.array([[0.3], [0.9999999], [1.0]], np.float32)
    for labels, bad in ((np.ones_like(p), np.nan),
                        (np.zeros_like(p), np.inf)):
        jl = jax_cgan._bce(j(labels).astype(jnp.bfloat16),
                           j(p).astype(jnp.bfloat16))
        tl = tcgan._bce(t(labels).to(torch.bfloat16),
                        t(p).to(torch.bfloat16))
        np.testing.assert_equal([float(tl), float(jl)], [bad, bad])
        assert np.isfinite(float(jax_cgan._bce(j(labels), j(p))))
        assert torch.isfinite(tcgan._bce(t(labels), t(p)))


# ---------------------------------------------------------------------------
# The fused step
# ---------------------------------------------------------------------------

def _trainer(data, **kw):
    args = dict(backbone='resnet', upsampling='spc', data_train=data,
                data_test=data, scale=SCALE, patch_size=PATCH, batch_size=B,
                epochs=1, generator_params=dict(G_ARGS),
                discriminator_params=dict(D_ARGS), device='cpu',
                verbose=False, save_loss_history=False)
    args.update(kw)
    return tds.CGANTrainer(**args)


def _jax_tx(lr, k):
    tx = optax.flatten(optax.adam(lr, b1=0.5, eps=1e-7))
    return optax.MultiSteps(tx, every_k_schedule=k) if k > 1 else tx


def _jax_sched(lr0, schedule, total, warmup=0):
    """The JAX trainer's `_sched` (dl4ds_tpu/training/cgan.py:352-368)."""
    if schedule is None:
        return lr0
    if schedule == 'cosine':
        return optax.cosine_decay_schedule(lr0, total, 0.0)
    return optax.warmup_cosine_decay_schedule(
        0.0, lr0, warmup or max(total // 20, 1), total, 0.0)


@functools.lru_cache(maxsize=None)
def _jax_models(tw, patch, bf16, d_attention=True):
    """The JAX generator and discriminator of a case."""
    extra = dict(dtype=jnp.bfloat16) if bf16 else {}
    lr_hw = (patch // SCALE,) * 2
    gen = dds.build_model('resnet', 'spc', SCALE, 1, 0, lr_hw,
                          (patch, patch), time_window=tw, **G_ARGS, **extra)
    disc = dds.residual_discriminator(
        1, 'spc', tw is not None, SCALE, lr_hw, time_window=tw,
        **dict(D_ARGS, attention=d_attention), **extra)
    return gen, disc


@functools.lru_cache(maxsize=None)
def _jax_variables(tw, d_attention=True):
    """G's and D's variables, the port's seeded weights exported to Flax
    trees (`export_jax_params`, which tests/test_torch_zoo.py holds
    against Flax's `init` trees), drawn once a case: they do not depend on
    the grid or the dtype."""
    lr_hw = (PATCH // SCALE,) * 2
    gen = tds.build_model('resnet', 'spc', SCALE, 1, 0, lr_hw,
                          (PATCH, PATCH), time_window=tw, **G_ARGS)
    disc = tds.residual_discriminator(
        1, 'spc', tw is not None, SCALE, lr_hw, time_window=tw,
        **dict(D_ARGS, attention=d_attention))
    return tuple({'params': tds.weights.export_jax_params(m.init(
        seed, device='cpu'))} for m, seed in ((gen, 3), (disc, 4)))


@functools.lru_cache(maxsize=None)
def _jax_step(tw, patch, bf16, loss, ema, d_attention=True):
    """The JAX `train_step` of a case, jitted, its draws recorded."""
    gen, disc = _jax_models(tw, patch, bf16, d_attention)
    return _JitDraws(functools.partial(
        jax_cgan.train_step, generator=gen, discriminator=disc,
        gen_pxloss_function=getattr(jax_losses, loss), ema_decay=ema))


def _pair_of_trainers(tw=None, dtype=None, loss='mae', k=1, ema=0.0,
                      schedule=None, steps=3, patch=PATCH, d_attention=True):
    """A port trainer set up on the CPU with the weights of the JAX
    generator and discriminator, and the JAX states built as the JAX
    trainer's `run` builds them."""
    data = _rand((6, 16, 16, 1), 11)
    textra = {} if dtype is None else dict(dtype=torch.bfloat16)
    tr = _trainer(data, time_window=tw, loss=loss, patch_size=patch,
                  gradient_accumulation_steps=k, ema_decay=ema,
                  lr_schedule=schedule, learning_rates=(2e-4, 3e-4),
                  generator_params=dict(G_ARGS, **textra),
                  discriminator_params=dict(D_ARGS, attention=d_attention,
                                            **textra))
    tr.setup_model()
    gv, dv = _jax_variables(tw, d_attention)
    load(tr.gen_net, gv)
    load(tr.disc_net, dv)
    tr.setup_optimizer(steps)
    total = steps * tr.epochs
    gs = jax_cgan.GenTrainState.create(
        apply_fn=None, params=gv['params'],
        tx=_jax_tx(_jax_sched(2e-4, schedule, total), k),
        ema_params=(jax.tree.map(jnp.array, gv['params']) if ema > 0
                    else None))
    ds = train_state.TrainState.create(
        apply_fn=None, params=dv['params'],
        tx=_jax_tx(_jax_sched(3e-4, schedule, total), k))
    return tr, _jax_step(tw, patch, dtype is not None, loss, ema,
                         d_attention), gs, ds


def _batches(n, tw=None, patch=PATCH):
    tws = () if tw is None else (tw,)
    return [dict(lr=_rand((B,) + tws + (patch // SCALE,) * 2 + (1,), 20 + i),
                 hr=_rand((B,) + tws + (patch, patch, 1), 40 + i), aux=None)
            for i in range(n)]


def _run_both(tr, step, gs, ds, batches, check=None):
    """Each batch through the JAX `train_step` (its dropout draws
    recorded) and the port trainer's `train_step` on the same draws: D's
    first draw, D(fake)'s, must be the one the JAX step's D pass draws
    again. `check(i, gs, ds)` runs after each step. Returns the losses of
    both and the final JAX states."""
    tr.train_net.train()
    got, want = [], []
    for i, batch in enumerate(batches):
        (gs, ds, losses), draws = step(
            gs, ds, {k: j(v) for k, v in batch.items()},
            jax.random.PRNGKey(100 + i))
        assert len(draws) == 3
        np.testing.assert_array_equal(draws[2][1], draws[0][1])
        with fed_draws(draws[:2]):
            got.append(tr.train_step({k: t(v) for k, v in batch.items()}))
        want.append([float(jnp.asarray(v, jnp.float32)) for v in losses])
        if check is not None:
            check(i, gs, ds)
    return np.array([g.numpy() for g in got]), np.array(want), gs, ds


def _assert_params(tr, gs, ds, tol=TOL, ema=False):
    assert_tree_close(tds.weights.export_jax_params(tr.gen_net), gs.params,
                      tol, what='generator')
    assert_tree_close(tds.weights.export_jax_params(tr.disc_net), ds.params,
                      tol, what='discriminator')
    if ema:
        assert_tree_close(tds.weights.export_jax_params(tr.ema_net),
                          gs.ema_params, tol, what='EMA')


@pytest.mark.parametrize('case', ['mae', 'dssim', 'st'])
def test_train_step_matches_jax(case):
    """Fused steps on the same batches and dropout masks: three with mae
    (parameters held after the first and the third), one with dssim_mae
    (the fused SSIM's plain path), one of a spatio-temporal pair (D's
    recurrent stem, the ConvLSTM's plain versions): the four losses and
    both networks' parameters after Adam."""
    tw = 3 if case == 'st' else None
    patch = 12 if case == 'dssim' else PATCH
    loss = 'dssim_mae' if case == 'dssim' else 'mae'
    tr, step, gs, ds = _pair_of_trainers(tw=tw, loss=loss, patch=patch)
    got, want, gs, ds = _run_both(
        tr, step, gs, ds, _batches(3 if case == 'mae' else 1, tw, patch),
        check=lambda i, gs, ds: _assert_params(tr, gs, ds))
    np.testing.assert_allclose(got, want, **TOL)


def _grab():
    """An optax transformation that applies no update and keeps the
    gradient as its state: a JAX step's gradients, read from its states."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _flat(tree):
    return np.concatenate([np.ravel(a) for a in
                           jax.tree_util.tree_leaves(np_tree(tree))])


def test_train_step_bf16_by_the_float32_yardstick():
    """One bfloat16 fused step on JAX's masks: the four losses at most half
    as far from JAX's bfloat16 step as JAX's float32 step is (the bfloat16
    ones, gan and d_loss, bfloat16 values), and each network's gradients
    by the mean: mean |port - jax_bf16| at most half of mean |jax_f32 -
    jax_bf16|, both over max |jax_bf16|. Parameters after Adam are not
    compared in bfloat16: a tiny gradient element whose sign rests on a
    rounding becomes a step of +-lr, in JAX's own float32 run too."""
    batch = _batches(1)[0]
    tr, step16, _, _ = _pair_of_trainers(dtype='bf16')
    _, step32, _, _ = _pair_of_trainers()
    gv, dv = _jax_variables(None)
    want = {}
    for name, step in (('bf16', step16), ('f32', step32)):
        (gs, ds, losses), draws = step(
            jax_cgan.GenTrainState.create(apply_fn=None, params=gv['params'],
                                          tx=_grab()),
            train_state.TrainState.create(apply_fn=None, params=dv['params'],
                                          tx=_grab()),
            {k: j(v) for k, v in batch.items()}, jax.random.PRNGKey(100))
        want[name] = (np.array([float(jnp.asarray(v, jnp.float32))
                                for v in losses]),
                      _flat(gs.opt_state), _flat(ds.opt_state), draws)
    tr.train_net.train()
    with fed_draws(want['bf16'][3][:2]):
        got = tcgan.gan_gradients(tr.gen_net, tr.disc_net,
                                  {k: t(v) for k, v in batch.items()},
                                  tds.losses.mae)
    assert [v.dtype for v in got] == [torch.float32, torch.bfloat16,
                                      torch.float32, torch.bfloat16]
    got = np.array([v.float().item() for v in got])
    w16, w32 = want['bf16'][0], want['f32'][0]
    assert np.abs(got - w16).max() <= 0.5 * np.abs(w32 - w16).max(), (
        got, w16, w32)
    for k, net in ((1, tr.gen_net), (2, tr.disc_net)):
        grads = copy.deepcopy(net)
        for g, p in zip(grads.parameters(), net.parameters()):
            g.data = p.grad.clone()
        mine = _flat(tds.weights.export_jax_params(grads))
        g16, g32 = want['bf16'][k], want['f32'][k]
        scale = np.abs(g16).max()
        port = np.abs(mine - g16).mean() / scale
        own = np.abs(g32 - g16).mean() / scale
        assert own > 0 and port <= 0.5 * own, (k, port, own)


def test_accumulation_ema_and_schedule_match_jax():
    """gradient_accumulation_steps=2 (optax.MultiSteps: the running mean,
    both networks committing together), EMA 0.9 (advancing on the commit
    alone) and 'warmup_cosine' on both optimizers over four microbatches:
    losses, parameters and the EMA against the JAX step; the rates of both
    optimizers against optax's schedules."""
    tr, step, gs, ds = _pair_of_trainers(k=2, ema=0.9,
                                         schedule='warmup_cosine', steps=4)
    got, want, gs, ds = _run_both(tr, step, gs, ds, _batches(4))
    np.testing.assert_allclose(got, want, **TOL)
    _assert_params(tr, gs, ds, ema=True)
    assert tr.n_updates == 2 and tr.mini_step == 0
    total = 4 * tr.epochs
    for mine, lr0 in ((tr._gen_lr, 2e-4), (tr._disc_lr, 3e-4)):
        want_s = _jax_sched(lr0, 'warmup_cosine', total)
        for c in range(total + 2):
            np.testing.assert_allclose(
                float(mine(torch.tensor(c, dtype=torch.int32))),
                float(want_s(c)), rtol=1e-6, atol=1e-12)


def test_train_step_function_is_the_trainers_step():
    """The vocabulary `train_step` (both gradients, both Adams, the EMA)
    gives the bits of the trainer's step on the same weights, batch and
    dropout masks."""
    data = _rand((6, 16, 16, 1), 12)
    pair = [_trainer(data, ema_decay=0.5) for _ in range(2)]
    for tr in pair:
        tr.setup_model()
        tr.setup_optimizer(2)
        tr.train_net.train()
    batch = {k: t(v) for k, v in _batches(1)[0].items()}
    rng = np.random.default_rng(13)
    draws = [('bernoulli', rng.random((B, 2 * D_ARGS['n_filters'])) < 0.6)
             for _ in range(2)]
    with fed_draws(draws):
        want = pair[0].train_step(batch)
    a = pair[1]
    with fed_draws(draws):
        got = tds.train_step(a.gen_net, a.disc_net, batch, a.g_optimizer,
                             a.d_optimizer, a.lossf, ema_params=a._ema,
                             ema_decay=0.5)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want.numpy())
    for x, y in zip(pair[0]._state_tensors()[:-3], a._state_tensors()[:-3]):
        np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy())


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _parameters(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


def test_signature_checks_and_refusals(tmp_path):
    """The JAX trainer's signature (`device`'s default 'cuda' apart), its
    checks, the bn refusal, the mesh checks (a mesh that is not a
    DeviceMesh, two `devices` in one process, and a 'model' or 'space' dim
    with the JAX trainer's NotImplementedError; the data mesh itself is
    tests/test_torch_distributed_cgan.py's), `init_weights` reaching the
    Keras import, and no GPU without device='cpu'."""
    want = [p if p[0] != 'device' else p[:2] + ('cuda',)
            for p in _parameters(dds.CGANTrainer.__init__)]
    assert _parameters(tds.CGANTrainer.__init__) == want
    assert _parameters(tds.load_checkpoint)[:-1] == _parameters(
        dds.load_checkpoint)
    data = _rand((6, 16, 16, 1), 0)
    for kw, err in ((dict(gradient_accumulation_steps=0), ValueError),
                    (dict(ema_decay=1.0), ValueError),
                    (dict(lr_schedule='step'), ValueError),
                    (dict(warmup_steps=-1), ValueError),
                    (dict(predictors_train=np.zeros(1)), TypeError)):
        with pytest.raises(err):
            _trainer(data, **kw)
    stand_in = types.SimpleNamespace(mesh_dim_names=('data', 'model'),
                                     device_type='cpu')
    for kw, err, match in (
            (dict(mesh=object()), TypeError, 'DeviceMesh'),
            (dict(devices=['cpu', 'cpu']), ValueError, 'one process a '
                                                       'device'),
            (dict(mesh=stand_in), NotImplementedError,
             'routed through SupervisedTrainer')):
        with pytest.raises(err, match=match):
            _trainer(data, **kw)
    assert _trainer(data, devices=['cpu']).device == torch.device('cpu')
    with pytest.raises(ValueError, match='exhausted'):
        _trainer(data, init_weights=[np.zeros((3, 3, 1, 8), 'f')]
                 ).setup_model()
    assert _trainer(data, time_window=1).time_window is None
    bn = _trainer(data, generator_params=dict(G_ARGS, normalization='bn'),
                  save_path=str(tmp_path) + '/')
    with pytest.raises(NotImplementedError, match="normalization='bn'"):
        bn.run()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _trainer(data, device='cuda')


def test_run_end_to_end_on_the_cpu(tmp_path):
    """`run()`: the last step's four losses an epoch, `losses.npy` (4,
    epochs), the JSONL log under the JAX names, the test loss over whole
    test chunks, `net` the EMA generator and `model` the generator; a NaN
    in the data stops after the first epoch with the JAX warning."""
    data = _rand((7, 16, 16, 1), 1)
    save = str(tmp_path) + '/'
    tr = _trainer(data, epochs=2, save_path=save, save_loss_history=True,
                  save_logs=True, ema_decay=0.5, data_test=data[:3],
                  batch_size=2).run()
    losses = np.load(save + 'losses.npy')
    assert losses.shape == (4, 2) and np.isfinite(losses).all()
    np.testing.assert_array_equal(losses, np.array(
        (tr.gentotal, tr.gengan, tr.gen_pxloss, tr.disc)))
    np.testing.assert_allclose(losses[:, -1], tr.train_losses[-1].numpy())
    assert tr.net is tr.ema_net and tr.model is tr.generator
    with open(save + 'scalars.jsonl') as fh:
        assert '"gen_px_loss"' in fh.read()
    assert np.isfinite(tr.test_loss)
    bad = data.copy()
    bad[:] = np.nan
    with pytest.warns(RuntimeWarning, match='Non-finite G/D loss'):
        nan = _trainer(bad, epochs=3, save_path=save).run()
    assert len(nan.gentotal) == 1


def test_test_loss_is_the_weighted_chunk_mean():
    """With whole grids (deterministic batches) the test loss is the
    size-weighted mean of the chunk losses of `net`, as the JAX trainer
    forms it."""
    data = _rand((5, 16, 16, 1), 2)
    tr = _trainer(data, patch_size=None, data_test=data, batch_size=2,
                  epochs=1)
    tr.run()
    synth = tds.BatchSynthesizer(data, None, 'spc', SCALE, 1, device='cpu')
    want = 0.0
    with torch.no_grad():
        for lo, hi in ((0, 2), (2, 4), (4, 5)):
            b = synth(torch.arange(lo, hi))
            want += float(tds.losses.mae(b['hr'], tr.net(b['lr'], None))) \
                * (hi - lo)
    np.testing.assert_allclose(tr.test_loss, want / 5, rtol=1e-6)


def test_checkpoints_round_trip_and_resume(tmp_path):
    """`checkpoints_frequency=1`: epoch-N and final files; `load_checkpoint`
    rebuilds G and D with the trained weights; a trainer resumed from the
    final checkpoint holds every tensor of the saved state before it runs
    on."""
    data = _rand((6, 16, 16, 1), 3)
    save = str(tmp_path) + '/'
    common = dict(save_path=save, ema_decay=0.5,
                  gradient_accumulation_steps=2, steps_per_epoch=3)
    tr = _trainer(data, epochs=2, checkpoints_frequency=1, **common).run()
    for name in ('epoch-1', 'epoch-2', 'final'):
        assert (tmp_path / 'checkpoints' / name / 'checkpoint.pt').is_file()
    g, gnet, d, dnet = tds.load_checkpoint(
        save, None, 'resnet', 'spc', SCALE, (PATCH // SCALE,) * 2,
        n_blocks=(1, 1), n_filters=(4, 4), attention=True, device='cpu')
    for mine, want in ((gnet, tr.gen_net), (dnet, tr.disc_net)):
        for (n, a), b in zip(mine.state_dict().items(),
                             want.state_dict().values()):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
    assert g.name == 'resnet_spc' and d.name == 'discriminator'
    again = _trainer(data, epochs=1, resume_from_checkpoint=save
                     + 'checkpoints/final', **dict(common, save_path=save
                                                   + 'b/'))
    again.ds_train = tds.BatchSynthesizer(data, None, 'spc', SCALE, B,
                                          patch_size=PATCH, device='cpu')
    again.setup_model()
    again.setup_optimizer(3)
    again._restore_gan_checkpoint(save + 'checkpoints/final')
    assert (again.n_updates, again.mini_step) == (tr.n_updates, tr.mini_step)
    for a, b in zip(again._state_tensors()[:-1], tr._state_tensors()[:-1]):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    again = _trainer(data, epochs=1, resume_from_checkpoint=save
                     + 'checkpoints/final', **dict(common, save_path=save
                                                   + 'b/')).run()
    assert again.n_updates == tr.n_updates + 1
    assert np.isfinite(again.gentotal).all()


def test_load_checkpoint_reads_a_jax_orbax_checkpoint(tmp_path):
    """A checkpoint that the JAX trainer's `_save_gan_checkpoint` writes
    (an orbax tree), read by the port's `load_checkpoint` through
    tensorstore: the generator and discriminator parameters exactly."""
    pytest.importorskip('tensorstore')
    pytest.importorskip('orbax.checkpoint')
    lr_hw = (PATCH // SCALE,) * 2
    gv, dv = _jax_variables(None)
    gs = jax_cgan.GenTrainState.create(apply_fn=None, params=gv['params'],
                                       tx=_jax_tx(2e-4, 1))
    ds = train_state.TrainState.create(apply_fn=None, params=dv['params'],
                                       tx=_jax_tx(2e-4, 1))
    stub = types.SimpleNamespace(
        savecheckpoint_path=str(tmp_path),
        _checkpoint_save=dds.Trainer._checkpoint_save)
    jax_cgan.CGANTrainer._save_gan_checkpoint(stub, gs, ds, 'epoch-3')
    g, gnet, d, dnet = tds.load_checkpoint(
        str(tmp_path), 3, 'resnet', 'spc', SCALE, lr_hw, n_blocks=(1, 1),
        n_filters=(4, 4), attention=True, device='cpu')
    assert_tree_close(tds.weights.export_jax_params(gnet), gv['params'],
                      dict(atol=0, rtol=0))
    assert_tree_close(tds.weights.export_jax_params(dnet), dv['params'],
                      dict(atol=0, rtol=0))


def test_predict_serves_the_raw_generator_as_jax_does(tmp_path):
    """`predict(trainer)` of a trained trainer with an EMA equals the JAX
    `predict` of a JAX trainer holding the same raw and EMA weights: both
    serve the raw generator (not `net`, the EMA one that `run` keeps)."""
    data = _rand((6, 16, 16, 1), 4)
    tr = _trainer(data, epochs=1, ema_decay=0.5,
                  save_path=str(tmp_path) + '/').run()
    grids = _rand((3, 16, 16), 5)
    got = tds.predict(tr, grids, SCALE, device='cpu')
    lr_hw = (PATCH // SCALE,) * 2
    gen = dds.build_model('resnet', 'spc', SCALE, 1, 0, lr_hw,
                          (PATCH, PATCH), **G_ARGS)
    raw = tds.weights.export_jax_params(tr.gen_net)
    ema = tds.weights.export_jax_params(tr.ema_net)
    jtr = types.SimpleNamespace(
        generator=gen, gen_state=types.SimpleNamespace(params=raw),
        model=gen, variables={'params': ema})
    want = np.asarray(dds.predict(jtr, grids, SCALE), np.float32)
    np.testing.assert_allclose(got, want, **TOL)
    served_ema = tds.predict((tr.model, tr.net), grids, SCALE, device='cpu')
    assert np.abs(served_ema - got).max() > 1e-4


def test_save_and_load_the_discriminator_both_ways(tmp_path):
    """The discriminator saved by the port is read by the JAX `load_model`
    and the JAX one (orbax) by the port's: the same output in eval mode."""
    jm, pm = _disc_pair('scale4')
    net = pm.init(2, device='cpu')
    v = {'params': tds.weights.export_jax_params(net)}
    x = _rand((B,) + jm.input_shape, 6)
    xr = _rand((B,) + jm.aux_shape, 7)
    want = np.asarray(jm.apply(v, j(x), j(xr)))
    tds.save_model(pm, net, str(tmp_path / 'port'))
    jm2, v2 = dds.load_model(str(tmp_path / 'port'))
    np.testing.assert_allclose(np.asarray(jm2.apply(v2, j(x), j(xr))), want,
                               **TOL)
    pytest.importorskip('tensorstore')
    dds.save_model(jm, v, str(tmp_path / 'jax'))
    pm2, net2 = tds.load_model(str(tmp_path / 'jax'), device='cpu')
    assert pm2.name == 'discriminator' and net2.route == 'same'
    with torch.no_grad():
        got = net2(t(x), t(xr)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
