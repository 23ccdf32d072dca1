"""Shared helpers of the port's train-mode state tests (test_torch_norm.py,
test_torch_dropout.py, test_torch_convnext.py, test_torch_predict_mc.py):
the JAX package's and the port's forward and gradients in train mode with
the `batch_stats` collection, and the JAX dropout draws recorded in call
order and fed to the port's `_dropout_mask`.

Tolerances are those of tests/test_torch_zoo.py: the float32 forward and
the gradients of a weighted mean of the output within atol/rtol 1e-4, the
gradients' atol scaled by their max |g|, or by 1e-2 of the largest
gradient of the model for a parameter whose gradient is zero but for
rounding (a conv bias before a train-mode batch norm, which removes it);
the running statistics the same."""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch.models import blocks as tblocks

TOL = dict(atol=1e-4, rtol=1e-4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def j(a):
    return None if a is None else jnp.asarray(a)


def flat(tree, prefix=''):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, f'{prefix}{key}/'))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def load(net, variables):
    """`variables` (params and, for a bn model, batch_stats) into `net`."""
    stats = variables.get('batch_stats')
    return tds.load_jax_params(net, np_tree(variables['params']),
                               None if stats is None else np_tree(stats))


@contextlib.contextmanager
def jax_draws():
    """Record every dropout draw of the JAX package (its `Dropout` and
    `DropPath` call `jax.random.bernoulli`, `normal` and `uniform`) in call
    order, as (kind, numpy array). Run the JAX model eagerly inside."""
    draws = []
    real = {k: getattr(jax.random, k) for k in ('bernoulli', 'normal',
                                                'uniform')}

    def recorder(kind):
        def draw(*args, **kwargs):
            value = real[kind](*args, **kwargs)
            draws.append((kind, np.asarray(value)))
            return value
        return draw
    for kind in real:
        setattr(jax.random, kind, recorder(kind))
    try:
        yield draws
    finally:
        for kind, fn in real.items():
            setattr(jax.random, kind, fn)


@contextlib.contextmanager
def fed_draws(draws):
    """Feed `draws` (from `jax_draws`) to the port's `_dropout_mask` in
    order; each must match the draw the port asks for in kind and shape,
    and all must be used."""
    queue = list(draws)
    real = tblocks._dropout_mask

    def feed(shape, keep, generator, dtype, device, kind='bernoulli'):
        assert queue, f'the port drew more than JAX ({kind}, {shape})'
        got_kind, value = queue.pop(0)
        assert got_kind == kind and tuple(value.shape) == tuple(shape), (
            got_kind, value.shape, kind, shape)
        return t(value).to(device)
    tblocks._dropout_mask = feed
    try:
        yield queue
    finally:
        tblocks._dropout_mask = real
    assert not queue, f'{len(queue)} JAX draws left unused'


def assert_tree_close(net_or_tree, want, tol=TOL, scaled=False, what=''):
    """Flattened `want` (a Flax tree) against the same leaves of a port
    tree; with `scaled` each leaf's atol is scaled by its max |want|."""
    got = flat(net_or_tree)
    want = flat(np_tree(want))
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30) if scaled else 1.0
        np.testing.assert_allclose(got[name], w, atol=tol['atol'] * scale,
                                   rtol=tol['rtol'],
                                   err_msg=f'{what} {name}')


def check_train_step(module_apply, variables, net, inputs, seed,
                     training=True, rngs=None, tol=TOL, eager=False,
                     grads=True):
    """The JAX module's `apply(variables, *inputs, training=...)` (with the
    `batch_stats` collection mutable in train mode) against `net` in the
    same mode: the outputs, the gradients of mean(out * r) with respect to
    every parameter and the first input, and the updated running
    statistics, within `tol`. With `eager` the JAX side runs op by op and
    its dropout draws (from `rngs`, or an 'mc*' dropout's fixed key) are
    recorded and fed to the port; otherwise it is jitted and must draw
    nothing. With `grads=False` the forward alone is compared (an eval-mode
    check of a model whose gradients a train-mode check holds). Returns
    the JAX output."""
    rest = [j(a) for a in inputs[1:]]
    has_bn = 'batch_stats' in variables
    stats = variables.get('batch_stats')

    def f(p, x):
        v = {'params': p}
        if has_bn:
            v['batch_stats'] = stats
        if training and has_bn:
            return module_apply(v, x, *rest, training=True,
                                mutable=['batch_stats'], rngs=rngs)
        return module_apply(v, x, *rest, training=training, rngs=rngs), {}

    def run(p, x, r):
        out, vjp, updates = jax.vjp(f, p, x, has_aux=True)
        return (out, updates) + vjp(r / r.size)

    x0 = j(inputs[0])
    if not grads:
        run_fwd = (lambda p, x: f(p, x)[0]) if eager else jax.jit(
            lambda p, x: f(p, x)[0])
        with jax_draws() as draws:
            want = np.asarray(run_fwd(variables['params'], x0))
        assert eager or not draws, 'a jitted check of a model that draws'
        net.train(training)
        with fed_draws(draws), torch.no_grad():
            got = net(*map(t, inputs))
        np.testing.assert_allclose(got.numpy(), want, **tol)
        return want
    shape = jax.eval_shape(lambda p, x: f(p, x)[0], variables['params'],
                           x0).shape
    r = np.random.default_rng(seed).standard_normal(shape).astype(
        np.asarray(inputs[0]).dtype)
    with jax_draws() as draws:
        out, updates, gp, gx = (run if eager else jax.jit(run))(
            variables['params'], x0, jnp.asarray(r))
    if not eager:
        assert not draws, 'a jitted check of a model that draws'
    want = np.asarray(out)
    net.train(training)
    x = t(inputs[0]).requires_grad_(True)
    net.zero_grad()
    with fed_draws(draws):
        got = net(x, *map(t, inputs[1:]))
    torch.mean(got * t(r)).backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    grads = {name: p.grad.numpy() for name, p in net.named_parameters()}
    ref = tds.load_jax_params(copy.deepcopy(net), np_tree(gp),
                              np_tree(stats) if has_bn else None)
    assert len(grads) == len(dict(ref.named_parameters()))
    floor = 1e-2 * max(float(g.detach().abs().max())
                       for g in ref.parameters())
    for name, g in ref.named_parameters():
        scale = max(float(g.detach().abs().max()), floor, 1e-30)
        np.testing.assert_allclose(grads[name], g.detach().numpy(),
                                   atol=tol['atol'] * scale,
                                   rtol=tol['rtol'], err_msg=name)
    gx = np.asarray(gx)
    np.testing.assert_allclose(x.grad.numpy(), gx,
                               atol=tol['atol'] * max(np.abs(gx).max(),
                                                      1e-30),
                               rtol=tol['rtol'])
    if training and has_bn:
        assert_tree_close(tds.weights.export_jax_variables(net)[
            'batch_stats'], updates['batch_stats'], tol,
            what='batch_stats')
    return want


def check_bf16_forward(jax_factory, port_factory, args, kwargs, inputs,
                       seed=0, ratio=0.5, variables=None):
    """tests/test_torch_bf16_models.py's mean criterion for a bfloat16
    model: the port's bfloat16 output is at most `ratio` of JAX's own
    float32-to-bfloat16 distance from JAX's bfloat16 output (mean |d| over
    mean |jax_bf16|), in eval mode, with the same float32 variables. JAX
    runs eagerly, as the port rounds each op. Returns (port, own)."""
    j32 = jax_factory(*args, **kwargs)
    j16 = jax_factory(*args, dtype=jnp.bfloat16, **kwargs)
    v = variables or jax.jit(j32.init)(jax.random.PRNGKey(seed))
    net = load(port_factory(*args, dtype=torch.bfloat16, **kwargs).init(
        seed, device='cpu'), v)
    want = np.asarray(j16.apply(v, *map(j, inputs)).astype(jnp.float32))
    y32 = np.asarray(j32.apply(v, *map(j, inputs)))
    with torch.no_grad():
        y = net(*map(t, inputs))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == want.shape
    scale = np.abs(want).mean()
    port = np.abs(y.float().numpy() - want).mean() / scale
    own = np.abs(y32 - want).mean() / scale
    assert own > 1e-4
    assert port <= ratio * own, (port, own)
    return port, own
