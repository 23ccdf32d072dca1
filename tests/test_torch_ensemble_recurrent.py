"""PyTorch port's deep ensembles of the spatio-temporal models
(`dl4ds_tpu_torch.parallel.init_ensemble`, `make_ensemble_step`,
`predict_ensemble` of a `recnet_postupsampling` model) against the JAX
package's on the CPU, from the JAX stack carried across by
`weights.load_jax_ensemble`, and the ConvLSTM layer's member mode (K2, K3
and K4 under `torch.func.vmap` with stacked weights; on the CPU their plain
versions member by member) against per-member calls and the JAX package's
interpreted Pallas layer run member by member. The JAX package's Pallas
ConvLSTM cannot be vmapped (its `custom_partitioning` wrappers have no
batching rule), so its ensembles run the XLA recurrence off the TPU, the
same function, which is the reference here. Small size: recnet resnet_spc
x2, n_filters 4, n_blocks 1, time_window 3, 8x8 LR grids, 3 members, batch
4, float32."""

import ctypes
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import dl4ds_tpu as dds
import dl4ds_tpu.ops.pallas_convlstm as jax_pallas_convlstm
from dl4ds_tpu import metrics as jmetrics
from dl4ds_tpu import parallel as jpar

import dl4ds_tpu_torch as tds
import dl4ds_tpu_torch.ops.convlstm as conv
from dl4ds_tpu_torch import metrics as tmetrics
from dl4ds_tpu_torch import parallel as tpar
from dl4ds_tpu_torch.ops.convlstm import FusedConvLSTM
from dl4ds_tpu_torch.weights import export_jax_ensemble, load_jax_ensemble
from _torch_xla import quick_xla  # noqa: F401

M, STEPS, T, BATCH = 3, 3, 3, 4
# tests/test_torch_ensemble.py's: losses are float32 means; parameters
# after 3 Adam steps of lr 1e-4 differ by the gradients' float32 sum order
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6
# the layer against the interpreted Pallas layer, as
# tests/test_torch_convlstm_grad.py holds one layer: ys and dx 1e-5, the
# weight and bias gradients (sums over every pixel) 1e-4
YS_TOL, GRAD_TOL = 1e-5, dict(dx=1e-5, dwx=1e-4, dbx=1e-4, dwh=1e-4)
CSRC = Path(conv.__file__).resolve().parent.parent / 'csrc'


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _kw(**kw):
    return dict(dict(backbone_block='resnet', upsampling='spc', scale=2,
                     n_channels=1, n_aux_channels=0, lr_size=(8, 8),
                     time_window=T, n_filters=4, n_blocks=1), **kw)


def _data(seed=0, b=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((b, T, 16, 16, 1)).astype(np.float32)
    return x, y


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}/'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope='module')
def trained():
    """3 steps of the JAX ensemble step (bootstrap off, a one-device
    ('ensemble',) mesh) and of the port's from the same stack: per-step
    losses and the final stacks."""
    jm, tm = dds.recnet_postupsampling(**_kw()), tds.recnet_postupsampling(
        **_kw())
    stacked = jpar.init_ensemble(jm, M, seed=0)
    x, y = _data()
    mesh = Mesh(np.array(jax.devices()[:1]), ('ensemble',))
    es = jpar.make_ensemble_step(jm, mesh, tx=optax.adam(1e-4), loss='mae',
                                 bootstrap=False)
    v, o, want = stacked, es.init_opt(stacked), []
    for k in range(STEPS):
        v, o, losses = es.step(v, o, x, y, jax.random.PRNGKey(k))
        want.append(np.asarray(losses))
    start = load_jax_ensemble(tm, _as_numpy(stacked), 'cpu')
    st = {k: t.clone() for k, t in start.items()}
    ts = tpar.make_ensemble_step(tm, loss='mae', bootstrap=False)
    opt, got = ts.init_opt(st), []
    for k in range(STEPS):
        st, opt, losses = ts.step(st, opt, x, y, k)
        got.append(losses.numpy())
    return dict(jm=jm, tm=tm, jax_start=stacked, start=start, jax_end=v,
                end=st, want=want, got=got, x=x, y=y)


def test_recurrent_ensemble_step_matches_jax(trained):
    """The members' losses of 3 steps and their final weights against the
    JAX package's step; the stack carries back to the JAX tree."""
    got, want = np.stack(trained['got']), np.stack(trained['want'])
    assert got.shape == (STEPS, M)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    want = _flat(_as_numpy(trained['jax_end'])['params'])
    got = _flat(export_jax_ensemble(trained['tm'], trained['end']))
    assert got.keys() == want.keys()
    assert any('ConvLSTM' in k for k in got)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize('member', [0, M - 1])
def test_member_equals_that_member_trained_alone(trained, member):
    """Member k of the vmapped step follows the same member trained alone
    in the port (plain autograd, torch.optim.Adam with optax's settings)."""
    tm, x, y = trained['tm'], trained['x'], trained['y']
    net = tm.init(0, device='cpu').train()
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(trained['start'][name][member])
    opt = torch.optim.Adam(net.parameters(), lr=1e-4, eps=1e-8)
    losses = []
    for _ in range(STEPS):
        loss = tds.losses.mae(torch.from_numpy(y),
                              net(torch.from_numpy(x)).float())
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, np.stack(trained['got'])[:, member],
                               rtol=LOSS_RTOL)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(trained['end'][name][member].numpy(),
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


def test_predict_ensemble_matches_jax_and_feeds_crps(trained):
    """Mean, population std and the member stack [M, N, T, H, W, C] against
    JAX's on the same members; the stack feeds `crps_ensemble` as the JAX
    one does."""
    x, y = _data(seed=9, b=3)
    want = jpar.predict_ensemble(trained['jm'], trained['jax_start'], x,
                                 return_members=True)
    got = tpar.predict_ensemble(trained['tm'], trained['start'], x,
                                return_members=True)
    assert got[2].shape == (M, 3, T, 16, 16, 1)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    assert got[1].max() > 1e-6
    np.testing.assert_allclose(tmetrics.crps_ensemble(y, got[2]),
                               np.asarray(jmetrics.crps_ensemble(y, want[2])),
                               atol=1e-5, rtol=1e-5)


def test_save_load_recurrent_stack_both_ways(trained, tmp_path):
    """The port's recurrent stack saved is read by the JAX `load_model`
    (leaves with the member axis); a JAX stack saved by the JAX
    `save_model` is read by the port's `load_model` as (model, stacked)."""
    tm, st = trained['tm'], trained['start']
    tds.save_model(tm, st, str(tmp_path / 'port'))
    _, jv = dds.load_model(str(tmp_path / 'port'))
    got, want = _flat(_as_numpy(jv)['params']), _flat(
        _as_numpy(trained['jax_start'])['params'])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    dds.save_model(trained['jm'], trained['jax_start'], str(tmp_path / 'jax'))
    tm2, st2 = tds.load_model(str(tmp_path / 'jax'), device='cpu')
    assert tm2.name == tm.name and st2.keys() == st.keys()
    for name in st:
        assert torch.equal(st2[name], st[name]), name


def test_bootstrap_and_dropout_part_members():
    """Members from one init, each on its own resample of the batch, differ
    after a step, and stay equal without the bootstrap; with dropout they
    draw their own masks under vmap's randomness='different' and part."""
    x, y = _data(seed=4)
    for kw, boot in ((_kw(), True), (_kw(), False),
                     (_kw(dropout_rate=0.5, dropout_variant='spatial'),
                      False)):
        tm = tds.recnet_postupsampling(**kw)
        net = tm.init(0, device='cpu')
        st = {n: p.detach()[None].repeat(2, *[1] * p.dim())
              for n, p in net.named_parameters()}
        es = tpar.make_ensemble_step(tm, loss='mae', bootstrap=boot)
        st, _, losses = es.step(st, es.init_opt(st), x, y, 3)
        apart = max((t[0] - t[1]).abs().max().item() for t in st.values())
        if boot or 'dropout_rate' in kw:
            assert apart > 0 and losses[0] != losses[1]
        else:
            assert apart == 0 and losses[0] == losses[1]


# The member mode's plain version: (M, B, T, H, W, Cin, F, k)
LAYER_SHAPES = [(3, 2, 3, 6, 7, 2, 4, 3), (2, 2, 2, 5, 5, 4, 3, 5)]


def _layer_inputs(shape, seed=0):
    m, b, t, h, w, cin, f, k = shape
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return ([n(m, b, t, h, w, cin), 0.3 * n(m, k, k, cin, 4 * f),
             0.1 * n(m, 4 * f), 0.3 * n(m, k, k, f, 4 * f)],
            n(m, b, t, h, w, f))


_JAX_LAYER = {}


def _jax_layer(shape):
    """Each member's ys and `jax.vjp` gradients through the interpreted
    Pallas layer, once a shape for both routes."""
    if shape not in _JAX_LAYER:
        args, dys = _layer_inputs(shape)
        refs = []
        for i in range(shape[0]):
            ys, vjp = jax.vjp(
                lambda *a: jax_pallas_convlstm.fused_convlstm(
                    *a, interpret=True), *(jnp.asarray(a[i]) for a in args))
            refs.append((np.asarray(ys), [np.asarray(g) for g in
                                          vjp(jnp.asarray(dys[i]))]))
        _JAX_LAYER[shape] = refs
    return _JAX_LAYER[shape]


def _seen_stacks(monkeypatch, names):
    """Record the calls of the plain versions `names` as (name, dims of
    their weight argument): a member-mode call has a weight stack of 5."""
    seen = []
    for name in names:
        inner = getattr(conv, name)
        where = 3 if name == 'convlstm_seq_reference' else 1

        def spy(*a, _i=inner, _n=name, _w=where, **k):
            seen.append((_n, a[_w].dim()))
            return _i(*a, **k)
        monkeypatch.setattr(conv, name, spy)
    return seen


@pytest.mark.parametrize('route', ['fused', 'split'])
@pytest.mark.parametrize('shape', LAYER_SHAPES)
def test_member_mode_under_vmap(shape, route, monkeypatch):
    """`torch.func.vmap` of the layer over members reaches the member mode
    (stacked weights, one call each way: K2's, then K3's or K4's plain
    version) and gives each member's per-member call, ys and (dx, dWx, db,
    dWh), and the interpreted Pallas layer's ys and `jax.vjp` gradients;
    with x not mapped (an ensemble's first layer) the same; under no_grad
    the operator's rule, the same ys."""
    args, dys = _layer_inputs(shape)
    tx = [torch.from_numpy(a) for a in args]
    tdys = torch.from_numpy(dys)
    seen = _seen_stacks(monkeypatch, (
        'convlstm_train_reference', 'convlstm_backward_reference',
        'convlstm_seq_reference', 'convlstm_backward_tail'))
    layer = torch.func.vmap(lambda *a: FusedConvLSTM.apply(*a, route))
    ys, vjp_fn = torch.func.vjp(layer, *tx)
    grads = vjp_fn(tdys)
    stacked = [s for s in seen if s[1] == 5]
    want_calls = ([('convlstm_train_reference', 5),
                   ('convlstm_backward_reference', 5)] if route == 'fused'
                  else [('convlstm_train_reference', 5),
                        ('convlstm_seq_reference', 5),
                        ('convlstm_backward_tail', 5)])
    assert stacked == want_calls
    for i, (want_y, want_g) in enumerate(_jax_layer(shape)):
        leaves = [t[i].clone().requires_grad_() for t in tx]
        yi = FusedConvLSTM.apply(*leaves, route)
        gi = torch.autograd.grad(yi, leaves, tdys[i])
        torch.testing.assert_close(ys[i], yi.detach(), atol=1e-6, rtol=1e-6)
        for g, r in zip(grads, gi):
            torch.testing.assert_close(g[i], r, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(ys[i].numpy(), want_y, atol=YS_TOL)
        for name, g, w in zip(GRAD_TOL, grads, want_g):
            np.testing.assert_allclose(g[i].numpy(), w, atol=GRAD_TOL[name],
                                       err_msg=name)
    # x shared by the members: its gradient is each member's own
    shared = torch.func.vmap(lambda *a: FusedConvLSTM.apply(*a, route),
                             in_dims=(None, 0, 0, 0))
    ys0, vjp0 = torch.func.vjp(shared, tx[0][0], *tx[1:])
    g0 = vjp0(tdys)
    ys1, vjp1 = torch.func.vjp(layer, tx[0][:1].expand_as(tx[0]), *tx[1:])
    g1 = vjp1(tdys)
    torch.testing.assert_close(ys0, ys1, atol=0, rtol=0)
    torch.testing.assert_close(g0[0], g1[0].sum(0), atol=1e-6, rtol=1e-6)
    for a, b in zip(g0[1:], g1[1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with torch.no_grad():
        seen.clear()
        served = torch.func.vmap(tds.fused_convlstm)(*tx)
    assert [s for s in seen if s[1] == 5] == [('convlstm_train_reference',
                                               5)]
    torch.testing.assert_close(served, ys, atol=0, rtol=0)


def test_nested_member_stack_raises():
    """The layer has one member axis: vmap over weights that are already a
    member stack raises, with grad mode on and off."""
    args, _ = _layer_inputs(LAYER_SHAPES[0])
    tx = [torch.from_numpy(a)[None].repeat(2, *[1] * a.ndim) for a in args]
    nested = torch.func.vmap(torch.func.vmap(tds.fused_convlstm))
    with pytest.raises(NotImplementedError, match='member stack'):
        nested(*tx)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match='member stack'):
        nested(*tx)


# (M, B, T, H, W, Cin, F, k, itemsize): config 4's layers at batch 128
# (width 8 and 64), small batches where the flattened batch would plan
# otherwise (more channels a block, fewer tiles a weight-gradient block),
# bfloat16
PLAN_SHAPES = [(4, 128, 4, 16, 16, 1, 8, 5, 4),
               (4, 128, 4, 16, 16, 8, 8, 3, 4),
               (4, 128, 4, 16, 16, 64, 64, 5, 4),
               (4, 8, 4, 16, 16, 64, 64, 3, 4),
               (3, 4, 2, 9, 11, 3, 12, 3, 4),
               (4, 8, 4, 16, 16, 64, 64, 5, 2)]


class _Lib:
    """A stand-in for a compiled ConvLSTM library: every call succeeds."""

    def __getattr__(self, name):
        return lambda *args: 0


def _member_plans(b, t, h, w, cin, f, k, n_sm, elem):
    """The plans of a layer's launches for b samples of one member: K2's,
    the chain step's, dx's and the two weight-gradient passes'."""
    return {'fwd': conv._fwd_plan(b, t, h, w, k, k, f, n_sm, elem),
            'chain': conv._seq_plan(b, h, w, k, k, f, n_sm, elem),
            'dx': conv._seq_plan(b * t, h, w, k, k, cin, n_sm, elem),
            'wgrad_x': conv._wgrad_plan(b, t, 0, h, w, cin, f, k, k, n_sm),
            'wgrad_h': conv._wgrad_plan(b, t, 1, h, w, f, f, k, k, n_sm)}


@pytest.mark.parametrize('shape', PLAN_SHAPES)
def test_member_plans_and_routes_are_a_members_own(shape, monkeypatch):
    """K2's, the chain step's, dx's and the two weight-gradient passes'
    plans of a member-mode call are those of one member's call on its B
    samples: the wrappers of K2, K3 and K4 call `_fwd_plan`, `_seq_plan`
    and `_wgrad_plan` with B (the card's calls, with the device check, the
    library and the stream stubbed here); the route is a member's. For
    these shapes the flattened batch would plan otherwise."""
    m, b, t, h, w, cin, f, k, elem = shape
    n_sm = 132
    per = _member_plans(b, t, h, w, cin, f, k, n_sm, elem)
    naive = _member_plans(m * b, t, h, w, cin, f, k, n_sm, elem)
    assert (naive['wgrad_x']['n_chunks'] != per['wgrad_x']['n_chunks']
            or naive['fwd'] != per['fwd'] or naive['chain'] != per['chain'])
    dtype = torch.bfloat16 if elem == 2 else torch.float32
    x = torch.empty((m * b, t, h, w, cin), dtype=dtype)
    wx = torch.empty((m, k, k, cin, 4 * f), dtype=dtype)
    bx = torch.empty((m, 4 * f), dtype=dtype)
    wh = torch.empty((m, k, k, f, 4 * f), dtype=dtype)
    zs = torch.empty((m * b, t, h, w, 4 * f), dtype=dtype)
    cs = torch.empty((m * b, t, h, w, f), dtype=dtype)
    planned = []

    def spy(name, planner):
        def plan(*args):
            out = planner(*args)
            planned.append((name, out))
            return out
        monkeypatch.setattr(conv, name, plan)
    for name in ('_fwd_plan', '_seq_plan', '_wgrad_plan'):
        spy(name, getattr(conv, name))
    for name in ('launches', 'train_launches', 'bwd_launches',
                 'seq_launches'):
        monkeypatch.setattr(conv.fused_convlstm, name, 0)
    for lib in ('_fwd_lib', '_seq_lib', '_bwd_lib'):
        monkeypatch.setattr(conv, lib, _Lib)
    monkeypatch.setattr(conv, '_check_cuda', lambda t, w: torch.device('cpu'))
    monkeypatch.setattr(conv, '_n_sm', lambda dev: n_sm)
    monkeypatch.setattr(torch.cuda, 'device', lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    want = {'_launch train': [per['fwd']], '_launch': [per['fwd']],
            '_launch_backward': [per['wgrad_x'], per['wgrad_h'],
                                 per['chain'], per['dx']],
            '_launch_seq': [per['chain']]}
    for name, call in (
            ('_launch train', lambda: conv._launch(x, wx, bx, wh, train=True)),
            ('_launch', lambda: conv._launch(x, wx, bx, wh)),
            ('_launch_backward',
             lambda: conv._launch_backward(x, wx, wh, zs, cs, cs, cs)),
            ('_launch_seq', lambda: conv._launch_seq(zs, cs, cs, wh))):
        planned.clear()
        call()
        assert [p for _, p in planned] == want[name], name
    assert conv._route(x, wx, wh) == conv.dispatch_info(
        (b, t, h, w, cin), wx.shape[1:], wh.shape[1:], elem)['path']


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _c_params(path):
    """The ctypes types of every `extern "C"` function's parameters in the
    CUDA source `path`: pointers void*, int int, int64_t int64."""
    out = {}
    text = path.read_text()
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        out[name] = [ctypes.c_void_p if '*' in p
                     else ctypes.c_int64 if 'int64_t' in p else ctypes.c_int
                     for p in params.split(',')]
    return out


@pytest.mark.parametrize('lib,source', [('_fwd_lib', 'convlstm.cu'),
                                        ('_seq_lib', 'convlstm_seq.cu'),
                                        ('_bwd_lib', 'convlstm_bwd.cu')])
def test_bindings_match_the_c_signatures(lib, source, monkeypatch):
    """Each ctypes binding of the ConvLSTM libraries, the member mode's
    argument included, has the parameters of its C function (the sources
    are compiled on the card alone)."""
    want = _c_params(CSRC / source)
    fake = types.SimpleNamespace(**{
        n: types.SimpleNamespace(argtypes=None, restype=None) for n in want})
    monkeypatch.setattr(conv._build, 'load', lambda name: fake)
    getattr(conv, lib)()
    for name, params in want.items():
        assert getattr(fake, name).argtypes == params, name
