"""PyTorch port's deep ensembles (`dl4ds_tpu_torch.parallel.init_ensemble`,
`make_ensemble_step`, `predict_ensemble`) against the JAX package's on the
CPU, from the JAX stack carried across by `weights.load_jax_ensemble`, and
K1's member mode (the gate under `torch.func.vmap` with stacked weights)
against the per-member gate and JAX `vmap` of the interpreted Pallas
kernel. Small size: resnet_spc x2, n_filters=4, n_blocks=1, 8x8 LR grids,
4 members, batch 8, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import dl4ds_tpu as dds
from dl4ds_tpu import metrics as jmetrics
from dl4ds_tpu import parallel as jpar
from dl4ds_tpu.ops.pallas_ops import (
    fused_channel_attention as jax_fused_channel_attention)

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import metrics as tmetrics
from dl4ds_tpu_torch import parallel as tpar
from dl4ds_tpu_torch.ops import fused_ops as fo
from dl4ds_tpu_torch.weights import export_jax_ensemble, load_jax_ensemble
from _torch_xla import quick_xla  # noqa: F401

M, STEPS = 4, 3
# losses: float32 means over 8*16*16 pixels; parameters after 3 Adam steps
# of lr 1e-4: float32 gradients in another sum order, which Adam's
# lr * g / (|g| + eps) turns into at most a few 1e-7 of a step
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-6


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _kw(**kw):
    return dict(dict(backbone_block='resnet', upsampling='spc', scale=2,
                     n_channels=1, n_aux_channels=0, lr_size=(8, 8),
                     n_filters=4, n_blocks=1, attention=False), **kw)


def _data(seed=0, b=8, aux=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 8, 8, 1)).astype(np.float32)
    y = rng.standard_normal((b, 16, 16, 1)).astype(np.float32)
    a = rng.standard_normal((b, 16, 16, aux)).astype(np.float32)
    return x, y, (a if aux else None)


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


@pytest.fixture(scope='module', params=[False, True], ids=['plain', 'gated'])
def trained(request):
    """3 steps of the JAX ensemble step (bootstrap off, a one-device mesh)
    and of the port's from the same stack: per-step losses and the final
    stacks."""
    kw = _kw(attention=request.param)
    jm, tm = dds.net_postupsampling(**kw), tds.net_postupsampling(**kw)
    stacked = jpar.init_ensemble(jm, M, seed=0)
    x, y, _ = _data()
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


def test_ensemble_step_matches_jax(trained):
    np.testing.assert_allclose(np.stack(trained['got']),
                               np.stack(trained['want']), rtol=LOSS_RTOL)
    want = _flat(_as_numpy(trained['jax_end'])['params'])
    got = _flat(export_jax_ensemble(trained['tm'], trained['end']))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL,
                                   err_msg=name)


def test_member_equals_that_member_trained_alone(trained):
    """Member 2 of the vmapped step follows the same member trained alone
    in the port (plain autograd, torch.optim.Adam with optax's settings)."""
    tm, x, y = trained['tm'], trained['x'], trained['y']
    net = tm.init(0, device='cpu').train()
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(trained['start'][name][2])
    opt = torch.optim.Adam(net.parameters(), lr=1e-4, eps=1e-8)
    losses = []
    for _ in range(STEPS):
        loss = tds.losses.mae(torch.from_numpy(y),
                              net(torch.from_numpy(x)).float())
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, np.stack(trained['got'])[:, 2],
                               rtol=LOSS_RTOL)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(trained['end'][name][2].numpy(),
                                   p.detach().numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


def test_aux_branch_trains_and_is_required():
    tm = tds.net_postupsampling(**_kw(n_aux_channels=2))
    st = tpar.init_ensemble(tm, M, seed=1, device='cpu')
    es = tpar.make_ensemble_step(tm, loss='mae', bootstrap=False)
    opt = es.init_opt(st)
    x, y, aux = _data(aux=2)
    start = {k: t.clone() for k, t in st.items()}
    with pytest.raises(ValueError, match='aux branch'):
        es.step(st, opt, x, y, 0)
    st, opt, losses = es.step(st, opt, x, y, 0, aux=aux)
    assert losses.shape == (M,) and torch.isfinite(losses).all()
    moved = [(st[k] - start[k]).abs().max().item() for k in st
             if 'aux' in k.lower()]
    assert moved and max(moved) > 0


def test_bootstrap_decorrelates_members():
    """Members from one init, each on its own resample of the batch (drawn
    from the step's generator), differ after a step; without bootstrap
    they stay equal."""
    tm = tds.net_postupsampling(**_kw())
    one = tm.init(0, device='cpu')
    x, y, _ = _data()
    ends = {}
    for boot in (True, False):
        st = {n: p.detach()[None].repeat(M, *[1] * p.dim())
              for n, p in one.named_parameters()}
        es = tpar.make_ensemble_step(tm, loss='mae', bootstrap=boot)
        st, _, _ = es.step(st, es.init_opt(st), x, y, 3)
        ends[boot] = st
    assert any((t[0] - t[1]).abs().max() > 0 for t in ends[True].values())
    assert all(torch.equal(t[0], t[1]) for t in ends[False].values())


def test_dssim_step_and_dropout_per_member():
    """A `dssim_mae` step (K6 under vmap, each member's own data range)
    gives each member the loss and update of that member stepped alone;
    with dropout, members from one init draw their own masks under vmap's
    randomness='different' and part."""
    tm = tds.net_postupsampling(**_kw(attention=True))
    st = tpar.init_ensemble(tm, 2, seed=2, device='cpu')
    start = {k: t.clone() for k, t in st.items()}
    x, y, _ = _data(seed=4)
    es = tpar.make_ensemble_step(tm, loss='dssim_mae', bootstrap=False)
    st, _, losses = es.step(st, es.init_opt(st), x, y, 0)
    for i in range(2):
        one = {k: t[i:i + 1].clone() for k, t in start.items()}
        one, _, li = es.step(one, es.init_opt(one), x, y, 0)
        np.testing.assert_allclose(losses[i].item(), li.item(),
                                   rtol=LOSS_RTOL)
        for k in st:
            torch.testing.assert_close(st[k][i], one[k][0], atol=PARAM_ATOL,
                                       rtol=0)
    drop = tds.net_postupsampling(**_kw(dropout_rate=0.5,
                                        dropout_variant='spatial'))
    net = drop.init(0, device='cpu')
    st = {n: p.detach()[None].repeat(2, *[1] * p.dim())
          for n, p in net.named_parameters()}
    es = tpar.make_ensemble_step(drop, loss='mae', bootstrap=False)
    st, _, losses = es.step(st, es.init_opt(st), x, y, 0)
    assert losses[0] != losses[1]


def test_predict_ensemble_matches_jax_and_feeds_crps(trained):
    """Mean, population std and the member stack against JAX's on the same
    members; the stack feeds `crps_ensemble` as the JAX one does."""
    x = np.random.default_rng(9).standard_normal((3, 8, 8, 1)).astype(
        np.float32)
    y = np.random.default_rng(10).standard_normal((3, 16, 16, 1)).astype(
        np.float32)
    want = jpar.predict_ensemble(trained['jm'], trained['jax_start'], x,
                                 return_members=True)
    got = tpar.predict_ensemble(trained['tm'], trained['start'], x,
                                return_members=True)
    assert got[2].shape == (M, 3, 16, 16, 1)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5)
    assert got[1].max() > 1e-6
    np.testing.assert_allclose(tmetrics.crps_ensemble(y, got[2]),
                               np.asarray(jmetrics.crps_ensemble(y, want[2])),
                               atol=1e-5, rtol=1e-5)


def test_refusals():
    """Batch norm is the JAX package's ValueError. Spatio-temporal models
    are ported (tests/test_torch_ensemble_recurrent.py), and so are meshes
    (tests/test_torch_distributed_serving.py): one that is not a
    DeviceMesh is a TypeError."""
    bn = tds.net_postupsampling(**_kw(normalization='bn'))
    with pytest.raises(ValueError, match='batch-norm'):
        tpar.init_ensemble(bn, 2, device='cpu')
    rec_bn = tds.recnet_postupsampling(**_kw(normalization='bn'),
                                       time_window=3)
    with pytest.raises(ValueError, match='batch-norm'):
        tpar.init_ensemble(rec_bn, 2, device='cpu')
    x = np.zeros((2, 3, 8, 8, 1), np.float32)
    tm = tds.net_postupsampling(**_kw())
    stack = {'w': torch.zeros(2, 1)}
    for call in (lambda: tpar.init_ensemble(tm, 2, mesh=object(),
                                            device='cpu'),
                 lambda: tpar.make_ensemble_step(tm, object()),
                 lambda: tpar.predict_ensemble(tm, stack, x, mesh=object())):
        with pytest.raises(TypeError, match='DeviceMesh'):
            call()


def test_save_load_stack_both_ways(trained, tmp_path):
    """The port's stack saved is read by the JAX `load_model` (leaves with
    the member axis); a JAX stack saved by the JAX `save_model` is read by
    the port's `load_model` as (model, stacked)."""
    tm, st = trained['tm'], trained['start']
    tds.save_model(tm, st, str(tmp_path / 'port'))
    jm2, jv = dds.load_model(str(tmp_path / 'port'))
    got, want = _flat(_as_numpy(jv)['params']), _flat(
        _as_numpy(trained['jax_start'])['params'])
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    dds.save_model(trained['jm'], trained['jax_start'], str(tmp_path / 'jax'))
    tm2, st2 = tds.load_model(str(tmp_path / 'jax'), device='cpu')
    assert tm2.name == tm.name and isinstance(st2, dict)
    assert st2.keys() == st.keys()
    for name in st:
        assert torch.equal(st2[name], st[name]), name
    # the port's own file reads back as a stack too
    _, st3 = tds.load_model(str(tmp_path / 'port'), device='cpu')
    assert all(torch.equal(st3[n], st[n]) for n in st)


# K1's member mode, plain version: (M, B, H, W, C, Cr)
MEMBER_SHAPES = [(3, 4, 5, 7, 8, 2), (2, 3, 6, 4, 12, 3)]


def _member_inputs(shape, seed=0):
    m, b, h, w, c, cr = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return [f(m, b, h, w, c), f(m, c, cr) * 0.5, f(m, cr) * 0.1,
            f(m, cr, c) * 0.5, f(m, c) * 0.1]


@pytest.mark.parametrize('shape', MEMBER_SHAPES)
def test_k1_member_mode_matches_jax_vmap(shape, monkeypatch):
    """`torch.func.vmap` of the gate over members reaches the member mode
    (stacked weights, one call each way) and gives JAX `vmap` of the
    interpreted Pallas kernel's values and `jax.vjp` gradients; the member
    mode is the per-member gate."""
    args = _member_inputs(shape)
    dy = np.random.default_rng(1).standard_normal(args[0].shape).astype(
        np.float32)
    want_y, vjp = jax.vjp(jax.vmap(
        lambda *a: jax_fused_channel_attention(*a, interpret=True)),
        *map(jnp.asarray, args))
    want_g = vjp(jnp.asarray(dy))

    seen = []
    for name in ('_plain_forward', '_plain_backward'):
        inner = getattr(fo, name)
        monkeypatch.setattr(fo, name, lambda *a, _i=inner, _n=name, **k: (
            seen.append((_n, a[1].dim())), _i(*a, **k))[1])
    tx = [torch.from_numpy(a) for a in args]
    y, vjp_fn = torch.func.vjp(torch.func.vmap(fo.fused_channel_attention),
                               *tx)
    grads = vjp_fn(torch.from_numpy(dy))
    # one call each way with the stacked weights (the forward's per-member
    # calls come after its own)
    assert seen[0] == ('_plain_forward', 3)
    assert [s for s in seen if s[1] == 3] == [('_plain_forward', 3),
                                              ('_plain_backward', 3)]
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5,
                               rtol=1e-5)
    for name, g, w in zip(('x', 'w1', 'b1', 'w2', 'b2'), grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=f'd{name}')
    # the member axis mapped from another dim of x
    y1, vjp1 = torch.func.vjp(torch.func.vmap(
        fo.fused_channel_attention, in_dims=(1, 0, 0, 0, 0)),
        tx[0].movedim(0, 1), *tx[1:])
    torch.testing.assert_close(y1, y, atol=0, rtol=0)
    g1 = vjp1(torch.from_numpy(dy))
    torch.testing.assert_close(g1[0].movedim(1, 0), grads[0], atol=0, rtol=0)
    for a, b in zip(g1[1:], grads[1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    for i in range(shape[0]):
        leaves = [t[i].clone().requires_grad_() for t in tx]
        yi = fo.channel_attention_reference(*leaves)
        gi = torch.autograd.grad(yi, leaves, torch.from_numpy(dy[i]))
        torch.testing.assert_close(y[i], yi.detach(), atol=1e-6, rtol=1e-6)
        for g, r in zip(grads, gi):
            torch.testing.assert_close(g[i], r, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('shape,members', [((512, 16, 16, 8), 4),
                                           ((64, 128, 128, 8), 4),
                                           ((60, 40, 40, 16), 3)])
def test_k1_member_plan_is_a_members_own(shape, members):
    """The member mode's plan cuts each sample as a one-member call on
    B / M samples does (the H100's limits), so that its sums are that
    call's."""
    limits = (132, 232448 - fo._STATIC_SMEM_RESERVE)
    one = (shape[0] // members,) + shape[1:]
    got = fo._ca_plan(shape, 2, torch.float32, *limits, members=members)
    want = fo._ca_plan(one, 2, torch.float32, *limits)
    for key in ('regime', 'vec', 'parts', 'ppp', 'region', 'smem',
                'bwd_region', 'bwd_smem'):
        assert got[key] == want[key], key
