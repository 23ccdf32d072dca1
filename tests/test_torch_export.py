"""The port's serving artifacts (`dl4ds_tpu_torch.export`) against the JAX
package's (`dl4ds_tpu.export`) on the CPU: the same seeded weights carried
across by `load_jax_params`, the same numpy inputs to both loaded
artifacts. float32 within 1e-5 of max |y_jax|; bfloat16 by the criterion of
tests/test_torch_bf16_models.py (the port at most half as far from JAX's
bfloat16 artifact as JAX's float32 model is). Also the meta, the refusals,
the kernels' operator nodes in the frozen graph and `torch.library.opcheck`
of the operators. Each JAX artifact is built once, in module fixtures;
small sizes (n_filters 4, grids of 8-12 pixels)."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
from dl4ds_tpu import export as jexport

import dl4ds_tpu_torch as tds
from dl4ds_tpu_torch import export as texport
from dl4ds_tpu_torch.ops import convlstm as tconv
from dl4ds_tpu_torch.ops import fused_ops as tfo

from _torch_state import fed_draws, jax_draws
from _torch_xla import quick_xla  # noqa: F401

REL = 1e-5           # float32: max |d| over max |y_jax|
RATIO = 0.5          # bfloat16: as tests/test_torch_bf16_models.py
K1_OP = 'dl4ds_tpu_torch.channel_attention.default'
K2_OP = 'dl4ds_tpu_torch.convlstm.default'

FLAGSHIP = dict(backbone_block='resnet', upsampling='spc', scale=4,
                n_channels=2, n_aux_channels=2, lr_size=(8, 8), n_filters=4,
                n_blocks=2, attention=True)
REC = dict(backbone_block='resnet', upsampling='spc', scale=2, n_channels=1,
           n_aux_channels=0, lr_size=(8, 8), time_window=3, n_filters=4,
           n_blocks=1)
SPATIAL = dict(backbone_block='resnet', upsampling='spc', scale=2,
               n_channels=1, n_aux_channels=1, lr_size=(8, 8), n_filters=4,
               n_blocks=1)
MC = dict(FLAGSHIP, n_aux_channels=0, n_blocks=1, dropout_rate=0.3,
          dropout_variant='mcdrop')


@pytest.fixture(autouse=True, scope='module')
def _torch_threads():
    torch.set_num_threads(2)


def _pair(factory, kw, seed=0, dtype=None):
    """The JAX model with its variables, the port's model and network with
    the same weights: drawn by the port from `seed` and carried to the Flax
    tree by `export_jax_params` (no JAX init compile), then read back by
    `load_jax_params`."""
    jkw, tkw = dict(kw), dict(kw)
    if dtype is not None:
        jkw['dtype'], tkw['dtype'] = jnp.bfloat16, torch.bfloat16
    jm = getattr(dds, factory)(**jkw)
    tm = getattr(tds, factory)(**tkw)
    params = tds.weights.export_jax_params(tm.init(seed, device='cpu'))
    variables = {'params': jax.tree_util.tree_map(jnp.asarray, params)}
    net = tds.load_jax_params(tm.init(0, device='cpu'), params)
    return jm, variables, tm, net


def _inputs(model, batch, seed=0, spatial=None):
    rng = np.random.default_rng(seed)
    shape = tuple(model.input_shape)
    aux = model.aux_shape
    if spatial is not None:
        shape = (*shape[:-3], *spatial, shape[-1])
        s = model.aux_shape[-3] // model.input_shape[-3] if aux else 1
        aux = aux and (spatial[0] * s, spatial[1] * s, aux[-1])
    x = rng.standard_normal((batch, *shape)).astype(np.float32)
    a = (rng.standard_normal((batch, *aux)).astype(np.float32)
         if aux else None)
    return x, a


def _close(got, want, rel=REL):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def _call(call, x, aux):
    return call(x) if aux is None else call(x, aux)


@pytest.fixture(scope='module')
def artifacts(tmp_path_factory):
    """{name: (JAX model, variables, port model, net, JAX dir, port dir)}:
    the flagship with aux (batch 'poly'), the recurrent model (batch 2 and
    'poly'), the spatial_size override (batch 2, 12x12 grids), the bfloat16
    flagship (batch 'poly')."""
    root = tmp_path_factory.mktemp('artifacts')
    cases = {'flagship': ('net_postupsampling', FLAGSHIP, {}, None),
             'rec_static': ('recnet_postupsampling', REC, dict(batch=2),
                            None),
             'rec_poly': ('recnet_postupsampling', REC, {}, None),
             'spatial': ('net_postupsampling', SPATIAL,
                         dict(batch=2, spatial_size=(12, 12)), None),
             'bf16': ('net_postupsampling', FLAGSHIP, {}, 'bf16')}
    out, pairs = {}, {}
    for name, (factory, kw, opts, dtype) in cases.items():
        key = (factory, tuple(sorted(kw.items())), dtype)
        if key not in pairs:
            pairs[key] = _pair(factory, kw, dtype=dtype)
        jm, variables, tm, net = pairs[key]
        jdir, tdir = str(root / f'{name}_jax'), str(root / f'{name}_port')
        jexport.save_serving_artifact(jm, variables, jdir, **opts)
        texport.save_serving_artifact(tm, net, tdir, **opts)
        out[name] = (jm, variables, tm, net, jdir, tdir)
    return out


@pytest.mark.parametrize('batch', [1, 3, 5])
def test_poly_batch_artifact_matches_jax(artifacts, batch):
    """One symbolic-batch artifact with aux serves batches 1, 3 and 5 as
    the JAX artifact does."""
    _, _, tm, _, jdir, tdir = artifacts['flagship']
    jcall, _ = jexport.load_serving_artifact(jdir)
    tcall, meta = texport.load_serving_artifact(tdir)
    x, aux = _inputs(tm, batch, seed=batch)
    y = tcall(x, aux)
    assert y.dtype == torch.float32 and meta['batch'] == 'poly'
    _close(y, jcall(x, aux))


@pytest.mark.parametrize('name', ['rec_static', 'rec_poly'])
def test_recurrent_artifact_matches_jax(artifacts, name):
    """A spatio-temporal artifact, static batch and symbolic batch (K2's
    inference operator in the graph)."""
    _, _, tm, _, jdir, tdir = artifacts[name]
    jcall, _ = jexport.load_serving_artifact(jdir)
    tcall, meta = texport.load_serving_artifact(tdir)
    batches = [2] if name == 'rec_static' else [1, 3]
    for b in batches:
        x, _ = _inputs(tm, b, seed=b)
        _close(tcall(x), jcall(x))
    assert meta['input_shape'] == [3, 8, 8, 1]


def test_spatial_size_override_and_meta(artifacts):
    """spatial_size exports a full-grid artifact of a patch-trained model
    (tests/test_export.py:85, :105): 12x12 LR grids, aux on 24x24; the meta
    has JAX's keys with `torch_version` for `jax_version`, and JAX's
    values."""
    _, _, tm, _, jdir, tdir = artifacts['spatial']
    jcall, jmeta = jexport.load_serving_artifact(jdir)
    tcall, tmeta = texport.load_serving_artifact(tdir)
    assert tmeta['input_shape'] == [12, 12, 1]
    assert tmeta['aux_shape'] == [24, 24, 1]
    assert set(tmeta) == set(jmeta) - {'jax_version'} | {'torch_version'}
    assert tmeta['torch_version'] == torch.__version__
    for key in set(jmeta) - {'jax_version'}:
        assert tmeta[key] == jmeta[key], key
    x, aux = _inputs(tm, 2, spatial=(12, 12))
    y = tcall(x, aux)
    assert tuple(y.shape) == (2, 24, 24, 1)
    _close(y, jcall(x, aux))


def test_flagship_meta_equals_the_jax_meta(artifacts):
    _, _, _, _, jdir, tdir = artifacts['flagship']
    with open(os.path.join(jdir, 'serving_meta.json')) as fh:
        jmeta = json.load(fh)
    with open(os.path.join(tdir, 'serving_meta.json')) as fh:
        tmeta = json.load(fh)
    jmeta.pop('jax_version')
    assert tmeta.pop('torch_version') == torch.__version__
    assert tmeta == jmeta


def test_bf16_artifact_matches_jax(artifacts):
    """The bfloat16 flagship's artifact returns bfloat16, as the JAX one.
    Against the JAX bfloat16 model run eagerly (the reference of
    tests/test_torch_bf16_models.py, where each op rounds as the port's
    does) it is at most RATIO of JAX's float32-to-bfloat16 distance (it
    is exact). The JAX artifact is jitted, and XLA's fusions keep some
    bfloat16 intermediates in float32: it lands about 0.7 of that distance
    from JAX's own eager model. So against the JAX artifact the port is
    held, by the mean as chip_smoke.py holds bfloat16 serving, to no more
    than JAX's float32 model's distance from it."""
    jm, variables, tm, _, jdir, tdir = artifacts['bf16']
    jcall, _ = jexport.load_serving_artifact(jdir)
    tcall, _ = texport.load_serving_artifact(tdir)
    x, aux = _inputs(tm, 3, seed=7)
    jart = jcall(x, aux)
    y = tcall(x, aux)
    assert jart.dtype == jnp.bfloat16 and y.dtype == torch.bfloat16
    y = y.float().numpy()
    jart = np.asarray(jart.astype(jnp.float32))
    eager = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(aux))
                       .astype(jnp.float32))
    y32 = np.asarray(jax.jit(dds.net_postupsampling(**FLAGSHIP).apply)(
        variables, jnp.asarray(x), jnp.asarray(aux)))

    def rel(a, ref):
        return np.abs(a - ref).max() / np.abs(ref).max()

    def mean_rel(a, ref):
        return np.abs(a - ref).mean() / np.abs(ref).mean()
    assert rel(y32, eager) > 3e-3
    assert rel(y, eager) <= RATIO * rel(y32, eager)
    assert mean_rel(y, jart) <= mean_rel(y32, jart)


def test_graph_holds_the_kernels_operators(artifacts):
    """The frozen graphs hold one K1 node per gate of the flagship (its
    blocks' and the output head's) and one K2 node per ConvLSTM layer of
    the recurrent model; nothing of the launch wrappers is inlined."""
    for name, ops in (('flagship', {K1_OP: FLAGSHIP['n_blocks'] + 1}),
                      ('bf16', {K1_OP: FLAGSHIP['n_blocks'] + 1}),
                      ('rec_poly', {K2_OP: 2 * (REC['n_blocks'] + 1)}),
                      ('rec_static', {K2_OP: 2 * (REC['n_blocks'] + 1)})):
        _, _, tm, net, _, tdir = artifacts[name]
        ep = torch.export.load(os.path.join(tdir, 'forward.pt2'))
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == 'call_function']
        counts = {op: targets.count(op) for op in (K1_OP, K2_OP)}
        assert counts == {K1_OP: 0, K2_OP: 0, **ops}, (name, counts)
        gates = sum(isinstance(m, tds.models.blocks.ChannelAttention2D)
                    for m in net.modules())
        assert counts[K1_OP] <= gates
        assert not any('launch' in t for t in targets)


def test_mode_and_grad_state_come_back(artifacts):
    """The export runs the eval forward with grad off and gives the
    caller's mode back."""
    _, _, tm, net, _, _ = artifacts['flagship']
    net.train()
    try:
        ep = texport.export_forward(tm, net, batch=2)
        assert net.training
    finally:
        net.eval()
    x, aux = _inputs(tm, 2, seed=11)
    with torch.no_grad():
        want = net(torch.from_numpy(x), torch.from_numpy(aux))
    assert torch.equal(ep.module()(torch.from_numpy(x),
                                   torch.from_numpy(aux)), want)
    assert torch.is_grad_enabled()


def test_mc_model_artifact_is_the_jax_fixed_member():
    """An 'mc*' dropout exports its eval forward as JAX's training=False
    does: the dropout stays on with one fixed member, the same at every
    call (JAX: `PRNGKey(0)`; the port: a generator seeded 0 afresh,
    `fixed_member_draw`). Fed JAX's draws, the port's artifact gives the
    JAX artifact's values."""
    jm, variables, tm, net = _pair('net_postupsampling', MC, seed=4)
    x, _ = _inputs(tm, 2, seed=4)
    jexp = jexport.export_forward(jm, variables, batch='poly')
    want = np.asarray(jexp.call(jnp.asarray(x)))
    np.testing.assert_array_equal(np.asarray(jexp.call(jnp.asarray(x))),
                                  want)
    with jax.disable_jit(), jax_draws() as draws:
        eager = np.asarray(jm.apply(variables, jnp.asarray(x), None,
                                    training=False))
    assert draws and all(kind == 'bernoulli' for kind, _ in draws)
    _close(eager, want)
    ep = texport.export_forward(tm, net, batch='poly')
    prog = ep.module()
    with torch.no_grad():
        y1 = prog(torch.from_numpy(x))
        assert torch.equal(prog(torch.from_numpy(x)), y1)
        assert torch.equal(net(torch.from_numpy(x)), y1)
        with fed_draws(draws):
            y = prog(torch.from_numpy(x))
    _close(y, want)
    assert not torch.equal(y, y1)       # other bits than JAX's threefry


def test_localized_model_refuses_spatial_size():
    """A LocalizedConvBlock binds the model to its grid: JAX fails at trace
    time, the port raises ValueError before tracing."""
    kw = dict(SPATIAL, localcon_layer=True)
    jm, variables, tm, net = _pair('net_postupsampling', kw)
    with pytest.raises(Exception):
        jexport.export_forward(jm, variables, batch=2, spatial_size=(12, 12))
    with pytest.raises(ValueError, match='LocalizedConvBlock'):
        texport.export_forward(tm, net, batch=2, spatial_size=(12, 12))


def test_quantize_is_not_ported_and_calibration_alone_is_ignored(artifacts):
    """The name is kept from before int8 artifacts were ported: `quantize`
    now exports (tests/test_torch_quantization.py holds the int8 artifact
    against `predict`); an aux model without `calibration_aux` raises the
    JAX package's ValueError and writes nothing; and, as in the JAX
    package, calibration without quantize= is not read."""
    jm, variables, tm, net, _, _ = artifacts['spatial']
    calib = np.zeros((2, 8, 8, 1), np.float32)
    calib_aux = np.zeros((2, 16, 16, 1), np.float32)
    for mode in ('int8', 'weight-only'):
        with pytest.raises(ValueError, match='calibration_aux') as want:
            jexport.export_forward(jm, variables, batch=2, quantize=mode,
                                   calibration=calib)
        with pytest.raises(ValueError, match='calibration_aux') as got:
            texport.save_serving_artifact(tm, net, 'unused', batch=2,
                                          quantize=mode, calibration=calib)
        assert str(got.value) == str(want.value)
        ep = texport.export_forward(tm, net, batch=2, quantize=mode,
                                    calibration=calib,
                                    calibration_aux=calib_aux)
        assert isinstance(ep, torch.export.ExportedProgram)
    assert not os.path.exists('unused')
    # as in the JAX package, calibration without quantize= is not read
    ep = texport.export_forward(tm, net, batch=2, calibration=calib,
                                calibration_aux=calib)
    x, aux = _inputs(tm, 2, seed=3)
    with torch.no_grad():
        want = net(torch.from_numpy(x), torch.from_numpy(aux))
    assert torch.equal(ep.module()(torch.from_numpy(x),
                                   torch.from_numpy(aux)), want)


def test_refusals(artifacts, tmp_path):
    """A JAX artifact, a 'cuda' artifact without a GPU, a device of
    another type and platforms other than the network's device raise."""
    _, _, tm, net, jdir, tdir = artifacts['spatial']
    with pytest.raises(ValueError, match='JAX artifact'):
        texport.load_serving_artifact(jdir)
    cuda_dir = str(tmp_path / 'cuda')
    shutil.copytree(tdir, cuda_dir)
    meta_path = os.path.join(cuda_dir, 'serving_meta.json')
    with open(meta_path) as fh:
        meta = json.load(fh)
    meta['platforms'] = ['cuda']
    with open(meta_path, 'w') as fh:
        json.dump(meta, fh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            texport.load_serving_artifact(cuda_dir)
    with pytest.raises(ValueError, match="'cuda' artifact"):
        texport.load_serving_artifact(cuda_dir, device='cpu')
    for platforms in (['tpu'], ['cuda'], ['cpu', 'cuda']):
        with pytest.raises(ValueError, match='platforms'):
            texport.export_forward(tm, net, batch=2, platforms=platforms)
    ep = texport.export_forward(tm, net, batch=2, platforms=['cpu'])
    assert isinstance(ep, torch.export.ExportedProgram)


def test_the_package_exports_the_entry_points():
    for name in ('export_forward', 'save_serving_artifact',
                 'load_serving_artifact'):
        assert getattr(tds, name) is getattr(texport, name)


def _gate_args(dtype=torch.float32, members=None):
    g = torch.Generator().manual_seed(5)
    lead = () if members is None else (members,)
    b = 3 * (members or 1)
    x = torch.randn(b, 5, 6, 8, generator=g).to(dtype)
    return (x, torch.randn(*lead, 8, 2, generator=g),
            torch.randn(*lead, 2, generator=g),
            torch.randn(*lead, 2, 8, generator=g),
            torch.randn(*lead, 8, generator=g))


_OPCHECK = {
    'channel_attention_f32': lambda: (tfo._channel_attention_op,
                                      (*_gate_args(), False)),
    'channel_attention_bf16': lambda: (tfo._channel_attention_op,
                                       (*_gate_args(torch.bfloat16), False)),
    'channel_attention_mixed': lambda: (tfo._channel_attention_op,
                                        (*_gate_args(torch.bfloat16), True)),
    'channel_attention_members': lambda: (tfo._channel_attention_op,
                                          (*_gate_args(members=2), False)),
    'convlstm_f32': lambda: (tconv._convlstm_op, (
        torch.randn(2, 3, 5, 6, 2), torch.randn(3, 3, 2, 16) * 0.3,
        torch.randn(16) * 0.1, torch.randn(3, 3, 4, 16) * 0.3)),
    'convlstm_bf16': lambda: (tconv._convlstm_op, tuple(
        t.to(torch.bfloat16) for t in (
            torch.randn(2, 3, 5, 6, 2), torch.randn(5, 5, 2, 8) * 0.3,
            torch.randn(8) * 0.1, torch.randn(5, 5, 2, 8) * 0.3))),
}


@pytest.mark.parametrize('case', list(_OPCHECK))
def test_opcheck(case):
    """`torch.library.opcheck` of the kernels' operators: the schema, the
    fake kernels against the CPU kernels, the autograd registration and
    the AOT dispatch with a dynamic batch."""
    op, args = _OPCHECK[case]()
    torch.library.opcheck(op, args)


def test_operators_equal_their_plain_versions():
    """On the CPU each operator is its kernel's plain version, bit for bit,
    and the fake kernels give the CPU kernels' shapes and dtypes."""
    args = _gate_args(torch.bfloat16)
    for mixed in (False, True):
        got = tfo._channel_attention_op(*args, mixed)
        want = tfo._plain_forward(*args, mixed)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got[0].dtype == (torch.float32 if mixed else torch.bfloat16)
    x, wx, bx, wh = _OPCHECK['convlstm_f32']()[1]
    assert torch.equal(tconv._convlstm_op(x, wx, bx, wh),
                       tconv.convlstm_reference(x, wx, bx, wh)[0])
