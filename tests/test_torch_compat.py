"""The port's Keras weight import (`dl4ds_tpu_torch/compat.py`) against the
JAX package's (`dl4ds_tpu/compat.py`), without TensorFlow.

A Keras-ordered weight list is written out of random Flax variables by
inverting each method of the JAX `_Consumer` (`tests/_torch_keras.py`);
the JAX import of that list must give the variables back exactly, which
pins the list to the JAX walkers' order (a misplaced tensor would land in
another leaf). The port's import of the same list must then equal the JAX
result leaf for leaf (through `export_jax_variables`), and its forward the
JAX forward within 1e-5, on a subset of `tools/compat_matrix.py`'s cases
that reaches every walker and quirk: bn statistics trailing each block,
densenet's dead norm1 (a bn densenet beside the matrix's), convnext's
stem-skip order, the recurrent aux block before the upsampler, dc's
flip-and-swap at x2 and the tied x8, the localized kernel's layout. Also
the unit guards of tests/test_compat.py, an npz round trip, and
`init_weights` in both trainers."""

import sys

import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
import dl4ds_tpu_torch as tds
from dl4ds_tpu import compat as jax_compat
from dl4ds_tpu_torch import compat
from dl4ds_tpu_torch.weights import export_jax_variables

from _torch_keras import build_pair, keras_weight_list, randomized
from _torch_xla import quick_xla  # noqa: F401

LABELS = ['resnet_spc_bn', 'convnet_rc_lcb', 'densenet_spc', 'resnet_dc2',
          'resnet_dc8', 'convnext_pin', 'unet_pin_dc', 'recresnet_spc_aux',
          'recresnet_pin_ln', 'recdensenet_rc']


def _zeros(tree):
    return {k: (_zeros(v) if isinstance(v, dict) else np.zeros_like(v))
            for k, v in tree.items()}


def _assert_trees_equal(got, want, path=''):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f'{path}/{k}')
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]),
                                          err_msg=f'{path}/{k}')


def _case(label, **overrides):
    """(port model, JAX model, x, aux, random variables, Keras list)."""
    m, x, s = build_pair(label, tds, **overrides)
    jm, _, _ = build_pair(label, dds, **overrides)
    variables = randomized(export_jax_variables(m.init(0, device='cpu')), 1)
    return m, jm, x, s, variables, keras_weight_list(jm.module, variables)


@pytest.mark.parametrize('label,overrides', [(lab, {}) for lab in LABELS]
                         + [('densenet_spc', dict(normalization='bn'))])
def test_import_equals_the_jax_import(label, overrides):
    m, jm, x, s, variables, ws = _case(label, **overrides)
    # the JAX import gives the variables back: the list is in its order
    jax_vars = jax_compat.import_keras_weights(jm, _zeros(variables), ws)
    jax_vars = {k: jax_compat._tree_to_numpy(v) for k, v in jax_vars.items()}
    _assert_trees_equal(jax_vars, variables)
    # the port's import of the same list, leaf for leaf
    net = m.init(5, device='cpu')
    assert compat.import_keras_weights(m, net, ws) is net
    _assert_trees_equal(export_jax_variables(net), jax_vars)
    want = np.asarray(jm.module.apply(jax_vars, x, s, training=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x),
                  None if s is None else torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_npz_round_trip(tmp_path):
    """save_weights_npz of a live model's weights, read back in order."""
    m, jm, x, s, variables, ws = _case('resnet_dc2')
    live = type('KerasModel', (), {'weights': ws})()
    path = str(tmp_path / 'ref.npz')
    compat.save_weights_npz(live, path)
    assert len(compat.load_weight_list(path)) == len(ws)
    for a, b in zip(compat.load_weight_list(path), ws):
        np.testing.assert_array_equal(a, b)
    net = compat.import_keras_weights(m, m.init(0, device='cpu'), path)
    _assert_trees_equal(export_jax_variables(net), variables)


def test_weight_sources_and_their_errors(tmp_path, monkeypatch):
    ws = [np.ones((2, 3), 'f'), np.zeros(4, 'f')]
    assert all(np.array_equal(a, b) for a, b in
               zip(compat.load_weight_list(tuple(ws)), ws))
    with pytest.raises(TypeError, match='unsupported weight source'):
        compat.load_weight_list(3)
    # a SavedModel path without TensorFlow: the JAX package's message
    monkeypatch.setitem(sys.modules, 'tensorflow', None)
    with pytest.raises(ImportError, match='requires TensorFlow'):
        compat.load_weight_list(str(tmp_path / 'saved_model'))


def test_dc_scale4_reference_bug_refused():
    with pytest.raises(ValueError, match='16x'):
        compat._Consumer([]).dc({}, 4)


def test_count_mismatch_raises():
    m = tds.net_postupsampling('resnet', 'spc', scale=4, n_channels=1,
                               n_aux_channels=0, lr_size=(8, 8),
                               n_filters=4, n_blocks=1)
    net = m.init(0, device='cpu')
    with pytest.raises(ValueError, match='exhausted|does not match'):
        tds.import_keras_weights(m, net, [np.zeros((3, 3, 1, 4), 'f')])
    _, jm, _, _, variables, ws = _case('resnet_spc_bn')
    m2 = build_pair('resnet_spc_bn', tds)[0]
    with pytest.raises(ValueError, match='consumed'):
        compat.import_keras_weights(m2, m2.init(0, device='cpu'),
                                    ws + [np.zeros(3, 'f')])


def test_unknown_norm_and_model_rejected():
    m = tds.net_pin('resnet', n_channels=1, n_aux_channels=0,
                    hr_size=(16, 16), n_filters=4, n_blocks=1)
    net = m.init(0, device='cpu')
    m.config = dict(m.config, normalization='in')
    with pytest.raises(NotImplementedError, match='normalization'):
        tds.import_keras_weights(m, net, [])
    d = tds.residual_discriminator(1, 'spc', False, 4, (8, 8), n_filters=4,
                                   n_res_blocks=1)
    with pytest.raises(NotImplementedError, match='not implemented'):
        tds.import_keras_weights(d, d.init(0, device='cpu'), [])
    with pytest.raises(TypeError, match='DSModel'):
        tds.import_keras_weights(net, net, [])


def _hr(n=24, size=32):
    return np.random.default_rng(0).standard_normal(
        (n, size, size, 1)).astype('float32')


def test_init_weights_in_the_supervised_trainer(capsys):
    hr = _hr()
    kw = dict(scale=4, patch_size=16, batch_size=4, epochs=1, n_filters=6,
              n_blocks=2, normalization='bn', device='cpu', verbose=True)
    tr = tds.SupervisedTrainer('resnet', 'spc', hr[:16], hr[16:20], hr[20:],
                               **kw)
    tr.setup_model()
    m = tr.model
    jm = dds.net_postupsampling('resnet', 'spc', scale=4, n_channels=1,
                                n_aux_channels=0, lr_size=(4, 4),
                                n_filters=6, n_blocks=2, normalization='bn')
    variables = randomized(export_jax_variables(tr.net), 2)
    ws = keras_weight_list(jm.module, variables)
    tr = tds.SupervisedTrainer('resnet', 'spc', hr[:16], hr[16:20], hr[20:],
                               init_weights=ws, **kw)
    tr.setup_model()
    assert 'Initialized parameters from reference checkpoint: list' in \
        capsys.readouterr().out
    _assert_trees_equal(export_jax_variables(tr.net), variables)
    assert tr.model.config == m.config
    with pytest.raises(ValueError, match='cannot be combined'):
        tds.SupervisedTrainer('resnet', 'spc', hr[:16], hr[16:20], hr[20:],
                              init_weights=ws, trained_model=(m, tr.net),
                              **kw)


def test_init_weights_in_the_cgan_trainer(capsys):
    hr = _hr()
    kw = dict(scale=4, patch_size=16, batch_size=4, epochs=1, device='cpu',
              generator_params=dict(n_filters=6, n_blocks=2),
              discriminator_params=dict(n_filters=4, n_res_blocks=1))
    tr = tds.CGANTrainer('resnet', 'spc', hr[:16], hr[16:], **kw)
    tr.setup_model()
    jm = dds.net_postupsampling('resnet', 'spc', scale=4, n_channels=1,
                                n_aux_channels=0, lr_size=(4, 4),
                                n_filters=6, n_blocks=2)
    variables = randomized(export_jax_variables(tr.gen_net), 3)
    disc = export_jax_variables(tr.disc_net)
    ws = keras_weight_list(jm.module, variables)
    tr = tds.CGANTrainer('resnet', 'spc', hr[:16], hr[16:], init_weights=ws,
                         **kw)
    tr.setup_model()
    assert 'Initialized generator from reference checkpoint: list' in \
        capsys.readouterr().out
    _assert_trees_equal(export_jax_variables(tr.gen_net), variables)
    # the discriminator starts fresh, from its seed
    _assert_trees_equal(export_jax_variables(tr.disc_net), disc)
