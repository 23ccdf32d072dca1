"""The model summary: `DSModel.summary` and the lines the trainers print
at `verbose=1`, against the JAX package's (`dl4ds_tpu/models/__init__.py`
`DSModel.summary`, printed by `SupervisedTrainer.setup_model` and, the
generator's then the discriminator's, by `CGANTrainer.setup_model`).

Small models (n_filters 4, one block) on seeded numpy grids; the JAX
trainers on one host device, so that their batch is the port's."""

import contextlib
import io

import jax
import numpy as np
import pytest

import dl4ds_tpu as dds

import dl4ds_tpu_torch as tds

from _torch_xla import quick_xla  # noqa: F401

SCALE, PATCH, BATCH = 2, 8, 2
ARCH = dict(n_filters=4, n_blocks=1, attention=True)


def _printed(trainer):
    """What `setup_model` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer.setup_model()
    return out.getvalue().splitlines()


@pytest.fixture(scope='module')
def grids():
    return np.random.default_rng(0).standard_normal(
        (8, 16, 16, 1)).astype(np.float32)


CASES = {
    'resnet_spc': dict(backbone='resnet', upsampling='spc'),
    'convnet_pin': dict(backbone='convnet', upsampling='pin'),
    'recresnet_spc': dict(backbone='resnet', upsampling='spc',
                          time_window=2),
}


@pytest.mark.parametrize('case', list(CASES))
def test_supervised_trainer_prints_the_jax_summary(grids, case):
    """`SupervisedTrainer(verbose=1)` prints the JAX trainer's three lines:
    the model's name, its input and aux shapes, its parameter count."""
    kw = dict(CASES[case], data_train=grids, data_val=grids,
              data_test=grids, scale=SCALE, patch_size=PATCH,
              batch_size=BATCH, epochs=1, **ARCH,
              save=False, verbose=1)
    want = _printed(dds.SupervisedTrainer(devices=jax.devices()[:1], **kw))
    got = _printed(tds.SupervisedTrainer(device='cpu', **kw))
    assert len(want) == 3 and want[0].startswith('Model: ')
    assert got == want
    quiet = tds.SupervisedTrainer(device='cpu', **dict(kw, verbose=2))
    assert _printed(quiet) == []


def test_cgan_trainer_prints_both_jax_summaries(grids):
    """`CGANTrainer(verbose=1)` prints the generator's summary, then the
    discriminator's, as the JAX trainer does."""
    kw = dict(backbone='resnet', upsampling='spc', data_train=grids,
              data_test=grids, scale=SCALE, patch_size=PATCH,
              batch_size=BATCH, epochs=1, generator_params=dict(ARCH),
              discriminator_params=dict(n_filters=4, n_res_blocks=1,
                                        attention=True),
              save=False, save_loss_history=False, verbose=1)
    want = _printed(dds.CGANTrainer(devices=jax.devices()[:1], **kw))
    got = _printed(tds.CGANTrainer(device='cpu', **kw))
    assert len(want) == 6 and want[3] == 'Model: discriminator'
    assert got == want


def test_summary_equals_jax_without_weights():
    """`summary()` alone: the name and shapes, no parameter line."""
    kw = dict(backbone_block='resnet', upsampling='spc', scale=2,
              n_channels=3, n_aux_channels=1, lr_size=(8, 8), n_filters=4,
              n_blocks=1)
    want = dds.net_postupsampling(**kw).summary()
    model = tds.net_postupsampling(**kw)
    assert model.summary() == want
    net = model.init(0, device='cpu')
    assert model.summary(net).splitlines()[:2] == want.splitlines()
    assert model.summary(net).splitlines()[2] == (
        f'  parameters: {model.param_count(net):,}')
