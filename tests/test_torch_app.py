"""The port's command-line app (`dl4ds_tpu_torch/app.py`) against the JAX
package's (`dl4ds_tpu/app.py`).

- One flag file using every kind of flag (booleans in their four forms,
  enums, strings, integers, floats, a repeated `--learning_rate`, a nested
  flag file, `#` and `//` comments, and `--flag value` on the command
  line) parses to equal values under absl (`dl4ds_tpu.app.FLAGS`) and the
  port's stdlib parser; the two define the same flags with the same
  defaults and choices, `--device` aside (GPU or CPU, default GPU).
- With recording stand-ins for both trainers in each package, JAX's
  `dl4ds` and the port's `main` build them from the same flag file
  (`--notest --nometrics`) with equal keyword arguments after the port's
  mappings (--device CPU -> 'cpu', --dtype -> torch's, --init_keras_npz ->
  init_weights).
- A real CPU run as tests/test_app.py's (convnet pin, mcdrop with 3 MC
  members, EMA, accumulation, warmup_cosine) writes the same files;
  `--trained_model_path` in a fresh process (`python -m
  dl4ds_tpu_torch.app`) gives the saved model's `predict`; float and int8
  `--export_artifact`s serve; `--init_keras_npz` loads a Keras-ordered
  `.npz`.
- Refusals: an unknown flag, bad values, `--device=TPU` (naming the two
  choices) and a `--mesh_shape` axis other than 'data' (ROADMAP item 10,
  part 4; 'data=N' is in tests/test_torch_distributed.py)."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dl4ds_tpu as dds
import dl4ds_tpu_torch as tds
from dl4ds_tpu import app as jax_app
from dl4ds_tpu_torch import app
from dl4ds_tpu_torch.weights import export_jax_variables

from _torch_keras import keras_weight_list, randomized
from _torch_xla import quick_xla  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA_MODULE = """
import numpy as np
rng = np.random.default_rng(0)
_all = rng.standard_normal((60, 16, 16, 1)).astype('float32')
data_train = _all[:40]
data_val = _all[40:50]
data_test = _all[50:]
data_train_lr = _all[:40, ::4, ::4]
data_val_lr = _all[40:50, ::4, ::4]
data_test_lr = _all[50:, ::4, ::4]
predictors_train = predictors_val = predictors_test = None
static_vars = [rng.standard_normal((16, 16)).astype('float32')]
inference_data = _all[50:]
inference_scaler = None
inference_predictors = None
gt_holdout_dataset = _all[50:]
gt_mask = np.ones((16, 16))
"""


def _data_module(tmp_path, full=False):
    """The data module of tests/test_app.py; `full` adds explicit LR pairs
    and a static variable (for the trainers' arguments)."""
    text = DATA_MODULE if full else DATA_MODULE.replace(
        "static_vars = [rng.standard_normal((16, 16)).astype('float32')]",
        'static_vars = None')
    path = tmp_path / ('data_full.py' if full else 'data_module.py')
    path.write_text(text)
    return str(path)


def _flagfile(tmp_path, body, name='params.cfg'):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


def _absl(argv):
    """absl's values of every flag the JAX app defines, after argv."""
    flags = jax_app.FLAGS
    try:
        flags(argv)
        return {f.name: f.value for f in flags.get_flags_for_module(jax_app)}
    finally:
        flags.unparse_flags()


def test_flag_definitions_are_the_jax_ones():
    jax_flags = {f.name: f for f in
                 jax_app.FLAGS.get_flags_for_module(jax_app)}
    assert set(jax_flags) == {name for name, *_ in app.FLAG_DEFS}
    for name, _, default, choices, _ in app.FLAG_DEFS:
        f = jax_flags[name]
        if name == 'device':
            assert (f.default, default) == ('TPU', 'GPU')
            assert choices == ['GPU', 'CPU']
            continue
        assert default == f.default, name
        assert choices == getattr(f.parser, 'enum_values', None), name


def test_one_flag_file_parses_alike(tmp_path):
    inner = _flagfile(tmp_path, """
        // nested flag file
        --learning_rate=2e-4
        --nosave
        --verbose=false
        --steps_per_execution=0x10
        """, 'inner.cfg')
    outer = _flagfile(tmp_path, f"""
        # every kind of flag
        --debug
        --train=0
        --test=true
        --metrics=1
        --trainer=CGANTrainer
        --data_module=/data/module.py
        --backbone=densenet
        --upsampling=rc
        --time_window=4
        --n_filters=16
        --normalization=ln
        --dropout_rate=0.35
        --dropout_variant=mcspatialdrop
        --attention
        --output_activation=selu
        --device=CPU
        --learning_rate=1e-3
        --flagfile={inner}
        --lr_decay_after=2.5e4
        --dtype=bfloat16
        --lr_schedule=warmup_cosine
        --ema_decay=0.999
        --export_quantize=weight-only
        --init_keras_npz=/ckpt/ref.npz
        --nodata_in_hbm
        """)
    argv = ['prog', f'--flagfile={outer}', '--scale', '4', '--batch_size',
            '12', '--noattention']
    want = _absl(argv)
    got = vars(app.parse_flags(argv + ['positional', '--', '--nonflag']))
    assert got == want
    assert got['learning_rate'] == [1e-3, 2e-4]
    assert got['steps_per_execution'] == 16
    defaults = vars(app.parse_flags(['prog']))
    assert defaults.pop('device') == 'GPU'
    assert defaults == {k: v for k, v in _absl(['prog']).items()
                        if k != 'device'}


@pytest.mark.parametrize('args,match', [
    (['--no_such_flag=1'], 'unknown command line flag'),
    (['--device=TPU'], '<GPU|CPU>'),
    (['--backbone=vgg'], 'value should be one of'),
    (['--attention=maybe'], 'not a valid bool'),
    (['--n_filters=eight'], 'not a valid integer'),
    (['--scale'], 'needs a value'),
    (['--flagfile=/no/such/file.cfg'], 'cannot read flag file'),
    (['--nodebug=1'], 'unknown command line flag')])
def test_bad_flags_are_refused(args, match):
    with pytest.raises(app.FlagError, match=match):
        app.parse_flags(['prog'] + args)


def test_device_tpu_and_mesh_shape_refused(tmp_path):
    with pytest.raises(ValueError) as e:
        app.main(['prog', '--device=TPU'])
    assert 'GPU' in str(e.value) and 'CPU' in str(e.value)
    # a 'model' axis is ported: the mesh needs 2 processes, this run has 1
    with pytest.MonkeyPatch.context() as m:
        m.setenv('WORLD_SIZE', '1')
        with pytest.raises(ValueError, match='needs 2 processes'):
            app.main(['prog', '--device=CPU', '--mesh_shape=data=1,model=2',
                      f'--data_module={_data_module(tmp_path)}'])


class _Recorder:
    """A trainer stand-in that records its keyword arguments."""
    calls = []

    def __init__(self, **kwargs):
        _Recorder.calls.append(kwargs)

    def run(self):
        pass


def _same(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(u, v) for u, v in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize('trainer', ['SupervisedTrainer', 'CGANTrainer'])
def test_trainers_get_the_jax_arguments(tmp_path, monkeypatch, trainer):
    cfg = _flagfile(tmp_path, f"""
        --device=CPU
        --trainer={trainer}
        --data_module={_data_module(tmp_path, full=True)}
        --paired_samples=explicit
        --backbone=unet
        --upsampling=pin
        --decoder_upsampling=spc
        --scale=4
        --epochs=3
        --batch_size=4
        --learning_rate=1e-3
        --learning_rate=1e-4
        --normalization=ln
        --dropout_variant=mcdrop
        --attention
        --gradient_accumulation_steps=2
        --lr_schedule=cosine
        --ema_decay=0.5
        --dtype=bfloat16
        --init_keras_npz=/ckpt/ref.npz
        --n_disc_filters=8
        --save_path={tmp_path}/out/
        --notest
        --nometrics
        """)
    argv = ['prog', f'--flagfile={cfg}']
    calls = {}
    for pkg, run in ((dds, lambda: (jax_app.FLAGS(argv),
                                    jax_app.dl4ds(argv))),
                     (tds, lambda: app.main(argv))):
        _Recorder.calls = []
        monkeypatch.setattr(pkg, trainer, _Recorder)
        try:
            run()
        finally:
            jax_app.FLAGS.unparse_flags()
        calls[pkg.__name__] = _Recorder.calls
    (want,), (got,) = calls['dl4ds_tpu'], calls['dl4ds_tpu_torch']
    assert want.pop('device') == 'CPU' and got.pop('device') == 'cpu'
    if trainer == 'SupervisedTrainer':
        assert want.pop('dtype') == jnp.bfloat16
        assert got.pop('dtype') == torch.bfloat16
        assert want['learning_rate'] == (1e-3, 1e-4)
    else:
        assert want['learning_rates'] == (1e-3, 1e-4)
        assert want['generator_params']['decoder_upsampling'] == 'spc'
    assert want['init_weights'] == '/ckpt/ref.npz'
    assert want['data_train_lr'] is not None
    assert _same(got, want)


def _cli_run(tmp_path, body, subprocess_run=False):
    cfg = _flagfile(tmp_path, body, f'run{len(os.listdir(tmp_path))}.cfg')
    if not subprocess_run:
        app.main(['prog', f'--flagfile={cfg}'])
        return None
    res = subprocess.run(
        [sys.executable, '-m', 'dl4ds_tpu_torch.app', f'--flagfile={cfg}'],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_cli_debug_run_writes_the_jax_files(tmp_path, capsys):
    """tests/test_app.py::test_app_debug_run on the port."""
    save = f'{tmp_path}/results/'
    _cli_run(tmp_path, f"""
        --debug
        --device=CPU
        --data_module={_data_module(tmp_path)}
        --backbone=convnet
        --upsampling=pin
        --scale=4
        --batch_size=2
        --n_filters=4
        --n_blocks=1
        --dropout_rate=0.1
        --dropout_variant=mcdrop
        --inference_mc_members=3
        --gradient_accumulation_steps=2
        --lr_schedule=warmup_cosine
        --warmup_steps=2
        --ema_decay=0.9
        --save_path={save}
        --inference_array_in_hr
        --inference_save_fname=y_hat.npy
        --noshow_plot
        """)
    for name in ('y_hat.npy', 'test_loss.txt', 'metrics_summary.txt',
                 'metrics_crps_map.npy', 'metrics_rank_histogram.npy',
                 'metrics_prob_summary.txt', 'learning_curve.png',
                 'convnet_pin/model_config.json'):
        assert os.path.exists(save + name), name
    y_hat = np.load(save + 'y_hat.npy')
    assert y_hat.shape == (10, 16, 16, 1) and np.isfinite(y_hat).all()
    mc_std = np.load(save + 'y_hat_mc_std.npy')
    assert mc_std.shape == y_hat.shape and float(mc_std.max()) > 0
    assert 'DL4DS Metrics computation phase' in capsys.readouterr().out


def test_cli_saved_model_and_artifacts(tmp_path, capsys):
    """Train and save with a float artifact; then, in a fresh process, the
    saved model's test phase (its `predict`) and an int8 artifact."""
    save = f'{tmp_path}/results/'
    common = f"""
        --debug
        --device=CPU
        --data_module={_data_module(tmp_path)}
        --backbone=resnet
        --upsampling=spc
        --attention
        --scale=4
        --batch_size=4
        --n_filters=4
        --n_blocks=1
        --dropout_rate=0
        --save_path={save}
        --inference_array_in_hr
        --noshow_plot
        --nometrics
        """
    _cli_run(tmp_path, common + f"""
        --notest
        --export_artifact={tmp_path}/float
        """)
    assert 'dl4ds_tpu_torch.serve --artifact' in capsys.readouterr().out
    out = _cli_run(tmp_path, common + f"""
        --notrain
        --test
        --trained_model_path={save}resnet_spc
        --inference_save_fname=y_eval.npy
        --export_artifact={tmp_path}/int8
        --export_quantize=int8
        --export_batch=4
        """, subprocess_run=True)
    assert 'Loaded trained model from' in out and 'int8, batch=4' in out
    pair = tds.load_model(f'{save}resnet_spc', device='cpu')
    data = np.random.default_rng(0).standard_normal(
        (60, 16, 16, 1)).astype('float32')[50:]
    want = tds.predict(pair, data, scale=4, array_in_hr=True, batch_size=4,
                       device='cpu')
    np.testing.assert_array_equal(np.load(save + 'y_eval.npy'), want)
    lr = tds.resize_array(data, (4, 4), squeezed=False)
    from dl4ds_tpu_torch.serve import ModelServer
    for kind, n in (('float', 3), ('int8', 6)):
        srv = ModelServer(f'{tmp_path}/{kind}', device='cpu')
        y = srv.predict(lr[:n])
        assert y.shape == (n, 16, 16, 1) and np.isfinite(y).all()
    assert ModelServer(f'{tmp_path}/int8', device='cpu').health()[
        'quantize'] == 'int8'


def test_cli_init_keras_npz(tmp_path, capsys):
    m = tds.net_postupsampling('resnet', 'spc', scale=4, n_channels=1,
                               n_aux_channels=0, lr_size=(4, 4), n_filters=6,
                               n_blocks=2)
    jm = dds.net_postupsampling('resnet', 'spc', scale=4, n_channels=1,
                                n_aux_channels=0, lr_size=(4, 4),
                                n_filters=6, n_blocks=2)
    variables = randomized(export_jax_variables(m.init(0, device='cpu')), 4)
    npz = str(tmp_path / 'ref_weights.npz')
    ws = keras_weight_list(jm.module, variables)
    np.savez(npz, **{f'w{i:04d}': w for i, w in enumerate(ws)})
    _cli_run(tmp_path, f"""
        --debug
        --device=CPU
        --data_module={_data_module(tmp_path)}
        --backbone=resnet
        --upsampling=spc
        --scale=4
        --batch_size=2
        --n_filters=6
        --n_blocks=2
        --init_keras_npz={npz}
        --save_path={tmp_path}/results/
        --notest
        --nometrics
        """)
    assert 'Initialized parameters from reference checkpoint: ' + npz in \
        capsys.readouterr().out


def test_module_entry_point_refuses_a_bad_flag(tmp_path):
    res = subprocess.run(
        [sys.executable, '-m', 'dl4ds_tpu_torch.app', '--device=TPU'],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 1
    assert 'FATAL Flags parsing error' in res.stderr
    assert '<GPU|CPU>' in res.stderr and not res.stdout


def test_cli_saves_without_matplotlib(tmp_path, monkeypatch):
    """A CUDA host may have no matplotlib: `--save` (the default) still
    writes the model, the test loss and the running time, and leaves the
    learning curve out with a warning (save_results imported matplotlib
    unconditionally)."""
    for name in ('matplotlib', 'matplotlib.pyplot'):
        monkeypatch.setitem(sys.modules, name, None)
    save = f'{tmp_path}/results/'
    with pytest.warns(RuntimeWarning, match='matplotlib is not installed'):
        _cli_run(tmp_path, f"""
            --debug
            --device=CPU
            --data_module={_data_module(tmp_path)}
            --backbone=convnet
            --upsampling=pin
            --scale=4
            --batch_size=2
            --n_filters=4
            --n_blocks=1
            --save_path={save}
            --inference_array_in_hr
            --inference_save_fname=y_hat.npy
            --nometrics
            """)
    for name in ('convnet_pin/model_config.json', 'test_loss.txt',
                 'running_time.txt', 'y_hat.npy'):
        assert os.path.exists(save + name), name
    assert not os.path.exists(save + 'learning_curve.png')
