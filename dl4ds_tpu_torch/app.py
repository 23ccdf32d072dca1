#!/usr/bin/env python
"""
Command-line app of the port (reference: dl4ds/app.py; the JAX package's
`dl4ds_tpu/app.py`).

Run:
    python -m dl4ds_tpu_torch.app --flagfile=params.cfg

or call `main(argv)` with a `sys.argv`-like list (the program's name
first). The flags are the JAX app's, with the same names, defaults and
choices, except `--device`: 'GPU' (the default, the current CUDA device)
or 'CPU'. The parser is the standard library's work, not absl's, but it
reads absl's syntax, so one flag file runs both apps (with `--device` set
to a value both take, 'GPU' or 'CPU'): `--flagfile=F` (nested, with `#`
and `//` comment lines), `--flag=value` and `--flag value`, booleans as
`--flag`, `--noflag` and `--flag=true|false|1|0`, enum choices checked, and
a repeated `--learning_rate` collected in order. An unknown flag, a bad
value or a missing flag file raises `FlagError` (`main` run as a program
prints it and exits 1, as absl does).

The `--data_module` flag points at a user Python file that is imported at
runtime and must expose: data_train, data_val, data_test (+ *_lr when
--paired_samples=explicit), predictors_train/val/test, static_vars,
inference_data, inference_scaler, inference_predictors, gt_holdout_dataset,
gt_mask — the same contract as the reference (dl4ds/app.py:111-116,
:177-186, :262-270, :294-297).

`--mesh_shape=data=N` trains the model (either trainer) data-parallel
over N processes, one a device, launched together:
    torchrun --nproc_per_node=N -m dl4ds_tpu_torch.app --flagfile=F \
        --mesh_shape=data=N
N must be the launcher's world size; the app opens the process group
(`distributed.initialize`: NCCL on the GPU, gloo with --device=CPU) and
passes `distributed.global_mesh()` to the trainer.
`--mesh_shape=data=N,space=M` (or `space=M`) trains SupervisedTrainer
spatially parallel over N x M processes, each grid's rows cut into M bands
(`distributed.spatial_mesh(M, N)`):
    torchrun --nproc_per_node=4 -m dl4ds_tpu_torch.app --flagfile=F \
        --mesh_shape=data=2,space=2
`--mesh_shape=data=N,model=M` (or `model=M`) trains SupervisedTrainer
tensor-parallel over N x M processes, each wide weight in M shards
(`distributed.tensor_mesh(M, N)`), launched as above with
--nproc_per_node=N*M. The metrics phase draws its maps with matplotlib
(`--nometrics` skips it).
"""

import importlib.util
import math
import os
import sys
import types

import numpy as np
import torch

import dl4ds_tpu_torch as tds
from . import (BACKBONE_BLOCKS, DROPOUT_VARIANTS, INTERPOLATION_METHODS,
               LOSS_FUNCTIONS, UPSAMPLING_METHODS)

__all__ = ['FLAG_DEFS', 'FlagError', 'parse_flags', 'dl4ds', 'main']

_ACTIVATIONS = ['elu', 'relu', 'gelu', 'crelu', 'leaky_relu', 'selu']

# (name, kind, default, choices, help): the JAX app's flags in its order
# (dl4ds_tpu/app.py:31-200); kind is 'bool', 'enum', 'string', 'integer',
# 'float' or 'multi_float'
FLAG_DEFS = [
    # EXPERIMENT
    ('train', 'bool', True, None, 'Training a model'),
    ('test', 'bool', True, None, 'Testing the trained model on holdout data'),
    ('metrics', 'bool', True, None,
     'Running verification metrics on the downscaled arrays'),
    ('debug', 'bool', False, None,
     'If True a debug training run (2 epochs with 6 steps) is executed'),
    # DOWNSCALING PARAMS
    ('trainer', 'enum', 'SupervisedTrainer',
     ['SupervisedTrainer', 'CGANTrainer'], 'Trainer'),
    ('paired_samples', 'enum', 'implicit', ['implicit', 'explicit'],
     'Type of learning: implicit (PerfectProg) or explicit (MOS)'),
    ('data_module', 'string', None, None,
     'Python module where the data pre-processing is done'),
    # MODEL
    ('backbone', 'enum', 'resnet', BACKBONE_BLOCKS, 'Backbone section'),
    ('upsampling', 'enum', 'spc', UPSAMPLING_METHODS, 'Upsampling method'),
    ('time_window', 'integer', None, None,
     'Time window for training spatio-temporal models'),
    ('n_filters', 'integer', 8, None,
     'Number of convolutional filters for the first convolutional block'),
    ('n_blocks', 'integer', 6, None, 'Number of convolutional blocks'),
    ('n_disc_filters', 'integer', 32, None,
     'Number of convolutional filters per convolutional block in the '
     'discriminator'),
    ('n_disc_blocks', 'integer', 4, None,
     'Number of residual blocks for discriminator network'),
    ('normalization', 'enum', None, ['bn', 'ln'], 'Normalization'),
    ('dropout_rate', 'float', 0.2, None, 'Dropout rate'),
    ('dropout_variant', 'enum', 'vanilla', DROPOUT_VARIANTS,
     'Dropout variants'),
    ('attention', 'bool', False, None,
     'Attention block in convolutional layers'),
    ('activation', 'enum', 'relu', _ACTIVATIONS,
     'Activation used in intermediate convolutional blocks'),
    ('output_activation', 'enum', None, _ACTIVATIONS,
     'Activation used in the last convolutional block'),
    ('localcon_layer', 'bool', False, None,
     'Locally connected convolutional layer'),
    ('decoder_upsampling', 'enum', 'rc', UPSAMPLING_METHODS,
     'Upsampling in decoder blocks (unet backbone)'),
    ('rc_interpolation', 'enum', 'bilinear', INTERPOLATION_METHODS,
     'Interpolation used in resize convolution upsampling'),
    # TRAINING PROCEDURE
    ('device', 'enum', 'GPU', ['GPU', 'CPU'],
     'Device to be used: GPU (the current CUDA device) or CPU'),
    ('save', 'bool', True, None,
     'Saving to disk the trained model, metrics, run info, etc'),
    ('save_path', 'string', './dl4ds_results/', None,
     'Path for saving results to disk'),
    ('scale', 'integer', 2, None, 'Scaling factor, positive integer'),
    ('epochs', 'integer', 100, None, 'Number of training epochs'),
    ('loss', 'enum', 'mae', LOSS_FUNCTIONS, 'Loss function'),
    ('interpolation', 'enum', 'inter_area', INTERPOLATION_METHODS,
     'Interpolation method'),
    ('patch_size', 'integer', None, None,
     'Patch size in number of px/gridpoints'),
    ('batch_size', 'integer', 32, None,
     'Batch size (of samples) used during training'),
    ('learning_rate', 'multi_float', [1e-3], None,
     'Learning rate (repeat the flag for the piecewise-constant pair)'),
    ('gpu_memory_growth', 'bool', True, None,
     'Kept for flag-file compatibility (no-op)'),
    ('use_multiprocessing', 'bool', True, None,
     'Kept for flag-file compatibility (batches are built on the device)'),
    ('lr_decay_after', 'float', 1e5, None,
     'Steps to tweak the learning rate using the piecewise-constant '
     'scheduler'),
    ('early_stopping', 'bool', False, None, 'Early stopping'),
    ('patience', 'integer', 6, None,
     'Patience in number of epochs w/o improvement for early stopping'),
    ('min_delta', 'float', 0.0, None,
     'Minimum delta improvement for early stopping'),
    ('show_plot', 'bool', False, None,
     'Reference-compat no-op (plots render headlessly and are saved to '
     'save_path)'),
    ('save_bestmodel', 'bool', True, None,
     'SupervisedTrainer - Whether to save the best model'),
    ('verbose', 'bool', True, None, 'Verbosity'),
    ('checkpoints_frequency', 'integer', 2, None,
     'CGANTrainer - Frequency for saving checkpoints and the generator'),
    # KNOBS BEYOND THE REFERENCE'S VOCABULARY
    ('dtype', 'enum', 'float32', ['float32', 'bfloat16'],
     'Model compute dtype (params/loss stay float32)'),
    ('data_in_hbm', 'bool', True, None,
     'Keep the training dataset in device memory (False streams from host '
     'RAM via the native gather/crop path)'),
    ('steps_per_execution', 'integer', None, None,
     'Training steps per replayed CUDA graph (None = whole epoch)'),
    ('gradient_accumulation_steps', 'integer', 1, None,
     'Microbatches accumulated per optimizer update (effective batch = k x '
     'batch_size at microbatch memory cost)'),
    ('lr_schedule', 'enum', None, ['cosine', 'warmup_cosine'],
     'LR schedule over the full run (None keeps the reference piecewise/'
     'constant behavior); CGAN applies it to both the G and D optimizers'),
    ('warmup_steps', 'integer', 0, None,
     'Linear LR warmup steps for warmup_cosine (0 = auto, 5% of the run)'),
    ('ema_decay', 'float', 0.0, None,
     'Parameter EMA decay, 0 disables. Supervised: eval/best-checkpoint/'
     'serving use the averaged weights; CGAN: the averaged generator is '
     'evaluated and served'),
    ('mesh_shape', 'string', None, None,
     "Device mesh as 'data=N[,space=M|model=M]': data parallel over the "
     "N processes of a torchrun launch, or over N x M, each grid's rows in "
     "M bands ('space') or each wide weight in M shards ('model') "
     "(SupervisedTrainer)"),
    # INFERENCE/TEST
    ('inference_array_in_hr', 'bool', False, None,
     'Whether the inference array is in high resolution'),
    ('init_keras_npz', 'string', None, None,
     'Initialize the model (CGAN: the generator) from a reference-trained '
     'Keras checkpoint before training - a .npz written by '
     'compat.save_weights_npz or a TF SavedModel directory '
     '(compat.import_keras_weights). The architecture flags must match the '
     'checkpoint'),
    ('trained_model_path', 'string', None, None,
     'Run the test/metrics phases on a model saved by a previous --train '
     '--save run (path to the <save_path>/<backbone>_<upsampling>/ folder '
     'written by save_results) - no retraining needed'),
    ('inference_mc_members', 'integer', 0, None,
     'When > 0 and the model uses an mc* dropout variant, the test phase '
     'also runs an MC-dropout ensemble of this many members (saves mean/std '
     'maps) and the metrics phase adds the probabilistic suite (CRPS, '
     'spread-skill, rank histogram)'),
    ('inference_save_fname', 'string', None, None,
     'Filename for saving the inference array'),
    ('export_artifact', 'string', None, None,
     'After training (or on --trained_model_path), freeze the forward to a '
     'serving-artifact directory (export.save_serving_artifact, symbolic '
     'batch); serve it with `python -m dl4ds_tpu_torch.serve --artifact '
     'DIR`'),
    ('export_quantize', 'enum', None, ['int8', 'weight-only'],
     'Freeze the CALIBRATED int8 (or weight-only) forward instead of the '
     'float one in --export_artifact. Calibration inputs are assembled from '
     "the data module's inference_data (first --export_batch samples, same "
     'preparation as the test phase); the artifact batch is pinned to that '
     'shape (the server pads/chunks requests)'),
    ('export_batch', 'integer', 8, None,
     'Serving batch for --export_quantize artifacts (= the calibration '
     'batch; the int8 forward is shape-pinned)'),
]

_DEFS = {name: (kind, default, choices, hlp)
         for name, kind, default, choices, hlp in FLAG_DEFS}
_TRUE = ('true', 't', '1')
_FALSE = ('false', 'f', '0')


class FlagError(ValueError):
    """An unknown flag, a bad value or an unreadable flag file."""


def _flagfile_args(path, seen):
    """The flag arguments of flag file `path`, nested flag files expanded:
    one flag a line, blank lines and lines starting with '#' or '//'
    skipped (absl's flag-file format)."""
    path = os.path.expanduser(path)
    if path in seen:
        raise FlagError(f'flag file {path!r} includes itself')
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise FlagError(f'cannot read flag file {path!r}: {e}') from None
    args = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith('#') or line.startswith('//'):
            continue
        name, _, value = line.lstrip('-').partition('=')
        if line.startswith('-') and name == 'flagfile':
            args += _flagfile_args(value, seen | {path})
        else:
            args.append(line)
    return args


def _value(name, kind, choices, text):
    """`text` parsed as flag `name`'s value."""
    try:
        if kind == 'bool':
            low = text.lower()
            if low in _TRUE or low in _FALSE:
                return low in _TRUE
            raise ValueError
        if kind == 'integer':
            return int(text, 0) if text[:2].lower() in (
                '0x', '0o', '0b') else int(text)
        if kind in ('float', 'multi_float'):
            return float(text)
    except ValueError:
        raise FlagError(f'flag --{name}={text}: not a valid {kind} '
                        'value') from None
    if kind == 'enum' and text not in choices:
        raise FlagError(f'flag --{name}={text}: value should be one of '
                        f'<{"|".join(choices)}>')
    return text


def parse_flags(argv):
    """The flag values of `argv` (a `sys.argv`-like list: the program's
    name first, then the arguments) as a namespace of every flag in
    `FLAG_DEFS`, unset ones at their defaults. Arguments that are not
    flags, and all after `--`, are ignored, as the JAX app ignores them.
    Raises FlagError (the module docstring)."""
    values = {name: (list(default) if kind == 'multi_float' else default)
              for name, (kind, default, _, _) in _DEFS.items()}
    given_multi = set()
    args = list(argv[1:])
    i = 0
    while i < len(args):
        arg = args[i]
        i += 1
        if arg == '--':
            break
        if not arg.startswith('-') or arg == '-':
            continue
        name, has_value, text = arg.lstrip('-').partition('=')
        if name == 'flagfile':
            if not has_value:
                if i >= len(args):
                    raise FlagError('flag --flagfile needs a value')
                text, i = args[i], i + 1
            args[i:i] = _flagfile_args(text, frozenset())
            continue
        if name == 'help':
            print(usage())
            raise SystemExit(0)
        if name not in _DEFS and name.startswith('no') \
                and _DEFS.get(name[2:], ('',))[0] == 'bool' and not has_value:
            values[name[2:]] = False
            continue
        if name not in _DEFS:
            raise FlagError(f'unknown command line flag {name!r}')
        kind, _, choices, _ = _DEFS[name]
        if not has_value:
            if kind == 'bool':
                values[name] = True
                continue
            if i >= len(args):
                raise FlagError(f'flag --{name} needs a value')
            text, i = args[i], i + 1
        value = _value(name, kind, choices, text)
        if kind == 'multi_float':
            if name not in given_multi:
                values[name], _ = [], given_multi.add(name)
            values[name].append(value)
        else:
            values[name] = value
    return types.SimpleNamespace(**values)


def usage():
    """The flags, their defaults and help, one a line."""
    lines = ['USAGE: python -m dl4ds_tpu_torch.app [--flagfile=F] [flags]']
    for name, kind, default, choices, hlp in FLAG_DEFS:
        opts = f' <{"|".join(choices)}>' if choices else ''
        lines.append(f'  --{name}: {hlp}{opts} (default: {default!r})')
    return '\n'.join(lines)


def _load_data_module(path):
    spec = importlib.util.spec_from_file_location('module.name', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _parse_mesh_shape(spec, device):
    """'data=N' -> `distributed.global_mesh()` over the N processes of the
    launch; 'data=N,space=M' or 'space=M' -> `distributed.spatial_mesh(M,
    N)` over N x M; 'data=N,model=M' or 'model=M' ->
    `distributed.tensor_mesh(M, N)`; the process group opened first if it
    is not open (None -> None, one process)."""
    if not spec:
        return None
    sizes = {}
    for part in spec.split(','):
        try:
            name, size = part.split('=')
            sizes[name.strip()] = int(size)
        except ValueError:
            raise ValueError(f"--mesh_shape must look like 'data=4'; got "
                             f'{spec!r}') from None
    other = sorted(set(sizes) - {'data', 'space', 'model'})
    if other:
        raise ValueError(f"--mesh_shape axes are 'data', 'space' and "
                         f"'model'; got {other}")
    if 'space' in sizes and 'model' in sizes:
        raise ValueError("pass a mesh with ONE of 'model'/'space' besides "
                         'data (3-D TPxSPxDP is untested)')
    n = math.prod(sizes.values())
    opened = torch.distributed.is_initialized()
    world = (torch.distributed.get_world_size() if opened
             else int(os.environ.get('WORLD_SIZE', 1)))
    if n != world:
        raise ValueError(
            f'--mesh_shape={spec} needs {n} processes; this launch has '
            f'{world} (torchrun --nproc_per_node=N)')
    if not opened:
        tds.distributed.initialize(device=device)
    if 'space' in sizes:
        return tds.distributed.spatial_mesh(sizes['space'], sizes.get('data'))
    if 'model' in sizes:
        return tds.distributed.tensor_mesh(sizes['model'], sizes.get('data'))
    return tds.distributed.global_mesh()


def dl4ds(flags):
    """The app's body on parsed flags (reference: dl4ds/app.py:94-299;
    dl4ds_tpu/app.py:230-511): load the data module, train, load a saved
    model, export a serving artifact, run the test and metrics phases.
    Returns the trainer, the loaded (model, net) pair, or None."""
    device = 'cuda' if flags.device == 'GPU' else 'cpu'
    mesh = _parse_mesh_shape(flags.mesh_shape, device)
    print('<' * 37, 'DL4DS-TPU', '>' * 36, '\n')

    if flags.debug:
        epochs = 2
        steps_per_epoch = test_steps = validation_steps = 6
    else:
        epochs = flags.epochs
        steps_per_epoch = test_steps = validation_steps = None

    print('<' * 33, 'Loading data', '>' * 33, '\n')
    if flags.data_module is None:
        raise ValueError('`data_module` flag must be provided (path to the '
                         'data preprocessing module)')
    DATA = _load_data_module(flags.data_module)

    # Architecture parameters (reference: app.py:119-168)
    architecture_params = dict(
        n_filters=flags.n_filters,
        normalization=flags.normalization,
        dropout_rate=flags.dropout_rate,
        dropout_variant=flags.dropout_variant,
        attention=flags.attention,
        activation=flags.activation,
        output_activation=flags.output_activation,
        localcon_layer=flags.localcon_layer)
    architecture_params['n_blocks'] = flags.n_blocks
    if flags.upsampling != 'pin':
        architecture_params['rc_interpolation'] = flags.rc_interpolation
    if flags.backbone == 'unet' and flags.upsampling == 'pin':
        architecture_params['decoder_upsampling'] = flags.decoder_upsampling
        architecture_params['rc_interpolation'] = flags.rc_interpolation

    explicit = flags.paired_samples == 'explicit'
    trainer = None
    if flags.train:
        print('\n' + '<' * 29, 'DL4DS Training phase', '>' * 29 + '\n')
        if flags.trainer == 'SupervisedTrainer':
            trainer = tds.SupervisedTrainer(
                backbone=flags.backbone,
                upsampling=flags.upsampling,
                data_train=DATA.data_train,
                data_val=DATA.data_val,
                data_test=DATA.data_test,
                data_train_lr=DATA.data_train_lr if explicit else None,
                data_val_lr=DATA.data_val_lr if explicit else None,
                data_test_lr=DATA.data_test_lr if explicit else None,
                predictors_train=DATA.predictors_train,
                predictors_val=DATA.predictors_val,
                predictors_test=DATA.predictors_test,
                static_vars=DATA.static_vars,
                scale=flags.scale,
                interpolation=flags.interpolation,
                patch_size=flags.patch_size,
                time_window=flags.time_window,
                batch_size=flags.batch_size,
                loss=flags.loss,
                epochs=epochs,
                steps_per_epoch=steps_per_epoch,
                validation_steps=validation_steps,
                test_steps=test_steps,
                device=device,
                learning_rate=tuple(flags.learning_rate),
                lr_decay_after=flags.lr_decay_after,
                early_stopping=flags.early_stopping,
                patience=flags.patience,
                min_delta=flags.min_delta,
                show_plot=flags.show_plot,
                save=flags.save,
                save_path=flags.save_path,
                save_bestmodel=flags.save_bestmodel,
                verbose=flags.verbose,
                data_in_hbm=flags.data_in_hbm,
                steps_per_execution=flags.steps_per_execution,
                gradient_accumulation_steps=(
                    flags.gradient_accumulation_steps),
                lr_schedule=flags.lr_schedule,
                warmup_steps=flags.warmup_steps,
                ema_decay=flags.ema_decay,
                init_weights=flags.init_keras_npz,
                mesh=mesh,
                dtype=(torch.bfloat16 if flags.dtype == 'bfloat16'
                       else torch.float32),
                **architecture_params)
        else:
            discriminator_params = dict(
                n_filters=flags.n_disc_filters,
                n_res_blocks=flags.n_disc_blocks,
                normalization=flags.normalization,
                activation=flags.activation,
                attention=flags.attention)
            trainer = tds.CGANTrainer(
                backbone=flags.backbone,
                upsampling=flags.upsampling,
                data_train=DATA.data_train,
                data_test=DATA.data_test,
                data_train_lr=DATA.data_train_lr if explicit else None,
                data_test_lr=DATA.data_test_lr if explicit else None,
                predictors_train=DATA.predictors_train,
                predictors_test=DATA.predictors_test,
                scale=flags.scale,
                patch_size=flags.patch_size,
                time_window=flags.time_window,
                loss=flags.loss,
                epochs=epochs,
                batch_size=flags.batch_size,
                learning_rates=tuple(flags.learning_rate),
                device=device,
                steps_per_epoch=steps_per_epoch,
                interpolation=flags.interpolation,
                static_vars=DATA.static_vars,
                checkpoints_frequency=flags.checkpoints_frequency,
                save=flags.save,
                save_path=flags.save_path,
                save_logs=False,
                save_loss_history=flags.save,
                verbose=flags.verbose,
                generator_params=architecture_params,
                discriminator_params=discriminator_params,
                gradient_accumulation_steps=(
                    flags.gradient_accumulation_steps),
                lr_schedule=flags.lr_schedule,
                warmup_steps=flags.warmup_steps,
                ema_decay=flags.ema_decay,
                init_weights=flags.init_keras_npz,
                mesh=mesh)
        trainer.run()

    y_hat = None
    mc_members = None
    if (flags.test or flags.metrics or flags.export_artifact) \
            and trainer is None and flags.trained_model_path:
        # evaluate a previously-saved model without retraining: load_model
        # returns a (model, net) pair, which Predictor/predict_mc accept
        # wherever a trainer is expected
        trainer = tds.load_model(flags.trained_model_path, device=device)
        print(f'Loaded trained model from {flags.trained_model_path} '
              f'({trainer[0].name})')
    if (flags.test or flags.metrics) and trainer is None:
        print('NOTE: --test/--metrics skipped — they run on the model '
              'trained in this invocation (pass --train, or point '
              '--trained_model_path at a saved model folder)')
    if flags.export_artifact and trainer is not None:
        model, net = (trainer if isinstance(trainer, tuple)
                      else (trainer.model, trainer.net))
        export_kwargs = {}
        if flags.export_quantize:
            # calibrate on the same model-ready tensors the test phase
            # feeds the network (predict's own default calibration source)
            from .inference import _assemble_inputs
            cx, caux, n_cal = _assemble_inputs(
                model, DATA.inference_data, flags.scale,
                flags.inference_array_in_hr, DATA.static_vars,
                DATA.inference_predictors, flags.time_window,
                flags.interpolation, device)
            b = min(flags.export_batch, n_cal)
            export_kwargs = dict(
                quantize=flags.export_quantize, batch=b,
                calibration=cx[:b],
                calibration_aux=None if caux is None else caux[:b])
        nbytes = tds.save_serving_artifact(model, net, flags.export_artifact,
                                           **export_kwargs)
        print(f'Serving artifact written to {flags.export_artifact} '
              f'({nbytes:,} bytes'
              + (f', {flags.export_quantize}, batch={export_kwargs["batch"]}'
                 if flags.export_quantize else '')
              + f'); serve it with: python -m '
              f'dl4ds_tpu_torch.serve --artifact {flags.export_artifact}')
    if flags.test and trainer is not None:
        print('\n' + '<' * 29, 'DL4DS Test phase', '>' * 29 + '\n')
        predictor = tds.Predictor(
            trainer=trainer,
            array=DATA.inference_data,
            array_in_hr=flags.inference_array_in_hr,
            scale=flags.scale,
            interpolation=flags.interpolation,
            predictors=DATA.inference_predictors,
            static_vars=DATA.static_vars,
            time_window=flags.time_window,
            batch_size=flags.batch_size,
            scaler=DATA.inference_scaler,
            save_path=flags.save_path,
            save_fname=flags.inference_save_fname,
            device=device)
        y_hat = predictor.run()

        if flags.inference_mc_members > 0:
            if not str(flags.dropout_variant or '').startswith('mc'):
                print('NOTE: --inference_mc_members ignored — the model was '
                      'not built with an mc* dropout variant (dropout is '
                      'inactive at inference, so all members would be '
                      'identical)')
            else:
                mc_mean, mc_std, mc_members = tds.predict_mc(
                    trainer, DATA.inference_data, scale=flags.scale,
                    n_members=flags.inference_mc_members,
                    return_members=True,
                    array_in_hr=flags.inference_array_in_hr,
                    interpolation=flags.interpolation,
                    predictors=DATA.inference_predictors,
                    static_vars=DATA.static_vars,
                    time_window=flags.time_window,
                    batch_size=flags.batch_size,
                    scaler=DATA.inference_scaler,
                    device=device)
                if flags.save_path is not None:
                    os.makedirs(flags.save_path, exist_ok=True)
                    np.save(os.path.join(flags.save_path,
                                         'y_hat_mc_mean.npy'), mc_mean)
                    np.save(os.path.join(flags.save_path,
                                         'y_hat_mc_std.npy'), mc_std)

        # netCDF export when xarray is available (reference: app.py:280-287)
        if flags.save and flags.save_path is not None:
            os.makedirs(flags.save_path, exist_ok=True)
            try:
                import xarray as xr
                gt = DATA.gt_holdout_dataset
                y = np.squeeze(np.asarray(y_hat))
                # spatio-temporal predict windows the input: y has
                # N - (time_window - 1) samples — align to the LAST
                # timestamps (each window predicts its final step)
                time = np.asarray(gt.time)[-y.shape[0]:]
                y_hat_da = xr.DataArray(
                    data=y, dims=('time', 'lat', 'lon'),
                    coords={'time': time, 'lon': gt.lon, 'lat': gt.lat})
                y_hat_da.to_netcdf(
                    os.path.join(flags.save_path, 'y_hat.nc'))
            except (ImportError, AttributeError):
                np.save(os.path.join(flags.save_path, 'y_hat_export.npy'),
                        np.squeeze(np.asarray(y_hat)).astype('float32'))

    if flags.metrics and y_hat is not None:
        print('\n' + '<' * 25, 'DL4DS Metrics computation phase',
              '>' * 25 + '\n')
        gt = DATA.gt_holdout_dataset
        # georeference the metric maps when the holdout carries coords
        lats = getattr(getattr(gt, 'lat', None), 'values', None)
        lons = getattr(getattr(gt, 'lon', None), 'values', None)
        tds.compute_metrics(
            y_test=gt,
            y_test_hat=y_hat,
            dpi=300, plot_size_px=1200,
            mask=DATA.gt_mask,
            save_path=flags.save_path,
            n_jobs=-1, lats=lats, lons=lons, device=device)
        if mc_members is not None:
            # probabilistic verification of the MC-dropout ensemble,
            # the ground truth aligned to the LAST n predicted samples
            gt_aligned = gt[-mc_members.shape[1]:]
            tds.compute_prob_metrics(
                gt_aligned, mc_members, dpi=300,
                save_path=flags.save_path, lats=lats, lons=lons)
    return trainer


def main(argv=None):
    """Parse `argv` (default `sys.argv`; the program's name first) and run
    the app; returns what `dl4ds` returns."""
    return dl4ds(parse_flags(sys.argv if argv is None else argv))


if __name__ == '__main__':
    try:
        main()
    except FlagError as e:
        print(f'FATAL Flags parsing error: {e}\n{usage()}', file=sys.stderr)
        sys.exit(1)
