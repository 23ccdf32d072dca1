"""
One-card parallelism (the counterpart of `dl4ds_tpu/parallel.py`'s parts
that run on one device): halo-tiled serving and deep ensembles.

`predict_tiled` runs full-grid inference in halo-overlapped windows, for
grids whose activations do not fit one forward. Fixed-size windows of
`tile + 2*halo` are anchored inside the grid (clipped flush at the true
borders), so border windows see the zero padding the full-grid
convolutions see, and the tiled output equals the untiled one wherever
`halo` is at least the network's receptive-field radius. The windows are
gathered and the output placed on the device, which copies the result to
the host once.

Exactness caveat, as in the JAX package: a model with channel attention
(the zoo's output head by default) takes the gate's mean over each window,
not over the grid, so its tiled output approximates the untiled one. Build
models with `attention=False, output_attention=False` for exact tiling.

Deep ensembles: `init_ensemble` stacks `n_members` independently seeded
networks' parameters into one dict of `[M, ...]` tensors
(`torch.func.stack_module_state`), `make_ensemble_step` trains every
member in one step (`torch.func.vmap` of `torch.func.grad_and_value` over
`torch.func.functional_call`, then one Adam over the stacked tensors) and
`predict_ensemble` serves them in one vmapped forward. Under `vmap` the
channel-attention gate runs K1's member mode, one launch each way for all
members (`ops/fused_ops.py`). Meshes (`mesh=`) are ROADMAP item 10's data
parallelism and raise; so do spatio-temporal ensembles, whose ConvLSTM
kernels have no member mode yet.
"""

import collections

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, stack_module_state

from .inference import _serving
from .models.blocks import use_dropout_generator
from .utils import checkarg_loss, not_ported, resolve_device

__all__ = ['predict_tiled', 'receptive_field_radius', 'init_ensemble',
           'make_ensemble_step', 'predict_ensemble', 'EnsembleStep']


def _output_scale(model):
    """Output/input spatial ratio from the model's name-suffix contract
    (names end _spc/_rc/_dc/_pin)."""
    upsampling = model.name.split('_')[-1]
    return (int(model.config['scale']) if upsampling in ('spc', 'rc', 'dc')
            else 1)


def receptive_field_radius(n_blocks, ks=3, convs_per_block=2, extra=6,
                           time_window=None):
    """Conservative receptive-field radius estimate for the zoo's backbones:
    each KxK conv adds (K-1)/2 px per side.

    Spatio-temporal models: pass `time_window` -- each ConvLSTM layer's
    recurrence convolves the hidden state once per timestep, so the
    spatial radius grows by (K-1)/2 * (T-1) per recurrent layer on top
    of the input convs (the backbone has 2 ConvLSTM layers per block,
    stem included: 2*(n_blocks+1) recurrent layers)."""
    per_conv = (ks - 1) // 2
    r = per_conv * (n_blocks * convs_per_block + extra)
    if time_window is not None and time_window > 1:
        r += per_conv * (time_window - 1) * 2 * (n_blocks + 1)
    return r


def _net_device(net):
    return next(net.parameters()).device


def _on(t, dev, dtype=torch.float32):
    """A numpy array or tensor as a `dtype` tensor on `dev`."""
    return torch.as_tensor(t).to(device=dev, dtype=dtype)


def predict_tiled(model, net, x, aux=None, tile=128, halo=32, batch_size=8,
                  mesh=None, quantize=None, calibration_quantile=None):
    """Tiled inference over [B, h, w, C] or spatio-temporal [B, T, h, w, C]
    input (LR for post-upsampling models; HR-sized for 'pin'), with the
    (DSModel, nn.Module) pair; the windows run in eval mode in batches of
    `batch_size` on the network's device. Returns float32 numpy [B(,T),
    h*s, w*s, C_out], s the model's output scale (1 for 'pin').

    `quantize` ('int8' or 'weight-only', with `calibration_quantile`)
    serves the windows through `quantization.quantize_forward`, calibrated
    on the first dispatch batch of real windows (cycled if there are
    fewer) and pinned to that batch: the windows are wrap-padded to a
    multiple of it (dl4ds_tpu/parallel.py:166-200). `mesh` (item 10)
    raises."""
    if mesh is not None:
        raise not_ported('predict_tiled(mesh=...)', 10, 3)
    dev = _net_device(net)
    x = _on(x, dev)
    b = x.shape[0]
    h, w = x.shape[-3], x.shape[-2]
    scale = _output_scale(model)

    t_in_y = min(h, tile + 2 * halo)
    t_in_x = min(w, tile + 2 * halo)
    n_ty = -(-h // tile)
    n_tx = -(-w // tile)

    # aux lives on the HR(-output) grid; scale its window geometry
    s_aux = None
    if aux is not None:
        aux = _on(aux, dev)
        s_aux = aux.shape[-3] // h

    windows, aux_windows, placements = [], [], []
    for ty in range(n_ty):
        for tx in range(n_tx):
            y0, x0 = ty * tile, tx * tile
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            wy0 = min(max(y0 - halo, 0), h - t_in_y)
            wx0 = min(max(x0 - halo, 0), w - t_in_x)
            windows.append(x[..., wy0:wy0 + t_in_y, wx0:wx0 + t_in_x, :])
            if aux is not None:
                aux_windows.append(
                    aux[..., wy0 * s_aux:(wy0 + t_in_y) * s_aux,
                        wx0 * s_aux:(wx0 + t_in_x) * s_aux, :])
            # where the tile region sits inside the window, and in the output
            placements.append((y0, x0, y1 - y0, x1 - x0, y0 - wy0, x0 - wx0))

    # tile-major, then batch: window k's samples are [k*b, (k+1)*b)
    tiles = torch.cat(windows)                # [B*nt, (T,) t_in_y, t_in_x, C]
    aux_tiles = torch.cat(aux_windows) if aux is not None else None
    n_win = tiles.shape[0]
    bs_eff = min(batch_size, n_win)
    if quantize is None:
        with _serving(net):
            out_tiles = torch.cat([
                net(tiles[i:i + bs_eff],
                    aux_tiles[i:i + bs_eff] if aux_tiles is not None
                    else None).float() for i in range(0, n_win, bs_eff)])
    else:
        out_tiles = _quantized_tiles(model, net, tiles, aux_tiles, bs_eff,
                                     quantize, calibration_quantile)

    c_out = out_tiles.shape[-1]
    full = torch.zeros((b, *out_tiles.shape[1:-3], h * scale, w * scale,
                        c_out), dtype=torch.float32, device=dev)
    for k, (y0, x0, ty_len, tx_len, oy, ox) in enumerate(placements):
        blk = out_tiles[k * b:(k + 1) * b]
        full[..., y0 * scale:(y0 + ty_len) * scale,
             x0 * scale:(x0 + tx_len) * scale, :] = \
            blk[..., oy * scale:(oy + ty_len) * scale,
                ox * scale:(ox + tx_len) * scale, :]
    return full.cpu().numpy()


def _quantized_tiles(model, net, tiles, aux_tiles, bs, mode,
                     calibration_quantile):
    """The windows through the quantized forward, pinned to `bs` windows a
    dispatch: calibrated on the first `bs` windows (cycled), the windows
    wrap-padded to a multiple of `bs`, the padding's outputs dropped."""
    from .quantization import quantize_forward
    n_win = tiles.shape[0]
    sel = torch.arange(bs, device=tiles.device) % n_win
    qf = quantize_forward(
        model, net, tiles[sel],
        calibration_aux=aux_tiles[sel] if aux_tiles is not None else None,
        mode=mode, calibration_quantile=calibration_quantile)
    n_run = -(-n_win // bs) * bs
    if n_run != n_win:
        sel = torch.arange(n_run, device=tiles.device) % n_win
        tiles = tiles[sel]
        aux_tiles = aux_tiles[sel] if aux_tiles is not None else None
    with torch.inference_mode():
        return torch.cat([
            qf(tiles[i:i + bs],
               aux_tiles[i:i + bs] if aux_tiles is not None else None)
            .float() for i in range(0, n_run, bs)])[:n_win]


# ---------------------------------------------------------------------------
# Deep ensembles: members stacked on one card, trained and served by vmap
# ---------------------------------------------------------------------------

EnsembleStep = collections.namedtuple(
    'EnsembleStep', ['step', 'init_opt', 'axis_size'])


def _check_ensemble_model(model, what):
    if len(model.input_shape) == 4:
        raise not_ported(f'{what} of a spatio-temporal model (the ConvLSTM '
                         f'kernels K2-K4 under vmap, a member mode each)', 10,
                         2)


def _base_net(model, dev):
    """A network of `model` on `dev`, built once a device, that
    `functional_call` runs with a member's parameters in place of its
    own."""
    nets = model.__dict__.setdefault('_ensemble_nets', {})
    if dev not in nets:
        nets[dev] = model.init(0, device=dev)
    return nets[dev]


def _stack_where(stacked):
    """The stack's device and dtype (float32; float64 in a reference run),
    which its inputs are given."""
    leaf = next(iter(stacked.values()))
    return leaf.device, leaf.dtype


def init_ensemble(model, n_members, seed=0, mesh=None,
                  member_axis='ensemble', device='cuda'):
    """Build `n_members` networks of `model`, member k's weights drawn from a
    seed derived from (`seed`, k), and return their parameters stacked: a
    dict from parameter name (`net.named_parameters()`) to an [M, ...]
    tensor on `device`, the port's form of the JAX package's stacked
    pytree (the bits differ from JAX's `random.split`). A model with batch
    norm raises, as in the JAX package; `mesh` and spatio-temporal models
    raise naming ROADMAP item 10."""
    if mesh is not None:
        raise not_ported('init_ensemble(mesh=...)', 10, 3)
    _check_ensemble_model(model, 'init_ensemble')
    if (model.config or {}).get('normalization') == 'bn':
        raise ValueError('ensemble training supports parameter-only models '
                         '(batch-norm statistics are per-member mutable '
                         'state); build the model without batch norm')
    device = resolve_device(device)
    nets = [model.init(int(np.random.SeedSequence((seed, k)).generate_state(
        1, np.uint64)[0]), device=device) for k in range(n_members)]
    params, _ = stack_module_state(nets)
    return {name: p.detach().contiguous() for name, p in params.items()}


def _adam(params):
    """optax.adam(1e-4): Adam with lr 1e-4, betas (0.9, 0.999), eps 1e-8;
    one fused (CUDA) or foreach (CPU) update over the stacked tensors, which
    is each member's own Adam, the update being elementwise."""
    cuda = params[0].device.type == 'cuda'
    return torch.optim.Adam(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            fused=cuda or None)


def make_ensemble_step(model, mesh=None, tx=None, loss='mae',
                       member_axis='ensemble', data_axis='data',
                       bootstrap=True):
    """A training step that advances a whole deep ensemble at once: the
    members' losses and gradients in one `torch.func.vmap` of
    `grad_and_value` over `functional_call` (x, y and aux shared, each
    member's bootstrap resample and dropout draws its own), then one
    optimizer update over the stacked parameters.

    Returns an `EnsembleStep`:
      init_opt(stacked) -> the optimizer over the stacked tensors, which
        holds its state (`tx(list(stacked.values()))`; `tx=None` is Adam
        with lr 1e-4, optax.adam(1e-4)'s settings);
      step(stacked, opt_state, x, y, key, aux=None) -> (stacked, opt_state,
        losses[M]), updating the stacked tensors in place;
      axis_size: 1, the members a step holds being the stack's M.
    x is [B, ...model.input_shape], y the matching HR batch, aux required
    iff the model has an aux branch (`model.aux_shape`). `key` is a
    `torch.Generator` on the stack's device or an int seed: with
    `bootstrap=True` each member trains on its own resample of the batch,
    drawn on the device from it, and the dropout draws come from it under
    vmap's randomness='different'. `mesh` raises naming ROADMAP item 10."""
    if mesh is not None:
        raise not_ported('make_ensemble_step(mesh=...)', 10, 3)
    _check_ensemble_model(model, 'make_ensemble_step')
    lossf = checkarg_loss(loss)
    tx = _adam if tx is None else tx
    needs_aux = model.aux_shape is not None

    def step(stacked, opt_state, x, y, key, aux=None):
        if needs_aux and aux is None:
            raise ValueError(f'model {model.name!r} has an aux branch '
                             f'(aux_shape={model.aux_shape}); pass aux= to '
                             f'step() or its params never train')
        held = opt_state.param_groups[0]['params']
        if len(held) != len(stacked) or any(
                a is not b for a, b in zip(held, stacked.values())):
            raise ValueError('opt_state is not the optimizer of this stack; '
                             'make it with init_opt(stacked)')
        dev, dtype = _stack_where(stacked)
        x, y = _on(x, dev, dtype), _on(y, dev, dtype)
        aux = _on(aux, dev, dtype) if needs_aux else None
        gen = (key if isinstance(key, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(key)))
        net = _base_net(model, dev).train()
        idx = None
        if bootstrap:
            b, m = x.shape[0], len(next(iter(stacked.values())))
            idx = torch.randint(0, b, (m, b), generator=gen, device=dev)

        def member_loss(params, x, y, aux, idx):
            if idx is not None:
                x, y = x[idx], y[idx]
                if aux is not None:
                    aux = aux[idx]
            out = functional_call(net, params, (x, aux))
            return lossf(y, out.to(y.dtype))
        params = {k: v.detach() for k, v in stacked.items()}
        fn = torch.func.vmap(
            grad_and_value(member_loss),
            in_dims=(0, None, None, None, 0 if bootstrap else None),
            randomness='different')
        try:
            with use_dropout_generator(net, gen):
                grads, losses = fn(params, x, y, aux, idx)
        finally:
            net.eval()
        for name, p in stacked.items():
            g = grads[name]
            # a fused optimizer takes each gradient in its parameter's layout
            p.grad = (g if g.stride() == p.stride()
                      else torch.empty_like(p).copy_(g))
        opt_state.step()
        for p in stacked.values():
            p.grad = None
        return stacked, opt_state, losses.detach()

    def init_opt(stacked):
        return tx(list(stacked.values()))

    return EnsembleStep(step, init_opt, 1)


def predict_ensemble(model, stacked_variables, x, aux=None, mesh=None,
                     member_axis='ensemble', return_members=False):
    """Ensemble inference: every member on `x` in one vmapped eval forward
    on the stack's device, returning `(mean, std)` over the members (float32
    numpy; std the population's, as `jnp.std`) -- the downscaled field and
    its epistemic uncertainty map. With `return_members=True` the member
    stack [M, N, H, W, C] comes third, the input of
    `metrics.crps_ensemble` and `metrics.compute_prob_metrics`. `mesh`
    raises naming ROADMAP item 10."""
    if mesh is not None:
        raise not_ported('predict_ensemble(mesh=...)', 10, 3)
    _check_ensemble_model(model, 'predict_ensemble')
    dev, dtype = _stack_where(stacked_variables)
    x = _on(x, dev, dtype)
    aux = _on(aux, dev, dtype) if aux is not None else None
    net = _base_net(model, dev)
    params = {k: v.detach() for k, v in stacked_variables.items()}
    with _serving(net):
        outs = torch.func.vmap(
            lambda p: functional_call(net, p, (x, aux)),
            randomness='same')(params).float()
    mean = outs.mean(dim=0).cpu().numpy()
    std = outs.std(dim=0, correction=0).cpu().numpy()
    if return_members:
        return mean, std, outs.cpu().numpy()
    return mean, std
