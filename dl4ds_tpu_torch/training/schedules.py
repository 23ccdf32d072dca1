"""
Learning-rate schedules on a device count (the counterparts of the optax
schedules that `dl4ds_tpu/training/supervised.py:330-385` builds).

A schedule maps the optimizer's update count, an int32 tensor (0 for the
first update), to the rate of that update as a float32 tensor on the same
device: device work only, so that it runs inside a captured training step.
The formulas are optax's, in the same order of float32 operations.
"""

import math

import torch

__all__ = ['piecewise_constant_schedule', 'cosine_decay_schedule',
           'warmup_cosine_decay_schedule', 'build_schedule']


def _f32(value, count):
    """`value` as a float32 scalar on count's device, by a fill on the
    device (no copy from the host)."""
    return torch.full((), value, dtype=torch.float32, device=count.device)


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    """optax.piecewise_constant_schedule: the rate is multiplied by each
    scale once the count reaches its boundary (init * scale formed in
    float32, as optax forms it)."""
    steps = []
    value = torch.tensor(init_value, dtype=torch.float32)
    for boundary, scale in sorted(boundaries_and_scales.items()):
        value = torch.tensor(scale, dtype=torch.float32) * value
        steps.append((int(boundary), float(value)))
    init = float(torch.tensor(init_value, dtype=torch.float32))

    def schedule(count):
        v = _f32(init, count)
        for boundary, after in steps:
            v = torch.where(count < boundary, v, _f32(after, count))
        return v
    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule (exponent 1): init * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)."""
    if not decay_steps > 0:
        raise ValueError(f'The cosine_decay_schedule requires positive '
                         f'decay_steps, got decay_steps={decay_steps}.')
    decay_steps = float(decay_steps)

    def schedule(count):
        c = torch.clamp(count, max=decay_steps).to(torch.float32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0):
    """optax.warmup_cosine_decay_schedule: a linear ramp from `init_value`
    to `peak_value` over `warmup_steps`, then the cosine decay from the
    peak to `end_value` over the remaining `decay_steps - warmup_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)

    def linear(count):
        if warmup_steps <= 0:
            return _f32(init_value, count)
        c = torch.clamp(count, 0, warmup_steps).to(torch.float32)
        frac = 1 - c / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def schedule(count):
        return torch.where(count < warmup_steps, linear(count),
                           cosine(count - warmup_steps))
    return schedule


def build_schedule(learning_rate, lr_decay_after, lr_schedule, warmup_steps,
                   total_steps, scale_by=1):
    """The schedule of a trainer's options, as the JAX trainer's
    `_build_optimizer` picks it: a callable `lr_schedule` as given;
    'cosine' decays lr[0] to lr[1] (or 0 for one rate) over `total_steps`;
    'warmup_cosine' ramps up over `warmup_steps` (0: total // 20, at least
    1) first; otherwise a 2-tuple is the piecewise schedule at
    `lr_decay_after`. Every rate but a callable's is scaled by `scale_by`,
    the number of data-parallel ranks (Goyal et al.'s linear scaling).
    Returns (initial rate, schedule or None for a constant rate)."""
    lr = learning_rate
    if callable(lr_schedule):
        return None, lr_schedule
    if lr_schedule is not None:
        if isinstance(lr, (tuple, list)) and len(lr) > 1:
            lr0, lr1 = float(lr[0]), float(lr[1])
        else:
            lr0 = float(lr[0] if isinstance(lr, (tuple, list)) else lr)
            lr1 = 0.0
        total = max(int(total_steps), 1)
        if lr_schedule == 'cosine':
            return None, cosine_decay_schedule(lr0 * scale_by, total,
                                               lr1 / lr0)
        warmup = warmup_steps or max(total // 20, 1)
        return None, warmup_cosine_decay_schedule(
            0.0, lr0 * scale_by, warmup, total, lr1 * scale_by)
    if isinstance(lr, (tuple, list)) and len(lr) > 1:
        return None, piecewise_constant_schedule(
            float(lr[0]) * scale_by, {int(lr_decay_after): lr[1] / lr[0]})
    return float(lr[0] if isinstance(lr, (tuple, list)) else lr) * scale_by, \
        None
