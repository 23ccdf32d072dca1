"""The member mode's shared pieces: a deep ensemble's M members in one
kernel call (weights stacked [M, ...], the per-sample tensors M members of
B samples in turn), reached under `torch.func.vmap` by the `vmap` rules of
the gate (`fused_ops`), the SSIM (`fused_ops`) and the ConvLSTM layer
(`convlstm`)."""

import torch

__all__ = ['front', 'by_member', 'member_vmap']


def front(t, d, n):
    """A vmap rule's operand with its mapped dim first, [n, ...]; expanded
    to n where the operand is not mapped (d None)."""
    return t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)


def by_member(fn, per_sample, weights, n_cat):
    """fn(*per-sample chunks, *weights) member by member: the per-sample
    tensors [M * B, ...] cut into M chunks, the weights [M, ...] indexed;
    the first `n_cat` results (per sample) concatenated, the others (per
    member) stacked, a None result kept. The member mode's plain
    version."""
    n = weights[0].shape[0]
    outs = [fn(*(t.chunk(n)[i] for t in per_sample), *(w[i] for w in weights))
            for i in range(n)]
    return tuple(None if o[0] is None else torch.cat(o) if k < n_cat
                 else torch.stack(o) for k, o in enumerate(zip(*outs)))


def member_vmap(call, info, in_dims, args, per_sample, weights, what,
                members=False, out_per_sample=None):
    """The `vmap` rule of a call with a member mode: `call(*args)` with the
    mapped axis moved first and flattened into the batch of the operands at
    the indices `per_sample`. `weights` maps the weights' indices to their
    dims an instance; weights that are already a member stack raise
    NotImplementedError ("`what`: ..."). With a mapped weight, or with
    `members` (a backward, whose instances need weight gradients of their
    own), every weight is expanded to the mapped size and stacked: the
    member mode, B samples a member; else one call on the flattened batch.
    The outputs at the indices `out_per_sample` (all when None) come back
    [n, B, ...], the others (weight gradients) are [n, ...] already.
    Returns (outputs, out_dims) as a `vmap` rule does."""
    n = info.batch_size
    args = list(args)
    for i, ndim in weights.items():
        if args[i].dim() - (in_dims[i] is not None) != ndim:
            raise NotImplementedError(f'{what}: vmap over weights that are '
                                      f'already a member stack')
    for i in per_sample:
        t = front(args[i], in_dims[i], n)
        args[i] = t.reshape(-1, *t.shape[2:]).contiguous()
    if members or any(in_dims[i] is not None for i in weights):
        for i in weights:
            args[i] = front(args[i], in_dims[i], n).contiguous()
    out = call(*args)
    outs = (out,) if torch.is_tensor(out) else tuple(out)
    outs = tuple(o.unflatten(0, (n, -1))
                 if out_per_sample is None or k in out_per_sample else o
                 for k, o in enumerate(outs))
    if torch.is_tensor(out):
        return outs[0], 0
    return outs, (0,) * len(outs)
