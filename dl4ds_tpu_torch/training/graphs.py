"""
A training or evaluation step captured as a CUDA graph (the port's
counterpart of the JAX trainer's `train_many` and `eval_many`,
`dl4ds_tpu/training/supervised.py:485-512`, which run a chunk of steps as
one XLA program).

The step function reads and writes only tensors that outlive the graph:
the parameters, the optimizer, EMA and accumulation state, the device
scalars of the rate and the counts, the plan rows of a chunk, the row
counter and a loss buffer. So one capture serves every step, and a replay
makes no host read. `CapturedStep` first runs the function on a side
stream to warm it up (kernel builds, the kernels' first-use allocations
and attributes, cuDNN and cuBLAS plans, the optimizer's state), puts the
tensors it changed back as they were, then captures it once. The dropout
generator is registered with the graph (`register_generator_state`), so
that each replay draws from where the generator stands and advances it
by a step's draws, as an eager step does; the warm-up and the capture
leave its state as they found it. The kernel
wrappers count their calls in the warm-up and the capture; a replay calls
no wrapper, so it counts nothing there. There is no eager fallback: a
capture or replay that fails raises.

A data-parallel step holds NCCL collectives (the gradients' all-reduce,
the global batch norms and loss ranges). The process group's communicator
exists before the capture (`distributed.initialize` binds the device, and
the warm-up calls run every collective of the step once); each
collective is issued synchronously on the capturing stream, so the graph
holds it and a replay runs it. In a process with a process group a step
is captured after the device has drained the warm-up, in the
'thread_local' capture mode, so that the group's watchdog thread may
query its events meanwhile.
"""

import torch

__all__ = ['CapturedStep', 'WARMUP_CALLS']

# warm-up calls of a step before its capture
WARMUP_CALLS = 2


class CapturedStep:
    """`fn()` captured once as a CUDA graph on the current device.

    `state` lists every tensor that `fn` changes in place; the warm-up
    calls change them, and they are restored before the capture, so the
    warm-up leaves no trace in the run. `generators` are the CUDA
    generators `fn` draws from: registered with the graph, their states
    restored after the warm-up and after the capture. `rewind` (tensors of
    `state`, such as a row counter) is zeroed before each warm-up call, so
    that each call reads what the first replay will. `pool` is the memory pool of an
    earlier capture to share (the steps of a run never overlap, and they
    hand results to each other only through `state`). `replays` counts
    the replays so far."""

    def __init__(self, fn, state, pool=None, rewind=(), generators=()):
        saved = [t.detach().clone() for t in state]
        rng = [g.get_state() for g in generators]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                for t in rewind:
                    t.zero_()
                fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        for g, r in zip(generators, rng):
            g.set_state(r)
            self.graph.register_generator_state(g)
        mode = 'global'
        if torch.distributed.is_initialized():
            torch.cuda.synchronize()
            mode = 'thread_local'
        with torch.cuda.graph(self.graph, pool=pool,
                              capture_error_mode=mode):
            fn()
        for g, r in zip(generators, rng):
            g.set_state(r)
        self.replays = 0

    def pool(self):
        return self.graph.pool()

    def replay(self):
        self.graph.replay()
        self.replays += 1
