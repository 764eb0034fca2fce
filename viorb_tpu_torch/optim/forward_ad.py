"""`torch.func.jacfwd` that one thread at a time evaluates.

PyTorch keeps forward-mode AD's dual levels in one process-wide stack, and
`jacfwd` enters a level and leaves it around its evaluation: two threads
differentiating at once (an async MonoViSlam's tracker and its mapping
worker, each running a VI optimizer eagerly) enter and leave each other's
levels and fail ("no level exists"). Every Jacobian the port takes in
forward mode goes through `jacfwd` here, which holds one process-wide lock
across the evaluation. In a CUDA graph the lock is taken at capture only:
a replay runs no Python."""

import threading

import torch

_LOCK = threading.RLock()


def jacfwd(fn, *args, **kwargs):
    """`torch.func.jacfwd(fn, *args, **kwargs)`, evaluated under the lock."""
    jac = torch.func.jacfwd(fn, *args, **kwargs)

    def call(*a, **kw):
        with _LOCK:
            return jac(*a, **kw)

    return call
