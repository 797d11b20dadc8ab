"""Small constant tables on a device, made once per key.

A table built from a host list on every call would be a blocking copy on
the card, so each is cached by its arguments (shapes, device). A table made
while a program is traced (`torch.export`) is a fake tensor that belongs to
that trace: it is handed to the trace and not kept. Tables are made outside
inference mode, so one made while serving can be saved for backward by a
training forward later.
"""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import FakeTensor


def device_table(fn):
    """Cache `fn`'s tensor (or tuple of tensors) by its hashable arguments,
    as `functools.lru_cache` does, except what a trace made (fake tensors)."""
    cache = {}

    @functools.wraps(fn)
    def table(*args):
        t = cache.get(args)
        if t is None:
            # a normal tensor even under inference mode: autograd may save it
            # in a later call (a division by the table in a training forward)
            with torch.inference_mode(False):
                t = fn(*args)
            if not any(isinstance(x, FakeTensor) for x in (t if isinstance(t, tuple) else (t,))):
                cache[args] = t
        return t

    table.cache_clear = cache.clear
    return table
