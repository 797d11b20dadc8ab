"""Where the reference rounds: every convolution and matrix product goes
through `conv2d` and `linear` here, so one switch puts the whole reference in
a lower precision (the control of `portbench/lib/checks.py`).

`PRECISION` is None for the reference proper (float32, TF32 off), or
"fp8": each operand of a convolution or a linear layer (input and weight)
and its result rounded to float8 e4m3 under a per-tensor scale (amax /
448): an fp8 engine feeds its tensor cores fp8 and keeps its activations in
fp8, as the bf16 program keeps them in bf16; sums stay float32, and a
backward passes through the rounding unchanged (straight through), as fp8
training keeps its gradients wider.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISION = None
FP8_MAX = 448.0


def rounded(x: torch.Tensor) -> torch.Tensor:
    if PRECISION is None:
        return x
    if PRECISION != "fp8":
        raise ValueError(f"precision {PRECISION!r}")
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach() if x.requires_grad else q


def conv2d(x, w, b=None, stride=1, padding=0):
    return rounded(F.conv2d(rounded(x), rounded(w), b, stride=stride, padding=padding))


def linear(x, w, b=None):
    return rounded(F.linear(rounded(x), rounded(w), b))


@contextlib.contextmanager
def exact(precision=None):
    """float32 products without TF32 (the reference), or `precision`."""
    global PRECISION
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, PRECISION)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    PRECISION = precision
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         PRECISION) = saved
