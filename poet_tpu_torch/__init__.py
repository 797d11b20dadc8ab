"""poet_tpu_torch — PoET pose estimation on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of `poet_tpu`. Module paths and names follow the JAX
package so that each counterpart is easy to find; the public functions keep
its layouts (NHWC images, (B, S, H, D) attention values) so that parity
tests compare like with like. Inside, the code is plain PyTorch: `nn.Module`s,
an explicit `device`, `torch.Generator` for random numbers.

Every TPU kernel on a ported path is a hand-written CUDA kernel for sm_90a
under `csrc/` (deformable-attention sampling and its adjoint, multi-scale
RoIAlign, the small-C stem conv, the ADD-S min distance), built with nvcc
at first use; on CPU tensors each entry runs its plain PyTorch version.

This package never imports JAX or `poet_tpu`.
"""

__version__ = "0.1.0"
