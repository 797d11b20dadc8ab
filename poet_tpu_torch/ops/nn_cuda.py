"""Min squared distance (ADD-S nearest neighbour): the entry the evaluator
calls, its plain version and its Hopper kernel's wrapper.

The contract of `poet_tpu/ops/nn_pallas.py:min_dist_sq_pallas`: gt (P, N,
3) and est (P, M, 3) f32 -> (P, N) f32 with out[p, n] = max(0, min_m
|gt[p, n] - est[p, m]|^2), without forming the (P, N, M) matrix. A NaN
coordinate makes its distances NaN, and a NaN distance makes the minimum
NaN, as `jnp.minimum` does:
  * CPU tensors run the plain version, `min_dist_sq_plain`;
  * CUDA tensors launch `csrc/min_dist_sq_fwd.cu` through `MIN_DIST_SQ`, or
    raise. There is no fallback from one to the other.
There is no gradient: the metric is computed on fetched poses.

The kernel replaces the TPU kernel `nn_pallas.py:_kernel`. It ranks the
est points by |e|^2 - 2 g.e on the tensor cores (mma.sync TF32 in the
3xTF32 split) and returns the winner's direct difference distance, so a
duplicate still scores exactly 0; NaN is carried by flags. The design note
is in the source.
"""

from __future__ import annotations

import torch

from poet_tpu_torch.ops.cuda_build import NN_LIB, device_guard, stream_of

# elements of the plain version's (P, N, chunk) temporaries: 2^26 f32, 256 MB each
PLAIN_CHUNK_ELEMENTS = 1 << 26


def _check(gt: torch.Tensor, est: torch.Tensor):
    """Validate the operands; returns (P, N, M)."""
    if gt.dim() != 3 or est.dim() != 3 or gt.shape[-1] != 3 or est.shape[-1] != 3 \
            or gt.shape[0] != est.shape[0]:
        raise ValueError(f"expected gt (P, N, 3) and est (P, M, 3), got {tuple(gt.shape)} "
                         f"and {tuple(est.shape)}")
    if gt.dtype != torch.float32 or est.dtype != torch.float32:
        raise TypeError(f"gt and est must be float32, got {gt.dtype} and {est.dtype}")
    if gt.device != est.device:
        raise ValueError(f"gt on {gt.device}, est on {est.device}")
    if gt.requires_grad or est.requires_grad:
        raise RuntimeError("min_dist_sq has no gradient")
    P, N, _ = gt.shape
    M = est.shape[1]
    if M < 1:
        raise ValueError("est has no point: the minimum is undefined")
    return P, N, M


def min_dist_sq_plain(gt: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """The plain version: the same direct difference form, chunked over est
    so that each (P, N, chunk) temporary holds at most PLAIN_CHUNK_ELEMENTS,
    running minimum by `torch.minimum` (which propagates NaN)."""
    P, N, M = _check(gt, est)
    chunk = max(1, PLAIN_CHUNK_ELEMENTS // max(P * N, 1))
    g = gt[:, :, None, :]
    best = None
    for s in range(0, M, chunk):
        e = est[:, None, s:s + chunk, :]
        dx, dy, dz = (g[..., i] - e[..., i] for i in range(3))
        d = (dx * dx + dy * dy + dz * dz).amin(-1)
        best = d if best is None else torch.minimum(best, d)
    return best.clamp_min(0.0)


class MinDistSq:
    """Launches the min-distance kernel (`csrc/min_dist_sq_fwd.cu`).

    `launches` counts kernel launches and nothing else: a run that reads it
    before and after an ADD-S pass learns how many times the evaluator went
    through the kernel."""

    def __init__(self):
        self.launches = 0

    def __call__(self, gt: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
        """Same contract as `min_dist_sq_plain`; CUDA tensors only."""
        P, N, _ = _check(gt, est)
        if gt.device.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {gt.device}")
        gt, est = gt.contiguous(), est.contiguous()
        out = torch.empty((P, N), dtype=torch.float32, device=gt.device)
        if P == 0 or N == 0:
            return out
        lib = NN_LIB.build()
        with device_guard(gt):
            rc = lib.poet_min_dist_sq_fwd(gt.data_ptr(), est.data_ptr(), out.data_ptr(),
                                          P, N, est.shape[1], stream_of(gt))
        NN_LIB.check(rc, "min_dist_sq_fwd")
        self.launches += 1
        return out


MIN_DIST_SQ = MinDistSq()


def min_dist_sq(gt: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """The evaluator's entry: CPU -> plain version, CUDA -> the hand-written
    kernel (which raises on what it does not take)."""
    if gt.device.type == "cpu":
        return min_dist_sq_plain(gt, est)
    return MIN_DIST_SQ(gt, est)
