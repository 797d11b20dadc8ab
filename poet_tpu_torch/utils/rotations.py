"""SO(3) math. Counterpart of `poet_tpu/utils/rotations.py`: 6D decoding
(`:17-35`) and the log map the aleatoric rotation loss needs (`:51-126`),
branch-free with gradient-safe denominators as in the JAX package."""

from __future__ import annotations

import math

import torch


def rotation_6d_to_matrix(rot_6d: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3) via Gram–Schmidt (Zhou et al., CVPR'19).

    Columns are [x, y, z] with x = norm(m1), z = norm(x × m2), y = z × x.
    """
    m1 = rot_6d[..., 0:3]
    m2 = rot_6d[..., 3:6]
    x = _l2_normalize(m1)
    z = _l2_normalize(torch.linalg.cross(x, m2, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """v / max(||v||, eps), as torch.nn.functional.normalize."""
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def hat_inv(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew-symmetric -> (..., 3); callers own skew-symmetry."""
    return torch.stack([h[..., 2, 1], h[..., 0, 2], h[..., 1, 0]], dim=-1)


def _acos_linear_approx(x: torch.Tensor, x0: float) -> torch.Tensor:
    return (x - x0) * (-1.0 / math.sqrt(1.0 - x0 * x0)) + math.acos(x0)


def acos_linear_extrapolation(x: torch.Tensor,
                              bounds=(-1.0 + 1e-4, 1.0 - 1e-4)) -> torch.Tensor:
    """acos inside `bounds`, its tangent line outside (finite gradients)."""
    lower, upper = bounds
    inside = torch.arccos(torch.clamp(x, lower, upper))
    below = _acos_linear_approx(x, lower)
    above = _acos_linear_approx(x, upper)
    return torch.where(x <= lower, below, torch.where(x >= upper, above, inside))


def so3_rotation_angle(R: torch.Tensor, eps: float = 1e-4, cos_angle: bool = False,
                       cos_bound: float = 1e-4) -> torch.Tensor:
    """Rotation angle(s) of (..., 3, 3) matrices; out-of-range traces saturate
    through the acos extrapolation instead of raising."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    phi_cos = (trace - 1.0) * 0.5
    if cos_angle:
        return phi_cos
    if cos_bound > 0.0:
        bound = 1.0 - cos_bound
        return acos_linear_extrapolation(phi_cos, (-bound, bound))
    return torch.arccos(phi_cos)


def so3_log_map(R: torch.Tensor, eps: float = 1e-4, cos_bound: float = 1e-4) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) axis-angle. The tiny-sin Taylor branch
    (0.5 + phi²/12 where |sin phi| <= eps/2) takes a safe denominator so the
    untaken branch gives no NaN gradient."""
    phi = so3_rotation_angle(R, cos_bound=cos_bound, eps=eps)
    phi_sin = torch.sin(phi)
    ok = phi_sin.abs() > (0.5 * eps)
    safe_sin = torch.where(ok, phi_sin, torch.ones_like(phi_sin))
    phi_factor = torch.where(ok, phi / (2.0 * safe_sin), 0.5 + (phi * phi) / 12.0)
    log_rot_hat = phi_factor[..., None, None] * (R - R.transpose(-1, -2))
    return hat_inv(log_rot_hat)
