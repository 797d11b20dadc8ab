"""Quaternion <-> rotation-matrix conversions, batched. Counterpart of
`poet_tpu/utils/quaternions.py`.

Quaternions are ordered (w, x, y, z). `rot2quat` takes the eigenvector of
the largest eigenvalue of the symmetric K matrix (Bar-Itzhack) and flips it
so that w >= 0. The torch functions run where their inputs lie; the numpy
twins (`quat2rot_np`, `rot2quat_np`) are for host code such as a data
pipeline, in float64.
"""

from __future__ import annotations

import numpy as np
import torch


def quat2rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3, 3), in the reference's 2*(...)-1
    form, which assumes unit norm."""
    q0, q1, q2, q3 = q.unbind(-1)
    rows = [
        [2 * (q0 * q0 + q1 * q1) - 1, 2 * (q1 * q2 - q0 * q3), 2 * (q1 * q3 + q0 * q2)],
        [2 * (q1 * q2 + q0 * q3), 2 * (q0 * q0 + q2 * q2) - 1, 2 * (q2 * q3 - q0 * q1)],
        [2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1), 2 * (q0 * q0 + q3 * q3) - 1],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _k_matrix(m, stack):
    """The symmetric 4x4 K matrix of rotation matrices m (..., 3, 3), / 3."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    rows = [
        [m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12],
        [m01 + m10, m11 - m00 - m22, m12 + m21, m02 - m20],
        [m02 + m20, m12 + m21, m22 - m00 - m11, m10 - m01],
        [m21 - m12, m02 - m20, m10 - m01, m00 + m11 + m22],
    ]
    return stack([stack(r, -1) for r in rows], -2) / 3.0


def rot2quat(rots: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) (w, x, y, z), w >= 0."""
    _, V = torch.linalg.eigh(_k_matrix(rots, lambda xs, d: torch.stack(xs, dim=d)))
    v = V[..., :, -1]                       # eigh sorts ascending: the largest
    q = torch.stack([v[..., 3], v[..., 0], v[..., 1], v[..., 2]], dim=-1)
    return torch.where(q[..., :1] < 0.0, -q, q)


def quat2rot_np(q: np.ndarray) -> np.ndarray:
    """Numpy twin of `quat2rot`, float64."""
    return quat2rot(torch.from_numpy(np.asarray(q, np.float64))).numpy()


def rot2quat_np(rots: np.ndarray) -> np.ndarray:
    """Numpy twin of `rot2quat`, float64."""
    _, V = np.linalg.eigh(_k_matrix(np.asarray(rots, np.float64),
                                    lambda xs, d: np.stack(xs, axis=d)))
    v = V[..., :, -1]
    q = np.stack([v[..., 3], v[..., 0], v[..., 1], v[..., 2]], axis=-1)
    return np.where(q[..., :1] < 0.0, -q, q)


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4) quaternions: the conjugate over the squared norm."""
    conj = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    return conj / (q * q).sum(-1, keepdim=True)


def quat_error(q_pred: torch.Tensor, q_gt: torch.Tensor) -> torch.Tensor:
    """Rotation angle (rad) of q_pred relative to q_gt: 2 atan2(|v|, |w|)
    of q_pred * q_gt^-1."""
    q_err = quat_mult(q_pred, quat_inverse(q_gt))
    v = torch.linalg.vector_norm(q_err[..., 1:], dim=-1)
    return 2.0 * torch.atan2(v, q_err[..., 0].abs())
