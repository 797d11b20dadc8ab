"""SO(3) decoding. Counterpart of `poet_tpu/utils/rotations.py:17-35`."""

from __future__ import annotations

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
