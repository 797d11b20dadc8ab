"""Static-shape batch structures. A copy of `poet_tpu/data/structures.py`
(the port imports nothing of `poet_tpu`).

The reference moves per-image variable-length target dicts (lists of tensors)
through the whole stack and pads queries ad-hoc inside the model
(models/pose_estimation_transformer.py:225-236). Here padding happens ONCE
at batch assembly, every downstream array is fixed-size, and validity is
carried as counts/masks. `Targets` is a plain dict of numpy arrays.

Conventions:
  * boxes: (B, Q, 4) cxcywh normalized; dummy rows are [-1, -1, -1, -1]
    (reference dummy-box convention, pose_estimation_transformer.py:226),
  * labels: (B, Q) int32; dummy = -1,
  * n_boxes: (B,) int32 count of real objects per image,
  * relative_position (B, Q, 3), relative_rotation (B, Q, 3, 3),
    relative_quaternions (B, Q, 4), intrinsics (B, Q, 9).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

Targets = Dict[str, Any]

DUMMY_BOX = (-1.0, -1.0, -1.0, -1.0)
DUMMY_LABEL = -1


def pad_targets(
    per_image: List[Dict[str, np.ndarray]],
    num_queries: int,
    with_jitter: bool = False,
) -> Targets:
    """Assemble per-image variable-length targets into one padded batch.

    Host-side (numpy): runs in the input pipeline.

    Each element of `per_image` maps:
      boxes (n, 4) cxcywh-normalized, labels (n,), relative_position (n, 3),
      relative_rotation (n, 3, 3), relative_quaternions (n, 4) [optional],
      intrinsics (n, 9) [optional], jitter_boxes (n, 4) [optional],
      image_id scalar [optional].
    """
    B, Q = len(per_image), num_queries

    def field(name, shape, fill=0.0, dtype=np.float32):
        out = np.full((B, Q) + shape, fill, dtype=dtype)
        for b, t in enumerate(per_image):
            if name in t and t[name] is not None and len(t[name]) > 0:
                n = min(len(t[name]), Q)
                out[b, :n] = np.asarray(t[name], dtype=dtype).reshape((-1,) + shape)[:n]
        return out

    batch: Targets = {
        "boxes": field("boxes", (4,), fill=-1.0),
        "labels": field("labels", (), fill=DUMMY_LABEL, dtype=np.int32),
        "relative_position": field("relative_position", (3,)),
        "relative_rotation": field("relative_rotation", (3, 3)),
        "n_boxes": np.asarray(
            [min(len(t.get("boxes", [])), Q) for t in per_image], dtype=np.int32
        ),
    }
    if any("relative_quaternions" in t for t in per_image):
        batch["relative_quaternions"] = field("relative_quaternions", (4,))
    if any("intrinsics" in t for t in per_image):
        batch["intrinsics"] = field("intrinsics", (9,))
    if with_jitter:
        batch["jitter_boxes"] = field("jitter_boxes", (4,), fill=-1.0)
    if any("image_id" in t for t in per_image):
        batch["image_id"] = np.asarray([int(t.get("image_id", -1)) for t in per_image], dtype=np.int64)
    return batch
