"""Min-cost assignment (Jonker–Volgenant with potentials), on the host.

Counterpart of `poet_tpu/ops/hungarian.py:hungarian` / `_hungarian_single`
(`:45`): the same shortest-augmenting-path algorithm, step for step, in the
same float32 arithmetic, so that ties break as they do in the JAX solver
(first minimum column, rows assigned in order). A library solver (scipy's)
breaks ties differently.

The JAX package runs the solver inside its jitted step. The port's trainer
matches on the host, from the CPU targets, before the batch goes to the
device (`models/matcher.py`), so this works on CPU tensors, one problem at a
time in numpy float32, looping over the leading dims. Problems are tiny
(n = num_queries).
"""

from __future__ import annotations

import numpy as np
import torch

_INF = np.float32(1e18)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost perfect assignment of square (..., n, n) cost matrices.

    Returns (..., n) int32 `col_of_row` on the CPU: the column assigned to
    each row, minimizing sum_i cost[i, col_of_row[i]].
    """
    c = np.asarray(cost.detach().cpu().float().numpy(), dtype=np.float32)
    n = c.shape[-1]
    flat = c.reshape((-1, n, n))
    out = np.stack([_hungarian_single(m) for m in flat]) if len(flat) else \
        np.zeros((0, n), np.int32)
    return torch.from_numpy(out.reshape(c.shape[:-1]).astype(np.int32))


def _hungarian_single(cost: np.ndarray) -> np.ndarray:
    n = cost.shape[-1]
    # 1-indexed working matrix with a virtual row/col 0
    a = np.zeros((n + 1, n + 1), np.float32)
    a[1:, 1:] = cost
    u = np.zeros(n + 1, np.float32)
    v = np.zeros(n + 1, np.float32)
    p = np.zeros(n + 1, np.int64)          # p[j]: row assigned to column j (0 = none)

    for i in range(1, n + 1):
        p[0] = i
        minv = np.full(n + 1, _INF, np.float32)
        used = np.zeros(n + 1, bool)
        way = np.zeros(n + 1, np.int64)
        j0 = 0
        while p[j0] != 0:
            used[j0] = True
            i0 = p[j0]
            cur = a[i0] - u[i0] - v
            better = ~used & (cur < minv)
            minv = np.where(better, cur, minv)
            way = np.where(better, j0, way)
            masked = np.where(used, _INF, minv)
            j1 = int(np.argmin(masked))       # first minimum, as jnp.argmin
            delta = masked[j1]
            # potentials along the tree; tentative distances shrink
            np.add.at(u, p, np.where(used, delta, np.float32(0)))
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0 = j1
        while j0 != 0:                          # augment back along `way`
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    col_of_row = np.zeros(n, np.int32)
    col_of_row[p[1:] - 1] = np.arange(n, dtype=np.int32)
    return col_of_row
