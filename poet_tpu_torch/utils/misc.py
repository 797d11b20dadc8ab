"""Misc runtime utilities. Counterpart of `poet_tpu/utils/misc.py`.

Parity targets from the reference's util/misc.py: the git state stamp
(:288-305) and the rank gating helpers (:374-427), here on the
`torch.distributed` rank (0 without a process group). JAX's
`inverse_sigmoid` has no counterpart: no path of either package calls it
(the learned reference points are a sigmoid, `models/transformer.py`).
"""

from __future__ import annotations

import os
import subprocess


def get_sha() -> str:
    """Git state stamp. Parity: util/misc.py:288-305."""
    cwd = os.path.dirname(os.path.abspath(__file__))

    def _run(cmd):
        return subprocess.check_output(cmd, cwd=cwd, stderr=subprocess.DEVNULL).decode(
            "ascii").strip()

    sha, diff, branch = "N/A", "clean", "N/A"
    try:
        sha = _run(["git", "rev-parse", "HEAD"])
        diff = _run(["git", "diff-index", "HEAD"])
        diff = "has uncommitted changes" if diff else "clean"
        branch = _run(["git", "rev-parse", "--abbrev-ref", "HEAD"])
    except Exception:
        pass
    return f"sha: {sha}, status: {diff}, branch: {branch}"


def get_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """Parity: util/misc.py:417-422."""
    return get_rank() == 0


def save_on_master(save_fn, *args, **kwargs):
    """Parity: util/misc.py:425-427."""
    if is_main_process():
        return save_fn(*args, **kwargs)
    return None
