"""The control on the card: the plain reference in the precision below the
configuration's (fp8 operands and activations for bf16), put in the
program's place at the cell's own size, must come out not correct against
the cell's limits, on three seeds. Marker `card`; on the card:

    python3 -m pytest --noconftest -m card portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.lib import manifest  # noqa: E402

SEEDS = (2900000011, 2900000012, 2900000013)


@pytest.fixture
def device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.manifest()["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(device, cell, seed):
    from portbench import calibrate
    from portbench.lib import checks

    w = manifest.workload(cell)
    conf, traffic = manifest.Config(w["config"]), manifest.traffic(w["traffic"])
    read = calibrate.control_readings(conf, traffic, seed, device)
    assert not checks.judge(read, manifest.limits(cell)), read
