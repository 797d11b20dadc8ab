"""The port's data-parallel helpers (`parallel/mesh.py`, `parallel/zero.py`)
and the loader's process shards, on the CPU in this process.

* the loader's shards over 2 and 3 processes against `poet_tpu`'s loader
  (contiguous chunks of the epoch's indices, padded to divide): together
  they cover the epoch, each equal to JAX's;
* `data_axis_size`: -1 or the number of processes; another number raises
  with the torchrun line that starts it;
* `local_device`, `init_distributed` (nothing without `WORLD_SIZE`, a group
  that exists kept), `collective_device` (the card under NCCL, the CPU
  under gloo), `any_process`;
* the metric sync through a one-process gloo group (the reference syncs
  whenever a group exists); the same under NCCL on the card:
  tests/test_torch_card.py and chip_smoke.py phase 26;
* ZeRO-1's partition: every process at most total / W + the largest tensor.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,count", [(10, 2), (11, 2), (7, 3), (1, 2)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_shards_match_jax(n, count, shuffle):
    from poet_tpu.data.loader import PoseDataLoader as JLoader

    from poet_tpu_torch.data.loader import PoseDataLoader

    got = []
    for r in range(count):
        kw = dict(batch_size=2, num_queries=4, shuffle=shuffle, seed=9, process_index=r,
                  process_count=count)
        mine = PoseDataLoader(_Sized(n), **kw)._epoch_indices(3).tolist()
        assert mine == JLoader(_Sized(n), **kw)._epoch_indices(3).tolist()
        got += mine
    assert set(got) == set(range(n)) and len(got) == -(-n // count) * count


def test_data_axis_size_in_one_process():
    from poet_tpu_torch.parallel.mesh import data_axis_size

    assert data_axis_size(-1, 16, 16) == data_axis_size(1, 3, 5) == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4 .*--mesh_data 4"):
        data_axis_size(4, 16, 16)


def test_local_device(monkeypatch):
    from poet_tpu_torch.parallel.mesh import local_device

    monkeypatch.setenv("LOCAL_RANK", "3")
    assert local_device("cuda") == torch.device("cuda", 3)
    assert local_device("cuda:1") == torch.device("cuda", 1)
    assert local_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert local_device("cuda") == torch.device("cuda", 0)


def test_init_distributed_without_torchrun(monkeypatch):
    from poet_tpu_torch.parallel import mesh
    from poet_tpu_torch.utils.misc import get_rank

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not mesh.init_distributed("cpu") and not mesh.is_distributed()
    assert (mesh.world_size(), get_rank()) == (1, 0)
    assert mesh.any_process(True) and not mesh.any_process(False)


def test_collective_device_under_nccl(monkeypatch):
    """NCCL refuses CPU tensors: a host value is reduced on the current card."""
    from poet_tpu_torch.parallel.mesh import collective_device

    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert collective_device() == torch.device("cuda", 2)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    assert collective_device() == torch.device("cpu")


@pytest.fixture
def gloo_group(monkeypatch):
    """A one-process gloo group, the way torchrun describes one."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    dist.init_process_group("gloo", init_method="env://")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_metric_sync_and_an_existing_group(gloo_group, monkeypatch):
    from poet_tpu_torch.engine.metrics import SmoothedValue
    from poet_tpu_torch.parallel import mesh

    monkeypatch.setenv("WORLD_SIZE", "2")       # a group exists: it is kept, not joined again
    assert not mesh.init_distributed("cpu") and dist.get_world_size() == 1
    seen = []
    reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: (seen.append(t.device),
                                                                reduce(t, *a, **k))[1])
    v = SmoothedValue()
    for x in (1.0, 2.5, 4.0):
        v.update(x, n=2)
    v.synchronize_between_processes()
    assert (v.count, v.total, seen) == (6, 15.0, [torch.device("cpu")])
    assert mesh.is_distributed() and mesh.world_size() == 1
    assert mesh.any_process(True) and not mesh.any_process(False)


def test_zero_partition_bound():
    from poet_tpu_torch.parallel.zero import partition

    rng = np.random.default_rng(0)
    for n in (2, 3, 4, 7):
        params = [torch.empty(int(k)) for k in rng.integers(1, 5000, 40)] + [torch.empty(9000)]
        owner = partition(params, n)
        loads = [sum(p.numel() for p, o in zip(params, owner) if o == r) for r in range(n)]
        total, largest = sum(loads), max(p.numel() for p in params)
        assert max(loads) <= total / n + largest and min(loads) > 0
        assert owner == partition(params, n)             # the same on every process
