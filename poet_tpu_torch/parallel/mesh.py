"""Data parallelism over processes, one card each. Counterpart of
`poet_tpu/parallel/mesh.py` and the rendezvous of `poet_tpu/cli.py:280-301`.

JAX builds one mesh with a 'data' axis over every device and lets the
compiler emit the gradient psum. The port runs the reference's layout
instead: one process per card, started by `torchrun --nproc_per_node N`,
joined in a `torch.distributed` process group, with the collectives written
out (`engine/train.py`: the matched count and the gradients; `parallel/zero.py`:
the ZeRO-1 parameter broadcast; `engine/evaluate.py`: the pose pairs).

**Batch semantics.** Each process loads `--batch_size` images of its own
shard of the epoch (`data/loader.py`: contiguous chunks of the shuffled
indices, DistributedSampler's split); the global batch is
`batch_size x world_size`. That is JAX's multi-process rule (each process
holds its local batch, `poet_tpu/parallel/mesh.py:43-52`) and the
reference's DDP rule. The loss divides by the global matched count, so one
step over W processes computes the gradient of one step over the
concatenated global batch.

  * `init_distributed` joins the group torchrun describes (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) when
    `WORLD_SIZE` > 1: NCCL on the card, gloo on the CPU. A group that exists
    already is used as it is, so a caller (a test, `chip_smoke.py`) can make
    its own, e.g. gloo over CUDA tensors on one card;
  * `world_size` (the rank: `utils/misc.py:get_rank`), `local_device`:
    `cuda:LOCAL_RANK` for 'cuda', the CPU for 'cpu';
  * `data_axis_size`: `--mesh_data` against the processes started, with
    JAX's gcd rule on the global batch sizes (`poet_tpu/cli.py:298-301`);
  * `replicate`: parameters and buffers broadcast from rank 0;
  * `collective_device`: where a host value is reduced (the card under
    NCCL, which refuses CPU tensors; the CPU under gloo);
  * `any_process`: a flag set on any process, for decisions that every
    process must take at the same step (the SIGTERM checkpoint), reduced on
    the CPU through a gloo group (the default one under gloo, a second one
    under NCCL), so the train loop never waits for the card for it;
  * `Layout`, `create_layout`: the ('data', 'seq', 'model') layout of
    `poet_tpu/parallel/tp.py:create_mesh_3d` over the processes, one process
    group per axis; `data_layout` is the data-only layout above (every
    process a data slot), which a model without a layout trains under.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional

import torch
import torch.distributed as dist


def is_distributed() -> bool:
    """A process group is initialized (of any size: over one process the
    collectives are sums over one, as under the reference's DDP)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The processes of the group, 1 without one (the rank:
    `utils/misc.py:get_rank`)."""
    return dist.get_world_size() if is_distributed() else 1


def local_device(name: str) -> torch.device:
    """The device of this process: `cuda:LOCAL_RANK` for 'cuda', else `name`."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_distributed(device: str) -> bool:
    """Join torchrun's process group when `WORLD_SIZE` > 1 (NCCL for a
    'cuda' device, gloo for 'cpu'); keep a group that exists. Returns
    whether more than one process takes part."""
    if is_distributed():
        return world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device(device))
        dist.init_process_group("nccl", init_method="env://",
                                device_id=local_device(device))
    else:
        dist.init_process_group("gloo", init_method="env://")
    return world_size() > 1


def data_axis_size(mesh_data: int, batch_size: int, eval_batch_size: int) -> int:
    """The processes on the data axis: `mesh_data` (-1: all of them), shrunk
    to the gcd of the global train and eval batches as JAX shrinks its mesh.
    Under per-process batches the global batches are multiples of the
    process count, so nothing shrinks; a `mesh_data` other than the number of
    processes started raises, since a process cannot be left out of the
    group it joined."""
    n = world_size()
    wanted = n if mesh_data == -1 else mesh_data
    if wanted != n:
        raise ValueError(
            f"--mesh_data {mesh_data}: {n} process{'es' if n > 1 else ''} started. The port "
            f"runs one process per card: launch `torchrun --nproc_per_node {wanted} -m "
            f"poet_tpu_torch.cli --mesh_data {wanted} ...` (or pass --mesh_data -1)")
    return math.gcd(wanted, math.gcd(batch_size * n, eval_batch_size * n))


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer broadcast from rank 0 (in place), one flat
    buffer per dtype, through `collective_device()` (a module on the CPU
    under NCCL goes through the card)."""
    if is_distributed():
        from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

        tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            group = [t for t in tensors if t.dtype == dtype]
            flat = _flatten_dense_tensors(group).to(collective_device())
            dist.broadcast(flat, src=0)
            for t, v in zip(group, _unflatten_dense_tensors(flat, group)):
                t.copy_(v)
    return module


def collective_device() -> torch.device:
    """Where a host value is reduced: the current card under NCCL, the CPU
    otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_host_group = None


def any_process(flag: bool) -> bool:
    """True on every process when `flag` is True on any of them (a
    collective: every process calls it at the same point)."""
    global _host_group
    if not is_distributed():
        return flag
    if dist.get_backend() != "gloo" and _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX,
                    group=_host_group if dist.get_backend() != "gloo" else None)
    return bool(t.item())


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """A ('data', 'seq', 'model') layout of the processes: batch over
    'data', the encoder's tokens over 'seq' (sequence parallelism), the
    attention heads and FFN columns over 'model' (tensor parallelism,
    `parallel/tp.py`). Ranks are numbered as JAX's reshape of the device list
    numbers the mesh, 'model' minor: rank = (d * n_seq + s) * n_model + m.
    Each axis of more than one process has its process group (None: the
    default group, where the axis spans every process); a size-1 axis has
    none and no collective runs over it."""

    n_data: int
    n_seq: int = 1
    n_model: int = 1
    data_index: int = 0
    seq_index: int = 0
    model_index: int = 0
    data_group: Any = None
    seq_group: Any = None
    model_group: Any = None

    def __deepcopy__(self, memo):          # a copied model keeps its process groups
        return self

    @property
    def data_collective(self) -> bool:
        """Whether the train step reduces over 'data': more than one data
        slot, or the data-only layout of any size (a one-process group still
        runs its collectives, as the data-parallel step always has)."""
        return is_distributed() and (self.n_data > 1 or self.n_seq * self.n_model == 1)


def data_layout() -> Layout:
    """The data-only layout: every process a data slot, the default group."""
    from poet_tpu_torch.utils.misc import get_rank

    return Layout(n_data=world_size(), data_index=get_rank())


def create_layout(n_data: int = -1, n_seq: int = 1, n_model: int = 1,
                  nheads: Optional[int] = None,
                  dim_feedforward: Optional[int] = None) -> Layout:
    """The 3-D layout over the processes of the group (a collective: every
    process calls it with the same sizes). `n_data` = -1 takes the processes
    left after 'seq' and 'model'. Raises where the sizes do not multiply to
    the processes started, or where `nheads` or `dim_feedforward` (when
    given) do not divide by `n_model` (JAX's tp.py requires the same)."""
    from poet_tpu_torch.utils.misc import get_rank

    n = world_size()
    if n_seq < 1 or n_model < 1 or n % (n_seq * n_model):
        raise ValueError(f"seq {n_seq} x model {n_model} does not divide {n} processes")
    if n_data == -1:
        n_data = n // (n_seq * n_model)
    if n_data * n_seq * n_model != n:
        raise ValueError(f"data {n_data} x seq {n_seq} x model {n_model} != {n} processes "
                         "started: a process cannot be left out of the group it joined")
    for name, size in (("nheads", nheads), ("dim_feedforward", dim_feedforward)):
        if size is not None and size % n_model:
            raise ValueError(f"{name} {size} does not divide by the model axis {n_model}")
    rank = get_rank()
    d, rest = divmod(rank, n_seq * n_model)
    s, m = divmod(rest, n_model)

    def rank_of(d, s, m):
        return (d * n_seq + s) * n_model + m

    def axis_group(size, ranks_of):
        """This process's group along an axis; every process creates every
        group of the axis, in the same order, as new_group requires."""
        if size == 1:
            return None
        if size == n:
            return None                   # the default group
        mine = None
        for ranks in ranks_of():
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    groups = {
        "data_group": axis_group(n_data, lambda: ([rank_of(i, j, k) for i in range(n_data)]
                                                  for j in range(n_seq) for k in range(n_model))),
        "seq_group": axis_group(n_seq, lambda: ([rank_of(i, j, k) for j in range(n_seq)]
                                                for i in range(n_data) for k in range(n_model))),
        "model_group": axis_group(n_model, lambda: ([rank_of(i, j, k) for k in range(n_model)]
                                                    for i in range(n_data) for j in range(n_seq))),
    }
    return Layout(n_data, n_seq, n_model, d, s, m, **groups)
