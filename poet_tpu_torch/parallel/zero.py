"""ZeRO-1 optimizer-state sharding over the data-parallel processes, behind
`--zero_opt_state`. Counterpart of `poet_tpu/parallel/zero.py`.

AdamW keeps two moments per trained parameter (SGD one momentum), on every
card when replicated. ZeRO stage 1 keeps each trained tensor's state on one
process only; the parameters stay replicated, so the forward and backward
are unchanged. JAX places the moment leaves with a 'data'-sharded
NamedSharding and lets GSPMD emit the collectives; here the partition is
explicit, under the port's `Optimizer` (`engine/train.py`):

  * `partition`: each trained tensor goes, largest first, to the process
    holding the fewest state bytes so far, so no process holds more than
    total / W plus the largest tensor;
  * the torch optimizer (AdamW, SGD or `AdamWMuBf16`, the bf16 first
    moment) is built over this process's share of each param group (the
    multi_transform labels and their rates kept); the accumulation
    (MultiSteps), the clip over every gradient and `grad_norm` run before,
    on the summed gradients, which every process holds whole;
  * after its update each process broadcasts its share of the parameters
    (one flat buffer per process), so every replica is the same again;
  * `state_dict()` consolidates: the shares are gathered to rank 0 and
    merged into the torch optimizer's usual layout (state by global index,
    param_groups with global indices), the one a plain `Optimizer` writes;
    `load_state_dict` takes that layout and keeps this process's share. So a
    checkpoint written under ZeRO resumes without it, and the other way
    round;
  * `opt_state_bytes_per_device` is the diagnostic of JAX's module: the
    bytes of optimizer state this process holds.

Under a model's layout (`parallel/tp.py`) each (seq, model) position's
state, over its own tensor-parallel shards, is partitioned over its 'data'
group, and every broadcast and gather runs within that group: JAX's
`init_zero1_opt_state_tp` (`poet_tpu/parallel/zero.py:94-106`). The
consolidated state is then gathered over 'model' into the one-process
layout (`engine/train.py:Optimizer.state_dict`).

Over one data slot `engine/train.py:make_optimizer` builds the plain
`Optimizer`: ZeRO is then a no-op, as JAX's `mesh.shape["data"] > 1` guard
makes it.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from poet_tpu_torch.engine.train import Optimizer
from poet_tpu_torch.parallel.tp import layout_of


def partition(params: List[torch.Tensor], n: int) -> List[int]:
    """The owning process of each tensor: largest first (ties by position)
    to the process with the fewest bytes so far (ties to the lowest rank)."""
    owner = [0] * len(params)
    load = [0] * n
    for i in sorted(range(len(params)), key=lambda i: (-params[i].numel(), i)):
        r = min(range(n), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += params[i].numel() * params[i].element_size()
    return owner


class ZeroOptimizer(Optimizer):
    """`Optimizer` with its state partitioned over the data slots (ZeRO-1)."""

    def __init__(self, cfg, model, steps_per_epoch: int):
        layout = layout_of(model)
        self.world, self.rank, self.group = layout.n_data, layout.data_index, layout.data_group
        super().__init__(cfg, model, steps_per_epoch)

    def _global_rank(self, r: int) -> int:
        """The global rank of data slot `r` of this process's data group."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _owned_groups(self) -> List[Dict]:
        self.owner = dict(zip(map(id, self.params), partition(self.params, self.world)))
        return [{**g, "params": [p for p in g["params"] if self.owner[id(p)] == self.rank]}
                for g in self.param_groups]

    @torch.no_grad()
    def _update(self) -> None:
        self.torch_opt.step()
        for r in range(self.world):
            share = [p for p in self.params if self.owner[id(p)] == r]
            if not share:
                continue
            flat = _flatten_dense_tensors([p.data for p in share])
            dist.broadcast(flat, src=self._global_rank(r), group=self.group)
            if r != self.rank:
                for p, v in zip(share, _unflatten_dense_tensors(flat, share)):
                    p.data.copy_(v)

    def _global_index(self) -> Dict[int, int]:
        """id(param) -> its index in a plain optimizer's state_dict."""
        return {id(p): i for i, p in enumerate(self.params)}

    def _torch_state(self):
        """The consolidated torch state on data slot 0 (None elsewhere); a
        collective over 'data': every process calls it."""
        local = self.torch_opt.state_dict()
        index = self._global_index()
        local_params = [p for g in self.torch_opt.param_groups for p in g["params"]]
        share = {index[id(p)]: {k: v.cpu() if torch.is_tensor(v) else v
                                for k, v in local["state"][i].items()}
                 for i, p in enumerate(local_params) if i in local["state"]}
        shares = [None] * self.world if self.rank == 0 else None
        dist.gather_object(share, shares, dst=self._global_rank(0), group=self.group)
        if self.rank != 0:
            return None
        state = {}
        for s in shares:
            state.update(s)
        groups = []
        for g, lg in zip(self.param_groups, local["param_groups"]):
            groups.append({**{k: v for k, v in lg.items() if k != "params"},
                           "params": [index[id(p)] for p in g["params"]]})
        return {"state": dict(sorted(state.items())), "param_groups": groups}

    def _load_torch_state(self, state: Dict) -> None:
        """Keep this process's share of a plain optimizer's state_dict."""
        index = self._global_index()
        groups, local_state, n = [], {}, 0
        for saved, mine in zip(state["param_groups"], self.torch_opt.param_groups):
            ids = []
            for p in mine["params"]:
                if index[id(p)] in state["state"]:
                    local_state[n] = state["state"][index[id(p)]]
                ids.append(n)
                n += 1
            groups.append({**{k: v for k, v in saved.items() if k != "params"}, "params": ids})
        self.torch_opt.load_state_dict({"state": local_state, "param_groups": groups})


def opt_state_bytes_per_device(optimizer: Optimizer) -> int:
    """Bytes of optimizer state (moments, momenta) this process holds."""
    return sum(v.numel() * v.element_size() for st in optimizer.torch_opt.state.values()
               for v in st.values() if torch.is_tensor(v))
