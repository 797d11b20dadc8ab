"""Tensor parallelism over attention heads and sequence parallelism over
the encoder's tokens. Counterpart of `poet_tpu/parallel/tp.py`.

JAX expresses both as shardings and lets GSPMD insert the collectives. The
port runs one process per card (`parallel/mesh.py:create_layout`: 'data',
'seq', 'model' process groups) and writes the collectives out, as autograd
Functions on local tensors: the deformable kernels are called through
ctypes on raw pointers (`ops/deform_attn_cuda.py`), so they must see the
process's own shard, never a distributed tensor.

**Tensor parallelism ('model').** `param_spec` applies JAX's `_TP_RULES`
(`poet_tpu/parallel/tp.py:96-117`) to the port's `state_dict` names:
`value_proj`, `sampling_offsets`, `attention_weights` and `linear1` are
split by output (column parallel, head-major), `output_proj`, `linear2` and
the decoder's `self_attn.out_proj` by input (row parallel; their biases
replicated, added once after the reduce), the decoder's packed
`in_proj_weight` / `in_proj_bias` by head inside each of its q, k and v
chunks; everything else is replicated. A process keeps `nheads / n_model`
heads. Its column-parallel inputs pass `copy_to_model` (identity forward,
all-reduce backward), its row-parallel outputs `reduce_from_model`
(all-reduce forward, identity backward): one all-reduce per attention block
and per FFN each way, Megatron's schedule.

**Sequence parallelism ('seq').** The encoder's flattened tokens are padded
to a multiple of `n_seq` (pad tokens: mask True, reference points -10, JAX's
convention at `poet_tpu/models/transformer.py:480-530`, so a pad query reads
nothing and a pad token's value is zero) and split (`SeqShard.split`: slice
forward, all-gather backward). Each encoder layer's value is gathered
before the sampling core (`SeqShard.gather_for_core`: all-gather forward,
reduce-scatter backward: the queries of each process add to every token's
d_value, JAX's psum of the query-partial d_value at
`poet_tpu/ops/deform_attn_pallas_v3.py:1174-1206`); `memory` is gathered once
for the decoder, which runs whole on every process
(`SeqShard.gather`: all-gather forward, slice backward, since each process
holds the whole d_memory). The pad rows are dropped after each gather.

**Dropout.** Every mask is drawn at the full shape of the one-process
model from the caller's generator and sliced to the process's tokens and
columns, so the loss does not depend on the layout (JAX's TP loss equals its
DP loss at dropout 0.1, `tests/test_tensor_parallel.py:40`); every seq and
model process of a data slot starts its generator from the same state.

**Gradients.** With these collectives each process's gradient of a
replicated parameter is the whole one, except the encoder layers' under
'seq': their tokens are split, so their gradients are summed over 'seq'
(`seq_partial`) before the data-parallel sum over 'data'
(`engine/train.py`). The clip's norm and `grad_norm` count each element of
a sharded tensor once (`grad_norm_fn`).

**Collectives on gloo.** Under gloo (the CPU, and two processes on one
card) every collective here runs on a host copy of the tensor (gloo reduces
in host memory either way), and the reduce-scatter is an all-reduce
followed by the process's slice; under NCCL they run on the card.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from poet_tpu_torch.parallel.mesh import Layout, data_layout

# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


class Spec(NamedTuple):
    """How a tensor is split over 'model': along `dim` (None: replicated),
    each of its `chunks` packed blocks along that dim split alike."""

    dim: Optional[int] = None
    chunks: int = 1


# (name regex, spec), first match wins; weights are torch's (out, in)
_TP_RULES = (
    (r"(^|\.)(value_proj|sampling_offsets|attention_weights)\.(weight|bias)$", Spec(0)),
    (r"(^|\.)output_proj\.weight$", Spec(1)),
    (r"(^|\.)linear1\.(weight|bias)$", Spec(0)),
    (r"(^|\.)linear2\.weight$", Spec(1)),
    (r"(^|\.)self_attn\.in_proj_(weight|bias)$", Spec(0, 3)),
    (r"(^|\.)self_attn\.out_proj\.weight$", Spec(1)),
)


def param_spec(name: str) -> Spec:
    """The split of one `state_dict` entry (a dotted name)."""
    for pattern, spec in _TP_RULES:
        if re.search(pattern, name):
            return spec
    return Spec()


def shard_tensor(t: torch.Tensor, spec: Spec, index: int, n: int) -> torch.Tensor:
    """Shard `index` of `n` of a full tensor (a copy)."""
    if spec.dim is None or n == 1:
        return t
    if t.shape[spec.dim] % (spec.chunks * n):
        raise ValueError(f"dim {spec.dim} of {tuple(t.shape)} does not split into "
                         f"{spec.chunks} x {n}")
    blocks = t.unflatten(spec.dim, (spec.chunks, -1))
    part = blocks.chunk(n, dim=spec.dim + 1)[index]
    return part.flatten(spec.dim, spec.dim + 1).clone()


def join_shards(parts: List[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The full tensor from its shards, in model order (inverse of
    `shard_tensor`)."""
    if spec.dim is None or len(parts) == 1:
        return parts[0]
    blocks = [p.unflatten(spec.dim, (spec.chunks, -1)) for p in parts]
    return torch.cat(blocks, dim=spec.dim + 1).flatten(spec.dim, spec.dim + 1)


def layout_of(model: nn.Module) -> Layout:
    """The layout `shard_module` gave the model, else the data-only one."""
    return getattr(model, "layout", None) or data_layout()


def sharded(layout: Optional[Layout], name: str) -> bool:
    """Whether a process holds a shard of `name` (not the whole tensor)."""
    return layout is not None and layout.n_model > 1 and param_spec(name).dim is not None


@torch.no_grad()
def shard_module(model: nn.Module, layout: Layout) -> nn.Module:
    """Apply `layout` to a full model, in place: every split parameter is
    cut to this process's shard (and a Dense's bias init with it), each
    attention module keeps its local heads, and every layout-aware module
    (`layout` attribute: the deformable transformer, its layers, MSDeformAttn,
    MultiheadAttention) and the model itself learn the layout. Raises where a
    head count or an FFN width does not divide by the model axis."""
    from poet_tpu_torch.models.transformer import MSDeformAttn, MultiheadAttention

    n, m = layout.n_model, layout.model_index
    if n > 1:
        for mod in model.modules():
            heads = (mod.n_heads if isinstance(mod, MSDeformAttn)
                     else mod.num_heads if isinstance(mod, MultiheadAttention) else n)
            if heads % n:
                raise ValueError(f"{heads} heads do not split over {n} model processes")
        for name, p in model.named_parameters():
            spec = param_spec(name)
            if spec.dim is not None:
                p.data = shard_tensor(p.data, spec, m, n)
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Linear):
                mod.out_features, mod.in_features = mod.weight.shape
                bias_init = getattr(mod, "bias_init", None)
                spec = param_spec(f"{name}.bias")
                if bias_init is not None and spec.dim is not None:
                    mod.bias_init = shard_tensor(torch.as_tensor(bias_init), spec, m, n).numpy()
            if isinstance(mod, MSDeformAttn):
                mod.n_heads //= n
            elif isinstance(mod, MultiheadAttention):
                mod.num_heads //= n
    for mod in model.modules():
        if hasattr(mod, "layout"):
            mod.layout = layout
    model.layout = layout
    return model


def shard_state_dict(state: Dict[str, torch.Tensor], layout: Layout) -> Dict[str, torch.Tensor]:
    """A full `state_dict` cut to this process's shards (to load into a
    sharded model)."""
    return {k: shard_tensor(v, param_spec(k), layout.model_index, layout.n_model)
            for k, v in state.items()}


def gather_tensor(t: torch.Tensor, name: str, layout: Optional[Layout]) -> torch.Tensor:
    """The full tensor of `name` from every model process's shard (a
    collective over 'model'), on the CPU; a replicated tensor as it is."""
    if not sharded(layout, name):
        return t.detach().cpu()
    parts = _all_gather(t.detach().contiguous(), layout.model_group, layout.n_model)
    return join_shards([p.cpu() for p in parts], param_spec(name))


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full `state_dict` on the CPU, on every process (a
    collective over 'model' for a sharded model): checkpoints, tests."""
    layout = getattr(model, "layout", None)
    return {k: gather_tensor(v, k, layout) for k, v in model.state_dict().items()}


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor]) -> nn.Module:
    """Load a full `state_dict` (a checkpoint's) into a model, sharded or not."""
    layout = getattr(model, "layout", None)
    model.load_state_dict(state if layout is None else shard_state_dict(state, layout))
    return model


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _through_host(t: torch.Tensor) -> bool:
    """gloo reduces in host memory: its collectives get a host copy."""
    return dist.get_backend() == "gloo" and t.device.type != "cpu"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of a tensor over `group` (a new tensor)."""
    if _through_host(t):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        return host.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(t: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    """Every process's `t` (same shape on each), in group rank order."""
    src = t.detach().cpu() if _through_host(t) else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def _reduce_scatter(t: torch.Tensor, group, n: int, index: int, dim: int) -> torch.Tensor:
    """The sum over `group` of `t`, chunk `index` of `n` along `dim`. Under
    gloo an all-reduce then this process's slice; under NCCL one
    reduce_scatter on the card."""
    if dist.get_backend() == "gloo":
        return all_reduce(t, group).chunk(n, dim=dim)[index].contiguous()
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.layout.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        return all_reduce(x, layout.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The input of a column-parallel projection: identity forward, the
    gradient summed over 'model' backward."""
    if layout is None or layout.n_model == 1:
        return x
    return _CopyToModel.apply(x, layout)


def reduce_from_model(x: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The output of a row-parallel projection: summed over 'model' forward,
    identity backward."""
    if layout is None or layout.n_model == 1:
        return x
    return _ReduceFromModel.apply(x, layout)


def row_parallel(dense: nn.Module, x: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """`dense(x)` for a row-parallel `models/layers.py:Dense`: the local
    product summed over 'model', then the (replicated) bias once."""
    if layout is None or layout.n_model == 1:
        return dense(x)
    dt = dense.compute_dtype
    y = nn.functional.linear(x.to(dt), dense.weight.to(dt))
    return reduce_from_model(y, layout) + dense.bias.to(dt)


def column_slice(layout: Optional[Layout], width: int) -> Optional[slice]:
    """This process's columns of a column-parallel activation of local
    `width` within the full one, or None without a model axis."""
    if layout is None or layout.n_model == 1:
        return None
    return slice(layout.model_index * width, (layout.model_index + 1) * width)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """This process's share of the encoder's S tokens, padded to S_pad (a
    multiple of n_seq): tokens [start, stop) of the padded axis (dim 1)."""

    layout: Layout
    S: int
    S_pad: int
    start: int
    stop: int

    def pad(self, x: torch.Tensor, value=0) -> torch.Tensor:
        """x (B, S, ...) padded to S_pad tokens with `value`."""
        if self.S_pad == self.S:
            return x
        tail = x.new_full((x.shape[0], self.S_pad - self.S) + tuple(x.shape[2:]), value)
        return torch.cat([x, tail], dim=1)

    def local(self, x: torch.Tensor, value=0) -> torch.Tensor:
        """This process's tokens of a full (B, S, ...) tensor, no autograd
        collective (masks, reference points, dropout masks)."""
        return self.pad(x, value)[:, self.start:self.stop]

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """This process's tokens of a full activation; backward: the
        gradients of every process's tokens gathered."""
        return _SeqSplit.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full (B, S, ...) activation from every process's tokens, for
        consumers that run whole on every process (the decoder's memory);
        backward: this process's tokens of the (whole) gradient."""
        return _SeqGather.apply(x, self, False)

    def gather_for_core(self, x: torch.Tensor) -> torch.Tensor:
        """As `gather`, for the sampling core's value: each process's queries
        add to every token's gradient, so the backward sums the processes'
        gradients and keeps this process's tokens (reduce-scatter)."""
        return _SeqGather.apply(x, self, True)


def seq_shard(layout: Optional[Layout], S: int) -> Optional[SeqShard]:
    """The SeqShard of S tokens under `layout`, None without a seq axis."""
    if layout is None or layout.n_seq == 1:
        return None
    n = layout.n_seq
    S_pad = -(-S // n) * n
    per = S_pad // n
    return SeqShard(layout, S, S_pad, layout.seq_index * per, (layout.seq_index + 1) * per)


class _SeqSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        # a copy: at B = 1 the slice would be a contiguous view of the input
        return seq.local(x).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        seq = ctx.seq
        parts = _all_gather(g.contiguous(), seq.layout.seq_group, seq.layout.n_seq)
        return torch.cat(parts, dim=1)[:, :seq.S], None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq, partial):
        ctx.seq, ctx.partial = seq, partial
        parts = _all_gather(x.contiguous(), seq.layout.seq_group, seq.layout.n_seq)
        return torch.cat(parts, dim=1)[:, :seq.S]

    @staticmethod
    def backward(ctx, g):
        seq = ctx.seq
        full = seq.pad(g.contiguous())
        if not ctx.partial:
            return full[:, seq.start:seq.stop].contiguous(), None, None
        return (_reduce_scatter(full, seq.layout.seq_group, seq.layout.n_seq,
                                seq.layout.seq_index, dim=1), None, None)


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def seq_partial(name: str) -> bool:
    """Whether a parameter's gradient is partial over 'seq' (the encoder
    layers run on this process's tokens only)."""
    return bool(re.search(r"(^|\.)encoder\.layers\.", name))


def grad_norm_fn(layout: Layout, names: List[str]) -> Callable[[List[torch.Tensor]], torch.Tensor]:
    """norm(grads) over the parameters `names` (in that order), counting
    each element once: a sharded tensor's squares summed over 'model', a
    replicated one's taken once. Without a model axis: `engine/train.py:
    global_norm`."""
    from poet_tpu_torch.engine.train import global_norm

    if layout.n_model == 1:
        return global_norm
    is_sharded = [sharded(layout, n) for n in names]

    def squares(ts: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        if not ts:
            return like.new_zeros(())
        return torch.stack(torch._foreach_norm(ts)).float().square().sum()

    def norm(grads: List[torch.Tensor]) -> torch.Tensor:
        split = [g for g, s in zip(grads, is_sharded) if s]
        whole = [g for g, s in zip(grads, is_sharded) if not s]
        local = squares(split, grads[0].float())
        return torch.sqrt(squares(whole, grads[0].float())
                          + all_reduce(local, layout.model_group))

    return norm


def gather_optimizer_state(state: Optional[Dict], names: List[str],
                           layout: Layout) -> Optional[Dict]:
    """A torch optimizer state_dict over this process's shards -> the full
    one: each per-parameter tensor of a sharded parameter (index i ->
    names[i]) gathered over 'model'. A collective over 'model'; None (a
    process that holds no consolidated state: ZeRO's other data slots) stays
    None, as on every process of its model group."""
    if state is None or layout.n_model == 1:
        return state
    out = {}
    for i, st in sorted(state["state"].items()):
        out[i] = {k: gather_tensor(v, names[i], layout)
                  if torch.is_tensor(v) and v.dim() > 0 else v for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def shard_optimizer_state(state: Dict, names: List[str], layout: Layout) -> Dict:
    """The inverse of `gather_optimizer_state`: a full optimizer state cut
    to this process's shards."""
    if layout.n_model == 1:
        return state
    out = {}
    for i, st in state["state"].items():
        spec = param_spec(names[i])
        out[i] = {k: shard_tensor(v, spec, layout.model_index, layout.n_model)
                  if torch.is_tensor(v) and v.dim() > 0 else v for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def shard_array(name: str, arr: np.ndarray, layout: Optional[Layout]) -> np.ndarray:
    """A full numpy parameter cut to this process's shard of `name`."""
    if not sharded(layout, name):
        return arr
    return shard_tensor(torch.from_numpy(np.ascontiguousarray(arr)), param_spec(name),
                        layout.model_index, layout.n_model).numpy()
