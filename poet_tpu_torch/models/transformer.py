"""Deformable transformer. Counterpart of `poet_tpu/models/transformer.py`.

Tokens are channels-last (B, S, C) with static per-level shapes. The
sampling core of the encoder's self-attention and the decoder's
cross-attention is chosen as in JAX, by `impl` (the config's
`enc_deform_impl` / `dec_deform_impl`, JAX's names): 'pallas' selects the
dense one-hot kernels (`ops/deform_attn_dense_cuda.py`), every other value
the gather kernels (`ops/deform_attn_cuda.py`), whose backward
`merged_adjoint` picks (`config.DEFORM_IMPLS`). Both routes compute the
same function with the same parameters, so a JAX tree built with any impl
loads unchanged. The port pads nothing: JAX's token and query padding to
its kernels' 128-query tiles exists for the TPU only.

Sampling offsets, attention logits, reference points and locations stay f32
at any compute dtype. Dropout follows flax's (`poet_tpu/models/transformer.py:
277-284` encoder, `:308-333` decoder): active only in `train()` mode, at the
layer's `dropout` rate, with masks drawn from the `torch.Generator` that the
caller passes to `forward` (the trainer owns it), never from the global RNG.
Submodule names follow the reference checkpoint
(`transformer.encoder.layers.{i}.self_attn.value_proj`, ...).

Under a multi-process layout (`parallel/tp.py:shard_module` sets each
module's `layout`) the attention modules run on their local heads with the
row-parallel projections reduced over 'model', and the encoder runs on this
process's share of the tokens ('seq'); every dropout mask is drawn at the
one-process model's shape and sliced (`parallel/tp.py`). Without a layout
nothing changes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from poet_tpu_torch.config import deform_route
from poet_tpu_torch.models.layers import Dense, LayerNorm, variance_scaling_
from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn
from poet_tpu_torch.ops.deform_attn_dense_cuda import ms_deform_attn_dense
from poet_tpu_torch.parallel import tp
from poet_tpu_torch.parallel.mesh import Layout


def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python number: jnp rounds a weakly
    typed scalar to the array's dtype. (A CUDA scalar tensor instead would
    cost a host-to-device copy and a sync per call.)"""
    return torch.tensor(value, dtype=dtype).item()


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            seq: Optional[tp.SeqShard] = None, cols: Optional[Layout] = None) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, kept values divided
    by the keep probability in x's dtype, the mask drawn from `generator`.
    Where x holds this process's tokens (`seq`) or its last-dim columns of a
    column-parallel activation (`cols`: the layout) of the one-process
    activation, the mask is drawn at that full shape and sliced, so every
    layout draws the same masks and the generator advances as in one
    process."""
    keep = 1.0 - rate
    shape = list(x.shape)
    part = tp.column_slice(cols, x.shape[-1])
    if seq is not None:
        shape[1] = seq.S
    if part is not None:
        shape[-1] = x.shape[-1] * cols.n_model
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if seq is not None:
        mask = seq.local(mask, False)
    if part is not None:
        mask = mask[..., part]
    return torch.where(mask, x / _rounded(keep, x.dtype), x.new_zeros(()))


class _Dropout(nn.Module):
    """Holds a layer's dropout rate; `active(generator)` says whether masks
    are drawn, and raises in train() mode when no generator was passed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def active(self, generator: Optional[torch.Generator]) -> bool:
        if not (self.training and self.rate > 0.0):
            return False
        if generator is None:
            raise ValueError(f"dropout {self.rate} in train() mode needs the caller's "
                             "torch.Generator (forward(..., generator=...)); call eval() "
                             "for inference")
        return True

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator],
                seq: Optional[tp.SeqShard] = None, cols: Optional[Layout] = None
                ) -> torch.Tensor:
        return dropout(x, self.rate, generator, seq, cols) if self.active(generator) else x


def _grid_init_bias(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Sampling-offset bias init: per-head unit directions scaled per point
    (Deformable-DETR MSDeformAttn._reset_parameters)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention: projections around the sampling core.
    `impl` is JAX's name of the core ('pallas' -> the dense kernels, any other
    -> the gather kernels, with the merged adjoint if `merged_adjoint`). Under
    a layout `n_heads` are this process's heads, the projections its shards."""

    layout: Optional[Layout] = None

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, dtype: torch.dtype = torch.float32, impl: str = "mxu",
                 merged_adjoint: bool = True):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.impl, self.route = impl, deform_route(impl)
        self.adjoint = "merged" if merged_adjoint else "pair"
        H, L, P = n_heads, n_levels, n_points
        self.value_proj = Dense(d_model, d_model, dtype)
        self.sampling_offsets = Dense(d_model, H * L * P * 2, torch.float32,
                                      kernel_init="zeros",
                                      bias_init=_grid_init_bias(H, L, P))
        self.attention_weights = Dense(d_model, H * L * P, torch.float32,
                                       kernel_init="zeros")
        self.output_proj = Dense(d_model, d_model, dtype)
        self._wh = {}

    def _level_wh(self, spatial_shapes, device) -> torch.Tensor:
        """(L, 2) level sizes as (W, H), made once per geometry and device: a
        host-to-device copy on every call would stall the host on the card."""
        key = (spatial_shapes, str(device))
        if key not in self._wh:
            self._wh[key] = torch.tensor([[w, h] for h, w in spatial_shapes],
                                         dtype=torch.float32, device=device)
        return self._wh[key]

    def forward(self, query: torch.Tensor,              # (B, Q, C)
                reference_points: torch.Tensor,         # (B, Q, L, 2) normalized
                input_flatten: torch.Tensor,            # (B, S, C)
                spatial_shapes: Sequence[Tuple[int, int]],
                input_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True=pad
                seq: Optional[tp.SeqShard] = None,
                ) -> torch.Tensor:
        """With `seq`, `input_flatten` and its mask hold this process's
        tokens, gathered (projected) before the core."""
        B, Q, _ = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        query = tp.copy_to_model(query, self.layout)
        input_flatten = tp.copy_to_model(input_flatten, self.layout)

        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        if seq is not None:
            value = seq.gather_for_core(value)
        S = value.shape[1]
        value = value.view(B, S, H, -1)

        offsets = self.sampling_offsets(query).view(B, Q, H, L, P, 2)
        attn = self.attention_weights(query).view(B, Q, H, L * P)
        attn = F.softmax(attn, dim=-1).view(B, Q, H, L, P)
        # offsets are in feature-map fractions of each level: divide by (W, H)
        wh = self._level_wh(tuple(spatial_shapes), query.device)
        locations = (reference_points.float()[:, :, None, :, None, :]
                     + offsets / wh[None, None, None, :, None, :])
        args = (value.contiguous(), tuple(spatial_shapes), locations.contiguous(),
                attn.contiguous())
        out = (ms_deform_attn_dense(*args) if self.route == "dense"
               else ms_deform_attn(*args, adjoint=self.adjoint))
        return tp.row_parallel(self.output_proj, out, self.layout)


class MultiheadAttention(nn.Module):
    """Self-attention with torch's packed `in_proj` layout (nn.MultiheadAttention
    names) and flax `MultiHeadDotProductAttention` numerics. Under a layout
    `num_heads` are this process's heads: the rows of its q, k and v
    projections and the columns of `out_proj`."""

    layout: Optional[Layout] = None

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.attn_drop = _Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Dense(embed_dim, embed_dim, dtype)

    def seeded_init(self, g: torch.Generator) -> None:
        # flax: lecun_normal query/key/value kernels (fan_in = C), zero biases
        variance_scaling_(self.in_proj_weight, 1.0, self.in_proj_weight.shape[1], g)
        with torch.no_grad():
            self.in_proj_bias.zero_()

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        B, Lq, _ = q.shape
        H = self.num_heads
        q, k, v = (tp.copy_to_model(t, self.layout) for t in (q, k, v))
        w = self.in_proj_weight.to(dt).chunk(3)
        b = self.in_proj_bias.to(dt).chunk(3)
        C = w[0].shape[0]                   # this process's heads x head width
        qh = F.linear(q.to(dt), w[0], b[0]).view(B, Lq, H, C // H)
        kh = F.linear(k.to(dt), w[1], b[1]).view(B, k.shape[1], H, C // H)
        vh = F.linear(v.to(dt), w[2], b[2]).view(B, v.shape[1], H, C // H)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh / math.sqrt(C // H), kh)
        weights = F.softmax(scores.float(), dim=-1).to(dt)
        if self.attn_drop.active(generator):
            # flax broadcast_dropout: ONE (Q, K) mask shared by batch and heads
            # (torch's nn.MultiheadAttention draws one per batch and head)
            keep = 1.0 - self.attn_drop.rate
            mask = torch.rand((1, 1) + tuple(weights.shape[-2:]), generator=generator,
                              device=weights.device) < keep
            weights = weights * (mask.to(dt) / _rounded(keep, dt))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, vh).reshape(B, Lq, C)
        return tp.row_parallel(self.out_proj, out, self.layout)


def _ffn(layer: nn.Module, x: torch.Tensor, generator: Optional[torch.Generator],
         seq: Optional[tp.SeqShard] = None) -> torch.Tensor:
    """linear2(dropout(relu(linear1(x)))): under a layout linear1 column- and
    linear2 row-parallel over 'model'."""
    h = F.relu(layer.linear1(tp.copy_to_model(x, layer.layout)))
    return tp.row_parallel(layer.linear2, layer.drop(h, generator, seq, layer.layout),
                           layer.layout)


class EncoderLayer(nn.Module):
    layout: Optional[Layout] = None

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 impl: str = "mxu", merged_adjoint: bool = True):
        super().__init__()
        self.drop = _Dropout(dropout)
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype, impl,
                                      merged_adjoint)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, d_ffn, dtype)
        self.linear2 = Dense(d_ffn, d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, src, pos, reference_points, spatial_shapes, padding_mask,
                generator: Optional[torch.Generator] = None,
                seq: Optional[tp.SeqShard] = None):
        """With `seq` the tokens, their positions, reference points and mask
        are this process's share."""
        src2 = self.self_attn(src + pos, reference_points, src, spatial_shapes, padding_mask,
                              seq)
        src = self.norm1(src + self.drop(src2, generator, seq))
        src2 = _ffn(self, src, generator, seq)
        return self.norm2(src + self.drop(src2, generator, seq))


class DecoderLayer(nn.Module):
    """MHA self-attention over the queries (q = k = tgt + pos, v = tgt),
    deformable cross-attention into the memory, then the FFN."""

    layout: Optional[Layout] = None

    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 impl: str = "mxu", merged_adjoint: bool = True):
        super().__init__()
        self.drop = _Dropout(dropout)
        self.self_attn = MultiheadAttention(d_model, n_heads, dtype, dropout)
        self.norm2 = LayerNorm(d_model, dtype)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, dtype, impl,
                                       merged_adjoint)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, d_ffn, dtype)
        self.linear2 = Dense(d_ffn, d_model, dtype)
        self.norm3 = LayerNorm(d_model, dtype)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask, generator: Optional[torch.Generator] = None):
        q = tgt + query_pos
        tgt2 = self.self_attn(q, q, tgt, generator)
        tgt = self.norm2(tgt + self.drop(tgt2, generator))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes,
                               src_padding_mask)
        tgt = self.norm1(tgt + self.drop(tgt2, generator))
        tgt2 = _ffn(self, tgt, generator)
        return self.norm3(tgt + self.drop(tgt2, generator))


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]],
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-pixel normalized reference grid scaled by the valid ratios,
    (B, S, L, 2), in f32. valid_ratios is (B, L, 2) as (w_ratio, h_ratio)."""
    refs = []
    dev = valid_ratios.device
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        ry, rx = torch.meshgrid(torch.arange(Hl, dtype=torch.float32, device=dev) + 0.5,
                                torch.arange(Wl, dtype=torch.float32, device=dev) + 0.5,
                                indexing="ij")
        ry = ry.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * Hl)
        rx = rx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * Wl)
        refs.append(torch.stack([rx, ry], dim=-1))          # (B, Hl*Wl, 2)
    ref = torch.cat(refs, dim=1)                            # (B, S, 2)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def compute_valid_ratios(masks: List[torch.Tensor]) -> torch.Tensor:
    """(B, L, 2) fraction of unpadded width/height per level (masks True = pad)."""
    ratios = []
    for m in masks:
        not_m = ~m
        valid_h = not_m[:, :, 0].float().sum(1)
        valid_w = not_m[:, 0, :].float().sum(1)
        ratios.append(torch.stack([valid_w / m.shape[2], valid_h / m.shape[1]], dim=-1))
    return torch.stack(ratios, dim=1)


class _LayerStack(nn.Module):
    """Holds `layers` so that names read `encoder.layers.{i}` as in the reference."""

    def __init__(self, layers: List[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableTransformer(nn.Module):
    """Encoder over the flattened multi-scale tokens + decoder with stacked
    intermediate states. Takes per-level maps channels-last. `enc_impl` /
    `dec_impl` pick each stack's sampling core by JAX's names (JAX's decoder
    'auto' resolves by memory length to 'mxu'; here it is the gather route
    too), `merged_adjoint` the gather route's backward. A learned (Q, 2C)
    query table is split and broadcast over the batch; without reference
    points (`learned_reference_points`) the decoder's are
    sigmoid(`reference_points`(qe)), as in JAX (`poet_tpu/models/
    transformer.py:533-544`). Under a layout with a 'seq' axis the encoder
    runs on this process's share of the tokens (`parallel/tp.py`: padded to a
    multiple of n_seq, pad tokens masked, their reference points at -10) and
    `memory` is gathered whole, with its pad rows dropped, for the decoder,
    which every process runs whole."""

    layout: Optional[Layout] = None

    def __init__(self, d_model: int = 256, nhead: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 1024,
                 num_feature_levels: int = 4, dec_n_points: int = 4,
                 enc_n_points: int = 4, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0, enc_impl: str = "mxu", dec_impl: str = "auto",
                 merged_adjoint: bool = True, learned_reference_points: bool = False):
        super().__init__()
        self.d_model = d_model
        self.dtype = dtype
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        # reference_points='learned': sigmoid(Linear(qe)), in f32 (flax's Dense
        # promotes the bf16 query to its f32 kernel)
        self.reference_points = (Dense(d_model, 2, torch.float32)
                                 if learned_reference_points else None)
        self.encoder = _LayerStack([
            EncoderLayer(d_model, dim_feedforward, num_feature_levels, nhead,
                         enc_n_points, dtype, dropout, enc_impl, merged_adjoint)
            for _ in range(num_encoder_layers)])
        self.decoder = _LayerStack([
            DecoderLayer(d_model, dim_feedforward, num_feature_levels, nhead,
                         dec_n_points, dtype, dropout, dec_impl, merged_adjoint)
            for _ in range(num_decoder_layers)])

    def seeded_init(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.level_embed.normal_(0.0, 1.0, generator=g)

    def forward(self, srcs: List[torch.Tensor],        # per level (B, Hl, Wl, C)
                masks: List[torch.Tensor],             # per level (B, Hl, Wl) True = pad
                pos_embeds: List[torch.Tensor],        # per level (B, Hl, Wl, C)
                query_embed: torch.Tensor,             # (B, Q, 2C), or (Q, 2C) if learned
                reference_points: Optional[torch.Tensor],   # (B, Q, 2); None if learned
                generator: Optional[torch.Generator] = None):
        spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
        B, C = srcs[0].shape[0], self.d_model
        src_flat = torch.cat([s.reshape(B, -1, C) for s in srcs], 1).to(self.dtype)
        mask_flat = torch.cat([m.reshape(B, -1) for m in masks], 1)
        pos_flat = torch.cat([p.reshape(B, -1, C) + self.level_embed[lvl]
                              for lvl, p in enumerate(pos_embeds)], 1).to(self.dtype)
        valid_ratios = compute_valid_ratios(masks)

        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        seq = tp.seq_shard(self.layout, src_flat.shape[1])
        if seq is None:
            out, pos_enc, ref_enc, mask_enc = src_flat, pos_flat, enc_ref, mask_flat
        else:
            out, pos_enc = seq.split(src_flat), seq.split(pos_flat)
            ref_enc, mask_enc = seq.local(enc_ref, -10.0), seq.local(mask_flat, True)
        for layer in self.encoder.layers:
            out = layer(out, pos_enc, ref_enc, spatial_shapes, mask_enc, generator, seq)
        memory = out if seq is None else seq.gather(out)

        qe, tgt = query_embed.to(self.dtype).split(C, dim=-1)
        if query_embed.dim() == 2:                  # a learned (Q, 2C) table
            qe, tgt = qe.expand(B, -1, -1), tgt.expand(B, -1, -1)
        ref = (torch.sigmoid(self.reference_points(qe)) if reference_points is None
               else reference_points)
        intermediates = []
        output = tgt
        for layer in self.decoder.layers:
            ref_input = ref[:, :, None, :] * valid_ratios[:, None, :, :]   # (B, Q, L, 2)
            output = layer(output, qe, ref_input, memory, spatial_shapes, mask_flat,
                           generator)
            intermediates.append(output)
        hs = torch.stack(intermediates).float()       # (n_dec_layers, B, Q, C)
        return hs, ref, memory
