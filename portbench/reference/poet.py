"""Plain PoET: the pose estimation transformer (Jantos et al., CoRL 2022,
github.com/aau-cns/poet) on given backbone maps and given boxes, in float32
PyTorch: input projections with GroupNorm, sine position embeddings, the
deformable encoder and decoder (Deformable DETR), and the class-specific
translation and 6D rotation heads.

Parameters are a flat dict under the reference checkpoint's names
(`input_proj.{i}.0.weight`, `transformer.encoder.layers.{i}.self_attn.
value_proj.weight`, `translation_head.{l}.layers.{j}.weight`, ...), so one
state dict serves this file and the program. Departures from the published
PyTorch code, each the reference package's (poet_tpu, written in JAX): norm
epsilons are 1e-6 and GroupNorm takes var = E[x^2] - E[x]^2; the box query
embedding is sin and cos of each coordinate times 2^k, k < hidden / 8; the
deformable sampling is bilinear with zero padding at pix = loc size - 0.5.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.numerics import conv2d, linear

Params = Dict[str, torch.Tensor]


def param_shapes(m: dict, in_channels: Sequence[int]) -> Dict[str, tuple]:
    """{name: shape} of PoET's parameters for the model settings `m` (the
    configuration file's "model" keys) on backbone maps of `in_channels`."""
    C, F_, H = m["hidden_dim"], m["dim_feedforward"], m["nheads"]
    L, n_cls = m["num_feature_levels"], m["n_classes"] + 1
    s = {}
    for i in range(L):
        if i < len(in_channels):
            s[f"input_proj.{i}.0.weight"] = (C, in_channels[i], 1, 1)
        else:
            s[f"input_proj.{i}.0.weight"] = (C, in_channels[-1] if i == len(in_channels) else C,
                                             3, 3)
        s[f"input_proj.{i}.0.bias"] = (C,)
        s[f"input_proj.{i}.1.weight"] = (C,)
        s[f"input_proj.{i}.1.bias"] = (C,)
    s["transformer.level_embed"] = (L, C)

    def dense(name, i, o):
        s[f"{name}.weight"] = (o, i)
        s[f"{name}.bias"] = (o,)

    def deform(p, points):
        dense(f"{p}.value_proj", C, C)
        dense(f"{p}.sampling_offsets", C, H * L * points * 2)
        dense(f"{p}.attention_weights", C, H * L * points)
        dense(f"{p}.output_proj", C, C)

    for i in range(m["enc_layers"]):
        p = f"transformer.encoder.layers.{i}"
        deform(f"{p}.self_attn", m["enc_n_points"])
        s[f"{p}.norm1.weight"], s[f"{p}.norm1.bias"] = (C,), (C,)
        dense(f"{p}.linear1", C, F_)
        dense(f"{p}.linear2", F_, C)
        s[f"{p}.norm2.weight"], s[f"{p}.norm2.bias"] = (C,), (C,)
    for i in range(m["dec_layers"]):
        p = f"transformer.decoder.layers.{i}"
        s[f"{p}.self_attn.in_proj_weight"] = (3 * C, C)
        s[f"{p}.self_attn.in_proj_bias"] = (3 * C,)
        dense(f"{p}.self_attn.out_proj", C, C)
        deform(f"{p}.cross_attn", m["dec_n_points"])
        for n in ("norm1", "norm2", "norm3"):
            s[f"{p}.{n}.weight"], s[f"{p}.{n}.bias"] = (C,), (C,)
        dense(f"{p}.linear1", C, F_)
        dense(f"{p}.linear2", F_, C)
    for l in range(m["dec_layers"]):
        for head, out in (("translation_head", 3), ("rotation_head", 6)):
            for j, (a, b) in enumerate(((C, C), (C, C), (C, out * n_cls))):
                dense(f"{head}.{l}.layers.{j}", a, b)
    return s


def grid_bias(H: int, L: int, P: int) -> np.ndarray:
    """Deformable DETR's sampling-offset bias: a unit direction per head,
    scaled by the point's index + 1."""
    th = np.arange(H, dtype=np.float64) * (2.0 * math.pi / H)
    g = np.stack([np.cos(th), np.sin(th)], -1)
    g = g / np.abs(g).max(-1, keepdims=True)
    g = np.tile(g[:, None, None, :], (1, L, P, 1)) * (np.arange(P) + 1)[None, None, :, None]
    return g.reshape(-1).astype(np.float32)


def dense(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * p[f"{name}.weight"] + p[f"{name}.bias"]


def group_norm(x: torch.Tensor, w, b, groups: int = 32) -> torch.Tensor:
    B, C, H, W = x.shape
    g = x.reshape(B, groups, -1)
    mu = g.mean(-1, keepdim=True)
    var = (g.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0.0)
    y = ((g - mu) / torch.sqrt(var + 1e-6)).reshape(B, C, H, W)
    return y * w[:, None, None] + b[:, None, None]


def sine_positions(B: int, H: int, W: int, npf: int, device) -> torch.Tensor:
    """DETR's normalized sine embedding of an unpadded (H, W) map, (B, H, W,
    2 npf): y features, then x, each sin and cos interleaved."""
    y = (torch.arange(1, H + 1, dtype=torch.float32, device=device) - 0.5) / (H + 1e-6)
    x = (torch.arange(1, W + 1, dtype=torch.float32, device=device) - 0.5) / (W + 1e-6)
    dim_t = 10000.0 ** (2 * (torch.arange(npf, device=device) // 2).float() / npf)

    def enc(v):
        a = v[:, None] * (2 * math.pi) / dim_t
        return torch.stack([a[:, 0::2].sin(), a[:, 1::2].cos()], -1).flatten(1)

    py, px = enc(y), enc(x)
    pos = torch.cat([py[:, None, :].expand(H, W, npf), px[None, :, :].expand(H, W, npf)], -1)
    return pos[None].expand(B, H, W, 2 * npf)


def deform_sample(value, shapes, loc, attn):
    """value (B, S, H, D), loc (B, Q, H, L, P, 2) in [0, 1] per level (x, y),
    attn (B, Q, H, L, P) -> (B, Q, H D): bilinear sampling, zero outside."""
    B, S, Hh, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    out = value.new_zeros(B * Hh, D, Q)
    start = 0
    for l, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 3, 1).reshape(B * Hh, D, h, w)
        start += h * w
        g = 2.0 * loc[:, :, :, l].transpose(1, 2).reshape(B * Hh, Q, P, 2) - 1.0
        smp = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        out += (smp * attn[:, :, :, l].transpose(1, 2).reshape(B * Hh, 1, Q, P)).sum(-1)
    return out.view(B, Hh, D, Q).permute(0, 3, 1, 2).reshape(B, Q, Hh * D)


def ms_deform_attn(p: Params, name: str, m: dict, points: int, query, ref, src, shapes):
    B, Q, C = query.shape
    H, L = m["nheads"], m["num_feature_levels"]
    value = dense(p, f"{name}.value_proj", src).view(B, src.shape[1], H, C // H)
    off = dense(p, f"{name}.sampling_offsets", query).view(B, Q, H, L, points, 2)
    attn = F.softmax(dense(p, f"{name}.attention_weights", query).view(B, Q, H, L * points), -1)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=query.device)
    loc = ref[:, :, None, :, None, :] + off / wh[None, None, None, :, None, :]
    out = deform_sample(value, shapes, loc, attn.view(B, Q, H, L, points))
    return dense(p, f"{name}.output_proj", out)


def self_attention(p: Params, name: str, heads: int, q, v):
    B, Q, C = q.shape
    w, b = p[f"{name}.in_proj_weight"].chunk(3), p[f"{name}.in_proj_bias"].chunk(3)
    qh, kh, vh = (linear(x, wi, bi).view(B, Q, heads, C // heads)
                  for x, wi, bi in ((q, w[0], b[0]), (q, w[1], b[1]), (v, w[2], b[2])))
    a = F.softmax(torch.einsum("bqhd,bkhd->bhqk", qh / math.sqrt(C // heads), kh), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", a, vh).reshape(B, Q, C)
    return dense(p, f"{name}.out_proj", out)


def box_embedding(boxes: torch.Tensor, npf: int) -> torch.Tensor:
    k = 2.0 ** torch.arange(npf, dtype=torch.float32, device=boxes.device)
    e = boxes[..., :, None] * k
    return torch.cat([e.sin(), e.cos()], -1).reshape(*boxes.shape[:-1], 8 * npf)


def rotation_6d(r: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s 6D -> SO(3): columns x = n(a1), z = n(x cross a2), y = z cross x."""
    n = lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
    x = n(r[..., :3])
    z = n(torch.linalg.cross(x, r[..., 3:], dim=-1))
    return torch.stack([x, torch.linalg.cross(z, x, dim=-1), z], -1)


def forward(p: Params, m: dict, feats: List[torch.Tensor], boxes: torch.Tensor,
            classes: torch.Tensor, n_boxes: torch.Tensor,
            all_layers: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats: backbone maps NCHW; boxes (B, Q, 4) normalized cxcywh, classes
    (B, Q), n_boxes (B,) -> the last decoder layer's (translations (B, Q, 3),
    rotations (B, Q, 3, 3)), or with `all_layers` every decoder layer's,
    stacked first. Images are unpadded."""
    C, H, L = m["hidden_dim"], m["nheads"], m["num_feature_levels"]
    B, Q = boxes.shape[:2]
    srcs = []
    for i in range(L):
        pre = f"input_proj.{i}."
        if i < len(feats):
            x = conv2d(feats[i], p[pre + "0.weight"], p[pre + "0.bias"])
        else:
            x = conv2d(feats[-1] if i == len(feats) else srcs[-1], p[pre + "0.weight"],
                       p[pre + "0.bias"], stride=2, padding=1)
        srcs.append(group_norm(x, p[pre + "1.weight"], p[pre + "1.bias"]))
    shapes = [tuple(s.shape[-2:]) for s in srcs]
    src = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
    pos = torch.cat([(sine_positions(B, h, w, C // 2, src.device)
                      + p["transformer.level_embed"][l]).reshape(B, h * w, C)
                     for l, (h, w) in enumerate(shapes)], 1)
    refs = []
    for h, w in shapes:
        ry, rx = torch.meshgrid(torch.arange(h, device=src.device) + 0.5,
                                torch.arange(w, device=src.device) + 0.5, indexing="ij")
        refs.append(torch.stack([rx.reshape(-1) / w, ry.reshape(-1) / h], -1))
    enc_ref = torch.cat(refs, 0).float()[None, :, None, :].expand(B, -1, L, 2)
    for i in range(m["enc_layers"]):
        pre = f"transformer.encoder.layers.{i}."
        a = ms_deform_attn(p, pre + "self_attn", m, m["enc_n_points"], src + pos, enc_ref, src,
                           shapes)
        src = layer_norm(p, pre + "norm1", src + a)
        f = dense(p, pre + "linear2", F.relu(dense(p, pre + "linear1", src)))
        src = layer_norm(p, pre + "norm2", src + f)

    valid = torch.arange(Q, device=boxes.device)[None, :] < n_boxes[:, None]
    emb = box_embedding(torch.where(valid[..., None], boxes, -1.0), C // 8)
    qe = torch.where(valid[..., None], emb, -10.0)
    tgt = qe
    ref = torch.where(valid[..., None], boxes, -1.0)[:, :, None, :2].expand(B, Q, L, 2)
    states = []
    for i in range(m["dec_layers"]):
        pre = f"transformer.decoder.layers.{i}."
        q = tgt + qe
        tgt = layer_norm(p, pre + "norm2", tgt + self_attention(p, pre + "self_attn", H, q, tgt))
        a = ms_deform_attn(p, pre + "cross_attn", m, m["dec_n_points"], tgt + qe, ref, src,
                           shapes)
        tgt = layer_norm(p, pre + "norm1", tgt + a)
        f = dense(p, pre + "linear2", F.relu(dense(p, pre + "linear1", tgt)))
        tgt = layer_norm(p, pre + "norm3", tgt + f)
        states.append(tgt)

    idx = torch.where(classes > 0, classes, 0).long()

    def head(name, layer, d):
        x = states[layer]
        for j in range(3):
            x = dense(p, f"{name}.{layer}.layers.{j}", x)
            x = F.relu(x) if j < 2 else x
        x = x.view(B, Q, m["n_classes"] + 1, d)
        return torch.gather(x, 2, idx[:, :, None, None].expand(B, Q, 1, d))[:, :, 0]

    layers = range(m["dec_layers"]) if all_layers else [m["dec_layers"] - 1]
    t = torch.stack([head("translation_head", l, 3) for l in layers])
    r = torch.stack([rotation_6d(head("rotation_head", l, 6)) for l in layers])
    return (t, r) if all_layers else (t[0], r[0])
