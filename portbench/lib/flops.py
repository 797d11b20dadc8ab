"""Operations and bytes counted from a configuration's shapes, never from
the program: the model's FLOPs for the `mfu.*` metrics and the deformable
core's least bytes and FLOPs for `deform_roofline.*`. Peaks: one NVIDIA
H100 SXM (data sheet, dense): 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s float32 outside them, 3.35 TB/s of HBM."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# per sampled (query, head, level, point) and channel: four bilinear corners
# (a multiply and an add each) and the attention weight's multiply-add
DEFORM_FLOPS_PER_SAMPLE_CHANNEL = 10


def conv_flops(cin: int, cout: int, k: int, hout: int, wout: int) -> int:
    """2 multiply-adds counted as two operations: 2 Cin k^2 Cout Ho Wo."""
    return 2 * cin * k * k * cout * hout * wout


def linear_flops(rows: int, fin: int, fout: int) -> int:
    return 2 * rows * fin * fout


def out_hw(h: int, w: int, k: int, stride: int, pad: int) -> Tuple[int, int]:
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


def darknet_flops(sections, H: int, W: int) -> Tuple[int, list]:
    """Every conv of the darknet graph for one image -> (FLOPs, the maps
    fed to the transformer as (C, h, w))."""
    from portbench.reference.darknet import conv_geometry, ints, walk

    total, sizes, feats = 0, [], []
    hw = (H, W)
    for li, (sec, (c, s, cin)) in enumerate(zip(sections[1:], walk(sections))):
        t = sec["type"]
        if t == "convolutional":
            f, k, stride, pad, _, _ = conv_geometry(sec)
            hw = out_hw(hw[0], hw[1], k, stride, pad)
            total += conv_flops(cin, f, k, *hw)
        elif t == "route":
            hw = sizes[[i if i >= 0 else li + i for i in ints(sec["layers"])][0]]
        elif t == "maxpool":
            size = int(sec.get("size", 2))
            hw = out_hw(hw[0], hw[1], size, int(sec.get("stride", size)), size // 2)
        elif t == "upsample":
            st = int(sec.get("stride", 2))
            hw = (hw[0] * st, hw[1] * st)
        elif t == "yolo":
            feats.append((walk(sections)[li - 2][0],) + sizes[li - 2])
            hw = sizes[-1]
        sizes.append(hw)
    return total, feats


def resnet_fpn_flops(H: int, W: int, levels: Sequence[str]) -> Tuple[int, list]:
    """torchvision's ResNet-50 (stem, 3-4-6-3 bottlenecks) and the FPN's
    lateral 1x1 and output 3x3 convs of the levels that feed `levels`
    ('2', '3', 'pool' = the stride-16/32/64 maps) for one image."""
    total = 0
    h, w = out_hw(H, W, 7, 2, 3)
    total += conv_flops(3, 64, 7, h, w)
    h, w = out_hw(h, w, 3, 2, 1)
    cin, dims = 64, []
    for stage, (width, n) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            total += conv_flops(cin, width, 1, h, w)
            h2, w2 = out_hw(h, w, 3, stride, 1)
            total += conv_flops(width, width, 3, h2, w2)
            total += conv_flops(width, width * 4, 1, h2, w2)
            if b == 0:
                total += conv_flops(cin, width * 4, 1, h2, w2)
            h, w, cin = h2, w2, width * 4
        dims.append((cin, h, w))
    finest = min(int(l) if l != "pool" else 3 for l in levels)
    feats = []
    for i in range(finest, 4):
        c, h, w = dims[i]
        total += conv_flops(c, 256, 1, h, w)
        if str(i) in levels or (i == 3 and "pool" in levels):
            total += conv_flops(256, 256, 3, h, w)
        if str(i) in levels:
            feats.append((256, h, w))
    if "pool" in levels:
        c, h, w = dims[3]
        feats.append((256, (h + 1) // 2, (w + 1) // 2))
    return total, feats


def deform_samples(rows: int, m: dict, points: int) -> int:
    return rows * m["nheads"] * m["num_feature_levels"] * points * (m["hidden_dim"] // m["nheads"])


def poet_flops(m: dict, feats, backward: bool = False) -> Dict[str, int]:
    """PoET for one image on backbone maps `feats` ((C, h, w) each): the
    input projections, the encoder, the decoder and every decoder layer's
    heads. `backward` adds twice the forward of everything but the input of
    the first trained layer (the usual 2x of a backward)."""
    C, F, H, Q = m["hidden_dim"], m["dim_feedforward"], m["nheads"], m["num_queries"]
    L, n_cls = m["num_feature_levels"], m["n_classes"] + 1
    proj, S = 0, 0
    c, h, w = feats[-1]
    for cin, fh, fw in feats:
        proj += conv_flops(cin, C, 1, fh, fw)
        S += fh * fw
    for e in range(L - len(feats)):
        h, w = out_hw(h, w, 3, 2, 1)
        proj += conv_flops(c if e == 0 else C, C, 3, h, w)
        S += h * w
    P_e, P_d = m["enc_n_points"], m["dec_n_points"]
    enc = m["enc_layers"] * (
        linear_flops(S, C, C) * 2 + linear_flops(S, C, H * L * P_e * 3)
        + linear_flops(S, C, F) * 2 + DEFORM_FLOPS_PER_SAMPLE_CHANNEL * deform_samples(S, m, P_e))
    dec = m["dec_layers"] * (
        linear_flops(Q, C, 3 * C) + 4 * Q * Q * C + linear_flops(Q, C, C)
        + linear_flops(S, C, C) + linear_flops(Q, C, H * L * P_d * 3) + linear_flops(Q, C, C)
        + linear_flops(Q, C, F) * 2 + DEFORM_FLOPS_PER_SAMPLE_CHANNEL * deform_samples(Q, m, P_d))
    heads = m["dec_layers"] * sum(linear_flops(Q, C, C) * 2 + linear_flops(Q, C, out * n_cls)
                                  for out in (3, 6))
    out = {"input_proj": proj, "encoder": enc, "decoder": dec, "heads": heads, "tokens": S}
    if backward:
        for k in ("input_proj", "encoder", "decoder", "heads"):
            out[k] *= 3
    return out


def model_flops(conf, H: int, W: int, train: bool = False) -> int:
    """FLOPs of one image through the whole model: the frozen backbone's
    forward once, PoET's forward (and backward when training)."""
    if conf.backbone == "darknet":
        bb, feats = darknet_flops(conf.sections, H, W)
    else:
        bb, feats = resnet_fpn_flops(H, W, conf.data["fpn_levels"])
    p = poet_flops(conf.model, feats, backward=train)
    return bb + p["input_proj"] + p["encoder"] + p["decoder"] + p["heads"]


def deform_call(B: int, S: int, Q: int, H: int, D: int, L: int, P: int, itemsize: int,
                adjoint: bool = False) -> Tuple[float, float]:
    """(least bytes, FLOPs) of one deformable-core call. Each input byte read
    once and each output written once: the value (no more of it than the
    call's B Q H L P 4 corners can reach: a decoder's ten queries touch a
    sliver of the memory), the f32 locations and weights, the output; the
    adjoint reads those and the incoming gradient and writes d_value, d_loc
    and d_attn. FLOPs: DEFORM_FLOPS_PER_SAMPLE_CHANNEL per sample and
    channel, twice that for the adjoint."""
    samples = B * Q * H * L * P
    value = min(B * S * H * D, samples * 4 * D) * itemsize
    loc, attn, out = samples * 2 * 4, samples * 4, B * Q * H * D * itemsize
    flops = DEFORM_FLOPS_PER_SAMPLE_CHANNEL * samples * D
    if adjoint:
        return float(value + loc + attn + out + value + loc + attn), 2.0 * flops
    return float(value + loc + attn + out), float(flops)


def deform_bound_s(call) -> float:
    nbytes, flops = deform_call(*call)
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32)
