"""A model of the stem conv kernel's tensor-core arithmetic, on the CPU.

`csrc/conv_stem_fwd.cu` runs only on the card, so these tests restate its
algorithm in numpy, block by block, and hold that model against the port's
plain version (`conv_stem_torch`) and against JAX's Pallas kernel in
interpret mode:
  * the block plan of the C entry (tile and halo, stride-phase column
    slots, the direct or im2col A path, the channel chunk, one or two tile
    buffers, the shared-memory layout), with its bank-group and size
    claims, and the staged weight columns' order, which lets each thread
    store its channels of a pixel as one vector;
  * the staged tile read through the kernel's own slot formula, the im2col
    tile with K padded to the mma depth, tap-major K;
  * products in k-steps of the mma depth (16 bf16, 8 f32), each step's
    exact product sum rounded once into its f32 accumulator: bf16 sums in
    one accumulator over all of K; f32's two accumulators join the f32
    total after every tap (direct) or every 4 steps (im2col);
  * f32 as 3xTF32: hi = tf32(v), lo = tf32(v - hi) on both sides, TF32
    rounding emulated bit for bit (`cvt.rna.tf32.f32`: round to nearest,
    ties away from zero), the small products in their own accumulator;
  * the epilogue: + bias, the activation in f32, one rounding.
Rows: `chip_smoke.py` phase 12's geometries (the YOLO and ResNet rows cut to
B=1 and a few tiles). Tolerances are phase 12's: f32 within 1e-5 of the
output's max |value|, bf16 within that plus 2^-8 |ref| (one bf16 rounding).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

TH, TW, MAX_CHUNK, W_PAD, FLUSH_STEPS = 8, 16, 64, 8, 4
MAX_SMEM = 232448
STEM_F32_RTOL = 1e-5
PAD1 = ((1, 1), (1, 1))
# chip_smoke.py STEM_GEOMETRIES, the B=16 rows cut to B=1 and 40x56 or 36x52
# (name, B, H, W, C, F, kh, kw, stride, padding, activation, bias)
GEOMETRIES = [
    ("yolo L0", 1, 40, 56, 3, 32, 3, 3, 1, PAD1, "mish", True),
    ("yolo L1", 1, 40, 56, 32, 64, 3, 3, 2, PAD1, "mish", True),
    ("yolo L3", 1, 36, 52, 32, 64, 3, 3, 1, PAD1, "mish", True),
    ("resnet stem", 1, 40, 56, 3, 64, 7, 7, 2, ((3, 3), (3, 3)), "relu", False),
    ("5x3/2 asymmetric", 2, 38, 52, 4, 16, 5, 3, 2, ((2, 1), (1, 2)), None, True),
    ("1x1", 2, 38, 52, 8, 24, 1, 1, 1, ((0, 0), (0, 0)), "relu", True),
    ("no bias, none", 2, 38, 52, 3, 32, 3, 3, 1, PAD1, None, False),
    ("no bias, relu", 2, 38, 52, 3, 32, 3, 3, 1, PAD1, "relu", False),
    ("no bias, mish", 2, 38, 52, 32, 64, 3, 3, 2, PAD1, "mish", False),
    ("no bias, leaky", 2, 38, 52, 32, 64, 3, 3, 1, PAD1, "leaky", False),
    ("C=5 F=12", 2, 38, 52, 5, 12, 3, 3, 2, PAD1, "leaky", True),
    ("F=72 (two channel chunks)", 2, 38, 52, 8, 72, 3, 3, 1, PAD1, "mish", True),
]
IDS = [g[0] for g in GEOMETRIES]


def tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (the magnitude bits + half a TF32 ulp, then truncate);
    NaN and infinities pass through."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    special = (bits & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    return np.where(special, bits, rounded).view(np.float32)


def split(a: np.ndarray):
    hi = tf32(a)
    return hi, tf32(a - hi)


def plan(C, F, kh, kw, s, bf16, x_aligned=True):
    """The C entry's plan (`poet_conv_stem_fwd`): the A path, the chunk, the
    staged layouts (elements) and the shared-memory bytes."""
    elem = 2 if bf16 else 4
    kstep, v = (16, 8) if bf16 else (8, 4)
    direct = C % kstep == 0 and x_aligned
    chunk = min(MAX_CHUNK, -(-F // 16) * 16)
    rows_in, cols_in = (TH - 1) * s + kh, (TW - 1) * s + kw
    colsp = -(-cols_in // s)
    K = kh * kw * C
    p = dict(direct=direct, kstep=kstep, chunk=chunk, n_chunks=-(-F // chunk),
             rows_in=rows_in, cols_in=cols_in, colsp=colsp, cs=C + v if direct else C,
             pitch=s * colsp if direct else cols_in,
             K=K, Kp=-(-K // kstep) * kstep, ws=chunk + W_PAD, elem=elem)
    p["as"] = p["Kp"] + v

    def r16(n):
        return -(-n // 16) * 16

    w_bytes = r16((K if direct else p["Kp"]) * p["ws"] * elem)
    tile_bytes = r16(rows_in * p["pitch"] * p["cs"] * elem)
    a_bytes = 0 if direct else TH * TW * p["as"] * elem + p["Kp"] * 4
    p["n_buf"] = 2 if w_bytes + 2 * tile_bytes + a_bytes <= MAX_SMEM else 1
    p["smem"] = w_bytes + p["n_buf"] * tile_bytes + a_bytes
    return p


def channel_of_column(j, NT):
    """The kernel's order of a chunk's staged weight columns: mma column
    j = 8 n + 2 t + c holds channel 32 q + 2 wq t + 2 (n - 4 q) + c, with
    q = n // 4 and wq = min(4, NT - 4 q)."""
    n, t, c = j >> 3, (j >> 1) & 3, j & 1
    q = n >> 2
    wq = min(4, NT - 4 * q)
    return 32 * q + 2 * wq * t + 2 * (n - 4 * q) + c


def col_slot(ix, s, colsp):
    """The direct path's stride-phase slot of tile column ix."""
    return (ix % s) * colsp + ix // s


def _act(v: np.ndarray, act):
    from poet_tpu_torch.ops.conv_stem_cuda import ACTIVATIONS

    return ACTIVATIONS[act](torch.from_numpy(v)).numpy()


def model(x, w, bias, *, stride, padding, activation, out_dtype=None):
    """The kernel's arithmetic, every block at once: x (B, H, W, C), w HWIO
    in x's dtype (torch), bias f32 or None -> (B, Ho, Wo, F) torch."""
    bf16 = x.dtype == torch.bfloat16
    B, H, W, C = x.shape
    kh, kw, _, F = w.shape
    (pt, pb), (pl, pr) = padding
    s = stride
    Ho, Wo = (H + pt + pb - kh) // s + 1, (W + pl + pr - kw) // s + 1
    p = plan(C, F, kh, kw, s, bf16)
    xs, wf = x.float().numpy(), w.float().numpy().reshape(-1, F)
    nty, ntx = -(-Ho // TH), -(-Wo // TW)

    # the staged tiles of every block: (B, nty, ntx, rows_in, pitch, cs); the
    # direct path stores columns by stride phase, the im2col path in order
    tile = np.zeros((B, nty, ntx, p["rows_in"], p["pitch"], p["cs"]), np.float32)
    slot = (lambda ix: col_slot(ix, s, p["colsp"])) if p["direct"] else (lambda ix: ix)
    r = np.arange(p["rows_in"])
    c = np.arange(p["cols_in"])
    iy = np.arange(nty)[:, None] * TH * s - pt + r[None, :]          # (nty, rows_in)
    ix = np.arange(ntx)[:, None] * TW * s - pl + c[None, :]          # (ntx, cols_in)
    vy, vx = (iy >= 0) & (iy < H), (ix >= 0) & (ix < W)
    vals = xs[:, np.clip(iy, 0, H - 1)][:, :, :, np.clip(ix, 0, W - 1)]  # (B,nty,R,ntx,Cc,C)
    vals = vals * (vy[None, :, :, None, None, None] & vx[None, None, None, :, :, None])
    tile[..., slot(c), :C] = vals.transpose(0, 1, 3, 2, 4, 5)

    # A rows: the 128 output pixels (warp w = tile row, px = column) of a block
    wr, px = np.repeat(np.arange(TH), TW), np.tile(np.arange(TW), TH)
    ks = p["kstep"]
    if p["direct"]:
        steps = []
        for ky in range(kh):
            for kx in range(kw):
                rows, slots = wr * s + ky, slot(kx) + px
                a_tap = tile[:, :, :, rows, slots, :]                  # (..., 128, cs)
                steps.append([(a_tap[..., c0:c0 + ks], (ky * kw + kx) * C + c0)
                              for c0 in range(0, C, ks)])
    else:
        k = np.arange(p["Kp"])
        tap, cc = np.minimum(k, p["K"] - 1) // C, np.minimum(k, p["K"] - 1) % C
        ky, kx = tap // kw, tap % kw
        rows = wr[:, None] * s + ky[None, :]
        slots = px[:, None] * s + kx[None, :]
        a_tile = tile[:, :, :, rows, slots, cc[None, :]] * (k < p["K"])  # (..., 128, Kp)
        n_steps = p["Kp"] // ks
        groups = [list(range(i, min(i + FLUSH_STEPS, n_steps)))
                  for i in range(0, n_steps, FLUSH_STEPS)]
        steps = [[(a_tile[..., j * ks:(j + 1) * ks], j * ks) for j in grp] for grp in groups]

    out = np.zeros((B, nty, ntx, TH * TW, p["n_chunks"] * p["chunk"]), np.float32)
    NT = p["chunk"] // 8
    perm = np.array([channel_of_column(j, NT) for j in range(p["chunk"])])
    for ch in range(p["n_chunks"]):
        f0 = ch * p["chunk"]
        n_real = min(p["chunk"], F - f0)
        w_pad = np.zeros((p["Kp"], p["chunk"]), np.float32)            # zero past F and K
        w_pad[:p["K"], :n_real] = wf[:, f0:f0 + n_real]
        w_s = w_pad[:, perm]                                           # staged column order
        total = np.zeros(out.shape[:-1] + (p["chunk"],), np.float32)
        for group in steps:                                            # one join each
            acc = np.zeros_like(total)
            sml = np.zeros_like(total)
            for a, k0 in group:
                b = w_s[k0:k0 + ks]
                if bf16:                      # exact products, summed in the mma's total
                    total = (total + np.einsum("...mk,kn->...mn", a.astype(np.float64), b)
                             ).astype(np.float32)
                else:                                                  # 3xTF32
                    ah, al = split(a)
                    bh, bl = split(b)
                    for u, v_, dst in ((al, bh, "s"), (ah, bl, "s"), (ah, bh, "a")):
                        prod = np.einsum("...mk,kn->...mn", u.astype(np.float64), v_)
                        if dst == "s":
                            sml = (sml + prod).astype(np.float32)
                        else:
                            acc = (acc + prod).astype(np.float32)
            if not bf16:
                total = total + (acc + sml)
        bvec = np.zeros(p["chunk"], np.float32)
        if bias is not None:
            bvec[:n_real] = bias.numpy()[f0:f0 + n_real]
        # column j of the fragments is channel perm[j]
        out[..., f0 + perm] = _act(total + bvec[perm], activation)
    # (B, nty, ntx, 8, 16, F) -> (B, Ho, Wo, F): the ragged tiles are masked
    out = out.reshape(B, nty, ntx, TH, TW, -1).transpose(0, 1, 3, 2, 4, 5)
    out = out.reshape(B, nty * TH, ntx * TW, -1)[:, :Ho, :Wo, :F]
    return torch.from_numpy(np.ascontiguousarray(out)).to(out_dtype or x.dtype)


def _inputs(B, H, W, C, Fo, kh, kw, with_bias, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((kh, kw, C, Fo)) / math.sqrt(kh * kw * C))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(Fo).astype(np.float32)) if with_bias else None
    return x, w, b


def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    cases = {1 + 2.0 ** -11: 1 + 2.0 ** -10,           # a tie: away from zero
             -(1 + 2.0 ** -11): -(1 + 2.0 ** -10),
             1 + 2.0 ** -12: 1.0,                        # below half an ulp
             1 + 3 * 2.0 ** -12: 1 + 2.0 ** -10,         # above half an ulp
             2 - 2.0 ** -12: 2.0}                        # carries into the exponent
    for v, want in cases.items():
        assert tf32(np.array([v], np.float32))[0] == np.float32(want), v
    assert np.isnan(tf32(np.array([np.nan], np.float32))[0])
    assert tf32(np.array([np.inf], np.float32))[0] == np.inf
    # the split is exact to 2^-22 relative: hi + lo vs v
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi, lo = split(v)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - v) <= 2.0 ** -22 * np.abs(v))
    assert tf32(one) == one


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_matches_the_plain_version(geom, dtype):
    from poet_tpu_torch.ops.conv_stem_cuda import conv_stem_torch

    name, B, H, W, C, Fo, kh, kw, s, pad, act, with_bias = geom
    x, w, b = _inputs(B, H, W, C, Fo, kh, kw, with_bias, seed=sum(map(ord, name)))
    kwargs = dict(stride=s, padding=pad, activation=act)
    if dtype == "float32":
        ref = conv_stem_torch(x, w, b, **kwargs)
        got = model(x, w, b, **kwargs)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        tol = STEM_F32_RTOL * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= tol
    else:
        x16, w16 = x.bfloat16(), w.bfloat16()
        ref = conv_stem_torch(x16, w16, b, out_dtype=torch.float32, **kwargs)
        got = model(x16, w16, b, **kwargs)
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        tol = STEM_F32_RTOL * ref.abs().max().item()
        assert bool(((got.float() - ref).abs() <= tol + 2.0 ** -8 * ref.abs()).all())


@pytest.mark.parametrize("geom", [GEOMETRIES[1], GEOMETRIES[4]], ids=[IDS[1], IDS[4]])
def test_model_matches_the_pallas_kernel(geom):
    """f32, against JAX's TPU kernel in interpret mode."""
    from poet_tpu.ops.conv_stem_pallas import conv_stem_pallas

    name, B, H, W, C, Fo, kh, kw, s, pad, act, with_bias = geom
    x, w, b = _inputs(B, H, W, C, Fo, kh, kw, with_bias, seed=11)
    want = np.asarray(conv_stem_pallas(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                       None if b is None else jnp.asarray(b.numpy()),
                                       stride=s, padding=pad, activation=act, interpret=True))
    got = model(x, w, b, stride=s, padding=pad, activation=act).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=STEM_F32_RTOL * float(np.abs(want).max()))


def test_plan_of_the_path_layers():
    """The YOLO request's three launches: L0 takes the im2col path (K = 27
    padded to 32), L1 and L3 the direct path; every phase-12 geometry fits
    in a block's shared memory in both dtypes."""
    l0 = plan(3, 32, 3, 3, 1, bf16=True)
    assert not l0["direct"] and (l0["K"], l0["Kp"], l0["chunk"]) == (27, 32, 32)
    l1 = plan(32, 64, 3, 3, 2, bf16=True)
    assert l1["direct"] and (l1["rows_in"], l1["cols_in"], l1["colsp"]) == (17, 33, 17)
    assert l1["K"] * l1["chunk"] * 2 == 288 * 64 * 2          # the staged weights, 36 KB
    assert plan(32, 64, 3, 3, 1, bf16=True)["direct"]
    assert not plan(32, 64, 3, 3, 1, bf16=True, x_aligned=False)["direct"]
    assert plan(8, 72, 3, 3, 1, bf16=False)["direct"]         # C = 8 is the f32 depth
    # the entry plans two tile buffers where both fit (every bf16 path layer,
    # not f32 L1); the launch keeps one where a second costs a resident block
    assert [plan(C, 64, 3, 3, s, bf16=True)["n_buf"] for C, s in ((3, 1), (32, 2), (32, 1))] \
        == [2, 2, 2]
    assert plan(32, 64, 3, 3, 2, bf16=False)["n_buf"] == 1
    assert (plan(5, 12, 3, 3, 2, bf16=True)["chunk"], plan(8, 72, 3, 3, 1, True)["n_chunks"]) \
        == (16, 2)
    for _, B, H, W, C, Fo, kh, kw, s, pad, act, bias in GEOMETRIES:
        for bf16 in (True, False):
            assert plan(C, Fo, kh, kw, s, bf16)["smem"] <= MAX_SMEM


@pytest.mark.parametrize("NT", [2, 4, 6, 8])
def test_each_thread_stores_consecutive_channels(NT):
    """channel_of_column is a permutation of the chunk; thread t's words of
    store group q are 2 wq consecutive channels, and the 4 threads of a
    row cover group q's channels as one contiguous run."""
    perm = [channel_of_column(j, NT) for j in range(8 * NT)]
    assert sorted(perm) == list(range(8 * NT))
    for q in range(-(-NT // 4)):
        wq = min(4, NT - 4 * q)
        run = []
        for t in range(4):
            chans = [perm[8 * n + 2 * t + c] for n in range(4 * q, 4 * q + wq) for c in (0, 1)]
            assert chans == list(range(chans[0], chans[0] + 2 * wq))
            run += chans
        assert run == list(range(32 * q, 32 * q + 8 * wq))


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("C,s", [(32, 1), (32, 2), (64, 2), (16, 2)])
def test_ldmatrix_rows_meet_no_bank_conflict(bf16, C, s):
    """Direct path: the 8 pixels of one ldmatrix matrix (neighbouring output
    columns at one tap) start on 8 different 16-byte groups of the 128-byte
    bank line, at stride 1 and 2, at every tap; so do the 8 weight rows of
    an ldmatrix.trans and the 8 rows of an im2col matrix."""
    p = plan(C, 64, 3, 3, s, bf16)
    assert p["direct"]
    for kx in range(3):
        for px0 in (0, 8):
            slots = col_slot(kx, s, p["colsp"]) + px0 + np.arange(8)
            groups = (slots * p["cs"] * p["elem"] // 16) % 8
            assert len(set(groups.tolist())) == 8
    if bf16:
        groups = (np.arange(8) * p["ws"] * 2 // 16) % 8
        assert len(set(groups.tolist())) == 8
    for K in (27, 45, 147):
        q = plan(3, 32, 3, 3, 1, bf16)
        q_as = -(-K // q["kstep"]) * q["kstep"] + 16 // q["elem"]
        groups = (np.arange(8) * q_as * q["elem"] // 16) % 8
        assert len(set(groups.tolist())) == 8


def test_library_key_covers_included_headers(tmp_path):
    """A library is keyed by its source and every `#include "..."` header it
    reads (through other headers too): a changed header is a new library,
    not a stale one. Both redesigned kernels read mma_sm90.cuh; the stem and
    the darknet epilogue read activations.cuh."""
    from poet_tpu_torch.ops.cuda_build import (EPILOGUE_LIB, NN_LIB, STEM_LIB, CudaLibrary,
                                               local_includes)

    for lib, headers in ((STEM_LIB, ["activations.cuh", "mma_sm90.cuh"]),
                         (NN_LIB, ["mma_sm90.cuh"]), (EPILOGUE_LIB, ["activations.cuh"])):
        assert [p.name for p in local_includes(lib.source)][1:] == headers
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "b.cuh"\nint f();\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("// one\n")
    lib = CudaLibrary(tmp_path / "a.cu", {})
    first = lib.library_path()
    assert [p.name for p in local_includes(lib.source)] == ["a.cu", "b.cuh", "c.cuh"]
    assert lib.library_path() == first
    (tmp_path / "c.cuh").write_text("// two\n")
    assert lib.library_path() != first and lib.library_path().name.startswith("a_")
