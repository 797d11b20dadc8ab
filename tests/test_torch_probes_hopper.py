"""The two probe kernels' Hopper designs, modelled in numpy on the CPU.

* kpad (`csrc/probe_kpad.cu`, `wgmma.mma_async`): the PTX ISA's fragment
  tables for wgmma m64nNk16 as index functions (accumulator (warp, lane,
  register) -> (row, column); A register fragment -> (row, k)); the A
  fragment of k-slice kk is the packed accumulator chunks 2 kk and 2 kk + 1
  of the same thread; the chain run through those maps, a warpgroup at a
  time, bit for bit in a_i against the plain version and within f32
  tolerance in the result against the plain version and a jnp restatement
  of `scripts/bench_kpad.py:33-48`; the task plan (every (strip, repeat)
  once, only the last repeat writes, rows past M never stored, the waves
  at G = 66 and 88) and the shared-memory plan.
* the forward's variants (`csrc/ms_deform_attn_fwd_variants.cu`, a
  TMA-staged slab): the slab plan (boxes of at most 256 tokens, every token
  staged once, 128-byte aligned destinations, the budget), the query passes
  (every (q, slice) item once), and the staged-slab walk, its output held
  against JAX's `ms_deform_attn_pallas_v3` in interpret mode.

The kernels themselves run only on the card (chip_smoke.py phase 22).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_deform_attn import _make_inputs
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_probes import KPAD_RTOL, V3_ATOL, _jax_kpad_chain

BF16 = np.dtype(jnp.bfloat16).type      # ml_dtypes.bfloat16: numpy scalars and arrays


# ---- the wgmma m64nNk16 fragment tables (PTX ISA, "Register Fragments") ----
def acc_index(w, lane, i):
    """Accumulator register i of lane `lane` in warp w of a warpgroup ->
    (row, column) of the 64 x N f32 accumulator."""
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * t + i % 2


def a_index(w, lane, r, h):
    """Half h (0: low 16 bits) of A register r of lane `lane` in warp w ->
    (row, k) of the 64 x 16 bf16 A operand."""
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (r % 2), 8 * (r // 2) + 2 * t + h


@pytest.mark.parametrize("N", [128, 256])
def test_wgmma_fragment_maps_are_bijections(N):
    acc = {acc_index(w, lane, i) for w in range(4) for lane in range(32) for i in range(N // 2)}
    assert acc == {(m, n) for m in range(64) for n in range(N)}
    a = {a_index(w, lane, r, h) for w in range(4) for lane in range(32) for r in range(4)
         for h in range(2)}
    assert a == {(m, k) for m in range(64) for k in range(16)}


@pytest.mark.parametrize("kk", range(8))
def test_a_fragment_of_k_slice_is_accumulator_chunks(kk):
    """The feedback in registers: A register r (halves h) of k-slice kk holds
    accumulator register 8 kk + 2 r + h of the same lane, i.e. chunks 2 kk
    and 2 kk + 1, in order, for every warp and lane."""
    for w in range(4):
        for lane in range(32):
            for r in range(4):
                for h in range(2):
                    m, k = a_index(w, lane, r, h)
                    i = 8 * kk + 2 * r + h
                    assert acc_index(w, lane, i) == (m, 16 * kk + k)
                    assert i // 4 in (2 * kk, 2 * kk + 1)


def _bf16(x):
    return np.asarray(x, np.float32).astype(BF16)


def _chain_through_fragments(a, b, R, wg_n):
    """The kernel's arithmetic on one task, a strip at a time, through the
    fragment maps: per warpgroup its N/2 accumulator registers a lane;
    warpgroup 0 builds each a_i register from its own accumulator and the
    staged a (a + bf16(acc * 1e-30), columns >= K zero), the others read the
    same a_i. Returns (out (M, N) f32, the a_i of every step as (M, KP))."""
    M, K = a.shape
    N = b.shape[1]
    kp = -(-K // 16) * 16
    n_wg = -(-N // wg_n)
    bp = np.zeros((kp, n_wg * wg_n), np.float32)            # b staged: zeros past K, N
    bp[:K, :N] = b.astype(np.float32)
    out = np.zeros((M, N), np.float32)
    steps = []
    for m0 in range(0, M, 64):
        strip = np.zeros((64, kp), BF16)                     # rows past M, columns past K zero
        rows = min(64, M - m0)
        strip[:rows, :K] = a[m0:m0 + rows]
        regs = np.zeros((n_wg, 4, 32, wg_n // 2), np.float32)
        for _ in range(R):
            a_i = np.zeros((64, kp), BF16)
            for w in range(4):
                for lane in range(32):
                    for kk in range(kp // 16):
                        for r in range(4):
                            for h in range(2):
                                m, k = a_index(w, lane, r, h)
                                k += 16 * kk
                                fb = _bf16(regs[0, w, lane, 8 * kk + 2 * r + h] * np.float32(1e-30))
                                a_i[m, k] = (strip[m, k] + fb) if k < K else BF16(0)
            steps.append(a_i[:rows].copy())
            prod = a_i.astype(np.float64) @ bp.astype(np.float64)   # exact products, one rounding
            for wg in range(n_wg):
                for w in range(4):
                    for lane in range(32):
                        for i in range(wg_n // 2):
                            m, n = acc_index(w, lane, i)
                            regs[wg, w, lane, i] += np.float32(prod[m, wg * wg_n + n])
        for wg in range(n_wg):                               # the last repeat's stores
            for w in range(4):
                for lane in range(32):
                    for i in range(wg_n // 2):
                        m, n = acc_index(w, lane, i)
                        if m0 + m < M and wg * wg_n + n < N:
                            out[m0 + m, wg * wg_n + n] = regs[wg, w, lane, i]
    return out, steps


@pytest.mark.parametrize("K,N,wg_n", [(8, 64, 128), (27, 96, 128), (40, 256, 128),
                                      (16, 288, 256)])
def test_kpad_chain_through_fragment_maps(rng, K, N, wg_n):
    from poet_tpu_torch.tools.bench_kpad import kpad_chain_torch

    M, R = 80, 3                      # two strips, the second 16 rows: 48 zero-filled
    a = rng.normal(size=(M, K)).astype(BF16)
    b = rng.normal(size=(K, N)).astype(BF16)
    got, steps = _chain_through_fragments(a, b, R, wg_n)
    # a_i of every step, bit for bit, against the plain version's
    ta = torch.from_numpy(a.astype(np.float32)).bfloat16()
    tb = torch.from_numpy(b.astype(np.float32)).bfloat16()
    acc = torch.zeros((M, N))
    plain_steps = []
    for _ in range(R):
        a_i = ta + (acc[:, :K] * 1e-30).to(ta.dtype)
        plain_steps.append(a_i)
        acc = acc + a_i.float() @ tb.float()
    for s, a_i in enumerate(plain_steps):                     # steps: strip-major
        model = np.concatenate([steps[j * R + s] for j in range(-(-M // 64))])
        np.testing.assert_array_equal(model[:, :K].astype(np.float32), a_i.float().numpy())
    for st in steps:                                          # the feedback writes columns < K
        assert not st[:, K:].astype(np.float32).any()
    want = kpad_chain_torch(ta, tb, R).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=KPAD_RTOL * scale)
    jax_want = _jax_kpad_chain(jnp.asarray(a), jnp.asarray(b), R)
    np.testing.assert_allclose(got, jax_want, atol=KPAD_RTOL * scale)


def kpad_tasks(M, G, blocks):
    """The kernel's persistent walk (`probe_kpad_kernel`'s task loop: task =
    blockIdx.x + j gridDim.x, strip = task % strips, repeat = task / strips):
    for each CTA, its tasks in order as (strip, repeat, writes its output)."""
    strips = -(-M // 64)
    return [[(task % strips, task // strips, task // strips == G - 1)
             for task in range(cta, strips * G, blocks)] for cta in range(blocks)]


@pytest.mark.parametrize("G,waves", [(66, 7.5), (88, 10.0)])
def test_kpad_task_plan(G, waves):
    """The flagship sweep's tasks: 15 strips of 64 rows at M = 960, one CTA
    an SM; every (strip, repeat) taken once, only the last repeat of a strip
    writes, each output row written once."""
    from poet_tpu_torch.tools.bench_kpad import kpad_plan

    for wg in (2, 4):
        plan = kpad_plan(960, 512, 128, G, wg)
        assert (plan["strips"], plan["tasks"], plan["blocks"]) == (15, 15 * G, 132)
        assert plan["waves"] == waves
        assert plan["n_wg"] * plan["wg_n"] == 512 and plan["threads"] == 128 * plan["n_wg"]
        assert plan["zero_blocks"] == 0 and plan["smem"] <= 232448
    walk = kpad_tasks(960, G, 132)
    taken = sorted((s, r) for cta in walk for s, r, _ in cta)
    assert taken == [(s, r) for s in range(15) for r in range(G)]
    writers = sorted(s for cta in walk for s, r, w in cta if w)
    assert writers == list(range(15))
    assert all(w == (r == G - 1) for cta in walk for _, r, w in cta)
    assert max(len(cta) for cta in walk) == int(np.ceil(waves))


@pytest.mark.parametrize("M", [16, 48, 976])
def test_kpad_rows_past_m_never_stored(M):
    """M % 16 == 0 but not 64: the last strip's rows past M are zero-filled
    and never stored, each row < M written once by its strip's last repeat."""
    G = 3
    written = np.zeros(M, int)
    for cta in kpad_tasks(M, G, 5):
        for strip, _, writes in cta:
            if writes:
                for w in range(4):
                    for lane in range(32):
                        for i in range(4):          # one chunk's registers: both rows
                            m = 64 * strip + acc_index(w, lane, i)[0]
                            if m < M:
                                written[m] += 1
    # each row is held by 4 lanes (t) x 2 registers of a chunk
    assert (written == 8).all()


@pytest.mark.parametrize("K", [1, 8, 16, 27, 40, 128])
@pytest.mark.parametrize("N", [32, 96, 512])
def test_kpad_smem_plan_fits(K, N):
    from poet_tpu_torch.tools.bench_kpad import kpad_plan

    if K > N:
        return
    for wg in (2, 4):
        plan = kpad_plan(960, N, K, 66, wg)
        assert plan["kp"] % 16 == 0 and plan["kp"] - 16 < K <= plan["kp"]
        assert plan["n_wg"] * plan["wg_n"] >= N > (plan["n_wg"] - 1) * plan["wg_n"]
        assert plan["tma_blocks"] + plan["zero_blocks"] == plan["n_wg"] * plan["wg_n"] // 64
        assert plan["smem"] <= 232448


def test_kpad_refuses_unknown_design():
    from poet_tpu_torch.tools.bench_kpad import KPAD_CHAIN, kpad_plan

    a = torch.zeros((32, 16), dtype=torch.bfloat16)
    b = torch.zeros((16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="warpgroups"):
        KPAD_CHAIN(a, b, 2, 1, 3)
    with pytest.raises(ValueError, match="warpgroups"):
        kpad_plan(960, 512, 128, 66, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        KPAD_CHAIN(a, b, 2, 1, 4)
    assert KPAD_CHAIN.launches == 0


# ---- the forward's variants on a staged slab ----
@pytest.mark.parametrize("D", [8, 16, 24, 32, 64, 256])
@pytest.mark.parametrize("S", [1, 19, 255, 256, 257, 1600, 6380])
def test_slab_plan_stages_every_token_once(S, D):
    from poet_tpu_torch.tools.bench_v3_variants import plan_slab

    p = plan_slab(S, D)
    box, n = p["box_tokens"], p["n_boxes"]
    assert 1 <= box <= 256
    assert n == -(-S // 256)                                # as few boxes as 256 tokens allow
    staged = np.zeros(n * box, int)
    for k in range(n):
        assert (k * box * D * 2) % 128 == 0                 # each box's destination
        staged[k * box:(k + 1) * box] += 1
    assert (staged == 1).all() and n * box >= S > (n - 1) * box   # tail: padding past S
    assert p["slab_bytes"] == n * box * D * 2 and p["smem"] == 128 + p["slab_bytes"] + 16


def test_slab_plan_at_the_pyramids():
    from poet_tpu_torch.ops.deform_attn_cuda import SMEM_OPTIN_MAX
    from poet_tpu_torch.tools.bench_v3_variants import plan_slab

    flagship, yolo = plan_slab(1600, 16), plan_slab(6380, 16)
    assert (flagship["box_tokens"], flagship["n_boxes"], flagship["slab_bytes"]) == (232, 7, 51968)
    assert (yolo["box_tokens"], yolo["n_boxes"], yolo["slab_bytes"]) == (256, 25, 204800)
    assert yolo["smem"] <= SMEM_OPTIN_MAX < plan_slab(7300, 16)["smem"]


def query_items(Q, D, variant, threads=512):
    """The CTA's walk over its (b, h)'s queries (the kernel's item loop, at
    its kThreads = 512): for each thread, its items in order, each a
    (queries, channel slice) pair; qt256 takes two queries an item."""
    qpt = 2 if variant == "qt256" else 1
    chunks = D // 8
    items = -(-Q // qpt) * chunks
    walk = []
    for tid in range(threads):
        mine = []
        for i in range(tid, items, threads):
            qg, c = divmod(i, chunks)
            mine.append((tuple(q for q in range(qg * qpt, qg * qpt + qpt) if q < Q), c))
        walk.append(mine)
    return walk


@pytest.mark.parametrize("variant", ["base", "qt256"])
@pytest.mark.parametrize("Q,D", [(1, 8), (37, 16), (1600, 16), (513, 32)])
def test_query_passes_take_every_item_once(variant, Q, D):
    walk = query_items(Q, D, variant)
    assert len(walk) == 512
    items = sorted((q, c) for mine in walk for qs, c in mine for q in qs)
    assert items == [(q, c) for q in range(Q) for c in range(D // 8)]
    per = 2 if variant == "qt256" else 1
    assert all(len(qs) <= per for mine in walk for qs, _ in mine)


def _staged_walk(value, shapes, locs, attn, variant):
    """The kernel's route in numpy, f32 arithmetic: per (b, h) the slab as
    the TMA boxes land it (tokens past S zero), then the CTA's items, each a
    (query, 8-channel slice), summing the corners read from the slab."""
    from poet_tpu_torch.tools.bench_v3_variants import plan_slab

    f32 = np.float32
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = locs.shape
    plan = plan_slab(S, D)
    out = np.zeros((B, Q, H, D), np.float32)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    for b in range(B):
        for h in range(H):
            slab = np.zeros((plan["n_boxes"] * plan["box_tokens"], D), np.float32)
            for k in range(plan["n_boxes"]):
                lo = k * plan["box_tokens"]
                hi = min(S, lo + plan["box_tokens"])
                slab[lo:hi] = value[b, lo:hi, h]
            for mine in query_items(Q, D, variant):
                for qs, c in mine:
                    for q in qs:
                        acc = np.zeros(8, np.float32)
                        for l, (hl, wl) in enumerate(shapes):
                            for p in range(P):
                                x = f32(locs[b, q, h, l, p, 0]) * f32(wl) - f32(0.5)
                                y = f32(locs[b, q, h, l, p, 1]) * f32(hl) - f32(0.5)
                                if not (x > -1 and x < wl and y > -1 and y < hl):
                                    continue
                                a = f32(attn[b, q, h, l, p])
                                x0, y0 = np.floor(x), np.floor(y)
                                tx, ty = x - x0, y - y0
                                for dy, wy in ((0, (f32(1) - ty) * a), (1, ty * a)):
                                    for dx, wx in ((0, f32(1) - tx), (1, tx)):
                                        xi, yi = int(x0) + dx, int(y0) + dy
                                        if 0 <= xi < wl and 0 <= yi < hl:
                                            tok = starts[l] + yi * wl + xi
                                            acc += f32(wx * wy) * slab[tok, 8 * c:8 * c + 8]
                        out[b, q, h, 8 * c:8 * c + 8] = acc
    return out.reshape(B, Q, H * D)


@pytest.mark.parametrize("variant", ["base", "qt256"])
def test_staged_walk_matches_pallas_v3_interpret(rng, variant):
    """The staged-slab walk (two boxes at S = 300: the tail box's padding)
    against JAX's TPU forward kernel in interpret mode, and the variant's
    plain version against both."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas_v3 import ms_deform_attn_pallas_v3
    from poet_tpu_torch.tools import bench_v3_variants as bv

    shapes = ((12, 20), (6, 10))                            # S = 300: boxes of 152 tokens
    value, shapes, locs, w = _make_inputs(rng, B=1, Q=5, H=2, D=16, shapes=shapes)
    assert bv.plan_slab(value.shape[1], 16)["n_boxes"] == 2
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ms_deform_attn_pallas_v3(jnp.asarray(value), shapes, jnp.asarray(locs),
                                                   jnp.asarray(w)))
    got = _staged_walk(value, shapes, locs, w, variant)
    np.testing.assert_allclose(got, want, atol=V3_ATOL)
    plain = bv.ms_deform_attn_variant(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                      torch.from_numpy(w), variant)
    np.testing.assert_allclose(plain.numpy(), got, atol=V3_ATOL)
    assert bv.MS_DEFORM_ATTN_VARIANT.launches == 0 and bv.VARIANTS_LIB._lib is None


def test_variant_plain_version_takes_any_slab_on_the_cpu():
    """Over the card's budget, the CPU still runs the plain version."""
    from poet_tpu_torch.tools.bench_v3_variants import ms_deform_attn_variant, plan_slab

    shapes = ((73, 100),)
    assert plan_slab(7300, 16)["smem"] > 232448
    g = torch.Generator().manual_seed(3)
    value = torch.randn((1, 7300, 1, 16), generator=g).bfloat16()
    locs = torch.rand((1, 3, 1, 1, 4, 2), generator=g)
    attn = torch.rand((1, 3, 1, 1, 4), generator=g)
    out = ms_deform_attn_variant(value, shapes, locs, attn, "base")
    assert out.shape == (1, 3, 16) and torch.isfinite(out.float()).all()


def test_library_keys_follow_the_new_headers():
    """A change to the wgmma or TMA helpers rebuilds every library that reads them."""
    from poet_tpu_torch.ops.cuda_build import KPAD_LIB, V2_LIB, VARIANTS_LIB, local_includes

    def headers(lib):
        return [p.name for p in local_includes(lib.source)][1:]

    assert headers(KPAD_LIB) == ["tma_sm90.cuh", "wgmma_sm90.cuh"]
    assert headers(V2_LIB) == ["tma_sm90.cuh"]
    assert headers(VARIANTS_LIB) == ["ms_deform_attn_point.cuh", "tma_sm90.cuh", "mma_sm90.cuh"]
