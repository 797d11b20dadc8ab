"""The train step's pieces against `poet_tpu`, on the CPU.

Same numpy inputs to both packages, f32:
  * the JV solver, assignment for assignment (random, tied, BIG_COST-padded);
  * box math, `match_poses` in all three bbox modes, every loss of
    `compute_losses` (6d, quat, silho_quat, aleatoric), the SO(3) log map;
  * the optimizer: the StepLR schedule, optax's clip, AdamW, SGD and
    MultiSteps on a shared gradient stream, and what it refuses;
  * dropout's keep fraction and scale, the MHA mask shared over batch and
    heads, and the host NaN guard.
The whole train step of the slice is in tests/test_torch_train.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-3
# losses: the same f32 sums in other orders, relative
LOSS_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Hungarian (JV)
# ---------------------------------------------------------------------------

def _costs(rng, kind):
    if kind == "random":
        return rng.normal(size=(6, 10, 10)).astype(np.float32) * 10
    if kind == "ties":       # few distinct values: many optimal assignments
        return rng.integers(0, 3, size=(6, 10, 10)).astype(np.float32)
    if kind == "padded":     # rectangular problems embedded with BIG_COST
        c = np.full((6, 10, 10), 1e6, np.float32)
        for b, (r, k) in enumerate([(7, 4), (10, 3), (2, 9), (5, 5), (1, 1), (10, 10)]):
            c[b, :r, :k] = rng.integers(0, 4, size=(r, k))
        return c
    return np.zeros((3, 10, 10), np.float32)   # "all_equal"


@pytest.mark.parametrize("kind", ["random", "ties", "padded", "all_equal"])
def test_hungarian_assignment_identical_to_jax(rng, kind):
    from poet_tpu.ops.hungarian import hungarian as jhungarian
    from poet_tpu_torch.ops.hungarian import hungarian

    cost = _costs(rng, kind)
    want = np.asarray(jhungarian(jnp.asarray(cost)))
    got = hungarian(_t(cost))
    assert got.dtype == torch.int32 and tuple(got.shape) == cost.shape[:-1]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(hungarian(_t(cost[0])).numpy(), want[0])


# ---------------------------------------------------------------------------
# Boxes, matcher, rotations, criterion
# ---------------------------------------------------------------------------

def test_box_ops_match_jax(rng):
    from poet_tpu.utils import boxes as jb
    from poet_tpu_torch.utils import boxes as pb

    cxcywh = rng.uniform(0.1, 0.9, size=(7, 4)).astype(np.float32)
    cxcywh[:, 2:] = rng.uniform(0.05, 0.5, size=(7, 2))
    xyxy_j = np.asarray(jb.box_cxcywh_to_xyxy(jnp.asarray(cxcywh)))
    xyxy_p = pb.box_cxcywh_to_xyxy(_t(cxcywh)).numpy()
    np.testing.assert_allclose(xyxy_p, xyxy_j, rtol=1e-6, atol=1e-7)
    want = np.asarray(jb.generalized_box_iou(jnp.asarray(xyxy_j[:4]), jnp.asarray(xyxy_j[2:])))
    got = pb.generalized_box_iou(_t(xyxy_j[:4]), _t(xyxy_j[2:])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _match_inputs(rng, mode):
    Bm, Q = 4, 10
    tgt = rng.uniform(0.2, 0.7, size=(Bm, Q, 4)).astype(np.float32)
    tgt[..., 2:] = rng.uniform(0.05, 0.2, size=(Bm, Q, 2))
    labels = rng.integers(1, 6, size=(Bm, Q)).astype(np.int32)
    n_tgt = np.array([10, 6, 3, 1], np.int32)
    n_pred = np.array([10, 8, 2, 1], np.int32)
    perm = np.stack([rng.permutation(Q) for _ in range(Bm)])
    pred = np.take_along_axis(tgt, perm[..., None], 1)
    pred_cls = np.take_along_axis(labels, perm, 1)
    if mode == "backbone":   # detections near the targets, some far, some misclassified
        pred = pred + rng.normal(scale=0.03, size=pred.shape).astype(np.float32)
        pred[:, ::4, :2] += 0.3
        pred_cls[:, ::3] = 7
    for b in range(Bm):
        tgt[b, n_tgt[b]:] = -1.0
        labels[b, n_tgt[b]:] = -1
        pred[b, n_pred[b]:] = -1.0
        pred_cls[b, n_pred[b]:] = -1
    return pred, pred_cls, tgt, labels, n_pred, n_tgt


@pytest.mark.parametrize("mode", ["gt", "gt_identity", "jitter", "backbone"])
def test_match_poses_matches_jax(rng, mode):
    from poet_tpu.models.matcher import match_poses as jmatch
    from poet_tpu_torch.models.matcher import match_poses

    pred, pred_cls, tgt, labels, n_pred, n_tgt = _match_inputs(rng, mode)
    if mode == "gt_identity":            # queries built from the targets in order
        pred, pred_cls, n_pred = tgt.copy(), labels.copy(), n_tgt.copy()
    bbox_mode = "gt" if mode == "gt_identity" else mode
    args = (pred, pred_cls, tgt, labels, n_pred, n_tgt)
    want = jmatch(*(jnp.asarray(a) for a in args), bbox_mode=bbox_mode, giou_thresh=0.3)
    got = match_poses(*(_t(a) for a in args), bbox_mode=bbox_mode, giou_thresh=0.3)
    np.testing.assert_array_equal(got.tgt_idx.numpy(), np.asarray(want.tgt_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.num_matched) == int(want.num_matched)
    if mode == "gt_identity":
        np.testing.assert_array_equal(got.tgt_idx.numpy(), np.tile(np.arange(10), (4, 1)))
    if mode == "backbone":               # the post-filter removed some matches
        assert int(got.num_matched) < int((np.minimum(n_pred, n_tgt)).sum())


def test_pairwise_diag_giou_matches_jax(rng):
    from poet_tpu.models.matcher import _pairwise_diag_giou
    from poet_tpu_torch.models.matcher import pairwise_diag_giou

    a, _, b, _, _, _ = _match_inputs(rng, "backbone")
    np.testing.assert_allclose(pairwise_diag_giou(_t(a), _t(b)).numpy(),
                               np.asarray(_pairwise_diag_giou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


def _random_rotations(rng, n):
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[:, :, 0] *= np.linalg.det(q)[:, None]
    return q.astype(np.float32)


def test_so3_log_map_matches_jax(rng):
    from poet_tpu.utils.rotations import so3_log_map as jlog
    from poet_tpu_torch.utils.rotations import so3_log_map

    R = _random_rotations(rng, 64)
    R[0] = np.eye(3)                     # the tiny-sin Taylor branch
    R[1] = np.diag([1.0, -1.0, -1.0])    # angle pi: the acos extrapolation
    np.testing.assert_allclose(so3_log_map(_t(R)).numpy(), np.asarray(jlog(jnp.asarray(R))),
                               rtol=1e-5, atol=1e-5)


def _criterion_inputs(rng, mode):
    L_, Bc, Q = 3, 2, 10
    out = {"translations": rng.normal(size=(L_, Bc, Q, 3)).astype(np.float32)}
    if mode in ("6d", "aleatoric"):
        out["rotations"] = _random_rotations(rng, L_ * Bc * Q).reshape(L_, Bc, Q, 3, 3)
    else:
        q = rng.normal(size=(L_, Bc, Q, 4)).astype(np.float32)
        out["rotations"] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    if mode == "aleatoric":
        out["translations_aleatoric"] = rng.normal(scale=0.5, size=(L_, Bc, Q, 3)).astype(
            np.float32)
        out["rotations_aleatoric"] = rng.normal(scale=0.5, size=(L_, Bc, Q, 3)).astype(
            np.float32)
    tq = rng.normal(size=(Bc, Q, 4)).astype(np.float32)
    targets = {
        "relative_position": rng.normal(size=(Bc, Q, 3)).astype(np.float32),
        "relative_rotation": _random_rotations(rng, Bc * Q).reshape(Bc, Q, 3, 3),
        "relative_quaternions": tq / np.linalg.norm(tq, axis=-1, keepdims=True),
    }
    tgt_idx = np.stack([rng.permutation(Q) for _ in range(Bc)]).astype(np.int32)
    valid = np.arange(Q)[None, :] < np.array([[7], [3]])
    return out, targets, tgt_idx, valid


@pytest.mark.parametrize("mode", ["6d", "quat", "silho_quat", "aleatoric"])
def test_compute_losses_matches_jax(rng, mode):
    from poet_tpu.models import criterion as jcrit
    from poet_tpu.models.matcher import MatchResult as JMatch
    from poet_tpu_torch.models import criterion as crit
    from poet_tpu_torch.models.matcher import MatchResult

    out, targets, tgt_idx, valid = _criterion_inputs(rng, mode)
    rot_mode = "6d" if mode == "aleatoric" else mode
    want = jcrit.compute_losses({k: jnp.asarray(v) for k, v in out.items()},
                                {k: jnp.asarray(v) for k, v in targets.items()},
                                JMatch(jnp.asarray(tgt_idx), jnp.asarray(valid)),
                                rotation_mode=rot_mode, aleatoric=mode == "aleatoric")
    got = crit.compute_losses({k: _t(v) for k, v in out.items()},
                              {k: _t(v) for k, v in targets.items()},
                              MatchResult(_t(tgt_idx), _t(valid)),
                              rotation_mode=rot_mode, aleatoric=mode == "aleatoric")
    assert list(got) == list(want) == ["loss_trans_0", "loss_rot_0", "loss_trans_1",
                                       "loss_rot_1", "loss_trans", "loss_rot"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(crit.weighted_total(got, 2.0, 0.5)),
                               float(jcrit.weighted_total(want, 2.0, 0.5)), rtol=LOSS_RTOL)


def test_losses_finite_with_zero_matches(rng):
    from poet_tpu_torch.models import criterion as crit
    from poet_tpu_torch.models.matcher import MatchResult

    out, targets, tgt_idx, valid = _criterion_inputs(rng, "6d")
    losses = crit.compute_losses({k: _t(v) for k, v in out.items()},
                                 {k: _t(v) for k, v in targets.items()},
                                 MatchResult(_t(tgt_idx), torch.zeros(valid.shape, dtype=bool)))
    assert all(float(v) == 0.0 for v in losses.values())


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    from poet_tpu.engine.train import make_lr_schedule as jsched
    from poet_tpu_torch.engine.train import make_lr_schedule

    for args in [(2e-4, 2, 10), (1e-3, 1, 3), (2e-4, 100, 0)]:
        j, p = jsched(*args), make_lr_schedule(*args)
        for step in range(0, 70, 3):
            assert p(step) == pytest.approx(float(j(step)), rel=1e-12)


@pytest.mark.parametrize("sgd", [False, True], ids=["adamw", "sgd"])
def test_resumed_optimizer_follows_the_schedule(sgd):
    """After `load_state_dict` the rates still follow StepLR: torch's load
    replaces its param groups, and the rates are set on the new ones (they
    were set on the old dicts, so a resume kept the saved rate past every
    drop)."""
    from poet_tpu_torch.config import PoETConfig
    from poet_tpu_torch.engine.train import Optimizer

    cfg = PoETConfig()
    cfg.optim.lr, cfg.optim.lr_drop, cfg.optim.sgd, cfg.optim.clip_max_norm = 1.0, 1, sgd, 0.0
    model = torch.nn.Linear(2, 2)

    def update(opt):
        model.weight.grad, model.bias.grad = torch.ones(2, 2), torch.ones(2)
        opt.step()
        return opt.torch_opt.param_groups[0]["lr"]

    first = Optimizer(cfg, model, steps_per_epoch=1)
    assert update(first) == 1.0
    resumed = Optimizer(cfg, model, steps_per_epoch=1)
    resumed.load_state_dict(first.state_dict())
    assert [update(resumed) for _ in range(2)] == pytest.approx([0.1, 0.01], rel=1e-12)


class _Toy(torch.nn.Module):
    """Two parameters under port-style names: 'main' and 'linear_proj'."""

    def __init__(self, w, b):
        super().__init__()
        self.layer = torch.nn.Linear(3, 4)
        self.sampling_offsets = torch.nn.Linear(4, 1, bias=False)
        with torch.no_grad():
            self.layer.weight.copy_(_t(w))
            self.layer.bias.copy_(_t(b))
            self.sampling_offsets.weight.fill_(0.5)


@pytest.mark.parametrize("sgd", [False, True], ids=["adamw", "sgd"])
@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax_on_shared_grads(rng, sgd, accum):
    """The same gradient stream through `make_optimizer` of both packages:
    clip (the first grads are below the max norm, the rest above), per-group
    lr, StepLR drops every epoch (2 micro-batches), AdamW / SGD, MultiSteps.
    Accumulation runs unclipped: a clip normalizes the mean and the sum of
    the micro-batch gradients alike, so only then does SGD tell them apart."""
    from poet_tpu.config import PoETConfig as JCfg
    from poet_tpu.engine.train import make_optimizer as jmake
    from poet_tpu_torch.config import PoETConfig
    from poet_tpu_torch.engine.train import make_optimizer

    jcfg, cfg = JCfg(), PoETConfig()
    for c in (jcfg, cfg):
        c.optim.lr, c.optim.lr_drop, c.optim.sgd = LR, 1, sgd
        c.optim.grad_accum_steps = accum
        c.optim.clip_max_norm = 0.5 if accum == 1 else 0.0
    w = rng.normal(size=(4, 3)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    params = {"params": {"layer": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)},
                         "sampling_offsets": {"kernel": jnp.full((4, 1), 0.5, jnp.float32)}}}
    tx = jmake(jcfg, params, steps_per_epoch=2)
    state = tx.init(params)
    model = _Toy(w, b)
    opt = make_optimizer(cfg, model, steps_per_epoch=2)
    for i in range(8):
        scale = 0.01 if i == 0 else 3.0
        gw = rng.normal(size=(4, 3)).astype(np.float32) * scale
        gb = rng.normal(size=(4,)).astype(np.float32) * scale
        go = rng.normal(size=(1, 4)).astype(np.float32) * scale
        grads = {"params": {"layer": {"kernel": jnp.asarray(gw.T), "bias": jnp.asarray(gb)},
                            "sampling_offsets": {"kernel": jnp.asarray(go.T)}}}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        model.layer.weight.grad, model.layer.bias.grad = _t(gw), _t(gb)
        model.sampling_offsets.weight.grad = _t(go)
        assert opt.step() == ((i + 1) % accum == 0)
        p = params["params"]
        np.testing.assert_allclose(model.layer.weight.detach().numpy(),
                                   np.asarray(p["layer"]["kernel"]).T, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(model.layer.bias.detach().numpy(),
                                   np.asarray(p["layer"]["bias"]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(model.sampling_offsets.weight.detach().numpy(),
                                   np.asarray(p["sampling_offsets"]["kernel"]).T,
                                   rtol=1e-6, atol=1e-9)
    assert opt.updates == 8 // accum


def test_clip_is_optax_not_clip_grad_norm():
    """At the reference clip_max_norm 0.1: optax divides by the norm, torch's
    clip_grad_norm_ by norm + 1e-6 — the port follows optax."""
    from poet_tpu_torch.config import PoETConfig
    from poet_tpu_torch.engine.train import make_optimizer

    cfg = PoETConfig()
    cfg.optim.sgd, cfg.optim.weight_decay, cfg.optim.lr = True, 0.0, 1.0
    model = _Toy(np.zeros((4, 3), np.float32), np.zeros(4, np.float32))
    g = [torch.full((4, 3), 0.1), torch.full((4,), 0.2), torch.full((1, 4), 0.3)]
    for p, gp in zip(model.parameters(), g):
        p.grad = gp.clone()
    norm = float(torch.sqrt(sum((x ** 2).sum() for x in g)))
    assert norm > 0.1
    want = [-(x / norm * 0.1) * s for x, s in zip(g, (1.0, 1.0, 0.1))]
    before = [p.detach().clone() for p in model.parameters()]
    make_optimizer(cfg, model, steps_per_epoch=1).step()
    for p, p0, w in zip(model.parameters(), before, want):
        np.testing.assert_allclose((p.detach() - p0).numpy(), w.numpy(), rtol=1e-6)
    torch_clipped = [x / (norm + 1e-6) * 0.1 for x in g]
    assert not np.allclose(torch_clipped[0].numpy(), (g[0] / norm * 0.1).numpy(),
                           rtol=1e-7, atol=0)


def test_optimizer_refuses_bf16_weights_and_unported_options():
    """bf16 master weights raise. The options this refused until they were
    ported (mu_bf16, calibrate) now build their optimizer and groups: the
    bf16 first moment's AdamW, and calibrate's heads-only 'main' group
    (nothing here is an aleatoric head: every tensor frozen)."""
    from poet_tpu_torch.config import PoETConfig
    from poet_tpu_torch.engine.train import AdamWMuBf16, label_params, make_optimizer

    model = _Toy(np.zeros((4, 3), np.float32), np.zeros(4, np.float32))
    cfg = PoETConfig()
    cfg.optim.mu_bf16 = True
    assert isinstance(make_optimizer(cfg, model, 1).torch_opt, AdamWMuBf16)
    cfg = PoETConfig()
    cfg.model.calibrate = True
    assert set(label_params(model, cfg).values()) == {"frozen"}
    model.layer.weight.data = model.layer.weight.data.bfloat16()
    with pytest.raises(TypeError, match="f32 master weights"):
        make_optimizer(PoETConfig(), model, 1)


def test_dropout_keep_fraction_and_scale():
    from poet_tpu_torch.models.transformer import dropout

    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    # binomial(200k, 0.9): 5 sigma = 0.0034
    assert abs(float(kept.float().mean()) - 0.9) < 0.0034
    assert torch.all(y[kept] == torch.tensor(1.0) / torch.tensor(0.9))


def test_mha_dropout_mask_shared_across_batch_and_heads():
    """flax broadcast_dropout: one (Q, K) mask for every batch element and
    head. With an identity value path and constant attention, the output's
    per-key contributions expose the mask."""
    from poet_tpu_torch.models.transformer import MultiheadAttention

    Bq, Qn, C, H = 3, 6, 8, 4
    mha = MultiheadAttention(C, H, dropout=0.5).train()
    with torch.no_grad():
        mha.in_proj_weight.zero_()
        mha.in_proj_bias.zero_()
        mha.in_proj_weight[2 * C:].copy_(torch.eye(C))      # v = x
        mha.out_proj.weight.copy_(torch.eye(C))
        mha.out_proj.bias.zero_()
    # key k carries value 2^k in every channel: the output's value, times
    # Qn (uniform attention), times keep prob, is the bitmask of kept keys
    x = torch.tensor([2.0 ** k for k in range(Qn)])[None, :, None].expand(Bq, Qn, C)
    out = mha(x, x, x, torch.Generator().manual_seed(3))
    bits = torch.round(out * Qn * 0.5).to(torch.int64)    # (B, Q, C)
    assert torch.all(bits == bits[0:1, :, 0:1])           # same for every batch and head
    assert len(set(bits[0, :, 0].tolist())) > 1           # and not all-or-nothing per query
    with pytest.raises(ValueError, match="Generator"):
        mha(x, x, x)
    eval_out = mha.eval()(x, x, x).detach()
    np.testing.assert_allclose(eval_out.numpy(), np.full((Bq, Qn, C), (2 ** Qn - 1) / Qn),
                               rtol=1e-6)


def test_nan_guard_raises_on_host():
    from poet_tpu_torch.engine.train import fetch_metrics

    assert fetch_metrics({"loss": torch.tensor(1.5)}) == {"loss": 1.5}
    with pytest.raises(FloatingPointError):
        fetch_metrics({"loss": torch.tensor(float("nan")), "grad_norm": torch.tensor(1.0)})


def test_profile_trace_device_time_by_class():
    """The profiler driver's reading of a Chrome trace: busy time is the
    union of device intervals, classes sum each interval, CPU events and
    host-side ranges are left out."""
    from poet_tpu_torch.tools.profile_train import device_time_by_class, kernel_class

    events = [
        {"ph": "X", "cat": "kernel", "name": "void ms_deform_attn_dvalue_kernel<float>",
         "ts": 0.0, "dur": 400.0},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16bf16", "ts": 300.0, "dur": 200.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel",
         "ts": 2000.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 5000.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step", "ts": 0.0,
         "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0.0},
    ]
    busy, by_class = device_time_by_class(events, steps=2)
    # union: [0, 500) + [1000, 1100) + [2000, 2050) = 650 us over 2 steps
    assert busy == pytest.approx(0.325)
    assert by_class == pytest.approx({"d_value kernel": 0.2, "GEMM": 0.1,
                                      "memcpy / memset": 0.05, "elementwise": 0.025})
    assert kernel_class("void (anonymous namespace)::ms_deform_attn_dloc_kernel<__nv_bfloat16>") \
        == "d_loc/d_attn kernel"
    assert kernel_class("cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s1688gemm>") \
        == "conv (cuDNN)"
    assert kernel_class("something_new") == "other"
