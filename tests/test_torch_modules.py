"""Ported modules against their `poet_tpu` counterparts at small widths.

Each JAX module's parameter tree is filled with seeded random values (so no
zero-initialized projection hides a layout bug) and loaded into the port
module through `load_jax_params`; the same numpy inputs go through both.
f32 throughout; tolerances are stated per test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu_torch.utils.jax_params import load_jax_params

B, C, H, D, L, P = 2, 64, 4, 16, 4, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for the module. The suite runs in several
    processes at once, and an OpenMP pool per process oversubscribes the
    cores: a small train step then runs tens of times slower. The port's
    test files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
SHAPES = ((6, 8), (3, 4), (2, 2), (1, 1))
S = sum(h * w for h, w in SHAPES)


def random_tree(tree, rng, std=0.2):
    """Same structure, seeded values: norm scales near 1, the rest N(0, std)."""
    def fill(path, leaf):
        shape = np.shape(leaf)
        if getattr(path[-1], "key", None) == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (std * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def init_shapes(jm, *args):
    """The module's parameter tree as shapes (static args stay Python values)."""
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))


def t(x):
    return torch.from_numpy(np.asarray(x))


def _interpret():
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _pad_mask(rng):
    """(B, S) token pad mask that is not all False: image 1 padded on the
    right of every level."""
    m = np.zeros((B, S), bool)
    start = 0
    for h, w in SHAPES:
        lvl = np.zeros((h, w), bool)
        lvl[:, max(1, w - w // 3):] = True
        m[1, start:start + h * w] = lvl.reshape(-1)
        start += h * w
    return m


@pytest.mark.parametrize("impl,Q", [("gather", 7), ("fused", 7), ("fused", S)])
def test_msdeform_attn(rng, impl, Q):
    from poet_tpu.models.transformer import MSDeformAttn as JMSDeformAttn
    from poet_tpu_torch.models.transformer import MSDeformAttn

    query = rng.normal(size=(B, Q, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, size=(B, Q, L, 2)).astype(np.float32)
    src = rng.normal(size=(B, S, C)).astype(np.float32)
    mask = _pad_mask(rng)
    jm = JMSDeformAttn(C, L, H, P, impl=impl)
    args = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src), SHAPES, jnp.asarray(mask))
    with _interpret():
        params = random_tree(init_shapes(jm, *args), rng)
        want = np.asarray(jm.apply(params, *args))

    pm = load_jax_params(MSDeformAttn(C, L, H, P), params)
    got = pm(t(query), t(ref), t(src), SHAPES, t(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_encoder_layer(rng, impl):
    from poet_tpu.models.transformer import EncoderLayer as JEncoderLayer
    from poet_tpu_torch.models.transformer import EncoderLayer

    src = rng.normal(size=(B, S, C)).astype(np.float32)
    pos = rng.normal(size=(B, S, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, size=(B, S, L, 2)).astype(np.float32)
    mask = _pad_mask(rng)
    jm = JEncoderLayer(C, 128, L, H, P, impl=impl)
    args = (jnp.asarray(src), jnp.asarray(pos), jnp.asarray(ref), SHAPES,
            jnp.asarray(mask), True)
    with _interpret():
        params = random_tree(init_shapes(jm, *args), rng)
        want = np.asarray(jm.apply(params, *args))

    pm = load_jax_params(EncoderLayer(C, 128, L, H, P), params)
    got = pm(t(src), t(pos), t(ref), SHAPES, t(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_decoder_layer(rng):
    from poet_tpu.models.transformer import DecoderLayer as JDecoderLayer
    from poet_tpu_torch.models.transformer import DecoderLayer

    Q = 10
    tgt = rng.normal(size=(B, Q, C)).astype(np.float32)
    qpos = rng.normal(size=(B, Q, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, size=(B, Q, L, 2)).astype(np.float32)
    ref[:, -2:] = -1.0                       # dummy queries (boxes -1)
    src = rng.normal(size=(B, S, C)).astype(np.float32)
    mask = _pad_mask(rng)
    jm = JDecoderLayer(C, 128, L, H, P)      # JAX decoder default: one-hot 'mxu'
    args = (jnp.asarray(tgt), jnp.asarray(qpos), jnp.asarray(ref), jnp.asarray(src),
            SHAPES, jnp.asarray(mask), True)
    params = random_tree(init_shapes(jm, *args), rng)
    want = np.asarray(jm.apply(params, *args))

    pm = load_jax_params(DecoderLayer(C, 128, L, H, P), params)
    got = pm(t(tgt), t(qpos), t(ref), t(src), SHAPES, t(mask)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("enc_impl", ["gather", "fused"])
def test_deformable_transformer(rng, enc_impl):
    from poet_tpu.models.transformer import DeformableTransformer as JDT
    from poet_tpu_torch.models.transformer import DeformableTransformer

    Q = 10
    srcs = [rng.normal(size=(B, h, w, C)).astype(np.float32) for h, w in SHAPES]
    pos = [rng.normal(size=(B, h, w, C)).astype(np.float32) for h, w in SHAPES]
    masks = []
    for h, w in SHAPES:
        m = np.zeros((B, h, w), bool)
        m[1, :, max(1, w - w // 3):] = True
        masks.append(m)
    query_embed = rng.normal(size=(B, Q, 2 * C)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, size=(B, Q, 2)).astype(np.float32)
    jm = JDT(d_model=C, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
             dim_feedforward=128, num_feature_levels=L, enc_impl=enc_impl, remat=False)
    args = ([jnp.asarray(x) for x in srcs], [jnp.asarray(x) for x in masks],
            [jnp.asarray(x) for x in pos], jnp.asarray(query_embed), jnp.asarray(ref), True)
    with _interpret():
        params = random_tree(init_shapes(jm, *args), rng)
        hs, _, _ = jm.apply(params, *args)

    pm = load_jax_params(DeformableTransformer(
        d_model=C, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
        dim_feedforward=128, num_feature_levels=L), params)
    got, _, _ = pm([t(x) for x in srcs], [t(x) for x in masks], [t(x) for x in pos],
                   t(query_embed), t(ref))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(hs), atol=2e-4, rtol=2e-4)


def test_fpn_levels_and_nearest_upsampling(rng):
    """Restricted FPN at sizes that are not exact 2x multiples, where the
    half-pixel nearest resize differs from torch's legacy 'nearest'."""
    from poet_tpu.models.resnet_fpn import FPN as JFPN
    from poet_tpu_torch.models.resnet_fpn import FPN

    sizes = ((20, 18), (10, 9), (7, 5), (3, 2))
    feats = [rng.normal(size=(1, h, w, c)).astype(np.float32)
             for (h, w), c in zip(sizes, (256, 512, 1024, 2048))]
    jm = JFPN(256, levels=("2", "3", "pool"))
    jfeats = [jnp.asarray(f) for f in feats]
    params = random_tree(init_shapes(jm, jfeats), rng, 0.02)
    want = jm.apply(params, jfeats)

    pm = load_jax_params(FPN(256, levels=("2", "3", "pool")), params)
    got = pm([t(f).permute(0, 3, 1, 2) for f in feats])
    assert sorted(got) == sorted(want) == ["2", "3", "pool"]
    for k in want:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4, rtol=1e-4, err_msg=k)


def test_resnet_fpn_with_frozen_bn_statistics(rng):
    """Full-depth ResNet-50-FPN with non-identity FrozenBN statistics (the
    seeded init's are identity, so only this exercises the fold)."""
    from poet_tpu.models.resnet_fpn import ResNetFPN as JResNetFPN
    from poet_tpu_torch.models.resnet_fpn import ResNetFPN

    levels = ("2", "3", "pool")
    images = rng.uniform(size=(1, 96, 64, 3)).astype(np.float32)
    jm = JResNetFPN(levels=levels)
    shapes = init_shapes(jm, jnp.asarray(images))

    def fill(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name == "running_var":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        if name == "weight":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "kernel":         # variance-preserving: std 1/sqrt(fan_in)
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    want = jm.apply(params, jnp.asarray(images))
    got = load_jax_params(ResNetFPN(levels=levels), params)(t(images))
    for k in levels:
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(got[k].detach().numpy() / scale, w / scale,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("hw,out_hw", [((45, 37), (3, 5)), ((128, 128), (8, 8)),
                                       ((480, 640), (4, 5)), ((50, 70), (13, 9))])
def test_downsample_mask(rng, hw, out_hw):
    from poet_tpu.models.resnet_fpn import downsample_mask as jdown
    from poet_tpu_torch.models.resnet_fpn import downsample_mask

    m = np.zeros((3,) + hw, bool)
    m[0, :, hw[1] * 2 // 3:] = True
    m[1, hw[0] // 2:, :] = True
    m[2] = rng.uniform(size=hw) < 0.5
    want = np.asarray(jdown(jnp.asarray(m), out_hw))
    np.testing.assert_array_equal(downsample_mask(t(m), out_hw).numpy(), want)


def test_position_embedding_sine(rng):
    from poet_tpu.ops.embeddings import position_embedding_sine as jpos
    from poet_tpu_torch.ops.embeddings import position_embedding_sine

    m = np.zeros((2, 9, 13), bool)
    m[1, :, 9:] = True
    m[1, 7:, :] = True
    want = np.asarray(jpos(jnp.asarray(m), num_pos_feats=32))
    got = position_embedding_sine(t(m), num_pos_feats=32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bbox_embedding_sine(rng):
    from poet_tpu.ops.embeddings import bbox_embedding_sine as jbox
    from poet_tpu_torch.ops.embeddings import bbox_embedding_sine

    boxes = rng.uniform(0, 1, size=(2, 10, 4)).astype(np.float32)
    boxes[:, 7:] = -1.0                      # dummy slots
    want = np.asarray(jbox(jnp.asarray(boxes), num_pos_feats=8))
    got = bbox_embedding_sine(t(boxes), num_pos_feats=8).numpy()
    # sin/cos of arguments up to 2^7: f32 range reduction differs by ~1e-5
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_rotation_6d_to_matrix(rng):
    from poet_tpu.utils.rotations import rotation_6d_to_matrix as jrot
    from poet_tpu_torch.utils.rotations import rotation_6d_to_matrix

    x = rng.normal(size=(3, 10, 6)).astype(np.float32)
    got = rotation_6d_to_matrix(t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrot(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", ["ill_conditioned", "random"])
def test_group_norm_matches_flax_fast_variance(rng, case):
    """flax's GroupNorm takes var = E[x^2] - E[x]^2 (use_fast_variance). In a
    group whose spread is small against its mean that differs from a
    two-pass variance by far more than rounding: channel 0 below holds
    1000 and 1000.0625 (exact in f32, so both frameworks round alike), where
    flax's variance is exactly 0 (outputs +-31.25 at eps 1e-6) and the
    two-pass one 2^-10 (outputs +-1)."""
    import flax.linen as fnn

    from poet_tpu_torch.models.layers import GroupNorm

    if case == "ill_conditioned":
        # NHWC (1, 1, 2, 2): channel 0 holds 1000 and 1000.0625, channel 1 -3 and 5
        x = np.array([[1000.0, -3.0], [1000.0625, 5.0]], np.float32).reshape(1, 1, 2, 2)
        groups = 2
    else:
        x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
        groups = 8
    jm = fnn.GroupNorm(num_groups=groups, epsilon=1e-6)
    params = random_tree(init_shapes(jm, jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    pm = load_jax_params(GroupNorm(groups, x.shape[-1]), params)
    got = pm(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if case == "ill_conditioned":
        scale = np.asarray(params["params"]["scale"])[0]
        bias = np.asarray(params["params"]["bias"])[0]
        np.testing.assert_allclose(np.abs(want[0, 0, :, 0] - bias), 31.25 * abs(scale),
                                   rtol=1e-6)
