"""The weight bridge: `load_jax_params` fills the port's PoET exactly from a
`poet_tpu` parameter tree, and the port's state_dict, read back through the
existing reference-checkpoint converters (`convert_poet_checkpoint`,
`convert_resnet_fpn`), reproduces that tree leaf for leaf."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poet_tpu.utils.torch_import import (
    convert_poet_checkpoint,
    convert_resnet_fpn,
    state_dict_to_numpy,
)
from poet_tpu_torch.utils.jax_params import load_jax_params
from tests.test_torch_modules import one_torch_thread, random_tree  # noqa: F401  (autouse)

ENC, DEC, HEADS = 2, 2, 4


def _configs():
    from poet_tpu.config import PoETConfig
    from poet_tpu_torch.flagship import flagship_config

    jcfg = PoETConfig()
    tcfg = flagship_config("float32")
    for cfg in (jcfg, tcfg):
        cfg.model.enc_layers, cfg.model.dec_layers = ENC, DEC
        cfg.model.hidden_dim, cfg.model.nheads, cfg.model.dim_feedforward = 64, HEADS, 128
    jcfg.model.enc_deform_impl = "gather"
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_tree():
    """A full PoET tree (ResNet-50-FPN included) with seeded random values."""
    from poet_tpu.models import build_model
    from poet_tpu_torch.flagship import flagship_batch

    jcfg, _ = _configs()
    model = build_model(jcfg)
    images, pad_mask, targets = flagship_batch(1, 64, 64)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(pad_mask),
        {k: jnp.asarray(v) for k, v in targets.items()}))
    tree = random_tree(shapes, np.random.default_rng(1))["params"]
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model():
    from poet_tpu_torch.models import build_model

    return build_model(_configs()[1])


def test_load_uses_every_leaf_and_sets_every_tensor(jax_tree):
    model = _port_model()
    for v in model.state_dict().values():
        v.fill_(np.nan)
    load_jax_params(model, {"params": jax_tree})
    sd = model.state_dict()
    assert all(torch.isfinite(v).all() for v in sd.values())
    # flax MHA has 8 leaves per decoder layer, torch's packed layout 4
    assert len(jax.tree_util.tree_leaves(jax_tree)) == len(sd) + 4 * DEC
    assert (sum(x.size for x in jax.tree_util.tree_leaves(jax_tree))
            == sum(v.numel() for v in sd.values()))
    np.testing.assert_array_equal(
        sd["backbone.backbone.body.layer2.0.downsample.0.weight"].numpy(),
        jax_tree["backbone"]["fpn_body"]["body"]["layer2_0"]["downsample_conv"]["kernel"]
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["transformer.decoder.layers.1.self_attn.in_proj_weight"][64:128].numpy(),
        jax_tree["transformer"]["decoder_layer_1"]["self_attn"]["key"]["kernel"]
        .reshape(64, 64).T)


def test_roundtrip_through_reference_converters(jax_tree):
    model = load_jax_params(_port_model(), jax_tree)
    sd = state_dict_to_numpy(model.state_dict())
    back = convert_poet_checkpoint(sd, enc_layers=ENC, dec_layers=DEC, nheads=HEADS)
    back["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    flat_a = jax.tree_util.tree_leaves_with_path(jax_tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_load_rejects_missing_and_unused_leaves(jax_tree):
    tree = dict(jax_tree)
    tree.pop("rotation_head_1")
    with pytest.raises(KeyError, match="rotation_head_1"):
        load_jax_params(_port_model(), tree)
    tree = dict(jax_tree, extra_head={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra_head"):
        load_jax_params(_port_model(), tree)
    bad = jax.tree_util.tree_map(lambda x: x, jax_tree)
    bad["transformer"]["level_embed"] = np.zeros((3, 64), np.float32)
    with pytest.raises(ValueError, match="level_embed"):
        load_jax_params(_port_model(), bad)


def test_seeded_init_is_deterministic_and_follows_the_jax_initializers():
    from poet_tpu_torch.utils.init import init_weights

    a = init_weights(_port_model(), seed=3).state_dict()
    b = init_weights(_port_model(), seed=3).state_dict()
    c = init_weights(_port_model(), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transformer.level_embed"], c["transformer.level_embed"])
    attn = "transformer.encoder.layers.0.self_attn."
    assert torch.count_nonzero(a[attn + "sampling_offsets.weight"]) == 0
    assert torch.count_nonzero(a[attn + "attention_weights.weight"]) == 0
    assert torch.count_nonzero(a[attn + "attention_weights.bias"]) == 0
    from poet_tpu.models.transformer import _grid_init_bias

    np.testing.assert_array_equal(a[attn + "sampling_offsets.bias"].numpy(),
                                  _grid_init_bias(HEADS, 4, 4))
    bn = "backbone.backbone.body.layer1.0.bn1."
    assert torch.all(a[bn + "weight"] == 1) and torch.all(a[bn + "running_var"] == 1)
    # he_normal on a 3x3x64 bottleneck conv vs lecun_normal on the 7x7x3 stem
    w = a["backbone.backbone.body.layer1.0.conv2.weight"]
    np.testing.assert_allclose(w.std().item(), np.sqrt(2 / (9 * 64)), rtol=0.05)
    assert w.abs().max() <= 2 * np.sqrt(2 / (9 * 64)) / 0.87962566103423978 + 1e-6
    stem = a["backbone.backbone.body.conv1.weight"]
    np.testing.assert_allclose(stem.std().item(), np.sqrt(1 / (49 * 3)), rtol=0.05)
