"""Tensor parallelism's rules and shards (`parallel/tp.py`), the layout's
checks (`parallel/mesh.py`) and `PoseServer(devices=...)`, in one process
on the CPU.

* `param_spec` on every `state_dict` key of the paper config against JAX's
  `poet_tpu/parallel/tp.py:param_spec` on the matching flax leaves, through
  the weight bridge's names and layouts (a torch (out, in) weight split by
  output is the (in, out) kernel split by its last axis; the packed
  `in_proj_weight` is the query, key and value kernels (C, H, hd) split by
  head);
* every shard of every tensor of the paper config, joined, is the tensor's
  bits; `shard_module` once per model process, the state dicts joined, is
  the full model's; a sharded Dense keeps the shard of its bias init;
* the decoder MHA's head shard: `load_jax_params` into a sharded module
  takes each of q, k and v's rows of JAX's (C, H, hd) kernels split by head,
  and `out_proj`'s columns of its (H, hd, C) kernel;
* the layout's checks: sizes that do not multiply to the processes, heads
  or FFN widths that do not divide by the model axis, raise;
* `PoseServer(devices=["cpu"] * 4)`, tracker mode, against JAX's `PoseServer`
  without a mesh (1e-5): `infer`, `stream` with a boxes function, and a
  batch that does not divide raising.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def paper_model():
    from poet_tpu_torch.flagship import flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    cfg = flagship_config("float32")
    return cfg, init_weights(build_model(cfg), seed=0)


def _jax_leaves(model):
    """Port state_dict key -> [(flax path 'a/b/leaf', how its spec maps)]:
    the bridge's rules (`utils/jax_params.py`)."""
    from poet_tpu_torch.models.layers import Dense
    from poet_tpu_torch.models.transformer import MultiheadAttention
    from poet_tpu_torch.utils.jax_params import flax_path

    out = {}
    for name, mod in model.named_modules():
        pre, path = f"{name}." if name else "", "/".join(("params",) + flax_path(name))
        if isinstance(mod, MultiheadAttention):
            out[pre + "in_proj_weight"] = [(f"{path}/{p}/kernel", "qkv_kernel")
                                           for p in ("query", "key", "value")]
            out[pre + "in_proj_bias"] = [(f"{path}/{p}/bias", "qkv_bias")
                                         for p in ("query", "key", "value")]
            out[pre + "out_proj.weight"] = [(f"{path}/out/kernel", "out_kernel")]
            out[pre + "out_proj.bias"] = [(f"{path}/out/bias", "bias")]
        elif isinstance(mod, Dense) and pre + "weight" not in out:
            out[pre + "weight"] = [(f"{path}/kernel", "kernel")]
            out[pre + "bias"] = [(f"{path}/bias", "bias")]
        else:
            for leaf, _ in list(mod.named_parameters(recurse=False)) + list(
                    mod.named_buffers(recurse=False)):
                out.setdefault(pre + leaf, [(f"{path}/{leaf}", "other")])
    return out


def _expected_jax_spec(spec, kind):
    """The JAX PartitionSpec a port Spec means on the flax leaf."""
    from jax.sharding import PartitionSpec as P

    if spec.dim is None:
        return P()
    return {("kernel", 0): P(None, "model"), ("kernel", 1): P("model", None),
            ("bias", 0): P("model"), ("qkv_kernel", 0): P(None, "model", None),
            ("qkv_bias", 0): P("model", None), ("out_kernel", 1): P("model", None, None),
            }[(kind, spec.dim)]


def test_param_spec_matches_jax_on_every_key(paper_model):
    from jax.sharding import PartitionSpec as P

    from poet_tpu.parallel.tp import param_spec as jax_spec
    from poet_tpu_torch.parallel.tp import Spec, param_spec

    _, model = paper_model
    leaves = _jax_leaves(model)
    keys = list(model.state_dict())
    assert set(keys) <= set(leaves)
    split = 0
    for k in keys:
        spec = param_spec(k)
        for path, kind in leaves[k]:
            assert jax_spec(path) == _expected_jax_spec(spec, kind), (k, path, spec)
        split += spec.dim is not None
        assert spec.chunks == (3 if k.endswith(("in_proj_weight", "in_proj_bias")) else 1) \
            or spec == Spec(), k
    # an encoder layer: 8 column (value_proj, sampling_offsets,
    # attention_weights, linear1: weight and bias) + 2 row (output_proj,
    # linear2); a decoder layer those and the MHA's in_proj (2) and out_proj
    assert split == 5 * 10 + 5 * 13
    assert jax_spec("params/backbone/fpn_body/conv1/kernel") == P()


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_shards_join_to_the_same_bits(paper_model, n):
    from poet_tpu_torch.parallel.tp import join_shards, param_spec, shard_tensor

    _, model = paper_model
    for k, v in model.state_dict().items():
        spec = param_spec(k)
        parts = [shard_tensor(v, spec, m, n) for m in range(n)]
        if spec.dim is not None:
            assert parts[0].shape[spec.dim] * n == v.shape[spec.dim], k
        assert torch.equal(join_shards(parts, spec), v), k


def test_shard_module_per_process_joins_to_the_model(paper_model):
    """`shard_module` on a copy per model process (the paper config's 16
    heads over 4): the state dicts joined are the full model's, the heads
    and widths are the shard's, and the sampling offsets' bias init is the
    shard of the grid init."""
    import copy

    from poet_tpu_torch.parallel.mesh import Layout
    from poet_tpu_torch.parallel.tp import join_shards, param_spec, shard_module

    _, model = paper_model
    n = 4
    shards = [shard_module(copy.deepcopy(model), Layout(1, 1, n, model_index=m))
              for m in range(n)]
    full = model.state_dict()
    for k, v in full.items():
        assert torch.equal(join_shards([s.state_dict()[k] for s in shards], param_spec(k)), v), k
    attn = shards[1].transformer.encoder.layers[0].self_attn
    assert attn.n_heads == 4 and attn.value_proj.weight.shape == (64, 256)
    assert attn.layout.model_index == 1 and shards[1].layout is attn.layout
    full_attn = model.transformer.encoder.layers[0].self_attn
    width = full_attn.sampling_offsets.bias_init.size // n
    np.testing.assert_array_equal(attn.sampling_offsets.bias_init,
                                  full_attn.sampling_offsets.bias_init[width:2 * width])
    mha = shards[1].transformer.decoder.layers[0].self_attn
    assert mha.num_heads == 4 and mha.in_proj_weight.shape == (192, 256)
    assert mha.out_proj.weight.shape == (256, 64)
    assert shards[1].transformer.encoder.layers[0].linear1.weight.shape == (256, 256)


def test_qkv_head_shard_is_jax_head_split():
    """load_jax_params into a head-sharded MultiheadAttention (a layer's
    `self_attn`) takes, for
    each of q, k and v, the rows of JAX's (C, H, hd) kernel's heads
    [m H/n, (m+1) H/n), and out_proj's columns of its (H, hd, C) kernel."""
    from poet_tpu_torch.models.transformer import MultiheadAttention
    from poet_tpu_torch.parallel.mesh import Layout
    from poet_tpu_torch.parallel.tp import shard_module
    from poet_tpu_torch.utils.jax_params import load_jax_params

    C, H, n = 32, 8, 4
    hd, h_loc = C // H, H // n
    rng = np.random.default_rng(3)
    tree = {p: {"kernel": rng.normal(size=(C, H, hd)).astype(np.float32),
                "bias": rng.normal(size=(H, hd)).astype(np.float32)}
            for p in ("query", "key", "value")}
    tree["out"] = {"kernel": rng.normal(size=(H, hd, C)).astype(np.float32),
                   "bias": rng.normal(size=(C,)).astype(np.float32)}
    for m in range(n):
        # the rules match the decoder layer's name for it, `self_attn`
        holder = shard_module(torch.nn.ModuleDict({"self_attn": MultiheadAttention(C, H)}),
                              Layout(1, 1, n, model_index=m))
        load_jax_params(holder, {"self_attn": tree})
        mha = holder["self_attn"]
        heads = slice(m * h_loc, (m + 1) * h_loc)
        w, b = mha.in_proj_weight.detach().chunk(3), mha.in_proj_bias.detach().chunk(3)
        for i, p in enumerate(("query", "key", "value")):
            np.testing.assert_array_equal(
                w[i].numpy(), tree[p]["kernel"][:, heads, :].reshape(C, h_loc * hd).T)
            np.testing.assert_array_equal(b[i].numpy(), tree[p]["bias"][heads].reshape(-1))
        np.testing.assert_array_equal(mha.out_proj.weight.detach().numpy(),
                                      tree["out"]["kernel"][heads].reshape(-1, C).T)
        np.testing.assert_array_equal(mha.out_proj.bias.detach().numpy(), tree["out"]["bias"])
        assert mha.num_heads == h_loc


def test_layout_checks_raise(paper_model):
    import copy

    from poet_tpu_torch.parallel import mesh
    from poet_tpu_torch.parallel.tp import seq_shard, shard_module

    assert not mesh.is_distributed()
    one = mesh.create_layout(-1, 1, 1, nheads=3, dim_feedforward=5)
    assert (one.n_data, one.n_seq, one.n_model) == (1, 1, 1) and not one.data_collective
    with pytest.raises(ValueError, match="does not divide 1 processes"):
        mesh.create_layout(1, 1, 2)
    with pytest.raises(ValueError, match="!= 1 processes"):
        mesh.create_layout(2, 1, 1)
    _, model = paper_model
    with pytest.raises(ValueError, match="16 heads do not split over 3"):
        shard_module(copy.deepcopy(model), mesh.Layout(1, 1, 3))
    assert seq_shard(one, 22) is None and seq_shard(None, 22) is None


# ---------------------------------------------------------------------------
# PoseServer(devices=...)
# ---------------------------------------------------------------------------

SERVE_B, SERVE_HW = 8, (64, 64)


@pytest.fixture(scope="module")
def served():
    """A small seeded PoET (hidden 32, 4 heads, 2 + 2 layers, 5 queries) in
    both packages, a batch of 8, and JAX's PoseServer's answer without a
    mesh."""
    from poet_tpu.config import PoETConfig
    from poet_tpu.engine.serving import PoseServer as JServer
    from poet_tpu.utils.torch_import import (
        convert_poet_checkpoint,
        convert_resnet_fpn,
        state_dict_to_numpy,
    )
    from poet_tpu_torch.flagship import flagship_batch, flagship_config
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    tcfg, jcfg = flagship_config("float32"), PoETConfig()
    jcfg.backbone.name = "maskrcnn"
    for cfg in (tcfg, jcfg):
        m = cfg.model
        m.enc_layers = m.dec_layers = 2
        m.hidden_dim, m.nheads, m.dim_feedforward, m.dtype = 32, 4, 64, "float32"
    model = init_weights(build_model(tcfg), seed=4)
    sd = state_dict_to_numpy(model.state_dict())
    tree = convert_poet_checkpoint(sd, enc_layers=2, dec_layers=2, nheads=4)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    images, _, t = flagship_batch(SERVE_B, *SERVE_HW, seed=6)
    kw = {k: t[k] for k in ("boxes", "labels", "n_boxes")}
    jserver = JServer(jcfg, {"params": jax.tree_util.tree_map(jnp.asarray, tree)},
                      batch_size=SERVE_B, image_size=SERVE_HW)
    return tcfg, model, images, kw, jserver.infer(images, **kw)


def test_server_over_four_devices_matches_jax(served):
    from poet_tpu_torch.engine.serving import PoseServer

    cfg, model, images, kw, want = served
    server = PoseServer(cfg, model, batch_size=SERVE_B, image_size=SERVE_HW,
                        devices=["cpu"] * 4)
    assert len(server.replicas) == 4 and server.replicas[0][1] is model
    got = server.infer(images, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    flipped = np.ascontiguousarray(images[:, ::-1])
    streamed = list(server.stream([images, flipped],
                                  boxes_fn=lambda prev: (kw["boxes"], kw["labels"],
                                                         kw["n_boxes"])))
    assert len(streamed) == 2
    for k in ("translation", "rotation"):
        np.testing.assert_allclose(streamed[0][k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    second = server.infer(flipped, **kw)          # frame order: the second frame's own
    for k in second:
        np.testing.assert_array_equal(streamed[1][k], second[k], err_msg=k)
    assert server.latency_stats()["frames"] == 4


def test_server_over_devices_equals_one_device(served):
    """Each shard is the one-device server's rows (the same kernels at the
    shard's batch)."""
    from poet_tpu_torch.engine.serving import PoseServer

    cfg, model, images, kw, _ = served
    one = PoseServer(cfg, model, batch_size=SERVE_B, image_size=SERVE_HW, device="cpu")
    two = PoseServer(cfg, model, batch_size=SERVE_B, image_size=SERVE_HW,
                     devices=("cpu", "cpu"))
    a, b = one.infer(images, **kw), two.infer(images, **kw)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_server_batch_that_does_not_divide_raises(served):
    from poet_tpu_torch.engine.serving import PoseServer

    cfg, model, _, _, _ = served
    with pytest.raises(ValueError, match="batch_size 6 does not split over 4 devices"):
        PoseServer(cfg, model, batch_size=6, image_size=SERVE_HW, devices=["cpu"] * 4)
