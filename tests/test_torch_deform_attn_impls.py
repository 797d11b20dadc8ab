"""The port's deformable-attention impls against the JAX package, on the CPU.

* the dense route (`ops/deform_attn_dense_cuda.py:ms_deform_attn_dense`,
  `enc_deform_impl` / `dec_deform_impl` = 'pallas') against JAX's
  `ms_deform_attn_pallas` (the one-hot TPU kernels in interpret mode):
  forward within 2e-5, d_value, d_loc and d_attn within 1e-4 (JAX's own
  tolerances for that kernel), over one and several of JAX's query tiles,
  edge levels, and a decoder-sized Q with most points far out of the map;
* the gather route with the merged adjoint (`ms_deform_attn(...,
  adjoint='merged')`) against JAX's `ms_deform_attn_fused` with
  `POET_V3_MERGED_ADJOINT=1` (its merged adjoint kernel in interpret mode);
* the config table (`config.DEFORM_IMPLS`): every JAX value is accepted and
  routed, any other raises; and the `MSDeformAttn` module built with each
  JAX value against JAX's module built with the same value, on the same
  random parameter tree.

On the CPU both routes run the plain PyTorch versions (`ops/deform_attn.py`)
and build nothing; the CUDA kernels are held against those versions on the
card (chip_smoke.py phases 18 and 19).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_deform_attn import _make_inputs
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

# JAX's own tolerances for the Pallas v1 kernel (tests/test_deform_attn_pallas.py)
FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4

# (B, Q, H, D, levels, location spread); spread s maps [-0.2, 1.2] to 0.5 +- 0.7 s
DENSE_CASES = {
    "q6": (2, 6, 4, 8, ((6, 9), (4, 5), (2, 3)), 1.0),
    "q300_three_jax_tiles": (1, 300, 2, 8, ((6, 9), (4, 5), (2, 3)), 1.0),
    "edge_levels": (1, 5, 2, 8, ((1, 7), (3, 1), (1, 1)), 1.0),
    "q10_far_out_of_map": (2, 10, 4, 8, ((6, 9), (4, 5), (2, 3)), 8.0),
}
ALL_IMPLS = ("auto", "fused", "pallas", "mxu", "patch", "sep", "sep_cv", "gather")
# the values JAX's MSDeformAttn takes ('auto' is resolved above it)
MODULE_IMPLS = ALL_IMPLS[1:]


def _inputs(rng, B, Q, H, D, shapes, spread):
    value, shapes, locs, w = _make_inputs(rng, B=B, Q=Q, H=H, D=D, shapes=shapes)
    locs = ((locs - 0.5) * spread + 0.5).astype(np.float32)
    dout = rng.normal(size=(B, Q, H * D)).astype(np.float32)
    return value, shapes, locs, w, dout


def _jax_vjp(fn, value, locs, w, dout):
    """fn's output and its cotangent-weighted gradients (value, locs, w)."""
    out, vjp = jax.vjp(fn, jnp.asarray(value), jnp.asarray(locs), jnp.asarray(w))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _port_vjp(entry, value, locs, w, dout):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (value, locs, w)]
    out = entry(*leaves)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _assert_grads(got, want, atol=GRAD_ATOL, rtol=0.0):
    for g, r, name in zip(got, want, ("d_value", "d_loc", "d_attn")):
        assert g.shape == r.shape, (name, g.shape, r.shape)
        np.testing.assert_allclose(g, r, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_entry_matches_pallas_v1_interpret(rng, case):
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas import ms_deform_attn_pallas
    from poet_tpu_torch.ops import deform_attn_dense_cuda as dense

    value, shapes, locs, w, dout = _inputs(rng, *DENSE_CASES[case])
    with pltpu.force_tpu_interpret_mode():
        want, want_grads = _jax_vjp(
            lambda v, l, a: ms_deform_attn_pallas(v, shapes, l, a), value, locs, w, dout)
    before = [k.launches for k in dense.KERNELS]
    got, grads = _port_vjp(lambda v, l, a: dense.ms_deform_attn_dense(v, shapes, l, a),
                           value, locs, w, dout)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    _assert_grads(grads, want_grads)
    # the CPU path runs the plain versions: no kernel built or launched
    assert [k.launches for k in dense.KERNELS] == before
    assert dense.DENSE_LIB._lib is None


def test_merged_adjoint_entry_matches_fused_merged_interpret(rng, monkeypatch):
    """JAX's merged adjoint selected as tests/test_deform_attn_pallas_v3.py
    selects it."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.ops.deform_attn_pallas_v3 import ms_deform_attn_fused
    from poet_tpu_torch.ops import deform_attn_cuda as gather

    monkeypatch.setenv("POET_V3_MERGED_ADJOINT", "1")
    value, shapes, locs, w, dout = _inputs(rng, 2, 7, 2, 8, ((5, 7), (3, 4)), 1.0)
    with pltpu.force_tpu_interpret_mode():
        want, want_grads = _jax_vjp(
            lambda v, l, a: ms_deform_attn_fused(v, shapes, l, a), value, locs, w, dout)
    before = gather.MS_DEFORM_ATTN_MERGED.launches
    got, grads = _port_vjp(
        lambda v, l, a: gather.ms_deform_attn(v, shapes, l, a, adjoint="merged"),
        value, locs, w, dout)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    _assert_grads(grads, want_grads, rtol=1e-4)     # JAX's own test: atol = rtol = 1e-4
    assert gather.MS_DEFORM_ATTN_MERGED.launches == before


@pytest.mark.parametrize("impl", ALL_IMPLS)
def test_config_accepts_and_routes_every_jax_impl(impl):
    from poet_tpu_torch.config import DEFORM_IMPLS, ModelConfig, deform_route
    from poet_tpu_torch.models.transformer import MSDeformAttn

    assert set(DEFORM_IMPLS) == set(ALL_IMPLS)
    cfg = ModelConfig(enc_deform_impl=impl, dec_deform_impl=impl)
    assert (cfg.enc_deform_impl, cfg.dec_deform_impl) == (impl, impl)
    want = "dense" if impl == "pallas" else "gather"
    assert deform_route(impl) == want
    for merged in (False, True):
        m = MSDeformAttn(32, 2, 4, 2, impl=impl, merged_adjoint=merged)
        assert (m.route, m.adjoint) == (want, "merged" if merged else "pair")


@pytest.mark.parametrize("bad", ["bogus", "Pallas", "", "dense"])
def test_config_rejects_other_impls(bad):
    from poet_tpu_torch.config import ModelConfig
    from poet_tpu_torch.models.transformer import MSDeformAttn

    with pytest.raises(ValueError, match="impl"):
        ModelConfig(enc_deform_impl=bad)
    with pytest.raises(ValueError, match="impl"):
        ModelConfig(dec_deform_impl=bad)
    with pytest.raises(ValueError, match="impl"):
        MSDeformAttn(32, 2, 4, 2, impl=bad)


def test_gather_entry_rejects_unknown_adjoint(rng):
    from poet_tpu_torch.ops.deform_attn_cuda import ms_deform_attn

    value, shapes, locs, w, _ = _inputs(rng, *DENSE_CASES["q6"])
    with pytest.raises(ValueError, match="adjoint"):
        ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                       torch.from_numpy(w), adjoint="dense")


@pytest.mark.parametrize("kernel", ["MS_DEFORM_ATTN_DENSE_FWD", "MS_DEFORM_ATTN_DENSE_BWD"])
def test_dense_kernel_wrappers_reject_cpu_tensors(rng, kernel):
    from poet_tpu_torch.ops import deform_attn_dense_cuda as dense

    value, shapes, locs, w, dout = _inputs(rng, *DENSE_CASES["q6"])
    args = [torch.from_numpy(x) for x in (value, locs, w)]
    if kernel.endswith("BWD"):
        args.append(torch.from_numpy(dout))
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(dense, kernel)(args[0], shapes, *args[1:])
    assert dense.DENSE_LIB._lib is None


def test_padded_tokens_counts_the_zero_border():
    from poet_tpu.ops.deform_attn_pallas import _padded_layout
    from poet_tpu_torch.ops.deform_attn_dense_cuda import padded_tokens

    for shapes in (((30, 40), (15, 20), (8, 10), (4, 5)), ((60, 80), (30, 40), (15, 20),
                                                           (8, 10)), ((1, 7), (3, 1), (1, 1))):
        assert padded_tokens(shapes) == _padded_layout(shapes)[2]
    assert padded_tokens(((30, 40), (15, 20), (8, 10), (4, 5))) == 1880


@pytest.mark.parametrize("impl", MODULE_IMPLS)
def test_msdeform_attn_module_each_impl_matches_jax(rng, impl):
    """JAX's MSDeformAttn and the port's, both built with `impl`, on one
    random parameter tree (the same for every impl: 'pallas' and the XLA
    formulations use the same nn.Dense names)."""
    from jax.experimental.pallas import tpu as pltpu

    from poet_tpu.models.transformer import MSDeformAttn as JMSDeformAttn
    from poet_tpu_torch.models.transformer import MSDeformAttn
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from tests.test_torch_modules import SHAPES, S, init_shapes, random_tree, t

    B, C, H, L, P, Q = 2, 32, 4, len(SHAPES), 2, 7
    query = rng.normal(size=(B, Q, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, size=(B, Q, L, 2)).astype(np.float32)
    src = rng.normal(size=(B, S, C)).astype(np.float32)
    jm = JMSDeformAttn(C, L, H, P, impl=impl)
    args = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src), SHAPES)
    with pltpu.force_tpu_interpret_mode():
        tree = init_shapes(jm, *args)
        params = random_tree(tree, rng)
        want = np.asarray(jm.apply(params, *args))
    # the tree of every impl is the 'mxu' one
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        init_shapes(JMSDeformAttn(C, L, H, P, impl="mxu"), *args))
    pm = load_jax_params(MSDeformAttn(C, L, H, P, impl=impl), params)
    got = pm(t(query), t(ref), t(src), SHAPES).detach().numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
