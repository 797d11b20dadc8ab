"""The darknet body's epilogue operator on the CPU
(`poet_tpu_torch/ops/darknet_epilogue_cuda.py`).

The operator's CPU implementation is the plain composition the body ran
before it: `FrozenBatchNorm.forward` on the conv output's NCHW view, then
the activation, bit for bit in f32 and bf16 on inputs spanning -30..30
(both sides of mish's clamp at 25). The route's predicate
(`models/yolov4.py:_use_epilogue`) is checked one input property at a time;
the fake implementation's shape, dtype and layout under `FakeTensorMode`;
the CUDA wrapper refuses CPU tensors and counts no launch; the entry refuses
what the kernel does not take. The mini cfg's body gives the same maps
through the operator as through the plain BN and activation. The kernel
itself runs only on the card (`tests/test_torch_card.py`).
"""

import numpy as np
import pytest
import torch

from poet_tpu_torch.models.resnet_fpn import FrozenBatchNorm
from poet_tpu_torch.ops import darknet_epilogue_cuda as ep
from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

B, H, W, C = 2, 5, 7, 24


def _bn(rng, c=C):
    bn = FrozenBatchNorm(c)
    bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    bn.bias.copy_(torch.from_numpy(rng.uniform(-2, 2, c).astype(np.float32)))
    bn.running_mean.copy_(torch.from_numpy(rng.uniform(-2, 2, c).astype(np.float32)))
    bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return bn


def _args(bn):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps


@pytest.mark.parametrize("act", ep.ACTIVATIONS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_operator_is_frozen_bn_then_activate(dtype, act):
    rng = np.random.default_rng(7)
    bn = _bn(rng)
    x = torch.from_numpy(rng.uniform(-30, 30, (B, H, W, C)).astype(np.float32)).to(dtype)
    pre = bn(x.permute(0, 3, 1, 2))
    assert (pre.float() > 25).any() and (pre.float() < -25).any()
    want = ep.activate(pre, act).permute(0, 2, 3, 1)
    launches = ep.DARKNET_EPILOGUE.launches
    for got in (ep.darknet_epilogue(x, *_args(bn), act),
                torch.ops.poet_tpu_torch.darknet_epilogue(x, *_args(bn), act)):
        assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
        assert torch.equal(got, want)
    assert ep.DARKNET_EPILOGUE.launches == launches and ep.EPILOGUE_LIB._lib is None


def _nchw_last(shape=(1, 16, 4, 6), dtype=torch.float32, device="cpu"):
    b, c, h, w = shape
    return torch.zeros((b, h, w, c), dtype=dtype, device=device).permute(0, 3, 1, 2)


PREDICATE_CASES = {
    "f32 channels-last": (lambda: _nchw_last(), True, "mish", True),
    "bf16": (lambda: _nchw_last(dtype=torch.bfloat16), True, "leaky", True),
    "linear": (lambda: _nchw_last(), True, "linear", True),
    "float16": (lambda: _nchw_last(dtype=torch.float16), True, "mish", False),
    "float64": (lambda: _nchw_last(dtype=torch.float64), True, "mish", False),
    "NCHW memory": (lambda: torch.zeros(1, 16, 4, 6), True, "mish", False),
    "C % 8": (lambda: _nchw_last((1, 12, 4, 6)), True, "mish", False),
    "C over the fold": (lambda: _nchw_last((1, 4104, 1, 2)), True, "mish", False),
    "requires grad": (lambda: _nchw_last().requires_grad_(), True, "mish", False),
    "no BN": (lambda: _nchw_last(), False, "linear", False),
    "logistic": (lambda: _nchw_last(), True, "logistic", False),
    "no implementation on the device": (lambda: _nchw_last(device="meta"), True, "mish", False),
}


@pytest.mark.parametrize("case", PREDICATE_CASES)
def test_route_predicate_by_input_property(case):
    from poet_tpu_torch.models.yolov4 import _use_epilogue

    make, bn, act, want = PREDICATE_CASES[case]
    assert _use_epilogue(make(), bn, act) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementation_shape_and_dtype(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    bn = _bn(np.random.default_rng(1))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        x = mode.from_tensor(torch.zeros((B, H, W, C), dtype=dtype))
        got = torch.ops.poet_tpu_torch.darknet_epilogue(x, *_args(bn), "mish")
    assert got.shape == (B, H, W, C) and got.dtype == dtype and got.is_contiguous()
    assert got.device == torch.device("cpu")


def test_kernel_refuses_cpu_tensors_and_the_entry_what_it_does_not_take():
    rng = np.random.default_rng(2)
    bn = _bn(rng)
    x = torch.zeros((B, H, W, C))
    launches = ep.DARKNET_EPILOGUE.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        ep.DARKNET_EPILOGUE(x, *_args(bn), "mish")
    with pytest.raises(ValueError, match="activation"):
        ep.darknet_epilogue(x, *_args(bn), "logistic")
    with pytest.raises(ValueError, match=r"weight \(16,\)"):
        ep.darknet_epilogue(x, *_args(_bn(rng, 16)), "mish")
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        ep.darknet_epilogue(x[0], *_args(bn), "mish")
    with pytest.raises(RuntimeError, match="no gradient"):
        ep.darknet_epilogue(x.clone().requires_grad_(), *_args(bn), "mish")
    assert ep.DARKNET_EPILOGUE.launches == launches


def test_mini_body_gives_the_plain_route_bit_for_bit(monkeypatch):
    from poet_tpu_torch.flagship import darknet_state
    from poet_tpu_torch.models import yolov4
    from poet_tpu_torch.utils.jax_params import load_jax_params
    from tests.test_torch_yolov4 import H_IMG, MINI_CFG, W_IMG, _frozen

    sections = _frozen(MINI_CFG)
    body = load_jax_params(yolov4.DarknetBody(sections), darknet_state(sections))
    images = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(B, H_IMG, W_IMG, 3)).astype(np.float32))
    seen = []
    epilogue = yolov4.DarknetBody._epilogue
    monkeypatch.setattr(yolov4.DarknetBody, "_epilogue",
                        lambda self, li, *a: seen.append(li) or epilogue(self, li, *a))
    with torch.no_grad():
        got = body(images)
        monkeypatch.setattr(yolov4, "_use_epilogue", lambda *a: False)
        want = body(images)
    # the BN convs after the two stem convs, but the logistic layer 13
    assert seen == [2, 3, 4, 9, 16]
    for g, w in zip(got[0] + got[2], want[0] + want[2]):
        assert torch.equal(g, w)


def test_epilogue_convs_are_the_maps_the_body_sends(monkeypatch):
    """`epilogue_convs` lists (H, W, C, activation) of exactly the conv
    outputs the mini body hands the operator, in its order."""
    from poet_tpu_torch.models import yolov4
    from tests.test_torch_yolov4 import H_IMG, MINI_CFG, W_IMG, _frozen

    body = yolov4.DarknetBody(_frozen(MINI_CFG)).eval()
    seen = []
    epilogue = yolov4.DarknetBody._epilogue
    monkeypatch.setattr(yolov4.DarknetBody, "_epilogue", lambda self, li, x, act: seen.append(
        (x.shape[2], x.shape[3], x.shape[1], act)) or epilogue(self, li, x, act))
    with torch.no_grad():
        body(torch.zeros((1, H_IMG, W_IMG, 3)))
    assert len(seen) == 5
    assert yolov4.epilogue_convs([dict(s) for s in body.sections], H_IMG, W_IMG) == seen


@pytest.mark.parametrize("name", ["ycbv", "lmo"])
def test_shipped_cfgs_send_109_maps_of_11_shapes(name):
    """At 480x640 the shipped cfgs send 109 mish maps of 11 distinct
    (H, W, C) to the operator: 53 990 400 elements an image."""
    from poet_tpu_torch.models.yolov4 import epilogue_convs, load_cfg_sections
    from tests.test_torch_yolov4 import SHIPPED

    path = next(p for p in SHIPPED if p.name.startswith(name))
    convs = epilogue_convs([dict(s) for s in load_cfg_sections(str(path))])
    assert len(convs) == 109 and {act for *_, act in convs} == {"mish"}
    assert len({c[:3] for c in convs}) == 11
    assert sum(h * w * c for h, w, c, _ in convs) == 53_990_400
