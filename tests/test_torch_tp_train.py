"""The port's train step under ('data', 'seq', 'model') layouts over 4 gloo
processes on the CPU (`parallel/mesh.py:create_layout`, `parallel/tp.py`),
against `poet_tpu`'s single-process `make_train_step` on the global batch
and against the port's own one-process step.

`tests/test_torch_ddp.py`'s small PoET and harness: the full
ResNet-50-FPN at 64x64 (S = 16 + 4 + 1 + 1 = 22 encoder tokens), 2 encoder
/ 2 decoder layers, hidden 32, 4 heads, FFN 64, f32, the 'sep' core in both
packages; the global batch of 8 images with a last data slot whose images
hold no object, target rotations the midpoints of the start model's
predictions. Each layout's data slot d takes images [d*8/n_data,
(d+1)*8/n_data); every process loads the same seeded weights whole and
shards them (`tp.shard_module`).

* each layout (1,1,4), (2,1,2) with ZeRO-1, (1,2,2), (2,2,1) and (1,4,1)
  (22 tokens over 4: 2 pad tokens): 2 SGD steps, losses (1e-5 relative),
  `grad_norm` (1e-4), the gradients gathered whole (1e-4 of each tensor's
  max, at the first step, as the DDP test holds them) and the parameters
  (1e-3 of lr) against JAX's step on the 8 images;
* each layout at dropout 0.1, one step from a generator seeded alike on
  every process: the loss within 1e-5 of the port's one-process loss with
  the same generator (over 2 data slots: each slot's images through the loss
  with the global matched count, from the same generator state, summed);
* checkpoints: SGD with momentum, 2 steps under (1,2,2) written (rank 0,
  gathered whole), resumed in one process; 2 steps in one process written,
  resumed under (1,2,2); each resumed third step's update equals the
  writing run's, and the two files' momenta agree (1e-4 of each tensor's
  max, the gradients' tolerance: both are linear in the gradients, which
  the layout sums in another order; AdamW's first steps divide near-zero
  gradients by their own magnitude, so its parameters are not comparable
  across layouts);
* each process's place in each layout: rank = (d * n_seq + s) * n_model + m.

Every child is joined with a timeout and killed on expiry.
"""

import os
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":       # the children import no JAX
    from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

from tests.test_torch_ddp import (  # noqa: E402  (no JAX at import)
    FFN,
    HEADS,
    LOSS_RTOL,
    STEPS,
    W,
    _assert_steps,
    _port_config,
    initial_model,
    load_batches,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B_GLOBAL = 8
LAYOUTS = ((1, 1, 4), (2, 1, 2), (1, 2, 2), (2, 2, 1), (1, 4, 1))
ZERO_LAYOUT, CKPT_LAYOUT = (2, 1, 2), (1, 2, 2)
DROPOUT, DROPOUT_SEED = 0.1, 11
# a third step's update and the momenta: the gradients' tolerance, of each
# tensor's max, with a floor of UPDATE_FLOOR of the largest (tensors whose
# gradient is rounding noise, e.g. a conv bias ahead of a GroupNorm)
CKPT_RTOL, UPDATE_FLOOR = 1e-4, 1e-6
CHILD_TIMEOUT_S = 240


def data_shard(batch, layout):
    """The images of `layout`'s data slot of a global batch."""
    per = B_GLOBAL // layout.n_data
    rows = slice(layout.data_index * per, (layout.data_index + 1) * per)
    images, pad_mask, t = batch
    return images[rows], pad_mask[rows], {k: v[rows] for k, v in t.items()}


def sharded_model(state, cfg, layout):
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.parallel import tp

    model = build_model(cfg)
    model.load_state_dict(state)
    return model if layout is None else tp.shard_module(model, layout)


def layout_run(model, cfg, batches, steps, opt=None, generator_seed=None):
    """`steps` steps of `make_train_step`: (metrics per step, the gradients
    each update saw, gathered whole, by name, the parameters after each step,
    gathered whole, by name, the optimizer). Collective over 'model' under a
    layout."""
    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )
    from poet_tpu_torch.parallel import tp

    layout = getattr(model, "layout", None)
    opt = opt or make_optimizer(cfg, model, steps_per_epoch=100)
    seen, update = [], opt.step

    def step_and_record():
        seen.append({n: tp.gather_tensor(g, n, layout).clone()
                     for n, g in zip(opt.clip_names, opt.grads())})
        return update()

    opt.step = step_and_record
    step = make_train_step(model, cfg, opt)
    metrics, params = [], []
    for batch in batches[:steps]:
        gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
        metrics.append(fetch_metrics(step(*prepare_batch(cfg, *batch, "cpu"), gen)))
        params.append({n: tp.gather_tensor(p, n, layout).clone()
                       for n, p in model.named_parameters() if p.requires_grad})
    opt.step = update
    return metrics, seen, params, opt


# ---------------------------------------------------------------- the children
def _worker(out_dir, batches_path, start_path, plain_ckpt):
    import torch.distributed as dist

    from poet_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from poet_tpu_torch.engine.train import make_optimizer
    from poet_tpu_torch.parallel import mesh, tp
    from poet_tpu_torch.parallel.zero import ZeroOptimizer
    from poet_tpu_torch.utils.misc import get_rank

    assert mesh.init_distributed("cpu") and mesh.world_size() == W
    rank = get_rank()
    batches = load_batches(batches_path)
    start = torch.load(start_path, weights_only=True)
    results = {"places": {}}
    for lay in LAYOUTS:
        layout = mesh.create_layout(*lay, nheads=HEADS, dim_feedforward=FFN)
        results["places"][lay] = (layout.data_index, layout.seq_index, layout.model_index)
        data = [data_shard(b, layout) for b in batches]
        cfg = _port_config("sgd", zero=lay == ZERO_LAYOUT)
        model = sharded_model(start, cfg, layout)
        opt = make_optimizer(cfg, model, steps_per_epoch=100)
        assert isinstance(opt, ZeroOptimizer) == (lay == ZERO_LAYOUT)
        metrics, grads, params, _ = layout_run(model, cfg, data, STEPS, opt)
        cfg = _port_config("sgd")
        cfg.model.dropout = DROPOUT
        dropped, _, _, _ = layout_run(sharded_model(start, cfg, layout), cfg, data, 1,
                                      generator_seed=DROPOUT_SEED)
        results[lay] = {"metrics": metrics, "grads": grads, "params": params,
                        "dropout_loss": dropped[0]["loss"]}

    # checkpoints both ways between CKPT_LAYOUT and one process
    layout = mesh.create_layout(*CKPT_LAYOUT, nheads=HEADS, dim_feedforward=FFN)
    data = [data_shard(b, layout) for b in batches]
    cfg = _port_config("sgd")
    model = sharded_model(start, cfg, layout)
    _, _, _, opt = layout_run(model, cfg, data, STEPS)
    save_checkpoint(out_dir, "layout.pth", model, opt, 0, STEPS, cfg)
    _, _, third, _ = layout_run(model, cfg, data[STEPS:], 1, opt)
    results["ckpt_third"] = third[0]
    payload, _ = load_checkpoint(plain_ckpt)
    from poet_tpu_torch.models import build_model

    resumed = tp.load_full_state_dict(tp.shard_module(build_model(cfg), layout),
                                      payload["model"])
    ropt = make_optimizer(cfg, resumed, steps_per_epoch=100)
    ropt.load_state_dict(payload["optimizer"])
    _, _, third, _ = layout_run(resumed, cfg, data[STEPS:], 1, ropt)
    results["plain_resumed_third"] = third[0]
    places = [None] * W
    dist.all_gather_object(places, results["places"])
    if rank == 0:
        results["places"] = places
        torch.save(results, os.path.join(out_dir, "results.pt"))
    dist.destroy_process_group()


def start_children(n: int, *args, script=__file__):
    """`n` processes of `script` (this file) in one gloo group on localhost."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, script, *args], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return "layouts", procs


# ---------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def start(tmp_path_factory):
    state = initial_model().state_dict()
    path = str(tmp_path_factory.mktemp("tp_start") / "start.pt")
    torch.save(state, path)
    return state, path


@pytest.fixture(scope="module")
def batches(tmp_path_factory, start):
    """The DDP test's 3 global batches (midpoint targets), and their file."""
    from tests.test_torch_ddp import global_batch
    from tests.test_torch_variants import _midpoint_targets

    model = initial_model(start[0])
    out = [_midpoint_targets(model, global_batch(s)) for s in range(STEPS + 1)]
    path = str(tmp_path_factory.mktemp("tp_batches") / "batches.npz")
    np.savez(path, **{f"{name}{s}": a for s, (i, m, _) in enumerate(out)
                      for name, a in (("images", i), ("pad_mask", m))},
             **{f"t{s}_{k}": v for s, (_, _, t) in enumerate(out) for k, v in t.items()})
    return out, path


@pytest.fixture(scope="module")
def plain_checkpoint(tmp_path_factory, batches, start):
    """One process, SGD: 2 steps on the global batch written, then the
    third step's parameters."""
    from poet_tpu_torch.engine.checkpoint import save_checkpoint

    out = str(tmp_path_factory.mktemp("tp_plain"))
    cfg = _port_config("sgd")
    model = initial_model(start[0])
    _, _, _, opt = layout_run(model, cfg, batches[0], STEPS)
    path = save_checkpoint(out, "plain.pth", model, opt, 0, STEPS, cfg)
    _, _, third, _ = layout_run(model, cfg, batches[0][STEPS:], 1, opt)
    return path, third[0]


@pytest.fixture(scope="module")
def children(tmp_path_factory, batches, start, plain_checkpoint):
    out = str(tmp_path_factory.mktemp("tp"))
    started = start_children(W, out, batches[1], start[1], plain_checkpoint[0])
    yield out, started
    for p in started[1]:
        p.kill()


@pytest.fixture(scope="module")
def layouts(children):
    from tests.test_torch_ddp import join_children

    out, started = children
    join_children(started, CHILD_TIMEOUT_S)
    return torch.load(os.path.join(out, "results.pt"), weights_only=False)


@pytest.fixture(scope="module")
def jax_steps(children, batches, start):
    from tests.test_torch_ddp import jax_sgd_steps

    return jax_sgd_steps(batches[0][:STEPS], start[0])


@pytest.fixture(scope="module")
def dropout_losses(children, batches, start):
    """The port's one-process loss at dropout 0.1 from the seeded generator,
    for 1 and 2 data slots: each slot's images through the loss with the
    global matched count, each from the same generator state, summed."""
    from poet_tpu_torch.engine.train import make_loss_fn, prepare_batch

    cfg = _port_config("sgd")
    cfg.model.dropout = DROPOUT
    model = sharded_model(start[0], cfg, None).train()
    images, pad_mask, t = batches[0][0]
    out = {}
    for n_data in (1, 2):
        per = B_GLOBAL // n_data
        shards = [prepare_batch(cfg, images[r * per:(r + 1) * per],
                                pad_mask[r * per:(r + 1) * per],
                                {k: v[r * per:(r + 1) * per] for k, v in t.items()}, "cpu")
                  for r in range(n_data)]
        count = sum(s[3].num_matched for s in shards)
        loss_fn = make_loss_fn(model, cfg, count=lambda match: count)
        with torch.no_grad():
            out[n_data] = sum(float(loss_fn(*s, torch.Generator().manual_seed(DROPOUT_SEED))[0])
                              for s in shards)
    return out


def test_sixty_four_pixel_tokens_pad_over_four():
    from poet_tpu_torch.parallel import tp
    from poet_tpu_torch.parallel.mesh import Layout

    shards = [tp.seq_shard(Layout(1, 4, 1, seq_index=s), 22) for s in range(4)]
    assert [(x.start, x.stop, x.S_pad) for x in shards] == [(0, 6, 24), (6, 12, 24),
                                                            (12, 18, 24), (18, 24, 24)]


def test_ranks_follow_jax_mesh_order(layouts):
    for lay in LAYOUTS:
        n_data, n_seq, n_model = lay
        for rank, places in enumerate(layouts["places"]):
            d, s, m = places[lay]
            assert rank == (d * n_seq + s) * n_model + m, (lay, rank, places[lay])


@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda x: "x".join(map(str, x)))
def test_layout_step_matches_jax_global_batch(jax_steps, layouts, lay):
    """Losses, grad_norm, the gradients gathered whole and the parameters of
    2 SGD steps under the layout equal JAX's step on the 8 images."""
    got = layouts[lay]
    names = list(got["grads"][0])
    want = ([m for m, _, _ in jax_steps],
            [{n: g[n] for n in names if n in g} for _, g, _ in jax_steps],
            [p for _, _, p in jax_steps])
    trained = [n for n in names if "backbone" not in n]
    assert len(trained) > 50
    _assert_steps((got["metrics"], got["grads"], got["params"]), want, trained,
                  f"{lay} against jax", grad_steps=1)


@pytest.mark.parametrize("lay", LAYOUTS, ids=lambda x: "x".join(map(str, x)))
def test_layout_dropout_loss_matches_one_process(dropout_losses, layouts, lay):
    np.testing.assert_allclose(layouts[lay]["dropout_loss"], dropout_losses[lay[0]],
                               rtol=LOSS_RTOL)


def _assert_scaled(got, want, label, base=None):
    """Each tensor within CKPT_RTOL of its max, plus UPDATE_FLOOR of the
    largest of them all; an update to `base` (by name) also within two f32
    roundings of the parameter it was added to."""
    floor = UPDATE_FLOOR * max(float(v.abs().max()) for v in want.values())
    eps = float(np.finfo(np.float32).eps)
    for n, ref in want.items():
        ulp = 0.0 if base is None else 2 * eps * float(base[n].abs().max())
        np.testing.assert_allclose(got[n].numpy(), ref.numpy(), rtol=0,
                                   atol=CKPT_RTOL * float(ref.abs().max()) + floor + ulp,
                                   err_msg=f"{label} {n}")


@pytest.mark.parametrize("way", ["layout_to_one", "one_to_layout"])
def test_checkpoint_resumes_across_layouts(layouts, children, plain_checkpoint, batches, way):
    """A checkpoint written under (1,2,2) resumed in one process, and one
    written in one process resumed under (1,2,2), take the writing run's
    third step."""
    from poet_tpu_torch.engine.checkpoint import load_checkpoint
    from poet_tpu_torch.engine.train import make_optimizer

    path = (plain_checkpoint[0] if way == "one_to_layout"
            else os.path.join(children[0], "layout.pth"))
    payload, _ = load_checkpoint(path)
    if way == "one_to_layout":
        got, want = layouts["plain_resumed_third"], plain_checkpoint[1]
    else:
        cfg = _port_config("sgd")
        model = initial_model(payload["model"])
        opt = make_optimizer(cfg, model, steps_per_epoch=100)
        opt.load_state_dict(payload["optimizer"])
        _, _, third, _ = layout_run(model, cfg, batches[0][STEPS:], 1, opt)
        got, want = third[0], layouts["ckpt_third"]
    assert len(want) > 50
    before = payload["model"]
    _assert_scaled({n: got[n] - before[n] for n in want},
                   {n: v - before[n] for n, v in want.items()}, f"{way} third update", before)


def test_checkpoint_momenta_agree_across_layouts(children, plain_checkpoint):
    """The momenta (2 steps) written under (1,2,2), gathered whole, are
    the one-process run's, in the one-process layout."""
    from poet_tpu_torch.engine.checkpoint import load_checkpoint

    layout_file, _ = load_checkpoint(os.path.join(children[0], "layout.pth"))
    plain_file, _ = load_checkpoint(plain_checkpoint[0])
    got, want = layout_file["optimizer"]["torch"], plain_file["optimizer"]["torch"]
    assert got["param_groups"] == want["param_groups"]
    assert sorted(got["state"]) == sorted(want["state"]) and len(want["state"]) > 50
    _assert_scaled({i: st["momentum_buffer"] for i, st in got["state"].items()},
                   {i: st["momentum_buffer"] for i, st in want["state"].items()}, "momentum")
    assert {k: v.shape for k, v in layout_file["model"].items()} == \
        {k: v.shape for k, v in plain_file["model"].items()}


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(*sys.argv[1:])
