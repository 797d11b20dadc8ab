"""The port's data-parallel train step and ZeRO-1 over 4 gloo processes on
the CPU, against `poet_tpu`'s single-process `make_train_step` on the
concatenated global batch and against the port's own single-process step.

A small PoET: the full ResNet-50-FPN at 64x64, 2 encoder / 2 decoder
layers, hidden 32, 4 heads, FFN 64, dropout 0, f32, the 'sep' sampling core
in both packages (`tests/test_torch_train_impls.py`'s "sep" case). Each of
the 4 processes (`torchrun`'s environment: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_*, read by `parallel.mesh.init_distributed`) seeds its own weights
and takes rank 0's (`mesh.replicate`), then trains on its 2 images of each
global batch of 8; the last process's images hold no object, the others
different numbers, so the ranks' matched counts differ and one is 0. Each
valid query's target rotation is the geodesic midpoint of the start
model's first and last decoder layers' predictions
(`tests/test_torch_variants.py:_midpoint_targets`): the geodesic loss's
arccos is ill-conditioned as a pair's angle nears pi, where the uniform
rotations of the flagship batch put some pair, and the two frameworks' f32
roundings there part by more than the gradient tolerance.

* DDP, SGD, 2 steps: the losses (1e-5 relative) and `grad_norm` (1e-4)
  of each step, every summed gradient (1e-4 of its max) and the parameters
  after each step (1e-3 of lr) against JAX's step on the 8 images, and
  against the port's one-process step on them. Against JAX the gradients
  are held at the first step: at init every encoder sampling point sits on
  a cell edge, where d_loc jumps, and after one update the two
  frameworks' points lie within a rounding of it on either side (the
  sampling offsets' second gradients part by ~10% of their max; the
  parameters they move stay within the tolerance);
* ZeRO-1 (`--zero_opt_state`) against DDP without it, 2 AdamW steps and 2
  with the bf16 first moment: the parameters within 1e-6 of each tensor's
  scale; each process's moment bytes at most total / 4 + the largest
  tensor's;
* checkpoints: a ZeRO checkpoint resumed without ZeRO and a plain one
  resumed under ZeRO take the same third step as the run that wrote them;
* `--eval` and `--eval_bop` through `cli.run` on 2 gloo processes against
  one process: every evaluator file equal (8 test images, 4 per process),
  the BOP CSV equal but for its time column, and each process's loader
  shard the indices JAX's loader gives it.

Every child is joined with a timeout and killed on expiry; the test then
fails with its output.
"""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":       # the children import no JAX
    from tests.test_torch_modules import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, B_LOCAL, HW, STEPS, LR = 4, 2, (64, 64), 2, 1e-3
ENC, DEC, HIDDEN, HEADS, FFN = 2, 2, 32, 4, 64
EMPTY_RANK = W - 1               # its images hold no object
LOSS_RTOL = 1e-5                 # the same f32 sums in other orders
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
PARAM_ATOL = 1e-3 * LR
ZERO_RTOL = 1e-6                 # ZeRO against DDP: the same per-tensor arithmetic
CHILD_TIMEOUT_S = 120


def _port_config(optimizer="sgd", zero=False):
    from poet_tpu_torch.flagship import flagship_config

    cfg = flagship_config("float32")
    m = cfg.model
    m.enc_layers, m.dec_layers = ENC, DEC
    m.hidden_dim, m.nheads, m.dim_feedforward, m.dropout = HIDDEN, HEADS, FFN, 0.0
    m.enc_deform_impl = m.dec_deform_impl = "sep"
    cfg.optim.lr = LR
    cfg.optim.sgd = optimizer == "sgd"
    cfg.optim.mu_bf16 = optimizer == "mu_bf16"
    cfg.runtime.zero_opt_state = zero
    return cfg


def global_batch(step: int):
    """The step's 8 images and targets; `EMPTY_RANK`'s two hold no object."""
    from poet_tpu_torch.flagship import flagship_batch

    images, pad_mask, t = flagship_batch(W * B_LOCAL, *HW, seed=100 + step)
    t = {k: t[k].copy() for k in ("boxes", "labels", "n_boxes", "relative_position",
                                  "relative_rotation")}
    rows = slice(EMPTY_RANK * B_LOCAL, (EMPTY_RANK + 1) * B_LOCAL)
    t["n_boxes"][rows] = 0
    t["boxes"][rows] = -1.0
    t["labels"][rows] = -1
    return images, pad_mask, t


def load_batches(path):
    with np.load(path) as z:
        return [(z[f"images{s}"], z[f"pad_mask{s}"],
                 {k[len(f"t{s}_"):]: z[k] for k in z.files if k.startswith(f"t{s}_")})
                for s in range(STEPS + 1)]


def shard(batch, r: int):
    rows = slice(r * B_LOCAL, (r + 1) * B_LOCAL)
    images, pad_mask, t = batch
    return images[rows], pad_mask[rows], {k: v[rows] for k, v in t.items()}


def initial_model(state=None, init=True):
    """The small PoET holding `state`, else seeded (init_weights, seed 0), or
    with `init=False` torch's default init (a process that takes rank 0's)."""
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights

    model = build_model(_port_config())
    if state is not None:
        model.load_state_dict(state)
        return model
    return init_weights(model, seed=0) if init else model


def train_run(model, cfg, batches, steps, optimizer=None):
    """`steps` steps of `make_train_step` on `batches` (host arrays, CPU):
    (metrics per step, the gradients each update saw per step, by name,
    the trained parameters after each step, by name, the optimizer)."""
    from poet_tpu_torch.engine.train import (
        fetch_metrics,
        make_optimizer,
        make_train_step,
        prepare_batch,
    )

    opt = optimizer or make_optimizer(cfg, model, steps_per_epoch=100)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    seen = []
    update = opt.step

    def step_and_record():
        seen.append({n: g.clone() for n, g in zip(names, opt.grads())})
        return update()

    opt.step = step_and_record
    step = make_train_step(model, cfg, opt)
    metrics, params = [], []
    for batch in batches[:steps]:
        metrics.append(fetch_metrics(step(*prepare_batch(cfg, *batch, "cpu"), None)))
        params.append({n: p.detach().clone() for n, p in model.named_parameters()
                       if p.requires_grad})
    opt.step = update
    return metrics, seen, params, opt


# ---------------------------------------------------------------- the children
def _train_worker(out_dir, batches_path, start_path):
    """Every run of the DDP and ZeRO checks, in one process of the group."""
    import torch.distributed as dist

    from poet_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from poet_tpu_torch.engine.train import make_optimizer
    from poet_tpu_torch.parallel import mesh
    from poet_tpu_torch.parallel.zero import ZeroOptimizer, opt_state_bytes_per_device
    from poet_tpu_torch.utils.misc import get_rank

    assert mesh.init_distributed("cpu") and mesh.world_size() == W
    r = get_rank()
    batches = [shard(b, r) for b in load_batches(batches_path)]
    start = torch.load(start_path, weights_only=True)
    # rank 0 holds the seeded weights, the others torch's default init
    template = mesh.replicate(initial_model(start) if r == 0 else initial_model(init=False))
    results = {"start": {k: v.clone() for k, v in template.state_dict().items()}}
    for k, v in start.items():
        assert torch.equal(results["start"][k], v), f"rank {r}: {k} is not rank 0's"

    def fresh():
        return copy.deepcopy(template)

    # DDP, SGD: against JAX and the one-process step
    metrics, seen, params, _ = train_run(fresh(), _port_config("sgd"), batches, STEPS)
    results["sgd"] = {"metrics": metrics, "grads": seen, "params": params}

    # ZeRO-1 against DDP, AdamW and the bf16 first moment; checkpoints both ways
    for optim in ("adamw", "mu_bf16"):
        for zero in (False, True):
            cfg, model = _port_config(optim, zero), fresh()
            opt = make_optimizer(cfg, model, steps_per_epoch=100)
            assert isinstance(opt, ZeroOptimizer) == zero
            metrics, _, params, opt = train_run(model, cfg, batches, STEPS, opt)
            moments = sum(v.numel() * v.element_size() for st in opt.torch_opt.state.values()
                          for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
            key = f"{optim}{'_zero' if zero else ''}"
            results[key] = {"metrics": metrics, "params": params, "moment_bytes": moments,
                            "state_bytes": opt_state_bytes_per_device(opt)}
            if optim == "adamw":
                path = save_checkpoint(out_dir, f"{key}.pth", model, opt, 0, STEPS, cfg)
                _, _, third, _ = train_run(model, cfg, batches[STEPS:], 1, opt)
                results[key]["third"] = third[0]
                dist.barrier()
                payload, _ = load_checkpoint(path)
                # resumed the other way: ZeRO <-> plain
                other = _port_config(optim, not zero)
                resumed = fresh()
                resumed.load_state_dict(payload["model"])
                ropt = make_optimizer(other, resumed, steps_per_epoch=100)
                ropt.load_state_dict(payload["optimizer"])
                _, _, third, _ = train_run(resumed, other, batches[STEPS:], 1, ropt)
                results[key]["third_resumed_other_way"] = third[0]
                if zero and r == 0:
                    results[key]["checkpoint_optimizer"] = payload["optimizer"]
    moment_bytes = [None] * W
    dist.all_gather_object(moment_bytes, {k: v["moment_bytes"] for k, v in results.items()
                                          if isinstance(v, dict) and "moment_bytes" in v})
    results["moment_bytes_by_rank"] = moment_bytes
    if r == 0:
        results["names"] = [n for n, p in template.named_parameters() if p.requires_grad]
        torch.save(results, os.path.join(out_dir, "results.pt"))
    dist.destroy_process_group()


def _eval_worker(out_dir, data, ckpt):
    """--eval and --eval_bop through the CLI in one process of the group,
    with each loader's shard recorded."""
    import torch.distributed as dist

    from poet_tpu_torch import cli
    from poet_tpu_torch.data import loader as loader_mod
    from poet_tpu_torch.parallel import mesh
    from poet_tpu_torch.utils.misc import get_rank

    mesh.init_distributed("cpu")
    r = get_rank()
    shards = []
    epoch = loader_mod.PoseDataLoader.epoch

    def recorded(loader, n):
        shards.append(loader._epoch_indices(n).tolist())
        return epoch(loader, n)

    loader_mod.PoseDataLoader.epoch = recorded
    argv = ["--dataset_path", data, "--output_dir", out_dir, "--resume", ckpt] + CLI_SMALL
    cli.run(argv + ["--eval", "--device", "cpu", "--mesh_data", "2"])
    cli.run(argv + ["--eval_bop", "--device", "cpu"])
    with open(os.path.join(out_dir, f"shards_{r}.json"), "w") as f:
        json.dump(shards, f)
    dist.destroy_process_group()


CLI_SMALL = ["--n_classes", "3", "--batch_size", "2", "--eval_batch_size", "2",
             "--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "2",
             "--dim_feedforward", "64", "--num_queries", "4", "--num_workers", "1",
             "--dropout", "0.0"]


def start_children(mode: str, n: int, *args):
    """`n` processes of this file in `mode`, in one gloo group on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, __file__, mode, *args], cwd=ROOT,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return mode, procs


def join_children(started, timeout=CHILD_TIMEOUT_S):
    """Each process joined within `timeout` s of the call, killed after it;
    the test fails with their output on a timeout or an error."""
    mode, procs = started
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                outs.append(p.communicate()[0])
                pytest.fail(f"{mode}: a process did not finish in {timeout} s:\n"
                            + "\n".join(o[-3000:] for o in outs))
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} rank {r} exited {p.returncode}:\n{out[-6000:]}"
    return outs


# ---------------------------------------------------------------- the tests
@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """The seeded weights every run starts from, and a file of them."""
    state = initial_model().state_dict()
    path = str(tmp_path_factory.mktemp("start") / "start.pt")
    torch.save(state, path)
    return state, path


@pytest.fixture(scope="module")
def batches(tmp_path_factory, start):
    """The global batches, the target rotations the midpoints of the start
    model's predictions, and a file of them for the children."""
    from tests.test_torch_variants import _midpoint_targets, _rotation_margin

    model = initial_model(start[0])
    out = [_midpoint_targets(model, global_batch(s)) for s in range(STEPS + 1)]
    for b in out:
        assert _rotation_margin(model, b) > 0.5
    path = str(tmp_path_factory.mktemp("batches") / "batches.npz")
    np.savez(path, **{f"{name}{s}": a for s, (i, m, _) in enumerate(out)
                      for name, a in (("images", i), ("pad_mask", m))},
             **{f"t{s}_{k}": v for s, (_, _, t) in enumerate(out) for k, v in t.items()})
    return out, path


@pytest.fixture(scope="module")
def children(tmp_path_factory, batches, start):
    """The 4 processes, started: they train while this process computes the
    references."""
    out = str(tmp_path_factory.mktemp("ddp"))
    started = start_children("train", W, out, batches[1], start[1])
    yield out, started
    for p in started[1]:
        p.kill()


@pytest.fixture(scope="module")
def ddp(children):
    out, started = children
    join_children(started)
    return torch.load(os.path.join(out, "results.pt"), weights_only=False)


def jax_sgd_steps(batches, start_state):
    """JAX's `make_train_step` with its SGD on each of `batches` (host
    arrays: the global batches), one step each, from the port's
    `start_state`: metrics, gradients and parameters after each step, the
    last two under port names."""
    import jax
    import jax.numpy as jnp
    import optax

    from poet_tpu.config import PoETConfig
    from poet_tpu.engine.train import TrainState, make_optimizer, make_train_step
    from poet_tpu.models import build_model as jbuild
    from poet_tpu.utils.torch_import import (
        convert_poet_checkpoint,
        convert_resnet_fpn,
        state_dict_to_numpy,
    )
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.jax_params import load_jax_params

    tcfg = _port_config("sgd")
    jcfg = PoETConfig()
    for sect in ("model", "optim"):
        for k, v in vars(getattr(tcfg, sect)).items():
            if hasattr(getattr(jcfg, sect), k) and k not in ("dtype",):
                setattr(getattr(jcfg, sect), k, v)
    jcfg.model.dtype = "float32"
    jcfg.model.enc_remat = "off"
    sd = state_dict_to_numpy(start_state)
    tree = convert_poet_checkpoint(sd, enc_layers=ENC, dec_layers=DEC, nheads=HEADS)
    tree["backbone"] = {"fpn_body": convert_resnet_fpn(sd, prefix="backbone.backbone.")}
    params = {"params": tree}
    inner = make_optimizer(jcfg, params, 100)
    tx = optax.GradientTransformation(        # the update, with the gradients kept
        lambda p: (inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)),
        lambda g, s, p=None: (lambda u: (u[0], (u[1], g)))(inner.update(g, s[0], p)))
    state = TrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = make_train_step(jbuild(jcfg), jcfg, tx, donate=False)
    holder = build_model(tcfg)

    def to_port(t):
        load_jax_params(holder, jax.device_get(t))
        return {k: v.detach().clone() for k, v in holder.named_parameters()}

    out = []
    for images, pad_mask, targets in batches:
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(pad_mask),
                              {k: jnp.asarray(v) for k, v in targets.items()},
                              jax.random.PRNGKey(0))
        out.append(({k: float(v) for k, v in metrics.items()},
                    to_port(state.opt_state[1]), to_port(state.params)))
    return out


@pytest.fixture(scope="module")
def jax_steps(children, batches, start):
    """JAX's `make_train_step` with its SGD on the 8 images, 2 steps, from
    the processes' shared start: metrics, gradients and parameters after each
    step, the last two under port names."""
    return jax_sgd_steps(batches[0][:STEPS], start[0])


@pytest.fixture(scope="module")
def one_process(children, batches, start):
    """The port's one-process SGD step on the 8 images, from the same start."""
    model = initial_model(start[0])
    metrics, seen, params, _ = train_run(model, _port_config("sgd"), batches[0], STEPS)
    return metrics, seen, params


def _assert_steps(got, want, names, label, grad_steps=STEPS):
    """(metrics, grads, params) per step of the data-parallel run against a
    reference's, at the train step's tolerances; the gradients of the first
    `grad_steps` steps."""
    (gm, gg, gp), (wm, wg, wp) = got, want
    for s in range(STEPS):
        assert set(gm[s]) == set(wm[s]), label
        for k in wm[s]:
            rtol = GRAD_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(gm[s][k], wm[s][k], rtol=rtol,
                                       err_msg=f"{label} step {s} {k}")
        for n in names if s < grad_steps else ():
            ref = wg[s][n].numpy()
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(gg[s][n].numpy(), ref, rtol=0,
                                       atol=GRAD_RTOL * scale + GRAD_ATOL,
                                       err_msg=f"{label} step {s} grad {n}")
        assert len(gp[s]) > 50
        for n, got in gp[s].items():
            np.testing.assert_allclose(got.numpy(), wp[s][n].detach().numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{label} step {s} param {n}")


def test_batch_has_uneven_and_empty_ranks():
    counts = [int(shard(global_batch(0), r)[2]["n_boxes"].sum()) for r in range(W)]
    assert counts[EMPTY_RANK] == 0 and len(set(counts)) == W, counts


def test_ddp_step_matches_jax_global_batch(jax_steps, ddp):
    """Losses, grad_norm, the summed gradients and the parameters of 2 SGD
    steps over 4 processes equal JAX's step on the 8 images."""
    got = (ddp["sgd"]["metrics"], ddp["sgd"]["grads"], ddp["sgd"]["params"])
    want = ([m for m, _, _ in jax_steps],
            [{n: g[n] for n in ddp["names"] if n in g} for _, g, _ in jax_steps],
            [p for _, _, p in jax_steps])
    trained = [n for n in ddp["names"] if "backbone" not in n]
    assert len(trained) > 50
    _assert_steps(got, want, trained, "jax", grad_steps=1)


def test_ddp_step_matches_one_process(one_process, ddp):
    got = (ddp["sgd"]["metrics"], ddp["sgd"]["grads"], ddp["sgd"]["params"])
    _assert_steps(got, one_process, ddp["names"], "one process")


@pytest.mark.parametrize("optim", ["adamw", "mu_bf16"])
def test_zero_matches_ddp(ddp, optim):
    plain, zero = ddp[optim], ddp[f"{optim}_zero"]
    for s in range(STEPS):
        assert zero["metrics"][s] == pytest.approx(plain["metrics"][s], rel=ZERO_RTOL)
        for n, ref in plain["params"][s].items():
            scale = float(ref.abs().max())
            np.testing.assert_allclose(zero["params"][s][n].numpy(), ref.numpy(), rtol=0,
                                       atol=ZERO_RTOL * scale, err_msg=f"{optim} {s} {n}")


@pytest.mark.parametrize("optim", ["adamw", "mu_bf16"])
def test_zero_moment_bytes_per_process(ddp, optim):
    """Each process holds at most total / W + the largest tensor's moments
    (ZeRO); without ZeRO each holds them all."""
    by_rank = [b[f"{optim}_zero"] for b in ddp["moment_bytes_by_rank"]]
    total = ddp[optim]["moment_bytes"]
    assert sum(by_rank) == total
    per_elem = 8 if optim == "adamw" else 6
    largest = max(v.numel() for n, v in ddp["start"].items() if n in ddp["names"]
                  and "backbone" not in n) * per_elem
    assert max(by_rank) <= total / W + largest, (by_rank, total, largest)
    assert all(b[optim] == total for b in ddp["moment_bytes_by_rank"])


def test_checkpoints_resume_across_zero(ddp):
    """A ZeRO checkpoint resumed without ZeRO, and a plain one under ZeRO,
    take the third step the writing run took; the ZeRO file holds the plain
    optimizer's layout."""
    plain, zero = ddp["adamw"], ddp["adamw_zero"]
    for label, got, want in (("zero->plain", zero["third_resumed_other_way"], zero["third"]),
                             ("plain->zero", plain["third_resumed_other_way"], plain["third"]),
                             ("zero vs plain", zero["third"], plain["third"])):
        for n, ref in want.items():
            scale = float(ref.abs().max())
            np.testing.assert_allclose(got[n].numpy(), ref.numpy(), rtol=0,
                                       atol=ZERO_RTOL * scale, err_msg=f"{label} {n}")
    saved = zero["checkpoint_optimizer"]["torch"]
    model = initial_model(init=False)
    from poet_tpu_torch.engine.train import make_optimizer

    opt = make_optimizer(_port_config("adamw"), model, 100)
    groups = [len(g["params"]) for g in opt.torch_opt.state_dict()["param_groups"]]
    assert [len(g["params"]) for g in saved["param_groups"]] == groups
    assert sorted(saved["state"]) == list(range(sum(groups)))


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """A checkpoint of a small seeded model, then --eval and --eval_bop on 2
    processes and on one."""
    from poet_tpu_torch import cli
    from poet_tpu_torch.engine.checkpoint import save_checkpoint
    from poet_tpu_torch.models import build_model
    from poet_tpu_torch.utils.init import init_weights
    from tests.helpers import make_synthetic_dataset

    root = tmp_path_factory.mktemp("mp_eval")
    data = make_synthetic_dataset(str(root / "data"), n_train=4, n_test=8)
    base = ["--dataset_path", data] + CLI_SMALL + ["--device", "cpu"]
    cfg = cli.parse_config(base)
    ckpt = save_checkpoint(str(root), "checkpoint.pth", init_weights(build_model(cfg), seed=3),
                           None, 0, 0, cfg)
    started = start_children("eval", 2, str(root / "two"), data, ckpt)
    try:
        one = str(root / "one")
        cli.run(base + ["--output_dir", one, "--resume", ckpt, "--eval"])
        cli.run(base + ["--output_dir", one, "--resume", ckpt, "--eval_bop"])
    finally:
        join_children(started)
    return root, data


def test_eval_two_processes_writes_one_process_files(eval_runs):
    root, _ = eval_runs
    one, two = root / "one" / "eval_test_gt", root / "two" / "eval_test_gt"
    names = sorted(str(p.relative_to(one)) for p in one.rglob("*") if p.is_file())
    assert len(names) >= 10
    assert names == sorted(str(p.relative_to(two)) for p in two.rglob("*") if p.is_file())
    for n in names:
        assert (one / n).read_bytes() == (two / n).read_bytes(), n
    rows = [(root / d / "bop_gt" / "ycbv.csv").read_text().splitlines() for d in ("one", "two")]
    assert len(rows[0]) > 8
    strip = [[ln.rsplit(",", 1)[0] for ln in r[1:]] for r in rows]     # the time column
    assert rows[0][0] == rows[1][0] and strip[0] == strip[1]


def test_eval_loader_shards_match_jax(eval_runs):
    """Each process's eval loader takes its contiguous shard, as JAX's
    loader does with the same process index and count (the CLI passes
    both)."""
    from poet_tpu.data.dataset import build_dataset as jbuild
    from poet_tpu.data.loader import PoseDataLoader as JLoader

    from poet_tpu_torch.cli import parse_config

    root, data = eval_runs
    cfg = parse_config(["--dataset_path", data] + CLI_SMALL)
    ds = jbuild(cfg.data.eval_set, cfg)
    seen = []
    for r in range(2):
        with open(root / "two" / f"shards_{r}.json") as f:
            shards = json.load(f)
        want = JLoader(ds, batch_size=2, num_queries=4, shuffle=False, drop_last=False,
                       process_index=r, process_count=2)._epoch_indices(0).tolist()
        assert shards == [want, want], (r, shards, want)
        seen += want
    assert sorted(seen) == list(range(len(ds)))


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, *rest = sys.argv[1:]
    if mode == "train":
        _train_worker(*rest)
    else:
        _eval_worker(*rest)
