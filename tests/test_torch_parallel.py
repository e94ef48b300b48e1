"""Data-parallel training in the port (`spnet_tpu_torch/parallel/`,
group-wide BatchNorm, the DDP train step, `train_network` in a group)
against one process and against JAX's mesh step.

The ranks are processes of a gloo group on the CPU
(`tests/_torch_parallel_child.py`), started on a free localhost port, each
with a timeout of its own; WORLD 0 is the same child without a group."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnet_tpu.config import LossWeights as JLossWeights
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.parallel.mesh import batch_sharding, make_mesh
from spnet_tpu.parallel.mesh import replicate_state as j_replicate
from spnet_tpu.train.schedule import onecycle_schedule as j_schedule
from spnet_tpu.train.state import create_train_state as j_create_state
from spnet_tpu.train.steps import make_train_step as j_make_train_step
from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, normalize
from spnet_tpu_torch.models.layers import BatchNorm
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.parallel import mesh
from spnet_tpu_torch.parallel.multihost import host_to_global, \
    is_multiprocess, maybe_initialize, process_shard
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_torch_parallel_child.py")
CHILD_TIMEOUT = 300  # seconds a rank may take
ENV_VARS = ("SPNET_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
            "SPNET_NUM_PROCESSES", "SPNET_PROCESS_ID", "SPNET_DIST",
            "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
            "LOCAL_RANK", "SPNET_LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(mode: str, d: str, worlds=(2,)) -> dict:
    """Start every rank of each world size in `worlds` (0 = one process
    without a group) at once, wait for all, and return their results by
    (world, rank)."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = {}
    for world in worlds:
        port = str(_free_port())
        for r in range(max(world, 1)):
            procs[(world, r)] = subprocess.Popen(
                [sys.executable, CHILD, mode, str(r), str(world), port, d],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    logs = {}
    try:
        for key, p in procs.items():
            logs[key] = p.communicate(timeout=CHILD_TIMEOUT)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for key, p in procs.items():
        assert p.returncode == 0, f"rank {key} failed:\n{logs[key][-3000:]}"
    return {key: dict(np.load(os.path.join(d, f"{mode}_w{key[0]}_r{key[1]}"
                                              ".npz")))
            for key in procs}


def _labels(rng, n, grid=GridSpec()):
    recs = []
    for _ in range(n):
        k = int(rng.integers(1, 6))
        a = rng.uniform(12, 90, k)
        raw = np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                        rng.uniform(grid.cy_min, grid.cy_max, k), a,
                        a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
                        rng.uniform(1, 11, k)], axis=1)
        recs.append(canonicalize_records(raw))
    return normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                     grid).astype(np.float32)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# one process: the helpers without a group
# ---------------------------------------------------------------------------


def test_maybe_initialize_noop_without_config(monkeypatch):
    """No configuration -> no group, False; the helpers are the identity
    of one process (JAX: tests/test_multihost.py)."""
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize() is False
    assert maybe_initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert process_shard() == (0, 1)
    assert not is_multiprocess()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert host_to_global(x) is not None
    np.testing.assert_array_equal(host_to_global(x), x)
    np.testing.assert_array_equal(mesh.local_rows(x), x)
    assert mesh.local_device("cpu") == torch.device("cpu")
    assert mesh.local_device("cuda") == torch.device("cuda")


def test_maybe_initialize_refuses_incomplete_config(monkeypatch):
    """SPNET_DIST=1 (JAX's TPU-pod discovery) has no torch meaning, and a
    coordinator needs the process count and id."""
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SPNET_DIST", "1")
    with pytest.raises(RuntimeError, match="SPNET_DIST"):
        maybe_initialize(device="cpu")
    monkeypatch.delenv("SPNET_DIST")
    monkeypatch.setenv("SPNET_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="SPNET_NUM_PROCESSES"):
        maybe_initialize(device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world,rank,env,cards,want", [
    (1, 0, {}, 1, "cuda:0"),
    (2, 1, {}, 4, "raises: SPNET_LOCAL_RANK"),
    (2, 1, {"LOCAL_RANK": "1"}, 2, "cuda:1"),
    (8, 7, {"SPNET_LOCAL_RANK": "3"}, 4, "cuda:3"),
    (8, 7, {"LOCAL_RANK": "2", "SPNET_LOCAL_RANK": "3"}, 4, "cuda:2"),
    (8, 5, {"SPNET_LOCAL_RANK": "5"}, 4, "raises: absent"),
])
def test_local_device_in_a_group(monkeypatch, world, rank, env, cards, want):
    """A bare 'cuda' in a group is the card LOCAL_RANK (torchrun) or
    SPNET_LOCAL_RANK names on this host, cuda:0 in a group of one; with
    more ranks and neither set it raises, since the global rank names a
    card only on one host (rank 7 of 8 on a 4-card host, or every host's
    rank 1 on its cuda:1 under a JAX-style launch of one process a host,
    would be wrong); a card the host lacks raises.  The group and the
    host's cards are faked."""
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mesh, "active", lambda: True)
    monkeypatch.setattr(mesh, "world_size", lambda: world)
    monkeypatch.setattr(mesh, "rank", lambda: rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want.startswith("raises"):
        with pytest.raises(RuntimeError, match=want.split(": ")[1]):
            mesh.local_device("cuda")
    else:
        assert mesh.local_device("cuda") == torch.device(want)
    assert mesh.local_device("cuda:0") == torch.device("cuda:0")
    assert mesh.local_device("cpu") == torch.device("cpu")


def test_step_is_the_autograd_grad_step():
    """Without a group the train step (`loss.backward()` into `.grad`, the
    body a group's DDP step shares) gives the same bits as the step it
    replaced, `torch.autograd.grad` of the loss: two steps of MobileNetTiny
    64^2 float32 with augmentation and dropout on, the losses and every
    parameter, statistic and Adam moment after them."""
    from spnet_tpu_torch.ops.augment import augment_on_the_fly
    from spnet_tpu_torch.train.steps import _prep_x, forward_loss, \
        make_train_step

    rng = np.random.default_rng(4)
    x_all = torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 1),
                                          dtype=np.uint8))
    y_all = torch.from_numpy(_labels(rng, 8))
    cfg = ModelConfig(backbone="MobileNetTiny", input_size=64,
                      compute_dtype="float32", dropout_rate=0.3)
    runs = {}
    for way in ("step", "autograd.grad"):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(1))
        state = create_train_state(model, onecycle_schedule(1e-3, 100))
        step = make_train_step(model, augment=True)
        gen = torch.Generator().manual_seed(2)
        losses = []
        for idx in (torch.arange(4), torch.arange(4, 8)):
            if way == "step":
                losses.append(step(state, x_all, y_all, idx, gen)[1]["loss"])
                continue
            model.train()
            x = augment_on_the_fly(_prep_x(x_all[idx]), gen)
            loss, _ = forward_loss(model, x, y_all[idx], gen)
            params = list(model.parameters())
            grads = torch.autograd.grad(loss, params)
            state.opt_state = state.optimizer.update(params, grads,
                                                     state.opt_state)
            state.step += 1
            losses.append(loss.detach())
        runs[way] = (torch.stack(losses), model, state.opt_state)
    (l0, m0, o0), (l1, m1, o1) = runs["step"], runs["autograd.grad"]
    sd0, sd1 = m0.state_dict(), m1.state_dict()
    assert torch.equal(l0, l1)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for a, b in zip(o0.mu + o0.nu, o1.mu + o1.nu):
        assert (a is None and b is None) or torch.equal(a, b)
    assert all(p.grad is None for p in m0.parameters())  # nothing held


def test_local_device_absent_card_raises():
    """A CUDA device this host does not have raises (no fall-back to the
    CPU); the rows each rank takes are checked in the 2-rank tests (their
    union in rank order is the global batch)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="absent"):
        mesh.local_device(f"cuda:{n}")


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------


def test_group_batchnorm_matches_one_process(tmp_path):
    """Train-mode BatchNorm on 2 gloo ranks, each on its half of a
    (8, 5, 6, 16) batch, against one process on the whole batch: output
    and input gradient rows, running statistics on both ranks, and the
    parameter gradients summed over the ranks; with and without scale
    (IRv2's gamma-less BN).  float32; rel 1e-6 covers the moments' mean
    of two half-batch means."""
    rng = np.random.default_rng(5)
    c = 16
    z = dict(x=rng.normal(0.4, 1.5, (8, 5, 6, c)).astype(np.float32),
             g=rng.normal(0, 1, (8, 5, 6, c)).astype(np.float32),
             w=rng.uniform(0.5, 1.5, c).astype(np.float32),
             b=rng.normal(0, 0.2, c).astype(np.float32))
    np.savez(tmp_path / "bn_in.npz", **z)
    res = _run_ranks("bn", str(tmp_path))
    for tag, scale in (("scaled", True), ("gammaless", False)):
        bn = BatchNorm(c, scale=scale).train()
        with torch.no_grad():
            if scale:
                bn.weight.copy_(torch.from_numpy(z["w"]))
            bn.bias.copy_(torch.from_numpy(z["b"]))
        x = torch.from_numpy(z["x"]).requires_grad_()
        y = bn(x)
        (y * torch.from_numpy(z["g"])).sum().backward()
        want = {"out": y.detach().numpy(), "dx": x.grad.numpy()}
        for key in ("out", "dx"):
            got = np.concatenate([res[(2, r)][f"{tag}_{key}"]
                                  for r in range(2)])
            assert _rel(got, want[key]) <= 1e-6, (tag, key)
        for r in range(2):
            assert _rel(res[(2, r)][f"{tag}_mean"],
                        bn.running_mean.numpy()) <= 1e-6
            assert _rel(res[(2, r)][f"{tag}_var"],
                        bn.running_var.numpy()) <= 1e-6
        grads = [("db", bn.bias.grad)] + ([("dw", bn.weight.grad)]
                                          if scale else [])
        for key, g in grads:
            got = res[(2, 0)][f"{tag}_{key}"] + res[(2, 1)][f"{tag}_{key}"]
            assert _rel(got, g.numpy()) <= 1e-6, (tag, key)
        # each rank alone (no all-reduce) would differ far beyond that
        half = BatchNorm(c, scale=scale).train()
        y_half = half(torch.from_numpy(z["x"][:4])).detach().numpy()
        assert _rel(y_half, want["out"][:4]) > 1e-2


def test_ranks_augment_their_rows_as_one_process(tmp_path):
    """Each of 2 gloo ranks warps, augments and drops out only its 4 rows
    of an 8-frame global batch, from draws made for the global batch: the
    ranks' rows in rank order are bitwise the one-process run's (the
    geometric warp and its remapped ellipse rows, cutout / salt & pepper /
    blur, the dropout mask), so a run does not depend on the world size
    and no rank augments another's rows."""
    rng = np.random.default_rng(9)
    rows = np.stack([rng.uniform(40, 470, (8, 4)), rng.uniform(40, 340,
                                                               (8, 4)),
                     rng.uniform(30, 80, (8, 4)), rng.uniform(10, 30, (8, 4)),
                     rng.uniform(0, 180, (8, 4)), rng.uniform(1, 9, (8, 4))],
                    axis=-1).astype(np.float32)
    np.savez(tmp_path / "aug_in.npz",
             x=rng.uniform(-1, 1, (8, 48, 64, 1)).astype(np.float32),
             rows=rows, mask=rng.uniform(size=(8, 4)) < 0.7)
    res = _run_ranks("aug", str(tmp_path), worlds=(2, 0))
    for k, want in res[(0, 0)].items():
        got = np.concatenate([res[(2, r)][k] for r in range(2)])
        np.testing.assert_array_equal(got, want, err_msg=k)
    # the draws differ between the halves: each rank kept its own rows
    assert not np.array_equal(res[(2, 0)]["drop"] == 0,
                              res[(2, 1)]["drop"] == 0)


@pytest.fixture(scope="module")
def step_setup(tmp_path_factory):
    """Full-width Xception at 96^2, float32, dropout 0, from JAX's init
    with perturbed BN; 8 seeded frames; two steps of b=4 (global)."""
    d = tmp_path_factory.mktemp("dp_step")
    rng = np.random.default_rng(0)
    jcfg = JModelConfig(input_size=96, compute_dtype="float32",
                        dropout_rate=0.0)
    jm = jbuild(jcfg)
    x_all = rng.integers(0, 256, (8, 96, 96, 1), dtype=np.uint8)
    y_all = _labels(rng, 8)
    v = jax.jit(lambda k, x: jm.init({"params": k, "dropout": k}, x,
                                     train=False))(
        jax.random.key(0), x_all[:1].astype(np.float32))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.6, 1.4, a.shape).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"]))
    idx = np.array([[0, 3, 5, 6], [1, 2, 4, 7]], np.int64)
    model = build_model(ModelConfig(input_size=96, compute_dtype="float32",
                                    dropout_rate=0.0), device="cpu")
    sd = flax_to_state_dict(params, stats, model)
    torch.save({"state_dict": sd, "x_all": torch.from_numpy(x_all),
                "y_all": torch.from_numpy(y_all),
                "idx": torch.from_numpy(idx)}, d / "step_in.pt")
    res = _run_ranks("step", str(d), worlds=(2, 1, 0))

    # JAX's mesh step over 2 devices: the batch sharded, global-batch BN
    mesh2 = make_mesh(2)
    j_state = j_create_state(jm, jax.random.key(0),
                             jnp.zeros((4, 96, 96, 1)), j_schedule(1e-3, 100),
                             adam_variant="optax")
    j_state = j_replicate(mesh2, j_state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats)))
    j_step = j_make_train_step(jm, JLossWeights(), "same", l2_reg=1e-4,
                               augment=False, indexed="epoch", mesh=mesh2,
                               pregather=False)
    put = batch_sharding(mesh2)
    j_state, j_losses = j_step(j_state, jax.device_put(x_all, put),
                               jax.device_put(y_all, put),
                               jnp.asarray(idx.astype(np.int32)),
                               jax.random.key(1))
    j_sd = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, j_state.params),
        jax.tree_util.tree_map(np.asarray, j_state.batch_stats), model)
    return res, np.asarray(j_losses), j_sd


def _state_close(got: dict, want: dict, sum_lr: float, stats_rtol: float):
    """Running statistics within stats_rtol of their scale; weights in
    units of the learning rate, as tests/test_torch_train.py bounds them:
    Adam moves a weight ~lr a step whatever its gradient's size, so where
    a gradient is near zero float32 noise may flip its sign (up to 2 lr a
    step); the bulk of each leaf must agree far closer."""
    for k, ref in want.items():
        ref = ref.numpy()
        g = got[f"sd_{k}"]
        if k.endswith(("running_mean", "running_var")):
            assert _rel(g, ref) <= stats_rtol, k
            continue
        dev = np.abs(g - ref).ravel() / sum_lr
        assert dev.max() <= 2.0, (k, dev.max())
        assert np.median(dev) <= 0.05 and np.quantile(dev, 0.99) <= 0.5, k


def test_ddp_step_matches_one_process(step_setup):
    """2 gloo ranks (2 frames each) against one process on the 4 frames:
    the loss of a DDP forward rel 1e-6, the head kernel's averaged gradient
    rel 1e-5 of its max, two train steps' losses rel 1e-5, the running
    statistics rel 1e-4 (the second step's come from weights that the
    first step's float32 noise moved), the weights as `_state_close` says;
    both ranks' states bitwise equal."""
    res, _, _ = step_setup
    one, r0, r1 = res[(0, 0)], res[(2, 0)], res[(2, 1)]
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r0["step"]) == int(one["step"]) == 2
    assert abs(float(r0["grad_loss"]) / float(one["grad_loss"]) - 1) <= 1e-6
    assert _rel(r0["head_grad"], one["head_grad"]) <= 1e-5
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-5)
    sched = j_schedule(1e-3, 100)
    want = {k[3:]: torch.from_numpy(v) for k, v in one.items()
            if k.startswith("sd_")}
    _state_close(r0, want, float(sched(0) + sched(1)), 1e-4)


def test_ddp_step_matches_jax_mesh(step_setup):
    """The 2-rank DDP steps against JAX's 2-device mesh step
    (`make_mesh(2)`, batch sharded, state replicated) from the converted
    weights: both steps' losses rel 1e-4 and the state after them as
    tests/test_torch_train.py holds one process to one device (running
    statistics rel 1e-4)."""
    res, j_losses, j_sd = step_setup
    r0 = res[(2, 0)]
    np.testing.assert_allclose(r0["losses"], j_losses, rtol=1e-4)
    sched = j_schedule(1e-3, 100)
    _state_close(r0, j_sd, float(sched(0) + sched(1)), 1e-4)


def test_world_size_one_group_is_bitwise_no_group(step_setup):
    """A group of one rank (DDP wraps the model, the logged loss is
    all-reduced, BatchNorm takes its own statistics) gives the same bits
    as no group: the DDP forward's loss and head gradient, both steps'
    losses and every parameter and statistic after them."""
    res, _, _ = step_setup
    one, w1 = res[(0, 0)], res[(1, 0)]
    assert set(one) == set(w1)
    for k in one:
        np.testing.assert_array_equal(w1[k], one[k], err_msg=k)


def test_remat_under_ddp_is_bitwise(step_setup):
    """With the backbone checkpointed (remat), the recompute runs the
    BatchNorm all-reduces again inside DDP's backward but leaves the
    running statistics alone (`_stats_frozen`): on every rank and with no
    group, the two steps' losses, weights and statistics are bitwise
    those without remat."""
    res, _, _ = step_setup
    for key in ((2, 0), (2, 1), (1, 0), (0, 0)):
        r = res[key]
        plain = {k: v for k, v in r.items() if k.startswith(("sd_", "losses"))}
        for k, v in plain.items():
            np.testing.assert_array_equal(r["remat_" + k], v,
                                          err_msg=f"{key} {k}")


def test_train_network_two_ranks(tmp_path):
    """`train_network` on 2 gloo ranks, each with its half of 32 train and
    16 val frames (MobileNetTiny 64^2, float32, b=8 global, augmentation
    and dropout on, half the backbone frozen for the first epoch, so DDP
    runs through the unfreeze): 2 epochs, then resumed to 3.  Both ranks'
    losses and final states bitwise equal; each rank's own shard (and
    only it) resident (rank 0 x[:16], rank 1 x[16:]); the global step
    count (4 an epoch); rank 0 alone writes losses.dat and the checkpoint; and the run
    follows the one-process run on the whole set (the same epoch order,
    augmentation and dropout draws): losses rel 1e-4 (measured 1.2e-5,
    7.1e-7 without the freeze; the float32 BatchNorm moments of half
    batches differ in the last bits, which Adam's sign-like first steps,
    again after the unfreeze's fresh moments, amplify with the learning
    rate: at lr_max 1e-3 the same runs part by 7e-3 in epoch 2, so the run
    trains at 1e-5)."""
    rng = np.random.default_rng(11)
    cfg = ExperimentConfig(
        model=ModelConfig(backbone="MobileNetTiny", input_size=64,
                          compute_dtype="float32"),
        train=TrainConfig(batch_size=8, epochs=2, save_every=1, seed=3,
                          lr_max=1e-5, freeze_fac=0.5, frozen_epochs=1))
    (tmp_path / "loop_cfg.json").write_text(cfg.to_json())
    np.savez(tmp_path / "loop_in.npz",
             x=rng.integers(0, 256, (32, 64, 64, 1), dtype=np.uint8),
             y=_labels(rng, 32),
             names=np.array([f"t{i}" for i in range(32)]),
             vx=rng.integers(0, 256, (16, 64, 64, 1), dtype=np.uint8),
             vy=_labels(rng, 16),
             vnames=np.array([f"v{i}" for i in range(16)]))
    res = _run_ranks("loop", str(tmp_path), worlds=(2, 0))
    z = np.load(tmp_path / "loop_in.npz")
    one, r0, r1 = res[(0, 0)], res[(2, 0)], res[(2, 1)]
    for k in r0:
        # each rank scores its own val shard and holds its own train shard
        if not k.startswith(("val_", "resident_")):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_array_equal(r0["resident_x"], z["x"][:16])
    np.testing.assert_array_equal(r1["resident_x"], z["x"][16:])
    assert int(r0["resident_bytes"]) == int(r1["resident_bytes"]) == (
        z["x"].nbytes + z["y"].nbytes) // 2
    assert r0["epochs_2"].tolist() == [0, 1]
    assert r0["epochs_3"].tolist() == [2]
    assert int(r0["step_2"]) == 8 and int(r0["step_3"]) == 12
    assert not (tmp_path / "log_w2_r1").exists()
    rows = [r for r in (tmp_path / "log_w2_r0" / "losses.dat").read_text()
            .splitlines() if not r.startswith("#")]
    assert len(rows) == 3
    assert os.path.exists(tmp_path / "ckpt_w2")
    for e in (2, 3):
        np.testing.assert_allclose(r0[f"losses_{e}"], one[f"losses_{e}"],
                                   rtol=1e-4)
    assert np.isfinite(r0["val_2"]).all() and np.isfinite(r1["val_2"]).all()


N_LOCAL, EXCHANGE_BATCH = 10, 6  # rows a rank; a global batch (W = 2, 3)


def _exchange_orders(rng, world: int) -> dict:
    """Global orders (steps, EXCHANGE_BATCH) over world * N_LOCAL rows:
    seeded random draws with repeats, the epoch order `train_network`
    walks, an order whose whole minibatch lives on the last rank, and one
    whose every rank's slice lives wholly on one other rank."""
    from spnet_tpu_torch.train.loop import epoch_order

    n, per = world * N_LOCAL, EXCHANGE_BATCH // world
    last = rng.integers((world - 1) * N_LOCAL, n, (2, EXCHANGE_BATCH))
    other = np.concatenate([
        rng.integers(((r + 1) % world) * N_LOCAL,
                     ((r + 1) % world + 1) * N_LOCAL, (3, per))
        for r in range(world)], axis=1)
    return {"random": rng.integers(0, n, (5, EXCHANGE_BATCH)),
            "epoch": epoch_order(n, EXCHANGE_BATCH, 3, 1, repeats=2),
            "one_rank": last, "other_rank": other}


def test_sharded_rows_exchange(tmp_path):
    """`ShardedRows` on W = 2 and W = 3 gloo ranks, each holding its
    N_LOCAL rows of a global set (x uint8 frames, y float32 labels, the
    geometric rows float32 and their bool mask): for every step of
    random orders, an epoch order, an order that lives wholly on one
    rank and one whose every slice lives on another rank, each rank's
    received rows are bitwise union[idx_r] of every array, where idx_r is
    its slice of the step's global minibatch; each rank holds 1/W of the
    set's bytes."""
    rng = np.random.default_rng(21)
    n = 3 * N_LOCAL
    z = dict(x=rng.integers(0, 256, (n, 6, 5, 1), dtype=np.uint8),
             y=rng.normal(size=(n, 16)).astype(np.float32),
             rows=rng.normal(size=(n, 4, 6)).astype(np.float32),
             mask=rng.uniform(size=(n, 4)) < 0.5, n_local=N_LOCAL)
    for world in (2, 3):
        for name, order in _exchange_orders(rng, world).items():
            z[f"order_w{world}_{name}"] = order
    np.savez(tmp_path / "exchange_in.npz", **z)
    res = _run_ranks("exchange", str(tmp_path), worlds=(2, 3))
    for world in (2, 3):
        per = EXCHANGE_BATCH // world
        total = sum(z[k][:world * N_LOCAL].nbytes
                    for k in ("x", "y", "rows", "mask"))
        for r in range(world):
            got = res[(world, r)]
            assert int(got["nbytes"]) * world == total
            orders = [k for k in z if k.startswith(f"order_w{world}_")]
            assert len(orders) == 4
            for name in orders:
                idx = z[name][:, r * per:(r + 1) * per].reshape(-1)
                for key in ("x", "y", "rows", "mask"):
                    want = z[key][:world * N_LOCAL][idx]
                    np.testing.assert_array_equal(
                        got[f"{name}_{key}"], want,
                        err_msg=f"W={world} rank {r} {name} {key}")
                    assert got[f"{name}_{key}"].dtype == want.dtype


def test_sharded_set_beyond_one_budget_trains(tmp_path):
    """With `train_network`'s card budget set to what one rank's shard and
    val shard take, a set whose union would not fit one rank trains on 2
    gloo ranks: each rank holds its half, the losses are finite and the
    global steps run (32 frames at b=8 global: 4 steps)."""
    from spnet_tpu_torch.train import loop

    rng = np.random.default_rng(12)
    cfg = ExperimentConfig(
        model=ModelConfig(backbone="MobileNetTiny", input_size=64,
                          compute_dtype="float32"),
        train=TrainConfig(batch_size=8, epochs=1, seed=3, lr_max=1e-5))
    (tmp_path / "loop_cfg.json").write_text(cfg.to_json())
    z = dict(x=rng.integers(0, 256, (32, 64, 64, 1), dtype=np.uint8),
             y=_labels(rng, 32), names=np.array([f"t{i}" for i in range(32)]),
             vx=rng.integers(0, 256, (16, 64, 64, 1), dtype=np.uint8),
             vy=_labels(rng, 16),
             vnames=np.array([f"v{i}" for i in range(16)]))
    np.savez(tmp_path / "loop_in.npz", **z)
    res = _run_ranks("budget", str(tmp_path))
    whole = Dataset(x=z["x"], y=z["y"], grid=cfg.grid,
                    file_list=list(z["names"]))
    val = Dataset(x=z["vx"][:8], y=z["vy"][:8], grid=cfg.grid,
                  file_list=list(z["vnames"][:8]))
    for r in range(2):
        got = res[(2, r)]
        # one rank's budget cannot hold the union with its val shard
        assert loop._resident_bytes(whole, val, False) > int(got["budget"])
        assert int(got["resident_bytes"]) == (z["x"].nbytes
                                              + z["y"].nbytes) // 2
        np.testing.assert_array_equal(got["resident_x"],
                                      z["x"][r * 16:(r + 1) * 16])
        assert np.isfinite(got["losses"]).all() and int(got["step"]) == 4
    np.testing.assert_array_equal(res[(2, 0)]["losses"],
                                  res[(2, 1)]["losses"])


@pytest.mark.parametrize("launcher", ["spnet_env", "torchrun"])
def test_cli_train_two_ranks(tmp_path, launcher):
    """`python -m spnet_tpu_torch train --device cpu` in 2 processes,
    configured by the JAX package's variables (SPNET_COORDINATOR,
    SPNET_NUM_PROCESSES, SPNET_PROCESS_ID) or started by torchrun
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE): each joins the gloo group,
    loads its own file shard (16 of 32 train frames, 4 of 8 val), trains
    the global batch of 4 for one epoch (8 global steps); rank 0 alone
    writes losses.dat, the checkpoint and the final weights, and
    evaluates."""
    from spnet_tpu_torch.data.synth import generate_dataset
    from spnet_tpu_torch.io.checkpoint import load_checkpoint

    generate_dataset(str(tmp_path / "data"), 40, seed=2, train_only=False,
                     device="cpu", verbose=False)
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(HERE))
    train = ["-m", "spnet_tpu_torch", "train", "-d", "data", "-b", "4",
             "-e", "1", "--backbone", "MobileNetTiny", "--input_size", "64",
             "--dtype", "float32", "--device", "cpu", "-w", "ck"]
    if launcher == "torchrun":  # one launcher process, two ranks
        cmds = [([sys.executable, "-m", "torch.distributed.run",
                  "--nproc_per_node=2", "--master_addr=localhost",
                  f"--master_port={_free_port()}"] + train, env)]
    else:
        env.update(SPNET_COORDINATOR=f"localhost:{_free_port()}",
                   SPNET_NUM_PROCESSES="2")
        cmds = [([sys.executable] + train,
                 dict(env, SPNET_PROCESS_ID=str(r))) for r in range(2)]
    procs = [subprocess.Popen(cmd, cwd=tmp_path, env=e,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, e in cmds]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    text = "".join(outs)
    for r in range(2):
        assert f"data-parallel: rank {r}/2 on cpu, file shard {r} of 2" \
            in text
    assert text.count("Starting model evaluation") == 1
    runs = [d for d in os.listdir(tmp_path / "logs") if d != "Evaluation"]
    assert len(runs) == 1
    assert {"losses.dat", "final_weights"} <= set(
        os.listdir(tmp_path / "logs" / runs[0]))
    assert load_checkpoint(str(tmp_path / "ck"))[0]["step"] == 8
