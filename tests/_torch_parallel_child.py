"""One rank of a gloo process group on the CPU, for
tests/test_torch_parallel.py.

    python tests/_torch_parallel_child.py MODE RANK WORLD PORT DIR

WORLD 0 runs MODE in one process without a group.  The inputs are files in
DIR that the test wrote; the rank writes its results to DIR/MODE_w{WORLD}
_r{RANK}.npz.  Imports torch and the port, never jax.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from spnet_tpu_torch.config import ExperimentConfig, LossWeights, \
    ModelConfig  # noqa: E402
from spnet_tpu_torch.data.dataset import Dataset  # noqa: E402
from spnet_tpu_torch.models.layers import BatchNorm, Dropout  # noqa: E402
from spnet_tpu_torch.models.spnet import build_model  # noqa: E402
from spnet_tpu_torch.parallel import mesh  # noqa: E402
from spnet_tpu_torch.ops.augment import augment_on_the_fly, \
    geo_augment_batch  # noqa: E402
from spnet_tpu_torch.parallel.multihost import ShardedRows, \
    maybe_initialize, process_shard  # noqa: E402
from spnet_tpu_torch.train import loop  # noqa: E402
from spnet_tpu_torch.train.loop import train_network  # noqa: E402
from spnet_tpu_torch.train.schedule import onecycle_schedule  # noqa: E402
from spnet_tpu_torch.train.state import create_train_state  # noqa: E402
from spnet_tpu_torch.train.steps import _prep_x, forward_loss, \
    make_train_step  # noqa: E402

torch.set_num_threads(1)
# the DDP step's model: full-width Xception on a 96^2 frame, float32
STEP_CFG = ModelConfig(input_size=96, compute_dtype="float32",
                       dropout_rate=0.0)
LR_MAX, TOTAL = 1e-3, 100


def _bn(d: str) -> dict:
    """Train-mode BatchNorm (with and without scale, as IRv2's) over this
    rank's rows of the global batch: output, input gradient of
    sum(out * g), parameter gradients and running statistics."""
    z = np.load(os.path.join(d, "bn_in.npz"))
    out = {}
    for tag, scale in (("scaled", True), ("gammaless", False)):
        bn = BatchNorm(z["x"].shape[-1], scale=scale).train()
        with torch.no_grad():
            if scale:
                bn.weight.copy_(torch.from_numpy(z["w"]))
            bn.bias.copy_(torch.from_numpy(z["b"]))
        x = mesh.local_rows(torch.from_numpy(z["x"])).requires_grad_()
        y = bn(x)
        (y * mesh.local_rows(torch.from_numpy(z["g"]))).sum().backward()
        out.update({f"{tag}_out": y.detach().numpy(),
                    f"{tag}_dx": x.grad.numpy(),
                    f"{tag}_db": bn.bias.grad.numpy(),
                    f"{tag}_mean": bn.running_mean.numpy(),
                    f"{tag}_var": bn.running_var.numpy()})
        if scale:
            out[f"{tag}_dw"] = bn.weight.grad.numpy()
    return out


def _aug(d: str) -> dict:
    """This rank's rows of the global batch through the train step's
    random stages, drawn from one seeded generator: the geometric warp
    with its label remap, cutout / salt & pepper / blur, then dropout."""
    z = np.load(os.path.join(d, "aug_in.npz"))
    x, rows, mask = (mesh.local_rows(torch.from_numpy(z[k]))
                     for k in ("x", "rows", "mask"))
    gen = torch.Generator().manual_seed(3)
    geo_x, geo_rows = geo_augment_batch(x, rows, mask, gen)
    aug_x = augment_on_the_fly(geo_x, gen, blur_prob=0.5)
    drop = Dropout(0.5).train()(aug_x, gen)
    return {"geo_x": geo_x.numpy(), "geo_rows": geo_rows.numpy(),
            "aug_x": aug_x.numpy(), "drop": drop.numpy()}


def _step(d: str) -> dict:
    """One data-parallel forward + backward through DDP on the first
    global batch (the loss and the head kernel's gradient), then a train
    step of `make_train_step` on each row of idx (augmentation off,
    dropout 0) from the same weights, without and with the backbone
    checkpointed (remat)."""
    z = torch.load(os.path.join(d, "step_in.pt"))
    x_all, y_all, idx = z["x_all"], z["y_all"], z["idx"]

    def fresh(remat=False):
        m = build_model(dataclasses.replace(STEP_CFG, remat=remat),
                        device="cpu")
        m.load_state_dict(z["state_dict"])
        return m.train()

    model = fresh()
    net = (torch.nn.parallel.DistributedDataParallel(model)
           if mesh.active() else model)
    loss, _ = forward_loss(net, mesh.local_rows(_prep_x(x_all[idx[0]])),
                           mesh.local_rows(y_all[idx[0]]), None,
                           LossWeights(), "same", 1e-4, "reference")
    loss.backward()
    logged = loss.detach().clone()
    if mesh.world_size() > 1:
        torch.distributed.all_reduce(logged)
        logged /= mesh.world_size()
    head_grad = model.final_output.weight.grad.numpy()

    out = {"grad_loss": logged.numpy(), "head_grad": head_grad}
    for tag, remat in (("", False), ("remat_", True)):
        model = fresh(remat)
        state = create_train_state(model, onecycle_schedule(LR_MAX, TOTAL),
                                   adam_variant="optax")
        step = make_train_step(model, LossWeights(), "same", l2_reg=1e-4,
                               augment=False)
        losses = []
        for row in idx:
            state, metrics = step(state, x_all, y_all, row,
                                  torch.Generator().manual_seed(0))
            losses.append(float(metrics["loss"]))
        out.update({f"{tag}losses": np.array(losses),
                    f"{tag}step": np.array(state.step)})
        out.update({f"{tag}sd_{k}": v.numpy()
                    for k, v in model.state_dict().items()})
    return out


def _spy_resident(out: dict) -> None:
    """Record in out['resident_x'] / ['resident_bytes'] the training
    arrays `train_network` puts on its device (`loop._to_device`)."""
    real = loop._to_device

    def spy(ds, val_ds, device, geo=False):
        res = real(ds, val_ds, device, geo)
        train = [a for i, a in enumerate(res) if i != 2 and a is not None]
        out["resident_x"] = res[0].numpy().copy()
        out["resident_bytes"] = np.array(sum(a.numel() * a.element_size()
                                             for a in train))
        return res

    loop._to_device = spy


def _loop_data(d: str):
    """(config, this rank's train and val shards) of loop_in.npz."""
    z = np.load(os.path.join(d, "loop_in.npz"))
    with open(os.path.join(d, "loop_cfg.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())

    def shard(name):  # the whole array without a group
        return mesh.local_rows(z[name])

    grid = cfg.grid
    train = Dataset(x=shard("x"), y=shard("y"), grid=grid,
                    file_list=list(shard("names")))
    val = Dataset(x=shard("vx"), y=shard("vy"), grid=grid,
                  file_list=list(shard("vnames")))
    return cfg, train, val


def _loop(d: str) -> dict:
    """`train_network` on this rank's shards (MobileNetTiny 64^2, float32,
    augmentation and dropout on): 2 epochs, then resumed to 3.  Rank r logs
    into log_r{r}; every rank shares one checkpoint directory.  Records
    the training arrays each run keeps on the device (`_spy_resident`)."""
    cfg, train, val = _loop_data(d)
    r, world = mesh.rank(), int(sys.argv[3])
    tag = f"w{world}"
    out = {}
    _spy_resident(out)
    for epochs in (2, 3):
        run = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, epochs=epochs))
        state, hist = train_network(
            run, train, val, "cpu",
            log_dir=os.path.join(d, f"log_{tag}_r{r}"),
            ckpt_dir=os.path.join(d, f"ckpt_{tag}"), render_overlays=False,
            verbose=0)
        out[f"losses_{epochs}"] = np.array([h["train_loss"] for h in hist])
        out[f"epochs_{epochs}"] = np.array([h["epoch"] for h in hist])
        out[f"step_{epochs}"] = np.array(state.step)
        out[f"val_{epochs}"] = np.array([h["val_comps"]["total"]
                                         for h in hist])
    out.update({f"sd_{k}": v.numpy()
                for k, v in state.model.state_dict().items()})
    return out


def _budget(d: str) -> dict:
    """`train_network` for one epoch with `loop._budget` set to what this
    rank's shard and val shard take: the union of the shards would not
    fit one rank, each shard fits its own."""
    cfg, train, val = _loop_data(d)
    fits = train.x.nbytes + train.y.nbytes + val.x.nbytes
    loop._budget = lambda device: fits
    out = {"budget": np.array(fits)}
    _spy_resident(out)
    run = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=1))
    state, hist = train_network(run, train, val, "cpu",
                                log_dir=os.path.join(d, f"budget_r"
                                                        f"{mesh.rank()}"),
                                render_overlays=False, verbose=0)
    out.update(losses=np.array([h["train_loss"] for h in hist]),
               step=np.array(state.step))
    return out


def _exchange(d: str) -> dict:
    """`ShardedRows` on this rank's shard of exchange_in.npz's global
    arrays (x uint8, y float32, the raw rows float32 and their bool mask,
    N_LOCAL rows a rank): for each step of each order of this world size,
    this rank's rows of the global minibatch.  Writes them stacked, one
    key an array and order."""
    z = np.load(os.path.join(d, "exchange_in.npz"))
    world, r = mesh.world_size(), mesh.rank()
    n = int(z["n_local"])
    shard = ShardedRows([torch.from_numpy(z[k][r * n:(r + 1) * n])
                         for k in ("x", "y", "rows", "mask")])
    out = {"nbytes": np.array(shard.nbytes)}
    for name in z.files:
        if not name.startswith(f"order_w{world}_"):
            continue
        order = z[name]
        plan = shard.plan(order)
        got = [shard.rows(plan, i) for i in range(len(order))]
        for k, key in enumerate(("x", "y", "rows", "mask")):
            out[f"{name}_{key}"] = np.concatenate([g[k].numpy()
                                                   for g in got])
    return out


MODES = {"bn": _bn, "aug": _aug, "step": _step, "loop": _loop,
         "budget": _budget, "exchange": _exchange}


def main():
    mode, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    if world > 0:
        for _ in range(2):  # a second call changes nothing
            assert maybe_initialize(f"localhost:{port}", world, rank,
                                    device="cpu")
        assert process_shard() == (rank, world)
    out = MODES[mode](d)
    np.savez(os.path.join(d, f"{mode}_w{world}_r{rank}.npz"), **out)
    if mesh.active():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
