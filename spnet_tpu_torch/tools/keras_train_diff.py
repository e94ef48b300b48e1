"""Step-level trainer differential: the port against tf.keras.

    python -m spnet_tpu_torch.tools.keras_train_diff [steps] [batch] \\
        [n_frames] [--device cuda|cpu]

Counterpart of the JAX package's `scripts/keras_train_diff.py`, with its
argv and defaults (30 steps, b=16, 256 frames; input 128, lr 4e-5): the
same model (the colorizer stem, Keras's MobileNet, the Dense head) built
in tf.keras (`build_keras_twin`) and in the port (SPNet(MobileNet),
float32, dropout 0), the Keras init copied into the port (the backbone
through `io/keras_import.py::keras_mobilenet_to_flax` +
`apply_backbone_weights`, the stem and head through
`keras_stem_head_to_port`), identical float32 batches with augmentation
and dropout off, and compared:

  1. the forward pass at init (eval mode): max|d| / std of Keras's output;
  2. the first optimizer step exactly: the updates of four anchors (the
     stem's colorizer and conv3, the head's kernel, the backbone's conv1),
     with the share of entries whose updates differ by more than 1 % of
     lr (`off_share`; a single sign flip of a saturated +-lr Adam update
     gives a `rel_err` of 2 on its own);
  3. the loss over N steps (float32 reduction orders drift apart; what
     matters is that nothing diverges systematically).

The frames are the port's `synthetic_dataset` on the given device (the
port's noise is its own): the tool holds the port to Keras, not to JAX.
SPNET_ADAM=keras switches the port to Keras-semantics Adam
(`train/optim.py`).  TensorFlow runs on the host's CPU; the port on
`--device` (default SPNET_DEVICE, else cuda).  Needs tensorflow (with
Keras 3 on its tensorflow backend), which the card's host does not have.
Prints `KERAS_DIFF_RESULT {json}`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from spnet_tpu_torch.config import IND_A, IND_ANGLE1, IND_ANGLE2, IND_B, \
    IND_CX, IND_CY, IND_NOOBJ, IND_RINGS, VARS_PER_PRED, ExperimentConfig, \
    GridSpec, LossWeights, ModelConfig
from spnet_tpu_torch.convert import _convert_leaf
from spnet_tpu_torch.data.dataset import synthetic_dataset
from spnet_tpu_torch.io.keras_import import apply_backbone_weights, \
    keras_mobilenet_to_flax
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.tools.runtime import tool_device
from spnet_tpu_torch.train.state import create_train_state
from spnet_tpu_torch.train.steps import make_train_step

INPUT_SIZE, LR = 128, 4e-5
#: update differences above this share of lr count as off (`off_share`)
OFF_FRACTION = 0.01


def tensorflow():
    """The tensorflow module, with Keras 3 on its tensorflow backend;
    raises ImportError saying so where it is missing."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "keras_train_diff compares the port with tf.keras and needs "
            "tensorflow (and Keras on its tensorflow backend), which is "
            "not installed here; run it on a host that has them (the "
            "card's host does not)") from e
    if tf.keras.backend.backend() != "tensorflow":
        raise ImportError(f"Keras runs on its {tf.keras.backend.backend()!r}"
                          " backend; set KERAS_BACKEND=tensorflow")
    return tf


def build_keras_twin(input_size: int, seed: int):
    """tf.keras model mirroring the port's SPNet(MobileNet): the same layer
    shapes, the same init family (glorot_uniform), BN eps 1e-3 / momentum
    0.99, LeakyReLU(0.1), no dropout; returns (model, backbone, the
    kernels of the L2 'reference' scope: the stem convs, the head and the
    backbone's conv1 / conv_dw_2 / conv_pw_2 (the port's block2))."""
    tf = tensorflow()
    tf.keras.utils.set_random_seed(seed)
    L = tf.keras.layers

    inp = L.Input((input_size, input_size, 1))
    x = L.Conv2D(3, (3, 3), padding="same", use_bias=False,
                 name="colorizer")(inp)
    x = L.AveragePooling2D((2, 2))(x)
    x = L.BatchNormalization(momentum=0.99, epsilon=1e-3, name="bn1")(x)
    x = L.LeakyReLU(0.1)(x)
    x = L.Conv2D(3, (3, 3), padding="same", use_bias=False,
                 name="conv2")(x)
    x = L.BatchNormalization(momentum=0.99, epsilon=1e-3, name="bn2")(x)
    x = L.LeakyReLU(0.1)(x)
    x = L.Conv2D(3, (3, 3), padding="same", use_bias=False,
                 name="conv3")(x)
    x = L.BatchNormalization(momentum=0.99, epsilon=1e-3, name="bn3")(x)
    skip = L.AveragePooling2D((2, 2))(inp)
    x = L.Lambda(lambda t: t[0] + t[1])([x, skip])  # 1ch skip broadcast

    half = input_size // 2
    backbone = tf.keras.applications.MobileNet(
        include_top=False, weights=None, input_shape=(half, half, 3))
    x = backbone(x)
    x = L.Flatten()(x)
    out = L.Dense(576, name="final_output")(x)
    model = tf.keras.Model(inp, out)
    reg_weights = [model.get_layer(n).trainable_weights[0]
                   for n in ("colorizer", "conv2", "conv3", "final_output")]
    reg_weights += [backbone.get_layer(n).trainable_weights[0]
                    for n in ("conv1", "conv_dw_2", "conv_pw_2")]
    return model, backbone, reg_weights


def keras_stem_head_to_port(kmodel, model: torch.nn.Module) -> None:
    """Copy the Keras stem (colorizer, conv2, conv3 and their BNs) and the
    Dense head into the port's model in place, through the flax-layout
    leaf conversion of `convert.py`; every leaf must meet a key of the
    model's with its shape."""
    by_name = {layer.name: layer for layer in kmodel.layers}
    leaves = [(("stem", n, "kernel"), by_name[n].get_weights()[0])
              for n in ("colorizer", "conv2", "conv3")]
    for n in ("bn1", "bn2", "bn3"):
        g, b, mu, var = by_name[n].get_weights()
        leaves += [(("stem", n, k), v) for k, v in (
            ("scale", g), ("bias", b), ("mean", mu), ("var", var))]
    k, b = by_name["final_output"].get_weights()
    leaves += [(("final_output", "kernel"), k), (("final_output", "bias"), b)]
    sd = model.state_dict()
    with torch.no_grad():
        for path, leaf in leaves:
            key, arr = _convert_leaf(path, np.asarray(leaf, np.float32))
            if tuple(sd[key].shape) != arr.shape:
                raise ValueError(f"{key}: Keras {arr.shape} != port "
                                 f"{tuple(sd[key].shape)}")
            sd[key].copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def keras_loss_fn(y_true, y_pred):
    """The tf twin of `ops/losses.py::loss_components` ('same')."""
    tf = tensorflow()
    w = LossWeights()
    m = y_true.shape[-1]
    yt = tf.reshape(y_true, (-1, m // VARS_PER_PRED, VARS_PER_PRED))
    yp = tf.reshape(y_pred, (-1, m // VARS_PER_PRED, VARS_PER_PRED))
    d = yp - yt
    pobj = 1.0 - yt[..., IND_NOOBJ]
    center = w.center * pobj * (d[..., IND_CX] ** 2 + d[..., IND_CY] ** 2)
    size = w.size * pobj * (d[..., IND_A] ** 2 + d[..., IND_B] ** 2)
    angle = (w.angle * pobj
             * (d[..., IND_ANGLE1] ** 2 + d[..., IND_ANGLE2] ** 2)
             * (yt[..., IND_A] - yt[..., IND_B]) ** 2)
    noobj = w.noobj * d[..., IND_NOOBJ] ** 2
    rings = w.rings * pobj * d[..., IND_RINGS] ** 2
    total = tf.reduce_sum(center + size + angle + noobj + rings,
                          axis=-1) / float(m)
    return tf.reduce_mean(total)


def _keras_layout(t: torch.Tensor) -> np.ndarray:
    """A port kernel in Keras's layout: conv OIHW -> HWIO, Dense (out, in)
    -> (in, out)."""
    a = t.detach().cpu().numpy()
    return np.array(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T)


def main(argv=None, *, input_size: int = INPUT_SIZE) -> dict:
    """The run's dict.  `input_size` is the JAX script's fixed 128; the
    keyword lets a CPU test run it small."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("steps", type=int, nargs="?", default=30)
    p.add_argument("batch", type=int, nargs="?", default=16)
    p.add_argument("n_frames", type=int, nargs="?", default=256)
    p.add_argument("--device", default=None,
                   help="the port's device; default SPNET_DEVICE, else "
                        "'cuda'")
    args = p.parse_args(argv)
    steps, batch, n_frames = args.steps, args.batch, args.n_frames
    tf = tensorflow()
    tf.config.set_visible_devices([], "GPU")
    device = tool_device(args.device)

    grid = GridSpec()
    ds = synthetic_dataset(n_frames, grid, seed=0, input_size=input_size,
                           device=device)
    x_all = ((ds.x.astype(np.float32) / 255.0) - 0.5) * 2.0
    y_all = np.asarray(ds.y, np.float32)
    print(f"data: {x_all.shape} {y_all.shape}", flush=True)

    # --- keras side -------------------------------------------------
    kmodel, kbackbone, reg_weights = build_keras_twin(input_size, seed=0)
    opt = tf.keras.optimizers.Adam(learning_rate=LR, epsilon=1e-7)

    @tf.function
    def k_step(xb, yb):
        with tf.GradientTape() as tape:
            yp = kmodel(xb, training=True)
            data_loss = keras_loss_fn(yb, yp)
            l2 = tf.add_n([tf.reduce_sum(tf.square(w))
                           for w in reg_weights])
            loss = data_loss + 1e-4 * l2
        grads = tape.gradient(loss, kmodel.trainable_variables)
        opt.apply_gradients(zip(grads, kmodel.trainable_variables))
        return data_loss

    # --- the port, initialized from the Keras weights ---------------
    cfg = ExperimentConfig(grid=grid, model=ModelConfig(
        backbone="MobileNet", input_size=input_size,
        compute_dtype="float32", dropout_rate=0.0))
    model = build_model(cfg.model, num_outputs=grid.num_outputs,
                        device=device)
    apply_backbone_weights(model, *keras_mobilenet_to_flax(kbackbone))
    keras_stem_head_to_port(kmodel, model)
    state = create_train_state(model, lambda _: LR)
    train_step = make_train_step(model, cfg.loss_weights,
                                 loss_type=cfg.model.loss_type,
                                 l2_reg=cfg.model.l2_reg, augment=False,
                                 indexed=False)
    gen = torch.Generator(device=device).manual_seed(1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # init parity: forward pass on the first batch (eval mode)
    xb0, yb0 = x_all[:batch], y_all[:batch]
    yk = kmodel(xb0, training=False).numpy()
    with torch.no_grad():
        yt = model.eval()(put(xb0)).cpu().numpy()
    fwd_rel = float(np.max(np.abs(yk - yt)) / (np.std(yk) + 1e-12))
    print(f"init forward max|d|/std = {fwd_rel:.3e}", flush=True)

    # --- step 1, compared exactly ------------------------------------
    anchors = {
        "stem/colorizer": (kmodel.get_layer("colorizer"),
                           model.stem.colorizer.weight),
        "stem/conv3": (kmodel.get_layer("conv3"), model.stem.conv3.weight),
        "head/dense": (kmodel.get_layer("final_output"),
                       model.final_output.weight),
        "backbone/conv1": (kbackbone.get_layer("conv1"),
                           model.backbone.conv1.conv.weight),
    }
    t_before = {k: _keras_layout(p) for k, (_, p) in anchors.items()}
    state, metrics = train_step(state, put(xb0), put(yb0), gen)
    t_loss1 = float(metrics["data_loss"])
    t_after = {k: _keras_layout(p) for k, (_, p) in anchors.items()}
    k_before = {k: layer.trainable_weights[0].numpy()
                for k, (layer, _) in anchors.items()}
    k_loss1 = float(k_step(tf.constant(xb0), tf.constant(yb0)))
    k_after = {k: layer.trainable_weights[0].numpy()
               for k, (layer, _) in anchors.items()}

    step1 = {}
    for label in anchors:
        dk = k_after[label] - k_before[label]
        dt = t_after[label] - t_before[label]
        diff = np.abs(dk - dt)
        step1[label] = {
            "keras_upd_max": float(np.max(np.abs(dk))),
            "torch_upd_max": float(np.max(np.abs(dt))),
            "rel_err": float(np.max(diff) / (np.max(np.abs(dk)) + 1e-30)),
            "off_share": float(np.mean(diff > OFF_FRACTION * LR)),
        }
        print(f"step-1 {label}: |dk|max {step1[label]['keras_upd_max']:.3e}"
              f"  |dt|max {step1[label]['torch_upd_max']:.3e}"
              f"  rel err {step1[label]['rel_err']:.3e}  off share "
              f"{step1[label]['off_share']:.3e}", flush=True)
    print(f"step-1 loss: keras {k_loss1:.6f}  torch {t_loss1:.6f}",
          flush=True)

    # --- trajectory -------------------------------------------------
    k_losses, t_losses = [k_loss1], [t_loss1]
    for t in range(1, steps):
        lo = (t * batch) % (n_frames - batch + 1)
        xb, yb = x_all[lo:lo + batch], y_all[lo:lo + batch]
        k_losses.append(float(k_step(tf.constant(xb), tf.constant(yb))))
        state, metrics = train_step(state, put(xb), put(yb), gen)
        t_losses.append(float(metrics["data_loss"]))
        if t % 5 == 0 or t == steps - 1:
            print(f"step {t:3d}: keras {k_losses[-1]:.6f} "
                  f"torch {t_losses[-1]:.6f}", flush=True)

    traj_rel = [abs(a - b) / (abs(a) + 1e-12)
                for a, b in zip(k_losses, t_losses)]
    out = {
        "adam_variant": os.environ.get("SPNET_ADAM", "optax"),
        "device": str(device),
        "fwd_rel": fwd_rel,
        "step1": step1,
        "loss_keras_first_last": [k_losses[0], k_losses[-1]],
        "loss_torch_first_last": [t_losses[0], t_losses[-1]],
        "traj_rel_max": max(traj_rel),
        "traj_rel_final": traj_rel[-1],
    }
    print("KERAS_DIFF_RESULT " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
