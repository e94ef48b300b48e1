"""`--pretrained` in the port (`spnet_tpu_torch/io/keras_import.py`) on the
CPU, with random-weight Keras models built here (ImageNet files cannot be
fetched): the port's `keras_*_to_flax` give JAX's trees leaf by leaf for
MobileNet, Xception, InceptionResNetV2 and NASNetMobile; each converted
tree loads into the port's backbone; the port's MobileNet reproduces
Keras's output; `train_network` with `pretrained` starts from the file's
weights, and a checkpoint still wins; and `train --pretrained --remat`
runs through the CLI."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

keras = pytest.importorskip("keras")

from spnet_tpu.io import keras_import as jki  # noqa: E402
from spnet_tpu_torch.config import ExperimentConfig, ModelConfig, \
    TrainConfig  # noqa: E402
from spnet_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from spnet_tpu_torch.data.csvio import write_meta_file  # noqa: E402
from spnet_tpu_torch.data.dataset import Dataset  # noqa: E402
from spnet_tpu_torch.io import keras_import as ki  # noqa: E402
from spnet_tpu_torch.io.checkpoint import save_checkpoint  # noqa: E402
from spnet_tpu_torch.models.spnet import build_model  # noqa: E402
from spnet_tpu_torch.train import loop  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERAS_HW = 96  # Keras's input; the port's SPNet at 2x that (its stem halves)
BACKBONES = ("MobileNet", "Xception", "InceptionResNetV2", "NASNetMobile")


def _randomize_bn(km, seed):
    """Non-trivial BN parameters and moving statistics (Keras inits them
    to 1 / 0), so a mix-up of the four BN leaves shows."""
    rng = np.random.default_rng(seed)
    for layer in km.layers:
        if layer.__class__.__name__ == "BatchNormalization":
            layer.set_weights([rng.uniform(0.5, 1.5, w.shape).astype(
                np.float32) for w in layer.get_weights()])
    return km


@pytest.fixture(scope="module")
def keras_models():
    return {name: _randomize_bn(getattr(keras.applications, name)(
        include_top=False, weights=None,
        input_shape=(KERAS_HW, KERAS_HW, 3)), k)
        for k, name in enumerate(BACKBONES)}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


TO_FLAX = {"MobileNet": "keras_mobilenet_to_flax",
           "Xception": "keras_xception_to_flax",
           "InceptionResNetV2": "keras_irv2_to_flax",
           "NASNetMobile": "keras_nasnet_to_flax"}


@pytest.mark.parametrize("backbone", BACKBONES)
def test_keras_mapping_matches_jax(keras_models, backbone):
    """The port's numpy mapping against JAX's on the same Keras model:
    the same (params, batch_stats) paths, every leaf bitwise."""
    km = keras_models[backbone]
    got = getattr(ki, TO_FLAX[backbone])(km)
    want = getattr(jki, TO_FLAX[backbone])(km)
    for g, w in zip(got, want):
        g, w = dict(_leaves(g)), dict(_leaves(w))
        assert sorted(g) == sorted(w)
        for path, leaf in w.items():
            assert g[path].dtype == leaf.dtype, path
            np.testing.assert_array_equal(g[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_converted_weights_load_into_the_port_backbone(keras_models,
                                                       backbone):
    """`apply_backbone_weights` puts the tree through the converter into
    SPNet's backbone (input 2 x 96, so the backbone sees Keras's 96):
    every backbone tensor is the converted one and the rest of the model
    is untouched; a tree of another backbone is refused."""
    model = build_model(ModelConfig(backbone=backbone,
                                    input_size=2 * KERAS_HW,
                                    compute_dtype="float32"), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    p, s = ki.load_keras_backbone(keras_models[backbone], backbone)
    ki.apply_backbone_weights(model, p, s)
    want = flax_to_state_dict(p, s, model.backbone)
    for k, v in model.state_dict().items():
        if k.startswith("backbone."):
            assert torch.equal(v, want[k[len("backbone."):]]), k
        else:
            assert torch.equal(v, before[k]), k
    other = "Xception" if backbone != "Xception" else "MobileNet"
    with pytest.raises(ValueError, match="conversion failed"):
        ki.apply_backbone_weights(model, *ki.load_keras_backbone(
            keras_models[other], other))


def test_mobilenet_reproduces_keras(keras_models):
    """The port's MobileNet backbone, eval mode, float32, with the
    imported weights: Keras's output on the same frames within 1e-3 of
    its mean magnitude (the JAX test's criterion: float32 sums in other
    orders through 28 layers)."""
    km = keras_models["MobileNet"]
    model = build_model(ModelConfig(backbone="MobileNet",
                                    input_size=2 * KERAS_HW,
                                    compute_dtype="float32"), device="cpu")
    ki.apply_backbone_weights(model, *ki.keras_mobilenet_to_flax(km))
    x = np.random.default_rng(0).normal(
        0, 1, (2, KERAS_HW, KERAS_HW, 3)).astype(np.float32)
    yk = np.asarray(km(x, training=False))
    with torch.no_grad():
        yt = model.backbone.eval()(torch.from_numpy(x)).numpy()
    assert yt.shape == yk.shape
    assert np.abs(yk - yt).max() / np.abs(yk).mean() < 1e-3


SIZE = 64


def _dataset(n, seed):
    rng = np.random.default_rng(seed)
    return Dataset(x=rng.integers(0, 256, (n, SIZE, SIZE, 1), np.uint8),
                   y=rng.random((n, 576), dtype=np.float32),
                   grid=ExperimentConfig().grid,
                   file_list=[f"synthetic://{seed}/{i}" for i in range(n)])


def test_train_network_starts_from_the_file(keras_models, monkeypatch,
                                            tmp_path):
    """`pretrained` names a `.weights.h5` (loaded into Keras's MobileNet
    after `load_model` refuses it, JAX's order): the backbone the first
    train step sees is the file's, bitwise.  With a checkpoint in
    `ckpt_dir` the restore comes after the import and wins."""
    km = keras_models["MobileNet"]
    path = str(tmp_path / "mn.weights.h5")
    km.save_weights(path)
    cfg = ExperimentConfig(
        model=ModelConfig(backbone="MobileNet", input_size=SIZE,
                          compute_dtype="float32", pretrained=path),
        train=TrainConfig(batch_size=4, epochs=1, augment=False))
    seen = []
    real = loop.make_train_step

    def first_step_sees(model, *a, **k):
        step = real(model, *a, **k)

        def wrapped(state, *args):
            if len(seen) < 1:
                seen.append({n: t.clone() for n, t in
                             state.model.backbone.state_dict().items()})
            return step(state, *args)
        return wrapped

    monkeypatch.setattr(loop, "make_train_step", first_step_sees)
    train, val = _dataset(4, 1), _dataset(4, 2)
    loop.train_network(cfg, train, val, "cpu", log_dir=str(tmp_path / "a"),
                       render_overlays=False, verbose=0)
    ref = build_model(cfg.model, device="cpu")
    want = flax_to_state_dict(*ki.keras_mobilenet_to_flax(km), ref.backbone)
    assert set(seen[0]) == set(want)
    for k, v in want.items():
        assert torch.equal(seen[0][k], v), k

    other = build_model(dataclasses.replace(cfg.model, pretrained=""),
                        device="cpu",
                        generator=torch.Generator().manual_seed(9))
    save_checkpoint(str(tmp_path / "ck"), other.state_dict(), cfg)
    seen.clear()
    loop.train_network(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=2)), train, val, "cpu",
        log_dir=str(tmp_path / "b"), ckpt_dir=str(tmp_path / "ck"),
        render_overlays=False, verbose=0)
    for k, v in other.backbone.state_dict().items():
        assert torch.equal(seen[0][k], v), k


def test_load_keras_backbone_refuses(monkeypatch, tmp_path):
    """DarkNet19 has no Keras counterpart (ValueError, as in JAX); a
    missing file is named; without keras the error names keras."""
    with pytest.raises(ValueError, match="DarkNet19"):
        ki.load_keras_backbone(str(tmp_path / "x.h5"), "DarkNet19")
    with pytest.raises(FileNotFoundError, match="nowhere.h5"):
        ki.load_keras_backbone(str(tmp_path / "nowhere.h5"), "Xception")
    path = tmp_path / "some.weights.h5"
    path.write_bytes(b"")
    monkeypatch.setitem(sys.modules, "keras", None)
    with pytest.raises(ImportError, match="keras"):
        ki.load_keras_backbone(str(path), "Xception")


def test_cli_train_pretrained_remat(keras_models, tmp_path):
    """`python -m spnet_tpu_torch train --pretrained <.weights.h5> --remat`
    on 8 seeded PNG + CSV frames, MobileNet at 64², one epoch, on the
    CPU: it loads the file and trains."""
    from spnet_tpu_torch.config import GridSpec

    grid = GridSpec()
    rng = np.random.default_rng(3)
    for split, n in (("Train", 8), ("Val", 4)):
        d = tmp_path / "data" / split
        os.makedirs(d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE),
                                         dtype=np.uint8)).save(
                d / f"f{i}.png")
            write_meta_file(str(d / f"f{i}.csv"), np.array(
                [[rng.uniform(grid.cx_min, grid.cx_max),
                  rng.uniform(grid.cy_min, grid.cy_max), 40.0, 30.0, 10.0,
                  3.0]]))
    keras_models["MobileNet"].save_weights(str(tmp_path / "mn.weights.h5"))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "spnet_tpu_torch", "train", "-d", "data",
         "-b", "4", "-e", "1", "-w", "ck", "--backbone", "MobileNet",
         "--input_size", str(SIZE), "--dtype", "float32", "--device", "cpu",
         "--remat", "--pretrained", "mn.weights.h5", "--no-eval"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "pretrained backbone loaded from mn.weights.h5" in proc.stdout
    cfg = ExperimentConfig.from_json(
        open(tmp_path / "ck" / "experiment.json").read())
    assert cfg.model.remat and cfg.model.pretrained == "mn.weights.h5"
