"""The port's own copy of the numpy layer (config, grid, data, io.logs,
io.render, the native PNG decoder) against the JAX package's modules it
was copied from, on seeded numpy inputs: the same dataclasses and
defaults, `experiment.json` across the two packages both ways, bitwise
equal label encoding and epoch order, equal datasets from PNG + CSV pairs
on the native and the PIL path, and byte-equal `losses.dat` and
prediction CSV."""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

import spnet_tpu.config as jconfig
import spnet_tpu.data.dataset as jdataset
import spnet_tpu.data.loader as jloader
import spnet_tpu.grid as jgrid
import spnet_tpu.io.logs as jlogs
import spnet_tpu.io.render as jrender
import spnet_tpu_torch.config as tconfig
import spnet_tpu_torch.data.dataset as tdataset
import spnet_tpu_torch.data.loader as tloader
import spnet_tpu_torch.grid as tgrid
import spnet_tpu_torch.io.logs as tlogs
import spnet_tpu_torch.io.render as trender
from spnet_tpu.data.csvio import write_meta_file

CLASSES = ["GridSpec", "LossWeights", "ModelConfig", "TrainConfig",
           "ExperimentConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_match(name):
    """Each config class: the same fields in the same order, with the same
    types and defaults; the module's layout constants are equal."""
    jc, tc = getattr(jconfig, name), getattr(tconfig, name)
    assert jc is not tc
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [(f.name, str(f.type)) for f in tf] == \
        [(f.name, str(f.type)) for f in jf]
    assert dataclasses.asdict(tc()) == dataclasses.asdict(jc())
    consts = [k for k in vars(jconfig) if k.isupper()]
    assert consts and all(getattr(tconfig, k) == getattr(jconfig, k)
                          for k in consts)


def _experiment(config):
    """An ExperimentConfig of `config`'s package with no default left in
    the parts a run sets."""
    return config.ExperimentConfig(
        grid=config.GridSpec(nx=4, ny=3, preds_per_cell=3),
        model=config.ModelConfig(backbone="MobileNetTiny", input_size=96,
                                 compute_dtype="float32",
                                 selective_sigmoid=True, dropout_rate=0.25),
        train=config.TrainConfig(batch_size=8, epochs=3, lr_max=1e-3,
                                 seed=7, save_every=1),
        loss_weights=config.LossWeights(center=3.0))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_experiment_json_crosses_packages(direction, tmp_path):
    """`experiment.json` written by one package and read by the other gives
    the reader's twin of the writer's config, and writes the same text."""
    src, dst = ((jconfig, tconfig) if direction == "jax_to_port"
                else (tconfig, jconfig))
    path = tmp_path / "experiment.json"
    path.write_text(_experiment(src).to_json())
    got = dst.ExperimentConfig.from_json(path.read_text())
    assert type(got) is dst.ExperimentConfig
    assert got == _experiment(dst)
    assert got.to_json() == path.read_text()
    assert got.grid.num_outputs == 4 * 3 * 3 * 8


def _raw_rows(rng, grid, k):
    a = rng.uniform(12, 90, k)
    return np.stack([rng.uniform(grid.cx_min, grid.cx_max, k),
                     rng.uniform(grid.cy_min, grid.cy_max, k), a,
                     a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
                     rng.uniform(1, 11, k)], axis=1)


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_codec_bitwise_equal(seed):
    rng = np.random.default_rng(seed)
    tg, jg = tconfig.GridSpec(), jconfig.GridSpec()
    raws = [_raw_rows(rng, tg, int(rng.integers(0, 7))) for _ in range(6)]
    trecs = [tgrid.canonicalize_records(r) for r in raws]
    jrecs = [jgrid.canonicalize_records(r) for r in raws]
    for a, b in zip(trecs, jrecs):
        np.testing.assert_array_equal(a, b)
    flat_t = tgrid.batch_ellipses_to_grid(trecs, tg, on_overflow="drop")
    flat_j = jgrid.batch_ellipses_to_grid(jrecs, jg, on_overflow="drop")
    np.testing.assert_array_equal(flat_t, flat_j)
    norm = tgrid.normalize(flat_t, tg)
    np.testing.assert_array_equal(norm, jgrid.normalize(flat_j, jg))
    noisy = norm + rng.normal(0, 0.1, norm.shape).astype(norm.dtype)
    np.testing.assert_array_equal(tgrid.denormalize(noisy, tg),
                                  jgrid.denormalize(noisy, jg))


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_order_equal(shuffle):
    for seed in (0, 3):
        got = list(tdataset.batches(37, 5, shuffle=shuffle, seed=seed))
        want = list(jdataset.batches(37, 5, shuffle=shuffle, seed=seed))
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pairs_dir(tmp_path_factory):
    """Seven 80x60 grey PNG frames with their CSV labels."""
    d = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(11)
    grid = tconfig.GridSpec()
    for i in range(7):
        Image.fromarray(rng.integers(0, 256, (60, 80), dtype=np.uint8)
                        ).save(d / f"frame_{i:02d}.png")
        write_meta_file(str(d / f"frame_{i:02d}.csv"),
                        _raw_rows(rng, grid, int(rng.integers(1, 5))))
    return str(d)


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("path", ["native", "pil"])
def test_build_dataset_equal(pairs_dir, path, uint8, monkeypatch):
    """Both packages' `build_dataset` on the same PNG + CSV pairs (seeded
    shuffle, batch 3 -> 6 of 7 kept, resized to 40): equal x, y, rows,
    row_mask and file order.  'native' runs each package's C++ decoder
    (built on first use); 'pil' takes each package's PIL fallback."""
    if path == "native":
        from spnet_tpu.native import io as jnative
        from spnet_tpu_torch.native import io as tnative

        assert jnative.available() and tnative.available()
    else:
        monkeypatch.setattr(jloader, "native_build_x", lambda *a, **k: None)
        monkeypatch.setattr(tloader, "native_build_x", lambda *a, **k: None)
    kw = dict(batch_size=3, input_size=40, seed=5, uint8=uint8)
    t = tdataset.build_dataset(pairs_dir, tconfig.GridSpec(), **kw)
    j = jdataset.build_dataset(pairs_dir, jconfig.GridSpec(), **kw)
    assert isinstance(t, tdataset.Dataset) and len(t.file_list) == 6
    assert t.file_list == j.file_list
    assert t.x.dtype == j.x.dtype == (np.uint8 if uint8 else np.float32)
    for k in ("x", "y", "rows", "row_mask"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)


def test_native_and_pil_paths_differ_only_by_rounding(pairs_dir):
    """The port's native decoder resizes like PIL to rounding (as the JAX
    package's does, tests/test_native_io.py), so which path a host takes
    matters, and the copy keeps it."""
    files = sorted(os.path.join(pairs_dir, f) for f in os.listdir(pairs_dir)
                   if f.endswith(".png"))
    native = tloader.native_build_x(files, 40)
    pil = np.stack([tdataset.load_image(f, 40) for f in files])
    assert native is not None and native.shape == pil.shape == (7, 40, 40, 1)
    np.testing.assert_allclose(native, pil, rtol=0, atol=0.02)


def test_loss_log_and_prediction_csv_byte_equal(pairs_dir, tmp_path):
    """`losses.dat` (and its JSONL twin) and the overlay renderer's
    prediction CSV and PNGs, written by each package from the same
    numbers, are the same bytes."""
    rng = np.random.default_rng(2)
    for pkg, mod in (("jax", jlogs), ("port", tlogs)):
        log = mod.LossLog(str(tmp_path / pkg))
        for epoch in range(3):
            comps = {k: float(rng.uniform()) for k in
                     ("total", "center", "size", "angle", "noobj", "rings")}
            log.append(epoch, float(rng.uniform()), comps, 0.5 + epoch,
                       extra={"lr": 1e-4})
        rng = np.random.default_rng(2)  # the same numbers for the other
    for name in ("losses.dat", "metrics.jsonl"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()

    files = sorted(os.path.join(pairs_dir, f) for f in os.listdir(pairs_dir)
                   if f.endswith(".png"))[:4]
    grid = tconfig.GridSpec()
    recs = [tgrid.canonicalize_records(_raw_rows(rng, grid, 3))
            for _ in files]
    y_true = tgrid.batch_ellipses_to_grid(recs, grid, on_overflow="drop")
    y_pred = y_true + rng.normal(0, 2, y_true.shape).astype(np.float32)
    y_pred[1] = 0.0  # a frame with no object predicted: the zeros row
    for pkg, mod in (("jax", jrender), ("port", trender)):
        mod.show_pred_ellipses(y_true, y_pred, files, num_draw=4,
                               log_dir=str(tmp_path / f"r_{pkg}"),
                               out_csv=str(tmp_path / f"{pkg}.csv"))
    csv = (tmp_path / "port.csv").read_bytes()
    assert csv == (tmp_path / "jax.csv").read_bytes()
    assert csv.count(b"\n") >= 4
    for i in range(4):
        name = f"steelpan_pred_{i:05d}.png"
        assert (tmp_path / "r_port" / name).read_bytes() == \
            (tmp_path / "r_jax" / name).read_bytes()
