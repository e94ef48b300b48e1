"""The port's TensorBoard writer (`io/tb.py`, a copy of the JAX package's)
and its use in the epoch loop: with the wall time and the host name fixed,
the event file is byte for byte the JAX writer's; its records pass the
CRC and read back; and `train_network(use_tb=True)` writes JAX's seven
scalar tags and the `val/overlay` image for every epoch."""

import os
import socket
import struct
import time

import numpy as np
import pytest

from spnet_tpu.io import tb as jtb
from spnet_tpu_torch.config import ExperimentConfig, ModelConfig, \
    TrainConfig
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, normalize
from spnet_tpu_torch.io import tb

TAGS = {"loss/train", "loss/val", "metrics/ring_acc", "metrics/class_acc",
        "metrics/mean_pix_err", "perf/img_per_sec", "lr"}


def _write(module, logdir):
    w = module.TBWriter(str(logdir))
    w.add_scalar("loss/train", 0.125, 3)
    w.add_scalar("metrics/ring_acc", 96.5, 3)
    w.add_scalar("lr", 4e-5, 1 << 40)
    img = (np.arange(32 * 48 * 3, dtype=np.uint8).reshape(32, 48, 3) % 251)
    w.add_image("val/overlay", img, 3)
    w.add_image("val/gray", img[..., 0], 4)
    w.close()
    return w.path, img


def test_event_file_is_byte_equal_to_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "card-host")
    path, img = _write(tb, tmp_path / "port")
    jpath, _ = _write(jtb, tmp_path / "jax")
    assert os.path.basename(path) == os.path.basename(jpath) == \
        "events.out.tfevents.1700000000.card-host"
    data = open(path, "rb").read()
    assert data == open(jpath, "rb").read()

    # every record: length, its masked CRC, payload, the payload's CRC
    pos, n = 0, 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        assert struct.unpack_from("<I", data, pos + 8)[0] == \
            tb._masked_crc(data[pos:pos + 8])
        payload = data[pos + 12:pos + 12 + length]
        assert struct.unpack_from("<I", data, pos + 12 + length)[0] == \
            tb._masked_crc(payload)
        pos += 16 + length
        n += 1
    assert pos == len(data) and n == 6  # the version record + 5
    assert tb._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value

    events = list(tb.read_events(path))
    assert events == list(jtb.read_events(path))
    scalars = {(t, s): v for s, t, k, v in events if k == "scalar"}
    assert scalars[("loss/train", 3)] == pytest.approx(0.125)
    assert scalars[("lr", 1 << 40)] == pytest.approx(4e-5)
    import io

    from PIL import Image

    (png,) = [v for s, t, k, v in events if t == "val/overlay"]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  img)


def _dataset(n, seed, size, grid):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        a = rng.uniform(12, 90, k)
        recs.append(canonicalize_records(np.stack(
            [rng.uniform(grid.cx_min, grid.cx_max, k),
             rng.uniform(grid.cy_min, grid.cy_max, k), a, a * 0.6,
             rng.uniform(0, 180, k), rng.uniform(1, 11, k)], axis=1)))
    y = normalize(batch_ellipses_to_grid(recs, grid, on_overflow="drop"),
                  grid).astype(np.float32)
    return Dataset(x=rng.integers(0, 256, (n, size, size, 1), np.uint8), y=y,
                   grid=grid,
                   file_list=[f"synthetic://{seed}/{i}" for i in range(n)])


def test_train_network_writes_the_epoch_summaries(tmp_path):
    """Two epochs of MobileNetTiny at 32^2 with use_tb: one event file in
    `<log_dir>/tb`, the seven scalar tags and the overlay image (the
    progress plot when no overlay was drawn) at epochs 0 and 1, the train
    loss equal to the run's history."""
    from spnet_tpu_torch.train.loop import train_network

    cfg = ExperimentConfig(
        model=ModelConfig(backbone="MobileNetTiny", input_size=32,
                          compute_dtype="float32"),
        train=TrainConfig(batch_size=4, epochs=2, use_tb=True))
    train, val = _dataset(8, 0, 32, cfg.grid), _dataset(4, 1, 32, cfg.grid)
    log = tmp_path / "log"
    _, hist = train_network(cfg, train, val, "cpu", log_dir=str(log),
                            verbose=0)
    (name,) = os.listdir(log / "tb")
    events = list(tb.read_events(str(log / "tb" / name)))
    for epoch in (0, 1):
        tags = {t for s, t, k, v in events if s == epoch and k == "scalar"}
        assert tags == TAGS
        loss = [v for s, t, k, v in events if s == epoch and t == "loss/train"]
        assert loss == [pytest.approx(hist[epoch]["train_loss"])]
    if os.path.exists(log / "progress.png"):  # drawn where matplotlib is
        assert [s for s, t, k, v in events if t == "val/overlay"] == [0, 1]
