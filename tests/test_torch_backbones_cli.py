"""`python -m spnet_tpu_torch train | predict | evaluate --tta` end to end on
the CPU with each of the other backbones, at its smallest input."""

import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from spnet_tpu_torch.config import GridSpec
from spnet_tpu_torch.data.csvio import write_meta_file
from spnet_tpu_torch.io.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"DarkNet19": 128, "InceptionResNetV2": 160, "NASNetMobile": 96}


def _write_frames(d, n, seed, size, grid=GridSpec()):
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size), dtype=np.uint8)
                        ).save(os.path.join(d, f"frame_{i:02d}.png"))
        k = int(rng.integers(1, 5))
        a = rng.uniform(12, 90, k)
        write_meta_file(os.path.join(d, f"frame_{i:02d}.csv"), np.stack(
            [rng.uniform(grid.cx_min, grid.cx_max, k),
             rng.uniform(grid.cy_min, grid.cy_max, k), a,
             a * rng.uniform(0.4, 1.0, k), rng.uniform(0, 180, k),
             rng.uniform(1, 11, k)], axis=1))


def _run(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "spnet_tpu_torch", *args,
                           "--device", "cpu"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("backbone", list(SIZES))
def test_cli_train_predict_evaluate_tta(backbone, tmp_path):
    """`train --backbone <b> --input_size <s> --dtype float32` trains one
    epoch of 2 steps, evaluates Val/ and predicts over --predict_dir into
    <log_dir>/predict/; `predict` serves the checkpoint, whose config names
    the backbone; `evaluate --tta h,v,hv` scores Val/ with the flip
    ensemble."""
    size = SIZES[backbone]
    _write_frames(str(tmp_path / "data" / "Train"), 16, 5, size)
    _write_frames(str(tmp_path / "data" / "Val"), 8, 6, size)
    out = _run(tmp_path, "train", "-d", "data", "-b", "8", "-e", "1", "-w",
               "ck", "--name", "m", "--backbone", backbone, "--input_size",
               str(size), "--dtype", "float32", "--predict_dir", "data/Val")
    assert "mAP" in out
    payload, cfg = load_checkpoint(str(tmp_path / "ck"))
    assert payload["step"] == 2 and cfg.model.backbone == backbone
    (log_dir,) = glob.glob(str(tmp_path / "logs" / "m_*"))
    lines = open(os.path.join(log_dir, "predict", "hawley_spnet.csv")
                 ).read().splitlines()
    assert len(lines) > 1
    _run(tmp_path, "predict", "-w", "ck", "-d", "data/Val", "-b", "2", "-l",
         "pred")
    assert (tmp_path / "pred" / "hawley_spnet.csv").exists()
    out = _run(tmp_path, "evaluate", "-w", "ck", "-d", "data/Val", "-b", "2",
               "-l", "eval", "--tta", "h,v,hv")
    assert "TTA ensemble over views: direct + ('h', 'v', 'hv')" in out
    assert "mAP" in out and (tmp_path / "eval" / "hawley_spnet.csv").exists()
    for d in ("ck", "logs", "eval"):  # up to 0.6 GB each (IRv2)
        shutil.rmtree(tmp_path / d)
