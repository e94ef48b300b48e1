"""The port's flip test-time augmentation (`spnet_tpu_torch/eval/tta.py`)
against the JAX package's (`spnet_tpu/eval/tta.py`): every numpy function
of the copy bitwise on seeded grids, the flips of a tensor, and
`predict_tta` and `evaluate_network(..., tta="h,v,hv")` on MobileNetTiny
at 96² with converted weights."""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from spnet_tpu.config import ExperimentConfig as JExperimentConfig
from spnet_tpu.config import ModelConfig as JModelConfig
from spnet_tpu.data.dataset import Dataset as JDataset
from spnet_tpu.eval import tta as jtta
from spnet_tpu.eval.evaluate import evaluate_network as j_evaluate_network
from spnet_tpu.models.spnet import build_model as jbuild
from spnet_tpu.train.steps import make_predict_step as j_make_predict_step
from spnet_tpu_torch.config import ExperimentConfig, GridSpec, ModelConfig
from spnet_tpu_torch.convert import flax_to_state_dict
from spnet_tpu_torch.data.dataset import Dataset
from spnet_tpu_torch.eval import tta
from spnet_tpu_torch.eval.evaluate import evaluate_network
from spnet_tpu_torch.grid import batch_ellipses_to_grid, \
    canonicalize_records, normalize
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train.steps import make_predict_step
from test_torch_backbones import fill

torch.set_num_threads(2)
GRID = GridSpec()
JGRID = JExperimentConfig().grid
SIZE = 96


def _records(rng, n):
    a = rng.uniform(12, 90, n)
    return canonicalize_records(np.stack(
        [rng.uniform(GRID.cx_min, GRID.cx_max, n),
         rng.uniform(GRID.cy_min, GRID.cy_max, n), a,
         a * rng.uniform(0.4, 1.0, n), rng.uniform(0, 180, n),
         rng.uniform(1, 11, n)], axis=1))


def _noisy_grids(rng, b):
    """Denormalized (b, num_outputs) grids: encoded scenes with noise on
    every value and noobj spread over (0, 1), so that views hold
    detections, near misses and spurious records."""
    recs = [_records(rng, int(rng.integers(2, 9))) for _ in range(b)]
    g = batch_ellipses_to_grid(recs, GRID, on_overflow="drop").reshape(
        (b,) + GRID.pred_shape)
    g = g + rng.normal(0, 4.0, g.shape).astype(np.float32)
    g[..., 6] = rng.uniform(0, 1, g.shape[:-1])
    return g.reshape(b, -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_functions_match_jax_bitwise(seed):
    """`flip_images` (numpy), `flipback_grid` per mode, `_decode_view`,
    `merge_views` and `reencode_view` give JAX's arrays bit for bit."""
    rng = np.random.default_rng(seed)
    assert tta.TTA_MODES == jtta.TTA_MODES
    x = rng.integers(0, 256, (2, 5, 7, 1), dtype=np.uint8)
    direct = _noisy_grids(rng, 3)
    views, jviews = [], []
    for mode in tta.TTA_MODES:
        np.testing.assert_array_equal(tta.flip_images(x, mode),
                                      jtta.flip_images(x, mode))
        v = _noisy_grids(rng, 3)
        views.append(tta.flipback_grid(v, mode, GRID))
        jviews.append(jtta.flipback_grid(v, mode, JGRID))
        np.testing.assert_array_equal(views[-1], jviews[-1])
        np.testing.assert_array_equal(tta.reencode_view(views[-1], GRID),
                                      jtta.reencode_view(jviews[-1], JGRID))
        np.testing.assert_array_equal(tta._decode_view(views[-1][0]),
                                      jtta._decode_view(jviews[-1][0]))
    merged = tta.merge_views(direct, views, GRID)
    np.testing.assert_array_equal(merged,
                                  jtta.merge_views(direct, jviews, JGRID))
    assert not np.array_equal(merged, direct)  # the merge did something
    with pytest.raises(ValueError, match="unknown TTA mode"):
        tta.flip_images(x, "d")


def test_flip_images_of_a_tensor_stay_on_its_device():
    x = torch.arange(2 * 3 * 4, dtype=torch.uint8).reshape(2, 3, 4, 1)
    for mode in tta.TTA_MODES:
        got = tta.flip_images(x, mode)
        assert isinstance(got, torch.Tensor) and got.device == x.device
        np.testing.assert_array_equal(got.numpy(),
                                      jtta.flip_images(x.numpy(), mode))


@pytest.fixture(scope="module")
def tiny():
    """MobileNetTiny at 96² in both packages (filled variables, converted)
    and 12 seeded uint8 frames with labels."""
    cfg = ModelConfig(backbone="MobileNetTiny", input_size=SIZE,
                      compute_dtype="float32")
    jm = jbuild(JModelConfig(**dataclasses.asdict(cfg)))
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)},
        np.zeros((1, SIZE, SIZE, 1), np.float32), train=False))
    params, stats = fill(shapes["params"], rng), fill(shapes["batch_stats"],
                                                      rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params, stats, model))
    x = rng.integers(0, 256, (12, SIZE, SIZE, 1), dtype=np.uint8)
    y = normalize(batch_ellipses_to_grid(
        [_records(rng, int(rng.integers(1, 6))) for _ in range(12)], GRID,
        on_overflow="drop"), GRID).astype(np.float32)
    return cfg, jm, (params, stats), model, x, y


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


@pytest.mark.parametrize("decode", [None, _sigmoid])
def test_predict_tta_matches_jax(tiny, decode):
    """Direct + h, v, hv views at b=4 (12 frames, 3 batches), with and
    without the 'hybrid' sigmoid on the noobj lanes: the merged normalized
    predictions within 1e-4 of their scale, as the eval tests hold one
    view; fps over the time of all four sweeps."""
    _, jm, (params, stats), model, x, _ = tiny
    y_jax, _ = jtta.predict_tta(j_make_predict_step(jm), params, stats, x,
                                4, JGRID, decode_noobj=decode)
    y, fps = tta.predict_tta(make_predict_step(model), torch.from_numpy(x),
                             4, "cpu", GRID, decode_noobj=decode)
    assert y.shape == y_jax.shape == (12, 576) and fps > 0
    direct, _ = tta.predict_tta(make_predict_step(model), x, 4, "cpu",
                                GRID, modes=(), decode_noobj=decode)
    assert not np.array_equal(y, direct)  # the views changed the merge
    np.testing.assert_allclose(y, y_jax, rtol=0,
                               atol=1e-4 * np.abs(y_jax).max())


@pytest.mark.parametrize("loss_type", ["same", "hybrid"])
def test_evaluate_network_tta_matches_jax(tiny, loss_type, tmp_path):
    """`evaluate_network(..., tta="h,v,hv")` against JAX's: mAP within
    1e-6 and every confusion count equal; under 'hybrid' both decode the
    noobj logits with a sigmoid before merging."""
    cfg, jm, (params, stats), model, x, y = tiny
    cfg = ExperimentConfig(model=dataclasses.replace(cfg,
                                                     loss_type=loss_type))
    files = [f"synthetic://{i}" for i in range(len(x))]
    state = collections.namedtuple("State", "params batch_stats")(params,
                                                                  stats)
    jres = j_evaluate_network(
        JExperimentConfig.from_json(cfg.to_json()), state, jm,
        JDataset(x=x, y=y, file_list=files, grid=JGRID),
        log_dir=str(tmp_path / "jax"), num_draw=0, tta="h,v,hv", verbose=0)
    res = evaluate_network(cfg, model, Dataset(x=x, y=y, file_list=files,
                                               grid=GRID), "cpu",
                           log_dir=str(tmp_path / "pt"), num_draw=0,
                           tta="h,v,hv", verbose=0)
    assert res["mAP"] == pytest.approx(jres["mAP"], abs=1e-6)
    for k in ("ring_truecounts", "ring_miscounts", "total_obj",
              "false_obj_pos", "false_obj_neg", "true_obj_pos",
              "true_obj_neg"):
        assert res[k] == jres[k], k
    assert res["mean_pix_err"] == pytest.approx(jres["mean_pix_err"],
                                                abs=1e-3)
    assert res["fps"] > 0 and (tmp_path / "pt" / "hawley_spnet.csv").exists()
