"""The inputs and traffic are drawn from the seed: the same seed gives the
same frames, labels, weights, orders and clips; another seed other ones,
with the same set of clip lengths."""

import itertools

import numpy as np
import torch

from perfbench import core, inputs
from perfbench.kinds import predict_clips

SEED = 2 ** 33 + 5  # more than 32 bits


def test_tensors_repeat_with_the_seed():
    for make in (lambda s: inputs.frames(3, 8, s, "f", "cpu"),
                 lambda s: inputs.labels(3, 16, s, "l", "cpu"),
                 lambda s: inputs.make_weights({"a.weight": (4, 3, 3, 3),
                                                "a.bias": (4,)}, s,
                                               "cpu")["a.weight"]):
        assert torch.equal(make(SEED), make(SEED))
        assert not torch.equal(make(SEED), make(SEED + 1))


def test_labels_are_slots():
    y = inputs.labels(64, 576, SEED, "l", "cpu").view(64, -1, 8)
    assert set(torch.unique(y[..., 6]).tolist()) == {0.0, 1.0}
    assert float(y.abs().max()) <= 1.0


def test_order_passes_without_replacement():
    rows = inputs.epoch_rows(40, 4, SEED, 2)
    assert rows.shape == (20, 4)
    assert np.array_equal(rows, inputs.epoch_rows(40, 4, SEED, 2))
    for p in (rows[:10], rows[10:]):
        assert sorted(p.reshape(-1)) == list(range(40))
    assert not np.array_equal(rows[:10], rows[10:])


def test_directory_plan_is_the_pool():
    t = core.load_cell("xception331-predict-b16")["traffic"]
    plan = list(itertools.islice(predict_clips.clip_plan(
        t, SEED, t["pool_frames"]), 3))
    assert plan == [(0, t["pool_frames"])] * 3
    assert t["pool_frames"] % t["batch"] == 0


def test_clip_plan_same_sizes_other_order():
    t = {"pool_frames": 4096, "clip_min": 48, "clip_max": 144}
    n_len = t["clip_max"] - t["clip_min"] + 1

    def first(seed):
        return list(itertools.islice(
            predict_clips.clip_plan(t, seed, t["pool_frames"]), 2 * n_len))

    a, b = first(SEED), first(SEED + 1)
    assert a == first(SEED)
    assert a != b
    for plan in (a, b):
        for blk in (plan[:n_len], plan[n_len:]):
            assert sorted(l for _, l in blk) == list(
                range(t["clip_min"], t["clip_max"] + 1))
        assert all(at + l <= t["pool_frames"] for at, l in plan)
