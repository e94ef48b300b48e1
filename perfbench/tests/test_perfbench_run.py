"""Whole runs: without a card the command fails and prints no result; a
directory holding only the benchmark fails too; a cell added from files
alone is found; and with the measured path broken underneath, `correct`
comes out false, once for each fault a cell can have."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import CELLS, ROOT, small
from perfbench import core

CMD = [sys.executable, "perfbench/run.py", "--seed", str(2 ** 31 + 3),
       "--seconds", "1", "--trace", "0", "--workload"]
FAKE_CARD = """
import runpy, sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.argv = ['perfbench/run.py'] + sys.argv[1:]
runpy.run_path('perfbench/run.py', run_name='__main__')
"""


def _no_result(out: str) -> bool:
    for line in out.strip().splitlines()[-1:]:
        try:
            return "metrics" not in json.loads(line)
        except ValueError:
            return True
    return True


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(CMD + [CELLS[0]], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert _no_result(out.stdout)
    assert "no result" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    """BENCHMARK.json and perfbench/ without the program: the run fails
    (here past a card check that is told a card is there)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "fixtures"))
    out = subprocess.run([sys.executable, "-c", FAKE_CARD] + CMD[2:]
                         + [CELLS[1]], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert _no_result(out.stdout)
    assert "spnet_tpu_torch" in out.stderr


ADD_CELL = """
import json, sys, torch
sys.path.insert(0, {root!r})
from perfbench import core
res, checks, _ = core.run_cell('dummy-predict', 2 ** 31 + 9, 0.3, True,
                               torch.device('cpu'), 0.0)
print(json.dumps(res))
"""


def test_a_cell_from_files_alone(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric, each
    a new file, and new entries in BENCHMARK.json: the harness runs the
    cell and reports the metric, with no file of it edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "fixtures"))
    (tmp_path / "spnet_tpu_torch").symlink_to(ROOT / "spnet_tpu_torch")
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "mobilenet331.json").read_text())
    cfg["name"] = "mobilenet96"
    cfg["model"]["input_size"] = 96
    (pb / "configs" / "mobilenet96.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "predict_dir_b16.json").read_text())
    mix.update(small("xception331-predict-b16")["traffic"])
    (pb / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (pb / "limits" / "dummy-predict.json").write_text('{"pred_gap": 1.0}')
    (pb / "metrics" / "clips_in_tail.py").write_text(
        "def read(record):\n"
        "    return float(len(record['tails']['layers'].extra"
        "['clip_lengths']))\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mobilenet96", "source": "x",
                            "file": "perfbench/configs/mobilenet96.json",
                            "reduced": ["input_size"], "why": "test"})
    spec["workloads"].append({"name": "dummy-predict", "config":
                              "mobilenet96", "traffic": "dummy_mix",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "clips_in_tail", "unit": "clips",
                              "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "predict_fps",
                              "workloads": ["dummy-predict"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "-c", ADD_CELL.format(
        root=str(tmp_path))], capture_output=True, text=True,
        cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["clips_in_tail"]["value"] >= 1


def _run(cell):
    res, _, _ = core.run_cell(cell, 2 ** 31 + 41, 0.5, False,
                              torch.device("cpu"), 0.0,
                              small(cell, compute_dtype="float32"))
    return res


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged: no update is applied."""
    from spnet_tpu_torch.train import state as program_state

    monkeypatch.setattr(program_state.Optimizer, "update",
                        lambda self, params, grads, st, lr=None: st)


def _half_batch(monkeypatch):
    """Half of each minibatch left out, the loss the mean over the rest."""
    from spnet_tpu_torch.train import steps as program_steps

    make = program_steps.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)

        def half(state, x_all, y_all, idx, generator):
            return step(state, x_all, y_all, idx[: idx.shape[0] // 2],
                        generator)
        return half

    monkeypatch.setattr(program_steps, "make_train_step", broken)


def _altered_answer(monkeypatch):
    """Each batch's first answer altered where the predict step makes it."""
    from spnet_tpu_torch.train import steps as program_steps

    make = program_steps.make_predict_step

    def broken(model):
        predict = make(model)

        def altered(x):
            y = predict(x).clone()
            y[0] = -y[0]
            return y
        return altered

    monkeypatch.setattr(program_steps, "make_predict_step", broken)


def _window_unchanged(monkeypatch):
    """The window's calls of the epoch form, past the first steps that the
    reference follows, return the state unchanged."""
    from spnet_tpu_torch.train import steps as program_steps

    make = program_steps.make_train_epoch

    def broken(*a, **k):
        epoch = make(*a, **k)
        calls = []

        def stuck(state, x_all, y_all, idx, generator):
            calls.append(idx.shape[0])
            if len(calls) <= 2:  # the check's first steps
                return epoch(state, x_all, y_all, idx, generator)
            return state, torch.ones(idx.shape[0])
        return stuck

    monkeypatch.setattr(program_steps, "make_train_epoch", broken)


TRAIN = [c for c in CELLS if "train" in c]
FAULTS = [(c, f) for c in TRAIN
          for f in (_unchanged_state, _half_batch, _window_unchanged)]
FAULTS += [(c, _altered_answer) for c in CELLS if c not in TRAIN]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    """(The same run without the fault is correct:
    test_perfbench_reference.py::test_cell_follows_reference_f32.)"""
    fault(monkeypatch)
    assert not _run(cell)["correct"]


#: the cells whose check the fp8 control fails: all
CONTROLLED = list(CELLS)


@pytest.mark.parametrize("cell", CONTROLLED)
def test_control_is_not_correct(cell):
    """The reference in fp8 in the program's place (the control) fails
    one of the cell's limits, here at the small size in the
    configuration's bf16."""
    limits = core.load_cell(cell)["limits"]
    res, _, _ = core.run_cell(cell, 2 ** 31 + 43, 0.5, False,
                              torch.device("cpu"), 0.0, small(cell),
                              calibrate=True)
    control = res["readings"]["control_fp8"]
    assert any(control[k] > lim for k, lim in limits.items()), control


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CONTROLLED)
def test_control_on_the_card(cell, card):
    """At the cell's own size on the card: the program is correct and the
    control fails one limit."""
    limits = core.load_cell(cell)["limits"]
    res, _, _ = core.run_cell(cell, 2 ** 31 + 47, 2.0, False, card, 0.0,
                              calibrate=True)
    assert res["correct"], res["checks"]
    control = res["readings"]["control_fp8"]
    assert any(control[k] > lim for k, lim in limits.items()), control
