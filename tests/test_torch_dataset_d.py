"""The port's Dataset-D tools (`spnet_tpu_torch/tools/`: dataset_d,
dataset_d_prep, dataset_d_inflate, eval_blur_split) against the JAX
package's scripts of the same names, on the CPU at a small size.  Each JAX
script is imported by its path and driven with its own argv; the JAX
functions it calls to generate, inflate, load, train and evaluate are
replaced by stand-ins that record what they are given, and the port's by
the same stand-ins."""

import collections
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import spnet_tpu.cli.augment_preproc as j_augment
import spnet_tpu.cli.common as j_cli_common
import spnet_tpu.cli.gen_fake_espi as j_gen
import spnet_tpu.data.dataset as j_dataset
import spnet_tpu.eval.evaluate as j_evaluate
import spnet_tpu.train.loop as j_loop
from spnet_tpu.config import ExperimentConfig as JExperimentConfig
import spnet_tpu_torch.cli.augment_preproc as t_augment
import spnet_tpu_torch.cli.gen_fake_espi as t_gen
from spnet_tpu_torch.config import ExperimentConfig
from spnet_tpu_torch.tools import dataset_d, dataset_d_inflate, \
    dataset_d_prep, eval_blur_split

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the keys of the JAX script's result line and of each arm's entry
#: (`scripts/dataset_d_run.py:61-66, 159-194`)
ARM_KEYS = {"tag", "train_wall_s", "ring_acc", "class_acc", "mAP",
            "pix_err", "epochs", "imgs_seen"}
RESULT_KEYS = {"both": {"gen_wall_s", "offline", "onthefly"},
               "offline": {"gen_wall_s", "offline"},
               "onthefly": {"gen_wall_s", "offline", "onthefly"}}
#: wall seconds: measured, so not compared between the two runs
WALL_KEYS = ("gen_wall_s", "train_wall_s", "inflate_wall_s")
#: the offline set's frames in the stand-ins: JAX's recorded 55,024 of
#: 1,280 x 43 (16 variants shared a name), so epoch_repeats = 42
INFLATED_FRAMES = 55024
EVAL = {"ring_acc": 87.5, "class_acc": 83.25, "mAP": 0.91,
        "mean_pix_err": 3.5}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kw):
    """(fn's return, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _lines(text, tag):
    return [json.loads(l[len(tag) + 1:]) for l in text.splitlines()
            if l.startswith(tag + " ")]


def _without_walls(d):
    if isinstance(d, dict):
        return {k: _without_walls(v) for k, v in d.items()
                if k not in WALL_KEYS}
    return d


class _Recorder:
    """Stand-ins for the five stages, on the JAX side (`jax=True`: its
    train_network returns (state, model, history) and its evaluate_network
    takes the state and the model) or the port's; each call is recorded
    with the working directory's prefix of its paths cut."""

    def __init__(self, jax: bool, frames: dict):
        self.jax, self.frames, self.calls = jax, frames, []

    def gen(self, argv):
        d = argv[argv.index("-d") + 1]
        os.makedirs(f"{d}/Train", exist_ok=True)
        n = int(argv[argv.index("-n") + 1])
        seed = argv[argv.index("--seed") + 1]
        for i in range(n):
            for ext in (".png", ".csv"):
                open(f"{d}/Train/f{i:07d}_s{seed}{ext}", "w").close()
        self.calls.append(("gen", _strip_device(argv)))

    def augment(self, argv):
        self.calls.append(("augment", _strip_device(argv)))
        d = argv[argv.index("-d") + 1]
        self.calls.append(("augment_input", sorted(os.listdir(d))))

    def build(self, path, grid, **kw):
        self.calls.append(("build", os.path.basename(path.rstrip("/")), kw))
        n = self.frames[os.path.basename(path.rstrip("/"))]
        return collections.namedtuple("Set", "x")(np.zeros((n, 1)))

    def train(self, cfg, train_ds, val_ds, *a, **kw):
        kw = dict(kw)
        self.calls.append(("train", json.loads(cfg.to_json()),
                           train_ds.x.shape[0], val_ds.x.shape[0],
                           kw.pop("log_dir"), kw))
        hist = [{"img_per_sec": 100.0}]
        if self.jax:
            return "state", "model", hist
        return collections.namedtuple("State", "model")("model"), hist

    def evaluate(self, cfg, *a, **kw):
        kw = dict(kw)
        self.calls.append(("evaluate", kw.pop("log_dir"), kw))
        return dict(EVAL)

    def install(self, monkeypatch):
        if self.jax:
            for mod, name, fn in ((j_gen, "main", self.gen),
                                  (j_augment, "main", self.augment),
                                  (j_dataset, "build_dataset", self.build),
                                  (j_loop, "train_network", self.train),
                                  (j_evaluate, "evaluate_network",
                                   self.evaluate)):
                monkeypatch.setattr(mod, name, fn)
        else:
            monkeypatch.setattr(t_gen, "main", self.gen)
            monkeypatch.setattr(t_augment, "main", self.augment)
            monkeypatch.setattr(dataset_d, "build_dataset", self.build)
            monkeypatch.setattr(dataset_d, "train_network", self.train)
            monkeypatch.setattr(dataset_d, "evaluate_network",
                                self.evaluate)


def _strip_device(argv):
    argv = list(argv)
    if "--device" in argv:
        i = argv.index("--device")
        del argv[i:i + 2]
    return argv


def _frames(n_train=1280, n_val=640, inflated=INFLATED_FRAMES):
    return {"Train": n_train, "Val": n_val, "TrainAug": inflated}


def _jax_run(argv, monkeypatch, frames):
    rec = _Recorder(True, frames)
    rec.install(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["dataset_d_run.py", *argv])
    _, out = _run(_script("dataset_d_run").main)
    return rec, out


def _port_run(argv, monkeypatch, frames):
    rec = _Recorder(False, frames)
    rec.install(monkeypatch)
    res, out = _run(dataset_d.main, [*argv, "--device", "cpu"])
    return rec, out, res


def _port_calls(calls):
    """The port's calls with its directories renamed to the JAX script's,
    so the rest can be compared."""
    text = json.dumps(calls)
    text = text.replace("logs/dataset_d_data_torch_cpu",
                        "logs/dataset_d_data")
    for tag in ("offline42x", "geo_fly"):
        text = text.replace(f"logs/dataset_d_{tag}_torch_cpu",
                            f"logs/dataset_d_{tag}")
    return json.loads(text)


ARM_CASES = {
    "both": [],
    "offline": ["1280", "12", "--arm", "offline"],
    "onthefly_rep42": ["--arm", "onthefly", "--rep", "42"],
    "both_rep_pinned": ["640", "3", "--rep", "7"],
}


@pytest.mark.parametrize("case", sorted(ARM_CASES))
def test_arms_match_the_jax_script(case, monkeypatch, tmp_path):
    """The same argv gives each arm the JAX script's ExperimentConfig,
    field by field, the same generation, inflation, dataset loads (paths,
    shuffle, seed, batch, input size, on_overflow), train_network and
    evaluate_network keywords, and the same result lines (wall seconds
    aside) with the script's keys; only the directories differ."""
    argv = ARM_CASES[case]
    n_train = int(argv[0]) if argv and argv[0].isdigit() else 1280
    frames = _frames(n_train)
    monkeypatch.chdir(tmp_path / ".")
    os.makedirs("jax")
    os.makedirs("port")
    monkeypatch.chdir(tmp_path / "jax")
    j_rec, j_out = _jax_run(argv, monkeypatch, frames)
    monkeypatch.chdir(tmp_path / "port")
    t_rec, t_out, res = _port_run(argv, monkeypatch, frames)

    assert _port_calls(t_rec.calls) == json.loads(json.dumps(j_rec.calls))
    trains = [c for c in j_rec.calls if c[0] == "train"]
    arm = "onthefly" if "onthefly" in argv else (
        "offline" if "offline" in argv else "both")
    assert len(trains) == {"both": 2, "offline": 1, "onthefly": 1}[arm]
    for c in trains:  # the port's config class reads the JAX one's JSON
        assert json.loads(ExperimentConfig.from_json(json.dumps(c[1]))
                          .to_json()) == c[1]
        assert json.loads(JExperimentConfig.from_json(json.dumps(c[1]))
                          .to_json()) == c[1]
        assert c[1]["model"]["backbone"] == "Xception"
        assert c[1]["model"]["input_size"] == 331
        assert c[1]["train"]["batch_size"] == 16
        assert c[1]["train"]["lr_max"] == 4e-5
    fly = [c for c in trains if c[1]["train"]["geo_augment"]]
    if fly:
        want_rep = (int(argv[argv.index("--rep") + 1]) if "--rep" in argv
                    else INFLATED_FRAMES // n_train)
        assert fly[0][1]["train"]["epoch_repeats"] == want_rep
        if case == "onthefly_rep42":
            assert want_rep == 42

    for tag in ("OFFLINE", "ONTHEFLY", "DATASET_D_RESULT"):
        j_lines, t_lines = _lines(j_out, tag), _lines(t_out, tag)
        assert [_without_walls(l) for l in t_lines] == \
            [_without_walls(l) for l in j_lines], tag
    want = _lines(j_out, "DATASET_D_RESULT")[0]
    assert set(want) == RESULT_KEYS[arm]
    for key in ("offline", "onthefly"):
        if want.get(key):
            extra = {"offline": {"inflate_wall_s"},
                     "onthefly": {"epoch_repeats"}}[key]
            assert set(want[key]) == ARM_KEYS | extra
    assert _without_walls(res) == _without_walls(want)
    stages = _lines(t_out, "DATASET_D_STAGES")
    assert [s["arm"] for s in stages] == {
        "both": ["offline", "onthefly"], "offline": ["offline"],
        "onthefly": ["onthefly"]}[arm]


@pytest.mark.parametrize("argv,message", [
    (["--arm"], "--arm needs a value"),
    (["--arm", "bogus"], "unknown --arm 'bogus'"),
    (["--arm", "onthefly"], "--arm onthefly needs --rep N"),
    (["--rep"], "--rep needs an integer value"),
])
def test_argv_errors_match(argv, message, monkeypatch, tmp_path):
    """The JAX script's errors, word for word, for the same argv."""
    errors = []
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        with pytest.raises(SystemExit) as e:
            if side == "jax":
                _jax_run(argv, monkeypatch, _frames())
            else:
                _port_run(argv, monkeypatch, _frames())
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith(message)


@pytest.mark.parametrize("argv", [
    ["--device", "cpu", "640", "3", "--arm", "offline"],
    ["640", "--device=cpu", "3", "--rep", "5"],
    ["640", "3", "--rep", "5", "--arm", "both", "--device", "cpu"],
])
def test_device_flag_anywhere(argv):
    n_train, ep, arm, rep, dev = dataset_d.parse_args(list(argv))
    assert (n_train, ep, dev) == (640, 3, "cpu")
    assert arm == ("offline" if "offline" in argv else "both")
    assert rep == (5 if "--rep" in argv else None)


def _seed_workdir(wd, n=2, stray=True, marker=None):
    os.makedirs(f"{wd}/Train")
    os.makedirs(f"{wd}/Val")
    for i in range(n):
        for ext in (".png", ".csv"):
            open(f"{wd}/Train/steelpan_{i:07d}{ext}", "w").close()
    if stray:  # a partial inflation left these
        os.makedirs(f"{wd}/TrainAug")
        open(f"{wd}/TrainAug/steelpan_0000000_v_r1.00.png", "w").close()
    if marker is not None:
        with open(f"{wd}/inflate_done.json", "w") as f:
            json.dump(marker, f)


@pytest.mark.parametrize("tool", ["dataset_d_run", "dataset_d_prep",
                                  "dataset_d_inflate"])
def test_marker_semantics_match(tool, monkeypatch, tmp_path):
    """A TrainAug/ without inflate_done.json is partial: removed, copied
    anew from Train/ and inflated once, then the marker written; with the
    marker the inflation is skipped and its wall seconds reused
    (dataset_d) or reported as complete (prep, inflate) — in the port as
    in each JAX script."""
    port_tool = {"dataset_d_run": dataset_d, "dataset_d_prep":
                 dataset_d_prep, "dataset_d_inflate": dataset_d_inflate}[tool]
    argv = {"dataset_d_run": ["2", "1", "--arm", "offline"],
            "dataset_d_prep": ["2", "2", "3"],
            "dataset_d_inflate": ["3"]}[tool]
    seen = {}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        wd = ("logs/dataset_d_data" if side == "jax"
              else "logs/dataset_d_data_torch_cpu")
        _seed_workdir(wd)
        rec = _Recorder(side == "jax", _frames(2, 640, 6))
        rec.install(monkeypatch)
        outs = []
        for _ in range(2):  # partial, then complete
            if side == "jax":
                monkeypatch.setattr(sys, "argv", [f"{tool}.py", *argv])
                _, out = _run(_script(tool).main)
            else:
                _, out = _run(port_tool.main, [*argv, "--device", "cpu"])
            outs.append(out)
        with open(f"{wd}/inflate_done.json") as f:
            marker = json.load(f)
        seen[side] = dict(
            augments=[c[1] for c in rec.calls if c[0] == "augment"],
            inputs=[c[1] for c in rec.calls if c[0] == "augment_input"],
            marker=set(marker), outs=outs,
            wall=marker["wall_s"])
    j, t = seen["jax"], seen["port"]
    strip = lambda c: [a.replace("_torch_cpu", "") for a in c]  # noqa
    assert [strip(a) for a in t["augments"]] == j["augments"]
    assert len(j["augments"]) == 1  # the second run reused the marker
    # the copy was fresh: the stray variant of the partial run is gone
    assert t["inputs"] == j["inputs"] == [["steelpan_0000000.csv",
                                          "steelpan_0000000.png",
                                          "steelpan_0000001.csv",
                                          "steelpan_0000001.png"]]
    assert "wall_s" in t["marker"] and t["marker"] >= j["marker"] - {
        "n_augs"}
    if tool == "dataset_d_run":
        for out in (j["outs"][1], t["outs"][1]):
            assert "(reusing completed inflation:" in out
        for side in (j, t):
            lines = [_lines(o, "OFFLINE")[0] for o in side["outs"]]
            assert lines[1]["inflate_wall_s"] == side["wall"]
    else:
        for out in (j["outs"], t["outs"]):
            assert "INFLATE_DONE" in out[0] and "already complete" in out[1]
            if tool == "dataset_d_prep":
                assert all("DATAGEN_DONE" in o for o in out)


def test_inflate_needs_the_train_split(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="Train missing"):
        dataset_d_inflate.main(["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["dataset_d_inflate.py"])
    with pytest.raises(SystemExit, match="Train missing"):
        _script("dataset_d_inflate").main()


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
def test_port_directories_are_never_the_jax_scripts(device, monkeypatch,
                                                    tmp_path):
    """Every directory the port reads or writes for an arm lies apart from
    every one the JAX script uses (none inside another), and the CPU's
    apart from the card's."""
    monkeypatch.chdir(tmp_path)
    j_rec, _ = _jax_run([], monkeypatch, _frames())
    jax_dirs = {"logs/dataset_d_data"} | {
        c[4] for c in j_rec.calls if c[0] == "train"} | {
        c[1].rstrip("/") for c in j_rec.calls if c[0] == "evaluate"}
    port_dirs = {dataset_d.workdir(device)} | {
        dataset_d.log_dir(t, device) for t in ("offline42x", "geo_fly")} | {
        dataset_d.log_dir(t, device) + "_eval"
        for t in ("offline42x", "geo_fly")}
    assert len(jax_dirs) == len(port_dirs) == 5
    for p in port_dirs:
        for j in jax_dirs:
            assert os.path.commonpath([p, j]) not in (p, j), (p, j)
    other = "cpu" if device != "cpu" else "cuda"
    assert dataset_d.workdir(device) != dataset_d.workdir(other)
    assert dataset_d.workdir("cuda") == dataset_d.workdir("cuda:1")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_prep_writes_the_jax_scripts_files(monkeypatch, tmp_path):
    """`dataset_d_prep 3 2 2` on the CPU against the JAX script's: the
    same Train/, Val/ and TrainAug/ file names (the generator's frame
    numbers and the augmentation draws are JAX's), the same label files
    of the generated frames byte for byte, and the marker's keys."""
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["dataset_d_prep.py", "3", "2",
                                              "2"])
            _, out = _run(_script("dataset_d_prep").main)
        else:
            _, out = _run(dataset_d_prep.main, ["3", "2", "2", "--device",
                                                "cpu"])
        assert "DATAGEN_DONE" in out and "INFLATE_DONE" in out
    jwd = tmp_path / "jax" / "logs" / "dataset_d_data"
    twd = tmp_path / "port" / "logs" / "dataset_d_data_torch_cpu"
    names = _tree(jwd)
    assert _tree(twd) == names
    aug = [n for n in names if n.startswith("TrainAug") and
           n.endswith(".png")]
    assert 3 < len(aug) <= 3 * 3
    for n in names:
        if n.endswith(".csv") and not n.startswith("TrainAug"):
            assert (twd / n).read_bytes() == (jwd / n).read_bytes(), n
    with open(twd / "inflate_done.json") as f, \
            open(jwd / "inflate_done.json") as g:
        assert set(json.load(f)) == set(json.load(g)) == {"wall_s",
                                                          "n_augs"}


def test_dataset_d_runs_end_to_end(monkeypatch, tmp_path):
    """Both arms through the module's seams: 16 train and 16 val frames,
    one variant a frame, one epoch, Xception (full width) at 96^2 on the
    CPU: the PNGs written and loaded, the inflated set of 32 frames on the
    resident feed, the on-the-fly arm at epoch_repeats 2, and a result
    line with the JAX script's keys and finite metrics."""
    monkeypatch.chdir(tmp_path)
    for name, v in (("N_VAL", 16), ("N_AUGS", 1), ("INPUT_SIZE", 96)):
        monkeypatch.setattr(dataset_d, name, v)
    res, out = _run(dataset_d.main, ["16", "1", "--device", "cpu"])
    line = _lines(out, "DATASET_D_RESULT")
    assert len(line) == 1 and set(line[0]) == RESULT_KEYS["both"]
    assert line[0] == json.loads(json.dumps(res, default=float))
    off, fly = res["offline"], res["onthefly"]
    assert set(off) == ARM_KEYS | {"inflate_wall_s"}
    assert set(fly) == ARM_KEYS | {"epoch_repeats"}
    assert off["imgs_seen"] == 32 and fly["imgs_seen"] == 32
    assert fly["epoch_repeats"] == 2
    for r in (off, fly):
        for k in ("ring_acc", "class_acc", "mAP", "pix_err"):
            assert np.isfinite(r[k]), k
    wd = "logs/dataset_d_data_torch_cpu"
    pngs = [f for f in os.listdir(f"{wd}/TrainAug") if f.endswith(".png")]
    assert len(pngs) == 32
    assert len(os.listdir(f"{wd}/Val")) == 32  # 16 PNG + 16 CSV
    with open(f"{wd}/inflate_done.json") as f:
        assert json.load(f)["n_augs"] == 1
    stages = _lines(out, "DATASET_D_STAGES")
    assert stages[0]["frames"] == 32 and stages[0]["inflated_files"] == 32
    assert stages[1]["frames"] == 16
    for s in stages:
        assert all(np.isfinite(s[k]) for k in ("load_s", "train_s",
                                                "eval_s"))
        assert len(s["img_per_sec"]) == 1
    assert out.count("device-resident dataset") == 2
    for tag in ("offline42x", "geo_fly"):
        assert os.path.exists(f"logs/dataset_d_{tag}_torch_cpu/losses.dat")
        assert os.path.exists(
            f"logs/dataset_d_{tag}_torch_cpu_eval/hawley_spnet.csv")
    # a second run reuses the data and the inflation
    _, out = _run(dataset_d.main, ["16", "1", "--arm", "offline",
                                   "--device", "cpu"])
    assert "(reusing completed inflation:" in out
    assert _lines(out, "OFFLINE")[0]["inflate_wall_s"] == \
        off["inflate_wall_s"]


@pytest.mark.parametrize("argv", [["ck"], ["ck", "64"]])
def test_eval_blur_split_matches_the_jax_script(argv, monkeypatch):
    """For the same checkpoint and evaluation results, the port prints the
    JAX script's two BLUR_SPLIT lines, after calling synthetic_dataset
    with the same size, seed, input size and blur flags, and
    evaluate_network without mAP or overlays."""
    seen = {"jax": [], "port": []}
    results = iter([dict(EVAL, ring_acc=92.43), dict(EVAL, ring_acc=92.95)]
                   * 2)

    def synth(side):
        def fn(n, grid, seed=0, input_size=331, blur=None, **kw):
            seen[side].append(("synth", n, seed, input_size, blur))
            return collections.namedtuple("Set", "x")(np.zeros((n, 1)))
        return fn

    def evaluate(side):
        def fn(*a, **kw):
            seen[side].append(("evaluate", kw["num_draw"],
                               kw["compute_map"]))
            return next(results)
        return fn

    jcfg = JExperimentConfig()  # input size 331
    monkeypatch.setattr(j_cli_common, "load_model_and_state",
                        lambda ckpt: (jcfg, None, None))
    monkeypatch.setattr(j_dataset, "synthetic_dataset", synth("jax"))
    monkeypatch.setattr(j_evaluate, "evaluate_network", evaluate("jax"))
    monkeypatch.setattr(sys, "argv", ["eval_blur_split.py", *argv])
    _, j_out = _run(_script("eval_blur_split").main)

    cfg = ExperimentConfig.from_json(jcfg.to_json())
    monkeypatch.setattr(eval_blur_split, "load_model_and_state",
                        lambda ckpt, device: (cfg, None, 0))
    monkeypatch.setattr(eval_blur_split, "synthetic_dataset",
                        synth("port"))
    monkeypatch.setattr(eval_blur_split, "evaluate_network",
                        evaluate("port"))
    lines, t_out = _run(eval_blur_split.main, [*argv, "--device", "cpu"])

    assert seen["port"] == seen["jax"]
    n = int(argv[1]) if len(argv) > 1 else 4992
    assert [s for s in seen["jax"] if s[0] == "synth"] == [
        ("synth", n, 777777, 331, True), ("synth", n, 777777, 331, False)]
    want = _lines(j_out, "BLUR_SPLIT")
    assert _lines(t_out, "BLUR_SPLIT") == want == lines
    assert [w["val"] for w in want] == ["blurred(30%)", "blur-free"]
    assert set(want[0]) == {"val", "ring_acc", "class_acc", "mean_pix_err"}


@pytest.mark.parametrize("tool,argv", [
    (dataset_d, []), (dataset_d_prep, []), (dataset_d_inflate, []),
    (eval_blur_split, ["ck"])])
def test_tools_need_a_card_unless_asked(tool, argv, monkeypatch, tmp_path):
    """Without --device or SPNET_DEVICE each tool asks for the card, and
    on a host without one it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SPNET_DEVICE", raising=False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main(argv)
    assert os.listdir(tmp_path) == []
