"""InceptionResNetV2 in the port against the benchmark's plain float32
reference (`perfbench/reference/inception_resnet_v2.py`), on the CPU at
input 224 (the last maps 2x2; at 160 they are 1x1), b=2, full widths,
with the weights and BatchNorm statistics a benchmark run gives them
(`perfbench.core.program_model`: `inputs.make_weights` from the seed, the
running statistics from the frames).  Also the residual blocks' span and
counter in an eager train step.  No JAX here."""

import copy
import json
import math
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import core, inputs
from perfbench.counts.model import ref_config
from perfbench.reference import spnet as ref
from spnet_tpu_torch.config import LossWeights, ModelConfig
from spnet_tpu_torch.models import inception_resnet_v2 as irv2
from spnet_tpu_torch.models.layers import BatchNorm
from spnet_tpu_torch.models.spnet import build_model
from spnet_tpu_torch.train import steps as program_steps
from spnet_tpu_torch.train.schedule import onecycle_schedule
from spnet_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH, SEED = 224, 2, 2 ** 31 + 5
#: float32 rounding.  The forward, the loss and every BatchNorm's batch
#: moments read 0 here: both sides run the same float32 ops in the same
#: order; the limit leaves room for another grouping of a conv (SAME pads
#: inside the conv or as a pad, the `up` bias inside it or after), which
#: 40 residual blocks and 207 batch-normalized layers carry to the output
F32_OUT = 1e-6
F32_LOSS = 1e-6
#: of each BatchNorm input's mean magnitude plus its spread
F32_MOMENTS = 1e-6
#: a leaf's gradient, of the larger of its norm and the median leaf's: the
#: two backward graphs sum the same terms in other orders (the port's
#: BatchNorm and residual join against the reference's autograd); read up
#: to 3.6e-6 (the stem's leaves, below every block)
F32_GRAD = 3e-5


def _config(**model):
    cfg = json.loads((ROOT / "perfbench" / "configs" / "irv2331.json")
                     .read_text())
    cfg["model"].update(model)
    return cfg


@pytest.fixture(scope="module")
def setup():
    """The configuration at 224 in float32, the port's model holding the
    benchmark's weights (eval mode), the weights, and BATCH frames."""
    cfg = _config(input_size=SIZE, compute_dtype="float32")
    ctx = core.Ctx("irv2-test", cfg, {}, SEED, 1.0, False,
                   torch.device("cpu"), 0.0)
    x = inputs.frames(BATCH, SIZE, SEED, "frames", "cpu")
    model, weights = core.program_model(ctx, x)
    return cfg, model, weights, x


def test_param_shapes_are_the_ports():
    """Every state-dict name and shape at 331, the configuration's count
    of trained leaves, 207 BatchNorms, and none in the backbone with a
    scale."""
    cfg = _config()
    model = build_model(ModelConfig(backbone="InceptionResNetV2"),
                        device="meta")
    prog = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ref.param_shapes(ref_config(cfg)) == prog
    assert sum(math.prod(s) for k, s in prog.items()
               if ref.is_param(k)) == cfg["parameters"]
    assert sum(k.endswith(".running_mean") for k in prog) == 207
    assert not [k for k in prog if k.startswith("backbone.")
                and k.endswith("bn.weight")]
    assert prog["final_output.weight"] == (576, 3 * 3 * 1536)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_reference_f32(setup, train):
    cfg, model0, w, x = setup
    model = copy.deepcopy(model0).train(train)
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    xn = ref.normalize(x)
    with torch.no_grad():
        yp = model(xn, dropout_generator=g1)
        yr = ref.forward(w, xn, ref_config(cfg), train, g2)
    assert yr.std() > 0.01
    assert float((yp - yr).abs().max()) <= F32_OUT * float(yr.abs().max())


def _moments(x):
    """A BatchNorm input's float32 batch moments, as the layer takes them:
    the mean and the fast variance E[x^2] - E[x]^2 clamped at 0."""
    xf = x.detach().float()
    dims = tuple(range(xf.dim() - 1))
    mean = xf.mean(dims)
    return mean, torch.clamp_min(torch.square(xf).mean(dims)
                                 - torch.square(mean), 0.0)


def test_train_step_matches_reference_f32(setup):
    """One train-mode forward with dropout, the 'same' loss plus the L2
    term, and its gradient: the loss, every leaf's gradient, and every
    BatchNorm's batch moments, port against reference."""
    cfg, model0, w, x = setup
    rc = ref_config(cfg)
    model = copy.deepcopy(model0).train()
    y = inputs.labels(BATCH, rc["num_outputs"], SEED, "labels", "cpu")
    xn = ref.normalize(x)

    moments = {}
    hooks = [m.register_forward_pre_hook(
        lambda _m, args, name=name: moments.__setitem__(
            name, _moments(args[0])))
        for name, m in model.named_modules() if isinstance(m, BatchNorm)]
    try:
        loss, _ = program_steps.forward_loss(
            model, xn, y, torch.Generator().manual_seed(3), LossWeights(),
            rc["loss_type"], rc["l2_reg"])
    finally:
        for h in hooks:
            h.remove()
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)

    p = {n: v.clone().requires_grad_(ref.is_param(n)) for n, v in w.items()}
    stats = {}
    out = ref.forward(p, xn, rc, True, torch.Generator().manual_seed(3),
                      stats=stats)
    rloss = ref.same_loss(y, out) + rc["l2_reg"] * ref.l2_term(p)
    rgrads = torch.autograd.grad(rloss, [p[n] for n in names])

    assert abs(float(loss) - float(rloss)) <= F32_LOSS * abs(float(rloss))
    norms = [float(g.norm()) for g in rgrads]
    med = sorted(norms)[len(norms) // 2]
    assert med > 0
    for n, g, r, rn in zip(names, grads, rgrads, norms):
        assert float((g - r).norm()) <= F32_GRAD * max(rn, med), n
    assert set(moments) == set(stats) and len(stats) == 207
    for name, (mr, vr) in stats.items():
        mp, vp = moments[name]
        mag = float(mr.abs().mean() + vr.sqrt().mean())
        assert float((mp - mr).abs().max()) <= F32_MOMENTS * mag, name
        assert float((vp - vr).abs().max()) <= F32_MOMENTS * mag ** 2, name


def test_residual_span_and_counter_in_an_eager_step(setup, tmp_path):
    """An eager train step exports 40 `spnet.residual` spans, one a
    residual block, each inside the step, and counts 40 joins; an eval
    forward without a profiler counts 40 too."""
    cfg, model0, _, x = setup
    model = copy.deepcopy(model0)
    state = create_train_state(model, onecycle_schedule(1e-4, 100))
    step = program_steps.make_train_step(model, augment=True, indexed=False)
    y = inputs.labels(BATCH, cfg["model"]["num_outputs"], SEED, "labels",
                      "cpu")
    before = irv2._Residual.joins
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.step"):
            step(state, x, y, torch.Generator().manual_seed(0))
    assert irv2._Residual.joins - before == 40
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if "dur" in e]
    (outer,) = [e for e in events if e["name"] == "test.step"]
    spans = [e for e in events if e["name"] == "spnet.residual"]
    assert len(spans) == 40 and all(e["cat"] == "cpu_op" for e in spans)
    assert all(outer["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= outer["ts"] + outer["dur"] for e in spans)
    before = irv2._Residual.joins
    with torch.no_grad():
        model.eval()(ref.normalize(x))
    assert irv2._Residual.joins - before == 40
