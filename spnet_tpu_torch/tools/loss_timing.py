"""Time the loss kernels of this checkout beside those of another one.

    python3 spnet_tpu_torch/tools/loss_timing.py --other DIR [--b 128]

DIR holds another version of `spnet_tpu_torch/` (for example the parent
commit's, unpacked with `git archive <commit> spnet_tpu_torch | tar -x -C
DIR`).  The two packages share a name, so each runs in a process of its
own, in turns: other, this, this, other, each building its kernels from
its own sources.  Every process times, at (B, 576) float32 'same' on
chip_smoke.py's seeded inputs and with chip_smoke.py's helpers:

  fwd      spnet_loss_fwd(y_true, y_pred)            the loss alone
  bwd      spnet_loss_bwd(y_true, y_pred, g)         g * dloss/dy_pred
  step     spnet_loss_fused forward + autograd.grad  what a train step runs
  fused    spnet_loss_fused forward, y_pred needing a gradient
  ss_step  the 'ss' head's train step from the pre-activation z to the
           loss and dloss/dz, by the route the checkout's own
           `train/steps.py::forward_loss` takes: the loss kernel with the
           selective sigmoid in its pass where `spnet_loss_fused` has the
           `selective_sigmoid` flag (2 launches), else `SelectiveSigmoid`
           (K4), the fused loss and K4's backward (4 launches)
  floor    a one-element add_

each as the device time per call from a CUDA graph of 100 calls (`ms`),
the event time of one call (`call_ms`) and the host time per eager call
(`host_us`), and prints one JSON line (with the loss, and the 'ss' loss,
as hex floats, to show them bitwise equal across versions); then a table
of all four runs.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: Path, b: int) -> dict:
    """The timings of the `spnet_tpu_torch` found under `root`."""
    cs = _chip_smoke()  # before `root` goes first on the path
    sys.path.insert(0, str(root))
    import torch

    from spnet_tpu_torch.ops import losses
    from spnet_tpu_torch.ops.activations import SelectiveSigmoid

    if Path(losses.__file__).resolve().parents[2] != root.resolve():
        raise RuntimeError(f"imported {losses.__file__}, not from {root}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    yt, yp = cs._loss_inputs(b, 576, gen)
    p = yp.clone().requires_grad_(True)
    g = torch.full((), 0.75, device="cuda")

    def step():
        loss = losses.spnet_loss_fused(yt, p)
        return loss, torch.autograd.grad(loss, p, g)[0]

    fused_ss = "selective_sigmoid" in inspect.signature(
        losses.spnet_loss_fused).parameters

    def ss_step():
        if fused_ss:
            loss = losses.spnet_loss_fused(yt, p, selective_sigmoid=True)
        else:
            loss = losses.spnet_loss_fused(yt, SelectiveSigmoid.apply(p))
        return loss, torch.autograd.grad(loss, p, g)[0]

    fns = {"fwd": lambda: losses.spnet_loss_fwd(yt, yp),
           "bwd": lambda: losses.spnet_loss_bwd(yt, yp, g),
           "step": step,
           "fused": lambda: losses.spnet_loss_fused(yt, p),
           "ss_step": ss_step}
    out = {k: cs._timings(fn) for k, fn in fns.items()}
    out["floor"] = dict(ms=cs.launch_floor_ms())
    loss = losses.spnet_loss_fwd(yt, yp)
    out["loss_hex"] = float(loss).hex()
    out["ss_loss_hex"] = float(ss_step()[0]).hex()
    out["ss_route"] = "fused" if fused_ss else "composed"
    out["root"] = str(root)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="directory holding the other spnet_tpu_torch/")
    ap.add_argument("--root", type=Path,
                    help="measure the package under this directory only")
    ap.add_argument("--b", type=int, default=128)
    args = ap.parse_args(argv)
    if args.root is not None:
        print(json.dumps(measure(args.root, args.b)))
        return
    if args.other is None:
        ap.error("give --other DIR (or --root DIR for one run)")
    runs = []
    for name, root in (("other", args.other), ("this", ROOT),
                       ("this", ROOT), ("other", args.other)):
        res = subprocess.run(
            [sys.executable, __file__, "--root", str(root), "--b",
             str(args.b)], capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"the run of {root} failed:\n{res.stderr}")
        line = res.stdout.strip().splitlines()[-1]
        runs.append((name, json.loads(line)))
        print(f"[{name}] {line}")
    print(f"B={args.b} M=576 'same'; ms = device ms per call (graph of 100), "
          "call = one call between events (ms), host = us per eager call")
    for key in ("fwd", "bwd", "step", "fused", "ss_step"):
        print(f"{key:8s}" + "".join(
            f"  {name}: ms {r[key]['ms']:.5f} call {r[key]['call_ms']:.4f} "
            f"host {r[key]['host_us']:.2f}" for name, r in runs))
    print("floor   " + "".join(f"  {name}: ms {r['floor']['ms']:.5f}"
                               for name, r in runs))
    for key in ("loss_hex", "ss_loss_hex", "ss_route"):
        print(f"{key:12s}" + "".join(f"  {name}: {r[key]}"
                                     for name, r in runs))


if __name__ == "__main__":
    main()
