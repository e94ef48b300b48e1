"""Time K1's bf16 kernel with parts cut out, to see what holds a level back.

Builds variants of `csrc/sepconv.cu` side by side (one nvcc each, all
started together) into a temporary directory, each with parts of
`wgmma_kernel` removed by a source substitution, and times every variant
at each shape with CUDA events, on the tiles `sepconv_plan` picks.  A cut
variant computes wrong outputs: it exists only to be timed.  Run it on a
CUDA host from the repo's root:

    python -m spnet_tpu_torch.tools.k1_variants

Variants:
  full           the kernel as it is;
  no_depthwise   the depthwise's loads and multiply-adds dropped (its A
                 chunk is written as zeros);
  no_copies      no TMA copy: each stage's barrier is arrived on directly;
  no_product     no `wgmma`;
  loop_only      none of the three: the step loop, its barriers and the
                 epilogue.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

# (source text, replacement) pairs, each found exactly once in sepconv.cu
DEPTHWISE = ("const bool keep = live && j < rows_left;",
             "const bool keep = false;")
PRODUCT = ("wgmma_k16<TN>(d, da, db);", "(void)da;\n      (void)db;")
COPIES = (
    ("mbar_arrive_expect_tx(b_full(s), Cfg::B_BYTES);\n"
     "    for (int box = 0; box < TN / 64; ++box)",
     "mbar_arrive(b_full(s));\n    for (int box = 0; box < 0; ++box)"),
    ("mbar_arrive_expect_tx(x_full(s), Cfg::x_tx_bytes(W));",
     "mbar_arrive(x_full(s));\n    return;"),
)
VARIANTS = {
    "full": (),
    "no_depthwise": (DEPTHWISE,),
    "no_copies": COPIES,
    "no_product": (PRODUCT,),
    "loop_only": (DEPTHWISE, PRODUCT, *COPIES),
}

# (B, H, W, C, F): a level of each kind at the val-sweep batch, and the
# middle flow at the predict batch
SHAPES = [(256, 10, 10, 728, 728), (256, 80, 80, 128, 128),
          (256, 40, 40, 256, 256), (256, 5, 5, 1536, 2048),
          (16, 10, 10, 728, 728)]


def variant_source(source: str, cuts) -> str:
    for old, new in cuts:
        if source.count(old) != 1:
            raise ValueError(f"cut not found once in sepconv.cu: {old!r}")
        source = source.replace(old, new)
    return source


def build_variants(workdir: str) -> dict[str, ctypes.CDLL]:
    from spnet_tpu_torch.ops import _build

    source = (_build.CSRC / "sepconv.cu").read_text()
    procs = {}
    for name, cuts in VARIANTS.items():
        src = os.path.join(workdir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(source, cuts))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o",
             os.path.join(workdir, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(workdir, f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spnet_sepconv_infer.argtypes = [p] * 6 + [i] * 11 + [p]
        lib.spnet_sepconv_infer.restype = i
        libs[name] = lib
    return libs


def time_variants(libs, shape, reps: int = 20) -> dict[str, float]:
    """Mean ms per call of each variant at `shape` (relu_in on, as the
    model has it), after 3 warm-up calls."""
    import torch

    from spnet_tpu_torch.ops.sepconv import H100_SMS, sepconv_plan

    b, h, w, c, f = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
    dw = torch.randn(3, 3, c, device="cuda", generator=gen)
    pw = torch.randn(c, f, device="cuda", generator=gen).bfloat16()
    scale = torch.rand(f, device="cuda", generator=gen)
    bias = torch.rand(f, device="cuda", generator=gen)
    out = torch.empty(b, h, w, f, device="cuda", dtype=torch.bfloat16)
    tm, tn, tiles = sepconv_plan(*shape)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, lib in libs.items():
        def call():
            err = lib.spnet_sepconv_infer(
                x.data_ptr(), dw.data_ptr(), pw.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                b, h, w, c, f, 0, 1, 1, tm, tn, min(tiles, H100_SMS),
                stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        res[name] = start.elapsed_time(end) / reps
    return res


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as workdir:
        libs = build_variants(workdir)
        for shape in SHAPES:
            res = time_variants(libs, shape)
            cols = "  ".join(f"{k} {v:.4f} ms" for k, v in res.items())
            print(f"[k1_variants] B={shape[0]} {shape[1]}x{shape[2]} "
                  f"{shape[3]}->{shape[4]}  {cols}  [{smi}]", flush=True)


if __name__ == "__main__":
    main()
