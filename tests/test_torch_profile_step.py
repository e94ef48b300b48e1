"""`tools/profile_step.py` on the CPU: the eager step of Xception at 96^2,
b=2, 2 traced steps (on the CPU the "kernels" are the aten ops, by self
time), and the kernel classes of names the card's traces show."""

import json

import pytest
import torch

from spnet_tpu_torch.tools import profile_step

torch.set_num_threads(2)

KEYS = {"form", "batch", "steps", "backbone", "input_size", "compute_dtype",
        "device", "card", "step_ms", "trace", "window_ms", "busy_share",
        "device_us_per_step", "top_kernels", "classes_us", "class_shares",
        "loss_kernel_calls", "aten_ops", "bn_forward_us_per_step",
        "residual_forward_us_per_step", "residual_joins_per_step"}


def test_eager_profile_on_the_cpu(tmp_path, capsys):
    """The result line's keys and class names; the class sums add up to
    the kernels' total, their shares to 1; the top kernels and aten ops
    are sorted and their classes are the tool's; the BatchNorm ranges
    were seen; the printed line is the returned dict."""
    res = profile_step.main(["2", "--form", "eager", "--steps", "2",
                             "--device", "cpu"], input_size=96,
                            logdir=str(tmp_path))
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("PROFILE_STEP_RESULT ")]
    assert len(line) == 1
    assert json.loads(line[0].split(" ", 1)[1]) == json.loads(
        json.dumps(res))
    assert set(res) == KEYS
    assert (res["form"], res["batch"], res["steps"], res["device"],
            res["backbone"], res["input_size"]) == ("eager", 2, 2, "cpu",
                                                   "Xception", 96)
    assert res["card"] is None  # no card: the CPU names itself
    assert tuple(res["classes_us"]) == profile_step.CLASS_NAMES
    assert set(profile_step.CLASS_NAMES) == {
        "ours", "cudnn_conv", "gemm", "multi_tensor_apply", "copy_cast",
        "index_gather", "reduction", "elementwise", "other"}
    total = res["device_us_per_step"]
    assert total > 0
    assert sum(res["classes_us"].values()) == pytest.approx(total, rel=1e-9)
    assert sum(res["class_shares"].values()) == pytest.approx(1.0, rel=1e-9)
    assert 0 < res["busy_share"] <= 1
    us = [k["us_per_step"] for k in res["top_kernels"]]
    assert us == sorted(us, reverse=True) and len(us) <= 25
    for k in res["top_kernels"]:
        assert k["cls"] == profile_step.kernel_class(k["name"])
    ops = [o["us_per_step"] for o in res["aten_ops"]]
    assert ops == sorted(ops, reverse=True) and len(ops) >= 5
    assert all(o["op"].startswith("aten::") for o in res["aten_ops"])
    assert 0 < res["bn_forward_us_per_step"] < res["window_ms"] * 1e3
    # Xception has no residual joins, so no span of theirs
    assert res["residual_forward_us_per_step"] == 0
    assert res["residual_joins_per_step"] == 0
    # the classes that carry the step's arithmetic on the CPU are seen
    for cls in ("cudnn_conv", "gemm", "elementwise", "reduction"):
        assert res["classes_us"][cls] > 0, cls


@pytest.mark.parametrize("name,cls", [
    ("void spnet::loss_kernel<4, 0, true, false>(float const*)", "ours"),
    ("void wgmma_kernel<2, 128>(Params)", "ours"),
    ("dgrad2d_c1_k1_nhwc_specialized", "cudnn_conv"),
    ("void convolve_common_engine_float_NHWC<__nv_bfloat16>(int)",
     "cudnn_conv"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "cudnn_conv"),
    ("nvjet_tst_128x64_64x8_2x4_h_bz_NTT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "at::native::(anonymous namespace)::TensorListMetadata<2>>()",
     "multi_tensor_apply"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)>()", "copy_cast"),
    ("void (anonymous namespace)::batchnorm_grad_sums_kernel<__nv_bfloat16"
     ", 8>(__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
     "float const*, float const*, float*, long long, int, int)", "ours"),
    ("Memcpy DtoD (Device -> Device)", "copy_cast"),
    ("memcpy32_post", "copy_cast"),
    ("void at::native::index_elementwise_kernel<128, 4>()", "index_gather"),
    ("void at::native::vectorized_gather_kernel<16, long>()",
     "index_gather"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>>>()", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>()", "elementwise"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<"
     "c10::BFloat16, int>()", "other"),
    ("aten::mm", "gemm"), ("aten::convolution_backward", "cudnn_conv"),
    ("aten::_foreach_mul_", "multi_tensor_apply"), ("aten::copy_", "copy_cast"),
    ("aten::index", "index_gather"), ("aten::sum", "reduction"),
    ("aten::mul", "elementwise"), ("aten::empty_strided", "other"),
])
def test_kernel_class(name, cls):
    """Names as the card's traces and the CPU's aten ops give them, each
    in its class (the first pattern in `CLASSES` that finds it)."""
    assert profile_step.kernel_class(name) == cls


def test_form_is_checked():
    with pytest.raises(ValueError, match="form"):
        profile_step.run(2, form="scan", steps=1, device="cpu")


def test_backbone_flag(tmp_path):
    """`--backbone` picks the model: InceptionResNetV2's eager step at
    160^2 (its smallest input), b=2, one traced step; its 40 residual
    joins are counted and their spans read."""
    res = profile_step.main(["2", "--form", "eager", "--steps", "1",
                             "--backbone", "InceptionResNetV2", "--device",
                             "cpu"], input_size=160, logdir=str(tmp_path))
    assert (res["backbone"], res["input_size"], res["batch"]) == (
        "InceptionResNetV2", 160, 2)
    assert res["classes_us"]["cudnn_conv"] > 0
    assert 0 < res["bn_forward_us_per_step"] < res["window_ms"] * 1e3
    assert res["residual_joins_per_step"] == 40
    assert 0 < res["residual_forward_us_per_step"] < res["window_ms"] * 1e3

