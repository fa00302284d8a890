"""The device-time accounting of tools/profile_port.py: busy time is the
union of device intervals, so overlapping or nested operations count once
and host events count not at all."""
import importlib.util
import json
import pathlib

import pytest

from torch_port_fixtures import one_thread  # noqa: F401

_PATH = pathlib.Path(__file__).resolve().parents[1] / "tools" / "profile_port.py"
_spec = importlib.util.spec_from_file_location("profile_port", _PATH)
profile_port = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(profile_port)


@pytest.mark.parametrize("intervals,expected", [
    ([], 0.0),
    ([("a", 0, 10), ("b", 20, 25)], 15.0),          # disjoint
    ([("a", 0, 10), ("b", 5, 15)], 15.0),           # overlapping
    ([("a", 0, 10), ("b", 2, 4), ("c", 10, 12)], 12.0),  # nested, touching
])
def test_union_us(intervals, expected):
    assert profile_port.union_us(intervals) == expected


def test_device_intervals_keeps_device_ops_only(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 160,
         "dur": 5},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 90,
         "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0,
         "dur": 500},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 95, "dur": 3},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 100},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ivs = profile_port.device_intervals(str(path))
    assert sorted(ivs) == [("Memcpy DtoH", 160.0, 165.0),
                           ("Memset", 90.0, 92.0), ("k", 100.0, 150.0)]
    assert profile_port.union_us(ivs) == 57.0


@pytest.mark.parametrize("name,cls", [
    ("void gr::fused_dropout_kernel<__nv_bfloat16, 8>(...)",
     "B5 dropout kernel"),
    ("void gr::conv3x3_bn_act_kernel<__nv_bfloat16, true>(...)",
     "hand-written kernels on the CUDA cores"),
    ("void gr::upsample2_wgmma_kernel<256>(CUtensorMap_st, ...)",
     "hand-written kernels on the tensor cores (bf16)"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc",
     "convolution (cuDNN)"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_f32f32_tf32f32_f32",
     "convolution (cuDNN)"),
    ("void cudnn::engines_precompiled::convertTensor_kernel<float>",
     "convolution (cuDNN)"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", "matmul (cuBLAS)"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<>",
     "optimizer and penalties (_foreach)"),
    ("void at::native::reduce_kernel<128, 4, ReduceOp<float, MeanOps>>",
     "reduction"),
    ("void at::native::vectorized_elementwise_kernel<8, "
     "bfloat16_copy_kernel_cuda>", "copy and cast"),
    ("void at::native::CatArrayBatchedCopy_alignedK_contig<>",
     "copy and cast"),
    ("Memcpy DtoH (Device -> Pageable)", "memcpy and memset"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>",
     "elementwise"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc",
     "pooling"),
    ("ncclKernel_AllReduce", "other"),
])
def test_kernel_class(name, cls):
    assert profile_port.kernel_class(name) == cls


@pytest.mark.parametrize("what", ["gan", "train", "apply_r", "all"])
def test_main_needs_a_card(what, monkeypatch, capsys):
    """Every section, the adversarial batch pair (--what gan) among them,
    refuses to run without a CUDA device: a measurement never falls back
    to the CPU."""
    monkeypatch.setattr(profile_port.torch.cuda, "is_available",
                        lambda: False)
    assert profile_port.main(["--what", what]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
