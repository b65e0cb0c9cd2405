"""The training step's work count and the kernel-kind classifier."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import train_trace, train_work
from port_bench.reference import net as ref_net
from port_bench.reference import train as ref_train


def test_train_flops_at_576():
    specs = ref_net.layer_specs(576, 2, 3, 3)
    assert train_work.train_flops(specs, 576, 2) == 397_478_264_832


@pytest.mark.parametrize("stride", [1, 2])
def test_train_flops_count_every_conv_of_the_reference_step(stride):
    """At 64 px, PyTorch's count of the reference's train-mode forward
    and backward: its convolutions' FLOPs, forward, input and weight
    gradients (none for the image)."""
    specs = ref_net.layer_specs(64, stride, 3, 3)
    weights = {k: torch.randn(s) * 0.1
               for k, s in ref_net.param_shapes(specs).items()}
    leaves = {k: v.requires_grad_(not k.endswith(("running_mean",
                                                  "running_var")))
              for k, v in weights.items()}
    with FlopCounterMode(display=False) as counter:
        raws = ref_train.TrainNet(specs, leaves)(torch.rand(1, 64, 64, 3))
        sum(r.sum() for r in raws).backward()
    convs = {op: n for op, n in counter.get_flop_counts()["Global"].items()
             if "convolution" in str(op)}
    assert train_work.train_flops(specs, 64, stride) == sum(convs.values())


@pytest.mark.parametrize("name,kind", [
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl_nocast<at::native::BinaryFunctor<float, float, f", "eltwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy"
     "_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}:", "eltwise"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16"
     "_copy_kernel_cuda(at::TensorIteratorBase&)::{lambd", "eltwise"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at"
     "::native::MeanOps<float, float, float, float>, unsi", "reduce"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
     "native::(anonymous namespace)::TensorListMetadata<2>", "adam"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tile"
     "n128m128k64", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv"
     "_bfloat16, float, false, true, (cudnnKernelDataType_t)0>", "conv"),
    ("nvjet_tst_128x160_64x5_1x2_h_ssched_bz_TNT", "conv"),
    ("void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
     "long, unsigned int, 2, 2, -2, true>", "other"),
])
def test_kernel_kinds_of_the_breakdowns_names(name, kind):
    assert train_trace.kernel_kind(name) == kind


def test_device_time_by_kind_takes_the_span():
    from port_bench.trace import Trace
    t = Trace(window_s=1.0, busy_s=0.5, calls=1, ops=[
        (0.0, 0.2, "reduce_kernel<x>", "block", "kernel"),
        (0.2, 0.1, "multi_tensor_apply_kernel<y>", "block", "kernel"),
        (0.3, 0.1, "elementwise_kernel<z>", "fetch", "kernel"),
        (0.4, 0.1, "memcpy", "block", "gpu_memcpy")])
    got = train_trace.device_s_by_kind(t, "block")
    assert got == {"conv": 0.0, "adam": 0.1, "reduce": 0.2, "eltwise": 0.0,
                   "other": 0.0}
