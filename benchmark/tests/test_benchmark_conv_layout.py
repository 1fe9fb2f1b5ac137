"""The reader of ``conv_layout_ms_per_call.corpus`` on hand-made traces,
with kernel names as the card's profiler gives them."""

import types

import pytest

from benchmark import readers, trace

NAME = "conv_layout_ms_per_call.corpus"
COPY = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
        "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIterator"
        "Base&)::{lambda()#3}::operator()() const::{lambda()#8}::operator()"
        "() const::{lambda(%s)#1}>")
# (name, counted): cuDNN's conversions, ATen's bfloat16 copies and fills;
# float32 copies and fills (analysis, synthesis), casts to bfloat16, the
# convolution and the bias add are not layout traffic
KERNELS = [
    ("void transposeBlock_kernel<__nv_bfloat16, __nv_bfloat16, float, 32u, "
     "8u>(int, int, int, float, __nv_bfloat16 const*, __nv_bfloat16*)", True),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>", True),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, true, false, (cudnnKernelDataType_t)0>", True),
    ("void tensorTransformGeneric<__nv_bfloat16, __nv_bfloat16, float, true, "
     "false, false, (cudnnKernelDataType_t)0>", True),
    (COPY % "c10::BFloat16", True),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "FillFunctor<c10::BFloat16>, std::array<char*, 1ul> >", True),
    (COPY % "float", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >", False),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)", False),
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     False),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::CUDAFunctor_add<c10::BFloat16> >", False),
]


def _read(device, host=(("vc.convert_batch", 0, 400),
                        ("vc.convert_batch", 500, 400))):
    s = trace.Summary(device, [("bench.window", 0, 1000), *host],
                      (0, 1000))
    run = types.SimpleNamespace(summary=s, counters={}, spans={})
    return readers.find(NAME)(run)


def test_counts_the_layout_kernels_per_call():
    # kernel i runs for 10 * (i + 1) ns; two calls in the window
    device = [(n, 10 * i, 10 * (i + 1)) for i, (n, _) in enumerate(KERNELS)]
    want = sum(10 * (i + 1) for i, (_, c) in enumerate(KERNELS) if c)
    assert _read(device) == pytest.approx(1e-6 * want / 2)


def test_reads_zero_where_no_layout_kernel_ran():
    device = [(n, 10 * i, 10) for i, (n, c) in enumerate(KERNELS) if not c]
    assert _read(device) == 0.0


def test_no_device_events_or_no_call_reads_none():
    assert readers.find(NAME)(types.SimpleNamespace(
        summary=None, counters={}, spans={})) is None
    assert _read([]) is None                               # the CPU
    assert _read([(KERNELS[0][0], 0, 10)], host=()) is None
