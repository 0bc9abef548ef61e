"""The profiles' attribution by range (`profiler.range_device_ms`, which
`beat_this_tpu_torch/bench/profile_eval.py` and `train/profile.py` print):
every kernel an eval forward launches, by the names the library compiles
(the redesigned K1, K2 and K3 and the SIMT kernels before them), falls in
its family, and its device time counts for the kernel entry whose
`bt.<entry>` range launched it: the device-side span of that range holds
it on its stream. So the feed-forward kernels that K1 and K2's tail share
go to whichever launched them. The host-side rows of the ranges, ranges of
no kernel entry (`bt.model`, which spans the entries' kernels too) and
other streams do not count; the rest of the device time is `REST`. The
profile itself needs the card."""

from types import SimpleNamespace

import pytest
import torch

from beat_this_tpu_torch import profiler
from beat_this_tpu_torch.bench import profile_eval as pe

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
FF = ("FF weight operands", "FF row pass", "FF hidden product", "FF output product",
      "FF output product, depth slices", "FF output slices' sum")
SHARED_FF = [
    "void (anonymous namespace)::mm::operands_kernel<float, 2>(...)",
    "void (anonymous namespace)::ff::ff_pre_kernel<512, float, float, false, 2>(...)",
    "void (anonymous namespace)::ff::ff_hidden_kernel<2, false>(...)",
    "void (anonymous namespace)::ff::ff_out_kernel<128, __nv_bfloat16, float, 1>(...)",
    "void (anonymous namespace)::ff::ff_product_kernel<false, 128, 2>(...)",
    "void (anonymous namespace)::ff::ff_out_sum_kernel<float, float>(...)",
]


def _event(name, device_type, start, end, stream=7, annotation=False):
    return SimpleNamespace(name=name, device_type=device_type, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_resource_id=stream)


@pytest.mark.parametrize("name,fam,entry,kernel", [
    # K2 (fused_time.cu): mangled names of the redesigned launches
    ("void (anonymous namespace)::tq::time_rows_kernel<512, float, 2>(...)",
     "K2 rows (norm, gates)", "fused_time_roformer", "K2"),
    ("void (anonymous namespace)::tq::time_qkv_kernel<128, __nv_bfloat16, 1, 1>(...)",
     "K2 qkv (RoPE epilogue)", "fused_time_roformer", "K2"),
    ("void (anonymous namespace)::tc::attn_fwd_kernel<2, true>(...)", "K2 attention core",
     "fused_time_roformer", "K2"),
    ("void (anonymous namespace)::time_out_kernel<128, float, 2>(...)",
     "K2 out projection (y1)", "fused_time_roformer", "K2"),
    # K3 (fused_freq.cu) on the tensor cores
    ("void (anonymous namespace)::freq_block_kernel<128, __nv_bfloat16, false>(...)",
     "K3 fused_freq (tensor cores)", "fused_freq_roformer", "K3"),
    # the SIMT kernels of earlier trees
    ("void (anonymous namespace)::time_attn_kernel<float>(...)", "K2 attention (SIMT)",
     "fused_time_roformer", "K2"),
    ("void (anonymous namespace)::time_out_ff_kernel<512, float>(...)",
     "K2 out projection + feed-forward (SIMT)", "fused_time_roformer", "K2"),
    ("void (anonymous namespace)::fused_ff_kernel<512, float>(...)", "K1 (SIMT)", "fused_ff",
     "K1"),
    ("void (anonymous namespace)::fused_freq_kernel<32, float, false>(...)", "K3 fused_freq",
     "fused_freq_roformer", "K3"),
    ("void (anonymous namespace)::flash_fwd_kernel<16, 0>(...)", "B10 flash_fwd", "flash_fwd",
     "B10"),
    # B10 on the tensor cores in both dtypes, with its pre-pass
    ("void (anonymous namespace)::tc::flash_fwd_kernel<16, float, 0>(...)", "B10 flash_fwd",
     "flash_fwd", "B10"),
    ("void (anonymous namespace)::tc::rotate_kernel<16, float, 3>(...)",
     "B10 pre-pass (rotation, operand parts)", "flash_fwd_lse", "B10"),
    ("void (anonymous namespace)::small_fwd_kernel<16>(...)", "B12 small_fwd", "small_fwd",
     "B12"),
    ("ampere_sgemm_128x64_nn", pe.OTHER, None, profiler.REST),
    ("void at::native::elementwise_kernel<128, 2>(...)", pe.OTHER, None, profiler.REST),
    # the feed-forward launches K1 and K2's tail share: whose range launched them
] + [(name, None, entry, kernel) for name in SHARED_FF
     for entry, kernel in (("fused_ff", "K1"), ("fused_time_roformer", "K2"))])
def test_device_time_goes_to_the_range_that_launched_it(name, fam, entry, kernel):
    if fam is None:
        assert pe.family(name) in FF
    else:
        assert pe.family(name) == fam
    # a 1.5 ms kernel inside its entry's device-side span, in a 4 ms profile;
    # the forward's span holds every kernel, the host-side range and a
    # kernel of the same name on another stream count for no entry
    events = [_event("bt.model", CUDA, 0.0, 4000.0, annotation=True),
              _event("bt.model", CPU, -50.0, 3000.0, annotation=True),
              _event("aten::mm", CPU, 0.0, 10.0),
              _event(name, CUDA, 1000.0, 2500.0), _event(name, CUDA, 1000.0, 2500.0, stream=9),
              _event("ampere_sgemm_64x64_nn", CUDA, 3000.0, 3100.0)]
    if entry is not None:
        events += [_event(f"bt.{entry}", CUDA, 900.0, 2600.0, annotation=True),
                   _event(f"bt.{entry}", CPU, 100.0, 200.0, annotation=True)]
    got = profiler.range_device_ms(events, device_ms=4.0)
    want = {profiler.REST: 4.0} if entry is None else {kernel: 1.5, profiler.REST: 2.5}
    assert got == pytest.approx(want)
    assert profiler.OP_ENTRIES.get(entry, profiler.REST) == kernel
