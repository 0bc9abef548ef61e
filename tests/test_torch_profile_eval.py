"""The eval profile's kernel families (`beat_this_tpu_torch/bench/profile_eval.py`):
every kernel an eval forward launches, by the names the library compiles
(the redesigned K1, K2 and K3 and the SIMT kernels before them), falls in its
family, and the feed-forward launches that K1 and K2's tail share go to
whichever ran in the window. The profile itself needs the card."""

import pytest

from beat_this_tpu_torch.bench import profile_eval as pe


@pytest.mark.parametrize("name,fam,grp", [
    # K2 (fused_time.cu): mangled names of the redesigned launches
    ("void (anonymous namespace)::tq::time_rows_kernel<512, float, 2>(...)",
     "K2 rows (norm, gates)", "K2"),
    ("void (anonymous namespace)::tq::time_qkv_kernel<128, __nv_bfloat16, 1, 1>(...)",
     "K2 qkv (RoPE epilogue)", "K2"),
    ("void (anonymous namespace)::tc::attn_fwd_kernel<2, true>(...)", "K2 attention core", "K2"),
    ("void (anonymous namespace)::time_out_kernel<128, float, 2>(...)",
     "K2 out projection (y1)", "K2"),
    # K3 (fused_freq.cu) on the tensor cores
    ("void (anonymous namespace)::freq_block_kernel<128, __nv_bfloat16, false>(...)",
     "K3 fused_freq (tensor cores)", "K3"),
    # the SIMT kernels of earlier trees
    ("void (anonymous namespace)::time_attn_kernel<float>(...)", "K2 attention (SIMT)", "K2"),
    ("void (anonymous namespace)::time_out_ff_kernel<512, float>(...)",
     "K2 out projection + feed-forward (SIMT)", "K2"),
    ("void (anonymous namespace)::fused_ff_kernel<512, float>(...)", "K1 (SIMT)", "K1"),
    ("void (anonymous namespace)::fused_freq_kernel<32, float, false>(...)", "K3 fused_freq",
     "K3"),
    ("void (anonymous namespace)::flash_fwd_kernel<16, 0>(...)", "B10 flash_fwd", "B10"),
    # B10 on the tensor cores in both dtypes, with its pre-pass
    ("void (anonymous namespace)::tc::flash_fwd_kernel<16, float, 0>(...)", "B10 flash_fwd",
     "B10"),
    ("void (anonymous namespace)::tc::rotate_kernel<16, float, 3>(...)",
     "B10 pre-pass (rotation, operand parts)", "B10"),
    ("void (anonymous namespace)::small_fwd_kernel<16>(...)", "B12 small_fwd", "B12"),
    ("ampere_sgemm_128x64_nn", pe.OTHER, "rest"),
    ("void at::native::elementwise_kernel<128, 2>(...)", pe.OTHER, "rest"),
])
def test_families_of_the_eval_kernels(name, fam, grp):
    assert pe.family(name) == fam
    assert pe.group(fam, k1_launches=0, k2_launches=9) == grp


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::mm::operands_kernel<float, 2>(...)",
    "void (anonymous namespace)::ff::ff_pre_kernel<512, float, float, false, 2>(...)",
    "void (anonymous namespace)::ff::ff_hidden_kernel<2, false>(...)",
    "void (anonymous namespace)::ff::ff_out_kernel<128, __nv_bfloat16, float, 1>(...)",
    "void (anonymous namespace)::ff::ff_product_kernel<false, 128, 2>(...)",
    "void (anonymous namespace)::ff::ff_out_sum_kernel<float, float>(...)",
])
def test_shared_feed_forward_launches_go_to_the_kernel_that_ran(name):
    fam = pe.family(name)
    assert fam in pe.SHARED
    assert pe.group(fam, k1_launches=0, k2_launches=9) == "K2"
    assert pe.group(fam, k1_launches=12, k2_launches=0) == "K1"
    assert pe.group(fam, k1_launches=3, k2_launches=6).startswith("K1 + K2")
