"""The traced slice's reduction: busy as the union of device intervals,
idle gaps labelled by the innermost host operation, kernel classes read
from their files."""
import pytest

from harness.profile import SLICE, classify, load_classes, reduce_events
from harness.spec import BENCH

CLASSES = load_classes(BENCH / "kernel_classes")


def test_busy_is_the_union_and_clipped_to_the_slice():
    ev = [(SLICE, False, 100.0, 200.0),
          ("step", False, 100.0, 200.0),
          ("aten::mm", False, 150.0, 160.0),
          ("flash_attention_tc_kernel", True, 90.0, 120.0),     # clipped
          ("sm90_xmma_gemm_bf16", True, 110.0, 130.0),          # overlaps
          ("void at::native::vectorized_elementwise_kernel", True,
           140.0, 150.0),
          ("mystery_kernel", True, 190.0, 210.0),               # clipped
          (SLICE, True, 100.0, 200.0)]                          # annotation
    t = reduce_events(ev, CLASSES, gap_floor_us=5.0)
    assert t.slice_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((30 + 10 + 10) * 1e-6)
    assert t.by_class["attention"] == pytest.approx(20e-6)
    assert t.by_class["gemm"] == pytest.approx(20e-6)
    assert t.by_class["pytorch"] == pytest.approx(10e-6)
    assert t.unclassified == ["mystery_kernel"]
    # gaps 130-140 (host in "step"), 150-190 (aten::mm covers 155-160?
    # no: the middle, 170, lies in "step" only)
    assert dict(t.gaps) == pytest.approx({"step": 50e-6})


def test_short_gaps_are_summed_apart():
    ev = [(SLICE, False, 0.0, 100.0),
          ("flash_decode_tc_kernel", True, 0.0, 48.0),
          ("paged_decode_tc_kernel", True, 50.0, 100.0)]
    t = reduce_events(ev, CLASSES, gap_floor_us=20.0)
    assert dict(t.gaps) == pytest.approx({"gaps under 20 us": 2e-6})


@pytest.mark.parametrize("name,cls", [
    ("flash_attention_tc_kernel", "attention"),
    ("paged_decode_tc_kernel", "attention"),
    ("paged_prefill_tc_kernel", "attention"),
    ("pytorch_flash::flash_fwd_kernel", "attention"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "gemm"),
    ("Memcpy DtoH (Device -> Pinned)", "copies"),
    ("void at::native::reduce_kernel<512, 1>", "pytorch"),
])
def test_kernel_classes(name, cls):
    assert classify(name, CLASSES) == cls
