"""The reductions from traces and counts to metrics, on hand-made inputs:
the busy time as a union of intervals, the idle gaps and their labels,
the roofline, MFU, glue and idle shares, the FLOP counter and the
attention calls of a UNet forward."""
import pytest
import torch
import torch.nn.functional as F

from port_bench import harness, readers
from port_bench.trace import TraceSummary, label_gaps, union_seconds
from port_bench.work import attention, flops

PEAKS = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}


def summary(**kw):
    base = dict(window_s=1.0, busy_s=0.5, device_s_by_name={}, device_s_by_class={}, gaps=[], units=1)
    base.update(kw)
    return TraceSummary(**base)


def test_busy_time_is_the_union_of_overlapping_intervals():
    busy, gaps = union_seconds([(0, 10), (5, 15), (20, 30), (25, 27), (29, 40)])
    assert busy == pytest.approx(35e-9)  # [0, 15) and [20, 40), not the 41 ns of the sum
    assert gaps == [(15, 20)]
    assert union_seconds([]) == (0.0, [])


def test_gaps_are_labelled_by_the_device_work_around_them():
    events = [(0, 10, "void ns::a_kernel<1, 2>(int)"), (20, 30, "b_kernel(float*)"), (35, 40, "Memcpy HtoD"),
              (5, 8, "c_kernel")]
    labels = label_gaps([(10, 20), (30, 35)], events)
    assert labels == [("after ns::a_kernel / before b_kernel", pytest.approx(10e-9)),
                      ("after b_kernel / before Memcpy HtoD", pytest.approx(5e-9))]


def test_roofline_mfu_glue_and_idle_shares_by_hand():
    call = (2, 4096, 8, 40)
    ops, nbytes, exps = attention.forward_work(call)
    assert ops == 4 * 2 * 8 * 4096 * 4096 * 40 and nbytes == 4 * 2 * 4096 * 8 * 40 * 2 and exps == 2 * 8 * 4096 ** 2
    least = max(ops / 1e12, nbytes / 1e9)  # operations bind here
    ctx = {"work": {"model_flops": 3e11, "kernels": {"attention_forward": [((ops, nbytes, exps), 3)]}},
           "trace": summary(device_s_by_class={"attention_forward": 4 * least, "elementwise": 1.0, "norm": 0.5,
                                               "conv": 2.5}, busy_s=0.75, window_s=1.5),
           "peaks": PEAKS, "window_s": 1.5, "peak_bytes": 3 * 2**30}
    assert readers.roofline(ctx, ("attention_forward",)) == pytest.approx(75.0)
    assert readers.mfu(ctx) == pytest.approx(20.0)
    total = 4 * least + 4.0
    assert readers.glue_share(ctx) == pytest.approx(100 * 1.5 / total)
    assert readers.idle_share(ctx) == pytest.approx(50.0)
    assert readers.peak_gib(ctx) == 3.0
    assert readers.device_s_per_unit(dict(ctx, trace=summary(busy_s=6.0, units=4))) == 1.5
    # nothing to read: no number, never 0
    empty = dict(ctx, work={}, trace=summary(device_s_by_class={}, busy_s=0.0))
    assert readers.roofline(empty, ("attention_forward",)) is None and readers.mfu(empty) is None
    assert readers.glue_share(empty) is None and readers.idle_share(empty) is None


def test_flop_counter_counts_a_toy_conv_and_matmul():
    m = torch.device("meta")
    x, w = torch.empty(2, 3, 8, 8, device=m), torch.empty(5, 3, 3, 3, device=m)
    assert flops.count(lambda: F.conv2d(x, w, padding=1)) == 2 * 2 * 5 * 8 * 8 * 3 * 3 * 3
    a, b = torch.empty(4, 6, device=m), torch.empty(6, 7, device=m)
    assert flops.count(lambda: a @ b) == 2 * 4 * 6 * 7
    q = torch.empty(1, 16, 8, device=m)
    from port_bench.reference.nn import attention as plain

    assert flops.count(lambda: plain(q, q, q, heads=2)) == 4 * 1 * 2 * 16 * 16 * 4


def test_flagship_unet_forward_makes_the_flash_calls_the_program_counts():
    cell = harness.find_cell("flagship_ddim50_b8")
    calls = attention.unet_calls(cell.arch, 32)
    # 5 transformers at 4096 and 5 at 1024 tokens, each a self- and two
    # cross-modal attentions: 30 a forward, 1500 a DDIM-50 batch
    assert len(calls) == 30
    assert calls[:3] == [(32, 4096, 8, 40), (16, 4096, 8, 40), (16, 4096, 8, 40)]
    assert {c[1:] for c in calls} == {(4096, 8, 40), (1024, 8, 80)}
    cam = harness.find_cell("camera_only_ddim50_b64")
    assert attention.unet_calls(cam.arch, 128) == [(128, 1024, 8, 40)] * 5
