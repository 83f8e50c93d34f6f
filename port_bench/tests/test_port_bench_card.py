"""On the card: the tiny cells run through the whole harness, timed and
traced, and the traced run reads the per-layer metrics from the device
trace. The tiny cells are float32, where cuDNN's convolutions may take
TF32, so their numbers are held to TF32's rounding here, not to the CPU's.

    python -m pytest port_bench/tests -m cuda -q    (on the card)
"""
import pytest

from port_bench.tests.helpers import run_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_bulk", "tiny_camera", "tiny_train"])
def test_tiny_cells_run_timed_and_traced_on_the_card(card, tiny_bench, cell):
    rc, res, _, err = run_cell(tiny_bench, cell, device=None, seconds=1.0)
    assert rc == 0, err
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    assert all(c["value"] < 1e-2 for c in res["checks"].values()), res["checks"]
    rc, res, lines, err = run_cell(tiny_bench, cell, device=None, trace=1)
    assert rc == 0, err
    kind = "train" if cell == "tiny_train" else "infer"
    unit = "step.train" if kind == "train" else "batch.infer"
    want = {f"mfu.{kind}", f"glue_share.{kind}", f"device_idle_share.{kind}", f"peak_mem_gib.{kind}",
            f"device_s_per_{unit}"}
    assert want <= set(res["metrics"]), res["metrics"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert 0 < res["metrics"][f"mfu.{kind}"]["value"] < 100
    assert res["breakdown"]["device_ops"] and len(res["breakdown"]["idle_gaps"]) <= 10
