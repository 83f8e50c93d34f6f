"""Cells, configurations, traffic mixes, limits, per-layer readers and
kernel classes are files found by name, and a new one is picked up
without an edit of any file already there."""
import json

from port_bench import harness
from port_bench.trace import classify


def test_every_cell_of_the_benchmark_finds_its_files():
    spec = harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.config["dtype"] in ("bfloat16", "float32")
        gen = harness.generator(cell)
        for fn in ("prepare", "window", "work", "check", "readings"):
            assert callable(getattr(gen, fn))
        for m in cell.per_layer:
            assert callable(harness.metric_reader(cell, m["name"]).read)
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    names = [c for c, _ in harness.kernel_classes()]
    assert names[:3] == ["attention_forward_tav", "attention_forward", "attention_backward"]


def test_new_files_are_picked_up_without_an_edit(tiny_bench):
    root = tiny_bench.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    # a configuration, a traffic mix, a cell's limits, a per-layer metric,
    # a kernel class and one more file of an existing class, each new
    cfg = json.loads((tiny_bench / "configs" / "tiny_mobi.json").read_text())
    cfg["model"]["unet_num_heads"] = 4
    (tiny_bench / "configs" / "tiny_mobi_h4.json").write_text(json.dumps(cfg))
    (tiny_bench / "traffic" / "tiny_bulk_b3.json").write_text(json.dumps(
        {"generator": "bulk_inference", "pairs": 3, "num_steps": 2, "guidance_scale": 3.0,
         "check_pairs": 1, "trace_units": 1}))
    (tiny_bench / "limits" / "new_cell.json").write_text(json.dumps({"limits": {"camera_rel_l2": 0.5}}))
    (tiny_bench / "metrics" / "answer.new.py").write_text("def read(ctx):\n    return 42.0\n")
    (tiny_bench / "kernels" / "new_class").mkdir()
    (tiny_bench / "kernels" / "new_class" / "a.json").write_text(json.dumps({"priority": 5, "patterns": ["foo_"]}))
    (tiny_bench / "kernels" / "attention_forward" / "next.json").write_text(
        json.dumps({"priority": 20, "patterns": ["my_attention_kernel"]}))
    spec["configs"].append({"name": "tiny_mobi_h4", "source": "test", "file": "port_bench/configs/tiny_mobi_h4.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "new_cell", "config": "tiny_mobi_h4", "traffic": "tiny_bulk_b3", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "answer.new", "unit": "%", "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "inpaints_per_hour", "workloads": ["new_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell("new_cell", tiny_bench)
    assert cell.arch["unet_num_heads"] == 4 and cell.mix["pairs"] == 3 and cell.limits == {"camera_rel_l2": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["answer.new"]
    assert harness.metric_reader(cell, "answer.new").read({}) == 42.0
    classes = harness.kernel_classes(tiny_bench)
    assert classes[0] == ("new_class", ["foo_"])
    of = classify(["void my_attention_kernel<8>(...)", "foo_bar", "flash_fwd_sm90_kernel<48, 48, false>"], classes)
    assert of == {"void my_attention_kernel<8>(...)": "attention_forward", "foo_bar": "new_class",
                  "flash_fwd_sm90_kernel<48, 48, false>": "attention_forward"}


def test_kernel_classes_follow_priority_not_folder_order():
    of = classify(["flash_fwd_sm90_kernel<48, 48, true>(x)", "flash_fwd_sm90_kernel<48, 48, false>(x)",
                   "flash_bwd_dkv_sm90_kernel<48>", "gn_silu_cluster_smem_kernel", "sm90_xmma_fprop_implicit_gemm",
                   "nvjet_tst_128x256", "vectorized_elementwise_kernel<4>", "at::native::reduce_kernel",
                   "Memcpy HtoD (Pageable -> Device)"], harness.kernel_classes())
    assert list(of.values()) == ["attention_forward_tav", "attention_forward", "attention_backward",
                                 "groupnorm_silu", "conv", "matmul", "elementwise", "norm", "other"]
