"""The trinity-mini cell's files: its readers on a made-up traced run,
and the expert FLOPs they count."""

import json

import pytest

from portbench import lm_harness, manifest, tracing

CELL = "trinity-mini.train-8x4096"


def model_and_reference():
    model = json.loads((manifest.HERE / "configs" / "trinity-mini.json"
                        ).read_text())["model"]
    return model, manifest.load_module(manifest.HERE / "reference" /
                                       "lm_afmoe.py")


def run_data(ops, flops=None):
    if flops is None:
        model, arch = model_and_reference()
        flops = 10 * arch.step_flops(model, 8, 4096)
    return lm_harness.RunData(
        window_s=50.0, steps=10, sequences=80, tokens=80 * 4096,
        flops=flops, window_peak_bytes=1, device_ops=ops, busy_s=49.0)


def test_the_cell_loads_with_its_readers():
    cell = manifest.load_cell(CELL)
    assert manifest.runner(cell) is lm_harness
    names = {m["name"] for m in cell.per_layer}
    assert names == {"lm_train_mfu", "moe_gmm_roofline",
                     "moe_gmm_ms_per_step", "device_idle_pct",
                     "peak_mem_gib"}
    assert set(cell.limits) <= set(lm_harness.NUMBERS)


def test_readers_read_kernel_2_5_and_nothing_without_it():
    gmm = [tracing.DeviceOp("(anonymous namespace)::gmm_wgmma_kernel(x)",
                            i * 10 ** 8, i * 10 ** 8 + 5 * 10 ** 6)
           for i in range(10)]
    other = [tracing.DeviceOp("sm90_xmma_gemm_bf16", 0, 10 ** 9)]
    read = {n: manifest.reader(n) for n in
            ("lm_train_mfu", "moe_gmm_roofline", "moe_gmm_ms_per_step")}
    run = run_data(gmm + other)
    assert read["moe_gmm_ms_per_step"](run) == 5.0
    model, arch = model_and_reference()
    flops = arch.expert_flops(model, 8, 4096)
    assert read["moe_gmm_roofline"](run) == 100.0 * flops * 10 / 0.05 \
        / run.peak_flops
    assert read["lm_train_mfu"](run) == 100.0 * run.flops / 50.0 \
        / run.peak_flops
    empty = run_data(other)
    assert read["moe_gmm_roofline"](empty) is None
    assert read["moe_gmm_ms_per_step"](empty) is None


def test_expert_flops_count_the_held_picks():
    model = json.loads((manifest.HERE / "configs" / "trinity-mini.json"
                        ).read_text())["model"]
    arch = manifest.load_module(manifest.HERE / "reference" / "lm_afmoe.py")
    picks = 8 * 4096 * 8 * 16 // 128
    assert arch.expected_picks(model, 8 * 4096) == picks == 32768
    per_forward = 2 * 3 * 2048 * 1024 * picks
    assert arch.expert_flops(model, 8, 4096) == 4 * 6 * per_forward
    assert arch.expert_flops(model, 8, 4096, remat=False) == \
        3 * 6 * per_forward


def test_roofline_refuses_another_models_step():
    """The roofline counts trinity-mini's experts: a run whose step FLOPs
    are another model's raises rather than read a wrong share."""
    gmm = [tracing.DeviceOp("gmm_wgmma_kernel", 0, 5 * 10 ** 6)]
    read = manifest.reader("moe_gmm_roofline")
    with pytest.raises(ValueError, match="another model"):
        read(run_data(gmm, flops=10 ** 15))
    assert read(run_data([], flops=10 ** 15)) is None


def test_the_cell_reads_the_devices_idle_share_and_peak():
    """The LM cell is on the device readers' lists, and they read its
    traced run."""
    cell = manifest.load_cell(CELL)
    spec = json.loads((manifest.HERE.parent / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in spec["per_layer"]
              if CELL in m.get("workloads", ())}
    assert {"device_idle_pct", "peak_mem_gib"} <= listed
    run = run_data([tracing.DeviceOp("gmm_wgmma_kernel", 0, 10 ** 9)])
    assert manifest.reader("device_idle_pct", cell.base)(run) == \
        pytest.approx(2.0)
    assert manifest.reader("peak_mem_gib", cell.base)(run) == 2 ** -30
