"""The port's benchmark (``noetic_slam_tpu_torch.bench``, ``cli bench``) and
its measurement helpers (``runtime.profiling``) on the CPU.

The port's tiny run (``BENCH_TINY=1``) must print root bench.py's JSON
schema plus ``backend``, ``device``, ``power_limit_w`` and
``host_syncs_per_scan``. Root bench.py's whole tiny run takes ~4 min on one
core (most of it compiles), beyond this file's budget, so the schema's
keys are taken from bench.py:437-455 (and the sections' keys it merges in,
:226-231, :253, :344-351); its odometry section alone (the other sections
skipped with its own BENCH_SKIP_* knobs, ~1 min) gives the values held:
the synthetic ATE and the submap overflow."""

import json
import types

import numpy as np
import pytest
import torch

import bench as jax_bench
from noetic_slam_tpu.runtime import profiling as jprofiling
from noetic_slam_tpu_torch import bench, cli
from noetic_slam_tpu_torch.runtime import profiling

torch.set_num_threads(1)

TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "extras"}
# bench.py:439-455, with the online (:226-231), fused (:253) and system
# (:344-351) sections; roofline (:447) and the MulRan ATE's value are not
# in a tiny run
JAX_EXTRAS = {
    "vs_baseline_semantics", "tsdf_integrations_per_sec",
    "ate_rmse_m_synthetic", "ate_rmse_m_mulran_fixture", "submap_overflow",
    "online_scans_per_sec_k1", "online_latency_ms_p50",
    "online_latency_ms_p95", "online_latency_includes_fetch",
    "slam_fused_scans_per_sec", "slam_system_scans_per_sec",
    "slam_system_includes", "slam_system_closures",
    "slam_system_lost_keyframes", "slam_system_raced_attempts"}
PORT_EXTRAS = {"backend", "device", "power_limit_w", "host_syncs_per_scan"}
ATE_GAP = 0.02       # [m] port vs JAX on the tiny replay
ATE_MAX = 0.05       # [m] tests/test_odometry_e2e.py


def _json_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def port_tiny():
    """The port's whole tiny run on the CPU, through ``cli bench``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BENCH_TINY", "1")
    seen = {}
    real = bench.main

    def keep(*a, **kw):
        seen["result"] = real(*a, **kw)
        seen["kwargs"] = kw
        return seen["result"]

    mp.setattr(bench, "main", keep)
    try:
        assert cli.main(["bench", "--device", "cpu"]) == 0
    finally:
        mp.undo()
    return seen


def test_port_bench_schema(port_tiny, capsys):
    r = port_tiny["result"]
    assert port_tiny["kwargs"] == {"device": "cpu"}
    assert set(r) == TOP_KEYS
    assert set(r["extras"]) == JAX_EXTRAS | PORT_EXTRAS
    assert r["metric"] == "odometry_scans_per_sec_1chip"
    assert r["unit"] == "scans/s"
    assert abs(r["vs_baseline"] - r["value"] / 10.0) <= 1e-3
    ex = r["extras"]
    assert ex["backend"] == "torch-cpu" and ex["device"] == "cpu"
    assert ex["power_limit_w"] is None
    assert set(ex["host_syncs_per_scan"]) == {
        "odometry_k8", "online_k1", "slam_fused", "slam_system"}
    # the step reads the host >= 2 times a registered scan (ROADMAP Queue 3)
    assert all(v >= 2 for v in ex["host_syncs_per_scan"].values())
    assert ex["ate_rmse_m_mulran_fixture"] is None      # skipped when tiny
    assert ex["slam_system_lost_keyframes"] == 0
    assert ex["submap_overflow"] == 0
    assert ex["ate_rmse_m_synthetic"] < ATE_MAX


def test_port_bench_against_root_bench(port_tiny, monkeypatch, capsys):
    """Root bench.py's odometry section at BENCH_TINY=1 (the other
    sections skipped): the same ATE within ATE_GAP, the same overflow."""
    monkeypatch.setenv("BENCH_TINY", "1")
    for s in ("ONLINE", "SLAM", "SYSTEM"):
        monkeypatch.setenv(f"BENCH_SKIP_{s}", "1")
    capsys.readouterr()
    jax_bench.main()
    jr = _json_line(capsys.readouterr().out)
    assert set(jr) == TOP_KEYS
    assert set(jr["extras"]) <= JAX_EXTRAS
    ex, jex = port_tiny["result"]["extras"], jr["extras"]
    assert abs(ex["ate_rmse_m_synthetic"]
               - jex["ate_rmse_m_synthetic"]) < ATE_GAP
    assert jex["ate_rmse_m_synthetic"] < ATE_MAX
    assert ex["submap_overflow"] == jex["submap_overflow"]


def test_bench_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])


def test_slope_timer_on_a_fake_clock(monkeypatch):
    """Per-op seconds = the slope between the two timed windows; the
    warm-up window and a fixed per-window cost drop out."""
    clock = {"t": 0.0}
    windows = []

    def run_window(k):
        windows.append(k)
        clock["t"] += 5.0 + 0.25 * k      # fixed fetch cost + 0.25 s/op
        if k == 1:
            clock["t"] += 100.0           # first call: build, warm-up

    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock["t"]))
    assert profiling.slope_timer(run_window, n1=4, n2=12) == 0.25
    assert windows == [1, 4, 12]
    with pytest.raises(ValueError):
        profiling.slope_timer(run_window, n1=3, n2=3)


@pytest.mark.parametrize("name, peaks", [
    ("NVIDIA H100 80GB HBM3", (989.0, 3350.0, 67.0)),
    ("NVIDIA H100 PCIe", (756.0, 2000.0, 51.0)),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_chip_peaks_by_card_name(monkeypatch, name, peaks):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert profiling.chip_peaks() == (peaks, name)


def test_chip_peaks_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.chip_peaks() == (None, "cpu")


@pytest.mark.parametrize("flops, nbytes", [(8.0e9, 2.0e9), (8.0e9, None),
                                           (None, 2.0e9)])
def test_roofline_report_matches_jax_format(monkeypatch, flops, nbytes):
    """JAX's line with its peak labelled as the card's f32 CUDA-core
    peak: the same numbers and layout against the same peaks."""
    name = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    monkeypatch.setattr(jprofiling, "chip_peaks",
                        lambda: ((67.0, 3350.0), name))
    port = profiling.roofline_report("nn1", 1.5e-3, flops, nbytes)
    ref = jprofiling.roofline_report("nn1", 1.5e-3, flops, nbytes)
    assert port == ref.replace("T bf16 MXU", "T f32 CUDA cores")
    if flops is not None:
        assert "of 67T f32 CUDA cores" in port
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "GPU X")
    monkeypatch.setattr(jprofiling, "chip_peaks", lambda: (None, "GPU X"))
    assert (profiling.roofline_report("nn1", 1.5e-3, flops, nbytes)
            == jprofiling.roofline_report("nn1", 1.5e-3, flops, nbytes))


def test_device_trace_runs_the_body_and_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir)) as started:
        y = torch.ones(64) * 2.0
    assert started and float(y.sum()) == 128.0
    files = list(logdir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # a profiler that cannot start (one is already running) still runs
    # the body, and says so
    with profiling.device_trace(str(tmp_path / "outer")) as outer:
        with profiling.device_trace(str(tmp_path / "inner")) as inner:
            z = np.float32(float(torch.arange(4).sum()))
    assert outer and not inner and z == 6.0
