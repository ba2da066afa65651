"""The harness's lookup by name, its statistics, its JAX check and its
refusal to measure without a card (CPU)."""

import copy
import json
import os
import re
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from benchmark import run  # noqa: E402
from benchmark.harness import check, spec, stats  # noqa: E402

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
# numbers of check.compare that every backend has; the rest are the map's
POSE_NUMBERS = {"missing_poses", "lost_keyframes", "pose_err_m",
                "pose_jumps", "ate_m"}


@pytest.mark.parametrize("cell", CELLS)
def test_cells_found_by_name(cell):
    c = spec.find_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["mode"] in ("replay", "live")
    assert set(c.limits) >= {"missing_poses", "lost_keyframes"}
    assert set(c.limits) - POSE_NUMBERS          # the map is compared
    assert c.limits["missing_poses"] == 0 == c.limits["lost_keyframes"]
    assert c.config["name"] == w["config"]
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    maps = spec.map_module(c.config["dlio"]["map_backend"])
    for f in ("capture", "numbers", "control", "jump_m"):
        assert callable(getattr(maps, f)), f


def test_every_metric_and_config_has_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(
            REPO, "benchmark", "metrics", f"{m['name']}.py"))
    for c in BENCH["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        # the port loads the configuration as it is run
        from noetic_slam_tpu_torch.config.params import load_config
        load_config(overrides=conf["dlio"])


def test_walk_replay_drives_the_live_cells_walk():
    """Both walk cells make the same path and scene from a seed."""
    mixes = {}
    for name in ("walk", "walk_replay"):
        with open(os.path.join(REPO, "benchmark", "traffic",
                               f"{name}.json")) as f:
            mixes[name] = json.load(f)
    for key in ("path", "scene"):
        assert mixes["walk_replay"][key] == mixes["walk"][key], key
    assert mixes["walk_replay"]["mode"] == "replay"
    assert mixes["walk_replay"]["batch"] == 8


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no.such.cell")


def test_map_backend_without_module_fails_at_find_cell(tmp_path,
                                                       monkeypatch):
    """A configuration whose map backend has no ``maps/<backend>.py``
    fails where the cell is found, naming the file, before ``run.main``
    asks for a card."""
    bench = copy.deepcopy(BENCH)
    conf = bench["configs"][0]
    with open(os.path.join(REPO, conf["file"])) as f:
        body = json.load(f)
    body["dlio"]["map_backend"] = "occupancy"
    path = tmp_path / "occupancy_config.json"
    path.write_text(json.dumps(body))
    conf["file"] = str(path)
    cell = next(w["name"] for w in bench["workloads"]
                if w["config"] == conf["name"])
    missing = re.escape(os.path.join("benchmark", "maps", "occupancy.py"))
    with pytest.raises(FileNotFoundError, match=missing):
        spec.find_cell(cell, bench)

    def no_card(n):
        raise AssertionError("a card was asked for")

    monkeypatch.setattr(spec, "load_benchmark", lambda repo=None: bench)
    monkeypatch.setattr(run, "require_cards", no_card)
    with pytest.raises(FileNotFoundError, match=missing):
        run.main(["--workload", cell, "--seed", "1", "--seconds", "1"])


def test_a_limited_number_missing_is_not_correct():
    limits = {"missing_poses": 0, "map_block_gap": 0.0045}
    assert check.judge({"missing_poses": 0, "map_block_gap": 0.001},
                       limits)[1]
    checks, ok = check.judge({"missing_poses": 0, "occupied": 5.0}, limits)
    assert not ok and set(checks) == {"missing_poses"}


def test_window_rate_counts_a_stall():
    """100 scans at 10 ms each and one stall of 4 s: the whole-window rate
    is 100 / 5 s; a median of per-chunk slopes would read 100 scans/s."""
    gaps = [0.01] * 100
    gaps[50] += 4.0
    assert stats.window_rate(100, sum(gaps)) == pytest.approx(20.0)
    chunk = [sum(gaps[i:i + 10]) for i in range(0, 100, 10)]
    assert sorted(10 / c for c in chunk)[5] == pytest.approx(100.0)


def test_p95_over_every_scan_with_a_stall():
    lat = [0.05] * 95 + [0.5] * 4 + [4.0]
    assert stats.p95(lat) == 0.05
    lat = [0.05] * 94 + [0.5] * 5 + [4.0]
    assert stats.p95(lat) == 0.5
    assert stats.p95([0.07]) == 0.07
    with pytest.raises(ValueError):
        stats.p95([])


def test_jax_check_compares_whole_top_level_names():
    mods = ["noetic_slam_tpu_torch", "noetic_slam_tpu_torch.ops.gicp",
            "numpy", "jaxtyping", "flaxen"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["jax.numpy", "noetic_slam_tpu.ops",
                                         "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "noetic_slam_tpu"]


def test_nothing_loaded_imports_jax():
    """A fresh process that loads the harness, the reference, every
    configuration's map comparison and the system under test holds no JAX
    module."""
    import subprocess

    backends = sorted({spec.find_cell(c).config["dlio"]["map_backend"]
                       for c in CELLS})
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.run as r, benchmark.harness.runner, "
            "benchmark.harness.check, benchmark.gen.producer, "
            "noetic_slam_tpu_torch.runtime.slam, "
            "noetic_slam_tpu_torch.io.replay; "
            "from benchmark.harness import spec; "
            "[spec.map_module(b) for b in %r]; "
            "print(r.forbidden_modules(sys.modules))"
            % (REPO, backends))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", str(2 ** 31 + 3),
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_too_few_cards_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                  "--trace", "1"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""
