"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``traffic/<name>.json``), its limits
(``limits/<cell>.json``), the readers of its metrics
(``metrics/<metric>.py``, each with ``read(record) -> float | None``) and
the map comparison of its configuration's map backend
(``maps/<dlio.map_backend>.py``, with ``capture``, ``numbers``,
``control`` and ``jump_m``). A later cell, configuration, mix, metric or
map backend is a new file and a new entry, and no edit here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
MAPS_DIR = os.path.join(BENCH_DIR, "maps")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as loaded
    traffic: dict         # the traffic file, as loaded
    limits: dict          # number compared -> limit
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_benchmark(repo: str = REPO) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def find_cell(name: str, bench: dict | None = None,
              repo: str = REPO) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises KeyError if none,
    and FileNotFoundError if its configuration's map backend has no
    module (before a card is asked for or a system is built)."""
    bench = bench or load_benchmark(repo)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    confs = {c["name"]: c for c in bench["configs"]}
    config = _json(repo, confs[w["config"]]["file"])
    map_module(config["dlio"]["map_backend"])
    traffic = _json(BENCH_DIR, "traffic", f"{w['traffic']}.json")
    limits = _json(BENCH_DIR, "limits", f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if _applies({**m, "moves": None}, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    return _load(path, "benchmark_metric_"
                 + metric.replace(".", "_").replace("-", "_")).read


def map_module(backend: str):
    """``maps/<backend>.py``, the map comparison of a configuration whose
    ``dlio.map_backend`` is ``backend``."""
    path = os.path.join(MAPS_DIR, f"{backend}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"map backend {backend!r} has no comparison: {path} is missing")
    return _load(path, "benchmark_map_" + backend)
