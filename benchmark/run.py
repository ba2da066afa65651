"""The benchmark of ``noetic_slam_tpu_torch`` on one NVIDIA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted`` (scans handed over in the window), ``failed`` (scans with no
pose and keyframes the sync lost), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, also the last lines of standard error. Without a card, or
with fewer cards than the cell asks for, it exits 2 and prints no result.

``--control ref_tf32`` also prints the control's numbers: the reference
put in the program's place and worked out in TF32, the precision below
the float32 (TF32 off) that the port computes in. ``--control tf32`` runs
the program itself with TF32 switched on, a second witness. The
benchmark's own runs use neither.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "noetic_slam_tpu")


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    one thread a math library, so that the host thread that drives the
    program shares its cores with as little as possible."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    root = os.path.join(REPO, "benchmark", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(root, sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules) -> list:
    """Top-level names of ``modules`` that are JAX or the JAX package,
    compared whole (``noetic_slam_tpu_torch`` is not ``noetic_slam_tpu``)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "ref_tf32"), default=None)
    return p.parse_args(argv)


def require_cards(n: int) -> None:
    """Raises SystemExit(2) unless ``n`` cards are there: the measurement
    has no CPU fallback."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {n} CUDA card(s), found {have}",
              file=sys.stderr)
        raise SystemExit(2)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    sys.path.insert(0, REPO)
    from benchmark.harness import check, spec
    from benchmark.harness.trace import breakdown

    cell = spec.find_cell(args.workload)
    require_cards(cell.chips)
    import torch

    torch.set_num_threads(1)
    import noetic_slam_tpu_torch  # noqa: F401  (the system under test)
    from benchmark.harness import runner

    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    seed = args.seed % (1 << 63)
    rec = runner.run(cell.config, cell.traffic, seed, args.seconds,
                     bool(args.trace), torch.device("cuda"), T_START)

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    if args.trace and rec.trace and rec.trace.get("busy_s") is not None:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]

    # everything else, on earlier lines of standard error
    step_ms = 1e3 * rec.window_s / max(rec.scans, 1)
    print(f"run: {cell.name} seed {args.seed} window {rec.window_s:.3f} s, "
          f"{rec.scans} scans ({step_ms:.2f} ms a scan), set-up "
          f"{rec.setup_s:.2f} s; generator {rec.gen_ms_per_scan:.2f} ms a "
          f"scan on the host thread; peak memory {rec.memory_peak_bytes}",
          file=sys.stderr)
    print("counters over the window: " + json.dumps(rec.counters),
          file=sys.stderr)
    print("host spans over the window [s]: " + json.dumps(rec.spans),
          file=sys.stderr)
    print("totals: " + json.dumps(rec.extra), file=sys.stderr)
    if rec.trace is not None:
        print("trace: " + json.dumps({k: rec.trace[k] for k in (
            "window_s", "busy_s", "scans", "activity_kinds")}),
              file=sys.stderr)

    t_ref = time.perf_counter()
    numbers, err = check.compare(rec, cell.traffic["checks"])
    shown = {k: v for k, v in numbers.items() if k not in cell.limits}
    shown["pose_err_max_m"] = float(err.max()) if len(err) else None
    print("not compared: " + json.dumps(shown), file=sys.stderr)
    if args.control == "ref_tf32":
        ctl = check.control(rec, cell.traffic["checks"])
        print("control: " + json.dumps(ctl) + "; correct: "
              + json.dumps(check.judge({**numbers, **ctl}, cell.limits)[1]),
              file=sys.stderr)
    print(f"comparison: {time.perf_counter() - t_ref:.2f} s",
          file=sys.stderr)
    checks, correct = check.judge(numbers, cell.limits)

    bad = forbidden_modules(sys.modules)
    if bad:
        print("benchmark: JAX or the JAX package was loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": rec.scans,
              "failed": int(numbers["missing_poses"]
                            + numbers["lost_keyframes"]),
              "metrics": metrics, "device": device}
    if args.trace and rec.trace is not None and rec.trace.get("kernels"):
        result["breakdown"] = breakdown(rec.trace)
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
