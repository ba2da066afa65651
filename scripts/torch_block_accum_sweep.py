#!/usr/bin/env python3
"""Kernels B and C of the PyTorch port at several compile-time shapes.

    python3 scripts/torch_block_accum_sweep.py [--configs NW=8 NW=4,NB=2]
                                               [--baseline FILE]

Each config overrides some of the shape constants of
``noetic_slam_tpu_torch/csrc/block_accum.cu`` (``NW`` warps per CTA, ``NB``
tiles a warp loads at once, ``SHORT`` samples one warp takes alone); the
others keep their values in the source. For each config the script writes a
copy of the source with those values into ``build/torch_block_accum_sweep/``
and builds it there (nvcc, sm_90a). ``--baseline`` adds one more build, of
another ``block_accum.cu`` with the same C interface (for example an older
tree's), timed the same way.

For each build it checks kernels B and C against their plain versions on
the streams of ``chip_smoke.py``'s phases 4 and 5 (one scan at the
production shapes, clamped; within ``chip_smoke.TOL``), and times each
kernel and one ``index_add_`` of the same stream in turns, hot and cold,
with ``chip_smoke._turns``. It also times each kernel with every entry
empty (the launch and the entry reads alone), with every entry cut to 384
samples, with only the entries longer than that, and on the same stream as
one entry that holds all of it (every sample in one row, the longest chain
a call can have), and prints that one's largest difference from the plain
version (sums of ~10^5 samples in other orders, so not held to the
tolerance). One line per kernel and build, then one JSON line. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SOURCE = os.path.join(ROOT, "noetic_slam_tpu_torch", "csrc", "block_accum.cu")
OUT_DIR = os.path.join(ROOT, "build", "torch_block_accum_sweep")
LAUNCHES = ("nst_tsdf_accum_launch", "nst_logodds_accum_launch")
CUT = 384        # the cut streams' entry limit


def _variant(tag: str, text: str):
    """``text`` (a block_accum.cu) built into its own library under
    OUT_DIR; returns it with the two launch functions bound."""
    from noetic_slam_tpu_torch.ops.cuda import _build

    d = os.path.join(OUT_DIR, tag)
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "block_accum.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(d, "libblock_accum.so")
    _build.compile_library([src], out)
    return _build.open_library(out, LAUNCHES)


def _patched(config: str) -> str:
    """The source with the constants of ``config`` (``NAME=V,...``)."""
    with open(SOURCE) as f:
        text = f.read()
    for kv in config.split(","):
        name, value = kv.split("=")
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise SystemExit(f"no constant {name} in {SOURCE}")
    return text


def _kernels(lib):
    """(kernel B, kernel C) of ``lib``, with the wrappers' arguments."""
    import torch

    from noetic_slam_tpu_torch.ops.cuda import _build
    from noetic_slam_tpu_torch.ops.cuda.tsdf_kernel import NO_CLAMP

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def b(W, WS, rows, starts, cnts, ivox, w, wd, max_weight):
        nc = max_weight >= NO_CLAMP
        _build.check(lib.nst_tsdf_accum_launch(
            W.data_ptr(), WS.data_ptr(), W.shape[0], rows.data_ptr(),
            starts.data_ptr(), cnts.data_ptr(), rows.shape[0],
            ivox.data_ptr(), w.data_ptr(), wd.data_ptr(), ivox.shape[0],
            float(0.0 if nc else max_weight), int(nc), stream()), "B")

    def c(L, rows, starts, cnts, ivox, delta, l_min, l_max):
        _build.check(lib.nst_logodds_accum_launch(
            L.data_ptr(), L.shape[0], rows.data_ptr(), starts.data_ptr(),
            cnts.data_ptr(), rows.shape[0], ivox.data_ptr(),
            delta.data_ptr(), ivox.shape[0], float(l_min), float(l_max),
            stream()), "C")

    return {"block_accumulate": b, "logodds_accumulate": c}


def _operands(dev):
    """name -> (plain, runs, stream args, payload, clamp limits)."""
    from noetic_slam_tpu_torch.config import OccupancyConfig, TsdfConfig
    from noetic_slam_tpu_torch.ops.cuda import logodds_kernel as lk
    from noetic_slam_tpu_torch.ops.cuda import tsdf_kernel as tk

    ocfg = OccupancyConfig()
    out = {}
    for name, plain, problem, limits, seed in (
            ("block_accumulate", tk.block_accumulate_plain, cs.tsdf_problem,
             (TsdfConfig().max_weight,), 1),
            ("logodds_accumulate", lk.logodds_accumulate_plain,
             cs.logodds_problem, (ocfg.l_min, ocfg.l_max), 2)):
        r, args, pay = problem(dev, np.random.default_rng(seed), 1.0)
        out[name] = (plain, r, args, pay, limits)
    return out


def _max_err(kernel, plain, pay, args, limits):
    """(max |kernel - plain|, whether it is within chip_smoke's TOL)."""
    import torch

    got = [p.clone() for p in pay]
    kernel(*got, *args, *limits)
    want = [p.clone() for p in pay]
    plain(*want, *args, *limits)
    torch.cuda.synchronize()
    ok = all(bool(torch.isclose(a, b, rtol=cs.TOL, atol=cs.TOL).all())
             for a, b in zip(got, want))
    return max(float((a - b).abs().max()) for a, b in zip(got, want)), ok


def _measure(tag, kernel, plain, r, sargs, pay, limits, dev):
    import torch

    err, ok = _max_err(kernel, plain, pay, sargs, limits)
    if not ok:
        raise SystemExit(f"{tag}: max |d| {err}")
    flat, spos = cs._stream_addresses(r, sargs[3])
    vals = torch.stack([c[spos] for c in sargs[4:]], dim=1)
    lib_pay = torch.zeros((pay[0].numel(), vals.shape[1]), device=dev)
    work = [p.clone() for p in pay]
    t = cs._turns(lambda: kernel(*work, *sargs, *limits),
                  lambda: lib_pay.index_add_(0, flat, vals))
    # the whole stream as one entry of row 0
    S = sargs[3].shape[0]
    one = [torch.zeros(1, dtype=torch.int32, device=dev),
           torch.zeros(1, dtype=torch.int32, device=dev),
           torch.full((1,), S, dtype=torch.int32, device=dev)]
    whole = (*one, *sargs[3:])
    whole_err, _ = _max_err(kernel, plain, pay, whole, limits)
    whole_ms = cs._time_ms(lambda: kernel(*work, *whole, *limits), 10)
    # the same entries empty, cut to CUT samples, and only the long ones
    cnts = sargs[2]
    part = {}
    for label, c in (("empty_ms", torch.zeros_like(cnts)),
                     ("short_ms", torch.clamp(cnts, max=CUT)),
                     ("long_ms", torch.where(cnts > CUT, cnts, 0))):
        cut = (*sargs[:2], c, *sargs[3:])
        part[label] = cs._time_ms(lambda: kernel(*work, *cut, *limits), 20)
    return {"max_abs_err": err, "largest": int(r.cnts.max()),
            "whole_stream_samples": S, "whole_ms": whole_ms,
            "whole_max_abs_err": whole_err, **part, **t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+",
                    default=["NW=8", "NW=4", "NW=16", "NB=2", "SHORT=256",
                             "SHORT=512"])
    ap.add_argument("--baseline", metavar="FILE",
                    help="another block_accum.cu, timed beside the configs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_block_accum_sweep: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}", flush=True)
    builds = [(c, _patched(c)) for c in args.configs]
    if args.baseline:
        with open(args.baseline) as f:
            builds.append(("baseline", f.read()))
    ops = _operands(dev)
    rows = []
    for i, (config, text) in enumerate(builds):
        kernels = _kernels(_variant(f"v{i}", text))
        for name, (plain, r, sargs, pay, limits) in ops.items():
            row = {"name": name, "config": config,
                   **_measure(f"{name} at {config}", kernels[name], plain, r,
                              sargs, pay, limits, dev)}
            rows.append(row)
            print(f"{name} {config}: kernel {row['ms']:.4f} ms hot / "
                  f"{row['ms_cold']:.4f} cold, index_add_ "
                  f"{row['library_ms']:.4f} / {row['library_ms_cold']:.4f}; "
                  f"entries empty / cut to {CUT} / long only "
                  f"{row['empty_ms']:.4f} / {row['short_ms']:.4f} / "
                  f"{row['long_ms']:.4f} (turns hot "
                  f"{[round(x, 4) for x in row['turns']]}, cold "
                  f"{[round(x, 4) for x in row['cold_turns']]}); largest "
                  f"{row['largest']} samples; whole stream "
                  f"({row['whole_stream_samples']} samples) "
                  f"{row['whole_ms']:.4f} ms; max |d| "
                  f"{row['max_abs_err']:.3e} / {row['whole_max_abs_err']:.3e}",
                  flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
