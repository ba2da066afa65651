#!/usr/bin/env python3
"""Kernel A of the PyTorch port at several compile-time shapes.

    python3 scripts/torch_nn1_sweep.py [--configs NW=8 T_TILE=128,NW=16]
                                       [--baseline FILE]

Each config overrides some of the shape constants of
``noetic_slam_tpu_torch/csrc/nn1.cu`` (``NW`` warps per CTA, ``T_TILE``
target rows per tile, ``QPL`` queries per lane, i.e. 32 x QPL queries per
group, ``BY_BOUND`` 1 for lists sorted by bound and 0 for lists in tile
order); the others keep their values in the source. For each config the
script writes a copy of the source with those values into
``build/torch_nn1_sweep/`` and builds it there (nvcc, sm_90a).
``--sources`` adds other ``nn1.cu`` files with the same C interface as
they are; ``--baseline`` adds the build of an older ``nn1.cu``, the one-launch form
whose visit lists the wrapper built with torch (``nst_nn1_launch``: 64
queries a CTA, one thread each), driven here as that wrapper drove it.

For each build it holds the kernel to its plain version on the operands of
``chip_smoke.py``'s phase 3 (8192 queries x 262,144 targets, capped and
uncapped, two runs bitwise equal; ``chip_smoke.nn_check``) and times it and
``cdist``+``amin`` in turns, hot and cold, with ``chip_smoke._turns``, and
its two launches apart, the second also with the queries moved out of
every tile's reach (the launch, the box tests and the output alone). One line
per build, then one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SOURCE = os.path.join(ROOT, "noetic_slam_tpu_torch", "csrc", "nn1.cu")
OUT_DIR = os.path.join(ROOT, "build", "torch_nn1_sweep")
NAMES = ("nst_nn1_boxes_launch", "nst_nn1_walk_launch", "nst_nn1_tile",
         "nst_nn1_group", "nst_nn1_warps", "nst_nn1_max_rows")
OLD_Q_TILE, OLD_T_TILE = 64, 256     # the baseline's tiles


def _build_variant(tag: str, text: str) -> str:
    """``text`` (an nn1.cu) built into its own library under OUT_DIR."""
    from noetic_slam_tpu_torch.ops.cuda import _build

    d = os.path.join(OUT_DIR, tag)
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "nn1.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(d, "libnn1.so")
    _build.compile_library([src], out)
    return out


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


def _kernel(path: str):
    """(nn1, boxes, walk, shape) of a build of the present source."""
    from noetic_slam_tpu_torch.ops.cuda import _build
    from noetic_slam_tpu_torch.ops.cuda import nn_kernel as nk

    lib = _build.open_library(path, NAMES)

    def boxes(target, count):
        return nk.target_boxes(target, count, lib=lib)

    def walk(query, target, tbox, count, cap):
        return nk.walk(query, target, tbox, count, cap, lib=lib)

    def nn1(query, target, count, cap):
        return walk(query, target, boxes(target, count), count, cap)

    shape = {"tile": lib.nst_nn1_tile(), "group": lib.nst_nn1_group(),
             "warps": lib.nst_nn1_warps()}
    return nn1, boxes, walk, shape


def _baseline_kernel(path: str):
    """nn1 of the older one-launch kernel, with its torch list build and
    exact recomputation around it."""
    import torch

    from noetic_slam_tpu_torch.ops.cuda import _build
    from noetic_slam_tpu_torch.ops.cuda import nn_kernel as nk

    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nst_nn1_launch.argtypes = [P, I, P, I, P, P, P, P, P, I, I, I, P, P, P]
    lib.nst_nn1_launch.restype = I

    def nn1(query, target, count, cap):
        dev = query.device
        nq, nt = query.shape[0], target.shape[0]
        count = count.reshape(1)
        cap2 = nk._cap2(cap, dev)
        vlist, vlb, vcnt = nk.visit_lists(query, target, count, cap2,
                                          OLD_Q_TILE, OLD_T_TILE,
                                          per_query=False)
        idx = torch.empty((nq,), dtype=torch.int32, device=dev)
        d = torch.empty((nq,), dtype=torch.float32, device=dev)
        _build.check(lib.nst_nn1_launch(
            query.data_ptr(), nq, target.data_ptr(), nt, count.data_ptr(),
            cap2.data_ptr(), vlist.data_ptr(), vlb.data_ptr(),
            vcnt.data_ptr(), vlist.shape[1], OLD_Q_TILE, OLD_T_TILE,
            idx.data_ptr(), d.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "baseline nn1")
        return nk._finish(query, target, idx, d, cap2)

    return nn1


def _measure(nn1, q, tgt, count, n_live, boxes=None, walk=None):
    import torch

    row = {}
    for label, cap in (("capped", cs.NN_CAP), ("uncapped", None)):
        fk, ties, err, _ = cs.nn_check(label, nn1, q, tgt, count, cap)
        row[f"found_{label}"] = int(fk.sum())
        row[f"max_abs_err_{label}"] = err
    cap_t = torch.full((), cs.NN_CAP, device=q.device)
    row.update(cs._turns(lambda: nn1(q, tgt, count, cap_t),
                         cs.nn_library(q, tgt, n_live)))
    row["uncapped_ms"] = cs._time_ms(lambda: nn1(q, tgt, count, None), 10)
    if boxes is not None:
        tbox = boxes(tgt, count)
        row["boxes_ms"] = cs._time_ms(lambda: boxes(tgt, count), 20)
        row["walk_ms"] = cs._time_ms(
            lambda: walk(q, tgt, tbox, count, cap_t), 20)
        q_far = q + cs.NO_WALK_SHIFT
        row["no_walk_ms"] = cs._time_ms(
            lambda: walk(q_far, tgt, tbox, count, cap_t), 20)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+",
                    default=["NW=16", "NW=8", "NW=32", "T_TILE=256",
                             "T_TILE=64", "T_TILE=256,NW=8", "QPL=2",
                             "BY_BOUND=0"])
    ap.add_argument("--sources", nargs="+", default=[], metavar="FILE",
                    help="other nn1.cu files with the present C interface, "
                         "timed as they are beside the configs")
    ap.add_argument("--baseline", metavar="FILE",
                    help="an older one-launch nn1.cu, timed beside the "
                         "configs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_nn1_sweep: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}", flush=True)
    q, tgt, count, n_live = cs.nn_problem(dev)
    rows = []
    builds = [(c, _patched(c)) for c in args.configs]
    for path in args.sources:
        with open(path) as f:
            builds.append((os.path.basename(path), f.read()))
    if args.baseline:
        with open(args.baseline) as f:
            builds.append(("baseline", f.read()))
    for i, (config, text) in enumerate(builds):
        path = _build_variant(f"v{i}", text)
        if config == "baseline":
            row = _measure(_baseline_kernel(path), q, tgt, count, n_live)
            shape = {"tile": OLD_T_TILE, "group": OLD_Q_TILE, "warps": 2}
        else:
            nn1, boxes, walk, shape = _kernel(path)
            row = _measure(nn1, q, tgt, count, n_live, boxes, walk)
        row = {"config": config, **shape, **row}
        rows.append(row)
        apart = (f"; target boxes {row['boxes_ms']:.4f} ms, list + walk "
                 f"{row['walk_ms']:.4f} ms ({row['no_walk_ms']:.4f} with "
                 "the queries out of reach)" if "boxes_ms" in row else "")
        print(f"nn1 {config} ({shape['group']} queries x {shape['warps']} "
              f"warps a CTA, {shape['tile']}-row tiles): kernel "
              f"{row['ms']:.4f} ms hot / {row['ms_cold']:.4f} cold, "
              f"cdist+amin {row['library_ms']:.3f} / "
              f"{row['library_ms_cold']:.3f} (turns hot "
              f"{[round(x, 4) for x in row['turns']]}, cold "
              f"{[round(x, 4) for x in row['cold_turns']]}){apart}; "
              f"uncapped {row['uncapped_ms']:.4f} ms; found "
              f"{row['found_capped']} / {row['found_uncapped']}, max |dsqd| "
              f"{row['max_abs_err_capped']:.3e} / "
              f"{row['max_abs_err_uncapped']:.3e}", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
