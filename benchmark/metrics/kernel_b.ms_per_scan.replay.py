"""Device milliseconds a scan of kernel B (``block_accum_kernel`` with
the TSDF epilogue, csrc/block_accum.cu), found by name in the traced
stretch, over the stretch's scans."""


def read(rec):
    tr = rec.trace
    if not tr or not tr.get("scans"):
        return None
    s = sum(v for k, v in tr["kernels"].items()
            if "block_accum_kernel" in k and "Logodds" not in k)
    return 1e3 * s / tr["scans"] if s > 0 else None
