"""Device milliseconds a scan of kernel A (``nn1_boxes_kernel`` and
``nn1_walk_kernel``, csrc/nn1.cu), found by name in the traced stretch,
over the stretch's scans."""


def read(rec):
    tr = rec.trace
    if not tr or not tr.get("scans"):
        return None
    s = sum(v for k, v in tr["kernels"].items() if "nn1_" in k)
    return 1e3 * s / tr["scans"] if s > 0 else None
