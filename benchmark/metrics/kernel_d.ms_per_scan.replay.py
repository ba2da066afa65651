"""Device milliseconds a scan of kernel D (``lm_search_kernel``,
csrc/lm_search.cu: GICP's LM lambda search in one launch), found by name
in the traced stretch, over the stretch's scans. None where no such
kernel ran."""


def read(rec):
    tr = rec.trace
    if not tr or not tr.get("scans"):
        return None
    s = sum(v for k, v in tr["kernels"].items() if "lm_search_kernel" in k)
    return 1e3 * s / tr["scans"] if s > 0 else None
