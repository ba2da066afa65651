"""Seconds from the process's start until the window opens: imports, the
system's construction, ``warmup()``, the kernels' library (built in the
first run of a checkout) and the set-up scans."""


def read(rec):
    return rec.setup_s
