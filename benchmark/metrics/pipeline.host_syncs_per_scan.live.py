"""Device-to-host reads a scan: the change of the port's counter
``SlamSystem.host_syncs`` over the window, over the window's scans."""


def read(rec):
    n = rec.counters.get("host_syncs")
    return n / rec.scans if n is not None and rec.scans else None
