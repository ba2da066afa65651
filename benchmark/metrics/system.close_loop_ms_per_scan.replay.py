"""Milliseconds a scan in ``maybe_close_loop`` (keyframe sync, archive,
descriptors, closures): the harness's ``close_loop`` span, closed by a
device synchronise in the traced run, summed over the window, over the
window's scans."""


def read(rec):
    t = rec.spans.get("close_loop")
    return 1e3 * t / rec.scans if t is not None and rec.scans else None
