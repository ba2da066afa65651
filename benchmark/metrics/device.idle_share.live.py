"""Percent of the traced stretch in which the device ran no kernel, copy
or set: 100 x (1 - busy / stretch), from the device trace."""


def read(rec):
    tr = rec.trace
    if not tr or not tr.get("window_s") or tr.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
