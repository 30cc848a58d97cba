"""Share of the traced slice in which no kernel, copy or fill ran on the
device (the union of their intervals, so overlapping streams count
once), %."""


def read(r):
    v = r.view
    if v is None or v.window_s <= 0:
        return None
    return 100.0 * (1.0 - v.busy_s / v.window_s)
