"""device_idle_share: the share of the traced call's wall (from the marker
before it to its end) in which no kernel or copy ran on the card (the
union of their intervals), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.wall_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.wall_s)
