"""The share of the traced window in which no operation ran on the card:
100 (1 - the union of the device's operation intervals / the window)."""


def read(run):
    if not run.device_ops or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
