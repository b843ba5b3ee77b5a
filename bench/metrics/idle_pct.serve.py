"""idle_pct.serve: the share of the traced window in which no kernel or copy
ran on the device (one minus the union of their intervals), in percent."""


def read(run):
    if not run.trace or run.window_s <= 0 or not run.device.events:
        return None
    return 100.0 * (1.0 - run.device.busy_s() / run.window_s)
