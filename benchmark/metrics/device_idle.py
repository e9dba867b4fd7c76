"""device_idle.<group>: the share of the traced slice in which no device
operation runs (one minus the union of the device events' intervals over
the slice), in %."""


def read(name, rec):
    tr = rec['trace']
    if tr is None or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
