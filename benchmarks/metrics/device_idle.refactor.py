"""device_idle.refactor: the device's idle share of the traced window, in %:
100·(1 − union of the device operations' intervals / window)."""

from metrics import _device


def read(w):
    return _device.idle_percent(w, "refactors")
