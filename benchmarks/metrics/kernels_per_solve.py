"""kernels_per_solve: device operations (kernels, copies, sets) in
the traced window, per a solve."""

from metrics import _device


def read(w):
    return _device.ops_per(w, "solves")
