"""kernels_per_factor.refactor: device operations (kernels, copies, sets) in
the traced window, per a refactor request."""

from metrics import _device


def read(w):
    return _device.ops_per(w, "refactors")
