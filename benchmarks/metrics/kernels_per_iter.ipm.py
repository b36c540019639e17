"""kernels_per_iter.ipm: device operations (kernels, copies, sets) in
the traced window, per an IPM iteration."""

from metrics import _device


def read(w):
    return _device.ops_per(w, "iterations")
