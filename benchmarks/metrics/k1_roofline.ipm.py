"""k1_roofline.ipm: K1's share of its roofline in the traced window, in %:
its least time (the run plan's value bytes at the HBM rate) over its
device time; see _k1.py."""

from metrics import _k1


def read(w):
    return _k1.roofline_percent(w, "iterations")
