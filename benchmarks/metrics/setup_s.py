"""setup_s: process start to the first request of the window (library
load, inputs, ordering and symbolic analysis, warm-up)."""


def read(w):
    return w.setup_s
