"""host_analysis_s: the benchmark's own span around the set-up's fill
ordering and symbolic analysis (``sparse_direct.ordering``,
``symbolic.analyze``, ``ea_plan``)."""


def read(w):
    return w.spans.get("host_analysis")
