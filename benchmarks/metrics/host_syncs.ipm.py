"""host_syncs.ipm: host waits for the device that start inside the
program's ``el.lp.iteration`` spans, per such span (one an IPM iteration,
its step and the loop's checks).  A wait is a CUDA runtime
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` or
``cudaEventSynchronize`` event (a value read on the host, ``float(t)``,
``bool(t)``, ``.item()``, ``.cpu()``, is a copy and a
``cudaStreamSynchronize``).  None where the trace holds no CUDA runtime
events (no card)."""

from metrics import _spans


def read(w):
    span = _spans.intervals(w, _spans.named("el.lp.iteration"))
    if span is None or not _spans.cuda_seen(w):
        return None
    return _spans.starting_inside(w, _spans.SYNCS.__contains__,
                                  span) / span[0].size
