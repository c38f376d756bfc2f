"""sync_wait_ms (ms): host time a frame inside the blocking sync calls of
``host_syncs``, those inside the program's ``frame.fetch`` span (the
frame's one wanted sync) left out: what the host waits for the device
before it can issue the rest of the frame. None where the program opens
no ``frame.*`` span."""

from benchmark import spans


def read(ctx):
    r = spans.attach(ctx)
    return None if r is None else r["sync_wait_ms"]
