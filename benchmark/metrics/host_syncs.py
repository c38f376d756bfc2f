"""host_syncs (count): the host's blocking sync calls into the CUDA runtime
a frame in the traced loops (``spans.SYNC_CALLS``: pageable uploads and
the fetch end in one), the window's closing synchronize left out."""

from benchmark import spans


def read(ctx):
    r = spans.attach(ctx)
    return None if r is None else r["host_syncs"]
