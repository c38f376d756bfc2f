"""ip_pack_device_ms (ms): device time a frame of the kernels launched in
the ``bench.ip_pack`` range (``sim/solver.py:get_ip_info`` and
``ops/beam_bend.py:pack_ip_data_fast``)."""


def read(ctx):
    v = ctx.get("span_device_ms", {}).get("bench.ip_pack")
    return v if v else None
