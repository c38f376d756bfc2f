"""frame_mfu (%): the whole frame's share of the card's peak: the field
MLP's flops these inputs need in a frame (2 x MACs a sample x the samples
the reference evaluates, averaged over the orbit's poses) over the
untraced frame's wall time at the field dtype's peak."""


def read(ctx):
    flops, ms, peak = (ctx.get("mlp_flops"), ctx.get("frame_ms"),
                       ctx.get("peak_flops"))
    if not flops or not ms or not peak:
        return None
    return 100.0 * flops / (ms * 1e-3 * peak)
