"""frame_pad_pct.<kind>: 100 x (bucket frames - the longest real row's
frames) / bucket frames, averaged over the traced window's requests; the
bucket recomputed from the cell's frame buckets and the returned
lengths."""


def read(name, ctx):
    pads = ctx.get("frame_pad")
    if not pads:
        return None
    return sum(pads) / len(pads)
