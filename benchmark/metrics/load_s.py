"""load_s: seconds of the host span `load` in set-up (the scene file
parsed, its OBJ files read, the scene built on the card and, above
ops/trace.BRUTE_MAX_TRIS triangles, its BVH attached), ending in a
synchronise. Moves setup_s."""


def read(ctx):
    spans = ctx.spans.get("load")
    return sum(spans) if spans else None
