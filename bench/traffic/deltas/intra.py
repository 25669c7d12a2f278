"""intra: ``edges`` edges inserted inside one fragment drawn uniformly,
both ends among its nodes (``chip_smoke.py``'s ``_intra_delta``)."""
from bench.data.generate import Delta


def make(ctx, spec: dict, gen) -> Delta:
    mine = ctx.members[int(gen.integers(ctx.graph.k))]
    src = gen.choice(mine, size=spec["edges"])
    dst = gen.choice(mine, size=spec["edges"])
    return Delta("intra", [(int(u), int(v)) for u, v in zip(src, dst)])
