"""cross: ``edges`` edges inserted out of one fragment drawn uniformly, to
targets drawn uniformly over all nodes (``chip_smoke.py``'s
``_dynamic_stream`` cross delta, without its choice of targets that are
not boundary nodes yet)."""
from bench.data.generate import Delta


def make(ctx, spec: dict, gen) -> Delta:
    mine = ctx.members[int(gen.integers(ctx.graph.k))]
    src = gen.choice(mine, size=spec["edges"])
    dst = gen.integers(0, ctx.graph.n, size=spec["edges"])
    return Delta("cross", [(int(u), int(v)) for u, v in zip(src, dst)])
