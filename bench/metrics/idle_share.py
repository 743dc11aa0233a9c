"""The share of the traced slice in which no device operation ran, in
percent: 1 - (the union of the kernels', copies' and sets' intervals over
the slice's wall time)."""


def read(ctx, part=None):
    s = ctx.get("trace")
    if s is None or s.wall_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)
