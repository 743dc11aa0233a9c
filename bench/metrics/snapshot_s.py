"""Mean wall seconds of ``ServeEngine.snapshot_service`` a batch of the
window (it drains, copies the serving state to the host and waits for the
write), by the host clock around the call."""


def read(ctx, part=None):
    recs = [x for x in ctx.get("recs") or [] if not x.get("traced")]
    times = [r["snapshot_s"] for r in recs]
    if not times or not any(times):
        return None
    return sum(times) / len(times)
