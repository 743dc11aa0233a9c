"""Milliseconds a decode step: the engine's own decode seconds of the
window's batches (``GenResult.decode_s``, read after a synchronize) over
their decode steps (new tokens less the prefill's)."""


def read(ctx, part=None):
    recs = [x for x in ctx.get("recs") or [] if not x.get("traced")]
    n = ctx["wl"].get("new_tokens", 1) - 1
    if not recs or n <= 0:
        return None
    return 1e3 * sum(r["decode_s"] for r in recs) / (n * len(recs))
