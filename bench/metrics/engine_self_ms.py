"""Milliseconds a request spends in the serving engine while the device
does no work for it: the median over the window's requests (the last
``len(recs)`` ``serve.generate`` spans) of the request's span less the
device durations of its ``serve.prefill`` and ``serve.decode`` spans."""
import statistics

import spans


def read(ctx, part=None):
    evs = spans.events()
    gens = spans.last(evs, "serve.generate", len(ctx.get("recs") or []))
    if gens is None:
        return None
    device, prefilled = {}, set()
    for e in evs:
        if e.name in ("serve.prefill", "serve.decode"):
            device[e.parent_id] = device.get(e.parent_id, 0.0) + e.dur
            if e.name == "serve.prefill":
                prefilled.add(e.parent_id)
    if any(g.span_id not in prefilled for g in gens):
        return None
    return 1e3 * statistics.median(g.dur - device[g.span_id] for g in gens)
