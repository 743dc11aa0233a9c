"""The least time a decode step could take over the time it took, in
percent.  The bound (``roofline.decode_bytes``/``decode_flops``) reads
every weight once, of each MoE layer's experts only those the step's
tokens selected (the mean over the sampled batch's decode steps, from the
reference's routing of the same tokens), and the cache up to the step's
mean position; the time is ``decode_step_ms``'s."""
import roofline


def read(ctx, part=None):
    hf, wl = ctx["hf"], ctx["wl"]
    recs = [x for x in ctx.get("recs") or [] if not x.get("traced")]
    n = wl.get("new_tokens", 1) - 1
    if not recs or n <= 0:
        return None
    step_s = sum(r["decode_s"] for r in recs) / (n * len(recs))
    slots = wl["prompt"] + wl["new_tokens"] / 2
    b = wl["batch"]
    t, _ = roofline.bound(roofline.decode_bytes(hf, b, slots, ctx["routed"]),
                          roofline.decode_flops(hf, b, slots))
    return 100.0 * t / step_s
