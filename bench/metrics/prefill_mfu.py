"""Model flops of the window's prefills (``roofline.prefill_flops``: 2 per
active weight a prompt token, the causal attention, the LM head at the
served position; a MoE layer counts its top-k and shared experts) over
the window's wall time at the card's bf16 peak, in percent; the traced
slice's batches and seconds (the profiler runs there) are left out."""
import roofline


def read(ctx, part=None):
    n = len(ctx.get("recs") or []) - ctx.get("traced", 0)
    secs = ctx["window_s"] - ctx.get("traced_s", 0.0)
    if n <= 0 or secs <= 0:
        return None
    return (100.0 * n * ctx["prefill_flops"]
            / (secs * roofline.BF16_FLOP_PER_S))
