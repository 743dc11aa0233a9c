"""Model flops of the window's training steps (``roofline.train_flops``:
6 per weight a token, the LM head at every position, three times the
causal attention's forward; recomputation not counted) over the window's
wall time at the card's bf16 peak, in percent; the traced slice's steps
and seconds (the profiler runs there) are left out."""
import roofline


def read(ctx, part=None):
    steps = ctx.get("steps", 0) - ctx.get("traced", 0)
    secs = ctx["window_s"] - ctx.get("traced_s", 0.0)
    if steps <= 0 or secs <= 0:
        return None
    return (100.0 * steps * ctx["flops_per_step"]
            / (secs * roofline.BF16_FLOP_PER_S))
