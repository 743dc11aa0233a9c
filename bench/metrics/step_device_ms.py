"""Milliseconds a training step takes on the device: the median duration
of the window's ``train.step`` device spans (the batch's copies into the
graph's inputs and the replay) launched outside the save's write."""
import statistics

import spans


def read(ctx, part=None):
    got = spans.train_steps(ctx)
    if got is None:
        return None
    steps, _, inside, _ = got
    durs = [s.dur for s, i in zip(steps, inside) if not i]
    return 1e3 * statistics.median(durs) if durs else None
