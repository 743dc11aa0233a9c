"""Seconds the window's save cost the training loop beyond its hold: over
the ``train.step`` device spans launched while the save's write ran (from
the end of ``ckptmgr.snapshot`` to the end of ``ckptmgr.write``), each
step's period (its device start to the next step's) less the median
period of the steps launched outside that interval, summed.  The hold
itself (drain and snapshot, before the first such step) is
``ckpt_block_s``'s."""
import statistics

import spans


def read(ctx, part=None):
    got = spans.train_steps(ctx)
    if got is None:
        return None
    _, periods, inside, saved = got
    outside = [p for p, i in zip(periods, inside) if not i]
    if not saved or not outside:
        return None
    base = statistics.median(outside)
    return sum(p - base for p, i in zip(periods, inside) if i)
