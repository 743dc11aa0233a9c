"""Seconds the process spent capturing CUDA graphs: the summed durations
of its ``train.capture`` spans (the graphed train step's eager first step
and its record) and ``serve.capture`` spans (the serving engine's warm-up
and capture of one graph), all of them in set-up; nothing once the ring
has filled, since the oldest spans, these first, may be gone."""
import spans

NAMES = ("train.capture", "serve.capture")


def read(ctx, part=None):
    caps = [e.dur for e in spans.events(whole=True) or () if e.name in NAMES]
    return sum(caps) if caps else None
