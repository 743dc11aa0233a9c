"""Seconds the window's save held the training loop: the checkpoint
manager's own ``drain_s`` (synchronize, wait for the last write) and
``snapshot_s`` (the copy to the host); the write runs behind."""


def read(ctx, part=None):
    ck = ctx.get("ckpt")
    if not ck or not ck.get("saves"):
        return None
    return float(ck["drain_s"] + ck["snapshot_s"])
