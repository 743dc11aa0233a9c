"""The flash kernel's share of its roofline, in percent: its launches in
the traced slice times the least time one launch of the cell's shape
needs (``roofline.flash_bound``), over the device time of those launches
(``fa_fwd_tc_kernel``, the bf16 tensor-core kernel).  Nothing where the
slice launched none."""
import roofline

KERNEL = "fa_fwd_tc_kernel"


def read(ctx, part=None):
    s = ctx.get("trace")
    if s is None:
        return None
    n, secs = s.kernel(KERNEL)
    if not n or secs <= 0:
        return None
    bh, bkv, seq, hd = ctx["flash_shape"]
    return 100.0 * n * roofline.flash_bound(bh, bkv, seq, hd) / secs
