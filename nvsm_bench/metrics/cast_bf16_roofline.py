"""cast_bf16_roofline: the least time of the word table's bfloat16 copy
(``work/``: 6 bytes an element over 3.35 TB/s) over the device
time of one launch of the CUDA C++ kernel (``cast_kernel``) in the
profiled epoch, in percent."""

from nvsm_bench import yardstick


def read(ctx, rec):
    t, work = rec.trace, ctx.work.cast(ctx.config)
    if t is None or work is None:
        return None
    secs, launches = t.matching("cast_kernel")
    if not launches or secs <= 0:
        return None
    least, _ = yardstick.bound(*work)
    return 100.0 * least * launches / secs
