"""adam_sweep_roofline: the least time of one step's full_adam sweeps over
both tables (``work/``: 28 bytes an element over 3.35 TB/s)
over the device time of the Triton sweep kernel (``_sweep_body``) per step
of the profiled epoch, in percent."""

from nvsm_bench import yardstick


def read(ctx, rec):
    t = rec.trace
    if t is None:
        return None
    secs, launches = t.matching("_sweep_body")
    if not launches or secs <= 0:
        return None
    least, _ = yardstick.bound(*ctx.work.sweep(ctx.config))
    return 100.0 * least * t.units / secs
