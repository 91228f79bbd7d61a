"""device_idle_share.<cell kind>: the share of the time in which the card
ran no operation, in percent: 1 - (the union of the device intervals per
unit of work (a training step) of the profiled segment,
``profile_torch_step.py:busy_us``'s arithmetic) / (the wall time per unit
of the untraced window)."""

from nvsm_bench import yardstick


def read(ctx, rec):
    f = rec.facts
    per_unit = f["untraced_s"] / f["untraced_units"] if f.get("untraced_units") else None
    return yardstick.idle_share(rec.trace, per_unit)
