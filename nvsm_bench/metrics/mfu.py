"""mfu.<cell kind>: the model FLOPs of a unit of work (a training step,
``work/``) times the units of the untraced window, over that
window's wall, as a share of the card's float32 peak, in percent."""

from nvsm_bench import yardstick


def read(ctx, rec):
    f = rec.facts
    if not f.get("untraced_units") or f["untraced_s"] <= 0:
        return None
    return 100.0 * f["unit_flops"] * f["untraced_units"] / f["untraced_s"] / yardstick.F32_OPS_PER_S
