"""idle_ms_per_step.trainer: the card's idle time per step of the profiled
epoch while the innermost open program span was the trainer's
(``layer_spans``)."""

from nvsm_bench import layer_spans


def read(ctx, rec):
    return layer_spans.idle_ms_per_step(rec, "trainer", show_split=True)
