"""idle_ms_per_step.sampler: the card's idle time per step of the profiled
epoch while the innermost open program span was the sampler's
(``layer_spans``)."""

from nvsm_bench import layer_spans


def read(ctx, rec):
    return layer_spans.idle_ms_per_step(rec, "sampler")
