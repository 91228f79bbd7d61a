"""host_ms_per_step.step: the self time of the step's program spans
per step of the profiled epoch (``layer_spans``)."""

from nvsm_bench import layer_spans


def read(ctx, rec):
    return layer_spans.host_ms_per_step(rec, "step")
