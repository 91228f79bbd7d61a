"""host_ms_per_step.sampler: the self time of the sampler's program spans
per step of the profiled epoch (``layer_spans``)."""

from nvsm_bench import layer_spans


def read(ctx, rec):
    return layer_spans.host_ms_per_step(rec, "sampler")
