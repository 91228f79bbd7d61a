"""host_ms_per_step.similarity: the self time of the similarity stream's
program spans (``cunvsm.similarity.*``) per step of the profiled epoch
(``layer_spans``)."""

from nvsm_bench import layer_spans


def read(ctx, rec):
    return layer_spans.host_ms_per_step(rec, "similarity")
