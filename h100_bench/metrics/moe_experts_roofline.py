"""The expert kernel's one-row form (`moe_experts_decode`, one launch an
expert layer of a DeepSeek-V2 decode step) against its roofline, %: the sum
over its launches in the traced slice of the least time each needs (the
chosen experts' and the shared expert's bytes over the HBM rate, 138.4 MB
at DeepSeek-V2-Lite's widths; the family's `moe_decode_cost`), over their
device time. None unless the trace saw one launch a step and expert layer
and the kernel's own count matches the host's steps (cross-checks on
standard error); None for a family without the kernel."""


def read(run):
    family, c = run.lm_family, run.lm_cfg
    if not hasattr(family, "moe_decode_cost"):
        return None
    return family.decode_roofline(run, "moe_experts_decode", family.moe_layers(c),
                                  family.moe_decode_cost(c))
