"""The latent-attention kernel (`mla_decode_attn`, one launch a layer of a
DeepSeek-V2 decode step) against its roofline, %: the sum over its launches
in the traced slice of the least time each needs (the latent cache's rows
[0, pos] and the f32 queries and output over the HBM rate, at the mean
cache row of the window's decode steps; the family's `mla_decode_cost`),
over their device time. None unless the trace saw one launch a step and
layer and the kernel's own count matches the host's steps (cross-checks on
standard error); None for a family without the kernel."""


def read(run):
    family, c = run.lm_family, run.lm_cfg
    if not hasattr(family, "mla_decode_cost"):
        return None
    cost = family.mla_decode_cost(c, family.mean_step_position(run))
    return family.decode_roofline(run, "mla_decode_attn", c["num_hidden_layers"], cost)
