"""The decode-step kernel (B1, `decode_persistent`) against its roofline,
%: the sum over its launches in the traced slice of the least time each
needs (bytes over the HBM rate or FLOPs over the bf16 peak, whichever is
larger; `costs.step_cost`), over its device time in the slice.

Launches: the engine's talker and code-predictor steps and the text LM's
steps between the slice's two counter reads (the reads wait for the work
in flight, so every step they count ran inside the slice), at the mean
talker position of the frames delivered in the slice, the code
predictor's positions 2..15 and the LM's mean reply position (the LM's
step as its family counts it, `b1_step_cost`; none where the family's
steps do not run in B1). The kernel's own launch count (graph replays
included) is the cross-check; when the profiler saw fewer of its events
than the kernel counts (it can drop a persistent kernel's events), the
device time is scaled by counted/seen."""

import sys

from h100_bench import costs
from h100_bench.metrics._shared import frames_between, tts_cfg


def read(run):
    s = run.summary
    if s is None or "decode_launches" not in s.c0:
        return None
    cfg = tts_cfg(run)
    talker, cp = s.delta("talker_steps"), s.delta("cp_steps")
    _frames, pos = frames_between(run, s.t0, s.t1)
    need = talker * costs.bound_s(*costs.step_cost(cfg["talker"], pos, True))
    need += cp * sum(costs.bound_s(*costs.step_cost(cfg["code_predictor"], p, False))
                     for p in range(2, 16)) / 14
    steps = talker + cp
    if "lm_steps" in s.c0:
        ids = [len(rp["prompt"]) + i for t in run.turns for rp in t["replies"]
               for i in range(len(rp["reply"]))]
        lm_pos = sum(ids) / len(ids) if ids else 64
        step = run.lm_family.b1_step_cost(run.lm_cfg, lm_pos)
        if step is not None:
            lm = s.delta("lm_steps")
            need += lm * costs.bound_s(*step)
            steps += lm
    sec, seen = s.kernel_s("decode_persistent")
    counted = s.delta("decode_launches")
    print(f"decode_step_roofline: {steps} steps counted by the host, {counted} launches by "
          f"the kernel, {seen} events in the trace", file=sys.stderr)
    if seen == 0 or counted <= 0:
        return None
    return 100.0 * need / (sec * counted / seen) if seen < counted else 100.0 * need / sec
