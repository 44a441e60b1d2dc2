"""Model FLOPs of the work completed in the traced slice over the slice's
seconds and the card's bf16 dense peak, %. Counted from the shapes by the
benchmark's own functions (`costs.py`): each frame whose audio reached a
client in the slice (talker step with its head, the code predictor's
prefill, steps and heads, Code2Wav's share of a 10-frame decode), each
request sent in it (text projection, the talker's 8-row prefill) and, with
a text LM, each reply id received in it and each prompt's prefill, as the
LM's family counts them (`token_flops`, `prefill_flops`)."""

from h100_bench import costs
from h100_bench.metrics._shared import frames_between, tts_cfg


def read(run):
    s = run.summary
    if s is None or s.t1 <= s.t0:
        return None
    cfg = tts_cfg(run)
    frames, pos = frames_between(run, s.t0, s.t1)
    flops = frames * costs.tts_frame_flops(cfg, pos)
    for r in run.requests:
        if s.t0 <= r.start <= s.t1:
            flops += costs.tts_request_flops(cfg, len(r.text.encode()) + 8)
    if run.turns:
        family, lc = run.lm_family, run.lm_cfg
        for t in run.turns:
            for rp in t["replies"]:
                P, done = len(rp["prompt"]), 0
                for when, n in rp["times"]:
                    if s.t0 <= when <= s.t1:
                        flops += n * family.token_flops(lc, P + done + n / 2)
                        if done == 0:    # the prompt's prefill gave the first id
                            flops += family.prefill_flops(lc, P)
                    done += n
    if frames == 0 and flops == 0:
        return None
    return 100.0 * flops / ((s.t1 - s.t0) * costs.PEAKS["bf16_flops"])
