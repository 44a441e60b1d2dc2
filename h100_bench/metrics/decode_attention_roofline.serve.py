"""The decode-attention kernel (B3, `decode_attention_kernel`) in the
batched path against its roofline, %: the least time of its launches in
the traced slice (each active slot's bf16 K/V prefix and its f32 q,
k_new, v_new and out moved once, `costs.attention_cost`; its f32 products
at the f32 peak), over its device time in the slice.

Launches: the kernel's own count between the slice's two reads, one a
layer of each talker step (28) and of each code-predictor step (5 x 14);
the slots in use and their talker positions from the harness's samples
over the slice (each active request at 9 rows plus the frames it had
received); idle slots are no work the traffic needs. An admission's
codec_bos step (28 launches) is counted as a frame step: the need reads
~2% high at 1.5 admissions a second."""

from h100_bench import costs
from h100_bench.metrics._shared import PREFIX, tts_cfg
from h100_bench.reference.code2wav import hop


def read(run):
    s = run.summary
    if s is None or "attention_launches" not in s.c0:
        return None
    cfg = tts_cfg(run)
    t, cp = cfg["talker"], cfg["code_predictor"]
    per_frame = t["num_layers"] + cp["num_layers"] * 14
    steps = s.delta("attention_launches") / per_frame
    hp = hop(cfg["code2wav"])
    talker_pos = []
    for when, _pending, _active in run.samples:
        if not s.t0 <= when <= s.t1:
            continue
        ps = []
        for r in run.requests:
            if r.first is not None and r.first <= when and (r.end is None or when < r.end):
                ps.append(PREFIX + sum(n for tt, n in r.chunks if tt <= when) // hp)
        talker_pos.append(ps)
    if not talker_pos or steps <= 0:
        return None
    need_t = sum(costs.bound_s(*costs.attention_cost(t, ps), costs.PEAKS["f32_flops"])
                 for ps in talker_pos) / len(talker_pos)
    need_cp = sum(costs.bound_s(*costs.attention_cost(cp, [p] * len(ps)), costs.PEAKS["f32_flops"])
                  for ps in talker_pos for p in range(2, 16)) / len(talker_pos) / 14
    need = steps * (t["num_layers"] * need_t + cp["num_layers"] * 14 * need_cp)
    sec, seen = s.kernel_s("decode_attention_kernel")
    return 100.0 * need / sec if seen else None
