"""What decides `correct`: the served outputs of a sample of the window's
finished requests, held to the plain float32 reference once the program's
state is freed.

The sample is drawn from the seed among the requests that finished: the
one with the most frames first, then others in the seed's order until
`frames` codec frames (and, with a text LM, `lm_tokens` reply ids) are in
it. Numbers compared, each the widest over the sample:

- `talker_gap`: how far a served code 0 (greedy) lies below the
  reference's best logit, and the EOS that ended a request before its cap;
- `cp_gap`: how far a sampled code of groups 1..15 lies below the
  reference's top-k-th logit (0 inside the top k);
- `cp_sample_z`: whether the sampled codes follow the distribution the
  configuration samples from (top-k, temperature): |z| of their summed
  surprisal against its expectation under the reference's distribution
  (`reference.tts.sample_terms`), over a larger sample of `cp_frames`
  frames drawn the same way; a standard normal's size for sound sampling;
- `audio_err`: a request's streamed audio against the reference's decode
  of its codes by the same chunks, |a - r| / |r| over the whole request;
- `lm_gap`: how far a served reply id lies below the reference's best
  logit, and the stop id that ended a reply early;
- `failed`: requests of the window that failed, returned no audio or
  non-finite audio, or did not finish.
"""

from __future__ import annotations

import numpy as np
import torch

from . import traffic


def _sample(items, size, total: int, seed: int, stream: int) -> list:
    """The largest item, then others in the seed's order, up to `total`."""
    if not items:
        return []
    order = sorted(range(len(items)), key=lambda i: -size(items[i]))
    rest = list(traffic.rng(seed, stream).permutation(order[1:]))
    picked, n = [order[0]], size(items[order[0]])
    for i in rest:
        if n >= total:
            break
        picked.append(int(i))
        n += size(items[int(i)])
    return [items[i] for i in picked]


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def tts_numbers(w: dict, cfg: dict, requests: list, plan: dict, seed: int, device,
                control: bool = False) -> dict:
    """The TTS numbers over a sample of `requests`. With `control`, the
    audio compared is the reference's own decode in TF32 (the precision
    below float32 with TF32 off), put in the program's place."""
    from .reference import code2wav, qwen3, tts

    qwen3.full_precision()
    done = [r for r in requests if r.ok and r.codes]
    talker = cp = err = 0.0
    frames = 0
    terms = torch.zeros(3, dtype=torch.float64)
    hop = code2wav.hop(cfg["code2wav"])
    top_k = cfg["engine"]["subtalker_top_k"]
    temperature = cfg["engine"]["subtalker_temperature"]
    # the gaps' sample is the prefix of the larger one up to `frames`
    # frames: the same requests as `_sample(..., plan["frames"], ...)`
    for r in _sample(done, lambda r: len(r.codes), max(plan["frames"], plan["cp_frames"]),
                     seed, 5):
        codes = torch.as_tensor(np.stack(r.codes), device=device)
        g = tts.request_gaps(w, cfg, r.text, codes, len(r.codes) < r.cap, top_k, temperature)
        terms += g["sample"]
        if frames >= plan["frames"]:
            continue
        talker, cp = max(talker, g["talker"]), max(cp, g["cp"])
        frames += g["frames"]
        chunk_frames = [n // hop for _t, n in r.chunks]
        ref = code2wav.stream_audio(cfg["code2wav"], w, codes, chunk_frames)
        got = torch.as_tensor(np.concatenate(r.audio), device=device)
        if control:
            _tf32(True)
            got = code2wav.stream_audio(cfg["code2wav"], w, codes, chunk_frames)
            qwen3.full_precision()
        if got.shape != ref.shape:
            err = float("inf")
            continue
        err = max(err, float((got - ref).norm() / ref.norm().clamp_min(1e-12)))
    z = float(terms[0] / terms[1].sqrt()) if terms[1] > 0 else float("inf")
    return {"talker_gap": talker, "cp_gap": cp, "audio_err": err, "cp_sample_z": abs(z),
            "frames_checked": frames, "codes_sampled": int(terms[2])}


def lm_numbers(replies: list, plan: dict, seed: int, reply_gaps) -> dict:
    """The text LM's numbers over a sample of `replies`: `reply_gaps(prompt,
    reply, stop)` is the LM family's reference, the gaps of a reply's served
    ids (and of `stop`, the id that ended it early) below its best logit."""
    from .reference import qwen3

    qwen3.full_precision()
    worst, n = 0.0, 0
    for r in _sample(replies, lambda r: len(r["reply"]), plan["lm_tokens"], seed, 6):
        stop = r["stop_ids"][0] if len(r["reply"]) < r["max"] and r["stop_ids"] else None
        g = reply_gaps(r["prompt"], r["reply"], stop)
        worst, n = max(worst, float(g.max())), n + int(g.numel())
    return {"lm_gap": worst, "tokens_checked": n}
