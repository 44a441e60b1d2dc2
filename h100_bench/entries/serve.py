"""An operator's shared card: `ContinuousBatcher` fed in an open loop, each
request submitted when it is due, whatever the card is doing. Requests due
in the window are drained after it, within the mix's grace; the batcher's
pending queue is sampled every `sample_ms` over the window."""

from __future__ import annotations

import asyncio
import time

from .. import traffic
from .common import Request, build_engine, frame_cap


def _program_request(agen):
    """The batcher's own record of the request that `submit`'s generator
    `agen` serves (read while the generator is suspended at a yield): its
    `codes` hold the frames served, in order. `ContinuousBatcher` gives a
    caller no public read of them."""
    req = agen.ag_frame.f_locals.get("req") if agen.ag_frame is not None else None
    if req is None or not hasattr(req, "codes"):
        raise RuntimeError("ContinuousBatcher.submit keeps no `req` with `codes`: "
                           "the served codes cannot be read")
    return req


def setup(run) -> None:
    from qwen_tts_tpu_torch.runtime.continuous import ContinuousBatcher

    mix = run.mix
    eng = build_engine(run, run.cfg, mix.get("engine"))
    b = ContinuousBatcher(eng, **mix["batcher"])
    b.warm()
    seq_bound = eng.model_config.talker.max_seq_len - 9 - 2 * b.chunk
    run.state.update(eng=eng, b=b, cap=lambda t: frame_cap(t, eng.config.max_new_tokens,
                                                             seq_bound))
    # the graphs fix every shape; two short requests run the path end to end
    vocab = mix["vocabulary"]
    b.serve([" ".join(vocab[:min(traffic.word_counts(mix["words"]))]) + "."] * 2)
    run.due = traffic.arrivals(mix, run.seconds, run.seed)
    run.texts = traffic.texts(mix, run.seed, len(run.due))


def counters(run) -> dict:
    eng = run.state["eng"]
    m = eng.get_metrics()
    out = {"requests": m["requests"]}
    if eng.device.type == "cuda":
        from qwen_tts_tpu_torch.ops.attention import device_launches

        out["attention_launches"] = device_launches(eng.device)
    return out


def window(run) -> None:
    b, cap = run.state["b"], run.state["cap"]
    mix = run.mix

    async def one(rec: Request):
        rec.start = time.perf_counter()
        agen, req = b.submit(rec.text), None
        try:
            async for audio, _sr in agen:
                rec.add(audio)
                req = req or _program_request(agen)
            rec.end = time.perf_counter()
        except Exception as e:
            rec.error = repr(e)
        if req is not None:
            rec.codes = [f for chunk in req.codes for f in chunk]

    async def sample(stop: asyncio.Event):
        dt = mix["sample_ms"] / 1e3
        while not stop.is_set():
            run.samples.append((time.perf_counter(), b.pending, b.active))
            run.tick()
            await asyncio.sleep(dt)

    async def loop():
        stop = asyncio.Event()
        sampler = asyncio.ensure_future(sample(stop))
        tasks = []
        for off, text in zip(run.due, run.texts):
            due = run.start + off
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            run.lateness.append(time.perf_counter() - due)
            rec = Request(text=text, due=due, cap=cap(text))
            run.requests.append(rec)
            tasks.append(asyncio.ensure_future(one(rec)))
        await asyncio.sleep(max(run.end - time.perf_counter(), 0.0))
        stop.set()
        await sampler
        done, late = await asyncio.wait(tasks, timeout=mix["grace_s"])
        for t in late:
            t.cancel()
        await asyncio.gather(*late, return_exceptions=True)
        for rec, t in zip(run.requests, tasks):
            if t in late:
                rec.error = rec.error or f"not finished {mix['grace_s']} s after the window"

    asyncio.run(loop())


def release(run) -> None:
    run.state.clear()
