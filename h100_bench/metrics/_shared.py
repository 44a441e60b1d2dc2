"""What several readers compute: window membership, percentiles, frames
delivered in an interval with their talker positions."""

from __future__ import annotations

import math

from h100_bench.reference.code2wav import hop

PREFIX = 9          # talker cache rows before a request's first frame


def nearest_rank(values: list[float], q: float) -> float | None:
    """The q-th percentile by nearest rank (a value of the sample)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def tts_cfg(run) -> dict:
    return run.cfg.get("tts", run.cfg)


def started_in_window(run) -> list:
    return [r for r in run.requests if run.start <= r.due < run.end]


def first_audio_ms(run) -> list[float]:
    """Due (or start) to first audio of each request of the window, ms; a
    request that failed counts as never served."""
    return [(r.first - r.due) * 1e3 if r.ok and r.first is not None else math.inf
            for r in started_in_window(run)]


def frames_between(run, t0: float, t1: float) -> tuple[int, float]:
    """Frames whose audio reached a client in [t0, t1], and their mean
    talker position."""
    hp = hop(tts_cfg(run)["code2wav"])
    n, pos = 0, 0.0
    for r in run.requests:
        done = 0
        for t, samples in r.chunks:
            k = samples // hp
            if t0 <= t <= t1:
                n += k
                pos += k * (PREFIX + done + (k - 1) / 2)
            done += k
    return n, (pos / n if n else 0.0)


def idle_share(run) -> float | None:
    """Share of the traced slice with no operation on the device, %."""
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def turns_by_length(run, value) -> float | None:
    """The mean, over the reply lengths of the window's turns, of the
    median of `value(turn)` among that length's turns: every turn counts,
    and each length weighs the same whichever of them the window's end
    cuts short (a turn's first audio grows with its reply's sentences)."""
    groups: dict = {}
    for t in run.turns:
        if run.start <= t["start"] < run.end:
            v = value(t)
            if v is not None:
                groups.setdefault(t["sentences"], []).append(v)
    if not groups:
        return None
    return sum(nearest_rank(g, 50) for g in groups.values()) / len(groups)
