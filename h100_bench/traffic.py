"""The one traffic generator: a mix's parameters (a data file under
`traffic/`) and `--seed` in, texts, lengths and arrival times out.

Every seed gets the same multiset of sentence lengths and of gaps between
arrivals, drawn at fixed quantiles of the mix's distributions; the seed
chooses their order and the words. So two seeds ask for the same work in
another order, and a run's spread is the system's, not the draw's.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per purpose (`stream`) of one seed."""
    return np.random.Generator(np.random.PCG64([int(seed) & (2 ** 64 - 1), stream]))


def _quantiles(n: int) -> list[float]:
    return [(i + 0.5) / n for i in range(n)]


def word_counts(spec: dict) -> list[int]:
    """`count` sentence lengths at the quantiles of a log-normal (`median`,
    `sigma`), rounded and clipped to [`min`, `max`]."""
    nd = NormalDist()
    out = []
    for q in _quantiles(spec["count"]):
        w = spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(q))
        out.append(int(min(max(round(w), spec["min"]), spec["max"])))
    return out


def texts(mix: dict, seed: int, n: int) -> list[str]:
    """n sentences: lengths from the mix's multiset in the seed's order
    (repeated as needed), words drawn from its vocabulary."""
    r = rng(seed, 1)
    counts = word_counts(mix["words"])
    order: list[int] = []
    while len(order) < n:
        order += list(r.permutation(counts))
    vocab = mix["vocabulary"]
    return [" ".join(vocab[i] for i in r.integers(0, len(vocab), size=int(k))) + "."
            for k in order[:n]]


def arrivals(mix: dict, seconds: float, seed: int) -> list[float]:
    """Open-loop due times in [0, seconds): `rate_per_s * seconds` arrivals.
    Their gaps are the exponential's quantiles (a Poisson process), or with
    `"kind": "gamma"` gaps of a Gamma distribution of coefficient of
    variation `cv` (bursts), drawn once from a fixed stream so that every
    seed has the same gaps; the seed orders them."""
    spec = mix["arrivals"]
    rate = spec["rate_per_s"]
    n = max(int(round(rate * seconds)), 1)
    if spec.get("kind", "poisson") == "gamma":
        shape = 1.0 / spec["cv"] ** 2
        gaps = list(rng(0, 7).gamma(shape, 1.0 / (rate * shape), size=n))
    else:
        gaps = [-math.log(1.0 - q) / rate for q in _quantiles(n)]
    scale = seconds * (n - 0.5) / n / sum(gaps)     # the last one inside the window
    return [float(t) * scale for t in np.cumsum(rng(seed, 2).permutation(gaps))]


def choices(items: list, seed: int, n: int, stream: int = 3) -> list:
    """n picks from `items` in the seed's order, each item equally often."""
    r = rng(seed, stream)
    out: list = []
    while len(out) < n:
        out += [items[i] for i in r.permutation(len(items))]
    return out[:n]
