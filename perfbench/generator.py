"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and a run's seed and gives the requests of a
window.  Every seed gets the same set of sizes and gaps, in another order:
lengths and inter-arrival gaps are the distributions' quantiles at evenly
spaced probabilities, and the members' counts are their shares rounded, so
two seeds differ in which request comes when, not in how much work there
is.

Mix parameters:

    arrivals    {"kind": "backlog", "requests": n, "block": b}: n requests
                queued before the window, their sizes drawn in blocks of b
                (each block holds the same sizes);
                {"kind": "poisson", "burst": k}: bursts of k requests of one
                member, due together, Poisson in time at the cell's
                ``rate_per_s`` requests a second: the window's gaps are the
                exponential's quantiles in one shuffle over the whole
                window, so they bunch as a Poisson stream's do, and only
                their count and their set are the same for every seed
    popularity  {"kind": "uniform"} or {"kind": "zipf", "s": s}: the
                members' shares (by rank, member 0 first)
    prompt      {"dist": "fixed", "tokens": n} or {"dist": "lognormal",
                "median": m, "sigma": s, "min": lo, "max": hi}
    output      as ``prompt``, for requests that decode (absent: none)
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist

import numpy as np

from perfbench.common import stable_seed


@dataclasses.dataclass(frozen=True)
class Planned:
    index: int
    due_s: float  # seconds after the window opens; 0 for a backlog
    member: int
    prompt_len: int
    output_len: int  # 0 for a serve request


def quantiles(n: int) -> np.ndarray:
    """n evenly spaced probabilities, (i + 1/2) / n."""
    return (np.arange(n) + 0.5) / n


def lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths of the distribution ``spec``, in quantile order."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["tokens"]), np.int64)
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(u)) for u in quantiles(n)])
        x = np.round(spec["median"] * np.exp(spec["sigma"] * z))
        return np.clip(x, spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def shares(spec: dict, members: int) -> np.ndarray:
    if spec["kind"] == "uniform":
        w = np.ones(members)
    elif spec["kind"] == "zipf":
        w = 1.0 / np.arange(1, members + 1) ** spec["s"]
    else:
        raise ValueError(f"unknown popularity {spec['kind']!r}")
    return w / w.sum()


def member_counts(spec: dict, members: int, n: int) -> np.ndarray:
    """Each member's count of n, its share rounded by largest remainder."""
    exact = shares(spec, members) * n
    counts = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[: n - counts.sum()]] += 1
    return counts


def members_of(spec: dict, members: int, n: int, rng) -> np.ndarray:
    counts = member_counts(spec, members, n)
    return rng.permutation(np.repeat(np.arange(members), counts))


def plan(mix: dict, seed: int, members: int, seconds: float, rate_per_s: float = 0.0) -> list:
    """The requests of one window, by due time."""
    rng = np.random.default_rng(stable_seed(seed, "traffic"))
    arr = mix["arrivals"]
    out_spec = mix.get("output")
    if arr["kind"] == "backlog":
        n, block = int(arr["requests"]), int(arr["block"])
        prompts, outputs = [], []
        base_p = lengths(mix["prompt"], block)
        base_o = lengths(out_spec, block) if out_spec else np.zeros(block, np.int64)
        for _ in range(-(-n // block)):
            prompts.append(rng.permutation(base_p))
            outputs.append(rng.permutation(base_o))
        who = np.concatenate([members_of(mix["popularity"], members, block, rng)
                              for _ in range(-(-n // block))])
        p, o = np.concatenate(prompts)[:n], np.concatenate(outputs)[:n]
        return [Planned(i, 0.0, int(who[i]), int(p[i]), int(o[i])) for i in range(n)]
    if arr["kind"] == "poisson":
        burst = int(arr.get("burst", 1))
        bursts = max(1, int(round(rate_per_s * seconds / burst)))
        lam = rate_per_s / burst
        gaps = rng.permutation(-np.log1p(-quantiles(bursts)) / lam)
        due = np.cumsum(gaps)
        who = members_of(mix["popularity"], members, bursts, rng)
        p = rng.permutation(lengths(mix["prompt"], bursts * burst))
        o = (rng.permutation(lengths(out_spec, bursts * burst)) if out_spec
             else np.zeros(bursts * burst, np.int64))
        out = []
        for b in range(bursts):
            if due[b] >= seconds:
                continue
            for k in range(burst):
                i = len(out)
                out.append(Planned(i, float(due[b]), int(who[b]), int(p[b * burst + k]),
                                   int(o[b * burst + k])))
        return out
    raise ValueError(f"unknown arrivals {arr['kind']!r}")


def tokens(seed: int, planned: list, vocab: int) -> list:
    """Each request's prompt token ids (int32), drawn from the seed."""
    rng = np.random.default_rng(stable_seed(seed, "tokens"))
    total = sum(r.prompt_len for r in planned)
    flat = rng.integers(0, vocab, total, dtype=np.int64).astype(np.int32)
    cuts = np.cumsum([0] + [r.prompt_len for r in planned])
    return [flat[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
