"""The one traffic generator: it reads a mix's parameters
(``bench/traffic/<name>.json``) and makes the requests, or the training
batches, from ``--seed``.

Sizes are drawn by stratified quantiles of the mix's distributions, in
blocks of ``block`` requests (16 unless the mix says otherwise): every
block holds the same (prompt length, output length) pairs, in another
order, so any run of whole blocks, and so every window, gets the same work
from every seed; the seed changes the order and the token ids.
Inter-arrival gaps are stratified over the whole schedule.  Distributions: ``{"dist": "lognormal", "median", "sigma",
"min", "max"}``, ``{"dist": "uniform", "min", "max"}`` (whole numbers,
both ends included) and ``{"dist": "fixed", "value"}``.  Loops:
``{"type": "closed", "clients": n}``, or open loops ``{"type":
"poisson", "rate": r}`` and ``{"type": "gamma", "rate": r, "cv": c}``
(bursty arrivals: gamma inter-arrival gaps of coefficient of variation
``c``), with ``"clients"`` bounding the requests in flight.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """A numpy stream for one purpose of one seed (any whole number)."""
    return np.random.default_rng([int(seed) & ((1 << 64) - 1), stream])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` stratified draws of ``spec`` (the midpoints of n equal-mass
    strata), ascending."""
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "fixed":
        return np.full(n, float(spec["value"]))
    if dist == "uniform":
        lo, hi = spec["min"], spec["max"]
        return np.floor(lo + u * (hi - lo + 1))
    if dist == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
        return np.clip(np.round(v), spec["min"], spec["max"])
    if dist == "gamma":                       # inter-arrival gaps
        cv, mean = spec["cv"], spec["mean"]
        k = 1.0 / (cv * cv)
        from scipy.stats import gamma
        return gamma.ppf(u, k, scale=mean / k)
    if dist == "exponential":
        return -spec["mean"] * np.log1p(-u)
    raise ValueError(f"unknown distribution {dist!r}")


def sizes(body: dict, out: dict, n: int, block: int,
          rng: np.random.Generator) -> List[Tuple[int, int]]:
    """``n`` (prompt body, output) length pairs: each block of ``block`` the
    stratified quantiles of both, paired by a fixed scramble (the k-th
    body quantile with the (7k mod block)-th output quantile), permuted."""
    qb, qo = quantiles(body, block), quantiles(out, block)
    pairs = [(int(qb[k]), int(qo[(7 * k) % block])) for k in range(block)]
    out_list: List[Tuple[int, int]] = []
    while len(out_list) < n:
        out_list += [pairs[i] for i in rng.permutation(block)]
    return out_list[:n]


def serve_requests(traffic: dict, vocab: int, seed: int
                   ) -> Tuple[List[Tuple[List[int], int]], List[Tuple[List[int], int]]]:
    """(the warm-up wave, the pool the window draws from): each a list of
    (prompt token ids, output tokens).  A prompt is the mix's shared
    prefix (one per seed) and a body of its own."""
    rng = rng_of(seed, 1)
    p = traffic["prompt"]
    prefix = rng.integers(0, vocab, int(p.get("shared_prefix", 0))).tolist()
    block = int(traffic.get("block", 16))

    def make(n, out_spec):
        return [(prefix + rng.integers(0, vocab, b).tolist(), o)
                for b, o in sizes(p["body"], out_spec, n, block, rng)]

    warm = traffic["warmup"]
    return make(int(warm["requests"]), warm["output"]), \
        make(int(traffic["pool"]), traffic["output"])


def arrival_gaps(loop: dict, n: int, seed: int) -> List[float]:
    """An open loop's inter-arrival gaps in seconds (stratified, permuted)."""
    rate = float(loop["rate"])
    if loop["type"] == "poisson":
        spec = {"dist": "exponential", "mean": 1.0 / rate}
    elif loop["type"] == "gamma":
        spec = {"dist": "gamma", "mean": 1.0 / rate, "cv": float(loop["cv"])}
    else:
        raise ValueError(f"{loop['type']!r} is not an open loop")
    return [float(v) for v in rng_of(seed, 2).permutation(quantiles(spec, n))]


class DistillFeed:
    """The training batches of a mix, made on ``device`` from the seed one
    at a time (each row its own): token ids, next-token labels and a loss
    mask over each row's last ``loss_positions`` positions."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        import torch
        self.b, self.s = int(traffic["batch"]), int(traffic["seq"])
        self.vocab = vocab
        self.gen = torch.Generator(device=device).manual_seed(
            (int(seed) * 0x9E3779B1 + 7) & ((1 << 63) - 1))
        self.device = device
        self.mask = torch.zeros((self.b, self.s), dtype=torch.float32, device=device)
        self.mask[:, self.s - int(traffic["loss_positions"]):] = 1.0

    def next(self) -> dict:
        import torch
        ids = torch.randint(0, self.vocab, (self.b, self.s + 1), generator=self.gen,
                            device=self.device)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:], "loss_mask": self.mask}
