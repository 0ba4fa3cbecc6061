"""Inputs made from ``--seed`` on the device: rows, queries, centroids and
PQ codebooks, all drawn from one Gaussian mixture per configuration.

The mixture follows ``chip_smoke.py:994`` (``make_data``: centres plus
noise), frozen here so that a change to the program cannot change the
yardstick, and extended in three ways: it is drawn on the device with a
``torch.Generator`` in a few large calls; its component weights are
uneven (a Zipf law over the components, the same multiset of weights for
every seed, assigned to the components in a seeded order), so that list
lengths are uneven; its centres and weights are drawn once for the
configuration (``data.mixture_seed``), as a dataset is one, and
``--seed`` draws the rows, queries and samples from it, so that every
seed makes the same amount of work; and it takes the two datasets'
shapes:

``unit_sphere``  rows ``normalize(c + noise * g / sqrt(dim))`` with unit
                 centre directions ``c`` (Deep1B's L2-normalised rows);
``byte_grid``    rows ``clamp(round(|c| * centre_scale + noise * g), 0,
                 255)`` held as float32 (BIGANN's SIFT bytes).

Centroids and codebooks are trained as Faiss trains them, by Lloyd's
k-means on a sample of the rows (``index.train_rows``, ``train_iters``
rounds), started from raw draws of the mixture; each cluster's sum adds
its rows in row order (a sort by cluster, then ``segment_reduce``), so a
seed gives the same centroids on every run. Untrained centroids drawn at
random leave the lists six to seven times out of balance (Faiss's
imbalance factor) where k-means leaves them at about 1.6 at the cells' size.
"""
from __future__ import annotations

import dataclasses
import math

import torch

CHUNK = 1 << 20          # rows drawn a call


@dataclasses.dataclass
class Mixture:
    spec: dict
    centres: torch.Tensor      # [components, dim]
    weights: torch.Tensor      # [components] float64, sums to 1

    @property
    def dim(self) -> int:
        return int(self.spec["dim"])


def mixture(spec: dict, gen: torch.Generator, dev) -> Mixture:
    k, d = int(spec["components"]), int(spec["dim"])
    centres = torch.randn(k, d, generator=gen, device=dev)
    if spec["kind"] == "unit_sphere":
        centres = torch.nn.functional.normalize(centres, dim=1)
    elif spec["kind"] == "byte_grid":
        centres = centres.abs() * float(spec["centre_scale"])
    else:
        raise ValueError(f"unknown mixture kind {spec['kind']!r}")
    w = (torch.arange(k, dtype=torch.float64, device=dev) + 1.0) \
        ** -float(spec["zipf"])
    w = w[torch.randperm(k, generator=gen, device=dev)]
    return Mixture(spec, centres, w / w.sum())


def draw(mix: Mixture, n: int, gen: torch.Generator, finish: bool = True
         ) -> torch.Tensor:
    """``n`` rows of the mixture, ``CHUNK`` at a time. ``finish`` applies
    the dataset's normalisation or rounding (stored rows and queries);
    without it the draws are raw centres plus noise."""
    spec, d = mix.spec, mix.dim
    dev = mix.centres.device
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    unit = spec["kind"] == "unit_sphere"
    noise = float(spec["noise"]) / (math.sqrt(d) if unit else 1.0)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        comp = torch.multinomial(mix.weights, m, replacement=True,
                                 generator=gen)
        x = mix.centres[comp] + noise * torch.randn(
            (m, d), generator=gen, device=dev)
        if finish:
            x = torch.nn.functional.normalize(x, dim=1) if unit \
                else x.round_().clamp_(0.0, 255.0)
        out[i:i + m] = x
    return out


def nearest(x: torch.Tensor, c: torch.Tensor, block: int = 1 << 14
            ) -> torch.Tensor:
    """``x [B, N, d]``, ``c [B, K, d]`` -> each row's nearest centre
    ``[B, N]`` (float32 ``|c|^2 - 2 x.c``; the first of equals)."""
    cc = (c * c).sum(-1).unsqueeze(1)                           # [B, 1, K]
    out = torch.empty(x.shape[:2], dtype=torch.long, device=x.device)
    for i in range(0, x.shape[1], block):
        d = torch.baddbmm(cc, x[:, i:i + block], c.transpose(1, 2),
                          alpha=-2.0)
        out[:, i:i + block] = d.argmin(-1)
    return out


def kmeans(x: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd's rounds on ``B`` problems at once: ``x [B, N, d]`` from
    ``init [B, K, d]``; an empty cluster keeps its centre."""
    b, n, d = x.shape
    k = init.shape[1]
    c = init.clone()
    flat = x.reshape(b * n, d)
    for _ in range(iters):
        a = nearest(x, c)
        keys = (a + k * torch.arange(b, device=x.device).unsqueeze(1)
                ).reshape(-1)
        order = torch.sort(keys, stable=True).indices
        counts = torch.bincount(keys, minlength=b * k)
        sums = torch.segment_reduce(flat[order], "sum", lengths=counts,
                                    unsafe=True).reshape(b, k, d)
        counts = counts.reshape(b, k, 1)
        c = torch.where(counts > 0, sums / counts.clamp(min=1).to(x.dtype),
                        c)
    return c


@dataclasses.dataclass
class Inputs:
    pool: torch.Tensor          # [pool_rows, dim]: row of counter c is c % P
    queries: torch.Tensor       # [n_queries, dim]
    centroids: torch.Tensor     # [n_lists, dim]
    codebooks: torch.Tensor | None   # [m, ksub, dim // m]
    gen: torch.Generator        # continues for the traffic's own draws


def make_inputs(config: dict, seed: int, dev, mark=lambda name: None
                ) -> Inputs:
    """Everything a run feeds the index, in a fixed order of draws;
    ``mark`` is called after the rows and queries (``"data"``) and after
    the centroids and codebooks (``"centroids"``)."""
    # the dataset's distribution is the configuration's (its own seed);
    # --seed draws the rows, queries, training samples and traffic from it
    mix = mixture(config["data"], torch.Generator(device=dev).manual_seed(
        int(config["data"]["mixture_seed"])), dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    pool = draw(mix, int(config["pool_rows"]), gen)
    queries = draw(mix, int(config["data"]["n_queries"]), gen)
    mark("data")
    ix = config["index"]
    iters = int(ix["train_iters"])
    sample = pool[:int(ix["train_rows"])]
    centroids = kmeans(sample.unsqueeze(0), draw(
        mix, int(ix["n_lists"]), gen, finish=False).unsqueeze(0), iters)[0]
    codebooks = None
    if ix.get("pq"):
        m, ksub = int(ix["pq"]["m"]), 1 << int(ix["pq"]["nbits"])
        ds = mix.dim // m
        raw = draw(mix, m * ksub, gen, finish=False).reshape(m, ksub, m, ds)
        # subspace s starts from ksub draws of its own
        init = torch.stack([raw[s, :, s] for s in range(m)])   # [m, K, ds]
        sub = sample[:int(ix["pq"]["train_rows"])]
        codebooks = kmeans(sub.reshape(-1, m, ds).transpose(0, 1)
                           .contiguous(), init, iters).contiguous()
    mark("centroids")
    return Inputs(pool, queries, centroids, codebooks, gen)
