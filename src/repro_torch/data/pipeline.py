"""Deterministic synthetic data pipelines: the port's own copy of
``repro/data/pipeline.py`` (numpy only; the batches are ``==`` the
reference's for the same ``(seed, step, host)``).

Requirements at scale: (1) deterministic per (seed, step, host) so an
elastic restart resumes the exact stream without coordination; (2) O(1)
skip-ahead (counter-based RNG, no sequential state); (3) per-host sharding
by host id so each host materializes only its slice of the global batch.

Token streams are Zipf-distributed over the vocab (natural-ish unigram
statistics); vector streams are Gaussian-mixture draws matching the SIVF
benchmark datasets (SIFT/GIST-like dims).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2


class TokenStream:
    """Counter-based deterministic token batches."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of n_hosts {cfg.n_hosts}")
        self.cfg = cfg
        self.host_batch = cfg.global_batch // cfg.n_hosts

    def batch(self, step: int) -> dict:
        """Batch for ``step`` (O(1): safe to skip ahead after a restart):
        int32 ``tokens`` and next-token ``labels``, ``[host_batch,
        seq_len]``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        toks = rng.zipf(cfg.zipf_a, size=(self.host_batch, cfg.seq_len + 1))
        toks = (toks - 1) % cfg.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass(frozen=True)
class VectorStreamConfig:
    seed: int = 0
    dim: int = 128
    n_clusters: int = 64
    cluster_std: float = 0.3
    zipf_a: float = 0.0        # 0 = uniform cluster popularity, else skewed


class VectorStream:
    """Gaussian-mixture vector batches for SIVF benchmarks (SIFT-like)."""

    def __init__(self, cfg: VectorStreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 777]))
        self.centers = rng.normal(size=(cfg.n_clusters, cfg.dim)
                                  ).astype(np.float32)

    def batch(self, step: int, n: int) -> np.ndarray:
        """``n`` float32 vectors ``[n, dim]`` for ``step``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        if cfg.zipf_a > 0:
            ranks = (rng.zipf(cfg.zipf_a, size=n) - 1) % cfg.n_clusters
        else:
            ranks = rng.integers(0, cfg.n_clusters, size=n)
        x = self.centers[ranks] + rng.normal(
            size=(n, cfg.dim)).astype(np.float32) * cfg.cluster_std
        return x.astype(np.float32)
