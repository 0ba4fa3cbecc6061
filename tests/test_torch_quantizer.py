"""Port quantizer (assign / probe / k-means) against the JAX reference.

``assign`` and ``probe`` must be ``==`` to the reference. Rows whose two
best centroid scores lie within 1e-5 relative of each other are near ties
that fp32 summation order may break either way: they are excluded and
counted (the count must stay small). A forced exact tie checks that the
lowest list index wins, as ``lax.top_k`` / ``argmin`` do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch.core import quantizer


def near_tie_rows(scores: np.ndarray, depth: int) -> np.ndarray:
    """Rows where any of the first ``depth`` ranked scores is within 1e-5
    relative of its successor (order there is rounding-dependent)."""
    s = -np.sort(-scores, axis=1)[:, :depth + 1]
    gap = np.abs(s[:, :-1] - s[:, 1:])
    return (gap <= 1e-5 * np.maximum(np.abs(s[:, 1:]), 1)).any(axis=1)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_assign_and_probe_match_reference(rng, metric):
    cents = rng.normal(size=(32, 24)).astype(np.float32)
    xs = rng.normal(size=(500, 24)).astype(np.float32)
    nprobe = 6
    ref_a = np.asarray(jcore.assign(jnp.asarray(cents), jnp.asarray(xs),
                                    metric))
    ref_p = np.asarray(jcore.probe(jnp.asarray(cents), jnp.asarray(xs),
                                   nprobe, metric))
    got_a = quantizer.assign(torch.from_numpy(cents), torch.from_numpy(xs),
                             metric).numpy()
    got_p = quantizer.probe(torch.from_numpy(cents), torch.from_numpy(xs),
                            nprobe, metric).numpy()
    assert got_a.dtype == got_p.dtype == np.int32
    scores = xs @ cents.T if metric == "ip" else -(
        (xs[:, None] - cents[None]) ** 2).sum(-1)
    tie = near_tie_rows(scores, nprobe)
    assert tie.sum() <= 5, tie.sum()
    assert np.array_equal(got_a[~tie], ref_a[~tie])
    assert np.array_equal(got_p[~tie], ref_p[~tie])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_ties_pick_the_lowest_index(metric):
    base = np.eye(4, 8, dtype=np.float32)
    cents = np.concatenate([base, base, base])     # each centroid 3 times
    xs = np.concatenate([base, base[::-1]])
    ref_p = np.asarray(jcore.probe(jnp.asarray(cents), jnp.asarray(xs), 5,
                                   metric))
    got_p = quantizer.probe(torch.from_numpy(cents), torch.from_numpy(xs), 5,
                            metric).numpy()
    assert np.array_equal(got_p, ref_p)
    assert np.array_equal(got_p[:4, :3], np.arange(4)[:, None] + [0, 4, 8])
    got_a = quantizer.assign(torch.from_numpy(cents), torch.from_numpy(xs),
                             metric).numpy()
    assert np.array_equal(got_a, np.asarray(jcore.assign(
        jnp.asarray(cents), jnp.asarray(xs), metric)))
    assert np.array_equal(got_a, [0, 1, 2, 3, 3, 2, 1, 0])


def test_train_kmeans_is_seeded_lloyd(rng):
    centres = rng.normal(scale=8.0, size=(6, 16)).astype(np.float32)
    xs = torch.from_numpy(
        (centres[rng.integers(0, 6, 600)] + rng.normal(size=(600, 16)))
        .astype(np.float32))
    a = quantizer.train_kmeans(xs, 6, iters=10,
                               generator=torch.Generator().manual_seed(3))
    b = quantizer.train_kmeans(xs, 6, iters=10,
                               generator=torch.Generator().manual_seed(3))
    assert a.shape == (6, 16) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    # Lloyd's iterations from the same start, in numpy (float64)
    x = xs.numpy().astype(np.float64)
    c = x[torch.randperm(600, generator=torch.Generator().manual_seed(3))
          [:6].numpy()]
    for _ in range(10):
        lab = ((x[:, None] - c[None]) ** 2).sum(-1).argmin(1)
        c = np.stack([x[lab == j].mean(0) if (lab == j).any() else c[j]
                      for j in range(6)])
    np.testing.assert_allclose(a.numpy(), c, rtol=1e-4, atol=1e-4)
    small = quantizer.train_kmeans(xs[:4], 6, iters=2,
                                   generator=torch.Generator().manual_seed(0))
    assert small.shape == (6, 16)
