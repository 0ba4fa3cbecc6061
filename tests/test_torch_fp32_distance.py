"""The float32 raw-distance error of the port's fused fold against the
reference's search, both against float64 (``ROADMAP.md`` queue 3, fault
2; ``scripts/fp32_distance_error.py`` runs the same at 1M x 128).

The chip workload's construction at a small size: rows of a mixture of
``N(0, 3^2)`` centres plus unit noise, 128 wide, in the reference's pool;
queries of the same mixture searched at k 10, nprobe 32 by the
reference (``core.search(impl="xla")``) and by the port's fused fold on
CPU tensors over the reference's planes and tables (the function kernel
1 is held to bit for bit). Labels ``==``, and the port's share of the
1e-5 distance limit against float64 is at most the reference's. The fold
sums ``q . x`` and ``||q||^2`` in eight float32 lanes over d
(``ref.dot_lanes``); while it summed in index order in one accumulator
it used about three times the reference's share (0.887 against 0.313 at
1M rows, 256 queries; kernel 1 reached 1.049 on the card).
"""
import jax.numpy as jnp
import numpy as np
import sivf_torch  # noqa: F401  (the core first: the kernels import it)
import torch

from repro import core as jcore
from repro_torch.kernels.sivf_scan import ops

RTOL = 1e-5


def share_of_limit(d, lab, base, queries) -> float:
    rows = base[np.clip(lab, 0, None)].astype(np.float64)
    exact = ((queries.astype(np.float64)[:, None] - rows) ** 2).sum(-1)
    ok = lab >= 0
    return float((np.abs(d.astype(np.float64) - exact)
                  / (RTOL + RTOL * exact))[ok].max())


def test_fused_fold_uses_no_more_of_the_limit_than_the_reference():
    rng = np.random.default_rng(0)
    centres = rng.normal(scale=3.0, size=(256, 128)).astype(np.float32)
    x = centres[rng.integers(0, 256, 20_016)] + rng.normal(
        size=(20_016, 128)).astype(np.float32)
    base, queries = x[:20_000], x[20_000:]
    cfg = jcore.SIVFConfig(dim=128, n_lists=64, n_slabs=512, capacity=128,
                           n_max=1 << 15, max_chain=32)
    state = jcore.init_state(cfg, jnp.asarray(base[:64]))
    for b0 in range(0, 20_000, 5_000):
        ids = np.arange(b0, b0 + 5_000, dtype=np.int32)
        state = jcore.insert(cfg, state, jnp.asarray(base[ids]),
                             jnp.asarray(ids))
    lists = jcore.probe(state.centroids, jnp.asarray(queries), 32)
    table = jcore.gather_tables(cfg, state, lists)
    rd, rl = jcore.search(cfg, state, jnp.asarray(queries), 10, 32,
                          impl="xla")
    planes = [torch.from_numpy(np.array(getattr(state, n)))
              for n in ("data", "ids", "norms")]
    bitmap = torch.from_numpy(np.array(state.bitmap).view(np.int32))
    pd, pl = ops.sivf_fused_search(torch.from_numpy(queries),
                                   torch.from_numpy(np.array(table)),
                                   *planes, bitmap, 10)
    assert np.array_equal(np.asarray(rl), pl.numpy())
    ref = share_of_limit(np.asarray(rd), np.asarray(rl), base, queries)
    port = share_of_limit(pd.numpy(), pl.numpy(), base, queries)
    assert ref < 0.5, (ref, port)
    assert port <= ref, (ref, port)
