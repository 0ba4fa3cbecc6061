"""Float32 raw-distance error of the reference's search and of the port's
fused fold against float64, on the CPU, at the chip workload's size.

``chip_smoke.py`` holds SIVF's kernel 1 to a 1e-5 distance limit (``RTOL``:
``|d - exact| <= 1e-5 + 1e-5 |exact|``) and reads how much of it the
float32 ``|q|^2 - 2 q.x + |x|^2`` uses against float64. This script asks
whether the reference's own search uses as much on the same construction:
1M x 128 rows of the chip workload's mixture (2,048 centres ``N(0, 3^2)``
plus unit noise, from a numpy seed, as ``chip_smoke.make_data`` draws
them), IVF 4,096 lists (centroids: 4,096 of the rows, not k-means: only the
routing depends on them), ingested into the reference's pool in 16,384-row
batches; then ``--queries`` queries of the same mixture searched at k 10,
nprobe 32 by the reference (``core.search(impl="xla")``) and by the
port's plain fused fold (``kernels.sivf_scan.ops.sivf_fused_search`` on
CPU tensors, the function kernel 1 is held to bit for bit) over the
reference's own planes and tables. The fold sums ``q . x`` and
``||q||^2`` over d in eight float32 lanes, term d into lane d mod 8, then
the lanes pairwise (``ref.dot_lanes``); XLA's dot sums in its own
blocks. Each returned distance is held to the float64 distance of its
(query, row) pair; the share of the limit used (the largest, and the
mean) is printed for both, with the labels' agreement. The script also
prints, for each order of ``ORDERS``, the shares the fold would use if
it summed ``q . x`` and ``||q||^2`` in that order, emulated in numpy on
the same rows with the pool's stored norms: ``L`` lanes (term d into
lane d mod L, the lanes then added pairwise), or blocks of ``B`` terms
(each block summed in one chain from ``+0.0`` and added into a running
total: two accumulators a query). Eight lanes is the port's own order,
and the script checks that its emulation equals the fold bit for bit.
About 3 GB of memory and a few minutes::

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/fp32_distance_error.py
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

RTOL = 1e-5                      # chip_smoke.RTOL
# Emulated orders of the float32 sum over d: ("lanes", L) or ("blocks", B).
ORDERS = (("lanes", 1), ("lanes", 2), ("lanes", 4), ("lanes", 8),
          ("lanes", 16), ("blocks", 8), ("blocks", 16), ("blocks", 32))


def share(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| / (RTOL + RTOL |want|) at the finite ``want``."""
    fin = np.isfinite(want)
    return (np.abs(got.astype(np.float64) - want)
            / (RTOL + RTOL * np.abs(want)))[fin]


def over_limit(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / (RTOL + RTOL |want|) over finite ``want``."""
    return float(share(got, want).max())


def lane_sum(q: np.ndarray, x: np.ndarray, lanes: int) -> np.ndarray:
    """float32 ``q . x`` over the last axis in ``lanes`` lanes (a power of
    two): term d into lane d mod lanes, one rounded product and one
    rounded sum a term, then the lanes added pairwise."""
    acc = [np.zeros(np.broadcast_shapes(q.shape, x.shape)[:-1], np.float32)
           for _ in range(lanes)]
    for d in range(x.shape[-1]):
        acc[d % lanes] = acc[d % lanes] + q[..., d] * x[..., d]
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
    return acc[0]


def block_sum(q: np.ndarray, x: np.ndarray, block: int) -> np.ndarray:
    """float32 ``q . x`` over the last axis in blocks of ``block`` terms:
    each block summed in one chain from +0.0 (one rounded product and one
    rounded sum a term), then added into a running total from +0.0."""
    total = np.zeros(np.broadcast_shapes(q.shape, x.shape)[:-1], np.float32)
    for b0 in range(0, x.shape[-1], block):
        part = np.zeros_like(total)
        for d in range(b0, min(b0 + block, x.shape[-1])):
            part = part + q[..., d] * x[..., d]
        total = total + part
    return total


def emulated_sum(q: np.ndarray, x: np.ndarray, order) -> np.ndarray:
    kind, n = order
    return lane_sum(q, x, n) if kind == "lanes" else block_sum(q, x, n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=256)
    args = ap.parse_args(argv)
    import jax.numpy as jnp
    import sivf_torch  # noqa: F401  (the core first: the kernels import it)
    import torch

    from repro import core as jcore
    from repro_torch.kernels.sivf_scan import ops

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    centres = rng.normal(scale=3.0, size=(2048, 128)).astype(np.float32)
    which = rng.integers(0, len(centres), args.rows + args.queries)
    x = centres[which] + rng.normal(size=(len(which), 128)).astype(
        np.float32)
    base, queries = x[:args.rows], x[args.rows:]
    cfg = jcore.SIVFConfig(dim=128, n_lists=4096, n_slabs=16384,
                           capacity=128, n_max=1 << 21, max_chain=32)
    cents = base[rng.choice(args.rows, 4096, replace=False)]
    state = jcore.init_state(cfg, jnp.asarray(cents))
    for b0 in range(0, args.rows, 16384):
        ids = np.arange(b0, min(b0 + 16384, args.rows), dtype=np.int32)
        state = jcore.insert(cfg, state, jnp.asarray(base[ids]),
                             jnp.asarray(ids))
    build_s = time.perf_counter() - t0
    k, nprobe = 10, 32
    out = {"rows": args.rows, "queries": args.queries, "k": k,
           "nprobe": nprobe, "build_s": build_s}
    lists = jcore.probe(state.centroids, jnp.asarray(queries), nprobe,
                        cfg.metric)
    table = jcore.gather_tables(cfg, state, lists)
    rd, rl = jcore.search(cfg, state, jnp.asarray(queries), k, nprobe,
                          impl="xla")
    planes = {n: torch.from_numpy(np.asarray(getattr(state, n)))
              for n in ("data", "ids", "norms")}
    bitmap = torch.from_numpy(np.asarray(state.bitmap).view(np.int32))
    pd, pl = ops.sivf_fused_search(
        torch.from_numpy(queries), torch.from_numpy(np.asarray(table)),
        planes["data"], planes["ids"], planes["norms"], bitmap, k)
    q64 = queries.astype(np.float64)
    for name, (d, lab) in {"reference_xla": (np.asarray(rd), np.asarray(rl)),
                           "port_fused_fold": (pd.numpy(), pl.numpy())
                           }.items():
        rows = base[np.clip(lab, 0, None)].astype(np.float64)
        exact = ((q64[:, None, :] - rows) ** 2).sum(-1)
        exact[lab < 0] = np.inf
        out[name] = {"dist_err_over_limit": over_limit(d, exact),
                     "mean_err_over_limit": float(share(d, exact).mean()),
                     "max_abs_err": float(np.abs(d - exact)[
                         np.isfinite(exact)].max())}
    out["labels_equal_share"] = float((np.asarray(rl) == pl.numpy()).mean())
    lab = pl.numpy()
    live = lab >= 0
    rows = base[np.clip(lab, 0, None)]                      # [Q, k, D]
    exact = ((q64[:, None, :] - rows.astype(np.float64)) ** 2).sum(-1)
    exact[~live] = np.inf
    at = np.clip(lab, 0, None)
    norms = np.asarray(state.norms)[np.asarray(state.att_slab)[at],
                                    np.asarray(state.att_slot)[at]]
    for order in ORDERS:
        dot = emulated_sum(queries[:, None, :], rows, order)
        qq = emulated_sum(queries, queries, order)[:, None]
        d = (qq - np.float32(2.0) * dot) + norms
        name = f"emulated_{order[1]}_{order[0]}"
        out[name] = {"dist_err_over_limit": over_limit(d, exact),
                     "mean_err_over_limit": float(share(d, exact).mean())}
        if order == ("lanes", 8):
            out["emulated_8_lanes_equals_port"] = bool(
                np.array_equal(d[live], pd.numpy()[live]))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
