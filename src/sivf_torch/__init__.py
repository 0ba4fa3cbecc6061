"""``sivf_torch`` — the client-facing namespace of the PyTorch port.

    import sivf_torch

    cfg = sivf_torch.SIVFConfig(dim=128, n_lists=4096, n_slabs=16384)
    centroids = sivf_torch.train_kmeans(sample, cfg.n_lists)
    index = sivf_torch.Index(cfg, centroids)       # device="cuda" by default
    report = index.add(vecs, ids)                  # -> MutationReport
    dists, labels = index.search(queries, k=10, nprobe=32)

    cfg = sivf_torch.SIVFConfig(dim=128, n_lists=4096, n_slabs=16384,
                                pq=sivf_torch.PQConfig(m=32),
                                attributes=("tenant", "ts"))
    index = sivf_torch.Index(cfg, centroids).train(sample)
    index.add(vecs, ids, attrs={"tenant": tenant, "ts": ts})
    res = index.search(queries, 10, 32, filter=sivf_torch.Eq("tenant", 7))

    index.save(path)                               # checkpoint format 3
    mesh = sivf_torch.ShardMesh.virtual(4, "cuda")   # 4 shards, one card
    index = sivf_torch.Index.load(path, backend=mesh)   # any shard count
    index.reshard("single")                        # a live handle
    index = sivf_torch.Index.load(path, device_slabs=8192)   # tiered
    index.maintain([sivf_torch.split(3, 9), sivf_torch.recluster(5)])

    index = sivf_torch.Index(cfg, centroids, deferred=True)
    with sivf_torch.ServeEngine(index, default_nprobe=32) as eng:
        eng.session("ingest").add(vecs, ids, attrs=attrs)
        res = eng.session("app").search(qs, k=10).result()

    sivf_torch.telemetry.enable()
    text = sivf_torch.telemetry.render_prometheus()

Everything re-exported here lives in ``repro_torch.core`` and
``repro_torch.serve``. It is the port of
``sivf`` (raw fp32 or PQ payloads, with or without filter attributes,
all-resident or tiered, on one device or sharded over a ``ShardMesh``,
with persistence and elastic resharding, maintenance, the streaming serve
engine and its telemetry, a tiered pool on a mesh included). Nothing it
exports raises ``NotImplementedError``; the paper's comparison baselines
are ``repro_torch.baselines`` (as ``repro.baselines`` sits beside
``sivf``).
"""
from repro_torch.core.api import (  # noqa: F401
    ErrorCode,
    Index,
    IndexProtocol,
    MaintenanceAborted,
    MutationRejected,
    MutationReport,
    PendingReport,
    SearchResult,
)
from repro_torch.core.distributed import (  # noqa: F401
    ShardMesh,
    flatten_live_rows,
    reshard_state,
    search_stacked,
)
from repro_torch.core.filters import (  # noqa: F401
    And,
    CompiledFilter,
    Eq,
    In,
    Range,
    compile_filter,
)
from repro_torch.core.maintenance import (  # noqa: F401
    MaintenanceReport,
    MaintOp,
    merge,
    recluster,
    split,
)
from repro_torch.core.pq import PQConfig, train_pq  # noqa: F401
from repro_torch.core.quantizer import train_kmeans  # noqa: F401
from repro_torch.core.state import (  # noqa: F401
    SIVFConfig,
    init_state,
    memory_report,
)
from repro_torch.serve.quota import (  # noqa: F401
    Backpressure,
    BackpressureKind,
    TenantQuota,
)
from repro_torch.serve.session import (  # noqa: F401
    ClientSession,
    ServeMaintenanceResult,
    ServeMutationResult,
    ServeSearchResult,
)
from repro_torch.serve.sivf_engine import ServeEngine  # noqa: F401

from sivf_torch import telemetry  # noqa: F401  (after repro_torch: no cycle)

__all__ = [
    "And", "Backpressure", "BackpressureKind", "ClientSession",
    "CompiledFilter", "Eq", "ErrorCode", "In", "Index", "IndexProtocol",
    "MaintOp", "MaintenanceAborted", "MaintenanceReport",
    "MutationRejected", "MutationReport", "PendingReport", "PQConfig",
    "Range", "SearchResult", "ServeEngine", "ServeMaintenanceResult",
    "ServeMutationResult", "ServeSearchResult", "ShardMesh", "SIVFConfig",
    "TenantQuota", "compile_filter", "flatten_live_rows", "init_state",
    "memory_report", "merge", "recluster", "reshard_state",
    "search_stacked", "split", "telemetry", "train_kmeans", "train_pq",
]
