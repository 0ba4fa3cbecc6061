"""``sivf_torch`` — the client-facing namespace of the PyTorch port.

    import sivf_torch

    cfg = sivf_torch.SIVFConfig(dim=128, n_lists=4096, n_slabs=16384)
    centroids = sivf_torch.train_kmeans(sample, cfg.n_lists)
    index = sivf_torch.Index(cfg, centroids)       # device="cuda" by default
    report = index.add(vecs, ids)                  # -> MutationReport
    dists, labels = index.search(queries, k=10, nprobe=32)

Everything re-exported here lives in ``repro_torch.core``. It is the port
of the single-backend, raw-fp32 main path of ``sivf``; what is not ported
yet raises ``NotImplementedError`` naming its ROADMAP.md item.
"""
from repro_torch.core.api import (  # noqa: F401
    ErrorCode,
    Index,
    IndexProtocol,
    MutationRejected,
    MutationReport,
    PendingReport,
    SearchResult,
)
from repro_torch.core.pq import PQConfig  # noqa: F401
from repro_torch.core.quantizer import train_kmeans  # noqa: F401
from repro_torch.core.state import (  # noqa: F401
    SIVFConfig,
    init_state,
    memory_report,
)

__all__ = [
    "ErrorCode", "Index", "IndexProtocol", "MutationRejected",
    "MutationReport", "PendingReport", "PQConfig", "SearchResult",
    "SIVFConfig", "init_state", "memory_report", "train_kmeans",
]
