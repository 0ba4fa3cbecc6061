"""SIVF core for PyTorch: the port of ``repro.core``'s main path."""
from repro_torch.core.state import (  # noqa: F401
    ERR_CHAIN_OVERFLOW,
    ERR_ID_RANGE,
    ERR_POOL_EXHAUSTED,
    SIVFConfig,
    SlabPoolState,
    init_state,
    memory_report,
)
from repro_torch.core.index import (  # noqa: F401
    delete,
    gather_tables,
    insert,
    scan_slabs_topk,
    search,
    stats,
    walk_chains,
)
from repro_torch.core.pq import PQConfig  # noqa: F401
from repro_torch.core.quantizer import assign, probe, train_kmeans  # noqa: F401
from repro_torch.core.api import (  # noqa: F401
    ErrorCode,
    Index,
    IndexProtocol,
    MutationRejected,
    MutationReport,
    PendingReport,
    SearchResult,
)
