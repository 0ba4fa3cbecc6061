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
    scan_slabs_topk_pq,
    search,
    stats,
    walk_chains,
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
    maintain,
    merge,
    recluster,
    split,
)
from repro_torch.core.pq import PQConfig, train_pq  # noqa: F401
from repro_torch.core.quantizer import assign, probe, train_kmeans  # noqa: F401
from repro_torch.core.reference import ReferenceIndex  # noqa: F401
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
