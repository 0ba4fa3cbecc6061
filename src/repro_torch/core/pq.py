"""Product-quantization configuration (``repro/core/pq.py``'s ``PQConfig``).

Only the dataclass that :class:`~repro_torch.core.state.SIVFConfig` names
is ported so far; the codec (``train_pq`` / ``encode`` / ``decode`` /
``adc_tables``) comes with the PQ slice (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Static PQ configuration: ``m`` subspaces of ``2**nbits`` codewords."""

    m: int
    nbits: int = 8
    store_raw: bool = False

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"pq.m must be >= 1, got {self.m}")
        if not 1 <= self.nbits <= 8:
            raise ValueError(f"pq.nbits must be in [1, 8], got {self.nbits}")

    @property
    def ksub(self) -> int:
        return 1 << self.nbits

    def code_bytes(self) -> int:
        """Stored bytes per vector (one uint8 per subspace)."""
        return self.m
