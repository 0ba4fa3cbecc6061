"""SIVF slab-pool state (paper §3.1), PyTorch counterpart of
``repro/core/state.py``.

The state is a dataclass of preallocated dense tensors on one device: the
same 23 planes, in the same order and with the same dtypes as the
reference, except that the validity bitmap is stored as ``int32`` words
with the reference's uint32 bits (``core/bitmap.py``). With ``cfg.pq``
the uint8 ``codes`` plane holds each slot's PQ codewords (and ``data`` is
zero-width unless ``store_raw``); with ``cfg.attributes`` the int32
``attrs`` plane holds each slot's filter attributes. The mutation
functions of ``core/index.py`` update these planes in place where the
reference donated its buffers to ``jit``.

Integer planes stay int32; code casts to int64 only where it indexes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.pq import PQConfig
from repro_torch.utils import resolve_device

@dataclasses.dataclass(frozen=True)
class SIVFConfig:
    """Static configuration; field names and defaults mirror the reference.

    ``device_slabs`` (the tiered pool, ``core/tiered.py``) keeps that many
    cache frames of payload on the device; the canonical payload planes
    (``data`` / ``codes`` / ``attrs``) then live on the host.
    """

    dim: int                       # vector dimensionality D
    n_lists: int                   # number of IVF lists (coarse centroids)
    n_slabs: int                   # slab pool size (pre-allocated)
    capacity: int = 128            # C: slots per slab (paper uses 32)
    n_max: int = 1 << 20           # dense external-id space [0, n_max)
    metric: str = "l2"             # "l2" or "ip"
    max_chain: int = 64            # slabs walked per list (Alg. 3 bound)
    track_tables: bool = True      # dense list->slab tables
    dtype: torch.dtype = torch.float32
    pq: PQConfig | None = None     # product-quantized payloads (core/pq.py)
    attributes: tuple[str, ...] = ()  # named int32 filter attributes
    device_slabs: int | None = None  # tiered mode: cache frames on device

    def __post_init__(self):
        bm.n_words(self.capacity)  # validates capacity
        if self.metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric {self.metric}")
        if self.dtype != torch.float32:
            raise ValueError(f"dtype must be torch.float32, got {self.dtype}")
        if self.device_slabs is not None and not (
                1 <= self.device_slabs <= self.n_slabs):
            raise ValueError(
                f"device_slabs must be in [1, n_slabs={self.n_slabs}], got "
                f"{self.device_slabs}")
        if self.pq is not None and self.dim % self.pq.m:
            raise ValueError(
                f"dim {self.dim} not divisible by pq.m {self.pq.m}")
        attrs = tuple(self.attributes)
        if len(set(attrs)) != len(attrs) or any(
                not (a and isinstance(a, str)) for a in attrs):
            raise ValueError(
                f"attributes must be unique non-empty names, got {attrs}")
        object.__setattr__(self, "attributes", attrs)

    @property
    def words(self) -> int:
        return bm.n_words(self.capacity)

    @property
    def pool_vectors(self) -> int:
        return self.n_slabs * self.capacity

    @property
    def payload_dim(self) -> int:
        """Width of the fp32 ``data`` plane: 0 when PQ codes replace it."""
        return 0 if (self.pq is not None and not self.pq.store_raw) \
            else self.dim

    @property
    def code_m(self) -> int:
        """Width of the uint8 ``codes`` plane (0 when PQ is disabled)."""
        return self.pq.m if self.pq is not None else 0

    @property
    def n_attrs(self) -> int:
        """Width of the int32 ``attrs`` plane (0 when filtering is off)."""
        return len(self.attributes)

    @property
    def codebook_shape(self) -> tuple[int, int, int]:
        """Shape of the ``pq_codebooks`` plane: ``[m, ksub, dim // m]``."""
        if self.pq is None:
            return (0, 0, 0)
        return (self.pq.m, self.pq.ksub, self.dim // self.pq.m)

    @property
    def tiered(self) -> bool:
        """True when the payload planes are host-resident (device_slabs)."""
        return self.device_slabs is not None

    @property
    def payload_slabs(self) -> int:
        """Leading dim of the *device* payload planes: 0 in tiered mode,
        where the canonical planes live on the host and the device keeps
        ``device_slabs`` cache frames (``core/tiered.py``)."""
        return 0 if self.tiered else self.n_slabs


PLANES = (
    "data", "ids", "norms", "bitmap", "nxt", "prv", "owner", "cursor",
    "live", "heads", "free_stack", "free_top", "att_slab", "att_slot",
    "n_live", "error", "centroids", "tables", "table_len", "table_pos",
    "codes", "pq_codebooks", "attrs",
)


@dataclasses.dataclass
class SlabPoolState:
    """Device-resident SIVF index state. All shapes static.

    Plane order matches the reference's registered data fields
    (``PLANES``); see ``repro/core/state.py`` for each plane's meaning.
    """

    data: torch.Tensor        # [n_slabs, C, payload_dim] f32 payloads
    ids: torch.Tensor         # [n_slabs, C] int32 external ids
    norms: torch.Tensor       # [n_slabs, C] f32 cached ||x||^2
    bitmap: torch.Tensor      # [n_slabs, W] int32 validity words
    nxt: torch.Tensor         # [n_slabs] int32 next-slab pointer (-1 = end)
    prv: torch.Tensor         # [n_slabs] int32 prev-slab pointer (-1 = head)
    owner: torch.Tensor       # [n_slabs] int32 owning list id (-1 = free)
    cursor: torch.Tensor      # [n_slabs] int32 allocation watermark
    live: torch.Tensor        # [n_slabs] int32 live-slot count
    heads: torch.Tensor       # [n_lists] int32 head slab id (-1 = empty)
    free_stack: torch.Tensor  # [n_slabs] int32
    free_top: torch.Tensor    # [] int32 number of free slabs
    att_slab: torch.Tensor    # [n_max] int32 (-1 = INVALID)
    att_slot: torch.Tensor    # [n_max] int32
    n_live: torch.Tensor      # [] int32 total live vectors
    error: torch.Tensor       # [] int32 sticky error bits
    centroids: torch.Tensor   # [n_lists, D] f32
    tables: torch.Tensor      # [n_lists, max_chain] int32 slab ids (-1 pad)
    table_len: torch.Tensor   # [n_lists] int32 chain length
    table_pos: torch.Tensor   # [n_slabs] int32 position in its table
    codes: torch.Tensor       # [n_slabs, C, code_m] uint8 PQ codewords
    pq_codebooks: torch.Tensor  # [m, ksub, dim // m] f32 trained codebooks
    attrs: torch.Tensor       # [n_slabs, C, n_attrs] int32 attribute stamps

    @property
    def device(self) -> torch.device:
        return self.data.device


ERR_POOL_EXHAUSTED = 1
ERR_ID_RANGE = 2
ERR_CHAIN_OVERFLOW = 4


def clear_error(state: SlabPoolState) -> SlabPoolState:
    """Return ``state`` with the sticky error bits zeroed (a new scalar)."""
    return dataclasses.replace(state, error=torch.zeros_like(state.error))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))


def init_state(cfg: SIVFConfig, centroids, pq_codebooks=None, device="cuda"
               ) -> SlabPoolState:
    """Fresh empty pool on ``device``. ``centroids`` [n_lists, D].

    With ``cfg.pq`` set, ``pq_codebooks`` ``[m, ksub, dim//m]`` carries the
    trained subspace codebooks (``core.pq.train_pq``); omitted, the plane
    is zeros and must be trained before ingest (``Index.train``).
    """
    dev = resolve_device(device)
    cents = _as_tensor(centroids)
    if tuple(cents.shape) != (cfg.n_lists, cfg.dim):
        raise ValueError(
            f"centroids shape {tuple(cents.shape)} != "
            f"{(cfg.n_lists, cfg.dim)}")
    cb_shape = cfg.codebook_shape
    if pq_codebooks is None:
        cb = torch.zeros(cb_shape, dtype=torch.float32, device=dev)
    else:
        cb = _as_tensor(pq_codebooks)
        if tuple(cb.shape) != cb_shape:
            raise ValueError(
                f"pq_codebooks shape {tuple(cb.shape)} != {cb_shape}")
        cb = cb.to(device=dev, dtype=torch.float32, copy=True)
    ns, c, w = cfg.n_slabs, cfg.capacity, cfg.words
    i32 = dict(dtype=torch.int32, device=dev)
    ps = cfg.payload_slabs
    return SlabPoolState(
        data=torch.zeros((ps, c, cfg.payload_dim), dtype=cfg.dtype,
                         device=dev),
        ids=torch.full((ns, c), -1, **i32),
        norms=torch.zeros((ns, c), dtype=torch.float32, device=dev),
        bitmap=torch.zeros((ns, w), **i32),
        nxt=torch.full((ns,), -1, **i32),
        prv=torch.full((ns,), -1, **i32),
        owner=torch.full((ns,), -1, **i32),
        cursor=torch.zeros((ns,), **i32),
        live=torch.zeros((ns,), **i32),
        heads=torch.full((cfg.n_lists,), -1, **i32),
        free_stack=torch.arange(ns, **i32),
        free_top=torch.tensor(ns, **i32),
        att_slab=torch.full((cfg.n_max,), -1, **i32),
        att_slot=torch.zeros((cfg.n_max,), **i32),
        n_live=torch.tensor(0, **i32),
        error=torch.tensor(0, **i32),
        # copy, never alias: mutations update the state in place
        centroids=cents.to(device=dev, dtype=cfg.dtype, copy=True),
        tables=torch.full((cfg.n_lists, cfg.max_chain), -1, **i32),
        table_len=torch.zeros((cfg.n_lists,), **i32),
        table_pos=torch.full((ns,), -1, **i32),
        codes=torch.zeros((ps, c, cfg.code_m), dtype=torch.uint8, device=dev),
        pq_codebooks=cb,
        attrs=torch.zeros((ps, c, cfg.n_attrs), **i32),
    )


def host_live_mask(cfg: SIVFConfig, bitmap) -> np.ndarray:
    """Unpack validity bitmaps to a host-side bool mask, slot-ordered.

    Accepts any ``[..., words]`` bitmap (a tensor or an array, int32 or
    uint32 words) and returns ``[..., capacity]`` bool.
    """
    if isinstance(bitmap, torch.Tensor):
        bitmap = bitmap.cpu().numpy()
    words = np.asarray(bitmap)
    words = words.view(np.uint32) if words.dtype == np.int32 \
        else words.astype(np.uint32)
    shifts = np.arange(bm.WORD_BITS, dtype=np.uint32)
    bits = ((words[..., None] >> shifts) & np.uint32(1)) != 0
    return bits.reshape(*words.shape[:-1], cfg.capacity)


def memory_report(cfg: SIVFConfig) -> dict:
    """Structural-overhead accounting (paper §5.6.2 / Fig. 12).

    Same keys and byte math as the reference: the payload is the fp32
    ``data`` plane (zero-width under PQ unless ``store_raw``) plus the
    uint8 code plane; attributes count raw on both sides of
    ``compression_ratio``. In tiered mode (``cfg.device_slabs``) the
    payload planes are ``host_bytes`` and the device holds the metadata
    and ``device_slabs`` cache frames (``device_cache_bytes``);
    ``total_bytes`` is always ``host_bytes + device_bytes``.
    """
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    slots = cfg.n_slabs * cfg.capacity
    payload = slots * cfg.payload_dim * itemsize
    codes = slots * cfg.code_m
    attrs = slots * cfg.n_attrs * 4
    raw_equiv = slots * cfg.dim * itemsize + attrs
    codebooks = cfg.pq.m * cfg.pq.ksub * (cfg.dim // cfg.pq.m) * 4 \
        if cfg.pq is not None else 0
    ids = slots * 4
    norms = slots * 4
    headers = cfg.n_slabs * (cfg.words * 4 + 4 * 6)  # bitmap + 6 int32 fields
    att = cfg.n_max * 8
    heads = cfg.n_lists * 4
    stack = cfg.n_slabs * 4
    tables = (cfg.n_lists * cfg.max_chain + cfg.n_lists + cfg.n_slabs) * 4 \
        if cfg.track_tables else 0
    stored = payload + codes + attrs
    metadata = codebooks + ids + norms + headers + att + heads + stack + tables
    per_slab = cfg.capacity * (cfg.payload_dim * itemsize + cfg.code_m
                               + cfg.n_attrs * 4)
    cache = cfg.device_slabs * per_slab if cfg.tiered else 0
    host = stored if cfg.tiered else 0
    device = metadata + cache + (0 if cfg.tiered else stored)
    total = host + device
    return {
        "payload_bytes": int(payload),
        "code_bytes": int(codes),
        "attr_bytes": int(attrs),
        "codebook_bytes": int(codebooks),
        "compression_ratio": float(raw_equiv / stored) if stored else 1.0,
        "metadata_bytes": int(metadata),
        "host_bytes": int(host),
        "device_bytes": int(device),
        "device_cache_bytes": int(cache),
        "total_bytes": int(total),
        "overhead_frac_vs_payload": float((total - stored) / max(stored, 1)),
    }
