"""Product-quantization codec: per-subspace codebooks and ADC tables
(PyTorch counterpart of ``repro/core/pq.py``).

A vector is stored as ``m`` one-byte codewords, one per ``dim/m``-wide
subspace, instead of ``dim`` fp32 components. Search never decodes: per
query an *asymmetric distance computation* (ADC) table
``T[s, j] = d(q_s, codebook[s, j])`` is built once, and a candidate's
distance is the sum of its ``m`` table entries in ascending ``s``. The
CUDA kernel (``csrc/sivf_pq_fused_search.cu``) and its plain version
(``kernels/sivf_scan/ref.py``) both sum one materialized table in that
order, so they agree bit for bit.

Conventions (the reference's):
  * ``codebooks``: ``[m, ksub, dsub]`` f32, ``ksub = 2**nbits``,
    ``dsub = dim // m``;
  * ``codes``: ``[..., m]`` uint8, one byte per subspace for any nbits;
  * codeword assignment is the L2-nearest centroid per subspace whatever
    the metric; the metric only changes the ADC table (squared-L2
    partials, or negated partial inner products).

Training cannot reproduce the reference's JAX PRNG stream; codebooks
cross between the packages through ``Index(pq_codebooks=...)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quantizer


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Static PQ configuration: ``m`` subspaces of ``2**nbits`` codewords.

    ``store_raw`` keeps the fp32 payload plane next to the codes; by
    default the codes replace it.
    """

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


def subspaces(xs: torch.Tensor, m: int) -> torch.Tensor:
    """``[..., dim]`` -> ``[..., m, dim//m]`` subspace view."""
    return xs.reshape(*xs.shape[:-1], m, xs.shape[-1] // m)


def train_pq(xs: torch.Tensor, m: int, nbits: int = 8, iters: int = 16,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """K-means per subspace. ``xs [N, dim]`` -> codebooks ``[m, ksub, dsub]``.

    Lloyd's iterations on all ``m`` subspaces at once
    (``quantizer.train_kmeans`` on a ``[m, N, dsub]`` batch), each from its
    own ``ksub`` sample rows drawn with ``generator``, as Faiss's
    ``ProductQuantizer::train`` trains each subspace on its own.
    """
    if xs.shape[-1] % m:
        raise ValueError(f"dim {xs.shape[-1]} not divisible by m={m}")
    sub = subspaces(xs.to(torch.float32), m).transpose(0, 1)   # [m, N, ds]
    return quantizer.train_kmeans(sub, 1 << nbits, iters=iters,
                                  generator=generator)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def encode(codebooks: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace. ``xs [B, dim]`` -> ``[B, m]`` uint8.

    Scores ``||x_s||^2 - 2 x_s.c + ||c||^2`` as the reference does, and
    ``argmin`` takes the first minimum, as ``jnp.argmin`` does.
    """
    m = codebooks.shape[0]
    sub = subspaces(xs.to(torch.float32), m)                   # [B, m, ds]
    dot = torch.einsum("bmd,mkd->bmk", sub, codebooks)
    d = (_sq_norms(sub).unsqueeze(-1) - 2.0 * dot
         + _sq_norms(codebooks).unsqueeze(0))                  # [B, m, K]
    return torch.argmin(d, dim=-1).to(torch.uint8)


def decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct. ``codes [B, m]`` uint8 -> ``[B, dim]`` f32."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codes.device).unsqueeze(0)
    return codebooks[sub, codes.long()].reshape(codes.shape[0], -1)


def adc_tables(codebooks: torch.Tensor, queries: torch.Tensor,
               metric: str = "l2") -> torch.Tensor:
    """Per-query ADC tables. ``queries [Q, dim]`` -> ``[Q, m, ksub]`` f32.

    ``l2``: ``T[q, s, j] = ||q_s - codebook[s, j]||^2`` (expanded as the
    reference does); ``ip``: negated partial inner products, summing to
    ``-<q, decode(code)>``. Build it once per query batch and hand the
    same tensor to whichever implementation scores with it.
    """
    m = codebooks.shape[0]
    q = subspaces(queries.to(torch.float32), m)                # [Q, m, ds]
    dot = torch.einsum("qmd,mkd->qmk", q, codebooks)
    if metric == "ip":
        return -dot
    return (_sq_norms(q).unsqueeze(-1) - 2.0 * dot
            + _sq_norms(codebooks).unsqueeze(0))
