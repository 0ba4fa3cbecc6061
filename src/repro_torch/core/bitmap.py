"""Packed validity bitmaps (paper §3.1), stored as int32 words.

Each slab carries a C-bit validity bitmap of ``C // 32`` words, with the
same bits as the reference's uint32 plane (``repro/core/bitmap.py``).
PyTorch's ``uint32`` lacks most operators on CPU and CUDA, so the port
stores the words as ``int32``; ``interop.py`` reinterprets the bits at the
boundary. Bit 31 makes a word negative, which is harmless: bits are read
with ``(w >> s) & 1`` (an arithmetic shift keeps bit ``s`` in place) and
set or cleared only through the masks in :data:`_BIT`.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32

# 1 << s for s in [0, 32) with the uint32 bits reinterpreted as int32
# (bit 31 is INT32_MIN), so no shift ever overflows a signed int
_BIT_NP = np.left_shift(np.uint32(1), np.arange(WORD_BITS, dtype=np.uint32)
                        ).view(np.int32)


def n_words(capacity: int) -> int:
    if capacity % WORD_BITS != 0:
        raise ValueError(
            f"slab capacity {capacity} must be a multiple of {WORD_BITS}")
    return capacity // WORD_BITS


def slot_word_bit(slot: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose slot index -> (word index, int32 bit mask)."""
    bits = torch.from_numpy(_BIT_NP).to(slot.device)
    return slot // WORD_BITS, bits[(slot % WORD_BITS).long()]


def get_bits(bitmap: torch.Tensor, slab: torch.Tensor, slot: torch.Tensor
             ) -> torch.Tensor:
    """Read validity bits for coordinates. bitmap [n_slabs, W]; returns bool."""
    word, bit = slot_word_bit(slot)
    return (bitmap[slab.long(), word.long()] & bit) != 0


def unpack_batch(bitmap_rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """Unpack [..., W] words -> [..., capacity] bool mask (slot-ordered)."""
    w = n_words(capacity)
    shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                          device=bitmap_rows.device)
    bits = ((bitmap_rows.unsqueeze(-1) >> shifts) & 1) != 0
    return bits.reshape(*bitmap_rows.shape[:-1], w * WORD_BITS)


def unpack(bitmap_row: torch.Tensor, capacity: int) -> torch.Tensor:
    """Unpack one slab's words -> [capacity] bool mask (slot-ordered)."""
    return unpack_batch(bitmap_row, capacity)


def popcount_rows(bitmap: torch.Tensor) -> torch.Tensor:
    """Per-slab population count. bitmap [n_slabs, W] -> [n_slabs] int32."""
    return unpack_batch(bitmap, bitmap.shape[-1] * WORD_BITS).sum(
        -1, dtype=torch.int32)
