"""Plain PyTorch paged decode attention: the oracle for
``csrc/paged_attention.cu``.

Counterpart of ``repro/kernels/paged_attention/ref.py::paged_attention_ref``:
gather every table entry's page (``-1`` pads read page 0 and are masked),
keep the slots of the window ``start <= slot < length``, GQA by
repeating K/V heads (q head h reads KV head ``h // g``), softmax in
float32, and 0 where a row has no live slot. ``dv`` may differ from
``dk``.
"""
from __future__ import annotations

import torch


def check_operands(q, k_pages, v_pages, block_tables, lengths, starts
                   ) -> None:
    """Raise unless q [B,Hq,dk], k/v pages [P,page,Hkv,dk|dv] of q's dtype
    (float32 or bfloat16), int32 tables [B,maxp] and lengths/starts [B],
    with Hkv dividing Hq."""
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"want one float32 or bfloat16 dtype, got "
                         f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.dim() != 4 or \
            k_pages.shape[:3] != v_pages.shape[:3]:
        raise ValueError(f"want q [B,Hq,dk] and pages [P,page,Hkv,d], got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, hq, dk = q.shape
    if k_pages.shape[3] != dk or hq % k_pages.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k pages "
                         f"{tuple(k_pages.shape)}: dk or head grouping "
                         "disagree")
    for name, t, shape in (("block_tables", block_tables, None),
                           ("lengths", lengths, (b,)),
                           ("starts", starts, (b,))):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be [B={b}, maxp], got "
                         f"{tuple(block_tables.shape)}")


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                        starts=None, scale: float | None = None
                        ) -> torch.Tensor:
    """q [B,Hq,dk]; pages [P,page,Hkv,dk|dv]; tables [B,maxp] (-1 pad);
    lengths, starts [B] -> [B,Hq,dv] in q's dtype."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    check_operands(q, k_pages, v_pages, block_tables, lengths, starts)
    b, hq, dk = q.shape
    _, page, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    g = hq // hkv
    scale = dk ** -0.5 if scale is None else scale
    maxp = block_tables.shape[1]
    tab = block_tables.clamp(min=0).long()
    k = k_pages[tab].reshape(b, maxp * page, hkv, dk)       # [B,S,Hkv,dk]
    v = v_pages[tab].reshape(b, maxp * page, hkv, dv)
    pos = torch.arange(maxp * page, device=q.device)[None, :]
    ok = (pos < lengths[:, None]) & (pos >= starts[:, None]) & \
        (block_tables >= 0).repeat_interleave(page, dim=1)
    kq = k.repeat_interleave(g, dim=2).float()               # [B,S,Hq,dk]
    vq = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), kq) * scale
    s = s.masked_fill(~ok[:, None, :], float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhs,bshd->bhd", p, vq).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, lengths,
                              starts=None, scale: float | None = None,
                              n_split: int = 32) -> torch.Tensor:
    """:func:`paged_attention_ref` computed as ``csrc/paged_attention.cu``
    computes it: each sequence's window ``[start, min(length, maxp *
    page))`` is cut into ``n_split`` equal parts of whole 32-slot chunks;
    each part gives a partial ``(m, l, acc)`` (``m = -inf, l = 0`` where
    it holds no live slot), and the partials are merged as
    ``sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i`` over the parts
    with ``l_i > 0`` (0 where none has). Used by the tests."""
    if starts is None:
        starts = torch.zeros_like(lengths)
    check_operands(q, k_pages, v_pages, block_tables, lengths, starts)
    b, hq, dk = q.shape
    _, page, hkv, _ = k_pages.shape
    dv = v_pages.shape[-1]
    g = hq // hkv
    scale = dk ** -0.5 if scale is None else scale
    maxp = block_tables.shape[1]
    n = maxp * page
    tab = block_tables.clamp(min=0).long()
    k = k_pages[tab].reshape(b, n, hkv, dk).repeat_interleave(g, dim=2)
    v = v_pages[tab].reshape(b, n, hkv, dv).repeat_interleave(g, dim=2)
    pos = torch.arange(n, device=q.device)[None, :]
    start = starts.clamp(min=0).long()[:, None]
    end = lengths.clamp(max=n).long()[:, None]
    share = ((end - start).clamp(min=0) + n_split - 1) // n_split
    share = (share + 31) // 32 * 32                          # [B, 1]
    part = torch.where(share > 0, (pos - start) // share.clamp(min=1), -1)
    ok = (pos < end) & (pos >= start) & \
        (block_tables >= 0).repeat_interleave(page, dim=1)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    m, l, acc = [], [], []
    for i in range(n_split):
        si = s.masked_fill(~(ok & (part == i))[:, None, :], float("-inf"))
        mi = si.amax(-1)                                     # [B,Hq]
        p = torch.exp(si - torch.where(torch.isfinite(mi), mi, 0.0)[..., None])
        m.append(mi)
        l.append(p.sum(-1))
        acc.append(torch.einsum("bhs,bshd->bhd", p, v.float()))
    m, l, acc = torch.stack(m, -1), torch.stack(l, -1), torch.stack(acc, 2)
    live = l > 0
    big = torch.where(live, m, float("-inf")).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - torch.where(
        torch.isfinite(big), big, 0.0)), 0.0)
    den = (w * l).sum(-1)[..., None]
    out = (w[..., None] * acc).sum(2)
    return torch.where(den > 0, out / torch.where(den > 0, den, 1.0),
                       0.0).to(q.dtype)
