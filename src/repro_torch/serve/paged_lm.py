"""Batched LM serving engine over the slab-paged KV cache.

Counterpart of ``repro/serve/paged_lm.py::PagedLMEngine`` for dense GQA
decoders. Requests are admitted via prefill (``admit``: one forward over
the prompt, its K/V written into freshly allocated pages), decoded in
lockstep batches (``step``), and evicted / window-slid in O(1) (``evict``,
``slide``): the paper's streaming lifecycle (ingest / search / evict) at
the KV-cache level. It is independent of the SIVF index path.

K/V pools are one tensor per K and per V, ``[n_layers, n_pages, page,
Hkv, dh]``, so one layer's slice is contiguous for the paged kernel; a
page id indexes every layer's pool (shared block tables). Pools and page
state are updated in place.

``attn_impl``:
  * ``"kernel"`` (default): the ops entry points dispatch by device, so on
    the card prefill runs the flash kernel (TPU kernel 6, as the
    reference's ``forward(impl="pallas")``) and decode the paged kernel
    (TPU kernel 5); on the CPU both take their plain versions;
  * ``"ref"``: the plain versions on any device, named by callers that
    hold the kernels against them (the reference's own
    ``attn_impl="ref"``). Never chosen silently.

The reference's prefill runs ``M.forward`` with ``impl="xla"``, whose
attention computes the same function as the plain version here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import model as M
from repro_torch.models.common import apply_norm, embed_lookup, lm_head
from repro_torch.serve import kv_cache as kvc
from repro_torch.sharding.rules import ShardPlan
from repro_torch.utils import ceil_div, resolve_device


class PagedLMEngine:
    def __init__(self, cfg: ModelConfig, plan: ShardPlan, params: M.DecoderLM,
                 page_size: int = 16, n_pages: int = 128, max_seqs: int = 4,
                 max_pages_per_seq: int = 32, attn_impl: str = "kernel",
                 device="cuda"):
        M.check_supported(cfg)
        attn.check_impl(attn_impl)
        dev = resolve_device(device)
        if params.device.type != dev.type or (
                dev.index is not None and params.device != dev):
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"runs on {dev}")
        self.device = params.device
        self.cfg, self.plan, self.params = cfg, plan, params
        self.attn_impl = attn_impl
        self.kv_cfg = kvc.PagedKVConfig(
            n_pages=n_pages, page_size=page_size,
            max_pages_per_seq=max_pages_per_seq, max_seqs=max_seqs)
        self.pages = kvc.init_page_state(self.kv_cfg, self.device)
        dt = getattr(torch, cfg.dtype)
        shape = (cfg.n_layers, n_pages, page_size, plan.n_kv_heads_padded,
                 cfg.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dt, device=self.device)
        self.last_tokens = torch.zeros((max_seqs, 1), dtype=torch.int32,
                                       device=self.device)
        self.logits = None      # the last decode step's logits [B, 1, V]

    # -- request lifecycle ---------------------------------------------------

    def admit(self, seq_id: int, tokens) -> bool:
        """Prefill ``tokens`` into sequence slot ``seq_id``."""
        cfg = self.cfg
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)[None, :]
        s = toks.shape[1]
        page = self.kv_cfg.page_size
        n_pages = ceil_div(s + 1, page)   # +1: room for the next token
        self.pages, ok = kvc.allocate(self.kv_cfg, self.pages, seq_id,
                                      int(n_pages))
        if not ok:
            return False
        with torch.no_grad():
            logits, _, caches = M.forward(self.params, cfg, self.plan,
                                          {"tokens": toks},
                                          impl=self.attn_impl,
                                          collect_cache=True)
            k, v = caches[0]                    # [n_layers, 1, S, hkv, dh]
            rows = self.pages.tables[seq_id, :n_pages].long()
            pad = n_pages * page - s
            for arr, pool in ((k, self.k_pool), (v, self.v_pool)):
                a = torch.nn.functional.pad(arr[:, 0],
                                            (0, 0, 0, 0, 0, pad))
                pool[:, rows] = a.reshape(a.shape[0], n_pages, page,
                                          *a.shape[2:]).to(pool.dtype)
            self.pages.lengths[seq_id] = s
            self.last_tokens[seq_id, 0] = torch.argmax(logits[0, -1]).to(
                torch.int32)
        return True

    def evict(self, seq_id: int) -> None:
        """O(1) eviction: pages return to the free stack, no copies."""
        self.pages = kvc.evict_seq(self.kv_cfg, self.pages, seq_id)

    def slide(self, seq_id: int, keep_last: int) -> None:
        """Sliding window: drop pages before (length - keep_last)."""
        new_start = (self.pages.lengths[seq_id] - keep_last).clamp(min=0)
        self.pages = kvc.slide_window(self.kv_cfg, self.pages, seq_id,
                                      new_start)

    # -- decode ---------------------------------------------------------------

    def decode(self, tokens: torch.Tensor):
        """One lockstep decode of every sequence slot (the reference's
        ``_decode``): writes each writing row's new K/V into its page slot
        and returns (logits [B, 1, V], next tokens [B, 1] int32, 0 where a
        slot is inactive)."""
        cfg, plan, params, st = self.cfg, self.plan, self.params, self.pages
        dtype = getattr(torch, cfg.dtype)
        with torch.no_grad():
            x = embed_lookup(params.embed, tokens, dtype)
            positions = st.offsets + st.lengths
            write = attn.paged_write_rows(st.tables, st.lengths, st.starts,
                                          self.kv_cfg.page_size)
            for li, lp in enumerate(params.layers):
                h = apply_norm(lp["ln1"], x)
                o, _, _ = attn.gqa_decode_paged(
                    lp["attn"], cfg, plan, h, self.k_pool[li],
                    self.v_pool[li], st.tables, st.lengths, st.starts,
                    positions, impl=self.attn_impl, write=write)
                x = x + o
                h = apply_norm(lp["ln2"], x)
                x = x + mlp_mod.apply_mlp(lp["mlp"], h, cfg.mlp_act)
            x = apply_norm(params.final_norm, x)
            logits = lm_head(params.lm_head_params, x, cfg.vocab_size)
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            nxt = torch.where(st.active, nxt, torch.zeros_like(nxt))
        return logits, nxt[:, None]

    def step(self) -> np.ndarray:
        """Decode one token for every active sequence; the step's logits
        stay in ``self.logits``."""
        page = self.kv_cfg.page_size
        # page-boundary allocation (paper Alg. 2 new-slab path)
        active = self.pages.active.cpu().numpy()
        lengths = self.pages.lengths.cpu().numpy()
        for seq in np.nonzero(active)[0]:
            need = int(kvc.pages_needed(int(lengths[seq]), 1, page))
            if need > 0:
                self.pages, ok = kvc.allocate(self.kv_cfg, self.pages,
                                              int(seq), need)
                if not ok:
                    raise RuntimeError("page pool exhausted (fail-fast)")
        self.logits, nxt = self.decode(self.last_tokens)
        act = self.pages.active
        self.pages.lengths += act.to(torch.int32)
        self.last_tokens = torch.where(act[:, None], nxt, self.last_tokens)
        return nxt[:, 0].cpu().numpy()
