"""Batched LM serving engine over the slab-paged KV cache.

Counterpart of ``repro/serve/paged_lm.py::PagedLMEngine`` for the
decoder-only models the port runs: dense GQA or MLA attention (MoE and
the vision stub's prefix included), RWKV6, and the hybrid Mamba +
attention + MoE stack. Requests are admitted via prefill
(``admit``: one forward over the prompt, its K/V written into freshly
allocated pages and its recurrent states into the sequence's slot),
decoded in lockstep batches (``step``), and evicted / window-slid in O(1)
(``evict``, ``slide``): the paper's streaming lifecycle (ingest / search
/ evict) at the KV-cache level. It is independent of the SIVF index path.

Pools, laid out as the reference engine lays them out, per layer kind:

  * attention layers: K and V pools ``[n_attn, n_pages, page, Hkv, dh]``,
    indexed by the layer's ordinal among the attention layers, so one
    layer's slice is contiguous for the paged kernel; a page id indexes
    every layer's pool (shared block tables). MLA's are the absorbed
    latent pages, one shared "KV head": K ``[..., 1, kv_lora + qk_rope]``
    (latent (+) rope key) and V ``[..., 1, kv_lora]`` (the latent);
  * RWKV6 layers (``state["rwkv"]``): time-mix ``x_prev`` ``[n, max_seqs,
    1, d]``, ``S`` float32 ``[n, max_seqs, H, hs, hs]`` and channel-mix
    ``x_prev`` ``[n, max_seqs, 1, d]``;
  * Mamba layers (``state["mamba"]``): conv state ``[n, max_seqs, K-1,
    di]`` and ``h`` float32 ``[n, max_seqs, di, n_state]``.

Every sequence slot has its recurrent state; pages are allocated for an
RWKV6 sequence too, as the reference does, and ``slide`` moves only page
state (an RNN has no window). Pools and page state are updated in place.
Decode runs every slot, as the reference's ``_decode`` does: an inactive
slot's recurrent state moves on too (and is overwritten by its next
admit), and its token joins the MoE routing.

``attn_impl`` picks the arithmetic of every kernel on the path:
  * ``"kernel"`` (default): the ops entry points dispatch by device, so on
    the card prefill runs the flash kernel (TPU kernel 6), and the WKV6
    and selective-scan kernels (TPU kernels 8 and 7) from a zero state,
    and decode the paged kernel (TPU kernel 5) and the two recurrence
    kernels at T = 1 from the carried state; on the CPU all take their
    plain versions;
  * ``"ref"``: the plain versions on any device, named by callers that
    hold the kernels against them (the reference's own
    ``attn_impl="ref"``). Never chosen silently.

The reference's prefill runs ``M.forward`` with ``impl="xla"``, whose
attention and recurrences compute the same functions as the plain
versions here (its recurrences chunk T, so it admits only prompts whose
length a chunk divides; the port admits any length).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import model as M
from repro_torch.models import rwkv as rwkv_mod
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
        self.kinds, self.ordinals = M.layer_kinds(cfg), M.ordinals(cfg)
        count = {k: self.kinds.count(k) for k in M.KINDS}
        hkv, dk, dv = plan.n_kv_heads_padded, cfg.head_dim, cfg.head_dim
        if cfg.attention == "mla":
            hkv, dk, dv = attn.mla_page_dims(cfg)
        shape = (count["attn"], n_pages, page_size, hkv)
        self.k_pool = torch.zeros(shape + (dk,), dtype=dt, device=self.device)
        self.v_pool = torch.zeros(shape + (dv,), dtype=dt, device=self.device)

        def pools(n, states):       # [n * max_seqs, ...] -> [n, max_seqs, ...]
            return tuple(t.reshape(n, max_seqs, *t.shape[1:]) for t in states)
        self.state = {}      # kind -> recurrent-state pools, see above
        if count["rwkv"]:
            n = count["rwkv"]
            xs, s = rwkv_mod.init_time_mix_state(cfg, plan, n * max_seqs, dt,
                                                 self.device)
            self.state["rwkv"] = pools(n, (xs, s, torch.zeros_like(xs)))
        if count["mamba"]:
            n = count["mamba"]
            self.state["mamba"] = pools(n, mamba_mod.init_mamba_state(
                cfg, n * max_seqs, dt, self.device))
        self.last_tokens = torch.zeros((max_seqs, 1), dtype=torch.int32,
                                       device=self.device)
        self.logits = None      # the last decode step's logits [B, 1, V]

    # -- request lifecycle ---------------------------------------------------

    def admit(self, seq_id: int, tokens, prefix_embeds=None) -> bool:
        """Prefill ``tokens`` into sequence slot ``seq_id``; for the vision
        stub, ``prefix_embeds`` [n_img, d] replace the embeddings of the
        first ``n_img`` tokens."""
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
        batch = {"tokens": toks}
        if prefix_embeds is not None:
            batch["prefix_embeds"] = torch.as_tensor(
                prefix_embeds, device=self.device)[None]
        with torch.no_grad():
            logits, _, caches = M.forward(self.params, cfg, self.plan, batch,
                                          impl=self.attn_impl,
                                          collect_cache=True)
            caches = dict(zip(M.kinds_present(cfg), caches))
            if "attn" in caches:
                k, v = caches["attn"]            # [n_attn, 1, S, hkv, dh]
                if cfg.attention == "mla":       # latent [.., lat], rope
                    k, v = attn.mla_page_rows(k, v)
                rows = self.pages.tables[seq_id, :n_pages].long()
                pad = n_pages * page - s
                for arr, pool in ((k, self.k_pool), (v, self.v_pool)):
                    a = torch.nn.functional.pad(arr[:, 0],
                                                (0, 0, 0, 0, 0, pad))
                    pool[:, rows] = a.reshape(a.shape[0], n_pages, page,
                                              *a.shape[2:]).to(pool.dtype)
            for kind, pools in self.state.items():  # [n, 1, ...] each
                for pool, c in zip(pools, caches[kind]):
                    pool[:, seq_id] = c[:, 0].to(pool.dtype)
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
        and every slot's new recurrent states into its pools, and returns
        (logits [B, 1, V], next tokens [B, 1] int32, 0 where a slot is
        inactive)."""
        cfg, plan, params, st = self.cfg, self.plan, self.params, self.pages
        with torch.no_grad():
            x = embed_lookup(params.embed, tokens, getattr(torch, cfg.dtype))
            positions = st.offsets + st.lengths
            write = attn.paged_write_rows(
                st.tables, st.lengths, st.starts, self.kv_cfg.page_size) \
                if self.k_pool.shape[0] else None
            for li, lp in enumerate(params.layers):
                kind, j = self.kinds[li], self.ordinals[li]
                pools = self.state.get(kind, ())
                x, _, new = M.apply_layer(
                    lp, cfg, plan, li, kind, x,
                    functools.partial(self._attend, j, positions, write),
                    tuple(pool[j] for pool in pools) or None,
                    impl=self.attn_impl)
                for pool, c in zip(pools, new or ()):
                    pool[j] = c
            x = apply_norm(params.final_norm, x)
            logits = lm_head(params.lm_head_params, x, cfg.vocab_size)
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            nxt = torch.where(st.active, nxt, torch.zeros_like(nxt))
        return logits, nxt[:, None]

    def _attend(self, j, positions, write, p, h):
        """Attention layer ``j``'s decode over its page pools (updated in
        place), for :func:`models.model.apply_layer`."""
        st = self.pages
        decode = attn.mla_decode_paged if self.cfg.attention == "mla" \
            else attn.gqa_decode_paged
        o, _, _ = decode(
            p, self.cfg, self.plan, h, self.k_pool[j], self.v_pool[j],
            st.tables, st.lengths, st.starts, positions, write=write,
            impl=self.attn_impl)
        return o, None

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
