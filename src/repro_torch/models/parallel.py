"""Tensor-parallel execution of the LM on a ``launch.mesh.ModelMesh``: the
port's counterpart of the reference's GSPMD-partitioned ``forward``,
``decode_step`` and train step under a ``ShardPlan``'s rules (as
``ShardMesh.virtual`` is the counterpart of the index's ``shard_map``).

Shards run in turn, in shard order, each on its own blocks; every
exchange between them is a ``launch.mesh.collective``. A computation on
replicated values (a norm, a residual add, the MoE routing of a whole
batch) runs once for each distinct set of input tensors
(``launch.mesh.replicated``): shards of one device that hold the same
tensors share the result, which each would compute equal.

  * **Parameters**: each shard holds its block of every tensor under the
    plan's specs (``launch.specs.shard_params``): column-parallel
    matrices split their output dim (``heads``, ``kv_heads`` where KV
    heads shard, ``mlp``, ``vocab``, ``expert``), row-parallel ones their
    input dim; the rest is replicated.
  * **The batch** splits over the batch rule's axes (``data``, or
    ``pod`` and ``data``); a batch the plan could not shard is replicated.
  * **The residual stream** ``[B_l, S, d]`` is replicated over ``model``,
    or sequence-parallel, ``[B_l, S/m, d]``, where the rules put
    ``seq_sp`` on ``model`` (train, prefill) and ``m`` divides ``S``.
  * **A sublayer** gathers its input over the sequence (sequence
    parallel), runs its column-parallel products on the shard's heads or
    ``mlp`` columns and its row-parallel product on the matching rows,
    and reduces the partial sums over ``model`` in shard order:
    ``reduce_scatter`` back to the sequence split, else ``all_reduce``.
    Attention runs kernel 6 (prefill) and kernel 5 (decode over heads)
    on each shard's heads; a shard's KV heads are its own where they
    shard, else cut or repeated to its q heads (``attention.shard_kv``,
    the reference's ``_maybe_repeat_kv``).
  * **Embedding and head** are vocab-parallel: each shard looks up the
    tokens in its rows and the model axis adds them; each shard's logits
    are its vocab columns, gathered over ``model``.
  * **MoE**: ``mlp.moe_mesh`` (the reference's ``moe``:
    ``apply_moe_shardmap``'s expert-parallel all-to-all where its
    conditions hold, else ``apply_moe`` over the whole batch).
  * **Decode** reads a dense cache laid out by
    ``launch.specs.cache_shardings`` (:func:`init_decode_cache`): on KV
    heads where they shard (kernel 5 per shard), else on ``head_dim``
    (``attention.decode_attn_kv_dh``, plain torch, as the reference's XLA
    path), or on the sequence under rules that map ``kv_seq`` to
    ``model`` (``attention.decode_attn_seqshard``). MLA's latent pages
    are replicated over ``model`` (each shard attends with its heads),
    where the reference shards the latent dim.

The mesh runs the decoder-only attention LMs (GQA or MLA, dense MLPs or
MoE with shared experts, the vision stub's prefix). RWKV6, the Mamba
hybrid and Whisper have their plans (``sharding.rules``) and specs, but
run on one device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ModelMesh, replicated
from repro_torch.launch.specs import param_shardings, shard_params
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import apply_norm, lm_head
from repro_torch.sharding.axes import spec_for
from repro_torch.sharding.rules import ShardPlan
from repro_torch.utils import resolve_device


def check_mesh_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the mesh runs ``cfg``'s
    blocks (see the module docstring)."""
    if cfg.enc_dec or cfg.block != "attn" or \
            cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: block={cfg.block!r} enc_dec={cfg.enc_dec} runs on "
            "one device; the model mesh runs decoder-only attention LMs")


def _axes(rule) -> tuple:
    return () if rule is None else (rule,) if isinstance(rule, str) \
        else tuple(rule)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one step's activations lie: ``batch`` and ``seq`` are the
    global sizes, ``sp`` whether the residual stream is split over the
    sequence."""

    mesh: ModelMesh
    plan: ShardPlan
    batch: int
    seq: int
    sp: bool

    @classmethod
    def of(cls, mesh: ModelMesh, plan: ShardPlan, batch: int, seq: int
           ) -> "Layout":
        rules = plan.rules_dict
        if rules is None or plan.model_size != mesh.shape["model"]:
            raise ValueError(f"a mesh of model {mesh.shape['model']} needs "
                             f"its mesh plan (model_size "
                             f"{plan.model_size}, rules {rules is not None})")
        n = mesh.extent(_axes(rules["batch"]))
        if batch % n:
            raise ValueError(f"batch {batch} does not split over {n} "
                             f"shards ({rules['batch']})")
        m = plan.model_size
        return cls(mesh, plan, batch, seq,
                   rules["seq_sp"] == "model" and seq % m == 0)

    @property
    def batch_axes(self) -> tuple:
        """The axes the batch splits over (``()``: replicated)."""
        return _axes(self.plan.rules_dict["batch"])

    def j(self, s: int) -> int:
        """Shard ``s``'s index on the model axis."""
        return self.mesh.position(s, "model")

    def rows(self, s: int) -> slice:
        n = self.mesh.extent(self.batch_axes)
        k, size = self.mesh.position(s, self.batch_axes), self.batch // n
        return slice(k * size, (k + 1) * size)

    def cols(self, s: int) -> slice:
        """Shard ``s``'s positions of a sequence-parallel stream."""
        size = self.seq // self.plan.model_size
        return slice(self.j(s) * size, (self.j(s) + 1) * size)

    def gather_seq(self, xs: list) -> list:
        """The stream over the whole sequence on every shard."""
        return mesh_mod.collective("all_gather", xs, self.mesh, "model",
                                   dim=1) if self.sp else xs

    def reduce(self, xs: list) -> list:
        """Partial sums over ``model`` -> the stream's layout."""
        if self.sp:
            return mesh_mod.collective("reduce_scatter", xs, self.mesh,
                                       "model", dim=1)
        return mesh_mod.collective("all_reduce", xs, self.mesh, "model")

    def gather_rows(self, xs: list) -> list:
        """Every row of the batch on every shard."""
        if not self.batch_axes:
            return xs
        return mesh_mod.collective("all_gather", xs, self.mesh,
                                   self.batch_axes, dim=0)

    def split(self, t: torch.Tensor) -> list:
        """A global ``[B, ...]`` tensor -> each shard's rows on its
        device."""
        return [t[self.rows(s)].to(self.mesh.devices[s])
                for s in range(self.mesh.size)]


def sharded(params, plan: ShardPlan, mesh: ModelMesh) -> list:
    """Every shard's blocks of ``params`` (a ``DecoderLM``; a list is
    taken as already sharded). A ``"cuda"`` mesh needs a visible card."""
    for d in set(mesh.devices):
        resolve_device(d)
    if isinstance(params, list):
        return params
    return shard_params(params, param_shardings(params, mesh,
                                                plan.rules_dict), mesh)


def norms(lps: list, name: str, xs: list) -> list:
    """Each shard's layer norm ``name`` of its stream."""
    return replicated(apply_norm, [lp[name] for lp in lps], xs)


def add(xs: list, os_: list) -> list:
    """The residual adds."""
    return replicated(torch.add, xs, os_)


def embed(sps: list, cfg: ModelConfig, lay: Layout, tokens: torch.Tensor,
          dtype, prefix: torch.Tensor | None = None) -> list:
    """Vocab-parallel lookup: each shard takes the tokens in its rows of
    the table (others 0) and the model axis adds them; the vision stub's
    ``prefix`` replaces the first positions; then the stream's layout."""
    xs = []
    toks = lay.split(tokens)
    for s, t in enumerate(toks):
        table = sps[s]["embed"]["table"]
        v_l = table.shape[0]
        t = t.long() - lay.j(s) * v_l
        ok = (t >= 0) & (t < v_l)
        x = table[t.clamp(0, v_l - 1)].to(dtype)
        xs.append(torch.where(ok[..., None], x,
                              torch.zeros((), dtype=dtype, device=x.device)))
    xs = mesh_mod.collective("all_reduce", xs, lay.mesh, "model")
    if prefix is not None:
        pre = lay.split(prefix.to(dtype))
        xs = [torch.cat([p, x[:, p.shape[1]:]], dim=1)
              for p, x in zip(pre, xs)]
    if lay.sp:
        xs = [x[:, lay.cols(s)] for s, x in enumerate(xs)]
    return xs


def logits_of(sps: list, cfg: ModelConfig, lay: Layout, xs: list
              ) -> torch.Tensor:
    """Final norm, vocab-parallel head, gathered: ``[B, S, V_pad]`` on the
    first shard's device."""
    hs = lay.gather_seq(norms(sps, "final_norm", xs))
    outs = []
    for s, (sp, h) in enumerate(zip(sps, hs)):
        head = sp["head"] if "head" in sp else sp["embed"]
        outs.append(lm_head(head, h, cfg.vocab_size,
                            row0=lay.j(s) * head["table"].shape[0]))
    outs = mesh_mod.collective("all_gather", outs, lay.mesh, "model",
                               dim=-1)
    return lay.gather_rows(outs)[0]


def _heads(plan: ShardPlan) -> int:
    return plan.n_heads_padded // plan.model_size


def _ffn(lps: list, cfg: ModelConfig, plan: ShardPlan, lay: Layout,
         li: int, hs: list) -> tuple:
    """The feed-forward sublayer: ``(outs, aux or None)``."""
    if cfg.is_moe_layer(li % cfg.layer_period):
        return mlp_mod.moe_mesh([lp["moe"] for lp in lps], cfg, plan, lay,
                                hs)
    hf = lay.gather_seq(hs)
    return lay.reduce([mlp_mod.apply_mlp(lp["mlp"], h, cfg.mlp_act)
                       for lp, h in zip(lps, hf)]), None


def forward(params, cfg: ModelConfig, plan: ShardPlan, batch: dict,
            mesh: ModelMesh, impl: str = "kernel",
            collect_cache: bool = False):
    """``models.model.forward`` on ``mesh``: the same (logits [B,S,V_pad]
    on the first shard's device, aux, caches | None). The caches are one
    list a shard: its ``[(k, v)]`` stacked over the attention layers as
    it computed them (its own KV heads, or all of them where they do not
    shard; MLA's latent and rope key), which :func:`fill_decode_cache`
    writes into a mesh decode cache."""
    check_mesh_supported(cfg)
    sps = sharded(params, plan, mesh)
    tokens = batch["tokens"]
    b, s_len = tokens.shape
    lay = Layout.of(mesh, plan, b, s_len)
    dtype = getattr(torch, cfg.dtype)
    prefix = batch.get("prefix_embeds") if cfg.frontend == "vision_stub" \
        else None
    xs = embed(sps, cfg, lay, tokens, dtype, prefix)
    positions = [torch.arange(s_len, device=d) for d in mesh.devices]
    full = attn.mla_full if cfg.attention == "mla" else attn.gqa_full
    hq = _heads(plan)
    aux = torch.zeros((), dtype=torch.float32, device=mesh.devices[0])
    caches = [[] for _ in range(mesh.size)]
    for li in range(cfg.n_layers):
        lps = [sp["layers"][li] for sp in sps]
        hf = lay.gather_seq(norms(lps, "ln1", xs))
        outs = []
        for s, (lp, h) in enumerate(zip(lps, hf)):
            o, kv = full(lp["attn"], cfg, plan, h, positions[s], causal=True,
                         impl=impl, head0=lay.j(s) * hq)
            outs.append(o)
            if collect_cache:
                caches[s].append(kv)
        xs = add(xs, lay.reduce(outs))
        outs, a = _ffn(lps, cfg, plan, lay, li, norms(lps, "ln2", xs))
        xs = add(xs, outs)
        if a is not None:
            aux = aux + a
    logits = logits_of(sps, cfg, lay, xs)
    if not collect_cache:
        return logits, aux, None
    return logits, aux, [[tuple(torch.stack(p) for p in zip(*c))]
                         for c in caches]


# ---------------------------------------------------------------------------
# decode over a dense cache laid out on the mesh
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, plan: ShardPlan) -> tuple:
    """The spec of a decode cache stack ``[n_attn, B, Smax, Hkv, d]``:
    ``cache_shardings``' K, V spec; MLA's latent pages replicated over
    ``model``."""
    ax = (None, "batch", None, None, None) if cfg.attention == "mla" else \
        (None, "batch", "kv_seq", "kv_heads", "kv_dh")
    return spec_for(ax, plan.rules_dict)


def init_decode_cache(cfg: ModelConfig, plan: ShardPlan, batch: int,
                      max_seq: int, mesh: ModelMesh, dtype=None) -> list:
    """``models.model.init_decode_cache`` on ``mesh``: each shard's
    ``{"attn": (k, v)}``, its block of the stacks under
    :func:`cache_spec`, zero."""
    check_mesh_supported(cfg)
    from repro_torch.models.model import layer_kinds
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    n = layer_kinds(cfg).count("attn")
    hkv, dk, dv = attn.mla_page_dims(cfg) if cfg.attention == "mla" else \
        (plan.n_kv_heads_padded, cfg.head_dim, cfg.head_dim)
    spec = cache_spec(cfg, plan)
    out = []
    for d in set(mesh.devices):
        resolve_device(d)
    for s in range(mesh.size):
        pair = []
        for d in (dk, dv):
            shape = [n, batch, max_seq, hkv, d]
            for i, e in enumerate(spec):
                if e is not None:
                    if shape[i] % mesh.extent(e):
                        raise ValueError(f"cache dim {i} of {shape} does not "
                                         f"split over {e}")
                    shape[i] //= mesh.extent(e)
            pair.append(torch.zeros(shape, dtype=dtype,
                                    device=mesh.devices[s]))
        out.append({"attn": tuple(pair)})
    return out


def fill_decode_cache(caches: list, kvs: list, cfg: ModelConfig,
                      plan: ShardPlan, mesh: ModelMesh) -> list:
    """Write each shard's prefill K, V (``forward(collect_cache=True)``'s
    caches, computed under a plan with the same batch and KV-head split)
    into slots ``0 .. S-1`` of its decode cache block: its ``head_dim``
    columns where ``kv_dh`` shards, its slots where ``kv_seq`` does."""
    rules = plan.rules_dict
    with torch.no_grad():
        for s in range(mesh.size):
            src = kvs[s][0]
            if cfg.attention == "mla":
                src = attn.mla_page_rows(*src)
            for dst, t in zip(caches[s]["attn"], src):
                if rules["kv_dh"] is not None:
                    w = dst.shape[-1]
                    c0 = mesh.position(s, _axes(rules["kv_dh"])) * w
                    t = t[..., c0:c0 + w]
                n_slots = t.shape[2]
                if rules["kv_seq"] is not None:
                    w = dst.shape[2]
                    s0 = mesh.position(s, _axes(rules["kv_seq"])) * w
                    t = t[:, :, s0:min(s0 + w, n_slots)]
                    dst[:, :, :t.shape[2]] = t.to(dst.dtype)
                else:
                    dst[:, :, :n_slots] = t.to(dst.dtype)
    return caches


def decode_step(params, cfg: ModelConfig, plan: ShardPlan,
                tokens: torch.Tensor, caches: list, pos: int,
                mesh: ModelMesh, impl: str = "kernel",
                embeds: torch.Tensor | None = None):
    """``models.model.decode_step`` on ``mesh`` over :func:`init_decode_
    cache`'s blocks (updated in place). Returns (logits [B,1,V_pad] on the
    first shard's device, caches)."""
    check_mesh_supported(cfg)
    from repro_torch.models.model import layer_kinds, ordinals
    sps = sharded(params, plan, mesh)
    dtype = getattr(torch, cfg.dtype)
    lay = Layout.of(mesh, plan, tokens.shape[0], 1)
    rules = plan.rules_dict
    hq = _heads(plan)
    seq_axes = attn._seqshard_axes(plan)
    by_heads = cfg.attention == "mla" or rules["kv_heads"] == "model"
    decode = attn.mla_decode_paged if cfg.attention == "mla" \
        else attn.gqa_decode_paged
    with torch.no_grad():
        if embeds is None:
            xs = embed(sps, cfg, lay, tokens, dtype)
        else:
            xs = [e.to(dtype) for e in lay.split(embeds)]
        windows = [attn.dense_window(x.shape[0], pos, x.device) for x in xs]
        ords = ordinals(cfg)
        for li, kind in enumerate(layer_kinds(cfg)):
            lps = [sp["layers"][li] for sp in sps]
            hs = norms(lps, "ln1", xs)
            a = ords[li]
            kcs = [c["attn"][0][a] for c in caches]
            vcs = [c["attn"][1][a] for c in caches]
            ps = [lp["attn"] for lp in lps]
            if seq_axes is not None and cfg.attention != "mla":
                outs = attn.decode_attn_seqshard(ps, cfg, plan, lay, hs, kcs,
                                                 vcs, pos, seq_axes)
            elif by_heads:
                outs = mesh_mod.collective("all_reduce", [
                    decode(p, cfg, plan, h, kc, vc, *w[:4], write=w[4],
                           impl=impl, head0=lay.j(s) * hq)[0]
                    for s, (p, h, kc, vc, w) in enumerate(
                        zip(ps, hs, kcs, vcs, windows))], mesh, "model")
            else:
                outs = attn.decode_attn_kv_dh(ps, cfg, plan, lay, hs, kcs,
                                              vcs, pos)
            xs = add(xs, outs)
            outs, _ = _ffn(lps, cfg, plan, lay, li, norms(lps, "ln2", xs))
            xs = add(xs, outs)
        logits = logits_of(sps, cfg, lay, xs)
    return logits, caches
