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
    input dim; the rest is replicated. Mamba's ``w_in`` is a pair of
    views, its ``di/m`` columns of each of its two halves
    (``launch.specs.PARTS``).
  * **The batch** splits over the batch rule's axes (``data``, or
    ``pod`` and ``data``); a batch the plan could not shard is replicated.
  * **The residual stream** ``[B_l, S, d]`` is replicated over ``model``,
    or sequence-parallel, ``[B_l, S/m, d]``, where the rules put
    ``seq_sp`` on ``model`` (train, prefill) and ``m`` divides ``S``
    (Whisper's encoder decides it for its own frame count).
  * **A sublayer** gathers its input over the sequence (sequence
    parallel), runs its column-parallel products on the shard's heads or
    ``mlp`` columns and its row-parallel product on the matching rows,
    and reduces the partial sums over ``model`` in shard order:
    ``reduce_scatter`` back to the sequence split, else ``all_reduce``.
    Attention runs kernel 6 (prefill) and kernel 5 (decode over heads)
    on each shard's heads; a shard's KV heads are its own where they
    shard, else cut or repeated to its q heads (``attention.shard_kv``,
    the reference's ``_maybe_repeat_kv``).
  * **RWKV6**: the time mix on a shard's heads (kernel 8 from its block
    of the state ``S``, ``[B, H/m, hs, hs]``), ``w_o`` row-parallel; the
    channel mix's ``w_k`` column-, ``w_v`` row-parallel, the sum over
    ``model`` before the gate of the replicated ``w_r``.
  * **Mamba**: a shard's ``di/m`` channels; ``w_x``'s row-parallel
    ``[B, S, dr + 2n]`` is summed over ``model`` (``all_reduce``), after
    which dt, B and C are replicated; kernel 7 on the shard's channels
    from its block of ``h`` ``[B, di/m, n]``; ``w_out`` row-parallel.
  * **Whisper**: the encoder heads-parallel (non-causal kernel 6 a
    shard), its output gathered to every shard; each shard computes the
    cross-attention's K, V for its own heads from it, kernel 6 with
    ``Sq != Sk`` in prefill, kernel 5 over its block of the cross cache
    in decode. Learned positions and LayerNorms are replicated.
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
    where the reference shards the latent dim. RWKV's ``S`` and Mamba's
    conv and SSM states are each shard's blocks; RWKV's token-shift
    states replicated.

Every architecture of the registry runs here. The one layout refused
(:func:`check_mesh_supported`) is Whisper's decode under rules set by
hand that do not put KV heads on ``model``: no plan makes it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import ModelMesh, replicated
from repro_torch.launch.specs import cache_shardings, param_shardings, \
    shard_params
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import apply_norm, lm_head, sinusoid_positions
from repro_torch.models.model import KINDS, kinds_present, layer_kinds, \
    ordinals
from repro_torch.sharding.axes import spec_for
from repro_torch.sharding.rules import ShardPlan
from repro_torch.utils import resolve_device


def check_mesh_supported(cfg: ModelConfig, plan: ShardPlan) -> None:
    """Raise ``NotImplementedError`` for Whisper's decode where the plan's
    rules do not put its KV heads on ``model``: its cross cache is then
    laid out on ``head_dim`` or the frames, which no decode path here
    reads (every plan ``make_plan`` gives Whisper shards its KV heads)."""
    rules = plan.rules_dict or {}
    if cfg.enc_dec and rules.get("kv_heads") != "model":
        raise NotImplementedError(
            f"{cfg.name}: a cross-attention decode cache off the KV heads "
            f"(kv_heads={rules.get('kv_heads')!r}) is not run on the model "
            "mesh")


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
          dtype, prefix: torch.Tensor | None = None, pos0: int = 0) -> list:
    """Vocab-parallel lookup: each shard takes the tokens in its rows of
    the table (others 0) and the model axis adds them; the vision stub's
    ``prefix`` replaces the first positions; an encoder-decoder adds its
    learned positions ``pos0 ..`` (replicated); then the stream's
    layout."""
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
    if cfg.enc_dec:
        n = tokens.shape[1]
        xs = replicated(lambda x, t: x + t[pos0:pos0 + n].to(dtype)[None],
                        xs, [sp["dec_pos"]["table"] for sp in sps])
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


def attention(lps: list, cfg: ModelConfig, plan: ShardPlan, lay: Layout,
              xs: list, positions: list, causal: bool, impl: str) -> tuple:
    """The attention sublayer (``ln1``, each shard's heads, the sum over
    ``model``, the residual): ``(xs, each shard's cache entry)``."""
    full = attn.mla_full if cfg.attention == "mla" else attn.gqa_full
    hq = _heads(plan)
    hf = lay.gather_seq(norms(lps, "ln1", xs))
    outs, kvs = [], []
    for s, (lp, h) in enumerate(zip(lps, hf)):
        o, kv = full(lp["attn"], cfg, plan, h, positions[s], causal=causal,
                     impl=impl, head0=lay.j(s) * hq)
        outs.append(o)
        kvs.append(kv)
    return add(xs, lay.reduce(outs)), kvs


def cross_attention(lps: list, cfg: ModelConfig, plan: ShardPlan,
                    lay: Layout, xs: list, enc_outs: list, impl: str) -> list:
    """Whisper's cross sublayer (``ln_x``): each shard's K, V of its own
    KV heads from the encoder output, its q heads over them (kernel 6,
    ``Sq != Sk``), the sum over ``model``, the residual."""
    hq = _heads(plan)
    hf = lay.gather_seq(norms(lps, "ln_x", xs))
    kvs = replicated(lambda p, e: attn.cross_kv(p, cfg, plan, e),
                     [lp["xattn"] for lp in lps], enc_outs)
    return add(xs, lay.reduce([
        attn.cross_full(lp["xattn"], cfg, plan, h, kv, impl=impl,
                        head0=lay.j(s) * hq)
        for s, (lp, h, kv) in enumerate(zip(lps, hf, kvs))]))


def time_mix(lps: list, cfg: ModelConfig, plan: ShardPlan, lay: Layout,
             xs: list, states: list | None, impl: str) -> tuple:
    """RWKV6's time-mix sublayer on each shard's heads from its state
    ``(x_prev [B_l,1,d], S [B_l,H/m,hs,hs])`` (``None``: zero):
    ``(xs, each shard's new state)``."""
    hq, hs = _heads(plan), cfg.rwkv_head_size
    hf = lay.gather_seq(norms(lps, "ln1", xs))
    outs, new = [], []
    for s, (lp, h) in enumerate(zip(lps, hf)):
        st = states[s] if states is not None else (
            torch.zeros_like(h[:, :1]),
            torch.zeros((h.shape[0], hq, hs, hs), dtype=torch.float32,
                        device=h.device))
        o, c = rwkv_mod.time_mix(lp["tm"], cfg, plan, h, st, impl=impl,
                                 head0=lay.j(s) * hq)
        outs.append(o)
        new.append(c)
    return add(xs, lay.reduce(outs)), new


def channel_mix(lps: list, lay: Layout, xs: list, states: list | None
                ) -> tuple:
    """RWKV6's channel-mix sublayer (``ln2``) from each shard's token-shift
    state ``[B_l,1,d]`` (``None``: zero): the partial sums over ``mlp``
    added over ``model``, then the replicated gate. ``(xs, new
    states)``."""
    hf = lay.gather_seq(norms(lps, "ln2", xs))
    if states is None:
        states = replicated(lambda h: torch.zeros_like(h[:, :1]), hf)
    summed = lay.reduce([rwkv_mod.channel_mix_partial(lp["cm"], h, st)
                         for lp, h, st in zip(lps, hf, states)])
    gates = replicated(rwkv_mod.channel_mix_gate, [lp["cm"] for lp in lps],
                       hf, states)
    if lay.sp:
        gates = [g[:, lay.cols(s)] for s, g in enumerate(gates)]
    return add(xs, replicated(torch.mul, gates, summed)), \
        [h[:, -1:] for h in hf]


def mamba(lps: list, cfg: ModelConfig, lay: Layout, xs: list,
          states: list | None, impl: str) -> tuple:
    """The Mamba sublayer on each shard's ``di/m`` channels from its state
    ``(conv [B_l,K-1,di/m], h [B_l,di/m,n])`` (``None``: zero); ``w_x``'s
    partial sums added over ``model`` between :func:`mamba.mamba_in` and
    :func:`mamba.mamba_out`. ``(xs, each shard's new state)``."""
    hf = lay.gather_seq(norms(lps, "ln1", xs))
    ins = []
    for s, (lp, h) in enumerate(zip(lps, hf)):
        di = lp["mamba"]["conv_w"].shape[1]
        conv = states[s][0] if states is not None else h.new_zeros(
            (h.shape[0], cfg.mamba_d_conv - 1, di))
        ins.append(mamba_mod.mamba_in(lp["mamba"], h, conv))
    xdbc = mesh_mod.collective("all_reduce", [i[3] for i in ins], lay.mesh,
                               "model")
    outs, new = [], []
    for s, (lp, (xc, z, conv, _)) in enumerate(zip(lps, ins)):
        h0 = states[s][1] if states is not None else torch.zeros(
            (xc.shape[0], xc.shape[2], cfg.mamba_d_state),
            dtype=torch.float32, device=xc.device)
        o, h_new = mamba_mod.mamba_out(lp["mamba"], cfg, xc, z, xdbc[s], h0,
                                       impl)
        outs.append(o)
        new.append((conv, h_new))
    return add(xs, lay.reduce(outs)), new


def encode(params, cfg: ModelConfig, plan: ShardPlan, frames: torch.Tensor,
           mesh: ModelMesh, impl: str = "kernel") -> list:
    """``models.model.encode`` on ``mesh``: Whisper's encoder, heads-
    parallel (non-causal kernel 6 on each shard's heads), its stream
    sequence-parallel only where ``model`` divides the frame count.
    Returns each shard's output over every frame ``[B_l, T, d]``."""
    sps = sharded(params, plan, mesh)
    b, t, _ = frames.shape
    lay = Layout.of(mesh, plan, b, t)
    dtype = getattr(torch, cfg.dtype)
    table = sinusoid_positions(t, cfg.d_model, frames.device).to(dtype)[None]
    xs = [f.to(dtype) + table.to(f.device) for f in lay.split(frames)]
    if lay.sp:
        xs = [x[:, lay.cols(s)] for s, x in enumerate(xs)]
    positions = [torch.arange(t, device=d) for d in mesh.devices]
    for li in range(cfg.n_enc_layers):
        lps = [sp["encoder"]["layers"][li] for sp in sps]
        xs, _ = attention(lps, cfg, plan, lay, xs, positions, False, impl)
        hf = lay.gather_seq(norms(lps, "ln2", xs))
        xs = add(xs, lay.reduce([mlp_mod.apply_mlp(lp["mlp"], h, cfg.mlp_act)
                                 for lp, h in zip(lps, hf)]))
    return lay.gather_seq(replicated(
        apply_norm, [sp["encoder"]["ln_post"] for sp in sps], xs))


def forward(params, cfg: ModelConfig, plan: ShardPlan, batch: dict,
            mesh: ModelMesh, impl: str = "kernel",
            collect_cache: bool = False):
    """``models.model.forward`` on ``mesh``: the same (logits [B,S,V_pad]
    on the first shard's device, aux, caches | None). The caches are one
    list a shard, in ``models.model.forward``'s layout over the kinds the
    model has, each entry the shard's own: attention's ``(k, v)`` as it
    computed them (its own KV heads, or all of them where they do not
    shard; MLA's latent and rope key), RWKV's ``(x_prev, S block, channel
    mix x_prev)``, Mamba's ``(conv block, h block)``; which
    :func:`fill_decode_cache` writes into a mesh decode cache."""
    sps = sharded(params, plan, mesh)
    tokens = batch["tokens"]
    b, s_len = tokens.shape
    lay = Layout.of(mesh, plan, b, s_len)
    dtype = getattr(torch, cfg.dtype)
    prefix = batch.get("prefix_embeds") if cfg.frontend == "vision_stub" \
        else None
    enc_outs = encode(sps, cfg, plan, batch["enc_frames"], mesh, impl) \
        if cfg.enc_dec else None
    xs = embed(sps, cfg, lay, tokens, dtype, prefix)
    positions = [torch.arange(s_len, device=d) for d in mesh.devices]
    aux = torch.zeros((), dtype=torch.float32, device=mesh.devices[0])
    caches = [{k: [] for k in KINDS} for _ in range(mesh.size)]
    for li, kind in enumerate(layer_kinds(cfg)):
        lps = [sp["layers"][li] for sp in sps]
        if kind == "attn":
            xs, new = attention(lps, cfg, plan, lay, xs, positions, True,
                                impl)
            if cfg.enc_dec:
                xs = cross_attention(lps, cfg, plan, lay, xs, enc_outs, impl)
        elif kind == "rwkv":
            xs, new = time_mix(lps, cfg, plan, lay, xs, None, impl)
        else:
            xs, new = mamba(lps, cfg, lay, xs, None, impl)
        if cfg.block == "rwkv" and not cfg.is_moe_layer(
                li % cfg.layer_period):
            xs, cm = channel_mix(lps, lay, xs, None)
            new = [n + (c,) for n, c in zip(new, cm)]
        else:
            outs, a = _ffn(lps, cfg, plan, lay, li, norms(lps, "ln2", xs))
            xs = add(xs, outs)
            if a is not None:
                aux = aux + a
        if collect_cache:
            for c, n in zip(caches, new):
                c[kind].append(n)
    logits = logits_of(sps, cfg, lay, xs)
    if not collect_cache:
        return logits, aux, None
    return logits, aux, [[tuple(torch.stack(p) for p in zip(*c[k]))
                          for k in kinds_present(cfg)] for c in caches]


# ---------------------------------------------------------------------------
# decode over a dense cache laid out on the mesh
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, plan: ShardPlan) -> tuple:
    """The spec of a decode cache stack ``[n_attn, B, Smax, Hkv, d]``:
    ``cache_shardings``' K, V spec (Whisper's cross K, V alike); MLA's
    latent pages replicated over ``model``."""
    ax = (None, "batch", None, None, None) if cfg.attention == "mla" else \
        (None, "batch", "kv_seq", "kv_heads", "kv_dh")
    return spec_for(ax, plan.rules_dict)


def cache_shapes(cfg: ModelConfig, plan: ShardPlan, batch: int,
                 max_seq: int, dtype) -> dict:
    """``{kind: ((shape, dtype, spec), ...)}`` of the whole decode cache
    (``models.model.init_decode_cache``'s stacks) with each stack's spec:
    :func:`cache_spec` for attention, ``launch.specs.cache_shardings``'
    for the recurrent states."""
    kinds = layer_kinds(cfg)
    n = {k: kinds.count(k) for k in KINDS}
    period = cache_shardings(cfg, plan)
    specs = {kind: period[li % cfg.layer_period]
             for li, kind in enumerate(kinds)}
    f32 = torch.float32
    out = {}
    if n["attn"]:
        hkv, dk, dv = attn.mla_page_dims(cfg) if cfg.attention == "mla" \
            else (plan.n_kv_heads_padded, cfg.head_dim, cfg.head_dim)
        sp = cache_spec(cfg, plan)
        seqs = (max_seq, cfg.enc_seq) if cfg.enc_dec else (max_seq,)
        out["attn"] = tuple(((n["attn"], batch, t, hkv, d), dtype, sp)
                            for t in seqs for d in (dk, dv))
    if n["rwkv"]:
        r, hs, d = n["rwkv"], cfg.rwkv_head_size, cfg.d_model
        shapes = ((r, batch, 1, d), (r, batch, plan.n_heads_padded, hs, hs),
                  (r, batch, 1, d))
        out["rwkv"] = tuple(zip(shapes, (dtype, f32, dtype), specs["rwkv"]))
    if n["mamba"]:
        m, di = n["mamba"], cfg.mamba_d_inner
        shapes = ((m, batch, cfg.mamba_d_conv - 1, di),
                  (m, batch, di, cfg.mamba_d_state))
        out["mamba"] = tuple(zip(shapes, (dtype, f32), specs["mamba"]))
    return out


def block_shape(shape: tuple, spec: tuple, mesh: ModelMesh) -> tuple:
    """A shard's block shape of ``shape`` under ``spec``."""
    out = list(shape)
    for i, e in enumerate(spec):
        if e is not None:
            if out[i] % mesh.extent(e):
                raise ValueError(f"dim {i} of {shape} does not split over "
                                 f"{e}")
            out[i] //= mesh.extent(e)
    return tuple(out)


def init_decode_cache(cfg: ModelConfig, plan: ShardPlan, batch: int,
                      max_seq: int, mesh: ModelMesh, dtype=None) -> list:
    """``models.model.init_decode_cache`` on ``mesh``: each shard's dict
    by kind (``attn``: ``(k, v)``, Whisper's ``+ (xk, xv)``; ``rwkv``,
    ``mamba``: the states), its block of every stack under
    :func:`cache_shapes`' specs, zero."""
    if cfg.enc_dec:
        check_mesh_supported(cfg, plan)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    shapes = cache_shapes(cfg, plan, batch, max_seq, dtype)
    for d in set(mesh.devices):
        resolve_device(d)
    return [{kind: tuple(torch.zeros(block_shape(shape, spec, mesh),
                                     dtype=dt, device=mesh.devices[s])
                         for shape, dt, spec in entries)
             for kind, entries in shapes.items()}
            for s in range(mesh.size)]


def fill_decode_cache(caches: list, kvs: list, cfg: ModelConfig,
                      plan: ShardPlan, mesh: ModelMesh) -> list:
    """Write each shard's prefill caches (``forward(collect_cache=True)``'s,
    computed under a plan with the same batch, head and ``mlp`` split)
    into its decode cache block: attention's K, V into slots ``0 ..
    S-1`` (its ``head_dim`` columns where ``kv_dh`` shards, its slots
    where ``kv_seq`` does), the recurrent states as they are."""
    rules = plan.rules_dict
    with torch.no_grad():
        for s in range(mesh.size):
            for kind, src in zip(kinds_present(cfg), kvs[s]):
                if kind != "attn":
                    for dst, t in zip(caches[s][kind], src):
                        dst.copy_(t)
                    continue
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


def fill_cross_cache(params, cfg: ModelConfig, plan: ShardPlan,
                     caches: list, enc_outs: list, mesh: ModelMesh) -> list:
    """``models.model.fill_cross_cache`` on ``mesh``: each shard writes the
    cross K, V of its own KV heads (``attention.cross_kv`` with its
    blocks) of :func:`encode`'s output into its cross cache block."""
    sps = sharded(params, plan, mesh)
    with torch.no_grad():
        for s, (sp, e) in enumerate(zip(sps, enc_outs)):
            xk, xv = caches[s]["attn"][2:]
            for li, lp in enumerate(sp["layers"]):
                k, v = attn.cross_kv(lp["xattn"], cfg, plan, e)
                xk[li] = k.to(xk.dtype)
                xv[li] = v.to(xv.dtype)
    return caches


def _write(pools: list, j: int, new: list) -> None:
    """Shard ``s``'s new state entries into entry ``j`` of its stacks."""
    for ps, ns in zip(pools, new):
        for pool, t in zip(ps, ns):
            pool[j] = t


def decode_step(params, cfg: ModelConfig, plan: ShardPlan,
                tokens: torch.Tensor, caches: list, pos: int,
                mesh: ModelMesh, impl: str = "kernel",
                embeds: torch.Tensor | None = None):
    """``models.model.decode_step`` on ``mesh`` over :func:`init_decode_
    cache`'s blocks (updated in place). Returns (logits [B,1,V_pad] on the
    first shard's device, caches)."""
    if cfg.enc_dec:
        check_mesh_supported(cfg, plan)
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
            xs = embed(sps, cfg, lay, tokens, dtype, pos0=pos)
        else:
            xs = [e.to(dtype) for e in lay.split(embeds)]
        windows = [attn.dense_window(x.shape[0], pos, x.device) for x in xs]
        ords = ordinals(cfg)
        for li, kind in enumerate(layer_kinds(cfg)):
            lps = [sp["layers"][li] for sp in sps]
            a = ords[li]
            if kind == "rwkv":
                pools = [c["rwkv"] for c in caches]
                xs, new = time_mix(lps, cfg, plan, lay, xs,
                                   [(p[0][a], p[1][a]) for p in pools], impl)
                _write([p[:2] for p in pools], a, new)
            elif kind == "mamba":
                pools = [c["mamba"] for c in caches]
                xs, new = mamba(lps, cfg, lay, xs,
                                [(p[0][a], p[1][a]) for p in pools], impl)
                _write(pools, a, new)
            else:
                hs = norms(lps, "ln1", xs)
                kcs = [c["attn"][0][a] for c in caches]
                vcs = [c["attn"][1][a] for c in caches]
                ps = [lp["attn"] for lp in lps]
                if seq_axes is not None and cfg.attention != "mla":
                    outs = attn.decode_attn_seqshard(ps, cfg, plan, lay, hs,
                                                     kcs, vcs, pos, seq_axes)
                elif by_heads:
                    outs = mesh_mod.collective("all_reduce", [
                        decode(p, cfg, plan, h, kc, vc, *w[:4], write=w[4],
                               impl=impl, head0=lay.j(s) * hq)[0]
                        for s, (p, h, kc, vc, w) in enumerate(
                            zip(ps, hs, kcs, vcs, windows))], mesh, "model")
                else:
                    outs = attn.decode_attn_kv_dh(ps, cfg, plan, lay, hs,
                                                  kcs, vcs, pos)
                xs = add(xs, outs)
                if cfg.enc_dec:
                    hx = norms(lps, "ln_x", xs)
                    xs = add(xs, mesh_mod.collective("all_reduce", [
                        attn.cross_decode(lp["xattn"], cfg, plan, h,
                                          c["attn"][2][a], c["attn"][3][a],
                                          impl=impl, head0=lay.j(s) * hq)
                        for s, (lp, h, c) in enumerate(
                            zip(lps, hx, caches))], mesh, "model"))
            if cfg.block == "rwkv" and not cfg.is_moe_layer(
                    li % cfg.layer_period):
                pools = [c["rwkv"] for c in caches]
                xs, cm = channel_mix(lps, lay, xs, [p[2][a] for p in pools])
                _write([p[2:] for p in pools], a, [(c,) for c in cm])
            else:
                outs, _ = _ffn(lps, cfg, plan, lay, li,
                               norms(lps, "ln2", xs))
                xs = add(xs, outs)
        logits = logits_of(sps, cfg, lay, xs)
    return logits, caches
