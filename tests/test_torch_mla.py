"""MLA on latent pages, shared experts and the vision prefix against the
JAX reference on the CPU, block by block.

At ``minicpm3-4b``'s trait-keeping variant (``test_torch_archs.TRAITS``:
latent 32, rope 8, nope and value heads 16, so the pages' keys are 40
wide, their values 32, and the scale is ``24 ** -0.5``), on one numpy
param tree carried into both packages, in float32:

  * ``mla_full`` (out and its latent / rope-key caches), through the
    flash entry point and through ``mha_ref``, within 1e-5 of the
    reference's (whose attention is its XLA ``_sdpa``); the prefill
    attention takes q, k and v at one width, V zero-padded, at the
    query/key scale;
  * ``mla_absorbed_parts`` and ``mla_absorbed_out`` within 1e-5;
  * the absorbed decode over latent pages against the expanded form
    (``mla_full`` at the same position) within 1e-5, and the paged call's
    scale ``qk_head_dim ** -0.5``, not its key width's;
  * the engine's latent pools' shapes.

``llava-next-34b``'s prefix embeddings change the logits as the
reference's do; ``interop`` carries MLA's groups and the MoE's nested
``shared`` group both ways. The engines of all three against the
reference's are in ``tests/test_torch_archs.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import model as JM
from repro.sharding import rules as jrules
from repro_torch import interop
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.serve.paged_lm import PagedLMEngine
from repro_torch.sharding import rules
from test_torch_archs import prefix_of, variants
from test_torch_rwkv import ENGINE, close, jtree, numpy_tree

B, S = 2, 21


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def mla():
    """The MLA variant, one numpy tree, the port's params, layer 1's
    attention group on both sides, and an input ``x [B,S,d]``."""
    jcfg, cfg = variants("minicpm3-4b")
    tree = numpy_tree(jcfg, jrules.unpadded_plan(jcfg), 21)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), tree["layers"][0]["attn"])
    params = interop.params_from_numpy(cfg, tree, device="cpu")
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jplan=jrules.unpadded_plan(jcfg),
                plan=rules.unpadded_plan(cfg), tree=tree, params=params,
                jp=jp, p=params.layers[1]["attn"], x=x)


jmla_full = jax.jit(jattn.mla_full, static_argnums=(1, 2))
jabsorbed_parts = jax.jit(jattn.mla_absorbed_parts, static_argnums=(1, 2))
jabsorbed_out = jax.jit(jattn.mla_absorbed_out, static_argnums=1)
jforward = jax.jit(JM.forward, static_argnums=(1, 2))


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_mla_full_matches_the_reference(mla, impl):
    cfg, pos = mla["cfg"], np.arange(S)
    jo, (jlat, jrope) = jmla_full(mla["jp"], mla["jcfg"], mla["jplan"],
                                  jnp.asarray(mla["x"]), jnp.asarray(pos))
    o, (lat, rope) = attn.mla_full(mla["p"], cfg, mla["plan"], t(mla["x"]),
                                   t(pos), impl=impl)
    assert lat.shape == (B, S, cfg.kv_lora_rank)
    assert rope.shape == (B, S, cfg.qk_rope_dim)
    close(o, jo)
    close(lat, jlat)
    close(rope, jrope)


def test_mla_prefill_pads_v_to_the_key_width(mla, monkeypatch):
    """The flash entry point gets q, k and v ``[B,H,S,qk_head_dim]``, V's
    columns past ``v_head_dim`` zero, and the query/key scale; the padding
    columns of its output are dropped."""
    cfg, seen = mla["cfg"], []
    orig = fops.flash_attention

    def spy(q, k, v, causal=True, scale=None):
        seen.append((q.shape, k.shape, v.clone(), causal, scale))
        return orig(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(fops, "flash_attention", spy)
    o, _ = attn.mla_full(mla["p"], cfg, mla["plan"], t(mla["x"]),
                         torch.arange(S))
    (qs, ks, v, causal, scale), = seen
    w, h = cfg.qk_head_dim, cfg.n_heads
    assert qs == ks == v.shape == (B, h, S, w) and causal
    assert w > cfg.v_head_dim
    assert bool((v[..., cfg.v_head_dim:] == 0).all())
    assert bool((v[..., :cfg.v_head_dim] != 0).any())
    assert scale == w ** -0.5
    assert o.shape == (B, S, cfg.d_model)


def test_mla_absorbed_parts_and_out_match_the_reference(mla):
    cfg = mla["cfg"]
    x = mla["x"][:, :1]
    pos = np.array([[5], [17]], np.int32)
    jq, jlat, jrope = jabsorbed_parts(mla["jp"], mla["jcfg"], mla["jplan"],
                                      jnp.asarray(x), jnp.asarray(pos))
    q, lat, rope = attn.mla_absorbed_parts(mla["p"], cfg, mla["plan"], t(x),
                                           t(pos))
    assert q.shape == (B, 1, cfg.n_heads,
                       cfg.kv_lora_rank + cfg.qk_rope_dim)
    close(q, jq)
    close(lat, jlat)
    close(rope, jrope)
    ctx = np.random.default_rng(6).normal(
        size=(B, 1, cfg.n_heads, cfg.kv_lora_rank)).astype(np.float32)
    out = attn.mla_absorbed_out(mla["p"], cfg, t(ctx))
    assert out.shape == (B, 1, cfg.n_heads, cfg.v_head_dim)
    close(out, jabsorbed_out(mla["jp"], mla["jcfg"], jnp.asarray(ctx)))


def test_absorbed_decode_equals_the_expanded_form(mla, monkeypatch):
    """Latent pages filled from ``mla_full``'s caches of the first S - 1
    tokens (window starting at slot 3 for sequence 1), then the absorbed
    decode of token S - 1: its output within 1e-5 of the expanded
    attention's over the same window, the new slot holding ``latent (+)
    rope`` and ``latent``, and the paged call at scale ``qk_head_dim **
    -0.5``."""
    cfg, plan, p = mla["cfg"], mla["plan"], mla["p"]
    page, maxp = 4, 6
    x, pos = t(mla["x"]), torch.arange(S)
    full, (lat, rope) = attn.mla_full(p, cfg, plan, x, pos)
    starts = torch.tensor([0, 3], dtype=torch.int32)
    # the expanded form over the window [start, S): the full sequence's
    # attention with the keys before ``start`` masked out
    q, k, v, _ = attn._mla_qkv(p, cfg, plan, x, pos)
    sc = torch.einsum("bhd,bthd->bht", q[:, -1], k) * cfg.qk_head_dim ** -0.5
    sc = sc.masked_fill(pos[None, None] < starts[:, None, None].long(),
                        float("-inf"))
    o = torch.einsum("bht,bthv->bhv", torch.softmax(sc, -1), v)
    want = attn.dense(p["wo"], o.reshape(B, 1, -1))
    close(want[0], full[0, -1:])                 # a whole window: mla_full
    dk, dv = cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank
    kp = torch.zeros((B * maxp, page, 1, dk))
    vp = torch.zeros((B * maxp, page, 1, dv))
    tables = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp)
    keys = torch.cat([lat, rope], -1)
    for b in range(B):
        for s in range(S - 1):
            kp[tables[b, s // page], s % page, 0] = keys[b, s]
            vp[tables[b, s // page], s % page, 0] = lat[b, s]
    lengths = torch.full((B,), S - 1, dtype=torch.int32)
    write = attn.paged_write_rows(tables, lengths, starts, page)
    seen, orig = [], pops.paged_attention

    def spy(*args, scale=None):
        seen.append(scale)
        return orig(*args, scale=scale)

    monkeypatch.setattr(pops, "paged_attention", spy)
    got, kp, vp = attn.mla_decode_paged(p, cfg, plan, x[:, -1:], kp, vp,
                                        tables, lengths, starts,
                                        lengths.clone(), write)
    assert seen == [cfg.qk_head_dim ** -0.5] and dk ** -0.5 != seen[0]
    close(got, want)
    last = tables[:, (S - 1) // page].long()
    close(kp[last, (S - 1) % page, 0], keys[:, -1])
    close(vp[last, (S - 1) % page, 0], lat[:, -1])


def test_mla_engine_holds_latent_pages(mla):
    cfg = mla["cfg"]
    eng = PagedLMEngine(cfg, mla["plan"], mla["params"], device="cpu",
                        **ENGINE)
    shape = (cfg.n_layers, ENGINE["n_pages"], ENGINE["page_size"], 1)
    assert tuple(eng.k_pool.shape) == shape + (
        cfg.kv_lora_rank + cfg.qk_rope_dim,)
    assert tuple(eng.v_pool.shape) == shape + (cfg.kv_lora_rank,)
    assert eng.admit(0, np.arange(1, 12))
    assert int(eng.pages.lengths[0]) == 11
    eng.step()
    assert eng.logits.shape == (ENGINE["max_seqs"], 1, cfg.vocab_size)


def test_prefix_embeds_change_logits_as_the_references_do():
    """The prefix is live input: logits with prefix ``e`` and ``e + 1``
    differ, from each other and from the bare tokens', each within 1e-5 of
    the reference's (``tests/test_models.py``'s
    ``test_vlm_prefix_replaces_embeddings``)."""
    jcfg, cfg = variants("llava-next-34b")
    tree = numpy_tree(jcfg, jrules.unpadded_plan(jcfg), 23)
    params = interop.params_from_numpy(cfg, tree, device="cpu")
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size,
                                             (B, 11)).astype(np.int32)
    pre = prefix_of(cfg, 10, batch=B)
    out = []
    for batch in ({"tokens": toks}, {"tokens": toks, "prefix_embeds": pre},
                  {"tokens": toks, "prefix_embeds": pre + 1.0}):
        jl, _, _ = jforward(jtree(tree), jcfg, jrules.unpadded_plan(jcfg),
                            jtree(batch))
        logits, _, _ = M.forward(params, cfg, rules.unpadded_plan(cfg),
                                 {k: t(a) for k, a in batch.items()})
        close(logits, jl)
        out.append(logits)
    for a, b in ((out[0], out[1]), (out[1], out[2])):
        assert float((a - b).abs().max()) > 1e-6


@pytest.mark.parametrize("name", ["minicpm3-4b", "moonshot-v1-16b-a3b"])
def test_interop_round_trips_the_new_groups(name):
    """A numpy tree crosses into the port and back ``==``; stored in bf16,
    the latent norms stay float32 and the shared experts take bf16."""
    jcfg, cfg = variants(name)
    tree = numpy_tree(jcfg, jrules.unpadded_plan(jcfg), 25)
    back = interop.params_to_numpy(cfg, interop.params_from_numpy(
        cfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    small = interop.params_from_numpy(cfg, tree, device="cpu",
                                      dtype=torch.bfloat16)
    layer = small.layers[0]
    if cfg.attention == "mla":
        assert layer["attn"]["q_ln"].dtype == torch.float32
        assert layer["attn"]["kv_ln"].dtype == torch.float32
        assert layer["attn"]["w_ukv"].dtype == torch.bfloat16
        assert set(tree["layers"][0]["attn"]) == set(layer["attn"])
    else:
        shared = layer["moe"]["shared"]
        assert {k: v.dtype for k, v in shared.items()} == dict.fromkeys(
            ("w_up", "w_down", "w_gate"), torch.bfloat16)
        assert shared["w_up"].shape == (cfg.d_model,
                                        cfg.n_shared_experts * cfg.moe_d_ff)
    want = interop.params_to_numpy(cfg, M.init_params(
        dataclasses.replace(cfg, dtype="bfloat16"), rules.unpadded_plan(cfg),
        seed=0, device="cpu"))
    assert jax.tree.map(np.shape, want) == jax.tree.map(np.shape, tree)
