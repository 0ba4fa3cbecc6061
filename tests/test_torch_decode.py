"""The port's dense-cache decode (``init_decode_cache`` + ``decode_step``)
against the reference's ``decode_step`` and against the port's own
``PagedLMEngine``, on the CPU, as ``tests/test_serve.py:31-60`` holds the
reference's engine to its dense decode.

Each family at its ``reduced()`` config (float32), the reference's
parameters (``init_params`` from a key, stripped) carried across by
``interop.params_from_numpy``: Llama (GQA), MiniCPM3 (MLA on latent
pages), RWKV6 and Jamba (Mamba + attention + MoE), and the VLM prefix
(LLaVA) and shared experts (Moonlight) beside them. A prompt of 10 tokens
is decoded token by token from position 0, then 5 more tokens are fed.
What each comparison holds:

  * against the reference's ``decode_step`` (jitted, float32 caches):
    logits at every position within 1e-4 (MoE families 5e-2: top-k
    routing flips near-tied experts when the sums run in another order,
    as the reference's own test allows), and every cache after the last
    step within the same bound (``interop.decode_cache_to_numpy``);
  * against ``PagedLMEngine`` admitting the prompt and fed the same 5
    tokens: logits within the reference test's bound for the family
    (5e-3; Jamba 5e-2, Moonlight 2e-1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import model as JM
from repro.sharding import rules as jrules
from repro.sharding.axes import strip
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.serve.paged_lm import PagedLMEngine
from repro_torch.sharding import rules

PROMPT, FEED, MAX_SEQ = 10, 5, 32
# (arch, bound against the reference's decode_step, bound against the
# paged engine: tests/test_serve.py:21-27)
CASES = [("llama3-8b", 1e-4, 5e-3), ("minicpm3-4b", 1e-4, 5e-3),
         ("rwkv6-3b", 1e-4, 5e-3), ("jamba-v0.1-52b", 5e-2, 5e-2),
         ("llava-next-34b", 1e-4, 5e-3),
         ("moonshot-v1-16b-a3b", 5e-2, 2e-1)]

jdecode = jax.jit(JM.decode_step, static_argnums=(1, 2))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def setup(arch: str):
    jcfg, cfg = JARCHS[arch].reduced(), get_arch(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jplan, plan = jrules.unpadded_plan(jcfg), rules.unpadded_plan(cfg)
    jp = strip(JM.init_params(jcfg, jplan, jax.random.key(1),
                              max_seq=MAX_SEQ))
    params = interop.params_from_numpy(cfg, jax.tree.map(np.array, jp),
                                       device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, PROMPT + FEED).astype(np.int32)
    embeds = None
    if cfg.frontend == "vision_stub":     # the prefix's first positions
        embeds = rng.normal(size=(1, cfg.n_prefix_embeds, cfg.d_model)
                            ).astype(np.float32)
    return jcfg, cfg, jplan, plan, jp, params, toks, embeds


def prefix_at(embeds, pos):
    if embeds is None or pos >= embeds.shape[1]:
        return None
    return embeds[:, pos:pos + 1]


@pytest.mark.parametrize("arch,tol_ref,tol_engine", CASES)
def test_dense_decode_matches_the_reference_and_the_engine(
        arch, tol_ref, tol_engine):
    jcfg, cfg, jplan, plan, jp, params, toks, embeds = setup(arch)
    jc = JM.init_decode_cache(jcfg, jplan, 1, MAX_SEQ, jnp.float32)
    caches = M.init_decode_cache(cfg, plan, 1, MAX_SEQ, device="cpu")
    assert jax.tree.map(np.shape, interop.decode_cache_to_numpy(
        cfg, caches)) == jax.tree.map(np.shape, jc)
    dense, ref_errs = [], []
    for pos, tok in enumerate(toks):
        emb = prefix_at(embeds, pos)
        want, jc = jdecode(jp, jcfg, jplan, jnp.asarray([[tok]]), jc, pos,
                           embeds=None if emb is None else jnp.asarray(emb))
        got, caches = M.decode_step(
            params, cfg, plan, torch.tensor([[tok]], dtype=torch.int32),
            caches, pos, embeds=None if emb is None else t(emb))
        assert got.shape == (1, 1, cfg.vocab_size)
        ref_errs.append(float(np.abs(got[0, 0].numpy()
                                     - np.asarray(want)[0, 0]).max()))
        dense.append(got[0, 0])
    assert max(ref_errs) < tol_ref, ref_errs
    for entry, jentry in zip(interop.decode_cache_to_numpy(cfg, caches), jc):
        for a, b in zip(entry, jentry):
            np.testing.assert_allclose(a, np.asarray(b), rtol=tol_ref,
                                       atol=tol_ref)

    eng = PagedLMEngine(cfg, plan, params, page_size=8, n_pages=32,
                        max_seqs=2, device="cpu")
    assert eng.admit(0, toks[:PROMPT], prefix_embeds=None if embeds is None
                     else t(embeds[0]))
    eng_errs = []
    for i, tok in enumerate(toks[PROMPT:]):
        eng.last_tokens[0, 0] = int(tok)
        eng.step()
        eng_errs.append(float((eng.logits[0, 0]
                               - dense[PROMPT + i]).abs().max()))
    assert max(eng_errs) < tol_engine, eng_errs
    eng.evict(0)
    assert int(eng.pages.free_top) == 32


def test_decode_cache_crosses_to_the_reference_layout():
    """In bf16, as served: every entry has the shape of the reference's
    ``init_decode_cache`` entry; MLA's latent pages cross as the
    reference's ``(latent, rope)`` pair, the first ``kv_lora_rank``
    columns of K's one KV head and then the rest; the bf16 caches come
    back as float32 with their values, and RWKV's ``S`` and Mamba's ``h``
    are float32 already."""
    for arch in ("minicpm3-4b", "rwkv6-3b", "jamba-v0.1-52b"):
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
        jcfg = JARCHS[arch].reduced()
        plan = rules.unpadded_plan(cfg)
        caches = M.init_decode_cache(cfg, plan, 2, 8, device="cpu")
        for parts in caches.values():
            for p in parts:
                p.copy_(torch.randn(p.shape))
        got = interop.decode_cache_to_numpy(cfg, caches)
        want = JM.init_decode_cache(jcfg, jrules.unpadded_plan(jcfg), 2, 8,
                                    jnp.float32)
        assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
        assert all(a.dtype == np.float32 for e in got for a in e)
        kinds, ords = M.layer_kinds(cfg), M.ordinals(cfg)
        for li, kind in enumerate(kinds):
            parts = caches[kind]
            if kind == "attn" and cfg.attention == "mla":
                k = parts[0][ords[li], :, :, 0].float()
                parts = (k[..., :cfg.kv_lora_rank], k[..., cfg.kv_lora_rank:])
            else:
                parts = tuple(p[ords[li]].float() for p in parts)
            entry = got[li % cfg.layer_period]
            for j, p in enumerate(parts):
                assert torch.equal(t(entry[j][li // cfg.layer_period]), p), \
                    (arch, li, j)
