"""The decoder-only architectures registered beside Llama, and the MoE
combine in a fixed order, against the JAX reference on the CPU.

``qwen3-14b`` (per-head QK-RMSNorm), ``phi3-medium-14b`` (4 query heads per
KV head over an odd KV-head count), ``granite-moe-3b-a800m`` (head dim
64 with 3 query heads per KV head; MoE top-8 of 40), ``minicpm3-4b``
(MLA: latent pages whose key width, latent + rope, differs from the
value's, the latent, and from the query/key head width that sets the
scale), ``moonshot-v1-16b-a3b`` (MoE top-6 plus 2 shared experts) and
``llava-next-34b`` (7 query heads per KV head; 4 image-patch prefix
embeddings) at reduced variants that keep each trait:
``ModelConfig.reduced()`` makes every config 4 heads over at most 2 KV
heads, every MoE top-2 of 4 and MLA's latent as wide as its nope head, so
the variants are ``dataclasses.replace``-d back on both packages. Per
architecture:

  * the config ``==`` the reference's, full and reduced, and the port's
    ``init_params`` tree of the variant has the reference's leaf shapes;
  * ``forward`` logits within 1e-5 on one numpy param tree (LLaVA's with
    prefix embeddings);
  * ``PagedLMEngine`` against the reference's engine on one traffic (the
    RWKV test's ``serve_both``: admits, LLaVA's first with its prefix,
    teacher-forced steps, slide, evict, re-admit): page state ``==``
    after every operation, the K/V pools (MLA's latent pages) and step
    logits within 1e-4, next tokens ``==``.

The MoE combine (``models/mlp.py``'s ``combine``) adds each token's kept
terms in ascending expert order with a rounding after each add, the order
the reference's scatter-add takes on the CPU, and Moonlight's shared
experts' output is added after that sum: held bit for bit in bf16
against an explicit fold over the expert-sorted pairs, then the shared
output, and against the reference's ``apply_moe`` in float32 at top-8 of
40.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as JARCHS
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.sharding import rules as jrules
from repro.sharding.axes import strip
from repro_torch import interop
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.flash_attention import flash_attention as fkernel
from repro_torch.kernels.paged_attention import paged_attention as pkernel
from repro_torch.models import mlp
from repro_torch.models import model as M
from repro_torch.sharding import rules
from test_torch_rwkv import check_served, close, jtree, numpy_tree, serve_both

NEW = ("qwen3-14b", "phi3-medium-14b", "granite-moe-3b-a800m",
       "minicpm3-4b", "moonshot-v1-16b-a3b", "llava-next-34b")
TRAITS = {
    "qwen3-14b": {},                                 # reduced() keeps qk_norm
    "phi3-medium-14b": dict(n_heads=20, n_kv_heads=5),
    "granite-moe-3b-a800m": dict(n_heads=6, n_kv_heads=2, head_dim=64,
                                 n_experts=40, moe_top_k=8),
    # latent 32: pages of keys 32 + 8 and values 32, scale 24 ** -0.5
    "minicpm3-4b": dict(kv_lora_rank=32),
    "moonshot-v1-16b-a3b": dict(n_experts=12, moe_top_k=6),  # + 2 shared
    "llava-next-34b": dict(n_heads=14, n_kv_heads=2),        # 4 prefix
}


def variants(name: str):
    """(reference config, port config) of ``name``'s trait-keeping reduced
    variant."""
    return (dataclasses.replace(JARCHS[name].reduced(), **TRAITS[name]),
            dataclasses.replace(get_arch(name).reduced(), **TRAITS[name]))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def test_registry_holds_the_three_and_not_the_rest():
    # whisper-base, the last, is registered too (tests/test_torch_whisper.py):
    # the port's registry is the reference's
    assert set(NEW) <= set(ARCHS) and set(ARCHS) == set(JARCHS)
    traits = {name: get_arch(name) for name in NEW}
    assert traits["qwen3-14b"].qk_norm
    assert traits["phi3-medium-14b"].n_heads // \
        traits["phi3-medium-14b"].n_kv_heads == 4
    g = traits["granite-moe-3b-a800m"]
    assert (g.head_dim, g.n_heads // g.n_kv_heads, g.n_experts,
            g.moe_top_k, g.n_shared_experts) == (64, 3, 40, 8, 0)
    m = traits["minicpm3-4b"]
    assert (m.attention, m.kv_lora_rank + m.qk_rope_dim, m.kv_lora_rank,
            m.qk_head_dim, m.v_head_dim) == ("mla", 288, 256, 96, 64)
    k = traits["moonshot-v1-16b-a3b"]
    assert (k.n_experts, k.moe_top_k, k.n_shared_experts) == (64, 6, 2)
    v = traits["llava-next-34b"]
    assert (v.frontend, v.n_prefix_embeds, v.n_heads // v.n_kv_heads) == \
        ("vision_stub", 576, 7)
    for name in NEW[3:]:                 # the variants keep the traits
        jcfg, cfg = variants(name)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    m, k, v = (variants(name)[1] for name in NEW[3:])
    assert m.kv_lora_rank + m.qk_rope_dim != m.kv_lora_rank != \
        m.qk_head_dim != m.kv_lora_rank + m.qk_rope_dim
    assert m.v_head_dim < m.qk_head_dim
    assert k.moe_top_k > 2 and k.n_experts > 4 and k.n_shared_experts == 2
    assert v.n_prefix_embeds == 4 and v.n_heads // v.n_kv_heads == 7


@pytest.mark.parametrize("name", NEW)
def test_config_and_param_shapes_match_the_reference(name):
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(JARCHS[name])
    assert get_arch(name).param_count() == JARCHS[name].param_count()
    jcfg, cfg = variants(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.qk_norm == (name == "qwen3-14b")
    assert (cfg.attention == "mla") == (name == "minicpm3-4b")
    M.check_supported(get_arch(name))               # blocks all ported
    want = strip(jax.eval_shape(
        lambda k: JM.init_params(jcfg, jrules.unpadded_plan(jcfg), k),
        jax.random.key(0)))
    got = interop.params_to_numpy(cfg, M.init_params(
        cfg, rules.unpadded_plan(cfg), seed=0, device="cpu"))
    shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert jax.tree.map(lambda a: tuple(a.shape), got) == shapes


@pytest.fixture(scope="module", params=NEW)
def arch(request):
    """An architecture's variant, one numpy param tree, and the port's
    parameters carried from it."""
    jcfg, cfg = variants(request.param)
    tree = numpy_tree(jcfg, jrules.unpadded_plan(jcfg), 3)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, tree=tree,
                params=interop.params_from_numpy(cfg, tree, device="cpu"))


def prefix_of(cfg, seed: int, batch: int | None = None):
    """The vision stub's prefix embeddings (``[batch,] n_img, d``) from
    ``seed``, or None for a config without them."""
    if not cfg.n_prefix_embeds:
        return None
    shape = (cfg.n_prefix_embeds, cfg.d_model)
    return np.random.default_rng(seed).normal(
        size=shape if batch is None else (batch,) + shape).astype(np.float32)


def test_forward_logits_match_the_reference(arch):
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    toks = np.random.default_rng(5).integers(1, cfg.vocab_size,
                                             (2, 19)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.n_prefix_embeds:
        batch["prefix_embeds"] = prefix_of(cfg, 8, batch=2)
    jl, jaux, _ = jax.jit(JM.forward, static_argnums=(1, 2))(
        jtree(arch["tree"]), jcfg, jrules.unpadded_plan(jcfg), jtree(batch))
    logits, aux, _ = M.forward(arch["params"], cfg, rules.unpadded_plan(cfg),
                               {k: t(a) for k, a in batch.items()})
    close(logits, jl)
    close(aux, jaux)


def test_engine_matches_the_reference_after_each_operation(arch):
    jcfg, cfg = arch["jcfg"], arch["cfg"]
    fkernel.launches = pkernel.launches = 0
    log = serve_both(jcfg, jrules.unpadded_plan(jcfg), cfg,
                     rules.unpadded_plan(cfg), arch["tree"], arch["params"],
                     seed=12, prefix=prefix_of(cfg, 9))
    check_served(log, cfg)
    assert fkernel.launches == pkernel.launches == 0      # CPU: plain


# ---------------------------------------------------------------------------
# the MoE combine in a fixed order
# ---------------------------------------------------------------------------

def moe_case(name: str, kind: str, dtype):
    """An MoE layer's parameters (``numpy_tree``'s) and tokens of the
    variant, the router as drawn ("random"), all zero (every probability
    ties: the top k are the lowest experts) or biased towards expert 2
    (over capacity)."""
    jcfg, cfg = variants(name) if name in TRAITS else (
        JARCHS[name].reduced(), get_arch(name).reduced())
    tree = numpy_tree(jcfg, jrules.unpadded_plan(jcfg), 7)
    layer = next(ly for ly in tree["layers"] if "moe" in ly)
    p = jax.tree.map(lambda a: np.array(a[0]), layer["moe"])
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    if kind == "ties":
        p["router"][:] = 0
    elif kind == "overflow":
        x = np.abs(x)
        p["router"][:, 2] = 4.0 / cfg.d_model ** 0.5
    tp = jax.tree.map(lambda a: torch.nn.Parameter(t(a).to(dtype),
                                                   requires_grad=False), p)
    return jcfg, cfg, p, tp, t(x).to(dtype)


def fold_over_sorted_pairs(tp, cfg, x):
    """The MoE output by an explicit loop: the (token, choice) pairs
    stably sorted by expert, those ranked below capacity run through the
    expert in one buffer, then each added onto its token, pair by pair in
    that order, a rounding to ``x.dtype`` after each add; last the shared
    experts' SwiGLU output, where there are shared experts."""
    plan = rules.unpadded_plan(cfg)
    n, d, k = x.shape[0] * x.shape[1], x.shape[-1], cfg.moe_top_k
    xf = x.reshape(n, d)
    _, topw, tope = mlp.moe_route(tp, cfg, plan, xf)
    cap = mlp.capacity(cfg, n)
    pairs = sorted(range(n * k), key=lambda i: int(tope.reshape(-1)[i]))
    rank, seen = {}, {}
    for i in pairs:
        e = int(tope.reshape(-1)[i])
        rank[i] = seen.get(e, 0)
        seen[e] = rank[i] + 1
    buf = x.new_zeros((cfg.n_experts, cap, d))
    for i in pairs:
        if rank[i] < cap:
            buf[int(tope.reshape(-1)[i]), rank[i]] = xf[i // k]
    hh = F.silu(torch.bmm(buf, tp["w_gate"])) * torch.bmm(buf, tp["w_up"])
    out = torch.bmm(hh, tp["w_down"])
    y = x.new_zeros((n, d))
    for i in pairs:
        e = int(tope.reshape(-1)[i])
        if rank[i] < cap:
            term = out[e, rank[i]] * topw.reshape(-1)[i].to(x.dtype)
            y[i // k] = y[i // k] + term
    y = y.reshape(x.shape)
    if "shared" in tp:
        sh = tp["shared"]
        y = y + (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]
    return y, tope, cap


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("kind", ["random", "ties", "overflow"])
def test_moe_combine_is_the_ascending_expert_fold(name, kind):
    _, cfg, _, tp, x = moe_case(name, kind, torch.bfloat16)
    got, _ = mlp.apply_moe(tp, cfg, rules.unpadded_plan(cfg), x)
    want, tope, cap = fold_over_sorted_pairs(tp, cfg, x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    load = torch.bincount(tope.reshape(-1), minlength=cfg.n_experts)
    if kind == "ties":
        assert (tope == torch.arange(cfg.moe_top_k)).all()
    if kind in ("ties", "overflow"):
        assert int(load.max()) > cap          # some pairs are dropped
    assert ("shared" in tp) == (cfg.n_shared_experts > 0)


def test_moe_combine_folds_from_zero_in_column_order():
    terms = torch.tensor([[[-0.0], [-0.0]], [[1.0], [2.0 ** -9]],
                          [[2.0 ** -9], [1.0]]], dtype=torch.bfloat16)
    y = mlp.combine(terms)
    assert [float(v) for v in y[:, 0]] == [0.0, 1.0, 1.0]
    assert not torch.signbit(y[0, 0])             # +0.0 + -0.0 is +0.0
    # 1 + 2^-8 is a tie in bf16 and rounds to even, 1; 2^-8 + 2^-8 + 1
    # is exact: the order shows where three terms are added
    three = torch.tensor([[[1.0], [2.0 ** -8], [2.0 ** -8]]],
                         dtype=torch.bfloat16)
    assert float(mlp.combine(three)[0, 0]) == 1.0
    assert float(mlp.combine(three.flip(1))[0, 0]) == 1.0 + 2.0 ** -7


@pytest.mark.parametrize("kind", ["random", "ties", "overflow"])
def test_apply_moe_matches_the_reference_at_top8_of_40(kind):
    jcfg, cfg, p, tp, x = moe_case("granite-moe-3b-a800m", kind,
                                   torch.float32)
    jo, jaux = jax.jit(jmlp.apply_moe, static_argnums=(1, 2))(
        jtree(p), jcfg, jrules.unpadded_plan(jcfg), jnp.asarray(x.numpy()))
    o, aux = mlp.apply_moe(tp, cfg, rules.unpadded_plan(cfg), x)
    close(o, jo)
    close(aux, jaux)
