"""The port's Whisper (encoder, cross-attention, dense-cache decode)
against the JAX reference, on the CPU.

``whisper-base.reduced()``: 2 encoder and 2 decoder layers, ``enc_seq``
16, d_model 64, 4 query heads over 2 KV heads, float32. The reference's
parameters (``init_params`` from a key, stripped) cross to the port by
``interop.params_from_numpy``; frames and tokens are numpy from a seed.
The reference runs ``impl="xla"`` and ``impl="pallas_interpret"`` (its
flash kernel, TPU kernel 6, in interpret mode, in the encoder and the
decoder's self-attention; its cross-attention is XLA's ``_sdpa`` either
way). The port runs ``impl="kernel"`` (on the CPU the kernels' plain
versions) and ``impl="ref"``. What each comparison holds:

  * ``sinusoid_positions``: within ``seq * 2^-23`` (at least 1e-6): XLA's
    and torch's float32 ``exp`` of the inverse frequencies differ in the
    last bit, which moves an angle near ``seq`` radians by up to
    ``seq * 2^-24``;
  * ``encode``, ``cross_kv``, ``cross_full``, ``forward`` logits: within
    1e-5;
  * ``init_decode_cache``: shapes and dtypes ``==`` the reference's;
  * ``decode_step`` over 8 tokens: logits and every cache within 1e-5 of
    the reference's ``decode_step``, its cross caches filled from
    ``cross_kv`` after ``_encode`` as ``tests/test_models.py:84-95`` fills
    them;
  * decode against the port's own forward: within the reference's 2e-3
    (``tests/test_models.py:108``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import attention as JA
from repro.models import common as jcommon
from repro.models import model as JM
from repro.sharding import rules as jrules
from repro.sharding.axes import strip
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models import attention as A
from repro_torch.models import common
from repro_torch.models import model as M
from repro_torch.sharding import rules

TOL = 1e-5
B, S, MAX_SEQ = 2, 8, 32
JCFG = JARCHS["whisper-base"].reduced()
CFG = get_arch("whisper-base").reduced()
JPLAN, PLAN = jrules.unpadded_plan(JCFG), rules.unpadded_plan(CFG)
REF_IMPLS = ("xla", "pallas_interpret")

jforward = jax.jit(JM.forward, static_argnums=(1, 2),
                   static_argnames=("impl", "collect_cache"))
jencode = jax.jit(JM._encode, static_argnums=(1, 2, 4))
jdecode = jax.jit(JM.decode_step, static_argnums=(1, 2))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def both():
    """(reference params, port params, frames, tokens)."""
    jp = strip(JM.init_params(JCFG, JPLAN, jax.random.key(3),
                              max_seq=MAX_SEQ))
    tree = jax.tree.map(np.array, jp)
    rng = np.random.default_rng(0)
    # norm scales and biases away from 1 and 0, so that they count
    for g in ("ln1", "ln_x", "ln2"):
        for k, a in tree["layers"][0][g].items():
            a += 0.2 * rng.normal(size=a.shape).astype(np.float32)
    for k, a in tree["encoder"]["ln_post"].items():
        a += 0.2 * rng.normal(size=a.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    params = interop.params_from_numpy(CFG, tree, device="cpu")
    frames = rng.normal(size=(B, CFG.enc_seq, CFG.d_model)).astype(
        np.float32)
    tokens = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    return jp, params, frames, tokens


def test_config_and_registry_match_the_reference():
    full = get_arch("whisper-base")
    assert full.param_count() == JARCHS["whisper-base"].param_count() == \
        97_165_824
    assert (CFG.n_layers, CFG.n_enc_layers, CFG.enc_seq, CFG.dtype) == \
        (2, 2, 16, "float32")


def test_params_cross_both_ways(both):
    jp, params, _, _ = both
    back = interop.params_to_numpy(CFG, params)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert {"ln_x", "xattn"} <= set(params.layers[0].keys())
    assert params.dec_pos["table"].shape == (MAX_SEQ, CFG.d_model)
    # the port's own init makes the same tree
    own = interop.params_to_numpy(CFG, M.init_params(
        CFG, PLAN, seed=1, device="cpu", max_seq=MAX_SEQ))
    assert jax.tree.map(np.shape, own) == jax.tree.map(np.shape, want)
    assert sum(p.numel() for p in params.parameters()) == \
        sum(a.size for a in jax.tree.leaves(want))


@pytest.mark.parametrize("seq,d", [(16, 64), (1500, 512)])
def test_sinusoid_positions(seq, d):
    got = common.sinusoid_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    close(got, jcommon.sinusoid_positions(seq, d), max(1e-6, seq * 2**-23))


@pytest.mark.parametrize("impl", REF_IMPLS)
def test_encode_matches_the_reference(both, impl):
    jp, params, frames, _ = both
    want = jencode(jp, JCFG, JPLAN, jnp.asarray(frames), impl)
    for pimpl in ("kernel", "ref"):
        close(M.encode(params, CFG, PLAN, t(frames), pimpl), want)


def test_cross_kv_and_cross_full(both):
    jp, params, frames, _ = both
    enc = np.asarray(jencode(jp, JCFG, JPLAN, jnp.asarray(frames), "xla"))
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, CFG.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"][0]["xattn"])
    lp = params.layers[0]["xattn"]
    jk, jv = JA.cross_kv(jl, JCFG, JPLAN, jnp.asarray(enc))
    k, v = A.cross_kv(lp, CFG, PLAN, t(enc))
    close(k, jk)
    close(v, jv)
    want = JA.cross_full(jl, JCFG, JPLAN, jnp.asarray(x), (jk, jv))
    for impl in ("kernel", "ref"):
        close(A.cross_full(lp, CFG, PLAN, t(x), (k, v), impl=impl), want)
    # one decoder token over the cross cache (the paged decode's window)
    one = A.cross_decode(lp, CFG, PLAN, t(x[:, :1]), k, v)
    close(one, np.asarray(want)[:, :1])


@pytest.mark.parametrize("impl", REF_IMPLS)
def test_forward_matches_the_reference(both, impl):
    jp, params, frames, tokens = both
    batch = {"tokens": jnp.asarray(tokens), "enc_frames": jnp.asarray(frames)}
    want, _, jc = jforward(jp, JCFG, JPLAN, batch, impl=impl,
                           collect_cache=True)
    for pimpl in ("kernel", "ref"):
        got, aux, caches = M.forward(
            params, CFG, PLAN, {"tokens": t(tokens), "enc_frames": t(frames)},
            impl=pimpl, collect_cache=True)
        close(got, want)
        assert float(aux) == 0.0
        k, v = caches[0]                   # the self-attention's K/V
        close(k, jc[0][0])
        close(v, jc[0][1])


def test_decode_cache_shapes_and_dtypes():
    want = JM.init_decode_cache(JCFG, JPLAN, B, MAX_SEQ, jnp.float32)
    caches = M.init_decode_cache(CFG, PLAN, B, MAX_SEQ, device="cpu")
    assert set(caches) == {"attn"} and len(caches["attn"]) == 4
    got = interop.decode_cache_to_numpy(CFG, caches)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), got) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), want)


def filled_caches(jp, params, frames):
    """Both sides' caches with the cross caches filled from ``cross_kv``
    after the encoder (the reference's as tests/test_models.py fills
    them)."""
    jc = JM.init_decode_cache(JCFG, JPLAN, B, MAX_SEQ, jnp.float32)
    enc = jencode(jp, JCFG, JPLAN, jnp.asarray(frames), "xla")
    lp = jp["layers"][0]
    ck, cv = jc[0][2], jc[0][3]
    for layer in range(JCFG.n_layers):
        k, v = JA.cross_kv(jax.tree.map(lambda a: a[layer], lp["xattn"]),
                           JCFG, JPLAN, enc)
        ck, cv = ck.at[layer].set(k), cv.at[layer].set(v)
    jc = [(jc[0][0], jc[0][1], ck, cv)]
    caches = M.init_decode_cache(CFG, PLAN, B, MAX_SEQ, device="cpu")
    M.fill_cross_cache(params, CFG, PLAN, caches,
                       M.encode(params, CFG, PLAN, t(frames)))
    return jc, caches


def test_decode_step_matches_the_reference(both):
    jp, params, frames, tokens = both
    jc, caches = filled_caches(jp, params, frames)
    close(caches["attn"][2], jc[0][2])
    close(caches["attn"][3], jc[0][3])
    for pos in range(S):
        want, jc = jdecode(jp, JCFG, JPLAN, jnp.asarray(tokens[:, pos:pos + 1]),
                           jc, pos)
        got, caches = M.decode_step(params, CFG, PLAN,
                                    t(tokens[:, pos:pos + 1]), caches, pos)
        assert got.shape == (B, 1, CFG.vocab_size)
        close(got, want)
    for a, b in zip(interop.decode_cache_to_numpy(CFG, caches)[0], jc[0]):
        close(t(a), b)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_decode_matches_the_port_forward(both, impl):
    """Token-by-token decode (``encode``, ``fill_cross_cache``, then
    ``decode_step``) against the full-sequence forward over the frames,
    under the reference's own bound (tests/test_models.py:108)."""
    _, params, frames, tokens = both
    full, _, _ = M.forward(params, CFG, PLAN, {"tokens": t(tokens),
                                               "enc_frames": t(frames)})
    caches = M.init_decode_cache(CFG, PLAN, B, MAX_SEQ, device="cpu")
    M.fill_cross_cache(params, CFG, PLAN, caches,
                       M.encode(params, CFG, PLAN, t(frames), impl))
    errs = []
    for pos in range(S):
        got, caches = M.decode_step(params, CFG, PLAN,
                                    t(tokens[:, pos:pos + 1]), caches, pos,
                                    impl=impl)
        errs.append(float((got[:, 0] - full[:, pos]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_lm_loss_matches_the_reference(both):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(B, S, CFG.vocab_size)).astype(np.float32)
    labels = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    want = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels), 0.5, 0.01)
    got = M.lm_loss(t(logits), t(labels), torch.tensor(0.5), 0.01)
    close(got, want, 1e-6)


@pytest.mark.parametrize("slots,length", [(448, 1), (448, 64), (1500, 1500)])
def test_dense_window_in_the_kernel_arithmetic(slots, length):
    """The paged kernel's own order of operations (``paged_attention_split_
    ref``: the window cut into the launch plan's ``n_split`` shares of
    whole 32-slot chunks, partials merged) over a dense cache read as one
    page of ``slots`` a sequence (Whisper's self cache at 448 and cross
    cache at 1,500 slots, B = 4, 8 heads of 64), against the plain
    version: within 2e-6 (float32)."""
    from repro_torch.kernels.paged_attention import paged_attention as pk
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref,
        paged_attention_split_ref,
    )
    rng = np.random.default_rng(slots + length)
    q = t(rng.normal(size=(4, 8, 64)).astype(np.float32))
    kc = t(rng.normal(size=(4, slots, 8, 64)).astype(np.float32))
    vc = t(rng.normal(size=(4, slots, 8, 64)).astype(np.float32))
    tables, lengths, starts, _, _ = A.dense_window(4, length - 1, "cpu")
    lengths = lengths + 1
    plan = pk.launch_plan(q.to("meta"), kc.to("meta"), vc.to("meta"),
                          tables.to("meta"))
    assert plan["n_split"] == min(32, -(-slots // 32))
    want = paged_attention_ref(q, kc, vc, tables, lengths, starts)
    got = paged_attention_split_ref(q, kc, vc, tables, lengths, starts,
                                    n_split=plan["n_split"])
    close(got, want, 2e-6)
