"""The port's training substrate (``data/pipeline.py``, ``train/`` and
``launch/train.py``) against the JAX reference, on the CPU.

What each comparison holds:

  * ``schedule``, ``adamw_update`` (three steps on one tree of matrices
    and vectors, clipping on and off), ``global_norm``: within 1e-6
    relative (float32, the same formula; XLA's and torch's ``pow`` and
    ``sqrt`` may round the last bit apart);
  * ``quantize_int8``, ``dequantize_int8``, ``compress_tree``: ``==``
    (the same IEEE divisions, ``round`` half to even on both sides);
    ``psum_compressed`` over virtual pods: ``==`` a numpy reckoning;
  * ``TokenStream`` / ``VectorStream`` batches: ``==``;
  * ``loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn`` on reduced
    Llama and Whisper (float32): loss within 1e-5, gradients within 1e-4
    of the largest entry of the leaf (the sums run in another order);
  * microbatches: two microbatches' accumulated float32 gradient within
    1e-6 of the largest entry of the full batch's. The parameters after
    an AdamW step are not the measure: the first step moves each weight
    by about ``lr * sign(g)``, so a gradient entry at rounding level can
    move a weight by up to ``2 lr`` when the summation order changes
    (the reference's ``tests/test_train.py`` holds parameters to 1e-5,
    and fails in some runs);
  * the launcher's stop-and-resume reaches the uninterrupted run's last
    loss within the reference test's 1e-4 (``tests/test_system.py``).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.sharding import rules as jrules
from repro.sharding.axes import strip
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as launcher
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.sharding import rules


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {"a_mat": (scale * rng.normal(size=(6, 5))).astype(np.float32),
            "b_vec": (scale * rng.normal(size=(5,))).astype(np.float32),
            "c_cube": (scale * rng.normal(size=(2, 3, 4))).astype(np.float32)}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 3, 9, 10, 50, 109, 110, 200])
def test_schedule_matches_the_reference(step):
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                        min_lr_frac=0.1)
    want = jopt.schedule(jopt.OptConfig(**cfg.__dict__), jnp.int32(step))
    got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_matches_the_reference(clip):
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        clip_norm=clip)
    jcfg = jopt.OptConfig(**cfg.__dict__)
    p0 = tree(0)
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    js = jopt.init_opt_state(jp)
    params = {k: t(v) for k, v in p0.items()}
    state = opt.init_opt_state(params)
    for i in range(3):
        g = tree(10 + i, scale=0.3)
        jp, js, jm = jopt.adamw_update(
            jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        params, state, met = opt.adamw_update(
            cfg, params, {k: t(v) for k, v in g.items()}, state)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for k in p0:
            for got, want in ((params[k], jp[k]), (state["mu"][k],
                                                   js["mu"][k]),
                              (state["nu"][k], js["nu"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
        assert int(state["step"]) == int(js["step"]) == i + 1
        assert state["mu"]["a_mat"].dtype == params["a_mat"].dtype


def test_adamw_first_step_and_decay_on_matrices_only():
    """The reference's hand-computed step: bias-corrected, the first step
    moves each weight by ``lr * sign(g)``; decay reaches ndim >= 2."""
    cfg = opt.OptConfig(lr=0.1, warmup_steps=0, total_steps=1, clip_norm=1e9,
                        weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    p = {"w": torch.tensor([[1.0, -2.0]])}
    newp, st, _ = opt.adamw_update(cfg, p, {"w": torch.tensor([[0.5, 0.5]])},
                                   opt.init_opt_state(p))
    np.testing.assert_allclose(newp["w"].numpy(), [[0.9, -2.1]], rtol=1e-4)
    assert int(st["step"]) == 1
    cfg = opt.OptConfig(lr=0.1, warmup_steps=0, total_steps=1, clip_norm=1e9,
                        weight_decay=0.5)
    p = {"m": torch.ones((2, 2)), "v": torch.ones((2,))}
    zero = {"m": torch.zeros((2, 2)), "v": torch.zeros((2,))}
    newp, _, _ = opt.adamw_update(cfg, p, zero, opt.init_opt_state(p))
    assert torch.allclose(newp["m"], torch.full((2, 2), 0.95))
    assert torch.equal(newp["v"], torch.ones((2,)))


def test_global_norm_and_clipping():
    g = tree(4)
    want = jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    np.testing.assert_allclose(float(opt.global_norm(
        {k: t(v) for k, v in g.items()})), float(want), rtol=1e-6)
    # the reference's clip test: norm 200 reported, the step clipped
    cfg = opt.OptConfig(lr=1.0, warmup_steps=0, clip_norm=1.0,
                        weight_decay=0.0)
    p = {"w": torch.ones((4,))}
    _, st, met = opt.adamw_update(cfg, p, {"w": torch.full((4,), 100.0)},
                                  opt.init_opt_state(p))
    assert float(met["grad_norm"]) == pytest.approx(200.0)
    # the clipped gradient 0.5 reaches the first moment
    np.testing.assert_allclose(st["mu"]["w"].numpy(), 0.05, rtol=1e-6)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_and_compress_equal_the_reference():
    rng = np.random.default_rng(1)
    g = rng.normal(size=(1000,)).astype(np.float32)
    g[:4] = [0.5, -0.5, 1.5, 2.5]         # ties: round half to even
    q, s = gc.quantize_int8(t(g))
    jq, js = jgc.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    assert np.array_equal(gc.dequantize_int8(q, s).numpy(),
                          np.asarray(jgc.dequantize_int8(jq, js)))
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5])),
                       torch.tensor([0.0, 2.0, 2.0, -0.0]))
    grads, res = tree(2, 1e-3), tree(3, 1e-5)
    q, s, r = gc.compress_tree({k: t(v) for k, v in grads.items()},
                               {k: t(v) for k, v in res.items()})
    jq, js, jr = jgc.compress_tree(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in res.items()})
    for k in grads:
        assert np.array_equal(q[k].numpy(), np.asarray(jq[k]))
        assert float(s[k]) == float(js[k])
        assert np.array_equal(r[k].numpy(), np.asarray(jr[k]))
    assert all(torch.equal(z, torch.zeros_like(z)) for z in
               gc.init_residual({k: t(v) for k, v in grads.items()}).values())


def test_error_feedback_sum_converges():
    """The reference's check: the accumulated dequantized stream follows
    the true stream."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)) * 1e-3
    res, total = {"g": torch.zeros_like(g)}, torch.zeros_like(g)
    for _ in range(50):
        q, s, res = gc.compress_tree({"g": g}, res)
        total = total + gc.dequantize_int8(q["g"], s["g"])
    np.testing.assert_allclose(total.numpy(), g.numpy() * 50, rtol=0.02,
                               atol=1e-5)
    q, s = gc.quantize_int8(g)
    assert float((gc.dequantize_int8(q, s) - g).abs().max()) <= \
        float(s) * 0.5 + 1e-9


def test_psum_compressed_over_virtual_pods():
    pods = [tree(20 + i, 1e-2) for i in range(3)]
    qs, ss = [], []
    for p in pods:
        q, s, _ = gc.compress_tree({k: t(v) for k, v in p.items()},
                                   gc.init_residual({k: t(v) for k, v in
                                                     p.items()}))
        qs.append(q)
        ss.append(s)
    got = gc.psum_compressed(qs, ss)
    for k in pods[0]:
        qsum = sum(q[k].numpy().astype(np.int32) for q in qs)
        smean = np.float32(sum(np.float32(s[k]) for s in ss)) / np.float32(3)
        want = qsum.astype(np.float32) * smean / np.float32(3)
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), want)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host", [0, 1])
def test_token_stream_equals_the_reference(host):
    kw = dict(seed=3, vocab_size=100, seq_len=8, global_batch=8, n_hosts=2,
              host_id=host)
    for step in (0, 5, 1000):
        a = pipe.TokenStream(pipe.DataConfig(**kw)).batch(step)
        b = jpipe.TokenStream(jpipe.DataConfig(**kw)).batch(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    full = pipe.TokenStream(pipe.DataConfig(**{**kw, "n_hosts": 1})).batch(5)
    assert np.array_equal(full["tokens"][:, 1:], full["labels"][:, :-1])
    with pytest.raises(ValueError):
        pipe.TokenStream(pipe.DataConfig(global_batch=3, n_hosts=2))


@pytest.mark.parametrize("zipf_a", [0.0, 1.3])
def test_vector_stream_equals_the_reference(zipf_a):
    kw = dict(seed=2, dim=16, n_clusters=8, zipf_a=zipf_a)
    a, b = pipe.VectorStream(pipe.VectorStreamConfig(**kw)), \
        jpipe.VectorStream(jpipe.VectorStreamConfig(**kw))
    assert np.array_equal(a.centers, b.centers)
    for step in (0, 7):
        assert np.array_equal(a.batch(step, 33), b.batch(step, 33))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def reduced(arch: str):
    jcfg, cfg = JARCHS[arch].reduced(), get_arch(arch).reduced()
    jplan, plan = jrules.unpadded_plan(jcfg), rules.unpadded_plan(cfg)
    jp = strip(JM.init_params(jcfg, jplan, jax.random.key(0), max_seq=16))
    params = interop.params_from_numpy(cfg, jax.tree.map(np.array, jp),
                                       device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 16))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][0, :3] = -1
    if cfg.enc_dec:
        batch["enc_frames"] = rng.normal(size=(4, cfg.enc_seq, cfg.d_model)
                                         ).astype(np.float32)
    return jcfg, cfg, jplan, plan, jp, params, batch


def as_tree(cfg, params, grads: dict) -> dict:
    """The port's gradients by name, in the reference's tree layout."""
    g = copy.deepcopy(params)
    for n, p in g.named_parameters():
        p.data = grads[n]
    return interop.params_to_numpy(cfg, g)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-base"])
def test_loss_and_gradients_match_the_reference(arch):
    jcfg, cfg, jplan, plan, jp, params, batch = reduced(arch)
    (jloss, _), jg = jax.jit(jax.value_and_grad(jts.loss_fn, has_aux=True),
                             static_argnums=(1, 2, 4))(
        jp, jcfg, jplan, {k: jnp.asarray(v) for k, v in batch.items()}, 0.01)
    ts.init_train_state(params)
    grads, met = ts.make_grad_fn(cfg, plan, ts.TrainConfig())(
        params, {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(met["loss"]), float(jloss), rtol=1e-5)
    got = as_tree(cfg, params, grads)
    want = jax.tree.map(np.asarray, jg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-base"])
def test_microbatch_gradients_equal_the_full_batch(arch):
    _, cfg, _, plan, _, params, batch = reduced(arch)
    batch["labels"][0, :3] = 7           # equal label counts per microbatch
    ts.init_train_state(params)
    full, fmet = ts.make_grad_fn(cfg, plan, ts.TrainConfig())(
        params, {k: t(v) for k, v in batch.items()})
    mb, mmet = ts.make_grad_fn(cfg, plan, ts.TrainConfig(microbatches=2))(
        params, {k: t(v).reshape(2, 2, *v.shape[1:])
                 for k, v in batch.items()})
    np.testing.assert_allclose(float(mmet["loss"]), float(fmet["loss"]),
                               rtol=1e-6)
    for n, g in full.items():
        assert mb[n].dtype == torch.float32
        bound = 1e-6 * max(float(g.abs().max()), 1e-30)
        assert float((mb[n] - g).abs().max()) <= bound, n


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-base"])
def test_loss_falls_on_a_repeated_batch(arch):
    """The reference's ``test_loss_decreases_small_lm``: 25 steps on one
    batch of the token stream."""
    _, cfg, _, plan, _, params, _ = reduced(arch)
    state = ts.init_train_state(params)
    step = ts.make_train_step(cfg, plan, ts.TrainConfig(
        opt=opt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=30)))
    data = pipe.TokenStream(pipe.DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=16, global_batch=4))
    batch = {k: t(v) for k, v in data.batch(0).items()}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.zeros((4, cfg.enc_seq, cfg.d_model))
    losses = []
    for _ in range(25):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::6]
    assert int(state["opt"]["step"]) == 25


def test_state_specs_names_the_mesh_plan():
    """The train state's specs under a (data 2, model 2) plan: the
    moments shard as the parameters do, and ZeRO-1 adds ``data`` on each
    moment's first dim that no axis shards and 2 divides."""
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.models import model as M
    cfg = get_arch("llama3-8b").reduced()
    mesh = ModelMesh.virtual({"data": 2, "model": 2}, "meta")
    plan = rules.make_plan(cfg, mesh.shape, "train", 4)
    params = M.init_params(cfg, plan, device="meta")
    plain = ts.mesh_state_specs(params, plan, mesh)
    z1 = ts.mesh_state_specs(params, plan, mesh, zero1=True)
    assert plain["params"] == z1["params"] == plain["opt"]["mu"]
    assert plain["params"]["layers.0.attn.wq"] == (None, "model")
    assert z1["opt"]["mu"]["layers.0.attn.wq"] == ("data", "model")
    assert z1["opt"]["nu"]["layers.0.attn.wo"] == ("model", "data")
    assert z1["opt"]["mu"]["final_norm.scale"] == ("data",)
    assert z1["opt"]["mu"]["embed.table"] == ("model", "data")
    assert z1["opt"]["step"] == ()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_resumes_to_the_uninterrupted_loss(tmp_path):
    """The reference's test_train_launcher_checkpoint_restart: an
    interrupted run (stop after 3 of 6 steps) resumed from its checkpoint
    reaches the uninterrupted run's last loss."""
    args = ["--arch", "llama3-8b", "--reduced", "--batch", "2", "--seq",
            "16", "--log-every", "100", "--device", "cpu", "--steps", "6",
            "--ckpt-every", "3"]
    r1 = launcher.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert r1["steps_run"] == 6 and r1["final_step"] == 6
    r2a = launcher.main(args + ["--stop-after", "3", "--ckpt-dir",
                                str(tmp_path / "b")])
    r2b = launcher.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert r2a["steps_run"] == 3 and r2a["final_step"] == 3
    assert r2b["steps_run"] == 3 and r2b["final_step"] == 6
    assert abs(r2b["last_loss"] - r1["last_loss"]) < 1e-4
    assert r2a["losses"] == r1["losses"][:3]
    assert set(r1) >= {"first_loss", "last_loss", "steps_run", "final_step"}


def test_launcher_feeds_whisper_and_microbatches():
    r = launcher.main(["--arch", "whisper-base", "--reduced", "--batch", "4",
                       "--seq", "8", "--steps", "2", "--microbatches", "2",
                       "--device", "cpu", "--log-every", "100",
                       "--multihost"])
    assert r["steps_run"] == 2 and np.isfinite(r["last_loss"])
