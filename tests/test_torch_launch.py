"""The port's launch tooling against the reference's, on the CPU.

  * ``configs.cell_runnable`` and ``launch.roofline.model_flops`` ``==``
    the reference's for every arch x shape; ``roofline_terms`` is the
    reference's formula with the H100's constants in place of the TPU's.
  * ``launch.op_count`` against the reference's ``hlo_analyzer.analyze``
    (run in a subprocess on the (data 2, model 4) ``AxisType.Auto`` mesh of
    eight fake CPU devices, ``jax.jit(...).lower(...).compile()`` with the
    dry run's in-shardings): the per-device FLOPs of Llama-3-8B, RWKV6-3B,
    Jamba and Whisper-base at ``.reduced()`` (Whisper with its
    ``n_kv_heads = n_heads``, as whisper-base has), prefill and decode,
    ``==`` the reference's plus the named gaps below, within ``GAP_TOL``
    of the reference's (the one case left, Jamba's decode, is 0.95 % off
    after its gaps). The collectives by kind are reported beside the
    reference's, not held to them: GSPMD chooses its own.
  * ``launch.dryrun``: one cell per family on a (2, 4) mesh, single and
    multi-pod, ``ok`` with FLOPs above 0 and a valid ``dominant``, its
    ``argument_bytes`` ``==`` the shard's blocks summed from the config
    and the plan here; the resumable sweep and the CLI's skips.
  * each kernel's ``meta`` route: its plain version's shapes and dtypes,
    no launch count moved.

The gaps between the two counts, each computed from the config:

  * ``causal``: kernel 6's formula counts the visible (q, k) pairs of a
    causal prefill, XLA's dots every pair (masked after);
  * ``recurrence``: kernels 7 and 8 count their elementwise state update
    too (WKV6 ``5 dk dv + 3 dk + 2 dv`` a token and head, the selective
    scan ``6 n + 3`` a token and channel), XLA only the contraction that
    is a dot (``2 dk dv``, ``2 n``);
  * ``replicated``: in prefill GSPMD splits a replicated weight's product
    over ``model`` and gathers it (RWKV's ``w_lora_a`` and channel-mix
    ``w_r``; ``wk`` and ``wv`` where KV heads do not shard), where each of
    the port's shards computes it whole;
  * ``moe_capacity``: in Jamba's decode GSPMD splits the MoE fallback's
    expert buffer over ``data``; each of the port's data shards runs the
    whole gathered buffer (``mlp.apply_moe_mesh``).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import cell_runnable as jcell_runnable
from repro.launch import roofline as JR
from repro_torch.configs import ARCHS, SHAPES, cell_runnable, get_arch
from repro_torch.kernels.flash_attention import flash_attention as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.mamba_scan import mamba_scan as mk
from repro_torch.kernels.mamba_scan import ops as mops
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention import paged_attention as pk
from repro_torch.kernels.wkv6 import ops as wops
from repro_torch.kernels.wkv6 import wkv6 as wk
from repro_torch.launch import dryrun, op_count
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import ModelMesh
from repro_torch.launch.specs import abstract_params
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.sharding.axes import logical_axes, spec_for
from repro_torch.sharding.rules import make_plan

REPO = Path(__file__).resolve().parent.parent
SHAPE = {"data": 2, "model": 4}
B, S = 2, 32
GAP_TOL = 0.01
VARIANTS = {"llama": ("llama3-8b", {}), "rwkv": ("rwkv6-3b", {}),
            "jamba": ("jamba-v0.1-52b", {}),
            "whisper": ("whisper-base", {"n_kv_heads": 4})}

ORACLE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.launch import specs as SP
from repro.launch.hlo_analyzer import analyze
from repro.models import model as M
from repro.sharding import axes as AX
from repro.sharding.rules import make_plan
from repro.utils import set_mesh_compat

spec = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
b, s = spec["batch"], spec["seq"]
for name, (arch, traits) in spec["variants"].items():
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **traits)
    for kind in ("prefill", "decode"):
        plan = make_plan(cfg, {"data": 2, "model": 4}, kind, b)
        rules = plan.rules_dict
        annot = SP.abstract_params(cfg, plan, max_seq=s)
        psh = SP.param_shardings(annot, mesh, rules)
        pabs = AX.strip(annot)
        rows = NamedSharding(mesh, P(rules["batch"], None))
        with set_mesh_compat(mesh), AX.use_rules(rules):
            if kind == "prefill":
                x = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
                xs = {"tokens": rows}
                if cfg.enc_dec:
                    x["enc_frames"] = jax.ShapeDtypeStruct(
                        (b, cfg.enc_seq, cfg.d_model), jnp.float32)
                    xs["enc_frames"] = NamedSharding(
                        mesh, P(rules["batch"], None, None))
                fn = jax.jit(lambda p, x: M.forward(p, cfg, plan, x)[0],
                             in_shardings=(psh, xs))
                comp = fn.lower(pabs, x).compile()
            else:
                cabs = SP.abstract_decode_cache(cfg, plan, b, s)
                csh = SP.cache_shardings(cfg, plan, cabs, mesh)
                fn = jax.jit(
                    lambda p, t, c, pos: M.decode_step(p, cfg, plan, t, c,
                                                       pos),
                    in_shardings=(psh, rows, csh, NamedSharding(mesh, P())))
                comp = fn.lower(pabs, jax.ShapeDtypeStruct((b, 1), jnp.int32),
                                cabs,
                                jax.ShapeDtypeStruct((), jnp.int32)).compile()
        a = analyze(comp.as_text())
        out[f"{name}|{kind}"] = {
            "flops": a["flops"],
            "collectives": {k: v["count"] for k, v in
                            a["collectives"].items()}}
print(json.dumps(out))
"""


def variant(name: str):
    arch, traits = VARIANTS[name]
    return dataclasses.replace(get_arch(arch).reduced(), **traits)


def test_cell_runnable_and_model_flops_equal_the_reference():
    assert list(SHAPES) == list(JSHAPES)
    assert set(ARCHS) == set(JARCHS)
    for arch in ARCHS:
        for shape in SHAPES:
            assert cell_runnable(ARCHS[arch], SHAPES[shape]) == \
                jcell_runnable(JARCHS[arch], JSHAPES[shape]), (arch, shape)
            assert R.model_flops(ARCHS[arch], SHAPES[shape]) == \
                JR.model_flops(JARCHS[arch], JSHAPES[shape]), (arch, shape)
    assert sum(not cell_runnable(ARCHS[a], SHAPES["long_500k"])[0]
               for a in ARCHS) == 8


def test_roofline_terms_is_the_reference_formula_on_h100_constants(
        monkeypatch):
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW, R.NET_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)
    src = Path(R.__file__).read_text()
    for tpu in ("197e12", "819e9"):            # the reference's constants
        assert tpu not in src
    monkeypatch.setattr(JR, "PEAK_FLOPS", R.PEAK_FLOPS)
    monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(JR, "ICI_BW", R.NVLINK_BW)
    for args in ((3.3e16, 1.2e14, 5e11, 256), (1e9, 4e12, 0.0, 8),
                 (5e12, 1e9, 3e13, 512), (0.0, 0.0, 0.0, 1)):
        assert R.roofline_terms(*args) == JR.roofline_terms(*args)
    # the network term: the reference's formula at 50 GB/s
    monkeypatch.setattr(JR, "ICI_BW", R.NET_BW)
    assert R.roofline_terms(1e15, 1e12, 0.0, 16, 7e11) == \
        JR.roofline_terms(1e15, 1e12, 7e11, 16)
    assert R.wire_path(list(range(8))) == "nvlink"
    assert R.wire_path([0, 16]) == R.wire_path(list(range(4, 12))) == \
        "network"


def port_count(cfg, kind: str) -> dict:
    """The op count of one data shard's rows on the (2, 4) mesh."""
    prod = ModelMesh.virtual(SHAPE, "meta")
    run = ModelMesh.virtual({"data": 1, "model": 4}, "meta")
    plan = make_plan(cfg, SHAPE, kind, B)
    params = abstract_params(cfg, plan, S)
    with op_count.counting(run, prod) as c, torch.no_grad():
        if kind == "prefill":
            x = {"tokens": torch.empty((1, S), dtype=torch.int32,
                                       device="meta")}
            if cfg.enc_dec:
                x["enc_frames"] = torch.empty((1, cfg.enc_seq, cfg.d_model),
                                              device="meta")
            M.forward(params, cfg, plan, x, mesh=run)
        else:
            caches = M.init_decode_cache(cfg, plan, 1, S, mesh=run)
            M.decode_step(params, cfg, plan, torch.empty(
                (1, 1), dtype=torch.int32, device="meta"), caches, S - 1,
                mesh=run)
    return c.per_device()


def gaps(cfg, kind: str) -> dict:
    """The named gaps (port minus reference) of one device, from the
    config (see the module docstring)."""
    m, plan = SHAPE["model"], make_plan(cfg, SHAPE, kind, B)
    rows, t = B // SHAPE["data"], (S if kind == "prefill" else 1)
    hq = plan.n_heads_padded // m
    out = {}
    kinds = M.layer_kinds(cfg)
    if kind == "prefill":
        visible = S * (S + 1) // 2
        out["causal"] = kinds.count("attn") * rows * hq * \
            2 * 2 * cfg.head_dim * (visible - S * S)
    if "rwkv" in kinds:
        dk = cfg.rwkv_head_size
        out["recurrence"] = kinds.count("rwkv") * rows * t * hq * (
            5 * dk * dk + 3 * dk + 2 * dk - 2 * dk * dk)
    if "mamba" in kinds:
        n, di = cfg.mamba_d_state, cfg.mamba_d_inner // m
        out["recurrence"] = kinds.count("mamba") * rows * t * di * (
            6 * n + 3 - 2 * n)
    if kind == "prefill":
        d, whole = cfg.d_model, 0
        if "attn" in kinds and not plan.kv_sharded:
            kv = plan.n_kv_heads_padded * cfg.head_dim
            whole += kinds.count("attn") * 2 * (2 * rows * S * d * kv)
        if "rwkv" in kinds:                       # w_lora_a, cm.w_r
            whole += kinds.count("rwkv") * 2 * rows * S * d * (64 + d)
        out["replicated"] = whole * (m - 1) // m
    if kind == "decode" and cfg.moe:
        n_moe = sum(cfg.is_moe_layer(i % cfg.layer_period)
                    for i in range(cfg.n_layers))
        from repro_torch.models.mlp import capacity
        cap = capacity(cfg, B)
        ffn = n_moe * (plan.n_experts_padded // m) * cap * 3 * 2 * \
            cfg.d_model * cfg.moe_d_ff
        out["moe_capacity"] = ffn // SHAPE["data"]
    return out


@pytest.fixture(scope="module")
def analyzer():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", ORACLE, json.dumps(
            {"variants": VARIANTS, "batch": B, "seq": S})],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_op_count_flops_match_the_reference_analyzer(name, kind, analyzer):
    cfg = variant(name)
    got, want = port_count(cfg, kind), analyzer[f"{name}|{kind}"]
    named = gaps(cfg, kind)
    residual = got["flops"] - want["flops"] - sum(named.values())
    assert abs(residual) <= GAP_TOL * want["flops"], (
        name, kind, got["flops"], want["flops"], named)
    if (name, kind) != ("jamba", "decode"):
        assert residual == 0, (name, kind, residual)
    # reported beside the reference's, not held: GSPMD picks its own
    print(name, kind, {k: v["count"] for k, v in
                       got["collectives"].items()}, want["collectives"])
    assert got["collectives"] and got["flops"] > 0


def _blocks_bytes(tree_axes: dict, shapes: dict, dtypes: dict, rules,
                  mesh) -> int:
    total = 0
    for name, ax in tree_axes.items():
        n = 1
        for size, e in zip(shapes[name], spec_for(ax, rules)):
            n *= size // (1 if e is None else mesh.extent(e))
        total += n * dtypes[name].itemsize
    return total


CELLS = (("rwkv6-3b", "decode_32k"), ("jamba-v0.1-52b", "prefill_32k"),
         ("whisper-base", "decode_32k"), ("llama3-8b", "prefill_32k"))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell_reports_a_coherent_cell(arch, shape, multi,
                                             monkeypatch):
    """At ``.reduced()`` widths (Whisper's MHA kept), the production
    shapes' batch and sequence, on (2, 4) and (2, 2, 4)."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), **(
        {"n_kv_heads": 4} if arch == "whisper-base" else {}))
    monkeypatch.setitem(dryrun.ARCHS, arch, cfg)
    r = dryrun.run_cell(arch, shape, multi, mesh_shape=SHAPE)
    assert r["status"] == "ok" and r["hlo_flops"] > 0
    assert r["roofline"]["dominant"] in ("compute_s", "memory_s",
                                         "collective_s")
    chips = 16 if multi else 8
    assert r["chips"] == chips
    sh = SHAPES[shape]
    mesh = ModelMesh.virtual({**({"pod": 2} if multi else {}), **SHAPE},
                             "meta")
    plan = make_plan(cfg, mesh.shape, sh.kind, sh.global_batch)
    params = abstract_params(cfg, plan, sh.seq_len)
    named = dict(params.named_parameters())
    want = _blocks_bytes(logical_axes(params),
                         {n: p.shape for n, p in named.items()},
                         {n: p.dtype for n, p in named.items()},
                         plan.rules_dict, mesh)
    rows = sh.global_batch // mesh.extent(plan.batch_axes)
    if sh.kind == "decode":
        want += rows * 4                                   # tokens
        for entries in parallel.cache_shapes(cfg, plan, sh.global_batch,
                                             sh.seq_len, torch.float32
                                             ).values():
            for shp, dt, spec in entries:
                want += int(np.prod(parallel.block_shape(shp, spec, mesh))
                            ) * dt.itemsize
    else:
        want += rows * sh.seq_len * 4
        if cfg.enc_dec:
            want += rows * cfg.enc_seq * cfg.d_model * 4
    assert r["memory"]["argument_bytes"] == want
    assert r["memory"]["temp_bytes"] > 0 and r["memory"]["fits_80gb"]
    per = r["per_device"]
    assert per["flops"] * chips == r["hlo_flops"]
    kern = {"rwkv6-3b": "wkv6", "jamba-v0.1-52b": "mamba_scan",
            "whisper-base": "paged_attention",
            "llama3-8b": "flash_attention"}[arch]
    assert per["kernels"][kern]["calls"] > 0


def test_dryrun_sweep_skips_and_resumes(tmp_path, monkeypatch):
    """The CLI's cells: ``long_500k`` of an attention LM is skipped with
    the reference's reason, a finished cell is not run again."""
    monkeypatch.setitem(dryrun.ARCHS, "llama3-8b",
                        ARCHS["llama3-8b"].reduced())
    calls = []
    orig = dryrun.run_cell

    def spy(*a, **k):
        calls.append(a[:3])
        return orig(*a[:3], mesh_shape=SHAPE)
    monkeypatch.setattr(dryrun, "run_cell", spy)
    out = tmp_path / "dry.json"
    argv = ["--arch", "llama3-8b", "--shape", "long_500k,decode_32k",
            "--mesh", "single", "--out", str(out)]
    assert dryrun.main(argv) == 0
    res = json.loads(out.read_text())
    skip = res["llama3-8b|long_500k|single"]
    assert skip["status"] == "skipped" and skip["reason"] == \
        jcell_runnable(JARCHS["llama3-8b"], JSHAPES["long_500k"])[1]
    assert res["llama3-8b|decode_32k|single"]["status"] == "ok"
    assert dryrun.main(argv) == 0 and len(calls) == 1


def test_kernel_meta_routes_give_the_plain_shapes_and_launch_nothing():
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    before = (fk.launches, pk.launches, wk.launches, mk.launches)
    q, k = t(1, 4, 7, 16, dtype=torch.bfloat16), t(1, 2, 9, 16,
                                                   dtype=torch.bfloat16)
    cases = [(fops.flash_attention, (q, k, k), {"causal": True})]
    tables = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    lens = torch.tensor([5, 3], dtype=torch.int32)
    kp = t(3, 4, 2, 16)
    cases.append((pops.paged_attention,
                  (t(2, 4, 16), kp, t(3, 4, 2, 8), tables, lens), {}))
    cases.append((wops.wkv6, (t(1, 5, 2, 4), t(1, 5, 2, 4), t(1, 5, 2, 3),
                              torch.rand(1, 5, 2, 4), t(2, 4),
                              t(1, 2, 4, 3)), {}))
    cases.append((mops.mamba_scan, (t(1, 5, 6), torch.rand(1, 5, 6),
                                    -torch.rand(6, 3), t(1, 5, 3),
                                    t(1, 5, 3), t(6), t(1, 6, 3)), {}))
    seen = []
    from repro_torch.kernels import _meta
    with _meta.recording(lambda *a: seen.append(a)):
        for fn, args, kw in cases:
            want = fn(*args, **kw)              # CPU: the plain version
            got = fn(*(a.to("meta") for a in args), **kw)
            want = want if isinstance(want, tuple) else (want,)
            got = got if isinstance(got, tuple) else (got,)
            assert [(g.shape, g.dtype, g.device.type) for g in got] == \
                [(w.shape, w.dtype, "meta") for w in want], fn
    assert [s[0] for s in seen] == ["flash_attention", "paged_attention",
                                    "wkv6", "mamba_scan"]
    assert all(s[1] > 0 and s[2] > 0 for s in seen)
    assert (fk.launches, pk.launches, wk.launches, mk.launches) == before
