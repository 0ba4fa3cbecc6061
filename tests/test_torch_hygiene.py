"""Boundaries of the port: no JAX inside it, the card by default, no
quiet fallback from the card to the plain versions."""
import ast
import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import sivf_torch
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as fkernel
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.mamba_scan import mamba_scan as skernel
from repro_torch.kernels.mamba_scan import ops as sops
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention import paged_attention as pkernel
from repro_torch.kernels.wkv6 import ops as wops
from repro_torch.kernels.wkv6 import wkv6 as wkernel
from repro_torch.models import model
from repro_torch.serve.paged_lm import PagedLMEngine
from repro_torch.sharding.rules import unpadded_plan

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + sorted(
    (REPO / "src" / "sivf_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "sivf"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_nothing_of_the_jax_package():
    assert len(PORT_FILES) > 15
    bad = {str(p.relative_to(REPO)): sorted(imported_roots(p) & FORBIDDEN)
           for p in PORT_FILES if imported_roots(p) & FORBIDDEN}
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, sivf_torch, repro_torch.core, repro_torch.interop; "
            "import repro_torch.kernels.sivf_scan.ops; "
            "import repro_torch.kernels.sivf_scan.pq_fused; "
            "import repro_torch.kernels.sivf_scan.sivf_scan; "
            "import repro_torch.kernels.topk.ops; "
            "import repro_torch.core.filters, repro_torch.core.pq; "
            "import repro_torch.serve.paged_lm, repro_torch.models.model; "
            "import repro_torch.kernels.paged_attention.ops; "
            "import repro_torch.kernels.flash_attention.ops; "
            "import repro_torch.configs; "
            "import repro_torch.kernels.wkv6.ops; "
            "import repro_torch.kernels.mamba_scan.ops; "
            "import repro_torch.models.rwkv, repro_torch.models.mamba; "
            "import repro_torch.obs, repro_torch.serve.sivf_engine; "
            "import sivf_torch.telemetry; "
            "import repro_torch.baselines; "
            "import repro_torch.data.pipeline, repro_torch.launch.train; "
            "import repro_torch.train.train_step; "
            "import repro_torch.train.grad_compress; "
            "import repro_torch.sharding.axes, repro_torch.sharding.rules; "
            "import repro_torch.launch.mesh, repro_torch.launch.specs; "
            "import repro_torch.models.parallel; "
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline; "
            "import repro_torch.launch.op_count; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'sivf')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_default_device_is_the_card():
    cfg = sivf_torch.SIVFConfig(dim=8, n_lists=2, n_slabs=4, capacity=32,
                                n_max=64)
    cents = np.zeros((2, 8), np.float32)
    if torch.cuda.is_available():
        assert sivf_torch.Index(cfg, cents).state.data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sivf_torch.Index(cfg, cents)
        with pytest.raises(RuntimeError):
            sivf_torch.init_state(cfg, cents)
    assert sivf_torch.Index(cfg, cents, device="cpu").device.type == "cpu"
    # the LM slice: init_params and PagedLMEngine
    cfg = get_arch("llama3-8b").reduced()
    plan = unpadded_plan(cfg)
    if torch.cuda.is_available():
        assert model.init_params(cfg, plan).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_params(cfg, plan)
    params = model.init_params(cfg, plan, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedLMEngine(cfg, plan, params)
    eng = PagedLMEngine(cfg, plan, params, device="cpu")
    assert eng.k_pool.device.type == "cpu" and eng.attn_impl == "kernel"


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_recurrent_paths_default_to_the_card(arch):
    """``init_params`` and ``PagedLMEngine`` of the RWKV6 and hybrid
    slices run on the card unless the caller passes ``device="cpu"``."""
    cfg = get_arch(arch).reduced()
    plan = unpadded_plan(cfg)
    if torch.cuda.is_available():
        assert model.init_params(cfg, plan).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_params(cfg, plan)
    params = model.init_params(cfg, plan, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedLMEngine(cfg, plan, params)
    eng = PagedLMEngine(cfg, plan, params, device="cpu")
    assert eng.attn_impl == "kernel"
    assert all(p.device.type == "cpu" for pools in eng.state.values()
               for p in pools)


@pytest.mark.parametrize("name", ["llava-next-34b", "minicpm3-4b",
                                  "moonshot-v1-16b-a3b", "whisper-base"])
def test_unported_archs_raise_naming_their_roadmap_item(name):
    """All four are registered and their blocks ported (Whisper last), so
    nothing is left to raise; the encoder-decoder's init, dense decode
    cache and the trainer default to the card."""
    cfg = get_arch(name)
    assert cfg.name == name and name in ARCHS
    model.check_supported(cfg)
    with pytest.raises(KeyError):
        get_arch(name + "-unknown")
    if cfg.enc_dec:
        small = cfg.reduced()
        plan = unpadded_plan(small)
        if not torch.cuda.is_available():
            for call in (lambda: model.init_params(small, plan),
                         lambda: model.init_decode_cache(small, plan, 1, 8)):
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    call()
        assert model.init_decode_cache(small, plan, 1, 8, device="cpu")[
            "attn"][2].shape == (small.n_layers, 1, small.enc_seq,
                                 small.n_kv_heads, small.head_dim)


def fake_cuda(args) -> list:
    """CUDA tensors of ``args``' shapes and dtypes, made under an entered
    ``FakeTensorMode`` (no card needed)."""
    return [torch.empty(a.shape, dtype=a.dtype, device="cuda") for a in args]


@pytest.mark.parametrize("name", ["paged_attention", "flash_attention"])
def test_attention_ops_never_fall_back_off_the_cpu(name, monkeypatch):
    """A CUDA tensor (a fake one, as no card is needed to make it) goes to
    the kernel's wrapper and never to the plain version: an error the
    wrapper raises propagates. A ``meta`` tensor takes the ``meta`` route
    (neither the wrapper nor the plain version), and the real wrapper
    refuses a tensor that is not on a CUDA device."""
    class Launched(Exception):
        pass

    def launch(*args, **kwargs):
        raise Launched(name)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    if name == "paged_attention":
        ops, wrapper, ref = pops, pkernel, "paged_attention_ref"
        args = (torch.empty(2, 4, 8), torch.empty(3, 4, 2, 8),
                torch.empty(3, 4, 2, 8),
                torch.zeros(2, 2, dtype=torch.int32),
                torch.ones(2, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32))
    else:
        ops, wrapper, ref = fops, fkernel, "mha_ref"
        args = (torch.empty(1, 4, 5, 8), torch.empty(1, 2, 5, 8),
                torch.empty(1, 2, 5, 8))
    monkeypatch.setattr(wrapper, f"{name}_cuda", launch)
    monkeypatch.setattr(ops, ref, plain)
    with pytest.raises(Launched), FakeTensorMode():
        getattr(ops, name)(*fake_cuda(args))
    assert getattr(ops, name)(*(a.to("meta") for a in args)).is_meta
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):   # the real wrapper
        getattr(wrapper, f"{name}_cuda")(*(a.to("meta") for a in args))


def test_serve_engine_never_falls_back_off_the_cpu(monkeypatch):
    """A ``ServeEngine`` over an index that does not lie on the CPU (here
    on the ``meta`` device) sends its tiles to kernel 1's wrapper and
    never to the plain version: the wrapper's error reaches the request's
    future."""
    from repro_torch.kernels.sivf_scan import fused
    from repro_torch.kernels.sivf_scan import ops as sops

    class Launched(Exception):
        pass

    def launch(*args, **kwargs):
        raise Launched("sivf_fused_search")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(fused, "sivf_fused_search_cuda", launch)
    monkeypatch.setattr(sops, "sivf_fused_search_ref", plain)
    cfg = sivf_torch.SIVFConfig(dim=16, n_lists=4, n_slabs=64, capacity=32,
                                n_max=1024)
    index = sivf_torch.Index(cfg, np.zeros((4, 16), np.float32),
                             device="meta", deferred=True)
    with sivf_torch.ServeEngine(index, default_k=5, default_nprobe=2) as eng:
        fut = eng.session().search(np.zeros((3, 16), np.float32))
        with pytest.raises(Launched):
            fut.result(30)
    monkeypatch.undo()
    with sivf_torch.ServeEngine(index, default_k=5, default_nprobe=2) as eng:
        with pytest.raises(ValueError, match="CUDA"):   # the real wrapper
            eng.session().search(np.zeros((3, 16), np.float32)).result(30)


def recurrence_args(name):
    if name == "wkv6":
        return (torch.empty(2, 3, 4, 16), torch.empty(2, 3, 4, 16),
                torch.empty(2, 3, 4, 16), torch.empty(2, 3, 4, 16),
                torch.empty(4, 16), torch.empty(2, 4, 16, 16))
    return (torch.empty(2, 3, 40), torch.empty(2, 3, 40), torch.empty(40, 4),
            torch.empty(2, 3, 4), torch.empty(2, 3, 4), torch.empty(40),
            torch.empty(2, 40, 4))


RECURRENCES = {"wkv6": (wops, wkernel, "wkv6_ref"),
               "mamba_scan": (sops, skernel, "mamba_scan_ref")}


@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_recurrence_ops_never_fall_back_off_the_cpu(name, monkeypatch):
    """A CUDA tensor (a fake one) goes to the kernel's wrapper and never to
    the plain version; a ``meta`` tensor takes the ``meta`` route; the
    real wrapper refuses a tensor that is not on a CUDA device."""
    ops, wrapper, ref = RECURRENCES[name]

    class Launched(Exception):
        pass

    def launch(*args, **kwargs):
        raise Launched(name)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(wrapper, f"{name}_cuda", launch)
    monkeypatch.setattr(ops, ref, plain)
    with pytest.raises(Launched), FakeTensorMode():
        getattr(ops, name)(*fake_cuda(recurrence_args(name)))
    args = [a.to("meta") for a in recurrence_args(name)]
    assert all(t.is_meta for t in getattr(ops, name)(*args))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(wrapper, f"{name}_cuda")(*args)


@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_recurrence_wrappers_raise_on_a_failed_build_or_launch(
        name, monkeypatch, tmp_path):
    """The wrapper past its operand check: a source that does not build
    raises (``nvcc`` fails, or is not installed), and a launch that CUDA
    refuses (the C side returns a CUDA error) raises; neither counts as a
    launch."""
    _, wrapper, _ = RECURRENCES[name]
    args = [a.to("meta") for a in recurrence_args(name)]
    monkeypatch.setattr(wrapper, "check_operand", lambda *a, **k: None)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / f"{name}.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        getattr(wrapper, f"{name}_cuda")(*args)

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(wrapper, "_fn", lambda: lambda *a: 700)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    with pytest.raises(RuntimeError, match="launch failed: cudaError 700"):
        getattr(wrapper, f"{name}_cuda")(*args)
    assert wrapper.launches == before


def test_smoke_script_refuses_to_run_without_a_card(tmp_path):
    """Alone in a directory (no ``src/``) the smoke script prints no result
    and fails; without CUDA it does so in the checkout as well."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    scripts = [lone] if torch.cuda.is_available() else [
        REPO / "chip_smoke.py", lone]
    for script in scripts:
        r = subprocess.run([sys.executable, str(script)],
                           capture_output=True, text=True, timeout=120,
                           cwd=script.parent)
        assert r.returncode != 0 and r.stdout == ""


def test_kernel_build_is_content_addressed():
    names = {_build.library_path(n).name for n in _build.KERNELS}
    assert len(names) == len(_build.KERNELS)
    assert all(n.endswith(".so") and "-" in n for n in names)
    assert _build.BUILD_DIR == REPO / "build" / "repro_torch_kernels"
    assert "sm_90a" in _build.ARCH


def test_slice_modules_import_nothing_of_the_jax_package():
    """The PQ, filter, unfused-scan, telemetry and serve-engine modules are
    among the files checked above, and each imports nothing of JAX or of
    the JAX package."""
    port = REPO / "src" / "repro_torch"
    new = [port / "core" / "filters.py", port / "core" / "pq.py",
           port / "kernels" / "sivf_scan" / "pq_fused.py",
           port / "kernels" / "sivf_scan" / "ops.py",
           port / "kernels" / "sivf_scan" / "sivf_scan.py",
           port / "kernels" / "sivf_scan" / "ref.py"] + [
        port / "kernels" / "topk" / f"{name}.py"
        for name in ("__init__", "ref", "topk", "ops")] + [
        port / "obs" / f"{name}.py"
        for name in ("__init__", "metrics", "trace", "export")] + [
        port / "serve" / f"{name}.py"
        for name in ("quota", "session", "sivf_engine")] + [
        REPO / "src" / "sivf_torch" / "telemetry.py"] + [
        port / "configs" / "whisper_base.py",
        port / "data" / "pipeline.py", port / "launch" / "train.py"] + [
        port / "train" / f"{name}.py"
        for name in ("__init__", "optimizer", "grad_compress",
                     "train_step")] + [
        port / "sharding" / f"{name}.py"
        for name in ("__init__", "axes", "rules")] + [
        port / "launch" / "mesh.py", port / "launch" / "specs.py",
        port / "models" / "parallel.py"] + [
        port / "launch" / f"{name}.py"
        for name in ("dryrun", "roofline", "op_count")] + [
        port / "kernels" / "_meta.py"]
    for path in new:
        assert path in PORT_FILES
        assert not imported_roots(path) & FORBIDDEN, path


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """Editing ``topk_fold.cuh`` renames the libraries of both kernels that
    include it (a stale library is never loaded) and no other."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    header = csrc / "topk_fold.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.KERNELS}
    changed = {n for n in _build.KERNELS if before[n] != after[n]}
    assert changed == {"sivf_fused_search", "sivf_pq_fused_search"}
    assert header in _build.sources("sivf_pq_fused_search")


def test_shared_arithmetic_header_renames_both_raw_scans(tmp_path,
                                                        monkeypatch):
    """``dot_row.cuh`` holds the raw scans' arithmetic: editing it renames
    the fused and the unfused raw scan's libraries, and no other."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    header = csrc / "dot_row.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    changed = {n for n in _build.KERNELS
               if _build.library_path(n) != before[n]}
    assert changed == {"sivf_fused_search", "sivf_scan"}


def test_kernel_list_names_every_source():
    assert "sivf_pq_fused_search" in _build.KERNELS
    assert {"sivf_scan", "topk"} <= set(_build.KERNELS)
    assert {"paged_attention", "flash_attention"} <= set(_build.KERNELS)
    assert {"mamba_scan", "wkv6"} <= set(_build.KERNELS)
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.KERNELS)


def test_trainer_defaults_to_the_card(tmp_path):
    """The launcher runs on the card unless asked for the CPU: where none
    is visible it raises before it builds anything, and writes no
    checkpoint."""
    from repro_torch.launch import train as launcher
    assert launcher.parse([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "llama3-8b", "--reduced", "--steps", "1",
                       "--ckpt-dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


def test_model_mesh_defaults_to_the_card():
    """``ModelMesh.virtual`` puts its shards on the card unless asked for
    another device; without one, placing parameters or a decode cache on
    it raises, as every entry point of the port does."""
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.sharding.rules import make_plan
    mesh = ModelMesh.virtual({"data": 1, "model": 2})
    assert {d.type for d in mesh.devices} == {"cuda"}
    cfg = get_arch("llama3-8b").reduced()
    plan = make_plan(cfg, mesh.shape, "decode", 1)
    if torch.cuda.is_available():
        assert model.init_decode_cache(cfg, plan, 1, 8, mesh=mesh)[0][
            "attn"][0].is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_decode_cache(cfg, plan, 1, 8, mesh=mesh)
    params = model.init_params(cfg, plan, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.forward(params, cfg, plan, {"tokens": torch.zeros(
            (1, 4), dtype=torch.int32)}, mesh=mesh)
    cpu = ModelMesh.virtual({"data": 1, "model": 2}, "cpu")
    assert model.init_decode_cache(cfg, plan, 1, 8, mesh=cpu)[1][
        "attn"][0].device.type == "cpu"
