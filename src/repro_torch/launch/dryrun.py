"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device: the
port's counterpart of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell for the production TPU mesh
and reads the compiled program. The port traces its own mesh program
(``models/parallel.py``) on ``meta`` tensors instead: ``make_plan`` for
``launch.mesh.make_production_mesh`` ((data 16, model 16), or (pod 2,
data 16, model 16)), the parameters and caches from ``launch.specs`` on
``meta``, then ``forward`` (prefill), ``decode_step`` (decode at the last
position of a ``seq_len`` cache) or the train step (loss, gradients of
each shard's blocks, AdamW on its ZeRO-1 moment blocks), counted by
``launch.op_count``. Each cell reports what the reference's does, per
device where the reference's is:

  * ``plan``; ``trace_s`` (the run on ``meta``, in place of ``lower_s``
    and ``compile_s``);
  * ``hlo_flops`` and ``hlo_bytes``: the op count's FLOPs and bytes over
    all ``chips`` (a device's times ``chips``, as the reference reports
    its analyzer's), under the reference's key names, though no HLO is
    read; ``per_device`` the device's own, by kernel too;
  * ``model_flops`` (``roofline.model_flops``) and ``useful_flops_frac``;
  * ``collectives``: the device's by kind and the wire bytes in all;
  * ``memory``: ``argument_bytes`` and ``output_bytes`` a device, exact
    from the plan's blocks (parameters in their storage dtype, caches,
    inputs; for train the float32 state with its ZeRO-1 moments), and
    ``temp_bytes``, the peak of the ``meta`` tensors the run holds live
    divided by the shards run (the shards run in turn, so the live set of
    one sublayer holds every shard's values); ``fits_80gb`` whether the
    three add up to at most 80e9 bytes;
  * ``roofline``: ``roofline.roofline_terms`` on the H100's data-sheet
    peaks.

A cell runs on a mesh whose ``pod`` and ``data`` extents are 1, with one
data shard's rows: its shards hold the production shapes, and a
collective over ``data`` or ``pod`` is priced at its production group
(``op_count.counting``; a gather over them returns the production
shapes, as the MoE fallback of a decode needs).

Resumable: results are kept in ``--out`` (default
``experiments/dryrun_results.json``, git-ignored), a cell that finished
``ok`` is skipped unless ``--force``. ``long_500k`` is skipped for the
pure full-attention archs (``configs.cell_runnable``)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape decode_32k --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, SHAPES, cell_runnable
from repro_torch.launch import op_count
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import ModelMesh, make_production_mesh
from repro_torch.launch.specs import abstract_params, param_shardings
from repro_torch.models import model as M
from repro_torch.models import parallel
from repro_torch.sharding.rules import make_plan
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

HBM_BYTES = 80e9                 # an H100 SXM's device memory


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def input_shapes(cfg, shape, rows: int) -> dict:
    """``{name: (shape, dtype)}`` of one data shard's inputs."""
    s = 1 if shape.kind == "decode" else shape.seq_len
    out = {"tokens": ((rows, s), torch.int32)}
    if shape.kind == "train":
        out["labels"] = ((rows, s), torch.int32)
    act = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        out["prefix_embeds"] = ((rows, cfg.n_prefix_embeds, cfg.d_model),
                                act)
    if cfg.enc_dec and shape.kind != "decode":
        out["enc_frames"] = ((rows, cfg.enc_seq, cfg.d_model), act)
    return out


def rows_of(plan, mesh: ModelMesh, batch: int) -> int:
    """A data shard's rows (all of them where the batch is replicated)."""
    if plan.rules_dict["batch"] is None:
        return batch
    return batch // mesh.extent(plan.batch_axes)


def block_bytes(params, plan, mesh: ModelMesh, moments: dict | None = None
                ) -> int:
    """A device's bytes of ``params``' blocks under the plan's specs on
    ``mesh`` (or under ``moments``' specs, float32 as the moments are)."""
    specs = moments or param_shardings(params, mesh, plan.rules_dict)
    total = 0
    for name, p in params.named_parameters():
        shp = parallel.block_shape(tuple(p.shape), specs[name], mesh)
        total += _nbytes(shp, torch.float32 if moments else p.dtype)
    return total


def cache_bytes(cfg, plan, mesh: ModelMesh, batch: int, max_seq: int) -> int:
    """A device's bytes of the decode cache's blocks."""
    shapes = parallel.cache_shapes(cfg, plan, batch, max_seq,
                                   getattr(torch, cfg.dtype))
    return sum(_nbytes(parallel.block_shape(shp, spec, mesh), dt)
               for entries in shapes.values() for shp, dt, spec in entries)


def _meta_tensors(spec: dict) -> dict:
    return {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in spec.items()}


def _leaves(tree):
    """The same nested blocks as fresh leaves that take gradients (so a
    shard's gradient is its block's, not a scatter into the master)."""
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves(v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype,
                       device="meta").requires_grad_(True)


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def adamw_per_device(params, specs: dict, prod: ModelMesh,
                     tcfg: ts.TrainConfig) -> tuple:
    """(flops, bytes) a device spends in AdamW: each distinct moment block
    of each leaf (under ``specs``, ZeRO-1's) updated once by its owner,
    ``update_leaf`` counted on one ``meta`` block and averaged over the
    devices."""
    one = ModelMesh.virtual({"data": 1, "model": 1}, "meta")
    step = torch.zeros((), dtype=torch.int32, device="meta")
    scalars = None
    flops = bytes_ = 0.0
    for name, p in params.named_parameters():
        spec = specs[name]
        shp = parallel.block_shape(tuple(p.shape), spec, prod)
        blocks = math.prod(prod.extent(e) for e in spec if e is not None)
        g = torch.empty(shp, dtype=torch.float32, device="meta")
        if scalars is None:
            scalars = opt.step_scalars(tcfg.opt, {name: g}, step)
        with op_count.counting(one) as c:
            opt.update_leaf(tcfg.opt, g.clone(), g, g.clone(), g.clone(),
                            scalars, p.dim() + 1)
        flops += c.flops * blocks / prod.size
        bytes_ += c.bytes * blocks / prod.size
    return flops, bytes_


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             mesh_shape: dict | None = None) -> dict:
    """One cell. ``mesh_shape`` replaces the production ``{data, model}``
    extents (a smaller mesh; ``pod`` 2 is added for ``multi_pod``)."""
    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    if mesh_shape is None:
        prod = make_production_mesh(multi_pod=multi_pod)
    else:
        prod = ModelMesh.virtual(
            {**({"pod": 2} if multi_pod else {}), **mesh_shape}, "meta")
    plan = make_plan(cfg, prod.shape, shape.kind, shape.global_batch)
    chips = prod.size
    rows = rows_of(plan, prod, shape.global_batch)
    run = ModelMesh.virtual(
        {a: (n if a == "model" else 1) for a, n in prod.shape.items()},
        "meta")
    inputs = input_shapes(cfg, shape, rows)
    tcfg = ts.TrainConfig()
    t0 = time.perf_counter()
    params = abstract_params(cfg, plan, shape.seq_len,
                             torch.float32 if shape.kind == "train" else None)
    batch = _meta_tensors(inputs)
    with op_count.counting(run, prod) as counts:
        if shape.kind == "prefill":
            with torch.no_grad():
                logits, _, _ = M.forward(params, cfg, plan, batch,
                                         mesh=run)
        elif shape.kind == "decode":
            caches = M.init_decode_cache(cfg, plan, rows, shape.seq_len,
                                         mesh=run)
            logits, _ = M.decode_step(params, cfg, plan, batch["tokens"],
                                      caches, shape.seq_len - 1, mesh=run)
        else:
            sps = _leaves(parallel.sharded(params, plan, run))
            loss, _ = ts.loss_fn(sps, cfg, plan, batch, tcfg.aux_coef,
                                 "ref", mesh=run)
            torch.autograd.grad(loss, _flat(sps), allow_unused=True)
            logits = None
    per = counts.per_device()
    specs = param_shardings(params, prod, plan.rules_dict)
    out_bytes = 0
    if shape.kind == "train":
        mom = ts.state_specs(specs, dict(params.named_parameters()),
                             plan.batch_axes, prod.shape, zero1=True)
        of, ob = adamw_per_device(params, mom["opt"]["mu"], prod, tcfg)
        per["flops"] += of
        per["memory_bytes"] += ob
        per["adamw"] = {"flops": of, "bytes": ob}
        state = block_bytes(params, plan, prod) + 2 * block_bytes(
            params, plan, prod, mom["opt"]["mu"]) + 4
        arg = state + sum(_nbytes(*v) for v in inputs.values())
        out_bytes = state
    else:
        arg = block_bytes(params, plan, prod) + \
            sum(_nbytes(*v) for v in inputs.values())
        s = 1 if shape.kind == "decode" else shape.seq_len
        out_bytes = _nbytes((rows, s, plan.vocab_padded // plan.model_size),
                            logits.dtype)
        if shape.kind == "decode":
            cb = cache_bytes(cfg, plan, prod, shape.global_batch,
                             shape.seq_len)
            arg += cb
            out_bytes += cb
    trace_s = time.perf_counter() - t0
    flops = per["flops"] * chips
    bytes_acc = per["memory_bytes"] * chips
    terms = R.roofline_terms(flops, bytes_acc,
                             per["collective_wire_bytes"] * chips, chips,
                             per["network_wire_bytes"] * chips)
    mflops = R.model_flops(cfg, shape)
    temp = per["peak_live_bytes"]
    return {
        "status": "ok", "arch": arch, "shape": shape_name,
        "mesh": ("multi_pod_" if multi_pod else "single_pod_")
        + "x".join(str(n) for n in prod.shape.values()),
        "chips": chips,
        "plan": {"n_heads_padded": plan.n_heads_padded,
                 "n_kv_heads_padded": plan.n_kv_heads_padded,
                 "kv_sharded": plan.kv_sharded,
                 "vocab_padded": plan.vocab_padded,
                 "n_experts_padded": plan.n_experts_padded},
        "counted_on": run.shape, "trace_s": round(trace_s, 2),
        "hlo_flops": flops, "hlo_bytes": bytes_acc,
        "model_flops": mflops,
        "useful_flops_frac": mflops / flops if flops else None,
        "per_device": per,
        "memory": {"argument_bytes": arg, "output_bytes": out_bytes,
                   "temp_bytes": temp,
                   "fits_80gb": arg + out_bytes + temp <= HBM_BYTES},
        "collectives": {"per_device": per["collectives"],
                        "wire_bytes_total": (per["collective_wire_bytes"]
                                             + per["network_wire_bytes"])
                        * chips},
        "roofline": terms,
    }


def cell_key(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}|{shape}|{'multi' if multi_pod else 'single'}"


def sweep(archs, shapes, meshes, out_path: Path, force: bool = False
          ) -> dict:
    """Run (or skip) every cell, writing ``out_path`` after each."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}
    for arch in archs:
        for shape in shapes:
            runnable, reason = cell_runnable(ARCHS[arch], SHAPES[shape])
            for mp in meshes:
                key = cell_key(arch, shape, mp)
                if results.get(key, {}).get("status") == "ok" and not force:
                    print(f"[skip-cached] {key}")
                    continue
                if not runnable:
                    results[key] = {"status": "skipped", "arch": arch,
                                    "shape": shape, "reason": reason}
                    print(f"[skip] {key}: {reason}")
                else:
                    print(f"[trace] {key} ...", flush=True)
                    try:
                        r = results[key] = run_cell(arch, shape, mp)
                        print(f"  ok: trace={r['trace_s']}s "
                              f"flops={r['hlo_flops']:.3e} "
                              f"dominant={r['roofline']['dominant']}",
                              flush=True)
                    except Exception as e:
                        results[key] = {
                            "status": "error", "arch": arch, "shape": shape,
                            "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-2000:]}
                        print(f"  ERROR: {e}", flush=True)
                out_path.write_text(json.dumps(results, indent=1))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_results.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = sweep(archs, shapes, meshes, Path(args.out), args.force)
    n = {s: sum(1 for v in results.values() if v.get("status") == s)
         for s in ("ok", "skipped", "error")}
    print(f"\ndone: {n['ok']} ok, {n['skipped']} skipped (documented), "
          f"{n['error']} errors")
    return 1 if n["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
