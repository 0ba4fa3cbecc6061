"""Training step: loss -> gradients -> AdamW, with microbatch gradient
accumulation (counterpart of ``repro/train/train_step.py``).

The reference trains through ``impl="xla"``: autodiff over its plain
paths. No Pallas kernel of the reference has a backward pass, so the port
trains through its plain (``impl="ref"``) paths with ``torch.autograd``,
on the card or the CPU alike: no hand-written kernel runs in a train
step, and none is written for one. The parameters are the trainer's
float32 master weights (``init_params(..., dtype=torch.float32)``);
every use casts a weight to the activation dtype (``cfg.dtype``), so
gradients arrive in float32.

State is ``{"params": DecoderLM, "opt": optimizer state}``; the
optimizer's trees are ``dict(params.named_parameters())``.

On a model mesh (``launch.mesh.ModelMesh``) the forward runs
tensor-parallel (``models.parallel``) on blocks of the master weights;
on a virtual mesh the blocks are views, so the gradients of every shard
land in the master tensors' own (the sum over the shards that hold a
block). The moments are held as the distinct blocks of
:func:`state_specs`' moment specs (:class:`ShardedMoments`), ZeRO-1's
with ``zero1=True``; each block is updated once, by the first shard that
holds it.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.launch.specs import block, param_shardings
from repro_torch.sharding.rules import ShardPlan
from repro_torch.train.optimizer import (
    OptConfig,
    adamw_update,
    init_opt_state,
    step_scalars,
    update_leaf,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1          # gradient accumulation steps
    aux_coef: float = 0.01         # MoE load-balance coefficient


def loss_fn(params: M.DecoderLM, cfg: ModelConfig, plan: ShardPlan,
            batch: dict, aux_coef: float, impl: str = "ref", mesh=None):
    """(loss, {"loss", "aux"}): ``lm_loss`` of the forward's logits
    against ``batch["labels"]`` plus ``aux_coef`` times the MoE loss."""
    logits, aux, _ = M.forward(params, cfg, plan, batch, impl=impl,
                               mesh=mesh)
    labels = batch["labels"].to(logits.device)
    loss = M.lm_loss(logits, labels, aux, aux_coef)
    return loss, {"loss": loss.detach(), "aux": aux.detach()}


def make_grad_fn(cfg: ModelConfig, plan: ShardPlan, tcfg: TrainConfig,
                 mesh=None):
    """Returns ``grads_of(params, batch) -> (grads, metrics)``: gradients
    by name through ``impl="ref"``. With ``tcfg.microbatches > 1`` every
    batch entry has a leading microbatch dim; each microbatch's gradient
    is added into float32 accumulators, which are then divided by the
    count, and the metrics are the microbatches' means. With ``mesh`` the
    forward runs on it."""
    def one(params, batch):
        named = dict(params.named_parameters())
        loss, met = loss_fn(params, cfg, plan, batch, tcfg.aux_coef, "ref",
                            mesh)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(named.items(), gs)}, met

    def grads_of(params, batch):
        if tcfg.microbatches == 1:
            return one(params, batch)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.named_parameters()}
        mets = []
        for i in range(tcfg.microbatches):
            g, met = one(params, {k: v[i] for k, v in batch.items()})
            for n, a in acc.items():
                a += g[n]
            del g
            mets.append(met)
        for a in acc.values():           # in place: no second copy
            a.div_(tcfg.microbatches)
        return acc, {k: torch.stack([m[k] for m in mets]).mean()
                       for k in mets[0]}

    return grads_of


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_train_step(cfg: ModelConfig, plan: ShardPlan, tcfg: TrainConfig,
                    mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    gradients of :func:`make_grad_fn`, then AdamW in place. ``metrics``
    has ``loss``, ``aux``, ``grad_norm``, ``lr`` and ``opt_s``, the
    seconds the optimizer took (the device synchronised before and after
    it). With ``mesh`` the state is :func:`init_train_state`'s for that
    mesh and AdamW runs block by block (:func:`adamw_update_sharded`)."""
    grads_of = make_grad_fn(cfg, plan, tcfg, mesh)
    update = adamw_update if mesh is None else adamw_update_sharded

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = grads_of(params, batch)
        _sync(params.device)
        t0 = time.perf_counter()
        _, opt, opt_met = update(
            tcfg.opt, dict(params.named_parameters()), grads, state["opt"],
            decay_ndims(params))
        del grads
        _sync(params.device)
        return {"params": params, "opt": opt}, {
            **metrics, **opt_met, "opt_s": time.perf_counter() - t0}

    return train_step


def decay_ndims(params: M.DecoderLM) -> dict:
    """Each parameter's rank in the reference's tree, which decides its
    weight decay (``ndim >= 2``): there a layer's leaves are stacked over
    the layers (and an encoder's over its layers), one dim more than the
    port's, so a layer's norm scales decay as its matrices do."""
    return {n: p.dim() + n.startswith(("layers.", "encoder.layers."))
            for n, p in params.named_parameters()}


def init_train_state(params: M.DecoderLM, mesh=None,
                     moment_specs: dict | None = None) -> dict:
    """``{"params", "opt"}``; the parameters start to require gradients.
    With ``mesh``, the moments are :class:`ShardedMoments` under
    ``moment_specs`` (``state_specs(...)["opt"]["mu"]``)."""
    for p in params.parameters():
        p.requires_grad_(True)
    named = dict(params.named_parameters())
    if mesh is None:
        return {"params": params, "opt": init_opt_state(named)}
    return {"params": params, "opt": {
        "mu": ShardedMoments(named, moment_specs, mesh),
        "nu": ShardedMoments(named, moment_specs, mesh),
        "step": torch.zeros((), dtype=torch.int32,
                            device=mesh.devices[0])}}


def state_specs(param_specs: dict, params_abs: dict | None = None,
                batch_axes: tuple = ("data",), mesh_axes: dict | None = None,
                zero1: bool = False) -> dict:
    """The train state's specs (``sharding.axes``' tuples):
    ``{"params", "opt": {"mu", "nu", "step"}}``. The moments shard as the
    parameters do; with ``zero1``, each moment also shards its first dim
    that no axis shards over the batch axes, where their extent divides
    it (ZeRO-1: the optimizer's memory drops by about the data extent).
    ``params_abs`` maps each name to a tensor of its shape (the ``meta``
    device will do)."""
    def moment_spec(spec: tuple, leaf) -> tuple:
        if not zero1 or leaf is None or mesh_axes is None:
            return spec
        dp = 1
        for a in batch_axes:
            dp *= mesh_axes[a]
        entries = list(spec) + [None] * (leaf.dim() - len(spec))
        for d in range(leaf.dim()):
            if entries[d] is None and leaf.shape[d] % dp == 0 \
                    and leaf.shape[d] >= dp:
                entries[d] = batch_axes if len(batch_axes) > 1 \
                    else batch_axes[0]
                return tuple(entries)
        return spec

    moments = param_specs
    if zero1 and params_abs is not None:
        moments = {n: moment_spec(sp, params_abs[n])
                   for n, sp in param_specs.items()}
    return {"params": param_specs,
            "opt": {"mu": moments, "nu": moments, "step": ()}}


def mesh_state_specs(params: M.DecoderLM, plan: ShardPlan, mesh,
                     zero1: bool = False) -> dict:
    """:func:`state_specs` of ``params`` on ``mesh`` under ``plan``."""
    specs = param_shardings(params, mesh, plan.rules_dict)
    return state_specs(specs, dict(params.named_parameters()),
                       plan.batch_axes, mesh.shape, zero1)


def _block_key(spec: tuple, mesh, s: int) -> tuple:
    """Which block of a tensor under ``spec`` shard ``s`` holds."""
    return tuple(0 if e is None else mesh.position(s, e) for e in spec)


class ShardedMoments:
    """A moment tree on a mesh: for each parameter, its distinct blocks
    under its moment spec (``blocks[name][key]``, ``key`` the block's
    index along each dim), zero, float32 as the parameters are; each
    block on the device of the first shard that holds it (``owner``).
    Shards that differ only along axes the spec does not name hold the
    same block: on one device it is kept once."""

    def __init__(self, params: dict, specs: dict, mesh):
        self.mesh, self.specs = mesh, specs
        self.blocks, self.owner = {}, {}
        for name, p in params.items():
            blocks, owner = {}, {}
            for s in range(mesh.size):
                key = _block_key(specs[name], mesh, s)
                if key not in blocks:
                    owner[key] = s
                    blocks[key] = torch.zeros_like(
                        block(p.detach(), specs[name], mesh, s),
                        memory_format=torch.contiguous_format)
            self.blocks[name], self.owner[name] = blocks, owner

    def shard_bytes(self, s: int) -> int:
        """The bytes of the blocks shard ``s`` holds."""
        return sum(self.blocks[n][_block_key(sp, self.mesh, s)].nbytes
                   for n, sp in self.specs.items())


def adamw_update_sharded(cfg: OptConfig, params: dict, grads: dict,
                         opt_state: dict, ndims: dict | None = None
                         ) -> tuple[dict, dict, dict]:
    """``adamw_update`` over :class:`ShardedMoments`: the same scalars
    (the global norm of the whole gradients), then each distinct moment
    block updated once, on its owner's device, with its block of the
    parameter and the gradient; the new block is written into the master
    parameter. ``ndims`` as ``adamw_update``'s."""
    mu, nu = opt_state["mu"], opt_state["nu"]
    mesh = mu.mesh
    scalars = step_scalars(cfg, grads, opt_state["step"])
    with torch.no_grad():
        for name, p in params.items():
            spec = mu.specs[name]
            for key, s in mu.owner[name].items():
                m_blk, v_blk = mu.blocks[name][key], nu.blocks[name][key]
                view = p
                for d, e in enumerate(spec):
                    if e is not None:
                        size = p.shape[d] // mesh.extent(e)
                        view = view.narrow(d, key[d] * size, size)
                g = block(grads[name], spec, mesh, s)
                ndim = p.dim() if ndims is None else ndims[name]
                if m_blk.device == p.device:
                    update_leaf(cfg, view, g, m_blk, v_blk, scalars, ndim)
                else:
                    work = view.to(m_blk.device)
                    update_leaf(cfg, work, g, m_blk, v_blk, tuple(
                        t.to(m_blk.device) for t in scalars), ndim)
                    view.copy_(work)
        opt_state["step"] += 1
    return params, opt_state, {"grad_norm": scalars[0], "lr": scalars[2]}


def state_leaves(state: dict) -> list:
    """The state as a list of tensors for ``CheckpointManager``: the
    parameters in ``named_parameters`` order, then ``mu`` and ``nu`` in
    that order, then the step."""
    names = [n for n, _ in state["params"].named_parameters()]
    params = dict(state["params"].named_parameters())
    return ([params[n] for n in names]
            + [state["opt"]["mu"][n] for n in names]
            + [state["opt"]["nu"][n] for n in names]
            + [state["opt"]["step"]])


def load_state_leaves(state: dict, arrays: list) -> dict:
    """Copy :func:`state_leaves`-ordered host arrays into ``state``'s
    tensors, in place (shapes and dtypes checked); returns ``state``."""
    dst = state_leaves(state)
    if len(arrays) != len(dst):
        raise ValueError(f"{len(arrays)} arrays for {len(dst)} leaves")
    with torch.no_grad():
        for t, a in zip(dst, arrays):
            src = torch.from_numpy(a)
            if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                raise ValueError(f"leaf {tuple(src.shape)} {src.dtype}, "
                                 f"want {tuple(t.shape)} {t.dtype}")
            t.copy_(src)
    return state
