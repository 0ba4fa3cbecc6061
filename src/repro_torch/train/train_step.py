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
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.sharding.rules import ROADMAP_MESH, ShardPlan
from repro_torch.train.optimizer import (
    OptConfig,
    adamw_update,
    init_opt_state,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1          # gradient accumulation steps
    aux_coef: float = 0.01         # MoE load-balance coefficient


def loss_fn(params: M.DecoderLM, cfg: ModelConfig, plan: ShardPlan,
            batch: dict, aux_coef: float, impl: str = "ref"):
    """(loss, {"loss", "aux"}): ``lm_loss`` of the forward's logits
    against ``batch["labels"]`` plus ``aux_coef`` times the MoE loss."""
    logits, aux, _ = M.forward(params, cfg, plan, batch, impl=impl)
    loss = M.lm_loss(logits, batch["labels"], aux, aux_coef)
    return loss, {"loss": loss.detach(), "aux": aux.detach()}


def make_grad_fn(cfg: ModelConfig, plan: ShardPlan, tcfg: TrainConfig):
    """Returns ``grads_of(params, batch) -> (grads, metrics)``: gradients
    by name through ``impl="ref"``. With ``tcfg.microbatches > 1`` every
    batch entry has a leading microbatch dim; each microbatch's gradient
    is added into float32 accumulators, which are then divided by the
    count, and the metrics are the microbatches' means."""
    def one(params, batch):
        named = dict(params.named_parameters())
        loss, met = loss_fn(params, cfg, plan, batch, tcfg.aux_coef, "ref")
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


def make_train_step(cfg: ModelConfig, plan: ShardPlan, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    gradients of :func:`make_grad_fn`, then AdamW in place. ``metrics``
    has ``loss``, ``aux``, ``grad_norm``, ``lr`` and ``opt_s``, the
    seconds the optimizer took (the device synchronised before and after
    it)."""
    grads_of = make_grad_fn(cfg, plan, tcfg)

    def train_step(state, batch):
        params = state["params"]
        grads, metrics = grads_of(params, batch)
        _sync(params.device)
        t0 = time.perf_counter()
        _, opt, opt_met = adamw_update(
            tcfg.opt, dict(params.named_parameters()), grads, state["opt"])
        del grads
        _sync(params.device)
        return {"params": params, "opt": opt}, {
            **metrics, **opt_met, "opt_s": time.perf_counter() - t0}

    return train_step


def init_train_state(params: M.DecoderLM) -> dict:
    """``{"params", "opt"}``; the parameters start to require
    gradients."""
    for p in params.parameters():
        p.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state(dict(params.named_parameters()))}


def state_specs(*args, **kwargs):
    """The train state's partition specs on a mesh: not ported, the mesh
    plan is not (one card has no model axis)."""
    raise NotImplementedError(f"state_specs needs the mesh plan: "
                              f"{ROADMAP_MESH}")


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
