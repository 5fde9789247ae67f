"""The pipelined stack: the model's train step over a dp x sp x tp x pp
mesh.

Counterpart of ``tpu_patterns/models/transformer.py``'s
``init_stack_params``, ``stack_specs`` and ``make_pipeline_train_step``.
Stage p is one block whose parameters live on the ranks at pipeline
coordinate p, split over their (dp, sp, tp) sub-mesh as the flat step
splits a layer; its activation is the list over that sub-mesh, and the
schedules of ``parallel/pipeline.py`` move it one stage a tick slot by
slot.  A stage's forward is ``transformer.forward_mesh`` over its
sub-mesh (the ring at sp > 1, the tp sums), so microbatches stream
through the same collectives as the flat step.  Two schedules:

* "gpipe": ``pipeline_apply`` forward, autograd over the whole world
  backward;
* "1f1b": ``pipeline_train_1f1b``, each backward slot recomputing its
  stage from the stash.

Either way each leaf's gradient is then summed over the (dp, sp) ranks
holding its block (and tp for the gate) and SGD runs on each rank.  The
objective is the reference's unnormalised sum(out ** 2) over the
microbatches, each (dp, sp) shard counted once.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_patterns_torch.models.transformer import (
    MESH_AXES,
    ModelConfig,
    _check_kv_heads_shardable,
    forward_mesh,
    init_params,
    n_experts,
    param_specs,
    reduce_groups,
    sgd_update,
    sum_over,
    unused_ok,
    world_grads,
)
from tpu_patterns_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_train_1f1b,
)


def init_stack_params(gen: torch.Generator, cfg: ModelConfig,
                      n_stages: int, device="cpu", n_experts: int = 0
                      ) -> dict[str, torch.Tensor]:
    """Per-stage parameters stacked on a leading ``[n_stages]`` axis (the
    depth axis of ``init_params`` with one layer a stage)."""
    return init_params(gen, dataclasses.replace(cfg, depth=n_stages), device,
                       n_experts)


def stack_specs(cfg: ModelConfig, n_stages: int, n_experts: int = 0
                ) -> dict[str, tuple[tuple, tuple]]:
    """Each stacked leaf's global shape and spec: the leading axis over
    "pp", the rest as ``param_specs``."""
    return param_specs(dataclasses.replace(cfg, depth=n_stages), n_experts,
                       lead="pp")


def make_pipeline_train_step(mesh, cfg: ModelConfig, n_micro: int,
                             lr: float = 1e-3, schedule: str = "gpipe"):
    """``step(params, xs) -> (new_params, loss)`` over a ("dp", "sp",
    "tp", "pp") mesh: params a dict of per-rank lists of each rank's
    ``[1, ...]`` block of a :func:`stack_specs` stack (``shard_params``
    with ``lead="pp"``), xs each rank's [B/dp, L/sp, E] shard
    (replicated over tp and pp); ``n_micro`` must divide B/dp."""
    if cfg.depth > 1:
        raise ValueError(
            "pipeline stages are single blocks; express depth as pp stages "
            "(init_stack_params), not ModelConfig.depth")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    _check_kv_heads_shardable(cfg, mesh)
    pp = mesh.dim("pp")
    stages = [mesh.sub("pp", p) for p in range(pp)]
    geometry = stages[0][0]  # every stage's sub-mesh has this shape
    loss_slots = [i for i in range(geometry.size)
                  if geometry.coord(i)["tp"] == 0]
    specs = stack_specs(cfg, pp, n_experts(mesh, cfg))
    groups = {k: reduce_groups(mesh, s, MESH_AXES)
              for k, (_, s) in specs.items()}
    unused = unused_ok(mesh, specs)

    def stage_fn(layers, xs):
        return forward_mesh(geometry, layers, xs, cfg)

    def split(params: dict, xs: list):
        b = xs[0].shape[0]
        if b % n_micro:
            raise ValueError(f"n_micro {n_micro} must divide the dp-local "
                             f"batch {b}")
        stage_params = [[{k: v[r][0] for k, v in params.items()}
                         for r in ranks] for _, ranks in stages]
        micro = [[xs[r].reshape(n_micro, b // n_micro, *xs[r].shape[1:])
                  for r in ranks] for _, ranks in stages]
        return stage_params, micro

    def objective(ys: list) -> torch.Tensor:
        home = ys[0].device
        return sum((ys[i].float() ** 2).sum().to(home) for i in loss_slots)

    def gpipe(params: dict, xs: list):
        def loss_fn(leaves):
            stage_params, micro = split(leaves, xs)
            outs = pipeline_apply(stage_fn, stage_params, micro)
            return objective(outs[0])

        return world_grads(loss_fn, params, unused)

    def one_f_one_b(params: dict, xs: list):
        def out_grad(ys):
            dys = [torch.zeros_like(y) for y in ys]
            for i in loss_slots:
                dys[i] = (2.0 * ys[i].float()).to(ys[i].dtype)
            return objective(ys), dys

        stage_params, micro = split(params, xs)
        losses, stage_grads = pipeline_train_1f1b(stage_fn, stage_params,
                                                  micro, out_grad)
        grads = {k: [None] * mesh.size for k in params}
        for (_, ranks), per_rank in zip(stages, stage_grads):
            for r, g in zip(ranks, per_rank):
                for k in params:
                    grads[k][r] = g[k][None]
        return losses[0], grads

    run = gpipe if schedule == "gpipe" else one_f_one_b

    def step(params: dict, xs: list):
        step.calls += 1
        loss, grads = run(params, xs)
        grads = {k: sum_over(groups[k], g) for k, g in grads.items()}
        return sgd_update(params, grads, lr), loss

    step.calls = 0
    return step
