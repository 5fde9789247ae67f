"""The ZeRO-1 twin of the model's train step over a dp x sp x tp mesh.

Counterpart of ``tpu_patterns/models/transformer.py::make_zero_train_step``
on ``parallel/zero.py`` and ``parallel/optim.py``.  Parameters persist
sharded over dp: rank (d, s, t) owns flat slice d of the zero-padded
flat of its tp-local block (each leaf of ``param_specs``), and the
optimizer state exists only on that slice.  A step:

    all-gather the slices over dp (``zero.unshard``)  ->  forward and
    backward over the world  ->  sum each leaf's grad over sp (and tp
    for a tp-replicated leaf)  ->  reduce-scatter over dp
    (``zero.grad_shard``)  ->  sgd or adam on each rank's slice

Every sp replica of a slice updates bit-identically.  With
``offload_state=True`` the moments live in pinned host memory between
steps, brought in before the update and sent back after it with
``non_blocking=True`` copies, each direction behind an event (on CPU
ranks the state is host memory already).
"""

from __future__ import annotations

import math

import torch

from tpu_patterns_torch.models.transformer import (
    MESH_AXES,
    ModelConfig,
    _check_kv_heads_shardable,
    loss_mesh,
    n_experts,
    param_specs,
    reduce_groups,
    sum_over,
    unused_ok,
    world_grads,
)
from tpu_patterns_torch.parallel import optim, zero
from tpu_patterns_torch.parallel.optim import tree_map

OPTIMIZERS = {"sgd": optim.sgd, "adam": optim.adam}


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """A rank's block shape of a global ``shape`` split per ``spec``."""
    return tuple(n // mesh.dim(a) if a else n for n, a in zip(shape, spec))


def shard_specs(mesh, cfg: ModelConfig) -> dict[str, tuple[tuple, tuple]]:
    """Each leaf's ZeRO global array and its spec: ``[tp, dp * k]`` split
    ("tp", "dp") for a tp-split leaf, ``[dp * k]`` split ("dp",) for a
    tp-replicated one, k the per-rank slice of the tp-local block;
    replicated over sp.  The shape changes with dp only through the
    padding, so a run saved on one dp resumes on another where the
    block's size divides both."""
    dp = mesh.dim("dp")
    out = {}
    for name, (shape, spec) in param_specs(cfg, n_experts(mesh, cfg)).items():
        n = math.prod(local_shape(shape, spec, mesh))
        k = zero.shard_size(n, dp)
        out[name] = (((mesh.dim("tp"), dp * k), ("tp", "dp")) if "tp" in spec
                     else ((dp * k,), ("dp",)))
    return out


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def make_zero_train_step(mesh, cfg: ModelConfig, lr: float = 1e-3,
                         optimizer: str = "adam", offload_state: bool = False,
                         n_global: float = 1.0, donate: bool = False):
    """``(step, init, specs)``: ``init(params) -> (shards, state)`` from
    per-rank params (``shard_params``); ``step(shards, state, xs) ->
    (shards, state, loss)``; ``step.gather(shards)`` rebuilds the
    per-rank params (``gather_params`` makes them global); ``specs`` is
    :func:`shard_specs`.  ``shards`` is a dict of per-rank flat slices,
    ``state`` the list over ranks of each rank's optimizer state over its
    slices.  ``donate=True`` writes the new slices and moments into the
    caller's buffers."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; want adam|sgd")
    tx = OPTIMIZERS[optimizer](lr)
    _check_kv_heads_shardable(cfg, mesh)
    specs = param_specs(cfg, n_experts(mesh, cfg))
    unused = unused_ok(mesh, specs)
    dp_groups = mesh.groups("dp")
    # the dp sum is the reduce-scatter's; the others are summed first
    pre = {k: reduce_groups(mesh, s, tuple(a for a in MESH_AXES
                                           if a != "dp"))
           for k, (_, s) in specs.items()}
    templates = {k: torch.empty(local_shape(shape, s, mesh),
                                dtype=cfg.torch_dtype, device="meta")
                 for k, (shape, s) in specs.items()}
    offload = offload_state and mesh.on_cuda

    def by_dp(fn, per_rank: list) -> list:
        out = [None] * mesh.size
        for g in dp_groups:
            for r, v in zip(g, fn([per_rank[r] for r in g])):
                out[r] = v
        return out

    def init(params: dict):
        shards = {k: [s.clone() for s in by_dp(zero.param_shard, v)]
                  for k, v in params.items()}
        state = [tx.init({k: shards[k][r] for k in shards})
                 for r in range(mesh.size)]
        if offload:
            state = [tree_map(_pinned_copy, st) for st in state]
            for dev in mesh.ranks.cards():
                torch.cuda.synchronize(dev)
        return shards, state

    def gather(shards: dict) -> dict:
        return {k: by_dp(lambda g, _t=templates[k]: zero.unshard(
            [_t] * len(g), g), v) for k, v in shards.items()}

    streams: dict = {}  # card -> the copy stream the moments come in on

    def bring_in(state: list):
        """The moments onto each rank's card, copied on a side stream
        (beside the forward and backward) behind an event a card that
        the update waits for."""
        moved = []
        for st, dev in zip(state, mesh.devices):
            if dev not in streams:
                streams[dev] = torch.cuda.Stream(dev)
            side = streams[dev]
            if dev in step.out_events:  # the last step's copies out
                side.wait_event(step.out_events[dev])
            with torch.cuda.stream(side):
                moved.append(tree_map(
                    lambda t, _d=dev: t.to(_d, non_blocking=True), st))
        events = {}
        for dev, side in streams.items():
            events[dev] = torch.cuda.Event()
            events[dev].record(side)
        return moved, events

    def wait_in(moved: list, events: dict) -> None:
        for dev, ev in events.items():
            torch.cuda.current_stream(dev).wait_event(ev)
        for st, dev in zip(moved, mesh.devices):
            tree_map(lambda t, _d=dev: t.record_stream(
                torch.cuda.current_stream(_d)), st)

    def send_back(state: list, into: list | None) -> list:
        """The moments back to pinned host memory (into the caller's
        buffers when donating), non-blocking behind an event that
        ``step.sync()`` waits for before the host reads them."""
        if into is None:
            out = [tree_map(_pinned_copy, st) for st in state]
        else:
            out = into
            for dst, src in zip(into, state):
                tree_map(lambda a, b: a.copy_(b, non_blocking=True), dst,
                         src)
        step.out_events = {}
        for dev in mesh.ranks.cards():
            step.out_events[dev] = torch.cuda.Event()
            step.out_events[dev].record(torch.cuda.current_stream(dev))
        return out

    def step(shards: dict, state: list, xs: list):
        step.calls += 1
        if offload:
            live, events = bring_in(state)
        params = gather(shards)
        loss, grads = world_grads(
            lambda leaves: loss_mesh(mesh, leaves, xs, cfg, n_global),
            params, unused)
        gs = {k: by_dp(zero.grad_shard, sum_over(pre[k], g))
              for k, g in grads.items()}
        if offload:
            wait_in(live, events)
        else:
            live = state
        new_shards = {k: [None] * mesh.size for k in shards}
        new_state = []
        with torch.no_grad():
            for r in range(mesh.size):
                p = {k: shards[k][r] for k in shards}
                updates, st = tx.update({k: gs[k][r] for k in gs}, live[r],
                                        p)
                for k, v in optim.apply_updates(p, updates).items():
                    new_shards[k][r] = v
                new_state.append(st)
            if donate:
                for k in shards:
                    for old, new in zip(shards[k], new_shards[k]):
                        old.copy_(new)
                new_shards = shards
            if offload:
                new_state = send_back(new_state, state if donate else None)
            elif donate:
                for old, new in zip(state, new_state):
                    tree_map(lambda a, b: a.copy_(b), old, new)
                new_state = state
        return new_shards, new_state, loss

    def sync() -> None:
        for ev in step.out_events.values():
            ev.synchronize()

    step.calls = 0
    step.out_events = {}
    step.gather = gather
    step.sync = sync
    return step, init, shard_specs(mesh, cfg)
