"""Pipeline parallelism: microbatches streamed through pipeline ranks.

Counterpart of ``tpu_patterns/parallel/pipeline.py``.  Stage s (rank s)
owns one layer's parameters; microbatches enter at stage 0, activations
hop one stage a tick (``comm/ring.py::ring_shift``), outputs drain from
the last stage.  Two schedules:

* :func:`pipeline_apply`: GPipe, all forwards in n_micro + pp - 1
  ticks; autograd differentiates it for the backward;
* :func:`pipeline_train_1f1b`: one forward and one backward slot a
  cycle over n_micro + 2(pp - 1) cycles, the forward inputs in a ring
  stash of at most 2pp - 1 slots.

There every rank runs the same program inside ``shard_map``.  Here a
function takes and returns per-rank lists (``comm/mesh.py``) and loops
over the ranks in each tick: rank r is a Python int, so the reference's
``where(is_first, ...)`` is a branch.  As in the reference's uniform
SPMD program, every rank computes every tick, a tick where it holds no
live microbatch included (on garbage, discarded).  Ranks that share a
card run one after another, so the bubble is not idle time on the card
there, and a step's time is the world's serial time.

A stage's activation, microbatches and params may be trees of tensors
(a list over the stage's own sub-mesh, as the model's pipelined step
gives them, ``models/pipeline_step.py``): every hop, feed and drain then
works leaf by leaf, each leaf's ring over the pipeline ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree

from tpu_patterns_torch.comm.mesh import RankMesh, default_mesh
from tpu_patterns_torch.comm.ring import library_allreduce, ring_shift
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.parallel.optim import tree_map
from tpu_patterns_torch.runtime import exact_f32, torch_dtype


def bubble_fraction(schedule: str, pp: int, n_micro: int) -> float:
    """Analytic idle fraction of the schedule's makespan.

    gpipe: pp-1 idle ticks in each direction over n_micro+pp-1 ticks
    each, the classic (pp-1)/(n_micro+pp-1).  1f1b (phase-aligned, see
    :func:`pipeline_train_1f1b`): 2(pp-1) idle cycles over
    n_micro+2(pp-1)."""
    if schedule == "gpipe":
        return (pp - 1) / (n_micro + pp - 1)
    if schedule == "1f1b":
        return 2 * (pp - 1) / (n_micro + 2 * (pp - 1))
    raise ValueError(f"unknown schedule {schedule!r}")


def peak_stash_microbatches(schedule: str, pp: int, n_micro: int) -> int:
    """Peak live forward activations a rank holds (in microbatches).

    gpipe differentiated by autograd keeps one residual a forward tick:
    n_micro + pp - 1.  1f1b stashes into a ring whose size is bounded by
    the pipeline depth, not the microbatch count: 2pp - 1."""
    if schedule == "gpipe":
        return n_micro + pp - 1
    if schedule == "1f1b":
        return min(2 * pp - 1, n_micro + 2 * (pp - 1))
    raise ValueError(f"unknown schedule {schedule!r}")


def _leaves(tree: Any) -> list:
    return _pytree.tree_flatten(tree)[0]


def _shift(trees: Sequence[Any], shift: int = 1) -> list:
    """``ring_shift`` of per-rank trees, leaf by leaf."""
    if isinstance(trees[0], torch.Tensor):
        return ring_shift(trees, shift)
    flat = [_pytree.tree_flatten(t) for t in trees]
    cols = [ring_shift([leaves[j] for leaves, _ in flat], shift)
            for j in range(len(flat[0][0]))]
    return [_pytree.tree_unflatten([c[r] for c in cols], flat[0][1])
            for r in range(len(trees))]


def _replicate_from(trees: Sequence[Any], owner: int) -> list:
    """Rank ``owner``'s tree on every rank, as the reference's psum over
    a one-hot owner: a sum over the ranks, zeros but the owner's, leaf
    by leaf."""
    flat = [_pytree.tree_flatten(t) for t in trees]
    cols = [library_allreduce([leaves[j] if r == owner
                               else torch.zeros_like(leaves[j])
                               for r, (leaves, _) in enumerate(flat)])
            for j in range(len(flat[0][0]))]
    return [_pytree.tree_unflatten([c[r] for c in cols], flat[0][1])
            for r in range(len(trees))]


def _loader_step(c: int, loaders: list[torch.Tensor],
                 store: Sequence[torch.Tensor]
                 ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Microbatch conveyor: microbatches live sharded over the ranks
    (rank r stores micro[r*K:(r+1)*K], K = n_micro/pp); one slab a rank
    rides a leftward ring toward stage 0, timed so that rank 0 holds
    micro[c] at cycle c.

    Rank r injects its j-th stored slab at cycle r*(K-1) + j; the slab
    travels r hops (one a cycle) and reaches rank 0 at cycle r*K + j, its
    global index.  Returns (what each rank holds this cycle, the loaders
    after the hop); rank 0 reads the first."""
    consumed = []
    for r, (loader, slabs) in enumerate(zip(loaders, store)):
        k = _leaves(slabs)[0].shape[0]
        j = c - r * (k - 1)
        consumed.append(tree_map(lambda a, _j=j: a[_j], slabs)
                        if 0 <= j < k else loader)
    return consumed, _shift(consumed, -1)


def _feed(c: int, micro: Sequence[torch.Tensor], loaders, micro_sharded,
          n_micro: int):
    """(stage 0's fresh microbatch for cycle c, the loaders after it)."""
    if micro_sharded:
        fresh, loaders = _loader_step(c, loaders, micro)
        return fresh[0], loaders
    i = min(c, n_micro - 1)
    return tree_map(lambda a: a[i], micro[0]), loaders


def _n_micro(micro: Sequence[Any], micro_sharded: bool) -> int:
    k = _leaves(micro[0])[0].shape[0]
    return k * len(micro) if micro_sharded else k


def _first_slots(micro: Sequence[Any]) -> list:
    """Zeros shaped like one microbatch, a tree a rank."""
    return [tree_map(lambda a: torch.zeros_like(a[0]), m) for m in micro]


def pipeline_apply(stage_fn: Callable, stage_params: Sequence[Any],
                   micro: Sequence[torch.Tensor],
                   micro_sharded: bool = False) -> list[torch.Tensor]:
    """Run n_micro microbatches through ``len(stage_params)`` stages
    (GPipe: all forwards; differentiate for the backward).

    ``stage_fn(params, x) -> y`` applies one stage (same shape in and
    out); ``stage_params[r]`` is rank r's stage.  ``micro``: with
    ``micro_sharded=False``, each rank's replica of the [n_micro, B, ...]
    microbatches; with ``micro_sharded=True``, rank r's contiguous
    [n_micro/pp, B, ...] block, streamed to stage 0 by the conveyor
    (:func:`_loader_step`), so no rank holds every microbatch.  Returns
    each rank's replica of the [n_micro, B, ...] outputs in microbatch
    order.  The drained outputs are collected and stacked (no write into
    an output buffer), so autograd runs through the schedule."""
    pp = len(stage_params)
    n_micro = _n_micro(micro, micro_sharded)
    recv = _first_slots(micro)
    loaders = _first_slots(micro)
    drained = []
    for t in range(n_micro + pp - 1):
        fresh, loaders = _feed(t, micro, loaders, micro_sharded, n_micro)
        ys = [stage_fn(stage_params[r], fresh if r == 0 else recv[r])
              for r in range(pp)]
        if t >= pp - 1:  # the last stage finished microbatch t - (pp-1)
            drained.append(ys[-1])
        recv = _shift(ys)  # activations one stage rightward
    out = tree_map(lambda *a: torch.stack(a), *drained)
    # the outputs live on the last stage; replicate them on every rank
    return _replicate_from([out if r == pp - 1 else tree_map(
        torch.zeros_like, out) for r in range(pp)], pp - 1)


def _stage_vjp(stage_fn: Callable, params: Any, x: torch.Tensor,
               dy: torch.Tensor) -> tuple[Any, torch.Tensor]:
    """The stage recomputed from ``x`` and transposed at ``dy``: (grads
    shaped like ``params``, dx).  ``torch.autograd.grad`` on fresh
    leaves, which costs the host less than ``torch.func.vjp``."""
    leaves, spec = _pytree.tree_flatten(params)
    xs, xspec = _pytree.tree_flatten(x)
    n = len(leaves)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (*leaves, *xs)]
        y = stage_fn(_pytree.tree_unflatten(ins[:n], spec),
                     _pytree.tree_unflatten(ins[n:], xspec))
        grads = torch.autograd.grad(_leaves(y), ins, _leaves(dy))
    return (_pytree.tree_unflatten(grads[:n], spec),
            _pytree.tree_unflatten(grads[n:], xspec))


def pipeline_train_1f1b(stage_fn: Callable, stage_params: Sequence[Any],
                        micro: Sequence[torch.Tensor], out_grad_fn: Callable,
                        micro_sharded: bool = False
                        ) -> tuple[list[torch.Tensor], list[Any]]:
    """One-forward-one-backward pipeline training pass: returns (each
    rank's replica of the loss sum, each rank's grads shaped like its
    stage's params).

    Phase-aligned 1F1B: every cycle each rank runs one forward slot and
    one backward slot (of different microbatches).  The forward of
    microbatch m runs at stage s on cycle m+s, its backward on cycle
    m + 2(pp-1) - s: cotangents enter at the last stage in the cycle its
    forward ends and ripple back one stage a cycle.  Forward inputs live
    in a ring stash of min(2pp-1, n_micro+2(pp-1)) slots indexed by
    cycle; each backward recomputes its stage from the stashed input and
    transposes it (:func:`_stage_vjp`), the FLOPs-for-memory trade of
    full rematerialization.  A backward slot whose microbatch does not
    exist adds nothing to the grads.

    ``out_grad_fn(y) -> (loss, dy)`` is the objective and its cotangent
    for one microbatch's last-stage output; ``micro`` and
    ``micro_sharded`` as in :func:`pipeline_apply`.  Grads are summed
    over microbatches in the params' dtype."""
    pp = len(stage_params)
    n_micro = _n_micro(micro, micro_sharded)
    slots = min(2 * pp - 1, n_micro + 2 * (pp - 1))
    base = _first_slots(micro)
    recv_f, recv_b, loaders = list(base), list(base), list(base)
    stash = [[b] * slots for b in base]
    grads = [tree_map(torch.zeros_like, p) for p in stage_params]
    homes = [_leaves(b)[0].device for b in base]
    loss_acc = torch.zeros((), dtype=torch.float32, device=homes[-1])
    with torch.no_grad():  # the backward slots build their own graphs
        for c in range(n_micro + 2 * (pp - 1)):
            fresh, loaders = _feed(c, micro, loaders, micro_sharded, n_micro)
            ys, dxs = [], []
            for r in range(pp):
                # forward slot: microbatch c - r
                x = fresh if r == 0 else recv_f[r]
                y = stage_fn(stage_params[r], x)
                stash[r][c % slots] = x
                ys.append(y)
                # backward slot: microbatch c - 2(pp-1) + r; the last stage's
                # is this cycle's forward, so the objective's cotangent
                # enters there
                m_b = c - 2 * (pp - 1) + r
                if r == pp - 1:
                    loss_val, dy = out_grad_fn(y)
                    if 0 <= c - r < n_micro:
                        loss_acc = loss_acc + loss_val.float().to(homes[-1])
                else:
                    dy = recv_b[r]
                x_b = stash[r][(c - 2 * (pp - 1) + 2 * r) % slots]
                dparams, dx = _stage_vjp(stage_fn, stage_params[r], x_b, dy)
                if 0 <= m_b < n_micro:
                    grads[r] = tree_map(lambda g, d: g + d, grads[r], dparams)
                dxs.append(dx)
            # hops: activations right, cotangents left
            recv_f, recv_b = _shift(ys), _shift(dxs, -1)
    losses = library_allreduce(
        [loss_acc if r == pp - 1 else torch.zeros((), device=home)
         for r, home in enumerate(homes)])
    return losses, grads


# ---------------------------------------------------------------------------
# Measured pattern: the two schedules side by side, with the costs the
# schedule trade is about (bubble fraction, activation memory) in the
# Record, and gradients held against sequential single-device autograd.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineConfig:
    n_micro: int = 8
    batch: int = 4  # rows a microbatch
    dim: int = 256
    dtype: str = "float32"
    reps: int = 5
    warmup: int = 2
    schedules: tuple = ("gpipe", "1f1b")
    micro_sharded: bool = True  # conveyor feed (no microbatch replication)
    seed: int = 0
    device: str = "cuda"


def _stage_fn(wl: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.tanh(a @ wl[0])


def _out_grad(y: torch.Tensor):
    yf = y.float()
    return (yf ** 2).sum(), (2.0 * yf).to(y.dtype)


def _mesh_note(mesh: RankMesh) -> str | None:
    note = mesh.note("activation and cotangent hops")
    if note is None:
        return None
    return (note + "; ranks sharing a card run one after another, so "
            "step_us is the world's serial time and the bubble is not "
            "idle time on the card")


def run_pipeline(mesh: RankMesh | None = None,
                 cfg: PipelineConfig | None = None,
                 writer: ResultWriter | None = None) -> list[Record]:
    """Time GPipe (autograd backward) and 1F1B (explicit interleaved
    backward) training passes of a matmul-stage pipeline over ``mesh``'s
    ranks (default: one a card of ``cfg.device``).  One Record a
    schedule: min-over-reps step time, analytic bubble fraction, peak
    stashed activation bytes a rank; the verdict gates the gradients
    against sequential single-device autograd."""
    cfg = cfg or PipelineConfig()
    writer = writer or ResultWriter()
    mesh = mesh or default_mesh(0, cfg.device)
    with exact_f32(mesh.on_cuda):
        return _run(mesh, cfg, writer)


def _run(mesh: RankMesh, cfg: PipelineConfig,
         writer: ResultWriter) -> list[Record]:
    pp = mesh.size
    if cfg.n_micro % pp:
        raise ValueError(f"n_micro {cfg.n_micro} not divisible by pp={pp}")
    dev = mesh.devices[0]
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    w = (torch.randn((pp, cfg.dim, cfg.dim), generator=gen, device=dev)
         * 0.5).to(dtype)
    micro = torch.randn((cfg.n_micro, cfg.batch, cfg.dim), generator=gen,
                        device=dev).to(dtype)
    micro_bytes = micro[0].numel() * micro.element_size()
    sw = mesh.scatter(w)
    sm = (mesh.scatter(micro) if cfg.micro_sharded
          else [micro.to(d, copy=True) for d in mesh.devices])

    def gpipe(ws):
        leaves = [p.detach().requires_grad_() for p in ws]
        with torch.enable_grad():
            out = pipeline_apply(_stage_fn, leaves, sm, cfg.micro_sharded)
            loss = (out[0].float() ** 2).sum()
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def one_f_one_b(ws):
        losses, grads = pipeline_train_1f1b(
            _stage_fn, ws, sm, _out_grad, cfg.micro_sharded)
        return losses[0], grads

    writer.progress(
        f"pipeline: pp={pp}, n_micro={cfg.n_micro}, dim={cfg.dim}, "
        f"micro_sharded={cfg.micro_sharded}, dtype={cfg.dtype}")

    # ground truth: sequential single-device autograd (the library-path
    # reference every schedule must reproduce)
    wl = w.detach().requires_grad_()
    with torch.enable_grad():
        x = micro
        for s in range(pp):
            x = _stage_fn(wl[s:s + 1], x)
        baseline = torch.autograd.grad((x.float() ** 2).sum(), wl)[0]
    baseline = baseline.float().cpu()
    scale = max(1.0, float(baseline.abs().max()))

    records = []
    for schedule in cfg.schedules:
        step = {"gpipe": gpipe, "1f1b": one_f_one_b}[schedule]

        def build_chain(k: int, _step=step):
            def run():
                wv = sw
                for _ in range(k):
                    _, grads = _step(wv)
                    # a data dependence, so no step can be skipped
                    wv = [p - 1e-30 * g for p, g in zip(wv, grads)]
                mesh.join()
            return run

        res = timing.measure_chain(build_chain, reps=cfg.reps,
                                   warmup=cfg.warmup, device=dev)
        loss, grads = step(sw)
        got = mesh.gather([g.detach() for g in grads]).float()
        err = float((got - baseline).abs().max())
        agree = err <= 1e-3 * scale
        stash = peak_stash_microbatches(schedule, pp, cfg.n_micro)
        rec = Record(
            pattern="pipeline",
            mode=schedule,
            commands=f"pp{pp} M{cfg.n_micro} B{cfg.batch} D{cfg.dim}"
            + (" sharded" if cfg.micro_sharded else " replicated"),
            metrics={
                "step_us": res.us(),
                "timing_converged": float(res.converged),
                "loss": float(loss),
                "bubble_fraction": bubble_fraction(schedule, pp,
                                                   cfg.n_micro),
                "peak_stash_microbatches": float(stash),
                "peak_stash_bytes": float(stash * micro_bytes),
                "grad_max_err": err,
                "checksum_ok": float(agree),
            },
            verdict=Verdict.SUCCESS if agree else Verdict.FAILURE,
        )
        if not agree:
            rec.notes.append(
                f"gradients diverge from sequential reference: {err:.2e}")
        if note := res.noise_note("step time"):
            rec.notes.append(note)
        if note := _mesh_note(mesh):
            rec.notes.append(note)
        records.append(writer.record(rec))
    return records
