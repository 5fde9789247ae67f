"""Expert parallelism: top-1 MoE dispatch over expert ranks.

Counterpart of ``tpu_patterns/parallel/moe.py``.  Expert dispatch and
return are the two tiled all-to-alls (``comm/ring.py::all_to_all``, the
collective Ulysses uses, re-purposed from heads to experts).  One expert
a rank; tokens are routed top-1 by a one-hot einsum dispatch (dense and
of static shape, no gather or scatter), with a per-expert capacity.

Flow a rank ([T, E] tokens):
  1. gate: softmax(x @ wg) -> top-1 expert and weight a token;
  2. dispatch one-hot [T, n_exp, C] -> expert inputs [n_exp, C, E];
  3. all-to-all: each rank receives its expert's slots from every rank
     -> [ep*C, E];
  4. apply the local expert;
  5. the reverse all-to-all; combine back to [T, E] weighted by the gate.

Capacity: C = ceil(capacity_factor * T / n_exp), or C = T when the
factor is <= 0 (every token fits even if all route to one expert).
Under a binding factor, overflow tokens are dropped in arrival order:
their dispatch row is all zeros, so their output is exactly zero and
the caller's residual carries them.

There each function runs inside ``shard_map``.  Here :func:`moe_apply`
takes and returns per-rank lists (``comm/mesh.py``); the routing helpers
work on one rank's tensors.  Slots are counted in an integer dtype,
never the token dtype, and the slot one-hot is built by comparison with
``arange(C)``, which gives the all-zero row for an overflow slot that
``jax.nn.one_hot`` gives for an out-of-range index.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Sequence

import numpy as np
import torch

from tpu_patterns_torch.comm.mesh import RankMesh, default_mesh
from tpu_patterns_torch.comm.ring import all_to_all
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.runtime import exact_f32, torch_dtype


def top1_route(x: torch.Tensor, wg: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate scores -> (one-hot dispatch [T, n_exp] int32, gate weight
    [T]).  Counting in the token dtype would corrupt slot indices once a
    per-expert count passes the mantissa range (256 for bf16)."""
    gates = torch.softmax(x @ wg, dim=-1)  # [T, n_exp]
    idx = torch.argmax(gates, dim=-1)
    onehot = (idx[:, None] == torch.arange(wg.shape[-1], device=x.device)
              ).to(torch.int32)
    weight = gates.gather(-1, idx[:, None])[:, 0]
    return onehot, weight


def capacity(t: int, n_exp: int, capacity_factor: float = 0.0) -> int:
    """Per-expert slot count C.  ``capacity_factor <= 0`` means exact
    routing (C = T); otherwise C = ceil(cf * T / n_exp), clamped to
    [1, T]: tokens whose expert is already full are dropped."""
    if capacity_factor <= 0:
        return t
    return min(t, max(1, math.ceil(capacity_factor * t / n_exp)))


def _slot_indices(onehot: torch.Tensor) -> torch.Tensor:
    """[T] arrival rank of each token within its chosen expert."""
    pos = torch.cumsum(onehot, dim=0) - onehot  # [T, n_exp]
    return (pos * onehot).sum(-1)


def dispatch_stats(onehot: torch.Tensor, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_dropped, per_expert_kept [n_exp]) under capacity ``cap``: the
    overflow accounting of the capacity-factor trade."""
    kept = (_slot_indices(onehot) < cap).to(onehot.dtype)
    n_dropped = onehot.shape[0] - kept.sum()
    per_expert = (onehot * kept[:, None]).sum(0)
    return n_dropped, per_expert


def _slot_onehot(onehot: torch.Tensor, cap: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """[T, C]: 1 at each token's slot, an all-zero row past ``cap``."""
    slots = torch.arange(cap, device=onehot.device)
    return (_slot_indices(onehot)[:, None] == slots).to(dtype)


def build_dispatch(onehot: torch.Tensor, cap: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """[T, n_exp] routing one-hot -> [T, n_exp, C] dispatch tensor:
    ``dispatch[t, e, c] = 1`` iff token t is slot c of expert e.  Tokens
    with slot >= cap get an all-zero row: dropped."""
    slot = _slot_onehot(onehot, cap, dtype)
    return onehot.to(dtype)[:, :, None] * slot[:, None, :]


def build_dispatch_column(onehot: torch.Tensor, expert: int, cap: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """[T, C] dispatch column for one expert: what a rank that owns a
    single expert needs, without the full [T, n_exp, C] tensor."""
    slot = _slot_onehot(onehot, cap, dtype)
    return onehot[:, expert].to(dtype)[:, None] * slot


def moe_apply(expert_fn: Callable, expert_params: Sequence,
              wg: torch.Tensor | Sequence[torch.Tensor],
              x: Sequence[torch.Tensor],
              capacity_factor: float = 0.0) -> list[torch.Tensor]:
    """Top-1 mixture over ``len(x)`` experts, one a rank.

    ``expert_fn(params, x) -> y`` (same shape); ``expert_params[r]``:
    rank r's expert; ``wg``: the [E, n_exp] gate, one tensor (each rank
    reads it on its own device) or each rank's replica; ``x[r]``: rank
    r's [T, E] tokens.  ``capacity_factor`` caps slots at
    C = ceil(cf*T/ep) (<= 0: exact, C = T); overflow tokens are dropped,
    their output zero.  Returns each rank's [T, E]."""
    ep = len(x)
    t, e = x[0].shape
    cap = capacity(t, ep, capacity_factor)
    gates = ([wg] * ep) if isinstance(wg, torch.Tensor) else list(wg)
    if gates[0].shape[-1] != ep:
        raise ValueError(
            f"gate has {gates[0].shape[-1]} experts but the ep axis has "
            f"{ep} ranks (one expert per mesh position)")
    routes, expert_in = [], []
    for xr, g in zip(x, gates):
        onehot, weight = top1_route(xr, g.to(xr.device))
        dispatch = build_dispatch(onehot, cap, xr.dtype)
        routes.append((dispatch, weight))
        expert_in.append(torch.einsum("tec,td->ecd", dispatch, xr))
    # each rank collects its expert's slots from every rank:
    # [ep, C, E] -> [1, ep*C, E] -> [ep*C, E]
    mine = all_to_all(expert_in, split=0, concat=1)
    ys = [expert_fn(p, m.reshape(ep * cap, e))
          for p, m in zip(expert_params, mine)]
    # results back to the owning ranks: the same all-to-all on the
    # [ep, C, E] view returns each source rank its tokens' results
    back = all_to_all([y.reshape(ep, cap, e) for y in ys], split=0,
                      concat=1)
    return [torch.einsum("tec,ecd->td", dispatch, b.reshape(ep, cap, e))
            * weight[:, None]
            for (dispatch, weight), b in zip(routes, back)]


def all_to_all_bytes(ep: int, cap: int, e: int, itemsize: int) -> int:
    """Bytes a rank sends a ``moe_apply``: two tiled all-to-alls
    (dispatch and return), each the [ep, C, E] buffer less the local
    shard, 2 * (ep-1)/ep * ep*C*E * itemsize."""
    return 2 * (ep - 1) * cap * e * itemsize


# ---------------------------------------------------------------------------
# Measured pattern: expert-parallel dispatch across capacity regimes, with
# the all-to-all traffic and the overflow-drop accounting in the Record.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MoEConfig:
    tokens: int = 512  # tokens a rank
    dim: int = 128
    dtype: str = "float32"
    reps: int = 5
    warmup: int = 2
    capacity_factors: tuple = (0.0, 2.0, 1.0)  # 0 = exact (C = T)
    seed: int = 0
    device: str = "cuda"


def host_reference(we: torch.Tensor, wg: torch.Tensor, xs: torch.Tensor,
                   ep: int, cap: int) -> tuple[np.ndarray, int]:
    """Reference (want [T_total, E] float32, n_dropped) for the
    tanh-matmul expert of the pattern and the tests.  Routing comes from
    the same :func:`top1_route` on the data's own dtype and device (a
    float32 numpy replay would argmax near-tied bf16 gate logits
    differently and report spurious mismatches); slot counting and the
    expert math are replayed in numpy float32."""
    t_total, dim = xs.shape
    tokens = t_total // ep
    want = np.zeros((t_total, dim), np.float32)
    dropped = 0
    we32 = we.float().cpu().numpy()
    for rank in range(ep):
        xb = xs[rank * tokens:(rank + 1) * tokens]
        onehot, weight = top1_route(xb, wg)
        idx = onehot.argmax(-1).cpu().numpy()
        gw = weight.float().cpu().numpy()
        xb32 = xb.float().cpu().numpy()
        counts: dict[int, int] = {}
        for i, e in enumerate(idx):
            slot = counts.get(int(e), 0)
            counts[int(e)] = slot + 1
            if slot >= cap:
                dropped += 1
                continue
            want[rank * tokens + i] = gw[i] * np.tanh(xb32[i] @ we32[e])
    return want, dropped


def _expert_fn(w: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.tanh(a @ w[0])


def run_moe(mesh: RankMesh | None = None, cfg: MoEConfig | None = None,
            writer: ResultWriter | None = None) -> list[Record]:
    """Time top-1 expert-parallel dispatch over ``mesh``'s ranks
    (default: one a card of ``cfg.device``) at each capacity factor.  One
    Record a factor: min-over-reps time, capacity, dropped tokens (the
    host replay of the slot arithmetic) and all-to-all bytes; the
    verdict gates the token-exact invariant: kept tokens equal
    gate_weight * expert(x), dropped tokens are exactly zero."""
    cfg = cfg or MoEConfig()
    writer = writer or ResultWriter()
    mesh = mesh or default_mesh(0, cfg.device)
    with exact_f32(mesh.on_cuda), torch.no_grad():
        return _run(mesh, cfg, writer)


def _run(mesh: RankMesh, cfg: MoEConfig,
         writer: ResultWriter) -> list[Record]:
    ep = mesh.size
    dev = mesh.devices[0]
    dtype = torch_dtype(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    we = normal(ep, cfg.dim, cfg.dim, scale=0.3)
    wg = normal(cfg.dim, ep)
    xs = normal(cfg.tokens * ep, cfg.dim)
    swe, sxs = mesh.scatter(we), mesh.scatter(xs)
    wgs = [wg.to(d, copy=True) for d in mesh.devices]

    writer.progress(
        f"moe: ep={ep}, tokens/rank={cfg.tokens}, dim={cfg.dim}, "
        f"dtype={cfg.dtype}")
    records = []
    for cf in cfg.capacity_factors:
        cap = capacity(cfg.tokens, ep, cf)
        fn = functools.partial(moe_apply, _expert_fn, capacity_factor=cf)

        def build_chain(k: int, _f=fn):
            # each output feeds the next dispatch (same [T, E] shape), a
            # data dependence no run can skip
            def run():
                cur = sxs
                for _ in range(k):
                    cur = _f(swe, wgs, cur)
                mesh.join()
            return run

        res = timing.measure_chain(build_chain, reps=cfg.reps,
                                   warmup=cfg.warmup, device=dev)
        out = mesh.gather(fn(swe, wgs, sxs)).float().numpy()
        want, dropped = host_reference(we, wg, xs, ep, cap)
        err = float(np.max(np.abs(out - want)))
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        ok = err <= tol
        writer.metric(f"moe cf={cf} dispatch", res.us(), "us")
        rec = Record(
            pattern="moe",
            mode=f"cf{cf}" if cf > 0 else "exact",
            commands=f"ep{ep} T{cfg.tokens} D{cfg.dim} C{cap}",
            metrics={
                "time_us": res.us(),
                "timing_converged": float(res.converged),
                "capacity": float(cap),
                "capacity_factor": float(cf),
                "dropped_tokens": float(dropped),
                "total_tokens": float(cfg.tokens * ep),
                "a2a_bytes": float(all_to_all_bytes(
                    ep, cap, cfg.dim, we.element_size())),
                "max_abs_err": err,
                "checksum_ok": float(ok),
            },
            verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
        )
        if not ok:
            rec.notes.append(
                f"token-exact invariant broken: {err:.2e} > {tol:.0e}")
        if note := res.noise_note("time"):
            rec.notes.append(note)
        if note := mesh.note("all-to-alls"):
            rec.notes.append(
                note + "; ranks sharing a card run one after another, so "
                "time_us is the world's serial time")
        records.append(writer.record(rec))
    return records
