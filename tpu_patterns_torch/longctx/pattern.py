"""Measured long-context pattern: ring vs Ulysses attention, with verdicts.

Counterpart of ``tpu_patterns/longctx/pattern.py`` over a rank mesh
(``comm/mesh.py``).  Each strategy runs over the mesh's ranks with the
suite's metrology (``core/timing.py``: min over reps of amortized
chains) and must match the one-device ground truth elementwise (one
Record a strategy); when several run, an "agreement" Record gates their
pairwise match; an optional throughput floor completes the verdict.

Headline metric: attention TFLOP/s, counting the two block products
(QK^T and PV: 4 L^2 H D flops for full attention, halved for causal).
Ranks that share a card run one after another, so the global rate is
that card's rate; each Record says so in its notes, and the ``--grad``
runner's silicon-rate sanity bound counts distinct cards, never ranks.

Differences from the reference, on purpose: inputs come from a
``torch.Generator`` seeded from ``cfg.seed`` (other values than
``jax.random``'s at one seed); float32 on the card runs with TF32 off,
so the gates' rounding unit is the io dtype's eps (the reference raises
it to bfloat16's only on a TPU, whose matrix unit rounds f32 products);
the ground truths run on the caller's device (rank 0's).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import warnings

import numpy as np
import torch

from tpu_patterns_torch.comm.mesh import RankMesh, default_mesh
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.longctx import attention as att
from tpu_patterns_torch.longctx.ring_attention import ring_attention
from tpu_patterns_torch.longctx.ulysses import ulysses_attention
from tpu_patterns_torch.runtime import exact_f32, torch_dtype


def flash_local(qs, ks, vs, causal=False, scale=None, block_q=1024,
                block_k=1024, grid_mode="dense"):
    """The fused kernels as a one-rank strategy (no communication):
    ``flash_attention_diff``, K2 forward, or K3 and K4 under autograd.
    ``block_q``/``block_k`` are the requested tile (clamped by
    ``tuning._auto_block``)."""
    from tpu_patterns_torch.longctx.flash import flash_attention_diff

    if len(qs) != 1:
        raise ValueError("flash strategy is single-device (sp must be 1)")
    scale = float(scale) if scale is not None else None
    return [flash_attention_diff(qs[0], ks[0], vs[0], causal, scale,
                                 block_q, block_k, grid_mode)]


def ring_pallas(qs, ks, vs, causal=False, scale=None):
    """Ring attention with K3 a step (and K4's second ring backward)."""
    return ring_attention(qs, ks, vs, causal=causal, scale=scale,
                          block_impl="pallas")


def ring_striped(qs, ks, vs, causal=False, scale=None):
    """Ring attention over the striped (load-balanced causal) layout;
    shards must hold tokens r::sp (the runners stripe and unstripe)."""
    return ring_attention(qs, ks, vs, causal=causal, scale=scale,
                          layout="striped")


def ulysses_pallas(qs, ks, vs, causal=False, scale=None, block_q=1024,
                   block_k=1024, grid_mode="dense"):
    """Ulysses with the fused kernels as each rank's full-sequence
    attention."""
    return ulysses_attention(qs, ks, vs, causal=causal, scale=scale,
                             block_impl="pallas", block_q=block_q,
                             block_k=block_k, grid_mode=grid_mode)


STRATEGIES = {
    "ring": ring_attention,
    "ring_pallas": ring_pallas,
    "ring_striped": ring_striped,
    "ulysses": ulysses_attention,
    "ulysses_pallas": ulysses_pallas,
    "flash": flash_local,
}
# these expect shards in the striped token layout (r::sp)
STRIPED = {"ring_striped"}


@dataclasses.dataclass
class LongCtxConfig:
    seq: int = 4096  # global sequence length
    heads: int = 8
    head_dim: int = 128
    dtype: str = "float32"
    causal: bool = True
    reps: int = 10
    warmup: int = 2
    min_tflops: float = -1.0  # verdict floor; <0 disables
    tol: float = 1e-4  # elementwise |err| gate vs f32 reference (dtype-scaled)
    strategies: tuple = ("ring", "ulysses")
    seed: int = 0
    # measure the backward too: each rep runs fwd+bwd of a
    # fixed-cotangent objective, validated against the reference's
    # gradients; TFLOP/s counts the standard fwd 2 + bwd 5 product model
    grad: bool = False
    # the fused strategies' requested tile (clamped by _auto_block)
    block_q: int = 1024
    block_k: int = 1024
    # flash causal grid: "dense" or "compact" (the reference's live-tile
    # table; here both launch the same work, see flash.py)
    causal_grid: str = "dense"
    device: str = "cuda"


def _resolve_strategy(name: str, cfg: LongCtxConfig, grad: bool = False):
    """Strategy callable with cfg's kernel knobs applied, in one place
    for both runners.  ``grid_mode`` reaches ``flash`` and
    ``ulysses_pallas`` only: ring shards have offsets, which the compact
    grid refuses."""
    strat = STRATEGIES[name]
    if name in ("flash", "ulysses_pallas"):
        if cfg.causal_grid != "dense" and not cfg.causal:
            # a Record labeled compact must never time the dense grid
            raise ValueError(
                "causal_grid='compact' requires --causal true: the "
                "non-causal grid has no masked tiles to skip, and the "
                "record would be labeled compact while timing the "
                "dense grid"
            )
        strat = functools.partial(strat, block_q=cfg.block_q,
                                  block_k=cfg.block_k,
                                  grid_mode=cfg.causal_grid)
    return strat


def attention_flops(seq: int, heads: int, head_dim: int,
                    causal: bool) -> float:
    """QK^T + PV product flops for one full-sequence attention."""
    full = 4.0 * seq * seq * heads * head_dim
    return full / 2 if causal else full


REF_CHUNK = 2048


def reference_blockwise(q, k, v, causal: bool) -> np.ndarray:
    """float32 ground truth computed chunk by chunk with the
    online-softmax monoid, so validation never holds the [H, L, L]
    score tensor.  It runs in torch on the inputs' device (on the card
    with TF32 off, under ``runtime.exact_f32``): numpy at L = 4096 would
    take longer than the runs it checks."""
    lq, lk = q.shape[0], k.shape[0]
    cq, ck = min(REF_CHUNK, lq), min(REF_CHUNK, lk)
    dev = q.device
    outs = []
    with torch.no_grad():
        for q0 in range(0, lq, cq):
            qc = q[q0:q0 + cq].float()
            state = att.empty_state(qc)
            for k0 in range(0, lk, ck):
                kc, vc = k[k0:k0 + ck].float(), v[k0:k0 + ck].float()
                mask = None
                if causal:
                    mask = att.causal_mask(
                        q0 + torch.arange(qc.shape[0], device=dev),
                        k0 + torch.arange(kc.shape[0], device=dev))
                state = att.combine_blocks(
                    state, att.block_attention(qc, kc, vc, mask=mask))
            outs.append(att.finalize(state).cpu().numpy())
    return np.concatenate(outs, axis=0)


def _unstripe(a: np.ndarray, sp: int) -> np.ndarray:
    out = np.empty_like(a)
    lq = a.shape[0] // sp
    for r in range(sp):
        out[r::sp] = a[r * lq:(r + 1) * lq]
    return out


def _eps_effective(cfg: LongCtxConfig) -> float:
    """Rounding unit of the strategies' products: the io dtype's eps.
    float32 runs with TF32 off (``runtime.exact_f32``), so no product
    rounds coarser than its inputs; the reference's TPU clause (bf16
    passes under f32 products on the matrix unit) has no counterpart
    here."""
    return float(torch.finfo(torch_dtype(cfg.dtype)).eps)


def _rms(a: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))


@dataclasses.dataclass(frozen=True)
class _Gates:
    """Validation gates vs the f32 reference, scaled to its magnitude.

    Elementwise: ``|out - ref| <= atol + rtol * |ref|``; ``rtol`` is 8
    eps_eff, ``atol`` floors at 4 eps_eff of rms(ref) (error leaked
    across elements by shared softmax denominators).  RMS:
    ``rms(out - ref) <= 4 eps_eff * rms(ref)`` bounds the bulk.  An
    all-zeros output fails both; one element corrupted by more than
    ~atol + 8 eps_eff of its magnitude fails the elementwise gate."""

    rtol: float
    atol: float
    rms: float
    # one width-unit of the grad gate's atol (eps4 * max|ref|), set by
    # _grad_gates only: lets width_needed express the residue in eps
    # units whatever cfg.tol floors or the width live at run time
    unit_atol: float | None = None

    def check_elem(self, diff: np.ndarray, ref: np.ndarray) -> float:
        """Max violation ratio: <=1 passes (1 == exactly at the gate)."""
        allow = self.atol + self.rtol * np.abs(np.asarray(ref, np.float64))
        return float(np.max(np.abs(np.asarray(diff, np.float64)) / allow))

    def width_needed(self, diff: np.ndarray,
                     ref: np.ndarray) -> float | None:
        """Smallest gate width (in eps units) whose atol term would have
        admitted this residue: width-independent, so a refit on it is
        idempotent."""
        if self.unit_atol is None:
            return None  # not a grad gate: the quantity is not claimed
        if self.unit_atol == 0:
            # identically-zero reference: only the cfg.tol floor gates
            return 0.0
        slack = np.abs(np.asarray(diff, np.float64)) - self.rtol * np.abs(
            np.asarray(ref, np.float64))
        return float(max(0.0, float(np.max(slack)) / self.unit_atol))

    def describe(self) -> str:
        return (f"atol {self.atol:.2e} + rtol {self.rtol:.2e}*|ref|, "
                f"rms gate {self.rms:.2e}")


def _gates(cfg: LongCtxConfig, ref: np.ndarray, depth: int = 1) -> _Gates:
    """``depth`` scales the allowances for deeper compute chains (the
    backward chains two more product stages than the forward)."""
    eps = _eps_effective(cfg) * depth
    ref_rms = _rms(ref)
    return _Gates(
        rtol=min(8 * eps, 0.25),
        atol=max(cfg.tol, min(4 * eps, 0.125) * ref_rms),
        rms=max(cfg.tol, min(4 * eps, 0.125) * ref_rms),
    )


# MODEL accounting (the number other flash implementations report): fwd
# = 2 products (QK^T, PV); bwd = 5 (score recompute, dV, dP, dS->dQ,
# dS->dK) -> 7 product-equivalents per fwd+bwd, 3.5x the forward's 2.
GRAD_FLOP_MULT = 3.5
# HARDWARE accounting: what the card executes, per strategy.  The fused
# backward K4 is two kernels that EACH recompute the score tile and dP
# (longctx/csrc/flash_attention_bwd.cu, its header: per visible (query,
# key) pair the dq kernel runs 3 products of 2 D flops, S, dP and dQ,
# the dk/dv kernel 4, S, dP, dV and dK) -> fwd 2 + bwd 7 = 9, 4.5x: the
# reference's split, held by both float32 and bfloat16 instances.  It
# covers "flash", "ulysses_pallas" and "ring_pallas" (K4 a ring step).
# The autograd strategies keep the probabilities as residuals instead
# of recomputing -> bwd 4 (dV, dP, dQ, dK) = 3.0x.  Records carry both
# rates: `tflops` (model flops) and `tflops_hw` (the card's, which must
# never exceed its peak).
GRAD_HW_FLOP_MULT = {"flash": 4.5, "ring_pallas": 4.5,
                     "ulysses_pallas": 4.5}
GRAD_HW_FLOP_MULT_DEFAULT = 3.0


# A refit grad-gate width (``recommended_width_eps``) may be committed
# beside this module; absent, the provisional 8-eps width stands.
# TPU_PATTERNS_GATES_FIT overrides the path (=/dev/null disables it).
# Read per call.
GATES_FIT_PATH = os.path.join(os.path.dirname(__file__), "gates_fit.json")


def _gate_width_eps() -> float:
    path = os.environ.get("TPU_PATTERNS_GATES_FIT", GATES_FIT_PATH)

    def _warn_fallback(e: Exception) -> float:
        # a present but unreadable fit must not silently loosen the gate
        warnings.warn(
            f"gates fit at {path} unreadable ({type(e).__name__}: {e}); "
            "falling back to the provisional 8-eps width",
            stacklevel=3,
        )
        return 8.0

    try:
        with open(path) as f:
            text = f.read()
    except FileNotFoundError:
        return 8.0  # no fit promoted yet
    except OSError as e:  # present but unreadable
        return _warn_fallback(e)
    if not text.strip():
        return 8.0  # the =/dev/null disable reads as empty
    try:
        return float(json.loads(text)["recommended_width_eps"])
    except (ValueError, KeyError, TypeError) as e:
        return _warn_fallback(e)


def _grad_gates(cfg: LongCtxConfig, ref: np.ndarray,
                width: float | None = None) -> _Gates:
    """The forward gates at depth 4, with the atol term rescaled to
    max|ref| rather than rms(ref): rows the reference zeroes
    analytically (causal dq[0]) come out of the kernels as rounding
    residues of dS = P * (dP - delta), whose size tracks the tensor's
    extremes.  ``width`` (eps units, default :func:`_gate_width_eps`) is
    read once by callers that record it."""
    base = _gates(cfg, ref, depth=4)
    eps = _eps_effective(cfg) * 4
    ref_scale = float(np.max(np.abs(ref)))
    if width is None:
        width = _gate_width_eps()
    return dataclasses.replace(
        base,
        atol=max(cfg.tol, min(width * eps, 0.25) * ref_scale),
        unit_atol=eps * ref_scale,
    )


def _inputs(cfg: LongCtxConfig, n: int) -> list[torch.Tensor]:
    """``n`` global [seq, heads, head_dim] normals from the seeded
    generator, on the CPU: q, k, v in the run's dtype, then (for the
    grad runner) the float32 cotangent."""
    gen = torch.Generator().manual_seed(cfg.seed)
    shape = (cfg.seq, cfg.heads, cfg.head_dim)
    out = [torch.randn(shape, generator=gen) for _ in range(n)]
    dtype = torch_dtype(cfg.dtype)
    return [t.to(dtype) for t in out[:3]] + out[3:]


def _layout(mesh: RankMesh, name: str, arrays):
    """Each global array scattered over the ranks, striped first for the
    striped strategies; and whether it was."""
    striped = name in STRIPED and mesh.size > 1
    return ([mesh.scatter(att.stripe(a, mesh.size) if striped else a)
             for a in arrays], striped)


def _global(mesh: RankMesh, shards, striped: bool) -> np.ndarray:
    out = mesh.gather([s.detach() for s in shards]).float().numpy()
    return _unstripe(out, mesh.size) if striped else out


def _mesh_note(mesh: RankMesh) -> str | None:
    note = mesh.note("ring shifts and all-to-alls")
    if note is None:
        return None
    return (note + "; ranks sharing a card run one after another, so the "
            "global TFLOP/s is that card's rate")


def run_longctx_grad(mesh: RankMesh, cfg: LongCtxConfig,
                     writer: ResultWriter) -> list[Record]:
    """Measured fwd+bwd: per strategy, time the gradients of a fixed
    cotangent objective and gate (dq, dk, dv) against autograd of the
    float32 reference attention."""
    from tpu_patterns_torch.runtime import chip_peak_tflops

    dev = mesh.devices[0]
    peak = chip_peak_tflops(cfg.dtype, dev)
    sp = mesh.size
    n_cards = len(mesh.cards())
    q, k, v, ct = _inputs(cfg, 4)
    fwd_flops = attention_flops(cfg.seq, cfg.heads, cfg.head_dim, cfg.causal)
    flops = fwd_flops * GRAD_FLOP_MULT
    writer.progress(
        f"longctx grad: sp={sp}, seq={cfg.seq}, heads={cfg.heads}, "
        f"head_dim={cfg.head_dim}, causal={cfg.causal}, dtype={cfg.dtype}"
    )

    # Reference gradients: autograd of the materializing reference in
    # float32 on rank 0's device (O(L^2) scores: validation only)
    leaves = [a.to(dev).float().requires_grad_() for a in (q, k, v)]
    ref_out = att.attention_reference(*leaves, causal=cfg.causal)
    ref_np = tuple(g.cpu().numpy() for g in torch.autograd.grad(
        ref_out, leaves, grad_outputs=ct.to(dev)))
    del leaves, ref_out
    # the width is read once and threads into every gate and record
    width_used = _gate_width_eps()
    gates = tuple(_grad_gates(cfg, g, width=width_used) for g in ref_np)

    records = []
    for name in cfg.strategies:
        strat = functools.partial(_resolve_strategy(name, cfg, grad=True),
                                  causal=cfg.causal)
        (qs, ks, vs, cts), striped = _layout(mesh, name, (q, k, v, ct))

        def grads(a, b, c, _f=strat, _ct=cts):
            ins = [t.detach().requires_grad_() for t in (*a, *b, *c)]
            outs = _f(ins[:sp], ins[sp:2 * sp], ins[2 * sp:])
            got = torch.autograd.grad(
                outs, ins, grad_outputs=[g.to(o.dtype)
                                         for g, o in zip(_ct, outs)])
            return got[:sp], got[sp:2 * sp], got[2 * sp:]

        # Chain on dq + dk + dv (one [L, H, D] shape): each op is one
        # full fwd+bwd whose three gradients all feed the next
        def step(x, _g=grads, _k=ks, _v=vs):
            dq, dk, dv = _g(x, _k, _v)
            return [a + b + c for a, b, c in zip(dq, dk, dv)]

        def build_chain(ki: int, _s=step, _q=qs):
            def run():
                timing.unrolled_chain(_s, _q, ki)
                mesh.join()
            return run

        res = timing.measure_chain(build_chain, reps=cfg.reps,
                                   warmup=cfg.warmup, device=dev,
                                   ops_per_iter=timing.CHAIN_UNROLL)
        tflops = flops / res.per_op_ns / 1e3
        hw_mult = GRAD_HW_FLOP_MULT.get(name, GRAD_HW_FLOP_MULT_DEFAULT)
        tflops_hw = fwd_flops * hw_mult / res.per_op_ns / 1e3
        got_np = [_global(mesh, g, striped) for g in grads(qs, ks, vs)]
        violation = max(gt.check_elem(g - r, r)
                        for gt, g, r in zip(gates, got_np, ref_np))
        width_needed = max(gt.width_needed(g - r, r)
                           for gt, g, r in zip(gates, got_np, ref_np))
        # each of dq/dk/dv against its own gate
        rms_ratio = max(_rms(g - r) / gt.rms
                        for gt, g, r in zip(gates, got_np, ref_np))
        err_rms = max(_rms(g - r) for g, r in zip(got_np, ref_np))
        data_ok = violation <= 1.0 and rms_ratio <= 1.0
        perf_ok = cfg.min_tflops < 0 or tflops >= cfg.min_tflops
        # A silicon rate above the cards' peak cannot be a measurement.
        # tflops_hw is a global rate; the ranks share n_cards cards, so
        # the bound is n_cards x one card's peak, never sp x
        sane = peak is None or tflops_hw <= peak * n_cards
        writer.metric(f"{name} attention grad", tflops, "TFLOP/s (model)")
        writer.metric(f"{name} attention grad hw", tflops_hw,
                      "TFLOP/s (silicon)")
        rec = Record(
            pattern="longctx",
            mode=f"{name}_grad",
            commands=f"sp{sp} L{cfg.seq} H{cfg.heads} D{cfg.head_dim} grad"
            + (" causal" if cfg.causal else ""),
            # dtype travels with the record so profilecheck's crosscheck
            # reads the right peak; device so it reads none off the card
            config={"dtype": cfg.dtype, "device": dev.type},
            metrics={
                "tflops": tflops,
                "tflops_hw": tflops_hw,
                "hw_flop_mult": hw_mult,
                "min_time_us": res.us(),
                "flops": flops,
                "gate_violation": violation,
                "gate_width_eps": width_used,
                "gate_width_needed_eps": width_needed,
                "rms_err": err_rms,
                "checksum_ok": float(data_ok),
                "timing_converged": float(res.converged),
            },
            verdict=Verdict.SUCCESS if (data_ok and perf_ok and sane)
            else Verdict.FAILURE,
        )
        if note := res.noise_note("TFLOP/s"):
            rec.notes.append(note)
        if note := _mesh_note(mesh):
            rec.notes.append(note)
        if not data_ok:
            rec.notes.append(
                f"grad elem violation {violation:.2f}x / rms {err_rms:.2e}")
        if not perf_ok:
            rec.notes.append(
                f"{tflops:.3f} TFLOP/s below floor {cfg.min_tflops}")
        if not sane:
            rec.notes.append(
                f"hardware rate {tflops_hw:.1f} TFLOP/s exceeds "
                f"{n_cards}-card peak {peak * n_cards:.1f} — accounting "
                "or timing bug")
        records.append(writer.record(rec))
    return records


def run_longctx(mesh: RankMesh | None = None,
                cfg: LongCtxConfig | None = None,
                writer: ResultWriter | None = None) -> list[Record]:
    """Run each strategy over ``mesh`` (default: one rank a card of
    ``cfg.device``); one Record a strategy, TFLOP/s metric."""
    cfg = cfg or LongCtxConfig()
    writer = writer or ResultWriter()
    mesh = mesh or default_mesh(0, cfg.device)
    if mesh.devices[0].type != torch.device(cfg.device).type:
        raise ValueError(f"mesh on {mesh.devices[0].type}, config on "
                         f"{cfg.device}")
    sp = mesh.size
    if cfg.seq % sp != 0:
        raise ValueError(f"seq {cfg.seq} not divisible by sp={sp}")
    if cfg.heads % sp != 0 and any(
            s.startswith("ulysses") for s in cfg.strategies):
        raise ValueError(
            f"heads {cfg.heads} not divisible by sp={sp} (ulysses)")
    if "flash" in cfg.strategies and sp != 1:
        raise ValueError("flash strategy is single-device (needs sp=1)")
    with exact_f32(mesh.on_cuda):
        if cfg.grad:
            return run_longctx_grad(mesh, cfg, writer)
        with torch.no_grad():
            return _run_forward(mesh, cfg, writer)


def _run_forward(mesh: RankMesh, cfg: LongCtxConfig,
                 writer: ResultWriter) -> list[Record]:
    dev = mesh.devices[0]
    sp = mesh.size
    q, k, v = _inputs(cfg, 3)
    flops = attention_flops(cfg.seq, cfg.heads, cfg.head_dim, cfg.causal)
    writer.progress(
        f"longctx: sp={sp}, seq={cfg.seq}, heads={cfg.heads}, "
        f"head_dim={cfg.head_dim}, causal={cfg.causal}, dtype={cfg.dtype}"
    )
    # ground truth on one device, blockwise f32 (no [H, L, L] tensor)
    ref_np = reference_blockwise(q.to(dev), k.to(dev), v.to(dev), cfg.causal)
    gates = _gates(cfg, ref_np)

    records = []
    outputs: dict[str, np.ndarray] = {}
    for name in cfg.strategies:
        body = functools.partial(_resolve_strategy(name, cfg),
                                 causal=cfg.causal)
        (qs, ks, vs), striped = _layout(mesh, name, (q, k, v))

        # Amortized chain: the output fed back as q (shapes match), a
        # data dependence no run can skip
        def build_chain(ki: int, _b=body, _q=qs, _k=ks, _v=vs):
            def run():
                timing.unrolled_chain(lambda a: _b(a, _k, _v), _q, ki)
                mesh.join()
            return run

        res = timing.measure_chain(build_chain, reps=cfg.reps,
                                   warmup=cfg.warmup, device=dev,
                                   ops_per_iter=timing.CHAIN_UNROLL)
        tflops = flops / res.per_op_ns / 1e3  # FLOP/ns == GFLOP/s
        out = _global(mesh, body(qs, ks, vs), striped)
        outputs[name] = out
        diff = out - ref_np
        err = float(np.max(np.abs(diff)))
        err_rms = _rms(diff)
        violation = gates.check_elem(diff, ref_np)
        data_ok = violation <= 1.0 and err_rms <= gates.rms
        perf_ok = cfg.min_tflops < 0 or tflops >= cfg.min_tflops
        writer.metric(f"{name} attention", tflops, "TFLOP/s")
        rec = Record(
            pattern="longctx",
            mode=name,
            commands=f"sp{sp} L{cfg.seq} H{cfg.heads} D{cfg.head_dim}"
            + (" causal" if cfg.causal else ""),
            metrics={
                "tflops": tflops,
                "min_time_us": res.us(),
                "flops": flops,
                "max_abs_err": err,
                "rms_err": err_rms,
                "gate_violation": violation,
                "checksum_ok": float(data_ok),
                "timing_converged": float(res.converged),
            },
            verdict=Verdict.SUCCESS if (data_ok and perf_ok)
            else Verdict.FAILURE,
        )
        if note := res.noise_note("TFLOP/s"):
            rec.notes.append(note)
        if note := _mesh_note(mesh):
            rec.notes.append(note)
        if not data_ok:
            rec.notes.append(
                f"elem violation {violation:.2f}x / rms {err_rms:.2e} "
                f"({gates.describe()})")
        if not perf_ok:
            rec.notes.append(
                f"{tflops:.3f} TFLOP/s below floor {cfg.min_tflops}")
        records.append(writer.record(rec))

    if len(outputs) >= 2:
        # pairwise agreement gate (the two lineages' check, as the
        # allreduce miniapp's ring-vs-library check)
        names = sorted(outputs)
        cross = cross_rms = cross_violation = 0.0
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                d = outputs[a] - outputs[b]
                cross = max(cross, float(np.max(np.abs(d))))
                cross_rms = max(cross_rms, _rms(d))
                cross_violation = max(cross_violation,
                                      gates.check_elem(d, ref_np))
        agree = cross_violation <= 1.0 and cross_rms <= gates.rms
        rec = Record(
            pattern="longctx",
            mode="agreement",
            commands=" vs ".join(names),
            metrics={
                "cross_max_err": cross,
                "cross_rms_err": cross_rms,
                "gate_violation": cross_violation,
            },
            verdict=Verdict.SUCCESS if agree else Verdict.FAILURE,
        )
        if not agree:
            rec.notes.append(
                f"strategies diverge: elem violation "
                f"{cross_violation:.2f}x / rms {cross_rms:.2e} "
                f"({gates.describe()})")
        records.append(writer.record(rec))
    return records
