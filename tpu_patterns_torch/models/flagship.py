"""The flagship workload: the PatternFormer train step over a rank mesh.

Counterpart of ``tpu_patterns/models/transformer.py``'s
``FlagshipConfig``, ``flagship_flops`` and ``run_flagship``: forward,
mean-square loss, backward and the update of ``depth`` transformer
blocks over a dp x sp x tp mesh (``comm/mesh.py::model_mesh``; one rank
by default), timed as a chain of dependent steps, with the reference's
gates (the loss is finite, and the same step twice gives the same loss
bit for bit) and its Record keys.  The update is SGD or a ZeRO optimizer
(``zero-sgd``, ``zero-adam``, each with ``-offload``).  With
``attn="kernel"`` (the default, the reference's "pallas") attention runs
the flash kernels both ways: at sp = 1 K3 forward and K4 dq and dk/dv
backward once a rank, block and step; at sp > 1 the fused ring, sp² of
each a sp group, block and step.  Ranks that share a card run one after
another, so ``step_ms`` is the world's serial time on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.models.transformer import (
    ModelConfig,
    init_params,
    make_train_step,
    n_experts,
    shard_params,
    single_mesh,
)
from tpu_patterns_torch.runtime import resolve_device


@dataclasses.dataclass
class FlagshipConfig:
    """The measured flagship workload (CLI ``flagship`` subcommand)."""

    embed: int = 1024
    heads: int = 8
    head_dim: int = 128
    mlp_mult: int = 4
    seq: int = 4096
    batch: int = 4
    dtype: str = "bfloat16"
    causal: bool = True
    attn: str = "kernel"  # "dense" | "kernel"
    attn_layout: str = "contiguous"
    # flash tile request; None defers to ModelConfig's promoted tier
    block_q: int | None = None
    block_k: int | None = None
    attn_grid: str = "dense"  # "dense" | "compact"
    moe: bool = False
    # sgd | zero-sgd | zero-adam (the sharded optimizer) |
    # zero-sgd-offload | zero-adam-offload (moments in pinned host memory)
    optimizer: str = "sgd"
    remat: bool = False  # checkpoint each block (FLOPs for memory)
    remat_policy: str = "full"
    depth: int = 1
    kv_heads: int = 0  # GQA K/V heads (0 = MHA)
    rope: bool = False
    reps: int = 10
    warmup: int = 2
    min_tflops: float = -1.0
    seed: int = 0
    device: str = "cuda"  # "cpu" runs the plain torch versions


def flagship_flops(cfg: FlagshipConfig) -> float:
    """Model FLOPs of ONE training step (fwd + bwd = 3x fwd, the standard
    accounting): qkv/out projections, attention matmuls, MLP."""
    b, l, e = cfg.batch, cfg.seq, cfg.embed
    hd = cfg.heads * cfg.head_dim
    # GQA shrinks the k/v projections to kv_heads (q and out stay at H)
    kvd = (cfg.kv_heads or cfg.heads) * cfg.head_dim
    proj = 2 * b * l * e * (hd + 2 * kvd) + 2 * b * l * hd * e
    attn = 4.0 * l * l * cfg.heads * cfg.head_dim * b / (2 if cfg.causal else 1)
    mlp = 4 * b * l * e * (e * cfg.mlp_mult)
    per_block = proj + attn + mlp
    # full remat re-runs the whole forward once more per block; dots
    # only the attention part
    if not cfg.remat:
        step_flops = 3.0 * per_block
    elif cfg.remat_policy == "dots":
        step_flops = 3.0 * per_block + attn
    elif cfg.remat_policy == "full":
        step_flops = 4.0 * per_block
    else:
        raise ValueError(
            f"unknown remat_policy {cfg.remat_policy!r}; want full|dots"
        )
    return step_flops * cfg.depth


ZERO_OPTIMIZERS = tuple(f"zero-{base}{suffix}" for base in ("sgd", "adam")
                        for suffix in ("", "-offload"))


def _nbytes(*trees) -> int:
    total = 0
    for t in trees:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += _nbytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += _nbytes(*t)
    return total


def _mode(cfg: FlagshipConfig) -> str:
    remat = ""
    if cfg.remat:
        remat = "_remat" + ("" if cfg.remat_policy == "full"
                            else f"_{cfg.remat_policy}")
    return (cfg.attn + ("_moe" if cfg.moe else "")
            + (f"_{cfg.optimizer}" if cfg.optimizer != "sgd" else "")
            + remat + (f"_d{cfg.depth}" if cfg.depth > 1 else ""))


def model_config(cfg: FlagshipConfig) -> ModelConfig:
    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, causal=cfg.causal, dtype=cfg.dtype,
        moe=cfg.moe, attn=cfg.attn, attn_layout=cfg.attn_layout,
        remat=cfg.remat, remat_policy=cfg.remat_policy, depth=cfg.depth,
        kv_heads=cfg.kv_heads, rope=cfg.rope, block_q=cfg.block_q,
        block_k=cfg.block_k, attn_grid=cfg.attn_grid,
    )


def check_config(cfg: FlagshipConfig, mesh) -> None:
    """The reference's refusals: a batch or sequence the mesh does not
    divide, an unknown optimizer, and a compact grid where it would be
    ignored (not causal, not the kernel path, or sp > 1, whose ring keeps
    the dense grid)."""
    dp, sp = mesh.dim("dp"), mesh.dim("sp")
    if cfg.batch % dp or cfg.seq % sp:
        raise ValueError(
            f"batch {cfg.batch} must be divisible by dp={dp} and "
            f"seq {cfg.seq} by sp={sp}"
        )
    if cfg.optimizer != "sgd" and cfg.optimizer not in ZERO_OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer {cfg.optimizer!r}; want "
            "sgd|zero-sgd|zero-adam|zero-{sgd,adam}-offload"
        )
    if cfg.attn_grid != "dense":
        # a compact-labelled Record must never time a path that ignores
        # the flag
        if not cfg.causal:
            raise ValueError(
                "attn_grid='compact' requires --causal true (non-causal "
                "has no masked tiles to skip)"
            )
        if cfg.attn != "kernel":
            raise ValueError(
                "attn_grid='compact' applies to the fused attention path "
                "only (--attn kernel)"
            )
        if sp > 1:
            raise ValueError(
                "attn_grid='compact' is the single-device fused path; "
                "sp>1 routes to ring attention, which keeps the dense grid"
            )


def flagship_step(cfg: FlagshipConfig, mesh, mcfg: ModelConfig, lr: float):
    """(step over a state, the initial state) for ``cfg.optimizer``:
    ``step(state, xs) -> (state, loss)``, the state the per-rank params
    (sgd) or the ZeRO slices and optimizer state; ``step.calls`` counts
    the steps."""
    gen = torch.Generator().manual_seed(cfg.seed)
    params = init_params(gen, mcfg, mesh.devices[0], n_experts(mesh, mcfg))
    sharded = shard_params(params, mesh, mcfg)
    if cfg.optimizer == "sgd":
        inner = make_train_step(mesh, mcfg, lr=lr)
        state = sharded

        def step(st, xs):
            step.calls += 1
            return inner(st, xs)

    else:
        from tpu_patterns_torch.models.zero_step import make_zero_train_step

        base = cfg.optimizer.removesuffix("-offload").split("-", 1)[1]
        zstep, zinit, _ = make_zero_train_step(
            mesh, mcfg, lr=lr, optimizer=base,
            offload_state=cfg.optimizer.endswith("-offload"))
        state = zinit(sharded)

        def step(st, xs):
            step.calls += 1
            shards, opt, loss = zstep(*st, xs)
            return (shards, opt), loss

    step.calls = 0
    return step, state


def batch_shards(cfg: FlagshipConfig, mesh, dtype) -> list:
    """The measured input: seed + 1's [B, L, E] normal (striped along L
    for the striped layout, as the reference's caller stripes), each
    rank's [B/dp, L/sp, E] block."""
    from tpu_patterns_torch.longctx.attention import stripe

    x = torch.randn((cfg.batch, cfg.seq, cfg.embed),
                    generator=torch.Generator().manual_seed(cfg.seed + 1))
    if cfg.attn_layout == "striped":
        x = stripe(x, mesh.dim("sp"), axis=1)
    return mesh.shard(x.to(dtype), ("dp", "sp", None))


def run_flagship(cfg: FlagshipConfig, writer: ResultWriter | None = None,
                 mesh=None) -> list[Record]:
    """Measure the full training step (fwd + bwd + update) of
    ``cfg.depth`` blocks over ``mesh`` (a ``comm/mesh.py::NamedMesh``
    with axes dp, sp, tp; default one rank on ``cfg.device``).  Returns
    one Record: min-over-reps step time and model TFLOP/s, gated on a
    finite loss that two runs of the same step reproduce bit for bit.
    On the card the Record also carries the step's memory on the card
    (``peak_temp_MB`` above the resident state and input, ``argument_MB``,
    ``output_MB``); on the CPU it has none, as the reference leaves out
    what its backend cannot analyse."""
    writer = writer or ResultWriter()
    if mesh is None:
        mesh = single_mesh(resolve_device(cfg.device))
    check_config(cfg, mesh)
    mcfg = model_config(cfg)
    dev = mesh.devices[0]
    xs = batch_shards(cfg, mesh, mcfg.torch_dtype)
    # Timing lr: small enough that p - lr * g rounds back to p (reps
    # cannot diverge the unnormalized objective), non-zero so the update
    # is real work.
    step, state = flagship_step(cfg, mesh, mcfg, lr=1e-30)

    mem: dict[str, float] = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        new, loss = step(state, xs)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        mem = {
            "peak_temp_MB": (peak - resident) / 1e6,
            "argument_MB": _nbytes(state, xs) / 1e6,
            "output_MB": _nbytes(new, loss) / 1e6,
        }
        del new, loss

    def build_chain(k: int):
        # k steps chained through the updated state: none can be skipped
        def run():
            st = state
            for _ in range(k):
                st, _ = step(st, xs)
            mesh.ranks.join()

        return run

    res = timing.measure_chain(build_chain, reps=cfg.reps,
                               warmup=cfg.warmup, device=dev)
    _, loss = step(state, xs)
    loss = float(loss)
    flops = flagship_flops(cfg)
    tflops = flops / res.per_op_ns / 1e3
    # consistency: the same step twice must reproduce the loss exactly
    _, loss2 = step(state, xs)
    data_ok = math.isfinite(loss) and float(loss2) == loss
    perf_ok = cfg.min_tflops < 0 or tflops >= cfg.min_tflops
    writer.progress(f"flagship {cfg.attn} train step: {tflops:.6g} TFLOP/s")
    rec = Record(
        pattern="flagship",
        mode=_mode(cfg),
        commands=f"{mesh.describe()} B{cfg.batch} L{cfg.seq} E{cfg.embed} "
        f"{cfg.dtype}" + (" causal" if cfg.causal else "")
        + (f" {cfg.attn_layout}" if cfg.attn_layout != "contiguous" else ""),
        metrics={
            "tflops": tflops,
            "step_ms": res.per_op_ns / 1e6,
            "timing_converged": float(res.converged),
            "flops": flops,
            "loss": loss,
            "checksum_ok": float(data_ok),
            **mem,
        },
        # which silicon produced the rate
        config={
            "device_kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "block_q": mcfg.block_q, "block_k": mcfg.block_k,
            "train_steps": step.calls,
        },
        verdict=Verdict.SUCCESS if (data_ok and perf_ok) else Verdict.FAILURE,
    )
    if not data_ok:
        rec.notes.append(f"loss not finite/reproducible: {loss} vs {loss2}")
    if not perf_ok:
        rec.notes.append(f"{tflops:.3f} TFLOP/s below floor {cfg.min_tflops}")
    if note := res.noise_note("TFLOP/s"):
        rec.notes.append(note)
    if note := mesh.note("ring shifts and tp sums"):
        rec.notes.append(note + "; ranks sharing a card run one after "
                         "another, so step_ms is the world's serial time")
    return [writer.record(rec)]
