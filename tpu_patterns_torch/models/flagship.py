"""The flagship workload: the PatternFormer train step on one device.

Counterpart of ``tpu_patterns/models/transformer.py``'s
``FlagshipConfig``, ``flagship_flops`` and ``run_flagship``: forward,
mean-square loss, backward and SGD of ``depth`` transformer blocks,
timed as a chain of dependent steps, with the reference's gates (the
loss is finite, and the same step twice gives the same loss bit for
bit) and its Record keys.  With ``attn="kernel"`` (the default, the
reference's "pallas") attention runs the flash kernels both ways: K3
forward and K4 dq and dk/dv backward per block per step.
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


def unported(cfg: FlagshipConfig) -> str | None:
    """Why ``cfg`` asks for something this package does not do yet, or
    None.  The reference takes these values; here they are refused, never
    ignored."""
    if cfg.moe:
        return "moe=True is not ported to tpu_patterns_torch yet"
    if cfg.optimizer != "sgd":
        return (f"optimizer {cfg.optimizer!r} is not ported yet (ZeRO "
                "optimizers: slice C); want sgd")
    if cfg.attn_layout == "striped":
        return "attn_layout='striped' is an sp > 1 layout, not ported yet"
    if cfg.remat_policy == "dots":
        return "remat_policy='dots' is not ported yet (ROADMAP.md, slice B)"
    return None


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
    # (not ported, kept for the accounting) only the attention part
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


def _nbytes(*trees) -> int:
    total = 0
    for t in trees:
        for x in (t.values() if isinstance(t, dict) else (t,)):
            total += x.numel() * x.element_size()
    return total


def _mode(cfg: FlagshipConfig) -> str:
    return (cfg.attn + ("_remat" if cfg.remat else "")
            + (f"_d{cfg.depth}" if cfg.depth > 1 else ""))


def run_flagship(cfg: FlagshipConfig,
                 writer: ResultWriter | None = None) -> list[Record]:
    """Measure the full training step (fwd + bwd + SGD) of ``cfg.depth``
    blocks on one device.  Returns one Record: min-over-reps step time
    and model TFLOP/s, gated on a finite loss that two runs of the same
    step reproduce bit for bit.  On the card the Record also carries the
    step's device memory (``peak_temp_MB`` above the resident params and
    input, ``argument_MB``, ``output_MB``); on the CPU it has none, as
    the reference leaves out what its backend cannot analyse."""
    writer = writer or ResultWriter()
    why = unported(cfg)
    if why:
        raise NotImplementedError(why)
    dev = resolve_device(cfg.device)
    mcfg = ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, causal=cfg.causal, dtype=cfg.dtype,
        attn=cfg.attn, attn_layout=cfg.attn_layout, remat=cfg.remat,
        remat_policy=cfg.remat_policy, depth=cfg.depth,
        kv_heads=cfg.kv_heads, rope=cfg.rope, block_q=cfg.block_q,
        block_k=cfg.block_k, attn_grid=cfg.attn_grid,
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
    params = init_params(torch.Generator().manual_seed(cfg.seed), mcfg, dev)
    x = torch.randn(
        (cfg.batch, cfg.seq, cfg.embed),
        generator=torch.Generator().manual_seed(cfg.seed + 1),
    ).to(device=dev, dtype=mcfg.torch_dtype)
    # Timing lr: small enough that p - lr * g rounds back to p (reps
    # cannot diverge the unnormalized objective), non-zero so the update
    # is real work.
    step = make_train_step(mcfg, lr=1e-30)

    mem: dict[str, float] = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        new, loss = step(params, x)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        mem = {
            "peak_temp_MB": (peak - resident) / 1e6,
            "argument_MB": _nbytes(params, x) / 1e6,
            "output_MB": _nbytes(new, loss) / 1e6,
        }
        del new, loss

    def build_chain(k: int):
        # k steps chained through the updated params: none can be skipped
        def run():
            pp = params
            for _ in range(k):
                pp, _ = step(pp, x)

        return run

    res = timing.measure_chain(build_chain, reps=cfg.reps,
                               warmup=cfg.warmup, device=dev)
    _, loss = step(params, x)
    loss = float(loss)
    flops = flagship_flops(cfg)
    tflops = flops / res.per_op_ns / 1e3
    # consistency: the same step twice must reproduce the loss exactly
    _, loss2 = step(params, x)
    data_ok = math.isfinite(loss) and float(loss2) == loss
    perf_ok = cfg.min_tflops < 0 or tflops >= cfg.min_tflops
    writer.progress(f"flagship {cfg.attn} train step: {tflops:.6g} TFLOP/s")
    rec = Record(
        pattern="flagship",
        mode=_mode(cfg),
        commands=f"dp1 sp1 tp1 B{cfg.batch} L{cfg.seq} E{cfg.embed} "
        f"{cfg.dtype}" + (" causal" if cfg.causal else ""),
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
    return [writer.record(rec)]
