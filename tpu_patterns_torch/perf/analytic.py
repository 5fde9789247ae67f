"""Closed-form FLOP / HBM-byte accounting for the ported entry points.

Copied from ``tpu_patterns/perf/analytic.py``: every count is a pure
function of the model config, so it is the same on the CPU and on the
card, which lets the perf baseline ratchet it with a near-zero band
(metric class ``analytic``, ``perf/baseline.py``) while measured times
ride a noise band.  On the card the same counts divide measured times
into achieved FLOP/s and bytes/s for the roofline table
(``perf/report.py``).  The counts sit on this package's own
``models/decode.py::kv_slot_bytes`` and
``models/flagship.py::flagship_flops``.

Conventions (the same accounting ``flagship_flops`` uses):

* a dot of [m,k]x[k,n] costs ``2*m*k*n`` FLOPs (multiply + add);
* causal attention halves the score/value work (only the live triangle);
* backward = 2x forward, so a train step is 3x the forward count;
* elementwise work (softmax, rope, norms) is not billed.

HBM byte counts are *analytic traffic floors*: parameter bytes read once
per call, KV-cache bytes read/written through the paged tables, logits.
Activation round-trips are excluded: the floor is the roofline
denominator, not an allocation prediction.
"""

from __future__ import annotations

import dataclasses

from tpu_patterns_torch.models.decode import kv_slot_bytes
from tpu_patterns_torch.models.flagship import flagship_flops
from tpu_patterns_torch.models.transformer import ModelConfig


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(attention width H*D, kv width Hkv*D, mlp hidden)."""
    hd = cfg.heads * cfg.head_dim
    kvd = (cfg.kv_heads or cfg.heads) * cfg.head_dim
    return hd, kvd, cfg.embed * cfg.mlp_mult


def param_count(cfg: ModelConfig, vocab: int) -> int:
    """Analytic parameter count of the stacked LM: per block the q and
    out projections (E*HD each), the kv projection (2*E*KVD), and the
    two MLP mats (2*E*hidden); plus the tied embedding (V*E)."""
    hd, kvd, hidden = _dims(cfg)
    e = cfg.embed
    per_block = e * hd + 2 * e * kvd + hd * e + 2 * e * hidden
    return cfg.depth * per_block + vocab * e


def param_bytes(cfg: ModelConfig, vocab: int) -> int:
    return param_count(cfg, vocab) * cfg.torch_dtype.itemsize


def prefill_flops(
    cfg: ModelConfig, vocab: int, rows: int, prompt_len: int
) -> float:
    """One paged prefill call: full forward over [rows, prompt_len] plus
    the single last-position logits matmul."""
    b, l, e = rows, prompt_len, cfg.embed
    hd, kvd, hidden = _dims(cfg)
    proj = 2 * b * l * e * (hd + 2 * kvd) + 2 * b * l * hd * e
    attn = 4.0 * b * l * l * hd / 2  # causal: live triangle only
    mlp = 4 * b * l * e * hidden
    logits = 2 * b * e * vocab  # last position only
    return cfg.depth * (proj + attn + mlp) + logits


def step_flops(
    cfg: ModelConfig, vocab: int, rows: int, ctx: int
) -> float:
    """One paged decode step: a 1-token forward per row attending over
    ``ctx`` cached positions, plus full-vocab logits."""
    b, e = rows, cfg.embed
    hd, kvd, hidden = _dims(cfg)
    proj = 2 * b * e * (hd + 2 * kvd) + 2 * b * hd * e
    attn = 4.0 * b * hd * ctx  # q.K over ctx + scores.V over ctx
    mlp = 4 * b * e * hidden
    logits = 2 * b * e * vocab
    return cfg.depth * (proj + attn + mlp) + logits


def verify_flops(
    cfg: ModelConfig, vocab: int, rows: int, width: int, ctx: int
) -> float:
    """One speculative wide step: ``width`` fed positions per row (last
    committed token + drafts), each attending over its own prefix
    (~ctx), logits at EVERY fed position."""
    b, e = rows, cfg.embed
    hd, kvd, hidden = _dims(cfg)
    proj = 2 * b * width * e * (hd + 2 * kvd) + 2 * b * width * hd * e
    attn = 4.0 * b * width * hd * ctx
    mlp = 4 * b * width * e * hidden
    logits = 2 * b * width * e * vocab
    return cfg.depth * (proj + attn + mlp) + logits


def train_step_flops(
    cfg: ModelConfig, batch: int, seq: int
) -> float:
    """One training step (fwd + bwd + SGD ≈ 3x fwd): delegates to
    ``flagship_flops`` through a duck-typed config, so the registry's
    train entry and the flagship Records never disagree on the count."""
    duck = _FlagshipDims(
        batch=batch, seq=seq, embed=cfg.embed, heads=cfg.heads,
        head_dim=cfg.head_dim, kv_heads=cfg.kv_heads,
        mlp_mult=cfg.mlp_mult, causal=cfg.causal, depth=cfg.depth,
        remat=cfg.remat, remat_policy=cfg.remat_policy,
    )
    return flagship_flops(duck)


@dataclasses.dataclass(frozen=True)
class _FlagshipDims:
    """The field surface ``flagship_flops`` reads."""

    batch: int
    seq: int
    embed: int
    heads: int
    head_dim: int
    kv_heads: int
    mlp_mult: int
    causal: bool
    depth: int
    remat: bool
    remat_policy: str


# -- HBM traffic floors ----------------------------------------------------


def kv_token_bytes(cfg: ModelConfig, cache_int8: bool) -> int:
    """K+V bytes of one token's cache slots across ALL layers."""
    return cfg.depth * kv_slot_bytes(
        cfg.head_dim, cfg.kv_heads or cfg.heads, cfg.torch_dtype, cache_int8
    )


def prefill_hbm_bytes(
    cfg: ModelConfig, vocab: int, rows: int, prompt_len: int,
    cache_int8: bool = False,
) -> float:
    """Traffic floor of one prefill: params read once, every position's
    K/V written once and read back over the causal triangle (~L/2 mean
    context), logits row out."""
    kv_tok = kv_token_bytes(cfg, cache_int8)
    write = rows * prompt_len * kv_tok
    read = rows * prompt_len * (prompt_len / 2) * kv_tok
    logits = rows * vocab * 4
    return float(param_bytes(cfg, vocab) + write + read + logits)


def step_hbm_bytes(
    cfg: ModelConfig, vocab: int, rows: int, ctx: int,
    cache_int8: bool = False,
) -> float:
    """Traffic floor of one decode step: params read once, ``ctx``
    cached positions read per row, one position written, logits row
    out."""
    kv_tok = kv_token_bytes(cfg, cache_int8)
    return float(
        param_bytes(cfg, vocab)
        + rows * ctx * kv_tok
        + rows * kv_tok
        + rows * vocab * 4
    )


def train_step_hbm_bytes(
    cfg: ModelConfig, batch: int, seq: int
) -> float:
    """Traffic floor of one train step: params read in fwd and bwd,
    grads materialized once, params written once (SGD in place) — 4x
    param bytes; activations excluded."""
    # vocab=0: the train step's loss is on embeddings, no LM head
    return float(4 * param_bytes(cfg, vocab=0))
