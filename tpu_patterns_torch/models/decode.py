"""Autoregressive decode over a dense two-segment KV cache.

Counterpart of ``tpu_patterns/models/decode.py`` on one device (no
sequence or tensor sharding): int8 KV quantization, the MLP, masked
attention against a cache and the cache layout (the pieces the paged
serve path reuses and the per-request dense oracle, ``models/lm.py``,
is built from), the decoder ``make_decoder`` (prefill, then a
self-feeding generation loop), and the measured ``decode`` pattern
``run_decode`` with its two gates: teacher-forced decode must equal the
training forward at every position, for lockstep and for ragged rows.
Every op is a torch op: the reference's decode at sp=1 runs no Pallas
kernel either (its cache attention is dense einsums).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tpu_patterns_torch.models.transformer import (
    ModelConfig,
    apply_rope,
    forward_stack,
    init_params,
    qkv_native,
    rope_tables,
)


def _neg_inf(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).min


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot symmetric int8: x [..., L, D] -> (int8 values, float32
    scale [..., L]).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=-1) / 127.0
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _mlp(params: dict, y: torch.Tensor) -> torch.Tensor:
    """The block's dense ReLU FFN with its residual."""
    hidden = torch.relu(torch.einsum("ble,ef->blf", y, params["w1"]))
    return y + torch.einsum("blf,fe->ble", hidden, params["w2"])


def _distributed_attention(
    q, cache_k, cache_v, mask, k_scale=None, v_scale=None
):
    """Masked softmax attention of q [B, Lq, H, D] against a cache
    [B, Hkv, L, D]; ``mask`` [B or 1, Lq, L] says which slots each query
    sees.  Scores stay in q's dtype and masked slots take that dtype's
    most negative finite value, as in the JAX package.  With GQA each
    cached head serves H/Hkv contiguous query heads.  int8 caches fold
    their per-slot scales in after the einsums: k's on the scores, v's
    on the probabilities after the normalizer is summed."""
    b, lq, h, d = q.shape
    hkv = cache_k.shape[1]
    g = h // hkv
    qg = q.reshape(b, lq, hkv, g, d)
    ck = cache_k.to(q.dtype) if cache_k.dtype == torch.int8 else cache_k
    s = torch.einsum("bqkgd,bkld->bkgql", qg, ck) * (d**-0.5)
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :].to(s.dtype)
    neg = _neg_inf(s.dtype)
    s = torch.where(mask[:, None, None], s, neg)
    m = s.amax(dim=-1, keepdim=True)
    # a query with no visible slot keeps m == finfo.min: clamp so its
    # probabilities are exactly 0 and the output 0/eps, never NaN
    m = torch.clamp_min(m, neg / 2)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :].to(p.dtype)
    cv = cache_v.to(p.dtype) if cache_v.dtype == torch.int8 else cache_v
    numer = torch.einsum("bkgql,bkld->bkgqd", p, cv)
    out = numer / torch.clamp_min(denom, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, d)


def kv_slot_bytes(
    head_dim: int, kv_heads: int, dtype: torch.dtype, cache_int8: bool
) -> int:
    """Bytes of one K+V cache slot (one token, one layer): int8 stores a
    byte per element plus a 4-byte scale per head; float stores the
    dtype's itemsize per element."""
    if cache_int8:
        return 2 * (kv_heads * head_dim + kv_heads * 4)
    return 2 * kv_heads * head_dim * torch.finfo(dtype).bits // 8


class _CacheLayout:
    """Two-segment contiguous cache on one device: slots [0, prefill)
    hold prompt positions, slots [prefill, prefill + gen_cap) hold
    generated tokens by generation index.  Every slot's position is a
    closed-form function of its index, so unwritten slots sit at future
    positions and no causal query sees them."""

    def __init__(self, prefill: int, gen_cap: int):
        self.prefill, self.gen_cap = prefill, gen_cap
        self.lc = prefill + gen_cap

    def kv_positions(self, device) -> torch.Tensor:
        """[lc] global position of each slot (gen index n at prefill+n)."""
        return torch.arange(self.lc, dtype=torch.int32, device=device)

    def slot_meta(self, device):
        """(prompt_pos, gen_index, is_gen), each [lc]: a prompt slot is
        visible to row b iff prompt_pos < lens[b], a gen slot iff
        gen_index <= the current step."""
        far = torch.iinfo(torch.int32).max
        i = torch.arange(self.lc, dtype=torch.int32, device=device)
        is_gen = i >= self.prefill
        prompt_pos = torch.where(is_gen, far, i)
        gen_index = torch.where(is_gen, i - self.prefill, far)
        return prompt_pos, gen_index, is_gen


def _zero_cache(cfg: ModelConfig, layout: _CacheLayout, batch, device,
                cache_int8: bool) -> dict:
    """Empty cache dict, [depth, B, Hkv, lc, ...] leaves."""
    kv_shape = (cfg.depth, batch, cfg.n_kv, layout.lc, cfg.head_dim)
    if cache_int8:
        return {
            "k": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "v": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(kv_shape[:-1], dtype=torch.float32,
                              device=device),
            "vs": torch.zeros(kv_shape[:-1], dtype=torch.float32,
                              device=device),
        }
    return {
        "k": torch.zeros(kv_shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=cfg.torch_dtype, device=device),
    }


def _cache_write(cache_l: dict, kt, vt, off: int) -> None:
    """Write k/v [B, Hkv, Lw, D] at slot ``off`` of one layer's cache,
    in place; quantizing on the way in when the cache is int8."""
    lw = kt.shape[2]
    if "ks" in cache_l:
        kq, ks = _quantize_kv(kt)
        vq, vs = _quantize_kv(vt)
        cache_l["k"][:, :, off:off + lw] = kq
        cache_l["v"][:, :, off:off + lw] = vq
        cache_l["ks"][:, :, off:off + lw] = ks
        cache_l["vs"][:, :, off:off + lw] = vs
        return
    cache_l["k"][:, :, off:off + lw] = kt.to(cache_l["k"].dtype)
    cache_l["v"][:, :, off:off + lw] = vt.to(cache_l["v"].dtype)


def _cache_attend(cache_l: dict, q, mask):
    return _distributed_attention(
        q, cache_l["k"], cache_l["v"], mask,
        k_scale=cache_l.get("ks"), v_scale=cache_l.get("vs"),
    )


def _prefill_layer(p_l, x, cache_l, layout: _CacheLayout, cfg: ModelConfig):
    """One layer over the whole right-padded prompt x [B, prefill, E]:
    write every position's k/v into the prompt segment, then attend
    causally over the cache (quantized values included, so prefill sees
    what decode will see)."""
    q, k, v = qkv_native(p_l, x)
    if cfg.rope:
        pos = torch.arange(layout.prefill, dtype=torch.int32, device=x.device)
        cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    _cache_write(cache_l, k.transpose(1, 2), v.transpose(1, 2), 0)
    q_pos = torch.arange(layout.prefill, dtype=torch.int32, device=x.device)
    mask = (layout.kv_positions(x.device)[None, :] <= q_pos[:, None])[None]
    attn = _cache_attend(cache_l, q, mask)
    y = x + torch.einsum("blhd,hde->ble", attn, p_l["wo"])
    return _mlp(p_l, y)


def _decode_mask(layout: _CacheLayout, lens, n: int) -> torch.Tensor:
    """[B, lc] slots visible to each row's n-th generated token: its
    prompt slots below lens[b] and the gen slots up to n."""
    prompt_pos, gen_index, is_gen = layout.slot_meta(lens.device)
    return torch.where(
        is_gen[None, :], gen_index[None, :] <= n,
        prompt_pos[None, :] < lens[:, None],
    )


def _decode_layer(p_l, x, cache_l, lens, n: int, layout: _CacheLayout,
                  cfg: ModelConfig, mask):
    """One layer for each row's n-th generated token x [B, 1, E]: row b's
    token sits at position lens[b] + n and is written to the shared gen
    slot n; a row sees the slots of ``mask`` (:func:`_decode_mask`, the
    same for every layer of a step)."""
    q, k, v = qkv_native(p_l, x)
    if cfg.rope:
        pos = (lens + n).to(torch.int32)[:, None]
        cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if 0 <= n < layout.gen_cap:
        _cache_write(
            cache_l, k.transpose(1, 2), v.transpose(1, 2), layout.prefill + n
        )
    out = _cache_attend(cache_l, q, mask[:, None, :])
    y = x + torch.einsum("blhd,hde->ble", out, p_l["wo"])
    return _mlp(p_l, y)


def _stacked_params(seed: int, cfg: ModelConfig, device) -> dict:
    """Block params with a leading [depth] axis (the port's layout at
    every depth, depth 1 included), drawn from a ``torch.Generator``
    seeded with ``seed``."""
    return init_params(torch.Generator().manual_seed(seed), cfg, device)


def _gather_last_valid(y, lens, layout: _CacheLayout) -> torch.Tensor:
    """[B, 1, E] output at each row's last valid prompt position
    ``lens[b] - 1``; a row whose position lies outside the prompt gets
    zeros."""
    idx = lens.to(torch.int64) - 1
    valid = (idx >= 0) & (idx < layout.prefill)
    rows = torch.arange(y.shape[0], device=y.device)
    gathered = y[rows, idx.clamp(0, layout.prefill - 1)][:, None, :]
    return torch.where(valid[:, None, None], gathered, 0)


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def make_decoder(
    cfg: ModelConfig,
    batch: int,
    prefill_len: int,
    gen_cap: int,
    cache_int8: bool = False,
    donate: bool = False,
):
    """The (prefill, generate) pair over a dense cache on one device.

    * ``prefill(params, x, lens=None) -> (caches, y_last)``: the
      right-padded prompt x [batch, prefill_len, E] through every layer,
      filling the prompt segment; ``lens`` [batch] gives each row's true
      prompt length (None: all prefill_len).  ``y_last`` [batch, 1, E]
      is each row's output at its last valid position, the first decode
      input.
    * ``generate(params, caches, y0, t0, n_steps) -> (caches, ys)``:
      ``n_steps`` of self-feeding decode, ys [batch, n_steps, E].  ``t0``
      is a global position (lockstep: every row at full prefill_len,
      ``t0 - prefill_len`` tokens generated already) or ``(lens, n0)``
      for ragged rows.  A write past ``gen_cap`` is dropped.

    Caches are dicts of [depth, B, Hkv, lc, ...] leaves on x's device
    (int8 K/V with per-slot float32 scales ``ks``/``vs`` under
    ``cache_int8``).  ``donate=True`` updates the caller's cache in place
    and returns it (the caller's cache is consumed); ``donate=False``
    works on a copy.  One Python loop runs the steps, each the depth
    loop of :func:`_decode_layer`; nothing in it reads a device value
    back to the host."""
    layout = _CacheLayout(prefill_len, gen_cap)

    @torch.no_grad()
    def prefill(params, x, lens=None):
        dev = x.device
        if lens is None:
            lens = torch.full((batch,), prefill_len, dtype=torch.int32,
                              device=dev)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        caches = _zero_cache(cfg, layout, x.shape[0], dev, cache_int8)
        y = x
        for i in range(cfg.depth):
            y = _prefill_layer(_layer(params, i), y, _layer(caches, i),
                               layout, cfg)
        return caches, _gather_last_valid(y, lens, layout)

    @torch.no_grad()
    def generate(params, caches, y0, t0, n_steps):
        dev = y0.device
        if isinstance(t0, tuple):
            lens, n0 = t0
            lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        else:
            lens = torch.full((batch,), prefill_len, dtype=torch.int32,
                              device=dev)
            n0 = int(t0) - prefill_len
        n0 = int(n0)
        if not donate:
            caches = {k: v.clone() for k, v in caches.items()}
        y, ys = y0, []
        for n in range(n0, n0 + int(n_steps)):
            mask = _decode_mask(layout, lens, n)
            for i in range(cfg.depth):
                y = _decode_layer(_layer(params, i), y, _layer(caches, i),
                                  lens, n, layout, cfg, mask)
            ys.append(y[:, 0])
        if not ys:
            return caches, y0[:, :0]
        return caches, torch.stack(ys, dim=1)

    return prefill, generate


@dataclasses.dataclass
class DecodeConfig:
    """CLI ``decode`` subcommand."""

    embed: int = 1024
    heads: int = 8
    head_dim: int = 128
    mlp_mult: int = 4
    dtype: str = "bfloat16"
    depth: int = 4
    kv_heads: int = 0  # GQA: K/V heads (0 = MHA); cache shrinks H/kv-fold
    rope: bool = False  # rotary position embeddings on q/k
    cache_int8: bool = False  # int8 K/V cache with per-slot scales
    layout: str = "contiguous"  # "striped" is refused (sp > 1)
    moe: bool = False  # refused: the mixture FFN is not ported
    batch: int = 8
    prefill: int = 4096  # prompt tokens (the long-context side)
    gen: int = 128  # generated tokens per rep
    reps: int = 5
    warmup: int = 1
    min_tokens_per_s: float = -1.0
    seed: int = 0
    device: str = "cuda"  # "cpu" runs on the CPU


def model_config(cfg: DecodeConfig) -> ModelConfig:
    """The block config of a ``decode`` run; raises NotImplementedError
    for what is not ported (``moe``, the striped layout)."""
    if cfg.moe or cfg.layout == "striped":
        raise NotImplementedError(
            "decode: moe and the striped layout run across ranks, not "
            "ported yet (ROADMAP.md Queue 1 step 8c, decode and lm "
            "across ranks)")
    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, causal=True, dtype=cfg.dtype,
        depth=cfg.depth, kv_heads=cfg.kv_heads, rope=cfg.rope,
        attn_layout=cfg.layout, moe=cfg.moe,
    )


def _timed_ms(fn, dev: torch.device) -> float:
    """Milliseconds of one ``fn()``: CUDA events on the card, the host
    clock on the CPU."""
    from tpu_patterns_torch.core.timing import clock_ns

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = clock_ns()
    fn()
    return (clock_ns() - t0) / 1e6


def run_decode(cfg: DecodeConfig, writer=None) -> list:
    """Measured pattern: prefill a long context, then time the
    self-feeding generation loop.  Gate: teacher-forced decode equals
    the training forward (:func:`_teacher_forcing_gate`, on a small
    probe shape, every position), and ``min_tokens_per_s`` when set."""
    from tpu_patterns_torch import obs
    from tpu_patterns_torch.core import timing
    from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
    from tpu_patterns_torch.runtime import resolve_device

    writer = writer or ResultWriter()
    dev = resolve_device(cfg.device)
    mcfg = model_config(cfg)
    # the measured pattern owns its cache: generate updates it in place
    prefill, generate = make_decoder(
        mcfg, cfg.batch, cfg.prefill, cfg.gen, cache_int8=cfg.cache_int8,
        donate=True,
    )
    params = _stacked_params(cfg.seed, mcfg, dev)
    x = _probe_input(cfg.seed + 1, (cfg.batch, cfg.prefill, cfg.embed),
                     dev).to(mcfg.torch_dtype)
    caches, y0 = prefill(params, x)
    # time to first token: one warmed prefill over the full context
    with obs.span("decode.prefill", tokens=cfg.batch * cfg.prefill):
        prefill_ms = _timed_ms(lambda: prefill(params, x), dev)

    gate = _teacher_forcing_gate(mcfg, cache_int8=cfg.cache_int8,
                                 device=dev)

    def fresh():
        return {k: v.clone() for k, v in caches.items()}

    def build_chain(k: int):
        def run():
            # every iteration regenerates the same positions (t0 fixed),
            # fed by the previous one's last output; generation consumes
            # its cache, so the chain starts from a fresh copy of the
            # prefill cache
            c, y = fresh(), y0
            for _ in range(k):
                c, out = generate(params, c, y, cfg.prefill, cfg.gen)
                y = out[:, -1:, :]

        return run

    res = timing.measure_chain(build_chain, reps=cfg.reps,
                               warmup=cfg.warmup, device=dev)
    tokens = cfg.batch * cfg.gen
    sec = res.per_op_ns * 1e-9
    tps = tokens / sec if sec > 0 else 0.0
    # the copy rides inside every timed window (CHAIN_K generate calls)
    clone_ns = timing.measure_chain(
        lambda k: lambda: [fresh() for _ in range(k)], reps=3, warmup=1,
        device=dev).per_op_ns
    clone_share = clone_ns / (res.per_op_ns * timing.CHAIN_K)
    obs.gauge("tpu_patterns_decode_tokens_per_s").set(tps)
    obs.gauge("tpu_patterns_decode_prefill_ms").set(prefill_ms)
    if cfg.gen > 0 and sec > 0:
        obs.histogram("tpu_patterns_decode_step_ms").observe(
            1e3 * sec / cfg.gen
        )
    obs.counter("tpu_patterns_decode_tokens_total").inc(tokens)
    max_len = cfg.prefill + cfg.gen
    cache_mb = (
        cfg.depth * cfg.batch * max_len
        * kv_slot_bytes(cfg.head_dim, cfg.kv_heads or cfg.heads,
                        mcfg.torch_dtype, cfg.cache_int8) / 1e6
    )
    ok = gate and np.isfinite(tps) and tps > 0
    if cfg.min_tokens_per_s > 0:
        ok = ok and tps >= cfg.min_tokens_per_s
    rec = Record(
        pattern="decode",
        mode="sp1"
        + (f"_gqa{cfg.kv_heads}" if cfg.kv_heads else "")
        + ("_rope" if cfg.rope else "")
        + ("_int8" if cfg.cache_int8 else ""),
        commands=(
            f"B{cfg.batch} prefill{cfg.prefill} gen{cfg.gen} "
            f"depth{cfg.depth} {cfg.dtype}"
        ),
        metrics={
            "tokens_per_s": round(tps, 1),
            "ms_per_token": round(1e3 * sec / cfg.gen, 3),
            "prefill_ms": round(prefill_ms, 2),
            "cache_MB": round(cache_mb, 3),
            "prefill_context": float(cfg.prefill),
            "timing_converged": float(res.converged),
        },
        verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
    )
    if note := res.noise_note("tokens/s"):
        rec.notes.append(note)
    if clone_share > 0.01:
        rec.notes.append(
            f"the cache copy at the head of each timed chain is "
            f"{100 * clone_share:.2f}% of its window (in ms_per_token)"
        )
    if not gate:
        rec.notes.append("teacher-forcing gate FAILED: cache path diverges")
    writer.record(rec)
    return [rec]


@contextlib.contextmanager
def _exact_matmuls(dev: torch.device):
    """TF32 off for the block on the card (restored after), so float32
    products are float32 on both sides of a gate."""
    if dev.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _probe_input(seed: int, shape, device) -> torch.Tensor:
    """Standard normal float32 ``shape`` from a CPU generator seeded with
    ``seed`` (the same values on every device), moved to ``device``."""
    return torch.randn(
        shape, generator=torch.Generator().manual_seed(seed)
    ).to(device)


def teacher_forced(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   half: int, cache_int8: bool = False):
    """(got, want) [B, L - half + 1, E] float32 numpy: the decoder's
    outputs at positions half-1 .. L-1 (prefill of x[:, :half], then
    x[:, t] fed at each t; teacher forcing, so every step meets the
    forward's input) and :func:`forward_stack`'s over the whole of x."""
    b, l, _ = x.shape
    with torch.no_grad():
        want = forward_stack(params, x, cfg)
    prefill, generate = make_decoder(cfg, b, half, l - half,
                                     cache_int8=cache_int8)
    c, y_last = prefill(params, x[:, :half])
    got = [y_last[:, 0]]
    for t in range(half, l):
        c, ys = generate(params, c, x[:, t:t + 1], t, 1)
        got.append(ys[:, 0])
    return (torch.stack(got, dim=1).float().cpu().numpy(),
            want[:, half - 1:].float().cpu().numpy())


def _teacher_forcing_gate(big: ModelConfig, cache_int8: bool = False,
                          device="cpu") -> bool:
    """Decode against the training forward on a probe shape (embed 64,
    8 heads of 8, float32, 32 tokens, half prefilled) at ``big``'s depth,
    RoPE and GQA layout: every position within 64 eps of the output's
    magnitude, 8% for an int8 cache (its honest quantization noise; a
    misrouted slot is an O(1) error)."""
    dev = torch.device(device)
    kv = 4 if big.kv_heads else 0
    cfg = dataclasses.replace(big, embed=64, heads=8, head_dim=8,
                              dtype="float32", causal=True, kv_heads=kv)
    b, l = 2, 32
    with _exact_matmuls(dev):
        params = _stacked_params(17, cfg, dev)
        x = _probe_input(18, (b, l, cfg.embed), dev)
        got, ref = teacher_forced(cfg, params, x, l // 2, cache_int8)
    scale = max(1.0, float(np.abs(ref).max()))
    tol = (0.08 * scale if cache_int8
           else 64 * np.finfo(np.float32).eps * scale)
    return bool(np.abs(got - ref).max() <= tol)


def _ragged_gate(big: ModelConfig, lens_fn=None, device="cpu") -> bool:
    """Ragged decode against the forward: rows with different true
    prompt lengths (right-padded to a 16-token prefill), each
    teacher-forced 2 steps, must equal the plain causal forward of the
    row's own unpadded stream at positions lens[b] - 1 .. lens[b] + 1,
    within 64 eps of the row's magnitude.  Run it with ``big.rope`` so an
    off-by-one slot shifts a rotary phase.  ``lens_fn(b, lp)`` overrides
    the default lengths ``[16, 13]``."""
    dev = torch.device(device)
    b, lp, gen = 2, 16, 2
    cfg = dataclasses.replace(big, embed=64, heads=8, head_dim=8, depth=1,
                              dtype="float32", causal=True, kv_heads=0)
    if lens_fn is None:
        lens_np = np.array([max(1, lp - 3 * i) for i in range(b)], np.int32)
    else:
        lens_np = np.asarray(lens_fn(b, lp), np.int32)
        if lens_np.shape != (b,) or lens_np.min() < 1 or lens_np.max() > lp:
            raise ValueError(
                f"lens_fn must return [b={b}] lengths in [1, {lp}], "
                f"got {lens_np!r}"
            )
    eps = 64 * np.finfo(np.float32).eps

    def row_ok(got_row, ref_row) -> bool:
        scale = max(1.0, float(np.abs(ref_row).max()))
        return bool(np.abs(got_row - ref_row).max() <= eps * scale)

    with _exact_matmuls(dev), torch.no_grad():
        params = _stacked_params(21, cfg, dev)
        x = _probe_input(22, (b, lp + gen, cfg.embed), dev)
        want = np.zeros((b, lp + gen, cfg.embed), np.float32)
        for row in range(b):
            ln = int(lens_np[row])
            seq = torch.cat([x[row, :ln], x[row, lp:lp + gen]])[None]
            want[row, :ln + gen] = (
                forward_stack(params, seq, cfg)[0].cpu().numpy())
        prefill, generate = make_decoder(cfg, b, lp, gen)
        lens = torch.as_tensor(lens_np, device=dev)
        c, y0 = prefill(params, x[:, :lp], lens)
        y0 = y0.cpu().numpy()
        ok = all(row_ok(y0[row, 0], want[row, lens_np[row] - 1])
                 for row in range(b))
        for n in range(gen):
            c, ys = generate(params, c, x[:, lp + n:lp + n + 1], (lens, n), 1)
            ys = ys.cpu().numpy()
            ok = ok and all(row_ok(ys[row, 0], want[row, lens_np[row] + n])
                            for row in range(b))
    return ok
