"""One-sided puts: the HBM-copy headline on one device, and the ring put.

Counterpart of ``tpu_patterns/comm/onesided.py``.
A one-sided put writes a buffer into memory of the device's own with no
receiver: there, an async DMA fenced by a semaphore wait; here, bulk
asynchronous copies through shared memory fenced by an mbarrier and a
bulk-group wait, or a copy streamed through registers fenced by the
launch's end (``csrc/local_put.cu``).  Four schedules, each a CUDA
kernel written for sm_90a:

* :func:`local_put` (K8a, mono): one launch copies the whole buffer,
  one contiguous span per SM (:func:`mono_spans`);
* :func:`local_put_streamed` (K8b): row tiles of ``block_rows`` rows,
  each cut into 16 KB pieces, one block a piece (:func:`streamed_pieces`),
  streamed through registers (``csrc/stream_copy.cuh``);
* :func:`local_put_multi` (K8c): ``chunks`` row slices, all in flight
  in one launch, each cut into spans over its share of the SMs
  (:func:`multi_spans`);
* :func:`local_put_inplace` (K8d): each chunk's first half copied into
  its tail inside the same buffer, each half cut into spans over its
  chunk's share of the SMs (:func:`inplace_spans`).

On a CUDA tensor each wrapper launches its kernel (counted in its
``launches``) or raises; on a CPU tensor it runs its plain version
(``*_reference``), the same function in plain torch.  There is no other
path.  :func:`run_onesided` times the schedules and a compiler-free
contrast (``xla``: ``torch.roll`` by one row, a library op, kept under
the reference's name) and records the fastest as the put bandwidth.

Over a rank mesh of more than one rank (``comm/mesh.py``),
:func:`ring_put` (K9, ``csrc/ring_put.cu``, on the same streaming copy,
one block a piece: :func:`ring_put_pieces`) puts every rank's shard into
its +1 neighbour's output buffer, and :func:`run_onesided` runs the
reference's ``ring_put`` mode.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os

import torch

from tpu_patterns_torch.comm import verify
from tpu_patterns_torch.comm.dtypes import get_dtype
from tpu_patterns_torch.comm.mesh import RankMesh
from tpu_patterns_torch.comm.ring import ring_perm, ring_shift
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
from tpu_patterns_torch.runtime import (
    SPEC_PLAUSIBILITY_MARGIN,
    chip_hbm_gbps,
    resolve_device,
)

KERNELS = ("auto", "streamed", "multi", "mono", "xla", "inplace")
COLS = 512  # the reference's 2-D layout: rows x 512


def hbm_plausible(gbps: float, spec_gbps: float | None) -> bool:
    """Whether a measured copy rate can have gone through device
    memory: every copied byte is one read and one write, so the traffic
    is twice the copy rate, bounded by the card's datasheet rate."""
    return spec_gbps is None or 2.0 * gbps <= SPEC_PLAUSIBILITY_MARGIN * spec_gbps


def _largest_divisor_at_most(rows: int, k: int) -> int:
    """Largest divisor of ``rows`` that is <= ``k`` (>= 1): the
    schedules' row slices tile the buffer exactly."""
    k = max(1, min(k, rows))
    while rows % k:
        k -= 1
    return k


def _inplace_plan(rows: int, chunks: int) -> tuple[int, int, int]:
    """(n_chunks, chunk_rows, half) for :func:`local_put_inplace`; shared
    with :func:`run_onesided` so that its oracle and its bytes-moved
    factor see the clamping the kernel applied."""
    chunks = _largest_divisor_at_most(rows, min(chunks, max(1, rows // 2)))
    chunk_rows = rows // chunks
    return chunks, chunk_rows, chunk_rows // 2


# -- the kernels' wrappers -----------------------------------------------


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from tpu_patterns_torch.kernels.build import load

    lib = load("local_put")
    if lib.local_put_mono.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.local_put_stage_bytes.restype = i64
        lib.local_put_stage_bytes.argtypes = []
        lib.local_put_mono_span.restype = i64
        lib.local_put_mono_span.argtypes = [i64, i64]
        lib.local_put_multi_span.restype = i64
        lib.local_put_multi_span.argtypes = [i64, i64, i64]
        lib.local_put_streamed_grid.restype = i64
        lib.local_put_streamed_grid.argtypes = [i64, i64]
        sigs = {
            "local_put_mono": [ptr, ptr, i64, ptr],
            "local_put_streamed": [ptr, ptr, i64, i64, ptr],
            "local_put_multi": [ptr, ptr, i64, i64, ptr],
            "local_put_inplace": [ptr, i64, i64, i64, i64, ptr],
        }
        for name, args in sigs.items():
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = args
    return lib


# The largest stage a block of the kernels stages through shared memory
# (csrc/local_put.cu STAGE_BYTES; the smoke checks the two agree).  Two
# stages and the barriers fit in the 227 KB a block may use.
STAGE_BYTES = 112 * 1024
# The smallest span of the mono put (csrc/local_put.cu MONO_MIN_SPAN).
MONO_MIN_SPAN = 16 * 1024
# The streaming copy of K8b and K9 (csrc/stream_copy.cuh): a block of
# 256 threads, each with 4 16-byte loads in flight, moves STREAM_STEP
# bytes a step.
STREAM_STEP = 256 * 4 * 16


def mono_span(n: int, sms: int) -> int:
    """K8a's span for an ``n``-byte buffer (n >= 1) on a card of ``sms``
    SMs, as ``local_put.cu::mono_span`` computes it: n over min(sms,
    ceil(n / MONO_MIN_SPAN)) blocks, rounded up to 16 bytes."""
    blocks = min(sms, -(-n // MONO_MIN_SPAN))
    return (-(-n // blocks) + 15) & ~15


def mono_spans(n: int, sms: int) -> list[tuple[int, int]]:
    """The (start, stop) byte spans of K8a's blocks, one per block, the
    last one ragged."""
    if n <= 0:
        return []
    span = mono_span(n, sms)
    return [(s, min(s + span, n)) for s in range(0, n, span)]


def multi_span(chunk_bytes: int, chunks: int, sms: int) -> int:
    """K8c's span for chunks of ``chunk_bytes`` (>= 1) on a card of
    ``sms`` SMs, as ``local_put.cu::multi_span`` computes it: K8a's span
    for one chunk over max(1, sms // chunks) blocks."""
    return mono_span(chunk_bytes, max(1, sms // chunks))


def multi_spans(chunk_bytes: int, chunks: int, sms: int
                ) -> list[tuple[int, int]]:
    """The (start, stop) byte spans of K8c's blocks over the whole
    buffer of ``chunks`` chunks, one per block in launch order: each
    chunk's spans, its last one ragged."""
    if chunk_bytes <= 0 or chunks <= 0:
        return []
    span = multi_span(chunk_bytes, chunks, sms)
    return [(c * chunk_bytes + s, c * chunk_bytes + min(s + span, chunk_bytes))
            for c in range(chunks) for s in range(0, chunk_bytes, span)]


def inplace_spans(rows: int, row_bytes: int, chunks: int, sms: int
                  ) -> list[tuple[int, int, int]]:
    """The (src_start, dst_start, src_stop) byte offsets of K8d's blocks
    in a buffer of ``rows`` rows of ``row_bytes``, one per block in
    launch order: for each of :func:`_inplace_plan`'s chunks, its first
    ``half`` rows cut as :func:`multi_spans` cuts a chunk of the half's
    bytes (the C side's ``local_put_multi_span(half_bytes, n_chunks,
    sms)``), each span written ``chunk_rows - half`` rows further on, the
    last span of a chunk ragged.  Fewer than two rows: no span."""
    if rows < 2 or row_bytes <= 0:
        return []
    n_chunks, chunk_rows, half = _inplace_plan(rows, chunks)
    chunk, half_bytes = chunk_rows * row_bytes, half * row_bytes
    shift = (chunk_rows - half) * row_bytes
    # multi_spans of the halves laid end to end, moved to their chunks
    out = []
    for start, stop in multi_spans(half_bytes, n_chunks, sms):
        src = start + start // half_bytes * (chunk - half_bytes)
        out.append((src, src + shift, src + stop - start))
    return out


def _check(x: torch.Tensor, name: str) -> None:
    """The kernels copy bytes: any dtype, a contiguous tensor of rank
    >= 1 whose leading axis is the rows."""
    if x.ndim < 1:
        raise ValueError(f"{name}: want rank >= 1, got a scalar")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _launch(name: str, *args) -> None:
    rc = getattr(_library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _row_bytes(x: torch.Tensor) -> int:
    return x.numel() // x.shape[0] * x.element_size()


def local_put_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain K8a, K8b and K8c: the put's output is a copy of its input."""
    return x.clone()


def local_put(x: torch.Tensor) -> torch.Tensor:
    """One-sided put into the device's own memory as one copy with one
    fence (K8a): a new tensor equal to ``x``."""
    if x.ndim and (x.shape[0] == 0 or x.numel() == 0):
        return x
    if x.device.type == "cpu":
        return local_put_reference(x)
    _check(x, "local_put")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("local_put_mono", x.data_ptr(), out.data_ptr(),
                x.numel() * x.element_size(), _stream(x))
    local_put.launches += 1
    return out


def streamed_block_rows(rows: int, row_bytes: int, block_rows: int) -> int:
    """``block_rows`` as K8b runs it: rows per tile, clamped so
    that a tile is at most ``STAGE_BYTES`` (a 512-column float32 row is
    2 KB, so this replaces the reference's 4 MiB VMEM cap: 48 rows and
    1,920 tiles at the full buffer) and then to a divisor of ``rows``.
    A row longer than that takes one row per tile."""
    return _largest_divisor_at_most(
        rows, min(block_rows, max(1, STAGE_BYTES // max(1, row_bytes)))
    )


def streamed_pieces(rows: int, row_bytes: int, block_rows: int
                    ) -> list[tuple[int, int]]:
    """The (start, stop) bytes of K8b's blocks over a buffer of ``rows``
    rows of ``row_bytes``: each tile of :func:`streamed_block_rows` rows
    cut into ``STREAM_STEP`` pieces, its last ragged, one block a piece,
    in launch order (the C side's ``local_put_streamed_grid`` counts
    them)."""
    if rows <= 0 or row_bytes <= 0:
        return []
    return _step_pieces(
        rows * row_bytes,
        streamed_block_rows(rows, row_bytes, block_rows) * row_bytes)


def ring_put_pieces(n_bytes: int) -> list[tuple[int, int]]:
    """The (start, stop) bytes of K9's blocks over an ``n_bytes`` shard,
    one tile: one block a ``STREAM_STEP`` piece, the last ragged, in
    launch order (the C side's ``ring_put_grid`` counts them)."""
    return _step_pieces(n_bytes, n_bytes) if n_bytes > 0 else []


def _step_pieces(n_bytes: int, tile: int) -> list[tuple[int, int]]:
    """``n_bytes`` cut into tiles of ``tile`` bytes and each tile into
    ``STREAM_STEP`` pieces, its last ragged (``stream_copy.cuh``'s
    ``copy_piece``, one block a piece)."""
    return [(t + s, t + min(s + STREAM_STEP, tile))
            for t in range(0, n_bytes, tile)
            for s in range(0, tile, STREAM_STEP)]


def local_put_streamed(x: torch.Tensor, block_rows: int = 1024
                       ) -> torch.Tensor:
    """One-sided put streamed through on-chip memory (K8b): tiles of
    :func:`streamed_block_rows` rows cut into one block's pieces
    (:func:`streamed_pieces`), each thread's loads into registers all in
    flight before its stores.  A new tensor equal to ``x``."""
    rows = x.shape[0] if x.ndim else 0
    if rows == 0 or x.numel() == 0:
        return x
    if x.device.type == "cpu":
        return local_put_reference(x)
    _check(x, "local_put_streamed")
    rb = _row_bytes(x)
    br = streamed_block_rows(rows, rb, block_rows)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("local_put_streamed", x.data_ptr(), out.data_ptr(),
                rows // br, br * rb, _stream(x))
    local_put_streamed.launches += 1
    return out


def local_put_multi(x: torch.Tensor, chunks: int = 8) -> torch.Tensor:
    """One-sided put as ``chunks`` row slices all in flight (K8c) in one
    launch, each slice cut into :func:`multi_spans` of a block (and its
    own mbarriers) each; ``chunks`` shrinks to a divisor of the row
    count.  A new tensor equal to ``x``."""
    rows = x.shape[0] if x.ndim else 0
    if rows == 0 or x.numel() == 0:
        return x
    if x.device.type == "cpu":
        return local_put_reference(x)
    _check(x, "local_put_multi")
    chunks = _largest_divisor_at_most(rows, chunks)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("local_put_multi", x.data_ptr(), out.data_ptr(), chunks,
                rows // chunks * _row_bytes(x), _stream(x))
    local_put_multi.launches += 1
    return out


def local_put_inplace_reference(x: torch.Tensor, chunks: int = 8
                                ) -> torch.Tensor:
    """Plain K8d: each chunk's first ``half`` rows assigned to its last
    ``half`` rows, in ``x``, which is returned."""
    rows = x.shape[0]
    n_chunks, chunk_rows, half = _inplace_plan(rows, chunks)
    for i in range(n_chunks):
        lo = i * chunk_rows
        x[lo + chunk_rows - half: lo + chunk_rows] = x[lo: lo + half]
    return x


def local_put_inplace(x: torch.Tensor, chunks: int = 8) -> torch.Tensor:
    """One-sided put with the output aliased onto the input (K8d).

    MUTATES ``x`` and returns it: for each of :func:`_inplace_plan`'s
    chunks, its first ``half`` rows are copied into its last ``half``
    rows (disjoint regions, all chunks in flight, each half over its
    chunk's share of the SMs: :func:`inplace_spans`).  The reference aliases
    the same way (``input_output_aliases={0: 0}``).  Fewer than two rows
    leave nothing to copy: ``x`` comes back untouched."""
    rows = x.shape[0] if x.ndim else 0
    if rows < 2 or x.numel() == 0:
        return x
    if x.device.type == "cpu":
        return local_put_inplace_reference(x, chunks)
    _check(x, "local_put_inplace")
    n_chunks, chunk_rows, half = _inplace_plan(rows, chunks)
    rb = _row_bytes(x)
    with torch.cuda.device(x.device):
        _launch("local_put_inplace", x.data_ptr(), n_chunks,
                chunk_rows * rb, half * rb, (chunk_rows - half) * rb,
                _stream(x))
    local_put_inplace.launches += 1
    return x


def _ring_library() -> ctypes.CDLL:
    """The built K9 library with its C signatures declared."""
    from tpu_patterns_torch.kernels.build import load

    lib = load("ring_put")
    if lib.ring_put.argtypes is None:
        lib.ring_put.restype = ctypes.c_int
        lib.ring_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p]
        lib.ring_put_enable_peer.restype = ctypes.c_int
        lib.ring_put_enable_peer.argtypes = [ctypes.c_int]
        lib.ring_put_grid.restype = ctypes.c_longlong
        lib.ring_put_grid.argtypes = [ctypes.c_longlong]
    return lib


def _enable_peer(lib: ctypes.CDLL, src: torch.device, dst: torch.device
                 ) -> None:
    """Let ``src`` write ``dst``'s memory, or raise: the ring put never
    stages through the host."""
    if not torch.cuda.can_device_access_peer(src, dst):
        raise RuntimeError(f"ring_put: {src} cannot access {dst}'s memory "
                           "(no peer access)")
    with torch.cuda.device(src):
        rc = lib.ring_put_enable_peer(dst.index)
    if rc != 0:
        raise RuntimeError(f"ring_put: enabling peer access {src} -> {dst} "
                           f"failed: CUDA error {rc}")


def ring_put_reference(shards: list[torch.Tensor]) -> list[torch.Tensor]:
    """Plain K9: rank r's shard copied into a fresh buffer of rank
    (r + 1) % p, the ring shift."""
    return ring_shift(shards)


def ring_put(shards: list[torch.Tensor]) -> list[torch.Tensor]:
    """One ring-neighbour one-sided put (K9): for every rank r, a launch
    on r's device copies r's shard into a new output buffer owned by
    rank (r + 1) % p; returns the outputs in rank order.  The shards
    share one shape and dtype.  Between cards the sender must have peer
    access to the receiver (else this raises), and an event recorded
    after the launch orders the receiver's stream behind it; on one card
    stream order is the fence."""
    types = {s.device.type for s in shards}
    if types == {"cpu"}:
        return ring_put_reference(shards)
    if types != {"cuda"}:
        raise ValueError(f"ring_put: shards on {sorted(types)} together")
    first = shards[0]
    for s in shards:
        _check(s, "ring_put")
        if s.shape != first.shape or s.dtype != first.dtype:
            raise ValueError("ring_put: shards differ in shape or dtype")
    out = [torch.empty_like(s) for s in shards]
    n_bytes = first.numel() * first.element_size()
    if n_bytes == 0:
        return out
    lib = _ring_library()
    for src, dst in ring_perm(len(shards)):
        sdev, ddev = shards[src].device, out[dst].device
        stream = torch.cuda.current_stream(sdev)
        if ddev != sdev:
            _enable_peer(lib, sdev, ddev)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(ddev))
            stream.wait_event(ready)
        with torch.cuda.device(sdev):
            rc = lib.ring_put(shards[src].data_ptr(), out[dst].data_ptr(),
                              n_bytes, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ring_put kernel launch failed: CUDA error "
                               f"{rc}")
        ring_put.launches += 1
        if ddev != sdev:
            done = torch.cuda.Event()
            done.record(stream)
            torch.cuda.current_stream(ddev).wait_event(done)
    return out


PUT_WRAPPERS = ("local_put", "local_put_streamed", "local_put_multi",
                "local_put_inplace", "ring_put")
for _name in PUT_WRAPPERS:
    globals()[_name].launches = 0


def reset_launches() -> None:
    """Set every put wrapper's launch count to 0."""
    for name in PUT_WRAPPERS:
        globals()[name].launches = 0


def launch_counts() -> dict[str, int]:
    return {name: globals()[name].launches for name in PUT_WRAPPERS}


# -- the measured pattern ------------------------------------------------

# Tuned schedule defaults for this package, when a tune run on the card
# has written them; absent, the fallbacks 1024 and 8 apply.  The JAX
# package's tuned.json was measured on a TPU and is not read.
TUNED_PATH = os.path.join(os.path.dirname(__file__), "tuned.json")


def _load_tuned() -> dict:
    try:
        with open(TUNED_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


@dataclasses.dataclass
class OneSidedConfig:
    count: int = 1179648 * 40  # elements; the reference's message size
    dtype: str = "float32"
    reps: int = 10
    warmup: int = 2
    min_bandwidth: float = -1.0
    seed: int = 0
    # auto | streamed | multi | mono | xla | inplace (auto measures
    # streamed, multi, xla and, with >= 2 rows, inplace, and keeps the
    # fastest)
    kernel: str = "auto"
    # streamed: rows per tile; multi/inplace: chunks in
    # flight.  Resolved per instance from TUNED_PATH.
    block_rows: int | None = None
    chunks: int | None = None

    def __post_init__(self):
        if self.block_rows is None or self.chunks is None:
            tuned = _load_tuned()
            if self.block_rows is None:
                self.block_rows = tuned.get("block_rows", 1024)
            if self.chunks is None:
                self.chunks = tuned.get("chunks", 8)


def _puts(cfg: OneSidedConfig, rows: int):
    """name -> (put fn, expected-output fn, bytes-moved factor).  Each
    wrapper's name is looked up when the put runs, so a test can replace
    one."""
    roll_axis = 0 if rows > 1 else 1  # one row: roll by row is identity
    ip_chunks, ip_rows, ip_half = _inplace_plan(rows, cfg.chunks)
    return {
        "streamed": (lambda b: local_put_streamed(b, cfg.block_rows),
                     lambda a: a, 1.0),
        "multi": (lambda b: local_put_multi(b, cfg.chunks),
                  lambda a: a, 1.0),
        "mono": (lambda b: local_put(b), lambda a: a, 1.0),
        # the contrast: one library call, torch.roll by one row
        "xla": (lambda b: torch.roll(b, 1, roll_axis),
                lambda a: torch.roll(a, 1, roll_axis), 1.0),
        "inplace": (lambda b: local_put_inplace(b, cfg.chunks),
                    lambda a: local_put_inplace_reference(a.clone(),
                                                          cfg.chunks),
                    (ip_chunks * ip_half) / rows),
    }


def run_onesided(
    cfg: OneSidedConfig | None = None,
    writer: ResultWriter | None = None,
    device: torch.device | str | None = None,
    mesh: RankMesh | None = None,
) -> list[Record]:
    """One-sided put bandwidth.  Over a ``mesh`` of more than one rank,
    the reference's ``ring_put`` mode (:func:`_run_ring_put`).  Else on
    one device (``mesh``'s only rank, or ``device``), the ``local_put``
    mode: time each candidate schedule as a chain of dependent puts,
    keep the fastest plausible one, check its output against the
    expected one, and return one Record.

    Unlike the reference, a candidate that fails in auto mode raises: a
    kernel that does not build or launch must not vanish behind the
    winner."""
    cfg = cfg or OneSidedConfig()
    if cfg.kernel not in KERNELS:
        raise ValueError(
            f"unknown onesided kernel {cfg.kernel!r}; "
            "want auto|streamed|multi|mono|xla|inplace"
        )
    writer = writer or ResultWriter()
    if mesh is not None and mesh.size > 1:
        return _run_ring_put(cfg, writer, mesh)
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    spec = get_dtype(cfg.dtype)
    rows = max(1, cfg.count // COLS)
    count = rows * COLS
    shard_bytes = count * spec.itemsize
    mode = "local_put"
    x = verify.fill_randomly(count, cfg.dtype, cfg.seed, dev).reshape(
        rows, COLS)
    puts = _puts(cfg, rows)
    # fewer than two rows leave the in-place put nothing to copy: an
    # explicit request raises (a 0-byte put is no measurement), and auto
    # leaves it out
    if cfg.kernel == "inplace" and rows < 2:
        raise ValueError(
            f"kernel 'inplace' needs >= 2 rows (count >= 1024); "
            f"count={cfg.count} gives rows={rows}"
        )
    if cfg.kernel == "auto":
        names = ["streamed", "multi", "xla"] + (["inplace"] if rows >= 2
                                                else [])
    else:
        names = [cfg.kernel]
    timing.device_barrier(dev)
    writer.progress(
        f"onesided {mode}: {shard_bytes / 1e6:.2f} MB/put, "
        f"1 transfer(s), dtype={cfg.dtype}"
    )
    extra_metrics: dict[str, float] = {}
    notes: list[str] = []
    hbm_spec = chip_hbm_gbps(dev)
    best = None
    for name in names:
        put, want_fn, factor = puts[name]
        # the in-place put times on its own clone, made outside the
        # window, so that every candidate and the final check see x
        a = x.clone() if name == "inplace" else x
        kres = timing.measure_chain(
            lambda k, put=put, a=a: (
                lambda: timing.unrolled_chain(put, a, k)),
            reps=cfg.reps, warmup=cfg.warmup, device=dev,
            ops_per_iter=timing.CHAIN_UNROLL,
        )
        del a
        kgbps = kres.gbps(shard_bytes * factor)
        kplausible = None if hbm_spec is None else hbm_plausible(
            kgbps, hbm_spec)
        extra_metrics[f"bandwidth_GBps_{name}"] = kgbps
        extra_metrics[f"timing_converged_{name}"] = float(kres.converged)
        writer.progress(
            f"onesided local_put[{name}]: {kgbps:.1f} GB/s"
            + (" (traffic above HBM spec — not HBM)"
               if kplausible is False else "")
            + ("" if kres.converged else " (noise-bound)")
        )
        if kplausible is False:
            notes.append(
                f"kernel {name}: {kgbps:.0f} GB/s copy implies "
                f"{2 * kgbps:.0f} GB/s of HBM traffic, above the "
                f"{hbm_spec:.0f} GB/s spec — buffer resident in a "
                "faster tier"
            )

        # a plausible (or unchecked) schedule beats an implausible one,
        # a converged measurement a noise-bound one, then the rate
        def rank(plaus, res_, gbps_):
            return (plaus is not False, res_.converged, gbps_)

        if best is None or rank(kplausible, kres, kgbps) > rank(
            best[0], best[4], best[3]
        ):
            best = (kplausible, name, put, kgbps, kres, want_fn, factor)
    plausible, name, fn, gbps, res, want_fn, bytes_factor = best
    if len(names) > 1:
        notes.append(f"auto-selected kernel: {name}")

    # the winner's output on a fresh clone (the in-place put mutates)
    out = fn(x.clone())
    data_ok = bool(torch.equal(out, want_fn(x)))
    bw_ok = cfg.min_bandwidth < 0 or gbps >= cfg.min_bandwidth
    verdict = (
        Verdict.SUCCESS
        if (data_ok and bw_ok and plausible is not False)
        else Verdict.FAILURE
    )
    writer.metric(f"{mode} Bandwidth", gbps, "GB/s")
    rec = Record(
        pattern="onesided",
        mode=mode,
        commands=f"1dev x {shard_bytes // 1_000_000}MB",
        metrics={
            "bandwidth_GBps": gbps,
            "min_time_us": res.us(),
            "bytes_per_put": float(shard_bytes * bytes_factor),
            "checksum_ok": float(data_ok),
            "timing_converged": float(res.converged),
            **({} if plausible is None
               else {"hbm_plausible": float(plausible)}),
            **extra_metrics,
        },
        config={"device_kind": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "kernel": name, "block_rows": cfg.block_rows,
                "chunks": cfg.chunks},
        verdict=verdict,
    )
    rec.notes.extend(notes)
    if note := res.noise_note():
        rec.notes.append(note)
    if not data_ok:
        rec.notes.append("one-sided put data mismatch")
    if plausible is False:
        rec.notes.append(
            "measured copy rate implies HBM traffic above the chip's spec — "
            "the shrunken buffer never left a faster memory tier; grow "
            "count until the working set exceeds the L2 cache"
        )
    return [writer.record(rec)]


def _run_ring_put(cfg: OneSidedConfig, writer: ResultWriter,
                  mesh: RankMesh) -> list[Record]:
    """The reference's ``ring_put`` mode: the global fill of ``n x
    count`` elements split by rank, a chain of dependent ring puts timed
    on rank 0's stream (every card joined back to it), the bandwidth
    over all ``n`` puts of a ring step, and the output checked against
    the global buffer rolled by one shard.  No device-memory
    plausibility gate: with ranks on other cards the put crosses a
    link."""
    n = mesh.size
    spec = get_dtype(cfg.dtype)
    rows = max(1, cfg.count // COLS)
    count = rows * COLS
    shard_bytes = count * spec.itemsize
    dev = mesh.devices[0]
    x = verify.fill_randomly(n * count, cfg.dtype, cfg.seed, dev).reshape(
        n * rows, COLS)
    shards = mesh.scatter(x)
    for d in mesh.cards():
        timing.device_barrier(d)
    writer.progress(
        f"onesided ring_put: {shard_bytes / 1e6:.2f} MB/put, "
        f"{n} transfer(s), dtype={cfg.dtype}"
    )

    def build_chain(k: int):
        def run():
            timing.unrolled_chain(ring_put, shards, k)
            mesh.join()
        return run

    res = timing.measure_chain(build_chain, reps=cfg.reps, warmup=cfg.warmup,
                               device=dev, ops_per_iter=timing.CHAIN_UNROLL)
    gbps = res.gbps(shard_bytes * n)
    out = mesh.gather(ring_put(shards))
    data_ok = bool(torch.equal(out, torch.roll(x.cpu(), rows, 0)))
    bw_ok = cfg.min_bandwidth < 0 or gbps >= cfg.min_bandwidth
    writer.metric("ring_put Bandwidth", gbps, "GB/s")
    rec = Record(
        pattern="onesided",
        mode="ring_put",
        commands=f"{n}dev x {shard_bytes // 1_000_000}MB",
        metrics={
            "bandwidth_GBps": gbps,
            "min_time_us": res.us(),
            "bytes_per_put": float(shard_bytes),
            "checksum_ok": float(data_ok),
            "timing_converged": float(res.converged),
        },
        config={"device_kind": (torch.cuda.get_device_name(dev)
                                if mesh.on_cuda else "cpu"),
                "world": n},
        verdict=Verdict.SUCCESS if data_ok and bw_ok else Verdict.FAILURE,
    )
    if note := mesh.note("the puts"):
        rec.notes.append(note)
    if note := res.noise_note():
        rec.notes.append(note)
    if not data_ok:
        rec.notes.append("one-sided put data mismatch")
    return [writer.record(rec)]
