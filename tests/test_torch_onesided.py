"""The port's one-sided put (K8a-K8d, ``run_onesided``) against the JAX
package's.

The same numpy inputs go through the reference's Pallas put kernels in
interpret mode (as tests/test_onesided.py runs them on the CPU) and the
port's wrappers on CPU tensors, which run the plain torch versions of
the CUDA kernels.  A put copies, so every comparison is exact.  The
Records of both packages' ``run_onesided`` are compared on the same
fill (the reference's, handed over as numpy); bandwidths are
measurements and are not compared."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns import cli as jcli
from tpu_patterns.comm import dtypes as jdtypes
from tpu_patterns.comm import onesided as jo
from tpu_patterns.comm import verify as jverify
from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm import dtypes as tdtypes
from tpu_patterns_torch.comm import onesided as to
from tpu_patterns_torch.comm import verify as tverify
from tpu_patterns_torch.convert import fill_from_numpy
from tpu_patterns_torch.core.results import ResultWriter as TWriter
from tpu_patterns_torch.core.results import Verdict

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


def _input(shape, dtype=np.float32, seed=0):
    n = int(np.prod(shape))
    return np.random.RandomState(seed).permutation(max(n, 1))[:n] \
        .astype(dtype).reshape(shape)


def _both(fn_ref, fn_port, a):
    want = np.asarray(fn_ref(jnp.asarray(a)))
    got = fn_port(fill_from_numpy(a)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(4, 128), (7, 256), (6, 100)])
def test_local_put_matches_reference(shape):
    _both(lambda x: jo.local_put(x, interpret=True), to.local_put,
          _input(shape))


@pytest.mark.parametrize("shape,block_rows,dtype", [
    ((6, 256), 4, np.float32),    # block shrinks to the divisor 3
    ((7, 256), 4, np.float32),    # prime rows
    ((97, 37), 8, np.int8),       # prime rows, 37-byte rows
    ((97, 37), 1, np.float32),    # a block a row: 148-byte tiles
    ((300, 1001), 1024, np.int8),  # one tile of 300,300 bytes
    ((16, 100), 1024, np.float32),  # trailing dim not a multiple of 128
    ((16, 3, 37), 1024, np.int32),
    ((4096,), 1024, np.float32),
    ((0, 128), 1024, np.float32),
    ((8, 0), 1024, np.float32),
])
def test_local_put_streamed_matches_reference(shape, block_rows, dtype):
    _both(lambda x: jo.local_put_streamed(x, block_rows=block_rows,
                                          interpret=True),
          lambda t: to.local_put_streamed(t, block_rows=block_rows),
          _input(shape, dtype))


@pytest.mark.parametrize("shape,chunks", [
    ((16, 256), 8),  # exact tiling
    ((6, 256), 4),   # shrinks to 3 chunks
    ((7, 256), 4),   # prime rows: one chunk
    ((2, 128), 8),   # more chunks than rows
    ((4, 128), 1),
    ((0, 128), 8),
])
def test_local_put_multi_matches_reference(shape, chunks):
    _both(lambda x: jo.local_put_multi(x, chunks=chunks, interpret=True),
          lambda t: to.local_put_multi(t, chunks=chunks), _input(shape))


@pytest.mark.parametrize("shape,chunks,dtype", [
    ((16, 256), 8, np.float32), ((6, 256), 4, np.float32),
    ((7, 256), 4, np.float32), ((2, 128), 8, np.float32),
    ((4, 128), 1, np.float32), ((1, 128), 8, np.float32),
    ((97, 37), 8, np.int8),
])
def test_local_put_inplace_matches_reference(shape, chunks, dtype):
    a = _input(shape, dtype)
    t = fill_from_numpy(a)
    got = to.local_put_inplace(t, chunks=chunks)
    assert got is t  # aliased: the input itself, mutated
    want = jo.local_put_inplace(jnp.asarray(a), chunks=chunks,
                                interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises."""
    x = torch.empty((4, 128), device="meta")
    for call in (to.local_put, to.local_put_streamed, to.local_put_multi,
                 to.local_put_inplace):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call(x)


def test_plans_match_reference():
    for rows in (1, 2, 3, 6, 7, 16, 97, 92160):
        for k in (1, 2, 4, 8, 64, 1024):
            assert to._largest_divisor_at_most(rows, k) == \
                jo._largest_divisor_at_most(rows, k)
            assert to._inplace_plan(rows, k) == jo._inplace_plan(rows, k)
    for gbps, spec in ((335.6, 819.0), (103523.6, 819.0), (475.0, 819.0),
                       (12345.0, None), (1926.0, 3350.0), (1927.0, 3350.0)):
        assert to.hbm_plausible(gbps, spec) == jo.hbm_plausible(gbps, spec)


def test_streamed_tile_fits_one_stage():
    """The full-size tile: 92,160 x 512 float32 rows of 2 KB give 48 rows
    (96 KB) per stage, a divisor of the rows; a row longer than a stage
    takes one row per tile."""
    assert to.streamed_block_rows(92160, 2048, 1024) == 48
    for rows, rb, br in ((92160, 2048, 1024), (97, 37, 8), (6, 1024, 4),
                         (4, 8 << 20, 1024)):
        got = to.streamed_block_rows(rows, rb, br)
        assert rows % got == 0 and got <= br
        assert got == 1 or got * rb <= to.STAGE_BYTES


@pytest.mark.parametrize("block_rows", [1, 4, 1024])
@pytest.mark.parametrize("rows,row_bytes", [
    (92160, 512 * 4), (97, 37 * 4), (97, 37), (300, 1001 * 4),
    (16, 100 * 4), (4, 40_000 * 4),
])
def test_streamed_pieces_cover_the_buffer_once(rows, row_bytes, block_rows):
    """K8b's grid (``streamed_pieces``, the mirror chip_smoke.py holds to
    the C side's ``local_put_streamed_grid``): each tile of
    ``streamed_block_rows`` rows cut into ``STREAM_STEP`` pieces, one
    block a piece, the blocks disjoint and in order, covering every byte
    of the rows x row_bytes buffer exactly once, no piece crossing a
    tile's end.  The reference's message (92,160 x 512 float32) at
    block_rows 1024 takes 1,920 tiles of 48 rows (96 KB), 11,520 blocks
    of 16 KB; a 160,000-byte row is a tile of ten pieces, the last
    ragged."""
    pieces = to.streamed_pieces(rows, row_bytes, block_rows)
    tile = to.streamed_block_rows(rows, row_bytes, block_rows) * row_bytes
    per = -(-tile // to.STREAM_STEP)
    assert len(pieces) == rows * row_bytes // tile * per
    pos = 0
    for i, (start, stop) in enumerate(pieces):
        assert start == pos and 0 < stop - start <= to.STREAM_STEP
        assert start // tile == (stop - 1) // tile  # inside one tile
        assert start % tile == i % per * to.STREAM_STEP
        pos = stop
    assert pos == rows * row_bytes
    if (rows, row_bytes, block_rows) == (92160, 2048, 1024):
        assert tile == 48 * 2048 and len(pieces) == 11520
        assert all(stop - start == 16384 for start, stop in pieces)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 188_743_680, 1_000_003])
def test_mono_plan_spans_cover_once_aligned_and_balanced(n):
    """K8a's plan on an H100 (132 SMs): one span per block that covers
    [0, n) exactly once, every span but the last starting 16-byte
    aligned, at most one block per SM, and no two spans differing by
    more than one stage (the kernel's stage: the span rounded up to 16
    bytes, at most STAGE_BYTES).  188,743,680 bytes is the reference's
    message; 1,000,003 is prime."""
    sms = 132
    spans = to.mono_spans(n, sms)
    assert len(spans) <= sms
    pos = 0
    for start, stop in spans:
        assert start == pos and stop > start
        pos = stop
    assert pos == n
    assert all(start % 16 == 0 for start, _ in spans[:-1])
    if spans:
        lens = [stop - start for start, stop in spans]
        stage = min(-(-lens[0] // 16) * 16, to.STAGE_BYTES)
        assert max(lens) - min(lens) <= stage
    if n == 188_743_680:  # the full put takes every SM
        assert len(spans) == sms


@pytest.mark.parametrize("name", sorted(jdtypes.DTYPES))
def test_dtypes_match_reference(name):
    want, got = jdtypes.get_dtype(name), tdtypes.get_dtype(name)
    assert (got.itemsize, got.exact_modulus) == (want.itemsize,
                                                 want.exact_modulus)
    assert tdtypes.dtype_name(got.canonical) == np.dtype(want.canonical).name


@pytest.mark.parametrize("n,dtype", [
    (0, "float32"), (1, "int8"), (1000, "bool"), (5000, "bfloat16"),
    (300000, "int8"), (47185920, "float32"), (123457, "int32"),
    (70000, "uint8"), (99, "float16"),
])
def test_expected_checksum_matches_reference(n, dtype):
    assert tverify.expected_checksum(n, dtype) == \
        jverify.expected_checksum(n, dtype)


@pytest.mark.parametrize("n,dtype", [
    (1000, "float32"), (4096, "bfloat16"), (3000, "int8"), (999, "bool"),
    (200000, "int32"),  # the sum wraps int32
    (70000, "uint32"),
])
def test_port_fill_passes_checksum(n, dtype):
    x = tverify.fill_randomly(n, dtype, seed=3)
    assert x.dtype == tdtypes.get_dtype(dtype).canonical and x.numel() == n
    assert tverify.checksum_ok(x)
    ref = np.asarray(jverify.fill_randomly(n, dtype, 3))
    assert tverify.checksum_ok(fill_from_numpy(ref), n, dtype)
    bad = x.clone()
    bad[0] = bad[1]  # a duplicated element
    assert bool((bad != x).any()) == (not tverify.checksum_ok(bad))


def _ref_record(cfg_kw):
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    rec, = jo.run_onesided(mesh, jo.OneSidedConfig(**cfg_kw),
                           JWriter(stream=io.StringIO()))
    return rec


def _notes(rec, names):
    """Notes up to the measurements: the winner of auto mode and the
    port's noise-bound note depend on timing."""
    out = []
    for n in rec.notes:
        if n.startswith("auto-selected kernel: "):
            assert n.split(": ")[1] in names
            n = "auto-selected kernel: *"
        if "noise-bound" in n:
            continue
        out.append(n)
    return out


@pytest.mark.parametrize("kernel",
                         ["auto", "streamed", "multi", "mono", "xla",
                          "inplace"])
def test_run_onesided_record_matches_reference(kernel, monkeypatch):
    kw = dict(count=2048, reps=2, warmup=1, kernel=kernel, block_rows=2,
              chunks=3)
    ref = _ref_record(kw)
    fill = np.asarray(jverify.fill_randomly(2048, "float32", 0))
    monkeypatch.setattr(tverify, "fill_randomly",
                        lambda n, dtype, seed, device: fill_from_numpy(
                            fill, device))
    rec, = to.run_onesided(to.OneSidedConfig(**kw),
                           TWriter(stream=io.StringIO()), device="cpu")
    names = ["streamed", "multi", "xla", "inplace"]
    assert (rec.pattern, rec.mode, rec.commands, rec.verdict.value) == (
        ref.pattern, ref.mode, ref.commands, ref.verdict.value)
    assert rec.verdict is Verdict.SUCCESS, rec.notes
    assert set(rec.metrics) == set(ref.metrics)
    if kernel == "auto":
        # each package's auto picks its winner by timing, so the bytes a
        # put moves (inplace moves half) are held to the reference's
        # Record for the kernel the port picked
        won, = [n.split(": ")[1] for n in rec.notes
                if n.startswith("auto-selected kernel: ")]
        ref_won = _ref_record(dict(kw, kernel=won))
        assert rec.metrics["bytes_per_put"] == ref_won.metrics["bytes_per_put"]
    else:
        assert rec.metrics["bytes_per_put"] == ref.metrics["bytes_per_put"]
    assert rec.metrics["checksum_ok"] == ref.metrics["checksum_ok"]
    assert _notes(rec, names) == _notes(ref, names)
    assert all(v > 0 for k, v in rec.metrics.items()
               if k.startswith("bandwidth_GBps"))


def test_run_onesided_inplace_needs_two_rows():
    with pytest.raises(ValueError, match="inplace"):
        to.run_onesided(to.OneSidedConfig(count=512, reps=1,
                                          kernel="inplace"),
                        TWriter(stream=io.StringIO()), device="cpu")
    rec, = to.run_onesided(to.OneSidedConfig(count=512, reps=2, warmup=1),
                           TWriter(stream=io.StringIO()), device="cpu")
    ref = _ref_record(dict(count=512, reps=2, warmup=1))
    assert rec.verdict is Verdict.SUCCESS, rec.notes
    assert "bandwidth_GBps_inplace" not in rec.metrics
    assert set(rec.metrics) == set(ref.metrics)


def test_run_onesided_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown onesided kernel"):
        to.run_onesided(to.OneSidedConfig(count=2048, kernel="bogus"),
                        device="cpu")


@pytest.mark.parametrize("kernel", ["auto", "multi"])
def test_a_broken_candidate_raises(kernel, monkeypatch):
    """Unlike the reference's auto mode, which notes a failing candidate
    and goes on (tests/test_onesided.py:189), the port's raises: a
    kernel that fails to build or launch must not hide behind the
    winner."""
    def boom(x, chunks=8):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(to, "local_put_multi", boom)
    with pytest.raises(RuntimeError, match="launch refused"):
        to.run_onesided(to.OneSidedConfig(count=2048, reps=1, kernel=kernel),
                        TWriter(stream=io.StringIO()), device="cpu")


def test_hbm_gate_fails_an_implausible_rate(monkeypatch):
    """With a spec no copy stays under, every candidate is flagged and
    the verdict is FAILURE, as in the reference."""
    monkeypatch.setattr(to, "chip_hbm_gbps", lambda dev: 1e-9)
    rec, = to.run_onesided(to.OneSidedConfig(count=2048, reps=2, warmup=1),
                           TWriter(stream=io.StringIO()), device="cpu")
    assert rec.verdict is Verdict.FAILURE
    assert rec.metrics["hbm_plausible"] == 0.0
    assert any("faster tier" in n for n in rec.notes)


def test_tuned_defaults(tmp_path, monkeypatch):
    monkeypatch.setattr(to, "TUNED_PATH", str(tmp_path / "none.json"))
    cfg = to.OneSidedConfig()
    assert (cfg.block_rows, cfg.chunks) == (1024, 8)
    (tmp_path / "t.json").write_text('{"block_rows": 77, "chunks": 5}')
    monkeypatch.setattr(to, "TUNED_PATH", str(tmp_path / "t.json"))
    assert (to.OneSidedConfig().block_rows, to.OneSidedConfig().chunks) == (
        77, 5)
    assert to.OneSidedConfig(block_rows=3).block_rows == 3


def test_p2p_cli_matches_reference_flags(capsys):
    """``--put-kernel`` takes the reference's choices, which are the
    library's; one_sided on the CPU writes a SUCCESS Record; two_sided
    on one device writes the reference's SKIPPED Record."""
    ref = next(a for a in jcli.build_parser()._subparsers._group_actions[0]
               .choices["p2p"]._actions if a.dest == "put_kernel")
    port = next(a for a in tcli.build_parser()._subparsers._group_actions[0]
                .choices["p2p"]._actions if a.dest == "put_kernel")
    assert tuple(port.choices) == tuple(ref.choices) == to.KERNELS
    assert tcli.main(["p2p", "--transport", "one_sided", "--device", "cpu",
                      "--count", "2048", "--reps", "2", "--warmup", "1",
                      "--put-kernel", "inplace", "--chunks", "2"]) == 0
    assert "## local_put | 1dev x 0MB | SUCCESS" in capsys.readouterr().out
    assert tcli.main(["p2p", "--device", "cpu"]) == 0
    assert "## two_sided | devices=1 | SKIPPED" in capsys.readouterr().out


@pytest.mark.parametrize("chunk_bytes,chunks", [
    (188_743_680 // 8, 8), (1, 1), (15, 3), (16, 200), (1_000_003, 8),
    (188_743_680 // 3, 3), (4096, 132), (300 * 1001, 7),
])
def test_multi_plan_spans_cover_each_chunk_once_and_aligned(chunk_bytes,
                                                            chunks):
    """K8c's plan on an H100 (132 SMs): each chunk's spans cover it
    exactly once, in order; every span but each chunk's last starts
    16-byte aligned within its chunk; no two spans of a chunk differ by
    more than one stage; at most max(chunks, 132) blocks in all.  The
    reference's message in 8 chunks takes 128 blocks."""
    sms = 132
    spans = to.multi_spans(chunk_bytes, chunks, sms)
    assert len(spans) <= max(chunks, sms)
    per = len(spans) // chunks
    assert per * chunks == len(spans)
    for c in range(chunks):
        mine = spans[c * per:(c + 1) * per]
        pos = c * chunk_bytes
        for start, stop in mine:
            assert start == pos and stop > start
            pos = stop
        assert pos == (c + 1) * chunk_bytes
        assert all((start - c * chunk_bytes) % 16 == 0
                   for start, _ in mine[:-1])
        lens = [stop - start for start, stop in mine]
        stage = min(-(-lens[0] // 16) * 16, to.STAGE_BYTES)
        assert max(lens) - min(lens) <= stage
    span = to.multi_span(chunk_bytes, chunks, sms)
    assert span == to.mono_span(chunk_bytes, max(1, sms // chunks))
    if (chunk_bytes, chunks) == (188_743_680 // 8, 8):
        assert len(spans) == 128


@pytest.mark.parametrize("rows,row_bytes,chunks", [
    (92160, 512 * 4, 8), (2, 512 * 4, 8), (3, 512 * 4, 8), (97, 512 * 4, 8),
    (5, 100 * 4, 8), (7, 37 * 4, 200), (300, 1001 * 4, 3), (97, 512, 8),
    (16, 100 * 4, 1), (1001, 37, 3),
])
def test_inplace_plan_spans_cover_each_half_once_and_disjoint(rows,
                                                              row_bytes,
                                                              chunks):
    """K8d's plan on an H100 (132 SMs): for each of ``_inplace_plan``'s
    chunks, its spans cover the chunk's first ``half`` rows exactly
    once, in order; each span is written ``shift`` bytes further on,
    inside the chunk's last ``half`` rows; no destination span overlaps
    any source span (the put is in place, with every block in flight);
    every span but a chunk's last starts 16-byte aligned within its
    chunk.  The reference's message (92,160 x 512 float32) in 8 chunks
    takes 128 blocks.  Row widths of 37 and 1001 float32 and int8 rows
    give chunks whose bytes are no multiple of 16."""
    sms = 132
    spans = to.inplace_spans(rows, row_bytes, chunks, sms)
    n_chunks, chunk_rows, half = to._inplace_plan(rows, chunks)
    chunk, half_bytes = chunk_rows * row_bytes, half * row_bytes
    shift = (chunk_rows - half) * row_bytes
    span = to.multi_span(half_bytes, n_chunks, sms)
    per = -(-half_bytes // span)
    assert len(spans) == n_chunks * per
    for c in range(n_chunks):
        mine = spans[c * per:(c + 1) * per]
        pos = c * chunk
        for src, dst, stop in mine:
            assert src == pos and stop > src
            assert dst == src + shift
            assert c * chunk + chunk - half_bytes <= dst
            assert dst + (stop - src) <= (c + 1) * chunk
            pos = stop
        assert pos == c * chunk + half_bytes
        assert all((src - c * chunk) % 16 == 0 for src, _, _ in mine[:-1])
    srcs = sorted((s, e) for s, _, e in spans)
    for src, dst, stop in spans:
        end = dst + stop - src
        assert not any(s < end and dst < e for s, e in srcs)
    if (rows, row_bytes, chunks) == (92160, 512 * 4, 8):
        assert len(spans) == 128
