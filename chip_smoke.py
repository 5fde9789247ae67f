#!/usr/bin/env python3
"""Chip smoke of tpu_patterns_torch on one CUDA card (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  ``python3 chip_smoke.py --tree TREE
[PHASE ...]`` instead runs only the named timing phases of
:data:`TREE_PHASES` with the package of the checkout at TREE, to compare
two trees in one call (:func:`tree_main`).  It imports nothing of JAX or
of the
JAX package, and fails (nonzero exit, no result line) without a CUDA
device or away from the repository.  It drives the ported paths: the
serve path (slice A), the flagship train step and the resumable train
loop with its checkpoints (slice B), the one-device
one-sided put (slice C), the concurrency suite (slice D), the ring
(the allreduce miniapp and the ring put over a rank mesh of four ranks
on the one card), the interop slice (the native C++ module and the
kernel whose output it reads in place), the rest of the P2P suite
(topology, placement, the pair exchange, the hierarchical allreduce and
the environment tier of the CLI), the load generator over the serve
path (seeded sampling, SLO Records, chaos under load), the
long-context ``decode`` pattern and the token LM's ``lm`` (no kernel on
their path), the serve engine's kv tier, priority preemption and
snapshots, its recovery path with the obs plane that records it, the
diagnostics (``doctor``, the profile reader, ``profilecheck``) and the
perf observatory (``perf``), sequence parallelism (ring attention
and Ulysses over a rank mesh of four ranks on the one card, through the
flash kernels), and the parallelism patterns (the collective matmul,
the GPipe and 1F1B pipelines, top-1 MoE dispatch and the ZeRO step over
rank meshes on the one card; no kernel on their path), the model train
step across ranks, ``decode`` and ``lm`` across ranks (no kernel on
their path), the sharded serve path, the replica fleet and its
disaggregated prefill/decode split.
Phases, each one or more printed lines:

1. device and toolchain: torch/CUDA versions, ``nvcc --version``, and the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: every kernel compiled from the checkout's sources with nvcc,
   one process per source, all at once; then the ``kernel_build`` line:
   each instance of the redesigned kernels (the bf16 wgmma forward of
   K2/K3 and its register-tiled f32 forward, the bf16 wgmma backward of
   K4, dq and dk/dv, and its register-tiled f32 backward, the all-SM mono,
   multi and in-place puts K8a, K8c and K8d, the register-streamed puts
   K8b and K9, the split-page K1, the streaming adds K5 and K10) with its
   registers,
   spills, static and dynamic shared memory from ``-Xptxas -v`` and
   whether ptxas serialized its wgmma products (a bf16 backward instance
   that spills or is serialized, or an f32 forward or backward instance
   that spills, fails);
3. K1 vs plain: the split-page paged-attention kernel against its plain
   torch version on the card, for f32, bf16 and int8 pools, W=1, W=4
   and W=5 (the verify step of spec_k 4), G=1 and G=4, ragged pos0,
   TRASH pages, an inactive and an all-TRASH row, at a small shape and
   at the serve slice's shape (with int8 at W=4 and G=4, split edges: a
   row whose window ends inside the first split, a split whose pages are
   all TRASH between live ones, and the verify cases at W=5, G=1 and
   G=4, bf16 and int8, with an inactive row and a row whose last lanes
   lie past its table; the shared memory of the G x W = 20 block is
   reported), the slice's cases again in splits of several stages, and a
   long window (32 rows at the end of 4096-token windows, bf16); at the
   slice's shape and the long window the kernel's, the plain version's,
   one SDPA call's (``scaled_dot_product_attention`` on the gathered
   window, the kernel table's yardstick) and the gather from the block
   tables plus that SDPA call's times (each the median of 5 readings
   of 20 calls, L2 flushed; the library calls are yardsticks the
   package never makes) beside the device-memory bound;
4. flash vs plain: K2 (``flash_attention``), K3 (``flash_block``) and
   K4 (``flash_block_bwd``: the dq and the dk/dv kernel) against their
   plain versions: causal and not, f32 and bf16, D 64 and 128, shard
   offsets (0,0,1), (16,32,1), (2,5,8), Lq != Lk, wholly masked rows,
   and the flagship's shape (32 folded heads x 4096 x 128, bf16,
   causal), where two runs must also agree bit for bit (so must two f32
   runs of K2, K3 and K4 at L4096 x 8 x 128, causal) and the tile model
   must equal the kernels' own shared-memory sizes (the bf16 forward and
   backward at the flagship's tiles, the f32 forward and backward at
   each of their tiles, D 64 and 128); the bf16 kernels also at lengths
   that are no multiple of their tile (K3, K2 and K4, Lq/Lk 100/200,
   130/130, 40/72; K4 also at its two-warpgroup tiles for D 64,
   256/384), and the f32 kernels (K3, K2, K4) at those lengths too (K3
   and K4 also with the first half of the rows seeing no key, where
   K4's dq must be exactly zero), and at 64 heads (their 64-entry
   units), ragged, at an offset and a stride; then each
   flash kernel's time at that shape (L2 flushed) beside its plain
   version's, one SDPA call's (forward for K2/K3, its backward for K4)
   and its bound (bytes over 3.35 TB/s or visible-key flops over 989
   TFLOP/s), the forward at every tile pair its bf16 kernel takes and
   each bf16 backward kernel at each of its pairs;
5. serve at full width in bf16 (embed 1024, 8 heads x 128, depth 4,
   vocab 2048): 16 requests, prompts 64-512, 64 generated tokens, 8
   slots, block_len 16, attention through K1; continuous and sequential
   tokens/s, K1's launches during the timed continuous run (which must
   be depth x its decode steps), the pool against the dense rectangle
   and in place, peak device memory; ids against the dense oracle as a
   report (a flip only where the oracle's top-2 margin is below bf16
   resolution); then the device's busy and idle share of the continuous
   run, from torch.profiler.  The legs after it run at depth 2 with 8
   requests (``SERVE_LEG_CUT``, the serve model's depth and requests
   halved).  A second leg serves 2 K/V heads and an int8 pool.  The spec leg
   decodes the repetitive trace
   with spec_k 4 beside plain decode (tokens/s of each, accepted tokens
   per row-step > 1.0, K1 launched depth x verify steps times in the
   timed run and at W = 5 in one more run, no leaked block); the
   prefix leg serves the shared trace (384 of 512 prompt tokens shared)
   with sharing and without (peak blocks, CoW copies, prefix hits, no
   leaked block, K1 launched depth x steps times); both with the oracle
   gate of the main leg;
6. serve exactness at full width (depth 2, 8 requests, ``SERVE_LEG_CUT``) in
   float32 with TF32 off: ``run_serve`` with spec_k 4 and prefix
   sharing: its main,
   ``prefix_share_*`` and ``spec_decode_*`` Records, each SUCCESS with
   ids equal to the dense oracle's;
7. the flagship train step at its full default width (bf16, batch 4,
   seq 4096, embed 1024, 8 heads x 128, causal, attention through the
   flash kernels): ``run_flagship``'s Record must read SUCCESS, and K3,
   dq and dk/dv each launch depth x its train steps times and K2 never;
   then the same config with dense attention for contrast; then one
   step under torch.profiler: device busy and idle share and each flash
   kernel's share of busy time;
8. flagship exactness at full width in float32 with TF32 off: one train
   step through the kernels against the same step through
   ``attention_reference`` (loss and every parameter's update), and one
   ``forward_shard`` under ``torch.no_grad``, which launches K2 once
   and matches the dense forward;
8b. the resumable train loop (``models/train_loop.py::train``) at the
   flagship's width and the serve model's depth 4 (bf16, causal, kernel
   attention, lr 1e-4), in a directory under ``build/`` removed after:
   8 steps with a checkpoint every 2 (keep 2) and a ``train_step``
   Record every 2, SUCCESS with 4 such Records, K3, dq and dk/dv each
   launched 4 x 8 times and K2 never (counts set to 0 just before);
   the same 8 steps with no checkpoint (the loop's rate, equal bit for
   bit); killed after 4 steps and resumed to 8 with the async saver
   (start 4, loss and every parameter's bytes equal to the straight
   run's); native data (the C++ loader) for 4 steps against killed at
   2 and resumed (bitwise equal); a NaN injected at step 2
   (``faults.configure``, checked every step), which halts with a
   FAILURE Record and a ``nonfinite`` WARNING, step 2 the only
   committed step; and ``python -m tpu_patterns_torch ckpt DIR
   --leaves`` on the straight run's directory (steps 6 and 8, 5 leaves
   each); each leg's steps/s, tokens/s and model TFLOP/s beside
   ``run_flagship``'s step_ms at depth 1;
9. the one-sided put: K8a's, K8c's and K8d's spans on this card and
   K8b's grid against their Python mirrors (``onesided.mono_span``,
   ``onesided.multi_span``, ``onesided.inplace_spans``,
   ``onesided.streamed_pieces``; K8c and K8d take 8 x (SMs // 8)
   blocks at the full buffer in 8 chunks, K8b one block a 16 KB piece of
   a tile); the
   four put kernels K8a-K8d
   against their plain versions, bit for bit, on float32, bfloat16,
   int32 and int8 at edge shapes (0, 1, 2 and 97 rows, chunks above the
   row count, trailing
   dimensions of 100, 37 and 1001 elements, inputs one element into a
   buffer)
   and at the full 92,160 x 512 float32 buffer; each kernel's time there
   beside its plain version's, one ``copy_`` call's (K8d: one strided
   ``copy_`` of the chunk halves) and its byte bound, each the median of
   5 readings, and each kernel's and library call's device time with no
   host gaps (calls queued behind a busy-wait);
   then ``run_onesided`` at the reference's message size in auto mode
   (SUCCESS, checksum and plausibility gates, the launches of streamed,
   multi and inplace) and with ``kernel="mono"``, and the ``p2p`` CLI;
10. the concurrency suite: the busy-wait kernel K6 against its plain
    version bit for bit (rows 1, 3, 8, 9, 64 at 0-4000 trips), the
    copy-and-compute kernel K7 likewise in
    both modes ("C", "D2D", "C D2D", "D2D D2D C C"; copies of 128, 4224,
    4,194,304 and 33,554,432 elements, computes of 8 and 64 rows at 0, 3
    and 100 trips); S buffers checked to be managed memory;
    ``run_concurrency`` at the defaults (xla concurrent "C C" SUCCESS
    with K6 launched; xla serial "C C" and both serial modes held to at
    least 0.6 x the sum of their solos; "C H2D", "C S2D" and the
    dispatch modes on "M2D D2M" and "H2D D2H"; pallas "C D2D" in both
    modes with K7 launched; the balanced leg, 128 MiB copies against 400
    trips raised by auto-tune, dma_overlap SUCCESS), the xla concurrent
    and the pallas dma_overlap run again under torch.profiler, in a
    process of their own, for the device's idle share, and the
    ``concurrency`` CLI, default and
    balanced; then K6 at the default 8 x 128 and 40,000 trips and K7 at
    every pallas run's tuned commands, in both modes, bit for bit
    against their plain versions (the plain busy-waits of one tripcount
    run once, over their inputs stacked); K6's time at the
    defaults and K7's at the tuned commands of the run whose launches
    are reported, beside their bounds, K6's FMA chain floor, K7's
    copy-only launch beside one ``copy_`` and the host's time per K7
    launch; and the balanced shape's copy-only, compute-only and mixed
    launches queued with no host gaps, the device's own overlap;
11. the ring: K5's grid as the C side computes it against its Python
    mirror (``pallas.tile_grid``); the accumulate kernel K5 against its
    plain version on the same tensors, bit for bit (float32 and int32;
    n = 1, 127, 4097, 2^23,
    2^25; operands one element into a buffer; pinned host and managed
    inputs, where K5 must launch and its output stay in their memory);
    K5's time at 2^25 and 2^23 beside its plain version's, one
    ``torch.add(out=)`` call's and its byte bound (each the median of 5
    readings of 20 calls, with their min and max, the host's time per
    call in them), and K5's and ``torch.add``'s device time with no host
    gaps and the host's us per call (calls queued behind a busy-wait);
    ``run_allreduce`` at
    the defaults (2^25 elements a rank, 4 ranks on the card, reps 5):
    xla ring, ring_opt and psum at float32, ring at int32 and bfloat16,
    pallas ring and ring_opt at float32, ring at int32 and at float32 in
    pinned host (H) and managed (S) memory, each SUCCESS, K5 launched
    (p-1) x p times per allreduce in every pallas run (its count set to
    0 just before each); the pallas ring and ring_opt on random float32,
    through K5 and through the plain accumulate, bit for bit; the ring
    put kernel K9's grid against its Python mirror
    (``onesided.ring_put_pieces``), and K9 against its plain version (the
    ring shift) at worlds 2, 4 and 8, float32 and bfloat16, 1, 97 and
    2048 rows and misaligned shards; K9's time per launch at 92,160 x
    512 float32 beside its plain version's, one ``copy_``'s and its
    bound, and K9's and ``copy_``'s device time with no host gaps;
    ``run_onesided`` over 4 ranks at the reference's message size
    (SUCCESS, checksum, 4 K9 launches per ring put); the ``allreduce``, ``miniapps`` and ``p2p
    --devices 4`` commands; the pallas ring's device idle share comes
    from the profiling process of phase 10;
12. interop: the native module built from the checkout with g++ (the
    compiler's version, the seconds of a build from scratch, the
    library the port loads); K10's grid as the C side computes it
    against its Python mirror (``kernel.tile_grid``); the kernel K10
    (``add_one``, x + 1) against its plain version on the same tensors,
    bit for bit, at (4, 128), 1, 3, 127, 4097, 2^25 and 2^25 + 3
    elements, input, output or both one element into a buffer, on
    +-0, +-inf and subnormals, and in managed memory, each call
    launching K10; the typed ops refusing a CUDA tensor; the zero-copy
    proof, the slice's main path (K10's count set to 0 just before):
    K10 writes into managed memory, which the C++ checksum reads in
    place after a synchronize (512 for (4, 128) zeros,
    ``expected_checksum(n) + n`` for ``fill_randomly(2^20)``), and K10's
    output in device memory reaches the C++ through
    ``offload_checksum`` (pinned staging) and ``host_checksum`` inside
    a ``torch.compile``d program (512 each), 4 K10 launches;
    ``python -m tpu_patterns_torch interop --device cuda`` (7 Records,
    modes native and offload:gpu, all SUCCESS, exit 0); K10's time at
    (4, 128) and 2^25 (L2 flushed, median of 5 readings) beside its
    plain version's, one ``torch.add(x, 1.0, out=)`` call's and its
    byte bound, and K10's and that call's device time with no host gaps;
    then the ``redesign`` line: K3's, K2's, K4's (dq, dk/dv), K8a's,
    K1's, K8c's, K8d's, K5's (2^23, 2^25), K8b's, K9's and K10's ms
    beside their times before the redesign (PERF.md's 4.485, 4.539,
    4.925, 6.599, 4.023, 0.1593, 0.5195, 0.2632, 0.04396, 0.1410,
    0.1381, 0.1372 and 0.09865 ms), their library call's and their
    bound;
13. the P2P suite (no TPU kernel on its path: the pair exchange and the
    hierarchical allreduce are torch copies and adds, as the reference's
    are XLA collectives), each CLI run in this process: ``topo`` (one
    device, ``gpu``, plane [0], one order in every placement mode, one
    group) and ``topo 0``; ``run_p2p`` at the reference's 1,179,648 x 40
    float32 (188.74 MB a pair) over 2 and 4 ranks on the card, uni and
    bidirectional, each Record SUCCESS with ``checksum_ok`` 1 and twice
    its rate at most 1.15 x 3350 GB/s, each receiver's output in storage
    apart from every input's; the six placement x mechanism pairs of
    ``p2p --devices 2`` (a mesh on card 0, the same per-shard checksums,
    SUCCESS); ``hier --devices 4`` at 2^22 float32 a rank with ``--dcn
    2`` and ``--dcn 0`` (flat and hier SUCCESS); ``allreduce --devices
    4`` compact and spread (the same ``validated``); and ``p2p`` under
    ``TPU_PATTERNS_REPS=3`` (the run's reps 3, a flag's 4 beating it);
14. the load generator on the serve path (``loadgen/``) at the serve
    model's width (vocab 2048, embed 1024, 8 heads x 128, 8 slots,
    block_len 16, attention through K1) cut to depth 2
    (``LOADGEN_WIDTH``) in float32 with TF32 off:
    a throwaway run of ``chat:requests=8`` and ``chat-sampled:requests=8``
    first (``warmup``: the decode and sampling paths' first launches),
    then each of
    the five presets (chat, rag, batch-summarize, agentic, chat-sampled)
    at half their requests (``LOADGEN_REQUESTS``) and ``time_scale`` 1
    under its own SLO, each a ``run_loadgen`` of its
    own: every Record SUCCESS (goodput 1.0, nothing lost), cost
    identities closed, K1 launched (its count set to 0 just before each
    run, read just after, with the width of every launch), and
    ``chat-sampled``'s ids equal to the fixed-seed oracle's; ``chat``
    also under ``loadgen.arrive:error:after=2:count=1``, whose chaos
    Record must read WARNING (an arrival dropped and healed, the
    reference's verdict) with one drop and the trace covered;
    ``chat-sampled`` again at ``spec_k`` 4 (oracle-exact, K1 at W = 5);
    ``chat-sampled`` in bfloat16 with its id flips against the oracle
    reported, not gated; ``chat:requests=16`` under torch.profiler (device
    activity only) for the device's idle share; and the ``loadgen`` CLI (embed 256, head_dim
    32); each leg's TTFT, TPOT
    and e2e p50/p99, goodput, tokens and wall time;
15. ``decode`` and ``lm`` (``models/decode.py``, ``models/lm.py``; dense
    torch ops, no hand-written kernel), K1's and K2-K4's counts set to 0
    just before: ``run_decode`` at ``DecodeConfig``'s defaults (bf16,
    embed 1024, 8 heads x 128, depth 4, batch 8, a 4096-token prefill,
    128 generated, 5 reps), SUCCESS with ``cache_MB`` 553.648, its
    tokens/s, ms a token beside the step's byte floor (cache and weights
    read once over 3.35 TB/s), prefill ms and peak device memory, then
    again with 2 K/V heads, RoPE and an int8 cache (mode
    ``sp1_gqa2_rope_int8``); the teacher-forced check at that width in
    float32 with TF32 off (batch 2, a 512-token prefill, 16 steps fed the
    true input, MHA and GQA 2 with RoPE) against ``forward_stack`` over
    the whole sequence, within 256 float32 eps of the output's
    magnitude; one ``generate(…, 128)`` under torch.profiler: the
    device's busy and idle share of its wall and its launches a step;
    ``run_lm`` at ``LMConfig``'s defaults (float32, vocab 1024, embed
    256, 8 x 32, depth 2, batch 4, seq 256, 20 steps) greedy and sampled
    (temperature 0.8, top-k 16) twice, each SUCCESS and the two sampled
    runs' ids equal bit for bit; the ``decode`` (prefill 512, gen 16,
    reps 2) and ``lm`` (steps 4) CLI exiting 0, ``loadgen --dp 2``
    refused with the reference's message;
    then K1's and K2-K4's counts, which must read 0;
16. the kv tier, preemption and snapshots on the serve path, at the
    serve model's width in float32 with TF32 off (K1's count set to 0
    just before each leg, read just after): (a) ``run_serve`` with
    ``kv_host_tier``: the ``kv_tier_*`` Record SUCCESS (exact, the
    defer-only leg deferring where the tier leg never does, pressure
    admits, evictions and onload hits, no leak, tokens/s above the
    defer-only leg's), its evict and onload MB and the milliseconds of
    the copies, the session commits and the onloads; (b) the same with
    ``session_dir`` twice over one directory, the second run reading
    its history back (``session_loaded`` > 0) with 0 fresh full prompt
    blocks; (c) ``serve --snapshot_dir`` under
    ``serve.step:preempt:after=4:count=1`` (a WARNING Record and a
    committed snapshot), then ``--resume true --ids_out``: SUCCESS,
    exact and the ids file equal to an uninterrupted engine's; again
    with ``--prefix_share true --spec_k 4`` under ``serve.verify``
    (K1 at W = 5 after the resume); (d) priority preemption at the
    engine (2 slots, running bulk rows, interactive arrivals), greedy
    and sampled (temperature 0.8, top-k 16): ids equal to an
    unpreempted engine's, preempted and resumed >= 1, no banked
    partial left, each lifecycle's n_out its n_gen; (e) ``run_loadgen``
    with ``kv_host_tier`` on the JAX package's tier-race traffic (its
    ``serve.kv_tier`` sweep cell, lengths doubled for block_len 16): the
    ``chat_kv_tier_*`` Record SUCCESS, the defer-only leg deferring, the
    tier leg never, and the tier leg decoding in fewer steps;
17. recovery and the obs plane on the serve path, through K1, at the
    serve model's width in float32 with TF32 off (K1's count set to 0
    just before each leg, read just after; alone with ``--tree .
    recovery``): (a) the serve trace (8 requests, gen 16) with
    ``error:count=1`` at ``serve.prefill``, ``serve.step`` and
    ``serve.verify`` (spec_k 4): ids equal to the unfaulted run's and
    the dense oracle's, one retry counted at the site; (b)
    ``scripts/chaos_smoke.py``'s leg (d) at dp = tp = 1 through the CLI
    (``--prefix_share true --spec_k 4 --max_prompt 24 --shared_prefix
    16`` under ``serve.verify:error:after=2:count=99``): exit 0, a
    WARNING Record, quarantined > 0, done + quarantined = 8, no leaked
    block; (c) the JAX package's ``loadgen.chaos_chat`` sweep cell: the
    chaos Record covers the trace, its faults fired and its p99 is
    within 50x the clean run's; (d) ``serve.step:error:count=99`` under
    a ``Breaker(threshold=2)``: it trips, the loop stops and the queue
    stays intact; (e) a ``--obs-dump`` serve run's ``spans.jsonl``,
    ``metrics.jsonl`` and ``cost.jsonl`` and their ``obs export
    --chrome-trace``, every ``serve.step_outer`` at least its
    ``serve.step`` under ``serve.step:sleep``, a hang dump with every
    thread's stack and a WARNING Record under ``serve.step:hang`` and
    ``--watchdog_s 1``, and ``/healthz`` and ``/metrics`` answering
    mid-run from the live plane; (f) the serve trace's tokens/s with the
    obs plane off and on, alternating, 4 readings each, spans a decode
    step and the host's microseconds a span (reported, not gated);
18. diagnostics and the perf observatory (alone with ``--tree .
    diagnostics``): (a) ``doctor --device cuda`` through the CLI in a
    process of its own, started as the smoke's pre-flight beside the
    kernel build (which uses no card) and waited for before the first
    timed phase: SUCCESS, its mode the card's name, the backend,
    tiny-op and deep (bf16 4096 x 2048 ``x @ x.T``, checksum) probes
    and both native modules ok; (b) ``--enable_profiling`` over a
    ``serve`` run at the serve model's width (bf16, 2 requests of 8
    tokens, with ``--obs-dump``) and over a ``flagship`` run at its
    defaults: each a ``profile_breakdown`` Record with busy <= wall and
    idle = wall - busy, the flagship's ``compute_frac`` >= 0.8 and K3/K4
    launched (their counts set to 0 just before); one serve engine run
    profiled in this process, its busy union parsed back from the
    exported Kineto JSON equal to the in-memory one within 1 us; (e)
    ``perf report`` at the serve width (bf16, train at batch 4, seq
    1024, 24 requests): K1 launched in the ``*_pallas`` captures (count
    set to 0 just before), a row for every ported executable, the card
    named, no MFU above 1 or GB/s past 1.15 x 3350, ``serve.kv_tier``
    with evictions and onload hits; (f) ``perf update-baseline`` into a
    scratch file, then ``perf diff --include serve.step`` under
    ``serve.step:sleep`` exiting 1 and naming ``serve.step``, and again
    without the fault exiting 0; then, with nothing left to time, (c)
    ``profilecheck`` on both traces, ``frac_other_time`` <= 0.2, the
    op-name snapshots written to ``results/op_names/`` (the
    classifier's fixtures) and every flash kernel booked as compute; (d)
    ``obs summarize --profile-dir`` joining the serve run's spans with
    its trace; and (e) one decode step of the dense and the K1 decoder
    on one pool in float32: logits within phase 3's K1 tolerance (2e-5),
    equal ids, K1 launched once a layer;
19. sequence parallelism, the ``longctx`` pattern over a rank mesh
    (alone with ``--tree . longctx``; TF32 off): (a) K3 and K4 (K2 on
    the diagonal) against their plain versions at the ring's full-width
    shard (Lq = Lk = 1024, 8 heads x 128, causal), float32 and bfloat16,
    contiguous (a wholly masked pair, the diagonal, a pair with no key
    masked) and striped at stride 4; then K2 (the whole 4096-token
    sequence), K3 and K4 (a shard pair with no key masked and the
    diagonal) in float32 (the register-tiled kernels), each beside its
    plain version, one SDPA call in float32 and its f32 bound (alone,
    with the f32 kernels' registers, the diagonal-over-full ratios and
    the f32 CLI legs' TFLOP/s, forward and ``--grad``, as ``--tree TREE
    flash_f32_time``); (b) ``longctx``
    through the CLI at ``LongCtxConfig``'s defaults (float32, seq 4096,
    8 x 128, causal): ``--devices 1`` (ring, ulysses and flash, and the
    agreement Record) and ``--devices 4`` with each of ring,
    ring_pallas, ring_striped, ulysses and ulysses_pallas; (c) ``--grad
    true``: flash at 1 rank, ring_pallas and ulysses_pallas at 4, each
    ``tflops_hw`` at most 67 TFLOP/s times the one card; (d) bfloat16:
    ring_pallas, and ulysses_pallas and flash with ``--causal_grid
    compact``; every Record SUCCESS, K2-K4 launched in every fused run
    and in no plain one (counts set to 0 just before each); one direct
    call of each fused strategy, without and with a gradient, its
    launches exactly as the strategy's structure gives (ring_pallas at
    sp 4: 16 K3, and 16 of each K4 kernel under grad; ulysses_pallas 4
    K2, or 4 K3 and 4 of each K4 kernel; flash 1 K2, or one of each);
    (e) ``--enable_profiling`` over ``longctx --grad true --strategy
    flash --devices 1``, then ``profilecheck --rates-jsonl`` on its
    Records: the ``tflops_hw`` cross-check SUCCESS and coherent;
20. the parallelism patterns (``parallel/``; alone with ``--tree .
    parallel``; no kernel on this path): ``overlap`` at
    ``OverlapConfig``'s defaults (rows 1024, E 4096, F 4096, bf16, the
    ag and rs Records) at 4 ranks and 1, with the card's TFLOP/s (ranks
    x ``tflops_decomposed``, and the baseline's) at most the bf16 peak;
    ``pipeline`` at ``PipelineConfig``'s (n_micro 8, batch 4, dim 256,
    f32, gpipe and 1f1b) at 4 ranks and 2, with the microbatch conveyor
    and with replicated microbatches; ``moe`` at ``MoEConfig``'s (512
    tokens a rank, dim 128, f32, cf 0, 2 and 1) at 4 ranks and 1, and
    in bfloat16 at 4; every Record SUCCESS; then ZeRO over 4 ranks on
    leaves of 4096 x 4096, 4096 and 61 (the pad path): one SGD step and
    two Adam steps of ``zero_apply`` within 1e-6 relative of the
    replicated update, each rank's Adam moments a quarter of a leaf;
    the phase's wall time and the card's name and power limit;
21. the model train step across ranks (``model_mesh``; alone with
    ``--tree . model_mesh``), all ranks on the one card: (a) ``run_flagship``
    at its full default width (bf16, E 1024, 8 x 128 heads, L 4096, B 4,
    kernel attention) over the contiguous meshes (dp, sp, tp) (1,1,1),
    (2,2,1), (1,4,1), (1,2,2) and (2,2,2), striped at (1,4,1), moe at
    (1,2,2) and zero-adam and zero-adam-offload at (2,2,1): every Record
    SUCCESS, each loss within rtol 2^-5 of the one-rank loss on the same
    params (moe: the one-rank loss of its own params), each mesh's world
    gradient (the ZeRO legs' through Adam's first moment) within
    ``MM_GRAD_TOL`` of the one-rank step's, part by part (wqkv's q, k and
    v apart) relative to the part's max, K3 and each K4 kernel launched
    depth x dp x tp x sp^2 times a step, step_ms and TFLOP/s beside the
    card's name and power limit, and ``MM_FAULTS``, faults planted in
    the ring's K3/K4 blocks, the attention output, the tp sums and the
    striped layout, each tripping the gradient gate; (b) float32 with
    TF32 off at E 256, H 8, D 64, L 1024, B 4: the (2,2,2) step's loss
    within rtol 1e-5 of (1,1,1)'s, its gathered params within atol 1e-6
    and its gradients within ``MM_GRAD_TOL``, every dp/sp replica
    bit-identical, zero-sgd equal to SGD (rtol 1e-5, atol 1e-7) and the
    ZeRO path's gradients to SGD's, GPipe's updates at (1,2,2,2) to
    1F1B's and to the flat (1,2,2) step's over the same two blocks, and
    the ring and attention faults planted again; (c) ``train --devices 4
    --dp 2 --optimizer zero-adam
    --ckpt_every 2 --attn kernel`` (at the train loop's widths but 4
    heads of 64, float32) killed at step 4 and resumed to 6:
    its step-6 checkpoint bit-exact with a straight run's, and resumed
    on ``--dp 1`` (sp 4) within atol 1e-5 of it; (d) ``python -m
    tpu_patterns_torch flagship --devices 4 --dp 2`` in a process of its
    own on the package under test, exit 0 and a SUCCESS marker; (e) ``perf report --include
    zero.step`` at ``PerfConfig``'s defaults, its row and a SUCCESS
    marker; the phase's wall time;
22. ``decode`` and ``lm`` across ranks (``decode_lm_mesh``; alone with
    ``--tree . decode_lm_mesh``; no kernel on this path), all ranks on
    the one card: (a) ``run_decode`` at ``DecodeConfig``'s widths (bf16,
    E 1024, 8 x 128, depth 4, B 8, prefill 4096, gen 128; reps 2) at
    (dp, sp, tp) (1,1,1), then cut to depth 2 and gen 32 (``DLM_CUT``)
    over (1,4,1), (1,2,2) and (2,2,2), striped at (1,4,1), moe at
    (1,2,2) and GQA 4 with RoPE and an int8 cache at (1,2,2): every
    Record SUCCESS (the teacher-forcing gate at
    the mesh), the ragged gate at each mesh, the mode the mesh gives,
    ``cache_MB`` 553.648 at gen 128, ``ms_per_token``, ``prefill_ms`` and
    ``cache_MB`` beside the card's name and power limit; (b) the
    attention gate: on each mesh of (a) at depth 4, every layer's combined
    attention output (before ``wo``) at the prefill's last row and the
    first 4 teacher-forced decode steps against one rank's on the same
    params and inputs (the probe's inputs x4, ``DLM_ATTN_INPUT_SCALE``),
    max |diff| over max |one rank| at most ``DLM_ATTN_TOL``, and two
    planted faults at (1,4,1) above it (one sp rank's weighted values
    left out of the combine, a per-rank max); in float32 with TF32 off
    (E 256, 8 x 64, prefill 1024, B 4) the teacher-forced outputs over
    (1,4,1), (1,2,2), (2,2,2) and striped (1,4,1) within 256 eps of one
    rank's, and the LM's greedy ids at (2,2,2) and striped (1,4,1) equal
    to one rank's; (c) ``run_lm`` at ``LMConfig``'s defaults over (1,1,1),
    (2,2,2), striped (1,4,1), and moe at (1,1,2) and (1,2,2): every
    Record SUCCESS, the first loss (unrounded) within rtol 1e-5 of one
    rank's (moe: of (1,1,2)'s), the greedy ids at (2,2,2) equal to one
    rank's, and the sampled ids (T 0.8, top_k 0 and 40) equal across
    two runs at one seed; (d) ``python -m tpu_patterns_torch decode
    --devices 4 --tp 2`` and ``lm --devices 8 --dp 2 --tp 2`` in
    processes of their own on the package under test, beside (b) and
    (c), exit 0 and a SUCCESS marker; K1-K4 launched 0 times in the
    phase; its wall time;
23. serve across ranks (``serve_mesh``; alone with ``--tree .
    serve_mesh``), all ranks on the one card: (a) K1 on one rank's stripe
    of every block (``bl_loc = 16 / sp``) at every rank of sp 2 and 4,
    against its plain version at phase 3's tolerances, at the serve
    width (8 rows, 8 x 128 heads over 2 kv heads, block_len 16, bf16, f32
    and int8, W 1 and 5, rows 0 and 1 at positions 1 and 5 so that page
    0 is dead on the upper ranks, an inactive row) and on the 4096-token
    windows; each sp group's combine of the kernel's triples against the
    sp = 1 kernel on the whole pool (``SM_COMBINE_TOL``); K1's ms a
    launch at rank 0 and rank sp - 1 beside the sp = 1 kernel's on the
    same pool, each beside its bound; (b) the serve width (E 1024, 8 x
    128, vocab 2048, RoPE, block_len 16; ``SM_CUT``: depth 2, 6 requests,
    16 generated) in bf16 through 4 slots (2 requests admitted mid-run,
    into recycled slots) over (dp, sp, tp) (1,1,1), (1,2,1), (1,1,2),
    (1,2,2) and (1,4,1) and with GQA 2 and an int8 pool at (1,2,2)
    (continuous faster than sequential, the pool in place, K1 launched
    depth x ranks x decode steps, id flips against the same-mesh dense
    oracle reported with their top-2 margin, gated above bf16 resolution
    but for int8); in float32 with TF32 off ``run_serve`` with the prefix
    and spec Records at (1,2,2), at (1,4,1), the kv tier Record at
    (1,2,1) (phase 16's 32 requests), a preempt/resume pair at (1,2,1)
    and ``run_loadgen`` ``chat:requests=16`` at (1,2,2): every Record
    SUCCESS (the preempted one WARNING) with exact ids, its mode the
    mesh's sp, K1 launched depth x ranks x the decoder's calls; (c) the
    combine gate: the sound combine at sp 2 and 4 within
    ``SM_COMBINE_TOL``, a per-rank max and one rank's weighted values
    left out each above it; the phase's wall time;
24. the replica fleet (``fleet``; alone with ``--tree . fleet``): the
    serve width in float32 (E 1024, 8 x 128, depth 4, vocab 2048, RoPE,
    block_len 16; phase 5's trace at 16 generated tokens and 8
    requests in leg c, ``FLEET_CUT``), every replica a
    ``python -m
    tpu_patterns_torch`` process of its own on the one card, each
    serving through K1: (a) ``serve --replicas 2 --devices 2
    --replica_policy round_robin`` on the plain trace, then one replica
    alone: both SUCCESS, exact, covered, no leak, the shipped child
    metrics equal to the front door's; ``replica_speedup`` printed, not
    gated (``FLEET_SPEEDUP_GATE`` 0: the reference's 1.8 is not met
    steadily on the one card); (b) the routing
    comparison on ``FLEET_CHAT``: ``prefix_hit_blocks`` under prefix
    routing above round-robin's, SUCCESS; (c) the store A/B under
    ``FLEET_KILL`` (one child SIGKILLed, a shared fault-state dir) with
    ``--prefix_share --kv_host_tier``, without and with
    ``--prefix_store``: both WARNING, covered and exact, the store leg's
    ``rerouted_fresh_blocks`` strictly below the base leg's; (d) the
    elastic A/B on ``FLEET_RAMP`` (1 replica + 1 reserve): SUCCESS with
    a scale-out; (e) ``obs fleet`` and ``obs journey`` over leg a's obs
    dir: one journey a completed request, the merged retirements equal
    to the Record's ``done_total``; every child that served launched K1;
    the phase's wall time;
25. disaggregated prefill/decode (``disagg``; alone with ``--tree .
    disagg``): the fleet width of phase 24 in float32, every replica a
    process of its own on the one card: (a) ``serve --replicas 2
    --devices 2 --disagg 1:1`` on the ``rag`` preset (``DISAGG_RAG``,
    arrivals at ``DISAGG_TIME_SCALE``): the disagg A/B Record SUCCESS
    with a transfer, exact ids, no leak and no recompute, the TTFT gate
    off (``DISAGG_TTFT_GATE`` 0: the reference smoke's 1.05 is not met
    on the one card); ``ttft_p99_ms_disagg``,
    ``ttft_p99_ms_unified``, ``ttft_improvement`` and ``transfer_bytes``
    printed; (b) chaos case (h): ``--replicas 3 --devices 3 --disagg
    2:1`` under ``DISAGG_KILL`` (prefill replica 0 SIGKILLed at its
    first transfer, a shared fault-state dir): SUCCESS with
    ``rerouted`` > 0 and no ``.tmp`` file left under the fleet's dir;
    (c) ``perf report --include disagg.stream`` at the serve width (a
    96-token window): the wire's ms and GB/s against its byte floor; in
    (a) and (b) K1 launched in every decode child and every unified
    child and in no prefill child, printed by replica and role; the
    phase's wall time;
26. the card's name and power limit again, the ``kernels`` line (the
    flash rows also carry ``train_loop_launches``, phase 8b's counts,
    K1's row ``loadgen_launches``, phase 14's by scenario,
    ``kv_tier_launches``, phase 16's by leg, ``recovery_launches``,
    phase 17's by leg, K1-K4 ``decode_lm_launches``, phase 15's,
    ``diagnostics_launches``, phase 18's by leg, and K2-K4
    ``longctx_launches``, phase 19's by leg, with ``longctx_f32``, their
    float32 times at longctx's shape, K3/K4 ``model_mesh_launches``,
    phase 21's by mesh, and K1-K4 ``decode_lm_mesh_launches``, phase
    22's, and K1's ``serve_mesh_launches``, phase 23's by leg, with its
    stripe checks and its times by rank, ``fleet_launches``, phase
    24's by leg and replica, and ``disagg_launches``, phase 25's by
    leg, replica and role),
    then the device line, which is the last.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BF16_RESOLUTION = 2.0**-7  # relative spacing of bfloat16 values
SPEC_K = 4  # drafts a row of the spec legs: K1 verifies at W = 5
SHARED_PREFIX = 384  # of the prefix leg's 512-token prompts
# the serve legs after phase 5's main bf16 leg (its GQA/int8, spec and
# prefix legs and phase 6's float32 Records) at half the serve model's
# depth and half its requests: each runs its trace continuous and
# sequential, twice
SERVE_LEG_CUT = dict(depth=2, requests=8)
FULL_WIDTH = dict(
    vocab=2048, embed=1024, heads=8, head_dim=128, mlp_mult=4, depth=4,
    rope=True, slots=8, block_len=16, min_prompt=64, max_prompt=512,
    gen=64, device=DEVICE, paged_attn="kernel",
)
# flash kernel vs plain: max |kernel - plain| over max |plain|
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flagship exactness (f32, TF32 off): the loss, and each parameter's
# update p - p_new as max |kernel - dense| over max |dense|.  The two
# attention paths differ by ~3e-7 relative; where an MLP preactivation
# lies within that of zero, relu's gate flips between them and moves a
# few elements of w1's update by up to ~1e-3 of its max, so the update
# gate is 1e-2 (a wrong kernel is off by O(1)).
FLAGSHIP_LOSS_RTOL = 1e-4
FLAGSHIP_UPDATE_TOL = 1e-2
FLASH_KERNELS = {  # LAUNCHES key -> (source, the Pallas body it replaces)
    "flash_attention": ("tpu_patterns_torch/longctx/csrc/flash_attention.cu",
                        "tpu_patterns/longctx/flash.py:135"),
    "flash_block": ("tpu_patterns_torch/longctx/csrc/flash_attention.cu",
                    "tpu_patterns/longctx/flash.py:591"),
    "flash_block_bwd_dq": (
        "tpu_patterns_torch/longctx/csrc/flash_attention_bwd.cu",
        "tpu_patterns/longctx/flash.py:255"),
    "flash_block_bwd_dkv": (
        "tpu_patterns_torch/longctx/csrc/flash_attention_bwd.cu",
        "tpu_patterns/longctx/flash.py:279"),
}


PUT_SOURCE = "tpu_patterns_torch/comm/csrc/local_put.cu"
PUT_KERNELS = {  # wrapper -> the Pallas body it replaces
    "local_put": "tpu_patterns/comm/onesided.py:88",
    "local_put_streamed": "tpu_patterns/comm/onesided.py:108",
    "local_put_multi": "tpu_patterns/comm/onesided.py:229",
    "local_put_inplace": "tpu_patterns/comm/onesided.py:175",
}
PUT_FULL = (92160, 512)  # the reference's message size as rows x cols
# The redesigned kernels' times before their redesign (PERF.md's kernel
# table, measured by this script on NVIDIA H100 80GB HBM3, 700.00 W),
# set beside this run's
REDESIGNED_BEFORE_MS = {"flash_block": 4.485, "flash_attention": 4.539,
                        "flash_block_bwd_dq": 4.925,
                        "flash_block_bwd_dkv": 6.599, "local_put": 4.023,
                        "paged_attention": 0.1593, "local_put_multi": 0.5195,
                        "local_put_inplace": 0.2632,
                        "accumulate n=2^23": 0.04396,
                        "accumulate n=2^25": 0.1410,
                        "local_put_streamed": 0.1381, "ring_put": 0.1372,
                        "add_one": 0.09865}
# the f32 kernels' times before their redesign (the scalar kernels, this
# script's phase 19 leg a on NVIDIA H100 80GB HBM3, 700.00 W), beside
# this run's
F32_BEFORE_MS = {"flash_attention": 5.918, "flash_block full": 0.5918,
                 "flash_block diagonal": 0.5921,
                 "flash_block_bwd_dq full": 0.9499,
                 "flash_block_bwd_dq diagonal": 0.7914,
                 "flash_block_bwd_dkv full": 1.074,
                 "flash_block_bwd_dkv diagonal": 1.056}
# kernel library -> the kernels redesigned for the card (name prefixes)
# whose -Xptxas -v report the kernel_build line carries
REDESIGNED_LIBS = {"flash_attention": ("flash_fwd_wgmma_kernel",
                                       "flash_fwd_f32_kernel"),
                   "flash_attention_bwd": ("flash_bwd_wgmma_",
                                           "flash_bwd_dq_f32_kernel",
                                           "flash_bwd_dkv_f32_kernel"),
                   "local_put": ("local_put_mono_kernel",
                                 "local_put_streamed_kernel",
                                 "local_put_multi_kernel",
                                 "local_put_inplace_kernel"),
                   "ring_put": ("ring_put_kernel",),
                   "paged_attention": ("paged_attention_split_kernel",),
                   "accumulate": ("accumulate_vec_kernel",
                                  "accumulate_scalar_kernel"),
                   "add_one": ("add_one_vec_kernel", "add_one_scalar_kernel")}
# the backward's instances as ptxas_report names them
BWD_WGMMA = re.compile(r"flash_bwd_wgmma_(dq|dkv)_kernel<D=(\d+),NC=(\d+)>")
# the f32 forward's instances (a head_dim and rows a thread each)
FWD_F32 = re.compile(r"flash_fwd_f32_kernel<D=(\d+),RT=(\d+)>")
# the f32 backward's (a head_dim and the rows or keys a block owns)
BWD_F32 = re.compile(r"flash_bwd_(dq|dkv)_f32_kernel<D=(\d+),OWN=(\d+)>")


def emit(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                          check=True).stdout


def ptxas_report(log: str, prefix: str) -> dict:
    """Registers, spills and static shared memory of each kernel whose
    name starts with ``prefix`` in an ``nvcc -Xptxas -v`` log, and
    whether ptxas serialized its wgmma products (C7513).  The wgmma
    kernels' instances are named by their template arguments (the
    forward's D, block_k, consumer warpgroups; the backward's D and
    consumer warpgroups)."""
    out, cur, serialized = {}, None, set()
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", ln)
        if m:
            cur = m.group(1) if prefix in m.group(1) else None
            if cur and cur not in out:
                out[cur] = {"wgmma_serialized": False}
            continue
        m = re.search(r"wgmma.*serialized.*function '(\w+)'", ln)
        if m:
            serialized.add(m.group(1))
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("static_smem", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                out[cur][key] = int(m.group(1))

    for name in serialized & out.keys():
        out[name]["wgmma_serialized"] = True

    def pretty(name):
        t = re.search(r"(accumulate_(?:vec|scalar)_kernel)I([fi])", name)
        if t:
            return (t.group(1) + "<" + {"f": "float", "i": "int"}[t.group(2)]
                    + ">")
        t = re.search(r"paged_attention_split_kernelI((?:L[ib]\d+E)+)E",
                      name)
        if t:
            args = re.findall(r"L[ib](\d+)E", t.group(1))
            labels = ("Q", "KV", "D", "STRIPED")
            return ("paged_attention_split_kernel<"
                    + ",".join(f"{a}={b}" for a, b in zip(labels, args))
                    + ">")
        t = re.search(r"\d(flash_\w+?_kernel)I((?:Li\d+E)+)E", name)
        if not t:
            return prefix
        args = re.findall(r"Li(\d+)E", t.group(2))
        labels = (("D", "BK", "NC") if len(args) == 3
                  else ("D", "OWN") if "bwd" in t.group(1) and "f32"
                  in t.group(1) else ("D", "RT") if "f32" in t.group(1)
                  else ("D", "NC"))
        return (t.group(1) + "<"
                + ",".join(f"{a}={b}" for a, b in zip(labels, args)) + ">")
    return {pretty(n): r for n, r in out.items()}


# -- phase 3: the kernel against its plain version ---------------------------


def make_case(torch, *, kind, b, w, h, hkv, d, bl, n_pages, n_blocks,
              seed, q_bf16=False, lens=None):
    """Pool, q, tables, pos0 and active on the card.  ``lens`` (per-row
    prompt lengths) gives the serve path's tables: each row owns the
    blocks of its whole lifetime and sits at a position inside it; else
    random distinct tables with a TRASH tail page on row 0, an inactive
    row 1 and an all-TRASH row 2."""
    g = torch.Generator().manual_seed(seed)
    shape = (n_blocks, bl, hkv, d)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    if kind == "int8":
        pool = {
            "k": torch.randint(-127, 128, shape, generator=g).to(torch.int8),
            "v": torch.randint(-127, 128, shape, generator=g).to(torch.int8),
            "ks": torch.rand(shape[:3], generator=g) * 0.015 + 0.005,
            "vs": torch.rand(shape[:3], generator=g) * 0.015 + 0.005,
        }
        q_dt = torch.bfloat16 if q_bf16 else torch.float32
    else:
        pool = {n: torch.randn(shape, generator=g).to(dt[kind])
                for n in ("k", "v")}
        q_dt = dt[kind]
    q = torch.randn((b, w, h, d), generator=g).to(q_dt)
    perm = (1 + torch.randperm(n_blocks - 1, generator=g)).tolist()
    tables = torch.zeros((b, n_pages), dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool)
    if lens is not None:
        pos0 = torch.zeros(b, dtype=torch.int32)
        for i, n in enumerate(lens):
            need = -(-(n + 63) // bl)
            tables[i, :need] = torch.tensor(perm[:need], dtype=torch.int32)
            perm = perm[need:]
            # a decode position inside the lifetime: pos0 + w - 1 <= n + 62
            pos0[i] = n + int(torch.randint(0, 64 - w, (1,), generator=g))
    else:
        tables[:] = torch.tensor(perm[: b * n_pages]).reshape(b, n_pages)
        pos0 = torch.randint(0, n_pages * bl - w + 1, (b,), generator=g,
                             dtype=torch.int32)
        tables[0, -1] = 0
        active[1] = False
        tables[2] = 0
    return ({n: t.to(DEVICE) for n, t in pool.items()}, q.to(DEVICE),
            tables.to(DEVICE), pos0.to(DEVICE), active.to(DEVICE))


def kernel_bytes_and_ops(case, block_len, rank=0):
    """Bytes the function must move (the K/V slots and scales that some
    query sees, q, tables and per-row ints in; o/m/l out) and its flops
    (q.k and p.v over the keys each query sees), for the bound.  Only
    visible keys count: slots of a live page past the row's last query
    position are masked and the output does not depend on them.  A
    shard pool of ``bl`` slots a block holds sp rank ``rank``'s stripe
    of each ``block_len``-slot block."""
    pool, q, tables, pos0, active = case
    b, w, h, d = q.shape
    bl, hkv = pool["k"].shape[1:3]
    g = h // hkv
    first = (tables.new_tensor(range(tables.shape[1]))[None, :] * block_len
             + rank * bl)
    live = (tables != 0) & active[:, None]  # [B, n_pages]

    def visible_keys(last_pos):  # keys at positions <= last_pos, [B]
        n = (last_pos[:, None] + 1 - first).clamp(0, bl)
        return (n * live).sum(dim=1)

    # bytes: keys seen by a row's last query; flops: each query's own
    n_bytes_keys = int(visible_keys(pos0 + w - 1).sum())
    n_op_keys = sum(int(visible_keys(pos0 + i).sum()) for i in range(w))
    slot = hkv * d * pool["k"].element_size() * 2
    if "ks" in pool:
        slot += hkv * 4 * 2
    nbytes = (
        n_bytes_keys * slot
        + q.numel() * q.element_size() + tables.numel() * 4 + b * 5
        + b * hkv * g * w * (d + 2) * 4
    )
    flops = n_op_keys * hkv * g * d * 4
    return nbytes, flops


def check_kernel(torch, pk, name, case, block_len, tol):
    """Launch the kernel and the plain version on one case; raise if
    they disagree or a dead row is not exactly zero."""
    pool, q, tables, pos0, active = case
    args = (q, pool["k"], pool["v"], tables, pos0, active)
    kw = dict(block_len=block_len, k_scale=pool.get("ks"),
              v_scale=pool.get("vs"))
    got = pk.paged_block(*args, **kw)
    want = pk.paged_block_reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for g, w_, what in zip(got, want, ("o", "m", "l")):
        if not torch.allclose(g, w_, rtol=tol, atol=tol):
            raise AssertionError(
                f"{name}: kernel {what} differs from the plain version by "
                f"{float((g - w_).abs().max())}"
            )
        err = max(err, float((g - w_).abs().max()))

    from tpu_patterns_torch.serve import paged as P

    lay = P.PagedLayout(pool["k"].shape[0], block_len)
    if hasattr(pk, "paged_attend"):
        # a tree of another commit (``--tree``): the one-shard attend
        out = pk.paged_attend(pool, q, tables, pos0, active, lay)
    else:
        (out,) = P.paged_attend([pool], [q], [tables], [pos0], [active], lay)
    dead = (~active) | (tables == 0).all(dim=1)
    if not torch.isfinite(out).all() or bool((out[dead] != 0).any()):
        raise AssertionError(f"{name}: a dead row is not exactly zero")
    return err


def long_window_case(torch, *, b=32, n_pages=256, hkv=8, d=128, bl=16,
                     seed=23):
    """The long-window shape: ``b`` bf16 rows, each at the end of an
    ``n_pages * bl``-token window of its own distinct pages (every block
    of the pool but TRASH is some row's), W 1, H = Hkv."""
    g = torch.Generator().manual_seed(seed)
    n_blocks = 1 + b * n_pages
    shape = (n_blocks, bl, hkv, d)
    pool = {n: torch.randn(shape, generator=g).to(torch.bfloat16)
            for n in ("k", "v")}
    q = torch.randn((b, 1, hkv, d), generator=g).to(torch.bfloat16)
    tables = (1 + torch.randperm(n_blocks - 1, generator=g)).to(
        torch.int32).reshape(b, n_pages)
    pos0 = torch.full((b,), n_pages * bl - 1, dtype=torch.int32)
    active = torch.ones(b, dtype=torch.bool)
    return ({n: t.to(DEVICE) for n, t in pool.items()}, q.to(DEVICE),
            tables.to(DEVICE), pos0.to(DEVICE), active.to(DEVICE))


def time_paged(torch, pk, timing, spec, case, block_len, flush):
    """K1 on ``case``, its plain version, one SDPA call on the gathered
    window (the table's library column, as in earlier runs) and the
    gather from the block tables plus that SDPA (the closest library
    route to the whole function), each read 5 times (median, min, max)
    with the L2 flushed before every call; and the byte bound."""
    pool, q, tables, pos0, active = case
    args = (q, pool["k"], pool["v"], tables, pos0, active)
    kw = dict(block_len=block_len, k_scale=pool.get("ks"),
              v_scale=pool.get("vs"))
    b, w, h, d = q.shape
    hkv = pool["k"].shape[2]
    n_pages = tables.shape[1]
    L = n_pages * block_len
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def gathered():
        tb = tables.long()
        kg = pool["k"][tb].movedim(3, 1).reshape(b, hkv, L, d)
        vg = pool["v"][tb].movedim(3, 1).reshape(b, hkv, L, d)
        k_pos = torch.arange(L, device=DEVICE)
        visible = ((k_pos[None, :] <= pos0[:, None])
                   & (tables != 0).repeat_interleave(block_len, dim=1))
        return kg, vg, visible[:, None, None, :]

    kg, vg, mask = gathered()
    qh = q.transpose(1, 2)

    def gather_sdpa():
        kg_, vg_, mask_ = gathered()
        return sdpa(qh, kg_, vg_, attn_mask=mask_)

    def t(fn):
        return timing.cuda_time_repeated_ms(fn, before=flush.zero_)

    row = {
        "kernel": t(lambda: pk.paged_block(*args, **kw)),
        "plain": t(lambda: pk.paged_block_reference(*args, **kw)),
        "library_sdpa": t(lambda: sdpa(qh, kg, vg, attn_mask=mask)),
        "library_gather_sdpa": t(gather_sdpa),
    }
    nbytes, flops = kernel_bytes_and_ops(case, block_len)
    bytes_ms = nbytes / (spec["hbm_gbps"] * 1e9) * 1e3
    ops_ms = flops / (spec["f32_tflops"] * 1e12) * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pps = pk.split_pages(n_pages, block_len, b, hkv,
                         d * pool["k"].element_size(), sms)
    row.update(
        bytes=nbytes, flops=flops, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        pages_per_split=pps, blocks=b * hkv * -(-n_pages // pps),
        pages_per_stage=min(pps, pk.stage_pages(
            block_len, d * pool["k"].element_size())),
    )
    row["share_of_bound"] = row["bound_ms"] / row["kernel"]["ms"]
    return row


# the serve slice's shape: 8 rows at their decode positions in lifetimes
# of prompts 64-512 plus 64 generated tokens, block_len 16, 36-page
# tables over a 217-block pool
SLICE_LENS = (64, 512, 300, 128, 450, 77, 200, 389)


def slice_case(torch, **kw):
    """:func:`make_case` at the serve slice's shape (``kw``: kind, w, h,
    hkv, seed, q_bf16)."""
    n_blocks = 1 + sum(-(-(n + 63) // 16) for n in SLICE_LENS)
    return make_case(torch, b=8, d=128, bl=16, n_pages=36,
                     n_blocks=max(n_blocks, 217), lens=list(SLICE_LENS),
                     **kw)


def k1_times(torch, pk, timing, spec, serve_case):
    """K1's time at the main path's shape (bf16 pool, W=1, G=1) and at
    the long window, L2 flushed, each emitted as a ``kernel_time``
    row."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    serve = time_paged(torch, pk, timing, spec, serve_case, 16, flush)
    emit({"phase": "kernel_time", "shape": "B8 W1 H8 Hkv8 D128 bl16 pages36 "
          "bf16, L2 flushed", **serve})
    long_case = long_window_case(torch)
    err = check_kernel(torch, pk, "long_window_bf16", long_case, 16, 1e-4)
    longw = time_paged(torch, pk, timing, spec, long_case, 16, flush)
    del long_case
    emit({"phase": "kernel_time", "shape": "B32 W1 H8 Hkv8 D128 bl16 "
          "pages256 (4096-token windows) bf16, L2 flushed", **longw})
    return serve, longw, err


def phase_kernels(torch, pk, timing, spec):
    results = {"cases": 0, "max_abs_err": 0.0}
    tols = {"f32": 2e-5, "bf16": 1e-4, "int8": 1e-4}
    for kind in ("f32", "bf16", "int8"):
        for w in (1, 4, 5):
            for g in (1, 4):
                name = f"small_{kind}_w{w}_g{g}"
                case = make_case(torch, kind=kind, b=4, w=w, h=4, hkv=4 // g,
                                 d=64, bl=8, n_pages=5, n_blocks=24,
                                 seed=len(name) * 7 + w + g)
                err = check_kernel(torch, pk, name, case, 8, tols[kind])
                results["cases"] += 1
                results["max_abs_err"] = max(results["max_abs_err"], err)
    slice_cases = {
        "slice_bf16_w1_g1": dict(kind="bf16", w=1, h=8, hkv=8),
        "slice_f32_w1_g1": dict(kind="f32", w=1, h=8, hkv=8),
        "slice_int8_w1_g4": dict(kind="int8", w=1, h=8, hkv=2, q_bf16=True),
        "slice_bf16_w4_g1": dict(kind="bf16", w=4, h=8, hkv=8),
        "slice_int8_w4_g4": dict(kind="int8", w=4, h=8, hkv=2, q_bf16=True),
        # split edges, at the kernel's own split of the bf16 serve shape:
        # row 0's window ends inside the first split, and every page of
        # row 1's second split is TRASH between live ones
        "split_edges_bf16_w4_g1": dict(kind="bf16", w=4, h=8, hkv=8),
        # the verify step of spec_k 4: W = 5, with an inactive row and a
        # row whose last lanes lie past its table (a verify's padding
        # lanes past the row's lifetime)
        "verify_bf16_w5_g1": dict(kind="bf16", w=5, h=8, hkv=8),
        "verify_bf16_w5_g4": dict(kind="bf16", w=5, h=8, hkv=2),
        "verify_int8_w5_g4": dict(kind="int8", w=5, h=8, hkv=2, q_bf16=True),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pps = pk.split_pages(36, 16, 8, 8, 128 * 2, sms)
    cases = {}
    for name, kw in slice_cases.items():
        cases[name] = slice_case(torch, seed=17, **kw)
        if name.startswith("split_edges"):
            _, _, tables, pos0, _ = cases[name]
            pos0[0] = pps * 16 // 2
            tables[1, pps: 2 * pps] = 0
        if name.startswith("verify"):
            _, _, tables, pos0, active = cases[name]
            active[5] = False
            pos0[2] = int((tables[2] != 0).sum()) * 16 - 2
        err = check_kernel(torch, pk, name, cases[name], 16,
                           tols[kw["kind"]])
        results["cases"] += 1
        results["max_abs_err"] = max(results["max_abs_err"], err)
    # the same cases in splits of several stages (the long-window plan,
    # which these shapes do not reach on their own)
    wave = pk.WAVE_BLOCKS
    pk.WAVE_BLOCKS = 0
    try:
        for name, case in cases.items():
            err = check_kernel(torch, pk, name + "_staged", case, 16,
                               tols[slice_cases[name]["kind"]])
            results["cases"] += 1
            results["max_abs_err"] = max(results["max_abs_err"], err)
    finally:
        pk.WAVE_BLOCKS = wave
    # shared memory of the verify step's block (G*W = 20, bf16, D 128)
    vpps = pk.split_pages(36, 16, 8, 2, 128 * 2, sms)
    verify_smem = pk._library().paged_attention_smem_bytes(
        20, 128, 1, 16, vpps, min(vpps, pk.stage_pages(16, 256)))
    emit({"phase": "kernel_vs_plain", **results,
          "serve_pages_per_split": pps,
          "verify_w5_g4_smem_bytes": verify_smem,
          "verify_w5_g4_pages_per_split": vpps})

    # time the main path's shape (bf16 pool, W=1, G=1) and the long
    # window, L2 flushed
    serve, longw, err = k1_times(torch, pk, timing, spec,
                                 cases["slice_bf16_w1_g1"])
    results["max_abs_err"] = max(results["max_abs_err"], err)
    return results, serve, longw


# -- phase 4: the flash kernels against their plain versions ----------------


def _rel(got, want, rows=None):
    """(max |got - want| / max |want|, max |got - want|), over the [H, L]
    statistics' ``rows`` (a mask) when given."""
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    diff = float((g - w).abs().max()) if w.numel() else 0.0
    top = float(w.abs().max()) if w.numel() else 0.0
    return diff / max(top, 1e-30), diff


def flash_case(torch, F, name, *, lq, lk, h, d, dtype, causal, q_off=0,
               k_off=0, stride=1, bq=1024, bk=1024, seed=0):
    """K3, K2 (zero offsets only) and K4 against their plain versions on
    one case; raise past FLASH_TOL or where a wholly masked row is not
    exactly zero.  Returns {kernel: (rel, abs)} and the inputs."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((lq, h, d), generator=g).to(DEVICE, dt)
    k, v = (torch.randn((lk, h, d), generator=g).to(DEVICE, dt)
            for _ in range(2))
    do = torch.randn((lq, h, d), generator=g).to(DEVICE, dt)
    kw = dict(causal=causal, block_q=bq, block_k=bk, pos_stride=stride)
    o, m, l = F.flash_block(q, k, v, q_off, k_off, **kw)
    ro, rm, rl = F.flash_block_reference(q, k, v, q_off, k_off, causal,
                                         None, stride)
    live = rl > 0  # [H, Lq] rows that see a key
    errs = {"flash_block": max(_rel(o, ro), _rel(m, rm, live), _rel(l, rl))}
    dead = ~live.T  # [Lq, H]
    dead_ok = bool((o[dead] == 0).all() and (l[~live] == 0).all()
                   and (m[~live] == F.NEG_INF).all())
    if (q_off, k_off, stride) == (0, 0, 1):
        out = F.flash_attention(q, k, v, causal=causal, block_q=bq,
                                block_k=bk)
        errs["flash_attention"] = _rel(
            out, F.flash_attention_reference(q, k, v, causal))
        dead_ok &= bool((out[dead] == 0).all())
    out_ref, lse = F._row_stats(ro, rm, rl)
    delta = F._delta(do, out_ref.to(dt))
    got = F.flash_block_bwd(q, k, v, do, lse, delta, q_off, k_off, **kw)
    want = F.flash_block_bwd_reference(q, k, v, do, lse, delta, q_off,
                                       k_off, causal, None, stride)
    errs["flash_block_bwd_dq"] = _rel(got[0], want[0])
    errs["flash_block_bwd_dkv"] = max(_rel(got[1], want[1]),
                                      _rel(got[2], want[2]))
    dead_ok &= bool((got[0][dead] == 0).all())
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    bad = [n for n, (r, _) in errs.items() if not r <= tol]
    if bad or not dead_ok:
        raise AssertionError(
            f"flash case {name}: {bad} past {tol} relative "
            f"({ {n: errs[n][0] for n in bad} }); wholly masked rows "
            f"exactly zero: {dead_ok}"
        )
    return errs, (q, k, v, do, lse, delta)


RAGGED = ((100, 200, 128, True), (100, 200, 64, False),
          (130, 130, 128, True), (40, 72, 64, True),
          (256, 384, 64, True), (256, 384, 64, False))


def _f32_bwd_case(torch, F, worst, q, k, v, do, q_off, k_off, causal,
                  stride=1, block=512):
    """K4 in float32 against its plain version on one case, the row
    statistics from the plain forward, into ``worst``; raise where a dq
    row that sees no key is not exactly zero."""
    ro, rm, rl = F.flash_block_reference(q, k, v, q_off, k_off, causal,
                                         None, stride)
    out, lse = F._row_stats(ro, rm, rl)
    delta = F._delta(do, out)
    got = F.flash_block_bwd(q, k, v, do, lse, delta, q_off, k_off,
                            causal=causal, block_q=block, block_k=block,
                            pos_stride=stride)
    want = F.flash_block_bwd_reference(q, k, v, do, lse, delta, q_off, k_off,
                                       causal, None, stride)
    worst["flash_block_bwd_dq"] = max(worst["flash_block_bwd_dq"],
                                      _rel(got[0], want[0])[0])
    worst["flash_block_bwd_dkv"] = max(worst["flash_block_bwd_dkv"],
                                       _rel(got[1], want[1])[0],
                                       _rel(got[2], want[2])[0])
    if not bool((got[0][(rl == 0).T] == 0).all()):
        raise AssertionError(f"f32 K4 {tuple(q.shape)} at ({q_off}, "
                             f"{k_off}, {stride}): dq of rows that see no "
                             "key not exactly zero")


def flash_ragged_f32(torch, F):
    """The f32 kernels at :data:`RAGGED`'s lengths, no multiple of their
    tiles (they stage rows past the end as zeros, mask keys past Lk and
    store no row past the end): K3 and K4 (also with the first half of
    the rows seeing no key) and K2 against their plain versions at
    FLASH_TOL, rows that see no key exactly zero (K3's o, m, l and K4's
    dq); then at 64 heads, where the 64-entry units run, ragged, at an
    offset and a stride.  Returns the worst relative error of each."""
    worst = {"flash_block": 0.0, "flash_attention": 0.0,
             "flash_block_bwd_dq": 0.0, "flash_block_bwd_dkv": 0.0}
    for i, (lq, lk, d, causal) in enumerate(RAGGED):
        g = torch.Generator().manual_seed(250 + i)
        q, k, v, do = (torch.randn((n, 3, d), generator=g).to(DEVICE)
                       for n in (lq, lk, lk, lq))
        for q_off, k_off in ((0, 0), (0, lq // 2)):
            o, m, l = F.flash_block(q, k, v, q_off, k_off, causal=causal)
            ro, rm, rl = F.flash_block_reference(q, k, v, q_off, k_off,
                                                 causal)
            live = rl > 0
            worst["flash_block"] = max(worst["flash_block"], _rel(o, ro)[0],
                                       _rel(m, rm, live)[0], _rel(l, rl)[0])
            dead_ok = bool((o[~live.T] == 0).all() and (l[~live] == 0).all()
                           and (m[~live] == F.NEG_INF).all())
            if not dead_ok:
                raise AssertionError(f"ragged f32 K3 {lq}/{lk}: wholly "
                                     "masked rows not exactly zero")
            _f32_bwd_case(torch, F, worst, q, k, v, do, q_off, k_off, causal)
        out = F.flash_attention(q, k, v, causal=causal)
        worst["flash_attention"] = max(worst["flash_attention"], _rel(
            out, F.flash_attention_reference(q, k, v, causal))[0])
    # 64 heads: the grids of 64-entry units fill the card, so these run
    # the 8-rows-a-thread forward and the 64-entry backward, ragged, at an
    # offset and a stride
    for i, d in enumerate((64, 128)):
        g = torch.Generator().manual_seed(260 + i)
        q, k, v, do = (torch.randn((1000, 64, d), generator=g).to(DEVICE)
                       for _ in range(4))
        if (F._blocks(q, k, ("fwd",), 1024, 1024)[0] != 64
                or F._bwd_tiles(q, k, 1000, 1000) != {"dq": (64, 64),
                                                      "dkv": (64, 64)}):
            raise AssertionError("64-entry f32 units not chosen at 64 heads")
        for q_off, k_off, stride in ((0, 0, 1), (0, 500, 1), (3, 0, 4)):
            o, m, l = F.flash_block(q, k, v, q_off, k_off, causal=True,
                                    pos_stride=stride)
            ro, rm, rl = F.flash_block_reference(q, k, v, q_off, k_off,
                                                 True, None, stride)
            live = rl > 0
            worst["flash_block"] = max(worst["flash_block"], _rel(o, ro)[0],
                                       _rel(m, rm, live)[0], _rel(l, rl)[0])
            if not bool((o[~live.T] == 0).all() and (l[~live] == 0).all()):
                raise AssertionError("64-row f32 K3: wholly masked rows not "
                                     "exactly zero")
            _f32_bwd_case(torch, F, worst, q, k, v, do, q_off, k_off, True,
                          stride, block=1000)
        worst["flash_attention"] = max(worst["flash_attention"], _rel(
            F.flash_attention(q, k, v, causal=True),
            F.flash_attention_reference(q, k, v, True))[0])
    torch.cuda.synchronize()
    bad = {n: r for n, r in worst.items() if not r <= FLASH_TOL["float32"]}
    if bad:
        raise AssertionError(f"ragged f32 flash kernels past "
                             f"{FLASH_TOL['float32']}: {bad}")
    return worst


def flash_ragged(torch, F):
    """The bf16 kernels at lengths that are no multiple of their tiles
    (their TMA boxes read zeros past the end, they mask keys past Lk and
    store no row past Lq): K3, K2 and K4 against their plain versions at
    FLASH_TOL, causal and not, D 64 and 128; and at D 64 with the
    default request, K4's two-warpgroup tiles (256/384).  Returns the
    worst relative error of each kernel."""
    worst = dict.fromkeys(FLASH_KERNELS, 0.0)
    for i, (lq, lk, d, causal) in enumerate(RAGGED):
        g = torch.Generator().manual_seed(200 + i)
        q, k, v, do = (torch.randn((n, 3, d), generator=g).to(
            DEVICE, torch.bfloat16) for n in (lq, lk, lk, lq))
        o, m, l = F.flash_block(q, k, v, 0, 0, causal=causal)
        ro, rm, rl = F.flash_block_reference(q, k, v, 0, 0, causal)
        out = F.flash_attention(q, k, v, causal=causal)
        out_ref, lse = F._row_stats(ro, rm, rl)
        delta = F._delta(do, out_ref.to(torch.bfloat16))
        got = F.flash_block_bwd(q, k, v, do, lse, delta, causal=causal)
        want = F.flash_block_bwd_reference(q, k, v, do, lse, delta, 0, 0,
                                           causal)
        errs = {"flash_block": max(_rel(o, ro)[0], _rel(m, rm)[0],
                                   _rel(l, rl)[0]),
                "flash_attention": _rel(
                    out, F.flash_attention_reference(q, k, v, causal))[0],
                "flash_block_bwd_dq": _rel(got[0], want[0])[0],
                "flash_block_bwd_dkv": max(_rel(got[1], want[1])[0],
                                           _rel(got[2], want[2])[0])}
        for n, r in errs.items():
            worst[n] = max(worst[n], r)
    torch.cuda.synchronize()
    bad = {n: r for n, r in worst.items() if not r <= FLASH_TOL["bfloat16"]}
    if bad:
        raise AssertionError(f"ragged bf16 flash kernels past "
                             f"{FLASH_TOL['bfloat16']}: {bad}")
    return worst


def phase_flash_kernels(torch, F, tuning):
    """Every case of phase 4; returns per-kernel max abs error and the
    flagship-shape inputs."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for d in (64, 128):
            for causal in (False, True):
                cases.append((f"{dtype}_d{d}_{'causal' if causal else 'full'}",
                              dict(lq=256, lk=256, h=4, d=d, dtype=dtype,
                                   causal=causal, bq=64, bk=32)))
        for causal in (False, True):
            for off in ((0, 0, 1), (16, 32, 1), (2, 5, 8)):
                cases.append((f"{dtype}_off{off}_{causal}",
                              dict(lq=64, lk=64, h=8, d=64, dtype=dtype,
                                   causal=causal, q_off=off[0],
                                   k_off=off[1], stride=off[2], bq=16,
                                   bk=16)))
        cases.append((f"{dtype}_lq64_lk192", dict(
            lq=64, lk=192, h=4, d=128, dtype=dtype, causal=False, bq=32,
            bk=64)))
        # rows 0-39 see no key: k_off 40 puts every key after them
        cases.append((f"{dtype}_masked_rows", dict(
            lq=64, lk=64, h=4, d=64, dtype=dtype, causal=True, k_off=40,
            bq=16, bk=16)))
    err = {n: 0.0 for n in FLASH_KERNELS}
    worst = {n: 0.0 for n in FLASH_KERNELS}
    by_dtype = {"float32": 0.0, "bfloat16": 0.0}
    for i, (name, kw) in enumerate(cases):
        errs, _ = flash_case(torch, F, name, seed=i, **kw)
        for n, (r, a) in errs.items():
            err[n] = max(err[n], a)
            worst[n] = max(worst[n], r)
            by_dtype[kw["dtype"]] = max(by_dtype[kw["dtype"]], r)
    # the flagship's shape: batch 4 x 8 heads folded, seq 4096, D 128
    flag = dict(lq=4096, lk=4096, h=32, d=128, dtype="bfloat16",
                causal=True)
    errs, inputs = flash_case(torch, F, "flagship", seed=99, **flag)
    for n, (r, a) in errs.items():
        err[n] = max(err[n], a)
        worst[n] = max(worst[n], r)
    q, k, v, do, lse, delta = inputs
    ragged = flash_ragged(torch, F)
    ragged_f32 = flash_ragged_f32(torch, F)
    # no atomics: a second run gives the same bits
    again = (F.flash_block(q, k, v, 0, 0, causal=True),
             F.flash_block_bwd(q, k, v, do, lse, delta, causal=True,
                               block_q=1024, block_k=1024))
    first = (F.flash_block(q, k, v, 0, 0, causal=True),
             F.flash_block_bwd(q, k, v, do, lse, delta, causal=True,
                               block_q=1024, block_k=1024))
    bitwise = all(torch.equal(a, b) for x, y in zip(again, first)
                  for a, b in zip(x, y))
    # and the f32 kernels, K3, K2 and K4, at longctx's L4096 x 8 x 128
    g = torch.Generator().manual_seed(98)
    qf, kf, vf, dof = (torch.randn((4096, 8, 128), generator=g).to(DEVICE)
                       for _ in range(4))
    ro, rm, rl = F.flash_block_reference(qf, kf, vf, 0, 0, True)
    out_f, lse_f = F._row_stats(ro, rm, rl)
    delta_f = F._delta(dof, out_f)
    runs = [(*F.flash_block(qf, kf, vf, 0, 0, causal=True),
             F.flash_attention(qf, kf, vf, causal=True),
             *F.flash_block_bwd(qf, kf, vf, dof, lse_f, delta_f,
                                causal=True, block_q=1024, block_k=1024))
            for _ in range(2)]
    bitwise_f32 = all(torch.equal(a, b) for a, b in zip(*runs))
    del qf, kf, vf, dof, ro, rm, rl, out_f, lse_f, delta_f, runs
    # the shared-memory model in Python is the kernels' own
    fwd_t = F._blocks(q, k, ("fwd",), 1024, 1024)
    bwd_t = F._bwd_tiles(q, k, 1024, 1024)  # {"dq": pair, "dkv": pair}
    lib_f, lib_b = F._library("flash_attention"), F._library(
        "flash_attention_bwd")
    model = {
        "fwd": (tuning.smem_bytes("fwd", *fwd_t, 128, 2),
                lib_f.flash_fwd_smem_bytes(2, *fwd_t, 128)),
        # the f32 forward's four tiles (q-units of 32 or 64 rows, k-tiles
        # of head_dim keys)
        **{f"fwd_f32_{bq}x{d}": (tuning.smem_bytes("fwd", bq, d, d, 4),
                                 lib_f.flash_fwd_smem_bytes(4, bq, d, d))
           for bq in F.FWD_F32_Q_SIDES for d in (64, 128)},
        "dq": (tuning.smem_bytes("dq", *bwd_t["dq"], 128, 2),
               lib_b.flash_bwd_smem_bytes(0, 2, *bwd_t["dq"], 128)),
        "dkv": (tuning.smem_bytes("dkv", *bwd_t["dkv"], 128, 2),
                lib_b.flash_bwd_smem_bytes(1, 2, *bwd_t["dkv"], 128)),
        # the f32 backward's eight (two tiles a kernel and head_dim)
        **{f"{kind}_f32_{bq}x{bk}": (
            tuning.smem_bytes(kind, bq, bk, d, 4),
            lib_b.flash_bwd_smem_bytes(int(kind == "dkv"), 4, bq, bk, d))
           for d in (64, 128)
           for kind, tiles in F._bwd_legal(torch.float32, d).items()
           for bq, bk in sorted(tiles)},
    }
    emit({"phase": "flash_vs_plain", "cases": len(cases) + 1,
          "tolerance_rel": FLASH_TOL, "max_rel_err": worst,
          "max_rel_err_by_dtype": by_dtype,
          "max_abs_err": err, "flagship_rel_err": {
              n: r for n, (r, _) in errs.items()},
          "flagship_bitwise_repeat": bitwise,
          "f32_bitwise_repeat_L4096": bitwise_f32,
          "ragged_rel_err": ragged, "ragged_f32_rel_err": ragged_f32,
          "tiles_fwd": fwd_t,
          "tiles_bwd": bwd_t, "smem_model_vs_kernel": model})
    if not (bitwise and bitwise_f32):
        raise AssertionError(f"flash kernels: two runs differ in bits "
                             f"(bf16 flagship equal: {bitwise}; f32 K3/K2/K4 "
                             f"at L4096 equal: {bitwise_f32})")
    if any(a != b for a, b in model.values()):
        raise AssertionError(f"shared-memory model differs: {model}")
    return err, inputs, fwd_t, bwd_t


def phase_flash_time(torch, F, timing, spec, inputs, fwd_t, bwd_t):
    """Each flash kernel at the flagship shape, L2 flushed before every
    launch: kernel, plain and SDPA ms, and the bound."""
    q, k, v, do, lse, delta = inputs
    lq, h, d = q.shape
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)

    def t(fn):
        return timing.cuda_time_ms(fn, reps=10, before=flush.zero_)

    kern = {
        "flash_block": t(lambda: F._launch_fwd(
            q, k, v, 0, 0, True, d**-0.5, *fwd_t, 1, emit_stats=True)),
        "flash_attention": t(lambda: F._launch_fwd(
            q, k, v, 0, 0, True, d**-0.5, *fwd_t, 1, emit_stats=False)),
    }
    for name in ("dq", "dkv"):
        kern[f"flash_block_bwd_{name}"] = t(lambda name=name: F._launch_bwd(
            q, k, v, do, lse, delta, 0, 0, True, d**-0.5, bwd_t, 1,
            kernels=(name,)))
    plain_fwd = t(lambda: F.flash_block_reference(q, k, v, 0, 0, True))
    plain = {
        "flash_block": plain_fwd,
        "flash_attention": t(lambda: F.flash_attention_reference(
            q, k, v, True)),
    }
    plain_bwd = t(lambda: F.flash_block_bwd_reference(
        q, k, v, do, lse, delta, 0, 0, True))
    # the library yardstick on the same inputs, [1, BH, L, D] views
    sdpa = torch.nn.functional.scaled_dot_product_attention
    views = [a.transpose(0, 1)[None] for a in (q, k, v)]
    lib_fwd = t(lambda: sdpa(*views, is_causal=True))
    qh, kh, vh = (a.detach().requires_grad_(True) for a in views)
    out = sdpa(qh, kh, vh, is_causal=True)
    doh = do.transpose(0, 1)[None]
    lib_bwd = t(lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True))
    # bound: visible (query, key) pairs of the causal square
    pairs = h * lq * (lq + 1) // 2
    io = q.numel() * q.element_size()  # one [L, BH, D] bf16 tensor
    stats = h * lq * 4
    work = {  # kernel -> (bytes in + out, flops)
        "flash_block": (3 * io + 2 * io + 2 * stats, 2 * 2 * d * pairs),
        "flash_attention": (4 * io, 2 * 2 * d * pairs),
        "flash_block_bwd_dq": (4 * io + 2 * stats + 2 * io,
                               3 * 2 * d * pairs),
        "flash_block_bwd_dkv": (4 * io + 2 * stats + 4 * io,
                                4 * 2 * d * pairs),
    }
    rows = {}
    for name, (nbytes, flops) in work.items():
        bytes_ms = nbytes / (spec["hbm_gbps"] * 1e9) * 1e3
        ops_ms = flops / (spec["bf16_tflops"] * 1e12) * 1e3
        bwd = name.startswith("flash_block_bwd")
        rows[name] = {
            "ms": kern[name],
            "plain_ms": plain_bwd if bwd else plain[name],
            "library_ms": lib_bwd if bwd else lib_fwd,
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
    # every tile pair the bf16 forward takes (the default, the 1024 x
    # 1024 request's, is the largest), and every pair of each bf16
    # backward kernel (one or two consumer warpgroups)
    sweep = {"fwd": {}, "dq": {}, "dkv": {}}
    for tiles in itertools.product(F.FWD_BF16_SIDES, repeat=2):
        sweep["fwd"][str(tiles)] = t(lambda tiles=tiles: F._launch_fwd(
            q, k, v, 0, 0, True, d**-0.5, *tiles, 1, emit_stats=True))
    for side in F.BWD_BF16_SIDES:
        for name, tiles in (("dq", (side, F.BWD_STREAM)),
                            ("dkv", (F.BWD_STREAM, side))):
            sweep[name][str(tiles)] = t(
                lambda name=name, tiles=tiles: F._launch_bwd(
                    q, k, v, do, lse, delta, 0, 0, True, d**-0.5,
                    {name: tiles}, 1, kernels=(name,)))
    emit({"phase": "flash_tiles", "ms_by_tile": sweep,
          "chosen": {"fwd": fwd_t, "bwd": bwd_t}})
    emit({"phase": "flash_time", "shape": f"BH{h} L{lq} D{d} bf16 causal, "
          "L2 flushed", "tiles_fwd": fwd_t, "tiles_bwd": bwd_t,
          "k4_ms": kern["flash_block_bwd_dq"] + kern["flash_block_bwd_dkv"],
          "note": "K4 plain_ms and library_ms cover dq, dk and dv together",
          **{n: r for n, r in rows.items()}})
    return rows


# -- phases 4 and 5: serving at full width ------------------------------------


def oracle_report(torch, mcfg, cfg, params, trace, got, mesh=None):
    """Per-request ids against the dense oracle (over ``mesh``: the
    same-mesh dense decoder, lengths padded up to a multiple of sp); for
    each request that differs, the oracle's top-2 relative logit margin
    at the first differing step."""
    from tpu_patterns_torch.models.lm import make_lm_decoder

    sp = mesh.dim("sp") if mesh is not None else 1
    lpd = cfg.max_prompt + (-cfg.max_prompt % sp)
    pre, gen = make_lm_decoder(mcfg, cfg.vocab, 1, lpd,
                               cfg.gen + (-cfg.gen % sp),
                               cache_int8=cfg.cache_int8, mesh=mesh)
    equal, flips = 0, []
    for r in trace:
        toks = torch.zeros((1, lpd), dtype=torch.int32)
        toks[0, : len(r.tokens)] = torch.tensor(r.tokens)
        lens = torch.tensor([len(r.tokens)], dtype=torch.int32)
        toks = (toks.to(DEVICE) if mesh is None
                else mesh.shard(toks, ("dp", "sp")))
        cache, t0, lg0 = pre(params, toks, lens, return_logits=True)
        _, ids, lgs = gen(params, cache, t0, (lens, 0), r.n_gen - 1,
                          return_logits=True)
        if mesh is not None:  # rank 0's ids, the vocab shards joined
            tp_ranks = mesh.group("tp", 0)
            t0, ids = t0[0], ids[0]
            lg0 = torch.cat([lg0[i] for i in tp_ranks], dim=-1)
            lgs = torch.cat([lgs[i] for i in tp_ranks], dim=-1)
        want = [int(t0[0])] + ids[0].tolist()
        if got[r.rid] == want:
            equal += 1
            continue
        k = next(i for i, (a, b_) in enumerate(zip(got[r.rid], want))
                 if a != b_)
        logits = torch.cat([lg0[:, None], lgs], dim=1)[0, k].float()
        top = logits.topk(2).values
        margin = float((top[0] - top[1]) / top[0].abs())
        flips.append({"rid": r.rid, "step": k, "rel_margin": margin,
                      "below_bf16_resolution": margin < BF16_RESOLUTION})
    return equal, flips


def serve_leg(torch, eng_mod, name, cfg, gate_flips=True, mesh=None,
              phase="serve"):
    """Serve ``cfg`` continuous and sequential through the engine (over
    ``mesh``: its sharded decoder).  The launch count is that of the
    timed continuous run alone (``serve_legs`` sets the kernel's count
    to 0 just before that run and reads it just after) and must equal
    depth x ranks x its decode steps.  With ``gate_flips`` an id flip
    against the oracle fails the leg unless the oracle's margin there is
    below bf16 resolution; without, flips are reported only (an int8
    pool also quantizes keys that the two paths computed in bf16 through
    different matmul shapes)."""
    # a tree of another commit (``--tree``) may predate the mesh argument
    mcfg, decoder, params, trace = (eng_mod.build_serve(cfg) if mesh is None
                                    else eng_mod.build_serve(cfg, mesh))
    ranks = mesh.size if mesh is not None else 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    legs = eng_mod.serve_legs(decoder, params, trace, cfg.slots)
    launches = legs.launches
    peak = torch.cuda.max_memory_allocated()
    steps = legs.engine.stats["steps"]
    total = sum(r.n_gen for r in trace)
    pool_mb, dense_mb = eng_mod.cache_mb(cfg, decoder)
    equal, flips = oracle_report(torch, mcfg, cfg, params, trace,
                                 legs.out_cont, mesh)
    row = {
        "phase": phase, "leg": name, "dtype": cfg.dtype,
        "kv_heads": cfg.kv_heads, "cache_int8": cfg.cache_int8,
        "requests": len(trace),
        "tokens_per_s": total / legs.cont_s,
        "sequential_tokens_per_s": total / legs.seq_s,
        "speedup": legs.seq_s / legs.cont_s,
        "decode_steps": steps, "kernel_launches": launches,
        "depth_x_steps": cfg.depth * steps,
        **({"mesh": list(mesh.shape), "ranks": ranks,
            "notes": _mesh_note(mesh)} if mesh is not None else {}),
        "pool_MB": pool_mb, "dense_cache_MB": dense_mb,
        "pool_in_place": legs.in_place,
        "max_memory_allocated_MB": peak / 1e6,
        "continuous_equals_sequential": legs.out_cont == legs.out_seq,
        "ids_sha256": hashlib.sha256(json.dumps(
            sorted(legs.out_cont.items())).encode()).hexdigest()[:16],
        "oracle_equal": equal, "oracle_flips": flips,
    }
    emit(row)
    bad = []
    if not row["speedup"] > 1.0:
        bad.append("continuous batching not faster than sequential")
    if steps == 0 or launches != cfg.depth * ranks * steps:
        bad.append(f"kernel launched {launches} times in the timed run, "
                   f"not depth x ranks x steps = "
                   f"{cfg.depth * ranks * steps}")
    if not (legs.in_place and pool_mb < dense_mb):
        bad.append("pool not in place or not under the dense rectangle")
    if gate_flips and any(not f["below_bf16_resolution"] for f in flips):
        bad.append("an id flip against the oracle above bf16 resolution")
    if bad:
        raise AssertionError(f"serve leg {name}: " + "; ".join(bad))
    return row


def _launch_widths(torch, eng_mod, pk, decoder, params, trace, slots, **kw):
    """The width W of every K1 launch of one run of ``trace`` through a
    fresh engine (``kw``: ``spec_k``, ``prefix_share``), as {W: count}
    (``_k1_widths``)."""
    with _k1_widths(pk) as widths:
        eng_mod.ServeEngine(decoder, params, slots=slots, **kw).run(
            [dataclasses.replace(r) for r in trace])
        torch.cuda.synchronize()
    return dict(widths)


def serve_spec_leg(torch, eng_mod, pk, cfg):
    """Speculative decoding at ``cfg``'s width on the repetitive trace
    (``spec_k`` drafts a row, prompt lookup), timed beside plain decode
    of the same trace through the same decoder (``engine.timed_run``).
    Gates: K1 launched depth x verify steps times in the timed spec
    run, every launch of one more run at W = spec_k + 1; accepted
    tokens per row-step >
    1.0; no leaked block; id flips against the dense oracle only where
    its top-2 margin is below bf16 resolution."""
    mcfg, decoder, params, _ = eng_mod.build_serve(cfg)
    trace = eng_mod.repetitive_trace(cfg)
    total = sum(r.n_gen for r in trace)
    out_s, spec_s, eng_s, _, launches = eng_mod.timed_run(
        decoder, params, trace, cfg.slots, spec_k=cfg.spec_k)
    out_p, plain_s, eng_p, _, plain_launches = eng_mod.timed_run(
        decoder, params, trace, cfg.slots)
    widths = _launch_widths(torch, eng_mod, pk, decoder, params, trace,
                            cfg.slots, spec_k=cfg.spec_k)
    st = eng_s.stats
    accepted = st["spec_tokens"] / st["spec_row_steps"]
    equal, flips = oracle_report(torch, mcfg, cfg, params, trace, out_s)
    row = {
        "phase": "serve", "leg": "spec", "dtype": cfg.dtype,
        "spec_k": cfg.spec_k, "requests": len(trace),
        "tokens_per_s": total / spec_s,
        "plain_tokens_per_s": total / plain_s,
        "spec_over_plain": plain_s / spec_s,
        "accepted_tokens_per_row_step": accepted,
        "verify_steps": st["spec_steps"], "plain_steps": eng_p.stats["steps"],
        "kernel_launches": launches,
        "depth_x_verify_steps": cfg.depth * st["spec_steps"],
        "launch_widths": widths,
        "plain_kernel_launches": plain_launches,
        "leaked_blocks": eng_s.leaked_blocks(),
        "spec_equals_plain": out_s == out_p,
        "oracle_equal": equal, "oracle_flips": flips,
    }
    emit(row)
    bad = []
    if st["spec_steps"] == 0 or launches != cfg.depth * st["spec_steps"]:
        bad.append(f"K1 launched {launches} times in the timed run, not "
                   f"depth x verify steps = {cfg.depth * st['spec_steps']}")
    if set(widths) != {cfg.spec_k + 1}:
        bad.append(f"K1 ran at widths {widths}, not W = {cfg.spec_k + 1}")
    if plain_launches != cfg.depth * eng_p.stats["steps"]:
        bad.append("plain decode's K1 launches are not depth x steps")
    if not accepted > 1.0:
        bad.append(f"accepted tokens per row-step {accepted} <= 1.0")
    if eng_s.leaked_blocks():
        bad.append("leaked blocks")
    if any(not f["below_bf16_resolution"] for f in flips):
        bad.append("an id flip against the oracle above bf16 resolution")
    if bad:
        raise AssertionError("serve spec leg: " + "; ".join(bad))
    return row


def serve_prefix_leg(torch, eng_mod, pk, cfg):
    """Prefix sharing at ``cfg``'s width on the shared trace (every
    prompt opens with the same ``shared_prefix`` tokens), shared and
    non-shared through the prefix-share Record's decoder (a pool that
    never defers), each timed (``engine.timed_run``).  Gates: fewer
    peak blocks shared than
    not, no leaked block, K1 launched depth x steps times in the timed
    shared run, id flips against the dense oracle only below bf16
    resolution."""
    mcfg, _, params, _ = eng_mod.build_serve(cfg)
    decoder = eng_mod.prefix_decoder(cfg, mcfg, params["wemb"].device)
    trace, s_len = eng_mod.shared_trace(cfg)
    total = sum(r.n_gen for r in trace)
    out_s, shared_s, eng_s, _, launches = eng_mod.timed_run(
        decoder, params, trace, cfg.slots, prefix_share=True)
    out_p, plain_s, eng_p, _, _ = eng_mod.timed_run(
        decoder, params, trace, cfg.slots)
    equal, flips = oracle_report(torch, mcfg, cfg, params, trace, out_s)
    st = eng_s.stats
    row = {
        "phase": "serve", "leg": "prefix", "dtype": cfg.dtype,
        "requests": len(trace), "shared_tokens": s_len,
        "tokens_per_s": total / shared_s,
        "nonshared_tokens_per_s": total / plain_s,
        "peak_blocks": st["peak_blocks"],
        "nonshared_peak_blocks": eng_p.stats["peak_blocks"],
        "block_savings": 1 - st["peak_blocks"] / eng_p.stats["peak_blocks"],
        "cow_copies": st["cow_copies"],
        "prefix_hit_blocks": st["prefix_hit_blocks"],
        "leaked_blocks": eng_s.leaked_blocks(),
        "decode_steps": st["steps"], "kernel_launches": launches,
        "depth_x_steps": cfg.depth * st["steps"],
        "shared_equals_nonshared": out_s == out_p,
        "oracle_equal": equal, "oracle_flips": flips,
    }
    emit(row)
    bad = []
    if not st["peak_blocks"] < eng_p.stats["peak_blocks"]:
        bad.append("sharing did not lower the peak blocks")
    if eng_s.leaked_blocks():
        bad.append("leaked blocks")
    if st["steps"] == 0 or launches != cfg.depth * st["steps"]:
        bad.append(f"K1 launched {launches} times, not depth x steps")
    if any(not f["below_bf16_resolution"] for f in flips):
        bad.append("an id flip against the oracle above bf16 resolution")
    if bad:
        raise AssertionError("serve prefix leg: " + "; ".join(bad))
    return row


def phase_profile(torch, eng_mod, timing, cfg, unprofiled_wall_s):
    """Device time of one continuous run of ``cfg``'s trace under
    torch.profiler: the device's busy and idle share against that same
    run's host wall (profiler overhead included), and the top kernels.
    ``unprofiled_wall_s`` (the timed serve run's wall, another run) is
    printed beside it with the idle share it would give."""
    from torch.profiler import ProfilerActivity, profile

    _, decoder, params, trace = eng_mod.build_serve(cfg)
    eng = eng_mod.ServeEngine(decoder, params, slots=cfg.slots)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = timing.clock_ns()
        eng.run([dataclasses.replace(r) for r in trace])
        torch.cuda.synchronize()
        wall_s = (timing.clock_ns() - t0) / 1e9

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies, memsets): a host op's own
    # device time repeats that of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_s = _profile_breakdown(prof, "the profile")["busy_ms"] / 1e3
    k1_s = sum(dev_us(e) for e in events
               if "paged_attention" in e.key) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:6]
    emit({
        "phase": "profile", "leg": cfg.dtype, "wall_s": wall_s,
        "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall_s,
        "unprofiled_wall_s": unprofiled_wall_s,
        "idle_share_vs_unprofiled_wall": 1 - busy_s / unprofiled_wall_s,
        "paged_attention_share_of_busy": k1_s / busy_s,
        "device_kernels": sum(e.count for e in events),
        "decode_steps": eng.stats["steps"],
        "top_device": [
            {"name": e.key[:60], "ms": dev_us(e) / 1e3, "calls": e.count}
            for e in top
        ],
    })


# -- phases 7 and 8: the flagship train step ---------------------------------


def phase_flagship(torch, F, fl):
    """``run_flagship`` at its full default width through the kernels,
    with the flash launch counts of that run, then with dense attention.
    Returns the kernel run's row (launches by kernel)."""
    rows = {}
    for attn in ("kernel", "dense"):
        cfg = fl.FlagshipConfig(attn=attn, device=DEVICE)
        F.reset_launches()
        rec, = fl.run_flagship(cfg)
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
        steps = rec.config["train_steps"]
        row = {"phase": "flagship", "attn": attn,
               "verdict": rec.verdict.value, "train_steps": steps,
               "launches": launches, **rec.metrics, "config": rec.config,
               "notes": rec.notes}
        emit(row)
        want = ({"flash_attention": 0, "flash_block": cfg.depth * steps,
                 "flash_block_bwd_dq": cfg.depth * steps,
                 "flash_block_bwd_dkv": cfg.depth * steps}
                if attn == "kernel" else dict.fromkeys(launches, 0))
        if not rec.verdict or launches != want:
            raise AssertionError(
                f"flagship {attn}: verdict {rec.verdict.value} "
                f"({rec.notes}); launches {launches}, want {want}"
            )
        rows[attn] = row
    return rows


def _flagship_model(fl, tr, **kw):
    """The flagship's default width as a ModelConfig, and its x shape."""
    d = fl.FlagshipConfig()
    cfg = tr.ModelConfig(embed=d.embed, heads=d.heads, head_dim=d.head_dim,
                         mlp_mult=d.mlp_mult, causal=d.causal,
                         block_q=d.block_q, block_k=d.block_k, **kw)
    return cfg, (d.batch, d.seq, d.embed)


def phase_flagship_profile(torch, timing, fl, tr, unprofiled_step_s):
    """One full-width bf16 flagship step under torch.profiler: device
    busy time and idle share against that step's own wall (profiler
    overhead included), and each flash kernel's share of busy time.
    ``unprofiled_step_s`` (``run_flagship``'s step time, another run) is
    printed beside it with the idle share it would give."""
    from torch.profiler import ProfilerActivity, profile

    cfg, shape = _flagship_model(fl, tr, dtype="bfloat16", attn="kernel")
    params = tr.init_params(torch.Generator().manual_seed(0), cfg, DEVICE)
    x = torch.randn(shape, device=DEVICE, dtype=torch.bfloat16)
    step = tr.make_train_step(None, cfg, lr=1e-30)
    step(params, x)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = timing.clock_ns()
        step(params, x)
        torch.cuda.synchronize()
        wall_s = (timing.clock_ns() - t0) / 1e9

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_s = _profile_breakdown(prof, "the flagship profile")["busy_ms"] / 1e3
    share = {}  # the flagship is bf16: its forward is the wgmma kernel
    for key in ("flash_fwd_wgmma_kernel", "flash_bwd_wgmma_dq_kernel",
                "flash_bwd_wgmma_dkv_kernel"):
        share[key] = sum(dev_us(e) for e in events if key in e.key) / 1e6 \
            / busy_s
    top = sorted(events, key=dev_us, reverse=True)[:8]
    emit({"phase": "flagship_profile", "wall_s": wall_s,
          "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall_s,
          "unprofiled_step_s": unprofiled_step_s,
          "idle_share_vs_unprofiled_step": 1 - busy_s / unprofiled_step_s,
          "share_of_busy": share, "flash_share_of_busy": sum(share.values()),
          "device_kernels": sum(e.count for e in events),
          "top_device": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                          "calls": e.count} for e in top]})


def phase_flagship_exact(torch, F, fl, tr):
    """Float32, TF32 off, full width: one train step through the kernels
    against the same step through attention_reference; then one forward
    without a gradient, which runs K2."""
    cfgs = {}
    for a in ("kernel", "dense"):
        cfgs[a], shape = _flagship_model(fl, tr, dtype="float32", attn=a)
    params = tr.init_params(torch.Generator().manual_seed(0),
                            cfgs["dense"], DEVICE)
    x = torch.randn(shape,
                    generator=torch.Generator().manual_seed(1)).to(DEVICE)
    out = {a: tr.make_train_step(None, c, lr=1e-2)(params, x)
           for a, c in cfgs.items()}
    loss_k, loss_d = float(out["kernel"][1]), float(out["dense"][1])
    upd_err, upd_norm_err = {}, {}
    for name, p in params.items():
        dk = p - out["kernel"][0][name]
        dd = p - out["dense"][0][name]
        upd_err[name] = float((dk - dd).abs().max() / dd.abs().max())
        upd_norm_err[name] = float((dk - dd).norm() / dd.norm())
    layer = {k: p[0] for k, p in params.items()}
    F.reset_launches()
    with torch.no_grad():
        yk = tr.forward_shard(layer, x, cfgs["kernel"])
        launches = dict(F.LAUNCHES)
        yd = tr.forward_shard(layer, x, cfgs["dense"])
    fwd_err = float((yk - yd).abs().max() / yd.abs().max())
    row = {"phase": "flagship_exact_f32",
           "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "loss_kernel": loss_k, "loss_dense": loss_d,
           "loss_rel_err": abs(loss_k - loss_d) / abs(loss_d),
           "update_rel_err": upd_err, "update_norm_rel_err": upd_norm_err,
           "no_grad_forward_rel_err": fwd_err,
           "no_grad_launches": launches,
           "tolerance": {"loss_rtol": FLAGSHIP_LOSS_RTOL,
                         "update": FLAGSHIP_UPDATE_TOL,
                         "forward": FLASH_TOL["float32"]}}
    emit(row)
    bad = []
    if not row["loss_rel_err"] <= FLAGSHIP_LOSS_RTOL:
        bad.append("loss")
    bad += [n for n, e in upd_err.items() if not e <= FLAGSHIP_UPDATE_TOL]
    if not fwd_err <= FLASH_TOL["float32"]:
        bad.append("no-grad forward")
    if launches != {"flash_attention": 1, "flash_block": 0,
                    "flash_block_bwd_dq": 0, "flash_block_bwd_dkv": 0}:
        bad.append(f"no-grad launches {launches}")
    if bad:
        raise AssertionError(f"flagship f32 exactness: {bad}")
    return launches


# -- phase 8b: the resumable train loop ---------------------------------------

# the flagship's width at the serve model's depth (TrainLoopConfig fields)
TRAIN_WIDTH = dict(embed=1024, heads=8, head_dim=128, mlp_mult=4, seq=4096,
                   batch=4, dtype="bfloat16", causal=True, attn="kernel",
                   depth=4, lr=1e-4)
TRAIN_FAULT = "train.step:nan:step=2"  # the halt leg's spec


def _loop(tl, work, name, **kw):
    """One ``train`` call at :data:`TRAIN_WIDTH` into ``work/name``; its
    Records go to a JSON-lines file (markers to a buffer).  Returns the
    loop's result and its Records."""
    from tpu_patterns_torch.core.results import ResultWriter

    jsonl = os.path.join(work, name + ".jsonl")
    writer = ResultWriter(jsonl_path=jsonl, stream=io.StringIO())
    cfg = tl.TrainLoopConfig(**TRAIN_WIDTH, ckpt_dir=os.path.join(work, name),
                             **kw)
    out = tl.train(cfg, writer, device=DEVICE)
    with open(jsonl) as f:
        return out, [json.loads(ln) for ln in f if ln.strip()]


def _same_state(torch, a, b) -> bool:
    """Every leaf of two checkpoint trees equal byte for byte."""
    if a["params"].keys() != b["params"].keys():
        return False
    return int(a["step"]) == int(b["step"]) and all(
        torch.equal(a["params"][k].view(torch.int16),
                    b["params"][k].view(torch.int16)) for k in a["params"])


def phase_train_loop(torch, F, tl, faults, tc, flagship_step_ms):
    """The train loop at the flagship's width, depth 4, through K3/K4:
    a straight run, a kill and an async resume, native data killed and
    resumed, the non-finite halt, and ``ckpt`` on the straight run's
    directory.  Returns the straight run's flash launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="train_loop_",
                            dir=os.path.join(ROOT, "build"))
    depth, steps = TRAIN_WIDTH["depth"], 8
    fail = []
    try:
        # 1. straight: 8 steps, a checkpoint every 2 (keep 2), K3/K4 counted
        t0 = time.perf_counter()
        F.reset_launches()
        a, recs = _loop(tl, work, "a", steps=steps, ckpt_every=2, keep=2,
                        log_every=2)
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
        wall_a = time.perf_counter() - t0
        final = recs[-1]
        logged = [r for r in recs if r["pattern"] == "train_step"]
        want = {"flash_attention": 0, "flash_block": depth * steps,
                "flash_block_bwd_dq": depth * steps,
                "flash_block_bwd_dkv": depth * steps}
        m = final["metrics"]
        loop_ms = 1e3 / m["steps_per_s"] if m["steps_per_s"] else None
        emit({"phase": "train_loop", "leg": "straight", "steps": steps,
              "width": TRAIN_WIDTH, "verdict": final["verdict"],
              "final_loss": a["loss"], "launches": launches,
              "steps_per_s": m["steps_per_s"],
              "tokens_per_s": m["tokens_per_s"],
              "model_tflops_per_s": m["model_tflops_per_s"],
              "step_ms": loop_ms,
              "step_ms_per_layer": loop_ms and loop_ms / depth,
              "flagship_step_ms_depth1": flagship_step_ms,
              "train_step_records": [(r["metrics"]["step"],
                                      r["metrics"]["steps_per_s"])
                                     for r in logged],
              "wall_s": wall_a})
        if final["verdict"] != "SUCCESS" or len(logged) != 4:
            fail.append(f"straight: {final['verdict']}, "
                        f"{len(logged)} train_step Records")
        if launches != want:
            fail.append(f"straight launches {launches}, want {want}")

        # the same 8 steps with no checkpoint and no log: the loop's rate
        # without its saves and fences
        r, recs = _loop(tl, work, "rate", steps=steps)
        m = recs[-1]["metrics"]
        emit({"phase": "train_loop", "leg": "no_ckpt",
              "steps_per_s": m["steps_per_s"],
              "tokens_per_s": m["tokens_per_s"],
              "model_tflops_per_s": m["model_tflops_per_s"],
              "step_ms": 1e3 / m["steps_per_s"],
              "flagship_step_ms_depth1": flagship_step_ms,
              "bit_equal_to_straight": _same_state(torch, a["state"],
                                                   r["state"])})
        if not _same_state(torch, a["state"], r["state"]):
            fail.append("no-checkpoint run differs from the straight run")
        del r

        # 2. kill after 4, resume to 8 with the async saver
        _loop(tl, work, "b", steps=4, ckpt_every=2, keep=2)
        b, recs = _loop(tl, work, "b", steps=steps, ckpt_every=2, keep=2,
                        resume=True, ckpt_async=True)
        same = _same_state(torch, a["state"], b["state"])
        emit({"phase": "train_loop", "leg": "kill_resume_async",
              "start_step": b["start_step"], "final_loss": b["loss"],
              "loss_equal": b["loss"] == a["loss"], "bit_equal": same,
              "verdict": recs[-1]["verdict"],
              "steps_per_s": recs[-1]["metrics"]["steps_per_s"]})
        if not (b["start_step"] == 4 and b["loss"] == a["loss"] and same):
            fail.append(f"kill/resume: start {b['start_step']}, loss "
                        f"{b['loss']} vs {a['loss']}, bit_equal {same}")
        del b

        # 3. native data: straight 4 steps against killed at 2 and resumed
        c, _ = _loop(tl, work, "c", steps=4, ckpt_every=2, data="native")
        _loop(tl, work, "d", steps=2, ckpt_every=2, data="native")
        d, recs = _loop(tl, work, "d", steps=4, ckpt_every=2, data="native",
                        resume=True)
        same = _same_state(torch, c["state"], d["state"])
        emit({"phase": "train_loop", "leg": "native_resume",
              "start_step": d["start_step"], "final_loss": d["loss"],
              "loss_equal": d["loss"] == c["loss"], "bit_equal": same,
              "verdict": recs[-1]["verdict"]})
        if not (d["start_step"] == 2 and d["loss"] == c["loss"] and same
                and math.isfinite(c["loss"])):
            fail.append(f"native resume: start {d['start_step']}, loss "
                        f"{d['loss']} vs {c['loss']}, bit_equal {same}")
        del c, d

        # 4. halt: NaN injected at step 2, checked every step
        faults.configure(TRAIN_FAULT)
        try:
            e, recs = _loop(tl, work, "e", steps=4, ckpt_every=2,
                            nonfinite_every=1)
        finally:
            faults.configure(None)
        warn = [r for r in recs if r["mode"] == "nonfinite"]
        committed = tc.available_steps(os.path.join(work, "e"))
        emit({"phase": "train_loop", "leg": "halt", "fault": TRAIN_FAULT,
              "verdict": recs[-1]["verdict"], "notes": recs[-1]["notes"],
              "nonfinite_warnings": [w["metrics"]["step"] for w in warn],
              "committed": committed})
        if (recs[-1]["verdict"] != "FAILURE"
                or [w["metrics"]["step"] for w in warn] != [2.0]
                or committed != [2]):
            fail.append(f"halt: {recs[-1]['verdict']}, warnings "
                        f"{len(warn)}, committed {committed}")

        # 5. `ckpt` on the straight run's directory, as a user runs it
        r = subprocess.run(
            [sys.executable, "-m", "tpu_patterns_torch", "ckpt",
             os.path.join(work, "a"), "--leaves"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        heads = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("step_")]
        n_leaves = len(a["state"]["params"]) + 1  # + the step
        emit({"phase": "train_loop", "leg": "ckpt_cli", "rc": r.returncode,
              "steps": heads, "want_leaves": n_leaves,
              "phase_seconds": time.perf_counter() - t_phase})
        if (r.returncode != 0 or len(heads) != 2
                or not heads[0].startswith("step_6:")
                or not heads[1].startswith("step_8:")
                or any(f", {n_leaves} leaves" not in h for h in heads)):
            fail.append(f"ckpt CLI: rc {r.returncode}: {r.stdout}{r.stderr}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if fail:
        raise AssertionError(f"train loop: {fail}")
    return launches


# -- phase 9: the one-sided put ----------------------------------------------


def _put_input(torch, shape, dtype, seed, offset=0):
    """Random bits of ``dtype`` on the card; with ``offset``, a view that
    starts ``offset`` elements into a larger buffer (contiguous, but not
    16-byte aligned)."""
    g = torch.Generator().manual_seed(seed)
    n = int(torch.Size(shape).numel())
    raw = torch.randint(-100, 100, (n + offset,), generator=g)
    return raw.to(dtype).to(DEVICE)[offset:].view(shape)


def phase_put_vs_plain(torch, op):
    """Every put kernel against its plain version, bit for bit."""
    lib = op._library()
    if lib.local_put_stage_bytes() != op.STAGE_BYTES:
        raise AssertionError("local_put.cu STAGE_BYTES differs from "
                             "onesided.STAGE_BYTES")
    # K8a's plan: the kernel's span is its Python mirror's, on this card
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan_ns = (1, 15, 16, 17, 4096, 16385, 1_000_003,
               PUT_FULL[0] * PUT_FULL[1] * 4)
    spans = {n: lib.local_put_mono_span(n, sms) for n in plan_ns}
    if any(spans[n] != op.mono_span(n, sms) for n in plan_ns):
        raise AssertionError(f"local_put.cu mono_span differs from "
                             f"onesided.mono_span: {spans}")
    # K8c's plan likewise, at the full buffer in 1-200 chunks and at the
    # small cases' chunks
    n_full = PUT_FULL[0] * PUT_FULL[1] * 4
    multi_plans = [(n_full // c, c) for c in (1, 3, 8, 200)] + [
        (1, 1), (16, 200), (97 * 512 * 4, 1), (300 * 1001, 3)]
    multi = {f"{cb}x{c}": lib.local_put_multi_span(cb, c, sms)
             for cb, c in multi_plans}
    if any(multi[f"{cb}x{c}"] != op.multi_span(cb, c, sms)
           for cb, c in multi_plans):
        raise AssertionError(f"local_put.cu multi_span differs from "
                             f"onesided.multi_span: {multi}")
    multi_blocks = len(op.multi_spans(n_full // 8, 8, sms))
    if multi_blocks != 8 * (sms // 8):
        raise AssertionError(f"K8c takes {multi_blocks} blocks at the full "
                             f"buffer in 8 chunks, not {8 * (sms // 8)}")
    # K8d's plan: each chunk's half cut by the C side's multi span of the
    # half bytes, at the full buffer and the small cases' shapes
    inplace = {}
    for rows, row_bytes, c in ((PUT_FULL[0], PUT_FULL[1] * 4, 8),
                               (2, 2048, 8), (97, 2048, 3), (97, 37 * 4, 8),
                               (300, 1001, 200), (16, 400, 1)):
        n_chunks, chunk_rows, half = op._inplace_plan(rows, c)
        span = lib.local_put_multi_span(half * row_bytes, n_chunks, sms)
        spans = op.inplace_spans(rows, row_bytes, c, sms)
        per = -(-half * row_bytes // span)
        lens = [stop - src for src, _, stop in spans]
        if len(spans) != n_chunks * per or any(
                ln != span for i, ln in enumerate(lens) if i % per != per - 1):
            raise AssertionError(f"onesided.inplace_spans differs from "
                                 f"local_put.cu's span {span} at rows "
                                 f"{rows} x {row_bytes} B, chunks {c}")
        inplace[f"{rows}x{row_bytes}Bx{c}"] = span
    inplace_blocks = len(op.inplace_spans(PUT_FULL[0], PUT_FULL[1] * 4, 8,
                                          sms))
    if inplace_blocks != 8 * (sms // 8):
        raise AssertionError(f"K8d takes {inplace_blocks} blocks at the full "
                             f"buffer in 8 chunks, not {8 * (sms // 8)}")
    # K8b's grid: one block a piece of a tile, as the wrapper cuts the
    # tiles
    streamed = {}
    for rows, row_bytes in ((PUT_FULL[0], PUT_FULL[1] * 4), (97, 37 * 4),
                            (97, 37), (300, 1001 * 4), (16, 100 * 4),
                            (4, 40_000 * 4)):
        for br in (1, 4, 1024):
            tile_rows = op.streamed_block_rows(rows, row_bytes, br)
            grid = lib.local_put_streamed_grid(rows // tile_rows,
                                               tile_rows * row_bytes)
            if grid != len(op.streamed_pieces(rows, row_bytes, br)):
                raise AssertionError(f"onesided.streamed_pieces differs "
                                     f"from local_put.cu's grid {grid} at "
                                     f"rows {rows} x {row_bytes} B, br {br}")
            streamed[f"{rows}x{row_bytes}Bxbr{br}"] = grid
    cases = 0

    def same(name, got, want):
        nonlocal cases
        cases += 1
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"put kernel differs from its plain "
                                 f"version: {name}")

    def all_puts(tag, x):
        same(f"{tag} mono", op.local_put(x), op.local_put_reference(x))
        for br in (1, 4, 1024):
            same(f"{tag} streamed br{br}", op.local_put_streamed(x, br),
                 op.local_put_reference(x))
        for c in (1, 3, 8, 200):
            same(f"{tag} multi c{c}", op.local_put_multi(x, c),
                 op.local_put_reference(x))
            same(f"{tag} inplace c{c}", op.local_put_inplace(x.clone(), c),
                 op.local_put_inplace_reference(x.clone(), c))

    dtypes = (torch.float32, torch.bfloat16, torch.int32, torch.int8)
    # (300, 1001): segments of several stages with unaligned tails, and
    # streamed tiles at unaligned offsets (16-byte heads)
    shapes = ((0, 512), (1, 512), (2, 512), (97, 512), (16, 100), (97, 37),
              (300, 1001))
    for i, dt in enumerate(dtypes):
        for j, shape in enumerate(shapes):
            all_puts(f"{dt} {shape}", _put_input(torch, shape, dt, 10 * i + j))
        # one element in: a source not 16-byte aligned; (97, 37) copies
        # bytewise, (400, 512) in place keeps bulk copies behind a head
        for shape in ((97, 37), (400, 512)):
            all_puts(f"{dt} {shape} at offset 1",
                     _put_input(torch, shape, dt, 99, offset=1))
    full = _put_input(torch, PUT_FULL, torch.float32, 7)
    same("full mono", op.local_put(full), full)
    same("full streamed", op.local_put_streamed(full, 1024), full)
    same("full multi", op.local_put_multi(full, 8), full)
    same("full inplace", op.local_put_inplace(full.clone(), 8),
         op.local_put_inplace_reference(full.clone(), 8))
    torch.cuda.synchronize()
    emit({"phase": "put_vs_plain", "cases": cases, "bit_exact": True,
          "dtypes": [str(d) for d in dtypes], "shapes": [*shapes, PUT_FULL],
          "stage_bytes": op.STAGE_BYTES, "sms": sms,
          "mono_span_by_bytes": spans,
          "multi_span_by_chunk_bytes_x_chunks": multi,
          "multi_blocks_full_8_chunks": multi_blocks,
          "inplace_span_by_rows_x_row_bytes_x_chunks": inplace,
          "inplace_blocks_full_8_chunks": inplace_blocks,
          "streamed_grid_by_rows_x_row_bytes_x_block_rows": streamed})
    return cases


def phase_put_time(torch, op, ck, cb, timing, spec):
    """Each put kernel at the full buffer (188.7 MB float32, 3.8x the L2,
    so no flush): kernel, plain and one ``copy_`` call's ms (each the
    median of 5 readings of 10 calls, an event pair around each), the
    kernel's and the library call's device ms with no host gaps
    (:func:`_queued_stats`), and the byte bound (each byte moved read
    once and written once).  Beside them K7's copy-only launch of the
    same buffer, queued: its copy blocks run the bulk-copy code of K8a,
    K8c and K8d (``bulk_copy.cuh``), so ``--tree`` sets it beside the
    parent's too."""
    x = _put_input(torch, PUT_FULL, torch.float32, 7)
    nbytes = x.numel() * x.element_size()
    n_chunks, chunk_rows, half = op._inplace_plan(PUT_FULL[0], 8)
    moved = {"local_put": nbytes, "local_put_streamed": nbytes,
             "local_put_multi": nbytes,
             "local_put_inplace": n_chunks * half * PUT_FULL[1] * 4}
    buf = x.clone()
    out = torch.empty_like(x)
    view = buf.view(n_chunks, chunk_rows, PUT_FULL[1])

    def t(fn):
        return timing.cuda_time_repeated_ms(fn, reps=10, warmup=2)["ms"]

    calls = {
        "local_put": lambda: op.local_put(x),
        "local_put_streamed": lambda: op.local_put_streamed(x, 1024),
        "local_put_multi": lambda: op.local_put_multi(x, 8),
        "local_put_inplace": lambda: op.local_put_inplace(buf, 8),
    }
    lib_calls = {
        "copy": lambda: out.copy_(x),
        "local_put_inplace": lambda: view[:, chunk_rows - half:].copy_(
            view[:, :half]),
    }
    kern = {name: t(fn) for name, fn in calls.items()}
    plain_copy = t(lambda: op.local_put_reference(x))
    plain = {"local_put_inplace": t(
        lambda: op.local_put_inplace_reference(buf, 8))}
    library = {name: t(fn) for name, fn in lib_calls.items()}
    queued = {name: _queued_stats(torch, ck, fn)
              for name, fn in calls.items()}
    lib_queued = {name: _queued_stats(torch, ck, fn)
                  for name, fn in lib_calls.items()}
    k7 = _queued_stats(torch, ck, cb.K7Launch([x.view(-1)], [], [], True,
                                              [out.view(-1)], []))
    rows = {}
    for name in PUT_KERNELS:
        bound = 2 * moved[name] / (spec["hbm_gbps"] * 1e9) * 1e3
        lib = name if name in lib_calls else "copy"
        rows[name] = {
            "ms": kern[name], "gbps": moved[name] / kern[name] / 1e6,
            "plain_ms": plain.get(name, plain_copy),
            "library_ms": library[lib],
            "device_ms": queued[name]["ms"],
            "device_ms_min": queued[name]["min"],
            "device_ms_max": queued[name]["max"],
            "library_device_ms": lib_queued[lib]["ms"],
            "device_over_library": queued[name]["ms"] / lib_queued[lib]["ms"],
            "bytes_moved": moved[name], "bound_ms": bound,
            "bound_by": "bytes", "share_of_bound": bound / kern[name],
        }
    emit({"phase": "put_time", "shape": f"{PUT_FULL[0]}x{PUT_FULL[1]} "
          "float32, chunks 8, block_rows 1024 (clamped to "
          f"{op.streamed_block_rows(PUT_FULL[0], PUT_FULL[1] * 4, 1024)})",
          "library": "out.copy_(x); inplace: one strided copy_ of the "
          "chunk halves", "timing": "ms: median of 5 readings of 10 calls, "
          "an event pair around each; device_ms: median of 5 readings of "
          "20 calls queued behind a busy-wait", **rows,
          "dma_compute_copy_only": {
              "device_ms": k7["ms"], "device_ms_min": k7["min"],
              "device_ms_max": k7["max"],
              "library_device_ms": lib_queued["copy"]["ms"]}})
    return rows


def phase_onesided(torch, op):
    """``run_onesided`` at the reference's message size: auto mode, then
    mono; each with the put launch counts set to 0 just before and read
    just after; then the ``p2p`` CLI in a process of its own."""
    recs = {}
    for kernel in ("auto", "mono"):
        op.reset_launches()
        rec, = op.run_onesided(op.OneSidedConfig(kernel=kernel),
                               device=DEVICE)
        torch.cuda.synchronize()
        launches = op.launch_counts()
        row = {"phase": "onesided", "kernel": kernel,
               "verdict": rec.verdict.value, "commands": rec.commands,
               "selected": rec.config["kernel"],
               "bandwidth_GBps": rec.metrics["bandwidth_GBps"],
               "launches": launches, "metrics": rec.metrics,
               "notes": rec.notes}
        emit(row)
        need = (("local_put_streamed", "local_put_multi",
                 "local_put_inplace") if kernel == "auto" else ("local_put",))
        keys = ([f"bandwidth_GBps_{k}" for k in
                 ("streamed", "multi", "xla", "inplace")]
                if kernel == "auto" else ["bandwidth_GBps_mono"])
        bad = []
        if not rec.verdict or rec.metrics.get("checksum_ok") != 1.0 \
                or rec.metrics.get("hbm_plausible") != 1.0:
            bad.append("verdict, checksum_ok or hbm_plausible")
        bad += [k for k in keys if k not in rec.metrics]
        bad += [f"{k} never launched" for k in need if not launches[k] > 0]
        bad += [n for n in rec.notes if "failed" in n]
        if bad:
            raise AssertionError(f"run_onesided {kernel}: {bad}; {rec.notes}")
        recs[kernel] = row
    r = subprocess.run(
        [sys.executable, "-m", "tpu_patterns_torch", "p2p", "--transport",
         "one_sided", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    emit({"phase": "p2p_cli", "rc": r.returncode,
          "stdout_tail": r.stdout.splitlines()[-3:]})
    if r.returncode != 0:
        raise AssertionError(f"p2p CLI exited {r.returncode}: {r.stderr}")
    return recs


# -- phase 10: the concurrency suite -------------------------------------------


CONC_KERNELS = {  # wrapper -> (source, the Pallas body it replaces)
    "busy_wait": ("tpu_patterns_torch/concurrency/csrc/busy_wait.cu",
                  "tpu_patterns/concurrency/kernels.py:49"),
    "dma_compute": ("tpu_patterns_torch/concurrency/csrc/dma_compute.cu",
                    "tpu_patterns/concurrency/backends.py:248"),
}
# cycles from one dependent f32 FMA to the next on this card (the FMA
# pipeline's latency): the chain floor of a busy-wait element is
# 64 x tripcount of them at the SM clock
FMA_LATENCY_CYCLES = 4
# a serial mode's group time must be at least this share of the sum of
# its commands' solo times, or the serial ordering was lost (the
# reference's own guard, tests/test_concurrency.py:177-215)
SERIAL_GUARD = 0.6
BALANCED = dict(copy_elements=1 << 25, tripcount=400)
CONC_KEYS = {"speedup", "theoretical_speedup", "serial_total_us", "mode_us",
             "bytes_per_iter", "timing_converged"}


def _conc_input(torch, rows, seed):
    """The suite's buffer (``default_rng(seed).random((rows, 128))`` in
    float32, as ``commands.alloc`` makes it) on the card."""
    import numpy as np

    a = np.random.default_rng(seed).random((rows, 128), dtype=np.float32)
    return torch.from_numpy(a).to(DEVICE)


def _same(torch, name, got, want):
    if len(got) != len(want) or any(
            g.shape != w.shape or not torch.equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError(f"{name}: kernel differs from its plain version")


def phase_busy_wait_vs_plain(torch, ck):
    """K6 against its plain version, bit for bit: rows 1, 3, 8, 9 and 64
    at tripcounts 0, 1, 3, 100 and 4000 (the plain version is
    elementwise, so one plain run over the rows stacked serves every row
    count of a tripcount).  The default 8 x 128 at 40,000 trips is held
    in :func:`phase_main_path_vs_plain`."""
    rows = (1, 3, 8, 9, 64)
    xs = [_conc_input(torch, r, 100 + r) for r in rows]
    stacked = torch.cat(xs)
    cases = 0
    for trips in (0, 1, 3, 100, 4000):
        want = ck.busy_wait_plain(stacked, trips).split(rows)
        _same(torch, f"busy_wait trips {trips}",
              [ck.busy_wait(x, trips) for x in xs], want)
        cases += len(rows)
    torch.cuda.synchronize()
    emit({"phase": "busy_wait_vs_plain", "cases": cases, "bit_exact": True,
          "rows": rows, "tripcounts": [0, 1, 3, 100, 4000]})
    return cases


def phase_dma_compute_vs_plain(torch, cb):
    """K7 against its plain version, bit for bit, in both modes, for the
    groups "C", "D2D", "C D2D" and "D2D D2D C C": copies of 128, 4224,
    4,194,304 and 33,554,432 elements (the auto-tune cap), computes of
    8 x 128 and 64 x 128 at tripcounts 0, 3 and 100."""
    lib = cb._dma_library()
    if (lib.dma_compute_max_copies(), lib.dma_compute_max_computes()) != (
            cb.MAX_COPIES, cb.MAX_COMPUTES):
        raise AssertionError("dma_compute.cu limits differ from backends.py")
    copy_sizes = (128, 4224, 1 << 22, 1 << 25)
    cases = 0
    for group in ("C", "D2D", "C D2D", "D2D D2D C C"):
        n_copy, n_comp = group.count("D2D"), group.split().count("C")
        for copy_n in (copy_sizes if n_copy else (None,)):
            copies = [_conc_input(torch, copy_n // 128, 10 + i)
                      for i in range(n_copy)]
            for comp_rows in ((8, 64) if n_comp else (None,)):
                comps = [_conc_input(torch, comp_rows, 20 + i)
                         for i in range(n_comp)]
                for trips in ((0, 3, 100) if n_comp else (0,)):
                    tr = [trips] * n_comp
                    want = cb.dma_compute_plain(copies, comps, tr)
                    for overlap in (False, True):
                        _same(torch, f"dma_compute {group!r} copy {copy_n} "
                              f"comp {comp_rows}x128 trips {trips} "
                              f"overlap {overlap}",
                              cb.dma_compute(copies, comps, tr, overlap),
                              want)
                        cases += 1
    torch.cuda.synchronize()
    emit({"phase": "dma_compute_vs_plain", "cases": cases, "bit_exact": True,
          "groups": ["C", "D2D", "C D2D", "D2D D2D C C"],
          "copy_elements": list(copy_sizes), "compute_rows": [8, 64],
          "tripcounts": [0, 3, 100], "modes": ["dma_serial", "dma_overlap"]})
    return cases


def _profile_breakdown(prof, what: str, planes=None) -> dict:
    """``core/profile.py``'s breakdown of a finished torch.profiler run,
    read from its in-memory Kineto results (or from ``planes`` already
    read from them): the one owner of the device's busy time (the union
    of its kernels', copies' and memsets' intervals over every stream)
    and idle; raises when the profile holds no device time."""
    from tpu_patterns_torch.core import profile as P

    if planes is None:
        planes = P.planes_from_profile(prof)
    bd = P.breakdown_of(planes)
    if bd is None or bd["busy_ms"] <= 0:
        raise AssertionError(f"{what} holds no device time")
    return bd


def _device_time_s(torch, fn):
    """``fn()`` under torch.profiler: its host wall, the summed device
    time of its kernels, copies and memsets by name, and the union of
    their intervals, the time the device was busy (work in flight
    together on two streams counts once there and twice in the sum); all
    in s; the number of device records by name, which tells whether the
    profile kept every launch; and the first record's start after the
    trace's, in ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    by_name: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0:
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) \
                + dev_us(e) / 1e6
            calls[e.key[:60]] = calls.get(e.key[:60], 0) + e.count
    if not by_name:
        raise AssertionError("the profile holds no device time")
    from tpu_patterns_torch.core import profile as P

    planes = P.planes_from_profile(prof)
    busy_s = _profile_breakdown(prof, "the profile", planes)["busy_ms"] / 1e3
    first_ps = min(ev.offset_ps for p in planes for ln in p.lines
                   for ev in ln.events)
    first_ms = (first_ps / 1e3 - prof.profiler.kineto_results.trace_start_ns()
                ) / 1e6
    return wall, by_name, busy_s, calls, first_ms


def _queued_ms(torch, ck, fn, n=20):
    """Device ms of one ``fn()`` with no host gaps, and the host's ms to
    enqueue one: ``n`` calls queued behind an 80,000-trip busy-wait
    (~10 ms; at 40,000 a slow host once took 5.78 ms to enqueue 20 K7
    launches), so the host has enqueued them all before the device
    reaches the first, timed by a CUDA-event pair after the busy-wait.
    Raises if the enqueueing outlasted the busy-wait, which would let
    host time back into the window."""
    x = torch.zeros((8, 128), device=DEVICE)
    fn()
    lead, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    lead.record()
    ck.busy_wait(x, 80_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if host_ms >= lead.elapsed_time(start):
        raise AssertionError(f"enqueueing {n} calls took {host_ms:.2f} ms, "
                             "longer than the busy-wait ahead of them")
    return start.elapsed_time(end) / n, host_ms / n


def _k7_inputs(cc, tuned):
    """The buffers ``PallasBackend.build`` makes for a Record's tuned
    commands (copies from seeds 10+i, computes from 20+i) and the
    computes' tripcounts."""
    cmds = [dataclasses.replace(cc.parse_command(t["text"]),
                                tripcount=t["tripcount"],
                                elements=t["elements"],
                                copy_elements=t["copy_elements"])
            for t in tuned]
    copies = [cc.alloc(c, DEVICE, seed=10 + i) for i, c in
              enumerate(c for c in cmds if c.kind == "copy")]
    comps = [cc.alloc(c, DEVICE, seed=20 + i) for i, c in
             enumerate(c for c in cmds if c.kind == "compute")]
    return copies, comps, [c.tripcount for c in cmds if c.kind == "compute"]


def _k7_bound(ck, spec, copies, comps, trips):
    """K7's bound on these inputs: (bytes ms, operations ms, bytes) --
    each copy read and written once, each compute element read and
    written once, 2 x 64 x tripcount flops an element over f32's peak."""
    n_bytes = sum(2 * t.numel() * 4 for t in (*copies, *comps))
    flops = sum(ck.flops(x.numel(), t) for x, t in zip(comps, trips))
    return (n_bytes / (spec["hbm_gbps"] * 1e9) * 1e3,
            flops / (spec["f32_tflops"] * 1e12) * 1e3, n_bytes)


def phase_main_path_vs_plain(torch, ck, cb, cc, tuned_by_run):
    """K6 and K7 bit for bit against their plain versions at the shapes
    the main path launched them with: K6 at the default 8 x 128 and
    40,000 trips (the xla runs' first compute, seed 0), K7 at each pallas
    run's tuned commands, rebuilt as its build made them, in both modes.
    The plain busy-waits of one tripcount run once, over their inputs
    stacked (the plain version is elementwise, and its time is that of
    its 64 x tripcount launches, not of the elements), timed by CUDA
    events; a plain K7 is then ``dma_compute_plain`` of its copies and
    those outputs.  Returns the plain ms of K6 and of K7 by run."""
    jobs = {"busy_wait": ([], [_conc_input(torch, 8, 0)], [40_000])}
    job_of = {}
    for run, tuned in tuned_by_run.items():
        key = json.dumps(tuned, sort_keys=True)
        if key not in job_of:
            job_of[key] = run
            jobs[run] = _k7_inputs(cc, tuned)
    by_trips: dict[int, list] = {}
    for job, (_, comps, trips) in jobs.items():
        for i, (x, t) in enumerate(zip(comps, trips)):
            by_trips.setdefault(t, []).append((job, i, x))
    busy_out, ms = {}, {}
    for t, items in by_trips.items():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        y = ck.busy_wait_plain(torch.cat([x for *_, x in items]), t)
        end.record()
        end.synchronize()
        for (job, i, _), part in zip(items, y.split(
                [x.shape[0] for *_, x in items])):
            busy_out[job, i] = part
        for job in {job for job, *_ in items}:
            ms[job] = ms.get(job, 0.0) + start.elapsed_time(end)
    copies, comps, trips = jobs["busy_wait"]
    _same(torch, "busy_wait 8x128 at 40000 trips",
          [ck.busy_wait(comps[0], trips[0])], [busy_out["busy_wait", 0]])
    plain_ms = {}
    for run, tuned in tuned_by_run.items():
        job = job_of[json.dumps(tuned, sort_keys=True)]
        copies, comps, trips = jobs[job]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = (*cb.dma_compute_plain(copies, [], []),
                *[busy_out[job, i] for i in range(len(comps))])
        end.record()
        end.synchronize()
        plain_ms[run] = ms.get(job, 0.0) + start.elapsed_time(end)
        for overlap in (False, True):
            _same(torch, f"dma_compute at the {run} run's tuned commands "
                  f"{tuned}, overlap {overlap}",
                  cb.dma_compute(copies, comps, trips, overlap), want)
    torch.cuda.synchronize()
    emit({"phase": "main_path_vs_plain", "bit_exact": True,
          "busy_wait": "8x128 at 40000 trips", "dma_compute": tuned_by_run,
          "modes": ["dma_serial", "dma_overlap"],
          "plain_busy_wait_runs": {t: sorted({job for job, *_ in items})
                                   for t, items in by_trips.items()},
          "busy_wait_plain_ms": ms["busy_wait"],
          "dma_compute_plain_ms": plain_ms})
    return ms["busy_wait"], plain_ms


def phase_concurrency_time(torch, ck, cb, cc, ch, timing, spec,
                           busy_plain_ms, k7_tuned, k7_plain_ms,
                           balanced_tuned):
    """K6 and K7 where the main path launches them, CUDA events: K6 at
    the suite's defaults (1024 elements at 40,000 trips), K7 at the
    tuned commands of the pallas dma_overlap "C D2D" run whose launches
    the ``kernels`` line counts (both modes, copy-only beside one
    ``copy_`` and compute-only), each beside its bound (flops over 67
    TFLOP/s of f32, bytes read and written once over 3.35 TB/s; for
    dma_serial also the sum of the two); K6's and K7's chain floor (64 x
    tripcount dependent FMAs of FMA_LATENCY_CYCLES at the SM's top clock,
    the least time for the work they are given); the
    copy-only launch also queued behind a busy-wait, which leaves out
    the host's launch path, with the host's ms per launch, bound once
    (as the backend launches) and marshalled per call; then the balanced
    leg's tuned shape queued the same way, copy-only, compute-only and
    mixed in both modes: the device's own overlap, held to the harness's
    verdict (speedup at least theoretical / 1.3) and dma_serial to its
    serial guard.  The plain ms come from :func:`phase_main_path_vs_plain`."""
    clock_mhz = float(_run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"]).split()[0])
    trips, n = 40_000, 1024
    x = _conc_input(torch, n // 128, 0)
    flops = ck.flops(n, trips)
    ops_ms = flops / (spec["f32_tflops"] * 1e12) * 1e3

    def chain_floor_ms(trips):
        return ck.FMAS_PER_TRIP * trips * FMA_LATENCY_CYCLES / (
            clock_mhz * 1e6) * 1e3

    chain_ms = chain_floor_ms(trips)

    def t(fn):
        return timing.cuda_time_ms(fn, reps=5, warmup=1)

    busy = {"ms": t(lambda: ck.busy_wait(x, trips)), "plain_ms": busy_plain_ms,
            "bound_ms": ops_ms, "bound_by": "operations",
            "chain_floor_ms": chain_ms, "library_ms": None,
            "flops": flops, "shape": "8x128 float32 at 40000 trips"}

    copies, comps, k7_trips = _k7_inputs(cc, k7_tuned)
    bytes_ms, k7_ops_ms, k7_bytes = _k7_bound(ck, spec, copies, comps,
                                              k7_trips)
    copy_bytes_ms, _, copy_bytes = _k7_bound(ck, spec, copies, [], [])
    dma = {
        "tuned": k7_tuned,
        "ms": t(lambda: cb.dma_compute(copies, comps, k7_trips, True)),
        "dma_serial_ms": t(lambda: cb.dma_compute(copies, comps, k7_trips,
                                                  False)),
        "plain_ms": k7_plain_ms, "bytes": k7_bytes,
        "bound_ms": max(k7_ops_ms, bytes_ms), "bound_by": "operations"
        if k7_ops_ms >= bytes_ms else "bytes",
        "dma_serial_floor_ms": k7_ops_ms + bytes_ms, "library_ms": None,
        "chain_floor_ms": chain_floor_ms(max(k7_trips, default=0)),
        "copy_only_ms": t(lambda: cb.dma_compute(copies, [], [], True)),
        "copy_only_bound_ms": copy_bytes_ms, "copy_only_bytes": copy_bytes,
        "compute_only_ms": t(lambda: cb.dma_compute([], comps, k7_trips,
                                                    True)),
    }
    outs = [torch.empty_like(c) for c in copies]
    dma["copy_only_library_ms"] = t(
        lambda: [o.copy_(c) for o, c in zip(outs, copies)])
    bound = cb.K7Launch(copies, [], [], True, outs, [])
    dma["copy_only_queued_ms"], dma["host_ms_per_bound_launch"] = \
        _queued_ms(torch, ck, bound)
    _, dma["host_ms_per_dma_compute_call"] = _queued_ms(
        torch, ck, lambda: cb.dma_compute(copies, [], [], True))
    dma["copy_only_library_queued_ms"], _ = _queued_ms(
        torch, ck, lambda: [o.copy_(c) for o, c in zip(outs, copies)])
    del copies, comps, outs, bound

    copies, comps, b_trips = _k7_inputs(cc, balanced_tuned)
    q = {}
    for name, args in (("copy_only", (copies, [], [], True)),
                       ("compute_only", ([], comps, b_trips, True)),
                       ("dma_overlap", (copies, comps, b_trips, True)),
                       ("dma_serial", (copies, comps, b_trips, False))):
        bound = cb.K7Launch(*args, [torch.empty_like(c) for c in args[0]],
                            [torch.empty_like(c) for c in args[1]])
        q[name], _ = _queued_ms(torch, ck, bound)
    solo_sum = q["copy_only"] + q["compute_only"]
    balanced = {"tuned": balanced_tuned, "queued_ms": q,
                "device_speedup": solo_sum / q["dma_overlap"],
                "device_theoretical": solo_sum / max(q["copy_only"],
                                                     q["compute_only"]),
                "dma_serial_share_of_solos": q["dma_serial"] / solo_sum}
    emit({"phase": "concurrency_time", "sm_clock_max_mhz": clock_mhz,
          "fma_latency_cycles": FMA_LATENCY_CYCLES, "busy_wait": busy,
          "dma_compute": dma, "balanced_device": balanced})
    # the harness's verdict and serial guard, on the device's own times
    if not balanced["device_speedup"] >= balanced["device_theoretical"] / (
            1 + ch.TOL_SPEEDUP):
        raise AssertionError(f"K7 dma_overlap does not overlap on the "
                             f"device: {balanced}")
    if not balanced["dma_serial_share_of_solos"] >= SERIAL_GUARD:
        raise AssertionError(f"K7 dma_serial lost its order: {balanced}")
    return busy, dma


def _conc_run(torch, ck, cb, ch, **kw):
    """One ``run_concurrency`` call with both launch counts set to 0 just
    before and read just after; returns its Record and the counts."""
    ck.busy_wait.launches = 0
    cb.dma_compute.launches = 0
    rec, = ch.run_concurrency(ch.ConcurrencyConfig(device=DEVICE, **kw))
    torch.cuda.synchronize()
    launches = {"busy_wait": ck.busy_wait.launches,
                "dma_compute": cb.dma_compute.launches}
    row = {"phase": "concurrency", "mode": rec.mode,
           "commands": rec.commands, "verdict": rec.verdict.value,
           "metrics": rec.metrics, "tuned": rec.config["tuned"],
           "launches": launches, "notes": rec.notes}
    emit(row)
    if set(rec.metrics) != CONC_KEYS:
        raise AssertionError(f"{rec.mode} {rec.commands}: metric keys "
                             f"{sorted(rec.metrics)}")
    return rec, launches


def _serial_guard(rec):
    m = rec.metrics
    if not m["mode_us"] >= SERIAL_GUARD * m["serial_total_us"]:
        raise AssertionError(
            f"{rec.mode} {rec.commands}: group {m['mode_us']:.1f} us < "
            f"{SERIAL_GUARD} x the solos' {m['serial_total_us']:.1f} us: the "
            "serial ordering was lost")


def phase_concurrency(torch, ck, cb, cc, ch):
    """``run_concurrency`` on the card at the reference's defaults unless
    stated: xla concurrent and serial "C C", concurrent "C H2D" and
    "C S2D", both dispatch modes on "M2D D2M" and "H2D D2H"; pallas
    dma_overlap and dma_serial on "C D2D"; the balanced leg (copies of
    128 MiB, computes from 400 trips, so auto-tune raises the compute to
    the copy); then the ``concurrency`` CLI, default and balanced.
    Returns the launch counts the ``kernels`` line reports and each
    pallas run's tuned commands."""
    s = cc.alloc(cc.parse_command("S2D"), DEVICE)
    d = cc.alloc(cc.parse_command("D2S"), DEVICE)
    if not cc.is_managed(s) or cc.is_managed(d):
        raise AssertionError("S is not managed memory, or D is")
    del s, d
    runs, k7_tuned = {}, {}
    rec, launches = _conc_run(torch, ck, cb, ch, mode="concurrent")
    if not rec.verdict or not launches["busy_wait"] > 0:
        raise AssertionError(f"xla concurrent 'C C': {rec.verdict.value}, "
                             f"{launches}; {rec.notes}")
    runs["busy_wait"] = launches["busy_wait"]
    # the same run, and the pallas one, under the profiler, in a
    # process of their own (see profile_concurrency_main)
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--profile-concurrency"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"concurrency profile exited {r.returncode}: "
                             f"{r.stdout}{r.stderr}")
    for ln in r.stdout.splitlines():
        if ln.startswith(('{"phase": "concurrency_profile"',
                          '{"phase": "allreduce_profile"')):
            emit(json.loads(ln))
    rec, _ = _conc_run(torch, ck, cb, ch, mode="serial")
    _serial_guard(rec)
    for mode, group in (("concurrent", "C H2D"), ("concurrent", "C S2D"),
                        ("dispatch_serial", "M2D D2M"),
                        ("dispatch_serial", "H2D D2H"),
                        ("dispatch_async", "M2D D2M"),
                        ("dispatch_async", "H2D D2H")):
        _conc_run(torch, ck, cb, ch, mode=mode, commands=(group,))
    for mode in ("dma_overlap", "dma_serial"):
        rec, launches = _conc_run(torch, ck, cb, ch, backend="pallas",
                                  mode=mode, commands=("C D2D",))
        if not launches["dma_compute"] > 0:
            raise AssertionError(f"pallas {mode}: K7 never launched")
        if mode == "dma_overlap":
            runs["dma_compute"] = launches["dma_compute"]
        k7_tuned[f"defaults {mode}"] = rec.config["tuned"]
    rec, _ = _conc_run(torch, ck, cb, ch, backend="pallas",
                       mode="dma_overlap", commands=("C D2D",), **BALANCED)
    if not rec.verdict:
        raise AssertionError(f"balanced pallas dma_overlap: {rec.notes}")
    k7_tuned["balanced dma_overlap"] = rec.config["tuned"]
    rec, _ = _conc_run(torch, ck, cb, ch, backend="pallas",
                       mode="dma_serial", commands=("C D2D",), **BALANCED)
    _serial_guard(rec)
    k7_tuned["balanced dma_serial"] = rec.config["tuned"]
    cli = [sys.executable, "-m", "tpu_patterns_torch", "concurrency",
           "--device", "cuda"]
    for argv in ([], ["--backend", "pallas", "--mode", "dma_overlap",
                      "--commands", "C D2D", "--copy_elements",
                      str(BALANCED["copy_elements"]), "--tripcount",
                      str(BALANCED["tripcount"])]):
        r = subprocess.run(cli + argv, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        emit({"phase": "concurrency_cli", "argv": argv, "rc": r.returncode,
              "stdout_tail": r.stdout.splitlines()[-3:]})
        if r.returncode != 0:
            raise AssertionError(f"concurrency CLI {argv} exited "
                                 f"{r.returncode}: {r.stdout}{r.stderr}")
    return runs, k7_tuned


# -- phase 11: the ring ---------------------------------------------------------

RING_KERNELS = {  # wrapper -> (source, the Pallas body it replaces)
    "accumulate": (
        "tpu_patterns_torch/miniapps/apps/allreduce/csrc/accumulate.cu",
        "tpu_patterns/miniapps/apps/allreduce/pallas.py:27"),
    "ring_put": ("tpu_patterns_torch/comm/csrc/ring_put.cu",
                 "tpu_patterns/comm/onesided.py:53"),
}
AR_WORLD = 4  # the miniapp's default world, four ranks on the one card
AR_FULL = 1 << 25  # the miniapp's per-rank elements
# run_allreduce at the defaults: (variant, algorithm, dtype, mem_kind)
AR_RUNS = (
    ("xla", "ring", "float32", "D"), ("xla", "ring_opt", "float32", "D"),
    ("xla", "psum", "float32", "D"), ("xla", "ring", "int32", "D"),
    ("xla", "ring", "bfloat16", "D"),
    ("pallas", "ring", "float32", "D"), ("pallas", "ring_opt", "float32", "D"),
    ("pallas", "ring", "int32", "D"), ("pallas", "ring", "float32", "H"),
    ("pallas", "ring", "float32", "S"),
)


def _ring_input(torch, n, dtype, seed, offset=0):
    """``n`` random values of ``dtype`` on the card (float32: normal;
    int32: the full range, so that adds wrap); with ``offset``, a view
    that starts ``offset`` elements into a larger buffer."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if dtype == torch.int32:
        raw = torch.randint(-2**31, 2**31 - 1, (n + offset,), generator=g,
                            dtype=torch.int32, device=DEVICE)
    else:
        raw = torch.randn(n + offset, generator=g, device=DEVICE)
    return raw[offset:]


def _bits_equal(torch, got, want):
    """Bit for bit, on the card: floats compared as their bits."""
    bits = {torch.float32: torch.int32, torch.int32: torch.int32,
            torch.bfloat16: torch.int16}
    got, want = got.to(DEVICE), want.to(DEVICE)
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(got.view(bits[got.dtype]),
                            want.view(bits[want.dtype])))


def phase_accumulate_vs_plain(torch, ap, cc):
    """K5's grid, as the C side computes it (``accumulate_grid``),
    against its Python mirror (``pallas.tile_grid``, which the CPU tests
    hold to cover every element once) on both paths; then K5 against its
    plain version on the same tensors, bit for bit: float32 and int32 at
    n = 1, 127, 4097, 2^23 and 2^25; views one element into a buffer (a,
    b or both misaligned); and inputs in pinned host (H) and managed (S)
    memory, where K5 must launch (its count says so) and its output
    stays in the inputs' memory."""
    from tpu_patterns_torch.comm.mesh import default_mesh

    lib = ap._library()
    grids = {}
    for n in (1, 3, 4, 5, 127, 4097, (1 << 23) + 3, 1 << 23, AR_FULL):
        for vec in (1, 0):
            grid = lib.accumulate_grid(n, vec)
            if grid != ap.tile_grid(n, bool(vec)):
                raise AssertionError(f"pallas.tile_grid({n}, {bool(vec)}) "
                                     f"differs from accumulate.cu's {grid}")
            grids[f"{n} {'vector' if vec else 'scalar'}"] = grid
    one_rank = default_mesh(1, DEVICE)
    cases = 0

    def same(name, got, want):
        nonlocal cases
        cases += 1
        if not _bits_equal(torch, got, want):
            raise AssertionError(f"accumulate differs from its plain "
                                 f"version: {name}")

    sizes = (1, 127, 4097, 1 << 23, AR_FULL)
    for i, dt in enumerate((torch.float32, torch.int32)):
        for j, n in enumerate(sizes):
            a = _ring_input(torch, n, dt, 10 * i + j)
            b = _ring_input(torch, n, dt, 10 * i + j + 5)
            same(f"{dt} n={n}", ap.accumulate(a, b),
                 ap.accumulate_reference(a, b))
        for n in (127, 4097):
            for oa, ob in ((1, 0), (0, 1), (1, 1)):
                a = _ring_input(torch, n, dt, 40 + n, oa)
                b = _ring_input(torch, n, dt, 41 + n, ob)
                same(f"{dt} n={n} offsets {oa},{ob}", ap.accumulate(a, b),
                     ap.accumulate_reference(a, b))
        for kind in ("H", "S"):
            for n in (4097, 1 << 23):
                a = _ring_input(torch, n, dt, 60 + n)
                b = _ring_input(torch, n, dt, 61 + n)
                ka = cc.empty_in(cc.MemKind[kind], (n,), DEVICE, dt)
                kb = cc.empty_in(cc.MemKind[kind], (n,), DEVICE, dt)
                ka.copy_(a)
                kb.copy_(b)
                torch.cuda.synchronize()
                before = ap.accumulate.launches
                with one_rank.allocating_in(kind):  # S: a managed output
                    got = ap.accumulate(ka, kb, device=DEVICE)
                if ap.accumulate.launches != before + 1:
                    raise AssertionError(f"accumulate on {kind} memory did "
                                         "not launch K5")
                kept = got.is_pinned() if kind == "H" else cc.is_managed(got)
                if not kept:
                    raise AssertionError(f"accumulate's output left {kind}")
                same(f"{dt} n={n} {kind}", got, ap.accumulate_reference(a, b))
    torch.cuda.synchronize()
    emit({"phase": "accumulate_vs_plain", "cases": cases, "bit_exact": True,
          "sizes": sizes, "kinds": ["D", "H", "S"], "grid_by_n": grids})
    return cases


def _queued_stats(torch, ck, fn, readings=5, n=20):
    """:func:`_queued_ms` of ``n`` calls read ``readings`` times: the
    median device ms of one ``fn()`` with no host gaps (``ms``, with
    ``min`` and ``max``) and the median host us to enqueue one
    (``host_us``)."""
    runs = [_queued_ms(torch, ck, fn, n) for _ in range(readings)]
    dev = [d for d, _ in runs]
    return {"ms": statistics.median(dev), "min": min(dev), "max": max(dev),
            "host_us": statistics.median(h for _, h in runs) * 1e3}


def accumulate_times(torch, ap, ck, timing, spec, n):
    """K5 at ``n`` float32 elements beside one ``torch.add(out=)`` call:
    each one's time with the host in it, as a caller of the wrapper
    sees it (the median of 5 readings of 20 calls, an event pair around
    each call, with their min and max: where the host's work per call
    outlasts the device's, the queue drains and the reading holds the
    host's time); its device time with no host gaps and the host's us to
    enqueue one call (:func:`_queued_stats`); the plain version's time
    and the byte bound (12 bytes an element).  2^23 and 2^25 both move
    more than the 50 MB L2 a launch, so no flush."""
    a = _ring_input(torch, n, torch.float32, 1)
    b = _ring_input(torch, n, torch.float32, 2)
    out = torch.empty_like(a)
    if not _bits_equal(torch, ap.accumulate(a, b), torch.add(a, b)):
        raise AssertionError(f"accumulate differs from torch.add at n={n}")

    def t(fn):
        return timing.cuda_time_repeated_ms(fn, reps=20, warmup=3)

    kern, plain, lib = (t(lambda: ap.accumulate(a, b)),
                        t(lambda: ap.accumulate_reference(a, b)),
                        t(lambda: torch.add(a, b, out=out)))
    q_kern = _queued_stats(torch, ck, lambda: ap.accumulate(a, b))
    q_lib = _queued_stats(torch, ck, lambda: torch.add(a, b, out=out))
    row = {
        "ms": kern["ms"], "ms_min": kern["min"], "ms_max": kern["max"],
        "device_ms": q_kern["ms"], "device_ms_min": q_kern["min"],
        "device_ms_max": q_kern["max"], "host_us_per_call": q_kern["host_us"],
        "plain_ms": plain["ms"],
        "library_ms": lib["ms"], "library_ms_min": lib["min"],
        "library_ms_max": lib["max"], "library_device_ms": q_lib["ms"],
        "library_host_us_per_call": q_lib["host_us"],
        "bound_ms": 3 * n * 4 / (spec["hbm_gbps"] * 1e9) * 1e3,
        "bound_by": "bytes",
    }
    return row


def phase_accumulate_time(torch, ap, ck, timing, spec):
    """K5 at 2^25 (the ring's shard) and 2^23 (the bandwidth-optimal
    ring's chunk) float32 (:func:`accumulate_times`); returns both
    rows."""
    rows = {n: accumulate_times(torch, ap, ck, timing, spec, n)
            for n in (AR_FULL, AR_FULL // AR_WORLD)}
    emit({"phase": "accumulate_time", "shape": "float32, per launch; ms: "
          "median of 5 readings of 20 calls with the host in them; "
          "device_ms: median of 5 readings of 20 calls queued behind a "
          "busy-wait", "library": "torch.add(a, b, out=o)",
          **{f"n={n}": r for n, r in rows.items()}})
    return rows


def phase_allreduce(torch, ap, ar, fw):
    """``run_allreduce`` at the defaults (2^25 elements a rank, 4 ranks on
    the one card, reps 5) over :data:`AR_RUNS`: each must read SUCCESS;
    K5's count, set to 0 just before each run and read just after, must
    be (p-1) x p launches per allreduce the run performed for every
    pallas run, and 0 for xla.  Returns the pallas ring's launches at
    float32 in device memory, the main path."""
    from tpu_patterns_torch.core.results import ResultWriter

    mesh = fw.default_mesh(AR_WORLD, DEVICE)
    main = None
    for variant, alg, dtype, kind in AR_RUNS:
        cfg = ar.AllreduceConfig(dtype=dtype, algorithm=alg, mem_kind=kind)
        ap.reset_launches()
        t0 = time.perf_counter()
        rec = fw.get_variant("allreduce", variant).run(
            mesh=mesh, dtype=dtype, algorithm=alg, mem_kind=kind,
            writer=ResultWriter(stream=io.StringIO()))
        torch.cuda.synchronize()
        launches = ap.accumulate.launches
        want = ((AR_WORLD - 1) * AR_WORLD * ar.allreduces_per_run(cfg)
                if variant == "pallas" else 0)
        emit({"phase": "allreduce", "variant": variant, "algorithm": alg,
              "dtype": dtype, "mem_kind": kind, "verdict": rec.verdict.value,
              "commands": rec.commands, "wall_s": rec.metrics["wall_s"],
              "busbw_GBps": rec.metrics["busbw_GBps"],
              "wire_GBps": rec.metrics["wire_GBps"],
              "timing_converged": rec.metrics["timing_converged"],
              "accumulate_launches": launches, "want_launches": want,
              "host_s": time.perf_counter() - t0, "notes": rec.notes})
        if not rec.verdict or launches != want:
            raise AssertionError(f"allreduce {variant}:{alg} {dtype} {kind}: "
                                 f"{rec.verdict.value}, K5 launches "
                                 f"{launches} (want {want}); {rec.notes}")
        if (variant, alg, dtype, kind) == ("pallas", "ring", "float32", "D"):
            main = launches
    return main


def phase_allreduce_vs_plain(torch, ap, ring, fw):
    """The main path against its plain version at its own shapes: the
    ring and the bandwidth-optimal ring over 4 ranks of 2^25 random
    float32 each, once with K5 for each rank and once with the plain
    accumulate, on the same tensors; equal bit for bit (the order of
    adds is the ring's in both)."""
    import functools

    mesh = fw.default_mesh(AR_WORLD, DEVICE)
    xs = [_ring_input(torch, AR_FULL, torch.float32, 90 + r)
          for r in range(AR_WORLD)]
    ops = [functools.partial(ap.accumulate, device=d) for d in mesh.devices]
    for alg in ("ring", "ring_opt"):
        got = ring.allreduce(xs, alg, ops)
        want = ring.allreduce(xs, alg, ap.accumulate_reference)
        if not all(_bits_equal(torch, g, w) for g, w in zip(got, want)):
            raise AssertionError(f"allreduce {alg} through K5 differs from "
                                 "its plain version")
        spread = max(float((g - got[0]).abs().max()) for g in got)
        emit({"phase": "allreduce_vs_plain", "algorithm": alg,
              "bit_exact": True, "ranks": AR_WORLD, "elements": AR_FULL,
              "max_rank_spread": spread})


def phase_ring_put_vs_plain(torch, op, fw):
    """K9 against its plain version (the ring shift), bit for bit, at
    worlds 2, 4 and 8 on the one card, float32 and bfloat16, 1, 97 and
    2048 rows of 512, and shards that start one element into a buffer;
    each output also equals the global buffer rolled by one shard.  First
    K9's grid, as the C side computes it (``ring_put_grid``), against
    its Python mirror (``onesided.ring_put_pieces``)."""
    lib = op._ring_library()
    grids = {}
    for n in (1, 15, 16, 17, 16383, 16384, 16385, 97 * 512 * 2,
             PUT_FULL[0] * PUT_FULL[1] * 4):
        grids[n] = lib.ring_put_grid(n)
        if grids[n] != len(op.ring_put_pieces(n)):
            raise AssertionError(f"onesided.ring_put_pieces({n}) differs "
                                 f"from ring_put.cu's grid {grids[n]}")
    cases = 0
    for world in (2, 4, 8):
        mesh = fw.default_mesh(world, DEVICE)
        for dt in (torch.float32, torch.bfloat16):
            for rows in (1, 97, 2048):
                x = _put_input(torch, (world * rows, 512), dt,
                               world + rows)
                shards = mesh.scatter(x)
                cases += 1
                got = op.ring_put(shards)
                want = op.ring_put_reference(shards)
                if not all(_bits_equal(torch, g, w)
                           for g, w in zip(got, want)) or not _bits_equal(
                        torch, mesh.gather(got), torch.roll(x, rows, 0)):
                    raise AssertionError(f"ring_put differs: world {world} "
                                         f"{dt} rows {rows}")
            buf = _put_input(torch, (world * 97 * 512 + 1,), dt, world)
            shards = [buf[1 + r * 97 * 512:1 + (r + 1) * 97 * 512]
                      .view(97, 512) for r in range(world)]
            cases += 1
            if not all(_bits_equal(torch, g, w) for g, w in zip(
                    op.ring_put(shards), op.ring_put_reference(shards))):
                raise AssertionError(f"ring_put differs: world {world} {dt} "
                                     "misaligned")
    torch.cuda.synchronize()
    emit({"phase": "ring_put_vs_plain", "cases": cases, "bit_exact": True,
          "worlds": [2, 4, 8], "rows": [1, 97, 2048],
          "dtypes": ["float32", "bfloat16"], "grid_by_bytes": grids})
    return cases


def phase_ring_put_time(torch, op, ck, timing, spec, fw):
    """K9's ms per launch at the reference's 92,160 x 512 float32 shard
    (188.7 MB, 3.8x the L2): one ring put over 4 ranks is 4 launches, so
    its time over 4 (the median of 5 readings of 10 calls, an event pair
    around each); the plain version (the ring shift) likewise; one
    ``copy_`` into the neighbour's buffer; K9's and ``copy_``'s device
    ms with no host gaps (:func:`_queued_stats`; a ring put does 4
    launches' host work, so 10 calls, 40 launches, a reading); the byte
    bound (the shard read once and written once)."""
    mesh = fw.default_mesh(AR_WORLD, DEVICE)
    x = _put_input(torch, (AR_WORLD * PUT_FULL[0], PUT_FULL[1]),
                   torch.float32, 3)
    shards = mesh.scatter(x)
    dst = torch.empty_like(shards[1])
    nbytes = shards[0].numel() * 4

    def t(fn):
        return timing.cuda_time_repeated_ms(fn, reps=10, warmup=2)["ms"]

    q_kern = _queued_stats(torch, ck, lambda: op.ring_put(shards), n=10)
    q_lib = _queued_stats(torch, ck, lambda: dst.copy_(shards[0]))
    row = {
        "ms": t(lambda: op.ring_put(shards)) / AR_WORLD,
        "plain_ms": t(lambda: op.ring_put_reference(shards)) / AR_WORLD,
        "library_ms": t(lambda: dst.copy_(shards[0])),
        "device_ms": q_kern["ms"] / AR_WORLD,
        "device_ms_min": q_kern["min"] / AR_WORLD,
        "device_ms_max": q_kern["max"] / AR_WORLD,
        "host_us_per_launch": q_kern["host_us"] / AR_WORLD,
        "library_device_ms": q_lib["ms"],
        "device_over_library": q_kern["ms"] / AR_WORLD / q_lib["ms"],
        "bound_ms": 2 * nbytes / (spec["hbm_gbps"] * 1e9) * 1e3,
        "bound_by": "bytes",
    }
    emit({"phase": "ring_put_time", "shape": f"{PUT_FULL[0]}x{PUT_FULL[1]} "
          f"float32 a rank, {AR_WORLD} ranks on the card, per launch",
          "library": "dst.copy_(src)", **row})
    return row


def phase_onesided_ring(torch, op, fw):
    """``run_onesided`` over 4 ranks on the one card at the reference's
    message size: SUCCESS, ``checksum_ok`` 1, no ``hbm_plausible``, and
    K9 launched 4 times for each ring put the run made (its count set to
    0 just before, read just after)."""
    cfg = op.OneSidedConfig()
    op.reset_launches()
    rec, = op.run_onesided(cfg, mesh=fw.default_mesh(AR_WORLD, DEVICE))
    torch.cuda.synchronize()
    launches = op.launch_counts()
    from tpu_patterns_torch.core import timing

    puts = timing.CHAIN_K * timing.CHAIN_UNROLL * (cfg.warmup + cfg.reps) + 1
    emit({"phase": "onesided_ring", "verdict": rec.verdict.value,
          "commands": rec.commands, "metrics": rec.metrics,
          "launches": launches, "want_ring_put": AR_WORLD * puts,
          "notes": rec.notes})
    if (not rec.verdict or rec.metrics.get("checksum_ok") != 1.0
            or "hbm_plausible" in rec.metrics
            or launches["ring_put"] != AR_WORLD * puts):
        raise AssertionError(f"run_onesided ring_put: {rec.verdict.value}, "
                             f"{launches}; {rec.notes}")
    return launches["ring_put"]


def phase_ring_cli():
    """The ``allreduce``, ``miniapps`` and ``p2p`` ring commands, each in
    a process of its own, at their defaults over 4 ranks."""
    cli = [sys.executable, "-m", "tpu_patterns_torch"]
    for argv in (["allreduce", "--variant", "pallas", "--devices", "4"],
                 ["miniapps", "--devices", "4"],
                 ["p2p", "--transport", "one_sided", "--devices", "4"]):
        r = subprocess.run(cli + argv + ["--device", "cuda"], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        emit({"phase": "ring_cli", "argv": argv, "rc": r.returncode,
              "stdout_tail": r.stdout.splitlines()[-3:]})
        if r.returncode != 0:
            raise AssertionError(f"CLI {argv} exited {r.returncode}: "
                                 f"{r.stdout}{r.stderr}")


# -- phase 12: interop -------------------------------------------------------

# K10: (source, the Pallas body it replaces)
INTEROP_KERNEL = ("tpu_patterns_torch/interop/csrc/add_one.cu",
                  "tests/test_interop.py:67")
K10_PROOF = (4, 128)  # the reference test's block
K10_FULL = 1 << 25


def _wrap32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def phase_native_build(native):
    """The native module from the checkout's source with g++: the
    compiler's version, the seconds of one build from scratch (into a
    temporary directory under build/), and the library the port loads
    (built at the first clock read)."""
    import tempfile
    from pathlib import Path

    cxx = native.find_cxx()
    version = _run([cxx, "--version"]).splitlines()[0]
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        native.build_shared_object(native.SOURCE, build_dir=Path(tmp))
        build_s = time.perf_counter() - t0
    native.load()
    emit({"phase": "native_build", "compiler": version, "seconds": build_s,
          "flags": native.CXX_FLAGS,
          "library": os.path.relpath(native.NATIVE.path, ROOT)})


def phase_add_one_vs_plain(torch, k10, cc, calls):
    """K10's grid, as the C side computes it (``add_one_grid``), against
    its Python mirror (``kernel.tile_grid``, which the CPU tests hold to
    cover every element once) on both paths; then K10 against its plain
    version on the same tensors, bit for bit: random float32 at (4,
    128), 1, 3, 127, 4097, 2^25 and 2^25 + 3 (an odd tail) elements;
    input, output or both one element into a buffer (the scalar path);
    +-0, +-inf, subnormals and the float32 extremes; an input and an
    output in managed memory.  Every call must launch K10.  Then the
    typed ops, registered for the CPU alone, must refuse a CUDA
    tensor."""
    lib = k10._library()
    grids = {}
    for n in (1, 3, 4, 5, 127, 512, 4097, K10_FULL, K10_FULL + 3):
        for vec in (1, 0):
            grid = lib.add_one_grid(n, vec)
            if grid != k10.tile_grid(n, bool(vec)):
                raise AssertionError(f"kernel.tile_grid({n}, {bool(vec)}) "
                                     f"differs from add_one.cu's {grid}")
            grids[f"{n} {'vector' if vec else 'scalar'}"] = grid
    cases = 0

    def same(name, x, out=None):
        nonlocal cases
        before = k10.add_one.launches
        got = k10.add_one(x, out=out)
        if k10.add_one.launches != before + 1:
            raise AssertionError(f"add_one did not launch K10: {name}")
        cases += 1
        if not _bits_equal(torch, got, k10.add_one_reference(x)):
            raise AssertionError(f"add_one differs from its plain version: "
                                 f"{name}")

    for i, shape in enumerate((K10_PROOF, (1,), (3,), (127,), (4097,),
                               (K10_FULL,), (K10_FULL + 3,))):
        g = torch.Generator(device=DEVICE).manual_seed(70 + i)
        same(f"shape {shape}", torch.randn(shape, generator=g, device=DEVICE))
    for n in (127, 4097, K10_FULL + 3):
        for xo, oo in ((1, 0), (0, 1), (1, 1)):
            out = (torch.empty(n + oo, device=DEVICE)[oo:] if oo else None)
            same(f"n={n} offsets in {xo}, out {oo}",
                 _ring_input(torch, n, torch.float32, 80 + n + xo, xo), out)
    special = torch.tensor(
        [0.0, -0.0, float("inf"), float("-inf"), 1.4e-45, -1.4e-45, 1e-40,
         -1e-40, 1.1754942e-38, -1.1754942e-38, -1.0, -0.5, 3.4e38, -3.4e38,
         1e-8, -1e-8], device=DEVICE)
    same("+-0, +-inf, subnormals", special)
    same("specials repeated, 16-byte vectors", special.repeat(257))
    xs = cc.empty_in(cc.MemKind.S, (4097,), DEVICE)
    outs = cc.empty_in(cc.MemKind.S, (4097,), DEVICE)
    if not (cc.is_managed(xs) and cc.is_managed(outs)):
        raise AssertionError("the S buffers are not managed memory")
    xs.copy_(_ring_input(torch, 4097, torch.float32, 90))
    same("managed input and output", xs, out=outs)
    torch.cuda.synchronize()
    x = torch.ones(8, device=DEVICE)
    refused = []
    for name, call in (
            ("ffi_checksum", lambda: calls.ffi_checksum(x)),
            ("ffi_saxpy", lambda: calls.ffi_saxpy(2.0, x, x)),
            ("tp::clock_ns", lambda: torch.ops.tp.clock_ns(x.device))):
        try:
            call()
        except RuntimeError:  # NotImplementedError is one
            refused.append(name)
            continue
        raise AssertionError(f"{name} ran on a CUDA tensor")
    emit({"phase": "add_one_vs_plain", "cases": cases, "bit_exact": True,
          "memory": ["device", "managed"], "cuda_refused": refused,
          "grid_by_n": grids})
    return cases


def phase_interop_proof(torch, k10, calls, native, cc):
    """The slice's main path, the zero-copy proof on the card, with
    K10's count set to 0 just before and read just after:
    K10 writes its output into managed memory (checked managed), and
    after a synchronize ``tp_checksum_f32_direct`` reads it in place
    through ``data_ptr()``: 4 x 128 for (4, 128) zeros, and
    ``expected_checksum(n) + n`` for ``fill_randomly(2^20)``; K10's
    output in device memory reaches the C++ through ``offload_checksum``
    (staged into pinned memory) and through ``host_checksum`` inside a
    ``torch.compile``d program, each reading 512.  Returns K10's
    launches (4)."""
    from tpu_patterns_torch.comm.verify import expected_checksum, fill_randomly

    lib = native.load()
    n = 1 << 20
    want = {"managed zeros": 4 * 128,
            "managed fill_randomly 2^20": _wrap32(expected_checksum(n) + n),
            "offload_checksum": 4 * 128, "compiled host_checksum": 4 * 128}
    t0 = time.perf_counter()
    prog = torch.compile(lambda t: calls.host_checksum(t), fullgraph=True,
                         backend="aot_eager")
    k10.reset_launches()
    got = {}
    for name, x in (("managed zeros", torch.zeros(K10_PROOF, device=DEVICE)),
                    ("managed fill_randomly 2^20",
                     fill_randomly(n, "float32", seed=4, device=DEVICE))):
        out = cc.empty_in(cc.MemKind.S, x.shape, DEVICE)
        if not cc.is_managed(out):
            raise AssertionError("the proof's output is not managed memory")
        k10.add_one(x, out=out)
        torch.cuda.synchronize()  # before the host reads managed memory
        got[name] = lib.tp_checksum_f32_direct(out.data_ptr(), out.numel())
    y = k10.add_one(torch.zeros(K10_PROOF, device=DEVICE))
    if not calls.stage_to_host(y).is_pinned():
        raise AssertionError("offload staging is not pinned host memory")
    off = calls.offload_checksum(y)
    if off.device.type != "cuda":
        raise AssertionError(f"offload_checksum returned on {off.device}")
    got["offload_checksum"] = int(off[0])
    got["compiled host_checksum"] = int(
        prog(k10.add_one(torch.zeros(K10_PROOF, device=DEVICE)))[0])
    launches = k10.add_one.launches
    emit({"phase": "interop_proof", "checksums": got, "want": want,
          "add_one_launches": launches, "seconds": time.perf_counter() - t0})
    if got != want or launches != 4:
        raise AssertionError(f"interop proof: {got} (want {want}), K10 "
                             f"launches {launches} (want 4)")
    return launches


def phase_interop_cli():
    """``python -m tpu_patterns_torch interop --device cuda`` in a
    process of its own: 7 Records, modes native and offload:gpu, all
    SUCCESS, exit 0."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        jl = os.path.join(tmp, "interop.jsonl")
        r = subprocess.run(
            [sys.executable, "-m", "tpu_patterns_torch", "--jsonl", jl,
             "interop", "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        recs = ([json.loads(ln) for ln in open(jl) if ln.strip()]
                if os.path.exists(jl) else [])
    got = sorted((r_["mode"], r_["commands"], r_["verdict"]) for r_ in recs)
    emit({"phase": "interop_cli", "rc": r.returncode, "records": got,
          "seconds": time.perf_counter() - t0})
    if (r.returncode != 0 or len(got) != 7
            or {m for m, _, _ in got} != {"native", "offload:gpu"}
            or any(v != "SUCCESS" for _, _, v in got)):
        raise AssertionError(f"interop CLI: rc {r.returncode}, {got}: "
                             f"{r.stdout}{r.stderr}")


def phase_add_one_time(torch, k10, ck, timing, spec):
    """K10's ms per launch, L2 flushed before each (the median of 5
    readings of 20 calls, with their min and max), at the proof's (4,
    128) and at 2^25 float32, beside its plain version's, one
    ``torch.add(x, 1.0, out=)`` call's and its byte bound (each element
    read once and written once: 8 bytes); and K10's and that call's
    device time with no host gaps and the host's us to enqueue one
    (:func:`_queued_stats`, no flush: 2^25 moves more than the L2).  At
    (4, 128) a launch's latency, not the bytes, bounds the time.
    Returns the 2^25 row."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    rows = {}
    for i, shape in enumerate((K10_PROOF, (K10_FULL,))):
        g = torch.Generator(device=DEVICE).manual_seed(100 + i)
        x = torch.randn(shape, generator=g, device=DEVICE)
        out = torch.empty_like(x)

        def t(fn):
            return timing.cuda_time_repeated_ms(fn, reps=20, warmup=3,
                                                before=flush.zero_)

        kern = t(lambda: k10.add_one(x, out=out))
        lib = t(lambda: torch.add(x, 1.0, out=out))
        q_kern = _queued_stats(torch, ck, lambda: k10.add_one(x, out=out))
        q_lib = _queued_stats(torch, ck, lambda: torch.add(x, 1.0, out=out))
        bound = 2 * x.numel() * 4 / (spec["hbm_gbps"] * 1e9) * 1e3
        rows["x".join(map(str, shape))] = {
            "ms": kern["ms"], "ms_min": kern["min"], "ms_max": kern["max"],
            "device_ms": q_kern["ms"], "device_ms_min": q_kern["min"],
            "device_ms_max": q_kern["max"],
            "host_us_per_call": q_kern["host_us"],
            "plain_ms": t(lambda: k10.add_one_reference(x))["ms"],
            "library_ms": lib["ms"], "library_ms_min": lib["min"],
            "library_ms_max": lib["max"], "library_device_ms": q_lib["ms"],
            "library_host_us_per_call": q_lib["host_us"],
            "bound_ms": bound, "bound_by": "bytes",
            "device_share_of_bound": bound / q_kern["ms"],
        }
    rows["4x128"]["note"] = ("the launch latency bounds this size; the byte "
                             "bound is far below one launch")
    emit({"phase": "add_one_time", "shape": "float32, per launch; ms: "
          "median of 5 readings of 20 calls, L2 flushed; device_ms: median "
          "of 5 readings of 20 calls queued behind a busy-wait",
          "library": "torch.add(x, 1.0, out=o)", **rows})
    return rows[str(K10_FULL)]


# -- phase 13: the P2P suite ---------------------------------------------------

P2P_WORLDS = (2, 4)  # ranks of the pair exchange, all on the one card
P2P_MARGIN = 1.15  # runtime.SPEC_PLAUSIBILITY_MARGIN


@contextlib.contextmanager
def _env(**vars_):
    """``os.environ`` with ``vars_`` set, restored after."""
    old = {k: os.environ.get(k) for k in vars_}
    os.environ.update(vars_)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _cli_in_process(argv, **env):
    """``python -m tpu_patterns_torch ARGV`` in this process (each
    process costs seconds to reach the card), with ``env`` set: its exit
    code, its stdout and its Records."""
    import tempfile

    from tpu_patterns_torch import cli

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        jl = os.path.join(tmp, "run.jsonl")
        out = io.StringIO()
        with _env(**env), contextlib.redirect_stdout(out):
            rc = cli.main(["--jsonl", jl, *argv])
        recs = ([json.loads(ln) for ln in open(jl) if ln.strip()]
                if os.path.exists(jl) else [])
    return rc, out.getvalue(), recs


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def phase_topo():
    """``topo`` and ``topo 0`` on the card: one device, platform gpu,
    plane [0], the same order in every placement mode, one group."""
    from tpu_patterns_torch.topo import placement

    rc, out, _ = _cli_in_process(["topo", "--device", DEVICE])
    lines = out.splitlines()
    want = ["devices: 1 (gpu), torus 1, 1 core(s)/chip [synthetic coords]",
            "plane 0: [0]",
            *[f"placement {m.value}: [0]" for m in placement.PlacementMode],
            "hierarchy: 1 slice group(s) (1 devices)"]
    rc0, out0, _ = _cli_in_process(["topo", "0", "--device", DEVICE])
    emit({"phase": "topo", "lines": lines, "entry_0": out0.strip()})
    if rc or rc0 or lines != want or out0 != "0\n":
        raise AssertionError(f"topo: rc {rc}/{rc0}, {lines} != {want}; "
                             f"entry {out0!r}")


def phase_p2p(torch, p2p, mesh_mod, spec):
    """``run_p2p`` at the reference's 1,179,648 x 40 float32 (188.74 MB
    a pair) over 2 and 4 ranks on the card, uni and bidirectional: each
    Record SUCCESS with ``checksum_ok`` 1, no ``ici_plausible``, and
    twice its rate (each transfer reads and writes its bytes) at most
    1.15 x the card's memory rate; each receiver's output in storage of
    its own, apart from every input's.  Returns the rows."""
    from tpu_patterns_torch.comm import verify
    from tpu_patterns_torch.core.results import ResultWriter

    cfg = p2p.P2PConfig()
    rows = []
    for n in P2P_WORLDS:
        mesh = mesh_mod.default_mesh(n, DEVICE)
        recs = p2p.run_p2p(mesh, cfg, ResultWriter(stream=io.StringIO()))
        shards = mesh.scatter(verify.fill_randomly(n * cfg.count, cfg.dtype,
                                                   cfg.seed, DEVICE))
        inputs = {_storage(x) for x in shards}
        for rec in recs:
            perm = p2p.pair_permutation(n, rec.mode == "bidirectional")
            out = p2p.pair_exchange(shards, perm)
            torch.cuda.synchronize()
            outs = [_storage(o) for o in out]
            distinct = not inputs & set(outs) and len(set(outs)) == n
            twice = 2 * rec.metrics["bandwidth_GBps"]
            row = {"phase": "p2p", "world": n, "mode": rec.mode,
                   "commands": rec.commands, "verdict": rec.verdict.value,
                   "metrics": rec.metrics, "notes": rec.notes,
                   "distinct_storage": distinct,
                   "twice_rate_over_hbm": twice / spec["hbm_gbps"]}
            emit(row)
            rows.append(row)
            del out
            if (not rec.verdict or rec.metrics["checksum_ok"] != 1.0
                    or "ici_plausible" in rec.metrics or not distinct
                    or twice > P2P_MARGIN * spec["hbm_gbps"]):
                raise AssertionError(f"p2p {n} ranks {rec.mode}: {row}")
        del shards
    return rows


def phase_p2p_placements(torch, p2p, placement):
    """Each of the six placement x mechanism pairs of ``p2p --devices
    2``: a mesh of two ranks on card 0, the CLI's Records SUCCESS, and
    the per-shard checksums after each exchange equal across the six."""
    from tpu_patterns_torch.comm import verify

    cfg = p2p.P2PConfig()
    fill = verify.fill_randomly(2 * cfg.count, cfg.dtype, cfg.seed, DEVICE)
    seen = {}
    for mode in placement.PlacementMode:
        for mech in placement.Mechanism:
            mesh = placement.make_mesh(2, mode, mech, DEVICE)
            shards = mesh.scatter(fill)
            sums = [p2p.shard_checksums(p2p.pair_exchange(
                shards, p2p.pair_permutation(2, bidir)))
                for bidir in (False, True)]
            del shards
            rc, _, recs = _cli_in_process(
                ["p2p", "--devices", "2", "--placement", mode.value,
                 "--mechanism", mech.value, "--reps", "3",
                 "--device", DEVICE])
            got = [(r["mode"], r["verdict"], r["metrics"]["checksum_ok"])
                   for r in recs]
            seen[(mode.value, mech.value)] = sums
            emit({"phase": "p2p_placement", "placement": mode.value,
                  "mechanism": mech.value, "rc": rc,
                  "devices": [str(d) for d in mesh.devices],
                  "checksums": sums, "records": got})
            if (rc or mesh.devices != (torch.device(DEVICE, 0),) * 2
                    or got != [("unidirectional", "SUCCESS", 1.0),
                               ("bidirectional", "SUCCESS", 1.0)]):
                raise AssertionError(f"p2p {mode.value}/{mech.value}: rc "
                                     f"{rc}, {mesh.devices}, {got}")
    if len({json.dumps(v) for v in seen.values()}) != 1:
        raise AssertionError(f"checksums differ across placements: {seen}")


def phase_hier():
    """``hier --devices 4`` at ``HierConfig``'s 2^22 float32 a rank:
    ``--dcn 2`` (2 x 2) and ``--dcn 0`` (one group detected, 1 x 4),
    flat and hier each SUCCESS."""
    for dcn, grid in (("2", "2x2dev"), ("0", "1x4dev")):
        rc, _, recs = _cli_in_process(["hier", "--devices", "4", "--dcn",
                                       dcn, "--device", DEVICE])
        got = [(r["mode"], r["commands"], r["verdict"]) for r in recs]
        emit({"phase": "hier", "dcn": int(dcn), "rc": rc, "records": got,
              "metrics": {r["mode"]: r["metrics"] for r in recs},
              "notes": {r["mode"]: r["notes"] for r in recs}})
        if rc or got != [(m, f"{grid} x 16MB", "SUCCESS")
                         for m in ("flat", "hier")]:
            raise AssertionError(f"hier --dcn {dcn}: rc {rc}, {got}")


def phase_allreduce_placement():
    """``allreduce --devices 4`` at the defaults, compact and spread:
    the same ``validated``, SUCCESS."""
    got = {}
    for mode in ("compact", "spread"):
        rc, _, recs = _cli_in_process(["allreduce", "--devices", "4",
                                       "--placement", mode,
                                       "--device", DEVICE])
        got[mode] = [(r["mode"], r["verdict"], r["metrics"]["validated"])
                     for r in recs]
        if rc:
            raise AssertionError(f"allreduce --placement {mode}: rc {rc}")
    emit({"phase": "allreduce_placement", "records": got})
    if got["spread"] != got["compact"] or got["compact"] != [
            ("xla:ring", "SUCCESS", 1.0)]:
        raise AssertionError(f"allreduce placements: {got}")


def phase_env_tier():
    """``TPU_PATTERNS_REPS=3 python -m tpu_patterns_torch p2p --devices
    2``: the run takes the environment's reps (its progress line), and a
    flag still beats the environment."""
    reps = {}
    for argv in ([], ["--reps", "4"]):
        rc, out, recs = _cli_in_process(
            ["p2p", "--devices", "2", "--bidirectional", "false", *argv,
             "--device", DEVICE], TPU_PATTERNS_REPS="3")
        line = next(ln for ln in out.splitlines() if ln.startswith("# p2p:"))
        reps[" ".join(argv) or "env"] = line
        if rc or [r["verdict"] for r in recs] != ["SUCCESS"]:
            raise AssertionError(f"p2p env tier {argv}: rc {rc}, {recs}")
    emit({"phase": "env_tier", "progress": reps})
    if not (reps["env"].endswith("reps=3")
            and reps["--reps 4"].endswith("reps=4")):
        raise AssertionError(f"env tier: {reps}")


def phase_p2p_suite(torch, spec):
    """Phase 13 (module docstring)."""
    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.comm import p2p
    from tpu_patterns_torch.topo import placement

    t0 = time.perf_counter()
    phase_topo()
    rows = phase_p2p(torch, p2p, mesh_mod, spec)
    phase_p2p_placements(torch, p2p, placement)
    phase_hier()
    phase_allreduce_placement()
    phase_env_tier()
    emit({"phase": "p2p_suite", "seconds": time.perf_counter() - t0,
          "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).strip().splitlines()[0]})
    return rows


# -- phase 14: the load generator on the serve path -------------------------

# the serve model's width (FULL_WIDTH's LoadGenConfig fields), cut to
# depth 2 (the host path a step is per layer: phases 14, 16's loadgen
# race and 23's loadgen leg run at half the serve model's depth)
LOADGEN_WIDTH = dict(
    vocab=2048, embed=1024, heads=8, head_dim=128, mlp_mult=4, depth=2,
    rope=True, slots=8, block_len=16, paged_attn="kernel", device=DEVICE,
    dtype="float32",
)
LOADGEN_PRESETS = ("chat", "rag", "batch-summarize", "agentic",
                   "chat-sampled")
# each preset at half its requests (its arrival process, lengths and SLO
# unchanged): the presets' walls are their arrival schedules
LOADGEN_REQUESTS = {"chat": 16, "rag": 12, "batch-summarize": 12,
                    "agentic": 20, "chat-sampled": 16}
LOADGEN_CHAOS = "loadgen.arrive:error:after=2:count=1"


@contextlib.contextmanager
def _k1_widths(pk):
    """{W: launches} of every K1 launch inside the block: the module's
    ``paged_block`` is swapped for a recorder, and the launches it
    counts are handed back after."""
    import collections

    widths = collections.Counter()
    launch = pk.paged_block

    def recording(q, *a, **k):
        widths[q.shape[1]] += 1
        return launch(q, *a, **k)

    # the kernel's wrapper counts into the module's paged_block, the
    # recorder while it stands there
    recording.launches = launch.launches
    pk.paged_block = recording
    try:
        yield widths
    finally:
        pk.paged_block = launch
        launch.launches = recording.launches


def _loadgen_run(torch, pk, lg, **kw):
    """``run_loadgen`` at the serve model's width with ``kw``: its
    Records and K1's launches in the run (count set to 0 just before,
    read just after) by width."""
    cfg = lg.LoadGenConfig(**{**LOADGEN_WIDTH, **kw})
    pk.paged_block.launches = 0
    t0 = time.perf_counter()
    with _k1_widths(pk) as widths:
        recs = lg.run_loadgen(cfg, lg_writer())
        torch.cuda.synchronize()
    return recs, pk.paged_block.launches, dict(widths), \
        time.perf_counter() - t0


def lg_writer():
    """A ResultWriter whose markers stay out of the smoke's output."""
    from tpu_patterns_torch.core.results import ResultWriter

    return ResultWriter(stream=io.StringIO())


_LG_KEYS = ("goodput", "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms",
            "tpot_p99_ms", "e2e_p50_ms", "e2e_p99_ms", "tokens", "requests",
            "done", "dropped", "deferrals", "sampled_exact",
            "cost_identity_ok", "cost_decode_ms", "cost_prefill_ms")


def _lg_row(rec, **extra) -> dict:
    return {"phase": "loadgen", "mode": rec.mode,
            "verdict": rec.verdict.value,
            **{k: rec.metrics[k] for k in _LG_KEYS if k in rec.metrics},
            **extra}


def loadgen_bf16_flips(torch, lg, runner):
    """``chat-sampled`` served in bfloat16 and held to the fixed-seed
    oracle, reported and not gated: the engine's batched bf16 matmuls
    and the oracle's batch-1 ones round differently, so a draw whose
    Gumbel-perturbed top two lie within that rounding can flip."""
    from tpu_patterns_torch.loadgen import build_schedule
    from tpu_patterns_torch.serve.engine import _oracle_expected

    t_leg = time.perf_counter()
    cfg = lg.LoadGenConfig(**{**LOADGEN_WIDTH, "dtype": "bfloat16",
                              "scenarios": ("chat-sampled",)})
    (spec,) = runner._resolved_specs(cfg)
    mcfg, decoder, params = runner.build_loadgen(cfg, [spec])
    sched = build_schedule(spec, vocab=cfg.vocab, seed=cfg.seed)
    eng, source, wall_s = runner._drive(decoder, params, cfg, spec, sched)
    want = _oracle_expected(mcfg, cfg.vocab, params,
                            [tr.request for tr in sched],
                            max_prompt=spec.max_prompt, max_gen=spec.max_gen)
    flips = []
    for rid, ids in sorted(eng.done.items()):
        if ids != want[rid]:
            step = next(i for i, (a, b) in enumerate(zip(ids, want[rid]))
                        if a != b)
            flips.append({"rid": rid, "step": step, "tokens": len(ids)})
    row = {"phase": "loadgen", "leg": "bf16_chat-sampled",
           "requests": len(sched), "done": len(eng.done),
           "oracle_equal": len(eng.done) - len(flips), "oracle_flips": flips,
           "wall_s": wall_s, "leg_seconds": time.perf_counter() - t_leg,
           "cost_identity_ok": all(
               eng.cost.snapshot()[k] for k in
               ("decode_identity_ok", "prefill_identity_ok",
                "conservation_ok"))}
    emit(row)
    if len(eng.done) != len(sched) or not row["cost_identity_ok"]:
        raise AssertionError("loadgen bf16 leg: a request was lost or the "
                             "cost identities broke")


def loadgen_profile(torch, lg, runner, timing):
    """``chat`` at half its requests (16) under torch.profiler: the
    device's busy and idle share of the run's host wall (the profiler's
    overhead in it), K1's share of busy time and the top device kernels.
    Device activity alone is traced, at half the scenario: gathering a
    whole one's ~74,000 kernel events took ~30 s, more than the run."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_patterns_torch.loadgen import build_schedule

    t_leg = time.perf_counter()
    cfg = lg.LoadGenConfig(**{**LOADGEN_WIDTH,
                              "scenarios": ("chat:requests=16",)})
    (spec,) = runner._resolved_specs(cfg)
    _, decoder, params = runner.build_loadgen(cfg, [spec])
    sched = build_schedule(spec, vocab=cfg.vocab, seed=cfg.seed)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = timing.clock_ns()
        eng, _, _ = runner._drive(decoder, params, cfg, spec, sched)
        torch.cuda.synchronize()
        wall_s = (timing.clock_ns() - t0) / 1e9

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_s = _profile_breakdown(prof, "the loadgen profile")["busy_ms"] / 1e3
    k1_s = sum(dev_us(e) for e in events
               if "paged_attention" in e.key) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:6]
    emit({"phase": "loadgen_profile", "scenario": spec.name,
          "wall_s": wall_s, "device_busy_s": busy_s,
          "device_idle_share": 1 - busy_s / wall_s,
          "paged_attention_share_of_busy": k1_s / busy_s,
          "device_kernels": sum(e.count for e in events),
          "decode_steps": eng.stats["steps"],
          "top_device": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                          "calls": e.count} for e in top],
          "leg_seconds": time.perf_counter() - t_leg})


def phase_loadgen(torch, pk, timing):
    """Phase 14 (module docstring).  Returns K1's launches by scenario."""
    from tpu_patterns_torch import loadgen as lg
    from tpu_patterns_torch.loadgen import runner

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # throwaway: the first launches of the decode and sampling paths
    recs, launches, _, wall = _loadgen_run(
        torch, pk, lg, scenarios=("chat:requests=8",
                                  "chat-sampled:requests=8"))
    emit({"phase": "loadgen", "leg": "warmup", "seconds": wall,
          "verdicts": [r.verdict.value for r in recs],
          "kernel_launches": launches})
    bad = []
    by_scenario = {}
    for name in LOADGEN_PRESETS:
        kw = {"scenarios": (f"{name}:requests={LOADGEN_REQUESTS[name]}",)}
        if name == "chat":
            kw["chaos"] = LOADGEN_CHAOS
        recs, launches, widths, wall = _loadgen_run(torch, pk, lg, **kw)
        by_scenario[name] = launches
        clean = recs[0]
        emit(_lg_row(clean, kernel_launches=launches, launch_widths=widths,
                     wall_s=wall))
        if clean.verdict.value != "SUCCESS":
            bad.append(f"{clean.mode} {clean.verdict.value}: "
                       + "; ".join(clean.notes))
        if clean.metrics["cost_identity_ok"] != 1.0:
            bad.append(f"{clean.mode}: cost identities broke")
        if launches <= 0 or set(widths) != {1}:
            bad.append(f"{clean.mode}: K1 launches {launches} at {widths}")
        if name == "chat-sampled" and clean.metrics["sampled_exact"] != 1.0:
            bad.append(f"{clean.mode}: sampled ids left the oracle")
        if name == "chat":
            chaos = recs[1]
            m = chaos.metrics
            emit({"phase": "loadgen", "mode": chaos.mode,
                  "verdict": chaos.verdict.value, **m})
            # a dropped arrival heals: the reference's verdict is WARNING
            if (chaos.verdict.value != "WARNING" or m["dropped"] != 1
                    or m["covered"] != 1 or m["injected"] < 1
                    or m["done"] + m["failed"] + m["dropped"]
                    != m["requests"]):
                bad.append(f"{chaos.mode} {chaos.verdict.value}: {m}")
    recs, launches, widths, wall = _loadgen_run(
        torch, pk, lg, scenarios=(
            f"chat-sampled:requests={LOADGEN_REQUESTS['chat-sampled']}",),
        spec_k=SPEC_K)
    rec = recs[0]
    by_scenario[f"chat-sampled spec_k{SPEC_K}"] = launches
    emit(_lg_row(rec, spec_k=SPEC_K, kernel_launches=launches,
                 launch_widths=widths, wall_s=wall))
    if (rec.verdict.value != "SUCCESS"
            or rec.metrics["sampled_exact"] != 1.0
            or rec.metrics["cost_identity_ok"] != 1.0
            or widths.get(SPEC_K + 1, 0) <= 0):
        bad.append(f"spec_k {SPEC_K} {rec.mode} {rec.verdict.value}: "
                   f"{rec.metrics['sampled_exact']}, widths {widths}; "
                   + "; ".join(rec.notes))
    loadgen_bf16_flips(torch, lg, runner)
    loadgen_profile(torch, lg, runner, timing)
    # the CLI at a small width K1 takes (head_dim 32)
    t_leg = time.perf_counter()
    rc, _, cli_recs = _cli_in_process(
        ["loadgen", "--device", "cuda", "--scenarios",
         "chat:requests=8,chat-sampled:requests=8", "--time_scale", "0.25",
         "--embed", "256", "--head_dim", "32"])
    emit({"phase": "loadgen_cli", "rc": rc,
          "modes": [r["mode"] for r in cli_recs],
          "verdicts": [r["verdict"] for r in cli_recs],
          "leg_seconds": time.perf_counter() - t_leg})
    if rc != 0 or [r["verdict"] for r in cli_recs] != ["SUCCESS"] * 2:
        bad.append(f"loadgen CLI rc {rc}")
    emit({"phase": "loadgen_phase", "seconds": time.perf_counter() - t_phase,
          "k1_launches": by_scenario,
          "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).strip().splitlines()[0]})
    if bad:
        raise AssertionError("loadgen: " + " | ".join(bad))
    return by_scenario


# -- phase 15: decode and lm on the card --------------------------------------

# the float32 teacher-forced check at the decode width: batch 2, a
# 512-token prefill, 16 steps fed the true next input
DECODE_EXACT = dict(batch=2, prefill=512, steps=16)
DECODE_EXACT_EPS = 256  # bound: this many float32 eps of the output's max


def _decode_leg(torch, D, **kw):
    """``run_decode`` at ``DecodeConfig``'s defaults with ``kw``: its
    Record and the run's peak device memory."""
    cfg = D.DecodeConfig(device=DEVICE, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec, = D.run_decode(cfg, lg_writer())
    torch.cuda.synchronize()
    return cfg, rec, torch.cuda.max_memory_allocated(), \
        time.perf_counter() - t0


def decode_byte_floor_ms(torch, D, tr, cfg, spec) -> float:
    """The least time of one decode step: every cache slot and every
    weight read once (the dense attention reads the whole cache, written
    or not), over the card's memory rate."""
    mcfg = D.model_config(cfg)
    lc = cfg.prefill + cfg.gen
    cache = cfg.depth * cfg.batch * lc * D.kv_slot_bytes(
        cfg.head_dim, mcfg.n_kv, mcfg.torch_dtype, cfg.cache_int8)
    itemsize = torch.empty((), dtype=mcfg.torch_dtype).element_size()
    weights = cfg.depth * sum(math.prod(s) for s in
                              tr.param_shapes(mcfg).values()) * itemsize
    return (cache + weights) / (spec["hbm_gbps"] * 1e9) * 1e3


def decode_exact(torch, D, tr):
    """The teacher-forced check at the decode width in float32 with TF32
    off, MHA and GQA 2 with RoPE: its max error against its bound."""
    rows = []
    for kw in (dict(), dict(kv_heads=2, rope=True)):
        d = D.DecodeConfig()
        cfg = tr.ModelConfig(embed=d.embed, heads=d.heads,
                             head_dim=d.head_dim, mlp_mult=d.mlp_mult,
                             depth=d.depth, dtype="float32", **kw)
        n = DECODE_EXACT
        with D._exact_matmuls(torch.device(DEVICE)):
            params = D._stacked_params(0, cfg, DEVICE)
            x = D._probe_input(1, (n["batch"], n["prefill"] + n["steps"],
                                   cfg.embed), DEVICE)
            got, want = D.teacher_forced(cfg, params, x, n["prefill"])
        scale = max(1.0, float(abs(want).max()))
        err = float(abs(got - want).max())
        bound = DECODE_EXACT_EPS * float(torch.finfo(torch.float32).eps) \
            * scale
        row = {"phase": "decode_exact_f32", "kv_heads": cfg.kv_heads,
               "rope": cfg.rope, **n, "depth": cfg.depth,
               "positions": got.shape[1], "max_abs_err": err,
               "scale": scale, "bound": bound,
               "err_in_eps_of_scale": err / scale
               / float(torch.finfo(torch.float32).eps),
               "tolerance": f"{DECODE_EXACT_EPS} eps(f32) x max(1, max|ref|)",
               "tf32": torch.backends.cuda.matmul.allow_tf32}
        emit(row)
        rows.append(row)
    return rows


def decode_profile(torch, D, timing):
    """One ``generate(…, 128)`` call at ``DecodeConfig``'s defaults under
    torch.profiler (device activity): the device's busy and idle share
    of its wall and its launches a token step, beside the same call's
    unprofiled wall (host clock, synchronized) and ``run_decode``'s
    timed chain over the same calls (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = D.DecodeConfig(device=DEVICE)
    mcfg = D.model_config(cfg)
    prefill, generate = D.make_decoder(mcfg, cfg.batch, cfg.prefill,
                                       cfg.gen, donate=True)
    params = D._stacked_params(cfg.seed, mcfg, DEVICE)
    x = D._probe_input(cfg.seed + 1, (cfg.batch, cfg.prefill, cfg.embed),
                       DEVICE).to(mcfg.torch_dtype)
    caches, y0 = prefill(params, x)

    def call():
        torch.cuda.synchronize()
        t0 = timing.clock_ns()
        generate(params, caches, y0, cfg.prefill, cfg.gen)
        torch.cuda.synchronize()
        return (timing.clock_ns() - t0) / 1e9

    call()  # warm
    unprofiled_s = min(call() for _ in range(3))

    def build_chain(k: int):  # run_decode's timed chain, the same calls
        def run():
            c, y = {n: v.clone() for n, v in caches.items()}, y0
            for _ in range(k):
                c, out = generate(params, c, y, cfg.prefill, cfg.gen)
                y = out[:, -1:, :]

        return run

    chain = timing.measure_chain(build_chain, reps=cfg.reps,
                                 warmup=cfg.warmup, device=DEVICE)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_s = call()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy_s = _profile_breakdown(prof, "the decode profile")["busy_ms"] / 1e3
    launches = sum(e.count for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:6]
    row = {"phase": "decode_profile", "steps": cfg.gen, "wall_s": wall_s,
           "unprofiled_wall_s": unprofiled_s,
           "unprofiled_ms_per_step": unprofiled_s * 1e3 / cfg.gen,
           "chain_ms_per_step": chain.per_op_ns / 1e6 / cfg.gen,
           "chain_converged": chain.converged, "device_busy_s": busy_s,
           "device_busy_share": busy_s / wall_s,
           "device_idle_share": 1 - busy_s / wall_s,
           "idle_share_vs_unprofiled_wall": 1 - busy_s / unprofiled_s,
           "device_launches": launches,
           "launches_per_step": launches / cfg.gen,
           "device_ms_per_step": busy_s * 1e3 / cfg.gen,
           "top_device": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                           "calls": e.count} for e in top]}
    emit(row)
    return row


@contextlib.contextmanager
def _lm_ids(lm):
    """Every ``generate`` output of the LM decoders made inside the
    block (``run_lm`` warms the call, then times a second), as (the
    decoder's mesh or None, its ids: a tensor, or per-rank lists over a
    mesh)."""
    seen = []
    real = lm.make_lm_decoder

    def recording(*a, **k):
        pre, gen = real(*a, **k)

        def gen_rec(*ga, **gk):
            out = gen(*ga, **gk)
            seen.append((k.get("mesh"), out[1]))
            return out

        return pre, gen_rec

    lm.make_lm_decoder = recording
    try:
        yield seen
    finally:
        lm.make_lm_decoder = real


def phase_decode_lm(torch, pk, F, timing, spec):
    """Phase 15 (module docstring).  Returns K1's and K2-K4's launches
    in the phase (each must be 0)."""
    from tpu_patterns_torch.models import decode as D
    from tpu_patterns_torch.models import lm
    from tpu_patterns_torch.models import transformer as tr

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pk.paged_block.launches = 0
    F.reset_launches()
    bad = []
    for name, kw, want_mb in (
            ("main", {}, 553.648),
            ("gqa2_rope_int8", dict(kv_heads=2, rope=True, cache_int8=True),
             None)):
        cfg, rec, peak, wall = _decode_leg(torch, D, **kw)
        floor_ms = decode_byte_floor_ms(torch, D, tr, cfg, spec)
        m = rec.metrics
        emit({"phase": "decode", "leg": name, "mode": rec.mode,
              "commands": rec.commands, "verdict": rec.verdict.value,
              **m, "byte_floor_ms_per_token": floor_ms,
              "byte_floor_share": floor_ms / m["ms_per_token"],
              "peak_device_MB": peak / 1e6, "leg_seconds": wall,
              "notes": rec.notes})
        if rec.verdict.value != "SUCCESS":
            bad.append(f"decode {rec.mode} {rec.verdict.value}: "
                       + "; ".join(rec.notes))
        if want_mb is not None and m["cache_MB"] != want_mb:
            bad.append(f"decode cache_MB {m['cache_MB']}, want {want_mb}")
        if name != "main" and rec.mode != "sp1_gqa2_rope_int8":
            bad.append(f"decode mode {rec.mode}")
    for row in decode_exact(torch, D, tr):
        if not row["max_abs_err"] <= row["bound"]:
            bad.append(f"decode f32 teacher-forced error {row['max_abs_err']}"
                       f" above {row['bound']}")
    decode_profile(torch, D, timing)

    legs = (("greedy", {}), ("sampled", dict(temperature=0.8, top_k=16)),
            ("sampled_again", dict(temperature=0.8, top_k=16)))
    ids = []
    for name, kw in legs:
        t0 = time.perf_counter()
        with _lm_ids(lm) as seen:
            rec, = lm.run_lm(lm.LMConfig(device=DEVICE, **kw), lg_writer())
        emit({"phase": "lm", "leg": name, "mode": rec.mode,
              "commands": rec.commands, "verdict": rec.verdict.value,
              **rec.metrics, "notes": rec.notes,
              "leg_seconds": time.perf_counter() - t0})
        if rec.verdict.value != "SUCCESS":
            bad.append(f"lm {rec.mode} {rec.verdict.value}: "
                       + "; ".join(rec.notes))
        ids.append(seen[-1][1].cpu())
    greedy_ids, sampled_ids = ids[0], ids[1:]
    same = torch.equal(*sampled_ids)
    emit({"phase": "lm", "leg": "sampled_repeat", "ids_equal": same,
          "ids_shape": list(sampled_ids[0].shape),
          "share_unlike_greedy": float(
              (sampled_ids[0] != greedy_ids).float().mean())})
    if not same:
        bad.append("lm: two sampled runs at one seed drew different ids")

    for argv, marker in ((["decode", "--prefill", "512", "--gen", "16",
                           "--reps", "2"], "sp1"), (["lm", "--steps", "4"],
                                                   "V1024")):
        t0 = time.perf_counter()
        rc, out, recs = _cli_in_process(argv)
        ok = rc == 0 and f"## {marker} |" in out and "| SUCCESS" in out
        emit({"phase": "decode_lm_cli", "argv": argv, "rc": rc,
              "verdicts": [r["verdict"] for r in recs],
              "leg_seconds": time.perf_counter() - t0})
        if not ok:
            bad.append(f"{' '.join(argv)}: rc {rc}")
    try:
        _cli_in_process(["loadgen", "--dp", "2"])
        refused = None
    except SystemExit as e:
        refused = str(e.code)
    emit({"phase": "decode_lm_cli", "argv": ["loadgen", "--dp", "2"],
          "exit": refused})
    if refused is None or "loadgen requires --dp 1" not in refused:
        bad.append("loadgen --dp 2 was not refused")

    torch.cuda.synchronize()
    launches = {"paged_attention": pk.paged_block.launches, **F.LAUNCHES}
    emit({"phase": "decode_lm_phase", "seconds": time.perf_counter() - t_phase,
          "kernel_launches": launches,
          "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).strip().splitlines()[0]})
    if any(launches.values()):
        bad.append(f"decode/lm launched kernels: {launches}")
    if bad:
        raise AssertionError("decode/lm: " + " | ".join(bad))
    return launches


# -- phase 16: the kv tier, preemption and snapshots on the serve path -------

# the serve model at full width in float32 (ids are gated)
KV_WIDTH = dict(FULL_WIDTH, dtype="float32")
# the session trace's size in legs a and b (16 conversations, 2 turns):
# at the default 16 requests (10 conversations) the retained prefixes
# fit the 26-block pool and nothing evicts, in the JAX package's run
# alike
KV_REQUESTS = 32
# the loadgen race: the JAX package's own tier-race traffic, its
# ``serve.kv_tier`` sweep cell (tpu_patterns/sweep.py, ``serve_specs``):
# one 2-block shared prefix, prompts pinned so that every request needs
# exactly 5 blocks, a pool 1/1.4 of the 8 slots' working set, arrivals
# at 0.02 of real time.  Its token lengths are doubled for block_len 16
# (the cell runs block_len 8), so the block counts stay the cell's: the
# defer-only engine fits 5 rows of 8, the tier (aliasing the prefix) 8
KV_LOADGEN = ("chat:requests=16:min_prompt=52:mean_prompt=56:max_prompt=60"
              ":min_gen=16:mean_gen=18:max_gen=20"
              ":prefix_groups=1:shared_prefix=32:working_set_mult=1.4"
              ":slo_ttft_ms=60000:slo_tpot_ms=20000")
KV_LOADGEN_TIME_SCALE = 0.02
# readings of leg e in ``--tree . kv_race`` (its spread, PERF.md)
KV_RACE_REPS = 8
# priority preemption at the engine: 2 slots of running bulk rows, and
# interactive requests behind them that claim slots by parking bulk
KV_PREEMPT_BLOCKS = 33  # 4 rows x 8 blocks of 16, + trash


def _k1_leg(torch, pk, fn):
    """``fn()`` with K1's count set to 0 just before and read just after:
    (its result, launches, {W: launches}, seconds)."""
    pk.paged_block.launches = 0
    t0 = time.perf_counter()
    with _k1_widths(pk) as widths:
        out = fn()
        torch.cuda.synchronize()
    return out, pk.paged_block.launches, dict(widths), \
        time.perf_counter() - t0


def _serve_argv(cfg: dict) -> list[str]:
    """``serve`` flags for the ServeConfig fields in ``cfg``."""
    argv = ["serve"]
    for k, v in cfg.items():
        argv += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    return argv


def _tier_ms(rec) -> dict:
    return {k: rec.config.get(k) for k in ("evict_ms", "commit_ms",
                                           "onload_ms")}


def kv_cli_preempt_resume(torch, pk, eng_mod, faults, work, name, site,
                          **kw):
    """``serve --snapshot_dir`` at the serve width with ``site:preempt``
    after 4 steps (a WARNING Record, a committed step), then ``--resume
    true --ids_out``: SUCCESS, exact, and the ids file equal to an
    uninterrupted engine's on the same trace.  Returns (problems, K1's
    launches in each run)."""
    from tpu_patterns_torch import ckpt as tc

    bad = []
    snap = os.path.join(work, f"snap_{name}")
    ids = os.path.join(work, f"ids_{name}.json")
    flags = dict(KV_WIDTH, requests=8, gen=32, **kw)
    argv = _serve_argv(flags) + ["--snapshot_dir", snap]
    faults.configure(f"{site}:preempt:after=4:count=1")
    try:
        (rc, _, recs), n1, w1, s1 = _k1_leg(
            torch, pk, lambda: _cli_in_process(argv))
    finally:
        faults.configure(None)
    step = tc.latest_step(snap)
    rec = recs[0] if recs else {}
    emit({"phase": "kv_tier", "leg": f"c_{name}_preempt", "rc": rc,
          "mode": rec.get("mode"), "verdict": rec.get("verdict"),
          "metrics": rec.get("metrics"), "committed_step": step,
          "kv_tier_launches": n1, "launch_widths": w1, "seconds": s1})
    launches = {f"c_{name}_preempt": n1}
    if (rc != 0 or rec.get("verdict") != "WARNING"
            or rec["metrics"]["preempted"] != 1.0 or step is None
            or n1 <= 0):
        bad.append(f"c {name}: preempt leg rc {rc} {rec}, K1 {n1}")
        return bad, launches
    (rc, _, recs), n2, w2, s2 = _k1_leg(torch, pk, lambda: _cli_in_process(
        argv + ["--resume", "true", "--ids_out", ids]))
    launches[f"c_{name}_resume"] = n2
    rec = recs[0] if recs else {}
    cfg = eng_mod.ServeConfig(**flags)
    mcfg, decoder, params, trace = eng_mod.build_serve(cfg)
    if cfg.prefix_share:
        trace, _ = eng_mod.shared_trace(cfg)
    want = eng_mod.ServeEngine(decoder, params, slots=cfg.slots,
                               prefix_share=cfg.prefix_share,
                               spec_k=cfg.spec_k).run(trace)
    got = {}
    if os.path.exists(ids):
        with open(ids) as f:
            got = {int(k): v for k, v in json.load(f)["done"].items()}
    emit({"phase": "kv_tier", "leg": f"c_{name}_resume", "rc": rc,
          "mode": rec.get("mode"), "verdict": rec.get("verdict"),
          "metrics": rec.get("metrics"), "ids_equal_uninterrupted":
          got == want, "kv_tier_launches": n2, "launch_widths": w2,
          "seconds": s2})
    if (rc != 0 or rec.get("verdict") != "SUCCESS"
            or rec["metrics"]["exact"] != 1.0 or got != want or n2 <= 0):
        bad.append(f"c {name}: resume leg rc {rc} {rec}, ids equal "
                   f"{got == want}, K1 {n2}")
    if cfg.spec_k and w2.get(cfg.spec_k + 1, 0) <= 0:
        bad.append(f"c {name}: no K1 launch at W = {cfg.spec_k + 1} after "
                   f"the resume ({w2})")
    return bad, launches


def kv_priority_preempt(torch, pk, eng_mod, sampled: bool):
    """The reference's interactive-preempts-bulk shape at the serve
    width: 2 slots, 2 bulk rows admitted first, 2 interactive requests
    behind them.  The preempting engine's ids must equal an unpreempted
    engine's; every banked partial retired; each request's lifecycle
    n_out its n_gen.  Returns (row, problems)."""
    import numpy as np

    from tpu_patterns_torch.models.lm import init_lm_params
    from tpu_patterns_torch.serve.paged import make_paged_lm_decoder

    cfg = eng_mod.ServeConfig(**KV_WIDTH)
    mcfg = eng_mod.model_config(cfg)
    decoder = make_paged_lm_decoder(
        mcfg, cfg.vocab, n_blocks=KV_PREEMPT_BLOCKS, block_len=16,
        max_len=128, attn="kernel", sampling=sampled, device=DEVICE)
    params = decoder.stack_params(init_lm_params(cfg.seed, mcfg, cfg.vocab,
                                                 DEVICE))
    rng = np.random.RandomState(9)
    reqs = []
    for i in range(4):
        bulk = i < 2
        reqs.append(eng_mod.Request(
            rid=i, tokens=rng.randint(0, cfg.vocab,
                                      size=rng.randint(40, 90)).tolist(),
            n_gen=24 if bulk else 6,
            priority="bulk" if bulk else "interactive",
            temperature=0.8 if sampled else 0.0,
            top_k=16 if sampled else 0, seed=100 + i))
    want = eng_mod.ServeEngine(decoder, params, slots=2).run(
        [dataclasses.replace(r) for r in reqs])
    eng = eng_mod.ServeEngine(decoder, params, slots=2, kv_host_tier=True,
                              preempt="bulk")
    out, launches, widths, secs = _k1_leg(
        torch, pk, lambda: eng.run([dataclasses.replace(r) for r in reqs]))
    n_out = {rid: lc["n_out"] for rid, lc in eng.lifecycle.items()}
    st = eng.stats
    row = {"phase": "kv_tier", "leg": "d_" + ("sampled" if sampled
                                               else "greedy"),
           "ids_equal_unpreempted": out == want,
           "preempted": st["preempted"],
           "preempted_resumed": st["preempted_resumed"],
           "evictions": st["evictions"], "onload_hits": st["onload_hits"],
           "banked_left": len(eng.preempted_partial),
           "lifecycle_n_out_ok": n_out == {r.rid: r.n_gen for r in reqs},
           "leaked_blocks": eng.leaked_blocks(),
           "kv_tier_launches": launches, "launch_widths": widths,
           "seconds": secs}
    bad = []
    if not (out == want and st["preempted"] >= 1
            and st["preempted_resumed"] >= 1 and not eng.preempted_partial
            and row["lifecycle_n_out_ok"] and row["leaked_blocks"] == 0
            and launches > 0):
        bad.append(f"d {row['leg']}: {row}")
    return row, bad


def kv_loadgen_race(torch, pk, lg):
    """Leg e: ``run_loadgen`` on :data:`KV_LOADGEN` with ``kv_host_tier``,
    its Records printed, then a ``e_loadgen_run`` line with the race's
    counts.  Beside the Record's verdict (which reads tokens/s on the
    host's clock) it holds the counts the schedule decides: the
    defer-only leg defers, the tier leg never does, and the tier leg
    decodes in fewer steps.  Returns (that line, problems)."""
    recs, n, widths, secs = _k1_leg(torch, pk, lambda: lg.run_loadgen(
        lg.LoadGenConfig(**LOADGEN_WIDTH, scenarios=(KV_LOADGEN,),
                         kv_host_tier=True,
                         time_scale=KV_LOADGEN_TIME_SCALE),
        lg_writer()))
    for rec in recs:
        emit({"phase": "kv_tier", "leg": "e_loadgen", "mode": rec.mode,
              "verdict": rec.verdict.value, **rec.metrics,
              **_tier_ms(rec), "notes": rec.notes})
    race = [r for r in recs if r.mode.endswith("_kv_tier_sp1")]
    row = {"phase": "kv_tier", "leg": "e_loadgen_run",
           "kv_tier_launches": n, "launch_widths": widths, "seconds": secs}
    if len(race) != 1:
        return row, [f"e: no race Record in {[r.mode for r in recs]}"]
    m, cfg = race[0].metrics, race[0].config
    row.update(verdict=race[0].verdict.value,
               goodput_speedup=m["goodput_speedup"],
               deferrals=m["deferrals"],
               defer_baseline_deferrals=m["defer_baseline_deferrals"],
               decode_steps=cfg.get("decode_steps"),
               defer_decode_steps=cfg.get("defer_decode_steps"))
    emit(row)
    bad = []
    if race[0].verdict.value != "SUCCESS" or n <= 0:
        bad.append(f"e: {race[0].verdict.value} {m} {race[0].notes}")
    if not (m["defer_baseline_deferrals"] > 0 and m["deferrals"] == 0
            and row["decode_steps"] < row["defer_decode_steps"]):
        bad.append(f"e: the schedule's counts {row}")
    return row, bad


def phase_kv_race(torch, pk):
    """``--tree . kv_race``: leg e :data:`KV_RACE_REPS` times in one
    process (after one run that warms the kernels and the allocator),
    then a ``kv_race_spread`` line: each reading's ``goodput_speedup``
    and decode steps, their min, median and max.  Fails if any
    reading's leg fails."""
    from tpu_patterns_torch import loadgen as lg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kv_loadgen_race(torch, pk, lg)
    rows, bad = [], []
    for _ in range(KV_RACE_REPS):
        row, problems = kv_loadgen_race(torch, pk, lg)
        rows.append(row)
        bad += problems
    ups = sorted(r.get("goodput_speedup", 0.0) for r in rows)
    emit({"phase": "kv_race_spread", "readings": len(rows),
          "goodput_speedup": [r.get("goodput_speedup") for r in rows],
          "min": ups[0], "median": ups[len(ups) // 2], "max": ups[-1],
          "decode_steps": [r.get("decode_steps") for r in rows],
          "defer_decode_steps": [r.get("defer_decode_steps") for r in rows],
          "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).strip().splitlines()[0]})
    if bad:
        raise AssertionError("kv race: " + " | ".join(bad))


def phase_kv_tier(torch, pk):
    """Phase 16 (module docstring).  Returns K1's launches by leg."""
    import shutil

    from tpu_patterns_torch import faults
    from tpu_patterns_torch import loadgen as lg
    from tpu_patterns_torch.serve import engine as eng_mod

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(ROOT, "build", "kv_tier_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bad = []
    launches = {}
    try:
        # a. the tier race
        (rec,), n, widths, secs = _k1_leg(torch, pk, lambda: eng_mod.run_serve(
            eng_mod.ServeConfig(**KV_WIDTH, requests=KV_REQUESTS,
                                kv_host_tier=True), lg_writer()))
        launches["a_tier_race"] = n
        m = rec.metrics
        emit({"phase": "kv_tier", "leg": "a_tier_race", "mode": rec.mode,
              "verdict": rec.verdict.value, **m, **_tier_ms(rec),
              "kv_tier_launches": n, "launch_widths": widths,
              "seconds": secs, "notes": rec.notes})
        if (rec.verdict.value != "SUCCESS" or m["exact"] != 1.0
                or not m["defer_baseline_deferrals"] > 0
                or m["deferrals"] != 0 or not m["pressure_admits"] > 0
                or not m["evictions"] > 0 or not m["onload_hits"] > 0
                or m["leaked_blocks"] != 0 or not m["goodput_speedup"] > 1.0
                or n <= 0):
            bad.append(f"a: {rec.verdict.value} {m} {rec.notes}")
        # b. the session cache, twice over one directory
        sess = os.path.join(work, "sess")
        for turn in (1, 2):
            (rec,), n, _, secs = _k1_leg(
                torch, pk, lambda: eng_mod.run_serve(eng_mod.ServeConfig(
                    **KV_WIDTH, requests=KV_REQUESTS, kv_host_tier=True,
                    session_dir=sess), lg_writer()))
            launches[f"b_session_{turn}"] = n
            m = rec.metrics
            emit({"phase": "kv_tier", "leg": f"b_session_{turn}",
                  "mode": rec.mode, "verdict": rec.verdict.value, **m,
                  **_tier_ms(rec), "kv_tier_launches": n, "seconds": secs,
                  "notes": rec.notes})
            if rec.verdict.value != "SUCCESS" or m["exact"] != 1.0 or n <= 0:
                bad.append(f"b{turn}: {rec.verdict.value} {m} {rec.notes}")
            if turn == 2 and not (m["session_loaded"] > 0
                                  and m["prompt_fresh_full_blocks"] == 0):
                bad.append(f"b2: the restart prefilled history {m}")
        # c. preempt -> snapshot -> resume through the CLI
        for name, site, kw in (
                ("greedy", "serve.step", {}),
                ("shared_spec", "serve.verify",
                 dict(prefix_share=True, spec_k=SPEC_K))):
            problems, counts = kv_cli_preempt_resume(
                torch, pk, eng_mod, faults, work, name, site, **kw)
            bad += problems
            launches.update(counts)
        # d. priority preemption at the engine, greedy and sampled
        for sampled in (False, True):
            row, problems = kv_priority_preempt(torch, pk, eng_mod, sampled)
            emit(row)
            launches[row["leg"]] = row["kv_tier_launches"]
            bad += problems
        # e. the loadgen race
        row, problems = kv_loadgen_race(torch, pk, lg)
        launches["e_loadgen"] = row["kv_tier_launches"]
        bad += problems
    finally:
        faults.configure(None)
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "kv_tier_phase", "seconds": time.perf_counter() - t_phase,
          "kv_tier_launches": launches,
          "card": _run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).strip().splitlines()[0]})
    if bad:
        raise AssertionError("kv tier: " + " | ".join(bad))
    return launches


# -- phase 17: recovery and the obs plane on the serve path, through K1 -------

# the serve trace of legs a, d and f: the serve model's random trace
REC_REQUESTS = 8
REC_GEN = 16
# leg b: ``scripts/chaos_smoke.py`` leg (d) at dp = tp = 1, its serve
# trace flags (SERVE_ARGS there: 8 requests, prompts 4-24, gen 6, 4
# slots) at the serve model's width
REC_CHAOS_SERVE = dict(requests=8, min_prompt=4, max_prompt=24, gen=6,
                       slots=4, prefix_share=True, spec_k=SPEC_K,
                       shared_prefix=16)
REC_VERIFY_FAULT = "serve.verify:error:after=2:count=99"
# leg c: the JAX package's ``loadgen.chaos_chat`` sweep cell
# (tpu_patterns/sweep.py, ``loadgen_specs``, the full shape)
REC_CHAOS_CHAT = dict(scenarios=("chat",), time_scale=0.05,
                      slo_ttft_ms=30000.0, slo_tpot_ms=5000.0,
                      chaos="serve.step:error:count=1,"
                            "serve.step:error:after=6:count=1",
                      chaos_p99_mult=50.0)
# leg f: readings of each of obs off and obs on, alternating
REC_OBS_READINGS = 4


def _smi() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).strip().splitlines()[0]


def _counter(obs, name, **labels) -> float:
    return obs.counter(name, **labels).value


def _fast_policy(faults):
    return faults.RetryPolicy(max_attempts=2, backoff_base_s=0.0,
                              jitter_frac=0.0)


def _free_port() -> int:
    """An ephemeral port of 127.0.0.1, asked of the kernel by binding
    port 0 (the plane's own ``ObsHttp(0)`` semantics; the CLI's
    ``--obs_http 0`` means off, as the JAX package's config reads it)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _engine_run(torch, pk, eng, trace):
    """``eng.run`` over a copy of ``trace`` as a K1 leg: (ids, launches,
    {W: launches}, seconds)."""
    return _k1_leg(torch, pk, lambda: eng.run(
        [dataclasses.replace(r) for r in trace]))


def rec_transient(torch, pk, eng_mod, faults, obs, decoder, params, mcfg,
                  cfg, trace):
    """Leg a: ``error:count=1`` at each of serve.prefill, serve.step and
    serve.verify (spec_k 4): ids equal to the unfaulted run's and the
    dense oracle's, one retry counted at the site, nothing
    quarantined."""
    bad, launches = [], {}
    want = eng_mod._dense_expected(mcfg, cfg, params, trace)
    clean = {}
    for spec_k in (0, SPEC_K):
        out, n, _, _ = _engine_run(torch, pk, eng_mod.ServeEngine(
            decoder, params, slots=cfg.slots, spec_k=spec_k), trace)
        clean[spec_k] = out
        launches[f"a_clean_k{spec_k}"] = n
        if out != want:
            bad.append(f"a: unfaulted spec_k {spec_k} differs from the "
                       "dense oracle")
    for site in ("serve.prefill", "serve.step", "serve.verify"):
        spec_k = SPEC_K if site == "serve.verify" else 0
        before = _counter(obs, "tpu_patterns_faults_retries_total",
                          site=site)
        eng = eng_mod.ServeEngine(decoder, params, slots=cfg.slots,
                                  spec_k=spec_k,
                                  retry_policy=_fast_policy(faults))
        faults.configure(f"{site}:error:count=1")
        try:
            out, n, widths, secs = _engine_run(torch, pk, eng, trace)
        finally:
            faults.configure(None)
        retries = _counter(obs, "tpu_patterns_faults_retries_total",
                           site=site) - before
        ok = (out == clean[spec_k] == want and not eng.failed
              and retries == 1 and n > 0)
        emit({"phase": "recovery", "leg": f"a_{site}", "ok": ok,
              "exact_vs_unfaulted": out == clean[spec_k],
              "exact_vs_dense": out == want, "retries": retries,
              "quarantined": len(eng.failed), "steps": eng.stats["steps"],
              "recovery_launches": n, "launch_widths": widths,
              "seconds": secs})
        launches[f"a_{site}"] = n
        if not ok:
            bad.append(f"a {site}: exact {out == want} retries {retries} "
                       f"failed {eng.failed} launches {n}")
    return bad, launches


def rec_verify_fault(torch, pk, faults, work):
    """Leg b: chaos-smoke leg (d) through the port's CLI: exit 0 with a
    WARNING Record, rows quarantined, done + quarantined = 8, no leaked
    block."""
    flags = dict(KV_WIDTH, **REC_CHAOS_SERVE)
    argv = _serve_argv(flags) + ["--snapshot_dir",
                                 os.path.join(work, "snap_v")]
    faults.configure(REC_VERIFY_FAULT)
    try:
        (rc, _, recs), n, widths, secs = _k1_leg(
            torch, pk, lambda: _cli_in_process(argv))
    finally:
        faults.configure(None)
    rec = recs[-1] if recs else {}
    m = rec.get("metrics", {})
    ok = (rc == 0 and rec.get("verdict") == "WARNING"
          and m.get("quarantined", 0) > 0
          and m.get("done_requests", 0) + m.get("quarantined", 0) == 8
          and m.get("leaked_blocks") == 0.0 and n > 0)
    emit({"phase": "recovery", "leg": "b_verify_fault", "ok": ok, "rc": rc,
          "mode": rec.get("mode"), "verdict": rec.get("verdict"),
          "metrics": m, "notes": rec.get("notes"),
          "recovery_launches": n, "launch_widths": widths, "seconds": secs})
    return ([] if ok else [f"b: rc {rc} {rec.get('verdict')} {m}"]), n


def rec_chaos_chat(torch, pk):
    """Leg c: the ``loadgen.chaos_chat`` cell under load: the chaos
    Record covers the trace, its faults fired, its p99 is within 50x the
    clean run's."""
    from tpu_patterns_torch import loadgen as lg

    recs, n, widths, secs = _loadgen_run(torch, pk, lg, **REC_CHAOS_CHAT)
    chaos = next(r for r in recs if r.mode.endswith("_chaos_sp1"))
    m = chaos.metrics
    ok = (m["covered"] == 1.0 and m["injected"] > 0
          and m["done"] + m["failed"] + m["dropped"] == m["requests"]
          and 0 < m["p99_ratio"] <= m["p99_mult_gate"]
          and chaos.verdict.value != "FAILURE" and n > 0)
    emit({"phase": "recovery", "leg": "c_chaos_chat", "ok": ok,
          "records": [{"mode": r.mode, "verdict": r.verdict.value,
                       **{k: r.metrics.get(k) for k in (
                           "requests", "done", "failed", "dropped",
                           "injected", "covered", "e2e_p99_ms",
                           "clean_e2e_p99_ms", "p99_ratio", "goodput",
                           "tpot_p50_ms", "ttft_p50_ms")}}
                      for r in recs],
          "notes": chaos.notes, "recovery_launches": n,
          "launch_widths": widths, "seconds": secs})
    return ([] if ok else [f"c: {chaos.verdict.value} {m}"]), n


def rec_breaker(torch, pk, eng_mod, faults, rt, decoder, params, cfg,
                trace):
    """Leg d: ``serve.step:error:count=99`` under ``Breaker(threshold=2)``:
    it trips after two whole-wave quarantines, the loop stops and the
    rest of the queue is left intact."""
    b = rt.Breaker(threshold=2, cooldown_s=3600.0)
    eng = eng_mod.ServeEngine(decoder, params, slots=2, breaker=b,
                              retry_policy=_fast_policy(faults))
    faults.configure("serve.step:error:count=99")
    try:
        out, n, _, secs = _engine_run(torch, pk, eng, trace)
    finally:
        faults.configure(None)
    queued = [r.rid for r, _ in eng.queue]
    ok = (eng.breaker_tripped and b.opened and b.failures == 2
          and sorted(eng.failed) == [0, 1, 2, 3] and not out
          and queued == [r.rid for r in trace[4:]] and not eng.active
          and eng.leaked_blocks() == 0)
    emit({"phase": "recovery", "leg": "d_breaker", "ok": ok,
          "tripped": eng.breaker_tripped, "failures": b.failures,
          "quarantined": sorted(eng.failed), "queued": queued,
          "decisions": [e["action"] for e in eng.decisions.events],
          "recovery_launches": n, "seconds": secs})
    return ([] if ok else [f"d: tripped {eng.breaker_tripped} "
                           f"failed {eng.failed} queued {queued}"]), n


def _span_pairs(entries):
    """(serve.step_outer, its serve.step or serve.verify) duration
    pairs, matched by parent id."""
    outers = {e["span_id"]: e for e in entries
              if e.get("kind") == "span" and e["name"] == "serve.step_outer"}
    return [(outers[e["parent_id"]]["dur_ns"], e["dur_ns"])
            for e in entries
            if e.get("kind") == "span"
            and e["name"] in ("serve.step", "serve.verify")
            and e["parent_id"] in outers]


def rec_obs_plane(torch, pk, eng_mod, faults, obs, work):
    """Leg e: a ``--obs-dump`` serve run's dumps and their Chrome-trace
    export; serve.step_outer >= serve.step under an injected sleep; the
    watchdog's hang dump under ``serve.step:hang`` and ``--watchdog_s
    1``; the live plane answering /healthz and /metrics mid-run."""
    import threading
    import urllib.request

    from tpu_patterns_torch.obs import export as obs_export

    bad, launches, row = [], {}, {"phase": "recovery", "leg": "e_obs_plane"}
    small = dict(KV_WIDTH, requests=4, gen=8, max_prompt=128, min_speedup=0)
    # e1: --obs-dump, then obs export --chrome-trace
    obs_dir = os.path.join(work, "obs")
    faults.configure("serve.step:sleep:delay_s=0.05:count=3")
    try:
        (rc, _, recs), n, _, secs = _k1_leg(torch, pk, lambda: _cli_in_process(
            ["--obs-dir", obs_dir, "--obs-dump"] + _serve_argv(small)))
    finally:
        faults.configure(None)
    launches["e_obs_dump"] = n
    dumps = {f: os.path.exists(os.path.join(obs_dir, f))
             for f in ("spans.jsonl", "metrics.jsonl", "cost.jsonl")}
    trace_path = os.path.join(work, "trace.json")
    rc2, out2, _ = _cli_in_process(["--obs-dir", obs_dir, "obs", "export",
                                    "--chrome-trace", trace_path])
    try:
        trace = json.load(open(trace_path))
        n_events = len(trace["traceEvents"])
    except (OSError, ValueError):
        n_events = -1
    entries = obs_export.load_entries(os.path.join(obs_dir, "spans.jsonl"))
    pairs = _span_pairs(entries)
    outer_ge = bool(pairs) and all(o >= i for o, i in pairs)
    slept = sum(1 for o, i in pairs if o - i >= 0.05e9)
    row.update(obs_dump_rc=rc, dumps=dumps, export_rc=rc2,
               chrome_trace_events=n_events, step_pairs=len(pairs),
               outer_ge_inner=outer_ge, outer_covers_sleep=slept,
               obs_dump_launches=n, obs_dump_seconds=secs)
    if (rc != 0 or not all(dumps.values()) or rc2 != 0 or n_events <= 0
            or not outer_ge or slept < 3 or n <= 0):
        bad.append(f"e1: rc {rc} dumps {dumps} export {rc2} "
                   f"events {n_events} pairs {len(pairs)} slept {slept}")
    # e2: the watchdog under an injected hang
    wd_dir = os.path.join(work, "obs_wd")
    before = len(obs.fired_dumps())
    faults.configure("serve.step:hang:delay_s=2.5:after=2:count=1")
    try:
        (rc, _, recs), n, _, secs = _k1_leg(torch, pk, lambda: _cli_in_process(
            ["--obs-dir", wd_dir] + _serve_argv(small)
            + ["--watchdog_s", "1"]))
    finally:
        faults.configure(None)
    launches["e_watchdog"] = n
    fired = obs.fired_dumps()[before:]
    stacks_ok, wd_rec = False, {}
    if fired:
        stacks = open(fired[0][: -len(".jsonl")] + "_stacks.txt").read()
        stacks_ok = ("thread MainThread" in stacks
                     and "tpu-patterns-watchdog" in stacks)
        wd_path = os.path.join(wd_dir, "watchdog.jsonl")
        if os.path.exists(wd_path):
            wd_rec = json.loads(open(wd_path).readline())
    row.update(watchdog_rc=rc, watchdog_dumps=[os.path.basename(p)
                                               for p in fired],
               watchdog_stacks=stacks_ok,
               watchdog_record=[wd_rec.get("mode"), wd_rec.get("commands"),
                                wd_rec.get("verdict")],
               watchdog_launches=n, watchdog_seconds=secs)
    if (rc != 0 or not fired or not stacks_ok
            or wd_rec.get("verdict") != "WARNING"):
        bad.append(f"e2: rc {rc} fired {fired} stacks {stacks_ok} {wd_rec}")
    # e3: the live plane, scraped from this thread while run_serve serves
    port = _free_port()
    result = {}

    def serve():
        result["recs"] = eng_mod.run_serve(
            eng_mod.ServeConfig(**dict(small, requests=8), obs_http=port),
            lg_writer())

    pk.paged_block.launches = 0
    th = threading.Thread(target=serve, name="live-serve")
    t0 = time.perf_counter()
    th.start()
    seen = {}
    while th.is_alive() and len(seen) < 2:
        for path in ("/healthz", "/metrics"):
            if path in seen:
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                    body = r.read().decode()
                if path == "/healthz":
                    h = json.loads(body)
                    if h["engine"] is not None:
                        seen[path] = {"verdict": h["verdict"],
                                      "active_rows":
                                          h["engine"]["active_rows"]}
                elif "tpu_patterns_serve_tokens_total" in body:
                    seen[path] = {"bytes": len(body)}
            except OSError:
                pass
        time.sleep(0.02)
    th.join()
    n = pk.paged_block.launches
    launches["e_live"] = n
    row.update(live=seen, live_seconds=time.perf_counter() - t0,
               live_launches=n)
    if len(seen) < 2 or seen["/healthz"]["verdict"] != "ok" or n <= 0:
        bad.append(f"e3: live plane answered {seen}")
    row["ok"] = not bad
    emit(row)
    return bad, launches


def rec_obs_cost(torch, pk, eng_mod, obs, decoder, params, cfg, trace):
    """Leg f: the serve trace's tokens/s with obs off (``set_enabled``,
    what ``TPU_PATTERNS_OBS=0`` sets at import) against on, alternating;
    spans a decode step and the host's microseconds a span.  Reported,
    not gated."""
    tokens = sum(r.n_gen for r in trace)

    def run():
        eng = eng_mod.ServeEngine(decoder, params, slots=cfg.slots)
        obs.flight_recorder().clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run([dataclasses.replace(r) for r in trace])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ring = obs.flight_recorder().snapshot()
        return (tokens / wall, sum(1 for e in ring if e["kind"] == "span"),
                eng.stats["steps"])

    readings = {"off": [], "on": []}
    spans_per_step = []
    pk.paged_block.launches = 0
    try:
        run()  # warm
        for _ in range(REC_OBS_READINGS):
            for mode in ("off", "on"):
                obs.set_enabled(mode == "on")
                tps, n_spans, steps = run()
                readings[mode].append(tps)
                if mode == "on":
                    spans_per_step.append(n_spans / max(steps, 1))
    finally:
        obs.set_enabled(True)
    n = pk.paged_block.launches
    # the host's cost of one span: enter and exit, timed over many
    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        with obs.span("cost.probe", rows=8):
            pass
    span_us = (time.perf_counter() - t0) / reps * 1e6
    obs.flight_recorder().clear()

    def spread(xs):
        s = sorted(xs)
        return {"min": s[0], "median": statistics.median(s), "max": s[-1]}

    off, on = spread(readings["off"]), spread(readings["on"])
    emit({"phase": "recovery", "leg": "f_obs_cost",
          "tokens_per_s_off": readings["off"],
          "tokens_per_s_on": readings["on"], "off": off, "on": on,
          "on_over_off_median": on["median"] / off["median"],
          "spans_per_decode_step": statistics.median(spans_per_step),
          "host_us_per_span": span_us, "recovery_launches": n,
          "card": _smi()})
    return n


def phase_recovery(torch, pk):
    """Phase 17 (module docstring).  Returns K1's launches by leg."""
    import shutil

    from tpu_patterns_torch import faults, obs, rt
    from tpu_patterns_torch.serve import engine as eng_mod

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = os.path.join(ROOT, "build", "recovery_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    obs.configure(os.path.join(work, "obs_phase"))
    bad, launches = [], {}
    try:
        cfg = eng_mod.ServeConfig(**dict(KV_WIDTH, requests=REC_REQUESTS,
                                         gen=REC_GEN))
        mcfg, decoder, params, trace = eng_mod.build_serve(cfg)
        problems, counts = rec_transient(torch, pk, eng_mod, faults, obs,
                                         decoder, params, mcfg, cfg, trace)
        bad += problems
        launches.update(counts)
        problems, launches["b_verify_fault"] = rec_verify_fault(
            torch, pk, faults, work)
        bad += problems
        problems, launches["c_chaos_chat"] = rec_chaos_chat(torch, pk)
        bad += problems
        problems, launches["d_breaker"] = rec_breaker(
            torch, pk, eng_mod, faults, rt, decoder, params, cfg, trace)
        bad += problems
        problems, counts = rec_obs_plane(torch, pk, eng_mod, faults, obs,
                                         work)
        bad += problems
        launches.update(counts)
        fcfg = eng_mod.ServeConfig(**dict(KV_WIDTH, requests=16))
        _, fdec, fparams, ftrace = eng_mod.build_serve(fcfg)
        launches["f_obs_cost"] = rec_obs_cost(torch, pk, eng_mod, obs, fdec,
                                              fparams, fcfg, ftrace)
    finally:
        faults.configure(None)
        obs.configure(None)
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "recovery_phase", "seconds": time.perf_counter() - t_phase,
          "recovery_launches": launches, "card": _smi()})
    if bad:
        raise AssertionError("recovery: " + " | ".join(bad))
    return launches


# -- phase 18: diagnostics and the perf observatory ---------------------------

# the perf registry at the serve model's width (PerfConfig's fields:
# DecodeConfig's embed 1024, 8 x 128 heads, depth 4, vocab 2048, bf16, 8
# slots, block_len 16), train at batch 4 and seq 1024; k and inner are
# measurement policy, no part of a baseline's fingerprint.  24 requests:
# the kv-tier trace holds max(slots + 2, requests // 2) conversations,
# and at 8 slots its pool evicts only from 11 of them on (PerfConfig's
# 6 give 10, which fit)
DIAG_WIDTH = dict(vocab=2048, embed=1024, heads=8, head_dim=128, depth=4,
                  slots=8, block_len=16, batch=4, seq=1024, requests=24)
DIAG_PERF = [f"--{k}={v}" for k, v in DIAG_WIDTH.items()] + [
    "--dtype=bfloat16", "--device=cuda", "--k=2", "--inner=4"]
# leg b's serve run: the serve model at full width, 2 requests of 8
# (the profiler's host events, ~115k of them at this size, are what the
# leg's seconds go to)
DIAG_SERVE = ["serve", "--device=cuda", "--vocab=2048", "--embed=1024",
              "--head_dim=128", "--depth=4", "--dtype=bfloat16",
              "--min_prompt=64", "--max_prompt=512", "--gen=8",
              "--requests=2"]
# leg b's flagship run: FlagshipConfig's defaults, its 10 reps too (at 2
# the weights' and input's host-to-device copies were 17-20% of busy)
DIAG_FLAGSHIP = ["flagship", "--device=cuda"]
DIAG_SLEEP = "serve.step:sleep:delay_s=0.05:count=1000000"
# phase 3's K1 tolerance for float32 (rtol = atol)
K1_F32_TOL = 2e-5
# where leg c's op-name snapshots land (the classifier's fixtures,
# committed as tests/torch_fixtures/op_names_h100_*.json)
DIAG_SNAPSHOT_DIR = os.path.join("results", "op_names")
DIAG_SNAPSHOTS = {"serve": "op_names_h100_serve.json",
                  "flagship": "op_names_h100_flagship.json"}


def _by_mode(recs, mode):
    return [r for r in recs if r["mode"] == mode]


def diag_doctor_start():
    """Leg a, started as the smoke's pre-flight: ``python -m
    tpu_patterns_torch doctor --device cuda`` in a process of its own,
    before the kernels build.  The build runs nvcc on the host and
    nothing on the card, so the doctor's probe children (their seconds go
    to importing torch) share the card with no other work; the smoke
    waits for it before its first timed phase (:func:`diag_doctor_wait`)
    and phase 18 reads its Record."""
    work = os.path.join(ROOT, "build", "doctor_preflight")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    jl = os.path.join(work, "doctor.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_patterns_torch", "--jsonl", jl,
         "doctor", "--device", "cuda"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, jl, time.perf_counter()


def diag_doctor_wait(doctor):
    """The pre-flight doctor's exit code, output and seconds, once it
    exits; killed if it outlives its probes' deadlines."""
    proc, jl, t0 = doctor
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, out, jl, time.perf_counter() - t0


def diag_doctor(rc, out, jl, seconds):
    """Leg a's verdict: the pre-flight doctor's Record."""
    with open(jl) as f:
        (rec,) = [json.loads(ln) for ln in f if ln.strip()]
    m = rec["metrics"]
    ok = (rc == 0 and rec["verdict"] == "SUCCESS" and "H100" in rec["mode"]
          and all(m.get(f"{n}_ok") == 1.0 for n in (
              "backend_init", "tiny_op", "deep_compute", "native_ffi",
              "native_loader", "watchdog")))
    emit({"phase": "diagnostics", "leg": "a_doctor", "ok": ok, "rc": rc,
          "when": "pre-flight, beside the kernel build", "seconds": seconds,
          "mode": rec["mode"], "verdict": rec["verdict"], "metrics": m,
          "notes": rec["notes"],
          "lines": [ln for ln in out.splitlines() if ln.startswith("#")]})
    return [] if ok else [f"doctor: rc {rc}, {rec['verdict']}, "
                          f"{rec['notes']}"]


def _profiled_run(torch, pk, F, argv, prof_dir, **env):
    """``--enable_profiling`` over a CLI run: its Records, the
    ``profile_breakdown`` one checked, and K1's and K2-K4's launches."""
    pk.paged_block.launches = 0
    F.reset_launches()
    rc, out, recs = _cli_in_process(["--enable_profiling", "--profile_dir",
                                     prof_dir, *argv], **env)
    launches = {"paged_attention": pk.paged_block.launches, **F.LAUNCHES}
    bad = []
    bds = _by_mode(recs, "profile_breakdown")
    if len(bds) != 1:
        return rc, None, recs, launches, [f"{argv}: no breakdown Record"]
    m = bds[0]["metrics"]
    # the Record's values are rounded to 4 decimals (ms)
    if not (m["busy_ms"] <= m["wall_ms"] + 1e-4
            and abs(m["idle_ms"] - (m["wall_ms"] - m["busy_ms"])) <= 2e-4):
        bad.append(f"{argv[0]}: busy {m['busy_ms']} wall {m['wall_ms']} "
                   f"idle {m['idle_ms']}")
    return rc, m, recs, launches, bad


def diag_union_parity(torch, eng_mod, work):
    """The busy union of one profile, parsed back from its exported
    Kineto JSON, against the same profile's in-memory union (both through
    ``core/profile.py``): equal within 1 us."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_patterns_torch.core import profile as P

    cfg = eng_mod.ServeConfig(**dict(FULL_WIDTH, dtype="bfloat16",
                                     requests=4, gen=8))
    _, decoder, params, trace = eng_mod.build_serve(cfg)
    eng_mod.ServeEngine(decoder, params, slots=cfg.slots).run(
        [dataclasses.replace(r) for r in trace])  # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng_mod.ServeEngine(decoder, params, slots=cfg.slots).run(
            [dataclasses.replace(r) for r in trace])
        torch.cuda.synchronize()
    path = os.path.join(work, "union.pt.trace.json")
    prof.export_chrome_trace(path)
    mem_planes, disk_planes = P.planes_from_profile(prof), P.parse_trace(path)
    mem, disk = P.breakdown_of(mem_planes), P.breakdown_of(disk_planes)
    diff_us = abs(mem["busy_ms"] - disk["busy_ms"]) * 1e3
    with open(path) as f:  # the device pids' event categories, counted
        cats = collections.Counter(
            ev.get("cat") for ev in json.load(f)["traceEvents"]
            if ev.get("ph") == "X" and ev.get("cat") not in (
                "cpu_op", "python_function", "cuda_runtime", "user_annotation",
                "cuda_driver"))
    row = {"phase": "diagnostics", "leg": "b_union_parity",
           "busy_ms_memory": mem["busy_ms"], "busy_ms_json": disk["busy_ms"],
           "wall_ms_memory": mem["wall_ms"], "wall_ms_json": disk["wall_ms"],
           "diff_us": diff_us,
           "streams": sum(len(p.lines) for p in mem_planes),
           "events_memory": sum(len(ln.events) for p in mem_planes
                                for ln in p.lines),
           "events_json": sum(len(ln.events) for p in disk_planes
                              for ln in p.lines),
           "json_categories": dict(cats), "ok": diff_us <= 1.0}
    emit(row)
    return [] if row["ok"] else [f"union parity: {diff_us} us apart"]


def diag_profilecheck(name, prof_dir, rates=None):
    """Leg c: ``profilecheck`` on one trace dir, its op-name snapshot
    written under ``results/op_names/``."""
    os.makedirs(os.path.join(ROOT, DIAG_SNAPSHOT_DIR), exist_ok=True)
    snap = os.path.join(ROOT, DIAG_SNAPSHOT_DIR, DIAG_SNAPSHOTS[name])
    argv = ["profilecheck", prof_dir, "--snapshot-out", snap]
    if rates:
        argv += ["--rates-jsonl", rates]
    rc, out, recs = _cli_in_process(argv)
    (ops,) = _by_mode(recs, "profile_ops")
    with open(snap) as f:
        names = json.load(f)
    total = sum(d["duration_ps"] for d in names.values()) or 1
    worst_other = sorted(
        ((d["duration_ps"] / total, n) for n, d in names.items()
         if d["category"] == "other"), reverse=True)[:5]
    row = {"phase": "diagnostics", "leg": f"c_profilecheck_{name}",
           "rc": rc, "verdict": ops["verdict"], "metrics": ops["metrics"],
           "snapshot": os.path.relpath(snap, ROOT),
           "crosscheck": [(r["verdict"], r["notes"])
                          for r in _by_mode(recs, "profile_crosscheck")],
           "top_other": worst_other}
    row["ok"] = (rc == 0 and ops["metrics"]["frac_other_time"] <= 0.2)
    emit(row)
    return names, ([] if row["ok"] else
                   [f"profilecheck {name}: {ops['metrics']}, {worst_other}"])


def _step_logits(dec, params, pool, a):
    """One ``dec.step`` on ``a``'s inputs: its ids and the logits [B, V]
    it picked them from, caught on their way into the decoder's picker
    (the step itself runs unchanged)."""
    seen = []
    pick = dec._pick

    def catch(logits, rows, w):
        # the picker takes each rank's vocab shard; one device holds one
        seen.append(logits[0] if isinstance(logits, list) else logits)
        return pick(logits, rows, w)

    object.__setattr__(dec, "_pick", catch)
    try:
        ids = dec.step(params, pool, a["tok"], a["lens"], a["steps"],
                       a["tables"], a["active"])
    finally:
        object.__delattr__(dec, "_pick")
    (logits,) = seen
    return ids, logits


def diag_dense_vs_k1(torch, pk):
    """Leg e's agreement: one decode step of the dense decoder and of the
    K1 decoder on the same pool and inputs, at the serve width in
    float32 with TF32 off: the step's logits (every layer's attention,
    positions and tables behind them) within phase 3's K1 tolerance, and
    its ids equal."""
    from tpu_patterns_torch.perf import registry

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.PerfConfig(**DIAG_WIDTH, dtype="float32", device=DEVICE)
    dense, params, mcfg = registry.decoder_for(cfg, DEVICE, attn="dense")
    kernel, _, _ = registry.decoder_for(cfg, DEVICE, attn="kernel")
    a = registry.core_inputs(cfg, dense)
    pool = dense.init_pool()
    dense.prefill(params, pool, a["tokens"], a["lens"], a["start"],
                  a["tables"], a["active"])
    got = {}
    for name, dec in (("dense", dense), ("kernel", kernel)):
        pk.paged_block.launches = 0
        got[name] = (*_step_logits(dec, params, {n: t.clone() for n, t
                                                  in pool.items()}, a),
                     pk.paged_block.launches)
    torch.cuda.synchronize()
    (ids_d, want, k1_dense), (ids_k, logits, k1) = got["dense"], got["kernel"]
    err = float((logits - want).abs().max())
    row = {"phase": "diagnostics", "leg": "e_dense_vs_k1", "dtype": "float32",
           "compared": "step logits", "shape": list(logits.shape),
           "max_abs_err": err, "max_abs_logit": float(want.abs().max()),
           "tolerance": K1_F32_TOL, "k1_launches": k1,
           "k1_launches_dense": k1_dense,
           "ids_equal": int((ids_d == ids_k).sum()), "rows": int(ids_d.numel())}
    row["ok"] = (k1 == mcfg.depth and k1_dense == 0
                 and row["ids_equal"] == row["rows"]
                 and bool(torch.allclose(logits, want, rtol=K1_F32_TOL,
                                         atol=K1_F32_TOL)))
    emit(row)
    return [] if row["ok"] else [f"dense vs K1: {row}"]


def diag_perf(torch, pk, work):
    """Legs e and f: the registry through ``perf`` at the serve width."""
    from tpu_patterns_torch.perf import history, registry
    from tpu_patterns_torch.runtime import SPEC_PLAUSIBILITY_MARGIN

    bad, launches = [], {}
    pk.paged_block.launches = 0
    rc, out, recs = _cli_in_process([
        "perf", "report", *DIAG_PERF, "--no-history",
        "--include", "decoder.step_pallas,decoder.verify_pallas"])
    launches["e_pallas_captures"] = pk.paged_block.launches
    if rc or not launches["e_pallas_captures"]:
        bad.append(f"perf pallas captures: rc {rc}, K1 "
                   f"{launches['e_pallas_captures']}")
    perf_dir = os.path.join(work, "perf")
    pk.paged_block.launches = 0
    rc, out, recs = _cli_in_process(["perf", "report", *DIAG_PERF,
                                     "--perf-dir", perf_dir])
    launches["e_report"] = pk.paged_block.launches
    (snap,) = history.load_history(perf_dir)
    rows = {n: f"| {n} |" in out for n in registry.EXECUTABLES}
    execs = snap["executables"]
    impossible = [
        n for n, m in execs.items()
        if m.get("mfu", 0.0) > 1.0
        or m.get("achieved_gbps", 0.0) > SPEC_PLAUSIBILITY_MARGIN * 3350.0]
    row = {"phase": "diagnostics", "leg": "e_perf_report", "rc": rc,
           "card": snap["mesh"].get("card"), "rows": rows,
           "impossible": impossible,
           "executables": {n: {k: m[k] for k in (
               "step_ms", "analytic_flops", "analytic_hbm_bytes",
               "achieved_gflops", "achieved_gbps", "mfu",
               "kv_evictions", "kv_evict_bytes", "kv_onload_hits") if k in m}
               for n, m in execs.items()},
           "table": [ln for ln in out.splitlines() if ln.startswith("|")]}
    tier = execs.get("serve.kv_tier", {})
    row["ok"] = (rc == 0 and all(rows.values()) and not impossible
                 and "H100" in (row["card"] or "")
                 and tier.get("kv_evictions", 0.0) > 0
                 and tier.get("kv_onload_hits", 0.0) > 0)
    emit(row)
    if not row["ok"]:
        bad.append(f"perf report: rc {rc}, rows {rows}, impossible "
                   f"{impossible}, serve.kv_tier {tier}")

    bl = os.path.join(work, "baseline.json")
    pk.paged_block.launches = 0
    rc_pin, _, _ = _cli_in_process(["perf", "update-baseline", *DIAG_PERF,
                                    "--baseline", bl, "--no-history"])
    diff_argv = ["perf", "diff", *DIAG_PERF, "--baseline", bl,
                 "--no-history", "--include", "serve.step"]
    rc_slow, out_slow, slow = _cli_in_process(
        diff_argv, TPU_PATTERNS_FAULTS=DIAG_SLEEP)
    rc_clean, _, clean = _cli_in_process(diff_argv)
    launches["f_baseline_and_diffs"] = pk.paged_block.launches
    with open(bl) as f:
        pinned = [e for e in json.load(f)["entries"]
                  if e["executable"] == "serve.step"
                  and e["metric"] == "step_ms"]
    (flagged,) = _by_mode(slow, "serve.step")
    (again,) = _by_mode(clean, "serve.step")
    row = {"phase": "diagnostics", "leg": "f_perf_diff", "fault": DIAG_SLEEP,
           "rc_update_baseline": rc_pin, "rc_diff_sleep": rc_slow,
           "rc_diff_clean": rc_clean, "sleep_notes": flagged["notes"],
           "pinned_step_ms": [(e["value"], e["machine"]) for e in pinned],
           "sleep_step_ms": flagged["metrics"]["step_ms"],
           "clean_step_ms": again["metrics"]["step_ms"],
           "diff_progress": [ln for ln in out_slow.splitlines()
                             if ln.startswith("# ")],
           "ok": (rc_pin == 0 and rc_slow == 1
                  and flagged["verdict"] == "FAILURE"
                  and any("serve.step.step_ms" in n
                          for n in flagged["notes"])
                  and rc_clean == 0)}
    emit(row)
    if not row["ok"]:
        bad.append(f"perf diff: {row}")
    return bad, launches


def phase_diagnostics(torch, pk, F, doctor):
    """Phase 18 (module docstring); ``doctor`` is the pre-flight doctor's
    :func:`diag_doctor_wait`.  Returns K1's and K2-K4's launches by
    leg."""
    from tpu_patterns_torch import obs
    from tpu_patterns_torch.serve import engine as eng_mod

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "diagnostics_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bad, launches = [], {"paged_attention": {}}
    ends = {}  # seconds into the phase at each leg's end

    def done(leg):
        ends[leg] = time.perf_counter() - t_phase

    try:
        bad += diag_doctor(*doctor)
        done("a_doctor")
        serve_prof = os.path.join(work, "serve_prof")
        obs_dir = os.path.join(work, "obs")
        rc, m, recs, got, problems = _profiled_run(
            torch, pk, F, ["--obs-dir", obs_dir, "--obs-dump", *DIAG_SERVE],
            serve_prof)
        bad += problems
        launches["paged_attention"]["b_serve"] = got["paged_attention"]
        emit({"phase": "diagnostics", "leg": "b_serve", "rc": rc,
              "breakdown": m, "k1_launches": got["paged_attention"],
              "verdicts": [(r["mode"], r["verdict"]) for r in recs]})
        if not got["paged_attention"]:
            bad.append("profiled serve: K1 not launched")
        obs.configure(None)  # its dumps are written; leg d reads them
        done("b_serve")
        flag_prof = os.path.join(work, "flagship_prof")
        rc, m, frecs, got, problems = _profiled_run(torch, pk, F,
                                                    DIAG_FLAGSHIP, flag_prof)
        bad += problems
        for k in FLASH_KERNELS:
            launches[k] = {"b_flagship": got[k]}
        rates = os.path.join(work, "flagship.jsonl")
        with open(rates, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in frecs)
        ok = (rc == 0 and m is not None and m["compute_frac"] >= 0.8
              and got["flash_block"] > 0 and got["flash_block_bwd_dq"] > 0
              and got["flash_block_bwd_dkv"] > 0)
        emit({"phase": "diagnostics", "leg": "b_flagship", "rc": rc,
              "breakdown": m, "launches": got, "ok": ok,
              "verdicts": [(r["mode"], r["verdict"]) for r in frecs]})
        if not ok:
            bad.append(f"profiled flagship: rc {rc}, {m}, {got}")
        done("b_flagship")
        bad += diag_union_parity(torch, eng_mod, work)
        done("b_union_parity")

        problems, got = diag_perf(torch, pk, work)
        bad += problems
        launches["paged_attention"].update(got)
        done("e_f_perf")
        _, problems = diag_profilecheck("serve", serve_prof)
        bad += problems
        names, problems = diag_profilecheck("flagship", flag_prof, rates)
        bad += problems
        flash = {n: d["category"] for n, d in names.items() if "flash_" in n}
        if not flash or set(flash.values()) != {"compute"}:
            bad.append(f"flagship: flash kernels booked as {flash}")
        done("c_profilecheck")

        rc, out, _ = _cli_in_process(["--obs-dir", obs_dir, "obs",
                                      "summarize", "--profile-dir",
                                      serve_prof])
        joined = [ln for ln in out.splitlines()
                  if ln.startswith("device plane") or ln.startswith("  ")]
        ok = rc == 0 and any("device busy" in ln for ln in joined)
        emit({"phase": "diagnostics", "leg": "d_obs_join", "rc": rc,
              "lines": joined, "ok": ok})
        if not ok:
            bad.append(f"obs summarize --profile-dir: rc {rc}")
        obs.configure(None)
        done("d_obs_join")

        bad += diag_dense_vs_k1(torch, pk)
        done("e_dense_vs_k1")
    finally:
        obs.configure(None)
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "diagnostics_phase",
          "seconds": time.perf_counter() - t_phase, "leg_end_s": ends,
          "diagnostics_launches": launches, "card": _smi()})
    if bad:
        raise AssertionError("diagnostics: " + " | ".join(bad))
    return launches


# -- phase 19: sequence parallelism (the longctx pattern) --------------------

# LongCtxConfig's defaults: float32, seq 4096, 8 heads x 128, causal; the
# ring's shard at 4 ranks is 1024 tokens
LC_SEQ, LC_H, LC_D, LC_SP = 4096, 8, 128, 4
LC_SHARD = LC_SEQ // LC_SP
# leg a's (q_off, k_off, pos_stride) at the shard shape: contiguous
# (stride 1) and striped (stride 4) rank pairs.  Contiguous: rank 0
# against rank 1's keys (wholly masked), the diagonal, rank 1 against
# rank 0's keys (no key masked).  Striped: rank 0 against rank 1's keys
# (query i sees keys before i; row 0 none), the diagonal, rank 3 against
# rank 0's keys (query i sees keys 0..i)
LC_OFFSETS = {"contiguous": ((0, LC_SHARD, 1), (0, 0, 1), (LC_SHARD, 0, 1)),
              "striped": ((0, 1, LC_SP), (0, 0, LC_SP), (3, 0, LC_SP))}
LC_SP4 = ("ring", "ring_pallas", "ring_striped", "ulysses",
          "ulysses_pallas")
# leg c: the --grad runs; leg d: bf16, compact grids where taken
LC_GRAD = (("flash", 1), ("ring_pallas", LC_SP), ("ulysses_pallas", LC_SP))
LC_BF16 = (("ring_pallas", LC_SP, False), ("ulysses_pallas", LC_SP, True),
           ("flash", 1, True))
# leg e's profiled run: the flash grad Record at fewer reps (the
# profiler's host events grow with each call)
LC_PROFILED = ["--devices", "1", "--strategy", "flash", "--grad", "true",
               "--reps", "3", "--warmup", "1"]


def lc_shards(torch, F):
    """Leg a: K3 and K4 (and K2 on the diagonal) against their plain
    versions at the ring's full-width shard, [1024, 8, 128] a side,
    causal, float32 and bfloat16, at each pair of :data:`LC_OFFSETS`.
    Returns the worst relative and absolute error of each kernel."""
    rel = dict.fromkeys(FLASH_KERNELS, 0.0)
    err = dict.fromkeys(FLASH_KERNELS, 0.0)
    cases = 0
    for dtype in ("float32", "bfloat16"):
        for layout, offsets in LC_OFFSETS.items():
            for q_off, k_off, stride in offsets:
                errs, _ = flash_case(
                    torch, F, f"ring_{dtype}_{layout}_{q_off}_{k_off}",
                    lq=LC_SHARD, lk=LC_SHARD, h=LC_H, d=LC_D, dtype=dtype,
                    causal=True, q_off=q_off, k_off=k_off, stride=stride,
                    seed=300 + cases)
                cases += 1
                for n, (r, a) in errs.items():
                    rel[n], err[n] = max(rel[n], r), max(err[n], a)
    emit({"phase": "longctx", "leg": "a_ring_shards", "cases": cases,
          "shape": f"Lq=Lk={LC_SHARD} H{LC_H} D{LC_D} causal",
          "offsets": LC_OFFSETS, "tolerance_rel": FLASH_TOL,
          "max_rel_err": rel, "max_abs_err": err})
    return err


def lc_f32_times(torch, F, timing, spec):
    """K2, K3 and K4 in float32 (the register-tiled FFMA kernels) at
    longctx's shape: K2 over the whole sequence, K3 and K4 over a
    1024-token shard pair with no key masked and on the diagonal; L2
    flushed before each launch.  Beside each: its plain version's ms,
    one SDPA call's in float32 with TF32 off and its bound (operations
    over the f32 peak, bytes over the memory rate, the larger)."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scale = LC_D ** -0.5

    def t(fn):
        return timing.cuda_time_ms(fn, reps=10, before=flush.zero_)

    def bound(nbytes, flops):
        bytes_ms = nbytes / (spec["hbm_gbps"] * 1e9) * 1e3
        ops_ms = flops / (spec["f32_tflops"] * 1e12) * 1e3
        return {"bytes": nbytes, "flops": flops,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    g = torch.Generator().manual_seed(400)

    def normal(n):
        return torch.randn((n, LC_H, LC_D), generator=g).to(DEVICE)

    rows = {}
    # K2: the whole causal sequence
    q, k, v = normal(LC_SEQ), normal(LC_SEQ), normal(LC_SEQ)
    tiles = F._blocks(q, k, ("fwd",), 1024, 1024)
    views = [a.transpose(0, 1)[None] for a in (q, k, v)]
    io_ = q.numel() * 4
    pairs = LC_H * LC_SEQ * (LC_SEQ + 1) // 2
    rows["flash_attention"] = {
        "shape": f"L{LC_SEQ} H{LC_H} D{LC_D} f32 causal", "tiles": tiles,
        "ms": t(lambda: F._launch_fwd(q, k, v, 0, 0, True, scale, *tiles,
                                      1, emit_stats=False)),
        "plain_ms": t(lambda: F.flash_attention_reference(q, k, v, True)),
        "library_ms": t(lambda: sdpa(*views, is_causal=True)),
        **bound(4 * io_, 2 * 2 * LC_D * pairs)}
    # K3 and K4 on one shard pair: no key masked, then the diagonal
    q, k, v, do = (normal(LC_SHARD) for _ in range(4))
    views = [a.transpose(0, 1)[None] for a in (q, k, v)]
    doh = do.transpose(0, 1)[None]
    io_ = q.numel() * 4
    stats = LC_H * LC_SHARD * 4
    fwd_t = F._blocks(q, k, ("fwd",), 1024, 1024)
    bwd_t = F._bwd_tiles(q, k, 512, 512)
    for name, (q_off, k_off, causal) in (
            ("full", (LC_SHARD, 0, True)), ("diagonal", (0, 0, True))):
        pairs = LC_H * (LC_SHARD * LC_SHARD if q_off
                        else LC_SHARD * (LC_SHARD + 1) // 2)
        ro, rm, rl = F.flash_block_reference(q, k, v, q_off, k_off, causal)
        out, lse = F._row_stats(ro, rm, rl)
        delta = F._delta(do, out)
        diag = q_off == 0
        qh, kh, vh = (a.detach().requires_grad_(True) for a in views)
        lib_out = sdpa(qh, kh, vh, is_causal=diag)
        lib_fwd = t(lambda: sdpa(*views, is_causal=diag))
        lib_bwd = t(lambda: torch.autograd.grad(
            lib_out, (qh, kh, vh), doh, retain_graph=True))
        plain_bwd = t(lambda: F.flash_block_bwd_reference(
            q, k, v, do, lse, delta, q_off, k_off, causal))
        rows[f"flash_block {name}"] = {
            "shape": f"Lq=Lk={LC_SHARD} H{LC_H} D{LC_D} f32, q_off "
            f"{q_off} k_off {k_off} causal", "tiles": fwd_t,
            "ms": t(lambda: F._launch_fwd(q, k, v, q_off, k_off, causal,
                                          scale, *fwd_t, 1,
                                          emit_stats=True)),
            "plain_ms": t(lambda: F.flash_block_reference(
                q, k, v, q_off, k_off, causal)),
            "library_ms": lib_fwd,
            **bound(5 * io_ + 2 * stats, 2 * 2 * LC_D * pairs)}
        for kname, n_prod, n_out in (("dq", 3, 1), ("dkv", 4, 2)):
            rows[f"flash_block_bwd_{kname} {name}"] = {
                "shape": rows[f"flash_block {name}"]["shape"],
                "tiles": bwd_t[kname],
                "ms": t(lambda kname=kname: F._launch_bwd(
                    q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                    bwd_t, 1, kernels=(kname,))),
                "plain_ms": plain_bwd, "library_ms": lib_bwd,
                **bound((4 + n_out) * io_ + 2 * stats,
                        n_prod * 2 * LC_D * pairs)}
    emit({"phase": "longctx", "leg": "f32_time", "card": _smi(),
          "note": "float32, L2 flushed; library_ms is SDPA in float32 with "
          "TF32 off (K4's: its backward, dq, dk and dv together, as "
          "plain_ms)", **rows})
    return rows


# the f32 longctx legs whose TFLOP/s the f32 kernels move: the forward
# (flash at 1 rank, ring_pallas and ulysses_pallas at 4), then the same
# with --grad (leg c's)
LC_F32_LEGS = tuple(["--devices", str(n), "--strategy", s] + grad
                    for grad in ([], ["--grad", "true"])
                    for s, n in LC_GRAD)


def phase_flash_f32_time(torch, F, timing, spec, libs):
    """``--tree TREE flash_f32_time``: leg a's float32 times
    (:func:`lc_f32_times`) with each kernel's diagonal over its full
    pair, the build's registers and spills of each f32 instance (the
    wgmma kernels left out) and the model TFLOP/s of the f32 ``longctx``
    legs of :data:`LC_F32_LEGS`, each through the CLI at
    ``LongCtxConfig``'s defaults, TF32 off, so that parent and change
    time in one call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = lc_f32_times(torch, F, timing, spec)
    ptxas = {}
    for lib in ("flash_attention", "flash_attention_bwd"):
        ptxas.update({n: r for n, r in ptxas_report(
            libs[lib].with_suffix(".log").read_text(), "flash_").items()
            if "wgmma" not in n})
    tflops = {}
    for argv in LC_F32_LEGS:
        rc, recs, got = lc_cli(F, argv)
        tflops[" ".join(argv[3:])] = {"rc": rc, "launches": got, "records": [
            (r["mode"], r["verdict"], r["metrics"].get("tflops"))
            for r in recs]}
    emit({"phase": "flash_f32_time", "card": _smi(), "ptxas": ptxas,
          "longctx_f32_tflops": tflops,
          "ms": {n: r["ms"] for n, r in rows.items()},
          "diagonal_over_full": {
              n: rows[f"{n} diagonal"]["ms"] / rows[f"{n} full"]["ms"]
              for n in ("flash_block", "flash_block_bwd_dq",
                        "flash_block_bwd_dkv")}})
    return rows


def lc_launches(torch, F, mesh_mod, pattern):
    """One direct call of each fused strategy at longctx's default shape
    (float32), without and with a gradient, K2-K4's counts set to 0 just
    before and read just after; held to the counts the strategies'
    structure gives (the ring: sp^2 K3, and sp^2 of each K4 kernel)."""
    sp = LC_SP
    want = {
        ("ring_pallas", False): (0, sp * sp, 0, 0),
        ("ring_pallas", True): (0, sp * sp, sp * sp, sp * sp),
        ("ulysses_pallas", False): (sp, 0, 0, 0),
        ("ulysses_pallas", True): (0, sp, sp, sp),
        ("flash", False): (1, 0, 0, 0),
        ("flash", True): (0, 1, 1, 1),
    }
    g = torch.Generator().manual_seed(500)
    qkv = [torch.randn((LC_SEQ, LC_H, LC_D), generator=g) for _ in range(3)]
    got, bad = {}, []
    for (name, grad), counts in want.items():
        mesh = mesh_mod.default_mesh(1 if name == "flash" else sp, DEVICE)
        shards = [s.requires_grad_(grad) for a in qkv
                  for s in mesh.scatter(a)]
        n = mesh.size
        torch.cuda.synchronize()
        F.reset_launches()
        outs = pattern.STRATEGIES[name](shards[:n], shards[n:2 * n],
                                        shards[2 * n:], causal=True)
        if grad:
            torch.autograd.grad(outs, shards, [torch.ones_like(o)
                                               for o in outs])
        torch.cuda.synchronize()
        got[f"{name}{'_grad' if grad else ''}"] = dict(F.LAUNCHES)
        if tuple(F.LAUNCHES.values()) != counts:
            bad.append(f"{name} grad={grad}: {F.LAUNCHES} != {counts}")
    emit({"phase": "longctx", "leg": "launch_counts", "sp": sp,
          "launches": got, "ok": not bad})
    return got, bad


def lc_cli(F, argv):
    """``longctx`` through the CLI in this process, K2-K4's counts set to
    0 just before: its exit code, Records and the launches."""
    F.reset_launches()
    rc, _, recs = _cli_in_process(["longctx", "--device", DEVICE, *argv])
    return rc, recs, dict(F.LAUNCHES)


def _lc_row(leg, argv, rc, recs, launches):
    return {"phase": "longctx", "leg": leg, "argv": argv, "rc": rc,
            "launches": launches,
            "records": [(r["mode"], r["commands"], r["verdict"],
                         {k: r["metrics"][k] for k in (
                             "tflops", "tflops_hw", "min_time_us",
                             "max_abs_err", "gate_violation",
                             "cross_max_err") if k in r["metrics"]})
                        for r in recs],
            "notes": sorted({n for r in recs for n in r["notes"]})}


def phase_longctx(torch, pk, F, timing, spec):
    """Phase 19 (module docstring).  Returns K2-K4's launches by leg
    (legs b-e) and the float32 times of leg a's kernels."""
    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.longctx import pattern

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "longctx_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bad, launches, ends, direct = [], {}, {}, {}
    # the --grad Records' silicon rate: at most the f32 peak times the
    # cards, and every rank of these runs is on the one card
    f32_cap = spec["f32_tflops"]
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        shard_err = lc_shards(torch, F)
        f32_rows = lc_f32_times(torch, F, timing, spec)
        ends["a"] = time.perf_counter() - t_phase

        legs = [("b_both_1", ["--devices", "1"])] + [
            (f"b_{s}_{LC_SP}", ["--devices", str(LC_SP), "--strategy", s])
            for s in LC_SP4]
        legs += [(f"c_{s}_grad_{n}", ["--devices", str(n), "--strategy", s,
                                      "--grad", "true"])
                 for s, n in LC_GRAD]
        legs += [(f"d_{s}_bf16_{n}", ["--devices", str(n), "--strategy", s,
                                      "--dtype", "bfloat16"]
                  + (["--causal_grid", "compact"] if compact else []))
                 for s, n, compact in LC_BF16]
        for leg, argv in legs:
            rc, recs, got = lc_cli(F, argv)
            launches[leg] = got
            row = _lc_row(leg, argv, rc, recs, got)
            ok = rc == 0 and recs and all(r["verdict"] == "SUCCESS"
                                          for r in recs)
            if leg == "b_both_1":
                ok &= [r["mode"] for r in recs] == [
                    "ring", "ulysses", "flash", "agreement"]
            else:
                ok &= len(recs) == 1
            if "_grad_" in leg:
                hw = [r["metrics"]["tflops_hw"] for r in recs]
                ok &= all(x <= f32_cap for x in hw)
                row["tflops_hw_cap"] = f32_cap
            # the fused strategies go through K2-K4, the plain ones never
            fused = "pallas" in leg or "flash" in leg or leg == "b_both_1"
            ok &= (sum(got.values()) > 0) == fused
            row["ok"] = bool(ok)
            emit(row)
            if not ok:
                bad.append(f"{leg}: rc {rc}, {row['records']}, "
                           f"{row['notes']}")
        ends["b_c_d"] = time.perf_counter() - t_phase

        direct, problems = lc_launches(torch, F, mesh_mod, pattern)
        bad += problems
        ends["launch_counts"] = time.perf_counter() - t_phase

        prof = os.path.join(work, "prof")
        rc, m, recs, got, problems = _profiled_run(
            torch, pk, F, ["longctx", "--device", DEVICE, *LC_PROFILED],
            prof)
        bad += problems
        launches["e_profiled_flash_grad"] = {
            k: got[k] for k in FLASH_KERNELS}
        rates = os.path.join(work, "longctx.jsonl")
        with open(rates, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs)
        rc_pc, _, pc = _cli_in_process(["profilecheck", prof,
                                        "--rates-jsonl", rates])
        cross = _by_mode(pc, "profile_crosscheck")
        ok = (rc == 0 and rc_pc == 0 and len(cross) == 1
              and cross[0]["verdict"] == "SUCCESS"
              and cross[0]["metrics"].get("coherent") == 1.0
              and all(r["verdict"] == "SUCCESS" for r in recs))
        emit({"phase": "longctx", "leg": "e_crosscheck", "rc": rc,
              "rc_profilecheck": rc_pc, "breakdown": m,
              "launches": launches["e_profiled_flash_grad"],
              "rate_records": [(r["mode"], r["verdict"],
                                r["metrics"].get("tflops_hw"))
                               for r in recs if "tflops_hw" in r["metrics"]],
              "crosscheck": [(r["verdict"], r["metrics"], r["notes"])
                             for r in cross], "ok": ok})
        if not ok:
            bad.append(f"crosscheck: {cross}")
        ends["e"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "longctx_phase", "seconds": time.perf_counter() - t_phase,
          "leg_end_s": ends, "longctx_launches": launches,
          "direct_launches": direct, "card": _smi()})
    if bad:
        raise AssertionError("longctx: " + " | ".join(bad))
    return launches, f32_rows, shard_err


# -- phase 20: the parallelism patterns (parallel/) -------------------------

# (leg, argv): each subcommand at its config's defaults, nothing cut:
# overlap (rows 1024, E 4096, F 4096, bf16, ag and rs) at 4 ranks and 1,
# pipeline (n_micro 8, batch 4, dim 256, f32, gpipe and 1f1b) at 4 and 2
# ranks with the conveyor and with replicated microbatches, moe (512
# tokens a rank, dim 128, f32, cf 0/2/1) at 4 and 1 and in bf16 at 4
PAR_LEGS = (
    [(f"overlap_{n}", ["overlap", "--devices", str(n)]) for n in (4, 1)]
    + [(f"pipeline_{n}_{'sharded' if s else 'replicated'}",
        ["pipeline", "--devices", str(n), "--micro_sharded", str(s).lower()])
       for n in (4, 2) for s in (True, False)]
    + [(f"moe_{n}", ["moe", "--devices", str(n)]) for n in (4, 1)]
    + [("moe_4_bf16", ["moe", "--devices", "4", "--dtype", "bfloat16"])])
PAR_RECORDS = {"overlap": 2, "pipeline": 2, "moe": 3}
# the ZeRO check: leaves of 4096 x 4096, (4096,) and 61 (the pad path) at
# 4 ranks; zero_apply against the replicated update
ZERO_RANKS = 4
ZERO_SHAPES = {"w": (4096, 4096), "b": (4096,), "pad": (61,)}
ZERO_RTOL = 1e-6


def par_zero(torch):
    """ZeRO over 4 ranks on the card: one SGD step and two Adam steps of
    ``zero_apply`` against the same optimizer on the replicated params
    and the summed grads (max |zero - replicated| over max |replicated|,
    each leaf, each rank), each rank's Adam state 1/4 of a leaf."""
    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.parallel import optim, zero

    mesh = mesh_mod.default_mesh(ZERO_RANKS, DEVICE)
    dev = mesh.devices[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def tree():
        return {k: torch.randn(s, generator=gen, device=dev)
                for k, s in ZERO_SHAPES.items()}

    params, grads = tree(), [tree() for _ in range(ZERO_RANKS)]
    g_sum = {k: torch.stack([g[k] for g in grads]).sum(0) for k in params}
    rows, bad = [], []
    for name, tx, steps in (("sgd", optim.sgd(0.1), 1),
                            ("adam", optim.adam(1e-3), 2)):
        t0 = time.perf_counter()
        ps = [{k: v.clone() for k, v in params.items()} for _ in mesh.devices]
        state = zero.zero_init(tx, ps)
        for _ in range(steps):
            ps, state = zero.zero_apply(tx, grads, state, ps)
        torch.cuda.synchronize()
        zero_s = time.perf_counter() - t0
        rp, rst = params, tx.init(params)
        for _ in range(steps):
            upd, rst = tx.update(g_sum, rst, rp)
            rp = optim.apply_updates(rp, upd)
        err = max(float((p[k] - rp[k]).abs().max())
                  / max(float(rp[k].abs().max()), 1e-30)
                  for p in ps for k in rp)
        shard = {k: zero.shard_size(math.prod(s), ZERO_RANKS)
                 for k, s in ZERO_SHAPES.items()}
        sharded = name == "sgd" or all(
            st.mu[k].numel() == st.nu[k].numel() == shard[k]
            for st in state for k in shard)
        ok = err <= ZERO_RTOL and sharded
        rows.append({"optimizer": name, "steps": steps, "rel_err": err,
                     "state_sharded": sharded, "seconds": zero_s,
                     "ok": ok})
        if not ok:
            bad.append(f"zero {name}: rel err {err:.3e}, state sharded "
                       f"{sharded}")
    memory = zero.memory_model(params, ZERO_RANKS)
    emit({"phase": "parallel", "leg": "zero", "ranks": ZERO_RANKS,
          "shapes": ZERO_SHAPES, "rtol": ZERO_RTOL, "runs": rows,
          "memory_model": memory,
          "verdict": "SUCCESS" if not bad else "FAILURE"})
    return bad


def phase_parallel(torch):
    """Phase 20 (module docstring): the ``overlap``, ``pipeline`` and
    ``moe`` subcommands over rank meshes on the card, then the ZeRO
    check.  Raises if any Record or check fails."""
    from tpu_patterns_torch.runtime import match_device_spec

    t_phase = time.perf_counter()
    peak = match_device_spec(torch.cuda.get_device_name(0))["bf16_tflops"]
    bad, ends = [], {}
    for leg, argv in PAR_LEGS:
        t0 = time.perf_counter()
        rc, _, recs = _cli_in_process([*argv, "--device", DEVICE])
        ranks = int(argv[argv.index("--devices") + 1])
        row = {"phase": "parallel", "leg": leg, "argv": argv, "rc": rc,
               "seconds": time.perf_counter() - t0,
               "records": [(r["mode"], r["commands"], r["verdict"],
                            r["metrics"]) for r in recs],
               "notes": sorted({n for r in recs for n in r["notes"]})}
        if argv[0] == "overlap":
            # tflops_decomposed counts a rank's flops; the ranks share the
            # one card, so the card's rate is ranks x that (the baseline's:
            # the same flops over its own time)
            row["card_tflops"] = {}
            for r in recs:
                m = r["metrics"]
                rate = ranks * m["tflops_decomposed"]
                row["card_tflops"][r["mode"]] = {
                    "decomposed": rate,
                    "baseline": rate * m["decomposed_us"] / m["baseline_us"]}
            row["bf16_peak_tflops"] = peak
            over = [m for m, t in row["card_tflops"].items()
                    if max(t.values()) > peak]
            if over:
                bad.append(f"{leg}: card rate above the bf16 peak {over}")
        emit(row)
        failed = [r["mode"] for r in recs if r["verdict"] != "SUCCESS"]
        if rc != 0 or failed or len(recs) != PAR_RECORDS[argv[0]]:
            bad.append(f"{leg}: rc {rc}, {len(recs)} Records, not "
                       f"SUCCESS: {failed}")
        ends[leg] = time.perf_counter() - t_phase
    bad += par_zero(torch)
    emit({"phase": "parallel_phase", "seconds": time.perf_counter() - t_phase,
          "leg_end_s": ends, "card": _smi()})
    if bad:
        raise AssertionError("parallel: " + " | ".join(bad))


# phase 21: the model train step across ranks
MM_MESHES = (  # (leg, (dp, sp, tp), FlagshipConfig fields)
    ("111", (1, 1, 1), {}),
    ("221", (2, 2, 1), {}),
    ("141", (1, 4, 1), {}),
    ("122", (1, 2, 2), {}),
    ("222", (2, 2, 2), {}),
    ("141_striped", (1, 4, 1), dict(attn_layout="striped")),
    ("122_moe", (1, 2, 2), dict(moe=True)),
    ("221_zero_adam", (2, 2, 1), dict(optimizer="zero-adam")),
    ("221_zero_adam_offload", (2, 2, 1),
     dict(optimizer="zero-adam-offload")),
)
# z carries at most 4 bf16 roundings that differ between meshes (the
# row-parallel sums of o and m, the attention merge, the residual adds),
# each within u = 2^-8 of |z|, so |d sum(z^2)| <= 2 * 4u * sum(z^2).
# At this init attention is ~1e-5 of sum(z^2), so this gate holds the
# mesh's x + MLP path; the gradient gate below holds its attention.
MM_LOSS_RTOL = 2 * 4 * 2.0 ** -8
# The gradient gate: each leaf's world gradient (wqkv split into its q,
# k and v parts, which only attention's backward reaches) against the
# one-rank step's on the same params and input, as max |mesh - one rank|
# over max |one rank|, a part at a time.  On the H100 the sound meshes
# read at most 1.7e-2 in bf16 (moe's we1; the attention parts 7.9e-3)
# and 8.7e-7 in float32, the planted faults (MM_FAULTS, taken on every
# run) at least 0.19 and 0.33 (PERF.md, Findings): 2^-4 sits near the bf16
# pair's geometric mean, 1e-4 over two decades from either f32 reading.
MM_GRAD_TOL = {"bfloat16": 2.0 ** -4, "float32": 1e-4}
# the float32 kernels take head_dim 64 or 128 (longctx/flash.py)
MM_F32 = dict(embed=256, heads=8, head_dim=64, seq=1024, batch=4)
MM_TRAIN = ["train", "--device", DEVICE, "--devices", "4",
            "--optimizer", "zero-adam", "--ckpt_every", "2",
            "--attn", "kernel", "--heads", "4", "--head_dim", "64"]


def mm_grad_err(got: dict, want: dict) -> dict:
    """Each gradient part's max |got - want| over max |want| (wqkv, or
    wq and wkv, split into their q, k and v parts)."""

    def parts(g):
        out = {}
        for k, v in g.items():
            v = v.float()
            if k == "wqkv":
                out.update(wq=v[:, 0], wk=v[:, 1], wv=v[:, 2])
            elif k == "wkv":
                out.update(wk=v[:, 0], wv=v[:, 1])
            else:
                out[k] = v
        return out

    g, w = parts(got), parts(want)
    return {k: float((g[k].to(w[k].device) - w[k]).abs().max()
                     / w[k].abs().max()) for k in w}


def mm_grads(tr, mesh, cfg, params, xs, n_global=1.0):
    """(loss, global gradients) of the mesh step (``make_mesh_grads``,
    the grads ``make_train_step`` applies) at the global ``params``."""
    loss, g = tr.make_mesh_grads(mesh, cfg, n_global)(
        tr.shard_params(params, mesh, cfg), xs)
    return float(loss), tr.gather_params(g, mesh, cfg)


def mm_zero_grads(torch, tr, zs, mesh, cfg, params, xs, offload,
                  n_global=1.0):
    """(loss, global gradients) of the ZeRO step's path (sp sums, the dp
    reduce-scatter, and with ``offload`` the moments' trip to pinned
    host memory): one Adam step from zero moments leaves mu = (1 - b1) g
    on each rank's slice (b1 = 0.9, ``optim.adam``'s default)."""
    zstep, zinit, _ = zs.make_zero_train_step(
        mesh, cfg, lr=1e-30, optimizer="adam", offload_state=offload,
        n_global=n_global)
    _, state, loss = zstep(*zinit(tr.shard_params(params, mesh, cfg)), xs)
    torch.cuda.synchronize()  # offload's copies back to host memory
    mu = {k: [st.mu[k].to(dev) for st, dev in zip(state, mesh.devices)]
          for k in state[0].mu}
    return float(loss), {k: v.float() / (1 - 0.9) for k, v in
                         tr.gather_params(zstep.gather(mu), mesh,
                                          cfg).items()}


@contextlib.contextmanager
def _patched(mod, name, wrap):
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def _second_shard_first_block(q, q_off, k_off, stride) -> bool:
    """The ring's (q shard 1, kv shard 0) block, wholly or partly
    visible under the causal mask in either layout."""
    return k_off == 0 and q_off == (1 if stride > 1 else q.shape[0])


def _k3_drop(orig):
    def bad(q, k, v, q_off=0, k_off=0, **kw):
        if _second_shard_first_block(q, q_off, k_off,
                                     kw.get("pos_stride", 1)):
            from tpu_patterns_torch.longctx.attention import empty_state

            return empty_state(q.float())
        return orig(q, k, v, q_off=q_off, k_off=k_off, **kw)

    return bad


def _k4_drop(which):
    def wrap(orig):
        def bad(q, k, v, do, lse, delta, q_off=0, k_off=0, **kw):
            out = list(orig(q, k, v, do, lse, delta, q_off=q_off,
                            k_off=k_off, **kw))
            if _second_shard_first_block(q, q_off, k_off,
                                         kw.get("pos_stride", 1)):
                for i in which:
                    out[i] = out[i] * 0
            return tuple(out)

        return bad

    return wrap


def _tp_rank_0(orig):
    def bad(mesh, xs):
        return orig(mesh, [x if mesh.coord(r)["tp"] == 0 else x * 0
                           for r, x in enumerate(xs)])

    return bad


def _striped_as_contiguous(orig):
    def bad(*args, **kw):
        return orig(*args, **{**kw, "layout": "contiguous"})

    return bad


# planted faults: (name, the leg whose mesh and params they run on, the
# module attribute patched: "F" the flash kernels' wrappers, "tr" the
# model, and the patch).  Each must trip the gradient gate.
MM_FAULTS = (
    ("k3_drops_a_ring_block", "141", "F", "flash_block", _k3_drop),
    ("k4_dq_drops_a_ring_block", "141", "F", "flash_block_bwd",
     _k4_drop((0,))),
    ("k4_dkv_drops_a_ring_block", "141", "F", "flash_block_bwd",
     _k4_drop((1, 2))),
    ("attention_output_zero", "222", "tr", "_attend",
     lambda orig: lambda *a, **kw: [o * 0 for o in orig(*a, **kw)]),
    ("tp_sum_keeps_only_tp_rank_0", "122", "tr", "_tp_sum", _tp_rank_0),
    ("moe_combine_keeps_only_tp_rank_0", "122_moe", "tr", "_tp_sum",
     _tp_rank_0),
    ("striped_read_as_contiguous", "141_striped", "tr", "ring_attention",
     _striped_as_contiguous),
)


def mm_planted(F, tr, width, runs, faults, tol):
    """Each planted fault's gradient error on its leg's run (``runs[leg]``:
    mesh, cfg, params, xs, n_global, the reference grads ``ref`` and the
    sound reading ``worst``), with the sound runs' worst beside it; a
    fault the gate does not trip is a failure."""
    mods = {"F": F, "tr": tr}
    readings = {}
    for name, leg, mod, attr, wrap in faults:
        run = runs[leg]
        with _patched(mods[mod], attr, wrap):
            _, g = mm_grads(tr, run["mesh"], run["cfg"], run["params"],
                            run["xs"], run["n_global"])
        readings[name] = max(mm_grad_err(g, run["ref"]).values())
    sound = max(r["worst"] for r in runs.values())
    emit({"phase": "model_mesh", "leg": f"planted_faults_{width}",
          "grad_tol": tol, "sound_worst": sound, "faults": readings})
    return [f"{width}: the gradient gate ({tol:.3g}) misses planted fault "
            f"{n} ({e:.3e})" for n, e in readings.items() if not e > tol]


def mm_flagship(torch, F, fl, tr, zs, mesh_mod):
    """Leg a: the full-width flagship over each mesh of MM_MESHES, its
    gradients on each mesh against one rank's, and the planted
    faults."""
    smi = _smi()
    tol = MM_GRAD_TOL["bfloat16"]
    rows, bad, launches, refs, runs = {}, [], {}, {}, {}
    d = fl.FlagshipConfig(device=DEVICE)
    one = mesh_mod.model_mesh(1, device=DEVICE)
    for leg, (dp, sp, tp), kw in MM_MESHES:
        cfg = dataclasses.replace(d, **kw)
        mesh = mesh_mod.model_mesh(dp * sp * tp, dp, tp, device=DEVICE)
        torch.cuda.synchronize()
        F.reset_launches()
        rec, = fl.run_flagship(cfg, mesh=mesh)
        torch.cuda.synchronize()
        got = dict(F.LAUNCHES)
        steps = rec.config["train_steps"]
        per = cfg.depth * dp * tp * sp * sp
        want = {"flash_attention": 0, "flash_block": per * steps,
                "flash_block_bwd_dq": per * steps,
                "flash_block_bwd_dkv": per * steps}
        launches[leg] = got
        loss = rec.metrics["loss"]
        # the flagship's params and input; the reference is one rank on
        # them (moe: its own params, every expert on the one rank)
        mcfg = fl.model_config(cfg)
        params = tr.init_params(torch.Generator().manual_seed(cfg.seed),
                                mcfg, DEVICE, tr.n_experts(mesh, mcfg))
        xs = fl.batch_shards(cfg, mesh, mcfg.torch_dtype)
        if cfg.optimizer == "sgd":
            _, grads = mm_grads(tr, mesh, mcfg, params, xs)
        else:
            _, grads = mm_zero_grads(torch, tr, zs, mesh, mcfg, params, xs,
                                     cfg.optimizer.endswith("-offload"))
        if cfg.moe not in refs:
            refs[cfg.moe] = mm_grads(tr, one, mcfg, params, fl.batch_shards(
                cfg, one, mcfg.torch_dtype))
        ref, ref_grads = refs[cfg.moe]
        rel = abs(loss - ref) / abs(ref)
        gerr = mm_grad_err(grads, ref_grads)
        worst = max(gerr.values())
        runs[leg] = dict(mesh=mesh, cfg=mcfg, params=params, xs=xs,
                         n_global=1.0, ref=ref_grads, worst=worst)
        row = {"phase": "model_mesh", "leg": leg, "mesh": [dp, sp, tp],
               "mode": rec.mode, "commands": rec.commands,
               "verdict": rec.verdict.value, "step_ms": rec.metrics["step_ms"],
               "tflops": rec.metrics["tflops"], "loss": loss,
               "loss_ref": ref, "loss_rel_diff": rel,
               "loss_rtol": MM_LOSS_RTOL, "grad_err_of_max": gerr,
               "grad_tol": tol, "train_steps": steps,
               "launches": got, "launches_want": want,
               "memory_MB": {k: rec.metrics.get(k) for k in (
                   "peak_temp_MB", "argument_MB", "output_MB")},
               "notes": rec.notes, "card": smi}
        emit(row)
        rows[leg] = row
        if (not rec.verdict or got != want or not rel <= MM_LOSS_RTOL
                or not worst <= tol):
            bad.append(f"flagship {leg}: {rec.verdict.value} {rec.notes}, "
                       f"launches {got} want {want}, loss rel {rel:.3e}, "
                       f"grads {worst:.3e} of their max")
    bad += mm_planted(F, tr, "full_width_bf16", runs, MM_FAULTS, tol)
    return rows, launches, bad


def mm_exact(torch, F, tr, mesh_mod, zs, ps):
    """Leg b: float32, TF32 off, MM_F32's width, kernel attention."""
    from tpu_patterns_torch.runtime import exact_f32

    bad = []
    tol = MM_GRAD_TOL["float32"]
    cfg = tr.ModelConfig(embed=MM_F32["embed"], heads=MM_F32["heads"],
                         head_dim=MM_F32["head_dim"], attn="kernel")
    b, l, e = MM_F32["batch"], MM_F32["seq"], MM_F32["embed"]
    n_global = float(b * l * e)
    g = torch.Generator().manual_seed(21)
    params = tr.init_params(g, cfg, DEVICE)
    x = torch.randn((b, l, e), generator=g).to(DEVICE)
    out = {}
    with exact_f32(True):
        runs = {}
        for name, shape in (("111", (1, 1, 1)), ("222", (2, 2, 2))):
            mesh = mesh_mod.model_mesh(int(math.prod(shape)), shape[0],
                                       shape[2], device=DEVICE)
            xs = mesh.shard(x, ("dp", "sp", None))
            step = tr.make_train_step(mesh, cfg, lr=1.0, n_global=n_global)
            new, loss = step(tr.shard_params(params, mesh, cfg), xs)
            _, grads = mm_grads(tr, mesh, cfg, params, xs, n_global)
            runs[name] = (mesh, new, float(loss), xs, grads)
        mesh, new, loss, xs, grads = runs["222"]
        _, new1, loss1, _, grads1 = runs["111"]
        got = tr.gather_params(new, mesh, cfg)
        want = tr.gather_params(new1, runs["111"][0], cfg)
        err = max(float((got[k] - want[k]).abs().max()) for k in got)
        rel = abs(loss - loss1) / abs(loss1)
        gerr = mm_grad_err(grads, grads1)
        specs = tr.param_specs(cfg)
        replicas_equal = all(
            torch.equal(new[k][grp[0]], new[k][r])
            for k in new
            for grp in tr.reduce_groups(mesh, specs[k][1],
                                        ("dp", "sp", "tp"))
            for r in grp[1:])
        out["sgd_222_vs_111"] = {"loss_rel_diff": rel, "params_max_err": err,
                                 "grad_err_of_max": gerr,
                                 "replicas_bit_identical": replicas_equal}
        if not (rel <= 1e-5 and err <= 1e-6 and replicas_equal
                and max(gerr.values()) <= tol):
            bad.append(f"f32 (2,2,2) vs (1,1,1): loss rel {rel:.3e}, "
                       f"params {err:.3e}, grads {max(gerr.values()):.3e} "
                       f"of their max, replicas {replicas_equal}")
        zstep, zinit, _ = zs.make_zero_train_step(
            mesh, cfg, lr=1.0, optimizer="sgd", n_global=n_global)
        shards, state = zinit(tr.shard_params(params, mesh, cfg))
        shards, state, zloss = zstep(shards, state, xs)
        zgot = tr.gather_params(zstep.gather(shards), mesh, cfg)
        zerr = max(float(((zgot[k] - got[k]).abs()
                          - 1e-5 * got[k].abs()).max()) for k in got)
        zrel = abs(float(zloss) - loss) / abs(loss)
        _, zgrads = mm_zero_grads(torch, tr, zs, mesh, cfg, params, xs,
                                  False, n_global)
        zgerr = mm_grad_err(zgrads, grads)
        out["zero_sgd_vs_sgd"] = {"loss_rel_diff": zrel,
                                  "excess_over_rtol": zerr,
                                  "zero_grad_err_of_max": zgerr}
        if not (zrel <= 1e-5 and zerr <= 1e-7
                and max(zgerr.values()) <= tol):
            bad.append(f"zero-sgd vs sgd: loss rel {zrel:.3e}, params "
                       f"beyond rtol 1e-5 by {zerr:.3e} (atol 1e-7), ZeRO "
                       f"grads {max(zgerr.values()):.3e} of their max")
        m4 = mesh_mod.model_mesh(8, 1, 2, pp=2, device=DEVICE)
        stack = ps.init_stack_params(torch.Generator().manual_seed(22), cfg,
                                     2, DEVICE)
        pspecs = ps.stack_specs(cfg, 2)
        sharded = {k: m4.shard(v, pspecs[k][1]) for k, v in stack.items()}
        xs4 = m4.shard(x, ("dp", "sp", None))
        upd = {}
        for sched in ("gpipe", "1f1b"):
            step = ps.make_pipeline_train_step(m4, cfg, 2, lr=1.0,
                                               schedule=sched)
            new4, l4 = step(sharded, xs4)
            upd[sched] = ({k: stack[k] - m4.assemble(v, pspecs[k][1])
                           for k, v in new4.items()}, float(l4))
        # the flat step over the same two blocks on one stage's sub-mesh
        cfg2 = dataclasses.replace(cfg, depth=2)
        m3 = mesh_mod.model_mesh(4, 1, 2, device=DEVICE)
        new3, l3 = tr.make_train_step(m3, cfg2, lr=1.0)(
            tr.shard_params(stack, m3, cfg2), m3.shard(x, ("dp", "sp",
                                                           None)))
        upd["flat"] = ({k: stack[k] - v for k, v in
                        tr.gather_params(new3, m3, cfg2).items()}, float(l3))
        (a, la), (c, lc), (f, lf) = upd["gpipe"], upd["1f1b"], upd["flat"]
        perr = mm_grad_err(c, a)
        ferr = mm_grad_err(a, f)
        out["gpipe_vs_1f1b"] = {"loss_rel_diff": abs(la - lc) / abs(la),
                                "grad_err_of_max": perr}
        out["gpipe_vs_flat_122"] = {"loss_rel_diff": abs(la - lf) / abs(lf),
                                    "grad_err_of_max": ferr}
        for name, r in (("gpipe vs 1f1b", out["gpipe_vs_1f1b"]),
                        ("gpipe vs the flat step", out["gpipe_vs_flat_122"])):
            worst = max(r["grad_err_of_max"].values())
            if not (r["loss_rel_diff"] <= 1e-5 and worst <= tol):
                bad.append(f"{name}: loss rel {r['loss_rel_diff']:.3e}, "
                           f"grads {worst:.3e} of their max")
        sound = {"222": dict(mesh=mesh, cfg=cfg, params=params, xs=xs,
                             n_global=n_global, ref=grads1,
                             worst=max(gerr.values()))}
        bad += mm_planted(F, tr, "f32", sound,
                          [(n, "222", *rest) for n, _, *rest in MM_FAULTS
                           if n.startswith(("k3", "k4", "attention"))], tol)
    emit({"phase": "model_mesh", "leg": "f32_exact", "width": MM_F32,
          **out, "ok": not bad})
    return bad


def _ckpt_arrays(torch, tc, root, step):
    """Every leaf of a committed step as its global array (CPU)."""
    leaves = tc.describe(root)["steps"]
    info = next(s for s in leaves if s["step"] == step)["leaves"]
    template = {}
    for leaf in info:
        node = template
        path = re.findall(r"\['([^']*)'\]", leaf["key"])
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(leaf["shape"],
                                     dtype=getattr(torch, leaf["dtype"]))
    flat = {}

    def walk(node, pre=""):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                flat[pre + k] = v

    walk(tc.restore(root, template, step=step))
    return flat


def mm_train(torch, tc):
    """Leg c: the train CLI on a mesh, killed and resumed on the same
    mesh and on another."""
    bad = []
    work = os.path.join(ROOT, "build", "model_mesh_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    runs = {}
    for name, steps, extra in (("straight", 6, ["--dp", "2"]),
                               ("killed", 4, ["--dp", "2"])):
        rc, _, recs = _cli_in_process(
            [*MM_TRAIN, *extra, "--steps", str(steps), "--ckpt_dir",
             os.path.join(work, name)])
        runs[name] = (rc, [r["verdict"] for r in recs])
    shutil.copytree(os.path.join(work, "killed"),
                    os.path.join(work, "other_mesh"))
    for name, extra in (("killed", ["--dp", "2"]), ("other_mesh",
                                                     ["--dp", "1"])):
        rc, _, recs = _cli_in_process(
            [*MM_TRAIN, *extra, "--steps", "6", "--resume", "true",
             "--ckpt_dir", os.path.join(work, name)])
        runs[f"{name}_resumed"] = (rc, [r["verdict"] for r in recs])
    want = _ckpt_arrays(torch, tc, os.path.join(work, "straight"), 6)
    same = _ckpt_arrays(torch, tc, os.path.join(work, "killed"), 6)
    other = _ckpt_arrays(torch, tc, os.path.join(work, "other_mesh"), 6)
    bit_exact = set(same) == set(want) and all(
        torch.equal(same[k].view(torch.uint8) if same[k].dim() else same[k],
                    want[k].view(torch.uint8) if want[k].dim() else want[k])
        for k in want)
    other_err = max(float((other[k].double() - want[k].double()).abs()
                          .max()) for k in want if k.startswith("shards/"))
    row = {"phase": "model_mesh", "leg": "train", "argv": MM_TRAIN,
           "runs": runs, "same_mesh_bit_exact": bit_exact,
           "other_mesh_params_max_err": other_err,
           "leaves": sorted(want)}
    emit(row)
    if not all(rc == 0 for rc, _ in runs.values()):
        bad.append(f"train CLI: {runs}")
    if not bit_exact or not other_err <= 1e-5:
        bad.append(f"train resume: same mesh bit-exact {bit_exact}, other "
                   f"mesh max err {other_err:.3e}")
    shutil.rmtree(work, ignore_errors=True)
    return bad


def mm_cli():
    """Leg d: the flagship CLI over 4 ranks in a process of its own, on
    the package this process imported (``--tree``'s, or this
    checkout's)."""
    import tpu_patterns_torch

    t0 = time.perf_counter()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        tpu_patterns_torch.__file__)))
    argv = [sys.executable, "-m", "tpu_patterns_torch", "flagship",
            "--devices", "4", "--dp", "2"]
    path = os.environ.get("PYTHONPATH")
    proc = subprocess.run(argv, cwd=tree, capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": (
                              tree + os.pathsep + path if path else tree)})
    markers = [ln for ln in proc.stdout.splitlines() if ln.startswith("## ")]
    ok = proc.returncode == 0 and any(ln.endswith("| SUCCESS")
                                      for ln in markers)
    emit({"phase": "model_mesh", "leg": "cli", "argv": argv[1:],
          "package": tree, "rc": proc.returncode, "markers": markers,
          "seconds": time.perf_counter() - t0,
          "stderr_tail": proc.stderr[-400:] if not ok else ""})
    return [] if ok else [f"flagship CLI: rc {proc.returncode} {markers}"]


def mm_perf():
    """Leg e: the registry's ``zero.step`` capture through ``perf report``
    at ``PerfConfig``'s defaults."""
    rc, out, _ = _cli_in_process(["perf", "report", "--include", "zero.step",
                                  "--device", DEVICE, "--no-history"])
    table = [ln for ln in out.splitlines() if ln.startswith("|")]
    markers = [ln for ln in out.splitlines() if ln.startswith("## ")]
    ok = (rc == 0 and any(ln.startswith("| zero.step |") for ln in table)
          and any(ln.endswith("| SUCCESS") for ln in markers))
    emit({"phase": "model_mesh", "leg": "perf_zero_step", "rc": rc,
          "table": table, "markers": markers, "ok": ok})
    return [] if ok else [f"perf report zero.step: rc {rc} {markers}"]


def phase_model_mesh(torch, F):
    """Phase 21 (module docstring).  Returns K3/K4's launches by leg a's
    mesh; raises if any leg fails."""
    from tpu_patterns_torch import ckpt as tc
    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.models import flagship as fl
    from tpu_patterns_torch.models import pipeline_step as ps
    from tpu_patterns_torch.models import transformer as tr
    from tpu_patterns_torch.models import zero_step as zs

    t_phase = time.perf_counter()
    ends = {}
    rows, launches, bad = mm_flagship(torch, F, fl, tr, zs, mesh_mod)
    ends["flagship"] = time.perf_counter() - t_phase
    bad += mm_exact(torch, F, tr, mesh_mod, zs, ps)
    ends["f32_exact"] = time.perf_counter() - t_phase
    bad += mm_train(torch, tc)
    ends["train"] = time.perf_counter() - t_phase
    bad += mm_cli()
    ends["cli"] = time.perf_counter() - t_phase
    bad += mm_perf()
    ends["perf"] = time.perf_counter() - t_phase
    emit({"phase": "model_mesh_phase", "seconds": time.perf_counter()
          - t_phase, "leg_end_s": ends, "card": _smi(),
          "step_ms": {leg: r["step_ms"] for leg, r in rows.items()},
          "tflops": {leg: r["tflops"] for leg, r in rows.items()}})
    if bad:
        raise AssertionError("model_mesh: " + " | ".join(bad))
    return launches


# -- phase 22: decode and lm across ranks ------------------------------------

# (leg, (dp, sp, tp), DecodeConfig fields): (1,1,1) at the defaults (E
# 1024, 8 x 128 heads, depth 4, bf16, B 8, prefill 4096, gen 128) but
# reps 2 (the steps are host-bound: 768 a leg), the other meshes and the
# feature legs cut to depth 2 and gen 32 (the ranks run in turn on the
# card, so a mesh leg's host time grows with its ranks: at depth 4 and
# gen 128 (2,2,2) alone took 47.5 s)
DLM_CUT = dict(depth=2, gen=32, reps=2)
DLM_MESHES = (
    ("111", (1, 1, 1), dict(reps=2)),
    ("141", (1, 4, 1), DLM_CUT),
    ("122", (1, 2, 2), DLM_CUT),
    ("222", (2, 2, 2), DLM_CUT),
    ("striped_141", (1, 4, 1), dict(DLM_CUT, layout="striped")),
    ("moe_122", (1, 2, 2), dict(DLM_CUT, moe=True)),
    ("gqa4_rope_int8_122", (1, 2, 2), dict(DLM_CUT, kv_heads=4, rope=True,
                                           cache_int8=True)),
)
# the attention gate of leg b: each layer's combined attention output
# (before wo) at the prefill's last row and the first DLM_ATTN_STEPS
# teacher-forced decode steps, max |mesh - one rank| / max |one rank|;
# set from the sound meshes' and the planted faults' readings on the
# card (PERF.md §6)
DLM_ATTN_STEPS = 4
DLM_ATTN_TOL = {"float": 0.07, "int8": 0.25}
DLM_FAULT_LEGS = ("141", "gqa4_rope_int8_122")
# the gate's prompt and fed tokens are the run's scaled by this: at the
# default init the scores' spread is ~0.04, the softmax near-uniform,
# and a per-rank max moves the output by less than bf16 resolves (on
# the H100 it read 1.08e-2 unscaled, the sound meshes' own reading);
# x4 multiplies the scores by 16
DLM_ATTN_INPUT_SCALE = 4.0
# leg b's float32 probe (TF32 off): DecodeConfig at E 256, 8 x 64 heads,
# prefill 1024, B 4; outputs within DLM_F32_EPS float32 eps of the
# one-rank output's max (phase 15's DECODE_EXACT_EPS bound)
DLM_F32 = dict(embed=256, heads=8, head_dim=64, prefill=1024, batch=4,
               dtype="float32")
DLM_F32_EPS = 256
DLM_F32_MESHES = (("141", (1, 4, 1), {}), ("122", (1, 2, 2), {}),
                  ("222", (2, 2, 2), {}),
                  ("striped_141", (1, 4, 1), dict(layout="striped")))
# leg b's greedy ids in float32: the LM at the probe's widths
DLM_F32_LM = dict(vocab=1024, embed=256, heads=8, head_dim=64, depth=2,
                  dtype="float32")
DLM_F32_LM_GEN = 16


def _dlm_mesh(mesh_mod, shape):
    return mesh_mod.model_mesh(math.prod(shape), shape[0], shape[2],
                               device=DEVICE)


@contextlib.contextmanager
def _attn_capture(D):
    """Every combined attention output of the decoders run inside the
    block: ("prefill", mesh, per-rank outputs) from ``_prefill_attend``
    and ("decode", mesh, outputs) from ``_decode_attend``, in call
    order (layer by layer)."""
    calls = []
    real_p, real_d = D._prefill_attend, D._decode_attend

    def prefill_attend(mesh, layout, *a):
        out = real_p(mesh, layout, *a)
        calls.append(("prefill", mesh, [o.float() for o in out]))
        return out

    def decode_attend(mesh, *a):
        out = real_d(mesh, *a)
        calls.append(("decode", mesh, [o.float() for o in out]))
        return out

    D._prefill_attend, D._decode_attend = prefill_attend, decode_attend
    try:
        yield calls
    finally:
        D._prefill_attend, D._decode_attend = real_p, real_d


def _attn_global(torch, kind, mesh, outs):
    """[B, H, D] of one captured call: the prefill's last row (the last
    sp rank's last local row, contiguous and striped alike) or the decode
    query, each (dp, tp) block from its rank."""
    sp = mesh.dim("sp")
    b_loc, _, h_loc, d = outs[0].shape
    out = torch.empty(b_loc * mesh.dim("dp"), h_loc * mesh.dim("tp"), d,
                      device=outs[0].device)
    for r, o in enumerate(outs):
        at = mesh.coord(r)
        if at["sp"] != (sp - 1 if kind == "prefill" else 0):
            continue
        out[at["dp"] * b_loc:(at["dp"] + 1) * b_loc,
            at["tp"] * h_loc:(at["tp"] + 1) * h_loc] = o[:, -1 if kind ==
                                                        "prefill" else 0]
    return out


def dlm_attn_run(torch, D, tr, mesh, cfg, params, x, toks):
    """Every layer's combined attention output [calls, B, H, D] of a
    prefill of ``x`` then DLM_ATTN_STEPS teacher-forced steps fed
    ``toks`` over ``mesh``, from the global ``params``."""
    from tpu_patterns_torch.longctx.attention import stripe

    mcfg = D.model_config(cfg)
    pre, gen = D.make_decoder(mcfg, cfg.batch, cfg.prefill,
                              DLM_ATTN_STEPS * mesh.dim("sp"),
                              cache_int8=cfg.cache_int8, mesh=mesh)
    sharded = tr.shard_params(params, mesh, mcfg)
    sp = mesh.dim("sp")
    xs = mesh.shard(stripe(x, sp, axis=1) if cfg.layout == "striped" else x,
                    ("dp", "sp", None))
    with torch.no_grad(), _attn_capture(D) as calls:
        c, _ = pre(sharded, xs)
        for n in range(DLM_ATTN_STEPS):
            c, _ = gen(sharded, c, mesh.shard(toks[:, n:n + 1],
                                              ("dp", None, None)),
                       cfg.prefill + n, 1)
    return torch.stack([_attn_global(torch, *call) for call in calls])


def _attn_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _dlm_inputs(torch, D, tr, cfg, mesh):
    mcfg = D.model_config(cfg)
    params = D._stacked_params(cfg.seed, mcfg, DEVICE,
                               tr.n_experts(mesh, mcfg))
    x = D._probe_input(cfg.seed + 1, (cfg.batch, cfg.prefill, cfg.embed),
                       DEVICE).to(mcfg.torch_dtype)
    toks = D._probe_input(cfg.seed + 2, (cfg.batch, DLM_ATTN_STEPS,
                                         cfg.embed),
                          DEVICE).to(mcfg.torch_dtype)
    return params, x * DLM_ATTN_INPUT_SCALE, toks * DLM_ATTN_INPUT_SCALE


def _numer_left_out(orig):
    """The combine's sum of weighted values leaves the group's last rank
    out (the normalizers, last axis 1, are summed whole)."""
    def wrap(xs):
        if xs[0].shape[-1] == 1 or len(xs) == 1:
            return orig(xs)
        return orig(list(xs[:-1]) + [xs[-1] * 0])

    return wrap


def dlm_decode(torch, D, tr, mesh_mod):
    """Leg a: ``run_decode`` over each mesh of DLM_MESHES, both gates at
    the mesh."""
    bad, rows = [], {}
    smi = _smi()
    for leg, shape, kw in DLM_MESHES:
        mesh = _dlm_mesh(mesh_mod, shape)
        cfg = D.DecodeConfig(device=DEVICE, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec, = D.run_decode(cfg, lg_writer(), mesh=mesh)
        ragged = D._ragged_gate(dataclasses.replace(D.model_config(cfg),
                                                    rope=True),
                                device=DEVICE, mesh=mesh)
        torch.cuda.synchronize()
        m = rec.metrics
        want_mode = (f"sp{shape[1]}"
                     + (f"_gqa{cfg.kv_heads}" if cfg.kv_heads else "")
                     + ("_rope" if cfg.rope else "")
                     + ("_int8" if cfg.cache_int8 else "")
                     + ("_striped" if cfg.layout == "striped" else "")
                     + ("_moe" if cfg.moe else ""))
        row = {"phase": "decode_lm_mesh", "leg": f"decode_{leg}",
               "mesh": list(shape), "mode": rec.mode,
               "commands": rec.commands, "verdict": rec.verdict.value,
               "ms_per_token": m["ms_per_token"],
               "prefill_ms": m["prefill_ms"], "cache_MB": m["cache_MB"],
               "tokens_per_s": m["tokens_per_s"],
               "timing_converged": m["timing_converged"],
               "ragged_gate": ragged,
               "peak_device_MB": torch.cuda.max_memory_allocated() / 1e6,
               "leg_seconds": time.perf_counter() - t0, "card": smi,
               "notes": rec.notes}
        emit(row)
        rows[leg] = row
        if rec.verdict.value != "SUCCESS" or not ragged:
            bad.append(f"decode {leg}: {rec.verdict.value}, ragged gate "
                       f"{ragged}: " + "; ".join(rec.notes))
        if rec.mode != want_mode:
            bad.append(f"decode {leg}: mode {rec.mode}, want {want_mode}")
        if cfg.gen == 128 and m["cache_MB"] != 553.648:
            bad.append(f"decode {leg}: cache_MB {m['cache_MB']}")
    return rows, bad


def _attn_kind(kw) -> str:
    return "int8" if kw.get("cache_int8") else "float"


def dlm_attn_gate(torch, D, tr, mesh_mod):
    """Leg b: the attention gate, each mesh of DLM_MESHES against one
    rank on the same params, prompt and fed tokens, and the planted
    faults on the legs of DLM_FAULT_LEGS (a float and an int8 cache:
    the int8 one's limit is its own, its quantization moving a sound
    reading ~10x)."""
    bad = []
    t0 = time.perf_counter()
    one = _dlm_mesh(mesh_mod, (1, 1, 1))
    readings, faults = {}, {}
    for leg, shape, kw in DLM_MESHES[1:]:
        # the gate runs at the decode defaults' depth, where its limits
        # and planted faults were read (DLM_CUT's depth 2 let the per-rank
        # max at (1,4,1) read 4.8e-2, under the 0.07 limit)
        kw = {k: v for k, v in kw.items()
              if k not in ("gen", "reps", "depth")}
        cfg = D.DecodeConfig(device=DEVICE, **kw)
        mesh = _dlm_mesh(mesh_mod, shape)
        inputs = _dlm_inputs(torch, D, tr, cfg, mesh)
        ref = dlm_attn_run(torch, D, tr, one, cfg, *inputs)
        readings[leg] = _attn_err(
            dlm_attn_run(torch, D, tr, mesh, cfg, *inputs), ref)
        tol = DLM_ATTN_TOL[_attn_kind(kw)]
        if not readings[leg] <= tol:
            bad.append(f"attention gate: {leg} reads {readings[leg]:.3e} "
                       f"> {tol}")
        if leg not in DLM_FAULT_LEGS:
            continue
        for name, attr, wrap in (("numer_left_out", "_sp_sum",
                                  _numer_left_out),
                                 ("per_rank_max", "_sp_max",
                                  lambda orig: list)):
            with _patched(D, attr, wrap):
                e = faults[f"{name}_{leg}"] = _attn_err(
                    dlm_attn_run(torch, D, tr, mesh, cfg, *inputs), ref)
            if not e > tol:
                bad.append(f"attention gate misses planted fault {name} "
                           f"at {leg} ({e:.3e})")
    emit({"phase": "decode_lm_mesh", "leg": "attention_gate",
          "tol": DLM_ATTN_TOL, "input_scale": DLM_ATTN_INPUT_SCALE,
          "sound": readings, "faults": faults, "steps": DLM_ATTN_STEPS,
          "seconds": time.perf_counter() - t0, "card": _smi()})
    return bad


def dlm_f32(torch, D, tr, lm, mesh_mod):
    """Leg b's float32 probe, TF32 off: teacher-forced decode outputs
    over each mesh of DLM_F32_MESHES against one rank's, and the LM's
    greedy ids at (2,2,2) and striped (1,4,1) against one rank's."""
    from tpu_patterns_torch.longctx.attention import stripe

    bad = []
    t0 = time.perf_counter()
    eps = float(torch.finfo(torch.float32).eps)
    errs = {}
    with D._exact_matmuls(torch.device(DEVICE)):
        for leg, shape, kw in DLM_F32_MESHES:
            cfg = D.model_config(D.DecodeConfig(**DLM_F32, **kw))
            params = D._stacked_params(3, cfg, DEVICE)
            x = D._probe_input(4, (DLM_F32["batch"],
                                   DLM_F32["prefill"] + DLM_ATTN_STEPS,
                                   cfg.embed), DEVICE)
            got, want = D.teacher_forced(cfg, params, x, DLM_F32["prefill"],
                                         mesh=_dlm_mesh(mesh_mod, shape))
            one, _ = D.teacher_forced(cfg, params, x, DLM_F32["prefill"])
            scale = max(1.0, float(abs(one).max()))
            errs[leg] = {"vs_one_rank": float(abs(got - one).max()),
                         "vs_forward": float(abs(got - want).max()),
                         "bound": DLM_F32_EPS * eps * scale}
        ids = {}
        for leg, shape, kw in (("111", (1, 1, 1), {}),
                               ("222", (2, 2, 2), {}),
                               ("striped_141", (1, 4, 1),
                                dict(attn_layout="striped"))):
            cfg = tr.ModelConfig(**{k: v for k, v in DLM_F32_LM.items()
                                    if k != "vocab"}, rope=True, **kw)
            mesh = _dlm_mesh(mesh_mod, shape)
            params = lm.init_lm_params(5, cfg, DLM_F32_LM["vocab"], DEVICE)
            toks = torch.randint(0, DLM_F32_LM["vocab"],
                                 (DLM_F32["batch"], DLM_F32["prefill"]),
                                 generator=torch.Generator().manual_seed(6))
            if cfg.attn_layout == "striped":
                toks = stripe(toks, shape[1], axis=1)
            pre, gen = lm.make_lm_decoder(
                cfg, DLM_F32_LM["vocab"], DLM_F32["batch"],
                DLM_F32["prefill"], DLM_F32_LM_GEN, mesh=mesh)
            p = lm.shard_lm_params(params, mesh, cfg)
            c, t0_ids = pre(p, mesh.shard(toks.to(DEVICE), ("dp", "sp")))
            _, out = gen(p, c, t0_ids, DLM_F32["prefill"], DLM_F32_LM_GEN)
            ids[leg] = torch.cat([mesh.assemble(t0_ids, ("dp",))[:, None],
                                  mesh.assemble(out, ("dp", None))],
                                 dim=1).cpu()
    same = {leg: bool(torch.equal(v, ids["111"])) for leg, v in ids.items()}
    emit({"phase": "decode_lm_mesh", "leg": "f32_exact", **{
        k: v for k, v in DLM_F32.items()}, "steps": DLM_ATTN_STEPS,
        "decode": errs, "tolerance": f"{DLM_F32_EPS} eps(f32) x max(1, "
        "max|one rank|)", "lm_greedy_ids_equal": same,
        "lm_ids_shape": list(ids["111"].shape),
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "seconds": time.perf_counter() - t0})
    bad += [f"f32 decode {leg}: {e['vs_one_rank']:.3e} from one rank, "
            f"bound {e['bound']:.3e}" for leg, e in errs.items()
            if not e["vs_one_rank"] <= e["bound"]]
    bad += [f"f32 lm greedy ids at {leg} differ from one rank's"
            for leg, ok in same.items() if not ok]
    return bad


# leg c's sampled runs: their ids must repeat at one seed, so a short
# training and generation do
DLM_SAMPLED = dict(temperature=0.8, steps=2, gen=8)


def dlm_lm(torch, lm, mesh_mod):
    """Leg c: ``run_lm`` at LMConfig's defaults over (2,2,2), striped
    (1,4,1) and moe (1,2,2), each loss_first (recomputed unrounded on
    the run's params and tokens, ``lm.lm_inputs``) against one rank's
    (moe: against (1,1,2), the expert count being tp), the greedy ids at
    (2,2,2) against one rank's, and the sampled ids (T 0.8, top_k 0 and
    40, DLM_SAMPLED) repeating at one seed."""
    bad, rows = [], {}
    legs = (("111", (1, 1, 1), {}), ("222", (2, 2, 2), {}),
            ("striped_141", (1, 4, 1), dict(layout="striped")),
            ("moe_112", (1, 1, 2), dict(moe=True)),
            ("moe_122", (1, 2, 2), dict(moe=True)),
            ("T0.8_222", (2, 2, 2), DLM_SAMPLED),
            ("T0.8_222_again", (2, 2, 2), DLM_SAMPLED),
            ("T0.8_k40_222", (2, 2, 2), dict(DLM_SAMPLED, top_k=40)),
            ("T0.8_k40_222_again", (2, 2, 2), dict(DLM_SAMPLED, top_k=40)))
    ids, losses = {}, {}
    for leg, shape, kw in legs:
        mesh = _dlm_mesh(mesh_mod, shape)
        t0 = time.perf_counter()
        with _lm_ids(lm) as seen:
            rec, = lm.run_lm(lm.LMConfig(device=DEVICE, **kw), lg_writer(),
                             mesh=mesh)
        m, out = seen[-1]
        ids[leg] = m.assemble(out, ("dp", None)).cpu()
        rows[leg] = rec.metrics
        if "temperature" not in kw:  # the Record's loss_first, unrounded
            cfg = lm.LMConfig(device=DEVICE, **kw)
            mcfg, params, toks = lm.lm_inputs(cfg, mesh)
            with torch.no_grad():
                losses[leg] = float(lm.lm_loss_mesh(
                    mesh, lm.shard_lm_params(params, mesh, mcfg),
                    mesh.shard(toks, ("dp", "sp")), mcfg))
        emit({"phase": "decode_lm_mesh", "leg": f"lm_{leg}",
              "mesh": list(shape), "mode": rec.mode,
              "commands": rec.commands, "verdict": rec.verdict.value,
              **rec.metrics, "notes": rec.notes,
              "leg_seconds": time.perf_counter() - t0})
        if rec.verdict.value != "SUCCESS":
            bad.append(f"lm {leg} {rec.verdict.value}: "
                       + "; ".join(rec.notes))
    checks = {
        "loss_first_222": ("222", "111"),
        "loss_first_striped_141": ("striped_141", "111"),
        "loss_first_moe_122": ("moe_122", "moe_112"),
    }
    rel = {name: abs(losses[a] - losses[b]) / abs(losses[b])
           for name, (a, b) in checks.items()}
    same = {"greedy_222": bool(torch.equal(ids["222"], ids["111"])),
            "T0.8_again": bool(torch.equal(ids["T0.8_222"],
                                           ids["T0.8_222_again"])),
            "T0.8_k40_again": bool(torch.equal(ids["T0.8_k40_222"],
                                               ids["T0.8_k40_222_again"])),
            "T0.8_unlike_greedy": not bool(torch.equal(ids["T0.8_222"],
                                                       ids["222"]))}
    emit({"phase": "decode_lm_mesh", "leg": "lm_checks",
          "loss_first": losses, "loss_first_rel": rel, "ids": same})
    bad += [f"lm {n}: loss_first off by {e:.2e} relative"
            for n, e in rel.items() if not e <= 1e-5]
    bad += [f"lm ids: {n} is false" for n, ok in same.items() if not ok]
    return rows, bad


def dlm_cli_start():
    """Leg d: ``decode --devices 4 --tp 2`` and ``lm --devices 8 --dp 2
    --tp 2`` at their defaults, each in a process of its own on the
    package this process imported, both at once; started here,
    collected by :func:`dlm_cli_finish`."""
    import tpu_patterns_torch

    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        tpu_patterns_torch.__file__)))
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ, "PYTHONPATH": (tree + os.pathsep + path if path
                                        else tree)}
    runs = [["decode", "--devices", "4", "--tp", "2"],
            ["lm", "--devices", "8", "--dp", "2", "--tp", "2"]]
    return tree, time.perf_counter(), [
        (argv, subprocess.Popen([sys.executable, "-m", "tpu_patterns_torch",
                                 *argv], cwd=tree, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE))
        for argv in runs]


def dlm_cli_finish(started):
    tree, t0, procs = started
    bad = []
    for argv, proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        markers = [ln for ln in out.splitlines() if ln.startswith("## ")]
        ok = proc.returncode == 0 and any(ln.endswith("| SUCCESS")
                                          for ln in markers)
        emit({"phase": "decode_lm_mesh", "leg": "cli", "argv": argv,
              "package": tree, "rc": proc.returncode, "markers": markers,
              "seconds": time.perf_counter() - t0,
              "stderr_tail": err[-400:] if not ok else ""})
        if not ok:
            bad.append(f"{' '.join(argv)}: rc {proc.returncode} {markers}")
    return bad


def phase_decode_lm_mesh(torch, pk, F):
    """Phase 22 (module docstring).  Returns K1's and K2-K4's launches in
    the phase (each must be 0); raises if any leg fails."""
    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.models import decode as D
    from tpu_patterns_torch.models import lm
    from tpu_patterns_torch.models import transformer as tr

    t_phase = time.perf_counter()
    pk.paged_block.launches = 0
    F.reset_launches()
    ends = {}
    rows, bad = dlm_decode(torch, D, tr, mesh_mod)
    ends["decode"] = time.perf_counter() - t_phase
    # the CLI processes run beside legs b and c, after the timed decode
    # legs (their timings are informational)
    cli = dlm_cli_start()
    try:
        bad += dlm_attn_gate(torch, D, tr, mesh_mod)
        ends["attention_gate"] = time.perf_counter() - t_phase
        bad += dlm_f32(torch, D, tr, lm, mesh_mod)
        ends["f32"] = time.perf_counter() - t_phase
        lm_rows, lm_bad = dlm_lm(torch, lm, mesh_mod)
        bad += lm_bad
        ends["lm"] = time.perf_counter() - t_phase
    finally:
        bad += dlm_cli_finish(cli)
    ends["cli"] = time.perf_counter() - t_phase
    torch.cuda.synchronize()
    launches = {"paged_attention": pk.paged_block.launches, **F.LAUNCHES}
    emit({"phase": "decode_lm_mesh_phase",
          "seconds": time.perf_counter() - t_phase, "leg_end_s": ends,
          "kernel_launches": launches, "card": _smi(),
          "ms_per_token": {leg: r["ms_per_token"] for leg, r in rows.items()},
          "prefill_ms": {leg: r["prefill_ms"] for leg, r in rows.items()},
          "cache_MB": {leg: r["cache_MB"] for leg, r in rows.items()},
          "gen_tokens_per_s": {leg: r["gen_tokens_per_s"]
                               for leg, r in lm_rows.items()}})
    if any(launches.values()):
        bad.append(f"decode/lm across ranks launched kernels: {launches}")
    if bad:
        raise AssertionError("decode_lm_mesh: " + " | ".join(bad))
    return launches


# -- phase 23: serve across ranks (the sharded pool, K1 at sp > 1) ----------

# (leg, (dp, sp, tp)): the serve width's meshes, all ranks on the card
SM_MESHES = (("11", (1, 1, 1)), ("21", (1, 2, 1)), ("12", (1, 1, 2)),
             ("22", (1, 2, 2)), ("41", (1, 4, 1)))
# the mesh legs' cut of phase 5's trace (16 requests, 64 generated) and
# of its depth (4): the ranks run one after another on the card, so a
# mesh leg's host time grows with its ranks
SM_CUT = dict(requests=6, gen=16, depth=2)
# the bf16 legs serve their 6 requests through 4 slots, so the
# continuous leg admits 2 of them mid-run, into recycled slots
SM_BF16 = {**FULL_WIDTH, "dtype": "bfloat16", **SM_CUT, "slots": 4}
SM_F32 = dict(FULL_WIDTH, dtype="float32", **SM_CUT)
# part a: K1 on a stripe against its plain version (phase 3's
# tolerances), and the sp group's combine against the sp = 1 kernel on
# the whole pool, max |diff| / max |sp 1|: float32 sums in another
# order; a bf16 q's output rounds to bf16 once
SM_TOL = {"f32": 2e-5, "bf16": 1e-4, "int8": 1e-4}
SM_COMBINE_TOL = {"f32": 1e-5, "bf16": 2.0**-7, "int8": 2.0**-7}
SM_SPS = (2, 4)
SM_LOADGEN = "chat:requests=16"


def _mesh_note(mesh):
    note = mesh.note("sp combines and tp sums")
    return [note] if note else []


def sm_stripes(case, sp):
    """Each rank's stripe of a case's global pool (block slots
    [r * bl_loc, (r + 1) * bl_loc)), contiguous on the card."""
    pool = case[0]
    bl = pool["k"].shape[1] // sp
    return [{n: t[:, r * bl:(r + 1) * bl].contiguous()
             for n, t in pool.items()} for r in range(sp)]


def sm_check_stripes(torch, pk, name, case, sp, kind):
    """K1 at every rank of sp on the case's stripes against its plain
    version (a row the rank sees nothing of: m = NEG_INF, exact zeros),
    then the group's combine of the kernel's triples against the sp = 1
    kernel on the whole pool.  Returns (max abs err, combine err)."""
    from tpu_patterns_torch.serve.paged import PagedLayout, paged_attend

    pool, q, tables, pos0, active = case
    stripes = sm_stripes(case, sp)
    err = 0.0
    for r, st in enumerate(stripes):
        args = (q, st["k"], st["v"], tables, pos0, active)
        kw = dict(block_len=16, rank=r, k_scale=st.get("ks"),
                  v_scale=st.get("vs"))
        got = pk.paged_block(*args, **kw)
        want = pk.paged_block_reference(*args, **kw)
        torch.cuda.synchronize()
        for g, w_, what in zip(got, want, ("o", "m", "l")):
            if not torch.allclose(g, w_, rtol=SM_TOL[kind],
                                  atol=SM_TOL[kind]):
                raise AssertionError(
                    f"{name} sp{sp} rank {r}: kernel {what} differs from "
                    f"the plain version by {float((g - w_).abs().max())}")
            err = max(err, float((g - w_).abs().max()))
        o, m, l_ = got
        blind = m == pk.NEG_INF
        if bool((o[blind] != 0).any()) or bool((l_[blind] != 0).any()):
            raise AssertionError(f"{name} sp{sp} rank {r}: a row this rank "
                                 "sees nothing of is not exactly zero")
    outs = paged_attend(stripes, [q] * sp, [tables] * sp, [pos0] * sp,
                        [active] * sp, PagedLayout(pool["k"].shape[0], 16, sp))
    (one,) = paged_attend([pool], [q], [tables], [pos0], [active],
                          PagedLayout(pool["k"].shape[0], 16))
    return err, max(_rel(o, one)[0] for o in outs)


def sm_cases(torch):
    """Part a's cases at the serve width (8 rows, 8 x 128 heads over 2
    kv heads, block_len 16, 36-page tables of the serve slice's
    lifetimes): bf16, f32 and int8 (bf16 q), W 1 and 5, rows 0 and 1 at
    positions 1 and 5 (page 0 dead on the upper ranks: at sp 4 ranks 1-3
    see nothing of row 0 at W 1, ranks 2-3 nothing of row 1), an inactive
    row 5."""
    cases = {}
    for kind in ("bf16", "f32", "int8"):
        for w in (1, 5):
            case = slice_case(torch, kind=kind, w=w, h=8, hkv=2,
                              seed=31 + w, q_bf16=kind == "int8")
            case[3][0], case[3][1] = 1, 5
            case[4][5] = False
            cases[f"serve_{kind}_w{w}"] = (kind, case)
    return cases


def sm_kernel(torch, pk, ck, timing, spec):
    """Part a: K1 on the stripes at sp 1, 2 and 4, every rank, against
    its plain version and, combined, against the sp = 1 kernel; the long
    window too; then K1's time a launch at rank 0 and rank sp - 1 of the
    bf16 W 1 serve case and of the long window (and at sp 1 on the same
    pools), L2 flushed and queued, beside each one's bound."""
    t0 = time.perf_counter()
    res = {"cases": 0, "max_abs_err": 0.0, "combine_rel_err": {}}
    cases = sm_cases(torch)
    for name, (kind, case) in cases.items():
        # sp 1: the unsharded launch with its new arguments, on its own
        for sp in (1, *SM_SPS):
            err, cerr = sm_check_stripes(torch, pk, name, case, sp, kind)
            res["cases"] += sp
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["combine_rel_err"][f"{name}_sp{sp}"] = cerr
            if not cerr <= SM_COMBINE_TOL[kind]:
                raise AssertionError(f"{name} sp{sp}: combine off the sp 1 "
                                     f"kernel by {cerr:.3e}")
    long_case = long_window_case(torch)
    for sp in SM_SPS:
        err, cerr = sm_check_stripes(torch, pk, "long_window", long_case,
                                     sp, "bf16")
        res["cases"] += sp
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["combine_rel_err"][f"long_window_sp{sp}"] = cerr
        if not cerr <= SM_COMBINE_TOL["bf16"]:
            raise AssertionError(f"long window sp{sp}: combine off by "
                                 f"{cerr:.3e}")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=DEVICE)

    def timed(case, st, rank):
        """K1 on ``st`` (a stripe of ``case``'s pool, or the pool) at
        ``rank``: ms a launch with the L2 flushed before each, device ms
        with no host gaps (20 launches queued behind a busy-wait, warm
        in L2) and the host's ms to enqueue one, beside the bound."""
        _, q, tables, pos0, active = case

        def fn():
            return pk.paged_block(q, st["k"], st["v"], tables, pos0, active,
                                  block_len=16, rank=rank,
                                  k_scale=st.get("ks"), v_scale=st.get("vs"))

        t = timing.cuda_time_repeated_ms(fn, before=flush.zero_)
        queued, host = _queued_ms(torch, ck, fn)
        nbytes, flops = kernel_bytes_and_ops((st, q, tables, pos0, active),
                                             16, rank)
        bound = max(nbytes / (spec["hbm_gbps"] * 1e9),
                    flops / (spec["f32_tflops"] * 1e12)) * 1e3
        return {"ms": t["ms"], "min": t["min"], "max": t["max"],
                "queued_ms": queued, "host_ms_a_call": host,
                "bound_ms": bound, "bytes": nbytes}

    times = {}
    for shape, case in (("serve", cases["serve_bf16_w1"][1]),
                        ("long_window", long_case)):
        times[f"{shape}_sp1"] = timed(case, case[0], 0)
        for sp in SM_SPS:
            st = sm_stripes(case, sp)
            for r in (0, sp - 1):
                times[f"{shape}_sp{sp}_rank{r}"] = timed(case, st[r], r)
            del st
    del long_case
    emit({"phase": "serve_mesh", "leg": "a_k1_stripes", **res,
          "tol": SM_TOL, "combine_tol": SM_COMBINE_TOL,
          "shape": "B8 H8 Hkv2 D128 bl16 pages36, W1 and W5, bf16/f32/int8; "
          "B32 4096-token windows bf16 (Hkv 8)", "times_bf16_w1": times,
          "seconds": time.perf_counter() - t0, "card": _smi()})
    return res, times


def sm_combine_gate(torch, pk, P):
    """Part c: the combine gate of part a on the f32 W 5 serve case at sp
    2 and 4, sound, then with each planted fault (a per-rank max in place
    of the group's, one rank's weighted values left out of the sum),
    each of which must read above the gate's tolerance."""
    _, case = sm_cases(torch)["serve_f32_w5"]
    tol = SM_COMBINE_TOL["f32"]
    readings, bad = {}, []
    faults = (("per_rank_max", "_sp_max", lambda orig: list),
              ("numer_left_out", "_sp_sum", _numer_left_out_o))
    for sp in SM_SPS:
        readings[f"sound_sp{sp}"] = sm_check_stripes(
            torch, pk, "gate", case, sp, "f32")[1]
        if not readings[f"sound_sp{sp}"] <= tol:
            bad.append(f"the sound combine at sp {sp} reads "
                       f"{readings[f'sound_sp{sp}']:.3e}")
        for name, attr, wrap in faults:
            with _patched(P, attr, wrap):
                e = readings[f"{name}_sp{sp}"] = sm_check_stripes(
                    torch, pk, "gate", case, sp, "f32")[1]
            if not e > tol:
                bad.append(f"the combine gate misses {name} at sp {sp} "
                           f"({e:.3e})")
    emit({"phase": "serve_mesh", "leg": "c_combine_gate", "tol": tol,
          "readings": readings, "card": _smi()})
    return bad


def _numer_left_out_o(orig):
    """The K1 combine's sum of weighted values [B, Hkv, G*W, D] leaves
    the group's last rank out (the normalizers are summed whole)."""
    def wrap(xs):
        if xs[0].dim() == 4 and len(xs) > 1:
            return orig(list(xs[:-1]) + [xs[-1] * 0])
        return orig(xs)

    return wrap


def _counting(calls):
    """A wrap for ``PagedDecoder.verify`` (``step`` calls it) that
    counts its calls."""
    def wrap(orig):
        def verify(self, *a, **k):
            calls[0] += 1
            return orig(self, *a, **k)

        return verify

    return wrap


def sm_records(torch, pk, P, leg, mesh, fn):
    """``fn()`` (Records of the sharded decoder over ``mesh``) with K1's
    count set to 0 just before and read just after, and the decoder's
    step and verify calls counted: each launches K1 depth x ranks times.
    Returns (Records, launches, calls, seconds)."""
    calls = [0]
    with _patched(P.PagedDecoder, "verify", _counting(calls)):
        # _k1_leg's recorder keeps the count of the whole run
        # (serve_legs sets the module's count to 0 before each timed leg)
        recs, launches, _, secs = _k1_leg(torch, pk, fn)
    return recs, launches, calls[0], secs


def sm_record_rows(leg, mesh, recs, launches, calls, depth, secs):
    """One row a Record, and what fails the leg: a verdict other than
    SUCCESS (WARNING for a preempted run), an id off the same-mesh dense
    oracle, a mode without the mesh's sp, K1's launches 0 or other than
    depth x ranks x the decoder's calls."""
    bad = []
    want = depth * mesh.size * calls
    for rec in recs:
        m = rec.metrics
        ok = "WARNING" if m.get("preempted") == 1.0 else "SUCCESS"
        emit({"phase": "serve_mesh", "leg": leg, "mesh": list(mesh.shape),
              "mode": rec.mode, "commands": rec.commands,
              "verdict": rec.verdict.value, "metrics": m,
              "k1_launches": launches, "decoder_calls": calls,
              "seconds": secs, "notes": rec.notes})
        if rec.verdict.value != ok or m.get("exact", 1.0) != 1.0:
            bad.append(f"{leg} {rec.mode}: {rec.verdict.value} "
                       + "; ".join(rec.notes))
        if f"_sp{mesh.dim('sp')}" not in rec.mode:
            bad.append(f"{leg}: mode {rec.mode} lacks sp {mesh.dim('sp')}")
    if launches <= 0 or launches != want:
        bad.append(f"{leg}: K1 launched {launches} times, not depth x "
                   f"ranks x decoder calls = {want}")
    return bad


def sm_serve(torch, pk, eng_mod, P, lg, faults, mesh_mod):
    """Part b: the serve width over the meshes; returns (K1's launches by
    leg, bf16 rows by mesh, problems)."""
    bad, launches, rows = [], {}, {}
    smi = _smi()
    for leg, shape in SM_MESHES:
        mesh = _dlm_mesh(mesh_mod, shape)
        try:
            row = serve_leg(torch, eng_mod, f"bf16_{leg}",
                            eng_mod.ServeConfig(**SM_BF16), mesh=mesh,
                            phase="serve_mesh")
        except AssertionError as e:
            bad.append(str(e))
            continue
        row["card"] = smi
        rows[leg] = row
        launches[f"bf16_{leg}"] = row["kernel_launches"]
    mesh22 = _dlm_mesh(mesh_mod, (1, 2, 2))
    try:
        row = serve_leg(torch, eng_mod, "bf16_gqa2_int8_22",
                        eng_mod.ServeConfig(**SM_BF16, kv_heads=2,
                                            cache_int8=True),
                        gate_flips=False, mesh=mesh22, phase="serve_mesh")
        launches["bf16_gqa2_int8_22"] = row["kernel_launches"]
    except AssertionError as e:
        bad.append(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = eng_mod.ServeConfig(**SM_F32)
    mesh21 = _dlm_mesh(mesh_mod, (1, 2, 1))
    legs = [
        ("f32_prefix_spec_22", mesh22, lambda: eng_mod.run_serve(
            dataclasses.replace(f32, prefix_share=True,
                                shared_prefix=SHARED_PREFIX, spec_k=SPEC_K),
            lg_writer(), mesh22)),
        ("f32_41", _dlm_mesh(mesh_mod, (1, 4, 1)), None),
        ("f32_kv_tier_21", mesh21, lambda: eng_mod.run_serve(
            eng_mod.ServeConfig(**{**KV_WIDTH, "depth": SM_CUT["depth"]},
                                requests=KV_REQUESTS, kv_host_tier=True),
            lg_writer(), mesh21)),
        ("f32_loadgen_chat_22", mesh22, lambda: lg.run_loadgen(
            lg.LoadGenConfig(**LOADGEN_WIDTH, scenarios=(SM_LOADGEN,)),
            lg_writer(), mesh22)),
    ]
    for leg, mesh, fn in legs:
        if fn is None:
            fn = (lambda m: lambda: eng_mod.run_serve(f32, lg_writer(),
                                                      m))(mesh)
        recs, n, calls, secs = sm_records(torch, pk, P, leg, mesh, fn)
        launches[leg] = n
        bad += sm_record_rows(leg, mesh, recs, n, calls, f32.depth, secs)
    # a preempt/resume pair at (1, 2, 1): preempted after 4 steps (a
    # WARNING Record, a committed snapshot), then resumed to the end
    work = os.path.join(ROOT, "build", "serve_mesh_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        snap = dataclasses.replace(f32, snapshot_dir=os.path.join(work, "s"))
        faults.configure("serve.step:preempt:after=4:count=1")
        try:
            recs, n, calls, secs = sm_records(
                torch, pk, P, "f32_preempt_21", mesh21,
                lambda: eng_mod.run_serve(snap, lg_writer(), mesh21))
        finally:
            faults.configure(None)
        launches["f32_preempt_21"] = n
        bad += sm_record_rows("f32_preempt_21", mesh21, recs, n, calls,
                              f32.depth, secs)
        recs, n, calls, secs = sm_records(
            torch, pk, P, "f32_resume_21", mesh21,
            lambda: eng_mod.run_serve(dataclasses.replace(snap, resume=True),
                                      lg_writer(), mesh21))
        launches["f32_resume_21"] = n
        bad += sm_record_rows("f32_resume_21", mesh21, recs, n, calls,
                              f32.depth, secs)
        if recs[0].metrics.get("resumed_from", -1) < 0:
            bad.append("f32_resume_21: the run did not resume a snapshot")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, rows, bad


def phase_serve_mesh(torch, pk, timing, spec):
    """Phase 23 (module docstring).  Returns (K1's launches by leg, the
    stripe checks, K1's times by rank); raises if any part fails."""
    from tpu_patterns_torch import faults
    from tpu_patterns_torch import loadgen as lg
    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.concurrency import kernels as ck
    from tpu_patterns_torch.serve import engine as eng_mod
    from tpu_patterns_torch.serve import paged as P

    t_phase = time.perf_counter()
    ends = {}
    kres, ktimes = sm_kernel(torch, pk, ck, timing, spec)
    ends["a_k1_stripes"] = time.perf_counter() - t_phase
    launches, rows, bad = sm_serve(torch, pk, eng_mod, P, lg, faults,
                                   mesh_mod)
    ends["b_serve"] = time.perf_counter() - t_phase
    bad += sm_combine_gate(torch, pk, P)
    ends["c_combine_gate"] = time.perf_counter() - t_phase
    emit({"phase": "serve_mesh_phase",
          "seconds": time.perf_counter() - t_phase, "leg_end_s": ends,
          "k1_launches": launches, "card": _smi(),
          "cut": SM_CUT,
          "bf16_tokens_per_s": {leg: r["tokens_per_s"]
                                for leg, r in rows.items()},
          "bf16_oracle_flips": {leg: r["oracle_flips"]
                                for leg, r in rows.items()}})
    if bad:
        raise AssertionError("serve_mesh: " + " | ".join(bad))
    return launches, kres, ktimes


# -- phase 24: the replica fleet (N engine processes behind the router) ----

# the serve width in float32 (the exact-id gates), phase 5's trace (16
# requests, 64 generated)
FLEET_WIDTH = dict(FULL_WIDTH, dtype="float32", requests=16)
# leg a's scaling gate: off.  On the one card the reference's 1.8 over
# one replica is not met steadily (PERF.md: 1.365 and 1.781 in two
# calls): host paths of processes that share one card and its host; the
# one-replica leg runs all the same and the speedup is printed, not
# gated.  The requests are dealt round-robin: prefix routing splits a
# 16-request random trace by the ring's arcs (11 to 5 on the card),
# which measures the ring
FLEET_SPEEDUP_GATE = 0.0
FLEET_SCALING_POLICY = "round_robin"
# leg b: the reference fleet smoke's chat recipe, its token lengths
# doubled for block_len 16 (two shared blocks, so that a group's prompts
# share their routing key)
FLEET_CHAT = ("chat:requests=16:prefix_groups=2:shared_prefix=32"
              ":min_prompt=40:mean_prompt=48:max_prompt=64"
              ":min_gen=2:mean_gen=4:max_gen=6"
              ":slo_ttft_ms=60000:slo_tpot_ms=20000")
# leg c: the reference's recipe (scripts/prefix_store_smoke.py): the busy
# arc owner killed at the fleet's 5th decode step, the shared trace
FLEET_KILL = "serve.step:kill:after=4:count=1"
FLEET_KILL_CUT = dict(requests=8, gen=16)
# what the phase cuts of the serve width, by leg
# leg a: phase 5's trace at 16 generated tokens (its oracle, decoded
# once a run_replicas call, and the one-replica leg were most of its
# serving time at 64)
FLEET_SCALING_CUT = dict(gen=16)
FLEET_CUT = {"a_scaling": FLEET_SCALING_CUT, "c_store": FLEET_KILL_CUT}
# leg d: the reference's elastic recipe (scripts/elastic_smoke.py)
FLEET_RAMP = ("batch-summarize:requests=24:rate_rps=12:bulk_fraction=0.5"
              ":min_prompt=8:mean_prompt=14:max_prompt=20"
              ":min_gen=4:mean_gen=8:max_gen=12"
              ":slo_ttft_ms=60000:slo_tpot_ms=20000")
FLEET_ELASTIC = dict(replicas=1, elastic_reserve=1, slots=2,
                     scale_out_occupancy=1.1, scale_in_occupancy=0.1,
                     scale_sustain_s=0.1, scale_cooldown_s=0.5,
                     kv_host_tier=True, preempt="bulk",
                     burn_mitigation="shed", time_scale=0.05)


def _fleet_record(eng_mod, replica, mesh_mod, work, ranks=2, **kw):
    """One ``run_replicas`` call at the fleet width over ``ranks`` ranks
    on the card (a rank a slice); returns its Record."""
    from tpu_patterns_torch.core.results import ResultWriter

    cfg = eng_mod.ServeConfig(**{**FLEET_WIDTH, **kw}, replica_dir=work)
    recs = replica.run_replicas(
        cfg, ResultWriter(stream=io.StringIO()),
        mesh=mesh_mod.model_mesh(ranks, device=DEVICE))
    assert len(recs) == 1
    return recs[0]


def _fleet_row(rec, leg, t0) -> dict:
    row = {"phase": "fleet", "leg": leg, "mode": rec.mode,
           "verdict": rec.verdict.value, "metrics": rec.metrics,
           "paged_block_launches": rec.config.get("paged_block_launches"),
           "notes": rec.notes, "seconds": time.perf_counter() - t0,
           "card": _smi()}
    emit(row)
    return row


def phase_fleet(torch):
    """Phase 24 (module docstring).  Returns K1's launches by leg and
    replica; raises if any part fails."""
    import tempfile

    from tpu_patterns_torch import obs
    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.obs import fleet as obs_fleet
    from tpu_patterns_torch.serve import engine as eng_mod
    from tpu_patterns_torch.serve import replica

    t_phase = time.perf_counter()
    bad, launches, ends = [], {}, {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="fleet_", dir=os.path.join(ROOT, "build"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def launched(leg, row):
        legs = row["paged_block_launches"] or []
        launches[leg] = legs
        # every replica that reported (a killed child reports nothing)
        if not legs or any(v <= 0 for by in legs for v in by.values()):
            bad.append(f"{leg}: a replica launched K1 0 times: {legs}")

    # (a) scaling against one replica, the obs plane dumping under obs_dir
    obs_dir = os.path.join(work, "obs")
    t0 = time.perf_counter()
    obs.configure(obs_dir)
    try:
        rec = _fleet_record(eng_mod, replica, mesh_mod,
                            os.path.join(work, "a"), replicas=2,
                            replica_policy=FLEET_SCALING_POLICY,
                            min_replica_speedup=FLEET_SPEEDUP_GATE,
                            **FLEET_SCALING_CUT)
        obs.dump(reason="end_of_run")
    finally:
        obs.configure(None)
    row = _fleet_row(rec, "a_scaling", t0)
    launched("a_scaling", row)
    if rec.verdict.value != "SUCCESS":
        bad.append(f"scaling Record {rec.verdict.value}: {rec.notes}")
    done_total = rec.metrics["done_total"]
    agg_tps = rec.metrics["aggregate_tokens_per_s"]
    t0 = time.perf_counter()
    rec = _fleet_record(eng_mod, replica, mesh_mod, os.path.join(work, "a1"),
                        ranks=1, replicas=1, min_replica_speedup=0.0,
                        **FLEET_SCALING_CUT)
    row = _fleet_row(rec, "a_one_replica", t0)
    launched("a_one_replica", row)
    if rec.verdict.value != "SUCCESS":
        bad.append(f"one-replica Record {rec.verdict.value}: {rec.notes}")
    one_tps = rec.metrics["aggregate_tokens_per_s"]
    emit({"phase": "fleet", "leg": "a_speedup", "aggregate_tokens_per_s":
          agg_tps, "single_replica_tokens_per_s": one_tps,
          "replica_speedup": agg_tps / one_tps if one_tps > 0 else 0.0,
          "reference_gate": 1.8, "gated": False, "card": _smi()})
    ends["a_scaling"] = time.perf_counter() - t_phase

    # (e) obs fleet and obs journey over leg a's dir: the parent's dump
    # holds the routes of both of leg a's fleets, the replica dirs the
    # measured fleet's requests, so a served journey is one that retired
    rc, out, _ = _cli_in_process(["--obs-dir", obs_dir, "obs", "fleet"])
    merged, procs = obs_fleet.merge_fleet(obs_dir)
    served = {jid: [a["name"] for a in anchors]
              for jid, anchors in obs_fleet.journeys(merged).items()
              if any(a["name"] == "req.retired" for a in anchors)}
    # the replicas' retirements (the smoke's own engines retire into the
    # parent's ring too, untagged)
    retired = sum(1 for e in merged if e.get("replica")
                  and e.get("kind") == "span" and e["name"] == "req.retired")
    whole = all(names[0] == "journey.route" and names.count("req.retired")
                == 1 for names in served.values())
    jid = min(served) if served else "none"
    rc_j, out_j, _ = _cli_in_process(["--obs-dir", obs_dir, "obs",
                                      "journey", jid])
    emit({"phase": "fleet", "leg": "e_obs", "fleet_rc": rc,
          "journey_rc": rc_j, "processes": sorted(procs),
          "served_journeys": len(served), "merged_retired": retired,
          "record_done_total": done_total, "routed_then_retired": whole,
          "journey_rows": out_j.count("\n| ") - 1,
          "fleet_trace": os.path.exists(os.path.join(obs_dir,
                                                     "fleet_trace.json"))})
    if (rc or rc_j or len(served) != done_total or retired != done_total
            or not whole):
        bad.append(f"obs fleet: rc {rc}/{rc_j}, {len(served)} served "
                   f"journeys, {retired} retired against {done_total} done")
    ends["e_obs"] = time.perf_counter() - t_phase

    # (b) the routing comparison
    t0 = time.perf_counter()
    rec = _fleet_record(eng_mod, replica, mesh_mod, os.path.join(work, "b"),
                        replicas=2, scenario=FLEET_CHAT, time_scale=0.05)
    row = _fleet_row(rec, "b_routing", t0)
    launched("b_routing", row)
    m = rec.metrics
    if (rec.verdict.value != "SUCCESS" or not m["prefix_hit_blocks_prefix"]
            > m["prefix_hit_blocks_round_robin"]):
        bad.append(f"routing Record {rec.verdict.value}: {rec.notes}")
    ends["b_routing"] = time.perf_counter() - t_phase

    # (c) the store A/B under a kill
    fresh = {}
    for leg, store in (("c_base", ""),
                       ("c_store", os.path.join(work, "store"))):
        t0 = time.perf_counter()
        with _env(TPU_PATTERNS_FAULTS=FLEET_KILL,
                  TPU_PATTERNS_FAULTS_STATE=os.path.join(work,
                                                         leg + "-state")):
            rec = _fleet_record(
                eng_mod, replica, mesh_mod, os.path.join(work, leg),
                replicas=2, min_replica_speedup=0.0, prefix_share=True,
                kv_host_tier=True, prefix_store=store, **FLEET_KILL_CUT)
        row = _fleet_row(rec, leg, t0)
        launched(leg, row)
        m = rec.metrics
        fresh[leg] = m["rerouted_fresh_blocks"]
        if (rec.verdict.value != "WARNING" or m["covered"] != 1.0
                or m["exact"] != 1.0 or m["rerouted"] < 1
                or m["leaked_blocks"]):
            bad.append(f"{leg}: {rec.verdict.value} {rec.notes}")
    if not fresh["c_store"] < fresh["c_base"]:
        bad.append(f"store A/B: rerouted_fresh_blocks {fresh}")
    ends["c_store"] = time.perf_counter() - t_phase

    # (d) the elastic A/B
    t0 = time.perf_counter()
    rec = _fleet_record(eng_mod, replica, mesh_mod, os.path.join(work, "d"),
                        scenario=FLEET_RAMP, **FLEET_ELASTIC)
    row = _fleet_row(rec, "d_elastic", t0)
    launched("d_elastic", row)
    if rec.verdict.value != "SUCCESS" or rec.metrics["scale_outs"] < 1:
        bad.append(f"elastic Record {rec.verdict.value}: {rec.notes}")
    ends["d_elastic"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "fleet_phase", "seconds": time.perf_counter() - t_phase,
          "leg_end_s": ends, "k1_launches": launches, "card": _smi(),
          "cut": FLEET_CUT, "speedup_gate": FLEET_SPEEDUP_GATE,
          "earlier_cuts": {"serve_legs": SERVE_LEG_CUT,
                           "loadgen_depth": LOADGEN_WIDTH["depth"],
                           "decode_lm_mesh": DLM_CUT, "serve_mesh": SM_CUT},
          "scaling_policy": FLEET_SCALING_POLICY})
    if bad:
        raise AssertionError("fleet: " + " | ".join(bad))
    return launches


# phase 25: the port's rag preset (24 requests, prompts 48-96, 2-8
# generated), the traffic the split exists for, arrivals compressed
DISAGG_RAG = "rag"
DISAGG_TIME_SCALE = 0.05
# leg a's TTFT gate: off.  The reference smoke's 1.05
# (scripts/disagg_smoke.py, on hosts of 4 cores or more) is not met
# steadily on the one card: the split read 0.658, 0.260 and 1.190 in
# three calls (PERF.md §6), its one prefill replica prefilling every
# prompt and spooling it before the first token's op leaves, while the
# unified fleet prefills on both, and each host path sharing the host.
# The Record notes the gate is off; ttft_improvement is printed
DISAGG_TTFT_GATE = 0.0
# leg b: the reference's chaos case (h), prefill replica 0 killed at its
# first transfer, a shared fault-state dir; half the preset's requests
DISAGG_KILL = "disagg.transfer:kill:replica=0:count=1"
DISAGG_KILL_RAG = "rag:requests=12"
# leg c: the wire at the serve width, a 96-token prompt's window
DISAGG_STREAM = [*DIAG_PERF, "--max_prompt=96", "--include",
                 "disagg.stream"]


def _disagg_launches(rec, roles, bad, leg) -> dict:
    """K1's launches by replica of each leg, with its role: every decode
    child and every unified child launched K1, no prefill child did."""
    by = rec.config.get("paged_block_launches") or [{}, {}]
    out = {"disagg": {r: {"role": roles.get(r), "launches": v}
                      for r, v in by[0].items()},
           "unified": by[1]}
    wrong = ([r for r, v in by[0].items()
              if (v > 0) != (roles.get(r) == "decode")]
             + [r for r, v in by[1].items() if v <= 0])
    if len(by) != 2 or not by[1] or wrong:
        bad.append(f"{leg}: K1 launches by replica {out}")
    return out


def phase_disagg(torch):
    """Phase 25 (module docstring).  Returns K1's launches by leg,
    replica and role; raises if any part fails."""
    import glob
    import tempfile

    from tpu_patterns_torch.comm import mesh as mesh_mod
    from tpu_patterns_torch.perf import history
    from tpu_patterns_torch.serve import engine as eng_mod
    from tpu_patterns_torch.serve import replica

    t_phase = time.perf_counter()
    bad, launches, ends = [], {}, {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="disagg_", dir=os.path.join(ROOT,
                                                               "build"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # (a) the A/B: 1 prefill + 1 decode replica against 2 unified
    t0 = time.perf_counter()
    rec = _fleet_record(eng_mod, replica, mesh_mod, os.path.join(work, "a"),
                        replicas=2, disagg="1:1", scenario=DISAGG_RAG,
                        time_scale=DISAGG_TIME_SCALE,
                        min_ttft_improvement=DISAGG_TTFT_GATE)
    m = rec.metrics
    launches["a_ab"] = _disagg_launches(rec, replica.disagg_roles(1, 1),
                                        bad, "a_ab")
    emit({"phase": "disagg", "leg": "a_ab", "mode": rec.mode,
          "verdict": rec.verdict.value,
          "ttft_p99_ms_disagg": m["ttft_p99_ms_disagg"],
          "ttft_p99_ms_unified": m["ttft_p99_ms_unified"],
          "ttft_improvement": m["ttft_improvement"],
          "ttft_gate": DISAGG_TTFT_GATE, "transfers": m["transfers"],
          "transfer_bytes": m["transfer_bytes"],
          "transfer_bytes_per_transfer": (m["transfer_bytes"]
                                          / max(m["transfers"], 1)),
          "metrics": m, "k1_launches": launches["a_ab"],
          "notes": rec.notes, "seconds": time.perf_counter() - t0,
          "card": _smi()})
    if (rec.verdict.value != "SUCCESS" or m["transfers"] < 1
            or m["exact"] != 1.0 or m["leaked_blocks"]
            or m["recomputes"]):
        bad.append(f"disagg A/B {rec.verdict.value}: {rec.notes}")
    ends["a_ab"] = time.perf_counter() - t_phase

    # (b) chaos case (h): a prefill replica killed mid-transfer
    t0 = time.perf_counter()
    with _env(TPU_PATTERNS_FAULTS=DISAGG_KILL,
              TPU_PATTERNS_FAULTS_STATE=os.path.join(work, "b-state")):
        rec = _fleet_record(eng_mod, replica, mesh_mod,
                            os.path.join(work, "b"), ranks=3, replicas=3,
                            disagg="2:1", scenario=DISAGG_KILL_RAG,
                            time_scale=DISAGG_TIME_SCALE,
                            replica_policy="round_robin")
    m = rec.metrics
    tmp_left = glob.glob(os.path.join(work, "b", "**", "*.tmp"),
                         recursive=True)
    launches["b_kill"] = _disagg_launches(rec, replica.disagg_roles(2, 1),
                                          bad, "b_kill")
    emit({"phase": "disagg", "leg": "b_kill", "mode": rec.mode,
          "verdict": rec.verdict.value, "spec": DISAGG_KILL,
          "rerouted": m["rerouted"], "tmp_files_left": tmp_left,
          "metrics": m, "k1_launches": launches["b_kill"],
          "notes": rec.notes, "seconds": time.perf_counter() - t0,
          "card": _smi()})
    if (rec.verdict.value != "SUCCESS" or m["rerouted"] < 1 or tmp_left
            or m["exact"] != 1.0 or m["leaked_blocks"]
            or "0" in launches["b_kill"]["disagg"]):
        bad.append(f"disagg chaos (h) {rec.verdict.value}: rerouted "
                   f"{m['rerouted']}, tmp {tmp_left}, {rec.notes}")
    ends["b_kill"] = time.perf_counter() - t_phase

    # (c) the wire alone through `perf`
    t0 = time.perf_counter()
    perf_dir = os.path.join(work, "perf")
    rc, _, _ = _cli_in_process(["perf", "report", *DISAGG_STREAM,
                                "--perf-dir", perf_dir])
    (snap,) = history.load_history(perf_dir)
    wire = snap["executables"]["disagg.stream"]
    floor_ms = wire["transfer_bytes"] / 3.35e12 * 1e3
    row = {"phase": "disagg", "leg": "c_stream", "rc": rc,
           "card": snap["mesh"].get("card"), "ms": wire["step_ms"],
           "transfer_bytes": wire["transfer_bytes"],
           "gbps": wire["transfer_bytes"] / wire["step_ms"] / 1e6,
           "byte_floor_ms": floor_ms,
           "share_of_floor": floor_ms / wire["step_ms"],
           "achieved_gbps_of_hops": wire.get("achieved_gbps"),
           "seconds": time.perf_counter() - t0}
    emit(row)
    if rc or not wire["step_ms"] > 0 or "H100" not in (row["card"] or ""):
        bad.append(f"disagg.stream capture: {row}")
    ends["c_stream"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "disagg_phase", "seconds": time.perf_counter() - t_phase,
          "leg_end_s": ends, "k1_launches": launches, "card": _smi(),
          "ttft_gate": DISAGG_TTFT_GATE})
    if bad:
        raise AssertionError("disagg: " + " | ".join(bad))
    return launches


def profile_concurrency_main() -> int:
    """``python3 chip_smoke.py --profile-concurrency``, which the smoke
    runs in a process of its own: the xla concurrent "C C" run, the
    pallas dma_overlap "C D2D" run and the pallas ring allreduce at the
    defaults (4 ranks on the card), each under torch.profiler, and the
    device's idle share of each, 1 - the union of its busy intervals
    over the host's wall.  (In the smoke's own process, after the
    earlier phases, the profiles dropped a few kernel records a run.)
    Each run goes once unprofiled first, so that the profiled one finds
    the kernel libraries loaded, as the main path did.  A profile that
    lost kernel records (fewer than the launches) only bounds the idle
    share from above; such a run is profiled again, up to 3 times, and
    the line says which it has."""
    import torch

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, ROOT)
    from tpu_patterns_torch.concurrency import backends as cb
    from tpu_patterns_torch.concurrency import harness as ch
    from tpu_patterns_torch.concurrency import kernels as ck
    from tpu_patterns_torch.core.results import ResultWriter
    from tpu_patterns_torch.miniapps import framework as fw
    from tpu_patterns_torch.miniapps.apps.allreduce import pallas as ap

    def conc(**kw):
        return lambda: ch.run_concurrency(
            ch.ConcurrencyConfig(device=DEVICE, **kw),
            ResultWriter(stream=io.StringIO()))

    mesh = fw.default_mesh(AR_WORLD, DEVICE)
    # (line, its keys, the run, the kernel's name (the prefix of its
    # instances' names) and the wrapper that counts its launches)
    legs = (
        ("concurrency_profile", dict(mode="concurrent"),
         conc(mode="concurrent"), "busy_wait", ck.busy_wait),
        ("concurrency_profile",
         dict(backend="pallas", mode="dma_overlap", commands=("C D2D",)),
         conc(backend="pallas", mode="dma_overlap", commands=("C D2D",)),
         "dma_compute", cb.dma_compute),
        ("allreduce_profile",
         dict(variant="pallas", algorithm="ring", world=AR_WORLD),
         lambda: fw.get_variant("allreduce", "pallas").run(
             mesh=mesh, writer=ResultWriter(stream=io.StringIO())),
         "accumulate", ap.accumulate),
    )
    for phase, kw, run, kname, wrapper in legs:
        run()
        recorded_by_attempt = []
        for _ in range(3):
            wrapper.launches = 0
            wall, by_name, busy, calls, first_ms = _device_time_s(torch, run)
            launched = wrapper.launches
            recorded_by_attempt.append(sum(
                n for k, n in calls.items()
                if re.search(kname + r"\w*_kernel", k)))
            if recorded_by_attempt[-1] == launched:
                break
        complete = recorded_by_attempt[-1] == launched
        emit({"phase": phase, **kw, "wall_s": wall,
              "device_busy_s": busy,
              "device_idle_share": 1 - busy / wall if complete else None,
              "device_idle_share_at_most": 1 - busy / wall,
              "device_time_sum_s": sum(by_name.values()),
              "launches": {kname: launched},
              "kernel_records_by_attempt": recorded_by_attempt,
              "profile_complete": complete, "first_record_ms": first_ms,
              "by_name_s": by_name, "calls_by_name": calls})
    return 0


# the timing phases ``--tree`` runs with another checkout's package
TREE_PHASES = ("put_time", "ring_put_time", "accumulate_time",
               "allreduce", "add_one_time", "parallel", "model_mesh",
               "decode_lm_mesh", "serve_mesh", "fleet", "disagg")
# phases ``--tree`` runs only when named: phases 14-19 on their own,
# phase 16's leg e again and again (``kv_race``: its spread), phase 5's
# bf16 serve leg (a tree's serve tokens/s and ids against another's),
# phase 19's f32 kernel times with the f32 legs' TFLOP/s
# (``flash_f32_time``) and phase 3's K1 times (``k1_time``)
TREE_ONLY_NAMED = ("loadgen", "decode_lm", "kv_tier", "kv_race",
                   "recovery", "diagnostics", "serve", "longctx",
                   "flash_f32_time", "k1_time")


def tree_main(tree: str, phases: list[str]) -> int:
    """``python3 chip_smoke.py --tree TREE [PHASE ...]``: the named
    phases of :data:`TREE_PHASES` (default: all) or
    :data:`TREE_ONLY_NAMED` with the package and
    kernels of the checkout at TREE (this one, or another unpacked under
    it), in a process of its own, so that two trees compare on one card
    in one call (run parent, change, change, parent).  Prints the card's
    name and power limit, a ``tree`` line (the package's path), then
    each phase's lines as the smoke prints them."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    unknown = set(phases) - set(TREE_PHASES) - set(TREE_ONLY_NAMED)
    if unknown:
        print(f"chip_smoke: no tree phase {sorted(unknown)}; "
              f"choose from {TREE_PHASES + TREE_ONLY_NAMED}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(tree))
    from tpu_patterns_torch.comm import onesided as op
    from tpu_patterns_torch.concurrency import backends as cb
    from tpu_patterns_torch.concurrency import kernels as ck
    from tpu_patterns_torch.core import timing
    from tpu_patterns_torch.interop import kernel as k10
    from tpu_patterns_torch.kernels import build
    from tpu_patterns_torch.longctx import flash as F
    from tpu_patterns_torch.miniapps import framework as fw
    from tpu_patterns_torch.miniapps.apps import allreduce as ar
    from tpu_patterns_torch.miniapps.apps.allreduce import pallas as ap
    from tpu_patterns_torch.runtime import match_device_spec
    from tpu_patterns_torch.serve import engine as eng_mod
    from tpu_patterns_torch.serve import paged_kernel as pk

    spec = match_device_spec(torch.cuda.get_device_name(0))
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]
    emit(smi)
    emit({"phase": "tree", "tree": tree, "card": smi,
          "package": os.path.dirname(os.path.dirname(
              os.path.abspath(op.__file__)))})
    doctor = (diag_doctor_start() if "diagnostics" in phases else None)
    try:
        libs = build.build_all()
    finally:
        if doctor is not None:
            doctor = diag_doctor_wait(doctor)
    run = {"put_time": lambda: phase_put_time(torch, op, ck, cb, timing,
                                              spec),
           "ring_put_time": lambda: phase_ring_put_time(
               torch, op, ck, timing, spec, fw),
           "accumulate_time": lambda: phase_accumulate_time(
               torch, ap, ck, timing, spec),
           "allreduce": lambda: phase_allreduce(torch, ap, ar, fw),
           "add_one_time": lambda: phase_add_one_time(torch, k10, ck,
                                                      timing, spec),
           "loadgen": lambda: phase_loadgen(torch, pk, timing),
           "decode_lm": lambda: phase_decode_lm(torch, pk, F, timing, spec),
           "kv_tier": lambda: phase_kv_tier(torch, pk),
           "kv_race": lambda: phase_kv_race(torch, pk),
           "recovery": lambda: phase_recovery(torch, pk),
           "diagnostics": lambda: phase_diagnostics(torch, pk, F, doctor),
           "longctx": lambda: phase_longctx(torch, pk, F, timing, spec),
           "parallel": lambda: phase_parallel(torch),
           "model_mesh": lambda: phase_model_mesh(torch, F),
           "decode_lm_mesh": lambda: phase_decode_lm_mesh(torch, pk, F),
           "serve_mesh": lambda: phase_serve_mesh(torch, pk, timing, spec),
           "fleet": lambda: phase_fleet(torch),
           "disagg": lambda: phase_disagg(torch),
           "flash_f32_time": lambda: phase_flash_f32_time(
               torch, F, timing, spec, libs),
           "k1_time": lambda: k1_times(torch, pk, timing, spec, slice_case(
               torch, seed=17, kind="bf16", w=1, h=8, hkv=8)),
           "serve": lambda: serve_leg(torch, eng_mod, "bf16",
                                      eng_mod.ServeConfig(
                                          **FULL_WIDTH, dtype="bfloat16",
                                          requests=16))}
    for name in phases or TREE_PHASES:
        run[name]()
    return 0


def phase_kernel_build(torch, libs, F, op, pk):
    """The redesigned kernels as built: each instance's registers,
    spills and static shared memory from ``-Xptxas -v``, whether ptxas
    serialized its wgmma products, and the dynamic shared memory it
    launches with (the wgmma kernels' from their library, the puts' at
    the full buffer on this card, with their blocks and span; K5 uses
    none).  A backward instance that spills
    or whose products ptxas serialized fails."""
    report = {}
    for lib, prefixes in REDESIGNED_LIBS.items():
        for prefix in prefixes:
            report.update(ptxas_report(
                libs[lib].with_suffix(".log").read_text(), prefix))
    lib_f = F._library("flash_attention")
    lib_b = F._library("flash_attention_bwd")
    for name, row in report.items():
        t = re.search(r"D=(\d+),BK=(\d+),NC=(\d+)", name)
        if t:
            d, bk, nc = map(int, t.groups())
            row["dynamic_smem"] = lib_f.flash_fwd_smem_bytes(2, 64 * nc, bk,
                                                             d)
        t = FWD_F32.fullmatch(name)
        if t:
            d, rt = int(t.group(1)), int(t.group(2))  # tile (8 RT, D)
            row["dynamic_smem"] = lib_f.flash_fwd_smem_bytes(4, 8 * rt, d, d)
        t = BWD_WGMMA.fullmatch(name)
        if t:
            which = int(t.group(1) == "dkv")
            d, nc = int(t.group(2)), int(t.group(3))
            tiles = ((F.BWD_STREAM, 64 * nc) if which
                     else (64 * nc, F.BWD_STREAM))
            row["dynamic_smem"] = lib_b.flash_bwd_smem_bytes(which, 2,
                                                             *tiles, d)
        t = BWD_F32.fullmatch(name)
        if t:
            which = int(t.group(1) == "dkv")
            d, own = int(t.group(2)), int(t.group(3))
            tiles = (own, 64 if own == 64 else d)  # dq's (bq, bk)
            row["dynamic_smem"] = lib_b.flash_bwd_smem_bytes(
                which, 4, *(tiles[::-1] if which else tiles), d)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = PUT_FULL[0] * PUT_FULL[1] * 4
    span = op.mono_span(n, sms)
    # bulk_copy.cuh: 128 B of mbarriers and two stages of the span
    report["local_put_mono_kernel"].update(
        dynamic_smem=128 + 2 * min(span, op.STAGE_BYTES),
        blocks=-(-n // span), span_bytes=span)
    span = op.multi_span(n // 8, 8, sms)
    report["local_put_multi_kernel"].update(
        dynamic_smem=128 + 2 * min(span, op.STAGE_BYTES),
        blocks=len(op.multi_spans(n // 8, 8, sms)), span_bytes=span)
    # stream_copy.cuh: no shared memory, one block a tile or piece
    report["local_put_streamed_kernel"].update(
        dynamic_smem=0, blocks=len(op.streamed_pieces(
            PUT_FULL[0], PUT_FULL[1] * 4, 1024)), piece_bytes=op.STREAM_STEP,
        tile_bytes=op.streamed_block_rows(PUT_FULL[0], PUT_FULL[1] * 4, 1024)
        * PUT_FULL[1] * 4)
    report["ring_put_kernel"].update(
        dynamic_smem=0, blocks=len(op.ring_put_pieces(n)),
        piece_bytes=op.STREAM_STEP)
    n_chunks, _, half = op._inplace_plan(PUT_FULL[0], 8)
    span = op.multi_span(half * PUT_FULL[1] * 4, n_chunks, sms)
    report["local_put_inplace_kernel"].update(
        dynamic_smem=128 + 2 * min(span, op.STAGE_BYTES),
        blocks=len(op.inplace_spans(PUT_FULL[0], PUT_FULL[1] * 4, 8, sms)),
        span_bytes=span)
    # K1 at the serve shape (bf16, G*W 1, D 128, 16 slots a page)
    pps = pk.split_pages(36, 16, 8, 8, 256, sms)
    lib_p = pk._library()
    for name, row in report.items():
        t = re.fullmatch(r"paged_attention_split_kernel<Q=(\d),KV=(\d),"
                         r"D=(\d+),STRIPED=0>", name)
        if t and t.groups() == ("1", "1", "128"):
            row.update(dynamic_smem=lib_p.paged_attention_smem_bytes(
                1, 128, 1, 16, pps, min(pps, pk.stage_pages(16, 256))),
                pages_per_split=pps,
                blocks=8 * 8 * -(-36 // pps))
    # K10: no shared memory, one block a tile of the stream
    from tpu_patterns_torch.interop import kernel as k10

    for name in ("add_one_vec_kernel", "add_one_scalar_kernel"):
        report[name].update(
            dynamic_smem=0, threads=k10.THREADS, vectors=k10.VECS,
            blocks_at_2_25=k10.tile_grid(K10_FULL,
                                         name == "add_one_vec_kernel"))
    emit({"phase": "kernel_build", "kernels": report})
    bwd = {n: r for n, r in report.items() if BWD_WGMMA.fullmatch(n)}
    bad = [n for n, r in bwd.items() if r.get("spill_stores")
           or r.get("spill_loads") or r["wgmma_serialized"]]
    if len(bwd) != 8 or bad:
        raise AssertionError(f"bf16 backward build: {len(bwd)} of 8 "
                             f"instances reported; spilled or serialized: "
                             f"{bad}")
    for what, pattern, want in (("forward", FWD_F32, 4),
                                ("backward", BWD_F32, 8)):
        f32 = {n: r for n, r in report.items() if pattern.fullmatch(n)}
        bad = [n for n, r in f32.items() if r.get("spill_stores")
               or r.get("spill_loads")]
        if len(f32) != want or bad:
            raise AssertionError(f"f32 {what} build: {len(f32)} of {want} "
                                 f"instances reported; spilled: {bad}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tpu_patterns_torch.comm import onesided as op
    from tpu_patterns_torch.comm import ring
    from tpu_patterns_torch.concurrency import backends as cb
    from tpu_patterns_torch.concurrency import commands as cc
    from tpu_patterns_torch.concurrency import harness as ch
    from tpu_patterns_torch.concurrency import kernels as ck
    from tpu_patterns_torch.core import timing
    from tpu_patterns_torch.interop import calls, native
    from tpu_patterns_torch.interop import kernel as k10
    from tpu_patterns_torch.kernels import build
    from tpu_patterns_torch.longctx import flash as F
    from tpu_patterns_torch.longctx import tuning
    from tpu_patterns_torch.miniapps import framework as fw
    from tpu_patterns_torch.miniapps.apps import allreduce as ar
    from tpu_patterns_torch.miniapps.apps.allreduce import pallas as ap
    from tpu_patterns_torch import ckpt as tc
    from tpu_patterns_torch import faults
    from tpu_patterns_torch.models import flagship as fl
    from tpu_patterns_torch.models import train_loop as tl
    from tpu_patterns_torch.models import transformer as tr
    from tpu_patterns_torch.runtime import match_device_spec
    from tpu_patterns_torch.serve import engine as eng_mod
    from tpu_patterns_torch.serve import paged_kernel as pk

    kind = torch.cuda.get_device_name(0)
    spec = match_device_spec(kind)
    if spec is None:
        raise RuntimeError(f"no datasheet entry for {kind!r}")
    t_main = time.perf_counter()

    def mark(after: str) -> None:
        """The smoke's clock: seconds since its start, after a phase."""
        emit({"phase": "clock", "after": after,
              "seconds": time.perf_counter() - t_main})

    nvcc_line = next(
        (ln.strip() for ln in _run([build.find_nvcc(), "--version"])
         .splitlines() if "release" in ln), "?"
    )
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_line, "name": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi})
    emit(smi)

    doctor = diag_doctor_start()
    try:
        t0 = time.perf_counter()
        libs = build.build_all()
        build_s = time.perf_counter() - t0
        ptxas = []
        for lib in libs.values():
            log = lib.with_suffix(".log")
            if log.exists():
                ptxas += [ln.strip() for ln in log.read_text().splitlines()
                          if "registers" in ln or "spill" in ln][:8]
        emit({"phase": "build", "seconds": build_s,
              "libs": {n: os.path.relpath(p, ROOT) for n, p in libs.items()},
              "ptxas": ptxas, "beside": "the pre-flight doctor"})
        phase_kernel_build(torch, libs, F, op, pk)
    finally:
        doctor = diag_doctor_wait(doctor)

    kres, ktime, klong = phase_kernels(torch, pk, timing, spec)
    mark("build_and_kernels")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions
    flash_err, inputs, fwd_t, bwd_t = phase_flash_kernels(torch, F, tuning)
    ftime = phase_flash_time(torch, F, timing, spec, inputs, fwd_t, bwd_t)
    del inputs
    mark("flash")

    base = eng_mod.ServeConfig(**FULL_WIDTH, dtype="bfloat16", requests=16)
    main_leg = serve_leg(torch, eng_mod, "bf16", base)
    phase_profile(torch, eng_mod, timing, base,
                  sum(r.n_gen for r in eng_mod.random_trace(base))
                  / main_leg["tokens_per_s"])
    cut = dataclasses.replace(base, **SERVE_LEG_CUT)
    serve_leg(torch, eng_mod, "gqa2_int8",
              dataclasses.replace(cut, kv_heads=2, cache_int8=True),
              gate_flips=False)
    spec_leg = serve_spec_leg(torch, eng_mod, pk,
                              dataclasses.replace(cut, spec_k=SPEC_K))
    serve_prefix_leg(torch, eng_mod, pk, dataclasses.replace(
        cut, prefix_share=True, shared_prefix=SHARED_PREFIX))
    mark("serve")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "exact_f32", "matmul.allow_tf32":
          torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})
    recs = eng_mod.run_serve(dataclasses.replace(
        cut, dtype="float32", spec_k=SPEC_K, prefix_share=True))
    for rec in recs:
        emit({"phase": "exact_f32", "mode": rec.mode,
              "verdict": rec.verdict.value, "metrics": rec.metrics,
              "notes": rec.notes})
    modes = [r.mode for r in recs]
    if (len(recs) != 3 or not modes[1].startswith("prefix_share_")
            or not modes[2].startswith("spec_decode_")):
        raise AssertionError(f"float32 run_serve Records: {modes}")
    for rec in recs:
        if rec.metrics["exact"] != 1.0 or not rec.verdict:
            raise AssertionError(f"float32 serve Record {rec.mode} failed: "
                                 + "; ".join(rec.notes))

    flag = phase_flagship(torch, F, fl)
    phase_flagship_profile(torch, timing, fl, tr,
                           flag["kernel"]["step_ms"] / 1e3)
    no_grad_launches = phase_flagship_exact(torch, F, fl, tr)
    train_launches = phase_train_loop(torch, F, tl, faults, tc,
                                      flag["kernel"]["step_ms"])
    mark("flagship_and_train_loop")

    phase_put_vs_plain(torch, op)
    ptime = phase_put_time(torch, op, ck, cb, timing, spec)
    puts = phase_onesided(torch, op)
    phase_busy_wait_vs_plain(torch, ck)
    phase_dma_compute_vs_plain(torch, cb)
    conc_launches, k7_tuned = phase_concurrency(torch, ck, cb, cc, ch)
    busy_plain_ms, k7_plain_ms = phase_main_path_vs_plain(torch, ck, cb, cc,
                                                          k7_tuned)
    conc_time = phase_concurrency_time(
        torch, ck, cb, cc, ch, timing, spec, busy_plain_ms,
        k7_tuned["defaults dma_overlap"], k7_plain_ms["defaults dma_overlap"],
        k7_tuned["balanced dma_overlap"])
    mark("put_and_concurrency")

    phase_accumulate_vs_plain(torch, ap, cc)
    acc_times = phase_accumulate_time(torch, ap, ck, timing, spec)
    acc_launches = phase_allreduce(torch, ap, ar, fw)
    phase_allreduce_vs_plain(torch, ap, ring, fw)
    phase_ring_put_vs_plain(torch, op, fw)
    rp_time = phase_ring_put_time(torch, op, ck, timing, spec, fw)
    rp_launches = phase_onesided_ring(torch, op, fw)
    phase_ring_cli()
    phase_native_build(native)
    phase_add_one_vs_plain(torch, k10, cc, calls)
    k10_launches = phase_interop_proof(torch, k10, calls, native, cc)
    phase_interop_cli()
    k10_time = phase_add_one_time(torch, k10, ck, timing, spec)
    mark("ring_and_interop")
    phase_p2p_suite(torch, spec)
    mark("p2p_suite")
    loadgen_launches = phase_loadgen(torch, pk, timing)
    mark("loadgen")
    decode_lm_launches = phase_decode_lm(torch, pk, F, timing, spec)
    mark("decode_lm")
    kv_tier_launches = phase_kv_tier(torch, pk)
    mark("kv_tier")
    recovery_launches = phase_recovery(torch, pk)
    mark("recovery")
    diagnostics_launches = phase_diagnostics(torch, pk, F, doctor)
    mark("diagnostics")
    longctx_launches, lc_f32, lc_err = phase_longctx(torch, pk, F, timing,
                                                     spec)
    mark("longctx")
    phase_parallel(torch)
    mark("parallel")
    mesh_launches = phase_model_mesh(torch, F)
    mark("model_mesh")
    dlm_mesh_launches = phase_decode_lm_mesh(torch, pk, F)
    mark("decode_lm_mesh")
    sm_launches, sm_stripes, sm_times = phase_serve_mesh(torch, pk, timing,
                                                         spec)
    mark("serve_mesh")
    fleet_launches = phase_fleet(torch)
    mark("fleet")
    disagg_launches = phase_disagg(torch)
    mark("disagg")

    rows = {**ftime, **ptime, "paged_attention": {
        "ms": ktime["kernel"]["ms"], "bound_ms": ktime["bound_ms"],
        "library_ms": ktime["library_sdpa"]["ms"]},
        "accumulate n=2^23": acc_times[AR_FULL // AR_WORLD],
        "accumulate n=2^25": acc_times[AR_FULL], "ring_put": rp_time,
        "add_one": k10_time}
    emit({"phase": "redesign", "card": smi,
          "note": "ms_before: PERF.md's kernel table before the redesign "
          "(this script, same card and power limit); paged_attention's "
          "library is SDPA on the gathered window; accumulate's ms holds "
          "the host's time per call (device_ms in accumulate_time); "
          "add_one's at 2^25, L2 flushed",
          **{name: {"ms": rows[name]["ms"], "ms_before": before,
                    "speedup": before / rows[name]["ms"],
                    "library_ms": rows[name]["library_ms"],
                    "bound_ms": rows[name]["bound_ms"],
                    "over_library": rows[name]["ms"]
                    / rows[name]["library_ms"]}
             for name, before in REDESIGNED_BEFORE_MS.items()},
          "f32": {name: {"ms": lc_f32[name]["ms"], "ms_before": before,
                         "speedup": before / lc_f32[name]["ms"],
                         "library_ms": lc_f32[name]["library_ms"],
                         "bound_ms": lc_f32[name]["bound_ms"]}
                  for name, before in F32_BEFORE_MS.items()}})

    # launches: K1 in the timed serve run, K3 and K4 in the flagship
    # run, K2 in the no-grad forward (each count set to 0 just before)
    launches = {**flag["kernel"]["launches"],
                "flash_attention": no_grad_launches["flash_attention"]}
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "tpu_patterns_torch/serve/csrc/paged_attention.cu",
        "replaces": "tpu_patterns/serve/paged_kernel.py:93",
        "launches": main_leg["kernel_launches"],
        "max_abs_err": kres["max_abs_err"],
        "ms": ktime["kernel"]["ms"],
        "plain_ms": ktime["plain"]["ms"],
        "bound_ms": ktime["bound_ms"],
        "bound_by": ktime["bound_by"],
        "library_ms": ktime["library_sdpa"]["ms"],
        "ms_min": ktime["kernel"]["min"], "ms_max": ktime["kernel"]["max"],
        "library_gather_sdpa_ms": ktime["library_gather_sdpa"]["ms"],
        "long_window_ms": klong["kernel"]["ms"],
        "long_window_share_of_bound": klong["share_of_bound"],
        "verify_launches": spec_leg["kernel_launches"],
        "loadgen_launches": loadgen_launches,
        "decode_lm_launches": decode_lm_launches["paged_attention"],
        "decode_lm_mesh_launches": dlm_mesh_launches["paged_attention"],
        "serve_mesh_launches": sm_launches,
        "stripes_max_abs_err": sm_stripes["max_abs_err"],
        "stripes_combine_rel_err": sm_stripes["combine_rel_err"],
        "stripe_ms": {k: v["ms"] for k, v in sm_times.items()},
        "stripe_bound_ms": {k: v["bound_ms"] for k, v in sm_times.items()},
        "kv_tier_launches": kv_tier_launches,
        "recovery_launches": recovery_launches,
        "diagnostics_launches": diagnostics_launches["paged_attention"],
        "fleet_launches": fleet_launches,
        "disagg_launches": disagg_launches,
    }]
    for kname, (source, replaces) in FLASH_KERNELS.items():
        row = ftime[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": flash_err[kname], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "train_loop_launches": train_launches[kname],
            "decode_lm_launches": decode_lm_launches[kname],
            "decode_lm_mesh_launches": dlm_mesh_launches[kname],
            "diagnostics_launches": diagnostics_launches[kname],
            "longctx_launches": {leg: got[kname] for leg, got
                                 in longctx_launches.items()},
            "longctx_ring_shard_max_abs_err": lc_err[kname],
            "model_mesh_launches": {leg: got[kname] for leg, got
                                    in mesh_launches.items()},
            "longctx_f32": {shape: row for shape, row in lc_f32.items()
                            if shape.split()[0] == kname},
        })
    # launches: mono in its run_onesided call, the others in auto's
    for kname, replaces in PUT_KERNELS.items():
        row = ptime[kname]
        run = puts["mono" if kname == "local_put" else "auto"]
        kernels.append({
            "name": kname, "route": "cuda", "source": PUT_SOURCE,
            "replaces": replaces, "launches": run["launches"][kname],
            "max_abs_err": 0.0, "bit_exact": True, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "library_device_ms": row["library_device_ms"],
        })
    # launches: K6 in the xla concurrent "C C" run, K7 in the pallas
    # dma_overlap "C D2D" run, both at the defaults; K7's times are at
    # that run's tuned commands
    for (kname, (source, replaces)), row in zip(CONC_KERNELS.items(),
                                                conc_time):
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": conc_launches[kname],
            "max_abs_err": 0.0, "bit_exact": True, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "chain_floor_ms": row["chain_floor_ms"],
        })
    # launches: K5 in the pallas ring allreduce at the defaults (float32,
    # device memory), K9 in run_onesided over 4 ranks; K5's times at the
    # ring's 2^25-element shard (with its device-only ms and host us per
    # call there and at the 2^23 chunk), K9's per launch at the 188.7 MB
    # shard
    for (kname, (source, replaces)), launched, row in zip(
            RING_KERNELS.items(), (acc_launches, rp_launches),
            (acc_times[AR_FULL], rp_time)):
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": 0.0, "bit_exact": True, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    chunk = acc_times[AR_FULL // AR_WORLD]
    next(k for k in kernels if k["name"] == "accumulate").update({
        "device_ms": acc_times[AR_FULL]["device_ms"],
        "host_us_per_call": acc_times[AR_FULL]["host_us_per_call"],
        "library_device_ms": acc_times[AR_FULL]["library_device_ms"],
        "ms_2^23": chunk["ms"], "device_ms_2^23": chunk["device_ms"],
        "host_us_per_call_2^23": chunk["host_us_per_call"],
        "library_ms_2^23": chunk["library_ms"],
        "library_device_ms_2^23": chunk["library_device_ms"],
        "bound_ms_2^23": chunk["bound_ms"]})
    next(k for k in kernels if k["name"] == "ring_put").update(
        device_ms=rp_time["device_ms"],
        library_device_ms=rp_time["library_device_ms"])
    # launches: K10 on the interop proof path (managed memory, offload,
    # host_checksum compiled); its times at 2^25 float32
    source, replaces = INTEROP_KERNEL
    kernels.append({
        "name": "add_one", "route": "cuda", "source": source,
        "replaces": replaces, "launches": k10_launches,
        "max_abs_err": 0.0, "bit_exact": True, "ms": k10_time["ms"],
        "plain_ms": k10_time["plain_ms"], "bound_ms": k10_time["bound_ms"],
        "bound_by": k10_time["bound_by"],
        "library_ms": k10_time["library_ms"],
        "device_ms": k10_time["device_ms"],
        "library_device_ms": k10_time["library_device_ms"],
        "host_us_per_call": k10_time["host_us_per_call"],
    })
    # the card's name and power limit again, beside the numbers, where a
    # tail of the output still holds them
    emit(_run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).strip().splitlines()[0])
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-concurrency"]:
        sys.exit(profile_concurrency_main())
    if sys.argv[1:2] == ["--tree"] and len(sys.argv) >= 3:
        sys.exit(tree_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
