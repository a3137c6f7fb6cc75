#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --moe-prefill   # paths 15-17's prefill alone
    python3 chip_smoke.py --flash-bwd     # the flash backward and path 21
    python3 chip_smoke.py --launch        # path 21, paths 22-23, path 12's
                                          # scenario-mesh walks

Builds the port's CUDA kernels from ``src/repro_torch/csrc/`` and runs,
each phase failing the script on error:

1. the card: ``nvidia-smi`` name and power limit, and the build time;
2. every kernel against its plain PyTorch version on the card, at the
   shapes of the paths, with the kernel, plain-version and (where one
   PyTorch call computes the same function) library times;
3. four paths at full width — the paper's scale (1200 shards x 50,
   K = 100 devices, the CNN), DAS with the ``fused_pgd`` allocator and
   kernel FedAvg, through ``run_federated`` (path 4 through
   ``events.run_events``, which ``run_federated`` calls for an event
   config, to read the server buffer's log), each with the kernel launch
   counts of its run checked, its warm wall time per round and its host
   syncs:
   - path 1, the synchronous round with every subsystem off, 3 rounds;
   - path 2, streaming data (Poisson arrivals, kernel refresh, staleness
     weight 0.25) and unreliable uplinks (outages with retries,
     stragglers, the reliability EMA, overprovisioning), 3 rounds;
   - path 3, path 2 with 8-bit ``quant`` compressed uplinks, 3 rounds,
     then one round of ``topk``;
   - path 4, path 2 as the event-driven asynchronous driver: diurnal
     availability, a buffer of 2, staleness decay 0.5, ticks of half
     path 1's median round time, a binding dispatch cap of 16 and the
     bf16 carry, 6 events; the event loop must add no host sync beyond
     the DAS convergence tests;
4. path 5, the synchronous limit on the card: path 2 with
   ``EventConfig()`` equal to path 2's run, parameters bit for bit, with
   deterministic algorithms switched on for this phase only;
5. one more full-width round of paths 1-3, and path 4's events, under
   ``torch.profiler``: time by phase, the top kernels, the device's busy
   share;
6. each path at K = 16 on the card and on the CPU from one random tape
   with TF32 off (path 3 with ``topk``, path 4 with a cap of 4): equal
   selections, DAS iteration and delivered counts (path 4: and flushes),
   the same Sub2 objective, close parameters;
7. path 6, the model zoo's serving path at full width: h2o-danube-3-4b
   (24 layers, d_model 3840, 32 heads over 8 KV heads of 120, a 4096
   sliding window) with random weights from a seeded generator, bf16
   compute: B = 4, a 5000-token prompt, one prefill and 32 greedy
   decode steps through ``transformer.prefill`` / ``decode_step``, every
   attention layer through the ``flash_attention`` kernel (24 x 33
   launches); prefill cold and warm, decode ms per step, peak memory,
   the profiled idle share of a decode step and the kernel's share of
   device time; decode parity against ``forward`` at the last position;
8. the four dense configurations at ``reduced()`` on the card and on the
   CPU (f32, TF32 off): prefill and 3 decode steps, logits within 1e-4;
9. the batch paths, S = 16 scenarios of K = 100 (each scenario its own
   network and tape from its global index) through
   ``run_federated_batch``, 3 rounds each: path 7 path 1's config, path
   8 path 2's with a dispatch cap of 16 and the bf16 carry, path 9 path
   3's 8-bit ``quant``.  Each checks that every kernel launched as often
   as in its single path's round (``sub2_pgd`` once per outer iteration
   of the slowest lane), prints the warm wall per batch round and per
   scenario-round beside its single path's per round from the same call,
   the launches per batch round by route, the peak memory, and the host
   syncs of a 1-round batch at S = 16 against S = 1 (only the DAS test's
   line may count more); one batch round of each is profiled (phase 5),
   and each runs at K = 16, S = 3 on the card and on the CPU from one
   tape (``draw_tapes``; path 9 with topk, path 8 with a cap of 4):
   per scenario equal selections, delivered and dropped counts, equal
   DAS iterations unless the two runs part at a convergence test decided
   by the allocation alone within ``sub2_pgd``'s tolerance against its
   plain version (``explain_iterations`` prints the numbers), the same
   Sub2 objective (not on path 8, whose binding cap re-prices the round,
   as for path 4 in phase 6), parameters within 5e-3
   (``BATCH_CARD_CPU_PARAM_TOL``: a CNN near-tie in this world);
10. path 10, the event batch: S = 16 scenarios of path 4's config (6
    events, its ticks, a cap of 16, the bf16 carry) through
    ``run_federated_batch``, checked as the batch paths are (every kernel
    as often as in path 4's run: ``fedavg_agg_stale`` once an event for
    all scenarios; wall per event and per scenario-event beside path 4's;
    peak memory; the host syncs of a 1-event batch at S = 16 and S = 1),
    then once more with telemetry on through ``events.run_events``: the
    same records, the event leaves ``(S, E, K)``, the frames' flushes the
    buffer log's, a stale flush and a binding cap.  One batched event is
    profiled in phase 5, and K = 16, S = 3 with a cap of 4 and telemetry
    on runs on the card and on the CPU: per scenario equal selections,
    delivered and dropped counts and flushes, DAS iterations as above,
    parameters within 5e-3 (the bf16 carry's rounding of pending updates
    compounds over the events; with an f32 carry, also run, within
    1e-4), the event frame's masks equal and its clock within 1e-4;
11. path 11, telemetry: path 2 with ``TelemetryConfig()`` (every group
    on), 3 rounds: under deterministic algorithms parameters and records
    bit for bit path 2's run beside it, no host sync beyond path 2's in
    a 1-round run, every frame leaf finite and ``(R, K)`` or ``(R,)``,
    the warm wall on over off in turns printed, and a JSONL log
    (``build/telemetry/path11.jsonl``, written by
    ``sinks.write_round_frames``) that ``python -m
    repro_torch.telemetry.report`` renders with exit code 0;
12. path 12, a resumable Monte-Carlo sweep (``repro_torch.sweep``):
    path 7's world and config with ``Axis("sched", "method", ("das",
    "random"))`` under common random numbers, 16 scenarios a point in
    chunks of 8 (4 chunks, base seed 0), each chunk one
    ``run_federated_batch`` call.  The chunk walk (each chunk's networks
    and seeds from ``engine.stream_bases``, its batch call and the
    engine's fold) runs twice (first, warm): every chunk's launches as
    ``expected_batch_counts`` says for its point at S = 8 (random: one
    ``sub2_pgd`` a round), its wall per chunk round and per scenario
    round beside path 7's from this call, and its peak memory, the last
    chunk's within 1% of the first's.  Each point's aggregate is held
    against one ``run_federated_batch`` call on the same 16 networks and
    seeds folded on the host in float64: the same selections and DAS
    iterations, the counts equal, round time and energy within rel 1e-3
    (``sub2_pgd``'s card tolerance on the objective), accuracy within
    5e-3 (``BATCH_CARD_CPU_PARAM_TOL``); the largest difference of each
    is printed.  The scenario-round with the largest round-time gap runs
    again alone (S = 1), in its chunk and in the batch, each printed
    with its allocation after every DAS outer iteration and, where they
    part, that solve's inputs solved again on 1, 8 and 16 rows.  It
    prints the host syncs of one ``SweepEngine.run_chunk`` against the
    batch call on the same 8 scenarios (the fold adds none) and of the
    checkpoint and the JSONL line (one copy each), the checkpoint's size
    and its save and load times, and under deterministic algorithms runs
    ``SweepRunner.run`` uninterrupted (its launches, counted from zero
    just before it, the chunk walk's) and stops a runner after one chunk
    (``max_chunks=1``, checkpoint under ``build/sweep/``) and resumes it
    with a new engine: summaries bit for bit the uninterrupted run's,
    the JSONL one line a chunk, cursors 1-4.  Then the sweep through the
    engine's own chunks on two scenario meshes (``launch.mesh``): the
    card's one-device mesh, whose summaries equal the unsharded walk's
    bit for bit (the same call), and two entries over the same card,
    each chunk of 8 run as 4 + 4, held at the limits above (the counts
    equal, the objective within rel 1e-3, accuracy within 5e-3); the
    wall of each walk is printed;
13. path 14, xlstm-125m served at its published width and depth (12
    layers alternating sLSTM / mLSTM, d_model 768, 162,317,616
    parameters, seeded random bf16 weights): B = 4, a 2048-token prompt
    (8 mLSTM chunks of 256, the state carried), 32 greedy decode steps
    through ``transformer.prefill`` / ``decode_step``; prefill cold and
    warm, decode ms a step, peak memory, a profiled decode step's idle
    share, no port kernel launched (xLSTM has no attention), and decode
    parity against ``forward`` within 2e-2;
14. path 13, the federated trainer on the same model: ``launch.train``'s
    clients (DAS with ``n_min`` 2) and ``driver_batch`` with
    ``launch.steps.make_federated_train_step``, K = 8 clients, a global
    batch of 64 x 512 tokens, AdamW (lr 3e-4, warmup 10), 3 steps (cold,
    warm, profiled): exactly one ``fedavg_agg`` launch a step (on the
    (8, 162,317,616) matrix of flattened gradients), finite ce, the
    warm wall and its parts, peak memory, the profiled step's idle share
    and its launches by scope, the checkpoint's bytes and save ms; then
    one plain ``make_train_step`` step at the same size with 1 and 2
    microbatches, parameters within 2e-3; and xlstm-125m at
    ``reduced(num_layers=4)`` card against CPU in f32 with TF32 off:
    forward, prefill + 3 decode steps and one federated step (K = 3)
    within 1e-4;
15. paths 15-17, the MoE decoders and the Jamba hybrid served at their
    published widths with seeded random weights made in bf16, cut in
    depth to fit one card (``MOE_PATHS``): path 15 mixtral-8x22b, 4 of
    56 layers (48 / 8 heads of 128, window 4096, 8 experts top-2, d_ff
    16384); path 16 qwen3-moe-235b-a22b, 4 of 94 (64 / 4 heads, qk_norm,
    128 experts top-8, d_ff 1536); path 17 jamba-1.5-large-398b, the
    first four positions of its period (attention + MoE, Mamba + MLP,
    Mamba + MoE, Mamba + MLP; d_model 8192, 16 experts top-2, d_ff 24576,
    a Mamba of d_inner 16384 in 256 heads of 64, state 16).  Each: B =
    4, a 5120-token prompt, 32 greedy decode steps through
    ``transformer.prefill`` / ``decode_step`` with ``dense_grouped``
    dispatch; its cuts, parameter count (against the reckoning),
    prefill cold and warm, decode ms a step, peak memory, a profiled
    decode step's idle share and flash's share of device time, the
    profiled prefill's, flash launches by route (4 prefill + 4 x 32
    decode on paths 15-16, 1 + 32 on path 17, every one checked), the
    share of MoE assignments dropped in prefill by MoE layer, and decode
    parity against ``forward`` within 2e-2 on a second, dropless run
    (``moe_impl="ragged"``); then the three at ``reduced()`` on the card
    and the CPU (f32, TF32 off, groups of 32 at capacity factor 0.5):
    forward, prefill and 3 decode steps within 1e-4, equal expert ids
    and kept assignments, drops in several prefill groups;
16. paths 18-19, the VLM and the encoder-decoder served at their
    published widths with seeded random weights made in bf16
    (``MEDIA_PATHS``): path 18 qwen2-vl-72b, 8 of its 80 layers (64 / 8
    heads of 128, d_ff 29,568, M-RoPE sections (16, 24, 24)), B = 4, a
    prompt of 4096 patch embeddings, 32 greedy text steps; path 19
    whisper-small at full depth (12 encoder + 12 decoder layers,
    d_model 768, 12 heads of 64), B = 16 clips of 1500 frame
    embeddings, a 64-token decoder prompt, the self-attention cache
    padded to 448, 32 greedy steps.  Each: its cut and parameter count
    (against the reference's reckoning), prefill cold and warm (path 19:
    the encoder alone too, and time to first token), decode ms a step,
    peak memory, a profiled prefill's and decode step's busy time, idle
    share, launches and flash's share, flash launches by route and by
    kind of call (encoder, self-, cross-attention; every one checked),
    and decode parity against ``forward`` (prefill + decode against
    forward over the prompt and the token) within 1e-3 in f32 compute
    and, on path 19, 2e-2 in bf16 (path 18's bf16 reading is printed);
    then the two at ``reduced()`` on the card and the CPU
    (f32, TF32 off): qwen2-vl's ``forward`` over an image grid's
    three-axis positions, whisper's ``encode`` and ``forward``, and each
    one's prefill and 3 decode steps within 1e-4;
17. path 20, the federated trainer on h2o-danube-3-4b at its published
    widths, cut to 6 of 24 layers (``DANUBE_LAYERS``), as ``launch.train
    --arch h2o-danube-3-4b --federated 4 --num-layers 6
    --clients-per-pass 2`` sets it up: bf16 compute, f32 parameters,
    AdamW (lr 3e-4, warmup 10), DAS, a global batch of 16 x 1024 tokens,
    3 steps (cold, warm, profiled): its parameter count, step walls,
    tokens/s, peak memory, flash launches by route (a forward and a
    backward on the tensor cores for every layer and pass, checked) and
    one ``fedavg_agg`` a step, the profiled step's device time, idle
    share and the backward kernel's share of the device time; then
    danube at ``reduced(num_layers=2)`` card against CPU in f32 with
    TF32 off: one federated step (K = 4, 160 tokens a sequence, past the
    window of 128), parameters within 1e-4;
18. path 21, the plain trainer on stablelm-12b at its published widths
    (hd 160, 25% partial rotary), cut to 2 of 40 layers
    (``STABLELM_LAYERS``), as ``launch.train --arch stablelm-12b
    --num-layers 2 --batch 8 --seq 1024`` sets it up: bf16 compute, f32
    parameters, AdamW, 3 steps (cold, warm, profiled): its step walls,
    tokens/s, peak memory, flash launches by route (every layer's forward
    ``prefill_tc`` and backward ``backward_tc``, none ``backward``,
    checked), the profiled step's idle share and the backward kernels'
    share of the device time; then stablelm at ``reduced(num_layers=2,
    head_dim=160)`` card against CPU in bf16 compute: one plain step's
    gradients within 3e-2 of each leaf's largest;
19. path 22, the quickstart (``examples/quickstart_torch.py``) on the
    card, in a process of its own: exit code 0, and its diversity index
    within 1e-6 of the same script's on the CPU (``--device cpu``, run
    beside it);
20. path 23, the dry-run planner (``repro_torch.launch.dryrun``)
    against the card: ``lower_one`` of path 21's own configuration on a
    1x1 mesh (stablelm-12b, 2 layers, 8 x 1024 int64 tokens, AdamW, bf16
    compute) must count as argument bytes exactly the bytes that path
    21's live parameters, optimizer state and batch hold on the card; its
    FLOPs over path 21's warm step are printed as TFLOP/s.  Then one
    production record, qwen3-14b x train_4k at 16x16 and at 2x16x16
    (abstract meshes, nothing allocated): per-device argument bytes,
    FLOPs, the planned collectives and the wall.

The kernel phase first prints, from ``cuobjdump -sass``, the size and
the atomic instructions of the ``stream_update``, ``diversity`` and
empty kernels, and times the empty kernel (``csrc/launch_floor.cu``, the
launch floor) by CUDA-graph replay, host loop and the profiler.  It
checks ``diversity`` on path 1's rows and on uniform labels of the same
shape, and ``stream_update`` at S = 1 and 16, each after a NaN fill of
shared memory (two launches bit for bit, through the route the wrapper
predicts), and times each by host loop, graph replay and the profiler,
as multiples of the floor.  It runs ``sub2_pgd`` at S = 1 and 16 (K = 100, the warp
route) and S = 1, K = 1024 (the block route), with inputs NaN past K and
every SM's shared memory NaN before each checked launch, timed by host
loop and by CUDA-graph replay beside a latency floor; on the warp route
it also times every speculative depth (each bit for bit the shipped
one's) and the block route on the same rows.  It checks ``fedavg_agg``,
``fedavg_agg_masked`` and ``fedavg_agg_stale`` at the CNN's and the
MLP's widths (``fedavg_agg`` also at path 13's (8, 162,317,616), the
line's ``fedavg_agg_train`` row) after a NaN fill of shared memory (two launches bit for
bit, the all-ones mask and staleness identities bit for bit, each launch
through the route of P and the matrix's address) and times each in
turns against its one-line PyTorch expression (``w @ u``, ``(w * m) @
u``, ``((w * m) * s) @ u``), by host loop and by graph replay.  It checks
``compress_update`` in both modes at both widths, at S = 16, at an odd P
split over a cluster and at a row too long for the on-chip route, every
launch after a NaN fill (topk bit for bit the plain version on every
route and speculative depth, quant within the flip limit), times it by
host loop and by graph replay beside the stream route (the earlier
design) on the same rows, and times the on-chip route's choices (cluster
size; topk's speculative depth and full trips), each bit for bit the
shipped choice's output.  It also
holds ``flash_attention`` against its plain
version at the prefill (one KV group), decode and edge-case shapes, in
bf16 and f32, each launch after every SM's shared memory is filled with
NaN and with the keys past ``kv_len`` set to NaN, and times it beside
SDPA.  For training, the forward that writes each row's log-sum-exp
and the backward are held in f32 and bf16 at path 20's shape and at ten
more (``FLASH_BWD_SHAPES``: path 21's, and hd 136, 192, 256 and G = 5
at hd 160 among them), each launch after a NaN fill of shared memory
with the keys and values past ``kv_len`` NaN, through the backward's
route (``bwd_route``: ``backward_tc``, ``csrc/flash_attention_bwd_tc.cu``,
for bf16 at every width; ``backward``, ``csrc/flash_attention_bwd.cu``,
for f32): the output against ``flash_attention_plain`` (as the serving
rows), the lse within 1e-4, and the gradients from the kernels' output
and lse against ``flash_attention_bwd_plain`` from the plain ones,
within 1e-4 (f32) and 2e-2 (bf16) of each gradient's largest magnitude;
both routes' shared memory against their mirrors at every width.  At
path 20's and path 21's shapes (the ``flash_attention_bwd`` and
``flash_attention_bwd_hd160`` rows, with those paths' backward
launches) and at hd 256 the bf16 backward is timed by host loop and by
graph beside SDPA's backward alone (on a retained forward) and its
forward + backward, with the tensor-core kernels' device times from the
profiler, and the f32 backward at path 20's shape the same way.  The
kernels line has two rows for ``flash_attention`` (the bf16 prefill on
the tensor cores, and ``flash_attention_decode``, the decode kernel,
each with its route's launches on path 6) and two for
``compress_update`` (its quant launches on path 3, and
``compress_update_topk``, path 3's topk round), six for flash at paths
15-19's shapes (``PATH_FLASH``: ``flash_attention_g6``, ``_g16``,
``_g8`` the prefill of paths 15, 16, 17, ``flash_attention_decode_g8``
path 17's decode, ``flash_attention_enc`` path 19's encoder prefill and
``flash_attention_cross_decode`` its cross-attention decode, each timed
at its path's shape and with that path's launches by route), and one row
``<kernel>_batch`` for each kernel of a batch path (at S = 16, with that
path's launches; ``fedavg_agg_stale_batch`` with path 10's).  Each
path prints its launches by route.  At S = 16 the kernel phase also
checks each FedAvg entry point at the CNN's and the
MLP's widths on (S, K, P) updates (after a NaN fill: two launches bit
for bit, each scenario bit for bit the launch on its rows alone, within
1e-5 of the plain version) and times it in turns against one
``torch.bmm``, and holds each scenario of a batched ``stream_update``
and ``compress_update`` (quant, the CNN's width, timed too) bit for bit
against its single launch.

The last two lines are the ``kernels`` JSON record and the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet peaks (dense): HBM bandwidth, the f32 rate outside
# the tensor cores and the bf16 tensor-core rate.  A card below its 700 W
# limit runs slower than these.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# f32 operations per device coordinate, per PGD step, per start in the
# sub2_pgd kernel (transcendentals counted as one): gradient and softmax
# ~25, step ~5, 32 bisection trips x 4, objective ~12.
SUB2_OPS_PER_COORD_STEP = 170
# The latency floor of sub2_pgd's warp route: per PGD step, the dependent
# warp butterflies of 5 stages (the objective's sum and max, the softmax
# sum, the gradient sum, the step's max, the bracket's min and max) and,
# per speculative round, one of log2(G) stages (G the group width the
# instance's selected count gives), at the cycles assumed for one
# dependent shuffle and its add.  Shares must sum to 1 within f32
# rounding.
SUB2_STEP_BUTTERFLIES = 5
SUB2_SHFL_CYCLES = 30
SUB2_SUM_TOL = 1e-5
# sub2_pgd's alpha limit against its plain version: the reference's own
# between its descent and its autodiff oracle (tests/test_allocator.py).
SUB2_ALPHA_TOL = 1e-2
# f32 operations per class of the stream_update kernel (add, clamp,
# rescale, sum, divide, square, log2, two products, two sums) and per
# coordinate of compress_update's quant pass (add, abs, max, divide,
# multiply, floor, subtract, compare, add, sign, two multiplies, divide,
# subtract); topk counts an add, abs and max, then a compare and an add
# per bisection trip, then a select and a subtract.
STREAM_OPS_PER_CLASS = 14
QUANT_OPS_PER_COORD = 15
TOPK_OPS_PER_COORD_TRIP = 2
TOPK_OPS_PER_COORD = 5
# Limits of the kernel-vs-plain comparisons: the share of stochastic
# roundings that may flip in quant (the arithmetic is the same IEEE
# sequence, so none should), and the stream refresh's tolerance (sums
# over C classes in another order).
QUANT_FLIP_LIMIT = 1e-4
STREAM_TOL = 1e-4
P_CNN, P_MLP = 21840, 159010
# compress_update's extra checks: an odd P split over a cluster of 8, and
# a row too long for the on-chip route.
P_ODD, P_LONG = 100003, 200001
# Turns of fedavg_agg against w @ u (each side first in half of them).
FEDAVG_TURNS = 10
SEED = 0
# The subsystems of paths 2-5.
FAULTS = dict(drop_prob=0.1, max_retries=2, straggler_prob=0.05,
              reliability_ema=0.2, chronic_spread=0.5, overprovision=2)
PATH2_SCHED = dict(staleness_weight=0.25, reliability_weight=0.5)
# Path 4's event driver: the reference's asynchronous benchmark setting
# (benchmarks/sched_micro.py) with its tick length set from path 1's
# round times, a dispatch cap that binds at K = 100 and the bf16 carry.
ASYNC = dict(availability="diurnal", duty=0.6, period=24.0,
             phase_spread=0.5, buffer_size=2, staleness_decay=0.5,
             num_events=6)
PATH4_CAP = 16
# The FedAvg kernels' limit against their plain versions: K-term f32 sums
# in another order.
STALE_TOL = 1e-5


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cycling(n_bytes: int) -> int:
    """Input copies to cycle through so repeated calls miss the 50 MB L2."""
    return max(1, math.ceil(120e6 / n_bytes))


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_turns(torch, kernel, library, label: str, turns: int = FEDAVG_TURNS,
             calls: int = 200) -> tuple[dict, str]:
    """``kernel`` and ``library`` (one PyTorch call computing the same
    function) in ``turns`` turns, each side first in half of them, by
    host loop and by CUDA-graph replay of ``calls`` calls.  Returns the
    medians (``loop``, ``graph``, ``library_loop``, ``library_graph``)
    and a line with each side's quartile spread and the turns the kernel
    wins."""
    times = {(fn, how): [] for fn in ("kernel", "library")
             for how in ("loop", "graph")}
    for turn in range(turns):
        order = (("kernel", kernel), ("library", library))
        for name, fn in order if turn % 2 == 0 else order[::-1]:
            times[(name, "loop")].append(time_ms(fn, calls))
            times[(name, "graph")].append(graph_ms(torch, fn, calls))
    read, out = [], {}
    for how in ("loop", "graph"):
        ker, lib = times[("kernel", how)], times[("library", how)]
        wins = sum(a < b for a, b in zip(ker, lib))
        out[how], out[f"library_{how}"] = median(ker), median(lib)
        read.append(f"{how}: kernel median {median(ker):.5f} (quartiles "
                    f"{quartiles(ker)}), {label} median {median(lib):.5f} "
                    f"(quartiles {quartiles(lib)}), kernel faster in {wins} "
                    f"of {turns} turns")
    return out, "; ".join(read)


def fedavg_checked(torch, fn, args, plain, label: str) -> tuple:
    """Two launches of the FedAvg entry point ``fn`` on ``args``, each after
    every SM's shared memory is filled with NaN: the same bits twice,
    within 1e-5 of ``plain`` (K-term f32 sums in another order than the
    plain version's cuBLAS reduction: a few ulps of the O(1) result), one
    launch through the route of (P, address).  Returns ``(output, max
    abs error, route)``."""
    from repro_torch.kernels import _check
    from repro_torch.kernels import fedavg_agg as fk
    u = args[0]
    which = fk.route(u.shape[-1], u.data_ptr(), u.shape[-2] * u.shape[-1])
    before = fn.route_launches[which]
    outs = []
    for _ in range(2):
        _check.fill_shared_memory(args[0].device)
        outs.append(fn(*args))
    want = plain(*args)
    torch.cuda.synchronize()
    if fn.route_launches[which] != before + 2:
        raise AssertionError(f"{label}: launches not through route {which}")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{label}: two launches on the same inputs "
                             f"differ")
    err = float((outs[0] - want).abs().max())
    if not err <= STALE_TOL:
        raise AssertionError(f"{label}: max err {err}")
    return outs[0], err, which


def phase_fedavg(torch, dev, k: int, p: int) -> dict:
    from repro_torch.kernels import fedavg_agg as fk
    gen = torch.Generator(device=dev).manual_seed(SEED + p)
    n = cycling(k * p * 4)
    us = [torch.randn((k, p), generator=gen, device=dev) for _ in range(n)]
    w = torch.softmax(torch.randn((k,), generator=gen, device=dev), 0)
    _, err, which = fedavg_checked(torch, fk.fedavg_agg, (us[0], w),
                                   fk.fedavg_agg_plain, f"fedavg_agg K={k} "
                                   f"P={p}")
    it = iter(range(10 ** 9))
    turns, read = in_turns(
        torch, lambda: fk.fedavg_agg(us[next(it) % n], w),
        lambda: w @ us[next(it) % n], "w @ u")
    plain_ms = time_ms(lambda: fk.fedavg_agg_plain(us[next(it) % n], w), 200)
    host_us = host_issue_us(torch, lambda: fk.fedavg_agg(us[0], w), 200)
    b_ms, b_by = bound(k * p * 4 + k * 4 + p * 4, 2 * k * p)
    print(f"[kernel] fedavg_agg K={k} P={p} route {which}: max_abs_err="
          f"{err:.3g} (NaN shared memory, two launches bit for bit) ms="
          f"{turns['loop']:.5f} (host {host_us:.2f} us per call) "
          f"plain_ms={plain_ms:.5f} library_ms(w@u)="
          f"{turns['library_loop']:.5f} bound_ms={b_ms:.5f} ({b_by}); in "
          f"turns, {read}", flush=True)
    return dict(max_abs_err=err, ms=turns["loop"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=turns["library_loop"])


def phase_fedavg_train(torch, dev, k: int, p: int) -> dict:
    """``fedavg_agg`` at path 13's shape: K clients' flattened gradients
    of xlstm-125m, (K, P) = (8, 162,317,616), 5.19 GB in f32.  One input
    (it is 100x the L2), turns of a few calls each."""
    from repro_torch.kernels import fedavg_agg as fk
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    u = torch.randn((k, p), generator=gen, device=dev)
    w = torch.softmax(torch.randn((k,), generator=gen, device=dev), 0)
    _, err, which = fedavg_checked(torch, fk.fedavg_agg, (u, w),
                                   fk.fedavg_agg_plain,
                                   f"fedavg_agg K={k} P={p}")
    turns, read = in_turns(torch, lambda: fk.fedavg_agg(u, w),
                           lambda: w @ u, "w @ u", turns=4, calls=10)
    plain_ms = time_ms(lambda: fk.fedavg_agg_plain(u, w), 10)
    b_ms, b_by = bound(k * p * 4 + k * 4 + p * 4, 2 * k * p)
    print(f"[kernel] fedavg_agg K={k} P={p} (path 13, {k * p * 4 / 1e9:.2f} "
          f"GB) route {which}: max_abs_err={err:.3g} (NaN shared memory, two "
          f"launches bit for bit) ms={turns['loop']:.4f} graph_ms="
          f"{turns['graph']:.4f} plain_ms={plain_ms:.4f} library_ms(w@u)="
          f"{turns['library_loop']:.4f} (graph "
          f"{turns['library_graph']:.4f}) bound_ms={b_ms:.4f} ({b_by}; "
          f"{b_ms / turns['graph']:.3f} of it by graph); in turns, {read}",
          flush=True)
    del u
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=turns["loop"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=turns["library_loop"])


def median(xs) -> float:
    ys = sorted(xs)
    mid = len(ys) // 2
    return ys[mid] if len(ys) % 2 else 0.5 * (ys[mid - 1] + ys[mid])


def quartiles(xs) -> str:
    ys = sorted(xs)
    return f"{ys[len(ys) // 4]:.5f}-{ys[(3 * len(ys)) // 4]:.5f}"


def profiled_ms(torch, fn, kname: str, calls: int = 50) -> float:
    """Mean device time a launch of the kernels named ``kname`` (a
    ``__global__`` name, template arguments aside) over ``calls``
    back-to-back calls of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and (f"{kname}(" in e.name or f"{kname}<" in e.name)]
    if not us:
        raise AssertionError(f"profiler saw no {kname} launch")
    return sum(us) / len(us) / 1e3


# Kernels whose SASS size and atomics the kernel phase prints.
SASS_KERNELS = ("stream_update_kernel", "diversity_kernel",
                "launch_floor_kernel")


def sass_sizes(lib) -> None:
    """Each SASS_KERNELS function of the built library ``lib``, from
    ``cuobjdump -sass``: its instructions (16 bytes each) and its atomic
    instructions (a float add on shared memory that compiles to a
    compare-and-swap loop shows as ``ATOMS.CAS``)."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs: dict = {}
    name = None
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
            continue
        ins = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if ins and name:
            funcs[name].append(ins.group(1).strip())
    for kname in SASS_KERNELS:
        found = [(n, ops) for n, ops in funcs.items() if kname in n]
        if not found:
            raise AssertionError(f"cuobjdump shows no {kname}")
        for n, ops in found:
            mnemonics = {re.sub(r"^@\S+\s+", "", op).split()[0]
                         for op in ops}
            atoms = sorted(m for m in mnemonics
                           if m.startswith(("ATOM", "RED.")))
            print(f"[sass] {n}: {len(ops)} instructions ({16 * len(ops)} "
                  f"bytes), atomics {atoms or 'none'}", flush=True)


def phase_floor(torch, dev) -> dict:
    """The empty kernel (``csrc/launch_floor.cu``): by graph replay, by
    host loop and by the profiler's device time a launch, and the host's
    time a call.  Every small kernel's graph time is set beside it."""
    from repro_torch.kernels import _check

    def empty():
        _check.launch_floor(dev)
    floor = dict(graph=graph_ms(torch, empty, 200), loop=time_ms(empty, 200),
                 device=profiled_ms(torch, empty, "launch_floor_kernel"),
                 host_us=host_issue_us(torch, empty, 200))
    print(f"[kernel] launch floor (an empty kernel, one warp): graph "
          f"{floor['graph']:.5f} ms, host loop {floor['loop']:.5f} ms, "
          f"profiler {floor['device']:.5f} ms a launch, host "
          f"{floor['host_us']:.2f} us per call", flush=True)
    return floor


def small_kernel_times(torch, fn, kname: str, floor: dict) -> tuple:
    """A small kernel's time beside the launch floor: ``(host-loop ms,
    line)``, the line with its graph-replay and profiler times, each as
    a multiple of the floor's, and the host's time a call."""
    ms = time_ms(fn, 200)
    graph = graph_ms(torch, fn, 200)
    device = profiled_ms(torch, fn, kname)
    host_us = host_issue_us(torch, fn, 200)
    return ms, (f"ms={ms:.5f} (graph {graph:.5f} = "
                f"{graph / floor['graph']:.2f}x the floor; profiler "
                f"{device:.5f} a launch = {device / floor['device']:.2f}x; "
                f"host {host_us:.2f} us per call)")


def twice_checked(torch, dev, fn, counter, which: str, label: str):
    """Two launches of ``fn`` through route ``which`` of ``counter``'s
    ``route_launches``, each after every SM's shared memory is filled
    with NaN: the same bits twice.  Returns the first output."""
    from repro_torch.kernels import _check
    before = counter.route_launches[which]
    outs = []
    for _ in range(2):
        _check.fill_shared_memory(dev)
        outs.append(fn())
    torch.cuda.synchronize()
    if counter.route_launches[which] != before + 2:
        raise AssertionError(f"{label}: launches not through route {which}")
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in outs)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two launches on the same inputs "
                                 f"differ")
    return outs[0]


def phase_diversity(torch, dev, labels, mask, c: int, floor: dict) -> dict:
    """diversity on the path's rows (label-sorted shards: a few classes a
    row) and on uniform random labels of the same shape under the same
    mask: checked after NaN shared memory, two launches bit for bit,
    timed beside the launch floor.  Returns the path rows' record."""
    from repro_torch.kernels import diversity as dk
    k, n = labels.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    uniform = torch.randint(0, c, (k, n), generator=gen, device=dev,
                            dtype=torch.int32)
    plain_ms = time_ms(lambda: dk.diversity_stats_plain(labels, mask, c), 50)
    b_ms, b_by = bound(k * n * 8 + k * 12, k * n * 2)
    recs = []
    for name, lab in (("path rows", labels), ("uniform labels", uniform)):
        which = dk.route(n, lab.data_ptr(), mask.data_ptr())
        got = twice_checked(torch, dev,
                            lambda: dk.diversity_stats(lab, mask, c),
                            dk.diversity_stats, which,
                            f"diversity {name}")
        want = dk.diversity_stats_plain(lab, mask, c)
        err = float((got - want).abs().max())
        # Exact integer counts; gini/shannon sums over C classes in
        # another order.
        if not (err <= 1e-5 and torch.equal(got[:, 2], want[:, 2])):
            raise AssertionError(f"diversity {name} K={k} N={n}: max err "
                                 f"{err}")
        ms, line = small_kernel_times(
            torch, lambda: dk.diversity_stats(lab, mask, c),
            "diversity_kernel", floor)
        print(f"[kernel] diversity K={k} N={n} C={c} {name} route {which}: "
              f"max_abs_err={err:.3g} (NaN shared memory, two launches bit "
              f"for bit, exact counts) {line} plain_ms={plain_ms:.5f} "
              f"bound_ms={b_ms:.6f} ({b_by})", flush=True)
        recs.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return recs[0]


def sub2_instances(torch, dev, s: int, k: int):
    """S Table-I instances: a network, fading, ~30% selected, starts."""
    from repro_torch.core import bandwidth, wireless
    wcfg = wireless.WirelessConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 17 * s)
    rows = {n: [] for n in ("sel", "tt", "c", "pw", "bits", "a0")}
    for _ in range(s):
        net = wireless.sample_network(gen, k, wcfg, dev)
        gains = wireless.sample_fading(gen, net)
        sizes = torch.randint(50, 901, (k,), generator=gen, device=dev)
        tt = wireless.train_time(sizes, net, wcfg)
        sel = (torch.rand((k,), generator=gen, device=dev) < 0.3).float()
        sel[0] = 1.0
        wf, _ = bandwidth.min_time_allocation(sel, tt, gains, net.tx_power,
                                              wcfg)
        rows["sel"].append(sel)
        rows["tt"].append(tt)
        rows["c"].append(gains * net.tx_power
                         / (wcfg.bandwidth_hz * wcfg.noise_psd))
        rows["pw"].append(net.tx_power)
        rows["bits"].append(torch.full((k,), wcfg.model_bits, device=dev))
        rows["a0"].append(torch.stack([wf, sel / sel.sum()]))
    args = [torch.stack(rows[n]).contiguous()
            for n in ("sel", "tt", "c", "pw", "bits", "a0")]
    return args, wcfg


def nan_padded(torch, t):
    """``t`` copied to the front of a NaN-filled buffer that runs 1024 - K
    floats past its end (at S = 1 the first K columns of a (1, 1024) row),
    so that a kernel reading past K reads NaN."""
    k = t.shape[-1]
    buf = torch.full((t.numel() + 1024 - k,), float("nan"), device=t.device)
    buf[:t.numel()] = t.reshape(-1)
    return buf[:t.numel()].view(t.shape)


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0])


def sub2_check(torch, args, plain, run, label: str):
    """One launch by ``run`` after every SM's shared memory is filled
    with NaN, against the plain version's ``(alpha, objective)`` on the
    same ``args``: finite shares that sum to 1 over the selected set
    (zeros elsewhere, and for an empty selection), the alpha and
    objective errors within the limits.  Returns ``(alpha, objective,
    alpha error, objective relative error)``."""
    from repro_torch.kernels import _check
    _check.fill_shared_memory(args[0].device)
    a_k, o_k = run()
    a_p, o_p = plain
    torch.cuda.synchronize()
    sel = args[0] > 0
    err = float((a_k - a_p).abs().max())
    rel_obj = float(((o_k - o_p).abs() / o_p.abs().clamp_min(1e-30)).max())
    sums = torch.where(sel, a_k, 0.0).sum(-1)
    any_sel = sel.any(-1)
    sum_err = float((sums - any_sel.float()).abs().max())
    if not (bool(a_k.isfinite().all()) and bool(o_k.isfinite().all())):
        raise AssertionError(f"sub2_pgd {label}: non-finite output after "
                             f"NaN past K and NaN shared memory")
    if not (sum_err <= SUB2_SUM_TOL and bool((a_k[~sel] == 0).all())):
        raise AssertionError(f"sub2_pgd {label}: shares off the simplex "
                             f"(sum error {sum_err})")
    # The reference's own tolerance between this descent and its autodiff
    # oracle (tests/test_allocator.py): the kernel's analytic gradient and
    # the plain version's autograd one round differently, and the
    # normalised steps amplify that along the objective's flat valley.
    if not (err <= SUB2_ALPHA_TOL and rel_obj <= 1e-3):
        raise AssertionError(f"sub2_pgd {label}: alpha err {err}, "
                             f"objective rel err {rel_obj}")
    return a_k, o_k, err, rel_obj


def phase_sub2(torch, dev, s: int, k: int) -> dict:
    """sub2_pgd at S instances of K devices through the wrapper's route,
    inputs NaN past K and shared memory NaN before each checked launch:
    errors against the plain version, time by host loop and by CUDA-graph
    replay.  On the warp route also every speculative depth (each must
    give the shipped depth's output bit for bit) and the block route on
    the same rows."""
    from repro_torch.core import bandwidth
    from repro_torch.kernels import sub2_pgd as sk
    args, wcfg = sub2_instances(torch, dev, s, k)
    args = [nan_padded(torch, t) for t in args]
    p = bandwidth.Sub2Params()
    kw = dict(rho=p.rho, lr=p.pgd_lr, tau=p.smooth_tau, iters=p.pgd_iters,
              bandwidth_hz=wcfg.bandwidth_hz, min_alpha=wcfg.min_alpha)
    which = sk.route(k)
    plain = sk.sub2_pgd_plain(*args, **kw)
    before = dict(sk.sub2_pgd.route_launches)
    a_k, o_k, err, rel_obj = sub2_check(
        torch, args, plain, lambda: sk.sub2_pgd(*args, **kw), f"S={s} K={k}")
    routed = {r: n - before[r] for r, n in sk.sub2_pgd.route_launches.items()}
    if routed != {r: int(r == which) for r in routed}:
        raise AssertionError(f"sub2_pgd K={k}: launches {routed}, expected "
                             f"one through {which}")
    ms = time_ms(lambda: sk.sub2_pgd(*args, **kw), 20)
    graph = graph_ms(torch, lambda: sk.sub2_pgd(*args, **kw), 20)
    plain_ms = time_ms(lambda: sk.sub2_pgd_plain(*args, **kw), 2, warmup=1)
    b_ms, b_by = bound(s * k * 4 * 7 + s * 4,
                       s * 2 * k * p.pgd_iters * SUB2_OPS_PER_COORD_STEP)
    floor = ""
    if which != "block":
        # The slowest instance's group width sets the bisection's stages.
        n_sel = int((args[0] > 0).sum(1).max())
        width = 2
        while 16 * width < n_sel:
            width *= 2
        rounds = -(-sk.DEFAULT_PROJ_ITERS // sk.SPEC_DEPTH)
        stages = SUB2_STEP_BUTTERFLIES * 5 + rounds * int(math.log2(width))
        clock = sm_clock_mhz()
        floor_ms = p.pgd_iters * stages * SUB2_SHFL_CYCLES / (clock * 1e3)
        floor = (f"; latency floor {floor_ms:.5f} ms ({stages} dependent "
                 f"shuffle stages per step: {SUB2_STEP_BUTTERFLIES} x 5 + "
                 f"{rounds} rounds x log2(G = {width}), {n_sel} selected, "
                 f"x {SUB2_SHFL_CYCLES} cycles at the {clock:.0f} MHz max SM "
                 f"clock)")
    print(f"[kernel] sub2_pgd S={s} K={k} iters={p.pgd_iters} route {which}"
          f" (depth {sk.SPEC_DEPTH}): max_abs_err(alpha)={err:.3g} "
          f"rel_err(obj)={rel_obj:.3g} (limits 1e-2, 1e-3) ms={ms:.5f} "
          f"(graph {graph:.5f}) plain_ms={plain_ms:.2f} bound_ms="
          f"{b_ms:.6f} ({b_by}){floor}", flush=True)
    if which != "block":
        outs = {}
        for depth in range(1, sk.MAX_SPEC_DEPTH + 1):
            def run(depth=depth):
                return sk.launch(*args, which=which, depth=depth, **kw)
            outs[depth] = sub2_check(torch, args, plain, run,
                                     f"S={s} K={k} depth {depth}")[:2]
            d_graph = graph_ms(torch, run, 20)
            same = torch.equal(outs[depth][0], a_k) and \
                torch.equal(outs[depth][1], o_k)
            print(f"[kernel] sub2_pgd S={s} K={k} route {which} depth "
                  f"{depth} ({-(-sk.DEFAULT_PROJ_ITERS // depth)} rounds of "
                  f"bisection): graph {d_graph:.5f} ms; output "
                  f"{'bit for bit' if same else 'DIFFERS from'} depth "
                  f"{sk.SPEC_DEPTH}'s", flush=True)
            if not same:
                raise AssertionError(f"sub2_pgd depth {depth} differs from "
                                     f"depth {sk.SPEC_DEPTH}")

        def blk():
            return sk.launch(*args, which="block", **kw)
        _, _, b_err, b_rel = sub2_check(torch, args, plain, blk,
                                        f"S={s} K={k} block route")
        print(f"[kernel] sub2_pgd S={s} K={k} block route on the same rows:"
              f" max_abs_err(alpha)={b_err:.3g} rel_err(obj)={b_rel:.3g} "
              f"ms={time_ms(blk, 20):.5f} (graph {graph_ms(torch, blk, 20):.5f})",
              flush=True)
    print(f"[kernel] sub2_pgd launches by route so far "
          f"{sk.sub2_pgd.route_launches}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase_stream(torch, dev, s: int, k: int, c: int, floor: dict) -> dict:
    """stream_update at S scenarios of K devices and C classes through
    the route of C: checked after NaN shared memory, two launches bit for
    bit, timed beside the launch floor."""
    from repro_torch.kernels import stream_update as su
    gen = torch.Generator(device=dev).manual_seed(SEED + s)
    h = torch.randint(0, 900, (s, k, c), generator=gen, device=dev).float()
    d = torch.poisson(torch.full((s, k, c), 2.0, device=dev), generator=gen)
    arr = d.sum(-1)
    stale = torch.rand((s, k), generator=gen, device=dev) * 50.0
    sel = (torch.rand((s, k), generator=gen, device=dev) < 0.4).float()
    args = (h, d, arr, stale, sel)
    kw = dict(decay=0.8, size_cap=900.0)     # the full world's capacity
    which = su.route(c)
    got = twice_checked(torch, dev, lambda: su.stream_update(*args, **kw),
                        su.stream_update, which, f"stream_update S={s}")
    want = su.stream_update_plain(*args, **kw)
    # Relative to each output's scale: counts and sizes reach 900.
    err = max(float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
              for g, w in zip(got, want))
    if not err <= STREAM_TOL:
        raise AssertionError(f"stream_update S={s}: rel err {err}")
    ms, line = small_kernel_times(
        torch, lambda: su.stream_update(*args, **kw), "stream_update_kernel",
        floor)
    plain_ms = time_ms(lambda: su.stream_update_plain(*args, **kw), 100)
    b_ms, b_by = bound(s * k * c * 12 + s * k * 28,
                       s * k * c * STREAM_OPS_PER_CLASS)
    print(f"[kernel] stream_update S={s} K={k} C={c} route {which}: "
          f"max_rel_err={err:.3g} (limit {STREAM_TOL:g}; NaN shared memory, "
          f"two launches bit for bit) {line} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.7f} ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def compress_inputs(torch, gen, mode: str, s: int, k: int, p: int):
    """One set of (S, K, P) rows (S = 1: (K, P)): updates of a per-row
    scale, a residual, and quant's noise (topk: a (…, K) placeholder)."""
    shape = (s, k, p) if s > 1 else (k, p)
    scale = torch.rand(shape[:-1] + (1,), generator=gen, device=gen.device)
    u = torch.randn(shape, generator=gen, device=gen.device) * scale
    r = 0.1 * torch.randn(shape, generator=gen, device=gen.device)
    noise = torch.rand(shape, generator=gen, device=gen.device) \
        if mode == "quant" else torch.zeros(shape[:-1], device=gen.device)
    return u, r, noise


def compress_check(torch, dev, mode: str, s: int, k: int, p: int) -> tuple:
    """compress_update at S x K rows of P through the wrapper's route,
    then the same rows through every route and, on the on-chip route,
    every speculative depth, each launch after every SM's shared memory is
    filled with NaN: topk bit for bit the plain version, quant within
    QUANT_FLIP_LIMIT with r' bit for bit wherever the codes agree, and the
    wrapper's two launches the same bits.  Returns the wrapper's max abs
    error and the check's widths, selection and keyword arguments."""
    from repro_torch.kernels import _check
    from repro_torch.kernels import compress as cu
    gen = torch.Generator(device=dev).manual_seed(SEED + p + s)
    u, r, noise = compress_inputs(torch, gen, mode, s, k, p)
    rows = u.shape[:-1]
    sel = (torch.rand(rows, generator=gen, device=dev) < 0.8).float()
    widths = torch.full(rows, 8.0 if mode == "quant" else 32.0, device=dev)
    kw = dict(mode=mode, keep=max(1, round(0.05 * p)))
    args = (u, r, widths, sel, noise)
    label = f"compress_update {mode} S={s} K={k} P={p}"
    which = cu.route(p)
    before = dict(cu.compress_update.route_launches)
    outs = []
    for _ in range(2):
        _check.fill_shared_memory(dev)
        outs.append(cu.compress_update(*args, **kw))
    routed = {key: n - before[key]
              for key, n in cu.compress_update.route_launches.items()}
    if routed != {key: 2 * (key == f"{mode}/{which}") for key in routed}:
        raise AssertionError(f"{label}: launches {routed}, expected two "
                             f"through {which}")
    batch = [a if s > 1 else a[None] for a in args]
    runs = {f"{which} (wrapper)": outs[0]}
    for route, depth in [("stream", cu.SPEC_DEPTH)] + (
            [("onchip", d) for d in range(1, cu.MAX_SPEC_DEPTH + 1)]
            if which == "onchip" and mode == "topk" else []):
        _check.fill_shared_memory(dev)
        c, r_new = cu.launch(*batch, which=route, depth=depth,
                             thresh_iters=cu.DEFAULT_THRESH_ITERS, **kw)
        runs[f"{route} depth {depth}"] = (c.view(u.shape), r_new.view(u.shape))
    c_p, r_p = cu.compress_update_plain(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError(f"{label}: two launches on the same inputs "
                             f"differ")
    for name, (c, r_new) in runs.items():
        flipped = float((c != c_p).float().mean())
        r_flipped = float((r_new != r_p).float().mean())
        if mode == "topk" and not (torch.equal(c, c_p)
                                   and torch.equal(r_new, r_p)):
            raise AssertionError(f"{label} {name}: not bit for bit the "
                                 f"plain version")
        if mode == "quant" and not (flipped <= QUANT_FLIP_LIMIT
                                    and r_flipped <= QUANT_FLIP_LIMIT):
            raise AssertionError(f"{label} {name}: flipped share {flipped}, "
                                 f"residual share {r_flipped}")
        # Where the codes agree, the residual v - c (or r, unselected) must
        # be bit for bit the plain one: the flips are the only difference.
        same = c == c_p
        if mode == "quant" and not torch.equal(r_new[same], r_p[same]):
            raise AssertionError(f"{label} {name}: residual differs where "
                                 f"the codes agree")
    c, r_new = outs[0]
    err = max(float((c - c_p).abs().max()), float((r_new - r_p).abs().max()))
    flipped = float((c != c_p).float().mean())
    r_flipped = float((r_new != r_p).float().mean())
    if which == "onchip":
        which += f" ({cu.cluster_blocks(p)} blocks a row)"
    print(f"[kernel] {label} route {which}: max_abs_err={err:.3g} "
          f"flipped_share={flipped:.3g} "
          f"residual_share={r_flipped:.3g} (limit {QUANT_FLIP_LIMIT:g} "
          f"quant, exact topk) after NaN shared memory, two launches bit "
          f"for bit; the same on {', '.join(runs)}", flush=True)
    return err, widths, sel, kw


def compress_smem_mirror() -> None:
    """The wrapper's mirror of the on-chip route's shared memory (which
    cluster sizes fit a row) against the C entry's, around the edges."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import compress as cu
    lib = _build.library()
    for p in (1, 3, 1001, P_CNN, 24576, 24577, 49153, P_ODD, P_MLP,
              196608, 196609, P_LONG):
        for nb in (1, 2, 4, 8, 16):
            for i, mode in enumerate(cu.MODES):
                if lib.compress_update_smem(p, nb, i) != \
                        cu.onchip_smem_bytes(p, nb, mode):
                    raise AssertionError(f"compress smem mirror at P={p} "
                                         f"nb={nb} {mode}")


def phase_compress(torch, dev, mode: str, k: int, p: int) -> dict:
    """compress_update at K rows of P: the checks of ``compress_check``,
    then the wrapper's time by host loop and by CUDA-graph replay (inputs
    cycled past the L2), beside the stream route (the earlier design) on
    the same rows, and on the on-chip route the design's choices: every
    cluster size that fits and, for topk, every speculative depth and
    count of full trips."""
    from repro_torch.kernels import compress as cu
    err, widths, sel, kw = compress_check(
        torch, dev, mode, 1, k, p)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3 * p)
    n = cycling(k * p * (12 if mode == "quant" else 8))
    sets = [compress_inputs(torch, gen, mode, 1, k, p) for _ in range(n)]
    it = iter(range(10 ** 9))

    def call(fn):
        u, r, noise = sets[next(it) % n]
        return fn(u, r, widths, sel, noise, **kw)

    def routed(which, **how):
        def fn(u, r, widths, sel, noise, **kw):
            return cu.launch(u[None], r[None], widths[None], sel[None],
                             noise[None], which=which,
                             thresh_iters=cu.DEFAULT_THRESH_ITERS,
                             **dict(kw, **how))
        return lambda: call(fn)

    ms = time_ms(lambda: call(cu.compress_update), 50)
    graph = graph_ms(torch, lambda: call(cu.compress_update), 20)
    host_us = host_issue_us(torch, lambda: call(cu.compress_update), 50)
    stream = graph_ms(torch, routed("stream"), 20)
    plain_ms = time_ms(lambda: call(cu.compress_update_plain), 5, warmup=1)
    if mode == "quant":
        b_ms, b_by = bound(20 * k * p + 8 * k, k * p * QUANT_OPS_PER_COORD)
    else:
        b_ms, b_by = bound(16 * k * p + 8 * k, k * p * (
            TOPK_OPS_PER_COORD + 32 * TOPK_OPS_PER_COORD_TRIP))
    which = cu.route(p)
    print(f"[kernel] compress_update {mode} K={k} P={p} route {which}: "
          f"ms={ms:.5f} (graph {graph:.5f}; host {host_us:.2f} us per call; "
          f"the stream route, the earlier design, on the same rows: graph "
          f"{stream:.5f}) plain_ms="
          f"{plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}; {b_ms / graph:.3f} "
          f"of it by the graph)", flush=True)
    if which == "onchip":
        # The design's choices, each timed by graph replay and each bit
        # for bit the shipped launch's output on the first set of rows.
        shipped = dict(nb=cu.cluster_blocks(p), depth=cu.SPEC_DEPTH,
                       full_trips=cu.FULL_TRIPS)
        choices = [dict(shipped, nb=nb) for nb in (1, 2, 4, 8)
                   if cu.onchip_smem_bytes(p, nb, mode)]
        if mode == "topk":
            choices += [dict(shipped, depth=d)
                        for d in range(1, cu.MAX_SPEC_DEPTH + 1)]
            choices += [dict(shipped, full_trips=f) for f in (2, 3, 4, 5, 6)]
        u, r, noise = sets[0]
        args = (u[None], r[None], widths[None], sel[None], noise[None])
        want = cu.launch(*args, which="onchip", **shipped, **kw,
                         thresh_iters=cu.DEFAULT_THRESH_ITERS)
        read = []
        for how in choices:
            got = cu.launch(*args, which="onchip", **how, **kw,
                            thresh_iters=cu.DEFAULT_THRESH_ITERS)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"compress_update {mode} P={p} {how}: "
                                     f"differs from the shipped {shipped}")
            read.append(f"nb {how['nb']} depth {how['depth']} full trips "
                        f"{how['full_trips']}: "
                        f"{graph_ms(torch, routed('onchip', **how), 20):.5f}")
        print(f"[kernel] compress_update {mode} K={k} P={p} on chip, graph "
              f"ms by (blocks a row, depth, full trips), each bit for bit "
              f"the shipped {tuple(shipped.values())}: {'; '.join(read)}",
              flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_masked(torch, dev, k: int, p: int) -> dict:
    from repro_torch.kernels import fedavg_agg as fk
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 * p)
    n = cycling(k * p * 4)
    us = [torch.randn((k, p), generator=gen, device=dev) for _ in range(n)]
    w = torch.softmax(torch.randn((k,), generator=gen, device=dev), 0)
    m = (torch.rand((k,), generator=gen, device=dev) < 0.8).float()
    label = f"fedavg_agg_masked K={k} P={p}"
    _, err, which = fedavg_checked(torch, fk.fedavg_agg_masked,
                                   (us[0], w, m), fk.fedavg_agg_masked_plain,
                                   label)
    ones, _, _ = fedavg_checked(torch, fk.fedavg_agg_masked,
                                (us[0], w, torch.ones_like(m)),
                                fk.fedavg_agg_masked_plain, label)
    unmasked, _, _ = fedavg_checked(torch, fk.fedavg_agg, (us[0], w),
                                    fk.fedavg_agg_plain, label)
    if not torch.equal(ones, unmasked):
        raise AssertionError("fedavg_agg_masked with an all-ones mask is "
                             "not bitwise fedavg_agg")
    it = iter(range(10 ** 9))
    turns, read = in_turns(
        torch, lambda: fk.fedavg_agg_masked(us[next(it) % n], w, m),
        lambda: (w * m) @ us[next(it) % n], "(w * m) @ u")
    plain_ms = time_ms(
        lambda: fk.fedavg_agg_masked_plain(us[next(it) % n], w, m), 200)
    b_ms, b_by = bound(k * p * 4 + k * 8 + p * 4, 2 * k * p)
    print(f"[kernel] {label} route {which}: max_abs_err={err:.3g} (NaN "
          f"shared memory, two launches bit for bit) all-ones bitwise "
          f"fedavg_agg: yes ms={turns['loop']:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms((w*m)@u)={turns['library_loop']:.5f} bound_ms="
          f"{b_ms:.5f} ({b_by}); in turns, {read}", flush=True)
    return dict(max_abs_err=err, ms=turns["loop"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=turns["library_loop"])


def phase_stale(torch, dev, k: int, p: int) -> dict:
    from repro_torch.kernels import fedavg_agg as fk
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 * p)
    n = cycling(k * p * 4)
    us = [torch.randn((k, p), generator=gen, device=dev) for _ in range(n)]
    w = torch.softmax(torch.randn((k,), generator=gen, device=dev), 0)
    m = (torch.rand((k,), generator=gen, device=dev) < 0.5).float()
    tau = torch.randint(0, 5, (k,), generator=gen, device=dev).float()
    s = (1.0 + tau) ** -0.5
    label = f"fedavg_agg_stale K={k} P={p}"
    _, err, which = fedavg_checked(torch, fk.fedavg_agg_stale,
                                   (us[0], w, m, s), fk.fedavg_agg_stale_plain,
                                   label)
    ones, _, _ = fedavg_checked(torch, fk.fedavg_agg_stale,
                                (us[0], w, m, torch.ones_like(s)),
                                fk.fedavg_agg_stale_plain, label)
    masked, _, _ = fedavg_checked(torch, fk.fedavg_agg_masked, (us[0], w, m),
                                  fk.fedavg_agg_masked_plain, label)
    if not torch.equal(ones, masked):
        raise AssertionError("fedavg_agg_stale with all-ones s is not "
                             "bitwise fedavg_agg_masked")
    it = iter(range(10 ** 9))
    turns, read = in_turns(
        torch, lambda: fk.fedavg_agg_stale(us[next(it) % n], w, m, s),
        lambda: ((w * m) * s) @ us[next(it) % n], "((w * m) * s) @ u")
    plain_ms = time_ms(
        lambda: fk.fedavg_agg_stale_plain(us[next(it) % n], w, m, s), 200)
    b_ms, b_by = bound(k * p * 4 + k * 12 + p * 4, 2 * k * p)
    print(f"[kernel] {label} route {which}: max_abs_err={err:.3g} (limit "
          f"{STALE_TOL:g}; NaN shared memory, two launches bit for bit) "
          f"all-ones s bitwise fedavg_agg_masked: yes ms={turns['loop']:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms((w*m*s)@u)="
          f"{turns['library_loop']:.5f} bound_ms={b_ms:.5f} ({b_by}); in "
          f"turns, {read}", flush=True)
    return dict(max_abs_err=err, ms=turns["loop"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=turns["library_loop"])


# The batch driver's scenario count on the card (paths 7-9 and the
# batched kernel checks), and the batch card-vs-CPU phase's.
BATCH_S = 16
CARD_CPU_BATCH_S = 3
FEDAVG_FORMS = {"fedavg_agg": "w", "fedavg_agg_masked": "w * m",
                "fedavg_agg_stale": "(w * m) * s"}


def fedavg_batch_inputs(torch, dev, s: int, k: int, p: int, n: int):
    """``n`` sets of (S, K, P) updates (inputs cycled past the L2) and one
    set of (S, K) weights, mask and staleness multiplier."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13 * p + s)
    us = [torch.randn((s, k, p), generator=gen, device=dev)
          for _ in range(n)]
    w = torch.softmax(torch.randn((s, k), generator=gen, device=dev), -1)
    m = (torch.rand((s, k), generator=gen, device=dev) < 0.7).float()
    tau = torch.randint(0, 5, (s, k), generator=gen, device=dev).float()
    return us, (w, m, (1.0 + tau) ** -0.5)


def scenario_bitwise(torch, dev, fn, args, label: str) -> None:
    """Each scenario of one batched launch of ``fn`` on ``args`` (leading
    (S,) axes) is bit for bit the launch on that scenario's rows alone,
    every launch after a NaN fill of shared memory."""
    from repro_torch.kernels import _check
    _check.fill_shared_memory(dev)
    batched = fn(*args)
    batched = batched if isinstance(batched, tuple) else (batched,)
    for i in range(args[0].shape[0]):
        _check.fill_shared_memory(dev)
        one = fn(*(a[i] for a in args))
        one = one if isinstance(one, tuple) else (one,)
        if not all(torch.equal(b[i], o) for b, o in zip(batched, one)):
            raise AssertionError(f"{label}: scenario {i} of the batched "
                                 f"launch differs from its single launch")


def phase_fedavg_batch(torch, dev, name: str, s: int, k: int, p: int
                       ) -> dict:
    """One FedAvg entry point on (S, K, P) updates: after a NaN fill of
    shared memory two batched launches bit for bit, each scenario bit for
    bit the single launch on its rows, within STALE_TOL of the plain
    version; timed in turns against the one ``torch.bmm`` call computing
    the same function, by host loop and by graph replay."""
    from repro_torch.kernels import fedavg_agg as fk
    fn = getattr(fk, name)
    plain = getattr(fk, f"{name}_plain")
    n = cycling(s * k * p * 4)
    us, rows = fedavg_batch_inputs(torch, dev, s, k, p, n)
    rows = rows[:{"fedavg_agg": 1, "fedavg_agg_masked": 2,
                  "fedavg_agg_stale": 3}[name]]
    label = f"{name} S={s} K={k} P={p}"
    _, err, which = fedavg_checked(torch, fn, (us[0],) + rows, plain, label)
    scenario_bitwise(torch, dev, fn, (us[0],) + rows, label)
    w = rows[0]
    for r in rows[1:]:
        w = w * r
    it = iter(range(10 ** 9))
    turns, read = in_turns(
        torch, lambda: fn(us[next(it) % n], *rows),
        lambda: torch.bmm(w[:, None, :], us[next(it) % n])[:, 0],
        f"bmm({FEDAVG_FORMS[name]})")
    plain_ms = time_ms(lambda: plain(us[next(it) % n], *rows), 50)
    b_ms, b_by = bound(s * k * p * 4 + len(rows) * s * k * 4 + s * p * 4,
                       2 * s * k * p)
    print(f"[kernel] {label} route {which}: max_abs_err={err:.3g} (limit "
          f"{STALE_TOL:g}; NaN shared memory, two launches bit for bit, "
          f"each scenario bit for bit its single launch) ms="
          f"{turns['loop']:.5f} (graph {turns['graph']:.5f}) plain_ms="
          f"{plain_ms:.5f} library_ms(bmm)={turns['library_loop']:.5f} "
          f"(graph {turns['library_graph']:.5f}) bound_ms={b_ms:.5f} "
          f"({b_by}; {b_ms / turns['graph']:.3f} of it by the graph); in "
          f"turns, {read}", flush=True)
    return dict(max_abs_err=err, ms=turns["loop"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=turns["library_loop"])


def phase_stream_scenarios(torch, dev, s: int, k: int, c: int) -> None:
    """stream_update at S scenarios: each scenario of one launch bit for
    bit the launch on its rows alone, after NaN fills."""
    from repro_torch.kernels import stream_update as su
    gen = torch.Generator(device=dev).manual_seed(SEED + 17 * s)
    h = torch.randint(0, 900, (s, k, c), generator=gen, device=dev).float()
    d = torch.poisson(torch.full((s, k, c), 2.0, device=dev), generator=gen)
    stale = torch.rand((s, k), generator=gen, device=dev) * 50.0
    sel = (torch.rand((s, k), generator=gen, device=dev) < 0.4).float()
    label = f"stream_update S={s} K={k} C={c}"
    scenario_bitwise(torch, dev, lambda *a: su.stream_update(
        *a, decay=0.8, size_cap=900.0), (h, d, d.sum(-1), stale, sel), label)
    print(f"[kernel] {label}: each scenario of the batched launch bit for "
          f"bit its single launch (NaN shared memory)", flush=True)


def phase_compress_batch(torch, dev, s: int, k: int, p: int) -> dict:
    """compress_update quant at S scenarios: the checks of
    ``compress_check``, each scenario of one launch bit for bit the launch
    on its rows alone, and the wrapper's time by host loop and by graph
    replay (inputs cycled past the L2)."""
    from repro_torch.kernels import compress as cu
    mode = "quant"
    err, widths, sel, kw = compress_check(torch, dev, mode, s, k, p)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19 * p)
    n = cycling(s * k * p * 12)
    sets = [compress_inputs(torch, gen, mode, s, k, p) for _ in range(n)]
    label = f"compress_update {mode} S={s} K={k} P={p}"
    u, r, noise = sets[0]
    scenario_bitwise(torch, dev, lambda *a: cu.compress_update(*a, **kw),
                     (u, r, widths, sel, noise), label)
    it = iter(range(10 ** 9))

    def call(fn):
        u, r, noise = sets[next(it) % n]
        return fn(u, r, widths, sel, noise, **kw)

    ms = time_ms(lambda: call(cu.compress_update), 50)
    graph = graph_ms(torch, lambda: call(cu.compress_update), 20)
    plain_ms = time_ms(lambda: call(cu.compress_update_plain), 3, warmup=1)
    b_ms, b_by = bound(20 * s * k * p + 8 * s * k,
                       s * k * p * QUANT_OPS_PER_COORD)
    print(f"[kernel] {label} route {cu.route(p)}: each scenario of the "
          f"batched launch bit for bit its single launch; ms={ms:.5f} (graph "
          f"{graph:.5f}) plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} "
          f"({b_by}; {b_ms / graph:.3f} of it by the graph)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# Flash attention at danube's head geometry.  f32 (both routes): within
# 1e-5 of the plain version (tests/test_kernels.py::_tol of the reference;
# sums in another order).  bf16 decode: each output within half a bf16 ulp
# of the plain version's f32 answer on the same input values, plus that
# 1e-5 -- what f32 arithmetic rounded to nearest once at the store gives;
# a store that truncates, or a bf16 intermediate, reads up to 2.  bf16
# prefill (tensor cores, p rounded to bf16 for p . v): (a) each output
# within half an ulp + 2**-8 of the softmax-weighted mean of |v| + 1e-5
# of the f32 answer (_check.bf16_prefill_ratio <= 1) and (b) the median
# of (got - want) sign(want) / half_ulp(want) within 0.25 of 0 (rounding
# to nearest reads about 0, truncation about -1).
FLASH_TOL = 1e-5
FLASH_BIAS_LIMIT = 0.25
# Peak rates for the operations bound: bf16 on the tensor cores (dense),
# f32 outside them.
PEAK_OPS = {"float32": F32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}
DANUBE_HEADS = dict(h=32, kv=8, hd=120)
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_WINDOW = 4, 5000, 32, 4096
# Edge shapes of the flash kernels, (b, sq, skv, h, kv, hd, kwargs): head
# widths 64, 120, 128, 160 (and 256); groups G = H / KV of 1, 2, 4, 5 (and
# 16, two decode blocks per KV head); Sq below 64 and not a multiple of
# 64; windows 33, 50 and 4096; kv_len < Skv; one query (decode), also
# with a cache shorter than the decode kernel's K ring at hd 120, where
# the mma's last k-step reads past each row.
FLASH_EDGES = [
    (2, 100, 100, 4, 4, 64, dict(causal=False, window=0)),
    (2, 77, 200, 4, 4, 128, dict(causal=False, window=0, kv_len=150)),
    (1, 300, 300, 8, 2, 160, dict(causal=True, window=50)),
    (1, 129, 129, 2, 1, 128, dict(causal=True, window=0)),
    (2, 200, 200, 8, 8, 64, dict(causal=True, window=33, kv_len=170)),
    (1, 40, 40, 10, 2, 120, dict(causal=True, window=0)),
    (2, 333, 333, 10, 2, 128, dict(causal=True, window=33)),
    (1, 250, 250, 5, 1, 160, dict(causal=True, window=0, kv_len=200)),
    (2, 50, 50, 4, 1, 64, dict(causal=True, window=0)),
    (1, 190, 190, 3, 3, 120, dict(causal=True, window=50)),
    (1, 130, 130, 2, 2, 160, dict(causal=False, window=0)),
    (1, 260, 260, 8, 2, 128, dict(causal=True, window=0)),
    (1, 2, 2, 4, 1, 120, dict(causal=True, window=0)),
    (1, 4500, 4500, 4, 1, 120, dict(causal=True, window=4096)),
    (3, 1, 77, 40, 8, 128, dict(causal=False, window=0, kv_len=61)),
    (2, 1, 300, 32, 8, 160, dict(causal=False, window=0)),
    (2, 1, 500, 32, 2, 128, dict(causal=False, window=0, kv_len=333)),
    (2, 1, 100, 6, 1, 256, dict(causal=False, window=0)),
    (2, 1, 96, 8, 2, 120, dict(causal=False, window=0, kv_len=70)),
    (1, 1, 40, 4, 1, 120, dict(causal=False, window=0)),
    # The query groups of paths 15-17 at hd 128: mixtral's G = 6 under
    # its 4096 window (Sq past it), jamba's G = 8, qwen3-moe's G = 16
    # (4 positions to a 64-row tile; Sq not a multiple of 64), and
    # decode at G = 8.
    (1, 4500, 4500, 6, 1, 128, dict(causal=True, window=4096)),
    (2, 300, 300, 16, 2, 128, dict(causal=True, window=0)),
    (1, 250, 250, 16, 1, 128, dict(causal=True, window=0, kv_len=230)),
    (2, 1, 500, 64, 8, 128, dict(causal=False, window=0, kv_len=450)),
    # Paths 18-19: whisper's hd 64 with one query head per KV head (G =
    # 1), non-causal, in cross-attention's prefill (64 decoder rows
    # against 1500 encoder frames) and the encoder's (1500 rows, not a
    # multiple of 64); its decode at G = 1 against the 1500-frame
    # encoder cache and against the 448-slot self-attention cache part
    # filled; qwen2-vl's G = 8 at hd 128, causal, Sq not a multiple of 64.
    (2, 64, 1500, 12, 12, 64, dict(causal=False, window=0)),
    (1, 1500, 1500, 12, 12, 64, dict(causal=False, window=0)),
    (4, 1, 1500, 12, 12, 64, dict(causal=False, window=0)),
    (4, 1, 448, 12, 12, 64, dict(causal=False, window=0, kv_len=97)),
    (1, 1000, 1000, 64, 8, 128, dict(causal=True, window=0)),
]
# The kernel phase's rows at the shapes of paths 15-19, by the kernels
# line's row names: (path, the timed shape (B, Sq, Skv, H, KV, hd), the
# checked shape, masks), all in bf16.  Paths 15-17's prefill is timed on
# one sequence of the prompt (the plain version's (H, S, S) f32 scores
# of four do not fit beside its softmax) and checked on one KV group, as
# path 6's; decode at jamba's cache after its last step.  Path 19's
# encoder prefill (16 clips of 1500 frames) and cross-attention decode
# (against those frames) at their whole shapes.  Each row's launches
# are its path's, by route.
PATH_FLASH = {
    "flash_attention_g6": (15, (1, 5120, 5120, 48, 8, 128),
                           (1, 5120, 5120, 6, 1, 128),
                           dict(causal=True, window=4096)),
    "flash_attention_g16": (16, (1, 5120, 5120, 64, 4, 128),
                            (1, 5120, 5120, 16, 1, 128),
                            dict(causal=True, window=0)),
    "flash_attention_g8": (17, (1, 5120, 5120, 64, 8, 128),
                           (1, 5120, 5120, 8, 1, 128),
                           dict(causal=True, window=0)),
    "flash_attention_decode_g8": (17, (4, 1, 5153, 64, 8, 128),
                                  (4, 1, 5153, 64, 8, 128),
                                  dict(causal=False, window=0)),
    "flash_attention_enc": (19, (16, 1500, 1500, 12, 12, 64),
                            (16, 1500, 1500, 12, 12, 64),
                            dict(causal=False, window=0)),
    "flash_attention_cross_decode": (19, (16, 1, 1500, 12, 12, 64),
                                     (16, 1, 1500, 12, 12, 64),
                                     dict(causal=False, window=0)),
}


def flash_inputs(torch, dev, gen, b, sq, skv, h, kv, hd, dtype, copies=1):
    """``copies`` sets of (q, k, v), each drawn in f32 and rounded."""
    out = []
    for _ in range(copies):
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev)
        k = torch.randn((b, skv, kv, hd), generator=gen, device=dev)
        v = torch.randn((b, skv, kv, hd), generator=gen, device=dev)
        out.append(tuple(t.to(dtype) for t in (q, k, v)))
    return out


def flash_check(torch, fa, q, k, v, label: str, **kw) -> float:
    """The kernel against its plain version (see FLASH_TOL); returns the
    max abs error against the plain version on the same inputs.  The
    plain version runs in f32 whatever the input type, so its f32 answer
    cast to the input type is its output.  The call must go through the
    kernel of its route.  Keys past ``kv_len`` are set to NaN and every
    SM's shared memory is filled with NaN just before the launch, so the
    output is finite only if the kernel reads neither."""
    from repro_torch.kernels import _check
    route = fa.route(q.dtype, q.shape[1])
    k = k.clone()
    k[:, kw.get("kv_len", k.shape[1]):] = float("nan")
    before = dict(fa.flash_attention.route_launches)
    _check.fill_shared_memory(q.device)
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    routed = {r: n - before[r]
              for r, n in fa.flash_attention.route_launches.items()}
    if routed != {r: int(r == route) for r in routed}:
        raise AssertionError(f"flash_attention {label}: launches {routed}, "
                             f"expected one through {route}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"flash_attention {label}: non-finite output "
                             f"after NaN shared memory and masked keys")
    err = float((got - want.to(q.dtype)).float().abs().max())
    if q.dtype == torch.float32:
        ok, read = err <= FLASH_TOL, f"(limit {FLASH_TOL:g})"
    elif route == "prefill_tc":
        want_abs_v = fa.flash_attention_plain(q.float(), k.float(),
                                              v.float().abs(), **kw)
        ratio = _check.bf16_prefill_ratio(got, want, want_abs_v, FLASH_TOL)
        bias = _check.bf16_rounding_bias(got, want)
        nz = want != 0
        mean = float(((got.float() - want) * torch.sign(want))[nz].div(
            _check.half_bf16_ulp(want)[nz]).mean())
        ok = ratio <= 1.0 and abs(bias) <= FLASH_BIAS_LIMIT
        read = (f"(bf16 plain output); against the f32 answer "
                f"{float((got.float() - want).abs().max()):.3g}, (a) worst "
                f"/ (half ulp + 2^-8 mean|v| + {FLASH_TOL:g}) = {ratio:.4f} "
                f"(limit 1), (b) median signed error in half ulps = "
                f"{bias:.4f} (limit +-{FLASH_BIAS_LIMIT:g}; the mean, "
                f"unused, {mean:.3f})")
    else:
        ratio = _check.bf16_rounding_ratio(got, want, FLASH_TOL)
        ok = ratio <= 1.0
        read = (f"(bf16 plain output); against the f32 answer "
                f"{float((got.float() - want).abs().max()):.3g}, worst / "
                f"(half bf16 ulp + {FLASH_TOL:g}) = {ratio:.4f} (limit 1)")
    print(f"[kernel] flash_attention {label} {tuple(q.shape)} x "
          f"{tuple(k.shape)} {q.dtype} {kw} route {route}: "
          f"max_abs_err={err:.3g} {read}", flush=True)
    if not ok:
        raise AssertionError(f"flash_attention {label}: {read}")
    return err


def flash_bound(q, k, pairs: int) -> tuple[float, str]:
    """Each input read once and the output written once; 4 hd flops per
    visible pair and head (q.k and p.v)."""
    b, _, h, hd = q.shape
    size = q.element_size()
    n_bytes = size * (2 * q.numel() + 2 * k.numel())
    n_ops = 4 * b * h * pairs * hd
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[str(q.dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_sdpa(torch, q, k, v, *, causal, window, kv_len):
    """The library call computing the same function: SDPA on (B, H, S,
    hd) copies, GQA by ``enable_gqa``, the window (or ``kv_len``) as an
    explicit mask, else ``is_causal``.  Returns a callable and its
    output in the model's layout."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sq, skv = q.shape[1], k.shape[1]
    mask = None
    if window > 0 or kv_len != skv:
        mask = fa.visible_mask(sq, skv, causal=causal, window=window,
                               kv_len=kv_len, device=q.device)

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True,
            is_causal=causal and mask is None)
    return call, call().transpose(1, 2)


_WARMUP_STREAMS: dict = {}


def graph_ms(torch, fn, calls: int) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one
    CUDA graph and replayed, so the host's per-call work (checks, tensor
    maps, the launch itself) is not counted.  The warm-up runs on one
    side stream per device for the whole process: a cuBLAS call on a new
    stream allocates a workspace that stays allocated."""
    dev = torch.cuda.current_device()
    if dev not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[dev] = torch.cuda.Stream()
    side = _WARMUP_STREAMS[dev]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / calls


def host_issue_us(torch, fn, calls: int) -> float:
    """Host time per call of issuing ``calls`` calls back to back (the
    device catches up after): what the wrapper and the launch cost the
    host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issue / calls * 1e6


def flash_timed(torch, fa, sets, label: str, **kw) -> dict:
    """Kernel, plain and SDPA ms of one shape (inputs cycled past L2).
    ``ms`` and ``library_ms`` time a host loop of back-to-back calls, as
    every other kernel's row does; printed beside them, the device times
    of the same calls replayed from a CUDA graph (no host work between
    launches) and the host's own time per call."""
    q, k, v = sets[0]
    n = len(sets)
    it = iter(range(10 ** 9))
    calls = 20 if q.shape[1] > 1 else 200

    def kernel():
        return fa.flash_attention(*sets[next(it) % n], **kw)
    ms = time_ms(kernel, calls)
    graph = graph_ms(torch, kernel, calls)
    host_us = host_issue_us(torch, kernel, calls)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2,
                       warmup=1)
    sdpa, sdpa_out = flash_sdpa(torch, q, k, v, **kw)
    sdpa_err = float((sdpa_out.float() - fa.flash_attention(q, k, v, **kw)
                      .float()).abs().max())
    library_ms = time_ms(sdpa, calls)
    library_graph = graph_ms(torch, sdpa, calls)
    library_host_us = host_issue_us(torch, sdpa, calls)
    pairs = fa.visible_pairs(q.shape[1], causal=kw["causal"],
                             window=kw["window"], kv_len=kw["kv_len"])
    b_ms, b_by = flash_bound(q, k, pairs)
    print(f"[kernel] flash_attention {label} {tuple(q.shape)} x "
          f"{tuple(k.shape)} {q.dtype} route "
          f"{fa.route(q.dtype, q.shape[1])}: ms={ms:.5f} (graph "
          f"{graph:.5f}; host {host_us:.2f} us per call) plain_ms="
          f"{plain_ms:.3f} library_ms(sdpa)={library_ms:.5f} (graph "
          f"{library_graph:.5f}; host {library_host_us:.2f} us per call; "
          f"sdpa vs kernel max diff {sdpa_err:.3g}) bound_ms={b_ms:.5f} "
          f"({b_by}; {pairs} visible pairs per head; {b_ms / ms:.3f} of it "
          f"by the host loop, {b_ms / graph:.3f} by the graph; "
          f"{library_ms / ms:.3f}x sdpa's speed by the host loop, "
          f"{library_graph / graph:.3f}x by the graph)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_flash(torch, dev) -> dict:
    """flash_attention against its plain version at the prefill (one KV
    group), decode and edge shapes in bf16 and f32; times at the path's
    prefill (B = 4) and decode shapes, and at paths 15-19's
    (``PATH_FLASH``).  Returns the rows of the kernels line: the bf16
    prefill (``flash_attention``, the tensor-core kernel), the bf16
    decode (``flash_attention_decode``) and the ``PATH_FLASH`` rows."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib = _build.library()
    for hd in range(8, fa.MAX_HEAD_DIM + 1, 8):
        if lib.flash_attention_tc_smem(hd) != fa.tc_smem_bytes(hd):
            raise AssertionError(f"prefill_tc smem mirror at hd {hd}")
    # Decode blocks per SM (the occupancy calculator's), which the CPU
    # tests of decode_splits assume; path 6's split gives every SM two.
    per_sm = {(grp, hd): lib.flash_attention_decode_blocks(1, grp, hd)
              for grp, hd in ((4, 120), (4, 64), (5, 128), (4, 128),
                              (4, 160))}
    print(f"[kernel] flash_attention decode blocks per SM, bf16 (G, hd): "
          f"{per_sm}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, _ = fa.decode_splits(SERVE_B, DANUBE_HEADS["kv"], SERVE_WINDOW,
                                 False, sms, 1, per_sm[(4, 120)])
    if SERVE_B * DANUBE_HEADS["kv"] * splits < 2 * sms:
        raise AssertionError(f"path 6 decode: {splits} splits at "
                             f"{per_sm[(4, 120)]} blocks per SM")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    h, kv, hd = DANUBE_HEADS["h"], DANUBE_HEADS["kv"], DANUBE_HEADS["hd"]
    s, w = SERVE_PROMPT, SERVE_WINDOW
    pre = dict(causal=True, window=w, kv_len=s)
    dec = dict(causal=False, window=0, kv_len=w)
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v), = flash_inputs(torch, dev, gen, 1, s, s, h // kv, 1, hd,
                                  dtype)
        errs[("prefill", dtype)] = flash_check(torch, fa, q, k, v,
                                               "(a) prefill, one KV group",
                                               **pre)
        (q, k, v), = flash_inputs(torch, dev, gen, SERVE_B, 1, w, h, kv, hd,
                                  dtype)
        errs[("decode", dtype)] = flash_check(torch, fa, q, k, v,
                                              "(b) decode", **dec)
        for b, sq, skv, hh, kvv, d, kw in FLASH_EDGES:
            (q, k, v), = flash_inputs(torch, dev, gen, b, sq, skv, hh, kvv, d,
                                      dtype)
            flash_check(torch, fa, q, k, v, "(c) edge", **kw)
        del q, k, v
        torch.cuda.empty_cache()
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.finfo(dtype).bits // 8
        n = cycling(size * SERVE_B * (s * h + 2 * s * kv) * hd)
        sets = flash_inputs(torch, dev, gen, SERVE_B, s, s, h, kv, hd, dtype,
                            n)
        rows[("prefill", dtype)] = flash_timed(torch, fa, sets,
                                               "(a) prefill, path 6 shape",
                                               **pre)
        del sets
        n = cycling(size * SERVE_B * 2 * w * kv * hd)
        sets = flash_inputs(torch, dev, gen, SERVE_B, 1, w, h, kv, hd, dtype,
                            n)
        rows[("decode", dtype)] = flash_timed(torch, fa, sets,
                                              "(b) decode, path 6 shape",
                                              **dec)
        del sets
        torch.cuda.empty_cache()
    # Paths 15-19's shapes (see PATH_FLASH).
    for name, (path, (b, sq, skv, hh, kvv, d), _, kw) in PATH_FLASH.items():
        n = cycling(2 * b * (sq * hh + 2 * skv * kvv) * d)
        sets = flash_inputs(torch, dev, gen, b, sq, skv, hh, kvv, d,
                            torch.bfloat16, n)
        rows[name] = flash_timed(torch, fa, sets, f"(e) {name}, path {path} "
                                 f"shape", kv_len=skv, **kw)
        del sets
        torch.cuda.empty_cache()
    # The wider head widths of the tensor-core prefill (stablelm-12b's 160,
    # and 256, where the kernel spills registers): timed, not in the line.
    for b, sq, hh, kvv, d in ((2, 4096, 32, 8, 160), (1, 2048, 8, 2, 256)):
        n = cycling(2 * b * (sq * hh + 2 * sq * kvv) * d)
        sets = flash_inputs(torch, dev, gen, b, sq, sq, hh, kvv, d,
                            torch.bfloat16, n)
        flash_timed(torch, fa, sets, f"(d) prefill, hd {d}", causal=True,
                    window=0, kv_len=sq)
        del sets
    # bf16 decode at path 6's heads over cache lengths: device time = a
    # fixed cost + bytes / rate (a least-squares line), beside SDPA's.
    lens, ours, sdpas, sizes = (512, 2048, 4096, 8192, 16384), [], [], []
    for w2 in lens:
        n = cycling(2 * SERVE_B * 2 * w2 * kv * hd)
        sets = flash_inputs(torch, dev, gen, SERVE_B, 1, w2, h, kv, hd,
                            torch.bfloat16, n)
        it = iter(range(10 ** 9))
        kw2 = dict(causal=False, window=0, kv_len=w2)
        ours.append(graph_ms(torch, lambda: fa.flash_attention(
            *sets[next(it) % n], **kw2), 50))
        sdpas.append(graph_ms(torch, flash_sdpa(torch, *sets[0], **kw2)[0],
                              50))
        sizes.append(2 * SERVE_B * 2 * w2 * kv * hd / 1e6)
        del sets
    for name, t in (("kernel", ours), ("sdpa", sdpas)):
        mx, my = sum(sizes) / len(sizes), sum(t) / len(t)
        slope = sum((x - mx) * (y - my) for x, y in zip(sizes, t)) / \
            sum((x - mx) ** 2 for x in sizes)
        print(f"[kernel] flash_attention decode sweep, {name}: ms "
              f"{[round(x, 5) for x in t]} at cache {list(lens)} slots "
              f"({[round(x, 2) for x in sizes]} MB): fixed "
              f"{(my - slope * mx) * 1e3:.2f} us + {slope * 1e3:.4f} us/MB "
              f"({1e-3 / slope:.3f} TB/s)", flush=True)
    splits = {key: n for key, n in fa._MAX_SPLITS.items()}
    print(f"[kernel] flash_attention decode cluster sizes chosen "
          f"(SMs, dtype, G, hd, clusters) -> splits: {splits}", flush=True)
    path_rows = {}
    for name, (path, _, shape, kw) in PATH_FLASH.items():
        (q, k, v), = flash_inputs(torch, dev, gen, *shape, torch.bfloat16)
        err = flash_check(torch, fa, q, k, v, f"(e) {name}, path {path}",
                          kv_len=k.shape[1], **kw)
        path_rows[name] = dict(rows[name], max_abs_err=err)
        del q, k, v
        torch.cuda.empty_cache()
    return {
        "flash_attention": dict(rows[("prefill", torch.bfloat16)],
                                max_abs_err=errs[("prefill", torch.bfloat16)]),
        "flash_attention_decode": dict(
            rows[("decode", torch.bfloat16)],
            max_abs_err=errs[("decode", torch.bfloat16)]),
        **path_rows,
    }


def _counters():
    from repro_torch.kernels import (compress, diversity, fedavg_agg,
                                     flash_attention, stream_update,
                                     sub2_pgd)
    return {"diversity": diversity.diversity_stats,
            "fedavg_agg": fedavg_agg.fedavg_agg,
            "sub2_pgd": sub2_pgd.sub2_pgd,
            "stream_update": stream_update.stream_update,
            "compress_update": compress.compress_update,
            "fedavg_agg_masked": fedavg_agg.fedavg_agg_masked,
            "fedavg_agg_stale": fedavg_agg.fedavg_agg_stale,
            "flash_attention": flash_attention.flash_attention}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0
        for route in getattr(fn, "route_launches", {}):
            fn.route_launches[route] = 0


def route_counts() -> str:
    """The launches of each kernel that has routes, by route."""
    return "; ".join(f"{name} {fn.route_launches}"
                     for name, fn in _counters().items()
                     if hasattr(fn, "route_launches"))


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def full_width_world(torch, dev):
    """The paper's scale: 1200 shards x 50 over K = 100 devices."""
    from repro_torch.core import wireless
    from repro_torch.data import partition, synthetic
    imgs, labels = synthetic.generate(SEED, samples_per_class=6000)
    data = partition.partition(
        imgs, labels, seed=SEED + 1,
        spec=partition.PartitionSpec(num_devices=100, num_shards=1200,
                                     shard_size=50))
    wcfg = wireless.WirelessConfig()
    net = wireless.sample_network(
        torch.Generator().manual_seed(SEED + 2), 100, wcfg)
    return data, net, wcfg


def path_config(path: int, codec: str = "quant", horizon: float = 0.0,
                cap: int = PATH4_CAP, events: int = ASYNC["num_events"],
                telemetry: bool = False) -> tuple[dict, dict]:
    """(FLConfig subsystem fields, SchedulerConfig extras) of a path.
    ``horizon``, ``cap`` and ``events`` shape paths 4 and 10, ``cap``
    path 8; ``telemetry`` turns every frame group on.  The batch paths
    7-10 take the configs of paths 1-4; path 8 adds a dispatch cap and
    the bf16 carry.  Path 11 is path 2 with telemetry."""
    from repro_torch import telemetry as tel
    from repro_torch.core import compression, events as ev, faults, \
        streaming
    if path in (1, 7):
        return ({"telemetry": tel.TelemetryConfig()} if telemetry else {},
                {})
    fl = dict(stream=streaming.StreamConfig(process="poisson"),
              faults=faults.FaultConfig(**FAULTS))
    if path == 8:
        fl.update(dispatch_cap=cap, carry_dtype="bfloat16")
    if path in (3, 9):
        fl["compression"] = compression.CompressionConfig(codec=codec,
                                                          bit_width=8)
    if path in (4, 10):
        fl.update(events=ev.EventConfig(**dict(ASYNC, tick_horizon=horizon,
                                               num_events=events)),
                  dispatch_cap=cap, carry_dtype="bfloat16")
    if path == 5:
        fl["events"] = ev.EventConfig()
    if telemetry or path == 11:
        fl["telemetry"] = tel.TelemetryConfig()
    return fl, dict(PATH2_SCHED)


def slice_configs(*, rounds, iterations_max, sub2, path=1, codec="quant",
                  **path_kw):
    from repro_torch.core import federated, scheduler
    fl, sched = path_config(path, codec, **path_kw)
    scfg = scheduler.SchedulerConfig(method="das", n_min=1,
                                     iterations_max=iterations_max,
                                     allocator="fused_pgd", sub2=sub2,
                                     **sched)
    fcfg = federated.FLConfig(num_rounds=rounds, local_epochs=1,
                              batch_size=50, learning_rate=0.05,
                              use_kernel_agg=True, **fl)
    return scfg, fcfg


def run_slice(torch, data, net, wcfg, *, rounds, iterations_max, sub2,
              device, draws=None, kind="cnn", path=1, codec="quant",
              **path_kw):
    """One run of a path through the user's entry point: ``(params,
    records)``, and the server buffer's log after them for path 4
    (``events.run_events``)."""
    from repro_torch.core import events, federated
    from repro_torch.models import paper_nets
    spec = paper_nets.PaperNetSpec(kind=kind)
    model = paper_nets.init(spec, torch.Generator().manual_seed(SEED + 3))
    scfg, fcfg = slice_configs(rounds=rounds, iterations_max=iterations_max,
                               sub2=sub2, path=path, codec=codec, **path_kw)
    entry = events.run_events if path == 4 else federated.run_federated
    return entry(model=model, data=data, net=net, wcfg=wcfg, scfg=scfg,
                 fcfg=fcfg, seed=SEED + 4, draws=draws, device=device)


def das_sync_line() -> str:
    """The DAS convergence test's source line (``bool(torch.any(
    changed))``), where the round's one host sync per outer iteration
    happens, for every lane of a batch at once."""
    path = os.path.join(ROOT, "src", "repro_torch", "core", "scheduler.py")
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if "if not bool(torch.any(changed)):" in line:
                return f"{os.path.relpath(path, ROOT)}:{n}"
    raise AssertionError("the DAS convergence test is gone")


def syncs_of(torch, fn):
    """The host syncs of ``fn()`` by source line, with PyTorch's CUDA
    sync debug mode -> (counter, fn's result)."""
    import collections
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return where, out


def count_syncs(torch, data, net, wcfg, dev, path: int, **kw):
    """The host syncs of one full-width run (set-up included) by source
    line -> (counter, records)."""
    from repro_torch.core import bandwidth
    where, out = syncs_of(torch, lambda: run_slice(
        torch, data, net, wcfg, iterations_max=6,
        sub2=bandwidth.Sub2Params(), device=dev, path=path, **kw))
    return where, out[1]


def report_syncs(torch, data, net, wcfg, dev, path: int, **path_kw):
    """Print one round's host syncs by source line.  For path 4 the
    count of 1 event and of 3 events: every sync the extra events add
    must be a DAS convergence test."""
    kw = dict(path_kw, events=1) if path == 4 else {}
    where, recs = count_syncs(torch, data, net, wcfg, dev, path, rounds=1,
                              **kw)
    what = "one event" if path == 4 else "one round"
    print(f"[syncs] path {path}, {what} ({recs[0].iterations} DAS "
          f"iterations): {sum(where.values())} host syncs: "
          f"{', '.join(f'{k} x{n}' for k, n in where.most_common())}",
          flush=True)
    if path != 4:
        return
    more, recs3 = count_syncs(torch, data, net, wcfg, dev, path, rounds=1,
                              **dict(path_kw, events=3))
    added = more - where
    das = das_sync_line()
    extra_iters = sum(r.iterations for r in recs3) - recs[0].iterations
    print(f"[syncs] path 4, 3 events: {sum(more.values())} host syncs; "
          f"the 2 more events add {dict(added)} ({extra_iters} more DAS "
          f"iterations)", flush=True)
    if set(added) - {das}:
        raise AssertionError(f"the event loop adds host syncs: {added}")


def expected_counts(path: int, rounds: int, das_iters: int) -> dict:
    """The launches of a path's run, by kernel.  Path 1 computes the
    label statistics once (diversity) and aggregates with fedavg_agg;
    paths 2-5 refresh them every round or event (stream_update, no
    diversity launch); path 2 aggregates the uploads that landed
    (fedavg_agg_masked); path 3 compresses every round (compress_update)
    and averages the decoded values with a plain product, as the
    reference does; the event paths 4 and 5 compute the buffer's flush
    every event (fedavg_agg_stale).  sub2_pgd runs once per DAS outer
    iteration."""
    want = dict.fromkeys(_counters(), 0)
    want["sub2_pgd"] = das_iters
    if path == 1:
        want.update(diversity=1, fedavg_agg=rounds)
        return want
    want["stream_update"] = rounds
    want[{2: "fedavg_agg_masked", 3: "compress_update", 4: "fedavg_agg_stale",
          5: "fedavg_agg_stale"}[path]] = rounds
    return want


def check_records(torch, recs, params, k: int) -> None:
    for r in recs:
        ok = (0.0 <= r.accuracy <= 1.0 and r.n_selected >= 1
              and 0 <= r.n_success <= r.n_selected
              and math.isfinite(r.round_time) and r.round_time > 0.0
              and math.isfinite(r.energy_total) and r.energy_total > 0.0
              and r.selected.shape == (k,))
        if not ok:
            raise AssertionError(f"bad round record {r}")
    check_params(torch, params)


def check_params(torch, params) -> None:
    for name, t in params.items():
        if not bool(torch.all(torch.isfinite(t))):
            raise AssertionError(f"non-finite parameter {name}")


def check_events(torch, recs, log, params, k: int, horizon: float,
                 cap: int) -> None:
    """An event run's records: evaluated every event, at most ``cap``
    devices dispatched, ticks of ``horizon`` seconds, a buffer log of
    one entry per event."""
    for r in recs:
        ok = (0.0 <= r.accuracy <= 1.0 and 0 <= r.n_selected <= cap
              and 0 <= r.n_success <= r.n_selected
              and r.round_time == float(torch.tensor(horizon))
              and math.isfinite(r.energy_total) and r.energy_total >= 0.0
              and r.selected.shape == (k,))
        if not ok:
            raise AssertionError(f"bad event record {r}")
    if not (len(log.flushed) == len(recs)
            and log.version[-1] == sum(log.flushed)):
        raise AssertionError(f"bad buffer log {log}")
    check_params(torch, params)


def print_events(recs, log, label: str) -> None:
    for r, fl, fill, tau in zip(recs, log.flushed, log.buffer_fill,
                                log.tau_mean):
        print(f"[{label}] event {r.round}: sel={r.n_selected:3d} "
              f"dropped={r.n_dropped:3d} landed={r.n_success:3d} "
              f"flushed={'yes' if fl else 'no '} fill={fill:3d} "
              f"mean_tau={tau:.3f} acc={r.accuracy:.4f} "
              f"E={r.energy_total:.4f}J das_iters={r.iterations}",
              flush=True)


def phase_path(torch, dev, data, net, wcfg, path: int, **path_kw):
    """One path at full width: its run with the launch counts checked,
    the same run again warm, its host syncs; path 3 adds a topk round.
    Returns ``(launch counts, records, warm wall per round)``."""
    from repro_torch.core import bandwidth
    rounds = ASYNC["num_events"] if path == 4 else 3
    kw = dict(rounds=rounds, iterations_max=6, sub2=bandwidth.Sub2Params(),
              device=dev, path=path, **path_kw)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_slice(torch, data, net, wcfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    routes = route_counts()
    params, recs = out[:2]
    # The same rounds again, warm: the first run of the process pays its
    # one-time set-up (CUDA context, cuDNN/cuBLAS initialisation and
    # algorithm choice, lazy kernel loading).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_slice(torch, data, net, wcfg, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    report_syncs(torch, data, net, wcfg, dev, path, **path_kw)
    unit = "round"
    if path == 4:
        unit = "event"
        log = out[2]
        print_events(recs, log, "path 4")
    else:
        for r in recs:
            print(f"[path {path}] round {r.round}: acc={r.accuracy:.4f} "
                  f"sel={r.n_selected:3d} ok={r.n_success:3d} "
                  f"T={r.round_time:.4f}s E={r.energy_total:.4f}J "
                  f"E/dev={r.energy_per_device:.4f}J "
                  f"das_iters={r.iterations}", flush=True)
    print(f"[path {path}] K={data.num_devices} cap={data.capacity} CNN, "
          f"{rounds} {unit}s: first run {wall:.3f}s, warm run {warm:.3f}s "
          f"= {warm / rounds:.3f}s per {unit}; launches {counts}", flush=True)
    print(f"[path {path}] launches by route: {routes}", flush=True)
    want = expected_counts(path, rounds, sum(r.iterations for r in recs))
    if counts != want:
        raise AssertionError(f"path {path} launch counts {counts}, "
                             f"expected {want}")
    if path == 4:
        check_events(torch, recs, log, params, data.num_devices,
                     path_kw["horizon"], PATH4_CAP)
        stale = [tau for fl, tau in zip(log.flushed, log.tau_mean)
                 if fl and tau > 0.0]
        dropped = sum(r.n_dropped for r in recs)
        print(f"[path 4] flushes {sum(log.flushed)}, of them with stale "
              f"updates (mean tau > 0) {len(stale)}; devices dropped by "
              f"the cap {dropped}; fedavg_agg_stale launches "
              f"{counts['fedavg_agg_stale']} for {rounds} events",
              flush=True)
        if not stale:
            raise AssertionError("path 4: no flush applied a stale update")
        if not dropped:
            raise AssertionError("path 4: the dispatch cap never bound")
        return counts, recs, warm / rounds
    check_records(torch, recs, params, data.num_devices)
    if path == 3:
        reset_counts()
        params, recs3 = run_slice(torch, data, net, wcfg, **dict(
            kw, rounds=1), codec="topk")
        got = read_counts()
        want = expected_counts(3, 1, recs3[0].iterations)
        print(f"[path 3] one topk round: acc={recs3[0].accuracy:.4f} "
              f"sel={recs3[0].n_selected} ok={recs3[0].n_success} "
              f"launches {got}; by route: {route_counts()}", flush=True)
        if got != want:
            raise AssertionError(f"topk launch counts {got}, expected "
                                 f"{want}")
        check_records(torch, recs3, params, data.num_devices)
        counts = dict(counts, compress_update_topk=got["compress_update"])
    return counts, recs, warm / rounds


@contextlib.contextmanager
def deterministic_algorithms(torch, label: str):
    """Deterministic algorithms on within ``with`` (cuDNN's deterministic
    convolutions; ``warn_only`` so an operation without a deterministic
    version warns instead of raising), the operations that warned
    printed after it."""
    import warnings
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.deterministic, cudnn.benchmark = saved[2], saved[3]
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    print(f"[{label}] deterministic algorithms on; operations without a "
          f"deterministic version: {nondet or 'none'}", flush=True)


def phase_sync_limit(torch, dev, data, net, wcfg) -> dict:
    """Path 5: path 2 with ``EventConfig()`` against path 2 on the card,
    3 rounds each, with deterministic algorithms switched on for this
    phase only (cuDNN's deterministic convolutions; ``warn_only`` so an
    operation without a deterministic version warns instead of raising,
    and the warnings are printed).  Selections, delivered counts, round
    times, energies and DAS iterations must be equal and the parameters
    bit for bit, else the largest difference is printed and the phase
    fails above 1e-6."""
    from repro_torch.core import bandwidth
    kw = dict(rounds=3, iterations_max=6, sub2=bandwidth.Sub2Params(),
              device=dev)
    with deterministic_algorithms(torch, "path 5"):
        p2, r2 = run_slice(torch, data, net, wcfg, path=2, **kw)
        reset_counts()
        p5, r5 = run_slice(torch, data, net, wcfg, path=5, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
    for a, b in zip(r2, r5):
        same = ((a.selected == b.selected).all()
                and (a.n_success, a.round_time, a.energy_total,
                     a.iterations, a.n_selected)
                == (b.n_success, b.round_time, b.energy_total,
                    b.iterations, b.n_selected))
        print(f"[path 5] round {a.round}: sync sel={a.n_selected} "
              f"ok={a.n_success} T={a.round_time!r} E={a.energy_total!r} "
              f"iters={a.iterations} | events sel={b.n_selected} "
              f"ok={b.n_success} T={b.round_time!r} E={b.energy_total!r} "
              f"iters={b.iterations}: {'equal' if same else 'DIFFER'}",
              flush=True)
        if not same:
            raise AssertionError(f"path 5 round {a.round} differs from "
                                 f"path 2")
    bitwise = all(torch.equal(p2[n], p5[n]) for n in p2)
    err = max(float((p2[n] - p5[n]).abs().max()) for n in p2)
    print(f"[path 5] parameters {'bit for bit equal' if bitwise else 'differ'}"
          f" to path 2's (max abs diff {err:.3g}); launches {counts}",
          flush=True)
    if not bitwise and not err <= 1e-6:
        raise AssertionError(f"path 5 params differ from path 2's by {err}")
    want = expected_counts(5, 3, sum(r.iterations for r in r5))
    if counts != want:
        raise AssertionError(f"path 5 launch counts {counts}, expected "
                             f"{want}")
    return counts


def same_records(a, b) -> bool:
    return bool((a.selected == b.selected).all()) and all(
        getattr(a, f) == getattr(b, f) for f in (
            "accuracy", "n_selected", "round_time", "energy_total",
            "n_success", "n_dropped", "iterations"))


def phase_telemetry(torch, dev, data, net, wcfg) -> None:
    """Path 11: path 2 with ``TelemetryConfig()`` (every group on), 3
    rounds at full width.  Against path 2 run beside it with
    deterministic algorithms on (for this check only): parameters and
    records bit for bit; no host sync per round beyond path 2's (a
    1-round run of each, by source line); every frame leaf finite,
    shaped ``(R, K)`` or ``(R,)``; the warm wall with telemetry on over
    off (in turns, with deterministic algorithms off);
    a JSONL log written by ``sinks.write_round_frames`` that ``python -m
    repro_torch.telemetry.report`` renders with exit code 0; the first
    path 11 run launches each kernel as often as path 2's."""
    from repro_torch.core import bandwidth
    from repro_torch.telemetry import sinks
    rounds, k = 3, data.num_devices
    kw = dict(rounds=rounds, iterations_max=6, sub2=bandwidth.Sub2Params(),
              device=dev)
    with deterministic_algorithms(torch, "path 11"):
        p2, r2 = run_slice(torch, data, net, wcfg, path=2, **kw)
        reset_counts()
        p11, r11, frames = run_slice(torch, data, net, wcfg, path=11, **kw)
        torch.cuda.synchronize()
        counts = read_counts()
    bitwise = all(torch.equal(p2[n], p11[n]) for n in p2) and all(
        same_records(a, b) for a, b in zip(r2, r11))
    # The warm wall in turns, deterministic algorithms off as on every
    # other path.
    walls = {2: [], 11: []}
    for path in (2, 11, 11, 2, 2, 11, 11, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_slice(torch, data, net, wcfg, path=path, **kw)
        torch.cuda.synchronize()
        walls[path].append((time.perf_counter() - t0) / rounds)
    print(f"[path 11] telemetry on: parameters and records "
          f"{'bit for bit' if bitwise else 'NOT'} equal to path 2's under "
          f"deterministic algorithms; warm wall per round in turns (off, "
          f"on, on, off, off, on, on, off): on "
          f"{[round(w, 4) for w in walls[11]]} s, off "
          f"{[round(w, 4) for w in walls[2]]} s; on / off of the medians "
          f"{median(walls[11]) / median(walls[2]):.3f}", flush=True)
    if not bitwise:
        raise AssertionError("path 11: telemetry changed the primary "
                             "outputs")
    want = expected_counts(2, rounds, sum(r.iterations for r in r11))
    if counts != want:
        raise AssertionError(f"path 11 launch counts {counts}, expected "
                             f"{want}")
    for name, t in frames.items():
        if tuple(t.shape) not in ((rounds, k), (rounds,)):
            raise AssertionError(f"path 11 frame {name} is "
                                 f"{tuple(t.shape)}")
        if not bool(torch.all(torch.isfinite(t.to(torch.float32)))):
            raise AssertionError(f"path 11 frame {name} is not finite")
    print(f"[path 11] {len(frames)} frame leaves, all finite, (R, K) or "
          f"(R,): {sorted(frames)}", flush=True)
    # Host syncs: the frames stay on the device until the caller copies
    # them, so a round with telemetry syncs where one without does.
    das = das_sync_line()
    off, r_off = count_syncs(torch, data, net, wcfg, dev, 2, rounds=1)
    on, r_on = count_syncs(torch, data, net, wcfg, dev, 11, rounds=1)
    print(f"[syncs] path 11, one round: {sum(on.values())} host syncs "
          f"({r_on[0].iterations} DAS iterations): "
          f"{', '.join(f'{n} x{c}' for n, c in on.most_common())}; path 2 "
          f"{sum(off.values())} ({r_off[0].iterations})", flush=True)
    if any(c > off.get(n, 0) for n, c in on.items() if n != das):
        raise AssertionError(f"path 11: telemetry adds host syncs {on} "
                             f"against {off}")
    scfg, fcfg = slice_configs(path=11, rounds=rounds, iterations_max=6,
                               sub2=kw["sub2"])
    log_dir = os.path.join(ROOT, "build", "telemetry")
    os.makedirs(log_dir, exist_ok=True)
    log = os.path.join(log_dir, "path11.jsonl")
    n = sinks.write_round_frames(log, frames,
                                 manifest=sinks.run_manifest(scfg, fcfg))
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.report", log],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    lines = rep.stdout.splitlines()
    print(f"[path 11] {n} round lines in {os.path.relpath(log, ROOT)}; "
          f"report exit code {rep.returncode}:", flush=True)
    for line in lines[:5] + [ln for ln in lines if ln.startswith(
            ("Jain", "divergence", "outer iterations"))]:
        print(f"[path 11]   {line}", flush=True)
    if rep.returncode != 0 or "== Round table ==" not in rep.stdout:
        raise AssertionError(f"path 11: the report failed: {rep.stderr}")


def phase_profile(torch, dev, data, net, wcfg, path: int, floor: dict,
                  run=None, what: str = "", **path_kw) -> None:
    """One more full-width round (path 4: its events; a batch path: the
    zero-argument ``run``, described by ``what``) under torch.profiler:
    per phase scope the host time and the device time of its kernels; the
    top kernels, the port's own with their device time a launch as a
    multiple of the launch floor's; the device's busy and idle share of
    the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import bandwidth
    scopes = ("schedule", "local_train", "aggregate", "evaluate")
    if path not in (1, 7):
        scopes += ("stream_refresh",)
    if run is None:
        def run():
            run_slice(torch, data, net, wcfg, rounds=1, iterations_max=6,
                      sub2=bandwidth.Sub2Params(), device=dev, path=path,
                      **path_kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_dev if e.name not in scopes
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Activity Buffer")]
    busy_us = sum(k.time_range.elapsed_us() for k in kernels)
    if busy_us <= 0:
        raise AssertionError("profiler recorded no device time")
    for scope in scopes:
        host = [e.time_range for e in events
                if e.name == scope and e.device_type == DeviceType.CPU]
        if not host:
            raise AssertionError(f"profiler saw no {scope!r} scope")
        # The profiler projects each record_function range onto the
        # device timeline; count the kernels that start inside it.
        spans = [e.time_range for e in on_dev if e.name == scope]
        inside = [k for k in kernels if any(
            r.start <= k.time_range.start <= r.end for r in spans)]
        host_ms = sum(r.elapsed_us() for r in host) / 1e3
        dev_ms = sum(k.time_range.elapsed_us() for k in inside) / 1e3
        print(f"[profile] path {path} {scope}: host {host_ms:.2f} ms, "
              f"kernels on the device {dev_ms:.2f} ms in {len(inside)} "
              f"launches", flush=True)
    by_name: dict = {}
    for k in kernels:
        tot, n = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (tot + k.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda x: -x[1][0])[:10]
    for name, (tot, n) in top:
        print(f"[profile] path {path} device {tot / 1e3:8.3f} ms  launches "
              f"{n:5d}  {name[:80]}", flush=True)
    # The port's own kernels, by their __global__ names: device time per
    # launch inside the run (the kernel phase's back-to-back timing of a
    # tiny kernel measures the host's launch rate instead).
    for kname in ("diversity_kernel", "sub2_pgd_warp_kernel",
                  "sub2_pgd_block_kernel", "fedavg_agg_kernel",
                  "stream_update_kernel", "compress_onchip_kernel",
                  "compress_stream_kernel", "fedavg_agg_masked_kernel",
                  "fedavg_agg_stale_kernel"):
        hits = [(tot, n) for name, (tot, n) in by_name.items()
                if f"::{kname}(" in name or f"::{kname}<" in name]
        if hits:
            tot, n = map(sum, zip(*hits))
            print(f"[profile] path {path} {kname}: {n} launches, device "
                  f"{tot / n / 1e3:.5f} ms per launch = "
                  f"{tot / n / 1e3 / floor['device']:.2f}x the launch "
                  f"floor's", flush=True)
    what = what or (f"{ASYNC['num_events']}-event run_events" if path == 4
                    else "1-round run_federated")
    print(f"[profile] path {path} {what} at full width "
          f"(set-up included): wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms in {len(kernels)} kernels and copies, "
          f"idle share {1.0 - busy_us / wall_us:.3f}", flush=True)


# Card-vs-CPU parameter limits by path: f32 convolutions and matmuls in
# another order (cuDNN vs CPU) over a few SGD steps at lr 0.05; path 3's
# topk keeps a coordinate whose magnitude sits at the threshold on one
# side and not the other when the two updates differ in the last bits,
# which moves that coordinate by its whole value; path 4 stores the
# pending updates in bf16 between events, so a value whose card and CPU
# results straddle a bf16 rounding boundary lands one bf16 ulp (2^-8
# relative) apart when its stale update is flushed.
CARD_CPU_PARAM_TOL = {1: 1e-4, 2: 1e-4, 3: 1e-3, 4: 1e-3}
# Path 4 at K = 16: a cap that binds there.
CARD_CPU_CAP = 4
# The batch paths' card-vs-CPU parameter limit (K = 16, S = 3, the CNN,
# 2 rounds): the CNN trainer's limit against the reference on the CPU
# (tests/test_torch_federated.py).  Scenario 1 of this world meets a
# near-tie of the CNN (a max pool or ReLU decision) in its second round
# that last-bit differences of the convolutions decide, run to run on
# the card: two runs of this phase on one tree read 1.2e-7 and 2.8e-3
# there.
BATCH_CARD_CPU_PARAM_TOL = 5e-3
# Path 10 (the event batch, K = 16, S = 3, 6 events) shares the batch
# paths' limit, for another reason: its bf16 carry stores each pending
# update in bf16, so a coordinate whose card and CPU values straddle a
# bf16 rounding boundary is flushed one bf16 ulp (2^-8 relative) apart,
# and the next events train on the flushed model.  Scenario 2 reads
# 1.88e-3, the same on every card run; the same run with an f32 carry
# reads 2.03e-5 and is held too, at paths 1-2's 1e-4.
EVENT_BATCH_F32_PARAM_TOL = 1e-4


def phase_card_vs_cpu(torch, dev, path: int, horizon: float = 0.0):
    """K = 16, 2 rounds (path 4: its 6 events at ``horizon``), one tape,
    TF32 off: card and CPU must agree.  Returns the card's records."""
    from repro_torch.core import bandwidth, federated, wireless
    from repro_torch.data import partition, synthetic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k, rounds, codec = 16, 2, "topk"
    imgs, labels = synthetic.generate(SEED, samples_per_class=600)
    data = partition.partition(
        imgs, labels, seed=SEED + 1,
        spec=partition.PartitionSpec(num_devices=k, num_shards=100,
                                     shard_size=50))
    wcfg = wireless.WirelessConfig()
    gen = torch.Generator().manual_seed(SEED + 2)
    net = wireless.sample_network(gen, k, wcfg)
    sub2 = bandwidth.Sub2Params.fast()
    path_kw = dict(horizon=horizon, cap=CARD_CPU_CAP) if path == 4 else {}
    _, fcfg = slice_configs(rounds=rounds, iterations_max=4, sub2=sub2,
                            path=path, codec=codec, **path_kw)
    draws = federated.draw_tape(
        gen, net, federated.sim_length(fcfg), data.capacity,
        federated._max_local_steps(fcfg, data.capacity), 50, fcfg,
        federated.client_histograms(data, fcfg.num_classes))
    out = {}
    for device in (dev, "cpu"):
        out[str(device)] = run_slice(torch, data, net, wcfg, rounds=rounds,
                                     iterations_max=4, sub2=sub2,
                                     device=device, draws=draws, path=path,
                                     codec=codec, **path_kw)
    (p_gpu, r_gpu), (p_cpu, r_cpu) = out[str(dev)][:2], out["cpu"][:2]
    if path == 4:
        log_gpu, log_cpu = out[str(dev)][2], out["cpu"][2]
        print(f"[card-vs-cpu] path 4 flushes card {log_gpu.flushed} CPU "
              f"{log_cpu.flushed}; dropped "
              f"{[r.n_dropped for r in r_gpu]}", flush=True)
        if log_gpu.flushed != log_cpu.flushed:
            raise AssertionError("path 4: card and CPU flush on other "
                                 "events")
    for a, b in zip(r_gpu, r_cpu):
        if not (a.selected == b.selected).all() or \
                a.iterations != b.iterations or a.n_success != b.n_success:
            raise AssertionError(
                f"path {path} round {a.round}: card selects {a.selected} "
                f"in {a.iterations} iters ({a.n_success} delivered), CPU "
                f"{b.selected} in {b.iterations} ({b.n_success})")
        if path == 4:
            print(f"[card-vs-cpu] path 4 event {a.round}: sel equal "
                  f"({a.n_selected}), iters {a.iterations}, landed "
                  f"{a.n_success}, E {a.energy_total:.6f}/"
                  f"{b.energy_total:.6f}", flush=True)
            continue
        j_a = 0.5 * a.energy_total + 0.5 * a.round_time
        j_b = 0.5 * b.energy_total + 0.5 * b.round_time
        print(f"[card-vs-cpu] path {path} round {a.round}: sel equal, "
              f"iters {a.iterations}, delivered {a.n_success}, E "
              f"{a.energy_total:.6f}/{b.energy_total:.6f} T "
              f"{a.round_time:.6f}/{b.round_time:.6f} Sub2 objective rel "
              f"diff {abs(j_a - j_b) / j_b:.2e}", flush=True)
        # Same Sub2 objective: the descent lands on the same optimum even
        # where the flat valley lets E and T trade off.
        if not abs(j_a - j_b) <= 1e-4 * j_b:
            raise AssertionError(f"path {path} round {a.round}: Sub2 "
                                 f"objective {j_a} vs {j_b}")
    err = max(float((p_gpu[n].cpu() - p_cpu[n]).abs().max())
              for n in p_cpu)
    tol = CARD_CPU_PARAM_TOL[path]
    print(f"[card-vs-cpu] path {path} final params max abs diff {err:.3g} "
          f"(limit {tol:g})", flush=True)
    if not err <= tol:
        raise AssertionError(f"path {path}: card and CPU params differ by "
                             f"{err}")
    return r_gpu


# The batch paths and the single path each repeats at S scenarios.
BATCH_OF = {7: 1, 8: 2, 9: 3, 10: 4}


def batch_networks(s: int, k: int, wcfg):
    """Scenario ``i``'s network from global index ``i``."""
    from repro_torch.core import wireless
    return wireless.sample_networks_indexed(SEED + 2, range(s), k, wcfg)


def run_batch(torch, data, nets, wcfg, *, rounds, iterations_max, sub2,
              device, path, draws=None, codec="quant", log=False,
              **path_kw):
    """One batch path's run through ``run_federated_batch``: ``(params,
    metrics[, frames])``, the metrics ``(S, R, ...)``; with ``log`` (an
    event batch) through ``events.run_events`` for the buffer's log after
    the metrics."""
    from repro_torch.core import events, federated
    from repro_torch.models import paper_nets
    spec = paper_nets.PaperNetSpec(kind="cnn")
    model = paper_nets.init(spec, torch.Generator().manual_seed(SEED + 3))
    scfg, fcfg = slice_configs(rounds=rounds, iterations_max=iterations_max,
                               sub2=sub2, path=path, codec=codec, **path_kw)
    s = nets.pathloss.shape[0]
    seeds = federated.scenario_seeds(SEED + 4, 0, s)
    kw = dict(model=model, data=data, wcfg=wcfg, scfg=scfg, fcfg=fcfg,
              draws=draws, device=device)
    if log:
        return events.run_events(net=nets, seed=seeds, **kw)
    return federated.run_federated_batch(nets=nets, seeds=seeds, **kw)


def expected_batch_counts(path: int, rounds: int, iterations) -> dict:
    """A batch path's launches: its single path's, whatever S is, with
    ``sub2_pgd`` once per DAS outer iteration of the slowest lane (every
    lane runs each outer iteration; ``iterations`` (S, R))."""
    slowest = int(iterations.max(dim=0).values.sum())
    return expected_counts(BATCH_OF[path], rounds, slowest)


def check_batch(torch, metrics, params, k: int, cap: int = 0,
                horizon: float = 0.0) -> None:
    """Every scenario's records sound (an event batch's as
    ``check_events`` holds a single event run's: ticks of ``horizon``
    seconds, at most ``cap`` devices dispatched), every parameter
    finite."""
    from repro_torch.core import federated
    for recs in federated.batch_metrics_to_records(metrics):
        for r in recs:
            if horizon > 0.0:
                ok = (0.0 <= r.accuracy <= 1.0 and 0 <= r.n_selected <= cap
                      and 0 <= r.n_success <= r.n_selected
                      and r.round_time == float(torch.tensor(horizon))
                      and math.isfinite(r.energy_total)
                      and r.energy_total >= 0.0 and r.selected.shape == (k,))
                if not ok:
                    raise AssertionError(f"bad batch event record {r}")
                continue
            ok = (0.0 <= r.accuracy <= 1.0 and r.n_selected >= 1
                  and 0 <= r.n_success <= r.n_selected
                  and (not cap or r.n_selected <= cap)
                  and math.isfinite(r.round_time) and r.round_time > 0.0
                  and math.isfinite(r.energy_total) and r.energy_total > 0.0
                  and r.selected.shape == (k,))
            if not ok:
                raise AssertionError(f"bad batch round record {r}")
    check_params(torch, params)


def batch_syncs(torch, data, wcfg, dev, path: int, s: int, **path_kw):
    """A 1-round (path 10: 1-event) batch run's host syncs by source
    line, and its slowest lane's DAS outer iterations."""
    from repro_torch.core import bandwidth
    if path == 10:
        path_kw = dict(path_kw, events=1)
    where, (_, metrics) = syncs_of(torch, lambda: run_batch(
        torch, data, batch_networks(s, data.num_devices, wcfg), wcfg,
        rounds=1, iterations_max=6, sub2=bandwidth.Sub2Params(),
        device=dev, path=path, **path_kw))
    return where, int(metrics.iterations.max())


def phase_batch_path(torch, dev, data, wcfg, path: int,
                     single_wall: float, **path_kw) -> tuple:
    """A batch path at full width (S = BATCH_S scenarios of K = 100, the
    CNN, 3 rounds; path 10 path 4's 6 events at ``path_kw``'s horizon):
    the run with its launch counts checked (each kernel as often as in
    the single path's round or event), the same run again warm beside
    the single path's warm wall per round (event) from this call, peak
    memory, the host syncs of a 1-round (1-event) batch at S = BATCH_S
    against S = 1.  Returns ``(launch counts, metrics, warm wall per
    batch round or event)``."""
    from repro_torch.core import bandwidth, federated
    events = path == 10
    rounds = ASYNC["num_events"] if events else 3
    unit = "event" if events else "round"
    k = data.num_devices
    nets = batch_networks(BATCH_S, k, wcfg)
    kw = dict(rounds=rounds, iterations_max=6, sub2=bandwidth.Sub2Params(),
              device=dev, path=path, **path_kw)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, metrics = run_batch(torch, data, nets, wcfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = read_counts(), route_counts()
    del params
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, metrics = run_batch(torch, data, nets, wcfg, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cap = PATH4_CAP if path in (8, 10) else 0
    check_batch(torch, metrics, params, k, cap, path_kw.get("horizon", 0.0))
    recs = federated.batch_metrics_to_records(metrics)
    for r in range(rounds):
        accs = [rs[r].accuracy for rs in recs]
        print(f"[path {path}] {unit} {r}: acc mean "
              f"{sum(accs) / len(accs):.4f} (min {min(accs):.4f}, max "
              f"{max(accs):.4f}) sel {[rs[r].n_selected for rs in recs]} ok "
              f"{[rs[r].n_success for rs in recs]} dropped "
              f"{sum(rs[r].n_dropped for rs in recs)} das_iters "
              f"{[rs[r].iterations for rs in recs]}", flush=True)
    per_round = warm / rounds
    what = {8: ", cap 16, bf16 carry", 10: ", events, cap 16, bf16 carry"}
    print(f"[path {path}] S={BATCH_S} x K={k} CNN (path "
          f"{BATCH_OF[path]}'s config{what.get(path, '')}), {rounds} "
          f"{unit}s: first run {wall:.3f}s, warm run {warm:.3f}s "
          f"= {per_round:.3f}s per batch {unit} = "
          f"{per_round / BATCH_S:.4f}s per scenario-{unit}, against path "
          f"{BATCH_OF[path]}'s {single_wall:.3f}s per {unit} in this call "
          f"({single_wall / (per_round / BATCH_S):.2f}x the scenario-"
          f"{unit}s per second); peak memory {peak:.2f} GiB; launches "
          f"{counts}", flush=True)
    per_batch_round = {name: n / rounds for name, n in counts.items()}
    print(f"[path {path}] launches per batch {unit} {per_batch_round}; by "
          f"route over the run: {routes}", flush=True)
    want = expected_batch_counts(path, rounds, metrics.iterations)
    if counts != want:
        raise AssertionError(f"path {path} launch counts {counts}, "
                             f"expected {want}")
    # Host syncs: S scenarios add none beyond the slowest lane's extra
    # DAS convergence tests.
    das = das_sync_line()
    many, it_many = batch_syncs(torch, data, wcfg, dev, path, BATCH_S,
                                **path_kw)
    one, it_one = batch_syncs(torch, data, wcfg, dev, path, 1, **path_kw)
    print(f"[syncs] path {path}, one batch {unit}: S={BATCH_S} "
          f"{sum(many.values())} host syncs ({it_many} DAS iterations in "
          f"the slowest lane): {', '.join(f'{n} x{c}' for n, c in many.most_common())}"
          f"; S=1 {sum(one.values())} ({it_one}): "
          f"{', '.join(f'{n} x{c}' for n, c in one.most_common())}",
          flush=True)
    other_many = {n: c for n, c in many.items() if n != das}
    other_one = {n: c for n, c in one.items() if n != das}
    if any(c > other_one.get(n, 0) for n, c in other_many.items()):
        raise AssertionError(f"path {path}: the batch adds host syncs "
                             f"{other_many} against S=1's {other_one}")
    if events:
        batch_event_frames(torch, data, nets, wcfg, metrics, **kw)
    return counts, metrics, per_round


def batch_event_frames(torch, data, nets, wcfg, metrics, **kw) -> None:
    """Path 10 once more, with telemetry on and through
    ``events.run_events`` for the buffer's log: the primary outputs equal
    the run without telemetry (selections, counts, DAS iterations), the
    event leaves are ``(S, E, K)`` (``(S, E)`` for the scalars) and agree
    with the log, some flush applies a stale update, the scenarios flush
    on other events and the cap binds."""
    params, metrics_t, log, frames = run_batch(torch, data, nets, wcfg,
                                               telemetry=True, log=True,
                                               **kw)
    for name in ("selected", "n_success", "n_dropped", "iterations"):
        if not torch.equal(getattr(metrics, name), getattr(metrics_t, name)):
            raise AssertionError(f"path 10: telemetry changed {name}")
    s, e, k = metrics.selected.shape
    for name in ("avail", "free", "in_flight", "staleness_tau"):
        if tuple(frames[name].shape) != (s, e, k):
            raise AssertionError(f"path 10 frame {name} is "
                                 f"{tuple(frames[name].shape)}")
    for name in ("buffer_fill", "flushed", "clock", "model_version"):
        if tuple(frames[name].shape) != (s, e):
            raise AssertionError(f"path 10 frame {name} is "
                                 f"{tuple(frames[name].shape)}")
    flushed = frames["flushed"].cpu()
    if flushed.tolist() != [[float(f) for f in fl] for fl in log.flushed]:
        raise AssertionError("path 10: the frames' flushes are not the "
                             "buffer log's")
    stale = [tau for fl, taus in zip(log.flushed, log.tau_mean)
             for f, tau in zip(fl, taus) if f and tau > 0.0]
    dropped = int(metrics.n_dropped.sum())
    print(f"[path 10] telemetry on: event leaves {(s, e, k)}, frames "
          f"{len(frames)} leaves; flushes by scenario "
          f"{[sum(fl) for fl in log.flushed]}, distinct flush patterns "
          f"{len({tuple(fl) for fl in log.flushed})}, flushes with stale "
          f"updates {len(stale)}; devices dropped by the cap {dropped}",
          flush=True)
    if not stale:
        raise AssertionError("path 10: no flush applied a stale update")
    if not dropped:
        raise AssertionError("path 10: the dispatch cap never bound")
    check_params(torch, params)


class Sub2Log:
    """Within ``with``: every ``fused_pgd`` solve's ``(selection, alpha)``
    rows, on the host, in call order (one call per DAS outer iteration,
    every lane of a batch in each), and in ``self.inputs`` each call's
    ``(t_train, gains, tx_power, alpha0)``, on the host too."""

    def __enter__(self):
        from repro_torch.core import allocator
        self.calls, self.inputs, self._cls = [], [], allocator.FusedPGD
        self._solve = solve = self._cls.solve

        def logged(alloc, selected, *args, **kw):
            out = solve(alloc, selected, *args, **kw)
            self.calls.append((selected.cpu(), out[0].cpu()))
            a0 = kw.get("alpha0")
            self.inputs.append(tuple(t.cpu() for t in args[:3])
                               + (None if a0 is None else a0.cpu(),))
            return out
        self._cls.solve = logged
        return self

    def __exit__(self, *exc):
        self._cls.solve = self._solve


def lane_trace(calls, iterations, lane: int, rnd: int):
    """Lane ``lane``'s ``(selection, alpha)`` after each outer iteration
    of round ``rnd``, from a run's ``Sub2Log`` calls and its (S, R)
    iteration counts: round r holds as many calls as its slowest lane's
    iterations."""
    start = int(iterations.max(dim=0).values[:rnd].sum())
    n = int(iterations[lane, rnd])
    return [(x[lane], a[lane]) for x, a in calls[start:start + n]]


def explain_iterations(label: str, trace_gpu, trace_cpu, k: int,
                       x_tol: float, alpha_tol: float) -> None:
    """A lane whose DAS outer iterations differ between the card and the
    CPU: pass only if the two runs part at a convergence test decided by
    the allocation alone (the same selections up to it, each unchanged by
    it) and the card's allocations lie within SUB2_ALPHA_TOL of the CPU's
    up to it, so the gap is sub2_pgd's own against its plain version
    meeting DAS's finer alpha_tol.  Prints the numbers."""
    m = min(len(trace_gpu), len(trace_cpu))
    start = (trace_gpu[0][0].new_ones(k),
             trace_gpu[0][1].new_full((k,), 1.0 / k))
    gpu, cpu = [start] + trace_gpu[:m], [start] + trace_cpu[:m]
    same_x = all(bool((a[0] == b[0]).all()) for a, b in zip(gpu, cpu))
    gaps = [float((a[1] - b[1]).abs().max()) for a, b in zip(gpu, cpu)]

    def moves(tr):
        return (float((tr[m][0] - tr[m - 1][0]).abs().sum()),
                float((tr[m][1] - tr[m - 1][1]).abs().max()))
    (dx_g, da_g), (dx_c, da_c) = moves(gpu), moves(cpu)
    print(f"[card-vs-cpu] {label}: outer iterations card {len(trace_gpu)}, "
          f"CPU {len(trace_cpu)}; at the test after iteration {m} the "
          f"allocation moved by {da_g:.4e} on the card and {da_c:.4e} on "
          f"the CPU (alpha_tol {alpha_tol:g}), the selection by {dx_g:g} / "
          f"{dx_c:g}; card-vs-CPU alpha gap by iteration "
          f"{', '.join(f'{g:.3e}' for g in gaps[1:])} (limit "
          f"{SUB2_ALPHA_TOL:g})", flush=True)
    if not (same_x and dx_g < x_tol and dx_c < x_tol
            and max(gaps) <= SUB2_ALPHA_TOL
            and (da_g >= alpha_tol) != (da_c >= alpha_tol)):
        raise AssertionError(f"{label}: the DAS iteration counts differ "
                             f"for another reason than the allocation's "
                             f"convergence test")


def phase_batch_card_vs_cpu(torch, dev, path: int,
                            horizon: float = 0.0) -> None:
    """A batch path at K = 16, S = CARD_CPU_BATCH_S, 2 rounds, on the
    card and on the CPU from one tape (``draw_tapes``), TF32 off (path 9
    with topk and paths 8 and 10 with a cap of CARD_CPU_CAP, as phase 6
    runs paths 3 and 4; path 10 its 6 events at ``horizon`` with
    telemetry on): per scenario equal selections, DAS iterations (unless
    ``explain_iterations`` finds the split decided by the allocation's
    convergence test within sub2_pgd's tolerance), delivered and dropped
    counts, the same Sub2 objective (not paths 8 and 10, see below),
    close parameters; path 10 also equal flushes, every event-frame
    leaf equal in its masks and within EVENT_FRAME_TOL in its floats, and
    the same run with an f32 carry within EVENT_BATCH_F32_PARAM_TOL."""
    from repro_torch.core import bandwidth, federated, wireless
    from repro_torch.data import partition, synthetic
    from repro_torch.models import paper_nets
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k, s, rounds, codec = 16, CARD_CPU_BATCH_S, 2, "topk"
    imgs, labels = synthetic.generate(SEED, samples_per_class=600)
    data = partition.partition(
        imgs, labels, seed=SEED + 1,
        spec=partition.PartitionSpec(num_devices=k, num_shards=100,
                                     shard_size=50))
    wcfg = wireless.WirelessConfig()
    nets = batch_networks(s, k, wcfg)
    sub2 = bandwidth.Sub2Params.fast()
    path_kw = dict(cap=CARD_CPU_CAP) if path in (8, 10) else {}
    if path == 10:
        path_kw.update(horizon=horizon, telemetry=True)
    scfg, fcfg = slice_configs(rounds=rounds, iterations_max=4, sub2=sub2,
                               path=path, codec=codec, **path_kw)
    model = paper_nets.init(paper_nets.PaperNetSpec(kind="cnn"),
                            torch.Generator().manual_seed(SEED + 3))
    draws = federated.draw_tapes(
        federated.scenario_seeds(SEED + 4, 0, s), nets,
        federated.sim_length(fcfg),
        data.capacity, federated._max_local_steps(fcfg, data.capacity), 50,
        fcfg, federated.client_histograms(data, fcfg.num_classes),
        federated.flat_param_size(paper_nets.params_of(model)))
    out, logs = {}, {}
    for device in (dev, "cpu"):
        with Sub2Log() as log:
            out[str(device)] = run_batch(
                torch, data, nets, wcfg, rounds=rounds, iterations_max=4,
                sub2=sub2, device=device, path=path, draws=draws,
                codec=codec, **path_kw)
        logs[str(device)] = log.calls
    (p_gpu, m_gpu), (p_cpu, m_cpu) = out[str(dev)][:2], out["cpu"][:2]
    if path == 10:
        event_frames_agree(torch, out[str(dev)][2], out["cpu"][2])
    r_gpu = federated.batch_metrics_to_records(m_gpu)
    r_cpu = federated.batch_metrics_to_records(m_cpu)
    for i in range(s):
        for a, b in zip(r_gpu[i], r_cpu[i]):
            if a.iterations != b.iterations:
                explain_iterations(
                    f"path {path} scenario {i} round {a.round}",
                    lane_trace(logs[str(dev)], m_gpu.iterations.cpu(), i,
                               a.round),
                    lane_trace(logs["cpu"], m_cpu.iterations, i, a.round),
                    k, scfg.x_tol, scfg.alpha_tol)
            if not (a.selected == b.selected).all() or \
                    (a.n_success, a.n_dropped) != (b.n_success, b.n_dropped):
                raise AssertionError(
                    f"path {path} scenario {i} round {a.round}: card "
                    f"selects {a.selected} in {a.iterations} iters "
                    f"({a.n_success} delivered, {a.n_dropped} dropped), "
                    f"CPU {b.selected} in {b.iterations} ({b.n_success}, "
                    f"{b.n_dropped})")
            j_a = 0.5 * a.energy_total + 0.5 * a.round_time
            j_b = 0.5 * b.energy_total + 0.5 * b.round_time
            d_e = abs(a.energy_total - b.energy_total) / b.energy_total \
                if b.energy_total else abs(a.energy_total)
            d_t = abs(a.round_time - b.round_time) / b.round_time
            print(f"[card-vs-cpu] path {path} scenario {i} round {a.round}: "
                  f"sel equal ({a.n_selected}), iters {a.iterations}, "
                  f"delivered {a.n_success}, dropped {a.n_dropped}, record "
                  f"objective rel diff {abs(j_a - j_b) / j_b:.2e} (E "
                  f"{d_e:.2e}, T {d_t:.2e})", flush=True)
            # Path 8's binding cap prices the round on the capped set at
            # the shares Sub2 chose for the whole selection, so its record
            # is not the Sub2 objective: the card's and the CPU's moves
            # along the objective's flat valley show in it (2.4e-3, T
            # 5.1e-3 in scenario 0, round 1).  As phase 6 does for its
            # capped path 4, the record is printed, not held; so for path
            # 10, whose T is the tick.
            if path not in (8, 10) and not abs(j_a - j_b) <= 1e-4 * j_b:
                raise AssertionError(f"path {path} scenario {i} round "
                                     f"{a.round}: Sub2 objective {j_a} vs "
                                     f"{j_b}")
    errs = [max(float((p_gpu[n][i].cpu() - p_cpu[n][i]).abs().max())
                for n in p_cpu) for i in range(s)]
    err = max(errs)
    tol = BATCH_CARD_CPU_PARAM_TOL
    if path == 10:
        # The f32 carry's run, which shows that the bf16 carry sets the
        # gap (EVENT_BATCH_F32_PARAM_TOL).
        f32 = dataclasses.replace(fcfg, carry_dtype=None)
        p32 = {str(d): federated.run_federated_batch(
            model=model, data=data, nets=nets, wcfg=wcfg, scfg=scfg,
            fcfg=f32, seeds=federated.scenario_seeds(SEED + 4, 0, s),
            draws=draws, device=d)[0] for d in (dev, "cpu")}
        err32 = max(float((p32[str(dev)][n].cpu() - p32["cpu"][n])
                          .abs().max()) for n in p32["cpu"])
        print(f"[card-vs-cpu] path 10 with the f32 carry: final params max "
              f"abs diff {err32:.3g} (limit {EVENT_BATCH_F32_PARAM_TOL:g})",
              flush=True)
        if not err32 <= EVENT_BATCH_F32_PARAM_TOL:
            raise AssertionError(f"path 10, f32 carry: card and CPU params "
                                 f"differ by {err32}")
    print(f"[card-vs-cpu] path {path} S={s} final params max abs diff "
          f"{err:.3g} (limit {tol:g}; by scenario "
          f"{', '.join(f'{e:.3g}' for e in errs)})", flush=True)
    if not err <= tol:
        raise AssertionError(f"path {path}: card and CPU params differ by "
                             f"{err}")


# Path 10's event frames, card against CPU: the masks and counts equal,
# the floats (the clock) within 1e-4.
EVENT_FRAME_MASKS = ("avail", "free", "in_flight", "buffer_fill", "flushed",
                     "staleness_tau", "model_version")
EVENT_FRAME_TOL = 1e-4


def event_frames_agree(torch, f_gpu, f_cpu) -> None:
    """Every event-frame leaf of a card run against the CPU run's."""
    for name in EVENT_FRAME_MASKS:
        if not torch.equal(f_gpu[name].cpu(), f_cpu[name]):
            raise AssertionError(f"path 10: card and CPU frame {name} "
                                 f"differ")
    err = float((f_gpu["clock"].cpu() - f_cpu["clock"]).abs().max())
    print(f"[card-vs-cpu] path 10 event frames: {', '.join(EVENT_FRAME_MASKS)}"
          f" equal; clock max abs diff {err:.3g} (limit "
          f"{EVENT_FRAME_TOL:g}); flushes by scenario "
          f"{f_gpu['flushed'].sum(dim=1).int().tolist()}", flush=True)
    if not err <= EVENT_FRAME_TOL:
        raise AssertionError(f"path 10: card and CPU clocks differ by {err}")


DENSE_ARCHS = ("h2o_danube_3_4b", "codeqwen1_5_7b", "qwen3_14b",
               "stablelm_12b")
# Decode parity at full width: the reference's own limit between prefill
# + decode and forward (tests/test_models.py), max-abs error over the
# max-abs logit.  The card-vs-CPU limit of the reduced configs (f32,
# TF32 off): sums in another order.
SERVE_PARITY_TOL = 2e-2
# The same at f32 with TF32 off: 24 layers of sums in another order.
SERVE_F32_PARITY_TOL = 1e-3
DENSE_CARD_CPU_TOL = 1e-4


def profile_device(torch, fn, host_top: int = 0):
    """Run ``fn`` once under torch.profiler -> (wall us, device busy us,
    flash_attention's device us, device kernels run); print the
    ``host_top`` operators with the most host time of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Activity Buffer")]
    busy = sum(k.time_range.elapsed_us() for k in kernels)
    flash = sum(k.time_range.elapsed_us() for k in kernels
                if "flash_attention_" in k.name)
    if busy <= 0:
        raise AssertionError("profiler recorded no device time")
    if host_top:
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        for e in ops[:host_top]:
            print(f"[profile] host {e.self_cpu_time_total / 1e3:8.3f} ms self "
                  f"in {e.count:5d} calls  {e.key[:70]}", flush=True)
    return wall_us, busy, flash, len(kernels)


def phase_serve(torch, dev) -> dict:
    """Path 6: h2o-danube-3-4b at full width, served.  Returns the
    launch counts of its prefill + decode run."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    cfg = configs.get("h2o_danube_3_4b")
    b, s, n_gen = SERVE_B, SERVE_PROMPT, SERVE_GEN
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = transformer.init(gen, cfg)
    sp = transformer.serving_params(params, cfg)
    del params
    torch.cuda.synchronize()
    print(f"[path 6] {cfg.name}: {transformer.param_count(cfg)} parameters "
          f"(f32 init, kept as a {cfg.dtype_compute} copy) in "
          f"{time.perf_counter() - t0:.2f}s; {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, window "
          f"{cfg.sliding_window}", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    pad_to = s + n_gen + 1
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(sp, prompt, cfg, pad_to=pad_to)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("path 6: non-finite prefill logits")
    tok = logits[:, -1].argmax(-1)[:, None]
    first_tok = tok
    logits, cache = transformer.decode_step(sp, tok, cache, s, cfg)
    first_logits = logits.clone()
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n_gen):
        logits, cache = transformer.decode_step(sp, tok, cache, s + i, cfg)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (n_gen - 1)
    counts = read_counts()
    routes = dict(fa.flash_attention.route_launches)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("path 6: non-finite decode logits")
    want = dict.fromkeys(_counters(), 0)
    want["flash_attention"] = cfg.num_layers * (1 + n_gen)
    # Every prefill layer on the tensor cores, every step on decode.
    want_routes = dict(prefill_tc=cfg.num_layers, prefill_f32=0,
                       decode=cfg.num_layers * n_gen, backward=0,
                       backward_tc=0)
    print(f"[path 6] flash_attention launches by route {routes}", flush=True)
    if routes != want_routes:
        raise AssertionError(f"path 6 flash routes {routes}, expected "
                             f"{want_routes}")
    print(f"[path 6] B={b} prompt {s}, pad_to {pad_to}: prefill cold "
          f"{cold:.3f}s; decode {n_gen} greedy steps, warm "
          f"{step_s * 1e3:.3f} ms per step = {b / step_s:.1f} tokens/s; "
          f"launches {counts}", flush=True)
    if counts != want:
        raise AssertionError(f"path 6 launch counts {counts}, expected "
                             f"{want}")
    del cache
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(sp, prompt, cfg, pad_to=pad_to)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[path 6] prefill warm {warm:.3f}s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    wall, busy, flash, n_kern = profile_device(
        torch, lambda: transformer.decode_step(sp, tok, cache, s + n_gen,
                                               cfg), host_top=12)
    print(f"[path 6] profiled decode step: wall {wall / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall:.3f} "
          f"(against the unprofiled warm step: "
          f"{1 - busy / (step_s * 1e6):.3f}), {n_kern} device kernels; "
          f"flash_attention "
          f"{flash / 1e3:.3f} ms = {flash / busy:.3f} of device time",
          flush=True)
    del cache
    wall, busy, flash, n_kern = profile_device(
        torch, lambda: transformer.prefill(sp, prompt, cfg, pad_to=pad_to))
    print(f"[path 6] profiled prefill: wall {wall / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall:.3f}, "
          f"{n_kern} device kernels; flash_attention {flash / 1e3:.1f} ms = "
          f"{flash / busy:.3f} of device time", flush=True)
    rel, _ = serve_parity(torch, transformer, sp, cfg, prompt, first_tok,
                          first_logits, "bf16")
    if not rel < SERVE_PARITY_TOL:
        raise AssertionError(f"path 6 decode parity rel err {rel}")
    del sp, first_logits
    torch.cuda.empty_cache()
    # The same weights in f32 (TF32 off): prefill, one decode step and
    # forward must pick the same greedy tokens.  In bf16 a token can flip
    # where the top two logits lie within the parity error (a near tie
    # of the random weights); in f32 that error is some 1e-5.
    cfg32 = dataclasses.replace(cfg, dtype_compute="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    p32 = transformer.init(gen, cfg32)
    logits, cache = transformer.prefill(p32, prompt, cfg32, pad_to=pad_to)
    tok32 = logits[:, -1].argmax(-1)[:, None]
    logits, cache = transformer.decode_step(p32, tok32, cache, s, cfg32)
    del cache
    rel32, same = serve_parity(torch, transformer, p32, cfg32, prompt, tok32,
                               logits, "f32")
    if not (rel32 < SERVE_F32_PARITY_TOL and same):
        raise AssertionError(f"path 6 f32: decode parity rel err {rel32}, "
                             f"same greedy tokens {same}")
    del p32
    torch.cuda.empty_cache()
    # The kernels line's rows: the prefill and the decode kernel, each by
    # its route's count.
    return dict(counts, flash_attention=routes["prefill_tc"],
                flash_attention_decode=routes["decode"])


def serve_parity(torch, transformer, params, cfg, prompt, tok, logits,
                 label: str, path: int = 6) -> tuple[float, bool]:
    """``forward(prompt + tok)`` at the last position against the first
    decode step's ``logits``: max-abs error over the max-abs logit, and
    whether both pick the same greedy tokens (printed with forward's
    top-two margin per sequence)."""
    full = torch.cat([prompt, tok], dim=1)
    ref, _ = transformer.forward(params, full, cfg)
    a, d = ref[:, -1].float(), logits[:, 0].float()
    del ref
    rel = float((a - d).abs().max() / a.abs().max())
    top = a.topk(2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]) / a.abs().max()
    same = torch.equal(a.argmax(-1), d.argmax(-1))
    print(f"[path {path}] {label} decode parity vs forward at position "
          f"{prompt.shape[1]}: rel err {rel:.3g} (limit "
          f"{SERVE_PARITY_TOL if label == 'bf16' else SERVE_F32_PARITY_TOL:g}"
          f"); greedy tokens forward "
          f"{a.argmax(-1).tolist()} decode {d.argmax(-1).tolist()} "
          f"({'same' if same else 'differ'}); forward's top-two margin per "
          f"sequence over the max logit "
          f"{[f'{m:.2e}' for m in margin.tolist()]}",
          flush=True)
    return rel, same


def phase_dense_card_vs_cpu(torch, dev) -> None:
    """The four dense configs at ``reduced()``: the same weights and
    tokens on the card and the CPU, prefill of 150 tokens (past danube's
    reduced 128-slot window) and 3 decode steps; in f32 (TF32 off, the
    CUDA-core prefill) within 1e-4, and in bf16 from the bf16 serving copy
    (the tensor-core prefill on the card, the plain version on the CPU)
    within the bf16 serving limit 2e-2."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s, steps = 2, 150, 3
    for arch in DENSE_ARCHS:
        for dtype, tol in (("float32", DENSE_CARD_CPU_TOL),
                           ("bfloat16", SERVE_PARITY_TOL)):
            cfg = dataclasses.replace(configs.get(arch).reduced(),
                                      dtype_compute=dtype)
            gen = torch.Generator().manual_seed(SEED + 8)
            params = transformer.init(gen, cfg)
            if dtype == "bfloat16":
                params = transformer.serving_params(params, cfg)
            tokens = torch.randint(0, cfg.vocab_size, (b, s + steps),
                                   generator=gen)
            outs = {}
            before = dict(fa.flash_attention.route_launches)
            for device in ("cpu", dev):
                p = _to(params, device)
                t = tokens.to(device)
                logits, cache = transformer.prefill(p, t[:, :s], cfg,
                                                    pad_to=s + steps)
                got = [logits]
                for i in range(steps):
                    logits, cache = transformer.decode_step(
                        p, t[:, s + i:s + i + 1], cache, s + i, cfg)
                    got.append(logits)
                outs[str(device)] = [x.float().cpu() for x in got]
            routed = {r: n - before[r]
                      for r, n in fa.flash_attention.route_launches.items()}
            rel = max(float((c - g).abs().max() / c.abs().max())
                      for c, g in zip(outs["cpu"], outs[str(dev)]))
            print(f"[card-vs-cpu] {cfg.name} reduced {dtype}: prefill + "
                  f"{steps} decode steps, logits max rel err {rel:.3g} "
                  f"(limit {tol:g}); card flash launches by route {routed}",
                  flush=True)
            prefill_route = fa.route(getattr(torch, dtype), s)
            if routed[prefill_route] != cfg.num_layers:
                raise AssertionError(f"{cfg.name} {dtype}: prefill routes "
                                     f"{routed}")
            if not rel <= tol:
                raise AssertionError(f"{cfg.name} {dtype}: card and CPU "
                                     f"logits differ by {rel}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def half_median_round_time(recs) -> float:
    times = sorted(r.round_time for r in recs)
    mid = len(times) // 2
    median = times[mid] if len(times) % 2 else 0.5 * (times[mid - 1]
                                                      + times[mid])
    return 0.5 * median


# Path 12, the sweep: path 7's world and config with the scheduling
# method swept over DAS and random under common random numbers, 16
# scenarios a point in chunks of 8.
SWEEP_S, SWEEP_CHUNK = 16, 8
# Its limits against one batch call of a point's 16 scenarios: the
# selections, DAS iterations and counts equal (scheduling never reads
# the model); round time and energy within sub2_pgd's card tolerance on
# the objective (rel 1e-3, as sub2_check holds it): on the card
# torch.sum rounds a row by how many rows it reduces, so the
# water-filling start's overshoot normalisation can part by an ulp
# between 8 and 16 rows and the descent carries it on, while the kernel
# gives each lane bit for bit at any S (sweep_lane_alone prints where);
# accuracy within the batch paths' limit (a chunk of 8 and a batch of 16
# run the vmapped CNN at two batch shapes, which can settle a near-tie
# apart, BATCH_CARD_CPU_PARAM_TOL).
SWEEP_OBJ_RTOL = 1e-3
SWEEP_ACC_TOL = BATCH_CARD_CPU_PARAM_TOL
SWEEP_COUNTS = ("n_selected", "n_success", "n_dropped")
# Peak memory of the last chunk against the first's.
SWEEP_MEM_RTOL = 0.01


def sweep_batch(eng, model, point, start: int, size: int):
    """Scenarios ``[start, start + size)`` of a grid point as one
    ``run_federated_batch`` call, their networks and seeds from the
    engine's public seed contract (``engine.stream_bases``): what
    ``SweepEngine.run_chunk`` runs before its fold.  Returns the (S, R)
    metrics."""
    from repro_torch.core import federated, wireless
    from repro_torch.sweep import engine as engine_lib
    net_base, sim_base = engine_lib.stream_bases(eng.spec.base_seed)
    nets = wireless.sample_networks_indexed(
        net_base, range(start, start + size), eng.data.num_devices,
        point.wireless)
    return federated.run_federated_batch(
        model=model, data=eng.data, nets=nets, wcfg=point.wireless,
        scfg=point.sched, fcfg=point.fl,
        seeds=federated.scenario_seeds(sim_base, start, size),
        eval_every=eng.spec.eval_every, device=eng.dev)[1]


def sweep_setup(torch, wcfg):
    """Path 12's ``SweepSpec`` and initial model."""
    from repro_torch.core import bandwidth
    from repro_torch.models import paper_nets
    from repro_torch.sweep import grid
    scfg, fcfg = slice_configs(rounds=3, iterations_max=6,
                               sub2=bandwidth.Sub2Params(), path=7)
    spec = grid.SweepSpec(
        fl=fcfg, sched=scfg, wireless=wcfg,
        axes=(grid.Axis("sched", "method", ("das", "random")),),
        scenarios_per_point=SWEEP_S, chunk_scenarios=SWEEP_CHUNK,
        base_seed=SEED)
    model = paper_nets.init(paper_nets.PaperNetSpec(kind="cnn"),
                            torch.Generator().manual_seed(SEED + 3))
    return spec, model


def expected_sweep_counts(point, rounds: int, iterations) -> dict:
    """A chunk's launches: DAS's are path 7's at the chunk's S
    (``expected_batch_counts``); random ranks a uniform draw and solves
    Sub2 once a round (one ``sub2_pgd`` launch, no DAS iterations)."""
    if point.sched.method == "das":
        return expected_batch_counts(7, rounds, iterations)
    return expected_counts(1, rounds, rounds)


def sweep_walk(torch, eng, model, label: str) -> tuple:
    """The runner's chunk walk over path 12's schedule, without
    checkpoints, each chunk a ``sweep_batch`` call and the engine's fold:
    each chunk's launches (counted from zero just before it) checked, its
    wall, its peak memory (reset just before it) and the memory held
    after it.  Returns ``(per-point aggregates, rows)``."""
    from repro_torch.sweep import engine as engine_lib
    aggs, rows = {}, []
    for p, start, size in eng.spec.schedule():
        point = eng.points[p]
        agg = aggs.get(p)
        if agg is None:
            agg = engine_lib.aggregate_init(eng.spec.fl.num_rounds, eng.dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        metrics = sweep_batch(eng, model, point, start, size)
        aggs[p] = engine_lib.aggregate_fold(agg, metrics,
                                            eng.target_accuracy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes = read_counts(), route_counts()
        want = expected_sweep_counts(point, eng.spec.fl.num_rounds,
                                     metrics.iterations)
        if counts != want:
            raise AssertionError(f"path 12 {point.name} chunk at {start}: "
                                 f"launches {counts}, expected {want}")
        rows.append(dict(point=point, start=start, wall=wall,
                         counts=counts, routes=routes, metrics=metrics,
                         peak=torch.cuda.max_memory_allocated(),
                         held=torch.cuda.memory_allocated()))
        print(f"[path 12] {label} run, {point.name} scenarios "
              f"{start}-{start + size - 1}: {wall:.3f}s = "
              f"{wall / eng.spec.fl.num_rounds:.3f}s per chunk round; "
              f"das_iters {metrics.iterations.tolist()}; launches "
              f"{counts}; peak {rows[-1]['peak'] / 2 ** 30:.3f} GiB",
              flush=True)
    return aggs, rows


def sweep_oracle(metrics) -> dict:
    """A float64 host fold of one batch's (S, R) metrics: per-round mean,
    min and max (NaN-aware) and the final accuracy's mean."""
    out = {}
    for name in ("accuracy", "round_time", "energy_total") + SWEEP_COUNTS:
        v = getattr(metrics, name).cpu().double().numpy()
        out[f"round.{name}"] = dict(mean=v.mean(0), min=v.min(0),
                                    max=v.max(0))
    acc = metrics.accuracy.cpu().double().numpy()
    out["scalar.final_accuracy"] = dict(mean=acc[:, -1].mean(),
                                        min=acc[:, -1].min(),
                                        max=acc[:, -1].max())
    return out


def sweep_against_batch(torch, eng, model, summaries, chunk_metrics):
    """Each point's aggregate against one ``run_federated_batch`` call on
    the same 16 networks and seeds, folded on the host in float64; each
    chunk's selections and DAS iterations against the batch's rows.  The
    lane and round of the sweep's largest round-time gap then run alone
    (``sweep_lane_alone``)."""
    import numpy as np
    spec, worst_gap = eng.spec, (-1.0, None)
    for p, point in enumerate(eng.points):
        start = spec.scenario_start(p)
        metrics = sweep_batch(eng, model, point, start, SWEEP_S)
        mine = [m for q, m in chunk_metrics if q == p]
        sel = torch.cat([m.selected for m in mine])
        its = torch.cat([m.iterations for m in mine])
        moved = int((sel != metrics.selected).any(-1).sum())
        its_moved = int((its != metrics.iterations).sum())
        t_chunk = torch.cat([m.round_time for m in mine]).double()
        t_batch = metrics.round_time.double()
        gap = ((t_chunk - t_batch).abs() / t_batch.abs()).cpu()
        lane, rnd = divmod(int(gap.argmax()), gap.shape[1])
        if float(gap.max()) > worst_gap[0]:
            worst_gap = (float(gap.max()), (point, lane, rnd))
        want, got = sweep_oracle(metrics), summaries[p]
        worst = {}
        for name, fields in want.items():
            for field, value in fields.items():
                g = np.asarray(got[name][field], np.float64)
                diff = np.abs(g - value)
                if name.endswith(("round_time", "energy_total")):
                    diff = diff / np.maximum(np.abs(value), 1e-30)
                worst[name] = max(worst.get(name, 0.0), float(diff.max()))
        print(f"[path 12] {point.name} against one batch call of "
              f"{SWEEP_S} scenarios: scenario-rounds with another "
              f"selection {moved}, with other DAS iterations {its_moved}; "
              f"largest difference by metric (relative for round time and "
              f"energy) "
              f"{', '.join(f'{n} {v:.3g}' for n, v in worst.items())}; the "
              f"largest round-time gap of one scenario-round "
              f"{float(gap.max()):.3g} (scenario {start + lane}, round "
              f"{rnd})", flush=True)
        limits = {"round.accuracy": SWEEP_ACC_TOL,
                  "scalar.final_accuracy": SWEEP_ACC_TOL,
                  "round.round_time": SWEEP_OBJ_RTOL,
                  "round.energy_total": SWEEP_OBJ_RTOL,
                  **{f"round.{n}": 0.0 for n in SWEEP_COUNTS}}
        over = {n: v for n, v in worst.items() if not v <= limits[n]}
        if moved or its_moved or over:
            raise AssertionError(f"path 12 {point.name}: the sweep "
                                 f"differs from one batch call: {moved} "
                                 f"selections, {its_moved} DAS iteration "
                                 f"counts, over the limits {over}")
    sweep_lane_alone(torch, eng, model, *worst_gap[1])


def sweep_lane_alone(torch, eng, model, point, lane: int, rnd: int) -> None:
    """Where a lane's round time parts between a chunk of 8 and a batch of
    16: the lane runs alone (S = 1), in its chunk and in the batch, each
    under ``Sub2Log``; prints its round time in each, the allocation gap
    after each DAS outer iteration, and, at the first iteration that
    parts, whether that solve's inputs were equal and what the same
    inputs give when solved again on 1, 8 and 16 rows: the water-filling
    start, a row sum of that start, the ``sub2_pgd`` kernel from one
    start for all three, and the whole ``fused_pgd`` solve."""
    from repro_torch.core import allocator, bandwidth
    from repro_torch.kernels import sub2_pgd as sub2_kernel
    start = eng.spec.scenario_start(point.index)
    chunk = lane - lane % SWEEP_CHUNK
    runs = {1: (start + lane, 0), SWEEP_CHUNK: (start + chunk, lane - chunk),
            SWEEP_S: (start, lane)}
    out = {}
    for n, (first, row) in runs.items():
        with Sub2Log() as log:
            metrics = sweep_batch(eng, model, point, first, n)
        calls = int(metrics.iterations.max(dim=0).values[:rnd].sum())
        out[n] = dict(row=row, log=log, first_call=calls,
                      t=float(metrics.round_time[row, rnd]),
                      its=int(metrics.iterations[row, rnd]),
                      trace=lane_trace(log.calls, metrics.iterations, row,
                                       rnd))

    def gaps(a, b):
        return [float((x[1] - y[1]).abs().max())
                for x, y in zip(out[a]["trace"], out[b]["trace"])]
    g_8_16, g_1_16 = gaps(SWEEP_CHUNK, SWEEP_S), gaps(1, SWEEP_S)
    print(f"[path 12] {point.name} scenario {start + lane} round {rnd} "
          f"alone and in its batches: round time S=1 "
          f"{out[1]['t']!r}, chunk S={SWEEP_CHUNK} "
          f"{out[SWEEP_CHUNK]['t']!r}, batch S={SWEEP_S} "
          f"{out[SWEEP_S]['t']!r}; DAS outer iterations "
          f"{[out[n]['its'] for n in runs]}; largest allocation gap after "
          f"each outer iteration, S={SWEEP_CHUNK} against S={SWEEP_S} "
          f"{[f'{g:.3g}' for g in g_8_16]}, S=1 against S={SWEEP_S} "
          f"{[f'{g:.3g}' for g in g_1_16]}", flush=True)
    parts = [m for m, g in enumerate(g_8_16) if g > 0.0]
    if not parts:
        return
    m = parts[0]

    def inputs(n):
        rec = out[n]
        x = rec["log"].calls[rec["first_call"] + m][0]
        ins = rec["log"].inputs[rec["first_call"] + m]
        return [None if t is None else t[rec["row"]] for t in (x,) + ins]
    same_in = [all(a is b if a is None else torch.equal(a, b)
                   for a, b in zip(inputs(n), inputs(SWEEP_S)))
               for n in (1, SWEEP_CHUNK)]
    rec16 = out[SWEEP_S]
    x = rec16["log"].calls[rec16["first_call"] + m][0]
    ins = rec16["log"].inputs[rec16["first_call"] + m]
    sub2 = point.sched.sub2
    alloc = allocator.FusedPGD(sub2)
    rows = {1: [lane], SWEEP_CHUNK: list(range(chunk, chunk + SWEEP_CHUNK)),
            SWEEP_S: list(range(SWEEP_S))}
    cfg = point.wireless
    starts, sums, kernel, solved, wf16 = {}, {}, {}, {}, None
    for n, idx in sorted(rows.items(), key=lambda kv: -kv[0]):
        at = idx.index(lane)
        sel, t_train, gains, power, a0 = (
            None if t is None else t[idx].to(eng.dev).contiguous()
            for t in (x,) + ins)
        wf, _ = bandwidth.min_time_allocation(sel, t_train, gains, power,
                                              cfg, sub2, alpha0=a0)
        if wf16 is None:
            wf16 = wf
        same = wf16[idx].contiguous()
        mask = (sel > 0.0).to(torch.float32)
        n_act = torch.clamp_min(torch.sum(mask, dim=-1, keepdim=True), 1.0)
        a_k, _ = sub2_kernel.sub2_pgd_solve(
            mask, t_train, gains, power,
            torch.stack([same, mask / n_act], dim=-2), rho=sub2.rho,
            lr=sub2.pgd_lr, tau=sub2.smooth_tau, iters=sub2.pgd_iters,
            bandwidth_hz=cfg.bandwidth_hz, noise_psd=cfg.noise_psd,
            model_bits=cfg.model_bits, min_alpha=cfg.min_alpha)
        alpha, _ = alloc.solve(sel, t_train, gains, power, cfg, alpha0=a0)
        starts[n], kernel[n], solved[n] = (wf[at].cpu(), a_k[at].cpu(),
                                           alpha[at].cpu())
        sums[n] = torch.sum(same, dim=-1)[at].cpu()

    def spread(d):
        gap = float(max((d[n] - d[SWEEP_S]).abs().max() for n in d))
        return "bit for bit" if gap == 0.0 else f"parts by {gap:.3g}"
    print(f"[path 12] {point.name} scenario {start + lane} round {rnd}, "
          f"outer iteration {m + 1}, the first that parts: its solve's "
          f"inputs equal bit for bit S=1 and S={SWEEP_CHUNK} against "
          f"S={SWEEP_S} {same_in}; the S={SWEEP_S} inputs solved again on "
          f"1, {SWEEP_CHUNK} and {SWEEP_S} rows: water-filling start "
          f"{spread(starts)}; torch.sum of one start row "
          f"{[float(sums[n]) for n in sorted(sums)]!r} "
          f"({spread(sums)}); sub2_pgd from that one start "
          f"{spread(kernel)}; fused_pgd allocation {spread(solved)}",
          flush=True)


def sweep_syncs(torch, eng, model) -> None:
    """The host syncs of one chunk against ``run_federated_batch`` on the
    same 8 scenarios (the fold may add none), and of the runner's
    checkpoint and JSONL line (one copy each)."""
    import collections
    from repro_torch.core import federated, wireless
    from repro_torch.sweep import engine as engine_lib
    from repro_torch.sweep import runner as runner_lib
    spec, point = eng.spec, eng.points[0]
    net_base, sim_base = engine_lib.stream_bases(spec.base_seed)
    chunk, agg = syncs_of(torch, lambda: eng.run_chunk(
        point, 0, SWEEP_CHUNK, engine_lib.aggregate_init(
            spec.fl.num_rounds, eng.dev)))
    batch, _ = syncs_of(torch, lambda: federated.run_federated_batch(
        model=model, data=eng.data, nets=wireless.sample_networks_indexed(
            net_base, range(SWEEP_CHUNK), eng.data.num_devices,
            point.wireless), wcfg=point.wireless, scfg=point.sched,
        fcfg=point.fl, seeds=federated.scenario_seeds(sim_base, 0,
                                                      SWEEP_CHUNK),
        device=eng.dev))
    sweep_dir = os.path.join(ROOT, "build", "sweep")
    runner = runner_lib.SweepRunner(
        eng, os.path.join(sweep_dir, "syncs.msgpack"),
        jsonl_path=os.path.join(sweep_dir, "syncs.jsonl"))
    save, _ = syncs_of(torch, lambda: runner._save({0: agg}, 1))
    emit, _ = syncs_of(torch, lambda: runner._jsonl_emit(
        1, point, 0, SWEEP_CHUNK, agg, False))

    def show(c: collections.Counter) -> str:
        return (f"{sum(c.values())}"
                + (f" ({', '.join(f'{n} x{k}' for n, k in c.most_common())})"
                   if c else ""))

    print(f"[syncs] path 12, one chunk of {SWEEP_CHUNK} (run_chunk: the "
          f"batch and the fold): {show(chunk)}; run_federated_batch on the "
          f"same scenarios: {show(batch)}; the fold adds "
          f"{show(chunk - batch)}; the checkpoint {show(save)}; the JSONL "
          f"line {show(emit)}", flush=True)
    if (chunk - batch) or sum(save.values()) > 1 or sum(emit.values()) > 1:
        raise AssertionError(f"path 12: host syncs beyond the batch's: "
                             f"fold {chunk - batch}, checkpoint {save}, "
                             f"JSONL {emit}")


def sweep_checkpoint(torch, eng, aggs) -> None:
    """The checkpoint of path 12's carry: its size, save and load times."""
    from repro_torch.sweep import runner as runner_lib
    path = os.path.join(ROOT, "build", "sweep", "timed.msgpack")
    runner = runner_lib.SweepRunner(eng, path)
    saves, loads = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        runner._save(aggs, len(eng.spec.schedule()))
        saves.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        loaded, cursor = runner._load()
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t0) * 1e3)
    same = all(torch.equal(getattr(loaded[p][g][n], f),
                           getattr(aggs[p][g][n], f))
               for p in aggs for g in aggs[p] for n in aggs[p][g]
               for f in ("count", "mean", "m2", "min", "max"))
    print(f"[path 12] checkpoint of {len(aggs)} points' carry: "
          f"{os.path.getsize(path)} bytes; save {median(saves):.3f} ms, "
          f"load onto the card {median(loads):.3f} ms (medians of 5); "
          f"restored carry {'bit for bit' if same else 'DIFFERS'}",
          flush=True)
    if not same or cursor != len(eng.spec.schedule()):
        raise AssertionError("path 12: the checkpoint does not restore "
                             "the carry")


def sweep_kill_resume(torch, eng, model, want: dict) -> None:
    """Under deterministic algorithms: a runner stopped after one chunk
    (``max_chunks=1``, its checkpoint under ``build/sweep/``) and resumed
    by a new engine gives an uninterrupted run's summaries bit for bit,
    and its JSONL one line a chunk, cursors 1-4.  The uninterrupted run,
    through ``SweepRunner.run`` (counts from zero just before it), must
    launch each kernel as often as the chunk walk's chunks together,
    ``want``."""
    import numpy as np
    from repro_torch.sweep import engine as engine_lib
    from repro_torch.sweep import runner as runner_lib
    from repro_torch.telemetry import sinks
    sweep_dir = os.path.join(ROOT, "build", "sweep")
    paths = {n: os.path.join(sweep_dir, n) for n in (
        "full.msgpack", "full.jsonl", "kill.msgpack", "kill.jsonl")}

    def runner(ck, log):
        return runner_lib.SweepRunner(engine_lib.SweepEngine(
            eng.spec, model=model, data=eng.data, device=eng.dev),
            paths[ck], jsonl_path=paths[log])

    for path in paths.values():
        if os.path.exists(path):
            os.remove(path)
    with deterministic_algorithms(torch, "path 12"):
        reset_counts()
        t0 = time.perf_counter()
        full = runner("full.msgpack", "full.jsonl").run()
        t_full = time.perf_counter() - t0
        counts = read_counts()
        t0 = time.perf_counter()
        if runner("kill.msgpack", "kill.jsonl").run(max_chunks=1) \
                is not None:
            raise AssertionError("path 12: max_chunks=1 ran to the end")
        resumed = runner("kill.msgpack", "kill.jsonl").run()
        t_kill = time.perf_counter() - t0
    cursors = [r["cursor"] for r in sinks.read_jsonl(paths["kill.jsonl"])]
    differ = [f"{p.name}/{m}/{f}" for (p, a), (_, b) in zip(full, resumed)
              for m in a for f in a[m]
              if not np.array_equal(a[m][f], b[m][f], equal_nan=True)]
    print(f"[path 12] kill after chunk 1 and resume: summaries "
          f"{'bit for bit' if not differ else 'DIFFER in ' + str(differ)} "
          f"an uninterrupted run's; JSONL cursors {cursors}; uninterrupted "
          f"{t_full:.2f}s, killed + resumed {t_kill:.2f}s; the "
          f"uninterrupted run's launches {counts} (the chunk walk's "
          f"{want})", flush=True)
    if differ or cursors != [1, 2, 3, 4] or counts != want:
        raise AssertionError(f"path 12: kill/resume differs {differ}, "
                             f"cursors {cursors}, launches {counts} "
                             f"against {want}")


def phase_sweep(torch, dev, data, wcfg, path7_round: float,
                smi: str) -> None:
    """Path 12: a resumable sweep at the paper's scale through
    ``repro_torch.sweep``: the chunk walk twice (launches checked, warm
    wall per chunk round and per scenario round beside path 7's, peak
    memory flat across chunks), each point against one batch call and
    its worst scenario-round alone, the host syncs, the checkpoint, and
    the runner's launches and kill / resume bit for bit."""
    import collections
    from repro_torch.sweep import engine as engine_lib
    os.makedirs(os.path.join(ROOT, "build", "sweep"), exist_ok=True)
    t_phase = time.perf_counter()
    spec, model = sweep_setup(torch, wcfg)
    eng = engine_lib.SweepEngine(spec, model=model, data=data,
                                 use_sharding=False, device=dev)
    rounds = spec.fl.num_rounds
    sweep_walk(torch, eng, model, "first")
    aggs, rows = sweep_walk(torch, eng, model, "warm")
    per_chunk_round = [r["wall"] / rounds for r in rows]
    warm = median(per_chunk_round)
    peaks = [r["peak"] for r in rows]
    held = [r["held"] for r in rows]
    print(f"[path 12] {smi}: S={SWEEP_S} a point in chunks of "
          f"{SWEEP_CHUNK} x K={data.num_devices} CNN, DAS and random, "
          f"{rounds} rounds: warm s per chunk round by chunk "
          f"{[round(w, 4) for w in per_chunk_round]} (median {warm:.3f}) "
          f"= {warm / SWEEP_CHUNK:.4f}s per "
          f"scenario-round, against path 7's {path7_round:.3f}s per batch "
          f"round of {BATCH_S} = {path7_round / BATCH_S:.4f}s per "
          f"scenario-round in this call; peak memory by chunk "
          f"{[round(p / 2 ** 30, 3) for p in peaks]} GiB, held after each "
          f"{[round(h / 2 ** 30, 3) for h in held]} GiB", flush=True)
    if abs(peaks[-1] - peaks[0]) > SWEEP_MEM_RTOL * peaks[0] or \
            abs(held[-1] - held[0]) > SWEEP_MEM_RTOL * held[0]:
        raise AssertionError(f"path 12: memory grows across chunks: peaks "
                             f"{peaks}, held {held}")
    summaries = {p: engine_lib.aggregate_summary(a) for p, a in aggs.items()}
    for p, point in enumerate(eng.points):
        s = summaries[p]
        print(f"[path 12] {point.name}: acc by round "
              f"{s['round.accuracy']['mean'].tolist()} [min "
              f"{s['round.accuracy']['min'].tolist()}, max "
              f"{s['round.accuracy']['max'].tolist()}], sel "
              f"{s['round.n_selected']['mean'].tolist()}, T "
              f"{s['round.round_time']['mean'].tolist()} s, final acc std "
              f"{float(s['scalar.final_accuracy']['std']):.4f}", flush=True)
    sweep_against_batch(torch, eng, model, summaries,
                        [(r["point"].index, r["metrics"]) for r in rows])
    sweep_syncs(torch, eng, model)
    sweep_checkpoint(torch, eng, aggs)
    want = collections.Counter()
    for r in rows:
        want.update(r["counts"])
    sweep_kill_resume(torch, eng, model,
                      {name: want[name] for name in rows[0]["counts"]})
    sweep_mesh_walks(torch, dev, data, spec, model, summaries,
                     sum(r["wall"] for r in rows), smi)
    print(f"[path 12] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)


# The summaries' statistics held between the sweep's walks: the counts
# exactly, round time and energy relative, accuracy absolute.
SWEEP_LIMITS = {"round.accuracy": SWEEP_ACC_TOL,
                "scalar.final_accuracy": SWEEP_ACC_TOL,
                "round.round_time": SWEEP_OBJ_RTOL,
                "round.energy_total": SWEEP_OBJ_RTOL,
                **{f"round.{n}": 0.0 for n in SWEEP_COUNTS}}


def sweep_mesh_walks(torch, dev, data, spec, model, want: dict,
                     unsharded_wall: float, smi: str) -> None:
    """Path 12 through ``SweepEngine.run_point`` (its chunks split over a
    scenario mesh) on the card's one-device mesh, bit for bit the
    unsharded walk's summaries ``want`` (the same call), and on two
    entries over the same card (each chunk of 8 as 4 + 4), at
    SWEEP_LIMITS; the wall and launches of each walk."""
    import numpy as np
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sweep import engine as engine_lib
    for label, mesh in (("one-device", mesh_lib.make_scenario_mesh()),
                        ("two-entry", mesh_lib.Mesh(("scenario",), (2,),
                                                    (dev, dev)))):
        eng = engine_lib.SweepEngine(spec, model=model, data=data,
                                     mesh=mesh, device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = {p.index: engine_lib.aggregate_summary(eng.run_point(p))
               for p in eng.points}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        worst, exact = {}, True
        for p, names in want.items():
            for name, fields in names.items():
                for field, value in fields.items():
                    g = np.asarray(got[p][name][field], np.float64)
                    w = np.asarray(value, np.float64)
                    exact &= bool(np.array_equal(g, w, equal_nan=True))
                    if name in SWEEP_LIMITS and field in ("mean", "min",
                                                          "max"):
                        diff = np.abs(g - w)
                        if name.endswith(("round_time", "energy_total")):
                            diff = diff / np.maximum(np.abs(w), 1e-30)
                        worst[name] = max(worst.get(name, 0.0),
                                          float(np.nanmax(diff)))
        split = [n for _, n, _ in eng.groups(SWEEP_CHUNK)]
        gaps = ", ".join(f"{n} {v:.3g}" for n, v in worst.items())
        print(f"[path 12] scenario mesh {label} {mesh.shape} on {dev}: "
              f"chunks of {SWEEP_CHUNK} as {split}; walk {wall:.3f}s "
              f"against the unsharded warm walk's {unsharded_wall:.3f}s; "
              f"launches {counts}; summaries bit for bit the unsharded "
              f"walk's: {exact}; largest difference by metric {gaps}; "
              f"{smi}", flush=True)
        over = {n: v for n, v in worst.items() if not v <= SWEEP_LIMITS[n]}
        if (label == "one-device" and not exact) or over:
            raise AssertionError(f"path 12 {label} scenario mesh: bit for "
                                 f"bit {exact}, over the limits {over}")


# Paths 13-14: xlstm-125m (arXiv 2405.04517 as the registry builds it: 12
# layers alternating sLSTM / mLSTM, d_model 768, 4 heads, vocab 50,304)
# at its published width and depth, random weights from a seed, bf16
# compute.  Path 14 serves it: B = 4, a 2048-token prompt (8 mLSTM chunks
# of 256, the state carried) and 32 greedy decode steps.  Path 13 trains
# it federated as launch/train.py does: K = 8 clients, a global batch of
# 64 (8 sequences a client) of 512 tokens (two mLSTM chunks), AdamW at the
# CLI's lr 3e-4 and warmup 10, DAS scheduling every step, 3 steps (cold,
# warm, profiled), set up by the CLI's own ``setup``; then one plain SGD
# step in f32 at half the batch with 1 and 2 microbatches.  The 8 clients'
# forward and backward in one pass do not fit in the card's 80 GB at 512
# tokens, so the step runs them 4 to a pass (``steps.pass_size``, the
# CLI's default).  Each pass is ~253k launches (the sLSTM's per-position
# operations, forward and backward), which set the step's wall; hence 3
# steps, not more.
XLSTM_B, XLSTM_PROMPT, XLSTM_GEN = 4, 2048, 32
TRAIN_K, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 64, 512, 3
XLSTM_PARAMS = 162_317_616
# Microbatched against one batch, SGD as the reference test takes it:
# its limits on the parameters (atol = rtol) and on ce
# (tests/test_system.py::test_microbatched_train_step_matches_mb1).
TRAIN_MB_TOL, TRAIN_MB_CE_RTOL = 2e-3, 1e-3
# ... and on the accumulated gradients themselves, ||g1 - g2|| / ||g1||,
# in f32 with TF32 off.  A dropped microbatch moves them by at least half
# their norm, a missing 1/m by all of it: at full width (512 positions of
# 12 layers, from path 13's state) the limit is 0.05, a tenth of the
# smaller, because two splits of the batch read 2.93e-3 there (not the
# ~1e-4 of sums in another order: the sensitivity is the model's, see
# PERF.md).  At reduced(num_layers=4) (the card-vs-CPU phase) the limit
# is 1e-4, below what a bf16 accumulator's rounding (about 2^-9 of each
# element) moves them by.  Not in bf16: this model's bf16 gradients part
# from its f32 ones by 0.17-0.25 at small widths, the reference's as the
# port's (``python tests/test_torch_train.py``), and two splits of a
# bf16 batch at full width read 0.2.
TRAIN_MB_GRAD_TOL, TRAIN_MB_GRAD_TOL_REDUCED = 0.05, 1e-4
# f32 activations of one 64 x 512 microbatch do not fit in 80 GB beside
# the trainer's state: the full-width check takes 32 x 512.
TRAIN_MB_BATCH = 32
# Card against CPU at xlstm_125m.reduced(num_layers=4), f32 with TF32
# off: sums in another order.
XLSTM_CARD_CPU_TOL = 1e-4
# The driver's scopes (launch/train.py, launch/steps.py).
TRAIN_SCOPES = ("train/batch", "train/schedule", "federated/client_grads",
                "federated/fedavg_agg", "federated/optimizer")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def profile_scopes(torch, fn, scopes, kernels=()) -> dict:
    """Run ``fn`` once under torch.profiler, reading the raw trace (the
    parsed events of a step with some 10^5 launches take minutes): wall,
    device busy time and operations, host launches (kernels, copies,
    fills) in total and within each of ``scopes`` (``record_function``
    ranges; ``other`` is outside all of them), each scope's host ms, and
    the device us of the kernels whose names hold each of ``kernels``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()
              and not e.name().startswith("Activity Buffer")]
    busy_us = sum(e.duration_ns() for e in device) / 1e3
    if busy_us <= 0:
        raise AssertionError("profiler recorded no device time")
    ranges = {name: [] for name in scopes}
    starts = []
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name() in ranges:
            ranges[e.name()].append((e.start_ns(), e.end_ns()))
        elif e.name().startswith(LAUNCH_CALLS):
            starts.append(e.start_ns())
    per = {name: sum(1 for t in starts if any(a <= t < b for a, b in rs))
           for name, rs in ranges.items()}
    per["other"] = len(starts) - sum(per.values())
    host_ms = {name: sum(b - a for a, b in rs) / 1e6
               for name, rs in ranges.items()}
    kernel_us = {k: sum(e.duration_ns() for e in device if k in e.name())
                 / 1e3 for k in kernels}
    return dict(wall_us=wall_us, busy_us=busy_us, device_ops=len(device),
                launches=len(starts), per_scope=per, host_ms=host_ms,
                kernel_us=kernel_us)


def phase_xlstm_serve(torch, dev) -> dict:
    """Path 14: xlstm-125m served at full width and depth.  Returns the
    launch counts of its prefill + decode run: no port kernel (xLSTM has
    no attention), which the run checks."""
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get("xlstm_125m")
    b, s, n_gen = XLSTM_B, XLSTM_PROMPT, XLSTM_GEN
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    params = transformer.init(gen, cfg)
    sp = transformer.serving_params(params, cfg)
    del params
    n_params = transformer.param_count(cfg)
    if n_params != XLSTM_PARAMS:
        raise AssertionError(f"path 14: {n_params} parameters")
    print(f"[path 14] {cfg.name}: {n_params} parameters, {cfg.num_layers} "
          f"layers ({'/'.join(x.mixer for x in cfg.pattern)} x "
          f"{cfg.num_groups}), d_model {cfg.d_model}, {cfg.xlstm_heads} "
          f"heads, vocab {cfg.vocab_size}, mLSTM chunk {cfg.ssm_chunk}, "
          f"{cfg.dtype_compute} compute", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(sp, prompt, cfg)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("path 14: non-finite prefill logits")
    first_tok = tok = logits[:, -1].argmax(-1)[:, None]
    logits, cache = transformer.decode_step(sp, tok, cache, s, cfg)
    first_logits = logits.clone()
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n_gen):
        logits, cache = transformer.decode_step(sp, tok, cache, s + i, cfg)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (n_gen - 1)
    counts = read_counts()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("path 14: non-finite decode logits")
    print(f"[path 14] B={b} prompt {s}: prefill cold {cold:.3f}s; decode "
          f"{n_gen} greedy steps, warm {step_s * 1e3:.3f} ms per step = "
          f"{b / step_s:.1f} tokens/s; launches {counts}", flush=True)
    if counts != dict.fromkeys(_counters(), 0):
        raise AssertionError(f"path 14 launch counts {counts}")
    del cache
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(sp, prompt, cfg)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[path 14] prefill warm {warm:.3f}s = {b * s / warm:.0f} tokens/s; "
          f"max_memory_allocated {peak / 2 ** 30:.2f} GiB", flush=True)
    prof = profile_scopes(torch, lambda: transformer.decode_step(
        sp, tok, cache, s + n_gen, cfg), ())
    print(f"[path 14] profiled decode step: wall {prof['wall_us'] / 1e3:.3f} "
          f"ms, device busy {prof['busy_us'] / 1e3:.3f} ms, idle share "
          f"{1 - prof['busy_us'] / prof['wall_us']:.3f}; "
          f"{prof['launches']} launches, {prof['device_ops']} device "
          f"operations", flush=True)
    del cache
    rel, _ = serve_parity(torch, transformer, sp, cfg, prompt, first_tok,
                          first_logits, "bf16", path=14)
    if not rel < SERVE_PARITY_TOL:
        raise AssertionError(f"path 14 decode parity rel err {rel}")
    del sp, first_logits
    torch.cuda.empty_cache()
    return counts


# Paths 15-17: the MoE decoders and the Jamba hybrid served at their
# published widths, cut in depth to fit one card: 4 of mixtral-8x22b's 56
# layers, 4 of qwen3-moe-235b-a22b's 94, and the first four positions of
# jamba-1.5-large-398b's period of 8 (attention + MoE, Mamba + MLP,
# Mamba + MoE, Mamba + MLP; the whole period is 84.06 GiB in bf16).  The
# weights are made in bf16 (``dtype_params``): an f32 draw and a bf16
# copy would take 6 bytes a parameter.  B = 4 and a 5120-token prompt:
# past mixtral's 4096 window, 20 SSD chunks of 256, and 5 MoE groups of
# 4096 tokens (not the one-group fallback).
MOE_B, MOE_PROMPT, MOE_GEN, MOE_LAYERS = 4, 5120, 32, 4
# path -> (architecture, parameters of the cut configuration, as the
# reference's ``transformer.param_count`` reckons them).
MOE_PATHS = {15: ("mixtral_8x22b", 10_418_903_040),
             16: ("qwen3_moe_235b_a22b", 11_195_683_840),
             17: ("jamba_1_5_large_398b", 22_975_670_528)}
# Card against CPU at reduced() (f32, TF32 off): groups of 32 tokens at
# half the capacity, so that several groups drop assignments (a group of
# 16 tokens or fewer never drops: the capacity's floor).
MOE_CARD_CPU_DISPATCH = dict(moe_group_size=32, moe_capacity_factor=0.5)


def moe_path_config(path: int):
    from repro_torch import configs
    cfg = configs.get(MOE_PATHS[path][0])
    return dataclasses.replace(cfg, num_layers=MOE_LAYERS,
                               pattern=cfg.pattern[:MOE_LAYERS],
                               dtype_params="bfloat16")


@contextlib.contextmanager
def moe_records(last_of: int = 0):
    """Record every MoE layer call's expert ids (``moe.route``) and
    kept assignments (``moe.dispatch_slots``, ``dense_grouped`` only) as
    device tensors, read after the run.  With ``last_of``, also each
    call's router input and f32 router probabilities at the last of
    every ``last_of`` rows (each sequence's last position)."""
    from repro_torch.models import moe
    rec = {"ids": [], "keep": [], "x": [], "probs": []}
    route, slots = moe.route, moe.dispatch_slots

    def route_rec(p, x2d, cfg):
        out = route(p, x2d, cfg)
        rec["ids"].append(out[0])
        if last_of:
            x = x2d.view(-1, last_of, x2d.shape[-1])[:, -1].float()
            rec["x"].append(x)
            rec["probs"].append((x @ p["router"].float()).softmax(dim=-1))
        return out

    def slots_rec(*args, **kw):
        out = slots(*args, **kw)
        rec["keep"].append(out[1])
        return out
    moe.route, moe.dispatch_slots = route_rec, slots_rec
    try:
        yield rec
    finally:
        moe.route, moe.dispatch_slots = route, slots


# Decode parity of paths 15-17 holds each sequence whose routing at the
# last position is the same in forward and in decode.  Where a top-k
# choice first differs in a sequence, the two probabilities it parts
# must nearly tie (their gap below this share of the k-th probability:
# bf16 rounding moves the router's input by ~1e-2, its logits by a few
# 1e-2; gaps of 0.009-0.013 read on path 16), and that sequence's logits
# are printed, not held (its later layers see inputs parted by the flip).
# The f32 run holds every sequence.
MOE_FLIP_GAP = 0.05


def moe_parity(torch, transformer, params, cfg, prompt, label: str,
               path: int, tol: float, flips: bool = True,
               held: bool = True) -> None:
    """Prefill + one decode step against ``forward`` at the last
    position on a dropless dispatch (``ragged``), per sequence, with the
    routing of both at that position; ``flips=False`` holds every
    sequence, ``held=False`` only prints the errors."""
    cfg = dataclasses.replace(cfg, moe_impl="ragged")
    b, s = prompt.shape
    n = s + 1
    logits, cache = transformer.prefill(params, prompt, cfg, pad_to=n)
    tok = logits[:, -1].argmax(-1)[:, None]
    with moe_records(last_of=1) as dec:
        logits, cache = transformer.decode_step(params, tok, cache, s, cfg)
    del cache
    d = logits[:, 0].float()
    # Forward over S + 1 = 5121 positions would make one SSD chunk of them
    # (the chunk must divide the sequence): a (4, 5121, 5121, 256) f32
    # tensor of 100 GiB.  The chunk length changes only the order of the
    # SSD's sums, so forward takes the least divisor of S + 1 from the
    # configured chunk up (569 here: 9 chunks).
    chunk = next(c for c in range(min(cfg.ssm_chunk, n), n + 1)
                 if n % c == 0)
    with moe_records(last_of=n) as fwd:
        hidden, _ = transformer.forward(
            params, torch.cat([prompt, tok], 1),
            dataclasses.replace(cfg, ssm_chunk=chunk), return_hidden=True)
    last = hidden[:, -1]
    del hidden
    a = (last @ transformer.head_matrix(params, cfg).to(last.dtype)).float()
    scale = a.abs().max()
    rel = ((a - d).abs().amax(dim=-1) / scale).tolist()
    k = cfg.num_experts_per_tok
    flipped, notes, bad = set(), [], []
    for layer, (i_f, i_d) in enumerate(zip(fwd["ids"], dec["ids"])):
        i_f = i_f.view(b, n, k)[:, -1].sort(dim=-1).values
        i_d = i_d.sort(dim=-1).values
        for seq in range(b):
            if torch.equal(i_f[seq], i_d[seq]):
                continue
            top = fwd["probs"][layer][seq].sort(descending=True).values
            gap = float((top[k - 1] - top[k]) / top[k - 1])
            dx = float((fwd["x"][layer][seq] - dec["x"][layer][seq]).norm()
                       / fwd["x"][layer][seq].norm())
            first = seq not in flipped
            flipped.add(seq)
            notes.append(f"MoE layer {layer} sequence {seq}: experts "
                         f"{i_f[seq].tolist()} in forward, "
                         f"{i_d[seq].tolist()} in decode; forward's k-th and "
                         f"(k+1)-th probabilities {float(top[k - 1]):.4g}, "
                         f"{float(top[k]):.4g} (gap {gap:.3g} of the k-th); "
                         f"router inputs {dx:.3g} apart")
            if (first and gap >= MOE_FLIP_GAP) or not flips:
                bad.append(gap)
    same = torch.equal(a.argmax(-1), d.argmax(-1))
    chunks = (f"; forward in SSD chunks of {chunk}"
              if any(x.mixer == "mamba" for x in cfg.pattern) else "")
    print(f"[path {path}] {label} decode parity vs forward at position {s} "
          f"(ragged{chunks}): rel err by sequence "
          f"{[f'{r:.3g}' for r in rel]} "
          f"({'limit' if held else 'printed, not held; the limit'} "
          f"{tol:g} where the routing agrees); routing flipped in "
          f"sequences {sorted(flipped)}; greedy tokens forward "
          f"{a.argmax(-1).tolist()} decode {d.argmax(-1).tolist()} "
          f"({'same' if same else 'differ'})", flush=True)
    for note in notes:
        print(f"[path {path}]   {note}", flush=True)
    if bad:
        raise AssertionError(f"path {path} {label}: routing flips at gaps "
                             f"{bad}")
    kept = [r for seq, r in enumerate(rel) if seq not in flipped]
    if held and kept and max(kept) >= tol:
        raise AssertionError(f"path {path} {label} decode parity {rel}, "
                             f"flipped {sorted(flipped)}")


def phase_moe_serve(torch, dev, path: int) -> dict:
    """Paths 15-17 (``MOE_PATHS``): one configuration served at its
    published widths.  Returns the launch counts of its prefill + decode
    run, with the flash rows' counts by route."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves
    cfg = moe_path_config(path)
    full = configs.get(MOE_PATHS[path][0])
    b, s, n_gen = MOE_B, MOE_PROMPT, MOE_GEN
    gen = torch.Generator(device=dev).manual_seed(SEED + path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp = transformer.serving_params(transformer.init(gen, cfg), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = transformer.param_count(cfg)
    if n_params != MOE_PATHS[path][1]:
        raise AssertionError(f"path {path}: {n_params} parameters, "
                             f"reckoned {MOE_PATHS[path][1]}")
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(sp))
    attn = cfg.num_groups * sum(x.mixer == "attn" for x in cfg.pattern)
    moes = cfg.num_groups * sum(x.ffn == "moe" for x in cfg.pattern)
    mamba = (f", Mamba d_inner {cfg.ssm_d_inner} in {cfg.ssm_num_heads} "
             f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state_dim}, "
             f"chunk {cfg.ssm_chunk}"
             if any(x.mixer == "mamba" for x in cfg.pattern) else "")
    print(f"[path {path}] {cfg.name} cut to {cfg.num_layers} of "
          f"{full.num_layers} layers "
          f"({', '.join(x.mixer + '+' + x.ffn for x in cfg.pattern)} x "
          f"{cfg.num_groups}) at its published widths: d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV "
          f"heads of {cfg.resolved_head_dim}, window {cfg.sliding_window}, "
          f"{cfg.num_experts} experts top-{cfg.num_experts_per_tok} of d_ff "
          f"{cfg.d_ff}{mamba}, vocab {cfg.vocab_size}; {n_params} parameters "
          f"(the reckoning's {MOE_PATHS[path][1]}; "
          f"{transformer.active_param_count(cfg)} active), "
          f"{n_bytes / 2 ** 30:.2f} GiB made in {cfg.dtype_params} in "
          f"{t_init:.2f}s; moe_impl {cfg.moe_impl}, groups of "
          f"{cfg.moe_group_size}, capacity factor {cfg.moe_capacity_factor}",
          flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    pad_to = s + n_gen + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with moe_records() as rec:
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(sp, prompt, cfg, pad_to=pad_to)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
    if len(rec["keep"]) != moes:
        raise AssertionError(f"path {path}: {len(rec['keep'])} dispatches "
                             f"for {moes} MoE layers")
    groups = rec["keep"][0].shape[0]
    drops = [f"{1 - float(k.float().mean()):.4f}" for k in rec["keep"]]
    del rec
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"path {path}: non-finite prefill logits")
    first_tok = tok = logits[:, -1].argmax(-1)[:, None]
    logits, cache = transformer.decode_step(sp, tok, cache, s, cfg)
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n_gen):
        logits, cache = transformer.decode_step(sp, tok, cache, s + i, cfg)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (n_gen - 1)
    counts = read_counts()
    routes = dict(fa.flash_attention.route_launches)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"path {path}: non-finite decode logits")
    print(f"[path {path}] B={b} prompt {s}, pad_to {pad_to}: prefill cold "
          f"{cold:.3f}s; decode {n_gen} greedy steps, warm "
          f"{step_s * 1e3:.3f} ms per step = {b / step_s:.1f} tokens/s; "
          f"share of MoE assignments dropped in prefill ({groups} groups "
          f"of {cfg.moe_group_size}), by MoE layer: {drops}; flash "
          f"launches by route {routes}; launches {counts}", flush=True)
    want = dict.fromkeys(_counters(), 0)
    want["flash_attention"] = attn * (1 + n_gen)
    want_routes = dict(prefill_tc=attn, prefill_f32=0, decode=attn * n_gen,
                       backward=0, backward_tc=0)
    if routes != want_routes or counts != want:
        raise AssertionError(f"path {path}: flash routes {routes}, launches "
                             f"{counts}; expected {want_routes}, {want}")
    del cache
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(sp, prompt, cfg, pad_to=pad_to)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[path {path}] prefill warm {warm:.3f}s = {b * s / warm:.0f} "
          f"tokens/s; max_memory_allocated {peak / 2 ** 30:.2f} GiB",
          flush=True)
    wall, busy, flash, n_kern = profile_device(
        torch, lambda: transformer.decode_step(sp, tok, cache, s + n_gen,
                                               cfg), host_top=8)
    print(f"[path {path}] profiled decode step: wall {wall / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {n_kern} device kernels; flash_attention "
          f"{flash / 1e3:.3f} ms = {flash / busy:.3f} of device time",
          flush=True)
    del cache, logits
    wall, busy, flash, n_kern = profile_device(
        torch, lambda: transformer.prefill(sp, prompt, cfg, pad_to=pad_to))
    print(f"[path {path}] profiled prefill: wall {wall / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall:.3f}, "
          f"{n_kern} device kernels; flash_attention {flash / 1e3:.1f} ms = "
          f"{flash / busy:.3f} of device time", flush=True)
    # Decode parity against forward at the last position needs a dropless
    # dispatch: at a capacity factor of 1.25, forward's one group of
    # B (S + 1) tokens drops other assignments than the prefill's groups
    # of 4096 and decode's of B.  So it routes through ``ragged`` (each
    # expert's tokens, nothing dropped): in bf16, and in f32 compute on
    # the same bf16 weights (every weight cast at use, TF32 off), where
    # every sequence is held at the f32 limit.  Jamba's bf16 reading is
    # printed, not held: its Mamba layers round forward and decode
    # apart by the reference's own arithmetic (forward adds D and sums
    # the conv taps in bf16, decode in f32), which puts the hybrid at
    # 1.7e-2 - 2.0e-2 of the 2e-2 limit at full width, and the
    # reference's own bf16 prefill + decode at 1.0e-2 - 1.9e-2 of forward
    # on jamba's first four positions at reduced width.
    hybrid = any(x.mixer == "mamba" for x in cfg.pattern)
    moe_parity(torch, transformer, sp, cfg, prompt, "bf16", path,
               SERVE_PARITY_TOL, held=not hybrid)
    print(f"[path {path}] greedy first tokens (dense_grouped) "
          f"{first_tok[:, 0].tolist()}", flush=True)
    moe_parity(torch, transformer, sp,
               dataclasses.replace(cfg, dtype_compute="float32"), prompt,
               "f32 compute", path, SERVE_F32_PARITY_TOL, flips=False)
    del sp
    torch.cuda.empty_cache()
    return dict(counts, flash_attention=routes["prefill_tc"],
                flash_attention_decode=routes["decode"])


# ``--moe-prefill``: only paths 15-17's prefill, each warm run timed
# MOE_PREFILL_RUNS times, with the peak memory it adds above the served
# weights.  It runs whatever tree of the port lies beside this file, so
# two trees compare on one card with a copy of this file in each root.
MOE_PREFILL_RUNS = 5


def moe_prefill_only(torch, dev) -> None:
    from repro_torch.models import transformer
    for path in MOE_PATHS:
        cfg = moe_path_config(path)
        gen = torch.Generator(device=dev).manual_seed(SEED + path)
        sp = transformer.serving_params(transformer.init(gen, cfg), cfg)
        prompt = torch.randint(0, cfg.vocab_size, (MOE_B, MOE_PROMPT),
                               generator=gen, device=dev)

        def run():
            return transformer.prefill(sp, prompt, cfg,
                                       pad_to=MOE_PROMPT + MOE_GEN + 1)
        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(MOE_PREFILL_RUNS):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del out
        peak = torch.cuda.max_memory_allocated()
        print(f"[moe-prefill] path {path} {cfg.name} B={MOE_B} prompt "
              f"{MOE_PROMPT}: warm prefill walls "
              f"{[f'{w:.4f}' for w in walls]} s, median {median(walls):.4f}"
              f" s; peak {peak / 2 ** 30:.3f} GiB, "
              f"{(peak - base) / 2 ** 30:.3f} GiB above the weights",
              flush=True)
        del sp, prompt
        torch.cuda.empty_cache()


def phase_moe_card_vs_cpu(torch, dev) -> None:
    """The three configurations of paths 15-17 at ``reduced()`` with
    ``MOE_CARD_CPU_DISPATCH``, on the card and the CPU (f32, TF32 off):
    forward, prefill of 128 tokens (8 dispatch groups) and 3 decode steps
    within 1e-4, every MoE call's expert ids equal, and drops in several
    of the prefill's groups."""
    from repro_torch import configs
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s, steps = 2, 128, 3
    for path, (arch, _) in MOE_PATHS.items():
        cfg = dataclasses.replace(configs.get(arch).reduced(),
                                  **MOE_CARD_CPU_DISPATCH)
        gen = torch.Generator().manual_seed(SEED + path)
        params = transformer.init(gen, cfg)
        tokens = torch.randint(0, cfg.vocab_size, (b, s + steps),
                               generator=gen)
        outs, ids, keeps = {}, {}, {}
        for device in ("cpu", dev):
            p = _to(params, device)
            t = tokens.to(device)
            with moe_records() as rec:
                got = [transformer.forward(p, t, cfg)[0]]
                logits, cache = transformer.prefill(p, t[:, :s], cfg,
                                                    pad_to=s + steps)
                got.append(logits)
                for i in range(steps):
                    logits, cache = transformer.decode_step(
                        p, t[:, s + i:s + i + 1], cache, s + i, cfg)
                    got.append(logits)
            outs[str(device)] = [x.float().cpu() for x in got]
            ids[str(device)] = [x.cpu() for x in rec["ids"]]
            keeps[str(device)] = [x.cpu() for x in rec["keep"]]
        rel = max(float((c - g).abs().max() / c.abs().max())
                  for c, g in zip(outs["cpu"], outs[str(dev)]))
        same_ids = len(ids["cpu"]) == len(ids[str(dev)]) and all(
            torch.equal(a, c) for a, c in zip(ids["cpu"], ids[str(dev)]))
        same_keep = all(torch.equal(a, c)
                        for a, c in zip(keeps["cpu"], keeps[str(dev)]))
        moes = cfg.num_groups * sum(x.ffn == "moe" for x in cfg.pattern)
        # Calls in order: forward's, prefill's, then each decode step's.
        pre = keeps["cpu"][moes:2 * moes]
        dropping = [int((~k).any(dim=(1, 2)).sum()) for k in pre]
        print(f"[card-vs-cpu] {cfg.name} reduced f32, groups of "
              f"{cfg.moe_group_size}, capacity factor "
              f"{cfg.moe_capacity_factor}: forward, prefill + {steps} decode "
              f"steps, logits max rel err {rel:.3g} (limit "
              f"{DENSE_CARD_CPU_TOL:g}); {len(ids['cpu'])} MoE calls, expert "
              f"ids {'equal' if same_ids else 'differ'}, kept assignments "
              f"{'equal' if same_keep else 'differ'}; prefill groups "
              f"dropping, by MoE layer: {dropping} of {pre[0].shape[0]}",
              flush=True)
        if not (rel <= DENSE_CARD_CPU_TOL and same_ids and same_keep):
            raise AssertionError(f"{cfg.name}: card and CPU differ")
        if min(dropping) < 2:
            raise AssertionError(f"{cfg.name}: drops in {dropping} groups")


# Paths 18-19: the VLM and the encoder-decoder served at their published
# widths, random weights made in bf16 (``dtype_params``) from a seed.
# Path 18 is qwen2-vl-72b (arXiv 2409.12191) cut to 8 of its 80 layers:
# the whole model is 72,705,384,448 parameters, 145 GB in bf16, and does
# not fit one 80 GB card.  B = 4; the prompt is 4096 rows of patch
# embeddings, one 1792 x 1792 image after Qwen2-VL's 14-pixel patches
# and 2 x 2 merge ((1792 / 28)^2 = 4096), at the text-like M-RoPE
# positions the reference's prefill gives; then 32 greedy text steps.
# Path 19 is whisper-small (arXiv 2212.04356) at full depth and width:
# B = 16 clips of 30 s, 1500 stub frame embeddings each, a 64-token
# decoder prompt, the self-attention cache padded to whisper's 448-token
# text context, 32 greedy steps.  Each entry: the architecture, the
# layers kept (0: all), the parameters as the reference's
# ``transformer.param_count`` reckons them, B, prompt rows, encoder
# frames, the self-attention cache's length (0: prompt + steps + 1), and
# whether the bf16 decode parity is held (see ``phase_media_serve``).
MEDIA_PATHS = {
    18: dict(arch="qwen2_vl_72b", layers=8, params=9_512_820_736, b=4,
             prompt=4096, frames=0, ctx=0, bf16_held=False),
    19: dict(arch="whisper_small", layers=0, params=278_143_488, b=16,
             prompt=64, frames=1500, ctx=448, bf16_held=True),
}
MEDIA_GEN = 32


def media_path_config(path: int):
    from repro_torch import configs
    spec = MEDIA_PATHS[path]
    cfg = dataclasses.replace(configs.get(spec["arch"]),
                              dtype_params="bfloat16")
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
    return cfg


@contextlib.contextmanager
def attention_calls():
    """Count the model's ``flash_attention`` calls by (Sq, Skv, causal)
    while the block runs (the wrapper, which counts launches, does the
    work)."""
    import collections
    from repro_torch.models import attention
    calls = collections.Counter()
    wrapped = attention.flash_attention

    def recorded(q, k, v, **kw):
        calls[(q.shape[1], k.shape[1], kw.get("causal", True))] += 1
        return wrapped(q, k, v, **kw)
    attention.flash_attention = recorded
    try:
        yield calls
    finally:
        attention.flash_attention = wrapped


def media_calls(cfg, s: int, frames: int, cache_len: int, steps: int):
    """The attention calls of a prefill of ``s`` rows and ``steps``
    decode steps, by (Sq, Skv, causal): decoder self-attention (causal
    at prefill, then against the cache), and under an encoder the
    encoder's (non-causal over the frames) and cross-attention's (the
    decoder rows, then each step's token, against the frames)."""
    calls = {(s, s, True): cfg.num_layers,
             (1, cache_len, False): steps * cfg.num_layers}
    if cfg.is_encdec:
        calls[(frames, frames, False)] = cfg.encoder_layers
        calls[(s, frames, False)] = cfg.num_layers
        calls[(1, frames, False)] = steps * cfg.num_layers
    return calls


def media_parity(torch, transformer, params, cfg, prompt, enc, label: str,
                 path: int, tol: float, held: bool = True) -> None:
    """Prefill + one decode step against ``forward`` over the prompt and
    the decoded token (its embedding row after an embeddings prompt) at
    the last position: max-abs error over the max-abs logit, within
    ``tol``; and the same greedy token wherever forward's top-two margin
    exceeds twice that error.  ``held=False`` only prints them."""
    s = prompt.shape[1]
    logits, cache = transformer.prefill(params, prompt, cfg,
                                        encoder_inputs=enc, pad_to=s + 1)
    tok = logits[:, -1].argmax(-1)[:, None]
    logits, cache = transformer.decode_step(params, tok, cache, s, cfg)
    del cache
    d = logits[:, 0].float()
    nxt = (torch.nn.functional.embedding(tok, params["embed"]).to(
        prompt.dtype) if prompt.is_floating_point() else tok)
    hidden, _ = transformer.forward(params, torch.cat([prompt, nxt], 1), cfg,
                                    encoder_inputs=enc, return_hidden=True)
    last = hidden[:, -1]
    del hidden
    a = (last @ transformer.head_matrix(params, cfg).to(last.dtype)).float()
    rel = float((a - d).abs().max() / a.abs().max())
    top = a.topk(2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]) / a.abs().max()
    same = a.argmax(-1) == d.argmax(-1)
    decided = margin > 2 * rel
    print(f"[path {path}] {label} decode parity vs forward at position {s}: "
          f"rel err {rel:.3g} ({'limit' if held else 'printed, not held; the '
                                'limit'} {tol:g}); greedy tokens forward "
          f"{a.argmax(-1).tolist()} decode {d.argmax(-1).tolist()}; "
          f"{int(same.sum())} of {len(same)} equal, every one of the "
          f"{int(decided.sum())} whose forward top-two margin over the max "
          f"logit exceeds twice the error must be (smallest margin "
          f"{float(margin.min()):.2e})", flush=True)
    if held and not (rel < tol and bool(same[decided].all())):
        raise AssertionError(f"path {path} {label}: decode parity {rel}, "
                             f"tokens {same.tolist()}")


def phase_media_serve(torch, dev, path: int) -> dict:
    """Paths 18-19 (``MEDIA_PATHS``): the VLM on an embeddings prompt or
    the encoder-decoder on frame embeddings, served at published widths.
    Returns the launch counts of its prefill + decode run, with the
    flash rows' counts by route."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves
    spec = MEDIA_PATHS[path]
    cfg = media_path_config(path)
    full = configs.get(spec["arch"])
    b, s, frames, n_gen = spec["b"], spec["prompt"], spec["frames"], MEDIA_GEN
    pad_to = spec["ctx"] or s + n_gen + 1
    gen = torch.Generator(device=dev).manual_seed(SEED + path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp = transformer.serving_params(transformer.init(gen, cfg), cfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = transformer.param_count(cfg)
    if n_params != spec["params"]:
        raise AssertionError(f"path {path}: {n_params} parameters, "
                             f"reckoned {spec['params']}")
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(sp))
    cut = (f"cut to {cfg.num_layers} of {full.num_layers} layers "
           f"({transformer.param_count(full)} parameters, "
           f"{transformer.param_count(full) * 2 / 1e9:.1f} GB in bf16, do "
           f"not fit one 80 GB card)" if cfg.num_layers < full.num_layers
           else f"at full depth ({cfg.encoder_layers} encoder + "
                f"{cfg.num_layers} decoder layers)")
    print(f"[path {path}] {cfg.name} {cut} at its published widths: "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} KV heads of {cfg.resolved_head_dim}, d_ff "
          f"{cfg.d_ff} ({cfg.mlp_activation}, {cfg.norm_type}), vocab "
          f"{cfg.vocab_size}, positions {cfg.pos_embedding}"
          f"{f' M-RoPE {cfg.mrope_sections}' if cfg.mrope_sections else ''}"
          f"; {n_params} parameters (the reckoning's {spec['params']}), "
          f"{n_bytes / 2 ** 30:.2f} GiB made in {cfg.dtype_params} in "
          f"{t_init:.2f}s", flush=True)
    dt = torch.bfloat16
    if cfg.input_mode == "embeddings":
        prompt = torch.randn((b, s, cfg.d_model), generator=gen,
                             device=dev).to(dt)
    else:
        prompt = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=dev)
    enc = (torch.randn((b, frames, cfg.d_model), generator=gen,
                       device=dev).to(dt) if cfg.is_encdec else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with attention_calls() as calls:
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(sp, prompt, cfg,
                                            encoder_inputs=enc,
                                            pad_to=pad_to)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"path {path}: non-finite prefill logits")
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, cache = transformer.decode_step(sp, tok, cache, s, cfg)
    want_calls = media_calls(cfg, s, frames, pad_to, 1)
    print(f"[path {path}] attention calls of the prefill and the first "
          f"decode step by (Sq, Skv, causal): {dict(calls)}", flush=True)
    if dict(calls) != want_calls:
        raise AssertionError(f"path {path}: attention calls {dict(calls)}, "
                             f"expected {want_calls}")
    tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, n_gen):
        logits, cache = transformer.decode_step(sp, tok, cache, s + i, cfg)
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (n_gen - 1)
    counts = read_counts()
    routes = dict(fa.flash_attention.route_launches)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"path {path}: non-finite decode logits")
    want_run = media_calls(cfg, s, frames, pad_to, n_gen)
    n_pre = sum(n for (sq, _, _), n in want_run.items() if sq > 1)
    n_dec = sum(want_run.values()) - n_pre
    want = dict.fromkeys(_counters(), 0)
    want["flash_attention"] = n_pre + n_dec
    want_routes = dict(prefill_tc=n_pre, prefill_f32=0, decode=n_dec,
                       backward=0, backward_tc=0)
    print(f"[path {path}] B={b} prompt {s}"
          f"{f', {frames} encoder frames' if frames else ''}, cache "
          f"{pad_to}: prefill cold {cold:.3f}s; decode {n_gen} greedy "
          f"steps, warm {step_s * 1e3:.3f} ms per step = "
          f"{b / step_s:.1f} tokens/s; flash_attention.route_launches "
          f"{routes}; launches {counts}", flush=True)
    if routes != want_routes or counts != want:
        raise AssertionError(f"path {path}: flash routes {routes}, launches "
                             f"{counts}; expected {want_routes}, {want}")
    del cache
    enc_line = ""
    if cfg.is_encdec:
        transformer.encode(sp, enc, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transformer.encode(sp, enc, cfg)
        torch.cuda.synchronize()
        enc_line = f"encode warm {time.perf_counter() - t0:.4f}s; "
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(sp, prompt, cfg, encoder_inputs=enc,
                                        pad_to=pad_to)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[path {path}] {enc_line}prefill warm {warm:.4f}s"
          f"{' (time to first token, the encoder included)' if enc_line else ''}"
          f" = {b * s / warm:.0f} prompt rows/s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    wall, busy, flash, n_kern = profile_device(
        torch, lambda: transformer.decode_step(sp, tok, cache, s + n_gen,
                                               cfg), host_top=8)
    print(f"[path {path}] profiled decode step: wall {wall / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {n_kern} device kernels; flash_attention "
          f"{flash / 1e3:.3f} ms = {flash / busy:.3f} of device time",
          flush=True)
    del cache, logits
    wall, busy, flash, n_kern = profile_device(
        torch, lambda: transformer.prefill(sp, prompt, cfg,
                                           encoder_inputs=enc, pad_to=pad_to))
    print(f"[path {path}] profiled prefill: wall {wall / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall:.3f}, "
          f"{n_kern} device kernels; flash_attention {flash / 1e3:.1f} ms = "
          f"{flash / busy:.3f} of device time", flush=True)
    # Path 18's bf16 reading is printed, not held: 8 layers of bf16
    # rounding put prefill + decode 1.98e-2 from forward at full width (an
    # H100 80GB HBM3 at 700 W), at the 2e-2 limit, by the model's own
    # arithmetic: the reference's bf16 prefill + decode parts from its
    # forward by 1.4e-2 at reduced(num_layers=8) with the same kind of
    # prompt (the port 1.3e-2), and by 4e-3 at 2 layers.  The f32 compute
    # run below holds every path's parity.
    media_parity(torch, transformer, sp, cfg, prompt, enc, "bf16", path,
                 SERVE_PARITY_TOL, held=spec["bf16_held"])
    # The same bf16 weights in f32 compute (each cast at use), TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    media_parity(torch, transformer, sp,
                 dataclasses.replace(cfg, dtype_compute="float32"), prompt,
                 enc, "f32 compute", path, SERVE_F32_PARITY_TOL)
    del sp
    torch.cuda.empty_cache()
    return dict(counts, flash_attention=routes["prefill_tc"],
                flash_attention_decode=routes["decode"])


def grid_positions(torch, b: int, prefix: int, rows: int, cols: int,
                   tail: int):
    """(3, B, S) M-RoPE ids of ``prefix`` text tokens, an image of
    ``rows`` x ``cols`` merged patches and ``tail`` text tokens, as
    Qwen2-VL's ``get_rope_index`` lays them: text runs on all three axes;
    the image holds t and spreads h and w over its grid from where the
    text stopped; text resumes one past the largest id."""
    r, c = torch.meshgrid(torch.arange(rows), torch.arange(cols),
                          indexing="ij")
    img = torch.stack([torch.zeros(rows * cols, dtype=torch.long),
                       r.flatten(), c.flatten()]) + prefix
    nxt = prefix + max(rows, cols)
    pos = torch.cat([torch.arange(prefix).expand(3, prefix), img,
                     torch.arange(nxt, nxt + tail).expand(3, tail)], dim=1)
    return pos[:, None].expand(3, b, pos.shape[1]).contiguous()


def phase_media_card_vs_cpu(torch, dev) -> None:
    """The configurations of paths 18-19 at ``reduced()`` on the card and
    the CPU (f32, TF32 off), within 1e-4 of the largest logit: qwen2-vl's
    ``forward`` over an image grid's three-axis positions (t = 0, h and w
    over an 8 x 8 grid, 69 rows) and its embeddings prefill; whisper's
    ``encode`` (150 frames) and ``forward``, and its prefill of 40
    tokens; each then 3 decode steps."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, steps = 2, 3
    for path, spec in MEDIA_PATHS.items():
        cfg = configs.get(spec["arch"]).reduced()
        gen = torch.Generator().manual_seed(SEED + path)
        params = transformer.init(gen, cfg)
        enc, positions = None, None
        if cfg.is_encdec:
            s = 40
            enc = torch.randn((b, 150, cfg.d_model), generator=gen)
            prompt = torch.randint(0, cfg.vocab_size, (b, s + steps),
                                   generator=gen)
            full, prompt = prompt, prompt[:, :s]
            toks = full[:, s:]
        else:
            positions = grid_positions(torch, b, 3, 8, 8, 2)
            s = positions.shape[-1]
            prompt = torch.randn((b, s, cfg.d_model), generator=gen)
            full = prompt
            toks = torch.randint(0, cfg.vocab_size, (b, steps),
                                 generator=gen)
        outs = {}
        before = dict(fa.flash_attention.route_launches)
        for device in ("cpu", dev):
            p = _to(params, device)
            e = None if enc is None else enc.to(device)
            got = []
            if e is not None:
                got.append(transformer.encode(p, e, cfg))
            got.append(transformer.forward(
                p, full.to(device), cfg,
                positions=None if positions is None else positions.to(device),
                encoder_inputs=e)[0])
            logits, cache = transformer.prefill(p, prompt.to(device), cfg,
                                                encoder_inputs=e,
                                                pad_to=s + steps)
            got.append(logits)
            for i in range(steps):
                logits, cache = transformer.decode_step(
                    p, toks[:, i:i + 1].to(device), cache, s + i, cfg)
                got.append(logits)
            outs[str(device)] = [x.float().cpu() for x in got]
        routed = {r: n - before[r]
                  for r, n in fa.flash_attention.route_launches.items()}
        rels = [float((c - g).abs().max() / c.abs().max())
                for c, g in zip(outs["cpu"], outs[str(dev)])]
        per_pass = cfg.num_layers + (cfg.encoder_layers + cfg.num_layers
                                     if cfg.is_encdec else 0)
        want = dict(prefill_tc=0, prefill_f32=2 * per_pass + (
            cfg.encoder_layers if cfg.is_encdec else 0),
            decode=steps * cfg.num_layers * (2 if cfg.is_encdec else 1),
            backward=0, backward_tc=0)
        print(f"[card-vs-cpu] {cfg.name} reduced f32 "
              f"({'encode, ' if enc is not None else ''}forward"
              f"{'' if enc is not None else ' over grid positions'}, "
              f"prefill + {steps} decode steps): logits max rel err "
              f"{[f'{r:.3g}' for r in rels]} (limit {DENSE_CARD_CPU_TOL:g}); "
              f"card flash launches by route {routed}", flush=True)
        if routed != want:
            raise AssertionError(f"{cfg.name}: card routes {routed}, "
                                 f"expected {want}")
        if not max(rels) <= DENSE_CARD_CPU_TOL:
            raise AssertionError(f"{cfg.name}: card and CPU differ by {rels}")


def phase_train(torch, dev, smi: str) -> dict:
    """Path 13: the federated trainer (``launch.train``'s own setup,
    batch and schedule, ``launch.steps``' federated step) at full width
    and depth.  Returns the launch counts of its TRAIN_STEPS steps."""
    from repro_torch.checkpoint import msgpack_ckpt
    from repro_torch.kernels import fedavg_agg as fk
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer
    run = train.setup(train.parse_args([
        "--arch", "xlstm-125m", "--federated", str(TRAIN_K), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--seed",
        str(SEED + 13)]))
    cfg, ocfg, gen, state, clients, step = (run.cfg, run.ocfg, run.gen,
                                            run.state, run.clients, run.step)
    on = run.dev
    del run
    per_pass = steps.pass_size(TRAIN_K, TRAIN_BATCH // TRAIN_K * TRAIN_SEQ)
    print(f"[path 13] {cfg.name} federated on {on}: "
          f"{transformer.param_count(cfg)} parameters, K={TRAIN_K} clients, "
          f"global batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamW lr "
          f"{ocfg.learning_rate} warmup {ocfg.warmup_steps}, DAS (n_min "
          f"{clients.scfg.n_min}, {clients.scfg.allocator}, iterations_max "
          f"{clients.scfg.iterations_max}); per-client gradients by "
          f"torch.func.vmap(grad), {per_pass} clients a pass (the CLI's "
          f"default: {steps.PASS_TOKENS} tokens a pass)", flush=True)

    def iteration(out: list) -> None:
        """One iteration of the driver's loop, timed by part."""
        t0 = time.perf_counter()
        batch = train.driver_batch(gen, TRAIN_BATCH, TRAIN_SEQ,
                                   cfg.vocab_size, clients)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new, metrics = step(out[0], batch)
        ce, n_sel = float(metrics["ce"]), int(metrics["n_selected"])
        t2 = time.perf_counter()
        out[:] = [new, (t2 - t0, t1 - t0, t2 - t1), ce, n_sel,
                  batch["selected"].int().tolist(),
                  float(metrics["grad_norm"])]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, out = [], [state]
    for i in range(TRAIN_STEPS):
        how = ("cold" if i == 0 else "profiled" if i == TRAIN_STEPS - 1
               else "warm")
        if how == "profiled":
            prof = profile_scopes(torch, lambda: iteration(out),
                                  TRAIN_SCOPES)
        else:
            iteration(out)
        state, wall, ce, n_sel, selected, gnorm = out
        out = [state]
        walls.append(wall)
        if not (math.isfinite(ce) and n_sel >= clients.scfg.n_min):
            raise AssertionError(f"path 13 step {i}: ce {ce}, n_selected "
                                 f"{n_sel}")
        print(f"[path 13] step {i} ({how}): wall {wall[0]:.3f}s = batch + "
              f"schedule {wall[1]:.3f}s + federated step {wall[2]:.3f}s; ce "
              f"{ce:.4f}; n_selected {n_sel} {selected}; grad_norm "
              f"{gnorm:.4f}", flush=True)
    counts = read_counts()
    routes = dict(fk.fedavg_agg.route_launches)
    peak = torch.cuda.max_memory_allocated()
    want = dict(dict.fromkeys(_counters(), 0), fedavg_agg=TRAIN_STEPS)
    print(f"[path 13] launches {counts}; fedavg_agg by route {routes}",
          flush=True)
    if counts != want or routes["vec4"] != TRAIN_STEPS:
        raise AssertionError(f"path 13 launch counts {counts}, routes "
                             f"{routes}, expected {want}, all vec4")
    warm, tokens = walls[1], TRAIN_BATCH * TRAIN_SEQ
    print(f"[path 13] warm wall a step {warm[0]:.3f}s = {tokens / warm[0]:.0f}"
          f" tokens/s (federated step {warm[2]:.3f}s = "
          f"{tokens / warm[2]:.0f} tokens/s, batch + schedule "
          f"{warm[1]:.3f}s); max_memory_allocated {peak / 2 ** 30:.2f} GiB; "
          f"{smi}", flush=True)
    print(f"[path 13] profiled step: wall {prof['wall_us'] / 1e6:.3f}s, "
          f"device busy {prof['busy_us'] / 1e6:.3f}s, idle share "
          f"{1 - prof['busy_us'] / prof['wall_us']:.3f} (against the "
          f"unprofiled warm step: {1 - prof['busy_us'] / 1e6 / warm[0]:.3f});"
          f" {prof['launches']} launches ({prof['device_ops']} device "
          f"operations) by scope {prof['per_scope']}; host ms by scope "
          f"{ {k: round(v, 1) for k, v in prof['host_ms'].items()} }",
          flush=True)
    os.makedirs(os.path.join(ROOT, "build", "train"), exist_ok=True)
    path = os.path.join(ROOT, "build", "train", "path13.msgpack")
    t0 = time.perf_counter()
    msgpack_ckpt.save(path, state["params"],
                      meta={"step": TRAIN_STEPS, "arch": cfg.name})
    save_ms = (time.perf_counter() - t0) * 1e3
    print(f"[path 13] checkpoint {os.path.getsize(path)} bytes saved in "
          f"{save_ms:.0f} ms", flush=True)
    os.remove(path)
    train_microbatches(torch, cfg, state["params"], gen)
    del state
    torch.cuda.empty_cache()
    return counts


def microbatch_agreement(torch, cfg, params, batch) -> dict:
    """``make_train_step`` with 1 and 2 microbatches from ``params`` on
    ``batch``, SGD as the reference test takes it (momentum 0, lr 0.05,
    no clip or warmup).  Returns, read back at once: ``excess`` the
    largest |a - b| - TRAIN_MB_TOL |b| over the two steps' parameters,
    ``ce`` the two ce's relative difference, ``grad`` the relative
    distance ||g1 - g2|| / ||g1|| of the gradients the two steps hand
    the optimizer (recorded on their way into ``optim.apply_updates``),
    ``finite`` whether every parameter, gradient and ce is finite; and
    each step's wall and peak memory.  A NaN anywhere makes every number
    NaN or ``finite`` False."""
    from repro_torch import optim
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    ocfg = optim.OptimizerConfig(name="sgd", momentum=0.0, learning_rate=0.05,
                                 grad_clip=0.0, warmup_steps=0)
    state = {"params": params, "opt": optim.init_state(params, ocfg)}
    cuda = tree_leaves(params)[0].is_cuda
    apply_updates, handed = optim.apply_updates, []

    def recorded(params, grads, *args):
        handed.append(grads)
        return apply_updates(params, grads, *args)

    new, ce, out = {}, {}, {}
    optim.apply_updates = recorded
    try:
        for mb in (1, 2):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            got, metrics = steps.make_train_step(cfg, ocfg, mb)(state, batch)
            new[mb], ce[mb] = tree_leaves(got["params"]), metrics["ce"]
            if cuda:
                torch.cuda.synchronize()
            out[f"wall{mb}"] = time.perf_counter() - t0
            out[f"peak{mb}"] = (torch.cuda.max_memory_allocated() if cuda
                                else 0)
    finally:
        optim.apply_updates = apply_updates
    names = leaf_paths(handed[0])
    (g1, g2), a, b = map(tree_leaves, handed), new[1], new[2]
    excess = torch.stack([((x - y).abs() - TRAIN_MB_TOL * y.abs()).amax()
                          for x, y in zip(a, b)]).amax()
    apart = torch.stack([torch.sum(torch.square(x.float() - y.float()))
                         for x, y in zip(g1, g2)])
    norm = torch.stack([torch.sum(torch.square(x.float())) for x in g1])
    finite = torch.stack([torch.isfinite(x).all() for x in a + b + g1 + g2]
                         + [torch.isfinite(ce[1]), torch.isfinite(ce[2])]
                         ).all()
    vals = torch.stack([excess, (ce[1] - ce[2]).abs() / ce[1].abs(),
                        torch.sqrt(apart.sum() / norm.sum()),
                        finite.float(), ce[1], ce[2]]).tolist()
    out.update(zip(("excess", "ce", "grad", "finite", "ce1", "ce2"), vals))
    out["finite"] = out["finite"] == 1.0
    # Where the gradients part: the leaf with the largest share of
    # ||g1 - g2||^2, and the spread of the leaves' own relative distances.
    apart, norm = apart.tolist(), norm.tolist()
    i = max(range(len(apart)), key=apart.__getitem__)
    rels = sorted((d / n) ** 0.5 for d, n in zip(apart, norm) if n > 0)
    out["where"] = (f"{names[i]} {apart[i] / max(sum(apart), 1e-300):.2f} "
                    f"of it (its own {(apart[i] / norm[i]) ** 0.5:.3g}); "
                    f"leaves {rels[0]:.3g} - {rels[-1]:.3g}, median "
                    f"{rels[len(rels) // 2]:.3g}")
    return out


def leaf_paths(tree, prefix: str = "") -> list:
    """The '/'-joined key paths of ``tree``'s leaves, in
    ``tree_leaves``' order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k, v in tree.items()
            for p in leaf_paths(v, f"{prefix}/{k}")]


def microbatches_agree(m: dict, grad_tol: float) -> bool:
    return (m["finite"] and m["excess"] <= TRAIN_MB_TOL
            and m["ce"] <= TRAIN_MB_CE_RTOL and m["grad"] <= grad_tol)


def train_microbatches(torch, cfg, params, gen) -> None:
    """One plain step at path 13's width, depth and sequence in f32 with
    TF32 off (TRAIN_MB_BATCH x 512), 1 and 2 microbatches, from path 13's
    last parameters (``microbatch_agreement``)."""
    from repro_torch.launch import train
    f32 = dataclasses.replace(cfg, dtype_compute="float32")
    batch = train.synthetic_lm_batch(gen, TRAIN_MB_BATCH, TRAIN_SEQ,
                                     cfg.vocab_size)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m = microbatch_agreement(torch, f32, params, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for mb in (1, 2):
        print(f"[path 13] plain SGD step, f32, {TRAIN_MB_BATCH} x "
              f"{TRAIN_SEQ}, {mb} microbatch(es): wall {m[f'wall{mb}']:.3f}s"
              f" (first call), ce {m[f'ce{mb}']:.4f}, max_memory_allocated "
              f"{m[f'peak{mb}'] / 2 ** 30:.2f} GiB", flush=True)
    print(f"[path 13] plain step mb 1 vs mb 2: max(|a - b| - "
          f"{TRAIN_MB_TOL:g} |b|) = {m['excess']:.3g} (limit "
          f"{TRAIN_MB_TOL:g}), ce rel {m['ce']:.3g} (limit "
          f"{TRAIN_MB_CE_RTOL:g}), gradient rel {m['grad']:.3g} (limit "
          f"{TRAIN_MB_GRAD_TOL:g}), all finite {m['finite']}; gradients "
          f"part most in {m['where']}", flush=True)
    if not microbatches_agree(m, TRAIN_MB_GRAD_TOL):
        raise AssertionError(f"path 13 mb 1 vs mb 2: {m}")


def phase_xlstm_card_vs_cpu(torch, dev) -> None:
    """xlstm-125m at ``reduced(num_layers=4)``, f32 with TF32 off, one set
    of weights and batches on the card and the CPU: forward logits,
    prefill of 128 positions (two mLSTM chunks of 64) + 3 decode steps,
    and one federated step (K = 3, the reference test's selection
    [1, 0, 1] and sizes [100, 999, 300], SGD lr 0.1); then, on the card,
    the plain step with 1 and 2 microbatches (``microbatch_agreement``,
    the gradients within TRAIN_MB_GRAD_TOL_REDUCED)."""
    from repro_torch import configs, optim
    from repro_torch.kernels import fedavg_agg as fk
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("xlstm_125m").reduced(num_layers=4)
    ocfg = optim.OptimizerConfig(name="sgd", momentum=0.0, learning_rate=0.1,
                                 grad_clip=0.0, warmup_steps=0)
    gen = torch.Generator().manual_seed(SEED + 15)
    state = steps.init_train_state(gen, cfg, ocfg)
    b, s, n_dec = 2, 128, 3
    tokens = torch.randint(0, cfg.vocab_size, (b, s + n_dec), generator=gen)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (3, 2, 64),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (3, 2, 64),
                                     generator=gen),
             "selected": torch.tensor([1.0, 0.0, 1.0]),
             "sizes": torch.tensor([100.0, 999.0, 300.0])}
    out = {}
    for device in ("cpu", dev):
        st = _to(state, device)
        t = tokens.to(device)
        fwd, _ = transformer.forward(st["params"], t, cfg)
        logits, cache = transformer.prefill(st["params"], t[:, :s], cfg)
        dec = [logits]
        for i in range(n_dec):
            logits, cache = transformer.decode_step(
                st["params"], t[:, s + i:s + i + 1], cache, s + i, cfg)
            dec.append(logits)
        before = fk.fedavg_agg.launches
        new, metrics = steps.make_federated_train_step(cfg, ocfg, 3)(
            st, {k: v.to(device) for k, v in batch.items()})
        launched = fk.fedavg_agg.launches - before
        out[str(device)] = (fwd.cpu(), [x.cpu() for x in dec],
                            [x.cpu() for x in tree_leaves(new["params"])],
                            float(metrics["n_selected"]), launched)
    (f_c, d_c, p_c, n_c, _), (f_g, d_g, p_g, n_g, launched) = out.values()
    rel_f = float((f_c - f_g).abs().max() / f_c.abs().max())
    rel_d = max(float((c - g).abs().max() / c.abs().max())
                for c, g in zip(d_c, d_g))
    err_p = max(float((c - g).abs().max()) for c, g in zip(p_c, p_g))
    print(f"[card-vs-cpu] {cfg.name} reduced(num_layers=4) f32: forward "
          f"logits rel err {rel_f:.3g}, prefill + {n_dec} decode steps "
          f"{rel_d:.3g}, federated step (K=3) parameters max abs err "
          f"{err_p:.3g} (limits {XLSTM_CARD_CPU_TOL:g}); n_selected card "
          f"{n_g} CPU {n_c}; card fedavg_agg launches {launched}",
          flush=True)
    if not (max(rel_f, rel_d, err_p) <= XLSTM_CARD_CPU_TOL and n_g == n_c
            and launched == 1):
        raise AssertionError("xlstm card vs CPU")
    mb_batch = {k: torch.randint(0, cfg.vocab_size, (4, 64), generator=gen
                                 ).to(dev) for k in ("inputs", "labels")}
    m = microbatch_agreement(torch, cfg, _to(state, dev)["params"], mb_batch)
    print(f"[card-vs-cpu] {cfg.name} reduced(num_layers=4) f32 on the card, "
          f"plain SGD step mb 1 vs mb 2 (4 x 64): max(|a - b| - "
          f"{TRAIN_MB_TOL:g} |b|) = {m['excess']:.3g}, ce rel {m['ce']:.3g},"
          f" gradient rel {m['grad']:.3g} (limit "
          f"{TRAIN_MB_GRAD_TOL_REDUCED:g}), all finite {m['finite']}; "
          f"gradients part most in {m['where']}", flush=True)
    if not microbatches_agree(m, TRAIN_MB_GRAD_TOL_REDUCED):
        raise AssertionError(f"xlstm mb 1 vs mb 2 in f32: {m}")

# Path 20: h2o-danube-3-4b (arXiv 2401.16818) trained federated at its
# published widths (d_model 3840, 32 / 8 heads of 120, d_ff 10240, vocab
# 32,000, window 4096), random weights from a seed, as ``launch.train
# --arch h2o-danube-3-4b --federated 4 --num-layers 6 --clients-per-pass
# 2 --batch 16 --seq 1024`` sets it up: bf16 compute, f32 parameters,
# AdamW at the CLI's lr 3e-4 and warmup 10, DAS every step, 4 sequences a
# client, 3 steps (cold, warm, profiled).  Depth is cut to 6 of 24
# layers: each layer holds ~155M parameters, and at 16 bytes a parameter
# (f32 parameters, AdamW's two moments, a gradient) beside the (K, P) f32
# client-gradient matrix the 24 layers' 3.96B need ~127 GB of one 80 GB
# card; 6 layers and the embeddings are 1.18B (~38 GB).  Two clients a
# pass: the (2, P) gradients of a pass and its 8 x 1024 tokens'
# activations come on top (``steps.pass_size``'s token budget was
# measured on xlstm-125m and would put all four in one pass).
DANUBE_LAYERS = 6
DANUBE_K, DANUBE_BATCH, DANUBE_SEQ = 4, 16, 1024
DANUBE_PER_PASS, DANUBE_STEPS = 2, 3
DANUBE_PASS_B = DANUBE_BATCH // DANUBE_K * DANUBE_PER_PASS
# Path 21: stablelm-12b trained plainly (``launch.train --arch stablelm-12b
# --num-layers 2 --batch 8 --seq 1024``) at its published widths (d_model
# 5120, 32 / 8 heads of 160 with 25% partial rotary, d_ff 13824, vocab
# 100,352 untied), random weights from a seed: bf16 compute, f32
# parameters, AdamW; a cold step and two warm ones, the second profiled.
# Depth is cut to 2 of 40 layers: 2 layers and the embeddings are ~1.58B
# parameters, ~25 GB at 16 bytes a parameter (f32 parameters, AdamW's two
# moments, a gradient); 40 would need ~190 GB.  No --federated, so no DAS
# host time: the step is the attention backward's path on the card.
STABLELM_LAYERS, STABLELM_BATCH, STABLELM_SEQ, STABLELM_STEPS = 2, 8, 1024, 3
# Card against CPU at danube's reduced(num_layers=2), f32 with TF32 off:
# sums in another order.
DANUBE_CARD_CPU_TOL = 1e-4
# The backward kernel against its plain version, of each gradient's
# largest magnitude: f32 sums in another order; bf16 outputs rounded once
# (2^-9 of the largest) and P rounded to bf16 for dV.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The training forward's row log-sum-exp against its plain version, abs:
# f32 from the kernels' online max and sum.
FLASH_LSE_TOL = 1e-4
# Card against CPU on stablelm-12b's reduced(num_layers=2, head_dim=160)
# in bf16 compute, of each gradient leaf's largest magnitude: every
# matmul rounds to bf16 in another order on each side, and the card's
# backward rounds dS to bf16 (readings on an H100: 1.1e-2 median, 1.6e-2
# the worst leaf, a LayerNorm's; the limit about twice that).
STABLELM_CARD_CPU_TOL = 3e-2
# The timed backward past hd 128, at path 20's tokens a pass: stablelm-
# 12b's attention (32 / 8 heads of 160, causal; path 21's pass) and the
# widest head the kernels serve.
STABLELM_BWD_SHAPE = (STABLELM_BATCH, STABLELM_SEQ, STABLELM_SEQ, 32, 8, 160)
HD256_BWD_SHAPE = (DANUBE_PASS_B, DANUBE_SEQ, DANUBE_SEQ, 32, 8, 256)
# The backward's check shapes, (label, (B, Sq, Skv, H, KV, hd), masks):
# path 20's (one pass: two clients' 4 sequences of 1024 tokens, danube's
# heads; its 4096 window does not bind at 1024), a binding window of 64,
# G = 8 at hd 128, whisper's cross-attention (G = 1, hd 64, 64 rows
# against 1500 frames, non-causal), stablelm's hd 160 with kv_len < Skv,
# danube's heads with a ragged last packed tile (Sq 300, 16 positions a
# tile) and kv_len < Skv, and the tensor-core route past hd 128: path
# 21's pass (stablelm-12b's 32 / 8 heads of 160, 8 x 1024 tokens), hd
# 136 (the first width past 128), hd 192 with a binding window, hd 256
# with kv_len < Skv, and hd 160 at G = 5 (a packed tile of 12 positions
# x 5 heads).
FLASH_BWD_SHAPES = [
    ("path 20", (DANUBE_PASS_B, DANUBE_SEQ, DANUBE_SEQ, 32, 8, 120),
     dict(causal=True, window=4096)),
    ("window 64", (2, 256, 256, 32, 8, 120), dict(causal=True, window=64)),
    ("G 8, hd 128", (2, 512, 512, 64, 8, 128), dict(causal=True, window=0)),
    ("cross, hd 64, G 1", (4, 64, 1500, 12, 12, 64),
     dict(causal=False, window=0)),
    ("hd 160", (2, 300, 300, 32, 8, 160),
     dict(causal=True, window=0, kv_len=280)),
    ("ragged, hd 120", (2, 300, 300, 32, 8, 120),
     dict(causal=True, window=0, kv_len=280)),
    ("path 21", STABLELM_BWD_SHAPE, dict(causal=True, window=0)),
    ("hd 136", (2, 256, 256, 16, 4, 136), dict(causal=True, window=0)),
    ("window 100, hd 192", (2, 384, 384, 16, 4, 192),
     dict(causal=True, window=100)),
    ("hd 256", (2, 300, 320, 16, 8, 256),
     dict(causal=True, window=0, kv_len=290)),
    ("G 5, hd 160", (2, 200, 200, 20, 4, 160),
     dict(causal=True, window=0, kv_len=190)),
]


def flash_bwd_inputs(torch, fa, gen, shape, dtype, kw):
    """q, k, v, dO drawn in f32 and rounded, and the forward's o and lse
    (the prefill kernel of the type, with the rows' log-sum-exp)."""
    b, sq, skv, h, kv, hd = shape
    dev = gen.device
    q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((b, sq, h, hd), (b, skv, kv, hd),
                             (b, skv, kv, hd), (b, sq, h, hd)))
    o, lse = fa._forward(q, k, v, kw["causal"], kw["window"],
                         kw.get("kv_len", skv), True)
    return q, k, v, o, lse, do


def flash_bwd_check(torch, fa, gen, shape, dtype, kw, label: str
                    ) -> float:
    """The training forward (the prefill kernel of the type, writing each
    row's lse) and the backward kernel, each against its plain version on
    q, k, v, dO drawn as ``flash_bwd_inputs`` draws them: o against
    ``flash_attention_plain`` (f32 within FLASH_TOL, bf16 by the
    tensor-core prefill's ratio check, as ``flash_check``), the lse
    within FLASH_LSE_TOL, and dq, dk, dv from the kernels' o and lse
    against ``flash_attention_bwd_plain`` from the plain o and lse
    (FLASH_BWD_TOL), so no kernel's output is its own reference.  The
    kernels get the keys and values past ``kv_len`` NaN and every SM's
    shared memory NaN before each launch; each launch must go through
    its route once (the backward's ``bwd_route``).  Returns the largest
    abs error over dq, dk, dv."""
    from repro_torch.kernels import _check
    b, sq, skv, h, kvh, hd = shape
    kv_len = kw.get("kv_len", skv)
    q, k, v, do = (torch.randn(s, generator=gen, device=gen.device).to(dtype)
                   for s in ((b, sq, h, hd), (b, skv, kvh, hd),
                             (b, skv, kvh, hd), (b, sq, h, hd)))
    kn, vn = k.clone(), v.clone()
    kn[:, kv_len:] = float("nan")
    vn[:, kv_len:] = float("nan")
    routes = fa.flash_attention.route_launches

    def launched(fn, route: str):
        before = dict(routes)
        _check.fill_shared_memory(q.device)
        out = fn()
        torch.cuda.synchronize()
        routed = {r: n - before[r] for r, n in routes.items()}
        if routed != {r: int(r == route) for r in routed}:
            raise AssertionError(f"flash_attention_bwd {label}: launches "
                                 f"{routed}, expected one through {route}")
        return out
    fwd_route = fa.route(dtype, sq, True)
    bwd_route = fa.bwd_route(dtype, hd)
    o, lse = launched(lambda: fa._forward(q, kn, vn, kw["causal"],
                                          kw["window"], kv_len, True),
                      fwd_route)
    got = launched(lambda: fa.flash_attention_bwd(q, kn, vn, o, lse, do,
                                                  **kw), bwd_route)
    del kn, vn
    want_o, want_lse = fa.flash_attention_plain(q.float(), k.float(),
                                                v.float(), with_lse=True,
                                                **kw)
    o_err = float((o.float() - want_o).abs().max())
    if dtype == torch.float32:
        o_ok, o_read = o_err <= FLASH_TOL, f"(limit {FLASH_TOL:g})"
    else:
        want_abs_v = fa.flash_attention_plain(q.float(), k.float(),
                                              v.float().abs(), **kw)
        ratio = _check.bf16_prefill_ratio(o, want_o, want_abs_v, FLASH_TOL)
        del want_abs_v
        o_ok = ratio <= 1.0
        o_read = (f"worst / (half ulp + 2^-8 mean|v| + {FLASH_TOL:g}) = "
                  f"{ratio:.4f} (limit 1)")
    # +inf on the same rows (those that see no key), close elsewhere.
    blind = torch.isinf(want_lse)
    lse_err = float(torch.where(blind, 0.0, lse - want_lse).abs().max())
    lse_ok = bool(torch.equal(torch.isinf(lse), blind)) \
        and lse_err <= FLASH_LSE_TOL
    want = fa.flash_attention_bwd_plain(q, k, v, want_o.to(dtype), want_lse,
                                        do, **kw)
    rels, errs = [], []
    for g, w in zip(got, want):
        errs.append(float((g.float() - w.float()).abs().max()))
        rels.append(errs[-1] / max(float(w.float().abs().max()), 1e-30))
    finite = all(bool(t.isfinite().all()) for t in (o, *got))
    tol = FLASH_BWD_TOL[str(dtype).split(".")[1]]
    print(f"[kernel] flash_attention_bwd {label} {tuple(q.shape)} x "
          f"{tuple(k.shape)} {dtype} {kw}: forward ({fwd_route}, with the "
          f"lse) o max abs err {o_err:.3g} {o_read}, lse max abs err "
          f"{lse_err:.3g} (limit {FLASH_LSE_TOL:g}); backward ({bwd_route}) "
          f"from the "
          f"kernels' o and lse against the plain backward from the plain "
          f"o and lse: max abs err dq/dk/dv {[f'{e:.3g}' for e in errs]}, "
          f"of each gradient's largest {[f'{r:.3g}' for r in rels]} (limit "
          f"{tol:g}); finite {finite}", flush=True)
    if not (o_ok and lse_ok):
        raise AssertionError(f"flash_attention_bwd {label} {dtype}: "
                             f"forward o {o_read}, lse err {lse_err}")
    if not (finite and max(rels) <= tol):
        raise AssertionError(f"flash_attention_bwd {label} {dtype}: {rels}")
    return max(errs)


def flash_bwd_bound(q, k, pairs: int) -> tuple[float, str]:
    """q, o, dO read and dq written, k and v read and dk, dv written, and
    the lse read, each once; five products (two score products again,
    dV, dK, dQ), 10 hd flops a visible pair and head."""
    b, sq, h, hd = q.shape
    n_bytes = q.element_size() * (4 * q.numel() + 4 * k.numel()) \
        + 4 * b * h * sq
    n_ops = 10 * b * h * pairs * hd
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[str(q.dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The tensor-core backward's kernels, as the profiler names them: the D
# pre-pass, dK and dV together (hd <= 128) or apart, and dQ.
BWD_TC_KERNELS = ("flash_attention_bwd_tc_delta",
                  "flash_attention_bwd_tc_dkdv",
                  "flash_attention_bwd_tc_dv_kernel",
                  "flash_attention_bwd_tc_dk_kernel",
                  "flash_attention_bwd_tc_dq")


def flash_bwd_timed(torch, fa, gen, label: str, shape, kw,
                    dtype=None) -> dict:
    """The backward at ``shape`` in ``dtype`` (bf16 unless given; inputs
    cycled past L2), through its ``bwd_route``: ``ms`` by host loop,
    printed beside its graph replay, the plain version's ms, and SDPA's
    backward alone in the same type (``enable_gqa``, ``is_causal``: the
    window does not bind at this length; timed on one retained forward
    graph) as ``library_ms``, with SDPA's forward + backward and its
    forward alone printed beside it; on the tensor-core route each of its
    kernels' device time a call from the profiler (the D pre-pass apart);
    also the forward with the lse against the serving forward on the same
    inputs."""
    import torch.nn.functional as F
    dtype = dtype or torch.bfloat16
    b, sq, skv, h, kv, hd = shape
    if kw["window"] and kw["window"] < sq:
        raise AssertionError("SDPA's yardstick assumes no binding window")
    which = fa.bwd_route(dtype, hd)
    size = torch.tensor([], dtype=dtype).element_size()
    n = cycling(size * b * (4 * sq * h + 4 * skv * kv) * hd)
    sets = [flash_bwd_inputs(torch, fa, gen, shape, dtype, kw)
            for _ in range(n)]
    it = iter(range(10 ** 9))
    calls = 10

    def kernel():
        return fa.flash_attention_bwd(*sets[next(it) % n], **kw)
    ms = time_ms(kernel, calls)
    graph = graph_ms(torch, kernel, calls)
    split = ""
    if which == "backward_tc":
        def run():
            for _ in range(calls):
                kernel()
        us = profile_scopes(torch, run, (),
                            kernels=BWD_TC_KERNELS)["kernel_us"]
        us = {name: t for name, t in us.items() if t > 0}
        total = sum(us.values())
        split = ("; profiler device ms a call: " + ", ".join(
            f"{name.split('_tc_')[1].split('_')[0]} "
            f"{t / calls / 1e3:.5f}" for name, t in us.items())
            + f" (D pre-pass {us[BWD_TC_KERNELS[0]] / total:.3f} of the "
            f"{len(us)})")
    q, k, v, o, lse, do = sets[0]
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), 2, warmup=1)
    kv_len = kw.get("kv_len", skv)
    fwd_lse = time_ms(lambda: fa._forward(q, k, v, kw["causal"],
                                          kw["window"], kv_len, True), calls)
    fwd = time_ms(lambda: fa._forward(q, k, v, kw["causal"], kw["window"],
                                      kv_len, False), calls)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              is_causal=kw["causal"])

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)
    with torch.no_grad():
        sdpa_f = time_ms(sdpa_fwd, calls)
    sdpa_fb = time_ms(sdpa_fwd_bwd, calls)
    retained = sdpa_fwd()
    library_ms = time_ms(lambda: torch.autograd.grad(
        retained, (qt, kt, vt), dot, retain_graph=True), calls)
    del retained
    sd = sdpa_fwd_bwd()
    sdpa_err = max(float((a.transpose(1, 2).float() - g.float()).abs().max())
                   for a, g in zip(sd, kernel()))
    pairs = fa.visible_pairs(sq, causal=kw["causal"], window=kw["window"],
                             kv_len=kv_len)
    b_ms, b_by = flash_bwd_bound(q, k, pairs)
    print(f"[kernel] flash_attention_bwd (b) {label} shape {tuple(q.shape)} "
          f"x {tuple(k.shape)} {dtype} {kw} ({which}): ms={ms:.5f} (graph "
          f"{graph:.5f}) plain_ms={plain_ms:.3f} library_ms(sdpa backward "
          f"alone, on a retained forward)={library_ms:.5f} (sdpa forward + "
          f"backward {sdpa_fb:.5f}, forward alone {sdpa_f:.5f}; sdpa vs "
          f"kernel gradients max diff {sdpa_err:.3g}; kernel by graph / "
          f"sdpa backward {graph / library_ms:.3f}) bound_ms={b_ms:.5f} "
          f"({b_by}; {pairs} visible pairs per head; {b_ms / ms:.3f} of it "
          f"by the host loop, {b_ms / graph:.3f} by the graph){split}; "
          f"forward with lse {fwd_lse:.5f} ms against the serving forward "
          f"{fwd:.5f} ms on the same inputs", flush=True)
    del sets, sd
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_flash_bwd(torch, dev) -> dict:
    """The backward kernels against their plain version at
    FLASH_BWD_SHAPES in f32 and bf16; timed in bf16 (the tensor-core
    route) at path 20's shape, at path 21's (stablelm-12b's hd 160) and
    at hd 256, and in f32 (the CUDA-core route) at path 20's shape.
    Returns the kernels line's ``flash_attention_bwd`` (path 20's shape)
    and ``flash_attention_bwd_hd160`` (path 21's) rows, bf16."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    lib = _build.library()
    for hd in range(8, fa.MAX_HEAD_DIM + 1, 8):
        if lib.flash_attention_bwd_smem(hd) != fa.bwd_smem_bytes(hd):
            raise AssertionError(f"backward smem mirror at hd {hd}")
        if lib.flash_attention_bwd_tc_smem(hd) != fa.bwd_tc_smem_bytes(hd):
            raise AssertionError(f"tensor-core backward smem mirror at hd "
                                 f"{hd}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, shape, kw in FLASH_BWD_SHAPES:
            errs[label, dtype] = flash_bwd_check(torch, fa, gen, shape,
                                                 dtype, kw, f"(a) {label}")
            torch.cuda.empty_cache()
    rows = {}
    for name, label, shape, kw in (
            ("flash_attention_bwd", "path 20", FLASH_BWD_SHAPES[0][1],
             FLASH_BWD_SHAPES[0][2]),
            ("flash_attention_bwd_hd160", "path 21", STABLELM_BWD_SHAPE,
             dict(causal=True, window=0))):
        rows[name] = dict(flash_bwd_timed(torch, fa, gen, label, shape, kw),
                          max_abs_err=errs[label, torch.bfloat16])
        torch.cuda.empty_cache()
    flash_bwd_timed(torch, fa, gen, "hd 256", HD256_BWD_SHAPE,
                    dict(causal=True, window=0))
    torch.cuda.empty_cache()
    flash_bwd_timed(torch, fa, gen, "path 20, f32", FLASH_BWD_SHAPES[0][1],
                    FLASH_BWD_SHAPES[0][2], torch.float32)
    torch.cuda.empty_cache()
    return rows


def phase_danube_train(torch, dev, smi: str) -> dict:
    """Path 20: the federated trainer on h2o-danube-3-4b at its published
    widths, 6 layers (``launch.train``'s own setup, batch and schedule).
    Returns the launch counts of its DANUBE_STEPS steps, with the
    kernels line's ``flash_attention_bwd`` count."""
    from repro_torch.kernels import fedavg_agg as fk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.setup(train.parse_args([
        "--arch", "h2o-danube-3-4b", "--federated", str(DANUBE_K),
        "--num-layers", str(DANUBE_LAYERS), "--clients-per-pass",
        str(DANUBE_PER_PASS), "--batch", str(DANUBE_BATCH), "--seq",
        str(DANUBE_SEQ), "--seed", str(SEED + 20)]))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, ocfg, gen, clients, step = (run.cfg, run.ocfg, run.gen,
                                     run.clients, run.step)
    out = [run.state]
    del run
    n_params = transformer.param_count(cfg)
    passes = -(-DANUBE_K // DANUBE_PER_PASS)
    print(f"[path 20] {cfg.name} federated on {dev}: {DANUBE_LAYERS} of 24 "
          f"layers at published widths (d_model {cfg.d_model}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, window {cfg.sliding_window}), param_count "
          f"{n_params}, {cfg.dtype_compute} compute, {cfg.dtype_params} "
          f"parameters, AdamW lr {ocfg.learning_rate} warmup "
          f"{ocfg.warmup_steps}; K={DANUBE_K} clients, global batch "
          f"{DANUBE_BATCH} x {DANUBE_SEQ} tokens, {DANUBE_PER_PASS} "
          f"clients a pass ({passes} passes); set up in {setup_s:.2f}s",
          flush=True)

    def iteration(out: list) -> None:
        t0 = time.perf_counter()
        batch = train.driver_batch(gen, DANUBE_BATCH, DANUBE_SEQ,
                                   cfg.vocab_size, clients)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new, metrics = step(out[0], batch)
        ce, n_sel = float(metrics["ce"]), int(metrics["n_selected"])
        t2 = time.perf_counter()
        out[:] = [new, (t2 - t0, t1 - t0, t2 - t1), ce, n_sel]

    reset_counts()
    walls = []
    for i in range(DANUBE_STEPS):
        how = ("cold" if i == 0 else "profiled" if i == DANUBE_STEPS - 1
               else "warm")
        if how == "profiled":
            prof = profile_scopes(torch, lambda: iteration(out),
                                  TRAIN_SCOPES,
                                  kernels=("flash_attention_bwd",
                                           "flash_attention_tc"))
        else:
            iteration(out)
        _, wall, ce, n_sel = out
        out = out[:1]
        walls.append(wall)
        if not (math.isfinite(ce) and n_sel >= clients.scfg.n_min):
            raise AssertionError(f"path 20 step {i}: ce {ce}, n_selected "
                                 f"{n_sel}")
        print(f"[path 20] step {i} ({how}): wall {wall[0]:.3f}s = batch + "
              f"schedule {wall[1]:.3f}s + federated step {wall[2]:.3f}s; ce "
              f"{ce:.4f}; n_selected {n_sel}", flush=True)
    counts = read_counts()
    routes = dict(fa.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    layer_passes = DANUBE_STEPS * DANUBE_LAYERS * passes
    want = dict(dict.fromkeys(_counters(), 0), fedavg_agg=DANUBE_STEPS,
                flash_attention=2 * layer_passes)
    want_routes = dict(prefill_tc=layer_passes, prefill_f32=0, decode=0,
                       backward=0, backward_tc=layer_passes)
    print(f"[path 20] launches {counts}; flash_attention by route {routes}; "
          f"fedavg_agg by route {dict(fk.fedavg_agg.route_launches)}",
          flush=True)
    if counts != want or routes != want_routes:
        raise AssertionError(f"path 20 launches {counts}, routes {routes}; "
                             f"expected {want}, {want_routes}")
    tokens = DANUBE_BATCH * DANUBE_SEQ
    cold, warm = walls[0], walls[1]
    print(f"[path 20] cold step {cold[0]:.3f}s, warm step {warm[0]:.3f}s = "
          f"{tokens / warm[0]:.0f} tokens/s (federated step "
          f"{warm[2]:.3f}s = {tokens / warm[2]:.0f} tokens/s, batch + "
          f"schedule {warm[1]:.3f}s); max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; {smi}", flush=True)
    busy = prof["busy_us"]
    bwd_us = prof["kernel_us"]["flash_attention_bwd"]
    fwd_us = prof["kernel_us"]["flash_attention_tc"]
    print(f"[path 20] profiled step: wall {prof['wall_us'] / 1e6:.3f}s, "
          f"device busy {busy / 1e6:.3f}s, idle share "
          f"{1 - busy / prof['wall_us']:.3f} (against the unprofiled warm "
          f"step: {1 - busy / 1e6 / warm[0]:.3f}); flash backward "
          f"{bwd_us / 1e3:.2f} ms = {bwd_us / busy:.3f} of device time, "
          f"flash forward {fwd_us / 1e3:.2f} ms = {fwd_us / busy:.3f}; "
          f"{prof['launches']} launches ({prof['device_ops']} device "
          f"operations) by scope {prof['per_scope']}; host ms by scope "
          f"{ {k: round(v, 1) for k, v in prof['host_ms'].items()} }",
          flush=True)
    del out
    torch.cuda.empty_cache()
    return dict(counts, flash_attention_bwd=routes["backward_tc"])


def phase_danube_card_vs_cpu(torch, dev) -> None:
    """h2o-danube-3-4b at ``reduced(num_layers=2)`` (window 128) on the
    card and on the CPU from one state, f32 with TF32 off: one federated
    step, K = 4 clients of 2 x 160 tokens, clients 0, 2 and 3 selected,
    SGD lr 0.1; parameters within DANUBE_CARD_CPU_TOL, and on the card
    every layer's attention forward and backward through the kernels."""
    from repro_torch import configs, optim
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.tree import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("h2o_danube_3_4b").reduced(num_layers=2)
    ocfg = optim.OptimizerConfig(name="sgd", momentum=0.0, learning_rate=0.1,
                                 grad_clip=0.0, warmup_steps=0)
    gen = torch.Generator().manual_seed(SEED + 21)
    state = steps.init_train_state(gen, cfg, ocfg)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (4, 2, 160),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (4, 2, 160),
                                     generator=gen),
             "selected": torch.tensor([1.0, 0.0, 1.0, 1.0]),
             "sizes": torch.tensor([100.0, 999.0, 300.0, 40.0])}
    out = {}
    for device in ("cpu", dev):
        before = dict(fa.flash_attention.route_launches)
        new, metrics = steps.make_federated_train_step(cfg, ocfg, 4)(
            _to(state, device), {k: v.to(device) for k, v in batch.items()})
        routed = {r: n - before[r]
                  for r, n in fa.flash_attention.route_launches.items()}
        out[str(device)] = ([x.cpu() for x in tree_leaves(new["params"])],
                            float(metrics["ce"]), routed)
    (p_c, ce_c, _), (p_g, ce_g, routed) = out.values()
    err = max(float((c - g).abs().max()) for c, g in zip(p_c, p_g))
    want = dict(prefill_tc=0, prefill_f32=cfg.num_layers, decode=0,
                backward=cfg.num_layers, backward_tc=0)
    print(f"[card-vs-cpu] {cfg.name} reduced(num_layers=2) f32: federated "
          f"step (K=4, 2 x 160 tokens a client, window "
          f"{cfg.sliding_window}) parameters max abs err {err:.3g} (limit "
          f"{DANUBE_CARD_CPU_TOL:g}); ce card {ce_g:.6f} CPU {ce_c:.6f}; "
          f"card flash launches by route {routed}", flush=True)
    if not (err <= DANUBE_CARD_CPU_TOL and routed == want):
        raise AssertionError(f"danube card vs CPU: {err}, routes {routed}")


def phase_stablelm_train(torch, dev, smi: str,
                         keep: dict | None = None) -> dict:
    """Path 21: the plain trainer on stablelm-12b at its published widths,
    STABLELM_LAYERS layers (``launch.train``'s own setup and batch), every
    layer's attention backward through the tensor-core route at hd 160.
    Returns the launch counts of its STABLELM_STEPS steps, with the
    kernels line's ``flash_attention_bwd_hd160`` count.  ``keep`` gets
    what path 23 plans against: the configurations, the warm step's wall
    and the bytes the live parameters, optimizer state and last batch
    hold on the card."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train.setup(train.parse_args([
        "--arch", "stablelm-12b", "--num-layers", str(STABLELM_LAYERS),
        "--batch", str(STABLELM_BATCH), "--seq", str(STABLELM_SEQ),
        "--seed", str(SEED + 22)]))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, ocfg, gen, step = run.cfg, run.ocfg, run.gen, run.step
    state = [run.state]
    del run
    print(f"[path 21] {cfg.name} plain training on {dev}: {STABLELM_LAYERS} "
          f"of 40 layers at published widths (d_model {cfg.d_model}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, rotary on {cfg.rope_fraction:g} of "
          f"each, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), param_count "
          f"{transformer.param_count(cfg)}, {cfg.dtype_compute} compute, "
          f"{cfg.dtype_params} parameters, {ocfg.name} lr "
          f"{ocfg.learning_rate} warmup {ocfg.warmup_steps}; batch "
          f"{STABLELM_BATCH} x {STABLELM_SEQ} tokens; set up in "
          f"{setup_s:.2f}s", flush=True)

    batches = []

    def iteration() -> tuple:
        t0 = time.perf_counter()
        batch = train.driver_batch(gen, STABLELM_BATCH, STABLELM_SEQ,
                                   cfg.vocab_size)
        batches[:] = [batch]
        state[0], metrics = step(state[0], batch)
        ce = float(metrics["ce"])
        return time.perf_counter() - t0, ce

    reset_counts()
    walls = []
    for i in range(STABLELM_STEPS):
        how = ("cold" if i == 0 else "profiled" if i == STABLELM_STEPS - 1
               else "warm")
        if how == "profiled":
            got = []
            prof = profile_scopes(torch, lambda: got.append(iteration()),
                                  ("train/batch",),
                                  kernels=("flash_attention_bwd",
                                           "flash_attention_tc"))
            wall, ce = got[0]
        else:
            wall, ce = iteration()
        walls.append(wall)
        if not math.isfinite(ce):
            raise AssertionError(f"path 21 step {i}: ce {ce}")
        print(f"[path 21] step {i} ({how}): wall {wall:.3f}s; ce {ce:.4f}",
              flush=True)
    counts = read_counts()
    routes = dict(fa.flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    layer_steps = STABLELM_STEPS * STABLELM_LAYERS
    want = dict(dict.fromkeys(_counters(), 0), flash_attention=2 * layer_steps)
    want_routes = dict(prefill_tc=layer_steps, prefill_f32=0, decode=0,
                       backward=0, backward_tc=layer_steps)
    print(f"[path 21] launches {counts}; flash_attention by route {routes}",
          flush=True)
    if counts != want or routes != want_routes:
        raise AssertionError(f"path 21 launches {counts}, routes {routes}; "
                             f"expected {want}, {want_routes}")
    tokens = STABLELM_BATCH * STABLELM_SEQ
    busy = prof["busy_us"]
    bwd_us = prof["kernel_us"]["flash_attention_bwd"]
    fwd_us = prof["kernel_us"]["flash_attention_tc"]
    print(f"[path 21] cold step {walls[0]:.3f}s, warm step {walls[1]:.3f}s = "
          f"{tokens / walls[1]:.0f} tokens/s; max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; profiled step: wall "
          f"{prof['wall_us'] / 1e6:.3f}s, device busy {busy / 1e6:.3f}s, "
          f"idle share {1 - busy / prof['wall_us']:.3f} (against the "
          f"unprofiled warm step: {1 - busy / 1e6 / walls[1]:.3f}); flash "
          f"backward {bwd_us / 1e3:.2f} ms = {bwd_us / busy:.4f} of device "
          f"time ({bwd_us / 1e3 / STABLELM_LAYERS:.3f} ms a layer), flash "
          f"forward {fwd_us / 1e3:.2f} ms = {fwd_us / busy:.4f}; "
          f"{prof['launches']} launches ({prof['device_ops']} device "
          f"operations); {smi}", flush=True)
    if keep is not None:
        from repro_torch.tree import tree_leaves
        keep.update(cfg=cfg, ocfg=ocfg, warm=walls[1], live_bytes=sum(
            t.nbytes for t in tree_leaves(state[0]) + tree_leaves(
                batches[0])))
    del state, batches
    torch.cuda.empty_cache()
    return dict(counts, flash_attention_bwd_hd160=routes["backward_tc"])


def phase_stablelm_card_vs_cpu(torch, dev) -> None:
    """stablelm-12b at ``reduced(num_layers=2, head_dim=160)`` with bf16
    compute (f32 parameters) on the card and on the CPU from one state:
    one plain step's gradients (``steps._grads``, 2 x 256 tokens), each
    leaf within STABLELM_CARD_CPU_TOL of its largest magnitude on the CPU;
    on the card each layer's attention forward and backward through the
    tensor-core kernels, on the CPU through the plain versions."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves
    cfg = configs.get("stablelm_12b").reduced(
        num_layers=2, head_dim=160, dtype_compute="bfloat16")
    gen = torch.Generator().manual_seed(SEED + 23)
    params = transformer.init(gen, cfg)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
             for k in ("inputs", "labels")}
    out = []
    for device in ("cpu", dev):
        before = dict(fa.flash_attention.route_launches)
        metrics, grads = steps._grads(_to(params, device),
                                      {k: v.to(device)
                                       for k, v in batch.items()}, cfg)
        routed = {r: n - before[r]
                  for r, n in fa.flash_attention.route_launches.items()}
        out.append(([g.float().cpu() for g in tree_leaves(grads)],
                    float(metrics["ce"]), routed))
    (g_c, ce_c, _), (g_g, ce_g, routed) = out
    rels = [float((c - g).abs().max()) / max(float(c.abs().max()), 1e-30)
            for c, g in zip(g_c, g_g)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    finite = all(bool(g.isfinite().all()) for g in g_g)
    want = dict(prefill_tc=cfg.num_layers, prefill_f32=0, decode=0,
                backward=0, backward_tc=cfg.num_layers)
    print(f"[card-vs-cpu] {cfg.name} reduced(num_layers=2, head_dim=160) "
          f"{cfg.dtype_compute} compute: one plain step's gradients, of each "
          f"leaf's largest: max {rels[worst]:.3g} (leaf {worst} of "
          f"{len(rels)}, shape {tuple(g_c[worst].shape)}), median "
          f"{sorted(rels)[len(rels) // 2]:.3g} (limit "
          f"{STABLELM_CARD_CPU_TOL:g}); ce card {ce_g:.6f} CPU {ce_c:.6f}; "
          f"finite {finite}; card flash launches by route {routed}",
          flush=True)
    if not (finite and rels[worst] <= STABLELM_CARD_CPU_TOL
            and routed == want):
        raise AssertionError(f"stablelm card vs CPU: {rels[worst]}, routes "
                             f"{routed}")


# Path 22: the quickstart's diversity index on the card against the same
# script's on the CPU.
QUICKSTART_INDEX_TOL = 1e-6


def quickstart_index(out: str) -> list:
    """The diversity index the quickstart prints."""
    for line in out.splitlines():
        if line.startswith("diversity index:"):
            return [float(v) for v in line.split(":", 1)[1].split()]
    raise AssertionError(f"path 22: no diversity index in {out!r}")


def phase_quickstart(torch) -> None:
    """Path 22: ``examples/quickstart_torch.py`` on the card, a process of
    its own, beside the same script with ``--device cpu``: both exit 0,
    the two indices within QUICKSTART_INDEX_TOL."""
    script = os.path.join(ROOT, "examples", "quickstart_torch.py")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = {where: subprocess.Popen(
        [sys.executable, script] + args, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for where, args in (("card", []), ("cpu", ["--device", "cpu"]))}
    outs = {}
    for where, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        if proc.returncode:
            raise AssertionError(f"path 22 ({where}) exited "
                                 f"{proc.returncode}: {err[-2000:]}")
        outs[where] = out
    wall = time.perf_counter() - t0
    card, cpu = (quickstart_index(outs[w]) for w in ("card", "cpu"))
    gap = max(abs(a - b) for a, b in zip(card, cpu))
    rounds = [ln for ln in outs["card"].splitlines()
              if ln.startswith(("selected", "round"))]
    print(f"[path 22] quickstart on the card and on the CPU in {wall:.2f}s "
          f"(two processes side by side): index of {len(card)} devices, "
          f"largest card-CPU gap {gap:.3g} (limit {QUICKSTART_INDEX_TOL:g}); "
          f"card: {'; '.join(rounds)}", flush=True)
    if len(card) != 16 or len(cpu) != 16 or not gap <= QUICKSTART_INDEX_TOL:
        raise AssertionError(f"path 22: card index {card}, CPU {cpu}")


def phase_dryrun(torch, dev, path21: dict, smi: str) -> None:
    """Path 23: ``launch.dryrun.lower_one`` of path 21's configuration on
    a 1x1 mesh of the card, its argument bytes exactly the bytes of path
    21's live state and batch, and its FLOPs over path 21's warm step;
    then qwen3-14b x train_4k on both production meshes."""
    from repro_torch import configs
    from repro_torch.configs import shapes
    from repro_torch.launch import dryrun, mesh as mesh_lib
    mesh = mesh_lib.Mesh(("data", "model"), (1, 1), (dev,))
    shape = shapes.InputShape("path21", STABLELM_SEQ, STABLELM_BATCH,
                              "train")
    rec = dryrun.lower_one(path21["cfg"], shape, mesh, ocfg=path21["ocfg"],
                           verbose=False, token_dtype=torch.int64)
    args = rec["memory"]["argument_size_in_bytes"]
    flops = rec["cost"]["flops"]
    print(f"[path 23] lower_one({path21['cfg'].name}, {STABLELM_LAYERS} "
          f"layers, {STABLELM_BATCH} x {STABLELM_SEQ} int64 tokens, 1x1 "
          f"mesh): argument bytes {args:.0f} against path 21's live state "
          f"and batch {path21['live_bytes']} (equal: "
          f"{args == path21['live_bytes']}); {flops:.4e} FLOPs over the "
          f"warm step's {path21['warm']:.3f}s = "
          f"{flops / path21['warm'] / 1e12:.1f} TFLOP/s; plan "
          f"{rec['lower_s'] + rec['compile_s']:.2f}s; {smi}", flush=True)
    if args != path21["live_bytes"]:
        raise AssertionError(f"path 23: argument bytes {args}, live "
                             f"{path21['live_bytes']}")
    cfg = configs.get("qwen3_14b")
    for multi_pod in (False, True):
        t0 = time.perf_counter()
        rec = dryrun.lower_one(cfg, shapes.get_shape("train_4k"),
                               mesh_lib.make_production_mesh(
                                   multi_pod=multi_pod), verbose=False)
        coll = rec["collectives"]
        print(f"[path 23] {cfg.name} x train_4k x {rec['mesh']}: argument "
              f"{rec['memory']['argument_size_in_bytes']:.0f} bytes a "
              f"device, {rec['cost']['flops']:.4e} FLOPs a device, "
              f"microbatches {rec['microbatches']}, planned collectives "
              f"{coll['total_bytes'] / 1e9:.3f} GB {coll['counts']}; wall "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
        if not (rec["memory"]["argument_size_in_bytes"] > 0
                and math.isfinite(rec["cost"]["flops"])
                and rec["cost"]["flops"] > 0):
            raise AssertionError(f"path 23: record {rec}")


def phase_launch(torch, dev, data, wcfg, smi: str, path21: dict) -> None:
    """Paths 22 and 23 (after path 21, whose ``keep`` is ``path21``), and
    path 12's scenario-mesh walks against one unsharded walk where path
    12 did not run."""
    phase_dryrun(torch, dev, path21, smi)
    phase_quickstart(torch)
    if data is not None:
        from repro_torch.sweep import engine as engine_lib
        spec, model = sweep_setup(torch, wcfg)
        eng = engine_lib.SweepEngine(spec, model=model, data=data,
                                     use_sharding=False, device=dev)
        aggs, rows = sweep_walk(torch, eng, model, "unsharded")
        sweep_mesh_walks(torch, dev, data, spec, model,
                         {p: engine_lib.aggregate_summary(a)
                          for p, a in aggs.items()},
                         sum(r["wall"] for r in rows), smi)


KERNELS = {
    "fedavg_agg": ("src/repro_torch/csrc/fedavg_agg.cu",
                   "src/repro/kernels/fedavg_agg.py:30"),
    "diversity": ("src/repro_torch/csrc/diversity.cu",
                  "src/repro/kernels/diversity.py:36"),
    "sub2_pgd": ("src/repro_torch/csrc/sub2_pgd.cu",
                 "src/repro/kernels/sub2_pgd.py:134"),
    "stream_update": ("src/repro_torch/csrc/stream_update.cu",
                      "src/repro/kernels/stream_update.py:58"),
    "compress_update": ("src/repro_torch/csrc/compress.cu",
                        "src/repro/kernels/compress.py:86"),
    "compress_update_topk": ("src/repro_torch/csrc/compress.cu",
                             "src/repro/kernels/compress.py:86"),
    "fedavg_agg_masked": ("src/repro_torch/csrc/fedavg_agg.cu",
                          "src/repro/kernels/fedavg_agg.py:100"),
    "fedavg_agg_stale": ("src/repro_torch/csrc/fedavg_agg.cu",
                         "src/repro/kernels/fedavg_agg.py:58"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_tc.cu",
                        "src/repro/kernels/flash_attention.py:90"),
    "flash_attention_decode": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:90"),
}
# The batch paths' rows: each kernel at the S = BATCH_S shapes of its
# batch path, with that path's launches; and fedavg_agg at path 13's shape
# (the federated trainer's K = 8 flattened gradients of xlstm-125m).
KERNELS.update({f"{name}_batch": KERNELS[name] for name in (
    "diversity", "sub2_pgd", "fedavg_agg", "stream_update",
    "fedavg_agg_masked", "compress_update", "fedavg_agg_stale")})
KERNELS["fedavg_agg_train"] = KERNELS["fedavg_agg"]
# The backward has no TPU kernel to replace: the reference differentiates
# its plain attention (``attend_full``).  The row is path 20's bf16
# backward, on the tensor-core route.
KERNELS["flash_attention_bwd"] = (
    "src/repro_torch/csrc/flash_attention_bwd_tc.cu",
    "src/repro/models/attention.py:142")
# Path 21's: stablelm-12b's hd 160 on the same route.
KERNELS["flash_attention_bwd_hd160"] = KERNELS["flash_attention_bwd"]
# Paths 15-19's flash rows (PATH_FLASH): the prefill at each MoE path's
# query group, jamba's decode, whisper's encoder prefill and its
# cross-attention decode.
KERNELS.update({name: KERNELS["flash_attention_decode" if "decode" in name
                              else "flash_attention"] for name in PATH_FLASH})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core import bandwidth
    from repro_torch.kernels import _build
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"[card] {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if sys.argv[1:] == ["--moe-prefill"]:
        moe_prefill_only(torch, dev)
        return 0
    if sys.argv[1:] == ["--flash-bwd"]:
        phase_flash_bwd(torch, dev)
        phase_stablelm_train(torch, dev, smi)
        phase_stablelm_card_vs_cpu(torch, dev)
        return 0
    if sys.argv[1:] == ["--launch"]:
        path21 = {}
        phase_stablelm_train(torch, dev, smi, path21)
        data, _, wcfg = full_width_world(torch, dev)
        phase_launch(torch, dev, data, wcfg, smi, path21)
        print(f"[time] chip_smoke --launch ran "
              f"{time.perf_counter() - t_start:.1f}s", flush=True)
        return 0

    compress_smem_mirror()
    sass_sizes(_build.build())
    floor = phase_floor(torch, dev)
    data, net, wcfg = full_width_world(torch, dev)
    data_dev = data.to(dev)
    # The rows of the kernels line: each kernel at the shapes its path
    # gives it (S = 1, the CNN's P, 8-bit quant).
    results = {
        "fedavg_agg": phase_fedavg(torch, dev, 100, P_CNN),
        "diversity": phase_diversity(torch, dev, data_dev.labels,
                                     data_dev.mask, 10, floor),
        "sub2_pgd": phase_sub2(torch, dev, 1, 100),
        "stream_update": phase_stream(torch, dev, 1, 100, 10, floor),
        "compress_update": phase_compress(torch, dev, "quant", 100, P_CNN),
        "compress_update_topk": phase_compress(torch, dev, "topk", 100,
                                               P_CNN),
        "fedavg_agg_masked": phase_masked(torch, dev, 100, P_CNN),
        "fedavg_agg_stale": phase_stale(torch, dev, 100, P_CNN),
        **phase_flash(torch, dev),
        **phase_flash_bwd(torch, dev),
        "fedavg_agg_train": phase_fedavg_train(torch, dev, TRAIN_K,
                                               XLSTM_PARAMS),
    }
    phase_fedavg(torch, dev, 100, P_MLP)
    results["sub2_pgd_batch"] = phase_sub2(torch, dev, BATCH_S, 100)
    phase_sub2(torch, dev, 1, 1024)
    results["stream_update_batch"] = phase_stream(torch, dev, BATCH_S, 100,
                                                  10, floor)
    phase_stream_scenarios(torch, dev, BATCH_S, 100, 10)
    results["diversity_batch"] = results["diversity"]
    for p in (P_CNN, P_MLP):
        for name in FEDAVG_FORMS:
            rec = phase_fedavg_batch(torch, dev, name, BATCH_S, 100, p)
            if p == P_CNN:
                results[f"{name}_batch"] = rec
    results["compress_update_batch"] = phase_compress_batch(
        torch, dev, BATCH_S, 100, P_CNN)
    phase_compress(torch, dev, "quant", 100, P_MLP)
    phase_compress(torch, dev, "topk", 100, P_MLP)
    for mode in ("quant", "topk"):
        compress_check(torch, dev, mode, 16, 100, P_CNN)
        compress_check(torch, dev, mode, 1, 7, P_ODD)
        compress_check(torch, dev, mode, 1, 3, P_LONG)
    phase_masked(torch, dev, 100, P_MLP)
    phase_stale(torch, dev, 100, P_MLP)
    del data_dev

    # Each kernel's launches come from the path that runs it, counted
    # from zero just before that path's run.
    owner = {"diversity": 1, "fedavg_agg": 1, "sub2_pgd": 1,
             "stream_update": 2, "fedavg_agg_masked": 2,
             "compress_update": 3, "compress_update_topk": 3,
             "fedavg_agg_stale": 4,
             "flash_attention": 6, "flash_attention_decode": 6,
             "diversity_batch": 7, "sub2_pgd_batch": 7,
             "fedavg_agg_batch": 7, "stream_update_batch": 8,
             "fedavg_agg_masked_batch": 8, "compress_update_batch": 9,
             "fedavg_agg_stale_batch": 10, "fedavg_agg_train": 13,
             "flash_attention_bwd": 20, "flash_attention_bwd_hd160": 21,
             **{name: path for name, (path, *_) in PATH_FLASH.items()}}
    by_path, recs, walls = {}, {}, {}
    for path in (1, 2, 3):
        by_path[path], recs[path], walls[path] = phase_path(
            torch, dev, data, net, wcfg, path)
    # Path 4's ticks last half of path 1's median simulated round, so
    # slow uploads straddle ticks and arrive stale.
    horizon = half_median_round_time(recs[1])
    print(f"[path 4] tick_horizon = half the median of path 1's round "
          f"times = {horizon:.6f} s", flush=True)
    by_path[4], _, walls[4] = phase_path(torch, dev, data, net, wcfg, 4,
                                         horizon=horizon)
    phase_sync_limit(torch, dev, data, net, wcfg)
    phase_telemetry(torch, dev, data, net, wcfg)
    for path in BATCH_OF:
        by_path[path], _, walls[path] = phase_batch_path(
            torch, dev, data, wcfg, path, walls[BATCH_OF[path]],
            **(dict(horizon=horizon) if path == 10 else {}))
    phase_sweep(torch, dev, data, wcfg, walls[7], smi)
    for path in (1, 2, 3):
        phase_profile(torch, dev, data, net, wcfg, path, floor)
    phase_profile(torch, dev, data, net, wcfg, 4, floor, horizon=horizon)
    for path in BATCH_OF:
        path_kw = dict(horizon=horizon, events=1) if path == 10 else {}
        phase_profile(torch, dev, data, None, wcfg, path, floor,
                      run=lambda path=path, path_kw=path_kw: run_batch(
                          torch, data, batch_networks(
                              BATCH_S, data.num_devices, wcfg), wcfg,
                          rounds=1, iterations_max=6,
                          sub2=bandwidth.Sub2Params(), device=dev,
                          path=path, **path_kw),
                      what=f"1-{'event' if path == 10 else 'round'} "
                           f"run_federated_batch S={BATCH_S}")
    torch.cuda.empty_cache()
    r16 = {path: phase_card_vs_cpu(torch, dev, path) for path in (1, 2, 3)}
    horizon16 = half_median_round_time(r16[1])
    phase_card_vs_cpu(torch, dev, 4, horizon=horizon16)
    for path in BATCH_OF:
        phase_batch_card_vs_cpu(torch, dev, path, horizon=horizon16)
    by_path[6] = phase_serve(torch, dev)
    phase_dense_card_vs_cpu(torch, dev)
    for path in MOE_PATHS:
        by_path[path] = phase_moe_serve(torch, dev, path)
    phase_moe_card_vs_cpu(torch, dev)
    for path in MEDIA_PATHS:
        by_path[path] = phase_media_serve(torch, dev, path)
    phase_media_card_vs_cpu(torch, dev)
    by_path[14] = phase_xlstm_serve(torch, dev)
    by_path[13] = phase_train(torch, dev, smi)
    phase_xlstm_card_vs_cpu(torch, dev)
    by_path[20] = phase_danube_train(torch, dev, smi)
    phase_danube_card_vs_cpu(torch, dev)
    path21 = {}
    by_path[21] = phase_stablelm_train(torch, dev, smi, path21)
    phase_stablelm_card_vs_cpu(torch, dev)
    phase_launch(torch, dev, None, wcfg, smi, path21)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=by_path[owner[name]][re.sub(
                        "_(batch|train|g6|g8|g16|enc)$|_cross(?=_decode$)",
                        "", name)],
                    **results[name])
               for name, (src, rep) in KERNELS.items()]
    print(f"[time] chip_smoke ran {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
