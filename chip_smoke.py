#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

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
   CPU (f32, TF32 off): prefill and 3 decode steps, logits within 1e-4.

The kernel phase also holds ``flash_attention`` against its plain
version at the prefill (one KV group), decode and edge-case shapes, in
bf16 and f32, and times it beside SDPA.

The last two lines are the ``kernels`` JSON record and the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
# The stale kernel's limit against its plain version (as its siblings).
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


def phase_fedavg(torch, dev, k: int, p: int) -> dict:
    from repro_torch.kernels import fedavg_agg as fk
    gen = torch.Generator(device=dev).manual_seed(SEED + p)
    n = cycling(k * p * 4)
    us = [torch.randn((k, p), generator=gen, device=dev) for _ in range(n)]
    w = torch.softmax(torch.randn((k,), generator=gen, device=dev), 0)
    got = fk.fedavg_agg(us[0], w)
    want = fk.fedavg_agg_plain(us[0], w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # f32 sums of K products in another order (the plain version is a
    # cuBLAS reduction): a few ulps of the O(1) result.
    if not err <= 1e-5:
        raise AssertionError(f"fedavg_agg K={k} P={p}: max err {err}")
    it = iter(range(10 ** 9))
    ms = time_ms(lambda: fk.fedavg_agg(us[next(it) % n], w), 200)
    plain_ms = time_ms(lambda: fk.fedavg_agg_plain(us[next(it) % n], w), 200)
    library_ms = time_ms(lambda: w @ us[next(it) % n], 200)
    b_ms, b_by = bound(k * p * 4 + k * 4 + p * 4, 2 * k * p)
    print(f"[kernel] fedavg_agg K={k} P={p}: max_abs_err={err:.3g} "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms(w@u)="
          f"{library_ms:.5f} bound_ms={b_ms:.5f} ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def phase_diversity(torch, dev, labels, mask, c: int) -> dict:
    from repro_torch.kernels import diversity as dk
    k, n = labels.shape
    got = dk.diversity_stats(labels, mask, c)
    want = dk.diversity_stats_plain(labels, mask, c)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # Exact integer counts; gini/shannon sums over C classes in another
    # order.
    if not err <= 1e-5:
        raise AssertionError(f"diversity K={k} N={n}: max err {err}")
    ms = time_ms(lambda: dk.diversity_stats(labels, mask, c), 200)
    plain_ms = time_ms(lambda: dk.diversity_stats_plain(labels, mask, c),
                       50)
    b_ms, b_by = bound(k * n * 8 + k * 12, k * n * 2)
    print(f"[kernel] diversity K={k} N={n} C={c}: max_abs_err={err:.3g} "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={b_ms:.6f} "
          f"({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


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


def phase_sub2(torch, dev, s: int, k: int) -> dict:
    from repro_torch.core import bandwidth
    from repro_torch.kernels import sub2_pgd as sk
    args, wcfg = sub2_instances(torch, dev, s, k)
    p = bandwidth.Sub2Params()
    kw = dict(rho=p.rho, lr=p.pgd_lr, tau=p.smooth_tau, iters=p.pgd_iters,
              bandwidth_hz=wcfg.bandwidth_hz, min_alpha=wcfg.min_alpha)
    a_k, o_k = sk.sub2_pgd(*args, **kw)
    a_p, o_p = sk.sub2_pgd_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((a_k - a_p).abs().max())
    rel_obj = float(((o_k - o_p).abs() / o_p.abs()).max())
    # The reference's own tolerance between this descent and its autodiff
    # oracle (tests/test_allocator.py): the kernel's analytic gradient and
    # the plain version's autograd one round differently, and the
    # normalised steps amplify that along the objective's flat valley.
    if not (err <= 1e-2 and rel_obj <= 1e-3):
        raise AssertionError(f"sub2_pgd S={s}: alpha err {err}, "
                             f"objective rel err {rel_obj}")
    if not bool(torch.all(torch.isfinite(a_k))):
        raise AssertionError("sub2_pgd produced non-finite shares")
    ms = time_ms(lambda: sk.sub2_pgd(*args, **kw), 20)
    plain_ms = time_ms(lambda: sk.sub2_pgd_plain(*args, **kw), 2, warmup=1)
    b_ms, b_by = bound(s * k * 4 * 7 + s * 4,
                       s * 2 * k * p.pgd_iters * SUB2_OPS_PER_COORD_STEP)
    print(f"[kernel] sub2_pgd S={s} K={k} iters={p.pgd_iters}: "
          f"max_abs_err(alpha)={err:.3g} rel_err(obj)={rel_obj:.3g} "
          f"ms={ms:.4f} plain_ms={plain_ms:.2f} bound_ms={b_ms:.6f} "
          f"({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase_stream(torch, dev, s: int, k: int, c: int) -> dict:
    from repro_torch.kernels import stream_update as su
    gen = torch.Generator(device=dev).manual_seed(SEED + s)
    h = torch.randint(0, 900, (s, k, c), generator=gen, device=dev).float()
    d = torch.poisson(torch.full((s, k, c), 2.0, device=dev), generator=gen)
    arr = d.sum(-1)
    stale = torch.rand((s, k), generator=gen, device=dev) * 50.0
    sel = (torch.rand((s, k), generator=gen, device=dev) < 0.4).float()
    args = (h, d, arr, stale, sel)
    kw = dict(decay=0.8, size_cap=900.0)     # the full world's capacity
    got = su.stream_update(*args, **kw)
    want = su.stream_update_plain(*args, **kw)
    torch.cuda.synchronize()
    # Relative to each output's scale: counts and sizes reach 900.
    err = max(float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
              for g, w in zip(got, want))
    if not err <= STREAM_TOL:
        raise AssertionError(f"stream_update S={s}: rel err {err}")
    ms = time_ms(lambda: su.stream_update(*args, **kw), 200)
    plain_ms = time_ms(lambda: su.stream_update_plain(*args, **kw), 100)
    b_ms, b_by = bound(s * k * c * 12 + s * k * 28,
                       s * k * c * STREAM_OPS_PER_CLASS)
    print(f"[kernel] stream_update S={s} K={k} C={c}: max_rel_err={err:.3g} "
          f"(limit {STREAM_TOL:g}) ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.7f} ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def phase_compress(torch, dev, mode: str, k: int, p: int) -> dict:
    from repro_torch.kernels import compress as cu
    gen = torch.Generator(device=dev).manual_seed(SEED + p)
    n = cycling(k * p * (12 if mode == "quant" else 8))
    scale = torch.rand((k, 1), generator=gen, device=dev)
    sets = []
    for _ in range(n):
        u = torch.randn((k, p), generator=gen, device=dev) * scale
        r = 0.1 * torch.randn((k, p), generator=gen, device=dev)
        noise = torch.rand((k, p), generator=gen, device=dev) \
            if mode == "quant" else torch.zeros((k,), device=dev)
        sets.append((u, r, noise))
    sel = (torch.rand((k,), generator=gen, device=dev) < 0.8).float()
    widths = torch.full((k,), 8.0 if mode == "quant" else 32.0, device=dev)
    keep = max(1, round(0.05 * p))
    kw = dict(mode=mode, keep=keep)
    u, r, noise = sets[0]
    c, r_new = cu.compress_update(u, r, widths, sel, noise, **kw)
    c_p, r_p = cu.compress_update_plain(u, r, widths, sel, noise, **kw)
    torch.cuda.synchronize()
    err = max(float((c - c_p).abs().max()), float((r_new - r_p).abs().max()))
    flipped = float((c != c_p).float().mean())
    r_flipped = float((r_new != r_p).float().mean())
    if mode == "topk" and not (torch.equal(c, c_p) and torch.equal(r_new,
                                                                   r_p)):
        raise AssertionError(f"compress_update topk P={p}: max err {err}")
    if mode == "quant" and not (flipped <= QUANT_FLIP_LIMIT
                                and r_flipped <= QUANT_FLIP_LIMIT):
        raise AssertionError(f"compress_update quant P={p}: flipped share "
                             f"{flipped}, residual share {r_flipped}")
    # Where the codes agree, the residual v - c (or r, unselected) must be
    # bit for bit the plain one: the flips are the only difference.
    same = c == c_p
    if mode == "quant" and not torch.equal(r_new[same], r_p[same]):
        raise AssertionError(f"compress_update quant P={p}: residual differs "
                             f"where the codes agree")
    it = iter(range(10 ** 9))

    def call(fn):
        u, r, noise = sets[next(it) % n]
        return fn(u, r, widths, sel, noise, **kw)

    ms = time_ms(lambda: call(cu.compress_update), 50)
    plain_ms = time_ms(lambda: call(cu.compress_update_plain), 5, warmup=1)
    if mode == "quant":
        b_ms, b_by = bound(20 * k * p + 8 * k, k * p * QUANT_OPS_PER_COORD)
    else:
        b_ms, b_by = bound(16 * k * p + 8 * k, k * p * (
            TOPK_OPS_PER_COORD + 32 * TOPK_OPS_PER_COORD_TRIP))
    print(f"[kernel] compress_update {mode} K={k} P={p}: max_abs_err="
          f"{err:.3g} flipped_share={flipped:.3g} residual_share="
          f"{r_flipped:.3g} (limit {QUANT_FLIP_LIMIT:g} quant, exact topk) "
          f"ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by})",
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
    got = fk.fedavg_agg_masked(us[0], w, m)
    want = fk.fedavg_agg_masked_plain(us[0], w, m)
    ones = fk.fedavg_agg_masked(us[0], w, torch.ones_like(m))
    unmasked = fk.fedavg_agg(us[0], w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # Same limit as fedavg_agg: K-term f32 sums in another order.
    if not err <= 1e-5:
        raise AssertionError(f"fedavg_agg_masked K={k} P={p}: err {err}")
    if not torch.equal(ones, unmasked):
        raise AssertionError("fedavg_agg_masked with an all-ones mask is "
                             "not bitwise fedavg_agg")
    it = iter(range(10 ** 9))
    ms = time_ms(lambda: fk.fedavg_agg_masked(us[next(it) % n], w, m), 200)
    plain_ms = time_ms(
        lambda: fk.fedavg_agg_masked_plain(us[next(it) % n], w, m), 200)
    library_ms = time_ms(lambda: (w * m) @ us[next(it) % n], 200)
    b_ms, b_by = bound(k * p * 4 + k * 8 + p * 4, 2 * k * p)
    print(f"[kernel] fedavg_agg_masked K={k} P={p}: max_abs_err={err:.3g} "
          f"all-ones bitwise fedavg_agg: yes ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms((w*m)@u)={library_ms:.5f} bound_ms="
          f"{b_ms:.5f} ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def phase_stale(torch, dev, k: int, p: int) -> dict:
    from repro_torch.kernels import fedavg_agg as fk
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 * p)
    n = cycling(k * p * 4)
    us = [torch.randn((k, p), generator=gen, device=dev) for _ in range(n)]
    w = torch.softmax(torch.randn((k,), generator=gen, device=dev), 0)
    m = (torch.rand((k,), generator=gen, device=dev) < 0.5).float()
    tau = torch.randint(0, 5, (k,), generator=gen, device=dev).float()
    s = (1.0 + tau) ** -0.5
    got = fk.fedavg_agg_stale(us[0], w, m, s)
    want = fk.fedavg_agg_stale_plain(us[0], w, m, s)
    ones = fk.fedavg_agg_stale(us[0], w, m, torch.ones_like(s))
    masked = fk.fedavg_agg_masked(us[0], w, m)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # Same limit as its siblings: K-term f32 sums in another order.
    if not err <= STALE_TOL:
        raise AssertionError(f"fedavg_agg_stale K={k} P={p}: err {err}")
    if not torch.equal(ones, masked):
        raise AssertionError("fedavg_agg_stale with all-ones s is not "
                             "bitwise fedavg_agg_masked")
    it = iter(range(10 ** 9))
    ms = time_ms(lambda: fk.fedavg_agg_stale(us[next(it) % n], w, m, s),
                 200)
    plain_ms = time_ms(
        lambda: fk.fedavg_agg_stale_plain(us[next(it) % n], w, m, s), 200)
    library_ms = time_ms(lambda: (w * m * s) @ us[next(it) % n], 200)
    b_ms, b_by = bound(k * p * 4 + k * 12 + p * 4, 2 * k * p)
    print(f"[kernel] fedavg_agg_stale K={k} P={p}: max_abs_err={err:.3g} "
          f"(limit {STALE_TOL:g}) all-ones s bitwise fedavg_agg_masked: "
          f"yes ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms((w*m*s)@u)="
          f"{library_ms:.5f} bound_ms={b_ms:.5f} ({b_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# Flash attention at danube's head geometry.  f32: within 1e-5 of the
# plain version (tests/test_kernels.py::_tol of the reference; sums in
# another order).  bf16: each output within half a bf16 ulp of the plain
# version's f32 answer on the same input values, plus that 1e-5 -- what
# f32 arithmetic rounded to nearest once at the store gives; a store that
# truncates, or a bf16 intermediate, reads up to 2.
FLASH_TOL = 1e-5
# Peak rates for the operations bound: bf16 on the tensor cores (dense),
# f32 outside them.
PEAK_OPS = {"float32": F32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}
DANUBE_HEADS = dict(h=32, kv=8, hd=120)
SERVE_B, SERVE_PROMPT, SERVE_GEN, SERVE_WINDOW = 4, 5000, 32, 4096


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
    cast to the input type is its output."""
    from repro_torch.kernels import _check
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    err = float((got - want.to(q.dtype)).float().abs().max())
    if q.dtype == torch.float32:
        ok, read = err <= FLASH_TOL, f"(limit {FLASH_TOL:g})"
    else:
        ratio = _check.bf16_rounding_ratio(got, want, FLASH_TOL)
        ok = ratio <= 1.0
        read = (f"(bf16 plain output); against the f32 answer "
                f"{float((got.float() - want).abs().max()):.3g}, worst / "
                f"(half bf16 ulp + {FLASH_TOL:g}) = {ratio:.4f} (limit 1)")
    print(f"[kernel] flash_attention {label} {tuple(q.shape)} x "
          f"{tuple(k.shape)} {q.dtype} {kw}: max_abs_err={err:.3g} {read}",
          flush=True)
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


def flash_timed(torch, fa, sets, label: str, **kw) -> dict:
    """Kernel, plain and SDPA ms of one shape (inputs cycled past L2)."""
    q, k, v = sets[0]
    n = len(sets)
    it = iter(range(10 ** 9))

    def kernel():
        return fa.flash_attention(*sets[next(it) % n], **kw)
    ms = time_ms(kernel, 20 if q.shape[1] > 1 else 200)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2,
                       warmup=1)
    sdpa, sdpa_out = flash_sdpa(torch, q, k, v, **kw)
    sdpa_err = float((sdpa_out.float() - fa.flash_attention(q, k, v, **kw)
                      .float()).abs().max())
    library_ms = time_ms(sdpa, 20 if q.shape[1] > 1 else 200)
    pairs = fa.visible_pairs(q.shape[1], causal=kw["causal"],
                             window=kw["window"], kv_len=kw["kv_len"])
    b_ms, b_by = flash_bound(q, k, pairs)
    print(f"[kernel] flash_attention {label} {tuple(q.shape)} x "
          f"{tuple(k.shape)} {q.dtype}: ms={ms:.5f} plain_ms={plain_ms:.3f} "
          f"library_ms(sdpa)={library_ms:.5f} (sdpa vs kernel max diff "
          f"{sdpa_err:.3g}) bound_ms={b_ms:.5f} ({b_by}; {pairs} visible "
          f"pairs per head)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_flash(torch, dev) -> dict:
    """flash_attention against its plain version at the prefill (one KV
    group), decode and edge shapes in bf16 and f32; times at the path's
    prefill (B = 4) and decode shapes.  Returns the bf16 prefill row."""
    from repro_torch.kernels import flash_attention as fa
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
        edges = [  # (b, sq, skv, h, kv, hd, kwargs)
            (2, 100, 100, 4, 2, 64, dict(causal=False, window=0)),
            (2, 77, 200, 4, 4, 128, dict(causal=False, window=0, kv_len=150)),
            (1, 300, 300, 8, 2, 160, dict(causal=True, window=50)),
            (1, 129, 129, 2, 1, 128, dict(causal=True, window=0)),
            (2, 200, 200, 8, 8, 64, dict(causal=True, window=33, kv_len=170)),
            (3, 1, 77, 40, 8, 128, dict(causal=False, window=0, kv_len=61)),
            (2, 1, 300, 32, 8, 160, dict(causal=False, window=0)),
        ]
        for b, sq, skv, hh, kvv, d, kw in edges:
            (q, k, v), = flash_inputs(torch, dev, gen, b, sq, skv, hh, kvv, d,
                                      dtype)
            flash_check(torch, fa, q, k, v, "(c) edge", **kw)
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
    row = dict(rows[("prefill", torch.bfloat16)],
               max_abs_err=errs[("prefill", torch.bfloat16)])
    return row


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
                cap: int = PATH4_CAP, events: int = ASYNC["num_events"]
                ) -> tuple[dict, dict]:
    """(FLConfig subsystem fields, SchedulerConfig extras) of a path.
    ``horizon``, ``cap`` and ``events`` shape path 4."""
    from repro_torch.core import compression, events as ev, faults, \
        streaming
    if path == 1:
        return {}, {}
    fl = dict(stream=streaming.StreamConfig(process="poisson"),
              faults=faults.FaultConfig(**FAULTS))
    if path == 3:
        fl["compression"] = compression.CompressionConfig(codec=codec,
                                                          bit_width=8)
    if path == 4:
        fl.update(events=ev.EventConfig(**dict(ASYNC, tick_horizon=horizon,
                                               num_events=events)),
                  dispatch_cap=cap, carry_dtype="bfloat16")
    if path == 5:
        fl["events"] = ev.EventConfig()
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
    """The DAS convergence test's source line (``bool(changed)``), where
    the round's one host sync per outer iteration happens."""
    path = os.path.join(ROOT, "src", "repro_torch", "core", "scheduler.py")
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if "if not bool(changed):" in line:
                return f"{os.path.relpath(path, ROOT)}:{n}"
    raise AssertionError("the DAS convergence test is gone")


def count_syncs(torch, data, net, wcfg, dev, path: int, **kw):
    """The host syncs of one full-width run (set-up included) by source
    line, with PyTorch's CUDA sync debug mode -> (counter, records)."""
    import collections
    import warnings
    from repro_torch.core import bandwidth
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run_slice(torch, data, net, wcfg, iterations_max=6,
                            sub2=bandwidth.Sub2Params(), device=dev,
                            path=path, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
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
    Returns ``(launch counts, records)``."""
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
          f"= {warm / rounds:.3f}s per {unit}; launches {counts}",
          flush=True)
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
        return counts, recs
    check_records(torch, recs, params, data.num_devices)
    if path == 3:
        reset_counts()
        params, recs3 = run_slice(torch, data, net, wcfg, **dict(
            kw, rounds=1), codec="topk")
        got = read_counts()
        want = expected_counts(3, 1, recs3[0].iterations)
        print(f"[path 3] one topk round: acc={recs3[0].accuracy:.4f} "
              f"sel={recs3[0].n_selected} ok={recs3[0].n_success} "
              f"launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"topk launch counts {got}, expected "
                                 f"{want}")
        check_records(torch, recs3, params, data.num_devices)
    return counts, recs


def phase_sync_limit(torch, dev, data, net, wcfg) -> dict:
    """Path 5: path 2 with ``EventConfig()`` against path 2 on the card,
    3 rounds each, with deterministic algorithms switched on for this
    phase only (cuDNN's deterministic convolutions; ``warn_only`` so an
    operation without a deterministic version warns instead of raising,
    and the warnings are printed).  Selections, delivered counts, round
    times, energies and DAS iterations must be equal and the parameters
    bit for bit, else the largest difference is printed and the phase
    fails above 1e-6."""
    import warnings
    from repro_torch.core import bandwidth
    kw = dict(rounds=3, iterations_max=6, sub2=bandwidth.Sub2Params(),
              device=dev)
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p2, r2 = run_slice(torch, data, net, wcfg, path=2, **kw)
            reset_counts()
            p5, r5 = run_slice(torch, data, net, wcfg, path=5, **kw)
            torch.cuda.synchronize()
            counts = read_counts()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        cudnn.deterministic, cudnn.benchmark = saved[2], saved[3]
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    print(f"[path 5] deterministic algorithms on; operations without a "
          f"deterministic version: {nondet or 'none'}", flush=True)
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


def phase_profile(torch, dev, data, net, wcfg, path: int,
                  **path_kw) -> None:
    """One more full-width round (path 4: its events) under
    torch.profiler: per phase scope the host time and the device time of
    its kernels; the top kernels; the device's busy and idle share of
    the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import bandwidth
    scopes = ("schedule", "local_train", "aggregate", "evaluate")
    if path > 1:
        scopes += ("stream_refresh",)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_slice(torch, data, net, wcfg, rounds=1, iterations_max=6,
                  sub2=bandwidth.Sub2Params(), device=dev, path=path,
                  **path_kw)
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
    for kname in ("diversity_kernel", "sub2_pgd_kernel",
                  "fedavg_agg_kernel", "stream_update_kernel",
                  "compress_update_kernel", "fedavg_agg_masked_kernel",
                  "fedavg_agg_stale_kernel"):
        hits = [(tot, n) for name, (tot, n) in by_name.items()
                if f"::{kname}(" in name]
        if hits:
            tot, n = map(sum, zip(*hits))
            print(f"[profile] path {path} {kname}: {n} launches, device "
                  f"{tot / n / 1e3:.5f} ms per launch", flush=True)
    what = f"{ASYNC['num_events']}-event run_events" if path == 4 \
        else "1-round run_federated"
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
    flash_attention's device us); print the ``host_top`` operators with
    the most host time of their own."""
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
    return wall_us, busy, flash


def phase_serve(torch, dev) -> dict:
    """Path 6: h2o-danube-3-4b at full width, served.  Returns the
    launch counts of its prefill + decode run."""
    from repro_torch import configs
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
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("path 6: non-finite decode logits")
    want = dict.fromkeys(_counters(), 0)
    want["flash_attention"] = cfg.num_layers * (1 + n_gen)
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
    wall, busy, flash = profile_device(
        torch, lambda: transformer.decode_step(sp, tok, cache, s + n_gen,
                                               cfg), host_top=12)
    print(f"[path 6] profiled decode step: wall {wall / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall:.3f} "
          f"(against the unprofiled warm step: "
          f"{1 - busy / (step_s * 1e6):.3f}); flash_attention "
          f"{flash / 1e3:.3f} ms = {flash / busy:.3f} of device time",
          flush=True)
    del cache
    wall, busy, flash = profile_device(
        torch, lambda: transformer.prefill(sp, prompt, cfg, pad_to=pad_to))
    print(f"[path 6] profiled prefill: wall {wall / 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.1f} ms, idle share {1 - busy / wall:.3f}; "
          f"flash_attention {flash / 1e3:.1f} ms = {flash / busy:.3f} of "
          f"device time", flush=True)
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
    return counts


def serve_parity(torch, transformer, params, cfg, prompt, tok, logits,
                 label: str) -> tuple[float, bool]:
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
    print(f"[path 6] {label} decode parity vs forward at position "
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
    tokens on the card and the CPU (f32, TF32 off), prefill of 150
    tokens (past danube's reduced 128-slot window) and 3 decode steps."""
    from repro_torch import configs
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s, steps = 2, 150, 3
    for arch in DENSE_ARCHS:
        cfg = configs.get(arch).reduced()
        gen = torch.Generator().manual_seed(SEED + 8)
        params = transformer.init(gen, cfg)
        tokens = torch.randint(0, cfg.vocab_size, (b, s + steps),
                               generator=gen)
        outs = {}
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
        rel = max(float((c - g).abs().max() / c.abs().max())
                  for c, g in zip(outs["cpu"], outs[str(dev)]))
        print(f"[card-vs-cpu] {cfg.name} reduced: prefill + {steps} decode "
              f"steps, logits max rel err {rel:.3g} (limit "
              f"{DENSE_CARD_CPU_TOL:g})", flush=True)
        if not rel <= DENSE_CARD_CPU_TOL:
            raise AssertionError(f"{cfg.name}: card and CPU logits differ "
                                 f"by {rel}")


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
    "fedavg_agg_masked": ("src/repro_torch/csrc/fedavg_agg.cu",
                          "src/repro/kernels/fedavg_agg.py:100"),
    "fedavg_agg_stale": ("src/repro_torch/csrc/fedavg_agg.cu",
                         "src/repro/kernels/fedavg_agg.py:58"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:90"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"[card] {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    data, net, wcfg = full_width_world(torch, dev)
    data_dev = data.to(dev)
    # The rows of the kernels line: each kernel at the shapes its path
    # gives it (S = 1, the CNN's P, 8-bit quant).
    results = {
        "fedavg_agg": phase_fedavg(torch, dev, 100, P_CNN),
        "diversity": phase_diversity(torch, dev, data_dev.labels,
                                     data_dev.mask, 10),
        "sub2_pgd": phase_sub2(torch, dev, 1, 100),
        "stream_update": phase_stream(torch, dev, 1, 100, 10),
        "compress_update": phase_compress(torch, dev, "quant", 100, P_CNN),
        "fedavg_agg_masked": phase_masked(torch, dev, 100, P_CNN),
        "fedavg_agg_stale": phase_stale(torch, dev, 100, P_CNN),
        "flash_attention": phase_flash(torch, dev),
    }
    phase_fedavg(torch, dev, 100, P_MLP)
    phase_sub2(torch, dev, 16, 100)
    phase_stream(torch, dev, 16, 100, 10)
    phase_compress(torch, dev, "quant", 100, P_MLP)
    phase_compress(torch, dev, "topk", 100, P_CNN)
    phase_compress(torch, dev, "topk", 100, P_MLP)
    phase_masked(torch, dev, 100, P_MLP)
    phase_stale(torch, dev, 100, P_MLP)
    del data_dev

    # Each kernel's launches come from the path that runs it, counted
    # from zero just before that path's run.
    owner = {"diversity": 1, "fedavg_agg": 1, "sub2_pgd": 1,
             "stream_update": 2, "fedavg_agg_masked": 2,
             "compress_update": 3, "fedavg_agg_stale": 4,
             "flash_attention": 6}
    by_path, recs = {}, {}
    for path in (1, 2, 3):
        by_path[path], recs[path] = phase_path(torch, dev, data, net, wcfg,
                                               path)
    # Path 4's ticks last half of path 1's median simulated round, so
    # slow uploads straddle ticks and arrive stale.
    horizon = half_median_round_time(recs[1])
    print(f"[path 4] tick_horizon = half the median of path 1's round "
          f"times = {horizon:.6f} s", flush=True)
    by_path[4], _ = phase_path(torch, dev, data, net, wcfg, 4,
                               horizon=horizon)
    phase_sync_limit(torch, dev, data, net, wcfg)
    for path in (1, 2, 3):
        phase_profile(torch, dev, data, net, wcfg, path)
    phase_profile(torch, dev, data, net, wcfg, 4, horizon=horizon)
    r16 = {path: phase_card_vs_cpu(torch, dev, path) for path in (1, 2, 3)}
    phase_card_vs_cpu(torch, dev, 4, horizon=half_median_round_time(r16[1]))
    by_path[6] = phase_serve(torch, dev)
    phase_dense_card_vs_cpu(torch, dev)

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=by_path[owner[name]][name], **results[name])
               for name, (src, rep) in KERNELS.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
