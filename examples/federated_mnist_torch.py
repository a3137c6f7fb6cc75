"""End-to-end driver of the PyTorch + CUDA port (one scenario, or S).

    PYTHONPATH=src python examples/federated_mnist_torch.py \
        [--model cnn|mlp] [--method das|abs|random|full] [--rounds 15]
        [--devices 40] [--n-fixed 7] [--epochs 1] [--model-bits 100e3]
        [--full-data] [--seed 0] [--allocator fused_pgd]
        [--kernel-agg | --no-kernel-agg] [--device cuda|cpu]
        [--stream poisson|drift|shift|evict|static] [--stream-rate 25]
        [--staleness-weight 0.25] [--codec none|quant|topk|adaptive]
        [--bit-width 8] [--dispatch-cap 16]
        [--carry-dtype float32|bfloat16|float16] [--scenarios 1]
        [--chunk-scenarios 0] [--sweep-ckpt PATH] [--sweep-jsonl PATH]

The port's counterpart of ``examples/federated_mnist.py``: K devices with
shard-partitioned synthetic MNIST-like data, DAS/ABS/random/full
scheduling and FedAvg training through
``repro_torch.core.federated.run_federated``, with the same per-round
line.  It runs on the CUDA card by default (the ``diversity``,
``sub2_pgd`` and ``fedavg_agg`` kernels on the DAS + ``fused_pgd`` +
kernel-FedAvg path); ``--device cpu`` runs the plain PyTorch versions.
``--stream`` turns on streaming data (the ``stream_update`` kernel
refreshes the per-device statistics every round) and ``--codec``
compressed uplinks (the ``compress_update`` kernel); ``--dispatch-cap``
trains only a dense block of that many admitted devices (the per-round
line gains a ``drop=`` column) and ``--carry-dtype`` stores the carried
streaming stats and error-feedback residual at reduced precision, with
the JAX example's flags and defaults.  ``--scenarios S > 1`` runs a
Monte-Carlo sweep of S independent scenarios (each its own network and
random tape, seeded by global scenario index from ``--seed``) through
``repro_torch.sweep.run_sweep``: chunks of ``--chunk-scenarios``
scenarios (0: all in one) each run as one
``federated.run_federated_batch`` call, where every kernel launches once
a round for the whole chunk, folded into per-round mean / min / max.
``--sweep-ckpt`` checkpoints the sweep after every chunk, and a killed
run started again with the same flags resumes from it (any file at that
path is resumed; its fingerprint covers the configs, not ``--devices``,
the data or the model, so delete it for a fresh study); ``--sweep-jsonl``
streams one line of aggregates per chunk.  It prints the JAX example's
per-round ``acc=mean [min,max] sel= T=`` lines and its final line.
"""

import argparse
import os
import sys

import torch

from repro_torch import sweep
from repro_torch.core import compression, federated, scheduler, \
    streaming, wireless
from repro_torch.data import partition, synthetic
from repro_torch.device import resolve_device
from repro_torch.models import paper_nets


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mlp", choices=["mlp", "cnn"])
    ap.add_argument("--method", default="das",
                    choices=["das", "abs", "random", "full"])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--devices", type=int, default=40)
    ap.add_argument("--n-fixed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--model-bits", type=float, default=100e3)
    ap.add_argument("--full-data", action="store_true",
                    help="paper scale: 1200 shards x 50 (else 300x50)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--allocator", default="fused_pgd",
                    choices=["fused_pgd", "pgd", "waterfilling",
                             "importance"])
    ap.add_argument("--kernel-agg", action=argparse.BooleanOptionalAction,
                    default=True, help="FedAvg through the CUDA kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--codec", default="",
                    choices=["", "none", "quant", "topk", "adaptive"],
                    help="uplink compression codec (default: "
                         "uncompressed full-precision uploads)")
    ap.add_argument("--bit-width", type=int, default=8,
                    help="quantization bit width for --codec quant")
    ap.add_argument("--stream", default="",
                    choices=["", "static", "poisson", "drift", "shift",
                             "evict"],
                    help="streaming-data arrival process (default: "
                         "static data, the paper's frozen partition)")
    ap.add_argument("--stream-rate", type=float, default=25.0,
                    help="mean arrivals per device per round")
    ap.add_argument("--staleness-weight", type=float, default=0.25,
                    help="gamma_s staleness boost for streaming runs")
    ap.add_argument("--dispatch-cap", type=int, default=0,
                    help="dense-block training lanes (0: masked all-K "
                         "path)")
    ap.add_argument("--carry-dtype", default="",
                    choices=["", "float32", "bfloat16", "float16"],
                    help="storage dtype of the carried streaming stats "
                         "and error-feedback residual")
    ap.add_argument("--scenarios", type=int, default=1,
                    help="Monte-Carlo scenarios through the sweep engine")
    ap.add_argument("--chunk-scenarios", type=int, default=0,
                    help="scenarios per batch call (0: all in one)")
    ap.add_argument("--sweep-ckpt", default="",
                    help="checkpoint path for resumable sweeps")
    ap.add_argument("--sweep-jsonl", default="",
                    help="stream per-chunk aggregates to this JSONL "
                         "file (resume-safe)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    shards = 1200 if args.full_data else 300
    spc = 6000 if args.full_data else 2000
    imgs, labels = synthetic.generate(args.seed, samples_per_class=spc)
    data = partition.partition(
        imgs, labels, seed=args.seed + 1,
        spec=partition.PartitionSpec(num_devices=args.devices,
                                     num_shards=shards, shard_size=50))
    wcfg = wireless.WirelessConfig(model_bits=args.model_bits)
    net = wireless.sample_network(
        torch.Generator().manual_seed(args.seed + 2), args.devices, wcfg)
    mspec = paper_nets.PaperNetSpec(kind=args.model)
    model = paper_nets.init(mspec,
                            torch.Generator().manual_seed(args.seed + 3))
    n_params = paper_nets.num_params(paper_nets.params_of(model))
    print(f"[feel-torch] {args.model} ({n_params:,} params), "
          f"K={args.devices}, method={args.method}, E={args.epochs}, "
          f"s={args.model_bits / 1e3:.0f} kbit, allocator={args.allocator}, "
          f"kernel_agg={args.kernel_agg}, device={dev}"
          + (f", stream={args.stream}@{args.stream_rate:g}/round"
             if args.stream else "")
          + (f", codec={args.codec}" if args.codec else "")
          + (f", S={args.scenarios}" if args.scenarios > 1 else ""))

    scfg = scheduler.SchedulerConfig(
        method=args.method, n_min=1, n_fixed=args.n_fixed or None,
        iterations_max=6, allocator=args.allocator,
        staleness_weight=args.staleness_weight if args.stream else 0.0)
    stream_cfg = streaming.StreamConfig(
        process=args.stream, rate=args.stream_rate) if args.stream else None
    comp_cfg = compression.CompressionConfig(
        codec=args.codec, bit_width=args.bit_width) if args.codec else None
    fcfg = federated.FLConfig(
        num_rounds=args.rounds, local_epochs=args.epochs, batch_size=50,
        learning_rate=0.1 if args.model == "mlp" else 0.05,
        use_kernel_agg=args.kernel_agg, stream=stream_cfg,
        compression=comp_cfg, dispatch_cap=args.dispatch_cap or None,
        carry_dtype=args.carry_dtype or None)
    if args.scenarios > 1:
        run_sweep(args, model, data, wcfg, scfg, fcfg, dev)
        return
    _, hist = federated.run_federated(
        model=model, data=data, net=net, wcfg=wcfg, scfg=scfg, fcfg=fcfg,
        seed=args.seed + 4, device=dev)

    e_tot = t_tot = 0.0
    for r in hist:
        e_tot += r.energy_total
        t_tot += r.round_time
        drop = f" drop={r.n_dropped:2d}" if args.dispatch_cap else ""
        print(f"round {r.round:3d}: acc={r.accuracy:.4f} "
              f"sel={r.n_selected:3d} T={r.round_time:7.3f}s "
              f"E/dev={r.energy_per_device:7.3f}J{drop}")
    print(f"[feel-torch] total: time={t_tot:.1f}s energy={e_tot:.1f}J "
          f"final acc={hist[-1].accuracy:.4f}")


def run_sweep(args, model, data, wcfg, scfg, fcfg, dev) -> None:
    """S scenarios through the sweep engine, in chunks, resumable."""
    spec = sweep.SweepSpec(
        fl=fcfg, sched=scfg, wireless=wcfg,
        scenarios_per_point=args.scenarios,
        chunk_scenarios=args.chunk_scenarios, base_seed=args.seed)
    if args.sweep_ckpt and os.path.exists(args.sweep_ckpt):
        print(f"[feel-torch] resuming the sweep from {args.sweep_ckpt}",
              file=sys.stderr)
    results = sweep.run_sweep(
        spec, model=model, data=data, ckpt_path=args.sweep_ckpt or None,
        jsonl_path=args.sweep_jsonl or None, device=dev)
    _, summary = results[0]
    acc = summary["round.accuracy"]
    sel = summary["round.n_selected"]
    t = summary["round.round_time"]
    for r in range(args.rounds):
        print(f"round {r:3d}: acc={acc['mean'][r]:.4f} "
              f"[{acc['min'][r]:.4f},{acc['max'][r]:.4f}] "
              f"sel={sel['mean'][r]:5.1f} T={t['mean'][r]:7.3f}s")
    final = summary["scalar.final_accuracy"]
    print(f"[feel-torch] S={args.scenarios} final acc "
          f"mean={float(final['mean']):.4f} min={float(final['min']):.4f} "
          f"max={float(final['max']):.4f} (std={float(final['std']):.4f})")


if __name__ == "__main__":
    main()
