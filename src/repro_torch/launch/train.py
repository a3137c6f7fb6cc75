"""LM training driver, plain or federated with DAS scheduling.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        [--reduced] [--steps 50] [--batch 8 --seq 128] [--federated K] \\
        [--num-layers N] [--device cpu] [--seed 0]

Port of ``repro.launch.train``.  Builds the model from the config
registry, synthetic LM token streams with a learnable bigram rule, and
runs ``train_step``, or with ``--federated K`` the federated step: every
step computes the clients' diversity index from their label histograms,
draws fading, schedules with DAS (``core.scheduler.schedule``), updates
the clients' ages and takes one FedAvg-weighted gradient step over the K
client shards -- the paper's technique as a training feature.
Checkpoints the parameters every ``--ckpt-every`` steps in the
reference's msgpack format.  Every decoder of the zoo trains, its
attention layers through the ``flash_attention`` kernel's gradient; the
encoder-decoder (whisper-small) does not, since the stream, as the
reference's, makes no encoder inputs.

Runs on the CUDA card unless ``--device cpu``; without a card it raises.
All randomness comes from ``torch.Generator`` s seeded from ``--seed``
(the reference draws from JAX keys, so the numbers differ).  The
reference's host mesh line is the device's name here: the trainer runs
on one device (``launch.mesh`` and ``sharding`` plan placements over
several; the model itself has no path over several devices yet).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.profiler import record_function

from repro_torch import configs, optim
from repro_torch.checkpoint import msgpack_ckpt
from repro_torch.core import diversity, scheduler, wireless
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def synthetic_lm_batch(gen: torch.Generator, batch: int, seq: int,
                       vocab: int, num_clients: int = 0
                       ) -> Dict[str, Tensor]:
    """Markov-ish token stream on ``gen``'s device: uniform tokens, half
    the positions continuing ``t+1 = (7 t + 3) mod vocab``.  With
    ``num_clients`` the (batch, seq) inputs and labels are split into
    (num_clients, batch / num_clients, seq) client shards."""
    dev = gen.device
    base = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                         device=dev)
    cont = (base[:, :-1] * 7 + 3) % vocab
    use = torch.rand(cont.shape, generator=gen, device=dev) < 0.5
    tokens = torch.cat([base[:, :1], torch.where(use, cont, base[:, 1:])],
                       dim=1)
    out = {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}
    if num_clients:
        out = {k: v.reshape(num_clients, batch // num_clients, seq)
               for k, v in out.items()}
    return out


@dataclasses.dataclass
class Clients:
    """The federated clients' world: their network, data sizes, label
    histograms and ages, and the DAS configuration of the reference's
    driver.  :meth:`admit` schedules one step and updates the ages."""

    net: wireless.NetworkState
    sizes: Tensor           # (K,) int
    hists: Tensor           # (K, 10) f32 label histograms
    ages: Tensor            # (K,) int32
    wcfg: wireless.WirelessConfig
    scfg: scheduler.SchedulerConfig

    @classmethod
    def sample(cls, gen: torch.Generator, num_clients: int) -> "Clients":
        """Placement, sizes in [50, 1500) and histograms in [0, 30) from
        ``gen``, on its device; ages 0."""
        dev = gen.device
        wcfg = wireless.WirelessConfig()
        net = wireless.sample_network(gen, num_clients, wcfg, device=dev)
        sizes = torch.randint(50, 1500, (num_clients,), generator=gen,
                              device=dev)
        hists = torch.randint(0, 30, (num_clients, 10), generator=gen,
                              device=dev).to(torch.float32)
        return cls(net, sizes, hists,
                   torch.zeros(num_clients, dtype=torch.int32, device=dev),
                   wcfg, scheduler.SchedulerConfig(method="das", n_min=2,
                                                   iterations_max=4))

    @property
    def num_clients(self) -> int:
        return self.sizes.shape[0]

    def admit(self, gen: torch.Generator, batch: Dict[str, Tensor]
              ) -> Dict[str, Tensor]:
        """One step's schedule: the diversity index, a fading draw from
        ``gen``, DAS, the age update; ``batch`` with ``selected`` and
        ``sizes`` added."""
        idx = diversity.diversity_index(label_hists=self.hists,
                                        data_sizes=self.sizes,
                                        ages=self.ages)
        gains = wireless.sample_fading(gen, self.net)
        res = scheduler.schedule(gen, idx, self.ages, self.sizes, gains,
                                 self.net, self.wcfg, self.scfg)
        self.ages = torch.where(res.selected > 0, 0, self.ages + 1
                                ).to(torch.int32)
        return dict(batch, selected=res.selected,
                    sizes=self.sizes.to(torch.float32))


def driver_batch(gen: torch.Generator, batch: int, seq: int, vocab: int,
                 clients: Optional[Clients] = None) -> Dict[str, Tensor]:
    """One step's input, as the driver's loop makes it: a synthetic batch
    (``train/batch``), client-sharded and scheduled by ``clients``
    (``train/schedule``) when training federated."""
    with record_function("train/batch"):
        k = 0 if clients is None else clients.num_clients
        out = synthetic_lm_batch(gen, batch, seq, vocab, k)
    if clients is None:
        return out
    with record_function("train/schedule"):
        return clients.admit(gen, out)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="train the configuration's first N layers at "
                         "its widths, where its full depth does not fit "
                         "the card (0: the configuration's depth)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--federated", type=int, default=0,
                    help="number of FEEL clients (0 = plain training)")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-path",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_ckpt.msgpack"))
    ap.add_argument("--clients-per-pass", type=int, default=0,
                    help="federated clients whose forward and backward "
                         "share one pass (0: as many as hold "
                         f"{steps_lib.PASS_TOKENS} tokens)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.federated:
        # the global batch must split evenly into client shards
        args.batch = max(args.batch, args.federated)
        args.batch -= args.batch % args.federated
    return args


@dataclasses.dataclass
class Run:
    """What the driver's loop runs: the step, its state and inputs."""

    dev: torch.device
    cfg: ModelConfig
    ocfg: optim.OptimizerConfig
    gen: torch.Generator
    state: Dict[str, Any]
    step: Callable
    clients: Optional[Clients]


def setup(args: argparse.Namespace) -> Run:
    """The model, optimizer, train state, step and (with ``--federated``)
    the clients that ``main`` drives."""
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    ocfg = optim.OptimizerConfig(learning_rate=args.lr, warmup_steps=10)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = steps_lib.init_train_state(gen, cfg, ocfg)
    clients = None
    if args.federated:
        step = steps_lib.make_federated_train_step(
            cfg, ocfg, num_clients=args.federated,
            clients_per_pass=args.clients_per_pass or None)
        clients = Clients.sample(
            torch.Generator(device=dev).manual_seed(args.seed + 1),
            args.federated)
    else:
        step = steps_lib.make_train_step(cfg, ocfg)
    return Run(dev, cfg, ocfg, gen, state, step, clients)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Tensor]:
    """Run the CLI; returns the last step's metrics (device tensors)."""
    args = parse_args(argv)
    run = setup(args)
    cfg, gen, state, step, clients = (run.cfg, run.gen, run.state, run.step,
                                      run.clients)
    name = (torch.cuda.get_device_name(run.dev) if run.dev.type == "cuda"
            else "cpu")
    print(f"[train] {cfg.name} reduced={args.reduced} device={name}")

    t0 = time.time()
    metrics: Dict[str, Tensor] = {}
    for i in range(args.steps):
        batch = driver_batch(gen, args.batch, args.seq, cfg.vocab_size,
                             clients)
        state, metrics = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            ce = float(metrics["ce"])
            extra = (f" sel={int(metrics['n_selected'])}"
                     if clients is not None else "")
            print(f"[train] step {i:4d} ce={ce:.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step){extra}",
                  flush=True)
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            msgpack_ckpt.save(args.ckpt_path, state["params"],
                              meta={"step": i + 1, "arch": cfg.name})
            print(f"[train] checkpoint -> {args.ckpt_path}")
    if metrics:
        print(f"[train] done: final ce={float(metrics['ce']):.4f}")
    return metrics


if __name__ == "__main__":
    main()
