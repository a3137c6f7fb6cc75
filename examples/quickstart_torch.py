"""Quickstart of the PyTorch + CUDA port: the DAS scheduler + three
federated rounds in ~30 lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``.  Runs on the CUDA
card unless ``--device cpu``; without a card it raises.
"""

import argparse

import torch

from repro_torch.core import diversity, federated, scheduler, wireless
from repro_torch.data import partition, synthetic
from repro_torch.device import resolve_device
from repro_torch.models import paper_nets

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
dev = resolve_device(ap.parse_args().device)

# 1. A wireless edge cell with 16 devices holding non-IID shard data.
wcfg = wireless.WirelessConfig()
net = wireless.sample_network(torch.Generator().manual_seed(0), 16, wcfg)
imgs, labels = synthetic.generate(0, samples_per_class=600)
data = partition.partition(
    imgs, labels, seed=1,
    spec=partition.PartitionSpec(num_devices=16, num_shards=100,
                                 shard_size=50)).to(dev)

# 2. On-device statistics -> the paper's diversity index (Eq. 4).
hists = diversity.label_histogram(data.labels, data.mask, 10)
ages = torch.zeros(16, dtype=torch.int32, device=dev)
index = diversity.diversity_index(label_hists=hists, data_sizes=data.sizes,
                                  ages=ages)
print("diversity index:", " ".join(f"{v:.8f}" for v in index.tolist()))

# 3. One DAS decision: joint selection + bandwidth allocation (Alg. 2).
gains = wireless.sample_fading(torch.Generator().manual_seed(2), net).to(dev)
sch = scheduler.SchedulerConfig(method="das", n_min=2)
res = scheduler.schedule(None, index, ages, data.sizes, gains, net.to(dev),
                         wcfg, sch)
print(f"selected {int(res.selected.sum())}/16 devices, "
      f"round time {float(res.round_time):.3f}s, "
      f"total energy {float(res.energy.sum()):.3f}J")

# 4. Three federated rounds (Alg. 1) on the paper's MLP.
mspec = paper_nets.PaperNetSpec(kind="mlp")
model = paper_nets.init(mspec, torch.Generator().manual_seed(4))
_, hist = federated.run_federated(
    model=model, data=data, net=net, wcfg=wcfg, scfg=sch,
    fcfg=federated.FLConfig(num_rounds=3, learning_rate=0.1), seed=5,
    device=dev)
for r in hist:
    print(f"round {r.round}: acc={r.accuracy:.3f} "
          f"selected={r.n_selected} energy/dev={r.energy_per_device:.3f}J")
