"""The port's legacy per-round loop on the card.

Needs a CUDA device and skips without one.  This file imports no JAX, so
it runs where only the port's dependencies are installed: the loop at
K = 16 on the card against its CPU run from one tape
(``tests/test_torch_loop.py`` holds it against the reference on the
CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bandwidth, faults, federated  # noqa: E402
from repro_torch.core import scheduler, streaming, wireless  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.kernels import fedavg_agg  # noqa: E402
from repro_torch.models import paper_nets  # noqa: E402


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: this test runs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_loop_card_matches_cpu_on_card(cuda_device, no_tf32):
    """K = 16, the CNN, streaming and faults with a binding cap of 4 and
    the bf16 carry, 2 rounds, one tape, TF32 off: the card's loop
    launches the masked FedAvg kernel once a round and agrees with the
    CPU's (equal selections, DAS iterations, delivered and dropped
    counts; parameters within 5e-3, the batch paths' card-vs-CPU limit,
    ``chip_smoke.py``'s ``BATCH_CARD_CPU_PARAM_TOL``)."""
    imgs, labels = synthetic.generate(0, samples_per_class=600)
    data = partition.partition(imgs, labels, seed=1,
                               spec=partition.PartitionSpec(
                                   num_devices=16, num_shards=100,
                                   shard_size=50))
    gen = torch.Generator().manual_seed(2)
    net = wireless.sample_network(gen, 16, wireless.WirelessConfig())
    model = paper_nets.init(paper_nets.PaperNetSpec(kind="cnn"),
                            torch.Generator().manual_seed(3))
    fcfg = federated.FLConfig(
        num_rounds=2, learning_rate=0.05, use_kernel_agg=True,
        stream=streaming.StreamConfig(),
        faults=faults.FaultConfig(drop_prob=0.1, max_retries=2),
        dispatch_cap=4, carry_dtype="bfloat16")
    draws = federated.draw_tape(
        gen, net, 2, data.capacity,
        federated._max_local_steps(fcfg, data.capacity), 50, fcfg,
        federated.client_histograms(data, 10))
    kw = dict(model=model, data=data, net=net,
              wcfg=wireless.WirelessConfig(),
              scfg=scheduler.SchedulerConfig(
                  allocator="fused_pgd", sub2=bandwidth.Sub2Params.fast()),
              fcfg=fcfg, draws=draws)
    before = fedavg_agg.fedavg_agg_masked.launches
    pg, rg = federated.run_federated_loop(device=cuda_device, **kw)
    assert fedavg_agg.fedavg_agg_masked.launches == before + 2
    pc, rc = federated.run_federated_loop(device="cpu", **kw)
    assert sum(r.n_dropped for r in rg) > 0
    for a, b in zip(rg, rc):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert (a.iterations, a.n_success, a.n_dropped) == \
            (b.iterations, b.n_success, b.n_dropped)
    for n in pc:
        torch.testing.assert_close(pg[n].cpu(), pc[n], rtol=0, atol=5e-3)
