"""The federated train step and its FedAvg reduction on the card.

Both tests need a CUDA device and skip without one; the file imports no
JAX, so it runs where only the port's dependencies are installed
(``pytest tests/test_torch_train_card.py -k on_card``):

* the federated step of xlstm-125m at ``reduced(num_layers=4)`` (K = 3,
  clients 0 and 2 selected, sizes 100 / 999 / 300) from one set of
  weights and batches on the card and on the CPU, f32 with TF32 off:
  parameters within 1e-4, ``n_selected`` equal, one ``fedavg_agg``
  launch on the card;
* ``fedavg_agg`` at K = 8 and P = 2^28 + 4 (K * P past 2^31 elements,
  8.6 GB) against its plain version on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, optim  # noqa: E402
from repro_torch.kernels import fedavg_agg as fk  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = 1e-4
# K-term f32 sums of O(1) values in another order.
AGG_TOL = 1e-5


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fedavg_agg kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def test_federated_step_card_vs_cpu_on_card(cuda_device, no_tf32):
    cfg = configs.get("xlstm_125m").reduced(num_layers=4)
    ocfg = optim.OptimizerConfig(name="sgd", momentum=0.0, learning_rate=0.1,
                                 grad_clip=0.0, warmup_steps=0)
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(gen, cfg, ocfg)
    batch = {
        "inputs": torch.randint(0, cfg.vocab_size, (3, 2, 64), generator=gen),
        "labels": torch.randint(0, cfg.vocab_size, (3, 2, 64), generator=gen),
        "selected": torch.tensor([1.0, 0.0, 1.0]),
        "sizes": torch.tensor([100.0, 999.0, 300.0]),
    }
    out = {}
    before = fk.fedavg_agg.launches
    for dev in ("cpu", cuda_device):
        step = steps.make_federated_train_step(cfg, ocfg, num_clients=3)
        st = tree_map(lambda t: t.to(dev), state)
        new, metrics = step(st, {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (tree_map(lambda t: t.cpu(), new["params"]),
                         float(metrics["n_selected"]), float(metrics["ce"]))
    assert fk.fedavg_agg.launches == before + 1
    (p_cpu, n_cpu, ce_cpu), (p_gpu, n_gpu, ce_gpu) = out.values()
    assert n_cpu == n_gpu == 2.0
    assert abs(ce_cpu - ce_gpu) <= TOL * abs(ce_cpu)
    err = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu)))
    assert err <= TOL, err


def test_fedavg_agg_past_2_31_elements_on_card(cuda_device):
    k, p = 8, 2 ** 28 + 4
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    u = torch.randn((k, p), generator=gen, device=cuda_device)
    w = torch.softmax(torch.randn((k,), generator=gen, device=cuda_device),
                      0)
    got = fk.fedavg_agg(u, w)
    want = fk.fedavg_agg_plain(u, w)
    assert got.shape == (p,)
    assert float((got - want).abs().max()) <= AGG_TOL
    # The last columns live past 2^31 elements of the matrix.
    tail = (w[:, None] * u[:, -8:]).sum(0)
    assert float((got[-8:] - tail).abs().max()) <= AGG_TOL
