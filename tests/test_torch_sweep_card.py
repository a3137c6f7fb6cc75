"""The port's sweep and checkpoint on the card.

Both tests need a CUDA device and skip without one.  This file imports
neither JAX nor msgpack, so it runs where only the port's dependencies
are installed: a sweep killed after one chunk and resumed gives an
uninterrupted run's summaries bit for bit under deterministic
algorithms (K = 16, the CNN), and a checkpoint of card tensors (bf16
included) restores onto the card equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import msgpack_ckpt  # noqa: E402
from repro_torch.core import bandwidth, federated, scheduler  # noqa: E402
from repro_torch.core import wireless  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.models import paper_nets  # noqa: E402
from repro_torch.sweep import engine, grid, runner  # noqa: E402
from repro_torch.telemetry import sinks  # noqa: E402


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sweep's kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """Deterministic algorithms (cuDNN's deterministic convolutions) for
    the test, restored after it."""
    cudnn = torch.backends.cudnn
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             cudnn.deterministic, cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    cudnn.deterministic, cudnn.benchmark = True, False
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    cudnn.deterministic, cudnn.benchmark = saved[2], saved[3]


def test_sweep_kill_resume_on_card(cuda_device, deterministic, tmp_path):
    imgs, labels = synthetic.generate(0, samples_per_class=1000)
    data = partition.partition(imgs, labels, seed=1,
                               spec=partition.PartitionSpec(
                                   num_devices=16, num_shards=200,
                                   shard_size=50))
    model = paper_nets.init(paper_nets.PaperNetSpec(kind="cnn"),
                            torch.Generator().manual_seed(3))
    spec = grid.SweepSpec(
        fl=federated.FLConfig(num_rounds=2, learning_rate=0.05,
                              use_kernel_agg=True),
        sched=scheduler.SchedulerConfig(method="das", n_min=1,
                                        iterations_max=4,
                                        allocator="fused_pgd",
                                        sub2=bandwidth.Sub2Params.fast()),
        wireless=wireless.WirelessConfig(),
        axes=(grid.Axis("sched", "method", ("das", "random")),),
        scenarios_per_point=4, chunk_scenarios=2, base_seed=5)

    def make(name):
        eng = engine.SweepEngine(spec, model=model, data=data,
                                 device=cuda_device)
        return runner.SweepRunner(eng, str(tmp_path / f"{name}.msgpack"),
                                  jsonl_path=str(tmp_path / f"{name}.jsonl"))

    full = make("full").run()
    assert make("kill").run(max_chunks=1) is None
    resumed = make("kill").run()
    for (p, a), (q, b) in zip(full, resumed):
        assert p.name == q.name
        for metric in a:
            for field in a[metric]:
                np.testing.assert_array_equal(
                    a[metric][field], b[metric][field],
                    err_msg=f"{p.name}/{metric}/{field}")
        assert float(a["scalar.final_accuracy"]["count"]) == 4
        assert np.all(np.isfinite(a["round.accuracy"]["mean"]))
    rows = sinks.read_jsonl(str(tmp_path / "kill.jsonl"))
    assert [r["cursor"] for r in rows] == [1, 2, 3, 4]
    # The chunk size moves no selection (scheduling never reads the
    # model); accuracy only within the vmapped CNN's batch-shape noise.
    one = runner.SweepRunner(engine.SweepEngine(
        dataclasses.replace(spec, chunk_scenarios=4), model=model,
        data=data, device=cuda_device), None).run()
    for (_, a), (_, b) in zip(full, one):
        for n in ("round.n_selected", "round.n_success"):
            np.testing.assert_array_equal(a[n]["mean"], b[n]["mean"])
        np.testing.assert_allclose(a["round.accuracy"]["mean"],
                                   b["round.accuracy"]["mean"], atol=5e-3)


def test_checkpoint_of_card_tensors_restores_on_card(cuda_device,
                                                     tmp_path):
    """Leaves on the card (bf16 included) are written from one host copy
    each and restored onto the card equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    tree = {"w": torch.randn((64, 33), generator=gen, device=cuda_device),
            "h": torch.randn((5, 7), generator=gen, device=cuda_device
                             ).to(torch.bfloat16),
            "n": {"i": torch.arange(9, device=cuda_device,
                                    dtype=torch.int32)}}
    path = str(tmp_path / "card.msgpack")
    msgpack_ckpt.save(path, tree, meta={"on": "card"})
    flat, meta = msgpack_ckpt.load_flat(path)
    assert meta == {"on": "card"} and flat["h"].dtype == torch.bfloat16
    got = msgpack_ckpt.restore(path, tree, device=cuda_device)
    for have, want in ((got["w"], tree["w"]), (got["h"], tree["h"]),
                       (got["n"]["i"], tree["n"]["i"])):
        assert have.device.type == "cuda" and have.dtype == want.dtype
        assert torch.equal(have, want)
