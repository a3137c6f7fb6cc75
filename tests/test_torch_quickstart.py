"""The port's quickstart (``examples/quickstart_torch.py``) on the CPU.

Its diversity index is held against the reference's on the same
numpy-seeded data through ``repro.core.diversity`` (as
``examples/quickstart.py`` computes it) within 1e-6.  The DAS decision
and the three rounds draw their network and fading from torch
generators where the reference draws from JAX keys, so they are not
compared here; the driver parity tests hold ``run_federated`` and
``scheduler.schedule`` against the reference on replayed draws.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import diversity as jdiv  # noqa: E402
from repro.data import partition as jpartition  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
INDEX_TOL = 1e-6


def _reference_index() -> np.ndarray:
    imgs, labels = jsynthetic.generate(0, samples_per_class=600)
    data = jpartition.partition(
        imgs, labels, seed=1,
        spec=jpartition.PartitionSpec(num_devices=16, num_shards=100,
                                      shard_size=50))
    hists = jax.vmap(lambda l, m: jdiv.label_histogram(l, m, 10))(
        data.labels, data.mask)
    return np.asarray(jdiv.diversity_index(
        label_hists=hists, data_sizes=data.sizes,
        ages=jnp.zeros((16,), jnp.int32)))


@pytest.fixture(scope="module")
def cpu_run():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)


def test_quickstart_index_matches_the_reference(cpu_run):
    assert cpu_run.returncode == 0, cpu_run.stderr[-2000:]
    lines = cpu_run.stdout.splitlines()
    index = [float(v) for v in lines[0].split(":", 1)[1].split()]
    np.testing.assert_allclose(index, _reference_index(), rtol=0,
                               atol=INDEX_TOL)


def test_quickstart_schedules_and_trains(cpu_run):
    """One DAS decision of at least n_min = 2 of the 16 devices, then
    three rounds with finite accuracy."""
    lines = cpu_run.stdout.splitlines()
    assert lines[1].startswith("selected ")
    assert 2 <= int(lines[1].split()[1].split("/")[0]) <= 16
    rounds = [ln for ln in lines if ln.startswith("round ")]
    assert len(rounds) == 3
    for ln in rounds:
        assert 0.0 <= float(ln.split("acc=")[1].split()[0]) <= 1.0


def test_quickstart_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "examples", "quickstart_torch.py")
    got = subprocess.run(
        [sys.executable, script], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert got.returncode != 0
    assert "no CUDA device is available" in got.stderr
