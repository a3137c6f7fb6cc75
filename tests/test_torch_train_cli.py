"""The port's training CLI, ``python -m repro_torch.launch.train``, on
the CPU.

Its own file: 30 federated steps with DAS each step are most of a
minute, and a file runs on one test worker.  The run must learn the
synthetic bigram stream, print the reference driver's lines and write
checkpoints the reference's ``load_flat`` reads.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import msgpack_ckpt as jckpt  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as tckpt  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from test_torch_transformer import one_thread  # noqa: E402,F401

# The last printed ce at least this far below the first (the reference's
# step at lr 3e-3 on this size falls 0.36 in 30 steps).
CE_DROP = 0.1


def test_cli_learns_on_cpu(capsys, tmp_path):
    """``--device cpu --reduced --federated 4 --steps 30 --lr 3e-3``:
    the reference driver's output lines, 4 clients a step (n_min 2), the
    last ce at least 0.1 below the first; its checkpoint (every 15 steps)
    loads in the reference's ``load_flat`` with the port's leaves."""
    path = str(tmp_path / "ckpt.msgpack")
    metrics = ttrain.main(["--device", "cpu", "--reduced", "--federated",
                           "4", "--steps", "30", "--lr", "3e-3",
                           "--ckpt-every", "15", "--ckpt-path", path])
    out = capsys.readouterr().out
    assert "[train] xlstm-125m reduced=True device=cpu" in out
    ces = [float(x) for x in re.findall(r"\] step +\d+ ce=([0-9.]+)", out)]
    assert len(ces) == 4
    assert all(int(s) >= 2 for s in re.findall(r"sel=(\d+)", out))
    assert ces[-1] <= ces[0] - CE_DROP, ces
    assert float(metrics["ce"]) == pytest.approx(ces[-1], abs=1e-4)
    assert out.count("[train] checkpoint -> ") == 2
    flat, meta = jckpt.load_flat(path)
    assert meta == {"step": 30, "arch": "xlstm-125m"}
    assert flat.keys() == tckpt.load_flat(path)[0].keys()


def test_cli_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--reduced", "--steps", "1"])
