"""The port's telemetry sinks, store and CLIs against the reference's.

A small port run with telemetry on (K = 8, an MLP of 8, faults and
streaming, and an event run) writes its frames as JSONL through
``repro_torch.telemetry.sinks``; the reference's report CLI and the
port's render the same files, and their ``--json`` summaries must be
equal.  The regression gates (``compare``) of both read the same stores
and must give the same verdicts and exit codes (0 in band, 1 regressed,
2 schema drift).  The host-side helpers (``run_summary``, the JSONL
rewind, ``frames_to_host``) are held to the reference's on the same
inputs.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.telemetry import compare as jcompare  # noqa: E402
from repro.telemetry import report as jreport  # noqa: E402
from repro.telemetry import sinks as jsinks  # noqa: E402
from repro.telemetry import store as jstore  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core import streaming as tst  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.telemetry import compare as tcompare  # noqa: E402
from repro_torch.telemetry import report as treport  # noqa: E402
from repro_torch.telemetry import sinks as tsinks  # noqa: E402
from repro_torch.telemetry import store as tstore  # noqa: E402
from test_torch_events import _small_world as events_world  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True)
def one_thread():
    """The shapes here are tiny: one intra-op thread, so the test workers
    that share the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """JSONL logs the port wrote: a synchronous run (streaming, faults;
    records merged, manifest inline), an event run, and a batch's
    scenario 1 of 2, each from a run with telemetry on."""
    torch.set_num_threads(1)
    k = 8
    kw = events_world(k)
    net, wcfg, scfg = kw.pop("net"), kw["wcfg"], kw["scfg"]
    del kw["seed"]
    fcfg = tfed.FLConfig(num_rounds=3, batch_size=50, learning_rate=0.1,
                         stream=tst.StreamConfig(),
                         faults=tf.FaultConfig(drop_prob=0.3, max_retries=1,
                                               reliability_ema=0.3),
                         telemetry=telemetry.TelemetryConfig())
    nets = tw.sample_networks(torch.Generator().manual_seed(2), 2, k, wcfg)
    out = tmp_path_factory.mktemp("tel")
    paths = {}
    seeds = tfed.scenario_seeds(3, 0, 2)
    _, metrics, frames = tfed.run_federated_batch(
        nets=nets, seeds=seeds, fcfg=fcfg, **kw)
    paths["batch"] = str(out / "batch.jsonl")
    scenario = tfed.RoundMetrics(*(getattr(metrics, f.name)[1] for f in
                                   dataclasses.fields(metrics)))
    assert tsinks.write_round_frames(
        paths["batch"], {n: t[1] for n, t in frames.items()}, scenario,
        scenario=1) == 3
    _, _, frames = tfed.run_federated(net=net, fcfg=fcfg, seed=4, **kw)
    paths["sync"] = str(out / "sync.jsonl")
    tsinks.write_round_frames(paths["sync"], frames,
                              manifest=tsinks.run_manifest(scfg, fcfg))
    ev = dataclasses.replace(fcfg, stream=None, events=tev.EventConfig(
        availability="churn", buffer_size=2, tick_horizon=0.5,
        num_events=4))
    _, _, frames = tfed.run_federated(net=net, fcfg=ev, seed=4, **kw)
    paths["event"] = str(out / "event.jsonl")
    tsinks.write_round_frames(paths["event"], frames)
    return paths


def _main_out(main, argv, capsys):
    code = main(argv)
    return code, capsys.readouterr().out


@pytest.mark.parametrize("which", ["sync", "event", "batch", "all"])
def test_report_json_equals_the_references(logs, which, capsys):
    files = [logs[n] for n in ("sync", "event", "batch")] \
        if which == "all" else [logs[which]]
    code_j, want = _main_out(jreport.main, files + ["--json"], capsys)
    code_t, got = _main_out(treport.main, files + ["--json"], capsys)
    assert code_j == code_t == 0
    assert json.loads(got) == json.loads(want)
    # The reference's text report reads the port's file too.
    code_j, text = _main_out(jreport.main, files, capsys)
    assert code_j == 0 and "== Round table ==" in text
    code_t, text = _main_out(treport.main, files, capsys)
    assert code_t == 0 and "== Fairness (end of run) ==" in text


def test_port_lines_hold_every_frame_leaf(logs):
    recs = tsinks.read_jsonl(logs["sync"])
    assert recs[0]["type"] == "manifest"
    man = recs[0]
    for key in ("config_fingerprint", "configs", "jax_version",
                "jaxlib_version", "xla_flags", "device_count",
                "device_platform", "backend", "git_sha"):
        assert key in man
    assert man["backend"] == "torch" and man["torch_version"]
    rounds = recs[1:]
    assert [r["round"] for r in rounds] == [0, 1, 2]
    assert len(rounds[0]["admitted"]) == 8
    assert isinstance(rounds[0]["sub2_iters"], int)
    assert {"fault_outage", "staleness", "sig_loss_delta",
            "jain_energy"} <= set(rounds[0])
    event = tsinks.read_jsonl(logs["event"])
    assert {"avail", "clock", "model_version"} <= set(event[0])
    batch = tsinks.read_jsonl(logs["batch"])
    assert all(r["scenario"] == 1 for r in batch)
    assert {"accuracy", "n_selected", "round_time"} <= set(batch[0])


def test_report_exit_codes(logs, tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    missing = str(tmp_path / "missing.jsonl")
    for main in (jreport.main, treport.main):
        assert main([str(empty)]) == 1
        assert main([missing]) == 2
    capsys.readouterr()


def _stores(tmp_path):
    """A baseline store and current stores in band, regressed and
    drifted, from one run summary the port computed."""
    rng = np.random.default_rng(0)
    acc = np.array([0.5, np.nan, 0.86, 0.9])
    sel = (rng.random((4, 6)) < 0.5).astype(np.float32)
    eng = rng.random((4, 6)).astype(np.float32) * sel
    metrics = tstore.run_summary(accuracy=acc, selected=sel, energy=eng,
                                 timings={"steady_s_per_round": 0.2})
    assert metrics == jstore.run_summary(accuracy=acc, selected=sel,
                                         energy=eng,
                                         timings={"steady_s_per_round": 0.2})
    paths = {}
    for name, change in (("base", {}), ("ok", {"final_acc": 0.88}),
                         ("regressed", {"final_acc": 0.7}),
                         ("drifted", {"jain_energy": None})):
        m = dict(metrics, **change)
        if name == "drifted":
            del m["jain_energy"]
        path = str(tmp_path / f"{name}.jsonl")
        tstore.append_run(path, m, run="smoke")
        paths[name] = path
    return paths


@pytest.mark.parametrize("case,code", [("ok", 0), ("regressed", 1),
                                       ("drifted", 2)])
def test_compare_verdicts_equal_the_references(tmp_path, case, code,
                                               capsys):
    paths = _stores(tmp_path)
    argv = [paths["base"], paths[case], "--run", "smoke", "--json"]
    code_j, want = _main_out(jcompare.main, argv, capsys)
    code_t, got = _main_out(tcompare.main, argv, capsys)
    assert code_j == code_t == code
    if code != 2:
        assert json.loads(got) == json.loads(want)
        code_t, table = _main_out(tcompare.main, argv[:-1], capsys)
        assert table.splitlines()[-1] == (
            "verdict: OK" if code == 0
            else "verdict: REGRESSED (1 metric(s) out of band)")
    assert tcompare.main([paths["base"], str(tmp_path / "none")]) == 2
    capsys.readouterr()


def test_clis_run_as_modules(logs, tmp_path):
    """``python -m repro_torch.telemetry.report`` and ``.compare``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry."
                          "report", logs["sync"]], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "== Run summary ==" in out.stdout and "torch" in out.stdout
    paths = _stores(tmp_path)
    out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry."
                          "compare", paths["base"], paths["regressed"]],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 1, out.stderr


def test_rewind_and_append_equal_the_references(tmp_path):
    lines = [{"cursor": 1, "x": 1.5}, {"cursor": 2, "x": float("nan")},
             {"cursor": 3, "x": [1, 2]}]
    files = []
    for sinks in (jsinks, tsinks):
        path = str(tmp_path / f"{sinks.__name__}.jsonl")
        for rec in lines:
            sinks.jsonl_append(path, rec)
        with open(path, "a") as f:
            f.write('{"cursor": 4, "torn')
        sinks.jsonl_rewind(path, 2)
        with open(path) as f:
            files.append(f.read())
    assert files[0] == files[1]
    assert tsinks.read_jsonl(str(tmp_path / f"{tsinks.__name__}.jsonl")) \
        == [{"cursor": 1, "x": 1.5}, {"cursor": 2, "x": None}]


def test_frames_to_host_keeps_dtypes_and_values():
    frames = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
              "b": torch.rand(2), "c": torch.ones(2, 3)}
    host = tsinks.frames_to_host(frames)
    for n, t in frames.items():
        assert host[n].dtype == t.numpy().dtype
        np.testing.assert_array_equal(host[n], t.numpy())
    assert tsinks.frames_to_host({"x": np.zeros(3)})["x"].shape == (3,)
