"""The port's checkpoint format against the JAX reference's.

``repro_torch.checkpoint._msgpack`` against the ``msgpack`` package
(byte for byte), and ``repro_torch.checkpoint.msgpack_ckpt`` against
``repro.checkpoint.msgpack_ckpt`` in both directions: each reads the
other's files, and both write the same bytes for the same tree.  The
card's case is in ``test_torch_sweep_card.py``, which imports no JAX.
"""

import ast
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import msgpack_ckpt as jckpt  # noqa: E402
from repro_torch.checkpoint import _msgpack  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as tckpt  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")


@pytest.fixture(autouse=True)
def one_thread():
    """Small tensors: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed=0):
    """The reference's round-trip case (tests/test_sweep.py) plus a
    0-d leaf, a list and an empty leaf."""
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((2, 3)).astype(np.float32),
        "f64": np.linspace(0, 1, 4),
        "i32": np.asarray([-1, 2], np.int32),
        "u8": np.asarray([[255, 0]], np.uint8),
        "bool": np.asarray([True, False]),
        "nested": {"leaf": np.asarray(3.5, np.float32),
                   "list": [np.arange(3, dtype=np.int64),
                            np.zeros((0, 2), np.float32)]},
    }


META = {"cursor": 3, "fingerprint": "abc", "nested": {"k": [1, 2]},
        "target_accuracy": 0.85, "names": {"0": "method=das"},
        "neg": -70000, "none": None, "flag": True}


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

EDGE_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -0.0, 1.5, 0.85, math.inf, -math.inf, 1e300,
    5e-324, "", "a" * 31, "a" * 32, "é" * 200, "x" * 70000, b"",
    b"x" * 255, b"x" * 256, b"y" * 70000, list(range(15)),
    list(range(16)), list(range(70000)), (1, "two", 3.0),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {str(i): i for i in range(70000)}, META,
]


@pytest.mark.parametrize("value", EDGE_VALUES,
                         ids=[f"v{i}" for i in range(len(EDGE_VALUES))])
def test_packb_is_msgpacks_bytes_and_round_trips(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    got = _msgpack.unpackb(want)
    assert got == msgpack.unpackb(want, raw=False, strict_map_key=False)


def test_packb_writes_the_reference_checkpoint_bytes(tmp_path):
    """The reference's whole file, decoded by msgpack and encoded by the
    port's codec, is the same bytes: every type and width the format
    uses, maps in the reference's order."""
    path = str(tmp_path / "ref.msgpack")
    tree = dict(_tree(), bf16=np.asarray([1.5, -2.25], ml_dtypes.bfloat16))
    jckpt.save(path, tree, meta=META)
    raw = open(path, "rb").read()
    assert _msgpack.packb(msgpack.unpackb(raw, raw=False)) == raw
    assert _msgpack.unpackb(raw) == msgpack.unpackb(raw, raw=False)


@pytest.mark.parametrize("data,what", [
    (b"", "truncated"), (b"\x92\x01", "truncated"),
    (b"\xdb\x00\x00\x00\x05ab", "truncated"), (b"\x01\x02", "extra data"),
    (b"\xc1", "unsupported"), (b"\xd4\x00\x00", "unsupported")])
def test_unpackb_refuses_damaged_data(data, what):
    with pytest.raises(ValueError, match=what):
        _msgpack.unpackb(data)


def test_packb_refuses_other_types():
    with pytest.raises(TypeError, match="float32"):
        _msgpack.packb({"x": np.float32(1.0)})


@pytest.mark.parametrize("package", ["checkpoint", "sweep"])
def test_modules_import_no_jax_repro_or_msgpack(package):
    """The port's checkpoint and sweep import neither the reference, nor
    JAX, nor the msgpack package."""
    folder = os.path.join(SRC, package)
    names = [n for n in os.listdir(folder) if n.endswith(".py")]
    assert names
    for name in names:
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "msgpack",
                                   "ml_dtypes"), (name, mod)


# ---------------------------------------------------------------------------
# The file format, both ways
# ---------------------------------------------------------------------------

def _flat_np(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat_np(v, path))
        elif isinstance(v, list):
            for i, x in enumerate(v):
                out[f"{path}[{i}]"] = x
        else:
            out[path] = v
    return out


def test_port_and_reference_write_the_same_file(tmp_path):
    """The same tree (numpy leaves on one side, torch tensors on the
    other, a bf16 leaf as an ml_dtypes array against a bf16 tensor) and
    meta: the two files are the same bytes."""
    tree = _tree()
    bf = np.asarray([1.5, -2.25, 3.0e-3], np.float32)
    jtree = dict(tree, bf16=bf.astype(ml_dtypes.bfloat16))
    ttree = {k: v for k, v in tree.items() if k != "nested"}
    ttree = {k: torch.from_numpy(v) for k, v in ttree.items()}
    ttree["nested"] = {"leaf": torch.tensor(3.5),
                       "list": [torch.from_numpy(x)
                                for x in tree["nested"]["list"]]}
    ttree["bf16"] = torch.from_numpy(bf).to(torch.bfloat16)
    jp, tp = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save(jp, jtree, meta=META)
    tckpt.save(tp, ttree, meta=META)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    tckpt.save(tp, jtree | {"bf16": ttree["bf16"]}, meta=META)
    assert open(jp, "rb").read() == open(tp, "rb").read()


def test_reference_reads_a_port_file(tmp_path):
    path = str(tmp_path / "port.msgpack")
    tree = _tree()
    bf = torch.tensor([1.5, -2.25, 7.0]).to(torch.bfloat16)
    tckpt.save(path, dict(tree, bf16=bf), meta=META)
    flat, meta = jckpt.load_flat(path)
    assert meta == META
    for key, want in _flat_np(tree).items():
        assert flat[key].dtype == want.dtype, key
        assert flat[key].shape == want.shape, key
        np.testing.assert_array_equal(flat[key], want)
    assert str(flat["bf16"].dtype) == "bfloat16"
    np.testing.assert_array_equal(flat["bf16"].astype(np.float32),
                                  bf.to(torch.float32).numpy())


def test_port_reads_a_reference_file(tmp_path):
    path = str(tmp_path / "ref.msgpack")
    tree = _tree()
    bf = np.asarray([1.5, -2.25, 7.0], np.float32)
    jckpt.save(path, dict(tree, bf16=bf.astype(ml_dtypes.bfloat16)),
               meta=META)
    flat, meta = tckpt.load_flat(path)
    assert meta == META
    for key, want in _flat_np(tree).items():
        got = flat[key]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.numpy().dtype == want.dtype, key
        assert tuple(got.shape) == want.shape, key
        np.testing.assert_array_equal(got.numpy(), want)
    assert flat["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(flat["bf16"].to(torch.float32).numpy(),
                                  bf)


def test_legacy_newer_and_damaged_files(tmp_path):
    legacy = str(tmp_path / "v0.msgpack")
    x = np.arange(3, dtype=np.float32)
    with open(legacy, "wb") as f:     # before the versioned header
        f.write(msgpack.packb({"leaves": {"x": {
            "dtype": "float32", "shape": [3], "data": x.tobytes()}}},
            use_bin_type=True))
    flat, meta = tckpt.load_flat(legacy)
    assert meta == {} and torch.equal(flat["x"], torch.from_numpy(x))

    newer = str(tmp_path / "v2.msgpack")
    with open(newer, "wb") as f:
        f.write(msgpack.packb({"__version__": tckpt.FORMAT_VERSION + 1,
                               "__meta__": {}, "leaves": {}},
                              use_bin_type=True))
    with pytest.raises(ValueError, match="newer"):
        tckpt.load_flat(newer)

    good = str(tmp_path / "good.msgpack")
    tckpt.save(good, {"x": x, "y": np.ones((4, 4))}, meta=META)
    raw = open(good, "rb").read()
    for name, data in (("cut", raw[:-7]), ("tail", raw + b"\x00"),
                       ("noise", b"\xc1" + raw[1:]),
                       ("not a container", msgpack.packb([1, 2]))):
        bad = str(tmp_path / f"{name}.msgpack")
        with open(bad, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match="corrupt or truncated"):
            tckpt.load_flat(bad)
        with pytest.raises(ValueError):
            jckpt.load_flat(bad)
    assert not os.path.exists(good + ".tmp")


def test_restore_checks_shapes_and_places_leaves(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32)}}
    tckpt.save(path, tree)
    got = tckpt.restore(path, tree, device="cpu")
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    like = {"a": np.zeros((3, 2)), "b": {"c": np.zeros(2)}}
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(path, like, device="cpu")
    # The reference restores the port's file into its own structure.
    ref = jckpt.restore(path, {"a": jnp.zeros((2, 3)),
                               "b": {"c": jnp.zeros(2)}})
    np.testing.assert_array_equal(np.asarray(ref["a"]), tree["a"].numpy())


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.msgpack")
    tckpt.save(path, {"a": np.zeros(2, np.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tckpt.restore(path, {"a": np.zeros(2)})
