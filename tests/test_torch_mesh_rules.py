"""The port's constraints by logical names against the reference's.

``sharding.rules.constrain_spec`` (the spec ``constrain`` lays a tensor
out by), ``constrain_pad``'s spec (``named``), ``residual_constrain``'s
and ``named`` itself, with no process group, against the reference's
``constrain``, ``constrain_pad``, ``residual_constrain`` and ``named``
on 2x2, 1x4 and 4x1 ``(data, model)`` meshes.  The reference runs in one
subprocess with 4 forced host devices and ``AxisType.Auto`` axes; each
constraint's output ``sharding.spec`` is read under ``jax.jit`` (where
``constrain_pad`` pads a dim that does not divide, XLA returns the array
in a layout of its own, and the spec constrained to is ``named``'s; an
axis of size 1, which splits nothing, XLA's output spec leaves out).  The grid holds dims that divide and dims
that do not, a batch of 1, 40 and 12 heads, a vocabulary of 51,865, KV
heads that do not split, and the residual stream with sequence sharding
on and off.  Without a mesh each constraint returns the very tensor it
was given.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
MESHES = ((2, 2), (1, 4), (4, 1))
# (shape, logical names): constrain, constrain_pad and named.
GRID = [
    ((4, 8, 16), ("batch", None, "tensor")),
    ((1, 8, 16), ("batch", None, "tensor")),
    ((3, 6, 51865), ("batch", None, "tensor")),
    ((2, 8, 40, 64), ("batch", None, "tensor", None)),
    ((2, 8, 12, 64), ("batch", None, "tensor", None)),
    ((4, 1, 12, 64), ("batch", None, "tensor", None)),
    ((2, 2, 16, 8, 64), (None, "batch", None, "tensor", None)),
    ((2, 2, 16, 3, 64), (None, "batch", None, None, "tensor")),
    ((2, 2, 16, 3, 60), (None, "batch", None, None, "tensor")),
    ((256, 1024), ("fsdp", "tensor")),
    ((8, 256, 512), ("expert", "fsdp", None)),
    ((6, 256, 512), ("expert", "fsdp", None)),
    ((1, 4096, 8), (None, "cache_seq", "tensor")),
    ((1, 4098, 8), (None, "cache_seq", "tensor")),
    ((2, 8, 16), ("batch", "seq", None)),
    ((2, 7, 16), ("batch", "seq", None)),
    ((2, 8, 16), (None, None, None)),
]
# (shape, seq_shard): residual_constrain.
RESIDUAL = [((4, 8, 16), True), ((4, 8, 16), False), ((1, 8, 16), True),
            ((2, 6, 16), True), ((3, 1, 16), True), ((2, 1, 16), False)]
FUNCTIONS = ("constrain", "constrain_pad", "residual_constrain", "named")

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    jax.devices()              # the backend holds 4 devices from here on
    from jax.sharding import AxisType
    from repro.sharding import rules

    grid, residual = json.loads(sys.argv[1]), json.loads(sys.argv[2])

    def entries(spec, ndim):
        return [e if e is None or isinstance(e, str) else list(e)
                for e in tuple(spec) + (None,) * (ndim - len(spec))]

    def padded(s, spec, mesh):
        def size(e):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            return int(np.prod([mesh.shape[a] for a in axes]))
        return any(d % size(e) for d, e in zip(s, spec))

    def laid_out(fn, s, mesh, *args):
        # The output's spec.  Where constrain_pad pads a dim that does not
        # divide, XLA returns the array in a layout of its own (whole, or
        # 2 rows on 2 of 4 devices): the spec constrained to is named()'s.
        sh = jax.jit(lambda x: fn(x, mesh, *args))(jnp.zeros(s)).sharding
        want = rules.named(mesh, *args).spec
        if fn is rules.constrain_pad and padded(s, want, mesh):
            return entries(want, len(s))
        return entries(sh.spec, len(s))

    out = {}
    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        key = f"{shape[0]}x{shape[1]}"
        for name in ("constrain", "constrain_pad"):
            out[f"{key}/{name}"] = [laid_out(getattr(rules, name), s, mesh,
                                             *names) for s, names in grid]
        out[f"{key}/named"] = [entries(rules.named(mesh, *names).spec,
                                       len(s)) for s, names in grid]
        out[f"{key}/residual_constrain"] = [entries(jax.jit(
            lambda x: rules.residual_constrain(x, mesh, seq))(
            jnp.zeros(s)).sharding.spec, len(s)) for s, seq in residual]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_specs():
    """The reference's specs of every grid entry, by mesh and function
    (about 10 s)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    got = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(GRID),
                          json.dumps(RESIDUAL)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    return json.loads(got.stdout.strip().splitlines()[-1])


def _entries(spec, ndim) -> list:
    return [e if e is None or isinstance(e, str) else list(e)
            for e in tuple(spec) + (None,) * (ndim - len(spec))]


def _drop_unit(entry, mesh: Mesh):
    axes = [a for a in rules.entry_axes(
        tuple(entry) if isinstance(entry, list) else entry)
        if mesh.axis_size(a) > 1]
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _port_specs(mesh: Mesh, function: str) -> list:
    if function == "constrain":
        return [_entries(rules.constrain_spec(s, mesh, *names), len(s))
                for s, names in GRID]
    if function in ("constrain_pad", "named"):
        # constrain_pad lays a tensor out by named()'s spec.
        return [_entries(rules.named(mesh, *names).spec, len(s))
                for s, names in GRID]
    return [_entries(rules.constrain_spec(
        s, mesh, "batch", "seq" if seq else None, None), len(s))
        for s, seq in RESIDUAL]


@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_specs_are_the_references(reference_specs, shape, function):
    """Entry for entry, the port's spec of every grid shape is the one
    the reference's function lays it out by."""
    mesh = Mesh(("data", "model"), shape)
    want = reference_specs[f"{shape[0]}x{shape[1]}/{function}"]
    got = _port_specs(mesh, function)
    if function == "constrain_pad":
        # An axis of size 1 splits nothing: XLA's output spec leaves it
        # out, named()'s spec keeps it.
        got = [[_drop_unit(e, mesh) for e in g] for g in got]
        want = [[_drop_unit(e, mesh) for e in w] for w in want]
    cases = GRID if function != "residual_constrain" else RESIDUAL
    for case, g, w in zip(cases, got, want):
        assert g == w, (case, g, w)


def test_named_pairs_mesh_and_placements():
    """``named`` is a frozen (mesh, spec) pair whose placements are the
    spec's on the mesh."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = Mesh(("data", "model"), (2, 4))
    sh = rules.named(mesh, "batch", None, "tensor")
    assert sh.mesh is mesh and sh.spec == rules.P("data", None, "model")
    assert sh.placements == [Shard(0), Shard(2)]
    assert rules.named(mesh, None, None).placements == [Replicate()] * 2
    with pytest.raises(AttributeError):
        sh.spec = rules.P()


@pytest.mark.parametrize("function", FUNCTIONS[:3])
def test_no_mesh_returns_the_tensor_itself(function):
    x = torch.zeros(2, 8, 16)
    if function == "residual_constrain":
        assert rules.residual_constrain(x, None, True) is x
    else:
        assert getattr(rules, function)(x, None, "batch", None,
                                        "tensor") is x


def test_constrain_on_a_mesh_takes_a_dtensor():
    """A plain tensor met on a mesh is a fault of the caller: raise."""
    with pytest.raises(TypeError, match="DTensor"):
        rules.constrain(torch.zeros(2, 8), Mesh(("data", "model"), (2, 2)),
                        "batch", None)
