"""The port's sharding rules and parameter placements against the JAX
reference's (``repro.sharding``), on the two production meshes.

The reference's specs need no devices: they are built on
``jax.sharding.AbstractMesh`` meshes of the production shapes, and
``NamedSharding(...).shard_shape`` gives each device's shard.  The
port's specs are built on its abstract ``launch.mesh`` meshes and
compare entry for entry; its ``transformer.init_shapes`` tree (``meta``
tensors) compares leaf for leaf with the reference's ``init_shapes``.
The DTensor placements are checked under torch's fake process group of
256 ranks: ``distribute_tensor`` of each ``meta`` leaf gives the
reference's shard shape.
"""

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.sharding import params as jparams  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.sharding import params as tparams  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
MESH_IDS = ["16x16", "2x16x16"]


@pytest.fixture(autouse=True)
def one_thread():
    """Shapes only: one intra-op thread, so the test workers that share
    the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESH_IDS)
def test_rules_match_the_reference(multi_pod):
    """``resolve``, ``spec`` and ``divisible`` for every logical name
    (and an unknown one) on the production mesh."""
    jm, tm = MESHES[multi_pod], mesh_lib.make_production_mesh(
        multi_pod=multi_pod)
    assert trules.mesh_axes(tm) == jrules.mesh_axes(jm)
    names = list(jrules.LOGICAL_RULES) + ["vocab", None]
    assert trules.LOGICAL_RULES == jrules.LOGICAL_RULES
    for name in names:
        assert trules.resolve(name, tm) == jrules.resolve(name, jm), name
    spec = trules.spec(tm, *names)
    assert tuple(spec) == tuple(jrules.spec(jm, *names))
    for n in (1, 16, 24, 40, 256, 512, 51_865):
        for axes in (("model",), ("pod", "data"), ("pod", "data", "model"),
                     ("nope",)):
            assert trules.divisible(n, tm, axes) == \
                jrules.divisible(n, jm, axes), (n, axes)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_init_shapes_match_the_reference(arch):
    """Every leaf's path, shape and dtype, from ``meta`` tensors."""
    want = _flat(jt.init_shapes(jconfigs.get(arch)))
    got = _flat(tt.init_shapes(tconfigs.get(arch)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype) == f"torch.{w.dtype}", k


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESH_IDS)
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_match_the_reference(arch, multi_pod):
    """Leaf for leaf, ``_sanitize``'s drops included; each leaf's shard
    shape equals ``NamedSharding.shard_shape``."""
    jm, tm = MESHES[multi_pod], mesh_lib.make_production_mesh(
        multi_pod=multi_pod)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    shapes = _flat(jt.init_shapes(jcfg))
    want = _flat(jparams.param_specs(jt.init_shapes(jcfg), jcfg, jm))
    got = _flat(tparams.param_specs(tt.init_shapes(tcfg), tcfg, tm))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k]) == tuple(w), (k, got[k], w)
        assert trules.shard_shape(shapes[k].shape, got[k], tm) == \
            tuple(NamedSharding(jm, w).shard_shape(shapes[k].shape)), k


def test_sanitize_drops_what_does_not_divide():
    """whisper-small's vocab of 51,865 does not split 16 ways: its token
    table replicates, as the reference's."""
    tm = mesh_lib.make_production_mesh()
    cfg = tconfigs.get("whisper_small")
    specs = tparams.param_specs(tt.init_shapes(cfg), cfg, tm)
    assert tuple(specs["embed"]) == (None, None)
    assert tuple(tparams._spec_for("embed", 2, (51_865, 768), cfg, tm,
                                   False)) == ("model", None)


def test_placements_under_a_fake_process_group():
    """``distribute_tensor`` of each ``meta`` leaf of two configurations
    (one with ``_sanitize``'s drops) over the ``DeviceMesh`` of the 16x16
    mesh gives the reference's shard shape, on rank 0 of 256 fake
    ranks."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    tm = mesh_lib.make_production_mesh()
    jm = MESHES[False]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=tm.size)
    try:
        dm = mesh_lib.device_mesh(tm)
        assert dm.shape == (16, 16)
        assert dm.mesh_dim_names == ("data", "model")
        for arch in ("qwen3_14b", "whisper_small"):
            jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
            leaves = _flat(tt.init_shapes(tcfg))
            want = _flat(jparams.param_specs(jt.init_shapes(jcfg), jcfg, jm))
            places = _flat(tparams.param_shardings(tt.init_shapes(tcfg),
                                                   tcfg, tm))
            for k, leaf in leaves.items():
                local = distribute_tensor(leaf, dm, places[k]).to_local()
                assert tuple(local.shape) == tuple(NamedSharding(
                    jm, want[k]).shard_shape(leaf.shape)), (arch, k)
    finally:
        dist.destroy_process_group()
