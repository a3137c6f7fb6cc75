"""Serving on a 1x1 device mesh of the card, against the same weights
without a mesh.

Every test needs a CUDA device and skips without one; the file imports
no JAX (``pytest tests/test_torch_mesh_card.py -k on_card``).  A
one-rank NCCL group (``HashStore``) gives the (data=1, model=1) mesh,
which runs the whole DTensor path (the constraints, ``local_map``
around the flash kernel and the recurrent scans, the MoE dispatch) with
no collective.  h2o-danube-3-4b with 2 layers, at ``reduced()`` in f32
and at its published widths in bf16 (the serving copy): prefill of 300
tokens (past the reduced 128-slot window) and 3 decode steps must equal
the meshless run bit for bit (logits and every cache leaf), every
attention call must launch the flash kernel (the same routes and counts
as the meshless run), and no process group may remain afterwards.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import params as sharding_params  # noqa: E402

B, S, STEPS = 2, 300, 3


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip: these tests run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernel has no CPU mode)")
    return torch.device("cuda")


def _config(width: str):
    cfg = configs.get("h2o_danube_3_4b")
    if width == "reduced":
        return cfg.reduced(num_layers=2)
    return dataclasses.replace(cfg, num_layers=2)


def _serve(params, cfg, tokens, mesh):
    """prefill + STEPS decode steps -> (outputs gathered, flash routes)."""
    full = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t.clone())
    before = dict(tfa.flash_attention.route_launches)
    logits, cache = transformer.prefill(params, tokens[:, :S], cfg,
                                        pad_to=S + STEPS, mesh=mesh)
    out = {"prefill": full(logits)}
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, tokens[:, S + i:S + i + 1], cache, S + i, cfg, mesh=mesh)
        out[f"decode{i}"] = full(logits)
    for pos, leaves in cache.items():
        for name, t in leaves.items():
            out[f"cache/{pos}/{name}"] = full(t)
    routes = {r: n - before[r]
              for r, n in tfa.flash_attention.route_launches.items()}
    return out, routes


@pytest.mark.parametrize("width", ["reduced", "full_width"])
def test_one_rank_mesh_is_the_meshless_run_on_card(cuda_device, width):
    import torch.distributed as dist
    cfg = _config(width)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = transformer.init(gen, cfg)
    if width == "full_width":
        params = transformer.serving_params(params, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + STEPS), generator=gen,
                           device=cuda_device)
    with torch.no_grad():
        want, want_routes = _serve(params, cfg, tokens, None)
        mesh = mesh_lib.init_mesh(
            mesh_lib.Mesh(("data", "model"), (1, 1)), dist.HashStore(), 0)
        try:
            sharded = sharding_params.shard_params(params, cfg, mesh)
            got, routes = _serve(sharded, cfg, tokens, mesh)
        finally:
            mesh_lib.destroy_mesh()
    assert not dist.is_initialized()
    assert want_routes["prefill_tc" if width == "full_width"
                       else "prefill_f32"] == cfg.num_layers
    assert want_routes["decode"] == cfg.num_layers * STEPS
    assert routes == want_routes
    assert set(got) == set(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ


def test_kernel_wrappers_refuse_dtensors_on_card(cuda_device):
    """A DTensor reaching a kernel wrapper other than through the flash
    kernel's mesh entry raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import fedavg_agg
    mesh = mesh_lib.init_mesh(mesh_lib.Mesh(("data", "model"), (1, 1)),
                              dist.HashStore(), 0)
    try:
        u = distribute_tensor(torch.ones(4, 64, device=cuda_device),
                              mesh.device_mesh, [Replicate(), Replicate()])
        w = distribute_tensor(torch.ones(4, device=cuda_device),
                              mesh.device_mesh, [Replicate(), Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            fedavg_agg.fedavg_agg(u, w)
        q = torch.zeros(1, 4, 2, 64, device=cuda_device)
        with pytest.raises(TypeError, match="DTensor"):
            tfa.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 4,
                                                            device=q.device),
                                    distribute_tensor(
                                        q, mesh.device_mesh,
                                        [Replicate(), Replicate()]))
    finally:
        mesh_lib.destroy_mesh()
