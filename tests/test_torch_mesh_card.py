"""Serving and training on a 1x1 device mesh of the card, against the
same weights without a mesh.

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
whisper-small at its published widths in bf16 (the serving copy):
prefill of 64 tokens against 300 frames and 3 decode steps, the encoder,
cross-attention and its cached K/V on the mesh, bit for bit likewise.

Training (danube at ``reduced(num_layers=2)``, B = 2, 256 tokens): two
AdamW steps of the plain step in bf16 and in f32 compute must equal the
meshless steps bit for bit (parameters, moments, count, metrics), with
the same flash launches by route (each layer's forward and backward:
``prefill_tc`` / ``backward_tc`` in bf16, ``prefill_f32`` / ``backward``
in f32).  One federated step (K = 4 clients of 2 x 128 tokens, SGD with
momentum) on the mesh takes each client's gradient with
``autograd.grad``: it must equal that route run without a mesh
(``steps.federated_step`` around ``steps.client_grads_by_autograd``,
the code the mesh step runs) bit for bit, launch ``fedavg_agg`` once,
and lie within 1e-5 of the meshless federated step run a client a pass
(``torch.func`` gradients, whose sums part from autograd's in the last
bits) with the same flash launches by route.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, optim  # noqa: E402
from repro_torch.kernels import fedavg_agg as tfk  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import params as sharding_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

B, S, STEPS = 2, 300, 3
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 256, 2
K, ENC_FRAMES, WHISPER_PROMPT = 4, 300, 64
FEDERATED_TOL = 1e-5


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


def _serve(params, cfg, tokens, mesh, s=S, enc=None):
    """prefill of ``s`` tokens + STEPS decode steps -> (outputs gathered,
    flash routes)."""
    full = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t.clone())
    before = dict(tfa.flash_attention.route_launches)
    logits, cache = transformer.prefill(params, tokens[:, :s], cfg,
                                        encoder_inputs=enc,
                                        pad_to=s + STEPS, mesh=mesh)
    out = {"prefill": full(logits)}
    for i in range(STEPS):
        logits, cache = transformer.decode_step(
            params, tokens[:, s + i:s + i + 1], cache, s + i, cfg, mesh=mesh)
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


def _one_rank_mesh():
    import torch.distributed as dist
    return mesh_lib.init_mesh(mesh_lib.Mesh(("data", "model"), (1, 1)),
                              dist.HashStore(), 0)


def test_one_rank_mesh_whisper_is_the_meshless_run_on_card(cuda_device):
    """whisper-small's encoder, cross-attention and cached cross K/V on
    the mesh: prefill and decode bit for bit, the same flash launches."""
    import torch.distributed as dist
    cfg = configs.get("whisper_small")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    params = transformer.serving_params(transformer.init(gen, cfg), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, WHISPER_PROMPT + STEPS),
                           generator=gen, device=cuda_device)
    enc = torch.randn((B, ENC_FRAMES, cfg.d_model), generator=gen,
                      device=cuda_device, dtype=torch.bfloat16)
    with torch.no_grad():
        want, want_routes = _serve(params, cfg, tokens, None,
                                   WHISPER_PROMPT, enc)
        mesh = _one_rank_mesh()
        try:
            sharded = sharding_params.shard_params(params, cfg, mesh)
            got, routes = _serve(sharded, cfg, tokens, mesh,
                                 WHISPER_PROMPT, enc)
        finally:
            mesh_lib.destroy_mesh()
    assert not dist.is_initialized()
    layers = cfg.num_layers
    assert want_routes["prefill_tc"] == cfg.encoder_layers + 2 * layers
    assert want_routes["decode"] == 2 * layers * STEPS
    assert routes == want_routes
    assert set(got) == set(want) and "cache/pos0/cross_k" in want
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ


def _train_config(dtype: str):
    return configs.get("h2o_danube_3_4b").reduced(num_layers=2,
                                                  dtype_compute=dtype)


def _state_leaves(state, metrics, mesh) -> dict:
    """Parameters, optimizer state and metrics by name (gathered)."""
    full = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t)
    out = {f"params/{i}": full(t)
           for i, t in enumerate(tree_leaves(state["params"]))}
    for name, tree in state["opt"].items():
        out.update({f"{name}/{i}": full(t)
                    for i, t in enumerate(tree_leaves(tree))})
    out.update({f"metric/{k}": full(v) for k, v in metrics.items()})
    return out


def _train_run(cfg, ocfg, batches, mesh, seed: int = 3):
    """TRAIN_STEPS plain steps from a seeded state -> (leaves, routes)."""
    gen = torch.Generator(device=batches[0]["inputs"].device).manual_seed(
        seed)
    state = steps.init_train_state(gen, cfg, ocfg, mesh=mesh)
    step = steps.make_train_step(cfg, ocfg, mesh=mesh)
    before = dict(tfa.flash_attention.route_launches)
    for batch in batches:
        state, metrics = step(state, batch)
    routes = {r: n - before[r]
              for r, n in tfa.flash_attention.route_launches.items()}
    return _state_leaves(state, metrics, mesh), routes


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_rank_mesh_train_step_is_the_meshless_step_on_card(cuda_device,
                                                               dtype):
    """Two AdamW steps of the plain step on the mesh, bit for bit the
    meshless steps, each layer's attention forward and backward through
    the flash kernels of the compute type."""
    import torch.distributed as dist
    cfg = _train_config(dtype)
    ocfg = optim.OptimizerConfig(warmup_steps=2)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    batches = [{k: torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                 generator=gen, device=cuda_device)
                for k in ("inputs", "labels")} for _ in range(TRAIN_STEPS)]
    want, want_routes = _train_run(cfg, ocfg, batches, None)
    mesh = _one_rank_mesh()
    try:
        got, routes = _train_run(cfg, ocfg, batches, mesh)
    finally:
        mesh_lib.destroy_mesh()
    assert not dist.is_initialized()
    n = cfg.num_layers * TRAIN_STEPS
    fwd, bwd = (("prefill_tc", "backward_tc") if dtype == "bfloat16"
                else ("prefill_f32", "backward"))
    assert want_routes[fwd] == want_routes[bwd] == n
    assert routes == want_routes
    assert set(got) == set(want)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ


def _federated_batch(cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (K, 2, TRAIN_S // 2),
                              generator=gen, device=dev)
             for k in ("inputs", "labels")}
    batch["selected"] = torch.tensor([1.0, 0.0, 1.0, 1.0], device=dev)
    batch["sizes"] = torch.tensor([100.0, 999.0, 300.0, 40.0], device=dev)
    return batch


def test_one_rank_mesh_federated_step_on_card(cuda_device):
    """One federated step on the mesh: one fedavg_agg launch; bit for bit
    the same route without a mesh; within 1e-5 of the meshless
    federated step a client a pass, with the same flash launches."""
    import torch.distributed as dist
    cfg = _train_config("float32")
    ocfg = optim.OptimizerConfig(name="sgd", learning_rate=0.1,
                                 warmup_steps=0)
    batch = _federated_batch(cfg, cuda_device)

    def fresh(mesh=None):
        gen = torch.Generator(device=cuda_device).manual_seed(6)
        return steps.init_train_state(gen, cfg, ocfg, mesh=mesh)

    same = _state_leaves(*steps.federated_step(
        ocfg, K, steps.client_grads_by_autograd(cfg))(fresh(), batch), None)
    before = dict(tfa.flash_attention.route_launches)
    one = _state_leaves(*steps.make_federated_train_step(
        cfg, ocfg, K, clients_per_pass=1)(fresh(), batch), None)
    one_routes = {r: n - before[r]
                  for r, n in tfa.flash_attention.route_launches.items()}
    mesh = _one_rank_mesh()
    try:
        aggs = tfk.fedavg_agg.launches
        before = dict(tfa.flash_attention.route_launches)
        got = _state_leaves(*steps.make_federated_train_step(
            cfg, ocfg, K, mesh=mesh)(fresh(mesh), batch), mesh)
        routes = {r: n - before[r]
                  for r, n in tfa.flash_attention.route_launches.items()}
        aggs = tfk.fedavg_agg.launches - aggs
    finally:
        mesh_lib.destroy_mesh()
    assert not dist.is_initialized()
    assert aggs == 1
    assert one_routes["prefill_f32"] == one_routes["backward"] \
        == K * cfg.num_layers
    assert routes == one_routes
    assert set(got) == set(same) == set(one)
    differ = [k for k in same if not torch.equal(got[k], same[k])]
    assert not differ, differ
    errs = {k: float((got[k] - one[k]).abs().max())
            / max(float(one[k].abs().max()), 1.0) for k in one}
    assert max(errs.values()) <= FEDERATED_TOL, errs
