"""One rank of the port serving on a CPU mesh (gloo), for
``tests/test_torch_mesh_serve.py``; imports no JAX.

    python tests/_torch_mesh_ranks.py RANK STORE DATA MODEL CASES_JSON DIR

Rank RANK of a (data=DATA, model=MODEL) mesh rendezvouses through the
``FileStore`` at STORE, then for each case of CASES_JSON (name -> arch,
``reduced()`` overrides) loads ``DIR/<name>.npz`` (the reference's
weights, flattened by '/', the inputs and an encoder-decoder's encoder
inputs), runs ``forward``,
``prefill`` and three ``decode_step`` calls on the mesh, and rank 0
writes ``DIR/port_<data>x<model>_<name>.npz`` with every output
gathered (``full_tensor``) and ``.json`` with the placements of the
logits and cache leaves as specs.  Each case's outputs are written
before the next case starts.  Last, each kernel wrapper is given
DTensors (``..._refusals.json``: what each raised); the group is
destroyed at the end.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.sharding import params as sharding_params


def unflatten(flat: dict) -> dict:
    """'a/b/c' keys -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = value
    return tree


def config(arch: str, overrides: dict):
    return configs.get(arch).reduced(**overrides)


def spec_of(t, mesh) -> list:
    """A DTensor's placements as a spec: each dim's mesh axes."""
    out: list = [[] for _ in range(t.dim())]
    for axis, placement in zip(mesh.axis_names, t.placements):
        if placement.is_shard():
            out[placement.dim].append(axis)
    return [None if not axes else axes[0] if len(axes) == 1 else axes
            for axes in out]


def serve(params, data: dict, cfg, mesh) -> tuple[dict, dict]:
    """forward, prefill and 3 decode steps; outputs as numpy (gathered
    where on a mesh) and the specs of the logits and cache leaves."""
    inputs = torch.from_numpy(data["inputs"])
    tokens = torch.from_numpy(data["tokens"])
    enc = (torch.from_numpy(data["encoder_inputs"])
           if "encoder_inputs" in data else None)
    s = inputs.shape[1]
    steps = tokens.shape[1]
    # A copy: decode updates the cache in place.
    full = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t.clone())
    out, specs = {}, {}
    logits, aux = transformer.forward(params, inputs, cfg,
                                      encoder_inputs=enc, mesh=mesh)
    out["forward"], out["aux"] = full(logits), full(aux)
    if mesh is not None:
        specs["forward"] = spec_of(logits, mesh)
    logits, cache = transformer.prefill(params, inputs, cfg,
                                        encoder_inputs=enc,
                                        pad_to=s + steps, mesh=mesh)
    out["prefill"] = full(logits)
    if mesh is not None:
        specs["prefill"] = spec_of(logits, mesh)
    for pos, leaves in cache.items():
        for name, t in leaves.items():
            out[f"prefill_cache/{pos}/{name}"] = full(t)
            if mesh is not None:
                specs[f"prefill_cache/{pos}/{name}"] = spec_of(t, mesh)
    for i in range(steps):
        logits, cache = transformer.decode_step(
            params, tokens[:, i:i + 1], cache, s + i, cfg, mesh=mesh)
        out[f"decode{i}"] = full(logits)
    if mesh is not None:
        specs["decode"] = spec_of(logits, mesh)
    for pos, leaves in cache.items():
        for name, t in leaves.items():
            out[f"cache/{pos}/{name}"] = full(t)
            if mesh is not None:
                specs[f"cache/{pos}/{name}"] = spec_of(t, mesh)
    return {k: v.detach().numpy() for k, v in out.items()}, specs


def refusals(mesh) -> dict:
    """Whether each kernel wrapper raises on DTensor operands (a DTensor
    reaches a kernel only through flash_attention's mesh entry)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels import diversity, fedavg_agg
    from repro_torch.kernels import flash_attention as fa

    def whole(t):
        return distribute_tensor(t, mesh.device_mesh,
                                 [Replicate()] * len(mesh.shape))

    q = torch.zeros(1, 4, 2, 64)
    calls = {
        "fedavg_agg": lambda: fedavg_agg.fedavg_agg(
            whole(torch.ones(4, 8)), whole(torch.ones(4))),
        "diversity_stats": lambda: diversity.diversity_stats(
            whole(torch.zeros(4, 8, dtype=torch.long)),
            whole(torch.ones(4, 8)), 10),
        "flash_attention_bwd": lambda: fa.flash_attention_bwd(
            *(whole(q),) * 4, whole(torch.zeros(1, 2, 4)), whole(q)),
        "flash_attention (k alone)": lambda: fa.flash_attention(
            q, whole(q), q),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except TypeError as e:
            out[name] = str(e)
    return out


def main(argv) -> None:
    rank, store_path, n_data, n_model, cases, out_dir = argv
    rank, n_data, n_model = int(rank), int(n_data), int(n_model)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, n_data * n_model)
    mesh = mesh_lib.init_mesh(
        mesh_lib.Mesh(("data", "model"), (n_data, n_model)), store, rank,
        device="cpu")
    try:
        for name, (arch, overrides) in json.loads(cases).items():
            cfg = config(arch, overrides)
            data = dict(np.load(os.path.join(out_dir, f"{name}.npz")))
            params = convert.transformer_params_from_numpy(unflatten(
                {k[2:]: v for k, v in data.items() if k.startswith("p/")}),
                cfg)
            sharded = sharding_params.shard_params(params, cfg, mesh)
            with torch.no_grad():
                out, specs = serve(sharded, data, cfg, mesh)
            if rank == 0:
                stem = os.path.join(out_dir,
                                    f"port_{n_data}x{n_model}_{name}")
                np.savez(stem + ".npz", **out)
                with open(stem + ".json", "w") as f:
                    json.dump(specs, f)
        refused = refusals(mesh)
        if rank == 0:
            with open(os.path.join(out_dir, f"port_{n_data}x{n_model}_"
                                   f"refusals.json"), "w") as f:
                json.dump(refused, f)
    finally:
        mesh_lib.destroy_mesh()


if __name__ == "__main__":
    main(sys.argv[1:])
