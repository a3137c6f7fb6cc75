"""One rank of the port training on a CPU mesh (gloo), for
``tests/test_torch_mesh_train.py``; imports no JAX.

    python tests/_torch_mesh_train_ranks.py RANK STORE DATA MODEL CASES DIR

Rank RANK of a (data=DATA, model=MODEL) mesh rendezvouses through the
``FileStore`` at STORE, then for each case of the JSON CASES (name ->
``{"arch", "over", "kind", "microbatches"}``) loads ``DIR/<name>.npz``
(the weights flattened by '/', each step's batch), lays the weights out
with ``sharding.params.shard_params`` and, for each optimizer of
:func:`optimizers`, builds its state on them and takes the case's steps:
``make_train_step`` (``kind`` "plain") or ``make_federated_train_step``
("federated").  Rank 0 writes ``DIR/port_<data>x<model>_<name>_<opt>
.npz`` (parameters, moments, count and each step's metrics, gathered)
and ``.json`` (the placements of every parameter and moment as specs);
each case is written before the next starts.  Last, the final case's
weights as laid out on the mesh are written by ``msgpack_ckpt.save``
(gathered, rank 0 alone) to ``DIR/port_<data>x<model>_ckpt.msgpack``.
The group is destroyed at the end.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_mesh_ranks as ranks
from repro_torch import convert, optim
from repro_torch.checkpoint import msgpack_ckpt
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.sharding import params as sharding_params


def optimizers() -> dict:
    """The optimizers every case trains with, by name.

    ``sgd`` (momentum 0.9, lr 0.1, global-norm clip 10) is held to the
    reference: SGD moves a parameter by the rate times its gradient, so
    the parameters and the first moment carry the comparison (over two
    steps the median leaf of these cases moves by more than 1e-3, ten
    times the limit).  ``adamw`` (lr 1e-4 with 10 warmup steps, clip 1)
    is held to the port on one device and gives both moments'
    placements: AdamW moves a parameter by about its rate whatever the
    gradient (1e-5, then 2e-5 here), and by up to twice that where a
    near-zero gradient's sign follows the order of a sum, so its
    parameters are compared with the same sums on one device, not with
    the reference's."""
    return {"sgd": optim.OptimizerConfig(name="sgd", momentum=0.9,
                                         learning_rate=0.1, warmup_steps=0,
                                         grad_clip=10.0),
            "adamw": optim.OptimizerConfig(learning_rate=1e-4,
                                           warmup_steps=10)}


def flat(tree, prefix: str) -> dict:
    """Nested dicts of tensors -> '/'-joined keys (under ``prefix``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def batches(data: dict, kind: str) -> list:
    """Each step's batch of a case's npz (every rank's whole tensors)."""
    out = []
    for i in range(data["inputs"].shape[0]):
        b = {k: torch.from_numpy(data[k][i]) for k in ("inputs", "labels")}
        if "encoder_inputs" in data:
            b["encoder_inputs"] = torch.from_numpy(data["encoder_inputs"][i])
        if kind == "federated":
            b["selected"] = torch.from_numpy(data["selected"])
            b["sizes"] = torch.from_numpy(data["sizes"])
        out.append(b)
    return out


def train(params, data: dict, cfg, case: dict, ocfg, mesh):
    """The case's steps from ``params`` with a fresh state of ``ocfg`` ->
    (final state, each step's metrics)."""
    state = {"params": params, "opt": optim.init_state(params, ocfg)}
    if case["kind"] == "federated":
        step = steps.make_federated_train_step(
            cfg, ocfg, data["inputs"].shape[1],
            2 if mesh is None else None, mesh=mesh)
    else:
        step = steps.make_train_step(cfg, ocfg, case.get("microbatches", 1),
                                     mesh=mesh)
    metrics = []
    for batch in batches(data, case["kind"]):
        state, m = step(state, batch)
        metrics.append(m)
    return state, metrics


def outputs(state, metrics, mesh) -> tuple[dict, dict]:
    """Every leaf of the state and metrics as numpy (gathered on a
    mesh), and the specs of the parameters and moments."""
    full = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t)
    leaves = flat(state["params"], "params")
    for name in ("mu", "nu"):
        if name in state["opt"]:
            leaves.update(flat(state["opt"][name], name))
    leaves["count"] = state["opt"]["count"]
    for i, m in enumerate(metrics):
        leaves.update({f"step{i}/{k}": v for k, v in m.items()})
    out = {k: full(v).detach().numpy() for k, v in leaves.items()}
    specs = {} if mesh is None else {
        k: ranks.spec_of(v, mesh) for k, v in leaves.items()
        if k.split("/")[0] in ("params", "mu", "nu")}
    return out, specs


def load(data: dict, cfg):
    return convert.transformer_params_from_numpy(ranks.unflatten(
        {k[2:]: v for k, v in data.items() if k.startswith("p/")}), cfg)


def main(argv) -> None:
    rank, store_path, n_data, n_model, cases, out_dir = argv
    rank, n_data, n_model = int(rank), int(n_data), int(n_model)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, n_data * n_model)
    mesh = mesh_lib.init_mesh(
        mesh_lib.Mesh(("data", "model"), (n_data, n_model)), store, rank,
        device="cpu")
    stem = os.path.join(out_dir, f"port_{n_data}x{n_model}")
    try:
        for name, case in json.loads(cases).items():
            cfg = ranks.config(case["arch"], case["over"])
            data = dict(np.load(os.path.join(out_dir, f"{name}.npz")))
            params = sharding_params.shard_params(load(data, cfg), cfg, mesh)
            for opt, ocfg in optimizers().items():
                state, metrics = train(params, data, cfg, case, ocfg, mesh)
                out, specs = outputs(state, metrics, mesh)
                if rank == 0:
                    np.savez(f"{stem}_{name}_{opt}.npz", **out)
                    with open(f"{stem}_{name}_{opt}.json", "w") as f:
                        json.dump(specs, f)
        msgpack_ckpt.save(f"{stem}_ckpt.msgpack", params,
                          meta={"case": name})
    finally:
        mesh_lib.destroy_mesh()


if __name__ == "__main__":
    main(sys.argv[1:])
