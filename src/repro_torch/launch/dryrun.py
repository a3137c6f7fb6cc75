"""Dry run: plan every (arch x shape x mesh) without a device.

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k [--multi-pod] [--all] [--out results.json]

Port of ``repro.launch.dryrun``.  For each combination :func:`lower_one`

1. lays the inputs on the production mesh (16x16 single pod, 2x16x16
   multi-pod; an abstract ``launch.mesh.Mesh``, no devices): the
   parameters by ``sharding.params.param_specs``, the optimizer moments
   like their parameters and its scalars replicated, the batch or the
   tokens, index and cache by ``launch.specs.input_specs``;
2. runs the step (train / prefill / serve) once on ``meta`` tensors at
   the global shapes under ``torch.utils.flop_counter.FlopCounterMode``:
   nothing is allocated and no kernel launches (every kernel wrapper
   takes its plain version for a meta tensor);
3. writes the reference's record: ``arch``, ``shape``, ``mesh``,
   ``mesh_axes``, ``num_devices``, ``cost``, ``memory``, ``memory_mb1``,
   ``collectives``, ``lower_s``, ``compile_s`` and ``microbatches``.

How each field compares with the reference's compiled program:

* ``memory.argument_size_in_bytes`` is the sum of every input leaf's
  per-device shard bytes: equal to XLA's, byte for byte, since the
  placements are the reference's.  ``output_size_in_bytes``,
  ``temp_size_in_bytes``, ``generated_code_size_in_bytes`` and
  ``alias_size_in_bytes`` are ``None``: XLA's buffer assignment has no
  counterpart here.
* ``cost.flops`` is the counter's total over the step divided by the
  device count: the matrix products (``mm``, ``bmm``, ``addmm``,
  attention), forward and backward and the cross-entropy's
  rematerialized chunks, but no elementwise op, which XLA's
  ``cost_analysis`` counts too.  The port's models loop over the layer
  groups in Python, so the count covers every group; XLA counts a
  ``scan`` body once, so the two compare at one group only
  (``num_layers = pattern_period``), where ``tests/test_torch_dryrun.py``
  holds them.  ``cost.bytes`` is ``None``.
* ``collectives`` is an analytic plan over the placements, in the
  reference's layout (``bytes`` and ``counts`` over the five
  ``COLLECTIVE_OPS``, ``total_bytes``), per device, each collective at
  its output's bytes as the reference's HLO parse counts them
  (:func:`collective_plan`).  The reference's ``collective_bytes``
  parses XLA's HLO, which torch does not make, so it has no port.
* ``lower_s`` is the time to lay out the inputs and build the step,
  ``compile_s`` the counted run's.

No environment variable is set at import: the reference forces 512 host
devices through ``XLA_FLAGS``; the abstract mesh needs none.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, optim
from repro_torch.configs import shapes as shapes_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models import common, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import params as psharding
from repro_torch.sharding import rules
from repro_torch.sharding.rules import P
from repro_torch.tree import tree_leaves, tree_map

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes")


def default_microbatches(cfg: ModelConfig, shape: shapes_lib.InputShape,
                         mesh: Mesh) -> int:
    """Gradient-accumulation factor keeping per-device activations sane:
    at most ~4 sequences a device a microbatch for d_model >= 4096."""
    if shape.kind != "train" or cfg.d_model < 4096:
        return 1
    per_dev = shape.global_batch // max(mesh_lib.data_parallel_size(mesh), 1)
    return max(1, per_dev // 4)


def default_optimizer(cfg: ModelConfig) -> optim.OptimizerConfig:
    """AdamW, its moments in bf16 for the hybrid and the largest
    configurations (235b, 398b, 72b), else f32."""
    return optim.OptimizerConfig(
        state_dtype=("bfloat16" if cfg.arch_type in ("hybrid",)
                     or "235b" in cfg.name or "398b" in cfg.name
                     or "72b" in cfg.name else "float32"))


def _arg_specs(tree, specs) -> Any:
    """Meta leaves and their specs -> ``ArgSpec`` leaves."""
    return tree_map(lambda t, s: specs_lib.ArgSpec(tuple(t.shape), t.dtype, s),
                    tree, specs)


def state_specs(cfg: ModelConfig, ocfg: optim.OptimizerConfig,
                mesh: Mesh) -> Dict[str, Any]:
    """The train state's leaves: parameters by ``param_specs``, the
    optimizer moments like their parameters, its scalars replicated (the
    reference's ``_opt_shardings``)."""
    params = transformer.init_shapes(cfg)
    pspecs = psharding.param_specs(params, cfg, mesh)
    opt = optim.init_state(params, ocfg)
    return {"params": _arg_specs(params, pspecs),
            "opt": {k: (_arg_specs(v, pspecs) if k in ("mu", "nu")
                        else specs_lib.ArgSpec(tuple(v.shape), v.dtype, P()))
                    for k, v in opt.items()}}


def _meta(tree):
    """A meta tensor for each ``ArgSpec`` leaf."""
    return tree_map(lambda a: a.meta(), tree)


class _Reads(TorchDispatchMode):
    """Records the tensors some computing operation reads, directly or
    through a chain of views (XLA drops an input that is only sliced)."""

    def __init__(self):
        super().__init__()
        self.ids = set()
        self._root = {}     # id of a view -> id of the tensor it views
        self._views = []    # holds the views, so that their ids stay theirs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        out = func(*args, **kwargs)
        if func.is_view and ins:
            root = self._root.get(id(ins[0]), id(ins[0]))
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor):
                    self._root[id(o)] = root
                    self._views.append(o)
        else:
            self.ids.update(self._root.get(id(x), id(x)) for x in ins)
        return out


def slstm_steps_flops(cfg: ModelConfig, shape: shapes_lib.InputShape) -> int:
    """The products of the sLSTM steps that the meta run stands in for
    by one (``models.xlstm.slstm_forward``): the recurrent ``(B, nh, hd)
    x (nh, hd, 4hd)`` product of the other ``S - 1`` positions, in every
    sLSTM layer, with its two backward products in training."""
    if shape.kind == "decode":
        return 0
    layers = cfg.num_groups * sum(s.mixer == "slstm" for s in cfg.pattern)
    hd = cfg.d_model // cfg.xlstm_heads
    step = 2 * shape.global_batch * cfg.d_model * 4 * hd
    passes = 3 if shape.kind == "train" else 1
    return layers * (shape.seq_len - 1) * step * passes


# ---------------------------------------------------------------------------
# The collective plan
# ---------------------------------------------------------------------------

# Leaves applied as ``x @ W`` over the tokens, W's last two dims (in,
# out): the 2-D projections, and the 3-D expert stacks when they are not
# expert-parallel.  The sLSTM's ``wr`` and Mamba's depthwise ``conv``
# contract nothing sharded; the router's D is gathered.
_PROJECTIONS = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "wup", "wgate",
                          "wz", "wx", "wB", "wC", "wdt", "wif", "wx4",
                          "lm_head"})


def collective_plan(cfg: ModelConfig, shape: shapes_lib.InputShape,
                    mesh: Mesh, params) -> Dict[str, Any]:
    """The collectives one device takes part in for one step, planned
    from the placements of ``params`` (``ArgSpec`` leaves; not
    measured), each at its output's bytes:

    * a parameter sharded over a data-parallel axis (FSDP) is all-gathered
      over those axes for the forward, and in training again for the
      backward: its bytes once gathered;
    * in training each such gradient is reduce-scattered (its shard's
      bytes), and every other gradient all-reduced over the data axes
      when they hold more than one device (its bytes a device);
    * a projection ``x @ W`` whose input dim is tensor-sharded all-reduces
      its output (tokens a device x out x the compute dtype) in the
      forward, and in training one whose output dim is tensor-sharded
      all-reduces the input's gradient (tokens a device x in); a
      vocab-sharded token table all-reduces the embeddings it looks up;
    * an expert-parallel MoE layer exchanges its tokens all to all twice
      in the forward (dispatch, combine) and twice more in the backward
      (tokens a device x top-k x d_model).

    Stacked leaves count once a layer group.  Tokens a device: the
    batch's share of the data axes (all of it where the batch does not
    split) times the sequence (1 in decode).
    """
    train = shape.kind == "train"
    cb = common.dtype_of(cfg.dtype_compute).itemsize
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = mesh_lib.data_parallel_size(mesh)
    tensor = rules.resolve("tensor", mesh)
    bsplit = rules.entry_size(specs_lib._batch_spec(
        shape.global_batch, mesh, 0)[0], mesh)
    tokens = shape.global_batch // bsplit * (
        1 if shape.kind == "decode" else shape.seq_len)
    per: Dict[str, float] = dict.fromkeys(COLLECTIVE_OPS, 0.0)
    counts: Dict[str, int] = dict.fromkeys(COLLECTIVE_OPS, 0)

    def add(kind: str, n: int, nbytes: float) -> None:
        counts[kind] += n
        per[kind] += n * nbytes

    def tensor_split(entry) -> bool:
        return tensor is not None and tensor in rules.entry_axes(entry)

    def walk(path: str, t) -> None:
        if isinstance(t, dict):
            for k in t:
                walk(f"{path}/{k}", t[k])
            return
        s = t.spec
        shard = t.shard_bytes(mesh)
        fsdp = math.prod(mesh.axis_size(a) for e in s
                         for a in rules.entry_axes(e) if a in dp_axes)
        if fsdp > 1:
            add("all-gather", 2 if train else 1, shard * fsdp)
            if train:
                add("reduce-scatter", 1, shard)
        elif train and dp > 1:
            add("all-reduce", 1, shard)
        name = path.rsplit("/", 1)[-1]
        stacked = "/layers/" in path
        groups = t.shape[0] if stacked else 1
        core = tuple(t.shape[1:] if stacked else t.shape)
        cspec = (tuple(s[1:] if stacked else s)
                 + (None,) * len(core))[:len(core)]
        if name == "embed":
            if tensor_split(cspec[0]) and not (
                    cfg.input_mode == "embeddings" and not cfg.is_encdec):
                add("all-reduce", 1, tokens * core[1] * cb)
            if cfg.tie_embeddings and train and tensor_split(cspec[0]):
                add("all-reduce", 1, tokens * core[1] * cb)
            return
        if name not in _PROJECTIONS or len(core) not in (2, 3):
            return
        rows = tokens
        if len(core) == 3:                       # (E, in, out) experts
            rows = tokens * cfg.num_experts_per_tok
            if tensor_split(cspec[0]):           # expert-parallel
                if name == "wi":
                    add("all-to-all", groups * (4 if train else 2),
                        rows * cfg.d_model * cb)
                return
        d_in, d_out = core[-2], core[-1]
        if tensor_split(cspec[-2]):
            add("all-reduce", groups, rows * d_out * cb)
        if train and tensor_split(cspec[-1]):
            add("all-reduce", groups, rows * d_in * cb)

    walk("", params)
    return {"bytes": per, "counts": counts,
            "total_bytes": sum(per.values())}


# ---------------------------------------------------------------------------
# Plan one (arch, shape, mesh)
# ---------------------------------------------------------------------------

def lower_one(cfg: ModelConfig, shape: shapes_lib.InputShape, mesh: Mesh,
              ocfg: Optional[optim.OptimizerConfig] = None,
              verbose: bool = True, microbatches: Optional[int] = None,
              mem_only: bool = False, with_mb_memory: bool = True,
              token_dtype: torch.dtype = torch.int32) -> Dict[str, Any]:
    """The record of one (arch, shape, mesh), the reference's keys.

    ``token_dtype`` is the token ids' type in the counted run and in the
    argument bytes (the reference's int32 by default; the port's own
    trainer feeds int64).  The FLOPs come from the ``microbatches=1``
    step, or under ``mem_only`` from the microbatched one (the same
    products), as the reference takes its costs.
    """
    ocfg = ocfg or default_optimizer(cfg)
    if microbatches is None:
        microbatches = default_microbatches(cfg, shape, mesh)
    t0 = time.perf_counter()
    specs = specs_lib.input_specs(cfg, shape, mesh)
    if token_dtype != torch.int32:
        specs = tree_map(lambda a: specs_lib.ArgSpec(
            a.shape, token_dtype if a.dtype == torch.int32 and a.shape
            else a.dtype, a.spec), specs)
    if shape.kind == "train":
        args = {"state": state_specs(cfg, ocfg, mesh), "batch": specs}
        params = args["state"]["params"]
        step = steps_lib.make_train_step(
            cfg, ocfg, microbatches=(microbatches if mem_only else 1))
        call = lambda m: step(m["state"], m["batch"])  # noqa: E731
    else:
        shapes = transformer.init_shapes(cfg)
        params = _arg_specs(shapes, psharding.param_specs(shapes, cfg, mesh))
        args = {"params": params, "inputs": specs}
        if shape.kind == "prefill":
            step = steps_lib.make_prefill_step(cfg)
            call = lambda m: step(m["params"], m["inputs"])  # noqa: E731
        else:
            step = steps_lib.make_serve_step(cfg)
            call = lambda m: step(  # noqa: E731
                m["params"], m["inputs"]["tokens"], m["inputs"]["cache"],
                shape.seq_len - 1)
    metas = _meta(args)
    t_lower = time.perf_counter() - t0
    reads = _Reads()
    with FlopCounterMode(display=False) as counter, reads:
        call(metas)
    t_compile = time.perf_counter() - t0 - t_lower

    # XLA drops an argument the program never reads (an encoder-decoder's
    # encoder in its decode step): count the leaves some operation read,
    # and the decode position where an attention layer reads it (an
    # argument of the reference's step; the port's takes a host int).
    read = [a for a, t in zip(tree_leaves(args), tree_leaves(metas))
            if id(t) in reads.ids]
    if shape.kind == "decode" and any(s.mixer == "attn" for s in cfg.pattern):
        read.append(specs["index"])
    memory = dict.fromkeys(MEMORY_KEYS)
    memory["argument_size_in_bytes"] = float(
        sum(a.shard_bytes(mesh) for a in read))
    rec: Dict[str, Any] = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh.describe(),
        "mesh_axes": list(mesh.axis_names),
        "num_devices": mesh.size,
        "cost": {"flops": (counter.get_total_flops()
                           + slstm_steps_flops(cfg, shape)) / mesh.size,
                 "bytes": None},
        "memory": memory,
        "memory_mb1": (dict(memory) if microbatches > 1 and with_mb_memory
                       and not mem_only else None),
        "collectives": collective_plan(cfg, shape, mesh, params),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "microbatches": microbatches,
    }
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape.name} x {rec['mesh']}: "
              f"lower {t_lower:.1f}s count {t_compile:.1f}s")
        print(f"  memory:      argument "
              f"{memory['argument_size_in_bytes']:.0f} bytes a device")
        print(f"  cost:        {rec['cost']['flops']:.4e} FLOPs a device")
        print(f"  collectives: total "
              f"{rec['collectives']['total_bytes'] / 1e9:.3f} GB "
              f"{rec['collectives']['counts']}")
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_matrix(arch_ids, shape_names, multi_pod_list, out_path: str,
               corrected: bool = True) -> int:
    """Every (arch, shape) that ``shapes.applicable`` admits on every
    mesh of ``multi_pod_list``; a record a pair, written to
    ``out_path`` after each.  Returns the failed records' count.

    The reference's stage 2 re-lowers each pair at one and two layer
    groups to undo XLA's once-counted scan; the port's count covers
    every group, so with ``corrected`` a single-pod record's
    ``cost_corrected`` is its ``cost`` and its
    ``collectives_corrected_bytes`` its plan's total."""
    results = []
    failures = 0
    pairs = []
    for arch in arch_ids:
        cfg = configs.get(arch)
        for sname in shape_names:
            shape = shapes_lib.get_shape(sname)
            ok, why = shapes_lib.applicable(cfg, shape)
            if not ok:
                print(f"[dryrun] SKIP {cfg.name} x {sname}: {why}",
                      flush=True)
                results.append({"arch": cfg.name, "shape": sname,
                                "skipped": why})
                continue
            pairs.append((cfg, shape))

    for cfg, shape in pairs:
        for mp in multi_pod_list:
            mesh = mesh_lib.make_production_mesh(multi_pod=mp)
            try:
                rec = lower_one(cfg, shape, mesh, mem_only=mp)
                if corrected and not mp:
                    rec["cost_corrected"] = dict(rec["cost"])
                    rec["collectives_corrected_bytes"] = \
                        rec["collectives"]["total_bytes"]
                results.append(rec)
                print(f"[dryrun] OK {cfg.name} x {shape.name} x "
                      f"{rec['mesh']}", flush=True)
            except Exception as e:  # noqa: BLE001
                failures += 1
                print(f"[dryrun] FAIL {cfg.name} x {shape.name} "
                      f"multi_pod={mp}: {type(e).__name__}: {e}",
                      flush=True)
                results.append({"arch": cfg.name, "shape": shape.name,
                                "multi_pod": mp, "error": str(e)})
            _dump(results, out_path)
    _dump(results, out_path)
    return failures


def _dump(results, out_path: str) -> None:
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1, default=float)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 mesh (default also runs 16x16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-corrected", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if (args.all or not args.arch) \
        else [args.arch]
    shape_names = ([s.name for s in shapes_lib.SHAPES]
                   if (args.all or not args.shape) else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = run_matrix(archs, shape_names, meshes, args.out,
                          corrected=not args.no_corrected)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
