"""Re-plans of the hill-climb pairs through the dry run.

Port of ``repro.launch.hillclimb``: the same configurations, each
planned by ``launch.dryrun.lower_one`` on the 16x16 mesh and written to
``--out`` after each.

Pair A   qwen3-14b x train_4k with the attention q-chunk at 2048.
Pair B   qwen3-moe-235b x train_4k, grouped MoE dispatch (the default).
Pair C   qwen2-vl-72b x prefill_32k.
Pair B2  pair B with dispatch groups of 8192 tokens.
Pair C2  pair C with the attention q-chunk at 2048.

Usage:  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
            [--out dryrun_hillclimb.json] [--pairs A,B,C]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch import configs
from repro_torch.configs import shapes as shapes_lib
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

# Tag -> (pair, arch, shape, config overrides), in the reference's order.
PAIRS = (
    ("B", "B/moe-grouped-dispatch/train_4k", "qwen3_moe_235b_a22b",
     "train_4k", {}),
    ("C", "C/prefill-pinned-cache/prefill_32k", "qwen2_vl_72b",
     "prefill_32k", {}),
    ("A", "A/qchunk-2048/train_4k", "qwen3_14b", "train_4k",
     {"attn_chunk": 2048}),
    ("B2", "B/moe-group-8192/train_4k", "qwen3_moe_235b_a22b", "train_4k",
     {"moe_group_size": 8192}),
    ("C2", "C/qchunk-2048/prefill_32k", "qwen2_vl_72b", "prefill_32k",
     {"attn_chunk": 2048}),
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dryrun_hillclimb.json")
    ap.add_argument("--pairs", default="A,B,C")
    args = ap.parse_args(argv)
    mesh = mesh_lib.make_production_mesh(multi_pod=False)
    wanted = set(args.pairs.split(","))
    results = []
    for pair, tag, arch, shape_name, over in PAIRS:
        if pair not in wanted:
            continue
        cfg = dataclasses.replace(configs.get(arch), **over)
        rec = dryrun.lower_one(cfg, shapes_lib.get_shape(shape_name), mesh)
        rec["tag"] = tag
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=float)
        print(f"[hillclimb] {tag}: mem={rec['memory']} "
              f"cost={rec['cost']} coll="
              f"{rec['collectives']['total_bytes'] / 1e9:.2f}GB",
              flush=True)


if __name__ == "__main__":
    main()
