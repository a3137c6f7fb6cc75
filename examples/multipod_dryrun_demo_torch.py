"""Multi-pod dry-run walkthrough for a single (arch, shape), in the port.

    PYTHONPATH=src python examples/multipod_dryrun_demo_torch.py \
        [--arch qwen3-14b] [--shape decode_32k]

The port's counterpart of ``examples/multipod_dryrun_demo.py``: the
16x16 and the 2x16x16 mesh, the inputs' placements, per-device argument
bytes, FLOPs and the planned collectives of
``repro_torch.launch.dryrun.lower_one``.  Needs no device: the step runs
on ``meta`` tensors.
"""

import argparse

from repro_torch import configs
from repro_torch.configs import shapes as shapes_lib
from repro_torch.launch import dryrun, mesh as mesh_lib


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--shape", default="decode_32k")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    shape = shapes_lib.get_shape(args.shape)
    ok, why = shapes_lib.applicable(cfg, shape)
    if not ok:
        raise SystemExit(f"{cfg.name} x {shape.name} skipped: {why}")

    for multi_pod in (False, True):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        rec = dryrun.lower_one(cfg, shape, mesh, mem_only=multi_pod)
        print(f"== {rec['mesh']} ({rec['num_devices']} devices) ==")
        print("  per-device memory:", rec["memory"])
        print("  collective bytes by kind:",
              {k: f"{v / 1e6:.1f} MB"
               for k, v in rec["collectives"]["bytes"].items() if v})


if __name__ == "__main__":
    main()
