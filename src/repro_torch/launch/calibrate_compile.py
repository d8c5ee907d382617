"""Trace-time calibration: one rank of the heaviest cell (deepseek-v3-671b ×
train_4k × 512-rank mesh), exec or cost variant, traced under
``FakeTensorMode`` over the fake process group (``launch.dryrun``); the port
of ``repro.launch.calibrate_compile``.

Run:  PYTHONPATH=src python -m repro_torch.launch.calibrate_compile [cost] [--device cpu]
"""

from __future__ import annotations

import sys
import time

t0 = time.time()


def main(argv=None):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dp_axes, make_production_mesh
    from repro_torch.launch.specs import build_cell

    argv = sys.argv[1:] if argv is None else list(argv)
    cost_variant = "cost" in argv
    device = "cpu" if "--device" in argv and argv[
        argv.index("--device") + 1] == "cpu" else "cuda"
    dev = dryrun.trace_device(device)
    with dryrun.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type=dev)
        print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"dp={dp_axes(mesh)} cost_variant={cost_variant} "
              f"import: {time.time()-t0:.1f}s", flush=True)
        t1 = time.time()
        cell = build_cell("deepseek-v3-671b", "train_4k", mesh,
                          "cost" if cost_variant else "exec")
        t2 = time.time()
        print(f"build: {t2-t1:.1f}s", flush=True)
        with FakeTensorMode():
            args = dryrun._materialize(cell.args, torch.device(dev))
            res, _ = dryrun.measure_step(cell, args)
    t3 = time.time()
    print(f"trace: {t3-t2:.1f}s (fake trace, per rank, torch "
          f"{torch.__version__}, {dev} tensors)")
    mem = res["memory"]
    gib = 1 << 30
    print(f"per-device: args {mem['argument_bytes']/gib:.2f} GiB, "
          f"out {mem['output_bytes']/gib:.2f} GiB, "
          f"temp {mem['temp_bytes']/gib:.2f} GiB, "
          f"alias {mem['alias_bytes']/gib:.2f} GiB")
    print("flops:", res["flops"], "bytes:", res["bytes_accessed"])
    print(f"TOTAL {time.time()-t0:.1f}s")
    return res


if __name__ == "__main__":
    main()
