"""The tiled scan's share of its roofline: the least time of every traced
batch (``bench/roofline.py``, from the inputs' need) summed, over the
device time of the kernels that the ``repro_torch::filtered_scan_tiled``
op launched (``torch.profiler``).  Nothing where the trace shows none."""


def read(run):
    if run.trace is None or run.need_s is None:
        return None
    device_s = run.trace["op_s"].get("repro_torch::filtered_scan_tiled", 0.0)
    return 100.0 * run.need_s / device_s if device_s > 0 else None
