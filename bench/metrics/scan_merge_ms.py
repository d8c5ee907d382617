"""The benchmark's ``bench.scan_merge`` span (``SearchEngine.result`` to the
answers on the host), total over the traced window's batches over their
number."""


def read(run):
    spans = run.spans.get("scan_merge")
    return sum(spans) / len(spans) * 1e3 if spans else None
