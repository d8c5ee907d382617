"""The benchmark's ``bench.plan`` span (``SearchEngine.submit``, ended by a
device sync), total over the traced window's batches over their number."""


def read(run):
    spans = run.spans.get("plan")
    return sum(spans) / len(spans) * 1e3 if spans else None
