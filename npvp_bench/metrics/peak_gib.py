"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at
its start, in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec.get("peak_bytes") else None
