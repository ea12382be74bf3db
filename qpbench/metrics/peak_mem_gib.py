"""``torch.cuda.max_memory_allocated`` over the window (peak reset after
set-up), in GiB."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 2**30
