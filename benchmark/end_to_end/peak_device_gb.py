"""``torch.cuda.max_memory_allocated()`` over the window, in 1e9 bytes: the
peak statistics are reset as the window opens, so the resident data,
object and optimizer state count and set-up's staging copies do not."""


def read(ctx):
    if ctx.memory_peak_bytes is None:
        return None
    return ctx.memory_peak_bytes / 1e9
