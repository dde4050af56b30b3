"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` from the start of
the run to the close of the window, GiB (the CUDA caching allocator's
record of the device; the reference runs after it is read)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
