"""device_mem_gib: torch.cuda.max_memory_allocated() over set-up and the
window, the CUDA graph's pool included (GiB)."""


def read(run):
    return run.mem_bytes / 2**30 if run.mem_bytes else None
