"""max_memory_allocated over the window, in GB (1e9 bytes)."""

def read(r):
    return r.peak_bytes / 1e9 if r.peak_bytes else None
