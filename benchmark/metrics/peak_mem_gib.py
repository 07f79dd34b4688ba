"""peak_mem_gib: the allocator's peak over the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its start)."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes else None
