"""t3_ms_per_step: T3's host milliseconds a decode step, over the window's
calls the profiler did not cover: the sum of their ``t3_s`` (each ends in a
read of the lengths, which waits for the card) over the sum of their
steps."""


def read(run):
    calls = [c for c in run.host_calls() if "t3_s" in c.stages]
    steps = sum(c.stages["t3_steps"] for c in calls)
    return 1e3 * sum(c.stages["t3_s"] for c in calls) / steps if steps else None
