"""mfu: the model FLOPs the window's inputs needed (``counts``: T3, the
flow, HiFT and in VC the S3 tokenizer, from the calls' shapes) over the
wall seconds of those calls times the card's bf16 peak, in %, over the
calls the profiler did not cover."""

from benchmark import counts


def read(run):
    calls = run.host_calls()
    wall = sum(c.wall_s for c in calls)
    if not calls or wall <= 0:
        return None
    return 100.0 * sum(c.flops for c in calls) / (wall * counts.PEAK_BF16_FLOPS)
