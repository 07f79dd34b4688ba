"""ssm_state_gib: the decode carry's Mamba state (conv inputs and fp32
recurrence), GiB: the program's ``t3.ssm_state_bytes`` counter, counted
once a call in T3's prefill, in the traced call's record (in a run with no
trace, the first call that holds a record). None without the counter."""


def _counted(rec):
    spans, counts = rec
    return counts.get("t3.ssm_state_bytes", 0) + sum(
        s.counts.get("t3.ssm_state_bytes", 0) for s in spans)


def read(run):
    calls = [c for c in [run.traced_call()] + run.calls if c is not None]
    for c in calls:
        rec = getattr(c, "spans", None)
        if rec and _counted(rec):
            return _counted(rec) / 2 ** 30
    return None
