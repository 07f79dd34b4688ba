"""t3_launches_per_step: device operations (kernels, copies and fills) that
began in the traced call's T3 span (its start to start + ``t3_s``), over its
decode steps: the host's dispatch cost of a step."""


def read(run):
    c, tr = run.traced_call(), run.trace
    if c is None or tr is None or "t3" not in tr.spans or not c.stages.get("t3_steps"):
        return None
    lo, hi = tr.spans["t3"]
    n = sum(1 for _, s, _ in tr.kernels + tr.copies if lo <= s < hi)
    return n / c.stages["t3_steps"]
