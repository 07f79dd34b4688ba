"""k3_roofline: K3 (the UNet's packed self-attention) against its roofline in
the traced call: every launch of a call has the call's shape (both CFG
streams of each row, its valid frames), so the share is the launch count
times one launch's bound over their summed device time, in %."""

from benchmark import counts

KERNEL = "flash_attention_packed_sm90_kernel"


def read(run):
    c, tr = run.traced_call(), run.trace
    if c is None or tr is None:
        return None
    ks = tr.kernels_named(KERNEL)
    if not ks:
        return None
    est = run.config["s3gen"]["flow"]["estimator"]
    ratio = run.config["s3gen"]["flow"]["token_mel_ratio"]
    p = c.shapes["prompt_tokens"]
    frames = [ratio * (p + n) for n in c.shapes["n_tokens"]]
    padded = -(-ratio * (p + c.shapes["token_bucket"]) // 128) * 128
    bound = counts.bound_s(*counts.k3_launch(frames, est, padded))
    return 100.0 * bound * len(ks) / sum(d for _, _, d in ks)

