"""s3gen_ms_per_audio_s: host milliseconds of S3Gen (flow, HiFT, trim-fade,
watermark and the readback: each call's ``s3gen_s``) a second of audio,
over the window's calls the profiler did not cover."""


def read(run):
    calls = [c for c in run.host_calls() if "s3gen_s" in c.stages]
    audio = sum(c.audio_s for c in calls)
    return 1e3 * sum(c.stages["s3gen_s"] for c in calls) / audio if audio else None
