"""audio_s_per_s: seconds of 24 kHz audio that the window's calls returned
over the window's wall seconds (its whole calls, the traced one too)."""


def read(run):
    return sum(c.audio_s for c in run.calls) / run.window_s
