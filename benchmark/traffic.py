"""The one generator of the benchmark's inputs, driven by a cell's traffic
parameters and the run's seed.

Everything a call sends is drawn from ``numpy.random.default_rng([seed,
call])``, so call k of a run is the same whatever the window's length, and
the same seed gives the same inputs. Parameters (see README.md):

- ``texts_per_call``, ``words`` [lo, hi], ``sentences`` [lo, hi], ``chars``
  [lo, hi], ``vocabulary``: texts of sentences of seeded words, redrawn
  until their length lies in ``chars`` (the length fixes the text bucket);
- ``source_seconds``: one synthetic voiced source (16 kHz) a listed
  duration, made once a run; each call sends all of them in a permuted
  order, each circularly shifted and scaled by its own draw, so every call
  of every seed carries the same audio and no two calls the same samples;
- ``voice_seconds``: the reference voice, one a run.
"""

import numpy as np

S3_SR, S3GEN_SR = 16000, 24000


def synthetic_voice(seed, seconds: float, sr: int) -> np.ndarray:
    """A seeded stand-in for recorded speech: a voiced harmonic signal (a
    gliding 90-250 Hz pitch, 12 harmonics falling off as 1/k),
    syllable-rate amplitude bursts, a little noise, and 0.2 s of
    near-silence at each end. float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 90.0 + 160.0 * rng.random() + 30.0 * np.sin(2 * np.pi * (0.3 + rng.random()) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 13))
    syllables = 0.5 + 0.5 * np.sin(2 * np.pi * (3.0 + 2.0 * rng.random()) * t) ** 2
    edge = np.clip(np.minimum(t, seconds - t) / 0.2, 0.0, 1.0) ** 4
    x = 0.25 * voiced * syllables * edge + 0.003 * rng.standard_normal(n)
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def _sentence(rng, vocab, words) -> str:
    n = int(rng.integers(words[0], words[1] + 1))
    s = " ".join(vocab[int(i)] for i in rng.integers(0, len(vocab), n))
    return s[0].upper() + s[1:] + "."


def _text(rng, p) -> str:
    lo, hi = p["chars"]
    for _ in range(1000):
        n = int(rng.integers(p["sentences"][0], p["sentences"][1] + 1))
        t = " ".join(_sentence(rng, p["vocabulary"], p["words"]) for _ in range(n))
        if lo <= len(t) <= hi:
            return t
    raise ValueError(f"no text of {lo}-{hi} characters from these words: widen 'chars'")


class Traffic:
    """One run's inputs: ``voice()`` and ``call(k)``."""

    def __init__(self, params: dict, seed: int):
        self.p = params
        self.seed = int(seed)

    def voice(self) -> np.ndarray:
        """The run's reference voice, 24 kHz."""
        return synthetic_voice([self.seed, 1 << 20], self.p["voice_seconds"], S3GEN_SR)

    def call(self, k: int) -> dict:
        """Call k's inputs: ``seed`` (the program's draws), and ``texts`` or
        ``sources`` (16 kHz); k = -1 is the warm-up call."""
        rng = np.random.default_rng([self.seed, k + 1])
        out = {"seed": int(rng.integers(0, 2 ** 31 - 2))}
        if "texts_per_call" in self.p:
            out["texts"] = [_text(rng, self.p) for _ in range(self.p["texts_per_call"])]
        if "source_seconds" in self.p:
            pool = self.sources()
            out["sources"] = [(np.roll(pool[i], int(rng.integers(0, len(pool[i]))))
                               * np.float32(rng.uniform(0.5, 1.0)))
                              for i in rng.permutation(len(pool))]
        return out

    def sources(self):
        """The run's pool of sources, one a listed duration, made once."""
        if not hasattr(self, "_pool"):
            self._pool = [synthetic_voice([self.seed, 1 << 21, i], float(s), S3_SR)
                          for i, s in enumerate(self.p["source_seconds"])]
        return self._pool
