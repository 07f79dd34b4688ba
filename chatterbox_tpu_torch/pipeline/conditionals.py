"""Voice conditionals as immutable values of tensors, stored as safetensors
with the same keys as the JAX package's ``Conditionals.save``, and read from
the reference's ``conds.pt`` (``load_torch``)."""

from typing import NamedTuple

import numpy as np
import torch

from ..checkpoint.safetensors_io import load_safetensors, save_safetensors
from ..models.s3gen.s3gen import RefDict


class T3CondData(NamedTuple):
    speaker_emb: torch.Tensor  # (B, 256)
    prompt_tokens: torch.Tensor  # (B, 150) int32
    emotion_adv: torch.Tensor  # (B,)


class Conditionals(NamedTuple):
    t3: T3CondData
    gen: RefDict

    def with_exaggeration(self, exaggeration: float) -> "Conditionals":
        emo = torch.full_like(self.t3.emotion_adv, exaggeration)
        return self._replace(t3=self.t3._replace(emotion_adv=emo))

    def rows(self, i: int, j: int) -> "Conditionals":
        """Rows [i, j) of batched (B, ...) conditionals; single-voice
        (1, ...) conds pass through unchanged (they broadcast per batch)."""
        if self.t3.speaker_emb.shape[0] == 1:
            return self
        return Conditionals(T3CondData(*(x[i:j] for x in self.t3)),
                            RefDict(*(x[i:j] for x in self.gen)))

    @classmethod
    def stack(cls, conds: list) -> "Conditionals":
        """Row-stack single-voice conditionals into one batched Conditionals
        (leading dim ``len(conds)``), so that one generate_batch call serves
        mixed voices: the pipeline broadcasts (1, ...) conds and takes
        (B, ...) conds row by row. All entries must share their shapes past
        the first axis (the same conditioning-length caps); otherwise
        ValueError."""
        if len(conds) == 1:
            return conds[0]
        shapes = {tuple(tuple(x.shape[1:]) for x in (*c.t3, *c.gen)) for c in conds}
        if len(shapes) != 1:
            raise ValueError(f"mixed conditional shapes cannot stack: {shapes}")
        return cls(T3CondData(*(torch.cat(xs) for xs in zip(*(c.t3 for c in conds)))),
                   RefDict(*(torch.cat(xs) for xs in zip(*(c.gen for c in conds)))))

    def to(self, device) -> "Conditionals":
        return Conditionals(
            T3CondData(*(x.to(device) for x in self.t3)), RefDict(*(x.to(device) for x in self.gen))
        )

    def save(self, fpath):
        tensors = {f"t3.{k}": v for k, v in self.t3._asdict().items()}
        tensors.update({f"gen.{k}": v for k, v in self.gen._asdict().items()})
        save_safetensors({k: v.detach().cpu().numpy() for k, v in tensors.items()}, fpath)

    @classmethod
    def load(cls, fpath) -> "Conditionals":
        arrays, _ = load_safetensors(fpath)
        t = {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}
        return cls(
            T3CondData(t["t3.speaker_emb"], t["t3.prompt_tokens"].to(torch.int32),
                       t["t3.emotion_adv"]),
            RefDict(t["gen.prompt_token"].to(torch.int32), t["gen.prompt_token_len"].to(torch.int32),
                    t["gen.prompt_feat"], t["gen.embedding"]),
        )

    @classmethod
    def load_torch(cls, fpath) -> "Conditionals":
        """A reference ``conds.pt`` (a torch pickle of ``{"t3": T3Cond's
        fields, "gen": the ref dict}``, tts.py:91-103), read with
        ``weights_only=True`` as the JAX package's ``load_torch``: the
        emotion as (B,), the token tensors int32, CPU tensors."""
        d = torch.load(fpath, map_location="cpu", weights_only=True)
        t3d, gen = d["t3"], d["gen"]

        def n(x, dtype=None):
            x = torch.as_tensor(x).detach()
            return x if dtype is None else x.to(dtype)

        return cls(
            T3CondData(n(t3d["speaker_emb"]), n(t3d["cond_prompt_speech_tokens"], torch.int32),
                       n(t3d["emotion_adv"]).reshape(-1)),
            RefDict(n(gen["prompt_token"], torch.int32), n(gen["prompt_token_len"], torch.int32),
                    n(gen["prompt_feat"]), n(gen["embedding"])),
        )
