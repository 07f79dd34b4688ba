"""Voice conditionals as immutable values of tensors, stored as safetensors
with the same keys as the JAX package's ``Conditionals.save``."""

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
