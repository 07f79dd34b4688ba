"""English text BPE tokenizer (vocab 704) reading the reference
``tokenizer.json``: port of ``chatterbox_tpu/models/tokenizer.py`` (greedy
lowest-rank merges; space maps to the ``[SPACE]`` special token before
encoding).

Backends, as in the JAX package (``backend="auto"`` takes the first that
loads): ``native``, the C++ BPE of ``chatterbox_tpu_torch/native``; ``hf``,
the ``tokenizers`` package, where it is installed (``backend="hf"`` raises
where it is not); and ``python``, the pure-Python BPE below, the same
algorithm. ``backend`` names the one in use.
"""

import json
import logging
from typing import List

import torch

logger = logging.getLogger(__name__)

SOT = "[START]"
EOT = "[STOP]"
UNK = "[UNK]"
SPACE = "[SPACE]"


class PurePythonBPE:
    """Greedy lowest-rank-merge BPE over a HF tokenizer.json model."""

    def __init__(self, spec: dict):
        model = spec["model"]
        self.vocab = dict(model["vocab"])
        self.id_to_token = {v: k for k, v in self.vocab.items()}
        self.merge_ranks = {}
        for rank, m in enumerate(model.get("merges", [])):
            pair = tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            self.merge_ranks[pair] = rank
        self.specials = {t["content"] for t in spec.get("added_tokens", [])}
        self.unk_id = self.vocab.get(UNK)

    def _bpe_word(self, word: str) -> List[str]:
        pieces = list(word)
        while len(pieces) > 1:
            best, best_rank = None, None
            for i in range(len(pieces) - 1):
                r = self.merge_ranks.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            pieces = pieces[:best] + [pieces[best] + pieces[best + 1]] + pieces[best + 2 :]
        return pieces

    def encode(self, text: str) -> List[int]:
        out, segment = [], []
        i = 0

        def flush():
            if segment:
                for piece in self._bpe_word("".join(segment)):
                    out.append(self.vocab.get(piece, self.unk_id))
                segment.clear()

        while i < len(text):
            matched = next((sp for sp in self.specials if text.startswith(sp, i)), None)
            if matched:
                flush()
                out.append(self.vocab[matched])
                i += len(matched)
            else:
                segment.append(text[i])
                i += 1
        flush()
        return [t for t in out if t is not None]

    def decode(self, ids) -> str:
        return "".join(self.id_to_token.get(int(i), "") for i in ids)


class EnTokenizer:
    """The reference EnTokenizer over the native, ``tokenizers`` or
    pure-Python BPE (see the module docstring)."""

    def __init__(self, vocab_file_path: str, backend: str = "auto"):
        if backend not in ("auto", "native", "hf", "python"):
            raise ValueError(f"unknown tokenizer backend {backend!r}")
        with open(vocab_file_path) as f:
            self.spec = json.load(f)
        self._native = self._hf = None
        if backend in ("auto", "native"):
            try:
                from ..native import NativeBPE

                self._native = NativeBPE(self.spec)
            except Exception:
                if backend == "native":
                    raise
        if backend in ("auto", "hf") and self._native is None:
            try:
                from tokenizers import Tokenizer

                self._hf = Tokenizer.from_file(vocab_file_path)
            except Exception:
                if backend == "hf":
                    raise
        self._py = PurePythonBPE(self.spec)
        self.backend = "native" if self._native else "hf" if self._hf else "python"
        if backend == "auto" and self.backend == "python":
            logger.warning("tokenizer: neither the native library nor `tokenizers` loaded; "
                           "the pure-Python BPE runs")
        voc = self._py.vocab
        if SOT not in voc or EOT not in voc:
            raise ValueError("tokenizer.json is missing [START]/[STOP]")
        self.sot_id = voc[SOT]
        self.eot_id = voc[EOT]

    def encode(self, txt: str) -> List[int]:
        txt = txt.replace(" ", SPACE)
        if self._native is not None:
            return self._native.encode(txt)
        if self._hf is not None:
            return self._hf.encode(txt).ids
        return self._py.encode(txt)

    def text_to_tokens(self, text: str):
        """The ids of ``text`` as a (1, N) int32 CPU tensor, the reference's
        ``text_to_tokens``."""
        return torch.tensor(self.encode(text), dtype=torch.int32).reshape(1, -1)

    def decode(self, seq) -> str:
        seq = [int(x) for x in seq]
        if self._hf is not None:
            txt = self._hf.decode(seq, skip_special_tokens=False).replace(" ", "")
        else:
            txt = self._py.decode(seq)
        return txt.replace(SPACE, " ").replace(EOT, "").replace(UNK, "")
