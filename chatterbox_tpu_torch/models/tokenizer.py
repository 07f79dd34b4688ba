"""English text BPE tokenizer (vocab 704) reading the reference
``tokenizer.json``: the port's own pure-Python copy of
``chatterbox_tpu/models/tokenizer.py:25-138`` (greedy lowest-rank merges;
space maps to the ``[SPACE]`` special token before encoding).
"""

import json
from typing import List

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
    """The reference EnTokenizer on the pure-Python BPE."""

    def __init__(self, vocab_file_path: str):
        with open(vocab_file_path) as f:
            self.spec = json.load(f)
        self._py = PurePythonBPE(self.spec)
        voc = self._py.vocab
        if SOT not in voc or EOT not in voc:
            raise ValueError("tokenizer.json is missing [START]/[STOP]")
        self.sot_id = voc[SOT]
        self.eot_id = voc[EOT]

    def encode(self, txt: str) -> List[int]:
        return self._py.encode(txt.replace(" ", SPACE))

    def decode(self, seq) -> str:
        txt = self._py.decode([int(x) for x in seq])
        return txt.replace(SPACE, " ").replace(EOT, "").replace(UNK, "")
