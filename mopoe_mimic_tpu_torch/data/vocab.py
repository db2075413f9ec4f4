"""Word vocabulary + report tokenization for the word text encoding: a copy
of ``mopoe_mimic_tpu/data/vocab.py``.

Parity: MimicSentences (mimic/dataio/MimicDataset.py:224-396) — build (on
the train split) or load a w2i/i2w vocabulary from the findings reports
with a min-occurrence threshold and specials ``<exc> <pad> <eos>`` in that
order (``<exc>`` = index 0, MimicDataset.py:359-362 — the reference's
``nn.Embedding(padding_idx=0)`` therefore freezes the *unknown* token, a
quirk the word encoder mirrors); words are kept when their occurrence is
STRICTLY greater than ``min_occ`` (MimicDataset.py:374); each report is
tokenized, truncated to max_sequence_length - 1, ``<eos>``-appended and
``<pad>``-padded; vocab persisted per (min_occ, max_seq_len).

Tokenization uses nltk's word_tokenize when its punkt data is available
and a regex fallback otherwise (zero-egress environments can't download
nltk data). The tokenizer that built a vocab is persisted with it and a
mismatch at load time raises a warning — vocab content is NOT portable
across tokenizers.
"""

from __future__ import annotations

import json
import re
from collections import Counter, OrderedDict
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np

from mopoe_mimic_tpu_torch.utils.logger import log

# reference order (MimicDataset.py:359): <exc>=0, <pad>=1, <eos>=2
SPECIALS = ["<exc>", "<pad>", "<eos>"]
UNK, PAD, EOS = SPECIALS

_WORD_RE = re.compile(r"\w+|[^\w\s]")
_TOKENIZER_NAME: Optional[str] = None


def tokenizer_name() -> str:
    """Which tokenizer this process resolves to: 'nltk_punkt' or 'regex'."""
    global _TOKENIZER_NAME
    if _TOKENIZER_NAME is None:
        try:
            from nltk.tokenize import word_tokenize

            word_tokenize("probe sentence.")
            _TOKENIZER_NAME = "nltk_punkt"
        except Exception:
            _TOKENIZER_NAME = "regex"
    return _TOKENIZER_NAME


def tokenize(line: str) -> List[str]:
    if tokenizer_name() == "nltk_punkt":
        from nltk.tokenize import word_tokenize

        return word_tokenize(line.lower())
    return _WORD_RE.findall(line.lower())


class Vocab:
    def __init__(self, w2i: Dict[str, int], i2w: Dict[str, str],
                 tokenizer: Optional[str] = None):
        self.w2i = w2i
        self.i2w = i2w
        self.tokenizer = tokenizer or tokenizer_name()

    @property
    def vocab_size(self) -> int:
        return len(self.w2i)

    @property
    def pad_idx(self) -> int:
        return self.w2i[PAD]

    @property
    def eos_idx(self) -> int:
        return self.w2i[EOS]

    @property
    def unk_idx(self) -> int:
        return self.w2i[UNK]

    @classmethod
    def build(cls, findings: Iterable[str], min_occ: int = 3) -> "Vocab":
        """Occurrence-ordered vocab; keep words with count STRICTLY above
        min_occ (MimicDataset.py:367-378)."""
        counter: Counter = Counter()
        for line in findings:
            counter.update(tokenize(line))
        w2i: "OrderedDict[str, int]" = OrderedDict()
        for sp in SPECIALS:
            w2i[sp] = len(w2i)
        for w, c in counter.items():
            if c > min_occ and w not in w2i:
                w2i[w] = len(w2i)
        i2w = {str(i): w for w, i in w2i.items()}
        return cls(dict(w2i), i2w)

    def encode(self, line: str, max_len: int) -> np.ndarray:
        """tokenize → truncate to max_len-1 → <eos> → <pad> to max_len;
        unknown words map to <exc> (MimicDataset.py:318-327)."""
        tok = tokenize(line)[: max_len - 1] + [EOS]
        if len(tok) < max_len:
            tok = tok + [PAD] * (max_len - len(tok))
        unk = self.w2i[UNK]
        return np.asarray([self.w2i.get(w, unk) for w in tok], dtype=np.int32)

    def decode(self, ids: Iterable[int]) -> List[str]:
        return [self.i2w.get(str(int(i)), UNK) for i in ids]

    # -- persistence (gen_dir layout parity: oc:{}_msl:{}/mimic.vocab) ----
    @staticmethod
    def gen_dir(data_dir: str, min_occ: int, max_len: int) -> Path:
        return Path(data_dir) / f"oc:{min_occ}_msl:{max_len}"

    def save(self, data_dir: str, min_occ: int, max_len: int) -> None:
        d = self.gen_dir(data_dir, min_occ, max_len)
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "mimic.vocab", "w") as f:
            json.dump(
                {"w2i": self.w2i, "i2w": self.i2w, "tokenizer": self.tokenizer}, f
            )

    @classmethod
    def load(cls, data_dir: str, min_occ: int, max_len: int) -> Optional["Vocab"]:
        p = cls.gen_dir(data_dir, min_occ, max_len) / "mimic.vocab"
        if not p.exists():
            return None
        with open(p) as f:
            v = json.load(f)
        built_with = v.get("tokenizer")
        if built_with and built_with != tokenizer_name():
            log.warning(
                f"vocab at {p} was built with tokenizer '{built_with}' but "
                f"this environment resolves to '{tokenizer_name()}' — "
                f"encodings will NOT match the build environment"
            )
        return cls(v["w2i"], v["i2w"], tokenizer=built_with)
