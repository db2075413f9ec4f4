"""Char codec + text decode helpers: a copy of
``mopoe_mimic_tpu/data/text_codec.py`` on the port's ``data/alphabet.py``.

Parity: mimic/utils/text.py:13-67 —
  * one_hot_encode: truncate to len_seq; shorter sequences get '$' EOS and
    '&' padding; characters outside the alphabet map to '@'.
  * tensor_to_text: argmax one-hot (or raw index) tensors back to strings
    via the alphabet (char) or the i2w vocab (word).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from mopoe_mimic_tpu_torch.data.alphabet import ALPHABET, EOS_CHAR, PAD_CHAR, UNK_CHAR


def one_hot_encode(len_seq: int, seq: str, alphabet: str = ALPHABET) -> np.ndarray:
    """[len_seq, |alphabet|] float32 one-hot of the (lowercased) text."""
    x = np.zeros((len_seq, len(alphabet)), dtype=np.float32)
    if len(seq) > len_seq:
        seq = seq[:len_seq]
    elif len(seq) < len_seq:
        seq = (seq + EOS_CHAR).ljust(len_seq, PAD_CHAR)
    unk = alphabet.index(UNK_CHAR)
    for i, ch in enumerate(seq):
        j = alphabet.find(ch)
        x[i, j if j != -1 else unk] = 1.0
    return x


def char_ids_encode(len_seq: int, seq: str, alphabet: str = ALPHABET) -> np.ndarray:
    """[len_seq] uint8 alphabet ids — exactly argmax(one_hot_encode(...)):
    same truncate / '$' EOS / '&' pad / '@' unknown semantics, 71× smaller
    (the compact form DeviceStore parks in HBM and one-hots on device)."""
    if len(seq) > len_seq:
        seq = seq[:len_seq]
    elif len(seq) < len_seq:
        seq = (seq + EOS_CHAR).ljust(len_seq, PAD_CHAR)
    unk = alphabet.index(UNK_CHAR)
    out = np.empty((len_seq,), dtype=np.uint8)
    for i, ch in enumerate(seq):
        j = alphabet.find(ch)
        out[i] = j if j != -1 else unk
    return out


def char_indices_to_text(indices: Sequence[int], alphabet: str = ALPHABET) -> str:
    return "".join(alphabet[int(i)] for i in indices)


def tensor_to_text(
    gen_t: np.ndarray, one_hot: bool = True, alphabet: str = ALPHABET,
    i2w=None,
) -> Union[List[List[str]], List[str]]:
    """One-hot/prob tensors or index arrays → per-sample token lists
    (tensor_to_text, mimic/utils/text.py:51-67)."""
    gen_t = np.asarray(gen_t)
    if one_hot:
        gen_t = np.argmax(gen_t, axis=-1)
    if gen_t.ndim == 1:
        gen_t = gen_t[None]
    gen_t = gen_t.astype(np.int64)
    # vectorized decode: one fancy index over a token table instead of a
    # Python dict lookup per token (the BLEU decode was a dominant host
    # cost of eval rounds on a 1-core box, VERDICT r2 #3)
    if i2w is not None:
        hi = int(gen_t.max(initial=0))
        table = np.array(
            [i2w.get(str(i), UNK_CHAR) for i in range(hi + 1)], dtype=object
        )
    else:
        table = np.array(list(alphabet), dtype=object)
    rows = table[gen_t]
    return [list(r) for r in rows]


def tensor_to_tokens(cfg, exp, t: np.ndarray, probs: bool) -> List[List[str]]:
    """Decode a batch of generated (probs=True) or target text tensors to
    token lists for BLEU."""
    if cfg.text_encoding == "word":
        i2w = getattr(getattr(exp, "dataset_train", None), "i2w", None)
        if i2w is None:
            i2w = {str(i): f"w{i}" for i in range(cfg.vocab_size)}
        idx = np.argmax(t, axis=-1) if (probs and t.ndim == 3) else t
        return [[i2w.get(str(int(i)), UNK_CHAR) for i in row] for row in idx.astype(np.int64)]
    # char: accept either one-hot/prob [B,L,A] or pre-argmaxed id [B,L]
    toks = tensor_to_text(t, one_hot=(np.asarray(t).ndim == 3))
    # char mode: split decoded strings into words for corpus BLEU
    return [
        "".join(row).split() for row in toks
    ]
