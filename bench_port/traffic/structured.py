"""Seeded, learnable MIMIC-shaped studies, made on the device in bulk.

Every study carries a class c shared by its three modalities, as the
program's structured synthetic set has it: each X-ray view shows a bright
band of rows whose position encodes c, every position of the report holds
a token drawn uniformly from the ids of its vocabulary (3517 words, or the
71-letter alphabet) that are c modulo the number of classes, and the label
one-hots c. Each signal is replaced, independently and with probability
``noise``, by that of a class drawn at random, so that the loss stays
finite and the modalities are not separable. Images are uint8 from the
start (background 0-25, band +204), word reports int32 ids, char reports
uint8 ids.

Parameters come from the cell's workload file (``traffic``): ``rows``,
``test_rows``, ``classes`` and ``noise``; sizes from the configuration.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BACKGROUND_LEVELS = 26  # 0.1 of the uint8 range
BAND_LEVEL = 204  # 0.8 of the uint8 range
LABELS = 3  # the CheXpert labels the evaluation reads
WORD_LENGTH, CHAR_LENGTH, ALPHABET = 128, 1024, 71


def studies(n: int, cfg: dict, params: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n`` studies on ``device``: PA and Lateral uint8 [n, H, W, 1], text
    ([n, 128] int32 word ids or [n, 1024] uint8 char ids), labels float32
    [n, 3], class int64 [n]."""
    gen = torch.Generator(device).manual_seed(seed)
    k, noise, h = params["classes"], params["noise"], cfg["img_size"]
    classes = torch.randint(0, k, (n,), generator=gen, device=device)

    def signal() -> torch.Tensor:
        swap = torch.rand(n, generator=gen, device=device) < noise
        return torch.where(swap, torch.randint(0, k, (n,), generator=gen, device=device),
                           classes)

    band = h // (k + 1)
    rows = torch.arange(h, device=device)
    out = {}
    for view, name in enumerate(("PA", "Lateral")):
        top = ((signal() + view) % k) * band + band // 2
        in_band = (rows[None, :] >= top[:, None]) & (rows[None, :] < top[:, None] + band)
        img = torch.randint(0, BACKGROUND_LEVELS, (n, h, h, 1), generator=gen, device=device,
                            dtype=torch.uint8)
        out[name] = img + (in_band.to(torch.uint8) * BAND_LEVEL)[:, :, None, None]
    word = cfg["text_encoding"] == "word"
    length, vocab = (WORD_LENGTH, cfg["vocab_size"]) if word else (CHAR_LENGTH, ALPHABET)
    c = signal()
    ids_of_class = (vocab - 1 - c) // k + 1  # the ids in [0, vocab) that are c modulo k
    u = torch.rand((n, length), generator=gen, device=device)
    token = c[:, None] + k * (u * ids_of_class[:, None]).long()
    out["text"] = token.to(torch.int32 if word else torch.uint8)
    labels = torch.zeros(n, LABELS, device=device)
    labels[torch.arange(n, device=device), signal() % LABELS] = 1.0
    out["labels"], out["class"] = labels, classes
    return out


class OneHotChars:
    """A char column as the program's datasets hold it, a one-hot [n, 1024,
    71] per study, kept as the [n, 1024] ids and one-hot encoded on
    reading."""

    def __init__(self, ids: np.ndarray, classes: int = ALPHABET):
        self.ids, self.classes = ids, classes
        self.shape = (*ids.shape, classes)
        self.dtype = np.dtype(np.uint8)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, idx):
        return np.eye(self.classes, dtype=np.uint8)[self.ids[idx]]


class StudySplit:
    """One split as the program's ``Experiment`` takes a dataset: column
    arrays on the host (images NHWC uint8), ``labels``, indexing by study."""

    def __init__(self, cols: Dict[str, torch.Tensor], encoding: str):
        host = {k: v.cpu().numpy() for k, v in cols.items()}
        self.labels = host.pop("labels")
        self.classes = host.pop("class")
        if encoding == "char":
            host["text"] = OneHotChars(host["text"])
        self._data = host
        self.length = len(self.labels)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self._data.items()}, self.labels[idx]

    @property
    def arrays(self):
        return self._data
