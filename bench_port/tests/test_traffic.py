"""The traffic is the seed's alone: the same seed gives the same studies,
another seed other studies of the same sizes."""

from __future__ import annotations

import torch

import _small  # noqa: F401  (paths)
from traffic.structured import studies

SIZE = {"img_size": 128, "text_encoding": "word", "vocab_size": 3517}
PARAMS = {"classes": 3, "noise": 0.2}


def test_studies_are_the_seeds():
    a, b = (studies(16, SIZE, PARAMS, 2 ** 31 + 5, "cpu") for _ in range(2))
    c = studies(16, SIZE, PARAMS, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["PA"], c["PA"])
    assert all(a[k].shape == c[k].shape for k in a)
    assert a["PA"].dtype == torch.uint8 and a["text"].dtype == torch.int32


def test_reports_span_the_vocabulary_by_class():
    for encoding, length, vocab in (("word", 128, 3517), ("char", 1024, 71)):
        s = studies(512, dict(SIZE, text_encoding=encoding), dict(PARAMS, noise=0.0),
                    2 ** 40 + 3, "cpu")
        text = s["text"].long()
        assert text.shape == (512, length)
        assert int(text.min()) == 0 and int(text.max()) == vocab - 1
        assert torch.equal(text % 3, s["class"][:, None].expand_as(text))
        assert (text != text[:, :1]).any(dim=1).all()  # positions differ within a report
