"""The port's data modules (mopoe_mimic_tpu_torch/data) against the JAX
package's, on the CPU: the synthetic dataset byte for byte, the
``DeviceStore``'s gathered batches bit for bit (after the NHWC → NCHW
transpose of the images), the epoch orders and index matrices element for
element, ``BatchLoader``'s batches, and ``fits``."""

import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.data.device_store import DeviceStore as JaxStore
from mopoe_mimic_tpu.data.loader import BatchLoader as JaxLoader
from mopoe_mimic_tpu.data.synthetic import SyntheticMimic as JaxSynthetic
from mopoe_mimic_tpu.train.scan import epoch_index_matrix as jax_index_matrix
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.alphabet import ALPHABET
from mopoe_mimic_tpu_torch.data.device_store import DeviceStore
from mopoe_mimic_tpu_torch.data.loader import BatchLoader
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.train.scan import epoch_index_matrix

KW = dict(dataset="testing", batch_size=4, img_size=64, vocab_size=30)  # text: DATASETS
DATASETS = {
    "word": dict(text_encoding="word"),
    "char": dict(text_encoding="char"),
    "structured": dict(text_encoding="word"),
    "structured_noisy_char": dict(text_encoding="char"),
}
ROWS = 22


def datasets(case, rows=ROWS, seed=0):
    extra = {"structured": True} if case.startswith("structured") else {}
    if case == "structured_noisy_char":
        extra["noise"] = 0.3
    return (JaxSynthetic(JaxConfig(**KW, **DATASETS[case]), seed=seed, length=rows, **extra),
            SyntheticMimic(MopoeConfig(**KW, **DATASETS[case]), seed=seed, length=rows, **extra))


class UInt8Images:
    """A dataset whose image columns are uint8 (a store's raw bytes)."""

    def __init__(self, base):
        self.labels = base.labels
        self.arrays = {k: (np.round(v * 255).astype(np.uint8) if v.ndim == 4 else v)
                       for k, v in base.arrays.items()}

    def __len__(self):
        return len(self.labels)


def as_port(name, x):
    x = np.asarray(x)
    return x.transpose(0, 3, 1, 2) if name in ("PA", "Lateral") else x


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_synthetic_dataset_is_the_jax_one_byte_for_byte(case):
    j, p = datasets(case, seed=3)
    assert len(j) == len(p) and j.arrays.keys() == p.arrays.keys()
    for k in j.arrays:
        assert j.arrays[k].dtype == p.arrays[k].dtype
        assert j.arrays[k].tobytes() == p.arrays[k].tobytes(), k
    assert j.labels.tobytes() == p.labels.tobytes()
    np.testing.assert_array_equal(j.classes, p.classes)


@pytest.mark.parametrize("source", ["float", "uint8"])
@pytest.mark.parametrize("quantize", [True, False], ids=["uint8_store", "float_store"])
@pytest.mark.parametrize("text", ["word", "char"])
def test_gather_is_bitwise_the_jax_stores(source, quantize, text):
    j_ds, p_ds = datasets(text)
    if source == "uint8":
        j_ds, p_ds = UInt8Images(j_ds), UInt8Images(p_ds)
    j_cfg, p_cfg = JaxConfig(**KW, **DATASETS[text]), MopoeConfig(**KW, **DATASETS[text])
    j_store = JaxStore(j_ds, j_cfg, quantize_uint8=quantize)
    p_store = DeviceStore(p_ds, p_cfg, quantize_uint8=quantize, device="cpu")
    assert p_store.nbytes == j_store.nbytes
    assert p_store.cols["PA"].dtype == (torch.uint8 if quantize else torch.float32)
    idx = np.array([5, 0, 21, 5, 13, 2], np.int32)
    ref = {k: np.asarray(v) for k, v in j_store.gather(idx).items()}
    for got in (p_store.gather(idx), p_store.gather(torch.from_numpy(idx)),
                p_store.gather_fn(p_store.cols, torch.from_numpy(idx))):
        assert got.keys() == ref.keys()
        for k, v in got.items():
            r = as_port(k, ref[k])
            assert v.numpy().dtype == r.dtype and v.shape == r.shape, k
            assert v.numpy().tobytes() == r.tobytes(), k
    if text == "char":
        assert got["text"].shape[-1] == len(ALPHABET)


def test_dequantisation_is_the_jax_stores_for_every_byte():
    """Each of the 256 uint8 values gathers as the JAX store's does: XLA
    compiles its ``x / 255.0`` into x · float32(1/255), which differs from
    the IEEE quotient for about half of them."""
    class AllBytes:
        labels = np.zeros((256, 3), np.float32)
        arrays = {"PA": np.arange(256, dtype=np.uint8).reshape(256, 1, 1, 1)}

        def __len__(self):
            return 256

    idx = np.arange(256, dtype=np.int32)
    got = DeviceStore(AllBytes(), MopoeConfig(**KW), device="cpu").gather(idx)["PA"].numpy()
    ref = np.asarray(JaxStore(AllBytes(), JaxConfig(**KW)).gather(idx)["PA"])
    assert got.reshape(-1).tobytes() == ref.reshape(-1).tobytes()
    assert (ref.reshape(-1) == np.arange(256, dtype=np.float32) * np.float32(1 / 255)).all()


@pytest.mark.parametrize("order", ["shuffled", "unshuffled", "weighted"])
def test_epoch_order_is_the_jax_one(order):
    j_ds, p_ds = datasets("structured", rows=37)
    j_store = JaxStore(j_ds, JaxConfig(**KW, **DATASETS["structured"]))
    p_store = DeviceStore(p_ds, MopoeConfig(**KW, **DATASETS["structured"]), device="cpu")
    kw = {"shuffled": {}, "unshuffled": {"shuffle": False}, "weighted": {"weighted": True}}[order]
    for epoch, seed in ((0, 0), (3, 1), (7, 42)):
        np.testing.assert_array_equal(p_store.epoch_order(epoch, seed=seed, **kw),
                                      j_store.epoch_order(epoch, seed=seed, **kw))


@pytest.mark.parametrize("rows, batch, cap, weighted", [
    (22, 4, None, False), (22, 4, 2, False), (22, 4, None, True), (22, 5, 3, True),
    (3, 4, None, False),  # a split smaller than one batch: one wraparound-padded batch
])
def test_epoch_index_matrix_and_iter_epoch_are_the_jax_ones(rows, batch, cap, weighted):
    j_ds, p_ds = datasets("word", rows=rows)
    j_store = JaxStore(j_ds, JaxConfig(**KW, **DATASETS["word"]))
    p_store = DeviceStore(p_ds, MopoeConfig(**KW, **DATASETS["word"]), device="cpu")
    for epoch in (0, 1):
        ref = jax_index_matrix(j_store, epoch, batch, seed=5, weighted=weighted, steps_cap=cap)
        got = epoch_index_matrix(p_store, epoch, batch, seed=5, weighted=weighted, steps_cap=cap)
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
        j_batches = list(j_store.iter_epoch(epoch, batch, seed=5, weighted=weighted))
        p_batches = list(p_store.iter_epoch(epoch, batch, seed=5, weighted=weighted))
        assert len(p_batches) == len(j_batches) == max(rows // batch, 1)
        for (pb, pl), (jb, jl) in zip(p_batches, j_batches):
            np.testing.assert_array_equal(pl, jl)
            for k, v in pb.items():
                assert v.numpy().tobytes() == as_port(k, jb[k]).tobytes(), k
    if rows < batch:
        assert got.shape == (1, batch)


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False), dict(weighted=True),
                                dict(num_shards=2, shard_index=1), dict(batch_size=64)],
                         ids=["shuffled", "unshuffled", "weighted", "shard", "short"])
def test_batch_loader_is_the_jax_one_in_the_ports_layout(kw):
    j_ds, p_ds = datasets("structured", rows=40)
    kw = dict(dict(batch_size=8, seed=4, num_shards=1, shard_index=0), **kw)
    j_loader, p_loader = JaxLoader(j_ds, **kw), BatchLoader(p_ds, **kw)
    for epoch in (0, 2):
        j_loader.set_epoch(epoch)
        p_loader.set_epoch(epoch)
        assert len(p_loader) == len(j_loader)
        j_batches, p_batches = list(j_loader), list(p_loader)
        assert len(p_batches) == len(j_batches) == len(p_loader)
        for (pb, pl), (jb, jl) in zip(p_batches, j_batches):
            np.testing.assert_array_equal(pl, jl)
            for k, v in pb.items():
                assert v.flags.c_contiguous
                assert v.tobytes() == np.ascontiguousarray(as_port(k, jb[k])).tobytes(), k


def test_fits_counts_the_jax_stores_bytes():
    j_ds, p_ds = datasets("word")
    j_cfg, p_cfg = JaxConfig(**KW, **DATASETS["word"]), MopoeConfig(**KW, **DATASETS["word"])
    need = ROWS * (2 * 64 * 64 + 128 * 4)
    for budget in (need - 1, need, need + 1):
        assert DeviceStore.fits(p_ds, p_cfg, budget) == JaxStore.fits(j_ds, j_cfg, budget)
    assert DeviceStore.fits(p_ds, p_cfg, need) and not DeviceStore.fits(p_ds, p_cfg, need - 1)


def test_sharded_store_is_not_ported():
    _, p_ds = datasets("word")
    with pytest.raises(NotImplementedError):
        DeviceStore(p_ds, MopoeConfig(**KW), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        DeviceStore(p_ds, MopoeConfig(**KW), shard_rows=True, device="cpu")


def test_columns_select_a_modality():
    _, p_ds = datasets("word")
    store = DeviceStore(p_ds, MopoeConfig(**KW), columns=("PA",), device="cpu")
    assert set(store.cols) == {"PA"} and store.nbytes == ROWS * 64 * 64
    assert store.gather(np.arange(3))["PA"].shape == (3, 1, 64, 64)
