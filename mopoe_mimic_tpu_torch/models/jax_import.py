"""JAX MMVae variables → a PyTorch ``state_dict`` for the port's MMVae.

The inverse of ``convert_mopoe_state_dict``
(mopoe_mimic_tpu/models/torch_import.py:157), numpy only. It takes
``{"params": ..., "batch_stats": ...}`` as nested dicts of arrays (what
``jax.device_get`` returns for a trained state) and inverts each layout
rule:

  * Conv{1,2}d       flax (k…, I, O)  → (O, I, k…)
  * ConvTranspose    flax (k…, I, O)  → (I, O, k…), then un-flip the
                     spatial axes (the JAX layer is a correlation with the
                     flipped kernel)
  * Linear           (I, O) → (O, I);  Embedding unchanged
  * BatchNorm        scale/bias → weight/bias, batch_stats mean/var →
                     running_mean/running_var, num_batches_tracked = 0
  * decoders         ``resblock_{i}`` → ``generator.{i-1}.0``,
                     ``conv_out`` → ``generator.{n_blocks}``; the char text
                     generator keeps its names (``resblock_{i}.0``, ``conv2``)
  * shortcuts        ``shortcut_conv`` / ``shortcut_bn`` →
                     ``downsample.{0,1}`` (encoders), ``upsample.{0,1}`` (decoders)

The text head's layout depends on the configuration, as the JAX side's
``short_word`` switch does (torch_import.py:177, :227-238 of the JAX
package): ``text_generator/conv_out`` is a plain Conv1d for word text at
``len_sequence`` ≤ 500 and a ConvTranspose1d at ≥ 512; char's ``conv2`` is
a ConvTranspose1d. ``cfg`` needs only ``text_encoding`` and
``len_sequence``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_TOP = {
    "encoder_PA": "encoder_pa", "decoder_PA": "decoder_pa",
    "encoder_Lateral": "encoder_lat", "decoder_Lateral": "decoder_lat",
    "encoder_text": "encoder_text", "decoder_text": "decoder_text",
}
_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _conv_w(k: np.ndarray) -> np.ndarray:
    """flax (k…, I, O) → torch Conv (O, I, k…)."""
    return np.transpose(k, (3, 2, 0, 1) if k.ndim == 4 else (2, 1, 0))


def _convT_w(k: np.ndarray) -> np.ndarray:
    """flax TorchConvTranspose (k…, I, O) → torch ConvTranspose (I, O, k…)."""
    if k.ndim == 4:
        return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return np.transpose(k, (1, 2, 0))[:, :, ::-1]


def _block_key(sub: str, shortcut: str) -> str:
    return {"shortcut_conv": f"{shortcut}.0", "shortcut_bn": f"{shortcut}.1"}.get(sub, sub)


def state_dict_from_jax(variables: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a JAX MMVae → the port's state_dict."""
    char = cfg.text_encoding == "char"
    short_word = cfg.text_encoding == "word" and cfg.len_sequence <= 500
    params = variables["params"]
    n_gen_blocks = {
        (top, gen): sum(1 for name in params[top][gen] if name.startswith("resblock_"))
        for top in params for gen in ("img_generator", "text_generator")
        if gen in params[top]
    }
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params):
        top, group, rest = path[0], path[1], path[2:]
        base = _TOP[top]
        leaf = rest[-1] if rest else None
        if group == "feature_compressor":  # content_mu / content_logvar
            name = {"kernel": "weight", "bias": "bias"}[leaf]
            out[f"{base}.feature_compressor.{rest[0]}.{name}"] = arr.T if leaf == "kernel" else arr
        elif group == "feature_generator":
            name = {"kernel": "weight", "bias": "bias"}[rest[0]]
            out[f"{base}.feature_generator.{name}"] = arr.T if rest[0] == "kernel" else arr
        elif group == "feature_extractor":
            mod = rest[0]
            if mod == "embedding":
                out[f"{base}.feature_extractor.embedding.weight"] = arr
            elif mod == "conv1":
                name = {"kernel": "weight", "bias": "bias"}[leaf]
                out[f"{base}.feature_extractor.conv1.{name}"] = _conv_w(arr) if leaf == "kernel" else arr
            else:
                key = f"{base}.feature_extractor.{mod}.0.{_block_key(rest[1], 'downsample')}"
                _put_block_leaf(out, key, rest[1], leaf, arr, transpose=False)
        elif group in ("img_generator", "text_generator"):
            mod = rest[0]
            gen = f"{base}.{group}.generator"
            if mod in ("conv_out", "conv2"):  # the output layer (conv2: char's)
                name = {"kernel": "weight", "bias": "bias"}[leaf]
                plain = group == "text_generator" and short_word  # word@128: Conv1d(k1)
                if leaf == "kernel":
                    arr = _conv_w(arr) if plain else _convT_w(arr)
                key = (f"{base}.{group}.conv2" if mod == "conv2" else
                       f"{gen}.{n_gen_blocks[(top, group)]}")
                out[f"{key}.{name}"] = arr
            else:
                key = _generator_block(base, group, mod, char)
                key = f"{key}.{_block_key(rest[1], 'upsample')}"
                _put_block_leaf(out, key, rest[1], leaf, arr, transpose=True)
        else:
            raise KeyError(f"unrecognized module group in {'/'.join(path)}")

    for path, arr in _flatten(variables.get("batch_stats", {})):
        top, group, mod, sub, leaf = path[0], path[1], path[2], path[3], path[4]
        base = _TOP[top]
        if group == "feature_extractor":
            key = f"{base}.feature_extractor.{mod}.0.{_block_key(sub, 'downsample')}"
        else:
            key = f"{_generator_block(base, group, mod, char)}.{_block_key(sub, 'upsample')}"
        out[f"{key}.{_BN_STAT[leaf]}"] = arr
        if leaf == "mean":
            out[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)
    # a fresh C-order copy: flipped views can keep negative strides even when
    # numpy deems them contiguous (size-1 axes), which torch refuses
    return {k: torch.from_numpy(np.array(v, order="C", copy=True)) for k, v in out.items()}


def _generator_block(base: str, group: str, mod: str, char: bool) -> str:
    """A decoder's ``resblock_{i}`` → its key prefix in the port: named in
    the char text generator, an index of the ``Sequential`` otherwise."""
    if char and group == "text_generator":
        return f"{base}.{group}.{mod}.0"
    return f"{base}.{group}.generator.{int(mod.split('_')[1]) - 1}.0"


def _put_block_leaf(out, key, sub, leaf, arr, transpose: bool) -> None:
    if sub.startswith("bn") or sub == "shortcut_bn":
        out[f"{key}.{_BN_PARAM[leaf]}"] = arr
        return
    name = {"kernel": "weight", "bias": "bias"}[leaf]
    if leaf == "kernel":
        # the 1×1 conv1 of a transpose block is a ConvTranspose too
        arr = _convT_w(arr) if transpose else _conv_w(arr)
    out[f"{key}.{name}"] = arr
