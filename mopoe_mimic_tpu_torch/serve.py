"""Inference: encode / generate / conditional generation with batch-size
bucketing, on a CUDA device (the default) or, when asked, the CPU.

Port of ``mopoe_mimic_tpu/serve.py``'s ``InferenceSession``. A session
serves a run directory that the training CLI wrote (``config.json`` and
``checkpoints/``): the epoch asked for, else the best by test loss, else
the latest (serve.py:54-117 of the JAX package); or a config and a
state_dict. Requests are split into chunks of at most the largest bucket,
and each chunk is padded up to the nearest bucket by repeating its last
row (``_pad_rows``), as in the JAX session: the joint mixture picks each
row's component from a partition of the padded batch, so padding the same
way gives the same joint. The session takes and returns the JAX session's
layouts: images NHWC [B, H, W, C]; text as word ids [B, L] or, under
``text_encoding="char"``, a float one-hot [B, 1024, 71] in, and
probabilities [B, L, classes] out. ``text_array`` and ``decode_text``
convert raw reports and generated text (serve.py:354-402 of the JAX
package).

Random draws come from a ``torch.Generator`` on the session's device,
seeded from (seed, chunk index): deterministic for a seed, but not the
JAX session's stream (``fold_in(PRNGKey(seed), chunk)``).

``compute_dtype="bfloat16"`` runs convolutions and linears under
``torch.autocast(bfloat16)`` with BatchNorm in float32; the posteriors are
float32 before fusion either way. Outputs are float32 numpy arrays, or
with ``compact=True`` the wire format: text as int32 argmax ids and images
as uint8.

CLI (images as PNG grids, text as ``text_probs.npy`` or, with
``--compact``, ``text_ids.npy``):
    python -m mopoe_mimic_tpu_torch.serve --run_dir RUN_DIR [--epoch N] \
        --num_samples 16 [--out OUT_DIR] [--device cuda]
    python -m mopoe_mimic_tpu_torch.serve --config CONFIG.json --weights W.pt \
        --out OUT_DIR
``--mode export`` is not ported: the kernels are loaded through ctypes
(``ops/_build.py``), which ``torch.export`` cannot trace.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.utils.logger import log

DEFAULT_BUCKETS = (1, 8, 32, 128)


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    if len(arr) == n:
        return arr
    pad = np.repeat(arr[-1:], n - len(arr), axis=0)
    return np.concatenate([arr, pad], axis=0)


def chunk_seed(seed: int, chunk: int) -> int:
    """A 63-bit generator seed from (seed, chunk index)."""
    words = np.random.SeedSequence([seed, chunk]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


class InferenceSession:
    """Weights → bucketed inference endpoints on one device.

    cfg: the model's configuration (``MopoeConfig``), with ``state_dict``
        the port's weights (reference key names); None keeps the model's
        own initialisation. Or:
    run_dir: a run directory of the training CLI: ``config.json`` (the
        fields ``MopoeConfig`` knows) and the checkpoint of ``epoch``, by
        default the best by test loss, else the latest.
    device: where the model runs ("cuda", the default, "cuda:1", ... or
        "cpu" when asked for).
    buckets: allowed static batch sizes; requests pad up to the nearest.
    """

    def __init__(
        self,
        cfg: Optional[MopoeConfig] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device: str | torch.device = "cuda",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        run_dir: Optional[str] = None,
        epoch: Optional[int] = None,
    ):
        self.epoch = -1
        if run_dir is not None:
            if cfg is not None or state_dict is not None:
                raise ValueError("pass run_dir, or cfg (and state_dict), not both")
            cfg, state_dict = self._restore(run_dir, epoch)
        elif cfg is None:
            raise ValueError("need run_dir or cfg")
        self.cfg = cfg
        self.device = torch.device(device)
        self.buckets = tuple(sorted(buckets))
        self.model = MMVae(cfg)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    def _restore(self, run_dir: str, epoch: Optional[int]):
        """(cfg, weights) of a run directory; sets ``self.epoch``."""
        from mopoe_mimic_tpu_torch.utils.checkpoints import CheckpointManager

        cfg = MopoeConfig.from_json(os.path.join(run_dir, "config.json"))
        mgr = CheckpointManager(os.path.join(run_dir, "checkpoints"))
        if epoch is None:
            epoch = mgr.best_epoch()
            if epoch is None:
                epoch = mgr.latest_epoch()
        self.epoch, payload = mgr.read(epoch)
        log.info(f"serving epoch {self.epoch} from {mgr.directory}")
        return cfg, payload["model"]

    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _chunks(self, n: int) -> Iterator[Tuple[int, int, int]]:
        """(start, rows, bucket) of each bucket-sized chunk of n rows."""
        done = 0
        while done < n:
            take = min(n - done, self.buckets[-1])
            yield done, take, self._bucket(take)
            done += take

    def _context(self):
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self.cfg.compute_dtype == "bfloat16":
            stack.enter_context(torch.autocast(self.device.type, dtype=torch.bfloat16))
        elif self.cfg.compute_dtype not in ("float32", None, ""):
            raise NotImplementedError(f"compute_dtype {self.cfg.compute_dtype!r}")
        return stack

    def _generator(self, seed: int, chunk: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(chunk_seed(seed, chunk))
        return gen

    def _inputs(self, batch: Mapping[str, np.ndarray], start: int, take: int,
                bucket: int) -> Dict[str, torch.Tensor]:
        """Slice, pad to the bucket, move to the device, NHWC → NCHW; word
        text as int64 ids, char text as a float32 one-hot."""
        out = {}
        for m, v in batch.items():
            arr = _pad_rows(np.asarray(v)[start:start + take], bucket)
            if m == "text":
                dtype = np.int64 if self.cfg.text_encoding == "word" else np.float32
                t = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
            else:
                t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).permute(0, 3, 1, 2)
            out[m] = t.to(self.device, non_blocking=True).contiguous()
        return out

    @staticmethod
    def _outputs(mods: Mapping[str, torch.Tensor], take: int, compact: bool) -> Dict[str, np.ndarray]:
        """Generated likelihood means → host numpy in the session's layouts;
        ``compact`` converts on the device first (text → argmax ids,
        images → uint8)."""
        out = {}
        for m, v in mods.items():
            v = v[:take]
            if m == "text":
                v = torch.argmax(v, dim=-1).to(torch.int32) if compact else v.float()
            else:
                v = v.float().permute(0, 2, 3, 1)
                if compact:
                    v = torch.clamp(v * 255.0 + 0.5, 0, 255).to(torch.uint8)
            out[m] = v.cpu().numpy()
        return out

    @staticmethod
    def _merge(merged: Optional[Any], part: Any) -> Any:
        if merged is None:
            return part
        if isinstance(part, Mapping):
            return {k: InferenceSession._merge(merged[k], v) for k, v in part.items()}
        if isinstance(part, tuple):
            return tuple(InferenceSession._merge(a, b) for a, b in zip(merged, part))
        return np.concatenate([merged, part])

    # ------------------------------------------------------------------
    # endpoints
    # ------------------------------------------------------------------

    def generate(self, num_samples: int, seed: int = 0, compact: bool = False) -> Dict[str, np.ndarray]:
        """Unconditional samples from the prior: modality → array."""
        merged = None
        with self._context():
            for chunk, (_start, take, bucket) in enumerate(self._chunks(num_samples)):
                mods = self.model.generate(bucket, generator=self._generator(seed, chunk))
                merged = self._merge(merged, self._outputs(mods, take, compact))
        return merged

    def encode(self, batch: Mapping[str, np.ndarray]) -> Dict[str, Any]:
        """Posterior parameters {'subsets': {key: (mu, logvar)},
        'joint': (mu, logvar)} for every subset of the given modalities."""
        n = len(next(iter(batch.values())))
        merged = None
        with self._context():
            for start, take, bucket in self._chunks(n):
                lat = self.model.inference(self._inputs(batch, start, take, bucket))
                part = {
                    "subsets": {k: (mu[:take].cpu().numpy(), lv[:take].cpu().numpy())
                                for k, (mu, lv) in lat["subsets"].items()},
                    "joint": tuple(x[:take].cpu().numpy() for x in lat["joint"]),
                }
                merged = self._merge(merged, part)
        return merged

    def cond_generate(self, batch: Mapping[str, np.ndarray], seed: int = 0,
                      compact: bool = False) -> Dict[str, Dict[str, np.ndarray]]:
        """Conditional generation from every subset posterior of the batch:
        subset key → modality → array."""
        n = len(next(iter(batch.values())))
        merged = None
        with self._context():
            for chunk, (start, take, bucket) in enumerate(self._chunks(n)):
                lat = self.model.inference(self._inputs(batch, start, take, bucket))
                out = self.model.cond_generation(lat["subsets"],
                                                 generator=self._generator(seed, chunk))
                part = {s: self._outputs(mods, take, compact) for s, mods in out.items()}
                merged = self._merge(merged, part)
        return merged


    # ------------------------------------------------------------------
    # raw-input helpers (the codecs of the training data, on the session)
    # ------------------------------------------------------------------

    def _vocab(self):
        """The persisted vocabulary of a word-mode model, next to its
        training data under ``cfg.dir_data``."""
        from mopoe_mimic_tpu_torch.data.vocab import Vocab

        cfg = self.cfg
        base = os.path.join(os.path.expanduser(cfg.dir_data), f"files_small_{cfg.img_size}")
        vocab = Vocab.load(base, cfg.word_min_occ, cfg.len_sequence)
        if vocab is None:
            raise FileNotFoundError(f"no persisted vocabulary under {base}; serve word-mode "
                                    "models next to their training data")
        return vocab

    def text_array(self, reports: Sequence[str]) -> np.ndarray:
        """Raw report strings → the model's text input: word ids [N, L]
        int32 through the persisted vocabulary, or char one-hots
        [N, 1024, 71] float32 of the lowercased reports."""
        cfg = self.cfg
        if cfg.text_encoding == "word":
            vocab = self._vocab()
            return np.stack([vocab.encode(str(t), cfg.len_sequence)
                             for t in reports]).astype(np.int32)
        from mopoe_mimic_tpu_torch.data.text_codec import one_hot_encode

        return np.stack([one_hot_encode(cfg.len_sequence, str(t).lower()) for t in reports])

    def decode_text(self, probs: np.ndarray, i2w=None) -> list:
        """Generated text probabilities, or compact int ids → strings
        (char) or token lists (word; the vocabulary's ``i2w`` unless given)."""
        from mopoe_mimic_tpu_torch.data.text_codec import tensor_to_text

        probs = np.asarray(probs)
        one_hot = not np.issubdtype(probs.dtype, np.integer)
        if self.cfg.text_encoding == "char":
            return ["".join(r) for r in tensor_to_text(probs, one_hot=one_hot)]
        if i2w is None:
            i2w = self._vocab().i2w
        return tensor_to_text(probs, one_hot=one_hot, i2w=i2w)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

EXPORT_REFUSAL = ("--mode export is not ported: the port's kernels are loaded through ctypes "
                  "(ops/_build.py), which torch.export cannot trace; export needs them "
                  "registered as torch.library custom ops first")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Generate samples with the PyTorch port.")
    source = ap.add_mutually_exclusive_group(required=True)
    source.add_argument("--run_dir", help="a run directory of the training CLI")
    source.add_argument("--config", help="MopoeConfig JSON (a run's config.json), with --weights")
    ap.add_argument("--weights", help="state_dict saved with torch.save (with --config)")
    ap.add_argument("--epoch", type=int, default=None,
                    help="the checkpoint to serve (default: the best by test loss, else the "
                    "latest)")
    ap.add_argument("--mode", choices=("generate", "export"), default="generate")
    ap.add_argument("--num_samples", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card (default), or cpu when asked for; no fallback")
    ap.add_argument("--compact", action="store_true",
                    help="wire format: text as int32 ids (text_ids.npy), images as uint8")
    ap.add_argument("--out", default=None, help="output directory (default: RUN_DIR/serving)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode == "export":
        raise NotImplementedError(EXPORT_REFUSAL)
    if args.config is not None:
        if args.weights is None or args.epoch is not None or args.out is None:
            ap.error("--config takes --weights and --out, and no --epoch")
        cfg = MopoeConfig.from_json(args.config)
        state_dict = torch.load(args.weights, map_location="cpu", weights_only=True)
        sess = InferenceSession(cfg, state_dict=state_dict, device=args.device)
    else:
        if args.weights is not None:
            ap.error("--weights goes with --config")
        sess = InferenceSession(run_dir=args.run_dir, epoch=args.epoch, device=args.device)
    out_dir = args.out or os.path.join(args.run_dir, "serving")
    os.makedirs(out_dir, exist_ok=True)
    samples = sess.generate(args.num_samples, seed=args.seed, compact=args.compact)
    from mopoe_mimic_tpu_torch.utils.save_samples import write_samples_img_to_file

    for m, data in samples.items():
        if m == "text":
            np.save(os.path.join(out_dir, "text_ids.npy" if args.compact else "text_probs.npy"),
                    data)
        else:
            write_samples_img_to_file(data, os.path.join(out_dir, f"{m}.png"))
    log.info(f"wrote {args.num_samples} samples to {out_dir}")


if __name__ == "__main__":
    main()
