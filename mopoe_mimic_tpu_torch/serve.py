"""Inference: encode / generate / conditional generation with batch-size
bucketing, on a CUDA device (the default) or, when asked, the CPU.

Port of ``mopoe_mimic_tpu/serve.py``'s ``InferenceSession``. Requests are
split into chunks of at most the largest bucket, and each chunk is padded
up to the nearest bucket by repeating its last row (``_pad_rows``), as in
the JAX session: the joint mixture picks each row's component from a
partition of the padded batch, so padding the same way gives the same
joint. The session takes and returns the JAX session's layouts: images
NHWC [B, H, W, C], text ids [B, L] in and probabilities [B, L, V] out.

Random draws come from a ``torch.Generator`` on the session's device,
seeded from (seed, chunk index): deterministic for a seed, but not the
JAX session's stream (``fold_in(PRNGKey(seed), chunk)``).

``compute_dtype="bfloat16"`` runs convolutions and linears under
``torch.autocast(bfloat16)`` with BatchNorm in float32; the posteriors are
float32 before fusion either way. Outputs are float32 numpy arrays, or
with ``compact=True`` the wire format: text as int32 argmax ids and images
as uint8.

CLI:
    python -m mopoe_mimic_tpu_torch.serve --config CONFIG.json \
        --weights W.pt --mode generate --num_samples 16 --device cuda --out OUT_DIR
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

    cfg: the model's configuration (``MopoeConfig``, as a JAX run writes it).
    state_dict: the port's weights (reference key names); None keeps the
        model's own initialisation.
    device: where the model runs ("cuda", the default, "cuda:1", ... or
        "cpu" when asked for).
    buckets: allowed static batch sizes; requests pad up to the nearest.
    """

    def __init__(
        self,
        cfg: MopoeConfig,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        device: str | torch.device = "cuda",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.buckets = tuple(sorted(buckets))
        self.model = MMVae(cfg)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

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
        """Slice, pad to the bucket, move to the device, NHWC → NCHW."""
        out = {}
        for m, v in batch.items():
            arr = _pad_rows(np.asarray(v)[start:start + take], bucket)
            if m == "text":
                if self.cfg.text_encoding != "word":
                    raise NotImplementedError("only word text encoding is ported")
                t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64))
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


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Generate samples with the PyTorch port.")
    ap.add_argument("--config", required=True, help="MopoeConfig JSON (a run's config.json)")
    ap.add_argument("--weights", required=True, help="state_dict saved with torch.save")
    ap.add_argument("--mode", choices=("generate",), default="generate")
    ap.add_argument("--num_samples", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the card (default), or cpu when asked for; no fallback")
    ap.add_argument("--compact", action="store_true",
                    help="wire format: text as int32 ids (text_ids.npy), images as uint8")
    ap.add_argument("--out", required=True, help="output directory")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    cfg = MopoeConfig.from_json(args.config)
    state_dict = torch.load(args.weights, map_location="cpu", weights_only=True)
    sess = InferenceSession(cfg, state_dict=state_dict, device=args.device)
    samples = sess.generate(args.num_samples, seed=args.seed, compact=args.compact)
    os.makedirs(args.out, exist_ok=True)
    for m, data in samples.items():
        if m == "text":
            name = "text_ids.npy" if args.compact else "text_probs.npy"
        else:
            name = f"{m}.npy"
        np.save(os.path.join(args.out, name), data)
    print(f"wrote {args.num_samples} samples to {args.out}")


if __name__ == "__main__":
    main()
