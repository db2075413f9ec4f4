"""The eval round's sample grids (``mopoe_mimic_tpu/utils/plotting.py``;
reference generate_plots at mimic/utils/plotting.py:10-182): random samples
of every modality, and per input subset the conditionally generated
modalities; text rendered to images with PIL where PIL imports, else as
blank frames, as the JAX package renders it.

``collect_plot_arrays`` is the device part: it generates at most 8 rows (the
grids show no more), argmaxes the text on the card and brings the arrays to
the host in one go (a few MB). ``render_plot_arrays`` is pure host work on
numpy (tiling, text rendering, the PNG files of ``utils/save_samples.py``
when ``cfg.save_figure``), which the eval round hands to the experiment's
worker thread: that thread touches no CUDA, so a CUDA-graph capture on the
main thread never meets its calls. The style-swap grids of factorized
representations are not ported (the model refuses style dims).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from mopoe_mimic_tpu_torch.data.text_codec import tensor_to_tokens
from mopoe_mimic_tpu_torch.train.step import eval_mode, to_device
from mopoe_mimic_tpu_torch.utils.save_samples import _to_grid, png_bytes

SEED_OFFSET = 71  # the grids' generator is seeded cfg.seed + 71 (plotting.py:149)
PLOT_DIRS = {"random": "plot_random", "cond_gen": "plot_cond"}  # the run's directories


def text_to_pil(tokens, size=(128, 128), font_path: Optional[str] = None) -> np.ndarray:
    """Render decoded text to an [H, W, 3] image in [0, 1] (plot.py:30-67);
    a blank frame where PIL or its font is unavailable."""
    try:
        from PIL import Image, ImageDraw, ImageFont

        img = Image.new("RGB", size, (255, 255, 255))
        draw = ImageDraw.Draw(img)
        try:
            font = ImageFont.truetype(font_path, 10) if font_path else ImageFont.load_default()
        except OSError:
            font = ImageFont.load_default()
        text = "".join(tokens) if isinstance(tokens, (list, tuple)) else str(tokens)
        width = 24  # a crude wrap
        lines = [text[i: i + width] for i in range(0, min(len(text), width * 12), width)]
        draw.multiline_text((2, 2), "\n".join(lines), fill=(0, 0, 0), font=font)
        return np.asarray(img, dtype=np.float32) / 255.0
    except Exception:
        return np.ones((*size, 3), dtype=np.float32)


def _modality_frames(cfg, exp, m: str, data: np.ndarray, n: int, size=None) -> np.ndarray:
    """A modality's frames [n, H, W, C]: images as they are, text rendered
    (at ``size`` where given, so that text rows fit the image grids)."""
    if m != "text":
        return np.asarray(data[:n])
    toks = tensor_to_tokens(cfg, exp, np.asarray(data[:n]), probs=True)
    return np.stack([text_to_pil(t, size=size or (128, 128)) for t in toks])


def _to_rgb(frames: np.ndarray) -> np.ndarray:
    """[N, H, W, C] → [N, H, W, 3] (grayscale repeated)."""
    if frames.shape[-1] == 3:
        return frames
    return np.repeat(frames[..., :1], 3, axis=-1)


def _host(out: Dict[str, torch.Tensor], rows: int) -> Dict[str, np.ndarray]:
    """The first ``rows`` rows of each modality on the host: images NHWC
    float32, text as argmaxed ids."""
    host = {}
    for m, v in out.items():
        v = v[:rows]
        if m == "text":
            host[m] = v.argmax(dim=-1).to(torch.int32).cpu().numpy()
        else:
            host[m] = v.float().permute(0, 2, 3, 1).cpu().numpy()
    return host


def collect_plot_arrays(exp, state, epoch: int) -> Dict[str, Any]:
    """The grids' samples on the host: ``gen`` (random, from N(0, I)) and
    ``cond`` (per subset, conditioned on the first rows of the first test
    batch), at most 8 rows each, from a generator seeded ``cfg.seed + 71``."""
    cfg, model = exp.cfg, state.model
    param = next(model.parameters())
    rows = min(cfg.batch_size, 8)
    generator = torch.Generator(param.device).manual_seed((cfg.seed or 0) + SEED_OFFSET)
    test_batch, _ = next(iter(exp.eval_batches("test")))
    with eval_mode(cfg, model):
        data: Dict[str, Any] = {"gen": _host(model.generate(rows, generator=generator), rows)}
        # eval mode: BN running statistics, so slicing before inference is exact
        batch = to_device({k: v[:rows] for k, v in test_batch.items()}, param)
        latents = model.inference(batch)
        cond = model.cond_generation(latents["subsets"], generator=generator)
        data["cond"] = {s: _host(mods, rows) for s, mods in cond.items()}
    return data


def render_plot_arrays(exp, data: Dict[str, Any], epoch: int) -> Dict[str, np.ndarray]:
    """The grids, [H, W, C] in [0, 1] by tag (``random/<modality>``,
    ``cond_gen/<subset>``), saved as PNG files under the run's plots/ tree
    when ``cfg.save_figure``. Host work only."""
    cfg = exp.cfg
    n = min(cfg.batch_size, 8)
    plots: Dict[str, np.ndarray] = {}
    for m in cfg.modality_names:
        plots[f"random/{m}"] = _to_grid(
            _modality_frames(cfg, exp, m, data["gen"][m], n if m != "text" else 4),
            per_row=2 if m == "text" else 8)
    # per input subset, one row per generated modality, text rendered at the
    # image size and grayscale lifted to RGB (mimic/utils/plot.py:30-67)
    for s_key, per_mod in (data.get("cond") or {}).items():
        rows = [_to_rgb(_modality_frames(cfg, exp, m, per_mod[m], 4,
                                         size=(cfg.img_size, cfg.img_size)))
                for m in cfg.modality_names]
        plots[f"cond_gen/{s_key}"] = _to_grid(np.concatenate(rows), per_row=4)
    _save_figures(exp, plots, epoch)
    return plots


def _save_figures(exp, plots: Dict[str, np.ndarray], epoch: int) -> None:
    """With ``cfg.save_figure``: each grid as plots/{random_samples,
    cond_gen}/<tag>_<epoch>.png."""
    if not exp.cfg.save_figure:
        return
    for tag, img in plots.items():
        arr = (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0).round().astype(np.uint8)
        path = os.path.join(exp.paths[PLOT_DIRS[tag.split("/", 1)[0]]],
                            f"{tag.replace('/', '_')}_{epoch}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(png_bytes(arr))
