"""Generation coherence (``mopoe_mimic_tpu/evaluation/coherence.py``;
reference mimic/evaluation/eval_metrics/coherence.py:36-324).

* Random generation: decode draws from N(0, I) in every modality and
  classify each with its CheXpert-label classifier; a sample is coherent
  when every modality's argmaxed prediction agrees (calculate_coherence,
  :87-112). The rate is per batch, averaged over the batches.
* Conditional generation: for every subset posterior, generate every
  modality and score the classifiers' probabilities against the true
  labels, one average precision per (label, subset, modality) over the
  whole pass (:204-293).
* Generated text: BLEU-1..4 and the common words against the reference
  report, per subset (:296-311).

Generation (K1's forward in ``inference``) and classification stay on the
card; the probabilities, the generated token ids and the reference ids
come to the host once, after the last batch. The noise comes from a
generator seeded ``cfg.seed + 47``: each batch draws the random latents,
then each subset's conditional noise in order. The spans
``coherence.device`` (the batches and the one trip), ``coherence.ap`` and
``coherence.bleu`` time the pass for its log line.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from mopoe_mimic_tpu_torch.evaluation.bleu import (
    build_ref_tables,
    corpus_bleu,
    corpus_bleu_ids,
    nbr_common_words,
    nbr_common_words_ids,
)
from mopoe_mimic_tpu_torch.evaluation.metrics import eval_label_ap
from mopoe_mimic_tpu_torch.train.step import eval_mode, to_device
from mopoe_mimic_tpu_torch.utils import profiling
from mopoe_mimic_tpu_torch.utils.logger import log

SEED_OFFSET = 47  # the pass's generator is seeded cfg.seed + 47 (coherence.py:116)


def transform_gen_samples(cfg, modality: str, x: torch.Tensor) -> torch.Tensor:
    """Generated samples in the classifier's input form
    (transform_gen_samples, coherence.py:115-125): word text is generated as
    per-position vocabulary probabilities, the word classifier reads token
    ids, so argmax; everything else as it is."""
    if modality == "text" and cfg.text_encoding == "word" and x.dim() == 3:
        return torch.argmax(x, dim=-1).to(torch.int32)
    return x


class CoherenceEvaluator:
    """The classifier of each modality (``nn.Module``s in eval mode)."""

    def __init__(self, cfg, classifiers: Mapping[str, torch.nn.Module]):
        self.cfg = cfg
        self.classifiers = dict(classifiers)

    def predict(self, modality: str, x) -> torch.Tensor:
        """Probabilities [B, n_labels], float32, on the classifier's device:
        the classifiers run in float32 whatever the VAE's autocast."""
        clf = self.classifiers[modality]
        param = next(clf.parameters())
        x = transform_gen_samples(self.cfg, modality, torch.as_tensor(x, device=param.device))
        if x.is_floating_point():
            x = x.float()
        with torch.no_grad(), torch.autocast(param.device.type, enabled=False):
            return clf(x)

    # -- random generation coherence ------------------------------------
    def coherence_rate(self, samples: Mapping[str, Any]) -> torch.Tensor:
        """The share of samples whose modalities' argmaxed predictions all
        agree (0-d, on the device)."""
        preds = torch.stack([torch.argmax(torch.nan_to_num(self.predict(m, samples[m])), dim=1)
                             for m in self.cfg.modality_names])  # [M, B]
        return torch.all(preds == preds[:1], dim=0).float().mean()

    def calculate_coherence(self, samples: Mapping[str, Any], labels_names) -> Dict[str, float]:
        rate = float(self.coherence_rate(samples))
        return {label: rate for label in labels_names}

    # -- conditional generation -------------------------------------------
    def predict_cond_probs(self, cond_samples: Mapping[str, Mapping[str, Any]]
                           ) -> Dict[str, Dict[str, np.ndarray]]:
        """The classifiers' probabilities per (subset, modality) for one batch
        of conditionally generated samples."""
        return {s: {m: torch.nan_to_num(self.predict(m, gen[m])).cpu().numpy()
                    for m in self.cfg.modality_names}
                for s, gen in cond_samples.items()}

    def cond_ap(self, probs: Mapping[str, Mapping[str, np.ndarray]], labels: np.ndarray,
                labels_names) -> Dict[str, Dict[str, Dict[str, float]]]:
        """{label: {subset: {modality: AP}}} over the whole accumulated pass:
        one average precision per triple, as the reference's
        eval_classified_gen_samples (coherence.py:204-224)."""
        out = {label: {s: {} for s in probs} for label in labels_names}
        for s_key, per_mod in probs.items():
            for m, p in per_mod.items():
                for li, l_key in enumerate(labels_names):
                    out[l_key][s_key][m] = eval_label_ap(p, labels, li)
        return out


def test_generation(exp, state, evaluator: CoherenceEvaluator, max_batches: int = 0,
                    eps: Optional[Union[torch.Tensor, float]] = None) -> Dict[str, Any]:
    """The coherence pass over the test set (test_generation,
    coherence.py:226-293): random coherence, conditional APs and the text
    scores; ``max_batches`` > 0 caps the batches, ``eps`` injects the
    conditional noise (``eps=0``: each subset's posterior mean)."""
    cfg, model = exp.cfg, state.model
    param = next(model.parameters())
    generator = torch.Generator(param.device).manual_seed((cfg.seed or 0) + SEED_OFFSET)
    n_rand = cfg.effective_eval_batch_size
    rates, labels_all, ref_ids = [], [], []
    probs: Dict[str, Dict[str, list]] = {}
    gen_ids: Dict[str, list] = {}
    with profiling.span("coherence.device") as t_device:
        for i, (batch, labels) in enumerate(exp.eval_batches("test")):
            if max_batches and i >= max_batches:
                break
            batch = to_device(batch, param)
            with eval_mode(cfg, model):
                rand = model.generate(n_rand, generator=generator)
                latents = model.inference(batch)
                cond = model.cond_generation(latents["subsets"], generator=generator, eps=eps)
            rates.append(evaluator.coherence_rate(rand))
            # subsets and modalities in sorted order, as the JAX package's
            # device_get of a dict gives them (and so its results' keys)
            for s_key in sorted(cond):
                gen = cond[s_key]
                slot = probs.setdefault(s_key, {})
                for m in sorted(cfg.modality_names):
                    slot.setdefault(m, []).append(torch.nan_to_num(evaluator.predict(m, gen[m])))
                gen_ids.setdefault(s_key, []).append(
                    torch.argmax(gen["text"], dim=-1).to(torch.int32))
            ref = batch["text"]
            ref_ids.append((torch.argmax(ref, dim=-1) if ref.dim() == 3 else ref)
                           .to(torch.int32))
            labels_all.append(np.nan_to_num(np.asarray(labels)))
        # the pass's one trip to the host
        rates_h = torch.stack(rates).tolist() if rates else []
        probs_h = {s: {m: torch.cat(parts).cpu().numpy() for m, parts in per_mod.items()}
                   for s, per_mod in probs.items()}
        gen_ids_h = {s: torch.cat(parts).cpu().numpy() for s, parts in gen_ids.items()}

    # the per-batch rate averaged over the batches, one value for every label
    results: Dict[str, Any] = {"random_coherence": (
        {label: float(np.mean(rates_h)) for label in exp.labels} if rates_h else {})}
    with profiling.span("coherence.ap") as t_ap:
        if labels_all:
            results["cond_coherence"] = evaluator.cond_ap(probs_h, np.concatenate(labels_all),
                                                          exp.labels)
    with profiling.span("coherence.bleu") as t_bleu:
        if ref_ids:
            text_eval = _text_bleu_per_subset(cfg, exp, gen_ids_h,
                                              torch.cat(ref_ids).cpu().numpy())
            if text_eval:
                results["text_gen"] = text_eval
    log.info(f"coherence: device={t_device.seconds:.1f}s ap={t_ap.seconds:.1f}s "
             f"bleu={t_bleu.seconds:.1f}s")
    return results


# keep pytest from collecting the reference-parity-named library function
test_generation.__test__ = False


def _text_bleu_per_subset(cfg, exp, gen_ids: Mapping[str, np.ndarray], ref_ids: np.ndarray
                          ) -> Dict[str, Dict[str, float]]:
    """{subset: {bleu_1..4, bleu, nbr_common_words}} (evaluate_generated_text,
    coherence.py:296-311) of the generated token ids against the reference
    ids. Word ids are the tokens (a bijection through the vocabulary), so
    they are scored directly, against the test set's n-gram tables, built
    once a run; char ids are decoded and split into words."""
    from mopoe_mimic_tpu_torch.data.text_codec import tensor_to_tokens

    out: Dict[str, Dict[str, float]] = {}
    if cfg.text_encoding == "word":
        key = ("bleu_ref_tables", ref_ids.shape, hash(ref_ids.tobytes()))
        tables = exp.cached(key, lambda: build_ref_tables(ref_ids))
        for s_key, hyp_ids in gen_ids.items():
            scores = corpus_bleu_ids(ref_ids, hyp_ids, ref_tables=tables)
            scores["nbr_common_words"] = nbr_common_words_ids(ref_ids, hyp_ids, ref_tables=tables)
            out[s_key] = scores
        return out
    refs = tensor_to_tokens(cfg, exp, ref_ids, probs=False)
    for s_key, hyp_ids in gen_ids.items():
        hyp = tensor_to_tokens(cfg, exp, hyp_ids, probs=False)
        scores = corpus_bleu(refs, hyp)
        scores["nbr_common_words"] = nbr_common_words(refs, hyp)
        out[s_key] = scores
    return out
