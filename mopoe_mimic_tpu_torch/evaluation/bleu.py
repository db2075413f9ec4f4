"""Corpus BLEU for generated reports — exact nltk semantics. A copy of
``mopoe_mimic_tpu/evaluation/bleu.py`` (stdlib and numpy only).

Parity: evaluate_generated_text (mimic/evaluation/eval_metrics/
coherence.py:296-311) scores generated text per conditioning subset with
nltk ``corpus_bleu`` under Chen & Cherry smoothing method 4: per-n weight
vectors (1,0,0,0)…(0,0,0,1), the cumulative default (0.25,)*4, plus a
``nbr_common_words`` mean set-overlap.

This module re-implements nltk's ``corpus_bleu`` + ``method4`` math in one
pass (the reference calls nltk five times, re-counting every n-gram per
weight vector; here numerators/denominators for n=1..4 are accumulated
once and the five weighted scores are derived from them — ~5× less host
work on the corpus scan). tests/test_eval_math.py asserts float equality
against the installed nltk on fixed token sets.

Mirrored nltk details (nltk/translate/bleu_score.py):
  * modified_precision: clip hypothesis n-gram counts against the per-
    hypothesis max reference count; denominator ``max(1, total)`` PER
    HYPOTHESIS (an empty hypothesis still contributes denominator 1);
  * corpus brevity penalty over summed hyp lengths vs summed closest-ref
    lengths (ties broken toward the shorter reference);
  * score 0 when no unigram matches at all;
  * method4 smoothing on the CORPUS-level (numerator, denominator) pairs
    with hyp_len = total hypothesis length: each zero numerator becomes
    ``(1 / (2**incvnt * k / ln(hyp_len))) / denominator`` with incvnt
    incrementing per smoothed order (k=5);
  * final score ``bp * exp(Σ w_i·log p_i)`` over the p_i > 0 only.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_K = 5  # SmoothingFunction(k=5) default, used by the reference


def _ngrams(tokens: Sequence[str], n: int):
    return [tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)]


def _corpus_counts(
    references: List[Sequence[str]],
    hypotheses: List[Sequence[str]],
    max_n: int = 4,
) -> Tuple[List[int], List[int], int, int]:
    """One scan over the corpus → per-order (numerators, denominators) and
    (hyp_lengths, ref_lengths). ``references[i]`` is the single reference
    for ``hypotheses[i]`` (the eval pairs generated text 1:1 with the
    batch's true report)."""
    nums = [0] * max_n
    dens = [0] * max_n
    hyp_lengths = 0
    ref_lengths = 0
    for ref, hyp in zip(references, hypotheses):
        hyp_lengths += len(hyp)
        ref_lengths += len(ref)  # single reference → it IS the closest
        for n in range(1, max_n + 1):
            counts = Counter(_ngrams(hyp, n)) if len(hyp) >= n else Counter()
            if counts:
                ref_counts = (
                    Counter(_ngrams(ref, n)) if len(ref) >= n else Counter()
                )
                nums[n - 1] += sum(
                    min(c, ref_counts[g]) for g, c in counts.items()
                )
            # nltk: denominator is max(1, Σcounts) per hypothesis
            dens[n - 1] += max(1, sum(counts.values()))
    return nums, dens, hyp_lengths, ref_lengths


def _method4(nums: List[int], dens: List[int], hyp_len: int) -> List[float]:
    """Chen & Cherry method4 on corpus-level fractions (nltk
    SmoothingFunction.method4 with the unreduced denominators)."""
    p_n: List[float] = []
    incvnt = 1
    for num, den in zip(nums, dens):
        if num == 0 and hyp_len > 1:
            smoothed_num = 1.0 / (2 ** incvnt * _K / math.log(hyp_len))
            p_n.append(smoothed_num / den)
            incvnt += 1
        else:
            p_n.append(num / den)
    return p_n


def _brevity_penalty(ref_len: int, hyp_len: int) -> float:
    if hyp_len > ref_len:
        return 1.0
    if hyp_len == 0:
        return 0.0
    return math.exp(1.0 - ref_len / hyp_len)


def _weighted_score(p_n: List[float], weights: Sequence[float], bp: float) -> float:
    s = math.fsum(
        w * math.log(p) for w, p in zip(weights, p_n) if p > 0
    )
    return bp * math.exp(s)


def _scores_from_counts(nums, dens, hyp_len: int, ref_len: int) -> Dict[str, float]:
    if nums[0] == 0:
        # nltk: no unigram matches → every score is 0 (smoothing never runs)
        return {f"bleu_{n}": 0.0 for n in (1, 2, 3, 4)} | {"bleu": 0.0}
    bp = _brevity_penalty(ref_len, hyp_len)
    p_n = _method4(list(nums), list(dens), hyp_len)
    out = {}
    for n in (1, 2, 3, 4):
        w = [0.0] * 4
        w[n - 1] = 1.0
        out[f"bleu_{n}"] = _weighted_score(p_n, w, bp)
    out["bleu"] = _weighted_score(p_n, (0.25, 0.25, 0.25, 0.25), bp)
    return out


def corpus_bleu(
    references: List[Sequence[str]], hypotheses: List[Sequence[str]]
) -> Dict[str, float]:
    """nltk-equal corpus BLEU report: per-n scores ``bleu_1..4`` (weight
    vectors (1,0,0,0)…(0,0,0,1)), cumulative ``bleu`` ((0.25,)*4), all
    under method4 smoothing — the exact quintuple the reference logs
    (coherence.py:302-310)."""
    nums, dens, hyp_len, ref_len = _corpus_counts(references, hypotheses)
    return _scores_from_counts(nums, dens, hyp_len, ref_len)


# ---------------------------------------------------------------------------
# integer-id fast path (identical scores, ~20× less host time)
# ---------------------------------------------------------------------------

def _pack_ngrams(a, n: int):
    """[N, L] int ids → [N, L-n+1] int64 where each value uniquely encodes
    one n-gram (16 bits per token — ids must be < 2**15, which covers the
    71-char alphabet and any MIMIC word vocab by orders of magnitude)."""
    import numpy as np

    w = np.lib.stride_tricks.sliding_window_view(a, n, axis=1).astype(np.int64)
    packed = w[..., 0]
    for k in range(1, n):
        packed = (packed << 16) | w[..., k]
    return packed


def build_ref_tables(references) -> Dict:
    """Precompute the reference-side n-gram count tables for
    ``corpus_bleu_ids`` / ``nbr_common_words_ids``. The references are the
    fixed test corpus — identical across the 7 conditioning subsets of one
    eval round AND across eval rounds — so the ref-side sorts (the majority
    of the BLEU corpus-scan cost) are paid once per run instead of
    7×rounds times. Returns an opaque dict keyed by n-gram order with
    (gram vocabulary, sorted (row,gram) keys, counts) triples."""
    import numpy as np

    refs = np.asarray(references)
    if refs.size and int(refs.max()) >= 1 << 15:
        raise ValueError("ids must be < 2**15 for packed n-gram counting")
    n_rows, l_ref = refs.shape
    tables: Dict = {"shape": (n_rows, l_ref)}
    for n in range(1, 5):
        if l_ref < n:
            tables[n] = None
            continue
        r = _pack_ngrams(refs, n)
        vocab = np.unique(r.ravel())
        gid = np.searchsorted(vocab, r)  # every ref gram is in vocab
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), r.shape[1])
        keys = rows * np.int64(len(vocab)) + gid.ravel()
        ur, cr = np.unique(keys, return_counts=True)
        tables[n] = (vocab, ur, cr)
    # distinct (row, token) keys for nbr_common_words (shift = 2**15: the
    # id bound validated above and for every hypothesis set)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), l_ref)
    tables["words"] = np.unique((rows << 15) | refs.ravel().astype(np.int64))
    return tables


def _clipped_matches_vs_tables(h, table) -> int:
    """Σ_rows Σ_grams min(count_hyp, count_ref) against a precomputed ref
    table: hyp grams map into the ref gram vocabulary by binary search
    (grams absent from every reference can never match and are dropped),
    then one unique + one sorted intersection. Exact integer counting."""
    import numpy as np

    vocab, ur, cr = table
    n_rows = h.shape[0]
    gid = np.searchsorted(vocab, h)
    np.clip(gid, 0, max(len(vocab) - 1, 0), out=gid)
    valid = (vocab[gid] == h) if len(vocab) else np.zeros_like(h, bool)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), h.shape[1])
    keys = (rows * np.int64(len(vocab)) + gid.ravel())[valid.ravel()]
    if not keys.size:
        return 0
    uh, ch = np.unique(keys, return_counts=True)
    _, hi, ri = np.intersect1d(uh, ur, assume_unique=True, return_indices=True)
    if not hi.size:
        return 0
    return int(np.minimum(ch[hi], cr[ri]).sum())


def _rowwise_clipped_matches(h, r) -> int:
    """Σ_rows Σ_grams min(count_hyp, count_ref) with NO per-row Python loop:
    compact the gram values globally (one np.unique), key each occurrence by
    ``row * n_distinct + gram_id`` (fits int64), reduce each side to unique
    (key, count) pairs, and intersect the two sorted key sets once. Exact
    integer counting — identical to per-row Counter clipping."""
    import numpy as np

    n_rows, width = h.shape
    uniq, inv = np.unique(np.concatenate([h.ravel(), r.ravel()]),
                          return_inverse=True)
    g = np.int64(len(uniq))
    rows_h = np.repeat(np.arange(n_rows, dtype=np.int64), width)
    rows_r = np.repeat(np.arange(n_rows, dtype=np.int64), r.shape[1])
    hk = rows_h * g + inv[: h.size]
    rk = rows_r * g + inv[h.size:]
    uh, ch = np.unique(hk, return_counts=True)
    ur, cr = np.unique(rk, return_counts=True)
    _, hi, ri = np.intersect1d(uh, ur, assume_unique=True, return_indices=True)
    if not hi.size:
        return 0
    return int(np.minimum(ch[hi], cr[ri]).sum())


def corpus_bleu_ids(references, hypotheses, ref_tables: Dict = None) -> Dict[str, float]:
    """corpus_bleu computed directly on token-ID arrays ([N, L] ints) —
    bit-identical scores to decoding through the vocab table first
    (id → token is a bijection for in-vocab ids, and argmax over
    vocab-sized logits cannot produce out-of-vocab ids). n-gram counting
    runs fully vectorized over packed int64 n-grams instead of Python
    tuple Counters — the BLEU corpus scan was a dominant host cost of
    eval rounds at [2048, 128] scale (VERDICT r2 #3). Pass
    ``ref_tables=build_ref_tables(references)`` to amortize the ref-side
    sorts across hypothesis sets (subsets × eval rounds); scores are
    identical either way."""
    import numpy as np

    refs = np.asarray(references)
    hyps = np.asarray(hypotheses)
    assert refs.shape[0] == hyps.shape[0]
    if refs.size and max(int(refs.max()), int(hyps.max(initial=0))) >= 1 << 15:
        raise ValueError("ids must be < 2**15 for packed n-gram counting")
    if ref_tables is not None:
        assert ref_tables["shape"] == refs.shape, "ref_tables built for a different corpus"
    n_rows, l_ref = refs.shape
    l_hyp = hyps.shape[1]
    nums = [0] * 4
    dens = [0] * 4
    for n in range(1, 5):
        if l_hyp < n:
            dens[n - 1] += n_rows  # nltk: max(1, 0) per hypothesis
            continue
        h = _pack_ngrams(hyps, n)
        dens[n - 1] += h.shape[1] * n_rows
        if l_ref >= n:
            if ref_tables is not None:
                nums[n - 1] += _clipped_matches_vs_tables(h, ref_tables[n])
            else:
                nums[n - 1] += _rowwise_clipped_matches(h, _pack_ngrams(refs, n))
    return _scores_from_counts(nums, dens, n_rows * l_hyp, n_rows * l_ref)


def nbr_common_words_ids(references, hypotheses, ref_tables: Dict = None) -> float:
    """Mean per-row count of distinct shared ids — equals the token-set
    overlap after decoding (bijection). Vectorized: distinct (row, id)
    pairs per side via one np.unique each, one sorted intersection."""
    import numpy as np

    refs = np.asarray(references, dtype=np.int64)
    hyps = np.asarray(hypotheses, dtype=np.int64)
    if not len(refs):
        return float("nan")
    rows_h = np.repeat(np.arange(len(hyps), dtype=np.int64), hyps.shape[1])
    if ref_tables is not None:
        assert ref_tables["shape"] == refs.shape
        if int(hyps.max(initial=0)) >= 1 << 15:
            raise ValueError("ids must be < 2**15 for the ref-table path")
        ur = ref_tables["words"]
        uh = np.unique((rows_h << 15) | hyps.ravel())
    else:
        shift = np.int64(max(int(refs.max()), int(hyps.max(initial=0))) + 1)
        rows_r = np.repeat(np.arange(len(refs), dtype=np.int64), refs.shape[1])
        ur = np.unique(rows_r * shift + refs.ravel())
        uh = np.unique(rows_h * shift + hyps.ravel())
    total = np.intersect1d(ur, uh, assume_unique=True).size
    return float(total / len(refs))


def common_word_count(reference: Sequence[str], hypothesis: Sequence[str]) -> int:
    return len(set(reference) & set(hypothesis))


def nbr_common_words(
    references: List[Sequence[str]], hypotheses: List[Sequence[str]]
) -> float:
    """Mean per-sample set overlap (coherence.py:303)."""
    if not references:
        return float("nan")
    return float(
        sum(common_word_count(r, h) for r, h in zip(references, hypotheses))
        / len(references)
    )
