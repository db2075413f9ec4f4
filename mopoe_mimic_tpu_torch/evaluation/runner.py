"""The eval round, run from the training loop every ``eval_freq`` epochs
and at the last one (``mopoe_mimic_tpu/evaluation/runner.py``; reference
test() at mimic/run_epochs.py:148-228): the latent classifiers
(``eval_lr``), generation coherence with the CheXpert-label classifiers
(``use_clf``), the IWAE likelihoods (``calc_nll``) and the sample grids.
PRD/FID (``calc_prd``) is not ported and raises.

The round leaves training where it was: the model goes back to its mode,
the BatchNorm running statistics are not updated (eval mode), no parameter
is reallocated (the graphed epoch holds their addresses), and every
evaluation draws from a generator of its own, never from the state's or
dropout's default one (the classifiers' training forks the default
generators: ``train/clf_trainer.py``). Each evaluation is a span inside
``eval.round`` (``eval.lr``, ``eval.clf_load``, ``eval.coherence``,
``eval.nll``, ``eval.plots_collect``, ``eval.plots_render``, the last on
the experiment's host worker where the plots render asynchronously); their
seconds go to the log and to ``exp.eval_timings``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from mopoe_mimic_tpu_torch.utils import profiling
from mopoe_mimic_tpu_torch.utils.logger import log
from mopoe_mimic_tpu_torch.utils.meters import flatten_metrics


def run_eval_suite(exp, state, epoch: int, max_batches: Optional[int] = None) -> Dict[str, Any]:
    """Every enabled evaluation, as one flat {name: value} (``lr_eval_*``,
    ``gen_eval_*``, ``likelihoods_*``), each also written to TensorBoard.
    ``max_batches`` caps each evaluation's test batches; None defers to
    ``cfg.eval_max_batches``, whose 0 is the whole test set, as the
    reference's test() pass. A cap is logged."""
    cfg = exp.cfg
    if cfg.calc_prd:
        from mopoe_mimic_tpu_torch.experiment import PRD_MISSING

        raise NotImplementedError(PRD_MISSING)
    if max_batches is None:
        max_batches = cfg.eval_max_batches
    if max_batches:
        log.info(f"heavy evals CAPPED at {max_batches} test batches "
                 f"(~{max_batches * cfg.effective_eval_batch_size} samples) — metrics are not "
                 "comparable to full-test-set reference numbers")
    results: Dict[str, Any] = {}
    parts: Dict[str, profiling.Span] = {}

    with profiling.span("eval.round", epoch=epoch) as round_span:
        if cfg.eval_lr:
            from mopoe_mimic_tpu_torch.evaluation.representation import (
                test_clf_lr_all_subsets,
                train_clf_lr_all_subsets,
            )

            log.info("eval: latent-representation classifiers")
            with profiling.span("eval.lr") as parts["lr_eval_s"]:
                lr_eval = test_clf_lr_all_subsets(exp, state,
                                                  train_clf_lr_all_subsets(exp, state))
            results["lr_eval"] = lr_eval
            for s_key, metrics in lr_eval.items():
                exp.tb_logger.write_epoch(f"lr_eval/{s_key}", epoch, metrics)

        if cfg.use_clf:
            from mopoe_mimic_tpu_torch.evaluation.clf_loader import load_or_train_classifiers
            from mopoe_mimic_tpu_torch.evaluation.coherence import test_generation

            log.info("eval: generation coherence")
            with profiling.span("eval.clf_load") as parts["clf_load_or_train_s"]:
                evaluator = load_or_train_classifiers(exp)
            with profiling.span("eval.coherence") as parts["coherence_s"]:
                gen_eval = test_generation(exp, state, evaluator, max_batches=max_batches)
            results["gen_eval"] = gen_eval
            exp.tb_logger.write_epoch("coherence", epoch, gen_eval)

        if cfg.calc_nll:
            from mopoe_mimic_tpu_torch.evaluation.likelihood import estimate_likelihoods

            log.info("eval: importance-weighted likelihoods")
            with profiling.span("eval.nll") as parts["nll_s"]:
                lhoods = estimate_likelihoods(exp, state, max_batches=max_batches)
            results["likelihoods"] = lhoods
            exp.tb_logger.write_epoch("likelihoods", epoch, lhoods)

        try:
            from mopoe_mimic_tpu_torch.utils.plotting import (
                collect_plot_arrays,
                render_plot_arrays,
            )

            with profiling.span("eval.plots_collect") as parts["plots_collect_s"]:
                plot_data = collect_plot_arrays(exp, state, epoch)

            def _render(data=plot_data, ep=epoch, parent=round_span.id) -> profiling.Span:
                with profiling.span("eval.plots_render", parent=parent, epoch=ep) as sp:
                    for tag, img in render_plot_arrays(exp, data, ep).items():
                        exp.tb_logger.write_image(tag, img, ep)
                return sp

            if cfg.async_plots:
                # host work only: overlaps the next epoch on the experiment's worker
                exp.submit_host_job(_render, name=f"plot render (epoch {epoch})")
            else:
                parts["plots_render_s"] = _render()
        except Exception as e:  # noqa: BLE001 — a failed plot must not end the run
            log.warning(f"plot generation FAILED: {e!r}", exc_info=True)

    timings = {k: sp.seconds for k, sp in parts.items()}
    exp.eval_timings = {**timings, "round_s": round_span.seconds}
    if timings:
        split = ", ".join(f"{k}={v:.3f}" for k, v in timings.items())
        log.info(f"eval round: {round_span.seconds:.3f}s total ({split})")
    return flatten_metrics(results, sep="_") if results else {}
