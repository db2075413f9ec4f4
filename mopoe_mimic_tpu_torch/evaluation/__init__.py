"""The evaluation suite: lr-eval (``representation``), coherence with the
CheXpert-label classifiers (``coherence``, ``clf_loader``), the IWAE
likelihoods (``likelihood``), BLEU (``bleu``), the metrics (``metrics``) and
the round that runs them (``runner``)."""
