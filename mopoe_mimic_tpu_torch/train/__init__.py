"""Training: the objective (``losses``), the state and optimizer (``state``),
the train and eval steps (``step``) and the epoch runners (``scan``)."""
