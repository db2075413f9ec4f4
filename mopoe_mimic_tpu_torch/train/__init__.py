"""Training: the objective (``losses``), the state and optimizer (``state``)
and the train and eval steps (``step``)."""
