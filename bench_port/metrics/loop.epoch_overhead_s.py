"""The loop's seconds an epoch outside the train pass: the test pass and
the callbacks, from ``run_epochs``' history, mean over the window's
epochs."""


def read(r):
    n = r.get("window_epochs")
    if not n:
        return None
    return sum(t + c for t, c in zip(r["test_s"], r["callbacks_s"])) / n
