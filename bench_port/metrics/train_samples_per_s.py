"""Training samples a second: every sample of the window's whole epochs
over the host's wall time of those epochs (train pass, test pass and
callbacks)."""


def read(r):
    if not r.get("window_epochs"):
        return None
    return r["window_epochs"] * r["steps_per_epoch"] * r["batch_size"] / r["window_s"]
