"""The device's idle share of the profiled training epoch (its train
pass's replays, the test pass and the callbacks): one less the union of
the kernel and copy intervals over the epoch's wall time."""


def read(r):
    prof = r.get("profile")
    if prof is None or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
