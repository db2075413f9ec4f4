"""Set-up: from the process's start to the window's."""


def read(r):
    return r["setup_s"]
