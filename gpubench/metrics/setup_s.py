"""setup_s: process start to the window's start, less the time the check
spent reading the program's state (host clock)."""


def read(rec):
    return rec.get("setup_s")
