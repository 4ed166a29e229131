"""round_s: the window's wall over its whole rounds (host clock)."""


def read(rec):
    return rec.get("round_s")
