"""cnn_round_s: the window's round wall in a cell whose rounds the host
paces (a CNN population): read, not gated."""


def read(rec):
    if rec["model"]["family"] != "cnn":
        return None
    return rec.get("round_s")
