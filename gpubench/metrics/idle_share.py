"""idle_share: the share of the traced rounds' window in which no kernel,
copy or fill ran on the device (torch.profiler), in %."""


def read(rec):
    if not rec.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["trace_window_s"])
