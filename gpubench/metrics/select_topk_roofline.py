"""select_topk_roofline: the least time of the fused Eq. 7-9 + top-k
calls (bytes once at HBM bandwidth or the Gram's FFMA work, whichever is
larger, at the header's shape) over their device time in the traced
rounds, in %. The calls are the program's launch counter's."""

from gpubench.harness import counts

KERNELS = ("row_inv_norm_kernel", "select_partial_kernel",
           "select_tile_kernel", "select_merge_kernel")


def read(rec):
    dev = rec.get("kernels", {}).get("select_topk_roofline")
    calls = rec.get("launches", {}).get("select_topk", 0)
    if not dev or not calls or dev["device_s"] <= 0:
        return None
    fl = rec["cell"]["fl"]
    m = fl["num_clients"]
    nbytes, flops = counts.select_topk_work(
        m, rec["header_params"], min(fl["peers_per_round"], m - 1))
    least = counts.roofline_s(nbytes, flops, counts.PEAK_FP32_FLOPS)
    return 100.0 * calls * least / dev["device_s"]
