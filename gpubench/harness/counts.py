"""The yardstick's arithmetic, frozen with the benchmark: the card's
published peaks, the bytes and operations a kernel call needs, and the
model FLOPs of a round. Nothing here reads the program."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def roofline_s(nbytes: float, flops: float, peak: float) -> float:
    """The least time: bytes once at HBM bandwidth or operations at
    `peak`, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def select_topk_work(m: int, p: int, k: int) -> tuple:
    """(bytes, FLOPs) of one fused Eq. 7-9 + top-k call over (M, P) f32
    headers with an (M, M) cost matrix and candidate mask: every input
    read once (headers, recency, loss array, cost, mask), every output
    written once (values, indices, the s_d statistics); the Gram's
    2·M²·P operations on the FFMA units."""
    nbytes = m * p * 4 + 3 * m * m * 4 + m * m + m * k * 8 + m * 2 * 4
    return nbytes, 2.0 * m * m * p


def dense_params(model: dict) -> dict:
    """Parameter counts of the decoder: embedding, extractor (embedding
    and layers), header (final norm and lm_head), and N, the weights a
    token's forward multiplies through (layers and lm_head)."""
    d, n, ff = model["d_model"], model["num_layers"], model["d_ff"]
    heads, kv = model["num_heads"], model["num_kv_heads"]
    hd = d // heads
    vocab = ((model["vocab_size"] + 255) // 256) * 256
    layer = (d * heads * hd + 2 * d * kv * hd + heads * hd * d
             + 3 * d * ff + 2 * d)
    if model.get("qkv_bias"):
        layer += heads * hd + 2 * kv * hd
    embed = vocab * d
    head = d * vocab + d
    return {"embed": embed, "extractor": embed + n * layer, "header": head,
            "n": n * layer + head, "n_head": head}


def round_model_flops(model: dict, cell: dict) -> float:
    """Model FLOPs of one round of a decoder cell, recomputation not
    counted: a full step 6·N a token; a phase-e step (header frozen: no
    lm_head weight gradient) (6·N - 2·N_head); a phase-h step (extractor
    frozen: the forward, and the head's weight and input gradients)
    (2·N + 4·N_head); an Eq. 6 probe forward 2·N."""
    c = dense_params(model)
    fl, spe = cell["fl"], cell["steps_per_epoch"]
    tokens = fl["batch_size"] * cell["data"]["seq_len"]
    n_clients = max(1, int(round(fl["num_clients"]
                                 * fl["client_sample_ratio"])))
    n_e = fl["epochs_extractor"] * spe
    n_h = fl["epochs_header"] * spe
    per_client = (n_e * (6.0 * c["n"] - 2.0 * c["n_head"])
                  + n_h * (2.0 * c["n"] + 4.0 * c["n_head"])) * tokens
    probe_tokens = (fl["num_clients"] * fl["probe_size"]
                    * cell["data"]["seq_len"])
    return n_clients * (per_client + 2.0 * c["n"] * probe_tokens)
