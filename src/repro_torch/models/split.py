"""Extractor / header split — the PFedDST partial-personalization cut
(reference `repro.models.split`).

cnn (a flat dict of dotted names): header = the "head." leaves (the
final fc), extractor = stem + stages. Every LLM family (nested dicts),
audio included: header = {final_norm, lm_head}, extractor = the rest.
Both halves keep their full names, so merge is a plain dict union.
"""
from __future__ import annotations

HEADER_KEYS = {"cnn": ("head",), "default": ("final_norm", "lm_head")}


def header_keys(cfg):
    return HEADER_KEYS.get(cfg.family, HEADER_KEYS["default"])


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def split_params(cfg, params: dict):
    """→ (extractor, header) — disjoint subsets of the dotted names."""
    hk = set(header_keys(cfg))
    extractor = {k: v for k, v in params.items() if _top(k) not in hk}
    header = {k: v for k, v in params.items() if _top(k) in hk}
    if not header:
        raise ValueError(f"no header keys {hk} found in params")
    return extractor, header


def merge_params(extractor: dict, header: dict) -> dict:
    out = dict(extractor)
    out.update(header)
    return out
