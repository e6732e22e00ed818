"""Sizes a CPU test run holds: the cells' configurations cut to two
layers and small widths, and their mixes to short prompts."""
import dataclasses

MIX = {"doc_tokens": 96, "question_tokens": [8, 40], "prompt_tokens": [16, 80]}


def moe(cfg):
    return dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                               head_dim=16, d_ff=32, vocab=512, n_experts=8, top_k=2)


def ssm(cfg):
    return dataclasses.replace(cfg, n_layers=2, d_model=64, vocab=512, ssm_state=16,
                               ssm_head_dim=16, ssm_chunk=32)


def for_cell(cell):
    return ssm if cell.startswith("mamba2") else moe
