"""Expert-activation trace collection (paper Contribution 2).

Runs batch-1 autoregressive decoding on an MoE backbone through the
facade's decode mode (``transformer.lm_apply(mode="decode")``: the
``topk_gating`` router and the ``expert_ffn`` kernel over the device's
``(E, D, F)`` experts on a card) and records, per token: its id, the
backbone's token-embedding row, and the routed expert ids at every MoE
layer — the paper's trace schema. The loop stays on the device: prompt
tokens, sampled tokens and routed ids are read back to the host once per
trace.

Sampling is Gumbel-max over ``logits / temperature`` (the form of JAX's
``random.categorical``) with noise from an explicit ``torch.Generator``;
``temperature <= 0`` is greedy. The draws are not JAX's, so only greedy
or teacher-forced traces can equal the reference's.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.transformer import moe_layer_ids  # noqa: F401


@dataclass
class Trace:
    tokens: np.ndarray       # (T,) i32 — token processed at each step
    embeddings: np.ndarray   # (T, emb_dim) f32 — backbone token embeddings
    experts: np.ndarray      # (T, L_moe, k) i32 — routed experts per layer
    prompt_len: int          # tokens 0..prompt_len-1 came from the prompt

    @property
    def num_tokens(self) -> int:
        return len(self.tokens)


def extract_step_experts(cfg, extras) -> List[torch.Tensor]:
    """A decode step's routed ids as a list in layer order, one (k,)
    tensor per MoE layer, of batch element 0 (the paper works at batch
    size 1); they stay on the device."""
    return [ex["experts"][0, 0] for ex in extras if "experts" in ex]


def _sample(logits, temperature: float, generator):
    """Next token (1,) from last-position logits (V,), on their device."""
    if temperature <= 0:
        return logits.argmax()[None]
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits / temperature + gumbel).argmax()[None]


@torch.no_grad()
def collect_trace(model, params, prompt: Sequence[int], max_new: int,
                  cache_len: int, temperature: float = 0.8,
                  generator: Optional[torch.Generator] = None) -> Trace:
    """Token-by-token batch-1 decode on the device of ``params``; every
    token (prompt + generated) passes through a decode step so its expert
    activations are recorded. Stops after ``min(len(prompt) + max_new,
    cache_len)`` tokens, as the reference does."""
    cfg = model.cfg
    dev = params["tok_emb"].device
    caches = model.init_decode_state(1, cache_len, device=dev)["caches"]
    prompt_t = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)
    n_total = min(len(prompt) + max_new, cache_len)
    tokens, rows = [], []
    cur = prompt_t[:1]
    for t in range(n_total):
        logits, caches, extras = T.lm_apply(params, cfg, cur[:, None],
                                            "decode", caches, pos=t)
        tokens.append(cur)
        rows.append(torch.stack(extract_step_experts(cfg, extras)))
        if t + 1 < len(prompt):
            cur = prompt_t[t + 1:t + 2]
        else:
            cur = _sample(logits[0, -1], temperature, generator)
    toks = torch.cat(tokens)
    emb = params["tok_emb"][toks].float().cpu().numpy()
    return Trace(
        tokens=toks.cpu().numpy().astype(np.int32),
        embeddings=emb,
        experts=torch.stack(rows).cpu().numpy().astype(np.int32),
        prompt_len=min(len(prompt), n_total),
    )


def collect_traces(model, params, prompts, max_new: int, cache_len: int,
                   temperature: float = 0.8, seed: int = 0) -> List[Trace]:
    """One trace per prompt; prompt ``i`` samples from a generator seeded
    with ``seed + i`` on the device of ``params``."""
    dev = params["tok_emb"].device
    return [collect_trace(model, params, p, max_new, cache_len, temperature,
                          torch.Generator(dev).manual_seed(seed + i))
            for i, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# (De)serialisation: the reference's .npz schema

def save_traces(path: str, traces: List[Trace]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = {}
    for i, tr in enumerate(traces):
        blob[f"t{i}_tokens"] = tr.tokens
        blob[f"t{i}_emb"] = tr.embeddings.astype(np.float16)
        blob[f"t{i}_experts"] = tr.experts
        blob[f"t{i}_plen"] = np.asarray(tr.prompt_len)
    np.savez_compressed(path, n=np.asarray(len(traces)), **blob)


def load_traces(path: str) -> List[Trace]:
    data = np.load(path)
    out = []
    for i in range(int(data["n"])):
        out.append(Trace(
            tokens=data[f"t{i}_tokens"],
            embeddings=data[f"t{i}_emb"].astype(np.float32),
            experts=data[f"t{i}_experts"],
            prompt_len=int(data[f"t{i}_plen"]),
        ))
    return out
