"""Decoder-only LM over the layer-pattern abstraction, the port of
``repro.models.lm`` for dense stacks.

Parameters are a plain dict of tensors in the reference's layout: every
leaf of ``params["stack"]`` carries a leading ``n_periods`` axis (the
reference's scan layout), and the port runs the periods as a Python loop
over views of that axis.

Entry points:
  lm_forward                — the training forward (logits); the teacher-
                              forcing oracle of decode
  prefill                   — build the KV cache for a prompt
  decode_step               — one token against the cache (serve_step)

A period whose layer kind is ``"mamba"`` or whose MLP is ``"moe"`` raises
``NotImplementedError``: those layers (and the ssd_scan kernel that the
mamba layer's forward reaches) come with later slices of the port.
``lm_loss`` (the training loss) waits for the training slice.
"""
from __future__ import annotations

from typing import Any

import torch

from .common import DTYPES, ArchConfig
from .layers import (_qkv, attention, decode_attention, init_attn, init_mlp,
                     init_norm, mlp_block, randn, rms_norm)

__all__ = ["init_lm", "lm_forward", "prefill", "decode_step",
           "init_decode_cache", "hidden_states", "embed_tokens",
           "unembed_matrix", "tree_leaves", "tree_map"]


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def _check_dense(cfg: ArchConfig) -> None:
    for spec in cfg.period:
        if spec.kind == "mamba":
            raise NotImplementedError(
                f"{cfg.name}: mamba layers are not ported yet (ROADMAP "
                "Queue 1 item 8: models/ssm with the ssd_scan kernel K5)")
        if spec.kind != "attn":
            raise ValueError(spec.kind)
        if spec.mlp == "moe":
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1 "
                "item 8: models/moe)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_lm(cfg: ArchConfig, gen: "torch.Generator | None",
            device: "torch.device | str | None" = None) -> dict:
    """Random parameters from `gen` (on the generator's device unless
    `device` says otherwise), with the reference's distributions: the same
    shapes and scales, not the same bits (``jax.random`` and torch's
    generators differ).  ``device="meta"`` with no generator builds the
    shapes only."""
    _check_dense(cfg)
    if device is None:
        device = gen.device
    dt = DTYPES[cfg.param_dtype]
    lead = (cfg.n_periods,)
    stack: dict[str, Any] = {}
    for i, spec in enumerate(cfg.period):
        stack[f"l{i}"] = {"attn": init_attn(cfg, gen, lead, device)}
        if spec.mlp == "dense":
            stack[f"l{i}"]["mlp"] = init_mlp(cfg, gen, lead, device)
    params = {
        "embed": randn((cfg.padded_vocab, cfg.d_model), gen, device, 0.02, dt),
        "stack": stack,
        "final_norm": init_norm(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = randn((cfg.d_model, cfg.padded_vocab), gen,
                                  device, cfg.d_model ** -0.5, dt)
    return params


def _period(params: dict, n: int) -> dict:
    """Period n's parameters: views of the stacked leaves."""
    return tree_map(lambda x: x[n], params["stack"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn_layer(cfg: ArchConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True):
    """Pre-norm attention block; also returns its k and v (the cache)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, positions)
    o = attention(cfg, q, k, v, causal=causal)
    B, S, _, _ = o.shape
    return x + o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"], k, v


def _apply_period(cfg: ArchConfig, pp: dict, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True,
                  cache: dict | None = None) -> torch.Tensor:
    for i, spec in enumerate(cfg.period):
        lp = pp[f"l{i}"]
        x, k, v = _attn_layer(cfg, lp["attn"], x, positions, causal=causal)
        if cache is not None:
            cache[f"l{i}"] = {"k": k, "v": v}
        if spec.mlp == "dense":
            x = mlp_block(cfg, lp["mlp"], x)
    return x


def hidden_states(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True):
    """Run the stack on embedded inputs x: (B, S, d) -> (h, aux).  A dense
    stack has no auxiliary loss, so aux is 0."""
    _check_dense(cfg)
    for n in range(cfg.n_periods):
        x = _apply_period(cfg, _period(params, n), x, positions, causal)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def embed_tokens(cfg: ArchConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed_matrix(cfg: ArchConfig, params: dict) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def _positions(B: int, S: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + S, device=device).expand(B, S)


def lm_forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
               positions: torch.Tensor | None = None):
    """tokens: (B, S) -> (logits (B, S, V_padded), aux)."""
    B, S = tokens.shape
    if positions is None:
        positions = _positions(B, S, tokens.device)
    h, aux = hidden_states(cfg, params, embed_tokens(cfg, params, tokens),
                           positions)
    return h @ unembed_matrix(cfg, params), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            inputs_embeds: torch.Tensor | None = None):
    """Returns (last-position logits (B, V), cache).  The cache is
    ``{"layers": {"l<i>": {"k", "v"}}, "length"}`` with (n_periods, B, S,
    Hkv, dh) leaves, stacked per period as in the reference; ``length`` is a
    Python int."""
    _check_dense(cfg)
    B, S = tokens.shape[:2]
    positions = _positions(B, S, tokens.device)
    h = inputs_embeds if inputs_embeds is not None \
        else embed_tokens(cfg, params, tokens)
    per: list[dict] = []
    for n in range(cfg.n_periods):
        cache_p: dict = {}
        h = _apply_period(cfg, _period(params, n), h, positions, True,
                          cache_p)
        per.append(cache_p)
    layers = {name: {kv: torch.stack([c[name][kv] for c in per])
                     for kv in ("k", "v")} for name in per[0]}
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(cfg, params))[:, 0, :cfg.vocab]
    return logits, {"layers": layers, "length": S}


def init_decode_cache(cfg: ArchConfig, batch: int, capacity: int,
                      device: "torch.device | str" = "cuda") -> dict:
    """Empty cache at a given KV capacity."""
    _check_dense(cfg)
    dt = DTYPES[cfg.compute_dtype]
    shape = (cfg.n_periods, batch, capacity, cfg.n_kv_heads, cfg.d_head)
    layers = {f"l{i}": {"k": torch.zeros(shape, dtype=dt, device=device),
                        "v": torch.zeros(shape, dtype=dt, device=device)}
              for i in range(len(cfg.period))}
    return {"layers": layers, "length": 0}


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor):
    """token: (B, 1) -> (logits (B, V), cache).  One serve_step.

    Unlike the reference, which builds a new cache with
    ``dynamic_update_slice``, this writes the new k and v into the cache's
    tensors in place (index assignment at ``length``) and returns the same
    tensors under a new length: the caller's cache is updated too."""
    _check_dense(cfg)
    B = token.shape[0]
    length = int(cache["length"])
    positions = _positions(B, 1, token.device, start=length)
    h = embed_tokens(cfg, params, token)
    scale = cfg.d_head ** -0.5
    for n in range(cfg.n_periods):
        pp = _period(params, n)
        for i, spec in enumerate(cfg.period):
            ap = pp[f"l{i}"]["attn"]
            kc = cache["layers"][f"l{i}"]["k"][n]
            vc = cache["layers"][f"l{i}"]["v"][n]
            hn = rms_norm(h, ap["norm"], cfg.norm_eps)
            q, k, v = _qkv(cfg, ap, hn, positions)
            kc[:, length] = k[:, 0].to(kc.dtype)
            vc[:, length] = v[:, 0].to(vc.dtype)
            o = decode_attention(q, kc, vc, length + 1, scale,
                                 layout=cfg.decode_cache_layout)
            h = h + o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ ap["wo"]
            if spec.mlp == "dense":
                h = mlp_block(cfg, pp[f"l{i}"]["mlp"], h)
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(cfg, params))[:, 0, :cfg.vocab]
    return logits, {"layers": cache["layers"], "length": length + 1}
