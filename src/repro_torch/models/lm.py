"""Decoder-only LM over the layer-pattern abstraction, the port of
``repro.models.lm`` for attention and mamba (SSD) layers with dense or no
MLPs.

Parameters are a plain dict of tensors in the reference's layout: every
leaf of ``params["stack"]`` carries a leading ``n_periods`` axis (the
reference's scan layout), and the port runs the periods as a Python loop
over views of that axis.

Entry points:
  lm_forward                — the training forward (logits); the teacher-
                              forcing oracle of decode
  prefill                   — build the KV / SSM caches for a prompt
  decode_step               — one token against the cache (serve_step)

On a card every attention of ``lm_forward`` and ``prefill`` goes through
the flash_attention kernel (K4) and every mamba layer of ``lm_forward``
through the ssd_scan kernel (K5); prefill's mamba layers run the plain
chunked form and decode the recurrence, as the reference's do.  A period
whose MLP is ``"moe"`` raises ``NotImplementedError``: MoE layers come with
a later slice of the port.  ``lm_loss`` (the training loss) waits for the
training slice.
"""
from __future__ import annotations

from typing import Any

import torch

from .common import DTYPES, ArchConfig
from .layers import (_qkv, attention, decode_attention, init_attn, init_mlp,
                     init_norm, mlp_block, randn, rms_norm)
from .ssm import (init_mamba, init_mamba_state, mamba_block,
                  mamba_decode_step)

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


def _check_no_moe(cfg: ArchConfig) -> None:
    for spec in cfg.period:
        if spec.kind not in ("attn", "mamba"):
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
    _check_no_moe(cfg)
    if device is None:
        device = gen.device
    dt = DTYPES[cfg.param_dtype]
    lead = (cfg.n_periods,)
    stack: dict[str, Any] = {}
    for i, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            lp = {"attn": init_attn(cfg, gen, lead, device=device)}
        else:
            lp = {"mamba": init_mamba(cfg, gen, lead, device=device)}
        if spec.mlp == "dense":
            lp["mlp"] = init_mlp(cfg, gen, lead, device=device)
        stack[f"l{i}"] = lp
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
    """One period.  With a `cache` dict (prefill) each layer's cache goes
    into it: k and v for attention, the SSD state and conv window for
    mamba (whose block then takes the chunked form, not the kernel)."""
    for i, spec in enumerate(cfg.period):
        lp = pp[f"l{i}"]
        if spec.kind == "attn":
            x, k, v = _attn_layer(cfg, lp["attn"], x, positions,
                                  causal=causal)
            if cache is not None:
                cache[f"l{i}"] = {"k": k, "v": v}
        elif cache is not None:
            x, cache[f"l{i}"] = mamba_block(cfg, lp["mamba"], x,
                                            return_state=True)
        else:
            x = mamba_block(cfg, lp["mamba"], x)
        if spec.mlp == "dense":
            x = mlp_block(cfg, lp["mlp"], x)
    return x


def hidden_states(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True):
    """Run the stack on embedded inputs x: (B, S, d) -> (h, aux).  Without
    MoE layers there is no auxiliary loss, so aux is 0."""
    _check_no_moe(cfg)
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
    ``{"layers": {"l<i>": ...}, "length"}``, stacked per period as in the
    reference: an attention layer's ``{"k", "v"}`` are (n_periods, B, S,
    Hkv, dh), a mamba layer's ``{"h", "conv"}`` (n_periods, B, H, N, P)
    float32 and (n_periods, B, d_conv - 1, C); ``length`` is a Python
    int."""
    _check_no_moe(cfg)
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
    layers = {name: {key: torch.stack([c[name][key] for c in per])
                     for key in leaves} for name, leaves in per[0].items()}
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(cfg, params))[:, 0, :cfg.vocab]
    return logits, {"layers": layers, "length": S}


def init_decode_cache(cfg: ArchConfig, batch: int, capacity: int,
                      device: "torch.device | str" = "cuda") -> dict:
    """Empty cache at a given KV capacity (a mamba layer's state has no
    capacity)."""
    _check_no_moe(cfg)
    dt = DTYPES[cfg.compute_dtype]
    shape = (cfg.n_periods, batch, capacity, cfg.n_kv_heads, cfg.d_head)
    layers = {}
    for i, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            layers[f"l{i}"] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
        else:
            st = init_mamba_state(cfg, batch, dt, device=device)
            layers[f"l{i}"] = {key: t[None].repeat(cfg.n_periods,
                                                   *[1] * t.dim())
                               for key, t in st.items()}
    return {"layers": layers, "length": 0}


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                token: torch.Tensor):
    """token: (B, 1) -> (logits (B, V), cache).  One serve_step.

    Unlike the reference, which builds a new cache with
    ``dynamic_update_slice``, this writes the new k and v (index assignment
    at ``length``) and a mamba layer's new state and conv window into the
    cache's tensors in place and returns the same tensors under a new
    length: the caller's cache is updated too."""
    _check_no_moe(cfg)
    B = token.shape[0]
    length = int(cache["length"])
    positions = _positions(B, 1, token.device, start=length)
    h = embed_tokens(cfg, params, token)
    scale = cfg.d_head ** -0.5
    for n in range(cfg.n_periods):
        pp = _period(params, n)
        for i, spec in enumerate(cfg.period):
            lc = cache["layers"][f"l{i}"]
            if spec.kind == "attn":
                ap = pp[f"l{i}"]["attn"]
                kc, vc = lc["k"][n], lc["v"][n]
                hn = rms_norm(h, ap["norm"], cfg.norm_eps)
                q, k, v = _qkv(cfg, ap, hn, positions)
                kc[:, length] = k[:, 0].to(kc.dtype)
                vc[:, length] = v[:, 0].to(vc.dtype)
                o = decode_attention(q, kc, vc, length + 1, scale,
                                     layout=cfg.decode_cache_layout)
                h = h + o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ ap["wo"]
            else:
                st, h = mamba_decode_step(
                    cfg, pp[f"l{i}"]["mamba"],
                    {"h": lc["h"][n], "conv": lc["conv"][n]}, h)
                lc["h"][n].copy_(st["h"])
                lc["conv"][n].copy_(st["conv"])
            if spec.mlp == "dense":
                h = mlp_block(cfg, pp[f"l{i}"]["mlp"], h)
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(cfg, params))[:, 0, :cfg.vocab]
    return logits, {"layers": cache["layers"], "length": length + 1}
