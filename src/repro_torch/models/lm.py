"""Decoder-only LM over the layer-pattern abstraction, the port of
``repro.models.lm``: attention and mamba (SSD) layers with dense, MoE or no
MLPs.

Parameters are a plain dict of tensors in the reference's layout: every
leaf of ``params["stack"]`` carries a leading ``n_periods`` axis (the
reference's scan layout), and the port runs the periods as a Python loop
over views of that axis.

Entry points:
  lm_forward / lm_loss      — the training forward (logits, and the MoE
                              auxiliary loss) and its chunked
                              cross-entropy; lm_forward is also the
                              teacher-forcing oracle of decode
  prefill                   — build the KV / SSM caches for a prompt
  decode_step               — one token against the cache (serve_step)

On a card every attention of ``lm_forward``, ``lm_loss`` and ``prefill``
goes through the flash_attention kernel (K4) and every mamba layer of
``lm_forward`` and ``lm_loss`` through the ssd_scan kernel (K5), forward
and, in training, backward; prefill's
mamba layers run the plain chunked form and decode the recurrence, as the
reference's do.  MoE layers (``models/moe.py``) are plain tensor code on
both devices.  ``cfg.remat`` applies the reference's rematerialisation
policy (``_maybe_remat``) to each period of ``hidden_states``; it changes
what a backward pass keeps, not the values.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from .common import DTYPES, ArchConfig
from .layers import (_qkv, attention, decode_attention, init_attn, init_mlp,
                     init_norm, mlp_block, randn, rms_norm)
from .moe import init_moe, moe_block
from .sharding import (fit_spec, index_on, is_dtensor, logical_spec,
                       merge_dims, pad, placements, reduce_partial, shard,
                       sharded_call)
from .ssm import (init_mamba, init_mamba_state, mamba_block,
                  mamba_decode_step)

__all__ = ["init_lm", "lm_forward", "lm_loss", "prefill", "decode_step",
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
    if device is None:
        device = gen.device
    dt = DTYPES[cfg.param_dtype]
    lead = (cfg.n_periods,)
    stack: dict[str, Any] = {}
    for i, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            lp = {"attn": init_attn(cfg, gen, lead, device=device)}
        elif spec.kind == "mamba":
            lp = {"mamba": init_mamba(cfg, gen, lead, device=device)}
        else:
            raise ValueError(spec.kind)
        if spec.mlp == "dense":
            lp["mlp"] = init_mlp(cfg, gen, lead, device=device)
        elif spec.mlp == "moe":
            lp["moe"] = init_moe(cfg, gen, lead, device=device)
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
    return x + merge_dims(o, 2) @ p["wo"], k, v


def _apply_period(cfg: ArchConfig, pp: dict, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True,
                  cache: dict | None = None):
    """One period -> (x, aux), aux the sum of its MoE layers' auxiliary
    losses (float32), None without MoE layers.  With a `cache` dict
    (prefill) each layer's cache goes into it: k and v for attention, the
    SSD state and conv window for mamba (whose block then takes the chunked
    form, not the kernel)."""
    aux = None
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
        elif spec.mlp == "moe":
            x, a = moe_block(cfg, lp["moe"], x)
            aux = a if aux is None else aux + a
        # Megatron-SP: keep the residual stream sequence-sharded on the TP
        # axis between blocks (under a mesh; a no-op without one)
        x = shard(x, ("dp", "model" if cfg.seq_parallel else None, None))
    return x, aux


# the matrix products that remat="dots" keeps (the reference's
# checkpoint_dots_with_no_batch_dims: every dot without batch dimensions;
# here each product of an activation with a weight matrix)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    if op in _DOT_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg: ArchConfig, fn):
    """The reference's ``_maybe_remat``: "none" runs `fn` as it is, "full"
    keeps only its inputs for the backward pass (and runs it again there),
    "dots" keeps its matrix products and recomputes the rest."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return lambda *a: _ckpt.checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: _ckpt.create_selective_checkpoint_contexts(
                _keep_dots))
    if cfg.remat != "full":
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False)


def hidden_states(cfg: ArchConfig, params: dict, x: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True):
    """Run the stack on embedded inputs x: (B, S, d) -> (h, aux), aux the
    MoE layers' auxiliary losses summed over the stack (0 without MoE).
    Each period runs under ``_maybe_remat`` when a gradient is wanted."""

    def body(pp, h):
        h, a = _apply_period(cfg, pp, h, positions, causal)
        return h, (torch.zeros((), dtype=torch.float32, device=h.device)
                   if a is None else a)

    step = _maybe_remat(cfg, body) if torch.is_grad_enabled() else body
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for n in range(cfg.n_periods):
        x, a = step(_period(params, n), x)
        aux = aux + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def embed_tokens(cfg: ArchConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the embedding (``F.embedding``: the same gather as
    ``embed[tokens]``, and a backward that sums into the table in a fixed
    order on a card, where indexing's backward accumulates with atomics)."""
    return shard(lookup(params["embed"], tokens, F.embedding),
                 ("dp", None, None))


def lookup(table: torch.Tensor, tokens: torch.Tensor, take) -> torch.Tensor:
    """``take(tokens, table)``, the rows of `table` at `tokens`.  On a
    DTensor table split over its rows (vocab TP) each rank looks up the
    tokens that fall in its own rows and zeros the rest, and the result is
    a ``Partial`` sum over those mesh dims (the vocab-parallel embedding;
    DTensor's own rule for it cannot take a gradient back through a
    second use of the table).  The rows a rank holds travel as an arange
    placed like the table, so no rank needs its coordinate."""
    if not is_dtensor(table):
        return take(tokens, table)
    from torch.distributed.tensor import Partial

    mesh = table.device_mesh
    rows = index_on(torch.arange(table.shape[0],
                                 device=table.to_local().device),
                    table.placements, 0, mesh)
    row_pl = tuple(rows.placements)
    dp = (logical_spec(("dp",)) or (None,))[0]
    tok_spec = fit_spec((dp,), tokens.shape, mesh, drop_trivial=True)
    out_pl = [Partial() if pl.is_shard() else tp for pl, tp in
              zip(row_pl, placements(tok_spec, mesh))]

    def local(tok, tab, own):
        idx = tok - own[0]
        hit = (idx >= 0) & (idx < own.shape[0])
        out = take(idx.clamp(0, own.shape[0] - 1), tab)
        return torch.where(hit[..., None], out, torch.zeros((), dtype=out.dtype,
                                                            device=out.device))

    return sharded_call(local, (tokens, table, rows),
                        (tok_spec, tuple(table.placements), row_pl),
                        tuple(out_pl), mesh)


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
    return shard(h @ unembed_matrix(cfg, params), ("dp", None, "model")), aux


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp(logits) - logits[label] at each position (labels clamped
    at 0).  When the logits are a DTensor sharded on the vocabulary, the
    vocab-parallel form: the max and the sum of exponentials reduce over
    the shards (two small all-reduces) and the gold logit is a masked sum,
    where a gather across shards would move the logits; otherwise
    ``logsumexp`` and ``gather``, so no bit moves on one card."""
    lb = labels.clamp(min=0).long()
    if is_dtensor(logits) and any(pl.is_shard(logits.dim() - 1)
                                  for pl in logits.placements):
        from torch.distributed.tensor import Partial

        mesh, last = logits.device_mesh, logits.dim() - 1
        # the max and the sum over the shards summed whole (all-reduces of
        # (B, C) floats): left Partial, DTensor would reduce-scatter them
        # over the batch and move the logits to match in the backward
        m = reduce_partial(logits.detach().amax(dim=-1, keepdim=True))
        logz = m + torch.log(reduce_partial(
            torch.exp(logits - m).sum(-1, keepdim=True)))
        # the gold logit on the shard that holds it, the vocabulary ids
        # placed like the logits' last dim
        ids = index_on(torch.arange(logits.shape[-1],
                                    device=logits.to_local().device),
                       logits.placements, last, mesh)
        gold = sharded_call(
            lambda lg, lab, own: torch.where(own == lab[..., None], lg,
                                             0.0).sum(-1),
            (logits, lb, ids),
            (tuple(logits.placements), tuple(lb.placements),
             tuple(ids.placements)),
            tuple(Partial() if pl.is_shard(last) else pl
                  for pl in logits.placements), mesh)
        return logz[..., 0] - gold
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, lb[..., None])[..., 0]


def lm_loss(cfg: ArchConfig, params: dict, tokens: torch.Tensor | None,
            labels: torch.Tensor, aux_weight: float = 0.01,
            loss_chunk: int | None = None,
            inputs_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked cross-entropy (float32 scalar): the logits exist one
    sequence chunk of ``loss_chunk`` positions at a time (``cfg.loss_chunk``
    by default, 0 = the whole sequence), the tail of S padded with label
    -1; the padded vocabulary is masked, labels -1 are ignored, and the MoE
    auxiliary loss is added with ``aux_weight``.  ``inputs_embeds`` (B, S,
    d) replaces the token embeddings (the VLM's patch prefix)."""
    B, S = labels.shape
    positions = _positions(B, S, labels.device)
    x = inputs_embeds if inputs_embeds is not None \
        else embed_tokens(cfg, params, tokens)
    h, aux = hidden_states(cfg, params, x, positions)
    w = unembed_matrix(cfg, params)

    if loss_chunk is None:
        loss_chunk = cfg.loss_chunk
    C = min(loss_chunk, S) if loss_chunk > 0 else S
    n_pad = (-S) % C
    if n_pad:
        h = pad(h, (0, 0, 0, n_pad))
        labels = pad(labels, (0, n_pad), value=-1)
    vocab_mask = torch.arange(cfg.padded_vocab, device=h.device) < cfg.vocab
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.long, device=h.device)
    for c0 in range(0, h.shape[1], C):
        lb = labels[:, c0:c0 + C]
        logits = shard(h[:, c0:c0 + C] @ w, ("dp", None, "model")).float()
        logits = torch.where(vocab_mask, logits, -1e30)
        valid = lb >= 0
        total = total + torch.where(valid, token_nll(logits, lb), 0.0).sum()
        count = count + valid.sum()
    return total / torch.clamp(count, min=1) + aux_weight * aux


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
    B, S = tokens.shape[:2]
    positions = _positions(B, S, tokens.device)
    h = inputs_embeds if inputs_embeds is not None \
        else embed_tokens(cfg, params, tokens)
    per: list[dict] = []
    for n in range(cfg.n_periods):
        cache_p: dict = {}
        h, _ = _apply_period(cfg, _period(params, n), h, positions, True,
                             cache_p)
        per.append(cache_p)
    layers = {name: {key: torch.stack([c[name][key] for c in per])
                     for key in leaves} for name, leaves in per[0].items()}
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(cfg, params))[:, 0, :cfg.vocab]
    return shard(logits, ("dp", None)), {"layers": layers, "length": S}


def init_decode_cache(cfg: ArchConfig, batch: int, capacity: int,
                      device: "torch.device | str" = "cuda") -> dict:
    """Empty cache at a given KV capacity (a mamba layer's state has no
    capacity)."""
    dt = DTYPES[cfg.compute_dtype]
    shape = (cfg.n_periods, batch, capacity, cfg.n_kv_heads, cfg.d_head)
    layers = {}
    for i, spec in enumerate(cfg.period):
        if spec.kind == "attn":
            layers[f"l{i}"] = {
                key: shard(torch.zeros(shape, dtype=dt, device=device),
                           (None, "dp", "sp", "model", None))
                for key in ("k", "v")}
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
                h = h + merge_dims(o, 2) @ ap["wo"]
            else:
                st, h = mamba_decode_step(
                    cfg, pp[f"l{i}"]["mamba"],
                    {"h": lc["h"][n], "conv": lc["conv"][n]}, h)
                lc["h"][n].copy_(st["h"])
                lc["conv"][n].copy_(st["conv"])
            if spec.mlp == "dense":
                h = mlp_block(cfg, pp[f"l{i}"]["mlp"], h)
            elif spec.mlp == "moe":
                h, _ = moe_block(cfg, pp[f"l{i}"]["moe"], h)
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ unembed_matrix(cfg, params))[:, 0, :cfg.vocab]
    return shard(logits, ("dp", None)), {"layers": cache["layers"],
                                         "length": length + 1}
