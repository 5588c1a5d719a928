"""Encoder-decoder stack (Whisper backbone), the port of
``repro.models.encdec``.  The audio conv frontend is a stub, as in the
reference: the encoder takes precomputed mel-frame embeddings (B, T_enc,
d_model); the encoder is a non-causal transformer and the decoder adds
cross-attention.  Positions are sinusoidal (stateless), the reference's
adaptation of Whisper's learned tables.

Parameters are a plain dict of tensors in the reference's layout, the
encoder's and the decoder's layers stacked (a leading n_encoder_layers or
n_periods axis on every leaf of ``enc_stack`` / ``dec_stack``); the port
runs the layers as a Python loop over views of that axis.  On a card every
``attention`` (the encoder's, the decoder's causal self-attention and its
cross-attention over the encoder's output) goes through the
flash_attention kernel (K4); decode attention is plain tensor code, as the
reference's.  ``encdec_decode_step`` writes the new self-attention k and v
into the cache's tensors in place, as ``lm.decode_step`` does.
"""
from __future__ import annotations

import torch

from .common import DTYPES, ArchConfig
from .layers import (_qkv, attention, decode_attention, init_attn, init_mlp,
                     init_norm, mlp_block, randn, rms_norm)
from .lm import _positions, lookup, token_nll, tree_map
from .sharding import merge_dims, shard, split_dim

__all__ = ["init_encdec", "encdec_forward", "encdec_loss", "encdec_prefill",
           "encdec_decode_step", "init_encdec_cache", "sinusoidal", "encode"]


def sinusoidal(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    step = torch.log(torch.tensor(10000.0)) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                      * step).to(positions.device)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def init_encdec(cfg: ArchConfig, gen: "torch.Generator | None",
                device: "torch.device | str | None" = None) -> dict:
    """Random parameters from `gen`, with the reference's shapes and
    scales (not its bits); ``device="meta"`` builds the shapes only."""
    if device is None:
        device = gen.device
    dt = DTYPES[cfg.param_dtype]
    enc = (cfg.n_encoder_layers,)
    dec = (cfg.n_periods,)
    return {
        "embed": randn((cfg.padded_vocab, cfg.d_model), gen, device, 0.02,
                       dt),
        "enc_stack": {"attn": init_attn(cfg, gen, enc, device=device),
                      "mlp": init_mlp(cfg, gen, enc, device=device)},
        "dec_stack": {"attn": init_attn(cfg, gen, dec, device=device),
                      "cross": init_attn(cfg, gen, dec, device=device),
                      "mlp": init_mlp(cfg, gen, dec, device=device)},
        "enc_norm": init_norm(cfg.d_model, dt, device=device),
        "final_norm": init_norm(cfg.d_model, dt, device=device),
        "unembed": randn((cfg.d_model, cfg.padded_vocab), gen, device,
                         cfg.d_model ** -0.5, dt),
    }


def _layer(stack: dict, n: int) -> dict:
    return tree_map(lambda x: x[n], stack)


def _self_attn(cfg: ArchConfig, p: dict, h: torch.Tensor,
               pos: torch.Tensor, causal: bool):
    """Pre-norm self-attention without rope; also returns k and v."""
    hn = rms_norm(h, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, hn, pos, rope_on=False)
    o = attention(cfg, q, k, v, causal=causal)
    return h + merge_dims(o, 2) @ p["wo"], k, v


def encode(cfg: ArchConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, d) precomputed embeddings (conv frontend stub)."""
    B, T, _ = frames.shape
    pos = _positions(B, T, frames.device)
    x = frames + sinusoidal(pos, cfg.d_model, frames.dtype)
    x = shard(x, ("dp", None, None))
    for n in range(cfg.n_encoder_layers):
        lp = _layer(params["enc_stack"], n)
        x, _, _ = _self_attn(cfg, lp["attn"], x, pos, causal=False)
        x = mlp_block(cfg, lp["mlp"], x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(cfg: ArchConfig, lp: dict, enc_out: torch.Tensor):
    B, T, _ = enc_out.shape
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    k = enc_out @ lp["wk"]
    v = enc_out @ lp["wv"]
    if "bk" in lp:
        k, v = k + lp["bk"], v + lp["bv"]
    return split_dim(k, 2, (hkv, dh)), split_dim(v, 2, (hkv, dh))


def _cross_q(cfg: ArchConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    B, S, _ = h.shape
    hn = rms_norm(h, lp["norm"], cfg.norm_eps)
    q = hn @ lp["wq"]
    if "bq" in lp:
        q = q + lp["bq"]
    return split_dim(q, 2, (cfg.n_heads, cfg.d_head))


def _dec_layer(cfg: ArchConfig, lp: dict, h: torch.Tensor,
               pos: torch.Tensor, enc_out: torch.Tensor):
    """One decoder layer over a whole prompt -> (h, self k, self v,
    cross k, cross v)."""
    h, k, v = _self_attn(cfg, lp["attn"], h, pos, causal=True)
    qc = _cross_q(cfg, lp["cross"], h)
    kc, vc = _cross_kv(cfg, lp["cross"], enc_out)
    o = attention(cfg, qc, kc, vc, causal=False)
    h = h + merge_dims(o, 2) @ lp["cross"]["wo"]
    return mlp_block(cfg, lp["mlp"], h), k, v, kc, vc


def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return lookup(emb, tokens, lambda t, e: e[t]) \
        + sinusoidal(pos, cfg.d_model, emb.dtype)


def encdec_forward(cfg: ArchConfig, params: dict, frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """-> logits (B, S, V_padded)."""
    enc_out = encode(cfg, params, frames)
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = shard(_embed(cfg, params, tokens, pos), ("dp", None, None))
    for n in range(cfg.n_periods):
        x = _dec_layer(cfg, _layer(params["dec_stack"], n), x, pos,
                       enc_out)[0]
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return shard(h @ params["unembed"], ("dp", None, "model"))


def encdec_loss(cfg: ArchConfig, params: dict, frames: torch.Tensor,
                tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy (float32) over labels >= 0, the padded
    vocabulary masked."""
    logits = encdec_forward(cfg, params, frames, tokens).float()
    vocab_mask = torch.arange(cfg.padded_vocab,
                              device=logits.device) < cfg.vocab
    logits = torch.where(vocab_mask, logits, -1e30)
    valid = labels >= 0
    return torch.where(valid, token_nll(logits, labels), 0.0).sum() \
        / torch.clamp(valid.sum(), min=1)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_encdec_cache(cfg: ArchConfig, batch: int, capacity: int,
                      device: "torch.device | str" = "cuda") -> dict:
    dt = DTYPES[cfg.compute_dtype]
    L = cfg.n_periods

    def kv(s):
        return torch.zeros((L, batch, s, cfg.n_kv_heads, cfg.d_head),
                           dtype=dt, device=device)

    return {"self_k": kv(capacity), "self_v": kv(capacity),
            "cross_k": kv(cfg.encoder_seq), "cross_v": kv(cfg.encoder_seq),
            "length": 0}


def encdec_prefill(cfg: ArchConfig, params: dict, frames: torch.Tensor,
                   tokens: torch.Tensor, capacity: int | None = None):
    """Encode + run the decoder prompt, building the self-attention cache
    (padded to `capacity`, ``cfg.max_seq`` by default) and the
    cross-attention cache.  Returns (last-position logits (B, V), cache);
    the cache's leaves are stacked per decoder layer, ``length`` a Python
    int."""
    enc_out = encode(cfg, params, frames)
    B, S = tokens.shape
    cap = capacity or cfg.max_seq
    pos = _positions(B, S, tokens.device)
    h = _embed(cfg, params, tokens, pos)
    per = []
    for n in range(cfg.n_periods):
        h, k, v, kc, vc = _dec_layer(cfg, _layer(params["dec_stack"], n), h,
                                     pos, enc_out)
        per.append((k, v, kc, vc))

    def stacked(j, size=None):
        t = torch.stack([c[j] for c in per])
        if size is None:
            return t
        out = t.new_zeros((t.shape[0], B, size, *t.shape[3:]))
        out[:, :, :S] = t
        return out

    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ params["unembed"])[:, 0, :cfg.vocab]
    return shard(logits, ("dp", None)), {"self_k": stacked(0, cap), "self_v": stacked(1, cap),
                    "cross_k": stacked(2), "cross_v": stacked(3),
                    "length": S}


def encdec_decode_step(cfg: ArchConfig, params: dict, cache: dict,
                       token: torch.Tensor):
    """token: (B, 1) -> (logits (B, V), cache); the new k and v go into the
    cache's self-attention tensors in place."""
    B = token.shape[0]
    length = int(cache["length"])
    pos = _positions(B, 1, token.device, start=length)
    h = _embed(cfg, params, token, pos)
    scale = cfg.d_head ** -0.5
    n_cross = cache["cross_k"].shape[2]
    for n in range(cfg.n_periods):
        lp = _layer(params["dec_stack"], n)
        sk, sv = cache["self_k"][n], cache["self_v"][n]
        hn = rms_norm(h, lp["attn"]["norm"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp["attn"], hn, pos, rope_on=False)
        sk[:, length] = k[:, 0].to(sk.dtype)
        sv[:, length] = v[:, 0].to(sv.dtype)
        o = decode_attention(q, sk, sv, length + 1, scale,
                             layout=cfg.decode_cache_layout)
        h = h + merge_dims(o, 2) @ lp["attn"]["wo"]
        qc = _cross_q(cfg, lp["cross"], h)
        o = decode_attention(qc, cache["cross_k"][n], cache["cross_v"][n],
                             n_cross, scale, layout=cfg.decode_cache_layout)
        h = h + merge_dims(o, 2) @ lp["cross"]["wo"]
        h = mlp_block(cfg, lp["mlp"], h)
    h = rms_norm(h[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (h @ params["unembed"])[:, 0, :cfg.vocab]
    return shard(logits, ("dp", None)), dict(cache, length=length + 1)
