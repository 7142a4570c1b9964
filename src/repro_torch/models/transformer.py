"""Decoder-only transformer LM: the port of ``repro/models/transformer.py``
for the dense and MoE archs of the zoo:

  granite-20b (MQA), olmo-1b (non-parametric LN, tied embeddings),
  qwen2-7b / qwen2.5-14b (GQA + QKV bias), musicgen-large (audio_stub
  frontend, 4 codebook heads), phi-3-vision (vision_stub prefix
  embeddings), qwen2-moe-a2.7b (shared + routed experts, padded to 64),
  arctic-480b (MoE + dense residual).

``repro`` stacks the layer parameters on a leading L axis for
``lax.scan``; the port keeps one dict per layer in a list
(``p["layers"][l]``, which ``bridge.params_from_repro`` unstacks) and
loops in Python.  The decode cache keeps ``repro``'s stacked layout:
k, v (L, b, S, hkv*dh) in the model dtype, or int8 with k_scale, v_scale
(L, b, S, 1) f32 for an int8 KV cache, and pos (b,) int32.

A prefill runs each layer's causal attention through ``ops.attention``
(K7 on the card, its plain version on the CPU), once a layer.  A decode
step runs per layer: the new k/v are written at each slot's position
and the token attends over the cache in plain PyTorch
(``blocks.decode_attention``), as ``repro`` leaves it to XLA.  There is
no cross-layer decode kernel for this family (``repro`` has no K3
instance for it): ``step_impl="megakernel"`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import blocks, moe
from repro_torch.parallel import sharding


def _layer_init(cfg, gen):
    p = {"norm1": blocks.norm_init(cfg),
         "attn": blocks.attention_init(cfg, gen),
         "norm2": blocks.norm_init(cfg)}
    if cfg.is_moe:
        p["moe"] = moe.moe_init(cfg, gen)
        if cfg.dense_residual:
            p["mlp"] = blocks.mlp_init(cfg, gen)
    else:
        p["mlp"] = blocks.mlp_init(cfg, gen)
    return p


def _layer_axes(cfg):
    p = {"norm1": blocks.norm_axes(cfg), "attn": blocks.attention_axes(cfg),
         "norm2": blocks.norm_axes(cfg)}
    if cfg.is_moe:
        p["moe"] = moe.moe_axes(cfg)
        if cfg.dense_residual:
            p["mlp"] = blocks.mlp_axes(cfg)
    else:
        p["mlp"] = blocks.mlp_axes(cfg)
    return p


def param_axes(cfg):
    """Logical axes of ``init``'s tree (``repro`` transformer.py:54-75,
    per layer without the stacked "layers" axis)."""
    p = {"embed": blocks.embed_axes(cfg), "norm_f": blocks.norm_axes(cfg)}
    if cfg.n_codebooks > 1:
        p["heads"] = {f"cb{i}": blocks.dense_axes("embed", "vocab")
                      for i in range(cfg.n_codebooks)}
    else:
        p["unembed"] = blocks.unembed_axes(cfg)
    p["layers"] = [_layer_axes(cfg) for _ in range(cfg.n_layers)]
    return p


def cache_axes(cfg):
    """Logical axes of ``init_cache``'s leaves (``repro``
    transformer.py:139-151)."""
    kv = ("layers", "act_batch", "act_seq", "act_ffn")
    out = {"k": kv, "v": kv}
    if cfg.kv_cache_dtype == "int8":
        sc = ("layers", "act_batch", "act_seq", None)
        out.update({"k_scale": sc, "v_scale": sc})
    out["pos"] = ("act_batch",)
    return out


def _zero_aux(device):
    return {"moe_lb": torch.zeros((), device=device),
            "moe_z": torch.zeros((), device=device)}


def _layer_apply(cfg, p, x, positions, cache=None, pos=None,
                 return_kv=False):
    """One pre-norm layer (``repro`` transformer.py:37).  Returns (x,
    the new KV cache of the layer or the prefill's k/v, aux)."""
    h, new_cache = blocks.attention_apply(
        cfg, p["attn"], blocks.apply_norm(cfg, p["norm1"], x), positions,
        cache=cache, pos=pos, return_kv=return_kv)
    x = x + h
    hn = blocks.apply_norm(cfg, p["norm2"], x)
    aux = _zero_aux(x.device)
    if cfg.is_moe:
        hm, aux = moe.moe_apply(cfg, p["moe"], hn)
        if cfg.dense_residual:
            hm = hm + blocks.mlp_apply(cfg, p["mlp"], hn)
    else:
        hm = blocks.mlp_apply(cfg, p["mlp"], hn)
    return x + hm, new_cache, aux


def init(cfg, gen):
    """Parameters from a ``torch.Generator``, drawn on its device."""
    p = {"embed": blocks.embed_init(cfg, gen),
         "norm_f": blocks.norm_init(cfg)}
    if cfg.n_codebooks > 1:
        p["heads"] = {f"cb{i}": blocks.dense_init(gen, cfg.d_model,
                                                  cfg.vocab)
                      for i in range(cfg.n_codebooks)}
    else:
        p["unembed"] = blocks.unembed_init(cfg, gen)
    p["layers"] = [_layer_init(cfg, gen) for _ in range(cfg.n_layers)]
    return p


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _positions(b, l, device):
    return torch.arange(l, device=device)[None].expand(b, l)


def _inputs_to_h(cfg, p, batch, dtype):
    """The (stub) frontend's first hidden state and its positions
    (``repro`` transformer.py:81): precomputed audio frame embeddings,
    image patch embeddings prepended to the tokens', or the tokens'."""
    if cfg.frontend == "audio_stub":
        h = batch["embeds"].to(dtype)
    elif cfg.frontend == "vision_stub":
        tok = blocks.embed_apply(cfg, p["embed"], batch["tokens"], dtype)
        h = torch.cat([batch["img_embeds"].to(dtype), tok], dim=1)
    else:
        h = blocks.embed_apply(cfg, p["embed"], batch["tokens"], dtype)
    return h, _positions(h.shape[0], h.shape[1], h.device)


def _logits(cfg, p, h):
    """(b, l, V), or (b, l, n_codebooks, V) for the multi-codebook heads
    (f32 inputs, as ``repro``)."""
    h = blocks.apply_norm(cfg, p["norm_f"], h)
    if cfg.n_codebooks > 1:
        return torch.stack([sharding.gather_cols(
            blocks.dense(p["heads"][f"cb{i}"], h.float()), cfg.vocab,
            "vocab") for i in range(cfg.n_codebooks)], dim=2)
    return blocks.unembed_apply(cfg, p.get("unembed", {}), p["embed"], h)


def forward(cfg, p, batch):
    """(logits, the summed aux losses); batch per frontend."""
    h, positions = _inputs_to_h(cfg, p, batch, _dtype(cfg))
    aux = _zero_aux(h.device)
    for lp in p["layers"]:
        h, _, a = _layer_apply(cfg, lp, h, positions)
        aux = {k: aux[k] + a[k] for k in aux}
    return _logits(cfg, p, h), aux


def init_cache(cfg, batch, max_seq, dtype, device):
    """Per-layer KV caches stacked on a leading layer axis (flat kv).
    Its leaves in the order of ``cache_slot_axes`` (k, v, the int8
    scales, pos), as every cache tree the family returns."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads * cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshape = (cfg.n_layers, batch, max_seq, 1)
        out = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
               "v": torch.zeros(shape, dtype=torch.int8, device=device),
               "k_scale": torch.zeros(sshape, device=device),
               "v_scale": torch.zeros(sshape, device=device)}
    else:
        out = {"k": torch.zeros(shape, dtype=dtype, device=device),
               "v": torch.zeros(shape, dtype=dtype, device=device)}
    out["pos"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return out


def cache_slot_axes(cfg):
    """Batch/slot axis index per cache leaf (layout matches init_cache)."""
    ax = {"k": 1, "v": 1}
    if cfg.kv_cache_dtype == "int8":
        ax.update({"k_scale": 1, "v_scale": 1})
    ax["pos"] = 0
    return ax


def _kv_keys(cache):
    return [k for k in ("k", "v", "k_scale", "v_scale") if k in cache]


def decode_step(cfg, p, cache, batch):
    """One token for every slot (``repro`` transformer.py:154):
    batch["tokens"] (b, 1), or batch["embeds"] (b, 1, d) for the audio
    stub.  Returns (logits (b, 1, V) or (b, 1, ncb, V), new cache); each
    layer's new k/v are written into fresh stacked leaves."""
    if ops.resolve_step_impl(cfg.step_impl) == "megakernel":
        raise NotImplementedError(
            f"family {cfg.family!r} has no megakernel decode path")
    dtype = _dtype(cfg)
    pos = cache["pos"]
    if cfg.frontend == "audio_stub":
        h = batch["embeds"].to(dtype)
    else:
        h = blocks.embed_apply(cfg, p["embed"], batch["tokens"], dtype)
    positions = pos[:, None]
    keys = _kv_keys(cache)
    new = {k: torch.empty_like(cache[k]) for k in keys}
    for i, lp in enumerate(p["layers"]):
        h, nc, _ = _layer_apply(cfg, lp, h, positions,
                                cache={k: cache[k][i] for k in keys},
                                pos=pos)
        for k in keys:
            new[k][i].copy_(nc[k])
    new["pos"] = pos + 1
    return _logits(cfg, p, h), new


def prefill(cfg, p, cache, batch):
    """Full-sequence forward that fills the decode cache (``repro``
    transformer.py:212): the rotated k/v of every layer, padded to the
    cache's max_seq (int8 codes and scales for an int8 KV cache), pos =
    the sequence length.  The returned cache is new."""
    h, positions = _inputs_to_h(cfg, p, batch, _dtype(cfg))
    b, l = h.shape[:2]
    S = cache["k"].shape[2]
    ks, vs = [], []
    for lp in p["layers"]:
        h, kv, _ = _layer_apply(cfg, lp, h, positions, return_kv=True)
        ks.append(kv["k"])
        vs.append(kv["v"])
    ks, vs = torch.stack(ks), torch.stack(vs)

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, 0, S - l))

    if cfg.kv_cache_dtype == "int8":
        kv_full = cfg.n_kv_heads * cfg.head_dim
        kq, ksc = blocks._kv_quant(ks, kv_full)
        vq, vsc = blocks._kv_quant(vs, kv_full)
        new = {"k": pad(kq), "v": pad(vq), "k_scale": pad(ksc),
               "v_scale": pad(vsc)}
    else:
        new = {"k": pad(ks).to(cache["k"].dtype),
               "v": pad(vs).to(cache["v"].dtype)}
    new["pos"] = torch.full((b,), l, dtype=torch.int32, device=h.device)
    return _logits(cfg, p, h), new
