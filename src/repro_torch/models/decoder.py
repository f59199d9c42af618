"""Decoder-only LM: every layout of the ported architectures.

Parameters live in per-kind *stacks* (leading axis = number of layers of
that kind), as in ``repro/models/decoder.py``; ``default_layout`` maps each
layer to its mixer (``attn``, ``local_attn``, ``rglru`` or ``ssd``; a local
attention layer draws from the ``attn`` stack) and its FFN (``dense`` or
none, indexed by ``ffn_idx``). The layer loop is one Python loop over the
layout: it stands for JAX's uniform ``lax.scan``, its unrolled loop and its
pattern-group scan (``_forward_pattern_groups``, a compile-size device with
the same math). RAP's masked mode multiplies each residual branch by a 0/1
gate: ``gates`` = {"mixer": [L] or [L, B], "ffn": ...}; the [L, B] form
gives every batch row its own keep-mask (continuous batching, and the
batched GSI scoring forward). Every entry point also takes a ``layout``
(default :func:`default_layout`): structural mode runs a retained-layer
layout (``repro_torch.core.masks``) whose rows may lack a mixer or an FFN
(a half-pruned layer; a mamba2 row can lack both) — such a block is
skipped — and whose gates, caches and page-pool layers are indexed by
layout row; an empty layout runs no layer.

Decode runs against a slot cache (:func:`init_cache`: per kind, a dense
``[n, B, S_max, K, Dh]`` attention cache — model-dtype or int8 with
per-(token, head) scales —, a ring buffer of ``min(window, S_max)`` tokens
for local attention, and f32 recurrent / SSM state with its conv buffer;
:func:`decode_step`, :func:`decode_horizon`) or, for uniform all-attention
layouts only, a page pool (:func:`paged_decode_step`,
:func:`paged_decode_horizon`) and chunked prefill. A vision-language model
(``family="vlm"``, internvl2-1b) is the dense decoder with precomputed
patch embeddings prepended to the token stream (``extra_embeds`` on
:func:`forward` and :func:`prefill`). An MoE model (olmoe, dbrx) has
``moe`` FFN rows (``models/moe.py``, the scatter dispatch; ``groups`` on
:func:`forward` gives each group of batch rows its own expert capacity,
as JAX's ``vmap`` over scoring candidates does). Encoder-decoder models
(whisper) have their own module, ``models/encdec.py``, built by
``registry.build``; the decoder-only entry points here refuse them.

Under a mesh policy with a model axis wider than one
(``parallel.activation.use``), ``params`` are this rank's blocks
(``parallel.sharding``) and every block computes its part: the embedding
looks up its vocab rows (:func:`embed_lookup`), the head gives its vocab
columns (:func:`vocab_logits`, gathered unless the greedy path reads them
through :func:`greedy`), and attention, FFN, RG-LRU and MoE blocks their
heads, features, width and experts (``parallel.tp``); caches hold the
rank's KV heads and width (:func:`local_cfg`). Where the policy carries
``cache_specs`` (``ShardedExecutor.lower_decode``, the dry run), the
decode cache is instead in the layout of ``parallel.sharding.cache_pspecs``
(:func:`local_cache`): every KV head and the whole width, axis 2 cut where
the specs say (``tp.cache_cut``), each kind's step joining its blocks.

Sequence parallelism: under a model axis m > 1 a stream of S >= 2048
positions that m divides (``parallel.activation.seq_sharded``) is cut
along S between the blocks: the embedding reduce-scatters it, each block
runs inside ``tp.seq_split`` (gathering the sequence at its entry and
cutting it at its exit; the pre-norms act on this rank's rows), and the
stream is gathered back before the final norm and the head, so the
logits, the hidden state and the caches keep their shapes.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention, ffn as ffn_mod, layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod, ssm as ssm_mod
from repro_torch.parallel import activation as act
from repro_torch.parallel import tp


class LayerSlot(NamedTuple):
    mixer: Optional[str]   # attn|local_attn|rglru|ssd|None
    mixer_idx: int         # index into the kind's stack
    ffn: Optional[str]     # dense|moe|None
    ffn_idx: int


def default_layout(cfg) -> Tuple[LayerSlot, ...]:
    slots = []
    counts: Dict[str, int] = {}
    for mixer, f in cfg.layer_specs():
        mk = "attn" if mixer == "local_attn" else mixer
        mi = counts.get(mk, 0)
        counts[mk] = mi + 1
        if f == "none":
            fk, fi = None, 0
        else:
            fi = counts.get(f, 0)
            counts[f] = fi + 1
            fk = f
        slots.append(LayerSlot(mixer, mi, fk, fi))
    return tuple(slots)


def layout_counts(layout) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for s in layout:
        if s.mixer is not None:
            mk = "attn" if s.mixer == "local_attn" else s.mixer
            counts[mk] = max(counts.get(mk, 0), s.mixer_idx + 1)
        if s.ffn is not None:
            counts[s.ffn] = max(counts.get(s.ffn, 0), s.ffn_idx + 1)
    return counts


def check_supported(cfg) -> None:
    """Refuse an encoder-decoder config: its layers, caches and entry points
    are ``models/encdec.py``'s (``registry.build`` picks them), not this
    decoder-only module's."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name!r} is an encoder-decoder model: the decoder-only "
            f"entry points do not run it; build it with registry.build "
            f"(models/encdec.py)")


def is_attn_layout(cfg, layout=None) -> bool:
    """Uniform all-attention layout (``layout``, default the config's): the
    only kind with a positional KV write frontier, so the only one chunked
    prefill and page pools serve. A half-pruned row breaks uniformity."""
    layout = default_layout(cfg) if layout is None else layout
    return bool(layout) and all(s.mixer == "attn" and s.ffn == layout[0].ffn
                                for s in layout)


def require_attn_layout(cfg, what: str, layout=None) -> None:
    """Raise unless ``what`` (a path that pages or chunks the KV cache) can
    serve ``layout`` (default the config's) of ``cfg``."""
    check_supported(cfg)
    if not is_attn_layout(cfg, layout):
        layout = default_layout(cfg) if layout is None else layout
        raise NotImplementedError(
            f"{what} serves uniform all-attention layouts; {cfg.name!r} mixes "
            f"{sorted({str(s.mixer) for s in layout})} — "
            f"heterogeneous models serve on slot caches (LocalExecutor: "
            f"prefill, decode_step)")


# --------------------------------------------------------------------- params
_INIT = {"attn": attention.init_attn_params,
         "rglru": rglru_mod.init_rglru_params,
         "ssd": ssm_mod.init_ssd_params,
         "dense": ffn_mod.init_ffn_params,
         "moe": moe_mod.init_moe_params}


def init_params(gen: torch.Generator, cfg, device) -> dict:
    """Random parameters drawn from ``gen`` on ``device``, in the JAX
    package's pytree layout (see ``repro_torch.bridge``): one stack per
    kind of the layout, each with its pre-norm."""
    check_supported(cfg)
    counts = layout_counts(default_layout(cfg))
    pd = cfg.torch_param_dtype()
    embed = torch.empty(cfg.vocab_padded, cfg.d_model, dtype=pd, device=device)
    params: dict = {"embed": layers.embed_init_(embed, gen),
                    "final_norm": layers.init_norm(cfg, device=device)}
    if not cfg.tie_embeddings:
        head = torch.empty(cfg.d_model, cfg.vocab_padded, dtype=pd,
                           device=device)
        params["lm_head"] = layers.dense_init_(head, gen)
    params["stacks"] = {}
    for kind in sorted(counts):
        params["stacks"][kind] = dict(
            norm=layers.init_norm(cfg, counts[kind], device=device),
            **_INIT[kind](gen, cfg, counts[kind], device))
    return params


def tree_slice(tree, idx: int):
    if isinstance(tree, dict):
        return {k: tree_slice(v, idx) for k, v in tree.items()}
    return tree[idx]


# --------------------------------------------------------------- helpers
def _lookup(params, cfg, tokens):
    """(rows, partial): ``params["embed"]`` rows of ``tokens`` in the model
    dtype; with the table cut on vocab (``parallel.tp``), this rank's rows
    only, zeros for ids outside them (``partial``)."""
    emb = params["embed"]
    if tp.block_mode(params, {"embed": (0, cfg.vocab_padded)},
                     "embed") != "partial":
        return emb[tokens].to(cfg.torch_dtype()), False
    v = emb.shape[0]
    ids = tokens - tp.active().mrank * v
    inside = ((ids >= 0) & (ids < v))[..., None]
    h = emb[torch.clamp(ids, 0, v - 1)].to(cfg.torch_dtype())
    return torch.where(inside, h, torch.zeros((), dtype=h.dtype,
                                              device=h.device)), True


def embed_lookup(params, cfg, tokens):
    """``params["embed"]`` rows of ``tokens`` in the model dtype. Under a
    model axis with the table cut on vocab (``parallel.tp``), each rank
    looks up the ids in its rows (zeros elsewhere) and the rows are summed
    over "model": one nonzero term per id, so the lookup is exact."""
    h, partial = _lookup(params, cfg, tokens)
    return tp.reduce_from(h) if partial else h


def vocab_logits(cfg, h, w, *, gather: bool = True):
    """f32 logits ``h @ w`` (``w [D, Vp]``, the LM head or the tied
    embedding's transpose). Under a model axis with ``w`` cut on vocab:
    this rank's columns, all-gathered unless ``gather=False`` (the greedy
    path reads them through ``tp.argmax``)."""
    if not _vocab_cut(cfg, w):
        return torch.matmul(h, w.to(h.dtype)).float()
    local = torch.matmul(tp.copy_to(h), w.to(h.dtype)).float()
    return tp.gather(local, -1, partial=False) if gather else local


def _vocab_cut(cfg, x) -> bool:
    """Whether ``x [..., V]`` (a head, logits) is this rank's cut of the
    vocab (``parallel.tp.block_mode``)."""
    return tp.block_mode({"x": x}, {"x": (-1, cfg.vocab_padded)},
                         "x") == "partial"


def greedy(cfg, logits) -> torch.Tensor:
    """int32 argmax over the vocab of logits [..., V]: the whole row, or
    the rank's vocab columns (``vocab_logits(..., gather=False)``) through
    ``tp.argmax``."""
    if _vocab_cut(cfg, logits):
        return tp.argmax(logits).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _embed(params, cfg, tokens, extra_embeds=None, sp: bool = False):
    """Token embeddings in the model dtype (times sqrt(d_model), rounded
    to that dtype first as in JAX, under ``embed_scale``), with
    ``extra_embeds [B, P, D]`` (a vision model's patch embeddings)
    prepended: [B, P + S, D]. ``sp`` (sequence parallelism): this rank's
    rows of it, the vocab-cut lookup reduce-scattered (the prefix added
    on model rank 0 alone, so the sum holds it once)."""
    h, partial = (_lookup(params, cfg, tokens) if sp
                  else (embed_lookup(params, cfg, tokens), False))
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    if extra_embeds is not None:
        pre = extra_embeds.to(h.dtype)
        if partial and tp.active().mrank != 0:
            pre = torch.zeros_like(pre)
        h = torch.cat([pre, h], dim=1)
    if not sp:
        return h
    return tp.scatter_seq(h) if partial else tp.split_seq(h)


def _seq_len(tokens, extra_embeds) -> int:
    """Positions of the stream: the tokens and a vision prefix."""
    return tokens.shape[1] + (extra_embeds.shape[1]
                              if extra_embeds is not None else 0)


def _norm(cfg, p, h):
    """A block's pre-norm (``p``: its params) of the stream ``h``; inside
    ``tp.seq_split`` the scales act on this rank's rows
    (``tp.seq_replicated``)."""
    return layers.apply_norm(cfg, tp.seq_replicated(p), h)


def _unembed(params, cfg, h, *, gather: bool = True):
    """Final norm + LM head → f32 logits. The product runs in the model
    dtype (JAX accumulates a bf16 einsum straight into f32; here a bf16
    product is rounded once before the cast). ``gather`` as in
    :func:`vocab_logits`."""
    h = layers.apply_norm(cfg, params["final_norm"], h)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return vocab_logits(cfg, h, w, gather=gather)


def _ones_gates(n_layers: int, device):
    return {"mixer": torch.ones(n_layers, device=device),
            "ffn": torch.ones(n_layers, device=device)}


def _bgate(g, ref):
    """Broadcast one layer's gate against an activation [B, S, D]: a scalar
    (one keep-mask for the batch) or a [B] row (one keep-mask per row)."""
    g = g.to(ref.dtype)
    if g.ndim == 0:
        return g
    return g.reshape(g.shape + (1,) * (ref.ndim - g.ndim))


def _mixer_params(params, slot: LayerSlot) -> dict:
    mk = "attn" if slot.mixer == "local_attn" else slot.mixer
    return tree_slice(params["stacks"][mk], slot.mixer_idx)


def _window(cfg, slot: LayerSlot) -> int:
    return cfg.attn_window if slot.mixer == "local_attn" else 0


def _apply_mixer(kind: str, p, cfg, h, positions, sp: bool = False):
    """Norm, then the mixer ``kind`` (``attn``, ``local_attn``, ``rglru``
    or ``ssd``) over the full sequence: its output [B, S, D] (this rank's
    rows of it under ``sp``)."""
    with tp.seq_split(sp):
        hn = _norm(cfg, p["norm"], h)
        if kind == "rglru":
            return rglru_mod.rglru_mixer(p, cfg, hn)
        if kind == "ssd":
            return ssm_mod.ssd_mixer(p, cfg, hn)
        window = cfg.attn_window if kind == "local_attn" else 0
        return attention.attention(p, cfg, hn, positions, window=window)[0]


def _apply_ffn(kind: str, p, cfg, h, groups: int = 1, sp: bool = False):
    """Norm, then the FFN ``kind`` (``dense``, or ``moe``: the scatter
    dispatch, ``groups`` independent token groups along the batch axis):
    its output [B, S, D] (this rank's rows under ``sp``)."""
    with tp.seq_split(sp):
        hn = _norm(cfg, p["norm"], h)
        if kind == "moe":
            return moe_mod.moe_ffn(p, cfg, hn, groups=groups)
        return ffn_mod.ffn(p, cfg, hn)


def _checkpointed(fn, remat: bool):
    """``fn`` rematerialised in the backward (``remat``), else as it is."""
    if not remat:
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False)


def _block(params, cfg, slot: LayerSlot, i: int, h, gates, mixer_out, *,
           remat: bool = False, groups: int = 1, sp: bool = False):
    """Residual updates of layout row ``i`` around its mixer output: the
    gated mixer branch (none for a pruned mixer, ``mixer_out`` None), then
    the gated FFN branch (none in mamba2 or for a pruned FFN; recomputed
    in the backward under ``remat``; ``groups`` as in :func:`forward`;
    ``sp``: ``h`` is this rank's rows)."""
    if mixer_out is not None:
        h = h + _bgate(gates["mixer"][i], h) * mixer_out
    if slot.ffn is None:
        return h
    pf = tree_slice(params["stacks"][slot.ffn], slot.ffn_idx)
    out = _checkpointed(lambda x: _apply_ffn(slot.ffn, pf, cfg, x, groups,
                                             sp), remat)(h)
    return h + _bgate(gates["ffn"][i], h) * out


def _cache_indices(layout) -> List[int]:
    """Per-layer index into its mixer kind's cache stack (``local_attn``
    counts apart from ``attn``: it has its own cache)."""
    counters: Dict[str, int] = {}
    idx = []
    for s in layout:
        if s.mixer is None:
            idx.append(-1)
            continue
        i = counters.get(s.mixer, 0)
        counters[s.mixer] = i + 1
        idx.append(i)
    return idx


# -------------------------------------------------------------------- forward
def forward(params, cfg, tokens, *, gates=None, extra_embeds=None,
            unembed: bool = True, layout=None, remat: bool = False,
            groups: int = 1):
    """Full-sequence forward. Returns (logits f32 [B,S,Vp], None), S
    counting the ``extra_embeds`` prefix (positions 0..P-1 are its);
    ``unembed=False`` returns the pre-final-norm hidden state instead.
    ``remat`` recomputes each mixer and each FFN block in the backward
    (``torch.utils.checkpoint``, the twin of JAX's per-block
    ``jax.checkpoint``): activation memory of one block at a time, at the
    cost of a second forward — and a second launch of its kernels.
    ``groups`` (dividing B) makes each group of B / groups consecutive
    rows an independent call of the MoE FFN (its own capacity and drop
    ranking); a model without MoE rows ignores it. Sequence parallelism
    (module docstring) applies where the stream qualifies."""
    check_supported(cfg)
    layout = default_layout(cfg) if layout is None else layout
    gates = gates or _ones_gates(len(layout), tokens.device)
    S = _seq_len(tokens, extra_embeds)
    sp = act.seq_sharded(S)
    h = _embed(params, cfg, tokens, extra_embeds, sp)
    positions = torch.arange(S, device=h.device)[None, :]
    for i, slot in enumerate(layout):
        out = None
        if slot.mixer is not None:
            pm = _mixer_params(params, slot)
            out = _checkpointed(
                lambda x, pm=pm, kind=slot.mixer: _apply_mixer(
                    kind, pm, cfg, x, positions, sp), remat)(h)
        h = _block(params, cfg, slot, i, h, gates, out, remat=remat,
                   groups=groups, sp=sp)
    if sp:
        h = tp.gather_seq(h, partial=False)
    if not unembed:
        return h, None
    return _unembed(params, cfg, h), None


# ---------------------------------------------------------------------- cache
def local_cfg(params, cfg):
    """The config whose cache shapes this rank holds: ``cfg`` itself, or
    under a model axis (``parallel.tp``) its K/m KV heads where the heads
    divide it and its W/m RG-LRU width where that block is cut (read from
    this rank's weights)."""
    pol = tp.active()
    if pol is None:
        return cfg
    kw = {}
    st = params["stacks"]
    if "attn" in st:        # the decoder's (and whisper's) self-attention
        mode, kv_sel = attention._tp_mode(st["attn"], cfg)
        if mode == "partial" and kv_sel is None:
            kw.update(n_kv_heads=cfg.n_kv_heads // pol.nmdl,
                      head_dim=cfg.dh)
    if "rglru" in st and rglru_mod.tp_mode(st["rglru"], cfg) == "partial":
        kw["rnn_width"] = (cfg.rnn_width or cfg.d_model) // pol.nmdl
    return cfg.replace(**kw) if kw else cfg


def local_cache(cache: dict, specs, mesh) -> dict:
    """This rank's block of a whole decode cache (:func:`init_cache`'s
    tree, ``encdec.init_cache``'s too) under ``specs``
    (``parallel.sharding.cache_pspecs``); ``"pos"`` as it is."""
    from repro_torch.parallel.sharding import shard_leaf, spec_at
    from repro_torch.tree import flatten, unflatten
    return unflatten(cache, {
        k: shard_leaf(v, spec_at(specs, k), mesh, mesh.coords)
        if torch.is_tensor(v) else v for k, v in flatten(cache).items()})


def init_cache(cfg, batch: int, max_len: int, kv_dtype=None,
               device=None, layout=None) -> dict:
    """Zeroed decode state for every stateful kind of ``layout`` (default
    the config's; one cache row per layout row with that mixer), plus
    ``"pos": 0``: ``"attn"`` {"k","v"} [n, batch, max_len, K, Dh] in
    ``kv_dtype`` (default the model dtype; ``torch.int8`` adds per-(token,
    head) scales), ``"local_attn"`` the same with ``min(attn_window,
    max_len)`` ring slots, ``"rglru"`` / ``"ssd"`` their f32 state and
    conv buffers."""
    check_supported(cfg)
    n: Dict[str, int] = {}
    for s in default_layout(cfg) if layout is None else layout:
        n[s.mixer] = n.get(s.mixer, 0) + 1
    cache: dict = {"pos": 0}
    if n.get("attn"):
        cache["attn"] = attention.init_kv_cache(cfg, batch, max_len,
                                                n["attn"], kv_dtype, device)
    if n.get("local_attn"):
        cache["local_attn"] = attention.init_kv_cache(
            cfg, batch, min(cfg.attn_window, max_len), n["local_attn"],
            kv_dtype, device)
    if n.get("rglru"):
        cache["rglru"] = rglru_mod.init_rglru_cache(cfg, batch, n["rglru"],
                                                    device)
    if n.get("ssd"):
        cache["ssd"] = ssm_mod.init_ssd_cache(cfg, batch, n["ssd"], device)
    return cache


def _store_window(entry: dict, ci: int, k, v) -> None:
    """Write a prompt's K/V into layer ``ci`` of a ring buffer of ``w``
    slots: the last ``w`` positions, rolled by ``(S - w) % w`` so that
    position p sits in slot ``p % w``; a prompt shorter than the ring fills
    its first S slots (the rest stay zero)."""
    S, w = k.shape[1], entry["k"].shape[2]
    if S >= w:
        roll = (S - w) % w
        k = torch.roll(k[:, S - w:], roll, dims=1)
        v = torch.roll(v[:, S - w:], roll, dims=1)
    for key, val in attention.store_kv(entry, k, v).items():
        entry[key][ci, :, :val.shape[1]] = val


def prefill(params, cfg, tokens, max_len: int, *, gates=None,
            extra_embeds=None, kv_dtype=None,
            layout=None) -> Tuple[torch.Tensor, dict]:
    """Process the prompt; return (last-position logits [B,Vp], cache) with
    cache :func:`init_cache` ``(B, max_len, kv_dtype)`` holding the
    prompt's K/V in positions [0, S) (S counts an ``extra_embeds`` prefix
    of P patch embeddings before the tokens; encoded by ``store_kv``; a local
    attention ring holds the last ``w``), every recurrent layer's final
    state and its last K-1 pre-conv inputs (zero-padded on the left for a
    prompt shorter than K-1), and ``"pos"`` = S. Each recurrent state comes
    from the same scan call that computes the layer's output."""
    check_supported(cfg)
    layout = default_layout(cfg) if layout is None else layout
    gates = gates or _ones_gates(len(layout), tokens.device)
    B, S = tokens.shape[0], _seq_len(tokens, extra_embeds)
    sp = act.seq_sharded(S)
    h = _embed(params, cfg, tokens, extra_embeds, sp)
    positions = torch.arange(S, device=h.device)[None, :]
    cache = init_cache(local_cfg(params, cfg), B, max_len,
                       kv_dtype or h.dtype, h.device, layout)
    cidx = _cache_indices(layout)
    for i, slot in enumerate(layout):
        if slot.mixer is None:
            h = _block(params, cfg, slot, i, h, gates, None, sp=sp)
            continue
        pm = _mixer_params(params, slot)
        ci = cidx[i]
        with tp.seq_split(sp):
            h = _prefill_mixer(params, cfg, slot, pm, ci, h, positions,
                               cache, gates, i, S, sp)
    if sp:
        h = tp.gather_seq(h, partial=False)
    cache["pos"] = S
    logits = _unembed(params, cfg, h[:, -1:, :])[:, 0]
    return logits, cache


def _prefill_mixer(params, cfg, slot, pm, ci, h, positions, cache, gates,
                   i: int, S: int, sp: bool):
    """Layout row ``i`` of :func:`prefill`: its mixer over the prompt,
    the state it leaves in ``cache`` (layer ``ci`` of its kind), then the
    row's residual updates."""
    hn = _norm(cfg, pm["norm"], h)
    if slot.mixer == "rglru":
        out, hs, conv = rglru_mod.rglru_sequence(pm, cfg, hn)
        cache["rglru"]["h"][ci] = hs
        cache["rglru"]["conv"][ci] = conv
    elif slot.mixer == "ssd":
        out, state, conv = ssm_mod.ssd_sequence(pm, cfg, hn)
        cache["ssd"]["state"][ci] = state
        cache["ssd"]["conv"][ci] = conv
    else:
        out, kv = attention.attention(pm, cfg, hn, positions,
                                      window=_window(cfg, slot))
        entry = cache[slot.mixer]
        if slot.mixer == "local_attn":
            _store_window(entry, ci, kv["k"], kv["v"])
        else:
            for key, val in attention.store_kv(entry, kv["k"],
                                               kv["v"]).items():
                entry[key][ci, :, :S] = val
    return _block(params, cfg, slot, i, h, gates, out, sp=sp)


# ------------------------------------------------------------ chunked prefill
def prefill_chunk(params, cfg, cache: dict, tokens, start: int, *,
                  gates=None, layout=None) -> torch.Tensor:
    """One prompt chunk against a partly filled slot cache.

    cache: {"attn": {"k","v"} [L, B, S_max, K, Dh]} (an int8 cache adds
    {"ks","vs"}), written in place at [start, start + C); tokens: [B, C] at
    absolute offset ``start``.
    Running a prompt chunk by chunk and reading the last chunk's logits
    gives :func:`prefill`'s logits. Returns last-position logits [B, Vp]
    and sets ``cache["pos"]``. Uniform all-attention ``layout`` s only."""
    require_attn_layout(cfg, "chunked prefill", layout)
    layout = default_layout(cfg) if layout is None else layout
    gates = gates or _ones_gates(len(layout), tokens.device)
    h = _embed(params, cfg, tokens)
    for i, slot in enumerate(layout):
        pm = _mixer_params(params, slot)
        out = attention.chunk_attention(
            pm, cfg, layers.apply_norm(cfg, pm["norm"], h),
            _pool_layer(cache["attn"], i), start)
        h = _block(params, cfg, slot, i, h, gates, out)
    cache["pos"] = start + tokens.shape[1]
    return _unembed(params, cfg, h[:, -1:, :])[:, 0]


def paged_prefill_chunk(params, cfg, pools: dict, page_table, tokens,
                        start: int, *, scratch_page: int,
                        gates=None, layout=None) -> torch.Tensor:
    """Paged sibling of :func:`prefill_chunk`: one prompt chunk written
    straight into granted pages.

    pools: {"k","v"} [L, n_pages, page_tokens, K, Dh] (quantized pools add
    {"ks","vs"} [L, n_pages, K]), updated in place; page_table: int32
    [B, max_pages]; tokens: [B, C] at absolute offset ``start``. A layout
    of L' rows writes pool layers [0, L'). Returns last-position logits
    [B, Vp]."""
    require_attn_layout(cfg, "paged prefill", layout)
    layout = default_layout(cfg) if layout is None else layout
    gates = gates or _ones_gates(len(layout), tokens.device)
    h = _embed(params, cfg, tokens)
    for i, slot in enumerate(layout):
        pm = _mixer_params(params, slot)
        out = attention.paged_chunk_attention(
            pm, cfg, layers.apply_norm(cfg, pm["norm"], h),
            _pool_layer(pools, i), page_table, start,
            scratch_page=scratch_page)
        h = _block(params, cfg, slot, i, h, gates, out)
    return _unembed(params, cfg, h[:, -1:, :])[:, 0]


def _pool_layer(pools: dict, i: int) -> dict:
    """Layer ``i``'s views of every pool leaf (pages and, for a quantized
    pool, the per-page scales)."""
    return {name: leaf[i] for name, leaf in pools.items()}


# --------------------------------------------------------------------- decode
def decode_step(params, cfg, cache: dict, tokens, *, gates=None,
                split_rows: int = 0, layout=None,
                gather: bool = True) -> Tuple[torch.Tensor, dict]:
    """One autoregressive step against a slot cache (updated in place).

    ``cache["pos"]`` is a scalar (the one-shot path: the whole batch at one
    position) or an int32 [B] tensor (continuous batching: each slot at its
    own offset); gates may be [L] or [L, B]. tokens: [B, 1]. Attention
    layers write their token into the cache (a local attention layer into
    its ring buffer) and run the dense decode kernel; recurrent layers
    advance their state and conv buffer. ``split_rows`` (0: B) is the row
    count the decode kernel's split-KV cut is chosen for. Returns (logits
    [B, 1, Vp], cache) with ``cache["pos"]`` advanced by one; under a model
    axis, ``gather=False`` leaves the logits cut on vocab
    (:func:`vocab_logits`). Under a policy with ``cache_specs`` the cache is
    this rank's block in the ``cache_pspecs`` layout (:func:`local_cache`)
    and each kind steps on it (``tp.cache_cut``)."""
    check_supported(cfg)
    layout = default_layout(cfg) if layout is None else layout
    gates = gates or _ones_gates(len(layout), tokens.device)
    pos = cache["pos"]
    h = _embed(params, cfg, tokens)
    cidx = _cache_indices(layout)
    for i, slot in enumerate(layout):
        if slot.mixer is None:
            h = _block(params, cfg, slot, i, h, gates, None)
            continue
        pm = _mixer_params(params, slot)
        hn = layers.apply_norm(cfg, pm["norm"], h)
        ci = cidx[i]
        if slot.mixer in ("rglru", "ssd"):
            out = _recurrent_step(pm, cfg, hn, cache[slot.mixer], ci,
                                  slot.mixer)
        else:
            out = attention.decode_attention(
                pm, cfg, hn, _pool_layer(cache[slot.mixer], ci), pos,
                window=_window(cfg, slot), split_rows=split_rows,
                cut=tp.cache_cut(slot.mixer, "k"))
        h = _block(params, cfg, slot, i, h, gates, out)
    cache["pos"] = pos + 1
    return _unembed(params, cfg, h, gather=gather), cache


_STATE = {"rglru": ("h", rglru_mod.rglru_decode_step),
          "ssd": ("state", ssm_mod.ssd_decode_step)}


def _recurrent_step(pm, cfg, hn, st: dict, ci: int, kind: str):
    """One token of a recurrent layer ``ci`` of ``kind``, its state
    ``st`` updated in place; its output. A conv buffer that the cache
    specs cut along its taps is gathered for the step and cut again."""
    key, step = _STATE[kind]
    conv_cut = tp.cache_cut(kind, "conv")
    conv = st["conv"][ci]
    if conv_cut is not None:
        conv = conv_cut.whole(conv, 1)
    out, st[key][ci], conv = step(pm, cfg, hn, st[key][ci], conv,
                                  cut=tp.cache_cut(kind, key))
    if conv_cut is not None:
        conv = conv[:, conv_cut.rows(conv.shape[1])]
    st["conv"][ci] = conv
    return out


def decode_horizon(params, cfg, cache: dict, tokens, horizon: int, *,
                   gates=None, split_rows: int = 0, layout=None
                   ) -> Tuple[torch.Tensor, dict]:
    """``horizon`` greedy :func:`decode_step` s with the argmax token fed
    back on the device (the loop form of JAX's ``lax.scan``): nothing is
    read back to the host inside the loop. tokens: int32 [B, 1] seed.
    Returns (toks int32 [B, horizon], cache)."""
    horizon = int(horizon)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    tok = tokens
    toks = []
    for _ in range(horizon):
        logits, cache = decode_step(params, cfg, cache, tok, gates=gates,
                                    split_rows=split_rows, layout=layout,
                                    gather=False)
        nxt = greedy(cfg, logits[:, -1])
        toks.append(nxt)
        tok = nxt[:, None]
    return torch.stack(toks, dim=1), cache


def paged_decode_step(params, cfg, pools: dict, page_table, pos, tokens, *,
                      gates=None, split_rows: int = 0,
                      layout=None) -> torch.Tensor:
    """One autoregressive step against a paged KV pool.

    pools: {"k","v"} page arrays [L, n_pages, page_tokens, K, Dh] —
    quantized pools add {"ks","vs"} scales [L, n_pages, K] — updated in
    place (one new token per row); page_table: int32 [B, max_pages]; pos:
    int32 [B] per-row write positions; tokens: [B, 1]. Gates may be [L] or
    [L, B]. ``split_rows`` as in :func:`decode_step`. A uniform
    all-attention ``layout`` of L' rows reads and writes pool layers
    [0, L'). Returns logits [B, 1, Vp].
    """
    require_attn_layout(cfg, "paged decode", layout)
    layout = default_layout(cfg) if layout is None else layout
    gates = gates or _ones_gates(len(layout), tokens.device)
    h = _embed(params, cfg, tokens)
    for i, slot in enumerate(layout):
        pm = _mixer_params(params, slot)
        out = attention.paged_decode_attention(
            pm, cfg, layers.apply_norm(cfg, pm["norm"], h),
            _pool_layer(pools, i), page_table, pos, split_rows=split_rows)
        h = _block(params, cfg, slot, i, h, gates, out)
    return _unembed(params, cfg, h)


def paged_decode_horizon(params, cfg, pools: dict, page_table, pos, tokens,
                         horizon: int, *, gates=None, split_rows: int = 0,
                         layout=None):
    """``horizon`` greedy paged decode steps with the argmax token fed back
    on the device (the loop form of JAX's ``lax.scan``): nothing is read
    back to the host inside the loop. The page table is constant across
    the horizon — callers pre-grant every page it can touch. Returns
    (toks int32 [B, horizon], pools, pos + horizon)."""
    horizon = int(horizon)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    tok = tokens
    toks = []
    for _ in range(horizon):
        logits = paged_decode_step(params, cfg, pools, page_table, pos, tok,
                                   gates=gates, split_rows=split_rows,
                                   layout=layout)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        toks.append(nxt)
        tok = nxt[:, None]
        pos = pos + 1
    return torch.stack(toks, dim=1), pools, pos
