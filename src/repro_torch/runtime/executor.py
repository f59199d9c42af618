"""Model executors — the execution seam of the serving engine.

The engine decides *who* runs (scheduler) and *what shape* they run in
(pruning policy); a :class:`ModelExecutor` owns *how* the chosen masks
execute. Two backends, each in masked or structural mode:

  * :class:`LocalExecutor` — slot-batched caches. A :class:`SlotGroup`
    holds the decoder's cache (``decoder.init_cache``) with ``n_slots``
    rows: per kind of the layout, one dense ``[n, n_slots, cache_len, K,
    Dh]`` attention cache per K/V leaf (model dtype, float8_e4m3fn, or
    int8 with per-(token, head) scales), a local attention ring buffer, or
    f32 recurrent / SSM state; every leaf has the slot axis at 1. Groups
    are keyed by cache length, so ``len_buckets="pow2"`` mints one group
    per power-of-two length. Decode steps the occupied slots in the smallest
    batch bucket of ``decode_buckets`` that holds them (gathered from and
    scattered back into the resident cache on the device), through the
    dense decode kernel. It serves every ported layout: uniform attention
    (llama2), SSD (mamba2) and the Griffin pattern (recurrentgemma).
  * :class:`PagedExecutor` — physically paged KV execution, uniform
    all-attention layouts only. Requests own *pages* of a global KV pool
    (``repro_torch.runtime.kv_pool.KVPool`` holds the page tensors on the
    device), prefill writes KV straight into granted pages, and one decode
    horizon advances any mix of cache lengths
    through a per-request page table and the paged decode kernel.
  * :class:`ShardedExecutor` — the local executor's masked groups on a mesh
    of ranks (``launch.mesh.Mesh``, explicit SPMD: every rank runs the same
    engine): each data rank holds its share of the slots, each model rank
    its heads / features of the weights and the cache
    (:class:`ShardedSlotGroup`).

Decode state is device-resident: a group keeps its cache (or page-table
rows), positions, seed tokens and ``[2, L, n_slots]`` gates (L: the
group's layout rows) as device tensors, updated in place at placement,
eviction and page grants. A horizon
of H greedy tokens is a loop of H decode steps launched back to back on the
current CUDA stream with the argmax token fed back on the device; the host
reads the ``[B, H]`` tokens once, in ``decode_finish`` (the counterpart of
JAX's async dispatch: the launch returns at once and the host schedules
while the card works).

Pools are model-dtype or quantized (int8 / float8_e4m3fn pages with
per-(page, kv head) scales; every write seam quantizes: monolithic prefill,
chunked prefill and the decode append). Prompts prefill monolithically or
in pow2 chunks, one chunk per engine tick (:meth:`PagedExecutor.prefill_begin`
/ :meth:`PagedExecutor.prefill_step`).

A preempted request leaves its group through ``spill_state`` (its
non-pool decode state copied to the host: every slot-cache leaf on the
local path, position and seed tokens on the paged one, whose pages the
pool spills) and comes back through ``restore_state`` into free slots of
an equivalent group, by the same placement a prefill uses.

Masked mode runs every request on all L layers with its mask as per-slot
0/1 gates. Structural mode runs a group per *bucket*: the request's mask
is snapped onto a ladder (``bucket_quant``, ``masks.quantize_mask``) and
the group is keyed by the exact retained rows (``masks.gather_key``) —
never by the bucket signature alone, which would serve a mask with
another mask's layers (DESIGN.md §9). A bucket of L' rows holds L' cache
layers (slot path) or reads and writes pool layers [0, L') of its
request's pages (paged path; the pool stays full depth), and its layout
(``masks.retained_layout``) indexes the retained rows of the *full* param
stacks: the decoder slices each row out of its stack anyway, so a
compacted copy of the weights (JAX's ``compact_params``) would buy
nothing. The request's exact mask rides per-slot gates over the bucket's
rows (``gate_rows``; all ones on an exact bucket's present blocks),
which gives the bits of the exact structural drop in a quantized bucket
too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import masks as masks_lib
from repro_torch.kernels.ref import put_pages
from repro_torch.models import attention, decoder
from repro_torch.kernels.ref import put_slots, take_slots
from repro_torch.runtime.kv_pool import resolve_kv_dtype

__all__ = ["ModelExecutor", "SlotGroup", "LocalExecutor", "PagedExecutor",
           "PagedGroup", "ShardedSlotGroup", "ShardedExecutor",
           "chunk_widths"]


def chunk_widths(n_tokens: int, max_chunk: int) -> List[int]:
    """Split a prompt into power-of-two chunk widths (largest first): 13
    tokens under an 8-token cap chunk as [8, 4, 1]."""
    n = int(n_tokens)
    cap = int(max_chunk)
    if n < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens!r}")
    if cap < 1:
        raise ValueError(f"max_chunk must be >= 1, got {max_chunk!r}")
    cap = 1 << (cap.bit_length() - 1)          # pow2 floor of the cap
    widths: List[int] = []
    while n > 0:
        c = min(cap, 1 << (n.bit_length() - 1))
        widths.append(c)
        n -= c
    return widths


@dataclasses.dataclass
class _PrefillTask:
    """One in-flight chunked prefill (``prefill_begin``/``prefill_step``).
    The request's slots are *reserved* in its group for the task's lifetime
    (they pad no decode bucket and admit no other request) and seated when
    the final chunk completes. ``state`` is the backend's partial cache
    (Local: the request-sized slot cache the chunks accumulate into; Paged:
    None, chunks write straight into the pool)."""
    group: Any
    slots: List[int]
    rid: str
    prompt: np.ndarray                # int32 [b, S]
    cols: np.ndarray                  # [2, L] gate columns
    widths: List[int]                 # pow2 chunk widths, sum == S
    pos: int = 0                      # prompt tokens processed so far
    step: int = 0                     # chunks processed so far
    state: Any = None

    @property
    def done(self) -> bool:
        return self.pos >= self.prompt.shape[1]


@dataclasses.dataclass
class _InFlightHorizon:
    """A launched-but-unread decode horizon. Occupancy is captured at
    launch, so host work overlapped with the device loop (admission may
    seat new requests into slots that were free padding at launch) cannot
    corrupt the finish-side bookkeeping."""
    group: Any
    horizon: int
    toks_dev: Any                     # device [width, horizon] tokens
    idx: Optional[List[int]]          # stepped slots (Local: None = all)
    occupants: List[Optional[str]]    # per stepped slot, at launch time


def _gate_cols(mask, gate_rows: Optional[np.ndarray]) -> np.ndarray:
    """A request's gate columns [2, Lg]: the keep-mask split into
    mixer/ffn rows (restricted to ``gate_rows`` for compacted buckets)."""
    m = np.asarray(mask, np.float32)
    L = m.shape[0] // 2
    gm, gf = m[:L], m[L:]
    if gate_rows is not None:
        gm, gf = gm[gate_rows], gf[gate_rows]
    return np.stack([gm, gf])


def _structural_group(cfg, mask, bucket_quant: str) -> Tuple[Tuple, dict]:
    """The structural group hosting ``mask``: (its gather key, the group's
    fields — bucket signature, minting mask, layout over the full stacks
    and the original row behind each layout row). ``mask`` (not the
    quantized bucket mask) is what bucket affinity reuses: a rounded-up
    mask would make affinity adopt a less-pruned decision."""
    qmask = masks_lib.quantize_mask(cfg, mask, bucket_quant)
    return masks_lib.gather_key(cfg, qmask), dict(
        key=masks_lib.bucket_key(cfg, qmask), mask=np.array(mask, copy=True),
        layout=masks_lib.retained_layout(cfg, qmask),
        gate_rows=masks_lib.keep_rows(cfg, qmask))


def _gate_tensors(cols: np.ndarray, device) -> dict:
    """Gate columns [2, L] as the decoder's {"mixer", "ffn"} gate dict."""
    return {"mixer": torch.from_numpy(cols[0]).to(device),
            "ffn": torch.from_numpy(cols[1]).to(device)}


def _bucket_batch(occ: List[int], free: List[int], n_slots: int,
                  buckets: Sequence[int]) -> Optional[List[int]]:
    """Slot indices to step this iteration: the occupied slots padded with
    free ones up to the smallest bucket that holds them, or None for the
    full-width path. Padding uses *distinct free* slots so a scatter-back
    never writes one index twice."""
    n = len(occ)
    for b in sorted(set(buckets)):
        if n <= b < n_slots:
            return occ + free[: b - n]
    return None


_IIDX_CACHE_CAP = 256     # occupancy patterns a group keeps index tensors for


def _state_leaves(cache: dict) -> dict:
    """The cache's state kinds ({kind: {leaf: tensor}}, without ``"pos"``);
    every leaf has the slot axis at 1."""
    return {kind: leaves for kind, leaves in cache.items() if kind != "pos"}


def _cached_iidx(cache: Dict[Tuple[int, ...], torch.Tensor], idx: List[int],
                 device) -> torch.Tensor:
    """Device copy of a slot-index vector, cached by its pattern, so a
    steady-state horizon launch uploads nothing. FIFO past the cap: a long
    adaptive serve cycles through unboundedly many patterns."""
    key = tuple(idx)
    dev = cache.get(key)
    if dev is None:
        if len(cache) >= _IIDX_CACHE_CAP:
            cache.pop(next(iter(cache)))
        dev = cache[key] = torch.tensor(idx, dtype=torch.long, device=device)
    return dev


# ---------------------------------------------------------------- protocol
class ModelExecutor:
    """Execution backend protocol for the engine.

    ``group_for`` resolves a keep-mask to the group that will host the
    request; ``prefill_into`` seats a prefilled request; ``decode_launch``
    / ``decode_finish`` advance one group H tokens with one read-back
    (``decode_horizon`` / ``decode`` are the one-call forms, JAX's).
    ``launch_s`` accumulates wall time spent launching device work and
    reading it back. ``paged`` marks backends whose KV lives in a
    :class:`KVPool`'s page tensors (the engine then admits through the
    token-granular pool API and calls ``bind_pool`` per run)."""

    launch_s: float = 0.0
    paged: bool = False

    def group_for(self, mask: np.ndarray, cache_len: Optional[int] = None):
        raise NotImplementedError

    def prefill_into(self, group, slots: List[int], rid: str,
                     prompt: np.ndarray, mask: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def decode_launch(self, group, horizon: int) -> _InFlightHorizon:
        """Launch one H-token decode for ``group`` without waiting for it."""
        raise NotImplementedError

    def decode_finish(self, launch: _InFlightHorizon) -> np.ndarray:
        """Read ``launch``'s tokens back (the tick's one sync) as
        [n_slots, horizon] tokens."""
        raise NotImplementedError

    def decode_horizon(self, group, horizon: int) -> Tuple[np.ndarray, bool]:
        """Advance every occupied slot of ``group`` by ``horizon`` tokens:
        ``decode_finish(decode_launch(group, horizon))`` with no host work
        between, as JAX's pair ([n_slots, horizon] tokens, new-compile
        flag). The port compiles no per-bucket executable: the flag is
        always False."""
        return self.decode_finish(self.decode_launch(group, horizon)), False

    def decode(self, group) -> Tuple[np.ndarray, bool]:
        """One token: ``decode_horizon(group, 1)`` as ([n_slots] tokens,
        False)."""
        toks, new = self.decode_horizon(group, 1)
        return toks[:, 0], new

    def groups(self) -> list:
        raise NotImplementedError

    def evict_all(self) -> None:
        for g in self.groups():
            g.evict(list(range(g.n_slots)))

    def spill_state(self, group, slots: List[int]) -> dict:
        """A preempted request's decode state outside the KV pool, copied
        to the host (the engine then evicts its slots)."""
        raise NotImplementedError

    def restore_state(self, group, slots: List[int], rid: str, state: dict,
                      mask, rows=None) -> None:
        """Reseat a :meth:`spill_state` snapshot in free ``slots`` of
        ``group`` (``rows``: the re-granted page ids of a paged request)."""
        raise NotImplementedError

    def kv_utilization(self) -> Tuple[float, float]:
        """(used_bytes, physical_bytes) of live KV storage."""
        return 0.0, 0.0

    def stats(self) -> Dict[str, int]:
        return {}


# ------------------------------------------------------------------- local
class SlotGroup:
    """One slot-batched decode family sharing a dense cache, minted per
    cache length: in masked mode all L layers with per-slot gates
    (``key`` "masked"); in structural mode one bucket's ``layout`` (its
    bucket signature is ``key``, the mask that minted it ``mask``), gated
    over its ``gate_rows``.

    All decode state — the cache (every leaf of every kind with the slot
    axis at 1, e.g. ``cache["attn"]["k"] [L_attn, n_slots, cache_len, K,
    Dh]`` or ``cache["ssd"]["state"] [L_ssd, n_slots, H, P, N]``;
    ``cache["pos"]`` int32 ``[n_slots]``), the per-slot seed tokens
    ``[n_slots, 1]`` and the ``[2, L, n_slots]`` gates — lives on the
    device. Placement writes only
    the placed slots' rows and gate columns; a horizon reads the resident
    tensors directly, so the per-token path uploads nothing. ``pos`` is a
    host mirror of the positions for the engine's bookkeeping."""

    def __init__(self, params, cfg_model, n_slots: int, cache_len: int,
                 kv_dtype, device, *, key="masked", layout=None, mask=None,
                 gate_rows=None):
        self.params = params
        self.key = key
        self.layout = layout            # None: the config's L layers
        self.mask = mask
        self.gate_rows = gate_rows
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.device = device
        self.occupants: List[Optional[str]] = [None] * n_slots
        # slots held by an in-flight chunked prefill
        self.reserved: set = set()
        self.cache = decoder.init_cache(cfg_model, n_slots, cache_len,
                                        kv_dtype, device, layout)
        self.cache["pos"] = torch.zeros(n_slots, dtype=torch.int32,
                                        device=device)
        self.tokens = torch.zeros(n_slots, 1, dtype=torch.int32,
                                  device=device)
        # one gate row per layout row
        self.gates_dev = torch.ones(
            2, cfg_model.n_layers if layout is None else len(layout), n_slots,
            device=device)
        self.pos = np.zeros(n_slots, np.int64)
        self._mcfg = cfg_model
        self._iidx_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    def free_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupants)
                if o is None and i not in self.reserved]

    def occupied_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupants) if o is not None]

    def occupied(self) -> bool:
        return any(o is not None for o in self.occupants)

    def iidx(self, idx: List[int]) -> torch.Tensor:
        return _cached_iidx(self._iidx_cache, idx, self.device)

    def place(self, rid: str, slots: List[int], req_cache: dict,
              cols: np.ndarray, prompt_len: int,
              first_dev: torch.Tensor) -> None:
        """Seat a prefilled request: its cache rows ``req_cache`` (a
        request-sized ``decoder.init_cache``: every leaf with
        ``len(slots)`` rows at axis 1), positions, seed tokens and gate
        columns ``cols [2, L]``, written in place at ``slots``."""
        self.reserved.difference_update(slots)
        for s in slots:
            self.occupants[s] = rid
            self.pos[s] = prompt_len
        sidx = self.iidx(slots)
        for kind, leaves in _state_leaves(self.cache).items():
            for key, leaf in leaves.items():
                put_slots(leaf, sidx, req_cache[kind][key])
        self.cache["pos"][sidx] = int(prompt_len)
        self.tokens[sidx, 0] = first_dev
        self.gates_dev[:, :, sidx] = torch.from_numpy(cols).to(
            self.device)[:, :, None]

    def evict(self, slots: List[int]) -> None:
        self.reserved.difference_update(slots)
        for s in slots:
            self.occupants[s] = None

    def launch_horizon(self, horizon: int, buckets: Sequence[int] = ()
                       ) -> Tuple[torch.Tensor, Optional[List[int]]]:
        """Enqueue ``horizon`` greedy decode steps for the occupied slots
        with no host read: the full width in place, or (when a batch
        bucket of ``buckets`` holds the occupied slots) a gather of the
        bucket's rows, H steps on them and a scatter back, all on the
        device. Returns (device toks [width, H], stepped slots or None for
        the full width)."""
        idx = (_bucket_batch(self.occupied_slots(), self.free_slots(),
                             self.n_slots, buckets) if buckets else None)
        g = self.gates_dev
        if idx is None:
            toks, self.cache = decoder.decode_horizon(
                self.params, self._mcfg, self.cache, self.tokens, horizon,
                gates={"mixer": g[0], "ffn": g[1]}, split_rows=self.n_slots,
                layout=self.layout)
            self.tokens = toks[:, -1:].contiguous()
            return toks, None
        iidx = self.iidx(idx)
        sub = {kind: {k: take_slots(v, iidx) for k, v in leaves.items()}
               for kind, leaves in _state_leaves(self.cache).items()}
        sub["pos"] = self.cache["pos"][iidx]
        gs = g[:, :, iidx]
        toks, sub = decoder.decode_horizon(
            self.params, self._mcfg, sub, self.tokens[iidx], horizon,
            gates={"mixer": gs[0], "ffn": gs[1]}, split_rows=self.n_slots,
            layout=self.layout)
        for kind, leaves in _state_leaves(sub).items():
            for k, v in leaves.items():
                put_slots(self.cache[kind][k], iidx, v)
        self.cache["pos"][iidx] = sub["pos"]
        self.tokens[iidx] = toks[:, -1:]
        return toks, idx

    def decode_horizon(self, horizon: int, buckets: Sequence[int] = ()
                       ) -> Tuple[np.ndarray, bool]:
        """Advance every occupied slot ``horizon`` tokens and read them
        back: ([n_slots, horizon] tokens, rows of unstepped slots zero; the
        new-compile flag, always False: the port compiles no per-bucket
        executable). Moves the host positions of the occupied slots."""
        toks_dev, idx = self.launch_horizon(horizon, buckets)
        out = toks_dev.cpu().numpy()
        if idx is not None:
            out, stepped = np.zeros((self.n_slots, int(horizon)),
                                    np.int32), out
            out[idx] = stepped
        for s in self.occupied_slots():
            self.pos[s] += int(horizon)
        return out, False

    def decode_once(self, buckets: Sequence[int] = ()
                    ) -> Tuple[np.ndarray, bool]:
        """One token: ``decode_horizon(1, buckets)`` as ([n_slots] tokens,
        False)."""
        toks, new = self.decode_horizon(1, buckets)
        return toks[:, 0], new


class LocalExecutor(ModelExecutor):
    """Slot-batched execution: one :class:`SlotGroup` per cache length
    (masked mode) or per (gather key, cache length) (structural mode),
    each with ``max_active`` slots.

    ``kv_dtype`` takes the canonical precision names (``fp32``/``bf16``/
    ``int8``/``fp8``) or a torch dtype: an int8 slot cache stores
    per-(token, kv head) scales (``attention.kv_quant``) and is
    dequantized to the model dtype before the decode kernel, as in JAX; an
    fp8 (float8_e4m3fn) slot cache is a plain cast on store and on load,
    as in JAX (no scale, no clipping). On a recurrent layout the precision
    applies to the local-attention ring alone (RG-LRU and SSD state stay
    f32, as in JAX), so on mamba2, which has no attention cache, it
    changes nothing. Decode steps the occupied
    slots in the smallest bucket of ``decode_buckets`` that holds them.
    ``groups_minted`` counts the groups (dense caches) created.

    Structural mode quantizes each mask by ``bucket_quant`` (none | layer
    | pow2) before keying its group; ``max_groups`` > 0 caps the
    structural groups, evicting idle ones (neither occupied nor reserved)
    least recently used first when a new one is minted — busy groups are
    never evicted, so the count may overshoot while all are busy."""

    def __init__(self, model, params, *, mode: str = "masked",
                 max_active: int = 8, kv_dtype=None,
                 decode_buckets: Sequence[int] = (1, 2, 4, 8),
                 bucket_quant: str = "none", max_groups: int = 0):
        if mode not in ("masked", "structural"):
            raise ValueError(f"unknown mode {mode!r}")
        if bucket_quant not in ("none", "layer", "pow2"):
            raise ValueError(f"unknown bucket_quant {bucket_quant!r}; "
                             f"expected none|layer|pow2")
        decoder.check_supported(model.cfg)
        _, store, _, _ = resolve_kv_dtype(kv_dtype)
        self.mcfg = model.cfg
        self.params = params
        self.device = params["embed"].device if params is not None else None
        self.mode = mode
        self.bucket_quant = bucket_quant
        self.max_groups = int(max_groups)
        self.max_active = int(max_active)
        self.kv_dtype = store if store is not None else model.cfg.torch_dtype()
        self.decode_buckets = tuple(int(b) for b in decode_buckets or ())
        self.launch_s = 0.0
        self.groups_minted = 0
        # ("masked" | gather key, cache length) -> group, least recently
        # used first
        self._groups: Dict[Tuple, SlotGroup] = {}

    # ------------------------------------------------------------ capacity
    def _invalidate(self) -> None:
        """The one invalidation path: every group (and its cache) drops."""
        self._groups.clear()

    def set_max_active(self, n_slots: int) -> None:
        """A new slot count changes every cache's slot axis: every group
        drops."""
        if int(n_slots) == self.max_active:
            return
        self.max_active = int(n_slots)
        self._invalidate()

    def drop_groups(self) -> None:
        self._invalidate()

    # -------------------------------------------------------------- groups
    def groups(self) -> List[SlotGroup]:
        return list(self._groups.values())

    def _evict_idle(self) -> None:
        """Make room under ``max_groups`` before a structural group is
        minted: drop idle structural groups, least recently used first."""
        if self.max_groups <= 0:
            return
        n = sum(1 for k in self._groups if k[0] != "masked")
        while n >= self.max_groups:
            idle = [k for k, g in self._groups.items()
                    if k[0] != "masked" and not g.occupied()
                    and not g.reserved]
            if not idle:
                break
            del self._groups[idle[0]]
            n -= 1

    def group_for(self, mask: np.ndarray,
                  cache_len: Optional[int] = None) -> SlotGroup:
        """The group of ``cache_len`` tokens hosting ``mask``, minted on
        first use: the masked group (masks ride per-slot gates), or the
        structural group of the mask's bucket."""
        if self.mode == "masked":
            gkey = ("masked", int(cache_len))
            group = self._groups.get(gkey)
            if group is None:
                group = self._groups[gkey] = SlotGroup(
                    self.params, self.mcfg, self.max_active,
                    int(cache_len), self.kv_dtype, self.device)
                self.groups_minted += 1
            return group
        rkey, kw = _structural_group(self.mcfg, mask, self.bucket_quant)
        gkey = (rkey, int(cache_len))
        group = self._groups.pop(gkey, None)
        if group is None:
            self._evict_idle()
            group = SlotGroup(self.params, self.mcfg, self.max_active,
                              int(cache_len), self.kv_dtype, self.device,
                              **kw)
            self.groups_minted += 1
        self._groups[gkey] = group      # (re)inserted last: LRU order
        return group

    # ------------------------------------------------------------- prefill
    def prefill_into(self, group: SlotGroup, slots: List[int], rid: str,
                     prompt: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Prefill the request into a request-sized cache, seat it in
        ``slots`` and return the first sampled tokens ``[b]``."""
        b, S = prompt.shape
        cols = _gate_cols(mask, group.gate_rows)
        t0 = time.perf_counter()
        logits, cache = decoder.prefill(
            self.params, self.mcfg, torch.from_numpy(
                np.asarray(prompt, np.int32)).to(self.device),
            group.cache_len, gates=_gate_tensors(cols, self.device),
            kv_dtype=self.kv_dtype, layout=group.layout)
        first_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        first = first_dev.cpu().numpy()
        self.launch_s += time.perf_counter() - t0
        group.place(rid, slots, _state_leaves(cache), cols, S, first_dev)
        return first

    # ----------------------------------------------------- chunked prefill
    def supports_chunked_prefill(self, group: SlotGroup) -> bool:
        """Chunked prefill resumes a positional KV write frontier: only
        uniform all-attention layouts have one (recurrent state cannot be
        re-entered mid-prompt), so other layouts — a half-pruned bucket's
        among them — prefill monolithically."""
        return decoder.is_attn_layout(self.mcfg, group.layout)

    def prefill_begin(self, group: SlotGroup, slots: List[int], rid: str,
                      prompt: np.ndarray, mask: np.ndarray, *,
                      max_chunk: int) -> _PrefillTask:
        """Reserve the slots and mint the request-sized cache the chunks
        accumulate into (placed into the group when the last chunk lands)."""
        prompt = np.asarray(prompt, np.int32)
        group.reserved.update(slots)
        return _PrefillTask(
            group=group, slots=list(slots), rid=rid, prompt=prompt,
            cols=_gate_cols(mask, group.gate_rows),
            widths=chunk_widths(prompt.shape[1], max_chunk),
            state=decoder.init_cache(self.mcfg, prompt.shape[0],
                                     group.cache_len, self.kv_dtype,
                                     self.device, group.layout))

    def prefill_step(self, task: _PrefillTask) -> Optional[np.ndarray]:
        """Run the task's next chunk; returns the first sampled tokens
        ``[b]`` once the last chunk is done (and seats the request), else
        None."""
        S = task.prompt.shape[1]
        c = task.widths[task.step]
        t0 = time.perf_counter()
        logits = decoder.prefill_chunk(
            self.params, self.mcfg, task.state,
            torch.from_numpy(task.prompt[:, task.pos:task.pos + c]).to(
                self.device), task.pos,
            gates=_gate_tensors(task.cols, self.device),
            layout=task.group.layout)
        task.pos += c
        task.step += 1
        if not task.done:
            self.launch_s += time.perf_counter() - t0
            return None
        first_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        first = first_dev.cpu().numpy()
        self.launch_s += time.perf_counter() - t0
        task.group.place(task.rid, task.slots, _state_leaves(task.state),
                         task.cols, S, first_dev)
        task.state = None
        return first

    # ---------------------------------------------------- preemption seam
    def spill_state(self, group: SlotGroup, slots: List[int]) -> dict:
        """The request's slot-cache rows — every leaf of every cache kind:
        attention K/V (and int8 scales), the local-attention ring, SSD and
        RG-LRU states, conv buffers — plus its position and seed tokens,
        copied to the host. The copies are blocking and exact, so reseating
        is bitwise."""
        iidx = group.iidx(list(slots))
        cache = {kind: {k: take_slots(v, iidx).cpu()
                        for k, v in leaves.items()}
                 for kind, leaves in _state_leaves(group.cache).items()}
        # one request's rows share one position (placed together, stepped
        # together)
        return {"cache": cache, "pos": int(group.cache["pos"][slots[0]]),
                "first": group.tokens[iidx, 0].cpu()}

    def restore_state(self, group: SlotGroup, slots: List[int], rid: str,
                      state: dict, mask, rows=None) -> None:
        """Reseat through the ordinary placement: the snapshot's rows have
        the shapes a monolithic prefill of the request produces."""
        dev = group.device
        cache = {kind: {k: v.to(dev) for k, v in leaves.items()}
                 for kind, leaves in state["cache"].items()}
        group.place(rid, list(slots), cache,
                    _gate_cols(mask, group.gate_rows), state["pos"],
                    state["first"].to(dev))

    # -------------------------------------------------------------- decode
    def decode_launch(self, group: SlotGroup,
                      horizon: int) -> _InFlightHorizon:
        """One horizon launch, no host read: the host is free to schedule
        and admit while the card decodes."""
        t0 = time.perf_counter()
        toks_dev, idx = group.launch_horizon(horizon, self.decode_buckets)
        self.launch_s += time.perf_counter() - t0
        stepped = range(group.n_slots) if idx is None else idx
        return _InFlightHorizon(group=group, horizon=int(horizon),
                                toks_dev=toks_dev, idx=idx,
                                occupants=[group.occupants[s]
                                           for s in stepped])

    def decode_finish(self, launch: _InFlightHorizon) -> np.ndarray:
        group, h = launch.group, launch.horizon
        t0 = time.perf_counter()
        nxt = launch.toks_dev.cpu().numpy()   # the single device→host read
        self.launch_s += time.perf_counter() - t0
        out = np.zeros((group.n_slots, h), np.int32)
        stepped = range(group.n_slots) if launch.idx is None else launch.idx
        for j, s in enumerate(stepped):
            # fold back only slots whose occupant is unchanged since launch
            if (launch.occupants[j] is not None
                    and group.occupants[s] == launch.occupants[j]):
                out[s] = nxt[j]
                group.pos[s] += h
        return out

    # ---------------------------------------------------------- utilization
    def kv_utilization(self) -> Tuple[float, float]:
        """Slot caches are dense: physical bytes exist for every minted
        group, and an occupied slot uses only its current position's tokens
        (a slot that over-advanced in its final horizon dropped the writes
        past ``cache_len``). Only global attention KV (the per-token state)
        counts: window rings and recurrent state are fixed-size, as in
        JAX."""
        used = phys = 0.0
        for g in self._groups.values():
            if "attn" not in g.cache:
                continue
            nbytes = sum(t.numel() * t.element_size()
                         for t in g.cache["attn"].values())
            phys += nbytes
            per_tok = nbytes / (g.n_slots * g.cache_len)
            used += sum(min(int(g.pos[s]), g.cache_len)
                        for s in g.occupied_slots()) * per_tok
        return used, phys

    def stats(self) -> Dict[str, int]:
        """Group counts: ``structural_buckets`` distinct gather keys,
        ``bucket_signatures`` distinct layouts (what ``bucket_quant``
        bounds), ``resident_param_stacks`` compacted copies of the weights
        held (none: every group runs on the full stacks)."""
        return {"groups": len(self._groups),
                "groups_minted": self.groups_minted,
                "structural_buckets": len({k for k, _ in self._groups
                                           if k != "masked"}),
                "bucket_signatures": len({g.key for g in self._groups.values()
                                          if g.key != "masked"}),
                "resident_param_stacks": 0}


# ------------------------------------------------------------------- paged
class PagedGroup:
    """One paged decode family: occupancy + page tables, no slot cache.
    Masked mode has one (``key`` "masked", all L layers); structural mode
    one per bucket, with its ``layout``, minting ``mask`` and
    ``gate_rows``.

    Owns the per-slot decode state around the pool's pages — int32
    page-table rows, write positions, next tokens and gates — as device
    tensors (``table_dev``/``pos_dev``/``tokens_dev``/``gates_dev``)
    updated in place, plus host mirrors (``table``/``pos``/``tokens``) for
    the engine's bookkeeping."""

    def __init__(self, cfg_model, n_slots: int, max_row_pages: int,
                 scratch_page: int, device, *, key="masked", layout=None,
                 mask=None, gate_rows=None):
        self.key = key
        self.layout = layout            # None: the config's L layers
        self.mask = mask
        self.gate_rows = gate_rows
        self.n_slots = n_slots
        self.max_row_pages = max_row_pages
        self.scratch_page = scratch_page
        self.device = device
        self.occupants: List[Optional[str]] = [None] * n_slots
        # slots held by an in-flight chunked prefill
        self.reserved: set = set()
        # padded decode rows write their garbage KV into the scratch page
        self.table = np.full((n_slots, max_row_pages), scratch_page, np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.tokens = np.zeros((n_slots,), np.int32)
        self.table_dev = torch.from_numpy(self.table.copy()).to(device)
        self.pos_dev = torch.zeros(n_slots, dtype=torch.int32, device=device)
        self.tokens_dev = torch.zeros(n_slots, dtype=torch.int32,
                                      device=device)
        self.gates_dev = torch.ones(
            2, cfg_model.n_layers if layout is None else len(layout), n_slots,
            device=device)
        self._iidx_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    def free_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupants)
                if o is None and i not in self.reserved]

    def occupied_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupants) if o is not None]

    def occupied(self) -> bool:
        return any(o is not None for o in self.occupants)

    def iidx(self, idx: List[int]) -> torch.Tensor:
        return _cached_iidx(self._iidx_cache, idx, self.device)

    def place(self, rid: str, slots: List[int], rows_np: np.ndarray,
              prompt_len: int, first_dev: torch.Tensor,
              first: np.ndarray, cols: np.ndarray) -> None:
        """Seat a prefilled request: host mirrors plus in-place writes of
        the placed rows of every device tensor."""
        npg = rows_np.shape[1]
        full_rows = np.full((len(slots), self.max_row_pages),
                            self.scratch_page, np.int32)
        full_rows[:, :npg] = rows_np
        self.reserved.difference_update(slots)
        for i, s in enumerate(slots):
            self.occupants[s] = rid
            self.table[s] = full_rows[i]
            self.pos[s] = prompt_len
            self.tokens[s] = first[i]
        sidx = self.iidx(slots)
        self.table_dev[sidx] = torch.from_numpy(full_rows).to(self.device)
        self.pos_dev[sidx] = int(prompt_len)
        self.tokens_dev[sidx] = first_dev
        self.gates_dev[:, :, sidx] = torch.from_numpy(cols).to(
            self.device)[:, :, None]

    def grant_pages(self, entries: List[Tuple[int, int, int]]) -> None:
        """Extend page-table rows with freshly granted pages:
        ``entries`` = (slot, column, page id)."""
        if not entries:
            return
        rows, cols, vals = (np.asarray(c, np.int64) for c in zip(*entries))
        self.table[rows, cols] = vals
        self.table_dev[torch.from_numpy(rows).to(self.device),
                       torch.from_numpy(cols).to(self.device)] = \
            torch.from_numpy(vals.astype(np.int32)).to(self.device)

    def evict(self, slots: List[int]) -> None:
        self.reserved.difference_update(slots)
        for s in slots:
            self.occupants[s] = None
            self.table[s] = self.scratch_page
            self.pos[s] = 0
            self.tokens[s] = 0
        if slots:
            sidx = self.iidx(slots)
            self.table_dev[sidx] = self.scratch_page
            self.pos_dev[sidx] = 0
            self.tokens_dev[sidx] = 0
            self.gates_dev[:, :, sidx] = 1.0


class PagedExecutor(ModelExecutor):
    """Physically paged KV execution, masked or structural.

    The engine's :class:`~repro_torch.runtime.kv_pool.KVPool` owns the
    page tensors (``bind_pool`` allocates them on this executor's device at
    pool capacity, once per run); this executor runs the model around them:

      * **prefill** runs the gated full-sequence pass and writes the
        prompt's K/V into the request's granted pages in place (JAX donates
        the pools through its jitted prefill; the port never copies the
        pool);
      * **decode** batches any mix of cache lengths through one paged
        horizon (``decoder.paged_decode_horizon``). Pages for the whole
        horizon are pre-granted in one bulk ``KVPool.extend`` before the
        launch (:meth:`pre_extend_horizon`), so the page table is constant
        across the loop.

    Dynamic decode-batch buckets: occupied slots are stepped in the
    smallest bucket of ``decode_buckets`` that holds them, padded with free
    slots whose page-table rows point at the pool's scratch page.

    ``kv_dtype`` takes the canonical precision names (``fp32``/``bf16``/
    ``int8``/``fp8``) or a torch dtype: quantized precisions store int8 /
    float8_e4m3fn pages plus per-(page, kv head) scales, quantize on every
    write seam, and decode through the fused-dequant kernel.

    Structural mode keys one group per gather key over the shared pool; a
    bucket of L' rows reads and writes pool layers [0, L') of its
    request's pages (pages are request-exclusive, so the upper layers are
    never read). The paged decoder serves uniform layouts only, so
    ``bucket_quant`` floors at "layer": every bucket is whole-layer, and
    a half-pruned layer runs as a 0 gate.
    """

    paged = True

    def __init__(self, model, params, *, mode: str = "masked",
                 max_active: int = 8, kv_dtype=None,
                 decode_buckets: Sequence[int] = (1, 2, 4, 8),
                 bucket_quant: str = "none"):
        if mode not in ("masked", "structural"):
            raise ValueError(f"unknown mode {mode!r}")
        if bucket_quant not in ("none", "layer", "pow2"):
            raise ValueError(f"unknown bucket_quant {bucket_quant!r}; "
                             f"expected none|layer|pow2")
        if mode == "structural" and bucket_quant == "none":
            bucket_quant = "layer"
        name, store, quantized, _ = resolve_kv_dtype(kv_dtype)
        decoder.require_attn_layout(model.cfg, "PagedExecutor")
        self.model = model
        self.mcfg = model.cfg
        self.params = params
        self.device = params["embed"].device
        self.mode = mode
        self.bucket_quant = bucket_quant
        self.max_active = int(max_active)
        self.kv_dtype_name = name            # canonical, None = model dtype
        self.kv_quantized = quantized
        self.kv_dtype = store if store is not None else model.cfg.torch_dtype()
        self.decode_buckets = tuple(int(b) for b in decode_buckets or ())
        self.launch_s = 0.0
        self.pool = None               # bound per engine run
        self.max_row_pages = 0
        self._groups: Dict[Any, PagedGroup] = {}

    # ------------------------------------------------------------- binding
    def page_phys_bytes(self, tokens_per_page: int) -> int:
        """Exact bytes of one physical page across all layers (K and V);
        a quantized page also carries its per-(layer, kv head) f32 scale
        rows, so admission and the pool ledger see true bytes."""
        cfg = self.mcfg
        itemsize = torch.empty((), dtype=self.kv_dtype).element_size()
        n = (2 * cfg.n_layers * int(tokens_per_page) * cfg.n_kv_heads
             * cfg.dh * itemsize)
        if self.kv_quantized:
            n += 2 * cfg.n_layers * cfg.n_kv_heads * 4    # K + V scale rows
        return n

    def bind_pool(self, pool, max_len: int) -> None:
        """Attach this run's KVPool: allocate its page tensors on the
        device and size the page-table width for ``max_len``-token
        requests."""
        pool.allocate_physical(n_layers=self.mcfg.n_layers,
                               n_kv_heads=self.mcfg.n_kv_heads,
                               head_dim=self.mcfg.dh,
                               dtype=self.mcfg.torch_dtype(),
                               kv_dtype=self.kv_dtype_name or self.kv_dtype,
                               device=self.device)
        self.pool = pool
        self.max_row_pages = -(-int(max_len) // pool.tokens_per_page)
        self._groups.clear()

    def _pools(self) -> Dict[str, torch.Tensor]:
        """The pool's device tensors: pages, plus scales when quantized."""
        pools = {"k": self.pool.k_pages, "v": self.pool.v_pages}
        if self.kv_quantized:
            pools["ks"] = self.pool.k_scales
            pools["vs"] = self.pool.v_scales
        return pools

    # -------------------------------------------------------------- groups
    def groups(self) -> List[PagedGroup]:
        return list(self._groups.values())

    def group_for(self, mask: np.ndarray,
                  cache_len: Optional[int] = None) -> PagedGroup:
        """Pages make cache length a per-slot property (``cache_len`` is
        ignored): in masked mode ONE group hosts every request (masks ride
        per-slot gates), in structural mode one group per bucket."""
        if self.pool is None:
            raise RuntimeError("PagedExecutor has no bound pool — the "
                               "engine calls bind_pool() per run")
        if self.mode == "masked":
            rkey, kw = "masked", {}
        else:
            rkey, kw = _structural_group(self.mcfg, mask, self.bucket_quant)
        group = self._groups.get(rkey)
        if group is None:
            group = self._groups[rkey] = PagedGroup(
                self.mcfg, self.max_active, self.max_row_pages,
                self.pool.scratch_page, self.device, **kw)
        return group

    # ------------------------------------------------------------- prefill
    def prefill_into(self, group: PagedGroup, slots: List[int], rid: str,
                     prompt: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Prefill the request, write its K/V into the pages the pool
        granted at admission, seat its rows in ``slots``, and return the
        first sampled tokens ``[b]``. A quantized pool prefills at model
        width and quantizes the whole pages on the write (every granted
        page is fresh, so no scale floor)."""
        b, S = prompt.shape
        cfg, pt = self.mcfg, self.pool.tokens_per_page
        rows_np = np.asarray(self.pool.row_pages(rid), np.int32)  # [b, npg]
        npg = rows_np.shape[1]
        cols = _gate_cols(mask, group.gate_rows)
        t0 = time.perf_counter()
        logits, cache = decoder.prefill(
            self.params, cfg, torch.from_numpy(
                np.asarray(prompt, np.int32)).to(self.device),
            npg * pt, gates=_gate_tensors(cols, self.device),
            layout=group.layout)
        Lp = cols.shape[1]                  # layout rows: pool layers [0, Lp)
        shape = (Lp, b, npg, pt, cfg.n_kv_heads, cfg.dh)
        rows = torch.from_numpy(rows_np).to(self.device).long()
        # in-place scatter into the pool (positions past S carry zeros)
        pools = self._pools()
        for pk, sk in (("k", "ks"), ("v", "vs")):
            kv = cache["attn"][pk].reshape(shape)
            if self.kv_quantized:
                kv, sc = attention.page_quant(kv.float(), pools[pk].dtype)
                pools[sk][:Lp, rows] = sc
            put_pages(pools[pk], (slice(0, Lp), rows), kv)
        first_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        first = first_dev.cpu().numpy()
        self.launch_s += time.perf_counter() - t0
        group.place(rid, slots, rows_np, S, first_dev, first, cols)
        return first

    # ----------------------------------------------------- chunked prefill
    def supports_chunked_prefill(self, group: PagedGroup) -> bool:
        # the constructor pins uniform all-attention models and structural
        # buckets are whole-layer: exactly what the paged chunk path serves,
        # at any pool precision
        return True

    def prefill_begin(self, group: PagedGroup, slots: List[int], rid: str,
                      prompt: np.ndarray, mask: np.ndarray, *,
                      max_chunk: int) -> _PrefillTask:
        """Open a chunked prefill. The admission allocation covers the
        first chunk; each later chunk extends the request's pages just
        before it runs, so a long prompt's pages are granted as it goes."""
        prompt = np.asarray(prompt, np.int32)
        group.reserved.update(slots)
        return _PrefillTask(group=group, slots=list(slots), rid=rid,
                            prompt=prompt,
                            cols=_gate_cols(mask, group.gate_rows),
                            widths=chunk_widths(prompt.shape[1], max_chunk))

    def prefill_step(self, task: _PrefillTask) -> Optional[np.ndarray]:
        """Run the task's next chunk; returns the first sampled tokens
        ``[b]`` once the last chunk is done (and seats the request), else
        None."""
        group, rid = task.group, task.rid
        b, S = task.prompt.shape
        c = task.widths[task.step]
        if task.pos > 0:
            # the admission alloc covered chunk 0; grant this chunk's pages
            self.pool.extend(rid, c)
        rows_np = np.asarray(self.pool.row_pages(rid), np.int32)
        table = np.full((b, self.max_row_pages), self.pool.scratch_page,
                        np.int32)
        table[:, :rows_np.shape[1]] = rows_np
        t0 = time.perf_counter()
        logits = decoder.paged_prefill_chunk(
            self.params, self.mcfg, self._pools(),
            torch.from_numpy(table).to(self.device),
            torch.from_numpy(task.prompt[:, task.pos:task.pos + c]).to(
                self.device), task.pos,
            scratch_page=self.pool.scratch_page,
            gates=_gate_tensors(task.cols, self.device), layout=group.layout)
        task.pos += c
        task.step += 1
        if not task.done:
            self.launch_s += time.perf_counter() - t0
            return None
        first_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        first = first_dev.cpu().numpy()
        self.launch_s += time.perf_counter() - t0
        group.place(rid, task.slots, rows_np, S, first_dev, first, task.cols)
        return first

    # ---------------------------------------------------- preemption seam
    def spill_state(self, group: PagedGroup, slots: List[int]) -> dict:
        """Paged decode state outside the pool is tiny: the write position
        and the per-row seed token (the page contents travel with
        ``KVPool.spill``)."""
        return {"pos": int(group.pos[slots[0]]),
                "first": group.tokens[np.asarray(slots)].copy()}

    def restore_state(self, group: PagedGroup, slots: List[int], rid: str,
                      state: dict, mask, rows=None) -> None:
        """Reseat with the re-granted page ids (``KVPool.restore``'s rows:
        the same per-row layout, contents written back bitwise): one
        placement rebuilds table, position, tokens and gates as an
        unpreempted resident holds them."""
        if rows is None:
            rows = self.pool.row_pages(rid)
        first = np.asarray(state["first"], np.int32)
        group.place(rid, list(slots), np.asarray(rows, np.int32),
                    state["pos"], torch.from_numpy(first).to(self.device),
                    first, _gate_cols(mask, group.gate_rows))

    # -------------------------------------------------------------- decode
    def _decode_batch(self, group: PagedGroup) -> List[int]:
        idx = _bucket_batch(group.occupied_slots(), group.free_slots(),
                            group.n_slots, self.decode_buckets)
        # full width: every slot steps (free rows write the scratch page)
        return idx if idx is not None else list(range(group.n_slots))

    def pre_extend_horizon(self, group: PagedGroup, horizon: int) -> int:
        """Pre-grant every page the coming horizon can touch: one bulk
        ``KVPool.extend`` per resident request, clamped to its admission
        commitment, folded into the device page table in one scatter.
        Positions past the commitment (a request over-generating inside its
        final horizon) resolve to the scratch page or its own last page and
        are truncated by the engine. Returns the number of pages granted."""
        occ = group.occupied_slots()
        entries: List[Tuple[int, int, int]] = []
        seen = set()
        for s in occ:
            rid = group.occupants[s]
            if rid in seen:
                continue
            seen.add(rid)
            n = min(int(horizon), self.pool.remaining_commitment(rid))
            if n <= 0:
                continue
            have = self.pool.pages_per_row(self.pool.seq_tokens(rid))
            new_rows = self.pool.extend(rid, n)    # [batch][granted pages]
            if not any(new_rows):
                continue
            rid_slots = [t for t in occ if group.occupants[t] == rid]
            for i, t in enumerate(rid_slots):
                for j, page in enumerate(new_rows[i]):
                    entries.append((t, have + j, page))
        group.grant_pages(entries)
        return len(entries)

    def launch_horizon(self, group: PagedGroup,
                       horizon: int) -> Tuple[torch.Tensor, List[int]]:
        """Device phase of a paged horizon: gather the stepped slots'
        resident state, enqueue ``horizon`` decode steps against the page
        pools, and write positions/tokens back — all on the device, no host
        read. Pages must already be granted (:meth:`pre_extend_horizon`).
        Returns (device toks [width, H], stepped slot ids)."""
        idx = self._decode_batch(group)
        full = len(idx) == group.n_slots
        g = group.gates_dev
        if full:
            table, pos, tok = group.table_dev, group.pos_dev, group.tokens_dev
        else:
            iidx = group.iidx(idx)
            g = g[:, :, iidx]
            table, pos, tok = (group.table_dev[iidx], group.pos_dev[iidx],
                               group.tokens_dev[iidx])
        toks, _, pos_out = decoder.paged_decode_horizon(
            self.params, self.mcfg, self._pools(), table, pos, tok[:, None],
            horizon, gates={"mixer": g[0], "ffn": g[1]},
            split_rows=group.n_slots, layout=group.layout)
        if full:
            group.pos_dev, group.tokens_dev = pos_out, toks[:, -1].contiguous()
        else:
            group.pos_dev[iidx] = pos_out
            group.tokens_dev[iidx] = toks[:, -1]
        return toks, idx

    def decode_launch(self, group: PagedGroup,
                      horizon: int) -> _InFlightHorizon:
        """Bulk page pre-grant + one horizon launch, no host read: the host
        is free to schedule and admit while the card decodes."""
        self.pre_extend_horizon(group, horizon)
        t0 = time.perf_counter()
        toks_dev, idx = self.launch_horizon(group, horizon)
        self.launch_s += time.perf_counter() - t0
        return _InFlightHorizon(group=group, horizon=int(horizon),
                                toks_dev=toks_dev, idx=idx,
                                occupants=[group.occupants[s] for s in idx])

    def decode_finish(self, launch: _InFlightHorizon) -> np.ndarray:
        group, h = launch.group, launch.horizon
        t0 = time.perf_counter()
        nxt = launch.toks_dev.cpu().numpy()   # the single device→host read
        self.launch_s += time.perf_counter() - t0
        out = np.zeros((group.n_slots, h), np.int32)
        for j, s in enumerate(launch.idx):
            # fold back only slots whose occupant is unchanged since launch
            if (launch.occupants[j] is not None
                    and group.occupants[s] == launch.occupants[j]):
                out[s] = nxt[j]
                group.tokens[s] = nxt[j, -1]
                group.pos[s] += h
        return out

    # ---------------------------------------------------------- utilization
    def kv_utilization(self) -> Tuple[float, float]:
        """used = tokens actually written by resident requests; physical =
        bytes of the pages they hold."""
        if self.pool is None or not self._groups:
            return 0.0, 0.0
        tok_bytes = self.pool.page_bytes / self.pool.tokens_per_page
        used = 0.0
        for group in self._groups.values():
            for s in group.occupied_slots():
                rid = group.occupants[s]
                used += min(int(group.pos[s]),
                            self.pool.seq_tokens(rid)) * tok_bytes
        return used, self.pool.bytes_reserved

    def stats(self) -> Dict[str, int]:
        """Group counts, as :meth:`LocalExecutor.stats`."""
        return {"groups": len(self._groups),
                "structural_buckets": sum(k != "masked" for k in self._groups),
                "bucket_signatures": len({g.key for g in self._groups.values()
                                          if g.key != "masked"}),
                "resident_param_stacks": 0}


# ----------------------------------------------------------------- sharded
_ROADMAP_STRUCTURAL = (
    "structural sharded buckets (per-bucket layouts placed on the mesh) "
    "are ROADMAP item 16b, and JAX refuses them too — use LocalExecutor "
    "for structural serving")


def _digest(*parts) -> int:
    """A signed 64-bit digest of ``parts`` (arrays, numbers, strings)."""
    import hashlib
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray) or torch.is_tensor(p):
            a = np.ascontiguousarray(np.asarray(p))
            h.update(str((a.dtype.str, a.shape)).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(p).encode())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


class ShardedSlotGroup(SlotGroup):
    """A :class:`SlotGroup` whose decode state is **mesh-resident**
    (DESIGN.md §7 "Sharded serving"), in explicit SPMD: every rank holds
    the group's host bookkeeping for all ``n_slots`` slots (occupants,
    positions, reservations — the engine's view, identical on every
    rank) and, on the device, only its own block of the state.

    The slot axis is the mesh's data-parallel dimension, as
    ``parallel.sharding.serve_state_pspecs`` lays it out: DP rank d of D
    owns slots [d·n/D, (d+1)·n/D) (when D does not divide ``n_slots`` the
    rules replicate the slot axis, and every rank holds every slot). KV
    leaves hold this rank's K/m heads where K divides the model axis, all
    K heads otherwise; an RG-LRU state holds the rank's W/m width where
    that block is cut (the rules replicate it over "model"; each rank
    stores the columns it computes). Gates follow the slots.

    A horizon decodes the rank's own slots (every slot steps: there is no
    bucketed gather, the slot axis IS the mesh axis), with the group's
    global width as ``split_rows`` so that a row takes the split count it
    takes under :class:`LocalExecutor`, then all-gathers the ``[n_slots,
    H]`` tokens over the data axis: the one result every rank reads back."""

    def __init__(self, executor: "ShardedExecutor", n_slots: int,
                 cache_len: int):
        mesh = executor.mesh
        self._exec = executor
        self.key = "masked"
        self.layout = None
        self.mask = None
        self.gate_rows = None
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.device = executor.device
        self.occupants: List[Optional[str]] = [None] * self.n_slots
        self.reserved: set = set()
        self.pos = np.zeros(self.n_slots, np.int64)
        self._mcfg = executor.mcfg
        self._iidx_cache: Dict[Tuple[int, ...], torch.Tensor] = {}
        dp = mesh.dp_axes
        self.dp_group = mesh.group(dp)
        D, d = mesh.axis_size(dp), mesh.coord(dp)
        self.split = self.n_slots % D == 0
        per = self.n_slots // D if self.split else self.n_slots
        self.lo = d * per if self.split else 0
        self.n_local = per
        self.cache = decoder.init_cache(executor.lcfg, per, self.cache_len,
                                        executor.kv_dtype, self.device)
        self.cache["pos"] = torch.zeros(per, dtype=torch.int32,
                                        device=self.device)
        self.tokens = torch.zeros(per, 1, dtype=torch.int32,
                                  device=self.device)
        self.gates_dev = torch.ones(2, executor.mcfg.n_layers, per,
                                    device=self.device)
        full = decoder.init_cache(executor.mcfg, self.n_slots,
                                  self.cache_len, executor.kv_dtype, "meta")
        self.attn_bytes = sum(t.numel() * t.element_size()
                              for t in full.get("attn", {}).values())

    # ---------------------------------------------------------- ownership
    def owner(self, slot: int) -> int:
        """The data coordinate that holds ``slot``."""
        return slot // self.n_local if self.split else 0

    def owned(self, slots: Sequence[int]) -> List[Tuple[int, int]]:
        """(row in ``slots``, local slot) of the slots this rank holds."""
        return [(i, s - self.lo) for i, s in enumerate(slots)
                if self.lo <= s < self.lo + self.n_local]

    def place(self, rid: str, slots: List[int], req_cache: Optional[dict],
              cols: np.ndarray, prompt_len: int,
              first_dev: Optional[torch.Tensor]) -> None:
        """Seat a request: the host bookkeeping of every slot, and the
        device rows of the slots this rank holds (``req_cache``: every
        leaf with ``len(slots)`` rows at axis 1; None on a rank that holds
        none of them)."""
        self.reserved.difference_update(slots)
        for s in slots:
            self.occupants[s] = rid
            self.pos[s] = prompt_len
        mine = self.owned(slots)
        if not mine:
            return
        rows = self.iidx([i for i, _ in mine])
        lidx = self.iidx([j for _, j in mine])
        for kind, leaves in _state_leaves(self.cache).items():
            for key, leaf in leaves.items():
                put_slots(leaf, lidx, take_slots(req_cache[kind][key], rows))
        self.cache["pos"][lidx] = int(prompt_len)
        self.tokens[lidx, 0] = first_dev[rows]
        self.gates_dev[:, :, lidx] = torch.from_numpy(cols).to(
            self.device)[:, :, None]

    def launch_horizon(self, horizon: int, buckets: Sequence[int] = ()
                       ) -> Tuple[torch.Tensor, Optional[List[int]]]:
        """H greedy steps of this rank's slots, then the tokens of every
        slot all-gathered over the data axis: (device toks [n_slots, H],
        None — the full width)."""
        if buckets:
            raise NotImplementedError(
                "sharded slot groups always step full width — the slot "
                "axis is the mesh's DP dimension (ShardedExecutor runs "
                "with decode_buckets=())")
        g = self.gates_dev
        with self._exec.context():
            toks, self.cache = decoder.decode_horizon(
                self._exec.compute_params(), self._mcfg, self.cache,
                self.tokens, horizon, gates={"mixer": g[0], "ffn": g[1]},
                split_rows=self.n_slots)
        self.tokens = toks[:, -1:].contiguous()
        if self.split:
            from repro_torch.parallel.tp import all_gather_cat
            toks = all_gather_cat(toks, self.dp_group)
        return toks, None


SHARD_SEQ = "shard_seq: sequence parallelism is ROADMAP item 16b"


class ShardedExecutor(LocalExecutor):
    """Mesh-resident slot-group execution (DESIGN.md §7 "Sharded
    serving"), explicit SPMD over a :class:`repro_torch.launch.mesh.Mesh`.

    Every rank runs the same engine on the same seed and requests, and
    this executor on its own blocks: parameters are placed under the
    production rules (``parallel.sharding.param_pspecs``: TP over feature
    dims, vocab and experts; ``fsdp=True`` also ZeRO-3 over "data",
    gathered once per call), and groups are :class:`ShardedSlotGroup`.
    The model code runs under ``parallel.activation.use(mesh)``, so a
    model axis wider than one computes each rank's heads, features,
    width and experts with the collectives of ``parallel.tp``.

    Prefill and placement run on the data rank that holds the request's
    slots (every rank of its model group), and its first tokens are
    broadcast over the data axis; a horizon decodes each rank's slots and
    all-gathers the tokens. Whatever a rank reads back is therefore
    rank-identical. ``group_for`` and ``prefill_into`` all-gather a
    digest of the keep-mask (and the prompt) over the world and raise if
    the ranks disagree. A spilled request's state is gathered to every
    data rank (:meth:`spill_state`), so it may resume in slots another
    rank holds.

    Masked mode only — one gated group per cache length serves every
    keep-mask; structural sharded buckets are refused, as in JAX, and so
    are ``shard_seq`` (sequence parallelism, ROADMAP item 16b) and a
    bucketed horizon. ``kv_int8=True`` is read by :meth:`lower_decode`
    alone, as in JAX; the slot caches' precision is ``kv_dtype``."""

    def __init__(self, model, mesh, *, params=None, fsdp: bool = False,
                 shard_seq: bool = False, kv_int8: bool = False,
                 mode: str = "masked", max_active: int = 8, kv_dtype=None):
        if mode != "masked":
            raise NotImplementedError(
                f"sharded serving is masked-mode only (got {mode!r}); "
                + _ROADMAP_STRUCTURAL)
        if shard_seq:
            raise NotImplementedError(SHARD_SEQ)
        self.mesh = mesh
        self.policy = {"fsdp": bool(fsdp), "shard_seq": False,
                       "kv_int8": bool(kv_int8)}
        self.model = model
        self._specs = None
        placed = self.place_params(params) if params is not None else None
        super().__init__(model, placed, mode="masked",
                         max_active=max_active, kv_dtype=kv_dtype,
                         decode_buckets=())
        self.device = mesh.device
        self.lcfg = model.cfg       # the cache shapes this rank holds
        if placed is not None:
            with self.context():
                self.lcfg = decoder.local_cfg(placed, model.cfg)

    # ----------------------------------------------------------- placement
    def param_specs(self):
        """The parameters' partition specs on this mesh."""
        from repro_torch.parallel.sharding import param_pspecs
        if self._specs is None:
            self._specs = param_pspecs(self.model.init(0, "meta"), self.mesh,
                                       fsdp=self.policy["fsdp"])
        return self._specs

    def place_params(self, params):
        """This rank's blocks of ``params`` under the production rules (a
        view of each leaf where nothing is cut)."""
        from repro_torch.parallel.sharding import shard_params
        return shard_params(params, self.param_specs(), self.mesh,
                            self.mesh.coords, self.model.cfg)

    def context(self):
        """The mesh policy the model code runs under."""
        from repro_torch.parallel import activation as act
        return act.use(self.mesh, fsdp=self.policy["fsdp"])

    def compute_params(self):
        """The parameters a call computes with: the placed blocks, with
        ZeRO-3 leaves gathered over "data" for the call (a collective:
        every rank calls it, whether or not it holds the call's slots)."""
        if self.policy["fsdp"] and self.mesh.axis_size(
                self.mesh.dp_axes) > 1:
            from repro_torch.parallel.tp import gather_fsdp
            return gather_fsdp(self.params, self.param_specs(), self.mesh)
        return self.params

    def lower_decode(self, shape) -> dict:
        """The counted record of one sharded decode step at ``shape`` (a
        ``configs.ShapeConfig``: its global batch, a cache of its
        ``seq_len``, every slot valid) on this rank: the step JAX lowers
        here for cost, memory and collective analysis. The port compiles
        nothing, so the step runs once on fake tensors of this rank's
        blocks under ``runtime.count.count_step`` (``memory``, ``cost``,
        ``collectives``, ``kernels``); the cache is int8 under
        ``kv_int8``. Needs no ``params``."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.runtime import count
        with FakeTensorMode():
            params, specs, cache, tokens = count.fake_decode_args(
                self.model, self.mesh, shape, self.policy, shape.seq_len)
            counted = count.count_step(
                count.decode_step_fn(self.model, self.mesh, self.policy,
                                     specs), params, cache, tokens)
        return {"shape": shape.name, "n_devices": int(self.mesh.size),
                "mesh": dict(self.mesh.shape), "policy": dict(self.policy),
                **counted}

    # ------------------------------------------------------------ agreement
    def _agree(self, what: str, *parts) -> None:
        """Raise unless every rank passes the same ``parts``."""
        import torch.distributed as dist
        from repro_torch.parallel.tp import all_gather_cat
        mine = torch.tensor([_digest(*parts)], dtype=torch.int64,
                            device=self.device)
        every = all_gather_cat(mine, None).cpu().numpy()
        if (every != every[0]).any():
            raise RuntimeError(
                f"ShardedExecutor.{what}: the ranks disagree (digests "
                f"{every.tolist()}, this is rank {dist.get_rank()}); every "
                f"rank must run the same engine on the same requests")

    def agree_clock(self, t: float) -> float:
        """The engine's clock reading, the same on every rank: the latest
        of the ranks' readings (a world of one reads its own)."""
        import torch.distributed as dist
        if dist.get_world_size() == 1:
            return t
        x = torch.tensor([t], dtype=torch.float64, device=self.device)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x[0])

    # ------------------------------------------------------------ serve API
    def group_for(self, mask: np.ndarray,
                  cache_len: Optional[int] = None) -> ShardedSlotGroup:
        """One gated mesh-resident group per cache length (every keep-mask
        shares it, as on the local path)."""
        if self.params is None:
            raise RuntimeError(
                "ShardedExecutor has no params — construct with params= "
                "to serve")
        self._agree("group_for", np.asarray(mask, np.float32),
                    int(cache_len))
        gkey = ("masked", int(cache_len))
        group = self._groups.get(gkey)
        if group is None:
            group = self._groups[gkey] = ShardedSlotGroup(
                self, self.max_active, int(cache_len))
            self.groups_minted += 1
        return group

    def _first_tokens(self, group: ShardedSlotGroup, slots: List[int],
                      first_dev: Optional[torch.Tensor],
                      b: int) -> torch.Tensor:
        """The first tokens of a request, on every rank: broadcast over
        the data axis from the lowest data rank that holds its slots."""
        if not group.split:
            return first_dev
        import torch.distributed as dist
        src = min(group.owner(s) for s in slots)
        buf = (first_dev.contiguous().clone() if first_dev is not None
               else torch.zeros(b, dtype=torch.int32, device=self.device))
        dist.broadcast(buf, src=dist.get_global_rank(group.dp_group, src),
                       group=group.dp_group)
        return buf

    def prefill_into(self, group: ShardedSlotGroup, slots: List[int],
                     rid: str, prompt: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
        """Prefill on the data rank(s) holding ``slots`` (the whole
        request, as :class:`LocalExecutor` does), broadcast its first
        tokens, seat it; returns the first tokens ``[b]``."""
        prompt = np.asarray(prompt, np.int32)
        self._agree("prefill_into", prompt, np.asarray(mask, np.float32),
                    list(slots), rid)
        b, S = prompt.shape
        cols = _gate_cols(mask, None)
        t0 = time.perf_counter()
        first_dev, state = None, None
        params = self.compute_params()      # a collective under fsdp
        if group.owned(slots):
            with self.context():
                logits, cache = decoder.prefill(
                    params, self.mcfg,
                    torch.from_numpy(prompt).to(self.device),
                    group.cache_len, gates=_gate_tensors(cols, self.device),
                    kv_dtype=self.kv_dtype)
            first_dev = torch.argmax(logits, dim=-1).to(torch.int32)
            state = _state_leaves(cache)
        first_dev = self._first_tokens(group, slots, first_dev, b)
        first = first_dev.cpu().numpy()
        self.launch_s += time.perf_counter() - t0
        group.place(rid, slots, state, cols, S, first_dev)
        return first

    def prefill_begin(self, group: ShardedSlotGroup, slots: List[int],
                      rid: str, prompt: np.ndarray, mask: np.ndarray, *,
                      max_chunk: int) -> _PrefillTask:
        """Reserve the slots on every rank; the data rank(s) holding them
        mint the request-sized cache the chunks accumulate into."""
        prompt = np.asarray(prompt, np.int32)
        self._agree("prefill_begin", prompt, np.asarray(mask, np.float32),
                    list(slots), rid)
        group.reserved.update(slots)
        state = None
        if group.owned(slots):
            state = decoder.init_cache(self.lcfg, prompt.shape[0],
                                       group.cache_len, self.kv_dtype,
                                       self.device)
        return _PrefillTask(group=group, slots=list(slots), rid=rid,
                            prompt=prompt, cols=_gate_cols(mask, None),
                            widths=chunk_widths(prompt.shape[1], max_chunk),
                            state=state)

    def prefill_step(self, task: _PrefillTask) -> Optional[np.ndarray]:
        """The task's next chunk on the holding rank(s); once the last is
        done, the first tokens are broadcast and the request seated."""
        S = task.prompt.shape[1]
        c = task.widths[task.step]
        t0 = time.perf_counter()
        logits = None
        params = self.compute_params()      # a collective under fsdp
        if task.state is not None:
            with self.context():
                logits = decoder.prefill_chunk(
                    params, self.mcfg, task.state,
                    torch.from_numpy(task.prompt[:, task.pos:task.pos + c]
                                     ).to(self.device), task.pos,
                    gates=_gate_tensors(task.cols, self.device))
        task.pos += c
        task.step += 1
        if not task.done:
            self.launch_s += time.perf_counter() - t0
            return None
        first_dev = (torch.argmax(logits, dim=-1).to(torch.int32)
                     if logits is not None else None)
        first_dev = self._first_tokens(task.group, task.slots, first_dev,
                                       task.prompt.shape[0])
        first = first_dev.cpu().numpy()
        self.launch_s += time.perf_counter() - t0
        task.group.place(task.rid, task.slots,
                         _state_leaves(task.state) if task.state else None,
                         task.cols, S, first_dev)
        task.state = None
        return first

    # ---------------------------------------------------- preemption seam
    def spill_state(self, group: ShardedSlotGroup, slots: List[int]) -> dict:
        """The request's rows of every state leaf, its position and seed
        tokens, on every data rank: each holder fills its rows, the blocks
        are all-gathered over the data axis and each row is taken from its
        holder's block (a gather, not a sum: the bits travel unchanged),
        then copied to the host."""
        if not group.split:
            return LocalExecutor.spill_state(self, group, slots)
        from repro_torch.parallel.tp import all_gather_cat
        b = len(slots)
        mine = group.owned(slots)
        rows = group.iidx([i for i, _ in mine]) if mine else None
        lidx = group.iidx([j for _, j in mine]) if mine else None
        owners = torch.tensor([group.owner(s) for s in slots],
                              device=self.device)
        pick = owners * b + torch.arange(b, device=self.device)

        def share(leaf: torch.Tensor) -> torch.Tensor:
            """Rows ``slots`` of a [L, n_local, ...] leaf (slot axis 1)."""
            buf = torch.zeros((leaf.shape[0], b) + tuple(leaf.shape[2:]),
                              dtype=leaf.dtype, device=self.device)
            if mine:
                put_slots(buf, rows, take_slots(leaf, lidx))
            # as bytes: the codes of every dtype cross unchanged
            every = all_gather_cat(buf.view(torch.uint8), group.dp_group,
                                   dim=1).view(leaf.dtype)
            return take_slots(every, pick).cpu()

        cache = {kind: {k: share(v) for k, v in leaves.items()}
                 for kind, leaves in _state_leaves(group.cache).items()}
        pos = share(group.cache["pos"][None])[0]
        first = share(group.tokens[None, :, 0])[0]
        return {"cache": cache, "pos": int(pos[0]), "first": first}

    def restore_state(self, group: ShardedSlotGroup, slots: List[int],
                      rid: str, state: dict, mask, rows=None) -> None:
        """Reseat through the ordinary placement: each rank writes the rows
        of the slots it holds, whichever rank spilled them."""
        dev = self.device
        cache = {kind: {k: v.to(dev) for k, v in leaves.items()}
                 for kind, leaves in state["cache"].items()}
        group.place(rid, list(slots), cache, _gate_cols(mask, None),
                    state["pos"], state["first"].to(dev))

    # ---------------------------------------------------------- utilization
    def kv_utilization(self) -> Tuple[float, float]:
        """The mesh's logical KV bytes, as :class:`LocalExecutor` counts
        them for the same groups (the same on every rank)."""
        used = phys = 0.0
        for g in self._groups.values():
            if not g.attn_bytes:
                continue
            phys += g.attn_bytes
            per_tok = g.attn_bytes / (g.n_slots * g.cache_len)
            used += sum(min(int(g.pos[s]), g.cache_len)
                        for s in g.occupied_slots()) * per_tok
        return used, phys

    def stats(self) -> Dict[str, int]:
        s = super().stats()
        s["mesh_devices"] = int(self.mesh.size)
        return s
