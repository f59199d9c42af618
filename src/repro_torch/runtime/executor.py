"""Model executors — the execution seam of the serving engine.

The engine decides *who* runs (scheduler) and *what shape* they run in
(pruning policy); a :class:`ModelExecutor` owns *how* the chosen masks
execute. The port has one backend so far, :class:`PagedExecutor`:
physically paged KV execution in masked mode. Requests own *pages* of a
global KV pool (``repro_torch.runtime.kv_pool.KVPool`` holds the page
tensors on the device), prefill writes KV straight into granted pages, and
one decode horizon advances any mix of cache lengths through a per-request
page table.

Decode state is device-resident: a group keeps page-table rows, positions,
seed tokens and ``[2, L, n_slots]`` gates as device tensors, updated in
place at placement, eviction and page grants. A horizon of H greedy tokens
is a loop of H decode steps launched back to back on the current CUDA
stream with the argmax token fed back on the device; the host reads the
``[B, H]`` tokens once, in :meth:`PagedExecutor.decode_finish` (the
counterpart of JAX's async dispatch: the launch returns at once and the
host schedules while the card works).

Structural mode (compacted stacks), chunked prefill, quantized pages,
spill/restore and the slot-cache ``LocalExecutor`` are later slices
(ROADMAP queue 1, items 4 and 6–9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import decoder
from repro_torch.runtime.kv_pool import resolve_kv_dtype

__all__ = ["ModelExecutor", "PagedExecutor", "PagedGroup", "chunk_widths"]


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
class _InFlightHorizon:
    """A launched-but-unread decode horizon. Occupancy is captured at
    launch, so host work overlapped with the device loop (admission may
    seat new requests into slots that were free padding at launch) cannot
    corrupt the finish-side bookkeeping."""
    group: Any
    horizon: int
    toks_dev: Any                     # device [width, horizon] tokens
    idx: List[int]                    # stepped slots
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


# ---------------------------------------------------------------- protocol
class ModelExecutor:
    """Execution backend protocol for the engine.

    ``group_for`` resolves a keep-mask to the group that will host the
    request; ``prefill_into`` seats a prefilled request; ``decode_launch``
    / ``decode_finish`` advance one group H tokens with one read-back.
    ``launch_s`` accumulates wall time spent launching device work and
    reading it back. ``paged`` marks backends whose KV lives in a
    :class:`KVPool`'s page tensors (the engine then admits through the
    token-granular pool API and calls ``bind_pool`` per run)."""

    launch_s: float = 0.0
    paged: bool = False

    def group_for(self, mask: np.ndarray):
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

    def groups(self) -> list:
        raise NotImplementedError

    def kv_utilization(self) -> Tuple[float, float]:
        """(used_bytes, physical_bytes) of live KV storage."""
        return 0.0, 0.0

    def stats(self) -> Dict[str, int]:
        return {}


# ------------------------------------------------------------------- paged
class PagedGroup:
    """One paged decode family: occupancy + page tables, no slot cache.

    Owns the per-slot decode state around the pool's pages — int32
    page-table rows, write positions, next tokens and gates — as device
    tensors (``table_dev``/``pos_dev``/``tokens_dev``/``gates_dev``)
    updated in place, plus host mirrors (``table``/``pos``/``tokens``) for
    the engine's bookkeeping."""

    def __init__(self, cfg_model, n_slots: int, max_row_pages: int,
                 scratch_page: int, device):
        self.n_slots = n_slots
        self.max_row_pages = max_row_pages
        self.scratch_page = scratch_page
        self.device = device
        self.occupants: List[Optional[str]] = [None] * n_slots
        # padded decode rows write their garbage KV into the scratch page
        self.table = np.full((n_slots, max_row_pages), scratch_page, np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.tokens = np.zeros((n_slots,), np.int32)
        self.table_dev = torch.from_numpy(self.table.copy()).to(device)
        self.pos_dev = torch.zeros(n_slots, dtype=torch.int32, device=device)
        self.tokens_dev = torch.zeros(n_slots, dtype=torch.int32,
                                      device=device)
        self.gates_dev = torch.ones(2, cfg_model.n_layers, n_slots,
                                    device=device)
        self._iidx_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    def free_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupants) if o is None]

    def occupied_slots(self) -> List[int]:
        return [i for i, o in enumerate(self.occupants) if o is not None]

    def occupied(self) -> bool:
        return any(o is not None for o in self.occupants)

    def iidx(self, idx: List[int]) -> torch.Tensor:
        """Device copy of a slot-index vector, cached by its pattern, so a
        steady-state horizon launch uploads nothing."""
        key = tuple(idx)
        dev = self._iidx_cache.get(key)
        if dev is None:
            if len(self._iidx_cache) >= 256:     # bound the pattern cache
                self._iidx_cache.pop(next(iter(self._iidx_cache)))
            dev = self._iidx_cache[key] = torch.tensor(
                idx, dtype=torch.long, device=self.device)
        return dev

    def place(self, rid: str, slots: List[int], rows_np: np.ndarray,
              prompt_len: int, first_dev: torch.Tensor,
              first: np.ndarray, cols: np.ndarray) -> None:
        """Seat a prefilled request: host mirrors plus in-place writes of
        the placed rows of every device tensor."""
        npg = rows_np.shape[1]
        full_rows = np.full((len(slots), self.max_row_pages),
                            self.scratch_page, np.int32)
        full_rows[:, :npg] = rows_np
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
    """Physically paged KV execution, masked mode.

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
    """

    paged = True

    def __init__(self, model, params, *, mode: str = "masked",
                 max_active: int = 8, kv_dtype=None,
                 decode_buckets: Sequence[int] = (1, 2, 4, 8)):
        if mode == "structural":
            raise NotImplementedError(
                "structural mode (compacted layer stacks) is ROADMAP "
                "queue 1, item 8")
        if mode != "masked":
            raise ValueError(f"unknown mode {mode!r}")
        name, store, quantized, _ = resolve_kv_dtype(kv_dtype)
        if quantized:
            raise NotImplementedError(
                f"kv_dtype {name!r}: quantized page pools are ROADMAP "
                f"queue 1, item 6")
        decoder._check_uniform(model.cfg)
        self.model = model
        self.mcfg = model.cfg
        self.params = params
        self.device = params["embed"].device
        self.mode = mode
        self.max_active = int(max_active)
        self.kv_dtype_name = name            # canonical, None = model dtype
        self.kv_dtype = store if store is not None else model.cfg.torch_dtype()
        self.decode_buckets = tuple(int(b) for b in decode_buckets or ())
        self.launch_s = 0.0
        self.pool = None               # bound per engine run
        self.max_row_pages = 0
        self._groups: Dict[Any, PagedGroup] = {}

    # ------------------------------------------------------------- binding
    def page_phys_bytes(self, tokens_per_page: int) -> int:
        """Exact bytes of one physical page across all layers (K and V)."""
        cfg = self.mcfg
        itemsize = torch.empty((), dtype=self.kv_dtype).element_size()
        return (2 * cfg.n_layers * int(tokens_per_page) * cfg.n_kv_heads
                * cfg.dh * itemsize)

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
        return {"k": self.pool.k_pages, "v": self.pool.v_pages}

    # -------------------------------------------------------------- groups
    def groups(self) -> List[PagedGroup]:
        return list(self._groups.values())

    def group_for(self, mask: np.ndarray) -> PagedGroup:
        """ONE group hosts every request: pages make cache length a
        per-slot property, and masks ride per-slot gates."""
        if self.pool is None:
            raise RuntimeError("PagedExecutor has no bound pool — the "
                               "engine calls bind_pool() per run")
        group = self._groups.get("masked")
        if group is None:
            group = self._groups["masked"] = PagedGroup(
                self.mcfg, self.max_active, self.max_row_pages,
                self.pool.scratch_page, self.device)
        return group

    # ------------------------------------------------------------- prefill
    def prefill_into(self, group: PagedGroup, slots: List[int], rid: str,
                     prompt: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Prefill the request, write its K/V into the pages the pool
        granted at admission, seat its rows in ``slots``, and return the
        first sampled tokens ``[b]``."""
        b, S = prompt.shape
        cfg, pt = self.mcfg, self.pool.tokens_per_page
        rows_np = np.asarray(self.pool.row_pages(rid), np.int32)  # [b, npg]
        npg = rows_np.shape[1]
        cols = _gate_cols(mask, None)
        t0 = time.perf_counter()
        gates = {"mixer": torch.from_numpy(cols[0]).to(self.device),
                 "ffn": torch.from_numpy(cols[1]).to(self.device)}
        logits, cache = decoder.prefill(
            self.params, cfg, torch.from_numpy(
                np.asarray(prompt, np.int32)).to(self.device),
            npg * pt, gates=gates)
        shape = (cfg.n_layers, b, npg, pt, cfg.n_kv_heads, cfg.dh)
        rows = torch.from_numpy(rows_np).to(self.device).long()
        # in-place scatter into the pool (positions past S carry zeros)
        self.pool.k_pages[:, rows] = cache["attn"]["k"].reshape(shape).to(
            self.pool.k_pages.dtype)
        self.pool.v_pages[:, rows] = cache["attn"]["v"].reshape(shape).to(
            self.pool.v_pages.dtype)
        first_dev = torch.argmax(logits, dim=-1).to(torch.int32)
        first = first_dev.cpu().numpy()
        self.launch_s += time.perf_counter() - t0
        group.place(rid, slots, rows_np, S, first_dev, first, cols)
        return first

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
            horizon, gates={"mixer": g[0], "ffn": g[1]})
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
        return {"groups": len(self._groups)}
