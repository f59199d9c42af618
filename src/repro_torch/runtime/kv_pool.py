"""Pooled KV-cache allocator — the shared-budget half of continuous batching.

The engine draws every request's dynamic state (the KV cache, the
Eq. (3)–(4) ``state_bytes`` term) from ONE device pool:

  * the pool owns ``capacity_bytes`` split into fixed-size pages
    (vLLM-block style); an allocation takes pages from the free list and
    returns them on completion;
  * admission control asks before the controller's keep-mask is executed,
    so requests queue instead of running out of memory when the pool is hot;
  * a :class:`repro_torch.core.memory.PoolAccounting` ledger tracks reserved
    (page-rounded) vs in-use (exact analytical) bytes.

Allocations are **token allocations** (:meth:`alloc_tokens` /
:meth:`extend`), the physically paged contract behind ``PagedExecutor``:
the pool owns the page arrays themselves
(:meth:`allocate_physical`; one K and one V pool per attention layer,
allocated once at capacity as torch tensors on the pool's device), grants
page ids whose contents the executor fills, and appends pages per decoded
token. Admission reserves a **commitment** (the request's worst-case page
count) up front, so a mid-decode :meth:`extend` can never fail:
``free pages − outstanding commitments`` is what :meth:`can_alloc_tokens`
admits against.

The byte-granular allocations of the slot-cache path (ROADMAP queue 1,
item 9), spilling a preempted request's pages to the host
(``spill``/``restore``, item 7) and quantized page pools (item 6) are
later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core.memory import PoolAccounting, PoolExhausted

__all__ = ["KVPool", "TokenAllocation", "PoolExhausted", "resolve_kv_dtype",
           "KV_DTYPE_NAMES"]

# user-facing kv-dtype names accepted by --kv-dtype and Decision.kv_dtype
KV_DTYPE_NAMES = ("fp32", "bf16", "int8", "fp8")


def resolve_kv_dtype(kv_dtype):
    """Normalize a user-facing KV dtype spec.

    Returns ``(name, storage_dtype, quantized, qmax)`` where ``name`` is the
    canonical string (or ``None`` for "use the model dtype"), ``storage_dtype``
    the torch dtype pages are stored in (``None`` when deferring to the model
    dtype), ``quantized`` whether per-page scales are required, and ``qmax``
    the symmetric quantization ceiling (127 for int8, 448 for fp8-e4m3)."""
    if kv_dtype is None:
        return None, None, False, None
    if isinstance(kv_dtype, str):
        name = kv_dtype.lower()
    else:
        name = str(kv_dtype).replace("torch.", "")   # torch dtype objects
    aliases = {"float32": "fp32", "bfloat16": "bf16",
               "float8_e4m3fn": "fp8", "auto": None}
    name = aliases.get(name, name)
    if name is None:
        return None, None, False, None
    if name == "fp32":
        return "fp32", torch.float32, False, None
    if name == "bf16":
        return "bf16", torch.bfloat16, False, None
    if name == "int8":
        return "int8", torch.int8, True, 127.0
    if name == "fp8":
        return "fp8", torch.float8_e4m3fn, True, 448.0
    if not isinstance(kv_dtype, str):
        # any other explicit dtype object passes through unquantized
        return name, kv_dtype, False, None
    raise ValueError(
        f"unknown kv_dtype {kv_dtype!r}; expected one of {KV_DTYPE_NAMES}")


@dataclasses.dataclass
class TokenAllocation:
    """A physically paged allocation: per-row page id lists that grow one
    page at a time as decode appends tokens, bounded by an admission-time
    commitment (``max_tokens``)."""
    rid: str
    batch: int
    seq_tokens: int          # tokens with granted page backing, per row
    max_tokens: int          # admission commitment, per row
    rows: List[List[int]]    # [batch][n_row_pages] physical page ids
    page_bytes: int
    tokens_per_page: int
    in_use_bytes: float      # analytical bytes charged so far
    in_use_per_token: float  # analytical bytes per appended token (all rows)

    @property
    def held_pages(self) -> int:
        return sum(len(r) for r in self.rows)

    @property
    def committed_pages(self) -> int:
        per_row = -(-max(self.max_tokens, 1) // self.tokens_per_page)
        return self.batch * per_row

    @property
    def reserved_bytes(self) -> float:
        return float(self.held_pages * self.page_bytes)


class KVPool:
    """Page-based KV-cache pool over a global byte budget."""

    def __init__(self, capacity_bytes: float, *, page_bytes: int,
                 tokens_per_page: int):
        if page_bytes <= 0:
            raise ValueError("page_bytes must be positive")
        if tokens_per_page < 1:
            raise ValueError("tokens_per_page must be >= 1")
        self.page_bytes = int(page_bytes)
        self.n_pages = max(int(capacity_bytes // self.page_bytes), 0)
        self.tokens_per_page = int(tokens_per_page)
        # capacity is page-quantized: a partial tail page is unusable
        self.acct = PoolAccounting(
            capacity_bytes=float(self.n_pages * self.page_bytes))
        self._free: List[int] = list(range(self.n_pages))
        self._tok: Dict[str, TokenAllocation] = {}
        self._committed_extra = 0   # Σ token allocs (committed − held) pages
        # physical page arrays (allocate_physical): [L, n_pages+1, pt, K, D]
        self.k_pages = None
        self.v_pages = None
        self.kv_dtype: Optional[str] = None

    # ---------------------------------------------------------- physical
    @property
    def scratch_page(self) -> int:
        """Extra physical page at index ``n_pages``: a write sink for padded
        decode-batch rows (never granted, never read under a valid mask)."""
        return self.n_pages

    def allocate_physical(self, *, n_layers: int, n_kv_heads: int,
                          head_dim: int, dtype, kv_dtype=None,
                          device="cuda") -> None:
        """Materialize the page pools on ``device``: one K and one V tensor
        per attention layer (stacked on a leading layer axis), sized once
        at capacity plus one scratch page.
        ``kv_dtype`` ``None`` keeps ``dtype``; ``"fp32"``/``"bf16"``
        override the width. Quantized pages (``"int8"``/``"fp8"``) are
        ROADMAP queue 1, item 6."""
        name, store_dtype, quantized, _ = resolve_kv_dtype(kv_dtype)
        if quantized:
            raise NotImplementedError(
                f"kv_dtype {name!r}: quantized page pools are ROADMAP "
                f"queue 1, item 6")
        self.kv_dtype = name
        phys = store_dtype if store_dtype is not None else dtype
        shape = (n_layers, self.n_pages + 1, self.tokens_per_page,
                 n_kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=phys, device=device)
        self.v_pages = torch.zeros(shape, dtype=phys, device=device)
        # analytical ledger charges arrive in model-dtype bytes; physical
        # truth per token is page_bytes / tokens_per_page
        model_tok = (2 * n_kv_heads * head_dim
                     * torch.empty((), dtype=dtype).element_size() * n_layers)
        if model_tok > 0:
            self.acct.in_use_scale = (
                self.page_bytes / self.tokens_per_page) / model_tok

    # ------------------------------------------------------------- queries
    def pages_per_row(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 1) // self.tokens_per_page)

    def pages_for_tokens(self, batch: int, n_tokens: int) -> int:
        return max(int(batch), 1) * self.pages_per_row(n_tokens)

    def can_alloc_tokens(self, batch: int, max_tokens: int) -> bool:
        """Admission check for the paged path: the request's *worst-case*
        page count must fit what is neither free-and-committed nor held."""
        need = self.pages_for_tokens(batch, max_tokens)
        return need <= len(self._free) - self._committed_extra

    def fits_capacity_tokens(self, batch: int, max_tokens: int) -> bool:
        return self.pages_for_tokens(batch, max_tokens) <= self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def committed_pages(self) -> int:
        """Pages promised to live token allocations but not yet granted."""
        return self._committed_extra

    @property
    def bytes_in_use(self) -> float:
        return self.acct.in_use_bytes

    @property
    def bytes_reserved(self) -> float:
        return self.acct.reserved_bytes

    # ----------------------------------------------------------- lifecycle
    def effective_kv_dtype(self) -> Optional[str]:
        """Canonical storage dtype name of the physical pools, or ``None``
        when unquantized pages simply mirror the model dtype."""
        if self.kv_dtype is not None:
            return self.kv_dtype
        if self.k_pages is not None:
            raw = str(self.k_pages.dtype)
            try:
                name, _, _, _ = resolve_kv_dtype(raw)
            except ValueError:
                return raw
            return name
        return None

    def check_kv_dtype(self, rid: str, kv_dtype) -> None:
        """Reject a request whose ``Decision.kv_dtype`` disagrees with the
        precision this pool's pages were allocated in. Writing model-width
        values into int8 pages (or vice versa) would silently mis-scale
        every page the request touches — fail loudly at admission instead."""
        if kv_dtype is None:
            return
        name, _, _, _ = resolve_kv_dtype(kv_dtype)
        if name is None:
            return
        pool_name = self.effective_kv_dtype()
        if name != (pool_name if pool_name is not None else name):
            raise ValueError(
                f"request {rid!r} asks for kv_dtype {name!r} but this pool "
                f"was allocated with kv_dtype {pool_name!r}; one pool holds "
                f"one precision — route the request to a matching pool or "
                f"re-allocate the pool")

    def alloc_tokens(self, rid: str, batch: int, n_tokens: int, *,
                     max_tokens: int, in_use_bytes: float = 0.0,
                     in_use_per_token: float = 0.0,
                     kv_dtype=None) -> TokenAllocation:
        """Token-granular physically paged allocation (strict only).

        Grants pages backing ``n_tokens`` per row now and *commits* up to
        ``max_tokens`` per row, so every later :meth:`extend` up to the
        commitment is guaranteed to find a free page. ``in_use_bytes`` is
        the analytical ledger charge for the granted tokens;
        ``in_use_per_token`` the charge per appended token (cross-check
        against the physical reservation). ``kv_dtype`` is the request's
        precision ask (``Decision.kv_dtype``): it must match the precision
        the physical pools were allocated in (:meth:`check_kv_dtype`)."""
        if rid in self._tok:
            raise ValueError(f"request {rid!r} already holds an allocation")
        self.check_kv_dtype(rid, kv_dtype)
        batch = max(int(batch), 1)
        n_tokens = max(int(n_tokens), 1)
        if max_tokens < n_tokens:
            raise ValueError(f"max_tokens {max_tokens} < n_tokens {n_tokens}")
        committed = self.pages_for_tokens(batch, max_tokens)
        if committed > len(self._free) - self._committed_extra:
            raise PoolExhausted(
                f"request {rid!r} commits {committed} pages "
                f"({batch}×{max_tokens} tokens), "
                f"{len(self._free) - self._committed_extra} admissible "
                f"({len(self._free)} free − {self._committed_extra} "
                f"committed) of {self.n_pages} total")
        per_row = self.pages_per_row(n_tokens)
        rows = [[self._free.pop() for _ in range(per_row)]
                for _ in range(batch)]
        alloc = TokenAllocation(
            rid=rid, batch=batch, seq_tokens=n_tokens, max_tokens=max_tokens,
            rows=rows, page_bytes=self.page_bytes,
            tokens_per_page=self.tokens_per_page,
            in_use_bytes=float(max(in_use_bytes, 0.0)),
            in_use_per_token=float(max(in_use_per_token, 0.0)))
        self._committed_extra += committed - alloc.held_pages
        self.acct.grow(alloc.reserved_bytes, alloc.in_use_bytes)
        self._tok[rid] = alloc
        return alloc

    def seq_tokens(self, rid: str) -> int:
        """Tokens per row with granted page backing for a live token
        allocation (the physical write frontier — positions beyond it have
        no page of their own)."""
        return self._tok_state(rid, "seq_tokens").seq_tokens

    def remaining_commitment(self, rid: str) -> int:
        """Tokens per row still extendable under ``rid``'s admission
        commitment (``max_tokens − seq_tokens``). The horizon decode path
        pre-grants ``min(H, remaining_commitment)`` tokens in ONE
        :meth:`extend` before launching a fused H-step loop — within the
        commitment that bulk extend can never fail in strict mode."""
        st = self._tok_state(rid, "remaining_commitment")
        return st.max_tokens - st.seq_tokens

    def _tok_state(self, rid: str, op: str) -> TokenAllocation:
        st = self._tok.get(rid)
        if st is None:
            raise ValueError(
                f"{op}({rid!r}): unknown request id; live token "
                f"allocations: {sorted(self._tok)}")
        return st

    def extend(self, rid: str, n_tokens: int = 1) -> List[List[int]]:
        """Append ``n_tokens`` decode tokens to ``rid``'s rows; returns the
        newly granted page ids per row (usually empty — a page boundary is
        crossed once every ``tokens_per_page`` tokens; a bulk horizon
        extend may grant several pages per row at once). Cannot exceed the
        admission commitment; within it, strict-mode extends never fail."""
        st = self._tok_state(rid, "extend")
        new_seq = st.seq_tokens + int(n_tokens)
        if new_seq > st.max_tokens:
            raise ValueError(
                f"extend({rid!r}) to {new_seq} tokens exceeds the admission "
                f"commitment of {st.max_tokens}")
        need_per_row = self.pages_per_row(new_seq)
        have_per_row = len(st.rows[0])
        granted: List[List[int]] = [[] for _ in st.rows]
        n_new = (need_per_row - have_per_row) * st.batch
        if n_new > 0:
            if n_new > len(self._free):
                raise PoolExhausted(
                    f"extend({rid!r}) needs {n_new} pages, "
                    f"{len(self._free)} free — commitment accounting was "
                    f"bypassed")
            for i, row in enumerate(st.rows):
                for _ in range(need_per_row - have_per_row):
                    p = self._free.pop()
                    row.append(p)
                    granted[i].append(p)
            self._committed_extra -= n_new
        st.seq_tokens = new_seq
        delta_in_use = st.in_use_per_token * int(n_tokens)
        st.in_use_bytes += delta_in_use
        self.acct.grow(float(n_new * self.page_bytes), delta_in_use)
        return granted

    def row_pages(self, rid: str) -> List[List[int]]:
        """Current per-row page ids of a live token allocation."""
        st = self._tok_state(rid, "row_pages")
        return [list(r) for r in st.rows]

    def free(self, rid: str) -> float:
        """Release a request's pages; returns the reserved bytes returned.
        Unknown ids raise a ``ValueError`` naming the id and the live set."""
        st = self._tok_state(rid, "free")
        del self._tok[rid]
        for row in st.rows:
            self._free.extend(row)
        self._committed_extra -= st.committed_pages - st.held_pages
        self.acct.release(st.reserved_bytes, st.in_use_bytes)
        return st.reserved_bytes

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        return {
            "capacity_bytes": self.acct.capacity_bytes,
            "page_bytes": float(self.page_bytes),
            "n_pages": float(self.n_pages),
            "free_pages": float(len(self._free)),
            "committed_pages": float(self._committed_extra),
            "live_requests": float(len(self._tok)),
            "reserved_bytes": self.acct.reserved_bytes,
            "in_use_bytes": self.acct.in_use_bytes,
            "peak_reserved_bytes": self.acct.peak_reserved_bytes,
            "peak_in_use_bytes": self.acct.peak_in_use_bytes,
            "occupancy": self.acct.occupancy(),
            "fragmentation": self.acct.fragmentation(),
            "overcommit_events": float(self.acct.overcommit_events),
            "in_use_scale": float(self.acct.in_use_scale),
        }
