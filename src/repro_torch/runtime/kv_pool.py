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

Two kinds of allocation:

  * **byte allocations** (:meth:`alloc`), the slot-cache path's
    accounting: ``LocalExecutor`` keeps dense slot caches of its own, and
    the pool only charges each request's analytical state bytes, rounded
    up to pages (``default_page_bytes``). ``allow_overcommit`` (force
    admission, the one-shot ``RAPServer``) takes what pages remain and
    books the rest as overflow pages past capacity, recorded as an
    overcommit;
  * **token allocations** (:meth:`alloc_tokens` / :meth:`extend`), the
    physically paged contract behind ``PagedExecutor``:
the pool owns the page arrays themselves
(:meth:`allocate_physical`; one K and one V pool per attention layer,
allocated once at capacity as torch tensors on the pool's device), grants
page ids whose contents the executor fills, and appends pages per decoded
token. Admission reserves a **commitment** (the request's worst-case page
count) up front, so a mid-decode :meth:`extend` can never fail:
``free pages − outstanding commitments`` is what :meth:`can_alloc_tokens`
admits against.

Quantized pools (``kv_dtype`` ``"int8"``/``"fp8"``) store int8 or
float8_e4m3fn pages plus per-(layer, page, kv head) f32 scales.

A preempted request leaves the device with :meth:`spill`: its page
contents and scale rows are copied to host tensors (blocking copies, so
the pages are free to be granted again the moment the call returns), its
pages return to the free list, and :meth:`restore` re-grants pages of the
same per-row layout and writes the copies back bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core.memory import MemoryModel, PoolAccounting, PoolExhausted
from repro_torch.kernels.ref import put_pages, take_pages

__all__ = ["KVPool", "PageAllocation", "TokenAllocation", "SpilledAllocation",
           "PoolExhausted", "resolve_kv_dtype", "default_page_bytes",
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


def default_page_bytes(mm: MemoryModel, tokens_per_page: int = 16,
                       batch: int = 1) -> int:
    """Bytes of a page holding ``tokens_per_page`` tokens of dense
    per-token state (all layers kept). A model with only fixed-size state
    has no per-token term: one page then holds one request's state."""
    full = [True] * (2 * mm.n_layers)
    per_tok = mm.state_bytes(full, batch, 1) - mm.state_bytes(full, batch, 0)
    if per_tok <= 0:
        return int(max(mm.state_bytes(full, batch, 0), 1.0))
    return max(int(per_tok * tokens_per_page), 1)


@dataclasses.dataclass(frozen=True)
class PageAllocation:
    """A byte-granular (accounting-only) allocation of the slot path."""
    rid: str
    pages: tuple            # page ids granted (ids >= n_pages: overflow)
    requested_bytes: float  # exact analytical state bytes
    page_bytes: int

    @property
    def reserved_bytes(self) -> float:
        return float(len(self.pages) * self.page_bytes)


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


@dataclasses.dataclass
class SpilledAllocation:
    """A preempted request's host-side allocation record.

    Token-style spills of a physical pool carry the page contents (and,
    for quantized pools, the scale rows) as host tensors; byte-style spills
    carry accounting only — the slot executor owns (and spills) the actual
    cache contents. ``restore`` rebuilds the allocation with the identical
    per-row page count and writes the host copies back bitwise."""
    rid: str
    kind: str                 # "tokens" | "bytes"
    batch: int
    seq_tokens: int
    max_tokens: int
    pages_per_row: int        # granted pages per row at spill time
    requested_bytes: float    # byte-kind ledger charge
    in_use_bytes: float
    in_use_per_token: float
    k_host: Optional[torch.Tensor] = None   # [L, held_pages, pt, K, D]
    v_host: Optional[torch.Tensor] = None
    k_scales_host: Optional[torch.Tensor] = None   # [L, held_pages, K] f32
    v_scales_host: Optional[torch.Tensor] = None


class KVPool:
    """Slot/page-based KV-cache pool over a global byte budget.
    ``tokens_per_page`` is needed by the token-granular (paged) API only."""

    def __init__(self, capacity_bytes: float, *, page_bytes: int,
                 tokens_per_page: Optional[int] = None):
        if page_bytes <= 0:
            raise ValueError("page_bytes must be positive")
        if tokens_per_page is not None and tokens_per_page < 1:
            raise ValueError("tokens_per_page must be >= 1")
        self.page_bytes = int(page_bytes)
        self.n_pages = max(int(capacity_bytes // self.page_bytes), 0)
        self.tokens_per_page = tokens_per_page
        # capacity is page-quantized: a partial tail page is unusable
        self.acct = PoolAccounting(
            capacity_bytes=float(self.n_pages * self.page_bytes))
        self._free: List[int] = list(range(self.n_pages))
        self._live: Dict[str, PageAllocation] = {}
        self._tok: Dict[str, TokenAllocation] = {}
        self._spilled: Dict[str, SpilledAllocation] = {}
        self.spilled_bytes_total = 0.0   # cumulative device bytes spilled
        self._next_overflow_page = self.n_pages  # ids of overcommitted pages
        self._committed_extra = 0   # Σ token allocs (committed − held) pages
        # physical page arrays (allocate_physical): [L, n_pages+1, pt, K, D]
        self.k_pages = None
        self.v_pages = None
        # quantized pools: canonical dtype name + per-page scales
        # ([L, n_pages+1, K] f32; row n_pages scales the scratch page)
        self.kv_dtype: Optional[str] = None
        self.k_scales = None
        self.v_scales = None

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
        override the width; ``"int8"``/``"fp8"`` store quantized pages plus
        per-(page, kv head) f32 scale tensors ``[n_layers, n_pages+1, K]``
        (the scratch page has a scale row too: padded decode rows
        requantize it harmlessly). The ledger's ``in_use_scale`` turns the
        analytical model-width charges into physical bytes. Requires
        ``tokens_per_page``."""
        if self.tokens_per_page is None:
            raise ValueError("allocate_physical requires tokens_per_page")
        name, store_dtype, quantized, _ = resolve_kv_dtype(kv_dtype)
        self.kv_dtype = name
        phys = store_dtype if store_dtype is not None else dtype
        shape = (n_layers, self.n_pages + 1, self.tokens_per_page,
                 n_kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=phys, device=device)
        self.v_pages = torch.zeros(shape, dtype=phys, device=device)
        self.k_scales = self.v_scales = None
        if quantized:
            sshape = (n_layers, self.n_pages + 1, n_kv_heads)
            self.k_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
            self.v_scales = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
        # analytical ledger charges arrive in model-dtype bytes; physical
        # truth per token is page_bytes / tokens_per_page (scales included)
        model_tok = (2 * n_kv_heads * head_dim
                     * torch.empty((), dtype=dtype).element_size() * n_layers)
        if model_tok > 0:
            self.acct.in_use_scale = (
                self.page_bytes / self.tokens_per_page) / model_tok

    # ------------------------------------------------------------- queries
    def pages_needed(self, nbytes: float) -> int:
        nbytes = max(float(nbytes), 0.0)
        return max(int(-(-nbytes // self.page_bytes)), 1)  # ceil, min 1 page

    def can_alloc(self, nbytes: float) -> bool:
        return self.pages_needed(nbytes) <= len(self._free)

    def fits_capacity(self, nbytes: float) -> bool:
        """Could this request EVER fit (empty pool)?"""
        return self.pages_needed(nbytes) <= self.n_pages

    def pages_per_row(self, n_tokens: int) -> int:
        if self.tokens_per_page is None:
            raise ValueError("token-granular API requires tokens_per_page")
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

    @property
    def available_bytes(self) -> float:
        return float(len(self._free) * self.page_bytes)

    # ----------------------------------------------------------- lifecycle
    def alloc(self, rid: str, nbytes: float, *,
              allow_overcommit: bool = False) -> PageAllocation:
        """Byte-granular (accounting-only) allocation of the slot path.

        Under ``allow_overcommit`` the pool pops whatever real pages remain
        and books ids past capacity for the rest: overflow ids have no
        backing and evaporate on ``free`` (they never enter the free list),
        and the ledger records the overcommit."""
        if rid in self._live or rid in self._tok:
            raise ValueError(f"request {rid!r} already holds an allocation")
        need = self.pages_needed(nbytes)
        if not allow_overcommit:
            if need > len(self._free):
                raise PoolExhausted(
                    f"request {rid!r} needs {need} pages ({nbytes:.0f}B), "
                    f"{len(self._free)} free of {self.n_pages} total")
            # ledger check BEFORE popping pages: an overcommit can hold the
            # ledger at capacity while real pages sit free
            if not self.acct.can_reserve(need * self.page_bytes):
                raise PoolExhausted(
                    f"request {rid!r} needs {need * self.page_bytes}B but "
                    f"the ledger has {self.acct.available_bytes:.0f}B "
                    f"headroom (an overcommitted allocation holds the "
                    f"budget past capacity)")
        pages = [self._free.pop() for _ in range(min(need, len(self._free)))]
        while len(pages) < need:
            pages.append(self._next_overflow_page)
            self._next_overflow_page += 1
        alloc = PageAllocation(rid=rid, pages=tuple(pages),
                               requested_bytes=float(max(nbytes, 0.0)),
                               page_bytes=self.page_bytes)
        self.acct.reserve(alloc.reserved_bytes, alloc.requested_bytes,
                          allow_overcommit=allow_overcommit)
        self._live[rid] = alloc
        return alloc

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
        if rid in self._live or rid in self._tok or rid in self._spilled:
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

    def free(self, rid: str, *, missing_ok: bool = False) -> float:
        """Release a request's pages (either kind of allocation); returns
        the reserved bytes returned. Unknown ids raise a ``ValueError``
        naming the id and the live set; ``missing_ok=True`` makes the call
        idempotent, so a cancel racing a completion cannot double-free."""
        if rid in self._tok:
            st = self._tok.pop(rid)
            for row in st.rows:
                self._free.extend(row)
            self._committed_extra -= st.committed_pages - st.held_pages
            self.acct.release(st.reserved_bytes, st.in_use_bytes)
            return st.reserved_bytes
        alloc = self._live.pop(rid, None)
        if alloc is None:
            if missing_ok:
                return 0.0
            raise ValueError(
                f"free({rid!r}): unknown request id; live allocations: "
                f"{sorted([*self._live, *self._tok])}")
        for p in alloc.pages:
            if p < self.n_pages:         # overflow pages evaporate
                self._free.append(p)
        self.acct.release(alloc.reserved_bytes, alloc.requested_bytes)
        return alloc.reserved_bytes

    def live_requests(self) -> List[str]:
        return [*self._live, *self._tok]

    def request_reserved_bytes(self, rid: str) -> float:
        """Device bytes currently reserved by ``rid`` — the bytes a
        preemption of it would free (0.0 for unknown or spilled ids)."""
        st = self._tok.get(rid)
        if st is not None:
            return st.reserved_bytes
        alloc = self._live.get(rid)
        return alloc.reserved_bytes if alloc is not None else 0.0

    # ------------------------------------------------------- spill / restore
    def _gather_pages(self, ids: List[int]):
        """Host copies of the physical pages (and scale rows) backing
        ``ids``. ``Tensor.cpu()`` is a blocking copy: when it returns the
        device pages may be granted and overwritten. Copies of f32, bf16,
        int8 and fp8 pages are exact, which makes spill → restore
        bitwise."""
        idx = (slice(None), torch.tensor(ids, dtype=torch.long,
                                         device=self.k_pages.device))
        k = take_pages(self.k_pages, idx).cpu()
        v = take_pages(self.v_pages, idx).cpu()
        ks = vs = None
        if self.k_scales is not None:
            ks = self.k_scales[idx].cpu()
            vs = self.v_scales[idx].cpu()
        return k, v, ks, vs

    def spill(self, rid: str) -> float:
        """Preempt ``rid``: copy its physical page contents (plus
        quantization scale rows) to a host-side store, return its device
        pages to the free list, and release its commitment and ledger
        charge. Returns the reserved bytes released. Byte-style (slot
        executor) allocations release accounting only — the executor spills
        the cache contents itself. :meth:`restore` rebuilds the allocation
        bitwise; :meth:`drop_spilled` discards it (cancellation)."""
        st = self._tok.pop(rid, None)
        if st is not None:
            ids = [p for row in st.rows for p in row]
            k = v = ks = vs = None
            if self.k_pages is not None and ids:
                k, v, ks, vs = self._gather_pages(ids)
            self._free.extend(ids)
            self._committed_extra -= st.committed_pages - st.held_pages
            self.acct.release(st.reserved_bytes, st.in_use_bytes)
            self._spilled[rid] = SpilledAllocation(
                rid=rid, kind="tokens", batch=st.batch,
                seq_tokens=st.seq_tokens, max_tokens=st.max_tokens,
                pages_per_row=len(st.rows[0]), requested_bytes=0.0,
                in_use_bytes=st.in_use_bytes,
                in_use_per_token=st.in_use_per_token,
                k_host=k, v_host=v, k_scales_host=ks, v_scales_host=vs)
            self.spilled_bytes_total += st.reserved_bytes
            return st.reserved_bytes
        alloc = self._live.pop(rid, None)
        if alloc is None:
            raise ValueError(
                f"spill({rid!r}): unknown request id; live allocations: "
                f"{sorted([*self._live, *self._tok])}")
        for p in alloc.pages:
            if p < self.n_pages:         # overflow pages evaporate
                self._free.append(p)
        self.acct.release(alloc.reserved_bytes, alloc.requested_bytes)
        self._spilled[rid] = SpilledAllocation(
            rid=rid, kind="bytes", batch=0, seq_tokens=0, max_tokens=0,
            pages_per_row=0, requested_bytes=alloc.requested_bytes,
            in_use_bytes=0.0, in_use_per_token=0.0)
        self.spilled_bytes_total += alloc.reserved_bytes
        return alloc.reserved_bytes

    def _spilled_state(self, rid: str, op: str) -> SpilledAllocation:
        sp = self._spilled.get(rid)
        if sp is None:
            raise ValueError(
                f"{op}({rid!r}): unknown request id; spilled requests: "
                f"{sorted(self._spilled)}")
        return sp

    def restore_reserved_bytes(self, rid: str) -> float:
        """Worst-case device bytes a :meth:`restore` of ``rid`` re-takes
        (the admission commitment for token spills, the page-rounded
        request for byte spills) — what the engine's elastic-budget check
        must find headroom for before resuming."""
        sp = self._spilled_state(rid, "restore_reserved_bytes")
        if sp.kind == "bytes":
            return float(self.pages_needed(sp.requested_bytes)
                         * self.page_bytes)
        return float(self.pages_for_tokens(sp.batch, sp.max_tokens)
                     * self.page_bytes)

    def can_restore(self, rid: str) -> bool:
        """Whether the pool physically has the pages (and ledger headroom)
        to restore ``rid`` right now."""
        sp = self._spilled.get(rid)
        if sp is None:
            return False
        if sp.kind == "bytes":
            need = self.pages_needed(sp.requested_bytes)
            return (need <= len(self._free)
                    and self.acct.can_reserve(need * self.page_bytes))
        return (self.pages_for_tokens(sp.batch, sp.max_tokens)
                <= len(self._free) - self._committed_extra)

    def restore(self, rid: str) -> Optional[List[List[int]]]:
        """Re-admit a spilled request: re-grant pages with the identical
        per-row layout, write the host page copies (and scale rows) back
        bitwise, and re-take the admission commitment. Returns the new
        per-row page ids (None for byte-style spills). Raises
        :class:`PoolExhausted` when the pool cannot host it yet — the
        caller retries when capacity frees."""
        sp = self._spilled_state(rid, "restore")
        if sp.kind == "bytes":
            del self._spilled[rid]
            try:
                self.alloc(rid, sp.requested_bytes)
            except Exception:
                self._spilled[rid] = sp      # stay restorable on failure
                raise
            return None
        committed = self.pages_for_tokens(sp.batch, sp.max_tokens)
        if committed > len(self._free) - self._committed_extra:
            raise PoolExhausted(
                f"restore({rid!r}) commits {committed} pages, "
                f"{len(self._free) - self._committed_extra} admissible "
                f"({len(self._free)} free − {self._committed_extra} "
                f"committed) of {self.n_pages} total")
        rows = [[self._free.pop() for _ in range(sp.pages_per_row)]
                for _ in range(sp.batch)]
        if self.k_pages is not None and sp.pages_per_row:
            dev = self.k_pages.device
            idx = (slice(None),
                   torch.tensor([p for row in rows for p in row],
                                dtype=torch.long, device=dev))
            put_pages(self.k_pages, idx, sp.k_host.to(dev))
            put_pages(self.v_pages, idx, sp.v_host.to(dev))
            if self.k_scales is not None:
                self.k_scales[idx] = sp.k_scales_host.to(dev)
                self.v_scales[idx] = sp.v_scales_host.to(dev)
        st = TokenAllocation(
            rid=rid, batch=sp.batch, seq_tokens=sp.seq_tokens,
            max_tokens=sp.max_tokens, rows=rows, page_bytes=self.page_bytes,
            tokens_per_page=self.tokens_per_page,
            in_use_bytes=sp.in_use_bytes,
            in_use_per_token=sp.in_use_per_token)
        self._committed_extra += committed - st.held_pages
        self.acct.grow(st.reserved_bytes, st.in_use_bytes)
        self._tok[rid] = st
        del self._spilled[rid]
        return [list(r) for r in rows]

    def drop_spilled(self, rid: str, *, missing_ok: bool = False) -> bool:
        """Discard a spilled request's host copy (cancellation while
        preempted). Idempotent under ``missing_ok``, mirroring
        :meth:`free`."""
        if self._spilled.pop(rid, None) is None:
            if missing_ok:
                return False
            raise ValueError(
                f"drop_spilled({rid!r}): unknown request id; spilled "
                f"requests: {sorted(self._spilled)}")
        return True

    def spilled_requests(self) -> List[str]:
        return list(self._spilled)

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        return {
            "capacity_bytes": self.acct.capacity_bytes,
            "page_bytes": float(self.page_bytes),
            "n_pages": float(self.n_pages),
            "free_pages": float(len(self._free)),
            "committed_pages": float(self._committed_extra),
            "live_requests": float(len(self._live) + len(self._tok)),
            "reserved_bytes": self.acct.reserved_bytes,
            "in_use_bytes": self.acct.in_use_bytes,
            "peak_reserved_bytes": self.acct.peak_reserved_bytes,
            "peak_in_use_bytes": self.acct.peak_in_use_bytes,
            "occupancy": self.acct.occupancy(),
            "fragmentation": self.acct.fragmentation(),
            "overcommit_events": float(self.acct.overcommit_events),
            "in_use_scale": float(self.acct.in_use_scale),
            "spilled_requests": float(len(self._spilled)),
            "spilled_bytes_total": float(self.spilled_bytes_total),
        }
