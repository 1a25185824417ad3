"""Block-paged continuous batching (counterpart of mingunivision_tpu/engine/paged.py).

KV lives in fixed-size PAGES owned by a host-side allocator; a slot addresses
its pages through a block table, pages are allocated as the sequence grows
and returned when the request finishes, so pool memory follows the tokens in
flight rather than slots * max_len.

  - The pool is (L, Hkv, P+1, page, D), head-major. Page P is SCRATCH: the
    per-step write of an inactive row lands there, so no write touches a live
    page; unassigned table entries point there and are never read (the
    attention reads only entries below ceil(length / page)).
  - Attention reads the pages through the table with the paged
    decode-attention kernel (ops/kernels/paged_attention.py).
  - The block table is a host int32 array; its device copy is re-sent only
    when the table changes.
  - Page exhaustion STALLS a slot (its active bit drops, its pages stay) until
    another request frees pages.
  - `prefix_cache=True` content-addresses full prompt pages by token-chain
    digest; a request whose prefix is cached shares those pages (refcounted,
    never rewritten) and prefills only the suffix.

The pool and the slot state are updated IN PLACE; a step reads back only its
sampled tokens. With enough pages the paged engine gives the dense engine's
tokens for the same requests and seed.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from mingunivision_tpu_torch.engine.batch_engine import (
    PREFILL_BUCKET,
    ContinuousBatchingEngine,
    Request,
    SamplingState,
    _sample_and_advance,
    pooled_layers,
)
from mingunivision_tpu_torch.engine.generate import prefill
from mingunivision_tpu_torch.engine.sampler import sample_token
from mingunivision_tpu_torch.models.bailing_moe import LLMCache, embed_tokens
from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_decode_attention


@dataclasses.dataclass
class PagedKVState:
    k_pages: torch.Tensor  # (L, Hkv, P+1, page, D); page P is scratch
    v_pages: torch.Tensor
    lengths: torch.Tensor  # (B,) int64 tokens in cache per slot
    cur: torch.Tensor  # (B,) int64 next token to feed
    active: torch.Tensor  # (B,) bool
    sampling: SamplingState

    @classmethod
    def create(cls, cfg, slots: int, num_pages: int, page_size: int, dtype=torch.bfloat16,
               device=None) -> "PagedKVState":
        shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, num_pages + 1, page_size, cfg.head_dim)
        zeros = lambda dt: torch.zeros(slots, dtype=dt, device=device)  # noqa: E731
        return cls(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device),
                   zeros(torch.long), zeros(torch.long), zeros(torch.bool), SamplingState.create(slots, device))


def paged_decode_step(params, cfg, state: PagedKVState, tables, generator: Optional[torch.Generator] = None,
                      int_dots: bool = True, prefill_int_dots: bool = False):
    """One decode step for every slot over the paged pool, IN PLACE.

    tables (B, maxp) int32 on the device: the host-kept block tables (scratch
    id for unassigned entries). Per-slot sampling and <eos> / <image>
    detection as `batched_decode_step`; inactive rows compute but write only
    the scratch page; int_dots / prefill_int_dots: the MoE's dot modes. Returns the
    sampled tokens (B,), -1 for inactive."""
    B = state.cur.shape[0]
    D = cfg.head_dim
    page = state.k_pages.shape[3]
    scratch = state.k_pages.shape[2] - 1
    rows = torch.arange(B, device=state.cur.device)
    write_pos = state.lengths  # the position of the token fed this step
    page_idx = torch.where(state.active, tables[rows, write_pos // page].long(), torch.full_like(write_pos, scratch))
    off = write_pos % page
    attn_len = (state.lengths + state.active.long()).int()  # attention sees the just-written token
    heads = torch.arange(cfg.num_key_value_heads, device=rows.device)[None, :]

    def attend(l, q, kn, vn):
        kc, vc = state.k_pages[l], state.v_pages[l]  # (Hkv, P+1, page, D)
        kc[heads, page_idx[:, None], off[:, None]] = kn[:, 0].to(kc.dtype)
        vc[heads, page_idx[:, None], off[:, None]] = vn[:, 0].to(vc.dtype)
        return paged_decode_attention(q, kc, vc, tables, attn_len, scale=D**-0.5)

    x = embed_tokens(params, state.cur[:, None]).to(state.k_pages.dtype)
    h = pooled_layers(params, cfg, x, write_pos[:, None], attend, int_dots, prefill_int_dots)
    return _sample_and_advance(params, cfg, state, h, generator)


def _page_chunks(cache_kv, page: int):
    """A one-row dense cache (L, 1, Hkv, Smax, D) as (L, Hkv, Smax / page, page, D) chunks (a view)."""
    L, _, Hkv, S, D = cache_kv.shape
    return cache_kv[:, 0].reshape(L, Hkv, S // page, page, D)


def _admit_pages(k_pages, v_pages, cache_k, cache_v, chunk_ids, page_ids):
    """Copy chunks `chunk_ids` of a prefilled one-row dense cache into pages
    `page_ids` of the pool, IN PLACE (the newly computed chunks only: a shared
    prefix page is never rewritten)."""
    if not page_ids:
        return
    dev = k_pages.device
    chunks = torch.as_tensor(chunk_ids, device=dev)
    pids = torch.as_tensor(page_ids, device=dev)
    page = k_pages.shape[3]
    for pages, cache in ((k_pages, cache_k), (v_pages, cache_v)):
        pages[:, :, pids] = _page_chunks(cache, page)[:, :, chunks].to(pages.dtype)


def _gather_pages(cache_k, cache_v, k_pages, v_pages, page_ids):
    """Inverse of `_admit_pages` for a prefix hit: pages `page_ids` into the
    first len(page_ids) chunks of a one-row dense cache, IN PLACE (the cached
    prefix seeds the cache the suffix prefill appends to)."""
    n = len(page_ids)
    pids = torch.as_tensor(page_ids, device=k_pages.device)
    page = k_pages.shape[3]
    for pages, cache in ((k_pages, cache_k), (v_pages, cache_v)):
        _page_chunks(cache, page)[:, :, :n] = pages[:, :, pids].to(cache.dtype)


class PageAllocator:
    """Host free-list over the page pool (page ids 0..P-1; P is scratch)."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(num_pages - 1, -1, -1))

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self.free):
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: List[int]):
        self.free.extend(pages)

    @property
    def available(self) -> int:
        return len(self.free)


class PrefixPageCache:
    """Content-addressed registry of full prompt pages (automatic prefix caching).

    A full page is identified by the sha256 CHAIN digest of every token id from
    position 0 through the page's end (its K/V depend on the whole prefix).
    Pages whose refcount drops to 0 are kept in LRU order and evicted only
    when the allocator runs dry."""

    def __init__(self):
        self.hash_to_page: Dict[bytes, int] = {}
        self.page_hash: Dict[int, bytes] = {}
        self.ref: Dict[int, int] = {}
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # refcount-0 registered pages, oldest first

    @staticmethod
    def chain_hashes(ids: np.ndarray, page: int, salt: bytes = b"") -> List[bytes]:
        """One digest per FULL page of the prompt (a partial tail page keeps growing)."""
        hs: List[bytes] = []
        h = salt
        for i in range(len(ids) // page):
            h = hashlib.sha256(h + np.asarray(ids[i * page : (i + 1) * page], np.int64).tobytes()).digest()
            hs.append(h)
        return hs

    def lookup(self, h: bytes) -> Optional[int]:
        return self.hash_to_page.get(h)

    def pin(self, pid: int):
        self.lru.pop(pid, None)
        self.ref[pid] = self.ref.get(pid, 0) + 1

    def unpin(self, pid: int):
        self.ref[pid] -= 1
        if self.ref[pid] == 0:
            self.lru[pid] = None  # reclaimable, kept until pressure

    def register(self, h: bytes, pid: int) -> bool:
        """Map h -> pid (refcount 0; the caller pins). False if another page
        already holds this hash."""
        if h in self.hash_to_page:
            return False
        self.hash_to_page[h] = pid
        self.page_hash[pid] = h
        self.ref[pid] = self.ref.get(pid, 0)
        return True

    def evict_one(self) -> Optional[int]:
        """Drop the oldest refcount-0 cached page; returns its id (now free)."""
        if not self.lru:
            return None
        pid, _ = self.lru.popitem(last=False)
        del self.hash_to_page[self.page_hash.pop(pid)]
        del self.ref[pid]
        return pid

    @property
    def cached_pages(self) -> int:
        return len(self.page_hash)


class PagedBatchingEngine(ContinuousBatchingEngine):
    """ContinuousBatchingEngine over block-paged KV (the same host interface).

    `num_pages * page_size` is the pool's token budget, shared by all slots. A
    slot that needs a page when the pool is exhausted STALLS and resumes when
    pages free up. `prefix_cache=True` shares full prompt pages between
    requests with the same prefix and prefills only the suffix; shared pages
    are never written (decode writes land at positions >= T, past the last
    shared full page)."""

    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 1024, page_size: int = 64,
                 num_pages: Optional[int] = None, dtype=torch.bfloat16, seed: int = 0, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0, prefix_cache: bool = False,
                 device=None, int_dots: bool = True, prefill_int_dots: bool = False):
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        self._setup(params, cfg, slots, max_len, dtype, seed, device,
                    dict(do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p), int_dots,
                    prefill_int_dots)
        self.page = page_size
        self.maxp = max_len // page_size
        # default budget: half the dense pool's reservation
        self.num_pages = int(num_pages) if num_pages is not None else max(self.maxp, slots * self.maxp // 2)
        self.scratch_pid = self.num_pages
        self.state = PagedKVState.create(cfg, slots, self.num_pages, page_size, dtype, self.device)
        self.allocator = PageAllocator(self.num_pages)
        self.tables = np.full((slots, self.maxp), self.scratch_pid, np.int32)
        self._tables_dev = None  # the device copy, re-sent only when the host table changes
        self._tables_dirty = True
        self.slot_pages: Dict[int, List[int]] = {}
        self.slot_lengths: Dict[int, int] = {}  # host mirror of lengths
        self.stalled: Dict[int, bool] = {}
        self.prefix = PrefixPageCache() if prefix_cache else None
        self.prefix_hit_tokens = 0  # prompt tokens whose prefill was skipped
        self.prefix_miss_tokens = 0  # prompt tokens prefilled
        self.stalls = 0  # times a slot stalled on an exhausted pool

    # -- admission ----------------------------------------------------------

    def _alloc(self, n: int) -> Optional[List[int]]:
        """allocator.alloc with prefix-cache eviction under pressure (LRU
        first). Evicts NOTHING when even the whole LRU would not be enough."""
        evictable = len(self.prefix.lru) if self.prefix is not None else 0
        if n > self.allocator.available + evictable:
            return None
        while self.allocator.available < n and self.prefix is not None:
            pid = self.prefix.evict_one()
            if pid is None:
                break
            self.allocator.release([pid])
        return self.allocator.alloc(n)

    def _release_pages(self, pages: List[int]):
        """Registered pages are unpinned into the prefix cache's LRU; the others
        go straight back to the free list."""
        for pid in pages:
            if self.prefix is not None and pid in self.prefix.page_hash:
                self.prefix.unpin(pid)
            else:
                self.allocator.release([pid])

    def _free_slot(self) -> Optional[int]:
        for b in range(self.slots):
            if b not in self.slot_req:
                return b
        return None

    def add_request(self, input_ids, max_new_tokens: int = 128, *, do_sample: Optional[bool] = None,
                    temperature: Optional[float] = None, top_k: Optional[int] = None,
                    top_p: Optional[float] = None) -> Optional[Request]:
        """Admit a request. None if no slot is free OR the prompt's pages cannot
        be allocated now (the caller retries after other requests finish)."""
        slot = self._free_slot()
        if slot is None:
            return None
        ids = np.asarray(input_ids).reshape(-1)
        T = len(ids)
        self._check_request(T, max_new_tokens)
        n_pages = (T + 1 + self.page - 1) // self.page  # covers the first decode write

        # the longest run of cached full pages, capped so at least one prompt
        # token is recomputed (the sampler needs the last position's logits)
        hashes: List[bytes] = []
        hit_pages: List[int] = []
        if self.prefix is not None:
            hashes = self.prefix.chain_hashes(ids, self.page)
            for h in hashes[: (T - 1) // self.page]:
                pid = self.prefix.lookup(h)
                if pid is None:
                    break
                hit_pages.append(pid)
        n_hit = len(hit_pages)
        for pid in hit_pages:  # pin BEFORE allocating so eviction cannot take them
            self.prefix.pin(pid)
        pages = self._alloc(n_pages - n_hit)
        if pages is None:
            for pid in hit_pages:
                self.prefix.unpin(pid)
            return None
        req, req_sampling = self._new_request(ids, max_new_tokens, dict(do_sample=do_sample, temperature=temperature,
                                                                          top_k=top_k, top_p=top_p))

        # bucketed one-row dense prefill, then the page copy. On a prefix hit the
        # hit pages seed the dense cache (length Tc) and only the suffix is
        # prefilled, at positions [Tc, T); its padded bucket is capped to fit.
        Tc = n_hit * self.page
        Ts = T - Tc
        Tb = min(self.max_len - Tc, -(-Ts // PREFILL_BUCKET) * PREFILL_BUCKET)
        cache1 = LLMCache.create(self.cfg, 1, self.max_len, self.dtype, self.device)
        if n_hit:
            _gather_pages(cache1.k, cache1.v, self.state.k_pages, self.state.v_pages, hit_pages)
            cache1.length = Tc
        mask1 = torch.zeros((1, self.max_len), dtype=torch.bool, device=self.device)
        mask1[:, :T] = True
        logits, cache1 = prefill(self.params, self.cfg, self._embed_padded(ids, Tc, Tb), cache1, mask1,
                                 int_dots=self.int_dots, prefill_int_dots=self.prefill_int_dots)
        first = int(sample_token(logits, self.generator, **req_sampling)[0])
        self.prefix_hit_tokens += Tc
        self.prefix_miss_tokens += Ts
        _admit_pages(self.state.k_pages, self.state.v_pages, cache1.k, cache1.v,
                     list(range(n_hit, n_hit + len(pages))), pages)

        st = self.state
        st.sampling.set_slot(slot, **req_sampling)
        st.lengths[slot] = T
        st.cur[slot] = first
        st.active[slot] = True
        self.tables[slot, : n_hit + len(pages)] = hit_pages + pages
        self._tables_dirty = True
        self.slot_pages[slot] = hit_pages + pages
        if self.prefix is not None:
            # content-address the freshly computed full prompt pages
            for i in range(n_hit, len(hashes)):
                pid = int(self.tables[slot, i])
                if self.prefix.register(hashes[i], pid):
                    self.prefix.pin(pid)
        self.slot_lengths[slot] = T
        self.stalled[slot] = False
        req.tokens.append(first)
        self.slot_req[slot] = req
        self.slot_budget[slot] = max_new_tokens - 1
        if first in (self.cfg.eos_token_id, self.cfg.image_start_token):
            self._finish(slot)
        return req

    def _finish(self, slot: int):
        req = self.slot_req.pop(slot, None)
        if req is not None:
            req.done = True
        self.slot_budget.pop(slot, None)
        self._release_pages(self.slot_pages.pop(slot, []))
        self.tables[slot] = self.scratch_pid
        self._tables_dirty = True
        self.slot_lengths.pop(slot, None)
        self.stalled.pop(slot, None)
        self.state.active[slot] = False

    # -- stepping -------------------------------------------------------------

    def _ensure_pages(self):
        """Lazy growth: every running slot must own the page its next write
        lands in. Exhaustion stalls the slot; freed pages resume it."""
        for slot in list(self.slot_req):
            pos = self.slot_lengths[slot]  # the next write position
            owned = len(self.slot_pages[slot])
            if pos // self.page + 1 > owned:
                got = self._alloc(pos // self.page + 1 - owned)
                if got is None:
                    if not self.stalled[slot]:
                        self.stalled[slot] = True
                        self.stalls += 1
                        self.state.active[slot] = False
                    continue
                self.tables[slot, owned : owned + len(got)] = got
                self._tables_dirty = True
                self.slot_pages[slot].extend(got)
            if self.stalled[slot]:
                self.stalled[slot] = False
                self.state.active[slot] = True

    def _grew(self, slot: int):
        self.slot_lengths[slot] += 1

    def step(self) -> Dict[int, int]:
        """Advance all runnable slots one token. Returns {request_id: token}."""
        if not self.slot_req:
            return {}
        self._ensure_pages()
        if all(self.stalled[s] for s in self.slot_req):
            return {}  # everything stalled on pages: the caller must finish or cancel
        if self._tables_dirty or self._tables_dev is None:
            self._tables_dev = torch.as_tensor(self.tables, device=self.device)
            self._tables_dirty = False
        toks = paged_decode_step(self.params, self.cfg, self.state, self._tables_dev, self.generator, self.int_dots,
                                 self.prefill_int_dots)
        return self._collect(toks.cpu().numpy())

    def run_to_completion(self, max_steps: int = 10_000) -> int:
        steps = 0
        while self.slot_req and steps < max_steps:
            out = self.step()
            steps += 1
            if not out and all(self.stalled.get(s, False) for s in self.slot_req):
                break  # deadlocked on pages with nothing finishing
        return steps
