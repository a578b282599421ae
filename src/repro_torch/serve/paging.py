"""Host-side block-table allocator for the paged KV cache (vLLM-style), with
**refcounted prefix sharing**, copy-on-write forking, and a **persistent pinned
prefix cache**.

The device holds one physical page pool per attention layer, shaped
``(num_pages, page_size, kv_heads, head_dim)``; this module owns the *mapping*:
which physical pages belong to which decode slot, in logical order. The device
side never sees the free list — only the dense ``(num_slots, max_pages_per_slot)``
block table produced by :meth:`PageAllocator.table`.

Ownership is **refcounted**: a physical page may appear in several slots' block
tables at once when those slots share a prompt prefix. A host-side **prefix
index** maps chains of *full pages of prompt token ids* to the physical page
already holding their K/V: admission walks the new prompt's pages through the
index and adopts every hit with ``refcount++`` instead of reserving and
re-prefilling it (``adopt``). K/V at a position is a pure function of the token
prefix for text-only stacks, so adopted pages are bitwise what the request's
own prefill would have written — the caller gates sharing to such configs. The
index is keyed by (interned chain-prefix id, full page token tuple) — content
equality, not hashing — so a chain hit can never be a collision.

A shared page is immutable to its adopters, with one exception: a write whose
value is bitwise identical to what the page already holds (the engine's
no-write full-last-page adoption) is indistinguishable from no write at all.
When a slot must write *divergent* data into one — the unshared tail of its
prompt starts mid-page after a partial-page hit — it **copy-on-write forks** it
first (``cow_fork``): a fresh page replaces the shared one in this slot's
chain, the shared page's refcount drops, and the caller copies the shared
prefix entries on device before writing. A fork target never aliases a
still-shared page.

**Pinned prefix cache** (``pin_pages > 0``): the prefix index is a *cache*, not
just a rendezvous for concurrently-live requests. When an indexed page's
refcount hits zero it is not freed — it is *pinned*: kept resident and indexed,
charged to the ``pin_pages`` budget, so a returning tenant minutes later adopts
the chain exactly like a live shared one and re-prefills only its unique
suffix. Eviction is **immune-memory-weighted LRU**: each page is tagged with
the request class that last touched it, a per-class :class:`~repro_torch.core.immune.
ImmuneMemory` EMA tracks how many pages each class's admissions actually adopt
(its remembered prefix value), and under pressure the evictable pinned page
with the lowest ``(class value, last-use stamp)`` goes first. Only chain
*leaves* (no indexed children) are evictable, so eviction never strands a
reachable chain. Pressure comes from two places: the pin budget itself
(pinning a hotter page may evict a strictly colder one) and the free list
(``_take_page`` evicts pinned pages before giving up).

Layout invariants (the hypothesis suite in ``tests/test_torch_paging.py`` churns these):

  * page 0 is the **null page**: never allocated, permanently parked. Unmapped
    block-table entries point at it, and the decode step routes the writes of
    inactive slots there, so it doubles as the trash page. Reads of it are
    always masked, so its contents are irrelevant as long as they stay finite.
  * ``sum(refcounts) == total live block-table entries`` — every owner of a
    page is counted, and nothing else is. Pinned pages have refcount zero and
    appear in no block table.
  * no page is ever simultaneously on the free list and refcounted, or on the
    free list and pinned. A page whose refcount hits zero is either pinned
    (indexed, budget permitting, chain reachable) or freed immediately and
    dropped from the prefix index — index entries only ever point at live or
    pinned pages, and every indexed page's parent chain is live or pinned.
  * ``free + pinned + distinct live pages == num_pages - 1`` (conservation,
    null page excluded — a shared page counts once, which is the memory win).
  * ``available()`` counts free *and* pinned pages (pinned pages are
    reclaimable on demand) net of reservations, and never goes negative.

Two admission disciplines share this allocator:

  * **reservation** (``require_reservation=True``): admission promises a
    request's private worst case up front (``reserve``), pages are appended
    lazily (``ensure``), and growing past the reservation is a bug. A slot can
    never stall mid-decode — the classic no-deadlock guarantee, paid for in
    admission pessimism.
  * **preemption** (``require_reservation=False``): no promises — ``ensure``
    and ``cow_fork`` draw pages on demand and raise :class:`OutOfPages` when
    the pool (free + evictable pinned) is exhausted. The engine resolves the
    stall by preempting a low-priority slot and replaying it later; the
    allocator only reports the pressure.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import immune

NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """No free page and no evictable pinned page — the caller must preempt
    (or defer) to make progress. Only raised under ``require_reservation=False``;
    a reservation-mode allocator that hits this has broken its accounting."""


def pages_for(tokens: int, page_size: int) -> int:
    """Physical pages needed to hold ``tokens`` cache positions."""
    return -(-tokens // page_size)


class PageAllocator:
    """Refcounted free-list page allocator with per-slot reservations, a
    prefix-sharing index, and an optional pinned prefix cache.

    ``num_pages`` counts the null page, so ``num_pages - 1`` pages are usable.
    ``share_prefix=False`` disables the index (every page single-owner, the
    pre-sharing behavior) without changing any other semantics; ``pin_pages``
    (which requires the index) sets the persistent-cache budget, 0 restoring
    free-on-zero exactly.
    """

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 max_pages_per_slot: int, share_prefix: bool = True,
                 pin_pages: int = 0, num_classes: int = 1,
                 pin_decay: float = 0.8, require_reservation: bool = True):
        if num_pages < 2:
            raise ValueError("need at least one usable page beyond the null page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_pages_per_slot = max_pages_per_slot
        self.share_prefix = share_prefix
        self.pin_pages = min(pin_pages, num_pages - 1) if share_prefix else 0
        self.num_classes = max(1, num_classes)
        self.require_reservation = require_reservation
        # pop() order is ascending page id — cosmetic, but makes traces readable
        self._free = list(range(num_pages - 1, NULL_PAGE, -1))
        self._owned: list[list[int]] = [[] for _ in range(num_slots)]
        self._reserved = np.zeros(num_slots, np.int64)
        self._ref = np.zeros(num_pages, np.int64)
        # prefix index: a page holding the i-th full page of a prompt is keyed
        # by (chain node id of pages 0..i-1, its own page_size token ids).
        # Node ids *intern* chain prefixes — one id per distinct content path,
        # assigned at registration — so a hit is still full-content equality
        # (never a hash collision), but each dict access hashes O(page_size)
        # instead of rehashing the whole nested prefix: index walks stay
        # linear in the prompt length. Node id 0 is the empty chain.
        self._index: dict[tuple, tuple] = {}    # (parent id, pt) -> (node, page)
        # partial-match candidates, bucketed by (parent node, first token) so
        # a busy divergence point (e.g. many distinct prompts under the root)
        # never costs a linear scan over all its children
        self._children: dict[tuple, set] = {}
        self._page_key: dict[int, tuple] = {}   # page id -> its index key
        # node id -> set of indexed child pages; a chain page is an evictable
        # *leaf* iff this set is empty for its node
        self._node_kids: dict[int, set] = {}
        self._next_node = 1
        # pinned cache state: refcount-zero indexed pages kept resident.
        self._pinned: set[int] = set()
        self._last_use = np.zeros(num_pages, np.int64)     # LRU stamps
        self._page_class = np.zeros(num_pages, np.int64)   # last adopter class
        self._clock = 0
        # per-class remembered prefix value: EMA of pages adopted per admission
        # — the immune-memory weight in the eviction score
        # on the CPU: the host-side eviction score reads it every admission
        self.pin_memory = immune.ImmuneMemory.create((self.num_classes,),
                                                     decay=pin_decay,
                                                     device="cpu")
        self._class_w = self.pin_memory.value.numpy()
        self.high_water = 0
        self.cow_forks = 0
        self.pins = 0            # refcount-zero pages retained in the cache
        self.pinned_hits = 0     # pinned pages revived by adoption
        self.evictions = 0       # pinned pages dropped (budget or pool pressure)

    # -- accounting ----------------------------------------------------------
    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def pages_in_use(self) -> int:
        """Resident pages: refcounted by a slot or pinned in the cache."""
        return self.usable_pages - len(self._free)

    @property
    def pages_pinned(self) -> int:
        return len(self._pinned)

    def owned(self, slot: int) -> list[int]:
        return list(self._owned[slot])

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def is_pinned(self, page: int) -> bool:
        return page in self._pinned

    def is_indexed(self, page: int) -> bool:
        """Does the prefix index hold ``page`` (a registered prompt page)?"""
        return page in self._page_key

    def live_refs(self) -> int:
        """Sum of all refcounts == total block-table entries across slots."""
        return int(self._ref.sum())

    def available(self) -> int:
        """Pages acquirable on demand: free or pinned (pinned pages are
        reclaimable cache, evicted under pressure), net of reservations."""
        return len(self._free) + len(self._pinned) - int(self._reserved.sum())

    def can_admit(self, need_pages: int) -> bool:
        """``need_pages`` is the request's *private* page count — full-page
        prefix hits ride on adopted refcounts and are not charged here."""
        return need_pages <= min(self.available(), self.max_pages_per_slot)

    def pinned_among(self, pages) -> int:
        """How many of ``pages`` are currently pinned. Adoption of a pinned
        page consumes reclaimable capacity, so admission must net these out of
        :meth:`available` before charging a request."""
        return sum(1 for p in pages if p in self._pinned)

    # -- prefix index --------------------------------------------------------
    @staticmethod
    def _page_tokens(tokens, i: int, page_size: int) -> tuple:
        return tuple(int(t) for t in tokens[i * page_size:(i + 1) * page_size])

    def match_prefix(self, tokens) -> tuple[list, Optional[tuple]]:
        """Walk ``tokens``'s full pages through the index.

        Returns ``(full_hits, partial)``: ``full_hits`` are the physical pages
        holding the longest indexed chain of full prompt pages; ``partial`` is
        ``(page, r)`` when a child page of that chain additionally matches the
        next ``r`` (< page_size) prompt tokens — adoptable, but the adopter
        must ``cow_fork`` it before writing position ``r`` or beyond. The last
        prompt token is never matched (capped at ``len(tokens) - 1``): the
        caller always recomputes it to produce the first logits. Hits may be
        live (shared with a resident slot) or pinned (cache)."""
        if not self.share_prefix:
            return [], None
        ps = self.page_size
        limit = len(tokens) - 1
        full: list[int] = []
        parent = 0
        while (len(full) + 1) * ps <= limit:
            pt = self._page_tokens(tokens, len(full), ps)
            hit = self._index.get((parent, pt))
            if hit is None:
                break
            parent, pid = hit
            full.append(pid)
        partial = None
        rem = tuple(int(t) for t in tokens[len(full) * ps:limit])
        if rem:
            best, best_r = None, 0
            for pid in self._children.get((parent, rem[0]), ()):
                _, pt = self._page_key[pid]
                r = 0
                for a, b in zip(pt, rem):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best, best_r = pid, r
            if best is not None:
                partial = (best, best_r)
        return full, partial

    def register_prefix(self, slot: int, tokens, rclass: int = 0) -> int:
        """Index ``slot``'s full prompt pages so later admissions can adopt
        them. Call once the pages' K/V is fully resident (prefill complete);
        only pages entirely covered by the prompt are registrable — they are
        never written again (decode writes land at positions >= len(tokens)).
        Pages already indexed (adopted from a donor, or a concurrent duplicate)
        are left alone. Returns the number of pages newly indexed."""
        if not self.share_prefix:
            return 0
        ps = self.page_size
        parent = 0
        n = 0
        self._clock += 1
        for i in range(len(tokens) // ps):
            pt = self._page_tokens(tokens, i, ps)
            pid = self._owned[slot][i]
            hit = self._index.get((parent, pt))
            if hit is not None:
                if hit[1] != pid:
                    # a concurrent duplicate's chain: this slot holds no ref
                    # on its pages, so none of ours may hang below them (a
                    # drop of that chain would cascade into our live pages)
                    break
                parent = hit[0]       # adopted page: keep walking the chain
                continue
            if pid in self._page_key:
                break                 # page busy under another chain: stop
            node = self._next_node
            self._next_node += 1
            self._index[(parent, pt)] = (node, pid)
            self._children.setdefault((parent, pt[0]), set()).add(pid)
            self._node_kids.setdefault(parent, set()).add(pid)
            self._page_key[pid] = (parent, pt)
            self._page_class[pid] = self._rc(rclass)
            self._last_use[pid] = self._clock
            parent = node
            n += 1
        return n

    def _unindex(self, page: int) -> None:
        # a chain node dies with its page; its children are always unindexed
        # first (_drop_chain cascades into pinned kids, and live kids refcount
        # their ancestors), so no dangling parent links survive
        key = self._page_key.pop(page, None)
        if key is not None:
            node, _ = self._index.pop(key)
            self._node_kids.pop(node, None)
            parent = key[0]
            kids = self._node_kids.get(parent)
            if kids is not None:
                kids.discard(page)
                if not kids:
                    del self._node_kids[parent]
            bucket = (key[0], key[1][0])
            kids = self._children.get(bucket)
            if kids is not None:
                kids.discard(page)
                if not kids:
                    del self._children[bucket]

    # -- pinned cache --------------------------------------------------------
    def _rc(self, rclass: int) -> int:
        return min(max(int(rclass), 0), self.num_classes - 1)

    def _note_adoption(self, rclass: int, npages: int) -> None:
        # EMA update for one class, identity for the rest: decay*v + (1-d)*v
        obs = self.pin_memory.value.clone()
        obs[self._rc(rclass)] = float(npages)
        self.pin_memory = self.pin_memory.update(obs)
        self._class_w = self.pin_memory.value.numpy()

    def _score(self, page: int) -> tuple:
        """Eviction ordering: coldest class first, then least recently used."""
        return (float(self._class_w[self._page_class[page]]),
                int(self._last_use[page]), page)

    def _coldest_evictable(self) -> Optional[int]:
        best = None
        for p in self._pinned:
            node = self._index[self._page_key[p]][0]
            if self._node_kids.get(node):
                continue              # not a leaf: eviction would strand kids
            if best is None or self._score(p) < self._score(best):
                best = p
        return best

    def _drop_chain(self, page: int) -> None:
        """Free a refcount-zero page. Pinned descendants are evicted first —
        a live descendant is impossible (every owner of a child page also
        refcounts its ancestors), so the cascade only ever touches cache."""
        key = self._page_key.get(page)
        if key is not None:
            node = self._index[key][0]
            for kid in list(self._node_kids.get(node, ())):
                self._drop_chain(kid)
        if page in self._pinned:
            self._pinned.discard(page)
            self.evictions += 1
        self._unindex(page)
        self._free.append(page)

    def _try_pin(self, page: int) -> bool:
        """Retain a refcount-zero indexed page in the cache. At budget, a
        strictly colder evictable pinned page makes room; otherwise the pin is
        refused (no thrash on ties)."""
        if self.pin_pages <= 0:
            return False
        if len(self._pinned) >= self.pin_pages:
            v = self._coldest_evictable()
            if v is None or not self._score(v) < self._score(page):
                return False
            self._drop_chain(v)
        self._pinned.add(page)
        self.pins += 1
        return True

    def _take_page(self) -> int:
        """Pop a free page, evicting the coldest pinned leaf if none is free."""
        if not self._free:
            v = self._coldest_evictable()
            if v is None:
                raise OutOfPages(
                    f"no free or evictable page ({self.pages_in_use}/"
                    f"{self.usable_pages} in use, {len(self._pinned)} pinned)")
            self._drop_chain(v)
        return self._free.pop()

    # -- lifecycle -----------------------------------------------------------
    def reserve(self, slot: int, need_pages: int) -> None:
        """Promise ``need_pages`` *private* pages to ``slot`` (its worst case
        net of full-page prefix hits); call at admission, after ``adopt`` so
        revived pinned pages are already netted out of :meth:`available`."""
        if self._reserved[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        if not self.can_admit(need_pages):
            raise RuntimeError(f"reserve({slot}, {need_pages}) exceeds "
                               f"available {self.available()}")
        self._reserved[slot] = need_pages

    def adopt(self, slot: int, pages, rclass: int = 0) -> None:
        """Append already-resident ``pages`` to ``slot``'s chain with
        refcount++ — the prefix-sharing admission path. Hits may be live
        (shared with a resident slot) or pinned (revived from the cache);
        free pages are not adoptable. Tags the pages with the adopter's class
        and feeds the per-class prefix-value EMA."""
        rc = self._rc(rclass)
        self._clock += 1
        for p in pages:
            if p == NULL_PAGE:
                raise RuntimeError(f"adopt({slot}, {p}): null page")
            if self._ref[p] <= 0:
                if p not in self._pinned:
                    raise RuntimeError(f"adopt({slot}, {p}): page is not live")
                self._pinned.discard(p)
                self.pinned_hits += 1
            self._ref[p] += 1
            self._owned[slot].append(p)
            self._page_class[p] = rc
            self._last_use[p] = self._clock
        if pages:
            self._note_adoption(rc, len(pages))

    def ensure(self, slot: int, npages: int) -> None:
        """Grow ``slot`` to at least ``npages`` logical pages (adopted pages
        count toward the total). Called before a prefill chunk lands or a
        decode write crosses a page boundary. Under reservation discipline the
        growth must be covered by the slot's reservation; under preemption it
        draws freely and raises :class:`OutOfPages` on exhaustion."""
        if npages > self.max_pages_per_slot:
            raise RuntimeError(f"slot {slot}: {npages} pages exceeds "
                               f"max_pages_per_slot {self.max_pages_per_slot}")
        while len(self._owned[slot]) < npages:
            if self.require_reservation and self._reserved[slot] <= 0:
                raise RuntimeError(f"slot {slot} grew past its reservation")
            page = self._take_page()
            self._ref[page] = 1
            self._owned[slot].append(page)
            if self._reserved[slot] > 0:
                self._reserved[slot] -= 1
            self.high_water = max(self.high_water, self.pages_in_use)

    def cow_fork(self, slot: int, logical_idx: int) -> tuple[int, int]:
        """Copy-on-write: replace the shared page at ``slot``'s chain position
        ``logical_idx`` with a fresh private page and drop one ref on the
        shared page. Returns ``(src, dst)``; the caller must copy the shared
        prefix entries ``src -> dst`` on device *before* dispatching any write
        that could recycle ``src``. The fork target comes off the free list
        (or an evicted cache page), so it can never alias a still-shared
        page. A source whose refcount hits zero is pinned if possible."""
        src = self._owned[slot][logical_idx]
        if src == NULL_PAGE or self._ref[src] <= 0:
            raise RuntimeError(f"cow_fork({slot}, {logical_idx}): no live page")
        if self.require_reservation and self._reserved[slot] <= 0:
            raise RuntimeError(f"slot {slot}: fork exceeds its reservation")
        dst = self._take_page()
        if self._reserved[slot] > 0:
            self._reserved[slot] -= 1
        self._ref[dst] = 1
        self._ref[src] -= 1
        if self._ref[src] == 0:
            if not (src in self._page_key and self._try_pin(src)):
                self._drop_chain(src)
        self._owned[slot][logical_idx] = dst
        self.cow_forks += 1
        self.high_water = max(self.high_water, self.pages_in_use)
        return src, dst

    def release(self, slot: int) -> None:
        """Retire ``slot``: drop one ref on each of its pages and return any
        unused reservation. Pages still shared by other slots stay resident
        and indexed; refcount-zero *indexed* pages are pinned into the cache
        while the budget holds (shallowest first, so a retained chain is
        always reachable from the root), the rest freed deepest-first. No
        zeroing: stale page contents are only ever read masked."""
        zeros: list[int] = []
        for p in self._owned[slot]:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                zeros.append(p)
        self._owned[slot] = []
        self._reserved[slot] = 0
        # zeros appear in logical = shallow-to-deep chain order (indexed
        # prompt pages form a contiguous chain prefix of the slot's pages).
        # Once one indexed page fails to pin, everything deeper would dangle,
        # so it frees instead — children before parents.
        broken = False
        leftover: list[int] = []
        for p in zeros:
            if not broken and p in self._page_key and self._try_pin(p):
                continue
            if p in self._page_key:
                broken = True
            leftover.append(p)
        for p in reversed(leftover):
            self._drop_chain(p)

    # -- device view ---------------------------------------------------------
    def table(self) -> np.ndarray:
        """(num_slots, max_pages_per_slot) int32 block table; unmapped entries
        point at the null page. Shared pages appear in several rows at once.
        Pinned pages appear in no row — they are cache, not state."""
        t = np.full((self.num_slots, self.max_pages_per_slot), NULL_PAGE,
                    np.int32)
        for slot, pages in enumerate(self._owned):
            t[slot, :len(pages)] = pages
        return t
