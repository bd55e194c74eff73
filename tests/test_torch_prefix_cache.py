"""Prefix sharing on the PyTorch port's ragged engine against the JAX
package's (``ContinuousBatcher(kv_layout="ragged", prefix_cache_pages=N)``,
whose ragged Pallas kernel runs in interpret mode on the CPU), on the same
weights, at the engine geometry of ``tests/test_prefix_cache.py``.

* ``PrefixCache`` and ``PageAllocator`` unit cases, mirroring the JAX
  package's ``TestAllocatorRefcounts`` and ``TestPrefixCacheUnit`` (its
  chaos case has no counterpart: the port has no chaos sites yet); the
  chain hashes equal the JAX module's digests.
* Engine parity: shared-prompt traffic (suffix hits and a full-prefix
  resume, staggered) gives the JAX engine's tokens, the unshared engine's
  tokens and ``llama_generate``'s, over pages in the model dtype and over
  int8 and fp8 pages; the ``prefix_*`` and ``cow_copies`` counters equal
  the JAX engine's; a preempted sharing slot regenerates exactly; the
  copy-on-write leaves the index's pages bitwise unchanged; the exact-fit
  resume drops the index's reference instead of preempting itself.

Tolerance: greedy tokens must be identical (temperature 0); pool rows
bitwise.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatcher as JaxBatcher
from paddle_tpu.inference import prefix_cache as jpc
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import llama_init_params
from paddle_tpu_torch.inference.paging import PageAllocator
from paddle_tpu_torch.inference.prefix_cache import (PrefixCache,
                                                     chain_hashes)
from paddle_tpu_torch.inference.serving import ContinuousBatcher
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.llama_decode import llama_generate

PS = 8
GEOMETRY = dict(max_batch=3, max_len=96, prompt_buckets=(8, 16, 32),
                burst=4, page_size=PS)
# the counters the two engines must agree on
PREFIX_STATS = ("prefix_hits", "prefix_tokens_shared", "prefix_pages_shared",
                "prefix_resumes", "prefix_marginal_pages", "cow_copies",
                "preemptions", "prefills")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32"):
    jcfg = JaxConfig.tiny(num_hidden_layers=2, max_position_embeddings=128,
                          dtype=getattr(jax.numpy, dtype))
    jparams = llama_init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tl.LlamaConfig.tiny(num_hidden_layers=2,
                               max_position_embeddings=128,
                               dtype=getattr(torch, dtype))
    tparams = tl.params_from_jax({k: np.asarray(v)
                                  for k, v in jparams.items()}, tcfg,
                                 device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return _pair()


def _engines(models, **kw):
    jcfg, jparams, tcfg, tparams = models
    geo = {**GEOMETRY, **kw}
    return (JaxBatcher(jcfg, jparams, kv_layout="ragged", **geo),
            ContinuousBatcher(tcfg, tparams, device="cpu", **geo))


def _generate(models, prompt, n):
    _, _, tcfg, tparams = models
    return llama_generate(tparams, torch.tensor([prompt]), tcfg, n,
                          device="cpu")[0].tolist()


def _sys_reqs(seed=11, sys_pages=2, tails=(5, 3, 0, 9, 1)):
    """A common system prompt of ``sys_pages`` FULL pages plus per-request
    tails (tail 0 = the full-prefix duplicate that resumes without any
    prefill)."""
    rng = np.random.RandomState(seed)
    sysp = rng.randint(1, 256, sys_pages * PS).tolist()
    return sysp, [(sysp + rng.randint(1, 256, n).tolist(), 6 + n % 5)
                  for n in tails]


def _serve(eng, reqs, stagger=False):
    """Serve ``reqs``; staggered: one more request joins per step."""
    if not stagger:
        rids = [eng.add_request(p, max_new_tokens=m) for p, m in reqs]
        out = eng.run()
        return [out[r] for r in rids]
    rids, pend = [], list(reqs)
    while pend or eng.pending:
        if pend:
            p, m = pend.pop(0)
            rids.append(eng.add_request(p, max_new_tokens=m))
        eng.step()
    outs = eng.take_finished()
    return [outs[r].out for r in rids]


def _stats(eng):
    return {k: eng.stats.get(k, 0) for k in PREFIX_STATS}


# ------------------------------------------------------- allocator refcounts
def test_allocator_share_free_lifecycle():
    a = PageAllocator(6)
    got = a.alloc(2)
    assert a.free_pages == 3 and a.pages_in_use == 2
    a.share(got)                      # second holder per page
    assert a.free_pages == 3          # shared pages count ONCE
    assert all(a.refcount(p) == 2 for p in got)
    a.free(got)
    assert a.free_pages == 3 and a.pages_in_use == 2
    a.free(got)                       # last holder: recycle
    assert a.free_pages == 5 and a.pages_in_use == 0
    with pytest.raises(RuntimeError):
        a.free(got)


def test_allocator_share_unallocated_raises():
    a = PageAllocator(4)
    with pytest.raises(ValueError):
        a.share([1])                  # never allocated
    with pytest.raises(ValueError):
        a.share([0])                  # scratch is never shareable
    got = a.alloc(1)
    a.share(got, n=3)
    assert a.refcount(got[0]) == 4


# ------------------------------------------------------------ cache mechanics
def test_chain_hashes_equal_jax_and_chain():
    toks = list(range(1, 25))         # 3 full pages at PS=8
    hs = chain_hashes(toks, PS)
    assert hs == jpc.chain_hashes(toks, PS)
    assert len(hs) == 3
    assert hs == chain_hashes(toks + [99, 98], PS)[:3]   # tail-invariant
    other = [7] + toks[1:]            # page 0 reaches every later hash
    assert all(x != y for x, y in zip(hs, chain_hashes(other, PS)))


def test_match_insert_refcounts():
    a = PageAllocator(10)
    c = PrefixCache(a, PS, capacity_pages=8)
    toks = list(range(1, 17))         # 2 full pages
    pages = a.alloc(2)
    assert c.insert(toks, pages) == 2
    assert all(a.refcount(p) == 2 for p in pages)   # owner + cache
    a.free(pages)                      # owner retires: cache holds on
    assert all(a.refcount(p) == 1 for p in pages)
    assert c.evictable_pages() == 2 and c.match_pages(toks) == 2
    got, matched = c.match(toks + [40, 41])
    assert got == pages and matched == 16
    assert all(a.refcount(p) == 2 for p in pages)
    none, m0 = c.match([5] * 20)
    assert none == [] and m0 == 0
    got2, m2 = c.match(toks[:8] + [3] * 8)
    assert got2 == pages[:1] and m2 == 8
    a.free(got + got2)


def test_verification_rejects_token_mismatch():
    a = PageAllocator(6)
    c = PrefixCache(a, PS, capacity_pages=4)
    toks = list(range(1, 9))
    c.insert(toks, a.alloc(1))
    # a chain collision: same key, other stored tokens
    c._entries[chain_hashes(toks, PS)[0]]["tokens"] = tuple([9] * 8)
    assert c.match(toks) == ([], 0)


def test_lru_cap_and_busy_entries_survive():
    a = PageAllocator(12)
    c = PrefixCache(a, PS, capacity_pages=2)
    p1 = a.alloc(1)
    c.insert(list(range(1, 9)), p1)
    a.free(p1)                         # idle (cache-only)
    p2 = a.alloc(1)
    c.insert(list(range(11, 19)), p2)  # BUSY: owner still holds p2
    c.insert(list(range(21, 29)), a.alloc(1))   # over cap: evicts idle p1
    assert c.cached_pages == 2
    assert c.match(list(range(1, 9)) + [1])[0] == []
    assert c.match(list(range(11, 19)) + [1])[0] == p2
    a.free(p2)


def test_lru_evicts_chain_tail_first():
    a = PageAllocator(8)
    c = PrefixCache(a, PS, capacity_pages=8)
    toks = list(range(1, 17))
    pages = a.alloc(2)
    c.insert(toks, pages)
    a.free(pages)
    assert c.reclaim(1) == 1           # evicts the TAIL entry
    got, m = c.match(toks)
    assert got == pages[:1] and m == 8
    a.free(got)


def test_reclaim_bounded_by_idle_and_drop_page():
    a = PageAllocator(12)
    c = PrefixCache(a, PS, capacity_pages=8)
    pages = a.alloc(3)
    c.insert(list(range(1, 25)), pages)
    a.free(pages[:2])                  # 2 idle, 1 busy
    free0 = a.free_pages
    assert c.reclaim(5) == 2           # only the idle ones
    assert a.free_pages == free0 + 2 and c.cached_pages == 1
    assert c.drop_page(pages[2]) and not c.drop_page(pages[2])
    assert a.refcount(pages[2]) == 1 and c.cached_pages == 0
    a.free(pages[2:])
    assert a.pages_in_use == 0


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_shared_matches_unshared_jax_and_generate(models, kv_dtype):
    """Suffix hits and a full-prefix resume, staggered: the port's shared
    serve gives the JAX engine's tokens, the unshared serve's and
    ``llama_generate``'s (pages in the model dtype), and the prefix
    counters equal the JAX engine's."""
    _, reqs = _sys_reqs()
    jeng, eng = _engines(models, kv_dtype=kv_dtype, prefix_cache_pages=64)
    ref = _serve(jeng, reqs, stagger=True)
    shared = _serve(eng, reqs, stagger=True)
    _, plain = _engines(models, kv_dtype=kv_dtype)
    assert shared == ref
    assert shared == _serve(plain, reqs, stagger=True)
    assert _stats(eng) == _stats(jeng)
    st = eng.stats
    assert st["prefix_hits"] >= 3 and st["prefix_resumes"] >= 1
    assert st["cow_copies"] >= 1
    assert eng.pages_in_use == eng._prefix.cached_pages
    if kv_dtype is None:
        for out, (p, m) in zip(shared, reqs):
            assert out == _generate(models, p, m)


def test_bf16_shared_matches_jax():
    """A bf16 tiny model: the same traffic gives the JAX engine's tokens
    and counters."""
    pair = _pair("bfloat16")
    _, reqs = _sys_reqs(seed=19)
    jeng, eng = _engines(pair, prefix_cache_pages=64)
    assert _serve(eng, reqs, stagger=True) == \
        _serve(jeng, reqs, stagger=True)
    assert _stats(eng) == _stats(jeng)


def test_preemption_of_sharing_slot_is_exact(models):
    """The pool runs dry mid-flight while slots share a prefix: the
    youngest sharing slot is preempted, re-matches on re-admit, and its
    regenerated output is exact."""
    rng = np.random.RandomState(41)
    sysp = rng.randint(1, 256, 2 * PS).tolist()
    reqs = [(sysp + [5], 4)] + [
        (sysp + rng.randint(1, 256, 3).tolist(), 26) for _ in range(2)]
    jeng, eng = _engines(models, num_pages=9, burst=8,
                         prefix_cache_pages=64)
    outs = _serve(eng, reqs)
    assert outs == _serve(jeng, reqs)
    assert eng.stats["preemptions"] >= 1 and eng.stats["prefix_hits"] >= 2
    assert _stats(eng) == _stats(jeng)
    for out, (p, m) in zip(outs, reqs):
        assert out == _generate(models, p, m)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cow_leaves_shared_pages_bitwise_unchanged(models, kv_dtype):
    """Two identical full-page prompts resume on the indexed pages and
    decode concurrently: each copies its tail page before writing, both
    streams stay exact, and every page the index holds (payload and
    scales) is bitwise what the first prefill wrote."""
    rng = np.random.RandomState(43)
    p = rng.randint(1, 256, 2 * PS).tolist()
    ref = _generate(models, p, 10)
    _, eng = _engines(models, kv_dtype=kv_dtype, prefix_cache_pages=64)
    assert _serve(eng, [(p, 10)]) == [ref]
    pages = eng._prefix.cached_page_ids()
    before = {n: [buf[pages].clone() for buf in bufs]
              for n, bufs in eng._cache.items()}
    cow0 = eng.stats.get("cow_copies", 0)
    assert _serve(eng, [(p, 10), (p, 10)]) == [ref, ref]
    assert eng.stats["cow_copies"] >= cow0 + 2
    assert eng.stats["prefix_resumes"] >= 2
    assert eng._prefix.cached_page_ids() == pages
    for n, bufs in eng._cache.items():
        for old, buf in zip(before[n], bufs):
            assert torch.equal(buf[pages].view(torch.uint8),
                               old.view(torch.uint8)), n


def test_exact_fit_resume_drops_cache_ref_not_livelock(models):
    """usable pages == the request's page bill, with a full-prefix
    resume: the copy has no free page to land in and the index is the
    shared pages' only other holder, so the zero-copy fallback drops the
    index's reference instead of preempting the slot forever."""
    rng = np.random.RandomState(67)
    p = rng.randint(1, 256, 2 * PS).tolist()
    ref = _generate(models, p, 8)
    jeng, eng = _engines(models, num_pages=4, burst=8, prefix_cache_pages=8)
    for e in (jeng, eng):
        assert _serve(e, [(p, 8)]) == [ref]
        assert _serve(e, [(p, 8)]) == [ref]
    assert eng.stats["prefix_resumes"] == 1
    assert eng.stats.get("cow_copies", 0) == 0     # zero-copy fallback
    assert eng.stats["preemptions"] == 0
    assert _stats(eng) == _stats(jeng)


def test_suffix_only_prefill_accounting(models):
    """Warm hits share every full prefix page, the marginal pages are the
    suffix's, and a full-prefix duplicate runs no prefill at all."""
    rng = np.random.RandomState(53)
    sysp = rng.randint(1, 256, 2 * PS).tolist()
    _, eng = _engines(models, prefix_cache_pages=64)
    _serve(eng, [(sysp + [7, 8, 9], 4)])
    pf0, pb0 = eng.stats["prefills"], eng.stats["prefill_bursts"]
    _serve(eng, [(sysp + [5, 6], 4), (sysp + [1, 2, 3, 4], 4)])
    assert eng.stats["prefix_hits"] == 2
    assert eng.stats["prefix_tokens_shared"] == 2 * len(sysp)
    assert eng.stats["prefix_marginal_pages"] == 2
    _serve(eng, [(list(sysp), 4)])
    assert eng.stats["prefills"] == pf0 + 2        # the resume added none
    assert eng.stats["prefill_bursts"] == pb0 + 1
    assert eng.stats["prefix_resumes"] == 1
