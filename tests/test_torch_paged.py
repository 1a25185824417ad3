"""PyTorch port, paged serving: the paged decode attention's plain version
against the JAX package's gather path and its Pallas kernel (interpret mode),
the port's PagedBatchingEngine against the JAX one and against the port's
dense engine, and the page lifecycle and prefix cache, on the tiny LLM config
at fp32 on the CPU. The CUDA kernel itself is held against the plain version
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import tiny_llm_config
from mingunivision_tpu.engine.paged import PagedBatchingEngine as JaxPaged
from mingunivision_tpu.models.bailing_moe import init_bailing_moe_params
from mingunivision_tpu.ops.kernels.paged_attention import paged_gather_attention as jax_gather
from mingunivision_tpu.ops.kernels.paged_attention import pallas_paged_decode_attention
from mingunivision_tpu_torch.engine.batch_engine import ContinuousBatchingEngine
from mingunivision_tpu_torch.engine.paged import PagedBatchingEngine
from mingunivision_tpu_torch.ops.kernels.paged_attention import paged_decode_attention, paged_gather_attention
from mingunivision_tpu_torch.utils.convert import params_from_jax
import test_torch_common  # noqa: F401  (one torch thread per test worker)

ATTN_TOL = 2e-5  # fp32 attention, two frameworks' reduction orders (as tests/test_paged.py)


@pytest.fixture(scope="module")
def llm():
    cfg = tiny_llm_config()
    jparams = init_bailing_moe_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu", torch.float32)
    return cfg, jparams, tparams


def _attention_case(case: str):
    """(q, k_pages, v_pages, tables, lengths) as numpy. "small": the shapes of
    tests/test_paged.py's kernel tests (rows own disjoint pages, unassigned
    entries on the scratch page). "full-head": G = 4, D = 128, page 64, the
    pages shuffled and two rows sharing their first two pages."""
    rng = np.random.default_rng(0 if case == "small" else 1)
    if case == "small":
        B, Hq, Hkv, D, page, P, maxp = 3, 4, 2, 8, 16, 6, 4
        tables = np.full((B, maxp), P, np.int32)
        tables[0, :2] = [0, 1]
        tables[1, :3] = [2, 3, 4]
        tables[2, :1] = [5]
        lengths = np.asarray([20, 41, 7], np.int32)
    else:
        B, Hq, Hkv, D, page, P, maxp = 3, 8, 2, 128, 64, 9, 4
        perm = rng.permutation(P)
        tables = np.full((B, maxp), P, np.int32)
        tables[0, :3] = perm[[0, 1, 2]]
        tables[1, :4] = perm[[0, 1, 3, 4]]  # shares row 0's first two pages
        tables[2, :2] = perm[[5, 6]]
        lengths = np.asarray([150, 250, 65], np.int32)
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    kp = rng.standard_normal((Hkv, P + 1, page, D), dtype=np.float32)
    vp = rng.standard_normal((Hkv, P + 1, page, D), dtype=np.float32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("case", ["small", "full-head"])
def test_plain_matches_jax_gather_and_pallas_interpret(case):
    args = _attention_case(case)
    got = paged_decode_attention(*(torch.from_numpy(a) for a in args)).numpy()  # CPU: the plain version
    want_gather = np.asarray(jax_gather(*(jnp.asarray(a) for a in args)))
    want_pallas = np.asarray(pallas_paged_decode_attention(*(jnp.asarray(a) for a in args), interpret=True))
    np.testing.assert_allclose(got, want_gather, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_scratch_and_tail_contents_change_nothing():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _attention_case("full-head"))
    out = paged_gather_attention(q, kp, vp, tables, lengths)
    P = kp.shape[1] - 1
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[:, P], vp2[:, P] = 1e6, -1e6  # the scratch page
    last = tables[2, 1]  # row 2's last page holds 1 of its 64 positions
    kp2[:, last, 1:], vp2[:, last, 1:] = 3e5, -3e5
    unused = sorted(set(range(P)) - set(tables.flatten().tolist()))
    kp2[:, unused], vp2[:, unused] = 7e5, -7e5
    np.testing.assert_array_equal(paged_gather_attention(q, kp2, vp2, tables, lengths).numpy(), out.numpy())


def test_row_of_length_zero_gives_zeros():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _attention_case("small"))
    lengths = lengths.clone()
    lengths[1] = 0
    out = paged_gather_attention(q, kp, vp, tables, lengths)
    assert torch.isfinite(out).all() and not out[1].any()
    np.testing.assert_array_equal(out[0].numpy(), paged_gather_attention(q, kp, vp, tables,
                                                                        torch.tensor([20, 41, 7]))[0].numpy())


def _drive(eng, requests, interleave=False):
    reqs = []
    for ids, n, kw in requests:
        reqs.append(eng.add_request(ids, n, **kw))
        if interleave:  # admit mid-flight: two steps between admissions
            for _ in range(2):
                eng.step()
    eng.run_to_completion(max_steps=64)
    assert all(r is not None and r.done for r in reqs)
    return [r.tokens for r in reqs]


def _port_paged(llm, **kw):
    cfg, _, tparams = llm
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 256)
    kw.setdefault("page_size", 32)
    return PagedBatchingEngine(tparams, cfg, dtype=torch.float32, **kw)


@pytest.mark.parametrize("interleave", [False, True], ids=["together", "mid-flight"])
def test_paged_engine_matches_jax_and_dense(llm, interleave):
    """Greedy tokens equal the JAX paged engine's; greedy and sampled tokens
    equal the port's dense engine's (same seed, same draws)."""
    cfg, jparams, tparams = llm
    rng = np.random.default_rng(1)
    greedy = [(rng.integers(0, 400, (40,)), 8, {}), (rng.integers(0, 400, (5,)), 8, {}),
              (rng.integers(0, 400, (30,)), 16, {})]  # 30: the decode writes cross the page boundary at 32
    got = _drive(_port_paged(llm), greedy, interleave)
    want = _drive(JaxPaged(jparams, cfg, slots=3, max_len=256, page_size=32, dtype=jnp.float32), greedy, interleave)
    assert got == want
    mixed = greedy[:2] + [(rng.integers(0, 400, (12,)), 6, {"do_sample": True, "temperature": 0.7, "top_k": 5})]
    dense = ContinuousBatchingEngine(tparams, cfg, slots=3, max_len=256, dtype=torch.float32, seed=3)
    assert _drive(_port_paged(llm, seed=3), mixed, interleave) == _drive(dense, mixed, interleave)


def test_prefix_hit_equals_cold_run_and_jax(llm):
    cfg, jparams, _ = llm
    ids = np.random.default_rng(10).integers(0, 400, (70,))  # 2 full pages + a partial one
    eng = _port_paged(llm, num_pages=12, prefix_cache=True)
    cold = _drive(eng, [(ids, 8, {})])
    assert eng.prefix_hit_tokens == 0 and eng.prefix.cached_pages == 2
    hit = _drive(eng, [(ids, 8, {})])
    assert eng.prefix_hit_tokens == 64 and eng.prefix_miss_tokens == 70 + 6
    assert hit == cold
    jeng = JaxPaged(jparams, cfg, slots=3, max_len=256, page_size=32, num_pages=12, dtype=jnp.float32,
                    prefix_cache=True)
    _drive(jeng, [(ids, 8, {})])
    assert _drive(jeng, [(ids, 8, {})]) == hit and jeng.prefix_hit_tokens == 64


def test_prefix_cache_cases(llm):
    """After tests/test_paged.py's prefix-cache cases: a partial hit, a fully
    paged prompt recomputes its last page, concurrent sharing is read-only,
    a hit near max_len keeps the prefix intact."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 400, (70,))
    b = np.concatenate([a[:32], rng.integers(0, 400, (38,))])
    eng = _port_paged(llm, num_pages=12, prefix_cache=True)
    _drive(eng, [(a, 4, {})])
    (rb,) = _drive(eng, [(b, 4, {})])
    assert eng.prefix_hit_tokens == 32 and rb == _drive(_port_paged(llm, slots=1, num_pages=12), [(b, 4, {})])[0]

    ids = rng.integers(0, 400, (64,))  # exactly 2 pages: only page 0 may be skipped
    eng = _port_paged(llm, num_pages=12, prefix_cache=True)
    first = _drive(eng, [(ids, 4, {})])
    assert _drive(eng, [(ids, 4, {})]) == first and eng.prefix_hit_tokens == 32

    common = rng.integers(0, 400, (32,))
    c1, c2 = (np.concatenate([common, rng.integers(0, 400, (n,))]) for n in (10, 20))
    solo = [_drive(_port_paged(llm, slots=1, num_pages=12), [(c, 8, {})])[0] for c in (c1, c2)]
    eng = _port_paged(llm, num_pages=12, prefix_cache=True)
    r1, r2 = eng.add_request(c1, 8), eng.add_request(c2, 8)
    assert eng.prefix_hit_tokens == 32 and eng.prefix.ref[eng.slot_pages[0][0]] == 2  # page 0 shared
    eng.run_to_completion()
    assert [r1.tokens, r2.tokens] == solo

    ids = rng.integers(0, 400, (250,))  # 7 full pages (Tc = 224), the padded suffix capped to 32
    eng = _port_paged(llm, num_pages=24, prefix_cache=True)
    first = _drive(eng, [(ids, 4, {})])
    assert _drive(eng, [(ids, 4, {})]) == first and eng.prefix_hit_tokens == 224


def test_pages_released_reused_and_exhausted(llm):
    rng = np.random.default_rng(3)
    eng = _port_paged(llm, slots=2, max_len=128, num_pages=4)
    r1 = eng.add_request(rng.integers(0, 400, (40,)), 4)  # 2 pages
    assert r1 is not None and eng.allocator.available == 2
    eng.run_to_completion()
    assert r1.done and eng.allocator.available == 4
    r2 = eng.add_request(rng.integers(0, 400, (100,)), 4)  # all 4 pages
    eng.run_to_completion()
    assert r2.done and eng.allocator.available == 4

    eng = _port_paged(llm, max_len=128, num_pages=3)
    assert eng.add_request(rng.integers(0, 400, (60,)), 4) is not None  # 2 pages
    assert eng.add_request(rng.integers(0, 400, (60,)), 4) is None  # 2 more, 1 left
    eng.run_to_completion()
    assert eng.add_request(rng.integers(0, 400, (60,)), 4) is not None  # the pages are back


def test_stall_and_resume_on_page_exhaustion(llm):
    rng = np.random.default_rng(5)
    ids_long, ids_other = rng.integers(0, 400, (31,)), rng.integers(0, 400, (60,))
    (want,) = _drive(_port_paged(llm, slots=1, max_len=128, num_pages=4, seed=7), [(ids_long, 8, {})])
    eng = _port_paged(llm, slots=2, max_len=128, num_pages=3, seed=7)
    r1 = eng.add_request(ids_long, 8)  # 1 page; its write at 32 needs a second
    r2 = eng.add_request(ids_other, 3)  # the other 2 pages, for 2 more steps
    stalled = False
    for _ in range(40):
        eng.step()
        stalled |= bool(eng.stalled.get(0))
        if not eng.slot_req:
            break
    assert stalled and r1.done and r2.done
    assert r1.tokens == want


def test_eviction_under_pressure_and_impossible_alloc(llm):
    rng = np.random.default_rng(14)
    eng = _port_paged(llm, max_len=128, num_pages=4, prefix_cache=True)
    _drive(eng, [(rng.integers(0, 400, (70,)), 4, {})])  # 3 pages, 2 of them cached after
    assert eng.prefix.cached_pages == 2 and eng.allocator.available == 2
    before = set(eng.prefix.hash_to_page)
    assert eng._alloc(8) is None  # more than free + evictable: evicts nothing
    assert set(eng.prefix.hash_to_page) == before
    r = eng.add_request(rng.integers(0, 400, (100,)), 4)  # needs all 4: both cached pages evicted
    assert r is not None and not before & set(eng.prefix.hash_to_page)
    eng.run_to_completion()
    assert r.done
