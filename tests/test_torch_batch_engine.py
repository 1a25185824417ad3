"""PyTorch port, continuous batching on the dense KV pool: the port's
ContinuousBatchingEngine against the JAX package's (greedy tokens, on the
tiny LLM config at fp32 on the CPU), the int4 tree's engine against the
port's own int4 session, and the per-slot sampler."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mingunivision_tpu.config import tiny_llm_config
from mingunivision_tpu.engine.batch_engine import ContinuousBatchingEngine as JaxEngine
from mingunivision_tpu.engine.sampler import sample_token_per_slot as jax_sample_per_slot
from mingunivision_tpu.models.bailing_moe import init_bailing_moe_params
from mingunivision_tpu.utils.quantize import quantize_tree
from mingunivision_tpu_torch.config import GenerationConfig, RuntimeConfig
from mingunivision_tpu_torch.engine.batch_engine import ContinuousBatchingEngine
from mingunivision_tpu_torch.engine.sampler import sample_token_per_slot
from mingunivision_tpu_torch.engine.session import MingUniVisionSession
from mingunivision_tpu_torch.utils.convert import params_from_jax

from test_torch_common import EOS, IMG_START, random_params, tiny_mm, to_jax


@pytest.fixture(scope="module")
def llm():
    cfg = tiny_llm_config()
    jparams = init_bailing_moe_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu", torch.float32)
    return cfg, jparams, tparams


def _engine(llm, **kw):
    cfg, _, tparams = llm
    kw.setdefault("slots", 3)
    return ContinuousBatchingEngine(tparams, cfg, max_len=256, dtype=torch.float32, **kw)


def test_greedy_tokens_match_jax_with_midflight_admission(llm):
    cfg, jparams, _ = llm
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 400, (40,)), rng.integers(0, 400, (5,)), rng.integers(0, 400, (70,))]

    def drive(eng):
        reqs = []
        for ids in prompts:
            reqs.append(eng.add_request(ids, 8))
            for _ in range(2):
                eng.step()
        eng.run_to_completion(64)
        return [r.tokens for r in reqs]

    got = drive(_engine(llm))
    assert got == drive(JaxEngine(jparams, cfg, slots=3, max_len=256, dtype=jnp.float32))
    assert all(len(t) == 8 for t in got)


def test_concurrent_requests_isolated(llm):
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 400, (5,)), rng.integers(0, 400, (9,))
    solo = []
    for ids in (a, b):
        eng = _engine(llm, slots=1)
        r = eng.add_request(ids, 8)
        eng.run_to_completion()
        solo.append(r.tokens)
    eng = _engine(llm)
    ra, rb = eng.add_request(a, 8), eng.add_request(b, 8)
    eng.run_to_completion()
    assert [ra.tokens, rb.tokens] == solo


def test_admission_when_full(llm):
    rng = np.random.default_rng(3)
    eng = _engine(llm, slots=2)
    r1, r2 = eng.add_request(rng.integers(0, 400, (6,)), 4), eng.add_request(rng.integers(0, 400, (7,)), 6)
    assert r1 is not None and r2 is not None and not eng.has_free_slot()
    assert eng.add_request(rng.integers(0, 400, (8,)), 4) is None
    while not r1.done:
        eng.step()
    assert eng.has_free_slot() and not r2.done
    r3 = eng.add_request(rng.integers(0, 400, (8,)), 4)  # admitted while r2 is mid-flight
    eng.run_to_completion()
    assert r3 is not None and r2.done and r3.done and len(r3.tokens) == 4
    with pytest.raises(ValueError):
        eng.add_request(rng.integers(0, 400, (250,)), 8)  # 250 + 8 >= max_len


def test_int4_engine_matches_int4_session():
    """The int4 tree (LLM quantized as the JAX int4 tier does) through the
    engine at one slot gives the port's int4 session's greedy tokens."""
    cfg = tiny_mm()
    params = random_params(cfg, seed=2)["llm"]
    params["lm_head"]["w"][:, [EOS, IMG_START]] = 0.0  # a text-only round
    q4 = params_from_jax({"llm": quantize_tree(to_jax(params), bits=4, min_size=1024)}, "cpu", torch.float32)
    ids = np.random.default_rng(4).integers(20, 400, (21,))
    sess = MingUniVisionSession(q4, cfg, RuntimeConfig(max_seq_len=128, compute_dtype="float32"), device="cpu")
    want = sess.generate(ids[None], np.ones((1, len(ids)), np.int64),
                         generation=GenerationConfig(max_new_tokens=10)).token_ids
    eng = ContinuousBatchingEngine(q4["llm"], cfg.llm, slots=1, max_len=128, dtype=torch.float32)
    req = eng.add_request(ids, 10)
    eng.run_to_completion()
    assert req.tokens == want and len(want) == 10


def _sampling(B, **overrides):
    kw = dict(do_sample=torch.zeros(B, dtype=torch.bool), temperature=torch.ones(B), top_k=torch.zeros(B, dtype=torch.long),
              top_p=torch.ones(B))
    kw.update(overrides)
    return kw


def test_greedy_rows_unperturbed_by_sampled_rows():
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 64), dtype=np.float32))
    kw = _sampling(4, do_sample=torch.tensor([False, True, False, True]), temperature=torch.tensor([1.0, 0.5, 1.0, 2.0]),
                   top_k=torch.tensor([0, 5, 0, 0]), top_p=torch.tensor([1.0, 1.0, 1.0, 0.6]))
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        out = sample_token_per_slot(logits, g, **kw)
        assert out[[0, 2]].tolist() == logits[[0, 2]].argmax(-1).tolist()
    # the JAX package's greedy rows agree (its sampled rows draw from its own PRNG)
    jout = jax_sample_per_slot(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                               **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    assert np.asarray(jout)[[0, 2]].tolist() == out[[0, 2]].tolist()


def test_top_k_one_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal((5, 64), dtype=np.float32))
    kw = _sampling(5, do_sample=torch.ones(5, dtype=torch.bool), temperature=torch.full((5,), 0.8),
                   top_k=torch.ones(5, dtype=torch.long))
    g = torch.Generator().manual_seed(1)
    for _ in range(10):
        assert sample_token_per_slot(logits, g, **kw).tolist() == logits.argmax(-1).tolist()


def test_sampled_tokens_stay_in_each_rows_kept_set():
    """Row 0 top-k 5; row 1 top-p 0.5 (the HF rule: the smallest set of most
    probable tokens whose probability reaches 0.5); row 2 both; row 3 neither."""
    logits = torch.from_numpy(2.0 * np.random.default_rng(7).standard_normal((4, 64), dtype=np.float32))
    temps = torch.tensor([1.0, 0.7, 1.3, 1.0])
    top_k, top_p = torch.tensor([5, 0, 8, 0]), torch.tensor([1.0, 0.5, 0.7, 1.0])
    kw = _sampling(4, do_sample=torch.ones(4, dtype=torch.bool), temperature=temps, top_k=top_k, top_p=top_p)

    def kept(row):
        lt = logits[row] / temps[row]
        order = torch.argsort(lt, descending=True)
        if top_k[row] > 0:
            order = order[: top_k[row]]
        probs = torch.softmax(lt[order], -1)
        n = len(order) if top_p[row] >= 1 else int((probs.cumsum(0) - probs <= top_p[row]).sum())
        return set(order[:n].tolist())

    sets = [kept(r) for r in range(4)]
    assert [len(s) for s in sets[:3]] != [64] * 3 and len(sets[3]) == 64
    g = torch.Generator().manual_seed(2)
    seen = [set() for _ in range(4)]
    for _ in range(300):
        for r, t in enumerate(sample_token_per_slot(logits, g, **kw).tolist()):
            seen[r].add(t)
    for r in range(4):
        assert seen[r] <= sets[r], r
        assert len(seen[r]) > 1, r  # it samples
