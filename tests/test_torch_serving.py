"""PyTorch port, the serving layer: the port's InferenceServer (in-process
aiohttp) on a tiny torch infer built from the JAX tiny infer's params and the
test tokenizer, against the JAX package's server on the same payloads, at
fp32 on the CPU: /health, /metrics, /generate, /generate_stream and
/generate_batch over both KV pools give the JAX server's texts; what is not
ported yet (/tts, LoRA) answers an error code at once. The image paths are in
test_torch_serving_images.py."""

import asyncio
import json
import os
import sys

import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from mingunivision_tpu.serving.server import InferenceServer as JaxServer  # noqa: E402
from mingunivision_tpu_torch.api import MingUniVisionInfer  # noqa: E402
from mingunivision_tpu_torch.config import RuntimeConfig  # noqa: E402
from mingunivision_tpu_torch.processing.processor import BailingMMProcessor  # noqa: E402
from mingunivision_tpu_torch.serving.server import InferenceServer  # noqa: E402
from mingunivision_tpu_torch.utils.convert import params_from_jax  # noqa: E402
import test_torch_common  # noqa: F401  (one torch thread per test worker)

PROMPTS = ("one prompt", "a different longer prompt here", "third")


def _msgs(text):
    return [{"role": "HUMAN", "content": [{"type": "text", "text": text}]}]


@pytest.fixture(scope="module")
def infers():
    """(JAX tiny infer, port infer on the same params). The <image> column of
    the LM head is zeroed in both, so every round stays text."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from examples.test_infer_unified import build_tiny_infer

    jax_infer = build_tiny_infer()
    llm = jax_infer.config.llm
    jax_infer.params["llm"]["lm_head"]["w"] = jax_infer.params["llm"]["lm_head"]["w"].at[:, llm.image_start_token].set(0.0)
    tree = params_from_jax({k: jax_infer.params[k] for k in ("llm", "mingtok", "rf_head", "vis_head", "linear_proj")},
                           device="cpu", dtype=torch.float32)
    proc = BailingMMProcessor(jax_infer.processor.tokenizer, und_image_size=64, gen_image_size=64)
    port = MingUniVisionInfer(params=tree, config=jax_infer.config, processor=proc, device="cpu",
                              runtime=RuntimeConfig(max_seq_len=1024, compute_dtype="float32"))
    return jax_infer, port


def _run(app, body):
    async def go():
        async with TestClient(TestServer(app)) as client:
            return await body(client)
    return asyncio.run(go())


async def _generate(client, text, **kw):
    r = await client.post("/generate", json={"messages": _msgs(text), "max_new_tokens": 6, "reset": True, **kw})
    assert r.status == 200, await r.text()
    out = await r.json()
    assert out["ret_code"] == 0
    return out["text"]


def test_health_metrics_and_generate_match_jax(infers):
    jax_infer, port = infers

    async def body(client):
        health = await (await client.get("/health")).json()
        assert health["status"] == "healthy" and health["ret_code"] == 0
        texts = [await _generate(client, t) for t in PROMPTS[:2]]
        r = await client.post("/generate", data=b"not json", headers={"Content-Type": "application/json"})
        assert r.status == 400
        r = await client.post("/generate", json={"max_new_tokens": 4})
        assert r.status == 400
        metrics = await (await client.get("/metrics")).json()
        assert metrics["requests"] == 2 and metrics["errors"] == 0
        return texts

    got = _run(InferenceServer(port).build_app(), body)
    want = _run(JaxServer(jax_infer).build_app(), lambda c: asyncio.gather(*[_generate(c, t) for t in PROMPTS[:2]]))
    assert got == list(want) and all(got)


def test_generate_stream_matches_jax(infers):
    jax_infer, port = infers
    payload = {"messages": _msgs("tell me"), "max_new_tokens": 10, "stream_chunk_tokens": 4, "reset": True,
               "session_id": "streamer"}

    async def body(client):
        r = await client.post("/generate_stream", json=payload)
        assert r.status == 200
        plain = (await r.read()).decode()
        r = await client.post("/generate_stream", json={**payload, "sse": True})
        assert r.headers["Content-Type"].startswith("text/event-stream")
        events = [json.loads(line[len("data: "):]) for line in (await r.read()).decode().splitlines()
                  if line.startswith("data: ")]
        assert events[-1]["done"] is True
        first = await _generate(client, "tell me", max_new_tokens=4)
        return plain, "".join(e["text"] for e in events), first

    plain, sse, first = _run(InferenceServer(port).build_app(), body)
    want, *_ = _run(JaxServer(jax_infer).build_app(), body)
    assert plain == sse == want
    assert plain.startswith(first)  # the first chunk is the round's first 4 tokens


@pytest.mark.parametrize("paged_kv", [None, False], ids=["paged-default", "dense"])
def test_generate_batch_matches_jax(infers, paged_kv):
    jax_infer, port = infers

    async def body(client):
        async def ask(text):
            r = await client.post("/generate_batch", json={"messages": _msgs(text), "max_new_tokens": 6})
            assert r.status == 200, await r.text()
            return (await r.json())["text"]
        return list(await asyncio.gather(*(ask(t) for t in PROMPTS)))  # all three in flight at once

    srv = InferenceServer(port, batch_slots=3, batch_max_len=256, paged_kv=paged_kv, page_size=32)
    jsrv = JaxServer(jax_infer, batch_slots=3, batch_max_len=256)
    try:
        got = _run(srv.build_app(), body)
        assert got == _run(jsrv.build_app(), body)
        assert len(set(got)) == 3
    finally:
        srv.batch_worker.stop()
        jsrv.batch_worker.stop()


def test_starved_paged_pool_finishes_and_rejects_what_never_fits(infers):
    _, port = infers
    srv = InferenceServer(port, batch_slots=3, batch_max_len=256, page_size=32, num_pages=2)

    async def body(client):
        async def ask(text, n):
            r = await client.post("/generate_batch", json={"messages": _msgs(text), "max_new_tokens": n})
            return r.status, await r.json()
        small = await asyncio.gather(*(ask(t, 6) for t in PROMPTS))
        big = await ask("x " * 80, 4)  # more pages than the pool holds
        return small, big

    try:
        small, big = _run(srv.build_app(), body)
        assert [s for s, _ in small] == [200] * 3
        assert big[0] == 500 and "page pool" in big[1]["error"]
    finally:
        srv.batch_worker.stop()


def test_unported_features_answer_an_error(infers):
    _, port = infers
    srv = InferenceServer(port)

    async def body(client):
        statuses = []
        for path, payload in (("/generate_image_batch", {"requests": []}), ("/tts", {"text": "hi"}),
                              ("/generate", {"messages": _msgs("a cat"), "lora": "x"}),
                              ("/generate_batch", {"messages": _msgs("a cat")})):
            r = await asyncio.wait_for(client.post(path, json=payload), timeout=30)
            out = await r.json()
            statuses.append((r.status, out["ret_code"]))
        return statuses

    # an empty image batch, /tts, a LoRA adapter; batching is off: /generate_batch too
    assert _run(srv.build_app(), body) == [(400, 1)] * 4
    bsrv = InferenceServer(port, batch_slots=1, batch_max_len=256)
    try:
        r = _run(bsrv.build_app(), lambda c: c.post("/generate_batch", json={"messages": _msgs("a"), "lora": "x"}))
        assert r.status == 400
    finally:
        bsrv.batch_worker.stop()
    for kw in ({"lora_adapters": {"a": {}}}, {"talker_pipeline": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            InferenceServer(port, **kw)
