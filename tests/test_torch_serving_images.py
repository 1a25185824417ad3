"""PyTorch port, the serving layer's image paths: `/generate` with
`n_images=2`, and `/generate_image_batch` through the barrier batcher and
through the image pool (`image_pool_slots > 0`, per-request text_cfg, seed and
temperature), on the port's InferenceServer (in-process aiohttp) against the
JAX package's server on the same payloads, a tiny infer at fp32 on the CPU,
the RF noise off (temperature 0) on both sides: the same texts and the same
PNGs within one 8-bit step (the images agree within 1e-3)."""

import asyncio
import base64
import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")

import jax  # noqa: E402
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402
from PIL import Image  # noqa: E402

from mingunivision_tpu.api import MingUniVisionInfer as JaxInfer  # noqa: E402
from mingunivision_tpu.config import RuntimeConfig as JaxRuntimeConfig  # noqa: E402
from mingunivision_tpu.serving.server import InferenceServer as JaxServer  # noqa: E402
from mingunivision_tpu_torch.api import MingUniVisionInfer  # noqa: E402
from mingunivision_tpu_torch.config import RuntimeConfig  # noqa: E402
from mingunivision_tpu_torch.processing.processor import BailingMMProcessor  # noqa: E402
from mingunivision_tpu_torch.serving.server import InferenceServer  # noqa: E402
from mingunivision_tpu_torch.utils.convert import params_from_jax  # noqa: E402

from test_torch_common import to_jax  # noqa: E402
from test_torch_slice import _bias_image_start  # noqa: E402

RT = dict(max_seq_len=1024, compute_dtype="float32")


def _msgs(text):
    return [{"role": "HUMAN", "content": [{"type": "text", "text": text}]}]


@pytest.fixture(scope="module")
def infers():
    """(JAX tiny infer, port infer) on the same params, the RF noise off, the
    RF head's guidance live, the LM head steered to open an image after the
    test prompt."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from examples.test_infer_unified import build_tiny_infer

    tiny = build_tiny_infer()
    cfg = dataclasses.replace(tiny.config, image_gen=dataclasses.replace(tiny.config.image_gen, temperature=0.0))
    params = jax.tree_util.tree_map(np.array, tiny.params)
    rng = np.random.default_rng(3)  # the RF head's zero-initialised AdaLN and final layers made random: CFG acts
    rf = params["rf_head"]
    for leaf in (rf["res_blocks"]["adaLN"], rf["final_layer"]["adaLN"], rf["final_layer"]["linear"]):
        leaf["w"] = (0.05 * rng.standard_normal(leaf["w"].shape)).astype(np.float32)
    proc = tiny.processor
    _bias_image_start(params, cfg, proc(text=proc.apply_chat_template(_msgs("a red cat"))).input_ids)
    jax_infer = JaxInfer(params=to_jax(params), config=cfg, runtime=JaxRuntimeConfig(**RT), processor=proc)
    port = MingUniVisionInfer(params=params_from_jax(params, "cpu", torch.float32), config=cfg, device="cpu",
                              processor=BailingMMProcessor(proc.tokenizer, und_image_size=64, gen_image_size=64),
                              runtime=RuntimeConfig(**RT))
    return jax_infer, port


def _run(app, body):
    async def go():
        async with TestClient(TestServer(app)) as client:
            return await body(client)
    return asyncio.run(go())


def _post(path, payload):
    async def body(client):
        r = await client.post(path, json=payload)
        return r.status, await r.json()
    return body


def _pixels(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")).astype(np.int32)


def _same_pngs(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.abs(_pixels(g) - _pixels(w)).max() <= 1


def test_generate_n_images_matches_jax(infers, tmp_path):
    jax_infer, port = infers
    outs = []
    for infer, cls in ((jax_infer, JaxServer), (port, InferenceServer)):
        payload = {"messages": _msgs("a red cat"), "max_new_tokens": 1, "reset": True, "n_images": 2,
                   "image_gen_temperature": 0.0, "output_image_prefix": str(tmp_path / cls.__module__)}
        status, out = _run(cls(infer).build_app(), _post("/generate", payload))
        assert status == 200 and out["ret_code"] == 0, out
        outs.append(out)
    want, got = outs
    assert got["text"] == want["text"] and len(got["images"]) == 2
    _same_pngs(got["images"], want["images"])


def test_image_batch_barrier_matches_jax(infers):
    jax_infer, port = infers
    payload = {"requests": [_msgs("a red cat"), _msgs("a much longer prompt about a small blue house")], "seed": 3}
    outs = [_run(cls(infer).build_app(), _post("/generate_image_batch", payload))
            for infer, cls in ((jax_infer, JaxServer), (port, InferenceServer))]
    assert [s for s, _ in outs] == [200, 200] and all(o["ret_code"] == 0 for _, o in outs)
    _same_pngs(outs[1][1]["images"], outs[0][1]["images"])
    assert _run(InferenceServer(port).build_app(), _post("/generate_image_batch", {"requests": []}))[0] == 400


def test_image_batch_pool_matches_jax_with_per_request_values(infers):
    """Pool mode: three requests on two slots (the third waits for a free
    slot), per-request text_cfg and seed, the noise off per request."""
    jax_infer, port = infers
    reqs = [{"messages": _msgs(t), "text_cfg": s, "temperature": 0.0, "seed": i}
            for i, (t, s) in enumerate((("a red cat", 1.0), ("a red cat", 5.0), ("a green field at noon", 3.0)))]
    outs = []
    for infer, cls in ((jax_infer, JaxServer), (port, InferenceServer)):
        srv = cls(infer, image_pool_slots=2, image_pool_chunk=4)
        try:
            outs.append(_run(srv.build_app(), _post("/generate_image_batch", {"requests": reqs})))
        finally:
            srv.image_pool_worker.stop()
    assert [s for s, _ in outs] == [200, 200] and all(o["ret_code"] == 0 for _, o in outs)
    want, got = outs[0][1]["images"], outs[1][1]["images"]
    assert len(got) == 3
    _same_pngs(got, want)
    assert np.abs(_pixels(got[0]) - _pixels(got[1])).max() > 0  # per-request guidance acts
