"""HTTP inference server over the port (counterpart of mingunivision_tpu/serving/server.py).

aiohttp app with:
  - GET  /health            liveness
  - GET  /metrics           request counters
  - POST /generate          one-shot generation through the session (text and base64 PNG images)
  - POST /generate_stream   chunked streaming of decoded text (session.continue_decode)
  - POST /generate_batch    text generation through the continuous-batching
                            engine (`batch_slots > 0`): the paged pool by
                            default, the dense pool with `paged_kv=False`
  - POST /generate_image_batch  several text-to-image requests: one barrier
                            batch (serving/image_batch.py), or with
                            `image_pool_slots > 0` continuous admission into
                            the image pool (engine/image_pool.py), whose
                            slots honour each request's seed, text_cfg,
                            image_cfg and temperature

Session work runs on one executor thread (one device stream), sessions per
`session_id` with LRU expiry and a per-session lock; the batching engine runs
on its own worker thread, and so does the image pool. `/generate` takes
`n_images` (variants of each image in one loop). JSON responses carry a
`ret_code` (`RetCode`).

Not ported yet, and refused rather than ignored: `/tts` and a talker
pipeline (ROADMAP.md Queue 1.7), LoRA adapters and a request's `lora`
(Queue 1.4). The endpoints answer BAD_REQUEST, the constructor raises
NotImplementedError.
Generated images come back base64 in the response and, as in the JAX server,
are written as PNGs at the request's `output_image_prefix` (default
`serve_out` in the temporary directory; `MingUniVisionInfer.generate`).

aiohttp is imported inside `build_app` and `run` only.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import os
import queue
import tempfile
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from enum import IntEnum
from typing import Optional

def not_ported(what: str, item: str):
    """The error for what this port does not run yet."""
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet (ROADMAP.md {item})")


class RetCode(IntEnum):
    OK = 0
    BAD_REQUEST = 1
    OVERLOADED = 2
    INTERNAL_ERROR = 3


def _png_b64(img_chw) -> str:
    from PIL import Image

    from mingunivision_tpu_torch.processing.image_ops import tensor_to_image

    buf = io.BytesIO()
    Image.fromarray(tensor_to_image(img_chw)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class BatchTextWorker:
    """The continuous-batching text path: a thread admits queued prompts into
    free engine slots and steps all active slots together. Each submitted
    item records `t_submit` and, once admitted (its first token sampled by
    the prefill), `t_first` (host perf_counter seconds). A step that raises
    fails every request in flight and queued, and the worker stops."""

    def __init__(self, engine, eos_token_id: int):
        self.engine = engine
        self.eos_token_id = eos_token_id
        self.queue: "queue.Queue" = queue.Queue()
        self._pending: deque = deque()  # worker-local admission queue (drained by stop)
        self._inflight: list = []
        self._running = True
        self.failure: Optional[str] = None
        self._thread = threading.Thread(target=self._loop, name="batch-worker", daemon=True)
        self._thread.start()

    def submit(self, input_ids, max_new_tokens: int, sampling: Optional[dict] = None) -> dict:
        item = {"ids": input_ids, "max": int(max_new_tokens), "sampling": sampling or {}, "event": threading.Event(),
                "req": None, "t_submit": time.perf_counter()}
        if self.failure is not None:
            item["error"] = self.failure
            item["event"].set()
        else:
            self.queue.put(item)
        return item

    def _fail_all(self, message: str):
        leftovers = list(self._pending) + list(self._inflight)
        self._pending.clear()
        self._inflight = []
        try:
            while True:
                leftovers.append(self.queue.get_nowait())
        except queue.Empty:
            pass
        for item in leftovers:
            item.setdefault("error", message)
            item["event"].set()

    def stop(self):
        self._running = False
        self._thread.join(timeout=5)
        # unblock every handler still waiting on an item
        self._fail_all("server shutting down")

    def _admit(self, pending):
        while pending and self.engine.has_free_slot():
            item = pending.popleft()
            try:
                item["req"] = self.engine.add_request(item["ids"], item["max"], **item["sampling"])
            except Exception as e:  # noqa: BLE001 - a bad request must not kill the worker
                item["error"] = str(e)
                item["event"].set()
                continue
            if item["req"] is None:
                # paged engine: a free slot but no pages now. Retry once requests in
                # flight release pages; with the pool idle the prompt can never fit.
                if self.engine.slot_req:
                    pending.appendleft(item)
                    break
                item["error"] = "request exceeds the KV page pool"
                item["event"].set()
                continue
            item["t_first"] = time.perf_counter()
            if item["req"].done:  # stopped at its first token
                item["event"].set()
            else:
                self._inflight.append(item)

    def _loop(self):
        pending = self._pending
        while self._running:
            try:
                while True:
                    pending.append(self.queue.get_nowait())
            except queue.Empty:
                pass
            self._admit(pending)
            if not self.engine.slot_req:
                try:
                    pending.append(self.queue.get(timeout=0.05))
                except queue.Empty:
                    pass
                continue
            try:
                self.engine.step()
            except Exception as e:  # noqa: BLE001 - fail the requests instead of hanging them
                self.failure = f"batch engine step failed: {e!r}"
                self._running = False
                self._fail_all(self.failure)
                return
            still = []
            for item in self._inflight:
                if item["req"].done:
                    item["event"].set()
                else:
                    still.append(item)
            self._inflight = still


class ImagePoolWorker:
    """Continuous-admission T2I serving (engine/image_pool.py): requests from
    any /generate_image_batch POST are admitted into free pool slots while
    earlier ones are mid-loop. The same thread, queue and drain discipline as
    BatchTextWorker: a step that raises fails every request in flight and
    queued, and the worker stops."""

    def __init__(self, engine):
        self.engine = engine  # an ImagePoolEngine
        self.queue: "queue.Queue" = queue.Queue()
        self._pending: deque = deque()
        self._inflight: list = []
        self._running = True
        self.failure: Optional[str] = None
        self._thread = threading.Thread(target=self._loop, name="image-pool-worker", daemon=True)
        self._thread.start()

    def submit(self, batch: dict, seed: int, gen_kwargs: Optional[dict] = None) -> dict:
        item = {"batch": batch, "seed": int(seed), "gen": gen_kwargs or {}, "event": threading.Event(), "req": None}
        if self.failure is not None:
            item["error"] = self.failure
            item["event"].set()
        else:
            self.queue.put(item)
        return item

    def _fail_all(self, message: str):
        leftovers = list(self._pending) + list(self._inflight)
        self._pending.clear()
        self._inflight = []
        try:
            while True:
                leftovers.append(self.queue.get_nowait())
        except queue.Empty:
            pass
        for item in leftovers:
            item.setdefault("error", message)
            item["event"].set()

    def stop(self):
        self._running = False
        self._thread.join(timeout=5)
        self._fail_all("server shutting down")

    def _loop(self):
        pending = self._pending
        while self._running:
            try:
                while True:
                    pending.append(self.queue.get_nowait())
            except queue.Empty:
                pass
            while pending and self.engine.has_free_slot():
                item = pending.popleft()
                try:
                    item["req"] = self.engine.add_request(item["batch"], item["seed"], **item["gen"])
                except Exception as e:  # noqa: BLE001 - a bad request must not kill the worker
                    item["error"] = str(e)
                    item["event"].set()
                    continue
                self._inflight.append(item)
            if not self.engine.slot_req:
                try:
                    pending.append(self.queue.get(timeout=0.05))
                except queue.Empty:
                    pass
                continue
            try:
                self.engine.step()  # `chunk` micro-steps for every active slot
            except Exception as e:  # noqa: BLE001 - fail the requests instead of hanging them
                self.failure = f"image pool step failed: {e!r}"
                self._running = False
                self._fail_all(self.failure)
                return
            still = []
            for item in self._inflight:
                if item["req"].done:
                    item["event"].set()
                else:
                    still.append(item)
            self._inflight = still


class InferenceServer:
    def __init__(self, infer, host: str = "0.0.0.0", port: int = 8816, max_sessions: int = 8, max_queue: int = 64,
                 talker_pipeline=None, batch_slots: int = 0, batch_max_len: int = 1024, image_pool_slots: int = 0,
                 image_pool_chunk: int = 32, paged_kv: Optional[bool] = None, page_size: int = 64,
                 num_pages: Optional[int] = None, prefix_cache: bool = False, lora_adapters: Optional[dict] = None):
        """batch_slots > 0 enables /generate_batch with that many decode slots,
        on the block-paged pool (`paged_kv` None or True: KV memory follows the
        tokens in flight, `num_pages * page_size` of them; an exhausted pool
        stalls slots) or on the dense pool (`paged_kv=False`). prefix_cache
        shares full prompt pages between requests with the same prefix.
        image_pool_slots > 0 switches /generate_image_batch to continuous
        admission into an image pool of that many slots, `image_pool_chunk`
        micro-steps between scheduling points."""
        if talker_pipeline is not None:
            raise not_ported("the talker pipeline (/tts)", "Queue 1.7")
        if lora_adapters:
            raise not_ported("LoRA adapters", "Queue 1.4")
        self.infer = infer  # a MingUniVisionInfer (holds the default session)
        self.host = host
        self.port = port
        self.max_sessions = max_sessions
        self.max_queue = max_queue
        self.executor = ThreadPoolExecutor(max_workers=1)  # one device stream
        self.pending = 0
        self.stats = {"requests": 0, "errors": 0, "tokens": 0, "images": 0}
        self._t0 = time.time()
        # session_id -> MingUniVisionSession, LRU-evicted at max_sessions. The map is
        # touched from the event-loop thread and the executor thread, so it is
        # lock-guarded; each session also has its own lock, so two requests on one
        # session_id cannot interleave KV continuations.
        self._sessions_lock = threading.Lock()
        self._session_locks: dict = {"default": threading.Lock()}
        self._sessions: OrderedDict = OrderedDict([("default", infer.session)])
        self.batch_worker = None
        if batch_slots > 0:
            kw = dict(slots=batch_slots, max_len=batch_max_len, dtype=infer.session._dtype,
                      device=infer.session.device, int_dots=infer.runtime.moe_int_dots,
                      prefill_int_dots=infer.session.prefill_int_dots)
            if paged_kv is None or paged_kv:
                from mingunivision_tpu_torch.engine.paged import PagedBatchingEngine

                engine = PagedBatchingEngine(infer.params["llm"], infer.config.llm, page_size=page_size,
                                             num_pages=num_pages, prefix_cache=prefix_cache, **kw)
            else:
                from mingunivision_tpu_torch.engine.batch_engine import ContinuousBatchingEngine

                engine = ContinuousBatchingEngine(infer.params["llm"], infer.config.llm, **kw)
            self.batch_worker = BatchTextWorker(engine, infer.config.llm.eos_token_id)
        self.image_pool_worker = None
        if image_pool_slots > 0:
            from mingunivision_tpu_torch.engine.image_pool import ImagePoolEngine

            pool = ImagePoolEngine(infer.params, infer.config, infer.runtime, slots=image_pool_slots,
                                   chunk=image_pool_chunk, device=infer.session.device)
            self.image_pool_worker = ImagePoolWorker(pool)

    # -- request handling -----------------------------------------------------

    def _get_session(self, session_id: str):
        with self._sessions_lock:
            if session_id in self._sessions:
                self._sessions.move_to_end(session_id)
                return self._sessions[session_id]
            from mingunivision_tpu_torch.engine.session import MingUniVisionSession

            sess = MingUniVisionSession(self.infer.params, self.infer.config, self.infer.runtime,
                                        device=self.infer.session.device)
            self._sessions[session_id] = sess
            self._session_locks.setdefault(session_id, threading.Lock())
            while len(self._sessions) > self.max_sessions:
                evicted_id, _ = self._sessions.popitem(last=False)
                if evicted_id == "default":  # never evict the default session
                    self._sessions["default"] = self.infer.session
                else:
                    self._session_locks.pop(evicted_id, None)
            return sess

    async def _lock_session(self, session_id: str, timeout: float = 300.0):
        """The per-session lock, held by a request (and a stream, across all its
        chunks); None after `timeout`. Polled from the event loop: blocking in
        the executor would deadlock, since the one executor thread is what the
        holder needs for its next chunk."""
        with self._sessions_lock:
            lock = self._session_locks.setdefault(session_id, threading.Lock())
        deadline = time.time() + timeout
        while not lock.acquire(blocking=False):
            if time.time() > deadline:
                return None
            await asyncio.sleep(0.01)
        return lock

    def _decode_images(self, messages):
        """Inline base64 images ('data:' or raw b64 in image fields) -> PIL."""
        for m in messages:
            content = m.get("content")
            if not isinstance(content, list):
                continue
            for c in content:
                if c.get("type") == "image" and isinstance(c.get("image"), str) \
                        and not c["image"].startswith(("/", "file://")):
                    from PIL import Image

                    raw = c["image"].split(",", 1)[-1]
                    c["image"] = Image.open(io.BytesIO(base64.b64decode(raw))).convert("RGB")
        return messages

    def _run_generate(self, payload: dict) -> dict:
        messages = self._decode_images(payload["messages"])
        self.infer.session = self._get_session(str(payload.get("session_id", "default")))
        if payload.get("reset", False):
            self.infer.reset_inner_state()
        text = self.infer.generate(
            messages,
            max_new_tokens=int(payload.get("max_new_tokens", 512)),
            for_edit=bool(payload.get("for_edit", False)),
            output_image_prefix=payload.get("output_image_prefix", os.path.join(tempfile.gettempdir(), "serve_out")),
            image_gen_text_cfg=float(payload.get("image_gen_text_cfg", 3.0)),
            image_gen_image_cfg=float(payload.get("image_gen_image_cfg", 1.1)),
            image_gen_temperature=float(payload.get("image_gen_temperature", 1.0)),
            do_sample=bool(payload.get("do_sample", False)),
            temperature=float(payload.get("temperature", 1.0)),
            top_k=int(payload.get("top_k", 0)),
            top_p=float(payload.get("top_p", 1.0)),
            n_images=int(payload.get("n_images", 1)),
        )
        images = [_png_b64(img) for img in getattr(self.infer, "last_images", [])]
        self.stats["requests"] += 1
        self.stats["tokens"] += len(text.split())
        self.stats["images"] += len(images)
        return {"ret_code": int(RetCode.OK), "text": text, "images": images}

    def _build_image_batches(self, requests) -> list:
        """Processor outputs of the T2I requests. A request is a `messages`
        list or {"messages": [...], "seed"/"text_cfg"/"image_cfg"/
        "temperature": ...} (per-request generation values, honoured per slot
        in pool mode); each output carries its options under "_opts"."""
        batches = []
        for r in requests:
            opts = r if isinstance(r, dict) and "messages" in r else {}
            messages = self._decode_images(opts.get("messages", r))
            text = self.infer.processor.apply_chat_template(messages, add_generation_prompt=True)
            b = self.infer.processor(text=text, images=self.infer.processor.process_vision_info(messages))
            batches.append({"input_ids": b.input_ids, "attention_mask": b.attention_mask,
                            "uncond_attention_mask": b.uncond_attention_mask,
                            "text_uncond_attention_mask": b.text_uncond_attention_mask, "_opts": opts})
        return batches

    def _run_generate_image_batch(self, payload: dict) -> dict:
        """The T2I requests through ONE barrier batch
        (`serving/image_batch.batched_image_generation`): image i's noise
        seeded `seed + i`."""
        from mingunivision_tpu_torch.serving.image_batch import batched_image_generation

        requests = payload["requests"]
        batches = [{k: v for k, v in b.items() if k != "_opts"} for b in self._build_image_batches(requests)]
        imgs = batched_image_generation(self.infer.params, self.infer.config, self.infer.runtime, batches,
                                        int(payload.get("seed", 0)), device=self.infer.session.device)
        self.stats["requests"] += len(requests)
        self.stats["images"] += len(imgs)
        return {"ret_code": int(RetCode.OK), "images": [_png_b64(im) for im in imgs]}

    @staticmethod
    def _unported_field(payload: dict) -> Optional[str]:
        """Why a request asks for what the port does not run yet, or None."""
        if payload.get("lora") is not None:
            return "a named LoRA adapter is not ported to the PyTorch package yet (ROADMAP.md Queue 1.4)"
        return None

    # -- aiohttp app ----------------------------------------------------------

    def build_app(self):
        from aiohttp import web

        def reply(code: RetCode, http_status: int, **body):
            return web.json_response({"ret_code": int(code), **body}, status=http_status)

        async def read_payload(request, required: str):
            """(payload, None) or (None, a BAD_REQUEST response)."""
            try:
                payload = await request.json()
            except (json.JSONDecodeError, UnicodeDecodeError):
                return None, reply(RetCode.BAD_REQUEST, 400, error="invalid json")
            if not isinstance(payload, dict) or required not in payload:
                return None, reply(RetCode.BAD_REQUEST, 400, error=f"missing {required}")
            why = self._unported_field(payload)
            if why is not None:
                return None, reply(RetCode.BAD_REQUEST, 400, error=why)
            return payload, None

        async def health(request):
            return reply(RetCode.OK, 200, status="healthy", uptime_s=time.time() - self._t0)

        async def metrics(request):
            return reply(RetCode.OK, 200, **self.stats, pending=self.pending)

        async def generate(request):
            if self.pending >= self.max_queue:
                return reply(RetCode.OVERLOADED, 503, error="queue full")
            payload, bad = await read_payload(request, "messages")
            if bad is not None:
                return bad
            sid = str(payload.get("session_id", "default"))
            lock = await self._lock_session(sid)
            if lock is None:
                return reply(RetCode.OVERLOADED, 409, error=f"session {sid!r} busy")
            self.pending += 1
            try:
                result = await asyncio.get_running_loop().run_in_executor(self.executor, self._run_generate, payload)
                return web.json_response(result)
            except Exception as e:  # noqa: BLE001
                self.stats["errors"] += 1
                return reply(RetCode.INTERNAL_ERROR, 500, error=str(e))
            finally:
                self.pending -= 1
                lock.release()

        async def generate_stream(request):
            """One prefill, then KV-cache continuation chunks through
            session.continue_decode: the prompt is never prefilled again."""
            payload, bad = await read_payload(request, "messages")
            if bad is not None:
                return bad
            sid = str(payload.get("session_id", "default"))
            # held for the WHOLE stream: two streams on one session would interleave chunks
            lock = await self._lock_session(sid)
            if lock is None:
                return reply(RetCode.OVERLOADED, 409, error=f"session {sid!r} busy")
            try:
                sse = bool(payload.get("sse", False))
                resp = web.StreamResponse(headers={"Content-Type": "text/event-stream" if sse
                                                   else "text/plain; charset=utf-8", "Cache-Control": "no-cache"})
                await resp.prepare(request)

                def frame(piece: str, done: bool = False) -> bytes:
                    if not sse:
                        return piece.encode()
                    return f"data: {json.dumps({'text': piece, 'done': done}, ensure_ascii=False)}\n\n".encode()

                loop = asyncio.get_running_loop()
                chunk = int(payload.get("stream_chunk_tokens", 16))
                total = int(payload.get("max_new_tokens", 512))
                result = await loop.run_in_executor(self.executor, self._run_generate,
                                                    {**payload, "max_new_tokens": min(chunk, total)})
                await resp.write(frame(result["text"]))
                eos = self.infer.config.llm.eos_token_id
                emitted = chunk
                sess = self._get_session(sid)  # the lock is held: no one swaps it

                def _continue(n):
                    out = sess.continue_decode(n)
                    ids = out.token_ids
                    done = bool(ids) and ids[-1] == eos
                    if done:
                        ids = ids[:-1]
                    self.stats["tokens"] += len(ids)
                    return self.infer.processor.decode(ids), done or not out.token_ids

                while emitted < total:
                    piece, done = await loop.run_in_executor(self.executor, _continue, min(chunk, total - emitted))
                    if piece:
                        await resp.write(frame(piece))
                    emitted += chunk
                    if done:
                        break
                if sse:
                    await resp.write(frame("", done=True))
                await resp.write_eof()
                return resp
            finally:
                lock.release()

        async def generate_batch(request):
            """Text generation through the continuous-batching engine: concurrent
            requests decode in the same engine step."""
            if self.batch_worker is None:
                return reply(RetCode.BAD_REQUEST, 400, error="batching disabled (batch_slots=0)")
            payload, bad = await read_payload(request, "messages")
            if bad is not None:
                return bad
            text = self.infer.processor.apply_chat_template(payload["messages"], add_generation_prompt=True)
            batch = self.infer.processor(text=text)
            sampling = {k: payload[k] for k in ("do_sample", "temperature", "top_k", "top_p") if k in payload}
            item = self.batch_worker.submit(batch.input_ids.reshape(-1), int(payload.get("max_new_tokens", 128)),
                                            sampling)
            finished = await asyncio.get_running_loop().run_in_executor(None, item["event"].wait, 600.0)
            if not finished:
                item["error"] = "batch worker timeout"
            if item.get("error") or item["req"] is None:
                self.stats["errors"] += 1
                return reply(RetCode.INTERNAL_ERROR, 500, error=item.get("error", "admission failed"))
            ids = item["req"].tokens
            if ids and ids[-1] == self.infer.config.llm.eos_token_id:
                ids = ids[:-1]
            self.stats["requests"] += 1
            self.stats["tokens"] += len(ids)
            return reply(RetCode.OK, 200, text=self.infer.processor.decode(ids))

        async def generate_image_batch(request):
            """Several T2I requests: one barrier batch, or with the image pool
            each request admitted into a free slot (concurrent POSTs share the
            pool mid-loop), request i seeded `seed + i` unless it names its own."""
            try:
                payload = await request.json()
            except (json.JSONDecodeError, UnicodeDecodeError):
                return reply(RetCode.BAD_REQUEST, 400, error="invalid json")
            if not isinstance(payload, dict) or not payload.get("requests"):
                return reply(RetCode.BAD_REQUEST, 400, error="missing requests")
            loop = asyncio.get_running_loop()
            if self.image_pool_worker is None:
                try:
                    return web.json_response(await loop.run_in_executor(self.executor, self._run_generate_image_batch,
                                                                        payload))
                except Exception as e:  # noqa: BLE001
                    self.stats["errors"] += 1
                    return reply(RetCode.INTERNAL_ERROR, 500, error=str(e))
            try:
                batches = await loop.run_in_executor(self.executor, self._build_image_batches, payload["requests"])
            except Exception as e:  # noqa: BLE001
                self.stats["errors"] += 1
                return reply(RetCode.INTERNAL_ERROR, 500, error=str(e))
            seed = int(payload.get("seed", 0))
            items = []
            for i, b in enumerate(batches):
                opts = b.pop("_opts", {})
                gen = {k: float(opts[k]) for k in ("text_cfg", "image_cfg", "temperature") if k in opts}
                items.append(self.image_pool_worker.submit(b, int(opts.get("seed", seed + i)), gen))
            images = []
            for item in items:
                if not await loop.run_in_executor(None, item["event"].wait, 600.0):
                    item["error"] = "image pool timeout"
                if item.get("error"):
                    self.stats["errors"] += 1
                    return reply(RetCode.INTERNAL_ERROR, 500, error=item["error"])
                images.append(_png_b64(item["req"].image))
            self.stats["requests"] += len(items)
            self.stats["images"] += len(items)
            return reply(RetCode.OK, 200, images=images)

        def refused(why: str):
            async def handler(request):
                return reply(RetCode.BAD_REQUEST, 400, error=why)
            return handler

        app = web.Application()
        app.router.add_get("/health", health)
        app.router.add_get("/metrics", metrics)
        app.router.add_post("/generate", generate)
        app.router.add_post("/generate_stream", generate_stream)
        app.router.add_post("/generate_batch", generate_batch)
        app.router.add_post("/generate_image_batch", generate_image_batch)
        app.router.add_post("/tts", refused("/tts is not ported to the PyTorch package yet (ROADMAP.md Queue 1.7)"))
        return app

    def run(self):  # pragma: no cover - blocking entry
        from aiohttp import web

        web.run_app(self.build_app(), host=self.host, port=self.port)
