"""One-token GQA decode attention over a block-paged KV pool: the CUDA kernel
`csrc/paged_attention.cu` and its plain version.

Replaces both TPU entries of mingunivision_tpu/ops/kernels/paged_attention.py,
`pallas_paged_decode_attention` (-> `_paged_decode_kernel`) and
`paged_decode_attention_auto` (the JAX library's multi-page kernel): they
compute the same function. What bounds it on the H100 is the bytes of K and
V at the rows' valid positions, which at the serving engine's batch sizes are
so few that latency sets its time as much. The kernel makes one launch per
call: one block per (SPLIT_TILE-position split, kv head, row), one page each
at the engine's page of 64; a split past the row's length exits at once, the
others copy only their valid rows through the block tables, write an fp32
partial (m, l, acc) to a workspace kept per device and stream (`_workspace`, decode
attention's)
and take a ticket, and the last block of each (row, kv head) merges the
partials by log-sum-exp in page order (see the source).

Layouts, as the JAX module's (the engine's pool adds a leading layer axis):
  q        (B, 1, Hq, D)
  pages    (Hkv, P+1, page, D), head-major; page P is the engine's scratch page
  tables   (B, maxp) int32 page ids
  lengths  (B,) int32 valid positions per row, the token written this step included

A row of length 0 gives zeros (the JAX gather path gives the mean of V there;
the engines never read such a row). The wrapper runs the plain version for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels import build

# The partials' and tickets' buffers, kept per device and stream and grown on demand: decode attention's, shared
# (launches on one stream run in order, each kernel leaves its counters at zero and reads only partials its launch
# wrote).
from mingunivision_tpu_torch.ops.kernels.decode_attention import _workspace

SPLIT_TILE = 64  # positions per split: csrc/paged_attention.cu's kTileS (`mu_paged_attention_tile`)


@functools.lru_cache(maxsize=256)
def workspace_sizes(B: int, Hkv: int, maxp: int, page: int, G: int, D: int) -> tuple[int, int]:
    """The workspace a launch needs for B rows of `maxp` table entries of
    `page` positions, Hkv kv heads of G query heads of width D, cut into
    ceil(maxp * page / SPLIT_TILE) splits per (row, kv head): (fp32 values,
    each split's m and l per head and its G x D sum; int32 tickets, one per
    (row, kv head))."""
    n_split = -(-maxp * page // SPLIT_TILE)
    return B * Hkv * n_split * G * (D + 2), B * Hkv


def paged_gather_attention(q, k_pages, v_pages, tables, lengths, *, scale=None):
    """Plain version: gather each row's pages into a dense (B, Hkv, maxp *
    page, D) view and run the masked `mha` over its first `lengths` positions."""
    B, _, Hq, D = q.shape
    Hkv, _, page, _ = k_pages.shape
    maxp = tables.shape[1]
    ids = tables.long()

    def gather(pages):  # (Hkv, B, maxp, page, D) -> (B, Hkv, maxp * page, D)
        return pages[:, ids].transpose(0, 1).reshape(B, Hkv, maxp * page, D)

    valid = torch.arange(maxp * page, device=q.device)[None, :] < lengths[:, None]
    out = mha(q, gather(k_pages), gather(v_pages), scale=scale, mask=valid[:, None, None, :], kv_head_major=True)
    return torch.where((lengths > 0)[:, None, None, None], out, torch.zeros_like(out))


def check_inputs(q, k_pages, v_pages, tables, lengths):
    """What the kernel takes (the wrapper's checks, callable on any device):
    q (B, 1, Hkv * G, D) with G <= 8 and D 64 or 128, k / v pages (Hkv, P+1,
    page, D) with page <= SPLIT_TILE, all bf16, contiguous, 16-byte aligned;
    int32 contiguous tables (B, maxp) and lengths (B,); one device. Raises
    ValueError on anything else. Returns (q made contiguous, G)."""
    B, T, Hq, D = q.shape
    Hkv, P1, page, Dk = k_pages.shape
    if T != 1 or Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128) or Dk != D or not 0 < page <= SPLIT_TILE:
        raise ValueError(f"paged_decode_attention: unsupported q {tuple(q.shape)} for pages {tuple(k_pages.shape)}")
    if not q.is_contiguous():
        q = q.contiguous()
    dev = q.get_device()
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype is not torch.bfloat16 or t.get_device() != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous, 16-byte aligned bf16 tensor on "
                             f"{q.device}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("paged_decode_attention: k/v pages must be (Hkv, P+1, page, D)")
    for name, t, shape in (("tables", tables, (B, tables.shape[-1])), ("lengths", lengths, (B,))):
        if t.dtype is not torch.int32 or t.get_device() != dev or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous int32 {shape} tensor on {q.device}")
    return q, Hq // Hkv


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *, scale=None):
    """Single-token attention through the block tables -> (B, 1, Hq, D)."""
    if q.device.type == "cpu":
        return paged_gather_attention(q, k_pages, v_pages, tables, lengths, scale=scale)
    q, G = check_inputs(q, k_pages, v_pages, tables, lengths)
    B, D = q.shape[0], q.shape[-1]
    Hkv, P1, page = k_pages.shape[:3]
    maxp = tables.shape[-1]
    out = torch.empty_like(q)
    stream = build.stream_handle(q)
    part, tickets = _workspace(workspace_sizes(B, Hkv, maxp, page, G, D), q.device, stream)
    rc = build.load().mu_paged_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(), B, Hkv, G, P1, page, D, maxp,
        float(D**-0.5 if scale is None else scale), stream,
    )
    build.check(rc, "mu_paged_attention_bf16")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
