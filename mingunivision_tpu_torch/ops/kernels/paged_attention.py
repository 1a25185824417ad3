"""One-token GQA decode attention over a block-paged KV pool: the CUDA kernel
`csrc/paged_attention.cu` and its plain version.

Replaces both TPU entries of mingunivision_tpu/ops/kernels/paged_attention.py,
`pallas_paged_decode_attention` (-> `_paged_decode_kernel`) and
`paged_decode_attention_auto` (the JAX library's multi-page kernel): they
compute the same function. What bounds it on the H100 is the bytes of K and
V at the rows' valid positions; the kernel reads only those, through the
block tables, with one CTA per (split of 8 pages, kv head, row) and a
log-sum-exp combine of the splits (see the source).

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

import torch

from mingunivision_tpu_torch.ops.attention import mha
from mingunivision_tpu_torch.ops.kernels import build

PAGES_PER_SPLIT = 8  # the kernel's pages per CTA


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


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *, scale=None):
    """Single-token attention through the block tables -> (B, 1, Hq, D)."""
    if q.device.type == "cpu":
        return paged_gather_attention(q, k_pages, v_pages, tables, lengths, scale=scale)
    B, T, Hq, D = q.shape
    Hkv, P1, page, Dk = k_pages.shape
    if T != 1 or Hq % Hkv or Hq // Hkv > 8 or D not in (64, 128) or Dk != D or not 0 < page <= 64:
        raise ValueError(f"paged_decode_attention: unsupported q {tuple(q.shape)} for pages {tuple(k_pages.shape)}")
    q = q.contiguous()
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous, 16-byte aligned bf16 tensor on "
                             f"{q.device}")
    if tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError("paged_decode_attention: k/v pages must be (Hkv, P+1, page, D)")
    for name, t, shape in (("tables", tables, (B, tables.shape[-1])), ("lengths", lengths, (B,))):
        if t.dtype != torch.int32 or t.device != q.device or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous int32 {shape} tensor on {q.device}")
    maxp = tables.shape[1]
    nsplit = -(-maxp // PAGES_PER_SPLIT)
    G = Hq // Hkv
    o_part = torch.empty((B, Hkv, nsplit, G, D), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((B, Hkv, nsplit, 2, G), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = build.load().mu_paged_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
        o_part.data_ptr(), ml_part.data_ptr(), out.data_ptr(), B, Hkv, G, P1, page, D, maxp,
        float(D**-0.5 if scale is None else scale), build.stream_handle(q),
    )
    build.check(rc, "mu_paged_attention_bf16")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
