"""PyTorch port: what surrounds the one-launch paged decode-attention kernel, on the CPU.

- Its workspace (`paged_attention.workspace_sizes`), the pure function of the
  shapes that the wrapper sizes it by, against a walk over the kernel's
  splits at page 64 (one page a split) and 32 (two), and the buffers kept per
  device and stream (decode attention's, shared).
- A plain-torch model of the page-split merge that `csrc/paged_attention.cu`
  computes (per 64-position split of a row's valid positions, read through
  the block table: the partial (m, l, acc); the partials merged by
  log-sum-exp in split order; a row of length 0 gives zeros), held against
  the plain version and against the JAX package's Pallas kernel in interpret
  mode on the same numpy-seeded inputs, in fp32.
- The wrapper's argument checks (`paged_attention.check_inputs`), case by case.

The kernel itself runs on the card only (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mingunivision_tpu.ops.kernels.paged_attention import pallas_paged_decode_attention
from mingunivision_tpu_torch.ops.kernels import paged_attention as pa
import test_torch_common  # noqa: F401  (one torch thread per test worker)

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32: the same sums in another order
LOG2E = 1.4426950408889634
LENGTHS = (0, 1, 63, 64, 65, 2047)


# ---------------------------------------------------------------------------
# the workspace
# ---------------------------------------------------------------------------


def _splits(maxp: int, page: int):
    """[(first, end)] of the kernel's splits of a row of maxp * page positions:
    block x of the grid takes positions x * SPLIT_TILE up to the next split."""
    S = maxp * page
    return [(x * pa.SPLIT_TILE, min(S, (x + 1) * pa.SPLIT_TILE)) for x in range(-(-S // pa.SPLIT_TILE))]


@pytest.mark.parametrize("B,Hkv,maxp,page,G,D", [(16, 4, 32, 64, 4, 128), (1, 4, 32, 64, 4, 128),
                                                 (8, 4, 64, 32, 4, 128), (3, 2, 64, 32, 8, 64),
                                                 (2, 1, 5, 48, 1, 64), (4, 2, 7, 16, 2, 128)])
def test_workspace_sizes_cover_every_split(B, Hkv, maxp, page, G, D):
    splits = _splits(maxp, page)
    cover = np.zeros(maxp * page, np.int64)
    for first, end in splits:
        assert 0 < end - first <= pa.SPLIT_TILE
        cover[first:end] += 1
        # the table entries a split reads: one at page 64, two at 32
        entries = set(range(first // page, (end - 1) // page + 1))
        if page in (32, 64):
            assert len(entries) == pa.SPLIT_TILE // page
    np.testing.assert_array_equal(cover, np.ones(maxp * page, np.int64))  # every position in exactly one split
    # per (row, kv head, split): G maxima, G sums, G x D partial sums; a ticket per (row, kv head)
    assert pa.workspace_sizes(B, Hkv, maxp, page, G, D) == (B * Hkv * len(splits) * G * (D + 2), B * Hkv)


def test_workspace_sizes_at_the_serving_shape():
    """The serving engine: 16 slots, 4 kv heads of 4 x 128, page 64, 32 table
    entries (max_len 2048): 32 splits each, 2,048 blocks, about 4 MiB of partials."""
    assert pa.SPLIT_TILE == 64 and len(_splits(32, 64)) == 32
    part_floats, tickets = pa.workspace_sizes(16, 4, 32, 64, 4, 128)
    assert part_floats * 4 == 4_259_840 and tickets == 64


def test_workspace_is_kept_per_stream_and_grows():
    """Decode attention's per-stream buffers serve both kernels: the paged call's sizes take them, and a
    call that needs more grows them."""
    from mingunivision_tpu_torch.ops.kernels import decode_attention as da

    assert pa._workspace is da._workspace
    dev = torch.device("cpu")
    small, large = pa.workspace_sizes(1, 4, 32, 64, 4, 128), pa.workspace_sizes(16, 4, 32, 64, 4, 128)
    part, tickets = pa._workspace(small, dev, stream=2001)
    assert part.numel() == small[0] and tickets.dtype == torch.int32 and not tickets.any()
    assert pa._workspace(small, dev, stream=2001)[0] is part  # reused, not allocated again
    other, _ = pa._workspace(small, dev, stream=2002)
    assert other is not part  # another stream has its own
    grown, grown_tickets = pa._workspace(large, dev, stream=2001)
    assert grown.numel() == large[0] and grown_tickets.numel() == large[1] and not grown_tickets.any()
    assert pa._workspace(small, dev, stream=2001)[0] is grown  # a smaller call keeps the larger buffer
    for key in [(None, 2001), (None, 2002)]:
        da._workspaces.pop(key)


# ---------------------------------------------------------------------------
# the kernel's page-split merge, modelled in plain torch
# ---------------------------------------------------------------------------


def page_split_model(q, k_pages, v_pages, tables, lengths, tile=pa.SPLIT_TILE, scale=None):
    """What csrc/paged_attention.cu computes, in fp32 with the kernel's steps:
    per (row, kv head) the row's first `lengths[b]` positions cut into splits
    of `tile`; each split's K and V rows gathered through the table (a valid
    position's page and offset only: nothing else is read), scores in the
    base-2 domain (q pre-scaled by scale * log2 e), the split's m, l and
    acc = sum p v; then the splits merged in order by log-sum-exp; a row of
    length 0 gives zeros."""
    B, _, Hq, D = q.shape
    Hkv, _, page, _ = k_pages.shape
    G = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    out = torch.zeros(B, 1, Hq, D)
    for b in range(B):
        n = int(lengths[b])
        for h in range(Hkv):
            qg = q[b, 0, h * G:(h + 1) * G].float() * (scale * LOG2E)  # (G, D)
            parts = []
            for first in range(0, n, tile):
                pos = torch.arange(first, min(n, first + tile))
                pid, off = tables[b, pos // page].long(), pos % page
                s = qg @ k_pages[h, pid, off].float().T  # (G, rows)
                m = s.max(-1).values
                p = torch.exp2(s - m[:, None])
                parts.append((m, p.sum(-1), p @ v_pages[h, pid, off].float()))
            if not parts:
                continue
            big = parts[0][0]
            l_tot, acc = parts[0][1], parts[0][2]
            for m, l, a in parts[1:]:  # in split order, as the merging block walks them
                new = torch.maximum(big, m)
                c_old, c_new = torch.exp2(big - new), torch.exp2(m - new)
                l_tot, acc, big = l_tot * c_old + l * c_new, acc * c_old[:, None] + a * c_new[:, None], new
            out[b, 0, h * G:(h + 1) * G] = acc / l_tot.clamp_min(1e-30)[:, None]
    return out


def _paged_inputs(G, D, page, Hkv=2, seed=3):
    """numpy (q, k_pages, v_pages, tables, lengths): one row per length of
    LENGTHS, page ids shuffled over the pool, the 65-long row sharing the
    2047-long row's first page (a prefix-cache hit), every unused table entry
    on the scratch page P, and a few pages no row owns."""
    rng = np.random.default_rng(seed + 7 * G + D + page)
    lengths = np.asarray(LENGTHS, np.int32)
    B = len(lengths)
    maxp = -(-2047 // page)
    need = [-(-int(n) // page) for n in lengths]
    P = sum(need) + 3
    perm = list(rng.permutation(P))
    tables = np.full((B, maxp), P, np.int32)
    for b in (5, 0, 1, 2, 3, 4):
        shared = [tables[5, 0]] if b == 4 else []
        tables[b, :need[b]] = shared + [perm.pop() for _ in range(need[b] - len(shared))]
    q = rng.standard_normal((B, 1, Hkv * G, D), dtype=np.float32)
    kp = rng.standard_normal((Hkv, P + 1, page, D), dtype=np.float32)
    vp = rng.standard_normal((Hkv, P + 1, page, D), dtype=np.float32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("G,D,page", [(1, 64, 64), (4, 64, 64), (8, 64, 64), (1, 128, 64), (4, 128, 64),
                                      (8, 128, 64), (4, 128, 32), (8, 64, 32)])
def test_page_split_model_matches_plain_and_pallas(G, D, page):
    q, kp, vp, tables, lengths = _paged_inputs(G, D, page)
    assert tables[4, 0] == tables[5, 0] and (tables == kp.shape[1] - 1).any()  # a shared page, scratch entries
    tq, tk, tv, tt, tl = map(torch.from_numpy, (q, kp, vp, tables, lengths))
    got = page_split_model(tq, tk, tv, tt, tl)
    plain = pa.paged_gather_attention(tq, tk, tv, tt, tl)
    torch.testing.assert_close(got, plain, **TOL)
    want = np.asarray(pallas_paged_decode_attention(*(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
                                                    interpret=True))
    rows = lengths > 0  # the Pallas kernel's length-0 row holds a masked average, not zeros
    np.testing.assert_allclose(got.numpy()[rows], want[rows], **TOL)
    assert not got[~torch.from_numpy(rows)].any()


@pytest.mark.parametrize("page", [64, 32])
def test_page_split_model_never_reads_scratch_tail_or_unused_pages(page):
    """NaN in the scratch page, in every page's positions at or past its row's
    length and in every page no row owns, Inf in the same places of V: the
    model, which gathers the valid positions only, agrees with the plain
    version on the clean pool."""
    q, kp, vp, tables, lengths = _paged_inputs(4, 128, page)
    P1 = kp.shape[1]
    valid = np.zeros((P1, page), bool)
    for b, n in enumerate(lengths):
        for i in range(-(-int(n) // page)):
            valid[tables[b, i], :min(page, int(n) - i * page)] = True
    assert (~valid).any(axis=1).sum() > 3  # tails, the scratch page and the unowned pages are poisoned
    kq, vq = kp.copy(), vp.copy()
    kq[:, ~valid] = np.nan
    vq[:, ~valid] = np.inf
    got = page_split_model(*map(torch.from_numpy, (q, kq, vq, tables, lengths)))
    assert torch.isfinite(got).all()
    clean = pa.paged_gather_attention(*map(torch.from_numpy, (q, kp, vp, tables, lengths)))
    torch.testing.assert_close(got, clean, **TOL)


def test_page_split_model_does_not_depend_on_split_size_beyond_rounding():
    """Splits of one page (64) and of four (256) give the same result within
    fp32 rounding: the merge is exact log-sum-exp algebra."""
    args = tuple(map(torch.from_numpy, _paged_inputs(4, 128, 64)))
    torch.testing.assert_close(page_split_model(*args, tile=64), page_split_model(*args, tile=256), **TOL)


def test_paged_wrapper_on_cpu_takes_the_plain_version_without_a_workspace():
    args = tuple(map(torch.from_numpy, _paged_inputs(4, 64, 64)))
    from mingunivision_tpu_torch.ops.kernels import decode_attention as da

    before, spaces = pa.paged_decode_attention.launches, dict(da._workspaces)
    torch.testing.assert_close(pa.paged_decode_attention(*args), pa.paged_gather_attention(*args))
    assert pa.paged_decode_attention.launches == before and da._workspaces == spaces


# ---------------------------------------------------------------------------
# the wrapper's argument checks
# ---------------------------------------------------------------------------


def _bf16_inputs(B=2, Hq=8, Hkv=2, D=128, page=64, maxp=4, P=6):
    q = torch.zeros(B, 1, Hq, D, dtype=torch.bfloat16)
    kp = torch.zeros(Hkv, P + 1, page, D, dtype=torch.bfloat16)
    return q, kp, kp.clone(), torch.zeros(B, maxp, dtype=torch.int32), torch.ones(B, dtype=torch.int32)


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


_CONTRACT = {
    "serving-shape": (lambda a: a, True),
    "d64-g1": (lambda a: _bf16_inputs(Hq=2, D=64), True),
    "g8": (lambda a: _bf16_inputs(Hq=16), True),
    "page32": (lambda a: _bf16_inputs(page=32, maxp=64), True),
    "page-1": (lambda a: _bf16_inputs(page=1, maxp=9), True),
    "q-noncontiguous": (lambda a: (a[0].transpose(0, 2).contiguous().transpose(0, 2), *a[1:]), True),  # copied
    "d96": (lambda a: _bf16_inputs(D=96), False),
    "g9": (lambda a: _bf16_inputs(Hq=18), False),
    "hq-not-multiple": (lambda a: _bf16_inputs(Hq=7), False),
    "page128": (lambda a: _bf16_inputs(page=128), False),
    "two-tokens": (lambda a: (a[0].repeat(1, 2, 1, 1), *a[1:]), False),
    "fp32-q": (lambda a: (a[0].float(), *a[1:]), False),
    "fp16-pages": (lambda a: (a[0], a[1].half(), a[2].half(), *a[3:]), False),
    "kv-shapes-differ": (lambda a: (a[0], a[1], a[2][:, :-1].contiguous(), *a[3:]), False),
    "pages-noncontiguous": (lambda a: (a[0], a[1].transpose(0, 1).contiguous().transpose(0, 1), *a[2:]), False),
    "pages-misaligned": (lambda a: (a[0], _misaligned(a[1]), *a[2:]), False),
    "int64-tables": (lambda a: (*a[:3], a[3].long(), a[4]), False),
    "int64-lengths": (lambda a: (*a[:4], a[4].long()), False),
    "tables-rows": (lambda a: (*a[:3], a[3][:1], a[4]), False),
    "lengths-rows": (lambda a: (*a[:4], a[4][:1]), False),
    "tables-noncontiguous": (lambda a: (*a[:3], a[3].t().contiguous().t(), a[4]), False),
}


@pytest.mark.parametrize("case", list(_CONTRACT))
def test_paged_attention_contract(case):
    make, takes = _CONTRACT[case]
    args = make(_bf16_inputs())
    if not takes:
        with pytest.raises(ValueError):
            pa.check_inputs(*args)
        return
    q, G = pa.check_inputs(*args)
    assert q.is_contiguous() and torch.equal(q, args[0]) and G == args[0].shape[2] // args[1].shape[0]
