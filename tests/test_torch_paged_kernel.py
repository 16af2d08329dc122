"""The Python side of K2 ``flash_decode_paged``'s Hopper kernel, on the CPU:
its split plan, its shared memory, what ``paged_kernel_plan`` refuses, that
the pages the kernel leaves unread add nothing to the output, and the
build's hash over the headers the kernels include. The kernel itself is held against the plain version on the
card by ``chip_smoke.py``; the plain version against the JAX package by
``tests/test_torch_kernels.py``."""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import build

FD = importlib.import_module("repro_torch.kernels.flash_decode")

torch.set_num_threads(1)

def test_paged_split_plan_at_the_slice_shape():
    """stablelm-1.6b at 8 slots (32 heads of 64, 128 pages of 16, ring of 8,
    bf16): 256 (slot, head) clusters; two blocks fit an SM, so 132 SMs hold
    one wave of 256 blocks at one split each, 66 SMs still one, 264 SMs
    two."""
    smem = FD.paged_smem_bytes(2, 64, 1, 1, 128, 16, 8)
    assert FD._SMEM_PER_SM // (smem + 1024) == 2
    args = (8, 32, 1, 129, 128 * 16 + 8, smem)
    assert FD._paged_splits(132, *args) == 1
    assert FD._paged_splits(66, *args) == 1
    assert FD._paged_splits(264, *args) == 2
    # one (slot, head): the cluster takes the most splits, 8
    assert FD._paged_splits(132, 1, 1, 1, 129, 128 * 16 + 8, smem) == 8


@pytest.mark.parametrize("sms,want", [(66, 4), (132, 8), (264, 8)])
@pytest.mark.parametrize("shape", [(1, 32, 32, 64), (8, 28, 4, 128)],
                         ids=["stablelm-C1", "qwen2-7b-C8"])
def test_paged_split_plan_for_one_slot(shape, sms, want):
    """One request decoding alone over a 2048-row view (128 pages of 16,
    ring of 8): stablelm-1.6b's 32 (slot, head) clusters, two blocks an SM,
    and qwen2-7b's GQA 28/4 at C = 8, 4 groups of 16 of its 56 query rows
    on each of 4 KV heads, one block an SM, both take 8 splits on 132 SMs,
    4 on 66."""
    c, hq, hkv, d = shape
    q = torch.zeros(1, c, hq, d, dtype=torch.bfloat16)
    pk = torch.zeros(2, 16, hkv, d, dtype=torch.bfloat16)
    rk = torch.zeros(1, 8, hkv, d, dtype=torch.bfloat16)
    blocks = torch.zeros(1, 128, dtype=torch.int32)
    assert FD.paged_kernel_plan(q, pk, pk, blocks, rk, rk, sms) == want


@pytest.mark.parametrize("sms", [16, 66, 132, 264, 1000])
@pytest.mark.parametrize("case", [(1, 1, 4, 65, 1032), (2, 4, 56, 13, 200),
                                  (8, 32, 1, 129, 2056), (3, 2, 8, 1, 5),
                                  (1, 1, 1, 1, 1)],
                         ids=lambda c: "-".join(map(str, c)))
def test_paged_split_plan_bounds(sms, case):
    """At most 8 splits a cluster (the portable cluster size), at least one,
    never more than the units or the block-wide rounds of 16-key chunks, and
    a function of the shapes and the SM count alone."""
    b, hkv, rows, units, keys = case
    smem = FD.paged_smem_bytes(2, 64, 1, 1, units, 8, 0)
    n = FD._paged_splits(sms, b, hkv, rows, units, keys, smem)
    assert 1 <= n <= FD.MAX_SPLIT
    assert n <= units and n <= -(-keys // (16 * FD.PAGED_WARPS[2]))
    assert n == FD._paged_splits(sms, b, hkv, rows, units, keys, smem)


@pytest.mark.parametrize("es", [2, 4])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_paged_smem_fits_a_block(es, d):
    """As ``Smem`` and ``Tables`` in the source: the warps' rings, the query
    rows, the key words, then the slot's tables. Every block of the slice
    (C = 1 and C = 8, GQA 28/4) fits the 227 KB a block may use."""
    dp = 64 if d <= 64 else 128
    warps, stages = FD.PAGED_WARPS[es], FD.PAGED_STAGES[es]
    stride = dp + 16 // es
    chunk = 16 * dp * 2 if es == 2 else 16 * stride * 4
    fixed = (warps * stages * 2 * chunk + 16 * stride * es
             + warps * stages * 16 * 4)
    p, ps, r, c = 128, 16, 8, 1
    n_words = 4 * (p * ps // 128)
    want = fixed + 4 * 2 * n_words + 4 * p + 4 * (p + 1) + c + r
    want = ((want + 3) & ~3) + 16
    assert FD.paged_smem_bytes(es, d, c, 1, p, ps, r) == want <= 227 * 1024
    assert FD.paged_smem_bytes(es, d, 8, 7, p, ps, r) <= 227 * 1024


def _ops(b=2, c=1, hq=4, hkv=2, d=16, nb=6, ps=4, p=3, r=2,
         dtype=torch.bfloat16):
    q = torch.zeros(b, c, hq, d, dtype=dtype)
    pk = torch.zeros(nb, ps, hkv, d, dtype=dtype)
    ring = torch.zeros(b, r, hkv, d, dtype=dtype) if r else None
    blocks = torch.zeros(b, p, dtype=torch.int32)
    return q, pk, pk.clone(), blocks, ring, None if ring is None else ring.clone()


def test_paged_kernel_plan_refuses_what_the_kernel_does_not_take():
    assert FD.paged_kernel_plan(*_ops(), 132) == 1
    assert FD.paged_kernel_plan(*_ops(d=4, dtype=torch.float32), 132) == 1
    assert FD.paged_kernel_plan(*_ops(d=128, r=0), 132) == 1
    with pytest.raises(ValueError):
        FD.paged_kernel_plan(*_ops(d=12), 132)         # not whole 16-byte pieces
    with pytest.raises(ValueError):
        FD.paged_kernel_plan(*_ops(d=136), 132)        # past 128
    with pytest.raises(ValueError):
        FD.paged_kernel_plan(*_ops(p=0, r=0), 132)     # no key at all
    q, pk, pv, blocks, rk, rv = _ops(d=32)
    with pytest.raises(ValueError):                    # a strided pool
        FD.paged_kernel_plan(q, pk[..., :16], pv[..., :16], blocks, None,
                             None, 132)
    qt = torch.zeros(2, 4, 2, 32, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):                    # a strided q
        FD.paged_kernel_plan(qt, pk, pv, blocks, rk, rv, 132)
    q, pk, pv, blocks, rk, rv = _ops()
    buf = torch.zeros(rk.numel() + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                    # an 8-byte aligned ring
        FD.paged_kernel_plan(q, pk, pv, blocks, buf[4:].view(rk.shape), rv,
                             132)
    with pytest.raises(ValueError):                    # tables past 227 KB
        FD.paged_kernel_plan(*_ops(p=20000, ps=1, nb=2), 132)


def _masks(rng, c, p, ps, r, kind):
    vok = rng.rand(c, p * ps) > 0.7
    rok = rng.rand(r) > 0.5
    if kind == "prefix":
        vok[:] = np.arange(p * ps)[None] < rng.randint(1, p * ps)
    elif kind == "sparse":
        vok &= rng.rand(c, p * ps) > 0.9
    elif kind == "ring_only":
        vok[:] = False
        rok[:] = True
    return torch.from_numpy(vok), torch.from_numpy(rok)


def test_reading_only_live_units_changes_no_output():
    """What the kernel leaves unread adds nothing: for a slot without a dead
    row, the plain version over the live units alone (the pages some query
    column sees a key of, compacted; the ring only when a lane is live)
    equals the plain version over the whole view."""
    rng = np.random.RandomState(7)
    c, hq, hkv, d, nb, ps, p, r = 3, 4, 2, 16, 20, 4, 9, 5
    for kind in ("random", "prefix", "sparse", "ring_only"):
        vok, rok = _masks(rng, c, p, ps, r, kind)
        q = torch.from_numpy(rng.randn(1, c, hq, d).astype(np.float32))
        pk = torch.from_numpy(rng.randn(nb, ps, hkv, d).astype(np.float32))
        pv = torch.from_numpy(rng.randn(nb, ps, hkv, d).astype(np.float32))
        blocks = torch.from_numpy(rng.randint(0, nb, (1, p)).astype(np.int32))
        rk = torch.from_numpy(rng.randn(1, r, hkv, d).astype(np.float32))
        rv = torch.from_numpy(rng.randn(1, r, hkv, d).astype(np.float32))
        full = FD.flash_decode_paged_ref(q, pk, pv, blocks, vok[None], rk, rv,
                                         rok[None])
        assert bool((vok.any(1) | rok.any()).all())
        keep = vok.view(c, p, ps).any(2).any(0).nonzero()[:, 0].tolist()
        sub_vok = vok.view(c, p, ps)[:, keep].reshape(1, c, -1)
        ring = (rk, rv, rok[None]) if rok.any() else (None, None, None)
        part = FD.flash_decode_paged_ref(q, pk, pv, blocks[:, keep], sub_vok,
                                         *ring)
        np.testing.assert_allclose(part.numpy(), full.numpy(), atol=2e-6,
                                   rtol=1e-4)


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """An edit to a header under ``csrc/`` changes the build's hash, so a
    stale library is never reused; the sources' hash covers every header."""
    for f in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [h.name for h in build.headers()] == ["decode_common.cuh",
                                                 "tma_wgmma.cuh"]
    seen = {build._source_hash(build.sources())}
    for name in ("decode_common.cuh", "tma_wgmma.cuh"):
        hdr = tmp_path / name
        hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
        after = build._source_hash(build.sources())
        assert after not in seen, name
        seen.add(after)
    assert build._source_hash(build.sources()) == after
