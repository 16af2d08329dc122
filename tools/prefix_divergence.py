#!/usr/bin/env python3
"""Where a prefix-cached pass first parts from the cold pass of the same
requests, on one GPU.

Serves ``chip_smoke.py``'s prefix traffic (stablelm-1.6b at full width, 24
layers, bf16, 16 requests opening with the same 1024 tokens, chunked at 16,
8 slots) cold on a fresh engine and then again after
``reset(keep_cache=True)`` (the REPEAT pass: every full prompt page
cached), and fingerprints every row each pass computes, in every layer:
the row's new key and value (``project_kv``), its query (``project_q``),
the attention read's output (``flash_decode_paged``), the attention
block's output and the MLP's. A fingerprint is an exact function of the
row's bits (a weighted sum of its 16-bit words). For each request it
prints the first row (position, and its token's index in the stream) where
the two passes' fingerprints differ, the first layer and stage there, and
how that row ran in each pass: in a mixed-phase step (C = 16) or a decode
step (C = 1), its write staged or direct, and how many of its slot's rows
sat in the staging ring at the read. It also checks that the 1024 shared
prompt rows come out bit-equal in every slot that computes them in the
cold pass (the repeat pass reads the first registrant's copy).

    python3 tools/prefix_divergence.py [--path adaptive|staged|direct]

Needs a CUDA device and ``nvcc``. The last line of the output is one JSON
object.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

STAGES = ("k", "v", "q", "read", "attn", "mlp")


class Recorder:
    """Fingerprints of every computed row, keyed by (pass, request,
    position) -> {(layer, stage): int}, and each row's step facts."""

    def __init__(self, sch, n_layers):
        self.sch, self.n_layers = sch, n_layers
        self.pass_name = None
        self.ctx = None
        self.fp = {}
        self.facts = {}
        gen = torch.Generator(device=cs.DEV).manual_seed(5)
        self.w = torch.randint(1, 1 << 20, (1 << 13,), generator=gen,
                               device=cs.DEV)

    def begin(self, kind, positions, valid, unload, cache):
        """A model call starts: the rows it computes, as host lists."""
        st = self.sch.slots
        req = st.req_id.tolist()
        pos = positions.tolist()
        ok = valid.tolist()
        ring_live = ((cache["ring_pos"] >= 0).sum(1).tolist()
                     if "ring_pos" in cache else [0] * len(req))
        stg = unload.tolist() if unload is not None else [False] * len(req)
        rows = [(b, j) for b in range(len(req)) for j in range(len(pos[b]))
                if ok[b][j] and req[b] >= 0]
        keys = [(self.pass_name, req[b], pos[b][j]) for b, j in rows]
        for (b, j), key in zip(rows, keys):
            self.facts[key] = dict(kind=kind, staged=bool(stg[b]) and j == 0,
                                   ring_live=ring_live[b])
        self.ctx = dict(layer=0, keys=keys,
                        b=torch.tensor([r[0] for r in rows], device=cs.DEV,
                                       dtype=torch.long),
                        j=torch.tensor([r[1] for r in rows], device=cs.DEV,
                                       dtype=torch.long))

    def put(self, stage, t):
        """Fingerprint rows (b, j) of ``t`` [B, C, ...] for ``stage``."""
        c = self.ctx
        if c is None or not c["keys"]:
            return
        rows = t[c["b"], c["j"]].reshape(len(c["keys"]), -1).contiguous()
        bits = (rows.view(torch.int16) if rows.element_size() == 2
                else rows.view(torch.int32)).long()
        fps = (bits * self.w[:bits.shape[1]]).sum(1).tolist()
        layer = c["layer"]
        for key, f in zip(c["keys"], fps):
            self.fp.setdefault(key, {})[(layer, stage)] = f


def install(model, rec):
    """Wrap the model's two paged calls and the layer functions they run."""
    step, chunk = model.decode_step_paged, model.decode_chunk_paged

    def decode_step(cache, tokens, pos, write_mask, unload_mask=None, **kw):
        rec.begin("decode", pos[:, None], write_mask[:, None],
                  unload_mask, cache)
        try:
            return step(cache, tokens, pos, write_mask,
                        unload_mask=unload_mask, **kw)
        finally:
            rec.ctx = None

    def decode_chunk(cache, tokens, start, n_valid, write_mask,
                     unload_mask=None, **kw):
        c = tokens.shape[1]
        offs = torch.arange(c, device=tokens.device)
        positions = start.long()[:, None] + offs[None]
        valid = (offs[None] < n_valid[:, None]) & write_mask[:, None]
        rec.begin("mixed", positions, valid, unload_mask, cache)
        try:
            return chunk(cache, tokens, start, n_valid, write_mask,
                         unload_mask=unload_mask, **kw)
        finally:
            rec.ctx = None

    model.decode_step_paged, model.decode_chunk_paged = (decode_step,
                                                         decode_chunk)
    project_kv, project_q = L.project_kv, L.project_q
    fused, mlp = L.fused_paged_attention, L.apply_mlp
    read = K.flash_decode_paged

    def kv(*a, **k):
        kk, vv = project_kv(*a, **k)
        rec.put("k", kk)
        rec.put("v", vv)
        return kk, vv

    def q(*a, **k):
        out = project_q(*a, **k)
        rec.put("q", out)
        return out

    def kernel(*a, **k):
        out = read(*a, **k)
        rec.put("read", out)
        return out

    def attn(*a, **k):
        out = fused(*a, **k)
        rec.put("attn", out)
        return out

    def mlp_out(*a, **k):
        out = mlp(*a, **k)
        rec.put("mlp", out)
        if rec.ctx is not None:
            rec.ctx["layer"] += 1
        return out

    L.project_kv, L.project_q = kv, q
    L.fused_paged_attention, L.apply_mlp = attn, mlp_out
    K.flash_decode_paged = kernel


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default=cs.SLICE["path"])
    args = ap.parse_args(argv)
    card = cs.phase_env()
    cs.phase_build()
    cfg, model = cs._slice_model()
    shape = dict(cs.SLICE, chunked=True, chunk_size=cs.CHUNK, path=args.path)
    eng = cs.Engine.from_config(cs.EngineConfig(
        **shape, memory=cs.MemoryConfig(prefix_cache=True)), model)
    sch = eng.scheduler
    sp = cs.SamplingParams(max_tokens=cs.NEW_TOKENS)

    def queue():
        return cs.synthetic_requests(cs.N_REQUESTS, cs.PREFIX_LENS, cfg.vocab,
                                     cs.NEW_TOKENS, params=sp,
                                     shared_prefix=cs.PREFIX_SHARED)

    rec = Recorder(sch, cfg.n_layers)
    install(model, rec)
    outs = {}
    for name in ("cold", "repeat"):
        if name == "repeat":
            eng.reset(keep_cache=True)
        rec.pass_name = name
        outs[name] = eng.serve(queue())
    torch.cuda.synchronize()
    plens = {rid: cs.PREFIX_LENS[rid % len(cs.PREFIX_LENS)]
             for rid in outs["cold"]}
    order = [(layer, s) for layer in range(cfg.n_layers) for s in STAGES]
    report = {}
    for rid in sorted(outs["cold"]):
        diff = cs._stream_diff({0: outs["repeat"][rid]},
                               {0: outs["cold"][rid]})
        first = None
        both = sorted(p for (ps, r, p) in rec.fp
                      if ps == "cold" and r == rid
                      and ("repeat", rid, p) in rec.fp)
        for p in both:
            a, b = rec.fp[("cold", rid, p)], rec.fp[("repeat", rid, p)]
            bad = [ls for ls in order if a.get(ls) != b.get(ls)]
            if bad:
                first = dict(position=p, token_index=p - plens[rid] + 1,
                             layer=bad[0][0], stage=bad[0][1],
                             stages_differing_there=sorted(
                                 {s for (lay, s) in bad if lay == bad[0][0]}),
                             cold=rec.facts[("cold", rid, p)],
                             repeat=rec.facts[("repeat", rid, p)])
                break
        report[rid] = dict(plen=plens[rid],
                           stream_first_diff=diff.get(0),
                           rows_compared=len(both), first_row_diff=first)
        print(json.dumps({"request": rid, **report[rid]}), flush=True)
    # the shared prompt rows: bit-equal in every cold slot that computed
    # them (the repeat pass reads the first registrant's copy)
    shared = {}
    for rid in sorted(outs["cold"]):
        rows = [p for p in range(cs.PREFIX_SHARED)
                if ("cold", rid, p) in rec.fp]
        if rows:
            shared[rid] = rows
    ref = min(shared) if shared else None
    mismatch = {}
    for rid, rows in shared.items():
        n = sum(1 for p in rows if rec.fp[("cold", rid, p)]
                != rec.fp[("cold", ref, p)])
        mismatch[rid] = n
    out = dict(card=card, path=args.path,
               requests=report,
               shared_rows_computed_by=sorted(shared),
               shared_rows_differing_from_request_0=mismatch)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
