#!/usr/bin/env python3
"""K1's drain against variants of its copy and against a plain copy of the
same bytes, timed cold on one GPU.

Builds ``tools/k1_variants.cu`` (into ``build/tools/``) and times, through
``chip_smoke.py``'s profiler helpers, each variant's device time a call,
cold (each call the next of ``chip_smoke.cold_sets`` buffer sets, so the
bytes come from HBM) and L2-warm (the same set every call):

  kept     ``staged_scatter_planes``, the repo's kernel
  0-2      the vector copy at 8 x 2 (the kept shape), 8 x 4 and 4 x 4
           16-byte loads a thread (layers a block x vectors of a row)
  3-5      a TMA bulk copy, global -> shared -> global, one warp a block
           (one thread issues), 1, 4 and 8 layers a block

at the paged engine's drain (the K and V planes ``[24, 16384, 2048]`` bf16,
64 int64 rows, all valid), one plane of it, and granite-moe-3b-a800m's
decode-step drain (``dest[320,1536]``, 64 staged rows; kept, 0 and 3).
Each variant's result is held ``torch.equal`` to the plain version. Beside
them, ``copy_``: one contiguous ``Tensor.copy_`` that reads and writes as
many bytes as the drain (cold), and one of 4x those bytes, whose two times
give the card's copy rate and fixed cost.

    python3 tools/k1_variants.py

Needs a CUDA device and ``nvcc``; prints the card and, as its last line,
one JSON object.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

VARIANTS = ["kept", 0, 1, 2, 3, 4, 5]


def load():
    out_dir = os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "k1_variants.so")
    subprocess.run([cs.kbuild.find_nvcc(), "-O3", "-arch=sm_90a", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(ROOT, "tools", "k1_variants.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.k1v_launch.argtypes = [i32, i32, vp, vp, i64, i64, i64, i32, i32,
                               vp, vp, i32, vp]
    lib.k1v_launch.restype = i32
    return lib


def main():
    lib = load()
    print(cs.phase_env(), flush=True)
    cs.phase_build()
    dev = cs.DEV

    def launch(var, planes, rows, ok):
        d, st = planes[0]
        arr = (ctypes.c_void_p * len(planes))
        err = lib.k1v_launch(
            var, len(planes), arr(*[p.data_ptr() for p, _ in planes]),
            arr(*[s.data_ptr() for _, s in planes]), d.shape[-1] * 2,
            d.stride(0) * 2, st.stride(0) * 2, d.shape[0], d.shape[1],
            rows.data_ptr(), ok.data_ptr(), rows.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant {var}: CUDA error {err}")

    def drain(var, ok):
        if var == "kept":
            return lambda planes, rows: cs.staged_scatter_planes(planes,
                                                                 rows, ok)
        return lambda planes, rows: launch(var, planes, rows, ok)

    def run(tag, sets, ok, variants):
        res = {}
        for var in variants:
            planes, rows = sets[0]
            want = [p.clone() for p, _ in planes]
            cs.staged_scatter_planes_ref(
                [(w, s) for w, (_, s) in zip(want, planes)], rows, ok)
            got = [p.clone() for p, _ in planes]
            drain(var, ok)([(g, s) for g, (_, s) in zip(got, planes)], rows)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{tag} variant {var}: not equal to "
                                     f"the plain version")
            fn = drain(var, ok)
            res[str(var)] = dict(
                cold_ms=cs.device_ms(cs.rotating(sets, fn), f"{tag} {var}"),
                warm_ms=cs.device_ms(lambda: fn(*sets[0]),
                                     f"{tag} {var} warm"))
        return res

    def copy_ms(nbytes, what):
        """A contiguous copy reading and writing ``nbytes`` in all, cold."""
        n = cs.cold_sets(nbytes)
        pairs = [(torch.empty(nbytes // 2, dtype=torch.uint8, device=dev),
                  torch.randint(0, 255, (nbytes // 2,), dtype=torch.uint8,
                                device=dev)) for _ in range(n)]
        return cs.device_ms(cs.rotating(pairs, lambda d, s: d.copy_(s)), what)

    out = {}
    gen = cs.timed_gen(101)
    l, r, w, n = 24, 16384, 2048, 64
    stores = [torch.zeros((l, r + 16, w), dtype=torch.bfloat16, device=dev)
              for _ in range(2)]
    nbytes = 2 * 2 * n * w * 2 * l
    sets = [([(st[:, :r], torch.randn((l, n, w), generator=gen,
                                      device=dev).to(torch.bfloat16))
              for st in stores],
             torch.randperm(r, generator=gen, device=dev)[:n])
            for _ in range(cs.cold_sets(nbytes))]
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    out["paged_kv"] = run("K and V", sets, ok, VARIANTS)
    out["paged_kv"]["bytes"] = nbytes
    out["paged_kv"]["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
    out["paged_kv"]["copy_ms"] = copy_ms(nbytes, "copy_ K and V bytes")
    one = [([p], rows) for planes, rows in sets for p in planes]
    out["one_plane"] = run("one plane", one, ok, VARIANTS)
    out["one_plane"]["copy_ms"] = copy_ms(nbytes // 2, "copy_ one plane")
    out["copy_4x_ms"] = copy_ms(4 * nbytes, "copy_ 4x")
    rate = 3 * nbytes / (out["copy_4x_ms"] - out["paged_kv"]["copy_ms"])
    out["copy_rate_bytes_per_ms"] = rate
    out["copy_fixed_ms"] = out["paged_kv"]["copy_ms"] - nbytes / rate
    del stores, sets, one
    torch.cuda.empty_cache()
    dest, staging, dst, okm = cs._moe_k1_inputs(cs.timed_gen(121),
                                                cs.MOE["n_slots"])
    nb = 2 * int(okm.sum()) * staging.shape[1] * 2 + dst.numel() * 9
    msets = [([(dest.clone()[None], staging.clone()[None])], dst.contiguous())
             for _ in range(cs.cold_sets(nb))]
    out["moe"] = run("MoE", msets, okm.contiguous(), ["kept", 0, 3])
    out["moe"]["bound_ms"] = nb / cs.HBM_BYTES_PER_S * 1e3
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
