#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run ``python3 chip_smoke.py`` from the root of a checkout. It needs a CUDA
device and ``nvcc``; without a GPU it exits non-zero and prints no result.
``python3 chip_smoke.py PHASE [PHASE ...]`` runs env, build, the named
phases and those whose results they take (``PHASES``), and prints no result
line. Phases, each failing the run on any exception or mismatch:

  env      the card's name and power limit, torch / CUDA / nvcc versions
  build    builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
           ``lru_scan.cu``'s kernels must have no stack frame and no spills
  kernels  each kernel against its plain PyTorch version on the card, and
           their times at the shapes the engine phases give them;
           staged_scatter on one plane and on tables of planes (K and V,
           a tp-4 device's eight shards, planes of other widths, layer
           counts and strides, more planes than one launch takes), int32
           and int64 rows, timed as the paged engine's drain of K and V in
           one launch and as the MoE drain, each one device op a call; the CMS
           monitor's step at the write engine's sketch and batch, its
           unfused chain of launches against the fused one (line
           ``cms_monitor_step``); flash_decode_paged at the chunked engine's
           mixed step (C = 16) and flash_attention at the lanes layout's
           chunk prefill (S = 512) under ``chunk_shape``; flash_decode_paged
           at the prefix cache's mixed step (every slot's 64 leading pages
           the same blocks, a cursor past the cached rows, a 1-row chunk at
           ``plen - 1``) under ``prefix_shape``, and such aliased page
           tables among its checked cases; flash_decode_paged_sharded (one
           K2 grid a device over the head shards there: one launch on a
           virtual mesh) on virtual meshes of the card, equal
           to unsharded K2 (``torch.equal``) for the head geometries of
           stablelm-1.6b, qwen2-7b and nemotron-4-15b at tp 2-8, C = 1 and
           16, with and without the ring, fp32 and bf16, and at the main
           path's own shapes (the engine's decode step and the chunked
           mixed step at tp 2 and 4), then checked and timed at the
           engine's shape at tp 4; flash_decode_paged at the speculative
           verify (C = k + 1 = 5, the ring empty and with 3 live lanes) and
           flash_decode at the self-draft's dense lanes (stablelm-1.6b's MHA,
           2048 rows), checked and timed (``verify_shape``,
           ``draft_shape``); lru_scan (the simulator's scan: a stable
           counting sort by cache set, then one thread a set) ``torch.equal``
           to its plain version at the paper workload (200 000 writes) at
           1, 2^12 and 2^20 regions under the offload, unload and hint
           routings, and at 2^20 regions at the paper's 5 000 000 writes
           (offload, unload), and at 2^20 regions at 98 tiles of 2048
           writes with only the last 10 in the last set (the bit map's last
           word), the bucketing that each call ran ``torch.equal`` to
           ``lru_buckets_ref`` in the same cases, and at way counts 1-32
           (``LRU_WAYS``: the chain's other paths), timed at 2^20 regions,
           1, 4 and 16 (the longest chains) and 2^20 at 5 000 000 writes
           beside a bound whose step, a hit and a miss, is the faster of
           two timed alone (``lru_chain_probe``: one thread running only
           the kernel's chain; ``lru_step_probe``: one warp running the
           first design's), with each of its five launches' time and count;
           staged_scatter, flash_attention and flash_decode at
           granite-moe-3b-a800m's shapes (a decode step's expert drain and
           a prefill group's, prefill and lanes chunk attention with GQA
           group 3 and head_dim 64, the decode read), checked and timed
           (``moe_shape``); flash_attention and flash_decode at head_dim
           80 (zamba2-2.7b's shared block: ``q[2,32,S,80]`` at S = T =
           512, 777 and 2048 and at the chunked arm's S = 256 queries over
           T = 512 and 2048 keys, fp32 and bf16; ``q[8,32,80]`` over lanes
           of 1024 and 2560 with ragged masks), checked, and timed at the
           engine's largest prefill call and its decode step
           (``zamba_shape``); flash_attention and flash_decode at
           whisper-medium's shapes (the causal encoder ``q[2,16,1500,64]``,
           the non-causal cross read of S = 64 and 37 queries against 1500
           frames; ``q[8,16,64]`` over 1500 frames all valid and over 448
           lanes with ragged masks), fp32 and bf16, checked and each timed
           (``whisper_shape``); flash_attention and flash_decode at
           llama-3.2-vision-90b's shapes (64 heads of 128 over 8 KV heads:
           the causal prompt ``q[2,64,480,128]``, a 64-token chunk at its
           end, the non-causal cross reads of S = 64, 37 and 480 queries
           against 1601 image keys; ``q[8,64,128]`` over 1601 image keys all
           valid and over 1024 lanes with ragged masks), fp32 and bf16,
           checked and each timed (``vlm_shape``); staged_scatter at the
           lanes ring's drain (each layer's K and V lanes a ``[8 * 1024,
           2048]`` plane, 64 staged entries, full and half full)
           ``torch.equal`` to its plain version, ``staged.drain_ring`` on
           the card equal to the CPU's, and flash_decode over cache ∪ ring
           (``q[8,32,64]`` over 1032 rows under the overlay's mask),
           checked and timed (``lanes_ring_shape``); training's kernels:
           K3's backward (``flash_attention_bwd``, from K3's ``out`` and
           ``lse``) against autograd of the plain version at the training
           microbatch of stablelm-1.6b ``q[4,32,512,64]`` and
           granite-moe-3b-a800m ``q[4,24,512,64]`` over 8 KV heads, a
           window shorter than S, S < T, a non-causal read, the VLM's
           head_dim 128 over GQA group 8 at S = 333 and its cross read of
           64 queries over 1601 keys, the training microbatches of
           zamba2-2.7b's shared block ``q[4,32,512,80]``, whisper-medium's
           causal encoder ``q[4,16,1500,64]`` and its decoder's cross
           read of 448 queries over the 1500 frames, fp32 within TOL_F32
           of the plain
           version in float64 and bf16 by ``held_bf16`` (two bf16 calls
           ``torch.equal``); timed with each of its three launches' share
           (``sub_kernels``), at stablelm's, granite's (``moe_shape``),
           zamba2's (``zamba_shape``) and whisper's encoder
           (``whisper_shape``) shapes; K3 with ``lse`` bit-equal to
           K3 without; K1's functional drain (``staged_drain``) and its
           adjoint ``staged_gather`` ``torch.equal`` to their plain versions
           at granite's training dispatch; both timed (rows
           ``flash_attention_bwd``, ``staged_gather``)
  engine   stablelm-1.6b at full width (bf16, random weights from a seed),
           cut to 4 of its 24 layers (``SLICE_LAYERS``, as engine_sharded
           and engine_chunked), serves 16 requests through
           ``Engine.from_config`` on the paged layout; the launch counts of staged_scatter,
           flash_decode_paged and flash_attention must be non-zero
  engine_sharded  the engine's configuration with ``attention='fused'``
           on a tp-4 virtual mesh of the card (``ParallelConfig.tensor(4)``,
           ``REPRO_TORCH_VIRTUAL_DEVICES``): the pool and ring split on the
           head axis ([SLICE_LAYERS, n_blocks+1, 16, 8, 64] a shard); streams, stats
           and path counts equal the engine phase's, K1 and the sharded K2
           launched once per device per drain or read (as often as the
           engine phase's K1 and K2), K2 alone never; a decode segment
           profiled against the engine's. Then tp 2,
           chunked at 16 with the prefix cache and the host tier on the
           staged path over a pool tight enough to park: equal to the same
           engine unsharded, every restore read back bit-equal
  engine_chunked  the same with ``chunked=True, chunk_size=16``: prompts
           prefilled inside mixed-phase segments; staged_scatter and
           flash_decode_paged launched, flash_attention never; every prompt
           row counted as a prefill write; a mixed segment profiled
  engine_prefix  the chunked slice, cut to 2 of its 24 layers
           (``MEMORY_LAYERS``, as the next three), with the prefix cache:
           16 requests opening with the same 1024 tokens, cold on a fresh engine, warm
           (new suffixes: each takes its 1024 rows from the cache) and
           repeated (every full prompt page cached, a copy-on-write of each
           whole-page prompt's last block) after ``reset(keep_cache=True)``;
           on the adaptive and the staged path. Hit rows, copies, prefill
           writes, the pool's audit and K1 / K2 launches held in every pass;
           on the staged path the cold and warm streams held equal to the
           engine's without the cache (exact by construction: see the
           phase); TTFT cold / warm / repeat and mixed-step device time
  engine_host_tier  the slice, cut to 2 of its 24 layers, on the staged
           path over a 320-block pool
           with the host tier (16 requests of 512-1792 tokens): blocking,
           chunked, and chunked with the prefix cache too, each against an
           ample pool; every restore read back bit-equal to its park, no
           slot left parked, the blocking streams held equal to the ample
           pool's; each park's and restore's bytes, ms and GB/s, and one
           116-block park and restore against a plain pinned copy
  sampler  the threefry key chain on the card: Random123's known answers and
           jax 0.9.0's ``split`` / ``fold_in`` goldens (constants), 8
           slots' chains over 64 steps bit-equal to the CPU's;
           ``sample_tokens`` on the same full-vocabulary logits on the card
           and the CPU (differing tokens counted, greedy held equal);
           ``filtered`` twice on the card identical; each mode's device
           time per call
  engine_sampled  the slice, cut to 2 of its 24 layers, serving 16
           requests with mixed sampling
           parameters (greedy, T = 0.8, top-k 40, top-p 0.9, explicit
           seeds), blocking and chunked at 16: a repeat run identical, an
           all-(T = 1, top_k = 1) run equal to an all-greedy run; a decode
           step with the mix against a greedy one (device ms, device
           operations, tok/s)
  engine_spec  the slice, cut to 2 of its 24 layers, with
           ``SpecConfig(enabled=True, k=4)`` (self-draft) serving
           engine_sampled's requests: adaptive blocking greedy,
           staged chunked (chunks of 16) greedy, adaptive blocking with
           engine_sampled's mix; per arm ``spec_proposed == k *
           spec_rounds``, ``0 <= spec_accepted <= spec_proposed``, on the
           blocking arms ``spec_committed == emitted - requests``, the
           pool's audit, and staged_scatter, flash_decode_paged,
           flash_attention and flash_decode launched; tok/s, committed
           tokens per round, the acceptance share, the greedy streams
           against engine_sampled's greedy run at the same depth, a spec
           segment profiled
  loadtest ``benchmarks/loadtest.py``'s three arms on the slice's model in
           virtual time (SLO counts, goodputs, their ratio; the streams'
           equality across arms reported), then the adaptive arm on the
           wall clock (TTFT / ITL p95, goodput)
  preempt  ``sched/preempt`` on the slice with the host tier: a burst of 4
           high-priority requests while 8 sampled low-priority ones fill
           every slot; each resume's position, key and last token equal
           what was saved and its blocks read back bit-equal; streams
           against a FIFO run reported
  lanes    h2o-danube-3-4b at full width (bf16, sliding window 4096), cut
           to 6 of its 24 layers (``LANES_LAYERS``), serves 12 requests with prompts up to 4608 tokens on the
           lanes layout; flash_attention's and flash_decode's launch counts
           must be non-zero
  lanes_chunked  the same model with ``chunked=True, chunk_size=512``:
           prompts of 2048 and 4608 tokens prefilled chunk by chunk at
           admission (one flash_attention launch a chunk and layer); the
           last-position logits held to the whole-prompt prefill's against
           the fp32 prefill (``held_bf16``)
  parity   stablelm-1.6b at 4 layers, fp32: direct / staged / adaptive,
           fused / reference, paged / lanes and greedy speculative decoding
           (self-draft, k = 3) give identical greedy token streams;
           h2o-danube-3-4b at 2 layers (window cut to 128), fp32:
           the engine on the card and the same weights on the CPU (the
           plain versions) give identical greedy token streams
  parity_chunked  stablelm-1.6b at 2 layers, fp32, chunk sizes 1 and 3, each
           path: chunked on the card = chunked on the CPU (streams, stats,
           path counts) = blocking on the card (streams, per-request write
           counts); h2o-danube-3-4b at 2 layers (window 128): chunked =
           blocking with prompts past the window
  write_engine  the flat RemoteWriteEngine at the paper's section 4 size:
           4 GiB of registered fp32 memory (2^20 regions of 4 KB, four uMTT
           registrations), 64 batches of 4096 writes of 16-256 B to
           Zipf(0.5) regions, through four decision planes (always offload,
           always unload, frequency and hysteresis over a count-min sketch);
           the four memories must be bit-identical and equal a sequential
           last-write-wins oracle, nothing rejected, both sketch engines
           must unload a share strictly between 0 and 1 and launch the
           fused cms_update_query once per batch and cms_update / cms_query
           never; the stream, made again from its seed, must be the same,
           and the card must draw the regions the CPU draws from the same
           uniforms
  write_parity  the same four engines on the card and on the CPU (the
           plain versions) at 2^12 regions, with 1 write in 64 carrying a
           wrong stag: memory, telemetry and ring state identical
  fig3     the paper's Fig. 3 on the card: ``sweep_point`` at the 11 region
           counts 1..2^20 for offload, unload, hint (top-4096) and
           frequency over an exact monitor, 200 000 writes (warm-up 20 000);
           frequency over a count-min sketch at 2^20 (one K5 and one K6
           launch); the 2^20 headline at the paper's 5 000 000 writes; one
           lru_scan call a point, each of its five kernels launched once a
           point (counted where launched); the ``FIG3_CLAIMS`` bounds held (the
           microseconds are the paper's model constants); the 2^20 offload
           point equal to the CPU's; device ms per point
  engine_moe  granite-moe-3b-a800m at full width (40 experts top-8,
           bf16, random weights from a seed), cut to 4 of its 32 layers
           (``MOE_LAYERS``), serves 16 requests of
           128-512 tokens through ``Engine.from_config`` on the lanes
           layout with staged expert dispatch, blocking and chunked at
           128: K1 launched once a layer of every MoE call, K3 and K4
           launched, a repeat serve identical; tok/s, TTFT, peak memory
           and a decode segment's profile
  engine_ssm  mamba2-130m at full width (24 layers, d_model 768, bf16,
           random weights from seed 0) serves 16 requests of 256-2048
           tokens, 32 new tokens each, on the lanes layout, direct writes,
           blocking and chunked at 256 (the SSD's own chunk): every
           request's 32 tokens in the vocabulary with 31 direct writes and
           none staged, admitted = retired = 16, a repeat serve identical,
           no kernel launched (the SSD is plain PyTorch, as the JAX
           package's is ``jnp``); tok/s, TTFT, peak memory, blocking
           against chunked, a decode segment's profile with the SSD's share
           of the device time
  engine_hybrid  zamba2-2.7b at full width (d_model 2560, 32 heads of
           80, bf16), cut to 12 of its 54 layers (``HYBRID_LAYERS``: the
           shared attention block twice, not 9 times), the same traffic:
           the same checks, and flash_attention launched 2 x the model's
           prefill and chunk calls, flash_decode 2 x its decode calls,
           nothing else
  parity_ssm  mamba2-130m at 4 layers and zamba2-2.7b at 6 (one
           application), full width, fp32: the engine on the card and the
           same weights on the CPU (plain versions) give identical greedy
           streams, blocking and chunked (blocking against chunked on the
           card reported); greedy
           speculative decoding on the card with the reduced mamba2 draft
           (snapshot rollback) for the reduced stablelm-1.6b equals the
           engine without it
  engine_encdec  whisper-medium at full width (d_model 1024, 16 heads of
           64, bf16, random weights from seed 0), cut to 8 of its 24
           encoder and 8 of its 24 decoder layers (``ENCDEC_LAYERS``),
           max_seq 448, serves 16 requests, each with its own
           frames [1500, 1024], of 4-224 tokens, 32 new tokens each, on the
           lanes layout, direct writes, blocking and chunked at 64: every
           request's 32 tokens in the vocabulary with 31 direct writes and
           none staged, admitted = retired = 16, a repeat serve identical,
           the encoder run once an admission group, flash_attention
           launched encoder layers x the encoder's calls + 2 x decoder
           layers x the prefill and chunk calls, flash_decode 2 x decoder
           layers x the decode calls, nothing else; tok/s,
           TTFT, peak memory, the encoder's device ms a request, blocking
           against chunked, a decode segment's profile with the cross
           reads' share
  parity_encdec  whisper-medium at 4 + 4 layers, full width, fp32: the
           engine on the card and the same weights on the CPU (plain
           versions) give identical greedy streams, blocking and chunked
           (blocking against chunked on the card reported)
  engine_vlm  llama-3.2-vision-90b at full width (d_model 8192, 64 heads
           of 128 over 8 KV heads, d_ff 28672, bf16, random weights from
           seed 0, the cross gates nonzero from seed 1), cut to 2 of its 20
           groups (``VLM_GROUPS``: 8 self and 2 cross layers, what fits the
           card), max_seq 1024, serves 16 requests, each with its own image
           embeddings [1601, 8192], of 16-480 tokens, 32 new tokens each, on
           the lanes layout, direct writes, blocking and chunked at 64 (the
           media on every chunk): the same checks as engine_encdec,
           flash_attention launched layers x the prefill and chunk calls,
           flash_decode layers x the decode calls, nothing else; tok/s, TTFT,
           peak memory, blocking against chunked, a decode segment's profile
           with the cross reads' share, the cross K/V projection's device ms
           a chunk
  parity_vlm  the VLM's kernel geometry (head_dim 128, GQA group 8, 1601
           image tokens, 2 groups of 5 layers) at d_model 1024, fp32, gates
           from a seed: the engine on the card and the same weights on the
           CPU give identical greedy streams, blocking and chunked at 64
  engine_ring_lanes  ``ServeEngine`` on stablelm-1.6b at full width, cut
           to 4 of its 24 layers (``RING_LANES_LAYERS``, bf16), over the
           dense lanes cache with its staging ring:
           8 prompts of 512 tokens, 128 new tokens, max_seq 1024, a ring of
           8, direct / staged / adaptive, each through ``decode`` and
           ``decode_reference``: equal tokens and stats; flash_attention one
           launch a layer, flash_decode one a layer and step, staged_scatter one a step and
           one for the last drain on the ring modes (the gated drain),
           every write staged in staged mode; the card equal to the CPU in
           fp32 at 2 layers (conflict-forced drains); each mode's device ms
           a step, drains, the concatenation's share of a step (its
           ``torch.cat`` kernels in the step's trace)
  parity_train  training on the card = on the CPU (plain versions), fp32,
           at the kernels' geometry and small widths (``PARITY_TRAIN_*``):
           stablelm-1.6b's family, granite-moe-3b-a800m's staged and
           adaptive, mamba2-130m's (the SSD's chunk 64 at seq 128),
           zamba2-2.7b's (head_dim 80, two applications of the shared
           block), whisper-medium's (200 frames) and llama-3.2-vision-90b's
           (head_dim 128, GQA group 8, two groups, 65 image tokens, gates
           from a seed); the first batch's gradients (every attention
           weight, the cross layers' too, every expert weight and gate
           nonzero), then 3 train steps (microbatches 2):
           losses, grad norms, lr, expert counts and hot masks, final
           parameters, and the launches of K3, its backward, the drain and
           its adjoint
  train_dense  stablelm-1.6b at full width (bf16 over fp32 masters), cut
           to 4 of its 24 layers (``TRAIN_DENSE_LAYERS``): ``Trainer`` on
           ``SyntheticSource`` batches of 8 x 512 in 2 microbatches, remat,
           AdamW under ``warmup_cosine``, 6 steps with a checkpoint at 3;
           a fresh model and ``Trainer`` resumed from it repeat steps 3-5
           within ``TRAIN_RESUME_RTOL``; K3 = 2 x, its backward 1 x layers
           x microbatches x steps; losses, grad norms, step ms, tokens/s,
           peak memory, a step's device ms, busy share and device ops
  train_moe  granite-moe-3b-a800m at full width, cut to 4 of its 32 layers
           (``TRAIN_MOE_LAYERS``), the same batches: 3 steps staged, 3
           adaptive (10 hot experts of 40, the mask recalibrated every
           step): the counts sum to tokens x 8 x layers x steps, each
           step's mask equals ``expert_hot_mask`` of its counts on the CPU,
           K1's drain 2 x and its adjoint 1 x layers x microbatches x
           steps; the same report as train_dense
  train_ssm  mamba2-130m at full width and depth, the same batches, 3
           steps: finite losses, nonzero grad norms, no kernel launched;
           train_dense's report and, from the traced step, the SSD's
           device ms (its forwards, recomputes and backward) and share,
           its calls 2 x layers x microbatches
  train_hybrid  zamba2-2.7b at full width, cut to 12 of its 54 layers
           (``TRAIN_HYBRID_LAYERS``), likewise; K3 = 2 x and its backward
           1 x the shared block's applications x microbatches x steps
           (``remat_calls``: the mamba layers nested in checkpointed
           groups run three times, the shared block twice)
  train_encdec  whisper-medium at full width and depth over 448 tokens
           (``TRAIN_ENCDEC_SEQ``), each row with frames [1500, 1024] from a
           seed, likewise; K3 = 2 x and its backward 1 x (24 + 2 x 24) x
           microbatches x steps
  train_sharded  training on meshes of virtual devices of the card
           (``TRAIN_SHARDED_ARMS``): stablelm-1.6b on (data 2, model 2),
           granite-moe-3b-a800m staged on (2, 2) and stablelm-1.6b on (1,
           3) (its 32 heads padded to 33, the vocab to 100353), full width,
           4 layers; mamba2-130m (4 layers), zamba2-2.7b (12), whisper-medium
           (4 + 4, 448 positions, frames from a seed) at full width and the
           VLM at its kernel geometry (two groups, 1601 image tokens) on (2,
           2): one fp32 step sharded and unsharded on the same weights
           and batch, held to parity_train's rule (a 0-d leaf also within
           twice its noise floor, the unsharded step's move from 2 to 4
           microbatches, and a control with it summed twice over model
           must fail); K3, its backward, the
           drain and its adjoint once per device for each unsharded launch;
           each collective's bytes equal to those the specs give
           (``models.parallel.expected_collective_bytes``); then bf16
           steps: host ms, device ms, busy share, device ops, peak memory
  roofline  the dry-run count of train_sharded's stablelm (2, 2) bf16 arm
           (``launch.cells`` / ``launch.roofline`` on the meta device, no
           card) against one untimed call of the same step on the card
           under the same counters: FLOPs (each dtype's and the slowest
           rank's), bytes (the slowest rank's too), collective bytes and
           each kernel's would-be launches equal, the launches also the
           wrappers' real ones; the arm's traced device ms at least the
           bound of the four ranks on one card, each dtype's products at
           its peak (a share over
           ``ROOFLINE_SHARE_MAX`` fails); the card's peak of live bytes
           over the step within ``ROOFLINE_PEAK_RTOL`` / ``_ATOL`` of the
           meta count. No timed card run of its own

Every kernel time in the ``kernels`` line (``ms``, ``plain_ms``,
``library_ms``) is device time: the sum of the kernels' own times in the
profiler's trace, warm, mean of 20 calls (but lru_scan's ``plain_ms``: its
plain version runs on the CPU, so that is host time). A trace that holds no
device event is taken again, up to three times in all; where none does, the
time is that between CUDA events around the 20 calls, and the ``done`` line
names it under ``traces_without_device_time``. The time between CUDA events
around one call (median of 30) stands beside it as ``*event_ms``; for calls
shorter than their own enqueue it measures the host. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import dataclasses
import importlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "runs on a GPU only")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import (FIG3_CLAIMS, PAPER_WORKLOAD,  # noqa: E402
                                 get_config)
from repro_torch.core import (AlwaysOffload, AlwaysUnload,  # noqa: E402
                              CMSMonitor, DecisionModule, ExactMonitor,
                              FrequencyPolicy, HintPolicy,
                              HysteresisPolicy, MonitorState,
                              RemoteWriteEngine, make_umtt, make_write_batch,
                              register, sweep_point, zipf_regions)
from repro_torch.kernels.cms import cms_hash  # noqa: E402
from repro_torch.core.decision import expert_hot_mask  # noqa: E402
from repro_torch.data import (DataConfig, Pipeline,  # noqa: E402
                              RequestQueue, SyntheticSource,
                              synthetic_requests)
from repro_torch.distributed import (VIRTUAL_DEVICES_ENV, Mesh,  # noqa: E402
                                     NamedSharding, ParallelConfig,
                                     ShardedTensor, collective_bytes,
                                     reset_collective_counts)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import (cms_query, cms_query_ref,  # noqa: E402
                                 cms_update, cms_update_query,
                                 cms_update_query_ref, cms_update_ref,
                                 flash_attention, flash_attention_bwd,
                                 flash_attention_bwd_ref, flash_attention_lse,
                                 flash_attention_lse_ref,
                                 flash_attention_ref, flash_decode,
                                 flash_decode_paged, flash_decode_paged_ref,
                                 flash_decode_paged_sharded,
                                 flash_decode_paged_sharded_ref,
                                 flash_decode_ref, kernel_launch_counts,
                                 launch_counts, lru_buckets_ref,
                                 lru_scan, lru_scan_ref,
                                 reset_launch_counts, staged_drain,
                                 staged_gather, staged_gather_ref,
                                 staged_scatter,
                                 staged_scatter_layers, staged_scatter_planes,
                                 staged_scatter_planes_ref,
                                 staged_scatter_ref)
from repro_torch.kernels.staged_scatter import (  # noqa: E402
    MAX_PLANES as K1_MAX_PLANES)
from repro_torch.kernels.lru_scan import (LRU_KERNELS,  # noqa: E402
                                          bucket_keys, longest_chain,
                                          lru_scan_buckets)
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed.sharding import make_abstract_mesh  # noqa: E402
from repro_torch.launch import cells as CELLS  # noqa: E402
from repro_torch.launch import roofline as ROOF  # noqa: E402
from repro_torch.models import (build_model, media_spec,  # noqa: E402
                                needs_media, remat_calls)
from repro_torch.models import moe as MOE_L  # noqa: E402
from repro_torch.models import parallel as PARALLEL  # noqa: E402
from repro_torch.models import mamba2 as MAMBA  # noqa: E402
from repro_torch.kvcache import paged as PG  # noqa: E402
from repro_torch.models import prng  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig,  # noqa: E402
                               init_train_state, make_train_step)
from repro_torch.models import sampling as SMP  # noqa: E402
from repro_torch.kvcache import staged as ST  # noqa: E402
from repro_torch.models import layers as LAYERS  # noqa: E402
from repro_torch.serve import (WRITE_MODES, Engine,  # noqa: E402
                               EngineConfig, MemoryConfig, SamplingParams,
                               ServeConfig, ServeEngine, SpecConfig)
from repro_torch.serve.traffic import (MarkovModulatedArrivals,  # noqa: E402
                                       RequestClass, generate_workload,
                                       run_loadtest)

# the module of K2 / K4 (the package exports the wrappers under its name)
FD = importlib.import_module("repro_torch.kernels.flash_decode")
from repro_torch.kernels import cost as COST  # noqa: E402

DEV = torch.device("cuda")
# published peaks of one H100 SXM (NVIDIA data sheet, dense) and the kernels'
# operation and byte counts: the formulas a dry-run cell's roofline counts
# by (``repro_torch.kernels.cost``)
HBM_BYTES_PER_S, PEAK_FLOPS = COST.HBM_BYTES_PER_S, COST.PEAK_FLOPS
live_pairs = COST.live_pairs

# the slice: what the engine phase runs
SLICE = dict(arch="stablelm-1.6b", reduced=False, max_seq=2048, n_slots=8,
             page_size=16, segment_len=16, ring_size=8, path="adaptive")
N_REQUESTS, PROMPT_LENS, NEW_TOKENS = 16, [128, 256, 384, 512], 64
ENGINE_RUNS = 3  # the timed serve is repeated so its spread is seen
# engine, engine_sharded (both arms) and engine_chunked run the slice at
# this depth (of its 24 layers; one depth, as they compare streams) to keep
# the script under 800 of its 1200 s: the three take 40.3 s at 4 layers,
# 65.5 s at 6 (H100 80GB HBM3, 700 W); every check is kept
SLICE_LAYERS = 4
# chunked prefill on the paged slice: prompt tokens per mixed-phase step
CHUNK = 16
# the memory tier on the paged slice. The prefix cache: 16 requests opening
# with the same 1024-token system prompt, suffixes of 64-192 tokens (three
# prompts a whole number of pages, so a repeated one copies its last
# block), chunked at 16 on the adaptive path
PREFIX_SHARED, PREFIX_LENS = 1024, [1088, 1152, 1216, 1100]
# the host tier: 16 requests of 512-1792 tokens, a working set of 8 live
# slots of about 640 pages, over a pool of 320 blocks (at least the largest
# request's 116 pages)
HOST_LENS, HOST_BLOCKS = [512, 1024, 1536, 1792], 320
# with the prefix cache as well: every prompt opens with the same 512 tokens
# (the 512-token prompts are nothing else, so they are fully cached)
HOST_SHARED = 512
# PCIe Gen5 x16, one direction: the host link's bound
PCIE_BYTES_PER_S = 64e9
# speculative decoding on the paged slice: k proposals a round, self-draft
SPEC_K = 4
# mesh-sharded serving on virtual meshes of the one card: the engine's
# configuration at tp 4 (fused read); then tp 2, chunked at 16 with the
# prefix cache and the host tier on the staged path, 12 requests of 512 /
# 768 tokens (every prompt opening with the same 512) over 160 blocks, a
# working set of 8 live slots of 33 / 49 pages
SHARDED_TP = 4
SHARDED_MEM = dict(tp=2, lens=[512, 768], requests=12, new_tokens=16,
                   n_blocks=160, shared=512)
# the lanes slice: the sliding-window model; max_seq 6144 makes the cache
# 4096 = the window, and 4608-token prompts exceed it, so prefill masks with
# the window, the cache keeps a rolled ring and decode wraps it
LANES = dict(arch="h2o-danube-3-4b", reduced=False, max_seq=6144, n_slots=8,
             segment_len=16, path="direct")
LANES_REQUESTS, LANES_PROMPTS, LANES_NEW = 12, [512, 2048, 4608], 64
LANES_GROUP = 2  # 4608-token prompts per prefill call (the first admission's)
# the lanes phase runs h2o at this depth (of its 24 layers) to keep the
# script under 800 of its 1200 s: 12.4 s at 6 layers (H100 80GB HBM3,
# 700 W); every check is kept
LANES_LAYERS = 6
# chunked prefill on the lanes slice: one prompt inside the window, one past
LANES_CHUNK, LANES_CHUNKED_PROMPTS, LANES_CHUNKED_NEW = 512, [2048, 4608], 16

# the paper's Fig. 3 (PAPER_WORKLOAD): 11 region counts x offload / unload /
# hint top-4096 / frequency over an exact monitor, 200 000 writes, warm-up
# 20 000; one frequency arm over a count-min sketch at 2^20 (its monitor
# step is K5 then K6, unfused); the headline at the paper's 5 000 000
FIG3_CMS = (4, 16)        # depth, log2 width of the sketch arm
FIG3_THRESHOLD = 3        # the frequency policy's count threshold
# the MoE family at full width (granite-moe-3b-a800m, 32 layers, 40 experts
# top-8, bf16) on the lanes layout, staged expert dispatch: 16 requests of
# 128-512 tokens, 32 new tokens each, 8 slots; chunked at 128
MOE = dict(arch="granite-moe-3b-a800m", reduced=False, max_seq=640,
           n_slots=8, segment_len=16, path="direct")
MOE_REQUESTS, MOE_PROMPTS, MOE_NEW, MOE_CHUNK = 16, [128, 256, 384, 512], 32, 128
# engine_moe runs granite at this depth (of its 32 layers) to keep the
# script under 800 of its 1200 s: 12.4 s at 4 layers (H100 80GB HBM3,
# 700 W); every check is kept, K1 held at layers x calls
MOE_LAYERS = 4
# the SSM and hybrid families at full width on the lanes layout: mamba2-130m
# (24 layers, d_model 768) and zamba2-2.7b (54 layers, d_model 2560, the
# shared attention block 9 times, 32 heads of 80), bf16, direct writes: 16
# requests of 256-2048 tokens, 32 new tokens each, 8 slots; chunked at 256,
# the SSD's own chunk, so chunking keeps its chunk boundaries
SSM = dict(arch="mamba2-130m", reduced=False, max_seq=2560, n_slots=8,
           segment_len=16, path="direct")
HYBRID = dict(SSM, arch="zamba2-2.7b")
SSM_REQUESTS, SSM_PROMPTS, SSM_NEW, SSM_CHUNK = 16, [256, 768, 1280, 2048], 32, 256
# engine_hybrid runs zamba2 at this depth (of its 54 layers: the shared
# block twice, not 9 times) to keep the script under 800 of its 1200 s:
# 14.9 s at 12 layers, 39.8 s at 24 (H100 80GB HBM3, 700 W); every check is
# kept, the launches held at applications x calls
HYBRID_LAYERS = 12
# the encoder-decoder family at full width (whisper-medium: 24 encoder and
# 24 decoder layers, d_model 1024, 16 heads of 64, bf16) on the lanes layout,
# direct writes, max_seq 448 (the decoder's context): 16 requests, each with
# its own frames [1500, 1024], prompts of 4-224 tokens (a few task tokens,
# or up to 224 tokens of earlier text), 32 new tokens each, 8 slots; chunked
# at 64
ENCDEC = dict(arch="whisper-medium", reduced=False, max_seq=448, n_slots=8,
              segment_len=16, path="direct")
ENCDEC_REQUESTS, ENCDEC_PROMPTS, ENCDEC_NEW, ENCDEC_CHUNK = \
    16, [4, 32, 96, 224], 32, 64
# engine_encdec runs whisper at this depth (of its 24 encoder and 24
# decoder layers, each) to keep the script under 800 of its 1200 s: 10.4 s
# at 8 + 8, 24.2 s at 24 + 24 (H100 80GB HBM3, 700 W); every check is kept,
# the launches held at layers x calls
ENCDEC_LAYERS = 8
# the VLM family at full width (llama-3.2-vision-90b: d_model 8192, 64 heads
# of 128 over 8 KV heads, d_ff 28672, 1601 image tokens, bf16), cut to 2 of
# its 20 groups (8 self + 2 cross layers): its fp32 masters and the bf16
# copy kept beside them take about 5.1 GB a layer and 8.4 GB of embedding
# and head, so 2 groups come to about 60 GB and 3 to about 86 GB, past the
# card's 80 GB. On the lanes layout, direct writes, max_seq 1024: visual
# question answering, 16 requests, each with its own embeddings [1601, 8192]
# (one 560x560 tile), text prompts of 16-480 tokens, 32 new tokens each, 8
# slots; chunked at 64. The gates are drawn from a seed (nonzero: at zero
# the cross layers would add nothing)
VLM = dict(arch="llama-3.2-vision-90b", reduced=False, max_seq=1024,
           n_slots=8, segment_len=16, path="direct")
VLM_GROUPS = 2
VLM_REQUESTS, VLM_PROMPTS, VLM_NEW, VLM_CHUNK = 16, [16, 64, 192, 480], 32, 64
# parity_vlm: the VLM's kernel geometry (head_dim 128, GQA group 8, 1601
# image tokens, 2 groups of 5) at a width a CPU serves in seconds in fp32
VLM_PARITY_WIDTH = dict(d_model=1024, n_heads=8, n_kv_heads=1, d_ff=3584)
# the staging ring on the lanes cache, through ServeEngine: stablelm-1.6b at
# full width (24 layers, bf16), 8 sequences of 512-token prompts, 128 new
# tokens, max_seq 1024, ring 8, pages of 64, hot threshold 4
RING_LANES = dict(arch="stablelm-1.6b", batch=8, prompt=512, new=128,
                  max_seq=1024, ring_size=8, page_size=64, hot_threshold=4)
# the memory tier's two phases, engine_sampled and engine_spec run the
# slice at this depth (of its 24 layers) to keep the script under 800 of
# its 1200 s: the four take 88.3 s at 2 layers, 162.6 s at 4 (H100 80GB
# HBM3, 700 W); every check is kept
MEMORY_LAYERS = 2
# training on the card (train_dense, train_moe): stablelm-1.6b and
# granite-moe-3b-a800m at full width, bf16 compute over fp32 masters,
# batches of 8 x 512 tokens from SyntheticSource in 2 microbatches of 4,
# remat (K3's forward twice a layer and microbatch, its backward once),
# AdamW under warmup_cosine. train_dense: 6 steps, a checkpoint at 3, then
# a fresh Trainer resumed from it runs to 6 again. train_moe: 3 steps
# staged (the unload path), then 3 adaptive with 10 hot experts of 40, the
# mask recalibrated from the counts after every step
TRAIN = dict(batch=8, seq=512, microbatches=2, lr=3e-4, warmup=2)
TRAIN_MB = TRAIN["batch"] // TRAIN["microbatches"]
TRAIN_DENSE_STEPS, TRAIN_RESUME_AT, TRAIN_MOE_STEPS, TRAIN_N_HOT = 6, 3, 3, 10
# the training phases run the two models at this depth (stablelm of its
# 24 layers, granite of its 32) to keep the script under 800 of its 1200 s:
# the last archive proof took 674.5 s on an H100 80GB HBM3 at 700 W. At
# full depth the training state (fp32 masters, gradients, AdamW mu / nu and
# the new moments) comes to about 20 B a parameter, some 33 GB for stablelm
# and 66 GB for granite's 3.3 B; at 4 layers about 12 GB and 11 GB, most of
# it stablelm's 100352 x 2048 embedding and head (every check kept)
TRAIN_DENSE_LAYERS = TRAIN_MOE_LAYERS = 4
# the SSM, hybrid and encoder-decoder families' training (train_ssm,
# train_hybrid, train_encdec): TRAIN's 8 rows in 2 microbatches, remat,
# AdamW, 3 steps, bf16 over fp32 masters. mamba2-130m at full depth (24
# layers); whisper-medium at full depth (24 + 24) over its decoder's whole
# context, 448 positions (TRAIN's 512 is past its table), each row with its
# own frames [1500, 1024] drawn on the card from a seed; zamba2-2.7b cut to
# 12 of its 54 layers (two applications of the shared block) to keep the
# script under 800 of its 1200 s (the training state at about 20 B a
# parameter comes to some 54 GB at full depth)
TRAIN_FAMILY_STEPS = 3
TRAIN_HYBRID_LAYERS = 12
TRAIN_ENCDEC_SEQ = 448
# the resumed run's losses against the first run's: relative, because the
# embedding's backward (an index_put with accumulation) adds with atomics
# on the card, in an order that differs from run to run
TRAIN_RESUME_RTOL = 1e-3
# parity_train: the training kernels' geometry (head_dim 64, GQA group 3 for
# the MoE, 128-token sequences: two 64-row tiles) at widths a CPU trains in
# seconds, fp32; the same weights and batches on the card (the kernels) and
# the CPU (the plain versions), 3 steps, lr 1e-4 (Adam turns the fp32 noise
# of the two backward passes into up to about lr of an entry whose gradient
# is near zero; a small lr keeps the routing of later steps the same)
PARITY_TRAIN = dict(seq=128, batch=4, microbatches=2, steps=3, lr=1e-4)
# a first-batch gradient leaf on the card within this share of its largest
# entry of the CPU's; an entry whose CPU gradient is, on some step, within
# this share of its leaf's largest is one that check cannot tell from 0
PARITY_GRAD_RTOL = 1e-4
# a 0-d gradient leaf (the VLM's gates) can be a sum that nearly cancels
# (the first cross gate's, -1.97e-5 of 2M terms), which any other order of
# its terms moves by more than PARITY_GRAD_RTOL of itself. train_sharded
# also allows it this many times its own noise floor: how far the unsharded
# step moves it between TRAIN's microbatches and twice as many (the same
# function, its sums in another order)
ZERO_D_NOISE_K = 2
PARITY_TRAIN_DENSE = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                          head_dim=64, d_ff=512, vocab=2048, dtype="float32")
PARITY_TRAIN_MOE = dict(n_layers=2, d_model=384, n_heads=6, n_kv_heads=2,
                        head_dim=64, n_experts=8, top_k=2, expert_d_ff=128,
                        vocab=2048, dtype="float32")
# and the other four families: the SSD's chunk at 64 so that a 128-token
# sequence runs the inter-chunk loop; zamba2's head_dim 80 and two
# applications of the shared block; whisper over 200 frames (no multiple of
# 64: a ragged last key tile); the VLM's head_dim 128 over one KV head (GQA
# group 8), two groups, 65 image tokens, its gates drawn from a seed
PARITY_TRAIN_SSM = dict(n_layers=2, d_model=256, ssm_chunk=64, vocab=2048,
                        dtype="float32")
PARITY_TRAIN_HYBRID = dict(n_layers=4, d_model=320, n_heads=4, n_kv_heads=4,
                           head_dim=80, d_ff=640, hybrid_attn_every=2,
                           ssm_chunk=64, vocab=2048, dtype="float32")
PARITY_TRAIN_ENCDEC = dict(n_layers=2, n_enc_layers=2, d_model=256,
                           n_heads=4, n_kv_heads=4, head_dim=64, d_ff=1024,
                           n_audio_frames=200, vocab=2048, dtype="float32")
PARITY_TRAIN_VLM = dict(VLM_PARITY_WIDTH, n_layers=4, head_dim=128,
                        cross_attn_every=2, n_image_tokens=65, vocab=2048,
                        dtype="float32")
# engine_ring_lanes runs the slice at this depth (of its 24 layers) to keep
# the script under 800 of its 1200 s: 27.4 s at 4 layers, 90.8 s at 24
# (H100 80GB HBM3, 700 W); every check is kept
RING_LANES_LAYERS = 4
# train_sharded: each arm one fp32 step sharded and unsharded on the same
# weights and TRAIN batch (2 microbatches; whisper's over TRAIN_ENCDEC_SEQ
# positions, each row with its frames, the VLM's with its image embeddings,
# both drawn on the card from a seed), then bf16 steps on the mesh (virtual
# devices of the card): (tag, arch, config changes, mesh shape, dispatch).
# mamba2 and whisper at TRAIN_SHARDED_LAYERS (whisper's encoder and decoder
# each), zamba2 at TRAIN_HYBRID_LAYERS (two applications of the shared
# block: the fewest that sum its gradient over applications), the VLM at
# its kernel geometry (VLM_PARITY_WIDTH, head_dim 128, two groups of a self
# and a cross layer, 1601 image tokens, gates from a seed): a full-width
# group is some 128 GB of training state, and a virtual mesh adds no memory
TRAIN_SHARDED_LAYERS = 4
TRAIN_SHARDED_VLM = dict(VLM_PARITY_WIDTH, n_layers=4, head_dim=128,
                         cross_attn_every=2)
TRAIN_SHARDED_ARMS = (
    ("dense_2x2", "stablelm-1.6b", dict(n_layers=TRAIN_DENSE_LAYERS), (2, 2),
     None),
    ("moe_2x2", "granite-moe-3b-a800m", dict(n_layers=TRAIN_MOE_LAYERS),
     (2, 2), "staged"),
    ("dense_1x3", "stablelm-1.6b", dict(n_layers=TRAIN_DENSE_LAYERS), (1, 3),
     None),
    ("ssm_2x2", "mamba2-130m", dict(n_layers=TRAIN_SHARDED_LAYERS), (2, 2),
     None),
    ("hybrid_2x2", "zamba2-2.7b", dict(n_layers=TRAIN_HYBRID_LAYERS), (2, 2),
     None),
    ("encdec_2x2", "whisper-medium", dict(n_layers=TRAIN_SHARDED_LAYERS,
                                          n_enc_layers=TRAIN_SHARDED_LAYERS),
     (2, 2), None),
    ("vlm_2x2", "llama-3.2-vision-90b", TRAIN_SHARDED_VLM, (2, 2), None),
)

# roofline: train_sharded's arm whose step the dry-run count is held to;
# the measured device ms over the count's bound on one card may be at most
# ROOFLINE_SHARE_MAX (a bound the card beats means the count is wrong); the
# card's peak of live bytes over the step (max_memory_allocated after
# reset_peak_memory_stats, less what was allocated before) within
# ROOFLINE_PEAK_RTOL of the meta count plus ROOFLINE_PEAK_ATOL bytes: the
# caching allocator keeps a large block whole where under 1 MB would be left
# of it, and a library takes its workspace through the allocator at first use
ROOFLINE_ARM = "dense_2x2"
ROOFLINE_SHARE_MAX = 1.05
ROOFLINE_PEAK_RTOL, ROOFLINE_PEAK_ATOL = 0.02, 64 << 20

# the flat write engine (section 4 of the paper): 2^20 regions of 4 KB
WRITE = dict(log2_regions=20, region_elems=1024, batches=64, batch=4096,
             width=64, ring=8192, cms=(4, 16), decay_every=65536,
             threshold=4, lo=2, hi=8, umtt=64, registrations=4, bad_every=0)
# the same engines, small, on the card and on the CPU, with bad stags
WRITE_PARITY = dict(log2_regions=12, region_elems=256, batches=32, batch=256,
                    width=64, ring=512, cms=(4, 10), decay_every=2048,
                    threshold=4, lo=2, hi=8, umtt=64, registrations=4,
                    bad_every=64)
WRITE_ENGINES = ("direct", "staged", "adaptive-cms", "hysteresis-cms")
# the sketch kernels are timed at the JAX default sketch and at the write
# engine's, at one engine batch and at 2^20 ids
CMS_TIMED = [(4, 12, 4096), (4, 16, 4096), (4, 12, 1 << 20), (4, 16, 1 << 20)]

# Tolerances against the plain version on the same inputs.
# fp32: the JAX package's own kernel-vs-oracle bound (sums in another order).
TOL_F32 = dict(atol=2e-6, rtol=1e-4)
# bf16: the plain version rounds q.k to bf16 before the softmax (its einsum
# returns bf16, as the JAX oracle's does), and so does K2; K3 and K4 keep
# fp32 scores. Kernel and plain version round p and the output to bf16 (the
# kernels the unnormalised p, the plain versions the normalised). The
# result is a few bf16 ulps (2^-8 relative) apart. This bound
# suits K2's small cases, whose outputs are of order 1; at the slice's and
# the engine's shapes (means over ~130-2000 keys, outputs of order 0.05)
# ``_check_k2_at`` holds the kernel to an fp32 reference by ``held_bf16``
# instead, and so does ``check_bf16`` for every bf16 case of K3 and K4.
TOL_BF16 = dict(atol=8e-3, rtol=1.6e-2)
# bf16: the kernel's error against the plain version run in fp32 on the same
# inputs may be at most this many times the plain bf16 version's
SLICE_ERR_FACTOR = 2.0


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, warm=5, reps=30):
    """Median time of one call, CUDA events, warm."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# Profiler traces that came back without a device event, by what was traced:
# CUPTI now and then delivers none for a short trace, so every trace is
# retried and a miss that lasts is reported in the ``done`` line.
TRACE_MISSES = []
# Traces that held fewer launches of a kernel than its wrapper counted, after
# their retries: CUPTI dropped some of their events
TRACE_SHORT = []


def trace_rows(run, what, tries=3):
    """``(self device us, calls, kernel name)`` for every kernel that ``run``
    launches, from the profiler's CUPTI trace, largest first (a profiler
    range's copy on the device's timeline, such as ``MAMBA.SSD_SPAN``'s, is
    no kernel and is left out). A trace with no device time is taken again,
    up to ``tries`` times; then ``[]``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = sorted(
            ((getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0)), e.count, e.key)
             for e in prof.key_averages()
             if not getattr(e, "is_user_annotation", False)), reverse=True)
        if sum(r[0] for r in rows) > 0:
            return rows
    TRACE_MISSES.append(what)
    return []


def span_events(events, span):
    """Of a profiler's ``events``: the ``span`` ranges, and the backward
    functions of the operators run inside them, matched as the profiler
    matches a backward function to its forward operator (its sequence
    number and forward thread). The ranges are the host's (a range's copy
    on the device's timeline is left out)."""
    from torch.autograd import DeviceType
    ranges = [e for e in events
              if e.name == span and e.device_type == DeviceType.CPU]
    keys = set()
    stack = list(ranges)
    while stack:
        e = stack.pop()
        stack += e.cpu_children
        if e.sequence_nr >= 0:
            keys.add((e.sequence_nr, e.thread))
    backward = [e for e in events if e.scope == 1
                and (e.sequence_nr, e.fwd_thread) in keys]
    return ranges, backward


def own_time(event, span, attr):
    """``event``'s ``attr`` (a time that sums its children's) less that of
    the ``span`` ranges run inside it (a remat recompute that a backward
    function sets off), which count as the span's forward."""
    t, stack = getattr(event, attr), list(event.cpu_children)
    while stack:
        e = stack.pop()
        if e.name == span:
            t -= getattr(e, attr)
        else:
            stack += e.cpu_children
    return t


def trace_spans(run, what, span, tries=3):
    """``trace_rows`` with the host's operators traced too, and the device
    ms that ``span`` accounts for (``span_events``): the kernels launched
    inside its ranges (``forward_ms``: each call, remat's recomputes
    included), those of the backward functions of its operators
    (``backward_ms``), and its ranges (``calls``). ``([], None)`` where no
    trace holds a device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = sorted(
            ((e.self_device_time_total, e.count, e.key)
             for e in prof.key_averages()
             if e.device_type != DeviceType.CPU
             and not getattr(e, "is_user_annotation", False)), reverse=True)
        if sum(r[0] for r in rows) > 0:
            ranges, backward = span_events(prof.events(), span)
            return rows, dict(
                calls=len(ranges),
                forward_ms=sum(e.device_time_total for e in ranges) / 1e3,
                backward_ms=sum(own_time(e, span, "device_time_total")
                                for e in backward) / 1e3)
    TRACE_MISSES.append(what)
    return [], None


def device_ops(rows):
    """The device's own operations (kernels, fills, copies) among
    ``trace_rows``' rows: those with device time. The other rows are the
    runtime's calls (one ``cudaLaunchKernel`` a kernel among them), so the
    sum over all rows counts each launch twice."""
    return sum(r[1] for r in rows if r[0] > 0)


def device_ms(fn, what, reps=20):
    """Mean device time of one call: the sum of the kernels' own times as the
    profiler's CUPTI trace gives them, host gaps left out. Where no trace
    holds a device event, the time between CUDA events around ``reps`` calls
    in a row, over ``reps`` (host gaps in), and ``what`` is in
    ``TRACE_MISSES``."""
    fn()
    def run():
        for _ in range(reps):
            fn()
    rows = trace_rows(run, what)
    if rows:
        return sum(r[0] for r in rows) / reps / 1e3
    return time_ms(run, warm=1, reps=5) / reps


def timings(name, kernel, plain, library):
    """Device time of the three (``ms``, ``plain_ms``, ``library_ms``) and,
    under its own keys, the time between CUDA events around one call."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        out[key] = device_ms(fn, f"{name} {key}")
        out[key.replace("ms", "event_ms")] = time_ms(fn)
    return out


# ---------------------------------------------------------------------------


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([kbuild.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    # fp32 matrix products in full fp32 (PyTorch's default, stated and set)
    torch.backends.cuda.matmul.allow_tf32 = False
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-2].strip(),
        python=sys.version.split()[0],
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build():
    kbuild.load_library()
    info = kbuild.build_info()
    ptxas = [ln.strip() for ln in str(info["log"]).splitlines()
             if "registers" in ln or "spill" in ln.lower()]
    # -Xptxas -v of the attention kernels (K3, its backward, K4, K2) in
    # full: registers, shared memory, spills and any wgmma serialisation
    # warning
    attn, keep = [], False
    for ln in str(info["log"]).splitlines():
        if ln.startswith("== "):
            keep = ln[3:] in ("flash_attention.cu", "flash_attention_bwd.cu",
                              "flash_decode.cu", "flash_decode_paged.cu")
        if keep and ("ptxas" in ln or "spill" in ln
                     or "warning" in ln.lower()):
            attn.append(ln.strip())
    lru = _ptxas_of(str(info["log"]), "lru_scan.cu")
    frames = [ln for ln in lru if "stack frame" in ln]
    say("build", seconds=round(float(info["seconds"]), 2),
        built=info["built"], sources=info["sources"], ptxas=ptxas[:24],
        ptxas_attention=attn, ptxas_lru_scan=lru)
    bad = [ln for ln in frames
           if ln != "0 bytes stack frame, 0 bytes spill stores, "
                    "0 bytes spill loads"]
    if not frames or bad:
        raise AssertionError(f"lru_scan.cu: every kernel must have no stack "
                             f"frame and no spills: {bad or 'no ptxas lines'}")


def _ptxas_of(log, source):
    """The ``-Xptxas -v`` lines of one source in the build log."""
    out, keep = [], False
    for ln in log.splitlines():
        if ln.startswith("== "):
            keep = ln[3:] == source
        elif keep and ln.strip():
            out.append(ln.strip())
    return out


# ---------------------------------------------------------------------------
# K1 staged_scatter
# ---------------------------------------------------------------------------


def _k1_routing(gen, r, n, valid_kind, idx=torch.int64):
    """K1's routing: ``n`` distinct rows of ``[-4, r + 4)`` (some out of
    range) in ``idx``, and the valid mask of ``valid_kind``."""
    rows = (torch.randperm(r + 8, generator=gen, device=DEV)[:n] - 4).to(idx)
    valid = {"none": torch.zeros(n, dtype=torch.bool, device=DEV),
             "all": torch.ones(n, dtype=torch.bool, device=DEV),
             "mixed": torch.rand(n, generator=gen, device=DEV) > 0.4}[valid_kind]
    return rows, valid


def _k1_case(gen, dtype, r, w, n, valid_kind, layers=0, idx=torch.int64):
    lead = (layers,) if layers else ()
    # a pool with spare rows after row r, as the engine's sink block gives
    store = torch.randn(lead + (r + 16, w), generator=gen, device=DEV).to(dtype)
    dest = store[..., :r, :]
    staging = torch.randn(lead + (n, w), generator=gen, device=DEV).to(dtype)
    rows, valid = _k1_routing(gen, r, n, valid_kind, idx)
    if layers:
        want = torch.stack([staged_scatter_ref(dest[l], staging[l], rows, valid)
                            for l in range(layers)])
        got = staged_scatter_layers(dest, staging, rows, valid)
    else:
        want = staged_scatter_ref(dest, staging, rows, valid)
        got = staged_scatter(dest, staging, rows, valid)
    torch.cuda.synchronize()
    assert got.data_ptr() == dest.data_ptr(), "staged_scatter is in place"
    if not torch.equal(got, want):
        raise AssertionError(
            f"staged_scatter mismatch: {dtype} r={r} w={w} n={n} "
            f"{valid_kind} layers={layers} {idx}")
    return float((got.float() - want.float()).abs().max())


def _k1_table_case(gen, planes, r, n, valid_kind, idx):
    """``staged_scatter_planes`` over a table of planes, one ``(dtype, w,
    layers, spare)`` each: ``dest[layers, r, w]`` cut from a store with
    ``spare`` rows more (so the planes differ in width and layer stride),
    one routing list; ``torch.equal`` to the plain version, the spare rows
    untouched."""
    rows, valid = _k1_routing(gen, r, n, valid_kind, idx)
    stores, table = [], []
    for dtype, w, layers, spare in planes:
        store = torch.randn((layers, r + spare, w), generator=gen,
                            device=DEV).to(dtype)
        staging = torch.randn((layers, n, w), generator=gen,
                              device=DEV).to(dtype)
        stores.append(store)
        table.append((store[:, :r], staging))
    want = [s.clone() for s in stores]
    staged_scatter_planes_ref([(s[:, :r], st) for s, (_, st) in
                               zip(want, table)], rows, valid)
    staged_scatter_planes(table, rows, valid)
    torch.cuda.synchronize()
    for j, (got, w) in enumerate(zip(stores, want)):
        if not torch.equal(got, w):
            raise AssertionError(
                f"staged_scatter_planes mismatch: plane {j} of "
                f"{planes}, r={r} n={n} {valid_kind} {idx}")


# tables of planes: (dtype, width, layers, spare rows) a plane. The paged
# drain's K and V; a tp-4 device's eight shards; planes that differ in
# width, layer count and layer stride (16-byte, 4-byte and 2-byte units);
# more planes than one launch takes (two launches)
K1_TABLES = (
    [(torch.bfloat16, 256, 3, 16)] * 2,
    [(torch.bfloat16, 64, 5, 16)] * 8,
    [(torch.bfloat16, 256, 3, 16), (torch.bfloat16, 64, 7, 5),
     (torch.float32, 24, 1, 0), (torch.float32, 40, 2, 3)],
    [(torch.bfloat16, 7, 2, 1), (torch.bfloat16, 256, 9, 0)],
    [(torch.float32, 8, 2, 1)] * (K1_MAX_PLANES + 3),
)


def check_k1(gen):
    """K1 ``torch.equal`` to its plain version: one plane (``staged_scatter``,
    ``staged_scatter_layers``) and tables of planes
    (``staged_scatter_planes``), int32 and int64 rows, rows out of range,
    nothing / everything / some valid; the slice's drain of K and V."""
    err, cases = 0.0, 0
    for idx in (torch.int64, torch.int32):
        for dtype in (torch.float32, torch.bfloat16):
            for kind in ("none", "all", "mixed"):
                for (r, w, n) in ((64, 256, 16), (40, 24, 9), (33, 7, 12)):
                    err = max(err, _k1_case(gen, dtype, r, w, n, kind,
                                            idx=idx))
                    err = max(err, _k1_case(gen, dtype, r, w, n, kind,
                                            layers=3, idx=idx))
                    cases += 2
        for planes in K1_TABLES:
            for kind in ("none", "mixed"):
                _k1_table_case(gen, planes, 48, 20, kind, idx)
                cases += 1
        # the slice's shape, one layer count as the engine drains it, both
        # planes
        err = max(err, _k1_case(gen, torch.bfloat16, 16384, 2048, 64,
                                "mixed", layers=24, idx=idx))
        _k1_table_case(gen, [(torch.bfloat16, 2048, 24, 16)] * 2, 16384, 64,
                       "mixed", idx)
        cases += 2
    return err, cases


def _counted(fn, counter):
    """``fn`` that counts its calls in ``.calls``, and ``.launched()``: the
    launches its wrapper counted (``launch_counts()[counter]``) since."""
    before = launch_counts()[counter]

    def call():
        call.calls += 1
        return fn()
    call.calls = 0
    call.launched = lambda: launch_counts()[counter] - before
    return call


def one_device_op(fn, what, counter, reps=20, tries=3):
    """The device operations of ``reps`` calls of ``fn``: raises unless its
    wrapper counted one launch a call (``launch_counts()[counter]``, where
    it launches) and the profiler's trace holds that kernel and no other
    device op (a drain or read a device: no conversion or copy beside it),
    at most once a call. CUPTI now and then drops some of a trace's events
    (13 of 20 once on an H100), so a trace holding fewer than ``reps``
    launches is taken again, up to ``tries`` times, and one that stays short
    is listed in ``TRACE_SHORT``. Returns the kernel's name, its counted
    launches a call, its traced launches a call, and its device ms a launch
    (its time over its traced launches); None when no trace holds a device
    event (listed in ``TRACE_MISSES``)."""
    call = _counted(fn, counter)
    call()

    def run():
        for _ in range(reps):
            call()
    op = None
    for _ in range(tries):
        rows = trace_rows(run, what)
        if not rows:
            break
        ops = [(name[:80], n, us) for us, n, name in rows if us > 0]
        if len(ops) != 1 or ops[0][1] > reps:
            raise AssertionError(f"{what}: not one device op a call: "
                                 f"{[(o[0], o[1] / reps) for o in ops]}")
        if op is None or ops[0][1] > op[1]:
            op = ops[0]
        if op[1] == reps:
            break
    if call.launched() != call.calls:
        raise AssertionError(f"{what}: {call.launched()} launches counted "
                             f"over {call.calls} calls")
    if op is None:
        return None
    name, n, us = op
    if n < reps:
        TRACE_SHORT.append(f"{what}: {n} of {reps}")
    return dict(kernel=name, launches_a_call=call.launched() / call.calls,
                traced_a_call=n / reps, ms_a_launch=us / n / 1e3)


def cold_sets(nbytes):
    """How many sets of buffers, ``nbytes`` each, a timing takes in turn so
    that together they fill four times the card's L2: a set's bytes have
    left the L2 before its turn comes again, so each call reads and writes
    HBM, as a bytes bound at ``HBM_BYTES_PER_S`` assumes."""
    l2 = torch.cuda.get_device_properties(DEV).L2_cache_size
    return max(2, -(-4 * l2 // nbytes))


def rotating(sets, call):
    """A function that runs ``call(*s)`` for the sets ``s`` of ``sets`` in
    turn, one set a call."""
    it = itertools.cycle(sets)
    return lambda: call(*next(it))


def time_k1(gen):
    """The paged engine's drain: the K and V planes ``dest[24, 16384, 2048]``
    (each a narrowed pool with spare rows) of one routing list of 64 int64
    rows, all valid, in one ``staged_scatter_planes`` launch, against the
    plain version (a loop over ``staged_scatter_ref``) and one
    ``index_copy_`` a plane (two calls: no PyTorch call drains two planes);
    the gated drain with no valid row; one plane alone (``one_plane``,
    ``staged_scatter_layers``, the shape that earlier records timed). Timed
    cold, as the engine drains: every call takes the next of
    ``cold_sets`` sets of staging planes and rows (the pools shared), so
    its bytes come from HBM as the bound counts them. ``l2_warm_ms``: the
    same set every call, its bytes in the L2 (not held to the bound)."""
    l, r, w, n = 24, 16384, 2048, 64
    stores = [torch.zeros((l, r + 16, w), dtype=torch.bfloat16, device=DEV)
              for _ in range(2)]
    valid = torch.ones(n, dtype=torch.bool, device=DEV)
    none = torch.zeros(n, dtype=torch.bool, device=DEV)
    nbytes = COST.k1_cost(n, n, w, 2, 8, planes=2 * l)[1]
    sets = [([(st[:, :r], torch.randn((l, n, w), generator=gen,
                                      device=DEV).to(torch.bfloat16))
              for st in stores],
             torch.randperm(r, generator=gen, device=DEV)[:n])
            for _ in range(cold_sets(nbytes))]

    def library(planes, rows):
        for dest, staging in planes:
            dest.index_copy_(1, rows, staging)

    kernel = rotating(sets, lambda planes, rows: staged_scatter_planes(
        planes, rows, valid))
    t = timings("staged_scatter", kernel,
                rotating(sets, lambda planes, rows: staged_scatter_planes_ref(
                    planes, rows, valid)),
                rotating(sets, library))
    ops = one_device_op(kernel, "staged_scatter paged drain, device ops",
                        "staged_scatter")
    ms_empty = device_ms(rotating(sets, lambda planes, rows:
                                  staged_scatter_planes(planes, rows, none)),
                         "staged_scatter, no valid row")
    warm = device_ms(lambda: staged_scatter_planes(*sets[0], valid),
                     "staged_scatter paged drain, L2 warm")
    # one plane: the K and V planes of every set in turn, twice the sets
    planes1 = [([p], rows) for planes, rows in sets for p in planes]
    one = timings(
        "staged_scatter one plane",
        rotating(planes1, lambda planes, rows: staged_scatter_layers(
            *planes[0], rows, valid)),
        rotating(planes1, lambda planes, rows: staged_scatter_planes_ref(
            planes, rows, valid)),
        rotating(planes1, library))
    one["bound_ms"] = (COST.k1_cost(n, n, w, 2, 8, planes=l)[1]
                       / HBM_BYTES_PER_S * 1e3)
    return dict(**t,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                library_of="two index_copy_ calls, one a plane",
                device_op=ops, ms_no_valid_rows=ms_empty,
                l2_warm_ms=warm, cold_sets=len(sets), one_plane=one,
                shape=f"K and V: dest[{l},{r},{w}] staging[{l},{n},{w}] "
                      f"bf16, {n} valid int64 rows, one launch, cold")


# ---------------------------------------------------------------------------
# K2 flash_decode_paged
# ---------------------------------------------------------------------------


def _k2_inputs(gen, dtype, b, c, hq, hkv, d, nb, ps, p, r, ring_kind="partial",
               dead_slot=False, masked_row=False, live="random"):
    """K2's operands. ``live`` places the live view keys: "random" (65 %
    of the keys), "first" / "last" (only in the first / last page of each
    slot), "ring" (none in the view: only the ring's lanes), "holes" (live
    pages with dead pages between them), "shared" (random, and every slot's
    page table the same block ids), "prefix" (as a prefix-cache hit makes
    it: every slot's leading half of the pages the same blocks; slot 0's
    chunk starts at ``cached_rows``, a page multiple; slot 1 runs the 1-row
    chunk of a fully cached prompt at ``plen - 1``; each column sees the
    rows up to its own position, as the engine's view mask gives them)."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    q, pk, pv = rn(b, c, hq, d), rn(nb, ps, hkv, d), rn(nb, ps, hkv, d)
    blocks = torch.randint(0, nb, (b, p), generator=gen, device=DEV,
                           dtype=torch.int32)
    view_ok = torch.rand((b, c, p * ps), generator=gen, device=DEV) > 0.35
    page = torch.arange(p * ps, device=DEV) // ps
    if live == "first":
        view_ok &= page == 0
    elif live == "last":
        view_ok &= page == p - 1
    elif live == "ring":
        view_ok[:] = False
    elif live == "holes":
        view_ok &= page % 3 == 1
    elif live == "shared":
        blocks[:] = blocks[0]
    elif live == "prefix":
        n_sh = p // 2
        blocks[:, :n_sh] = blocks[0, :n_sh]
        start = torch.randint(0, p * ps - c + 1, (b,), generator=gen,
                              device=DEV)
        start[0], start[1] = n_sh * ps, (n_sh + 1) * ps - 1
        view_ok = (torch.arange(p * ps, device=DEV)[None, None]
                   <= (start[:, None] + torch.arange(c, device=DEV)[None])
                   [..., None]).contiguous()
    ring = (None, None, None)
    if r:
        ring_ok = {
            "empty": torch.zeros((b, r), dtype=torch.bool, device=DEV),
            "partial": (torch.arange(r, device=DEV)[None] < r // 2).expand(b, r).contiguous(),
            "full": torch.ones((b, r), dtype=torch.bool, device=DEV),
        }[ring_kind]
        ring = (rn(b, r, hkv, d), rn(b, r, hkv, d), ring_ok)
    if dead_slot:  # a retired slot: clamped page table, nothing valid
        blocks[0] = 0
        view_ok[0] = False
        if r:
            ring[2][0] = False
    if masked_row:  # one query column with every source masked
        view_ok[-1, -1] = False
        if r:
            ring[2][-1] = False
    return (q, pk, pv, blocks, view_ok) + ring


# b, c, hq, hkv, d, nb, ps, p, r, live: the cases of the cluster design.
# One (slot, head) over 64 pages of 16 has 8 splits on 132 SMs, so a
# cluster holds blocks with live pages and blocks with none; live keys only
# in the first page, the last page or the ring; dead pages between live
# ones; one page table shared by every slot; C = 8 with GQA 28/4 and 48/8
# at D = 128 (4 and 3 groups of 16 query rows, columns across the groups);
# ragged pages (ps 3) past one 128-key group of the mask; page tables whose
# leading blocks every slot shares, cursors past the cached rows and a 1-row
# chunk at plen - 1, as the prefix cache makes them (C = 4 with GQA 8/2,
# and the slice's C = 16 with 32 heads)
K2_LIVE_CASES = [(1, 1, 4, 1, 64, 80, 16, 64, 8, "first"),
                 (1, 1, 4, 1, 64, 80, 16, 64, 8, "last"),
                 (1, 1, 4, 1, 64, 80, 16, 64, 8, "ring"),
                 (1, 1, 4, 1, 64, 80, 16, 64, 8, "holes"),
                 (1, 2, 4, 1, 64, 80, 16, 64, 8, "random"),
                 (3, 1, 4, 2, 64, 30, 16, 20, 8, "shared"),
                 (2, 8, 28, 4, 128, 40, 16, 12, 8, "random"),
                 (2, 8, 48, 8, 128, 40, 16, 12, 8, "holes"),
                 (2, 8, 28, 4, 128, 40, 16, 12, 0, "last"),
                 (2, 3, 4, 2, 32, 200, 3, 90, 5, "holes"),
                 (4, 4, 8, 2, 64, 40, 16, 12, 8, "prefix"),
                 (4, 16, 32, 32, 64, 60, 16, 20, 8, "prefix")]


def check_k2(gen):
    """Every case within TOL_F32 / TOL_BF16 of the plain version; returns
    the largest error and the largest share of the tolerance used, by
    dtype."""
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    share = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    shapes = []  # b, c, hq, hkv, d, nb, ps, p, r, live
    for d in (16, 64):
        for c in (1, 8):
            for (hq, hkv) in ((4, 4), (8, 2)):
                shapes.append((3, c, hq, hkv, d, 12, 4, 5, 6, "random"))
    shapes += [(2, 1, 8, 1, 128, 6, 8, 3, 4, "random"),    # MQA, D=128
               (2, 3, 6, 3, 32, 9, 2, 6, 0, "random"),     # odd sizes, no ring
               (2, 1, 4, 4, 64, 40, 16, 20, 8, "random")]  # several tiles
    shapes += K2_LIVE_CASES
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for shp in shapes:
            r, live = shp[-2], shp[-1]
            kinds = ("empty", "partial", "full") if r else ("none",)
            if live != "random":
                kinds = kinds[-1:] if live == "ring" else kinds[:1]
            for kind in kinds:
                for dead, masked in ((False, False), (True, True)):
                    args = _k2_inputs(gen, dtype, *shp[:-1], ring_kind=kind,
                                      dead_slot=dead, masked_row=masked,
                                      live=live)
                    got = flash_decode_paged(*args)
                    want = flash_decode_paged_ref(*args)
                    torch.cuda.synchronize()
                    if not torch.isfinite(got.float()).all():
                        raise AssertionError(f"non-finite output {shp} {kind}")
                    torch.testing.assert_close(
                        got.float(), want.float(), **tol,
                        msg=lambda m: f"flash_decode_paged {dtype} {shp} "
                                      f"{kind} dead={dead}: {m}")
                    errs[dtype] = max(errs[dtype], float(
                        (got.float() - want.float()).abs().max()))
                    share[dtype] = max(share[dtype], float((
                        (got.float() - want.float()).abs()
                        / (tol["atol"] + tol["rtol"] * want.float().abs())
                    ).max()))
                    cases += 1
    return errs, cases, share


def _k2_slice_inputs(gen, c):
    b, hq, hkv, d, nb, ps, p, r = 8, 32, 32, 64, 1024, 16, 128, 8
    dt = torch.bfloat16
    pk = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dt)
    pv = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dt)
    q = torch.randn((b, c, hq, d), generator=gen, device=DEV).to(dt)
    blocks = torch.randperm(nb, generator=gen, device=DEV).view(b, p).to(torch.int32)
    pos = torch.randint(600, 2040, (b,), generator=gen, device=DEV)
    view_ok = (torch.arange(p * ps, device=DEV)[None, None, :]
               <= (pos[:, None, None] - (c - 1)
                   + torch.arange(c, device=DEV)[None, :, None]))
    view_ok = view_ok.contiguous()
    rk = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dt)
    rv = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dt)
    rok = (torch.arange(r, device=DEV)[None] < 5).expand(b, r).contiguous()
    return q, pk, pv, blocks, view_ok, rk, rv, rok


def _as_f32(args):
    return tuple(t.float() if t is not None and t.is_floating_point() else t
                 for t in args)


def _k2_engine_inputs(gen, dtype=torch.bfloat16):
    """K2 at the paged engine's decode step (the slice: stablelm-1.6b, 8
    slots, 128 pages of 16, ring of 8): slot i's live prefix is a prompt of
    128 / 256 / 384 / 512 tokens plus up to 64 generated ones, 128-575 keys
    of its 2048-row view; pages are allocated for the prefix only and the
    rest of the page table is clamped to block 0, as ``kernel_blocks`` makes
    it; the last 5 tokens sit in the ring's 5 live lanes, their view rows
    shadowed out."""
    b, hq, hkv, d, ps, p, r = 8, 32, 32, 64, 16, 128, 8
    nb = b * p
    pk = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    pv = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    q = torch.randn((b, 1, hq, d), generator=gen, device=DEV).to(dtype)
    n = (torch.tensor(PROMPT_LENS * (b // len(PROMPT_LENS)), device=DEV)
         + torch.randint(0, NEW_TOKENS, (b,), generator=gen, device=DEV))
    pages = (n + ps - 1) // ps
    ids = torch.randperm(nb, generator=gen, device=DEV).view(b, p)
    blocks = torch.where(torch.arange(p, device=DEV)[None] < pages[:, None],
                         ids, 0).to(torch.int32)
    n_ring = 5
    view_ok = (torch.arange(p * ps, device=DEV)[None]
               < (n - n_ring)[:, None])[:, None, :].contiguous()
    rk = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    rv = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    rok = (torch.arange(r, device=DEV)[None] < n_ring).expand(b, r)
    return q, pk, pv, blocks, view_ok, rk, rv, rok.contiguous()


def _check_k2_at(what, args):
    """The kernel at a real shape. In fp32 it must meet the plain version
    within TOL_F32, which a dropped key or ring lane breaks. In bf16 it is
    held by ``held_bf16`` to the plain version run in fp32 on the same
    (upcast) inputs, over the tensor and query row by query row."""
    args32 = _as_f32(args)
    ref32 = flash_decode_paged_ref(*args32)
    got32 = flash_decode_paged(*args32)
    torch.testing.assert_close(
        got32, ref32, **TOL_F32,
        msg=lambda m: f"flash_decode_paged fp32, {what}: {m}")
    got, plain = flash_decode_paged(*args), flash_decode_paged_ref(*args)
    torch.cuda.synchronize()
    b, c, hq, d = got.shape
    rows = [x.reshape(b, c * hq, d) for x in (got, plain, ref32)]
    h = held_bf16("flash_decode_paged", what, *rows, K2_ROWS)
    return dict(err_f32=float((got32 - ref32).abs().max()),
                err_bf16_vs_f32_ref=h["err"],
                plain_err_bf16_vs_f32_ref=h["err_plain"],
                worst_block_share=h["worst_block_share"],
                err_bf16_vs_plain=h["err_vs_plain"],
                out_rms=float(ref32.square().mean().sqrt()))


def check_k2_slice(gen, c):
    return dict(c=c, **_check_k2_at(f"slice shape, C={c}",
                                    _k2_slice_inputs(gen, c)))


def check_k2_engine(gen):
    return _check_k2_at("engine shape", _k2_engine_inputs(gen))


def _k2_plan(args):
    """(splits a cluster, blocks a call) of the kernel on these operands."""
    q, pk, pv, blocks, _, rk, rv, _ = args
    b, c, hq, _ = q.shape
    hkv = pk.shape[2]
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    n_split = FD.paged_kernel_plan(q, pk, pv, blocks, rk, rv, sms)
    return n_split, n_split * hkv * -(-c * hq // hkv // FD.BLOCK_ROWS) * b


def _k2_bound(args):
    """The least time of the function on these operands, and what sets it.
    The work depends on the data: a masked key adds exactly 0 to a row with
    one live key, so the function needs the K and V rows that some query
    column of their slot sees, and no other. A pool row that several slots
    see (a shared prefix block) is one input: its bytes count once, its
    products once per slot."""
    q, pk, _, blocks, view_ok, _, _, rok = args
    b, c, hq, d = q.shape
    ps, hkv, es = pk.shape[1], pk.shape[2], q.element_size()
    assert bool((view_ok.any(2) | rok.any(1)[:, None]).all()), \
        "a row has no live key"
    live = view_ok.any(1)
    live_keys = int(live.sum()) + int(rok.sum())
    phys = (blocks.long()[:, :, None] * ps
            + torch.arange(ps, device=q.device)[None, None]).reshape(b, -1)
    read_keys = int(torch.unique(phys[live]).numel()) + int(rok.sum())
    small = (2 * q.numel() * es                       # q in, out
             + blocks.numel() * 4 + view_ok.numel() + rok.numel())
    t_bytes = (read_keys * hkv * d * 2 * es + small) / HBM_BYTES_PER_S
    t_ops = 4 * c * hq * live_keys * d / PEAK_FLOPS[q.dtype]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _k2_facts(args):
    """What is stated beside K2's times on these operands: its live and all
    keys, the time reading every view row and ring lane once (live or not)
    would take at the memory's rate, its split plan, the shape."""
    q, pk, _, blocks, view_ok, rk, _, rok = args
    b, c, hq, d = q.shape
    ps, hkv, es = pk.shape[1], pk.shape[2], q.element_size()
    p, r = blocks.shape[1], rk.shape[1]
    all_keys = b * (p * ps + r)
    small = (2 * q.numel() * es + blocks.numel() * 4 + view_ok.numel()
             + rok.numel())
    n_split, n_blocks = _k2_plan(args)
    phys = (blocks.long()[:, :, None] * ps
            + torch.arange(ps, device=q.device)[None, None]).reshape(b, -1)
    return dict(live_keys=int(view_ok.any(1).sum()) + int(rok.sum()),
                distinct_live_pool_rows=int(torch.unique(
                    phys[view_ok.any(1)]).numel()),
                all_keys=all_keys,
                all_rows_ms=(all_keys * hkv * d * 2 * es + small)
                / HBM_BYTES_PER_S * 1e3,
                splits_per_cluster=n_split, blocks_per_call=n_blocks,
                shape=f"q[{b},{c},{hq},{d}] pages[{pk.shape[0]},{ps},{hkv},{d}] "
                      f"blocks[{b},{p}] ring[{b},{r},{hkv},{d}] {q.dtype}")


def _k2_timed(name, args):
    """Device times of the kernel, the plain version and the library
    yardstick on these operands, and the kernel's bound on them."""
    q, pk, pv, blocks, view_ok, rk, rv, rok = args
    b, c, hq, d = q.shape
    ps, hkv, r = pk.shape[1], pk.shape[2], rk.shape[1]

    def library():
        # yardstick only: gathered view + one fused PyTorch attention call
        rows = (blocks.long()[:, :, None] * ps
                + torch.arange(ps, device=DEV)[None, None]).reshape(b, -1)
        k = torch.cat([pk.reshape(-1, hkv, d)[rows], rk], 1).transpose(1, 2)
        v = torch.cat([pv.reshape(-1, hkv, d)[rows], rv], 1).transpose(1, 2)
        mask = torch.cat([view_ok, rok[:, None, :].expand(b, c, r)], 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:, None])
    t = timings(name, lambda: flash_decode_paged(*args),
                lambda: flash_decode_paged_ref(*args), library)
    return dict(**t, **_k2_bound(args))


# b, c, hq, hkv, d, nb, ps, p, r: shapes on which the split plan picks more
# than one split (a single request decoding alone: stablelm-1.6b, and
# qwen2-7b's GQA 28/4 at D = 128 with C = 8), over a 2048-row view
K2_SPLIT_TIMED = [(1, 1, 32, 32, 64, 1024, 16, 128, 8),
                  (1, 8, 28, 4, 128, 1024, 16, 128, 8)]


def time_k2_splits(gen):
    """K2 at the plan's splits and at one split on the same operands."""
    out = []
    for shp in K2_SPLIT_TIMED:
        args = _k2_inputs(gen, torch.bfloat16, *shp)
        facts = _k2_facts(args)
        ms = device_ms(lambda: flash_decode_paged(*args), "K2 split plan")
        plan = FD._paged_splits
        FD._paged_splits = lambda *a, **k: 1
        try:
            ms_one = device_ms(lambda: flash_decode_paged(*args),
                               "K2 one split")
        finally:
            FD._paged_splits = plan
        out.append(dict(shape=facts["shape"], live_keys=facts["live_keys"],
                        splits_per_cluster=facts["splits_per_cluster"],
                        blocks_per_call=facts["blocks_per_call"], ms=ms,
                        ms_one_split=ms_one, **_k2_bound(args)))
    return out


def time_k2(gen):
    """At the slice shape (as timed since the first port) and at the engine's
    own shape, where most of each view is dead: the kernels line's times and
    bounds, and the facts beside them for the checks line."""
    slice_args = _k2_slice_inputs(gen, 1)
    engine_args = _k2_engine_inputs(gen)
    t = _k2_timed("flash_decode_paged", slice_args)
    t["engine_shape"] = _k2_timed("flash_decode_paged engine", engine_args)
    split_plan = time_k2_splits(gen)
    # drawn last, so the inputs timed before stay as they were
    chunk_args = _k2_chunk_inputs(gen)
    t["chunk_shape"] = _k2_timed("flash_decode_paged chunk", chunk_args)
    prefix_args = _k2_prefix_inputs(gen)
    t["prefix_shape"] = _k2_timed("flash_decode_paged prefix", prefix_args)
    # the speculative verify, from a generator of its own
    verify_args = _k2_verify_inputs(timed_gen(110))
    t["verify_shape"] = _k2_timed("flash_decode_paged verify", verify_args)
    return t, dict(slice=_k2_facts(slice_args), engine=_k2_facts(engine_args),
                   chunk=_k2_facts(chunk_args),
                   prefix=_k2_facts(prefix_args),
                   verify=_k2_facts(verify_args), split_plan=split_plan)


# (arch, Hq, Hkv, D, tp values): the head geometries of the three paged
# archs at full width, at every mesh size whose model axis divides both;
# stablelm at tp 32 too, more shards than one launch takes (two launches)
K2_SHARDED_GEOMS = [("stablelm-1.6b", 32, 32, 64, (2, 4, 8, 32)),
                    ("qwen2-7b", 28, 4, 128, (2, 4)),
                    ("nemotron-4-15b", 48, 8, 128, (2, 4, 8))]


def _virtual_mesh(tp):
    """A 1-D ``model`` mesh of ``tp`` virtual devices, all the card."""
    return Mesh([DEV] * tp, (tp,), ("model",))


def _place_heads(args, mesh):
    """K2's operands with the pool and ring planes split on their head axis
    over ``mesh`` (as the sharded engine holds them)."""
    q, pk, pv, blocks, view_ok, rk, rv, rok = args
    sharding = NamedSharding(mesh, (None, None, "model", None))

    def place(t):
        return None if t is None else ShardedTensor.place(t, sharding)
    return (q, place(pk), place(pv), blocks, view_ok, place(rk), place(rv),
            rok)


def _check_k2_sharded_at(what, args, mesh):
    """The sharded read at a main-path shape (bf16 operands, as the engine
    holds them), the pool and ring placed on ``mesh``: in bf16 and on the
    fp32 upcast it equals unsharded K2 (``torch.equal``); in fp32 it is
    within TOL_F32 of its plain version; in bf16 within TOL_BF16 of it and
    held by ``held_bf16`` to the plain version run in fp32. Returns the
    largest error against the plain version (fp32, bf16)."""
    what = f"flash_decode_paged_sharded {what}"
    out = []
    for xs in (_as_f32(args), args):
        placed = _place_heads(xs, mesh)
        got = flash_decode_paged_sharded(mesh, *placed)
        whole = flash_decode_paged(*xs)
        plain = flash_decode_paged_sharded_ref(mesh, *placed)
        torch.cuda.synchronize()
        if not torch.equal(got, whole):
            diff = (got.float() - whole.float()).abs().max()
            raise AssertionError(f"{what} {got.dtype}: not equal to "
                                 f"unsharded K2, max diff {float(diff)}")
        tol = TOL_F32 if got.dtype == torch.float32 else TOL_BF16
        torch.testing.assert_close(got.float(), plain.float(), **tol,
                                   msg=lambda m: f"{what} {got.dtype}: {m}")
        out.append((got, plain))
    (_, ref32), (got, plain) = out
    b, c, hq, d = got.shape
    rows = [x.reshape(b, c * hq, d) for x in (got, plain, ref32)]
    held_bf16("flash_decode_paged_sharded", what, *rows, K2_ROWS)
    return (float((out[0][0] - ref32).abs().max()),
            float((got.float() - plain.float()).abs().max()))


def check_k2_sharded(gen):
    """``flash_decode_paged_sharded`` on virtual meshes of the card (one
    grid over every shard: one launch a call, one per ``MAX_SHARDS`` shards
    past that): equal to unsharded K2 on the
    same operands (``torch.equal``: the launch takes the whole shape's
    split count) and within TOL_F32 / TOL_BF16 of its plain version (the
    plain K2 over the device's shards joined), on small shapes of every
    geometry, the planes placed on the mesh and, at tp 4, whole (cut by
    the wrapper), and on the main path's own shapes
    (``_check_k2_sharded_at``); a model axis that does not divide the heads
    raises. Returns (cases, the largest error against the plain version by
    dtype)."""
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for arch, hq, hkv, d, tps in K2_SHARDED_GEOMS:
        for c in (1, CHUNK):
            for r in (8, 0):
                for dtype, tol in ((torch.float32, TOL_F32),
                                   (torch.bfloat16, TOL_BF16)):
                    args = _k2_inputs(gen, dtype, 3, c, hq, hkv, d, 40, 16,
                                      12, r)
                    whole = flash_decode_paged(*args)
                    for tp, whole_planes in [(t, False) for t in tps] + [
                            (4, True)]:
                        mesh = _virtual_mesh(tp)
                        placed = (args if whole_planes
                                  else _place_heads(args, mesh))
                        reset_launch_counts()
                        got = flash_decode_paged_sharded(mesh, *placed)
                        want = -(-tp // FD.MAX_SHARDS)
                        if launch_counts()["flash_decode_paged_sharded"] \
                                != want:
                            raise AssertionError(
                                f"flash_decode_paged_sharded: "
                                f"{launch_counts()} launches on a virtual "
                                f"mesh of tp {tp}, not {want}")
                        plain = flash_decode_paged_sharded_ref(mesh, *placed)
                        torch.cuda.synchronize()
                        what = (f"flash_decode_paged_sharded {arch} tp {tp} "
                                f"C={c} R={r} {dtype}"
                                + (" whole planes" if whole_planes else ""))
                        if not torch.equal(got, whole):
                            diff = (got.float() - whole.float()).abs().max()
                            raise AssertionError(
                                f"{what}: not equal to unsharded K2, max "
                                f"diff {float(diff)}")
                        torch.testing.assert_close(
                            got.float(), plain.float(), **tol,
                            msg=lambda m: f"{what}: {m}")
                        errs[dtype] = max(errs[dtype], float(
                            (got.float() - plain.float()).abs().max()))
                        cases += 1
    # the shapes the main path gives it: the engine's decode step at the
    # engine_sharded tp and the memory arm's, the mixed-phase chunk step at
    # both
    for what, make in (("engine shape", _k2_engine_inputs),
                       ("chunk shape", _k2_chunk_inputs)):
        for tp in sorted({SHARDED_TP, SHARDED_MEM["tp"]}):
            err32, err = _check_k2_sharded_at(
                f"{what}, tp {tp}", make(gen), _virtual_mesh(tp))
            errs[torch.float32] = max(errs[torch.float32], err32)
            errs[torch.bfloat16] = max(errs[torch.bfloat16], err)
            cases += 2
    args = _k2_inputs(gen, torch.bfloat16, 2, 1, 6, 2, 64, 12, 4, 5, 4)
    try:
        flash_decode_paged_sharded(_virtual_mesh(4), *args)
    except ValueError as e:
        if "divide" not in str(e):
            raise
    else:
        raise AssertionError("flash_decode_paged_sharded took Hq=6, Hkv=2 "
                             "on a model axis of 4")
    return cases + 1, errs


def kernel_ms(fn, what, kernel, counter, reps=20):
    """Mean device time a call of the kernels named ``kernel`` alone: their
    mean a launch in the profiler's trace of ``reps`` calls times the
    launches a call that the wrapper counted (``launch_counts()[counter]``),
    so that events CUPTI dropped do not shorten it; None when no trace holds
    a device event. Raises when a trace holds device time but none of it is
    ``kernel``'s."""
    call = _counted(fn, counter)
    call()

    def run():
        for _ in range(reps):
            call()
    rows = trace_rows(run, what)
    if not rows:
        return None
    mine = [(us, n) for us, n, name in rows if kernel in name and us > 0]
    if not mine:
        raise AssertionError(f"{what}: the trace holds no {kernel} time: "
                             f"{[r[2] for r in rows[:8]]}")
    a_launch = sum(us for us, _ in mine) / sum(n for _, n in mine) / 1e3
    return a_launch * call.launched() / call.calls


def time_k2_sharded(gen):
    """At the engine's decode shape (``_k2_engine_inputs``) on a tp-4
    virtual mesh, the pool and ring placed on their head axis: ``ms`` the
    K2 launch's own device time a call (one grid over the four shards),
    ``wrapper_ms`` the wrapper's whole device time (which must be that one
    device op), ``unsharded_ms`` one K2 launch on the same operands, whole;
    the plain version (the plain K2 over the shards joined) and the
    library yardstick (per shard a gathered view and one SDPA call); the
    bound is K2's, the bytes of the live keys, which sharding does not
    change."""
    args = _k2_engine_inputs(gen)
    mesh = _virtual_mesh(SHARDED_TP)
    placed = _place_heads(args, mesh)
    q, pk, pv, blocks, view_ok, rk, rv, rok = args
    b, c, hq, d = q.shape
    ps, r = pk.shape[1], rk.shape[1]
    hs = hq // SHARDED_TP

    def kernel():
        return flash_decode_paged_sharded(mesh, *placed)

    def plain():
        return flash_decode_paged_sharded_ref(mesh, *placed)

    def library():
        # yardstick only: per shard a gathered view + one PyTorch attention
        rows = (blocks.long()[:, :, None] * ps
                + torch.arange(ps, device=DEV)[None, None]).reshape(b, -1)
        mask = torch.cat([view_ok, rok[:, None, :].expand(b, c, r)], 2)
        outs = []
        for j in range(SHARDED_TP):
            pkj, pvj = placed[1].shards[j], placed[2].shards[j]
            rkj, rvj = placed[5].shards[j], placed[6].shards[j]
            h = pkj.shape[2]
            k = torch.cat([pkj.reshape(-1, h, d)[rows], rkj], 1)
            v = torch.cat([pvj.reshape(-1, h, d)[rows], rvj], 1)
            outs.append(F.scaled_dot_product_attention(
                q[:, :, j * hs:(j + 1) * hs].transpose(1, 2),
                k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None]))
        return torch.cat(outs, 1)
    got, whole = kernel(), flash_decode_paged(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, whole):
        raise AssertionError("flash_decode_paged_sharded at the timed engine "
                             "shape: not equal to unsharded K2")
    torch.testing.assert_close(
        got.float(), plain().float(), **TOL_BF16,
        msg=lambda m: f"flash_decode_paged_sharded timed shape: {m}")
    t = timings("flash_decode_paged_sharded", kernel, plain, library)
    t["wrapper_ms"] = t["ms"]
    t["device_op"] = one_device_op(
        kernel, "flash_decode_paged_sharded, device ops",
        "flash_decode_paged_sharded")
    ms = kernel_ms(kernel, "flash_decode_paged_sharded K2 launch",
                   "paged_decode_kernel", "flash_decode_paged_sharded")
    if ms is not None:
        t["ms"], t["ms_of"] = ms, ("the K2 launch's own device time (one "
                                   "grid over the shards), profiler trace")
    else:
        # no trace: CUDA events around the bare launch
        n_split = FD.paged_splits(
            torch.cuda.get_device_properties(DEV).multi_processor_count, b,
            c, hq, pk.shape[2], d, blocks.shape[1], ps, r, q.element_size())
        shards = [tuple(placed[i].shards[j] for i in (1, 2, 5, 6))
                  for j in range(SHARDED_TP)]
        t["ms"] = time_ms(lambda: FD._paged_launch(q, shards, blocks, view_ok,
                                                   rok, n_split))
        t["ms_of"] = ("CUDA events around the bare launch, host gaps in (no "
                      "profiler trace)")
    t["unsharded_ms"] = device_ms(lambda: flash_decode_paged(*args),
                                  "flash_decode_paged unsharded twin")
    t["tp"] = SHARDED_TP
    t["shape"] = _k2_facts(args)["shape"] + f", tp {SHARDED_TP}"
    return dict(**t, **_k2_bound(args))


def _k2_chunk_inputs(gen, dtype=torch.bfloat16, empty_slot=False):
    """K2 at the chunked paged engine's mixed-phase step (the slice with
    ``chunk_size`` 16): ``q[8, 16, 32, 64]``, 128 pages of 16 a slot. Slots
    0-3 prefill a chunk of 16 at a cursor inside a prompt of 128 / 256 /
    384 / 512 tokens; slots 4-7 decode (column 0 live, columns 1-15 dead
    but reading what the engine's view mask gives them, the rows up to
    ``pos + j`` on allocated pages), each with its ring full: the last 8
    tokens staged, their view rows shadowed out. Pages are allocated for
    the rows the segment can reach, the rest of the page table clamped to
    block 0. ``empty_slot``: slot 7 is empty (no page, ``n_valid`` 0, every
    key of every column masked: the uniform mean)."""
    b, c, hq, hkv, d, ps, p, r = 8, CHUNK, 32, 32, 64, 16, 128, 8
    nb = b * p
    pk = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    pv = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    q = torch.randn((b, c, hq, d), generator=gen, device=DEV).to(dtype)
    plen = torch.tensor(PROMPT_LENS * 2, device=DEV)
    cursor = torch.tensor([0, 112, 240, 496], device=DEV)
    pos = plen[4:] + torch.randint(r, NEW_TOKENS - 1, (4,), generator=gen,
                                   device=DEV)
    start = torch.cat([cursor, pos])
    seg = SLICE["segment_len"]
    reach = torch.cat([torch.minimum(cursor + seg * c, plen[:4] + NEW_TOKENS),
                       torch.minimum(pos + seg, plen[4:] + NEW_TOKENS)])
    pages = (reach + ps - 1) // ps
    ids = torch.randperm(nb, generator=gen, device=DEV).view(b, p)
    live_page = torch.arange(p, device=DEV)[None] < pages[:, None]
    if empty_slot:
        live_page[-1] = False
    blocks = torch.where(live_page, ids, 0).to(torch.int32)
    rows = torch.arange(p * ps, device=DEV)
    positions = start[:, None] + torch.arange(c, device=DEV)[None]
    allocated = live_page.repeat_interleave(ps, dim=1)
    view_ok = (rows[None, None] <= positions[..., None]) & allocated[:, None]
    decode = torch.arange(b, device=DEV) >= 4
    # the ring: the decode slots' last r rows staged (this step's included)
    staged = decode[:, None] & (rows[None] > start[:, None] - r) \
        & (rows[None] <= start[:, None])
    view_ok &= ~staged[:, None]
    rok = decode[:, None].expand(b, r).clone()
    if empty_slot:
        rok[-1] = False
    rk = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    rv = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    return q, pk, pv, blocks, view_ok.contiguous(), rk, rv, rok.contiguous()


def _k2_prefix_inputs(gen, dtype=torch.bfloat16):
    """K2 at the mixed-phase step of the prefix-cached engine
    (``engine_prefix``: prompts of ``PREFIX_LENS`` opening with the same
    1024 tokens, chunks of 16): every slot's 64 leading pages are the SAME
    physical blocks. Slot 0 prefills its first chunk after a hit, at
    ``cached_rows`` 1024; slot 1 runs the 1-row chunk of its fully cached
    1152-token prompt at row 1151 (its last page a private copy); slot 2
    prefills at 1184 of 1216; slot 3 the 12 rows past its 68 cached pages;
    slots 4-7 decode with the ring full, as in ``_k2_chunk_inputs``. The
    pages past the prefix are distinct blocks, allocated for the rows the
    segment can reach, the rest of the page table clamped to block 0."""
    b, c, hq, hkv, d, ps, p, r = 8, CHUNK, 32, 32, 64, 16, 128, 8
    nb = b * p
    pk = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    pv = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    q = torch.randn((b, c, hq, d), generator=gen, device=DEV).to(dtype)
    plen = torch.tensor(PREFIX_LENS * 2, device=DEV)
    cursor = torch.tensor([PREFIX_SHARED, 1151, 1184, 1088], device=DEV)
    pos = plen[4:] + torch.randint(r, NEW_TOKENS - 1, (4,), generator=gen,
                                   device=DEV)
    start = torch.cat([cursor, pos])
    seg = SLICE["segment_len"]
    reach = torch.cat([torch.minimum(cursor + seg * c, plen[:4] + NEW_TOKENS),
                       torch.minimum(pos + seg, plen[4:] + NEW_TOKENS)])
    pages = (reach + ps - 1) // ps
    ids = torch.randperm(nb, generator=gen, device=DEV).view(b, p)
    n_sh = PREFIX_SHARED // ps
    ids[:, :n_sh] = ids[0, :n_sh]
    live_page = torch.arange(p, device=DEV)[None] < pages[:, None]
    blocks = torch.where(live_page, ids, 0).to(torch.int32)
    rows = torch.arange(p * ps, device=DEV)
    positions = start[:, None] + torch.arange(c, device=DEV)[None]
    allocated = live_page.repeat_interleave(ps, dim=1)
    view_ok = (rows[None, None] <= positions[..., None]) & allocated[:, None]
    decode = torch.arange(b, device=DEV) >= 4
    staged = decode[:, None] & (rows[None] > start[:, None] - r) \
        & (rows[None] <= start[:, None])
    view_ok &= ~staged[:, None]
    rok = decode[:, None].expand(b, r).contiguous()
    rk = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    rv = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    return q, pk, pv, blocks, view_ok.contiguous(), rk, rv, rok


def check_k2_chunk(gen):
    """K2 at the mixed-phase step's shape, with and without an empty slot,
    and with the prefix cache's aliased page tables: fp32 within TOL_F32 of
    the plain version, bf16 by ``held_bf16`` row by row against the plain
    version run in fp32."""
    out = [dict(empty_slot=e, **_check_k2_at(
        f"chunk shape, C={CHUNK}, empty slot {e}",
        _k2_chunk_inputs(gen, empty_slot=e))) for e in (False, True)]
    args = _k2_prefix_inputs(gen)
    assert bool((args[3][:, :PREFIX_SHARED // 16] == args[3][0, :PREFIX_SHARED
                                                             // 16]).all())
    out.append(dict(prefix_aliased=True, **_check_k2_at(
        f"chunk shape, C={CHUNK}, prefix-cache aliased page tables", args)))
    return out


def _k2_verify_inputs(gen, dtype=torch.bfloat16, ring_live=0):
    """K2 at the speculative verify (``engine_spec``: the slice with
    ``SpecConfig(k=4)``): ``q[8, 5, 32, 64]``, 128 pages of 16. Slot i has
    written a prompt of 128 / 256 / 384 / 512 tokens plus up to 59
    generated ones and verifies the 5 rows from its position ``pos``:
    column j reads the rows up to ``pos + j``. Pages cover the request's
    whole footprint (blocking admission), the rest of the page table is
    clamped to block 0. The ring planes are there (the adaptive path) with
    no live lane, as a spec segment leaves them; ``ring_live`` lanes live
    (the rows before ``pos``, shadowed out of the view) hold the kernel to
    a ring it must not assume empty."""
    b, c, hq, hkv, d, ps, p, r = 8, SPEC_K + 1, 32, 32, 64, 16, 128, 8
    nb = b * p
    pk = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    pv = torch.randn((nb + 1, ps, hkv, d), generator=gen, device=DEV).to(dtype)
    q = torch.randn((b, c, hq, d), generator=gen, device=DEV).to(dtype)
    plen = torch.tensor(PROMPT_LENS * 2, device=DEV)
    pos = plen + torch.randint(0, NEW_TOKENS - c, (b,), generator=gen,
                               device=DEV)
    pages = (plen + NEW_TOKENS - 1 + ps - 1) // ps
    ids = torch.randperm(nb, generator=gen, device=DEV).view(b, p)
    live_page = torch.arange(p, device=DEV)[None] < pages[:, None]
    blocks = torch.where(live_page, ids, 0).to(torch.int32)
    rows = torch.arange(p * ps, device=DEV)
    positions = pos[:, None] + torch.arange(c, device=DEV)[None]
    allocated = live_page.repeat_interleave(ps, dim=1)
    view_ok = (rows[None, None] <= positions[..., None]) & allocated[:, None]
    staged = (rows[None] >= (pos - ring_live)[:, None]) & (rows[None]
                                                           < pos[:, None])
    view_ok &= ~staged[:, None]
    rok = (torch.arange(r, device=DEV)[None] < ring_live).expand(b, r)
    rk = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    rv = torch.randn((b, r, hkv, d), generator=gen, device=DEV).to(dtype)
    return q, pk, pv, blocks, view_ok.contiguous(), rk, rv, rok.contiguous()


def check_k2_verify(gen):
    """K2 at the verify's shape (C = k + 1 = 5: an odd row count), the
    ring empty as the engine leaves it and with 3 live lanes: fp32 within
    TOL_F32 of the plain version, bf16 by ``held_bf16`` row by row against
    the plain version run in fp32."""
    return [dict(ring_live=n, **_check_k2_at(
        f"verify shape, C={SPEC_K + 1}, {n} live ring lanes",
        _k2_verify_inputs(gen, ring_live=n))) for n in (0, 3)]


# ---------------------------------------------------------------------------
# K3 flash_attention
# ---------------------------------------------------------------------------


def _k3_inputs(gen, dtype, b, hq, hkv, s, t, d, model_layout=True):
    """q [B,Hq,S,D], k/v [B,Hkv,T,D]; by default [B,S,H,D] tensors seen
    transposed, as the model passes them."""
    def rn(h, n):
        if model_layout:
            return torch.randn((b, n, h, d), generator=gen,
                               device=DEV).to(dtype).transpose(1, 2)
        return torch.randn((b, h, n, d), generator=gen, device=DEV).to(dtype)
    return rn(hq, s), rn(hkv, t), rn(hkv, t)


# b, hq, hkv, s, t, d, causal, window: head_dim 64 / 120 / 128, GQA group 1
# and 4, S = T and S < T, window 0 and < S, ragged S and T; the paged
# engine's prefill shapes (stablelm: 32 heads of 64, two prompts of 128,
# 256, 384 and 512 tokens a call); a window that cuts 64-key tiles partway
# (4000 at S = T = 4608). For the 192-row blocks and 64-key tiles of the
# wgmma design: S and T not multiples of 64 (200 / 300, 333 / 1000),
# windows that cut 64-key tiles (100 at 333 / 1000, 200 at 1000), GQA
# group 8, and D = 128 with GQA at ragged S = T
K3_CASES = [(1, 4, 4, 1, 1, 64, True, 0), (2, 4, 1, 37, 37, 120, True, 0),
            (1, 8, 2, 37, 1000, 128, True, 16),
            (1, 4, 4, 1000, 1000, 120, True, 300),
            (2, 8, 2, 128, 128, 64, False, 0),
            (1, 4, 1, 64, 200, 120, False, 50),
            (1, 4, 1, 300, 4608, 64, True, 4096),
            (1, 2, 2, 700, 700, 120, True, 0),
            (1, 4, 1, 4608, 4608, 120, True, 4096),
            (2, 32, 32, 512, 512, 64, True, 0),
            (2, 32, 32, 384, 384, 64, True, 0),
            (1, 4, 1, 4608, 4608, 120, True, 4000),
            (2, 32, 32, 256, 256, 64, True, 0),
            (2, 32, 32, 128, 128, 64, True, 0),
            (2, 4, 2, 200, 300, 128, True, 0),
            (1, 8, 1, 333, 1000, 120, True, 100),
            (1, 8, 1, 1000, 1000, 64, True, 200),
            (2, 8, 2, 200, 300, 120, False, 0),
            (1, 16, 2, 333, 333, 128, True, 0)]
# bf16 is held block by block: K3 by its query tile (64 rows of one head),
# so the rows past the window form blocks of their own; K2 and K4 row by row
K3_TILE, K4_ROWS, K2_ROWS = 64, 1, 1


def _block_max(x, rows):
    """max |x| over each block of ``rows`` consecutive query rows of one
    (batch, head): ``[B,H,S,D]`` -> ``[B,H,ceil(S/rows)]``; a ``[B,H,D]``
    decode output counts as S = 1."""
    x = x.abs()
    if x.dim() == 3:
        x = x[:, :, None]
    pad = -x.shape[2] % rows
    x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(x.shape[0], x.shape[1], -1, rows * x.shape[3]).amax(-1)


def held_bf16(name, case, got, plain, ref32, rows):
    """The bf16 rule. ``ref32`` is the plain version run in fp32 on the same
    (upcast) inputs. Over the whole tensor the kernel may err at most
    SLICE_ERR_FACTOR times as far from it as the plain bf16 version. Block by
    block (``_block_max``), the same, plus half a bf16 ulp of the block's
    largest value, the error of rounding an exact result to bf16, which both
    versions pay. (The plain version rounds q.k to bf16 before the softmax,
    the kernels keep fp32 scores, so a fixed tolerance against the plain bf16
    output does not fit every case.) Returns what the phase reports."""
    diff, diff_plain = got.float() - ref32, plain.float() - ref32
    err, err_plain = float(diff.abs().max()), float(diff_plain.abs().max())
    if not err <= SLICE_ERR_FACTOR * err_plain:
        raise AssertionError(
            f"{name} bf16 {case}: error {err} against the fp32 reference, "
            f"the plain version's is {err_plain}")
    blk, blk_plain = _block_max(diff, rows), _block_max(diff_plain, rows)
    limit = SLICE_ERR_FACTOR * blk_plain + 2.0 ** -8 * _block_max(ref32, rows)
    share = float((blk / limit.clamp(min=1e-30)).max())
    if not bool((blk <= limit).all()):
        i = int((blk - limit).argmax())
        raise AssertionError(
            f"{name} bf16 {case}: block {i} ({rows} rows each) errs "
            f"{float(blk.flatten()[i])}, its limit is "
            f"{float(limit.flatten()[i])} (the plain version's error there "
            f"is {float(blk_plain.flatten()[i])})")
    return dict(err=err, err_plain=err_plain, worst_block_share=share,
                err_vs_plain=float((got.float() - plain.float()).abs().max()))


def check_bf16(name, case, kernel, plain, args, rows):
    """``held_bf16`` on the kernel's and the plain version's outputs; returns
    the kernel's max abs difference from the plain bf16 version and the
    largest share of its block limit that any block used."""
    got, want = kernel(*args), plain(*args)
    ref32 = plain(*_as_f32(args))
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} non-finite, bf16 {case}")
    h = held_bf16(name, case, got, want, ref32, rows)
    return h["err_vs_plain"], h["worst_block_share"]


def check_k3(gen):
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases, share = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, hq, hkv, s, t, d, causal, w) in enumerate(K3_CASES):
            q, k, v = _k3_inputs(gen, dtype, b, hq, hkv, s, t, d,
                                 model_layout=i % 2 == 0)
            if dtype == torch.bfloat16:
                e, sh = check_bf16(
                    "flash_attention", K3_CASES[i],
                    lambda *a: flash_attention(*a, causal, w),
                    lambda *a: flash_attention_ref(*a, causal, w), (q, k, v),
                    K3_TILE)
                errs[dtype], share = max(errs[dtype], e), max(share, sh)
                cases += 1
                continue
            got = flash_attention(q, k, v, causal, w)
            want = flash_attention_ref(q, k, v, causal, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got, want, **TOL_F32,
                msg=lambda m: f"flash_attention fp32 {K3_CASES[i]}: {m}")
            errs[dtype] = max(errs[dtype], float((got - want).abs().max()))
            cases += 1
    return errs, cases, share


def _k3_slice_inputs(gen, dtype=torch.bfloat16):
    c = get_config(LANES["arch"])
    return _k3_inputs(gen, dtype, LANES_GROUP, c.n_heads, c.n_kv_heads,
                      max(LANES_PROMPTS), max(LANES_PROMPTS),
                      c.resolved_head_dim)


def check_k3_slice(gen):
    """At the lanes slice's prefill shape: fp32 within TOL_F32 of the plain
    version; bf16 by ``held_bf16``, block by block of 64 query rows."""
    window = get_config(LANES["arch"]).sliding_window
    args = _k3_slice_inputs(gen)
    args32 = tuple(x.float() for x in args)
    ref32 = flash_attention_ref(*args32, True, window)
    got32 = flash_attention(*args32, True, window)
    torch.testing.assert_close(
        got32, ref32, **TOL_F32,
        msg=lambda m: f"flash_attention fp32, slice shape: {m}")
    err_f32 = float((got32 - ref32).abs().max())
    del got32
    got = flash_attention(*args, True, window)
    plain = flash_attention_ref(*args, True, window)
    torch.cuda.synchronize()
    h = held_bf16("flash_attention", "slice shape", got, plain, ref32, K3_TILE)
    out_rms = float(ref32.square().mean().sqrt())
    del got, plain, ref32
    torch.cuda.empty_cache()
    return dict(err_f32=err_f32, err_bf16_vs_f32_ref=h["err"],
                plain_err_bf16_vs_f32_ref=h["err_plain"],
                worst_block_share=h["worst_block_share"], out_rms=out_rms)


def time_k3(gen):
    window = get_config(LANES["arch"]).sliding_window
    q, k, v = _k3_slice_inputs(gen)
    b, hq, s, d = q.shape
    t = k.shape[2]
    t_ = timings("flash_attention",
                 lambda: flash_attention(q, k, v, True, window),
                 lambda: flash_attention_ref(q, k, v, True, window),
                 # yardstick only: causal, no window (SDPA takes no window
                 # rule but an explicit mask, which would time its masked path)
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=True, enable_gqa=True))
    pairs = live_pairs(s, t, True, window)
    bound, by = COST.bound_ms(*COST.k3_cost(
        q.shape, k.shape, q.element_size(), True, window), q.dtype)
    return dict(**t_, bound_ms=bound, bound_by=by,
                live_pairs_per_head=pairs,
                shape=f"q[{b},{hq},{s},{d}] k/v[{b},{k.shape[1]},{t},{d}] "
                      f"bf16 (strided views of [B,S,H,D]), causal, window "
                      f"{window}")


def _k3_chunk_inputs(gen, t, dtype=torch.bfloat16):
    """K3 at the lanes layout's chunked prefill: the 512 queries of one
    chunk against the ``t`` keys of the cache unrolled before it plus the
    chunk (``layers.chunk_attention``): h2o-danube-3-4b's 32 / 8 heads of
    120, ``[B, S, H, D]`` tensors seen transposed."""
    c = get_config(LANES["arch"])
    return _k3_inputs(gen, dtype, 1, c.n_heads, c.n_kv_heads, LANES_CHUNK, t,
                      c.resolved_head_dim)


# key streams of a chunk: the last chunk of the 2048-token prompt (1536
# cached keys + 512) and a chunk past the window (4096 + 512)
K3_CHUNK_T = (2048, 4608)


def check_k3_chunk(gen):
    """K3 with S = 512 queries at the end of T keys: fp32 within TOL_F32 of
    the plain version; bf16 by ``held_bf16``, block by block of 64 query
    rows, against the plain version run in fp32."""
    window = get_config(LANES["arch"]).sliding_window
    out = []
    for t in K3_CHUNK_T:
        args = _k3_chunk_inputs(gen, t)
        args32 = tuple(x.float() for x in args)
        ref32 = flash_attention_ref(*args32, True, window)
        got32 = flash_attention(*args32, True, window)
        torch.testing.assert_close(
            got32, ref32, **TOL_F32,
            msg=lambda m: f"flash_attention fp32, chunk S=512 T={t}: {m}")
        got = flash_attention(*args, True, window)
        plain = flash_attention_ref(*args, True, window)
        torch.cuda.synchronize()
        h = held_bf16("flash_attention", f"chunk S=512 T={t}", got, plain,
                      ref32, K3_TILE)
        out.append(dict(t=t, err_f32=float((got32 - ref32).abs().max()),
                        err_bf16_vs_f32_ref=h["err"],
                        plain_err_bf16_vs_f32_ref=h["err_plain"],
                        worst_block_share=h["worst_block_share"]))
    return out


def time_k3_chunk(gen):
    """K3 on a chunk past the window (S = 512, T = 4608): the kernels line's
    ``chunk_shape`` of K3."""
    window = get_config(LANES["arch"]).sliding_window
    q, k, v = _k3_chunk_inputs(gen, K3_CHUNK_T[-1])
    b, hq, s, d = q.shape
    t = k.shape[2]
    qa = torch.arange(s, device=DEV)[:, None] + (t - s)
    kpos = torch.arange(t, device=DEV)[None]
    mask = (kpos <= qa) & (kpos > qa - window)
    t_ = timings("flash_attention chunk",
                 lambda: flash_attention(q, k, v, True, window),
                 lambda: flash_attention_ref(q, k, v, True, window),
                 # yardstick only: SDPA's own causal rule aligns the queries
                 # to the start of the keys, so the same function takes the
                 # explicit mask
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask, enable_gqa=True))
    pairs = live_pairs(s, t, True, window)
    bound, by = COST.bound_ms(*COST.k3_cost(
        q.shape, k.shape, q.element_size(), True, window), q.dtype)
    return dict(**t_, bound_ms=bound, bound_by=by,
                live_pairs_per_head=pairs,
                shape=f"q[{b},{hq},{s},{d}] k/v[{b},{k.shape[1]},{t},{d}] "
                      f"bf16 (strided views of [B,S,H,D]), causal, window "
                      f"{window}")


# ---------------------------------------------------------------------------
# K4 flash_decode
# ---------------------------------------------------------------------------


def _k4_inputs(gen, dtype, b, hq, hkv, t, d, special=False):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    q, k, v = rn(b, hq, d), rn(b, t, hkv, d), rn(b, t, hkv, d)
    mask = torch.rand((b, t), generator=gen, device=DEV) > 0.35
    if special:
        mask[0] = False             # no live key: the uniform mean
        if b > 1:
            mask[1] = False
            mask[1, t // 2] = True  # one live key
    return q, k, v, mask


# b, hq, hkv, t, d: GQA groups 1, 2, 4, 8 and 32 (two blocks of 16 rows),
# head_dim 16-128, T from 1 to 4096; each run plain and ``special`` (slot 0
# with no live key, slot 1 with one: with several splits, splits with no
# live key). With the split plan on 132 SMs: n_split 1 (T = 1, T = 37), 8
# (T = 1000 and 4096 with one or two (slot, head)), 2-6 elsewhere; T not a
# multiple of the 128-key tile (bf16) or the 64-key tile (fp32): 37, 129,
# 300, 700, 1000, 1500
K4_CASES = [(3, 4, 4, 1, 64), (2, 8, 2, 37, 120), (2, 4, 1, 1000, 128),
            (4, 32, 32, 700, 64), (8, 32, 8, 4096, 120), (2, 8, 8, 300, 16),
            (3, 6, 3, 129, 32), (1, 4, 1, 4096, 120), (1, 8, 1, 1500, 64),
            (2, 16, 2, 700, 120), (2, 32, 1, 300, 64)]


def check_k4(gen):
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases, share = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shp in K4_CASES:
            for special in (False, True):
                args = _k4_inputs(gen, dtype, *shp, special=special)
                cases += 1
                if dtype == torch.bfloat16:
                    e, sh = check_bf16("flash_decode", (shp, special),
                                       flash_decode, flash_decode_ref, args,
                                       K4_ROWS)
                    errs[dtype], share = max(errs[dtype], e), max(share, sh)
                    continue
                got = flash_decode(*args)
                want = flash_decode_ref(*args)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, **TOL_F32,
                    msg=lambda m: f"flash_decode fp32 {shp} "
                                  f"special={special}: {m}")
                errs[dtype] = max(errs[dtype], float(
                    (got - want).abs().max()))
    return errs, cases, share


def _k4_slice_inputs(gen, all_live):
    """The lanes cache at the slice's shape: 8 slots x 4096 slots of 8 KV
    heads; every key live (every slot past the window), or slot i live up to
    a position drawn from 600-4095 as early in a request."""
    c = get_config(LANES["arch"])
    b, t = LANES["n_slots"], c.sliding_window
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, c.n_heads, c.n_kv_heads,
                            t, c.resolved_head_dim)
    if all_live:
        mask = torch.ones((b, t), dtype=torch.bool, device=DEV)
    else:
        pos = torch.randint(600, t, (b, 1), generator=gen, device=DEV)
        mask = torch.arange(t, device=DEV)[None] <= pos
    return q, k, v, mask


def _check_k4_at(what, args):
    """K4 at a real shape: fp32 within TOL_F32 of the plain version, bf16 by
    ``held_bf16`` against the plain version run in fp32."""
    args32 = _as_f32(args)
    ref32 = flash_decode_ref(*args32)
    got32 = flash_decode(*args32)
    torch.testing.assert_close(
        got32, ref32, **TOL_F32,
        msg=lambda m: f"flash_decode fp32, {what}: {m}")
    got, plain = flash_decode(*args), flash_decode_ref(*args)
    torch.cuda.synchronize()
    h = held_bf16("flash_decode", what, got, plain, ref32, K4_ROWS)
    return dict(err_f32=float((got32 - ref32).abs().max()),
                err_bf16_vs_f32_ref=h["err"],
                plain_err_bf16_vs_f32_ref=h["err_plain"],
                worst_block_share=h["worst_block_share"],
                out_rms=float(ref32.square().mean().sqrt()))


def check_k4_slice(gen, all_live):
    return dict(all_live=all_live, **_check_k4_at(
        "slice shape", _k4_slice_inputs(gen, all_live)))


def _k4_draft_inputs(gen):
    """K4 at the self-draft's decode step (``engine_spec``): ``q[8, 32,
    64]`` over the draft's dense lanes ``k/v[8, 2048, 32, 64]`` bf16
    (max_seq 2048; MHA, so a GQA group of 1 query row); slot i live up to
    its position, a prompt of 128 / 256 / 384 / 512 tokens plus up to 63
    generated and k drafted rows."""
    cfg = get_config(SLICE["arch"])
    b, t = SLICE["n_slots"], SLICE["max_seq"]
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, cfg.n_heads,
                            cfg.n_kv_heads, t, cfg.resolved_head_dim)
    pos = torch.tensor(PROMPT_LENS * 2, device=DEV) + torch.randint(
        0, NEW_TOKENS + SPEC_K, (b,), generator=gen, device=DEV)
    return q, k, v, torch.arange(t, device=DEV)[None] <= pos[:, None]


def check_k4_draft(gen):
    return _check_k4_at("draft shape", _k4_draft_inputs(gen))


def _k4_timed(name, args):
    """Device times of K4, its plain version and SDPA with a ``[B,1,1,T]``
    mask on these operands, its bound (the live keys' bytes) and shape."""
    q, k, v, mask = args
    b, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]

    def library():
        # yardstick only: one fused PyTorch attention call over the lanes
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True)
    t_ = timings(name, lambda: flash_decode(q, k, v, mask),
                 lambda: flash_decode_ref(q, k, v, mask), library)
    n_live = int(mask.sum())      # the work depends on the data: live keys
    bound, by = COST.bound_ms(*COST.k4_cost(
        q.shape, hkv, n_live, mask.numel(), q.element_size()), q.dtype)
    return dict(**t_, bound_ms=bound, bound_by=by,
                live_keys=n_live,
                shape=f"q[{b},{hq},{d}] k/v[{b},{t},{hkv},{d}] bf16, "
                      f"{n_live} live keys")


def time_k4(gen):
    t = _k4_timed("flash_decode", _k4_slice_inputs(gen, all_live=True))
    # the self-draft's step, from a generator of its own
    t["draft_shape"] = _k4_timed("flash_decode draft",
                                 _k4_draft_inputs(timed_gen(111)))
    return t


# ---------------------------------------------------------------------------
# K5 cms_update, K6 cms_query
# ---------------------------------------------------------------------------


def _cms_ids(gen, n, dtype=torch.int32):
    """n ids over the whole int32 range, negatives included."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                         device=DEV, dtype=torch.int64).to(dtype)


def _cms_case(counts, ids, mask, what):
    """K5 and K6 against their plain versions on the same inputs: exact."""
    want = cms_update_ref(counts, ids, mask)
    got = cms_update(counts.clone(), ids, mask)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"cms_update mismatch: {what}")
    est, est_want = cms_query(got, ids), cms_query_ref(want, ids)
    torch.cuda.synchronize()
    if est.dtype != torch.int32 or not torch.equal(est, est_want):
        raise AssertionError(f"cms_query mismatch: {what}")
    return 1


def check_cms(gen):
    """Depth 1-4, k in {0, 4, 6, 10, 12, 16}, n in {0, 1, 255, 256, 1000,
    4096, 2^20}, each masked and not; ids over the whole int32 range, int32
    and int64 alternating, both at one engine batch (4096); zero and non-zero
    starting counts. Then the write engines' own ids (int64, Zipf(0.5) over
    their regions, many duplicates) at their sketches and batches, 256 equal
    ids, distinct ids that share a bucket, and negative ids."""
    cases = 0
    for depth in (1, 2, 3, 4):
        for ki, k in enumerate((0, 4, 6, 10, 12, 16)):
            for ni, n in enumerate((0, 1, 255, 256, 1000, 4096, 1 << 20)):
                dts = ((torch.int32, torch.int64) if n == 4096 else
                       (torch.int64 if (ki + ni) % 2 else torch.int32,))
                start = (torch.randint(0, 5, (depth, 1 << k), generator=gen,
                                       device=DEV, dtype=torch.int32)
                         if (depth + ki) % 2 else
                         torch.zeros((depth, 1 << k), dtype=torch.int32,
                                     device=DEV))
                mask = torch.rand((n,), generator=gen, device=DEV) > 0.3
                for dt in dts:
                    ids = _cms_ids(gen, n, dt)
                    for m in (None, mask):
                        cases += _cms_case(start, ids, m,
                                           f"depth={depth} k={k} n={n} {dt} "
                                           f"masked={m is not None}")
    for shape in (WRITE, WRITE_PARITY):
        depth, k = shape["cms"]
        start = torch.randint(0, 5, (depth, 1 << k), generator=gen,
                              device=DEV, dtype=torch.int32)
        ids = zipf_regions(shape["batch"], 1 << shape["log2_regions"], 0.5,
                           generator=gen, device=DEV)
        mask = torch.rand(ids.shape, generator=gen, device=DEV) > 0.3
        for m in (None, mask):
            cases += _cms_case(start, ids, m,
                               f"Zipf(0.5) ids, depth={depth} k={k} "
                               f"n={ids.numel()} masked={m is not None}")
    same = torch.full((256,), 12345, dtype=torch.int32, device=DEV)
    zero = torch.zeros((4, 1 << 10), dtype=torch.int32, device=DEV)
    cases += _cms_case(zero, same, None, "256 equal ids")
    if int(cms_query(cms_update(zero.clone(), same), same[:1])[0]) != 256:
        raise AssertionError("cms: 256 equal ids do not count 256")
    h = cms_hash(torch.arange(2048), 0, 4)
    bucket = torch.nonzero(h == h[0]).flatten()[:8].to(DEV)
    one = torch.zeros((1, 16), dtype=torch.int32, device=DEV)
    cases += _cms_case(one, bucket, None, "8 ids in one bucket")
    if int(cms_update(one.clone(), bucket)[0, int(h[0])]) != 8:
        raise AssertionError("cms: 8 ids in one bucket do not stack")
    neg = torch.tensor([-5, -1, -2 ** 31, 7, -5], device=DEV)
    for dt in (torch.int32, torch.int64):
        cases += _cms_case(zero, neg.to(dt), None, f"negative ids {dt}")
    return cases


def _fused_case(counts, total, ids, mask, decay, what):
    """The fused step against its plain version on the same inputs: counts,
    total and estimates exact; the total a fresh tensor."""
    want_c, want_t, want_e = cms_update_query_ref(counts, total, ids, mask,
                                                  decay)
    got_c, got_t, got_e = cms_update_query(counts.clone(), total, ids, mask,
                                           decay)
    torch.cuda.synchronize()
    if not torch.equal(got_c, want_c):
        raise AssertionError(f"cms_update_query counts mismatch: {what}")
    if (got_t.dtype != torch.int64 or got_t.data_ptr() == total.data_ptr()
            or int(got_t) != int(want_t)):
        raise AssertionError(f"cms_update_query total mismatch: {what}: "
                             f"{int(got_t)} vs {int(want_t)}")
    if got_e.dtype != torch.int32 or not torch.equal(got_e, want_e):
        raise AssertionError(f"cms_update_query estimate mismatch: {what}")
    return 1


def _decay_modes(count):
    """(name, total_in, decay_every) for a batch of ``count`` unmasked ids:
    decay off; configured and firing in this batch (total_in = e - 1, e =
    count + 1, so the total crosses e); configured and not firing (e
    past every total)."""
    modes = [("off", 12345, 0), ("quiet", 12345, 1 << 40)]
    if count > 0:
        modes.append(("fires", count, count + 1))
    return modes


def check_cms_fused(gen):
    """The fused monitor step: depth 1-4, k in {0, 4, 10, 16}, n in {1,
    255, 4096, 2^16, 2^20}, int32 and int64 ids alternating (both at
    4096), ids over the whole int32 range, each masked and not, each with
    the decay off, firing in this batch and configured but quiet, starting
    counts up to 1000 (so the halving shows); then the write engines' Zipf
    ids at their sketches, 256 equal ids, 8 ids in one bucket of a row and
    negative ids, with the decay firing. Returns (cases, cases in which the
    decay fired)."""
    cases = fired = 0
    for depth in (1, 2, 3, 4):
        for ki, k in enumerate((0, 4, 10, 16)):
            for ni, n in enumerate((1, 255, 4096, 1 << 16, 1 << 20)):
                dts = ((torch.int32, torch.int64) if n == 4096 else
                       (torch.int64 if (ki + ni + depth) % 2 else
                        torch.int32,))
                start = torch.randint(0, 1000, (depth, 1 << k), generator=gen,
                                      device=DEV, dtype=torch.int32)
                mask = torch.rand((n,), generator=gen, device=DEV) > 0.3
                for dt in dts:
                    ids = _cms_ids(gen, n, dt)
                    for m in (None, mask):
                        count = n if m is None else int(m.sum())
                        for mode, t_in, e in _decay_modes(count):
                            total = torch.tensor(t_in, dtype=torch.int64,
                                                 device=DEV)
                            cases += _fused_case(
                                start, total, ids, m, e,
                                f"depth={depth} k={k} n={n} {dt} "
                                f"masked={m is not None} decay={mode}")
                            fired += mode == "fires"
    for shape in (WRITE, WRITE_PARITY):
        depth, k = shape["cms"]
        start = torch.randint(0, 1000, (depth, 1 << k), generator=gen,
                              device=DEV, dtype=torch.int32)
        ids = zipf_regions(shape["batch"], 1 << shape["log2_regions"], 0.5,
                           generator=gen, device=DEV)
        mask = torch.rand(ids.shape, generator=gen, device=DEV) > 0.3
        for m in (None, mask):
            count = ids.numel() if m is None else int(m.sum())
            for mode, t_in, e in _decay_modes(count) + [
                    ("engine", 0, shape["decay_every"])]:
                total = torch.tensor(t_in, dtype=torch.int64, device=DEV)
                cases += _fused_case(start, total, ids, m, e,
                                     f"Zipf(0.5) ids, depth={depth} k={k} "
                                     f"masked={m is not None} decay={mode}")
                fired += mode == "fires"
    h = cms_hash(torch.arange(2048), 0, 4)
    bucket = torch.nonzero(h == h[0]).flatten()[:8].to(DEV)
    one_bucket = [
        ("256 equal ids", torch.full((256,), 12345, dtype=torch.int32,
                                     device=DEV), 4, 10),
        ("8 ids in one bucket of row 0", bucket, 1, 4),
        ("negative ids", torch.tensor([-5, -1, -2 ** 31, 7, -5], device=DEV),
         4, 10)]
    for what, ids, depth, k in one_bucket:
        start = torch.randint(0, 1000, (depth, 1 << k), generator=gen,
                              device=DEV, dtype=torch.int32)
        for dt in (torch.int32, torch.int64):
            for mode, t_in, e in _decay_modes(ids.numel()):
                total = torch.tensor(t_in, dtype=torch.int64, device=DEV)
                cases += _fused_case(start, total, ids.to(dt), None, e,
                                     f"{what} {dt} decay={mode}")
                fired += mode == "fires"
    same = torch.full((256,), 12345, dtype=torch.int32, device=DEV)
    zero = torch.zeros((4, 1 << 10), dtype=torch.int32, device=DEV)
    _, _, est = cms_update_query(zero, torch.zeros((), dtype=torch.int64,
                                                   device=DEV), same)
    if int(est.min()) != 256 or int(est.max()) != 256:
        raise AssertionError("cms_update_query: 256 equal ids do not "
                             "count 256")
    return cases, fired


def _cms_flat(counts, ids):
    """Flat bucket index of every (row, id), for the library calls."""
    depth, width = counts.shape
    k = width.bit_length() - 1
    return torch.cat([r * width + cms_hash(ids, r, k) for r in range(depth)])


def _sector_bytes(flat):
    """Bytes of the distinct 32-byte sectors (8 int32 counters) that the flat
    bucket indices touch: what the counters must move from or to HBM."""
    return torch.unique(flat // 8).numel() * 32


def time_cms(gen):
    """K5 and K6 at the four sizes of ``CMS_TIMED``, int64 ids as the engine
    passes them, no mask (the engine's calls), uniform ids over 2^20
    regions. The library calls take precomputed bucket indices: the hash is
    excluded from them. The bounds count the ids once, the estimates once
    (K6) and, once each way, the counter sectors this run's ids touch."""
    rows = {"cms_update": [], "cms_query": []}
    for depth, k, n in CMS_TIMED:
        counts = torch.zeros((depth, 1 << k), dtype=torch.int32, device=DEV)
        ids = torch.randint(0, 1 << 20, (n,), generator=gen, device=DEV)
        flat = _cms_flat(counts, ids)
        ones = torch.ones_like(flat, dtype=torch.int32)
        cview = counts.view(-1)
        ctr = _sector_bytes(flat)
        shape = (f"counts[{depth},{1 << k}] int32, ids[{n}] int64, "
                 f"{ctr // 32} counter sectors touched")
        up = timings(f"cms_update {shape}", lambda: cms_update(counts, ids),
                     lambda: cms_update_ref(counts, ids, inplace=True),
                     lambda: cview.index_add_(0, flat, ones))
        up_bytes = n * ids.element_size() + 2 * ctr
        rows["cms_update"].append(dict(
            **up, bound_ms=up_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            shape=shape))
        q = timings(f"cms_query {shape}", lambda: cms_query(counts, ids),
                    lambda: cms_query_ref(counts, ids),
                    lambda: cview.take(flat).view(depth, n).amin(0))
        q_bytes = n * ids.element_size() + n * 4 + ctr
        rows["cms_query"].append(dict(
            **q, bound_ms=q_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            shape=shape))
    return rows


def _library_step(cview, flat, ones, total, n, depth, decay):
    """PyTorch calls for the fused step on precomputed buckets: one
    ``index_add_`` over the depth x n buckets, the total, the decay's ops
    where it is configured, ``take`` and ``amin``."""
    cview.index_add_(0, flat, ones)
    after = total + n
    if decay:
        do_decay = (after % decay) < (total % decay)
        cview.div_(1 + do_decay.to(torch.int32), rounding_mode="floor")
    return cview.take(flat).view(depth, n).amin(0)


def _step_bytes(n, ids, ctr, table_bytes, fires):
    """What the monitor step must move: the ids once, the estimates once,
    the two totals, and the touched counter sectors once each way, or the
    whole table each way when it halves."""
    return (n * ids.element_size() + n * 4 + 16
            + 2 * (table_bytes if fires else ctr))


# the monitor step's decay modes at the engine's batch of 4096 ids: off;
# configured as the engine configures it and quiet (the total starts at 0
# on every call, so 4096 writes cross no multiple of 65536); firing on
# every call (8191 + 4096 crosses 8192)
STEP_MODES = (("off", 0, 0), ("quiet", 0, 65536), ("fires", 8191, 8192))


def time_cms_fused(gen):
    """The fused step at ``CMS_TIMED``'s sizes (int64 ids, no mask, decay
    off), against its plain version and the library calls; then, at the
    engine's sketch and batch, on the same inputs in turns (unfused,
    fused, fused, unfused), the monitor's unfused step
    (``CMSMonitor.update`` then ``.query``: K5, the total's add, the
    decay's elementwise ops, K6) and the fused step in the three
    ``STEP_MODES``, and K5 then K6 alone."""
    rows = []
    for depth, k, n in CMS_TIMED:
        counts = torch.zeros((depth, 1 << k), dtype=torch.int32, device=DEV)
        total = torch.zeros((), dtype=torch.int64, device=DEV)
        ids = torch.randint(0, 1 << 20, (n,), generator=gen, device=DEV)
        flat = _cms_flat(counts, ids)
        ones = torch.ones_like(flat, dtype=torch.int32)
        cview = counts.view(-1)
        ctr = _sector_bytes(flat)
        shape = (f"counts[{depth},{1 << k}] int32, ids[{n}] int64, "
                 f"{ctr // 32} counter sectors touched, decay off")
        t = timings(f"cms_update_query {shape}",
                    lambda: cms_update_query(counts, total, ids),
                    lambda: cms_update_query_ref(counts, total, ids,
                                                 inplace=True),
                    lambda: _library_step(cview, flat, ones, total, n, depth,
                                          0))
        rows.append(dict(
            **t, bound_ms=_step_bytes(n, ids, ctr, 0, False)
            / HBM_BYTES_PER_S * 1e3, bound_by="bytes", shape=shape))
    depth, k, n = 4, 16, 4096
    counts = torch.zeros((depth, 1 << k), dtype=torch.int32, device=DEV)
    ids = torch.randint(0, 1 << 20, (n,), generator=gen, device=DEV)
    flat = _cms_flat(counts, ids)
    ones = torch.ones_like(flat, dtype=torch.int32)
    ctr, table = _sector_bytes(flat), counts.numel() * 4
    step = dict(shape=f"counts[{depth},{1 << k}] int32, ids[{n}] int64, "
                      f"no mask, {ctr // 32} counter sectors touched",
                k5_then_k6_ms=device_ms(lambda: (cms_update(counts, ids),
                                                 cms_query(counts, ids)),
                                        "cms K5 then K6"))
    for mode, t_in, decay in STEP_MODES:
        total = torch.tensor(t_in, dtype=torch.int64, device=DEV)
        mon = CMSMonitor(depth=depth, log2_width=k, decay_every=decay)
        state = MonitorState(counts, total)
        fires = mode == "fires"
        if fires:
            # the mode's inputs do cross a multiple of decay_every
            before = counts.clone()
            cms_update_query(counts, total, ids, None, decay)
            want = cms_update_ref(before, ids).div_(2, rounding_mode="floor")
            if not torch.equal(counts, want):
                raise AssertionError("cms step timing: the decay did not "
                                     "fire")

        def unfused():
            return mon.query(mon.update(state, ids), ids)

        def fused():
            return cms_update_query(counts, total, ids, None, decay)

        turns = [device_ms(fn, f"cms step {mode} {who}")
                 for who, fn in (("unfused", unfused), ("fused", fused),
                                 ("fused", fused), ("unfused", unfused))]
        step[mode] = dict(
            unfused_ms=[turns[0], turns[3]], fused_ms=[turns[1], turns[2]],
            unfused_event_ms=time_ms(unfused), fused_event_ms=time_ms(fused),
            library_ms=device_ms(
                lambda: _library_step(counts.view(-1), flat, ones, total, n,
                                      depth, decay), f"cms step {mode} lib"),
            bound_ms=_step_bytes(n, ids, ctr, table, fires)
            / HBM_BYTES_PER_S * 1e3)
    return rows, step


# ---------------------------------------------------------------------------
# lru_scan: the simulator's two-cache LRU scan (no TPU kernel: a lax.scan)
# ---------------------------------------------------------------------------


def _paper_regions(n_regions, seed=0, n=PAPER_WORKLOAD.sim_writes):
    """The paper workload's regions on the card (200 000 writes unless
    ``n`` says otherwise), from ``sweep_point``'s uniforms (the JAX
    package's bits for the same seed)."""
    return zipf_regions(n, n_regions, PAPER_WORKLOAD.zipf_skew,
                        u=prng.uniform(prng.key(seed, DEV), n))


def _lru_masks(regions, n_regions):
    """The three routings the sweep gives the scan: all offloaded (MTT),
    all unloaded (TLB), and the hint policy's (top-4096 offloaded)."""
    n = regions.shape[0]
    hot = torch.zeros((n_regions,), dtype=torch.bool, device=DEV)
    hot[:min(PAPER_WORKLOAD.adaptive_top_k, n_regions)] = True
    return {"offload": torch.zeros((n,), dtype=torch.bool, device=DEV),
            "unload": torch.ones((n,), dtype=torch.bool, device=DEV),
            "hint": ~hot[regions]}


def _last_word_regions(n):
    """2^20 paper regions for ``n`` writes (a multiple of the bucketing's
    2048-write tile, so the chain's bit map has no word past the writes),
    moved off the last MTT and TLB sets (``r % 256 == 255``) but for the
    last 10 writes, all at region 511: when every write goes to one cache,
    the last bucket is those 10 and its last group of steps starts at bit
    22 of the map's last word."""
    regions = _paper_regions(1 << 20, n=n)
    regions = torch.where(regions % 256 == 255, regions - 1, regions)
    regions[-10:] = 511
    return regions


def check_lru_scan():
    """The kernel's hit flags ``torch.equal`` to the plain version's (run on
    the CPU) at the paper workload (200 000 writes) at 1, 2^12 and 2^20
    regions, under each of the three routings; at 2^20 regions at the
    paper's own 5 000 000 writes (the ``fig3`` headline's regions), all
    offloaded and all unloaded; and at 98 x 2048 writes whose last bucket
    ends the bit map (``_last_word_regions``), under each routing. In every
    case the bucketing that the same call ran (``lru_scan_buckets``: what
    the scan's first three launches wrote) gives ``lru_buckets_ref``'s
    order and offsets, ``torch.equal``."""
    cases = []
    runs = [(r, PAPER_WORKLOAD.sim_writes, ("offload", "unload", "hint"),
             _paper_regions) for r in (1, 1 << 12, 1 << 20)]
    runs.append((1 << 20, PAPER_WORKLOAD.n_writes, ("offload", "unload"),
                 _paper_regions))
    runs.append((1 << 20, 98 * 2048, ("offload", "unload", "hint"),
                 lambda r, n: _last_word_regions(n)))
    for r, n, names, make in runs:
        regions = make(r, n=n)
        masks = _lru_masks(regions, r)
        for name in names:
            unload = masks[name]
            got, inv, offsets = lru_scan_buckets(regions, unload)
            torch.cuda.synchronize()
            cpu = (regions.cpu(), unload.cpu())
            want = lru_scan_ref(*cpu)
            if not torch.equal(got.cpu(), want):
                raise AssertionError(
                    f"lru_scan mismatch at {r} regions, {n} writes, {name}: "
                    f"{int((got.cpu() != want).sum())} flags differ")
            want_order, want_offsets = lru_buckets_ref(*cpu)
            order = torch.full_like(want_order, -1)
            order[inv.cpu()] = torch.arange(n)
            if not (torch.equal(order, want_order)
                    and torch.equal(offsets.cpu(), want_offsets)):
                raise AssertionError(
                    f"lru_scan's buckets mismatch at {r} regions, {n} "
                    f"writes, {name}: {int((order != want_order).sum())} "
                    f"places, {int((offsets.cpu() != want_offsets).sum())} "
                    f"offsets differ")
            cases.append(dict(regions=r, writes=n, mask=name,
                              hits=int(want.sum()), buckets_equal=True,
                              longest_chain=longest_chain(*cpu)))
    return cases


# (MTT, TLB) geometries beside the paper's 8 / 8 ways, so that the chain's
# other paths run on the card: a list of 16 and of 32 with a hit mask below
# the way count, and exactly 32 ways
LRU_WAYS = (((509, 3), (250, 9)), ((300, 1), (200, 20)), ((64, 32), (32, 32)))


def check_lru_ways():
    """``lru_scan`` ``torch.equal`` to its plain version at ``LRU_WAYS``, on
    the paper workload's 200 000 writes at 2^12 regions, the odd regions
    unloaded (so both caches run)."""
    regions = _paper_regions(1 << 12)
    unload = (regions & 1).bool()
    cpu = (regions.cpu(), unload.cpu())
    cases = []
    for mtt, tlb in LRU_WAYS:
        got = lru_scan(regions, unload, mtt, tlb)
        want = lru_scan_ref(*cpu, mtt, tlb)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(
                f"lru_scan mismatch at MTT {mtt}, TLB {tlb}: "
                f"{int((got.cpu() != want).sum())} flags differ")
        cases.append(dict(mtt=list(mtt), tlb=list(tlb), hits=int(want.sum())))
    return cases


def _probe_ns(launch, what, steps):
    """Device ns a step of a probe kernel that runs ``steps`` steps."""
    def probe():
        err = launch()
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")
    return device_ms(probe, what, reps=5) / steps * 1e6


def lru_step_probe_ns(steps, miss):
    """Device ns of one step of the first design's loop-carried chain, run
    alone by one warp for ``steps`` steps (``lru_step_probe_launch``: one
    warp a set, the ways on lanes): every step a hit, or every step a miss
    (8 ways)."""
    out = torch.empty((32,), dtype=torch.int64, device=DEV)
    return _probe_ns(lambda: kbuild.load_library().lru_step_probe_launch(
        steps, 8, int(miss), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream),
        f"lru_step_probe miss={miss}", steps)


def lru_chain_probe_ns(steps, miss):
    """Device ns of one step of the kernel's chain (``lru_step``), run alone
    by one thread, registers only, for ``steps`` steps
    (``lru_chain_probe_launch``): every step a hit, or every step a miss (8
    ways)."""
    out = torch.empty((1,), dtype=torch.int64, device=DEV)
    return _probe_ns(lambda: kbuild.load_library().lru_chain_probe_launch(
        steps, int(miss), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream),
        f"lru_chain_probe miss={miss}", steps)


def _chain_ns(regions, unload, hit, hit_ns, miss_ns, mtt=(512, 8),
              tlb=(256, 8)):
    """The slowest (cache, set) chain at the probe's step times: its hits
    times a hit step plus its misses times a miss step."""
    key = bucket_keys(regions, unload, mtt, tlb)
    size = mtt[0] + tlb[0]
    n_all = torch.bincount(key, minlength=size).double()
    n_hit = torch.bincount(key, weights=hit.double(), minlength=size)
    return float((n_hit * hit_ns + (n_all - n_hit) * miss_ns).max())


# (tag, regions, writes) timed: the kernels line's row first, then 1 region
# (the longest chain), 4 and 16 (the long chains after it), and the fig3
# headline's 5 000 000 writes
LRU_TIMED = (("2e20", 1 << 20, PAPER_WORKLOAD.sim_writes),
             ("1", 1, PAPER_WORKLOAD.sim_writes),
             ("4", 4, PAPER_WORKLOAD.sim_writes),
             ("16", 16, PAPER_WORKLOAD.sim_writes),
             ("2e20_5M", 1 << 20, PAPER_WORKLOAD.n_writes))


def lru_sub_kernels(fn, what, reps=20):
    """Per call, over one profiler trace of ``reps`` calls: each of the
    scan's five kernels' launches (``kernel_launch_counts``, counted where
    each is launched), the launches the trace holds, and its device ms (the
    trace's mean a launch times the counted launches a call). ``None``
    where no trace held device time."""
    fn()
    before, runs = kernel_launch_counts(), []

    def run():                      # a trace with no device time runs again
        runs.append(reps)
        for _ in range(reps):
            fn()
    rows = trace_rows(run, what)
    counted = {k: v - before[k] for k, v in kernel_launch_counts().items()}
    if not rows:
        return None
    out = {}
    for name in LRU_KERNELS:
        mine = [(us, c) for us, c, k in rows if us > 0 and f"{name}_kernel" in k]
        traced = sum(c for _, c in mine)
        per_call = counted[name] / sum(runs)
        out[name] = dict(
            launches_per_call=per_call, traced_launches=traced,
            ms=(sum(us for us, _ in mine) / traced / 1e3 * per_call
                if traced else None))
    return out


def time_lru_scan():
    """lru_scan, every write offloaded (the MTT's 512 sets), at each of
    ``LRU_TIMED``: 2^20 regions (the kernels line's row), 1 region (all
    200 000 writes in one set: the longest chain), 4, 16, and 2^20 at
    5 000 000 writes. The bound is the larger of the bytes (8-byte region,
    1-byte flag in, 1-byte hit out per write) over the memory rate and the
    slowest set's chain: its hits and misses at a hit step and a miss step,
    each the faster of the two designs' steps timed alone
    (``lru_chain_probe_ns``, ``lru_step_probe_ns``), not at the kernel's own
    rate. At 2^20 (200 000 and 5 000 000 writes) and at 1 region the trace
    also splits the time among the five launches (``sub_kernels``);
    ``event_ms - ms`` is the gaps between them. The chain's hits are the kernel's flags, held ``torch.equal`` to
    the plain version's here at 200 000 writes and by ``check_lru_scan`` at
    5 000 000. The plain version runs on the CPU: its time is host seconds
    (not measured at 5 000 000 writes)."""
    n = PAPER_WORKLOAD.sim_writes
    warp = {m: lru_step_probe_ns(n, m) for m in (False, True)}
    chain = {m: lru_chain_probe_ns(n, m) for m in (False, True)}
    hit_ns, miss_ns = (min(warp[m], chain[m]) for m in (False, True))
    out, sub = {}, {}
    for tag, r, nw in LRU_TIMED:
        regions = _paper_regions(r, n=nw)
        unload = torch.zeros((nw,), dtype=torch.bool, device=DEV)
        fn = lambda: lru_scan(regions, unload)  # noqa: E731
        hit, plain_ms = fn(), None
        if nw == n:
            cpu = (regions.cpu(), unload.cpu())
            t0 = time.perf_counter()
            want = lru_scan_ref(*cpu)
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(hit.cpu(), want):
                raise AssertionError(f"lru_scan mismatch at {r} regions")
        t_bytes = nw * (8 + 1 + 1) / HBM_BYTES_PER_S * 1e3
        t_ops = _chain_ns(regions, unload, hit, hit_ns, miss_ns) * 1e-6
        ms = device_ms(fn, f"lru_scan {tag}")
        out[tag] = dict(ms=ms, event_ms=time_ms(fn), plain_ms=plain_ms,
                        plain_event_ms=None,
                        longest_chain=longest_chain(regions, unload),
                        bound_ms=max(t_bytes, t_ops),
                        bound_by=("bytes" if t_bytes >= t_ops
                                  else "operations"),
                        ms_over_bound=ms / max(t_bytes, t_ops))
        if tag in ("2e20", "1", "2e20_5M"):
            sub[tag] = lru_sub_kernels(fn, f"lru_scan sub-kernels {tag}")
    main = out.pop("2e20")
    return dict(**main, library_ms=None, library_event_ms=None,
                step_ns=dict(hit=hit_ns, miss=miss_ns, chain_hit=chain[False],
                             chain_miss=chain[True], warp_hit=warp[False],
                             warp_miss=warp[True], probe_steps=n),
                one_region=out["1"], four_regions=out["4"],
                sixteen_regions=out["16"], writes_5M=out["2e20_5M"],
                sub_kernels=sub,
                shape=f"{n} writes (int64 regions), Zipf(0.5) over 2^20 "
                      f"regions, all offloaded: MTT 512 x 8, TLB 256 x 8; "
                      f"plain_ms is the plain version's host time")


# ---------------------------------------------------------------------------
# K1, K3 and K4 at the MoE family's shapes (granite-moe-3b-a800m)
# ---------------------------------------------------------------------------


def _check_k3_at(what, args32, causal):
    """K3 at a real shape (fp32 operands): fp32 within TOL_F32 of the plain
    version, then the same operands in bf16 by ``held_bf16`` against the
    plain version in fp32, block by block of 64 query rows."""
    ref32 = flash_attention_ref(*args32, causal, 0)
    got32 = flash_attention(*args32, causal, 0)
    torch.testing.assert_close(
        got32, ref32, **TOL_F32,
        msg=lambda m: f"flash_attention fp32, {what}: {m}")
    err32 = float((got32 - ref32).abs().max())
    del got32
    args = tuple(a.to(torch.bfloat16) for a in args32)
    got = flash_attention(*args, causal, 0)
    plain = flash_attention_ref(*args, causal, 0)
    torch.cuda.synchronize()
    h = held_bf16("flash_attention", what, got, plain, ref32, K3_TILE)
    return dict(shape=f"q{list(args[0].shape)} k/v{list(args[1].shape)}",
                err_f32=err32, err_bf16_vs_f32_ref=h["err"],
                plain_err_bf16_vs_f32_ref=h["err_plain"],
                worst_block_share=h["worst_block_share"])


def _k3_timed(name, args, causal, note):
    """Device times of K3 (no window), its plain version and SDPA (causal
    or not as K3; GQA by index where the head counts differ) on these bf16
    operands, its bound (the live pairs' operations against the operands'
    bytes) and shape."""
    q, k, v = args
    b, hq, s, d = q.shape
    t = k.shape[2]
    t3 = timings(name, lambda: flash_attention(q, k, v, causal, 0),
                 lambda: flash_attention_ref(q, k, v, causal, 0),
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=causal,
                     enable_gqa=hq != k.shape[1]))
    bound, by = COST.bound_ms(*COST.k3_cost(
        q.shape, k.shape, q.element_size(), causal, 0), q.dtype)
    return dict(**t3, bound_ms=bound, bound_by=by,
                shape=f"q[{b},{hq},{s},{d}] k/v[{b},{k.shape[1]},{t},{d}] "
                      f"bf16, {note}")


def _moe_k1_inputs(gen, t):
    """K1 as ``dispatch_staged`` calls it for ``t`` tokens of granite: the
    routing of random router logits (top-8 of 40 experts), the staging rows
    ``x[token_sorted]`` (bf16, d_model 1536) and ``dest[E * C, D]`` zeros."""
    c = get_config(MOE["arch"])
    logits = torch.randn((t, c.n_experts), generator=gen, device=DEV)
    idx = logits.argsort(dim=-1, descending=True)[:, :c.top_k]
    cap = MOE_L.expert_capacity(c, t)
    perm, dst, ok, _ = MOE_L.staging_plan(
        idx, torch.ones_like(idx, dtype=torch.bool), cap, c.n_experts)
    x = torch.randn((t, c.d_model), generator=gen, device=DEV).to(
        torch.bfloat16)
    staging = x[perm // c.top_k]
    dest = torch.zeros((c.n_experts * cap, c.d_model), dtype=torch.bfloat16,
                       device=DEV)
    return dest, staging, dst, ok


def _moe_k3_inputs(gen, dtype, what):
    """K3 at granite's prefill (2 prompts of 512 a call) or lanes chunk
    (2 x 128 queries at the end of 512 keys): 24 / 8 heads of 64 (GQA
    group 3), ``[B, S, H, D]`` tensors seen transposed."""
    c = get_config(MOE["arch"])
    s = max(MOE_PROMPTS) if what == "prefill" else MOE_CHUNK
    return _k3_inputs(gen, dtype, 2, c.n_heads, c.n_kv_heads, s,
                      max(MOE_PROMPTS), c.resolved_head_dim)


def _moe_k4_inputs(gen):
    """K4 at granite's decode step: ``q[8, 24, 64]`` over the lanes
    ``k/v[8, 640, 8, 64]`` bf16, slot i live up to its position (a prompt of
    128-512 tokens plus up to 31 generated)."""
    c = get_config(MOE["arch"])
    b, t = MOE["n_slots"], MOE["max_seq"]
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, c.n_heads, c.n_kv_heads,
                            t, c.resolved_head_dim)
    pos = torch.tensor(MOE_PROMPTS * 2, device=DEV) + torch.randint(
        0, MOE_NEW, (b,), generator=gen, device=DEV)
    return q, k, v, torch.arange(t, device=DEV)[None] <= pos[:, None]


def check_moe_shapes(gen):
    """K1 ``torch.equal`` to its plain version at a decode step (8 tokens)
    and a prefill group (2 x 512 tokens); K3 at the prefill and chunk
    shapes and K4 at the decode shape: fp32 within TOL_F32 of the plain
    version, bf16 by ``held_bf16``."""
    out = {}
    for tag, t in (("decode", MOE["n_slots"]), ("prefill",
                                                2 * max(MOE_PROMPTS))):
        dest, staging, dst, ok = _moe_k1_inputs(gen, t)
        # the routing as staging_plan gives it (int64) and in int32
        for rows in (dst, dst.to(torch.int32)):
            want = staged_scatter_ref(dest, staging, rows, ok)
            got = staged_scatter(dest.clone(), staging, rows, ok)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"staged_scatter mismatch, MoE {tag}, "
                                     f"{rows.dtype} rows")
        out[f"staged_scatter_{tag}"] = dict(
            dest=list(dest.shape), staging=list(staging.shape),
            valid_rows=int(ok.sum()), rows=["int64", "int32"], exact=True)
    for what in ("prefill", "chunk"):
        out[f"flash_attention_{what}"] = _check_k3_at(
            f"MoE {what}", _moe_k3_inputs(gen, torch.float32, what), True)
    out["flash_decode_decode"] = _check_k4_at("MoE decode shape",
                                              _moe_k4_inputs(gen))
    return out


def time_moe_shapes():
    """K1, K3 and K4 timed at granite's shapes, each beside its bound and
    one library call: K1 at a decode step's drain (``index_copy_`` of the
    valid rows), K3 at the prefill shape (SDPA, causal), K4 at the decode
    shape (SDPA with a ``[B,1,1,T]`` mask)."""
    dest, staging, dst, ok = _moe_k1_inputs(timed_gen(121), MOE["n_slots"])
    n_valid, w = int(ok.sum()), staging.shape[1]
    nbytes = COST.k1_cost(n_valid, dst.numel(), w, staging.element_size(),
                          dst.element_size())[1]
    # timed cold (``cold_sets``): each call its own dest and staging, the
    # routing shared
    sets = [(dest.clone(), staging.clone()) for _ in range(cold_sets(nbytes))]
    rows, sel = dst[ok], [(d, s[ok]) for d, s in sets]
    kernel = rotating(sets, lambda d, s: staged_scatter(d, s, dst, ok))
    t1 = timings("staged_scatter moe", kernel,
                 rotating(sets, lambda d, s: staged_scatter_ref(
                     d, s, dst, ok, inplace=True)),
                 rotating(sel, lambda d, src: d.index_copy_(0, rows, src)))
    ops = one_device_op(kernel, "staged_scatter MoE drain, device ops",
                        "staged_scatter")
    warm = device_ms(lambda: staged_scatter(dest, staging, dst, ok),
                     "staged_scatter MoE drain, L2 warm")
    k1 = dict(**t1, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
              bound_by="bytes", device_op=ops, l2_warm_ms=warm,
              cold_sets=len(sets),
              shape=f"dest[{dest.shape[0]},{w}] staging[{staging.shape[0]},"
                    f"{w}] bf16, {n_valid} valid int64 rows, cold")
    k3 = _k3_timed("flash_attention moe",
                   _moe_k3_inputs(timed_gen(122), torch.bfloat16, "prefill"),
                   True, "causal, GQA group 3")
    k4 = _k4_timed("flash_decode moe", _moe_k4_inputs(timed_gen(123)))
    return k1, k3, k4


def _zamba_k3_inputs(gen, dtype, s, t=None):
    """K3 at zamba2-2.7b's shared block: 2 prompts of ``s`` tokens a call,
    32 heads of 80 (MHA, no window), ``[B, S, H, D]`` tensors seen
    transposed (a row of 160 bytes, columns 80-127 of the second TMA box
    past the tensor). With ``t``: a lanes chunk, the ``s`` queries at the
    end of ``t`` keys (``layers.chunk_attention``)."""
    c = get_config(HYBRID["arch"])
    return _k3_inputs(gen, dtype, 2, c.n_heads, c.n_kv_heads, s, t or s,
                      c.resolved_head_dim)


def _zamba_k4_inputs(gen, t):
    """K4 at zamba2-2.7b's decode step: ``q[8, 32, 80]`` over one
    application's lanes ``k/v[8, t, 32, 80]`` bf16, slot i live up to a
    ragged position (a prompt of 256-2048 tokens plus up to 31 generated,
    cut to the lanes)."""
    c = get_config(HYBRID["arch"])
    b = HYBRID["n_slots"]
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, c.n_heads, c.n_kv_heads,
                            t, c.resolved_head_dim)
    pos = (torch.tensor(SSM_PROMPTS * 2, device=DEV) + torch.randint(
        0, SSM_NEW, (b,), generator=gen, device=DEV)).clamp(max=t - 1)
    return q, k, v, torch.arange(t, device=DEV)[None] <= pos[:, None]


ZAMBA_K3_S = (512, 777, 2048)     # 777: ragged against the 192-row blocks
# the chunked arm's calls: a chunk of SSM_CHUNK queries at the end of the
# keys before it plus its own (the second chunk, and the last of a 2048-token
# prompt)
ZAMBA_K3_CHUNK_T = (512, 2048)
ZAMBA_K4_T = (1024, 2560)


def check_zamba_shapes(gen):
    """K3 at head_dim 80 (``q[2, 32, S, 80]``: S = T = 512, 777 and 2048,
    and the chunked arm's S = 256 queries at the end of T = 512 and 2048
    keys; causal) and K4 at head_dim 80 (``q[8, 32, 80]``, ``k/v[8, T, 32,
    80]``, T = 1024 and 2560, ragged masks): fp32 within TOL_F32 of the
    plain version, bf16 by ``held_bf16`` against the plain version in
    fp32."""
    out = {}
    cases = ([(f"s{s}", s, s) for s in ZAMBA_K3_S]
             + [(f"chunk_s{SSM_CHUNK}_t{t}", SSM_CHUNK, t)
                for t in ZAMBA_K3_CHUNK_T])
    for tag, s, t in cases:
        out[f"flash_attention_{tag}"] = _check_k3_at(
            f"zamba S={s} T={t}", _zamba_k3_inputs(gen, torch.float32, s, t),
            True)
    for t in ZAMBA_K4_T:
        out[f"flash_decode_t{t}"] = _check_k4_at(
            f"zamba decode T={t}", _zamba_k4_inputs(gen, t))
    torch.cuda.empty_cache()
    return out


def time_zamba_shapes():
    """K3 and K4 timed at zamba2's shapes beside their bounds and one library
    call: K3 at the engine's largest prefill call (2 prompts of 2048, SDPA
    causal), K4 at its decode step over lanes of 2560 (SDPA with a
    ``[B,1,1,T]`` mask)."""
    k3 = _k3_timed("flash_attention zamba",
                   _zamba_k3_inputs(timed_gen(131), torch.bfloat16,
                                    max(SSM_PROMPTS)),
                   True, "causal, MHA, head_dim "
                   f"{get_config(HYBRID['arch']).resolved_head_dim}")
    k4 = _k4_timed("flash_decode zamba",
                   _zamba_k4_inputs(timed_gen(132), HYBRID["max_seq"]))
    torch.cuda.empty_cache()
    return k3, k4


def _whisper_k3_inputs(gen, dtype, s, t):
    """K3 at whisper-medium's calls: 2 requests an admission group, 16 heads
    of 64 (MHA, no window), ``[B, S, H, D]`` tensors seen transposed. The
    encoder: ``s = t`` = 1500 frames, causal (the reference's encoder);
    the cross read: ``s`` decoder queries against the ``t`` = 1500 frames'
    K/V, non-causal."""
    c = get_config(ENCDEC["arch"])
    return _k3_inputs(gen, dtype, 2, c.n_heads, c.n_kv_heads, s, t,
                      c.resolved_head_dim)


def _whisper_k4_inputs(gen, t, all_valid):
    """K4 at whisper-medium's decode step: ``q[8, 16, 64]`` over ``k/v[8,
    t, 16, 64]`` bf16. The cross read: t = 1500 frames, every key valid;
    the self read: t = max_seq 448, slot i live up to a ragged position (a
    prompt of 4-224 tokens plus up to 31 generated)."""
    c = get_config(ENCDEC["arch"])
    b = ENCDEC["n_slots"]
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, c.n_heads, c.n_kv_heads,
                            t, c.resolved_head_dim)
    if all_valid:
        return q, k, v, torch.ones((b, t), dtype=torch.bool, device=DEV)
    pos = (torch.tensor(ENCDEC_PROMPTS * 2, device=DEV) + torch.randint(
        0, ENCDEC_NEW, (b,), generator=gen, device=DEV)).clamp(max=t - 1)
    return q, k, v, torch.arange(t, device=DEV)[None] <= pos[:, None]


# (tag, S, T, causal): the encoder, and the cross read of a 64-token chunk
# and of a ragged 37 queries (both ragged against the 1500 keys' 64-key
# tiles; never ``causal`` with S < T, which would put the queries at the
# end of the keys)
WHISPER_K3 = (("encoder", 1500, 1500, True), ("cross_s64", 64, 1500, False),
              ("cross_s37", 37, 1500, False))
WHISPER_K4 = (("cross_t1500", 1500, True), ("self_t448", 448, False))


def check_whisper_shapes(gen):
    """K3 at whisper-medium's shapes (``WHISPER_K3``) and K4 at its decode
    reads (``WHISPER_K4``): fp32 within TOL_F32 of the plain version, bf16
    by ``held_bf16`` against the plain version in fp32."""
    out = {f"flash_attention_{tag}": _check_k3_at(
        f"whisper {tag}", _whisper_k3_inputs(gen, torch.float32, s, t),
        causal) for tag, s, t, causal in WHISPER_K3}
    for tag, t, all_valid in WHISPER_K4:
        out[f"flash_decode_{tag}"] = _check_k4_at(
            f"whisper {tag}", _whisper_k4_inputs(gen, t, all_valid))
    torch.cuda.empty_cache()
    return out


def time_whisper_shapes():
    """K3 and K4 timed at every ``check_whisper_shapes`` shape beside their
    bounds and one library call (SDPA: causal for the encoder, no mask for
    the cross reads; a ``[B,1,1,T]`` mask for K4). Returns ({tag: K3
    timing}, {tag: K4 timing})."""
    k3 = {tag: _k3_timed(f"flash_attention whisper {tag}",
                         _whisper_k3_inputs(timed_gen(150 + i),
                                            torch.bfloat16, s, t), causal,
                         f"{'causal' if causal else 'non-causal'}, MHA")
          for i, (tag, s, t, causal) in enumerate(WHISPER_K3)}
    k4 = {tag: _k4_timed(f"flash_decode whisper {tag}",
                         _whisper_k4_inputs(timed_gen(155 + i), t, all_valid))
          for i, (tag, t, all_valid) in enumerate(WHISPER_K4)}
    torch.cuda.empty_cache()
    return k3, k4


def _vlm_k3_inputs(gen, dtype, s, t):
    """K3 at llama-3.2-vision-90b's calls: 2 requests an admission group, 64
    heads of 128 over 8 KV heads (GQA group 8), ``[B, S, H, D]`` tensors
    seen transposed. The prompt: ``s = t`` tokens, causal; a chunk: ``s``
    queries at the end of ``t`` keys, causal; the cross read: ``s`` text
    queries against the ``t`` = 1601 image tokens' K/V, non-causal (1601 =
    25 x 64 + 1: the last 64-key tile holds one key)."""
    c = get_config(VLM["arch"])
    return _k3_inputs(gen, dtype, 2, c.n_heads, c.n_kv_heads, s, t,
                      c.resolved_head_dim)


def _vlm_k4_inputs(gen, t, all_valid):
    """K4 at the VLM's decode step: ``q[8, 64, 128]`` (GQA group 8: 16 rows
    a KV head with padding) over ``k/v[8, t, 8, 128]`` bf16. The cross
    read: t = 1601 image tokens, every key valid; the self read: t =
    max_seq 1024, slot i live up to a ragged position (a prompt of 16-480
    tokens plus up to 31 generated)."""
    c = get_config(VLM["arch"])
    b = VLM["n_slots"]
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, c.n_heads, c.n_kv_heads,
                            t, c.resolved_head_dim)
    if all_valid:
        return q, k, v, torch.ones((b, t), dtype=torch.bool, device=DEV)
    pos = (torch.tensor(VLM_PROMPTS * 2, device=DEV) + torch.randint(
        0, VLM_NEW, (b,), generator=gen, device=DEV)).clamp(max=t - 1)
    return q, k, v, torch.arange(t, device=DEV)[None] <= pos[:, None]


# (tag, S, T, causal): the largest prompt (2 x 480 tokens a prefill call),
# a 64-token chunk at the end of it, and the cross reads of a 64-token chunk,
# a ragged 37 queries and the whole 480-token prompt against 1601 image keys
VLM_K3 = (("prompt", 480, 480, True), ("chunk", 64, 480, True),
          ("cross_s64", 64, 1601, False), ("cross_s37", 37, 1601, False),
          ("cross_s480", 480, 1601, False))
VLM_K4 = (("cross_t1601", 1601, True), ("self_t1024", 1024, False))


def check_vlm_shapes(gen):
    """K3 at the VLM's shapes (``VLM_K3``) and K4 at its decode reads
    (``VLM_K4``): fp32 within TOL_F32 of the plain version, bf16 by
    ``held_bf16`` against the plain version in fp32."""
    out = {f"flash_attention_{tag}": _check_k3_at(
        f"vlm {tag}", _vlm_k3_inputs(gen, torch.float32, s, t), causal)
        for tag, s, t, causal in VLM_K3}
    for tag, t, all_valid in VLM_K4:
        out[f"flash_decode_{tag}"] = _check_k4_at(
            f"vlm {tag}", _vlm_k4_inputs(gen, t, all_valid))
    torch.cuda.empty_cache()
    return out


def time_vlm_shapes():
    """K3 and K4 timed at every ``check_vlm_shapes`` shape beside their
    bounds and one library call (SDPA: causal for the prompt and chunk, no
    mask for the cross reads, GQA by ``enable_gqa``; a ``[B,1,1,T]`` mask
    for K4). Returns ({tag: K3 timing}, {tag: K4 timing})."""
    k3 = {tag: _k3_timed(f"flash_attention vlm {tag}",
                         _vlm_k3_inputs(timed_gen(180 + i), torch.bfloat16,
                                        s, t), causal,
                         f"{'causal' if causal else 'non-causal'}, GQA "
                         f"group 8")
          for i, (tag, s, t, causal) in enumerate(VLM_K3)}
    k4 = {tag: _k4_timed(f"flash_decode vlm {tag}",
                         _vlm_k4_inputs(timed_gen(186 + i), t, all_valid))
          for i, (tag, t, all_valid) in enumerate(VLM_K4)}
    torch.cuda.empty_cache()
    return k3, k4


def _ring_lanes_cache(gen, fill, dtype=torch.bfloat16):
    """A lanes cache with a staging ring as ``ServeEngine`` holds it on
    the slice's model (``RING_LANES``: 24 layers, 8 sequences, 1024 slots, 32
    heads of 64, a ring of 8) after ``fill`` staged steps: ring column j of
    sequence b staged for slot ``pos_b + j`` (``pos_b`` a prompt of 512 plus
    up to 100 generated), sequence 3 direct at every other column (its
    entry -1: not live)."""
    c = get_config(RING_LANES["arch"])
    l, b, s = c.n_layers, RING_LANES["batch"], RING_LANES["max_seq"]
    r, h, d = RING_LANES["ring_size"], c.n_kv_heads, c.resolved_head_dim
    cache = {n: torch.randn((l, b, s, h, d), generator=gen, device=DEV)
             .to(dtype) for n in ("k", "v")}
    cache = ST.add_ring(cache, r)
    for n in ("ring_k", "ring_v"):
        cache[n].copy_(torch.randn(cache[n].shape, generator=gen, device=DEV))
    pos = RING_LANES["prompt"] + torch.randint(0, 100, (b, 1), generator=gen,
                                               device=DEV)
    slot = pos + torch.arange(r, device=DEV)[None]
    slot[3, 1::2] = -1
    cache["ring_slot"].copy_(torch.where(
        torch.arange(r, device=DEV)[None] < fill, slot, -1))
    cache["ring_fill"] = torch.tensor(fill, device=DEV)
    return cache, pos[:, 0]


def check_ring_lanes_shapes(gen):
    """The lanes ring's drain (K1) ``torch.equal`` to its plain version at
    the slice's shape, the ring full (one sequence with entries not live)
    and half full, int64 rows; ``staged.drain_ring`` on the card equal to
    the same drain on the CPU copy; K4 over cache ∪ ring (``q[8, 32, 64]``
    over ``k/v[8, 1024 + 8, 32, 64]``, the overlay's mask): fp32 within
    TOL_F32, bf16 by ``held_bf16``."""
    out = {}
    for fill in (RING_LANES["ring_size"], RING_LANES["ring_size"] // 2):
        cache, _ = _ring_lanes_cache(gen, fill)
        planes, rows, ok = ST.drain_plan(cache)
        want = [(d.clone(), st) for d, st in planes]
        staged_scatter_planes_ref(want, rows, ok)
        staged_scatter_planes(planes, rows, ok)
        torch.cuda.synchronize()
        for (got, _), (w, _) in zip(planes, want):
            if not torch.equal(got, w):
                raise AssertionError(f"staged_scatter lanes ring drain "
                                     f"mismatch, fill {fill}")
        del want
        cpu = {n: x.cpu() for n, x in cache.items()}
        ST.drain_ring(cache)
        ST.drain_ring(cpu)
        for n in cpu:
            if not torch.equal(cache[n].cpu(), cpu[n]):
                raise AssertionError(f"staged.drain_ring card != CPU: {n}")
        out[f"staged_scatter_fill{fill}"] = dict(
            planes=[list(p[0].shape) for p in planes],
            staging=list(planes[0][1].shape), valid_rows=int(ok.sum()),
            rows="int64", exact=True, drain_ring_card_equals_cpu=True)
        del cache, cpu, planes
    out["flash_decode_cache_ring"] = _check_k4_at(
        "lanes cache ∪ ring", _ring_lanes_k4_inputs(gen))
    torch.cuda.empty_cache()
    return out


def _ring_lanes_k4_inputs(gen):
    """K4 as the ring's decode step reads: ``q[8, 32, 64]`` over the
    concatenation ``k/v[8, 1024 + 8, 32, 64]`` bf16 under the overlay's
    mask: cache slots up to the position live but for the last 8, which
    sit in the ring, and every ring column live."""
    c = get_config(RING_LANES["arch"])
    b, s, r = RING_LANES["batch"], RING_LANES["max_seq"], \
        RING_LANES["ring_size"]
    q, k, v, _ = _k4_inputs(gen, torch.bfloat16, b, c.n_heads, c.n_kv_heads,
                            s + r, c.resolved_head_dim)
    pos = RING_LANES["prompt"] + torch.randint(
        r, RING_LANES["new"], (b, 1), generator=gen, device=DEV)
    slot = torch.arange(s, device=DEV)[None]
    cache_ok = (slot <= pos) & (slot <= pos - r)
    mask = torch.cat([cache_ok, torch.ones((b, r), dtype=torch.bool,
                                           device=DEV)], dim=1)
    return q, k, v, mask


def time_ring_lanes_shapes():
    """K1 at the lanes ring's drain (the full ring: 64 entries, 63 live at
    most, K and V of 24 layers in one launch), timed cold as ``time_k1``
    does (each call the next of ``cold_sets`` sets of staging planes and
    rows, the caches shared) against its plain version and two
    ``index_copy_`` calls; K4 over cache ∪ ring against SDPA with the mask.
    Returns (K1 timing, K4 timing)."""
    gen = timed_gen(190)
    cache, _ = _ring_lanes_cache(gen, RING_LANES["ring_size"])
    planes, rows, ok = ST.drain_plan(cache)
    (l, _, w), n = planes[0][0].shape, rows.shape[0]
    n_valid = int(ok.sum())
    nbytes = COST.k1_cost(n_valid, n, w, 2, 8, planes=2 * l)[1]
    # each set its own staging planes and its slots 8 further on (the next
    # ring's worth of positions), so its destination rows differ too
    sets = [([(d, torch.randn(st.shape, generator=gen, device=DEV)
               .to(st.dtype)) for d, st in planes],
             torch.where(ok, rows + 8 * i, rows))
            for i in range(cold_sets(nbytes))]
    sel = [([(d, st[:, ok]) for d, st in ps], rr[ok]) for ps, rr in sets]

    def library(planes_, rows_):
        for dest, staging in planes_:
            dest.index_copy_(1, rows_, staging)

    kernel = rotating(sets, lambda p, rr: staged_scatter_planes(p, rr, ok))
    t = timings("staged_scatter lanes ring", kernel,
                rotating(sets, lambda p, rr: staged_scatter_planes_ref(
                    p, rr, ok)),
                rotating(sel, library))
    ops = one_device_op(kernel, "staged_scatter lanes ring drain, device ops",
                        "staged_scatter")
    k1 = dict(**t, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
              bound_by="bytes", library_of="two index_copy_ calls over the "
                                          "live rows, one a plane",
              device_op=ops, cold_sets=len(sets),
              shape=f"K and V: dest[{l},{planes[0][0].shape[1]},{w}] "
                    f"staging[{l},{n},{w}] bf16, {n_valid} valid int64 rows "
                    f"of {n}, one launch, cold")
    del cache, planes, sets, sel
    torch.cuda.empty_cache()
    k4 = _k4_timed("flash_decode lanes cache ∪ ring",
                   _ring_lanes_k4_inputs(timed_gen(191)))
    return k1, k4


# ---------------------------------------------------------------------------
# training: K3's backward, its lse, and K1's adjoint
# ---------------------------------------------------------------------------

# b, hq, hkv, s, t, d, causal, window: the training phases' microbatch for
# stablelm-1.6b (32 heads of 64) and granite-moe-3b-a800m (24 over 8),
# a window shorter than S at head_dim 120, S < T, a non-causal read at
# head_dim 80, and llama-3.2-vision-90b's geometry (head_dim 128, GQA group
# 8): causal with S no multiple of 64, and its cross read of 64 queries over
# 1601 image keys (the last key tile holds one key); then the training
# microbatches of zamba2-2.7b's shared block (32 heads of 80) and of
# whisper-medium (16 heads of 64): its causal encoder over 1500 frames and
# the decoder's cross read of 448 queries over them
K3_BWD_CASES = [(TRAIN_MB, 32, 32, TRAIN["seq"], TRAIN["seq"], 64, True, 0),
                (TRAIN_MB, 24, 8, TRAIN["seq"], TRAIN["seq"], 64, True, 0),
                (1, 8, 2, 700, 700, 120, True, 256),
                (2, 4, 1, 100, 300, 64, True, 0),
                (2, 4, 2, 64, 200, 80, False, 0),
                (1, 16, 2, 333, 333, 128, True, 0),
                (1, 16, 2, 64, 1601, 128, False, 0),
                (TRAIN_MB, 32, 32, TRAIN["seq"], TRAIN["seq"], 80, True, 0),
                (TRAIN_MB, 16, 16, 1500, 1500, 64, True, 0),
                (TRAIN_MB, 16, 16, TRAIN_ENCDEC_SEQ, 1500, 64, False, 0)]


def _k3_bwd_inputs(gen, case, dtype):
    """q, k, v (``[B, S, H, D]`` tensors seen transposed, as the model
    passes them) and a cotangent of the output's shape, likewise."""
    b, hq, hkv, s, t, d, _, _ = case
    q, k, v = _k3_inputs(gen, dtype, b, hq, hkv, s, t, d)
    do = torch.randn((b, s, hq, d), generator=gen, device=DEV).to(
        dtype).transpose(1, 2)
    return q, k, v, do


def check_k3_bwd(gen):
    """K3's backward (``flash_attention_bwd`` from K3's own ``out`` and
    ``lse``) against autograd of the plain version on the card: fp32 within
    TOL_F32 of the plain version run in float64 (the plain fp32 version's
    own error there is reported beside the kernel's), bf16 by ``held_bf16``
    (each of dq, dk, dv, block by block of 64 rows) against the plain
    version in fp32 on the upcast operands, each case's largest share of
    its block limit reported; a second bf16 call ``torch.equal`` to the
    first (no atomics: the sums run in a fixed order). K3 with ``lse``
    equal to K3 without, bit for bit; ``lse`` within 1e-4 (absolute and
    relative) of the plain version's on the same (upcast) operands."""
    out = dict(cases=[], err_f32=0.0, err_bf16_vs_plain=0.0,
               worst_block_share=0.0, lse_err=0.0, bf16_repeat_equal=True)
    for case in K3_BWD_CASES:
        causal, w = case[6], case[7]
        share = 0.0
        args32 = _k3_bwd_inputs(gen, case, torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (x.to(dtype) for x in args32)
            o, lse = flash_attention_lse(q, k, v, causal, w)
            if not torch.equal(o, flash_attention(q, k, v, causal, w)):
                raise AssertionError(f"flash_attention with lse differs from "
                                     f"without, {dtype} {case}")
            lse_ref = flash_attention_lse_ref(q.float(), k.float(), v.float(),
                                              causal, w)
            torch.testing.assert_close(
                lse, lse_ref, atol=1e-4, rtol=1e-4,
                msg=lambda m: f"flash_attention lse {dtype} {case}: {m}")
            out["lse_err"] = max(out["lse_err"],
                                 float((lse - lse_ref).abs().max()))
            got = flash_attention_bwd(q, k, v, o, lse, do, causal, w)
            plain = flash_attention_bwd_ref(q, k, v, do, causal, w)
            if dtype == torch.float32:
                # held to the plain version run in float64: its own fp32
                # backward sums up to G * S products per entry in cuBLAS's
                # order and errs by more than TOL_F32 at these shapes (by
                # 7.6e-6 at granite's, where the kernel errs by 3.7e-6)
                ref64 = flash_attention_bwd_ref(q.double(), k.double(),
                                                v.double(), do.double(),
                                                causal, w)
                for name, g, p, r in zip(("dq", "dk", "dv"), got, plain,
                                         ref64):
                    r = r.float()
                    out["err_f32"] = max(out["err_f32"],
                                         float((g - r).abs().max()))
                    out["plain_err_f32"] = max(out.get("plain_err_f32", 0.0),
                                               float((p - r).abs().max()))
                    out["err_vs_plain_f32"] = max(
                        out.get("err_vs_plain_f32", 0.0),
                        float((g - p).abs().max()))
                    torch.testing.assert_close(
                        g, r, **TOL_F32, msg=lambda m: f"flash_attention_bwd "
                        f"fp32 {name} {case} against the plain version in "
                        f"float64: {m}")
                continue
            ref32 = flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                            do.float(), causal, w)
            again = flash_attention_bwd(q, k, v, o, lse, do, causal, w)
            torch.cuda.synchronize()
            for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
                if not torch.equal(g, g2):
                    raise AssertionError(f"flash_attention_bwd bf16 {name} "
                                         f"{case}: a second call differs")
            for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref32):
                if not torch.isfinite(g.float()).all():
                    raise AssertionError(f"flash_attention_bwd {name} "
                                         f"non-finite, bf16 {case}")
                h = held_bf16("flash_attention_bwd", f"{name} {case}", g, p,
                              r, K3_TILE)
                out["err_bf16_vs_plain"] = max(out["err_bf16_vs_plain"],
                                               h["err_vs_plain"])
                share = max(share, h["worst_block_share"])
        out["worst_block_share"] = max(out["worst_block_share"], share)
        out["cases"].append(dict(case=list(case), worst_block_share=share))
    return out


# the backward's three launches in a trace, by what each computes
K3_BWD_LAUNCHES = (("delta", "attn_bwd_prep_kernel"),
                   ("dk_dv", "attn_bwd_dkdv_wgmma_kernel"),
                   ("dq", "attn_bwd_dq_wgmma_kernel"))


def k3_bwd_sub_kernels(fn, what, reps=20):
    """Per call of the bf16 backward, over one profiler trace of ``reps``
    calls: each of its three launches' device ms (the trace's mean a
    launch; each runs once a call), the launches the trace holds, and its
    share of the three's sum. ``None`` where no trace held device time."""
    fn()

    def run():
        for _ in range(reps):
            fn()
    rows = trace_rows(run, what)
    if not rows:
        return None
    out = {}
    for tag, kernel in K3_BWD_LAUNCHES:
        mine = [(us, c) for us, c, k in rows if us > 0 and kernel in k]
        traced = sum(c for _, c in mine)
        out[tag] = dict(traced_launches=traced,
                        ms=(sum(us for us, _ in mine) / traced / 1e3
                            if traced else None))
    total = sum(v["ms"] for v in out.values() if v["ms"])
    for v in out.values():
        v["share"] = v["ms"] / total if v["ms"] else None
    return out


def _k3_bwd_timed(name, case, gen):
    """Device times of K3's backward, the plain version's backward (autograd
    of the plain forward, its graph kept) and SDPA's backward (the same),
    at one bf16 shape, and the backward's time split among its three
    launches (``sub_kernels``); its bound: ``10 * D * Hq * B * live pairs``
    FLOP against one read of q, k, v, out, dout and lse and one write of
    dq, dk, dv."""
    b, hq, hkv, s, t, d, causal, w = case
    q, k, v, do = _k3_bwd_inputs(gen, case, torch.bfloat16)
    o, lse = flash_attention_lse(q, k, v, causal, w)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    ref_out = flash_attention_ref(*leaves, causal, w)
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=hq != hkv)
    t_ = timings(name,
                 lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, w),
                 lambda: torch.autograd.grad(ref_out, leaves, do,
                                             retain_graph=True),
                 lambda: torch.autograd.grad(sdpa_out, leaves, do,
                                             retain_graph=True))
    t_["sub_kernels"] = k3_bwd_sub_kernels(
        lambda: flash_attention_bwd(q, k, v, o, lse, do, causal, w),
        f"{name} sub-kernels")
    pairs = live_pairs(s, t, causal, w)
    # q, out and dout read and dq written; k and v read, dk and dv written
    bound, by = COST.bound_ms(*COST.k3_bwd_cost(
        q.shape, k.shape, q.element_size(), causal, w), q.dtype)
    return dict(**t_, bound_ms=bound, bound_by=by,
                live_pairs_per_head=pairs,
                shape=f"q[{b},{hq},{s},{d}] k/v[{b},{hkv},{t},{d}] bf16 "
                      f"(strided views of [B,S,H,D]), causal, window {w}; "
                      f"library: SDPA's backward (graph kept), "
                      f"{'GQA' if hq != hkv else 'MHA'}")


def time_k3_bwd():
    """At train_dense's microbatch (stablelm-1.6b); granite-moe-3b-a800m's
    under ``moe_shape``, zamba2-2.7b's shared block under ``zamba_shape``,
    whisper-medium's encoder under ``whisper_shape``."""
    row = _k3_bwd_timed("flash_attention_bwd", K3_BWD_CASES[0],
                        timed_gen(180))
    for key, case, seed in (("moe_shape", 1, 181), ("zamba_shape", 7, 182),
                            ("whisper_shape", 8, 183)):
        row[key] = _k3_bwd_timed(f"flash_attention_bwd {key}",
                                 K3_BWD_CASES[case], timed_gen(seed))
    return row


def _train_k1_inputs(gen, valid_share=1.0):
    """K1 as ``dispatch_staged`` calls it under training for granite's
    microbatch (4 x 512 tokens, top-8 of 40, capacity 512), with a
    ``valid_share`` of the entries kept, and a cotangent of the expert
    buffer (bf16)."""
    dest, staging, dst, ok = _moe_k1_inputs(gen, TRAIN_MB * TRAIN["seq"])
    if valid_share < 1.0:
        ok = ok & (torch.rand(ok.shape, generator=gen, device=DEV)
                   < valid_share)
    grad = torch.randn(dest.shape, generator=gen, device=DEV).to(dest.dtype)
    return dest, staging, dst, ok, grad


def check_k1_adjoint(gen):
    """At granite's training dispatch: ``staged_drain`` (K1 into a fresh
    buffer) ``torch.equal`` to the plain drain; its adjoint
    ``staged_gather`` ``torch.equal`` to the plain gather, int64 and int32
    rows, all entries valid and about half, bf16 and fp32."""
    out = []
    for share in (1.0, 0.5):
        dest, staging, dst, ok, grad = _train_k1_inputs(gen, share)
        for dtype in (torch.bfloat16, torch.float32):
            st, g = staging.to(dtype), grad.to(dtype)
            want = staged_scatter_ref(dest.to(dtype), st, dst, ok)
            if not torch.equal(staged_drain(st, dst, ok, dest.shape[0]),
                               want):
                raise AssertionError(f"staged_drain mismatch {dtype} "
                                     f"{share}")
            for rows in (dst, dst.to(torch.int32)):
                got = staged_gather(g, rows, ok)
                torch.cuda.synchronize()
                if not torch.equal(got, staged_gather_ref(g, rows, ok)):
                    raise AssertionError(f"staged_gather mismatch {dtype} "
                                         f"{rows.dtype} {share}")
        out.append(dict(src=list(grad.shape), rows=dst.shape[0],
                        valid=int(ok.sum()), exact=True))
    return out


def time_k1_adjoint():
    """``staged_gather`` at granite's training dispatch (bf16, int64 rows
    as ``staging_plan`` gives them) beside its plain version and
    ``index_select`` of the valid rows (a yardstick: it writes no zero
    rows); bound: the valid rows read, every output row written and the
    routing read, once."""
    _, _, dst, ok, grad = _train_k1_inputs(timed_gen(182))
    n, w = dst.shape[0], grad.shape[1]
    n_valid = int(ok.sum())
    rows = dst[ok]
    t_ = timings("staged_gather", lambda: staged_gather(grad, dst, ok),
                 lambda: staged_gather_ref(grad, dst, ok),
                 lambda: grad.index_select(0, rows))
    nbytes = COST.k1_gather_cost(n_valid, n, w, grad.element_size(),
                                 dst.element_size())[1]
    ops = one_device_op(lambda: staged_gather(grad, dst, ok),
                        "staged_gather, device ops", "staged_gather")
    return dict(**t_, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", device_op=ops,
                shape=f"src[{grad.shape[0]},{w}] bf16 -> [{n},{w}], "
                      f"{n_valid} valid int64 rows, warm")


def timed_gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)


def phase_kernels():
    gen = torch.Generator(device=DEV).manual_seed(0)
    k1_err, k1_cases = check_k1(gen)
    k2_errs, k2_cases, k2_share = check_k2(gen)
    k2_slice = [check_k2_slice(gen, c) for c in (1, 8)]
    k2_engine = check_k2_engine(gen)
    k3_errs, k3_cases, k3_share = check_k3(gen)
    k3_slice = check_k3_slice(gen)
    k4_errs, k4_cases, k4_share = check_k4(gen)
    k4_slice = [check_k4_slice(gen, live) for live in (True, False)]
    cms_cases = check_cms(gen)
    fused_cases, fused_fired = check_cms_fused(gen)
    # the shapes chunked prefill gives K2 and K3 (drawn after the rest)
    k2_chunk, k3_chunk = check_k2_chunk(gen), check_k3_chunk(gen)
    # each timing draws from a generator of its own, so a check added above
    # never moves the inputs that are timed
    k1_t, (k2_t, k2_facts) = time_k1(timed_gen(101)), time_k2(timed_gen(102))
    k3_t, k4_t = time_k3(timed_gen(103)), time_k4(timed_gen(104))
    cms_t = time_cms(timed_gen(105))
    fused_t, step_t = time_cms_fused(timed_gen(106))
    k3_t["chunk_shape"] = time_k3_chunk(timed_gen(107))
    k2s_cases, k2s_errs = check_k2_sharded(timed_gen(108))
    k2s_t = time_k2_sharded(timed_gen(109))
    # the speculative path's shapes: the verify (K2 at C = k + 1) and the
    # self-draft's step (K4 at the slice's MHA geometry)
    k2_verify = check_k2_verify(timed_gen(112))
    k4_draft = check_k4_draft(timed_gen(113))
    # the simulator's scan, and K1 / K3 / K4 at the MoE family's shapes
    lru_cases = check_lru_scan()
    lru_ways = check_lru_ways()
    lru_t = time_lru_scan()
    moe_checks = check_moe_shapes(timed_gen(120))
    k1_moe, k3_moe, k4_moe = time_moe_shapes()
    k1_t["moe_shape"], k3_t["moe_shape"] = k1_moe, k3_moe
    k4_t["moe_shape"] = k4_moe
    # K3 and K4 at head_dim 80: zamba2-2.7b's shared attention block
    zamba_checks = check_zamba_shapes(timed_gen(130))
    k3_t["zamba_shape"], k4_t["zamba_shape"] = time_zamba_shapes()
    # K3 and K4 at whisper-medium's encoder, cross and decode shapes
    whisper_checks = check_whisper_shapes(timed_gen(140))
    k3_t["whisper_shape"], k4_t["whisper_shape"] = time_whisper_shapes()
    # K3 and K4 at llama-3.2-vision-90b's prompt, chunk, cross and decode
    # shapes; K1 and K4 at the lanes ring's drain and cache ∪ ring read
    vlm_checks = check_vlm_shapes(timed_gen(170))
    k3_t["vlm_shape"], k4_t["vlm_shape"] = time_vlm_shapes()
    ring_checks = check_ring_lanes_shapes(timed_gen(175))
    k1_t["lanes_ring_shape"], k4_t["lanes_ring_shape"] = \
        time_ring_lanes_shapes()
    # training: K3's backward (and K3 with lse) at the training phases'
    # shapes, K1's drain into a fresh buffer and its adjoint
    k3_bwd_checks = check_k3_bwd(timed_gen(185))
    k1_adj_checks = check_k1_adjoint(timed_gen(186))
    k3_bwd_t, k1_adj_t = time_k3_bwd(), time_k1_adjoint()
    say("cms_monitor_step", **step_t)
    say("kernel_checks", staged_scatter_cases=k1_cases,
        staged_scatter_exact=True, flash_decode_paged_cases=k2_cases,
        flash_decode_paged_max_abs_err_f32=k2_errs[torch.float32],
        flash_decode_paged_max_abs_err_bf16=k2_errs[torch.bfloat16],
        flash_decode_paged_tol_share_f32=k2_share[torch.float32],
        flash_decode_paged_tol_share_bf16=k2_share[torch.bfloat16],
        flash_attention_cases=k3_cases,
        bf16_rule_k2_k3_k4="error vs the fp32 plain version <= "
                        "slice_err_factor x the plain bf16 version's, over "
                        "the tensor and in each block (+ half a bf16 ulp of "
                        "the block's largest value there)",
        bf16_blocks=dict(flash_attention=f"{K3_TILE} query rows of a head",
                         flash_decode=f"{K4_ROWS} row",
                         flash_decode_paged=f"{K2_ROWS} row (slice and "
                                            f"engine shapes)"),
        flash_attention_max_abs_err_f32=k3_errs[torch.float32],
        flash_attention_max_abs_err_bf16=k3_errs[torch.bfloat16],
        flash_attention_bf16_worst_block_share=k3_share,
        flash_decode_cases=k4_cases,
        flash_decode_max_abs_err_f32=k4_errs[torch.float32],
        flash_decode_max_abs_err_bf16=k4_errs[torch.bfloat16],
        flash_decode_bf16_worst_block_share=k4_share,
        tol_f32=TOL_F32, tol_bf16=TOL_BF16,
        staged_scatter_ms_no_valid_rows=k1_t.pop("ms_no_valid_rows"),
        staged_scatter_shape=k1_t.pop("shape"),
        flash_decode_paged_timed=k2_facts,
        flash_decode_paged_slice=k2_slice,
        flash_decode_paged_engine_shape=k2_engine,
        flash_decode_paged_chunk_shape=k2_chunk,
        flash_decode_paged_verify_shape=k2_verify,
        flash_decode_draft_shape=k4_draft,
        flash_decode_paged_sharded_cases=k2s_cases,
        flash_decode_paged_sharded_equal_unsharded=True,
        flash_decode_paged_sharded_max_abs_err_f32=k2s_errs[torch.float32],
        flash_decode_paged_sharded_max_abs_err_bf16=k2s_errs[torch.bfloat16],
        flash_attention_chunk_shape=k3_chunk,
        flash_attention_shape=k3_t.pop("shape"),
        flash_attention_live_pairs_per_head=k3_t.pop("live_pairs_per_head"),
        flash_attention_slice=k3_slice,
        flash_decode_shape=k4_t.pop("shape"),
        flash_decode_live_keys=k4_t.pop("live_keys"),
        flash_decode_draft_timed=dict(
            shape=k4_t["draft_shape"].pop("shape"),
            live_keys=k4_t["draft_shape"].pop("live_keys")),
        flash_decode_slice=k4_slice,
        slice_err_factor=SLICE_ERR_FACTOR, cms_cases=cms_cases,
        cms_exact=True, cms_update_query_cases=fused_cases,
        cms_update_query_cases_decay_fired=fused_fired,
        cms_update_query_exact=True, lru_scan_cases=lru_cases,
        lru_scan_way_cases=lru_ways,
        lru_scan_equal=True, lru_scan_shape=lru_t.pop("shape"),
        moe_shapes=moe_checks, zamba_shapes=zamba_checks,
        whisper_shapes=whisper_checks, vlm_shapes=vlm_checks,
        lanes_ring_shapes=ring_checks, flash_attention_bwd=k3_bwd_checks,
        staged_drain_and_gather=k1_adj_checks)
    # the kernels line: the write engine's sketch (depth 4, k 16) at one
    # engine batch; all four timed sizes under "sizes"
    cms_main = CMS_TIMED.index((4, 16, 4096))
    cms_rows = []
    for name, line in (("cms_update", 51), ("cms_query", 109)):
        cms_rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/cms.cu",
            replaces=f"src/repro/kernels/cms.py:{line}", launches=None,
            max_abs_err=0.0, **cms_t[name][cms_main], sizes=cms_t[name]))
    cms_rows.append(dict(
        name="cms_update_query", route="cuda",
        source="src/repro_torch/kernels/csrc/cms.cu",
        replaces="src/repro/kernels/cms.py:51",
        also_replaces="src/repro/kernels/cms.py:109", launches=None,
        max_abs_err=0.0, **fused_t[cms_main], sizes=fused_t))
    return [
        dict(name="staged_scatter", route="cuda",
             source="src/repro_torch/kernels/csrc/staged_scatter.cu",
             replaces="src/repro/kernels/staged_scatter.py:44",
             launches=None, max_abs_err=k1_err, **k1_t),
        dict(name="flash_decode_paged", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode_paged.cu",
             replaces="src/repro/kernels/flash_decode.py:135",
             launches=None, max_abs_err=max(k2_errs.values()), **k2_t),
        dict(name="flash_decode_paged_sharded", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode_paged.cu",
             wrapper="src/repro_torch/kernels/flash_decode.py",
             replaces="src/repro/kernels/flash_decode.py:207",
             launches=None, max_abs_err=max(k2s_errs.values()), **k2s_t),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:83",
             launches=None, max_abs_err=max(k3_errs.values()), **k3_t),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:271",
             launches=None, max_abs_err=max(k4_errs.values()), **k4_t),
    ] + cms_rows + [
        dict(name="lru_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/lru_scan.cu",
             replaces="no TPU kernel: the lax.scan at "
                      "src/repro/core/simulator.py:146",
             launches=None, max_abs_err=0.0, **lru_t),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             wrapper="src/repro_torch/kernels/flash_attention.py",
             replaces="no TPU kernel: the JAX package takes this gradient "
                      "by autodiff of sdpa (src/repro/models/layers.py:194)",
             launches=None,
             max_abs_err=max(k3_bwd_checks["err_vs_plain_f32"],
                             k3_bwd_checks["err_bf16_vs_plain"]),
             **k3_bwd_t),
        dict(name="staged_gather", route="cuda",
             source="src/repro_torch/kernels/csrc/staged_scatter.cu",
             wrapper="src/repro_torch/kernels/staged_scatter.py",
             replaces="no TPU kernel: the JAX package takes this gradient "
                      "by autodiff of .at[dst].set(mode='drop') "
                      "(src/repro/models/moe.py:241)",
             launches=None, max_abs_err=0.0, **k1_adj_t)]


# ---------------------------------------------------------------------------


def _serve_timed(eng, cfg, new_tokens, runs):
    """Warm-up (one short request per prompt length, uncounted), then
    ``runs`` timed serves of the slice's requests; launch counts set to 0
    just before the first and read just after it. Greedy streams must
    repeat exactly. Returns what the engine phases report."""
    t0 = time.perf_counter()
    eng.serve(synthetic_requests(len(PROMPT_LENS), PROMPT_LENS, cfg.vocab, 2,
                                 params=SamplingParams(max_tokens=2)))
    eng.reset()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    sp = SamplingParams(max_tokens=new_tokens)

    def timed_serve():
        queue = synthetic_requests(N_REQUESTS, PROMPT_LENS, cfg.vocab,
                                   new_tokens, params=sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve(queue)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, eng.completions()

    reset_launch_counts()           # counts = 0 just before the main path
    torch.cuda.reset_peak_memory_stats()
    outputs, dt, comps = timed_serve()
    counts = launch_counts()        # read just after
    stats = dict(eng.stats)
    peak = torch.cuda.max_memory_allocated()
    n_toks = sum(len(t) for t in outputs.values())
    seconds, ttfts = [dt], [sorted(c.ttft_s for c in comps.values())]
    for _ in range(runs - 1):
        eng.reset()
        again, dt_i, comps_i = timed_serve()
        seconds.append(dt_i)
        ttfts.append(sorted(c.ttft_s for c in comps_i.values()))
        for rid, toks in outputs.items():
            assert (again[rid] == toks).all(), f"request {rid} did not repeat"
    return dict(outputs=outputs, comps=comps, counts=counts, stats=stats,
                report=dict(requests=len(outputs), tokens=n_toks,
                            seconds=seconds,
                            tok_per_s=[n_toks / x for x in seconds],
                            ttft_median_s=[x[len(x) // 2] for x in ttfts],
                            ttft_min_max_s=[[x[0], x[-1]] for x in ttfts],
                            warm_up_seconds=t_warm, attention=eng.attention,
                            stats=stats, launches=counts,
                            peak_mem_gb=peak / 1e9))


def _check_slice_streams(outputs, comps, stats, cfg):
    assert len(outputs) == N_REQUESTS
    for rid, toks in outputs.items():
        assert toks.shape == (NEW_TOKENS,), (rid, toks.shape)
        assert ((toks >= 0) & (toks < cfg.vocab)).all(), rid
        pc = comps[rid].path_counts
        assert pc["direct"] + pc["staged"] == NEW_TOKENS - 1, pc
    assert stats["admitted"] == stats["retired"] == N_REQUESTS, stats
    assert stats["staged_writes"] > 0 and stats["drains"] > 0, stats


def phase_engine(kernels):
    t0 = time.perf_counter()
    cfg, model = _slice_model(SLICE_LAYERS)
    eng = Engine.from_config(EngineConfig(**SLICE), model)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    run = _serve_timed(eng, cfg, NEW_TOKENS, ENGINE_RUNS)
    say("engine", config=SLICE, n_layers=cfg.n_layers, dtype=cfg.dtype,
        model_build_seconds=t_build, **run["report"])
    assert eng.attention == "fused", eng.attention
    _check_slice_streams(run["outputs"], run["comps"], run["stats"], cfg)
    counts = run["counts"]
    take_launches(kernels, counts, ("staged_scatter", "flash_decode_paged"))
    if counts["flash_attention"] <= 0:   # prefill runs K3 on this path too
        raise AssertionError(f"flash_attention was never launched by the "
                             f"paged engine: {counts}")
    profile = engine_profile(eng, cfg, SLICE, PROMPT_LENS)
    del eng
    torch.cuda.empty_cache()
    return dict(outputs=run["outputs"], comps=run["comps"],
                report=run["report"], profile=profile)


def phase_engine_chunked(kernels, blocking):
    """The slice with ``chunked=True, chunk_size=16``: requests are admitted
    at once and prefilled 16 tokens a step inside mixed-phase segments (K2
    at C = 16), so no whole-prompt prefill runs and K3 is never launched.
    Three timed serves; each request's stream is compared with the blocking
    engine's (reported, not held: in bf16 K2 over chunks and K3 over the
    prompt round differently)."""
    cfg, model = _slice_model(SLICE_LAYERS)
    shape = dict(SLICE, chunked=True, chunk_size=CHUNK)
    eng = Engine.from_config(EngineConfig(**shape), model)
    run = _serve_timed(eng, cfg, NEW_TOKENS, ENGINE_RUNS)
    outputs, comps, counts, stats = (run["outputs"], run["comps"],
                                     run["counts"], run["stats"])
    _check_slice_streams(outputs, comps, stats, cfg)
    n_prompt = sum(PROMPT_LENS[i % len(PROMPT_LENS)]
                   for i in range(N_REQUESTS))
    assert stats["prefill_writes"] == n_prompt, stats
    for rid, c in comps.items():
        assert c.path_counts["prefill"] == PROMPT_LENS[rid % len(PROMPT_LENS)]
    for name in ("staged_scatter", "flash_decode_paged"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched by the chunked "
                                 f"engine: {counts}")
    if counts["flash_attention"] != 0:
        raise AssertionError(f"the chunked engine ran a whole-prompt "
                             f"prefill (flash_attention launched): {counts}")
    same = [bool((outputs[r] == blocking["outputs"][r]).all())
            for r in outputs]
    for k in kernels:
        if k["name"] in ("staged_scatter", "flash_decode_paged"):
            k["launches_chunked"] = counts[k["name"]]
    profile = engine_profile(eng, cfg, shape, [128, 1792], mixed=True)
    say("engine_chunked", config=shape, n_layers=cfg.n_layers,
        dtype=cfg.dtype, **run["report"],
        streams_equal_blocking_share=sum(same) / len(same),
        blocking=dict((k, blocking["report"][k]) for k in
                      ("tok_per_s", "ttft_median_s", "ttft_min_max_s")),
        blocking_profile=blocking["profile"])
    del eng
    torch.cuda.empty_cache()


class virtual_devices:
    """``REPRO_TORCH_VIRTUAL_DEVICES=n`` around engine builds: meshes of
    ``n`` virtual devices, all the card."""

    def __init__(self, n):
        self.n, self.old = n, None

    def __enter__(self):
        self.old = os.environ.get(VIRTUAL_DEVICES_ENV)
        os.environ[VIRTUAL_DEVICES_ENV] = str(self.n)

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = self.old


def _payload(outputs, comps, stats):
    """What sharded serving must reproduce: streams, per-request path
    counts, stats."""
    return ({r: t.tolist() for r, t in outputs.items()},
            {r: c.path_counts for r, c in comps.items()}, dict(stats))


def _placement_problems(sch, tp, what):
    """Each shard of the pool and ring ``[L, ., ., H / tp, Dh]`` on its own
    mesh device; the decision plane whole on the lead."""
    out = []
    mesh, cache, mcfg = sch.mesh, sch.cache, sch.model.cfg
    h, dh, l = mcfg.n_kv_heads, mcfg.resolved_head_dim, mcfg.n_layers
    want = {"pages_k": (l, sch.n_blocks + 1, sch.cfg.page_size, h // tp, dh),
            "ring_k": (l, sch.cfg.n_slots, sch.cfg.ring_size, h // tp, dh)}
    want["pages_v"], want["ring_v"] = want["pages_k"], want["ring_k"]
    for name, shape in want.items():
        x = cache[name]
        if not isinstance(x, ShardedTensor) or len(x.shards) != tp:
            out.append(f"{what}: {name} is not split in {tp}: {x!r}")
            continue
        for i, piece in enumerate(x.shards):
            if tuple(piece.shape) != shape or piece.device != mesh.devices[i]:
                out.append(f"{what}: {name} shard {i} is {tuple(piece.shape)}"
                           f" on {piece.device}, want {shape} on "
                           f"{mesh.devices[i]}")
    for name in ("page_table", "ring_pos"):
        if not isinstance(cache[name], torch.Tensor):
            out.append(f"{what}: {name} is not whole")
    return out


def _sharded_memory_arm(cfg, model):
    """SHARDED_MEM: the same tight engine unsharded and at tp 2, each run's
    parks and restores timed and every restore read back against what was
    parked, shard by shard."""
    m = SHARDED_MEM
    sp = SamplingParams(max_tokens=m["new_tokens"])
    shape = dict(SLICE, path="staged", chunked=True, chunk_size=CHUNK,
                 n_blocks=m["n_blocks"],
                 memory=MemoryConfig(prefix_cache=True, host_tier=True))
    runs, problems = {}, []
    for tp in (1, m["tp"]):
        with virtual_devices(tp):
            eng = Engine.from_config(EngineConfig(
                **shape, parallel=ParallelConfig.tensor(tp)), model)
        sch = eng.scheduler
        log, bad = [], []
        unwrap = _time_block_moves(log, bad)
        try:
            reset_launch_counts()
            out, comps, secs = _serve_once(eng, synthetic_requests(
                m["requests"], m["lens"], cfg.vocab, m["new_tokens"],
                params=sp, shared_prefix=m["shared"]))
            counts = launch_counts()
        finally:
            unwrap()
        st = dict(eng.stats)
        runs[tp] = dict(payload=_payload(out, comps, st), counts=counts)
        if tp > 1:
            problems += _placement_problems(sch, tp, f"memory arm tp {tp}")
        if bad:
            problems.append(f"memory arm tp {tp}: restores differ: {bad}")
        if not (st["host_unloads"] > 0 and st["prefix_hit_rows"] > 0):
            problems.append(f"memory arm tp {tp}: nothing parked or hit: "
                            f"{st}")
        if any(sch._parked) or sch._host_store:
            problems.append(f"memory arm tp {tp}: a slot ended parked")
        sch.pool.audit()
        runs[tp]["report"] = dict(
            seconds=secs, stats=st, launches=counts,
            moves=_moves_summary(log, _block_bytes(sch.cache)),
            restores_read_back_equal=not bad)
        del eng, sch
        torch.cuda.empty_cache()
    one, two = runs[1], runs[m["tp"]]
    same = one["payload"] == two["payload"]
    if not same:
        problems.append(f"memory arm: tp {m['tp']} differs from unsharded: "
                        f"streams {one['payload'][0] == two['payload'][0]}, "
                        f"path counts "
                        f"{one['payload'][1] == two['payload'][1]}, stats "
                        f"{one['payload'][2]} vs {two['payload'][2]}")
    # once per device per drain or read: the mesh is one device
    for k, base in (("staged_scatter", "staged_scatter"),
                    ("flash_decode_paged_sharded", "flash_decode_paged")):
        if two["counts"][k] != one["counts"][base]:
            problems.append(f"memory arm: {k} launches {two['counts'][k]} "
                            f"!= the unsharded {base}'s "
                            f"{one['counts'][base]}")
    return dict(config=dict(SHARDED_MEM, chunk_size=CHUNK, path="staged"),
                equal_unsharded=same, unsharded=one["report"],
                sharded=two["report"]), problems


def phase_engine_sharded(kernels, blocking):
    """The engine phase's configuration (stablelm-1.6b at full width and
    depth, bf16, 16 requests, adaptive) with ``attention='fused'`` on a
    tp-4 virtual mesh of the card: each shard's pool ``[24, n_blocks + 1,
    16, 8, 64]`` on its device, the decision plane whole; streams, stats
    and per-request path counts equal to the engine phase's first timed
    run (the same configuration, weights, warm-up and requests); K1 and the
    sharded K2 launched once per device per drain or read (the virtual
    mesh is one device: as often as the engine phase's K1 and K2), K2 never
    alone, K3 as often. One decode segment profiled against the engine
    phase's. Then the memory arm (``_sharded_memory_arm``)."""
    cfg, model = _slice_model(SLICE_LAYERS)
    tp = SHARDED_TP
    shape = dict(SLICE, attention="fused")
    with virtual_devices(tp):
        eng = Engine.from_config(EngineConfig(
            **shape, parallel=ParallelConfig.tensor(tp)), model)
    sch = eng.scheduler
    run = _serve_timed(eng, cfg, NEW_TOKENS, 1)
    problems = _placement_problems(sch, tp, f"tp {tp}")
    got = _payload(run["outputs"], run["comps"], run["stats"])
    want = _payload(blocking["outputs"], blocking["comps"],
                    blocking["report"]["stats"])
    for what, a, b in zip(("streams", "path counts", "stats"), got, want):
        if a != b:
            problems.append(f"tp {tp}: {what} differ from the unsharded "
                            f"engine's")
    counts, base = run["counts"], blocking["report"]["launches"]
    # once per device per drain or read: the virtual mesh is one device
    for k, want in (("staged_scatter", base["staged_scatter"]),
                    ("flash_decode_paged_sharded",
                     base["flash_decode_paged"]),
                    ("flash_decode_paged", 0),
                    ("flash_attention", base["flash_attention"])):
        if counts[k] != want:
            problems.append(f"tp {tp}: {k} launched {counts[k]} times, not "
                            f"{want} (once per device per drain or read)")
    # row 7's launches: its own count in this run
    sharded_row = next(k for k in kernels
                       if k["name"] == "flash_decode_paged_sharded")
    sharded_row["launches"] = counts["flash_decode_paged_sharded"]
    if sharded_row["launches"] <= 0:
        problems.append(f"tp {tp}: the sharded read was never launched")
    profile = engine_profile(eng, cfg, SLICE, PROMPT_LENS)
    del eng, sch
    torch.cuda.empty_cache()
    mem, found = _sharded_memory_arm(cfg, model)
    problems += found
    sharded_row["launches_memory_arm"] = mem["sharded"]["launches"][
        "flash_decode_paged_sharded"]
    del model
    torch.cuda.empty_cache()
    unsharded = blocking["profile"]
    say("engine_sharded", tp=tp, config=dict(shape, parallel=f"tensor({tp})"),
        virtual_devices=True, equal_unsharded=not problems, **run["report"],
        unsharded_tok_per_s=blocking["report"]["tok_per_s"],
        unsharded_launches=base, profile=profile,
        unsharded_profile={k: unsharded[k] for k in (
            "step_ms", "device_ms_per_step", "device_ops_per_step",
            "device_busy_share")},
        memory_arm=mem)
    if problems:
        raise AssertionError("engine_sharded: " + "; ".join(problems))


def take_launches(kernels, counts, names):
    """The launch counts of one main path's run, for the kernels it owns."""
    for k in kernels:
        if k["name"] in names:
            k["launches"] = counts[k["name"]]
            if k["launches"] <= 0:
                raise AssertionError(f"{k['name']} was never launched by "
                                     f"the engine: {counts}")


# ---------------------------------------------------------------------------
# the memory tier on the paged slice: prefix cache and host tier
# ---------------------------------------------------------------------------


def _slice_model(n_layers=None):
    """The slice's model at full width, bf16, weights from seed 0; at full
    depth, or cut to its first ``n_layers`` layers."""
    cfg = get_config(SLICE["arch"])
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, build_model(cfg, device=DEV).init(0)


def _serve_once(eng, queue):
    """One serve between two synchronisations: (streams, completions,
    host-clock seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.serve(queue)
    torch.cuda.synchronize()
    return out, eng.completions(), time.perf_counter() - t0


def _ttft(comps):
    """Mean and nearest-rank p95 of the requests' TTFT (arrival to first
    token), seconds."""
    t = sorted(c.ttft_s for c in comps.values())
    return dict(mean_s=sum(t) / len(t), p95_s=t[-(-95 * len(t) // 100) - 1])


def _stream_diff(got, want):
    """{request: index of its first differing token} (-1: other length)."""
    out = {}
    for rid in sorted(set(got) | set(want)):
        a, b = got.get(rid), want.get(rid)
        if a is None or b is None or len(a) != len(b):
            out[rid] = -1
        elif (a != b).any():
            out[rid] = int((a != b).argmax())
    return out


def _segment_profile(sch, what):
    """Device ms per step of the next topped-up segment, from the
    profiler's trace, and whether it is mixed-phase."""
    mixed = sch._mixed_phase_pending()
    rows = trace_rows(lambda: sch.run_topped_up_segment(~sch.done_flags()),
                      what)
    steps = sch.cfg.segment_len
    return dict(mixed=mixed,
                device_ms_per_step=sum(r[0] for r in rows) / 1e3 / steps,
                device_ops_per_step=device_ops(rows) / steps)


def _prefix_queue(vocab, fresh):
    """The prefix traffic: 16 requests opening with the same 1024 tokens,
    suffixes of ``PREFIX_LENS`` - 1024 tokens. ``fresh``: requests 16-31 of
    the same generator, so the same system prompt with suffixes no request
    of the first 16 has."""
    sp = SamplingParams(max_tokens=NEW_TOKENS)
    n = 2 * N_REQUESTS if fresh else N_REQUESTS
    q = synthetic_requests(n, PREFIX_LENS, vocab, NEW_TOKENS, params=sp,
                           shared_prefix=PREFIX_SHARED)
    while len(q) > N_REQUESTS:
        q.pop_at(0)
    return q


def _expected_hits(rids, full):
    """Rows a pass over requests ``rids`` takes from the cache when every
    request's full prompt pages are registered (``full``; a whole-page
    prompt re-runs its last row) or only the shared system prompt's."""
    ps = SLICE["page_size"]
    out = []
    for rid in rids:
        p = PREFIX_LENS[rid % len(PREFIX_LENS)]
        out.append((p - 1 if p % ps == 0 else p // ps * ps) if full
                   else PREFIX_SHARED)
    return out


def _prefix_run(model, path, profile):
    """The prefix phase's passes on ``path``: cold, warm and repeat on one
    engine with the cache, cold and warm on one without. Returns the passes,
    the reference streams and seconds, and (``profile``) the device time of
    a mixed step warm and cold."""
    cfg = model.cfg
    shape = dict(SLICE, chunked=True, chunk_size=CHUNK, path=path)
    eng = Engine.from_config(EngineConfig(
        **shape, memory=MemoryConfig(prefix_cache=True)), model)
    sch = eng.scheduler
    # warm-up on prompts that share nothing with the measured ones, then a
    # fresh pool
    eng.serve(synthetic_requests(len(PREFIX_LENS), 64, cfg.vocab, 2, seed=1,
                                 params=SamplingParams(max_tokens=2)))
    eng.reset()
    passes = {}
    for name, fresh in (("cold", False), ("warm", True), ("repeat", False)):
        if name != "cold":
            eng.reset(keep_cache=True)
        reset_launch_counts()       # counts = 0 just before each pass
        out, comps, secs = _serve_once(eng, _prefix_queue(cfg.vocab, fresh))
        passes[name] = dict(out=out, comps=comps, seconds=secs,
                            counts=launch_counts(), stats=dict(eng.stats))
        sch.pool.audit()
    ref_eng = Engine.from_config(EngineConfig(**shape), model)
    ref = {}
    for name, fresh in (("cold", False), ("warm", True)):
        ref[name], _, ref[name + "_seconds"] = _serve_once(
            ref_eng, _prefix_queue(cfg.vocab, fresh))
        ref_eng.reset()
    del ref_eng
    prof = {}
    if profile:
        # device time a mixed step: with the system prompt cached (the warm
        # pass's requests, every slot's first segment) and cold (a fresh
        # pool, every slot prefilling)
        eng.reset(keep_cache=True)
        sch.admit(_prefix_queue(cfg.vocab, True))
        prof["warm"] = _segment_profile(sch, f"prefix warm segment {path}")
        eng.reset()
        sch.admit(_prefix_queue(cfg.vocab, False))
        sch.run_topped_up_segment(~sch.done_flags())
        prof["cold"] = _segment_profile(sch, f"prefix cold segment {path}")
    del eng
    torch.cuda.empty_cache()
    return passes, ref, prof


def _prefix_problems(path, passes, want):
    """What ``engine_prefix`` holds of one path's passes besides streams."""
    out = []
    for name, run in passes.items():
        st = run["stats"]
        if st["prefix_hit_rows"] != sum(want[name]):
            out.append(f"{path} {name}: prefix_hit_rows "
                       f"{st['prefix_hit_rows']} != {sum(want[name])}")
        n_cow = (sum(PREFIX_LENS[r % len(PREFIX_LENS)] % SLICE["page_size"]
                     == 0 for r in range(N_REQUESTS))
                 if name == "repeat" else 0)
        if st["cow_copies"] != n_cow:
            out.append(f"{path} {name}: cow_copies {st['cow_copies']} != "
                       f"{n_cow}")
        base = N_REQUESTS if name == "warm" else 0
        for rid, c in run["comps"].items():
            pc, plen = c.path_counts, PREFIX_LENS[rid % len(PREFIX_LENS)]
            if (pc["prefill"] != plen - want[name][rid - base]
                    or pc["direct"] + pc["staged"] != NEW_TOKENS - 1):
                out.append(f"{path} {name}: request {rid} path counts {pc}")
        for k in ("staged_scatter", "flash_decode_paged"):
            if run["counts"][k] <= 0:
                out.append(f"{path} {name}: {k} not launched: "
                           f"{run['counts']}")
    return out


def phase_engine_prefix(kernels):
    """The slice chunked at 16 with ``MemoryConfig(prefix_cache=True)``,
    bf16 at full width, cut to ``MEMORY_LAYERS`` of its 24 layers:
    requests opening with the same 1024 tokens (a system prompt), suffixes
    of 64-192 tokens, 64 new tokens each. Three passes on one engine: COLD (16 requests, a fresh engine: the
    first 8 find nothing cached, the next 8 the system prompt), WARM after
    ``reset(keep_cache=True)`` (16 requests with the same system prompt and
    suffixes never seen: each takes its 1024 rows from the cache), and
    REPEAT after another such reset (the cold pass's requests again: every
    full prompt page cached; a whole-page prompt re-runs its last row, its
    last block copied first). The same engine without the cache serves the
    cold and the warm requests. Run on the adaptive path (the main path:
    timed, profiled, its launch counts in the kernels line) and on the
    staged path.

    Held on both paths: ``prefix_hit_rows`` is 8 x 1024 cold, 16 x 1024
    warm and every full prompt page on the repeat, with a copy per
    whole-page prompt (``cow_copies``); each request's prefill writes are
    its uncached rows; the pool's audit; K1 and K2 launched in every pass.
    Held exactly on the staged path: the cold and the warm streams equal
    those without the cache. That is exact by construction: a hit of the
    1024 shared rows (64 chunks, 4 segments) shifts a request's schedule by
    whole segments, so every row runs in the same kind of step at the same
    ring phase, and the staged path stages every decode write whatever its
    block. Reported, not held: the same comparisons on the adaptive path,
    which routes a write by its block's heat (the warm pass's blocks have
    other histories than the engine's without the cache), and the repeat
    pass against the cold one (a fully cached prompt flips in its first
    step, so its decode rows run in mixed-phase steps, the MLP's GEMM at M =
    128, where the cold pass ran them in decode steps at M = 8); cuBLAS and
    K2 round those differently (``tools/prefix_divergence.py`` finds the
    first such row)."""
    cfg, model = _slice_model(MEMORY_LAYERS)
    first_wave = N_REQUESTS // 2
    want = dict(cold=[0] * first_wave
                + _expected_hits(range(first_wave, N_REQUESTS), False),
                warm=_expected_hits(range(N_REQUESTS, 2 * N_REQUESTS), False),
                repeat=_expected_hits(range(N_REQUESTS), True))
    n_tok = N_REQUESTS * NEW_TOKENS
    problems, report = [], {}
    for path in ("adaptive", "staged"):
        passes, ref, prof = _prefix_run(model, path, path == "adaptive")
        problems += _prefix_problems(path, passes, want)
        diffs = dict(
            cold_vs_no_cache=_stream_diff(passes["cold"]["out"], ref["cold"]),
            warm_vs_no_cache=_stream_diff(passes["warm"]["out"], ref["warm"]),
            repeat_vs_cold=_stream_diff(passes["repeat"]["out"],
                                        passes["cold"]["out"]))
        held = ["cold_vs_no_cache", "warm_vs_no_cache"] \
            if path == "staged" else []
        for what in held:
            if diffs[what]:
                problems.append(f"{path} {what}: streams differ (request: "
                                f"first token) {diffs[what]}")
        if path == "adaptive":
            for k in kernels:
                if k["name"] in ("staged_scatter", "flash_decode_paged"):
                    for name, run in passes.items():
                        k[f"launches_prefix_{name}"] = run["counts"][k["name"]]
        report[path] = dict(
            ttft={name: _ttft(run["comps"]) for name, run in passes.items()},
            tok_per_s=dict({name: n_tok / run["seconds"]
                            for name, run in passes.items()},
                           no_cache_cold=n_tok / ref["cold_seconds"],
                           no_cache_warm=n_tok / ref["warm_seconds"]),
            stats={name: run["stats"] for name, run in passes.items()},
            launches={name: run["counts"] for name, run in passes.items()},
            mixed_step=prof, streams_held=held, streams_differ=diffs)
    del model
    torch.cuda.empty_cache()
    say("engine_prefix", config=dict(SLICE, chunked=True, chunk_size=CHUNK),
        n_layers=cfg.n_layers,
        shared_prefix=PREFIX_SHARED, prompt_lens=PREFIX_LENS,
        new_tokens=NEW_TOKENS, requests=N_REQUESTS,
        hit_rows_expected={k: sum(v) for k, v in want.items()}, **report)
    if problems:
        raise AssertionError("engine_prefix: " + "; ".join(problems))


def _time_block_moves(log, bad):
    """Wrap the host tier's two bulk moves (``PG.unload_blocks`` /
    ``PG.load_blocks``, as the scheduler calls them): each call between two
    synchronisations, its blocks and host-clock ms appended to ``log``.
    After each restore (outside the timed span) the restored blocks are
    read back and compared with the host copy they came from, bit for bit;
    a mismatch is appended to ``bad``. Returns the function that unwraps
    them."""
    unload, load = PG.unload_blocks, PG.load_blocks

    def timed(kind, fn, cache, blocks, *rest):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(cache, blocks, *rest)
        torch.cuda.synchronize()
        log.append((kind, len(blocks), (time.perf_counter() - t0) * 1e3))
        return out

    def restore(cache, blocks, host_k, host_v):
        out = timed("restore", load, cache, blocks, host_k, host_v)
        bl = torch.as_tensor(list(blocks), device=DEV).long()
        for plane, host in (("pages_k", host_k), ("pages_v", host_v)):
            x = cache[plane]
            if isinstance(x, ShardedTensor):
                # every shard holds its head slice of the parked blocks
                got = [(p[:, bl].cpu(), host[..., sl, :])
                       for p, (_, sl) in zip(x.shards,
                                             x.slices(host.shape[3]))]
            else:
                got = [(x[:, bl].cpu(), host)]
            if not all(torch.equal(a, h) for a, h in got):
                bad.append(f"{plane} of blocks {list(blocks)[:4]}...")
        return out

    PG.unload_blocks = lambda c, b: timed("park", unload, c, b)
    PG.load_blocks = restore

    def unwrap():
        PG.unload_blocks, PG.load_blocks = unload, load
    return unwrap


def _block_bytes(cache):
    """Bytes of one block, K and V planes, every layer."""
    l, _, ps, h, d = cache["pages_k"].shape
    return 2 * l * ps * h * d * cache["pages_k"].element_size()


def _moves_summary(log, block_bytes):
    out = {}
    for kind in ("park", "restore"):
        rows = [r for r in log if r[0] == kind]
        if not rows:
            continue
        blocks = sum(r[1] for r in rows)
        ms = sum(r[2] for r in rows)
        out[kind] = dict(count=len(rows), blocks=blocks,
                         blocks_max=max(r[1] for r in rows),
                         bytes=blocks * block_bytes, host_ms=ms,
                         host_ms_each=[r[2] for r in rows],
                         host_gb_per_s=blocks * block_bytes / ms / 1e6)
    return out


def _copy_rates(cache, n_blocks):
    """One park's and one restore's copies of ``n_blocks`` blocks on an idle
    pool, and a plain pinned ``copy_`` of the same bytes each way: the time
    between CUDA events around one call (median of 30, warm), the device
    time by kernel from the profiler's trace, and the host-clock time of a
    call between two synchronisations (median of 3); against the link's
    bound (bytes / 64 GB/s)."""
    blocks = list(range(n_blocks))
    nbytes = n_blocks * _block_bytes(cache)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    keep = {}

    def unload():
        keep["kv"] = PG.unload_blocks(cache, blocks)

    def load():
        PG.load_blocks(cache, blocks, *keep["kv"])

    out = dict(blocks=n_blocks, bytes=nbytes,
               link_bound_ms=nbytes / PCIE_BYTES_PER_S * 1e3)
    for name, fn in (("park", unload), ("restore", load),
                     ("pinned_d2h", lambda: host.copy_(dev,
                                                       non_blocking=True)),
                     ("pinned_h2d", lambda: dev.copy_(host,
                                                      non_blocking=True))):
        event_ms = time_ms(fn, warm=2, reps=30)
        host_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        rows = trace_rows(fn, f"host tier {name}")
        copy_us = sum(r[0] for r in rows if "Memcpy" in r[2])
        out[name] = dict(event_ms=event_ms,
                         event_gb_per_s=nbytes / event_ms / 1e6,
                         host_ms=sorted(host_ms)[1],
                         device_ms=sum(r[0] for r in rows) / 1e3 or None,
                         copy_device_ms=copy_us / 1e3 or None,
                         copy_gb_per_s=(nbytes / copy_us / 1e3
                                        if copy_us else None),
                         rows=[dict(kernel=r[2][:64], us=r[0], calls=r[1])
                               for r in rows if r[0] > 0][:6])
    return out


def _host_tier_case(model, shape, extra, queue, tag):
    """One configuration with ``MemoryConfig(host_tier=True, **extra)`` over
    ``HOST_BLOCKS`` blocks against the same engine with an ample pool.
    Returns (report, problems, streams of both, launch counts, the tight
    engine)."""
    ample = Engine.from_config(EngineConfig(**shape), model)
    out_a, _, s_a = _serve_once(ample, queue())
    del ample
    torch.cuda.empty_cache()
    tight = Engine.from_config(EngineConfig(
        **shape, n_blocks=HOST_BLOCKS,
        memory=MemoryConfig(host_tier=True, **extra)), model)
    sch = tight.scheduler
    log, bad = [], []
    unwrap = _time_block_moves(log, bad)
    try:
        reset_launch_counts()       # counts = 0 just before the tight serve
        out_t, comps_t, s_t = _serve_once(tight, queue())
        counts = launch_counts()
    finally:
        unwrap()
    st = dict(tight.stats)
    n_tok = sum(len(t) for t in out_t.values())
    report = dict(
        config=dict(shape, n_blocks=HOST_BLOCKS,
                    memory=dict(host_tier=True, **extra)),
        tok_per_s=n_tok / s_t, ample_tok_per_s=n_tok / s_a,
        seconds=s_t, ample_seconds=s_a, stats=st, launches=counts,
        moves=_moves_summary(log, _block_bytes(sch.cache)),
        restores_read_back_equal=not bad,
        ttft=_ttft(comps_t), streams_differ=_stream_diff(out_t, out_a))
    problems = [f"{tag}: a restore did not give back what was parked: "
                f"{b}" for b in bad]
    if not st["host_unloads"] > 0 or st["host_pageins"] <= 0:
        problems.append(f"{tag}: nothing parked or restored: {st}")
    if any(sch._parked) or sch._host_store:
        problems.append(f"{tag}: a slot ended parked")
    sch.pool.audit()
    for k in ("staged_scatter", "flash_decode_paged"):
        if counts[k] <= 0:
            problems.append(f"{tag}: {k} not launched: {counts}")
    if extra.get("prefix_cache") and not st["prefix_hit_rows"] > 0:
        problems.append(f"{tag}: the prefix cache hit nothing: {st}")
    return report, problems, counts, tight


def phase_engine_host_tier(kernels):
    """The slice with ``MemoryConfig(host_tier=True)`` over a pool of 320
    blocks (about half the working set of 8 live slots, at least the largest
    request's 116 pages), bf16 at full width, cut to ``MEMORY_LAYERS`` of
    its 24 layers, on the staged path:
    16 requests of 512 / 1024 / 1536 / 1792 tokens, 64 new tokens each,
    blocking, chunked at 16, and chunked with the prefix cache and the host
    tier together (the prefix cache needs chunked prefill; every prompt
    opens with the same 512 tokens there); each against the same engine
    with an ample pool.

    Held in every run: ``host_unloads`` > 0 and restores; every restore
    reads back bit-equal to what was parked; no slot ends parked; the
    pool's audit; K1 and K2 launched; with the prefix cache, hits. Held
    exactly: the blocking run's
    streams equal the ample pool's. That comparison is exact by
    construction: blocking runs only decode steps (M = 8), a park stalls a
    slot for whole segments (so its rows meet the ring at the same phase),
    and the staged path routes no write by its block. The chunked runs'
    streams are reported: a park changes which steps are mixed-phase, and
    with them the GEMMs' M (see ``phase_engine_prefix``). Reported: tok/s
    against the ample pool; each park's and restore's blocks, bytes, host
    ms and GB/s; one 116-block park and restore traced on the device
    against a plain pinned copy of the same bytes and the link's bound."""
    cfg, model = _slice_model(MEMORY_LAYERS)
    sp = SamplingParams(max_tokens=NEW_TOKENS)

    def queue(shared=0):
        return synthetic_requests(N_REQUESTS, HOST_LENS, cfg.vocab,
                                  NEW_TOKENS, params=sp, shared_prefix=shared)

    staged = dict(SLICE, path="staged")
    chunked = dict(staged, chunked=True, chunk_size=CHUNK)
    ps = SLICE["page_size"]
    biggest = -(-(max(HOST_LENS) + NEW_TOKENS - 1) // ps)
    warm = Engine.from_config(EngineConfig(**staged), model)
    warm.serve(synthetic_requests(2, HOST_LENS[:2], cfg.vocab, 2, seed=1,
                                  params=SamplingParams(max_tokens=2)))
    del warm
    report, problems = {}, []
    for name, shape, extra in (("blocking", staged, {}),
                               ("chunked", chunked, {}),
                               ("both", chunked, dict(prefix_cache=True))):
        r, found, counts, tight = _host_tier_case(
            model, shape, extra,
            lambda: queue(HOST_SHARED if extra else 0), name)
        problems += found
        r["streams_held"] = name == "blocking"
        if r["streams_held"] and r["streams_differ"]:
            problems.append(f"{name}: streams differ from the ample pool's "
                            f"(request: first token) {r['streams_differ']}")
        for k in kernels:
            if k["name"] in ("staged_scatter", "flash_decode_paged"):
                k[f"launches_host_tier_{name}"] = counts[k["name"]]
        if name == "chunked":
            report["copies"] = _copy_rates(tight.scheduler.cache, biggest)
        report[name] = r
        del tight
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    say("engine_host_tier", n_layers=cfg.n_layers, requests=N_REQUESTS,
        prompt_lens=HOST_LENS,
        new_tokens=NEW_TOKENS, n_blocks=HOST_BLOCKS,
        shared_prefix_with_prefix_cache=HOST_SHARED,
        working_set_pages=sum(-(-(p + NEW_TOKENS - 1) // ps)
                              for p in HOST_LENS) * 2,
        link_gb_per_s=PCIE_BYTES_PER_S / 1e9, **report)
    if problems:
        raise AssertionError("engine_host_tier: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# sampled decoding: the threefry key chain and the sampler on the card
# ---------------------------------------------------------------------------

# jax 0.9.0's answers, kept as constants (this script imports no JAX):
# Random123's known answers for Threefry-2x32 with 20 rounds, and the key
# data of ``split(key(0))`` and ``fold_in(key(0), 3)``
THREEFRY_KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0))]
SPLIT_KEY0 = [[1797259609, 2579123966], [928981903, 3453687069]]
FOLD_IN_KEY0_3 = [2467461003, 3840466878]
# the sampler's test: 8 slots, the slice's full vocabulary, the key chain
# over 64 steps, the tokens over 32 (the CPU's sampler takes most of the
# phase), the engine_sampled phase's parameter mix
SAMPLER_SLOTS, SAMPLER_STEPS, SAMPLER_DRAWS = 8, 64, 32
SAMPLER_TEMP = [0.0, 0.8, 0.8, 1.0, 0.8, 1.0, 0.0, 0.8]
SAMPLER_TOP_K = [0, 0, 40, 0, 0, 40, 0, 40]
SAMPLER_TOP_P = [1.0, 1.0, 1.0, 0.9, 0.9, 1.0, 1.0, 0.9]


def _sampler_params(device):
    s = SAMPLER_SLOTS
    return SMP.SlotParams(
        temperature=torch.tensor(SAMPLER_TEMP, device=device),
        top_k=torch.tensor(SAMPLER_TOP_K, device=device),
        top_p=torch.tensor(SAMPLER_TOP_P, device=device),
        stop=torch.full((s, SMP.MAX_STOP_TOKENS), -1, device=device))


def phase_sampler():
    """The key chain on the card: Random123's known answers and jax 0.9.0's
    ``split`` / ``fold_in`` goldens, bit for bit; 8 slots' chains split
    once per step for 64 steps on the card and on the CPU, bit for bit.
    ``sample_tokens`` on the same full-vocabulary logits and keys on the
    card and on the CPU, 32 steps in each mode: the differing tokens are
    counted (the float ``log`` and the top-p ``cumsum`` may round otherwise
    on the card). ``filtered`` run twice on the card on the same inputs:
    the tokens, the masked logits and the keys must be identical. Each
    mode's device time and device operations per call at [8, V]."""
    problems = []
    for key, count, want in THREEFRY_KAT:
        a, b = prng.threefry2x32(
            *(torch.tensor(v, device=DEV) for v in (*key, *count)))
        if (int(a), int(b)) != want:
            problems.append(f"threefry{key}{count} = {int(a):#x}, "
                            f"{int(b):#x}")
    k0 = prng.key(0, DEV)
    if prng.split(k0).tolist() != SPLIT_KEY0:
        problems.append(f"split(key(0)) = {prng.split(k0).tolist()}")
    if prng.fold_in(k0, 3).tolist() != FOLD_IN_KEY0_3:
        problems.append(f"fold_in(key(0), 3) = {prng.fold_in(k0, 3)}")
    s, steps = SAMPLER_SLOTS, SAMPLER_STEPS
    vocab = get_config(SLICE["arch"]).vocab
    base = prng.key(7)
    keys = prng.fold_in(base[None, :], torch.arange(s))
    kc, kd = keys.clone(), keys.to(DEV)
    for _ in range(steps):
        kc, kd = prng.split(kc)[:, 1], prng.split(kd)[:, 1]
    if not torch.equal(kc, kd.cpu()):
        problems.append("the key chain parts from the CPU's")
    draws = SAMPLER_DRAWS
    gen = torch.Generator().manual_seed(11)
    logits = torch.randn((draws, s, vocab), generator=gen) * 4
    differ = {m: 0 for m in SMP.SAMPLE_MODES}
    repeat_ok = True
    cpu_p, dev_p = _sampler_params("cpu"), _sampler_params(DEV)
    kc, kd = keys.clone(), keys.to(DEV)
    for t in range(draws):
        lg_d = logits[t].to(DEV)
        for mode in SMP.SAMPLE_MODES:
            tc, nc = SMP.sample_tokens(logits[t], kc, cpu_p, mode)
            td, nd = SMP.sample_tokens(lg_d, kd, dev_p, mode)
            differ[mode] += int((tc != td.cpu()).sum())
            if not torch.equal(nc, nd.cpu()):
                problems.append(f"{mode}: next keys part from the CPU's")
        t2, n2 = SMP.sample_tokens(lg_d, kd, dev_p, "filtered")
        scaled = lg_d / torch.where(dev_p.temperature > 0,
                                    dev_p.temperature, 1.0)[:, None]
        f1 = SMP.filter_logits(scaled, dev_p.top_k, dev_p.top_p)
        f2 = SMP.filter_logits(scaled, dev_p.top_k, dev_p.top_p)
        repeat_ok &= (torch.equal(td, t2) and torch.equal(nd, n2)
                      and torch.equal(f1, f2))
        kc, kd = nc, nd
    if not repeat_ok:
        problems.append("filtered gave other results on a repeat")
    if differ["greedy"]:
        problems.append(f"greedy tokens differ from the CPU's: {differ}")
    cost = {}
    lg_d = logits[0].to(DEV)
    for mode in SMP.SAMPLE_MODES:
        rows = trace_rows(lambda: SMP.sample_tokens(lg_d, kd, dev_p, mode),
                          f"sampler {mode}")
        cost[mode] = dict(
            device_ms=device_ms(
                lambda: SMP.sample_tokens(lg_d, kd, dev_p, mode),
                f"sampler {mode} x20"),
            event_ms=time_ms(
                lambda: SMP.sample_tokens(lg_d, kd, dev_p, mode)),
            device_ops=device_ops(rows))
    say("sampler", slots=s, vocab=vocab, chain_steps=steps,
        params=dict(temperature=SAMPLER_TEMP, top_k=SAMPLER_TOP_K,
                    top_p=SAMPLER_TOP_P),
        known_answers_held=not problems, tokens_differing_from_cpu=differ,
        tokens_compared_per_mode=draws * s,
        filtered_repeat_identical=repeat_ok,
        cost_per_call=cost)
    if problems:
        raise AssertionError("sampler: " + "; ".join(problems))


def _sampled_params(i, new_tokens):
    """The engine_sampled mix, by request index: greedy, T = 0.8, top-k 40,
    top-p 0.9, and each of the last three with an explicit seed on every
    other request."""
    kind = i % 4
    seed = 1000 + i if (i // 4) % 2 else None
    if kind == 0:
        return SamplingParams(max_tokens=new_tokens, temperature=0.0)
    if kind == 1:
        return SamplingParams(max_tokens=new_tokens, temperature=0.8,
                              seed=seed)
    if kind == 2:
        return SamplingParams(max_tokens=new_tokens, temperature=0.8,
                              top_k=40, seed=seed)
    return SamplingParams(max_tokens=new_tokens, temperature=0.8, top_p=0.9,
                          seed=seed)


def _sampled_queue(vocab, params, n=None, new_tokens=None, lens=None,
                   media_shape=None):
    """The slice's requests (``N_REQUESTS`` of ``PROMPT_LENS``,
    ``NEW_TOKENS`` new unless given), request ``i`` with ``params(i,
    new_tokens)``, each with frames of ``media_shape`` if given."""
    n, new_tokens = n or N_REQUESTS, new_tokens or NEW_TOKENS
    return synthetic_requests(n, lens or PROMPT_LENS, vocab, new_tokens,
                              media_shape=media_shape,
                              params=[params(i, new_tokens)
                                      for i in range(n)])


def phase_engine_sampled(kernels):
    """The slice (stablelm-1.6b at full width, cut to ``MEMORY_LAYERS`` of
    its 24 layers, bf16, paged, adaptive: every comparison here is within
    the phase) serving 16 requests with mixed sampling parameters (greedy,
    T = 0.8, top-k 40, top-p 0.9, explicit seeds on half of the sampled
    ones), blocking and chunked at 16. Held in each: a repeat run gives
    identical streams (the key chain and the sampler are deterministic);
    an all-(T = 1, top_k = 1) run gives the streams of an all-greedy run of
    the same requests (the filter keeps the argmax alone, exact by
    construction); K1 and K2 launched. Reported: tok/s; a decode segment's
    device ms, device operations and host ms per step with the mix (the
    ``filtered`` sampler) against an all-greedy one. Returns the blocking
    all-greedy run (streams, tok/s, decode profile), which ``engine_spec``
    compares with at the same depth."""
    cfg, model = _slice_model(MEMORY_LAYERS)
    mixed = _sampled_params
    topk1 = lambda i, n: SamplingParams(  # noqa: E731
        max_tokens=n, temperature=1.0, top_k=1, seed=i)
    greedy = lambda i, n: SamplingParams(max_tokens=n)  # noqa: E731
    report, problems, ref = {}, [], {}
    for name, shape in (("blocking", SLICE),
                        ("chunked", dict(SLICE, chunked=True,
                                         chunk_size=CHUNK))):
        eng = Engine.from_config(EngineConfig(**shape), model)
        eng.serve(synthetic_requests(len(PROMPT_LENS), PROMPT_LENS,
                                     cfg.vocab, 2, params=SamplingParams(
                                         max_tokens=2, temperature=0.8)))
        eng.reset()
        reset_launch_counts()       # counts = 0 just before the main path
        out, comps, secs = _serve_once(eng, _sampled_queue(cfg.vocab, mixed))
        counts = launch_counts()    # read just after
        runs = {"mixed": (out, secs)}
        for what, params in (("repeat", mixed), ("top_k_1", topk1),
                             ("greedy", greedy)):
            eng.reset()
            o, _, sec = _serve_once(eng, _sampled_queue(cfg.vocab, params))
            runs[what] = (o, sec)
        diffs = dict(repeat=_stream_diff(runs["repeat"][0], out),
                     top_k_1_vs_greedy=_stream_diff(runs["top_k_1"][0],
                                                    runs["greedy"][0]),
                     mixed_vs_greedy=_stream_diff(out, runs["greedy"][0]))
        for what in ("repeat", "top_k_1_vs_greedy"):
            if diffs[what]:
                problems.append(f"{name} {what}: streams differ (request: "
                                f"first token) {diffs[what]}")
        for k in ("staged_scatter", "flash_decode_paged"):
            if counts[k] <= 0:
                problems.append(f"{name}: {k} not launched: {counts}")
        for k in kernels:
            if k["name"] in ("staged_scatter", "flash_decode_paged"):
                k[f"launches_sampled_{name}"] = counts[k["name"]]
        n_tok = sum(len(t) for t in out.values())
        report[name] = dict(
            tok_per_s={w: sum(len(t) for t in o.values()) / sec
                       for w, (o, sec) in runs.items()},
            ttft=_ttft(comps), stats=dict(eng.stats), launches=counts,
            tokens=n_tok, streams_differ=diffs)
        if name == "blocking":
            report["steps"] = {
                mode: engine_profile(eng, cfg, shape, PROMPT_LENS,
                                     params=params)
                for mode, params in (("greedy", greedy), ("mixed", mixed))}
            for mode, prof in report["steps"].items():
                prof["tok_per_s"] = shape["n_slots"] / prof["step_ms"] * 1e3
            ref = dict(outputs=runs["greedy"][0],
                       report=dict(tok_per_s=report[name]["tok_per_s"][
                           "greedy"]),
                       profile=report["steps"]["greedy"])
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    say("engine_sampled", config=SLICE, requests=N_REQUESTS,
        new_tokens=NEW_TOKENS, params_mix="greedy / T 0.8 / T 0.8 top-k 40 "
        "/ T 0.8 top-p 0.9, explicit seeds on requests 4-7, 12-15",
        **report)
    if problems:
        raise AssertionError("engine_sampled: " + "; ".join(problems))
    return ref


# ---------------------------------------------------------------------------
# speculative decoding on the paged slice
# ---------------------------------------------------------------------------

# name, engine shape over SLICE, the sampling mix
SPEC_ARMS = (("adaptive_blocking_greedy", {}, "greedy"),
             ("staged_chunked_greedy",
              dict(path="staged", chunked=True, chunk_size=CHUNK), "greedy"),
             ("adaptive_blocking_filtered", {}, "filtered"))
SPEC_KERNELS = ("staged_scatter", "flash_decode_paged", "flash_attention",
                "flash_decode")


def _spec_arm(model, cfg, extra, mix):
    """One arm of ``engine_spec``: warm-up, then the slice's requests served
    once with the launch counts set to 0 just before and read just after.
    Returns (streams, stats, counts, seconds, the engine)."""
    shape = dict(SLICE, **extra)
    eng = Engine.from_config(EngineConfig(
        **shape, spec=SpecConfig(enabled=True, k=SPEC_K)), model)
    eng.serve(synthetic_requests(len(PROMPT_LENS), PROMPT_LENS, cfg.vocab,
                                 2, params=SamplingParams(max_tokens=2)))
    eng.reset()
    params = (_sampled_params if mix == "filtered"
              else lambda i, n: SamplingParams(max_tokens=n))
    reset_launch_counts()           # counts = 0 just before the main path
    out, _, secs = _serve_once(eng, _sampled_queue(cfg.vocab, params))
    counts = launch_counts()        # read just after
    return out, dict(eng.stats), counts, secs, eng


def phase_engine_spec(kernels, blocking):
    """The slice (stablelm-1.6b at full width, cut to ``MEMORY_LAYERS`` of
    its 24 layers, bf16, paged) with
    ``SpecConfig(enabled=True, k=4)``, self-draft, serving the engine
    phase's 16 requests x 64 tokens: adaptive blocking greedy, staged
    chunked (chunks of 16) greedy, and adaptive blocking with
    ``engine_sampled``'s mix (the ``filtered`` sampler). Held in each arm
    (exact by construction): ``spec_proposed == k * spec_rounds``, ``0 <=
    spec_accepted <= spec_proposed``, on the blocking arms every token but
    the prefill one committed by a round (``spec_committed == emitted -
    requests``), the pool's audit, and K1 (the boundary drains of the
    ring-bearing paths), K2 (the verify), K3 (prefill and the draft's
    re-prefill) and K4 (the draft's steps) launched. Reported: tok/s,
    committed tokens per round, the acceptance share (self-draft reads its
    keys through K4 on lanes and the target through K2 on pages, so in
    bf16 a share below 1 is a finding), the greedy arm's streams against
    ``blocking``, the non-spec greedy run of ``engine_sampled`` at the same
    depth (the verify's GEMM has M = 8 x 5 where a decode step's has M = 8:
    a known difference by construction), and a spec segment profiled beside
    that run's decode one."""
    cfg, model = _slice_model(MEMORY_LAYERS)
    report, problems = {}, []
    for name, extra, mix in SPEC_ARMS:
        out, st, counts, secs, eng = _spec_arm(model, cfg, extra, mix)
        eng.scheduler.pool.audit()
        n_tok = sum(len(t) for t in out.values())
        chunked = bool(extra.get("chunked"))
        if st["spec_proposed"] != SPEC_K * st["spec_rounds"]:
            problems.append(f"{name}: spec_proposed != k * spec_rounds {st}")
        if not 0 <= st["spec_accepted"] <= st["spec_proposed"]:
            problems.append(f"{name}: spec_accepted out of range {st}")
        if not chunked and st["spec_committed"] != n_tok - len(out):
            problems.append(f"{name}: spec_committed {st['spec_committed']}"
                            f" != emitted - requests {n_tok - len(out)}")
        if len(out) != N_REQUESTS or any(len(t) != NEW_TOKENS
                                         for t in out.values()):
            problems.append(f"{name}: not every request got {NEW_TOKENS} "
                            f"tokens")
        for k in SPEC_KERNELS:
            if counts[k] <= 0:
                problems.append(f"{name}: {k} not launched: {counts}")
        arm = dict(config=dict(extra, mix=mix), tokens=n_tok, seconds=secs,
                   tok_per_s=n_tok / secs, stats=st, launches=counts,
                   committed_per_round=st["spec_committed"]
                   / max(st["spec_rounds"], 1),
                   acceptance_share=st["spec_accepted"]
                   / max(st["spec_proposed"], 1))
        if name == "adaptive_blocking_greedy":
            diff = _stream_diff(out, blocking["outputs"])
            arm["streams_equal_engine_share"] = 1 - len(diff) / len(out)
            arm["first_divergence"] = diff
            arm["engine_tok_per_s"] = blocking["report"]["tok_per_s"]
            arm["profile"] = engine_profile(eng, cfg, SLICE, PROMPT_LENS)
            arm["decode_profile"] = {
                k: blocking["profile"][k] for k in (
                    "step_ms", "device_ms_per_step", "device_busy_share",
                    "device_ops_per_step")}
            for k in kernels:
                if k["name"] == "flash_decode_paged":
                    k["verify_shape"]["launches"] = counts[k["name"]]
                if k["name"] == "flash_decode":
                    k["draft_shape"]["launches"] = counts[k["name"]]
        for k in kernels:
            if k["name"] in SPEC_KERNELS:
                k[f"launches_spec_{name}"] = counts[k["name"]]
        report[name] = arm
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    say("engine_spec", config=SLICE, n_layers=MEMORY_LAYERS, k=SPEC_K,
        requests=N_REQUESTS, new_tokens=NEW_TOKENS, **report)
    if problems:
        raise AssertionError("engine_spec: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# the open-loop loadtest (benchmarks/loadtest.py's three arms) on the card
# ---------------------------------------------------------------------------

LOADTEST_ARMS = (("direct_fifo", "direct", "fifo"),
                 ("staged_fifo", "staged", "fifo"),
                 ("adaptive", "adaptive", "sched/deadline"))
LOADTEST_SHAPE = dict(max_seq=96, n_slots=8, segment_len=8, chunked=True,
                      chunk_size=16, page_size=8)
LOADTEST_REQUESTS, LOADTEST_SEED = 48, 7


def loadtest_workload(vocab):
    """``benchmarks/loadtest.py``'s bursty two-tenant mix (its
    ``build_workload``): rates in VIRTUAL requests per second."""
    classes = [
        RequestClass("interactive", ttft_slo_s=1.0e-3, itl_slo_s=1.0e-3,
                     priority=1, prompt_len=(4, 12), max_tokens=6,
                     weight=3.0),
        RequestClass("batch", ttft_slo_s=20.0e-3, itl_slo_s=5.0e-3,
                     priority=0, prompt_len=(24, 48), max_tokens=12,
                     weight=1.0),
    ]
    process = MarkovModulatedArrivals(calm_rps=400.0, burst_rps=60000.0,
                                      mean_calm_s=2.0e-3,
                                      mean_burst_s=8.0e-3)
    return generate_workload(classes, process, LOADTEST_REQUESTS,
                             vocab=vocab, seed=LOADTEST_SEED)


def _loadtest_row(res):
    out = {}
    for label, r in res.items():
        cls = {n: dict(n=c.n, slo_met=c.n_slo_met, ttft_p95_ms=c.ttft_p95_s
                       * 1e3, itl_p95_ms=c.itl_p95_s * 1e3)
               for n, c in r.per_class.items()}
        out[label] = dict(slo_met=r.n_slo_met, goodput_rps=r.goodput_rps,
                          throughput_rps=r.throughput_rps,
                          makespan_s=r.makespan_s, per_class=cls,
                          stats={k: r.stats[k] for k in (
                              "direct_writes", "staged_writes", "drains",
                              "prefill_writes", "segments")})
    return out


def phase_loadtest(kernels):
    """``benchmarks/loadtest.py``'s three arms (direct + FIFO, staged +
    FIFO, adaptive + earliest deadline) on the slice's model at full width
    and depth (bf16), chunked at 16, max_seq 96: 48 requests of the bursty
    two-tenant mix. In VIRTUAL time (the segment cost model's clock, model
    time, not the card's): each arm's SLO count and goodput, and the
    goodput ratio. Reported, not held: ``bit_identical`` across the arms
    (K2 reads rows from the ring on one arm and from the pool on another,
    and rounds them differently in bf16). Then the adaptive arm once on the
    wall clock: TTFT / ITL p95 and goodput as the card serves them; its
    launch counts go to the kernels line."""
    cfg, model = _slice_model()
    wl = loadtest_workload(cfg.vocab)
    Engine.from_config(EngineConfig(**LOADTEST_SHAPE), model).serve(
        synthetic_requests(2, [8, 40], cfg.vocab, 2,
                           params=SamplingParams(max_tokens=2)))
    res = {}
    for label, path, sched in LOADTEST_ARMS:
        eng = Engine.from_config(EngineConfig(
            **LOADTEST_SHAPE, path=path, sched=sched), model)
        res[label] = run_loadtest(eng, wl, virtual=True)
        del eng
    ref = res["direct_fifo"].outputs
    bit_identical = all(
        sorted(r.outputs) == sorted(ref)
        and all((r.outputs[k] == ref[k]).all() for k in ref)
        for r in res.values())
    best = max(res["direct_fifo"].goodput_rps, res["staged_fifo"].goodput_rps)
    eng = Engine.from_config(EngineConfig(
        **LOADTEST_SHAPE, path="adaptive", sched="sched/deadline"), model)
    reset_launch_counts()           # counts = 0 just before the main path
    torch.cuda.synchronize()
    wall = run_loadtest(eng, wl, virtual=False)
    torch.cuda.synchronize()
    counts = launch_counts()        # read just after
    for k in kernels:
        if k["name"] in ("staged_scatter", "flash_decode_paged"):
            k["launches_loadtest_wall"] = counts[k["name"]]
    del eng, model
    torch.cuda.empty_cache()
    say("loadtest", config=LOADTEST_SHAPE, requests=LOADTEST_REQUESTS,
        seed=LOADTEST_SEED, n_layers=cfg.n_layers, dtype=cfg.dtype,
        virtual=dict(_loadtest_row(res), goodput_ratio=(
            res["adaptive"].goodput_rps / best if best else 0.0),
            bit_identical=bit_identical,
            clock="virtual (the segment cost model; not device time)"),
        wall_adaptive=dict(_loadtest_row({"adaptive": wall})["adaptive"],
                           clock="wall (host clock, this card)",
                           launches=counts))
    if counts["flash_decode_paged"] <= 0:
        raise AssertionError(f"loadtest: K2 not launched: {counts}")


# ---------------------------------------------------------------------------
# preemption through the host tier
# ---------------------------------------------------------------------------

PREEMPT_LOW, PREEMPT_HIGH = 8, 4     # requests: low priority, the burst
PREEMPT_LENS, PREEMPT_BURST_LEN, PREEMPT_BURST_NEW = [512, 1024], 256, 32


def _preempt_queue(vocab, sch=None):
    """8 low-priority requests (T = 0.8, prompts of 512 / 1024 tokens, 64
    new) and, once they run, a burst of 4 priority-5 greedy requests of 256
    tokens: ``sch`` admits the first wave and runs one segment first."""
    low = synthetic_requests(PREEMPT_LOW, PREEMPT_LENS, vocab, NEW_TOKENS,
                             params=SamplingParams(max_tokens=NEW_TOKENS,
                                                   temperature=0.8))
    burst = synthetic_requests(PREEMPT_HIGH, [PREEMPT_BURST_LEN], vocab,
                               PREEMPT_BURST_NEW, seed=5)
    if sch is not None:
        sch.admit(low)
        sch.run_topped_up_segment(~sch.done_flags())
    for i in range(PREEMPT_HIGH):
        r = burst.at(i)
        low.submit(r.prompt,
                   params=SamplingParams(max_tokens=PREEMPT_BURST_NEW),
                   priority=5)
    return low


def phase_preempt(kernels):
    """``sched/preempt`` on the slice (full width and depth, bf16, paged,
    direct path, blocking, host tier on an ample pool) under a burst of 4
    high-priority requests arriving while 8 low-priority sampled requests
    fill every slot. Held: preemptions happen and each resumes; on every
    resume the slot's restored position, key data and last token equal
    what was saved, and the restored blocks read back bit-equal to the
    host copy; no slot ends parked; the pool's audit; K2 launched.
    Reported: each request's stream against a FIFO run of the same
    requests (a resumed request re-enters another slot and the burst's
    prefills group otherwise, so rounding may part them), and the burst's
    TTFT under both."""
    cfg, model = _slice_model()
    shape = dict(SLICE, path="direct")
    runs, problems = {}, []
    for sched in ("fifo", "sched/preempt"):
        eng = Engine.from_config(EngineConfig(
            **shape, sched=sched, memory=MemoryConfig(host_tier=True)),
            model)
        sch = eng.scheduler
        checks = []
        resume = sch._try_resume

        def checked(slot, req, resume=resume, sch=sch, checks=checks):
            snap = dict(sch._preempted[req.req_id])
            ok = resume(slot, req)
            if ok:
                st = sch.slots
                checks.append(dict(
                    req=req.req_id, pos=int(st.pos[slot]) == snap["pos"],
                    token=int(st.token[slot]) == snap["token"],
                    key=torch.equal(st.key[slot], snap["key"])))
            return ok

        sch._try_resume = checked
        log, bad = [], []
        unwrap = _time_block_moves(log, bad)
        try:
            reset_launch_counts()   # counts = 0 just before the main path
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            queue = _preempt_queue(cfg.vocab, sch)
            out = sch.serve(queue)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            unwrap()
        comps = eng.completions()
        burst = [r for r in out if r >= PREEMPT_LOW]
        runs[sched] = dict(out=out, stats=dict(sch.stats), checks=checks,
                           counts=counts, seconds=secs,
                           burst_ttft_s=[comps[r].ttft_s for r in burst],
                           moves=_moves_summary(log, _block_bytes(sch.cache)))
        if sched == "sched/preempt":
            st = sch.stats
            if not st["preemptions"] or \
                    st["preempt_resumes"] != st["preemptions"]:
                problems.append(f"preemptions / resumes: {st}")
            bad_checks = [c for c in checks if not all(
                c[k] for k in ("pos", "token", "key"))]
            if bad_checks:
                problems.append(f"restored state differs: {bad_checks}")
            if bad:
                problems.append(f"restored blocks differ: {bad}")
            if any(sch._parked) or sch._host_store or sch._preempted:
                problems.append("a slot or request ended parked")
            sch.pool.audit()
            for k in kernels:
                if k["name"] in ("staged_scatter", "flash_decode_paged"):
                    k["launches_preempt"] = counts[k["name"]]
        if counts["flash_decode_paged"] <= 0:
            problems.append(f"{sched}: K2 not launched: {counts}")
        del eng, sch
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    p, f = runs["sched/preempt"], runs["fifo"]
    say("preempt", config=dict(shape, memory=dict(host_tier=True)),
        low_requests=PREEMPT_LOW, burst_requests=PREEMPT_HIGH,
        stats=p["stats"], resumes_checked=len(p["checks"]),
        restored_state_equal=not problems, moves=p["moves"],
        burst_ttft_s=dict(preempt=p["burst_ttft_s"],
                          fifo=f["burst_ttft_s"]),
        seconds=dict(preempt=p["seconds"], fifo=f["seconds"]),
        streams_differ_from_fifo=_stream_diff(p["out"], f["out"]),
        launches=p["counts"])
    if problems:
        raise AssertionError("preempt: " + "; ".join(problems))


def phase_lanes(kernels):
    """The sliding-window model on the lanes layout: 12 requests, prompts of
    512 / 2048 / 4608 tokens (the longest past the 4096 window), 64 new
    tokens each, three timed serves in turn after an uncounted warm-up."""
    cfg = dataclasses.replace(get_config(LANES["arch"]),
                              n_layers=LANES_LAYERS)
    t0 = time.perf_counter()
    eng = Engine.from_config(EngineConfig(**LANES),
                             build_model(cfg, device=DEV).init(0))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    assert eng.layout == "lanes" and eng.attention == "reference", (
        eng.layout, eng.attention)
    t0 = time.perf_counter()
    eng.serve(synthetic_requests(len(LANES_PROMPTS), LANES_PROMPTS, cfg.vocab,
                                 2, params=SamplingParams(max_tokens=2)))
    eng.reset()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    sp = SamplingParams(max_tokens=LANES_NEW)

    def timed_serve():
        queue = synthetic_requests(LANES_REQUESTS, LANES_PROMPTS, cfg.vocab,
                                   LANES_NEW, params=sp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve(queue)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, eng.completions()

    reset_launch_counts()           # counts = 0 just before the main path
    torch.cuda.reset_peak_memory_stats()
    outputs, dt, comps = timed_serve()
    counts = launch_counts()        # read just after
    peak = torch.cuda.max_memory_allocated()
    stats = dict(eng.stats)
    n_toks = sum(len(t) for t in outputs.values())
    seconds, ttfts = [dt], [sorted(c.ttft_s for c in comps.values())]
    for _ in range(ENGINE_RUNS - 1):
        eng.reset()
        again, dt_i, comps_i = timed_serve()
        seconds.append(dt_i)
        ttfts.append(sorted(c.ttft_s for c in comps_i.values()))
        for rid, toks in outputs.items():
            assert (again[rid] == toks).all(), f"request {rid} did not repeat"
    # one prefill call of a group of 4608-token prompts, device time
    prompts = torch.randint(0, cfg.vocab, (LANES_GROUP, max(LANES_PROMPTS)),
                            generator=torch.Generator(device=DEV).manual_seed(1),
                            device=DEV)
    prefill_ms = device_ms(
        lambda: eng.model.prefill(prompts, LANES["max_seq"]),
        "lanes prefill", reps=3)
    say("lanes", config=LANES, n_layers=cfg.n_layers, dtype=cfg.dtype,
        layout=eng.layout, requests=len(outputs), tokens=n_toks,
        seconds=seconds, tok_per_s=[n_toks / x for x in seconds],
        ttft_median_s=[x[len(x) // 2] for x in ttfts],
        ttft_min_max_s=[[x[0], x[-1]] for x in ttfts],
        prefill_device_ms=prefill_ms,
        prefill_shape=f"{LANES_GROUP} x {max(LANES_PROMPTS)} tokens",
        model_build_seconds=t_build, warm_up_seconds=t_warm, stats=stats,
        launches=counts, peak_mem_gb=peak / 1e9)
    assert len(outputs) == LANES_REQUESTS
    for rid, toks in outputs.items():
        assert toks.shape == (LANES_NEW,), (rid, toks.shape)
        assert ((toks >= 0) & (toks < cfg.vocab)).all(), rid
        pc = comps[rid].path_counts
        assert pc["direct"] == LANES_NEW - 1 and pc["staged"] == 0, pc
    assert stats["admitted"] == stats["retired"] == LANES_REQUESTS, stats
    assert stats["staged_writes"] == 0 and stats["drains"] == 0, stats
    take_launches(kernels, counts, ("flash_attention", "flash_decode"))
    engine_profile(eng, cfg, LANES, LANES_PROMPTS)
    del eng
    torch.cuda.empty_cache()


class _fp32_compute:
    """The model's forward in float32 on its own fp32 master weights (the
    compute dtype is read from ``model.cfg``): no copy of the weights."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def __enter__(self):
        self.model.cfg = dataclasses.replace(self.cfg, dtype="float32")

    def __exit__(self, *exc):
        self.model.cfg = self.cfg


def phase_lanes_chunked(kernels):
    """h2o-danube-3-4b at full width on the lanes layout with ``chunked=True,
    chunk_size=512``: prompts of 2048 and 4608 tokens (the second past the
    4096 window) are prefilled chunk by chunk at admission, each chunk one
    flash_attention call a layer with S = 512 queries at the end of up to
    4608 keys. The last-position logits of the chunked prefill are held to
    those of the whole-prompt prefill by ``held_bf16`` against the fp32
    prefill on the same weights; K3 launches per prompt and the chunked
    prefill's device time are reported, and the engine serves both
    requests (16 new tokens)."""
    cfg = get_config(LANES["arch"])
    shape = dict(LANES, chunked=True, chunk_size=LANES_CHUNK)
    eng = Engine.from_config(EngineConfig(**shape))
    sch, model = eng.scheduler, eng.scheduler.model
    assert eng.layout == "lanes"
    gen = torch.Generator(device=DEV).manual_seed(3)
    per_prompt = []
    for plen in LANES_CHUNKED_PROMPTS:
        prompt = torch.randint(0, cfg.vocab, (1, plen), generator=gen,
                               device=DEV)
        reset_launch_counts()
        got, _ = sch._chunk_prefill_host(prompt, LANES["max_seq"])
        k3 = launch_counts()["flash_attention"]
        plain, _ = model.prefill(prompt, LANES["max_seq"])
        with _fp32_compute(model):
            ref32, _ = model.prefill(prompt, LANES["max_seq"])
        torch.cuda.synchronize()
        n_chunks = -(-plen // LANES_CHUNK)
        if k3 != n_chunks * cfg.n_layers:
            raise AssertionError(f"{plen}-token prompt: {k3} flash_attention "
                                 f"launches, want {n_chunks} chunks x "
                                 f"{cfg.n_layers} layers")
        h = held_bf16("chunk_prefill logits", f"prompt {plen}",
                      got[:, None], plain[:, None], ref32[:, None], 1)
        per_prompt.append(dict(
            prompt=plen, chunks=n_chunks, flash_attention_launches=k3,
            err_bf16_vs_f32_ref=h["err"],
            blocking_err_bf16_vs_f32_ref=h["err_plain"],
            err_vs_blocking=h["err_vs_plain"],
            argmax_equal_blocking=bool(got.argmax(-1) == plain.argmax(-1))))
        del got, plain, ref32
    # device time of the longest prompt's prefill, chunked and whole
    per_prompt[-1].update(
        chunked_prefill_device_ms=device_ms(
            lambda: sch._chunk_prefill_host(prompt, LANES["max_seq"]),
            "lanes chunked prefill", reps=2),
        blocking_prefill_device_ms=device_ms(
            lambda: model.prefill(prompt, LANES["max_seq"]),
            "lanes prefill", reps=2))
    torch.cuda.empty_cache()
    sp = SamplingParams(max_tokens=LANES_CHUNKED_NEW)
    reset_launch_counts()           # counts = 0 just before the path
    t0 = time.perf_counter()
    outputs = eng.serve(synthetic_requests(
        len(LANES_CHUNKED_PROMPTS), LANES_CHUNKED_PROMPTS, cfg.vocab,
        LANES_CHUNKED_NEW, params=sp))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()        # read just after
    comps = eng.completions()
    for rid, toks in outputs.items():
        assert toks.shape == (LANES_CHUNKED_NEW,), (rid, toks.shape)
        pc = comps[rid].path_counts
        assert pc["direct"] == LANES_CHUNKED_NEW - 1 and pc["staged"] == 0
    want_k3 = cfg.n_layers * sum(-(-p // LANES_CHUNK)
                                 for p in LANES_CHUNKED_PROMPTS)
    if counts["flash_attention"] != want_k3 or counts["flash_decode"] <= 0:
        raise AssertionError(f"lanes chunked serve: {counts}, want "
                             f"{want_k3} flash_attention launches")
    for k in kernels:
        if k["name"] == "flash_attention":
            k["launches_lanes_chunked"] = counts["flash_attention"]
    say("lanes_chunked", config=shape, n_layers=cfg.n_layers,
        dtype=cfg.dtype, prompts=per_prompt, serve_seconds=dt,
        ttft_s=sorted(c.ttft_s for c in comps.values()),
        stats=dict(eng.stats), launches=counts)
    del eng, sch, model
    torch.cuda.empty_cache()


def engine_profile(eng, cfg, shape, prompt_lens, mixed=False, params=None):
    """Where one segment's time goes: 8 live slots, three segments timed on
    the host clock (the median is used), the next one under the profiler
    (device time by kernel name, and the device's busy share of the timed
    segment). The requests are long enough to stay live throughout.
    ``mixed`` (chunked engines): prompts of ``prompt_lens`` alternate over
    the slots, the short ones flip to decode in the warm segment and the
    long ones still prefill in every measured one, so each is a
    mixed-phase segment. ``params(i, max_tokens)`` gives request ``i``'s
    SamplingParams (default: greedy). A speculative engine's step is a
    round (up to k + 1 tokens a slot); its draft lanes are re-prefilled in
    the warm segment only."""
    eng.reset()
    sch = eng.scheduler
    per_step = sch.spec.k + 1 if sch._spec_enabled else 1
    # at most 7 segments run below
    n_new = 8 * shape["segment_len"] * per_step
    params = params or (lambda i, n: SamplingParams(max_tokens=n))
    sch.admit(_sampled_queue(
        cfg.vocab, params, shape["n_slots"], n_new, prompt_lens,
        media_spec(cfg, 1)[1:] if needs_media(cfg) else None))

    def segment():
        if mixed and not sch._mixed_phase_pending():
            raise AssertionError("the profiled segment is not mixed-phase")
        sch.run_topped_up_segment(~sch.done_flags())

    segment()                       # warm
    torch.cuda.synchronize()
    seg = []
    for _ in range(3):
        t0 = time.perf_counter()
        segment()
        torch.cuda.synchronize()
        seg.append((time.perf_counter() - t0) * 1e3)
    seg_ms = sorted(seg)[1]
    # a retried trace runs one more segment: the requests stay live for it
    rows = trace_rows(segment, f"{shape['arch']} segment")
    steps = shape["segment_len"]
    dev_ms = sum(r[0] for r in rows) / 1e3
    out = dict(arch=shape["arch"], layout=eng.layout,
               mixed=mixed, spec_k=sch.spec.k if per_step > 1 else None,
               slots=shape["n_slots"], steps=steps,
               segment_ms=seg, step_ms=seg_ms / steps,
               device_ms_per_step=dev_ms / steps,
               device_busy_share=dev_ms / seg_ms if dev_ms else None,
               launches_per_step=sum(r[1] for r in rows) / steps,
               device_ops_per_step=device_ops(rows) / steps,
               top=[dict(kernel=k[:64], ms_per_step=us / 1e3 / steps,
                         calls_per_step=n / steps)
                    for us, n, k in rows[:8]])
    say("engine_profile", **out)
    return out


def _top2_gap(model, prompt, tokens, max_seq):
    """The gap between the two largest logits the model gives for the token
    after ``prompt + tokens`` (a whole-prompt prefill on the card)."""
    toks = torch.as_tensor(list(prompt) + list(tokens), device=DEV)[None]
    logits, _ = model.prefill(toks.long(), max_seq)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def _parity_spec(model, run, base, plens, new, max_seq):
    """The spec arm of ``parity``: greedy self-draft spec (k = 3) against
    the direct / fused base streams. At the first divergence (if any), the
    top-2 logit gap of a whole-prompt prefill up to it."""
    out, stats = run("direct", "fused", spec=SpecConfig(enabled=True, k=3))
    diff = _stream_diff(out, base)
    res = dict(identical_streams=not diff, first_divergence=diff,
               stats={k: stats[k] for k in ("spec_proposed", "spec_accepted",
                                            "spec_committed", "spec_rounds")})
    if diff:
        rid = min(diff)
        i = max(diff[rid], 0)
        prompt = synthetic_requests(6, plens, model.cfg.vocab, new).at(rid)
        res["top2_gap_at_first_divergence"] = dict(
            request=rid, token=i, gap=_top2_gap(model, prompt.prompt,
                                                base[rid][:i], max_seq))
    return res


def phase_parity():
    """Smaller depth, full width, fp32: the write paths, the two paged read
    implementations and the two layouts must emit identical greedy token
    streams; so must the sliding-window model on the card and on the CPU,
    and greedy speculative decoding (self-draft, k = 3) on the direct path
    with the fused read: the JAX package's contract that greedy spec is
    greedy non-spec."""
    cfg = dataclasses.replace(get_config(SLICE["arch"]), n_layers=4,
                              dtype="float32")
    model = build_model(cfg, device=DEV).init(1)
    shape = dict(max_seq=512, n_slots=4, page_size=16, segment_len=8,
                 ring_size=4)
    plens, new = [128, 200, 256], 24

    def run(path, attention, layout="auto", spec=None):
        eng = Engine.from_config(EngineConfig(
            path=path, attention=attention, kv_layout=layout, spec=spec,
            **shape), model)
        out = eng.serve(synthetic_requests(6, plens, cfg.vocab, new))
        stats = dict(eng.stats)
        assert eng.layout == ("paged" if layout == "auto" else layout)
        del eng
        torch.cuda.empty_cache()
        return out, stats

    base, base_stats = run("direct", "fused")
    report = {}
    for path, attention, layout in (
            ("staged", "fused", "auto"), ("adaptive", "fused", "auto"),
            ("adaptive", "reference", "auto"), ("staged", "reference", "auto"),
            ("direct", "auto", "lanes")):
        out, stats = run(path, attention, layout)
        for rid in base:
            if not (out[rid] == base[rid]).all():
                raise AssertionError(
                    f"token streams differ: {path}/{attention}/{layout} vs "
                    f"direct/fused, request {rid}: {out[rid]} vs {base[rid]}")
        report[f"{path}/{attention}/{layout}"] = {
            k: stats[k] for k in ("direct_writes", "staged_writes", "drains")}
    spec = _parity_spec(model, run, base, plens, new, shape["max_seq"])
    if not spec["identical_streams"]:
        raise AssertionError(f"greedy spec streams differ from the direct / "
                             f"fused base: {spec}")
    report["spec_k3/direct/fused"] = spec
    del model
    torch.cuda.empty_cache()
    swa = phase_parity_swa()
    say("parity", n_layers=cfg.n_layers, dtype=cfg.dtype, requests=len(base),
        tokens=sum(len(t) for t in base.values()), identical_streams=True,
        runs=report, swa=swa)


def phase_parity_swa():
    """h2o-danube-3-4b at 2 layers and full width, fp32, the window cut to
    128 so that it and the ring's wrap bite at short prompts: the engine on
    the card (flash_attention, flash_decode) and the same weights in a CPU
    engine (their plain versions) give identical greedy streams."""
    cfg = dataclasses.replace(get_config(LANES["arch"]), n_layers=2,
                              dtype="float32", sliding_window=128)
    shape = dict(max_seq=512, n_slots=4, segment_len=8, path="direct")
    plens, new = [100, 200, 300], 24
    gpu_model = build_model(cfg, device=DEV).init(2)
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    outs = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = Engine.from_config(EngineConfig(device=dev, **shape), model)
        assert eng.layout == "lanes"
        outs[dev] = eng.serve(synthetic_requests(6, plens, cfg.vocab, new))
        del eng
    for rid in outs["cpu"]:
        if not (outs["cuda"][rid] == outs["cpu"][rid]).all():
            raise AssertionError(
                f"sliding-window streams differ, card vs CPU, request {rid}: "
                f"{outs['cuda'][rid]} vs {outs['cpu'][rid]}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, n_layers=cfg.n_layers, window=cfg.sliding_window,
                requests=len(outs["cpu"]),
                tokens=sum(len(t) for t in outs["cpu"].values()),
                identical_streams=True)


def phase_parity_chunked():
    """Chunked prefill at smaller depth, full width, fp32. stablelm-1.6b at
    2 layers, for each path and chunk sizes 1 and 3: the chunked engine on
    the card (fused read, K2 at C = chunk size) and on the CPU (plain
    versions) give the same greedy streams, engine stats and per-request
    path counts, and the blocking engine on the card the same streams and
    per-request [direct + staged, prefill] write counts (its stats differ
    by design: fewer segments, and the monitor sees the prompt rows at
    admission, not in the segments). h2o-danube-3-4b at 2 layers, window
    128: a chunked lanes engine with prompts past the window gives the
    blocking engine's streams on the card."""
    cfg = dataclasses.replace(get_config(SLICE["arch"]), n_layers=2,
                              dtype="float32")
    gpu_model = build_model(cfg, device=DEV).init(1)
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    shape = dict(max_seq=128, n_slots=4, page_size=16, segment_len=8,
                 ring_size=4)
    plens, new, n_req = [9, 17, 26], 8, 5

    def run(model, dev, path, chunked, cs=CHUNK):
        eng = Engine.from_config(EngineConfig(
            path=path, device=dev, chunked=chunked, chunk_size=cs, **shape),
            model)
        out = eng.serve(synthetic_requests(n_req, plens, cfg.vocab, new))
        pcs = {r: c.path_counts for r, c in eng.completions().items()}
        return out, dict(eng.stats), pcs

    def same_streams(a, b, what):
        for rid in a:
            if not (a[rid] == b[rid]).all():
                raise AssertionError(f"token streams differ, {what}, request "
                                     f"{rid}: {a[rid]} vs {b[rid]}")

    report = {}
    for path in ("direct", "staged", "adaptive"):
        block = run(gpu_model, "cuda", path, False)
        for cs in (1, 3):
            card = run(gpu_model, "cuda", path, True, cs)
            cpu = run(cpu_model, "cpu", path, True, cs)
            same_streams(card[0], cpu[0], f"{path} C={cs} card vs CPU")
            same_streams(card[0], block[0], f"{path} C={cs} vs blocking")
            if card[1] != cpu[1] or card[2] != cpu[2]:
                raise AssertionError(f"{path} C={cs}: telemetry differs, "
                                     f"card {card[1:]} vs CPU {cpu[1:]}")
            for rid, pc in card[2].items():
                b = block[2][rid]
                if (pc["direct"] + pc["staged"], pc["prefill"]) != (
                        b["direct"] + b["staged"], b["prefill"]):
                    raise AssertionError(f"{path} C={cs} request {rid}: "
                                         f"{pc} vs blocking {b}")
            report[f"{path}/C={cs}"] = {
                k: card[1][k] for k in ("direct_writes", "staged_writes",
                                        "drains", "prefill_writes",
                                        "segments")}
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    lcfg = dataclasses.replace(get_config(LANES["arch"]), n_layers=2,
                               dtype="float32", sliding_window=128)
    model = build_model(lcfg, device=DEV).init(2)
    lshape = dict(max_seq=512, n_slots=4, segment_len=8, path="direct")
    outs = {}
    for chunked in (False, True):
        eng = Engine.from_config(EngineConfig(chunked=chunked, chunk_size=64,
                                              **lshape), model)
        assert eng.layout == "lanes"
        outs[chunked] = eng.serve(synthetic_requests(
            6, [100, 200, 300], lcfg.vocab, 24))
        del eng
    same_streams(outs[True], outs[False], "lanes chunked vs blocking")
    del model
    torch.cuda.empty_cache()
    say("parity_chunked", n_layers=cfg.n_layers, dtype=cfg.dtype,
        chunk_sizes=[1, 3], requests=n_req, identical_streams=True,
        identical_telemetry_card_cpu=True, runs=report,
        lanes=dict(arch=lcfg.name, n_layers=lcfg.n_layers,
                   window=lcfg.sliding_window, chunk_size=64,
                   prompts=[100, 200, 300], identical_streams=True))


# ---------------------------------------------------------------------------
# the flat write engine
# ---------------------------------------------------------------------------


def write_stream(shape, gen, device):
    """The section 4 write stream, made on ``device`` from ``gen``: regions
    Zipf(0.5) over 2^log2_regions, offsets 64 x U{0..regions_elems/64 - 1}
    elements, sizes U{4..64} fp32 elements (16-256 B), payload [n, width],
    each write carrying its region's registration stag (registration i
    covers an equal share of the regions under stag 11 + i), and with
    ``bad_every`` > 0 about one write in that many carrying stag 99. Two
    writes of a batch either share (region, offset) or do not overlap."""
    n_regions = 1 << shape["log2_regions"]
    per_reg = n_regions // shape["registrations"]
    n, w = shape["batch"], shape["width"]
    stream = []
    for _ in range(shape["batches"]):
        region = zipf_regions(n, n_regions, 0.5, generator=gen, device=device)
        offset = 64 * torch.randint(0, shape["region_elems"] // 64, (n,),
                                    generator=gen, device=device)
        size = torch.randint(4, 65, (n,), generator=gen, device=device)
        stag = 11 + region // per_reg
        if shape["bad_every"]:
            bad = torch.randint(0, shape["bad_every"], (n,), generator=gen,
                                device=device) == 0
            stag = torch.where(bad, 99, stag)
        payload = torch.randn((n, w), generator=gen, device=device)
        stream.append((make_write_batch(region, offset, size), payload, stag))
    return stream


def check_stream_seeded(shape, stream, seed):
    """The stream is its seed's own: made again from the seed it is the
    same, and the card draws the regions the CPU draws from the same
    uniforms."""
    again = write_stream(shape, torch.Generator(device=DEV).manual_seed(seed),
                         DEV)
    for (b1, p1, s1), (b2, p2, s2) in zip(stream, again):
        if not all(torch.equal(x, y)
                   for x, y in zip((*b1, p1, s1), (*b2, p2, s2))):
            raise AssertionError("the write stream differs when made again "
                                 "from its seed")
    n_regions = 1 << shape["log2_regions"]
    u = torch.rand((1 << 20,), device=DEV,
                   generator=torch.Generator(device=DEV).manual_seed(seed))
    if not torch.equal(zipf_regions(0, n_regions, u=u).cpu(),
                       zipf_regions(0, n_regions, u=u.cpu())):
        raise AssertionError("zipf_regions: the card and the CPU draw other "
                             "regions from the same uniforms")


def write_table(shape, device):
    n_regions = 1 << shape["log2_regions"]
    per_reg = n_regions // shape["registrations"]
    table = make_umtt(shape["umtt"], device=device)
    for i in range(shape["registrations"]):
        table = register(table, i * per_reg, per_reg, stag=11 + i)
    return table


def write_engines(shape):
    """The four decision planes over one write engine shape. The sketch
    engines share one CMSMonitor: the frequency policy's also sits on the
    module (the module updates, the policy queries), the hysteresis
    policy owns its own."""
    depth, log2w = shape["cms"]
    cms = CMSMonitor(depth=depth, log2_width=log2w,
                     decay_every=shape["decay_every"])
    planes = {
        "direct": DecisionModule(policy=AlwaysOffload()),
        "staged": DecisionModule(policy=AlwaysUnload()),
        "adaptive-cms": DecisionModule(policy=FrequencyPolicy(
            monitor=cms, threshold=shape["threshold"]), monitor=cms),
        "hysteresis-cms": DecisionModule(policy=HysteresisPolicy(
            monitor=cms, lo=shape["lo"], hi=shape["hi"],
            n_regions=1 << shape["log2_regions"])),
    }
    return {name: RemoteWriteEngine(decision=d, ring_capacity=shape["ring"],
                                    width=shape["width"])
            for name, d in planes.items()}


def write_pass(eng, table, mem, stream):
    """One pass of the stream through a fresh engine state, then a flush."""
    st = eng.init_state(table, device=mem.device)
    for batch, payload, stag in stream:
        st, mem = eng.write(st, mem, batch, payload, stag)
    return eng.flush(st, mem)[0]


def _telemetry(st):
    return dict(n_offloaded=int(st.n_offloaded), n_unloaded=int(st.n_unloaded),
                n_rejected=int(st.n_rejected))


def _last_of_runs(keys):
    """bool mask of the last element of each run of equal sorted keys."""
    last = torch.ones_like(keys, dtype=torch.bool)
    last[:-1] = keys[1:] != keys[:-1]
    return last


def oracle_mem(shape, stream, device):
    """Sequential last-write-wins, written independently of the engine: a
    write is dropped when a later write of its batch has the same (region,
    offset); of the others, each element holds the last write that covers
    it. Every stag of this stream is valid."""
    n_regions, re = 1 << shape["log2_regions"], shape["region_elems"]
    n = shape["batch"]
    total = n * len(stream)
    key = torch.cat([b.region * re + b.offset for b, _, _ in stream])
    size = torch.cat([b.size for b, _, _ in stream])
    payload = torch.cat([p for _, p, _ in stream])
    order = torch.arange(total, device=device)
    # within a batch, the last write per key survives
    comb = ((order // n) * (n_regions * re) + key) * total + order
    comb, _ = torch.sort(comb)
    keep = torch.zeros(total, dtype=torch.bool, device=device)
    keep[(comb % total)[_last_of_runs(comb // total)]] = True
    # element by element, the last surviving write wins
    w = shape["width"]
    lane = torch.arange(w, device=device)
    elem = keep[:, None] & (lane[None] < size[:, None])
    flat = (key[:, None] + lane[None])[elem]
    src = (order[:, None] * w + lane[None])[elem]
    comb2, perm = torch.sort(flat * (total * w) + src)
    win = _last_of_runs(comb2 // (total * w))
    mem = torch.zeros((n_regions, re), dtype=torch.float32, device=device)
    mem.view(-1)[flat[perm][win]] = payload.reshape(-1)[src[perm][win]]
    return mem


def phase_write_engine(kernels):
    """The paper's flat write engine at its section 4 size on the card."""
    shape = WRITE
    gen = torch.Generator(device=DEV).manual_seed(13)
    n_regions = 1 << shape["log2_regions"]
    stream = write_stream(shape, gen, DEV)
    check_stream_seeded(shape, stream, 13)
    table = write_table(shape, DEV)
    n_writes = shape["batches"] * shape["batch"]
    sketch_kernels = ("cms_update", "cms_query", "cms_update_query")
    report, ref_mem = {}, None
    totals = dict.fromkeys(sketch_kernels, 0)
    for name, eng in write_engines(shape).items():
        torch.cuda.reset_peak_memory_stats()
        mem = torch.zeros((n_regions, shape["region_elems"]),
                          dtype=torch.float32, device=DEV)
        write_pass(eng, table, mem, stream)      # warm-up, not counted
        torch.cuda.synchronize()
        seconds = []
        for i in range(3):
            if i == 0:
                reset_launch_counts()   # counts = 0 just before the main path
            t0 = time.perf_counter()
            st = write_pass(eng, table, mem, stream)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                counts = launch_counts()        # read just after
                tel = _telemetry(st)
        ev = trace_rows(lambda: write_pass(eng, table, mem, stream),
                        f"write_engine {name}")
        dev_ms = sum(e[0] for e in ev) / 1e3
        host_ms = sorted(seconds)[1] * 1e3 / shape["batches"]
        per_batch = {k: counts[k] / shape["batches"]
                     for k in sketch_kernels}
        report[name] = dict(
            writes_per_s=[n_writes / x for x in seconds],
            host_ms_per_batch=host_ms,
            device_ms_per_batch=dev_ms / shape["batches"],
            device_busy_share=dev_ms / shape["batches"] / host_ms,
            kernel_launches_per_batch=sum(e[1] for e in ev)
            / shape["batches"],
            device_ops_per_batch=device_ops(ev) / shape["batches"],
            top=[dict(kernel=k[:64], ms_per_batch=us / 1e3 / shape["batches"],
                      calls_per_batch=c / shape["batches"])
                 for us, c, k in ev[:8]],
            cms_launches_per_batch=per_batch, **tel,
            unload_share=tel["n_unloaded"] / n_writes,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        # the sketch planes' monitor step is one fused launch a batch; K5
        # and K6 alone are left to heat() and the read-only decide()
        sketch = name.endswith("-cms")
        want = dict.fromkeys(sketch_kernels, 0.0)
        want["cms_update_query"] = 1.0 if sketch else 0.0
        if per_batch != want:
            raise AssertionError(f"{name}: sketch launches per batch "
                                 f"{per_batch}, expected {want}")
        if sketch:
            for k in totals:
                totals[k] += counts[k]
            if not 0.0 < report[name]["unload_share"] < 1.0:
                raise AssertionError(f"{name}: unload share "
                                     f"{report[name]['unload_share']}")
        if tel["n_rejected"] != 0:
            raise AssertionError(f"{name}: {tel['n_rejected']} rejected")
        if ref_mem is None:
            ref_mem = mem
            oracle = oracle_mem(shape, stream, DEV)
            if not torch.equal(mem, oracle):
                raise AssertionError("direct engine's memory differs from "
                                     "the last-write-wins oracle")
            del oracle
        else:
            if not torch.equal(mem, ref_mem):
                raise AssertionError(f"{name}: memory differs from the "
                                     f"direct engine's")
            del mem
        torch.cuda.empty_cache()
    del ref_mem
    torch.cuda.empty_cache()
    say("write_engine", shape=shape, writes=n_writes, engines=report,
        identical_memories=True, matches_oracle=True, stream_seeded=True,
        memory_gb=n_regions * shape["region_elems"] * 4 / 2 ** 30)
    for k in kernels:
        if k["name"] in totals:
            k["launches"] = totals[k["name"]]


def phase_write_parity():
    """The four engines on the card and on the CPU, small, bad stags in the
    stream: memory, telemetry and ring state identical."""
    shape = WRITE_PARITY
    gen = torch.Generator(device="cpu").manual_seed(14)
    n_regions = 1 << shape["log2_regions"]
    cpu_stream = write_stream(shape, gen, "cpu")
    dev_stream = [(type(b)(*(t.to(DEV) for t in b)), p.to(DEV), s.to(DEV))
                  for b, p, s in cpu_stream]
    report = {}
    for name, eng in write_engines(shape).items():
        out = {}
        for dev, stream in ((DEV, dev_stream), ("cpu", cpu_stream)):
            mem = torch.zeros((n_regions, shape["region_elems"]),
                              dtype=torch.float32, device=dev)
            st = write_pass(eng, write_table(shape, dev), mem, stream)
            out[str(dev)] = (mem.cpu(), _telemetry(st), st.ring.live.cpu(),
                             int(st.ring.head))
        (m_c, t_c, l_c, h_c), (m_p, t_p, l_p, h_p) = out[str(DEV)], out["cpu"]
        if not torch.equal(m_c, m_p):
            raise AssertionError(f"{name}: memory differs, card vs CPU")
        if t_c != t_p or h_c != h_p or not torch.equal(l_c, l_p):
            raise AssertionError(f"{name}: telemetry or ring differs, card "
                                 f"{t_c} head {h_c} vs CPU {t_p} head {h_p}")
        if t_c["n_rejected"] == 0 and name != "direct":
            raise AssertionError(f"{name}: no bad stag was rejected")
        report[name] = t_c
    say("write_parity", shape=shape, engines=report, identical=True)


# ---------------------------------------------------------------------------
# the paper's Fig. 3 on the card
# ---------------------------------------------------------------------------


def _fig3_arm(arm, r):
    """(policy, monitor) of one Fig. 3 line at ``r`` regions, state on the
    card."""
    if arm == "offload":
        return AlwaysOffload(), None
    if arm == "unload":
        return AlwaysUnload(), None
    if arm == "hint":
        hot = torch.zeros((r,), dtype=torch.bool, device=DEV)
        hot[:min(PAPER_WORKLOAD.adaptive_top_k, r)] = True
        return HintPolicy(hot_regions=hot), None
    mon = (ExactMonitor(n_regions=r) if arm == "frequency"
           else CMSMonitor(*FIG3_CMS))
    return FrequencyPolicy(monitor=mon, threshold=FIG3_THRESHOLD), mon


def phase_fig3(kernels):
    """The paper's Fig. 3 on the card: ``sweep_point`` (seed 0) at each of
    ``PAPER_WORKLOAD.region_counts`` for offload, unload, hint (top-4096)
    and frequency over an exact monitor, 200 000 writes, warm-up 20 000;
    frequency over a count-min sketch at 2^20 (its monitor step: one K5
    and one K6 launch); then the 2^20 headline at the paper's 5 000 000
    writes (warm-up 500 000). Launch counts are set to 0 just before the
    sweep and read just after it: one lru_scan a point, each of its five
    kernels launched once a point, K5 and K6 > 0.
    Held: the ``FIG3_CLAIMS`` bounds of ``tests/test_fig3_regression.py``
    (the fixed paths on the paper's calibration; adaptive no slower than
    the better fixed path + 0.15 us at 1 and 2^20 regions) and the
    improvement at 2^20 within 0.05 of 31 %, at 200 000 and at 5 000 000
    writes; the 2^20 offload point equal, within 1e-5 us, to the same
    point run on the CPU (the plain scan). The microseconds are the
    paper's model constants, not device times."""
    pw = PAPER_WORKLOAD
    n, warm = pw.sim_writes, pw.sim_warmup
    key = prng.key(0)
    sweep_point(key, 16, 4096, 64, FrequencyPolicy(
        monitor=CMSMonitor(*FIG3_CMS), threshold=1), CMSMonitor(*FIG3_CMS))
    torch.cuda.synchronize()
    arms = ("offload", "unload", "hint", "frequency")
    table = {arm: {} for arm in arms}
    point_ms = {arm: {} for arm in arms}
    reset_launch_counts()           # counts = 0 just before the sweep
    t_sweep = time.perf_counter()
    for r in pw.region_counts:
        for arm in arms:
            pol, mon = _fig3_arm(arm, r)
            t0 = time.perf_counter()
            table[arm][r], _ = sweep_point(key, r, n, warm, pol, mon)
            point_ms[arm][r] = (time.perf_counter() - t0) * 1e3
    pol, mon = _fig3_arm("frequency_cms", 1 << 20)
    cms_avg, cms_res = sweep_point(key, 1 << 20, n, warm, pol, mon)
    head = {}
    for arm in ("offload", "unload"):
        pol, _ = _fig3_arm(arm, 1 << 20)
        head[arm], _ = sweep_point(key, 1 << 20, pw.n_writes,
                                   pw.n_writes // 10, pol)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t_sweep
    counts = launch_counts()        # read just after
    by_kernel = kernel_launch_counts()
    n_points = len(pw.region_counts) * len(arms) + 1 + len(head)
    # device time of one sweep point: 2^20 offload and the 1-region chain,
    # at 200 000 writes, and the headline's 5 000 000
    dev = {}
    for tag, r, nw in (("2e20", 1 << 20, n), ("1", 1, n),
                       ("2e20_5M", 1 << 20, pw.n_writes)):
        dev[tag] = device_ms(
            lambda: sweep_point(key, r, nw, nw // 10, AlwaysOffload()),
            f"fig3 point {tag}", reps=3)
    cpu_off, _ = sweep_point(key, 1 << 20, n, warm, AlwaysOffload(),
                             device="cpu")
    lo, hi = 1, 1 << 20
    imp = 1.0 - table["unload"][hi] / table["offload"][hi]
    imp_5m = 1.0 - head["unload"] / head["offload"]
    say("fig3_table", unit="us (the paper's model constants, not device "
        "times)", writes=n, warmup=warm, seed=0,
        regions=list(pw.region_counts),
        **{arm: [table[arm][r] for r in pw.region_counts] for arm in arms})
    say("fig3", frequency_cms_2e20=cms_avg,
        frequency_cms_unload_share=int(cms_res.n_unloaded) / n,
        headline_5M=dict(head, improvement=imp_5m, warmup=pw.n_writes // 10),
        improvement_2e20=imp, claims=FIG3_CLAIMS,
        offload_2e20_cpu=cpu_off, launches=counts,
        lru_scan_launches_by_kernel=by_kernel, points=n_points,
        sweep_seconds=sweep_s, point_host_ms=point_ms,
        point_device_ms=dev)
    problems = []

    def near(what, got, want, tol):
        if not abs(got - want) < tol:
            problems.append(f"{what}: {got} not within {tol} of {want}")

    near("offload at 1 region", table["offload"][lo],
         FIG3_CLAIMS["offload_rtt_1_region"], 0.1)
    near("offload at 2^20", table["offload"][hi],
         FIG3_CLAIMS["offload_rtt_2e20_regions"], 0.3)
    near("unload at 1 region", table["unload"][lo],
         FIG3_CLAIMS["unload_rtt_flat"], 0.2)
    near("unload at 2^20", table["unload"][hi],
         FIG3_CLAIMS["unload_rtt_2e20_regions"], 0.2)
    near("hint at 1 region", table["hint"][lo],
         FIG3_CLAIMS["offload_rtt_1_region"], 0.15)
    near("hint at 2^20", table["hint"][hi],
         FIG3_CLAIMS["unload_rtt_2e20_regions"], 0.25)
    near("improvement at 2^20", imp, FIG3_CLAIMS["improvement_at_2e20"], 0.05)
    near("improvement at 2^20, 5M writes", imp_5m,
         FIG3_CLAIMS["improvement_at_2e20"], 0.05)
    near("2^20 offload, card against CPU", table["offload"][hi], cpu_off,
         1e-5)
    for arm in ("hint", "frequency"):
        for r in (lo, hi):
            best = min(table["offload"][r], table["unload"][r])
            if not table[arm][r] <= best + 0.15:
                problems.append(f"{arm} at {r} regions: {table[arm][r]} > "
                                f"best fixed {best} + 0.15")
    if counts["lru_scan"] != n_points:
        problems.append(f"lru_scan launched {counts['lru_scan']} times for "
                        f"{n_points} points")
    if any(by_kernel[name] != n_points for name in LRU_KERNELS):
        problems.append(f"lru_scan's kernels launched {by_kernel} times for "
                        f"{n_points} points")
    for k in ("cms_update", "cms_query"):
        if counts[k] <= 0:
            problems.append(f"{k} never launched by the sketch arm: {counts}")
    if problems:
        raise AssertionError("fig3: " + "; ".join(problems))
    for k in kernels:
        if k["name"] == "lru_scan":
            k["launches"] = counts["lru_scan"]
            k["launches_by_kernel"] = by_kernel
        elif k["name"] in ("cms_update", "cms_query"):
            k["launches_write_engine"] = k["launches"]
            k["launches"] = counts[k["name"]]


# ---------------------------------------------------------------------------
# the MoE family at full width on the lanes layout
# ---------------------------------------------------------------------------


def _count_model_calls(model):
    """Count the calls of the model's three lanes entry points, each on its
    own (an MoE model's every call runs ``moe_ffn_layer``, so one K1 drain,
    in every layer), and of an encoder-decoder's ``encode`` (called by
    ``prefill`` and by a ``chunk_prefill`` given media). Returns the counter
    and the function that unwraps them."""
    calls = {name: 0 for name in ("prefill", "chunk_prefill", "decode_step",
                                  "encode") if hasattr(model, name)}
    for name in calls:
        def counted(*a, _f=getattr(model, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        setattr(model, name, counted)

    def unwrap():
        for name in calls:
            delattr(model, name)
    return calls, unwrap


def phase_engine_moe(kernels):
    """granite-moe-3b-a800m at full width (d_model 1536, 40 experts top-8,
    bf16, random weights from seed 0), cut to ``MOE_LAYERS`` of its 32
    layers, through
    ``Engine.from_config`` on the lanes layout, direct KV writes, staged
    expert dispatch (``MoELM``'s default): 16 requests of 128-512 tokens,
    32 new tokens each, 8 slots, blocking and chunked at 128. Launch counts
    set to 0 just before each first serve and read just after it; the
    model's calls counted alongside. Held: K1 launched once a layer of
    every MoE call (layers x calls), K3 and K4 launched; every request's 32
    tokens in the vocabulary, 31 direct writes, none staged; admitted =
    retired = 16; a second serve identical. Reported: blocking against
    chunked (a chunk routes its own token count, so capacity drops can
    differ by construction), tok/s, TTFT, peak memory, a decode segment's
    profile."""
    cfg = dataclasses.replace(get_config(MOE["arch"]), n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV).init(0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if model.dispatch_mode != "staged":
        raise AssertionError(f"MoE dispatch {model.dispatch_mode}")
    sp = SamplingParams(max_tokens=MOE_NEW)

    def queue():
        return synthetic_requests(MOE_REQUESTS, MOE_PROMPTS, cfg.vocab,
                                  MOE_NEW, params=sp)

    runs, problems, profile = {}, [], None
    for name, chunked in (("blocking", False), ("chunked", True)):
        shape = dict(MOE, chunked=chunked, chunk_size=MOE_CHUNK)
        eng = Engine.from_config(EngineConfig(**shape), model)
        if eng.layout != "lanes":
            raise AssertionError(f"MoE served on {eng.layout}")
        eng.serve(synthetic_requests(len(MOE_PROMPTS), MOE_PROMPTS,
                                     cfg.vocab, 2,
                                     params=SamplingParams(max_tokens=2)))
        eng.reset()
        calls, unwrap = _count_model_calls(model)
        reset_launch_counts()       # counts = 0 just before the main path
        torch.cuda.reset_peak_memory_stats()
        try:
            out, comps, secs = _serve_once(eng, queue())
            counts = launch_counts()    # read just after
        finally:
            unwrap()
        peak = torch.cuda.max_memory_allocated()
        stats = dict(eng.stats)
        eng.reset()
        again, _, secs2 = _serve_once(eng, queue())
        n_tok = sum(len(t) for t in out.values())
        if _stream_diff(again, out):
            problems.append(f"{name}: a second serve differs "
                            f"{_stream_diff(again, out)}")
        if len(out) != MOE_REQUESTS:
            problems.append(f"{name}: {len(out)} requests served")
        for rid, toks in out.items():
            pc = comps[rid].path_counts
            if toks.shape != (MOE_NEW,) or not (
                    (toks >= 0) & (toks < cfg.vocab)).all():
                problems.append(f"{name}: request {rid} tokens {toks}")
            if pc["direct"] != MOE_NEW - 1 or pc["staged"] != 0:
                problems.append(f"{name}: request {rid} path counts {pc}")
        if not stats["admitted"] == stats["retired"] == MOE_REQUESTS:
            problems.append(f"{name}: stats {stats}")
        n_calls = sum(calls.values())
        if counts["staged_scatter"] != cfg.n_layers * n_calls:
            problems.append(f"{name}: staged_scatter launched "
                            f"{counts['staged_scatter']} times for "
                            f"{n_calls} MoE calls x {cfg.n_layers} layers")
        for k in ("flash_attention", "flash_decode"):
            if counts[k] <= 0:
                problems.append(f"{name}: {k} never launched: {counts}")
        runs[name] = dict(out=out, report=dict(
            tok_per_s=[n_tok / secs, n_tok / secs2], seconds=[secs, secs2],
            tokens=n_tok, ttft=_ttft(comps), model_calls=n_calls,
            launches=counts, stats=stats, peak_mem_gb=peak / 1e9))
        for k in kernels:
            if k["name"] in ("staged_scatter", "flash_attention",
                             "flash_decode"):
                k["moe_shape"][f"launches_{name}"] = counts[k["name"]]
        if not chunked:
            profile = engine_profile(eng, cfg, MOE, MOE_PROMPTS)
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    say("engine_moe", config=MOE, n_layers=cfg.n_layers, dtype=cfg.dtype,
        n_experts=cfg.n_experts, top_k=cfg.top_k, chunk_size=MOE_CHUNK,
        params_billions=cfg.param_count() / 1e9,
        model_build_seconds=t_build, requests=MOE_REQUESTS,
        prompt_lens=MOE_PROMPTS, new_tokens=MOE_NEW,
        blocking_vs_chunked=_stream_diff(runs["chunked"]["out"],
                                         runs["blocking"]["out"]),
        profile=profile, **{k: r["report"] for k, r in runs.items()})
    if problems:
        raise AssertionError("engine_moe: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# the SSM and hybrid families at full width on the lanes layout
# ---------------------------------------------------------------------------


def _ssd_step_ms(model, slots):
    """Device ms a decode step spends in the SSD recurrence
    (``ssd_decode_step``, the state update and read-out) and in the whole
    mamba blocks (``mamba_decode_step``), each timed alone at the step's
    shapes (``slots`` rows, bf16, the state in bf16) and multiplied by the
    layer count."""
    cfg = model.cfg
    gen = timed_gen(140)
    bf = torch.bfloat16
    h, pd, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.ssm_state
    ch = cfg.d_inner + 2 * g * n

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(bf)
    p = model.blocks[0].params(bf)
    x, b_t, c_t = rn(slots, h, pd), rn(slots, g, n), rn(slots, g, n)
    dt = F.softplus(torch.randn((slots, h), generator=gen, device=DEV) - 2)
    a = -torch.exp(p["A_log"])
    state = rn(slots, h, pd, n, scale=0.1)
    u, tail = rn(slots, cfg.d_model), rn(slots, cfg.ssm_conv - 1, ch)
    ssd = device_ms(lambda: MAMBA.ssd_decode_step(x, dt, a, b_t, c_t, state),
                    f"{cfg.name} ssd_decode_step")
    block = device_ms(lambda: MAMBA.mamba_decode_step(cfg, p, u, state, tail),
                      f"{cfg.name} mamba_decode_step")
    return dict(ssd_ms_per_step=ssd * cfg.n_layers,
                mamba_blocks_ms_per_step=block * cfg.n_layers)


def _lanes_family_runs(kernels, model, shape, traffic, want, tag,
                       profile_fn):
    """One family at full width through ``Engine.from_config`` on the lanes
    layout, direct writes: ``traffic`` (``requests`` requests of
    ``prompts`` tokens, ``new`` new tokens each, each with its own frames
    where the model takes media), blocking and chunked at ``chunk``. Launch
    counts set to 0 just before each first serve and read just after it,
    the model's calls counted alongside by entry point. Held: every
    request's tokens in the vocabulary, ``new - 1`` direct writes and none
    staged; admitted = retired = requests; a second serve identical; each
    kernel launched ``want(calls)[kernel]`` times (0 where absent).
    ``kernels`` rows of ``want``'s kernels get each arm's launches under
    ``tag``; ``profile_fn(eng)`` profiles the blocking engine. Returns
    (runs, problems, profile)."""
    cfg = model.cfg
    prompts, new = traffic["prompts"], traffic["new"]
    media_shape = media_spec(cfg, 1)[1:] if needs_media(cfg) else None
    # the workload's requests, media included, made once (hashing the VLM's
    # 16 x 1601 x 8192 media takes the host seconds); each serve submits
    # them anew (fresh arrival stamps) with its own budget: the values
    # ``synthetic_requests`` gives for that budget
    made = synthetic_requests(traffic["requests"], prompts, cfg.vocab, new,
                              media_shape=media_shape)
    template = [made.pop() for _ in range(len(made))]

    def queue(n, max_new):
        q = RequestQueue()
        for r in template[:n]:
            q.submit(r.prompt, media=r.media,
                     params=SamplingParams(max_tokens=max_new))
        return q

    runs, problems, profile = {}, [], None
    for name, chunked in (("blocking", False), ("chunked", True)):
        eng = Engine.from_config(EngineConfig(
            chunked=chunked, chunk_size=traffic["chunk"], **shape), model)
        if eng.layout != "lanes":
            raise AssertionError(f"{cfg.name} served on {eng.layout}")
        eng.serve(queue(len(prompts), 2))
        eng.reset()
        calls, unwrap = _count_model_calls(model)
        reset_launch_counts()       # counts = 0 just before the main path
        torch.cuda.reset_peak_memory_stats()
        try:
            out, comps, secs = _serve_once(eng, queue(traffic["requests"],
                                                      new))
            counts = launch_counts()    # read just after
        finally:
            unwrap()
        peak = torch.cuda.max_memory_allocated()
        stats = dict(eng.stats)
        eng.reset()
        again, _, secs2 = _serve_once(eng, queue(traffic["requests"], new))
        n_tok = sum(len(t) for t in out.values())
        if _stream_diff(again, out):
            problems.append(f"{name}: a second serve differs "
                            f"{_stream_diff(again, out)}")
        if len(out) != traffic["requests"]:
            problems.append(f"{name}: {len(out)} requests served")
        for rid, toks in out.items():
            pc = comps[rid].path_counts
            if toks.shape != (new,) or not (
                    (toks >= 0) & (toks < cfg.vocab)).all():
                problems.append(f"{name}: request {rid} tokens {toks}")
            if pc["direct"] != new - 1 or pc["staged"] != 0:
                problems.append(f"{name}: request {rid} path counts {pc}")
        if not stats["admitted"] == stats["retired"] == traffic["requests"]:
            problems.append(f"{name}: stats {stats}")
        wanted = want(calls)
        for k, n in counts.items():
            if n != wanted.get(k, 0):
                problems.append(f"{name}: {k} launched {n} times, want "
                                f"{wanted.get(k, 0)} (calls {calls})")
        runs[name] = dict(out=out, report=dict(
            tok_per_s=[n_tok / secs, n_tok / secs2], seconds=[secs, secs2],
            tokens=n_tok, ttft=_ttft(comps), model_calls=calls,
            launches=counts, stats=stats, peak_mem_gb=peak / 1e9))
        for k in kernels:
            if tag and wanted.get(k["name"]):
                k[tag][f"launches_{name}"] = counts[k["name"]]
        if not chunked:
            profile = profile_fn(eng)
        del eng
        torch.cuda.empty_cache()
    return runs, problems, profile


def _recurrent_engine_phase(kernels, shape, requests, what, n_layers=None):
    """One family at full width (bf16, random weights from seed 0; cut to
    its first ``n_layers`` layers if given), ``requests`` requests of ``SSM_PROMPTS`` tokens, ``SSM_NEW`` new tokens
    each, 8 slots, blocking and chunked at ``SSM_CHUNK``
    (``_lanes_family_runs``): flash_attention launched once an application
    of the shared block in every prefill and chunk call, flash_decode once
    an application in every decode call (none of either without a shared
    block), no other kernel. Reported: blocking against chunked, tok/s,
    TTFT, peak memory, a decode segment's profile with the SSD's device-ms
    share."""
    cfg = get_config(shape["arch"])
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    apps = cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every \
        else 0
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV).init(0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0

    def want(calls):
        return dict(flash_attention=apps * (calls["prefill"]
                                            + calls["chunk_prefill"]),
                    flash_decode=apps * calls["decode_step"])

    def profile_fn(eng):
        profile = engine_profile(eng, cfg, shape, SSM_PROMPTS)
        profile.update(_ssd_step_ms(model, shape["n_slots"]))
        dev_ms = profile["device_ms_per_step"]
        for part in ("ssd", "mamba_blocks"):
            profile[f"{part}_share"] = (
                profile[f"{part}_ms_per_step"] / dev_ms if dev_ms else None)
        return profile

    runs, problems, profile = _lanes_family_runs(
        kernels, model, shape, dict(requests=requests, prompts=SSM_PROMPTS,
                                    new=SSM_NEW, chunk=SSM_CHUNK),
        want, "zamba_shape" if apps else None, profile_fn)
    del model
    torch.cuda.empty_cache()
    say(what, config=shape, n_layers=cfg.n_layers, dtype=cfg.dtype,
        d_model=cfg.d_model, shared_block_applications=apps,
        chunk_size=SSM_CHUNK, params_billions=cfg.param_count() / 1e9,
        model_build_seconds=t_build, requests=requests,
        prompt_lens=SSM_PROMPTS, new_tokens=SSM_NEW,
        blocking_vs_chunked=_stream_diff(runs["chunked"]["out"],
                                         runs["blocking"]["out"]),
        profile=profile, **{k: r["report"] for k, r in runs.items()})
    if problems:
        raise AssertionError(f"{what}: " + "; ".join(problems))


def phase_engine_ssm(kernels):
    """mamba2-130m at full width (24 layers, d_model 768, 24 SSD heads of
    64, state 128): no attention kernel may run (``_recurrent_engine_phase``)."""
    _recurrent_engine_phase(kernels, SSM, SSM_REQUESTS, "engine_ssm")


def phase_engine_hybrid(kernels):
    """zamba2-2.7b at full width (d_model 2560, 32 heads of 80), cut to
    ``HYBRID_LAYERS`` of its 54 layers (the shared block twice): K3
    launched 2 x the prefill and chunk calls, K4 2 x the decode calls
    (``_recurrent_engine_phase``)."""
    _recurrent_engine_phase(kernels, HYBRID, SSM_REQUESTS, "engine_hybrid",
                            n_layers=HYBRID_LAYERS)


def phase_parity_ssm():
    """Full width, fp32, cut depth: mamba2-130m at 4 layers and zamba2-2.7b
    at 6 (one application of the shared block). The engine on the card
    (K3 and K4 for zamba) and the same weights in a CPU engine (their plain
    versions) must give identical greedy streams, blocking and chunked
    (the chunked arm's K3 calls: chunks of 64 queries at the end of the
    keys before them); blocking against chunked on the card is reported
    (matrix products of another row count round otherwise). Then greedy speculative decoding on the card, the reduced
    stablelm-1.6b target (vocabulary 256) with the reduced mamba2-130m
    draft (k = 3, snapshot rollback), must equal the non-speculative
    engine."""
    shape = dict(max_seq=512, n_slots=4, segment_len=8, path="direct")
    plens, new, chunk = [100, 200, 300], 16, 64
    report = {}
    for arch, layers, seed in (("mamba2-130m", 4, 3), ("zamba2-2.7b", 6, 4)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        gpu_model = build_model(cfg, device=DEV).init(seed)
        cpu_model = build_model(cfg, device="cpu")
        cpu_model.load_state_dict(gpu_model.state_dict())
        outs = {}
        for tag, dev, model, chunked in (
                ("cuda", DEV, gpu_model, False),
                ("cpu", "cpu", cpu_model, False),
                ("cuda_chunked", DEV, gpu_model, True),
                ("cpu_chunked", "cpu", cpu_model, True)):
            eng = Engine.from_config(EngineConfig(
                device=dev, chunked=chunked, chunk_size=chunk, **shape),
                model)
            assert eng.layout == "lanes"
            outs[tag] = eng.serve(synthetic_requests(4, plens, cfg.vocab,
                                                     new))
            del eng
        for arm in ("", "_chunked"):
            diff = _stream_diff(outs["cuda" + arm], outs["cpu" + arm])
            if diff:
                raise AssertionError(
                    f"{arch} greedy streams differ, card vs CPU{arm} (first "
                    f"differing token by request): {diff}")
        report[arch] = dict(
            n_layers=layers, requests=len(outs["cpu"]),
            tokens=sum(len(t) for t in outs["cpu"].values()),
            card_equals_cpu=True, card_equals_cpu_chunked=True,
            chunked_vs_blocking_on_card=_stream_diff(outs["cuda_chunked"],
                                                     outs["cuda"]))
        del gpu_model, cpu_model
        torch.cuda.empty_cache()
    target = build_model(get_config(SLICE["arch"]).reduced(),
                         device=DEV).init(5)
    kw = dict(max_seq=256, n_slots=4, page_size=16, segment_len=8,
              path="direct")
    spec = SpecConfig(draft_arch="mamba2-130m", enabled=True, k=3)
    outs, stats = {}, {}
    for tag, sp in (("base", None), ("spec", spec)):
        eng = Engine.from_config(EngineConfig(spec=sp, **kw), target)
        outs[tag] = eng.serve(synthetic_requests(6, [40, 90], 256, 24))
        stats[tag] = {k: eng.stats[k] for k in (
            "spec_proposed", "spec_accepted", "spec_committed",
            "spec_rounds")}
        if sp is not None and eng.scheduler._draft_positional:
            raise AssertionError("the mamba2 draft is not rolled back by "
                                 "snapshots")
        del eng
    diff = _stream_diff(outs["spec"], outs["base"])
    if diff or stats["spec"]["spec_rounds"] <= 0:
        raise AssertionError(f"greedy spec with the mamba2 draft differs "
                             f"from non-spec: {diff}, {stats['spec']}")
    report["spec_mamba2_draft"] = dict(
        target=target.cfg.name, draft="mamba2-130m-smoke", k=3,
        identical_streams=True, stats=stats["spec"])
    del target
    torch.cuda.empty_cache()
    say("parity_ssm", dtype="float32", **report)


# ---------------------------------------------------------------------------
# the encoder-decoder family at full width on the lanes layout
# ---------------------------------------------------------------------------


def _encoder_ms(model, group):
    """Device ms of the encoder over one admission group's frames (``group``
    requests, bf16, random frames), a request."""
    frames = torch.randn((group,) + media_spec(model.cfg, 1)[1:],
                         generator=timed_gen(160), device=DEV)
    return device_ms(lambda: model.encode(frames), "whisper encode",
                     reps=5) / group


def _cross_read_ms(cfg, slots):
    """Device ms a decode step spends in its cross reads: K4 at ``q[slots,
    H, Dh]`` over ``k/v[slots, n_audio_frames, H, Dh]``, every frame
    valid, timed alone, times the decoder's layer count."""
    q, k, v, mask = _whisper_k4_inputs(timed_gen(161), cfg.n_audio_frames,
                                       True)
    return device_ms(lambda: flash_decode(q, k, v, mask),
                     "whisper cross read") * cfg.n_layers


def phase_engine_encdec(kernels):
    """whisper-medium at full width (d_model 1024, 16 heads of 64, bf16,
    random weights from seed 0), cut to ``ENCDEC_LAYERS`` encoder and
    decoder layers of its 24 + 24, max_seq 448: ``ENCDEC_REQUESTS`` requests, each with its own frames [1500,
    1024], of ``ENCDEC_PROMPTS`` tokens, ``ENCDEC_NEW`` new tokens each, 8
    slots, blocking and chunked at ``ENCDEC_CHUNK``
    (``_lanes_family_runs``). Held besides: flash_attention launched once
    an encoder layer of an ``encode`` call (once an admission group: by
    ``prefill`` blocking, by the first chunk chunked) and twice a decoder
    layer of a ``prefill`` or ``chunk_prefill`` call (self and cross),
    flash_decode twice a decoder layer of a decode step, nothing else.
    Reported: blocking against chunked, tok/s, TTFT, peak memory, the
    encoder's device ms a request, a decode segment's profile with the
    cross reads' share of its device ms."""
    cfg = dataclasses.replace(get_config(ENCDEC["arch"]),
                              n_layers=ENCDEC_LAYERS,
                              n_enc_layers=ENCDEC_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV, max_seq=ENCDEC["max_seq"]).init(0)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    def want(calls):
        return dict(flash_attention=cfg.n_enc_layers * calls["encode"]
                    + 2 * cfg.n_layers * (calls["prefill"]
                                          + calls["chunk_prefill"]),
                    flash_decode=2 * cfg.n_layers * calls["decode_step"])

    def profile_fn(eng):
        profile = engine_profile(eng, cfg, ENCDEC, ENCDEC_PROMPTS)
        cross = _cross_read_ms(cfg, ENCDEC["n_slots"])
        dev_ms = profile["device_ms_per_step"]
        profile.update(cross_read_ms_per_step=cross,
                       cross_read_share=cross / dev_ms if dev_ms else None)
        return profile

    runs, problems, profile = _lanes_family_runs(
        kernels, model, ENCDEC,
        dict(requests=ENCDEC_REQUESTS, prompts=ENCDEC_PROMPTS,
             new=ENCDEC_NEW, chunk=ENCDEC_CHUNK),
        want, "whisper_shape", profile_fn)
    # the encoder runs once an admission group: by prefill when blocking,
    # by the first chunk (and only there) when chunked
    blk, chk = (runs[arm]["report"]["model_calls"]
                for arm in ("blocking", "chunked"))
    if not (blk["encode"] == blk["prefill"] > 0
            and chk["prefill"] == 0
            and 0 < chk["encode"] <= chk["chunk_prefill"]):
        problems.append(f"encoder calls: blocking {blk}, chunked {chk}")
    enc_ms = _encoder_ms(model, 2)
    del model
    torch.cuda.empty_cache()
    say("engine_encdec", config=ENCDEC, n_layers=cfg.n_layers,
        n_enc_layers=cfg.n_enc_layers, dtype=cfg.dtype, d_model=cfg.d_model,
        n_audio_frames=cfg.n_audio_frames, chunk_size=ENCDEC_CHUNK,
        params_billions=cfg.param_count() / 1e9,
        model_build_seconds=t_build, requests=ENCDEC_REQUESTS,
        prompt_lens=ENCDEC_PROMPTS, new_tokens=ENCDEC_NEW,
        encoder_device_ms_per_request=enc_ms,
        blocking_vs_chunked=_stream_diff(runs["chunked"]["out"],
                                         runs["blocking"]["out"]),
        profile=profile, **{k: r["report"] for k, r in runs.items()})
    if problems:
        raise AssertionError("engine_encdec: " + "; ".join(problems))


def phase_parity_encdec():
    """whisper-medium at full width, fp32, cut to 4 encoder and 4 decoder
    layers: the engine on the card (K3: the causal encoder, the prompt's
    self-attention, the cross read over 1500 frames; K4: the decode reads)
    and the same weights in a CPU engine (their plain versions) must give
    identical greedy streams, blocking and chunked at 64 (a chunk's cross
    read: 64 queries, non-causal, against the 1500 frames); blocking
    against chunked on the card is reported."""
    cfg = dataclasses.replace(get_config(ENCDEC["arch"]), n_layers=4,
                              n_enc_layers=4, dtype="float32")
    shape = dict(max_seq=448, n_slots=4, segment_len=8, path="direct")
    plens, new, chunk = [4, 70, 150], 16, 64
    gpu_model = build_model(cfg, device=DEV, max_seq=448).init(6)
    cpu_model = build_model(cfg, device="cpu", max_seq=448)
    cpu_model.load_state_dict(gpu_model.state_dict())
    frames = media_spec(cfg, 1)[1:]
    outs = {}
    for tag, dev, model, chunked in (
            ("cuda", DEV, gpu_model, False),
            ("cpu", "cpu", cpu_model, False),
            ("cuda_chunked", DEV, gpu_model, True),
            ("cpu_chunked", "cpu", cpu_model, True)):
        eng = Engine.from_config(EngineConfig(
            device=dev, chunked=chunked, chunk_size=chunk, **shape), model)
        assert eng.layout == "lanes"
        outs[tag] = eng.serve(synthetic_requests(4, plens, cfg.vocab, new,
                                                 media_shape=frames))
        del eng
    for arm in ("", "_chunked"):
        diff = _stream_diff(outs["cuda" + arm], outs["cpu" + arm])
        if diff:
            raise AssertionError(
                f"whisper greedy streams differ, card vs CPU{arm} (first "
                f"differing token by request): {diff}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    say("parity_encdec", dtype="float32", n_layers=4, n_enc_layers=4,
        requests=len(outs["cpu"]), prompt_lens=plens, chunk_size=chunk,
        tokens=sum(len(t) for t in outs["cpu"].values()),
        card_equals_cpu=True, card_equals_cpu_chunked=True,
        chunked_vs_blocking_on_card=_stream_diff(outs["cuda_chunked"],
                                                 outs["cuda"]))


# ---------------------------------------------------------------------------
# the VLM family at full width on the lanes layout
# ---------------------------------------------------------------------------


def _seed_gates(model, seed):
    """Nonzero cross gates drawn from ``seed`` (uniform in [0.3, 1.2)): at
    zero, ``tanh(0) = 0`` takes the cross layers out of the output, and a
    wrong cross read would pass every stream check."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for cb in model.cross_blocks:
            for g in (cb.gate_attn, cb.gate_mlp):
                g.copy_(torch.rand((), generator=gen) * 0.9 + 0.3)
    return model


def _vlm_cross_ms(model, slots):
    """Device ms a decode step spends in its cross reads (K4 at ``q[slots,
    64, 128]`` over the ``n_image_tokens`` image K/V, every key valid,
    timed alone, times the groups) and a chunk in its cross K/V projection
    (``project_kv`` of 2 requests' embeddings, bf16, times the groups)."""
    cfg = model.cfg
    q, k, v, mask = _vlm_k4_inputs(timed_gen(192), cfg.n_image_tokens, True)
    read = device_ms(lambda: flash_decode(q, k, v, mask), "vlm cross read")
    media = torch.randn((2, cfg.n_image_tokens, cfg.d_model),
                        generator=timed_gen(193), device=DEV).to(
                            torch.bfloat16)
    pa = model.cross_blocks[0].attn.tensors(torch.bfloat16)
    proj = device_ms(lambda: LAYERS.project_kv(cfg, pa, media, None),
                     "vlm cross K/V projection", reps=5)
    return dict(cross_read_ms_per_step=read * model.n_groups,
                cross_kv_projection_ms_per_chunk=proj * model.n_groups)


def phase_engine_vlm(kernels):
    """llama-3.2-vision-90b at full width (d_model 8192, 64 heads of 128
    over 8 KV heads, d_ff 28672, bf16, random weights from seed 0, gates
    from seed 1), cut to ``VLM_GROUPS`` of its 20 groups (4 self and 1
    cross layer each), max_seq 1024: ``VLM_REQUESTS`` requests,
    each with its own image embeddings [1601, 8192], of ``VLM_PROMPTS``
    tokens, ``VLM_NEW`` new tokens each, 8 slots, blocking and chunked at
    ``VLM_CHUNK`` (``_lanes_family_runs``). Held besides: flash_attention
    launched once a layer of a ``prefill`` or ``chunk_prefill`` call (self
    and cross), flash_decode once a layer of a decode step, nothing
    else. Reported: blocking against chunked, tok/s, TTFT, peak memory, a
    decode segment's profile with the cross reads' share of its device ms,
    the cross K/V projection's device ms a chunk."""
    cfg = dataclasses.replace(get_config(VLM["arch"]),
                              n_layers=VLM_GROUPS * get_config(
                                  VLM["arch"]).cross_attn_every)
    t0 = time.perf_counter()
    model = _seed_gates(build_model(cfg, device=DEV).init(0), 1)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    params_gb = torch.cuda.memory_allocated() / 1e9

    def want(calls):
        return dict(flash_attention=cfg.n_layers * (calls["prefill"]
                                                    + calls["chunk_prefill"]),
                    flash_decode=cfg.n_layers * calls["decode_step"])

    def profile_fn(eng):
        profile = engine_profile(eng, cfg, VLM, VLM_PROMPTS)
        profile.update(_vlm_cross_ms(model, VLM["n_slots"]))
        dev_ms = profile["device_ms_per_step"]
        profile["cross_read_share"] = (
            profile["cross_read_ms_per_step"] / dev_ms if dev_ms else None)
        return profile

    runs, problems, profile = _lanes_family_runs(
        kernels, model, VLM,
        dict(requests=VLM_REQUESTS, prompts=VLM_PROMPTS, new=VLM_NEW,
             chunk=VLM_CHUNK),
        want, "vlm_shape", profile_fn)
    del model
    torch.cuda.empty_cache()
    say("engine_vlm", config=VLM, n_layers=cfg.n_layers,
        groups=VLM_GROUPS, dtype=cfg.dtype, d_model=cfg.d_model,
        n_image_tokens=cfg.n_image_tokens, chunk_size=VLM_CHUNK,
        params_billions=cfg.param_count() / 1e9, params_gb=params_gb,
        model_build_seconds=t_build, requests=VLM_REQUESTS,
        prompt_lens=VLM_PROMPTS, new_tokens=VLM_NEW,
        gates="uniform [0.3, 1.2) from seed 1",
        blocking_vs_chunked=_stream_diff(runs["chunked"]["out"],
                                         runs["blocking"]["out"]),
        profile=profile, **{k: r["report"] for k, r in runs.items()})
    if problems:
        raise AssertionError("engine_vlm: " + "; ".join(problems))


def phase_parity_vlm():
    """The VLM's kernel geometry at a CPU's width, fp32: llama-3.2-vision-90b
    with head_dim 128, GQA group 8, 1601 image tokens and 2 groups of 5
    layers, d_model 1024 (``VLM_PARITY_WIDTH``), gates from a seed. The
    engine on the card (K3: the prompt, the chunks, the cross reads over
    1601 image keys; K4: the decode reads) and the same weights in a CPU
    engine (their plain versions) must give identical greedy streams,
    blocking and chunked at 64 (the media on every chunk); blocking
    against chunked on the card is reported."""
    base = get_config(VLM["arch"])
    cfg = dataclasses.replace(base, n_layers=2 * base.cross_attn_every,
                              dtype="float32", **VLM_PARITY_WIDTH)
    shape = dict(max_seq=512, n_slots=4, segment_len=8, path="direct")
    plens, new, chunk = [16, 70, 150], 16, 64
    gpu_model = _seed_gates(build_model(cfg, device=DEV).init(7), 8)
    cpu_model = build_model(cfg, device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    image = media_spec(cfg, 1)[1:]
    outs = {}
    for tag, dev, model, chunked in (
            ("cuda", DEV, gpu_model, False),
            ("cpu", "cpu", cpu_model, False),
            ("cuda_chunked", DEV, gpu_model, True),
            ("cpu_chunked", "cpu", cpu_model, True)):
        eng = Engine.from_config(EngineConfig(
            device=dev, chunked=chunked, chunk_size=chunk, **shape), model)
        assert eng.layout == "lanes"
        outs[tag] = eng.serve(synthetic_requests(4, plens, cfg.vocab, new,
                                                 media_shape=image))
        del eng
    for arm in ("", "_chunked"):
        diff = _stream_diff(outs["cuda" + arm], outs["cpu" + arm])
        if diff:
            raise AssertionError(
                f"VLM greedy streams differ, card vs CPU{arm} (first "
                f"differing token by request): {diff}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    say("parity_vlm", dtype="float32", n_layers=cfg.n_layers,
        width=VLM_PARITY_WIDTH, head_dim=cfg.resolved_head_dim,
        n_image_tokens=cfg.n_image_tokens, requests=len(outs["cpu"]),
        prompt_lens=plens, chunk_size=chunk,
        tokens=sum(len(t) for t in outs["cpu"].values()),
        card_equals_cpu=True, card_equals_cpu_chunked=True,
        chunked_vs_blocking_on_card=_stream_diff(outs["cuda_chunked"],
                                                 outs["cuda"]))


# ---------------------------------------------------------------------------
# the staging ring on the lanes cache: ServeEngine
# ---------------------------------------------------------------------------


def _ring_engine(model, mode, **kw):
    cfg = dict(max_seq=RING_LANES["max_seq"], ring_size=RING_LANES["ring_size"],
               page_size=RING_LANES["page_size"],
               hot_threshold=RING_LANES["hot_threshold"])
    cfg.update(kw)
    return ServeEngine(model, ServeConfig(write_mode=mode, **cfg),
                       _internal=True)


def _ring_step_profile(model, mode, prompt, steps=16):
    """Device ms and ops a decode step of one mode: ``steps`` steps of
    ``decode`` after a prefill, under the profiler (the host clock's ms a
    step beside)."""
    eng = _ring_engine(model, mode)
    logits, cache = eng.prefill(prompt)
    first = torch.argmax(logits, dim=-1)
    start = torch.full_like(first, prompt.shape[1])
    eng.decode(cache, first, start, steps)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.decode(cache, first, start, steps)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / steps
    rows = trace_rows(lambda: eng.decode(cache, first, start, steps),
                      f"ring lanes {mode} decode")
    dev_ms = sum(r[0] for r in rows) / 1e3 / steps
    # torch.cat's kernel: the concatenation of cache and ring, in the step
    cat = sum(r[0] for r in rows if "CatArray" in r[2]) / 1e3 / steps
    return dict(step_ms=host, device_ms_per_step=dev_ms,
                device_busy_share=dev_ms / host if dev_ms else None,
                concat_ms_in_step=cat,
                concat_share=cat / dev_ms if dev_ms else None,
                device_ops_per_step=device_ops(rows) / steps,
                top=[dict(kernel=k[:64], ms_per_step=us / 1e3 / steps,
                          calls_per_step=n / steps)
                     for us, n, k in rows[:6]])


def _concat_ms(cfg):
    """The concatenation of cache and ring (K and V, every layer) timed
    alone: ``torch.cat`` of ``[8, 1024, 32, 64]`` and ``[8, 8, 32, 64]``
    bf16, the same operands every call (so partly L2-warm), times 2 x
    layers; the profile's ``concat_ms_in_step`` is its time in the step."""
    b, s, r = RING_LANES["batch"], RING_LANES["max_seq"], \
        RING_LANES["ring_size"]
    h, d = cfg.n_kv_heads, cfg.resolved_head_dim
    gen = timed_gen(194)
    kc = torch.randn((b, s, h, d), generator=gen, device=DEV).to(
        torch.bfloat16)
    rk = torch.randn((b, r, h, d), generator=gen, device=DEV).to(
        torch.bfloat16)
    one = device_ms(lambda: torch.cat([kc, rk], dim=1), "cache ∪ ring cat")
    return one * 2 * cfg.n_layers


def phase_engine_ring_lanes(kernels):
    """``ServeEngine`` on stablelm-1.6b at full width, cut to
    ``RING_LANES_LAYERS`` of its 24 layers (bf16, weights from seed 0),
    over the dense lanes cache: 8 sequences of
    512-token prompts, 128 new tokens, max_seq 1024, a ring of 8, pages of
    64, hot threshold 4; each of direct, staged and adaptive through
    ``decode`` (one loop, one readback) and ``decode_reference`` (a host
    read a step). Launch counts set to 0 just before each ``generate`` and
    read just after. Held: ``decode`` = ``decode_reference`` (tokens and
    ``stats``); flash_attention one launch a layer (the prefill),
    flash_decode one a layer and decode step (the read of cache ∪ ring, or
    of the cache alone when direct); staged_scatter one launch a ``maybe_drain`` call (every step:
    the drain decision rides in its validity) and one for the last drain on
    the ring modes, none when direct; every write staged in staged mode,
    none in direct; then the card = the CPU in fp32 at 2 layers (tokens and
    ``stats``, all three modes, a ring of 8 that fills and slots that
    clamp past max_seq, so conflicts force drains). Reported: each mode's
    device ms and ops a step, its drains and tok/s, the concatenation's
    share of a step (the ``torch.cat`` kernels in the step's trace; timed
    alone beside it), direct against staged streams (bf16: K4's key order
    differs)."""
    cfg = dataclasses.replace(get_config(RING_LANES["arch"]),
                              n_layers=RING_LANES_LAYERS)
    model = build_model(cfg, device=DEV).init(0)
    b, plen, new = RING_LANES["batch"], RING_LANES["prompt"], \
        RING_LANES["new"]
    prompt = torch.randint(0, cfg.vocab, (b, plen), generator=timed_gen(195),
                           device=DEV)
    steps = new - 1
    report, problems, toks = {}, [], {}
    t_start, t_parts = time.perf_counter(), {}
    for mode in WRITE_MODES:
        ring = mode != "direct"
        arm = {}
        for tag, reference in (("decode", False), ("decode_reference", True)):
            eng = _ring_engine(model, mode)
            torch.cuda.synchronize()
            reset_launch_counts()   # counts = 0 just before the main path
            t0 = time.perf_counter()
            out = eng.generate(prompt, new, reference=reference)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = launch_counts()    # read just after
            want = dict(flash_attention=cfg.n_layers,
                        flash_decode=cfg.n_layers * steps,
                        staged_scatter=steps + 1 if ring else 0)
            for k, n in counts.items():
                if n != want.get(k, 0):
                    problems.append(f"{mode} {tag}: {k} launched {n} times, "
                                    f"want {want.get(k, 0)}")
            st = dict(eng.stats)
            if st["direct_writes"] + st["staged_writes"] != b * steps:
                problems.append(f"{mode} {tag}: stats {st}")
            if mode == "staged" and st["staged_writes"] != b * steps:
                problems.append(f"{mode} {tag}: staged writes {st}")
            if mode == "direct" and (st["staged_writes"] or st["drains"]):
                problems.append(f"{mode} {tag}: stats {st}")
            arm[tag] = dict(tokens=out.cpu().numpy(), stats=st,
                            launches=counts, seconds=secs,
                            tok_per_s=b * new / secs)
            if tag == "decode":
                for k in kernels:
                    if k["name"] == "staged_scatter" and ring:
                        k["lanes_ring_shape"][f"launches_{mode}"] = counts[
                            "staged_scatter"]
                    if k["name"] == "flash_decode":
                        k["lanes_ring_shape"][f"launches_{mode}"] = counts[
                            "flash_decode"]
        a, r_ = arm["decode"], arm["decode_reference"]
        if (a["tokens"] != r_["tokens"]).any() or a["stats"] != r_["stats"]:
            problems.append(f"{mode}: decode != decode_reference "
                            f"({a['stats']} / {r_['stats']})")
        toks[mode] = a["tokens"]
        report[mode] = dict(stats=a["stats"], launches=a["launches"],
                            tok_per_s=[a["tok_per_s"], r_["tok_per_s"]],
                            seconds=[a["seconds"], r_["seconds"]],
                            decode_equals_reference=True,
                            profile=_ring_step_profile(model, mode, prompt))
    report["concat_ms_alone_per_step"] = _concat_ms(cfg)
    t_parts["engines_and_profiles"] = time.perf_counter() - t_start
    del model
    torch.cuda.empty_cache()
    # the card against the CPU, fp32, 2 layers: a ring of 8 that fills, and
    # 40 steps past a 100-token prompt with max_seq 128 clamp the last
    # slots, so conflicts force drains
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    gpu_model = build_model(cfg2, device=DEV).init(9)
    cpu_model = build_model(cfg2, device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    p2 = torch.randint(0, cfg.vocab, (4, 100), generator=torch.Generator()
                       .manual_seed(10))
    parity = {}
    for mode in WRITE_MODES:
        got = {}
        for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
            eng = _ring_engine(model, mode, max_seq=128, page_size=16)
            got[dev] = (eng.generate(p2.to(model.device), 40).cpu().numpy(),
                        dict(eng.stats))
        if (got["cuda"][0] != got["cpu"][0]).any() or \
                got["cuda"][1] != got["cpu"][1]:
            problems.append(f"fp32 card != CPU, {mode}: {got['cuda'][1]} / "
                            f"{got['cpu'][1]}")
        parity[mode] = got["cpu"][1]
    del gpu_model, cpu_model
    t_parts["fp32_parity"] = time.perf_counter() - t_start - t_parts[
        "engines_and_profiles"]
    say("engine_ring_lanes", config=RING_LANES, n_layers=cfg.n_layers,
        seconds_parts=t_parts,
        dtype=cfg.dtype, decode_steps=steps,
        direct_vs_staged=_stream_diff(
            {i: t for i, t in enumerate(toks["staged"])},
            {i: t for i, t in enumerate(toks["direct"])}),
        direct_vs_adaptive=_stream_diff(
            {i: t for i, t in enumerate(toks["adaptive"])},
            {i: t for i, t in enumerate(toks["direct"])}),
        fp32_card_equals_cpu_2_layers=not any("fp32" in p for p in problems),
        fp32_stats=parity, **report)
    if problems:
        raise AssertionError("engine_ring_lanes: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# training on the card: parity with the CPU, then the dense and MoE families
# at full width
# ---------------------------------------------------------------------------


def _train_launches(cfg, steps, staged=False):
    """The launches a training run of ``steps`` steps makes: K3 and its
    backward as ``remat_calls`` counts them (none in the SSM), a staged
    dispatch's drain twice a layer and microbatch and its adjoint once;
    every other kernel none."""
    n = TRAIN["microbatches"] * steps
    calls = remat_calls(cfg)
    want = {k: calls[k] * n for k in ("flash_attention",
                                      "flash_attention_bwd")}
    if staged:
        want.update(staged_drain=2 * cfg.n_layers * n,
                    staged_gather=cfg.n_layers * n)
    return want


def _launch_problems(what, counts, want):
    return [f"{what}: {k} launched {n} times, want {want.get(k, 0)}"
            for k, n in counts.items() if n != want.get(k, 0)]


def _same(a, b):
    """Both None, or equal tensors."""
    return (a is None and b is None) or (
        a is not None and b is not None and torch.equal(a, b))


def _recorded(step):
    """``step`` wrapped to keep each call's grad norm and lr and the MoE
    counters and mask it leaves."""
    rec = []

    def run(state, batch):
        state, met = step(state, batch)
        rec.append(dict(
            grad_norm=met["grad_norm"], lr=met["lr"],
            counts=None if state.expert_counts is None
            else state.expert_counts.clone(),
            hot=None if state.hot_mask is None else state.hot_mask.clone()))
        return state, met
    return run, rec


def _train_profile(tr, what, span=None):
    """One more step of the trainer ``tr`` on its next batch: its host ms
    (to the loss's read) untraced, then traced: the device ms (the kernels'
    own times), the device's operations, the busy share (device ms over
    host ms) and the largest kernels; with a ``span``, read from the same
    trace (``trace_spans``), its device ms and their share of the step."""
    batch = tr.put_batch(next(tr.pipeline))

    def one():
        tr.state, met = tr.train_step(tr.state, batch)
        float(met["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    host_ms = (time.perf_counter() - t0) * 1e3
    spans = None
    if span:
        rows, spans = trace_spans(one, what, span)
    else:
        rows = trace_rows(one, what)
    dev_ms = sum(r[0] for r in rows) / 1e3
    if spans:
        spans["ms"] = spans["forward_ms"] + spans["backward_ms"]
        spans["share_of_step"] = spans["ms"] / dev_ms
    return dict(host_ms=host_ms, device_ms=dev_ms,
                busy_share=dev_ms / host_ms if rows else None,
                device_ops=device_ops(rows), span=spans,
                largest=[(r[2][:70], r[1], r[0] / 1e3) for r in rows[:6]])


def _train_report(tr, rec, secs, tokens_a_step):
    steady = sorted(tr.step_ms[1:]) or tr.step_ms
    return dict(losses=tr.history,
                grad_norms=[float(r["grad_norm"]) for r in rec],
                lr=[float(r["lr"]) for r in rec], step_host_ms=tr.step_ms,
                seconds=secs,
                tokens_per_s=tokens_a_step / steady[len(steady) // 2] * 1e3)


class _KeptGrads:
    """An optimizer that keeps a copy of the gradients of every ``update``
    (before the clip scales them) in ``kept``, on ``device`` (the host by
    default; a placed gradient gathered whole)."""

    def __init__(self, opt, device="cpu"):
        self.opt, self.kept, self.device = opt, [], device

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, state, params):
        self.kept.append({
            k: (g.gather(self.device) if isinstance(g, ShardedTensor)
                else g).detach().to(self.device, torch.float32, copy=True)
            for k, g in grads.items()})
        return self.opt.update(grads, state, params)


def _parity_train_arm(cfg, mode, n_hot):
    """One model on the card (the kernels) and the CPU (the plain versions)
    from the same weights and batches (with media drawn on the CPU from a
    seed for the families that read them; the VLM's gates drawn from a
    seed): the first batch's loss and gradients, then
    ``PARITY_TRAIN["steps"]`` train steps each, every step's gradients
    kept (``step_grads``)."""
    P = PARITY_TRAIN
    kw = {"dispatch_mode": mode} if mode else {}
    card = build_model(cfg, device=DEV, **kw).init(0)
    if card.is_vlm:
        _seed_gates(card, 9)
    cpu = build_model(cfg, device="cpu", **kw)
    cpu.load_state_dict(card.state_dict())
    src = SyntheticSource(DataConfig(P["seq"], P["batch"], cfg.vocab))
    media = [torch.randn(media_spec(cfg, P["batch"]),
                         generator=torch.Generator().manual_seed(60 + i))
             if needs_media(cfg) else None for i in range(P["steps"])]
    runs, counts = {}, None
    for name, m in (("card", card), ("cpu", cpu)):
        opt = _KeptGrads(AdamW(lr=warmup_cosine(P["lr"], 1, P["steps"])))
        st = init_train_state(m, opt, None, n_hot)

        def put(i):
            b = dict(src.batch_at(i))
            if media[i] is not None:
                b["media"] = media[i]
            return {k: torch.as_tensor(v, device=m.device)
                    for k, v in b.items()}
        loss = (m.loss(put(0), hot_mask=st.hot_mask) if mode
                else m.loss(put(0)))
        names, ps = zip(*m.named_parameters())
        grads = {k: g.cpu() for k, g in zip(names,
                                            torch.autograd.grad(loss, ps))}
        step = make_train_step(m, opt, microbatches=P["microbatches"],
                               n_hot_experts=n_hot)
        if name == "card":
            torch.cuda.synchronize()
            reset_launch_counts()   # counts = 0 just before the main path
        mets = []
        for i in range(P["steps"]):
            st, met = step(st, put(i))
            mets.append(dict(
                loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                lr=float(met["lr"]),
                counts=None if st.expert_counts is None
                else st.expert_counts.cpu(),
                hot=None if st.hot_mask is None else st.hot_mask.cpu()))
        if name == "card":
            counts = launch_counts()    # read just after
        runs[name] = dict(loss0=float(loss.detach()), grads=grads, mets=mets,
                          step_grads=opt.kept,
                          params={k: v.detach().cpu()
                                  for k, v in m.named_parameters()})
    del card, cpu
    torch.cuda.empty_cache()
    return runs, counts


def phase_parity_train():
    """Training on the card = on the CPU, fp32, at the kernels' geometry
    (``PARITY_TRAIN_*``): stablelm-1.6b's family, granite-moe-3b-a800m's
    staged and adaptive (2 hot experts of 8), mamba2-130m's, zamba2-2.7b's,
    whisper-medium's (with frames) and llama-3.2-vision-90b's (with image
    embeddings, gates from a seed). Held: every gradient leaf of the first
    batch within 1e-4 of its largest entry (every attention weight's, the
    cross layers' too, every expert weight's and the gates' nonzero); per
    step the loss
    within 1e-5 and the grad norm within 1e-4 (relative), lr within 1e-6,
    ``expert_counts`` and the hot mask equal; the final parameters within
    3 x lr, at most 0.1 % of the entries of a leaf past 1e-6, leaving out
    the entries whose gradient the gradient check cannot tell from 0: on
    some step the CPU's gradient of the entry is within
    ``PARITY_GRAD_RTOL`` of its leaf's largest (Adam's first step of such an
    entry is ``lr * g / (|g| + eps)``, so fp32 noise of a few 1e-9 in ``g``
    moves it by a part of lr, and the later steps keep that). The entries
    past 1e-6 that differ most are reported with their gradients on every
    step, card and CPU. And the launches of K3, its backward, K1's drain
    and its adjoint as remat makes them."""
    P = PARITY_TRAIN
    problems, report = [], {}
    for tag, arch, over, mode, n_hot in (
            ("dense", SLICE["arch"], PARITY_TRAIN_DENSE, None, 0),
            ("moe_staged", MOE["arch"], PARITY_TRAIN_MOE, "staged", 0),
            ("moe_adaptive", MOE["arch"], PARITY_TRAIN_MOE, "adaptive", 2),
            ("ssm", SSM["arch"], PARITY_TRAIN_SSM, None, 0),
            ("hybrid", HYBRID["arch"], PARITY_TRAIN_HYBRID, None, 0),
            ("encdec", ENCDEC["arch"], PARITY_TRAIN_ENCDEC, None, 0),
            ("vlm", VLM["arch"], PARITY_TRAIN_VLM, None, 0)):
        cfg = dataclasses.replace(get_config(arch), **over)
        runs, counts = _parity_train_arm(cfg, mode, n_hot)
        a, b = runs["card"], runs["cpu"]
        grad_share, zero = 0.0, []
        for k, g in a["grads"].items():
            ref = b["grads"][k]
            scale = float(ref.abs().max())
            grad_share = max(grad_share, float((g - ref).abs().max())
                             / max(PARITY_GRAD_RTOL * scale, 1e-30))
            if ("attn" in k or "moe" in k or "gate" in k) and \
                    float(g.abs().max()) == 0:
                zero.append(k)
        if grad_share > 1.0:
            problems.append(f"{tag}: a gradient leaf errs {grad_share} x "
                            f"its tolerance")
        if zero:
            problems.append(f"{tag}: zero gradients on the card: {zero}")
        if abs(a["loss0"] - b["loss0"]) > 1e-5 * abs(b["loss0"]):
            problems.append(f"{tag}: loss {a['loss0']} != {b['loss0']}")
        for i, (x, y) in enumerate(zip(a["mets"], b["mets"])):
            if abs(x["loss"] - y["loss"]) > 1e-5 * abs(y["loss"]) or \
                    abs(x["grad_norm"] - y["grad_norm"]) > \
                    1e-4 * abs(y["grad_norm"]) or \
                    abs(x["lr"] - y["lr"]) > 1e-6 * abs(y["lr"]):
                problems.append(f"{tag} step {i}: card {x} cpu {y}")
            if mode and not (_same(x["counts"], y["counts"])
                             and _same(x["hot"], y["hot"])):
                problems.append(f"{tag} step {i}: counts / mask differ")
        worst, share_1e6, held_1e6, leaves_over, past = 0.0, 0.0, 0.0, [], []
        for k, v in a["params"].items():
            d = (v - b["params"][k]).abs().reshape(-1)
            worst = max(worst, float(d.max()))
            beyond = d > 1e-6
            share_1e6 = max(share_1e6, int(beyond.sum()) / d.numel())
            g = torch.stack([s[k].reshape(-1).abs() for s in b["step_grads"]])
            unpinned = (g <= PARITY_GRAD_RTOL
                        * g.amax(dim=1, keepdim=True)).any(dim=0)
            n_held = int((beyond & ~unpinned).sum())
            held_1e6 = max(held_1e6, n_held / d.numel())
            if n_held > 1e-3 * d.numel():
                leaves_over.append((k, n_held, d.numel()))
            past += [(float(d[i]), k, i, bool(unpinned[i]),
                      int(beyond.sum()) > 1e-3 * d.numel())
                     for i in beyond.nonzero()[:, 0].tolist()]
        if worst > 3 * P["lr"] or leaves_over:
            problems.append(f"{tag}: parameters part by {worst} (entries "
                            f"past 1e-6 with a pinned gradient, of a leaf: "
                            f"{leaves_over})")

        def steps_of(run, k, i):
            return [float(s[k].reshape(-1)[i]) for s in run["step_grads"]]

        def entry(x, k, i, u):
            return dict(leaf=k, index=i, diff=x, gradient_unpinned=u,
                        cpu_grads=steps_of(b, k, i),
                        card_grads=steps_of(a, k, i),
                        cpu_grad_share_of_leaf_max=[
                            abs(g) / float(s[k].abs().max()) for g, s in
                            zip(steps_of(b, k, i), b["step_grads"])])
        # the largest, and the entries of the leaves past 0.1 % before the
        # unpinned entries are left out
        past.sort(reverse=True)
        past_entries = [entry(*e[:4]) for e in past[:4]]
        dense_entries = [entry(*e[:4]) for e in past if e[4]][:8]
        problems += _launch_problems(tag, counts, _train_launches(
            cfg, P["steps"], staged=mode is not None))
        report[tag] = dict(
            config=over, losses=[m["loss"] for m in a["mets"]],
            loss_diff=[x["loss"] - y["loss"]
                       for x, y in zip(a["mets"], b["mets"])],
            grad_leaf_worst_share_of_tol=grad_share,
            param_max_diff=worst, param_share_past_1e6=share_1e6,
            param_share_past_1e6_pinned=held_1e6,
            n_past_1e6=len(past),
            n_past_1e6_unpinned=sum(e[3] for e in past),
            past_1e6_largest=past_entries,
            past_1e6_in_leaves_over_share=dense_entries,
            expert_counts=None if not mode
            else a["mets"][-1]["counts"].tolist(), launches=counts)
    say("parity_train", shape=P, **report)
    if problems:
        raise AssertionError("parity_train: " + "; ".join(problems))


def _train_dir():
    """Scratch space for train_dense's checkpoint: inside the checkout's
    ignored ``build/``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_train")


def phase_train_dense(kernels):
    """stablelm-1.6b at full width (d_model 2048, 32 heads of 64, vocab
    100352), cut to ``TRAIN_DENSE_LAYERS`` of its 24 layers, bf16 compute
    over fp32 masters: ``Trainer`` over ``SyntheticSource`` batches of 8 x
    512 in 2 microbatches, remat, AdamW under ``warmup_cosine``. A
    checkpoint at step 3 (written async while the run goes on to 6); then a
    fresh model and ``Trainer`` resume from it and run to 6: their losses
    within ``TRAIN_RESUME_RTOL`` of the first run's. Launch counts set to 0
    just before the first run and read just after: K3 twice and its
    backward once a layer, microbatch and step, nothing else. Reported:
    losses, grad norms, step host ms, tokens/s, peak memory, and one more
    step traced (device ms, busy share, device ops)."""
    import shutil
    cfg = dataclasses.replace(get_config(SLICE["arch"]),
                              n_layers=TRAIN_DENSE_LAYERS)
    steps, at = TRAIN_DENSE_STEPS, TRAIN_RESUME_AT
    ckdir = _train_dir()
    shutil.rmtree(ckdir, ignore_errors=True)
    dc = DataConfig(TRAIN["seq"], TRAIN["batch"], cfg.vocab)

    def trainer(seed, total, ckpt_dir):
        model = build_model(cfg, device=DEV)
        opt = AdamW(lr=warmup_cosine(TRAIN["lr"], TRAIN["warmup"], steps))
        step, rec = _recorded(make_train_step(
            model, opt, microbatches=TRAIN["microbatches"]))
        return Trainer(step, init_train_state(model, opt, seed),
                       Pipeline(SyntheticSource(dc)).start(),
                       TrainerConfig(total_steps=total, checkpoint_every=at,
                                     checkpoint_dir=ckpt_dir,
                                     log_every=10 ** 9)), rec

    problems = []
    t0 = time.perf_counter()
    tr, rec = trainer(0, at, ckdir)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    reset_launch_counts()           # counts = 0 just before the main path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.run()                        # steps 0..2, the checkpoint at 3
    ckpt_s = time.perf_counter() - t0
    tr.cfg = dataclasses.replace(tr.cfg, total_steps=steps,
                                 checkpoint_dir=None)
    tr.run()                        # steps 3..5
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()        # read just after
    peak = torch.cuda.max_memory_allocated()
    problems += _launch_problems("train_dense", counts,
                                 _train_launches(cfg, steps))
    report = _train_report(tr, rec, secs, TRAIN["batch"] * TRAIN["seq"])
    profile = _train_profile(tr, "train_dense step")
    tr.pipeline.stop()
    first = tr.history
    del tr, rec
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tr2, _ = trainer(1, steps, ckdir)
    tr2.maybe_resume()
    restore_s = time.perf_counter() - t0
    if tr2.state.step != at or tr2.pipeline.step != at:
        problems.append(f"resumed at step {tr2.state.step}, pipeline "
                        f"{tr2.pipeline.step}")
    tr2.cfg = dataclasses.replace(tr2.cfg, checkpoint_dir=None)
    tr2.run()
    tr2.pipeline.stop()
    resumed = tr2.history
    rel = [abs(x - y) / abs(y) for x, y in zip(resumed, first[at:])]
    if len(resumed) != steps - at or max(rel) > TRAIN_RESUME_RTOL:
        problems.append(f"resumed losses {resumed} against {first[at:]}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(ckdir) for f in fs)
    del tr2
    torch.cuda.empty_cache()
    shutil.rmtree(ckdir, ignore_errors=True)
    say("train_dense", arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
        shape=TRAIN, steps=steps, params_billions=cfg.param_count() / 1e9,
        model_build_seconds=t_build, launches=counts, peak_mem_gb=peak / 1e9,
        checkpoint_at=at, checkpoint_gb=ckpt_bytes / 1e9,
        first_leg_seconds=ckpt_s, resume_seconds=restore_s,
        resumed_losses=resumed, resumed_rel_diff=rel,
        resume_rtol=TRAIN_RESUME_RTOL, profile=profile, **report)
    take_launches(kernels, counts, ("flash_attention_bwd",))
    for k in kernels:
        if k["name"] == "flash_attention":
            k["train_dense_launches"] = counts["flash_attention"]
    if problems:
        raise AssertionError("train_dense: " + "; ".join(problems))


def phase_train_moe(kernels):
    """granite-moe-3b-a800m at full width (d_model 1536, 40 experts top-8,
    24 heads over 8), cut to ``TRAIN_MOE_LAYERS`` of its 32 layers, bf16
    over fp32 masters, ``train_dense``'s batches: 3 steps with staged
    dispatch (the unload path: every assignment drains through K1), then 3
    adaptive with ``TRAIN_N_HOT`` hot experts, the mask recalibrated after
    every step. Held per arm: ``expert_counts`` sums to tokens x top-8 x
    layers x steps; each step's mask equals ``expert_hot_mask`` of that
    step's counts taken on the CPU; K3, its backward, the drain and its
    adjoint launched as remat makes them, nothing else. Reported as
    ``train_dense``."""
    cfg = dataclasses.replace(get_config(MOE["arch"]),
                              n_layers=TRAIN_MOE_LAYERS)
    steps = TRAIN_MOE_STEPS
    dc = DataConfig(TRAIN["seq"], TRAIN["batch"], cfg.vocab)
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    problems, arms, drains = [], {}, {}
    want = _train_launches(cfg, steps, staged=True)
    for mode, n_hot in (("staged", 0), ("adaptive", TRAIN_N_HOT)):
        model.dispatch_mode = mode
        opt = AdamW(lr=warmup_cosine(TRAIN["lr"], TRAIN["warmup"], steps))
        step, rec = _recorded(make_train_step(
            model, opt, microbatches=TRAIN["microbatches"],
            n_hot_experts=n_hot))
        tr = Trainer(step, init_train_state(model, opt, 0, n_hot),
                     Pipeline(SyntheticSource(dc)).start(),
                     TrainerConfig(total_steps=steps, log_every=10 ** 9))
        reset_launch_counts()       # counts = 0 just before the main path
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()    # read just after
        peak = torch.cuda.max_memory_allocated()
        problems += _launch_problems(f"train_moe {mode}", counts, want)
        total = int(tr.state.expert_counts.sum())
        if total != TRAIN["batch"] * TRAIN["seq"] * cfg.top_k * \
                cfg.n_layers * steps:
            problems.append(f"{mode}: expert_counts sum to {total}")
        masks_ok = True
        for r in rec:
            if n_hot and not torch.equal(
                    r["hot"].cpu(), expert_hot_mask(r["counts"].cpu(), n_hot)):
                masks_ok = False
        if not masks_ok:
            problems.append(f"{mode}: a step's mask is not expert_hot_mask "
                            f"of its counts")
        report = _train_report(tr, rec, secs, TRAIN["batch"] * TRAIN["seq"])
        profile = _train_profile(tr, f"train_moe {mode} step")
        tr.pipeline.stop()
        arms[mode] = dict(report, launches=counts, peak_mem_gb=peak / 1e9,
                          expert_counts=tr.state.expert_counts.tolist(),
                          hot_masks=[None if r["hot"] is None
                                     else r["hot"].nonzero()[:, 0].tolist()
                                     for r in rec],
                          masks_equal_expert_hot_mask=masks_ok,
                          profile=profile)
        drains[mode] = counts["staged_drain"]
        if mode == "staged":
            take_launches(kernels, counts, ("staged_gather",))
        del tr, rec
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    for k in kernels:
        if k["name"] == "staged_scatter":
            k["train_moe_drain_launches"] = drains
    say("train_moe", arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
        shape=TRAIN, steps=steps, n_experts=cfg.n_experts, top_k=cfg.top_k,
        n_hot=TRAIN_N_HOT, params_billions=cfg.param_count() / 1e9,
        model_build_seconds=t_build, **arms)
    if problems:
        raise AssertionError("train_moe: " + "; ".join(problems))


def _train_family(kernels, tag, cfg, seq):
    """``cfg`` at full width trained for ``TRAIN_FAMILY_STEPS`` steps:
    ``Trainer`` over ``SyntheticSource`` batches of ``TRAIN["batch"]`` x
    ``seq`` (with frames or image embeddings drawn on the card from a seed
    where the model reads them) in ``TRAIN["microbatches"]`` microbatches,
    remat, AdamW under ``warmup_cosine``, weights from seed 0. Launch counts
    set to 0 just before the run and read just after: K3 and its backward
    as ``remat_calls`` counts them, nothing else. Held: finite losses,
    nonzero finite grad norms. Reported as ``train_dense`` (one more step
    traced: device ms, busy share, device ops), and for the SSD, from that
    trace, its device ms a step (``MAMBA.SSD_SPAN``: its forwards and
    recomputes, and its operators' backward) and their share of the step's,
    its ranges held to ``remat_calls``."""
    steps = TRAIN_FAMILY_STEPS
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV)
    opt = AdamW(lr=warmup_cosine(TRAIN["lr"], TRAIN["warmup"], steps))
    step, rec = _recorded(make_train_step(
        model, opt, microbatches=TRAIN["microbatches"]))
    put = None
    if needs_media(cfg):
        gen = torch.Generator(device=DEV).manual_seed(7)
        shape = media_spec(cfg, TRAIN["batch"])

        def put(b):
            out = {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}
            out["media"] = torch.randn(shape, generator=gen, device=DEV)
            return out
    tr = Trainer(step, init_train_state(model, opt, 0),
                 Pipeline(SyntheticSource(DataConfig(
                     seq, TRAIN["batch"], cfg.vocab))).start(),
                 TrainerConfig(total_steps=steps, log_every=10 ** 9),
                 put_batch=put)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    reset_launch_counts()           # counts = 0 just before the main path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()        # read just after
    peak = torch.cuda.max_memory_allocated()
    want = _train_launches(cfg, steps)
    problems = _launch_problems(tag, counts, want)
    report = _train_report(tr, rec, secs, TRAIN["batch"] * seq)
    if not all(math.isfinite(x) for x in report["losses"]):
        problems.append(f"losses {report['losses']}")
    if not all(math.isfinite(x) and x > 0 for x in report["grad_norms"]):
        problems.append(f"grad norms {report['grad_norms']}")
    profile = _train_profile(tr, f"{tag} step",
                             MAMBA.SSD_SPAN if cfg.ssm_state else None)
    tr.pipeline.stop()
    del tr, rec, model
    torch.cuda.empty_cache()
    ssd = profile.pop("span")
    if ssd is not None:
        ssd["calls_want"] = (remat_calls(cfg)["ssd_chunked"]
                             * TRAIN["microbatches"])
        if ssd["calls"] != ssd["calls_want"]:
            problems.append(f"ssd_chunked ran {ssd['calls']} times in the "
                            f"traced step, want {ssd['calls_want']}")
    say(tag, arch=cfg.name, n_layers=cfg.n_layers,
        n_enc_layers=cfg.n_enc_layers, dtype=cfg.dtype,
        shape=dict(TRAIN, seq=seq), steps=steps,
        params_billions=cfg.param_count() / 1e9, model_build_seconds=t_build,
        launches=counts, launches_want=want, peak_mem_gb=peak / 1e9,
        profile=profile, ssd=ssd, **report)
    for k in kernels:
        if k["name"] in ("flash_attention", "flash_attention_bwd"):
            k[f"{tag}_launches"] = counts[k["name"]]
    if problems:
        raise AssertionError(f"{tag}: " + "; ".join(problems))


def phase_train_ssm(kernels):
    """mamba2-130m at full width and depth (24 layers, d_model 768, the
    head tied to the embedding): ``_train_family``; no kernel launched (the
    SSD is plain PyTorch, as the reference's is ``jnp``)."""
    _train_family(kernels, "train_ssm", get_config(SSM["arch"]),
                  TRAIN["seq"])


def phase_train_hybrid(kernels):
    """zamba2-2.7b at full width, cut to ``TRAIN_HYBRID_LAYERS`` of its 54
    layers (two applications of the shared block, 32 heads of 80):
    ``_train_family``; K3 and its backward at head_dim 80, 2 x and 1 x the
    applications a microbatch (the mamba layers nested in the checkpointed
    groups)."""
    cfg = dataclasses.replace(get_config(HYBRID["arch"]),
                              n_layers=TRAIN_HYBRID_LAYERS)
    _train_family(kernels, "train_hybrid", cfg, TRAIN["seq"])


def phase_train_encdec(kernels):
    """whisper-medium at full width and depth (24 + 24 layers, 16 heads of
    64) over ``TRAIN_ENCDEC_SEQ`` tokens, each row with its frames [1500,
    1024]: ``_train_family``; K3 and its backward over the causal encoder
    (S = T = 1500), the decoder's causal self-attention and its non-causal
    cross read (448 queries over 1500 frames), 2 x and 1 x (24 + 2 x 24) a
    microbatch."""
    _train_family(kernels, "train_encdec", get_config(ENCDEC["arch"]),
                  TRAIN_ENCDEC_SEQ)


def _sharded_seq(cfg):
    """The tokens a row of ``cfg``'s train_sharded batches: TRAIN's, but
    whisper's decoder context (``TRAIN_ENCDEC_SEQ``)."""
    return TRAIN_ENCDEC_SEQ if cfg.n_enc_layers else TRAIN["seq"]


def _sharded_model(cfg, mode):
    """``cfg``'s model on the card, weights from seed 0 (the VLM's gates
    from seed 9: at zero every cross gradient would be zero)."""
    kw = {"dispatch_mode": mode} if mode else {}
    model = build_model(cfg, device=DEV, max_seq=_sharded_seq(cfg),
                        **kw).init(0)
    return _seed_gates(model, 9) if model.is_vlm else model


def _sharded_batches(cfg):
    """``i -> `` the TRAIN batch ``i`` of ``cfg`` on the card, with frames or
    image embeddings drawn on the card from seed ``7 + i`` where the model
    reads them."""
    src = SyntheticSource(DataConfig(_sharded_seq(cfg), TRAIN["batch"],
                                     cfg.vocab))

    def batch(i):
        out = {k: torch.as_tensor(v, device=DEV)
               for k, v in src.batch_at(i).items()}
        if needs_media(cfg):
            gen = torch.Generator(device=DEV).manual_seed(7 + i)
            out["media"] = torch.randn(media_spec(cfg, TRAIN["batch"]),
                                       generator=gen, device=DEV)
        return out
    return batch


def _grad_tolerance(ref, noise=None):
    """``parity_train``'s tolerance of a gradient leaf whose reference is
    ``ref``: ``PARITY_GRAD_RTOL`` of its largest entry; for a 0-d leaf also
    ``ZERO_D_NOISE_K`` x ``noise``, its own noise floor (the larger of the
    two)."""
    tol = PARITY_GRAD_RTOL * float(ref.abs().max())
    if noise is not None:
        tol = max(tol, ZERO_D_NOISE_K * noise)
    return max(tol, 1e-30)


def _grad_share(grads, ref, noise):
    """The worst leaf of ``grads`` against ``ref``: (its largest difference
    over its tolerance, its name); ``noise`` the 0-d leaves' floors."""
    share, worst = 0.0, None
    for k, g in grads.items():
        x = float((g - ref[k]).abs().max()) / _grad_tolerance(
            ref[k], noise.get(k))
        if x > share:
            share, worst = x, k
    return share, worst


def _sharded_fp32_arm(cfg, shape, mode):
    """One fp32 step of ``cfg`` unsharded and on a ``(data, model)`` mesh of
    ``shape`` virtual devices from the same weights and TRAIN batch (media
    included): the launches and collective bytes of the sharded step
    (counts set to 0 just before it, read just after), and
    ``parity_train``'s rule between the two (the unsharded step standing
    where the CPU stood). Where the model has 0-d parameters (the VLM's
    gates), the unsharded step again at twice the microbatches gives each
    its noise floor (``ZERO_D_NOISE_K``), and a control must fail the same
    comparison: the sharded gradients with each 0-d leaf's summed over
    ``model`` once more (``model`` x its value)."""
    P = TRAIN
    n_hot = 0
    n_dev = math.prod(shape)
    kw = {"dispatch_mode": mode} if mode else {}
    base = _sharded_model(cfg, mode)
    copies = []
    for _ in range(2 if any(p.dim() == 0 for p in base.parameters()) else 1):
        copies.append(build_model(cfg, device=DEV,
                                  max_seq=_sharded_seq(cfg), **kw))
        copies[-1].load_state_dict(base.state_dict())
    batch = _sharded_batches(cfg)(0)
    lr = warmup_cosine(P["lr"], P["warmup"], 1)
    mb = P["microbatches"]
    runs = {}
    for name, m, par, k_mb in (
            ("unsharded", base, None, mb),
            ("sharded", copies[0], ParallelConfig(shape, ("data", "model")),
             mb),
            ("noise", copies[-1] if len(copies) > 1 else None, None,
             2 * mb)):
        if m is None:
            continue
        opt = _KeptGrads(AdamW(lr=lr), device=DEV)
        with virtual_devices(n_dev):
            st = init_train_state(m, opt, None, n_hot, parallel=par)
        step = make_train_step(m, opt, microbatches=k_mb, mesh=st.mesh)
        torch.cuda.synchronize()
        reset_launch_counts()           # counts = 0 just before the step
        reset_collective_counts()
        st, met = step(st, batch)
        torch.cuda.synchronize()
        counts, moved = launch_counts(), collective_bytes()   # just after
        runs[name] = dict(
            loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
            lr=float(met["lr"]), grads=opt.kept[0], launches=counts,
            bytes=moved, plan=None if st.mesh is None
            else PARALLEL.MeshPlan(m, st.mesh),
            counts=None if st.expert_counts is None
            else st.expert_counts.cpu(),
            params={k: (v.gather() if isinstance(v, ShardedTensor)
                        else v).detach().clone()
                    for k, v in st.params.items()})
        del st, step, opt
    del base, copies
    torch.cuda.empty_cache()
    a, b = runs["sharded"], runs["unsharded"]
    problems = []
    noise = {k: float((g - b["grads"][k]).abs())
             for k, g in runs.get("noise", {"grads": {}})["grads"].items()
             if g.dim() == 0}
    grad_share, grad_worst = _grad_share(a["grads"], b["grads"], noise)
    if grad_share > 1.0:
        problems.append(f"a gradient leaf ({grad_worst}) errs {grad_share} "
                        f"x its tolerance")
    control = None
    if noise:
        m_size = a["plan"].m
        control = _grad_share({k: m_size * a["grads"][k] for k in noise},
                              b["grads"], noise)[0]
        if control <= 1.0:
            problems.append(f"the 0-d leaves summed twice over model pass "
                            f"({control} x their tolerance)")
    if abs(a["loss"] - b["loss"]) > 1e-5 * abs(b["loss"]) or \
            abs(a["grad_norm"] - b["grad_norm"]) > 1e-4 * b["grad_norm"] or \
            abs(a["lr"] - b["lr"]) > 1e-6 * abs(b["lr"]):
        problems.append(f"sharded {a['loss'], a['grad_norm'], a['lr']} "
                        f"unsharded {b['loss'], b['grad_norm'], b['lr']}")
    if mode and not torch.equal(a["counts"], b["counts"]):
        problems.append("expert counts differ")
    worst, held, over = 0.0, 0.0, []
    for k, v in a["params"].items():
        d = (v.detach() - b["params"][k]).abs().reshape(-1)
        worst = max(worst, float(d.max()))
        g = b["grads"][k].reshape(-1).abs()
        pinned = g > PARITY_GRAD_RTOL * g.max()
        n_held = int(((d > 1e-6) & pinned).sum())
        held = max(held, n_held / d.numel())
        if n_held > 1e-3 * d.numel():
            over.append((k, n_held, d.numel()))
    if worst > 3 * b["lr"] or over:
        problems.append(f"parameters part by {worst} (pinned entries past "
                        f"1e-6: {over})")
    want = {k: v * n_dev for k, v in _train_launches(
        cfg, 1, staged=mode == "staged").items()}
    problems += _launch_problems("sharded fp32 step", a["launches"], want)
    spec_bytes = PARALLEL.expected_collective_bytes(
        a["plan"], TRAIN_MB, _sharded_seq(cfg), P["microbatches"])
    if a["bytes"] != spec_bytes:
        problems.append(f"collective bytes {a['bytes']} != the specs' "
                        f"{spec_bytes}")
    plan = a["plan"]
    report = dict(
        loss=a["loss"], loss_unsharded=b["loss"],
        loss_rel_diff=abs(a["loss"] - b["loss"]) / abs(b["loss"]),
        grad_norm=a["grad_norm"], grad_norm_unsharded=b["grad_norm"],
        grad_leaf_worst_share_of_tol=grad_share, grad_leaf_worst=grad_worst,
        zero_d_grads={k: [float(b["grads"][k]), float(a["grads"][k]),
                          float(runs["noise"]["grads"][k])] for k in noise},
        zero_d_noise=noise, zero_d_control_share_of_tol=control,
        param_max_diff=worst,
        param_share_past_1e6_pinned=held, launches=a["launches"],
        launches_want=want, collective_bytes=a["bytes"],
        collective_bytes_spec=spec_bytes, scheme=plan.scheme,
        heads_run=plan.hp, vocab_lanes=plan.vp,
        experts_run=plan.ep or None)
    return report, problems


def _sharded_bf16_arm(cfg, shape, mode):
    """bf16 steps on the mesh (virtual devices of the card): one untimed
    (launches and collective bytes against the specs), one on the host
    clock, one traced (device ms, busy share, device ops, the largest
    kernels); the peak memory of the two timed steps."""
    P = TRAIN
    n_dev = math.prod(shape)
    seq = _sharded_seq(cfg)
    model = _sharded_model(cfg, mode)
    opt = AdamW(lr=warmup_cosine(P["lr"], P["warmup"], 3))
    with virtual_devices(n_dev):
        st = init_train_state(model, opt, None, 0, parallel=ParallelConfig(
            shape, ("data", "model")))
    step = make_train_step(model, opt, microbatches=P["microbatches"],
                           mesh=st.mesh)
    batches = _sharded_batches(cfg)
    holder = [st]

    def one(i):
        holder[0], met = step(holder[0], batches(i))
        return float(met["loss"])
    torch.cuda.synchronize()
    reset_launch_counts()
    reset_collective_counts()
    losses = [one(0)]
    torch.cuda.synchronize()
    counts, moved = launch_counts(), collective_bytes()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses.append(one(1))
    host_ms = (time.perf_counter() - t0) * 1e3
    rows = trace_rows(lambda: losses.append(one(2)), "train_sharded step")
    peak = torch.cuda.max_memory_allocated()
    dev_ms = sum(r[0] for r in rows) / 1e3
    spec_bytes = PARALLEL.expected_collective_bytes(
        PARALLEL.MeshPlan(model, st.mesh), TRAIN_MB, seq, P["microbatches"])
    problems = []
    if moved != spec_bytes:
        problems.append(f"bf16 collective bytes {moved} != the specs' "
                        f"{spec_bytes}")
    want = {k: v * n_dev for k, v in _train_launches(
        cfg, 1, staged=mode == "staged").items()}
    problems += _launch_problems("sharded bf16 step", counts, want)
    if not all(math.isfinite(x) for x in losses):
        problems.append(f"losses {losses}")
    del holder, st, step, model
    torch.cuda.empty_cache()
    return dict(losses=losses, step_host_ms=host_ms, device_ms=dev_ms,
                busy_share=dev_ms / host_ms if rows else None,
                device_ops=device_ops(rows), peak_mem_gb=peak / 1e9,
                tokens_per_s=P["batch"] * seq / host_ms * 1e3,
                launches=counts, collective_bytes=moved,
                collective_bytes_spec=spec_bytes,
                largest=[(r[2][:70], r[1], r[0] / 1e3) for r in rows[:6]]), \
        problems


def phase_train_sharded(kernels):
    """Training on a mesh of virtual devices of the card
    (``REPRO_TORCH_VIRTUAL_DEVICES``), seven arms (``TRAIN_SHARDED_ARMS``):
    stablelm-1.6b at full width on ``(data 2, model 2)`` (scheme ``heads``,
    the vocab split as it is), granite-moe-3b-a800m at full width, staged,
    on ``(2, 2)`` (24 q / 8 kv heads, 20 of the 40 experts a rank) and
    stablelm-1.6b on ``(1, 3)`` (scheme ``replicate``: 32 heads run as 33,
    the vocab as 100353 lanes), each cut to ``TRAIN_DENSE_LAYERS``; then
    on ``(2, 2)`` mamba2-130m at full width, 4 layers (``in_proj`` /
    ``out_proj`` FSDP over ``data``, every model rank running its rows'
    whole layer; the tied head the D-split table made whole over
    ``model``, its 50280 lanes cut in two), zamba2-2.7b at full width, 12
    layers (two applications of the shared block, 16 of its 32 heads of 80
    a rank), whisper-medium at full width, 4 + 4 layers over 448
    positions, each row with its frames [1500, 1024] (8 of 16 heads a rank
    in the causal encoder, the decoder's self and cross reads; its 51865
    vocab padded to 51866 lanes) and the VLM at its kernel geometry
    (``TRAIN_SHARDED_VLM``: scheme ``qheads_kvrepl``, 4 of 8 q heads a rank
    over the one kv head, 1601 image tokens, gates from a seed). Per arm:
    one fp32 step sharded and unsharded from the same weights and TRAIN
    batch held to ``parity_train``'s rule (the loss within 1e-5 and the
    grad norm within 1e-4 relative; every gradient leaf within
    ``PARITY_GRAD_RTOL`` of its largest entry, a 0-d leaf also within
    ``ZERO_D_NOISE_K`` x its noise floor, and a control that sums the 0-d
    leaves twice over ``model`` must fail; the new parameters within 3 x lr, at
    most 0.1 % of a leaf's entries past 1e-6 among those whose gradient is
    above ``PARITY_GRAD_RTOL`` of the leaf's largest; the expert counts
    equal);
    K3, its backward, the drain and its adjoint launched once per device
    for each unsharded launch (``remat_calls``); every collective's bytes
    equal to those the specs give (``expected_collective_bytes``); then
    bf16 steps: host ms, device ms, busy share, device ops, peak memory,
    tokens/s, launches and bytes again."""
    problems, arms = [], {}
    for tag, arch, over, shape, mode in TRAIN_SHARDED_ARMS:
        base = dataclasses.replace(get_config(arch), **over)
        t0 = time.perf_counter()
        fp32, found = _sharded_fp32_arm(
            dataclasses.replace(base, dtype="float32"), shape, mode)
        problems += [f"{tag} fp32: {p}" for p in found]
        bf16, found = _sharded_bf16_arm(base, shape, mode)
        problems += [f"{tag} bf16: {p}" for p in found]
        arms[tag] = dict(arch=arch, config=over, mesh=dict(
            zip(("data", "model"), shape)), dispatch=mode,
            seq=_sharded_seq(base), fp32=fp32, bf16=bf16,
            seconds=round(time.perf_counter() - t0, 1))
    # the launches of each arm's fp32 sharded step (K1 as its drain)
    for k in kernels:
        name = {"staged_scatter": "staged_drain"}.get(k["name"], k["name"])
        if name in ("flash_attention", "flash_attention_bwd",
                    "staged_drain", "staged_gather"):
            k["train_sharded_launches"] = {
                t: a["fp32"]["launches"].get(name, 0)
                for t, a in arms.items()}
    say("train_sharded", shape=TRAIN, virtual_devices=True, **arms)
    if problems:
        raise AssertionError("train_sharded: " + "; ".join(problems))
    return arms


def phase_roofline(sharded):
    """The dry-run count of ``ROOFLINE_ARM``'s step against the card. On
    the meta device: ``cells.build_cell`` of the arm's config, rows,
    sequence, microbatches and mesh shape, counted by
    ``roofline.count_step`` (FLOPs, bytes, collective bytes, transient peak,
    the kernels' would-be launches). On the card: the same step (the arm's
    model, placed on virtual devices, an int32 batch as the cell's) once,
    untimed, under the same counters. The bound of the four ranks on one
    card is the larger of the step's FLOPs, each dtype's at its peak (the
    fp32 head at 67 TFLOP/s), and its bytes at the HBM rate (the virtual collectives are the sums and copies the byte
    count holds); the arm's traced bf16 step is the measured time."""
    tag, arch, over, shape, mode = next(
        a for a in TRAIN_SHARDED_ARMS if a[0] == ROOFLINE_ARM)
    cfg = dataclasses.replace(get_config(arch), **over)
    P, n = TRAIN, math.prod(shape)
    seq = _sharded_seq(cfg)
    cell = ShapeSpec("train_sharded", seq, P["batch"], "train")
    t0 = time.perf_counter()
    step, args, _ = CELLS.build_cell(
        cfg, cell, make_abstract_mesh(shape, ("data", "model")),
        microbatches=P["microbatches"], dispatch_mode=mode or "staged")
    meta, meta_launches = ROOF.count_step(step, args, n)
    meta_s = time.perf_counter() - t0
    del step, args
    model = _sharded_model(cfg, mode)
    opt = CELLS.make_optimizer()
    with virtual_devices(n):
        st = init_train_state(model, opt, None, 0, parallel=ParallelConfig(
            shape, ("data", "model")))
    step = make_train_step(model, opt, microbatches=P["microbatches"],
                           mesh=st.mesh)
    gen = torch.Generator(device=DEV).manual_seed(11)
    batch = {k: torch.randint(0, cfg.vocab, (P["batch"], seq), generator=gen,
                              device=DEV, dtype=torch.int32)
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    reset_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card, card_launches = ROOF.count_step(step, (st, batch), n)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - base
    launched = {k: v for k, v in launch_counts().items() if v}
    del st, step, model, opt, batch
    torch.cuda.empty_cache()
    problems = []
    for k in sorted(set(meta) | set(card)):
        if k != "peak_bytes" and meta.get(k) != card.get(k):
            problems.append(f"{k}: meta {meta.get(k)} card {card.get(k)}")
    if meta_launches != card_launches or card_launches != launched:
        problems.append(f"launches: meta {meta_launches} card counter "
                        f"{card_launches} wrappers {launched}")
    meta_peak = meta["peak_bytes"] * n
    if abs(card_peak - meta_peak) > ROOFLINE_PEAK_RTOL * meta_peak \
            + ROOFLINE_PEAK_ATOL:
        problems.append(f"peak bytes: card {card_peak} meta {meta_peak}")
    flops, nbytes = meta["flops"] * n, meta["bytes"] * n
    t_ops = ROOF.compute_seconds(meta) * n
    bound_ms = max(t_ops, nbytes / ROOF.HBM_BW) * 1e3
    device = sharded[tag]["bf16"]["device_ms"]
    share = bound_ms / device if device else None
    if share is None or share > ROOFLINE_SHARE_MAX:
        problems.append(f"bound {bound_ms} ms over device {device} ms")
    cells = ROOF.roofline_terms(
        meta, cfg, cell, mesh_shape=dict(zip(("data", "model"), shape)))
    say("roofline", arm=tag, arch=arch, config=over,
        mesh=dict(zip(("data", "model"), shape)), seq=seq,
        rows=P["batch"], microbatches=P["microbatches"],
        meta_count_s=meta_s, flops=flops, bytes=nbytes,
        coll_bytes=meta["coll_bytes"] * n,
        collectives={k: v * n for k, v in meta.items()
                     if k.startswith("coll_") and ":" in k},
        launches=meta_launches, peak_bytes_meta=meta_peak,
        peak_bytes_card=card_peak,
        peak_card_over_meta=card_peak / meta_peak if meta_peak else None,
        flops_by_dtype={k[6:]: v * n for k, v in meta.items()
                        if k.startswith("flops:")},
        rank_balance=ROOF.rank_balance(meta), bound_ms=bound_ms,
        bound_by="operations" if t_ops >= nbytes / ROOF.HBM_BW
        else "bytes",
        device_ms=device, bound_share_of_device=share,
        terms_per_rank=cells, card_counts_equal=not problems)
    if problems:
        raise AssertionError("roofline: " + "; ".join(problems))


PHASE_SECONDS = {}


def timed(name, fn, *args):
    """Run one phase and keep its host-clock seconds for the ``done`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    return out


# every phase in order: (name, function, the phases whose results it takes)
PHASES = (
    ("env", phase_env, ()),
    ("build", phase_build, ()),
    ("kernels", phase_kernels, ()),
    ("engine", phase_engine, ("kernels",)),
    ("engine_sharded", phase_engine_sharded, ("kernels", "engine")),
    ("engine_chunked", phase_engine_chunked, ("kernels", "engine")),
    ("engine_prefix", phase_engine_prefix, ("kernels",)),
    ("engine_host_tier", phase_engine_host_tier, ("kernels",)),
    ("sampler", phase_sampler, ()),
    ("engine_sampled", phase_engine_sampled, ("kernels",)),
    ("engine_spec", phase_engine_spec, ("kernels", "engine_sampled")),
    ("loadtest", phase_loadtest, ("kernels",)),
    ("preempt", phase_preempt, ("kernels",)),
    ("lanes", phase_lanes, ("kernels",)),
    ("lanes_chunked", phase_lanes_chunked, ("kernels",)),
    ("parity", phase_parity, ()),
    ("parity_chunked", phase_parity_chunked, ()),
    ("write_engine", phase_write_engine, ("kernels",)),
    ("write_parity", phase_write_parity, ()),
    ("fig3", phase_fig3, ("kernels",)),
    ("engine_moe", phase_engine_moe, ("kernels",)),
    ("engine_ssm", phase_engine_ssm, ("kernels",)),
    ("engine_hybrid", phase_engine_hybrid, ("kernels",)),
    ("parity_ssm", phase_parity_ssm, ()),
    ("engine_encdec", phase_engine_encdec, ("kernels",)),
    ("parity_encdec", phase_parity_encdec, ()),
    ("engine_vlm", phase_engine_vlm, ("kernels",)),
    ("parity_vlm", phase_parity_vlm, ()),
    ("engine_ring_lanes", phase_engine_ring_lanes, ("kernels",)),
    ("parity_train", phase_parity_train, ()),
    ("train_dense", phase_train_dense, ("kernels",)),
    ("train_moe", phase_train_moe, ("kernels",)),
    ("train_ssm", phase_train_ssm, ("kernels",)),
    ("train_hybrid", phase_train_hybrid, ("kernels",)),
    ("train_encdec", phase_train_encdec, ("kernels",)),
    ("train_sharded", phase_train_sharded, ("kernels",)),
    ("roofline", phase_roofline, ("train_sharded",)),
)


def main(names=()):
    """Every phase in order. With ``names`` (``python3 chip_smoke.py PHASE
    ...``, to run a few phases while working on them): env, build, the
    named phases and the phases whose results they take, in the same
    order, and no result line."""
    known = [name for name, _, _ in PHASES]
    unknown = sorted(set(names) - set(known))
    if unknown:
        sys.exit(f"chip_smoke: unknown phases {unknown}; phases: {known}")
    chosen = set(names or known) | {"env", "build"}
    for name, _, needs in reversed(PHASES):
        if name in chosen:
            chosen.update(needs)
    t0 = time.perf_counter()
    results = {}
    for name, fn, needs in PHASES:
        if name in chosen:
            results[name] = timed(name, fn, *(results[n] for n in needs))
    say("done", seconds=round(time.perf_counter() - t0, 1),
        phase_seconds=PHASE_SECONDS,
        traces_without_device_time=TRACE_MISSES,
        traces_that_lost_events=TRACE_SHORT)
    if "kernels" in results:
        print(json.dumps({"kernels": results["kernels"]}), flush=True)
    print(results["env"], flush=True)
    if names:
        return
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
