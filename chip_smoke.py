#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # from the repository root

Phases, each reported on its own JSON line:

1. device: the card's name and power limit (``nvidia-smi``); build: every
   CUDA kernel compiled from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
2. parity: each retrieval kernel held against its plain torch version on
   the card, on the paper's 600-tree hospital corpus and a 6,000-tree
   one, at hit rates 0.1 and 0.9, with out-of-range tree ids and three
   temperature rounds — exact integer equality, dtypes included (the
   probe's bucket/slot on hits, where they are defined);
   attention_parity: the flash-attention and decode-attention kernels
   against their plain versions at the generator's heads (14/2/64),
   batch 4, prefill lengths 1-512 and per-row cache lengths 1-512, in f32
   (out and lse within 1e-5) and bf16 (out within 2^-6 |out| + 1e-6
   elementwise, lse within 1e-5);
3. path A: ``RAGPipeline`` (bank mode, on the card) answers the corpus's
   64 queries twice — 3,000 (tree, hash) queries each — through the
   arena-probe kernel; contexts must equal a CPU pipeline's;
4. path B: ``RetrievalSession(fused=True)`` serves the same global
   requests on the 600- and 6,000-tree states through the fused-retrieve
   kernel; all five fields must equal an unfused session's;
   path C: ``RAGPipeline.answer`` generates 16 tokens for 8 queries with
   ``paper-cftrag`` at full width in bf16 (random weights from a seeded
   generator, ``attn_impl="flash"``, cache 512, batch 4) through the
   probe and both attention kernels; checked teacher-forced against the
   plain path (``attn_impl="reference"``) on the same tokens — bf16
   logits within 0.15, and in a second f32 run logits within 1e-3 and
   greedy ids equal except at listed steps whose plain top-2 gap is below
   twice the measured logit delta;
5. profile: wall and device-busy time per request of the three paths
   under torch.profiler, with the top kernels; path C must show both
   attention kernels and no plain attention op;
6. kernels: per kernel its launches on the main path; kernel and plain
   device time per call (CUDA-graph replay, CUDA events) and eager time
   (back-to-back launches, host overhead included); the library call's
   time where one computes the same function (SDPA for attention); its
   bound from this run's bytes and operations.

Each path's launch counters are set to 0 just before it and read just
after.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside a checkout, the script exits non-zero and prints
no result.  The CPU parity of the same paths is ``tests/test_torch_*.py``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s; int32 at 16.7 Top/s
# = 132 SMs x 64 INT32 lanes x the 1.98 GHz implied by the 67 TFLOP/s
# fp32 rate (132 SMs x 128 lanes x 2 per FMA); dense bf16 tensor cores
# at 989 TFLOP/s, f32 at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# int32 operations per query, counted from the sources: hash, candidates,
# 2S compares (probe); plus CSR window and per-step walk work (fused).
PROBE_OPS_PER_QUERY = 65
WALK_OPS_PER_STEP = 6
MAX_LOCS, N_HIER = 4, 3
# path C: answers, new tokens per answer, KV cache rows, batch rows
ANSWERS, NEW_TOKENS, CACHE, BATCH = 8, 16, 512, 4
# path C's teacher-forced logit limits, kernel path against plain path:
# bf16 rounding of the activations; f32 summation order only
BF16_LOGIT_TOL, F32_LOGIT_TOL = 0.15, 1e-3
# plain attention ops that must not run on path C
PLAIN_ATTENTION_OPS = ("aten::softmax", "aten::_softmax", "aten::bmm",
                       "aten::einsum")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # f32 products in full f32 (no TF32) for the f32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.core import (CFTDeviceState, build_bank, build_forest,
                                  hashing)
    from repro_torch.core.trag import STATE_FIELDS
    from repro_torch.data import build_gazetteer, hospital_corpus, \
        recognize_entities
    from repro_torch.kernels import _build
    from repro_torch.kernels.cuckoo_lookup import kernel as probe_kernel
    from repro_torch.kernels.cuckoo_lookup import (cuckoo_lookup_arena,
                                                   cuckoo_lookup_arena_ref)
    from repro_torch.kernels.fused_retrieve import kernel as fused_kernel
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.fused_retrieve import (fused_retrieve_ragged,
                                                    fused_retrieve_ragged_ref)
    from repro_torch.models import lm
    from repro_torch.serving import (RAGPipeline, Request, RetrievalSession,
                                     ServeEngine)

    dev = torch.device("cuda")
    sizes = (600, 6000)
    sync = torch.cuda.synchronize

    # ------------------------------------------------------ 1. device, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gpu, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit(phase="device", nvidia_smi=smi, name=gpu, count=count,
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    libs = _build.build()
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3),
         libraries=sorted(p.name for p in libs.values()))

    # -------------------------------------------------------------- worlds
    class World:
        def __init__(self, num_trees):
            t0 = time.perf_counter()
            self.corpus = hospital_corpus(num_trees=num_trees)
            self.forest = build_forest(self.corpus.trees)
            self.bank = build_bank(self.forest)
            self.state = CFTDeviceState.from_bank(self.bank, self.forest,
                                                  device=dev)
            self.hashes = hashing.hash_entities(self.forest.entity_names)
            gaz = build_gazetteer(self.forest.entity_names)
            # global requests: each recognized entity fans out to every
            # tree, as RAGPipeline._device_query_batch does
            t = self.bank.num_trees
            self.requests = []
            for q in self.corpus.queries:
                h = hashing.hash_entities(recognize_entities(q, gaz))
                self.requests.append(
                    (np.repeat(np.arange(t, dtype=np.int32), h.size),
                     np.tile(h, t)))
            emit(phase="world", trees=num_trees,
                 nodes=self.forest.num_nodes,
                 entities=self.forest.num_entities,
                 arena=list(self.state.fingerprints.shape),
                 csr=int(self.state.csr_offsets.shape[0]),
                 state_bytes=sum(getattr(self.state, f).numel() * 4
                                 for f in STATE_FIELDS),
                 requests=len(self.requests),
                 queries_per_request=int(self.requests[0][0].size),
                 build_s=round(time.perf_counter() - t0, 3))

        def random_queries(self, batch, hit_rate, rng):
            """Hits drawn from stored (tree, entity) rows, misses random;
            1% of tree ids out of range."""
            b = self.bank
            rows = rng.integers(b.num_rows, size=batch)
            hit = rng.random(batch) < hit_rate
            tid = np.where(hit, b.row_tree[rows],
                           rng.integers(b.num_trees, size=batch))
            hh = np.where(hit, self.hashes[b.row_entity[rows]],
                          rng.integers(1, 2 ** 32, size=batch))
            oob = rng.random(batch) < 0.01
            tid = np.where(oob, rng.choice([-7, -1, b.num_trees,
                                            b.num_trees + 3], size=batch),
                           tid)
            return self.to_dev(tid, hh)

        def to_dev(self, tid, hh):
            return (torch.from_numpy(np.asarray(tid, np.int32)).to(dev),
                    torch.from_numpy(np.asarray(hh, np.int64)).to(dev))

        def routed(self, tid):
            """(row_offsets, masks) as retrieve_device routes queries."""
            st = self.state
            ok = (tid >= 0) & (tid < st.num_trees)
            t = torch.where(ok, tid, 0).long()
            return st.bucket_offsets[t], st.tree_nb[t] - 1

    worlds = [World(n) for n in sizes]

    def tensors(st):
        return (st.fingerprints, st.temperature, st.heads, st.bucket_offsets,
                st.tree_nb)

    def forest_tensors(st):
        return (st.csr_offsets, st.csr_nodes, st.parent, st.entity_id,
                st.child_offsets, st.child_index)

    def fused(st, tid, hh, plain):
        fn = fused_retrieve_ragged_ref if plain else fused_retrieve_ragged
        return fn(*tensors(st), tid, hh, *forest_tensors(st),
                  max_locs=MAX_LOCS, n=N_HIER)

    def diff(a, b, what, sel=None):
        """Max |a - b| after checking shape and dtype."""
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: {a.dtype}{tuple(a.shape)} vs {b.dtype}"
              f"{tuple(b.shape)}")
        a, b = a.long(), b.long()
        if sel is not None:
            a, b = a[sel], b[sel]
        return int((a - b).abs().max()) if a.numel() else 0

    # -------------------------------------------------------------- 2. parity
    rng = np.random.default_rng(0)
    err = {"arena_probe": 0, "fused_retrieve": 0}
    checked = {"arena_probe": 0, "fused_retrieve": 0}
    for w in worlds:
        batch = 5 * w.bank.num_trees
        for hit_rate in (0.1, 0.9):
            tid, hh = w.random_queries(batch, hit_rate, rng)
            off, mask = w.routed(tid)
            st = w.state
            k = cuckoo_lookup_arena(st.fingerprints, st.heads, off, mask, hh)
            p = cuckoo_lookup_arena_ref(st.fingerprints, st.heads, off, mask,
                                        hh)
            e = max(diff(k.hit, p.hit, "probe hit"),
                    diff(k.head, p.head, "probe head"),
                    diff(k.bucket, p.bucket, "probe bucket", p.hit),
                    diff(k.slot, p.slot, "probe slot", p.hit))
            err["arena_probe"] = max(err["arena_probe"], e)
            checked["arena_probe"] += batch
            sk = sp = st
            for rnd in range(3):
                tid, hh = w.random_queries(batch, hit_rate, rng)
                k, p = fused(sk, tid, hh, False), fused(sp, tid, hh, True)
                e = max(diff(getattr(k, f), getattr(p, f), f"fused {f}")
                        for f in k._fields)
                err["fused_retrieve"] = max(err["fused_retrieve"], e)
                checked["fused_retrieve"] += batch
                sk = sk.with_temperature(k.temperature)
                sp = sp.with_temperature(p.temperature)
            emit(phase="parity", trees=w.bank.num_trees, hit_rate=hit_rate,
                 queries=batch, max_abs_err=dict(err),
                 hits=int(p.hit.sum()), bumps=int(sk.temperature.sum()))
    check(all(v == 0 for v in err.values()),
          f"kernels disagree with their plain versions: {err}")

    # --------------------------------------------------- 2b. attention parity
    hq, hkv, hd = 14, 2, 64                      # paper-cftrag's heads
    gen = torch.Generator(device=dev).manual_seed(0)
    att_err = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def attn_check(key, dtype, got, want):
        """Max errors of (out, lse) against the plain version's; raises
        past the stated tolerance."""
        (out, lse), (w_out, w_lse) = got, want
        d_out = (out.float() - w_out.float()).abs()
        e_lse = float((lse - w_lse).abs().max())
        if dtype == torch.float32:
            ok = float(d_out.max()) <= 1e-5
        else:
            ok = bool((d_out <= w_out.float().abs() * 2 ** -6 + 1e-6).all())
        e = att_err.setdefault(key, {"cases": 0, "out": 0.0, "lse": 0.0})
        e["cases"] += 1
        e["out"] = max(e["out"], float(d_out.max()))
        e["lse"] = max(e["lse"], e_lse)
        check(ok and e_lse <= 1e-5, f"{key}: out {float(d_out.max())}, "
              f"lse {e_lse} past the tolerance")

    decode_lens = ((1, 255, 256, 300), (512, 300, 255, 1))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for length in (1, 64, 127, 128, 300, 457, 512):
            q, k, v = (randn(BATCH, h, length, hd).to(dtype)
                       for h in (hq, hkv, hkv))
            attn_check(f"flash_attention/{name}", dtype,
                       flash_attention(q, k, v, True, return_lse=True),
                       attention_ref(q, k, v, True, hd ** -0.5,
                                     return_lse=True))
        for lens in decode_lens:
            q = randn(BATCH, hq, hd).to(dtype)
            k, v = (randn(BATCH, hkv, CACHE, hd).to(dtype) for _ in range(2))
            cl = torch.tensor(lens, dtype=torch.int32, device=dev)
            attn_check(f"decode_attention/{name}", dtype,
                       decode_attention(q, k, v, cl, return_lse=True),
                       decode_attention_ref(q, k, v, cl, return_lse=True))
    torch.cuda.synchronize()
    emit(phase="attention_parity", heads=[hq, hkv, hd], batch=BATCH,
         prefill_lengths=[1, 64, 127, 128, 300, 457, 512],
         decode_cache_lens=decode_lens,
         tolerance={"float32": {"out": 1e-5, "lse": 1e-5},
                    "bfloat16": {"out": "2^-6 * |out| + 1e-6 elementwise",
                                 "lse": 1e-5}},
         max_abs_err=att_err)

    # ------------------------------------------------- 3. main path A (probe)
    w = worlds[0]
    pipe = RAGPipeline(w.corpus, None, use_bank=True, device=dev)
    cpu_pipe = RAGPipeline(w.corpus, None, use_bank=True, device="cpu")
    probe_kernel.LAUNCHES = fused_kernel.LAUNCHES = 0
    lat_a, contexts = [], []
    for _ in range(2):
        for q in w.corpus.queries:
            t0 = time.perf_counter()
            contexts.append(pipe.retrieve(q).context)
            sync()
            lat_a.append(time.perf_counter() - t0)
    launches_a = (probe_kernel.LAUNCHES, fused_kernel.LAUNCHES)
    want = [cpu_pipe.retrieve(q).context for _ in range(2)
            for q in w.corpus.queries]
    check(contexts == want, "path A contexts differ from the CPU pipeline")
    check(torch.equal(pipe._dev_state.temperature.cpu(),
                      cpu_pipe._dev_state.temperature),
          "path A temperature differs from the CPU pipeline")
    check(launches_a[0] == len(lat_a) and launches_a[1] == 0,
          f"path A launches {launches_a}")
    req_a = len(lat_a)
    emit(phase="path_a", entry="RAGPipeline.retrieve", requests=req_a,
         queries_per_request=int(w.requests[0][0].size),
         probe_launches=launches_a[0], fused_launches=launches_a[1],
         latency_ms_p50=statistics.median(lat_a) * 1e3,
         latency_ms_max=max(lat_a) * 1e3,
         hits=int(pipe._dev_state.temperature.sum()),
         contexts_match_cpu=True)

    # ------------------------------------------------- 4. main path B (fused)
    sessions = []
    for w in worlds:
        fus, unf = RetrievalSession(), RetrievalSession()
        fus.attach(w.state, fused=True)
        unf.attach(w.state)
        sessions.append((w, fus, unf))
    probe_kernel.LAUNCHES = fused_kernel.LAUNCHES = 0
    lat_b = {}
    outs = []
    for w, fus, _ in sessions:
        lat_b[w.bank.num_trees] = []
        for tid, hh in w.requests[:8]:
            t0 = time.perf_counter()
            out = fus.retrieve(tid.tolist(), hh.tolist())
            sync()
            lat_b[w.bank.num_trees].append(time.perf_counter() - t0)
            outs.append(out)
    launches_b = (probe_kernel.LAUNCHES, fused_kernel.LAUNCHES)
    i = 0
    for w, fus, unf in sessions:
        for tid, hh in w.requests[:8]:
            want = unf.retrieve(tid.tolist(), hh.tolist())
            for f in want._fields:
                check(diff(getattr(outs[i], f), getattr(want, f),
                           f"path B {f}") == 0,
                      f"path B {f} differs from the unfused session")
            i += 1
        check(torch.equal(fus.state.temperature, unf.state.temperature),
              "path B threaded temperature differs")
    req_b = len(outs)
    check(launches_b[1] == req_b and launches_b[0] == 0,
          f"path B launches {launches_b}")
    emit(phase="path_b", entry="RetrievalSession.retrieve(fused=True)",
         requests=req_b, probe_launches=launches_b[0],
         fused_launches=launches_b[1],
         latency_ms_p50={t: statistics.median(v) * 1e3
                         for t, v in lat_b.items()},
         padded_queries={w.bank.num_trees: int(fus.pad_queries(
             *w.requests[0])[0].shape[0]) for w, fus, _ in sessions},
         identical_to_unfused=True)

    # ------------------------------------------- 4b. main path C (answer)
    cfg = get_arch("paper-cftrag").replace(attn_impl="flash")
    corpus = worlds[0].corpus
    queries = corpus.queries[:ANSWERS]
    counters = {"arena_probe": probe_kernel, "fused_retrieve": fused_kernel,
                "flash_attention": flash_kernel,
                "decode_attention": decode_kernel}

    def generator_pipeline(run_cfg):
        """The answer pipeline on the card with random weights drawn from
        a seeded generator on the card."""
        params = lm.init_params(
            run_cfg, torch.Generator(device=dev).manual_seed(0), dev)
        return RAGPipeline(corpus, ServeEngine(run_cfg, params,
                                               cache_size=CACHE,
                                               batch_size=BATCH),
                           use_bank=True, device=dev)

    def run_answers(pipe):
        lat, answers = [], []
        for q in queries:
            t0 = time.perf_counter()
            answers.append(pipe.answer(q, max_new_tokens=NEW_TOKENS))
            sync()
            lat.append(time.perf_counter() - t0)
        return answers, lat

    def forced(pipe, run_cfg, ans):
        """Row-0 logits (steps, V) when the answer's batch is prefilled
        and decoded on its own ids (teacher forcing); the prompt's length
        in the batch, prefill seconds and per-token decode seconds."""
        eng = pipe.engine
        toks, _ = eng.pack([Request(pipe.tokenizer.encode(ans.prompt,
                                                          bos=True),
                                    NEW_TOKENS)])
        with torch.inference_mode():
            sync()
            t0 = time.perf_counter()
            logits, state = lm.prefill(
                run_cfg, eng.params,
                {"tokens": torch.from_numpy(toks).to(dev)}, eng.cache_size)
            sync()
            t_pre, t_dec, rows = time.perf_counter() - t0, [], [logits[0, -1]]
            for f in ans.output_ids[:-1]:
                tok = lm.greedy_token(logits)
                tok[0, 0] = f
                t0 = time.perf_counter()
                logits, state = lm.decode_step(run_cfg, eng.params, tok,
                                               state)
                sync()
                t_dec.append(time.perf_counter() - t0)
                rows.append(logits[0, -1])
        return torch.stack(rows), toks.shape[1], t_pre, t_dec

    def teacher_forced(pipe, answers):
        """Kernel path and plain path (attn_impl="reference": the plain
        attention on both steps) on the kernel path's tokens."""
        run_cfg = pipe.engine.cfg
        out = []
        for a in answers:
            k_rows, plen, t_pre, t_dec = forced(pipe, run_cfg, a)
            p_rows = forced(pipe, run_cfg.replace(attn_impl="reference"),
                            a)[0]
            check(k_rows.shape == (NEW_TOKENS, cfg.padded_vocab)
                  and bool(torch.isfinite(k_rows).all()),
                  f"path C logits {tuple(k_rows.shape)} not finite")
            check(k_rows.argmax(-1).tolist() == a.output_ids,
                  "path C: the kernel path's replay does not reproduce "
                  "its answer's ids")
            out.append((k_rows, p_rows, plen, t_pre, t_dec))
        delta = max(float((k - p).abs().max()) for k, p, *_ in out)
        return out, delta

    pipe_c = generator_pipeline(cfg)
    pipe_c.answer(corpus.queries[ANSWERS], max_new_tokens=2)   # warm-up
    sync()
    for mod in counters.values():
        mod.LAUNCHES = 0
    answers, lat_c = run_answers(pipe_c)
    launches_c = {name: mod.LAUNCHES for name, mod in counters.items()}
    per_answer = {"arena_probe": 1, "fused_retrieve": 0,
                  "flash_attention": cfg.n_layers,
                  "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}
    check(launches_c == {k: v * ANSWERS for k, v in per_answer.items()},
          f"path C launches {launches_c}, want {per_answer} per answer")
    check(all(len(a.output_ids) == NEW_TOKENS and a.text for a in answers),
          "path C answers lack ids or text")
    forced_bf16, delta_bf16 = teacher_forced(pipe_c, answers)
    check(delta_bf16 <= BF16_LOGIT_TOL, f"path C bf16 logits differ from "
          f"the plain path by {delta_bf16} > {BF16_LOGIT_TOL}")

    cfg32 = cfg.replace(dtype="float32")
    pipe32 = generator_pipeline(cfg32)
    answers32, _ = run_answers(pipe32)
    forced_f32, delta_f32 = teacher_forced(pipe32, answers32)
    check(delta_f32 <= F32_LOGIT_TOL, f"path C f32 logits differ from the "
          f"plain path by {delta_f32} > {F32_LOGIT_TOL}")
    flips, steps_equal = [], 0
    for i, (a, (_, p_rows, *_)) in enumerate(zip(answers32, forced_f32)):
        top2 = p_rows.topk(2, dim=-1).values
        for t, want in enumerate(a.output_ids):
            if int(p_rows[t].argmax()) == want:
                steps_equal += 1
                continue
            gap = float(top2[t, 0] - top2[t, 1])
            flips.append({"answer": i, "step": t, "plain_top2_gap": gap})
            check(gap < 2 * delta_f32, f"path C f32: answer {i} step {t} "
                  f"differs from the plain path with top-2 gap {gap} >= "
                  f"2 x logit delta {delta_f32}")
    prefill_lens = [plen for _, _, plen, _, _ in forced_bf16]
    t_dec = [t for *_, td in forced_bf16 for t in td]
    emit(phase="path_c", entry="RAGPipeline.answer", arch=cfg.arch_id,
         attn_impl=cfg.attn_impl, dtype=cfg.dtype,
         params=lm.param_count(cfg), answers=ANSWERS, new_tokens=NEW_TOKENS,
         batch_rows=BATCH, cache_size=CACHE,
         prompt_tokens=[len(pipe_c.tokenizer.encode(a.prompt, bos=True))
                        for a in answers],
         prefill_tokens=prefill_lens, launches=launches_c,
         launches_per_answer={k: v / ANSWERS for k, v in launches_c.items()},
         latency_ms_p50=statistics.median(lat_c) * 1e3,
         latency_ms_max=max(lat_c) * 1e3,
         tokens_per_s=ANSWERS * NEW_TOKENS / sum(lat_c),
         prefill_ms_p50=statistics.median(
             t for _, _, _, t, _ in forced_bf16) * 1e3,
         decode_ms_per_token_p50=statistics.median(t_dec) * 1e3,
         teacher_forced_steps=NEW_TOKENS * ANSWERS,
         bf16_max_abs_logit_delta=delta_bf16, bf16_tolerance=BF16_LOGIT_TOL,
         f32_max_abs_logit_delta=delta_f32, f32_tolerance=F32_LOGIT_TOL,
         f32_steps_ids_equal_plain=steps_equal, f32_flips=flips,
         first_text=answers[0].text)
    del pipe32, forced_f32, forced_bf16

    # --------------------------------------------- 5. where the time goes
    def profile_requests(serve, n=8):
        """Wall and device-busy ms per request over n requests under
        torch.profiler; device time sums the CUDA kernel events (None when
        the profiler reports none).  Also returns every event name."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        serve(0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                serve(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        dev = sum(getattr(e, "self_device_time_total", 0) for e in kern)
        dev = dev / 1e3 / n if dev else None
        top = sorted(kern, key=lambda e: -getattr(
            e, "self_device_time_total", 0))[:5]
        return dict(wall_ms=wall, device_ms=dev,
                    idle_share=None if dev is None else 1 - dev / wall,
                    top_kernels=[[e.key[:60], getattr(
                        e, "self_device_time_total", 0) / 1e3 / n]
                        for e in top]), {e.key for e in prof.key_averages()}

    prof = {"path_a": profile_requests(
        lambda i: pipe.retrieve(worlds[0].corpus.queries[i]))[0]}
    for w, fus, _ in sessions:
        prof[f"path_b_{w.bank.num_trees}"] = profile_requests(
            lambda i, w=w, fus=fus: fus.retrieve(
                w.requests[i][0].tolist(), w.requests[i][1].tolist()))[0]
    prof["path_c"], names = profile_requests(
        lambda i: pipe_c.answer(queries[i], max_new_tokens=NEW_TOKENS), n=2)
    kernels_c = [k for k in names if "flash_fwd_kernel" in k
                 or "decode_kernel" in k]
    plain_c = sorted(k for k in names if k in PLAIN_ATTENTION_OPS)
    check(len(kernels_c) >= 2 and not plain_c,
          f"path C profile: attention kernels {kernels_c}, plain attention "
          f"ops {plain_c}")
    prof["path_c"]["attention_kernels"] = sorted(k[:60] for k in kernels_c)
    prof["path_c"]["plain_attention_ops"] = plain_c
    emit(phase="profile", per_request=prof)

    # ------------------------------------------------------ 6. kernel times
    def time_ms(fn, reps=50, rounds=5):
        """Eager time per call: median over rounds of (events around
        `reps` back-to-back calls) / reps, after warm-up.  Host launch
        overhead is included wherever the host is the slower side."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(rounds):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            per.append(s.elapsed_time(e) / reps)
        return statistics.median(per)

    def graph_ms(fn, reps=20):
        """Device time per call: `reps` calls captured in one CUDA graph
        and replayed, so host launch overhead is excluded."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        return time_ms(g.replay, reps=5) / reps

    def timings(kernel_fn, plain_fn):
        return dict(ms=graph_ms(kernel_fn), plain_ms=graph_ms(plain_fn),
                    eager_ms=time_ms(kernel_fn),
                    plain_eager_ms=time_ms(plain_fn))

    def bound(nbytes, ops, rate=INT32_OPS_PER_S, unit="int_ops"):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
        return {"bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, unit: ops}

    def probe_cost(w, tid, hh):
        """Times and bound at one request's shape.  Bytes: h/offset/mask
        in and hit/head/bucket/slot out per query, the distinct candidate
        fingerprint rows, one head per hit."""
        st = w.state
        off, mask = w.routed(tid)
        args = (st.fingerprints, st.heads, off, mask, hh)
        res = cuckoo_lookup_arena_ref(*args)
        fp, i1, i2 = hashing.candidate_buckets_masked(hh, mask)
        rows = torch.unique(torch.cat([off.long() + i1, off.long() + i2]))
        b, s = hh.shape[0], st.fingerprints.shape[1]
        nbytes = (b * 12 + rows.numel() * s * 4 + int(res.hit.sum()) * 4
                  + b * 13)
        return dict(timings(lambda: cuckoo_lookup_arena(*args),
                            lambda: cuckoo_lookup_arena_ref(*args)),
                    **bound(nbytes, b * PROBE_OPS_PER_QUERY))

    def fused_cost(w, tid, hh):
        """As probe_cost for the fused step.  Bytes: h/tree id in and
        hit/locations/up/down out per query, the routing entries of the
        trees touched, the distinct candidate rows, the temperature table
        read and written whole (the step returns a new one), and the CSR
        and forest entries this run's outputs show were read."""
        st = w.state
        p = fused(st, tid, hh, True)
        off, mask = w.routed(tid)
        fp, i1, i2 = hashing.candidate_buckets_masked(hh, mask)
        rows = torch.unique(torch.cat([off.long() + i1, off.long() + i2]))
        b, s = hh.shape[0], st.fingerprints.shape[1]
        a = st.fingerprints.shape[0]
        trees = torch.unique(tid.clamp(0, st.num_trees - 1)).numel()
        hits = int(p.hit.sum())
        locs = int((p.locations >= 0).sum())
        nnz_up = int((p.up >= 0).sum())
        nnz_down = int((p.down >= 0).sum())
        forest_reads = (2 * hits + locs + (locs + nnz_up) + nnz_up
                        + 2 * (locs + nnz_down) + 2 * nnz_down)
        nbytes = (b * 8 + trees * 8 + rows.numel() * s * 4 + hits * 4
                  + 2 * a * s * 4 + forest_reads * 4
                  + b * (1 + MAX_LOCS * 4 + 2 * MAX_LOCS * N_HIER * 4))
        ops = b * (PROBE_OPS_PER_QUERY + 10) + WALK_OPS_PER_STEP * (
            locs * 2 * N_HIER)
        return dict(timings(lambda: fused(st, tid, hh, False),
                            lambda: fused(st, tid, hh, True)),
                    **bound(nbytes, ops))

    rows_out = []
    for name, route, src, replaces, cost, launches, requests in (
            ("arena_probe", "cuda",
             "src/repro_torch/kernels/csrc/arena_probe.cu",
             "src/repro/kernels/cuckoo_lookup/kernel.py:321", probe_cost,
             launches_a[0], req_a),
            ("fused_retrieve", "cuda",
             "src/repro_torch/kernels/csrc/fused_retrieve.cu",
             "src/repro/kernels/fused_retrieve/kernel.py:317", fused_cost,
             launches_b[1], req_b)):
        at = {}
        for w in worlds:
            tid, hh = w.to_dev(*w.requests[0])
            at[w.bank.num_trees] = dict(queries=int(tid.shape[0]),
                                        **cost(w, tid, hh))
        main = at[sizes[0]]
        rows_out.append(dict(
            name=name, route=route, source=src, replaces=replaces,
            launches=launches, launches_per_request=launches / requests,
            identical=err[name] == 0, max_abs_err=err[name],
            checked_queries=checked[name], ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None,
            eager_ms=main["eager_ms"], plain_eager_ms=main["plain_eager_ms"],
            shape_queries=main["queries"], by_trees=at))

    # attention at path C's shapes: the longest prefill, and the last
    # decode step of that prompt (its valid prefix), bf16
    length = max(prefill_lens)
    n_valid = length + NEW_TOKENS - 1
    bf16, esz = torch.bfloat16, 2
    q, k, v = (randn(BATCH, h, length, hd).to(bf16) for h in (hq, hkv, hkv))
    flash_args = (q, k, v, True)
    # each input read once, out and lse written once; QK^T and P.V over
    # the length * (length + 1) / 2 visible pairs, 2 FLOPs per multiply-add
    flash_bytes = (esz * (2 * BATCH * hq * length * hd
                          + 2 * BATCH * hkv * length * hd)
                   + 4 * BATCH * hq * length)
    flash_flops = 2 * BATCH * hq * hd * length * (length + 1)
    qd = randn(BATCH, hq, hd).to(bf16)
    kd, vd = (randn(BATCH, hkv, CACHE, hd).to(bf16) for _ in range(2))
    cl = torch.full((BATCH,), n_valid, dtype=torch.int32, device=dev)
    mask = (torch.arange(CACHE, device=dev)[None, :]
            < cl[:, None])[:, None, None, :]
    # q, the valid prefix of k and v, cache_len read; out and lse written
    decode_bytes = (esz * (2 * BATCH * hq * hd
                           + 2 * BATCH * hkv * n_valid * hd)
                    + 4 * BATCH * hq + 4 * BATCH)
    decode_flops = 4 * BATCH * hq * n_valid * hd
    for name, src, replaces, kernel_fn, plain_fn, library_fn, nbytes, \
            flops, shape in (
            ("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:70",
             lambda: flash_attention(*flash_args),
             lambda: attention_ref(*flash_args, hd ** -0.5),
             lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, scale=hd ** -0.5, enable_gqa=True),
             flash_bytes, flash_flops,
             {"q": list(q.shape), "kv": list(k.shape), "causal": True}),
            ("decode_attention",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:63",
             lambda: decode_attention(qd, kd, vd, cl),
             lambda: decode_attention_ref(qd, kd, vd, cl),
             lambda: F.scaled_dot_product_attention(
                 qd[:, :, None], kd, vd, attn_mask=mask, scale=hd ** -0.5,
                 enable_gqa=True),
             decode_bytes, decode_flops,
             {"q": list(qd.shape), "kv": list(kd.shape),
              "cache_len": [n_valid] * BATCH})):
        t = timings(kernel_fn, plain_fn)
        b = bound(nbytes, flops, FLOPS_PER_S["bfloat16"], "flops")
        e = att_err[f"{name}/bfloat16"]
        rows_out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches_c[name],
            launches_per_request=launches_c[name] / ANSWERS,
            max_abs_err=e["out"], lse_max_abs_err=e["lse"],
            dtype="bfloat16", ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=b["bound_ms"], bound_by=b["bound_by"],
            library_ms=graph_ms(library_fn), eager_ms=t["eager_ms"],
            plain_eager_ms=t["plain_eager_ms"], bytes=nbytes, flops=flops,
            shape=shape))
    emit(kernels=rows_out)
    emit(ok=True, device={"platform": "gpu", "kind": gpu, "count": count})
    return 0


if __name__ == "__main__":
    sys.exit(main())
