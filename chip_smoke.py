#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # from the repository root

Phases, each reported on its own JSON line:

1. device: the card's name and power limit (``nvidia-smi``); build: every
   CUDA kernel compiled from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
2. parity: each kernel held against its plain torch version on the card,
   on the paper's 600-tree hospital corpus and a 6,000-tree one, at hit
   rates 0.1 and 0.9, with out-of-range tree ids and three temperature
   rounds — exact integer equality, dtypes included (the probe's
   bucket/slot on hits, where they are defined);
3. path A: ``RAGPipeline`` (bank mode, on the card) answers the corpus's
   64 queries twice — 3,000 (tree, hash) queries each — through the
   arena-probe kernel; contexts must equal a CPU pipeline's;
4. path B: ``RetrievalSession(fused=True)`` serves the same global
   requests on the 600- and 6,000-tree states through the fused-retrieve
   kernel; all five fields must equal an unfused session's;
5. profile: wall and device-busy time per request of both paths under
   torch.profiler, with the top kernels;
6. kernels: per kernel its launches on the main path; kernel and plain
   device time per call (CUDA-graph replay, CUDA events) and eager time
   (back-to-back launches, host overhead included); its bound from this
   run's bytes and operations.

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
# fp32 rate (132 SMs x 128 lanes x 2 per FMA).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per query, counted from the sources: hash, candidates,
# 2S compares (probe); plus CSR window and per-step walk work (fused).
PROBE_OPS_PER_QUERY = 65
WALK_OPS_PER_STEP = 6
MAX_LOCS, N_HIER = 4, 3


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
    from repro_torch.kernels.fused_retrieve import (fused_retrieve_ragged,
                                                    fused_retrieve_ragged_ref)
    from repro_torch.serving import RAGPipeline, RetrievalSession

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

    # --------------------------------------------- 5. where the time goes
    def profile_requests(serve, n=8):
        """Wall and device-busy ms per request over n requests under
        torch.profiler; device time sums the CUDA kernel events (None when
        the profiler reports none)."""
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
                        for e in top])

    prof = {"path_a": profile_requests(
        lambda i: pipe.retrieve(worlds[0].corpus.queries[i]))}
    for w, fus, _ in sessions:
        prof[f"path_b_{w.bank.num_trees}"] = profile_requests(
            lambda i, w=w, fus=fus: fus.retrieve(
                w.requests[i][0].tolist(), w.requests[i][1].tolist()))
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

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bytes=nbytes, int_ops=ops)

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
    emit(kernels=rows_out)
    emit(ok=True, device={"platform": "gpu", "kind": gpu, "count": count})
    return 0


if __name__ == "__main__":
    sys.exit(main())
