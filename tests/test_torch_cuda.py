"""Card-only tests of the port's CUDA kernels: each kernel against its
plain torch version on the same CUDA tensors — exact integer equality
with dtypes for the retrieval kernels (the probe's bucket/slot on hits);
for the attention kernels f32 out and lse within 1e-5 (another summation
order in f32), bf16 out within 2^-6 |out| + 1e-6 elementwise (two bf16
ulps: both round an f32 result) and lse within 1e-5; for the flash
backward f32 dq/dk/dv within 1e-4 of the gradient's scale (summation
order; the scale is the largest |grad| or 1, since at length 1 dq is
zero up to rounding) and bf16 within 2^-6 |grad| + 1e-4 of that scale,
elementwise — and one ``RAGPipeline.answer`` and one smoke-config train
step on the card against the same on the CPU.
Skips without a CUDA device; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no jax, so it runs where only torch is installed."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import (CFTDeviceState, build_bank, build_forest,
                              hashing, retrieve_device)
from repro_torch.data import (HashTokenizer, PackedBatches, TextDataset,
                              hospital_corpus)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.cuckoo_lookup import (cuckoo_lookup_arena,
                                               cuckoo_lookup_arena_ref)
from repro_torch.kernels.cuckoo_lookup import kernel as probe_kernel
from repro_torch.kernels.fused_retrieve import (fused_retrieve_ragged,
                                                fused_retrieve_ragged_ref)
from repro_torch.kernels.fused_retrieve import kernel as fused_kernel
from repro_torch.models import lm
from repro_torch.models.transformer import tree_leaves
from repro_torch.serving import RAGPipeline, ServeEngine
from repro_torch.training import AdamWConfig, adamw_init, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _world(num_trees, seed, device):
    """Skewed forest: every 7th tree a deep hub with a random-parent
    tail; a few empty trees."""
    rng = np.random.default_rng(seed)
    trees = []
    for t in range(num_trees):
        size = 0 if t % 11 == 5 else int(rng.integers(1, 9))
        names = [f"e{t}_{i}" for i in range(size)]
        edges = [(f"r{t}", n) for n in names]
        if t % 7 == 0 and names:
            for j in range(40):
                parent = names[int(rng.integers(len(names)))]
                edges.append((parent, f"e{t}_h{j}"))
                names.append(f"e{t}_h{j}")
        trees.append(edges)
    forest = build_forest(trees)
    bank = build_bank(forest)
    return bank, forest, CFTDeviceState.from_bank(bank, forest, device=device)


def _queries(bank, forest, batch, hit_rate, rng, device):
    hashes = hashing.hash_entities(forest.entity_names)
    rows = rng.integers(bank.num_rows, size=batch)
    hit = rng.random(batch) < hit_rate
    tid = np.where(hit, bank.row_tree[rows],
                   rng.integers(bank.num_trees, size=batch))
    hh = np.where(hit, hashes[bank.row_entity[rows]],
                  rng.integers(0, 2 ** 32, size=batch))
    tid[:4] = [-3, bank.num_trees, bank.num_trees + 9, -1]
    return (torch.from_numpy(tid.astype(np.int32)).to(device),
            torch.from_numpy(hh.astype(np.int64)).to(device))


def _tables(st):
    return (st.fingerprints, st.temperature, st.heads, st.bucket_offsets,
            st.tree_nb)


def _context(st):
    return (st.csr_offsets, st.csr_nodes, st.parent, st.entity_id,
            st.child_offsets, st.child_index)


def _same(a, b, what, sel=None):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if sel is not None:
        a, b = a[sel], b[sel]
    assert torch.equal(a, b), what


@pytest.mark.parametrize("hit_rate", [0.1, 0.9])
def test_probe_matches_plain(cuda_device, hit_rate):
    bank, forest, st = _world(300, 1, cuda_device)
    rng = np.random.default_rng(2)
    tid, hh = _queries(bank, forest, 5000, hit_rate, rng, cuda_device)
    ok = (tid >= 0) & (tid < st.num_trees)
    t = torch.where(ok, tid, 0).long()
    args = (st.fingerprints, st.heads, st.bucket_offsets[t],
            st.tree_nb[t] - 1, hh)
    before = probe_kernel.LAUNCHES
    got = cuckoo_lookup_arena(*args)
    assert probe_kernel.LAUNCHES == before + 1
    want = cuckoo_lookup_arena_ref(*args)
    torch.cuda.synchronize()
    _same(got.hit, want.hit, "hit")
    _same(got.head, want.head, "head")
    _same(got.bucket, want.bucket, "bucket", want.hit)
    _same(got.slot, want.slot, "slot", want.hit)


@pytest.mark.parametrize("max_locs,n", [(4, 3), (1, 1), (6, 4), (16, 8)])
def test_fused_matches_plain_over_rounds(cuda_device, max_locs, n):
    bank, forest, st = _world(200, 3, cuda_device)
    rng = np.random.default_rng(max_locs * 10 + n)
    sk = sp = st
    for _ in range(3):
        tid, hh = _queries(bank, forest, 3000, 0.7, rng, cuda_device)
        got = fused_retrieve_ragged(*_tables(sk), tid, hh, *_context(sk),
                                    max_locs=max_locs, n=n)
        want = fused_retrieve_ragged_ref(*_tables(sp), tid, hh,
                                         *_context(sp), max_locs=max_locs,
                                         n=n)
        for f in want._fields:
            _same(getattr(got, f), getattr(want, f), f)
        sk = sk.with_temperature(got.temperature)
        sp = sp.with_temperature(want.temperature)
    assert int(st.temperature.sum()) == 0      # input state untouched
    assert int(sk.temperature.sum()) > 0


def test_fused_state_on_card_equals_cpu(cuda_device):
    bank, forest, st = _world(50, 4, cuda_device)
    cpu = CFTDeviceState.from_bank(bank, forest, device="cpu")
    tid, hh = _queries(bank, forest, 777, 0.5, np.random.default_rng(5),
                       cuda_device)
    before = fused_kernel.LAUNCHES
    got = retrieve_device(st, hh, tid, fused=True)
    assert fused_kernel.LAUNCHES == before + 1
    want = retrieve_device(cpu, hh.cpu(), tid.cpu())
    for f in want._fields:
        _same(getattr(got, f).cpu(), getattr(want, f), f)


def test_far_out_of_range_int64_tree_ids_miss(cuda_device):
    bank, forest, st = _world(20, 6, cuda_device)
    hashes = hashing.hash_entities(forest.entity_names)
    h = int(hashes[bank.row_entity[0]])
    tid = torch.tensor([int(bank.row_tree[0]), 2 ** 32 + int(bank.row_tree[0]),
                        -2 ** 33], dtype=torch.int64, device=cuda_device)
    hh = torch.full((3,), h, dtype=torch.int64, device=cuda_device)
    out = retrieve_device(st, hh, tid, fused=True)
    assert out.hit.tolist() == [True, False, False]


def test_geometry_and_device_errors(cuda_device):
    bank, forest, st = _world(10, 7, cuda_device)
    tid, hh = _queries(bank, forest, 16, 0.5, np.random.default_rng(8),
                       cuda_device)
    with pytest.raises(ValueError, match="caps"):
        fused_retrieve_ragged(*_tables(st), tid, hh, *_context(st),
                              max_locs=17, n=3)
    with pytest.raises(ValueError):
        cuckoo_lookup_arena(st.fingerprints, st.heads, tid.cpu(),
                            tid.cpu(), hh)


def _close_attention(got, want, dtype):
    """Out: f32 within 1e-5; bf16 within 2^-6 |want| + 1e-6 elementwise."""
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        assert float((g - w).abs().max()) <= 1e-5
    else:
        assert bool(((g - w).abs() <= w.abs() * 2 ** -6 + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,lq", [((4, 2, 32), 1), ((4, 2, 32), 127),
                                      ((14, 2, 64), 200), ((4, 1, 64), 64)])
def test_flash_matches_plain(cuda_device, dtype, heads, lq):
    hq, hkv, d = heads
    g = torch.Generator(device=cuda_device).manual_seed(lq)
    q = torch.randn(2, hq, lq, d, generator=g, device=cuda_device)
    kv = [torch.randn(2, hkv, lq, d, generator=g, device=cuda_device)
          for _ in range(2)]
    q, k, v = (t.to(dtype) for t in (q, *kv))
    before = flash_kernel.LAUNCHES
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    assert flash_kernel.LAUNCHES == before + 1
    want, want_lse = attention_ref(q, k, v, causal=True, scale=d ** -0.5,
                                   return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close_attention(out, want, dtype)
    assert float((lse - want_lse).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,lens", [((4, 2, 32), (1, 64, 65, 100)),
                                        ((14, 2, 64), (255, 256, 300, 512))])
def test_decode_matches_plain(cuda_device, dtype, heads, lens):
    hq, hkv, d = heads
    s = max(lens)
    g = torch.Generator(device=cuda_device).manual_seed(s)
    q = torch.randn(len(lens), hq, d, generator=g, device=cuda_device)
    kv = [torch.randn(len(lens), hkv, s, d, generator=g, device=cuda_device)
          for _ in range(2)]
    q, k, v = (t.to(dtype) for t in (q, *kv))
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = decode_kernel.LAUNCHES
    out, lse = decode_attention(q, k, v, cl, return_lse=True)
    assert decode_kernel.LAUNCHES == before + 1
    want, want_lse = decode_attention_ref(q, k, v, cl, return_lse=True)
    torch.cuda.synchronize()
    _close_attention(out, want, dtype)
    assert float((lse - want_lse).abs().max()) <= 1e-5


def _close_grads(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        top = max(float(w.abs().max()), 1.0)   # unit-normal inputs
        if dtype == torch.float32:
            assert float((g - w).abs().max()) <= 1e-4 * top
        else:
            assert bool(((g - w).abs() <= w.abs() * 2 ** -6
                         + 1e-4 * top).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,lq,lkv", [((4, 2, 32), 1, 1),
                                          ((4, 2, 32), 127, 127),
                                          ((14, 2, 64), 200, 200),
                                          ((14, 2, 64), 70, 300),
                                          ((4, 1, 64), 64, 64)])
def test_flash_bwd_matches_plain(cuda_device, dtype, heads, lq, lkv):
    hq, hkv, d = heads
    g = torch.Generator(device=cuda_device).manual_seed(lq + lkv)
    q, do = (torch.randn(2, hq, lq, d, generator=g, device=cuda_device)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(2, hkv, lkv, d, generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    before = flash_kernel.BWD_LAUNCHES
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, do, True,
                                                d ** -0.5)
    assert flash_kernel.BWD_LAUNCHES == before + 1
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, True, d ** -0.5)
    torch.cuda.synchronize()
    _close_grads(got, want, dtype)
    # through autograd: one backward launch, the same gradients
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(flash_attention(*leaves, causal=True), leaves,
                               do)
    assert flash_kernel.BWD_LAUNCHES == before + 2
    _close_grads(auto, want, dtype)


def test_attention_kernels_raise_instead_of_falling_back(cuda_device):
    q = torch.zeros(1, 4, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q.clone().requires_grad_(), q[:, :2], q[:, :2])
    h = torch.zeros(1, 4, 8, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(h, h[:, :2], h[:, :2])
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(h.clone().requires_grad_(), h[:, :2], h[:, :2])
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 4, 8, 32, device=cuda_device,
                                    requires_grad=True),
                        torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0].float(), q.cpu(), q.cpu(),
                         torch.ones(1, dtype=torch.int32))


def test_answer_on_card_equals_cpu(cuda_device):
    """One answer on the card through both attention kernels equals the
    same pipeline with the same weights on the CPU (f32 smoke config)."""
    cfg = get_arch("paper-cftrag").smoke().replace(attn_impl="flash")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    corpus = hospital_corpus(num_trees=6, num_queries=2)
    card = RAGPipeline(corpus, ServeEngine(cfg, lm.init_params(
        cfg, torch.Generator().manual_seed(0), cuda_device)),
        use_bank=True, device=cuda_device)
    cpu = RAGPipeline(corpus, ServeEngine(cfg, params), use_bank=True,
                      device="cpu")
    flash0, dec0 = flash_kernel.LAUNCHES, decode_kernel.LAUNCHES
    got = card.answer(corpus.queries[0], max_new_tokens=5)
    assert flash_kernel.LAUNCHES - flash0 == cfg.n_layers
    assert decode_kernel.LAUNCHES - dec0 == cfg.n_layers * 4
    want = cpu.answer(corpus.queries[0], max_new_tokens=5)
    assert got.prompt == want.prompt
    assert got.output_ids == want.output_ids


def test_train_step_on_card_equals_cpu(cuda_device):
    """One f32 smoke-config train step on the card, through both flash
    kernels, equals the same step on the CPU: loss and grad norm within
    1e-5 relative (summation order); m and v within 1e-5 of each leaf's
    largest entry; each parameter's update within 1e-3 of its leaf's
    largest update where the gradient is above 1e-2 of the leaf's
    largest.  (The first AdamW step moves an entry by lr * g / (|g| +
    eps), so where g is at rounding noise its sign alone decides a step
    of lr.)  Leaving out weight decay would move the norm scales by a
    tenth of their largest update."""
    cfg = get_arch("paper-cftrag").smoke().replace(attn_impl="flash")
    pb = PackedBatches(TextDataset(hospital_corpus(num_trees=8).documents,
                                   HashTokenizer(cfg.vocab)),
                       batch_size=4, seq_len=96, prefetch=False)
    batch = {k: torch.from_numpy(a) for k, a in pb.next_batch().items()}
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=4))
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), dev)
        before = [t.clone() for t in tree_leaves(params)]  # updated in place
        fwd0, bwd0 = flash_kernel.LAUNCHES, flash_kernel.BWD_LAUNCHES
        p, s, m = step(params, adamw_init(params),
                       {k: t.to(dev) for k, t in batch.items()})
        if dev.type == "cuda":
            assert flash_kernel.LAUNCHES - fwd0 == cfg.n_layers
            assert flash_kernel.BWD_LAUNCHES - bwd0 == cfg.n_layers
        updates = [(a - b).cpu() for a, b in zip(tree_leaves(p), before)]
        results.append((updates, s, m))
    (uc, sc, mc), (up, sp, mp) = results
    for key in ("loss", "grad_norm"):
        assert abs(float(mc[key]) - float(mp[key])) <= 1e-5 * abs(
            float(mp[key]))
    assert int(sc.step) == int(sp.step) == 1
    for tc, tp in ((sc.m, sp.m), (sc.v, sp.v)):
        for a, b in zip(tree_leaves(tc), tree_leaves(tp), strict=True):
            assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
                b.abs().max())
    for a, b, m1 in zip(uc, up, tree_leaves(sp.m), strict=True):
        clear = m1.abs() > 1e-2 * m1.abs().max()
        assert float((a - b)[clear].abs().max()) <= 1e-3 * float(
            b.abs().max())
