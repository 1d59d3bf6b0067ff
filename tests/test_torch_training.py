"""Port parity of training on the CPU: the reference's parameters and
optimizer state, converted with ``params_from_jax``/``opt_state_from_jax``,
go through the port's ``loss_fn``, ``make_train_step`` and AdamW, and
everything is held against the reference (JAX on the CPU; the flash
attention's Pallas kernels in interpret mode).  Also the data pipeline,
checkpoints, the fault-tolerant loop and the launcher.

Tolerances (f32 smoke configs):
- loss, ce and z-loss within 1e-5 relative: two frameworks summing 2
  layers and a 512-way log-sum-exp in other orders (measured 2e-7);
- each gradient leaf within 1e-5 of its largest entry (measured 1.3e-6);
- after one train step, m within 1e-7 and v within 1e-8 absolute (they
  are 0.1 g and 0.05 g^2 of gradients below 1; measured 6e-9 and 4e-10),
  grad_norm within 1e-5 relative, lr exactly;
- each parameter's update (new minus old) within 2e-2 of its leaf's
  largest update: AdamW divides each gradient entry by its own root mean
  square, so an entry whose gradient is near zero moves by up to lr on
  rounding noise (measured 8.6e-3); and within 1e-3 where the entry's
  root mean square gradient is above 1e-3 of its leaf's largest
  (measured 1.4e-4).  Leaving out weight decay moves the norm scales
  (which are 1) by lr * 0.1, a tenth of their leaf's largest update;
- ``adamw_update`` alone, on the same f32 gradients, within 1e-5 of each
  leaf's largest update (f32 rounding; each term of the update, weight
  decay, bias correction, clipping, moves it by more than 1e-2);
- integer outputs (batches, step counts, token counts) exactly; bf16
  checkpoints bit-exact."""
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import HashTokenizer as RefTokenizer
from repro.data import PackedBatches as RefPackedBatches
from repro.data import TextDataset as RefTextDataset
from repro.data import hospital_corpus as ref_hospital
from repro.models import lm as ref_lm
from repro.training import AdamWConfig as RefAdamWConfig
from repro.training import AdamWState as RefAdamWState
from repro.training import adamw_init as ref_adamw_init
from repro.training import adamw_update as ref_adamw_update
from repro.training import global_norm as ref_global_norm
from repro.training import make_train_step as ref_make_train_step
from repro.training import quantize_grads_int8 as ref_quantize
from repro.training import schedule_lr as ref_schedule_lr
from repro_torch.configs import get_arch
from repro_torch.data import (HashTokenizer, PackedBatches, TextDataset,
                              hospital_corpus)
from repro_torch.launch import train as launch_train
from repro_torch.models import lm, params_from_jax
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.training import (AdamWConfig, AdamWState, LoopConfig,
                                  SimulatedPreemption, TrainLoop, adamw_init,
                                  adamw_update, cleanup, global_norm,
                                  latest_step, make_train_step,
                                  opt_state_from_jax,
                                  quantize_grads_int8, restore, save,
                                  schedule_lr)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of each leaf's largest entry
M_TOL, V_TOL = 1e-7, 1e-8
UPDATE_TOL = 2e-2        # of each leaf's largest update
UPDATE_CLEAR_TOL = 1e-3  # the same, where the gradient is clear of noise
ADAMW_TOL = 1e-5
ARCHS = ("qwen2-0.5b", "paper-cftrag")


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return ref_lm.init_params(ref_get_arch(arch).smoke(),
                              jax.random.PRNGKey(3))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab: int, batch: int = 4, seq: int = 32, trees: int = 8):
    """One packed batch as numpy arrays, from the reference's pipeline."""
    ds = RefTextDataset(ref_hospital(num_trees=trees).documents,
                        RefTokenizer(vocab))
    return RefPackedBatches(ds, batch_size=batch, seq_len=seq,
                            prefetch=False).next_batch()


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_update_close(ref_old, ref_new, port_old, port_new, tol, what,
                         ref_v=None):
    """Each leaf's update (new minus old) against the reference's, within
    ``tol`` of that leaf's largest reference update.  With ``ref_v`` (the
    reference's second moments), only the entries whose root mean square
    gradient is above 1e-3 of the leaf's largest."""
    ref_v = ref_old if ref_v is None else ref_v
    for r0, r1, p0, p1, v in zip(jax.tree.leaves(ref_old),
                                 jax.tree.leaves(ref_new),
                                 tree_leaves(port_old), tree_leaves(port_new),
                                 jax.tree.leaves(ref_v), strict=True):
        want = np.asarray(r1, np.float32) - np.asarray(r0, np.float32)
        got = (p1.float() - p0.float()).numpy()
        keep = np.ones(want.shape, bool)
        if v is not r0:
            rms = np.sqrt(np.asarray(v))
            keep = rms > 1e-3 * rms.max()
        np.testing.assert_allclose(got[keep], want[keep], rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=what)


def _assert_tree_close(ref_tree, port_tree, atol, what):
    ref_leaves = jax.tree.leaves(ref_tree)
    port_leaves = tree_leaves(port_tree)
    assert len(ref_leaves) == len(port_leaves), what
    for r, p in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(p.float().numpy(),
                                   np.asarray(r, np.float32), atol=atol,
                                   rtol=0, err_msg=what)


@pytest.mark.parametrize("impl", ["reference", "blocked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, impl):
    rcfg = ref_get_arch(arch).smoke().replace(attn_impl=impl)
    cfg = get_arch(arch).smoke().replace(attn_impl=impl)
    batch = _batch(cfg.vocab)
    (want, want_aux), want_grads = jax.value_and_grad(
        lambda p: ref_lm.loss_fn(rcfg, p, _jax(batch)),
        has_aux=True)(_ref_params(arch))
    params = params_from_jax(cfg, _np_tree(_ref_params(arch)))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, aux = lm.loss_fn(cfg, params, _torch(batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    for key in ("ce", "z_loss"):
        np.testing.assert_allclose(float(aux[key].detach()),
                                   float(want_aux[key]), rtol=LOSS_RTOL)
    assert aux["tokens"].dtype == torch.int32
    assert int(aux["tokens"]) == int(want_aux["tokens"]) == batch["mask"].sum()
    for g, w in zip(grads, jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max())


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True)])
def test_train_step_matches_reference(microbatches, compress):
    """The second step of a run (non-zero moments carried across with
    ``opt_state_from_jax``), microbatched and with int8 compression."""
    arch = "qwen2-0.5b"
    rcfg, cfg = ref_get_arch(arch).smoke(), get_arch(arch).smoke()
    batch = _batch(cfg.vocab, batch=8)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    ref_step = jax.jit(ref_make_train_step(
        rcfg, RefAdamWConfig(**kw), microbatches=microbatches,
        compress_grads=compress))
    p1, s1, _ = ref_step(_ref_params(arch), ref_adamw_init(_ref_params(arch)),
                         _jax(batch))
    params = params_from_jax(cfg, _np_tree(p1))
    before = tree_map(torch.clone, params)   # the step updates in place
    state = opt_state_from_jax(cfg, _np_tree(s1))
    want_p, want_s, want_m = ref_step(p1, s1, _jax(batch))
    step = make_train_step(cfg, AdamWConfig(**kw), microbatches=microbatches,
                           compress_grads=compress)
    got_p, got_s, got_m = step(params, state, _torch(batch))
    assert got_s.step.dtype == torch.int32
    assert int(got_s.step) == int(want_s.step) == 2
    _assert_tree_close(want_s.m, got_s.m, M_TOL, "m")
    _assert_tree_close(want_s.v, got_s.v, V_TOL, "v")
    _assert_update_close(p1, want_p, before, got_p, UPDATE_TOL, "update")
    _assert_update_close(p1, want_p, before, got_p, UPDATE_CLEAR_TOL,
                         "update where the gradient is clear of noise",
                         ref_v=want_s.v)
    assert set(got_m) == set(want_m) == {"loss", "grad_norm", "lr"}
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=LOSS_RTOL)
    assert float(got_m["lr"]) == float(want_m["lr"])


def test_microbatch_split_rejects_ragged_batch():
    cfg = get_arch("qwen2-0.5b").smoke()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, AdamWConfig(), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), _torch(_batch(cfg.vocab, batch=4)))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    for s in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        got = schedule_lr(AdamWConfig(**kw), torch.tensor(s, dtype=torch.int32))
        want = ref_schedule_lr(RefAdamWConfig(**kw), jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=f"{schedule} step {s}")


def test_global_norm_and_int8_compression_match_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(64, 64)).astype(np.float32),
            "b": {"w": (rng.normal(size=(7,)) * 1e-3).astype(np.float32)}}
    err = {"a": rng.normal(size=(64, 64)).astype(np.float32) * 1e-3,
           "b": {"w": np.zeros(7, np.float32)}}
    ttree = tree_map(torch.from_numpy, tree)
    np.testing.assert_allclose(float(global_norm(ttree)),
                               float(ref_global_norm(tree)), rtol=1e-6)
    for e in (None, err):
        deq, res = quantize_grads_int8(
            ttree, None if e is None else tree_map(torch.from_numpy, e))
        want_deq, want_res = ref_quantize(tree, e)
        # one int8 level of disagreement in a rounding tie would be
        # 1/127 of the leaf's max; the two agree to f32 rounding
        _assert_tree_close(want_deq, deq, 1e-6, "dequantized")
        _assert_tree_close(want_res, res, 1e-6, "residual")
        for d, r, g in zip(tree_leaves(deq), tree_leaves(res),
                           tree_leaves(ttree)):
            assert d.dtype == g.dtype and r.dtype == torch.float32


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])
def test_adamw_update_matches_reference(grad_scale):
    """Two f32 steps on the same gradients, below (1e-2) and above (10)
    the clipping norm; unit-normal params, so that weight decay is a
    tenth of each update."""
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(32, 16)), "n": {"scale": rng.normal(size=16)}}
    gs = [{"w": rng.normal(size=(32, 16)) * grad_scale,
           "n": {"scale": rng.normal(size=16) * grad_scale}}
          for _ in range(2)]
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), p)
    port_p = tree_map(lambda a: torch.from_numpy(a).float(), p)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_s, port_s = ref_adamw_init(ref_p), adamw_init(port_p)
    for g in gs:
        ref_old, port_old = ref_p, tree_map(torch.clone, port_p)
        ref_p, ref_s, ref_m = ref_adamw_update(
            RefAdamWConfig(**kw), jax.tree.map(jnp.float32, g), ref_s, ref_p)
        port_p, port_s, port_m = adamw_update(
            AdamWConfig(**kw), tree_map(lambda a: torch.from_numpy(a).float(),
                                        g), port_s, port_p)
        _assert_update_close(ref_old, ref_p, port_old, port_p, ADAMW_TOL,
                             "update")
        _assert_tree_close(ref_s.m, port_s.m, 1e-7 * grad_scale, "m")
        _assert_tree_close(ref_s.v, port_s.v, 1e-7 * grad_scale ** 2, "v")
        assert int(port_s.step) == int(ref_s.step)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(port_m[key]), float(ref_m[key]),
                                       rtol=1e-6)


def test_bf16_adamw_update_matches_reference():
    """bf16 params with f32 moments: the update rounds each parameter to
    bf16 once, as the reference does."""
    rng = np.random.default_rng(1)
    p = {"w": rng.normal(size=(32, 16)), "n": {"scale": np.ones(16)}}
    g = {"w": rng.normal(size=(32, 16)), "n": {"scale": rng.normal(size=16)}}
    ref_p = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    ref_g = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
    # weight decay 1: over 3 steps it moves each parameter by 3e-2 of
    # itself, several bf16 ulps, so leaving it out fails
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=1.0)
    ref_s = ref_adamw_init(ref_p)
    port_p = tree_map(lambda a: torch.from_numpy(a).bfloat16(), p)
    port_g = tree_map(lambda a: torch.from_numpy(a).bfloat16(), g)
    port_s = adamw_init(port_p)
    for _ in range(3):
        ref_p, ref_s, ref_m = ref_adamw_update(RefAdamWConfig(**kw), ref_g,
                                               ref_s, ref_p)
        port_p, port_s, port_m = adamw_update(AdamWConfig(**kw), port_g,
                                              port_s, port_p)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(port_p))
    assert all(t.dtype == torch.float32 for t in tree_leaves(port_s.m))
    # f32 rounding of the update may move each final rounding to bf16
    # by one ulp of the parameter (2^-7 of its power of two)
    for r, t in zip(jax.tree.leaves(ref_p), tree_leaves(port_p),
                    strict=True):
        want = np.asarray(r, np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2 ** -60)))
                      - 7)
        assert np.all(np.abs(t.float().numpy() - want) <= ulp), "bf16 params"
    _assert_tree_close(ref_s.m, port_s.m, 1e-6, "m")
    _assert_tree_close(ref_s.v, port_s.v, 1e-6, "v")
    np.testing.assert_allclose(float(port_m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-6)


def test_packed_batches_and_state_match_reference():
    vocab = 512
    corpus, ref_corpus = hospital_corpus(num_trees=8), ref_hospital(
        num_trees=8)
    assert corpus.documents == ref_corpus.documents
    port = PackedBatches(TextDataset(corpus.documents, HashTokenizer(vocab)),
                         batch_size=4, seq_len=64, prefetch=False)
    ref = RefPackedBatches(RefTextDataset(ref_corpus.documents,
                                          RefTokenizer(vocab)),
                           batch_size=4, seq_len=64, prefetch=False)
    for _ in range(40):          # crosses epochs
        got, want = port.next_batch(), ref.next_batch()
        for key in ("tokens", "labels", "mask"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert port.checkpoint_state() == ref.checkpoint_state()
    assert port.checkpoint_state()["epoch"] >= 1
    saved = port.checkpoint_state()
    after = port.next_batch()
    port.restore_state(saved)
    np.testing.assert_array_equal(port.next_batch()["tokens"],
                                  after["tokens"])
    # prefetching iteration yields the same batches as next_batch
    fresh = PackedBatches(TextDataset(corpus.documents, HashTokenizer(vocab)),
                          batch_size=4, seq_len=64)
    first = next(iter(fresh))
    ref2 = RefPackedBatches(RefTextDataset(ref_corpus.documents,
                                           RefTokenizer(vocab)),
                            batch_size=4, seq_len=64, prefetch=False)
    np.testing.assert_array_equal(first["tokens"],
                                  ref2.next_batch()["tokens"])


def test_checkpoint_roundtrip_bit_exact_and_cleanup():
    cfg = get_arch("paper-cftrag").smoke().replace(dtype="bfloat16")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params)
    opt.m["embed"].normal_(generator=torch.Generator().manual_seed(1))
    tree = {"params": params, "opt": opt._asdict()}
    target = tree_map(torch.zeros_like, tree)
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4):
            save(d, s, tree, extra={"pipeline": {"epoch": s, "cursor": 7}})
        assert latest_step(d) == 4
        assert not [x for x in os.listdir(d) if x.startswith("tmp.")]
        got, step, extra = restore(d, target)
        assert step == 4 and extra["pipeline"] == {"epoch": 4, "cursor": 7}
        for a, b in zip(tree_leaves(tree), tree_leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.uint8) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.uint8) if b.dtype ==
                               torch.bfloat16 else b)
        assert params["embed"].dtype == torch.bfloat16
        _, step2, _ = restore(d, target, step=2)
        assert step2 == 2
        with pytest.raises(ValueError, match="target"):
            restore(d, {"params": tree_map(lambda t: t.float(), params),
                        "opt": target["opt"]})
        cleanup(d, keep_last=2)
        assert latest_step(d) == 4
        assert sorted(x for x in os.listdir(d) if x.startswith("step_")) \
            == ["step_00000003", "step_00000004"]
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            restore(d, target)


def _loop_run(cfg, ckpt_dir, interrupt):
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    step_fn = make_train_step(cfg, ocfg)
    pb = PackedBatches(TextDataset(hospital_corpus(num_trees=8).documents,
                                   HashTokenizer(cfg.vocab)),
                       batch_size=4, seq_len=32, prefetch=False)

    def batches():
        while True:
            yield _torch(pb.next_batch())

    def fresh(seed):
        params = lm.init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
        return params, adamw_init(params)

    lc = LoopConfig(total_steps=6, ckpt_dir=ckpt_dir, ckpt_every=1,
                    log_every=100)
    loop = TrainLoop(lc, step_fn, *fresh(0), batches(), pipeline=pb,
                     log=lambda *_: None)
    if not interrupt:
        loop.run()
        return loop
    with pytest.raises(SimulatedPreemption):
        loop._preempted = True        # as the SIGTERM handler sets it
        loop.run(max_steps=3)
    assert loop.step == 1 and latest_step(ckpt_dir) == 1
    loop = TrainLoop(lc, step_fn, *fresh(0), batches(), pipeline=pb,
                     log=lambda *_: None)
    loop.run(max_steps=2)
    assert loop.step == 3
    # a restart with other weights resumes from step 3's checkpoint
    loop2 = TrainLoop(lc, step_fn, *fresh(9), batches(), pipeline=pb,
                      log=lambda *_: None)
    loop2.run()
    assert loop2.step == 6 and len(loop2.step_times) == 3
    return loop2


def test_preemption_resume_exact():
    """Preempt, resume, and land on the same final state as an
    uninterrupted run (pipeline state travels in the checkpoint)."""
    cfg = get_arch("qwen2-0.5b").smoke()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        resumed = _loop_run(cfg, d1, interrupt=True)
        full = _loop_run(cfg, d2, interrupt=False)
    assert len(full.losses) == 6 and all(np.isfinite(full.losses))
    assert int(resumed.opt_state.step) == int(full.opt_state.step) == 6
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(full.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_launch_train_main_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        loop = launch_train.main(["--device", "cpu", "--smoke", "--arch",
                                  "paper-cftrag", "--steps", "3", "--batch",
                                  "2", "--seq", "32", "--ckpt-dir", d,
                                  "--ckpt-every", "2"])
        assert latest_step(d) == 3
    assert loop.step == 3 and all(np.isfinite(loop.losses))
    assert "done at step 3" in capsys.readouterr().out
    with pytest.raises(KeyError, match="item 10"):
        launch_train.main(["--device", "cpu", "--arch", "zamba2-1.2b"])
