"""Port parity of the generator: the reference's parameters, converted with
``params_from_jax``, drive the port's prefill and decode steps, its engine
and ``RAGPipeline.answer``; everything is held against the reference on
the CPU (JAX jitted as its engine jits it; the Pallas flash kernel in
interpret mode).

Tolerances: logits within 1e-4 absolute on the f32 smoke configs — the
two frameworks sum in other orders, and 2 layers of f32 rounding at
logits of magnitude ~1 stay orders of magnitude below that; greedy ids,
prompts and decoded text exactly equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data.datasets import hospital_corpus as ref_hospital
from repro.data.tokenizer import HashTokenizer as RefTokenizer
from repro.models import lm as ref_lm
from repro.serving import RAGPipeline as RefPipeline
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine
from repro.serving import kv_cache_bytes as ref_kv_cache_bytes
from repro_torch.configs import get_arch
from repro_torch.data import HashTokenizer, hospital_corpus
from repro_torch.models import lm, params_from_jax
from repro_torch.serving import (RAGPipeline, Request, ServeEngine,
                                 kv_cache_bytes)

LOGIT_TOL = 1e-4
ARCHS = ("paper-cftrag", "qwen2-0.5b")


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    cfg = ref_get_arch(arch).smoke()
    return ref_lm.init_params(cfg, jax.random.PRNGKey(3))


def _configs(arch: str, impl: str):
    return (ref_get_arch(arch).smoke().replace(attn_impl=impl),
            get_arch(arch).smoke().replace(attn_impl=impl))


def _port_params(arch: str, cfg):
    return params_from_jax(cfg, jax.tree.map(np.asarray, _ref_params(arch)))


def test_configs_match_reference():
    for arch in ARCHS:
        assert get_arch(arch) == get_arch(arch).replace()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "qkv_bias", "rope_theta",
                  "tie_embeddings", "dtype", "attn_impl", "attn_chunk",
                  "padded_vocab", "resolved_head_dim"):
            for c, r in ((get_arch(arch), ref_get_arch(arch)),
                         (get_arch(arch).smoke(), ref_get_arch(arch).smoke())):
                assert getattr(c, f) == getattr(r, f), (arch, f)
        assert lm.param_count(get_arch(arch)) == \
            ref_lm.param_count(ref_get_arch(arch))
        assert kv_cache_bytes(get_arch(arch), 4, 512) == \
            ref_kv_cache_bytes(ref_get_arch(arch), 4, 512)
    assert lm.param_count(get_arch("paper-cftrag")) == 415_242_112
    with pytest.raises(KeyError, match="item 10"):
        get_arch("granite-moe-1b-a400m")


def test_params_from_jax_checks_the_tree():
    cfg = get_arch("paper-cftrag").smoke()
    tree = jax.tree.map(np.asarray, _ref_params("paper-cftrag"))
    p = params_from_jax(cfg, tree)
    assert p["layers"]["attn"]["wq"]["w"].shape == (2, 128, 128)
    np.testing.assert_array_equal(p["embed"].numpy(), tree["embed"])
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(cfg, bad)
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(cfg, {k: v for k, v in tree.items() if k != "embed"})
    bf = params_from_jax(cfg, tree, dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16


def test_init_decode_state_matches_reference():
    rcfg, cfg = _configs("qwen2-0.5b", "blocked")
    state = lm.init_decode_state(cfg, _port_params("qwen2-0.5b", cfg), 3, 40)
    want = ref_lm.init_decode_state(rcfg, _ref_params("qwen2-0.5b"), 3, 40)
    assert state["len"] == int(want["len"]) == 0
    for name in ("k", "v"):
        got = state["cache"][name]
        assert tuple(got.shape) == want["cache"][name].shape
        assert got.dtype == torch.float32 and not bool(got.any())


@pytest.mark.parametrize("impl", ["reference", "blocked", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    """Left-padded prompts (row 0 starts with PAD, as the engine pads),
    prefill + 4 greedy decode steps: logits within LOGIT_TOL at every
    step, greedy ids equal."""
    rcfg, cfg = _configs(arch, impl)
    params = _port_params(arch, cfg)
    rparams = _ref_params(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(4, cfg.vocab, size=(2, 21)).astype(np.int32)
    toks[0, :6] = HashTokenizer.PAD
    cache = 64
    rprefill = jax.jit(functools.partial(ref_lm.prefill, rcfg,
                                         cache_size=cache))
    rdecode = jax.jit(functools.partial(ref_lm.decode_step, rcfg))
    rlogits, rstate = rprefill(rparams, {"tokens": jnp.asarray(toks)})
    logits, state = lm.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                               cache)
    for step in range(5):
        assert logits.shape == rlogits.shape and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"step {step}")
        tok = lm.greedy_token(logits)
        rtok = ref_lm.greedy_token(rlogits)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(rtok))
        if step < 4:
            rlogits, rstate = rdecode(rparams, rtok, rstate)
            logits, state = lm.decode_step(cfg, params, tok, state)
    assert state["len"] == int(rstate["len"]) == 25
    np.testing.assert_allclose(state["cache"]["k"].numpy(),
                               np.asarray(rstate["cache"]["k"]),
                               atol=LOGIT_TOL, rtol=0)


def test_forward_matches_reference():
    rcfg, cfg = _configs("paper-cftrag", "blocked")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 9))
    got = lm.forward(cfg, _port_params("paper-cftrag", cfg),
                     {"tokens": torch.from_numpy(toks)})
    want = ref_lm.forward(rcfg, _ref_params("paper-cftrag"),
                          {"tokens": jnp.asarray(toks, jnp.int32)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


def test_tokenizer_matches_reference():
    text = "You are an assistant.\nQuestion: What is Ward-3's unit? Answer:"
    tok, rtok = HashTokenizer(512), RefTokenizer(512)
    ids = tok.encode(text, bos=True, eos=True)
    assert ids == rtok.encode(text, bos=True, eos=True)
    assert tok.decode(ids + [0, 3, 9999]) == rtok.decode(ids + [0, 3, 9999])
    with pytest.raises(ValueError):
        HashTokenizer(4)


def test_serve_batches_pads_and_truncates_like_reference():
    """Five requests in batches of 4 (one short batch), one prompt longer
    than the cache budget: every request's ids equal the reference's."""
    rcfg, cfg = _configs("qwen2-0.5b", "flash")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(4, cfg.vocab, size=n).tolist()
               for n in (30, 7, 19, 60, 12)]
    news = [3, 5, 2, 4, 3]
    eng = ServeEngine(cfg, _port_params("qwen2-0.5b", cfg), cache_size=64,
                      batch_size=4)
    reng = RefEngine(rcfg, _ref_params("qwen2-0.5b"), cache_size=64,
                     batch_size=4)
    got = eng.serve([Request(list(p), n) for p, n in zip(prompts, news)])
    want = reng.serve([RefRequest(list(p), n) for p, n in zip(prompts, news)])
    for g, w in zip(got, want):
        assert g.prompt_ids == w.prompt_ids
        assert g.out_ids == w.out_ids
        assert len(g.out_ids) == g.max_new_tokens
    assert len(got[3].prompt_ids) == 64 - 5       # tail kept


def test_answer_matches_reference_three_queries():
    """RAGPipeline.answer with a flash-attention engine over three
    consecutive queries: prompt, ids and text equal the reference
    pipeline's (whose answer() also runs maintain() after each)."""
    rcfg, cfg = _configs("paper-cftrag", "flash")
    corpus = hospital_corpus(num_trees=6, num_queries=3)
    port = RAGPipeline(corpus, ServeEngine(
        cfg, _port_params("paper-cftrag", cfg)), use_bank=True, device="cpu")
    ref = RefPipeline(ref_hospital(num_trees=6, num_queries=3),
                      RefEngine(rcfg, _ref_params("paper-cftrag")),
                      use_bank=True)
    for q in corpus.queries:
        got, want = port.answer(q, max_new_tokens=4), \
            ref.answer(q, max_new_tokens=4)
        assert got.prompt == want.prompt
        assert got.output_ids == want.output_ids
        assert got.text == want.text
        assert len(got.output_ids) == 4


def test_engine_retrieval_delegates_to_the_session():
    """``ServeEngine.attach_retrieval`` + ``retrieve`` serve the same
    batches as a bare ``RetrievalSession`` on the same state."""
    from repro_torch.core import CFTDeviceState, build_bank, build_forest
    from repro_torch.core import hashing
    from repro_torch.serving import RetrievalSession
    _, cfg = _configs("paper-cftrag", "blocked")
    corpus = hospital_corpus(num_trees=5, num_queries=1)
    forest = build_forest(corpus.trees)
    state = CFTDeviceState.from_bank(build_bank(forest), forest,
                                     device="cpu")
    eng = ServeEngine(cfg, _port_params("paper-cftrag", cfg))
    eng.attach_retrieval(state, batch_pad=32)
    session = RetrievalSession()
    session.attach(state, batch_pad=32)
    hashes = hashing.hash_entities(forest.entity_names[:7])
    trees = [i % 5 for i in range(7)]
    got, want = eng.retrieve(trees, hashes), session.retrieve(trees, hashes)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(got.hit.any())
