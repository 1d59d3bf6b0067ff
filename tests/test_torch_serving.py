"""Port parity of the serving layer: the port's bank-mode ``RAGPipeline``
renders the same context strings and threads the same temperature as the
reference's; a port ``RetrievalSession`` gives identical padded batches
fused and unfused (and equal to the reference's session); entry points
default to the card and raise without one; unported modes say so."""
import jax
import numpy as np
import pytest
import torch

from repro.core import CFTDeviceState as RefState
from repro.core import build_bank as ref_build_bank
from repro.core import build_forest as ref_build_forest
from repro.core import hashing as ref_hashing
from repro.data.datasets import hospital_corpus as ref_hospital
from repro.serving.engine import RetrievalSession as RefSession
from repro.serving.rag import RAGPipeline as RefPipeline
from repro_torch.configs import get_arch
from repro_torch.core import CFTDeviceState, build_bank, build_forest
from repro_torch.core.trag import STATE_FIELDS
from repro_torch.data import hospital_corpus
from repro_torch.models import lm
from repro_torch.serving import RAGPipeline, RetrievalSession

FIELDS = ("hit", "locations", "up", "down", "temperature")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, msg=""):
    for f in FIELDS:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        assert g.dtype == w.dtype, f"{f} {msg}: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{f} {msg}")


def test_pipeline_matches_reference_two_rounds():
    corpus = hospital_corpus(num_trees=6, num_queries=6)
    ref = RefPipeline(ref_hospital(num_trees=6, num_queries=6), None,
                      use_bank=True)
    port = RAGPipeline(corpus, None, use_bank=True, device="cpu")
    for rnd in range(2):
        for q in corpus.queries:
            got, want = port.retrieve(q), ref.retrieve(q)
            assert got.entities == want.entities
            assert got.context == want.context, f"round {rnd}: {q}"
            assert got.prompt == want.prompt
        np.testing.assert_array_equal(
            port._dev_state.temperature.numpy(),
            np.asarray(ref._dev_state.temperature))
    assert int(port._dev_state.temperature.sum()) > 0
    q = corpus.queries[0]
    assert port.retrieve(q, tree_scope=2).context == \
        ref.retrieve(q, tree_scope=2).context


def _session_inputs():
    corpus = hospital_corpus(num_trees=8, num_queries=4)
    rng = np.random.default_rng(4)
    names = corpus.entities
    batches = []
    for size in (50, 64, 130):
        tid = rng.integers(-1, 9, size=size).astype(np.int32)
        hh = ref_hashing.hash_entities(
            [names[int(i)] for i in rng.integers(len(names), size=size)])
        hh[::3] = rng.integers(1, 2 ** 32, size=hh[::3].size)
        batches.append((tid.tolist(), [int(h) for h in hh]))
    return corpus, batches


def test_session_fused_and_unfused_identical():
    corpus, batches = _session_inputs()
    forest = build_forest(corpus.trees)
    bank = build_bank(forest)
    rforest = ref_build_forest(corpus.trees)
    ref = RefSession()
    ref.attach(RefState.from_bank(ref_build_bank(rforest), rforest))
    unf, fus = RetrievalSession(), RetrievalSession()
    unf.attach(CFTDeviceState.from_bank(bank, forest, device="cpu"))
    fus.attach(CFTDeviceState.from_bank(bank, forest, device="cpu"),
               fused=True)
    for i, (tid, hh) in enumerate(batches):
        for rnd in range(2):
            want = ref.retrieve_dispatch(*ref.pad_queries(tid, hh)[:2])
            padded = unf.pad_queries(tid, hh)
            assert padded[2] == len(hh) and padded[0].shape[0] % 64 == 0
            a = unf.retrieve_dispatch(*padded[:2])
            b = fus.retrieve_dispatch(*fus.pad_queries(tid, hh)[:2])
            _assert_same(a, want, f"unfused batch {i} round {rnd}")
            _assert_same(b, want, f"fused batch {i} round {rnd}")
    # the synchronous entry slices back to the true batch
    tid, hh = batches[0]
    a, b = unf.retrieve(tid, hh), fus.retrieve(tid, hh)
    _assert_same(a, b)
    assert a.hit.shape == (len(hh),) and unf.harvest() == 0


def test_pad_lanes_are_valid_tree0_queries():
    """Pad lanes query tree 0 with hash 0 and are *not* masked: a stored
    fingerprint equal to hash 0's is hit (and bumped) by every pad."""
    corpus, _ = _session_inputs()
    forest = build_forest(corpus.trees)
    sess = RetrievalSession()
    sess.attach(CFTDeviceState.from_bank(build_bank(forest), forest,
                                         device="cpu"), fused=True)
    hh, tid, b = sess.pad_queries([1], [5])
    assert b == 1 and hh.shape == (64,) and tid.dtype == torch.int32
    assert hh.dtype == torch.int64
    assert int(hh[1:].abs().sum()) == 0 and int(tid[1:].abs().sum()) == 0
    with pytest.raises(ValueError, match="pad_to"):
        sess.pad_queries([0, 0], [1, 2], pad_to=1)


def test_set_fused_flip():
    corpus, batches = _session_inputs()
    forest = build_forest(corpus.trees)
    sess = RetrievalSession()
    with pytest.raises(RuntimeError):
        sess.set_fused(True)
    sess.attach(CFTDeviceState.from_bank(build_bank(forest), forest,
                                         device="cpu"))
    tid, hh = batches[1]
    a = sess.retrieve(tid, hh)
    sess.set_fused(True)
    assert sess.fused
    b = sess.retrieve(tid, hh)
    np.testing.assert_array_equal(a.locations.numpy(), b.locations.numpy())
    with pytest.raises(ValueError, match="lookup_fn"):
        sess.attach(sess.state, lookup_fn=lambda *a: None, fused=True)


def test_entry_points_default_to_the_card():
    """``device=None`` means the card: without CUDA the entry points
    raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    corpus = hospital_corpus(num_trees=3, num_queries=2)
    forest = build_forest(corpus.trees)
    with pytest.raises(RuntimeError, match="CUDA"):
        CFTDeviceState.from_bank(build_bank(forest), forest)
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGPipeline(corpus, None, use_bank=True)
    arrays = {f: np.zeros(2, np.int32) for f in STATE_FIELDS}
    with pytest.raises(RuntimeError, match="CUDA"):
        CFTDeviceState.from_arrays(arrays)


@pytest.mark.parametrize("kw,item", [
    ({"use_bank": False}, "item 4"),
    ({"use_bank": True, "mesh": object()}, "item 9"),
    ({"use_bank": True, "snapshot_dir": "snap"}, "item 7"),
    ({"use_bank": True, "tenants": {"a": (0, 1)}}, "item 7"),
])
def test_unported_modes_raise(kw, item):
    corpus = hospital_corpus(num_trees=2, num_queries=1)
    with pytest.raises(NotImplementedError, match=item):
        RAGPipeline(corpus, None, device="cpu", **kw)
    moe = get_arch("paper-cftrag").smoke().replace(family="moe")
    with pytest.raises(NotImplementedError, match="item 10"):
        lm.init_params(moe, torch.Generator(), "cpu")


def test_state_roundtrip_through_reference_arrays():
    """The reference's state feeds a port session unchanged."""
    corpus = ref_hospital(num_trees=4, num_queries=1)
    rforest = ref_build_forest(corpus.trees)
    ref = RefState.from_bank(ref_build_bank(rforest), rforest)
    arrays = {f: np.asarray(jax.device_get(getattr(ref, f)))
              for f in STATE_FIELDS}
    st = CFTDeviceState.from_arrays(arrays, device="cpu")
    for f, a in st.to_numpy().items():
        assert a.dtype == arrays[f].dtype
        np.testing.assert_array_equal(a, arrays[f])
