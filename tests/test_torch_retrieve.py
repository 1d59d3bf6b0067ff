"""Port parity: the port's ``retrieve_device``, unfused and ``fused=True``
(CPU tensors run the fused kernel's plain version), against the
reference's jitted unfused chain and its interpret-mode fused Pallas path
— all five ``DeviceRetrieval`` fields exactly equal, dtype included —
over ragged, skewed and empty-tree forests, miss-heavy batches,
out-of-range tree ids, several walk geometries and temperature rounds
threaded forward on every path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CFTDeviceState as RefState
from repro.core import build_bank as ref_build_bank
from repro.core import build_forest as ref_build_forest
from repro.core import hashing as ref_hashing
from repro.core import retrieve_device as ref_retrieve
from repro_torch.core import CFTDeviceState, retrieve_device
from repro_torch.core.trag import STATE_FIELDS
from repro_torch.kernels.cuckoo_lookup import cuckoo_lookup_arena

FIELDS = ("hit", "locations", "up", "down", "temperature")
_ref_unfused = jax.jit(ref_retrieve, static_argnames=("max_locs", "n"))


def _trees(tree_sizes, deep_every=0, seed=0):
    """``tests/test_fused.py::_forest`` edge lists: every
    ``deep_every``-th tree gets a skewed random-parent tail; a size-0
    entry builds a root-only tree."""
    rng = np.random.default_rng(seed)
    trees = []
    for t, size in enumerate(tree_sizes):
        names = [f"e{t}_{i}" for i in range(size)]
        edges = [(f"r{t}", n) for n in names]
        if not size:
            edges = [(f"r{t}", f"only{t}")]
        if deep_every and t % deep_every == 0 and names:
            for j in range(11):
                parent = names[int(rng.integers(len(names)))]
                child = f"e{t}_d{j}"
                edges.append((parent, child))
                names.append(child)
        trees.append(edges)
    return trees


def _queries(trees, batch, hit_rate, seed=0, oob=True):
    """(hashes uint32, tree ids int32); ids 0 and 1 out of range."""
    rng = np.random.default_rng(seed)
    num_trees = len(trees)
    qt = rng.integers(num_trees, size=batch).astype(np.int32)
    qh = np.empty(batch, np.uint32)
    for i in range(batch):
        ents = [c for _, c in trees[qt[i]]]
        if rng.random() < hit_rate and ents:
            qh[i] = ref_hashing.entity_hash(ents[int(rng.integers(len(ents)))])
        else:
            qh[i] = rng.integers(1, 2 ** 32)
    if oob and batch >= 4:
        qt[0], qt[1] = -2, num_trees + 5
    return qh, qt


def _states(trees):
    forest = ref_build_forest(trees)
    ref = RefState.from_bank(ref_build_bank(forest), forest)
    arrays = {f: np.asarray(jax.device_get(getattr(ref, f)))
              for f in STATE_FIELDS}
    return ref, CFTDeviceState.from_arrays(arrays, device="cpu")


def _port_args(qh, qt):
    return (torch.from_numpy(qh.astype(np.int64)),
            torch.from_numpy(qt.astype(np.int32)))


def _assert_same(got, want, msg=""):
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, f"{f} {msg}: {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{f} {msg}")


@pytest.mark.parametrize("sizes,hit_rate", [
    ((6, 1, 14, 3), 0.9),
    ((2, 9, 0, 5, 7, 4, 11, 3), 0.5),                    # an empty tree
    (tuple(3 + (t % 6) * 4 for t in range(24)), 0.1),    # miss-heavy
])
def test_unfused_and_fused_match_reference(sizes, hit_rate):
    trees = _trees(sizes, deep_every=3)
    ref, st = _states(trees)
    qh, qt = _queries(trees, 96, hit_rate)
    want = _ref_unfused(ref, jnp.asarray(qh), jnp.asarray(qt))
    _assert_same(ref_retrieve(ref, jnp.asarray(qh), jnp.asarray(qt),
                              fused=True), want, "reference fused")
    h, t = _port_args(qh, qt)
    _assert_same(retrieve_device(st, h, t), want, "port unfused")
    _assert_same(retrieve_device(st, h, t, fused=True), want, "port fused")
    _assert_same(retrieve_device(st, h, t, lookup_fn=cuckoo_lookup_arena),
                 want, "port probe wrapper")
    assert not bool(retrieve_device(st, h, t).hit[:2].any())  # out of range


def test_temperature_rounds_threaded():
    """Bump equivalence holds cumulatively: each round's temperature is
    threaded forward on every path and compared every round."""
    trees = _trees((8, 12, 4, 9), deep_every=2)
    ref, st = _states(trees)
    s_unf = s_fus = st
    for rnd in range(3):
        qh, qt = _queries(trees, 64, 0.8, seed=rnd)
        want = _ref_unfused(ref, jnp.asarray(qh), jnp.asarray(qt))
        h, t = _port_args(qh, qt)
        got_u = retrieve_device(s_unf, h, t)
        got_f = retrieve_device(s_fus, h, t, fused=True)
        _assert_same(got_u, want, f"unfused round {rnd}")
        _assert_same(got_f, want, f"fused round {rnd}")
        ref = ref.with_temperature(want.temperature)
        s_unf = s_unf.with_temperature(got_u.temperature)
        s_fus = s_fus.with_temperature(got_f.temperature)
    assert int(s_fus.temperature.sum()) > 0
    # the input state is never bumped in place
    assert int(st.temperature.sum()) == 0


@pytest.mark.parametrize("seed", range(6))
def test_random_geometry_sweep(seed):
    """Forest shape, batch size, hit rate and walk geometry drawn from a
    seed: port paths equal the reference, bit for bit."""
    rng = np.random.default_rng(1000 + seed)
    sizes = tuple(int(s) for s in rng.integers(0, 19, rng.integers(1, 13)))
    batch = int(rng.integers(1, 151))
    hit_rate = float(rng.integers(0, 11)) / 10.0
    max_locs, n = int(rng.integers(1, 7)), int(rng.integers(1, 5))
    trees = _trees(sizes, deep_every=2, seed=seed)
    ref, st = _states(trees)
    qh, qt = _queries(trees, batch, hit_rate, seed=seed)
    want = _ref_unfused(ref, jnp.asarray(qh), jnp.asarray(qt),
                        max_locs=max_locs, n=n)
    h, t = _port_args(qh, qt)
    msg = f"seed={seed} max_locs={max_locs} n={n}"
    _assert_same(retrieve_device(st, h, t, max_locs=max_locs, n=n), want,
                 "unfused " + msg)
    _assert_same(retrieve_device(st, h, t, max_locs=max_locs, n=n,
                                 fused=True), want, "fused " + msg)


def test_nodeless_forest_and_default_trees():
    """A forest with no nodes at all (padded one-entry forest tables) and
    the default all-zero tree ids."""
    ref, st = _states([[]])
    qh = np.asarray([0, 1, 0xFFFFFFFF, 12345], np.uint32)
    want = _ref_unfused(ref, jnp.asarray(qh))
    h = torch.from_numpy(qh.astype(np.int64))
    _assert_same(retrieve_device(st, h), want, "unfused")
    _assert_same(retrieve_device(st, h, fused=True), want, "fused")


def test_fused_rejects_lookup_fn():
    _, st = _states(_trees((4,)))
    h, t = _port_args(*_queries(_trees((4,)), 8, 1.0, oob=False))
    with pytest.raises(ValueError, match="lookup_fn"):
        retrieve_device(st, h, t, fused=True, lookup_fn=cuckoo_lookup_arena)
