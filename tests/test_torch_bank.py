"""Port parity: the port's forest, filter-bank build and device state are
byte-equal to the reference's (dtype included) on hospital, skewed and
empty-tree forests, including the seeded kick order, forced-uniform and
scalar builds, and tree-local doubling."""
import jax
import numpy as np
import pytest

from repro.core import CFTDeviceState as RefState
from repro.core import build_bank as ref_build_bank
from repro.core import build_forest as ref_build_forest
from repro.core.bank import pad_csr as ref_pad_csr
from repro.data.datasets import hospital_corpus as ref_hospital
from repro_torch.core import CFTDeviceState, build_bank, build_forest, pad_csr
from repro_torch.core.trag import STATE_FIELDS
from repro_torch.data import hospital_corpus

FOREST_ARRAYS = ("parent", "entity_id", "tree_id", "depth", "child_offsets",
                 "child_index", "roots")
BANK_ARRAYS = ("tree_nb", "bucket_offsets", "fingerprints", "temperature",
               "heads", "entity_ids", "stored_hash", "csr_offsets",
               "csr_nodes", "row_tree", "row_entity", "num_items")


def skewed_trees(tree_sizes, deep_every=0, seed=0):
    """Ragged forest edge lists (``tests/test_fused.py::_forest``): every
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


def hub_trees(num_trees, seed=0):
    """``benchmarks/bench_kernels.py::skewed_forest``: every 7th tree is a
    deep hub with a random-parent tail."""
    rng = np.random.default_rng(seed)
    trees = []
    for t in range(num_trees):
        names = [f"e{t}_{i}" for i in range(4)]
        edges = [(f"r{t}", n) for n in names]
        if t % 7 == 0:
            for j in range(40):
                parent = names[int(rng.integers(len(names)))]
                child = f"e{t}_h{j}"
                edges.append((parent, child))
                names.append(child)
        trees.append(edges)
    return trees


CASES = {
    "hospital": lambda: hospital_corpus(num_trees=12).trees,
    "skewed": lambda: skewed_trees((6, 1, 14, 3, 0, 9), deep_every=3),
    "empty_trees": lambda: [[("r0", "a"), ("r0", "b")], [],
                            [(f"r2", f"e2_{i}") for i in range(60)], []],
    "hubs": lambda: hub_trees(16),
}


def _eq(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_hospital_corpus_identical():
    got, want = hospital_corpus(num_trees=9), ref_hospital(num_trees=9)
    assert got.trees == want.trees and got.entities == want.entities
    assert got.queries == want.queries
    assert got.query_entities == want.query_entities
    assert got.documents == want.documents


@pytest.mark.parametrize("case", sorted(CASES))
def test_forest_identical(case):
    trees = CASES[case]()
    got, want = build_forest(trees), ref_build_forest(trees)
    for f in FOREST_ARRAYS:
        _eq(getattr(got, f), getattr(want, f), f)
    assert got.entity_names == want.entity_names
    assert got.entity_locations == want.entity_locations
    assert got.num_trees == want.num_trees


@pytest.mark.parametrize("kw", [{}, {"num_buckets": 8}, {"bulk": False},
                                {"load_target": 0.97}],
                         ids=["ragged", "uniform8", "scalar", "tight"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bank_byte_equal(case, kw):
    trees = CASES[case]()
    got = build_bank(build_forest(trees), **kw)
    want = ref_build_bank(ref_build_forest(trees), **kw)
    for f in BANK_ARRAYS:
        _eq(getattr(got, f), getattr(want, f), f)
    assert got.build_stats == want.build_stats
    assert (got.num_trees, got.slots) == (want.num_trees, want.slots)
    assert got.total_buckets == want.total_buckets
    assert got.segment(got.num_trees - 1) == want.segment(want.num_trees - 1)


def test_tree_local_doubling_exercised():
    """A forced small uniform NB overflows and doubles; a ragged build of
    the same forest keeps the empty trees at the minimum."""
    trees = CASES["empty_trees"]()
    bank = build_bank(build_forest(trees), num_buckets=4)
    assert bank.build_stats["rebuilds"] >= 1
    ragged = build_bank(build_forest(trees))
    assert int(ragged.tree_nb[1]) == 1 and int(ragged.tree_nb[3]) == 1


def test_pad_csr_identical():
    rng = np.random.default_rng(3)
    for n in (0, 5, 300, 1025):
        off = np.concatenate([[0], np.cumsum(rng.integers(0, 3, n))])
        nodes = rng.integers(0, 99, int(off[-1]))
        for g, w in zip(pad_csr(off, nodes), ref_pad_csr(off, nodes)):
            _eq(g, w, f"pad_csr n={n}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_state_byte_equal(case):
    trees = CASES[case]()
    forest, rforest = build_forest(trees), ref_build_forest(trees)
    got = CFTDeviceState.from_bank(build_bank(forest), forest, device="cpu")
    ref = RefState.from_bank(ref_build_bank(rforest), rforest)
    want = {f: np.asarray(jax.device_get(getattr(ref, f)))
            for f in STATE_FIELDS}
    mine = got.to_numpy()
    for f in STATE_FIELDS:
        _eq(mine[f], want[f], f)
    assert got.num_trees == ref.num_trees
    # the reference's arrays feed straight into a port state
    again = CFTDeviceState.from_arrays(want, device="cpu").to_numpy()
    for f in STATE_FIELDS:
        _eq(again[f], want[f], f"from_arrays {f}")


def test_state_does_not_alias_host_bank():
    forest = build_forest(CASES["skewed"]())
    bank = build_bank(forest)
    state = CFTDeviceState.from_bank(bank, forest, device="cpu")
    before = state.temperature.clone()
    bank.temperature += 5
    assert bool((state.temperature == before).all())
