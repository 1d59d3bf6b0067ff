"""Port parity: the port's arena lookup (plain ``lookup_arena`` and the
``cuckoo_lookup_arena`` wrapper, which runs its plain version on CPU
tensors) against the reference's ``lookup_arena`` and its interpret-mode
Pallas ``cuckoo_lookup_arena_auto``.  Integer outputs are exactly equal,
dtype included; the kernel path's bucket/slot are compared on hits, where
the reference defines them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CFTDeviceState as RefState
from repro.core import build_bank as ref_build_bank
from repro.core import build_forest as ref_build_forest
from repro.core import hashing as ref_hashing
from repro.core.lookup import bump_temperature_arena as ref_bump
from repro.core.lookup import lookup_arena as ref_lookup_arena
from repro.core.lookup import lookup_batch_ragged as ref_lookup_ragged
from repro.kernels.cuckoo_lookup import cuckoo_lookup_arena_auto as ref_kernel
from repro_torch.core import CFTDeviceState
from repro_torch.core.lookup import (bump_temperature_arena, lookup_arena,
                                     lookup_batch_ragged)
from repro_torch.core.trag import STATE_FIELDS
from repro_torch.kernels.cuckoo_lookup import cuckoo_lookup_arena

FIELDS = ("hit", "head", "bucket", "slot")


def _skewed_trees(rng, num_trees):
    """``tests/test_ragged.py::_skewed_forest``: sizes vary ~25x, empty
    trees allowed, one hot tree blown up further."""
    sizes = rng.integers(0, 14, size=num_trees)
    sizes[int(rng.integers(num_trees))] *= 8
    return [[(f"r{t}", f"e{t}_{i}") for i in range(int(sizes[t]))]
            for t in range(num_trees)]


def _states(trees):
    forest = ref_build_forest(trees)
    bank = ref_build_bank(forest)
    ref = RefState.from_bank(bank, forest)
    arrays = {f: np.asarray(jax.device_get(getattr(ref, f)))
              for f in STATE_FIELDS}
    return bank, forest, ref, CFTDeviceState.from_arrays(arrays, "cpu")


def _routed_queries(bank, forest, rng, misses=48):
    """Every stored (tree, entity) row plus random misses, routed as
    ``retrieve_device`` routes them."""
    hashes = ref_hashing.hash_entities(forest.entity_names)
    tid = np.concatenate([bank.row_tree, rng.integers(
        0, bank.num_trees, size=misses)]).astype(np.int32)
    hh = np.concatenate([
        hashes[bank.row_entity] if bank.num_rows else np.zeros(0, np.uint32),
        rng.integers(1, 2 ** 32, size=misses).astype(np.uint32)])
    off = bank.bucket_offsets[tid].astype(np.int32)
    mask = (bank.tree_nb[tid] - 1).astype(np.uint32)
    return tid, hh, off, mask


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, what, sel=None):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if sel is not None:
        got, want = got[sel], want[sel]
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lookup_arena_matches_reference(seed):
    rng = np.random.default_rng(seed)
    bank, forest, ref, st = _states(_skewed_trees(rng, int(rng.integers(3,
                                                                      10))))
    tid, hh, off, mask = _routed_queries(bank, forest, rng)
    want = ref_lookup_arena(ref.fingerprints, ref.heads, jnp.asarray(off),
                            jnp.asarray(mask), jnp.asarray(hh))
    got = lookup_arena(st.fingerprints, st.heads, _t(off), _t(mask), _t(hh))
    for f in FIELDS:                   # the plain version: every field
        _eq(getattr(got, f), getattr(want, f), f)
    assert bool(got.hit[:bank.num_rows].all())

    want_r = ref_lookup_ragged(ref.fingerprints, ref.heads,
                               ref.bucket_offsets, ref.tree_nb,
                               jnp.asarray(tid), jnp.asarray(hh))
    got_r = lookup_batch_ragged(st.fingerprints, st.heads, st.bucket_offsets,
                                st.tree_nb, _t(tid), _t(hh))
    for f in FIELDS:
        _eq(getattr(got_r, f), getattr(want_r, f), f"ragged {f}")


@pytest.mark.parametrize("seed", [5, 6])
def test_probe_wrapper_matches_reference_kernel(seed):
    """The port's kernel wrapper on CPU tensors (its plain version)
    against the reference's Pallas probe in interpret mode."""
    rng = np.random.default_rng(seed)
    bank, forest, ref, st = _states(_skewed_trees(rng, 7))
    tid, hh, off, mask = _routed_queries(bank, forest, rng, misses=200)
    want = ref_kernel(ref.fingerprints, ref.heads, jnp.asarray(off),
                      jnp.asarray(mask), jnp.asarray(hh))
    got = cuckoo_lookup_arena(st.fingerprints, st.heads, _t(off), _t(mask),
                              _t(hh))
    hit = _np(want.hit)
    _eq(got.hit, want.hit, "hit")
    _eq(got.head, want.head, "head")
    for f in ("bucket", "slot"):       # defined on hits only
        _eq(getattr(got, f), getattr(want, f), f, sel=hit)
    # int32 bit-pattern hashes are the same queries
    bits = torch.from_numpy(hh.view(np.int32).copy())
    again = cuckoo_lookup_arena(st.fingerprints, st.heads, _t(off), _t(mask),
                                bits)
    for f in FIELDS:
        _eq(getattr(again, f), getattr(got, f), f"bits {f}")


def test_bump_accumulates_duplicates():
    """Duplicate (row, slot) hits in one batch add up, as the reference's
    functional scatter-add does; the input table is untouched."""
    rng = np.random.default_rng(9)
    bank, forest, ref, st = _states(_skewed_trees(rng, 5))
    tid, hh, off, mask = _routed_queries(bank, forest, rng, misses=16)
    rep = np.r_[np.arange(tid.size), np.arange(tid.size)[:20]]
    hh, off, mask = hh[rep], off[rep], mask[rep]
    res_ref = ref_lookup_arena(ref.fingerprints, ref.heads, jnp.asarray(off),
                               jnp.asarray(mask), jnp.asarray(hh))
    want = ref_bump(ref.temperature, jnp.asarray(off), res_ref)
    res = lookup_arena(st.fingerprints, st.heads, _t(off), _t(mask), _t(hh))
    before = st.temperature.clone()
    got = bump_temperature_arena(st.temperature, _t(off), res)
    _eq(got, want, "temperature")
    assert bool((st.temperature == before).all())
    assert int(got.sum()) == int(res.hit.sum())

