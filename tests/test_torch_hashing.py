"""Port parity: every hashing function of ``repro_torch.core.hashing`` (numpy
host half and torch device half) equals ``repro.core.hashing`` bit for
bit on random uint32 inputs, the extremes 0 and 0xFFFFFFFF included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as ref
from repro_torch.core import hashing as port

_RNG = np.random.default_rng(11)
H = np.concatenate([
    np.asarray([0, 0xFFFFFFFF, 1, 2 ** 31 - 1, 2 ** 31, 0x9E3779B9],
               np.uint64),
    _RNG.integers(0, 2 ** 32, size=4000, dtype=np.uint64)]).astype(np.uint32)
MASKS = (2 ** _RNG.integers(0, 20, size=H.size) - 1).astype(np.uint32)
NAMES = ["", "a", "Cardiology Ward T3_7", "naïve café", "x" * 300,
         "Oncology Headquarters T0_0", "🙂 unit"]


def _as_torch(a: np.ndarray, form: str) -> torch.Tensor:
    """uint32 values in the three integer forms the torch half accepts."""
    if form == "int64":
        return torch.from_numpy(a.astype(np.int64))
    if form == "int32_bits":
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())                     # torch.uint32


FORMS = ("int64", "int32_bits", "uint32")


def _eq_torch(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_fnv1a_and_entity_hash():
    for s in NAMES:
        assert port.fnv1a_64(s) == ref.fnv1a_64(s)
        got, want = port.entity_hash(s), ref.entity_hash(s)
        assert type(got) is type(want) and got == want


def test_hash_entities_batch():
    got, want = port.hash_entities(NAMES), ref.hash_entities(NAMES)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    assert port.hash_entities([]).dtype == np.uint32


def test_numpy_half_matches():
    pairs = [
        (port._mix(H), ref._mix(H, np)),
        (port.fingerprint(H), ref.fingerprint(H)),
        (port.bucket_i1(H, 1024), ref.bucket_i1(H, 1024)),
        (port.bucket_i1_masked(H, MASKS), ref.bucket_i1_masked(H, MASKS)),
    ]
    fp = ref.fingerprint(H)
    i1 = ref.bucket_i1_masked(H, MASKS)
    pairs += [
        (port.alt_bucket(i1 & 255, fp, 256), ref.alt_bucket(i1 & 255, fp,
                                                            256)),
        (port.alt_bucket_masked(i1, fp, MASKS),
         ref.alt_bucket_masked(i1, fp, MASKS)),
    ]
    pairs += list(zip(port.candidate_buckets_masked(H, MASKS),
                      ref.candidate_buckets_masked(H, MASKS)))
    for got, want in pairs:
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


def test_numpy_scalar_forms():
    """The scalar forms the host build's kick chain calls."""
    for h in (0, 0xFFFFFFFF, 123456789):
        h = np.uint32(h)
        assert int(port.fingerprint(h)) == int(ref.fingerprint(h))
        assert int(port.bucket_i1(h, 16)) == int(ref.bucket_i1(h, 16))
        fp = ref.fingerprint(h)
        assert int(port.alt_bucket(np.uint32(5), fp, 16)) == \
            int(ref.alt_bucket(np.uint32(5), fp, 16))


@pytest.mark.parametrize("form", FORMS)
def test_torch_half_matches_device_reference(form):
    """The int64-masked torch half against the reference's jnp uint32
    device half, for every accepted input form."""
    ht, mt = _as_torch(H, form), _as_torch(MASKS, form)
    hj, mj = jnp.asarray(H), jnp.asarray(MASKS)
    _eq_torch(port._mix(ht), ref._mix(hj, jnp))
    _eq_torch(port.fingerprint(ht), ref.fingerprint(hj, jnp))
    for got, want in zip(port.candidate_buckets_masked(ht, mt),
                         ref.candidate_buckets_masked(hj, mj, jnp)):
        _eq_torch(got, want)
    _eq_torch(port.bucket_i1(ht, 4096), ref.bucket_i1(hj, 4096, jnp))
    fp = ref.fingerprint(hj, jnp)
    i1 = ref.bucket_i1(hj, 4096, jnp)
    _eq_torch(port.alt_bucket(torch.from_numpy(np.asarray(i1).astype(
        np.int64)), torch.from_numpy(np.asarray(fp).astype(np.int64)), 4096),
        ref.alt_bucket(i1, fp, 4096, jnp))


def test_u32_bits_maps_high_values_explicitly():
    v = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                     dtype=torch.int64)
    bits = port.u32_bits(v)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray([0, 1, 2 ** 31 - 1, -2 ** 31, -1],
                                 np.int32))
    np.testing.assert_array_equal(port.u32(bits).numpy(), v.numpy())
    same = torch.tensor([-5, 7], dtype=torch.int32)
    assert port.u32_bits(same) is same
