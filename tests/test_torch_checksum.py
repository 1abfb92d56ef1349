"""The port's device checksum vs the JAX package's, on the CPU.

The same numpy inputs from a seed go through the JAX ``device_checksum``
(its Pallas kernel in interpret mode) and the port's (``device="cpu"``: the
plain PyTorch version, the one the CUDA kernel is held to on the card).
Checksums are integers, so every comparison is exact equality: every dtype
the checksum reads, lengths 1-7, ``n = b``, ragged ``n``, ``block=512``,
blocks large enough for the reference's uint32 sums to wrap, and uint8
bytes counted as one word each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.checksum import checksum_ref as jax_checksum_ref
from repro.kernels.checksum import device_checksum as jax_device_checksum
from repro_torch.kernels.checksum import (
    checksum_ref,
    device_checksum,
    to_words,
    verify_replicas,
)

RNG_SEED = 12
MOD = 65521

DTYPES = ["bool", "uint8", "int8", "uint16", "int16", "int32", "uint32",
          "int64", "uint64", "float16", "bfloat16", "float32", "float64"]


def _inputs(dtype: str, n: int, seed: int = RNG_SEED) -> np.ndarray:
    """``n`` values of ``dtype`` over its whole range (negative integers,
    float specials); bfloat16 comes as float32 values that bfloat16 holds
    exactly, so both packages see the same numbers."""
    rng = np.random.default_rng(seed)
    with np.errstate(over="ignore"):  # 1e300 becomes inf in narrow floats
        return _draw(rng, dtype, n)


def _draw(rng, dtype, n):
    if dtype == "bool":
        return rng.random(n) < 0.5
    if dtype in ("float16", "bfloat16", "float32", "float64"):
        x = rng.normal(scale=1e3, size=n)
        specials = [0.0, -0.0, np.inf, -np.inf, 1e-42, 6e-8, 1e300]
        x[: min(n, len(specials))] = specials[:n]
        if dtype == "bfloat16":
            bits = x.astype(np.float32).view(np.uint32) & 0xFFFF0000
            return bits.view(np.float32)
        return x.astype(dtype)
    raw = rng.bit_generator.random_raw(n)
    return raw.astype(np.uint64).view(np.int64).astype(dtype)


def _jax(x: np.ndarray, dtype: str, **kw) -> np.ndarray:
    arr = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else x
    with np.errstate(over="ignore"):  # JAX narrows float64 to float32
        return np.asarray(jax_device_checksum(arr, **kw))


def _port(x: np.ndarray, dtype: str, **kw) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    out = device_checksum(t, **kw)
    assert out.dtype == torch.int64 and out.shape == (2,)
    return out.numpy()


CASES = (
    [(d, n, 2048) for d in DTYPES for n in (3, 2048 * 2 + 5)]
    + [(d, n, 2048) for d in ("uint8", "int8", "float32") for n in range(1, 8)]
    + [("uint8", 2048, 2048), ("int32", 2048, 2048)]
    + [(d, n, 512) for d in ("uint8", "int32", "float16")
       for n in (512, 4096, 512 * 3 + 7)]
    # blocks past 32768 words; at 2*10^5 words of full-range uint32 the
    # reference's uint32 block sums wrap
    + [("uint32", 450_000, 200_000), ("int8", 90_001, 40_000)]
)


@pytest.mark.parametrize("dtype,n,block", CASES)
def test_port_equals_jax_checksum(dtype, n, block):
    x = _inputs(dtype, n)
    np.testing.assert_array_equal(
        _port(x, dtype, block=block), _jax(x, dtype, block=block))


def test_bytes_are_one_word_each():
    payload = bytes(range(10))
    want = [45, 330]
    assert device_checksum(payload, device="cpu").tolist() == want
    assert device_checksum(np.frombuffer(payload, np.uint8),
                           device="cpu").tolist() == want
    np.testing.assert_array_equal(
        _jax(np.frombuffer(payload, np.uint8), "uint8"), want)


@pytest.mark.parametrize("x,want", [
    (np.array([-1, 2], np.int8), [226, 228]),
    (np.array([2 ** 40 + 5], np.int64), [5, 5]),
    (np.array([True, False, True]), [2, 4]),
])
def test_word_casts(x, want):
    assert device_checksum(x, device="cpu").tolist() == want
    np.testing.assert_array_equal(np.asarray(jax_device_checksum(x)), want)


def test_checksum_vs_ref_and_detects_corruption():
    """The reference's own test, mirrored."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 31 - 1, 4096).astype(np.int32)
    got = device_checksum(x, block=512, device="cpu")
    assert torch.equal(got, checksum_ref(torch.from_numpy(x), block=512))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jax_checksum_ref(jnp.asarray(x).astype(jnp.uint32),
                                    block=512)))
    y = x.copy()
    y[1234] ^= 1
    bad = device_checksum(y, block=512, device="cpu")
    assert not torch.equal(bad, got)
    assert verify_replicas([got, got, got])
    assert not verify_replicas([got, bad])


def test_checksum_any_dtype():
    """The reference's own test, mirrored."""
    f = np.random.default_rng(0).normal(size=(33, 65)).astype(np.float32)
    c1 = device_checksum(f, device="cpu")
    c2 = device_checksum(f + np.float32(1e-3), device="cpu")
    assert not torch.equal(c1, c2)
    np.testing.assert_array_equal(c1.numpy(),
                                  np.asarray(jax_device_checksum(f)))


def _sequential_fold(words: np.ndarray, b: int) -> list[int]:
    """The reference kernel's grid loop (``kernel.py:26-48``) one block at
    a time, in numpy uint32 arithmetic."""
    mod = np.uint32(MOD)
    x = np.zeros(-(-words.size // b) * b, np.uint32)
    x[: words.size] = words
    w = (np.arange(b, dtype=np.uint32) + np.uint32(1)) % mod
    acc1 = acc2 = np.uint32(0)
    with np.errstate(over="ignore"):
        for blk in x.reshape(-1, b):
            r = blk % mod
            s1 = r.sum(dtype=np.uint32) % mod
            s2 = ((r * w) % mod).sum(dtype=np.uint32) % mod
            acc1, acc2 = (
                (acc1 + s1) % mod,
                (acc2 + (acc1 * np.uint32(b % MOD)) % mod + s2) % mod,
            )
    return [int(acc1), int(acc2)]


@pytest.mark.parametrize("dtype,n,block", [
    ("uint8", 100_003, 2048),
    ("int32", 4096 * 3 + 1, 512),
    ("float32", 777, 64),
    ("uint32", 450_000, 200_000),
])
def test_chunked_fold_equals_one_shot_fold(dtype, n, block):
    x = torch.from_numpy(_inputs(dtype, n))
    if block > 32768:  # the case exists to make the uint32 sums wrap
        assert int((to_words(x[:block]) % MOD).sum()) >= 2 ** 32
    nb = -(-n // block)
    one_shot = checksum_ref(x, block, chunk_blocks=nb)
    for chunk in (1, 3, 7):
        assert torch.equal(checksum_ref(x, block, chunk_blocks=chunk),
                           one_shot)
    assert one_shot.tolist() == _sequential_fold(
        to_words(x).numpy().astype(np.uint32), block)


def test_device_rules(monkeypatch):
    x = _inputs("uint8", 100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for data in (x, x.tobytes()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_checksum(data)
    with pytest.raises(ValueError, match="where it lies"):
        device_checksum(torch.from_numpy(x), device="cuda")
    with pytest.raises(ValueError, match="empty"):
        device_checksum(np.zeros(0, np.uint8), device="cpu")
    with pytest.raises(ValueError, match="block must be positive"):
        device_checksum(x, block=0, device="cpu")
    with pytest.raises(TypeError, match="no checksum"):
        device_checksum(torch.zeros(4, dtype=torch.complex64))
