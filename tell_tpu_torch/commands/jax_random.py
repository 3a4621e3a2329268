"""The few draws of jax.random that `towers verify`'s probes take, in numpy
(the port does not import JAX), bit for bit as JAX 0.9.0 makes them on
the CPU with its default `jax_threefry_partitionable`:

* ``prng_key(seed)``: PRNGKey(seed), the threefry key (seed >> 32, seed &
  0xFFFFFFFF);
* ``random_bits(key, shape)``: threefry2x32 (20 rounds) of each element's
  flat index as a 64-bit counter (hi, lo), its two output words XORed;
* ``split(key, n)``: the keys threefry2x32(key, (0, i)), both words;
* ``normal(key, shape)``: float32 uniforms on (nextafter(-1, 1), 1) from
  the bits' 23 high mantissa bits, through XLA's float32 erf_inv (Giles'
  polynomials, with log1p) times sqrt(2), each step in float32;
* ``randint(key, shape, lo, hi)``: two bit streams from split(key), the
  high one reduced by span and scaled by (2**16 % span)**2 % span, plus
  the low one, all mod span, as jax.random.randint's int32 path does.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """jax.random's threefry_2x32 of counters (x0, x1) under key (k0, k1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def split(key, n: int = 2) -> np.ndarray:
    b0, b1 = threefry2x32(key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's ErfInv32 in float32."""
    f = np.float32
    small = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
             -4.39150654e-06, 0.00021858087, -0.00125372503,
             -0.00417768164, 0.246640727, 1.50140941)
    large = (-0.000200214257, 0.000100950558, 0.00134934322,
             -0.00367342844, 0.00573950773, -0.0076224613,
             0.00943887047, 1.00167406, 2.83297682)
    w = -np.log1p(-x * x)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.where(lt, f(small[0]), f(large[0])).astype(f)
    for a, b in zip(small[1:], large[1:]):
        p = (np.where(lt, f(a), f(b)) + p * w).astype(f)
    return np.where(np.abs(x) == f(1.0), x * np.finfo(f).max, p * x)


def uniform(key, shape, lo: float, hi: float) -> np.ndarray:
    f = np.float32
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f) - f(1)
    lo, hi = f(lo), f(hi)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(f)


def normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape), float32."""
    f = np.float32
    lo = np.nextafter(f(-1.0), f(np.inf))
    u = uniform(key, shape, lo, f(1.0))
    return (f(np.sqrt(2)) * _erf_inv(u)).astype(f)


def randint(key, shape, lo: int, hi: int) -> np.ndarray:
    """jax.random.randint(key, shape, lo, hi), int32 (lo < hi)."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(hi - lo)
    mult = np.uint32((1 << 16) % int(span))
    mult = np.uint32((int(mult) * int(mult)) % int(span))
    with np.errstate(over="ignore"):
        off = (higher % span) * mult + lower % span
    return (np.int32(lo) + (off % span).astype(np.int32)).astype(np.int32)
