"""The four counter-based random draws the trainer makes (numpy, host).

The trainer (``core/train.py``) draws, per tree, from a threefry2x32 key
derived from ``TrainConfig.seed``: ``split`` the key in four, a Poisson(1)
bootstrap weight per row (RandomForest bagging), a feature ``permutation``
(``colsample``) and a ``uniform`` per row (GOSS).  ``TrainConfig.seed``
names the same forest in the JAX reference and in this port only if these
draws give the same bits, so this module is a copy of the JAX algorithms
(``jax/_src/prng.py`` and ``jax/_src/random.py``, in the
``jax_threefry_partitionable`` mode, the default since JAX 0.5) in numpy
``uint32`` arithmetic, run on the host:

  * ``threefry2x32``: the 20-round Threefry-2x32 hash (``prng.py``
    ``_threefry2x32_lowering``, unrolled);
  * ``split``: counters (0, i) hashed under the key, one row of two words
    a new key (``_threefry_split_foldlike``);
  * ``random_bits``: the XOR of the two hashed words of the counters
    (0, i) (``_threefry_random_bits_partitionable``);
  * ``uniform``: the top 23 bits as a mantissa of [1, 2), minus 1
    (``random.py`` ``_uniform``);
  * ``permutation``: rounds of a stable sort on fresh 32-bit keys
    (``_shuffle``);
  * ``poisson``: Knuth's algorithm for lam < 10, one ``split`` and one
    ``uniform`` over every row an iteration while any row's log product
    is above -lam (``_poisson_knuth``).

A key is an explicit value, a ``uint32`` array of shape (2,); nothing here
holds state.

The one step that is not bit-exact: Knuth's ``log``.  XLA's CPU ``log``
is not correctly rounded: on 2M of these uniforms it differs from
``torch.log`` on 14 % of float32 inputs, by one ulp (from ``np.log`` on
23 %, by up to four), so this module takes ``torch.log`` on the CPU.  A
Poisson draw changes only where a row's running log product lands within
a few ulps of -lam, on either side -- a few 1e-7 a row -- and the draws
are deterministic per key, so a pinned key either agrees every time or
differs every time (``tests/test_torch_train.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["prng_key", "threefry2x32", "split", "random_bits", "uniform",
           "permutation", "poisson"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as (high, low) words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x1: np.ndarray,
                 x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter pairs (x1, x2) under ``key``."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = np.asarray(x1, np.uint32) + ks[0]
    b = np.asarray(x2, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = _rotl(b, r) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3]
        b = b + np.uint32(i + 1)
    return a, b


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``iota_2x32_shape((n,))``: the 64-bit counters 0..n-1 as words."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32 keys."""
    a, b = threefry2x32(key, *_counters(num))
    return np.stack([a, b], axis=1)


def random_bits(key: np.ndarray, n: int) -> np.ndarray:
    """[n] uint32 random words (``bit_width=32``)."""
    a, b = threefry2x32(key, *_counters(n))
    return a ^ b


def uniform(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))``: [n] float32 in [0, 1)."""
    bits = random_bits(key, n) >> np.uint32(32 - 23) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0),
                      bits.view(np.float32) - np.float32(1.0))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: a permutation of arange(n),
    int32."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, n), kind="stable")]
    return x


def poisson(key: np.ndarray, lam: float, n: int) -> np.ndarray:
    """``jax.random.poisson(key, lam, (n,))`` for 0 <= lam < 10 (Knuth):
    [n] int32."""
    if not 0 <= lam < 10:
        raise ValueError(f"only Knuth's range 0 <= lam < 10 is ported, "
                         f"got {lam}")
    k = np.zeros(n, np.int32)
    if lam == 0:
        return k
    neg_lam = -np.float32(lam)
    log_prod = np.zeros(n, np.float32)
    rng = key
    while (log_prod > neg_lam).any():
        rng, sub = split(rng)
        k = np.where(log_prod > neg_lam, k + np.int32(1), k)
        log_prod = log_prod + torch.log(
            torch.from_numpy(uniform(sub, n))).numpy()
    return k - np.int32(1)
