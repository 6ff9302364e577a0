"""The port's own copy of the ``jax.random`` calls that GBDT's masks make.

It reproduces jax 0.9.0's default PRNG, ``threefry2x32`` with
``jax_threefry_partitionable=True``, bit for bit:

- :func:`PRNGKey` (a key is two uint32 words: 0 and the seed mod 2^32);
- :func:`fold_in` (the threefry hash of the counter pair ``(0, data)``);
- :func:`split` (key ``i`` hashes the counter ``(0, i)``);
- :func:`random_bits` (element ``i`` hashes the 64-bit counter ``i`` as the
  pair ``(i >> 32, i & 0xffffffff)`` and XORs the two output words);
- :func:`uniform` (the top 23 bits as an f32 mantissa in [1, 2), minus 1);
- :func:`permutation` (jax's ``_shuffle``: ``ceil(3 ln n / ln(2^32 - 1))``
  rounds, each a split and a stable sort by 32 random bits);
- :func:`normal` (``_normal_real``: a uniform draw on
  ``[nextafter(-1, 0), 1)`` through XLA's f32 ``erf_inv``, times √2).

Keys and the small draws live on the host as numpy uint32 arrays.
:func:`normal` is the one draw that is not bit for bit: ``torch.log1p``
rounds a few values an ulp away from XLA's, so it is held to
:data:`NORMAL_MAX_ULP` of ``jax.random.normal`` (``tests/test_torch_prng.py``).
:func:`uniform` also takes a torch device: the row draw of a tree is
``[N]`` and is made where the rows are, in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry_rounds(k0, k1, x0, x1, wrap):
    """The 20 rounds of Threefry-2x32 with its five key injections.
    ``wrap`` reduces a sum or a left shift to 32 bits: the identity for
    numpy uint32 (which wraps by itself), ``& 0xffffffff`` for int64
    tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = wrap(x0 + ks[0])
    x1 = wrap(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = (wrap(x1 << r) | (x1 >> (32 - r))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(wrap(x1 + ks[(i + 2) % 3]) + (i + 1))
    return x0, x1


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Hash the uint32 counter pairs ``(x0, x1)`` under ``key`` (uint32
    [2]); returns the two uint32 output words."""
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    x0 = np.asarray(x0, dtype=np.uint32)
    x1 = np.asarray(x1, dtype=np.uint32)
    with np.errstate(over="ignore"):
        return _threefry_rounds(k[0:1], k[1:2], x0, x1, lambda v: v)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` under 32-bit jax: ``[0, seed mod
    2^32]``."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: a new key from ``key`` and a uint32."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.concatenate([y0, y1])


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` under the partitionable setting: [num, 2]."""
    y0, y1 = threefry2x32(key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, n: int) -> np.ndarray:
    """32 random bits for each of ``n`` elements (uint32 [n])."""
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(_MASK)).astype(np.uint32))
    return y0 ^ y1


def _random_bits_torch(key: np.ndarray, n: int,
                       device: torch.device) -> torch.Tensor:
    """:func:`random_bits` in int64 tensors on ``device`` (values in
    [0, 2^32))."""
    k0, k1 = (int(v) for v in np.asarray(key, dtype=np.uint32))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry_rounds(k0, k1, idx >> 32, idx & _MASK,
                              lambda v: v & _MASK)
    return y0 ^ y1


def uniform(key: np.ndarray, n: int,
            device: Optional[torch.device] = None):
    """``jax.random.uniform(key, (n,))`` in f32 [0, 1): numpy on the host
    (``device`` None), else a float32 tensor made on ``device``."""
    one = int(np.array(1.0, np.float32).view(np.uint32))
    if device is None:
        bits = (random_bits(key, n) >> np.uint32(9)) | np.uint32(one)
        return bits.view(np.float32) - np.float32(1.0)
    bits = (_random_bits_torch(key, n, device) >> 9) | one
    return bits.to(torch.int32).view(torch.float32) - 1.0


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: a shuffle of ``arange(n)``
    (int32 [n]) by jax's rounds of stable sorts on random keys."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    for _ in range(rounds):
        key, subkey = split(key)
        x = x[np.argsort(random_bits(subkey, n), kind="stable")]
    return x



#: the most that :func:`normal` differs from ``jax.random.normal`` in units
#: in the last place: ``torch.log1p`` and XLA's differ by an ulp on some
#: inputs, and the polynomial carries that through (3 seen over 2^20 draws)
NORMAL_MAX_ULP = 4

# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 for w = -log1p(-x^2) < 5, else in
# sqrt(w) - 3, highest power first
_ERF_INV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` in torch ops (``torch.erfinv`` is another
    approximation: on 2^20 uniform draws √2·erfinv differs from
    ``jax.random.normal`` by up to 2.05e-5). ±1 map to ±inf."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.full_like(x, _ERF_INV_W_GE_5[0])
    p = torch.where(small, _ERF_INV_W_LT_5[0], p)
    for lt, ge in zip(_ERF_INV_W_LT_5[1:], _ERF_INV_W_GE_5[1:]):
        p = torch.where(small, lt, ge).to(x.dtype) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: np.ndarray, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32, within
    :data:`NORMAL_MAX_ULP`: ``uniform`` scaled onto ``[nextafter(-1, 0),
    1)`` as jax's ``_uniform`` does (``max(lo, u * (hi - lo) + lo)``, with
    ``hi - lo`` = 2 in f32), then √2 · :func:`erf_inv`. A CPU tensor: the
    caller moves it, so every device starts from the same values."""
    shape = tuple(int(d) for d in shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.from_numpy(uniform(key, int(np.prod(shape, dtype=np.int64))))
    u = torch.clamp_min(u * 2.0 + lo, lo)
    return (float(np.float32(np.sqrt(2.0))) * erf_inv(u)).reshape(shape)
