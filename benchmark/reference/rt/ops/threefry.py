"""Threefry-2x32 counter-based RNG, bit-identical to `jax.random`.

The reference's CPU McICA oracle (ops/mcica.py:generate_stochastic_clouds)
draws its subcolumn fields with jax.random under the partitionable threefry
scheme (jax_threefry_partitionable=True):

* key(0) is the word pair (0, 0);
* fold_in(k, d) is threefry2x32(k, (0, d));
* split(k, n) gives the pairs threefry2x32(k, (0, i)) for i < n;
* uniform(k, shape) takes bits = w0 ^ w1 of threefry2x32(k, (0, i)) over
  the row-major flat index i, and returns
  float_from_bits((bits >> 9) | 0x3F800000) - 1.

torch has no usable uint32 arithmetic, so words are carried in int64 and
masked to 32 bits after every add and shift.
"""

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 of the count words (x0, x1) under key (k0, k1).

    All arguments are int64 tensors (or ints) holding uint32 values; they
    broadcast against each other. Returns the two output words.
    """
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed=0, device="cuda"):
    """jax.random.key(seed) for 0 <= seed < 2**32: the pair (0, seed)."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    return torch.stack([z, z + seed])


def fold_in(k, data):
    """jax.random.fold_in. k: [..., 2] int64 key pairs; data: [...] uint32
    values as int64. Returns [..., 2]."""
    w0, w1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([w0, w1], dim=-1)


def split(k, num):
    """jax.random.split(k, num). k: [..., 2]; returns [..., num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    w0, w1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([w0, w1], dim=-1)


def uniform(k, shape):
    """jax.random.uniform(k, shape, float32) for a batch of keys.

    k: [..., 2]; returns [..., *shape] float32. The bits of element i of
    the row-major flattened shape are w0 ^ w1 of threefry2x32(k, (0, i));
    (bits >> 9) | 0x3F800000 is a float in [1, 2).
    """
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    w0, w1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    mant = (((w0 ^ w1) >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    return u.reshape(k.shape[:-1] + tuple(shape))
