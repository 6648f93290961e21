"""The dropout draws of a training run, made again from its seed.

The program draws every dropout decision from two generators seeded with
the run's seed: a generator on the card gives each dropout site u8 draws of
its activation's shape (``torch.randint(0, 256)``), in the order the forward
reaches the sites, and a CPU generator gives each attention call a seed in
[0, 2^31 - 1), from which the attention kernel takes its u8 draws over
(B, H, L, L) from the Philox4x32-10 counter generator (Salmon et al., SC'11)
keyed on (seed, 0): element e = ((b H + h) L + i) L + j is the low byte of
word e mod 4 at counter (e / 4 mod 2^32, e / 2^34, 0, 0).

``DropSource`` makes the same draws from the same seed, so the reference
drops what the program drops.
"""

from __future__ import annotations

import torch

SEED_BOUND = 2**31 - 1
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_LOW32 = 0xFFFFFFFF


def _mul_hi_lo(a: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of a * x (x holds 32-bit values in int64),
    in 16-bit halves so that no product leaves int64."""
    lo = a * (x & 0xFFFF)
    hi = a * (x >> 16)
    low_sum = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (low_sum >> 32), low_sum & _LOW32


def philox_bytes(seed: int, B: int, H: int, L: int, device=None) -> torch.Tensor:
    """(B, H, L, L) u8: the low byte of each Philox4x32-10 output word."""
    n = B * H * L * L
    counter = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    x0, x1 = counter & _LOW32, counter >> 32
    x2 = torch.zeros_like(counter)
    x3 = torch.zeros_like(counter)
    k0, k1 = int(seed) & _LOW32, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _LOW32, (k1 + _W1) & _LOW32
        hi0, lo0 = _mul_hi_lo(_M0, x0)
        hi1, lo1 = _mul_hi_lo(_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    words = torch.stack((x0, x1, x2, x3), dim=-1).reshape(-1)[:n]
    return (words & 0xFF).to(torch.uint8).reshape(B, H, L, L)


class DropSource:
    """The two generators of a training run with seed ``seed``."""

    def __init__(self, seed: int, device):
        self.cpu = torch.Generator().manual_seed(int(seed))
        self.card = torch.Generator(device=torch.device(device)).manual_seed(int(seed))

    def bits(self, shape, device) -> torch.Tensor:
        return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=device,
                             generator=self.card)

    def attention_bits(self, B: int, H: int, L: int, device) -> torch.Tensor:
        seed = int(torch.randint(0, SEED_BOUND, (1,), generator=self.cpu))
        return philox_bytes(seed, B, H, L, device)
