"""Bit-exact reimplementation of Rust `rand` 0.9 `StdRng` sampling.

The reference subsamples ultra-high-coverage loci with
`StdRng::seed_from_u64(42)` + `rng.random_range(0..n_reads)`
(ref: src/trgt/workflows/tr.rs:312-338; Cargo.lock pins rand 0.9.0,
rand_chacha 0.9.0, rand_core 0.9.3). Reproducing the reference's exact
read selection therefore requires three pieces, all replicated here:

1. `seed_from_u64` — rand_core's default: a PCG32 stream (constant
   multiplier/increment, XSH-RR output) fills the 32-byte ChaCha seed.
2. `StdRng` = ChaCha12 (djb variant: 64-bit block counter in words
   12-13, 64-bit stream id in words 14-15, both starting at 0), with
   rand_core::BlockRng word-at-a-time output over 4-block (256-byte)
   refills.
3. `random_range(0..n)` for `usize` n — rand 0.9's UniformUsize routes
   n ≤ u32::MAX through `UniformInt::<u32>::sample_single_inclusive`,
   which is Canon's method: one 32-bit sample, widening multiply, and a
   single extra sample only in the (rare) biased window.

Pure Python; the reservoir path only activates above 3x max-depth
coverage (750+ reads at wgs defaults) so per-call cost is irrelevant.
"""

from typing import List, Sequence, Tuple

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def seed_from_u64(state: int) -> bytes:
    """rand_core 0.9 `SeedableRng::seed_from_u64`: PCG32 (XSH-RR) output
    stream expands the u64 into the generator's seed bytes."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    out = bytearray(32)
    for off in range(0, 32, 4):
        state = (state * MUL + INC) & _M64
        xorshifted = (((state >> 18) ^ state) >> 27) & _M32
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & _M32
        out[off:off + 4] = x.to_bytes(4, "little")
    return bytes(out)


def _qr(x: List[int], a: int, b: int, c: int, d: int) -> None:
    x[a] = (x[a] + x[b]) & _M32
    x[d] ^= x[a]
    x[d] = ((x[d] << 16) | (x[d] >> 16)) & _M32
    x[c] = (x[c] + x[d]) & _M32
    x[b] ^= x[c]
    x[b] = ((x[b] << 12) | (x[b] >> 20)) & _M32
    x[a] = (x[a] + x[b]) & _M32
    x[d] ^= x[a]
    x[d] = ((x[d] << 8) | (x[d] >> 24)) & _M32
    x[c] = (x[c] + x[d]) & _M32
    x[b] ^= x[c]
    x[b] = ((x[b] << 7) | (x[b] >> 25)) & _M32


def chacha_block(key_words: Sequence[int], counter: int,
                 nonce_words: Tuple[int, int], rounds: int) -> List[int]:
    """One ChaCha block (djb 64-bit-counter variant), as 16 u32 words."""
    st = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
          *key_words,
          counter & _M32, (counter >> 32) & _M32,
          nonce_words[0], nonce_words[1]]
    x = list(st)
    for _ in range(rounds // 2):
        _qr(x, 0, 4, 8, 12)
        _qr(x, 1, 5, 9, 13)
        _qr(x, 2, 6, 10, 14)
        _qr(x, 3, 7, 11, 15)
        _qr(x, 0, 5, 10, 15)
        _qr(x, 1, 6, 11, 12)
        _qr(x, 2, 7, 8, 13)
        _qr(x, 3, 4, 9, 14)
    return [(a + b) & _M32 for a, b in zip(x, st)]


class StdRng:
    """rand 0.9 `StdRng` (ChaCha12) with the BlockRng output discipline:
    4 blocks (64 u32 words) per refill, words served in order."""

    ROUNDS = 12

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._key = [int.from_bytes(seed[i:i + 4], "little")
                     for i in range(0, 32, 4)]
        self._counter = 0
        self._buf: List[int] = []
        self._idx = 64

    @classmethod
    def seed_from_u64(cls, state: int) -> "StdRng":
        return cls(seed_from_u64(state))

    def _refill(self) -> None:
        buf: List[int] = []
        for _ in range(4):
            buf.extend(chacha_block(self._key, self._counter, (0, 0),
                                    self.ROUNDS))
            self._counter = (self._counter + 1) & _M64
        self._buf = buf
        self._idx = 0

    def next_u32(self) -> int:
        if self._idx >= 64:
            self._refill()
        v = self._buf[self._idx]
        self._idx += 1
        return v

    def next_u64(self) -> int:
        """BlockRng::next_u64: two consecutive u32 words, low first.
        (Buffer length is even so a refill never splits a pair here.)"""
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo

    def random_range(self, n: int) -> int:
        """`rng.random_range(0..n)` for usize n in [1, 2^32]: rand 0.9
        UniformUsize → UniformInt::<u32>::sample_single_inclusive(0, n-1)
        — Canon's method (default, no `unbiased` feature)."""
        assert 0 < n <= (1 << 32)
        rng_range = n & _M32          # n == 2^32 wraps to the 0 special case
        if rng_range == 0:
            return self.next_u32()
        prod = self.next_u32() * rng_range
        result, lo_order = prod >> 32, prod & _M32
        if lo_order > ((-rng_range) & _M32):
            new_hi = (self.next_u32() * rng_range) >> 32
            if lo_order + new_hi > _M32:
                result += 1
        return result
