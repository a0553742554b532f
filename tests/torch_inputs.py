"""Seeded numpy inputs for the port's kernel tests (no jax, so the card-only
tests can import them on a machine without it).

Tie-heavy: CS and LUT are quantized to a few levels (``+ 0.0`` turns
numpy's ``-0.0`` into ``0.0``, so no signed zero decides a max). Token
validity is a prefix of each doc (pad code ``n_c`` after it), as
``PackedIndex.token_mask()`` builds it; term masks have dead terms.
"""
import numpy as np


def quant(x, levels):
    return np.asarray(np.round(x * levels) / levels + 0.0, np.float32)


def _lengths(rng, shape, cap, lens):
    """Token counts uniform in [0, cap], or drawn from the values ``lens``."""
    if lens is None:
        return rng.integers(0, cap + 1, size=shape).astype(np.int32)
    return rng.choice(np.asarray(lens, np.int32), size=shape)


def prefilter_inputs(seed, nb, n_q, n_c, n_docs, cap, levels=4, density=0.6,
                     lens=None):
    """-> cs (B, n_q, n_c), codes (n_docs, cap), mask (n_docs, cap),
    bitmap (B, n_docs) with each bit set with probability ``density``,
    q_mask (B, n_q). ``lens``: the token counts to draw from (default any
    in [0, cap])."""
    rng = np.random.default_rng(seed)
    cs = quant(rng.normal(size=(nb, n_q, n_c)) * 0.5, levels)
    codes = rng.integers(0, n_c, size=(n_docs, cap)).astype(np.int32)
    lens = _lengths(rng, n_docs, cap, lens)
    mask = np.arange(cap)[None, :] < lens[:, None]
    codes[~mask] = n_c
    bitmap = rng.random((nb, n_docs)) < density
    qm = rng.random((nb, n_q)) < 0.75
    qm[:, 0] = True
    return cs, codes, mask, bitmap, qm


def pqinter_inputs(seed, nb, n_q, n_c, nf, cap, m, ksub, levels=2,
                   lens=None):
    """-> cs_t (B, n_c, n_q), lut (B, n_q, m, K), codes (B, nf, cap),
    res_codes (B, nf, cap, m) uint8, mask (B, nf, cap), q_mask (B, n_q).
    ``lens``: the token counts to draw from (default any in [0, cap])."""
    rng = np.random.default_rng(seed)
    cs_t = quant(rng.normal(size=(nb, n_c, n_q)) * 0.5, levels)
    lut = quant(rng.normal(size=(nb, n_q, m, ksub)) * 0.3, levels)
    codes = rng.integers(0, n_c, size=(nb, nf, cap)).astype(np.int32)
    lens = _lengths(rng, (nb, nf), cap, lens)
    mask = np.arange(cap) < lens[..., None]
    codes[~mask] = n_c
    res = rng.integers(0, ksub, size=(nb, nf, cap, m)).astype(np.uint8)
    qm = rng.random((nb, n_q)) < 0.75
    qm[:, 0] = True
    return cs_t, lut, codes, res, mask, qm


def lit_row_words(seed, nb, n_c, share):
    """(B, n_c) uint32 word table whose rows (a centroid's B words) are all
    zero except a ``share`` of them; each lit row has a bit set, and bit 31
    is in use (int32-negative words)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(nb, n_c), dtype=np.uint64)
    w &= rng.integers(0, 1 << 32, size=(nb, n_c), dtype=np.uint64)
    lit = rng.random(n_c) < share
    cols = np.flatnonzero(lit)
    w[cols % nb, cols] |= np.uint64(1) << (cols % 32).astype(np.uint64)
    w[:, ~lit] = 0
    return w.astype(np.uint32)


def plan_words(seed, n):
    """(n,) uint32 predicate words, bit 31 in use, a few fixed words
    first."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    w[:6] = [0, 0xFFFFFFFF, 1 << 31, 0b1101, 0b0101, 0x80000041][:n]
    return w


def compact_inputs(seed, nb, n_q, n_c, cand_cap, cap, levels=4):
    """Compact mode's per-query operands: -> cs (B, n_q, n_c), codes
    (B, cand_cap, cap), mask (B, cand_cap, cap) prefix masks, valid
    (B, cand_cap) with holes (about a third of the slots invalid, the last
    query's first slots too), q_mask (B, n_q)."""
    rng = np.random.default_rng(seed)
    cs = quant(rng.normal(size=(nb, n_q, n_c)) * 0.5, levels)
    codes = rng.integers(0, n_c, size=(nb, cand_cap, cap)).astype(np.int32)
    lens = rng.integers(0, cap + 1, size=(nb, cand_cap))
    mask = np.arange(cap) < lens[..., None]
    codes[~mask] = n_c
    valid = rng.random((nb, cand_cap)) < 0.65
    valid[-1, :min(cand_cap, 7)] = False
    qm = rng.random((nb, n_q)) < 0.75
    qm[:, 0] = True
    return cs, codes, mask, valid, qm


def doc_pass_rows(seed, nb, nf, passing, n_docs, k):
    """(B, nf) bool verdicts per survivor: ``all``, ``none``, ``sparse``
    (fewer than n_docs pass) or ``few`` (fewer than k pass), at random
    positions."""
    if passing in ("all", "none"):
        return np.full((nb, nf), passing == "all")
    rng = np.random.default_rng(seed)
    count = n_docs // 2 if passing == "sparse" else k // 2
    dp = np.zeros((nb, nf), bool)
    for b in range(nb):
        dp[b, rng.choice(nf, size=count + b % 2, replace=False)] = True
    return dp


# bf16 thresholds of the bf16 tests, and the bf16 values they round to:
# bf16(0.4) = 0.400390625 lies above float32(0.4), so an entry equal to it
# fails a bf16 comparison with 0.4 and passes a float32 one. chip_smoke.py
# holds the same constants and bf16_edges for the card.
BF16_TH, BF16_TH_R = 0.4, 0.3
BF16_EDGES = (0.400390625, 0.30078125)


def bf16_edges(seed, x, share=0.15, values=BF16_EDGES):
    """``x`` (float32, every entry a bf16 value, as the quantized inputs
    above are) with a ``share`` of its entries set to each of ``values``:
    bf16(th) and bf16(th_r), where the comparison dtypes of the lanes
    differ."""
    rng = np.random.default_rng(seed)
    x = x.copy()
    pick = rng.random(x.shape)
    for i, v in enumerate(values):
        x[(pick >= i * share) & (pick < (i + 1) * share)] = v
    return x


def topnprobe_inputs(seed, nb, n_q, n_c, nprobe, th, device="cpu"):
    """The masked top-nprobe's edge cases as torch tensors on ``device``
    (made there, so the card's full-width rows need no host copy) -> cs
    (B, n_q, n_c) float32, q_mask (B, n_q) bool with dead terms.

    The rows take turns: exactly 0, 1, nprobe - 1, nprobe and n_c survivors
    (> th, in a run of columns that starts at a random column and wraps),
    then a free row. Values lie on eighths above th, and on eighths less
    0.00, 0.01 or 0.02 at or below it, so ties are everywhere, entries
    equal to th are there, and entries below th that differ tie again after
    the -1e6 offset (whose float32 ulp is 0.0625). A free row holds -0.0,
    0.0, th and bf16(th) at four columns."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    rows, th32 = nb * n_q, float(np.float32(th))

    def draw(lo, hi):
        return torch.randint(lo, hi, (rows, n_c), generator=gen,
                             device=device).float()
    above = th32 + draw(1, 9) / 8
    below = th32 - draw(0, 8) / 8 - draw(0, 3) / 100
    counts = [0, 1, max(nprobe - 1, 0), nprobe, n_c, -1]
    want = torch.tensor(counts, device=device).repeat(
        rows // len(counts) + 1)[:rows]
    start = torch.randint(0, n_c, (rows, 1), generator=gen, device=device)
    run = (torch.arange(n_c, device=device) - start) % n_c
    free = torch.randint(0, 2, (rows, n_c), generator=gen,
                         device=device).bool()
    keep = torch.where(want[:, None] < 0, free, run < want[:, None])
    cs = torch.where(keep, above, below)
    bf16_th = float(torch.tensor(th32).to(torch.bfloat16).float())
    for i, v in enumerate((-0.0, 0.0, th32, bf16_th)):
        col = (start[:, 0] + i * (n_c // 4 + 1)) % n_c
        cs[want < 0, col[want < 0]] = v
    q_mask = torch.rand((nb, n_q), generator=gen, device=device) < 0.8
    q_mask[:, 0] = True
    return cs.reshape(nb, n_q, n_c), q_mask
