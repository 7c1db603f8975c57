"""The table of peaks and the work the algorithm needs, kernel by kernel.

A kernel's least time is the larger of its bytes over the card's memory
bandwidth and its integer operations over the card's INT32 rate.  The
counts are of the work these inputs need, whatever implements it, and
not of the program's tensors: each value the kernel needs at 4 bytes,
each input read once and each output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM: HBM3 at 3.35 TB/s (data sheet); 132 SMs x 64 INT32
# lanes x 1.98 GHz boost clock (Hopper architecture white paper)
H100_BYTES_PER_S = 3.35e12
H100_INT32_OPS_PER_S = 132 * 64 * 1.98e9
VALUE_BYTES = 4

# the level-6 DP (the JAX package's tpu_optimal.py:75-87): every length
# 3..66, then 74..130 step 8 and 146..258 step 16, over segments of 1024
# positions
LEN_LADDER_DENSE2 = (tuple(range(3, 67)) + tuple(range(74, 131, 8))
                     + tuple(range(146, 259, 16)))
DP_SEGMENT = 1024
DP_INPUTS = 12       # a position's A, B, C (length, offset cost, distance),
                     # d3 (cost, distance) and literal cost
DP_OUTPUTS = 2       # the winning edge's span and distance
DP_OPS_PER_RUNG = 3  # cost + lc[f] + D[t + f]: two adds, then one min
LC_ENTRIES = 259     # a chunk's length-cost row
CHAIN_STRIDES = (8, 16, 32, 64, 128, 256)
CHAIN_OPS_PER_STRIDE = 6   # r == s, d' == d, and, select r, add, select f


def least_s(nbytes: float, nops: float) -> float:
    return max(nbytes / H100_BYTES_PER_S, nops / H100_INT32_OPS_PER_S)


def feasible_rungs(ladder, segment: int) -> int:
    """Rungs f with t + f <= segment, summed over a segment's t."""
    return sum(sum(1 for f in ladder if t + f <= segment)
               for t in range(segment))


def dp_parse_least_s(positions: int, chunks: int) -> float:
    """K1, the level-6 DP over ``positions`` (whole segments) of
    ``chunks`` chunks: 14 values a position and a chunk's lc row read or
    written once; 3 operations a feasible rung."""
    nbytes = VALUE_BYTES * ((DP_INPUTS + DP_OUTPUTS) * positions
                            + LC_ENTRIES * chunks)
    nops = (DP_OPS_PER_RUNG * feasible_rungs(LEN_LADDER_DENSE2, DP_SEGMENT)
            * (positions // DP_SEGMENT))
    return least_s(nbytes, nops)


def chain_double_least_s(positions: int) -> float:
    """C4 with one candidate (the level-1 greedy parser's stride-8
    doubling): its length, distance and fine length read and the new
    length written once a position; 6 operations a stride."""
    nbytes = VALUE_BYTES * 4 * positions
    nops = CHAIN_OPS_PER_STRIDE * len(CHAIN_STRIDES) * positions
    return least_s(nbytes, nops)
