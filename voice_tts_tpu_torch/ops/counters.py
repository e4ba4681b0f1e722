"""Launch counters of the hand-written kernels.

Each kernel wrapper adds one to its entry each time it launches its kernel,
and nowhere else, so a run can show that the main path went through the
kernels.  `fused_decode_step` (K1), `fused_decode_step_batch` (K3) and
`fused_decode_verify` (K6) count one per step (a step is a chain of
launches, see `ops/fused_decode.py`); `fused_decode_int4` (K7) counts each
of those chains that ran with an int4 pack, in addition to the chain's own
count; `int8_gemv` (K4) one per product (one C call of two launches, the
split partials and their fixed-order sum, see `ops/int8_matmul.py`).
`dit_block_chain` (K8) counts one per trunk evaluation (one C call
of a few launches a layer, see `ops/dit_blocks.py`); `cfm_attention` (K9)
and `flash_attention` (K11) one per attention call of a DiT block, not the
attention stage inside a K8 chain.  `decode_attention` (K5) counts one per
layer call of the unfused decode step (all B rows in one launch);
`fused_resblock_stage` (K10) one per fused vocoder stage (one C call of 18
launches, see `ops/fused_vocoder.py`).  The micro-benchmark kernels count
one per call, that is one per pass of their benchmark: `micro_tile` (K12)
per C call of its tile pass and fixed-order reduction (two launches, see
`ops/micro_tile.py`), `micro_int4` (K13) per cooperative launch (see
`ops/micro_int4.py`).

A wrapper counts in Python, which a replayed CUDA graph does not run: the
device loops (`engine/device_loop.py`) take back what a capture counted
(a capture launches nothing) and add it again at each replay, so K1 and K3
count every decode step a replayed chunk executes, the at most CHUNK - 1
steps after a stop included, and K8 / K9 / K11 every evaluation of a
replayed CFM solve.
"""

from __future__ import annotations

import collections

KERNELS = ("fused_decode_step", "fused_decode_step_batch", "fused_decode_verify",
           "fused_decode_int4", "int8_gemv", "aa_snake_activation",
           "dit_block_chain", "cfm_attention", "flash_attention",
           "decode_attention", "fused_resblock_stage", "micro_tile",
           "micro_int4")

LAUNCHES: collections.Counter = collections.Counter({k: 0 for k in KERNELS})


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def snapshot() -> dict:
    return {k: LAUNCHES[k] for k in KERNELS}
