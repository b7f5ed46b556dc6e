"""The paper's own workload: NN-DTW search over a million-series store
(copy of ``repro.configs.paper_dtw``, data only).

A 2^20-series candidate store (the regime the paper's introduction says
NN-DTW "does not scale" to), a 2048-query batch, the LB_ENHANCED^4
cascade and banded-DTW verification.  W = 0.3 L matches the paper's
Fig. 1 protocol.  Not an LM config, so not in ``registry.ARCHS``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperSearchConfig:
    name: str = "search_1m"
    n_store: int = 1_048_576       # 2^20 candidate series
    length: int = 512
    n_queries: int = 2048
    w: int = 154                   # 0.3 * L (paper Fig. 1)
    v: int = 4                     # the paper's recommended variant
    k: int = 1
    verify_chunk: int = 64
    candidate_chunk: int = 512
    expected_verify: int = 64      # expected DTW verifications per query


PAPER_SEARCH = PaperSearchConfig()
