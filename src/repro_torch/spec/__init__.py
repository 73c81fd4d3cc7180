"""Self-speculative decoding of the port (``repro.spec``'s counterpart).

A cheap *draft* proposes ``k`` tokens a slot (``spec.draft``: re-packed
ternary weights, a prefix of the layers, or an external model), the
target verifies the whole ``(slots, k+1)`` window in one forward
(``spec.verify``), greedy longest-prefix acceptance emits the accepted
drafts and one bonus token, and ``spec.rollback`` restores the cache for
the rejected tail (length bookkeeping dense, page truncation paged). The
engine runs the round inside its continuous-batching loop:
``ContinuousScheduler(cfg, ..., spec=SpecConfig(draft="layer_skip",
k=4))``.
"""
from repro_torch.spec.draft import (Draft, DraftModel, SpecConfig,
                                    build_draft, external, layer_skip,
                                    make_draft_round, resparsify)
from repro_torch.spec.rollback import rollback_dense, rollback_paged
from repro_torch.spec.verify import longest_prefix_match, make_verify_step

__all__ = [
    "SpecConfig", "DraftModel", "Draft", "build_draft",
    "resparsify", "layer_skip", "external",
    "make_draft_round", "make_verify_step", "longest_prefix_match",
    "rollback_dense", "rollback_paged",
]
