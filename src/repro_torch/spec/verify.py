"""Multi-token verification of the port's self-speculative decoding
(``repro.spec.verify``'s counterpart).

One verify step a round runs the whole ``(slots, k+1)`` window (the
newest committed token and the draft's ``k`` proposals) through the
target's ``LM.decode_step``: the window stores each token's K/V before
any query attends, so token j's logits are those the j-th of k+1
one-token steps would give. Greedy longest-prefix acceptance then emits a
prefix of the sequential stream. On the CPU the window is bitwise equal
to the one-token steps (``tests/test_torch_spec.py``). On the card a
dense window's attention runs cuBLAS over k+1 query rows where a decode
step has one, so the two may part at near ties (``chip_smoke.py``'s spec
phase names the op).

The verify GEMMs are M = slots·(k+1), 40 at 8 slots and k 4, and run
under ``ops.serving_phase("verify")``, which takes the decode tiles.

The step computes greedy tokens, accepted counts and each slot's
finite-logits guard on the device and packs them into one (slots, k+3)
int32 tensor, so the host reads one small tensor a round (as
``ChunkRunner`` does); on the card the engine captures the step as one
CUDA graph over static buffers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["longest_prefix_match", "make_verify_step"]


def longest_prefix_match(window: torch.Tensor, greedy: torch.Tensor,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy (exact-match) acceptance. ``window`` (B, k+1): the fed
    tokens ``[t, d_1 .. d_k]``; ``greedy`` (B, k+1): the target's argmax
    after each (``greedy[:, j]`` follows ``window[:, j]``). Draft token
    ``d_{j+1}`` is accepted iff it equals ``greedy[:, j]`` and every
    earlier one was. Returns int32 ``(n_acc (B,), bonus (B,))``: the
    accepted count in [0, k] and ``greedy[b, n_acc[b]]``, the target's
    token after the last accepted one (a round emits ``n_acc + 1``)."""
    match = (window[:, 1:] == greedy[:, :-1]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    bonus = greedy.gather(1, n_acc[:, None].long())[:, 0]
    return n_acc, bonus.to(torch.int32)


def make_verify_step(model, max_len: int, k: int):
    """The verify step for a target ``LM``:
    ``verify(params, layers, pos, window, table=None, nan_mask=None)``
    writes the window's K/V into ``layers`` in place (through the block
    table ``table`` when paged) and returns ``(out, logits)``: ``out``
    (B, k+3) int32 holds the greedy tokens (k+1 columns), the accepted
    count and the guard, ``logits`` the window's (B, k+1, V). The cache
    position is clamped to ``max_len - 1 - k`` so free slots' garbage
    writes stay in range; live rows never clamp (the engine reserves k
    positions of headroom). ``nan_mask`` (B,) bool makes the masked rows'
    logits NaN ahead of the guard (fault injection; an all-false mask
    leaves them bitwise unchanged); the guard is the all-finite check
    over each slot's whole window."""

    @torch.no_grad()
    def verify(params, layers, pos, window, table: Optional[torch.Tensor]
               = None, nan_mask: Optional[torch.Tensor] = None):
        cache = {"layers": layers, "pos": torch.clamp(pos,
                                                      max=max_len - 1 - k)}
        if table is not None:
            cache["block_table"] = table
        logits, _ = model.decode_step(params, cache, window)
        if nan_mask is not None:
            logits = torch.where(nan_mask[:, None, None], float("nan"),
                                 logits)
        greedy = logits.argmax(dim=-1).to(torch.int32)
        n_acc, _ = longest_prefix_match(window, greedy)
        ok = torch.isfinite(logits).flatten(1).all(dim=1)
        out = torch.cat([greedy, n_acc[:, None],
                         ok[:, None].to(torch.int32)], dim=1)
        return out, logits

    return verify
