"""Synthetic datasets shaped like the reference workloads (ported from
``distributedvolunteercomputing_tpu/training/data.py``).

The LM task is the reference's: each token has 4 "likely" successors given
by fixed affine hash maps (90% one of the 4, 10% uniform), so next-token
prediction has low achievable entropy. Draws come from a ``torch.Generator``,
so the bits differ from ``jax.random``; the task is the same. The token chain
is a composition of affine maps mod vocab, built with a parallel prefix scan
on the generator's device (the trainer draws on the host and moves finished
batches to the card).
"""

from __future__ import annotations

from typing import Dict

import torch

# The 4 successor maps: next = (tok * mult + off) % vocab.
_SUCC_MULT = (3, 5, 7, 11)
_SUCC_OFF = (13, 101, 997, 4099)
_LIKELY_P = 0.9  # P(successor drawn from the 4 likely maps vs. uniform)


def affine_chain(first: torch.Tensor, a: torch.Tensor, b: torch.Tensor, vocab: int) -> torch.Tensor:
    """tok[0] = first, tok[i+1] = (a[i] * tok[i] + b[i]) % vocab, for [n, B]
    ``a``/``b``, as an inclusive prefix composition of the affine maps
    (log2(n) vector steps instead of n sequential ones). Returns [B, n + 1]."""
    shift = 1
    n = a.shape[0]
    while shift < n:
        # Element i covers maps (i - shift, i]; compose it after element i - shift.
        a_new, b_new = a.clone(), b.clone()
        a_new[shift:] = (a[shift:] * a[:-shift]) % vocab
        b_new[shift:] = (a[shift:] * b[:-shift] + b[shift:]) % vocab
        a, b = a_new, b_new
        shift *= 2
    rest = (a * first + b) % vocab
    return torch.cat([first[None], rest]).t()


def synthetic_token_stream(
    gen: torch.Generator, batch_size: int, seq_len: int, vocab: int
) -> torch.Tensor:
    dev = gen.device
    mult = torch.tensor(_SUCC_MULT, dtype=torch.int64, device=dev)
    off = torch.tensor([o % vocab for o in _SUCC_OFF], dtype=torch.int64, device=dev)
    n = seq_len - 1
    first = torch.randint(0, vocab, (batch_size,), generator=gen, device=dev)
    choice = torch.randint(0, len(_SUCC_MULT), (n, batch_size), generator=gen, device=dev)
    uniform = torch.randint(0, vocab, (n, batch_size), generator=gen, device=dev)
    likely = torch.rand((n, batch_size), generator=gen, device=dev) < _LIKELY_P
    # A likely step is the map x -> mult * x + off; a uniform one the constant
    # map. (gather: tensor indexing is ~1000x slower on the CPU at this size.)
    flat = choice.reshape(-1)
    a = torch.where(likely, mult.gather(0, flat).view_as(choice), 0)
    b = torch.where(likely, off.gather(0, flat).view_as(choice), uniform)
    return affine_chain(first, a, b, vocab)


def synthetic_lm_batch(
    gen: torch.Generator, batch_size: int, seq_len: int, vocab: int
) -> Dict[str, torch.Tensor]:
    """Causal LM batch: predict tokens[1:] from tokens[:-1]."""
    toks = synthetic_token_stream(gen, batch_size, seq_len + 1, vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
