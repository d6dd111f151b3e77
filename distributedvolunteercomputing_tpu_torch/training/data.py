"""Synthetic datasets shaped like the reference workloads (ported from
``distributedvolunteercomputing_tpu/training/data.py``).

The LM task is the reference's: each token has 4 "likely" successors given
by fixed affine hash maps (90% one of the 4, 10% uniform), so next-token
prediction has low achievable entropy. Draws come from a ``torch.Generator``,
so the bits differ from ``jax.random``; the task is the same. The token chain
is a composition of affine maps mod vocab, built with a parallel prefix scan
on the generator's device (the trainer draws on the host and moves finished
batches to the card).

The image task is the reference's too: class-conditional Gaussian blobs
around fixed per-class prototypes. The reference draws the prototypes from a
fixed ``jax.random`` key, whose bits torch cannot reproduce, so the arrays
for the zoo's two image shapes are committed beside this module
(``prototypes/image_<H>x<W>x<C>_<classes>.npy``, written once from the
reference's ``_image_prototypes``): port and JAX volunteers train the same
task. Any other shape draws its prototypes from a fixed torch seed.

Real data swaps in through ``npz_batch_iter``: shuffled minibatches of an
``.npz`` file, numpy only, byte-equal to the reference's for the same file
and seed.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_PROTO_DIR = Path(__file__).resolve().parent / "prototypes"
_PROTO_SEED = 1234  # class prototypes are global constants of the task

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


@functools.lru_cache(maxsize=None)
def image_prototypes(shape: Tuple[int, ...], n_classes: int) -> torch.Tensor:
    """[n_classes, *shape] f32 on the host: the reference's for the committed
    shapes, else from a fixed torch seed."""
    path = _PROTO_DIR / f"image_{'x'.join(str(d) for d in shape)}_{n_classes}.npy"
    if path.exists():
        return torch.from_numpy(np.load(path))
    gen = torch.Generator().manual_seed(_PROTO_SEED)
    return torch.randn((n_classes,) + tuple(shape), generator=gen)


def synthetic_image_batch(
    gen: torch.Generator, batch_size: int, shape: Tuple[int, ...], n_classes: int, noise: float = 0.3
) -> Dict[str, torch.Tensor]:
    dev = gen.device
    y = torch.randint(0, n_classes, (batch_size,), generator=gen, device=dev)
    protos = image_prototypes(tuple(shape), n_classes).to(dev)
    x = protos.index_select(0, y) + noise * torch.randn((batch_size,) + tuple(shape), generator=gen, device=dev)
    return {"x": x, "y": y}


def synthetic_mlm_batch(
    gen: torch.Generator, batch_size: int, seq_len: int, vocab: int, mask_id: int, mask_rate: float = 0.15
) -> Dict[str, torch.Tensor]:
    """BERT-style MLM batch: 15% of positions replaced by [MASK], predict originals."""
    toks = synthetic_token_stream(gen, batch_size, seq_len, vocab)
    mask = torch.rand(toks.shape, generator=gen, device=gen.device) < mask_rate
    inputs = torch.where(mask, mask_id, toks)
    return {"tokens": inputs, "targets": toks, "mask": mask.float()}


def npz_batch_iter(path: str, batch_size: int, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffled minibatches from an ``.npz`` of aligned arrays.

    The file's keys become the batch's keys, so they must match the model's
    schema (``x``/``y`` for image models, ``tokens``/``targets`` for LMs,
    plus ``mask`` for MLM). Each pass reshuffles with
    ``np.random.default_rng(seed)``, as the reference does; the trailing
    partial batch is dropped. Batches are host numpy; the trainer moves them
    to the device."""
    data = {k: np.asarray(v) for k, v in np.load(path).items()}
    if not data:
        raise ValueError(f"{path}: empty npz")
    n = len(next(iter(data.values())))
    for k, v in data.items():
        if len(v) != n:
            raise ValueError(f"{path}: key {k!r} has {len(v)} rows, expected {n}")
    if n < batch_size:
        raise ValueError(f"{path}: {n} examples < batch_size {batch_size}")

    def gen() -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.permutation(n)
            for s in range(0, n - batch_size + 1, batch_size):
                sel = idx[s : s + batch_size]
                yield {k: v[sel] for k, v in data.items()}

    return gen()
