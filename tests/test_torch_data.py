"""The port's synthetic LM stream: the parallel affine-chain scan equals the
step-by-step recurrence, and the task has the reference's statistics."""

import torch

from distributedvolunteercomputing_tpu_torch.training import data


def test_affine_chain_equals_the_recurrence():
    gen = torch.Generator().manual_seed(0)
    vocab, n, b = 50257, 37, 3
    first = torch.randint(0, vocab, (b,), generator=gen)
    a = torch.randint(0, vocab, (n, b), generator=gen) * (torch.rand((n, b), generator=gen) < 0.8)
    c = torch.randint(0, vocab, (n, b), generator=gen)
    toks = [first]
    for i in range(n):
        toks.append((a[i] * toks[-1] + c[i]) % vocab)
    assert torch.equal(data.affine_chain(first, a, c, vocab), torch.stack(toks, dim=1))


def test_lm_batch_follows_the_successor_maps():
    vocab = 50257
    batch = data.synthetic_lm_batch(torch.Generator().manual_seed(1), 4, 256, vocab)
    tok, tgt = batch["tokens"], batch["targets"]
    assert tok.shape == tgt.shape == (4, 256) and tok.dtype == torch.int64
    assert torch.equal(tok[:, 1:], tgt[:, :-1])
    hits = torch.zeros_like(tok, dtype=torch.bool)
    for m, o in zip(data._SUCC_MULT, data._SUCC_OFF):
        hits |= tgt == (tok * m + o % vocab) % vocab
    assert 0.85 < hits.float().mean().item() < 0.95  # 90% likely successors
