"""distributedvolunteercomputing_tpu_torch — the PyTorch/CUDA port of the
volunteer training framework.

The JAX package ``distributedvolunteercomputing_tpu`` beside it is the
reference: every module here computes what its JAX counterpart computes, and
the tests hold the two against each other on the same inputs. This package
imports ``torch`` and never ``jax`` (nor anything of the JAX package).

Ported so far (one volunteer's train step, data-parallel over a local
mesh, and sync averaging rounds between volunteers on the f32 and bf16
wires):

    training   Trainer (local loop, blocking / overlapped averaging rounds),
               train/eval steps, optax-semantics optimizers
    models     gpt2_small / gpt2_medium / gpt2_large over a dict-of-tensors tree
    ops        attention router + hand-written CUDA flash attention (fwd, dq,
               dkv); the bf16 wire codec and mean folder on the card, with
               hand-written CUDA encode and decode-axpy, and over a mesh's
               ranks the ring fold (CUDA reduce-scatter fold, all-gather);
               robust estimators
    parallel   the volunteer's local mesh and the data-parallel step
    swarm      Volunteer, the sync averager and streaming aggregation, over
               copies of the reference's transport, DHT, membership,
               matchmaking and telemetry
    native     copy of the reference's C++ host codec (built with g++ at first use)
    utils      device/dtype resolution, flat-buffer pytree serde, logging

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a card and without that argument they raise.
"""

from distributedvolunteercomputing_tpu_torch.version import __version__

__all__ = ["__version__"]
