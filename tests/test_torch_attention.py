"""The port's flash attention (plain versions of K1-K3 on the CPU) against the
JAX package's Pallas kernels in interpret mode, and the port's router.

Same inputs on both sides (numpy, seeded); f32; block 16 on the JAX side so
its online softmax walks several blocks and pads T=40. Tolerances are the
reference's own flash-vs-XLA ones (tests/test_pallas_attention.py): 2e-5 for
the forward, 5e-5 for the grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu.ops import pallas_attention as jax_flash
from distributedvolunteercomputing_tpu_torch.ops import attention as port_attn
from distributedvolunteercomputing_tpu_torch.ops import flash_attention as port_flash

B, H, T, D = 2, 2, 40, 16


def _inputs(seed, n=3, t=T):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, t, D)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_lse_match_pallas(causal):
    q, k, v = _inputs(0)
    o_ref, lse_ref = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 16, 16, True
    )
    o, lse = port_flash.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=2e-5, rtol=2e-5)


def test_grads_match_pallas_vjp():
    # Causal: the flagship path. One vjp = one forward + the dq and dkv kernels.
    q, k, v, cot = _inputs(1, n=4)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_flash.flash_attention(a, b, c, True, 16, 16, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    g_ref = vjp(jnp.asarray(cot))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = port_flash.flash_attention(qt, kt, vt, True)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(cot))
    for name, a, b in zip(("dq", "dk", "dv"), grads, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=5e-5, err_msg=name)


def test_plain_versions_round_like_the_kernels_in_bf16():
    # bf16 inputs: P and dS are rounded to bf16 before their products, and
    # the outputs come back in bf16 — close to the f32 result, not equal.
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, n=4))
    o32, lse32 = port_flash.flash_fwd_plain(q, k, v, True)
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
    o16, lse16 = port_flash.flash_fwd_plain(qb, kb, vb, True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    np.testing.assert_allclose(o16.float().numpy(), o32.numpy(), atol=3e-2, rtol=3e-2)
    delta = (dob.float() * o16.float()).sum(-1)
    dk, dv = port_flash.flash_dkv_plain(qb, kb, vb, dob, lse16, delta, True)
    assert dk.dtype == dv.dtype == torch.bfloat16


def test_router():
    q, k = (torch.zeros(1, 2, t, 64) for t in (16, 48))
    try:
        port_attn.set_attention_impl("flash")
        assert port_attn._route_to_flash(q, q, True, None)
        assert not port_attn._route_to_flash(q, k, True, None)  # rectangular causal
        assert port_attn._route_to_flash(q, k, False, None)
        assert not port_attn._route_to_flash(q, q, True, torch.ones(1, 1, 16, 16, dtype=torch.bool))
        port_attn.set_attention_impl("auto")
        assert not port_attn._route_to_flash(q, q, True, None)  # auto: the kernels are CUDA-only
        port_attn.set_attention_impl("xla")
        assert not port_attn._route_to_flash(q, q, True, None)
    finally:
        port_attn.set_attention_impl("auto")
    with pytest.raises(ValueError):
        port_attn.set_attention_impl("pallas")


def test_environment_does_not_pick_the_impl(monkeypatch):
    # The reference reads DVC_ATTN_IMPL; the port does not, so an inherited
    # variable cannot take the main path off the kernels.
    import importlib

    monkeypatch.setenv("DVC_ATTN_IMPL", "xla")
    importlib.reload(port_attn)
    assert port_attn._impl == "auto"


def test_rectangular_causal_takes_the_plain_core():
    # Under "flash", Tq != Tk causal must still be bottom-right aligned like
    # the reference's XLA core.
    from distributedvolunteercomputing_tpu.ops.attention import attention_core as jax_core

    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, 16, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, 48, D)).astype(np.float32) for _ in range(2))
    ref = jax_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    try:
        port_attn.set_attention_impl("flash")
        out = port_attn.attention_core(*map(torch.from_numpy, (q, k, v)), causal=True)
    finally:
        port_attn.set_attention_impl("auto")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_wrappers_launch_or_raise():
    # A tensor that is neither on the CPU nor on the card never reaches a
    # plain version: the wrapper raises.
    q = torch.empty(1, 1, 8, 64, device="meta")
    before = dict(port_flash.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        port_flash.flash_fwd(q, q, q, True)
    assert port_flash.LAUNCHES == before
    # CPU tensors take the plain version and count no launch.
    x = torch.randn(1, 1, 8, 64)
    port_flash.flash_fwd(x, x, x, True)
    assert port_flash.LAUNCHES == before


@pytest.mark.parametrize("h, d", [(12, 64), (8, 128)])
def test_fused_qkv_views_are_read_in_place(h, d):
    # The train step hands K1-K3 the head-split views of the fused qkv
    # projection (t-stride 3*H*D elements, k and v bases inside the row) and
    # dO as the head-split view of a [B, T, H*D] gradient. The kernels' TMA
    # tensor maps read them in place: _aligned passes them and kernel_layout
    # hands them back unchanged.
    t = 32
    qkv = torch.zeros(2, t, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = (port_attn.split_heads(x, h) for x in qkv.split(h * d, dim=-1))
    do = port_attn.split_heads(torch.zeros(2, t, h * d, dtype=torch.bfloat16), h)
    assert q.stride() == (t * 3 * h * d, d, 3 * h * d, 1)
    assert k.data_ptr() - q.data_ptr() == h * d * 2
    for x in (q, k, v, do):
        assert port_flash._aligned(x)
        assert port_flash.kernel_layout(x) is x
    # A t-stride that is not a multiple of 16 bytes cannot be read in place.
    ragged = torch.zeros(2, t, h * d + 4, dtype=torch.bfloat16)[..., : h * d]
    assert not port_flash._aligned(port_attn.split_heads(ragged, h))
    # Nor a base that is not 16-byte aligned.
    shifted = torch.zeros(2, t, h * d + 8, dtype=torch.bfloat16)[..., 4 : 4 + h * d]
    assert not port_flash._aligned(port_attn.split_heads(shifted, h))
    # Nor a stride of 2**40 bytes or more, the tensor maps' limit (on a batch
    # of one, so the view needs no storage for it).
    big = torch.zeros(1, h, 4, d, dtype=torch.bfloat16).as_strided((1, h, 4, d), (1 << 39, 4 * d, d, 1))
    assert not port_flash._aligned(big)
    assert port_flash._aligned(big.as_strided(big.shape, ((1 << 39) - 8, 4 * d, d, 1)))


def test_dq_wrapper_refuses_layouts_the_tensor_maps_cannot_read():
    # K2 reads q, k, v and dO through TMA tensor maps, as K1 and K3 do: a
    # tensor off the CPU and the card raises before any launch, and the
    # layout rule refuses what the maps cannot describe (t-stride not a
    # multiple of 16 bytes, base not 16-byte aligned) and passes the fused
    # qkv projection's head-split views.
    h, d, t = 2, 64, 8
    before = dict(port_flash.LAUNCHES)
    m = torch.empty(1, h, t, d, device="meta")
    lse = torch.empty(1, h, t, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        port_flash.flash_dq(m, m, m, m, lse, lse, True)
    qkv = torch.zeros(1, t, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = (port_attn.split_heads(x, h) for x in qkv.split(h * d, dim=-1))
    do = port_attn.split_heads(torch.zeros(1, t, h * d, dtype=torch.bfloat16), h)
    port_flash.check_layout("flash_dq", q, k, v, do)
    ragged = port_attn.split_heads(torch.zeros(1, t, h * d + 4, dtype=torch.bfloat16)[..., : h * d], h)
    shifted = port_attn.split_heads(torch.zeros(1, t, h * d + 8, dtype=torch.bfloat16)[..., 4 : 4 + h * d], h)
    for bad in (ragged, shifted):
        with pytest.raises(ValueError, match="not readable in place"):
            port_flash.check_layout("flash_dq", q, k, v, bad)
        with pytest.raises(ValueError, match="not readable in place"):
            port_flash.check_layout("flash_dq", bad, k, v, do)
    with pytest.raises(ValueError, match="D in"):
        port_flash.check_layout("flash_dq", torch.zeros(1, h, t, 32, dtype=torch.bfloat16))
    # CPU tensors take the plain version and count no launch.
    x = torch.randn(1, h, t, d)
    dq = port_flash.flash_dq(x, x, x, x, torch.zeros(1, h, t), torch.zeros(1, h, t), True)
    assert dq.shape == x.shape and port_flash.LAUNCHES == before
