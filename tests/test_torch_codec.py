"""The port's bf16 wire codec and mean folder (``ops/mesh_codec.py``) against
the JAX package's.

The same numpy inputs go to both packages. The reference's Pallas kernels
(K4 ``_enc_kernel``, K5 ``_dec_axpy_kernel``) run in interpret mode on one
(512, 128) block, as the reference's own tests run them; the port's wrappers
take their plain versions on CPU tensors. Limits: the encode is bit-equal,
NaN lanes included; decode-axpy, folds and window estimators within rtol
1e-5 / atol 1e-6 (the reference's own tolerance, ``tests/test_mesh_codec.py``).
"""

import numpy as np
import pytest
import torch

from distributedvolunteercomputing_tpu import native as jax_native
from distributedvolunteercomputing_tpu.ops import mesh_codec as jax_mc
from distributedvolunteercomputing_tpu_torch import native
from distributedvolunteercomputing_tpu_torch.ops import mesh_codec as mc

BLOCK = 512 * 128  # one Pallas block of the reference kernels
RTOL, ATOL = 1e-5, 1e-6

# f32 bit patterns with a known bf16 encoding: ±0, ±inf, canonical and
# signalling NaNs of both signs, subnormals (ties included), the largest
# finite value and values that round up to inf, ties to even.
SPECIAL = np.array(
    [
        0x00000000, 0x80000000, 0x7F800000, 0xFF800000,  # ±0, ±inf
        0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,  # NaN of both signs
        0x00000001, 0x807FFFFF, 0x00008000, 0x00018000, 0x00017FFF,  # subnormals
        0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,  # max finite, -> inf, stays finite
        0x3F808000, 0x3F818000, 0xBF808000,  # ties to even
    ],
    np.uint32,
)
# NaNs whose top payload bits are set: the XLA convert (the TPU kernel, and
# the port) gives sign | 0x7fc0; the host codec keeps the payload bits.
PAYLOAD_NAN = np.array([0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000, 0x7F810000], np.uint32)


@pytest.fixture(scope="module")
def ref_interpret():
    return jax_mc.MeshCodec(backend="mesh", pallas="interpret")


@pytest.fixture(scope="module")
def ref_codec():
    return jax_mc.MeshCodec(backend="mesh", pallas="off")


@pytest.fixture
def codec():
    return mc.MeshCodec(device="cpu", backend="device")


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    assert native.ensure_built() and jax_native.ensure_built()


def _random_bits(rng, n, canonical_nans: bool) -> np.ndarray:
    """Random f32 bit patterns over every exponent (1e-45 .. 3.4e38, inf,
    NaN), with the special values up front."""
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    bits[: SPECIAL.size] = SPECIAL
    if canonical_nans:
        nan = (bits & 0x7FFFFFFF) > 0x7F800000
        bits[nan] = (bits[nan] & 0x80000000) | 0x7FC00000
    return bits


def test_encode_matches_reference_kernel(ref_interpret, codec):
    rng = np.random.default_rng(0)
    bits = _random_bits(rng, BLOCK, canonical_nans=False)
    bits[SPECIAL.size : SPECIAL.size + PAYLOAD_NAN.size] = PAYLOAD_NAN
    x = bits.view(np.float32)
    want = ref_interpret.encode_bf16(x)
    got = codec.encode_bf16(x)
    assert got.dtype == np.uint16 and got.shape == (BLOCK,)
    np.testing.assert_array_equal(got, want)
    nan = np.isnan(x)
    assert nan.sum() > 200 and set(got[nan].tolist()) == {0x7FC0, 0xFFC0}


def test_encode_matches_host_codec():
    rng = np.random.default_rng(1)
    x = _random_bits(rng, 1000, canonical_nans=True).view(np.float32)
    got = mc.encode_bf16_plain(torch.from_numpy(x)).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, jax_native.f32_to_bf16(x))
    np.testing.assert_array_equal(got, native.f32_to_bf16(x))
    assert got[4] == 0x7FC0 and got[5] == 0xFFC0  # ±NaN
    assert got[13] == 0x7F80 and got[15] == 0x7F80 and got[16] == 0x7F7F  # rounds up to inf / stays
    # torch's own cast gives a different NaN, which is why the plain version
    # does the bit arithmetic itself.
    assert torch.tensor([float("nan")]).to(torch.bfloat16).view(torch.int16).item() & 0xFFFF != 0x7FC0


def test_decode_axpy_matches_reference_kernel(ref_interpret, codec):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(BLOCK).astype(np.float32)
    bits = jax_native.f32_to_bf16(x)
    acc = rng.standard_normal(BLOCK).astype(np.float32)
    want = ref_interpret.decode_axpy(acc.copy(), bits, 0.3)
    # The wrapper on CPU tensors is the plain version; in place when asked.
    a = torch.from_numpy(acc.copy())
    got = mc.bf16_decode_axpy(a, torch.from_numpy(bits.view(np.int16)), 0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    out = mc.bf16_decode_axpy(a, torch.from_numpy(bits.view(np.int16)), 0.3, out=a)
    assert out is a
    np.testing.assert_array_equal(a.numpy(), got.numpy())
    np.testing.assert_array_equal(codec.decode_bf16(bits), jax_native.bf16_to_f32(bits))


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    before = dict(mc.LAUNCHES)
    x = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mc.bf16_encode(x)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        mc.bf16_decode_axpy(x, torch.empty(16, dtype=torch.int16, device="meta"), 1.0)
    mc.bf16_encode(torch.ones(16))  # plain version: no launch counted
    assert mc.LAUNCHES == before


@pytest.mark.parametrize(
    "method,kw",
    [("mean", {"weights": np.array([1.0, 2.0, 0.5, 1.5, 3.0])}), ("median", {}), ("trimmed_mean", {"trim": 1})],
)
def test_aggregate_matches_reference(ref_codec, codec, method, kw):
    rng = np.random.default_rng(3)
    stack = rng.standard_normal((5, 3000)).astype(np.float32)
    stack[2, ::7] = np.nan  # a byzantine row: NaN -> +inf before the sort
    want = ref_codec.aggregate(stack, method, **kw)
    got = codec.aggregate(stack, method, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isnan(got).any() == (method == "mean")
    bits = jax_native.f32_to_bf16(stack)
    np.testing.assert_allclose(
        codec.aggregate_bits(bits.reshape(5, -1), method, **kw),
        ref_codec.aggregate_bits(bits.reshape(5, -1), method, **kw),
        rtol=RTOL, atol=ATOL,
    )
    with pytest.raises(ValueError, match="too large"):
        codec.aggregate(stack, "trimmed_mean", trim=3)


def test_mean_folder_matches_reference_folder_and_host_fold(ref_codec, codec):
    """A ragged buffer (the last tile short), three peers' chunks staged in
    ONE batch so every tile repeats in it, then a dense feed."""
    rng = np.random.default_rng(4)
    n, tile = 10000, 2048
    n_tiles = -(-n // tile)
    bufs = rng.standard_normal((3, n)).astype(np.float32)
    weights = [0.5, 1.0, 2.0]
    dense = rng.standard_normal(n).astype(np.float32)
    folders = [codec.mean_folder(n, tile, n_tiles, "bf16"), ref_codec.mean_folder(n, tile, n_tiles, "bf16")]
    host = np.zeros(n, np.float32)
    for folder in folders:
        folder.flush_bytes = 1 << 30  # stage everything: one batch
    for p in range(3):
        bits = native.f32_to_bf16(bufs[p])
        for t in range(n_tiles):
            e0, e1 = t * tile, min((t + 1) * tile, n)
            for folder in folders:
                folder.add(t, weights[p], bits[e0:e1].tobytes())
            native.weighted_sum_inplace(host[e0:e1], native.bf16_to_f32(bits[e0:e1]), weights[p])
    for folder in folders:
        folder.flush()
        folder.add_dense(dense, 1.5)
    native.weighted_sum_inplace(host, dense, 1.5)
    got, want = (f.result() for f in folders)
    assert folders[0].flushes == 1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, host, rtol=RTOL, atol=ATOL)
    # The f32 wire folds the same way.
    f32 = codec.mean_folder(n, tile, n_tiles, "f32")
    for t in range(n_tiles):
        f32.add(t, 2.0, bufs[0][t * tile : (t + 1) * tile].tobytes())
    np.testing.assert_allclose(f32.result(), 2.0 * bufs[0], rtol=RTOL, atol=ATOL)


def test_failure_mid_round_commits_all_mass():
    """A device failure between two flushes raises out of the flush (the
    aggregator's finalize then fails the round, and no peer merges a partial
    mean); the codec stays on the device, and the next round's folder
    commits all the mass of its contributions."""
    codec = mc.MeshCodec(device="cpu", backend="device")
    rng = np.random.default_rng(5)
    bufs = rng.standard_normal((2, 8192)).astype(np.float32)
    bits = [native.f32_to_bf16(b) for b in bufs]

    def feed(folder, p, w):
        for t in range(4):
            folder.add(t, w, bits[p][t * 2048 : (t + 1) * 2048].tobytes())
        folder.flush()

    folder = codec.mean_folder(8192, 2048, 4, "bf16")
    feed(folder, 0, 1.0)
    codec.inject_failure()
    with pytest.raises(mc.MeshCodecError, match="injected"):
        feed(folder, 1, 2.0)
    with pytest.raises(mc.MeshCodecError, match="injected"):
        codec.inject_failure()
        codec.encode_bf16(bufs[0])
    assert codec.stats()["backend"] == "device"
    folder = codec.mean_folder(8192, 2048, 4, "bf16")
    assert folder is not None
    ref = np.zeros(8192, np.float32)
    for p, w in enumerate((1.0, 2.0)):
        feed(folder, p, w)
        native.weighted_sum_inplace(ref, native.bf16_to_f32(bits[p]), w)
    np.testing.assert_allclose(folder.result(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(codec.encode_bf16(bufs[0]), bits[0])


def test_selection_is_by_argument_only(monkeypatch):
    monkeypatch.setenv("DVC_MESH_CODEC", "0")
    monkeypatch.setenv("DVC_MESH_PALLAS", "interpret")
    monkeypatch.setenv("DVC_MESH_COLLECTIVE", "ring")
    assert mc.MeshCodec(device="cpu", backend="device").backend == "device"
    monkeypatch.setenv("DVC_MESH_CODEC", "1")
    assert mc.MeshCodec(device="cpu").backend == "host"  # auto: device only on CUDA
    with pytest.raises(ValueError, match="backend"):
        mc.MeshCodec(device="cpu", backend="mesh")
    mc.reset()
    try:
        if torch.cuda.is_available():
            assert mc.get_default().device.type == "cuda"
        else:  # nothing configured: the default is the card, which is missing
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mc.get_default()
        assert mc.configure(device="cpu", backend="device") is mc.get_default()
    finally:
        mc.reset()


# ---------------------------------------------------------------------------
# K5 on a staged batch: fold_chunks_plain, the chunk-table plan, the wrapper
# ---------------------------------------------------------------------------

FOLD_N, FOLD_TILE = 10000, 2048  # five tiles, the last one short (1808)


def _fold_batch(rng):
    """Three peers' chunks of a ragged buffer staged in one batch, tiles
    repeated and out of order, one zero weight: [(tile, weight, bits)]."""
    n_tiles = -(-FOLD_N // FOLD_TILE)
    bufs = rng.standard_normal((3, FOLD_N)).astype(np.float32)
    batch = []
    for p, w in enumerate((0.5, 0.0, 2.0)):
        bits = native.f32_to_bf16(bufs[p])
        for t in rng.permutation(n_tiles):
            batch.append((int(t), w, bits[t * FOLD_TILE : (t + 1) * FOLD_TILE]))
    return batch


def _per_chunk_loop(acc, rows, batch, lo):
    """The staged folder's fold before the batched kernel: one
    ``decode_axpy_plain`` per chunk, in staging order, on the rank's slice."""
    shard = acc.shape[1]
    for i, (t, w, bits) in enumerate(batch):
        n = min(bits.size - lo, shard)
        if n > 0:
            acc[t, :n] = mc.decode_axpy_plain(acc[t, :n], rows[i, :n], w)


@pytest.mark.parametrize("nd", [1, 2])
def test_fold_chunks_plain_matches_reference_folder_flush(ref_codec, nd):
    rng = np.random.default_rng(6)
    n_tiles = -(-FOLD_N // FOLD_TILE)
    shard = FOLD_TILE // nd
    batch = _fold_batch(rng)
    ref = ref_codec.mean_folder(FOLD_N, FOLD_TILE, n_tiles, "bf16")
    ref.flush_bytes = 1 << 30  # one batch, as the port's flush below
    for t, w, bits in batch:
        ref.add(t, w, bits.tobytes())
    want = ref.result()
    rows = np.zeros((len(batch), FOLD_TILE), np.uint16)
    for i, (_, _, bits) in enumerate(batch):
        rows[i, : bits.size] = bits
    whole = torch.from_numpy(rows.view(np.int16))
    tiles = [t for t, _, _ in batch]
    weights = [w for _, w, _ in batch]
    shards, loops, from_whole = [], [], []
    for r in range(nd):
        lo = r * shard
        lens = [min(max(bits.size - lo, 0), shard) for _, _, bits in batch]
        part = whole[:, lo : lo + shard].contiguous()
        acc = torch.zeros((n_tiles, shard))
        mc.fold_chunks_plain(acc, part, tiles, weights, lens, 0)
        shards.append(acc)
        loop = torch.zeros((n_tiles, shard))
        _per_chunk_loop(loop, part, batch, lo)
        loops.append(loop)
        # The same rank reading whole rows from its own column.
        acc = torch.zeros((n_tiles, shard))
        mc.fold_chunks_plain(acc, whole, tiles, weights, lens, lo)
        from_whole.append(acc)
    got = torch.cat(shards, dim=1).reshape(-1)[:FOLD_N].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for a, b, c in zip(shards, loops, from_whole):
        np.testing.assert_array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32))
        np.testing.assert_array_equal(a.numpy().view(np.int32), c.numpy().view(np.int32))


def _check_plan(tiles, weights, lens):
    plan = mc.fold_plan(tiles, weights, lens)
    seen, tile_group = [], {}
    for g, (words, n_tiles, n_chunks) in enumerate(plan):
        w = np.frombuffer(words, np.int32)
        assert w.size == 3 * n_tiles + 1 + 3 * n_chunks <= mc.FOLD_WORDS
        rows, cols, ptr = w[:n_tiles], w[n_tiles : 2 * n_tiles], w[2 * n_tiles : 3 * n_tiles + 1]
        chunk = w[3 * n_tiles + 1 : 3 * n_tiles + 1 + n_chunks]
        wb, ln = w[3 * n_tiles + 1 + n_chunks : -n_chunks], w[-n_chunks:]
        assert ptr[0] == 0 and ptr[-1] == n_chunks and (np.diff(ptr) > 0).all()
        for u, t in enumerate(rows):
            assert t not in tile_group  # a tile's chunks stay in one launch
            tile_group[t] = g
            mine = chunk[ptr[u] : ptr[u + 1]]
            assert (np.diff(mine) > 0).all()  # staging order
            assert all(tiles[i] == t for i in mine) and cols[u] == max(lens[i] for i in mine)
        np.testing.assert_array_equal(wb, np.asarray(weights, np.float32)[chunk].view(np.int32))
        np.testing.assert_array_equal(ln, np.asarray(lens)[chunk])
        seen += chunk.tolist()
    assert sorted(seen) == [i for i, n in enumerate(lens) if n > 0]  # every chunk once, empty ones dropped
    return plan


@pytest.mark.parametrize(
    "name,tiles,lens,launches",
    [
        # A flagship flush: 16 chunks of 1 MiB, 13 tiles (the tail short), 97 words.
        ("flagship", [5, 9, 0, 237, 14, 5, 3, 8, 2, 1, 6, 11, 7, 5, 9, 0], [524288] * 3 + [183552] + [524288] * 12, 1),
        # 256 chunks of 64 KiB, every tile distinct: 1537 words, one launch.
        ("small", list(range(256)), [32768] * 256, 1),
        # 600 chunks over 300 tiles: 2701 words, must split.
        ("split", [t for t in range(300) for _ in range(2)], [1024] * 600, 2),
        # Zero-length chunks (a short tail before the rank's columns) fold nothing.
        ("empty", [0, 1, 2, 1, 0], [64, 0, 64, 0, 0], 1),
    ],
)
def test_fold_plan_keeps_each_tile_in_one_launch(name, tiles, lens, launches):
    rng = np.random.default_rng(len(tiles))
    order = rng.permutation(len(tiles)) if name == "split" else np.arange(len(tiles))
    tiles = [tiles[i] for i in order]
    weights = rng.uniform(0.0, 2.0, len(tiles)).tolist()
    assert len(_check_plan(tiles, weights, lens)) == launches


def test_fold_plan_refuses_a_tile_whose_chunks_need_more_than_one_table():
    k = (mc.FOLD_WORDS - 4) // 3 + 1
    with pytest.raises(ValueError, match="table words"):
        mc.fold_plan([7] * k, [1.0] * k, [8] * k)
    assert len(mc.fold_plan([7] * (k - 1), [1.0] * (k - 1), [8] * (k - 1))) == 1


@pytest.mark.parametrize(
    "case,match",
    [
        ("tile_high", "out of"), ("tile_negative", "out of"), ("len_past_shard", "past the shard"),
        ("len_past_row", "past the bits row"), ("len_negative", "past the shard"), ("col0_negative", "negative"),
        ("counts", "bits rows"), ("acc_dtype", "acc must be"), ("bits_dtype", "bits_rows must be"),
        ("strided_rows", "contiguous rows"), ("device", "CUDA or CPU"),
    ],
)
def test_fold_chunks_raises_on_a_malformed_table(case, match):
    acc, bits = torch.zeros((4, 16)), torch.zeros((3, 20), dtype=torch.int16)
    args = dict(tiles=[0, 3, 1], weights=[1.0, 0.5, 2.0], lens=[16, 8, 16], col0=4)
    if case == "tile_high":
        args["tiles"] = [0, 4, 1]
    elif case == "tile_negative":
        args["tiles"] = [0, -1, 1]
    elif case == "len_past_shard":
        acc, bits = torch.zeros((4, 16)), torch.zeros((3, 40), dtype=torch.int16)
        args["lens"] = [16, 17, 16]
    elif case == "len_past_row":
        args["col0"] = 5
    elif case == "len_negative":
        args["lens"] = [16, -1, 16]
    elif case == "col0_negative":
        args["col0"] = -1
    elif case == "counts":
        args["weights"] = [1.0, 0.5]
    elif case == "acc_dtype":
        acc = acc.double()
    elif case == "bits_dtype":
        bits = bits.int()
    elif case == "strided_rows":
        bits = torch.zeros((20, 3), dtype=torch.int16).t()
    elif case == "device":
        acc, bits = acc.to("meta"), bits.to("meta")
    before = dict(mc.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        mc.bf16_fold_chunks(acc, bits, **args)
    if case != "device":
        with pytest.raises(ValueError, match=match):
            mc.fold_chunks_plain(acc, bits, **args)
    assert mc.LAUNCHES == before


@pytest.mark.parametrize("nd", [1, 2])
def test_folder_flush_makes_one_fold_per_rank(monkeypatch, nd):
    """A staged flush folds its whole batch with one ``bf16_fold_chunks``
    call per rank (one K5 launch on the card), not one per chunk."""
    from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh

    codec = (mc.MeshCodec(device="cpu", backend="device") if nd == 1 else
             mc.MeshCodec(mesh=make_mesh(dp=2, devices=["cpu", "cpu"]), backend="device", collective="off"))
    calls = []
    fold = mc.bf16_fold_chunks
    monkeypatch.setattr(mc, "bf16_fold_chunks", lambda *a: calls.append(len(a[2])) or fold(*a))
    rng = np.random.default_rng(7)
    n_tiles = -(-FOLD_N // FOLD_TILE)
    folder = codec.mean_folder(FOLD_N, FOLD_TILE, n_tiles, "bf16")
    folder.flush_bytes = 1 << 30
    before = dict(mc.LAUNCHES)
    host = np.zeros(FOLD_N, np.float32)
    for t, w, bits in _fold_batch(rng):
        folder.add(t, w, bits.tobytes())
        native.weighted_sum_inplace(host[t * FOLD_TILE : t * FOLD_TILE + bits.size], native.bf16_to_f32(bits), w)
    folder.flush()
    assert calls == [3 * n_tiles] * nd and folder.flushes == 1
    np.testing.assert_allclose(folder.result(), host, rtol=RTOL, atol=ATOL)
    assert mc.LAUNCHES == before  # no kernel launch on the CPU


@pytest.mark.parametrize("backend,nd", [("device", 1), ("device", 2), ("host", 1)])
def test_codec_decode_axpy_matches_reference(ref_interpret, backend, nd):
    from distributedvolunteercomputing_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(8)
    x = rng.standard_normal(BLOCK).astype(np.float32)
    bits = jax_native.f32_to_bf16(x)
    acc = rng.standard_normal(BLOCK).astype(np.float32)
    want = ref_interpret.decode_axpy(acc.copy(), bits, 0.3)
    codec = (mc.MeshCodec(device="cpu", backend=backend) if nd == 1 else
             mc.MeshCodec(mesh=make_mesh(dp=2, devices=["cpu", "cpu"]), backend=backend))
    got = codec.decode_axpy(acc.copy(), bits, 0.3)
    assert got.dtype == np.float32 and got.shape == (BLOCK,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="size mismatch"):
        codec.decode_axpy(acc, bits[:-1], 0.3)
    if backend == "host":  # the host fold mutates the caller's accumulator, as the reference's does
        a = acc.copy()
        res = codec.decode_axpy(a, bits, 0.3)
        assert np.shares_memory(res, a) and np.array_equal(a, got)
    # The mismatch raised before any op ran.
    assert codec.stats()["ops_host" if backend == "host" else "ops_mesh"] == (2 if backend == "host" else 1)


def _codec_variants():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "experiments" / "torch_codec_variants.py"
    spec = importlib.util.spec_from_file_location("torch_codec_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["current", "unroll8", "no_hints", "persistent", "tma", "parent"])
def test_codec_variant_patches_apply_to_the_source(name):
    """The variants script patches ``csrc/bf16_codec.cu`` by text: every
    patch must still find its line in the shipped source (an edit that
    moves one breaks the experiment, and this says so on the CPU)."""
    variants = _codec_variants()
    src, reps = variants.VARIANTS[name]
    text = src.read_text()
    for old, _ in reps:
        assert old in text, f"variant {name}: {old!r} not in {src.name}"
