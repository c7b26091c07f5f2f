"""The port's packed wire transport (search/packed.py) against the JAX
package's: one wire format, bit for bit.

A ``PackedChunk`` packed by either package unpacks in the other to the
same int16 values; the port's packers (numpy and the host packer
csrc/wire_pack.cc, on any number of workers) equal the JAX package's and
native/wire_pack.cc's word for word; ``pack_adaptive`` ships pcm16 on
exactly the inputs where the wire_pack.cc pack did; and the packed sweep
is ``torch.equal`` to the pcm16 sweep of the same PCM.  Everything is
exact: integer arithmetic, then one multiplication by 2**-15.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaserotate_tpu.search import packed as j_packed
from phaserotate_tpu_torch.core.sizes import OfflineGeometry
from phaserotate_tpu_torch.io import native
from phaserotate_tpu_torch.search import _wirepack
from phaserotate_tpu_torch.search import packed as p_packed
from phaserotate_tpu_torch.search.packed import (
    BLOCK,
    pack_adaptive,
    pack_residual,
    packed_bits_per_sample,
    sweep_peaks_aux_packed,
    unpack_residual,
)
from phaserotate_tpu_torch.search.sweep import sweep_peaks_aux_pcm16

torch.set_num_threads(1)

N_HOSTILE = 3 * BLOCK + 17


def _impulses():
    imp = np.zeros(N_HOSTILE, np.int16)
    imp[::BLOCK] = 32767
    imp[1::BLOCK] = -32768
    return imp


def _case(name):
    """int16 PCM (..., n), from a seed: the inputs of tests/test_packed.py
    (random, the hostile extremes that maximize the residual at every
    order, odd lengths) and two smooth signals that pick an order > 0."""
    rng = np.random.default_rng(11)
    n = N_HOSTILE
    if name == "random":
        return rng.integers(-32768, 32768, (3, 2, 10_000), np.int16)
    if name.startswith("len"):
        return rng.integers(-32768, 32768, (2, int(name[3:])), np.int16)
    t = np.arange(4 * BLOCK)
    tn = np.arange(n)
    orders = [  # a stream whose best order is 0, 1, 2, 3
        rng.integers(-32768, 32768, n, np.int16),
        np.clip(np.cumsum(rng.integers(-20, 21, n)), -32768,
                32767).astype(np.int16),
        np.rint(30000 * np.sin(0.002 * tn)).astype(np.int16),
        np.rint(30000 * np.sin(0.02 * tn)).astype(np.int16)]
    if name.startswith("order"):
        return orders[int(name[5:])][None]
    if name == "one_stream":
        return (20000 * np.sin(t / 300.0)).astype(np.int16)[None]
    if name == "batch_of_orders":
        return np.stack(orders + [np.zeros(n, np.int16), _impulses()])[None]
    return {
        "silence": np.zeros(n, np.int16),
        "full_scale_high": np.full(n, 32767, np.int16),
        "full_scale_low": np.full(n, -32768, np.int16),
        "nyquist_square": (np.arange(n) % 2 * 65535 - 32768
                           ).astype(np.int16),
        "clipped_ramp": np.clip(np.arange(n) * 7 - 32768, -32768,
                                32767).astype(np.int16),
        "impulses": _impulses(),
        "slow_sine": (10000 * np.sin(t / 2000.0)).astype(np.int16),
        "mixed_orders": np.stack([
            (20000 * np.sin(t / 300.0)).astype(np.int16),
            rng.integers(-32768, 32768, t.size, np.int16),
            (t % 4096 * 8 - 16384).astype(np.int16)]),
    }[name][None]


CASES = ["random", "silence", "full_scale_high", "full_scale_low",
         "nyquist_square", "clipped_ramp", "impulses", "slow_sine",
         "mixed_orders"] + [
    f"len{n}" for n in (1, 31, BLOCK - 1, BLOCK, BLOCK + 1, 2 * BLOCK + 333)]


# The host packer's cases besides CASES: fewer than 4 samples, one stream,
# a stream of each order (order0 is white noise at full scale), and a
# batch of those with silence and impulses.
HOST_CASES = CASES + ["len2", "len3", "one_stream", "order0", "order1",
                      "order2", "order3", "batch_of_orders"]


def _force_workers(monkeypatch, workers):
    """The host packer on ``workers`` threads (an int, or "more": five
    more than the pack has blocks)."""
    monkeypatch.setattr(
        _wirepack, "workers_for",
        lambda blocks: blocks + 5 if workers == "more" else workers)


def _wire_pack_cc(x16):
    """native/wire_pack.cc's pack of ``x16`` (the oracle)."""
    assert native.available(), "native/wire_pack.cc did not build"
    shape = x16.shape
    n = shape[-1]
    streams = np.ascontiguousarray(x16.reshape(-1, n))
    S = streams.shape[0]
    nb = -(-n // BLOCK)
    words = np.empty(p_packed._grid_pad(S * nb * (BLOCK // 2) + 1),
                     np.int32)
    widths = np.empty((S, nb), np.int32)
    woffs = np.empty((S, nb), np.int32)
    order = np.empty(S, np.int32)
    total = native.pack_residual_raw(streams, words, widths, woffs, order)
    assert total >= 0
    words = words[:p_packed._grid_pad(total + 1)]
    words[total:] = 0
    return p_packed.PackedChunk(words=words, widths=widths, woffs=woffs,
                                order=order, n=n, shape=shape)


def _wire_pack_cc_adaptive(x16, scratch, threshold=0.9):
    """``pack_adaptive`` as it was over native/wire_pack.cc: the budget
    and the scratch bound the words that pack writes, and it stops on
    the first block past them."""
    assert native.available(), "native/wire_pack.cc did not build"
    shape = x16.shape
    n = shape[-1]
    streams = x16.reshape(-1, n)
    S = streams.shape[0]
    nb = -(-n // BLOCK)
    budget = int(threshold * S * n * 16) // 32
    cap = min(scratch.size, p_packed._grid_pad(budget + 1))
    widths = np.empty((S, nb), np.int32)
    woffs = np.empty((S, nb), np.int32)
    order = np.empty(S, np.int32)
    total = native.pack_residual_raw(streams, scratch[:cap], widths, woffs,
                                     order)
    if total < 0 or total > budget:
        return None
    wpad = p_packed._grid_pad(total + 1)
    if wpad > scratch.size:
        return None
    words = scratch[:wpad]
    words[total:] = 0
    return p_packed.PackedChunk(words=words, widths=widths, woffs=woffs,
                                order=order, n=n, shape=shape)


def _as_f32(x16):
    return x16.astype(np.float32) / 32768.0


def _unpack_port(pk):
    out = unpack_residual(
        torch.from_numpy(np.ascontiguousarray(pk.words)),
        torch.from_numpy(pk.widths), torch.from_numpy(pk.woffs),
        torch.from_numpy(pk.order), pk.n)
    assert out.dtype == torch.float32
    return out.numpy().reshape(pk.shape)


def _unpack_jax(pk):
    out = j_packed.unpack_residual(
        jnp.asarray(pk.words), jnp.asarray(pk.widths),
        jnp.asarray(pk.woffs), jnp.asarray(pk.order), pk.n)
    return np.asarray(out).reshape(pk.shape)


def _assert_same_chunk(a, b):
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.widths, b.widths)
    np.testing.assert_array_equal(a.woffs, b.woffs)
    np.testing.assert_array_equal(a.words, b.words)
    assert a.n == b.n and tuple(a.shape) == tuple(b.shape)
    assert a.wire_bytes == b.wire_bytes


@pytest.mark.parametrize("name", CASES)
def test_roundtrip_in_the_port(name):
    x = _case(name)
    np.testing.assert_array_equal(
        _unpack_port(pack_residual(x, native=False)), _as_f32(x))


@pytest.mark.parametrize("name", CASES)
def test_jax_chunk_unpacks_in_the_port(name):
    x = _case(name)
    np.testing.assert_array_equal(
        _unpack_port(j_packed.pack_residual(x, native=False)), _as_f32(x))


@pytest.mark.parametrize("name", CASES)
def test_port_chunk_unpacks_in_jax(name):
    x = _case(name)
    np.testing.assert_array_equal(
        _unpack_jax(pack_residual(x, native=False)), _as_f32(x))


@pytest.mark.parametrize("name", CASES)
def test_packers_equal_the_jax_package_word_for_word(name):
    x = _case(name)
    want = j_packed.pack_residual(x, native=False)
    _assert_same_chunk(pack_residual(x, native=False), want)
    if native.available():
        _assert_same_chunk(pack_residual(x, native=True), want)
        _assert_same_chunk(pack_residual(x), want)  # None: native if built


def _break_the_build(monkeypatch, tmp_path):
    bad = tmp_path / "wire_pack.cc"
    bad.write_text("int prt_wire_widths( { return 0; }\n")
    monkeypatch.setattr(_wirepack, "SOURCE", bad)
    monkeypatch.setattr(_wirepack, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_wirepack, "_lib", None)


def test_native_is_required_when_asked_for(monkeypatch, tmp_path):
    """A host packer that fails to build raises with the compiler's
    output, whether the pack asked for it (True) or took the default
    (None); only ``native=False`` packs, with numpy."""
    _break_the_build(monkeypatch, tmp_path)
    x = _case("random")
    for native_ in (True, None):
        with pytest.raises(RuntimeError,
                           match=r"(?s)exit code.*wire_pack\.cc.*error"):
            pack_residual(x, native=native_)
    np.testing.assert_array_equal(
        _unpack_port(pack_residual(x, native=False)), _as_f32(x))


def test_a_failed_build_ships_nothing(monkeypatch, tmp_path):
    """``pack_adaptive`` raises too (no quiet pcm16), and no library, whole
    or half, is left behind."""
    _break_the_build(monkeypatch, tmp_path)
    x = _case("slow_sine")
    with pytest.raises(RuntimeError, match=r"(?s)exit code.*error"):
        pack_adaptive(x, np.empty(x.size, np.int32))
    assert list((tmp_path / "build").iterdir()) == []


def test_the_build_is_named_by_source_and_flags(monkeypatch):
    """The library's name carries a hash of the source and the flags; a
    built one is reused as it is."""
    so = _wirepack.build()
    assert so.parent == _wirepack.BUILD_DIR and so.name.startswith(
        "libprt_wire_")
    mtime = so.stat().st_mtime_ns
    assert _wirepack.build() == so and so.stat().st_mtime_ns == mtime
    monkeypatch.setattr(_wirepack, "CXX_FLAGS", (*_wirepack.CXX_FLAGS, "-g"))
    assert _wirepack.library_path() != so
    assert not [p for p in so.parent.iterdir() if p.suffix == ".tmp"]


@pytest.mark.parametrize("workers", [1, 2, 3, "more"])
@pytest.mark.parametrize("name", HOST_CASES)
def test_host_packer_equals_every_oracle(monkeypatch, name, workers):
    """Words up to the total, the zeroed slack and grid padding, widths,
    offsets and orders: native/wire_pack.cc's, the numpy path's and the
    JAX package's, on any number of workers."""
    x = _case(name)
    _force_workers(monkeypatch, workers)
    got = pack_residual(x)
    _assert_same_chunk(got, _wire_pack_cc(x))
    _assert_same_chunk(got, pack_residual(x, native=False))
    _assert_same_chunk(got, j_packed.pack_residual(x, native=False))
    np.testing.assert_array_equal(_unpack_port(got), _as_f32(x))


def test_host_packer_under_more_workers_than_cores(monkeypatch):
    """Four workers a CPU over 320 blocks, five times: the shared run
    counter hands every block to one worker only, each time."""
    import os

    workers = 4 * len(os.sched_getaffinity(0))
    _force_workers(monkeypatch, workers)
    x = np.random.default_rng(9).integers(-32768, 32768, (64, 5 * BLOCK - 3),
                                          np.int16)
    x[::2] //= 256  # other widths and orders in every other stream
    want = _wire_pack_cc(x)
    for _ in range(5):
        _assert_same_chunk(pack_residual(x), want)


def test_host_packer_checks_its_buffers():
    """Every array must be C-contiguous, of its dtype and shape, and the
    words must hold the total."""
    x = np.ascontiguousarray(_case("random").reshape(-1, 10_000))
    widths, woffs, order, total, _ = p_packed._host_layout(x)
    for words in (np.empty(total - 1, np.int32), np.empty(total, np.int64),
                  np.empty(2 * total, np.int32)[::2]):
        with pytest.raises(ValueError):
            _wirepack.fill(x, widths, woffs, order, words, total, 1)
    for bad in (x.astype(np.int32), x[:, ::2]):
        with pytest.raises(ValueError):
            _wirepack.layout(bad, widths, woffs, order, 1)
    with pytest.raises(ValueError):
        _wirepack.layout(x, widths[:, :1], woffs, order, 1)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_host_cases_are_what_they_say(k):
    """Each order case picks its order; full-scale noise packs at 16 bits,
    silence at 1; the batch picks all four."""
    pk = pack_residual(_case(f"order{k}"))
    assert pk.order.tolist() == [k]
    if k == 0:
        assert set(pk.widths.ravel().tolist()) == {16}
    assert set(pack_residual(_case("silence")).widths.ravel().tolist()) == {1}
    assert set(pack_residual(_case("batch_of_orders")).order.tolist()) == {
        0, 1, 2, 3}


@pytest.mark.parametrize("group", [BLOCK, 3 * BLOCK, 1 << 25])
def test_unpack_group_size_does_not_change_the_result(group):
    """The streams unpack independently: the metadata of any group of
    streams of about ``group`` samples, over the whole words, gives those
    streams' samples."""
    for name in ("random", "mixed_orders"):
        x = _case(name)
        pk = pack_residual(x)
        whole = _unpack_port(pk).reshape(-1, pk.n)
        words = torch.from_numpy(np.ascontiguousarray(pk.words))
        step = max(1, group // (pk.widths.shape[1] * BLOCK))
        for a in range(0, pk.widths.shape[0], step):
            got = unpack_residual(
                words, *(torch.from_numpy(m[a : a + step])
                         for m in (pk.widths, pk.woffs, pk.order)), pk.n)
            np.testing.assert_array_equal(got.numpy(), whole[a : a + step])


def test_unpack_rejects_other_dtypes():
    pk = pack_residual(_case("len31"))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (pk.words, pk.widths, pk.woffs, pk.order)]
    with pytest.raises(TypeError, match="int32"):
        unpack_residual(t[0].long(), t[1], t[2], t[3], pk.n)
    with pytest.raises(TypeError, match="int32"):
        unpack_residual(t[0], t[1], t[2], t[3].long(), pk.n)


def test_tonal_content_compresses():
    """Music-like content packs well below 16 bits/sample; white noise
    never exceeds 16 + metadata and grid padding; and both packages count
    the same bits."""
    rng = np.random.default_rng(11)
    n = 48000 * 2
    t = np.arange(n) / 48000.0
    tone = np.clip(np.rint(32768 * (
        0.3 * np.sin(2 * np.pi * 220 * t)
        + 0.1 * np.sin(2 * np.pi * 440 * t)
        + 0.001 * rng.standard_normal(n))), -32768, 32767).astype(np.int16)
    pk = pack_residual(tone[None])
    assert packed_bits_per_sample(pk) < 12.0
    assert packed_bits_per_sample(pk) == j_packed.packed_bits_per_sample(
        j_packed.pack_residual(tone[None]))
    assert pk.wire_bytes < 2 * n
    noise = rng.integers(-32768, 32768, (1, n), np.int16)
    assert packed_bits_per_sample(pack_residual(noise)) < 17.5


def test_order_selection_adapts():
    assert pack_residual(_case("len16384")).order.tolist() == [0, 0]
    assert pack_residual(_case("slow_sine")).order[0] >= 1
    assert len(set(pack_residual(_case("mixed_orders")).order.tolist())) > 1


@pytest.mark.parametrize("use_native", [False, True])
def test_scratch_buffer_reuse(use_native):
    if use_native and not native.available():
        pytest.skip("native host library unavailable")
    x = np.random.default_rng(5).integers(-32768, 32768, (2, 3 * BLOCK),
                                          np.int16)
    ref = pack_residual(x, native=False)
    scratch = np.empty(1 << 20, np.int32)
    pk = pack_residual(x, out_words=scratch, native=use_native)
    assert pk.words.base is scratch
    np.testing.assert_array_equal(pk.words, ref.words)
    np.testing.assert_array_equal(_unpack_port(pk), _as_f32(x))


def _tone16(shape_lead, n, noise, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    return np.clip(np.rint(32768 * (
        0.4 * np.sin(2 * np.pi * 300 * t) * np.ones((*shape_lead, 1))
        + noise * rng.standard_normal((*shape_lead, n)))), -32768,
        32767).astype(np.int16)


def test_pack_adaptive_equals_the_jax_package():
    """Compressible content packs (the same chunk as JAX's, unpacking to
    the input); noise exceeds the budget and ships as pcm16 (None)."""
    x = _tone16((2, 2), 8 * BLOCK + 5, 0.001)
    scratch = np.empty(max(1 << 16, x.size * 16 // 32), np.int32)
    pk = pack_adaptive(x, scratch)
    assert pk is not None and pk.words.base is scratch
    np.testing.assert_array_equal(_unpack_port(pk), _as_f32(x))
    j_scratch = np.empty_like(scratch)
    _assert_same_chunk(pk, j_packed.pack_adaptive(x, j_scratch))
    noise = _case("random")
    assert pack_adaptive(noise, scratch) is None
    assert j_packed.pack_adaptive(noise, j_scratch) is None


@pytest.mark.parametrize("lead,n,blksiz", [((3, 1), 6000, 1024),
                                           ((2, 2), 9001, 2048),
                                           ((2,), 5000, 1024)])
def test_packed_sweep_equals_the_pcm16_sweep(lead, n, blksiz):
    """Identical dequantized floats feed the identical sweep: torch.equal;
    and the JAX package's packed sweep agrees within float32 roundoff of
    the convolution (3e-6, as the pcm16 paths do)."""
    x = _tone16(lead, n, 0.02)
    geom = OfflineGeometry(blksiz)
    want_t, want_r = sweep_peaks_aux_pcm16(x, geom, device="cpu")
    got_t, got_r = sweep_peaks_aux_packed(pack_residual(x), geom,
                                          device="cpu")
    assert got_t.shape == (*lead, 360)
    assert torch.equal(got_t, want_t) and torch.equal(got_r, want_r)
    from phaserotate_tpu.core.sizes import OfflineGeometry as JGeom

    j_t, j_r = j_packed.sweep_peaks_aux_packed(
        j_packed.pack_residual(x), JGeom(blksiz))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(j_t), atol=3e-6,
                               rtol=0)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(j_r), atol=3e-6,
                               rtol=0)


def test_packed_sweep_needs_a_device():
    """Nothing runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    pk = pack_residual(_case("len4097"))
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep_peaks_aux_packed(pk, OfflineGeometry(1024))


def _adaptive_input(name):
    return _tone16((2, 2), 8 * BLOCK + 5, 0.001) if name == "tone" \
        else _case(name)


@pytest.mark.parametrize("room", ["ample", "exact", "short"])
@pytest.mark.parametrize("budget", ["default", "at_total", "below_total"])
@pytest.mark.parametrize("name", ["tone", "random", "batch_of_orders",
                                  "silence"])
def test_pack_adaptive_ships_pcm16_where_wire_pack_cc_did(name, budget,
                                                          room):
    """None on exactly the inputs where the pack over native/wire_pack.cc
    gave None, the same chunk elsewhere, at the default threshold and at
    budgets of the packed total and one word less, with scratch to spare,
    exactly the padded words, and one word short; the scratch holds
    another pack's words beforehand."""
    x = _adaptive_input(name)
    S, n = int(np.prod(x.shape[:-1])), x.shape[-1]
    total = int(pack_residual(x).widths.sum()) * (BLOCK // 32)
    wpad = p_packed._grid_pad(total + 1)
    threshold = {"default": 0.9, "at_total": (32 * total + 16) / (16 * S * n),
                 "below_total": (32 * total - 16) / (16 * S * n)}[budget]
    size = {"ample": 2 * wpad + x.size, "exact": wpad, "short": wpad - 1}[room]
    stale = pack_residual(_case("random")).words
    scratches = []
    for _ in range(3):
        scratch = np.full(size, -7, np.int32)
        scratch[: min(size, stale.size)] = stale[:size]
        scratches.append(scratch)
    got = pack_adaptive(x, scratches[0], threshold)
    want = _wire_pack_cc_adaptive(x, scratches[1], threshold)
    assert (got is None) == (want is None)
    j_got = j_packed.pack_adaptive(x, scratches[2], threshold)
    assert (j_got is None) == (want is None)
    if budget == "below_total" or room == "short":
        assert got is None
    if budget == "at_total" and room != "short":
        assert got is not None
    if got is not None:
        assert got.words.base is scratches[0]
        _assert_same_chunk(got, want)
        _assert_same_chunk(got, j_got)
        np.testing.assert_array_equal(_unpack_port(got), _as_f32(x))


@pytest.mark.parametrize("workers", [1, 3, "more"])
def test_pack_adaptive_into_a_reused_scratch(monkeypatch, workers):
    """One scratch through a run of packs, as a staging ring would reuse
    it: each chunk equals a fresh pack over native/wire_pack.cc."""
    _force_workers(monkeypatch, workers)
    scratch = np.empty(1 << 16, np.int32)
    for name in ("tone", "batch_of_orders", "random", "silence", "len31",
                 "one_stream"):
        x = _adaptive_input(name)
        got = pack_adaptive(x, scratch)
        want = _wire_pack_cc_adaptive(x, np.empty_like(scratch))
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.words.base is scratch
            _assert_same_chunk(got, want)


# A numpy emulation of csrc/wire_unpack.cu's decomposition, held bit for
# bit to the plain twin (kernels/unpack.py wire_unpack_plain): each
# block's words staged at thread t's pitch (w | 1) through the kernel's
# division by multiplication, 32 residuals a thread by funnel shifts, the
# thread's nested sums, the block's scan of its 128 threads (warp
# shuffles, then the four warps' totals), each stream's scan of its
# blocks' sums on 1024 threads, and the carries applied, all in wrapping
# uint32.  Edit it with any change to the kernel's maps or sums.

_THREADS, _PER, _SCAN_THREADS = 128, 32, 1024
_ZERO = np.zeros((), np.uint32)


def _u32(v):
    return np.asarray(v, np.uint32)


def _tri(l):
    """l (l + 1) / 2 mod 2^32, halving the even factor first."""
    l = _u32(l)
    with np.errstate(over="ignore"):
        return np.where(l & 1, l * ((l + 1) >> 1), (l >> 1) * (l + 1))


def _combine(p, q):
    """The kernel's ``combine``: p's segment, then q's, as (l, a1, a2,
    a3) uint32 arrays."""
    pl, p1, p2, p3 = p
    ql, q1, q2, q3 = q
    with np.errstate(over="ignore"):  # uint32 wraps, as on the card
        return (pl + ql, p1 + q1, p2 + ql * p1 + q2,
                p3 + ql * p2 + _tri(ql) * p1 + q3)


def _identity(shape):
    return tuple(np.zeros(shape, np.uint32) for _ in range(4))


def _warp_inclusive(e):
    """Hillis-Steele over the last axis (32 lanes), as the shuffles."""
    e = tuple(a.copy() for a in e)
    for d in (1, 2, 4, 8, 16):
        up = _combine(tuple(a[..., :-d] for a in e),
                      tuple(a[..., d:] for a in e))
        for a, u in zip(e, up):
            a[..., d:] = u
    return e


def _exclusive(e, warps):
    """What precedes each thread of (..., warps * 32) summaries: the
    kernel's ``block_exclusive`` (and the carries kernel's first half)."""
    lead = e[0].shape[:-1]
    e = tuple(a.reshape(*lead, warps, 32) for a in e)
    inc = _warp_inclusive(e)
    excl = tuple(np.concatenate([np.zeros((*lead, warps, 1), np.uint32),
                                 a[..., :-1]], axis=-1) for a in inc)
    totals = tuple(a[..., -1] for a in inc)             # (..., warps)
    pre = _identity((*lead, 1))
    pres = []
    for q in range(warps):
        pres.append(pre)
        pre = _combine(pre, tuple(a[..., q : q + 1] for a in totals))
    pre = tuple(np.concatenate([p[k] for p in pres], axis=-1)[..., None]
                for k in range(4))
    out = _combine(tuple(np.broadcast_to(a, excl[0].shape) for a in pre),
                   excl)
    return tuple(a.reshape(*lead, warps * 32) for a in out)


def _emulate_decode(words, w, off):
    """One block's (128, 32) int32 residuals, as the kernel stages and
    shifts them."""
    n_words = words.size
    w = int(min(max(w, 1), 32))
    pitch, total = w | 1, _THREADS * w
    magic = ((1 << 32) + w - 1) // w
    sm = np.zeros(_THREADS * 33 + 1, np.uint64)
    g = np.arange(total, dtype=np.uint64)
    t = (g * np.uint64(magic)) >> np.uint64(32)
    assert np.array_equal(t, g // np.uint64(w))
    at = off + g.astype(np.int64)
    ok = (at >= 0) & (at < n_words)
    sm[(t * np.uint64(pitch) + g - t * np.uint64(w)).astype(np.int64)] = (
        np.where(ok, words.view(np.uint32)[np.clip(at, 0, n_words - 1)], 0))
    j = np.arange(_PER, dtype=np.uint64)
    bit = j * np.uint64(w)
    k = (np.arange(_THREADS, dtype=np.uint64)[:, None] * np.uint64(pitch)
         + (bit >> np.uint64(5))).astype(np.int64)
    pair = sm[k] | (sm[k + 1] << np.uint64(32))
    v = (pair >> (bit & np.uint64(31))) & np.uint64(0xFFFFFFFF)
    cut = np.uint64(32 - w)
    v = ((v << cut) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (v.view(np.int32) >> np.int32(32 - w)).view(np.uint32)


def _emulate_wire_unpack(words, widths, woffs, order, n):
    """csrc/wire_unpack.cu's three launches in numpy: (S, n) float32."""
    words = np.ascontiguousarray(words, np.int32)
    S, nb = widths.shape
    scan = (order >= 1) & (order <= 3)
    res = np.empty((S, nb, _THREADS, _PER), np.uint32)
    for s in range(S):
        for b in range(nb):
            res[s, b] = _emulate_decode(words, widths[s, b], woffs[s, b])
    # thread sums from zero: (l, L1, L2, L3) at the thread's end
    l1 = np.cumsum(res, axis=-1, dtype=np.uint32)
    l2 = np.cumsum(l1, axis=-1, dtype=np.uint32)
    l3 = np.cumsum(l2, axis=-1, dtype=np.uint32)
    own = (np.full((S, nb, _THREADS), _PER, np.uint32), l1[..., -1],
           l2[..., -1], l3[..., -1])
    pre = _exclusive(own, _THREADS // 32)                # (S, nb, 128)
    # launch 1: the block's sums, the last thread's prefix and its own
    block = _combine(tuple(a[..., -1] for a in pre),
                     tuple(a[..., -1] for a in own))     # (S, nb)
    # launch 2: each stream's blocks on 1024 threads, `per` a thread
    per = -(-nb // _SCAN_THREADS)
    carries = np.zeros((S, nb, 3), np.uint32)
    for s in range(S):
        if not scan[s]:
            continue
        item = lambda j: (_u32(BLOCK), block[1][s, j], block[2][s, j],
                          block[3][s, j])
        mine = _identity(_SCAN_THREADS)
        for t in range(_SCAN_THREADS):
            m = _identity(())
            for j in range(min(nb, t * per), min(nb, t * per + per)):
                m = _combine(m, item(j))
            for a, v in zip(mine, m):
                a[t] = v
        tpre = _exclusive(mine, _SCAN_THREADS // 32)
        for t in range(_SCAN_THREADS):
            c = tuple(a[t] for a in tpre)
            for j in range(min(nb, t * per), min(nb, t * per + per)):
                carries[s, j] = c[1:]
                c = _combine(c, item(j))
    # launch 3: the block's carries, then the thread's prefix, then the
    # thread's own nested sums from there
    c = _combine((_ZERO, carries[..., 0, None], carries[..., 1, None],
                  carries[..., 2, None]), pre)
    y1 = c[1][..., None] + l1
    y2 = c[2][..., None] + np.cumsum(y1, axis=-1, dtype=np.uint32)
    y3 = c[3][..., None] + np.cumsum(y2, axis=-1, dtype=np.uint32)
    o = order[:, None, None, None]
    v = np.where(o == 1, y1, np.where(o == 2, y2, np.where(o == 3, y3, res)))
    v = v.reshape(S, nb * BLOCK)[:, :n].view(np.int32)
    return v.astype(np.float32) * np.float32(1.0 / 32768.0)


def _twin(words, widths, woffs, order, n):
    from phaserotate_tpu_torch.kernels.unpack import wire_unpack_plain

    return wire_unpack_plain(
        *(torch.from_numpy(np.ascontiguousarray(a, np.int32))
          for a in (words, widths, woffs, order)), n).numpy()


def _forced_order_wire(x16, orders):
    """The wire of (S, n) int16 ``x16`` with stream s at ``orders[s]``,
    whatever the packer would pick: its k-th difference, each block at
    its minimal width, blocks in (stream, block) order, one slack word."""
    S, n = x16.shape
    nb = -(-n // BLOCK)
    streams = np.pad(x16.astype(np.int32), ((0, 0), (0, nb * BLOCK - n)))
    resid = np.empty_like(streams)
    for s, k in enumerate(orders):
        r = streams[s]
        for _ in range(k):
            r = np.diff(r, prepend=0)
        resid[s] = r
    blocks = resid.reshape(S * nb, BLOCK)
    widths = p_packed._signed_width(blocks.max(-1), blocks.min(-1))
    parts = [p_packed._pack_fixed_width(blocks[i : i + 1], int(widths[i]))[0]
             for i in range(S * nb)]
    woffs = np.cumsum([0] + [p.size for p in parts[:-1]]).astype(np.int32)
    words = np.concatenate(parts + [np.zeros(1, np.int32)])
    return (words, widths.reshape(S, nb), woffs.reshape(S, nb),
            np.asarray(orders, np.int32), n)


def _square(n, period):
    return np.where(np.arange(n) % period < period // 2, 32767,
                    -32768).astype(np.int16)


def _alternating(n):
    return np.where(np.arange(n) % 2 == 0, -32768, 32767).astype(np.int16)


EMULATED = ["random", "mixed_orders", "batch_of_orders", "nyquist_square",
            "impulses", "silence", "len1", "len31", f"len{BLOCK}",
            f"len{2 * BLOCK + 333}", "one_stream"]


@pytest.mark.parametrize("name", EMULATED)
def test_kernel_emulation_equals_the_twin_on_packed_wires(name):
    """Packer-made wires: orders 0-3, one-block and many-block streams,
    lengths that are no multiple of 4096."""
    pk = pack_residual(_case(name))
    wire = (pk.words, pk.widths, pk.woffs, pk.order, pk.n)
    got = _emulate_wire_unpack(*wire)
    want = _twin(*wire)
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(pk.shape), _as_f32(_case(name)))


@pytest.mark.parametrize("signal", ["square", "alternating", "impulses"])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_kernel_emulation_on_the_widest_residuals(signal, order):
    """Full-scale square and alternating -32768/32767 signals forced to
    each order: order 3 ships residuals of up to 262,140 in magnitude (19
    bits), the widest an int16 signal gives."""
    n = 2 * BLOCK + 77
    x = {"square": _square(n, 6), "alternating": _alternating(n),
         "impulses": _impulses()[:n]}[signal]
    x16 = np.stack([x, -x - 1, x[::-1].copy()])
    wire = _forced_order_wire(x16, [order] * 3)
    if order == 3 and signal == "alternating":
        assert wire[1].max() == 19
    got = _emulate_wire_unpack(*wire)
    assert np.array_equal(got, _twin(*wire))
    np.testing.assert_array_equal(got, _as_f32(x16))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_emulation_on_adversarial_wires(seed):
    """Random words under every width 1-32, offsets anywhere inside the
    words (unaligned, overlapping, out of order), orders 0-3 and one
    outside them (which ships the residuals): the int32 wrap of the
    twin's cumsums is the kernel's uint32 wrap."""
    rng = np.random.default_rng(seed)
    S, nb = 5, 9
    n = nb * BLOCK - int(rng.integers(0, BLOCK))
    widths = rng.integers(1, 33, (S, nb)).astype(np.int32)
    widths.flat[:32] = np.arange(1, 33)
    W = 40 * 128 * 32
    words = rng.integers(-2**31, 2**31, W, dtype=np.int64).astype(np.int32)
    woffs = rng.integers(0, W - 128 * widths - 1).astype(np.int32)
    order = np.array([0, 1, 2, 3, 9], np.int32)
    got = _emulate_wire_unpack(words, widths, woffs, order, n)
    assert np.array_equal(got, _twin(words, widths, woffs, order, n))


def test_kernel_emulation_with_more_blocks_than_scan_threads():
    """A stream of 1,100 blocks: the carries' scan takes two blocks a
    thread on some threads."""
    rng = np.random.default_rng(4)
    n = 1100 * BLOCK - 5
    x16 = np.cumsum(rng.integers(-3, 4, (2, n)), axis=-1).clip(
        -32768, 32767).astype(np.int16)
    wire = _forced_order_wire(x16, [3, 2])
    got = _emulate_wire_unpack(*wire)
    assert np.array_equal(got, _twin(*wire))
    np.testing.assert_array_equal(got, _as_f32(x16))


def test_kernel_division_by_multiplication():
    """The staging's g / w as a multiply-high, for every word index of a
    block and every width."""
    g = np.arange(128 * 32, dtype=np.uint64)
    for w in range(1, 33):
        magic = np.uint64(((1 << 32) + w - 1) // w)
        assert np.array_equal((g * magic) >> np.uint64(32), g // np.uint64(w))


def test_unpack_block_is_the_format_block():
    """The kernel's block is the format's (and the JAX package's)."""
    assert (BLOCK, p_packed.MAX_ORDER) == (j_packed.BLOCK, j_packed.MAX_ORDER)
    src = (p_packed.__file__.rsplit("/search/", 1)[0]
           + "/csrc/wire_unpack.cu")
    assert f"kBlock = {BLOCK};" in open(src).read()
