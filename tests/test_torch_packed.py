"""The port's packed wire transport (search/packed.py) against the JAX
package's: one wire format, bit for bit.

A ``PackedChunk`` packed by either package unpacks in the other to the
same int16 values; the port's packers (numpy and the host library) equal
the JAX package's word for word; and the packed sweep is ``torch.equal``
to the pcm16 sweep of the same PCM.  Everything is exact: integer
arithmetic, then one multiplication by 2**-15.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaserotate_tpu.search import packed as j_packed
from phaserotate_tpu_torch.core.sizes import OfflineGeometry
from phaserotate_tpu_torch.io import native
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


def test_native_is_required_when_asked_for(monkeypatch):
    monkeypatch.setattr(p_packed, "_pack_residual_native",
                        lambda *a: None)
    x = _case("random")
    with pytest.raises(RuntimeError, match="native"):
        pack_residual(x, native=True)
    # None falls back to the numpy path
    np.testing.assert_array_equal(_unpack_port(pack_residual(x)), _as_f32(x))


@pytest.mark.parametrize("group", [BLOCK, 3 * BLOCK, 1 << 25])
def test_unpack_group_size_does_not_change_the_result(monkeypatch, group):
    """The unpack walks the streams a few at a time; any group size gives
    the same samples."""
    monkeypatch.setattr(p_packed, "_UNPACK_GROUP_SAMPLES", group)
    for name in ("random", "mixed_orders"):
        x = _case(name)
        np.testing.assert_array_equal(_unpack_port(pack_residual(x)),
                                      _as_f32(x))


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
    if not native.available():
        pytest.skip("native host library unavailable")
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
