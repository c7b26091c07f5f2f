"""The port's file layer (phaserotate_tpu_torch/io) against the JAX
package's (phaserotate_tpu/io), which it copies; and every other module
the port copies from the JAX package (``COPIED_ELSEWHERE``: the plugin
role's JAX-free modules) held to its source the same way.

Both are numpy/ctypes host code, so everything here is exact: a file
written by one package is read identically by the other, the lossless
writers give the same bytes, ``read_audio_pcm16`` and ``write_audio(...,
like=)`` behave alike, and every function and class of a copied module has
the source text of its original, so a later fix to one side cannot drift
unseen.  The lossy codecs need their system libraries and skip where the
JAX package's own tests do.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest

from phaserotate_tpu import io as j_io
from phaserotate_tpu.io import mp3 as j_mp3, opus as j_opus, \
    vorbisenc as j_vorbisenc
from phaserotate_tpu.io import audio as j_audio
from phaserotate_tpu_torch import io as p_io
from phaserotate_tpu_torch.io import audio as p_audio

RATE = 48000
COPIED = ["native", "wav", "aiff", "au", "containers", "flac", "vorbis",
          "vorbisenc", "opus", "mp3", "audio"]
# the copies outside io/, by dotted path under the package (the plugin
# role's JAX-free modules; their relative imports reach the port's own
# plugin.lifecycle and hostapp)
COPIED_ELSEWHERE = ["io.playback", "plugin", "plugin.uris", "plugin.protocol",
                    "plugin.descriptors", "plugin.ttl", "gui", "gui.client",
                    "gui.deflect", "gui.render", "gui.widgets", "gui.web",
                    "tui"]

needs_vorbis = pytest.mark.skipif(
    not j_vorbisenc.available(), reason="system libvorbis not present")
needs_opus = pytest.mark.skipif(
    not j_opus.available(), reason="system libopus not present")
needs_mp3 = pytest.mark.skipif(
    not j_mp3.available(),
    reason="system libmpg123/libmp3lame not present")

_PCM16 = dict(bits=16, float_format=False)
_PCM24 = dict(bits=24, float_format=False)
_F32 = dict(bits=32, float_format=True)

# id -> (writer name, extension, writer keywords)
LOSSLESS = {
    "wav-16": ("write_wav", ".wav", _PCM16),
    "wav-24": ("write_wav", ".wav", _PCM24),
    "wav-32f": ("write_wav", ".wav", _F32),
    "aiff-16": ("write_aiff", ".aiff", _PCM16),
    "aiff-24": ("write_aiff", ".aiff", _PCM24),
    "aiff-32f": ("write_aiff", ".aiff", _F32),
    "au-16": ("write_au", ".au", dict(encoding="pcm16")),
    "au-24": ("write_au", ".au", dict(encoding="pcm24")),
    "au-32f": ("write_au", ".au", dict(encoding="f32")),
    "w64-16": ("write_w64", ".w64", _PCM16),
    "w64-24": ("write_w64", ".w64", _PCM24),
    "w64-32f": ("write_w64", ".w64", _F32),
    "rf64-16": ("write_rf64", ".rf64", _PCM16),
    "rf64-24": ("write_rf64", ".rf64", _PCM24),
    "rf64-32f": ("write_rf64", ".rf64", _F32),
    "caf-16": ("write_caf", ".caf", _PCM16),
    "caf-24": ("write_caf", ".caf", _PCM24),
    "caf-32f": ("write_caf", ".caf", _F32),
    "flac-16": ("write_flac", ".flac", dict(bits=16)),
    "flac-24": ("write_flac", ".flac", dict(bits=24)),
}
LOSSY = {
    "ogg": ("write_ogg", ".ogg", {}),
    "opus": ("write_opus", ".opus", {}),
    "mp3": ("write_mp3", ".mp3", {}),
}
FORMATS = {**LOSSLESS, **LOSSY}
_LOSSY_MARKS = {"ogg": needs_vorbis, "opus": needs_opus, "mp3": needs_mp3}


def _params(names):
    return [pytest.param(n, marks=_LOSSY_MARKS[n]) if n in _LOSSY_MARKS
            else n for n in names]


def _tone(ch=2, n=6000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = np.stack([0.5 * np.sin(2 * np.pi * (440.0 + 110 * c) * t + c)
                  for c in range(ch)])
    return (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32)


def _meta(mod):
    return mod.WavMetadata(info={b"INAM": "a title", b"IART": "an artist"})


def _write(mod, name, path, audio, with_meta=True):
    writer, _, kw = FORMATS[name]
    if writer == "write_ogg":  # comments in place of a metadata carrier
        getattr(mod, writer)(path, audio, RATE, **kw)
    else:
        getattr(mod, writer)(path, audio, RATE,
                             _meta(mod) if with_meta else None, **kw)


def _same_read(got, want):
    g_audio, g_rate, g_meta = got
    w_audio, w_rate, w_meta = want
    assert g_audio.dtype == w_audio.dtype
    assert g_audio.shape == w_audio.shape
    assert np.array_equal(g_audio, w_audio)
    assert g_rate == w_rate
    assert dataclasses.asdict(g_meta) == dataclasses.asdict(w_meta)


@pytest.mark.parametrize("name", _params(FORMATS))
def test_file_of_jax_io_read_identically(tmp_path, name):
    path = str(tmp_path / ("j" + FORMATS[name][1]))
    _write(j_io, name, path, _tone())
    want = j_io.read_audio(path)
    assert want[0].shape[0] == 2 and want[0].shape[1] > 0
    _same_read(p_io.read_audio(path), want)


@pytest.mark.parametrize("name", _params(FORMATS))
def test_file_of_the_port_read_identically_by_jax_io(tmp_path, name):
    path = str(tmp_path / ("p" + FORMATS[name][1]))
    _write(p_io, name, path, _tone(seed=1))
    _same_read(j_io.read_audio(path), p_io.read_audio(path))


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("name", sorted(LOSSLESS))
def test_lossless_writers_give_the_same_bytes(tmp_path, name, ch):
    ext = FORMATS[name][1]
    j_path, p_path = str(tmp_path / ("j" + ext)), str(tmp_path / ("p" + ext))
    x = _tone(ch=ch, n=5001, seed=2)
    _write(j_io, name, j_path, x)
    _write(p_io, name, p_path, x)
    with open(j_path, "rb") as f, open(p_path, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", _params(FORMATS))
def test_read_audio_pcm16_equals_jax(tmp_path, name):
    path = str(tmp_path / ("x" + FORMATS[name][1]))
    _write(j_io, name, path, _tone(seed=3))
    want = j_io.read_audio_pcm16(path)
    got = p_io.read_audio_pcm16(path)
    assert got[0].dtype == np.int16
    _same_read(got, want)
    if name.endswith("-16"):  # value-identical to the float reader
        f = p_io.read_audio(path)[0]
        assert np.array_equal(got[0].astype(np.float32) / 32768.0, f)


@pytest.mark.parametrize("name", _params(FORMATS))
def test_probe_audio_equals_jax(tmp_path, name):
    path = str(tmp_path / ("x" + FORMATS[name][1]))
    _write(j_io, name, path, _tone(seed=4))
    assert p_audio.probe_audio(path) == j_audio.probe_audio(path)
    assert p_audio._sniff(path) == j_audio._sniff(path)


@pytest.mark.parametrize("name", _params(
    ["wav-32f", "aiff-16", "au-16", "w64-24", "rf64-16", "caf-32f",
     "flac-16", "ogg", "opus", "mp3"]))
def test_write_audio_like_inherits_the_container(tmp_path, name):
    """An output without a known extension follows ``like``, sniffed by
    content; a known extension wins over it."""
    src = str(tmp_path / "src_without_extension")
    _write(j_io, name, src, _tone(seed=5))
    x, rate, meta = p_io.read_audio(src)
    j_out, p_out = str(tmp_path / "j_out"), str(tmp_path / "p_out")
    j_io.write_audio(j_out, x, rate, meta, like=src)
    p_io.write_audio(p_out, x, rate, meta, like=src)
    kind = p_audio._sniff(src)
    assert kind == name.split("-")[0]
    assert p_audio._sniff(p_out) == j_audio._sniff(j_out) == kind
    _same_read(p_io.read_audio(p_out), j_io.read_audio(p_out))
    if name in LOSSLESS:
        with open(j_out, "rb") as f, open(p_out, "rb") as g:
            assert f.read() == g.read()
    named = str(tmp_path / "named.wav")
    p_io.write_audio(named, x, rate, meta, like=src)
    assert p_audio._sniff(named) == "wav"


def test_io_exports_every_name_of_the_jax_io():
    assert sorted(p_io.__all__) == sorted(j_io.__all__)
    for name in j_io.__all__:
        assert hasattr(p_io, name), name
    assert p_audio.__all__ == j_audio.__all__


def test_format_errors_are_the_ports_own(tmp_path):
    """The port raises its own exception classes (the CLI catches them),
    on the same input as the JAX package."""
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x04\x00\x00\x00WAVE")
    with pytest.raises(j_io.WavFormatError):
        j_io.read_audio(str(bad))
    with pytest.raises(p_io.WavFormatError):
        p_io.read_audio(str(bad))
    assert p_io.WavFormatError is not j_io.WavFormatError
    with pytest.raises(OSError):
        p_io.read_audio(str(tmp_path / "missing.flac"))


def test_native_library_is_shared():
    """Both packages load the one host library of ``native/``."""
    from phaserotate_tpu.io import native as j_native
    from phaserotate_tpu_torch.io import native as p_native

    assert p_native._LIB_PATH == j_native._LIB_PATH
    assert p_native.available() == j_native.available()
    x = (np.random.default_rng(6).integers(-32768, 32767, 4001)
         .astype(np.int16))
    assert np.array_equal(p_native.pcm16_to_f32(x), j_native.pcm16_to_f32(x))
    assert np.array_equal(p_native.pcm16_to_f32(x),
                          x.astype(np.float32) / 32768.0)


def _definitions(module):
    """Functions and classes defined in ``module`` itself."""
    return {n: o for n, o in vars(module).items()
            if (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == module.__name__}


def _pair(module):
    """(JAX module, port module) of a COPIED (io) or COPIED_ELSEWHERE name."""
    dotted = module if module in COPIED_ELSEWHERE else f"io.{module}"
    return (importlib.import_module(f"phaserotate_tpu.{dotted}"),
            importlib.import_module(f"phaserotate_tpu_torch.{dotted}"))


def _source_cases():
    cases = []
    for m in COPIED + COPIED_ELSEWHERE:
        j_mod, _ = _pair(m)
        cases += [(m, n) for n in sorted(_definitions(j_mod))]
    return cases


@pytest.mark.parametrize("module,name", _source_cases())
def test_copied_definition_has_the_source_of_its_original(module, name):
    j_mod, p_mod = _pair(module)
    assert name in _definitions(p_mod), f"{module}.{name} is missing"
    assert inspect.getsource(getattr(p_mod, name)) == \
        inspect.getsource(getattr(j_mod, name))


@pytest.mark.parametrize("module", COPIED + COPIED_ELSEWHERE)
def test_copied_module_differs_in_its_docstring_only(module):
    """Outside the module docstring the copy is its source line for line
    (constants and import lines included), and defines nothing more."""
    import os

    import phaserotate_tpu

    j_mod, p_mod = _pair(module)

    def body(mod):
        text = inspect.getsource(mod)
        doc_end = text.index('"""', 3) + 3
        return text[doc_end:]

    assert body(p_mod) == body(j_mod)
    source = os.path.relpath(j_mod.__file__,
                             os.path.dirname(phaserotate_tpu.__file__))
    assert f"copy of ``phaserotate_tpu/{source}``" in p_mod.__doc__
    assert sorted(_definitions(p_mod)) == sorted(_definitions(j_mod))
