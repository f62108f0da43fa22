"""The port's FLAC I/O and native helpers (taiwan_whisper_tpu_torch/
utils/native.py, a binding of native/*.cpp built under build/) against
the JAX package's binding: files written by either decode to the same
samples through the other, ``load_audio_16k`` of FLAC agrees, and the
edit distance and n-gram count agree."""

import os

import numpy as np
import pytest

from taiwan_whisper_tpu.audio.io import load_audio_16k as jax_load_audio_16k
from taiwan_whisper_tpu.utils import native as jax_native
from taiwan_whisper_tpu_torch.audio import io as pio
from taiwan_whisper_tpu_torch.utils import native

SR = 16000


def _audio(channels: int, seconds: float = 1.5, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    cols = [0.5 * np.sin(2 * np.pi * (220 * (c + 1)) * t) + 0.02 * rng.randn(len(t))
            for c in range(channels)]
    x = np.stack(cols, axis=1) if channels > 1 else cols[0]
    return np.clip(x, -1, 1).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flac_roundtrip_across_bindings(tmp_path, channels, writer):
    x = _audio(channels, seed=channels)
    p = str(tmp_path / f"{writer}{channels}.flac")
    (pio.write_flac if writer == "port" else jax_native.flac_encode)(p, x, SR)
    got, got_sr = pio.read_flac(p)
    want, want_sr = jax_native.flac_decode(p)
    assert got_sr == want_sr == SR
    assert got.shape == want.shape == x.shape
    np.testing.assert_array_equal(got, want)
    # the encoder scales by 32767 and rounds, the decoder divides by 32768:
    # at most (|x| + 0.5) / 32768 from the input, |x| <= 1
    np.testing.assert_allclose(got, x, rtol=0, atol=1.5 / 32768)
    assert os.path.getsize(p) < x.size * 2  # it compresses


def test_flac_files_written_by_both_are_identical(tmp_path):
    x = _audio(2, seed=3)
    a, b = str(tmp_path / "a.flac"), str(tmp_path / "b.flac")
    pio.write_flac(a, x, SR)
    jax_native.flac_encode(b, x, SR)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("rate", [16000, 44100])
def test_load_audio_16k_flac(tmp_path, rate):
    x = _audio(2, seconds=0.75, seed=rate)
    p = str(tmp_path / f"s{rate}.flac")
    pio.write_flac(p, x, rate)
    got = pio.load_audio_16k(p)
    assert got.ndim == 1 and abs(len(got) - int(round(len(x) * SR / rate))) <= 1
    np.testing.assert_array_equal(got, jax_load_audio_16k(p))


def test_unreadable_and_unknown_formats_raise(tmp_path):
    bad = str(tmp_path / "bad.flac")
    with open(bad, "wb") as f:
        f.write(b"not a flac stream")
    with pytest.raises(ValueError):
        pio.load_audio_16k(bad)
    with pytest.raises(ValueError):
        pio.read_audio(str(tmp_path / "x.mp3"))


def test_native_library_builds_under_build(tmp_path):
    so = native.library_path()
    native.edit_distance(["a"], ["b"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.exists(so)
    assert os.path.relpath(so, os.path.dirname(root)).startswith("build" + os.sep)
    assert os.path.dirname(so) != os.path.dirname(native.SOURCES[0])


def test_edit_distance_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(40):
        a = [str(x) for x in rng.randint(0, 8, rng.randint(0, 30))]
        b = [str(x) for x in rng.randint(0, 8, rng.randint(0, 30))]
        assert native.edit_distance(a, b) == jax_native.edit_distance(a, b)
    assert native.edit_distance(list("kitten"), list("sitting")) == 3
    assert native.edit_distance([], list("abc")) == 3


@pytest.mark.parametrize("text,n", [
    ("abcdefabcdefabcdefabcdefabcdefabcdef", 6),
    ("<|1.00|>xxxxxxxxxx<|2.00|>", 6),
    ("short", 6),
    ("重複重複重複重複重複重複重複重複重複重複", 6),
    ("哈哈哈哈哈哈哈哈", 3),
    ("", 2),
])
def test_max_ngram_count_matches_jax(text, n):
    assert native.max_ngram_count(text, n) == jax_native.max_ngram_count(text, n)
