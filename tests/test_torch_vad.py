"""The port's VAD (taiwan_whisper_tpu_torch/pipeline/vad.py) against the JAX
package's, on the same numpy audio: the host energy and spectral VADs give
equal regions on the fixtures of tests/test_vad.py, and the PyTorch device
scorer, run here on the CPU, gives the JAX device scorer's scores within
the tolerances below and equal regions. Three traps of translating the
XLA scorer are pinned: the symmetric window, the 12000-frame count, and
the median of an even count."""

import os
import sys

import numpy as np
import pytest
import torch

from taiwan_whisper_tpu.pipeline import vad as JV
from taiwan_whisper_tpu_torch.pipeline import vad as PV
from taiwan_whisper_tpu_torch.tools.synth_audio import synth_lecture

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_vad import _signal, pink_noise, synth_music, synth_speech, white_noise  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401, E402

SR = 16000
# device scorer vs JAX's, both fp32 on the CPU (measured: 1.2e-5 dB,
# 1.2e-5 flatness, 6.6e-7 modulation ratio on the 130 s fixture)
TOL = dict(energy_db=1e-3, flatness=1e-4, mod_ratio=1e-4)


def _fixtures():
    mixed = np.concatenate([
        np.zeros(3 * SR, np.float32), synth_speech(seed=7, dur=4.0),
        synth_music(seed=7, dur=4.0), synth_speech(seed=8, dur=3.0),
        white_noise(seed=7, dur=3.0)])
    return {
        "speech": synth_speech(seed=0),
        "quiet_speech": synth_speech(seed=2, level=0.04),
        "noisy_speech": synth_speech(seed=1) + pink_noise(seed=1, level=0.03),
        "music": synth_music(seed=1),
        "white_noise": white_noise(seed=2),
        "pink_noise": pink_noise(seed=3),
        "silence": np.zeros(SR * 5, np.float32),
        "mixed_timeline": mixed,
        "short": synth_speech(dur=0.4),
        "half_second_silence": np.zeros(SR // 2, np.float32),
        "tone_bursts": _signal([(2.0, 0.0), (3.0, 0.3), (2.0, 0.0), (1.5, 0.3), (1.0, 0.0)]),
    }


FIXTURES = _fixtures()


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("mode", ["energy", "spectral-host"])
def test_host_regions_equal_jax(name, mode):
    audio = FIXTURES[name]
    assert PV.detect_speech_regions(audio, mode, "cpu") == JV.detect_speech_regions(audio, mode)


@pytest.mark.parametrize("name", ["speech", "music", "mixed_timeline"])
def test_host_block_scores_equal_jax(name):
    got, want = PV.spectral_block_scores(FIXTURES[name]), JV.spectral_block_scores(FIXTURES[name])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_energy_helpers_equal_jax():
    audio = FIXTURES["tone_bursts"]
    assert PV.speech_ratio(audio) == JV.speech_ratio(audio)
    got, got_r = PV.extract_speech(audio)
    want, want_r = JV.extract_speech(audio)
    np.testing.assert_array_equal(got, want)
    assert got_r == want_r


@pytest.fixture(scope="module")
def lecture_130s():
    """130 s of lecture-like audio: two scoring segments, the second mostly
    zero padding."""
    return synth_lecture(np.random.RandomState(5), 130.0)[: 130 * SR]


@pytest.fixture(scope="module")
def scores_130s(lecture_130s):
    segs = JV._file_segments(lecture_130s)
    np.testing.assert_array_equal(PV._file_segments(lecture_130s), segs)
    return PV._score_segments(segs, "cpu"), JV._score_segments(segs)


def test_device_scorer_matches_jax(lecture_130s, scores_130s):
    got, want = scores_130s
    assert got.shape == want.shape == (2, 3, PV._SEG_BLOCKS)
    got_d, want_d = PV._scores_dict(got, 130.0), JV._scores_dict(want, 130.0)
    np.testing.assert_array_equal(got_d["t"], want_d["t"])
    for k, tol in TOL.items():
        np.testing.assert_allclose(got_d[k], want_d[k], rtol=0, atol=tol, err_msg=k)
    regions = PV.spectral_speech_regions(lecture_130s, scores=got_d)
    assert regions == JV.spectral_speech_regions(lecture_130s, scores=want_d)
    assert len(regions) >= 4  # speech bursts between silent gaps


def test_device_regions_batch_equal_jax(lecture_130s):
    """Several files share scorer calls; each file's regions equal the JAX
    batch entry's and the per-file device entry's."""
    audios = [lecture_130s[: 50 * SR], FIXTURES["mixed_timeline"], FIXTURES["music"],
              lecture_130s]
    got = PV.spectral_regions_device_batch(audios, "cpu")
    assert got == JV.spectral_regions_device_batch(audios)
    assert got[3] == PV.detect_speech_regions(lecture_130s, "spectral-device", "cpu")
    assert got[2] == []  # music rejected


def test_vad_mode_resolves_by_device():
    assert PV.resolve_vad_mode("spectral", "cuda") == "spectral-device"
    assert PV.resolve_vad_mode("spectral", torch.device("cuda", 0)) == "spectral-device"
    assert PV.resolve_vad_mode("spectral", "cpu") == "spectral-host"
    for mode in ("spectral-device", "spectral-host", "energy", "off"):
        assert PV.resolve_vad_mode(mode, "cuda") == mode
    with pytest.raises(ValueError):
        PV.detect_speech_regions(FIXTURES["speech"], "nope", "cpu")


def test_scorer_window_is_symmetric_hanning():
    """np.hanning is the symmetric window; torch.hann_window defaults to
    the periodic one, which would shift every score."""
    window = PV._device_scorer("cpu").window
    np.testing.assert_array_equal(window.numpy(), np.hanning(400).astype(np.float32))
    assert not torch.allclose(window, torch.hann_window(400), atol=1e-3)


def test_scorer_takes_12000_frames():
    """A segment of SEG + WIN samples unfolds into 12001 frames; the scorer
    (like JAX's) takes 12000: samples only the 12001st frame reads change
    nothing, samples of the 12000th do."""
    score = PV._device_scorer("cpu")
    segs = torch.zeros((1, PV._VAD_SEG_SAMPLES + PV._WIN), dtype=torch.int16)
    base = score(segs)
    late = segs.clone()
    late[0, 12000 * 160 + 300] = 20000  # frame 12000 only (0-based)
    assert torch.equal(score(late), base)
    last = segs.clone()
    last[0, 11999 * 160 + 10] = 20000  # frame 11999, in the last block
    assert not torch.equal(score(last), base)


def test_scorer_median_of_even_count():
    """Blocks hold 100 flatness values; their median is the mean of the two
    middle ones, as numpy and jnp take it, not torch.median's lower one."""
    rng = np.random.RandomState(0)
    flat = rng.rand(2, 3 * PV._FPB).astype(np.float32)
    blocks = np.lib.stride_tricks.sliding_window_view(flat, PV._FPB, axis=1)[:, ::PV._BLOCK_HOP]
    got = PV.block_median(torch.from_numpy(flat)).numpy()
    np.testing.assert_allclose(got, np.median(blocks, axis=-1), rtol=0, atol=1e-7)
    lower = torch.from_numpy(flat).unfold(1, PV._FPB, PV._BLOCK_HOP).median(-1).values
    assert not np.allclose(lower.numpy(), got, atol=1e-4)
